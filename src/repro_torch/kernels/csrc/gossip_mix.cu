// Gossip mix Y = W X of the flat (n, D) f32 buffer (Algorithm 1, line 6).
//
// Replaces the TPU kernels repro/kernels/gossip_mix.py:gossip_mix_pallas
// (dense W) and :gossip_mix_sparse_pallas (ELL neighbour table).
// Bound on the H100: bytes.  Each call reads X once and writes Y once
// (8 B per element) for 2n flop (dense) or 2(max_deg+1) flop (ELL) per
// element; at n = 8 that is 2 flop per byte against a ridge point near 20
// for f32 outside the tensor cores.  Design (mix_common.cuh): a thread
// owns whole columns, loads all n rows of them before the first FMA, and
// keeps W or the ELL tables in shared memory, so X streams through once
// and nothing else touches device memory.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64.  Each function returns the cudaError_t of its launch.
#include "mix_common.cuh"

extern "C" int gossip_mix_dense(const float* w, const float* x, float* y,
                                int64_t n, int64_t d, void* stream) {
  feddec::Args a{};
  a.w = w;
  a.x = x;
  a.y = y;
  a.n = n;
  a.d = d;
  return feddec::launch_mix<feddec::kNone, false>(
      a, static_cast<cudaStream_t>(stream));
}

extern "C" int gossip_mix_ell(const int32_t* nbr, const float* wv,
                              const float* wd, int64_t max_deg,
                              const float* x, float* y, int64_t n, int64_t d,
                              void* stream) {
  feddec::Args a{};
  a.nbr = nbr;
  a.wv = wv;
  a.wd = wd;
  a.max_deg = max_deg;
  a.x = x;
  a.y = y;
  a.n = n;
  a.d = d;
  return feddec::launch_mix<feddec::kNone, true>(
      a, static_cast<cudaStream_t>(stream));
}
