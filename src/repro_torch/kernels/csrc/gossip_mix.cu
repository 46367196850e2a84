// Gossip mix Y = W X of the flat (n, D) f32 buffer (Algorithm 1, line 6),
// and of the (R, n, D) buffer of an R-run sweep lattice in one launch.
//
// Replaces the TPU kernels repro/kernels/gossip_mix.py:gossip_mix_pallas
// (dense W), :gossip_mix_sparse_pallas (ELL neighbour table), and their
// run-batched forms :gossip_mix_batched_pallas (per-run W, (R, n, n)) and
// :gossip_mix_sparse_batched_pallas (per-run ELL tables padded to the
// lattice's max degree).  Bound on the H100: bytes.  Each call reads X
// once and writes Y once (8 B per element) for 2n flop (dense) or
// 2(max_deg+1) flop (ELL) per element; at n = 8 that is 2 flop per byte
// against a ridge point near 20 for f32 outside the tensor cores.  At the
// sweep path's R = 2, n = 8, D = 156,519,168 that is 20.03 GB, 5.980 ms at
// 3.35 TB/s (2.990 ms for one run).  Design
// (mix_common.cuh): a thread owns whole columns of one run, loads all n
// rows of them before the first FMA, and keeps its run's W or ELL tables
// in shared memory, so X streams through once and nothing else touches
// device memory.  The single-run kernels are the R = 1 case.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64.  Each function returns the cudaError_t of its launch.
#include "mix_common.cuh"

extern "C" int gossip_mix_dense(const float* w, const float* x, float* y,
                                int64_t r, int64_t n, int64_t d,
                                void* stream) {
  feddec::Args a{};
  a.w = w;
  a.x = x;
  a.y = y;
  a.r = r;
  a.n = n;
  a.d = d;
  return feddec::launch_mix<feddec::kNone, false>(
      a, static_cast<cudaStream_t>(stream));
}

extern "C" int gossip_mix_ell(const int32_t* nbr, const float* wv,
                              const float* wd, int64_t max_deg,
                              const float* x, float* y, int64_t r, int64_t n,
                              int64_t d, void* stream) {
  feddec::Args a{};
  a.nbr = nbr;
  a.wv = wv;
  a.wd = wd;
  a.max_deg = max_deg;
  a.x = x;
  a.y = y;
  a.r = r;
  a.n = n;
  a.d = d;
  return feddec::launch_mix<feddec::kNone, true>(
      a, static_cast<cudaStream_t>(stream));
}
