// Gossip mix Y = W X of the flat (n, D) buffer (Algorithm 1, line 6), f32,
// f64 or bf16 (mixed in f32, as the reference's kernels mix), and of the
// (R, n, D) buffer of an R-run sweep lattice in one launch.
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
// 3.35 TB/s (2.990 ms for one run); a bf16 buffer moves half the bytes.
// Design
// (mix_common.cuh): a thread owns whole columns of one run, loads all n
// rows of them before the first FMA, and keeps its run's W or ELL tables
// in shared memory, so X streams through once and nothing else touches
// device memory.  The ELL mix at n <= 8 gives a thread 4 adjacent columns,
// so that an aligned f32 row is one 16-byte access (a bf16 row 8 bytes).  The single-run
// kernels are the R = 1 case.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64, the buffer's dtype as feddec::Dtype (W and the ELL
// weights are f32 whatever it is).  Each function returns the cudaError_t
// of its launch.
#include "mix_common.cuh"

extern "C" int gossip_mix_dense(const float* w, const void* x, void* y,
                                int64_t r, int64_t n, int64_t d, int dtype,
                                void* stream) {
  return feddec::by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    feddec::Args<T> a{};
    a.w = w;
    a.x = static_cast<const T*>(x);
    a.y = static_cast<T*>(y);
    a.r = r;
    a.n = n;
    a.d = d;
    return feddec::launch_mix<feddec::kNone, false>(
        a, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int gossip_mix_ell(const int32_t* nbr, const float* wv,
                              const float* wd, int64_t max_deg,
                              const void* x, void* y, int64_t r, int64_t n,
                              int64_t d, int dtype, void* stream) {
  return feddec::by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    feddec::Args<T> a{};
    a.nbr = nbr;
    a.wv = wv;
    a.wd = wd;
    a.max_deg = max_deg;
    a.x = static_cast<const T*>(x);
    a.y = static_cast<T*>(y);
    a.r = r;
    a.n = n;
    a.d = d;
    return feddec::launch_mix<feddec::kNone, true>(
        a, static_cast<cudaStream_t>(stream));
  });
}
