// Fused local update + gossip mix: y = W (x - eta g) (sgd), or the
// momentum / nesterov step that also emits the new f32 momentum m'; for
// the flat (n, D) buffer, f32, f64 or bf16 (the step in the buffer's type,
// the mix in f32, as the reference's kernels do; a bf16 step rounds where
// XLA rounds the reference's kernel body, mix_common.cuh:step_value), or
// for the (R, n, D) buffer of an R-run sweep
// lattice in one launch with per-run W (or ELL tables) and per-run eta.
//
// Replaces the TPU kernels repro/kernels/update_mix.py:update_mix_pallas
// (dense W), :update_mix_sparse_pallas (ELL neighbour table), and their
// run-batched forms :update_mix_batched_pallas and
// :update_mix_sparse_batched_pallas.  The single-run kernels are the
// R = 1 case.
//
// Bound on the H100: bytes.  sgd reads x and g and writes y (12 B per
// element); momentum also reads m and writes m' (20 B per element); at the
// sweep path's R = 2, n = 8, D = 156,519,168 that is 30.05 GB (8.971 ms at
// 3.35 TB/s) and 50.09 GB (14.951 ms), twice one run's; a bf16 buffer
// moves 6 B (sgd) or 14 B (momentum) per element.  The
// post-update iterate p is formed on chip and never written, which is the
// point of the fusion (the unfused pair moves p out and back in: 5 passes
// instead of 3 for sgd).  Design (mix_common.cuh): a thread owns whole
// columns, applies the optimizer step to all n rows of them in registers,
// writes m' right away, and mixes p against W or the ELL tables held in
// shared memory.  eta is read from a device pointer, so one launch
// sequence serves any step-size schedule without a host round trip.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64, the dtype of x, g and y as feddec::Dtype (W, the ELL
// weights, m and eta are f32 whatever it is).  eta holds one f32 per run.
// The step is sgd when m is null, else momentum, or nesterov when the
// nesterov flag is set.  Each function returns the cudaError_t of its
// launch.
#include "mix_common.cuh"

namespace {

template <bool ELL, typename T>
int launch_step(const feddec::Args<T>& a, int nesterov, cudaStream_t stream) {
  if ((a.m == nullptr) != (a.m_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.m == nullptr) return feddec::launch_mix<feddec::kSgd, ELL>(a, stream);
  if (nesterov) return feddec::launch_mix<feddec::kNesterov, ELL>(a, stream);
  return feddec::launch_mix<feddec::kMomentum, ELL>(a, stream);
}

}  // namespace

extern "C" int update_mix_dense(const float* w, const void* x, const void* g,
                                const float* m, const float* eta, void* y,
                                float* m_out, int64_t r, int64_t n, int64_t d,
                                float beta, int nesterov, int dtype,
                                void* stream) {
  return feddec::by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    feddec::Args<T> a{};
    a.w = w;
    a.x = static_cast<const T*>(x);
    a.g = static_cast<const T*>(g);
    a.m = m;
    a.eta = eta;
    a.y = static_cast<T*>(y);
    a.m_out = m_out;
    a.r = r;
    a.n = n;
    a.d = d;
    a.beta = beta;
    return launch_step<false>(a, nesterov, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int update_mix_ell(const int32_t* nbr, const float* wv,
                              const float* wd, int64_t max_deg, const void* x,
                              const void* g, const float* m, const float* eta,
                              void* y, float* m_out, int64_t r, int64_t n,
                              int64_t d, float beta, int nesterov, int dtype,
                              void* stream) {
  return feddec::by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    feddec::Args<T> a{};
    a.nbr = nbr;
    a.wv = wv;
    a.wd = wd;
    a.max_deg = max_deg;
    a.x = static_cast<const T*>(x);
    a.g = static_cast<const T*>(g);
    a.m = m;
    a.eta = eta;
    a.y = static_cast<T*>(y);
    a.m_out = m_out;
    a.r = r;
    a.n = n;
    a.d = d;
    a.beta = beta;
    return launch_step<true>(a, nesterov, static_cast<cudaStream_t>(stream));
  });
}
