// Compressed gossip with error feedback (repro/core/compress.py) on the
// flat (n, D) buffer, f32, f64 or bf16: the fused receive side of the EF exchange
// and the int8 mixes.  Every kernel also takes the (R, n, D) buffer of an R-run
// lattice, with the run as the grid's y index as in mix_common.cuh: the EF
// entry points with R = 1 are #9/#11, with R runs #10/#12; the int8 ones
// are called with R = 1.
//
// Replaces the TPU kernels
//   #9  repro/kernels/update_mix.py:ef_mix_pallas        (dense W)
//   #10 repro/kernels/update_mix.py:ef_mix_batched_pallas        (R runs)
//   #11 repro/kernels/update_mix.py:ef_mix_sparse_pallas (ELL tables)
//   #12 repro/kernels/update_mix.py:ef_mix_sparse_batched_pallas (R runs)
//   #13 repro/kernels/compress_mix.py:quant_mix_pallas   (int8 send side)
//   #14 repro/kernels/compress_mix.py:dequant_mix_pallas (int8 receive side)
// All of them compute, per run and column,
//     y_i = sum_j W_ij s_j + W_ii (p_i - s_i)                   (dense)
//     y_i = wd_i s_i + sum_k wv_ik s_nbr(i,k) + wd_i (p_i - s_i)   (ELL)
// and differ in where s comes from and what else they write:
//   kEf      (#9-#12)  s is read, and r = u - s is written;
//   kDequant (#14)     s = q * scale_j from the int8 payload q;
//   kQuant   (#13)     q = clip(floor(u / scale_j + noise), -127, 127) is
//                      written as int8, and s = q * scale_j.
//
// Bound on the H100: bytes.  Per element #9-#12 read p, s, u and write y, r
// (20 B); #14 reads q (1 B) and p and writes y (9 B); #13 reads u, noise, p
// and writes y and q (17 B).  The mix is 2n flop per element, about one
// flop per byte at n = 8, far below the ridge point.  At the main path's
// n = 8, D = 156,519,168 the bounds are 7.476 ms (#9/#11; R = 2 runs of
// it, #10/#12: 14.951 ms), 3.364 ms (#14) and 6.354 ms (#13) at 3.35 TB/s;
// a bf16 buffer halves the bytes of p, s, u, y and r (10, 5 and 11 B per
// element: 3.738, 1.869 and 4.111 ms).  Design: mix_common.cuh's per-column
// layout with another load stage and output stage.  A thread owns whole
// columns.  It reads row j's inputs of its columns once and forms s_j,
// writing r_j or q_j right away, so u and the noise are dead after the
// load.  It keeps s in its own shared-memory slots, never in registers:
// the output stage loads p row by row, and each row's load waits on
// memory, so the kernel needs many warps in flight more than it needs
// registers (s in registers took 80-113 registers per thread and ran at
// 25-40% of the bound on the H100).  At n <= 8 a thread owns 4 adjacent
// columns, so that each row is one 16-byte access of p, s, u, y (4 bytes
// of q, 8 of a bf16 buffer) when D % 4 == 0 and the buffers are aligned
// to 4 elements, and four
// masked scalar accesses otherwise (the ragged edge); one byte per
// thread per request made the int8 kernels the slowest.  W (n <= 8) or
// the ELL tables sit in shared memory.  On #13/#14 the f32 s never
// touches device memory, which is the point of fusing the int8 payload
// into the mix.
//
// Dtypes, as the reference's kernels (repro/kernels/update_mix.py:
// ef_mix_kernel, repro/kernels/compress_mix.py): the mix sums s rounded to
// f32 with f32 weights.  On #9-#12 the mix is then converted to the
// buffer's type T, and r = u - s and the correction W_ii (p - s) (W_ii in
// T) are computed in T (a bf16 operation is the f32 one rounded to bf16,
// as in mix_common.cuh); #13/#14 compute everything in f32 and convert y
// to T at the end.  For an f64 buffer the correction re-reads s_i in f64
// (the shared slots hold the f32 s of the mix); a bf16 s is exact in f32.
//
// Exactness: r = u - s is one subtraction; q is floorf(__fdiv_rn(u, scale)
// + noise), clipped (IEEE division, no --use_fast_math); s = q * scale; the
// correction W_ii (p - s) and its sum with the mix are rounded op by op by
// the _rn intrinsics, which nvcc does not contract into FMAs.  So r and q
// equal the plain versions (kernels/ref.py) bit for bit, and y differs
// from them only through the order of the mix's sum.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64, the dtype of p, s, u, y and r (and of the dense EF
// kernels' diagonal) as feddec::Dtype; W, the ELL weights, the scales and
// the noise are f32.  Each function returns the cudaError_t of its launch.
#include "mix_common.cuh"

namespace feddec {
namespace {

enum Source : int { kEf = 0, kDequant = 1, kQuant = 2 };

template <typename T>
struct EfArgs {
  const float* w;      // (R, n, n) dense mixing matrices (dense only)
  const int32_t* nbr;  // (R, n, max_deg) ELL neighbour rows (ELL only)
  const float* wv;     // (R, n, max_deg) ELL edge weights, 0 on padding
  const float* wd;     // (R, n) diagonal weights W_ii (ELL only)
  const T* diag;       // (R, n) W_ii in the buffer's type (kEf dense)
  const T* p;          // (R, n, D) full-precision iterate
  const T* s;          // (R, n, D) decoded payload (kEf)
  const T* u;          // (R, n, D) error-compensated payload (kEf, kQuant)
  const float* noise;  // (R, n, D) U[0, 1) rounding noise (kQuant)
  const float* scale;  // (R, n) per-row int8 scales (kDequant, kQuant)
  const int8_t* q_in;  // (R, n, D) int8 payload (kDequant)
  T* y;                // (R, n, D) mixed output
  T* res;              // (R, n, D) new residual u - s (kEf)
  int8_t* q_out;       // (R, n, D) int8 payload (kQuant)
  int64_t r;
  int64_t n;
  int64_t d;
  int64_t max_deg;
};

// q = clip(floor(u / sc + noise), -127, 127) of one element, written
// through *q, and its s = q * sc.
__device__ __forceinline__ float quantize(float u, float noise, float sc,
                                          int8_t* q) {
  const float v = fminf(
      fmaxf(floorf(__fadd_rn(__fdiv_rn(u, sc), noise)), -127.f), 127.f);
  *q = static_cast<int8_t>(v);
  return __fmul_rn(v, sc);
}

// The f32 s at element idx of a row whose int8 scale is sc (unused by
// kEf), writing the residual (kEf) or the int8 payload (kQuant) on the
// way.
template <int S, typename T>
__device__ __forceinline__ float load_s(const EfArgs<T>& a, int64_t idx,
                                        float sc) {
  if (S == kEf) {
    const T s = __ldcs(a.s + idx);
    __stcs(a.res + idx, sub_rn(__ldcs(a.u + idx), s));
    return to_f32(s);
  }
  if (S == kDequant) return __fmul_rn(static_cast<float>(a.q_in[idx]), sc);
  return quantize(to_f32(__ldcs(a.u + idx)), __ldcs(a.noise + idx), sc,
                  a.q_out + idx);
}

// mix + diag * (p - s), each operation rounded on its own, in f32.
__device__ __forceinline__ float corrected(float mix, float diag, float p,
                                           float s) {
  return __fadd_rn(mix, __fmul_rn(diag, __fsub_rn(p, s)));
}

// y of one element from the f32 mix: kEf converts the mix to T and adds
// diag_t (p - s_t) in T; the int8 kernels correct in f32 with the f32 s
// and convert at the end.
template <int S, typename T>
__device__ __forceinline__ T output(float mix, float diag32, T diag_t, T p,
                                    T s_t, float s32) {
  if (S == kEf)
    return add_rn(from_f32<T>(mix), mul_rn(diag_t, sub_rn(p, s_t)));
  return from_f32<T>(corrected(mix, diag32, to_f32(p), s32));
}

template <bool VEC>
__device__ __forceinline__ char4 ldq4(const int8_t* q, int64_t idx, int nv) {
  if (VEC) return *reinterpret_cast<const char4*>(q + idx);
  char4 v = make_char4(0, 0, 0, 0);
  if (nv > 0) v.x = q[idx];
  if (nv > 1) v.y = q[idx + 1];
  if (nv > 2) v.z = q[idx + 2];
  if (nv > 3) v.w = q[idx + 3];
  return v;
}

template <bool VEC>
__device__ __forceinline__ void stq4(int8_t* q, int64_t idx, char4 v,
                                     int nv) {
  if (VEC) {
    *reinterpret_cast<char4*>(q + idx) = v;
    return;
  }
  if (nv > 0) q[idx] = v.x;
  if (nv > 1) q[idx + 1] = v.y;
  if (nv > 2) q[idx + 2] = v.z;
  if (nv > 3) q[idx + 3] = v.w;
}

// load_s for 4 adjacent elements.
template <int S, bool VEC, typename T>
__device__ __forceinline__ float4 load_s4(const EfArgs<T>& a, int64_t idx,
                                          float sc, int nv) {
  if (S == kEf) {
    const Quad<T> s = ldq<VEC>(a.s, idx, nv);
    const Quad<T> u = ldq<VEC>(a.u, idx, nv);
    Quad<T> r;
#pragma unroll
    for (int k = 0; k < kQuad; ++k) r.v[k] = sub_rn(u.v[k], s.v[k]);
    stq<VEC>(a.res, idx, r, nv);
    return make_float4(to_f32(s.v[0]), to_f32(s.v[1]), to_f32(s.v[2]),
                       to_f32(s.v[3]));
  }
  if (S == kDequant) {
    const char4 q = ldq4<VEC>(a.q_in, idx, nv);
    return make_float4(__fmul_rn(static_cast<float>(q.x), sc),
                       __fmul_rn(static_cast<float>(q.y), sc),
                       __fmul_rn(static_cast<float>(q.z), sc),
                       __fmul_rn(static_cast<float>(q.w), sc));
  }
  const Quad<T> u = ldq<VEC>(a.u, idx, nv);
  const Quad<float> z = ldq<VEC>(a.noise, idx, nv);
  char4 q;
  float4 s;
  s.x = quantize(to_f32(u.v[0]), z.v[0], sc, &q.x);
  s.y = quantize(to_f32(u.v[1]), z.v[1], sc, &q.y);
  s.z = quantize(to_f32(u.v[2]), z.v[2], sc, &q.z);
  s.w = quantize(to_f32(u.v[3]), z.v[3], sc, &q.w);
  stq4<VEC>(a.q_out, idx, q, nv);
  return s;
}

// n <= kSmallN: thread t of a block owns the 4 adjacent columns
// 4 (tile * kThreads + t) .. + 3 of its run's slice.
template <int S, bool ELL, bool VEC, typename T>
__global__ void __launch_bounds__(kThreads) ef_small_kernel(EfArgs<T> a) {
  constexpr int NB = kSmallN;
  const int n = static_cast<int>(a.n);
  const int md = static_cast<int>(a.max_deg);
  const int64_t d = a.d;
  const int tid = threadIdx.x;
  const int64_t run = blockIdx.y;
  const int64_t base = run * a.n * d;  // this run's (n, D) slice

  __shared__ float ws[ELL ? 1 : NB * NB];
  __shared__ float sc_s[NB];
  __shared__ T diag_s[NB];  // W_ii in T (kEf)
  extern __shared__ float4 dyn4[];
  float4* ps = dyn4;                                    // NB*kThreads
  float* wv_s = reinterpret_cast<float*>(dyn4 + NB * kThreads);  // ELL
  float* wd_s = wv_s + NB * md;                         // ELL: n
  int32_t* nbr_s = reinterpret_cast<int32_t*>(wd_s + NB);  // ELL: n*md

  if (!ELL) {
    const float* w = a.w + run * n * n;
    for (int e = tid; e < NB * NB; e += kThreads) {
      const int i = e / NB, j = e % NB;
      ws[e] = (i < n && j < n) ? w[i * n + j] : 0.f;
    }
  } else {
    const int64_t tab = run * n * md;
    for (int e = tid; e < n * md; e += kThreads) {
      wv_s[e] = a.wv[tab + e];
      nbr_s[e] = a.nbr[tab + e];
    }
    for (int e = tid; e < n; e += kThreads) wd_s[e] = a.wd[run * n + e];
  }
  for (int e = tid; e < NB; e += kThreads) {
    sc_s[e] = (S != kEf && e < n) ? a.scale[run * n + e] : 1.f;
    diag_s[e] = (S != kEf || e >= n) ? from_f32<T>(0.f)
                : ELL                ? from_f32<T>(a.wd[run * n + e])
                                     : a.diag[run * n + e];
  }
  __syncthreads();

  constexpr int64_t kTile = int64_t(kQuad) * kThreads;
  const int64_t ntiles = (d + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t col = (t * kThreads + tid) * kQuad;
    if (col >= d) continue;  // no barrier below: a thread may skip a tile
    const int nv = d - col < kQuad ? static_cast<int>(d - col) : kQuad;
    const int64_t off = base + col;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < n) ps[j * kThreads + tid] = load_s4<S, VEC>(a, off + j * d,
                                                          sc_s[j], nv);
    }
    // each thread reads back only its own slots: no barrier needed
    for (int i = 0; i < n; ++i) {
      float4 acc;
      float diag;
      if (ELL) {
        diag = wd_s[i];
        const float4 si = ps[i * kThreads + tid];
        acc = make_float4(diag * si.x, diag * si.y, diag * si.z,
                          diag * si.w);
        for (int k = 0; k < md; ++k) {
          const float wk = wv_s[i * md + k];
          const float4 sk = ps[nbr_s[i * md + k] * kThreads + tid];
          acc = make_float4(fmaf(wk, sk.x, acc.x), fmaf(wk, sk.y, acc.y),
                            fmaf(wk, sk.z, acc.z), fmaf(wk, sk.w, acc.w));
        }
      } else {
        diag = ws[i * NB + i];
        acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < n; ++j) {
          const float wij = ws[i * NB + j];
          const float4 sj = ps[j * kThreads + tid];
          acc = make_float4(fmaf(wij, sj.x, acc.x), fmaf(wij, sj.y, acc.y),
                            fmaf(wij, sj.z, acc.z), fmaf(wij, sj.w, acc.w));
        }
      }
      const int64_t idx = off + i * d;
      const Quad<T> p = ldq<VEC>(a.p, idx, nv);
      const float4 s4 = ps[i * kThreads + tid];
      const float s32[kQuad] = {s4.x, s4.y, s4.z, s4.w};
      Quad<T> s_t = to_quad<T>(s4);
      if (S == kEf && sizeof(T) > sizeof(float))
        s_t = ldq<VEC>(a.s, idx, nv);
      const float mix[kQuad] = {acc.x, acc.y, acc.z, acc.w};
      Quad<T> y;
#pragma unroll
      for (int k = 0; k < kQuad; ++k)
        y.v[k] = output<S>(mix[k], diag, diag_s[i], p.v[k], s_t.v[k],
                           s32[k]);
      stq<VEC>(a.y, idx, y, nv);
    }
  }
}

template <int S, bool ELL, typename T>
__global__ void __launch_bounds__(kThreads) ef_general_kernel(EfArgs<T> a) {
  extern __shared__ float ps[];  // n * kThreads: thread t owns column t
  const int n = static_cast<int>(a.n);
  const int md = static_cast<int>(a.max_deg);
  const int64_t d = a.d;
  const int tid = threadIdx.x;
  const int64_t run = blockIdx.y;
  const int64_t base = run * a.n * d;  // this run's (n, D) slice
  const float* w = a.w + run * n * n;
  const int32_t* nbr = a.nbr + run * n * md;
  const float* wv = a.wv + run * n * md;
  const float* wd = a.wd + run * n;
  const int64_t ntiles = (d + kThreads - 1) / kThreads;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t col = t * kThreads + tid;
    if (col >= d) continue;  // no barrier below: a thread may skip a tile
    for (int j = 0; j < n; ++j) {
      const float sc = (S == kEf) ? 1.f : __ldg(a.scale + run * n + j);
      ps[j * kThreads + tid] = load_s<S>(a, base + j * d + col, sc);
    }
    for (int i = 0; i < n; ++i) {
      float acc, diag;
      if (ELL) {
        diag = __ldg(wd + i);
        acc = diag * ps[i * kThreads + tid];
        for (int k = 0; k < md; ++k) {
          const int src = __ldg(nbr + i * md + k);
          acc = fmaf(__ldg(wv + i * md + k), ps[src * kThreads + tid], acc);
        }
      } else {
        diag = __ldg(w + i * n + i);
        acc = 0.f;
        for (int j = 0; j < n; ++j)
          acc = fmaf(__ldg(w + i * n + j), ps[j * kThreads + tid], acc);
      }
      const int64_t idx = base + i * d + col;
      const float s32 = ps[i * kThreads + tid];
      const T s_t = (S == kEf && sizeof(T) > sizeof(float))
                        ? __ldcs(a.s + idx)
                        : from_f32<T>(s32);
      const T diag_t = (S != kEf) ? from_f32<T>(0.f)
                       : ELL      ? from_f32<T>(diag)
                                  : a.diag[run * n + i];
      __stcs(a.y + idx,
             output<S>(acc, diag, diag_t, __ldcs(a.p + idx), s_t, s32));
    }
  }
}

// Whether every row of every buffer starts on a vector boundary: f32 or
// bf16 buffers, D a multiple of 4 and each buffer aligned to 4 of its
// elements (the f32 noise 16-byte, int8: 4-byte aligned).
template <typename T>
bool vector_rows(const EfArgs<T>& a) {
  if (sizeof(T) > 4 || a.d % kQuad) return false;
  const void* rows[] = {a.p, a.s, a.u, a.y, a.res};
  for (const void* ptr : rows) {
    if (ptr != nullptr && !aligned(ptr, kQuad * sizeof(T))) return false;
  }
  if (a.noise != nullptr && !aligned(a.noise, 16)) return false;
  const void* bytes[] = {a.q_in, a.q_out};
  for (const void* ptr : bytes) {
    if (ptr != nullptr && !aligned(ptr, 4)) return false;
  }
  return true;
}

template <int S, bool ELL, typename T>
int launch_ef(const EfArgs<T>& a, cudaStream_t stream) {
  if (a.r < 1 || a.r > kMaxR || a.n < 1 || a.n > kMaxN || a.d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ELL && a.max_deg < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (S == kEf && !ELL && a.diag == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.d == 0) return 0;
  if (a.n <= kSmallN) {
    constexpr int NB = kSmallN;
    const size_t smem =
        sizeof(float4) * NB * kThreads +
        (ELL ? sizeof(float) * (NB * a.max_deg + NB) +
                   sizeof(int32_t) * NB * a.max_deg
             : 0);
    const int64_t ntiles =
        (a.d + int64_t(kQuad) * kThreads - 1) / (int64_t(kQuad) * kThreads);
    if constexpr (sizeof(T) <= 4) {
      if (vector_rows(a)) {
        return launch_grid(ef_small_kernel<S, ELL, true, T>, a, ntiles, smem,
                           stream);
      }
    }
    return launch_grid(ef_small_kernel<S, ELL, false, T>, a, ntiles, smem,
                       stream);
  }
  const size_t smem = sizeof(float) * size_t(a.n) * kThreads;
  const int64_t ntiles = (a.d + kThreads - 1) / kThreads;
  return launch_grid(ef_general_kernel<S, ELL, T>, a, ntiles, smem, stream);
}

}  // namespace
}  // namespace feddec

extern "C" int ef_mix_dense(const float* w, const void* diag, const void* p,
                            const void* s, const void* u, void* y, void* res,
                            int64_t r, int64_t n, int64_t d, int dtype,
                            void* stream) {
  return feddec::by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    feddec::EfArgs<T> a{};
    a.w = w;
    a.diag = static_cast<const T*>(diag);
    a.p = static_cast<const T*>(p);
    a.s = static_cast<const T*>(s);
    a.u = static_cast<const T*>(u);
    a.y = static_cast<T*>(y);
    a.res = static_cast<T*>(res);
    a.r = r;
    a.n = n;
    a.d = d;
    return feddec::launch_ef<feddec::kEf, false>(
        a, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int ef_mix_ell(const int32_t* nbr, const float* wv,
                          const float* wd, int64_t max_deg, const void* p,
                          const void* s, const void* u, void* y, void* res,
                          int64_t r, int64_t n, int64_t d, int dtype,
                          void* stream) {
  return feddec::by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    feddec::EfArgs<T> a{};
    a.nbr = nbr;
    a.wv = wv;
    a.wd = wd;
    a.max_deg = max_deg;
    a.p = static_cast<const T*>(p);
    a.s = static_cast<const T*>(s);
    a.u = static_cast<const T*>(u);
    a.y = static_cast<T*>(y);
    a.res = static_cast<T*>(res);
    a.r = r;
    a.n = n;
    a.d = d;
    return feddec::launch_ef<feddec::kEf, true>(
        a, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int quant_mix_dense(const float* w, const float* scale,
                               const void* u, const float* noise,
                               const void* p, void* y, int8_t* q, int64_t r,
                               int64_t n, int64_t d, int dtype,
                               void* stream) {
  return feddec::by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    feddec::EfArgs<T> a{};
    a.w = w;
    a.scale = scale;
    a.u = static_cast<const T*>(u);
    a.noise = noise;
    a.p = static_cast<const T*>(p);
    a.y = static_cast<T*>(y);
    a.q_out = q;
    a.r = r;
    a.n = n;
    a.d = d;
    return feddec::launch_ef<feddec::kQuant, false>(
        a, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int dequant_mix_dense(const float* w, const float* scale,
                                 const int8_t* q, const void* p, void* y,
                                 int64_t r, int64_t n, int64_t d, int dtype,
                                 void* stream) {
  return feddec::by_dtype(dtype, [&](auto zero) {
    using T = decltype(zero);
    feddec::EfArgs<T> a{};
    a.w = w;
    a.scale = scale;
    a.q_in = q;
    a.p = static_cast<const T*>(p);
    a.y = static_cast<T*>(y);
    a.r = r;
    a.n = n;
    a.d = d;
    return feddec::launch_ef<feddec::kDequant, false>(
        a, static_cast<cudaStream_t>(stream));
  });
}
