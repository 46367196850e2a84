// Device code shared by gossip_mix.cu and update_mix.cu (compress_mix.cu
// takes its constants, the element helpers and launch_grid, with kernels
// of its own).
//
// Every kernel here computes, per run r and column c of the (R, n, D)
// buffer (R = 1 for the single-run kernels, R runs of a sweep lattice for
// the batched ones),
//
//     p_j = local_step(x[r, j, c], g[r, j, c], m[r, j, c])   j = 0 .. n-1
//     y[r, i, c] = sum_j W[r, i, j] p_j                        (dense mix)
//     y[r, i, c] = wd[r, i] p_i + sum_k wv[r, i, k] p_nbr[r, i, k]  (ELL)
//
// with local_step the identity (plain gossip), the sgd step or the
// momentum / nesterov step.  The buffer's element type T is f32, f64 or
// bf16, as in the reference's Pallas kernels, which load the buffer's
// dtype, mix in f32 and store the buffer's dtype
// (repro/kernels/gossip_mix.py:41-44, repro/kernels/update_mix.py:_local_step
// and _dense_mix): the optimizer step runs in T (the momentum in f32), p is
// rounded to f32 for the mix, W and the ELL weights are f32, and y is the
// f32 sum converted to T.  A bf16 step rounds where XLA rounds the
// reference's kernel body (step_value below).
//
// A column needs only its own n values, so a thread owns whole columns: it
// reads x/g/m of its columns once (row by row, neighbouring threads on
// neighbouring addresses), forms p in registers or in its own
// shared-memory slots, and writes the n outputs (and m').  p never touches
// device memory, so the fused update+mix moves the bytes of one pass: read
// x, g (, m), write y (, m').  At the main path's n = 8 the work is about
// 2n flop per 8 bytes, far below the card's ridge point: the bound is
// bytes, and the design's job is to keep enough independent loads in
// flight (all n rows of several columns are issued before any arithmetic
// uses them).
//
// Two launch shapes:
//   * small (n <= kSmallN = 8, the main path): W (8 x 8, zero-padded) or
//     the ELL tables sit in shared memory and p in the thread's own
//     shared-memory slots (dynamic neighbour indices cannot address
//     registers), and a thread owns 4 adjacent columns, so that each row
//     is one 16-byte access of x, g, m, y (8 bytes of a bf16 buffer) where
//     D % 4 == 0 and every buffer's base is aligned to 4 elements
//     (compress_mix.cu's layout), and 4 masked scalar accesses elsewhere
//     (the ragged edge, a misaligned base, an f64 buffer); but the dense
//     mix of an f64 buffer keeps p in registers (fully unrolled, 4
//     columns a thread strided by the block), which its scalar accesses
//     read faster.
//   * general (8 < n <= kMaxN): p in per-thread shared slots, W or the
//     ELL tables read through the read-only cache (warp-uniform
//     addresses, one broadcast transaction each).
// The run is the grid's y index, so one launch covers the whole lattice
// and a block only ever strides over the tiles of its own run: the W or
// ELL table it loaded into shared memory is that run's.  The per-column
// arithmetic does not depend on R, so each run's slice equals the
// single-run kernel's output on that slice bit for bit (a padded ELL slot
// adds fmaf(0, p, acc) == acc).  The ragged edge of D is masked inside
// the kernel; all offsets are 64-bit (R * n * D is 2.5e9 on the tiny-LM
// lattice of R = 2, n = 8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace feddec {

enum Update : int { kNone = 0, kSgd = 1, kMomentum = 2, kNesterov = 3 };
// The buffer's element type as the wrappers pass it (kernels/ops.py).
enum Dtype : int { kF32 = 0, kF64 = 1, kBF16 = 2 };

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
// General path: n * kThreads floats of shared memory per block.
constexpr int kMaxN = 400;

// Maximum run count: the grid's y dimension.
constexpr int64_t kMaxR = 65535;

template <typename T>
struct Args {
  const float* w;        // (R, n, n) dense mixing matrices (dense only)
  const int32_t* nbr;    // (R, n, max_deg) ELL neighbour rows (ELL only)
  const float* wv;       // (R, n, max_deg) ELL edge weights, 0 on padding
  const float* wd;       // (R, n) diagonal weights W_ii
  const T* x;            // (R, n, D) parameters
  const T* g;            // (R, n, D) gradients (update kernels)
  const float* m;        // (R, n, D) f32 momentum (momentum kernels)
  const float* eta;      // (R,) f32 step sizes, read on the device
  T* y;                  // (R, n, D) mixed output
  float* m_out;          // (R, n, D) new momentum (momentum kernels)
  int64_t r;
  int64_t n;
  int64_t d;
  int64_t max_deg;
  float beta;
};

// One IEEE operation in the element type, rounded on its own: the _rn
// intrinsics keep nvcc from contracting a product and a sum into an FMA.
// A bf16 operation is the f32 one rounded to bf16, as torch's and XLA's
// bf16 ops compute it (a bf16 sum or product rounded once in f32 and
// again in bf16 is the correctly rounded bf16 result: 24 >= 2 * 8 + 2).
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ bf16 add_rn(bf16 a, bf16 b) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ bf16 sub_rn(bf16 a, bf16 b) {
  return __float2bfloat16_rn(
      __fsub_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ bf16 mul_rn(bf16 a, bf16 b) {
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}

// An element as f32 (an f64 one rounded to nearest, the others exact).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) {
  return __double2float_rn(v);
}
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// An f32 value in the element type, rounded to nearest.
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// x - eta * step as the mix reads it, in f32.  f32 and f64: the
// reference optimizer's arithmetic in x's type, rounded op by op, then
// rounded to f32.  bf16: XLA rounds the product eta * step to bf16 (eta
// rounded to bf16 first) but keeps the difference in f32, since the mix
// converts it to f32 straight away (repro/kernels/update_mix.py:59-62
// under jit; kernels/ref.py:_local_step_bf16).
template <typename T>
__device__ __forceinline__ float minus_step(T x, float eta, T step) {
  return to_f32(sub_rn(x, mul_rn(from_f32<T>(eta), step)));
}
__device__ __forceinline__ float minus_step(bf16 x, float eta, bf16 step) {
  return __fsub_rn(__bfloat162float(x),
                   __bfloat162float(mul_rn(__float2bfloat16_rn(eta), step)));
}

// beta * a + b in f32: rounded op by op for f32 and f64 buffers, one fused
// multiply-add for a bf16 buffer, as XLA contracts the reference's
// momentum update there.
template <typename T>
__device__ __forceinline__ float momentum_add(float beta, float a, float b) {
  if constexpr (std::is_same_v<T, bf16>) return __fmaf_rn(beta, a, b);
  return __fadd_rn(__fmul_rn(beta, a), b);
}

// The reference optimizer's step (repro/kernels/update_mix.py:_local_step):
// sgd p = x - eta*g; momentum m' = beta*m + g in f32, step = m' (or
// beta*m' + g under nesterov) in x's type, p = x - eta*step; p in f32 for
// the mix.  So p equals the plain version's bit for bit.
template <int U, typename T>
__device__ __forceinline__ float step_value(T x, T g, float m, float eta,
                                            float beta, float* new_m) {
  if (U == kNone) return to_f32(x);
  if (U == kSgd) return minus_step(x, eta, g);
  const float g32 = to_f32(g);
  *new_m = momentum_add<T>(beta, m, g32);
  const float step =
      (U == kNesterov) ? momentum_add<T>(beta, *new_m, g32) : *new_m;
  return minus_step(x, eta, from_f32<T>(step));
}

// p of one element, in f32 for the mix (m' written on the way).
template <int U, typename T>
__device__ __forceinline__ float local_step(const Args<T>& a, int64_t idx,
                                            float eta) {
  const T x = __ldcs(a.x + idx);
  if (U == kNone) return to_f32(x);
  const T g = __ldcs(a.g + idx);
  const float m = U >= kMomentum ? __ldcs(a.m + idx) : 0.f;
  float new_m;
  const float p = step_value<U>(x, g, m, eta, a.beta, &new_m);
  if (U >= kMomentum) __stcs(a.m_out + idx, new_m);
  return p;
}

// Four adjacent elements idx .. idx+3 of a row, nv of them inside D: one
// vector access when VEC (16 bytes of an f32 row, 8 of a bf16 row, on
// such a boundary), else nv scalar ones.  Missing elements read as 0 and
// are not written.
constexpr int kQuad = 4;

template <typename T>
struct Quad {
  T v[kQuad];
};

// The vector type of four elements of T.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<bf16> {
  using type = uint2;
};

template <bool VEC, typename T>
__device__ __forceinline__ Quad<T> ldq(const T* p, int64_t idx, int nv) {
  Quad<T> q;
  if constexpr (VEC) {
    static_assert(sizeof(T) == 4 || sizeof(T) == 2,
                  "vector rows are f32 or bf16 rows");
    using V = typename Vec4<T>::type;
    const V v = __ldcs(reinterpret_cast<const V*>(p + idx));
    static_assert(sizeof(V) == sizeof(Quad<T>), "one quad per vector");
    memcpy(&q, &v, sizeof(V));
  } else {
#pragma unroll
    for (int k = 0; k < kQuad; ++k)
      q.v[k] = k < nv ? __ldcs(p + idx + k) : from_f32<T>(0.f);
  }
  return q;
}

template <bool VEC, typename T>
__device__ __forceinline__ void stq(T* p, int64_t idx, const Quad<T>& q,
                                    int nv) {
  if constexpr (VEC) {
    static_assert(sizeof(T) == 4 || sizeof(T) == 2,
                  "vector rows are f32 or bf16 rows");
    using V = typename Vec4<T>::type;
    V v;
    memcpy(&v, &q, sizeof(V));
    __stcs(reinterpret_cast<V*>(p + idx), v);
  } else {
#pragma unroll
    for (int k = 0; k < kQuad; ++k)
      if (k < nv) __stcs(p + idx + k, q.v[k]);
  }
}

// An f32 quad (the mix's sum) in the buffer's type.
template <typename T>
__device__ __forceinline__ Quad<T> to_quad(float4 f) {
  return Quad<T>{{from_f32<T>(f.x), from_f32<T>(f.y), from_f32<T>(f.z),
                  from_f32<T>(f.w)}};
}

// Small path: at most kSmallN agents and kSmallCols columns per thread,
// so 8 * 4 = 32 p values sit in registers.
constexpr int kSmallN = 8;
constexpr int kSmallCols = 4;
constexpr int64_t kSmallTile = int64_t(kSmallCols) * kThreads;

// Dense mix of an f64 buffer, n <= kSmallN: column c of a thread's tile
// is off + c * kThreads, so each row access of a warp is 256 adjacent
// bytes; mix_quad_small_kernel's four scalar 8-byte accesses a thread
// (no 32-byte vector) ran 1.6-15.5% slower on the H100 (PERF.md).
template <int U, typename T>
__global__ void __launch_bounds__(kThreads) mix_dense_small_kernel(
    Args<T> a) {
  constexpr int NB = kSmallN;
  constexpr int C = kSmallCols;
  const int n = static_cast<int>(a.n);
  const int64_t d = a.d;
  const int tid = threadIdx.x;
  const int64_t run = blockIdx.y;
  const int64_t base = run * a.n * d;  // this run's (n, D) slice

  __shared__ float ws[NB * NB];
  const float* w = a.w + run * n * n;
  for (int e = tid; e < NB * NB; e += kThreads) {
    const int i = e / NB, j = e % NB;
    ws[e] = (i < n && j < n) ? w[i * n + j] : 0.f;
  }
  __syncthreads();

  const float eta = (U == kNone) ? 0.f : __ldg(a.eta + run);
  const int64_t ntiles = (d + kSmallTile - 1) / kSmallTile;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // Column c of this thread's tile is off + c * kThreads in row 0 of the
    // run's slice; it exists while c * kThreads < rem.  One 64-bit offset
    // per thread, so the run axis costs no register per column.
    const int64_t col0 = t * kSmallTile + tid;
    const int64_t rem = d - col0;
    const int64_t off = base + col0;
    float p[NB][C];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        p[j][c] = (j < n && c * kThreads < rem)
                      ? local_step<U>(a, off + j * d + c * kThreads, eta)
                      : 0.f;
      }
    }
    for (int i = 0; i < n; ++i) {
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float wij = ws[i * NB + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(wij, p[j][c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c * kThreads < rem)
          __stcs(a.y + off + i * d + c * kThreads, from_f32<T>(acc[c]));
      }
    }
  }
}

// p of 4 adjacent elements of a row, as f32 (m' written on the way).
template <int U, bool VEC, typename T>
__device__ __forceinline__ float4 step4(const Args<T>& a, int64_t idx,
                                        float eta, int nv) {
  const Quad<T> x = ldq<VEC>(a.x, idx, nv);
  float p[kQuad];
  if (U == kNone) {
#pragma unroll
    for (int k = 0; k < kQuad; ++k) p[k] = to_f32(x.v[k]);
  } else {
    const Quad<T> g = ldq<VEC>(a.g, idx, nv);
    Quad<float> m{}, nm{};
    if (U >= kMomentum) m = ldq<VEC>(a.m, idx, nv);
#pragma unroll
    for (int k = 0; k < kQuad; ++k)
      p[k] = step_value<U>(x.v[k], g.v[k], m.v[k], eta, a.beta, &nm.v[k]);
    if (U >= kMomentum) stq<VEC>(a.m_out, idx, nm, nv);
  }
  return make_float4(p[0], p[1], p[2], p[3]);
}

// ELL mix, and the dense mix of an f32 or bf16 buffer, n <= kSmallN:
// thread t of a block owns the 4 adjacent columns 4 (tile * kThreads + t)
// .. + 3 of its run's slice.  It forms p of all n rows of them in its own
// shared-memory slots (the optimizer step, m' written right away), then
// y_i = wd_i p_i + sum_k wv_ik p_nbr(i,k) (ELL) or sum_j W_ij p_j (dense)
// from the slots, one row at a time.  A thread reads back only its own
// slots, so no barrier follows the table load.  A bf16 row is then one
// 8-byte access, an f32 row one 16-byte access: a column a thread (2- and
// 4-byte loads) reached 43-59% of the bf16 bound on the H100 and 71-83%
// of the f32 one, this layout 79-87% in both (PERF.md).
template <int U, bool ELL, bool VEC, typename T>
__global__ void __launch_bounds__(kThreads) mix_quad_small_kernel(
    Args<T> a) {
  constexpr int NB = kSmallN;
  const int n = static_cast<int>(a.n);
  const int md = static_cast<int>(a.max_deg);
  const int64_t d = a.d;
  const int tid = threadIdx.x;
  const int64_t run = blockIdx.y;
  const int64_t base = run * a.n * d;  // this run's (n, D) slice

  __shared__ float ws[ELL ? 1 : NB * NB];
  extern __shared__ float4 dyn4[];
  float4* ps = dyn4;                                              // NB*kThreads
  float* wv_s = reinterpret_cast<float*>(dyn4 + NB * kThreads);  // n*md
  float* wd_s = wv_s + NB * md;                                   // n
  int32_t* nbr_s = reinterpret_cast<int32_t*>(wd_s + NB);         // n*md

  if (ELL) {
    const int64_t tab = run * n * md;
    for (int e = tid; e < n * md; e += kThreads) {
      wv_s[e] = a.wv[tab + e];
      nbr_s[e] = a.nbr[tab + e];
    }
    for (int e = tid; e < n; e += kThreads) wd_s[e] = a.wd[run * n + e];
  } else {
    const float* w = a.w + run * n * n;
    for (int e = tid; e < NB * NB; e += kThreads) {
      const int i = e / NB, j = e % NB;
      ws[e] = (i < n && j < n) ? w[i * n + j] : 0.f;
    }
  }
  __syncthreads();

  const float eta = (U == kNone) ? 0.f : __ldg(a.eta + run);
  constexpr int64_t kTile = int64_t(kQuad) * kThreads;
  const int64_t ntiles = (d + kTile - 1) / kTile;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t col = (t * kThreads + tid) * kQuad;
    if (col >= d) continue;  // no barrier below: a thread may skip a tile
    const int nv = d - col < kQuad ? static_cast<int>(d - col) : kQuad;
    const int64_t off = base + col;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (j < n)
        ps[j * kThreads + tid] = step4<U, VEC>(a, off + j * d, eta, nv);
    }
    for (int i = 0; i < n; ++i) {
      float4 acc;
      if (ELL) {
        const float wdi = wd_s[i];
        const float4 pi = ps[i * kThreads + tid];
        acc = make_float4(wdi * pi.x, wdi * pi.y, wdi * pi.z, wdi * pi.w);
        for (int k = 0; k < md; ++k) {
          const float wk = wv_s[i * md + k];
          const float4 pk = ps[nbr_s[i * md + k] * kThreads + tid];
          acc = make_float4(fmaf(wk, pk.x, acc.x), fmaf(wk, pk.y, acc.y),
                            fmaf(wk, pk.z, acc.z), fmaf(wk, pk.w, acc.w));
        }
      } else {
        acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < n; ++j) {
          const float wij = ws[i * NB + j];
          const float4 pj = ps[j * kThreads + tid];
          acc = make_float4(fmaf(wij, pj.x, acc.x), fmaf(wij, pj.y, acc.y),
                            fmaf(wij, pj.z, acc.z), fmaf(wij, pj.w, acc.w));
        }
      }
      stq<VEC>(a.y, off + i * d, to_quad<T>(acc), nv);
    }
  }
}

template <int U, bool ELL, typename T>
__global__ void __launch_bounds__(kThreads) mix_general_kernel(Args<T> a) {
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
  const float eta = (U == kNone) ? 0.f : __ldg(a.eta + run);
  const int64_t ntiles = (d + kThreads - 1) / kThreads;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t col = t * kThreads + tid;
    if (col >= d) continue;  // no barrier below: a thread may skip a tile
    for (int j = 0; j < n; ++j)
      ps[j * kThreads + tid] = local_step<U>(a, base + j * d + col, eta);
    for (int i = 0; i < n; ++i) {
      float acc;
      if (ELL) {
        acc = __ldg(wd + i) * ps[i * kThreads + tid];
        for (int k = 0; k < md; ++k) {
          const int src = __ldg(nbr + i * md + k);
          acc = fmaf(__ldg(wv + i * md + k), ps[src * kThreads + tid], acc);
        }
      } else {
        acc = 0.f;
        for (int j = 0; j < n; ++j)
          acc = fmaf(__ldg(w + i * n + j), ps[j * kThreads + tid], acc);
      }
      __stcs(a.y + base + i * d + col, from_f32<T>(acc));
    }
  }
}

inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// One persistent-style grid: as many blocks as fit on the card at once,
// shared out over the runs (grid y), each striding over its run's column
// tiles.  ``A`` is the kernel's argument struct; its run count is ``a.r``.
template <typename Kernel, typename A>
int launch_grid(Kernel kernel, const A& a, int64_t ntiles, size_t smem,
                cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t full = int64_t(per_sm) * sm_count();
  const int64_t per_run = (full + a.r - 1) / a.r;
  const dim3 grid(static_cast<unsigned>(ntiles < per_run ? ntiles : per_run),
                  static_cast<unsigned>(a.r));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// Whether every row of every buffer starts on a boundary of 4 of its
// elements (D % 4 == 0, aligned bases): the condition of the vector
// accesses, which f32 and bf16 buffers take (an f64 row never does).
template <typename T>
bool vector_rows(const Args<T>& a) {
  if (sizeof(T) > 4 || a.d % kQuad) return false;
  const void* rows[] = {a.x, a.g, a.y};
  for (const void* ptr : rows) {
    if (ptr != nullptr && !aligned(ptr, kQuad * sizeof(T))) return false;
  }
  const void* f32_rows[] = {a.m, a.m_out};
  for (const void* ptr : f32_rows) {
    if (ptr != nullptr && !aligned(ptr, 16)) return false;
  }
  return true;
}

template <int U, bool ELL, typename T>
int launch_mix(const Args<T>& a, cudaStream_t stream) {
  if (a.r < 1 || a.r > kMaxR || a.n < 1 || a.n > kMaxN || a.d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ELL && a.max_deg < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.d == 0) return 0;
  // f64 dense: a column a thread; every other small mix: four adjacent
  // columns a thread
  if constexpr (!ELL && sizeof(T) == 8) {
    if (a.n <= kSmallN) {
      const int64_t ntiles = (a.d + kSmallTile - 1) / kSmallTile;
      return launch_grid(mix_dense_small_kernel<U, T>, a, ntiles, 0, stream);
    }
  }
  if (a.n <= kSmallN) {
    constexpr int NB = kSmallN;
    const size_t smem =
        sizeof(float4) * NB * kThreads +
        (ELL ? (sizeof(float) + sizeof(int32_t)) * NB * a.max_deg +
                   sizeof(float) * NB
             : 0);
    const int64_t ntiles =
        (a.d + int64_t(kQuad) * kThreads - 1) / (int64_t(kQuad) * kThreads);
    if constexpr (sizeof(T) <= 4) {
      if (vector_rows(a)) {
        return launch_grid(mix_quad_small_kernel<U, ELL, true, T>, a, ntiles,
                           smem, stream);
      }
    }
    return launch_grid(mix_quad_small_kernel<U, ELL, false, T>, a, ntiles,
                       smem, stream);
  }
  const size_t smem = sizeof(float) * size_t(a.n) * kThreads;
  const int64_t ntiles = (a.d + kThreads - 1) / kThreads;
  return launch_grid(mix_general_kernel<U, ELL, T>, a, ntiles, smem, stream);
}

// Calls f with a zero of the buffer's element type: f(0.f) for an f32
// buffer, f(0.0) for an f64 one, f(bf16 0) for a bf16 one;
// cudaErrorInvalidValue for another dtype code.  The entry points
// instantiate their launch for the three types by it.
template <typename F>
int by_dtype(int dtype, F&& f) {
  if (dtype == kF32) return f(0.f);
  if (dtype == kF64) return f(0.0);
  if (dtype == kBF16) return f(__float2bfloat16_rn(0.f));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace feddec
