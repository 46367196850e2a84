// Device code shared by gossip_mix.cu and update_mix.cu (compress_mix.cu
// takes its constants and launch_grid, with kernels of its own).
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
// momentum / nesterov step.  A column needs only its own n values, so a
// thread owns whole columns: it reads x/g/m of its columns once (row by
// row, neighbouring threads on neighbouring addresses), forms p in
// registers or in its own shared-memory slots, and writes the n outputs
// (and m').  p never touches device memory, so the fused update+mix moves
// the bytes of one pass: read x, g (, m), write y (, m').  At the main
// path's n = 8 the work is about 2n flop per 8 bytes, far below the
// card's ridge point: the bound is bytes, and the design's job is to keep
// enough independent loads in flight (all n rows of several columns are
// issued before any arithmetic uses them).
//
// Two launch shapes:
//   * small (n <= kSmallN = 8, the main path): n has a compile-time bound,
//     so the dense path keeps p in registers (fully unrolled) and W
//     (8 x 8, zero-padded) in static shared memory; the ELL path keeps the
//     tables in shared memory and p in per-thread shared slots (dynamic
//     neighbour indices cannot address registers).
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

#include <cuda_runtime.h>

#include <cstdint>

namespace feddec {

enum Update : int { kNone = 0, kSgd = 1, kMomentum = 2, kNesterov = 3 };

constexpr int kThreads = 128;
// General path: n * kThreads floats of shared memory per block.
constexpr int kMaxN = 400;

// Maximum run count: the grid's y dimension.
constexpr int64_t kMaxR = 65535;

struct Args {
  const float* w;        // (R, n, n) dense mixing matrices (dense only)
  const int32_t* nbr;    // (R, n, max_deg) ELL neighbour rows (ELL only)
  const float* wv;       // (R, n, max_deg) ELL edge weights, 0 on padding
  const float* wd;       // (R, n) diagonal weights W_ii
  const float* x;        // (R, n, D) parameters
  const float* g;        // (R, n, D) gradients (update kernels)
  const float* m;        // (R, n, D) f32 momentum (momentum kernels)
  const float* eta;      // (R,) f32 step sizes, read on the device
  float* y;              // (R, n, D) mixed output
  float* m_out;          // (R, n, D) new momentum (momentum kernels)
  int64_t r;
  int64_t n;
  int64_t d;
  int64_t max_deg;
  float beta;
};

// The reference optimizer's arithmetic, rounded op by op
// (repro/kernels/update_mix.py:_local_step): sgd p = x - eta*g;
// momentum m' = beta*m + g, step = m' (or beta*m' + g under nesterov),
// p = x - eta*step.  The explicit _rn intrinsics keep nvcc from
// contracting them into FMAs, so p equals the plain version's bit for bit.
template <int U>
__device__ __forceinline__ float local_step(const Args& a, int64_t idx,
                                            float eta) {
  const float x = __ldcs(a.x + idx);
  if (U == kNone) return x;
  const float g = __ldcs(a.g + idx);
  if (U == kSgd) return __fsub_rn(x, __fmul_rn(eta, g));
  const float m = __ldcs(a.m + idx);
  const float new_m = __fadd_rn(__fmul_rn(a.beta, m), g);
  __stcs(a.m_out + idx, new_m);
  const float step =
      (U == kNesterov) ? __fadd_rn(__fmul_rn(a.beta, new_m), g) : new_m;
  return __fsub_rn(x, __fmul_rn(eta, step));
}

// Small path: at most kSmallN agents and kSmallCols columns per thread,
// so 8 * 4 = 32 p values sit in registers.
constexpr int kSmallN = 8;
constexpr int kSmallCols = 4;
constexpr int64_t kSmallTile = int64_t(kSmallCols) * kThreads;

template <int U, bool ELL>
__global__ void __launch_bounds__(kThreads) mix_small_kernel(Args a) {
  constexpr int NB = kSmallN;
  constexpr int C = kSmallCols;
  const int n = static_cast<int>(a.n);
  const int md = static_cast<int>(a.max_deg);
  const int64_t d = a.d;
  const int tid = threadIdx.x;
  const int64_t run = blockIdx.y;
  const int64_t base = run * a.n * d;  // this run's (n, D) slice

  __shared__ float ws[ELL ? 1 : NB * NB];
  extern __shared__ float dyn[];
  float* ps = dyn;                              // ELL: NB*C*kThreads
  float* wv_s = dyn + NB * C * kThreads;        // ELL: n*md
  float* wd_s = wv_s + NB * md;                 // ELL: n
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
    if (!ELL) {
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
            __stcs(a.y + off + i * d + c * kThreads, acc[c]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < n) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            ps[(j * C + c) * kThreads + tid] =
                c * kThreads < rem
                    ? local_step<U>(a, off + j * d + c * kThreads, eta)
                    : 0.f;
          }
        }
      }
      // each thread reads back only its own slots: no barrier needed
      for (int i = 0; i < n; ++i) {
        float acc[C];
        const float wdi = wd_s[i];
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[c] = wdi * ps[(i * C + c) * kThreads + tid];
        for (int k = 0; k < md; ++k) {
          const int src = nbr_s[i * md + k];
          const float wk = wv_s[i * md + k];
#pragma unroll
          for (int c = 0; c < C; ++c)
            acc[c] = fmaf(wk, ps[(src * C + c) * kThreads + tid], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (c * kThreads < rem)
            __stcs(a.y + off + i * d + c * kThreads, acc[c]);
        }
      }
    }
  }
}

template <int U, bool ELL>
__global__ void __launch_bounds__(kThreads) mix_general_kernel(Args a) {
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
      __stcs(a.y + base + i * d + col, acc);
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

template <int U, bool ELL>
int launch_small(const Args& a, cudaStream_t stream) {
  constexpr int NB = kSmallN;
  const size_t smem =
      ELL ? sizeof(float) *
                    (size_t(NB) * kSmallCols * kThreads + NB * a.max_deg +
                     NB) +
                sizeof(int32_t) * NB * a.max_deg
          : 0;
  const int64_t ntiles = (a.d + kSmallTile - 1) / kSmallTile;
  return launch_grid(mix_small_kernel<U, ELL>, a, ntiles, smem, stream);
}

template <int U, bool ELL>
int launch_mix(const Args& a, cudaStream_t stream) {
  if (a.r < 1 || a.r > kMaxR || a.n < 1 || a.n > kMaxN || a.d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ELL && a.max_deg < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.d == 0) return 0;
  if (a.n <= kSmallN) return launch_small<U, ELL>(a, stream);
  const size_t smem = sizeof(float) * size_t(a.n) * kThreads;
  const int64_t ntiles = (a.d + kThreads - 1) / kThreads;
  return launch_grid(mix_general_kernel<U, ELL>, a, ntiles, smem, stream);
}

}  // namespace feddec
