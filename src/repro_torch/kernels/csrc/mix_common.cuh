// Device code shared by gossip_mix.cu and update_mix.cu.
//
// Every kernel here computes, per column c of the flat (n, D) buffer,
//
//     p_j = local_step(x[j, c], g[j, c], m[j, c])     j = 0 .. n-1
//     y[i, c] = sum_j W[i, j] p_j                      (dense mix)
//     y[i, c] = wd[i] p_i + sum_k wv[i, k] p_nbr[i, k] (ELL mix)
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
// The ragged edge of D is masked inside the kernel; all offsets are
// 64-bit (n * D passes 2^31 at n = 16 on the tiny LM).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace feddec {

enum Update : int { kNone = 0, kSgd = 1, kMomentum = 2, kNesterov = 3 };

constexpr int kThreads = 128;
// General path: n * kThreads floats of shared memory per block.
constexpr int kMaxN = 400;

struct Args {
  const float* w;        // (n, n) dense mixing matrix (dense only)
  const int32_t* nbr;    // (n, max_deg) ELL neighbour rows (ELL only)
  const float* wv;       // (n, max_deg) ELL edge weights, 0 on padding
  const float* wd;       // (n,) diagonal weights W_ii
  const float* x;        // (n, D) parameters
  const float* g;        // (n, D) gradients (update kernels)
  const float* m;        // (n, D) f32 momentum (momentum kernels)
  const float* eta;      // (1,) f32 step size, read on the device
  float* y;              // (n, D) mixed output
  float* m_out;          // (n, D) new momentum (momentum kernels)
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

  __shared__ float ws[ELL ? 1 : NB * NB];
  extern __shared__ float dyn[];
  float* ps = dyn;                              // ELL: NB*C*kThreads
  float* wv_s = dyn + NB * C * kThreads;        // ELL: n*md
  float* wd_s = wv_s + NB * md;                 // ELL: n
  int32_t* nbr_s = reinterpret_cast<int32_t*>(wd_s + NB);  // ELL: n*md

  if (!ELL) {
    for (int e = tid; e < NB * NB; e += kThreads) {
      const int i = e / NB, j = e % NB;
      ws[e] = (i < n && j < n) ? a.w[int64_t(i) * n + j] : 0.f;
    }
  } else {
    for (int e = tid; e < n * md; e += kThreads) {
      wv_s[e] = a.wv[e];
      nbr_s[e] = a.nbr[e];
    }
    for (int e = tid; e < n; e += kThreads) wd_s[e] = a.wd[e];
  }
  __syncthreads();

  const float eta = (U == kNone) ? 0.f : __ldg(a.eta);
  const int64_t ntiles = (d + kSmallTile - 1) / kSmallTile;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t col0 = t * kSmallTile + tid;
    if (!ELL) {
      float p[NB][C];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int64_t col = col0 + int64_t(c) * kThreads;
          p[j][c] = (j < n && col < d) ? local_step<U>(a, j * d + col, eta)
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
          const int64_t col = col0 + int64_t(c) * kThreads;
          if (col < d) __stcs(a.y + i * d + col, acc[c]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j < n) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int64_t col = col0 + int64_t(c) * kThreads;
            ps[(j * C + c) * kThreads + tid] =
                col < d ? local_step<U>(a, j * d + col, eta) : 0.f;
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
          const int64_t col = col0 + int64_t(c) * kThreads;
          if (col < d) __stcs(a.y + i * d + col, acc[c]);
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
  const float eta = (U == kNone) ? 0.f : __ldg(a.eta);
  const int64_t ntiles = (d + kThreads - 1) / kThreads;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t col = t * kThreads + tid;
    if (col >= d) continue;  // no barrier below: a thread may skip a tile
    for (int j = 0; j < n; ++j)
      ps[j * kThreads + tid] = local_step<U>(a, j * d + col, eta);
    for (int i = 0; i < n; ++i) {
      float acc;
      if (ELL) {
        acc = __ldg(a.wd + i) * ps[i * kThreads + tid];
        for (int k = 0; k < md; ++k) {
          const int src = __ldg(a.nbr + int64_t(i) * md + k);
          acc = fmaf(__ldg(a.wv + int64_t(i) * md + k),
                     ps[src * kThreads + tid], acc);
        }
      } else {
        acc = 0.f;
        for (int j = 0; j < n; ++j)
          acc = fmaf(__ldg(a.w + int64_t(i) * n + j), ps[j * kThreads + tid],
                     acc);
      }
      __stcs(a.y + i * d + col, acc);
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
// each striding over the column tiles.
template <typename Kernel>
int launch_grid(Kernel kernel, const Args& a, int64_t ntiles, size_t smem,
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
  const int grid = static_cast<int>(ntiles < full ? ntiles : full);
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
  if (a.n < 1 || a.n > kMaxN || a.d < 0) {
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
