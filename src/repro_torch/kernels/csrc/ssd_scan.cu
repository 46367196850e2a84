// Mamba2 SSD scan from a zero state (the SSM layer's prefill), kernel #16:
//
//   S_t = exp(dt_t * A_h) * S_{t-1} + (dt_t * x_t) (outer) B_t,
//   y_t = S_t C_t,
//
// with one (P, N) f32 state per (batch, head) and B, C shared by the heads.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_pallas, which
// walks the chunks of each (b, h) in order with the state in VMEM scratch
// and phrases each chunk as three matrix products; its wrapper pre-scales
// x and A by dt and broadcasts b and c to (B, H, NC, L, N).  Here the
// kernel applies dt itself and reads b and c as they are.  Bound on the
// H100: bytes at Mamba2-2.7B's shape (x and y (B, S, H, P), b, c, dt read
// or written once: 88 MB in bf16 at B 1, S 4096, H 80, P 64, N 128, 0.026
// ms at 3.35 TB/s; the chunked form's products are 16.4 GFLOP, 0.017 ms on
// the bf16 tensor cores).
//
// Design: the token-by-token recurrence, which computes the chunked form's
// function with fewer roundings (the chunked form's cumulative log-decays
// lose digits where dt*A is large).  A block owns 16 rows p of one
// (b, h) state, 128 threads: 8 threads share a row, each holding N/8 of
// its state columns in registers (column i*8 + q for thread q, so a warp
// reads 8 neighbouring words of shared memory per step).  Per token a
// thread updates its columns, S = S*exp(dt*A) + (dt*x_p)*B_n with the
// products and the sum rounded as the plain version rounds them, and adds
// S*C_n into a partial readout that three shuffles reduce over the 8
// threads.  B, C, dt*x and exp(dt*A) of 32 tokens are staged in shared
// memory per pass, so the token loop runs without barriers.  The grid is
// (P/16, H, B): 320 blocks at the model's shape.  The work is serial in
// the sequence (S steps per block), which is what bounds it in practice.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64, dtype 0 = f32 and 1 = bf16 for x, b, c and y (dt and a
// are f32).  Returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 16;  // state rows p of one block
constexpr int kSplit = 8;          // threads sharing one row
constexpr int kThreads = kRowsPerBlock * kSplit;
constexpr int kTokens = 32;        // tokens staged per pass
constexpr int kMaxCols = 32;       // N / kSplit at most (N <= 256)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

size_t smem_bytes(int64_t n) {
  return sizeof(float) *
         (2 * kTokens * n + kTokens * kRowsPerBlock + kTokens);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ b,
                    const T* __restrict__ c, T* __restrict__ y, int64_t s,
                    int64_t h, int64_t p, int n) {
  extern __shared__ __align__(16) float smem[];
  float* s_b = smem;                              // [kTokens][n]
  float* s_c = s_b + kTokens * n;                 // [kTokens][n]
  float* s_xl = s_c + kTokens * n;                // [kTokens][kRowsPerBlock]
  float* s_decay = s_xl + kTokens * kRowsPerBlock;  // [kTokens]

  const int tid = threadIdx.x;
  const int row = tid / kSplit;
  const int q = tid % kSplit;
  const int64_t hh = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int cols = n / kSplit;
  const float ah = a[hh];

  float st[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) st[i] = 0.0f;

  for (int64_t t0 = 0; t0 < s; t0 += kTokens) {
    const int nt = static_cast<int>(s - t0 < kTokens ? s - t0 : kTokens);
    __syncthreads();  // the previous pass is done with the staged tokens
    for (int idx = tid; idx < nt * n; idx += kThreads) {
      const int64_t src = (bb * s + t0) * n + idx;
      s_b[idx] = to_f32(b[src]);
      s_c[idx] = to_f32(c[src]);
    }
    for (int idx = tid; idx < nt * kRowsPerBlock; idx += kThreads) {
      const int tt = idx / kRowsPerBlock;
      const int64_t col = p0 + idx % kRowsPerBlock;
      const int64_t tok = bb * s + t0 + tt;
      s_xl[idx] = col < p
                      ? __fmul_rn(to_f32(x[(tok * h + hh) * p + col]),
                                  dt[tok * h + hh])
                      : 0.0f;
    }
    for (int tt = tid; tt < nt; tt += kThreads)
      s_decay[tt] = expf(__fmul_rn(dt[(bb * s + t0 + tt) * h + hh], ah));
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float decay = s_decay[tt];
      const float xl = s_xl[tt * kRowsPerBlock + row];
      const float* bt = s_b + tt * n;
      const float* ct = s_c + tt * n;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxCols; ++i) {
        if (i < cols) {
          const int col = i * kSplit + q;
          st[i] = __fadd_rn(__fmul_rn(st[i], decay), __fmul_rn(xl, bt[col]));
          acc = fmaf(st[i], ct[col], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      const int64_t pp = p0 + row;
      if (q == 0 && pp < p)
        y[((bb * s + t0 + tt) * h + hh) * p + pp] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, void* y, int64_t batch, int64_t s, int64_t h,
           int64_t p, int64_t n, cudaStream_t stream) {
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(
      static_cast<unsigned>((p + kRowsPerBlock - 1) / kRowsPerBlock),
      static_cast<unsigned>(h), static_cast<unsigned>(batch));
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), s, h, p,
      static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan(const void* x, const float* dt, const float* a,
                        const void* b, const void* c, void* y, int64_t batch,
                        int64_t s, int64_t h, int64_t p, int64_t n,
                        int dtype, void* stream) {
  if (batch < 0 || batch > 65535 || s < 0 || h < 0 || h > 65535 || p < 0 ||
      n < kSplit || n > kSplit * kMaxCols || n % kSplit || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || s == 0 || h == 0 || p == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(x, dt, a, b, c, y, batch, s, h, p, n, st)
             : launch<__nv_bfloat16>(x, dt, a, b, c, y, batch, s, h, p, n,
                                     st);
}
