// RG-LRU linear recurrence h_t = a_t * h_{t-1} + bx_t from h_0 = 0
// (Griffin / RecurrentGemma prefill), kernel #17.
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py:rglru_scan_pallas,
// which walks (BLOCK_S, BLOCK_W) tiles of the sequence in VMEM with the
// carry in scratch; its wrapper pads S and W to those tiles, which this
// kernel does not need.  Bound on the H100: bytes.  Each element of a and
// bx is read once and each h written once (12 B per element in f32, 2
// flop), far below the ridge point.  At RecurrentGemma-9B's shape (B 1,
// S 4096, W 4096) that is 201 MB, 0.06 ms at 3.35 TB/s.
//
// Design: one thread per (b, channel), sequential over S; neighbouring
// threads own neighbouring channels, so every load and store is
// coalesced along W.  The recurrence is a dependent chain, so a thread
// loads kUnroll steps of a and bx ahead into registers before it runs
// them: the loads of a stretch are in flight together.  There are only
// B·W threads (4096 at the model's shape, one warp on each of 128 SMs):
// occupancy is low by construction; a chunked two-pass scan would raise
// it.  The product and the sum are rounded separately (__fmul_rn,
// __fadd_rn), as the plain version rounds them, so h equals it bit for
// bit; h_last is written from the same register as h[:, S-1].
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64, dtype 0 = f32 and 1 = bf16 for a and bx.  Returns the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;
constexpr int kUnroll = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                      float* __restrict__ h, float* __restrict__ h_last,
                      int64_t s, int64_t w) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (col >= w) return;
  const int64_t b = blockIdx.y;
  const int64_t base = b * s * w + col;
  float state = 0.0f;
  int64_t t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_f32(a[base + (t + u) * w]);
      bv[u] = to_f32(bx[base + (t + u) * w]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      h[base + (t + u) * w] = state;
    }
  }
  for (; t < s; ++t) {
    state = __fadd_rn(__fmul_rn(to_f32(a[base + t * w]), state),
                      to_f32(bx[base + t * w]));
    h[base + t * w] = state;
  }
  h_last[b * w + col] = state;
}

template <typename T>
int launch(const void* a, const void* bx, float* h, float* h_last,
           int64_t batch, int64_t s, int64_t w, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx), h, h_last, s, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rglru_scan(const void* a, const void* bx, float* h,
                          float* h_last, int64_t batch, int64_t s, int64_t w,
                          int dtype, void* stream) {
  if (batch < 0 || batch > 65535 || s < 1 || w < 0 ||
      (w + kThreads - 1) / kThreads > 0x7fffffff || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || w == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, bx, h, h_last, batch, s, w, st)
                    : launch<__nv_bfloat16>(a, bx, h, h_last, batch, s, w,
                                            st);
}
