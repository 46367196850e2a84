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
// Design: the recurrence is a chain of S steps per channel, but a short
// one (4096 steps of a multiply and an add, ~18 us at the card's clock);
// what bounds it is keeping enough bytes in flight to the few threads it
// has.  A block owns kCh = 32 channels of one batch row and walks all of
// S: warp 0 runs the recurrence (one lane a channel), warp 1 is a
// producer that keeps a ring of kStages slots of (kSteps tokens x kCh
// channels) tiles of a and bx filled ahead of it, 64 KB in flight per
// block in f32 (one block per SM at the model's shape).  The producer's
// lanes fill a slot by 16-byte cp.async copies and hand it over with
// cp.async.mbarrier.arrive.noinc on the slot's "full" mbarrier (it
// completes when every lane's copies have landed); the consumer hands a
// slot back on its "empty" mbarrier.  (One cp.async.bulk per 128-byte
// token row into the same ring timed several times slower on the H100:
// the bulk copies are too small.)  Rows that are not 16-byte multiples
// (W*size % 16 != 0, or unaligned buffers) are copied with plain loads
// instead.  h is stored straight from the consumer's registers, one
// coalesced 128-byte row of the tile per step (staging it through shared
// memory for bulk stores would save little: dropping the stores altogether
// timed only a few percent faster); h_last from the same register as
// h[:, S-1].
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn),
// as the plain version rounds them, so h equals it bit for bit.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64, dtype 0 = f32 and 1 = bf16 for a and bx.  Returns the
// cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCh = 32;      // channels of a block (the consumer's lanes)
constexpr int kSteps = 32;   // tokens of a ring slot
constexpr int kStages = 8;   // ring slots
constexpr int kThreads = 64; // warp 0 consumes, warp 1 produces

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// 16 bytes by cp.async, and the arrival on `bar` once this thread's
// copies so far have landed
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                      float* __restrict__ h, float* __restrict__ h_last,
                      int64_t s, int64_t w, int vec) {
  constexpr int kSlot = kSteps * kCh;  // elements of one array in a slot
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_a = reinterpret_cast<T*>(smem);      // [kStages][kSteps][kCh]
  T* ring_b = ring_a + kStages * kSlot;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_b + kStages * kSlot);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kCh;
  const int cols = static_cast<int>(w - col0 < kCh ? w - col0 : kCh);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s * w + col0;
  const int64_t slots = (s + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 32);  // the producer's lanes
      mbar_init(empty + st, 1);  // the consumer's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 1) {  // producer
    const int per_row = static_cast<int>(cols * sizeof(T) / 16);
    constexpr int kPer16 = 16 / sizeof(T);  // elements of a 16-byte copy
    for (int64_t it = 0; it < slots; ++it) {
      const int st = static_cast<int>(it % kStages);
      if (it >= kStages)
        mbar_wait(empty + st, static_cast<uint32_t>((it / kStages - 1) & 1));
      const int64_t t0 = it * kSteps;
      const int steps = static_cast<int>(s - t0 < kSteps ? s - t0 : kSteps);
      T* da = ring_a + st * kSlot;
      T* db = ring_b + st * kSlot;
      const int64_t src = base + t0 * w;
      if (vec) {
        for (int q = lane; q < steps * per_row; q += 32) {
          const int r = q / per_row, col = (q % per_row) * kPer16;
          cp_async16(da + r * kCh + col, a + src + r * w + col);
          cp_async16(db + r * kCh + col, bx + src + r * w + col);
        }
        cp_async_arrive(full + st);
      } else {
        if (lane < cols) {
#pragma unroll 8
          for (int r = 0; r < steps; ++r) {
            da[r * kCh + lane] = a[src + r * w + lane];
            db[r * kCh + lane] = bx[src + r * w + lane];
          }
        }
        mbar_arrive(full + st);
      }
    }
  } else {  // consumer: lane = channel
    float state = 0.f;
    float* hp = h + base + lane;
    for (int64_t it = 0; it < slots; ++it) {
      const int st = static_cast<int>(it % kStages);
      mbar_wait(full + st, static_cast<uint32_t>((it / kStages) & 1));
      const int64_t t0 = it * kSteps;
      const int steps = static_cast<int>(s - t0 < kSteps ? s - t0 : kSteps);
      const T* sa = ring_a + st * kSlot + lane;
      const T* sb = ring_b + st * kSlot + lane;
      if (lane < cols) {
        if (steps == kSteps) {
#pragma unroll
          for (int r = 0; r < kSteps; ++r) {
            state = __fadd_rn(__fmul_rn(to_f32(sa[r * kCh]), state),
                              to_f32(sb[r * kCh]));
            hp[(t0 + r) * w] = state;
          }
        } else {
          for (int r = 0; r < steps; ++r) {
            state = __fadd_rn(__fmul_rn(to_f32(sa[r * kCh]), state),
                              to_f32(sb[r * kCh]));
            hp[(t0 + r) * w] = state;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    if (lane < cols) h_last[blockIdx.y * w + col0 + lane] = state;
  }
}

template <typename T>
int launch(const void* a, const void* bx, float* h, float* h_last,
           int64_t batch, int64_t s, int64_t w, cudaStream_t stream) {
  const size_t smem =
      2 * kStages * kSteps * kCh * sizeof(T) + 2 * kStages * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = (w * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                  aligned(a) && aligned(bx);
  const dim3 grid(static_cast<unsigned>((w + kCh - 1) / kCh),
                  static_cast<unsigned>(batch));
  rglru_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx), h, h_last, s, w,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rglru_scan(const void* a, const void* bx, float* h,
                          float* h_last, int64_t batch, int64_t s, int64_t w,
                          int dtype, void* stream) {
  if (batch < 0 || batch > 65535 || s < 1 || w < 0 ||
      (w + kCh - 1) / kCh > 0x7fffffff || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || w == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, bx, h, h_last, batch, s, w, st)
                    : launch<__nv_bfloat16>(a, bx, h, h_last, batch, s, w,
                                            st);
}
