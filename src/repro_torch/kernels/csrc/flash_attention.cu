// Causal grouped-query flash attention, optionally limited to a sliding
// window (the prefill of the attention layers), kernel #15.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas.  Same function: q is scaled by `scale` in f32
// before QK^T, key j is seen by query i when j <= i and, for window > 0,
// j > i - window; masked scores are -1e30, the softmax runs online with
// f32 running (max, denominator, accumulator), the probabilities stay f32
// in the PV product, and the output is acc / l in q's dtype.  Head h reads
// KV head h / (H / KV).
//
// Bound on the H100: operations.  Per (query, visible key) pair and head
// the product is 4*hd flop; at RecurrentGemma-9B's local layers (B 1,
// S 4096, H 16, hd 256, window 2048: 6.29M visible pairs per head) that is
// 103 GFLOP, 0.104 ms on the bf16 tensor cores, against 68 MB of q, k, v
// and out (0.020 ms at 3.35 TB/s).  This kernel computes in f32 on the
// CUDA cores (the Pallas body keeps P in f32), so it sits far from that
// bound: a tensor-core (wgmma) version is later work.
//
// Design: the Pallas kernel holds a head's whole K and V in VMEM, which
// shared memory cannot at S = 4096, so K and V stream through shared
// memory in tiles of 32 keys.  A block of 256 threads owns 64 queries of
// one (b, h); each warp owns 8 of them.  The key loop visits only the
// tiles in [q0 - window + 1, q_hi], so a local layer costs O(S * window).
// Per tile: q, k and v are staged as f32 (q pre-scaled, rows padded by 4
// floats so that a quarter warp's 16-byte reads of 8 key rows hit 32
// distinct banks); lane j scores key j against the warp's 8 queries; the
// row max and sum are warp shuffles; P goes to the warp's slice of shared
// memory; lane d accumulates output columns d, d + 32, ... of the 8 rows
// in registers.  The ragged end of S is masked in the kernel (rows and
// keys past S are zero-filled, keys past S scored -1e30, rows past S not
// written).  hd = 256 takes 141 KB of shared memory, above the 48 KB
// default, hence the opt-in attribute.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64, dtype 0 = f32 and 1 = bf16 for q, k, v and out.
// Returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBlockQ / kWarps;  // queries per warp
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {
  static constexpr int kQStride = HD + 4;
  static constexpr int kKStride = HD + 4;
  static constexpr int kVStride = HD;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBlockQ * kQStride;
  static constexpr int kV = kK + kBlockK * kKStride;
  static constexpr int kP = kV + kBlockK * kVStride;
  static constexpr size_t kBytes =
      sizeof(float) * (kP + kBlockQ * kBlockK);
};

// a 16-byte vector of T (4 f32 or 8 bf16) as f32 times `mul`
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       float mul) {
  if constexpr (std::is_same_v<T, float>) {
    const float4 f = *reinterpret_cast<const float4*>(&raw);
    out[0] = f.x * mul;
    out[1] = f.y * mul;
    out[2] = f.z * mul;
    out[3] = f.w * mul;
  } else {
    const __nv_bfloat162* pairs =
        reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      out[2 * i] = f.x * mul;
      out[2 * i + 1] = f.y * mul;
    }
  }
}

// rows [0, rows) of a (row_stride)-strided source into shared memory as
// f32 times `mul`; rows >= valid are zero-filled.  16-byte loads.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int dst_stride,
                                      const T* __restrict__ src,
                                      int64_t row_stride, int rows,
                                      int valid, float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int idx = threadIdx.x; idx < rows * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int col = (idx % kPerRow) * kVec;
    float vals[kVec];
    if (r < valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + r * row_stride + col);
      unpack<T>(raw, vals, mul);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      *reinterpret_cast<float4*>(dst + r * dst_stride + col + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int64_t s, int64_t h, int64_t kv_heads,
                           int64_t window, float scale) {
  using L = Layout<HD>;
  constexpr int kCols = HD / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem + L::kQ;
  float* s_k = smem + L::kK;
  float* s_v = smem + L::kV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* s_p = smem + L::kP + warp * kRows * kBlockK;

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBlockQ;
  const int64_t hh = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int64_t kvh = hh / (h / kv_heads);
  const int64_t q_last = (q0 + kBlockQ < s ? q0 + kBlockQ : s) - 1;

  stage<T, HD>(s_q, L::kQStride, q + ((bb * s + q0) * h + hh) * HD, h * HD,
               kBlockQ, static_cast<int>(q_last - q0 + 1), scale);

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  int64_t lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / kBlockK;
  const int64_t hi = q_last / kBlockK;
  for (int64_t kt = lo; kt <= hi; ++kt) {
    const int64_t k0 = kt * kBlockK;
    const int valid = static_cast<int>(s - k0 < kBlockK ? s - k0 : kBlockK);
    __syncthreads();  // the previous tile is consumed (and q is staged)
    const int64_t kv_off = ((bb * s + k0) * kv_heads + kvh) * HD;
    stage<T, HD>(s_k, L::kKStride, k + kv_off, kv_heads * HD, kBlockK,
                 valid, 1.0f);
    stage<T, HD>(s_v, L::kVStride, v + kv_off, kv_heads * HD, kBlockK,
                 valid, 1.0f);
    __syncthreads();

    // scores of key `lane` against the warp's rows
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.0f;
    const float* krow = s_k + lane * L::kKStride;
    const float* qrows = s_q + warp * kRows * L::kQStride;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(qrows + r * L::kQStride + d);
        sc[r] = fmaf(qq.x, kk.x, sc[r]);
        sc[r] = fmaf(qq.y, kk.y, sc[r]);
        sc[r] = fmaf(qq.z, kk.z, sc[r]);
        sc[r] = fmaf(qq.w, kk.w, sc[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int64_t kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t qpos = q0 + warp * kRows + r;
      bool seen = kpos <= qpos && kpos < s;
      if (window > 0) seen = seen && kpos > qpos - window;
      const float sv = seen ? sc[r] : kNegInf;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float pv = expf(sv - m_new);
      const float alpha = expf(m[r] - m_new);
      float sum = pv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
      s_p[r * kBlockK + lane] = pv;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc += P V: lane owns columns lane, lane + 32, ...
#pragma unroll 1
    for (int j = 0; j < kBlockK; j += 4) {
      float4 pr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        pr[r] = *reinterpret_cast<const float4*>(s_p + r * kBlockK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = s_v + (j + jj) * L::kVStride + lane;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float vv = vrow[c * 32];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float pj = jj == 0   ? pr[r].x
                             : jj == 1 ? pr[r].y
                             : jj == 2 ? pr[r].z
                                       : pr[r].w;
            acc[r][c] = fmaf(pj, vv, acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t qpos = q0 + warp * kRows + r;
    if (qpos < s) {
      T* orow = out + ((bb * s + qpos) * h + hh) * HD + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        orow[c * 32] = from_f32<T>(acc[r][c] / l[r]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t b, int64_t s, int64_t h, int64_t kv, int64_t window,
           float scale, cudaStream_t stream) {
  const auto kernel = flash_attention_kernel<T, HD>;
  const size_t smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(h), static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, h, kv, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int64_t b, int64_t s, int64_t h, int64_t kv, int64_t hd,
             int64_t window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, b, s, h, kv, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, s, h, kv, window, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, out, b, s, h, kv, window, scale,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int64_t b, int64_t s, int64_t h,
                               int64_t kv, int64_t hd, int64_t window,
                               float scale, int dtype, void* stream) {
  if (b < 0 || b > 65535 || s < 0 || h < 1 || h > 65535 || kv < 1 ||
      h % kv || window < 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || s == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(q, k, v, out, b, s, h, kv, hd, window,
                                      scale, st)
                    : dispatch<__nv_bfloat16>(q, k, v, out, b, s, h, kv, hd,
                                              window, scale, st);
}
