// Causal grouped-query flash attention, optionally limited to a sliding
// window (the prefill of the attention layers), kernel #15.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas.  Same function: key j is seen by query i when
// j <= i and, for window > 0, j > i - window; masked scores are -1e30, the
// softmax runs online with f32 running (max, denominator, accumulator),
// the probabilities keep f32 accuracy in the PV product, and the output is
// acc / l in q's dtype.  Head h reads KV head h / (H / KV).
//
// Bound on the H100: operations.  Per (query, visible key) pair and head
// the product is 4*hd flop; at RecurrentGemma-9B's local layers (B 1,
// S 4096, H 16, hd 256, window 2048: 6.29M visible pairs per head) that is
// 103 GFLOP, 0.104 ms on the bf16 tensor cores, against 68 MB of q, k, v
// and out (0.020 ms at 3.35 TB/s).
//
// bf16 inputs: the tensor cores (wgmma), with the reference's function.
//   * A product of two bf16 values is exact in f32, so S = Q K^T from bf16
//     operands with f32 accumulation is the f32 product of the upcast
//     values up to the order of summation.  The scale (1/sqrt(hd) is no
//     power of two) is applied to S in f32, folded with log2(e) into one
//     multiply ahead of exp2.
//   * P splits into P_hi = bf16(P) and P_lo = bf16(P - P_hi); P_hi V +
//     P_lo V accumulated in f32 carries P to about 2^-16 relative error,
//     2^7 below the rounding of the bf16 output.  So the kernel keeps the
//     Pallas body's f32 P (and not the xla path's one-product bf16 P) at
//     1.5x the operations of one PV product.
//   Design: a block is two consumer warpgroups of 64 query rows each.
//   When the heads of a KV group come in pairs (H / KV even: MQA and GQA)
//   the two serve two heads of one KV head on the same 64 rows, so every
//   K/V tile feeds both and their key ranges coincide; otherwise they
//   take 128 consecutive rows of one head.  K and V tiles of 64 keys
//   arrive by cp.async (16 bytes a thread, zero-filled past S) into a
//   two-stage ring in shared memory while the previous tile is consumed;
//   Q, K and V sit there as bf16 in 128-byte swizzled atoms of 64 columns,
//   the layout wgmma reads without bank conflicts.  S comes from
//   wgmma m64n64k16 with both operands in shared memory (K-major); the
//   mask, the scale and the online softmax run in registers (the row max
//   and sum over the quad of threads that hold a row); P_hi and P_lo go
//   straight from S's accumulator registers into the A operand of two
//   wgmma m64n{hd}k16 per 16 keys, with V as the MN-major B operand
//   (transposed by the hardware, as it allows for 16-bit types).  The key
//   loop visits only the tiles in [q0 - window + 1, q_last], so a local
//   layer costs O(S * window); the ragged end of S is masked in the
//   kernel.  At hd 256 a block takes 193 KB of shared memory (one block
//   of 8 warps per SM) and a thread holds the 64 x 256 f32 accumulator
//   of its warpgroup in 128 registers.
//
// f32 inputs: CUDA cores, as the Pallas body computes in f32 and one TF32
// product would not keep it (TF32 stays off in the port).  A block of 256
// threads owns 64 queries of one (b, h); each warp owns 8 of them.  K and
// V stream through shared memory in tiles of 32 keys, staged as f32 (q
// pre-scaled, rows padded by 4 floats so that a quarter warp's 16-byte
// reads of 8 key rows hit 32 distinct banks); lane j scores key j against
// the warp's 8 queries; the row max and sum are warp shuffles; P goes to
// the warp's slice of shared memory; lane d accumulates output columns
// d, d + 32, ... of the 8 rows in registers.  hd = 256 takes 141 KB of
// shared memory, above the 48 KB default, hence the opt-in attribute.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64, dtype 0 = f32 and 1 = bf16 for q, k, v and out.
// Returns the cudaError_t of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBlockQ / kWarps;  // queries per warp

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

// rows [0, rows) of a (row_stride)-strided source into shared memory
// times `mul`; rows >= valid are zero-filled.  16-byte loads.
template <int HD>
__device__ __forceinline__ void stage(float* dst, int dst_stride,
                                      const float* __restrict__ src,
                                      int64_t row_stride, int rows,
                                      int valid, float mul) {
  constexpr int kPerRow = HD / 4;
  for (int idx = threadIdx.x; idx < rows * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int col = (idx % kPerRow) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      f = *reinterpret_cast<const float4*>(src + r * row_stride + col);
      f = make_float4(f.x * mul, f.y * mul, f.z * mul, f.w * mul);
    }
    *reinterpret_cast<float4*>(dst + r * dst_stride + col) = f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ out, int64_t s,
           int64_t h, int64_t kv_heads, int64_t window, float scale) {
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

  stage<HD>(s_q, L::kQStride, q + ((bb * s + q0) * h + hh) * HD, h * HD,
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
    stage<HD>(s_k, L::kKStride, k + kv_off, kv_heads * HD, kBlockK, valid,
              1.0f);
    stage<HD>(s_v, L::kVStride, v + kv_off, kv_heads * HD, kBlockK, valid,
              1.0f);
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
      float* orow = out + ((bb * s + qpos) * h + hh) * HD + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c) orow[c * 32] = acc[r][c] / l[r];
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t b, int64_t s, int64_t h, int64_t kv, int64_t window,
           float scale, cudaStream_t stream) {
  const auto fn = kernel<HD>;
  const size_t smem = Layout<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(h), static_cast<unsigned>(b));
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, h, kv,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 64;          // query rows per consumer warpgroup
constexpr int kBlockN = 64;          // keys per tile
constexpr int kGroups = 2;           // consumer warpgroups per block
constexpr int kThreads = 128 * kGroups;
constexpr float kLog2e = 1.4426950408889634f;

// A tile of `Rows` rows x HD bf16 columns in shared memory: HD / 64 atoms
// of Rows x 128 bytes, each 1024-byte aligned; in row r of an atom the
// 16-byte chunk c sits at chunk c ^ (r % 8) (the 128-byte swizzle that
// wgmma's descriptors name with layout type 1).
template <int Rows>
__device__ __forceinline__ uint32_t swizzled(int r, int chunk) {
  return (chunk / 8) * (Rows * 128) + r * 128 +
         (((chunk % 8) ^ (r % 8)) << 4);
}

template <int HD>
struct Smem {
  static constexpr uint32_t kQ = kBlockM * HD * 2;   // one warpgroup's Q
  static constexpr uint32_t kKV = kBlockN * HD * 2;  // one K or V tile
  static constexpr uint32_t kKVStart = kGroups * kQ;
  // two stages of (K, V), and 1 KB to align the base
  static constexpr size_t kBytes = kKVStart + 2 * 2 * kKV + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, Rows) of a (row_stride)-strided bf16 source into a swizzled
// tile by cp.async; rows >= valid are zero-filled (no bytes read).
template <int HD, int Rows>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const bf16* __restrict__ src,
                                          int64_t row_stride, int valid) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < Rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = r < valid;
    cp_async16(dst + swizzled<Rows>(r, c),
               ok ? src + r * row_stride + c * 8 : src, ok ? 16 : 0);
  }
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (in 16-byte units), 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A B (scale_d 0) or d += A B (scale_d 1), A (64 x 16) and B
// (64 keys x 16) in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A (64 x 16) in registers (the accumulator layout of a
// 64 x 16 slice, two bf16 per register), B (16 x 64) in shared memory,
// MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A (64 x 16) in registers (the accumulator layout of a
// 64 x 16 slice, two bf16 per register), B (16 x 128) in shared memory,
// MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A (64 x 16) in registers (the accumulator layout of a
// 64 x 16 slice, two bf16 per register), B (16 x 256) in shared memory,
// MN-major (imm-trans-b 1).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for one warpgroup's 64 rows against a 64-key tile: HD / 16
// wgmma steps, each 16 columns (32 bytes) further into the swizzle atom.
template <int HD>
__device__ __forceinline__ void qk_tile(float (&sc)[kBlockN / 2],
                                        uint32_t sq, uint32_t sk) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t off = (ks / 4) * (kBlockM * 128) + (ks % 4) * 32;
    wgmma_ss_n64(sc, desc(sq + off, 16, 1024), desc(sk + off, 16, 1024),
                 ks > 0);
  }
  wgmma_commit_wait();
  hold(sc);
}

// O += P_hi V + P_lo V over a 64-key tile: per 16 keys, V's rows start
// 2048 bytes further; its HD / 64 atoms lie kBlockN * 128 bytes apart
// (the leading byte offset of an MN-major operand), its 8-row groups
// 1024 bytes apart (the stride byte offset).
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2],
                                        const uint32_t (&ph)[kBlockN / 4],
                                        const uint32_t (&pl)[kBlockN / 4],
                                        uint32_t sv) {
  hold(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBlockN / 16; ++j) {
    const uint64_t db = desc(sv + j * 16 * 128, kBlockN * 128, 1024);
    if constexpr (HD == 64) {
      wgmma_rs_n64(o, ph + 4 * j, db);
      wgmma_rs_n64(o, pl + 4 * j, db);
    } else if constexpr (HD == 128) {
      wgmma_rs_n128(o, ph + 4 * j, db);
      wgmma_rs_n128(o, pl + 4 * j, db);
    } else {
      wgmma_rs_n256(o, ph + 4 * j, db);
      wgmma_rs_n256(o, pl + 4 * j, db);
    }
  }
  wgmma_commit_wait();
  hold(o);
}

// P in S's accumulator registers -> (P_hi, P_lo) as the A operand of the
// PV product: register 4j + q holds accumulator entries 8j + 2q, 8j + 2q + 1
// (the fragment of keys 16j .. 16j + 15), low half first.
__device__ __forceinline__ void split_p(const float (&p)[kBlockN / 2],
                                        uint32_t (&ph)[kBlockN / 4],
                                        uint32_t (&pl)[kBlockN / 4]) {
#pragma unroll
  for (int i = 0; i < kBlockN / 4; ++i) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hi);
    const __nv_bfloat162 lo =
        __floats2bfloat162_rn(p[2 * i] - hf.x, p[2 * i + 1] - hf.y);
    ph[i] = *reinterpret_cast<const uint32_t*>(&hi);
    pl[i] = *reinterpret_cast<const uint32_t*>(&lo);
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Block (x, y, z): z the batch row, y a pair of heads of one KV head (or
// one head when `pair` is 0), x the query rows.  Warpgroup g takes head
// y * (1 + pair) + g % (1 + pair) and 64 rows from q0.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out, int64_t s,
           int64_t h, int64_t kv_heads, int64_t window, float scale_log2,
           int pair) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const int g = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int hpb = 1 + pair;                      // heads per block
  const int64_t rows = kBlockM * kGroups / hpb;  // query rows per block
  const int64_t qbase = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t head0 = static_cast<int64_t>(blockIdx.y) * hpb;
  const int64_t bb = blockIdx.z;
  const int64_t kvh = head0 / (h / kv_heads);
  const int64_t q_last = (qbase + rows < s ? qbase + rows : s) - 1;

  // every warpgroup's Q tile, then the first K/V tile
#pragma unroll
  for (int w = 0; w < kGroups; ++w) {
    const int64_t qw = qbase + (w / hpb) * kBlockM;
    const int64_t left = s - qw;  // rows past S: no bytes read
    load_tile<HD, kBlockM>(
        base + w * L::kQ,
        q + ((bb * s + (left > 0 ? qw : 0)) * h + head0 + w % hpb) * HD,
        h * HD, static_cast<int>(left < 0 ? 0 : left < 64 ? left : 64));
  }
  cp_async_commit();
  int64_t lo = 0;
  if (window > 0 && qbase - window + 1 > 0)
    lo = (qbase - window + 1) / kBlockN;
  const int64_t hi = q_last / kBlockN;
  const int64_t kv_stride = kv_heads * HD;
  auto load_kv = [&](int64_t kt, int st) {
    const int64_t k0 = kt * kBlockN;
    const int valid = static_cast<int>(s - k0 < kBlockN ? s - k0 : kBlockN);
    const int64_t off = (bb * s + k0) * kv_stride + kvh * HD;
    const uint32_t dst = base + L::kKVStart + st * 2 * L::kKV;
    load_tile<HD, kBlockN>(dst, k + off, kv_stride, valid);
    load_tile<HD, kBlockN>(dst + L::kKV, v + off, kv_stride, valid);
    cp_async_commit();
  };
  load_kv(lo, 0);

  const int64_t q0 = qbase + (g / hpb) * kBlockM;
  const int64_t head = head0 + g % hpb;
  const int64_t qp0 = q0 + warp * 16 + lane / 4;  // this thread's two rows
  const int64_t qp1 = qp0 + 8;
  const uint32_t sq = base + g * L::kQ;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int64_t kt = lo; kt <= hi; ++kt) {
    const int st = static_cast<int>((kt - lo) & 1);
    if (kt < hi) {
      load_kv(kt + 1, st ^ 1);  // into the stage the last tile freed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // this thread's copies are done; make them visible to wgmma's proxy,
    // then wait for everyone's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t sk = base + L::kKVStart + st * 2 * L::kKV;

    float sc[kBlockN / 2];
    qk_tile<HD>(sc, sq, sk);

    // mask, scale (with log2 e, for exp2) and the online softmax; entry i
    // is key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2 of row qp0 (i & 2 == 0)
    // or qp1
    const int64_t k0 = kt * kBlockN + 2 * (lane % 4);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      const int64_t kpos = k0 + 8 * (i / 4) + (i % 2);
      const int64_t qpos = (i & 2) ? qp1 : qp0;
      const bool seen = kpos <= qpos && kpos < s &&
                        (window <= 0 || kpos > qpos - window);
      sc[i] = seen ? sc[i] * scale_log2 : kNegInf;
      if (i & 2) {
        mx1 = fmaxf(mx1, sc[i]);
      } else {
        mx0 = fmaxf(mx0, sc[i]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2_approx(m0 - mn0);
    const float alpha1 = exp2_approx(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      sc[i] = exp2_approx(sc[i] - ((i & 2) ? mn1 : mn0));
      if (i & 2) {
        sum1 += sc[i];
      } else {
        sum0 += sc[i];
      }
    }
    l0 = alpha0 * l0 + quad_sum(sum0);
    l1 = alpha1 * l1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;

    uint32_t ph[kBlockN / 4], pl[kBlockN / 4];
    split_p(sc, ph, pl);
    pv_tile<HD>(o, ph, pl, sk + L::kKV);
    __syncthreads();  // the stage is consumed: the next load may refill it
  }

  // out = O / l in bf16, two adjacent columns per store
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int64_t qpos = (i & 2) ? qp1 : qp0;
    const float li = (i & 2) ? l1 : l0;
    if (qpos < s) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((bb * s + qpos) * h + head) * HD + col) =
          __floats2bfloat162_rn(o[i] / li, o[i + 1] / li);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t b, int64_t s, int64_t h, int64_t kv, int64_t window,
           float scale, cudaStream_t stream) {
  const auto fn = kernel<HD>;
  const size_t smem = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pair = (h / kv) % 2 == 0 ? 1 : 0;
  const int64_t rows = kBlockM * kGroups / (1 + pair);
  const dim3 grid(static_cast<unsigned>((s + rows - 1) / rows),
                  static_cast<unsigned>(h / (1 + pair)),
                  static_cast<unsigned>(b));
  fn<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s, h, kv, window,
      scale * kLog2e, pair);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <int HD>
int dispatch_hd(int dtype, const void* q, const void* k, const void* v,
                void* out, int64_t b, int64_t s, int64_t h, int64_t kv,
                int64_t window, float scale, cudaStream_t stream) {
  return dtype == 0
             ? f32::launch<HD>(q, k, v, out, b, s, h, kv, window, scale,
                               stream)
             : tc::launch<HD>(q, k, v, out, b, s, h, kv, window, scale,
                              stream);
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
  switch (hd) {
    case 64:
      return dispatch_hd<64>(dtype, q, k, v, out, b, s, h, kv, window, scale,
                             st);
    case 128:
      return dispatch_hd<128>(dtype, q, k, v, out, b, s, h, kv, window,
                              scale, st);
    case 256:
      return dispatch_hd<256>(dtype, q, k, v, out, b, s, h, kv, window,
                              scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
