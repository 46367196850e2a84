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
// Design: the chunked form (chunks of L tokens: 128 on the bf16 route, 64
// on the f32 one), parallel over chunks, in three passes of one call:
//   1. chunk_state: per (chunk, head, P tile) the chunk's own state
//      sum_j exp(s+_j) dt_j x_j (outer) B_j, s+_j = sum_{k>j} la_k (la =
//      dt*A), and exp(total) of the chunk;
//   2. state_pass: per (head, state element) the short recurrence over the
//      chunks, S_c = exp(total_c) S_{c-1} + local_c, in f32, writing the
//      state each chunk starts from;
//   3. chunk_output: per (chunk, group of kHeads heads, P tile) y_i =
//      exp(cum_i) C_i S_{c-1} + sum_{j<=i} (C_i . B_j) exp(seg_ij) dt_j x_j.
// Every exponent is a direct segment sum of la (all la <= 0, so no sum
// cancels): s+ and the within-tile segments are summed from their ends; a
// segment that crosses into a 16-row tile from before it is the sum of its
// two parts, seg_ij = (sum_{j<k<=a} la_k) + (sum_{a<k<=i} la_k) with a the
// tile's first row, and exp(seg_ij) is taken as the product of the two
// parts' exponentials; cum_i = (sum_{k<=a} la_k) + the second part.  The
// reference's exp(cum_i - cum_j) loses digits where dt*A is large (cum
// reaches -200 within a chunk); these do not.
//
// bf16 inputs run the products on the tensor cores (mma.sync m16n8k16,
// f32 accumulation): x, B and C are bf16 and exact there, and the f32
// operand of each product (x scaled by exp(s+) dt, the decayed C.B^T, or
// the state S) is split into bf16 hi + lo pieces, two products each (as
// #15's P.V); pass 2 writes S as its two pieces.  In pass 3 a warp owns
// 16-row tiles of the chunk: C.B^T up to the diagonal (formed once for the
// head group), the decay applied in registers, the result used straight
// from the accumulators as the A operand of (.)x; the tiles above the
// diagonal are skipped.  Operands are staged in shared memory by cp.async
// and read by ldmatrix (.trans where the stored layout is MN-major).  f32
// inputs take the same passes with the products on the CUDA cores (fmaf),
// f32 throughout: no TF32.  The chunk length trades the state traffic of
// passes 1-3 (the chunk states are 84 MB at L = 128 at Mamba2-2.7B's
// shape, twice that at 64) against the quadratic intra-chunk work.
//
// Scratch from the caller (ssd_scan_scratch): per (batch, head, chunk) the
// chunk's own state and the state it starts from, (P rounded to 64, N
// rounded to 16) f32 each (the second as bf16 hi then lo on the bf16
// route), and exp(total) per chunk, (B, H, NC) f32.
//
// Plain C interface for ctypes: pointers and the CUDA stream as void*,
// sizes as int64, dtype 0 = f32 and 1 = bf16 for x, b, c and y (dt and a
// are f32).  Returns the cudaError_t of the launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 128;    // tokens of a chunk (bf16 route)
constexpr int kChunkF32 = 64;  // tokens of a chunk (f32 route)
constexpr int kTile = 64;          // P rows (and N columns in pass 1)
constexpr int kScanThreads = 256;
constexpr int kHeads = 10;  // heads of a pass-3 block
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
constexpr bool kTC = std::is_same<T, bf16>::value;

// Shared-memory row padding (elements): bf16 rows of 16 k are 32 bytes,
// so K + 8 makes a row an odd number of 16-byte units (ldmatrix reads 8
// rows on distinct banks); f32 rows K + 4 stay 16-byte multiples.
template <typename T>
__host__ __device__ constexpr int pad() {
  return kTC<T> ? 8 : 4;
}

__host__ __device__ constexpr int64_t round_up(int64_t v, int64_t m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ bf16 zero<bf16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes by cp.async; 0 source bytes (a zero fill) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// rows [0, rows) x cols [0, cols) of a row-major global tile (row stride
// `stride` elements) into shared rows of `ld`; entries past rows_valid or
// cols_valid are 0.  `vec`: 16-byte cp.async copies (cols_valid, stride
// and the tile's start all multiples of 16 bytes), else one element at a
// time.  A thread's (row, column) advances without a division.
template <typename T, int kThreads>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t stride, int rows,
                                          int rows_valid, int cols,
                                          int cols_valid, bool vec) {
  const int v = vec ? static_cast<int>(16 / sizeof(T)) : 1;
  const int per_row = cols / v;
  int r = threadIdx.x / per_row;
  int col = (threadIdx.x % per_row) * v;
  const int dr = kThreads / per_row, dc = (kThreads % per_row) * v;
  while (r < rows) {
    const bool ok = r < rows_valid && col < cols_valid;
    if (vec)
      cp_async16(dst + r * ld + col, ok ? src + r * stride + col : src, ok);
    else
      dst[r * ld + col] = ok ? src[r * stride + col] : zero<T>();
    r += dr;
    col += dc;
    if (col >= cols) {
      col -= cols;
      ++r;
    }
  }
}

// bf16 hi/lo pieces of (v0, v1), packed as the mma operands' pairs
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  if (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  }
}

// The A operand (16 x 16, rows m0.., k0..) of mma.m16n8k16: stored [m][k]
// (kKMajor) or [k][m].
template <bool kKMajor>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* s,
                                       int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, i = lane >> 3, q = lane & 7;
  if (kKMajor)
    ldsm4<false>(r, s + (m0 + q + (i & 1) * 8) * ld + k0 + (i >> 1) * 8);
  else
    ldsm4<true>(r, s + (k0 + q + (i >> 1) * 8) * ld + m0 + (i & 1) * 8);
}

// The B operands of two n-tiles (k0.., n0.. and n0 + 8..): r[0..1] and
// r[2..3]; stored [n][k] (kKMajor) or [k][n].
template <bool kKMajor>
__device__ __forceinline__ void load_b2(uint32_t (&r)[4], const bf16* s,
                                        int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, i = lane >> 3, q = lane & 7;
  if (kKMajor)
    ldsm4<false>(r, s + (n0 + q + (i >> 1) * 8) * ld + k0 + (i & 1) * 8);
  else
    ldsm4<true>(r, s + (k0 + q + (i & 1) * 8) * ld + n0 + (i >> 1) * 8);
}

// suf[k] = sum_{k <= k' < L} v(k') for k < L, suf[L] = 0: one warp, L / 32
// values a lane summed from the end, the lanes' sums joined by shuffles.
template <int L, typename F>
__device__ __forceinline__ void warp_suffix_sum(float* suf, F v) {
  constexpr int kPer = L / 32;
  const int lane = threadIdx.x & 31;
  float part[kPer];
  float run = 0.f;
#pragma unroll
  for (int u = kPer - 1; u >= 0; --u) {
    run += v(lane * kPer + u);
    part[u] = run;
  }
  float tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float later = __shfl_down_sync(kFull, tot, o);
    if (lane + o < 32) tot += later;
  }
  float after = __shfl_down_sync(kFull, tot, 1);
  if (lane == 31) after = 0.f;
#pragma unroll
  for (int u = 0; u < kPer; ++u) suf[lane * kPer + u] = after + part[u];
  if (lane == 0) suf[L] = 0.f;
}

template <typename T>
struct Args {
  const T* x;
  const float* dt;
  const float* a;
  const T* b;
  const T* c;
  T* y;
  float* local;   // (B, H, NC, ppad, nk) f32: each chunk's own state
  float* enter;   // the state each chunk starts from: f32, or (bf16) the
                  // slot's hi (ppad, nk) then lo (ppad, nk)
  float* decay;   // (B, H, NC): exp(sum of the chunk's la)
  int64_t s, h, p, per;  // per: floats of a slot, ppad * nk
  int n, nk, ppad, npt, nc;
  int heads;  // pass 3: heads per block
  bool vec_x, vec_bc;
};

// ---------------------------------------------------------------------------
// Pass 1: the chunk's own state for one head and P tile:
// local[p][n] = sum_j (x[j][p] exp(s+_j) dt_j) B[j][n].  Eight warps, warp
// w the rows p in [16 (w % 4), +16) and the 64-column tiles n of parity
// w / 4; x scaled by w_j is the f32 operand (split into hi + lo on the
// bf16 route), B exact.
// (A block that walks a group of heads with B loaded once timed slower.)
// ---------------------------------------------------------------------------

template <typename T, int L>
__host__ __device__ constexpr size_t state_smem(int nk) {
  return sizeof(T) * (L * (kTile + pad<T>()) + L * (nk + pad<T>())) +
         (kTC<T> ? sizeof(bf16) * L * (kTile + pad<T>()) : 0) +
         sizeof(float) * (2 * L + L + 4);
}

constexpr int kStateThreads = 256;

template <typename T, int L>
__global__ void __launch_bounds__(kStateThreads) chunk_state_kernel(Args<T> g) {
  constexpr int kThreads = kStateThreads;
  constexpr int ldx = kTile + pad<T>();
  const int ldb = g.nk + pad<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_x = reinterpret_cast<T*>(smem);   // [L][ldx]: x[j][p], then x w (hi)
  T* s_b = s_x + L * ldx;                // [L][ldb]: B[j][n]
  bf16* s_xlo = reinterpret_cast<bf16*>(s_b + L * ldb);  // bf16: lo pieces
  float* s_dt = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(s_b + L * ldb) +
      (kTC<T> ? sizeof(bf16) * L * ldx : 0));
  float* s_la = s_dt + L;
  float* s_suf = s_la + L;               // [L + 1]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int pt = blockIdx.x % g.npt;
  const int64_t hh = blockIdx.x / g.npt;
  const int64_t bb = blockIdx.z;
  const int64_t c = blockIdx.y;
  const int64_t tok0 = c * L;
  const int valid = static_cast<int>(g.s - tok0 < L ? g.s - tok0 : L);
  const int p0 = pt * kTile;
  const int64_t bh = bb * g.h + hh;

  load_tile<T, kThreads>(s_x, ldx, g.x + ((bb * g.s + tok0) * g.h + hh) *
                                            g.p + p0,
                         g.h * g.p, L, valid, kTile,
                         static_cast<int>(g.p - p0 < kTile ? g.p - p0
                                                           : kTile),
                         g.vec_x);
  load_tile<T, kThreads>(s_b, ldb, g.b + (bb * g.s + tok0) * g.n, g.n, L,
                         valid, g.nk, g.n, g.vec_bc);
  for (int j = tid; j < L; j += kThreads) {
    const float d = j < valid ? g.dt[(bb * g.s + tok0 + j) * g.h + hh] : 0.f;
    s_dt[j] = d;
    s_la[j] = __fmul_rn(d, g.a[hh]);
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) {
    warp_suffix_sum<L>(s_suf, [&](int k) { return s_la[k]; });
    if (lane == 0 && pt == 0) g.decay[bh * g.nc + c] = expf(s_suf[0]);
    __syncwarp();
    for (int j = lane; j < L; j += 32)  // w_j = exp(s+_j) dt_j, in place
      s_dt[j] = expf(s_suf[j + 1]) * s_dt[j];
  }
  __syncthreads();
  // x[j][p] w_j; bf16: hi in place, lo beside
  for (int idx = tid; idx < L * kTile / 2; idx += kThreads) {
    const int j = idx / (kTile / 2), col = 2 * (idx % (kTile / 2));
    const float wj = s_dt[j];
    T* e = s_x + j * ldx + col;
    const float v0 = to_f32(e[0]) * wj, v1 = to_f32(e[1]) * wj;
    if constexpr (kTC<T>) {
      uint32_t hi, lo;
      split2(v0, v1, hi, lo);
      *reinterpret_cast<uint32_t*>(e) = hi;
      *reinterpret_cast<uint32_t*>(s_xlo + j * ldx + col) = lo;
    } else {
      e[0] = v0;
      e[1] = v1;
    }
  }
  __syncthreads();

  const int wp = warp & 3;  // this warp's 16 rows p, and n-tile parity
  float* out = g.local + (bh * g.nc + c) * g.per +
               static_cast<int64_t>(p0 + 16 * wp + gq) * g.nk + 2 * tq;
  for (int n0 = kTile * (warp >> 2); n0 < g.nk; n0 += 2 * kTile) {
    const int tiles = (g.nk - n0) / 8 < kTile / 8 ? (g.nk - n0) / 8
                                                   : kTile / 8;  // even
    float acc[kTile / 8][4];
#pragma unroll
    for (int q = 0; q < kTile / 8; ++q)
      acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
    if constexpr (kTC<T>) {
#pragma unroll
      for (int k0 = 0; k0 < L; k0 += 16) {
        uint32_t ah[4], al[4], bf[kTile / 16][4];
        load_a<false>(ah, s_x, ldx, 16 * wp, k0);      // (x w)^T: [j][p]
        load_a<false>(al, s_xlo, ldx, 16 * wp, k0);
#pragma unroll
        for (int q = 0; q < kTile / 16; ++q)
          if (2 * q < tiles)
            load_b2<false>(bf[q], s_b, ldb, k0, n0 + 16 * q);  // B: [j][n]
        // the hi products of every tile, then the lo ones
#pragma unroll
        for (int q = 0; q < kTile / 16; ++q) {
          if (2 * q < tiles) {
            mma(acc[2 * q], ah, bf[q][0], bf[q][1]);
            mma(acc[2 * q + 1], ah, bf[q][2], bf[q][3]);
          }
        }
#pragma unroll
        for (int q = 0; q < kTile / 16; ++q) {
          if (2 * q < tiles) {
            mma(acc[2 * q], al, bf[q][0], bf[q][1]);
            mma(acc[2 * q + 1], al, bf[q][2], bf[q][3]);
          }
        }
      }
    } else {
      const int m0 = 16 * wp + gq;
      for (int k = 0; k < L; ++k) {
        const float x0 = s_x[k * ldx + m0], x1 = s_x[k * ldx + m0 + 8];
#pragma unroll
        for (int q = 0; q < kTile / 8; ++q) {
          if (q < tiles) {
            const float b0 = s_b[k * ldb + n0 + 8 * q + 2 * tq];
            const float b1 = s_b[k * ldb + n0 + 8 * q + 2 * tq + 1];
            acc[q][0] = fmaf(x0, b0, acc[q][0]);
            acc[q][1] = fmaf(x0, b1, acc[q][1]);
            acc[q][2] = fmaf(x1, b0, acc[q][2]);
            acc[q][3] = fmaf(x1, b1, acc[q][3]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kTile / 8; ++q) {
      if (q < tiles) {
        store_pair(out + n0 + 8 * q, acc[q][0], acc[q][1]);
        store_pair(out + 8 * g.nk + n0 + 8 * q, acc[q][2], acc[q][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: S_c = exp(total_c) S_{c-1} + local_c over the chunks in f32, 4
// state elements a thread; writes the state chunk c starts from (bf16
// route: as its hi and lo pieces, the readout's operands).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
    state_pass_kernel(const float* __restrict__ local,
                      float* __restrict__ enter,
                      const float* __restrict__ decay, int nc, int64_t per) {
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * kScanThreads +
                     threadIdx.x) * 4;
  if (e >= per) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * gridDim.y +
                     blockIdx.y;
  const float4* src = reinterpret_cast<const float4*>(local + bh * nc * per +
                                                      e);
  const float* dec = decay + bh * nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 8;  // chunks whose loads are in flight together
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 v[kAhead];
    float d[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u < nc) {
        v[u] = src[(c0 + u) * (per / 4)];
        d[u] = dec[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (c0 + u < nc) {
        float* slot = enter + (bh * nc + c0 + u) * per;
        if constexpr (kTC<T>) {
          uint2 hi, lo;
          split2(s.x, s.y, hi.x, lo.x);
          split2(s.z, s.w, hi.y, lo.y);
          bf16* half = reinterpret_cast<bf16*>(slot);
          *reinterpret_cast<uint2*>(half + e) = hi;
          *reinterpret_cast<uint2*>(half + per + e) = lo;
        } else {
          *reinterpret_cast<float4*>(slot + e) = s;
        }
        s = make_float4(fmaf(d[u], s.x, v[u].x), fmaf(d[u], s.y, v[u].y),
                        fmaf(d[u], s.z, v[u].z), fmaf(d[u], s.w, v[u].w));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3: y of one chunk for a group of heads (and one P tile).  Four
// warps; warp w takes the 16-row tiles w and, for L = 128, 7 - w (the
// causal work of the pair is the same for every w), and every column p of
// the tile.  C.B^T does not depend on the head: it is formed once, kept
// raw in registers, and decayed per head.  Each head's x tile and starting
// state arrive by cp.async into one buffer (two, so that the next head's
// arrive while one runs, timed slower: half the blocks fit on an SM).
// ---------------------------------------------------------------------------

constexpr int kOutThreads = 128;

// floats of a pass-3 warp's scratch: suf [L + 1], wcol [L], the diagonal
// tile's segment sums [16][17] and its rows' F [16]
template <int L>
constexpr int kWarpScratch = 2 * L + 1 + 16 * 17 + 16;

template <typename T, int L>
struct OutSmem {
  int ldn, ldx;
  size_t x_bytes, buf_bytes, c_off, buf0, g_off, dt_off, warp_off, total;
  __host__ __device__ OutSmem(int nk, int heads) {
    ldn = nk + pad<T>();
    ldx = kTile + pad<T>();
    x_bytes = sizeof(T) * L * ldx;
    const size_t b_bytes = sizeof(T) * L * ldn;
    buf_bytes = x_bytes + (kTC<T> ? 2 * sizeof(bf16) : sizeof(float)) *
                              kTile * ldn;  // S: hi, lo (bf16) or f32
    if (buf_bytes < b_bytes) buf_bytes = b_bytes;  // B waits in a buffer
    c_off = 0;
    buf0 = c_off + sizeof(T) * L * ldn;
    g_off = buf0 + buf_bytes;
    // f32: each warp's G rows [16][L + 4]
    dt_off = g_off + (kTC<T> ? 0 : sizeof(float) * 4 * 16 * (L + 4));
    warp_off = dt_off + sizeof(float) * heads * L;
    total = warp_off + sizeof(float) * 4 * kWarpScratch<L>;
  }
};

// C.B^T of the rows [16m, 16m + 16) of the chunk, n-tiles up to the
// diagonal (2m + 2), from C[i][n] and B[j][n] in shared memory
template <typename T, int NT>
__device__ __forceinline__ void cb_rows(float (&cb)[NT][4], int m,
                                        const T* s_c, const T* s_b, int ldn,
                                        int nk) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int a0 = 16 * m, nt_cb = 2 * m + 2;
#pragma unroll
  for (int q = 0; q < NT; ++q) cb[q][0] = cb[q][1] = cb[q][2] = cb[q][3] = 0.f;
  if constexpr (kTC<T>) {
#pragma unroll
    for (int k0 = 0; k0 < nk; k0 += 16) {
      uint32_t af[4];
      load_a<true>(af, s_c, ldn, a0, k0);            // C: stored [i][n]
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        if (2 * q < nt_cb) {
          uint32_t bf[4];
          load_b2<true>(bf, s_b, ldn, k0, 16 * q);   // B: stored [j][n]
          mma(cb[2 * q], af, bf[0], bf[1]);
          mma(cb[2 * q + 1], af, bf[2], bf[3]);
        }
      }
    }
  } else {
    const int i0 = a0 + gq;
    for (int k = 0; k < nk; ++k) {
      const float c0 = s_c[i0 * ldn + k], c1 = s_c[(i0 + 8) * ldn + k];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        if (q < nt_cb) {
          const float b0 = s_b[(8 * q + 2 * tq) * ldn + k];
          const float b1 = s_b[(8 * q + 2 * tq + 1) * ldn + k];
          cb[q][0] = fmaf(c0, b0, cb[q][0]);
          cb[q][1] = fmaf(c0, b1, cb[q][1]);
          cb[q][2] = fmaf(c1, b0, cb[q][2]);
          cb[q][3] = fmaf(c1, b1, cb[q][3]);
        }
      }
    }
  }
}

// One head's inputs in shared memory, for head_rows
template <typename T>
struct Head {
  const float* dt;  // [L]
  float a;          // A_h
  const T* x;       // [L][ldx]: x[j][p]
  const void* s;    // the starting state [kTile][ldn]: bf16 hi then lo, f32
  bool readout;     // past chunk 0
  T* y;             // row i of the chunk at y + i * row_stride
  int64_t row_stride;
  int64_t p_left;   // columns of y from the tile's first (P - p0)
};

// y of one head for the rows [16m, 16m + 16) of the chunk: the readout of
// the starting state and the decayed C.B^T times x.  `scratch`: this
// warp's kWarpScratch floats; s_gw (f32 route): its [16][L + 4] G rows.
template <typename T, int L, int NT>
__device__ __forceinline__ void head_rows(const float (&cb)[NT][4], int m,
                                          const Head<T>& hd, const T* s_c,
                                          int ldn, int nk, float* scratch,
                                          float* s_gw, int valid) {
  constexpr int ldx = kTile + pad<T>();
  constexpr int kPt = kTile / 8;  // n-tiles of y (p)
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int a0 = 16 * m;
  const float* dth = hd.dt;
  const float ah = hd.a;
  float* suf = scratch;                  // [L + 1]
  float* wcol = suf + L + 1;             // [L]
  float* dseg = wcol + L;                // [16][17]
  float* dfi = dseg + 16 * 17;           // [16]

  // Segment sums, a = 16 m the tile's first row: suf[j] = sum_{j<=k<=a}
  // la_k, so P_j = suf[j + 1] for j < a; wcol_j = exp(P_j) dt_j.  Row i's
  // own part F_i = sum_{a<k<=i} la_k and the diagonal tile's seg_ij =
  // sum_{j<k<=i} la_k are summed from i down, one lane a row.  Off the
  // diagonal exp(seg_ij) = exp(P_j) exp(F_i): a product of two
  // exponentials of direct sums, no difference taken.
  warp_suffix_sum<L>(suf, [&](int kk) {
    return kk <= a0 ? __fmul_rn(dth[kk], ah) : 0.f;
  });
  if (lane < 16) {
    float sum = 0.f;
    dseg[lane * 17 + lane] = 0.f;
#pragma unroll
    for (int kk = 15; kk >= 1; --kk) {
      if (kk <= lane) {
        sum += __fmul_rn(dth[a0 + kk], ah);
        dseg[lane * 17 + kk - 1] = sum;
      }
    }
    dfi[lane] = sum;
  }
  __syncwarp();
  for (int j = lane; j < a0; j += 32) wcol[j] = expf(suf[j + 1]) * dth[j];
  float ef[2], sd[2][4], ecum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = dseg + (gq + 8 * r) * 17;
    sd[r][0] = row[2 * tq];  // above the diagonal: masked below
    sd[r][1] = row[2 * tq + 1];
    sd[r][2] = row[8 + 2 * tq];
    sd[r][3] = row[9 + 2 * tq];
    const float fi = dfi[gq + 8 * r];
    ef[r] = expf(fi);
    ecum[r] = expf(suf[0] + fi);  // cum_i = sum_{k<=a} la_k + F_i
  }
  __syncwarp();
  // exp(seg_ij) dt_j for row i, column j: off the diagonal tile from wcol
  // and exp(F_i), on it from its own segment sum, 0 above it
  auto factor = [&](int i, int j, bool off, float seg, float efi) {
    return off ? wcol[j] * efi : j <= i ? expf(seg) * dth[j] : 0.f;
  };

  float y[kPt][4];
#pragma unroll
  for (int q = 0; q < kPt; ++q) y[q][0] = y[q][1] = y[q][2] = y[q][3] = 0.f;
  if constexpr (kTC<T>) {
    const bf16* s_hi = static_cast<const bf16*>(hd.s);
    const bf16* s_lo = s_hi + kTile * ldn;
    if (hd.readout) {
#pragma unroll
      for (int k0 = 0; k0 < nk; k0 += 16) {
        uint32_t af[4], sh[kPt / 2][4], sl[kPt / 2][4];
        load_a<true>(af, s_c, ldn, a0, k0);
#pragma unroll
        for (int q = 0; q < kPt / 2; ++q) {
          load_b2<true>(sh[q], s_hi, ldn, k0, 16 * q);  // S: stored [p][n]
          load_b2<true>(sl[q], s_lo, ldn, k0, 16 * q);
        }
#pragma unroll
        for (int q = 0; q < kPt / 2; ++q) {
          mma(y[2 * q], af, sh[q][0], sh[q][1]);
          mma(y[2 * q + 1], af, sh[q][2], sh[q][3]);
        }
#pragma unroll
        for (int q = 0; q < kPt / 2; ++q) {
          mma(y[2 * q], af, sl[q][0], sl[q][1]);
          mma(y[2 * q + 1], af, sl[q][2], sl[q][3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPt; ++q) {
      y[q][0] *= ecum[0];
      y[q][1] *= ecum[0];
      y[q][2] *= ecum[1];
      y[q][3] *= ecum[1];
    }
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
      if (kt <= m) {
        // G of n-tiles 2kt (half 0) and 2kt + 1, rows r, columns e: the
        // A operand of k-tile kt, from the accumulators of C.B^T
        float v[8];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = 2 * kt + hf;
              v[4 * hf + 2 * r + e] =
                  cb[q][2 * r + e] *
                  factor(a0 + gq + 8 * r, 8 * q + 2 * tq + e, kt < m,
                         sd[r][2 * hf + e], ef[r]);
            }
          }
        }
        uint32_t ah2[4], al2[4], bx[kPt / 2][4];
        split2(v[0], v[1], ah2[0], al2[0]);
        split2(v[2], v[3], ah2[1], al2[1]);
        split2(v[4], v[5], ah2[2], al2[2]);
        split2(v[6], v[7], ah2[3], al2[3]);
#pragma unroll
        for (int q = 0; q < kPt / 2; ++q)
          load_b2<false>(bx[q], hd.x, ldx, 16 * kt, 16 * q);  // x: [j][p]
#pragma unroll
        for (int q = 0; q < kPt / 2; ++q) {
          mma(y[2 * q], ah2, bx[q][0], bx[q][1]);
          mma(y[2 * q + 1], ah2, bx[q][2], bx[q][3]);
        }
#pragma unroll
        for (int q = 0; q < kPt / 2; ++q) {
          mma(y[2 * q], al2, bx[q][0], bx[q][1]);
          mma(y[2 * q + 1], al2, bx[q][2], bx[q][3]);
        }
      }
    }
  } else {
    const float* s_s = static_cast<const float*>(hd.s);
    const int i0 = a0 + gq;
    if (hd.readout) {
      for (int kk = 0; kk < nk; ++kk) {
        const float v0 = s_c[i0 * ldn + kk], v1 = s_c[(i0 + 8) * ldn + kk];
#pragma unroll
        for (int q = 0; q < kPt; ++q) {
          const float s0 = s_s[(8 * q + 2 * tq) * ldn + kk];
          const float s1 = s_s[(8 * q + 2 * tq + 1) * ldn + kk];
          y[q][0] = fmaf(v0, s0, y[q][0]);
          y[q][1] = fmaf(v0, s1, y[q][1]);
          y[q][2] = fmaf(v1, s0, y[q][2]);
          y[q][3] = fmaf(v1, s1, y[q][3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPt; ++q) {
      y[q][0] *= ecum[0];
      y[q][1] *= ecum[0];
      y[q][2] *= ecum[1];
      y[q][3] *= ecum[1];
    }
    constexpr int ldg = L + 4;
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      if (q < 2 * m + 2) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * q + 2 * tq + e;
            s_gw[(gq + 8 * r) * ldg + j] =
                cb[q][2 * r + e] *
                factor(a0 + gq + 8 * r, j, q < 2 * m, sd[r][2 * (q & 1) + e],
                       ef[r]);
          }
        }
      }
    }
    __syncwarp();
    for (int kk = 0; kk < a0 + 16; ++kk) {
      const float g0 = s_gw[gq * ldg + kk], g1 = s_gw[(gq + 8) * ldg + kk];
#pragma unroll
      for (int q = 0; q < kPt; ++q) {
        const float x0 = hd.x[kk * ldx + 8 * q + 2 * tq];
        const float x1 = hd.x[kk * ldx + 8 * q + 2 * tq + 1];
        y[q][0] = fmaf(g0, x0, y[q][0]);
        y[q][1] = fmaf(g0, x1, y[q][1]);
        y[q][2] = fmaf(g1, x0, y[q][2]);
        y[q][3] = fmaf(g1, x1, y[q][3]);
      }
    }
  }

  // rows a + gq (+ 8) of the chunk, columns 8q + 2tq of the tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = a0 + gq + 8 * r;
    if (i >= valid) continue;
    T* row = hd.y + i * hd.row_stride;
#pragma unroll
    for (int q = 0; q < kPt; ++q) {
      const int64_t pp = 8 * q + 2 * tq;
      if (pp + 1 < hd.p_left && ((hd.p_left | hd.row_stride) & 1) == 0) {
        store_pair(row + pp, y[q][2 * r], y[q][2 * r + 1]);
      } else {
        if (pp < hd.p_left) store_one(row + pp, y[q][2 * r]);
        if (pp + 1 < hd.p_left) store_one(row + pp + 1, y[q][2 * r + 1]);
      }
    }
  }
  __syncwarp();  // the scratch (and G rows) are rewritten next
}

template <typename T, int L>
__global__ void __launch_bounds__(kOutThreads) chunk_output_kernel(Args<T> g) {
  static_assert(L == 64 || L == 128, "four warps of one or two row tiles");
  constexpr int kThreads = kOutThreads;
  const OutSmem<T, L> lay(g.nk, g.heads);
  const int ldn = lay.ldn;
  constexpr int ldx = kTile + pad<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_c = reinterpret_cast<T*>(smem + lay.c_off);       // [L][ldn]: C[i][n]
  unsigned char* buf = smem + lay.buf0;  // a head's x tile and state
  float* s_dt = reinterpret_cast<float*>(smem + lay.dt_off);  // [heads][L]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int m_lo = warp, m_hi = L / 16 - 1 - warp;  // this warp's row tiles
  float* scratch = reinterpret_cast<float*>(smem + lay.warp_off) +
                   warp * kWarpScratch<L>;
  float* s_gw = reinterpret_cast<float*>(smem + lay.g_off) +
                warp * 16 * (L + 4);  // f32 route only
  const int pt = blockIdx.x % g.npt;
  const int64_t h0 = static_cast<int64_t>(blockIdx.x / g.npt) * g.heads;
  const int nh = static_cast<int>(g.h - h0 < g.heads ? g.h - h0 : g.heads);
  const int64_t bb = blockIdx.z;
  const int64_t c = blockIdx.y;
  const int64_t tok0 = c * L;
  const int valid = static_cast<int>(g.s - tok0 < L ? g.s - tok0 : L);
  const int p0 = pt * kTile;

  // head k's x tile (rows j, columns p0..) and, past chunk 0, the state it
  // starts from (rows p0.. of its slot) into the buffer
  auto fetch = [&](int k) {
    const int64_t hh = h0 + k;
    load_tile<T, kThreads>(reinterpret_cast<T*>(buf), ldx,
                           g.x + ((bb * g.s + tok0) * g.h + hh) * g.p + p0,
                           g.h * g.p, L, valid, kTile,
                           static_cast<int>(g.p - p0 < kTile ? g.p - p0
                                                             : kTile),
                           g.vec_x);
    if (c > 0) {
      const float* s_in = g.enter + ((bb * g.h + hh) * g.nc + c) * g.per;
      if constexpr (kTC<T>) {
        const bf16* hi = reinterpret_cast<const bf16*>(s_in) +
                         static_cast<int64_t>(p0) * g.nk;
        bf16* dst = reinterpret_cast<bf16*>(buf + lay.x_bytes);
        load_tile<bf16, kThreads>(dst, ldn, hi, g.nk, kTile, kTile, g.nk,
                                  g.nk, true);
        load_tile<bf16, kThreads>(dst + kTile * ldn, ldn, hi + g.per, g.nk,
                                  kTile, kTile, g.nk, g.nk, true);
      } else {
        load_tile<float, kThreads>(
            reinterpret_cast<float*>(buf + lay.x_bytes), ldn,
            s_in + static_cast<int64_t>(p0) * g.nk, g.nk, kTile, kTile,
            g.nk, g.nk, true);
      }
    }
  };

  T* s_b = reinterpret_cast<T*>(buf);  // B until C.B^T is done
  load_tile<T, kThreads>(s_c, ldn, g.c + (bb * g.s + tok0) * g.n, g.n, L,
                         valid, g.nk, g.n, g.vec_bc);
  load_tile<T, kThreads>(s_b, ldn, g.b + (bb * g.s + tok0) * g.n, g.n, L,
                         valid, g.nk, g.n, g.vec_bc);
  for (int idx = tid; idx < L * nh; idx += kThreads) {
    const int j = idx / nh, k = idx % nh;
    s_dt[k * L + j] =
        j < valid ? g.dt[(bb * g.s + tok0 + j) * g.h + h0 + k] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  float cb_lo[8][4];                  // row tile w: n-tiles < 2w + 2 <= 8
  float cb_hi[L == 128 ? 16 : 1][4];  // row tile 7 - w (L = 128): <= 16
  cb_rows<T>(cb_lo, m_lo, s_c, s_b, ldn, g.nk);
  if constexpr (L == 128) cb_rows<T>(cb_hi, m_hi, s_c, s_b, ldn, g.nk);
  for (int k = 0; k < nh; ++k) {
    __syncthreads();  // the buffer is free (of B, or of head k - 1)
    fetch(k);
    cp_async_wait_all();
    __syncthreads();
    const int64_t hh = h0 + k;
    Head<T> hd;
    hd.dt = s_dt + k * L;
    hd.a = g.a[hh];
    hd.x = reinterpret_cast<const T*>(buf);
    hd.s = buf + lay.x_bytes;
    hd.readout = c > 0;
    hd.row_stride = g.h * g.p;
    hd.y = g.y + ((bb * g.s + tok0) * g.h + hh) * g.p + p0;
    hd.p_left = g.p - p0;
    head_rows<T, L>(cb_lo, m_lo, hd, s_c, ldn, g.nk, scratch, s_gw, valid);
    if constexpr (L == 128)
      head_rows<T, L>(cb_hi, m_hi, hd, s_c, ldn, g.nk, scratch, s_gw, valid);
  }
}

template <typename T>
constexpr int chunk_of() {
  return kTC<T> ? kChunk : kChunkF32;
}

// NC and the floats of scratch per (batch, head, chunk): the chunk's own
// state and the state it starts from, ppad * nk floats each
template <typename T>
void scratch_dims(int64_t s, int64_t p, int64_t n, int64_t* nc,
                  int64_t* floats) {
  *nc = (s + chunk_of<T>() - 1) / chunk_of<T>();
  *floats = 2 * round_up(p, kTile) * round_up(n, 16);
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, void* y, float* states, float* decay,
           int64_t batch, int64_t s, int64_t h, int64_t p, int64_t n,
           cudaStream_t stream) {
  constexpr int L = chunk_of<T>();
  constexpr int64_t V = 16 / sizeof(T);
  int64_t nc, floats;
  scratch_dims<T>(s, p, n, &nc, &floats);
  if (nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Args<T> g;
  g.x = static_cast<const T*>(x);
  g.dt = dt;
  g.a = a;
  g.b = static_cast<const T*>(b);
  g.c = static_cast<const T*>(c);
  g.y = static_cast<T*>(y);
  g.s = s;
  g.h = h;
  g.p = p;
  g.n = static_cast<int>(n);
  g.nk = static_cast<int>(round_up(n, 16));
  g.ppad = static_cast<int>(round_up(p, kTile));
  g.npt = g.ppad / kTile;
  g.nc = static_cast<int>(nc);
  g.per = floats / 2;
  g.local = states;
  g.enter = states + batch * h * nc * g.per;
  g.decay = decay;
  auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  g.vec_x = p % V == 0 && aligned(x);
  g.vec_bc = aligned(b) && aligned(c);  // n % 8 == 0: rows of 16 bytes

  g.heads = static_cast<int>(h < kHeads ? h : kHeads);
  const size_t smem1 = state_smem<T, L>(g.nk);
  const size_t smem3 = OutSmem<T, L>(g.nk, g.heads).total;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(chunk_output_kernel<T, L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 groups(
      static_cast<unsigned>((h + g.heads - 1) / g.heads * g.npt),
      static_cast<unsigned>(nc), static_cast<unsigned>(batch));
  chunk_state_kernel<T, L><<<dim3(static_cast<unsigned>(h * g.npt),
                                  static_cast<unsigned>(nc),
                                  static_cast<unsigned>(batch)),
                             kStateThreads, smem1, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  state_pass_kernel<T><<<dim3(static_cast<unsigned>(
                                  (g.per / 4 + kScanThreads - 1) /
                                  kScanThreads),
                              static_cast<unsigned>(h),
                              static_cast<unsigned>(batch)),
                         kScanThreads, 0, stream>>>(
      g.local, g.enter, decay, g.nc, g.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_output_kernel<T, L><<<groups, kOutThreads, smem3, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

bool valid_sizes(int64_t batch, int64_t s, int64_t h, int64_t p, int64_t n,
                 int dtype) {
  return batch >= 0 && batch <= 65535 && s >= 0 && h >= 0 && h <= 65535 &&
         p >= 0 && n >= 8 && n <= 256 && n % 8 == 0 && dtype >= 0 &&
         dtype <= 1;
}

}  // namespace

// The scratch ssd_scan needs: out[0] = NC (chunks), out[1] = floats of
// scratch per (batch, head, chunk); states hold batch * h * NC * out[1]
// floats, decay batch * h * NC.
extern "C" int ssd_scan_scratch(int64_t s, int64_t p, int64_t n, int dtype,
                                int64_t* out) {
  if (!valid_sizes(0, s, 0, p, n, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    scratch_dims<float>(s, p, n, out, out + 1);
  else
    scratch_dims<bf16>(s, p, n, out, out + 1);
  return 0;
}

extern "C" int ssd_scan(const void* x, const float* dt, const float* a,
                        const void* b, const void* c, void* y, float* states,
                        float* decay, int64_t batch, int64_t s, int64_t h,
                        int64_t p, int64_t n, int dtype, void* stream) {
  if (!valid_sizes(batch, s, h, p, n, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || s == 0 || h == 0 || p == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, dt, a, b, c, y, states, decay, batch,
                                    s, h, p, n, st)
                    : launch<bf16>(x, dt, a, b, c, y, states, decay, batch,
                                   s, h, p, n, st);
}
