// Flash attention forward: what the kernels of flash_attention.cu and the
// decode regime's files (flash_attention_decode_<hd>.cu) share. The design
// notes are at the head of flash_attention.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_fa {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -2.0e38f;
constexpr float kMInit = -1e30f;

enum MaskKind { kCausal = 0, kFull = 1, kPrefix = 2 };

struct Params {
  int B, Sq, Skv, H, K, G;
  float scale, softcap;
  int kind, window, prefix_len, q_offset;
};

// The mask of models/layers._mask_block at absolute positions (qp, kp).
__device__ __forceinline__ bool admitted(const Params& p, int qp, int kp) {
  if (p.kind == kFull) return true;
  const bool pre = p.kind == kPrefix && p.prefix_len > 0;
  bool m = kp <= qp;
  if (pre) m = m || (qp < p.prefix_len && kp < p.prefix_len);
  if (p.window > 0) {
    bool w_ok = (qp - kp) < p.window;
    if (pre) w_ok = w_ok || (kp < p.prefix_len);
    m = m && w_ok;
  }
  return m;
}

// The keys [lo, hi) that the mask can admit for any query row in
// [q_start, q_start + rows). The one rule for every kernel's key range;
// decode_split_plan (kernels/flash_attention.py) computes the same range.
__host__ __device__ __forceinline__ void kv_range(const Params& p, int q_start,
                                                  int rows, int& lo, int& hi) {
  const int q_last = (q_start + rows < p.Sq ? q_start + rows : p.Sq) - 1;
  lo = 0;
  hi = p.Skv;
  if (p.kind != kFull) {
    const bool pre = p.kind == kPrefix && p.prefix_len > 0;
    hi = p.q_offset + q_last + 1;
    if (pre && p.q_offset + q_start < p.prefix_len && hi < p.prefix_len) hi = p.prefix_len;
    hi = hi < 0 ? 0 : (hi > p.Skv ? p.Skv : hi);
    if (p.window > 0 && !pre) {
      lo = p.q_offset + q_start - p.window + 1;
      lo = lo < 0 ? 0 : lo;
    }
  }
}

// The KV tiles [t_begin, t_end) that the mask can admit for any query row
// in [q_start, q_start + kRows), in tiles of kKeys.
template <int kRows = kBlockQ, int kKeys = kBlockK>
__device__ __forceinline__ void kv_tiles(const Params& p, int q_start,
                                         int& t_begin, int& t_end) {
  int lo, hi;
  kv_range(p, q_start, kRows, lo, hi);
  t_begin = lo / kKeys;
  t_end = (hi + kKeys - 1) / kKeys;
}

// Block index -> (b, h, q tile), heaviest causal tiles first.
template <int kRows = kBlockQ>
__device__ __forceinline__ void tile_of_block(const Params& p, int& b, int& h,
                                              int& q_start) {
  const int nq = (p.Sq + kRows - 1) / kRows;
  const int bh = blockIdx.x / nq;
  b = bh / p.H;
  h = bh % p.H;
  q_start = (nq - 1 - (int)(blockIdx.x % nq)) * kRows;
}

// ---------------------------------------------------------------------------
// bf16 tiles: shared memory, cp.async, the mask by tiles.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;    // query rows per CTA: two warpgroups of 64
constexpr int kWgThreads = 256;
constexpr int kWgKeys = 64;     // keys per KV tile
// KV tiles in the ring: 3 (two loads ahead of the math), or 2 at hd 256,
// where Q and three stages would not fit in a block's shared memory.
template <int HD>
__host__ __device__ constexpr int stages_for() { return HD >= 256 ? 2 : 3; }
// The head dim padded to whole 64-column panels (128-byte swizzled rows):
// 16, 32 and 64 to 64, 112 and 128 to 128, 256 stays.
template <int HD>
__host__ __device__ constexpr int hd_padded() { return (HD + 63) / 64 * 64; }
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// +inf: the log-sum-exp of a row whose keys the mask all removes.
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !valid (src is then unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// Copy rows [row0, row0 + R) of a (rows, HD) bf16 operand with row stride
// `stride` elements into its shared tile: HDP / 64 panels of R rows of
// 128 bytes, each 16-byte piece at its 128-byte-swizzle place (piece c of
// row r at c ^ (r % 8)), the layout that the wgmma descriptors below name.
// Rows at or past `limit` are zero-filled; columns HD..HDP-1 are never
// written (they stay as the kernel zeroed them).
template <int R, int HD, int HDP, int kThreads = kWgThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int limit) {
  for (int e = threadIdx.x; e < R * (HD / 8); e += kThreads) {
    const int r = e / (HD / 8), c8 = e % (HD / 8);
    const bool ok = row0 + r < limit;
    const uint32_t at = dst + (c8 / 8) * (R * 128) + r * 128 +
                        (((c8 % 8) ^ (r % 8)) << 4);
    cp_async16(at, src + (ok ? row0 + r : 0) * stride + c8 * 8, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x in one MUFU instruction (2 ulp; exp2f adds range fix-ups).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma (Hopper's warpgroup products) on 128-byte-swizzled shared tiles, as
// the bf16 training kernels use them: the forward in flash_attention.cu and
// the backward in attention_bwd.cuh.

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64x64 fp32) (+)= A (64x16, K-major, shared) * B (16x64, K-major,
// shared); scale_d = 0 starts from zero.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64x64 fp32) += A (64x16 bf16, registers) * B (16x64, MN-major, shared).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

enum TileClass { kEmpty = 0, kPartial = 1, kWhole = 2 };

// What the mask does to the block of absolute query positions [qlo, qhi]
// and keys [klo, khi]: admits no pair (kEmpty), admits every pair with
// every key inside Skv (kWhole), or anything else (kPartial, masked per
// element). Both verdicts are sufficient conditions, never guesses.
__device__ __forceinline__ int tile_class(const Params& p, int qlo, int qhi,
                                          int klo, int khi) {
  const bool in_seq = khi < p.Skv;
  if (p.kind == kFull) return in_seq ? kWhole : kPartial;
  const bool pre = p.kind == kPrefix && p.prefix_len > 0;
  const int pl = p.prefix_len;
  // The causal part: k <= q, or both inside the prefix.
  if (klo > qhi && !(pre && qlo < pl && klo < pl)) return kEmpty;
  bool all = khi <= qlo || (pre && qhi < pl && khi < pl);
  if (p.window > 0) {  // q - k < window, or k inside the prefix
    if (qlo - khi >= p.window && !(pre && klo < pl)) return kEmpty;
    all = all && (qhi - klo < p.window || (pre && khi < pl));
  }
  return all && in_seq ? kWhole : kPartial;
}

// ---------------------------------------------------------------------------
// bf16 decode regime: a GQA group's rows, keys split across CTAs, a merge.
// ---------------------------------------------------------------------------

constexpr int kDecRows = 64;      // Sq·G at most: the query rows of one CTA
constexpr int kDecKeys = 64;      // keys per KV tile
constexpr int kDecThreads = 128;  // 4 warps
constexpr int kMaxSplits = 64;    // kernels/flash_attention.py: MAX_SPLITS
constexpr int kMergeThreads = 64;

// Four 8x8 bf16 tiles from shared memory: lane l names row l % 8 of tile
// l / 8 and receives, in register i, elements 2 (l % 4) and 2 (l % 4) + 1
// of row l / 4 of tile i (with .trans: rows 2 (l % 4) and 2 (l % 4) + 1 of
// column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// D += A (16x16 bf16, row) * B (16x8 bf16, col), fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte piece c of row r in a swizzled tile of kRows rows
// (load_tile's layout: 64-column panels of kRows 128-byte rows).
template <int kRows>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c / 8) * (kRows * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// One CTA: kv head kh of batch b, split `split` of n_split, all R = Sq·G
// query rows. kRowTiles 16-row tiles (1, or 4 past 16 rows) share the 4
// warps: warp w takes row tile w / kSlices and keys [kWarpKeys·(w % kSlices),
// + kWarpKeys) of every 64-key tile.
template <int HD, int kRowTiles>
__global__ void __launch_bounds__(kDecThreads)
flash_attention_decode_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o,
                              float2* __restrict__ ws_ml, float* __restrict__ ws_o,
                              Params p, int t_begin, int n_tiles, int n_split) {
  static_assert(HD % 16 == 0, "an mma k-step is 16 columns of the head dim");
  constexpr int HDP = hd_padded<HD>();
  constexpr int kSlices = 4 / kRowTiles;           // warps on one row tile
  constexpr int kWarpKeys = kDecKeys / kSlices;    // 16 or 64
  constexpr int kNT = kWarpKeys / 8;               // score n-tiles a warp
  constexpr int kKSteps = HD / 16;                 // QKᵀ k-steps
  constexpr int kDN = HD / 8;                      // output n-tiles
  constexpr int kStages = stages_for<HD>();
  constexpr int kQRows = 16 * kRowTiles;
  constexpr int kKVBytes = kDecKeys * HDP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sk = (raw + 127u) & ~127u;  // swizzle rows start 128-byte aligned
  const uint32_t sv = sk + kStages * kKVBytes;
  const uint32_t sq = sv + kStages * kKVBytes;

  const int R = p.Sq * p.G;
  const int split = blockIdx.x % n_split;
  const int bk = blockIdx.x / n_split;
  const int b = bk / p.K, kh = bk % p.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int li = lane >> 3, lr = lane & 7;  // the ldmatrix tile and row this lane names
  const int rt = warp / kSlices, k0 = (warp % kSlices) * kWarpKeys;
  const bool live = rt * 16 < R;  // warp-uniform: the row tile holds a real row
  const int r0 = rt * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int qp0 = p.q_offset + r0 / p.G, qp1 = p.q_offset + r1 / p.G;
  // This split's tiles: an even share of [t_begin, t_begin + n_tiles).
  const int t0 = t_begin + (int)((long long)split * n_tiles / n_split);
  const int t1 = t_begin + (int)((long long)(split + 1) * n_tiles / n_split);

  const long long kv_stride = (long long)p.K * HD;
  const __nv_bfloat16* kbase = k + (long long)b * p.Skv * kv_stride + (long long)kh * HD;
  const __nv_bfloat16* vbase = v + (long long)b * p.Skv * kv_stride + (long long)kh * HD;

  // Prologue: the group's Q rows join the first tile's copy group.
  for (int e = threadIdx.x; e < kQRows * (HD / 8); e += kDecThreads) {
    const int r = e / (HD / 8), c8 = e % (HD / 8);
    const bool ok = r < R;
    const int s = ok ? r / p.G : 0, gg = ok ? r % p.G : 0;
    cp_async16(sq + swz<kQRows>(r, c8),
               q + (((long long)b * p.Sq + s) * p.H + kh * p.G + gg) * HD + c8 * 8, ok);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t0 + s < t1) {
      const int kv0 = (t0 + s) * kDecKeys;
      load_tile<kDecKeys, HD, HDP, kDecThreads>(sk + s * kKVBytes, kbase, kv_stride,
                                                kv0, p.Skv);
      load_tile<kDecKeys, HD, HDP, kDecThreads>(sv + s * kKVBytes, vbase, kv_stride,
                                                kv0, p.Skv);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  const float mul = p.softcap > 0.f ? kLog2e : p.scale * kLog2e;
  float oacc[kDN][4];
#pragma unroll
  for (int n = 0; n < kDN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m0 = kMInit * kLog2e, m1 = kMInit * kLog2e;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the row sums
  const int q_lo = p.q_offset, q_hi = p.q_offset + p.Sq - 1;

  for (int i = 0; i < t1 - t0; ++i) {
    const int t = t0 + i, stage = i % kStages;
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    __syncthreads();  // tile t is in; every warp is done with tile t-1
    {
      const int tn = t + kStages - 1, sn = (i + kStages - 1) % kStages;
      if (tn < t1) {
        load_tile<kDecKeys, HD, HDP, kDecThreads>(sk + sn * kKVBytes, kbase, kv_stride,
                                                  tn * kDecKeys, p.Skv);
        load_tile<kDecKeys, HD, HDP, kDecThreads>(sv + sn * kKVBytes, vbase, kv_stride,
                                                  tn * kDecKeys, p.Skv);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const int kv0 = t * kDecKeys;
    const int cls = tile_class(p, q_lo, q_hi, kv0, kv0 + kDecKeys - 1);
    if (cls == kEmpty || !live) continue;  // uniform over the warp
    const uint32_t kt = sk + stage * kKVBytes, vt = sv + stage * kKVBytes;

    // S = Q Kᵀ over this warp's keys: s[n][e] at row (e < 2 ? r0 : r1), key
    // kv0 + k0 + 8n + 2 t4 + (e & 1).
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      uint32_t a[4];  // tiles: rows 0-7 / 8-15 x columns 16ks + 0-7 / 8-15
      ldsm_x4(a, sq + swz<kQRows>(rt * 16 + (li & 1) * 8 + lr, 2 * ks + (li >> 1)));
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bk4[4];  // tiles: keys 0-7 x columns 0-7 / 8-15, keys 8-15 x ...
        ldsm_x4(bk4, kt + swz<kDecKeys>(k0 + np * 16 + (li >> 1) * 8 + lr,
                                        2 * ks + (li & 1)));
        mma_bf16(s[2 * np], a, bk4[0], bk4[1]);
        mma_bf16(s[2 * np + 1], a, bk4[2], bk4[3]);
      }
    }

    if (p.softcap > 0.f) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = p.softcap * tanhf(s[n][e] * p.scale / p.softcap);
    }
    if (cls == kPartial) {
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kv0 + k0 + 8 * n + 2 * t4 + (e & 1);
          if (kp >= p.Skv || !admitted(p, e < 2 ? qp0 : qp1, kp)) s[n][e] = kNegInf;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * mul), mn1 = fmaxf(m1, mx1 * mul);
    const float c0 = fast_exp2(m0 - mn0), c1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      s[n][0] = fast_exp2(fmaf(s[n][0], mul, -mn0));
      s[n][1] = fast_exp2(fmaf(s[n][1], mul, -mn0));
      s[n][2] = fast_exp2(fmaf(s[n][2], mul, -mn1));
      s[n][3] = fast_exp2(fmaf(s[n][3], mul, -mn1));
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
    }
    // O += P V, 16 keys a k-step: P (rounded to bf16) is the A fragment
    // straight from the score accumulators; V comes transposed by ldmatrix,
    // two 8-column n-tiles of hd a load.
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDN / 2; ++dp) {
        uint32_t bv[4];  // tiles: keys 0-7 / 8-15 x columns 16dp + 0-7, then + 8-15
        ldsm_x4_t(bv, vt + swz<kDecKeys>(k0 + kk * 16 + (li & 1) * 8 + lr,
                                         2 * dp + (li >> 1)));
        mma_bf16(oacc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(oacc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // Combine the warps of each row tile in warp order through shared memory
  // (the ring's bytes: every copy has landed and every warp is past its last
  // tile), then write the output or this split's partials.
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(smem_raw + (sk - raw));  // [warp][16][HD]
  float2* red_ml = reinterpret_cast<float2*>(red_o + 4 * 16 * HD);  // [warp][16]
  if (live) {
#pragma unroll
    for (int n = 0; n < kDN; ++n) {
      const int d = 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(red_o + (warp * 16 + g) * HD + d) =
          make_float2(oacc[n][0], oacc[n][1]);
      *reinterpret_cast<float2*>(red_o + (warp * 16 + g + 8) * HD + d) =
          make_float2(oacc[n][2], oacc[n][3]);
    }
    if (t4 == 0) {
      red_ml[warp * 16 + g] = make_float2(m0, l0);
      red_ml[warp * 16 + g + 8] = make_float2(m1, l1);
    }
  }
  __syncthreads();
  const long long part = (long long)bk * n_split + split;  // this CTA's partials
  for (int e = threadIdx.x; e < R * (HD / 2); e += kDecThreads) {
    const int r = e / (HD / 2), d = 2 * (e % (HD / 2));
    const int w0 = (r / 16) * kSlices, rr = r % 16;
    float M = red_ml[w0 * 16 + rr].x;
#pragma unroll
    for (int j = 1; j < kSlices; ++j) M = fmaxf(M, red_ml[(w0 + j) * 16 + rr].x);
    float L = 0.f, O0 = 0.f, O1 = 0.f;
#pragma unroll
    for (int j = 0; j < kSlices; ++j) {
      const float2 ml = red_ml[(w0 + j) * 16 + rr];
      const float w = fast_exp2(ml.x - M);
      const float2 x = *reinterpret_cast<const float2*>(red_o + ((w0 + j) * 16 + rr) * HD + d);
      L += ml.y * w;
      O0 += x.x * w;
      O1 += x.y * w;
    }
    if (n_split == 1) {
      const float den = fmaxf(L, 1e-30f);
      const int s = r / p.G, gg = r % p.G;
      *reinterpret_cast<uint32_t*>(
          o + (((long long)b * p.Sq + s) * p.H + kh * p.G + gg) * HD + d) =
          pack_bf16(O0 / den, O1 / den);
    } else {
      *reinterpret_cast<float2*>(ws_o + (part * R + r) * HD + d) = make_float2(O0, O1);
      if (d == 0) ws_ml[part * R + r] = make_float2(M, L);
    }
  }
}

// The decode regime's kernel at head dim HD, launched on the fewest 16-row
// tiles that hold Sq·G rows: one, or four past 16 rows (granite's 48; no
// serving path gives 17-32). Its instances are built in
// flash_attention_decode_<HD>.cu, one file per head dim, so that nvcc builds
// them side by side. The members are defined out of the class, so not
// inline: the extern declarations below then keep every other file from
// instantiating them (in one file with the rest, the build took 71 s).
// ws_ml and ws_o: the workspace's partials, unused at n_split = 1.
template <int HD>
struct Decode {
  static int launch(const void* q, const void* k, const void* v, void* o,
                    float2* ws_ml, float* ws_o, const Params& p, int t_begin,
                    int n_tiles, int n_split, cudaStream_t stream);
  template <int kRowTiles>
  static int rows(const void* q, const void* k, const void* v, void* o,
                  float2* ws_ml, float* ws_o, const Params& p, int t_begin,
                  int n_tiles, int n_split, cudaStream_t stream);
};

template <int HD>
int Decode<HD>::launch(const void* q, const void* k, const void* v, void* o,
                       float2* ws_ml, float* ws_o, const Params& p, int t_begin,
                       int n_tiles, int n_split, cudaStream_t stream) {
  const int R = p.Sq * p.G;
  if (R <= 16) return rows<1>(q, k, v, o, ws_ml, ws_o, p, t_begin, n_tiles, n_split, stream);
  return rows<4>(q, k, v, o, ws_ml, ws_o, p, t_begin, n_tiles, n_split, stream);
}

template <int HD>
template <int kRowTiles>
int Decode<HD>::rows(const void* q, const void* k, const void* v, void* o,
                     float2* ws_ml, float* ws_o, const Params& p, int t_begin,
                     int n_tiles, int n_split, cudaStream_t stream) {
  constexpr int HDP = hd_padded<HD>();
  constexpr int kRing = 2 * stages_for<HD>() * kDecKeys * HDP * 2;
  // The K and V rings, the Q rows, and the slack that aligns them to 128 bytes.
  constexpr int kSmem = kRing + 16 * kRowTiles * HDP * 2 + 128;
  static_assert(kSmem <= 232448, "past the H100's shared memory per block");
  static_assert(4 * 16 * (HD + 2) * 4 <= kRing, "the warps' combine reuses the ring");
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(flash_attention_decode_kernel<HD, kRowTiles>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_attention_decode_kernel<HD, kRowTiles>
      <<<(unsigned)((long long)p.B * p.K * n_split), kDecThreads, kSmem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
          (__nv_bfloat16*)o, ws_ml, ws_o, p, t_begin, n_tiles, n_split);
  return (int)cudaGetLastError();
}

extern template struct Decode<16>;
extern template struct Decode<32>;
extern template struct Decode<64>;
extern template struct Decode<112>;
extern template struct Decode<128>;
extern template struct Decode<256>;

}  // namespace repro_fa
