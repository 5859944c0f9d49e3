// Flash attention forward (FA2 online softmax). Replaces the Pallas TPU
// kernel of repro/kernels/flash_attention.py: flash_attention_kernel
// (_attn_kernel), with the same contract: q (B, Sq, H, hd), k/v
// (B, Skv, K, hd), H % K == 0 (query head h reads kv head h / (H/K)); causal,
// full or prefix mask, sliding window, q_offset, logit softcap; fp32 running
// max m, denominator l and accumulator; output in q's type. The edge cases
// follow _attn_kernel exactly: m starts at -1e30, masked scores are -2e38,
// and the output is acc / max(l, 1e-30).
//
// Bound: at GPT-2's shape (8, 1024, 12, 64) bf16 causal, the data sheet puts
// the bytes (q, k, v read once, o written once: 50 MB) slightly above the
// tensor-core operations (12.9 GFLOP), so the bound is memory.
//
// Two kernels, one per input type:
//
// * bf16 (the training path): a Hopper kernel on wgmma. A CTA of two
//   warpgroups owns 128 query rows of one (b, h), 64 rows each; Q stays in
//   shared memory for the whole CTA. KV tiles of 64 keys stream through a
//   ring of 3 stages in dynamic shared memory, loaded by cp.async two
//   tiles ahead of the math, so the copies overlap the products. Every
//   tile sits in shared memory in the 128-byte-swizzle layout that TMA
//   would write (16-byte piece c of row r at c ^ (r % 8)), with head dims
//   below 64 zero-padded to one 128-byte row, so the products read it
//   without bank conflicts:
//     S = Q Kᵀ: wgmma.m64n64k16, Q and K K-major from shared memory;
//     O += P V: wgmma.m64n64k16 with P (the score accumulators rounded to
//       bf16, whose layout is the A fragment) in registers, and V read
//       MN-major from the same swizzled rows through the transpose bit, so
//       no transposed copy is built; one product per 64 columns of hd.
//   Each warpgroup classifies each KV tile once against its 64 rows:
//   empty tiles are skipped, whole ones skip the mask, and only partial
//   ones (the causal diagonal, window edges, the ragged Skv edge) test
//   admitted() per element. Scores are scaled after QKᵀ and go to log2
//   units in the same FMA that feeds ex2.approx (scale·log2e folded; safe under
//   the bf16 tolerance of 2e-2); l is reduced across the row's threads
//   once, at the end.
//   cp.async, not TMA: the same swizzled tiles without host-side tensor
//   maps, zero-fill of ragged rows and of the padded head dims in the
//   kernel, and a ring a later change can move to TMA unchanged.
// * fp32 (the parity sweeps, held to 2e-5, which tensor cores cannot meet):
//   plain FMA on the CUDA cores. A CTA of 256 threads owns 64 rows, four
//   threads per row, each holding an interleaved quarter of q and of the
//   accumulator; K/V tiles in shared memory as float4 rows; the softmax
//   rescales once per 16 keys.
//
// Both skip KV tiles that the mask removes entirely, which leaves the result
// bit-identical (such a tile adds exp(-2e38 - m) = 0 and rescales by
// exp(0) = 1); both mask ragged Sq/Skv edges, so no shape has to divide the
// tile sizes; both schedule heavy causal tiles (high q index) first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// The KV tiles [t_begin, t_end) that the mask can admit for any query row
// in [q_start, q_start + kRows), in tiles of kKeys.
template <int kRows = kBlockQ, int kKeys = kBlockK>
__device__ __forceinline__ void kv_tiles(const Params& p, int q_start,
                                         int& t_begin, int& t_end) {
  const int q_last = min(q_start + kRows, p.Sq) - 1;
  int lo = 0, hi = p.Skv;
  if (p.kind != kFull) {
    const bool pre = p.kind == kPrefix && p.prefix_len > 0;
    hi = p.q_offset + q_last + 1;
    if (pre && p.q_offset + q_start < p.prefix_len) hi = max(hi, p.prefix_len);
    hi = min(max(hi, 0), p.Skv);
    if (p.window > 0 && !pre) lo = max(0, p.q_offset + q_start - p.window + 1);
  }
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
// bf16: Hopper (cp.async ring, wgmma).
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;    // query rows per CTA: two warpgroups of 64
constexpr int kWgThreads = 256;
constexpr int kWgKeys = 64;     // keys per KV tile
constexpr int kStages = 3;      // KV tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

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
template <int R, int HD, int HDP>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int limit) {
  for (int e = threadIdx.x; e < R * (HD / 8); e += kWgThreads) {
    const int r = e / (HD / 8), c8 = e % (HD / 8);
    const bool ok = row0 + r < limit;
    const uint32_t at = dst + (c8 / 8) * (R * 128) + r * 128 +
                        (((c8 % 8) ^ (r % 8)) << 4);
    cp_async16(at, src + (ok ? row0 + r : 0) * stride + c8 * 8, ok);
  }
}

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

template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o, Params p) {
  constexpr int HDP = HD < 64 ? 64 : HD;  // padded to whole 128-byte rows
  constexpr int kPanels = HDP / 64;
  constexpr int kQBytes = kWgRows * HDP * 2;
  constexpr int kKVBytes = kWgKeys * HDP * 2;
  constexpr int kSteps = HDP / 16;  // k-steps of QKᵀ
  extern __shared__ unsigned char smem_raw[];
  // Swizzle atoms are 1024 bytes and must start 1024-byte aligned.
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sk = sq + kQBytes;
  const uint32_t sv = sk + kStages * kKVBytes;

  int b, h, q_start;
  tile_of_block<kWgRows>(p, b, h, q_start);
  const int kh = h / p.G;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg_row = q_start + wg * 64;  // this warpgroup's first row
  const int r0 = wg_row + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;

  if (HD < HDP) {  // zero the tiles once: the padding columns stay zero
    unsigned char* base = smem_raw + (sq - raw);
    const int n16 = (kQBytes + 2 * kStages * kKVBytes) / 16;
    for (int e = threadIdx.x; e < n16; e += kWgThreads)
      reinterpret_cast<uint4*>(base)[e] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  int t_begin, t_end;
  kv_tiles<kWgRows, kWgKeys>(p, q_start, t_begin, t_end);
  const long long q_stride = (long long)p.H * HD;
  const long long kv_stride = (long long)p.K * HD;
  const __nv_bfloat16* qbase = q + (long long)b * p.Sq * q_stride + (long long)h * HD;
  const __nv_bfloat16* kbase = k + (long long)b * p.Skv * kv_stride + (long long)kh * HD;
  const __nv_bfloat16* vbase = v + (long long)b * p.Skv * kv_stride + (long long)kh * HD;

  // Prologue: Q joins the first tile's group; kStages - 1 groups in flight.
  load_tile<kWgRows, HD, HDP>(sq, qbase, q_stride, q_start, p.Sq);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t_begin + s < t_end) {
      const int kv0 = (t_begin + s) * kWgKeys;
      load_tile<kWgKeys, HD, HDP>(sk + s * kKVBytes, kbase, kv_stride, kv0, p.Skv);
      load_tile<kWgKeys, HD, HDP>(sv + s * kKVBytes, vbase, kv_stride, kv0, p.Skv);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // Scores go to log2 units in one FMA: exp(x - m) = exp2(x·log2e - m·log2e).
  // Without a softcap x·log2e = s·(scale·log2e) for the raw score s; with
  // one, x = softcap·tanh(s·scale/softcap) first. The running max m is kept
  // in log2 units (its start, -1e30, scaled alike); ex2.approx's error is
  // far inside the bf16 tolerance of 2e-2.
  const float mul = p.softcap > 0.f ? kLog2e : p.scale * kLog2e;
  float oacc[kPanels][32];
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[pn][i] = 0.f;
  float m0 = kMInit * kLog2e, m1 = kMInit * kLog2e;
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the row sums
  // Absolute positions of this warpgroup's rows inside the sequence.
  const int q_lo = p.q_offset + wg_row;
  const int q_hi = p.q_offset + min(wg_row + 64, p.Sq) - 1;

  for (int i = 0; i < t_end - t_begin; ++i) {
    const int t = t_begin + i, stage = i % kStages;
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    // The copies were made through the generic proxy; wgmma reads through
    // the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile t is in; every warpgroup is done with tile t-1
    {
      const int tn = t + kStages - 1, sn = (i + kStages - 1) % kStages;
      if (tn < t_end) {
        load_tile<kWgKeys, HD, HDP>(sk + sn * kKVBytes, kbase, kv_stride,
                                    tn * kWgKeys, p.Skv);
        load_tile<kWgKeys, HD, HDP>(sv + sn * kKVBytes, vbase, kv_stride,
                                    tn * kWgKeys, p.Skv);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const int kv0 = t * kWgKeys;
    const int cls = wg_row >= p.Sq ? kEmpty
                                   : tile_class(p, q_lo, q_hi, kv0, kv0 + kWgKeys - 1);
    if (cls == kEmpty) continue;  // uniform over the warpgroup

    // S = Q Kᵀ: 64 rows x 64 keys, in the accumulator layout: s[4n + e] at
    // row (e < 2 ? r0 : r1), key kv0 + 8n + 2 t4 + (e & 1).
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const uint32_t off = (ks % 4) * 32;  // 16 columns inside a 128-byte row
      const uint64_t da = desc_b128(
          sq + (ks / 4) * (kWgRows * 128) + wg * 64 * 128 + off, 1024);
      const uint64_t db = desc_b128(
          sk + stage * kKVBytes + (ks / 4) * (kWgKeys * 128) + off, 1024);
      wgmma_ss(s, da, db, ks > 0);
    }
    wgmma_commit_wait();
    fence_regs(s);

    if (p.softcap > 0.f) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = p.softcap * tanhf(s[e] * p.scale / p.softcap);
    }
    if (cls == kPartial) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = (e & 2) ? r1 : r0;
        const int kp = kv0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
        if (kp >= p.Skv || !admitted(p, p.q_offset + row, kp)) s[e] = kNegInf;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
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
    for (int n = 0; n < 8; ++n) {
      s[4 * n] = fast_exp2(fmaf(s[4 * n], mul, -mn0));
      s[4 * n + 1] = fast_exp2(fmaf(s[4 * n + 1], mul, -mn0));
      s[4 * n + 2] = fast_exp2(fmaf(s[4 * n + 2], mul, -mn1));
      s[4 * n + 3] = fast_exp2(fmaf(s[4 * n + 3], mul, -mn1));
      ps0 += s[4 * n] + s[4 * n + 1];
      ps1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        oacc[pn][4 * n] *= c0;
        oacc[pn][4 * n + 1] *= c0;
        oacc[pn][4 * n + 2] *= c1;
        oacc[pn][4 * n + 3] *= c1;
      }
    }
    // O += P V. P, rounded to bf16, is the A operand straight from the
    // score accumulators (the layouts agree); V is read MN-major (its hd
    // contiguous) through the descriptor's transpose bit, 16 keys (two
    // 1024-byte atoms) per k-step, one 64-column panel per product.
    uint32_t pa[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      pa[st][0] = pack_bf16(s[8 * st], s[8 * st + 1]);
      pa[st][1] = pack_bf16(s[8 * st + 2], s[8 * st + 3]);
      pa[st][2] = pack_bf16(s[8 * st + 4], s[8 * st + 5]);
      pa[st][3] = pack_bf16(s[8 * st + 6], s[8 * st + 7]);
    }
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_regs(oacc[pn]);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < 4; ++st) {
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn)
        wgmma_rs(oacc[pn], pa[st],
                 desc_b128(sv + stage * kKVBytes + pn * (kWgKeys * 128) + st * 2048, 1024));
    }
    wgmma_commit_wait();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_regs(oacc[pn]);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + (((long long)b * p.Sq + r0) * p.H + h) * HD;
  __nv_bfloat16* o1 = o + (((long long)b * p.Sq + r1) * p.H + h) * HD;
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = pn * 64 + 8 * n + 2 * t4;
      if (d >= HD) continue;
      if (r0 < p.Sq)
        *reinterpret_cast<uint32_t*>(o0 + d) =
            pack_bf16(oacc[pn][4 * n] / den0, oacc[pn][4 * n + 1] / den0);
      if (r1 < p.Sq)
        *reinterpret_cast<uint32_t*>(o1 + d) =
            pack_bf16(oacc[pn][4 * n + 2] / den1, oacc[pn][4 * n + 3] / den1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int kThreadsPerRow = 4;
constexpr int kFmaThreads = kBlockQ * kThreadsPerRow;
constexpr int kKeyChunk = 16;

template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
flash_attention_fma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           Params p) {
  constexpr int kVec = HD / 4;                         // float4s per row
  constexpr int kVecPerThread = kVec / kThreadsPerRow;  // HD / 16
  extern __shared__ float4 smem[];
  float4* ks = smem;                    // [kBlockK][kVec]
  float4* vs = smem + kBlockK * kVec;   // [kBlockK][kVec]

  int b, h, q_start;
  tile_of_block(p, b, h, q_start);
  const int kh = h / p.G;
  const int row = threadIdx.x / kThreadsPerRow;
  const int part = threadIdx.x % kThreadsPerRow;
  const int qi = q_start + row;
  const bool row_ok = qi < p.Sq;
  const int q_pos = p.q_offset + qi;

  float4 qv[kVecPerThread], acc[kVecPerThread];
  {
    const float* qrow =
        q + (((long long)b * p.Sq + (row_ok ? qi : 0)) * p.H + h) * HD;
#pragma unroll
    for (int c = 0; c < kVecPerThread; ++c) {
      const int d = (c * kThreadsPerRow + part) * 4;
      qv[c] = row_ok ? make_float4(qrow[d] * p.scale, qrow[d + 1] * p.scale,
                                   qrow[d + 2] * p.scale, qrow[d + 3] * p.scale)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float m_run = kMInit, l_run = 0.f;

  int t_begin, t_end;
  kv_tiles(p, q_start, t_begin, t_end);
  const long long kv_row = (long long)p.K * HD;  // stride between positions
  const float* kbase = k + (long long)b * p.Skv * kv_row + (long long)kh * HD;
  const float* vbase = v + (long long)b * p.Skv * kv_row + (long long)kh * HD;
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  for (int t = t_begin; t < t_end; ++t) {
    const int kv0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kBlockK * HD; e += kFmaThreads) {
      const int r = e / HD, d = e % HD;
      const int j = kv0 + r;
      ksf[e] = j < p.Skv ? kbase[j * kv_row + d] : 0.f;
      vsf[e] = j < p.Skv ? vbase[j * kv_row + d] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kBlockK; j0 += kKeyChunk) {
      float s[kKeyChunk];
      float m_chunk = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const float4* krow = ks + (j0 + jj) * kVec;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kVecPerThread; ++c) {
          const float4 kk = krow[c * kThreadsPerRow + part];
          dot += qv[c].x * kk.x + qv[c].y * kk.y + qv[c].z * kk.z +
                 qv[c].w * kk.w;
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
        const int kp = kv0 + j0 + jj;
        if (kp >= p.Skv || !admitted(p, q_pos, kp)) dot = kNegInf;
        s[jj] = dot;
        m_chunk = fmaxf(m_chunk, dot);
      }
      const float m_new = fmaxf(m_run, m_chunk);
      const float corr = expf(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l_run = l_run * corr + psum;
#pragma unroll
      for (int c = 0; c < kVecPerThread; ++c) {
        acc[c].x *= corr;
        acc[c].y *= corr;
        acc[c].z *= corr;
        acc[c].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < kKeyChunk; ++jj) {
        const float pj = s[jj];
        const float4* vrow = vs + (j0 + jj) * kVec;
#pragma unroll
        for (int c = 0; c < kVecPerThread; ++c) {
          const float4 vv = vrow[c * kThreadsPerRow + part];
          acc[c].x += pj * vv.x;
          acc[c].y += pj * vv.y;
          acc[c].z += pj * vv.z;
          acc[c].w += pj * vv.w;
        }
      }
      m_run = m_new;
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l_run, 1e-30f);
    float* orow = o + (((long long)b * p.Sq + qi) * p.H + h) * HD;
#pragma unroll
    for (int c = 0; c < kVecPerThread; ++c) {
      const int d = (c * kThreadsPerRow + part) * 4;
      orow[d] = acc[c].x / denom;
      orow[d + 1] = acc[c].y / denom;
      orow[d + 2] = acc[c].z / denom;
      orow[d + 3] = acc[c].w / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int kRows = kBlockQ>
unsigned n_blocks(const Params& p) {
  return (unsigned)((long long)p.B * p.H * ((p.Sq + kRows - 1) / kRows));
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const Params& p, cudaStream_t stream) {
  constexpr int HDP = HD < 64 ? 64 : HD;
  // Q, the K and V rings, and the slack that aligns them to 1024 bytes.
  constexpr int kSmem = (kWgRows + 2 * kStages * kWgKeys) * HDP * 2 + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(flash_attention_wgmma_kernel<HD>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_attention_wgmma_kernel<HD><<<n_blocks<kWgRows>(p), kWgThreads, kSmem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               const Params& p, cudaStream_t stream) {
  const int smem = 2 * kBlockK * HD * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(flash_attention_fma_kernel<HD>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_attention_fma_kernel<HD><<<n_blocks(p), kFmaThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           const Params& p, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_fma<HD>(q, k, v, o, p, stream);
    case 1: return launch_wgmma<HD>(q, k, v, o, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kind: 0 = causal, 1 = full, 2 = prefix.
// All tensors contiguous in the (B, S, heads, hd) layout and 16-byte aligned.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int K, int hd, float scale, float softcap,
    int kind, int window, int prefix_len, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  const Params p{B, Sq, Skv, H, K, H / K, scale, softcap,
                 kind, window, prefix_len, q_offset};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(dtype, q, k, v, o, p, st);
    case 32: return launch<32>(dtype, q, k, v, o, p, st);
    case 64: return launch<64>(dtype, q, k, v, o, p, st);
    case 128: return launch<128>(dtype, q, k, v, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
