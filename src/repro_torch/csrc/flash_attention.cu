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
// The kernels, by input type and shape:
//
// * bf16 (the training path): a Hopper kernel on wgmma. A CTA of two
//   warpgroups owns 128 query rows of one (b, h), 64 rows each; Q stays in
//   shared memory for the whole CTA. KV tiles of 64 keys stream through a
//   ring of 3 stages in dynamic shared memory, loaded by cp.async two
//   tiles ahead of the math, so the copies overlap the products (at hd 256
//   the ring holds 2 stages, one tile ahead: Q and 3 stages of K and V
//   would need 263,168 bytes, past the 232,448 a block may opt in to; 2
//   need 197,632). Every
//   tile sits in shared memory in the 128-byte-swizzle layout that TMA
//   would write (16-byte piece c of row r at c ^ (r % 8)), in panels of 64
//   columns (one 128-byte row each), the head dim zero-padded to a whole
//   number of panels (16 and 32 to one, kimi's 112 to two), so the products
//   read it without bank conflicts:
//     S = Q Kᵀ: wgmma.m64n64k16, Q and K K-major from shared memory, one
//       k-step per 16 columns of the real head dim (7 at hd 112): the
//       padding columns are zero in Q and K alike and would add only zeros;
//     O += P V: wgmma.m64n64k16 with P (the score accumulators rounded to
//       bf16, whose layout is the A fragment) in registers, and V read
//       MN-major from the same swizzled rows through the transpose bit, so
//       no transposed copy is built; one product per 64 columns of hd
//       (four at hd 256, whose 64 x 256 fp32 output accumulator is 128
//       registers a thread beside the 32 of the score tile).
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
//   Given an lse pointer (a call that wants a gradient), it also writes each
//   row's log-sum-exp, m + log(l), for the backward (attention_bwd.cuh);
//   the output is the same bits either way.
// * fp32 (the parity sweeps, held to 2e-5, which tensor cores cannot meet):
//   plain FMA on the CUDA cores. A CTA of 256 threads owns 64 rows, four
//   threads per row, each holding an interleaved quarter of q and of the
//   accumulator; K/V tiles in shared memory as float4 rows (128 KB at hd
//   256, through the dynamic shared-memory opt-in); the softmax rescales
//   once per 16 keys.
//
// * bf16 decode regime (Sq·G <= 64, G = H/K: every serving decode step, from
//   G = 1 to granite's 48:1): one query row, or a few, over a KV cache. Its
//   bound is the K/V bytes of the admitted rows, read once per kv head;
//   q and o are a few KB. The training tile would give it one CTA per query
//   head with 1 of 128 rows live, read a GQA group's K/V G times and walk
//   every key tile in series on B·H CTAs (64 at PaliGemma's and gemma2's
//   shapes, on 132 SMs). Instead:
//     rows: a CTA owns one (b, kv head) and all Sq·G query rows that read
//       it, row s·G + g of its tile being query s of head kh·G + g, so each
//       K/V byte is read once per group;
//     keys: the admitted range [lo, hi) (kv_range, kv_tiles' rule for
//       the whole group) is cut into n_split runs of whole 64-key tiles, one
//       CTA each (B·K·n_split CTAs). The split count comes from the caller
//       (kernels/flash_attention.py:decode_split_plan: about one CTA an
//       SM, two where the runs stay long) and is checked here. Each CTA streams its tiles through the
//       same cp.async ring and 128-byte swizzle as the tile above; its 4
//       warps split each tile's keys (past 16 rows: take a 16-row tile
//       each) and combine in a fixed order through shared memory at the end;
//     merge: at n_split = 1 the CTA writes the bf16 output. Otherwise it
//       writes fp32 partials (m and l per row, the unnormalised o) to a
//       workspace the caller allocates, and a second kernel merges them in
//       split order (deterministic: no atomics). A split whose keys the
//       mask removes keeps m at its start value and adds exp2(-1e30 - M) = 0.
//     products: mma.sync.m16n8k16 (bf16 in, fp32 sums) on 16-row tiles,
//       Q, K and V (transposed) fed by ldmatrix. wgmma needs 64 rows a
//       product and would waste 63 of them at G = 1 and 56 at G = 8; the
//       work is some 2 operations a byte of K/V, far below the card's ridge
//       of about 295, so the products only have to keep up with the loads.
//   The numerics are the tile's: scale or softcap·tanh(s·scale/softcap),
//   log2 units, P rounded to bf16 before P·V, fp32 m, l and accumulator,
//   m starting at -1e30, masked scores -2e38, output acc / max(l, 1e-30).
//
// All three skip KV tiles that the mask removes entirely, which leaves the
// result bit-identical (such a tile adds exp(-2e38 - m) = 0 and rescales by
// exp(0) = 1); all mask ragged Sq/Skv edges, so no shape has to divide the
// tile sizes; the two training kernels schedule heavy causal tiles (high q
// index) first.
#include "flash_attention.cuh"

namespace {

using namespace repro_fa;

// ---------------------------------------------------------------------------
// bf16: Hopper (cp.async ring, wgmma).
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, Params p) {
  static_assert(HD % 16 == 0, "a wgmma k-step is 16 columns of the head dim");
  constexpr int HDP = hd_padded<HD>();
  constexpr int kPanels = HDP / 64;
  constexpr int kQBytes = kWgRows * HDP * 2;
  constexpr int kKVBytes = kWgKeys * HDP * 2;
  // k-steps of QKᵀ: the real head dim's, HD / 16, not HDP / 16 (the
  // padding columns are zero in both operands, so their steps would add
  // only zeros to the fp32 scores).
  constexpr int kSteps = HD / 16;
  constexpr int kStages = stages_for<HD>();
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
  // Each row's log-sum-exp of its scores, for the backward (only when asked:
  // serving and calls without a gradient pass null). m is in log2 units; a
  // row that the mask leaves empty gets +inf, so that the backward's
  // exp(score - lse) is 0 there, as the row's output is.
  if (lse != nullptr && t4 == 0) {
    float* lrow = lse + ((long long)b * p.H + h) * p.Sq;
    if (r0 < p.Sq) lrow[r0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : pos_inf();
    if (r1 < p.Sq) lrow[r1] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : pos_inf();
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
  static_assert(kVec % kThreadsPerRow == 0,
                "each of a row's threads holds whole float4s (hd 112: 7)");
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
// bf16 decode regime: the split merge (the kernel is in flash_attention.cuh).
// ---------------------------------------------------------------------------

// The split merge: one CTA per (b, kv head, row); the splits in order.
__global__ void __launch_bounds__(kMergeThreads)
flash_attention_merge_kernel(const float2* __restrict__ ws_ml,
                             const float* __restrict__ ws_o,
                             __nv_bfloat16* __restrict__ o, Params p, int hd,
                             int n_split) {
  const int R = p.Sq * p.G;
  const int r = blockIdx.x % R, bk = blockIdx.x / R;
  const int b = bk / p.K, kh = bk % p.K;
  const int s = r / p.G, gg = r % p.G;
  const float2* ml = ws_ml + (long long)bk * n_split * R + r;  // split j at ml[j R]
  float M = ml[0].x;
  for (int j = 1; j < n_split; ++j) M = fmaxf(M, ml[(long long)j * R].x);
  float L = 0.f;
  for (int j = 0; j < n_split; ++j) {
    const float2 x = ml[(long long)j * R];
    L += x.y * fast_exp2(x.x - M);
  }
  const float den = fmaxf(L, 1e-30f);
  __nv_bfloat16* orow = o + (((long long)b * p.Sq + s) * p.H + kh * p.G + gg) * hd;
  const float* obase = ws_o + ((long long)bk * n_split * R + r) * hd;
  for (int d = 2 * threadIdx.x; d < hd; d += 2 * kMergeThreads) {
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const float w = fast_exp2(ml[(long long)j * R].x - M);
      const float2 x = *reinterpret_cast<const float2*>(obase + (long long)j * R * hd + d);
      o0 += x.x * w;
      o1 += x.y * w;
    }
    *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16(o0 / den, o1 / den);
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
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                 const Params& p, cudaStream_t stream) {
  constexpr int HDP = hd_padded<HD>();
  // Q, the K and V rings, and the slack that aligns them to 1024 bytes.
  constexpr int kSmem = (kWgRows + 2 * stages_for<HD>() * kWgKeys) * HDP * 2 + 1024;
  static_assert(kSmem <= 232448, "past the H100's shared memory per block");
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(flash_attention_wgmma_kernel<HD>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_attention_wgmma_kernel<HD><<<n_blocks<kWgRows>(p), kWgThreads, kSmem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, p);
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
int launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
           const Params& p, cudaStream_t stream) {
  switch (dtype) {
    case 0: return lse ? (int)cudaErrorInvalidValue : launch_fma<HD>(q, k, v, o, p, stream);
    case 1: return launch_wgmma<HD>(q, k, v, o, lse, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The decode regime: its kernel, then (n_split > 1) the merge. Workspace
// (fp32): (m, l) per partial row, then o.
template <int HD>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  void* workspace, const Params& p, int t_begin, int n_tiles,
                  int n_split, cudaStream_t stream) {
  const long long R = (long long)p.Sq * p.G;
  const long long groups = (long long)p.B * p.K;
  float2* ws_ml = reinterpret_cast<float2*>(workspace);
  float* ws_o = n_split > 1 ? reinterpret_cast<float*>(ws_ml + groups * n_split * R)
                            : nullptr;
  const int e = Decode<HD>::launch(q, k, v, o, ws_ml, ws_o, p, t_begin, n_tiles,
                                   n_split, stream);
  if (e != 0 || n_split == 1) return e;
  flash_attention_merge_kernel<<<(unsigned)(groups * R), kMergeThreads, 0, stream>>>(
      ws_ml, ws_o, (__nv_bfloat16*)o, p, HD, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kind: 0 = causal, 1 = full, 2 = prefix.
// All tensors contiguous in the (B, S, heads, hd) layout and 16-byte aligned.
// bf16 with Sq·(H/K) <= 64 takes the decode regime, cut into n_split runs
// of key tiles (1 <= n_split <= min(64, the admitted range's 64-key tiles),
// or 1 where it has none); past n_split = 1 it needs `workspace`: B·K·n_split
// ·Sq·(H/K)·(hd + 2) floats. Every other call takes n_split = 1 and no
// workspace. `lse` (or null): fp32 (B, H, Sq), each query row's log-sum-exp of
// its scaled (and softcapped) scores, for the backward; bf16 only, and a call
// that asks for it takes the wgmma kernel whatever its shape, with n_split 1.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int K, int hd, float scale, float softcap,
    int kind, int window, int prefix_len, int q_offset, int n_split,
    void* workspace, void* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  const Params p{B, Sq, Skv, H, K, H / K, scale, softcap,
                 kind, window, prefix_len, q_offset};
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = reinterpret_cast<float*>(lse);
  if (dtype != 1 || (long long)Sq * p.G > kDecRows || l != nullptr) {
    if (n_split != 1) return (int)cudaErrorInvalidValue;
    switch (hd) {
      case 16: return launch<16>(dtype, q, k, v, o, l, p, st);
      case 32: return launch<32>(dtype, q, k, v, o, l, p, st);
      case 64: return launch<64>(dtype, q, k, v, o, l, p, st);
      case 112: return launch<112>(dtype, q, k, v, o, l, p, st);
      case 128: return launch<128>(dtype, q, k, v, o, l, p, st);
      case 256: return launch<256>(dtype, q, k, v, o, l, p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  int lo, hi;
  kv_range(p, 0, Sq, lo, hi);  // all Sq rows in one block
  const int t_begin = lo / kDecKeys;
  int n_tiles = (hi + kDecKeys - 1) / kDecKeys - t_begin;
  if (n_tiles < 0) n_tiles = 0;
  const int most = n_tiles < kMaxSplits ? (n_tiles > 1 ? n_tiles : 1) : kMaxSplits;
  if (n_split < 1 || n_split > most || (n_split > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_decode<16>(q, k, v, o, workspace, p, t_begin, n_tiles, n_split, st);
    case 32: return launch_decode<32>(q, k, v, o, workspace, p, t_begin, n_tiles, n_split, st);
    case 64: return launch_decode<64>(q, k, v, o, workspace, p, t_begin, n_tiles, n_split, st);
    case 112: return launch_decode<112>(q, k, v, o, workspace, p, t_begin, n_tiles, n_split, st);
    case 128: return launch_decode<128>(q, k, v, o, workspace, p, t_begin, n_tiles, n_split, st);
    case 256: return launch_decode<256>(q, k, v, o, workspace, p, t_begin, n_tiles, n_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
