// Flash attention backward (bf16, Hopper): dq, dk and dv of the forward in
// flash_attention.cu, from its output o and each query row's log-sum-exp
// (lse, which the forward writes when a gradient is wanted). The JAX package
// has no backward kernel (its _fa_bwd differentiates the XLA attention); the
// port's plain fp32 autograd of attention_plain materialised the dense score
// matrix, masked half included, and ran six fp32 products off the tensor
// cores. This replaces it for bf16 calls at head dims 16, 32, 64, 112 and 128.
//
// Three launches, no atomics, so the gradients are the same bits on every run:
//
// * prep (attention_bwd.cu): D = rowsum(dO ∘ O) in fp32, (B, H, Sq).
// * dK/dV: one CTA, one warpgroup, per (batch, kv head, 64 keys). K and V
//   stay in shared memory; the CTA walks the G query heads of its GQA group
//   and, for each, the 64-row query tiles that the mask admits for its keys
//   (q_range, kv_range turned around). Q, dO and the tile's lse and D rows
//   stream through a cp.async ring in the forward's 128-byte swizzle. A tile
//   is, with keys on the accumulator's rows:
//     Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (wgmma, both from shared memory, issued
//       together),
//     Pᵀ = exp(score - lse), the score being scale·s or softcap·tanh(scale·s
//       / softcap) as in the forward, while dPᵀ is in flight,
//     dV += Pᵀ dO (Pᵀ rounded to bf16, from registers; dO through the
//       descriptor's transpose bit, as the forward reads V),
//     dSᵀ = Pᵀ ∘ (dPᵀ - D), times 1 - tanh² under a softcap, while dV's
//       product is in flight,
//     dK += dSᵀ Q (dSᵀ rounded to bf16).
//   dK and dV accumulate in fp32 registers and are written once, dK times
//   scale (the score's derivative with respect to q·k). At hd <= 64 three
//   CTAs share an SM (168 registers a thread).
// * dQ: one CTA of two warpgroups per (batch, head, 128 query rows), 64 rows
//   a warpgroup, as the forward's tile; Q and dO stay in shared memory and the
//   admitted K/V tiles stream through the ring. It recomputes S and dP
//   (issued together), P and dS, and accumulates dQ += dS K in fp32, written
//   once (times scale). At hd <= 64 two CTAs share an SM (128 registers).
//
// Each tile's elementwise code is one of six branch-free instances (softcap
// or not; no mask, the causal rule, or admitted() per element), chosen once
// per tile. Measured on the H100 at GPT-2's and Whisper's shapes (PERF.md),
// what did not pay: a third ring stage; two warpgroups a dK/dV CTA (one CTA
// an SM at 218 registers); four CTAs an SM (spills at 128 registers); and
// leaving a tile's last products in flight into the next tile, which makes
// ptxas serialize every product of the kernel (C7515).
//
// Seven products per admitted (query, key) pair and head, against the five of
// a backward that adds dQ with atomics across the dK/dV CTAs: the two more
// buy gradients that do not depend on the order CTAs finish in. Operands are
// bf16 (P and dS rounded to it, as the forward rounds P for P·V); scores,
// softmax, lse, D and the accumulators fp32.
//
// Bound, at GPT-2's (12, 1024, 12, 64) causal: 10·hd operations per admitted
// pair and head (the five products) is 48 GFLOP, 49 µs on the tensor cores;
// the bytes (q, k, v, o, dO read, dq, dk, dv written, lse and D: 152 MB)
// take 45 µs, so the bound is the operations, barely.
//
// Head dim 256 keeps the plain backward: dK and dV alone would take 256 fp32
// accumulators a thread, past the 255 registers a thread may have.
#pragma once

#include "flash_attention.cuh"

namespace repro_fa {

constexpr int kBwdKeys = 64;       // dK/dV: keys per CTA, one warpgroup
constexpr int kDkdvThreads = 128;
constexpr int kBwdQTile = 64;  // dK/dV: query rows per streamed tile
constexpr int kBwdRows = 128;  // dQ: query rows per CTA, 64 a warpgroup
constexpr int kBwdKTile = 64;  // dQ: keys per streamed tile
// Ring stages: each tile's copies are issued while the tile before it is
// computed. A tile's products are all done before the next tile starts, so
// its stage is free for the load issued at the next tile. (A third stage,
// two tiles ahead, was no faster at GPT-2's and Whisper's shapes.)
constexpr int kBwdStages = 2;
constexpr int kPrepWarps = 8;

struct BwdTensors {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq): D, written by the prep kernel
  __nv_bfloat16 *dq, *dk, *dv;
};

// The query rows [lo, hi) (indices into Sq) that the mask can admit for any
// key in [k_start, k_start + rows): kv_range turned around. A causal key
// admits the queries at or after it, and under a window only those less
// than `window` after it; a prefix key every query inside the prefix too,
// whatever the window. kernels/flash_attention.py:admitted_queries computes
// the same range.
__host__ __device__ __forceinline__ void q_range(const Params& p, int k_start, int rows,
                                                 int& lo, int& hi) {
  const int k_last = (k_start + rows < p.Skv ? k_start + rows : p.Skv) - 1;
  lo = 0;
  hi = p.Sq;
  if (p.kind != kFull) {
    const bool in_prefix = p.kind == kPrefix && p.prefix_len > 0 && k_start < p.prefix_len;
    lo = in_prefix ? 0 : k_start - p.q_offset;
    if (p.window > 0 && !in_prefix) hi = k_last + p.window - p.q_offset;
    lo = lo < 0 ? 0 : (lo > p.Sq ? p.Sq : lo);
    hi = hi < lo ? lo : (hi > p.Sq ? p.Sq : hi);
  }
}

// 4 bytes global -> shared, zero-filled when !valid (src is then unread).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// What the elementwise code of a tile needs to know at compile time: whether
// a softcap applies, and how the tile is masked: not at all (every pair
// admitted), by the causal rule alone (a causal mask without a window: the
// diagonal tiles), or by admitted(). with_flags calls f(Flag<softcap>(),
// Mask<kind>()) on the one of six instances that the tile needs, so that no
// instance branches per element.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};
enum ElementMask { kNoMask = 0, kCausalMask = 1, kAnyMask = 2 };
template <int M>
struct Mask {
  static constexpr int value = M;
};
__device__ __forceinline__ int element_mask(const Params& p, int cls) {
  return cls != kPartial ? kNoMask
                         : (p.kind == kCausal && p.window == 0 ? kCausalMask : kAnyMask);
}
template <typename F>
__device__ __forceinline__ void with_flags(bool softcap, int mask, F&& f) {
  auto by_mask = [&](auto cap) {
    if (mask == kCausalMask) f(cap, Mask<kCausalMask>());
    else if (mask == kAnyMask) f(cap, Mask<kAnyMask>());
    else f(cap, Mask<kNoMask>());
  };
  if (softcap) by_mask(Flag<true>());
  else by_mask(Flag<false>());
}
// Whether a partial tile's element (query position qp, key kp) counts: inside
// the ragged edges and admitted by the mask.
template <int M>
__device__ __forceinline__ bool element_in(const Params& p, int qi, int kp) {
  const int qp = p.q_offset + qi;
  if (kp >= p.Skv || qi >= p.Sq) return false;
  return M == kCausalMask ? kp <= qp : admitted(p, qp, kp);
}

// The score from the raw product s, and the factor that carries dScore back
// to d(score before the softcap) / scale: under a softcap x = softcap ·
// tanh(s · scale / softcap) (the forward's arithmetic, with scale / softcap
// and 1 / softcap taken once: `cap_in`, `cap_inv`) and 1 - tanh², else s and 1.
template <bool kCap>
__device__ __forceinline__ float bwd_score(const Params& p, float cap_in, float cap_inv,
                                           float s, float& dfac) {
  if constexpr (kCap) {
    const float x = p.softcap * tanhf(s * cap_in);
    const float t = x * cap_inv;
    dfac = 1.f - t * t;
    return x;
  } else {
    dfac = 1.f;
    return s;
  }
}

// Pack a 64x64 fp32 accumulator (in wgmma's layout) into the four bf16 A
// fragments of its 16-column k-steps, as the forward packs P.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    a[st][0] = pack_bf16(x[8 * st], x[8 * st + 1]);
    a[st][1] = pack_bf16(x[8 * st + 2], x[8 * st + 3]);
    a[st][2] = pack_bf16(x[8 * st + 4], x[8 * st + 5]);
    a[st][3] = pack_bf16(x[8 * st + 6], x[8 * st + 7]);
  }
}

// The products are issued asynchronously, one commit group each, and waited
// for by wgmma_wait<N> (all but the newest N groups done), so that a
// warpgroup's softmax work overlaps its products in flight; every product of
// a tile is done before the next tile. The register fences after a wait tie
// the accumulators' and the A fragments' registers to that point, so that
// the compiler neither reads an accumulator nor reuses a fragment's registers
// while a product still uses them. Nothing but a wgmma may define an
// accumulator between its issue and its wait (ptxas would serialize every
// product of the kernel), so no fence comes in between.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int st = 0; st < 4; ++st)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[st][j]) :: "memory");
}
template <int kPanels>
__device__ __forceinline__ void fence_acc(float (&acc)[kPanels][32]) {
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) fence_regs(acc[pn]);
}

// Issue acc[pn] += A (64x64 bf16, registers) * B (64 rows x HD, MN-major
// through the transpose bit), B's 64 rows a swizzled tile of 64-row panels
// at `tile`; one commit group.
template <int kPanels>
__device__ __forceinline__ void issue_acc(float (&acc)[kPanels][32], uint32_t (&a)[4][4],
                                          uint32_t tile) {
  fence_acc(acc);
  fence_frags(a);
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < 4; ++st)
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn)
      wgmma_rs(acc[pn], a[st], desc_b128(tile + pn * (64 * 128) + st * 2048, 1024));
  wgmma_commit();
}

// Issue d = A Bᵀ over the real head dim, A's 64 rows from a swizzled tile of
// kARows rows at `a_tile` (rows a_row0..a_row0+63), B's 64 rows from one of
// kBRows rows at `b_tile`, both K-major; one commit group.
template <int HD, int kARows, int kBRows>
__device__ __forceinline__ void issue_abt(float (&d)[32], uint32_t a_tile, int a_row0,
                                          uint32_t b_tile) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;  // 16 columns inside a 128-byte row
    wgmma_ss(d, desc_b128(a_tile + (ks / 4) * (kARows * 128) + a_row0 * 128 + off, 1024),
             desc_b128(b_tile + (ks / 4) * (kBRows * 128) + off, 1024), ks > 0);
  }
  wgmma_commit();
}

template <int HD>
__host__ __device__ constexpr int bwd_kv_bytes() { return kBwdKeys * hd_padded<HD>() * 2; }
// One stage of the dK/dV ring: the Q and dO tiles, then the tile's lse and D
// rows, padded so that the next stage's tiles start 1024-byte aligned.
template <int HD>
__host__ __device__ constexpr int bwd_stage_bytes() {
  return 2 * kBwdQTile * hd_padded<HD>() * 2 + 1024;
}
template <int HD>
__host__ __device__ constexpr int dkdv_smem() {
  return 1024 + 2 * bwd_kv_bytes<HD>() + kBwdStages * bwd_stage_bytes<HD>();
}
template <int HD>
__host__ __device__ constexpr int dq_smem() {
  return 1024 + 2 * kBwdRows * hd_padded<HD>() * 2 + kBwdStages * 2 * kBwdKTile * hd_padded<HD>() * 2;
}

template <int HD>
__global__ void __launch_bounds__(kDkdvThreads, HD <= 64 ? 3 : 1)
attn_bwd_dkdv_kernel(BwdTensors t, Params p) {
  static_assert(HD % 16 == 0, "a wgmma k-step is 16 columns of the head dim");
  constexpr int HDP = hd_padded<HD>();
  constexpr int kPanels = HDP / 64;
  constexpr int kTileBytes = kBwdQTile * HDP * 2;
  constexpr int kStage = bwd_stage_bytes<HD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sk = (raw + 1023u) & ~1023u;
  const uint32_t sv = sk + bwd_kv_bytes<HD>();
  const uint32_t ring = sv + bwd_kv_bytes<HD>();

  const int nk = (p.Skv + kBwdKeys - 1) / kBwdKeys;
  const int bk = blockIdx.x / nk;  // (b, kv head); low key blocks first: under
  const int b = bk / p.K, kh = bk % p.K;  // a causal mask they admit the most rows
  const int k_start = (blockIdx.x % nk) * kBwdKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = k_start + warp * 16 + g, r1 = r0 + 8;  // this thread's keys

  if (HD < HDP) {  // zero the tiles once: the padding columns stay zero
    uint4* base = reinterpret_cast<uint4*>(smem_raw + (sk - raw));
    const int n16 = (2 * bwd_kv_bytes<HD>() + kBwdStages * kStage) / 16;
    for (int e = threadIdx.x; e < n16; e += kDkdvThreads) base[e] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  int q_lo, q_hi;
  q_range(p, k_start, kBwdKeys, q_lo, q_hi);
  const int qt_begin = q_lo / kBwdQTile;
  const int n_qt = q_hi > q_lo ? (q_hi + kBwdQTile - 1) / kBwdQTile - qt_begin : 0;
  const int n_tiles = p.G * n_qt;  // (head of the group, query tile), heads outer
  const long long q_stride = (long long)p.H * HD;
  const long long kv_stride = (long long)p.K * HD;
  const long long kv_off = (long long)b * p.Skv * kv_stride + (long long)kh * HD;

  auto load = [&](int i, int stage) {
    const int h = kh * p.G + i / n_qt, q0 = (qt_begin + i % n_qt) * kBwdQTile;
    const long long q_off = (long long)b * p.Sq * q_stride + (long long)h * HD;
    const uint32_t st = ring + stage * kStage;
    load_tile<kBwdQTile, HD, HDP, kDkdvThreads>(st, t.q + q_off, q_stride, q0, p.Sq);
    load_tile<kBwdQTile, HD, HDP, kDkdvThreads>(st + kTileBytes, t.dout + q_off, q_stride, q0, p.Sq);
    if (threadIdx.x < 2 * kBwdQTile) {  // lse rows, then D rows
      const int r = threadIdx.x % kBwdQTile, row = q0 + r;
      const float* src = threadIdx.x < kBwdQTile ? t.lse : t.delta;
      const bool ok = row < p.Sq;
      cp_async4(st + 2 * kTileBytes + threadIdx.x * 4,
                src + ((long long)b * p.H + h) * p.Sq + (ok ? row : 0), ok);
    }
  };

  // Prologue: K and V join the first tile's copy group.
  load_tile<kBwdKeys, HD, HDP, kDkdvThreads>(sk, t.k + kv_off, kv_stride, k_start, p.Skv);
  load_tile<kBwdKeys, HD, HDP, kDkdvThreads>(sv, t.v + kv_off, kv_stride, k_start, p.Skv);
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // With one panel the dS fragments get registers of their own, so that dS
  // is packed while dV's product is in flight; past one panel (hd 112,
  // 128) they reuse P's, after that product.
  constexpr bool kTwoPacks = kPanels == 1;
  const float mul = p.softcap > 0.f ? kLog2e : p.scale * kLog2e;
  const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
  const float cap_inv = p.softcap > 0.f ? 1.f / p.softcap : 0.f;
  float dk[kPanels][32], dv[kPanels][32];
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[pn][e] = dv[pn][e] = 0.f;
  uint32_t packs[kTwoPacks ? 2 : 1][4][4];
  auto& pa = packs[0];
  auto& pb = packs[kTwoPacks ? 1 : 0];

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % kBwdStages;
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kBwdStages - 2) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile i is in; every warp is done with tile i - 1
    {
      const int in = i + kBwdStages - 1;  // into tile i - 1's stage
      if (in < n_tiles) load(in, in % kBwdStages);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const int q0 = (qt_begin + i % n_qt) * kBwdQTile;
    const int q_last = min(q0 + kBwdQTile, p.Sq) - 1;
    int cls = tile_class(p, p.q_offset + q0, p.q_offset + q_last, k_start, k_start + 63);
    if (cls == kEmpty) continue;  // uniform over the CTA
    if (q_last < q0 + kBwdQTile - 1) cls = kPartial;  // ragged query rows
    const uint32_t sq = ring + stage * kStage, sdo = sq + kTileBytes;
    const float* s_lse = reinterpret_cast<const float*>(smem_raw + (sq + 2 * kTileBytes - raw));
    const float* s_d = s_lse + kBwdQTile;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: st[4n + e] (and dpt's) at key (e < 2 ? r0 :
    // r1), query q0 + c, c = 8n + 2 t4 + (e & 1).
    float st[32], dpt[32];
    issue_abt<HD, kBwdKeys, kBwdQTile>(st, sk, 0, sq);
    issue_abt<HD, kBwdKeys, kBwdQTile>(dpt, sv, 0, sdo);
    wgmma_wait<1>();
    fence_regs(st);
    // Pᵀ into pa (bf16), and Pᵀ·(1 - tanh²) into st for dS.
    with_flags(p.softcap > 0.f, element_mask(p, cls), [&](auto cap, auto mask) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        float pe[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * (e >> 2) + 2 * t4 + j;
          float dfac;
          const float x = bwd_score<decltype(cap)::value>(p, cap_in, cap_inv, st[e + j], dfac);
          pe[j] = fast_exp2(fmaf(x, mul, -s_lse[c] * kLog2e));
          if constexpr (decltype(mask)::value != kNoMask) {
            if (!element_in<decltype(mask)::value>(p, q0 + c, (e & 2) ? r1 : r0)) pe[j] = 0.f;
          }
          st[e + j] = pe[j] * dfac;
        }
        pa[e / 8][(e % 8) / 2] = pack_bf16(pe[0], pe[1]);  // pack_a's layout
      }
    });
    issue_acc<kPanels>(dv, pa, sdo);  // dV += Pᵀ dO
    if constexpr (kTwoPacks) wgmma_wait<1>(); else wgmma_wait<0>();
    fence_regs(dpt);
    if constexpr (!kTwoPacks) fence_frags(pa);
#pragma unroll
    for (int e = 0; e < 32; ++e) dpt[e] = st[e] * (dpt[e] - s_d[8 * (e >> 2) + 2 * t4 + (e & 1)]);
    pack_a(pb, dpt);
    issue_acc<kPanels>(dk, pb, sq);  // dK += dSᵀ Q
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);
    fence_frags(pa);
    fence_frags(pb);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = pn * 64 + 8 * n + 2 * t4;
      if (d >= HD) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= p.Skv) continue;
        const long long at = ((long long)b * p.Skv + r) * kv_stride + (long long)kh * HD + d;
        const int e = 4 * n + 2 * half;
        *reinterpret_cast<uint32_t*>(t.dk + at) =
            pack_bf16(dk[pn][e] * p.scale, dk[pn][e + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(t.dv + at) = pack_bf16(dv[pn][e], dv[pn][e + 1]);
      }
    }
  }
}

// Two CTAs an SM up to hd 64 (128 registers a thread), one past it.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, HD <= 64 ? 2 : 1)
attn_bwd_dq_kernel(BwdTensors t, Params p) {
  static_assert(HD % 16 == 0, "a wgmma k-step is 16 columns of the head dim");
  constexpr int HDP = hd_padded<HD>();
  constexpr int kPanels = HDP / 64;
  constexpr int kRowBytes = kBwdRows * HDP * 2;
  constexpr int kKVBytes = kBwdKTile * HDP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sdo = sq + kRowBytes;
  const uint32_t sk = sdo + kRowBytes;  // stage s: K at sk + 2 s kKVBytes, V after it

  int b, h, q_start;
  tile_of_block<kBwdRows>(p, b, h, q_start);
  const int kh = h / p.G;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wg_row = q_start + wg * 64;
  const int r0 = wg_row + warp * 16 + g, r1 = r0 + 8;  // this thread's rows

  if (HD < HDP) {
    uint4* base = reinterpret_cast<uint4*>(smem_raw + (sq - raw));
    const int n16 = (2 * kRowBytes + kBwdStages * 2 * kKVBytes) / 16;
    for (int e = threadIdx.x; e < n16; e += kWgThreads) base[e] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  int t_begin, t_end;
  kv_tiles<kBwdRows, kBwdKTile>(p, q_start, t_begin, t_end);
  const long long q_stride = (long long)p.H * HD;
  const long long kv_stride = (long long)p.K * HD;
  const long long q_off = (long long)b * p.Sq * q_stride + (long long)h * HD;
  const long long kv_off = (long long)b * p.Skv * kv_stride + (long long)kh * HD;
  auto load = [&](int tile, int stage) {
    const uint32_t st = sk + stage * 2 * kKVBytes;
    load_tile<kBwdKTile, HD, HDP>(st, t.k + kv_off, kv_stride, tile * kBwdKTile, p.Skv);
    load_tile<kBwdKTile, HD, HDP>(st + kKVBytes, t.v + kv_off, kv_stride, tile * kBwdKTile,
                                  p.Skv);
  };

  load_tile<kBwdRows, HD, HDP>(sq, t.q + q_off, q_stride, q_start, p.Sq);
  load_tile<kBwdRows, HD, HDP>(sdo, t.dout + q_off, q_stride, q_start, p.Sq);
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (t_begin + s < t_end) load(t_begin + s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // This thread's rows' lse (in log2 units) and D; rows past Sq read as 0.
  const float* lrow = t.lse + ((long long)b * p.H + h) * p.Sq;
  const float* drow = t.delta + ((long long)b * p.H + h) * p.Sq;
  const float lse0 = r0 < p.Sq ? lrow[r0] * kLog2e : 0.f;
  const float lse1 = r1 < p.Sq ? lrow[r1] * kLog2e : 0.f;
  const float d0 = r0 < p.Sq ? drow[r0] : 0.f, d1 = r1 < p.Sq ? drow[r1] : 0.f;
  const float mul = p.softcap > 0.f ? kLog2e : p.scale * kLog2e;
  const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
  const float cap_inv = p.softcap > 0.f ? 1.f / p.softcap : 0.f;
  const int q_lo = p.q_offset + wg_row;
  const int q_hi = p.q_offset + min(wg_row + 64, p.Sq) - 1;
  float dq[kPanels][32];
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn)
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[pn][e] = 0.f;

  uint32_t da[4][4];
  for (int i = 0; i < t_end - t_begin; ++i) {
    const int tile = t_begin + i, stage = i % kBwdStages;
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kBwdStages - 2) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile i is in; every warpgroup is done with tile i - 1
    {
      const int tn = tile + kBwdStages - 1;
      if (tn < t_end) load(tn, (i + kBwdStages - 1) % kBwdStages);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    const int kv0 = tile * kBwdKTile;
    const int cls = wg_row >= p.Sq ? kEmpty
                                   : tile_class(p, q_lo, q_hi, kv0, kv0 + kBwdKTile - 1);
    if (cls == kEmpty) continue;
    const uint32_t kt = sk + stage * 2 * kKVBytes, vt = kt + kKVBytes;

    // S = Q Kᵀ and dP = dO Vᵀ: s[4n + e] (and dp's) at row (e < 2 ? r0 : r1),
    // key kv0 + 8n + 2 t4 + (e & 1).
    float s[32], dp[32];
    issue_abt<HD, kBwdRows, kBwdKTile>(s, sq, wg * 64, kt);
    issue_abt<HD, kBwdRows, kBwdKTile>(dp, sdo, wg * 64, vt);
    wgmma_wait<1>();
    fence_regs(s);
    with_flags(p.softcap > 0.f, element_mask(p, cls), [&](auto cap, auto mask) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        float dfac;
        const float x = bwd_score<decltype(cap)::value>(p, cap_in, cap_inv, s[e], dfac);
        float pe = fast_exp2(fmaf(x, mul, (e & 2) ? -lse1 : -lse0));
        if constexpr (decltype(mask)::value != kNoMask) {
          const int kp = kv0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
          if (!element_in<decltype(mask)::value>(p, (e & 2) ? r1 : r0, kp)) pe = 0.f;
        }
        s[e] = pe * dfac;
      }
    });
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - ((e & 2) ? d1 : d0));
    pack_a(da, dp);
    issue_acc<kPanels>(dq, da, kt);  // dQ += dS K
    wgmma_wait<0>();
    fence_acc(dq);
    fence_frags(da);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int d = pn * 64 + 8 * n + 2 * t4;
      if (d >= HD) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= p.Sq) continue;
        const int e = 4 * n + 2 * half;
        *reinterpret_cast<uint32_t*>(t.dq + ((long long)b * p.Sq + r) * q_stride +
                                     (long long)h * HD + d) =
            pack_bf16(dq[pn][e] * p.scale, dq[pn][e + 1] * p.scale);
      }
    }
  }
}

// The dK/dV and dQ kernels at head dim HD, built one head dim a file
// (attention_bwd_<hd>.cu) so that nvcc builds them side by side; the members
// are defined out of the class, as Decode's are, so that the extern
// declarations below keep every other file from instantiating them.
template <int HD>
struct Bwd {
  static int launch(const BwdTensors& t, const Params& p, cudaStream_t stream);
};

template <int HD>
int Bwd<HD>::launch(const BwdTensors& t, const Params& p, cudaStream_t stream) {
  static_assert(dkdv_smem<HD>() <= 232448 && dq_smem<HD>() <= 232448,
                "past the H100's shared memory per block");
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(attn_bwd_dkdv_kernel<HD>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(reinterpret_cast<const void*>(attn_bwd_dq_kernel<HD>),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<HD>());
  if (e != cudaSuccess) return (int)e;
  const long long nk = (p.Skv + kBwdKeys - 1) / kBwdKeys;
  const long long nq = (p.Sq + kBwdRows - 1) / kBwdRows;
  if (nk > 0) {
    attn_bwd_dkdv_kernel<HD><<<(unsigned)((long long)p.B * p.K * nk), kDkdvThreads,
                               dkdv_smem<HD>(), stream>>>(t, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  attn_bwd_dq_kernel<HD><<<(unsigned)((long long)p.B * p.H * nq), kWgThreads, dq_smem<HD>(),
                           stream>>>(t, p);
  return (int)cudaGetLastError();
}

extern template struct Bwd<16>;
extern template struct Bwd<32>;
extern template struct Bwd<64>;
extern template struct Bwd<112>;
extern template struct Bwd<128>;

}  // namespace repro_fa
