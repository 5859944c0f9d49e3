// SSD forward: the Mamba2 state-space scan. Replaces the Pallas TPU kernel
// of repro/kernels/ssd.py: ssd_kernel (_ssd_kernel), with its contract:
// x (B, S, H, P), dt (B, S, H) > 0, A_log (H,), Bm and Cm (B, S, N) shared
// by every head, initial state (B, H, P, N) or none; y (B, S, H, P) fp32 and
// the final state fp32. Per (b, h), with a_t = exp(dt_t * -exp(A_log[h])):
//
//   h[p][n] <- a_t * h[p][n] + dt_t * x_t[p] * B_t[n]
//   y_t[p]   = sum_n C_t[n] * h[p][n]
//
// The output reads the state after step t's update (kernels/ref.ssd_ref),
// the opposite order to WKV6. B and C are read at (b, t): the per-head
// copies that the JAX wrapper broadcasts are never built (L2 serves the
// 64 heads that share them). Every launch computes the whole sequence.
//
// Two kernels, one per input type:
//
// * bf16 (the training path): the Pallas kernel's chunked form on tensor
//   cores, with its own chunk L = 64 (the wrapper's `chunk` is ignored).
//   One CTA of 4 warps per (b, h) walks the S/L chunks in order; x, B, C
//   and dt of chunk c+1 load by cp.async while chunk c computes, and a
//   ragged last chunk is zero-filled (dt = 0 leaves the state unchanged, as
//   the plain version's padding does). Per chunk, with Lc the inclusive
//   cumulative sum of dt * -exp(A_log[h]) (a warp scan):
//     S   = C Bᵀ                                   (L x L, depth N)
//     M   = S ⊙ exp(min(Lc_t - Lc_j, 0)) ⊙ dt_j, j <= t
//     y   = M X + exp(Lc_t) · C hᵀ
//     h  <- exp(L_last) h + (X ⊙ w)ᵀ B,  w = exp(L_last - Lc) ⊙ dt
//   All four are mma.sync.m16n8k16 bf16 products with fp32 sums; warp w
//   owns rows 16w..16w+15 of the chunk (of h, for the state update). The
//   bf16 inputs x, B and C enter as they are (exact); their fragments come
//   by 32-bit loads or ldmatrix(.trans), and C hᵀ reuses C Bᵀ's. The three
//   operands the kernel computes — M, the operand copy of h, X ⊙ w — are
//   split as bf16 hi + lo over two products, which carries them to about
//   2^-18 relative: rounded once to bf16 they leave _rec_tol(bf16) = 2e-2
//   (tests/test_torch_ssd.py emulates both), and M rounded once to TF32
//   left it on a few of the Zamba2 path's 50M outputs. The state stays in
//   fp32 registers for the whole sequence; only its operand copy in shared
//   memory is split. Decays are kept in log2 units and dt_j joins the
//   exponent as log2 dt_j, so each element of M costs one add, one
//   ex2.approx and one multiply (about 2^-22 relative, far inside
//   _rec_tol). N = 8 is padded to the mma depth 16 with zeros in shared
//   memory. Shared rows are padded so that every fragment load hits 32
//   distinct banks.
// * fp32 (the parity sweeps, held to 1e-3/1e-4): a sequential scan. One
//   CTA per (b, h) with P threads; thread p keeps h[p][0:N] in registers;
//   each step's B_t, C_t are staged in shared memory (double buffered, one
//   __syncthreads per step). All arithmetic fp32 (expf, no fast-math).
//
// Bound: at the Zamba2 1.2B training shape (8, 1024, 64, 64), N = 64, bf16
// x/B/C, the bytes (x read, y written in fp32, dt/B/C read, the final state
// written: 214 MB) give 0.064 ms at 3.35 TB/s; the chunked form's tensor-
// core operations take a fifth of that, so the bf16 kernel is bound by
// bytes, most of them the fp32 y.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }

constexpr int kMinThreads = 16;  // the smallest P

template <int N, typename T>
__global__ void __launch_bounds__(64)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A_log, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ hf, int S, int H,
               int P) {
  constexpr int kPer = (N + kMinThreads - 1) / kMinThreads;  // B/C per thread
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int p = threadIdx.x;
  __shared__ __align__(16) float s_b[2][N];
  __shared__ __align__(16) float s_c[2][N];

  float hs[N];
  const long long sbase = ((long long)bh * P + p) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) hs[n] = h0 ? h0[sbase + n] : 0.0f;
  const float lA = -expf(A_log[h]);

  // Element (b, t) of x/y is at ((b*S + t)*H + h)*P + p, of dt at
  // (b*S + t)*H + h, of Bm/Cm at (b*S + t)*N + n.
  long long bt = (long long)b * S;
  float xn = 0.f, dtn = 0.f, bn[kPer], cn[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) bn[j] = cn[j] = 0.f;
  auto load = [&](long long row) {
    xn = to_f32(x[(row * H + h) * P + p]);
    dtn = dt[row * H + h];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = p + j * P;
      if (n < N) {
        bn[j] = to_f32(Bm[row * N + n]);
        cn[j] = to_f32(Cm[row * N + n]);
      }
    }
  };
  if (S > 0) load(bt);
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = p + j * P;
      if (n < N) {
        s_b[buf][n] = bn[j];
        s_c[buf][n] = cn[j];
      }
    }
    const float xt = xn, dtt = dtn;
    const long long row = bt + t;
    __syncthreads();
    if (t + 1 < S) load(row + 1);  // prefetch step t + 1
    const float a = expf(dtt * lA);
    const float dx = dtt * xt;
    const float4* b4 = reinterpret_cast<const float4*>(s_b[buf]);
    const float4* c4 = reinterpret_cast<const float4*>(s_c[buf]);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four partial sums: shorter chains
#pragma unroll
    for (int n4 = 0; n4 < N / 4; ++n4) {
      const float4 bb = b4[n4], cc = c4[n4];
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
      const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n4 * 4 + j;
        hs[n] = a * hs[n] + dx * bv[j];
        acc[j] += cv[j] * hs[n];
      }
    }
    y[(row * H + h) * P + p] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) hf[sbase + n] = hs[n];
}

// ---------------------------------------------------------------------------
// bf16: the chunked form on tensor cores.
// ---------------------------------------------------------------------------

constexpr int kL = 64;               // the kernel's chunk
constexpr int kChunkThreads = 128;   // 4 warps; warp w owns rows 16w..16w+15
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 (or 4) bytes; zero-filled when !valid (src is then unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// 2^x and log2(x) in one MUFU instruction each (about 2^-22 relative).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 tiles, transposed on the way: lane l names row l % 8 of
// tile l / 8 and receives, in register i, rows 2 (l % 4) and 2 (l % 4) + 1
// of column l / 4 of tile i — a B fragment of a row-major K x N operand,
// or an A fragment of the transpose of a row-major K x M one.
__device__ __forceinline__ void ldmatrix_t(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float low_of(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float high_of(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// (x0, x1) as two bf16 pairs, hi + lo, whose sum carries each value to
// about 2^-18 relative (one bf16 keeps 2^-9, TF32 2^-11).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - low_of(hi), x1 - high_of(hi));
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

// Shared memory of one CTA. Row strides are padded so that each fragment
// load of a warp touches 32 distinct banks.
template <int P, int NP>
struct __align__(16) ChunkSmem {
  static constexpr int XS = P + 8;   // bf16 row stride of x
  static constexpr int BS = NP + 8;  // bf16 row stride of B and C
  static constexpr int HS = NP + 8;  // bf16 row stride of the state copy
  __nv_bfloat16 x[2][kL * XS];       // double buffered: chunk c and c + 1
  __nv_bfloat16 b[2][kL * BS];
  __nv_bfloat16 c[2][kL * BS];
  float dt[2][kL];
  float g[4][kL];                    // each warp's log2(dt_j) - Lc_j·log2(e)
  __nv_bfloat16 h_hi[P * HS];        // the state's operand copy, as
  __nv_bfloat16 h_lo[P * HS];        // bf16 hi + lo
};

template <int P, int N>
__global__ void __launch_bounds__(kChunkThreads, 3)
ssd_chunked_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dt,
                   const float* __restrict__ A_log,
                   const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm,
                   const float* __restrict__ h0, float* __restrict__ y,
                   float* __restrict__ hf, int S, int H) {
  constexpr int NP = N < 16 ? 16 : N;  // the state dim, padded to the mma depth
  constexpr int kPT = P / 8;           // n-tiles over p
  constexpr int kNT = NP / 8;          // n-tiles over the state dim
  using Sm = ChunkSmem<P, NP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // The log-decays in log2 units: every exponential below is one exp2.
  const float lA2 = -expf(A_log[h]) * 1.4426950408889634f;
  const int n_chunks = (S + kL - 1) / kL;

  // Zero everything once: the padding columns of B and C (N = 8) are never
  // written again.
  for (int e = tid; e < (int)(sizeof(Sm) / 16); e += kChunkThreads)
    reinterpret_cast<uint4*>(smem_raw)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  auto load_chunk = [&](int ci, int buf) {
    const int t0 = ci * kL;
    for (int e = tid; e < kL * (P / 8); e += kChunkThreads) {
      const int r = e / (P / 8), q = e % (P / 8);
      const bool ok = t0 + r < S;
      const long long row = (long long)b * S + (ok ? t0 + r : 0);
      cp_async16(&sm.x[buf][r * Sm::XS + q * 8], x + (row * H + h) * P + q * 8, ok);
    }
    for (int e = tid; e < kL * (N / 8); e += kChunkThreads) {
      const int r = e / (N / 8), q = e % (N / 8);
      const bool ok = t0 + r < S;
      const long long row = (long long)b * S + (ok ? t0 + r : 0);
      cp_async16(&sm.b[buf][r * Sm::BS + q * 8], Bm + row * N + q * 8, ok);
      cp_async16(&sm.c[buf][r * Sm::BS + q * 8], Cm + row * N + q * 8, ok);
    }
    if (tid < kL) {
      const bool ok = t0 + tid < S;
      const long long row = (long long)b * S + (ok ? t0 + tid : 0);
      cp_async4(&sm.dt[buf][tid], dt + row * H + h, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // The state: warp w < P/16 owns rows p = 16w + g and 16w + g + 8, in the
  // mma accumulator layout (n-tile i: columns 8i + 2 t4, + 1).
  const int pr = 16 * warp + g;
  float hacc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int p = pr + (v >> 1) * 8, n = i * 8 + 2 * t4 + (v & 1);
      hacc[i][v] = (warp < P / 16 && h0 && n < N)
                       ? h0[((long long)bh * P + p) * N + n] : 0.f;
    }
  }
  // The operand copy of this warp's rows of the state, as bf16 hi + lo.
  auto store_state = [&]() {
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int at = pr * Sm::HS + i * 8 + 2 * t4;
      uint32_t hi, lo;
      split_bf16(hacc[i][0], hacc[i][1], hi, lo);
      *reinterpret_cast<uint32_t*>(sm.h_hi + at) = hi;
      *reinterpret_cast<uint32_t*>(sm.h_lo + at) = lo;
      split_bf16(hacc[i][2], hacc[i][3], hi, lo);
      *reinterpret_cast<uint32_t*>(sm.h_hi + at + 8 * Sm::HS) = hi;
      *reinterpret_cast<uint32_t*>(sm.h_lo + at + 8 * Sm::HS) = lo;
    }
  };
  if (warp < P / 16) store_state();
  // ldmatrix_t: the row this lane names, in tile lane / 8 of four.
  const int ld_tile = lane >> 3, ld_row = lane & 7;

  if (n_chunks > 0) load_chunk(0, 0);
  const int tr = 16 * warp + g;  // this thread's chunk rows: tr, tr + 8
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // (A) chunk ci has landed; chunk ci-1 is consumed and its state copy
    // written.
    __syncthreads();
    if (ci + 1 < n_chunks) load_chunk(ci + 1, buf ^ 1);

    const __nv_bfloat16* xs = sm.x[buf];
    const __nv_bfloat16* bs = sm.b[buf];
    const __nv_bfloat16* cs = sm.c[buf];
    const float* dts = sm.dt[buf];

    // Lc, the inclusive cumulative log-decay (log2 units): lane holds steps
    // 2 lane and 2 lane + 1 (lc0, lc1); a warp scan over the pairs.
    const float dt0 = dts[2 * lane], dt1 = dts[2 * lane + 1];
    float lc0, lc1;
    {
      const float l0 = dt0 * lA2, l1 = dt1 * lA2;
      float run = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, run, off);
        if (lane >= off) run += o;
      }
      lc0 = run - l1;
      lc1 = run;
    }
    const float l_last = __shfl_sync(kFull, lc1, 31);
    // dt_j joins the exponent: exp(Lc_t - Lc_j) dt_j = 2^(Lc_t + g_j). A
    // zero-filled step (dt = 0) gives g = -inf and a factor of 0.
    float* gw = sm.g[warp];
    gw[2 * lane] = fast_log2(dt0) - lc0;
    gw[2 * lane + 1] = fast_log2(dt1) - lc1;
    __syncwarp();
    // Lc at this thread's rows tr and tr + 8 (same parity), from their lanes.
    float lct0, lct1;
    {
      const float a0 = __shfl_sync(kFull, lc0, tr >> 1), b0 = __shfl_sync(kFull, lc1, tr >> 1);
      const float a1 = __shfl_sync(kFull, lc0, (tr >> 1) + 4);
      const float b1 = __shfl_sync(kFull, lc1, (tr >> 1) + 4);
      lct0 = (tr & 1) ? b0 : a0;
      lct1 = (tr & 1) ? b1 : a1;
    }

    // S = C Bᵀ for rows tr, tr + 8 and the key tiles j <= 16 warp + 15.
    uint32_t ca[NP / 16][4];
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks) {
      const __nv_bfloat16* c0 = cs + tr * Sm::BS + ks * 16 + 2 * t4;
      ca[ks][0] = ld_u32(c0);
      ca[ks][1] = ld_u32(c0 + 8 * Sm::BS);
      ca[ks][2] = ld_u32(c0 + 8);
      ca[ks][3] = ld_u32(c0 + 8 * Sm::BS + 8);
    }
    float sacc[8][4];
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      sacc[jt][0] = sacc[jt][1] = sacc[jt][2] = sacc[jt][3] = 0.f;
      if (jt <= 2 * warp + 1) {
#pragma unroll
        for (int ks = 0; ks < NP / 16; ++ks) {
          const __nv_bfloat16* b0 = bs + (jt * 8 + g) * Sm::BS + ks * 16 + 2 * t4;
          mma_bf16(sacc[jt], ca[ks], ld_u32(b0), ld_u32(b0 + 8));
        }
      }
    }
    // M = S ⊙ exp(Lc_t - Lc_j) ⊙ dt_j (j <= t, where Lc_t - Lc_j <= 0),
    // in place.
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const float2 gj = jt <= 2 * warp + 1
          ? *reinterpret_cast<const float2*>(gw + jt * 8 + 2 * t4)
          : make_float2(0.f, 0.f);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int t = tr + (v >> 1) * 8, j = jt * 8 + 2 * t4 + (v & 1);
        float m = 0.f;
        if (jt <= 2 * warp + 1 && j <= t)
          m = sacc[jt][v] * fast_exp2((v < 2 ? lct0 : lct1) + ((v & 1) ? gj.y : gj.x));
        sacc[jt][v] = m;
      }
    }
    // y = M X. M, split as bf16 hi + lo, is the A operand straight from
    // the accumulators (n-tiles 2kk, 2kk + 1 are k-step kk); X's B
    // fragments come by ldmatrix.trans.
    float yacc[kPT][4];
#pragma unroll
    for (int pn = 0; pn < kPT; ++pn)
      yacc[pn][0] = yacc[pn][1] = yacc[pn][2] = yacc[pn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) continue;
      uint32_t ah[4], al[4];
      split_bf16(sacc[2 * kk][0], sacc[2 * kk][1], ah[0], al[0]);
      split_bf16(sacc[2 * kk][2], sacc[2 * kk][3], ah[1], al[1]);
      split_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int pn = 0; pn < kPT; pn += 2) {
        uint32_t bx[4];  // tiles (j, p), (j + 8, p), (j, p + 8), (j + 8, p + 8)
        ldmatrix_t(bx, xs + (kk * 16 + (ld_tile & 1) * 8 + ld_row) * Sm::XS +
                           pn * 8 + (ld_tile >> 1) * 8);
        mma_bf16(yacc[pn], ah, bx[0], bx[1]);
        mma_bf16(yacc[pn], al, bx[0], bx[1]);
        mma_bf16(yacc[pn + 1], ah, bx[2], bx[3]);
        mma_bf16(yacc[pn + 1], al, bx[2], bx[3]);
      }
    }
    // C hᵀ against the state copy (hi and lo), with C Bᵀ's A fragments.
    float cacc[kPT][4];
#pragma unroll
    for (int pn = 0; pn < kPT; ++pn)
      cacc[pn][0] = cacc[pn][1] = cacc[pn][2] = cacc[pn][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks) {
#pragma unroll
      for (int pn = 0; pn < kPT; ++pn) {
        const int at = (pn * 8 + g) * Sm::HS + ks * 16 + 2 * t4;
        mma_bf16(cacc[pn], ca[ks], ld_u32(sm.h_hi + at), ld_u32(sm.h_hi + at + 8));
        mma_bf16(cacc[pn], ca[ks], ld_u32(sm.h_lo + at), ld_u32(sm.h_lo + at + 8));
      }
    }
    // y_t = (M X)_t + exp(Lc_t) (C hᵀ)_t, rows inside the sequence only.
    {
      const float e0 = fast_exp2(lct0), e1 = fast_exp2(lct1);
      const int t0 = ci * kL + tr, t1 = t0 + 8;
      float* y0 = y + (((long long)b * S + t0) * H + h) * P + 2 * t4;
      float* y1 = y + (((long long)b * S + t1) * H + h) * P + 2 * t4;
#pragma unroll
      for (int pn = 0; pn < kPT; ++pn) {
        if (t0 < S)
          *reinterpret_cast<float2*>(y0 + pn * 8) =
              make_float2(yacc[pn][0] + e0 * cacc[pn][0],
                          yacc[pn][1] + e0 * cacc[pn][1]);
        if (t1 < S)
          *reinterpret_cast<float2*>(y1 + pn * 8) =
              make_float2(yacc[pn][2] + e1 * cacc[pn][2],
                          yacc[pn][3] + e1 * cacc[pn][3]);
      }
    }
    // (B) every read of the state copy is done.
    __syncthreads();

    // h <- exp(L_last) h + (X ⊙ w)ᵀ B, then its operand copy: X's A
    // fragments come transposed by ldmatrix, are scaled by w and split as
    // bf16 hi + lo; B stays exact.
    if (warp < P / 16) {
      const float a_last = fast_exp2(l_last);
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        hacc[i][0] *= a_last;
        hacc[i][1] *= a_last;
        hacc[i][2] *= a_last;
        hacc[i][3] *= a_last;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t xa[4];  // tiles (j, p), (j, p + 8), (j + 8, p), (j + 8, p + 8)
        ldmatrix_t(xa, xs + (kk * 16 + (ld_tile >> 1) * 8 + ld_row) * Sm::XS +
                           16 * warp + (ld_tile & 1) * 8);
        // w_j = exp(L_last - Lc_j) dt_j = 2^(L_last + g_j)
        const float2 g0 = *reinterpret_cast<const float2*>(gw + kk * 16 + 2 * t4);
        const float2 g1 = *reinterpret_cast<const float2*>(gw + kk * 16 + 8 + 2 * t4);
        const float2 w0 = make_float2(fast_exp2(l_last + g0.x), fast_exp2(l_last + g0.y));
        const float2 w1 = make_float2(fast_exp2(l_last + g1.x), fast_exp2(l_last + g1.y));
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 wr = r < 2 ? w0 : w1;
          split_bf16(low_of(xa[r]) * wr.x, high_of(xa[r]) * wr.y, ah[r], al[r]);
        }
#pragma unroll
        for (int ni = 0; ni < kNT; ni += 2) {
          uint32_t bb[4];  // tiles (j, n), (j + 8, n), (j, n + 8), (j + 8, n + 8)
          ldmatrix_t(bb, bs + (kk * 16 + (ld_tile & 1) * 8 + ld_row) * Sm::BS +
                             ni * 8 + (ld_tile >> 1) * 8);
          mma_bf16(hacc[ni], ah, bb[0], bb[1]);
          mma_bf16(hacc[ni], al, bb[0], bb[1]);
          mma_bf16(hacc[ni + 1], ah, bb[2], bb[3]);
          mma_bf16(hacc[ni + 1], al, bb[2], bb[3]);
        }
      }
      store_state();
    }
  }

  if (warp < P / 16) {
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int p = pr + (v >> 1) * 8, n = i * 8 + 2 * t4 + (v & 1);
        if (n < N) hf[((long long)bh * P + p) * N + n] = hacc[i][v];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int P, int N>
cudaError_t launch_chunked(const void* x, const float* dt, const float* A_log,
                           const void* Bm, const void* Cm, const float* h0,
                           float* y, float* hf, int B, int S, int H,
                           cudaStream_t stream) {
  constexpr int kSmem = (int)sizeof(ChunkSmem<P, (N < 16 ? 16 : N)>);
  if (kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(ssd_chunked_kernel<P, N>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
  }
  ssd_chunked_kernel<P, N><<<(unsigned)(B * H), kChunkThreads, kSmem, stream>>>(
      (const __nv_bfloat16*)x, dt, A_log, (const __nv_bfloat16*)Bm,
      (const __nv_bfloat16*)Cm, h0, y, hf, S, H);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(int dtype, const void* x, const float* dt,
                   const float* A_log, const void* Bm, const void* Cm,
                   const float* h0, float* y, float* hf, int B, int S, int H,
                   int P, cudaStream_t stream) {
  if (dtype == 0) {
    ssd_fwd_kernel<N, float><<<(unsigned)(B * H), P, 0, stream>>>(
        (const float*)x, dt, A_log, (const float*)Bm, (const float*)Cm, h0, y,
        hf, S, H, P);
    return cudaGetLastError();
  }
  switch (P) {
    case 16: return launch_chunked<16, N>(x, dt, A_log, Bm, Cm, h0, y, hf, B, S, H, stream);
    case 32: return launch_chunked<32, N>(x, dt, A_log, Bm, Cm, h0, y, hf, B, S, H, stream);
    default: return launch_chunked<64, N>(x, dt, A_log, Bm, Cm, h0, y, hf, B, S, H, stream);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, Bm, Cm); dt, A_log, h0 (may be null), y and
// hf are fp32. P must be 16, 32 or 64; N 8, 16 or 64.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A_log,
                             const void* Bm, const void* Cm, const void* h0,
                             void* y, void* hf, int dtype, int B, int S, int H,
                             int P, int N, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || (dtype != 0 && dtype != 1) ||
      (P != 16 && P != 32 && P != 64))
    return (int)cudaErrorInvalidValue;
  const float* dtf = (const float*)dt;
  const float* af = (const float*)A_log;
  const float* h0f = (const float*)h0;
  float* yf = (float*)y;
  float* hff = (float*)hf;
  cudaStream_t st = (cudaStream_t)stream;
  switch (N) {
    case 8: return (int)launch<8>(dtype, x, dtf, af, Bm, Cm, h0f, yf, hff, B, S, H, P, st);
    case 16: return (int)launch<16>(dtype, x, dtf, af, Bm, Cm, h0f, yf, hff, B, S, H, P, st);
    case 64: return (int)launch<64>(dtype, x, dtf, af, Bm, Cm, h0f, yf, hff, B, S, H, P, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
