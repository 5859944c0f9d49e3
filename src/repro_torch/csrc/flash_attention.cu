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
// * bf16 (the training path): tensor cores through mma.sync.m16n8k16 with
//   fp32 accumulation. A CTA of 4 warps owns 64 query rows (16 per warp) of
//   one (b, h); the warp keeps its Q fragments, its 16x64 score tile and its
//   16xhd output accumulator in registers. K tiles (row-major) and V tiles
//   (transposed) of 64 keys are staged in shared memory with 8 elements of
//   row padding, so the 32-bit fragment loads hit distinct banks. Scores are
//   scaled after QKᵀ; P is rounded to bf16 for P·V, as the JAX XLA path
//   does. Row max and row sum are reduced across the 4 threads that share a
//   row with two shuffles.
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
// in [q_start, q_start + kBlockQ).
__device__ __forceinline__ void kv_tiles(const Params& p, int q_start,
                                         int& t_begin, int& t_end) {
  const int q_last = min(q_start + kBlockQ, p.Sq) - 1;
  int lo = 0, hi = p.Skv;
  if (p.kind != kFull) {
    const bool pre = p.kind == kPrefix && p.prefix_len > 0;
    hi = p.q_offset + q_last + 1;
    if (pre && p.q_offset + q_start < p.prefix_len) hi = max(hi, p.prefix_len);
    hi = min(max(hi, 0), p.Skv);
    if (p.window > 0 && !pre) lo = max(0, p.q_offset + q_start - p.window + 1);
  }
  t_begin = lo / kBlockK;
  t_end = (hi + kBlockK - 1) / kBlockK;
}

// Block index -> (b, h, q tile), heaviest causal tiles first.
__device__ __forceinline__ void tile_of_block(const Params& p, int& b, int& h,
                                              int& q_start) {
  const int nq = (p.Sq + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / nq;
  b = bh / p.H;
  h = bh % p.H;
  q_start = (nq - 1 - (int)(blockIdx.x % nq)) * kBlockQ;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = kBlockQ / 16;
constexpr int kMmaThreads = kMmaWarps * 32;

// D = A (16x16, row) * B (16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, Params p) {
  constexpr int kSteps = HD / 16;        // k-steps of QKᵀ
  constexpr int kDTiles = HD / 8;        // n-tiles of P·V
  constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of QKᵀ
  constexpr int kKStride = HD + 8;        // padded K row (bf16)
  constexpr int kVStride = kBlockK + 8;   // padded transposed-V row (bf16)
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt[HD * kVStride];

  int b, h, q_start;
  tile_of_block(p, b, h, q_start);
  const int kh = h / p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = q_start + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;

  // Q fragments (A operand), straight from global memory.
  uint32_t qf[kSteps][4];
  {
    const __nv_bfloat16* q0 = q + (((long long)b * p.Sq + r0) * p.H + h) * HD;
    const __nv_bfloat16* q1 = q + (((long long)b * p.Sq + r1) * p.H + h) * HD;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int d = s * 16 + tig * 2;
      qf[s][0] = r0 < p.Sq ? load_u32(q0 + d) : 0u;
      qf[s][1] = r1 < p.Sq ? load_u32(q1 + d) : 0u;
      qf[s][2] = r0 < p.Sq ? load_u32(q0 + d + 8) : 0u;
      qf[s][3] = r1 < p.Sq ? load_u32(q1 + d + 8) : 0u;
    }
  }
  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kMInit, m1 = kMInit, l0 = 0.f, l1 = 0.f;  // l: this thread's part

  int t_begin, t_end;
  kv_tiles(p, q_start, t_begin, t_end);
  const long long kv_row = (long long)p.K * HD;
  const __nv_bfloat16* kbase = k + (long long)b * p.Skv * kv_row + (long long)kh * HD;
  const __nv_bfloat16* vbase = v + (long long)b * p.Skv * kv_row + (long long)kh * HD;

  for (int t = t_begin; t < t_end; ++t) {
    const int kv0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kBlockK * (HD / 8); e += kMmaThreads) {
      const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
      const int j = kv0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (j < p.Skv) {
        kx = *reinterpret_cast<const uint4*>(kbase + j * kv_row + c);
        vx = *reinterpret_cast<const uint4*>(vbase + j * kv_row + c);
      }
      *reinterpret_cast<uint4*>(ks + r * kKStride + c) = kx;
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(c + i) * kVStride + r] = vh[i];
    }
    __syncthreads();

    // S = Q Kᵀ for this warp's 16 rows and the tile's 64 keys.
    float s[kKeyTiles][4];
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = ks + (n * 8 + g) * kKStride + tig * 2;
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        mma_bf16(s[n], qf[st], load_u32(krow + st * 16),
                 load_u32(krow + st * 16 + 8));
    }
    // Scale, softcap, mask; row maxima.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? r0 : r1;
        const int kp = kv0 + n * 8 + tig * 2 + (i & 1);
        float x = s[n][i] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (kp >= p.Skv || !admitted(p, p.q_offset + row, kp)) x = kNegInf;
        s[n][i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKeyTiles; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    // O += P V: the score accumulators of two key n-tiles are exactly the A
    // fragment of one 16-key step.
#pragma unroll
    for (int st = 0; st < kBlockK / 16; ++st) {
      const uint32_t a[4] = {pack_bf16(s[2 * st][0], s[2 * st][1]),
                             pack_bf16(s[2 * st][2], s[2 * st][3]),
                             pack_bf16(s[2 * st + 1][0], s[2 * st + 1][1]),
                             pack_bf16(s[2 * st + 1][2], s[2 * st + 1][3])};
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        const __nv_bfloat16* vrow = vt + (n * 8 + g) * kVStride + st * 16 + tig * 2;
        mma_bf16(acc[n], a, load_u32(vrow), load_u32(vrow + 8));
      }
    }
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
  for (int n = 0; n < kDTiles; ++n) {
    const int d = n * 8 + tig * 2;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(o0 + d) =
          pack_bf16(acc[n][0] / den0, acc[n][1] / den0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(o1 + d) =
          pack_bf16(acc[n][2] / den1, acc[n][3] / den1);
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

unsigned n_blocks(const Params& p) {
  return (unsigned)((long long)p.B * p.H * ((p.Sq + kBlockQ - 1) / kBlockQ));
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               const Params& p, cudaStream_t stream) {
  flash_attention_mma_kernel<HD><<<n_blocks(p), kMmaThreads, 0, stream>>>(
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
    case 1: return launch_mma<HD>(q, k, v, o, p, stream);
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
