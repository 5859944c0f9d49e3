// WKV6 decode regime: a few steps of the RWKV-6 recurrence from a carried
// state. Replaces the Pallas TPU kernel of repro/kernels/wkv6.py:
// wkv6_kernel (_wkv6_kernel) in its decode regime, S <=
// kernels/wkv6.DECODE_MAX_STEPS (a serving decode step, S = 1, from the
// state the last step left). Same contract as repro_wkv6_fwd (wkv6.cu):
// per (b, h), with the state's axes [key channel c][value channel d],
//
//   a      = sum_c r[c] * u[c] * k[c]                (the u bonus)
//   o[d]   = v[d] * a + sum_c r[c] * S[c][d]        (the state before)
//   S[c][d] <- exp(lw[c]) * S[c][d] + k[c] * v[d]
//
// Bound: at RWKV-6 1.6B's decode shape (8, 1, 32, 64) the work is the fp32
// state, 4.2 MB read and 4.2 MB written (r, k, v, lw and out add 0.3 MB):
// 8.7 MB, 0.0026 ms at 3.35 TB/s. Its 5 hd^2 operations per (b, h) are
// 2.6 MFLOP, nothing at 67 TFLOP/s. So the design streams the state once:
// * each thread owns one float4 of value columns (d = d0 .. d0 + 3) in R
//   key rows (c = rg + j RG), strided so that neighbouring threads read
//   neighbouring 16 bytes; it starts its R state loads (streaming hint)
//   before its first FMA, with its rows' r, k, lw and its columns' v; the
//   final state leaves before the output's sums, and over more than one
//   step the next step's inputs load ahead.
// * a (b, h) at hd 64 is split by value columns over two CTAs of 128
//   threads (512 CTAs at the decode shape, about four an SM, all resident:
//   32 KB of state loads in flight per SM); hd 32 takes one CTA of 128,
//   hd 16 one of 64.
// * the sum over c has one fixed order: each thread's R rows in order
//   (FMAs), then the row groups of a warp by an xor butterfly (lane
//   offsets 16, ..., CW / 4), then the warps' partials through shared
//   memory, summed in warp order by warp 0, which adds v[d] a last (an
//   FMA). Warp 0 also reduces a: lane l sums c = l, l + 32 in order, then
//   an xor butterfly (16, ..., 1). No atomics: two runs give the same bits.
// * no chunk staging: 2 x W x CW floats of shared memory (1 KB), one
//   barrier a step, nothing above 48 KB, so no attribute call.
// * fp32 throughout, expf and no fast-math, as the sequential kernel; r, k
//   and v enter as fp32 or bf16; state == null starts from zeros without
//   reading memory. More than one step walks them in order with the state
//   in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The tiling of one head dim: CW value columns a CTA, LR = CW / 4 lanes a
// key row, RGW row groups a warp, R rows a thread, RG = HD / R row groups
// and W warps a CTA.
template <int HD>
struct Tile {
  static constexpr int CW = HD == 64 ? 32 : HD;
  static constexpr int LR = CW / 4;
  static constexpr int RGW = 32 / LR;
  static constexpr int R = HD == 64 ? 4 : (HD == 32 ? 2 : 1);
  static constexpr int RG = HD / R;
  static constexpr int W = RG / RGW;
  static constexpr int NT = 32 * W;
  static constexpr int SPLIT = HD / CW;  // CTAs a (b, h)
  static_assert(RG % RGW == 0 && W >= 1 && W <= 4, "tile");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One step's inputs of a thread: its columns' v, its rows' r, k and lw,
// and (warp 0) the bonus's r and k at channels lane, lane + 32.
template <int HD>
struct StepIn {
  float4 v;
  float r[Tile<HD>::R], k[Tile<HD>::R], lw[Tile<HD>::R];
  float br[(HD + 31) / 32], bk[(HD + 31) / 32];
};

template <int HD, typename T>
__global__ void __launch_bounds__(Tile<HD>::NT)
wkv6_decode_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   float* __restrict__ out, float* __restrict__ sf, int S,
                   int H) {
  using Tl = Tile<HD>;
  constexpr int R = Tl::R, RG = Tl::RG, LR = Tl::LR, W = Tl::W;
  constexpr int kBonus = (HD + 31) / 32;
  __shared__ __align__(16) float part[2][W][Tl::CW];

  const int bh = blockIdx.x / Tl::SPLIT;
  const int half = blockIdx.x % Tl::SPLIT;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane % LR;                       // float4 of this CTA's columns
  const int rg = warp * Tl::RGW + lane / LR;     // row group
  const int d0 = half * Tl::CW + 4 * q;          // first value column

  // The state: rows c = rg + j RG, columns d0 .. d0 + 3, all loads first.
  float4 st[R];
  const long long sbase = (long long)bh * HD * HD + d0;
  if (s0 != nullptr) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      st[j] = __ldcs(reinterpret_cast<const float4*>(s0 + sbase + (long long)(rg + j * RG) * HD));
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) st[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  auto store_state = [&]() {
#pragma unroll
    for (int j = 0; j < R; ++j)
      __stcs(reinterpret_cast<float4*>(sf + sbase + (long long)(rg + j * RG) * HD), st[j]);
  };
  float ul[kBonus];
#pragma unroll
  for (int i = 0; i < kBonus; ++i) {
    const int ch = lane + 32 * i;
    ul[i] = warp == 0 && ch < HD ? u[h * HD + ch] : 0.f;
  }
  auto load = [&](int t, StepIn<HD>& in) {
    const long long base = (((long long)b * S + t) * H + h) * HD;
    in.v = load4(v + base + d0);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = rg + j * RG;
      in.r[j] = to_f32(r[base + c]);
      in.k[j] = to_f32(k[base + c]);
      in.lw[j] = lw[base + c];
    }
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < kBonus; ++i) {
        const int ch = lane + 32 * i;
        in.br[i] = ch < HD ? to_f32(r[base + ch]) : 0.f;
        in.bk[i] = ch < HD ? to_f32(k[base + ch]) : 0.f;
      }
    }
  };

  StepIn<HD> cur{}, nxt{};
  if (S > 0) load(0, cur);
  for (int t = 0; t < S; ++t) {
    if (t + 1 < S) load(t + 1, nxt);  // the next step's inputs, ahead
    const float4 vv = cur.v;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float rr = cur.r[j], kk = cur.k[j], ww = expf(cur.lw[j]);
      float4& s = st[j];
      acc.x = fmaf(rr, s.x, acc.x);
      acc.y = fmaf(rr, s.y, acc.y);
      acc.z = fmaf(rr, s.z, acc.z);
      acc.w = fmaf(rr, s.w, acc.w);
      s.x = fmaf(ww, s.x, kk * vv.x);
      s.y = fmaf(ww, s.y, kk * vv.y);
      s.z = fmaf(ww, s.z, kk * vv.z);
      s.w = fmaf(ww, s.w, kk * vv.w);
    }
    if (t + 1 == S) store_state();  // the final state leaves before the sums
#pragma unroll
    for (int off = 16; off >= LR; off >>= 1) {
      acc.x += __shfl_xor_sync(kFull, acc.x, off);
      acc.y += __shfl_xor_sync(kFull, acc.y, off);
      acc.z += __shfl_xor_sync(kFull, acc.z, off);
      acc.w += __shfl_xor_sync(kFull, acc.w, off);
    }
    float (*pb)[Tl::CW] = part[t & 1];
    if (lane < LR) *reinterpret_cast<float4*>(&pb[warp][4 * q]) = acc;
    float a = 0.f;
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < kBonus; ++i) a = fmaf(cur.br[i] * ul[i], cur.bk[i], a);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
    }
    // Every warp's partials are in; the buffer of step t - 1 (the other
    // one) was read before any thread reached this step's barrier.
    __syncthreads();
    if (warp == 0 && lane < LR) {
      float4 o = *reinterpret_cast<const float4*>(&pb[0][4 * q]);
#pragma unroll
      for (int w = 1; w < W; ++w) {
        const float4 p = *reinterpret_cast<const float4*>(&pb[w][4 * q]);
        o.x += p.x;
        o.y += p.y;
        o.z += p.z;
        o.w += p.w;
      }
      o.x = fmaf(vv.x, a, o.x);
      o.y = fmaf(vv.y, a, o.y);
      o.z = fmaf(vv.z, a, o.z);
      o.w = fmaf(vv.w, a, o.w);
      *reinterpret_cast<float4*>(out + (((long long)b * S + t) * H + h) * HD + d0) = o;
    }
    cur = nxt;
  }
  if (S == 0) store_state();
}

template <int HD, typename T>
cudaError_t launch_typed(const void* r, const void* k, const void* v,
                         const float* lw, const float* u, const float* s0,
                         float* out, float* sf, int B, int S, int H,
                         cudaStream_t stream) {
  using Tl = Tile<HD>;
  wkv6_decode_kernel<HD, T><<<(unsigned)(B * H * Tl::SPLIT), Tl::NT, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, lw, u, s0, out, sf, S, H);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* r, const void* k, const void* v,
                   const float* lw, const float* u, const float* s0,
                   float* out, float* sf, int B, int S, int H,
                   cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<HD, float>(r, k, v, lw, u, s0, out, sf, B, S, H, stream);
  return launch_typed<HD, __nv_bfloat16>(r, k, v, lw, u, s0, out, sf, B, S, H,
                                         stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (r, k, v); lw, u, s0 (may be null), out and sf
// are fp32; every array contiguous, v and out 16-byte aligned (float4 or
// 8-byte moves), s0 and sf too. hd must be 16, 32 or 64.
extern "C" int repro_wkv6_decode(const void* r, const void* k, const void* v,
                                 const void* lw, const void* u, const void* s0,
                                 void* out, void* sf, int dtype, int B, int S,
                                 int H, int hd, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const float* lwf = (const float*)lw;
  const float* uf = (const float*)u;
  const float* s0f = (const float*)s0;
  float* o = (float*)out;
  float* f = (float*)sf;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return (int)launch<16>(dtype, r, k, v, lwf, uf, s0f, o, f, B, S, H, st);
    case 32: return (int)launch<32>(dtype, r, k, v, lwf, uf, s0f, o, f, B, S, H, st);
    case 64: return (int)launch<64>(dtype, r, k, v, lwf, uf, s0f, o, f, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
