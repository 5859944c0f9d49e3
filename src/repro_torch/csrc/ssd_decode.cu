// SSD decode regime: a few steps of the Mamba2 scan from a carried state.
// Replaces the Pallas TPU kernel of repro/kernels/ssd.py: ssd_kernel
// (_ssd_kernel) in its decode regime, S <= kernels/ssd.DECODE_MAX_STEPS (a
// serving decode step, S = 1, from the state the last step left). Same
// contract as repro_ssd_fwd (ssd.cu): per (b, h), a_t = exp(dt_t *
// -exp(A_log[h])),
//
//   h[p][n] <- a_t * h[p][n] + (dt_t * x_t[p]) * B_t[n]
//   y_t[p]   = sum_n C_t[n] * h[p][n]      (the state after the update)
//
// Bound: at Zamba2 1.2B's decode shape (8, 1, 64, 64), N = 64, the work is
// the fp32 state, 8.4 MB read and 8.4 MB written (x, B, C, dt and y add
// 0.2 MB): 17.0 MB, 0.0051 ms at 3.35 TB/s. Its 5 P N operations per
// (b, h) are 2.7 MFLOP, nothing at 67 TFLOP/s. So the design is all about
// streaming the state once at the memory's rate:
// * no shared memory, no staging, no barrier: every thread owns one float4
//   of the state dim (n = 4q .. 4q + 3) in kRows rows of p, strided by
//   P / kRows so that neighbouring threads read neighbouring 16 bytes
//   (the N / 4 lanes of a row, then the rows). It starts all its state
//   loads (kRows float4, streaming hint) before its first FMA, together
//   with its rows' x, its float4 of B and C and dt.
// * threads are numbered over the whole (b, h, row group, lane) space in
//   CTAs of 128: a (b, h) is split across CTAs by rows of p where its rows
//   outnumber a CTA, and a CTA holds several (b, h) where they do not. At
//   the decode shape that is 512 CTAs, about four an SM, all resident in
//   one wave: 64 KB of state loads in flight per SM.
// * y's sum over n is fixed: each thread's float4 of products in order
//   (c0 h0, then + c1 h1, + c2 h2, + c3 h3 as FMAs), then the N / 4 lanes
//   of the row by an xor butterfly (offsets N / 8, ..., 1). No atomics, so
//   two runs give the same bits.
// * x, B and C are read through row strides (elements between consecutive
//   (b, t) rows), so the views that models/mamba2.block_apply splits from
//   one xbc tensor reach the kernel without a copy.
// * all fp32 on the CUDA cores (expf, no fast-math), as the fp32
//   sequential kernel computes it; state == null starts from zeros
//   without reading memory. The final state leaves before y's sums. More
//   than one step walks them in order with the state in registers, the
//   next step's inputs loaded ahead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;  // rows of p a thread owns; every P is a multiple
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive elements as fp32: one 16-byte load (fp32) or one 8-byte
// load (bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One step's inputs of a thread.
template <typename T>
struct StepIn {
  float dt;
  float4 b, c;
  float x[kRows];
};

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_decode_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A_log, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hf, int S, int H,
                  int P, long long n_threads, long long x_stride,
                  long long bc_stride) {
  constexpr int L = N / 4;  // lanes per state row
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  // Threads past the last (b, h) keep to the shuffles and touch no memory.
  const bool live = g < n_threads;
  const int q = (int)(g % L);
  const int RG = P / kRows;  // row groups of a (b, h)
  const long long rest = g / L;
  const int rg = (int)(rest % RG);
  const long long bh = live ? rest / RG : 0;
  const int b = (int)(bh / H), h = (int)(bh % H);

  // The state: rows p = rg + j RG, columns 4q .. 4q + 3, all loads first.
  float4 st[kRows];
  const long long sbase = bh * P * N + 4 * q;
  if (live && h0 != nullptr) {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      st[j] = __ldcs(reinterpret_cast<const float4*>(h0 + sbase + (long long)(rg + j * RG) * N));
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) st[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float lA = live ? -expf(A_log[h]) : 0.f;
  auto store_state = [&]() {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      __stcs(reinterpret_cast<float4*>(hf + sbase + (long long)(rg + j * RG) * N), st[j]);
  };

  auto load = [&](int t, StepIn<T>& in) {
    const long long row = (long long)b * S + t;
    in.dt = dt[row * H + h];
    in.b = load4(Bm + row * bc_stride + 4 * q);
    in.c = load4(Cm + row * bc_stride + 4 * q);
    const T* xr = x + row * x_stride + (long long)h * P + rg;
#pragma unroll
    for (int j = 0; j < kRows; ++j) in.x[j] = to_f32(xr[j * RG]);
  };
  StepIn<T> cur{}, nxt{};
  if (live && S > 0) load(0, cur);
  for (int t = 0; t < S; ++t) {
    if (live && t + 1 < S) load(t + 1, nxt);  // the next step's inputs, ahead
    const float a = expf(cur.dt * lA);
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float dx = cur.dt * cur.x[j];
      float4& s = st[j];
      s.x = fmaf(a, s.x, dx * cur.b.x);
      s.y = fmaf(a, s.y, dx * cur.b.y);
      s.z = fmaf(a, s.z, dx * cur.b.z);
      s.w = fmaf(a, s.w, dx * cur.b.w);
      float v = cur.c.x * s.x;
      v = fmaf(cur.c.y, s.y, v);
      v = fmaf(cur.c.z, s.z, v);
      acc[j] = fmaf(cur.c.w, s.w, v);
    }
    if (live && t + 1 == S) store_state();  // the final state leaves before the sums
#pragma unroll
    for (int off = L / 2; off >= 1; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], off);
    }
    if (live && q == 0) {
      float* yr = y + (((long long)b * S + t) * H + h) * P + rg;
#pragma unroll
      for (int j = 0; j < kRows; ++j) yr[j * RG] = acc[j];
    }
    cur = nxt;
  }
  if (live && S == 0) store_state();
}

template <int N, typename T>
cudaError_t launch(const void* x, const float* dt, const float* A_log,
                   const void* Bm, const void* Cm, const float* h0, float* y,
                   float* hf, int B, int S, int H, int P, long long x_stride,
                   long long bc_stride, cudaStream_t stream) {
  const long long n_threads = (long long)B * H * (P / kRows) * (N / 4);
  const long long n_ctas = (n_threads + kThreads - 1) / kThreads;
  ssd_decode_kernel<N, T><<<(unsigned)n_ctas, kThreads, 0, stream>>>(
      (const T*)x, dt, A_log, (const T*)Bm, (const T*)Cm, h0, y, hf, S, H, P,
      n_threads, x_stride, bc_stride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* A_log,
                         const void* Bm, const void* Cm, const float* h0,
                         float* y, float* hf, int B, int S, int H, int P, int N,
                         long long xs, long long bcs, cudaStream_t st) {
  switch (N) {
    case 8: return launch<8, T>(x, dt, A_log, Bm, Cm, h0, y, hf, B, S, H, P, xs, bcs, st);
    case 16: return launch<16, T>(x, dt, A_log, Bm, Cm, h0, y, hf, B, S, H, P, xs, bcs, st);
    default: return launch<64, T>(x, dt, A_log, Bm, Cm, h0, y, hf, B, S, H, P, xs, bcs, st);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (x, Bm, Cm); dt (B, S, H), A_log, h0 (may be
// null), y (B, S, H, P) and hf (B, H, P, N) are fp32 and contiguous. x's
// element (b, t, h, p) is at (b S + t) x_stride + h P + p, Bm's and Cm's
// (b, t, n) at (b S + t) bc_stride + n; the pointers of x, Bm and Cm and
// both strides (in bytes) must be multiples of 16. P must be 16, 32 or 64;
// N 8, 16 or 64.
extern "C" int repro_ssd_decode(const void* x, const void* dt, const void* A_log,
                                const void* Bm, const void* Cm, const void* h0,
                                void* y, void* hf, int dtype, int B, int S,
                                int H, int P, int N, long long x_stride,
                                long long bc_stride, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || (dtype != 0 && dtype != 1) || (P != 16 && P != 32 && P != 64) ||
      (N != 8 && N != 16 && N != 64) || x_stride < (long long)H * P ||
      bc_stride < N)
    return (int)cudaErrorInvalidValue;
  const float* dtf = (const float*)dt;
  const float* af = (const float*)A_log;
  const float* h0f = (const float*)h0;
  float* yf = (float*)y;
  float* hff = (float*)hf;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_typed<float>(x, dtf, af, Bm, Cm, h0f, yf, hff, B, S, H, P,
                                    N, x_stride, bc_stride, st);
  return (int)launch_typed<__nv_bfloat16>(x, dtf, af, Bm, Cm, h0f, yf, hff, B, S,
                                          H, P, N, x_stride, bc_stride, st);
}
