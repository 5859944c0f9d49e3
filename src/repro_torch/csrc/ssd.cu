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
// the opposite order to WKV6.
//
// Design: a sequential scan, not the Pallas kernel's chunked blocking. One
// CTA per (b, h) with P threads; thread p keeps h[p][0:N] in registers for
// the whole sequence. Per step the CTA stages B_t and C_t (N values each,
// read at (b, t): the per-head copies that the JAX wrapper broadcasts are
// never built) in shared memory and every thread reads them back as
// broadcasts. The staging buffer is double buffered, so one __syncthreads
// per step suffices; the next step's inputs are loaded into registers before
// the current step's arithmetic. Inputs are cast to fp32 on load; all
// arithmetic is fp32 (expf, no fast-math).
//
// Bound: at the Zamba2 1.2B training shape (8, 1024, 64, 64), N = 64, bf16
// x/B/C, the 5 P*N fp32 operations per (b, t, h) (10.7 GFLOP) outweigh the
// bytes (x read, y written, dt/B/C read, the final state written: 213 MB),
// so the data sheet bounds it by fp32 operations. Each CTA walks 1024
// dependent steps, so in this form serial latency sets the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <int N>
cudaError_t launch(int dtype, const void* x, const float* dt,
                   const float* A_log, const void* Bm, const void* Cm,
                   const float* h0, float* y, float* hf, int B, int S, int H,
                   int P, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * H));
  if (dtype == 0) {
    ssd_fwd_kernel<N, float><<<grid, P, 0, stream>>>(
        (const float*)x, dt, A_log, (const float*)Bm, (const float*)Cm, h0, y,
        hf, S, H, P);
  } else {
    ssd_fwd_kernel<N, __nv_bfloat16><<<grid, P, 0, stream>>>(
        (const __nv_bfloat16*)x, dt, A_log, (const __nv_bfloat16*)Bm,
        (const __nv_bfloat16*)Cm, h0, y, hf, S, H, P);
  }
  return cudaGetLastError();
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
