// WKV6 forward: the RWKV-6 recurrence. Replaces the Pallas TPU kernel of
// repro/kernels/wkv6.py: wkv6_kernel (_wkv6_kernel), with its contract:
// r, k, v, lw (B, S, H, hd), u (H, hd), initial state (B, H, hd, hd) or none;
// out (B, S, H, hd) fp32 and the final state fp32. Per (b, h), with the
// state's axes [key channel c, value channel d]:
//
//   o_t[d]    = sum_c r_t[c] * (u[c] * k_t[c] * v_t[d] + S[c][d])
//   S[c][d]  <- exp(lw_t[c]) * S[c][d] + k_t[c] * v_t[d]
//
// The output reads the state before step t's update (kernels/ref.wkv6_ref).
//
// Design: the sequential form of the official RWKV-6 CUDA kernel, not the
// Pallas kernel's chunked blocking. One CTA per (b, h) with hd threads;
// thread d keeps the state column S[:, d] (hd floats) in registers for the
// whole sequence. Per step each thread stages r_t[d], k_t[d] and
// exp(lw_t[d]) in shared memory — one expf per channel per step, not hd^2 —
// and reads all hd of them back as broadcasts. The staging buffer is double
// buffered, so one __syncthreads per step suffices: step t writes buffer
// t & 1, which no thread can still be reading from step t - 2. The next
// step's inputs are loaded into registers before the current step's
// arithmetic, so global latency hides behind it. Inputs are cast to fp32 on
// load; all arithmetic is fp32 (expf, no fast-math).
//
// Bound: at the RWKV-6 1.6B training shape (8, 1024, 32, 64) with fp32
// r/k/v, the bytes (r, k, v, lw read once, out written once, the final state
// written once: 340 MB) outweigh the 5 hd^2 fp32 operations per (b, t, h),
// so the data sheet bounds it by memory. Each CTA walks 1024 dependent
// steps, so in this form serial latency, not either bound, sets the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int HD, typename T>
__global__ void __launch_bounds__(HD)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ out, float* __restrict__ sf, int S,
                int H) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int d = threadIdx.x;
  __shared__ __align__(16) float s_r[2][HD];
  __shared__ __align__(16) float s_k[2][HD];
  __shared__ __align__(16) float s_w[2][HD];
  __shared__ __align__(16) float s_u[HD];

  float st[HD];  // st[c] = S[c][d]
  const long long sbase = (long long)bh * HD * HD + d;
#pragma unroll
  for (int c = 0; c < HD; ++c) st[c] = s0 ? s0[sbase + (long long)c * HD] : 0.0f;
  s_u[d] = u[h * HD + d];  // published by step 0's barrier

  const long long step = (long long)H * HD;  // one time step in (B, S, H, hd)
  long long idx = ((long long)b * S * H + h) * HD + d;
  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (S > 0) {
    rn = to_f32(r[idx]); kn = to_f32(k[idx]); vn = to_f32(v[idx]); wn = lw[idx];
  }
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    s_r[buf][d] = rn;
    s_k[buf][d] = kn;
    s_w[buf][d] = expf(wn);
    const float vt = vn;
    const long long cur = idx;
    __syncthreads();
    if (t + 1 < S) {  // prefetch step t + 1
      idx += step;
      rn = to_f32(r[idx]); kn = to_f32(k[idx]); vn = to_f32(v[idx]); wn = lw[idx];
    }
    const float4* r4 = reinterpret_cast<const float4*>(s_r[buf]);
    const float4* k4 = reinterpret_cast<const float4*>(s_k[buf]);
    const float4* w4 = reinterpret_cast<const float4*>(s_w[buf]);
    const float4* u4 = reinterpret_cast<const float4*>(s_u);
    float y[4] = {0.f, 0.f, 0.f, 0.f};  // four partial sums: shorter chains
#pragma unroll
    for (int c4 = 0; c4 < HD / 4; ++c4) {
      const float4 rr = r4[c4], kk = k4[c4], ww = w4[c4], uu = u4[c4];
      const float rc[4] = {rr.x, rr.y, rr.z, rr.w};
      const float kc[4] = {kk.x, kk.y, kk.z, kk.w};
      const float wc[4] = {ww.x, ww.y, ww.z, ww.w};
      const float uc[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c4 * 4 + j;
        const float x = kc[j] * vt;
        const float s = st[c];
        y[j] += rc[j] * (uc[j] * x + s);
        st[c] = wc[j] * s + x;
      }
    }
    out[cur] = (y[0] + y[1]) + (y[2] + y[3]);
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) sf[sbase + (long long)c * HD] = st[c];
}

template <int HD>
cudaError_t launch(int dtype, const void* r, const void* k, const void* v,
                   const float* lw, const float* u, const float* s0,
                   float* out, float* sf, int B, int S, int H,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)(B * H));
  if (dtype == 0) {
    wkv6_fwd_kernel<HD, float><<<grid, HD, 0, stream>>>(
        (const float*)r, (const float*)k, (const float*)v, lw, u, s0, out, sf,
        S, H);
  } else {
    wkv6_fwd_kernel<HD, __nv_bfloat16><<<grid, HD, 0, stream>>>(
        (const __nv_bfloat16*)r, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, lw, u, s0, out, sf, S, H);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (r, k, v); lw, u, s0 (may be null), out and sf
// are fp32. hd must be 16, 32 or 64.
extern "C" int repro_wkv6_fwd(const void* r, const void* k, const void* v,
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
