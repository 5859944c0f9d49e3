// Shard codec: per-256-element-block int8 quantisation of replicated fp32
// training state. Replaces the Pallas TPU kernels of
// repro/kernels/shard_codec.py: shard_encode_kernel (_encode_kernel) and
// shard_decode_kernel (_decode_kernel).
//
// Bound: memory. Encode reads 4 bytes and writes 1 byte per element, plus one
// 4-byte scale per block; decode reads 1 byte plus the block's scale and
// writes 4. Neither does enough arithmetic to matter.
//
// Design: one warp owns one 256-element block, 8 elements per lane, so the
// block is read from device memory once, stays in registers, and its max-abs
// is a shuffle reduction. Neighbouring lanes touch neighbouring addresses.
// The kernel reads the leaf flat and treats the ragged tail past `n` as
// zeros, which replaces the reference's host-side pad copy and the TPU-only
// divisor blocking; the output layout stays (nb, 256) codes + (nb,) scales.
//
// Bit-identity with the reference (optim/compression.int8_quantize):
//   scale = max(amax, 1e-12f) * (float)(1/127)   -- a multiply, not "/ 127"
//   code  = clamp(rintf(x / scale), -127, 127)    -- IEEE division, round
//                                                    half to even as jnp.round
// __fdiv_rn pins the division to round-to-nearest whatever the flags; the
// library is built without --use_fast_math all the same.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kPerLane = kBlock / 32;
constexpr int kWarpsPerCta = 8;
constexpr int kDecodeThreads = 256;

__global__ void __launch_bounds__(kWarpsPerCta * 32)
shard_encode_kernel(const float* __restrict__ x, long long n,
                    int8_t* __restrict__ codes, float* __restrict__ scales,
                    long long nb) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nb) return;  // whole warps leave together
  const long long base = row * kBlock;
  float v[kPerLane];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const long long idx = base + i * 32 + lane;
    v[i] = idx < n ? x[idx] : 0.0f;
    amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-12f) * (float)(1.0 / 127.0);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    float c = rintf(__fdiv_rn(v[i], scale));
    c = fminf(fmaxf(c, -127.0f), 127.0f);
    codes[base + i * 32 + lane] = (int8_t)c;
  }
  if (lane == 0) scales[row] = scale;
}

__global__ void __launch_bounds__(kDecodeThreads)
shard_decode_kernel(const int8_t* __restrict__ codes,
                    const float* __restrict__ scales, long long n,
                    float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = (float)codes[i] * scales[i / kBlock];
}

}  // namespace

// x: n fp32 values; codes: nb*256 int8; scales: nb fp32; nb = ceil(n/256).
extern "C" int repro_shard_encode(const void* x, long long n, void* codes,
                                  void* scales, long long nb, void* stream) {
  if (nb <= 0) return 0;
  const long long ctas = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  shard_encode_kernel<<<(unsigned)ctas, kWarpsPerCta * 32, 0,
                        (cudaStream_t)stream>>>(
      (const float*)x, n, (int8_t*)codes, (float*)scales, nb);
  return (int)cudaGetLastError();
}

// Writes the first n decoded values (n <= nb*256) of codes * scales[:, None].
extern "C" int repro_shard_decode(const void* codes, const void* scales,
                                  long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  long long ctas = (n + kDecodeThreads - 1) / kDecodeThreads;
  if (ctas > 1048576) ctas = 1048576;  // grid-stride loop covers the rest
  shard_decode_kernel<<<(unsigned)ctas, kDecodeThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const float*)scales, n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
