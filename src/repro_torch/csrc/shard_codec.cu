// Shard codec: per-256-element-block int8 quantisation of replicated fp32
// training state. Replaces the Pallas TPU kernels of
// repro/kernels/shard_codec.py: shard_encode_kernel (_encode_kernel) and
// shard_decode_kernel (_decode_kernel).
//
// Bound: memory. Encode reads 4 bytes and writes 1 byte per element, plus one
// 4-byte scale per block; decode reads 1 byte plus the block's scale and
// writes 4. Neither does enough arithmetic to matter.
//
// Encode design: one warp owns kBlocksPerWarp consecutive 256-element
// blocks and issues all their loads before it uses any, so two blocks'
// bytes are in flight per warp. (Over GPT-2's state on an H100, 1 and 2
// blocks a warp ran alike and 4 or 8 ran slower: the number of warps in
// flight, not the bytes each has in flight, limits it.) A
// lane owns 8 consecutive elements of a block, read as two 16-byte loads;
// the block's max-abs is a shuffle reduction and the lane's 8 codes leave
// as one 8-byte store. The kernel
// reads each leaf flat and treats the ragged tail past its `n` as zeros,
// which replaces the reference's host-side pad copy and the TPU-only divisor
// blocking; the output layout stays (nb, 256) codes + (nb,) scales. A leaf
// whose base is not 16-byte aligned, and a lane that straddles the tail,
// read element by element.
//
// One launch encodes every fp32 leaf of a training state
// (repro_shard_encode_many): a device table gives each leaf's pointer, size
// and first block in one (sum nb, 256) codes buffer, and each warp finds its
// first block's leaf by binary search over the table. A scale-out then pays
// one launch and one host dispatch, not one per leaf. repro_shard_encode is
// the one-leaf case of the same kernel, its leaf passed by value.
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
constexpr int kBlocksPerWarp = 2;
constexpr int kDecodeThreads = 256;

// One leaf of an encode: n fp32 values at x, coded as blocks first,
// first + 1, ... of the output. Laid out as three int64s, as the wrapper
// builds the table.
struct Leaf {
  const float* x;
  long long n;
  long long first;
};

// The 8 values of `lane` in local block `blk` of `leaf`, zeros past n.
__device__ __forceinline__ void load_lane(const Leaf& leaf, long long blk,
                                          int lane, float (&v)[kPerLane]) {
  const long long e0 = blk * kBlock + lane * kPerLane;
  const bool aligned = (reinterpret_cast<uintptr_t>(leaf.x) & 15) == 0;
  if (aligned && e0 + kPerLane <= leaf.n) {
    const float4* p = reinterpret_cast<const float4*>(leaf.x + e0);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      v[i] = e0 + i < leaf.n ? leaf.x[e0 + i] : 0.0f;
  }
}

// table == nullptr: the one leaf `single`; else n_leaves leaves, none
// empty, in block order.
__global__ void __launch_bounds__(kWarpsPerCta * 32)
shard_encode_kernel(const Leaf* __restrict__ table, int n_leaves, Leaf single,
                    long long nb, int8_t* __restrict__ codes,
                    float* __restrict__ scales) {
  const long long row0 =
      ((long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5)) *
      kBlocksPerWarp;
  const int lane = threadIdx.x & 31;
  if (row0 >= nb) return;  // whole warps leave together
  int li = 0;
  Leaf leaf = single;
  if (table != nullptr) {  // the last leaf whose first block is <= row0
    int hi = n_leaves - 1;
    while (li < hi) {
      const int mid = (li + hi + 1) >> 1;
      if (table[mid].first <= row0) li = mid; else hi = mid - 1;
    }
    leaf = table[li];
  }
  float v[kBlocksPerWarp][kPerLane];
#pragma unroll
  for (int b = 0; b < kBlocksPerWarp; ++b) {
    const long long row = row0 + b;
    if (table != nullptr)
      while (li + 1 < n_leaves && row >= table[li + 1].first) leaf = table[++li];
    if (row < nb) {
      load_lane(leaf, row - leaf.first, lane, v[b]);
    } else {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) v[b][i] = 0.0f;
    }
  }
#pragma unroll
  for (int b = 0; b < kBlocksPerWarp; ++b) {
    const long long row = row0 + b;
    if (row >= nb) break;  // uniform across the warp
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) amax = fmaxf(amax, fabsf(v[b][i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = fmaxf(amax, 1e-12f) * (float)(1.0 / 127.0);
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      float c = rintf(__fdiv_rn(v[b][i], scale));
      c = fminf(fmaxf(c, -127.0f), 127.0f);
      word[i / 4] |= (uint32_t)(uint8_t)(int8_t)(int)c << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(codes + row * kBlock + lane * kPerLane) =
        make_uint2(word[0], word[1]);
    if (lane == 0) scales[row] = scale;
  }
}

cudaError_t launch_encode(const Leaf* table, int n_leaves, Leaf single,
                          long long nb, void* codes, void* scales,
                          cudaStream_t stream) {
  constexpr long long per_cta = (long long)kWarpsPerCta * kBlocksPerWarp;
  const long long ctas = (nb + per_cta - 1) / per_cta;
  shard_encode_kernel<<<(unsigned)ctas, kWarpsPerCta * 32, 0, stream>>>(
      table, n_leaves, single, nb, (int8_t*)codes, (float*)scales);
  return cudaGetLastError();
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
  const Leaf one = {(const float*)x, n, 0};
  return (int)launch_encode(nullptr, 0, one, nb, codes, scales,
                            (cudaStream_t)stream);
}

// table: n_leaves rows of three int64s in device memory, (pointer to the
// leaf's n fp32 values, n > 0, index of its first block), in block order;
// nb: the blocks of all leaves. codes: nb*256 int8; scales: nb fp32.
extern "C" int repro_shard_encode_many(const void* table, int n_leaves,
                                       long long nb, void* codes,
                                       void* scales, void* stream) {
  if (nb <= 0 || n_leaves <= 0) return 0;
  const Leaf none = {nullptr, 0, 0};
  return (int)launch_encode((const Leaf*)table, n_leaves, none, nb, codes,
                            scales, (cudaStream_t)stream);
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
