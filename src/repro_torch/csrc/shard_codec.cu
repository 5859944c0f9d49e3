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
// Decode design: the kernel reads 1 byte of code and 4/256 bytes of scale
// per element and writes 4 bytes, so it is bound by bytes: 5.016 bytes an
// element, 0.668 ms over GPT-2's 446,208,768 fp32 state elements at
// 3.35 TB/s; 80% of them are writes. A half-warp decodes one block, each
// lane loading the block's scale once; lane `sub` owns four groups of 4
// codes, 64 bytes apart, each read as one 4-byte load and written as one
// 16-byte streaming store (__stcs), so every load of the half-warp reads 64
// consecutive codes and every store writes 256 consecutive bytes. A warp
// takes kDecodeSteps pairs of blocks, and a lane issues all its loads (16
// bytes of codes a block, and the scale) before its first store. (On an
// H100, a lane owning 16 consecutive codes, whose four 16-byte stores lie
// 64 bytes apart across the warp, ran far slower: the writes, not the
// loads, need the contiguous pattern; and more pairs of blocks a warp ran
// no faster. PERF.md has the numbers of each layout and step count, from
// tools/decode_layouts.py.) The ragged tail past a leaf's `n`
// is stored element by element; a codes pointer that is not 4-byte aligned
// is read, and an output pointer that is not 16-byte aligned written,
// element by element.
//
// One launch decodes every int8 leaf of a state (repro_shard_decode_many): a
// device table gives each leaf's codes, scales and output pointers, its `n`
// and its first block in the global block count; each warp finds its first
// block's leaf by binary search. The leaves need not share buffers.
// repro_shard_decode is the one-leaf case, its leaf passed by value.
//
// Bit-identity with the reference (optim/compression.int8_quantize):
//   scale = max(amax, 1e-12f) * (float)(1/127)   -- a multiply, not "/ 127"
//   code  = clamp(rintf(x / scale), -127, 127)    -- IEEE division, round
//                                                    half to even as jnp.round
//   value = (float)code * scale                  -- one IEEE multiply
//                                                    (optim/compression
//                                                    .int8_dequantize)
// __fdiv_rn and __fmul_rn pin both to round-to-nearest, and the multiply
// cannot contract into an FMA; the library is built without
// --use_fast_math all the same.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kPerLane = kBlock / 32;
constexpr int kWarpsPerCta = 8;
constexpr int kBlocksPerWarp = 2;
// Decode: a half-warp decodes a block; its lane `sub` owns the block's
// elements kGroupStride * g + 4 * sub + i, g < kGroups, i < 4.
constexpr int kLanesPerBlock = 16;
constexpr int kGroups = kBlock / (4 * kLanesPerBlock);
constexpr int kGroupStride = 4 * kLanesPerBlock;
constexpr int kDecodeWarps = 8;
constexpr int kDecodeSteps = 1;       // a warp decodes 2 * kDecodeSteps blocks
constexpr long long kNoLeaf = 0x7fffffffffffffffLL;

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

// One leaf of a decode: the first n values of codes * scales[:, None] go to
// out; its blocks are first, first + 1, ... of the launch. Laid out as five
// int64s, as the wrapper builds the table.
struct DecodeLeaf {
  const int8_t* codes;
  const float* scales;
  float* out;
  long long n;
  long long first;
};

__device__ __forceinline__ float decode_one(uint32_t word, int i, float scale) {
  return __fmul_rn((float)(int8_t)(uint8_t)(word >> (8 * i)), scale);
}

// The lane's codes of a block: kGroups words, kGroupStride bytes apart, from
// p = the block's codes + 4 * sub.
__device__ __forceinline__ void load_lane_codes(const int8_t* p,
                                                uint32_t (&w)[kGroups]) {
  const bool aligned = (reinterpret_cast<uintptr_t>(p) & 3) == 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int8_t* q = p + g * kGroupStride;
    if (aligned) {
      w[g] = __ldg(reinterpret_cast<const uint32_t*>(q));
    } else {
      w[g] = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) w[g] |= (uint32_t)(uint8_t)__ldg(q + i) << (8 * i);
    }
  }
}

// The lane's values of a block to dst = the block's output + 4 * sub, of
// which the first `left` (> 0) lie before the leaf's end.
__device__ __forceinline__ void store_lane(float* dst, int left,
                                           const uint32_t (&w)[kGroups],
                                           float scale) {
  const bool aligned = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = decode_one(w[g], i, scale);
    float* q = dst + g * kGroupStride;
    const int count = left - g * kGroupStride;
    if (count >= 4 && aligned) {
      __stcs(reinterpret_cast<float4*>(q), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < count) q[i] = v[i];
    }
  }
}

// table == nullptr: the one leaf `single`; else n_leaves leaves, none
// empty, in block order. nb: the blocks the launch decodes.
__global__ void __launch_bounds__(kDecodeWarps * 32)
shard_decode_kernel(const DecodeLeaf* __restrict__ table, int n_leaves,
                    DecodeLeaf single, long long nb) {
  const long long row0 =
      ((long long)blockIdx.x * kDecodeWarps + (threadIdx.x >> 5)) *
      (2 * kDecodeSteps);
  if (row0 >= nb) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int half = lane / kLanesPerBlock;  // which block of a step's two
  const int sub = lane % kLanesPerBlock;
  int li = 0;
  DecodeLeaf leaf = single;
  long long next = kNoLeaf;  // the first block of the leaf after `leaf`
  if (table != nullptr) {  // the last leaf whose first block is <= row0
    int hi = n_leaves - 1;
    while (li < hi) {
      const int mid = (li + hi + 1) >> 1;
      if (table[mid].first <= row0) li = mid; else hi = mid - 1;
    }
    leaf = table[li];
    if (li + 1 < n_leaves) next = table[li + 1].first;
  }
  uint32_t w[kDecodeSteps][kGroups];
  float scale[kDecodeSteps];
  float* dst[kDecodeSteps];
  int left[kDecodeSteps];
#pragma unroll
  for (int k = 0; k < kDecodeSteps; ++k) {  // every load before any store
    const long long row = row0 + 2 * k + half;
    left[k] = 0;
    dst[k] = nullptr;
    if (row >= nb) continue;
    while (row >= next) {  // only with a table
      leaf = table[++li];
      next = li + 1 < n_leaves ? table[li + 1].first : kNoLeaf;
    }
    const long long blk = row - leaf.first;
    const long long e0 = blk * kBlock + 4 * sub;
    if (e0 >= leaf.n) continue;  // past the last block's ragged tail
    const long long rest = leaf.n - e0;
    left[k] = rest < kBlock ? (int)rest : kBlock;
    dst[k] = leaf.out + e0;
    scale[k] = __ldg(leaf.scales + blk);
    load_lane_codes(leaf.codes + e0, w[k]);
  }
#pragma unroll
  for (int k = 0; k < kDecodeSteps; ++k)
    if (left[k] > 0) store_lane(dst[k], left[k], w[k], scale[k]);
}

cudaError_t launch_decode(const DecodeLeaf* table, int n_leaves,
                          DecodeLeaf single, long long nb,
                          cudaStream_t stream) {
  constexpr long long per_cta = (long long)kDecodeWarps * 2 * kDecodeSteps;
  const long long ctas = (nb + per_cta - 1) / per_cta;
  shard_decode_kernel<<<(unsigned)ctas, kDecodeWarps * 32, 0, stream>>>(
      table, n_leaves, single, nb);
  return cudaGetLastError();
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

// Writes the first n decoded values (n <= nb*256 for the codes' nb rows) of
// codes * scales[:, None] to out.
extern "C" int repro_shard_decode(const void* codes, const void* scales,
                                  long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  const DecodeLeaf one = {(const int8_t*)codes, (const float*)scales,
                          (float*)out, n, 0};
  return (int)launch_decode(nullptr, 0, one, (n + kBlock - 1) / kBlock,
                            (cudaStream_t)stream);
}

// table: n_leaves rows of five int64s in device memory, (pointer to the
// leaf's int8 codes, to its fp32 scales, to its n fp32 outputs, n > 0,
// index of its first block), in block order, each leaf's first block
// ceil(n/256) after the one before; nb: the blocks of all leaves.
extern "C" int repro_shard_decode_many(const void* table, int n_leaves,
                                       long long nb, void* stream) {
  if (nb <= 0 || n_leaves <= 0) return 0;
  const DecodeLeaf none = {nullptr, nullptr, nullptr, 0, 0};
  return (int)launch_decode((const DecodeLeaf*)table, n_leaves, none, nb,
                            (cudaStream_t)stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
