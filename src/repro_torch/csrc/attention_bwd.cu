// Flash attention backward: the prep kernel and the C entry. The design notes
// and the dK/dV and dQ kernels are in attention_bwd.cuh, instantiated one
// head dim a file (attention_bwd_<hd>.cu).
#include "attention_bwd.cuh"

namespace {

using namespace repro_fa;

// D = rowsum(dO ∘ O) in fp32, written (B, H, Sq). A row of the (B, Sq, H, hd)
// tensors is read by kLanes lanes, 16 bytes each (the head dim's 8-element
// pieces, the lanes past them idle), so a warp reads 32 / kLanes rows; the
// lanes' sums meet in a butterfly, in a fixed order.
template <int HD>
__global__ void __launch_bounds__(kPrepWarps * 32)
attn_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                     int B, int Sq, int H) {
  constexpr int kPieces = HD / 8;
  constexpr int kLanes = kPieces <= 2 ? 2 : kPieces <= 4 ? 4 : kPieces <= 8 ? 8 : 16;
  const int lane = threadIdx.x & 31, j = lane % kLanes;
  const long long row = ((long long)blockIdx.x * kPrepWarps + (threadIdx.x >> 5)) *
                            (32 / kLanes) + lane / kLanes;
  const bool live = row < (long long)B * Sq * H;
  float acc = 0.f;
  if (live && j < kPieces) {
    const uint4 a = reinterpret_cast<const uint4*>(o + row * HD)[j];
    const uint4 c = reinterpret_cast<const uint4*>(dout + row * HD)[j];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(c2[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && j == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;  // b·Sq + s
    const long long b = bs / Sq, s = bs % Sq;
    delta[(b * H + h) * Sq + s] = acc;
  }
}

template <int HD>
int launch_bwd(const BwdTensors& t, const Params& p, cudaStream_t st) {
  constexpr int kPieces = HD / 8;
  constexpr int kRowsPerBlock = kPrepWarps * (32 / (kPieces <= 2 ? 2 : kPieces <= 4 ? 4
                                                    : kPieces <= 8 ? 8 : 16));
  const long long rows = (long long)p.B * p.Sq * p.H;
  attn_bwd_prep_kernel<HD><<<(unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock),
                             kPrepWarps * 32, 0, st>>>(t.o, t.dout, t.delta, p.B, p.Sq, p.H);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return Bwd<HD>::launch(t, p, st);
}

}  // namespace

// bf16 only. q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, K, hd), all
// contiguous and 16-byte aligned; lse (the forward's, fp32 (B, H, Sq)) and
// delta (fp32 (B, H, Sq), scratch the call writes). kind: 0 = causal, 1 =
// full, 2 = prefix. hd: 16, 32, 64, 112 or 128.
extern "C" int repro_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta, int B, int Sq,
    int Skv, int H, int K, int hd, float scale, float softcap, int kind, int window,
    int prefix_len, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0 || Skv < 0) return (int)cudaErrorInvalidValue;
  const Params p{B, Sq, Skv, H, K, H / K, scale, softcap,
                 kind, window, prefix_len, q_offset};
  const BwdTensors t{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                     (const __nv_bfloat16*)v, (const __nv_bfloat16*)o,
                     (const __nv_bfloat16*)dout, (const float*)lse, (float*)delta,
                     (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch_bwd<16>(t, p, st);
    case 32: return launch_bwd<32>(t, p, st);
    case 64: return launch_bwd<64>(t, p, st);
    case 112: return launch_bwd<112>(t, p, st);
    case 128: return launch_bwd<128>(t, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
