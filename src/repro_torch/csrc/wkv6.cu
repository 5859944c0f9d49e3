// WKV6 forward: the RWKV-6 recurrence. Replaces the Pallas TPU kernel of
// repro/kernels/wkv6.py: wkv6_kernel (_wkv6_kernel), with its contract:
// r, k, v, lw (B, S, H, hd), u (H, hd), initial state (B, H, hd, hd) or none;
// out (B, S, H, hd) fp32 and the final state fp32. Per (b, h), with the
// state's axes [key channel c, value channel d]:
//
//   o_t[d]    = sum_c r_t[c] * S[c][d] + v_t[d] * a_t,
//               a_t = sum_c r_t[c] * u[c] * k_t[c]      (the u bonus, hoisted)
//   S[c][d]  <- exp(lw_t[c]) * S[c][d] + k_t[c] * v_t[d]
//
// The output reads the state before step t's update (kernels/ref.wkv6_ref).
//
// Bound: at the RWKV-6 1.6B training shape (8, 1024, 32, 64) with fp32
// r/k/v the bytes (r, k, v, lw read once, out and the final state written
// once: 340 MB, 0.101 ms) outweigh the 5 hd^2 fp32 operations per (b, t, h)
// (0.080 ms). The recurrence is sequential in t, so what a design has to
// beat is latency: hd threads per (b, h), each loading its step's inputs
// from device memory and meeting the others at a barrier every step, leave
// about four warps an SM to hide a round trip per step.
//
// Design: the sequential recurrence (its accuracy at the decays' whole clip
// range is the fp64 oracle's within ~2e-5, where the chunked form loses
// digits), with the latency taken out of each step.
// * Each thread keeps a tile of the state in registers: kPieces 16-byte
//   pieces of key rows (q = rg, rg + RG, ...: rows 4q..4q+3) by kCols value
//   columns. At hd 64 that is 8 rows by 4 columns, 128 threads per (b, h).
//   A step is 3 fp32 operations per state element (an FMA for the output,
//   a multiply and an FMA for the update). The RG row groups of a column
//   group are neighbouring lanes; their partial outputs meet by a
//   reduce-scatter of __shfl_xor_sync (each lane keeps half its columns per
//   level, then one all-reduce level).
// * The tile is what shared memory can feed: every thread reads its rows'
//   r, k and exp(lw) and its columns' v each step, and the card delivers
//   128 bytes a cycle to an SM however many lanes share an address. One
//   column per thread (16 rows each) needed 4x the bytes of an 8 x 4 tile
//   per step, and that, not arithmetic, set its pace. Smaller tiles (more
//   warps) and larger ones (fewer) both ran slower than 8 x 4 on an H100.
// * kChunk steps of r, k, v and lw are staged in shared memory by cp.async,
//   double buffered: the copy of chunk i + 1 runs under chunk i's steps, so
//   no step waits on device memory, and threads meet at two barriers per
//   chunk instead of one per step. A preparing pass per chunk takes exp(lw)
//   once per element (in place), converts bf16 r/k/v to fp32, and reduces
//   a_t per step with one warp per step. Row group 0 starts its output
//   partials at v_d * a_t.
// * A chunk's outputs collect in shared memory and leave as whole rows of
//   hd floats, 16 bytes a thread.
// Arithmetic is fp32 throughout (expf, no fast-math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 32;   // steps staged per chunk

// The state tile of one thread: kPieces 16-byte pieces of key rows by kCols
// value columns; RG row groups per column group, NT threads per (b, h).
template <int HD>
struct Tile {
  static constexpr int kPieces = HD == 64 ? 2 : 1;
  static constexpr int kCols = HD == 16 ? 2 : 4;
  static constexpr int RG = HD / 4 / kPieces;
  static constexpr int NT = RG * (HD / kCols);
  static_assert(kCols <= RG && NT % 32 == 0 && 32 % RG == 0, "tile");
};
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of one CTA, in bytes: fp32 arrays first, then the staged
// r/k/v in their input type. bf16 inputs add an fp32 working copy.
template <int HD, typename T>
struct Smem {
  static constexpr int kRow = kChunk * HD;  // elements of one staged array
  static constexpr int kLw = 0;                          // [2][kChunk][HD]
  static constexpr int kOut = kLw + 2 * kRow * 4;        // [kChunk][HD]
  static constexpr int kA = kOut + kRow * 4;             // [kChunk]
  static constexpr int kU = kA + kChunk * 4;             // [HD]
  static constexpr int kWork = kU + HD * 4;              // [3][kChunk][HD]
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kRaw = kWork + (kF32 ? 0 : 3 * kRow * 4);  // [2][3][kChunk][HD] of T
  static constexpr int kBytes = kRaw + 2 * 3 * kRow * (int)sizeof(T);
};

template <int HD, typename T>
__global__ void __launch_bounds__(Tile<HD>::NT)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ out, float* __restrict__ sf, int S,
                int H) {
  using L = Smem<HD, T>;
  constexpr int NT = Tile<HD>::NT;       // threads
  constexpr int NQ = Tile<HD>::kPieces;  // row pieces per thread
  constexpr int C = Tile<HD>::kCols;     // value columns per thread
  constexpr int RG = Tile<HD>::RG;       // row groups per column group
  constexpr int EPP = 16 / (int)sizeof(T);  // elements per 16-byte piece
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lw = reinterpret_cast<float*>(smem + L::kLw);
  float* s_out = reinterpret_cast<float*>(smem + L::kOut);
  float* s_a = reinterpret_cast<float*>(smem + L::kA);
  float* s_u = reinterpret_cast<float*>(smem + L::kU);
  T* s_raw = reinterpret_cast<T*>(smem + L::kRaw);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int rg = tid % RG, cg = tid / RG;  // row group, column group
  const int lane = tid & 31, warp = tid >> 5;
  const long long rows = (long long)H * HD;              // one step
  const long long base = ((long long)b * S * H + h) * HD;  // step 0 of (b, h)
  const int nchunks = (S + kChunk - 1) / kChunk;

  // Stage chunk `c` into buffer `buf`: r, k, v (type T) and lw (fp32).
  auto stage = [&](int buf, int c) {
    const int t0 = c * kChunk;
    const int nt = min(kChunk, S - t0);
    constexpr int PR = HD / EPP;  // pieces per row, r/k/v
    const T* src[3] = {r, k, v};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T* dst = s_raw + (buf * 3 + a) * L::kRow;
      for (int p = tid; p < nt * PR; p += NT) {
        const int row = p / PR, piece = p % PR;
        cp_async16(dst + row * HD + piece * EPP,
                   src[a] + base + (t0 + row) * rows + piece * EPP);
      }
    }
    constexpr int PRW = HD / 4;  // pieces per row, lw
    float* dst = s_lw + buf * L::kRow;
    for (int p = tid; p < nt * PRW; p += NT) {
      const int row = p / PRW, piece = p % PRW;
      cp_async16(dst + row * HD + piece * 4,
                 lw + base + (t0 + row) * rows + piece * 4);
    }
    cp_async_commit();
  };

  // Write the outputs of `nt` steps from t0 on, whole rows of hd floats.
  auto flush = [&](int t0, int nt) {
    constexpr int PRW = HD / 4;
    for (int p = tid; p < nt * PRW; p += NT) {
      const int row = p / PRW, piece = p % PRW;
      *reinterpret_cast<float4*>(out + base + (t0 + row) * rows + piece * 4) =
          reinterpret_cast<const float4*>(s_out)[p];
    }
  };

  if (nchunks > 0) stage(0, 0);
  if (tid < HD) s_u[tid] = u[h * HD + tid];  // published by the first barrier

  // st[j][e][i] = S[4 (rg + RG j) + e][C cg + i]
  float st[NQ][4][C];
  const long long sbase = (long long)bh * HD * HD + C * cg;
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < C; ++i)
        st[j][e][i] = s0 ? s0[sbase + (long long)(4 * (rg + RG * j) + e) * HD + i]
                         : 0.0f;

  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    const int t0 = c * kChunk;
    const int nt = min(kChunk, S - t0);
    cp_async_wait_all();
    // Chunk c has landed for every thread; every thread has finished chunk
    // c - 1's steps, so its buffer and the output rows are free.
    __syncthreads();
    if (c + 1 < nchunks) stage(buf ^ 1, c + 1);
    if (c > 0) flush(t0 - kChunk, kChunk);

    // Prepare chunk c: exp(lw) in place, bf16 -> fp32, a_t per step.
    const T* raw_r = s_raw + (buf * 3 + 0) * L::kRow;
    const T* raw_k = s_raw + (buf * 3 + 1) * L::kRow;
    const T* raw_v = s_raw + (buf * 3 + 2) * L::kRow;
    float* w_c = s_lw + buf * L::kRow;
    for (int e = tid; e < nt * HD; e += NT) w_c[e] = expf(w_c[e]);
    const float* r_c;
    const float* k_c;
    const float* v_c;
    if constexpr (L::kF32) {
      r_c = raw_r;
      k_c = raw_k;
      v_c = raw_v;
    } else {
      float* work = reinterpret_cast<float*>(smem + L::kWork);
      for (int e = tid; e < nt * HD; e += NT) {
        work[e] = to_f32(raw_r[e]);
        work[L::kRow + e] = to_f32(raw_k[e]);
        work[2 * L::kRow + e] = to_f32(raw_v[e]);
      }
      r_c = work;
      k_c = work + L::kRow;
      v_c = work + 2 * L::kRow;
    }
    for (int t = warp; t < nt; t += NT / 32) {
      float x = 0.0f;
#pragma unroll
      for (int ch = lane; ch < HD; ch += 32)
        x = fmaf(to_f32(raw_r[t * HD + ch]) * s_u[ch],
                 to_f32(raw_k[t * HD + ch]), x);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(kFull, x, off);
      if (lane == 0) s_a[t] = x;
    }
    __syncthreads();

    // The steps: no global memory, no barrier.
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      const float4* r4 = reinterpret_cast<const float4*>(r_c + t * HD);
      const float4* k4 = reinterpret_cast<const float4*>(k_c + t * HD);
      const float4* w4 = reinterpret_cast<const float4*>(w_c + t * HD);
      float vv[C];
      if constexpr (C % 4 == 0) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 x =
              reinterpret_cast<const float4*>(v_c + t * HD + C * cg)[q];
          vv[4 * q] = x.x; vv[4 * q + 1] = x.y;
          vv[4 * q + 2] = x.z; vv[4 * q + 3] = x.w;
        }
      } else {
        const float2 x = reinterpret_cast<const float2*>(v_c + t * HD)[cg];
        vv[0] = x.x; vv[1] = x.y;
      }
      const float at = s_a[t];
      float acc[C];
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] = rg == 0 ? vv[i] * at : 0.0f;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float4 rr = r4[rg + RG * j], kk = k4[rg + RG * j],
                     ww = w4[rg + RG * j];
        const float rc[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kc[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wc[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const float s = st[j][e][i];
            acc[i] = fmaf(rc[e], s, acc[i]);
            st[j][e][i] = fmaf(wc[e], s, kc[e] * vv[i]);
          }
      }
      // Reduce-scatter over the RG lanes of the column group: while a lane
      // holds more than one column it keeps half (the upper half where its
      // bit `off` is set) and adds its partner's; then all-reduce.
      int col = 0;
      int n = C;
#pragma unroll
      for (int off = RG / 2; off >= 1; off >>= 1) {
        if (n > 1) {
          const bool up = (rg & off) != 0;
          const int half = n / 2;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = up ? acc[i] : acc[i + half];
            const float keep = up ? acc[i + half] : acc[i];
            acc[i] = keep + __shfl_xor_sync(kFull, send, off);
          }
          if (up) col += half;
          n = half;
        } else {
          acc[0] += __shfl_xor_sync(kFull, acc[0], off);
        }
      }
      if ((rg & (RG / C - 1)) == 0) s_out[t * HD + C * cg + col] = acc[0];
    }
  }
  __syncthreads();
  if (nchunks > 0) flush((nchunks - 1) * kChunk, S - (nchunks - 1) * kChunk);
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < C; ++i)
        sf[sbase + (long long)(4 * (rg + RG * j) + e) * HD + i] = st[j][e][i];
}

template <int HD, typename T>
cudaError_t launch_typed(const void* r, const void* k, const void* v,
                         const float* lw, const float* u, const float* s0,
                         float* out, float* sf, int B, int S, int H,
                         cudaStream_t stream) {
  constexpr int bytes = Smem<HD, T>::kBytes;  // 72.4 KB at hd 64
  constexpr int threads = Tile<HD>::NT;
  const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  wkv6_fwd_kernel<HD, T><<<(unsigned)(B * H), threads, bytes, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, lw, u, s0, out, sf, S, H);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* r, const void* k, const void* v,
                   const float* lw, const float* u, const float* s0,
                   float* out, float* sf, int B, int S, int H,
                   cudaStream_t stream) {
  if (dtype == 0)
    return launch_typed<HD, float>(r, k, v, lw, u, s0, out, sf, B, S, H,
                                   stream);
  return launch_typed<HD, __nv_bfloat16>(r, k, v, lw, u, s0, out, sf, B, S,
                                         H, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (r, k, v); lw, u, s0 (may be null), out and sf
// are fp32. hd must be 16, 32 or 64. r, k, v, lw and out must be 16-byte
// aligned (cp.async and the output rows move 16 bytes at a time).
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
