// K1: split-KV flash-decode GQA attention for the decode tail, written for
// sm_90a.
//
// Replaces: the Pallas TPU kernel `flash_decode_attention`
// (src/repro/kernels/decode_attention.py, body `_decode_kernel`).
//
// What it computes: one query token per sequence against that sequence's KV
// cache. q is (B, H, D); the cache k, v is (B, S, Hkv, D) with a free batch
// stride, so the caller can hand in a view trimmed to a ctx bucket without a
// copy. Sequence b attends to cache positions [0, min(lengths[b], S)) and,
// when k_new / v_new are given, to its freshly produced token as one more key
// (the two-branch form of the jnp `decode_attention`): the new token is never
// scattered into the cache first, so no index can land past the buffer. The
// softmax is online in fp32 with a finite sentinel (-1e30) and the sum is
// normalised by max(l, 1e-20), as the Pallas kernel does: a row with no key
// gives 0, never NaN.
//
// What bounds it on the H100: bytes. Every cache element is read once and
// used for G = H / Hkv query heads, so at decode it does ~2·G flops per byte
// read — far below the ~295 flop/byte ridge of the card. The least time is
// B·len·Hkv·D·2·itemsize bytes over 3.35 TB/s: ~5 us for 16 slots of 256
// keys at qwen3-0.6b's widths. What keeps a kernel from it at that size is
// latency: one block per (sequence, KV head) is 128 blocks on 132 SMs, each
// walking its keys in dependent rounds of loads.
//
// What the design does about it:
// - Split-KV. The key axis of each (sequence, KV head) is cut into n_split
//   ranges of split_len keys over S + 1 positions (the live cache, then the
//   new token at position len), one block each, so the grid is
//   n_split x Hkv x B. The wrapper plans the split from the shapes alone,
//   never from `lengths`, so a launch needs no host sync and can be
//   captured in a CUDA graph. A block whose range starts past its
//   sequence's live keys writes an empty partial (m = -1e30, l = 0) and
//   returns; the loop of a live block stops at the live length, so the dead
//   tail of the buffer is never fetched.
// - The G query heads that share a KV head share every K/V row a block
//   fetches: each byte is read once. G is any of 1, 2, 4, 5, 6, 8, 16: a
//   lane's state is indexed by g and nothing pairs heads, so an odd G
//   (llama4-scout's 40 over 8) needs nothing of its own.
// - 16-byte vector loads: a row is cut into P = D / VEC pieces of VEC
//   contiguous elements (8 bf16 or 4 fp32; 4 bf16 when G = 16, to bound the
//   registers). LPR lanes cover a row, the power of two at or above P (at
//   most 32), and a lane holds NV = ceil(P / LPR) pieces, LPR pieces apart;
//   a warp instruction loads 32 / LPR rows (two at D = 128 bf16). Where P
//   is not a power of two (D = 160: 20 bf16 or 40 fp32 pieces; D = 240: 30
//   or 60) the lanes past the row's last piece idle in that load, so every
//   key is still read once. Each warp issues the K and V loads of UNROLL
//   such instructions before it uses any of them, so a block keeps up to
//   64 rows in flight, and one online-softmax rescale covers them all.
// - The lanes' and warps' partial softmax states are merged by shuffles and
//   through shared memory. With one split the block writes the output;
//   otherwise it writes (m, l, unnormalised acc) in fp32 scratch that the
//   wrapper allocates, and a second kernel from the same entry point merges
//   the splits.
// - An int8 cache (the quantized decode tail, `kv_cache_dtype="int8"`,
//   dequantized as int8 x kv_scale): the kernel reads the int8 rows
//   themselves, half the bytes of bf16, a 16-byte piece then carrying 16
//   values (8 or 4 when G >= 5, to bound the registers), and widens them to
//   float in registers. The scale is applied once to q, before the dot
//   products, and once to each block's weighted sum, never per key. q, the
//   new token and the output stay in the model's dtype; the new token is
//   attended in full precision, as one more key after the loop, its K and V
//   divided by kv_scale so that the scaled q and the final scaling leave it
//   as it is. Instantiated at D = 128.
// Not done yet: a persistent grid that walks (sequence, KV head, split)
// work items, which would also fold the combine into the same launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// the largest G x D instantiated: a lane holds G x D / 32 query and as many
// accumulator elements at least, so past this they spill (G = 16 at D = 160
// or 240 serves no configuration)
constexpr int kMaxGD = 2048;

template <int BYTES>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = unsigned int;
};

template <typename T, int VEC>
__device__ __forceinline__ void widen(const typename Word<VEC * sizeof(T)>::type& w,
                                      float (&f)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    const float* p = reinterpret_cast<const float*>(&w);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = p[e];
  } else if constexpr (sizeof(T) == 1) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = (float)p[e];
  } else {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < VEC / 2; ++e) {
      const float2 t = __bfloat1622float2(p[e]);
      f[2 * e] = t.x;
      f[2 * e + 1] = t.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int pow2_at_least(int x) { return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2); }
constexpr int pow2_at_most(int x) { return x <= 1 ? 1 : 2 * pow2_at_most(x / 2); }

// KT: the cache's element type
template <typename KT, int D, int G>
struct DecodeShape {
  // elements per piece: one 16-byte load, or fewer elements when a lane's
  // G x VEC would not fit its registers (8 bytes of bf16 at G = 16; 8 or 4
  // bytes of int8 at G >= 5)
  static constexpr int VEC = (16 / (int)sizeof(KT)) < pow2_at_most(64 / G)
                                 ? 16 / (int)sizeof(KT) : pow2_at_most(64 / G);
  static constexpr int P = D / VEC;     // pieces per row
  static constexpr int LPR = P >= 32 ? 32 : pow2_at_least(P);  // lanes a row
  static constexpr int NV = (P + LPR - 1) / LPR;  // pieces per lane
  static constexpr int RPW = 32 / LPR;  // rows per warp instruction
  static constexpr int E = NV * VEC;    // elements per lane
  // row loads each warp has in flight per round: more when a lane's state
  // (G x E query and accumulator elements) is small
  static constexpr int UNROLL = G * E <= 16 ? 8 : (G * E <= 32 ? 4 : 2);
  static_assert(D % VEC == 0 && LPR <= 32 && 32 % LPR == 0, "row split");
};

// One block per (split, KV head, sequence). T: q, the new token and the
// output; KT: the cache, T itself or int8 (kQuant). scale_log2 holds
// kv_scale too when kQuant.
template <typename T, typename KT, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const T* __restrict__ k_new,
                    const T* __restrict__ v_new,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int S, int Hkv, long long kv_stride_b, int split_len,
                    float scale_log2, float kv_scale) {
  using Sh = DecodeShape<KT, D, G>;
  constexpr int VEC = Sh::VEC, P = Sh::P, LPR = Sh::LPR, NV = Sh::NV,
                RPW = Sh::RPW, E = Sh::E, U = Sh::UNROLL;
  constexpr bool kFull = NV * LPR == P;  // no lane idles in a row's load
  constexpr bool kQuant = sizeof(KT) == 1;
  using W = typename Word<VEC * sizeof(KT)>::type;
  const int split = blockIdx.x;
  const int n = blockIdx.y;  // KV head
  const int b = blockIdx.z;  // sequence
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPR;  // which of the warp's RPW rows
  // the lane's pieces: lane % LPR + i * LPR, each VEC elements from col[i]
  int col[NV];
  bool has[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int pc = lane % LPR + i * LPR;
    has[i] = kFull || pc < P;
    col[i] = has[i] ? pc * VEC : 0;
  }
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int n_keys = len + (k_new != nullptr ? 1 : 0);
  const int j0 = split * split_len;
  const int j1 = min(j0 + split_len, n_keys);
  // the loop's keys: with an int8 cache the new token comes after it
  const int jl = kQuant ? min(j1, len) : j1;
  const bool direct = gridDim.x == 1;
  const long long head = (long long)b * Hkv + n;  // (b, n) in (B, Hkv)
  const long long BH = (long long)gridDim.z * Hkv * G;

  if (!direct && j0 >= n_keys) {  // nothing live in this range
    if (threadIdx.x < G) {
      float* ml = part_ml + 2 * ((long long)split * BH + head * G +
                                 threadIdx.x);
      ml[0] = kNegInf;
      ml[1] = 0.f;
    }
    return;
  }

  // an idle piece holds zeros in q, so its products add nothing
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float f[VEC];
      if constexpr (kQuant) {  // VEC elements of T: once a block
        const T* qp = q + (head * G + g) * D + col[i];
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = has[i] ? to_float<T>(qp[e]) : 0.f;
      } else {
        W w = W{};
        if (has[i])
          w = *reinterpret_cast<const W*>(q + (head * G + g) * D + col[i]);
        widen<T, VEC>(w, f);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][i * VEC + e] = f[e] * scale_log2;
    }
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const long long row = (long long)Hkv * D;  // stride between positions
  const KT* kb = k + b * kv_stride_b + (long long)n * D;
  const KT* vb = v + b * kv_stride_b + (long long)n * D;
  const T* kn = k_new + head * D;
  const T* vn = v_new + head * D;
  for (int base = j0; base < jl; base += kWarps * U * RPW) {
    W kw[U][NV], vw[U][NV];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // issue every load of the round first
      const int j = base + (u * kWarps + warp) * RPW + sub;
      ok[u] = j < jl;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        kw[u][i] = W{};
        vw[u][i] = W{};
        if (!has[i]) continue;
        if (j < len) {
          kw[u][i] = __ldg(reinterpret_cast<const W*>(kb + j * row + col[i]));
          vw[u][i] = __ldg(reinterpret_cast<const W*>(vb + j * row + col[i]));
        } else if constexpr (!kQuant) {
          if (ok[u]) {  // j == len: the new token, one past the cache
            kw[u][i] = __ldg(reinterpret_cast<const W*>(kn + col[i]));
            vw[u][i] = __ldg(reinterpret_cast<const W*>(vn + col[i]));
          }
        }
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float f[VEC];
        widen<KT, VEC>(kw[u][i], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[i * VEC + e] = f[e];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x += qr[g][e] * kf[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)  // the lanes of one row
          x += __shfl_xor_sync(0xffffffffu, x, off);
        s[u][g] = x;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float vf[E];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float f[VEC];
        widen<KT, VEC>(vw[u][i], f);
#pragma unroll
        for (int e = 0; e < VEC; ++e) vf[i * VEC + e] = f[e];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = exp2f(s[u][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += p * vf[e];
      }
    }
  }

  if constexpr (kQuant) {
    // the new token at position len, in full precision, by warp 0's first
    // row group (all of warp 0 takes part in the shuffles)
    if (k_new != nullptr && len >= j0 && len < j1 && warp == 0) {
      const float inv = 1.f / kv_scale;
      float kf[E], vf[E];
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kf[i * VEC + e] = has[i] ? to_float<T>(kn[col[i] + e]) * inv : 0.f;
          vf[i * VEC + e] = has[i] ? to_float<T>(vn[col[i] + e]) * inv : 0.f;
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x += qr[g][e] * kf[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        if (sub == 0) {
          const float mx = fmaxf(m[g], x);
          const float corr = exp2f(m[g] - mx), p = exp2f(x - mx);
          m[g] = mx;
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = acc[g][e] * corr + p * vf[e];
        }
      }
    }
  }

  // merge the warp's RPW row groups (lanes LPR apart hold the same columns)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float c_self = exp2f(m[g] - mx), c_other = exp2f(mo - mx);
      l[g] = l[g] * c_self + lo * c_other;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * c_self + ao * c_other;
      }
      m[g] = mx;
    }
  }

  // merge the warps through shared memory
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (!has[i]) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          sm_acc[warp][g][col[i] + e] = acc[g][i * VEC + e];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm_m[w][g] - mx);
      lt += sm_l[w][g] * c;
      at += sm_acc[w][g][d] * c;
    }
    if constexpr (kQuant) at *= kv_scale;  // the sum of int8 rows, scaled
    const long long hq = head * G + g;  // (b, h) in (B, H)
    if (direct) {
      out[hq * D + d] = from_float<T>(at / fmaxf(lt, 1e-20f));
    } else {
      part_acc[((long long)split * BH + hq) * D + d] = at;
      if (d == 0) {
        part_ml[2 * ((long long)split * BH + hq)] = mx;
        part_ml[2 * ((long long)split * BH + hq) + 1] = lt;
      }
    }
  }
}

// Merge the splits' partial states: one thread per output element. A split
// with l = 0 (no live key) is skipped, so its acc is never read.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc, T* __restrict__ out,
                      int n_split, long long BH, int D) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= BH * D) return;
  const long long hq = idx / D;
  const int d = (int)(idx % D);
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) {
    const float* ml = part_ml + 2 * (s * BH + hq);
    if (ml[1] > 0.f) mx = fmaxf(mx, ml[0]);
  }
  float lt = 0.f, at = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ml = part_ml + 2 * (s * BH + hq);
    if (ml[1] > 0.f) {
      const float c = exp2f(ml[0] - mx);
      lt += ml[1] * c;
      at += part_acc[(s * BH + hq) * D + d] * c;
    }
  }
  out[idx] = from_float<T>(at / fmaxf(lt, 1e-20f));
}

template <typename T, typename KT, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_new, const void* v_new, const int* lengths,
                   void* out, float* scratch, int B, int S, int Hkv,
                   long long kv_stride_b, int n_split, int split_len,
                   float scale, float kv_scale, cudaStream_t stream) {
  const long long BH = (long long)B * Hkv * G;
  float* part_ml = scratch;
  float* part_acc = scratch == nullptr ? nullptr : scratch + 2 * n_split * BH;
  dim3 grid(n_split, Hkv, B);
  const float scale_log2 =
      sizeof(KT) == 1 ? scale * kLog2e * kv_scale : scale * kLog2e;
  decode_split_kernel<T, KT, D, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), lengths, static_cast<T*>(out), part_ml,
      part_acc, S, Hkv, kv_stride_b, split_len, scale_log2, kv_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const long long n_out = BH * D;
  decode_combine_kernel<T><<<(unsigned)((n_out + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), n_split, BH, D);
  return cudaGetLastError();
}

template <typename T, typename KT, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const void* k_new, const void* v_new,
                       const int* lengths, void* out, float* scratch, int B,
                       int S, int Hkv, long long kv_stride_b, int n_split,
                       int split_len, float scale, float kv_scale,
                       cudaStream_t stream) {
  switch (G) {
#define REPRO_G(g)                                                           \
  case g:                                                                    \
    if constexpr (g * D <= kMaxGD)                                           \
      return launch<T, KT, D, g>(q, k, v, k_new, v_new, lengths, out,        \
                                 scratch, B, S, Hkv, kv_stride_b, n_split,   \
                                 split_len, scale, kv_scale, stream);        \
    break;
    REPRO_G(1) REPRO_G(2) REPRO_G(4) REPRO_G(5) REPRO_G(6) REPRO_G(8)
    REPRO_G(16)
#undef REPRO_G
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename KT>
cudaError_t dispatch_d(int D, int G, const void* q, const void* k,
                       const void* v, const void* k_new, const void* v_new,
                       const int* lengths, void* out, float* scratch, int B,
                       int S, int Hkv, long long kv_stride_b, int n_split,
                       int split_len, float scale, float kv_scale,
                       cudaStream_t stream) {
#define REPRO_D(d)                                                            \
  case d:                                                                     \
    return dispatch_g<T, KT, d>(G, q, k, v, k_new, v_new, lengths, out,       \
                                scratch, B, S, Hkv, kv_stride_b, n_split,     \
                                split_len, scale, kv_scale, stream);
  if constexpr (sizeof(KT) == 1) {  // an int8 cache: D = 128 only
    switch (D) { REPRO_D(128) }
  } else {
    switch (D) {
      REPRO_D(16) REPRO_D(32) REPRO_D(64) REPRO_D(128) REPRO_D(160)
      REPRO_D(240)
    }
  }
#undef REPRO_D
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of q, k_new, v_new and out; kv_int8: the
// cache k, v is int8, dequantized as int8 x kv_scale (else it is of dtype and
// kv_scale is not read). k_new / v_new may be null. The key axis
// is cut into n_split ranges of split_len keys, which must cover S + 1
// positions; with n_split > 1, `scratch` holds n_split * B * H * (D + 2)
// floats (it may be null otherwise). Returns the cudaError_t of the
// launches (cudaErrorInvalidValue for a shape it does not take).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* k_new,
                                      const void* v_new, const void* lengths,
                                      void* out, void* scratch, int B, int S,
                                      int H, int Hkv, int D,
                                      long long kv_stride_b, int n_split,
                                      int split_len, float scale, int dtype,
                                      int kv_int8, float kv_scale,
                                      void* stream) {
  if (B <= 0 || S < 0 || Hkv <= 0 || H % Hkv != 0 || n_split < 1 ||
      split_len < 1 || (long long)n_split * split_len < (long long)S + 1 ||
      (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int* lens = static_cast<const int*>(lengths);
  float* scr = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0 && !kv_int8)
    err = dispatch_d<float, float>(D, G, q, k, v, k_new, v_new, lens, out,
                                   scr, B, S, Hkv, kv_stride_b, n_split,
                                   split_len, scale, 1.f, st);
  else if (dtype == 1 && !kv_int8)
    err = dispatch_d<__nv_bfloat16, __nv_bfloat16>(
        D, G, q, k, v, k_new, v_new, lens, out, scr, B, S, Hkv, kv_stride_b,
        n_split, split_len, scale, 1.f, st);
  else if (dtype == 0)
    err = dispatch_d<float, int8_t>(D, G, q, k, v, k_new, v_new, lens, out,
                                    scr, B, S, Hkv, kv_stride_b, n_split,
                                    split_len, scale, kv_scale, st);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16, int8_t>(
        D, G, q, k, v, k_new, v_new, lens, out, scr, B, S, Hkv, kv_stride_b,
        n_split, split_len, scale, kv_scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
