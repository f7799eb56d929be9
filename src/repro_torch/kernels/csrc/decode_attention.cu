// K1: flash-decode GQA attention for the decode tail, written for sm_90a.
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
// softmax is online in fp32 and the sum is normalised by max(l, 1e-20), as the
// Pallas kernel does.
//
// What bounds it on the H100: bytes. Every cache element is read once and
// used for G = H / Hkv query heads, so at decode it does ~2·G flops per byte
// read — far below the ~295 flop/byte ridge of the card. The least time is
// B·len·Hkv·D·2·itemsize bytes over 3.35 TB/s.
//
// What the design does about it: one block per (KV head, sequence), so the G
// query heads that share a KV head share every K/V row fetched — each byte is
// read once. The loop stops at the sequence's live length, so the dead tail
// of the buffer is never fetched (the Pallas kernel clamps its block index map
// for the same reason). Each warp streams its own share of the keys with
// kUnroll rows in flight, a lane holds D/32 contiguous elements of a row, and
// the four warps' partial softmax states are merged once at the end through
// shared memory. Not done yet: split-KV across blocks for small B·Hkv, and
// 16-byte vector loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // keys each warp has in flight
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
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

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ k_new,
              const T* __restrict__ v_new, const int* __restrict__ lengths,
              T* __restrict__ out, int S, int Hkv, long long kv_stride_b,
              float scale) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // row elements per lane
  const int n = blockIdx.x;                  // KV head
  const int b = blockIdx.y;                  // sequence
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool lane_on = lane * EPL < D;  // D = 16: the upper half-warp idles
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const bool has_new = k_new != nullptr;
  const int n_keys = len + (has_new ? 1 : 0);

  const long long head = (long long)b * Hkv + n;  // (b, n) in (B, Hkv)
  const T* qb = q + head * G * D;
  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[g][e] = lane_on ? to_float(qb[g * D + lane * EPL + e]) : 0.f;

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const long long row = (long long)Hkv * D;  // stride between positions
  const T* kb = k + b * kv_stride_b + (long long)n * D;
  const T* vb = v + b * kv_stride_b + (long long)n * D;
  for (int base = warp * kUnroll; base < n_keys; base += kWarps * kUnroll) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u;
      const T* kp = nullptr;
      const T* vp = nullptr;
      if (j < len) {
        kp = kb + j * row;
        vp = vb + j * row;
      } else if (j < n_keys) {  // the new token, one past the live cache
        kp = k_new + head * D;
        vp = v_new + head * D;
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const bool ok = kp != nullptr && lane_on;
        kr[u][e] = ok ? to_float(kp[lane * EPL + e]) : 0.f;
        vr[u][e] = ok ? to_float(vp[lane * EPL + e]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u >= n_keys) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qr[g][e] * kr[u][e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= scale;
        const float m_new = fmaxf(m[g], s);
        const float corr = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = acc[g][e] * corr + p * vr[u][e];
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (lane_on)
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  T* ob = out + head * G * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lt += sm_l[w][g] * c;
      at += sm_acc[w][g][d] * c;
    }
    ob[g * D + d] = from_float<T>(at / fmaxf(lt, 1e-20f));
  }
}

template <typename T, int D, int G>
void launch(const void* q, const void* k, const void* v, const void* k_new,
            const void* v_new, const int* lengths, void* out, int B, int S,
            int Hkv, long long kv_stride_b, float scale, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  decode_kernel<T, D, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), lengths, static_cast<T*>(out), S, Hkv,
      kv_stride_b, scale);
}

template <typename T, int D>
bool dispatch_g(int G, const void* q, const void* k, const void* v,
                const void* k_new, const void* v_new, const int* lengths,
                void* out, int B, int S, int Hkv, long long kv_stride_b,
                float scale, cudaStream_t stream) {
  switch (G) {
#define REPRO_G(g)                                                       \
  case g:                                                                \
    launch<T, D, g>(q, k, v, k_new, v_new, lengths, out, B, S, Hkv,      \
                    kv_stride_b, scale, stream);                         \
    return true;
    REPRO_G(1) REPRO_G(2) REPRO_G(4) REPRO_G(8) REPRO_G(16)
#undef REPRO_G
  }
  return false;
}

template <typename T>
bool dispatch_d(int D, int G, const void* q, const void* k, const void* v,
                const void* k_new, const void* v_new, const int* lengths,
                void* out, int B, int S, int Hkv, long long kv_stride_b,
                float scale, cudaStream_t stream) {
  switch (D) {
#define REPRO_D(d)                                                          \
  case d:                                                                   \
    return dispatch_g<T, d>(G, q, k, v, k_new, v_new, lengths, out, B, S,   \
                            Hkv, kv_stride_b, scale, stream);
    REPRO_D(16) REPRO_D(32) REPRO_D(64) REPRO_D(128)
#undef REPRO_D
  }
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. k_new / v_new may be null. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape it does not
// take).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* k_new,
                                      const void* v_new, const void* lengths,
                                      void* out, int B, int S, int H, int Hkv,
                                      int D, long long kv_stride_b,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == 0)
    ok = dispatch_d<float>(D, G, q, k, v, k_new, v_new, lens, out, B, S, Hkv,
                           kv_stride_b, scale, st);
  else if (dtype == 1)
    ok = dispatch_d<__nv_bfloat16>(D, G, q, k, v, k_new, v_new, lens, out, B,
                                   S, Hkv, kv_stride_b, scale, st);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
