// K2: causal (optionally sliding-window) flash attention for turn-1 prefill,
// written for sm_90a.
//
// Replaces: the Pallas TPU kernel `flash_prefill_attention`
// (src/repro/kernels/prefill_attention.py, body `_flash_kernel`).
//
// What it computes: q (B, S, H, D) against k, v (B, S, Hkv, D), all
// contiguous, with H a multiple of Hkv. Query head h reads KV head h / G
// directly (G = H / Hkv), so the caller never materialises the expanded
// `_repeat_kv` copy. Row i attends to keys j <= i, and with window > 0 only
// to keys j > i - window. The softmax is online in fp32 over key tiles and
// the sum is normalised by max(l, 1e-20), as the Pallas kernel does. S need
// not be a multiple of any tile: the ragged last query tile and key tile are
// masked here, so every fresh turn-1 prefill can use the kernel, the exact-
// length fallback of the replica included.
//
// What bounds it on the H100: operations. A causal prefill does about
// 2·B·H·S²·D flops for 4·B·S·(H + Hkv)·D·itemsize bytes, well above the
// card's ~295 flop/byte ridge once S reaches a few hundred.
//
// What the design does about it, for now: one block per (query tile of 64
// rows, head, sequence); two threads per query row, each holding half of the
// row's D elements (interleaved, so the two halves sit in different shared
// memory banks) and half of its fp32 accumulator in registers. Key and value
// tiles of 32 rows are staged once in shared memory and read by all 64 rows
// as broadcasts. Tiles wholly above the diagonal or before the window are
// never loaded. The products run on the CUDA cores in fp32, not on the
// tensor cores: this is the simple, correct form. `mma`/`wgmma` tiles, TMA
// and a deeper pipeline are the work that makes it fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 32;   // keys per shared-memory tile
constexpr int kThreads = 2 * kBlockQ;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out, int S, int H,
               int Hkv, int window, float scale) {
  constexpr int HALF = D / 2;  // elements d = 2 * i + half of this thread
  const int q_lo = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int qpos = q_lo + r;
  const bool row_ok = qpos < S;

  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];

  const long long q_row = (long long)H * D;
  const long long kv_row = (long long)Hkv * D;
  float qr[HALF], acc[HALF];
  const T* qp = q + ((long long)b * S + (row_ok ? qpos : 0)) * q_row +
                (long long)h * D;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    qr[i] = row_ok ? to_float(qp[2 * i + half]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys any row of this tile can see: causal end, window start
  const int q_hi = min(q_lo + kBlockQ, S) - 1;
  const int k_end = q_hi + 1;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / kBlockK) * kBlockK;

  const T* kb = k + (long long)b * S * kv_row + (long long)hk * D;
  const T* vb = v + (long long)b * S * kv_row + (long long)hk * D;
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const int kp = k0 + j;
      float kv_k = 0.f, kv_v = 0.f;
      if (kp < S) {
        kv_k = to_float(kb[kp * kv_row + d]);
        kv_v = to_float(vb[kp * kv_row + d]);
      }
      ks[j][d] = kv_k;
      vs[j][d] = kv_v;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < HALF; ++i) part += qr[i] * ks[j][2 * i + half];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int kp = k0 + j;
      const bool ok = kp <= qpos && (window == 0 || kp > qpos - window);
      s[j] = ok ? part * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < HALF; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int i = 0; i < HALF; ++i) acc[i] += p * vs[j][2 * i + half];
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (!row_ok) return;
  T* op = out + ((long long)b * S + qpos) * q_row + (long long)h * D;
  const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
  for (int i = 0; i < HALF; ++i) op[2 * i + half] = from_float<T>(acc[i] * inv);
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int S, int H, int Hkv, int window, float scale,
            cudaStream_t stream) {
  dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  prefill_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Hkv, window,
      scale);
}

template <typename T>
bool dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int Hkv, int window, float scale,
                cudaStream_t stream) {
  switch (D) {
#define REPRO_D(d)                                                        \
  case d:                                                                 \
    launch<T, d>(q, k, v, out, B, S, H, Hkv, window, scale, stream);      \
    return true;
    REPRO_D(16) REPRO_D(32) REPRO_D(64) REPRO_D(128)
#undef REPRO_D
  }
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int repro_prefill_attention(const void* q, const void* k,
                                       const void* v, void* out, int B, int S,
                                       int H, int Hkv, int D, int window,
                                       float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == 0)
    ok = dispatch_d<float>(D, q, k, v, out, B, S, H, Hkv, window, scale, st);
  else if (dtype == 1)
    ok = dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, S, H, Hkv, window,
                                   scale, st);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
