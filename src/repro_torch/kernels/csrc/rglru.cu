// K4: the RG-LRU gated linear recurrence of RecurrentGemma, written for
// sm_90a.
//
// Replaces: the Pallas TPU kernel `rglru_pallas`
// (src/repro/kernels/rglru_kernel.py, body `_rglru_kernel`).
//
// What it computes: for every sequence b and channel w, in float32,
//
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   h_{-1} = h0,
//
// and writes every h_t to h_all (B, S, W) and the last to hT (B, W). log_a
// and b are (B, S, W), each float32 or bfloat16 (widened to fp32 in
// registers); h0, h_all and hT are float32. The exp of log_a is taken here
// (the TPU wrapper takes it before its kernel). Any S >= 0 and any W work:
// there is no chunk or channel-block multiple (the Pallas kernel asserts
// S % chunk == 0 and W % block_w == 0).
//
// What bounds it on the H100: it reads log_a and b once and writes h_all
// once, ~12 B per (t, w) with fp32 inputs: at the served shape (B = 1,
// S = 150, W = 4096) ~7.4 MB, ~2.2 us at 3.35 TB/s; its 2 flops and one exp
// per element are far below the fp32 peak. So bytes bound it, but this form
// is serial in t: its time is S dependent steps of one thread, and the
// loads of a step must arrive before its FMA can run.
//
// What the design does: one thread per (sequence, channel), kThreads = 64
// channels per block (at B = 1, W = 4096 that is 64 blocks, spread over
// the SMs), so the loads of one step are coalesced across channels. Each
// thread walks t in tiles of kTile steps: a and b of a tile do not depend on
// h, so the tile after the current one is loaded into registers (as raw
// input words) before the current tile's exps and its serial FMA chain run,
// keeping two tiles of loads in flight per thread. Its chunk-parallel form
// (per-chunk products, then a carry pass) would run all of S at once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels per block
constexpr int kTile = 16;     // time steps loaded per pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const TA* __restrict__ log_a, const TB* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ h_all,
             float* __restrict__ hT, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const long long bi = blockIdx.y;
  if (w >= W) return;
  const long long base = bi * S * W + w;
  const TA* ap = log_a + base;
  const TB* bp = b + base;
  float* yp = h_all + base;
  const long long ts = W;  // stride of one time step
  float h = h0[bi * W + w];

  const int n_tiles = S / kTile;
  TA ca[kTile];
  TB cb[kTile];
  if (n_tiles > 0) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      ca[q] = ap[q * ts];
      cb[q] = bp[q * ts];
    }
  }
  for (int i = 0; i < n_tiles; ++i) {
    const long long t0 = (long long)i * kTile;
    TA na[kTile];
    TB nb[kTile];
    if (i + 1 < n_tiles) {  // the next tile's loads go out first
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        na[q] = ap[(t0 + kTile + q) * ts];
        nb[q] = bp[(t0 + kTile + q) * ts];
      }
    }
    float a[kTile];
#pragma unroll
    for (int q = 0; q < kTile; ++q) a[q] = expf(to_float(ca[q]));
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      h = fmaf(a[q], h, to_float(cb[q]));
      yp[(t0 + q) * ts] = h;
    }
    if (i + 1 < n_tiles) {
#pragma unroll
      for (int q = 0; q < kTile; ++q) {
        ca[q] = na[q];
        cb[q] = nb[q];
      }
    }
  }
  for (long long t = (long long)n_tiles * kTile; t < S; ++t) {
    h = fmaf(expf(to_float(ap[t * ts])), h, to_float(bp[t * ts]));
    yp[t * ts] = h;
  }
  hT[bi * W + w] = h;
}

template <typename TA, typename TB>
void launch(const void* log_a, const void* b, const float* h0, float* h_all,
            float* hT, int B, int S, int W, cudaStream_t stream) {
  dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_kernel<TA, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(log_a), static_cast<const TB*>(b), h0, h_all,
      hT, S, W);
}

template <typename TA>
bool dispatch_b(int b_dtype, const void* log_a, const void* b,
                const float* h0, float* h_all, float* hT, int B, int S, int W,
                cudaStream_t stream) {
  if (b_dtype == 0)
    launch<TA, float>(log_a, b, h0, h_all, hT, B, S, W, stream);
  else if (b_dtype == 1)
    launch<TA, __nv_bfloat16>(log_a, b, h0, h_all, hT, B, S, W, stream);
  else
    return false;
  return true;
}

}  // namespace

// a_dtype, b_dtype (of log_a, b): 0 = float32, 1 = bfloat16. Every tensor is
// contiguous: log_a, b, h_all (B, S, W); h0, hT (B, W). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape or dtype it
// does not take).
extern "C" int repro_rglru(const void* log_a, const void* b, const void* h0,
                           void* h_all, void* hT, int B, int S, int W,
                           int a_dtype, int b_dtype, void* stream) {
  if (B <= 0 || B > 65535 || S < 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const float* hh0 = static_cast<const float*>(h0);
  float* y = static_cast<float*>(h_all);
  float* hTT = static_cast<float*>(hT);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  bool ok;
  if (a_dtype == 0)
    ok = dispatch_b<float>(b_dtype, log_a, b, hh0, y, hTT, B, S, W, cs);
  else if (a_dtype == 1)
    ok = dispatch_b<__nv_bfloat16>(b_dtype, log_a, b, hh0, y, hTT, B, S, W,
                                   cs);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
