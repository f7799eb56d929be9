// K4: the RG-LRU gated linear recurrence of RecurrentGemma, a blocked
// chunk-parallel scan written for sm_90a.
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
// per element are far below the fp32 peak. So bytes bound it.
//
// What the design does: a blocked scan with no traffic between blocks. A
// block is kCh = 32 channels x kSeg = 16 time segments, one warp per
// segment, so a warp's loads of one step are 128 contiguous bytes: W / 32
// blocks (128 at W = 4096). The block takes S in tiles of up to kSeg x kT =
// 256 steps, split evenly over as many segments as give each at least
// kMinLen = 4 steps (a short append does not pay a 16-step carry), and for
// each tile:
//   1. each thread issues all of its segment's loads at once (its a_t and
//      b_t do not depend on h), up to 2 kT loads in flight;
//   2. it scans the segment from zero in registers, keeping the local h_t
//      and the running product P_t = prod a of the segment so far;
//   3. each segment's (P, h) end goes to shared memory, and each thread
//      folds the segments before its own into its carry-in, starting from
//      the h the tile began with (at most 15 FMAs);
//   4. it writes h_t = local_t + P_t * carry. Every input is read once and
//      every output is written once.
// The state between tiles stays in registers. The serial depth of a tile is
// kT steps plus the carry over the segments, not S steps, and a whole served
// first-turn prefill (S <= 256) is one tile. The sums run in another order
// than the serial recurrence (a product of the segment's decays times the
// carry), ~1e-7 relative. One launch per call; nothing is read back to the
// host.
//
// What still holds it back: at B = 1, W = 4096 the 128 blocks are one per
// SM, so the whole card has one round of loads in flight per tile and the
// latency of that round is not hidden by other blocks; at S of a few dozen
// the launch and that one round are most of the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCh = 32;     // channels per block, one per lane
constexpr int kSeg = 16;    // time segments per tile, one per warp
constexpr int kT = 16;      // at most this many steps per segment
constexpr int kMinLen = 4;  // a short tile uses fewer, longer segments

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kCh * kSeg)
rglru_kernel(const TA* __restrict__ log_a, const TB* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ h_all,
             float* __restrict__ hT, int S, int W) {
  __shared__ float sP[kSeg][kCh];  // each segment's product of decays
  __shared__ float sH[kSeg][kCh];  // each segment's local end state
  const int lane = threadIdx.x & 31;
  const int seg = threadIdx.x >> 5;
  const int w = blockIdx.x * kCh + lane;
  const long long bi = blockIdx.y;
  const bool live = w < W;
  const long long base = bi * S * W + w;
  const TA* ap = log_a + base;
  const TB* bp = b + base;
  float* yp = h_all + base;
  const long long ts = W;  // stride of one time step
  float h = live ? h0[bi * W + w] : 0.f;  // the state at the tile's start

  for (int t0 = 0; t0 < S; t0 += kSeg * kT) {
    const int rem = S - t0 < kSeg * kT ? S - t0 : kSeg * kT;
    int nseg = (rem + kMinLen - 1) / kMinLen;  // segments with steps
    if (nseg > kSeg) nseg = kSeg;
    const int len = (rem + nseg - 1) / nseg;  // steps per segment
    const int s0 = t0 + seg * len;
    const int m = t0 + rem - s0;
    const int n = !live || m <= 0 ? 0 : (m < len ? m : len);
    float a[kT], x[kT];
#pragma unroll
    for (int q = 0; q < kT; ++q) {
      if (q < n) {
        a[q] = to_float(ap[(s0 + q) * ts]);
        x[q] = to_float(bp[(s0 + q) * ts]);
      }
    }
    float hl = 0.f, P = 1.f;
#pragma unroll
    for (int q = 0; q < kT; ++q) {
      if (q < n) {
        const float aq = expf(a[q]);
        hl = fmaf(aq, hl, x[q]);
        P *= aq;
        a[q] = P;   // the product of the segment's decays up to q
        x[q] = hl;  // the local state at q
      }
    }
    sP[seg][lane] = P;
    sH[seg][lane] = hl;
    __syncthreads();
    const int before = seg < nseg ? seg : nseg;
    float cin = h;
    for (int s = 0; s < before; ++s)
      cin = fmaf(sP[s][lane], cin, sH[s][lane]);
    float hend = cin;
    for (int s = before; s < nseg; ++s)
      hend = fmaf(sP[s][lane], hend, sH[s][lane]);
#pragma unroll
    for (int q = 0; q < kT; ++q)
      if (q < n) yp[(s0 + q) * ts] = fmaf(a[q], cin, x[q]);
    h = hend;
    __syncthreads();  // sP, sH are rewritten by the next tile
  }
  if (live && seg == 0) hT[bi * W + w] = h;
}

template <typename TA, typename TB>
void launch(const void* log_a, const void* b, const float* h0, float* h_all,
            float* hT, int B, int S, int W, cudaStream_t stream) {
  dim3 grid((W + kCh - 1) / kCh, B);
  rglru_kernel<TA, TB><<<grid, kCh * kSeg, 0, stream>>>(
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
