// K3: the WKV6 recurrence of RWKV6 ("Finch"), written for sm_90a.
//
// Replaces: the Pallas TPU kernel `wkv6_pallas`
// (src/repro/kernels/rwkv6_kernel.py, body `_wkv6_kernel`).
//
// What it computes: for every (sequence b, head h) an (hs x hs) fp32 state S
// in [key i, value j] layout, carried over the tokens t of the prefill:
//
//   y_tj = sum_i r_ti * (S_ij + u_i * k_ti * v_tj)
//   S_ij <- exp(logw_ti) * S_ij + k_ti * v_tj
//
// r, k, v, logw are (B, S, H, hs) — the model's layout, read through strides
// so no transposed copy is made; r, k, v in float32 or bfloat16 (widened to
// fp32 in registers), logw in float32. u is (H, hs) and the state
// (B, H, hs, hs), both float32. y (B, S, H, hs) and the final state are
// written in float32. Any S >= 0 works: there is no chunk multiple and no
// padding (the Pallas kernel needs S % chunk == 0).
//
// What bounds it on the H100: at the main path's shape (B = 1, S = 512,
// H = 40, hs = 64, bf16 r/k/v) it moves ~19.7 MB (r, k, v in bf16, logw and
// y in fp32, the state in and out): ~5.9 us at 3.35 TB/s; it does ~5 fp32
// flops per state element per token, ~0.42 GFLOP: ~6.3 us at 67 TFLOP/s.
// This form is neither: it is serial in t, and with one block per (b, h)
// only B·H = 40 blocks of 64 threads run at B = 1, so its time is the
// latency of S dependent steps, far above that bound.
//
// What the design does: one block per (b, h) with hs threads. Thread j keeps
// column j of S in registers (hs floats) for the whole sequence, so the state
// never leaves the chip between tokens. Tokens go in tiles of kTile: the
// block loads a tile's r, k, v and exp(logw) into shared memory in one pass
// (thread i loads element i of each row, kTile independent loads in flight),
// synchronises once, then runs the tile's steps from shared memory with no
// barrier between tokens. A later PR makes it chunk-parallel, with the
// intra-chunk products on the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;  // tokens staged in shared memory per pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides {  // element strides of a (B, S, H, hs) tensor; hs is unit
  long long b, s, h;
};

template <typename T, int HS>
__global__ void __launch_bounds__(HS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int S, int H,
            Strides rs, Strides ks, Strides vs, Strides ws) {
  __shared__ float sr[kTile][HS];
  __shared__ float sk[kTile][HS];
  __shared__ float sv[kTile][HS];
  __shared__ float sw[kTile][HS];  // exp(logw), the decay itself
  __shared__ float su[HS];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;  // value column this thread owns
  const long long bh = (long long)b * H + h;

  float st[HS];  // column j of the state: st[i] = S[i][j]
  const float* s0p = s0 + bh * HS * HS;
#pragma unroll
  for (int i = 0; i < HS; ++i) st[i] = s0p[i * HS + j];
  su[j] = u[h * HS + j];

  const T* rp = r + b * rs.b + h * rs.h + j;
  const T* kp = k + b * ks.b + h * ks.h + j;
  const T* vp = v + b * vs.b + h * vs.h + j;
  const float* wp = logw + b * ws.b + h * ws.h + j;
  float* yp = y + (bh - h) * S * HS + (long long)h * HS + j;  // (B,S,H,hs)
  const long long y_s = (long long)H * HS;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int n = S - t0 < kTile ? S - t0 : kTile;
    __syncthreads();  // the previous tile's reads are done
    for (int q = 0; q < n; ++q) {
      const long long t = t0 + q;
      sr[q][j] = to_float(rp[t * rs.s]);
      sk[q][j] = to_float(kp[t * ks.s]);
      sv[q][j] = to_float(vp[t * vs.s]);
      sw[q][j] = expf(wp[t * ws.s]);
    }
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      const float vj = sv[q][j];
      float acc = 0.f;    // sum_i r_i S_ij
      float bonus = 0.f;  // sum_i r_i u_i k_i
#pragma unroll
      for (int i = 0; i < HS; ++i) {
        const float ri = sr[q][i];
        const float ki = sk[q][i];
        acc = fmaf(ri, st[i], acc);
        bonus = fmaf(ri, su[i] * ki, bonus);
        st[i] = fmaf(sw[q][i], st[i], ki * vj);
      }
      yp[(t0 + q) * y_s] = fmaf(bonus, vj, acc);
    }
  }
  float* sTp = sT + bh * HS * HS;
#pragma unroll
  for (int i = 0; i < HS; ++i) sTp[i * HS + j] = st[i];
}

template <typename T, int HS>
void launch(const void* r, const void* k, const void* v, const float* logw,
            const float* u, const float* s0, float* y, float* sT, int B,
            int S, int H, Strides rs, Strides ks, Strides vs, Strides ws,
            cudaStream_t stream) {
  dim3 grid(H, B);
  wkv6_kernel<T, HS><<<grid, HS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, y, sT, S, H, rs, ks, vs, ws);
}

template <typename T>
bool dispatch_hs(int hs, const void* r, const void* k, const void* v,
                 const float* logw, const float* u, const float* s0, float* y,
                 float* sT, int B, int S, int H, Strides rs, Strides ks,
                 Strides vs, Strides ws, cudaStream_t stream) {
  switch (hs) {
#define REPRO_HS(n)                                                        \
  case n:                                                                  \
    launch<T, n>(r, k, v, logw, u, s0, y, sT, B, S, H, rs, ks, vs, ws,     \
                 stream);                                                  \
    return true;
    REPRO_HS(16) REPRO_HS(32) REPRO_HS(64)
#undef REPRO_HS
  }
  return false;
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16. strides: 12 element strides,
// (b, s, h) of r, k, v and logw in that order. y and sT are contiguous.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, const void* s0,
                          void* y, void* sT, int B, int S, int H, int hs,
                          const long long* strides, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int a = 0; a < 4; ++a)
    st[a] = Strides{strides[3 * a], strides[3 * a + 1], strides[3 * a + 2]};
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* ss = static_cast<const float*>(s0);
  float* yy = static_cast<float*>(y);
  float* sTT = static_cast<float*>(sT);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == 0)
    ok = dispatch_hs<float>(hs, r, k, v, lw, uu, ss, yy, sTT, B, S, H, st[0],
                            st[1], st[2], st[3], cs);
  else if (dtype == 1)
    ok = dispatch_hs<__nv_bfloat16>(hs, r, k, v, lw, uu, ss, yy, sTT, B, S,
                                    H, st[0], st[1], st[2], st[3], cs);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
