// K3: the WKV6 recurrence of RWKV6 ("Finch"), chunk-parallel, written for
// sm_90a.
//
// Replaces: the Pallas TPU kernel `wkv6_pallas`
// (src/repro/kernels/rwkv6_kernel.py, body `_wkv6_kernel`).
//
// What it computes: for every (sequence b, head h) an (hs x hs) fp32 state S
// in [key i, value j] layout, carried over the tokens t of the prefill:
//
//   y_tj = sum_i r_ti * (S_ij + u_i * k_ti * v_tj)
//   S_ij <- d_ti * S_ij + k_ti * v_tj,      d = exp(logw) in (0, 1]
//
// r, k, v, logw are (B, S, H, hs) — the model's layout, read through strides
// so no transposed copy is made; r, k, v in float32 or bfloat16 (widened to
// fp32 in registers), logw in float32. u is (H, hs) and the state
// (B, H, hs, hs), both float32. y (B, S, H, hs) and the final state are
// written in float32. Any S >= 0 works: the last chunk is ragged and masked,
// there is no padding (the Pallas kernel needs S % chunk == 0).
//
// What bounds it on the H100: at the main path's shape (B = 1, S = 512,
// H = 40, hs = 64, bf16 r/k/v) it moves ~19.7 MB (r, k, v in bf16, logw and
// y in fp32, the state in and out): ~5.9 us at 3.35 TB/s; it does ~5 fp32
// flops per state element per token, ~0.42 GFLOP: ~6.3 us at 67 TFLOP/s.
// At S = 150 the bytes give ~2.0 us. This form issues ~4 fp32 instructions
// per state element per token (the chunk-local pass reads and updates the
// state, the cross-chunk pass reads it again), plus per-key work (bf16
// widening, the bonus, exp, the running products) that each value tile
// repeats.
//
// What the design does: all of S runs at once in chunks of kC = 8 tokens;
// only the state is carried from chunk to chunk, so the serial depth is 8
// token steps plus one elementwise carry step per chunk, not S steps.
// One block per (sequence, head, tile of kVT = 8 value columns): 320 blocks
// at B = 1, H = 40, hs = 64, all resident at once (three a SM in 75 KB of
// shared memory each). Each value tile needs only its own columns of v, S
// and y; r, k and logw are shared with the head's other tiles and come from
// L2 after the first. A block takes the tokens in passes of nch chunks, one
// warp per chunk. Within a warp the (hs x kVT) state tile is spread over
// the lanes: lane (kg, cg) holds kKPL keys (4 at hs = 64) x 4 value
// columns, so a token costs each lane a few vector loads from shared memory
// (its keys of r, k, d and its 4 columns of v). Each pass runs in four
// steps:
//   1. stage: each warp's rows of the pass were copied into shared memory
//      with cp.async during the previous pass (r, k, logw as stored, the
//      tile's columns of v; 16-byte pieces when the rows are 16-byte
//      aligned, else element by element; a ragged chunk's missing rows
//      neutral), so a pass waits on HBM only at the first; it starts the
//      next pass's copies into its second buffer and turns logw into
//      d = exp(logw) in place, once per element;
//   2. chunk-local: each warp runs the recurrence over its chunk from a zero
//      state in registers: the local y partial sums (bonus included), the
//      chunk's contribution dS_c = sum_j k~_j v_j^T, its total decay
//      D_c = prod d and r~_t = r_t (.) prod_{s<t} d_s. Every decay factor is
//      a running product of d, never exp(cum_t - cum_j): the relative error
//      grows with the number of factors, not with |cum| (10^2-10^3 at the
//      full-width init), and a product underflows to 0 rather than
//      overflows, as in the serial recurrence;
//   3. carry: after one barrier each warp folds the carried state through
//      the pass's earlier chunks in its own registers, S <- D_c (.) S + dS_c,
//      to get the state at its chunk's start; the last chunk also writes
//      the state after it, the next pass's carried state (two tiles, so no
//      warp overwrites one another still reads);
//   4. cross-chunk: y_t += r~_t . S_c into the same partial sums, then one
//      transpose-reduce over the key-group lanes (shuffles) leaves a lane 4
//      finished columns of one token, stored as one 16-byte write.
// Arithmetic is fp32 on the CUDA cores: bytes and fp32 arithmetic give about
// the same floor here, and a bf16 or TF32 tensor-core product would round
// r~ and k~, which are not bf16-exact. One launch per call; nothing is read
// back to the host.
//
// What still holds it back: the per-key work and the head's r, k and logw
// are repeated by each of the hs / kVT value tiles (8 at hs = 64, the
// copies from L2); a warp walks its 8 tokens in a dependent chain with few
// warps to hide it (a block is one warp per chunk of a pass); the fold
// gives the last chunk of a pass the most work while the others wait at
// the barrier; and the first pass waits on one round trip to HBM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 8;            // tokens per chunk
constexpr int kVT = 8;           // value columns per block
constexpr int kCPL = 4;          // value columns per lane
constexpr int kCG = kVT / kCPL;  // column groups of a warp
constexpr int kKG = 32 / kCG;    // key groups of a warp
constexpr int kMaxChunks = 12;   // chunks per pass: at most 384 threads
constexpr int kSmemBudget = 75 * 1024;  // three blocks share an SM's 228 KB
static_assert(kKG >= kC, "the transpose-reduce leaves a token per lane");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides {  // element strides of a (B, S, H, hs) tensor; hs is unit
  long long b, s, h;
};

// The state tile in shared memory: lane (kg, cg)'s kKPL x 4 block at
// kg * kKGStride + ii * kVT + cg * 4, padded per key group so the lanes of
// one 16-byte access phase fall in distinct banks.
template <int HS>
struct Tile {
  static constexpr int kKPL = HS / kKG;  // keys per lane
  static constexpr int kKGStride = kKPL * kVT + 4 * kCG;
  static constexpr int kFloats = kKG * kKGStride;
  __device__ static int index(int i, int j) {
    return (i / kKPL) * kKGStride + (i % kKPL) * kVT + j;
  }
};

// Shared memory of one block: per chunk of a pass two staging buffers (r, k
// in their type, logw then d = exp(logw) fp32, v in its type: this pass's
// rows, and the next pass's in flight), r~ [kC][HS], the chunk's state
// contribution (a tile) and its decay [HS]; for the call, the carried tile
// twice (one read in a pass, the other written for the next).
template <typename T, int HS>
struct Smem {
  static constexpr int kR = kC * HS * (int)sizeof(T);  // bytes of r (or k)
  static constexpr int kW = kC * HS * 4;                // logw / d, and r~
  static constexpr int kV = kC * kVT * (int)sizeof(T);
  static constexpr int kStage = 2 * kR + kW + kV;       // one buffer
  static constexpr int kTileB = Tile<HS>::kFloats * 4;
  static constexpr int kRtOff = 2 * kStage;
  static constexpr int kSOff = kRtOff + kW;
  static constexpr int kDOff = kSOff + kTileB;
  static constexpr int kPerChunk = kDOff + HS * 4;
  static constexpr int kFixed = 2 * kTileB;
  static size_t bytes(int nch) { return kFixed + (size_t)nch * kPerChunk; }
  static int max_chunks() {
    const int n = (kSmemBudget - kFixed) / kPerChunk;
    return n < kMaxChunks ? n : kMaxChunks;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// N values of type T from shared memory, widened to fp32 (N * sizeof(T)
// bytes, aligned to that size up to 16).
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float* out) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kPerVec = 16 / (int)sizeof(T);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w) {
      const uint4 x = reinterpret_cast<const uint4*>(p)[w];
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int q = 0; q < kPerVec; ++q) out[w * kPerVec + q] = to_float(e[q]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
    for (int q = 0; q < N; ++q) out[q] = to_float(e[q]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) out[q] = to_float(p[q]);
  }
}

// Copy `rows` rows of `width` elements of type E (row q at src + q * stride
// elements) to dst (dense rows), by the 32 lanes of a warp with cp.async.
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src,
                                           long long stride, int rows,
                                           int width, bool vec16, int lane) {
  if (vec16) {
    constexpr int kPer = 16 / (int)sizeof(E);
    const int pieces = width / kPer;
    for (int p = lane; p < rows * pieces; p += 32) {
      const int q = p / pieces, c = p % pieces;
      cp_async16(dst + q * width + c * kPer, src + q * stride + c * kPer);
    }
  } else if constexpr (sizeof(E) == 4) {
    for (int p = lane; p < rows * width; p += 32) {
      const int q = p / width, c = p % width;
      cp_async4(dst + q * width + c, src + q * stride + c);
    }
  } else {  // 2-byte elements off 16-byte alignment: plain copies
    for (int p = lane; p < rows * width; p += 32) {
      const int q = p / width, c = p % width;
      dst[q * width + c] = src[q * stride + c];
    }
  }
}

template <typename T, int HS>
__global__ void __launch_bounds__(kMaxChunks * 32)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int S, int H,
            int nch, int vec16, Strides rs, Strides ks, Strides vs,
            Strides ws) {
  using M = Smem<T, HS>;
  using TL = Tile<HS>;
  constexpr int KPL = TL::kKPL;
  extern __shared__ uint4 smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_raw);
  float* sRun[2] = {reinterpret_cast<float*>(base),
                    reinterpret_cast<float*>(base + M::kTileB)};

  const int j0 = blockIdx.x * kVT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int c = tid >> 5;     // the chunk of a pass this warp walks
  const int kg = lane / kCG;  // this lane's keys: kg * KPL ...
  const int cg = lane % kCG;  // its columns: cg * 4 ...
  const int blk = kg * TL::kKGStride + cg * kCPL;  // its block in a tile
  const long long bh = (long long)b * H + h;

  auto region = [&](int cc) {
    return base + M::kFixed + (size_t)cc * M::kPerChunk;
  };
  unsigned char* mine = region(c);
  float* crt = reinterpret_cast<float*>(mine + M::kRtOff);  // r~ [kC][HS]
  float* cS = reinterpret_cast<float*>(mine + M::kSOff);    // dS_c tile
  float* cD = reinterpret_cast<float*>(mine + M::kDOff);    // D_c [HS]

  // the carried tile from s0, in flight with the first pass's copies
  const float* s0p = s0 + bh * HS * HS + j0;
  for (int e = tid; e < HS * kVT; e += nthreads) {
    const int i = e / kVT, j = e % kVT;
    cp_async4(sRun[0] + TL::index(i, j), s0p + i * HS + j);
  }
  float uk[KPL];
#pragma unroll
  for (int ii = 0; ii < KPL; ++ii) uk[ii] = u[h * HS + kg * KPL + ii];

  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h + j0;
  const float* wb = logw + b * ws.b + h * ws.h;
  const long long y_s = (long long)H * HS;
  float* yb = y + (long long)b * S * y_s + (long long)h * HS + j0 + cg * kCPL;

  const int Lt = nch * kC;  // tokens per pass
  auto chunk_len = [&](int t0) {  // tokens of this warp's chunk in a pass
    const int m = (S - t0 < Lt ? S - t0 : Lt) - c * kC;
    return m < 0 ? 0 : (m > kC ? kC : m);
  };
  // 1. stage this warp's chunk of the pass at t0 into buffer sb; a ragged
  // chunk's missing rows are neutral (r = k = v = 0, logw = 0: d = 1), so
  // every chunk runs kC steps with no branch between them
  auto stage = [&](int t0, int sb) {
    const int nq = chunk_len(t0);
    if (nq == 0) return;
    unsigned char* buf = mine + sb * M::kStage;
    T* cr = reinterpret_cast<T*>(buf);
    T* ck = reinterpret_cast<T*>(buf + M::kR);
    float* cw = reinterpret_cast<float*>(buf + 2 * M::kR);
    T* cv = reinterpret_cast<T*>(buf + 2 * M::kR + M::kW);
    const int tc = t0 + c * kC;
    stage_rows(cr, rb + tc * rs.s, rs.s, nq, HS, vec16, lane);
    stage_rows(ck, kb + tc * ks.s, ks.s, nq, HS, vec16, lane);
    stage_rows(cw, wb + tc * ws.s, ws.s, nq, HS, vec16, lane);
    stage_rows(cv, vb + tc * vs.s, vs.s, nq, kVT, vec16, lane);
    for (int e = nq * HS + lane; e < kC * HS; e += 32) {
      cr[e] = T(0.f);
      ck[e] = T(0.f);
      cw[e] = 0.f;
    }
    for (int e = nq * kVT + lane; e < kC * kVT; e += 32) cv[e] = T(0.f);
  };

  stage(0, 0);
  int p = 0;  // passes done
  for (int t0 = 0; t0 < S; t0 += Lt, ++p) {
    const int n = S - t0 < Lt ? S - t0 : Lt;
    const int n_live = (n + kC - 1) / kC;
    const int nq = chunk_len(t0);
    const int tc = t0 + c * kC;  // this chunk's first token
    cp_async_wait_all();  // this pass's rows (and, first, the carried tile)
    __syncwarp();
    if (t0 + Lt < S) stage(t0 + Lt, (p + 1) & 1);  // the next pass's rows
    unsigned char* buf = mine + (p & 1) * M::kStage;
    const T* cr = reinterpret_cast<const T*>(buf);
    const T* ck = reinterpret_cast<const T*>(buf + M::kR);
    float* cw = reinterpret_cast<float*>(buf + 2 * M::kR);
    const T* cv = reinterpret_cast<const T*>(buf + 2 * M::kR + M::kW);

    // ---- 2. chunk-local recurrence from a zero state
    float st[KPL][kCPL];  // this lane's block of the state
    float py[kC][kCPL];   // partial y: this lane's keys, its 4 columns
    if (nq > 0) {
      for (int e = lane; e < kC * HS; e += 32) cw[e] = expf(cw[e]);
      __syncwarp();
      float P[KPL];  // running product of d over the chunk so far
#pragma unroll
      for (int ii = 0; ii < KPL; ++ii) {
        P[ii] = 1.f;
#pragma unroll
        for (int jj = 0; jj < kCPL; ++jj) st[ii][jj] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        float rr[KPL], kk[KPL], dd[KPL], vv[kCPL];
        load_f<T, KPL>(cr + q * HS + kg * KPL, rr);
        load_f<T, KPL>(ck + q * HS + kg * KPL, kk);
        load_f<float, KPL>(cw + q * HS + kg * KPL, dd);
        load_f<T, kCPL>(cv + q * kVT + cg * kCPL, vv);
        float bonus = 0.f;
#pragma unroll
        for (int ii = 0; ii < KPL; ++ii)
          bonus = fmaf(rr[ii] * uk[ii], kk[ii], bonus);
#pragma unroll
        for (int jj = 0; jj < kCPL; ++jj) {
          float acc = bonus * vv[jj];
#pragma unroll
          for (int ii = 0; ii < KPL; ++ii) acc = fmaf(rr[ii], st[ii][jj], acc);
          py[q][jj] = acc;
        }
#pragma unroll
        for (int ii = 0; ii < KPL; ++ii) {
          if (cg == 0) crt[q * HS + kg * KPL + ii] = rr[ii] * P[ii];
          P[ii] *= dd[ii];
#pragma unroll
          for (int jj = 0; jj < kCPL; ++jj)
            st[ii][jj] = fmaf(dd[ii], st[ii][jj], kk[ii] * vv[jj]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < KPL; ++ii) {
        *reinterpret_cast<float4*>(cS + blk + ii * kVT) =
            make_float4(st[ii][0], st[ii][1], st[ii][2], st[ii][3]);
        if (cg == 0) cD[kg * KPL + ii] = P[ii];
      }
    }
    __syncthreads();  // every chunk's dS_c and D_c are in shared memory

    if (nq > 0) {
      // ---- 3. the state at this chunk's start: the carried tile, folded
      // through the pass's earlier chunks, S <- D_c (.) S + dS_c; the last
      // chunk also writes the state after it for the next pass
      const float* run_in = sRun[p & 1];
#pragma unroll
      for (int ii = 0; ii < KPL; ++ii) {
        const float4 s4 =
            *reinterpret_cast<const float4*>(run_in + blk + ii * kVT);
        st[ii][0] = s4.x;
        st[ii][1] = s4.y;
        st[ii][2] = s4.z;
        st[ii][3] = s4.w;
      }
      for (int cc = 0; cc <= c; ++cc) {
        float* Sc = reinterpret_cast<float*>(region(cc) + M::kSOff);
        const float* Dc = reinterpret_cast<float*>(region(cc) + M::kDOff);
        if (cc == c) {
          if (c != n_live - 1) break;
          // the last chunk: S_start stays in st, S_end goes to the other
          // carried tile
          float Dk[KPL];
          load_f<float, KPL>(Dc + kg * KPL, Dk);
          float* run_out = sRun[(p + 1) & 1];
#pragma unroll
          for (int ii = 0; ii < KPL; ++ii) {
            const float4 d4 =
                *reinterpret_cast<const float4*>(Sc + blk + ii * kVT);
            *reinterpret_cast<float4*>(run_out + blk + ii * kVT) =
                make_float4(fmaf(Dk[ii], st[ii][0], d4.x),
                            fmaf(Dk[ii], st[ii][1], d4.y),
                            fmaf(Dk[ii], st[ii][2], d4.z),
                            fmaf(Dk[ii], st[ii][3], d4.w));
          }
          break;
        }
        float Dk[KPL];
        load_f<float, KPL>(Dc + kg * KPL, Dk);
#pragma unroll
        for (int ii = 0; ii < KPL; ++ii) {
          const float4 d4 =
              *reinterpret_cast<const float4*>(Sc + blk + ii * kVT);
          st[ii][0] = fmaf(Dk[ii], st[ii][0], d4.x);
          st[ii][1] = fmaf(Dk[ii], st[ii][1], d4.y);
          st[ii][2] = fmaf(Dk[ii], st[ii][2], d4.z);
          st[ii][3] = fmaf(Dk[ii], st[ii][3], d4.w);
        }
      }

      // ---- 4. cross-chunk term, then the reduction over key groups
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        float rt[KPL];
        load_f<float, KPL>(crt + q * HS + kg * KPL, rt);
#pragma unroll
        for (int jj = 0; jj < kCPL; ++jj) {
          float acc = py[q][jj];
#pragma unroll
          for (int ii = 0; ii < KPL; ++ii)
            acc = fmaf(rt[ii], st[ii][jj], acc);
          py[q][jj] = acc;
        }
      }
      // transpose-reduce over the key-group bits of the lane, highest
      // first: each exchange halves the tokens a lane keeps until one is
      // left; any further key-group bit plain-adds
      float* flat = &py[0][0];
#pragma unroll
      for (int o = 16, m = kC * kCPL; o >= kCG; o >>= 1) {
        if (m > kCPL) {
          const bool upper = lane & o;
          m >>= 1;
#pragma unroll
          for (int x = 0; x < kC * kCPL / 2; ++x) {
            if (x < m) {
              const float send = upper ? flat[x] : flat[x + m];
              const float keep = upper ? flat[x + m] : flat[x];
              flat[x] = keep + __shfl_xor_sync(0xffffffffu, send, o);
            }
          }
        } else {
#pragma unroll
          for (int x = 0; x < kCPL; ++x)
            flat[x] += __shfl_xor_sync(0xffffffffu, flat[x], o);
        }
      }
      // this lane's token: the key-group bits that chose the halves
      const int tq = kg / (kKG / kC);
      if (kg % (kKG / kC) == 0 && tq < nq)
        *reinterpret_cast<float4*>(yb + (long long)(tc + tq) * y_s) =
            make_float4(flat[0], flat[1], flat[2], flat[3]);
    }
    __syncthreads();  // before the next pass overwrites dS_c and D_c
  }
  cp_async_wait_all();  // S == 0: the tile copy still has to land
  __syncthreads();
  const float* fin = sRun[p & 1];
  float* sTp = sT + bh * HS * HS + j0;
  for (int e = tid; e < HS * kVT; e += nthreads) {
    const int i = e / kVT, j = e % kVT;
    sTp[i * HS + j] = fin[TL::index(i, j)];
  }
}

template <typename T, int HS>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* y, float* sT, int B, int S,
           int H, Strides rs, Strides ks, Strides vs, Strides ws,
           cudaStream_t stream) {
  using M = Smem<T, HS>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<T, HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)M::bytes(M::max_chunks()));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // 16-byte copies need every row of r, k, v, logw on a 16-byte boundary
  auto aligned = [](const void* p, const Strides& s, long long esz) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * esz) % 16 == 0 &&
           (s.s * esz) % 16 == 0 && (s.h * esz) % 16 == 0;
  };
  const int vec16 = aligned(r, rs, sizeof(T)) && aligned(k, ks, sizeof(T)) &&
                    aligned(v, vs, sizeof(T)) && aligned(logw, ws, 4);
  // as few passes as the shared memory allows, the chunks spread evenly
  const int n_chunks = (S + kC - 1) / kC;
  const int cap = M::max_chunks();
  const int passes = n_chunks > 0 ? (n_chunks + cap - 1) / cap : 1;
  const int nch = n_chunks > 0 ? (n_chunks + passes - 1) / passes : 1;
  dim3 grid(HS / kVT, H, B);
  wkv6_kernel<T, HS><<<grid, nch * 32, M::bytes(nch), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, y, sT, S, H, nch, vec16, rs, ks,
      vs, ws);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hs(int hs, const void* r, const void* k, const void* v,
                const float* logw, const float* u, const float* s0, float* y,
                float* sT, int B, int S, int H, Strides rs, Strides ks,
                Strides vs, Strides ws, cudaStream_t stream) {
  switch (hs) {
#define REPRO_HS(n)                                                         \
  case n:                                                                   \
    return launch<T, n>(r, k, v, logw, u, s0, y, sT, B, S, H, rs, ks, vs,   \
                        ws, stream);
    REPRO_HS(16) REPRO_HS(32) REPRO_HS(64)
#undef REPRO_HS
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16. strides: 12 element strides,
// (b, s, h) of r, k, v and logw in that order. u, s0, y and sT are
// contiguous. Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a shape it does not take).
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, const void* s0,
                          void* y, void* sT, int B, int S, int H, int hs,
                          const long long* strides, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S < 0)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int a = 0; a < 4; ++a)
    st[a] = Strides{strides[3 * a], strides[3 * a + 1], strides[3 * a + 2]};
  const float* lw = static_cast<const float*>(logw);
  const float* uu = static_cast<const float*>(u);
  const float* ss = static_cast<const float*>(s0);
  float* yy = static_cast<float*>(y);
  float* sTT = static_cast<float*>(sT);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hs<float>(hs, r, k, v, lw, uu, ss, yy, sTT, B, S, H,
                              st[0], st[1], st[2], st[3], cs);
  if (dtype == 1)
    return dispatch_hs<__nv_bfloat16>(hs, r, k, v, lw, uu, ss, yy, sTT, B,
                                      S, H, st[0], st[1], st[2], st[3], cs);
  return (int)cudaErrorInvalidValue;
}
