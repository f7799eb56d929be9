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
// to keys j > i - window. The softmax is online in fp32 over key tiles, with
// a finite sentinel (-1e30, so a row with no key gives 0, never NaN), and the
// sum is normalised by max(l, 1e-20), as the Pallas kernel does. S need not
// be a multiple of any tile: the ragged last query tile and key tile are
// masked here, so every fresh turn-1 prefill can use the kernel.
//
// What bounds it on the H100: q, k, v and the output are read or written
// once (~6 MB at S = 512 with qwen3-0.6b's heads), against ~2·B·H·S²·D
// causal flops. In bf16 the bytes bound it up to S of ~900 at those heads
// (3.35 TB/s of HBM), the tensor cores (989 TFLOP/s) beyond; in fp32 the
// CUDA cores (67 TFLOP/s) bound it from S of ~100. Coming near either needs
// the tensor cores, tiles big enough to reuse K/V from shared memory, and
// loads that overlap the arithmetic.
//
// bf16, the served path — a FlashAttention-2-style kernel on the tensor
// cores: one block of 4 warps per (64-row query tile, query head, sequence),
// each warp owning 16 query rows. The Q tile is copied to shared memory once
// and, up to D = 160, kept in registers as `mma` A-fragments. 64-key K and V
// tiles stream through a double buffer in shared memory with `cp.async`
// (16-byte copies,
// zero-filled past S), so tile j+1 loads while tile j computes. Q·Kᵀ and P·V
// are `mma.sync.m16n8k16` bf16 products with fp32 accumulators, fed through
// `ldmatrix` (V through `ldmatrix.trans`); shared-memory rows are padded by
// 16 bytes so that `ldmatrix` is free of bank conflicts. The online softmax
// runs on the accumulator fragments (row max and sum across the quad of
// lanes that share a row, in base 2). P is rounded to bf16 in registers to
// become the A-fragments of P·V, as the Pallas kernel rounds it. Only tiles
// that cross the diagonal, the ragged end or the window start are masked;
// tiles wholly above the diagonal or before the window are never loaded. The
// query tiles run in reverse, so the heaviest causal tiles start first. The
// output tile is staged through shared memory and written with 16-byte
// stores. At D = 240 (gemma3-12b's global layers) a warp's O accumulators
// alone take 120 registers, so Q stays in shared memory and is read per
// k-step, and the K/V tiles hold 32 keys (`MmaShape`); the double-buffered
// tiles and Q take 107,520 B of shared memory at D = 160 (stablelm-12b) and
// 95,232 B at D = 240, so two blocks fit an SM, as at D = 128.
// Not done yet: `wgmma` on warpgroups and TMA loads with `mbarrier`s (the
// full tensor-core rate), and a persistent grid.
//
// The append instance (`append_mma_kernel` and `append_combine_kernel`,
// further down, with its own note): an append's queries against the slot's
// cached prefix and then the new keys, bf16 on the same tensor-core tile
// loop, split over fixed ranges of the prefix and merged by a combine pass.
//
// fp32, the parity path: the CUDA-core kernel of the first port, one block
// per (64-row query tile, head, sequence), two threads per query row (four
// past D = 128), K/V tiles of 32 rows (16 at D = 240) widened in shared
// memory, products in fp32 (TF32 would miss the fp32 tolerance of 2e-5).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1e30f;

// --------------------------------------------------------------------------
// fp32: the CUDA-core kernel
// --------------------------------------------------------------------------
constexpr int kF32BlockQ = 64;   // query rows per block

// threads per query row and keys per shared-memory tile: 2 threads and 32
// keys up to D = 128; past it 4 threads (a thread's query and accumulator
// elements stay at D / 4, so nothing spills) and, at D = 240, 16 keys (two
// fp32 tiles of 32 x 240 would pass the 48 KB of static shared memory)
template <int D>
struct F32Shape {
  static constexpr int TPR = D <= 128 ? 2 : 4;
  static constexpr int BK = D <= 160 ? 32 : 16;
  static constexpr int THREADS = TPR * kF32BlockQ;
};

template <int D>
__global__ void __launch_bounds__(F32Shape<D>::THREADS)
prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int S, int H, int Hkv, int window, float scale) {
  constexpr int TPR = F32Shape<D>::TPR, BK = F32Shape<D>::BK;
  constexpr int THREADS = F32Shape<D>::THREADS;
  constexpr int PART = D / TPR;  // elements d = TPR * i + part of a thread
  const int q_lo = blockIdx.x * kF32BlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int r = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int qpos = q_lo + r;
  const bool row_ok = qpos < S;

  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const long long q_row = (long long)H * D;
  const long long kv_row = (long long)Hkv * D;
  float qr[PART], acc[PART];
  const float* qp = q + ((long long)b * S + (row_ok ? qpos : 0)) * q_row +
                    (long long)h * D;
#pragma unroll
  for (int i = 0; i < PART; ++i) {
    qr[i] = row_ok ? qp[TPR * i + part] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys any row of this tile can see: causal end, window start
  const int q_hi = min(q_lo + kF32BlockQ, S) - 1;
  const int k_end = q_hi + 1;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_lo - window + 1);
  k_begin = (k_begin / BK) * BK;

  const float* kb = k + (long long)b * S * kv_row + (long long)hk * D;
  const float* vb = v + (long long)b * S * kv_row + (long long)hk * D;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const int j = idx / D;
      const int d = idx % D;
      const int kp = k0 + j;
      float kv_k = 0.f, kv_v = 0.f;
      if (kp < S) {
        kv_k = kb[kp * kv_row + d];
        kv_v = vb[kp * kv_row + d];
      }
      ks[j][d] = kv_k;
      vs[j][d] = kv_v;
    }
    __syncthreads();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < PART; ++i) dot += qr[i] * ks[j][TPR * i + part];
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)  // the threads of one row
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kp = k0 + j;
      const bool ok = kp <= qpos && (window == 0 || kp > qpos - window);
      s[j] = ok ? dot * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < PART; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j] > 0.5f * kNegInf ? expf(s[j] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int i = 0; i < PART; ++i) acc[i] += p * vs[j][TPR * i + part];
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (!row_ok) return;
  float* op = out + ((long long)b * S + qpos) * q_row + (long long)h * D;
  const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
  for (int i = 0; i < PART; ++i) op[TPR * i + part] = acc[i] * inv;
}

// --------------------------------------------------------------------------
// bf16: the tensor-core kernel
// --------------------------------------------------------------------------
constexpr int kBlockQ = 64;  // query rows per block, 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;      // bf16 elements of padding per shared row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, bypassing L1; zero-filled when !ok (the
// source is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a · b on one 16x8x16 tile: a row-major (4 regs of bf16 pairs), b
// column-major (2 regs), c fp32 (4 regs)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Up to D = 160 a warp keeps its Q tile in registers as A-fragments and
// streams 64-key tiles (ptxas: 182 registers at D = 128, 244 at D = 160, no
// spill). At D = 240 the registers would not hold Q's 15 x 4 and O's 30 x 4
// beside the scores: Q is read from shared memory at each k-step instead
// (QREG false) and the key tiles shrink to 32 (BK), which also halves the
// scores' and P's fragments (234 registers, no spill).
template <int D>
struct MmaShape {
  static constexpr bool QREG = D <= 160;      // Q fragments in registers
  static constexpr int BK = D <= 160 ? 64 : 32;  // keys per K/V tile
  static constexpr int LD = D + kPad;         // shared row stride, elements
  static constexpr int CPR = D / 8;           // 16-byte chunks per row
  static constexpr int KC = D / 16;           // k-steps of Q·Kᵀ
  static constexpr int NT = D / 8;            // n-tiles of the output
  static constexpr int SMEM =                 // Q + 2 x (K, V) tiles
      (kBlockQ + 4 * BK) * LD * (int)sizeof(__nv_bfloat16);
  static_assert(D % 16 == 0, "k-steps of 16");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int S, int H, int Hkv,
                   int window, float scale_log2) {
  using Sh = MmaShape<D>;
  constexpr int LD = Sh::LD, CPR = Sh::CPR, KC = Sh::KC, NT = Sh::NT;
  constexpr int BK = Sh::BK;
  constexpr bool QREG = Sh::QREG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kBlockQ * LD;       // [2][BK][LD]
  __nv_bfloat16* sv = sk + 2 * BK * LD;   // [2][BK][LD]

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // row of the fragment (and row + 8)
  const int tq = lane & 3;   // column pair of the fragment

  const long long q_row = (long long)H * D;
  const long long kv_row = (long long)Hkv * D;
  const __nv_bfloat16* qb = q + (long long)b * S * q_row + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * S * kv_row + (long long)hk * D;
  const __nv_bfloat16* vb = v + (long long)b * S * kv_row + (long long)hk * D;

  // keys any row of this tile can see: causal end, window start
  const int q_hi = min(q_lo + kBlockQ, S) - 1;
  int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = (q_hi + 1 - k_begin + BK - 1) / BK;

  for (int c = tid; c < kBlockQ * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    const int pos = q_lo + r;
    cp_async16(sq + r * LD + cc * 8,
               qb + (long long)(pos < S ? pos : 0) * q_row + cc * 8, pos < S);
  }
  auto load_kv = [&](int tile, int buf) {
    const int k0 = k_begin + tile * BK;
    __nv_bfloat16* dk = sk + buf * BK * LD;
    __nv_bfloat16* dv = sv + buf * BK * LD;
    for (int c = tid; c < BK * CPR; c += kThreads) {
      const int r = c / CPR, cc = c % CPR;
      const int pos = k0 + r;
      const long long off = (long long)(pos < S ? pos : 0) * kv_row + cc * 8;
      cp_async16(dk + r * LD + cc * 8, kb + off, pos < S);
      cp_async16(dv + r * LD + cc * 8, vb + off, pos < S);
    }
  };
  // the warp's 16 query rows, k-step kc, as an A-fragment
  auto load_q = [&](uint32_t(&a)[4], int kc) {
    ldmatrix_x4(a, sq + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                            LD + kc * 16 + (lane >> 4) * 8);
  };
  load_kv(0, 0);
  cp_async_commit();  // group 0: the Q tile and K/V tile 0

  uint32_t qf[QREG ? KC : 1][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;  // rows g and g + 8, base-2 units
  float l_lo = 0.f, l_hi = 0.f;          // this lane's share of the row sums
  const int row_lo = q_lo + warp * 16 + g;
  const int row_hi = row_lo + 8;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed, t + 1 is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (t == 0) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) load_q(qf[kc], kc);
      }
    }
    const __nv_bfloat16* kt = sk + (t & 1) * BK * LD;
    const __nv_bfloat16* vt = sv + (t & 1) * BK * LD;

    // S = Q·Kᵀ: 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
      } else {
        load_q(a, kc);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kc * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale to base-2 units; mask only the tiles that need it
    const int k0 = k_begin + t * BK;
    const bool need_mask = k0 + BK - 1 > q_lo || k0 + BK > S ||
                           (window > 0 && k0 <= q_lo + kBlockQ - 1 - window);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (need_mask) {
          const int j = k0 + n * 8 + 2 * tq + (e & 1);
          const int i = e < 2 ? row_lo : row_hi;
          const bool ok = j <= i && j < S && (window == 0 || j > i - window);
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {  // the quad that shares a row
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float c_lo = exp2f(m_lo - mx_lo);
    const float c_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= c_lo;
      o[n][1] *= c_lo;
      o[n][2] *= c_hi;
      o[n][3] *= c_hi;
    }
    // P in bf16 as the A-fragments of P·V: k-step kc covers n-tiles 2kc and
    // 2kc + 1 (the accumulator layout of S is the operand layout of P)
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mx = e < 2 ? mx_lo : mx_hi;
        p[e] = s[n][e] > 0.5f * kNegInf ? exp2f(s[n][e] - mx) : 0.f;
      }
      l_lo += p[0] + p[1];
      l_hi += p[2] + p[3];
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P·V: V through ldmatrix.trans, 16 output columns per load
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kc * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa[kc], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa[kc], bv[2], bv[3]);
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration
  }

  // normalise, stage the warp's 16 rows in the (now free) Q tile, and write
  // them with 16-byte stores
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-20f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-20f);
  __nv_bfloat16* so = sq + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(so + g * LD + n * 8 + 2 * tq) =
        pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + n * 8 + 2 * tq) =
        pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
  }
  __syncwarp();
  __nv_bfloat16* ob = out + (long long)b * S * q_row + (long long)h * D;
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, cc = c % CPR;
    const int pos = q_lo + warp * 16 + r;
    if (pos < S)
      *reinterpret_cast<uint4*>(ob + (long long)pos * q_row + cc * 8) =
          *reinterpret_cast<const uint4*>(so + r * LD + cc * 8);
  }
}

// ---- K2's append instance ---------------------------------------------------
//
// Replaces no Pallas kernel: the JAX package attends an append's queries
// to the slot's prefix in jnp ops that XLA fuses. It was added because the
// port did the same in a Python loop of float32 torch ops (`_repeat_kv`
// copies of the prefix, then 256 x 512 chunk pairs of einsums and
// elementwise passes, some twenty small kernels a pair): on qwen3-0.6b an
// append of a ~300-token tool result on a ~16.5k-row prefix took ~290 ms,
// about half of each decoder's clock in the SWE-agent cell, against a
// bound of ~2 ms for its 28 layers' attention.
//
// What it computes: q (B, S, H, D) against the slot's prefix k, v (B, P,
// Hkv, D), rows at or past kv_lens[b] (read on the device) masked, and then
// the S new keys k_new, v_new (B, S, Hkv, D), causal (new key j is seen by
// query i iff j <= i). RoPE and qk-norm are the caller's. The prefix's live
// rows all precede the new tokens, so no prefix row is causally masked.
//
// What bounds it: at S = 512 on a 16k-row prefix the tensor cores do ~2·S
// flops for each K/V byte, several times the card's ridge of ~295: the
// bf16 flops of Q·Kᵀ and P·V, 4·H·D·S·(P + S/2), bound it (~69 GFLOP a
// layer at qwen3-0.6b's heads, 70 us at 989 TFLOP/s).
//
// What the design does about it:
// - K2's tensor-core tile loop as it is (the pieces below): 64 query rows
//   a block, 16 a warp, 64-key K/V tiles streamed through a cp.async double
//   buffer, mma.sync bf16 with fp32 accumulators and the online softmax on
//   the fragments, P rounded to bf16 before P·V.
// - GQA packed into the rows: a KV head's G query heads at one position are
//   G neighbouring rows of the tile (row r is position r / G, head r % G),
//   so each K/V tile is loaded once for all G heads and nothing is
//   expanded. The Q rows of one position are contiguous in q.
// - A fixed split: the prefix, and the new keys, are cut into ranges of
//   kAppendSplit rows, one block each, so a 16k prefix at S = 512 and G = 2
//   is ~17 x 16 x 8 blocks, not the 128 blocks of an unsplit grid on 132
//   SMs. A range that starts at or past the live length exits at once, and
//   its K/V is never fetched; rows past kv_len load as zeros. The blocks of
//   one range run side by side (the query tile is the fastest grid axis),
//   so a K/V tile is fetched from HBM about once and then read from L2.
// - Each block writes (m, l, unnormalised O) in fp32 scratch, and
//   append_combine_kernel merges the ranges in a fixed order: the live
//   prefix ranges, then the new ones a row can see. The partition depends
//   on row indices alone, never on P, so a prefix trimmed to its ctx
//   bucket and the whole max_ctx buffer give the same bytes.
// - It reads kv_len on the device, launches on the caller's stream and
//   allocates nothing (the wrapper allocates the scratch), so one CUDA graph
//   per (pad_to, ctx) serves any slot and prefix.
constexpr int kAppendSplit = 1024;  // K/V rows a block reads at most

// ---- the pieces of K2's append instance ------------------------------------
// prefill_mma_kernel's tile loop cut into functions: the same loads, the
// same products and the same online softmax. K2 keeps its loop inline: built
// from these pieces it took 168 registers instead of 182 at D = 128 and ran
// 2-6% slower at S = 200-1024 (one call on the H100).

// The warp's 16 query rows of the block's Q tile (in shared memory), k-step
// kc, as an A-fragment
template <int D>
__device__ __forceinline__ void load_q_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* sq, int kc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ldmatrix_x4(a, sq + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          MmaShape<D>::LD + kc * 16 + (lane >> 4) * 8);
}

// K and V rows [k0, k0 + BK) of one KV head (row stride `row` elements) into
// one buffer of the double buffer, 16-byte cp.async copies; rows at or past
// `limit` are zero-filled and not read
template <int D>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* dk,
                                             __nv_bfloat16* dv,
                                             const __nv_bfloat16* kb,
                                             const __nv_bfloat16* vb,
                                             long long row, int k0,
                                             int limit) {
  using Sh = MmaShape<D>;
  for (int c = threadIdx.x; c < Sh::BK * Sh::CPR; c += kThreads) {
    const int r = c / Sh::CPR, cc = c % Sh::CPR;
    const int pos = k0 + r;
    const long long off = (long long)(pos < limit ? pos : 0) * row + cc * 8;
    cp_async16(dk + r * Sh::LD + cc * 8, kb + off, pos < limit);
    cp_async16(dv + r * Sh::LD + cc * 8, vb + off, pos < limit);
  }
}

// The K/V loop of one block: tile 0 is in flight (committed with the Q
// tile), tile t + 1 loads into the other buffer while `step(t, k, v)` runs
// on tile t
template <int D, class Load, class Step>
__device__ __forceinline__ void kv_pipeline(int n_tiles, __nv_bfloat16* sk,
                                            __nv_bfloat16* sv, Load load,
                                            Step step) {
  constexpr int TILE = MmaShape<D>::BK * MmaShape<D>::LD;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed, t + 1 is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    step(t, sk + (t & 1) * TILE, sv + (t & 1) * TILE);
    __syncthreads();  // this buffer is refilled by the next iteration
  }
}

// The flash state of a warp's 16 query rows: O accumulators, and per row
// (g and g + 8 of the fragment) the running max in base-2 units and this
// lane's share of the row sum
template <int D>
struct FlashRows {
  float o[MmaShape<D>::NT][4];
  float m_lo, m_hi, l_lo, l_hi;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < MmaShape<D>::NT; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m_lo = m_hi = kNegInf;
    l_lo = l_hi = 0.f;
  }

  // the whole row sums, summed over the quad of lanes that share a row
  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
  }
};

// One K/V tile for the warp's rows: S = Q·Kᵀ on the tensor cores, scaled to
// base-2 units, masked where `need_mask` by ok(j, hi) (key j against row g,
// or row g + 8 when hi), the online softmax on the fragments, P rounded to
// bf16, O += P·V. Q comes from the registers `qf` (QREG) or shared memory.
template <int D, class Ok>
__device__ __forceinline__ void attend_tile(
    FlashRows<D>& st,
    const uint32_t (&qf)[MmaShape<D>::QREG ? MmaShape<D>::KC : 1][4],
    const __nv_bfloat16* sq, const __nv_bfloat16* kt,
    const __nv_bfloat16* vt, int k0, bool need_mask, Ok ok,
    float scale_log2) {
  using Sh = MmaShape<D>;
  constexpr int LD = Sh::LD, KC = Sh::KC, NT = Sh::NT, BK = Sh::BK;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;  // column pair of the fragment

  // S = Q·Kᵀ: BK / 8 n-tiles of 8 keys
  float s[BK / 8][4];
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
    if constexpr (Sh::QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kc][e];
    } else {
      load_q_frag<D>(a, sq, kc);
    }
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          kc * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
    }
  }

  // scale to base-2 units; mask only the tiles that need it
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * scale_log2;
      if (need_mask) x = ok(k0 + n * 8 + 2 * tq + (e & 1), e >= 2) ? x : kNegInf;
      s[n][e] = x;
    }
  }

  // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (e = 2, 3)
  float mx_lo = st.m_lo, mx_hi = st.m_hi;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // the quad that shares a row
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float c_lo = exp2f(st.m_lo - mx_lo);
  const float c_hi = exp2f(st.m_hi - mx_hi);
  st.m_lo = mx_lo;
  st.m_hi = mx_hi;
  st.l_lo *= c_lo;
  st.l_hi *= c_hi;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    st.o[n][0] *= c_lo;
    st.o[n][1] *= c_lo;
    st.o[n][2] *= c_hi;
    st.o[n][3] *= c_hi;
  }
  // P in bf16 as the A-fragments of P·V: k-step kc covers n-tiles 2kc and
  // 2kc + 1 (the accumulator layout of S is the operand layout of P)
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mx = e < 2 ? mx_lo : mx_hi;
      p[e] = s[n][e] > 0.5f * kNegInf ? exp2f(s[n][e] - mx) : 0.f;
    }
    st.l_lo += p[0] + p[1];
    st.l_hi += p[2] + p[3];
    pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }

  // O += P·V: V through ldmatrix.trans, 16 output columns per load
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vt + (kc * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * LD +
                                dp * 16 + (lane >> 4) * 8);
      mma_bf16(st.o[2 * dp], pa[kc], bv[0], bv[1]);
      mma_bf16(st.o[2 * dp + 1], pa[kc], bv[2], bv[3]);
    }
  }
}


template <int D>
__global__ void __launch_bounds__(kThreads)
append_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kp,
                  const __nv_bfloat16* __restrict__ vp,
                  const __nv_bfloat16* __restrict__ kn,
                  const __nv_bfloat16* __restrict__ vn,
                  const int* __restrict__ kv_lens, float* __restrict__ part_o,
                  float* __restrict__ part_ml, int B, int S, int P, int H,
                  int Hkv, long long prefix_bstride, int n_prefix,
                  float scale_log2) {
  using Sh = MmaShape<D>;
  constexpr int LD = Sh::LD, CPR = Sh::CPR, KC = Sh::KC, NT = Sh::NT;
  constexpr int BK = Sh::BK;
  static_assert(kAppendSplit % BK == 0, "tiles never cross a range's end");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + kBlockQ * LD;  // [2][BK][LD]
  __nv_bfloat16* sv = sk + 2 * BK * LD;   // [2][BK][LD]

  const int G = H / Hkv;
  const int rows = S * G;  // (position, head of the group) rows of a KV head
  const int r0 = blockIdx.x * kBlockQ;
  const int split = blockIdx.y;
  const int b = blockIdx.z / Hkv;
  const int hk = blockIdx.z % Hkv;
  const bool is_new = split >= n_prefix;
  const int pos_first = r0 / G;
  const int pos_last = (min(r0 + kBlockQ, rows) - 1) / G;

  // this block's keys [k_lo, k_hi): live prefix rows, or new rows up to the
  // last position of the tile
  const int live = is_new ? S : min(max(kv_lens[b], 0), P);
  const int k_lo = (is_new ? split - n_prefix : split) * kAppendSplit;
  const int k_hi = min(min(k_lo + kAppendSplit, live),
                       is_new ? pos_last + 1 : live);
  if (k_hi <= k_lo) return;  // nothing live here: the combine skips it
  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const long long kv_row = (long long)Hkv * D;
  const __nv_bfloat16* kb =
      (is_new ? kn + (long long)b * S * kv_row : kp + b * prefix_bstride) +
      (long long)hk * D;
  const __nv_bfloat16* vb =
      (is_new ? vn + (long long)b * S * kv_row : vp + b * prefix_bstride) +
      (long long)hk * D;
  // q's row of tile row r: position (r0 + r) / G, head hk·G + (r0 + r) % G
  auto q_off = [&](int rf) {
    return (((long long)b * S + rf / G) * H + (long long)hk * G + rf % G) * D;
  };

  for (int c = tid; c < kBlockQ * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    const bool ok = r0 + r < rows;
    cp_async16(sq + r * LD + cc * 8, q + (ok ? q_off(r0 + r) : 0) + cc * 8,
               ok);
  }
  auto load = [&](int tile, int buf) {
    load_kv_tile<D>(sk + buf * BK * LD, sv + buf * BK * LD, kb, vb, kv_row,
                    k_lo + tile * BK, live);
  };
  load(0, 0);
  cp_async_commit();  // group 0: the Q tile and K/V tile 0

  uint32_t qf[Sh::QREG ? KC : 1][4];
  FlashRows<D> st;
  st.init();
  const int rf_lo = r0 + warp * 16 + g;
  const int pos_lo = rf_lo / G;
  const int pos_hi = (rf_lo + 8) / G;

  kv_pipeline<D>(n_tiles, sk, sv, load, [&](int t, const __nv_bfloat16* kt,
                                            const __nv_bfloat16* vt) {
    if constexpr (Sh::QREG) {
      if (t == 0) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) load_q_frag<D>(qf[kc], sq, kc);
      }
    }
    const int k0 = k_lo + t * BK;
    const bool need_mask = is_new ? k0 + BK - 1 > pos_first : k0 + BK > live;
    attend_tile<D>(st, qf, sq, kt, vt, k0, need_mask,
                   [&](int j, bool hi) {
                     return is_new ? j <= (hi ? pos_hi : pos_lo) : j < live;
                   },
                   scale_log2);
  });

  // the partial state of each live row: O unnormalised, (m, l) beside it
  st.reduce_l();
  const long long split_rows = (long long)B * S * H;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rf = rf_lo + 8 * half;
    if (rf >= rows) continue;
    const long long idx = split * split_rows +
                          ((long long)b * S + rf / G) * H + hk * G + rf % G;
    float* po = part_o + idx * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(po + n * 8 + 2 * tq) =
          make_float2(st.o[n][2 * half], st.o[n][2 * half + 1]);
    if (tq == 0)
      *reinterpret_cast<float2*>(part_ml + 2 * idx) =
          half ? make_float2(st.m_hi, st.l_hi) : make_float2(st.m_lo, st.l_lo);
  }
}

// Merges the ranges of append_mma_kernel, one warp per output row (b, i, h):
// the live prefix ranges in order, then the new ranges that start at or
// before position i, each weighted by 2^(m - max m); 16-byte reads of O
template <int D>
__global__ void __launch_bounds__(kThreads)
append_combine_kernel(const float* __restrict__ part_o,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ kv_lens,
                      __nv_bfloat16* __restrict__ out, int B, int S, int P,
                      int H, int n_prefix) {
  constexpr int C4 = D / 4;             // float4 pieces of a row
  constexpr int PER = (C4 + 31) / 32;   // pieces a lane holds
  const long long split_rows = (long long)B * S * H;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= split_rows) return;
  const int lane = threadIdx.x & 31;
  const int b = (int)(row / ((long long)S * H));
  const int pos = (int)((row / H) % S);
  const int live = min(max(kv_lens[b], 0), P);
  const int n_live = (live + kAppendSplit - 1) / kAppendSplit;
  const int n = n_live + pos / kAppendSplit + 1;
  auto at = [&](int i) {  // the i-th range this row merges
    return (long long)(i < n_live ? i : n_prefix + i - n_live) * split_rows +
           row;
  };
  float mx = kNegInf;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, part_ml[2 * at(i)]);
  float l = 0.f;
  float4 acc[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const long long idx = at(i);
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * idx);
    const float w = exp2f(ml.x - mx);
    l += w * ml.y;
    const float4* po = reinterpret_cast<const float4*>(part_o + idx * D);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = lane + 32 * p;
      if (c < C4) {
        const float4 x = po[c];
        acc[p].x += w * x.x;
        acc[p].y += w * x.y;
        acc[p].z += w * x.z;
        acc[p].w += w * x.w;
      }
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-20f);
  __nv_bfloat16* ob = out + row * D;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int c = lane + 32 * p;
    if (c < C4)
      *reinterpret_cast<uint2*>(ob + 4 * c) =
          make_uint2(pack_bf16(acc[p].x * inv, acc[p].y * inv),
                     pack_bf16(acc[p].z * inv, acc[p].w * inv));
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int S, int H, int Hkv, int window, float scale,
                       cudaStream_t stream) {
  dim3 grid((S + kF32BlockQ - 1) / kF32BlockQ, H, B);
  prefill_f32_kernel<D><<<grid, F32Shape<D>::THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, Hkv,
      window, scale);
  return cudaGetLastError();
}

// Lets a tensor-core kernel take its dynamic shared memory (above the
// default 48 KB at D = 128): set once per device in `done`, since the
// attribute is held by each device's context, and retried while it fails.
constexpr int kMaxDevices = 64;

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem,
                       std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && cached)
    done[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int B, int S, int H, int Hkv, int window, float scale,
                       cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  constexpr int smem = MmaShape<D>::SMEM;
  const cudaError_t attr = allow_smem(prefill_mma_kernel<D>, smem, done);
  if (attr != cudaSuccess) return attr;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  prefill_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, H, Hkv, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_append(const void* q, const void* kp, const void* vp,
                          const void* kn, const void* vn, const int* kv_lens,
                          void* out, float* scratch, int B, int S, int P,
                          int H, int Hkv, long long prefix_bstride,
                          float scale, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  constexpr int smem = MmaShape<D>::SMEM;
  const cudaError_t attr = allow_smem(append_mma_kernel<D>, smem, done);
  if (attr != cudaSuccess) return attr;
  const int n_prefix = (P + kAppendSplit - 1) / kAppendSplit;
  const int n_split = n_prefix + (S + kAppendSplit - 1) / kAppendSplit;
  const long long split_rows = (long long)B * S * H;
  float* part_ml = scratch + n_split * split_rows * D;
  const int G = H / Hkv;
  dim3 grid((S * G + kBlockQ - 1) / kBlockQ, n_split, B * Hkv);
  append_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp),
      static_cast<const __nv_bfloat16*>(kn),
      static_cast<const __nv_bfloat16*>(vn), kv_lens, scratch, part_ml, B, S,
      P, H, Hkv, prefix_bstride, n_prefix, scale * 1.4426950408889634f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  append_combine_kernel<D>
      <<<(unsigned)((split_rows + kWarps - 1) / kWarps), kThreads, 0,
         stream>>>(scratch, part_ml, kv_lens,
                   static_cast<__nv_bfloat16*>(out), B, S, P, H, n_prefix);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int repro_prefill_attention(const void* q, const void* k,
                                       const void* v, void* out, int B, int S,
                                       int H, int Hkv, int D, int window,
                                       float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + D) {
#define REPRO_D(d)                                                          \
  case d:                                                                   \
    return (int)launch_f32<d>(q, k, v, out, B, S, H, Hkv, window, scale,   \
                              st);                                          \
  case 1000 + d:                                                            \
    return (int)launch_mma<d>(q, k, v, out, B, S, H, Hkv, window, scale,   \
                              st);
    REPRO_D(16) REPRO_D(32) REPRO_D(64) REPRO_D(128) REPRO_D(160)
    REPRO_D(240)
#undef REPRO_D
  }
  return (int)cudaErrorInvalidValue;
}

// The append instance, bf16 only: q (B, S, H, D), the prefix k, v (B, P,
// Hkv, D) with a batch stride of prefix_bstride elements, the new k_new,
// v_new (B, S, Hkv, D), kv_lens (B,) int32 on the device, out (B, S, H, D),
// and `scratch` of (n_split · B · S · H · (D + 2)) floats, n_split =
// ceil(P / split) + ceil(S / split). `split` must be the kernel's own
// kAppendSplit: the wrapper sizes the scratch from it. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for a shape it does
// not take).
extern "C" int repro_append_attention(const void* q, const void* k,
                                      const void* v, const void* k_new,
                                      const void* v_new, const void* kv_lens,
                                      void* out, void* scratch, int B, int S,
                                      int P, int H, int Hkv, int D,
                                      long long prefix_bstride, int split,
                                      float scale, void* stream) {
  if (B <= 0 || S <= 0 || P < 0 || Hkv <= 0 || H % Hkv != 0 ||
      split != kAppendSplit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lens);
  float* part = static_cast<float*>(scratch);
  switch (D) {
#define REPRO_D(d)                                                          \
  case d:                                                                   \
    return (int)launch_append<d>(q, k, v, k_new, v_new, lens, out, part, B, \
                                 S, P, H, Hkv, prefix_bstride, scale, st);
    REPRO_D(16) REPRO_D(32) REPRO_D(64) REPRO_D(128) REPRO_D(160)
    REPRO_D(240)
#undef REPRO_D
  }
  return (int)cudaErrorInvalidValue;
}
