// Causal flash attention, backward, on Hopper's tensor cores. For bf16 Q, K,
// V, O, dO of shape (B, H, S, 128), S % 64 == 0, and the forward's float32
// row log-sum-exp LSE (natural log, csrc/flash_attn.cu):
//     P  = exp(mask_causal(Q K^T * sm_scale) - LSE)
//     dV = P^T dO
//     dP = dO V^T
//     Di = rowsum(O * dO)
//     dS = P * (dP - Di)
//     dQ = dS K * sm_scale
//     dK = dS^T Q * sm_scale
// with dQ, dK, dV in bf16 and everything before the last rounding in float32.
//
// Replaces the two backward TPU kernels reached through
// ecoflap_tpu/ops/attention.py:189 (_flash -> the Pallas library's
// flash_attention, a custom_vjp): _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq. As there, the backward is split in two kernels,
// one that owns a key tile and one that owns a query tile, so every output
// element is written by exactly one CTA: no atomics, and dQ, dK, dV are the
// same bits from run to run. The masked scores take the forward's finite
// mask value -0.7 * FLT_MAX, so P is exactly 0 above the diagonal. Di, which
// the library computes in XLA before its kernels, is fused into the dQ
// kernel: each dQ CTA reduces its 64 rows of O * dO in float32 (a fixed
// shuffle tree) and writes them for the dK/dV kernel, which is launched
// after it on the same stream.
//
// Design (FlashAttention-2 backward, mma.sync bf16 -> f32, cp.async):
//   * dK/dV: one CTA per (64-key tile, b * H + h), 8 warps. K and V are
//     staged once; Q and dO tiles of 64 queries are double-buffered with
//     cp.async over the query tiles from the diagonal to the end (causal:
//     queries >= keys). Key tile 0, which sees every query, launches first.
//   * dQ: one CTA per (64-query tile, b * H + h), 8 warps. Q and dO are
//     staged once; K and V tiles are double-buffered over the key tiles up to
//     the diagonal. The longest query tiles launch first.
//   * Each tile step has two phases. Phase A: warp w takes 16 rows and 32
//     columns of the 64 x 64 score tile and computes both products over the
//     head dimension (S and dP, or their transposes), then P and dS in
//     float32 registers, and stores them as bf16 to shared memory. Phase B:
//     warp w takes 16 rows and 64 head-dimension columns of the outputs and
//     accumulates dV += P^T dO and dK += dS^T Q (or dQ += dS K) from shared
//     memory. So each warp holds two 16 x 64 float32 accumulators (dK/dV) or
//     one (dQ), where one warp per 16 rows would need two of 16 x 128: the
//     split keeps the register count under the limit without spills.
//   * Rows of the 64 x 128 tiles are padded from 256 to 272 bytes and rows of
//     the 64 x 64 P and dS tiles from 128 to 144 bytes, so the ldmatrix reads
//     of eight rows hit eight different bank groups.
//   * P and dS are rounded to bf16 before their products (as FlashAttention-2
//     does); dS is formed from the float32 P.
// Inputs and outputs take any strides whose last dimension is contiguous.
//
// What bounds it on an H100: at B = 8, H = 32, S = 2048 the function needs
// five products over the causal half (S, dP, dV, dK, dQ), 2.5 times the
// forward's 2.75e11 operations: 6.87e11, 0.695 ms at 989 TFLOP/s bf16,
// against 1.08 GB of bytes (q, k, v, o, dO and LSE read, dQ, dK, dV
// written), 0.32 ms at 3.35 TB/s: the operations bound. The two-kernel split
// computes S and dP twice (seven products, 1.4 times the bound's work) to buy
// deterministic outputs without atomics; wgmma, TMA and warp specialisation
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;
constexpr int kBlock = 64;  // queries or keys per tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRow = kDh + 8;  // padded row of a Q, K, V or dO tile: 272 bytes
constexpr int kTile = kBlock * kRow;
constexpr int kPRow = kBlock + 8;  // padded row of a P or dS tile: 144 bytes
constexpr int kPTile = kBlock * kPRow;
constexpr int kBf16 = static_cast<int>(sizeof(__nv_bfloat16));
// dK/dV: K, V, two stages of Q and of dO, then P^T and dS^T
constexpr int kSmemDkv = (6 * kTile + 2 * kPTile) * kBf16;
// dQ: Q, dO, two stages of K and of V, dS, then Di of the tile's rows
constexpr int kSmemDq = (6 * kTile + kPTile) * kBf16 + kBlock * static_cast<int>(sizeof(float));
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b for one 16x8 tile, k = 16: a row-major 16x16, b column-major
// 16x8, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Strides {
  int64_t b, h, s;  // in elements; the head dimension is contiguous
};

// Rows row0..row0+63 of one (b, h) slice into a padded shared tile, 16
// bytes a copy: 64 rows x 16 chunks over 256 threads.
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm, const __nv_bfloat16* g,
                                          int64_t row_stride, int tid) {
#pragma unroll
  for (int c = tid; c < kBlock * (kDh / 8); c += kThreads) {
    const int r = c >> 4;
    const int col = (c & 15) * 8;
    cp_async16(sm + r * kRow + col, g + r * row_stride + col);
  }
}

// Phase A of one warp: c1 = A1 B1^T and c2 = A2 B2^T, where A1, A2 point at
// 16 rows and B1, B2 at 32 rows of padded 64 x 128 tiles; the product runs
// over the head dimension. c[nt] covers columns nt*8 .. nt*8+7 of the 32.
__device__ __forceinline__ void score_products(float (&c1)[4][4], float (&c2)[4][4],
                                               const __nv_bfloat16* a1,
                                               const __nv_bfloat16* b1,
                                               const __nv_bfloat16* a2,
                                               const __nv_bfloat16* b2, int lane) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[nt][e] = c2[nt][e] = 0.f;
  }
#pragma unroll
  for (int kk2 = 0; kk2 < kDh / 32; ++kk2) {
    uint32_t fa1[2][4], fa2[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int off = (lane & 15) * kRow + kk2 * 32 + half * 16 + (lane >> 4) * 8;
      ldmatrix_x4(fa1[half], a1 + off);
      ldmatrix_x4(fa2[half], a2 + off);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int off = (nt * 8 + (lane & 7)) * kRow + kk2 * 32 + (lane >> 3) * 8;
      uint32_t fb[4];
      ldmatrix_x4(fb, b1 + off);
      mma_bf16(c1[nt], fa1[0], fb[0], fb[1]);
      mma_bf16(c1[nt], fa1[1], fb[2], fb[3]);
      ldmatrix_x4(fb, b2 + off);
      mma_bf16(c2[nt], fa2[0], fb[0], fb[1]);
      mma_bf16(c2[nt], fa2[1], fb[2], fb[3]);
    }
  }
}

// Stores a warp's 16 x 32 float32 tile c (layout of score_products) as bf16
// into a padded 64 x 64 tile at rows row0.., columns col0...
__device__ __forceinline__ void store_p_tile(__nv_bfloat16* sm, float (&c)[4][4],
                                             int row0, int col0, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    __nv_bfloat16* p = sm + (row0 + g) * kPRow + col0 + nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(c[nt][0], c[nt][1]);
    *reinterpret_cast<uint32_t*>(p + 8 * kPRow) = pack_bf16(c[nt][2], c[nt][3]);
  }
}

// Phase B of one warp: acc += A B, A the 16 rows at `a` of a padded 64 x 64
// P-type tile, B the padded 64 x 128 tile `t` (its rows are the contraction
// index) restricted to columns col0 .. col0+63; acc[n] covers columns
// col0 + n*8 .. col0 + n*8 + 7.
__device__ __forceinline__ void accumulate_product(float (&acc)[8][4], const __nv_bfloat16* a,
                                                   const __nv_bfloat16* t, int col0, int lane) {
#pragma unroll
  for (int kq = 0; kq < kBlock / 16; ++kq) {
    uint32_t fa[4];
    ldmatrix_x4(fa, a + (lane & 15) * kPRow + kq * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, t + (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
                                col0 + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * dp + 1], fa, fb[2], fb[3]);
    }
  }
}

// Writes a warp's 16 x 64 accumulator times `scale` as bf16 rows row0.. of
// a strided (b, h) slice, columns col0...
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t row_stride,
                                           float (&acc)[8][4], float scale, int row0,
                                           int col0, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  __nv_bfloat16* p = out + (row0 + g) * row_stride + col0 + 2 * t;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(p + n * 8) =
        pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(p + 8 * row_stride + n * 8) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ di, __nv_bfloat16* __restrict__ dq, Strides qs,
                    Strides ks, Strides vs, Strides os, Strides dos, Strides dqs,
                    int num_heads, float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kTile;
  __nv_bfloat16* sK = sdO + kTile;
  __nv_bfloat16* sV = sK + 2 * kTile;
  __nv_bfloat16* sdS = sV + 2 * kTile;
  float* sDi = reinterpret_cast<float*>(sdS + kPTile);

  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int64_t seq = static_cast<int64_t>(gridDim.x) * kBlock;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int64_t q0 = static_cast<int64_t>(qt) * kBlock;
  const __nv_bfloat16* qg = q + b * qs.b + h * qs.h + q0 * qs.s;
  const __nv_bfloat16* dog = dout + b * dos.b + h * dos.h + q0 * dos.s;
  const __nv_bfloat16* kg = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vg = v + b * vs.b + h * vs.h;

  load_tile(sQ, qg, qs.s, tid);
  load_tile(sdO, dog, dos.s, tid);
  load_tile(sK, kg, ks.s, tid);
  load_tile(sV, vg, vs.s, tid);
  cp_async_commit();

  // Di of the tile's 64 rows: a warp per row at a time, 4 columns a lane
  const __nv_bfloat16* og = o + b * os.b + h * os.h + q0 * os.s;
  for (int r = warp; r < kBlock; r += kWarps) {
    const uint2 ov = *reinterpret_cast<const uint2*>(og + r * os.s + lane * 4);
    const uint2 dv = *reinterpret_cast<const uint2*>(dog + r * dos.s + lane * 4);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 of = __bfloat1622float2(o2[i]);
      const float2 df = __bfloat1622float2(d2[i]);
      sum += of.x * df.x + of.y * df.y;
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
    if (lane == 0) {
      sDi[r] = sum;
      di[bh * seq + q0 + r] = sum;
    }
  }
  __syncthreads();

  // phase A: rows ra.. (queries) x columns ca.. (keys); phase B: rows ra..
  // x head-dimension columns cb..
  const int ra = 16 * (warp & 3);
  const int ca = 32 * (warp >> 2);
  const int cb = 64 * (warp >> 2);
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse[bh * seq + q0 + ra + g + 8 * i] * kLog2e;
    dd[i] = sDi[ra + g + 8 * i];
  }
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = qt + 1;  // key tiles up to and including the diagonal
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int64_t k1 = static_cast<int64_t>(j + 1) * kBlock;
      load_tile(sK + (st ^ 1) * kTile, kg + k1 * ks.s, ks.s, tid);
      load_tile(sV + (st ^ 1) * kTile, vg + k1 * vs.s, vs.s, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sKs = sK + st * kTile;
    const __nv_bfloat16* sVs = sV + st * kTile;

    float s[4][4], dp[4][4];
    score_products(s, dp, sQ + ra * kRow, sKs + ca * kRow, sdO + ra * kRow, sVs + ca * kRow,
                   lane);
    const bool diag = (j == qt);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = ra + g + ((e >> 1) << 3);
        const int col = ca + nt * 8 + 2 * t + (e & 1);
        const float x = (diag && col > row) ? kMaskValue : s[nt][e] * scale_log2;
        const float p = exp2f(x - lse2[e >> 1]);
        s[nt][e] = p * (dp[nt][e] - dd[e >> 1]);  // dS
      }
    }
    store_p_tile(sdS, s, ra, ca, lane);
    __syncthreads();
    accumulate_product(acc, sdS + ra * kPRow, sKs, cb, lane);
    __syncthreads();  // sdS and this stage are rewritten by the next step
  }
  store_rows(dq + b * dqs.b + h * dqs.h + q0 * dqs.s, dqs.s, acc, sm_scale, ra, cb, lane);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                     int num_heads, float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile;
  __nv_bfloat16* sQ = sV + kTile;
  __nv_bfloat16* sdO = sQ + 2 * kTile;
  __nv_bfloat16* sP = sdO + 2 * kTile;
  __nv_bfloat16* sdS = sP + kPTile;

  const int kt = blockIdx.x;  // key tile 0 sees every query: launched first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int n_tiles = gridDim.x;
  const int64_t seq = static_cast<int64_t>(n_tiles) * kBlock;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int64_t k0 = static_cast<int64_t>(kt) * kBlock;
  const __nv_bfloat16* qg = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dog = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + bh * seq;
  const float* di_bh = di + bh * seq;

  load_tile(sK, k + b * ks.b + h * ks.h + k0 * ks.s, ks.s, tid);
  load_tile(sV, v + b * vs.b + h * vs.h + k0 * vs.s, vs.s, tid);
  load_tile(sQ, qg + k0 * qs.s, qs.s, tid);
  load_tile(sdO, dog + k0 * dos.s, dos.s, tid);
  cp_async_commit();

  // phase A: rows ra.. (keys) x columns ca.. (queries); phase B: rows ra..
  // x head-dimension columns cb..
  const int ra = 16 * (warp & 3);
  const int ca = 32 * (warp >> 2);
  const int cb = 64 * (warp >> 2);
  float acc_dv[8][4], acc_dk[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[n][e] = acc_dk[n][e] = 0.f;
  }

  for (int i = kt; i < n_tiles; ++i) {  // query tiles from the diagonal on
    const int st = (i - kt) & 1;
    if (i + 1 < n_tiles) {
      const int64_t q1 = static_cast<int64_t>(i + 1) * kBlock;
      load_tile(sQ + (st ^ 1) * kTile, qg + q1 * qs.s, qs.s, tid);
      load_tile(sdO + (st ^ 1) * kTile, dog + q1 * dos.s, dos.s, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sQs = sQ + st * kTile;
    const __nv_bfloat16* sdOs = sdO + st * kTile;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float s[4][4], dp[4][4];
    score_products(s, dp, sK + ra * kRow, sQs + ca * kRow, sV + ra * kRow, sdOs + ca * kRow,
                   lane);
    const int64_t q0 = static_cast<int64_t>(i) * kBlock;
    const bool diag = (i == kt);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = ca + nt * 8 + 2 * t;  // query of element 0; element 1 is col + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lse_bh + q0 + col);
      const float2 d2 = *reinterpret_cast<const float2*>(di_bh + q0 + col);
      const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
      const float dd[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = ra + g + ((e >> 1) << 3);
        const float x = (diag && col + (e & 1) < row) ? kMaskValue : s[nt][e] * scale_log2;
        const float p = exp2f(x - lse2[e & 1]);
        s[nt][e] = p;                               // P^T
        dp[nt][e] = p * (dp[nt][e] - dd[e & 1]);    // dS^T
      }
    }
    store_p_tile(sP, s, ra, ca, lane);
    store_p_tile(sdS, dp, ra, ca, lane);
    __syncthreads();
    accumulate_product(acc_dv, sP + ra * kPRow, sdOs, cb, lane);
    accumulate_product(acc_dk, sdS + ra * kPRow, sQs, cb, lane);
    __syncthreads();  // sP, sdS and this stage are rewritten by the next step
  }
  store_rows(dv + b * dvs.b + h * dvs.h + k0 * dvs.s, dvs.s, acc_dv, 1.f, ra, cb, lane);
  store_rows(dk + b * dks.b + h * dks.h + k0 * dks.s, dks.s, acc_dk, sm_scale, ra, cb, lane);
}

}  // namespace

extern "C" {

// q, k, v, o, dout: bf16 (B, H, S, 128) inputs; dq, dk, dv: bf16 outputs of
// the same shape. Each takes its own element strides (batch, head,
// sequence); the head dimension is contiguous and every row starts on a
// 16-byte boundary (the wrapper checks both). lse: the forward's contiguous
// float32 (B, H, S) log-sum-exp; di: contiguous float32 (B, H, S) scratch,
// written by the first kernel and read by the second. Launches the dQ kernel
// and then the dK/dV kernel on `stream`; returns the first non-zero
// cudaGetLastError() (0 = cudaSuccess).
int ecoflap_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* di, void* dq, void* dk,
                           void* dv, int batch, int heads, int seq, int head_dim,
                           int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                           int64_t kss, int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
                           int64_t osh, int64_t oss, int64_t dosb, int64_t dosh,
                           int64_t doss, int64_t dqsb, int64_t dqsh, int64_t dqss,
                           int64_t dksb, int64_t dksh, int64_t dkss, int64_t dvsb,
                           int64_t dvsh, int64_t dvss, float sm_scale, void* stream) {
  if (head_dim != kDh || seq <= 0 || seq % kBlock != 0 || batch <= 0 || heads <= 0 ||
      static_cast<int64_t>(batch) * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB, dynamic shared memory must be asked for explicitly
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(seq / kBlock, batch * heads);
  const float scale_log2 = sm_scale * kLog2e;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const Strides dos{dosb, dosh, doss};
  flash_bwd_dq_kernel<<<grid, kThreads, kSmemDq, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(di), static_cast<__nv_bfloat16*>(dq), qs, ks, vs,
      Strides{osb, osh, oss}, dos, Strides{dqsb, dqsh, dqss}, heads, scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<<<grid, kThreads, kSmemDkv, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), qs, ks, vs, dos,
      Strides{dksb, dksh, dkss}, Strides{dvsb, dvsh, dvss}, heads, scale_log2, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
