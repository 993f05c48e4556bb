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
// one that owns key rows and one that owns query rows, so every output
// element is written by exactly one CTA: no atomics, and dQ, dK, dV are the
// same bits from run to run. The masked scores take the forward's finite
// mask value -0.7 * FLT_MAX, so P is exactly 0 above the diagonal. Di, which
// the library computes in XLA before its kernels, is fused into the dQ
// kernel: each thread sums a quarter of a row of O * dO in float32 and a
// fixed shuffle tree adds the quarters; the sums are written for the dK/dV
// kernel, which is launched after it on the same stream.
//
// What bounds it on an H100: at B = 8, H = 32, S = 2048 the function needs
// five products over the causal half (S, dP, dV, dK, dQ), 2.5 times the
// forward's 2.75e11 operations: 6.87e11, 0.695 ms at 989 TFLOP/s bf16,
// against 1.08 GB of bytes (q, k, v, o, dO and LSE read, dQ, dK, dV
// written), 0.32 ms at 3.35 TB/s: the operations bound. The two-kernel split
// computes S and dP twice (seven products, 1.4 times the bound's work) to buy
// deterministic outputs without atomics. Only wgmma reaches the tensor
// cores' full rate, and it has to be fed without the issuing threads
// stopping to copy or to pass P and dS through shared memory.
//
// Design (Hopper, warp-specialised; helpers in csrc/hopper.cuh). Both
// kernels have the same shape:
//   * one CTA owns 128 rows of one side (keys for dK/dV, queries for dQ) of
//     one (b, h): a producer warpgroup and two consumer warpgroups of 64
//     rows each. The owned Q and dO (or K and V) are loaded once by TMA; the
//     other side streams through a ring of 64-row tiles (three stages for dQ,
//     two for dK/dV), loaded by the producer's one thread with TMA on
//     mbarriers, each tile two 64-column boxes of 128-byte-swizzled rows
//     from a 4-D tensor map (dims 128, S, H, B built from the caller's
//     strides; boxes that run past S read zeros). The consumers free a stage
//     with one arrival per warp. The producer gives up registers (setmaxnreg
//     24), the consumers take them (240): dK and dV are two 64 x 128 float32
//     accumulators, 128 registers a thread;
//   * the two consumer warpgroups take turns to issue their score products
//     (a pair of named barriers), so one's elementwise work overlaps the
//     other's products;
//   * dK/dV, per 64-query tile: S^T = K Q^T and dP^T = V dO^T are SS wgmmas
//     m64n64k16 (both operands K-major); P^T and dS^T are formed in the
//     float32 accumulators, with the tile's LSE and Di rows staged in shared
//     memory by the producer beside its Q and dO (bulk copies on the same
//     mbarrier), then rounded to bf16 in registers, where the accumulator
//     layout is the A-fragment layout; dV += P^T dO (issued before dS^T is
//     formed) and dK += dS^T Q are RS wgmmas m64n128k16 with dO and Q read
//     MN-major. No shared-memory round trip of P or dS, no block-wide barrier
//     in the loop. Query tiles run from the diagonal to the end (causal:
//     queries >= keys). Overlapping a tile's score products with the last
//     tile's dV and dK products needs more than the 240 registers;
//   * dQ, per 64-key tile: S = Q K^T and dP = dO V^T as SS wgmmas, dS in
//     registers, dQ += dS K as an RS wgmma with K read MN-major; key tiles
//     run up to the diagonal. Step j issues S_j and dP_j and then the dQ
//     product of tile j - 1, and forms dS_j while that product runs. Di and
//     LSE of the CTA's rows are read once, before the loop;
//   * the outputs leave through shared memory: each consumer warpgroup
//     writes its 64 rows, as bf16, over its own rows of the owned tiles (dQ
//     over Q, dK over K, dV over V) and one thread stores them with TMA;
//   * a consumer warpgroup skips the tiles wholly above its diagonal (it
//     still waits for them, takes its turn and frees them), masks its
//     diagonal tile, and stores nothing when its rows all lie past S (the
//     output maps would clip them anyway); the longest tiles of a head
//     are launched first, and the heads one after the other, so the CTAs on
//     the card at one time share their heads' streamed tiles in L2.
// P and dS are rounded to bf16 before their products (as FlashAttention-2
// does); dS is formed from the float32 P.

#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kDh = 128;
constexpr int kOwn = 128;    // rows a CTA owns: two consumer warpgroups of 64
constexpr int kStream = 64;  // rows of a streamed tile
// ring depth: the dQ kernel holds a tile until its dQ product, issued in the
// next step, is done; the dK/dV kernel frees a tile within its step
constexpr int kStagesDq = 3;
constexpr int kStagesDkv = 2;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kOwnBox = kOwn * 128;          // one 64-column box of owned rows
constexpr int kOwnTile = 2 * kOwnBox;        // 128 rows x 128 columns
constexpr int kStreamBox = kStream * 128;    // one 64-column box of a streamed tile
constexpr int kStreamTile = 2 * kStreamBox;  // 64 rows x 128 columns
constexpr int kRowBytes = kStream * static_cast<int>(sizeof(float));  // LSE or Di of a tile
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

// two owned tiles, Stages of two streamed tiles, LSE and Di per stage, the
// barriers; 1024 to align the base
template <int Stages>
constexpr int smem_bytes() {
  return 2 * kOwnTile + 2 * Stages * kStreamTile + 2 * Stages * kRowBytes + 1024 + 128;
}

struct Strides {
  int64_t b, h, s;  // in elements; the head dimension is contiguous
};

template <int Stages>
struct Smem {
  char* own0;  // Q (dQ) or K (dK/dV), owned rows
  char* own1;  // dO (dQ) or V (dK/dV), owned rows
  char* str0;  // stage 0 of K (dQ) or Q (dK/dV); stage s at + s * kStreamTile
  char* str1;  // stages of V (dQ) or dO (dK/dV)
  float* lse;  // stages of the streamed tile's LSE rows (dK/dV)
  float* di;   // stages of its Di rows (dK/dV)
  uint64_t* own_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    own0 = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                   ~static_cast<uintptr_t>(1023));
    own1 = own0 + kOwnTile;
    str0 = own1 + kOwnTile;
    str1 = str0 + Stages * kStreamTile;
    lse = reinterpret_cast<float*>(str1 + Stages * kStreamTile);
    di = lse + Stages * kStream;
    own_full = reinterpret_cast<uint64_t*>(di + Stages * kStream);
    full = own_full + 1;
    empty = full + Stages;
    if (threadIdx.x == 0) {
      mbar_init(own_full, 1);
      for (int s = 0; s < Stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 4 * kConsumers);
      }
      mbar_init_fence();
    }
    __syncthreads();
  }

  // The producer's loads of the owned rows: two tensors, two boxes each.
  __device__ __forceinline__ void load_owned(const CUtensorMap* a, const CUtensorMap* b,
                                             int row, int h, int bb) const {
    mbar_arrive_expect_tx(own_full, 2 * kOwnTile);
    for (int half = 0; half < 2; ++half) {
      tma_load_4d(own0 + half * kOwnBox, a, own_full, 64 * half, row, h, bb);
      tma_load_4d(own1 + half * kOwnBox, b, own_full, 64 * half, row, h, bb);
    }
  }

  // Waits for the stage of streamed tile j to be free and loads two
  // tensors' rows into it; `extra` more bytes are expected on the same
  // barrier. Returns the stage.
  __device__ __forceinline__ int acquire(int j, const CUtensorMap* a, const CUtensorMap* b,
                                         int row, int h, int bb, uint32_t extra) const {
    const int s = j % Stages;
    mbar_wait(&empty[s], ((j / Stages) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[s], 2 * kStreamTile + extra);
    for (int half = 0; half < 2; ++half) {
      tma_load_4d(str0 + s * kStreamTile + half * kStreamBox, a, &full[s], 64 * half, row, h,
                  bb);
      tma_load_4d(str1 + s * kStreamTile + half * kStreamBox, b, &full[s], 64 * half, row, h,
                  bb);
    }
    return s;
  }

  // A consumer's wait for the tile of step j, and its warp's release of it.
  __device__ __forceinline__ void wait_full(int j) const {
    mbar_wait(&full[j % Stages], (j / Stages) & 1);
  }
  __device__ __forceinline__ void release(int j, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % Stages]);
  }
  __device__ __forceinline__ const char* tile0(int j) const {
    return str0 + (j % Stages) * kStreamTile;
  }
  __device__ __forceinline__ const char* tile1(int j) const {
    return str1 + (j % Stages) * kStreamTile;
  }
};

// Both score-type products of a tile over the head dimension, c1 = A1 B1^T
// and c2 = A2 B2^T, 64 owned rows x 64 streamed rows, as SS wgmmas issued and
// committed as one group.
__device__ __forceinline__ void issue_scores(float (&c1)[32], float (&c2)[32], const char* a1,
                                             const char* b1, const char* a2, const char* b2) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int a_off = (kk / 4) * kOwnBox + (kk % 4) * 32;
    const int b_off = (kk / 4) * kStreamBox + (kk % 4) * 32;
    wgmma_m64n64k16_ss<0>(c1, desc_k_major(a1 + a_off), desc_k_major(b1 + b_off), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int a_off = (kk / 4) * kOwnBox + (kk % 4) * 32;
    const int b_off = (kk / 4) * kStreamBox + (kk % 4) * 32;
    wgmma_m64n64k16_ss<0>(c2, desc_k_major(a2 + a_off), desc_k_major(b2 + b_off), kk > 0);
  }
  wgmma_commit();
}

// acc += A T over the 64 streamed rows: A the bf16 fragments (4 k-steps of
// 16 rows), T a streamed tile read MN-major (its rows are the contraction
// index, its 128 columns the output's). Issued and committed as one group.
__device__ __forceinline__ void issue_accumulate(float (&acc)[64], const uint32_t (&a)[4][4],
                                                 const char* tile) {
#pragma unroll
  for (int kk = 0; kk < kStream / 16; ++kk) {
    wgmma_m64n128k16_rs<1>(acc, a[kk], desc_mn_major(tile + kk * 2048, kStreamBox), 1);
  }
  wgmma_commit();
}

// Writes a warpgroup's 64 x 128 accumulator times `scale` as bf16 into its
// own 64 rows of an owned tile (two boxes of swizzled rows), whose last
// product is done: the other warpgroup reads only its own rows.
__device__ __forceinline__ void stage_out(char* own_wg, const float (&acc)[64], float scale,
                                          int warp, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int local = 16 * warp + g + 8 * r;
#pragma unroll
    for (int c = 0; c < kDh / 8; ++c) {
      char* at = swizzled(own_wg + (c / 8) * kOwnBox, local, 8 * (c % 8) + 2 * t);
      *reinterpret_cast<uint32_t*>(at) =
          pack_bf16(acc[4 * c + 2 * r] * scale, acc[4 * c + 2 * r + 1] * scale);
    }
  }
}

// One thread's TMA stores of a warpgroup's staged rows to rows row0 .. of a
// (b, h) slice; rows past S are clipped by the map.
__device__ __forceinline__ void store_out(const CUtensorMap* map, const char* own_wg, int row0,
                                          int h, int b) {
  tma_store_4d(map, own_wg, 0, row0, h, b);
  tma_store_4d(map, own_wg + kOwnBox, 64, row0, h, b);
}

// The two consumer warpgroups take turns to issue their score products
// (named barrier 1 + cw is warpgroup cw's turn), so one's elementwise work
// overlaps the other's products. Both take a turn in every step, whether
// they have work in it or not; warpgroup 0 goes first and, after the last
// step, takes warpgroup 1's last turn.
__device__ __forceinline__ void turn_begin(int cw) { named_sync(1 + cw, 256); }
__device__ __forceinline__ void turn_end(int cw) { named_arrive(2 - cw, 256); }
__device__ __forceinline__ void turns_open(int cw) {
  if (cw == 1) named_arrive(1, 256);
}
__device__ __forceinline__ void turns_close(int cw) {
  if (cw == 0) named_sync(1, 256);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap dq_map,
                    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ di, Strides os,
                    Strides dos, int num_heads, int seq, float scale_log2, float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<kStagesDq> m(smem_raw);
  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int tid = threadIdx.x;
  // key tiles up to the last one's diagonal; a half-full last query tile
  // (S % 128 == 64) has no second warpgroup's diagonal
  const int n_tiles = min(2 * qt + 2, seq / kStream);

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<24>();
    if (tid == 0) {
      m.load_owned(&q_map, &do_map, qt * kOwn, h, b);
      for (int j = 0; j < n_tiles; ++j) m.acquire(j, &k_map, &v_map, j * kStream, h, b, 0);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int cw = tid / 128 - 1;  // consumer warpgroup: query rows 64 cw ..
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = qt * kOwn + 64 * cw + 16 * warp + g;  // this thread's rows r0, r0 + 8
  const bool valid = qt * kOwn + 64 * cw < seq;        // rows past S in a half-full tile
  const int last = 2 * qt + cw;                        // this warpgroup's diagonal key tile
  const int n_active = valid ? last + 1 : 0;           // key tiles 0 .. last

  // Di = rowsum(O * dO) of rows r0 and r0 + 8: each of the 4 threads of a
  // row sums 32 columns, then a fixed shuffle tree adds the quarters.
  float lse2[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  if (valid) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = r0 + 8 * r;
      const uint4* op = reinterpret_cast<const uint4*>(o + b * os.b + h * os.h + row * os.s +
                                                       32 * t);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + b * dos.b + h * dos.h +
                                                       row * dos.s + 32 * t);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 ov = op[c];
        const uint4 dv = dp[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          sum += of.x * df.x + of.y * df.y;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dd[r] = sum;
      const int64_t at = static_cast<int64_t>(bh) * seq + row;
      if (t == 0) di[at] = sum;
      lse2[r] = lse[at] * kLog2e;
    }
  }

  float acc[64];  // dQ accumulator, 64 rows x 128
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const char* q_wg = m.own0 + cw * 64 * 128;
  const char* do_wg = m.own1 + cw * 64 * 128;
  uint32_t dsf[kStream / 16][4];  // dS of the previous tile, bf16 A fragments

  // dS = P * (dP - Di) of key tile j, in place in sc; the diagonal masked
  auto form_ds = [&](float (&sc)[32], const float (&dp)[32], int j) {
    const bool diag = (j == last);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int col = j * kStream + 8 * (i / 4) + 2 * t + (i & 1);
      const float x = (diag && col > r0 + 8 * r) ? kMaskValue : sc[i] * scale_log2;
      sc[i] = exp2_approx(x - lse2[r]) * (dp[i] - dd[r]);
    }
  };

  turns_open(cw);
  mbar_wait(m.own_full, 0);
  // Step j issues S_j and dP_j, then dQ += dS_{j-1} K_{j-1}, and forms dS_j
  // while the latter runs; step 0 has no predecessor and is peeled off, so
  // every product in the loop is issued and waited for unconditionally.
  if (n_active > 0) {
    float sc[32], dp[32];
    m.wait_full(0);
    turn_begin(cw);
    wgmma_fence();
    issue_scores(sc, dp, q_wg, m.tile0(0), do_wg, m.tile1(0));
    turn_end(cw);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    form_ds(sc, dp, 0);
#pragma unroll
    for (int kk = 0; kk < kStream / 16; ++kk) pack_a(dsf[kk], sc, kk);
  }
  for (int j = 1; j < n_active; ++j) {
    float sc[32], dp[32];
    m.wait_full(j);
    turn_begin(cw);
    wgmma_fence();
    issue_scores(sc, dp, q_wg, m.tile0(j), do_wg, m.tile1(j));
    issue_accumulate(acc, dsf, m.tile0(j - 1));  // dQ += dS_{j-1} K_{j-1}
    turn_end(cw);
    wgmma_wait<1>();
    fence_regs(sc);
    fence_regs(dp);
    form_ds(sc, dp, j);
    wgmma_wait<0>();
    fence_regs(acc);
    m.release(j - 1, lane);
#pragma unroll
    for (int kk = 0; kk < kStream / 16; ++kk) pack_a(dsf[kk], sc, kk);
  }
  if (n_active > 0) {
    wgmma_fence();
    issue_accumulate(acc, dsf, m.tile0(n_active - 1));
    wgmma_wait<0>();
    fence_regs(acc);
    m.release(n_active - 1, lane);
  }
  for (int j = n_active; j < n_tiles; ++j) {  // wholly above the diagonal
    m.wait_full(j);
    turn_begin(cw);
    turn_end(cw);
    m.release(j, lane);
  }
  turns_close(cw);
  if (valid) {  // dQ through this warpgroup's rows of the Q tile
    char* out = m.own0 + cw * 64 * 128;
    stage_out(out, acc, sm_scale, warp, g, t);
    fence_async_shared();
    named_sync(3 + cw, 128);
    if (tid % 128 == 0) {
      store_out(&dq_map, out, qt * kOwn + 64 * cw, h, b);
      tma_store_wait_read();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap dk_map,
                     const __grid_constant__ CUtensorMap dv_map, const float* __restrict__ lse,
                     const float* __restrict__ di, int num_heads, int seq, float scale_log2,
                     float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  const Smem<kStagesDkv> m(smem_raw);
  const int kt = blockIdx.x;  // key tile 0 sees every query: launched first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int tid = threadIdx.x;
  const int first = 2 * kt;  // the first query tile that sees these keys
  const int n_tiles = seq / kStream - first;

  if (tid < 128) {  // producer warpgroup
    setmaxnreg_dec<24>();
    if (tid == 0) {
      m.load_owned(&k_map, &v_map, kt * kOwn, h, b);
      const float* lse_bh = lse + static_cast<int64_t>(bh) * seq;
      const float* di_bh = di + static_cast<int64_t>(bh) * seq;
      for (int j = 0; j < n_tiles; ++j) {
        const int row = (first + j) * kStream;
        const int s = m.acquire(j, &q_map, &do_map, row, h, b, 2 * kRowBytes);
        bulk_load(m.lse + s * kStream, lse_bh + row, kRowBytes, &m.full[s]);
        bulk_load(m.di + s * kStream, di_bh + row, kRowBytes, &m.full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int cw = tid / 128 - 1;  // consumer warpgroup: key rows 64 cw ..
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = kt * kOwn + 64 * cw + 16 * warp + g;  // this thread's keys r0, r0 + 8
  const bool valid = kt * kOwn + 64 * cw < seq;        // keys past S in a half-full tile
  // the query tiles before this warpgroup's diagonal one see none of its keys
  const int n_skip = valid ? cw : n_tiles;

  float acc_dv[64], acc_dk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_dv[i] = acc_dk[i] = 0.f;
  const char* k_wg = m.own0 + cw * 64 * 128;
  const char* v_wg = m.own1 + cw * 64 * 128;

  turns_open(cw);
  mbar_wait(m.own_full, 0);
  for (int j = 0; j < n_skip; ++j) {
    m.wait_full(j);
    turn_begin(cw);
    turn_end(cw);
    m.release(j, lane);
  }
  for (int j = n_skip; j < n_tiles; ++j) {
    const int qi = first + j;
    const char* q_s = m.tile0(j);
    const char* do_s = m.tile1(j);
    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float st[32], dpt[32];
    m.wait_full(j);
    turn_begin(cw);
    wgmma_fence();
    issue_scores(st, dpt, k_wg, q_s, v_wg, do_s);
    turn_end(cw);
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const bool diag = (j == cw);
    const float* lse_s = m.lse + (j % kStagesDkv) * kStream;
    const float* di_s = m.di + (j % kStagesDkv) * kStream;
    float dd[kStream / 8][2];  // Di of this thread's query columns
#pragma unroll
    for (int c = 0; c < kStream / 8; ++c) {
      const int col = 8 * c + 2 * t;  // query of elements 0 and 2; +1 for 1 and 3
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 d2 = *reinterpret_cast<const float2*>(di_s + col);
      const float lq[2] = {l2.x * kLog2e, l2.y * kLog2e};
      dd[c][0] = d2.x;
      dd[c][1] = d2.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = qi * kStream + col + (e & 1);
        const float x =
            (diag && query < r0 + 8 * (e >> 1)) ? kMaskValue : st[4 * c + e] * scale_log2;
        st[4 * c + e] = exp2_approx(x - lq[e & 1]);  // P^T
      }
    }
    // dV += P^T dO runs while dS^T is formed
    uint32_t pf[kStream / 16][4];
#pragma unroll
    for (int kk = 0; kk < kStream / 16; ++kk) pack_a(pf[kk], st, kk);
    wgmma_fence();
    issue_accumulate(acc_dv, pf, do_s);
#pragma unroll
    for (int i = 0; i < 32; ++i) dpt[i] = st[i] * (dpt[i] - dd[i / 4][i & 1]);  // dS^T
    uint32_t dsf[kStream / 16][4];
#pragma unroll
    for (int kk = 0; kk < kStream / 16; ++kk) pack_a(dsf[kk], dpt, kk);
    wgmma_fence();
    issue_accumulate(acc_dk, dsf, q_s);  // dK += dS^T Q
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    m.release(j, lane);
  }
  turns_close(cw);
  if (valid) {  // dK and dV through this warpgroup's rows of the K and V tiles
    char* out_k = m.own0 + cw * 64 * 128;
    char* out_v = m.own1 + cw * 64 * 128;
    stage_out(out_k, acc_dk, sm_scale, warp, g, t);
    stage_out(out_v, acc_dv, 1.f, warp, g, t);
    fence_async_shared();
    named_sync(3 + cw, 128);
    if (tid % 128 == 0) {
      store_out(&dk_map, out_k, kt * kOwn + 64 * cw, h, b);
      store_out(&dv_map, out_v, kt * kOwn + 64 * cw, h, b);
      tma_store_wait_read();
    }
  }
}

}  // namespace

extern "C" {

// q, k, v, o, dout: bf16 (B, H, S, 128) inputs; dq, dk, dv: bf16 outputs of
// the same shape. Each takes its own element strides (batch, head,
// sequence); the head dimension is contiguous and every row starts on a
// 16-byte boundary (the wrapper checks both). lse: the forward's contiguous
// float32 (B, H, S) log-sum-exp; di: contiguous float32 (B, H, S) scratch,
// written by the first kernel and read by the second. Launches the dQ kernel
// and then the dK/dV kernel on `stream`; returns 0 or the first cudaError_t
// of the tensor maps' encoding, the launches' attributes or the launches.
int ecoflap_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* di, void* dq, void* dk,
                           void* dv, int batch, int heads, int seq, int head_dim,
                           int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh,
                           int64_t kss, int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
                           int64_t osh, int64_t oss, int64_t dosb, int64_t dosh,
                           int64_t doss, int64_t dqsb, int64_t dqsh, int64_t dqss,
                           int64_t dksb, int64_t dksh, int64_t dkss, int64_t dvsb,
                           int64_t dvsh, int64_t dvss, float sm_scale, void* stream) {
  if (head_dim != kDh || seq <= 0 || seq % kStream != 0 || batch <= 0 || heads <= 0 ||
      static_cast<int64_t>(batch) * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // owned rows in boxes of 128, streamed rows in boxes of 64
  CUtensorMap q_own, do_own, k_str, v_str, k_own, v_own, q_str, do_str, dq_map, dk_map, dv_map;
  int rc = encode_bhsd(&q_own, q, batch, heads, seq, qsb, qsh, qss, kOwn);
  if (rc == 0) rc = encode_bhsd(&do_own, dout, batch, heads, seq, dosb, dosh, doss, kOwn);
  if (rc == 0) rc = encode_bhsd(&k_str, k, batch, heads, seq, ksb, ksh, kss, kStream);
  if (rc == 0) rc = encode_bhsd(&v_str, v, batch, heads, seq, vsb, vsh, vss, kStream);
  if (rc == 0) rc = encode_bhsd(&k_own, k, batch, heads, seq, ksb, ksh, kss, kOwn);
  if (rc == 0) rc = encode_bhsd(&v_own, v, batch, heads, seq, vsb, vsh, vss, kOwn);
  if (rc == 0) rc = encode_bhsd(&q_str, q, batch, heads, seq, qsb, qsh, qss, kStream);
  if (rc == 0) rc = encode_bhsd(&do_str, dout, batch, heads, seq, dosb, dosh, doss, kStream);
  // outputs, stored 64 rows (one warpgroup's) at a time
  if (rc == 0) rc = encode_bhsd(&dq_map, dq, batch, heads, seq, dqsb, dqsh, dqss, 64);
  if (rc == 0) rc = encode_bhsd(&dk_map, dk, batch, heads, seq, dksb, dksh, dkss, 64);
  if (rc == 0) rc = encode_bhsd(&dv_map, dv, batch, heads, seq, dvsb, dvsh, dvss, 64);
  if (rc != 0) return rc;
  // above 48 KB, dynamic shared memory must be asked for explicitly
  constexpr int kSmemDq = smem_bytes<kStagesDq>();
  constexpr int kSmemDkv = smem_bytes<kStagesDkv>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((seq + kOwn - 1) / kOwn, batch * heads);
  const float scale_log2 = sm_scale * kLog2e;
  flash_bwd_dq_kernel<<<grid, kThreads, kSmemDq, st>>>(
      q_own, do_own, k_str, v_str, dq_map, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(di), Strides{osb, osh, oss}, Strides{dosb, dosh, doss}, heads, seq,
      scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<<<grid, kThreads, kSmemDkv, st>>>(
      k_own, v_own, q_str, do_str, dk_map, dv_map, static_cast<const float*>(lse),
      static_cast<const float*>(di), heads, seq, scale_log2, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
