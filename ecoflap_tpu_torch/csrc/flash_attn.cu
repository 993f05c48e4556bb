// Causal flash attention, forward, on Hopper's tensor cores:
//     O = softmax(mask_causal(Q K^T * sm_scale)) V
// and, when asked for, the row log-sum-exp the backward needs
// (csrc/flash_attn_bwd.cu):
//     LSE = log(sum_j exp(mask_causal(Q K^T * sm_scale)_j)), float32, natural log
// for bf16 Q, K, V, O of shape (B, H, S, 128), with S % 64 == 0 and one
// shared sequence for queries and keys (row r sees keys 0..r).
//
// Replaces the TPU kernel reached through ecoflap_tpu/ops/attention.py:189
// (_flash -> jax.experimental.pallas.ops.tpu.flash_attention), forward
// pass. As there, scores, the running max, the running sum and the output
// accumulator are float32; sm_scale multiplies the float32 scores (not the
// bf16 queries); masked scores take the finite value -0.7 * FLT_MAX (the TPU
// library's DEFAULT_MASK_VALUE), so no inf - inf appears; key tiles that lie
// wholly above the diagonal are never loaded. The library's separate
// residuals l and m (kept for its backward) are one tensor here,
// LSE = m + log l, stored in natural-log units whatever base the kernel
// computes in; the backward and both plain versions read it so.
//
// What bounds it on an H100: at B = 8, H = 32, S = 2048 the causal half of
// Q K^T and P V is 2 * 2 * B * H * Dh * S(S+1)/2 = 2.75e11 operations,
// 0.278 ms at 989 TFLOP/s bf16, against 4 * 8*32*2048*128 * 2 bytes =
// 537 MB, 0.160 ms at 3.35 TB/s: the operations bound. Only wgmma reaches
// the tensor cores' full rate, and it has to be fed from shared memory
// without the issuing threads stopping to copy.
//
// Design (Hopper, warp-specialised; helpers in csrc/hopper.cuh):
//   * one CTA per (128-row query tile, b * H + h): a producer warpgroup and
//     two consumer warpgroups of 64 query rows each. The longest tiles (most
//     keys) of a head are launched first, and the heads one after the other,
//     so the CTAs on the card at one time share their heads' K and V in L2;
//   * the producer's one thread loads the Q tile once and then 128-key K
//     and V tiles into a two-stage ring with TMA, each tile two 64-column
//     boxes of 128-byte-swizzled rows from a 4-D tensor map (dims 128, S,
//     H, B built from the caller's strides, so the model's (B, S, H, Dh)
//     views are read in place). K and V of a stage complete, and are freed,
//     on separate mbarriers: a consumer frees K_j once S_j is done and V_j
//     once P_j V_j is, with one arrival per warp. The producer gives up
//     registers (setmaxnreg 24) and the consumers take them (240);
//   * S = Q K^T is an SS wgmma m64n128k16 (both operands K-major, from the
//     swizzled tiles) into float32 registers; online softmax in base 2 in
//     registers: x = s * sm_scale * log2(e), running max m, alpha =
//     2^(m_old - m_new), the diagonal tile masked; P is rounded to bf16 in
//     registers (the accumulator layout is the A-fragment layout) and
//     O += P V is an RS wgmma m64n128k16 with V read MN-major. The row sum
//     is taken over the float32 P; one division at the end, and LSE =
//     (m + log2(l)) * ln(2) when the lse pointer is not null;
//   * step j issues S_j and then P_{j-1} V_{j-1}, and runs the softmax of
//     S_j while the latter is in flight; the two consumer warpgroups take
//     turns to issue (a pair of named barriers), so one's softmax overlaps
//     the other's products;
//   * the output leaves through shared memory: each consumer warpgroup
//     writes its 64 rows of O / l, as bf16, over its own rows of the Q tile
//     and one thread stores them with TMA (the row LSE goes out from
//     registers);
//   * a last query tile that is half full (S % 128 == 64) reads zeros past
//     S (TMA clips each dimension to its own bound); those keys lie above
//     the diagonal of every valid row, and the output's map clips the
//     store of rows >= S.

#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kDh = 128;
constexpr int kBlockM = 128;  // query rows per CTA: two consumer warpgroups
constexpr int kBlockN = 128;  // keys per tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxBytes = kBlockN * 128;   // one 64-column box of 128 rows
constexpr int kTileBytes = 2 * kBoxBytes;  // 128 rows x 128 columns
// Q, kStages of K, kStages of V, then the barriers; 1024 to align the base
constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes + 1024 + 256;
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBlockM == kBlockN, "the diagonal tile test assumes square tiles");

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S = Q K^T for one warpgroup's 64 rows and a 128-key tile, issued and
// committed as one group.
__device__ __forceinline__ void issue_scores(float (&sc)[64], const char* q_wg,
                                             const char* k_s) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_m64n128k16_ss<0>(sc, desc_k_major(q_wg + off), desc_k_major(k_s + off), kk > 0);
  }
  wgmma_commit();
}

// O += P V for a 128-key tile, V read MN-major (16 keys, 2048 bytes, a
// step), issued and committed as one group.
__device__ __forceinline__ void issue_pv(float (&acc)[64], const uint32_t (&pf)[kBlockN / 16][4],
                                         const char* v_s) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    wgmma_m64n128k16_rs<1>(acc, pf[kk], desc_mn_major(v_s + kk * 2048, kBoxBytes), 1);
  }
  wgmma_commit();
}

// One step of the online softmax in base 2 on a 64 x 128 score tile whose
// first key is col0: x = s * sm_scale * log2(e), masked above the diagonal
// on the diagonal tile; the running max m and this thread's share of the
// row sums l are updated, alpha = 2^(m_old - m_new) is returned for the
// output's rescale, and P = 2^(x - m) (float32) is left in sc.
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2],
                                               float scale_log2, bool diag, int col0, int r0,
                                               int t) {
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
  if (diag) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = col0 + 8 * (i / 4) + 2 * t + (i & 1);
      if (col > r0 + 8 * ((i >> 1) & 1)) sc[i] = kMaskValue;
    }
  }
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = exp2_approx(m_run[r] - mx[r]);  // 0 on the first tile
    m_run[r] = mx[r];
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = exp2_approx(sc[i] - m_run[(i >> 1) & 1]);
    l_run[(i >> 1) & 1] += sc[i];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse,
                 int num_heads, int seq, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  char* sQ = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~static_cast<uintptr_t>(1023));
  char* sK = sQ + kTileBytes;
  char* sV = sK + kStages * kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int bh = blockIdx.y;
  const int b = bh / num_heads;
  const int h = bh % num_heads;
  const int tid = threadIdx.x;
  const int n_tiles = qt + 1;  // key tiles up to and including the diagonal

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * kConsumers);
      mbar_init(&v_empty[s], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (tid == 0) {
      mbar_arrive_expect_tx(q_full, kTileBytes);
      tma_load_4d(sQ, &q_map, q_full, 0, qt * kBlockM, h, b);
      tma_load_4d(sQ + kBoxBytes, &q_map, q_full, 64, qt * kBlockM, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;
        char* k_dst = sK + s * kTileBytes;
        char* v_dst = sV + s * kTileBytes;
        mbar_wait(&k_empty[s], parity);
        mbar_arrive_expect_tx(&k_full[s], kTileBytes);
        tma_load_4d(k_dst, &k_map, &k_full[s], 0, j * kBlockN, h, b);
        tma_load_4d(k_dst + kBoxBytes, &k_map, &k_full[s], 64, j * kBlockN, h, b);
        mbar_wait(&v_empty[s], parity);
        mbar_arrive_expect_tx(&v_full[s], kTileBytes);
        tma_load_4d(v_dst, &v_map, &v_full[s], 0, j * kBlockN, h, b);
        tma_load_4d(v_dst + kBoxBytes, &v_map, &v_full[s], 64, j * kBlockN, h, b);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int cw = tid / 128 - 1;  // consumer warpgroup: query rows 64 cw ..
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane / 4;  // row of the fragment within 8
  const int t = lane % 4;  // column pair of the fragment
  const int r0 = qt * kBlockM + 64 * cw + 16 * warp + g;  // rows r0 and r0 + 8
  const char* q_wg = sQ + cw * 64 * 128;  // this warpgroup's rows in each box

  float acc[64];  // O accumulator, 64 rows x 128
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  uint32_t pf[kBlockN / 16][4];  // P of the previous tile, bf16 A fragments

  // The two warpgroups take turns to issue their products (named barrier
  // 1 + cw is this one's turn), so one's softmax overlaps the other's
  // products; warpgroup 0 goes first. Tile 0 is peeled off the loop so that
  // every product in the loop is issued and waited for unconditionally.
  if (cw == 1) named_arrive(1, 256);
  mbar_wait(q_full, 0);
  {
    float sc[64];
    mbar_wait(&k_full[0], 0);
    named_sync(1 + cw, 256);
    wgmma_fence();
    issue_scores(sc, q_wg, sK);
    named_arrive(2 - cw, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&k_empty[0]);  // K_0 may be refilled
    float alpha[2];
    online_softmax(sc, m_run, l_run, alpha, scale_log2, qt == 0, 0, r0, t);
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) pack_a(pf[kk], sc, kk);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int sp = (j - 1) % kStages;  // the previous tile's stage
    // Issue S_j = Q K_j^T, then O += P_{j-1} V_{j-1}; the softmax of S_j
    // runs while the second product is in flight.
    float sc[64];
    mbar_wait(&k_full[s], (j / kStages) & 1);
    mbar_wait(&v_full[sp], ((j - 1) / kStages) & 1);
    named_sync(1 + cw, 256);
    wgmma_fence();
    issue_scores(sc, q_wg, sK + s * kTileBytes);
    issue_pv(acc, pf, sV + sp * kTileBytes);
    named_arrive(2 - cw, 256);
    wgmma_wait<1>();
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&k_empty[s]);  // K_j may be refilled
    float alpha[2];
    online_softmax(sc, m_run, l_run, alpha, scale_log2, j == qt, j * kBlockN, r0, t);
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&v_empty[sp]);  // V_{j-1} may be refilled
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) pack_a(pf[kk], sc, kk);
  }
  // the last tile's O += P V, and warpgroup 0 takes warpgroup 1's last turn
  const int sl = (n_tiles - 1) % kStages;
  mbar_wait(&v_full[sl], ((n_tiles - 1) / kStages) & 1);
  wgmma_fence();
  issue_pv(acc, pf, sV + sl * kTileBytes);
  wgmma_wait<0>();
  fence_regs(acc);
  if (cw == 0) named_sync(1, 256);

  // Epilogue: O / l as bf16 into this warpgroup's own rows of the Q tile
  // (free: its last S product is done, and the other warpgroup reads only
  // its own rows), then two TMA stores, clipped at S
  char* o_wg = sQ + cw * 64 * 128;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const int local = 16 * warp + g + 8 * r;
    const float l = quad_sum(l_run[r]);
    const float inv = 1.f / l;
    if (lse != nullptr && t == 0 && row < seq) {
      lse[static_cast<int64_t>(bh) * seq + row] = (m_run[r] + log2f(l)) * kLn2;
    }
#pragma unroll
    for (int c = 0; c < kDh / 8; ++c) {
      char* at = swizzled(o_wg + (c / 8) * kBoxBytes, local, 8 * (c % 8) + 2 * t);
      *reinterpret_cast<uint32_t*>(at) =
          pack_bf16(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    }
  }
  fence_async_shared();
  named_sync(3 + cw, 128);  // this warpgroup's rows are written
  if (tid % 128 == 0) {
    const int row0 = qt * kBlockM + 64 * cw;
    tma_store_4d(&o_map, o_wg, 0, row0, h, b);
    tma_store_4d(&o_map, o_wg + kBoxBytes, 64, row0, h, b);
    tma_store_wait_read();
  }
}

}  // namespace

extern "C" {

// q, k, v, o: bf16 (B, H, S, 128) with the given element strides (batch,
// head, sequence); the head dimension is contiguous and every row starts on
// a 16-byte boundary (the wrapper checks both). lse: null, or a contiguous
// float32 (B, H, S) output. Returns 0, or the first cudaError_t of the
// tensor maps' encoding, the launch's attribute or the launch itself.
int ecoflap_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                           int batch, int heads, int seq, int head_dim, int64_t qsb,
                           int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
                           int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
                           int64_t oss, float sm_scale, void* stream) {
  if (head_dim != kDh || seq <= 0 || seq % 64 != 0 || batch <= 0 || heads <= 0 ||
      static_cast<int64_t>(batch) * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap q_map, k_map, v_map, o_map;
  int rc = encode_bhsd(&q_map, q, batch, heads, seq, qsb, qsh, qss, kBlockM);
  if (rc == 0) rc = encode_bhsd(&k_map, k, batch, heads, seq, ksb, ksh, kss, kBlockN);
  if (rc == 0) rc = encode_bhsd(&v_map, v, batch, heads, seq, vsb, vsh, vss, kBlockN);
  if (rc == 0) rc = encode_bhsd(&o_map, o, batch, heads, seq, osb, osh, oss, 64);
  if (rc != 0) return rc;
  // above 48 KB, dynamic shared memory must be asked for explicitly
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kBlockM - 1) / kBlockM, batch * heads);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, o_map, static_cast<float*>(lse), heads, seq, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
