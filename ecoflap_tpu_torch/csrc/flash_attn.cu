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
// Design (FlashAttention-2 forward, mma.sync):
//   * one CTA per (64-row query tile, b * H + h), 4 warps, each warp owning
//     16 query rows; the longest tiles (most keys) are launched first;
//   * the Q tile is staged once in shared memory and held in registers as
//     mma A fragments for the whole key loop;
//   * K and V tiles of 64 keys are double-buffered in shared memory with
//     cp.async: tile j+1 loads while tile j is multiplied. Rows are padded
//     from 256 to 272 bytes, so the ldmatrix reads of eight rows hit eight
//     different bank groups;
//   * S = Q K^T and O += P V through mma.sync.m16n8k16 bf16 -> f32. P is
//     rounded to bf16 for the PV product (as FlashAttention-2 does); the
//     row sum is taken over the float32 P;
//   * online softmax in base 2: x = s * sm_scale * log2(e), running max m,
//     alpha = 2^(m_old - m_new); one division by the row sum at the end,
//     and LSE = (m + log2(l)) * ln(2) when the lse pointer is not null (the
//     forward without a gradient passes null and writes nothing more).
// Inputs and the output take any strides whose last dimension is
// contiguous, so the model's (B, S, H, Dh) -> (B, H, S, Dh) views are read
// in place without a copy.
//
// What bounds it on an H100: at B = 8, H = 32, S = 2048 the causal half of
// Q K^T and P V is 2 * 2 * B * H * Dh * S(S+1)/2 = 2.75e11 operations,
// 0.278 ms at 989 TFLOP/s bf16, against 4 * 8*32*2048*128 * 2 bytes =
// 537 MB, 0.160 ms at 3.35 TB/s: the operations bound. The design keeps the
// S x S scores out of device memory entirely and skips the masked half of
// the work; wgmma, TMA, warp specialisation and persistent scheduling (the
// way to the tensor cores' full rate) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;
constexpr int kBlockM = 64;  // query rows per CTA
constexpr int kBlockN = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRow = kDh + 8;  // padded shared row: 272 bytes
constexpr int kTile = kBlockM * kRow;  // elements of one staged tile
// Q, then two stages of K, then two stages of V
constexpr int kSmemBytes = 5 * kTile * static_cast<int>(sizeof(__nv_bfloat16));
constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBlockM == kBlockN, "the diagonal tile test assumes square tiles");

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

// Rows row0..row0+63 of one (b, h) slice into a padded shared tile, 16
// bytes a copy: 64 rows x 16 chunks over 128 threads.
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm, const __nv_bfloat16* g,
                                          int64_t row_stride, int tid) {
#pragma unroll
  for (int c = tid; c < kBlockM * (kDh / 8); c += kThreads) {
    const int r = c >> 4;
    const int col = (c & 15) * 8;
    cp_async16(sm + r * kRow + col, g + r * row_stride + col);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Strides {
  int64_t b, h, s;  // in elements; the head dimension is contiguous
};

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs, Strides os,
                 int num_heads, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kTile;
  __nv_bfloat16* sV = sK + 2 * kTile;

  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first
  const int b = blockIdx.y / num_heads;
  const int h = blockIdx.y % num_heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row of the fragment within 8
  const int t = lane & 3;   // column pair of the fragment

  const int64_t q0 = static_cast<int64_t>(qt) * kBlockM;
  const __nv_bfloat16* qg = q + b * qs.b + h * qs.h + q0 * qs.s;
  const __nv_bfloat16* kg = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vg = v + b * vs.b + h * vs.h;

  load_tile(sQ, qg, qs.s, tid);
  load_tile(sK, kg, ks.s, tid);
  load_tile(sV, vg, vs.s, tid);
  cp_async_commit();

  uint32_t qf[kDh / 16][4];      // A fragments of this warp's 16 query rows
  float acc[kDh / 8][4];         // O accumulator, 16 rows x 128
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};   // this thread's share of the row sums
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  }

  const int n_tiles = qt + 1;  // key tiles up to and including the diagonal
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      const int64_t k0 = static_cast<int64_t>(j + 1) * kBlockN;
      load_tile(sK + (st ^ 1) * kTile, kg + k0 * ks.s, ks.s, tid);
      load_tile(sV + (st ^ 1) * kTile, vg + k0 * vs.s, vs.s, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * kRow + kk * 16 + (lane >> 4) * 8);
      }
    }

    const __nv_bfloat16* sKs = sK + st * kTile;
    const __nv_bfloat16* sVs = sV + st * kTile;

    // S = Q K^T: 16 rows x 64 keys as 8 tiles of 8 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk2 = 0; kk2 < kDh / 32; ++kk2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sKs + (nt * 8 + (lane & 7)) * kRow + kk2 * 32 + (lane >> 3) * 8);
        mma_bf16(s[nt], qf[2 * kk2], bk[0], bk[1]);
        mma_bf16(s[nt], qf[2 * kk2 + 1], bk[2], bk[3]);
      }
    }

    // scale to base 2, mask the diagonal tile, running max
    const bool diag = (j == qt);
    const int r_lo = warp * 16 + g;  // row within the tile of s[.][0..1]
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (diag) {
          const int col = nt * 8 + 2 * t + (e & 1);
          const int row = r_lo + ((e >> 1) << 3);
          if (col > row) x = kMaskValue;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2f(m_run[i] - mx[i]);  // 0 on the first tile
      m_run[i] = mx[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int d = 0; d < kDh / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // P = 2^(x - m) as bf16 A fragments, 4 k-steps of 16 keys
    uint32_t pf[kBlockN / 16][4];
#pragma unroll
    for (int kp = 0; kp < kBlockN / 16; ++kp) {
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[half][e] = exp2f(s[2 * kp + half][e] - m_run[e >> 1]);
          l_run[e >> 1] += p[half][e];
        }
      }
      pf[kp][0] = pack_bf16(p[0][0], p[0][1]);
      pf[kp][1] = pack_bf16(p[0][2], p[0][3]);
      pf[kp][2] = pack_bf16(p[1][0], p[1][1]);
      pf[kp][3] = pack_bf16(p[1][2], p[1][3]);
    }

    // O += P V: V tiles read transposed, two 8-wide head-dim tiles a load
#pragma unroll
    for (int kp = 0; kp < kBlockN / 16; ++kp) {
#pragma unroll
      for (int dp = 0; dp < kDh / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sVs + (kp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pf[kp], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pf[kp], bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    inv[i] = 1.f / l;
    if (lse != nullptr && t == 0) {
      const int64_t row = q0 + warp * 16 + g + 8 * i;
      lse[static_cast<int64_t>(blockIdx.y) * gridDim.x * kBlockM + row] =
          (m_run[i] + log2f(l)) * kLn2;
    }
  }
  __nv_bfloat16* og = o + b * os.b + h * os.h + (q0 + warp * 16 + g) * os.s;
#pragma unroll
  for (int d = 0; d < kDh / 8; ++d) {
    const int col = d * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(og + col) = pack_bf16(acc[d][0] * inv[0], acc[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(og + 8 * os.s + col) =
        pack_bf16(acc[d][2] * inv[1], acc[d][3] * inv[1]);
  }
}

}  // namespace

extern "C" {

// q, k, v, o: bf16 (B, H, S, 128) with the given element strides (batch,
// head, sequence); the head dimension is contiguous and every row starts on
// a 16-byte boundary (the wrapper checks both). lse: null, or a contiguous
// float32 (B, H, S) output. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess).
int ecoflap_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                           int batch, int heads, int seq, int head_dim, int64_t qsb,
                           int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
                           int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
                           int64_t oss, float sm_scale, void* stream) {
  if (head_dim != kDh || seq <= 0 || seq % kBlockM != 0 || batch <= 0 || heads <= 0 ||
      static_cast<int64_t>(batch) * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB, dynamic shared memory must be asked for explicitly
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(seq / kBlockM, batch * heads);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Strides{qsb, qsh, qss}, Strides{ksb, ksh, kss},
      Strides{vsb, vsh, vss}, Strides{osb, osh, oss}, heads, sm_scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
