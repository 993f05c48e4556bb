// SparseGPT's in-block OBS column sweep: for one column block of B <= 128
// columns of K same-shape weights, per row r and column i = 0 .. B-1 in turn,
//     q      = mask[r, i] ? 0 : w[r, i]
//     err    = (w[r, i] - q) / Hinv1[i, i]
//     w[r, j] = w[r, j] - err * Hinv1[i, j]      for j > i, the product rounded
// then Q (the q of every column) is written over the block's columns of the
// weight, in place, and Err (the err of every column) to its own buffer.
// With prune_n != 0 the mask is chosen inside the sweep instead: at each i
// with i % prune_m == 0, the prune_n smallest of w^2 / Hinv1[j, j]^2 over
// columns i .. i+prune_m-1 of the row's updated weights, ties by position,
// NaN above everything (a stable ascending sort's first prune_n).
//
// Replaces no TPU kernel: the JAX package runs this sweep as an XLA
// fori_loop (ecoflap_tpu/pruning/sparsegpt.py). The plain PyTorch version is
// _sweep_block in ecoflap_tpu_torch/pruning/sparsegpt.py; this kernel does
// its arithmetic in its order, one IEEE rounding per operation as the eager
// kernels round: the division correctly rounded (no fast math), and the
// update the product rounded, then the difference, as addcmul_(...,
// value=-1) computes a + value * (b * c), with no fused multiply-add. So on
// the card the two give the same bits. The saliency is (w * w) / (d * d),
// as w ** 2 / d ** 2 is computed there. The _rn intrinsics keep the
// compiler from contracting a product and a sum into one rounding. A column
// before i is never written at step i, so a non-finite Hinv1 entry cannot
// reach a finished column, and nothing mixes rows or lanes: a lane whose
// Hinv1 is NaN leaves the others exact.
//
// What bounds it on an H100: the 128-step dependent chain of each row (the
// pruned-or-kept select, a subtraction, the shuffle of the difference, the
// division, then the product and the difference of the next column); the
// bytes (W read, Q and Err written, the mask read: 13 bytes an element in
// float32, 3 us at 6144 rows) and the operations (1.5 us) come far behind.
// So the design keeps the chain in registers and short:
// * one warp sweeps two rows side by side: two independent chains, one read
//   of Hinv1 for both;
// * lane l holds columns l, l + 32, l + 64, l + 96, so every load and store
//   of a warp is 32 consecutive elements whatever the row's alignment or B,
//   and the loop over column i = 32 E + l runs with E fixed at compile time:
//   no register is picked at run time, finished elements are skipped;
// * the owner lane's difference is broadcast by __shfl_sync and every lane
//   divides it; a zero difference (a kept entry, half the columns) is
//   multiplied by zero_over(d) instead, since the IEEE division takes its
//   slow path for a zero dividend (without this: 58 us a block at 1408
//   rows, not 32);
// * each CTA stages Hinv1's upper triangle (and zero_over of its diagonal)
//   in shared memory once, then walks row pairs, no more CTAs than fit on
//   the card at once: a step's Hinv1 row is one conflict-free shared load,
//   not an L2 round trip inside the chain (the first design, which read it
//   from global memory and divided at every step, took 79-155 us a block);
// * the mask is 4 bits a lane.
// Measured on an H100 (chip_smoke.py phase 3): 33-43 us a 128-column block
// at 1408-6144 rows, some 10 us of it the staging, against the 0.7-3.1 us
// bytes bound. Grid: (min(ceil(rows / 16), CTAs resident / K), K) CTAs of 8
// warps.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 2;  // rows a warp sweeps side by side
constexpr int kMaxBlock = 128;
constexpr int kPerLane = kMaxBlock / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// z with 0 * z == 0 / d, bit for bit, for every d: NaN for a zero or NaN d,
// else 1 with d's sign
__device__ __forceinline__ float zero_over(float d) {
  return d == 0.0f || d != d ? __int_as_float(0x7fffffff) : copysignf(1.0f, d);
}
__device__ __forceinline__ double zero_over(double d) {
  return d == 0.0 || d != d ? __longlong_as_double(0x7fffffffffffffffll) : copysign(1.0, d);
}

// a before b in a stable ascending sort that puts NaN last (torch.sort)
template <typename T>
__device__ __forceinline__ bool sorts_before(T a, T b, bool a_first) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return !an || (bn && a_first);
  return a < b || (a == b && a_first);
}

// v[e] for a run-time e, without indexing registers (which would spill them)
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[kPerLane], int e) {
  T out = v[0];
#pragma unroll
  for (int k = 1; k < kPerLane; ++k)
    if (e == k) out = v[k];
  return out;
}

// One row's state in a lane: its columns' weights (Q once swept), errors and
// prune bits.
template <typename T>
struct Row {
  T w[kPerLane], err[kPerLane];
  unsigned bits;
};

// The n:m refresh at column i: the group [i, end)'s prune bits from the
// row's updated weights, d the block's Hinv1 in shared memory.
template <typename T>
__device__ __forceinline__ void refresh(Row<T>& r, const T* d, int bsz, int i, int end,
                                        int prune_n, int lane) {
  T sal[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int c = lane + 32 * e;
    const T dc = c >= i && c < end ? d[c * bsz + c] : T(1);
    sal[e] = div_rn(mul_rn(r.w[e], r.w[e]), mul_rn(dc, dc));
  }
  int rank[kPerLane] = {};
  for (int t = i; t < end; ++t) {
    const T s = __shfl_sync(kFull, pick(sal, t >> 5), t & 31);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = lane + 32 * e;
      if (t != c && sorts_before(s, sal[e], t < c)) ++rank[e];
    }
  }
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int c = lane + 32 * e;
    if (c >= i && c < end) r.bits = rank[e] < prune_n ? r.bits | (1u << e) : r.bits & ~(1u << e);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
sparsegpt_sweep_kernel(T* w, int64_t w_k_stride, int64_t w_row_stride, int rows, int bsz,
                       const T* hinv, int64_t h_k_stride, int64_t h_row_stride,
                       const uint8_t* mask, T* err, int prune_n, int prune_m) {
  // the block's Hinv1, row-major, bsz x bsz (its upper triangle), then
  // zero_over of its diagonal
  extern __shared__ __align__(16) unsigned char smem[];
  T* d = reinterpret_cast<T*>(smem);
  T* rd = d + bsz * bsz;
  const int k = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const T* h = hinv + k * h_k_stride;
  for (int i = threadIdx.x >> 5; i < bsz; i += kWarps) {
#pragma unroll 4
    for (int j = i + lane; j < bsz; j += 32) d[i * bsz + j] = h[i * h_row_stride + j];
    if (lane == 0) rd[i] = zero_over(h[i * h_row_stride + i]);
  }
  __syncthreads();

  const int stride = gridDim.x * kWarps * kRows;
  for (int r0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows; r0 < rows; r0 += stride) {
    Row<T> rs[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + r;
      const T* wr = w + k * w_k_stride + static_cast<int64_t>(row) * w_row_stride;
      const uint8_t* mr =
          prune_n == 0 ? mask + (static_cast<int64_t>(k) * rows + row) * bsz : nullptr;
      rs[r].bits = 0;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int c = lane + 32 * e;
        const bool in = row < rows && c < bsz;
        rs[r].w[e] = in ? wr[c] : T(0);
        rs[r].err[e] = T(0);
        if (prune_n == 0 && in && mr[c]) rs[r].bits |= 1u << e;
      }
    }
    // column i = 32 E + l is lane l's element E: with E fixed at compile
    // time, no register is picked at run time, and the elements before E,
    // all finished, are not visited
#pragma unroll
    for (int E = 0; E < kPerLane; ++E) {
#pragma unroll 1
      for (int l = 0; l < min(32, bsz - 32 * E); ++l) {
        const int i = 32 * E + l;
        const T* di = d + i * bsz;
        if (prune_n != 0 && i % prune_m == 0) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            refresh(rs[r], d, bsz, i, min(i + prune_m, bsz), prune_n, lane);
        }
        T q[kRows], e_i[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          q[r] = (rs[r].bits >> E) & 1u ? T(0) : rs[r].w[E];
          const T x = __shfl_sync(kFull, rs[r].w[E] - q[r], l);
          // x / d, and a zero x (a kept entry) as x * zero_over(d): the
          // division takes its slow path for a zero dividend, and this
          // keeps it off the chain
          if (x != T(0))
            e_i[r] = div_rn(x, di[i]);
          else
            e_i[r] = mul_rn(x, rd[i]);
        }
        if (lane > l && lane + 32 * E < bsz) {
          const T hij = di[lane + 32 * E];
#pragma unroll
          for (int r = 0; r < kRows; ++r) rs[r].w[E] = sub_rn(rs[r].w[E], mul_rn(e_i[r], hij));
        }
        if (lane == l) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) rs[r].w[E] = q[r], rs[r].err[E] = e_i[r];
        }
#pragma unroll
        for (int e = E + 1; e < kPerLane; ++e) {
          const int c = lane + 32 * e;
          if (c < bsz) {
            const T hij = di[c];
#pragma unroll
            for (int r = 0; r < kRows; ++r) rs[r].w[e] = sub_rn(rs[r].w[e], mul_rn(e_i[r], hij));
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + r;
      if (row >= rows) continue;
      T* wr = w + k * w_k_stride + static_cast<int64_t>(row) * w_row_stride;
      T* er = err + (static_cast<int64_t>(k) * rows + row) * bsz;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int c = lane + 32 * e;
        if (c < bsz) wr[c] = rs[r].w[e], er[c] = rs[r].err[e];
      }
    }
  }
}

template <typename T>
int launch(void* w, int k, int rows, int bsz, int64_t w_k_stride, int64_t w_row_stride,
           const void* hinv, int64_t h_k_stride, int64_t h_row_stride, const void* mask,
           void* err, int prune_n, int prune_m, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (bsz + 1) * bsz;
  // per device: the shared memory opt-in above 48 KB and the CTAs that fit
  static int ready[64] = {}, resident[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    cudaFuncSetAttribute(sparsegpt_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(sizeof(T) * (kMaxBlock + 1) * kMaxBlock));
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sparsegpt_sweep_kernel<T>,
                                                  kWarps * 32,
                                                  sizeof(T) * (kMaxBlock + 1) * kMaxBlock);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
    ready[dev] = 1;
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }
  // enough CTAs to cover the rows, no more than fit at once over the K lanes
  const int need = (rows + kWarps * kRows - 1) / (kWarps * kRows);
  const int fit = (resident[dev] + k - 1) / k;
  const dim3 grid(need < fit ? need : fit, k);
  sparsegpt_sweep_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<T*>(w), w_k_stride, w_row_stride, rows, bsz, static_cast<const T*>(hinv),
      h_k_stride, h_row_stride, static_cast<const uint8_t*>(mask), static_cast<T*>(err),
      prune_n, prune_m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. w: the block's first column of a (K, rows,
// >= bsz) weight, strides in elements, unit column stride; hinv: Hinv1[0, 0]
// of a (K, bsz, bsz) block, unit column stride; mask: (K, rows, bsz) bytes,
// contiguous (read only when prune_n == 0); err: (K, rows, bsz), contiguous.
// The caller checks shapes and bounds (1 <= bsz <= 128, 1 <= K <= 65535; with
// prune_n != 0, 1 <= prune_m <= 32). Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
int ecoflap_sparsegpt_sweep(void* w, int dtype, int k, int rows, int bsz,
                            int64_t w_k_stride, int64_t w_row_stride, const void* hinv,
                            int64_t h_k_stride, int64_t h_row_stride, const void* mask,
                            void* err, int prune_n, int prune_m, void* stream) {
  if (k < 1 || k > 65535 || rows < 1 || bsz < 1 || bsz > kMaxBlock || dtype < 0 || dtype > 1 ||
      (prune_n != 0 && (prune_m < 1 || prune_m > 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(w, k, rows, bsz, w_k_stride, w_row_stride, hinv, h_k_stride,
                                    h_row_stride, mask, err, prune_n, prune_m, s)
                    : launch<double>(w, k, rows, bsz, w_k_stride, w_row_stride, hinv, h_k_stride,
                                     h_row_stride, mask, err, prune_n, prune_m, s);
}

}  // extern "C"
