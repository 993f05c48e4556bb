// Gaussian perturbation for zeroth-order (MeZO) scoring:
//     w[i] += scale * z[i]   (in place), or
//     out[i] = w[i] + scale * z[i]   (out of place),
// z ~ N(0, 1) generated inside the kernel.
//
// Replaces the TPU kernels ecoflap_tpu/ops/perturb.py:_perturb_block_kernel
// (wrapper perturb_block_inplace; the in-place entry) and
// ecoflap_tpu/ops/perturb.py:_perturb_kernel (wrapper perturb; the
// out-of-place entry), which drew z from the TPU's own PRNG.
// Here z comes from a counter-based Philox4x32-10 keyed by a 64-bit seed,
// with the element's linear index as the counter: the stream does not depend
// on the launch shape, so the plain PyTorch version in
// ecoflap_tpu_torch/ops/perturb.py reproduces the words bit for bit, and
// the same seed gives the same z. That makes +eps, -2eps, +eps an exact
// antithetic cycle without ever storing z.
//
// Transform (as perturb.py:61-71 of the TPU kernel): keep 24 bits of each of
// two 32-bit words (>> 8, * 2^-24), clamp u1 at 1e-7, z = sqrt(-2 ln u1) *
// cos(2 pi u2); float32 math, one rounding to the storage type. The products
// and the final add use __fmul_rn/__fadd_rn so the compiler cannot contract
// them into an FMA that the plain version would not reproduce. No fast math:
// __logf is too coarse near u1 = 1e-7.
//
// What bounds it on an H100: one read and one write of the weight (4 bytes an
// element in bf16, 8 in f32) against ten Philox rounds (20 32-bit multiplies
// and 40 XORs) plus log, sqrt and cos per element -- about 113 operations
// against 4 bytes, so the operations bound (float32 rate outside the tensor
// cores) is the larger one. The design keeps the noise out of device memory
// entirely: no z buffer, one pass over the weight, no second read of w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_R(10, ...)):
// counter (lo(idx), hi(idx), 0, 0), key (lo(seed), hi(seed)). Returns the
// first two output words.
__device__ __forceinline__ void philox_words(uint64_t seed, uint64_t idx,
                                             uint32_t* w0, uint32_t* w1) {
  uint32_t c0 = static_cast<uint32_t>(idx);
  uint32_t c1 = static_cast<uint32_t>(idx >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  *w0 = c0;
  *w1 = c1;
}

__device__ __forceinline__ float normal_from_words(uint32_t w0, uint32_t w1) {
  const float two_pow_m24 = 5.9604644775390625e-08f;  // 2^-24, exact
  float u1 = __fmul_rn(static_cast<float>(w0 >> 8), two_pow_m24);
  const float u2 = __fmul_rn(static_cast<float>(w1 >> 8), two_pow_m24);
  u1 = fmaxf(u1, 1e-7f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.28318530717958647692f, u2)));
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One element per thread step, grid-stride over the flat tensor: any shape,
// the ragged tail is the loop bound. dst == src is the in-place form; each
// element is read and written by one thread, so the two may alias.
template <typename T>
__global__ void __launch_bounds__(kThreads)
perturb_kernel(const T* src, T* dst, uint64_t n, uint64_t seed, float scale) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t a, b;
    philox_words(seed, i, &a, &b);
    const float z = normal_from_words(a, b);
    store_f32(dst + i, __fadd_rn(load_f32(src + i), __fmul_rn(scale, z)));
  }
}

// The raw stream, for checking the plain version bit for bit: out[2i],
// out[2i+1] are element i's two words.
__global__ void __launch_bounds__(kThreads)
philox_words_kernel(uint32_t* __restrict__ out, uint64_t n, uint64_t seed) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t a, b;
    philox_words(seed, i, &a, &b);
    out[2 * i] = a;
    out[2 * i + 1] = b;
  }
}

unsigned int grid_for(uint64_t n) {
  // enough resident blocks to fill 132 SMs many times over; the grid-stride
  // loop covers the rest
  const uint64_t want = (n + kThreads - 1) / kThreads;
  const uint64_t cap = 132ull * 64ull;
  return static_cast<unsigned int>(want < cap ? want : cap);
}

int launch_perturb(const void* src, void* dst, int dtype, uint64_t n, uint64_t seed,
                   float scale, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    perturb_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(src), static_cast<float*>(dst), n, seed, scale);
  } else if (dtype == 1) {
    perturb_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(dst), n,
        seed, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// the launch (0 = cudaSuccess).
int ecoflap_perturb_inplace(void* w, int dtype, uint64_t n, uint64_t seed,
                            float scale, void* stream) {
  return launch_perturb(w, w, dtype, n, seed, scale, stream);
}

// Out of place (replaces ecoflap_tpu/ops/perturb.py:_perturb_kernel):
// out = w + scale * z with the stream and arithmetic of the in-place entry,
// so the two give the same bits for the same seed.
int ecoflap_perturb(const void* w, void* out, int dtype, uint64_t n,
                    uint64_t seed, float scale, void* stream) {
  return launch_perturb(w, out, dtype, n, seed, scale, stream);
}

int ecoflap_philox_words(void* out, uint64_t n, uint64_t seed, void* stream) {
  if (n == 0) return 0;
  philox_words_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
