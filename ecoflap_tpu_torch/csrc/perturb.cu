// Gaussian perturbation for zeroth-order (MeZO) scoring:
//     w[i] += scale * z[i]   (in place), or
//     out[i] = w[i] + scale * z[i]   (out of place),
// z ~ N(0, 1) generated inside the kernel.
//
// Replaces the TPU kernels ecoflap_tpu/ops/perturb.py:_perturb_block_kernel
// (wrapper perturb_block_inplace; the in-place entry) and
// ecoflap_tpu/ops/perturb.py:_perturb_kernel (wrapper perturb; the
// out-of-place entry), which drew z from the TPU's own PRNG.
//
// The stream. z comes from a counter-based Philox4x32-10 keyed by a 64-bit
// seed. Counter j = (lo(j), hi(j), 0, 0) gives four words, two Box-Muller
// pairs, and each pair gives two normals, its cos and its sin branch:
// elements 4j, 4j + 1 are the cos and sin of words (0, 1), elements 4j + 2,
// 4j + 3 those of words (2, 3). So z depends only on (seed, element index),
// never on the launch shape or the start address: the plain PyTorch version
// in ecoflap_tpu_torch/ops/perturb.py reproduces the words bit for bit, and
// the same seed gives the same z, which makes +eps, -2eps, +eps an exact
// antithetic cycle without ever storing z.
//
// Transform (as perturb.py:61-71 of the TPU kernel), per word pair: keep 24
// bits of each word (>> 8, * 2^-24), clamp u1 at 1e-7, r = sqrt(-2 ln u1),
// theta = 2 pi u2; z = r cos(theta), and the sin branch r sin(theta), which
// the TPU kernel drops; float32 math, one rounding to the storage type. The
// products and the final add use __fmul_rn/__fadd_rn so the compiler cannot
// contract them into an FMA that the plain version would not reproduce. No
// fast math: __logf is too coarse near u1 = 1e-7.
//
// What bounds it on an H100: instruction issue. One read and one write of
// the weight (4 bytes an element in bf16) take 1.2 ps an element at 3.35
// TB/s, and the stream counted as operations is about 30 an element (0.44
// ps at the float32 rate); but the accurate logf, sqrtf and sincosf issue
// tens of instructions each, so issue slots, not bytes, set the time. So
// the design spends as few instructions per element as the stream allows:
//  - every Philox call serves four elements (all four words are used, and
//    both branches of each pair);
//  - the ten round keys are computed once on the host and passed as kernel
//    parameters, so the rounds read them from the constant bank;
//  - 32-bit index arithmetic when n < 2^31 (a template flag), 64-bit above;
//  - 16-byte loads and stores: a thread takes 8 bf16 or 4 f32 elements at a
//    time, a short fixed loop of kItems such vectors, no grid-stride. The
//    elements before the first 16-byte boundary (a view such as leaf[idx]
//    of a ragged leaf starts anywhere) and the ragged tail go one at a time,
//    on the same element-index stream, so alignment never changes z.
// The noise never touches device memory: no z buffer, one pass over w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr int kItems = 2;  // 16-byte vectors per thread
constexpr int kPerCounter = 4;  // elements per Philox counter

// Philox4x32-10's key schedule (Random123's philox4x32_R(10, ...)): round r
// uses (lo(seed) + r W0, hi(seed) + r W1) mod 2^32.
struct RoundKeys {
  uint32_t k0[10];
  uint32_t k1[10];
};

RoundKeys round_keys(uint64_t seed) {
  RoundKeys rk;
  uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  for (int r = 0; r < 10; ++r) {
    rk.k0[r] = k0;
    rk.k1[r] = k1;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return rk;
}

__device__ __forceinline__ uint32_t hi32(uint32_t) { return 0u; }
__device__ __forceinline__ uint32_t hi32(uint64_t j) { return static_cast<uint32_t>(j >> 32); }

// The four words of counter (lo(j), hi(j), 0, 0).
template <typename Index>
__device__ __forceinline__ uint4 philox(const RoundKeys& rk, Index j) {
  uint32_t c0 = static_cast<uint32_t>(j), c1 = hi32(j), c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ rk.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ rk.k1[r];
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float uniform24(uint32_t w) {
  return __fmul_rn(static_cast<float>(w >> 8), 5.9604644775390625e-08f);  // 2^-24, exact
}

__device__ __forceinline__ float radius(uint32_t w) {
  return sqrtf(__fmul_rn(-2.0f, logf(fmaxf(uniform24(w), 1e-7f))));
}

__device__ __forceinline__ float angle(uint32_t w) {
  return __fmul_rn(6.28318530717958647692f, uniform24(w));
}

// The normals of one counter's words, in element order.
__device__ __forceinline__ void normals(uint4 w, float (&z)[kPerCounter]) {
  const float r0 = radius(w.x), r1 = radius(w.z);
  float s0, c0, s1, c1;
  sincosf(angle(w.y), &s0, &c0);
  sincosf(angle(w.w), &s1, &c1);
  z[0] = __fmul_rn(r0, c0);
  z[1] = __fmul_rn(r0, s0);
  z[2] = __fmul_rn(r1, c1);
  z[3] = __fmul_rn(r1, s1);
}

__device__ __forceinline__ float add_noise(float w, float scale, float z) {
  return __fadd_rn(w, __fmul_rn(scale, z));
}

// 16-byte vector and single-element access, widened to float32.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  static __device__ void load(const float* p, float (&v)[kVec]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  static __device__ void store(float* p, const float (&v)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ float load1(const float* p) { return *p; }
  static __device__ void store1(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ void load(const __nv_bfloat16* p, float (&v)[kVec]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x, v[2 * k + 1] = f.y;
    }
  }
  static __device__ void store(__nv_bfloat16* p, const float (&v)[kVec]) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
  static __device__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// Elements [head, head + nvec * kVec) go by 16-byte vectors, kItems of them
// a thread; the at most kVec - 1 elements before (head) and after (the tail)
// go one a thread. kPhase = head % kPerCounter: where a vector's first
// element sits within its counter. dst == src is the in-place form; each
// element is read and written by one thread, so the two may alias.
template <typename T, typename Index, int kPhase>
__global__ void __launch_bounds__(kThreads)
perturb_kernel(const T* src, T* dst, Index n, Index head, Index nvec, RoundKeys rk,
               float scale) {
  constexpr int kVec = Io<T>::kVec;
  constexpr int kCounters = (kPhase + kVec + kPerCounter - 1) / kPerCounter;
  const Index first = static_cast<Index>(blockIdx.x) * (kThreads * kItems) + threadIdx.x;
#pragma unroll 1
  for (int it = 0; it < kItems; ++it) {
    const Index v = first + static_cast<Index>(it * kThreads);
    if (v >= nvec) break;
    const Index e = head + v * kVec;
    const Index j0 = (e - kPhase) / kPerCounter;
    float w[kVec];
    Io<T>::load(src + e, w);
#pragma unroll
    for (int c = 0; c < kCounters; ++c) {
      float z[kPerCounter];
      normals(philox(rk, j0 + c), z);
#pragma unroll
      for (int q = 0; q < kPerCounter; ++q) {
        const int k = c * kPerCounter + q - kPhase;
        if (k >= 0 && k < kVec) w[k] = add_noise(w[k], scale, z[q]);
      }
    }
    Io<T>::store(dst + e, w);
  }
  const Index t = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  const Index body_end = head + nvec * kVec;
  if (t < head + (n - body_end)) {
    const Index i = t < head ? t : body_end + (t - head);
    float z[kPerCounter];
    normals(philox(rk, i / kPerCounter), z);
    float zi = z[0];
#pragma unroll
    for (int q = 1; q < kPerCounter; ++q)
      if (i % kPerCounter == q) zi = z[q];
    Io<T>::store1(dst + i, add_noise(Io<T>::load1(src + i), scale, zi));
  }
}

// The raw stream, for checking the plain version bit for bit: out[j] holds
// counter j's four words.
__global__ void __launch_bounds__(kThreads)
philox_words_kernel(uint4* __restrict__ out, uint64_t m, RoundKeys rk) {
  const uint64_t j = static_cast<uint64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j < m) out[j] = philox(rk, j);
}

template <typename T, typename Index, int kPhase = 0>
void launch_phase(int phase, unsigned int blocks, cudaStream_t s, const T* src, T* dst,
                  uint64_t n, uint64_t head, uint64_t nvec, const RoundKeys& rk,
                  float scale) {
  if constexpr (kPhase < kPerCounter) {
    if (phase != kPhase) {
      launch_phase<T, Index, kPhase + 1>(phase, blocks, s, src, dst, n, head, nvec, rk,
                                         scale);
      return;
    }
    perturb_kernel<T, Index, kPhase><<<blocks, kThreads, 0, s>>>(
        src, dst, static_cast<Index>(n), static_cast<Index>(head),
        static_cast<Index>(nvec), rk, scale);
  }
}

template <typename T>
int launch_typed(const void* src_, void* dst_, uint64_t n, uint64_t seed, float scale,
                 cudaStream_t s) {
  constexpr int kVec = Io<T>::kVec;
  const T* src = static_cast<const T*>(src_);
  T* dst = static_cast<T*>(dst_);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(src);
  // the vectors need src and dst at the same distance from a 16-byte
  // boundary (the out-of-place wrapper allocates its output so)
  if (addr % sizeof(T) != 0 || ((addr ^ reinterpret_cast<uintptr_t>(dst)) & 15u) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  uint64_t head = ((16u - (addr & 15u)) & 15u) / sizeof(T);
  if (head > n) head = n;
  const uint64_t nvec = (n - head) / kVec;
  const uint64_t per_block = static_cast<uint64_t>(kThreads) * kItems;
  const uint64_t blocks = nvec > 0 ? (nvec + per_block - 1) / per_block : 1;
  if (blocks > 0x7FFFFFFFull) return static_cast<int>(cudaErrorInvalidValue);
  const RoundKeys rk = round_keys(seed);
  const int phase = static_cast<int>(head % kPerCounter);
  if (n < (1ull << 31)) {
    launch_phase<T, uint32_t>(phase, static_cast<unsigned int>(blocks), s, src, dst, n,
                              head, nvec, rk, scale);
  } else {
    launch_phase<T, uint64_t>(phase, static_cast<unsigned int>(blocks), s, src, dst, n,
                              head, nvec, rk, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_perturb(const void* src, void* dst, int dtype, uint64_t n, uint64_t seed,
                   float scale, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(src, dst, n, seed, scale, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(src, dst, n, seed, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
// so the two give the same bits for the same seed. out must lie at w's
// distance from a 16-byte boundary.
int ecoflap_perturb(const void* w, void* out, int dtype, uint64_t n,
                    uint64_t seed, float scale, void* stream) {
  return launch_perturb(w, out, dtype, n, seed, scale, stream);
}

// The four words of counters 0..m-1 into out[4j..4j+3] (16-byte aligned).
int ecoflap_philox_words(void* out, uint64_t m, uint64_t seed, void* stream) {
  if (m == 0) return 0;
  const uint64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFull) return static_cast<int>(cudaErrorInvalidValue);
  philox_words_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(out), m, round_keys(seed));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
