// Device code shared by the port's Adam kernels (sparse_adam.cu,
// fused_adam.cu): typed loads and stores for f32 / bf16 storage — one
// element at a time for the scalar kernels, 8 consecutive elements in
// 16-byte accesses for the vector kernels — the stochastically rounded
// bf16 weight store, one element's Adam step, and the launchers' grid size.
//
// The vector forms do the scalar forms' arithmetic on each of their 8
// elements, so a vector kernel and a scalar kernel leave the same bits.
// w, m, v and a dense gradient are touched once per update and are far
// larger than the L2 cache: their vector accesses are the streaming
// (evict-first) forms __ldcs / __stcs.
//
// The random bits of the stochastic rounding are the murmur3 32-bit
// finalizer over (storage element index, seed) — the hash of
// ops/rounding.py and of the JAX package, so the kernels, their plain
// PyTorch versions and JAX round the same element the same way.
//
// Arithmetic is IEEE single precision in the plain versions' operation
// order, written with the round-to-nearest intrinsics so that nothing is
// contracted into an FMA whatever the build flags say.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aread {

__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t seed) {
  uint32_t h = idx * 0x9E3779B9u + seed * 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_rn(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_rn(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// weight store of element i: exact for f32, stochastic rounding for bf16,
// keyed by `key` and the seed. The key is the element's index in the whole
// table (below 2^32): its storage index, or for a row shard of the table
// that index plus the shard's first element's.
__device__ __forceinline__ void store_w(float* p, size_t i, uint32_t, float x,
                                        uint32_t) {
  p[i] = x;
}
__device__ __forceinline__ void store_w(__nv_bfloat16* p, size_t i,
                                        uint32_t key, float x, uint32_t seed) {
  uint32_t b = __float_as_uint(x);
  b = (b + (hash_bits(key, seed) & 0xFFFFu)) & 0xFFFF0000u;
  p[i] = __ushort_as_bfloat16(static_cast<unsigned short>(b >> 16));
}
// keyed by the storage index
template <typename WT>
__device__ __forceinline__ void store_w(WT* p, uint32_t i, float x,
                                        uint32_t seed) {
  store_w(p, i, i, x, seed);
}

// ---- 8 consecutive elements from a 16-byte aligned address ----
constexpr int VEC = 8;

__device__ __forceinline__ void load8_cs(const float* p, float (&x)[VEC]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// 8 bf16 elements as one 16-byte word: element 2j of the vector is the low
// half of 32-bit word j, element 2j+1 the high half (little-endian), which
// is __nv_bfloat162's (.x, .y). The bf16 loads and stores below are these
// conversions around a streaming access; a kernel that moves the words
// through shared memory (adam_attrib.cu's TMA sweep) calls them directly.
__device__ __forceinline__ void unpack8(const uint4& u, float (&x)[VEC]) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[j]));
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8_rn(const float (&x)[VEC]) {
  uint32_t words[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * j]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * j + 1]));
    words[j] = lo | (hi << 16);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ uint4 pack8_w(uint32_t base, const float (&x)[VEC],
                                         uint32_t seed) {
  uint32_t words[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo =
        (__float_as_uint(x[2 * j]) + (hash_bits(base + 2 * j, seed) & 0xFFFFu)) >> 16;
    const uint32_t hi = (__float_as_uint(x[2 * j + 1]) +
                         (hash_bits(base + 2 * j + 1, seed) & 0xFFFFu)) &
                        0xFFFF0000u;
    words[j] = lo | hi;
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ void load8_cs(const __nv_bfloat16* p,
                                         float (&x)[VEC]) {
  unpack8(__ldcs(reinterpret_cast<const uint4*>(p)), x);
}

__device__ __forceinline__ void store8_rn(float* p, const float (&x)[VEC]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1,
         make_float4(x[4], x[5], x[6], x[7]));
}
__device__ __forceinline__ void store8_rn(__nv_bfloat16* p,
                                          const float (&x)[VEC]) {
  __stcs(reinterpret_cast<uint4*>(p), pack8_rn(x));
}

// weight store of 8 elements (p already points at the first): element i of
// the vector is rounded with the hash of key base + i, as store_w rounds it
// (base is the first element's storage index, or its index in the whole
// table for a shard)
__device__ __forceinline__ void store8_w(float* p, uint32_t,
                                         const float (&x)[VEC], uint32_t) {
  store8_rn(p, x);
}
__device__ __forceinline__ void store8_w(__nv_bfloat16* p, uint32_t base,
                                         const float (&x)[VEC], uint32_t seed) {
  __stcs(reinterpret_cast<uint4*>(p), pack8_w(base, x, seed));
}

// The f32 scalars of one step (ops/sparse_adam.py::adam_scalars): decay is
// wd + 2 * l2, b1c / b2c the bias corrections 1 - b^t, omb1 / omb2 the
// coefficients 1 - b.
struct AdamScalars {
  float lr, b1, b2, eps, decay, b1c, b2c, omb1, omb2;
};

// the launch's step-independent scalars completed with lr, b1c and b2c
// (their f32 bits) from the step's [4]-word block on the device
// (ops/sparse_adam.py::step_scalars: lr, b1c, b2c, then the seed, which the
// kernels read as step[3]). The block is written before the launch, so a
// CUDA graph that captured the launch replays each step with its own.
__device__ __forceinline__ AdamScalars with_step(AdamScalars s,
                                                 const uint32_t* step) {
  s.lr = __uint_as_float(__ldg(step + 0));
  s.b1c = __uint_as_float(__ldg(step + 1));
  s.b2c = __uint_as_float(__ldg(step + 2));
  return s;
}

// One element of torch-semantics Adam from its data gradient gd:
//   g  = gd + decay * w
//   m' = b1 * m + omb1 * g
//   v' = b2 * v + omb2 * g * g
//   w' = w - lr * (m' / b1c) / (sqrt(v' / b2c) + eps)
__device__ __forceinline__ void adam_element(float wf, float mf, float vf,
                                             float gd, const AdamScalars& s,
                                             float* w2, float* m2, float* v2) {
  const float g = __fadd_rn(gd, __fmul_rn(s.decay, wf));
  *m2 = __fadd_rn(__fmul_rn(s.b1, mf), __fmul_rn(s.omb1, g));
  *v2 = __fadd_rn(__fmul_rn(s.b2, vf), __fmul_rn(__fmul_rn(s.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(*v2, s.b2c)), s.eps);
  const float step = __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(*m2, s.b1c)), den);
  *w2 = __fsub_rn(wf, step);
}

// Blocks of 256 threads that fill the current device once with `kernel`
// (occupancy x SMs), computed once per device and kept in `cache`, which the
// caller owns per kernel instantiation. Host code.
constexpr int MAX_DEVICES = 64;
constexpr int BLOCK = 256;

inline cudaError_t full_grid(const void* kernel, int (&cache)[MAX_DEVICES],
                             int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < MAX_DEVICES;
  if (cached && cache[dev] > 0) {
    *grid = cache[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *grid = per_sm * sms > 0 ? per_sm * sms : 1;
  if (cached) cache[dev] = *grid;
  return cudaSuccess;
}

}  // namespace aread
