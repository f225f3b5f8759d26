// Device code shared by the port's Adam kernels (sparse_adam.cu,
// fused_adam.cu): typed loads and stores for f32 / bf16 storage, the
// stochastically rounded bf16 weight store, and one element's Adam step.
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

// weight store: exact for f32, stochastic rounding for bf16, keyed by the
// element's storage index (below 2^32) and the seed
__device__ __forceinline__ void store_w(float* p, uint32_t i, float x, uint32_t) { p[i] = x; }
__device__ __forceinline__ void store_w(__nv_bfloat16* p, uint32_t i, float x,
                                        uint32_t seed) {
  uint32_t b = __float_as_uint(x);
  b = (b + (hash_bits(i, seed) & 0xFFFFu)) & 0xFFFF0000u;
  p[i] = __ushort_as_bfloat16(static_cast<unsigned short>(b >> 16));
}

// The f32 scalars of one step (ops/sparse_adam.py::adam_scalars): decay is
// wd + 2 * l2, b1c / b2c the bias corrections 1 - b^t, omb1 / omb2 the
// coefficients 1 - b.
struct AdamScalars {
  float lr, b1, b2, eps, decay, b1c, b2c, omb1, omb2;
};

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

}  // namespace aread
