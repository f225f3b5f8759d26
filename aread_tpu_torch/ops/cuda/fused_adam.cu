// One fused torch-semantics Adam step on a leaf of any shape from its dense
// gradient — the Hopper kernel that replaces the TPU kernel
// aread_tpu/ops/pallas/fused_adam.py::_adam_kernel (entry
// fused_adam_update). On the dense-table-gradient path of the generic
// Trainer it updates the fused embedding table once per step.
//
// What it computes, for every element e of the flat leaf:
//   g  = gd[e] + decay * w[e]         decay = wd + 2 * l2
//   m' = b1 * m + omb1 * g
//   v' = b2 * v + omb2 * g * g
//   w' = w - lr * (m' / b1c) / (sqrt(v' / b2c) + eps)
// w, m and v are updated in place. w is f32 or bf16 (bf16: f32 compute and
// a stochastically rounded write keyed by murmur3-fmix32(e, seed), which
// the TPU entry point leaves to its plain version); m and v are f32 or
// bf16 (round to nearest); the gradient is f32 or bf16.
//
// Bound: HBM bytes. Each element reads w, m, v, g and writes w, m, v once:
// 28 B all-f32, 20 B with bf16 moments; a dozen flops per element are far
// below the card's rate at that traffic. The design is one grid-stride
// pass, a thread per element and coalesced 4- or 2-byte accesses; the
// TPU kernel's (1024, 128) blocks, its 128-lane flat view with a padded
// tail and its input/output aliasing have no counterpart — any element
// count below 2^32 is taken as it is.
//
// Arithmetic is IEEE single precision in the plain version's operation
// order (rounding.cuh, shared with sparse_adam.cu; the build passes
// --fmad=false and keeps IEEE division and sqrt), so the result is bitwise
// equal to the plain PyTorch version, and to the sparse sweep fed the same
// gradient in (uids, gsum) form.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rounding.cuh"

namespace {

using aread::AdamScalars;
using aread::load_f;
using aread::store_rn;
using aread::store_w;

template <typename WT, typename MT, typename GT>
__global__ void fused_adam(WT* __restrict__ w, MT* __restrict__ m,
                           MT* __restrict__ v, const GT* __restrict__ g,
                           size_t n_elems, AdamScalars s, uint32_t seed) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elems; e += stride) {
    float w2, m2, v2;
    aread::adam_element(load_f(w, e), load_f(m, e), load_f(v, e), load_f(g, e),
                        s, &w2, &m2, &v2);
    store_w(w, static_cast<uint32_t>(e), w2, seed);
    store_rn(m, e, m2);
    store_rn(v, e, v2);
  }
}

template <typename WT, typename MT>
void launch_g(void* w, void* m, void* v, const void* g, int g_bf16,
              size_t n_elems, AdamScalars s, uint32_t seed, int n_blocks,
              cudaStream_t stream) {
  if (g_bf16) {
    fused_adam<WT, MT, __nv_bfloat16><<<n_blocks, 256, 0, stream>>>(
        static_cast<WT*>(w), static_cast<MT*>(m), static_cast<MT*>(v),
        static_cast<const __nv_bfloat16*>(g), n_elems, s, seed);
  } else {
    fused_adam<WT, MT, float><<<n_blocks, 256, 0, stream>>>(
        static_cast<WT*>(w), static_cast<MT*>(m), static_cast<MT*>(v),
        static_cast<const float*>(g), n_elems, s, seed);
  }
}

}  // namespace

// Plain C entry point, called by the PyTorch operator in fused_adam_op.cpp
// (the PyTorch headers stay out of this file, so nvcc compiles it in
// seconds). Pointers are device pointers; the caller has checked dtypes,
// shapes, contiguity and devices, and that n_elems < 2^32 (the hash's
// element index is uint32, as in the JAX package). Returns the cudaError_t
// of the launch (0 on success).
extern "C" int aread_fused_adam(
    void* w, int w_bf16, void* m, void* v, int mv_bf16, const void* g,
    int g_bf16, uint64_t n_elems, float lr, float b1, float b2, float eps,
    float decay, float b1c, float b2c, float omb1, float omb2, uint32_t seed,
    int n_blocks, void* stream_ptr) {
  if (n_elems == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const AdamScalars s{lr, b1, b2, eps, decay, b1c, b2c, omb1, omb2};
  const size_t n = static_cast<size_t>(n_elems);
  if (w_bf16 && mv_bf16) {
    launch_g<__nv_bfloat16, __nv_bfloat16>(w, m, v, g, g_bf16, n, s, seed,
                                           n_blocks, stream);
  } else if (w_bf16) {
    launch_g<__nv_bfloat16, float>(w, m, v, g, g_bf16, n, s, seed, n_blocks,
                                   stream);
  } else if (mv_bf16) {
    launch_g<float, __nv_bfloat16>(w, m, v, g, g_bf16, n, s, seed, n_blocks,
                                   stream);
  } else {
    launch_g<float, float>(w, m, v, g, g_bf16, n, s, seed, n_blocks, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* aread_fused_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
