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
// a stochastically rounded write keyed by murmur3-fmix32(index_base + e,
// seed), which the TPU entry point leaves to its plain version); m and v
// are f32 or bf16 (round to nearest); the gradient is f32 or bf16.
// index_base is the global element index of the leaf's first element: 0
// for a whole leaf, the shard's first element for a row shard of the table
// on a mesh, so that the shards together round as the whole table does (as
// the JAX package's reference_adam_update does under GSPMD, keyed on the
// global element index).
//
// The scalars that change from step to step — lr, b1c, b2c and the seed —
// are read from the device, as sparse_adam.cu reads them: `step` holds
// their 32 bits (the f32 bits of the three, then the seed), written by the
// host before the launch (ops/sparse_adam.py::step_scalars). A CUDA graph
// that captured the launch then replays every step with its own values
// (train/step_graph.py stages a chunk's blocks at once). Every thread reads
// the four words once, before its loop. The step-independent scalars and
// index_base (constant per leaf) stay arguments.
//
// Bound: HBM bytes. Each element reads w, m, v, g and writes w, m, v once:
// 28 B all-f32, 20 B with bf16 moments; a dozen flops per element are far
// below the card's rate at that traffic. What the design does about it:
// fused_adam_vec8 gives a thread 8 consecutive elements per grid-stride
// step, moved as 16-byte streaming loads and stores (one uint4 of bf16,
// two float4 of f32), so a warp moves 512 B an instruction and each thread
// has eight independent division / square-root chains in flight; the last
// n_elems % 8 elements are done one thread each in the same kernel. It
// needs the four pointers 16-byte aligned. fused_adam_scalar, a thread per
// element with 4- or 2-byte accesses, is the general kernel for leaves that
// are not (a view at an odd offset); the wrapper picks. Both fill the card
// once (occupancy x SMs blocks of 256) and stride. The TPU kernel's
// (1024, 128) blocks, its 128-lane flat view with a padded tail and its
// input/output aliasing have no counterpart — any element count below
// 2^32 is taken as it is.
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
using aread::BLOCK;
using aread::VEC;
using aread::with_step;

template <typename WT, typename MT, typename GT>
__device__ __forceinline__ void update_one(WT* w, MT* m, MT* v, const GT* g,
                                           size_t e, const AdamScalars& s,
                                           uint32_t seed, uint32_t base) {
  float w2, m2, v2;
  aread::adam_element(aread::load_f(w, e), aread::load_f(m, e),
                      aread::load_f(v, e), aread::load_f(g, e), s, &w2, &m2,
                      &v2);
  aread::store_w(w, e, static_cast<uint32_t>(e) + base, w2, seed);
  aread::store_rn(m, e, m2);
  aread::store_rn(v, e, v2);
}

// a thread per element; any alignment
template <typename WT, typename MT, typename GT>
__global__ void __launch_bounds__(BLOCK)
    fused_adam_scalar(WT* __restrict__ w, MT* __restrict__ m,
                      MT* __restrict__ v, const GT* __restrict__ g,
                      size_t n_elems, AdamScalars consts,
                      const uint32_t* __restrict__ step, uint32_t base) {
  const AdamScalars s = with_step(consts, step);
  const uint32_t seed = __ldg(step + 3);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_elems; e += stride)
    update_one(w, m, v, g, e, s, seed, base);
}

// a thread per 8 consecutive elements; w, m, v, g 16-byte aligned
template <typename WT, typename MT, typename GT>
__global__ void __launch_bounds__(BLOCK)
    fused_adam_vec8(WT* __restrict__ w, MT* __restrict__ m,
                    MT* __restrict__ v, const GT* __restrict__ g,
                    size_t n_elems, AdamScalars consts,
                    const uint32_t* __restrict__ step, uint32_t base) {
  const AdamScalars s = with_step(consts, step);
  const uint32_t seed = __ldg(step + 3);
  const size_t n_vec = n_elems / VEC;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < n_vec; i += stride) {
    const size_t e = i * VEC;
    float wf[VEC], mf[VEC], vf[VEC], gf[VEC];
    aread::load8_cs(w + e, wf);
    aread::load8_cs(m + e, mf);
    aread::load8_cs(v + e, vf);
    aread::load8_cs(g + e, gf);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      aread::adam_element(wf[j], mf[j], vf[j], gf[j], s, &wf[j], &mf[j],
                          &vf[j]);
    aread::store8_w(w + e, static_cast<uint32_t>(e) + base, wf, seed);
    aread::store8_rn(m + e, mf);
    aread::store8_rn(v + e, vf);
  }
  // the last n_elems % 8 elements
  for (size_t e = n_vec * VEC + tid; e < n_elems; e += stride)
    update_one(w, m, v, g, e, s, seed, base);
}

template <typename WT, typename MT, typename GT>
cudaError_t launch(void* w, void* m, void* v, const void* g, size_t n_elems,
                   AdamScalars s, const uint32_t* step, uint32_t base,
                   int vec, cudaStream_t stream) {
  static int vec_grid[aread::MAX_DEVICES] = {};
  static int scalar_grid[aread::MAX_DEVICES] = {};
  auto* kernel = vec ? &fused_adam_vec8<WT, MT, GT>
                     : &fused_adam_scalar<WT, MT, GT>;
  int grid = 0;
  cudaError_t err = aread::full_grid(reinterpret_cast<const void*>(kernel),
                                     vec ? vec_grid : scalar_grid, &grid);
  if (err != cudaSuccess) return err;
  const size_t work = vec ? (n_elems / VEC > 0 ? n_elems / VEC : 1) : n_elems;
  const size_t need = (work + BLOCK - 1) / BLOCK;
  if (need < static_cast<size_t>(grid)) grid = static_cast<int>(need);
  kernel<<<grid, BLOCK, 0, stream>>>(static_cast<WT*>(w), static_cast<MT*>(m),
                                     static_cast<MT*>(v),
                                     static_cast<const GT*>(g), n_elems, s,
                                     step, base);
  return cudaGetLastError();
}

template <typename WT, typename MT>
cudaError_t launch_g(void* w, void* m, void* v, const void* g, int g_bf16,
                     size_t n_elems, AdamScalars s, const uint32_t* step,
                     uint32_t base, int vec, cudaStream_t stream) {
  return g_bf16 ? launch<WT, MT, __nv_bfloat16>(w, m, v, g, n_elems, s, step,
                                                base, vec, stream)
                : launch<WT, MT, float>(w, m, v, g, n_elems, s, step, base,
                                        vec, stream);
}

}  // namespace

// Plain C entry point, called by the PyTorch operator in fused_adam_op.cpp
// (the PyTorch headers stay out of this file, so nvcc compiles it in
// seconds). Pointers are device pointers; the caller has checked dtypes,
// shapes, contiguity and devices, that index_base + n_elems < 2^32 (the
// hash's element index is uint32, as in the JAX package), and with vec != 0
// that w, m, v and g are 16-byte aligned. The device of the tensors is current.
// step is the step's scalar block on the device: 4 words, the f32 bits of
// lr, b1c and b2c, then the seed. Returns the cudaError_t of the launch (0
// on success).
extern "C" int aread_fused_adam(
    void* w, int w_bf16, void* m, void* v, int mv_bf16, const void* g,
    int g_bf16, uint64_t n_elems, const uint32_t* step, float b1, float b2,
    float eps, float decay, float omb1, float omb2, uint32_t index_base,
    int vec, void* stream_ptr) {
  if (n_elems == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // lr, b1c and b2c are read from `step` in the kernel
  const AdamScalars s{0.0f, b1, b2, eps, decay, 0.0f, 0.0f, omb1, omb2};
  const size_t n = static_cast<size_t>(n_elems);
  cudaError_t err;
  if (w_bf16 && mv_bf16) {
    err = launch_g<__nv_bfloat16, __nv_bfloat16>(w, m, v, g, g_bf16, n, s,
                                                 step, index_base, vec, stream);
  } else if (w_bf16) {
    err = launch_g<__nv_bfloat16, float>(w, m, v, g, g_bf16, n, s, step,
                                         index_base, vec, stream);
  } else if (mv_bf16) {
    err = launch_g<float, __nv_bfloat16>(w, m, v, g, g_bf16, n, s, step,
                                         index_base, vec, stream);
  } else {
    err = launch_g<float, float>(w, m, v, g, g_bf16, n, s, step, index_base,
                                 vec, stream);
  }
  return static_cast<int>(err);
}

extern "C" const char* aread_fused_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
