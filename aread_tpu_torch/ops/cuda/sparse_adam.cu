// Dense-semantics Adam over the whole embedding table from a sparse,
// deduplicated data gradient — the Hopper kernel that replaces the TPU
// kernel aread_tpu/ops/pallas/sparse_adam_kernel.py::_kernel (entry
// sparse_adam_kernel_premeta, metadata pack_meta).
//
// What it computes, for every element e = r * D + c of the table:
//   g  = gd + decay * w          gd = gsum[slot[r], c] if row r was touched
//                                     this step, else 0
//   m' = b1 * m + omb1 * g
//   v' = b2 * v + omb2 * g * g
//   w' = w - lr * (m' / b1c) / (sqrt(v' / b2c) + eps)
// w, m and v are updated in place. A bf16 table is written with stochastic
// rounding keyed by murmur3-fmix32(e, seed); bf16 moments round to nearest.
// Optionally it also returns sum(w * w) of the pre-update table.
//
// Bound: HBM bytes. The sweep reads and writes w, m and v once each (12 B
// per element with bf16 storage, 24 B with f32); everything else (the
// [K, D] row gradients and the slot map) is a few MB. There is no block
// window, so unlike the TPU kernel it cannot overflow and needs no
// fallback: the touched rows are found through a slot map instead of a
// per-block one-hot matmul.
//
//   1. slot_scatter:  slot[uids[k]] = k for every live (non-sentinel) k;
//   2. adam_sweep:    one grid-stride pass over all n_rows * D elements,
//                     with per-block partial sums of w*w when asked;
//   3. slot_reset:    slot[uids[k]] = -1, so the map is all -1 again;
//   4. l2_reduce:     one block sums the partials in a fixed order, so
//                     repeated runs agree bitwise (no float atomics).
//
// Arithmetic is IEEE single precision in the plain version's operation
// order: the build passes --fmad=false (no contraction of a*b+c into an
// FMA) and keeps IEEE division and sqrt (no fast-math), so the result is
// bitwise equal to the plain PyTorch version on the same inputs. The
// element update, the stochastic rounding and the typed loads and stores
// are rounding.cuh's, shared with fused_adam.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rounding.cuh"

namespace {

using aread::AdamScalars;
using aread::load_f;
using aread::store_rn;
using aread::store_w;

__global__ void slot_scatter(const int32_t* __restrict__ uids, int k_total,
                             uint32_t n_rows, int32_t* __restrict__ slot) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < k_total) {
    int32_t u = uids[k];
    if (u >= 0 && static_cast<uint32_t>(u) < n_rows) slot[u] = k;
  }
}

__global__ void slot_reset(const int32_t* __restrict__ uids, int k_total,
                           uint32_t n_rows, int32_t* __restrict__ slot) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < k_total) {
    int32_t u = uids[k];
    if (u >= 0 && static_cast<uint32_t>(u) < n_rows) slot[u] = -1;
  }
}

template <typename WT, typename MT, bool WANT_L2>
__global__ void adam_sweep(WT* __restrict__ w, MT* __restrict__ m,
                           MT* __restrict__ v,
                           const float* __restrict__ gsum,
                           const int32_t* __restrict__ slot, uint32_t n_elems,
                           uint32_t d, AdamScalars s, uint32_t seed,
                           double* __restrict__ l2_partials) {
  double acc = 0.0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < n_elems;
       e += stride) {
    const uint32_t r = e / d;
    const uint32_t c = e - r * d;
    const int32_t k = slot[r];
    const float gd = k >= 0 ? gsum[static_cast<size_t>(k) * d + c] : 0.0f;
    const float wf = load_f(w, e);
    if (WANT_L2) acc += static_cast<double>(__fmul_rn(wf, wf));
    float w2, m2, v2;
    aread::adam_element(wf, load_f(m, e), load_f(v, e), gd, s, &w2, &m2, &v2);
    store_w(w, e, w2, seed);
    store_rn(m, e, m2);
    store_rn(v, e, v2);
  }
  if (WANT_L2) {
    // fixed-order tree reduction within the block (blockDim.x is 256)
    __shared__ double red[256];
    red[threadIdx.x] = acc;
    __syncthreads();
    for (unsigned h = blockDim.x / 2; h > 0; h >>= 1) {
      if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
      __syncthreads();
    }
    if (threadIdx.x == 0) l2_partials[blockIdx.x] = red[0];
  }
}

__global__ void l2_reduce(const double* __restrict__ partials, int n,
                          double* __restrict__ out) {
  __shared__ double red[256];
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (unsigned h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = red[0];
}

template <typename WT, typename MT>
void launch_sweep(void* w, void* m, void* v, const float* gsum,
                  const int32_t* slot, uint32_t n_elems, uint32_t d,
                  AdamScalars s, uint32_t seed, double* l2_partials,
                  int n_blocks, cudaStream_t stream) {
  if (l2_partials != nullptr) {
    adam_sweep<WT, MT, true><<<n_blocks, 256, 0, stream>>>(
        static_cast<WT*>(w), static_cast<MT*>(m), static_cast<MT*>(v), gsum,
        slot, n_elems, d, s, seed, l2_partials);
  } else {
    adam_sweep<WT, MT, false><<<n_blocks, 256, 0, stream>>>(
        static_cast<WT*>(w), static_cast<MT*>(m), static_cast<MT*>(v), gsum,
        slot, n_elems, d, s, seed, nullptr);
  }
}

}  // namespace

// Plain C entry point, called by the PyTorch operator in sparse_adam_op.cpp
// (the PyTorch headers stay out of this file, so nvcc compiles it in
// seconds). Pointers are device pointers; the caller has checked dtypes,
// shapes, contiguity and devices, and that n_rows * d < 2^32 (the hash and
// the flat index are uint32, as in the JAX package). slot must hold -1
// everywhere on entry and does again on exit. l2_partials / l2_out are null
// unless the pre-update sum(w*w) is wanted; l2_partials then holds n_blocks
// doubles. Returns the cudaError_t of the launches (0 on success).
extern "C" int aread_sparse_adam(
    void* w, int w_bf16, void* m, void* v, int mv_bf16, const int32_t* uids,
    int k_total, const float* gsum, int32_t* slot, uint32_t n_rows, uint32_t d,
    float lr, float b1, float b2, float eps, float decay, float b1c, float b2c,
    float omb1, float omb2, uint32_t seed, double* l2_partials,
    double* l2_out, int n_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const AdamScalars s{lr, b1, b2, eps, decay, b1c, b2c, omb1, omb2};
  const uint32_t n_elems = n_rows * d;
  const int kb = (k_total + 255) / 256;
  if (k_total > 0) slot_scatter<<<kb, 256, 0, stream>>>(uids, k_total, n_rows, slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (w_bf16 && mv_bf16) {
    launch_sweep<__nv_bfloat16, __nv_bfloat16>(w, m, v, gsum, slot, n_elems, d, s,
                                               seed, l2_partials, n_blocks, stream);
  } else if (w_bf16) {
    launch_sweep<__nv_bfloat16, float>(w, m, v, gsum, slot, n_elems, d, s, seed,
                                       l2_partials, n_blocks, stream);
  } else if (mv_bf16) {
    launch_sweep<float, __nv_bfloat16>(w, m, v, gsum, slot, n_elems, d, s, seed,
                                       l2_partials, n_blocks, stream);
  } else {
    launch_sweep<float, float>(w, m, v, gsum, slot, n_elems, d, s, seed,
                               l2_partials, n_blocks, stream);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k_total > 0) slot_reset<<<kb, 256, 0, stream>>>(uids, k_total, n_rows, slot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l2_partials != nullptr) {
    l2_reduce<<<1, 256, 0, stream>>>(l2_partials, n_blocks, l2_out);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

extern "C" const char* aread_sparse_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
