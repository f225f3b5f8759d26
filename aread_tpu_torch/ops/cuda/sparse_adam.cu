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
// The scalars that change from step to step — lr, b1c, b2c and the seed —
// are read from the device: `step` holds their 32 bits (the f32 bits of the
// three, then the seed), written by the host before the launch
// (ops/sparse_adam.py::step_scalars). A CUDA graph that captured the launch
// then replays every step with its own values (train/step_graph.py stages a
// chunk's blocks at once); the step-independent scalars stay arguments.
// Every thread reads the four words once, before its loop.
//
// Bound: HBM bytes. The sweep reads and writes w, m and v once each (12 B
// per element with bf16 storage, 24 B with f32); everything else (the
// [K, D] row gradients and the slot map) is a few MB. There is no block
// window, so unlike the TPU kernel it cannot overflow and needs no
// fallback: the touched rows are found through a slot map instead of a
// per-block one-hot matmul.
//
// What the design does about the bound: two launches per update.
//
//   1. slot_scatter:  slot[uids[k]] = k for every live (non-sentinel) k. It
//      stays a launch of its own: it must have finished before any block of
//      the sweep reads the map.
//   2. adam_sweep_vec8 (D % 8 == 0, pointers 16-byte aligned): a thread owns
//      8 consecutive elements of one row, moved as 16-byte streaming loads
//      and stores; vector index -> (row, column) by a shift when D / 8 is a
//      power of two, else by a multiply-high with a multiplier computed on
//      the host (ops/sparse_adam.py::row_divider) — no division in the
//      kernel; one slot load per vector, the gradient row as two float4.
//      In the same kernel:
//      * the map's reset. When D / 8 divides 32, a row's vectors sit in
//        one warp in one step of its loop (a warp walks 32 consecutive
//        vectors from a multiple of 32): every lane reads slot[row],
//        __syncwarp(), the lane of the row's first vector writes -1. This
//        was chosen over a generation stamp in the map because it adds no
//        bytes (a stamp doubles the map's traffic), has no wrap-around to
//        handle, and keeps the invariant the wrapper already promises: the
//        map is all -1 between launches. For other D the slot_reset launch
//        follows the sweep (three launches).
//      * sum(w * w). Each block writes its f64 partial, __threadfence(),
//        then counts itself done with an atomicAdd on an integer; the block
//        that counts last sums the partials in index order, writes the sum
//        as f32 and sets the counter back to 0. The order of that sum does
//        not depend on which block is last, so repeated launches agree
//        bitwise; no float atomics.
//   adam_sweep_scalar, a thread per element with a division by D per
//   element, is the general sweep for any other D or alignment, followed
//   by slot_reset; it folds sum(w * w) the same way.
// Both sweeps fill the card once (occupancy x SMs blocks of 256) and stride.
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
using aread::BLOCK;
using aread::VEC;
using aread::with_step;

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

// fixed-order tree sum of one value per thread; the result is in red[0]
// (blockDim.x is BLOCK)
__device__ __forceinline__ void block_sum(double* red, double x) {
  red[threadIdx.x] = x;
  __syncthreads();
  for (unsigned h = BLOCK / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
}

// The block's partial of sum(w * w) goes to partials[blockIdx.x]; the block
// that finishes last adds all partials in index order into out[0] (f32) and
// zeroes the counter for the next launch.
__device__ void finish_l2(double acc, double* partials, float* out,
                          unsigned int* count) {
  __shared__ double red[BLOCK];
  __shared__ bool last;
  block_sum(red, acc);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = red[0];
    __threadfence();
    last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double a = 0.0;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += BLOCK)
    a += __ldcg(partials + i);
  block_sum(red, a);
  if (threadIdx.x == 0) {
    out[0] = __double2float_rn(red[0]);
    *count = 0;
  }
}

// a thread per element; any D, any alignment
template <typename WT, typename MT, bool WANT_L2>
__global__ void __launch_bounds__(BLOCK)
    adam_sweep_scalar(WT* __restrict__ w, MT* __restrict__ m,
                      MT* __restrict__ v, const float* __restrict__ gsum,
                      const int32_t* __restrict__ slot, size_t n_elems,
                      uint32_t d, AdamScalars consts,
                      const uint32_t* __restrict__ step,
                      double* l2_partials, float* l2_out,
                      unsigned int* l2_count) {
  const AdamScalars s = with_step(consts, step);
  const uint32_t seed = __ldg(step + 3);
  double acc = 0.0;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_elems; i += stride) {
    const uint32_t e = static_cast<uint32_t>(i);
    const uint32_t r = e / d;
    const uint32_t c = e - r * d;
    const int32_t k = slot[r];
    const float gd = k >= 0 ? gsum[static_cast<size_t>(k) * d + c] : 0.0f;
    const float wf = aread::load_f(w, e);
    if (WANT_L2) acc += static_cast<double>(__fmul_rn(wf, wf));
    float w2, m2, v2;
    aread::adam_element(wf, aread::load_f(m, e), aread::load_f(v, e), gd, s,
                        &w2, &m2, &v2);
    aread::store_w(w, e, w2, seed);
    aread::store_rn(m, e, m2);
    aread::store_rn(v, e, v2);
  }
  if (WANT_L2) finish_l2(acc, l2_partials, l2_out, l2_count);
}

// A thread per 8 consecutive elements of one row: D = 8 * vpr, w, m, v and
// gsum 16-byte aligned, n_vec = n_rows * vpr vectors. A warp walks 32
// consecutive vectors from a multiple of 32 per step, every lane the same
// number of steps. Row of vector vi: vi >> shift if mul == 0, else
// __umulhi(vi, mul) >> shift. With reset_map (the launcher sets it only
// when vpr divides 32, so that a row's vectors are lanes of one warp in one
// step) the touched rows' slots go back to -1 here.
template <typename WT, typename MT, bool WANT_L2>
__global__ void __launch_bounds__(BLOCK)
    adam_sweep_vec8(WT* __restrict__ w, MT* __restrict__ m,
                    MT* __restrict__ v, const float* __restrict__ gsum,
                    int32_t* slot, uint32_t n_vec, uint32_t d, uint32_t vpr,
                    uint32_t shift, uint32_t mul, int reset_map,
                    AdamScalars consts, const uint32_t* __restrict__ step,
                    double* l2_partials, float* l2_out,
                    unsigned int* l2_count) {
  const AdamScalars s = with_step(consts, step);
  const uint32_t seed = __ldg(step + 3);
  double acc = 0.0;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const uint32_t lane = threadIdx.x & 31u;
  for (size_t base = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     (threadIdx.x - lane);
       base < n_vec; base += stride) {
    const uint32_t vi = static_cast<uint32_t>(base) + lane;
    const bool live = vi < n_vec;
    uint32_t r = 0, cv = 0;
    int32_t k = -1;
    if (live) {
      r = mul != 0 ? __umulhi(vi, mul) >> shift : vi >> shift;
      cv = vi - r * vpr;
      // not __ldg: with reset_map this kernel writes the map
      k = __ldcg(slot + r);
    }
    if (reset_map) {
      __syncwarp();
      if (cv == 0 && k >= 0) slot[r] = -1;
    }
    if (!live) continue;
    const size_t e = static_cast<size_t>(vi) * VEC;
    float wf[VEC], mf[VEC], vf[VEC], gf[VEC];
    aread::load8_cs(w + e, wf);
    aread::load8_cs(m + e, mf);
    aread::load8_cs(v + e, vf);
    if (k >= 0) {
      const float4* gp = reinterpret_cast<const float4*>(
          gsum + static_cast<size_t>(k) * d + cv * VEC);
      const float4 a = __ldg(gp), b = __ldg(gp + 1);
      gf[0] = a.x; gf[1] = a.y; gf[2] = a.z; gf[3] = a.w;
      gf[4] = b.x; gf[5] = b.y; gf[6] = b.z; gf[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) gf[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (WANT_L2) acc += static_cast<double>(__fmul_rn(wf[j], wf[j]));
      aread::adam_element(wf[j], mf[j], vf[j], gf[j], s, &wf[j], &mf[j],
                          &vf[j]);
    }
    aread::store8_w(w + e, static_cast<uint32_t>(e), wf, seed);
    aread::store8_rn(m + e, mf);
    aread::store8_rn(v + e, vf);
  }
  if (WANT_L2) finish_l2(acc, l2_partials, l2_out, l2_count);
}

struct Sweep {
  void *w, *m, *v;
  const float* gsum;
  int32_t* slot;
  uint32_t n_rows, d, vpr, shift, mul;
  AdamScalars s;  // lr, b1c and b2c are read from `step` in the kernel
  const uint32_t* step;
  double* l2_partials;
  int l2_capacity;
  float* l2_out;
  unsigned int* l2_count;
  cudaStream_t stream;
};

// blocks for `work` threads' worth of work: the card filled once, no more
// blocks than the work needs or than there are sum(w * w) partials
inline int clamp_grid(int grid, size_t work, const Sweep& a) {
  const size_t need = (work + BLOCK - 1) / BLOCK;
  if (need < static_cast<size_t>(grid)) grid = static_cast<int>(need);
  if (a.l2_partials != nullptr && grid > a.l2_capacity) grid = a.l2_capacity;
  return grid > 0 ? grid : 1;
}

template <typename WT, typename MT, bool WANT_L2>
cudaError_t launch_sweep_l2(const Sweep& a) {
  static int vec_grid[aread::MAX_DEVICES] = {};
  static int scalar_grid[aread::MAX_DEVICES] = {};
  WT* w = static_cast<WT*>(a.w);
  MT* m = static_cast<MT*>(a.m);
  MT* v = static_cast<MT*>(a.v);
  int grid = 0;
  if (a.vpr > 0) {
    cudaError_t err = aread::full_grid(
        reinterpret_cast<const void*>(&adam_sweep_vec8<WT, MT, WANT_L2>),
        vec_grid, &grid);
    if (err != cudaSuccess) return err;
    const uint32_t n_vec = a.n_rows * a.vpr;
    adam_sweep_vec8<WT, MT, WANT_L2>
        <<<clamp_grid(grid, n_vec, a), BLOCK, 0, a.stream>>>(
            w, m, v, a.gsum, a.slot, n_vec, a.d, a.vpr, a.shift, a.mul,
            32 % a.vpr == 0, a.s, a.step, a.l2_partials, a.l2_out,
            a.l2_count);
  } else {
    cudaError_t err = aread::full_grid(
        reinterpret_cast<const void*>(&adam_sweep_scalar<WT, MT, WANT_L2>),
        scalar_grid, &grid);
    if (err != cudaSuccess) return err;
    const size_t n_elems = static_cast<size_t>(a.n_rows) * a.d;
    adam_sweep_scalar<WT, MT, WANT_L2>
        <<<clamp_grid(grid, n_elems, a), BLOCK, 0, a.stream>>>(
            w, m, v, a.gsum, a.slot, n_elems, a.d, a.s, a.step,
            a.l2_partials, a.l2_out, a.l2_count);
  }
  return cudaGetLastError();
}

template <typename WT, typename MT>
cudaError_t launch_sweep(const Sweep& a) {
  return a.l2_partials != nullptr ? launch_sweep_l2<WT, MT, true>(a)
                                  : launch_sweep_l2<WT, MT, false>(a);
}

}  // namespace

// Plain C entry point, called by the PyTorch operator in sparse_adam_op.cpp
// (the PyTorch headers stay out of this file, so nvcc compiles it in
// seconds). Pointers are device pointers and their device is current; the
// caller has checked dtypes, shapes, contiguity and devices, and that
// n_rows * d < 2^32 (the hash and the flat index are uint32, as in the JAX
// package). vpr == 0 asks for the scalar sweep; vpr > 0 for the vector
// sweep: then d == 8 * vpr, w, m, v and gsum are 16-byte aligned and
// (shift, mul) divide a vector index by vpr as adam_sweep_vec8 says. slot
// must hold -1 everywhere on entry and does again on exit. step is the
// step's scalar block on the device: 4 words, the f32 bits of lr, b1c and
// b2c, then the seed; it must not change until the launch has run.
// l2_partials /
// l2_out / l2_count are null unless the pre-update sum(w*w) is wanted:
// l2_partials then holds l2_capacity doubles, l2_out one float, and
// l2_count one unsigned int that is 0 on entry and again on exit. Returns
// the cudaError_t of the launches (0 on success).
extern "C" int aread_sparse_adam(
    void* w, int w_bf16, void* m, void* v, int mv_bf16, const int32_t* uids,
    int k_total, const float* gsum, int32_t* slot, uint32_t n_rows, uint32_t d,
    const uint32_t* step, float b1, float b2, float eps, float decay,
    float omb1, float omb2, uint32_t vpr, uint32_t shift, uint32_t mul,
    double* l2_partials, int l2_capacity, float* l2_out,
    unsigned int* l2_count, void* stream_ptr) {
  if (n_rows == 0 || d == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Sweep a{w, m, v, gsum, slot, n_rows, d, vpr, shift, mul,
                AdamScalars{0.0f, b1, b2, eps, decay, 0.0f, 0.0f, omb1, omb2},
                step, l2_partials, l2_capacity, l2_out, l2_count, stream};
  const int kb = (k_total + BLOCK - 1) / BLOCK;
  if (k_total > 0) slot_scatter<<<kb, BLOCK, 0, stream>>>(uids, k_total, n_rows, slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (w_bf16 && mv_bf16) {
    err = launch_sweep<__nv_bfloat16, __nv_bfloat16>(a);
  } else if (w_bf16) {
    err = launch_sweep<__nv_bfloat16, float>(a);
  } else if (mv_bf16) {
    err = launch_sweep<float, __nv_bfloat16>(a);
  } else {
    err = launch_sweep<float, float>(a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool reset_in_sweep = vpr > 0 && 32 % vpr == 0;
  if (k_total > 0 && !reset_in_sweep) {
    slot_reset<<<kb, BLOCK, 0, stream>>>(uids, k_total, n_rows, slot);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

extern "C" const char* aread_sparse_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
