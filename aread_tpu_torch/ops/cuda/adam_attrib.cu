// Kernel 1's sweep with parts taken out, to say where its time above a bare
// copy goes — the Hopper kernel that replaces the TPU kernel
// benchmarks/prof_kernel_attrib.py::variant_kernel (its pallas_call in
// run_variant), which runs copies of the sparse-Adam kernel's body with
// parts removed at the Amazon table in bf16.
//
// The sweep is adam_sweep_vec8 of sparse_adam.cu (a thread per 8
// consecutive elements of one row, 16-byte streaming loads and stores, the
// row of a vector by a shift, one slot load per vector, the map's reset in
// the sweep) for a bf16 table and bf16 moments, templated on a compile-time
// MODE. Each mode computes what its TPU variant computes, as a function:
//
//   full    kernel 1 itself: bitwise sparse_adam.cu on the same inputs, seed
//           and t (stochastically rounded weight write);
//   rtn     the weight written round-to-nearest instead (the TPU's
//           `w2.astype(bfloat16)`): the cost of the random bits;
//   dot1    the gradient row rounded to bf16 (to nearest) and widened
//           before the Adam math: the TPU's one-dot densify `onehot @ hi`
//           as a function. The TPU variant saves two of three one-hot
//           matmuls; this sweep has no matmul (it finds a row's gradient
//           through the slot map), so here dot1 costs one more rounding,
//           not less work — the cost it isolates differs;
//   noslot  the TPU's nodots: a zero data gradient, no slot-map load and no
//           gsum read, only decay * w enters Adam;
//   noadam  the slot map and gsum read as in full, w written back as
//           w + g * 0 (the TPU's `w + gfix.astype(w.dtype) * 0`: a -0.0
//           weight comes out +0.0 unless its gradient is negative or -0.0;
//           every other weight unchanged), m and v copied through;
//   copy    a bare read and write of w, m and v: the 6-pass floor.
//
// Launches per update: full, rtn, dot1 and noadam scatter the touched rows'
// slots (attrib_slot_scatter) and then sweep, restoring the map in the
// sweep, as kernel 1 does at D = 32 (two launches, so a mode's time per
// update covers what kernel 1's covers); noslot and copy read no map and
// are the sweep alone (one launch): the scatter's cost is part of what
// full - noslot and noadam - copy measure.
//
// Bound: HBM bytes, 12 B per element (w, m, v read and written once in
// bf16) plus the uids and gsum. Arithmetic and rounding are rounding.cuh's
// (IEEE single precision, no contraction), so full is bitwise kernel 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rounding.cuh"

namespace {

using aread::AdamScalars;
using aread::BLOCK;
using aread::VEC;

enum Mode : int { FULL = 0, RTN = 1, DOT1 = 2, NOSLOT = 3, NOADAM = 4, COPY = 5 };

__host__ __device__ constexpr bool reads_map(int mode) {
  return mode != NOSLOT && mode != COPY;
}

__global__ void attrib_slot_scatter(const int32_t* __restrict__ uids,
                                    int k_total, uint32_t n_rows,
                                    int32_t* __restrict__ slot) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < k_total) {
    int32_t u = uids[k];
    if (u >= 0 && static_cast<uint32_t>(u) < n_rows) slot[u] = k;
  }
}

// 16 bytes through unchanged (bf16 bits, no conversion)
__device__ __forceinline__ void copy16(__nv_bfloat16* p) {
  uint4* q = reinterpret_cast<uint4*>(p);
  __stcs(q, __ldcs(q));
}

// n_vec = n_rows * vpr vectors, D = 8 * vpr with vpr a power of two that
// divides 32 (row of vector vi: vi >> shift; a row's vectors are lanes of
// one warp in one step, so the lane of its first vector resets its slot)
template <int MODE>
__global__ void __launch_bounds__(BLOCK)
    attrib_sweep(__nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ m,
                 __nv_bfloat16* __restrict__ v, const float* __restrict__ gsum,
                 int32_t* slot, uint32_t n_vec, uint32_t d, uint32_t vpr,
                 uint32_t shift, AdamScalars s, uint32_t seed) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const uint32_t lane = threadIdx.x & 31u;
  for (size_t base = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     (threadIdx.x - lane);
       base < n_vec; base += stride) {
    const uint32_t vi = static_cast<uint32_t>(base) + lane;
    const bool live = vi < n_vec;
    const size_t e = static_cast<size_t>(vi) * VEC;
    if (MODE == COPY) {
      if (!live) continue;
      copy16(w + e);
      copy16(m + e);
      copy16(v + e);
      continue;
    }
    uint32_t r = 0, cv = 0;
    int32_t k = -1;
    if (reads_map(MODE)) {
      if (live) {
        r = vi >> shift;
        cv = vi - r * vpr;
        k = __ldcg(slot + r);  // not __ldg: this kernel writes the map
      }
      __syncwarp();
      if (cv == 0 && k >= 0) slot[r] = -1;
    }
    if (!live) continue;
    float wf[VEC], mf[VEC], vf[VEC], gf[VEC];
    aread::load8_cs(w + e, wf);
    if (MODE != NOADAM) {
      aread::load8_cs(m + e, mf);
      aread::load8_cs(v + e, vf);
    }
    if (reads_map(MODE) && k >= 0) {
      const float4* gp = reinterpret_cast<const float4*>(
          gsum + static_cast<size_t>(k) * d + cv * VEC);
      const float4 a = __ldg(gp), b = __ldg(gp + 1);
      gf[0] = a.x; gf[1] = a.y; gf[2] = a.z; gf[3] = a.w;
      gf[4] = b.x; gf[5] = b.y; gf[6] = b.z; gf[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) gf[j] = 0.0f;
    }
    if (MODE == NOADAM) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        wf[j] = __fadd_rn(wf[j], __fmul_rn(gf[j], 0.0f));
      aread::store8_rn(w + e, wf);  // exact: wf holds bf16 values
      copy16(m + e);
      copy16(v + e);
      continue;
    }
    if (MODE == DOT1) {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        gf[j] = __bfloat162float(__float2bfloat16_rn(gf[j]));
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      aread::adam_element(wf[j], mf[j], vf[j], gf[j], s, &wf[j], &mf[j],
                          &vf[j]);
    if (MODE == RTN)
      aread::store8_rn(w + e, wf);
    else
      aread::store8_w(w + e, static_cast<uint32_t>(e), wf, seed);
    aread::store8_rn(m + e, mf);
    aread::store8_rn(v + e, vf);
  }
}

struct Args {
  __nv_bfloat16 *w, *m, *v;
  const float* gsum;
  int32_t* slot;
  uint32_t n_rows, d, shift;
  AdamScalars s;
  uint32_t seed;
  cudaStream_t stream;
};

template <int MODE>
cudaError_t launch_sweep(const Args& a) {
  static int grid_cache[aread::MAX_DEVICES] = {};
  int grid = 0;
  cudaError_t err = aread::full_grid(
      reinterpret_cast<const void*>(&attrib_sweep<MODE>), grid_cache, &grid);
  if (err != cudaSuccess) return err;
  const uint32_t vpr = a.d / VEC;
  const uint32_t n_vec = a.n_rows * vpr;
  const size_t need = (static_cast<size_t>(n_vec) + BLOCK - 1) / BLOCK;
  if (need < static_cast<size_t>(grid)) grid = static_cast<int>(need);
  attrib_sweep<MODE><<<grid > 0 ? grid : 1, BLOCK, 0, a.stream>>>(
      a.w, a.m, a.v, a.gsum, a.slot, n_vec, a.d, vpr, a.shift, a.s, a.seed);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, called by the PyTorch operator in adam_attrib_op.cpp.
// Device pointers on the current device; the caller has checked that w, m
// and v are contiguous, 16-byte aligned bf16 [n_rows, d] with d in
// {8, 16, 32, 64, 128, 256} and n_rows * d < 2^32, uids int32 [k_total]
// (sentinel n_rows past the live entries), gsum f32 [k_total, d] 16-byte
// aligned, and that slot holds -1 everywhere (it does again on exit);
// shift = log2(d / 8). Returns the cudaError_t of the launches (0 on
// success), cudaErrorInvalidValue for an unknown mode.
extern "C" int aread_adam_attrib(
    int mode, void* w, void* m, void* v, const int32_t* uids, int k_total,
    const float* gsum, int32_t* slot, uint32_t n_rows, uint32_t d, float lr,
    float b1, float b2, float eps, float decay, float b1c, float b2c,
    float omb1, float omb2, uint32_t seed, uint32_t shift, void* stream_ptr) {
  if (mode < FULL || mode > COPY) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || d == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Args a{static_cast<__nv_bfloat16*>(w),
               static_cast<__nv_bfloat16*>(m),
               static_cast<__nv_bfloat16*>(v),
               gsum, slot, n_rows, d, shift,
               AdamScalars{lr, b1, b2, eps, decay, b1c, b2c, omb1, omb2},
               seed, stream};
  if (reads_map(mode) && k_total > 0) {
    attrib_slot_scatter<<<(k_total + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
        uids, k_total, n_rows, slot);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (mode) {
    case FULL: return static_cast<int>(launch_sweep<FULL>(a));
    case RTN: return static_cast<int>(launch_sweep<RTN>(a));
    case DOT1: return static_cast<int>(launch_sweep<DOT1>(a));
    case NOSLOT: return static_cast<int>(launch_sweep<NOSLOT>(a));
    case NOADAM: return static_cast<int>(launch_sweep<NOADAM>(a));
    default: return static_cast<int>(launch_sweep<COPY>(a));
  }
}

extern "C" const char* aread_adam_attrib_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
