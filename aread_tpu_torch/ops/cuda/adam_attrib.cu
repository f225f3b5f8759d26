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
// Two sweeps (forms), each with the six modes, compared in one run by
// benchmarks/prof_kernel_attrib.py; they leave the same bits:
//
//   vec8   attrib_sweep: kernel 1's sweep as above, 16 bytes of each of w,
//          m and v a thread an iteration (the first form);
//   tma    attrib_sweep_tma: a bulk-copy pipeline, for more bytes in
//          flight a thread than vec8's 48 (the wrapper's default: it moves
//          copy faster). A load warp streams tiles of TILE contiguous
//          elements (whole rows for every D) of w, m and v into a ring of
//          TMA_STAGES shared-memory stages, each on a "full" mbarrier;
//          eight consumer warps read the tile's slots and gradient rows
//          while it is on its way, then compute in place in shared memory
//          and arrive on the stage's "computed" mbarrier; a store warp
//          writes the tile back with bulk stores
//          (cp.async.bulk.global.shared::cta) and frees the stage (its
//          "empty" mbarrier) once the stores have read it, so no consumer
//          waits for a store.
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

// ---- the tma sweep's parts ----

// k of vector vi's row in the slot map (-1: untouched) and the vector's
// column cv; the lane of the row's first vector resets the row's slot.
// Every lane of the warp calls it, live or not, for vectors of 32 aligned
// consecutive indices (a row's vectors then lie in one call).
__device__ __forceinline__ int32_t row_slot(int32_t* slot, uint32_t vi,
                                            bool live, uint32_t vpr,
                                            uint32_t shift, uint32_t* cv) {
  uint32_t r = 0;
  int32_t k = -1;
  *cv = 0;
  if (live) {
    r = vi >> shift;
    *cv = vi - r * vpr;
    k = __ldcg(slot + r);  // not __ldg: this kernel writes the map
  }
  __syncwarp();
  if (*cv == 0 && k >= 0) slot[r] = -1;
  return k;
}

// The data gradient of a vector: gsum's 8 floats at row k, column cv * 8,
// or zeros where k < 0 (an untouched row, or a mode that reads no map).
struct Grad8 {
  float4 a, b;
};

__device__ __forceinline__ Grad8 load_grad(const float* __restrict__ gsum,
                                           int32_t k, uint32_t d,
                                           uint32_t cv) {
  if (k < 0) return {make_float4(0.f, 0.f, 0.f, 0.f),
                     make_float4(0.f, 0.f, 0.f, 0.f)};
  const float4* p = reinterpret_cast<const float4*>(
      gsum + static_cast<size_t>(k) * d + cv * VEC);
  return {__ldg(p), __ldg(p + 1)};
}

// One vector of mode MODE (not COPY) on its 16-byte words of w, m and v,
// updated in place: attrib_sweep's arithmetic. g is its data gradient;
// e the element index of its first element.
template <int MODE>
__device__ __forceinline__ void update8(uint4& wq, uint4& mq, uint4& vq,
                                        const Grad8& g, uint32_t e,
                                        const AdamScalars& s, uint32_t seed) {
  float wf[VEC], mf[VEC], vf[VEC];
  float gf[VEC] = {g.a.x, g.a.y, g.a.z, g.a.w, g.b.x, g.b.y, g.b.z, g.b.w};
  aread::unpack8(wq, wf);
  if (MODE == NOADAM) {  // m and v pass through as they are
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      wf[j] = __fadd_rn(wf[j], __fmul_rn(gf[j], 0.0f));
    wq = aread::pack8_rn(wf);  // exact: wf holds bf16 values
    return;
  }
  aread::unpack8(mq, mf);
  aread::unpack8(vq, vf);
  if (MODE == DOT1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      gf[j] = __bfloat162float(__float2bfloat16_rn(gf[j]));
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    aread::adam_element(wf[j], mf[j], vf[j], gf[j], s, &wf[j], &mf[j], &vf[j]);
  wq = MODE == RTN ? aread::pack8_rn(wf) : aread::pack8_w(e, wf, seed);
  mq = aread::pack8_rn(mf);
  vq = aread::pack8_rn(vf);
}

// ---- tma: a bulk-copy pipeline through shared memory ----
// 2,048-element tiles in 4 stages: 48 KB a CTA, four CTAs (32 computing
// warps) a SM. 4,096 x 4 (two CTAs a SM) moved copy 0.5% faster and full
// 12% slower; 2,048 x 6 and 4,096 x 3 lost in both (PERF.md section 6).
constexpr int TILE = 2048;  // elements of each of w, m, v a stage holds
constexpr int TMA_STAGES = 4;
constexpr int CONSUMERS = 256;  // eight computing warps; warp 8 loads,
constexpr int TMA_THREADS = CONSUMERS + 64;  // warp 9 stores
constexpr int TMA_SMEM = TMA_STAGES * 3 * TILE * 2;  // bytes of bf16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "BAR_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra BAR_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the generic proxy's shared-memory writes before the copy engine's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// elements of tile t (the last one may be short; a multiple of 8)
__device__ __forceinline__ uint32_t tile_elems(uint32_t t, uint32_t n_elem) {
  const uint32_t left = n_elem - t * static_cast<uint32_t>(TILE);
  return left < static_cast<uint32_t>(TILE) ? left : static_cast<uint32_t>(TILE);
}

template <int MODE>
__global__ void __launch_bounds__(TMA_THREADS)
    attrib_sweep_tma(__nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ m,
                     __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ gsum, int32_t* slot,
                     uint32_t n_elem, uint32_t d, uint32_t vpr,
                     uint32_t shift, AdamScalars s, uint32_t seed) {
  constexpr uint32_t TV = TILE / VEC;  // 16-byte words of an array a tile
  extern __shared__ __align__(128) uint4 tiles[];  // [stage][w, m, v][TV]
  __shared__ __align__(8) uint64_t full[TMA_STAGES];      // tile landed
  __shared__ __align__(8) uint64_t computed[TMA_STAGES];  // tile updated
  __shared__ __align__(8) uint64_t empty[TMA_STAGES];     // tile stored
  const int tid = threadIdx.x;
  const uint32_t n_tiles = (n_elem + TILE - 1) / TILE;
  if (tid < TMA_STAGES) {
    bar_init(&full[tid], 1);
    bar_init(&computed[tid], CONSUMERS);
    bar_init(&empty[tid], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_shared();
  __syncthreads();
  __nv_bfloat16* arrays[3] = {w, m, v};
  if (tid >= CONSUMERS + 32) {  // the store warp; its lane 0 stores
    if (tid == CONSUMERS + 32) {
      uint32_t i = 0;
      for (uint32_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
        const int st = i % TMA_STAGES;
        bar_wait(&computed[st], (i / TMA_STAGES) & 1u);
        const size_t e0 = static_cast<size_t>(t) * TILE;
        const uint32_t bytes = tile_elems(t, n_elem) * 2;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          asm volatile(
              "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                  reinterpret_cast<uint64_t>(arrays[a] + e0)),
              "r"(smem_addr(tiles + (st * 3 + a) * TV)), "r"(bytes)
              : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (i > 0) {  // the previous tile's stores have read its stage
          asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          bar_arrive(&empty[(i - 1) % TMA_STAGES]);
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    return;
  }
  if (tid >= CONSUMERS) {  // the load warp; its lane 0 loads
    if (tid == CONSUMERS) {
      uint32_t i = 0;
      for (uint32_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
        const int st = i % TMA_STAGES;
        if (i >= TMA_STAGES) bar_wait(&empty[st], (i / TMA_STAGES - 1) & 1u);
        const uint32_t bytes = tile_elems(t, n_elem) * 2;
        const size_t e0 = static_cast<size_t>(t) * TILE;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_addr(&full[st])),
            "r"(3 * bytes)
            : "memory");
#pragma unroll
        for (int a = 0; a < 3; ++a)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];\n" ::"r"(
                  smem_addr(tiles + (st * 3 + a) * TV)),
              "l"(reinterpret_cast<uint64_t>(arrays[a] + e0)), "r"(bytes),
              "r"(smem_addr(&full[st]))
              : "memory");
      }
    }
    return;
  }
  constexpr int PER = TV / CONSUMERS;  // words of an array a thread a tile
  uint32_t i = 0;
  for (uint32_t t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
    const int st = i % TMA_STAGES;
    const size_t e0 = static_cast<size_t>(t) * TILE;
    const uint32_t nv = tile_elems(t, n_elem) / VEC;
    uint4* sw = tiles + st * 3 * TV;
    if (MODE != COPY) {
      // the slot map and the gradient rows first, while the tile is still
      // on its way: word j = tid + u * CONSUMERS of each array; a warp's
      // 32 words are 32 aligned consecutive vectors, so a row's vectors
      // lie in one step for D <= 256
      Grad8 g[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const uint32_t j = tid + u * CONSUMERS;
        uint32_t cv = 0;
        const int32_t k = reads_map(MODE)
                              ? row_slot(slot, static_cast<uint32_t>(e0 / VEC) + j,
                                         j < nv, vpr, shift, &cv)
                              : -1;
        g[u] = load_grad(gsum, k, d, cv);
      }
      bar_wait(&full[st], (i / TMA_STAGES) & 1u);
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const uint32_t j = tid + u * CONSUMERS;
        if (j < nv)
          update8<MODE>(sw[j], sw[TV + j], sw[2 * TV + j], g[u],
                        (static_cast<uint32_t>(e0 / VEC) + j) * VEC, s, seed);
      }
      fence_async_shared();  // this thread's writes, before the stores
    } else {
      bar_wait(&full[st], (i / TMA_STAGES) & 1u);
    }
    bar_arrive(&computed[st]);
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

enum Form : int { VEC8 = 0, TMA = 1 };

template <int MODE>
cudaError_t launch_sweep(int form, const Args& a) {
  const uint32_t vpr = a.d / VEC;
  const uint32_t n_vec = a.n_rows * vpr;
  if (form == TMA) {
    // stages above 48 KB only by opt-in; the grid fills the card with as
    // many CTAs as a SM holds
    static int grid_cache[aread::MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool cached = dev >= 0 && dev < aread::MAX_DEVICES;
    int grid = cached ? grid_cache[dev] : 0;
    if (grid == 0) {
      err = cudaFuncSetAttribute(attrib_sweep_tma<MODE>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 TMA_SMEM);
      if (err != cudaSuccess) return err;
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, attrib_sweep_tma<MODE>, TMA_THREADS, TMA_SMEM);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      grid = per_sm * sms > 0 ? per_sm * sms : 1;
      if (cached) grid_cache[dev] = grid;
    }
    const uint32_t n_elem = a.n_rows * a.d;
    const int tiles = static_cast<int>((n_elem + TILE - 1) / TILE);
    attrib_sweep_tma<MODE><<<tiles < grid ? tiles : grid, TMA_THREADS,
                             TMA_SMEM, a.stream>>>(
        a.w, a.m, a.v, a.gsum, a.slot, n_elem, a.d, vpr, a.shift, a.s, a.seed);
    return cudaGetLastError();
  }
  static int grid_cache[aread::MAX_DEVICES] = {};
  int grid = 0;
  cudaError_t err = aread::full_grid(
      reinterpret_cast<const void*>(&attrib_sweep<MODE>), grid_cache, &grid);
  if (err != cudaSuccess) return err;
  const size_t need = (static_cast<size_t>(n_vec) + BLOCK - 1) / BLOCK;
  if (need < static_cast<size_t>(grid)) grid = static_cast<int>(need);
  if (grid < 1) grid = 1;
  attrib_sweep<MODE><<<grid, BLOCK, 0, a.stream>>>(
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
// shift = log2(d / 8); form 0 vec8, 1 tma. Returns the
// cudaError_t of the launches (0 on success), cudaErrorInvalidValue for an
// unknown mode or form.
extern "C" int aread_adam_attrib(
    int mode, int form, void* w, void* m, void* v, const int32_t* uids,
    int k_total,
    const float* gsum, int32_t* slot, uint32_t n_rows, uint32_t d, float lr,
    float b1, float b2, float eps, float decay, float b1c, float b2c,
    float omb1, float omb2, uint32_t seed, uint32_t shift, void* stream_ptr) {
  if (mode < FULL || mode > COPY || form < VEC8 || form > TMA)
    return static_cast<int>(cudaErrorInvalidValue);
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
    case FULL: return static_cast<int>(launch_sweep<FULL>(form, a));
    case RTN: return static_cast<int>(launch_sweep<RTN>(form, a));
    case DOT1: return static_cast<int>(launch_sweep<DOT1>(form, a));
    case NOSLOT: return static_cast<int>(launch_sweep<NOSLOT>(form, a));
    case NOADAM: return static_cast<int>(launch_sweep<NOADAM>(form, a));
    default: return static_cast<int>(launch_sweep<COPY>(form, a));
  }
}

extern "C" const char* aread_adam_attrib_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
