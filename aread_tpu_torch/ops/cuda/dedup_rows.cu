// Duplicate ids' row gradients summed in sorted order: the Hopper kernel of
// ops/sparse_adam.py::dedup_rows for CUDA tensors, run before every table
// update (kernel 1 reads its output). It replaces no TPU kernel: the JAX
// package leaves this step to XLA (aread_tpu/ops/sparse_adam.py::dedup_rows:
// argsort, gather, cumsum, segment_sum, scatter), and the port's plain
// version (dedup_rows_reference) runs the same chain as PyTorch operators,
// whose segment_reduce adds each (run, column) in one thread, every add
// after a load from device memory.
//
// In: sid, the ids sorted stably (PyTorch's sort, the one step left to
// PyTorch), the sort's permutation `order`, and the row gradients grads
// [K, D] in their original order, read through `order` (no sorted copy).
// Out, in the plain version's static shapes: uids [K], the sorted-unique
// ids then the sentinel n_rows; gsum [K, D], each run's sum then zero rows.
// Every (run, column) is summed from 0.0f by adding the run's rows in
// sorted order, one IEEE add at a time (--fmad=false): segment_reduce's
// order and the JAX package's segment_sum order, so the result is bitwise
// the plain version's. No atomics, no tree sum.
//
// Bound: the serial adds of the longest run, not bytes. The gradient rows
// are read once and gsum written once (~4.7 MB with the ids at an Amazon
// batch, ~1.4 us at 3.35 TB/s), but a column of a run of L rows is L
// dependent adds (~5.7 cycles each measured on the H100, ~4 by the book),
// and the benchmark's history padding makes one run of ~5,100 of the 17,408
// rows. A long run's rows are also fetched by one SM: ~8 cycles a scattered
// 128-byte row measured there.
//
// Design, two launches:
//   1. dedup_runs, one block: each warp takes stripes of 32 neighbouring
//      sorted ids (coalesced loads, all in flight), a ballot a stripe marks
//      its run starts, a scan of the warps' counts numbers the runs, and
//      each run's start and id are written (uids' tail gets the sentinel);
//      then every run longer than a warp's 32 lanes goes on the list of
//      long runs.
//   2. dedup_sum. Its first blocks take the long runs, a block a run: the
//      block's producer warps copy the run's rows, found through `order`,
//      into a ring of NSTAGE tiles of shared memory with cp.async, up to
//      NSTAGE tiles ahead, each stage handed over by mbarriers (full: the
//      copies landed; empty: the adds read it), while its consumer threads
//      (a column each, the first ceil(D / 32) warps; rows wider than 256
//      columns go in column slices) add the tile that has landed, their
//      shared-memory loads AHEAD rows ahead of the adds, so an add waits on
//      the add before it. Producers run on the schedulers free of
//      consumers. The other blocks take the other runs, a warp a run, a
//      lane a column: the lanes fetch the run's positions in `order` at
//      once, and every lane issues BATCH rows' loads before their adds; and
//      the entries past the last run (zero rows).
//   Which path a run takes is its length; D sets the lanes and the slices.
//   No option.
// The rows summed through the staged path (counts[0], one atomicAdd a long
// block) and all rows (counts[1], dedup_runs) only grow; the trainers read
// them at their existing fetches (ops/sparse_adam.py::fetch_tiny_counts).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int RUNS_THREADS = 1024;
constexpr int RUN_ITEMS = 16;   // stripes of 32 ids a warp of dedup_runs takes
constexpr int SUM_THREADS = 256;
constexpr int WARPS = SUM_THREADS / 32;
constexpr int NSTAGE = 3;       // tiles of the ring: two in flight, one read
constexpr int SHORT_MAX = 32;   // a run of at most this many rows: a warp's
constexpr int BATCH = 8;        // rows a lane has in flight (copies, loads)
constexpr int AHEAD = 16;       // staged rows a consumer loads ahead
constexpr int MAX_W = SUM_THREADS;   // a consumer thread a column of a slice
constexpr int TILE_FLOATS = 4096;    // 16 KB a tile, 3 a ring
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// starts [n_runs + 1] (the last is k), longs [n_long], meta = {n_runs,
// n_long}. sid is read in chunks of RUN_ITEMS x RUNS_THREADS ids: warp w
// takes RUN_ITEMS stripes of 32 neighbours, every load of a stripe
// coalesced and all of them in flight at once; a ballot a stripe finds its
// run starts, their ranks are counted within the warp and the warps' sums
// added by a scan of the block's 32 warps, so a stripe's starts are written
// to neighbouring entries.
__global__ void __launch_bounds__(RUNS_THREADS)
    dedup_runs(const int32_t* __restrict__ sid, int k, int32_t n_rows,
               int32_t* __restrict__ uids, int32_t* starts,
               int32_t* __restrict__ longs, int32_t* __restrict__ meta,
               unsigned long long* __restrict__ counts) {
  __shared__ int warp_total[RUNS_THREADS / 32];
  __shared__ int n_long;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) n_long = 0;
  int n_runs = 0;  // the runs of the chunks before, the same in every thread
  for (int base = 0; base < k; base += RUN_ITEMS * RUNS_THREADS) {
    const int wbase = base + warp * 32 * RUN_ITEMS;
    int32_t v[RUN_ITEMS];
#pragma unroll
    for (int e = 0; e < RUN_ITEMS; ++e) {
      const int i = wbase + 32 * e + lane;
      v[e] = i < k ? __ldg(sid + i) : 0;
    }
    const int32_t before =
        lane == 0 && wbase > 0 && wbase <= k ? __ldg(sid + wbase - 1) : 0;
    unsigned starts_of[RUN_ITEMS];  // a ballot of each stripe's run starts
    int found = 0;
#pragma unroll
    for (int e = 0; e < RUN_ITEMS; ++e) {
      int32_t prev = __shfl_up_sync(FULL, v[e], 1);
      const int32_t carry =
          e > 0 ? __shfl_sync(FULL, v[e > 0 ? e - 1 : 0], 31) : before;
      if (lane == 0) prev = carry;
      const int i = wbase + 32 * e + lane;
      starts_of[e] = __ballot_sync(FULL, i < k && (i == 0 || v[e] != prev));
      found += __popc(starts_of[e]);
    }
    if (lane == 0) warp_total[warp] = found;
    __syncthreads();
    if (warp == 0) warp_total[lane] = warp_inclusive_scan(warp_total[lane]);
    __syncthreads();
    int r = n_runs + (warp > 0 ? warp_total[warp - 1] : 0);
    n_runs += warp_total[RUNS_THREADS / 32 - 1];
    __syncthreads();  // warp_total is free for the next chunk
#pragma unroll
    for (int e = 0; e < RUN_ITEMS; ++e) {
      if ((starts_of[e] >> lane) & 1u) {
        const int at = r + __popc(starts_of[e] & ((1u << lane) - 1u));
        starts[at] = wbase + 32 * e + lane;
        uids[at] = v[e];
      }
      r += __popc(starts_of[e]);
    }
  }
  for (int j = n_runs + t; j < k; j += RUNS_THREADS) uids[j] = n_rows;
  if (t == 0) {
    starts[n_runs] = k;
    meta[0] = n_runs;
  }
  __syncthreads();  // the block's starts are visible to all its threads
#pragma unroll 4
  for (int j = t; j < n_runs; j += RUNS_THREADS)
    if (starts[j + 1] - starts[j] > SHORT_MAX)
      longs[atomicAdd(&n_long, 1)] = j;
  __syncthreads();
  if (t == 0) {
    meta[1] = n_long;
    atomicAdd(counts + 1, static_cast<unsigned long long>(k));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// one arrival on *bar once every cp.async this thread has issued has
// landed (.noinc: the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_STAGE:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_STAGE;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// acc + x[0] + x[S] + x[2S] + ... (rows of them; S = STRIDE, or w where
// STRIDE is 0), added in order. The loads run AHEAD rows ahead of the adds,
// unconditionally: up to AHEAD rows past the tile are read and not added
// (the next stage's, or the ring's padding), so an add waits on the add
// before it alone.
template <int STRIDE>
__device__ __forceinline__ float add_rows(float acc, const float* x,
                                          int rows, int w) {
  const int stride = STRIDE > 0 ? STRIDE : w;
  float cur[AHEAD];
#pragma unroll
  for (int b = 0; b < AHEAD; ++b) cur[b] = x[b * stride];
  int j = 0;
  for (; j + AHEAD <= rows; j += AHEAD) {
    float nxt[AHEAD];
#pragma unroll
    for (int b = 0; b < AHEAD; ++b) nxt[b] = x[(j + AHEAD + b) * stride];
#pragma unroll
    for (int b = 0; b < AHEAD; ++b) acc = __fadd_rn(acc, cur[b]);
#pragma unroll
    for (int b = 0; b < AHEAD; ++b) cur[b] = nxt[b];
  }
#pragma unroll
  for (int b = 0; b < AHEAD; ++b)
    if (j + b < rows) acc = __fadd_rn(acc, cur[b]);
  return acc;
}

// The producer warps of a long-run block beside CW consumer warps (warps
// 0 .. CW - 1). A warp issues on scheduler warp % 4; while a scheduler is
// free of consumers, only those schedulers' warps produce, so that the
// consumers' chains of adds keep their issue slots.
__host__ __device__ constexpr int producer_warps(int cw) {
  return cw < 4 ? (WARPS / 4) * (4 - cw) : (cw < WARPS ? WARPS - cw : WARPS);
}

// producer index of warp w (-1: not a producer)
__device__ __forceinline__ int producer_of(int w, int cw) {
  if (cw < 4) return w % 4 >= cw ? (w / 4) * (4 - cw) + w % 4 - cw : -1;
  return cw < WARPS ? w - cw : w;
}

// The ring of a long-run block: NSTAGE stages of tile_rows rows of a
// column slice (then AHEAD rows of padding), each stage with a "full"
// barrier (every producer thread arrives once its copies into the stage
// have landed) and an "empty" one (every consumer warp arrives once it has
// read the stage). The block's tiles are numbered across its runs and
// slices (tile0), so stage g % NSTAGE holds tile g and its barriers' phase
// is g / NSTAGE.
struct Ring {
  float* stage;
  uint64_t* full;
  uint64_t* empty;
  int tile0;
};

// One long run's column slice: rows order[s .. s + len) of grads,
// columns [c0, c0 + w), summed by the whole block into out[0 .. w) (the
// run's gsum row from column c0). CW = ceil(w / 32) consumer warps own a
// column a thread; producer_warps(CW) warps copy the rows into the ring,
// where row i of a tile holds the slice's w floats at i * w. Producer p
// copies the tile's rows p, p + producers, ... (at most 32: the wrapper's
// tile_rows keeps it so), a lane a column (4-byte copies, coalesced): lane
// l holds the l-th one's position, loaded while the tile before is copied,
// and BATCH rows at a time have their positions broadcast and their copies
// issued back to back. (16-byte copies, 8 lanes a row, measured slower on
// the H100.) Producers wait for a stage's consumers to free it and run up
// to NSTAGE tiles ahead of the adds. (A struct of inlined methods, not
// lambdas: everything stays in registers.)
template <int CW>
struct Staged {
  static constexpr int producers = producer_warps(CW);

  const float* src0;  // grads + c0 + lane
  const long long* order;
  int s, len, d, w, tile_rows, tiles, lane, p;
  Ring& ring;

  __device__ __forceinline__ int rows_of(int t) const {
    return min(tile_rows, len - t * tile_rows);
  }

  // this producer warp's rows of tile t
  __device__ __forceinline__ int mine(int t) const {
    const int rows = t < tiles ? rows_of(t) : 0;
    return rows > p ? (rows - p + producers - 1) / producers : 0;
  }

  // lane's row position of tile t (0 past this warp's rows)
  __device__ __forceinline__ int fetch(int t) const {
    return lane < mine(t) ? static_cast<int>(__ldg(
                                order + s + t * tile_rows + p + producers * lane))
                          : 0;
  }

  __device__ __forceinline__ void produce(int t, int pos) const {
    if (t >= tiles) return;
    const int g = ring.tile0 + t, st = g % NSTAGE;
    if (g >= NSTAGE) bar_wait(&ring.empty[st], ((g / NSTAGE) - 1) & 1);
    float* dst = ring.stage + (st * tile_rows + p) * w + lane;
    const int step = producers * w, n = mine(t);
    bool col_ok[CW];
#pragma unroll
    for (int q = 0; q < CW; ++q) col_ok[q] = lane + 32 * q < w;
    for (int l0 = 0; l0 < n; l0 += BATCH) {
      int row[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        row[b] = __shfl_sync(FULL, pos, (l0 + b) & 31);
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        if (l0 + b < n) {
          const float* from = src0 + row[b] * d;
          float* to = dst + (l0 + b) * step;
#pragma unroll
          for (int q = 0; q < CW; ++q)
            if (col_ok[q]) cp_async4(to + 32 * q, from + 32 * q);
        }
      }
    }
    cp_async_arrive(&ring.full[st]);
  }

  __device__ __forceinline__ float consume(int t, float acc) const {
    const int g = ring.tile0 + t, st = g % NSTAGE;
    bar_wait(&ring.full[st], (g / NSTAGE) & 1);
    const int col = threadIdx.x;
    const float* x = ring.stage + st * tile_rows * w + col;
    if (w == 32 * CW)  // the stride known to the compiler: fewer operations
      acc = add_rows<32 * CW>(acc, x, rows_of(t), w);
    else if (col < w)
      acc = add_rows<0>(acc, x, rows_of(t), w);
    __syncwarp();
    if (lane == 0) bar_arrive(&ring.empty[st]);
    return acc;
  }

  __device__ __forceinline__ void run(float* __restrict__ out) {
    int pos = 0;
    if (p >= 0) {
      pos = fetch(0);
      for (int t = 0; t < NSTAGE - 1; ++t) {
        const int next = fetch(t + 1);
        produce(t, pos);
        pos = next;
      }
    }
    float acc = 0.0f;
    const int warp = threadIdx.x >> 5;
    for (int t = 0; t < tiles; ++t) {
      if (p >= 0) {
        const int next = fetch(t + NSTAGE);
        produce(t + NSTAGE - 1, pos);
        pos = next;
      }
      if (warp < CW) acc = consume(t, acc);
    }
    if (static_cast<int>(threadIdx.x) < w) out[threadIdx.x] = acc;
    ring.tile0 += tiles;
  }
};

// One short run (len <= 32) summed by one warp, a lane a column, 32
// columns at a time.
__device__ void sum_warp(const float* __restrict__ grads,
                         const long long* __restrict__ order, int s, int len,
                         int d, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int src = lane < len ? static_cast<int>(__ldg(order + s + lane)) : 0;
  for (int c = lane; c - lane < d; c += 32) {
    float acc = 0.0f;
    for (int j0 = 0; j0 < len; j0 += BATCH) {
      float x[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int row = __shfl_sync(FULL, src, (j0 + b) & 31);
        x[b] = j0 + b < len && c < d ? __ldg(grads + row * d + c) : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        if (j0 + b < len) acc = __fadd_rn(acc, x[b]);
    }
    if (c < d) out[c] = acc;
  }
}

// Blocks [0, long_blocks) take the long runs, longs[j] for j = blockIdx.x,
// + long_blocks, ..., a column slice of w at a time; the rest take run
// r = their warp, + all their warps, ... up to k: a short run, or a zero
// row past the last run (a long run is left to its block). CW =
// ceil(w / 32).
template <int CW>
__global__ void __launch_bounds__(SUM_THREADS, 2)
    dedup_sum(const float* __restrict__ grads,
              const long long* __restrict__ order,
              const int32_t* __restrict__ starts,
              const int32_t* __restrict__ longs,
              const int32_t* __restrict__ meta, int k, int d, int w,
              int tile_rows, int long_blocks, float* __restrict__ gsum,
              unsigned long long* __restrict__ counts) {
  // NSTAGE * tile_rows + AHEAD rows of w
  extern __shared__ __align__(16) float stage[];
  __shared__ __align__(8) uint64_t bars[2 * NSTAGE];
  const int n_runs = meta[0];
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    const int n_long = meta[1];
    if (static_cast<int>(blockIdx.x) >= n_long) return;
    if (threadIdx.x == 0) {
      for (int i = 0; i < NSTAGE; ++i) {
        bar_init(&bars[i], 32 * producer_warps(CW));
        bar_init(&bars[NSTAGE + i], CW);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    Ring ring{stage, bars, bars + NSTAGE, 0};
    const int lane = threadIdx.x & 31;
    const int p = producer_of(threadIdx.x >> 5, CW);
    unsigned long long staged = 0;
    for (int j = blockIdx.x; j < n_long; j += long_blocks) {
      const int r = longs[j];
      const int s = starts[r];
      const int len = starts[r + 1] - s;
      for (int c0 = 0; c0 < d; c0 += w) {
        Staged<CW> job{grads + c0 + lane, order, s, len, d, min(w, d - c0),
                       tile_rows, (len + tile_rows - 1) / tile_rows, lane, p,
                       ring};
        job.run(gsum + static_cast<size_t>(r) * d + c0);
      }
      staged += static_cast<unsigned long long>(len);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (threadIdx.x == 0) atomicAdd(counts, staged);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x - long_blocks) * WARPS;
  for (int r = (blockIdx.x - long_blocks) * WARPS + (threadIdx.x >> 5); r < k;
       r += warps) {
    float* out = gsum + static_cast<size_t>(r) * d;
    if (r >= n_runs) {
      for (int c = lane; c < d; c += 32) out[c] = 0.0f;
      continue;
    }
    const int s = starts[r];
    const int len = starts[r + 1] - s;
    if (len <= SHORT_MAX) sum_warp(grads, order, s, len, d, out);
  }
}

struct SumArgs {
  const float* grads;
  const long long* order;
  const int32_t* starts;
  const int32_t* longs;
  const int32_t* meta;
  int k, d, w, tile_rows;
  float* gsum;
  unsigned long long* counts;
  cudaStream_t stream;
};

// dedup_sum<CW>'s grid: a block for each long run there can be (k / 33 at
// most) up to one an SM, first, then the card filled once with short-run
// blocks (the occupancy query kept for the device's last instantiation
// and shared-memory size)
template <int CW>
int launch_sum(const SumArgs& a) {
  static int sms_of[MAX_DEVICES] = {};
  static int key_of[MAX_DEVICES] = {};
  static int per_sm_of[MAX_DEVICES] = {};
  const int smem = (NSTAGE * a.tile_rows + AHEAD) * a.w *
                   static_cast<int>(sizeof(float));
  const int key = smem * 16 + CW;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  const bool cached = dev >= 0 && dev < MAX_DEVICES;
  if (cached && per_sm_of[dev] > 0 && key_of[dev] == key) {
    sms = sms_of[dev];
    per_sm = per_sm_of[dev];
  } else {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // 50 KB at D = 32: above the default limit
    err = cudaFuncSetAttribute(dedup_sum<CW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dedup_sum<CW>, SUM_THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = std::max(per_sm, 1);
    if (cached) {
      sms_of[dev] = sms;
      key_of[dev] = key;
      per_sm_of[dev] = per_sm;
    }
  }
  const int long_blocks = std::min((a.k + SHORT_MAX) / (SHORT_MAX + 1), sms);
  const int short_blocks = std::min((a.k + WARPS - 1) / WARPS, per_sm * sms);
  dedup_sum<CW><<<long_blocks + short_blocks, SUM_THREADS, smem, a.stream>>>(
      a.grads, a.order, a.starts, a.longs, a.meta, a.k, a.d, a.w,
      a.tile_rows, long_blocks, a.gsum, a.counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, called by the PyTorch operator in dedup_rows_op.cpp
// (no PyTorch headers here, so nvcc compiles it in seconds). Pointers are
// device pointers on the current device; the caller has checked dtypes,
// shapes, contiguity and devices. sid [k] int32 sorted, order [k] int64 its
// stable sort's permutation, grads [k, d] f32, uids [k] int32, gsum [k, d]
// f32, work [2k + 3] int32 scratch, counts [2] (staged rows, all rows),
// increased. k * d < 2^31. A long run is staged a column slice of w at a
// time (w a multiple of 32 up to 256, or d itself below that), tile_rows
// rows a tile: a multiple of 8, tile_rows * w <= 4,096, at most 32 rows a
// producer warp (ops/sparse_adam.py::dedup_plan). Returns the cudaError_t
// of the launches (0 on success).
extern "C" int aread_dedup_rows(const int32_t* sid, const long long* order,
                                const float* grads, int k, int d, int w,
                                int tile_rows, int32_t n_rows, int32_t* uids,
                                float* gsum, int32_t* work,
                                unsigned long long* counts,
                                void* stream_ptr) {
  if (k == 0) return 0;
  const int cw = (w + 31) / 32;
  if (d < 1 || w < 1 || w > MAX_W || (w < d && w % 32 != 0) || w > d ||
      static_cast<long long>(k) * d >= (1LL << 31) || tile_rows < 8 ||
      tile_rows % 8 != 0 || tile_rows * w > TILE_FLOATS ||
      (tile_rows + producer_warps(cw) - 1) / producer_warps(cw) > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int32_t* starts = work;
  int32_t* longs = work + k + 1;
  int32_t* meta = work + 2 * k + 1;
  dedup_runs<<<1, RUNS_THREADS, 0, stream>>>(sid, k, n_rows, uids, starts,
                                             longs, meta, counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const SumArgs args{grads, order, starts, longs, meta, k, d, w,
                     tile_rows, gsum, counts, stream};
  switch (cw) {
    case 1: return launch_sum<1>(args);
    case 2: return launch_sum<2>(args);
    case 3: return launch_sum<3>(args);
    case 4: return launch_sum<4>(args);
    case 5: return launch_sum<5>(args);
    case 6: return launch_sum<6>(args);
    case 7: return launch_sum<7>(args);
    default: return launch_sum<8>(args);
  }
}

extern "C" const char* aread_dedup_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
