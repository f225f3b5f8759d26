// Scattered row copies into shared memory — the Hopper kernel that replaces
// the TPU kernel benchmarks/prof_dma_issue.py::gather_rows_kernel (its
// pallas_call in bench_gather). It is a probe: it measures what one
// scattered copy of a [rows, 128] f32 block costs, the price of a
// touched-rows ("lazy") Adam that would fetch each touched row with such
// copies instead of sweeping the table.
//
// What it computes: out = sum_i table[ids[i], 0] in f32, where for every i
// the whole block table[ids[i] : ids[i] + rows, :] (rows * 512 contiguous
// bytes) is copied from device memory into shared memory before its first
// element is read. Reading element [0, 0] alone would be a 4-byte gather and
// would measure nothing of a block copy. Each copy is one TMA bulk copy
// (cp.async.bulk, global -> shared) completing on an mbarrier of its stage
// (mbarrier.arrive.expect_tx with the copy's bytes, then try_wait.parity on
// the stage's phase): what the TPU's DMA and its semaphore are. One
// instruction issues the whole block whatever its size; cp.async would
// spend one per 16 bytes and a __syncthreads per copy.
//
// Two forms:
//
// gather_rows_ring (the card's form). A CTA per CHUNK consecutive ids, so
// the grid spreads over every SM (16,384 ids: 256 CTAs, two a SM). The CTA
// loads its ids into shared memory in one coalesced read. Each warp of the
// CTA is a ring for its 32 ids: `stages` [rows, 128] stages of its own, and
// an elected lane that issues the ring's copies in order, keeping up to
// `stages` in flight, copy k into stage k % stages as soon as the copy
// before it in that stage has been read (the stage's "empty" mbarrier).
// Copy q completes on its own "full" mbarrier (one per copy, so each is
// waited for once, on parity 0); thread q waits for it, keeps its element
// [0, 0] and frees the stage, so the waits run in parallel and the elected
// lane only issues. The elected lane is lane 31: the copies it waits to
// reuse a stage for are read by lanes below it, never by itself. (One
// elected thread a CTA, the first design, issued its 64 copies one after
// another and was the slowest part at rows 1: PERF.md section 6.) A CTA's
// rings hold RING_BYTES (64 KB) or 32 stages each, whichever is less
// (Little's law: a cold bulk copy's round trip is ~0.45 us, so ~1.5 MB
// in flight over the card, 12-16 KB a SM, reach the 3.35 TB/s; 64 KB a
// CTA is 4x that margin: 2 x 32 stages of 512 B at rows 1, 2 x 8 of 4 KB
// at rows 8, 2 x 2 of 16 KB at rows 32). Above 48 KB the launcher opts in
// to the dynamic shared memory.
//   Order of the sum, fixed whatever order the CTAs run in: each chunk's
// elements are added in i order from 0 into the chunk's partial; the
// partials go to a global buffer indexed by chunk, and the last CTA to
// finish (an atomic ticket taken after __threadfence) adds them in chunk
// order from 0. The ticket is the word after the partials in the call's
// own scratch buffer, zeroed on the stream by the launcher (a memset, then
// the kernel's one launch): launches on other streams never share it. An
// in-order sum over all ids would be one chain of dependent adds (~35 us
// for 16,384) that would hide every copy. Where n <= CHUNK the two orders
// make the same adds, so the result is bitwise the in-order sum. Both
// chains are added from shared memory with the loads issued 16 ahead of
// the adds, so a chain costs its adds' latency, not a load's per element.
//
// gather_rows_sum (the TPU's form, kept to ask the TPU script's question:
// what one issuer costs). One thread of one block, as the TPU kernel is one
// sequential core, and the TPU's order exactly: start copy i + 1 into stage
// (i + 1) % 2, wait for copy i, read element [0, 0] of stage i % 2. With
// two copies in flight the loop waits about half a round trip to device
// memory a copy. The next id is loaded one step ahead so that its latency
// hides behind the wait.
//
// Ids out of range: both forms check each id before the copy that reads
// the table with it (the ring as it loads its chunk's ids, the serial form
// as it starts the copy, a step after the load) and trap on an id outside
// [0, n_table - rows]; the launch then fails (cudaErrorLaunchFailure at the
// next synchronisation) and the CUDA context is lost. The check waits for
// nothing on the host, so calls queue back to back.
//
// Bound: bytes, n * rows * 512 of blocks and the ids (microseconds at
// 3.35 TB/s). The ring is built to approach it; the serial form stays far
// from it by design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;  // f32 per table row
// ids a CTA of the ring takes and sums in order; ops/gather_rows.py CHUNK
constexpr int CHUNK = 64;
// shared memory of a CTA's ring; ops/gather_rows.py RING_BYTES
constexpr int RING_BYTES = 64 * 1024;
// rings of a CTA, one a warp of 32 ids
constexpr int RINGS = CHUNK / 32;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a stage read by this thread, ordered before the copy engine writes it again
__device__ __forceinline__ void fence_reuse() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that expects `bytes`, and the bulk copy that completes them
__device__ __forceinline__ void start_copy(float* dst, const float* src,
                                           uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(b)
      : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void wait_copy(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_COPY:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_COPY;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// id, or a trap where it lies outside [0, max_id]
__device__ __forceinline__ int32_t checked_id(int32_t id, int32_t max_id) {
  if (static_cast<uint32_t>(id) > static_cast<uint32_t>(max_id)) __trap();
  return id;
}

// launched as one block of one thread; stage holds 2 * rows * LANES floats
__global__ void gather_rows_sum(const float* __restrict__ table,
                                const int32_t* __restrict__ ids, int n,
                                int rows, int32_t max_id,
                                float* __restrict__ out) {
  extern __shared__ __align__(128) float stage[];
  __shared__ __align__(8) uint64_t bar[2];
  const uint32_t bytes = static_cast<uint32_t>(rows) * LANES * sizeof(float);
  const size_t block = static_cast<size_t>(rows) * LANES;
  bar_init(&bar[0]);
  bar_init(&bar[1]);
  fence_bar_init();
  float acc = 0.0f;
  if (n > 0)
    start_copy(stage,
               table + static_cast<size_t>(checked_id(ids[0], max_id)) * LANES,
               bytes, &bar[0]);
  int32_t next = n > 1 ? ids[1] : 0;
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    if (i + 1 < n) {
      // stage 1 - s was read at step i - 1
      fence_reuse();
      // checked here, a step after its load: the check waits for nothing
      start_copy(stage + (1 - s) * block,
                 table + static_cast<size_t>(checked_id(next, max_id)) * LANES,
                 bytes, &bar[1 - s]);
      if (i + 2 < n) next = ids[i + 2];
    }
    wait_copy(&bar[s], (static_cast<uint32_t>(i) >> 1) & 1u);
    acc = __fadd_rn(acc, stage[s * block]);
  }
  out[0] = acc;
}

// acc + x[0] + x[1] + ... + x[m - 1], added in order in f32, the loads of
// shared memory issued 16 ahead of the adds
__device__ __forceinline__ float add_in_order(float acc, const float* x, int m) {
  constexpr int AHEAD = 16;
  int j = 0;
  for (; j + AHEAD <= m; j += AHEAD) {
    float v[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) v[k] = x[j + k];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) acc = __fadd_rn(acc, v[k]);
  }
  for (; j < m; ++j) acc = __fadd_rn(acc, x[j]);
  return acc;
}

// launched with one CTA of CHUNK threads per chunk of ids (one CTA when n is
// 0); stage holds RINGS * stages * rows * LANES floats, 1 <= stages <= 32;
// partials holds gridDim.x floats; *ticket is 0 on entry
__global__ void __launch_bounds__(CHUNK)
    gather_rows_ring(const float* __restrict__ table,
                     const int32_t* __restrict__ ids, int n, int rows,
                     int32_t max_id, int stages,
                     float* __restrict__ partials,
                     unsigned int* __restrict__ ticket,
                     float* __restrict__ out) {
  extern __shared__ __align__(128) float stage[];
  __shared__ __align__(8) uint64_t full[CHUNK];   // copy q has landed
  __shared__ __align__(8) uint64_t empty[CHUNK];  // stage s has been read
  __shared__ int32_t chunk_ids[CHUNK];
  __shared__ __align__(16) float vals[CHUNK];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int first = blockIdx.x * CHUNK;
  const int len = min(CHUNK, n - first);  // 0 only in the one CTA of n = 0
  const size_t block = static_cast<size_t>(rows) * LANES;
  if (tid < len) chunk_ids[tid] = checked_id(ids[first + tid], max_id);
  const int ring = tid >> 5, lane = tid & 31;
  bar_init(&full[tid]);
  if (lane < stages) bar_init(&empty[ring * stages + lane]);
  fence_bar_init();
  __syncthreads();
  if (lane == 31) {  // the ring's elected lane: it issues the ring's copies
    const uint32_t bytes = static_cast<uint32_t>(rows) * LANES * sizeof(float);
    for (int k = 0; k < 32 && ring * 32 + k < len; ++k) {
      const int s = ring * stages + k % stages;
      if (k >= stages) wait_copy(&empty[s], (k / stages - 1) & 1);
      start_copy(stage + s * block,
                 table + static_cast<size_t>(chunk_ids[ring * 32 + k]) * LANES,
                 bytes, &full[ring * 32 + k]);
    }
  }
  if (tid < len) {  // thread q: copy q's element, then its stage is free
    const int s = ring * stages + lane % stages;
    wait_copy(&full[tid], 0u);
    vals[tid] = stage[s * block];
    if (lane + stages < 32) {  // a later copy of the ring takes the stage
      fence_reuse();
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem_addr(&empty[s]))
                   : "memory");
    }
  }
  __syncthreads();
  if (tid == 0) {
    partials[blockIdx.x] = add_in_order(0.0f, vals, len);
    __threadfence();  // the partial before the ticket, for the last CTA
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last CTA: every other CTA's partial is written; add them in chunk
  // order, through the stages (free now) as many at a time as they hold
  __threadfence();
  const int room = RINGS * stages * static_cast<int>(block);
  float total = 0.0f;
  for (int base = 0; base < static_cast<int>(gridDim.x); base += room) {
    const int m = min(room, static_cast<int>(gridDim.x) - base);
    for (int j = tid; j < m; j += CHUNK) stage[j] = __ldcg(partials + base + j);
    __syncthreads();
    if (tid == 0) total = add_in_order(total, stage, m);
    __syncthreads();
  }
  if (tid == 0) out[0] = total;
}

}  // namespace

// Plain C entry points, called by the PyTorch operators in
// gather_rows_op.cpp. Device pointers on the current device; the caller has
// checked that table is a contiguous, 16-byte aligned f32 [n_table, 128]
// with n_table >= rows, ids int32 [n], and 1 <= rows <= 32; the kernels
// trap on an id outside [0, n_table - rows]. Each writes the sum to out[0]
// and returns the cudaError_t of its launch (0 on success).

// The serial form: the two stages fit the default 48 KB of shared memory.
extern "C" int aread_gather_rows(const float* table, int n_table,
                                 const int32_t* ids, int n, int rows,
                                 float* out, void* stream_ptr) {
  if (n < 0 || rows < 1 || n_table < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(rows) * LANES * sizeof(float);
  gather_rows_sum<<<1, 1, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      table, ids, n, rows, n_table - rows, out);
  return static_cast<int>(cudaGetLastError());
}

// The ring: n_chunks = max(1, ceil(n / CHUNK)) CTAs, scratch the call's
// own n_chunks + 1 words (the chunks' f32 partials, then the ticket, which
// this launcher zeroes on the stream), and 1 <= stages <= 32 a ring with
// RINGS * stages * rows * 512 <= RING_BYTES (the plan of
// ops/gather_rows.py::ring_plan); anything else is cudaErrorInvalidValue.
extern "C" int aread_gather_rows_ring(const float* table, int n_table,
                                      const int32_t* ids, int n, int rows,
                                      int stages, float* scratch,
                                      int n_chunks, float* out,
                                      void* stream_ptr) {
  const size_t smem =
      static_cast<size_t>(RINGS) * stages * rows * LANES * sizeof(float);
  if (n < 0 || rows < 1 || n_table < rows || stages < 1 || stages > 32 ||
      smem > static_cast<size_t>(RING_BYTES) ||
      n_chunks != (n > 0 ? (n + CHUNK - 1) / CHUNK : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + n_chunks);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // above 48 KB of dynamic shared memory only by opt-in, once per device
  static int opted_in[MAX_DEVICES] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES || !opted_in[dev]) {
    err = cudaFuncSetAttribute(gather_rows_ring,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               RING_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < MAX_DEVICES) opted_in[dev] = 1;
  }
  gather_rows_ring<<<n_chunks, CHUNK, smem, stream>>>(
      table, ids, n, rows, n_table - rows, stages, scratch, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* aread_gather_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
