// Scattered row copies into a two-stage shared-memory scratch — the Hopper
// kernel that replaces the TPU kernel benchmarks/prof_dma_issue.py::
// gather_rows_kernel (its pallas_call in bench_gather). It is a probe: it
// measures what one scattered copy of a [rows, 128] f32 block costs, the
// price of a touched-rows ("lazy") Adam that would fetch each touched row
// with such copies instead of sweeping the table.
//
// What it computes: out = sum_i table[ids[i], 0] in f32, added one at a time
// in the order of i (bitwise a sequential f32 sum), where for every i the
// whole block table[ids[i] : ids[i] + rows, :] (rows * 512 contiguous bytes)
// is copied from device memory into shared memory before its first element
// is read. Reading element [0, 0] alone would be a 4-byte gather and would
// measure nothing of a block copy.
//
// How: one thread of one block, as the TPU kernel is one sequential core,
// and the TPU's order exactly: start copy i + 1 into stage (i + 1) % 2, wait
// for copy i, read element [0, 0] of stage i % 2. Each copy is one TMA bulk
// copy (cp.async.bulk, global -> shared) completing on an mbarrier of its
// stage (mbarrier.arrive.expect_tx with the copy's bytes, then
// try_wait.parity on the stage's phase). The bulk copy was chosen over
// cp.async at 16 bytes a thread because it is what the TPU's DMA is: one
// instruction issues the whole block whatever its size, the hardware walks
// the addresses, and a barrier in shared memory reports completion as the
// DMA semaphore does. cp.async would spend one instruction per 16 bytes
// (32 for a 512-byte block, 256 for 4 KB) and a __syncthreads per copy, so
// its time would not be the issue cost the probe asks for. The next id is
// loaded one step ahead so that its latency hides behind the wait.
//
// Bound: bytes (n * rows * 512 and the ids: microseconds at 3.35 TB/s), and
// the kernel stays far from it by design: with two copies in flight the
// loop waits a round trip to device memory for every other copy, so ns per
// copy is about half that latency plus the issue cost, which is what the
// probe measures.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;  // f32 per table row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
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

// launched as one block of one thread; stage holds 2 * rows * LANES floats
__global__ void gather_rows_sum(const float* __restrict__ table,
                                const int32_t* __restrict__ ids, int n,
                                int rows, float* __restrict__ out) {
  extern __shared__ __align__(128) float stage[];
  __shared__ __align__(8) uint64_t bar[2];
  const uint32_t bytes = static_cast<uint32_t>(rows) * LANES * sizeof(float);
  const size_t block = static_cast<size_t>(rows) * LANES;
  bar_init(&bar[0]);
  bar_init(&bar[1]);
  // the barriers' initialisation visible to the copy engine
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float acc = 0.0f;
  if (n > 0)
    start_copy(stage, table + static_cast<size_t>(ids[0]) * LANES, bytes,
               &bar[0]);
  int32_t next = n > 1 ? ids[1] : 0;
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    if (i + 1 < n) {
      // stage 1 - s was read at step i - 1; order that read before the
      // copy engine writes the stage again
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      start_copy(stage + (1 - s) * block,
                 table + static_cast<size_t>(next) * LANES, bytes,
                 &bar[1 - s]);
      if (i + 2 < n) next = ids[i + 2];
    }
    wait_copy(&bar[s], (static_cast<uint32_t>(i) >> 1) & 1u);
    acc = __fadd_rn(acc, stage[s * block]);
  }
  out[0] = acc;
}

}  // namespace

// Plain C entry point, called by the PyTorch operator in gather_rows_op.cpp.
// Device pointers on the current device; the caller has checked that table
// is a contiguous, 16-byte aligned f32 [n_table, 128], ids int32 [n] with
// 0 <= ids < n_table - rows + 1, and 1 <= rows <= 32 (the two stages then
// fit the default 48 KB of shared memory). Writes the sum to out[0].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int aread_gather_rows(const float* table, const int32_t* ids, int n,
                                 int rows, float* out, void* stream_ptr) {
  const size_t smem = 2 * static_cast<size_t>(rows) * LANES * sizeof(float);
  gather_rows_sum<<<1, 1, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      table, ids, n, rows, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* aread_gather_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
