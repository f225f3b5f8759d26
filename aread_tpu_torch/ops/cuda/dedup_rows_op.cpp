// Registers the row dedup of dedup_rows.cu as the PyTorch operator
// torch.ops.aread_tpu_torch.dedup_rows_ (CUDA dispatch key). Compiled by
// the host compiler against PyTorch's headers and linked with the nvcc
// object of dedup_rows.cu; see build.py.
//
// The Python wrapper (ops/sparse_adam.py::dedup_rows_cuda) checks the ids'
// and gradients' devices, dtypes and shapes, sorts the ids, plans the
// column slice and the staging tile (dedup_plan), allocates uids, gsum and the runs' scratch
// and owns the counters; the launcher sizes the grid. This operator passes
// the tensors' storage to the launcher on the stream it is given and raises
// on a CUDA error.

#include <torch/library.h>

#include <cstdint>

extern "C" int aread_dedup_rows(const int32_t* sid, const long long* order,
                                const float* grads, int k, int d, int w,
                                int tile_rows, int32_t n_rows, int32_t* uids,
                                float* gsum, int32_t* work,
                                unsigned long long* counts,
                                void* stream_ptr);
extern "C" const char* aread_dedup_rows_error_string(int err);

namespace {

void dedup_rows_(const at::Tensor& sid, const at::Tensor& order,
                 const at::Tensor& grads, const at::Tensor& uids,
                 const at::Tensor& gsum, const at::Tensor& work,
                 const at::Tensor& counts, int64_t n_rows, int64_t width,
                 int64_t tile_rows, int64_t stream) {
  const int64_t k = sid.numel();
  TORCH_CHECK(sid.scalar_type() == at::kInt && sid.dim() == 1 &&
                  order.scalar_type() == at::kLong && order.numel() == k &&
                  uids.scalar_type() == at::kInt && uids.numel() == k,
              "dedup_rows_: sid and uids must be [K] int32, order [K] int64");
  TORCH_CHECK(grads.scalar_type() == at::kFloat && grads.dim() == 2 &&
                  grads.size(0) == k && gsum.scalar_type() == at::kFloat &&
                  gsum.sizes() == grads.sizes(),
              "dedup_rows_: grads and gsum must be [K, D] float32");
  TORCH_CHECK(work.scalar_type() == at::kInt && work.numel() == 2 * k + 3,
              "dedup_rows_: the runs' scratch must be [2K + 3] int32");
  TORCH_CHECK(counts.scalar_type() == at::kLong && counts.numel() == 2,
              "dedup_rows_: the counters must be [2] int64");
  TORCH_CHECK(grads.numel() < (int64_t{1} << 31) && n_rows >= 0 &&
                  n_rows < (int64_t{1} << 31),
              "dedup_rows_: K * D and n_rows below 2^31");
  for (const at::Tensor* x : {&sid, &order, &grads, &uids, &gsum, &work,
                              &counts})
    TORCH_CHECK(x->is_contiguous() && x->device() == sid.device(),
                "dedup_rows_: every tensor contiguous on one device");
  const int err = aread_dedup_rows(
      sid.data_ptr<int32_t>(),
      reinterpret_cast<const long long*>(order.data_ptr<int64_t>()),
      grads.data_ptr<float>(), static_cast<int>(k),
      static_cast<int>(grads.size(1)), static_cast<int>(width),
      static_cast<int>(tile_rows),
      static_cast<int32_t>(n_rows), uids.data_ptr<int32_t>(),
      gsum.data_ptr<float>(), work.data_ptr<int32_t>(),
      reinterpret_cast<unsigned long long*>(counts.data_ptr<int64_t>()),
      reinterpret_cast<void*>(stream));
  TORCH_CHECK(err == 0, "dedup_rows_ kernel launch failed: ",
              aread_dedup_rows_error_string(err));
}

}  // namespace

// a fragment: every kernel of the port adds its operator to the one
// namespace from its own library
TORCH_LIBRARY_FRAGMENT(aread_tpu_torch, lib) {
  lib.def(
      "dedup_rows_(Tensor sid, Tensor order, Tensor grads, Tensor(a!) uids, "
      "Tensor(b!) gsum, Tensor(c!) work, Tensor(d!) counts, int n_rows, "
      "int width, int tile_rows, int stream) -> ()");
}

TORCH_LIBRARY_IMPL(aread_tpu_torch, CUDA, lib) {
  lib.impl("dedup_rows_", &dedup_rows_);
}
