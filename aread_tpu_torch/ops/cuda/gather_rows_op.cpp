// Registers the scattered-row copy probe of gather_rows.cu as the PyTorch
// operator torch.ops.aread_tpu_torch.gather_rows_ (CUDA dispatch key).
// Compiled by the host compiler against PyTorch's headers and linked with
// the nvcc object of gather_rows.cu; see build.py.
//
// The Python wrapper (ops/gather_rows.py::gather_rows_sum) checks the
// device, dtypes, shapes, contiguity, alignment and the ids' range and
// allocates the output. This operator passes the tensors' storage to the
// launcher on the stream it is given and raises on a CUDA error.

#include <torch/library.h>

#include <cstdint>

extern "C" int aread_gather_rows(const float* table, const int32_t* ids, int n,
                                 int rows, float* out, void* stream_ptr);
extern "C" const char* aread_gather_rows_error_string(int err);

namespace {

void gather_rows_(const at::Tensor& table, const at::Tensor& ids,
                  const at::Tensor& out, int64_t rows, int64_t stream) {
  TORCH_CHECK(table.scalar_type() == at::kFloat && table.dim() == 2 &&
                  table.size(1) == 128,
              "gather_rows_: table must be float32 [n, 128]");
  TORCH_CHECK(ids.scalar_type() == at::kInt && out.scalar_type() == at::kFloat &&
                  out.numel() == 1,
              "gather_rows_: ids must be int32 and out one float32");
  TORCH_CHECK(rows >= 1 && rows <= 32, "gather_rows_: rows must be in 1..32");
  const int err = aread_gather_rows(
      table.data_ptr<float>(), ids.data_ptr<int32_t>(),
      static_cast<int>(ids.numel()), static_cast<int>(rows),
      out.data_ptr<float>(), reinterpret_cast<void*>(stream));
  TORCH_CHECK(err == 0, "gather_rows_ kernel launch failed: ",
              aread_gather_rows_error_string(err));
}

}  // namespace

// a fragment: every kernel of the port adds its operator to the one
// namespace from its own library
TORCH_LIBRARY_FRAGMENT(aread_tpu_torch, lib) {
  lib.def(
      "gather_rows_(Tensor table, Tensor ids, Tensor(a!) out, int rows, "
      "int stream) -> ()");
}

TORCH_LIBRARY_IMPL(aread_tpu_torch, CUDA, lib) {
  lib.impl("gather_rows_", &gather_rows_);
}
