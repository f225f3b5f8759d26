// Registers the sparse-Adam sweep of sparse_adam.cu as the PyTorch operator
// torch.ops.aread_tpu_torch.sparse_adam_ (CUDA dispatch key). Compiled by
// the host compiler against PyTorch's headers and linked with the nvcc
// object of sparse_adam.cu; see build.py.
//
// The Python wrapper (ops/sparse_adam.py::sparse_adam_cuda) checks dtypes,
// shapes, devices and contiguity, computes the step-independent f32 scalars
// and hands the step's scalar block (lr, b1c, b2c, seed: a [4] int32 tensor
// on the device, which the kernel reads), picks the
// vector or the scalar sweep (vpr, shift, mul) and owns the slot map and
// the sum(w * w) scratch; the launcher sizes the grid. This operator passes
// the tensors' storage to the launcher on the stream it is given and
// raises on a CUDA error.

#include <torch/library.h>

#include <cstdint>

extern "C" int aread_sparse_adam(
    void* w, int w_bf16, void* m, void* v, int mv_bf16, const int32_t* uids,
    int k_total, const float* gsum, int32_t* slot, uint32_t n_rows, uint32_t d,
    const uint32_t* step, float b1, float b2, float eps, float decay,
    float omb1, float omb2, uint32_t vpr, uint32_t shift, uint32_t mul,
    double* l2_partials, int l2_capacity, float* l2_out,
    unsigned int* l2_count, void* stream_ptr);
extern "C" const char* aread_sparse_adam_error_string(int err);

namespace {

// Scalars arrive as doubles (the schema's `float`) holding exact f32
// values, so the casts below are exact.
void sparse_adam_(const at::Tensor& w, const at::Tensor& m,
                  const at::Tensor& v, const at::Tensor& uids,
                  const at::Tensor& gsum, const at::Tensor& slot,
                  const at::Tensor& l2_partials, const at::Tensor& l2_out,
                  const at::Tensor& l2_count, const at::Tensor& step,
                  double b1, double b2, double eps, double decay, double omb1,
                  double omb2, int64_t vpr, int64_t shift, int64_t mul,
                  int64_t stream) {
  TORCH_CHECK(step.scalar_type() == at::kInt && step.numel() == 4 &&
                  step.is_contiguous() && step.device() == w.device(),
              "sparse_adam_: the step's scalars must be a contiguous [4] "
              "int32 tensor on the table's device");
  const bool want_l2 = l2_partials.numel() > 0;
  TORCH_CHECK(!want_l2 || (l2_partials.scalar_type() == at::kDouble &&
                           l2_out.scalar_type() == at::kFloat &&
                           l2_out.numel() == 1 &&
                           l2_count.scalar_type() == at::kInt &&
                           l2_count.numel() == 1),
              "sparse_adam_: the sum(w*w) scratch must be float64 partials, "
              "one float32 and one int32");
  TORCH_CHECK(vpr == 0 || w.size(1) == 8 * vpr,
              "sparse_adam_: the vector sweep needs D == 8 * vpr");
  const int err = aread_sparse_adam(
      w.data_ptr(), w.scalar_type() == at::kBFloat16, m.data_ptr(),
      v.data_ptr(), m.scalar_type() == at::kBFloat16,
      uids.data_ptr<int32_t>(), static_cast<int>(uids.numel()),
      gsum.data_ptr<float>(), slot.data_ptr<int32_t>(),
      static_cast<uint32_t>(w.size(0)), static_cast<uint32_t>(w.size(1)),
      reinterpret_cast<const uint32_t*>(step.data_ptr<int32_t>()),
      static_cast<float>(b1), static_cast<float>(b2),
      static_cast<float>(eps), static_cast<float>(decay),
      static_cast<float>(omb1), static_cast<float>(omb2),
      static_cast<uint32_t>(vpr),
      static_cast<uint32_t>(shift), static_cast<uint32_t>(mul),
      want_l2 ? l2_partials.data_ptr<double>() : nullptr,
      static_cast<int>(l2_partials.numel()),
      want_l2 ? l2_out.data_ptr<float>() : nullptr,
      want_l2 ? reinterpret_cast<unsigned int*>(l2_count.data_ptr<int32_t>())
              : nullptr,
      reinterpret_cast<void*>(stream));
  TORCH_CHECK(err == 0, "sparse_adam_ kernel launch failed: ",
              aread_sparse_adam_error_string(err));
}

}  // namespace

// a fragment: every kernel of the port adds its operator to the one
// namespace from its own library
TORCH_LIBRARY_FRAGMENT(aread_tpu_torch, lib) {
  lib.def(
      "sparse_adam_(Tensor(a!) w, Tensor(b!) m, Tensor(c!) v, Tensor uids, "
      "Tensor gsum, Tensor(d!) slot, Tensor(e!) l2_partials, "
      "Tensor(f!) l2_out, Tensor(g!) l2_count, Tensor step, float b1, "
      "float b2, float eps, float decay, float omb1, float omb2, int vpr, "
      "int shift, int mul, int stream) -> ()");
}

TORCH_LIBRARY_IMPL(aread_tpu_torch, CUDA, lib) {
  lib.impl("sparse_adam_", &sparse_adam_);
}
