// Registers the fused dense Adam of fused_adam.cu as the PyTorch operator
// torch.ops.aread_tpu_torch.fused_adam_ (CUDA dispatch key). Compiled by
// the host compiler against PyTorch's headers and linked with the nvcc
// object of fused_adam.cu; see build.py.
//
// The Python wrapper (ops/fused_adam.py::fused_adam_cuda) checks dtypes,
// shapes, devices and contiguity, computes the step-independent f32 scalars
// and hands the step's scalar block (lr, b1c, b2c, seed: a [4] int32 tensor
// on the device, which the kernel reads), picks the vector or the scalar
// kernel (`vec`) from the pointers' alignment; index_base keys a shard's
// stochastic rounding on global element indices; the launcher sizes the
// grid. This operator passes the tensors' storage to
// the launcher on the stream it is given and raises on a CUDA error.

#include <torch/library.h>

#include <cstdint>

extern "C" int aread_fused_adam(
    void* w, int w_bf16, void* m, void* v, int mv_bf16, const void* g,
    int g_bf16, uint64_t n_elems, const uint32_t* step, float b1, float b2,
    float eps, float decay, float omb1, float omb2, uint32_t index_base,
    int vec, void* stream_ptr);
extern "C" const char* aread_fused_adam_error_string(int err);

namespace {

// Scalars arrive as doubles (the schema's `float`) holding exact f32
// values, so the casts below are exact.
void fused_adam_(const at::Tensor& w, const at::Tensor& m, const at::Tensor& v,
                 const at::Tensor& g, const at::Tensor& step, double b1,
                 double b2, double eps, double decay, double omb1, double omb2,
                 int64_t index_base, bool vec, int64_t stream) {
  TORCH_CHECK(step.scalar_type() == at::kInt && step.numel() == 4 &&
                  step.is_contiguous() && step.device() == w.device(),
              "fused_adam_: the step's scalars must be a contiguous [4] "
              "int32 tensor on the leaf's device");
  TORCH_CHECK(index_base >= 0 && index_base + w.numel() <= 0xFFFFFFFFLL,
              "fused_adam_: index_base + numel must stay below 2^32");
  const int err = aread_fused_adam(
      w.data_ptr(), w.scalar_type() == at::kBFloat16, m.data_ptr(),
      v.data_ptr(), m.scalar_type() == at::kBFloat16, g.data_ptr(),
      g.scalar_type() == at::kBFloat16, static_cast<uint64_t>(w.numel()),
      reinterpret_cast<const uint32_t*>(step.data_ptr<int32_t>()),
      static_cast<float>(b1), static_cast<float>(b2),
      static_cast<float>(eps), static_cast<float>(decay),
      static_cast<float>(omb1), static_cast<float>(omb2),
      static_cast<uint32_t>(index_base), vec ? 1 : 0,
      reinterpret_cast<void*>(stream));
  TORCH_CHECK(err == 0, "fused_adam_ kernel launch failed: ",
              aread_fused_adam_error_string(err));
}

}  // namespace

// a fragment: every kernel of the port adds its operator to the one
// namespace from its own library
TORCH_LIBRARY_FRAGMENT(aread_tpu_torch, lib) {
  lib.def(
      "fused_adam_(Tensor(a!) w, Tensor(b!) m, Tensor(c!) v, Tensor g, "
      "Tensor step, float b1, float b2, float eps, float decay, "
      "float omb1, float omb2, int index_base, bool vec, int stream) -> ()");
}

TORCH_LIBRARY_IMPL(aread_tpu_torch, CUDA, lib) {
  lib.impl("fused_adam_", &fused_adam_);
}
