// Registers the fused dense Adam of fused_adam.cu as the PyTorch operator
// torch.ops.aread_tpu_torch.fused_adam_ (CUDA dispatch key). Compiled by
// the host compiler against PyTorch's headers and linked with the nvcc
// object of fused_adam.cu; see build.py.
//
// The Python wrapper (ops/fused_adam.py::fused_adam_cuda) checks dtypes,
// shapes, devices and contiguity, computes the f32 scalars and picks the
// vector or the scalar kernel (`vec`) from the pointers' alignment;
// index_base keys a shard's stochastic rounding on global element indices; the
// launcher sizes the grid. This operator passes the tensors' storage to
// the launcher on the stream it is given and raises on a CUDA error.

#include <torch/library.h>

#include <cstdint>

extern "C" int aread_fused_adam(
    void* w, int w_bf16, void* m, void* v, int mv_bf16, const void* g,
    int g_bf16, uint64_t n_elems, float lr, float b1, float b2, float eps,
    float decay, float b1c, float b2c, float omb1, float omb2, uint32_t seed,
    uint32_t index_base, int vec, void* stream_ptr);
extern "C" const char* aread_fused_adam_error_string(int err);

namespace {

// Scalars arrive as doubles (the schema's `float`) holding exact f32
// values, so the casts below are exact.
void fused_adam_(const at::Tensor& w, const at::Tensor& m, const at::Tensor& v,
                 const at::Tensor& g, double lr, double b1, double b2,
                 double eps, double decay, double b1c, double b2c, double omb1,
                 double omb2, int64_t seed, int64_t index_base, bool vec,
                 int64_t stream) {
  TORCH_CHECK(index_base >= 0 && index_base + w.numel() <= 0xFFFFFFFFLL,
              "fused_adam_: index_base + numel must stay below 2^32");
  const int err = aread_fused_adam(
      w.data_ptr(), w.scalar_type() == at::kBFloat16, m.data_ptr(),
      v.data_ptr(), m.scalar_type() == at::kBFloat16, g.data_ptr(),
      g.scalar_type() == at::kBFloat16, static_cast<uint64_t>(w.numel()),
      static_cast<float>(lr), static_cast<float>(b1), static_cast<float>(b2),
      static_cast<float>(eps), static_cast<float>(decay),
      static_cast<float>(b1c), static_cast<float>(b2c),
      static_cast<float>(omb1), static_cast<float>(omb2),
      static_cast<uint32_t>(seed & 0xFFFFFFFF),
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
      "float lr, float b1, float b2, float eps, float decay, float b1c, "
      "float b2c, float omb1, float omb2, int seed, int index_base, "
      "bool vec, int stream) -> ()");
}

TORCH_LIBRARY_IMPL(aread_tpu_torch, CUDA, lib) {
  lib.impl("fused_adam_", &fused_adam_);
}
