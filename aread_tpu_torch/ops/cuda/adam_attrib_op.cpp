// Registers the attribution sweeps of adam_attrib.cu (six modes, two
// forms) as the PyTorch operator torch.ops.aread_tpu_torch.adam_attrib_
// (CUDA dispatch key).
// Compiled by the host compiler against PyTorch's headers and linked with
// the nvcc object of adam_attrib.cu; see build.py.
//
// The Python wrapper (ops/adam_attrib.py::adam_attrib_) checks the mode,
// the form, dtypes, shapes, devices, contiguity and alignment, computes the f32
// scalars and the row shift and owns the slot map. This operator passes
// the tensors' storage to the launcher on the stream it is given and
// raises on a CUDA error.

#include <torch/library.h>

#include <cstdint>

extern "C" int aread_adam_attrib(
    int mode, int form, void* w, void* m, void* v, const int32_t* uids,
    int k_total,
    const float* gsum, int32_t* slot, uint32_t n_rows, uint32_t d, float lr,
    float b1, float b2, float eps, float decay, float b1c, float b2c,
    float omb1, float omb2, uint32_t seed, uint32_t shift, void* stream_ptr);
extern "C" const char* aread_adam_attrib_error_string(int err);

namespace {

// Scalars arrive as doubles (the schema's `float`) holding exact f32
// values, so the casts below are exact.
void adam_attrib_(const at::Tensor& w, const at::Tensor& m, const at::Tensor& v,
                  const at::Tensor& uids, const at::Tensor& gsum,
                  const at::Tensor& slot, int64_t mode, int64_t form,
                  double lr, double b1,
                  double b2, double eps, double decay, double b1c, double b2c,
                  double omb1, double omb2, int64_t seed, int64_t shift,
                  int64_t stream) {
  TORCH_CHECK(w.scalar_type() == at::kBFloat16 &&
                  m.scalar_type() == at::kBFloat16 &&
                  v.scalar_type() == at::kBFloat16,
              "adam_attrib_: w, m and v must be bfloat16");
  TORCH_CHECK(w.size(1) == (int64_t{8} << shift),
              "adam_attrib_: D must be 8 << shift");
  const int err = aread_adam_attrib(
      static_cast<int>(mode), static_cast<int>(form), w.data_ptr(),
      m.data_ptr(), v.data_ptr(),
      uids.data_ptr<int32_t>(), static_cast<int>(uids.numel()),
      gsum.data_ptr<float>(), slot.data_ptr<int32_t>(),
      static_cast<uint32_t>(w.size(0)), static_cast<uint32_t>(w.size(1)),
      static_cast<float>(lr), static_cast<float>(b1), static_cast<float>(b2),
      static_cast<float>(eps), static_cast<float>(decay),
      static_cast<float>(b1c), static_cast<float>(b2c),
      static_cast<float>(omb1), static_cast<float>(omb2),
      static_cast<uint32_t>(seed & 0xFFFFFFFF), static_cast<uint32_t>(shift),
      reinterpret_cast<void*>(stream));
  TORCH_CHECK(err == 0, "adam_attrib_ kernel launch failed: ",
              aread_adam_attrib_error_string(err));
}

}  // namespace

// a fragment: every kernel of the port adds its operator to the one
// namespace from its own library
TORCH_LIBRARY_FRAGMENT(aread_tpu_torch, lib) {
  lib.def(
      "adam_attrib_(Tensor(a!) w, Tensor(b!) m, Tensor(c!) v, Tensor uids, "
      "Tensor gsum, Tensor(d!) slot, int mode, int form, float lr, float b1, "
      "float b2, "
      "float eps, float decay, float b1c, float b2c, float omb1, float omb2, "
      "int seed, int shift, int stream) -> ()");
}

TORCH_LIBRARY_IMPL(aread_tpu_torch, CUDA, lib) {
  lib.impl("adam_attrib_", &adam_attrib_);
}
