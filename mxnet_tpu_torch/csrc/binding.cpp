// Python binding of the port's CUDA kernels: the only source that includes
// PyTorch's headers. It turns tensors into pointers and calls the plain C
// launchers in the .cu files. The Python wrappers (mxnet_tpu_torch/ops/cuda)
// check device, dtype, shape and contiguity and allocate the outputs; the
// launchers run on the stream they are given and return cudaGetLastError().
#include <torch/extension.h>

#include <optional>
#include <vector>

extern "C" {
int mxt_layernorm_fwd(const void* x, const void* gamma, const void* beta,
                      void* y, int64_t rows, int cols, float eps, int dtype,
                      void* stream);
int64_t mxt_layernorm_bwd_parts(int64_t rows, int sms);
int mxt_layernorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                      float* part, float* dgamma, float* dbeta, int64_t rows,
                      int cols, int parts, float eps, int dtype, void* stream);
int mxt_flash_fwd(const void* q, const void* k, const void* v,
                  const int32_t* valid_len, void* o, float* lse,
                  int batch_heads, int heads, int tq, int tk, int d,
                  float scale, int causal, void* stream);
int mxt_flash_fwd_f32(const float* q, const float* k, const float* v,
                      const int32_t* valid_len, float* o, float* lse,
                      float* work, int batch_heads, int heads, int tq, int tk,
                      int d, float scale, int causal, int splits, int chunk,
                      void* stream);
int mxt_flash_fwd_f32_tile(int d, int* rows, int* keys, int* per_sm);
int mxt_flash_bwd(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const int32_t* valid_len, float* dq_acc, void* dq, void* dk,
                  void* dv, int batch_heads, int heads, int tq, int tk, int d,
                  float scale, int causal, void* stream);
int64_t mxt_flash_bwd_workspace(int batch_heads, int tq, int d);
int mxt_xent_fwd(const void* x, const int32_t* labels, float* loss, float* lse,
                 int64_t rows, int V, int64_t ldx, int dtype, void* stream);
int mxt_xent_bwd(const void* x, const int32_t* labels, const float* lse,
                 const float* dy, void* dx, int64_t rows, int V, int64_t ldx,
                 int64_t ldd, int dtype, void* stream);
const char* mxt_cuda_error_string(int err);
}

namespace {

void check_launch(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " launch failed: ", mxt_cuda_error_string(err));
}

int dtype_code(const torch::Tensor& x) {
  switch (x.scalar_type()) {
    case torch::kFloat32: return 0;
    case torch::kBFloat16: return 1;
    default: TORCH_CHECK(false, "kernel: unsupported dtype ", x.scalar_type());
  }
  return -1;
}

const int32_t* optional_int32(const std::optional<torch::Tensor>& t) {
  return t ? t->data_ptr<int32_t>() : nullptr;
}

void layernorm_fwd(const torch::Tensor& x, const torch::Tensor& gamma,
                   const torch::Tensor& beta, torch::Tensor& y, double eps,
                   int64_t stream) {
  check_launch(mxt_layernorm_fwd(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                 y.data_ptr(), x.size(0), (int)x.size(1),
                                 (float)eps, dtype_code(x),
                                 reinterpret_cast<void*>(stream)),
               "layernorm_fwd");
}

int64_t layernorm_bwd_parts(int64_t rows, int64_t sms) {
  return mxt_layernorm_bwd_parts(rows, (int)sms);
}

void layernorm_bwd(const torch::Tensor& x, const torch::Tensor& gamma,
                   const torch::Tensor& dy, torch::Tensor& dx,
                   torch::Tensor& part, torch::Tensor& dgamma,
                   torch::Tensor& dbeta, double eps, int64_t stream) {
  check_launch(mxt_layernorm_bwd(x.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                                 dx.data_ptr(), part.data_ptr<float>(),
                                 dgamma.data_ptr<float>(),
                                 dbeta.data_ptr<float>(), x.size(0),
                                 (int)x.size(1), (int)part.size(0), (float)eps,
                                 dtype_code(x), reinterpret_cast<void*>(stream)),
               "layernorm_bwd");
}

void flash_fwd(const torch::Tensor& q, const torch::Tensor& k,
               const torch::Tensor& v, const std::optional<torch::Tensor>& valid_len,
               torch::Tensor& o, const std::optional<torch::Tensor>& lse,
               int64_t heads, double scale, bool causal, int64_t stream) {
  check_launch(
      mxt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    optional_int32(valid_len),
                    o.data_ptr(), lse ? lse->data_ptr<float>() : nullptr,
                    (int)(q.size(0) * q.size(1)), (int)heads, (int)q.size(2),
                    (int)k.size(2), (int)q.size(3), (float)scale, causal ? 1 : 0,
                    reinterpret_cast<void*>(stream)),
      "flash_fwd");
}

void flash_fwd_f32(const torch::Tensor& q, const torch::Tensor& k,
                   const torch::Tensor& v,
                   const std::optional<torch::Tensor>& valid_len,
                   torch::Tensor& o, const std::optional<torch::Tensor>& lse,
                   const std::optional<torch::Tensor>& work, int64_t heads,
                   double scale, bool causal, int64_t splits, int64_t chunk,
                   int64_t stream) {
  check_launch(
      mxt_flash_fwd_f32(q.data_ptr<float>(), k.data_ptr<float>(),
                        v.data_ptr<float>(), optional_int32(valid_len),
                        o.data_ptr<float>(),
                        lse ? lse->data_ptr<float>() : nullptr,
                        work ? work->data_ptr<float>() : nullptr,
                        (int)(q.size(0) * q.size(1)), (int)heads,
                        (int)q.size(2), (int)k.size(2), (int)q.size(3),
                        (float)scale, causal ? 1 : 0, (int)splits, (int)chunk,
                        reinterpret_cast<void*>(stream)),
      "flash_fwd_f32");
}

std::vector<int64_t> flash_fwd_f32_tile(int64_t d) {
  int rows = 0, keys = 0, per_sm = 0;
  check_launch(mxt_flash_fwd_f32_tile((int)d, &rows, &keys, &per_sm),
               "flash_fwd_f32_tile");
  return {rows, keys, per_sm};
}

void flash_bwd(const torch::Tensor& q, const torch::Tensor& k,
               const torch::Tensor& v, const torch::Tensor& dout,
               const torch::Tensor& lse, const torch::Tensor& delta,
               const std::optional<torch::Tensor>& valid_len,
               torch::Tensor& dq_acc, torch::Tensor& dq, torch::Tensor& dk,
               torch::Tensor& dv, int64_t heads, double scale, bool causal,
               int64_t stream) {
  check_launch(
      mxt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                    lse.data_ptr<float>(), delta.data_ptr<float>(),
                    optional_int32(valid_len), dq_acc.data_ptr<float>(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    (int)(q.size(0) * q.size(1)), (int)heads, (int)q.size(2),
                    (int)k.size(2), (int)q.size(3), (float)scale, causal ? 1 : 0,
                    reinterpret_cast<void*>(stream)),
      "flash_bwd");
}

int64_t flash_bwd_workspace(int64_t batch_heads, int64_t tq, int64_t d) {
  return mxt_flash_bwd_workspace((int)batch_heads, (int)tq, (int)d);
}

void xent_fwd(const torch::Tensor& x, const torch::Tensor& labels,
              torch::Tensor& loss, torch::Tensor& lse, int64_t stream) {
  check_launch(mxt_xent_fwd(x.data_ptr(), labels.data_ptr<int32_t>(),
                            loss.data_ptr<float>(), lse.data_ptr<float>(),
                            x.size(0), (int)x.size(1), x.stride(0),
                            dtype_code(x), reinterpret_cast<void*>(stream)),
               "xent_fwd");
}

void xent_bwd(const torch::Tensor& x, const torch::Tensor& labels,
              const torch::Tensor& lse, const torch::Tensor& dy,
              torch::Tensor& dx, int64_t stream) {
  check_launch(mxt_xent_bwd(x.data_ptr(), labels.data_ptr<int32_t>(),
                            lse.data_ptr<float>(), dy.data_ptr<float>(),
                            dx.data_ptr(), x.size(0), (int)x.size(1),
                            x.stride(0), dx.stride(0), dtype_code(x),
                            reinterpret_cast<void*>(stream)),
               "xent_bwd");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("layernorm_fwd", &layernorm_fwd, "row LayerNorm forward (CUDA)");
  m.def("layernorm_bwd_parts", &layernorm_bwd_parts,
        "partial rows of the LayerNorm backward's dgamma/dbeta workspace");
  m.def("layernorm_bwd", &layernorm_bwd,
        "row LayerNorm backward, dx, dgamma, dbeta (CUDA)");
  m.def("flash_fwd", &flash_fwd, "flash-attention forward (CUDA)");
  m.def("flash_fwd_f32", &flash_fwd_f32,
        "flash-attention forward, fp32 operands (CUDA)");
  m.def("flash_fwd_f32_tile", &flash_fwd_f32_tile,
        "(query rows a CTA, keys a K/V tile, CTAs an SM) of the fp32 "
        "forward");
  m.def("flash_bwd", &flash_bwd, "flash-attention backward, dq, dk, dv (CUDA)");
  m.def("flash_bwd_workspace", &flash_bwd_workspace,
        "floats of the flash backward's fp32 dq workspace");
  m.def("xent_fwd", &xent_fwd, "softmax cross-entropy forward (CUDA)");
  m.def("xent_bwd", &xent_bwd, "softmax cross-entropy backward (CUDA)");
}
