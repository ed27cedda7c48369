// PyTorch binding of the port's CUDA kernels (csrc/*.cu).
//
// Each function takes tensors on one CUDA device, checks their shapes,
// types and layout, allocates the output and calls the kernel's plain-C
// launcher under that device's guard, on its current stream.  A failed
// check or launch raises (RuntimeError in Python); nothing falls back.
// The kernels include no PyTorch header, so nvcc compiles them quickly;
// only this file is compiled against PyTorch.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <cuda_runtime.h>
#include <torch/extension.h>

#include <algorithm>
#include <cstdint>
#include <exception>
#include <optional>
#include <string>
#include <vector>

extern "C" {
int cascade_truncate_launch(const int* p, const float* ck, const int* groups,
                            const int* rows, const int* n3, float* out, int U,
                            int C, int B, int expose, void* stream);
long long target_attention_smem_bytes(int T, int d, int h1, int h2);
int target_attention_launch(const float* q, long long q_bstride,
                            const float* keys, const float* mask,
                            const float* w1, const float* b1, const float* w2,
                            const float* b2, const float* w3, const float* b3,
                            float* out, int B, int N, int T, int d, int h1,
                            int h2, void* stream);
int embedding_bag_launch(const float* table, long long ld, const int* ids,
                         const float* weights, float* out, int B, int D,
                         int L, void* stream);
long long target_attention_bwd_scratch_floats(int B, int N, int d, int h1,
                                              int h2);
int target_attention_bwd_launch(const float* dout, const float* q,
                                const float* keys, const float* mask,
                                const float* w1, const float* b1,
                                const float* w2, const float* b2,
                                const float* w3, const float* b3, float* dq,
                                float* dk, float* dw, float* scratch, int B,
                                int N, int T, int d, int h1, int h2,
                                void* stream);
long long embedding_bag_bwd_scratch_ints(long long n, long long V);
int embedding_bag_bwd_launch(const void* ids, int ids64,
                             const float* weights, const float* dout,
                             float* dtable, int* scratch, long long n, int D,
                             int L, long long V, void* stream);
int dot_interact_launch(const void* feats, void* out, int B, int F, int D,
                        int bf16, void* stream);
int cin_layer_launch(const float* w, const float* x_prev, const float* x0,
                     float* out, int B, int Hp, int m, int D, int Ho,
                     float* (*alloc)(long long, void*), void* alloc_ctx,
                     void* stream);
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int B, int T,
                           int S, int H, int Hkv, int dh, int causal,
                           int window, float scale, float softcap,
                           void* stream);
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, const long long* strides, int B,
                                 int T, int S, int H, int Hkv, int dh,
                                 int causal, int window, float scale,
                                 float softcap, void* stream);
int dot_interact_bwd_launch(const void* dout, const void* feats,
                            void* dfeats, int B, int F, int D, int bf16,
                            void* stream);
long long cin_layer_bwd_scratch_floats(int B, int Hp, int m, int D, int Ho);
int cin_layer_bwd_launch(const float* w, const float* x_prev,
                         const float* x0, const float* dz, float* dw,
                         float* dx_prev, float* dx0, float* scratch, int B,
                         int Hp, int m, int D, int Ho, void* stream);
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, float* scratch, int B,
                               int T, int S, int H, int Hkv, int dh,
                               int causal, int window, float scale,
                               float softcap, int bf16, void* stream);
}

namespace {

// Numbers enter error messages as strings: on some hosts the extension's
// own instance of the ostream number formatting (an inline template from
// the compiler's headers) crashes against the libstdc++ loaded at run
// time, so a failed check that streamed an integer segfaulted instead of
// raising.  std::to_string formats without a stream.
std::string num(long long v) { return std::to_string(v); }

void same_device(const char* what, const torch::Tensor& first,
                 std::initializer_list<const torch::Tensor*> rest) {
  TORCH_CHECK(first.is_cuda(), what, ": inputs must be CUDA tensors");
  for (const torch::Tensor* t : rest)
    TORCH_CHECK(t->device() == first.device(), what,
                ": inputs must all lie on one CUDA device, got ",
                first.device(), " and ", t->device());
}

// err is the launcher's cudaGetLastError() right after its launch.
void check_launch(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)), " (",
              num(err), ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The same for a launcher that builds TMA maps, which also returns -1 when
// libcuda has no cuTensorMapEncodeTiled and -(1000 + r) when it refuses a
// map with CUresult r.
void check_tma_launch(int err, const char* what) {
  TORCH_CHECK(err != -1, what, ": libcuda offers no cuTensorMapEncodeTiled");
  TORCH_CHECK(err > -1000, what, ": cuTensorMapEncodeTiled refused a map "
              "(CUresult ", num(-err - 1000), ")");
  check_launch(err, what);
}

void* stream() { return at::cuda::getCurrentCUDAStream().stream(); }

int as_int(int64_t v, const char* what) {
  TORCH_CHECK(v >= 0 && v <= INT32_MAX, what, " does not fit an int: ",
              num(v));
  return static_cast<int>(v);
}

}  // namespace

// (B,) revenue@expose from (G, U, C) CompactPlan tables.
torch::Tensor cascade_truncate(const torch::Tensor& p, const torch::Tensor& ck,
                               const torch::Tensor& groups,
                               const torch::Tensor& rows,
                               const torch::Tensor& n3, int64_t expose) {
  same_device("cascade_truncate", p, {&ck, &groups, &rows, &n3});
  TORCH_CHECK(p.dim() == 3 && p.sizes() == ck.sizes(),
              "tables must be matching (G, U, C) tensors");
  TORCH_CHECK(p.scalar_type() == torch::kInt32 &&
                  ck.scalar_type() == torch::kFloat32,
              "tables must be int32 positions and float32 clicks");
  TORCH_CHECK(p.is_contiguous() && ck.is_contiguous(),
              "tables must be contiguous");
  TORCH_CHECK(groups.dim() == 1 && rows.sizes() == groups.sizes() &&
                  n3.sizes() == groups.sizes(),
              "groups, rows and n3 must be (B,) vectors");
  const c10::cuda::CUDAGuard guard(p.device());
  const auto g = groups.to(torch::kInt32).contiguous();
  const auto r = rows.to(torch::kInt32).contiguous();
  const auto n = n3.to(torch::kInt32).contiguous();
  const int b = as_int(groups.size(0), "B");
  auto out = torch::empty({b}, ck.options());
  if (b == 0) return out;
  check_launch(
      cascade_truncate_launch(p.data_ptr<int>(), ck.data_ptr<float>(),
                              g.data_ptr<int>(), r.data_ptr<int>(),
                              n.data_ptr<int>(), out.data_ptr<float>(),
                              as_int(p.size(1), "U"), as_int(p.size(2), "C"),
                              b, as_int(expose, "expose"), stream()),
      "cascade_truncate");
  return out;
}

// (B, N, d) candidates against per-user (B, T, d) keys -> (B, N, d).
// q may share one candidate list across users (batch stride 0).
torch::Tensor target_attention(torch::Tensor q, const torch::Tensor& keys,
                               const torch::Tensor& mask,
                               const torch::Tensor& w1,
                               const torch::Tensor& b1,
                               const torch::Tensor& w2,
                               const torch::Tensor& b2,
                               const torch::Tensor& w3,
                               const torch::Tensor& b3) {
  same_device("target_attention", q, {&keys, &mask, &w1, &b1, &w2, &b2, &w3,
                                      &b3});
  TORCH_CHECK(q.dim() == 3 && keys.dim() == 3 && mask.dim() == 2,
              "want q (B, N, d), keys (B, T, d), mask (B, T)");
  const int64_t bsz = q.size(0), n = q.size(1), d = q.size(2);
  const int64_t t = keys.size(1);
  TORCH_CHECK(keys.size(0) == bsz && keys.size(2) == d &&
                  mask.size(0) == bsz && mask.size(1) == t,
              "keys/mask shapes do not match q");
  TORCH_CHECK(w1.dim() == 2 && w2.dim() == 2, "W1 and W2 must be matrices");
  const int64_t h1 = w1.size(1), h2 = w2.size(1);
  TORCH_CHECK(w1.size(0) == 4 * d && b1.numel() == h1 && w2.size(0) == h1 &&
                  b2.numel() == h2 && w3.numel() == h2 && b3.numel() == 1,
              "attention MLP weights must be (4d, h1), (h1, h2), (h2, 1) "
              "with matching biases");
  TORCH_CHECK(d <= 64 && h1 <= 128 && h2 <= 64,
              "the kernel supports d <= 64, h1 <= 128 and h2 <= 64, got d = ",
              num(d), ", h1 = ", num(h1), ", h2 = ", num(h2));
  for (const torch::Tensor* x : std::initializer_list<const torch::Tensor*>{
           &q, &keys, &mask, &w1, &b1, &w2, &b2, &w3, &b3})
    TORCH_CHECK(x->scalar_type() == torch::kFloat32, "inputs must be f32");
  if (!(q.stride(2) == 1 && q.stride(1) == d)) q = q.contiguous();
  const c10::cuda::CUDAGuard guard(q.device());
  const auto k = keys.contiguous(), m = mask.contiguous();
  const auto w1c = w1.contiguous(), b1c = b1.contiguous();
  const auto w2c = w2.contiguous(), b2c = b2.contiguous();
  const auto w3c = w3.contiguous(), b3c = b3.contiguous();
  auto out = torch::empty({bsz, n, d}, q.options());
  if (bsz == 0 || n == 0) return out;
  const int ti = as_int(t, "T"), di = as_int(d, "d");
  const int h1i = as_int(h1, "h1"), h2i = as_int(h2, "h2");
  const int err = target_attention_launch(
      q.data_ptr<float>(), q.stride(0), k.data_ptr<float>(),
      m.data_ptr<float>(), w1c.data_ptr<float>(), b1c.data_ptr<float>(),
      w2c.data_ptr<float>(), b2c.data_ptr<float>(), w3c.data_ptr<float>(),
      b3c.data_ptr<float>(), out.data_ptr<float>(), as_int(bsz, "B"),
      as_int(n, "N"), ti, di, h1i, h2i, stream());
  TORCH_CHECK(err == 0, "target_attention kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)),
              " (shared memory ",
              num(target_attention_smem_bytes(ti, di, h1i, h2i)),
              " bytes)");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

// (B, L) bags into a (V, D) table -> (B, D) sums, weighted when weights
// is given.  Any D and L; the table is read through its row stride (a
// table whose columns are not contiguous is copied first).
torch::Tensor embedding_bag(const torch::Tensor& table,
                            const torch::Tensor& ids,
                            const std::optional<torch::Tensor>& weights) {
  if (weights)
    same_device("embedding_bag", table, {&ids, &*weights});
  else
    same_device("embedding_bag", table, {&ids});
  TORCH_CHECK(table.dim() == 2 && ids.dim() == 2,
              "want table (V, D), ids (B, L)");
  TORCH_CHECK(table.scalar_type() == torch::kFloat32, "table must be f32");
  const int64_t d = table.size(1);
  const c10::cuda::CUDAGuard guard(table.device());
  torch::Tensor w;
  if (weights) {
    TORCH_CHECK(weights->sizes() == ids.sizes() &&
                    weights->scalar_type() == torch::kFloat32,
                "weights must be f32 and shaped like ids");
    w = weights->contiguous();
  }
  const auto tab = table.stride(1) == 1 ? table : table.contiguous();
  const auto i = ids.to(torch::kInt32).contiguous();
  const int b = as_int(ids.size(0), "B");
  auto out = torch::empty({b, d}, table.options());
  if (out.numel() == 0) return out;
  check_launch(embedding_bag_launch(tab.data_ptr<float>(), tab.stride(0),
                                    i.data_ptr<int>(),
                                    weights ? w.data_ptr<float>() : nullptr,
                                    out.data_ptr<float>(), b, as_int(d, "D"),
                                    as_int(ids.size(1), "L"), stream()),
               "embedding_bag");
  return out;
}

// The backward of target_attention: dout (B, N, d) and the forward's
// inputs -> [dq (B, N, d), dkeys (B, T, d), dW1, db1, dW2, db2, dW3, db3]
// shaped like their inputs.  The weight gradients are views of one
// (nW,) buffer the kernels write.
std::vector<torch::Tensor> target_attention_bwd(
    const torch::Tensor& dout, const torch::Tensor& q,
    const torch::Tensor& keys, const torch::Tensor& mask,
    const torch::Tensor& w1, const torch::Tensor& b1, const torch::Tensor& w2,
    const torch::Tensor& b2, const torch::Tensor& w3,
    const torch::Tensor& b3) {
  same_device("target_attention_bwd", dout, {&q, &keys, &mask, &w1, &b1, &w2,
                                             &b2, &w3, &b3});
  TORCH_CHECK(q.dim() == 3 && keys.dim() == 3 && mask.dim() == 2 &&
                  dout.sizes() == q.sizes(),
              "want dout and q (B, N, d), keys (B, T, d), mask (B, T)");
  const int64_t bsz = q.size(0), n = q.size(1), d = q.size(2);
  const int64_t t = keys.size(1);
  TORCH_CHECK(keys.size(0) == bsz && keys.size(2) == d &&
                  mask.size(0) == bsz && mask.size(1) == t,
              "keys/mask shapes do not match q");
  TORCH_CHECK(w1.dim() == 2 && w2.dim() == 2, "W1 and W2 must be matrices");
  const int64_t h1 = w1.size(1), h2 = w2.size(1);
  TORCH_CHECK(w1.size(0) == 4 * d && b1.numel() == h1 && w2.size(0) == h1 &&
                  b2.numel() == h2 && w3.numel() == h2 && b3.numel() == 1,
              "attention MLP weights must be (4d, h1), (h1, h2), (h2, 1) "
              "with matching biases");
  TORCH_CHECK(d <= 64 && h1 <= 128 && h2 <= 64,
              "the kernel supports d <= 64, h1 <= 128 and h2 <= 64, got d = ",
              num(d), ", h1 = ", num(h1), ", h2 = ", num(h2));
  for (const torch::Tensor* x : std::initializer_list<const torch::Tensor*>{
           &dout, &q, &keys, &mask, &w1, &b1, &w2, &b2, &w3, &b3})
    TORCH_CHECK(x->scalar_type() == torch::kFloat32, "inputs must be f32");
  const c10::cuda::CUDAGuard guard(q.device());
  const auto g = dout.contiguous(), qc = q.contiguous();
  const auto k = keys.contiguous(), m = mask.contiguous();
  const auto w1c = w1.contiguous(), b1c = b1.contiguous();
  const auto w2c = w2.contiguous(), b2c = b2.contiguous();
  const auto w3c = w3.contiguous(), b3c = b3.contiguous();
  const int bi = as_int(bsz, "B"), di = as_int(d, "d");
  const int h1i = as_int(h1, "h1"), h2i = as_int(h2, "h2");
  const int64_t n_w = 4 * d * h1 + h1 + h1 * h2 + 2 * h2 + 1;
  auto dq = torch::empty({bsz, n, d}, q.options());
  auto dk = torch::empty({bsz, t, d}, q.options());
  torch::Tensor dw;
  if (bsz == 0 || n == 0) {
    dq.zero_();
    dk.zero_();
    dw = torch::zeros({n_w}, q.options());
  } else {
    as_int(bsz * n * d, "B*N*d");
    as_int(bsz * t, "B*T");
    auto scratch = torch::empty(
        {target_attention_bwd_scratch_floats(bi, as_int(n, "N"), di, h1i,
                                             h2i)},
        q.options());
    dw = torch::empty({n_w}, q.options());
    check_launch(
        target_attention_bwd_launch(
            g.data_ptr<float>(), qc.data_ptr<float>(), k.data_ptr<float>(),
            m.data_ptr<float>(), w1c.data_ptr<float>(),
            b1c.data_ptr<float>(), w2c.data_ptr<float>(),
            b2c.data_ptr<float>(), w3c.data_ptr<float>(),
            b3c.data_ptr<float>(), dq.data_ptr<float>(), dk.data_ptr<float>(),
            dw.data_ptr<float>(), scratch.data_ptr<float>(), bi,
            as_int(n, "N"), as_int(t, "T"), di, h1i, h2i, stream()),
        "target_attention_bwd");
  }
  std::vector<torch::Tensor> out{dq, dk};
  int64_t o = 0;
  for (const torch::Tensor* like : {&w1, &b1, &w2, &b2, &w3, &b3}) {
    out.push_back(dw.narrow(0, o, like->numel()).view(like->sizes()));
    o += like->numel();
  }
  return out;
}

// The backward of embedding_bag into the table: dout (B, D), ids (B, L)
// int32 or int64, weights (B, L) or none -> the dense (V, D) gradient.
// The kernels order the ids themselves (a counting sort by row, in flat
// order within a row) and write every row, so nothing runs on the device
// but their two launches: the gradient and their int32 scratch are one
// torch::empty, the scratch after the (V, D) rows (from a 16-byte
// boundary).
torch::Tensor embedding_bag_bwd(const torch::Tensor& dout,
                                const torch::Tensor& ids,
                                const std::optional<torch::Tensor>& weights,
                                int64_t num_rows) {
  if (weights)
    same_device("embedding_bag_bwd", dout, {&ids, &*weights});
  else
    same_device("embedding_bag_bwd", dout, {&ids});
  TORCH_CHECK(dout.dim() == 2 && ids.dim() == 2 &&
                  ids.size(0) == dout.size(0),
              "want dout (B, D) and ids (B, L)");
  TORCH_CHECK(dout.scalar_type() == torch::kFloat32, "dout must be f32");
  TORCH_CHECK(ids.scalar_type() == torch::kInt32 ||
                  ids.scalar_type() == torch::kInt64,
              "ids must be int32 or int64");
  TORCH_CHECK(num_rows >= 0, "the table's row count must be >= 0");
  const c10::cuda::CUDAGuard guard(dout.device());
  const int64_t d = dout.size(1), l = ids.size(1);
  const int64_t n = ids.numel();
  if (n == 0 || d == 0 || num_rows == 0)
    return torch::zeros({num_rows, d}, dout.options());
  torch::Tensor w;
  if (weights) {
    TORCH_CHECK(weights->sizes() == ids.sizes() &&
                    weights->scalar_type() == torch::kFloat32,
                "weights must be f32 and shaped like ids");
    w = weights->contiguous();
  }
  const auto i = ids.contiguous();
  const auto g = dout.contiguous();
  const int64_t cells = num_rows * d;
  const int64_t at = (cells + 3) / 4 * 4;  // the scratch, 16-byte aligned
  auto buf = torch::empty({at + embedding_bag_bwd_scratch_ints(n, num_rows)},
                          dout.options());
  auto out = buf.narrow(0, 0, cells).view({num_rows, d});
  check_launch(embedding_bag_bwd_launch(
                   i.data_ptr(), i.scalar_type() == torch::kInt64 ? 1 : 0,
                   weights ? w.data_ptr<float>() : nullptr,
                   g.data_ptr<float>(), out.data_ptr<float>(),
                   reinterpret_cast<int*>(buf.data_ptr<float>() + at), n,
                   as_int(d, "D"), as_int(l, "L"), num_rows, stream()),
               "embedding_bag_bwd");
  return out;
}

// (B, F, D) f32 or bf16 -> (B, F(F-1)/2) strictly-lower-triangle dots in
// the same type (bf16 goes to the kernel as raw 16-bit words).
torch::Tensor dot_interact(const torch::Tensor& feats) {
  same_device("dot_interact", feats, {});
  TORCH_CHECK(feats.dim() == 3, "want feats (B, F, D)");
  const auto dt = feats.scalar_type();
  TORCH_CHECK(dt == torch::kFloat32 || dt == torch::kBFloat16,
              "feats must be f32 or bf16");
  const c10::cuda::CUDAGuard guard(feats.device());
  const auto x = feats.contiguous();
  const int b = as_int(x.size(0), "B"), f = as_int(x.size(1), "F");
  const int d = as_int(x.size(2), "D");
  auto out = torch::empty({b, static_cast<int64_t>(f) * (f - 1) / 2},
                          x.options());
  if (out.numel() == 0) return out;
  check_launch(dot_interact_launch(x.data_ptr(), out.data_ptr(), b, f, d,
                                   dt == torch::kBFloat16, stream()),
               "dot_interact");
  return out;
}

// The scratch a launcher asks for: f32 tensors like `like`, held until
// the binding returns (the caching allocator keeps them for the stream's
// work).  An allocation's exception is kept and raised after the launcher
// returns, since it must not unwind through the launcher's C frames.
struct Scratch {
  at::TensorOptions like;
  std::vector<torch::Tensor> held;
  std::exception_ptr error;
};

float* scratch_floats(long long n, void* ctx) {
  auto* s = static_cast<Scratch*>(ctx);
  try {
    s->held.push_back(torch::empty({n}, s->like));
    return s->held.back().data_ptr<float>();
  } catch (...) {
    s->error = std::current_exception();
    return nullptr;
  }
}

// w (H_out, Hp*m), x_prev (B, Hp, D), x0 (B, m, D), f32 -> (B, H_out, D).
// The kernel's scratch (w's TF32 halves and, when its plan cuts K into
// parts, the partial outputs) comes from scratch_floats.
torch::Tensor cin_layer(const torch::Tensor& w, const torch::Tensor& x_prev,
                        const torch::Tensor& x0) {
  same_device("cin_layer", w, {&x_prev, &x0});
  TORCH_CHECK(w.dim() == 2 && x_prev.dim() == 3 && x0.dim() == 3,
              "want w (H_out, Hp*m), x_prev (B, Hp, D), x0 (B, m, D)");
  const int64_t bsz = x_prev.size(0), hp = x_prev.size(1);
  const int64_t d = x_prev.size(2), m = x0.size(1), ho = w.size(0);
  TORCH_CHECK(x0.size(0) == bsz && x0.size(2) == d,
              "x0 must be (B, m, D) like x_prev");
  TORCH_CHECK(w.size(1) == hp * m, "w must have Hp*m = ", num(hp * m),
              " columns, got ", num(w.size(1)));
  for (const torch::Tensor* t : {&w, &x_prev, &x0})
    TORCH_CHECK(t->scalar_type() == torch::kFloat32, "inputs must be f32");
  const c10::cuda::CUDAGuard guard(w.device());
  const auto wc = w.contiguous(), xp = x_prev.contiguous();
  const auto xz = x0.contiguous();
  auto out = torch::empty({bsz, ho, d}, xp.options());
  if (out.numel() == 0) return out;
  if (hp * m == 0) return out.zero_();
  as_int(hp * m, "Hp*m");
  as_int(bsz * d, "B*D");
  const int bi = as_int(bsz, "B"), hpi = as_int(hp, "Hp");
  const int mi = as_int(m, "m"), di = as_int(d, "D");
  const int hoi = as_int(ho, "H_out");
  Scratch scratch{xp.options(), {}, nullptr};
  const int err = cin_layer_launch(
      wc.data_ptr<float>(), xp.data_ptr<float>(), xz.data_ptr<float>(),
      out.data_ptr<float>(), bi, hpi, mi, di, hoi, scratch_floats, &scratch,
      stream());
  if (scratch.error) std::rethrow_exception(scratch.error);
  check_tma_launch(err, "cin_layer");
  return out;
}

namespace {

// The checks both flash kernels share: q (B, T, H, dh), k and v (B, S,
// Hkv, dh) of dtype dt on one device, dh contiguous (copied where not).
struct Attention {
  torch::Tensor q, k, v;
  int64_t b, t, h, dh, s, hk;
};

Attention attention_args(const char* what, torch::Tensor q, torch::Tensor k,
                         torch::Tensor v, at::ScalarType dt) {
  same_device(what, q, {&k, &v});
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && k.sizes() == v.sizes(), what,
              ": want q (B, T, H, dh) and k, v (B, S, Hkv, dh)");
  Attention a{q, k, v, q.size(0), q.size(1), q.size(2),
              q.size(3), k.size(1), k.size(2)};
  TORCH_CHECK(k.size(0) == a.b && k.size(3) == a.dh, what,
              ": k and v must share q's batch and head width");
  TORCH_CHECK(a.hk >= 1 && a.h % a.hk == 0, what, ": H = ", num(a.h),
              " must be a multiple of Hkv = ", num(a.hk));
  TORCH_CHECK(a.b <= 65535 && a.h <= 65535, what,
              ": B and H must be <= 65535");
  TORCH_CHECK(q.scalar_type() == dt && k.scalar_type() == dt &&
                  v.scalar_type() == dt,
              what, ": q, k and v must all be ", dt);
  if (q.stride(3) != 1) a.q = q.contiguous();
  if (k.stride(3) != 1) a.k = k.contiguous();
  if (v.stride(3) != 1) a.v = v.contiguous();
  return a;
}

// (b, t, h) strides of q, (b, s, h) of k and of v, (b, t, h) of out.
void attention_strides(const Attention& a, const torch::Tensor& out,
                       long long* st) {
  const torch::Tensor* ts[4] = {&a.q, &a.k, &a.v, &out};
  for (int i = 0; i < 4; ++i)
    for (int d = 0; d < 3; ++d) st[3 * i + d] = ts[i]->stride(d);
}

int clamp_window(int64_t window) {
  return static_cast<int>(
      std::max<int64_t>(-1, std::min<int64_t>(window, INT32_MAX)));
}

}  // namespace

// q (B, T, H, dh), k/v (B, S, Hkv, dh), f32 -> (B, T, H, dh) f32, the
// products as 3xTF32 on the tensor cores (mma.sync).  Read through their
// strides (only dh must be contiguous; cp.async copies 4 bytes at a time
// where 16 do not fit the strides); softcap <= 0 means none, window <= 0
// global.
torch::Tensor flash_attention(torch::Tensor q, torch::Tensor k,
                              torch::Tensor v, bool causal, int64_t window,
                              double softcap, double scale) {
  const Attention a =
      attention_args("flash_attention", q, k, v, torch::kFloat32);
  TORCH_CHECK(a.dh >= 1 && a.dh <= 256,
              "flash_attention: the kernel supports 1 <= dh <= 256");
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty({a.b, a.t, a.h, a.dh}, q.options());
  if (out.numel() == 0) return out;
  long long strides[12];
  attention_strides(a, out, strides);
  check_launch(
      flash_attention_launch(a.q.data_ptr(), a.k.data_ptr(), a.v.data_ptr(),
                             out.data_ptr(), strides, as_int(a.b, "B"),
                             as_int(a.t, "T"), as_int(a.s, "S"),
                             as_int(a.h, "H"), as_int(a.hk, "Hkv"),
                             as_int(a.dh, "dh"), causal, clamp_window(window),
                             static_cast<float>(scale),
                             static_cast<float>(softcap), stream()),
      "flash_attention");
  return out;
}

// The same function in bf16, on the tensor cores with TMA loads.  TMA
// reads q, k and v through their strides, so it needs base pointers
// aligned to 16 bytes, strides (of dimensions longer than 1) that are
// multiples of 16 bytes, and dh a multiple of 8 up to 256.
torch::Tensor flash_attention_wgmma(torch::Tensor q, torch::Tensor k,
                                    torch::Tensor v, bool causal,
                                    int64_t window, double softcap,
                                    double scale) {
  const char* what = "flash_attention_wgmma";
  const Attention a = attention_args(what, q, k, v, torch::kBFloat16);
  TORCH_CHECK(a.dh >= 8 && a.dh <= 256 && a.dh % 8 == 0, what,
              ": TMA needs dh a multiple of 8 in [8, 256], got ", num(a.dh));
  for (const torch::Tensor* x : {&a.q, &a.k, &a.v}) {
    TORCH_CHECK(reinterpret_cast<uintptr_t>(x->data_ptr()) % 16 == 0, what,
                ": TMA needs base pointers aligned to 16 bytes");
    for (int d = 0; d < 3; ++d)
      TORCH_CHECK(x->size(d) == 1 || x->stride(d) % 8 == 0, what,
                  ": TMA needs strides that are multiples of 16 bytes, got "
                  "stride ", num(x->stride(d)), " of dim ", num(d));
  }
  const c10::cuda::CUDAGuard guard(q.device());
  auto out = torch::empty({a.b, a.t, a.h, a.dh}, q.options());
  if (out.numel() == 0) return out;
  long long strides[12];
  attention_strides(a, out, strides);
  const int err = flash_attention_wgmma_launch(
      a.q.data_ptr(), a.k.data_ptr(), a.v.data_ptr(), out.data_ptr(),
      strides, as_int(a.b, "B"), as_int(a.t, "T"), as_int(a.s, "S"),
      as_int(a.h, "H"), as_int(a.hk, "Hkv"), as_int(a.dh, "dh"), causal,
      clamp_window(window), static_cast<float>(scale),
      static_cast<float>(softcap), stream());
  check_tma_launch(err, what);
  return out;
}

// The backward of dot_interact: dout (B, F(F-1)/2) and feats (B, F, D),
// both f32 or both bf16 -> dfeats (B, F, D) in that dtype.
torch::Tensor dot_interact_bwd(const torch::Tensor& dout,
                               const torch::Tensor& feats) {
  same_device("dot_interact_bwd", feats, {&dout});
  TORCH_CHECK(feats.dim() == 3 && dout.dim() == 2,
              "want dout (B, F(F-1)/2) and feats (B, F, D)");
  const int64_t bsz = feats.size(0), f = feats.size(1), d = feats.size(2);
  TORCH_CHECK(dout.size(0) == bsz && dout.size(1) == f * (f - 1) / 2,
              "dout must be (B, F(F-1)/2) for feats' B and F");
  const auto dt = feats.scalar_type();
  TORCH_CHECK((dt == torch::kFloat32 || dt == torch::kBFloat16) &&
                  dout.scalar_type() == dt,
              "dout and feats must both be f32 or both bf16");
  const c10::cuda::CUDAGuard guard(feats.device());
  const auto x = feats.contiguous(), g = dout.contiguous();
  auto out = torch::empty({bsz, f, d}, x.options());
  if (out.numel() == 0) return out;
  check_launch(dot_interact_bwd_launch(g.data_ptr(), x.data_ptr(),
                                       out.data_ptr(), as_int(bsz, "B"),
                                       as_int(f, "F"), as_int(d, "D"),
                                       dt == torch::kBFloat16, stream()),
               "dot_interact_bwd");
  return out;
}

// The backward of cin_layer: dz (B, H_out, D) and the forward's w
// (H_out, Hp*m), x_prev (B, Hp, D), x0 (B, m, D), f32 -> [dw, dx_prev,
// dx0] shaped like their inputs.  The kernel's scratch (its layout
// pre-passes' copies and dw's part slabs) is one f32 tensor.
std::vector<torch::Tensor> cin_layer_bwd(const torch::Tensor& dz,
                                         const torch::Tensor& w,
                                         const torch::Tensor& x_prev,
                                         const torch::Tensor& x0) {
  same_device("cin_layer_bwd", w, {&dz, &x_prev, &x0});
  TORCH_CHECK(w.dim() == 2 && x_prev.dim() == 3 && x0.dim() == 3 &&
                  dz.dim() == 3,
              "want dz (B, H_out, D), w (H_out, Hp*m), x_prev (B, Hp, D), "
              "x0 (B, m, D)");
  const int64_t bsz = x_prev.size(0), hp = x_prev.size(1);
  const int64_t d = x_prev.size(2), m = x0.size(1), ho = w.size(0);
  TORCH_CHECK(x0.size(0) == bsz && x0.size(2) == d,
              "x0 must be (B, m, D) like x_prev");
  TORCH_CHECK(w.size(1) == hp * m, "w must have Hp*m = ", num(hp * m),
              " columns, got ", num(w.size(1)));
  TORCH_CHECK(dz.size(0) == bsz && dz.size(1) == ho && dz.size(2) == d,
              "dz must be (B, H_out, D)");
  for (const torch::Tensor* t : {&dz, &w, &x_prev, &x0})
    TORCH_CHECK(t->scalar_type() == torch::kFloat32, "inputs must be f32");
  TORCH_CHECK(m <= 64, "cin_layer_bwd supports m <= 64, got ", num(m));
  TORCH_CHECK(ho <= 256, "cin_layer_bwd supports H_out <= 256, got ",
              num(ho));
  const c10::cuda::CUDAGuard guard(w.device());
  const auto wc = w.contiguous(), xp = x_prev.contiguous();
  const auto xz = x0.contiguous(), g = dz.contiguous();
  auto dw = torch::zeros({ho, hp * m}, wc.options());
  auto dxp = torch::zeros({bsz, hp, d}, xp.options());
  auto dx0 = torch::zeros({bsz, m, d}, xz.options());
  if (bsz == 0 || d == 0 || ho == 0 || hp == 0 || m == 0)
    return {dw, dxp, dx0};
  as_int(bsz * d * std::max({hp, ho, m}), "B*D*max(Hp, H_out, m)");
  as_int(ho * hp * m, "H_out*Hp*m");
  const int bi = as_int(bsz, "B"), hpi = as_int(hp, "Hp");
  const int mi = as_int(m, "m"), di = as_int(d, "D");
  const int hoi = as_int(ho, "H_out");
  const long long n_scratch =
      cin_layer_bwd_scratch_floats(bi, hpi, mi, di, hoi);
  auto scratch = torch::empty({std::max<long long>(n_scratch, 1)},
                              wc.options());
  check_tma_launch(cin_layer_bwd_launch(
                       wc.data_ptr<float>(), xp.data_ptr<float>(),
                       xz.data_ptr<float>(), g.data_ptr<float>(),
                       dw.data_ptr<float>(), dxp.data_ptr<float>(),
                       dx0.data_ptr<float>(), scratch.data_ptr<float>(), bi,
                       hpi, mi, di, hoi, stream()),
                   "cin_layer_bwd");
  return {dw, dxp, dx0};
}

// The backward of both flash kernels: dout and the forward's output
// (B, T, H, dh), q (B, T, H, dh), k and v (B, S, Hkv, dh), all f32 or all
// bf16 -> [dq, dk, dv] in that dtype.  Inputs are made contiguous; the
// rows' log-sum-exp and D are f32 scratch.  bf16 loads by TMA, so it
// needs dh a multiple of 8.
std::vector<torch::Tensor> flash_attention_bwd(
    const torch::Tensor& dout, const torch::Tensor& q, const torch::Tensor& k,
    const torch::Tensor& v, const torch::Tensor& out, bool causal,
    int64_t window, double softcap, double scale) {
  const char* what = "flash_attention_bwd";
  same_device(what, q, {&k, &v, &dout, &out});
  const auto dt = q.scalar_type();
  TORCH_CHECK(dt == torch::kFloat32 || dt == torch::kBFloat16, what,
              ": inputs must be f32 or bf16");
  const Attention a = attention_args(what, q, k, v, dt);
  TORCH_CHECK(dout.sizes() == q.sizes() && out.sizes() == q.sizes() &&
                  dout.scalar_type() == dt && out.scalar_type() == dt,
              what, ": dout and out must be shaped and typed like q");
  TORCH_CHECK(a.dh >= 1 && a.dh <= 256, what,
              ": the kernel supports 1 <= dh <= 256");
  TORCH_CHECK(dt == torch::kFloat32 || a.dh % 8 == 0, what,
              ": the bf16 kernels load by TMA, which needs dh a multiple of "
              "8, got ", num(a.dh));
  const c10::cuda::CUDAGuard guard(q.device());
  // contiguous, from a 16-byte boundary (the bf16 kernels' TMA loads need
  // it)
  const auto dense = [](const torch::Tensor& t) {
    auto c = t.contiguous();
    return reinterpret_cast<uintptr_t>(c.data_ptr()) % 16 ? c.clone() : c;
  };
  const auto qc = dense(a.q), kc = dense(a.k), vc = dense(a.v);
  const auto oc = dense(out), gc = dense(dout);
  auto dq = torch::empty(qc.sizes(), qc.options());
  auto dk = torch::empty(kc.sizes(), kc.options());
  auto dv = torch::empty(vc.sizes(), vc.options());
  if (a.b == 0 || a.h == 0 || a.dh == 0 || a.t == 0 || a.s == 0) {
    dq.zero_();
    dk.zero_();
    dv.zero_();
    return {dq, dk, dv};
  }
  as_int(a.b * a.t * a.h * a.dh, "B*T*H*dh");
  as_int(a.b * a.s * a.hk * a.dh, "B*S*Hkv*dh");
  const int bi = as_int(a.b, "B"), ti = as_int(a.t, "T");
  const int si = as_int(a.s, "S"), hi = as_int(a.h, "H");
  const int hki = as_int(a.hk, "Hkv"), dhi = as_int(a.dh, "dh");
  const int bf16 = dt == torch::kBFloat16;
  auto scratch = torch::empty({2 * a.b * a.h * a.t},
                              qc.options().dtype(torch::kFloat32));
  check_tma_launch(
      flash_attention_bwd_launch(
          qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), oc.data_ptr(),
          gc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
          scratch.data_ptr<float>(), bi, ti, si, hi, hki, dhi, causal,
          clamp_window(window), static_cast<float>(scale),
          static_cast<float>(softcap), bf16, stream()),
      what);
  return {dq, dk, dv};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("cascade_truncate", &cascade_truncate,
        "CompactPlan truncation: (B,) revenue@expose");
  m.def("target_attention", &target_attention,
        "DIN target attention, candidate form");
  m.def("embedding_bag", &embedding_bag,
        "(weighted) embedding bag sums");
  m.def("target_attention_bwd", &target_attention_bwd,
        "DIN target attention's backward: dq, dkeys and the MLP's grads");
  m.def("embedding_bag_bwd", &embedding_bag_bwd,
        "embedding bag's backward: the dense (V, D) table gradient");
  m.def("dot_interact", &dot_interact,
        "DLRM dot interaction: strictly-lower-triangle pairwise dots");
  m.def("cin_layer", &cin_layer, "xDeepFM CIN layer");
  m.def("flash_attention", &flash_attention,
        "causal / GQA / sliding-window / softcap flash attention, f32 "
        "(3xTF32 on the tensor cores)");
  m.def("flash_attention_wgmma", &flash_attention_wgmma,
        "the same in bf16 on the tensor cores (wgmma, TMA)");
  m.def("dot_interact_bwd", &dot_interact_bwd,
        "DLRM dot interaction's backward: dfeats = (G + G^T) X");
  m.def("cin_layer_bwd", &cin_layer_bwd,
        "xDeepFM CIN layer's backward: dw, dx_prev, dx0");
  m.def("flash_attention_bwd", &flash_attention_bwd,
        "flash attention's backward (f32 or bf16): dq, dk, dv");
}
