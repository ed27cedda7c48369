// DLRM dot interaction: the backward pass.  dout (B, F(F-1)/2), the
// gradient of the strictly-lower-triangle dots in the order of
// np.tril_indices(F, k=-1), and feats (B, F, D) -> dfeats (B, F, D):
//
//   dfeats[b] = (G + G^T) X[b],   G[i][j] = dout[b, i(i-1)/2 + j], i > j,
//
// summed in f32 and written in the input's dtype (f32 or bf16).
//
// Stands for jax.grad of the DLRM interaction oracle
// (src/repro/models/recsys/dlrm.py:99, dot_interact), which the JAX
// package differentiates as a plain einsum and gather; the Pallas kernel
// src/repro/kernels/dot_interact.py has no backward.
//
// Bound: bytes.  A sample reads F D inputs and F(F-1)/2 gradients and
// writes F D values for 2 F^2 D flops: at DLRM-RM2's widths (F = 27,
// D = 64, bf16) 7.6 kB moved for 93 kflops, 12 flops a byte, far below
// the ~295 at which the card turns from bytes to operations.
//
// Design (simple first): a block of 128 threads takes one sample at a
// time (a grid-stride loop over samples, up to 16 blocks an SM).  It
// stages X as f32 and the symmetric G + G^T (zero diagonal) in shared
// memory, then each thread owns outputs (i, d..d+3) (one float4 of X a
// step of j, where D is a multiple of 4; else (i, d)), consecutive
// threads consecutive d, and sums G[i][j] X[j][d] over j = 0 .. F-1 in
// that order: one fmaf chain an output, so the result is bitwise
// repeatable and no atomics are used.
//
// Limits: one sample's F D + F F floats must fit a block's shared
// memory (227 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 16;
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int V>
__device__ __forceinline__ void load_row(float* out, const float* p);
template <>
__device__ __forceinline__ void load_row<1>(float* out, const float* p) {
  out[0] = *p;
}
template <>
__device__ __forceinline__ void load_row<4>(float* out, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// V outputs of row i a thread (V = 4: a float4 of X a step of j, when D
// is a multiple of 4; else 1)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    dot_interact_bwd_kernel(const T* __restrict__ dout,
                            const T* __restrict__ feats,
                            T* __restrict__ dfeats, int B, int F, int D) {
  extern __shared__ __align__(16) float smem[];
  float* x = smem;           // F x D
  float* g = smem + F * D;   // F x F, G + G^T
  const int fd = F * D, dv = D / V;
  const long long pairs = static_cast<long long>(F) * (F - 1) / 2;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const T* xb = feats + static_cast<long long>(b) * fd;
    const T* gb = dout + static_cast<long long>(b) * pairs;
    for (int i = threadIdx.x; i < fd; i += kThreads) x[i] = to_f32(xb[i]);
    for (int e = threadIdx.x; e < F * F; e += kThreads) {
      const int i = e / F, j = e % F;
      float val = 0.f;
      if (i > j)
        val = to_f32(gb[i * (i - 1) / 2 + j]);
      else if (i < j)
        val = to_f32(gb[j * (j - 1) / 2 + i]);
      g[e] = val;
    }
    __syncthreads();
    T* ob = dfeats + static_cast<long long>(b) * fd;
    for (int e = threadIdx.x; e < F * dv; e += kThreads) {
      const int i = e / dv, d = (e % dv) * V;
      const float* gi = g + i * F;
      float acc[V] = {};
      for (int j = 0; j < F; ++j) {
        const float gij = gi[j];
        float xv[V];
        load_row<V>(xv, x + j * D + d);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(gij, xv[v], acc[v]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) ob[i * D + d + v] = from_f32<T>(acc[v]);
    }
    __syncthreads();  // the next sample overwrites x and g
  }
}

template <typename T>
int launch(const void* dout, const void* feats, void* dfeats, int B, int F,
           int D, cudaStream_t s) {
  const long long bytes =
      (static_cast<long long>(F) * D + static_cast<long long>(F) * F) * 4;
  if (bytes > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = D % 4 ? dot_interact_bwd_kernel<T, 1>
                     : dot_interact_bwd_kernel<T, 4>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = B < sms * kBlocksPerSm ? B : sms * kBlocksPerSm;
  kernel<<<grid, kThreads, bytes, s>>>(static_cast<const T*>(dout),
                                       static_cast<const T*>(feats),
                                       static_cast<T*>(dfeats), B, F, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dout (B, F(F-1)/2), feats and dfeats (B, F, D), contiguous, f32 or
// (bf16 != 0) bf16.  Requires B, F, D > 0.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue when a sample does not fit
// shared memory.
extern "C" int dot_interact_bwd_launch(const void* dout, const void* feats,
                                       void* dfeats, int B, int F, int D,
                                       int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(dout, feats, dfeats, B, F, D, s)
              : launch<float>(dout, feats, dfeats, B, F, D, s);
}
