// DIN target attention, candidate form.
//
// Replaces the Pallas kernel src/repro/kernels/target_attention.py
// (target_attention), the attention pool of models/recsys/din.py.
//
//   q (B, N, d) candidates, keys (B, T, d) + mask (B, T) per user,
//   feat = [q, k, q-k, q*k] -> sigmoid(feat W1 + b1) -> sigmoid(. W2 + b2)
//        -> . W3 + b3 = w,   out[b, n] = sum_t w * mask[b, t] * keys[b, t]
//
// The TPU kernel took one query per row (N = 1) and DIN's score
// broadcast every user's history to all N candidates, a (B, N, T, d)
// tensor.  Here a block serves one user and 128 of its candidates: the
// user's keys and mask, and the whole attention MLP, are staged once in
// shared memory, and each thread walks the history for ITS candidate,
// so neither the broadcast keys nor the (B, N, T, 4d) features ever
// exist in device memory.  The MLP runs in the kernel's own body on the
// CUDA cores in f32: W1 in chunks of 8 hidden units held in registers
// (float4 broadcast reads of the weights), each chunk's sigmoid folded
// straight into the second layer's accumulators.  History steps whose
// mask is exactly 0 add 0 * key and are skipped (uniform per block).
//
// Bound: operations.  Per unmasked (candidate, step) this kernel does
// 2 * (4d * h1 + h1 * h2 + h2 + d) flops against a few bytes of input.
// The function needs fewer: W1's four (d, h1) row blocks split feat W1
// into a candidate-only term, a key-only term and (q*k) W1_qk, so per
// (candidate, step) only d + 2d * h1 + 2 * h1 flops of the first layer
// remain (about 12.5k flops per step in all at d = 36, h1 = 80,
// h2 = 40, against about 29.7k here).  That split is left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // candidates per block
constexpr int kJ = 8;          // hidden units of W1 per register chunk
constexpr int kH2Max = 64;     // second hidden layer width, padded to 4

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads)
    target_attention_kernel(const float* __restrict__ q,
                            long long q_bstride,
                            const float* __restrict__ keys,
                            const float* __restrict__ mask,
                            const float* __restrict__ w1,
                            const float* __restrict__ b1,
                            const float* __restrict__ w2,
                            const float* __restrict__ b2,
                            const float* __restrict__ w3,
                            const float* __restrict__ b3,
                            float* __restrict__ out, int N, int n_blocks,
                            int T, int d, int h1, int h2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h1p = (h1 + kJ - 1) / kJ * kJ;
  const int h2p = (h2 + 3) / 4 * 4;
  float* w1_s = smem;                   // (4d, h1p), zero-padded columns
  float* w2_s = w1_s + 4 * d * h1p;     // (h1p, h2p), zero-padded
  float* b1_s = w2_s + h1p * h2p;       // (h1p,)
  float* b2_s = b1_s + h1p;             // (h2p,)
  float* w3_s = b2_s + h2p;             // (h2p,)
  float* keys_s = w3_s + h2p;           // (T, d)
  float* mask_s = keys_s + T * d;       // (T,)
  float* q_s = mask_s + T;              // (d, kThreads), transposed
  float* pool_s = q_s + d * kThreads;   // (d, kThreads), transposed

  const int b = blockIdx.x / n_blocks;
  const int n0 = (blockIdx.x % n_blocks) * kThreads;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < 4 * d * h1p; idx += kThreads) {
    const int f = idx / h1p, j = idx % h1p;
    w1_s[idx] = j < h1 ? w1[f * h1 + j] : 0.f;
  }
  for (int idx = tid; idx < h1p * h2p; idx += kThreads) {
    const int j = idx / h2p, k = idx % h2p;
    w2_s[idx] = (j < h1 && k < h2) ? w2[j * h2 + k] : 0.f;
  }
  for (int j = tid; j < h1p; j += kThreads) b1_s[j] = j < h1 ? b1[j] : 0.f;
  for (int k = tid; k < h2p; k += kThreads) {
    b2_s[k] = k < h2 ? b2[k] : 0.f;
    w3_s[k] = k < h2 ? w3[k] : 0.f;
  }
  const float* kb = keys + static_cast<long long>(b) * T * d;
  for (int idx = tid; idx < T * d; idx += kThreads) keys_s[idx] = kb[idx];
  for (int t = tid; t < T; t += kThreads)
    mask_s[t] = mask[static_cast<long long>(b) * T + t];
  const float* qb = q + b * q_bstride;
  for (int idx = tid; idx < kThreads * d; idx += kThreads) {
    const int nn = idx / d, i = idx % d;
    const int n = n0 + nn;
    q_s[i * kThreads + nn] =
        n < N ? qb[static_cast<long long>(n) * d + i] : 0.f;
    pool_s[i * kThreads + nn] = 0.f;
  }
  const float bias3 = b3[0];
  __syncthreads();

  float h2acc[kH2Max];
  for (int t = 0; t < T; ++t) {
    const float mt = mask_s[t];
    if (mt == 0.f) continue;  // adds 0 * key; same for the whole block
    const float* kt = keys_s + t * d;
#pragma unroll
    for (int k = 0; k < kH2Max; ++k)
      if (k < h2p) h2acc[k] = b2_s[k];
    for (int jc = 0; jc < h1p; jc += kJ) {
      float a[kJ];
#pragma unroll
      for (int u = 0; u < kJ; ++u) a[u] = b1_s[jc + u];
      for (int i = 0; i < d; ++i) {
        const float qi = q_s[i * kThreads + tid];
        const float ki = kt[i];
        const float f[4] = {qi, ki, qi - ki, qi * ki};
#pragma unroll
        for (int blk = 0; blk < 4; ++blk) {
          const float4* wr = reinterpret_cast<const float4*>(
              w1_s + (blk * d + i) * h1p + jc);
          const float4 lo = wr[0], hi = wr[1];
          a[0] += f[blk] * lo.x;
          a[1] += f[blk] * lo.y;
          a[2] += f[blk] * lo.z;
          a[3] += f[blk] * lo.w;
          a[4] += f[blk] * hi.x;
          a[5] += f[blk] * hi.y;
          a[6] += f[blk] * hi.z;
          a[7] += f[blk] * hi.w;
        }
      }
#pragma unroll
      for (int u = 0; u < kJ; ++u) {
        const float s = sigmoidf(a[u]);
        const float4* w2r =
            reinterpret_cast<const float4*>(w2_s + (jc + u) * h2p);
#pragma unroll
        for (int k4 = 0; k4 < kH2Max / 4; ++k4) {
          if (4 * k4 < h2p) {
            const float4 w = w2r[k4];
            h2acc[4 * k4 + 0] += s * w.x;
            h2acc[4 * k4 + 1] += s * w.y;
            h2acc[4 * k4 + 2] += s * w.z;
            h2acc[4 * k4 + 3] += s * w.w;
          }
        }
      }
    }
    float wt = bias3;
#pragma unroll
    for (int k = 0; k < kH2Max; ++k)
      if (k < h2p) wt += sigmoidf(h2acc[k]) * w3_s[k];
    wt *= mt;
    for (int i = 0; i < d; ++i) pool_s[i * kThreads + tid] += wt * kt[i];
  }
  __syncthreads();
  float* ob = out + static_cast<long long>(b) * N * d;
  for (int idx = tid; idx < kThreads * d; idx += kThreads) {
    const int nn = idx / d, i = idx % d;
    const int n = n0 + nn;
    if (n < N) ob[static_cast<long long>(n) * d + i] = pool_s[i * kThreads + nn];
  }
}

}  // namespace

extern "C" long long target_attention_smem_bytes(int T, int d, int h1,
                                                 int h2) {
  const long long h1p = (h1 + kJ - 1) / kJ * kJ;
  const long long h2p = (h2 + 3) / 4 * 4;
  const long long floats = 4LL * d * h1p + h1p * h2p + h1p + 2 * h2p +
                           static_cast<long long>(T) * d + T +
                           2LL * d * kThreads;
  return floats * 4;
}

// q_bstride: elements between users' candidate blocks (0 when every
// user shares one candidate list).  Requires h2 <= 64 and the staged
// tensors to fit one block's shared memory.
extern "C" int target_attention_launch(
    const float* q, long long q_bstride, const float* keys,
    const float* mask, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, float* out, int B,
    int N, int T, int d, int h1, int h2, void* stream) {
  if (h2 > kH2Max) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = target_attention_smem_bytes(T, d, h1, h2);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(target_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (N + kThreads - 1) / kThreads;
  const long long grid = static_cast<long long>(B) * n_blocks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  target_attention_kernel<<<static_cast<unsigned>(grid), kThreads,
                            static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      q, q_bstride, keys, mask, w1, b1, w2, b2, w3, b3, out, N, n_blocks, T,
      d, h1, h2);
  return static_cast<int>(cudaGetLastError());
}
