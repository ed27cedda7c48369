// DIN target attention, candidate form: the backward pass.
//
// Stands for jax.grad of the attention pool (src/repro/models/recsys/
// din.py:65, attention_pool), which the JAX package trains through its
// jnp form; the Pallas kernel src/repro/kernels/target_attention.py has
// no backward.  The forward is csrc/target_attention.cu:
//
//   feat = [q, k, q-k, q*k] (4d),  a1 = sigmoid(feat W1 + b1) (h1),
//   a2 = sigmoid(a1 W2 + b2) (h2), w = a2 W3 + b3,
//   out[b, n] = sum_t w * mask[b, t] * keys[b, t]
//
// Given dOut (B, N, d) this kernel returns dq (B, N, d), dkeys (B, T, d)
// and the attention MLP's dW1, db1, dW2, db2, dW3, db3.  Nothing of the
// forward is saved: each (b, n, t) pair's feat, a1 and a2 are recomputed
// here, so the (B, N, T, 4d) features never exist in device memory.
// Per pair:
//   ds  = mask * <dOut[b,n], k[b,t]>,  dk[b,t] += w * mask * dOut[b,n]
//   dz2 = ds * W3 . a2 (1 - a2),       dz1 = (dz2 W2^T) . a1 (1 - a1)
//   dW3 += ds a2, db3 += ds, dW2 += a1 (x) dz2, db2 += dz2,
//   dW1 += feat (x) dz1, db1 += dz1,  dfeat = dz1 W1^T = [f0 f1 f2 f3]
//   dq[b,n] += f0 + f2 + k . f3,       dk[b,t] += f1 - f2 + q . f3
//
// Bound: operations, at the f32 rate of the CUDA cores (this kernel runs
// plain f32 FMAs).  The least work per unmasked pair, with W1 split as
// the forward splits it, is about 10 d h1 + 6 h1 h2 flops (48,000 at
// DIN's d = 36, h1 = 80, h2 = 40); this simple design does about
// 12 d h1 + 3 h1 h2 FMAs, most with two operands read from shared
// memory, so shared-memory bandwidth rather than the FMA rate should set
// its time (it runs at about 5 % of the bound on an H100; what holds
// it is not measured).
//
// Design (256 threads a block, a fixed grid of kBlocks blocks):
// - A block stages W1 and W2 in shared memory, their rows padded to an
//   odd stride so that both row-wise and column-wise walks are free of
//   bank conflicts, then walks its users b = blockIdx.x, + gridDim.x, ...
//   For each candidate n of a user it takes the steps in tiles of P
//   pairs (P <= 32, chosen by the launcher so two blocks fit an SM):
//   feat, a1, a2, then ds, dz2, dz1, dfeat, each a loop of the block's
//   threads over the tile's outputs, with a barrier between stages.
// - dkeys: the pairs of a tile share n and have distinct t, so each
//   (t, c) is written by one thread: set at n = 0, added to for n > 0.
//   dq: a tile's pair terms are summed in pair order into a running
//   (d,) sum in shared memory, written at the end of the candidate.
// - The weight gradients are sums over all B N T pairs.  Each thread
//   owns fixed entries of its block's partial (nW floats in scratch, in
//   L2) and adds a tile's terms to them in pair order; a second launch
//   sums the kBlocks partials in block order.
// So every sum has a fixed order: the same inputs give the same bits,
// and no float atomics are used.
//
// Sizes: d <= 64, h1 <= 128, h2 <= 64, as the forward.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocks = 264;  // two a card's SM; fixed, so sums are too
constexpr int kMaxPairs = 32;

__device__ __forceinline__ float sigmoid_acc(float x) {
  return 1.f / (1.f + expf(-x));
}

// Odd row strides: a walk down a column touches every bank once.
__host__ __device__ inline int odd(int n) { return n | 1; }

struct Dims {
  int B, N, T, d, h1, h2, P;
  __host__ __device__ int f4() const { return 4 * d; }
  __host__ __device__ int ld1() const { return odd(h1); }
  __host__ __device__ int ld2() const { return odd(h2); }
  // entries of one block's weight-gradient partial, in the order
  // dW1 (4d, h1), db1 (h1), dW2 (h1, h2), db2 (h2), dW3 (h2), db3 (1);
  // at most 4 * 64 * 128 + 128 + 128 * 64 + 2 * 64 + 1 = 41,217
  __host__ __device__ int n_w() const {
    return 4 * d * h1 + h1 + h1 * h2 + 2 * h2 + 1;
  }
};

// Shared-memory layout, in floats.
struct Smem {
  int w1, w2, b1, b2, w3, qv, go, sq, sk, sm, sf, sa1, sa2, sdz1, sdz2, sdf,
      sw, sds, total;
  __host__ __device__ Smem(const Dims& m, int P) {
    int o = 0;
    w1 = o;  o += m.f4() * m.ld1();
    w2 = o;  o += m.h1 * m.ld2();
    b1 = o;  o += m.h1;
    b2 = o;  o += m.h2;
    w3 = o;  o += m.h2;
    qv = o;  o += m.d;
    go = o;  o += m.d;
    sq = o;  o += m.d;
    sk = o;  o += P * m.d;
    sm = o;  o += P;
    sf = o;  o += P * m.f4();
    sa1 = o; o += P * m.h1;
    sa2 = o; o += P * m.h2;
    sdz1 = o; o += P * m.h1;
    sdz2 = o; o += P * m.h2;
    sdf = o; o += P * m.f4();
    sw = o;  o += P;
    sds = o; o += P;
    total = o;
  }
};

__global__ void __launch_bounds__(kThreads, 2)
    target_attention_bwd_kernel(
        const float* __restrict__ dout, const float* __restrict__ q,
        const float* __restrict__ keys, const float* __restrict__ mask,
        const float* __restrict__ w1, const float* __restrict__ b1,
        const float* __restrict__ w2, const float* __restrict__ b2,
        const float* __restrict__ w3, const float* __restrict__ b3,
        float* __restrict__ dq, float* __restrict__ dk,
        float* __restrict__ part, Dims m) {
  extern __shared__ float smem[];
  const Smem L(m, m.P);
  const int tid = threadIdx.x;
  const int d = m.d, f4 = m.f4(), h1 = m.h1, h2 = m.h2;
  const int ld1 = m.ld1(), ld2 = m.ld2();
  float* W1 = smem + L.w1;
  float* W2 = smem + L.w2;
  float* B1 = smem + L.b1;
  float* B2 = smem + L.b2;
  float* W3 = smem + L.w3;
  float* qv = smem + L.qv;
  float* go = smem + L.go;
  float* sq = smem + L.sq;
  float* sk = smem + L.sk;
  float* sm = smem + L.sm;
  float* sf = smem + L.sf;
  float* sa1 = smem + L.sa1;
  float* sa2 = smem + L.sa2;
  float* sdz1 = smem + L.sdz1;
  float* sdz2 = smem + L.sdz2;
  float* sdf = smem + L.sdf;
  float* sw = smem + L.sw;
  float* sds = smem + L.sds;

  for (int i = tid; i < f4 * h1; i += kThreads)
    W1[(i / h1) * ld1 + i % h1] = w1[i];
  for (int i = tid; i < h1 * h2; i += kThreads)
    W2[(i / h2) * ld2 + i % h2] = w2[i];
  for (int i = tid; i < h1; i += kThreads) B1[i] = b1[i];
  for (int i = tid; i < h2; i += kThreads) {
    B2[i] = b2[i];
    W3[i] = w3[i];
  }
  const float bias3 = b3[0];
  const int n_w = m.n_w();
  float* my_part = part + static_cast<long long>(blockIdx.x) * n_w;
  for (int e = tid; e < n_w; e += kThreads) my_part[e] = 0.f;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int o_db1 = f4 * h1, o_dw2 = o_db1 + h1;
  const int o_db2 = o_dw2 + h1 * h2, o_dw3 = o_db2 + h2;
  const int o_db3 = o_dw3 + h2;

  for (int b = blockIdx.x; b < m.B; b += gridDim.x) {
    const float* kb = keys + static_cast<long long>(b) * m.T * d;
    const float* mb = mask + static_cast<long long>(b) * m.T;
    float* dkb = dk + static_cast<long long>(b) * m.T * d;
    for (int n = 0; n < m.N; ++n) {
      const long long bn = (static_cast<long long>(b) * m.N + n) * d;
      for (int c = tid; c < d; c += kThreads) {
        qv[c] = q[bn + c];
        go[c] = dout[bn + c];
        sq[c] = 0.f;
      }
      __syncthreads();
      for (int t0 = 0; t0 < m.T; t0 += m.P) {
        const int P = min(m.P, m.T - t0);
        // feat = [q, k, q - k, q * k] and the tile's keys and mask
        for (int i = tid; i < P * d; i += kThreads) {
          const int p = i / d, c = i - p * d;
          const float kv = kb[static_cast<long long>(t0 + p) * d + c];
          const float qc = qv[c];
          sk[i] = kv;
          float* f = sf + p * f4;
          f[c] = qc;
          f[d + c] = kv;
          f[2 * d + c] = qc - kv;
          f[3 * d + c] = qc * kv;
        }
        for (int p = tid; p < P; p += kThreads) sm[p] = mb[t0 + p];
        __syncthreads();
        // a1 = sigmoid(feat W1 + b1)
        for (int i = tid; i < P * h1; i += kThreads) {
          const int p = i / h1, j = i - p * h1;
          const float* f = sf + p * f4;
          float acc = B1[j];
          for (int r = 0; r < f4; ++r) acc = fmaf(f[r], W1[r * ld1 + j], acc);
          sa1[i] = sigmoid_acc(acc);
        }
        __syncthreads();
        // a2 = sigmoid(a1 W2 + b2)
        for (int i = tid; i < P * h2; i += kThreads) {
          const int p = i / h2, j = i - p * h2;
          const float* a = sa1 + p * h1;
          float acc = B2[j];
          for (int r = 0; r < h1; ++r) acc = fmaf(a[r], W2[r * ld2 + j], acc);
          sa2[i] = sigmoid_acc(acc);
        }
        __syncthreads();
        // a warp a pair: w = a2 W3 + b3 and <dOut, k>, by a fixed tree
        for (int p = warp; p < P; p += kThreads / 32) {
          float w = 0.f, dot = 0.f;
          for (int j = lane; j < h2; j += 32)
            w = fmaf(sa2[p * h2 + j], W3[j], w);
          for (int c = lane; c < d; c += 32)
            dot = fmaf(go[c], sk[p * d + c], dot);
#pragma unroll
          for (int s = 16; s > 0; s >>= 1) {
            w += __shfl_xor_sync(0xffffffffu, w, s);
            dot += __shfl_xor_sync(0xffffffffu, dot, s);
          }
          if (lane == 0) {
            sw[p] = (w + bias3) * sm[p];
            sds[p] = sm[p] * dot;
          }
        }
        __syncthreads();
        // dz2 = ds W3 . a2 (1 - a2)
        for (int i = tid; i < P * h2; i += kThreads) {
          const int p = i / h2, j = i - p * h2;
          const float a = sa2[i];
          sdz2[i] = sds[p] * W3[j] * (a * (1.f - a));
        }
        __syncthreads();
        // dz1 = (dz2 W2^T) . a1 (1 - a1)
        for (int i = tid; i < P * h1; i += kThreads) {
          const int p = i / h1, j = i - p * h1;
          const float* g = sdz2 + p * h2;
          float acc = 0.f;
          for (int r = 0; r < h2; ++r) acc = fmaf(g[r], W2[j * ld2 + r], acc);
          const float a = sa1[i];
          sdz1[i] = acc * (a * (1.f - a));
        }
        __syncthreads();
        // this block's weight-gradient partial: each entry one thread's,
        // the tile's pairs added in order
        for (int e = tid; e < n_w; e += kThreads) {
          float acc = 0.f;
          if (e < o_db1) {
            const int r = e / h1, j = e - r * h1;
            for (int p = 0; p < P; ++p)
              acc = fmaf(sf[p * f4 + r], sdz1[p * h1 + j], acc);
          } else if (e < o_dw2) {
            const int j = e - o_db1;
            for (int p = 0; p < P; ++p) acc += sdz1[p * h1 + j];
          } else if (e < o_db2) {
            const int i = (e - o_dw2) / h2, j = (e - o_dw2) - i * h2;
            for (int p = 0; p < P; ++p)
              acc = fmaf(sa1[p * h1 + i], sdz2[p * h2 + j], acc);
          } else if (e < o_dw3) {
            const int j = e - o_db2;
            for (int p = 0; p < P; ++p) acc += sdz2[p * h2 + j];
          } else if (e < o_db3) {
            const int j = e - o_dw3;
            for (int p = 0; p < P; ++p)
              acc = fmaf(sds[p], sa2[p * h2 + j], acc);
          } else {
            for (int p = 0; p < P; ++p) acc += sds[p];
          }
          my_part[e] += acc;
        }
        // dfeat = dz1 W1^T
        for (int i = tid; i < P * f4; i += kThreads) {
          const int p = i / f4, r = i - p * f4;
          const float* g = sdz1 + p * h1;
          const float* wr = W1 + r * ld1;
          float acc = 0.f;
          for (int j = 0; j < h1; ++j) acc = fmaf(g[j], wr[j], acc);
          sdf[i] = acc;
        }
        __syncthreads();
        // dkeys (one writer per (t, c)) and the pairs' dq terms, kept in
        // dfeat's f0 slots
        for (int i = tid; i < P * d; i += kThreads) {
          const int p = i / d, c = i - p * d;
          float* f = sdf + p * f4;
          const float kv = sk[i], qc = qv[c], f3 = f[3 * d + c];
          const float gk = f[d + c] - f[2 * d + c] + qc * f3 + sw[p] * go[c];
          float* dst = dkb + static_cast<long long>(t0 + p) * d + c;
          *dst = n == 0 ? gk : *dst + gk;
          f[c] = f[c] + f[2 * d + c] + kv * f3;
        }
        __syncthreads();
        for (int c = tid; c < d; c += kThreads) {
          float s = sq[c];
          for (int p = 0; p < P; ++p) s += sdf[p * f4 + c];
          sq[c] = s;
        }
        __syncthreads();
      }
      for (int c = tid; c < d; c += kThreads) dq[bn + c] = sq[c];
      __syncthreads();
    }
  }
}

// out[e] = sum over the G partials in block order.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int n_w,
                                    int G) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_w) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += part[static_cast<long long>(g) * n_w + e];
  out[e] = s;
}

int grid_for(int B) { return B < kBlocks ? B : kBlocks; }

// The largest tile (<= 32 pairs, <= T) whose shared memory lets two
// blocks share an SM, else one; the tile then shrinks to balance T's
// tiles.  0 when even one pair does not fit.
int pick_pairs(const Dims& m, long long max_optin) {
  const int cap = m.T < kMaxPairs ? (m.T > 0 ? m.T : 1) : kMaxPairs;
  const long long limits[2] = {max_optin / 2 - 1024, max_optin};
  for (const long long limit : limits) {
    for (int p = cap; p >= 1; --p) {
      if (4LL * Smem(m, p).total <= limit) {
        const int tiles = (m.T + p - 1) / p;
        return tiles > 0 ? (m.T + tiles - 1) / tiles : p;
      }
    }
  }
  return 0;
}

}  // namespace

// Floats of scratch the launch needs: one weight-gradient partial a
// block, then their (nW,) sum.
extern "C" long long target_attention_bwd_scratch_floats(int B, int d,
                                                         int h1, int h2) {
  const Dims m{B, 1, 1, d, h1, h2, 1};
  return (static_cast<long long>(grid_for(B)) + 1) * m.n_w();
}

// dout, q (B, N, d), keys (B, T, d), mask (B, T), the MLP as in the
// forward, all contiguous f32.  Writes dq (B, N, d), dkeys (B, T, d) and
// the weight gradients, concatenated in the order dW1, db1, dW2, db2,
// dW3, db3, to dw (nW floats, the last nW of scratch's
// target_attention_bwd_scratch_floats).  Needs B, N > 0.
extern "C" int target_attention_bwd_launch(
    const float* dout, const float* q, const float* keys, const float* mask,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, const float* b3, float* dq, float* dk, float* scratch,
    int B, int N, int T, int d, int h1, int h2, void* stream) {
  if (d > 64 || h1 > 128 || h2 > 64 || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Dims m{B, N, T, d, h1, h2, 0};
  m.P = pick_pairs(m, max_optin);
  if (m.P == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(Smem(m, m.P).total);
  err = cudaFuncSetAttribute(target_attention_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const int G = grid_for(B);
  const int n_w = m.n_w();
  float* dw = scratch + static_cast<long long>(G) * n_w;
  target_attention_bwd_kernel<<<G, kThreads, smem, st>>>(
      dout, q, keys, mask, w1, b1, w2, b2, w3, b3, dq, dk, scratch, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_w + kThreads - 1) / kThreads;
  sum_partials_kernel<<<blocks, kThreads, 0, st>>>(
      scratch, dw, n_w, G);
  return static_cast<int>(cudaGetLastError());
}
