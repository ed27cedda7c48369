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
// user's keys and mask, and the attention MLP, are staged once in shared
// memory, so neither the broadcast keys nor the (B, N, T, 4d) features
// ever exist in device memory.
//
// The algebra: W1's four (d, h1) row blocks Wq, Wk, Wd, Wp act on q, k,
// q - k and q*k, so feat W1 = q (Wq + Wd) + k (Wk - Wd) + (q*k) Wp.  The
// block computes Aq = q (Wq + Wd) once for each of its candidates (kept
// in registers) and Ak = k (Wk - Wd) + b1 once for each unmasked step
// of its user (T x h1 in shared memory), in f32 on the CUDA cores.  Per
// (candidate, step) there remain (q*k) Wp (d x h1), the sigmoid, . W2
// (h1 x h2), the sigmoid, . W3 and the pooling.
//
// Bound: operations.  Per unmasked (candidate, step) the function needs
// d + 2 d h1 + 2 h1 + 2 h1 h2 + 2 h2 + 2 d flops (12,508 at d = 36,
// h1 = 80, h2 = 40) against a few bytes of input; 12,160 of them are
// the two products, which run on the tensor cores in 3xTF32, so the
// least time counts them at 495/3 TFLOP/s and the rest at the f32 peak.
//
// Why three passes: one TF32 pass (10 mantissa bits) misses the 2e-5
// gate; with each operand split into hi = tf32(x) and lo = tf32(x - hi)
// and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi summed, the split form meets it
// (tests/test_torch_tf32x3.py shows both on the CPU, with sums that round
// to nearest; the card tests of tests/test_torch_gpu.py hold the kernel
// itself to the gate).
//
// Design (256 threads, 8 warps of 16 candidates, mma.sync m16n8k8 tf32):
// - Wp and W2 are split into hi and lo once a block and stored in
//   fragment order, one float4 (b0 hi, b1 hi, b0 lo, b1 lo) a lane, so a
//   B fragment is one 16-byte load.  That region first holds the setup's
//   (Wq + Wd), (Wk - Wd) and the candidate tile.
// - Per unmasked step a warp forms the A fragments of q*k from its
//   candidates' q (registers) and the key (shared, broadcast), split
//   with cvt.rna.tf32, and runs the first product into h1/8 accumulator
//   tiles started at Aq + Ak[t]: three mma a k8 step and tile.
// - The sigmoid of a first-product tile is, in the accumulator's own
//   layout, the A fragment of the second product's k8 step: the thread's
//   columns 2t and 2t + 1 stand for k = t and t + 4, and W2's rows are
//   stored in that order.  So the hidden layer never leaves registers.
// - The second product accumulates h2/8 tiles started at b2; their
//   sigmoids times W3, summed over a quad's lanes, give the step's
//   weight of each candidate, and each lane adds weight * key into its
//   quarter of the candidate's d pooled values.
// - Steps whose mask is exactly 0 add 0 * key and are skipped (uniform
//   per block).
// - The sigmoids (h1 + h2 = 120 a candidate and step) take the fast form,
//   __expf and __fdividef: with expf and an IEEE division they were most
//   of the kernel's instructions and it ran about half as fast, and the
//   2e-5 gate holds with the fast form (PERF.md, kernel table).
// - Sizes: d <= 64, h1 <= 128, h2 <= 64, padded to multiples of 8 with
//   zeros (the padding adds 0: q and Wp's rows past d are 0, W2's rows
//   past h1 are 0, W3 past h2 is 0).  The register tiles are compiled
//   for DIN's d = 36, h1 = 80, h2 = 40 and for the limits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps of 16 candidates
constexpr int kCands = 128;    // candidates per block

// 1 / (1 + e^-x) with the hardware exp2 and reciprocal (a few ulp each);
// 0 for x below about -87, 1 above about 17.
__device__ __forceinline__ float sigmoidf(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo + (what neither keeps): hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) b (8 x 8, tf32, col).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a_lo b_hi + a_hi b_lo + a_hi b_hi; bf = (b0 hi, b1 hi, b0 lo, b1 lo).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const float4& bf) {
  const uint32_t h0 = __float_as_uint(bf.x), h1 = __float_as_uint(bf.y);
  mma_tf32(c, alo, h0, h1);
  mma_tf32(c, ahi, __float_as_uint(bf.z), __float_as_uint(bf.w));
  mma_tf32(c, ahi, h0, h1);
}

// Shared memory of one block, in floats: the fragment region (first the
// setup's operands), Ak + b1 (T x NJ1*8), keys (T x KD*8), b2 and W3
// (NJ2*8 each), mask (T); every part but the mask a multiple of 8.
template <int KD, int NJ1, int NJ2>
struct Layout {
  static constexpr int kDp = 8 * KD, kH1p = 8 * NJ1, kH2p = 8 * NJ2;
  static constexpr int kFrag = 4 * 32 * (KD * NJ1 + NJ1 * NJ2);
  static constexpr int kSetup = 2 * kDp * kH1p + kCands * kDp;
  static constexpr int kRegion = kFrag > kSetup ? kFrag : kSetup;
  static long long floats(int T) {
    return kRegion + static_cast<long long>(T) * (kH1p + kDp + 1) + 2 * kH2p;
  }
};

template <int KD, int NJ1, int NJ2>
__global__ void __launch_bounds__(kThreads, 1)
    target_attention_kernel(const float* __restrict__ q, long long q_bstride,
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
  using L = Layout<KD, NJ1, NJ2>;
  constexpr int kDp = L::kDp, kH1p = L::kH1p, kH2p = L::kH2p;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // setup view of the fragment region
  float* wqd_s = smem;                // (kDp, kH1p): Wq + Wd
  float* wkd_s = wqd_s + kDp * kH1p;  // (kDp, kH1p): Wk - Wd
  float* q_s = wkd_s + kDp * kH1p;    // (kCands, kDp)
  // main-loop view: B fragments, one float4 a lane
  const float4* wp_f = smem4;                        // [KD][NJ1][32]
  const float4* w2_f = smem4 + KD * NJ1 * 32;        // [NJ1][NJ2][32]
  float* ak_s = smem + L::kRegion;                   // (T, kH1p)
  float* keys_s = ak_s + static_cast<long long>(T) * kH1p;  // (T, kDp)
  float* b2_s = keys_s + T * kDp;                    // (kH2p,)
  float* w3_s = b2_s + kH2p;                         // (kH2p,)
  float* mask_s = w3_s + kH2p;                       // (T,)

  const int b = blockIdx.x / n_blocks;
  const int n0 = (blockIdx.x % n_blocks) * kCands;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * warp + g;  // this thread's candidates r0, r0 + 8

  // ---- setup: stage the user, the candidates and W1's folded blocks ----
  const float* kb = keys + static_cast<long long>(b) * T * d;
  for (int idx = tid; idx < T * kDp; idx += kThreads) {
    const int t = idx / kDp, i = idx % kDp;
    keys_s[idx] = i < d ? kb[t * d + i] : 0.f;
  }
  for (int t = tid; t < T; t += kThreads)
    mask_s[t] = mask[static_cast<long long>(b) * T + t];
  for (int k = tid; k < kH2p; k += kThreads) {
    b2_s[k] = k < h2 ? b2[k] : 0.f;
    w3_s[k] = k < h2 ? w3[k] : 0.f;
  }
  const float* qb = q + b * q_bstride;
  for (int idx = tid; idx < kCands * kDp; idx += kThreads) {
    const int nn = idx / kDp, i = idx % kDp;
    const int n = n0 + nn;
    q_s[idx] = (n < N && i < d) ? qb[static_cast<long long>(n) * d + i] : 0.f;
  }
  for (int idx = tid; idx < kDp * kH1p; idx += kThreads) {
    const int i = idx / kH1p, c = idx % kH1p;
    float wq = 0.f, wk = 0.f;
    if (i < d && c < h1) {
      const float wd = w1[(2 * d + i) * h1 + c];
      wq = w1[i * h1 + c] + wd;
      wk = w1[(d + i) * h1 + c] - wd;
    }
    wqd_s[idx] = wq;
    wkd_s[idx] = wk;
  }
  __syncthreads();

  // Ak[t] + b1 for the unmasked steps
  for (int idx = tid; idx < T * kH1p; idx += kThreads) {
    const int t = idx / kH1p, c = idx % kH1p;
    float a = 0.f;
    if (c < h1 && mask_s[t] != 0.f) {
      for (int i = 0; i < d; ++i)
        a = fmaf(keys_s[t * kDp + i], wkd_s[i * kH1p + c], a);
      a += b1[c];
    }
    ak_s[idx] = a;
  }
  // Aq of this thread's accumulator places: rows r0 (0, 1) and r0 + 8
  // (2, 3), columns 8 j + 2 t4 (0, 2) and + 1 (1, 3)
  float aq[NJ1][4];
#pragma unroll
  for (int j = 0; j < NJ1; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) aq[j][e] = 0.f;
  for (int i = 0; i < d; ++i) {
    const float x0 = q_s[r0 * kDp + i], x1 = q_s[(r0 + 8) * kDp + i];
#pragma unroll
    for (int j = 0; j < NJ1; ++j) {
      const float2 w =
          *reinterpret_cast<const float2*>(&wqd_s[i * kH1p + 8 * j + 2 * t4]);
      aq[j][0] = fmaf(x0, w.x, aq[j][0]);
      aq[j][1] = fmaf(x0, w.y, aq[j][1]);
      aq[j][2] = fmaf(x1, w.x, aq[j][2]);
      aq[j][3] = fmaf(x1, w.y, aq[j][3]);
    }
  }
  // q in the A-fragment places: k = 8 kk + t4 (0: row r0, 1: r0 + 8) and
  // 8 kk + t4 + 4 (2, 3)
  float qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    qa[kk][0] = q_s[r0 * kDp + 8 * kk + t4];
    qa[kk][1] = q_s[(r0 + 8) * kDp + 8 * kk + t4];
    qa[kk][2] = q_s[r0 * kDp + 8 * kk + t4 + 4];
    qa[kk][3] = q_s[(r0 + 8) * kDp + 8 * kk + t4 + 4];
  }
  __syncthreads();  // the setup view is consumed

  // B fragments: b0 = B[k = t4][n = g], b1 = B[t4 + 4][g] of each 8 x 8
  // tile.  Wp's k is its row 8 kk + t4 (+ 4); W2's k step j stands for
  // W1-output columns 8 j + 2 t4 (b0) and 8 j + 2 t4 + 1 (b1).
  float4* frag = smem4;
  for (int idx = tid; idx < (KD * NJ1 + NJ1 * NJ2) * 32; idx += kThreads) {
    const int l = idx % 32, tile = idx / 32;
    const int lg = l / 4, lt = l % 4;
    float v0 = 0.f, v1 = 0.f;
    if (tile < KD * NJ1) {
      const int kk = tile / NJ1, j = tile % NJ1;
      const int c = 8 * j + lg, i0 = 8 * kk + lt, i1 = i0 + 4;
      if (c < h1) {
        if (i0 < d) v0 = w1[(3 * d + i0) * h1 + c];
        if (i1 < d) v1 = w1[(3 * d + i1) * h1 + c];
      }
    } else {
      const int j = (tile - KD * NJ1) / NJ2, j2 = (tile - KD * NJ1) % NJ2;
      const int c = 8 * j2 + lg, i0 = 8 * j + 2 * lt, i1 = i0 + 1;
      if (c < h2) {
        if (i0 < h1) v0 = w2[i0 * h2 + c];
        if (i1 < h1) v1 = w2[i1 * h2 + c];
      }
    }
    uint32_t h0, l0, h1b, l1;
    split_tf32(v0, h0, l0);
    split_tf32(v1, h1b, l1);
    frag[idx] = make_float4(__uint_as_float(h0), __uint_as_float(h1b),
                            __uint_as_float(l0), __uint_as_float(l1));
  }
  const float bias3 = b3[0];
  __syncthreads();

  // ---- the history walk ----
  constexpr int kDq = (kDp + 3) / 4;  // pooled values per lane and row
  float pool[2][kDq];
#pragma unroll
  for (int u = 0; u < kDq; ++u) pool[0][u] = pool[1][u] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float mt = mask_s[t];
    if (mt == 0.f) continue;  // adds 0 * key; same for the whole block
    const float* kt = keys_s + t * kDp;
    const float* akt = ak_s + t * kH1p;

    // first product: c1[j] = Aq + Ak[t] + b1 + (q*k) Wp
    float c1[NJ1][4];
#pragma unroll
    for (int j = 0; j < NJ1; ++j) {
      const float2 a = *reinterpret_cast<const float2*>(&akt[8 * j + 2 * t4]);
      c1[j][0] = aq[j][0] + a.x;
      c1[j][1] = aq[j][1] + a.y;
      c1[j][2] = aq[j][2] + a.x;
      c1[j][3] = aq[j][3] + a.y;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const float k0 = kt[8 * kk + t4], k1 = kt[8 * kk + t4 + 4];
      uint32_t ahi[4], alo[4];
      split_tf32(qa[kk][0] * k0, ahi[0], alo[0]);
      split_tf32(qa[kk][1] * k0, ahi[1], alo[1]);
      split_tf32(qa[kk][2] * k1, ahi[2], alo[2]);
      split_tf32(qa[kk][3] * k1, ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < NJ1; ++j)
        mma_3xtf32(c1[j], ahi, alo, wp_f[(kk * NJ1 + j) * 32 + lane]);
    }

    // second product: c2 = b2 + sigmoid(c1) W2, k step j from tile j
    float c2[NJ2][4];
#pragma unroll
    for (int j2 = 0; j2 < NJ2; ++j2) {
      const float2 bb = *reinterpret_cast<const float2*>(&b2_s[8 * j2 + 2 * t4]);
      c2[j2][0] = c2[j2][2] = bb.x;
      c2[j2][1] = c2[j2][3] = bb.y;
    }
#pragma unroll
    for (int j = 0; j < NJ1; ++j) {
      // A places (row, k): 0 (r0, t4) 1 (r0 + 8, t4) 2 (r0, t4 + 4)
      // 3 (r0 + 8, t4 + 4) <- c1 places 0, 2, 1, 3
      uint32_t ahi[4], alo[4];
      split_tf32(sigmoidf(c1[j][0]), ahi[0], alo[0]);
      split_tf32(sigmoidf(c1[j][2]), ahi[1], alo[1]);
      split_tf32(sigmoidf(c1[j][1]), ahi[2], alo[2]);
      split_tf32(sigmoidf(c1[j][3]), ahi[3], alo[3]);
#pragma unroll
      for (int j2 = 0; j2 < NJ2; ++j2)
        mma_3xtf32(c2[j2], ahi, alo, w2_f[(j * NJ2 + j2) * 32 + lane]);
    }

    // the step's weight of candidates r0 and r0 + 8
    float w0 = 0.f, w1r = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < NJ2; ++j2) {
      const float2 v = *reinterpret_cast<const float2*>(&w3_s[8 * j2 + 2 * t4]);
      w0 += sigmoidf(c2[j2][0]) * v.x + sigmoidf(c2[j2][1]) * v.y;
      w1r += sigmoidf(c2[j2][2]) * v.x + sigmoidf(c2[j2][3]) * v.y;
    }
    w0 += __shfl_xor_sync(0xffffffffu, w0, 1);
    w1r += __shfl_xor_sync(0xffffffffu, w1r, 1);
    w0 += __shfl_xor_sync(0xffffffffu, w0, 2);
    w1r += __shfl_xor_sync(0xffffffffu, w1r, 2);
    w0 = (w0 + bias3) * mt;
    w1r = (w1r + bias3) * mt;
    // lane t4 pools the key's values t4 + 4 u
#pragma unroll
    for (int u = 0; u < kDq; ++u) {
      const int i = t4 + 4 * u;
      if (i < kDp) {
        const float kv = kt[i];
        pool[0][u] = fmaf(w0, kv, pool[0][u]);
        pool[1][u] = fmaf(w1r, kv, pool[1][u]);
      }
    }
  }

  float* ob = out + static_cast<long long>(b) * N * d;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int n = n0 + r0 + 8 * rr;
    if (n >= N) continue;
#pragma unroll
    for (int u = 0; u < kDq; ++u) {
      const int i = t4 + 4 * u;
      if (i < d) ob[static_cast<long long>(n) * d + i] = pool[rr][u];
    }
  }
}

// The register tiles a call runs with: DIN's widths, or the limits.
struct Shape {
  int kd, nj1, nj2;
};

Shape shape_for(int d, int h1, int h2) {
  const int kd = (d + 7) / 8, nj1 = (h1 + 7) / 8, nj2 = (h2 + 7) / 8;
  if (kd <= 5 && nj1 <= 10 && nj2 <= 5) return {5, 10, 5};
  return {8, 16, 8};
}

long long smem_floats(Shape s, int T) {
  if (s.kd == 5) return Layout<5, 10, 5>::floats(T);
  return Layout<8, 16, 8>::floats(T);
}

template <int KD, int NJ1, int NJ2>
int launch(const float* q, long long q_bstride, const float* keys,
           const float* mask, const float* w1, const float* b1,
           const float* w2, const float* b2, const float* w3,
           const float* b3, float* out, int B, int N, int T, int d, int h1,
           int h2, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      target_attention_kernel<KD, NJ1, NJ2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (N + kCands - 1) / kCands;
  const long long grid = static_cast<long long>(B) * n_blocks;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  target_attention_kernel<KD, NJ1, NJ2>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
          q, q_bstride, keys, mask, w1, b1, w2, b2, w3, b3, out, N, n_blocks,
          T, d, h1, h2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long target_attention_smem_bytes(int T, int d, int h1,
                                                 int h2) {
  return 4 * smem_floats(shape_for(d, h1, h2), T);
}

// q_bstride: elements between users' candidate blocks (0 when every
// user shares one candidate list).  Requires d <= 64, h1 <= 128,
// h2 <= 64 and the staged tensors to fit one block's shared memory.
extern "C" int target_attention_launch(
    const float* q, long long q_bstride, const float* keys,
    const float* mask, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, float* out, int B,
    int N, int T, int d, int h1, int h2, void* stream) {
  if (d > 64 || h1 > 128 || h2 > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = shape_for(d, h1, h2);
  const long long smem = 4 * smem_floats(s, T);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_optin) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (s.kd == 5)
    return launch<5, 10, 5>(q, q_bstride, keys, mask, w1, b1, w2, b2, w3, b3,
                            out, B, N, T, d, h1, h2,
                            static_cast<size_t>(smem), st);
  return launch<8, 16, 8>(q, q_bstride, keys, mask, w1, b1, w2, b2, w3, b3,
                          out, B, N, T, d, h1, h2, static_cast<size_t>(smem),
                          st);
}
