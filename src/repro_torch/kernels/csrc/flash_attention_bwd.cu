// Flash attention: the backward pass.  q (B, T, H, dh), k and v (B, S,
// Hkv, dh), the forward's output o and its gradient dO (B, T, H, dh),
// all f32 or all bf16, contiguous -> dq, dk, dv in the inputs' dtype,
// for ops.flash_attention's semantics: positions from 0, GQA (kv head
// h / (H / Hkv)), a scale, an optional tanh softcap s = c tanh(x / c),
// the mask k_pos < S, causal (k_pos <= q_pos) and a sliding window
// (q_pos - k_pos < window when window > 0); ragged T and S.  With the
// recomputed scores s, P = exp(s - lse), D = rowsum(dO o O):
//
//   dv = P^T dO,  dP = dO V^T,  dS = P (dP - D) (1 - (s / c)^2) scale,
//   dq = dS K,    dk = dS^T Q,
//
// each query head of a group adding into its kv head.  Every row must
// admit a key (ops.flash_attention_bwd refuses other shapes).
//
// Stands for jax.grad of the JAX LM's attention (src/repro/models/lm.py:
// 296, _attention, and _attention_chunked, the XLA twin of the Pallas
// kernel src/repro/kernels/flash_attention.py, which has no backward).
//
// Bound: operations.  dq, dk, dv and dP are four products of 2 dh flops
// a (query, key) pair admitted, against the forward's two: at gemma2-2b's
// train_4k (T = S = 4,096, 8 heads on 4, dh = 256, causal) some 172
// GFLOP a layer and sequence, 0.17 ms at the bf16 tensor cores' 989
// TFLOP/s.  bf16 runs every product on the tensor cores (mma.sync
// m16n8k16, f32 sums); f32, which only the smoke widths train in, runs
// them on the CUDA cores in f32.  Neither is a Hopper design yet (wgmma,
// TMA): later work.
//
// Determinism: every sum runs in one fixed order and no atomics are
// used, so the same inputs give the same bits.
//
// Design, f32 (three launches, 256 threads a block, 32-row tiles, f32
// tiles in shared memory with rows padded to DH + 1 floats, DH = dh
// rounded up to 64, 128 or 256):
// (a) prologue, a block a (query tile, head): recomputes each row's
//     log-sum-exp over the admitted kv tiles with an online max and sum
//     (masked scores -1e30, as the forward kernels), and D = rowsum(dO o
//     O) a warp a row.  The forward kernels stay as they are.
// (b) kv kernel, a block a (kv tile, kv head): holds K and V, walks the
//     group's query heads and, in order, the query tiles whose rows admit
//     one of its keys; a tile's scores and dP are 2 x 2 a thread, P and
//     dS go to shared memory, and each thread adds dh / 8 columns of one
//     key's dk and dv rows in registers, summing over the tile's rows in
//     order.  It writes dk and dv once.
// (c) q kernel, a block a (query tile, head): holds Q and dO, walks its
//     admitted kv tiles in order, recomputes P and dS the same way and
//     adds dS K into dq rows in registers.
// Design, bf16: the same three launches on the tensor cores (namespace
// tc below): 64-row blocks of warps that own 16 rows each, bf16 tiles
// read by ldmatrix, the scores' fragments reused in registers as the
// accumulating products' operands, the streamed tiles double-buffered
// (cp.async: the next tile loads while this one is used).
//
// Limits: 1 <= dh <= 256; shared memory 140 KB a block at dh = 256 (f32),
// 135 KB (bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 32;          // rows of a query tile and of a kv tile
constexpr int kThreads = 256;   // 16 x 16 for the scores, 32 x 8 for sums
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (B, H, T)
  float* delta;  // (B, H, T)
  int B, T, S, H, Hkv, group, dh, causal, window;
  float scale, softcap;
};

template <int DH>
__host__ __device__ constexpr int ld() {
  return DH + 1;
}

// Rows [r0, r0 + kB) of head hh of x (B, L, nh, dh) into s as f32, zero
// past L and past dh.
template <int DH>
__device__ void load_tile(float* s, const void* xv, int b, int r0, int L,
                          int nh, int hh, int dh) {
  const float* x = static_cast<const float*>(xv);
  for (int e = threadIdx.x; e < kB * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int row = r0 + r;
    float val = 0.f;
    if (row < L && d < dh)
      val = x[((static_cast<long long>(b) * L + row) * nh + hh) * dh + d];
    s[r * ld<DH>() + d] = val;
  }
}

// The thread's 2 x 2 entries of A B^T over dh: rows 2 ty + i of a, rows
// tx + 16 j of b.
template <int DH>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int dh, float acc[2][2]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* a0 = a + (2 * ty) * ld<DH>();
  const float* a1 = a0 + ld<DH>();
  const float* b0 = b + tx * ld<DH>();
  const float* b1 = b + (tx + 16) * ld<DH>();
  acc[0][0] = acc[0][1] = acc[1][0] = acc[1][1] = 0.f;
  for (int d = 0; d < dh; ++d) {
    const float x0 = a0[d], x1 = a1[d], y0 = b0[d], y1 = b1[d];
    acc[0][0] = fmaf(x0, y0, acc[0][0]);
    acc[0][1] = fmaf(x0, y1, acc[0][1]);
    acc[1][0] = fmaf(x1, y0, acc[1][0]);
    acc[1][1] = fmaf(x1, y1, acc[1][1]);
  }
}

__device__ __forceinline__ bool admitted(const Params& p, int qp, int kp) {
  if (qp >= p.T || kp >= p.S) return false;
  if (p.causal && kp > qp) return false;
  if (p.window > 0 && qp - kp >= p.window) return false;
  return true;
}

// Scaled, soft-capped score and the softcap's tanh (0 without one).
__device__ __forceinline__ float score(const Params& p, float dot,
                                       float* th) {
  float s = dot * p.scale;
  *th = 0.f;
  if (p.softcap > 0.f) {
    *th = tanhf(s / p.softcap);
    s = p.softcap * *th;
  }
  return s;
}

// kv tiles of bk keys, [*lo, *hi), that query rows [r0, r0 + nr) may
// admit
__device__ __forceinline__ void kv_range(const Params& p, int r0, int nr,
                                         int bk, int* lo, int* hi) {
  int k_hi = p.S;
  if (p.causal) k_hi = min(k_hi, r0 + nr);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, r0 - p.window + 1);
  *lo = k_lo / bk;
  *hi = k_hi > k_lo ? (k_hi - 1) / bk + 1 : *lo;
}

// query tiles of bq rows, [*lo, *hi), whose rows may admit keys [c0, c0 +
// nc)
__device__ __forceinline__ void q_range(const Params& p, int c0, int nc,
                                        int bq, int* lo, int* hi) {
  const int q_lo = p.causal ? c0 : 0;
  int q_hi = p.T;
  if (p.window > 0) q_hi = min(q_hi, c0 + nc - 1 + p.window);
  *lo = q_lo / bq;
  *hi = q_hi > q_lo ? (q_hi - 1) / bq + 1 : *lo;
}

// (a) lse and D of query tile blockIdx.x of head blockIdx.y, batch z.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_prologue_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kB * ld<DH>();
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kB;
  const int hk = h / p.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // D = rowsum(dO o O), a warp a row, lanes over dh then a fixed tree
  const float* o = static_cast<const float*>(p.o);
  const float* g = static_cast<const float*>(p.dout);
  for (int r = warp; r < kB; r += kThreads / 32) {
    const int row = r0 + r;
    if (row >= p.T) break;
    const long long base =
        ((static_cast<long long>(b) * p.T + row) * p.H + h) * p.dh;
    float s = 0.f;
    for (int d = lane; d < p.dh; d += 32)
      s = fmaf(g[base + d], o[base + d], s);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0)
      p.delta[(static_cast<long long>(b) * p.H + h) * p.T + row] = s;
  }

  load_tile<DH>(qs, p.q, b, r0, p.T, p.H, h, p.dh);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int lo, hi;
  kv_range(p, r0, kB, kB, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int c0 = j * kB;
    __syncthreads();  // the previous tile's scores are done with ks
    load_tile<DH>(ks, p.k, b, c0, p.S, p.Hkv, hk, p.dh);
    __syncthreads();
    float acc[2][2];
    tile_dots<DH>(qs, ks, p.dh, acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = r0 + 2 * ty + i;
      float s[2], th;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kp = c0 + tx + 16 * jj;
        s[jj] = admitted(p, qp, kp) ? score(p, acc[i][jj], &th) : kNegInf;
      }
      float mt = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      float e = expf(s[0] - mn) + expf(s[1] - mn);
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        e += __shfl_xor_sync(0xffffffffu, e, off);
      l[i] = l[i] * expf(m[i] - mn) + e;
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 2 * ty + i;
      if (row < p.T)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.T + row] =
            m[i] + logf(l[i]);
    }
  }
}

// P and dS of the thread's 2 x 2 entries of query tile r0 against kv
// tile c0 into ps and dss (kB x (kB + 1)); qs/dos hold the query tile's
// Q and dO, ks/vs the kv tile's K and V, lse_s/d_s the rows' lse and D.
template <int DH>
__device__ __forceinline__ void p_and_ds(const Params& p, const float* qs,
                                         const float* dos, const float* ks,
                                         const float* vs, const float* lse_s,
                                         const float* d_s, int r0, int c0,
                                         float* ps, float* dss) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sd[2][2], dp[2][2];
  tile_dots<DH>(qs, ks, p.dh, sd);
  tile_dots<DH>(dos, vs, p.dh, dp);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = tx + 16 * jj;
      float pv = 0.f, ds = 0.f;
      if (admitted(p, r0 + r, c0 + c)) {
        float th;
        const float s = score(p, sd[i][jj], &th);
        pv = expf(s - lse_s[r]);
        ds = pv * (dp[i][jj] - d_s[r]);
        if (p.softcap > 0.f) ds *= 1.f - th * th;
        ds *= p.scale;
      }
      ps[r * (kB + 1) + c] = pv;
      dss[r * (kB + 1) + c] = ds;
    }
  }
}

template <int DH>
constexpr long long tiles_bytes() {
  return (4LL * kB * ld<DH>() + 2LL * kB * (kB + 1) + 2LL * kB) * 4;
}

// (b) dk, dv of kv tile blockIdx.x of kv head blockIdx.y, batch z.
template <int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_kv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kB * ld<DH>();
  float* qs = vs + kB * ld<DH>();
  float* dos = qs + kB * ld<DH>();
  float* ps = dos + kB * ld<DH>();
  float* dss = ps + kB * (kB + 1);
  float* lse_s = dss + kB * (kB + 1);
  float* d_s = lse_s + kB;
  const int b = blockIdx.z, hk = blockIdx.y, c0 = blockIdx.x * kB;
  const int row = threadIdx.x / 8, col = threadIdx.x % 8;  // key, d
  constexpr int kN = DH / 8;
  float dk[kN], dv[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) dk[n] = dv[n] = 0.f;
  load_tile<DH>(ks, p.k, b, c0, p.S, p.Hkv, hk, p.dh);
  load_tile<DH>(vs, p.v, b, c0, p.S, p.Hkv, hk, p.dh);
  int lo, hi;
  q_range(p, c0, kB, kB, &lo, &hi);
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;
    for (int i = lo; i < hi; ++i) {
      const int r0 = i * kB;
      __syncthreads();  // the previous tile's sums are done
      load_tile<DH>(qs, p.q, b, r0, p.T, p.H, h, p.dh);
      load_tile<DH>(dos, p.dout, b, r0, p.T, p.H, h, p.dh);
      if (threadIdx.x < kB) {
        const int r = r0 + threadIdx.x;
        lse_s[threadIdx.x] = r < p.T ? p.lse[rows + r] : 0.f;
        d_s[threadIdx.x] = r < p.T ? p.delta[rows + r] : 0.f;
      }
      __syncthreads();
      p_and_ds<DH>(p, qs, dos, ks, vs, lse_s, d_s, r0, c0, ps, dss);
      __syncthreads();
      for (int r = 0; r < kB; ++r) {
        const float pv = ps[r * (kB + 1) + row];
        const float ds = dss[r * (kB + 1) + row];
        const float* dor = dos + r * ld<DH>() + col;
        const float* qr = qs + r * ld<DH>() + col;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          dv[n] = fmaf(pv, dor[8 * n], dv[n]);
          dk[n] = fmaf(ds, qr[8 * n], dk[n]);
        }
      }
    }
  }
  const int kp = c0 + row;
  if (kp >= p.S) return;
  const long long base =
      ((static_cast<long long>(b) * p.S + kp) * p.Hkv + hk) * p.dh;
  float* dkp = static_cast<float*>(p.dk);
  float* dvp = static_cast<float*>(p.dv);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int d = col + 8 * n;
    if (d < p.dh) {
      dkp[base + d] = dk[n];
      dvp[base + d] = dv[n];
    }
  }
}

// (c) dq of query tile blockIdx.x of head blockIdx.y, batch z.
template <int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_q_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kB * ld<DH>();
  float* qs = vs + kB * ld<DH>();
  float* dos = qs + kB * ld<DH>();
  float* ps = dos + kB * ld<DH>();
  float* dss = ps + kB * (kB + 1);
  float* lse_s = dss + kB * (kB + 1);
  float* d_s = lse_s + kB;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kB;
  const int hk = h / p.group;
  const int row = threadIdx.x / 8, col = threadIdx.x % 8;  // query, d
  constexpr int kN = DH / 8;
  float dq[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) dq[n] = 0.f;
  load_tile<DH>(qs, p.q, b, r0, p.T, p.H, h, p.dh);
  load_tile<DH>(dos, p.dout, b, r0, p.T, p.H, h, p.dh);
  if (threadIdx.x < kB) {
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;
    const int r = r0 + threadIdx.x;
    lse_s[threadIdx.x] = r < p.T ? p.lse[rows + r] : 0.f;
    d_s[threadIdx.x] = r < p.T ? p.delta[rows + r] : 0.f;
  }
  int lo, hi;
  kv_range(p, r0, kB, kB, &lo, &hi);
  for (int j = lo; j < hi; ++j) {
    const int c0 = j * kB;
    __syncthreads();  // the previous tile's sums are done with ks
    load_tile<DH>(ks, p.k, b, c0, p.S, p.Hkv, hk, p.dh);
    load_tile<DH>(vs, p.v, b, c0, p.S, p.Hkv, hk, p.dh);
    __syncthreads();
    p_and_ds<DH>(p, qs, dos, ks, vs, lse_s, d_s, r0, c0, ps, dss);
    __syncthreads();
    for (int c = 0; c < kB; ++c) {
      const float ds = dss[row * (kB + 1) + c];
      const float* kr = ks + c * ld<DH>() + col;
#pragma unroll
      for (int n = 0; n < kN; ++n) dq[n] = fmaf(ds, kr[8 * n], dq[n]);
    }
  }
  const int qp = r0 + row;
  if (qp >= p.T) return;
  const long long base =
      ((static_cast<long long>(b) * p.T + qp) * p.H + h) * p.dh;
  float* dqp = static_cast<float*>(p.dq);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int d = col + 8 * n;
    if (d < p.dh) dqp[base + d] = dq[n];
  }
}

// -- bf16 on the tensor cores ----------------------------------------------
//
// The same three launches with bf16 tiles in shared memory (rows padded
// by 16 bytes, so the 8 rows an ldmatrix phase reads fall in distinct
// bank groups) and every product on mma.sync m16n8k16 (bf16 in, f32
// sums).  A warp owns 16 rows of its block's tile (keys in the kv kernel,
// queries in the others) and, at dh = 256, one half of the dims of its
// accumulators (DW = 128 a warp, the scores computed by both halves):
// the accumulators of a thread are DW / 2 floats each.  The scores' C
// fragments become the A fragments of the accumulating products in
// registers (two n8 tiles are one k16 block); P and dS round to bf16
// there, as the forward rounds P before PV.

namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kPad = 8;  // bf16 elements of padding a shared-memory row

template <int DH>
struct Cfg {
  static constexpr int DW = DH == 256 ? 128 : DH;  // dims a warp owns
  static constexpr int SPLIT = DH / DW;            // warps a row group
  static constexpr int LD = DH + kPad;             // row stride, elements
  static constexpr int NTD = DW / 8;               // n8 tiles of a warp's dims
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p)));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of s
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* s, int r0,
                                       int c0, int lane) {
  ldsm4(a, s + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
               (lane >> 4) * 8);
}

// B fragments of two n8 tiles, B[k][n] = s[n][k]: s's rows [n0, n0 + 16)
// are n, its columns [k0, k0 + 16) are k.  b[0..1] tile n0, b[2..3] n0+8.
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* s, int n0,
                                       int k0, int lane) {
  ldsm4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
               ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles, B[k][n] = s[k][n]: s's rows [k0, k0 + 16)
// are k, its columns [n0, n0 + 16) are n.
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t* b, const bf16* s, int k0,
                                        int n0, int lane) {
  ldsm4t(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                (lane >> 4) * 8);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(saddr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + n) of head hh of x (B, L, nh, dh) into s (stride LD), 16
// bytes a copy, zero past L and past dh: by cp.async where dh is a
// multiple of 8 (complete after the next cp_wait and barrier), else by
// plain loads (complete after the barrier).
template <int DH>
__device__ void load_rows(bf16* s, const void* xv, int b, int r0, int n,
                          int L, int nh, int hh, int dh) {
  constexpr int LD = Cfg<DH>::LD, CH = DH / 8;
  const bf16* x = static_cast<const bf16*>(xv);
  const bool vec = dh % 8 == 0;
  for (int e = threadIdx.x; e < n * CH; e += blockDim.x) {
    const int r = e / CH, c = (e % CH) * 8;
    const int row = r0 + r;
    const bool live = row < L && c < dh;
    const bf16* src =
        live ? x + ((static_cast<long long>(b) * L + row) * nh + hh) * dh + c
             : x;
    if (vec) {
      cp16(s + r * LD + c, src, live ? 16 : 0);
      continue;
    }
    union {
      uint4 u;
      bf16 h[8];
    } tmp;
    for (int i = 0; i < 8; ++i)
      tmp.h[i] = live && c + i < dh ? src[i] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(s + r * LD + c) = tmp.u;
  }
}

// P and dS of one score from its dot, dP, and its row's lse and D (0 for
// a pair the mask refuses).
__device__ __forceinline__ void p_ds(const Params& p, int qp, int kp,
                                     float dot, float dpv, float lse,
                                     float dd, float* pv, float* ds) {
  *pv = *ds = 0.f;
  if (!admitted(p, qp, kp)) return;
  float th;
  const float s = score(p, dot, &th);
  *pv = __expf(s - lse);
  float d = *pv * (dpv - dd);
  if (p.softcap > 0.f) d *= 1.f - th * th;
  *ds = d * p.scale;
}

constexpr int kRows = 64;  // rows of a prologue block and of a q block
constexpr int kKv = 64;    // keys of a kv block
constexpr int kQt = 32;    // query rows a kv block takes at a time
constexpr int kKt = 32;    // keys a q block takes at a time

// (a) lse and D of query rows [64 x, 64 x + 64) of head y, batch z: 4
// warps of 16 rows, kv tiles of 64 keys, the next tile loading while this
// one is scored.
template <int DH>
__global__ void __launch_bounds__(128) prologue_tc(Params p) {
  constexpr int LD = Cfg<DH>::LD;
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* qs = reinterpret_cast<bf16*>(raw);
  bf16* kbuf[2] = {qs + kRows * LD, qs + (kRows + kKv) * LD};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kRows;
  const int hk = h / p.group, kd = (p.dh + 15) / 16;

  int lo, hi;
  kv_range(p, r0, kRows, kKv, &lo, &hi);
  load_rows<DH>(qs, p.q, b, r0, kRows, p.T, p.H, h, p.dh);
  if (lo < hi) load_rows<DH>(kbuf[0], p.k, b, lo * kKv, kKv, p.S, p.Hkv, hk,
                             p.dh);
  cp_commit();

  const bf16* o = static_cast<const bf16*>(p.o);
  const bf16* gd = static_cast<const bf16*>(p.dout);
  for (int r = warp; r < kRows; r += 4) {
    const int row = r0 + r;
    if (row >= p.T) break;
    const long long base =
        ((static_cast<long long>(b) * p.T + row) * p.H + h) * p.dh;
    float sum = 0.f;
    for (int d = lane; d < p.dh; d += 32)
      sum = fmaf(__bfloat162float(gd[base + d]), __bfloat162float(o[base + d]),
                 sum);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0)
      p.delta[(static_cast<long long>(b) * p.H + h) * p.T + row] = sum;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int j = lo; j < hi; ++j) {
    const int c0 = j * kKv;
    const bf16* ks = kbuf[(j - lo) & 1];
    if (j + 1 < hi) {
      load_rows<DH>(kbuf[(j + 1 - lo) & 1], p.k, b, c0 + kKv, kKv, p.S,
                    p.Hkv, hk, p.dh);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float sc[kKv / 8][4] = {};
    for (int kk = 0; kk < kd; ++kk) {
      uint32_t a[4];
      frag_a<LD>(a, qs, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < kKv / 16; ++np) {
        uint32_t bb[4];
        frag_b<LD>(bb, ks, 16 * np, 16 * kk, lane);
        mma(sc[2 * np], a, bb[0], bb[1]);
        mma(sc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = r0 + 16 * warp + g + 8 * hr;
      float mt = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kKv / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = c0 + 8 * nt + 2 * t4 + e;
          float th;
          const float v = admitted(p, qp, kp)
                              ? score(p, sc[nt][2 * hr + e], &th)
                              : kNegInf;
          sc[nt][2 * hr + e] = v;
          mt = fmaxf(mt, v);
        }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[hr], mt);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKv / 8; ++nt)
        sum += expf(sc[nt][2 * hr] - mn) + expf(sc[nt][2 * hr + 1] - mn);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * expf(m[hr] - mn) + sum;
      m[hr] = mn;
    }
    __syncthreads();  // this buffer is free for the tile after next
  }
  cp_wait<0>();  // no copy outlives the block (none left unless no tile)
  if (t4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 16 * warp + g + 8 * hr;
      if (row < p.T)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.T + row] =
            m[hr] + logf(l[hr]);
    }
  }
}

// (b) dk, dv of keys [64 x, 64 x + 64) of kv head y, batch z: 4 key
// groups of 16 x SPLIT dim slices; the (query head, 32-row query tile)
// pairs in order, the next pair's Q and dO loading while this one's are
// used.
template <int DH>
__global__ void __launch_bounds__(128 * Cfg<DH>::SPLIT) kv_tc(Params p) {
  using C = Cfg<DH>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* ks = reinterpret_cast<bf16*>(raw);
  bf16* vs = ks + kKv * LD;
  bf16* qbuf[2] = {vs + kKv * LD, vs + (kKv + kQt) * LD};
  bf16* dbuf[2] = {vs + (kKv + 2 * kQt) * LD, vs + (kKv + 3 * kQt) * LD};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kg = warp & 3, sl = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y, c0 = blockIdx.x * kKv;
  const int kd = (p.dh + 15) / 16;
  float dk[C::NTD][4] = {}, dv[C::NTD][4] = {};
  int lo, hi;
  q_range(p, c0, kKv, kQt, &lo, &hi);
  const int nq = hi - lo, total = p.group * nq;
  auto issue = [&](int t) {
    const int h = hk * p.group + t / nq, r0 = (lo + t % nq) * kQt;
    load_rows<DH>(qbuf[t & 1], p.q, b, r0, kQt, p.T, p.H, h, p.dh);
    load_rows<DH>(dbuf[t & 1], p.dout, b, r0, kQt, p.T, p.H, h, p.dh);
  };
  load_rows<DH>(ks, p.k, b, c0, kKv, p.S, p.Hkv, hk, p.dh);
  load_rows<DH>(vs, p.v, b, c0, kKv, p.S, p.Hkv, hk, p.dh);
  if (total > 0) issue(0);
  cp_commit();
  for (int t = 0; t < total; ++t) {
    const int h = hk * p.group + t / nq, r0 = (lo + t % nq) * kQt;
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;
    const bf16* qs = qbuf[t & 1];
    const bf16* dos = dbuf[t & 1];
    if (t + 1 < total) {
      issue(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries a warp
    float st[kQt / 8][4] = {}, dpt[kQt / 8][4] = {};
    for (int kk = 0; kk < kd; ++kk) {
      uint32_t ak[4], av[4];
      frag_a<LD>(ak, ks, 16 * kg, 16 * kk, lane);
      frag_a<LD>(av, vs, 16 * kg, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < kQt / 16; ++np) {
        uint32_t bq[4], bo[4];
        frag_b<LD>(bq, qs, 16 * np, 16 * kk, lane);
        frag_b<LD>(bo, dos, 16 * np, 16 * kk, lane);
        mma(st[2 * np], ak, bq[0], bq[1]);
        mma(st[2 * np + 1], ak, bq[2], bq[3]);
        mma(dpt[2 * np], av, bo[0], bo[1]);
        mma(dpt[2 * np + 1], av, bo[2], bo[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kQt / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = c0 + 16 * kg + g + 8 * (e >> 1);
        const int qp = r0 + 8 * nt + 2 * t4 + (e & 1);
        const bool ok = qp < p.T;
        p_ds(p, qp, kp, st[nt][e], dpt[nt][e], ok ? p.lse[rows + qp] : 0.f,
             ok ? p.delta[rows + qp] : 0.f, &st[nt][e], &dpt[nt][e]);
      }
    // dV += P^T dO, dK += dS^T Q over the tile's 32 queries
#pragma unroll
    for (int kb = 0; kb < kQt / 16; ++kb) {
      const uint32_t ap[4] = {pack(st[2 * kb][0], st[2 * kb][1]),
                              pack(st[2 * kb][2], st[2 * kb][3]),
                              pack(st[2 * kb + 1][0], st[2 * kb + 1][1]),
                              pack(st[2 * kb + 1][2], st[2 * kb + 1][3])};
      const uint32_t ad[4] = {pack(dpt[2 * kb][0], dpt[2 * kb][1]),
                              pack(dpt[2 * kb][2], dpt[2 * kb][3]),
                              pack(dpt[2 * kb + 1][0], dpt[2 * kb + 1][1]),
                              pack(dpt[2 * kb + 1][2], dpt[2 * kb + 1][3])};
#pragma unroll
      for (int nd = 0; nd < C::NTD / 2; ++nd) {
        uint32_t bo[4], bq[4];
        frag_bt<LD>(bo, dos, 16 * kb, sl * C::DW + 16 * nd, lane);
        frag_bt<LD>(bq, qs, 16 * kb, sl * C::DW + 16 * nd, lane);
        mma(dv[2 * nd], ap, bo[0], bo[1]);
        mma(dv[2 * nd + 1], ap, bo[2], bo[3]);
        mma(dk[2 * nd], ad, bq[0], bq[1]);
        mma(dk[2 * nd + 1], ad, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this buffer is free for the pair after next
  }
  cp_wait<0>();  // no copy outlives the block (none left unless no pair)
  bf16* dkp = static_cast<bf16*>(p.dk);
  bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int nt = 0; nt < C::NTD; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = c0 + 16 * kg + g + 8 * (e >> 1);
      const int d = sl * C::DW + 8 * nt + 2 * t4 + (e & 1);
      if (kp < p.S && d < p.dh) {
        const long long at =
            ((static_cast<long long>(b) * p.S + kp) * p.Hkv + hk) * p.dh + d;
        dkp[at] = __float2bfloat16(dk[nt][e]);
        dvp[at] = __float2bfloat16(dv[nt][e]);
      }
    }
}

// (c) dq of query rows [64 x, 64 x + 64) of head y, batch z: 4 row groups
// of 16 x SPLIT dim slices, kv tiles of 32 keys, the next tile loading
// while this one is used.
template <int DH>
__global__ void __launch_bounds__(128 * Cfg<DH>::SPLIT) q_tc(Params p) {
  using C = Cfg<DH>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) unsigned char raw[];
  bf16* qs = reinterpret_cast<bf16*>(raw);
  bf16* dos = qs + kRows * LD;
  bf16* kbuf[2] = {dos + kRows * LD, dos + (kRows + kKt) * LD};
  bf16* vbuf[2] = {dos + (kRows + 2 * kKt) * LD,
                   dos + (kRows + 3 * kKt) * LD};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qg = warp & 3, sl = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * kRows;
  const int hk = h / p.group, kd = (p.dh + 15) / 16;
  float dq[C::NTD][4] = {};
  float lse[2], dd[2];  // this thread's rows g and g + 8 of its group
  {
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = r0 + 16 * qg + g + 8 * hr;
      lse[hr] = qp < p.T ? p.lse[rows + qp] : 0.f;
      dd[hr] = qp < p.T ? p.delta[rows + qp] : 0.f;
    }
  }
  int lo, hi;
  kv_range(p, r0, kRows, kKt, &lo, &hi);
  load_rows<DH>(qs, p.q, b, r0, kRows, p.T, p.H, h, p.dh);
  load_rows<DH>(dos, p.dout, b, r0, kRows, p.T, p.H, h, p.dh);
  if (lo < hi) {
    load_rows<DH>(kbuf[0], p.k, b, lo * kKt, kKt, p.S, p.Hkv, hk, p.dh);
    load_rows<DH>(vbuf[0], p.v, b, lo * kKt, kKt, p.S, p.Hkv, hk, p.dh);
  }
  cp_commit();
  for (int j = lo; j < hi; ++j) {
    const int c0 = j * kKt, buf = (j - lo) & 1;
    const bf16* ks = kbuf[buf];
    const bf16* vs = vbuf[buf];
    if (j + 1 < hi) {
      load_rows<DH>(kbuf[buf ^ 1], p.k, b, c0 + kKt, kKt, p.S, p.Hkv, hk,
                    p.dh);
      load_rows<DH>(vbuf[buf ^ 1], p.v, b, c0 + kKt, kKt, p.S, p.Hkv, hk,
                    p.dh);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float sc[kKt / 8][4] = {}, dp[kKt / 8][4] = {};
    for (int kk = 0; kk < kd; ++kk) {
      uint32_t aq[4], ao[4];
      frag_a<LD>(aq, qs, 16 * qg, 16 * kk, lane);
      frag_a<LD>(ao, dos, 16 * qg, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < kKt / 16; ++np) {
        uint32_t bk[4], bv[4];
        frag_b<LD>(bk, ks, 16 * np, 16 * kk, lane);
        frag_b<LD>(bv, vs, 16 * np, 16 * kk, lane);
        mma(sc[2 * np], aq, bk[0], bk[1]);
        mma(sc[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ao, bv[0], bv[1]);
        mma(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kKt / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int qp = r0 + 16 * qg + g + 8 * hr;
        const int kp = c0 + 8 * nt + 2 * t4 + (e & 1);
        float pv;
        p_ds(p, qp, kp, sc[nt][e], dp[nt][e], lse[hr], dd[hr], &pv,
             &dp[nt][e]);
      }
    // dQ += dS K over the tile's 32 keys
#pragma unroll
    for (int kb = 0; kb < kKt / 16; ++kb) {
      const uint32_t ad[4] = {pack(dp[2 * kb][0], dp[2 * kb][1]),
                              pack(dp[2 * kb][2], dp[2 * kb][3]),
                              pack(dp[2 * kb + 1][0], dp[2 * kb + 1][1]),
                              pack(dp[2 * kb + 1][2], dp[2 * kb + 1][3])};
#pragma unroll
      for (int nd = 0; nd < C::NTD / 2; ++nd) {
        uint32_t bk[4];
        frag_bt<LD>(bk, ks, 16 * kb, sl * C::DW + 16 * nd, lane);
        mma(dq[2 * nd], ad, bk[0], bk[1]);
        mma(dq[2 * nd + 1], ad, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }
  cp_wait<0>();  // no copy outlives the block (none left unless no tile)
  bf16* dqp = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int nt = 0; nt < C::NTD; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = r0 + 16 * qg + g + 8 * (e >> 1);
      const int d = sl * C::DW + 8 * nt + 2 * t4 + (e & 1);
      if (qp < p.T && d < p.dh)
        dqp[((static_cast<long long>(b) * p.T + qp) * p.H + h) * p.dh + d] =
            __float2bfloat16(dq[nt][e]);
    }
}

}  // namespace tc

template <typename K>
int set_smem(K kernel, long long bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int DH>
int launch(const Params& p, cudaStream_t s) {
  const long long pro = 2LL * kB * ld<DH>() * 4;
  const long long tiles = tiles_bytes<DH>();
  int err = set_smem(flash_bwd_prologue_kernel<DH>, pro);
  if (err == 0) err = set_smem(flash_bwd_kv_kernel<DH>, tiles);
  if (err == 0) err = set_smem(flash_bwd_q_kernel<DH>, tiles);
  if (err != 0) return err;
  const unsigned qt = (p.T + kB - 1) / kB, kt = (p.S + kB - 1) / kB;
  flash_bwd_prologue_kernel<DH>
      <<<dim3(qt, p.H, p.B), kThreads, pro, s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_bwd_kv_kernel<DH><<<dim3(kt, p.Hkv, p.B), kThreads, tiles, s>>>(
      p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  flash_bwd_q_kernel<DH><<<dim3(qt, p.H, p.B), kThreads, tiles, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_tc(const Params& p, cudaStream_t s) {
  using C = tc::Cfg<DH>;
  // bf16 tiles, the streamed ones twice (double buffers)
  const long long pro = (tc::kRows + 2LL * tc::kKv) * C::LD * 2;
  const long long kv = (2LL * tc::kKv + 4LL * tc::kQt) * C::LD * 2;
  const long long q = (2LL * tc::kRows + 4LL * tc::kKt) * C::LD * 2;
  int err = set_smem(tc::prologue_tc<DH>, pro);
  if (err == 0) err = set_smem(tc::kv_tc<DH>, kv);
  if (err == 0) err = set_smem(tc::q_tc<DH>, q);
  if (err != 0) return err;
  const unsigned qt = (p.T + tc::kRows - 1) / tc::kRows;
  const unsigned kt = (p.S + tc::kKv - 1) / tc::kKv;
  tc::prologue_tc<DH><<<dim3(qt, p.H, p.B), 128, pro, s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  tc::kv_tc<DH><<<dim3(kt, p.Hkv, p.B), 128 * C::SPLIT, kv, s>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  tc::q_tc<DH><<<dim3(qt, p.H, p.B), 128 * C::SPLIT, q, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const Params& p, cudaStream_t s) {
  if (p.dh <= 64) return launch<64>(p, s);
  if (p.dh <= 128) return launch<128>(p, s);
  return launch<256>(p, s);
}

int launch_dh_tc(const Params& p, cudaStream_t s) {
  if (p.dh <= 64) return launch_tc<64>(p, s);
  if (p.dh <= 128) return launch_tc<128>(p, s);
  return launch_tc<256>(p, s);
}

}  // namespace

// q, o, dout, dq (B, T, H, dh); k, v, dk, dv (B, S, Hkv, dh); all
// contiguous, f32 or (bf16 != 0) bf16; scratch 2 B H T floats (lse, D).
// softcap <= 0 means none, window <= 0 global.  Requires B, T, S, H > 0,
// H a multiple of Hkv, 1 <= dh <= 256 (else cudaErrorInvalidValue) and
// every query row admitting a key.  Returns the first failing launch's
// cudaGetLastError(), else 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* scratch, int B,
    int T, int S, int H, int Hkv, int dh, int causal, int window,
    float scale, float softcap, int bf16, void* stream) {
  if (dh < 1 || dh > 256 || Hkv < 1 || H % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = scratch;
  p.delta = scratch + static_cast<long long>(B) * H * T;
  p.B = B;
  p.T = T;
  p.S = S;
  p.H = H;
  p.Hkv = Hkv;
  p.group = H / Hkv;
  p.dh = dh;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dh_tc(p, s) : launch_dh(p, s);
}
