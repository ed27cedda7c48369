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
// train_4k (T = S = 4,096, 8 heads on 4, dh = 256, causal) some 137
// GFLOP a layer and sequence, 0.14 ms at the bf16 tensor cores' 989
// TFLOP/s.  The bf16 route (every layer the LMs train) is a Hopper design
// on wgmma and TMA; the f32 route, which only the smoke widths and the
// identity checks run, keeps the CUDA cores (not redesigned).
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
// Design, bf16 (namespace hw below; sm_90a, the forward's machinery in
// flash_attention_wgmma.cu: 384 threads, a producer warpgroup whose one
// thread starts TMA loads of 4-D maps with the 128-byte swizzle into
// full/empty mbarrier rings, two consumer warpgroups on wgmma m64nNk16;
// the same three launches, each score computed once a launch):
// (a) prologue, 128 query rows of a head: S = Q K^T over kv tiles of 64
//     keys (both operands in shared memory), an online max and sum for
//     lse; three producer warps take D = rowsum(dO o O).
// (b) kv kernel, 64 keys of a kv head, walking the group's (head, query
//     tile) pairs in order (64 rows, 128 at dh <= 64), Q and dO streamed
//     through a ring.  Warpgroup 0 computes S^T = K Q^T once, P and G = P
//     (1 - tanh^2) scale, hands G to warpgroup 1 through shared memory
//     (in its own fragment order, named barriers both ways) and adds dV
//     += P^T dO; warpgroup 1 computes dP^T = V dO^T once, dS = G (dP - D)
//     and adds dK += dS^T Q.  P and dS round to bf16 as the register A
//     operand (the score accumulator's layout is the A-fragment layout),
//     Q and dO are read MN-major; each warpgroup holds its 64 x dh
//     accumulator (128 registers a thread at dh = 256) and writes dk, dv
//     once.
// (c) q kernel, 128 query rows of a head (64 a consumer warpgroup), Q
//     and dO loaded once, kv tiles streamed (32 keys, 64 at dh <= 128):
//     S = Q K^T and dP = dO V^T once each, dS in bf16 as the A operand of
//     dQ += dS K.
// Scores s = c tanh(x / c) take tanh as 1 - 2 / (e^{2x} + 1) on
// ex2.approx and rcp.approx (absolute error a few 1e-7: s enters P by
// its absolute error), not tanhf, in all three launches alike.
// Products a pair: 8 (1 + 4 + 3).
// Masks apply only on tiles that cross the diagonal, the window's edge,
// T or S; kv blocks start in order of their walks' length (the causal
// kv tile 0 first), q and prologue blocks from the last query tile.
//
// Limits: 1 <= dh <= 256, in bf16 a multiple of 8 (TMA reads 16-byte
// rows); shared memory 140 KB a block at dh = 256 (f32), 214 KB (bf16 kv
// kernel).

#include "hopper.cuh"

#include <type_traits>

namespace {

using namespace hopper;

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

// -- bf16 on Hopper's tensor cores ------------------------------------------
//
// Three launches, each 384 threads: consumer warpgroups 0 and 1 and a
// producer warpgroup whose thread 256 starts every TMA load (4-D maps of
// the contiguous tensors, dh cut into 64-wide chunks of 128-byte
// swizzled rows, zeros past dh, T and S), with full (TMA bytes) and
// empty (256 consumer arrivals) mbarriers a ring slot.  Every product is
// a wgmma m64nNk16 (bf16 in, f32 sums): scores with both operands in
// shared memory, K-major; the accumulating products with P or dS as the
// register A operand (the accumulator layout of a 64 x 64 score tile is
// the A-fragment layout of two k16 steps) and Q, dO or K read MN-major.

namespace hw {

constexpr int kThreads = 384;
constexpr int kRow = 128;   // bytes of one swizzled row: 64 bf16
constexpr int kKv = 64;     // keys of a kv block
constexpr int kQb = 128;    // query rows of a q or prologue block
constexpr int kKp = 64;     // keys a prologue block takes a step

// Tile shapes and ring slots by dh's 64-wide chunks.  A short dh makes
// a step brief, so the kv kernel takes 128 queries a step at dh <= 64 and
// the q kernel 64 keys at dh <= 128 (their registers allow it), and the
// rings hold as many slots as shared memory leaves (two leave a load's
// latency exposed).
template <int NC>
struct Tiles {
  static constexpr int kv_rows = NC == 1 ? 128 : 64;  // queries a kv step
  static constexpr int q_keys = NC <= 2 ? 64 : 32;    // keys a q step
  static constexpr int pro = NC == 1 ? 8 : NC == 2 ? 6 : 4;
  static constexpr int kv = NC <= 2 ? 5 : NC == 3 ? 3 : 2;
  static constexpr int q = NC == 1 ? 8 : NC == 2 ? 4 : NC == 3 ? 5 : 3;
};

// dh's NC chunks of `rows` rows of a (B, L, heads, dh) tensor into dst,
// chunk c at dst + c rows kRow, completing on `bar`.
template <int NC>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int rows, int head,
                                         int r0, int b) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load(dst + c * rows * kRow, map, bar, 64 * c, head, r0, b);
}

// MN-major (Q, dO or K as the B operand of an accumulating product, dims
// along N): 8 rows of 128 bytes a k group, groups 1024 bytes apart; the
// next 64 dims would be a chunk of `rows` rows away.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, int rows) {
  return desc_sw128(addr, rows * kRow, 8 * kRow);
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// admitted() without a branch a test: the bf16 kernels call it inside
// their unrolled score loops.
__device__ __forceinline__ bool admits(const Params& p, int qp, int kp) {
  return qp < p.T && kp < p.S && !(p.causal && kp > qp) &&
         !(p.window > 0 && qp - kp >= p.window);
}

// The scaled score s and, soft-capped (kCap), the softcap's tanh: s =
// cap tanh(dot scale / cap).  tanh(x) = 1 - 2 / (e^{2x} + 1) on
// ex2.approx and rcp.approx: an absolute error of a few 1e-7, which is
// what s needs (it enters P = exp(s - lse) by its absolute error), for
// some 20 instructions a score less than tanhf's relative accuracy near
// 0.
struct Score {
  float scale, k, cap;  // k = scale / cap, where cap > 0
  template <bool kCap>
  __device__ __forceinline__ float at(float dot, float* th) const {
    if constexpr (kCap) {
      *th = 1.f - 2.f * rcp(ex2(dot * k * 2.885390081777927f) + 1.f);
      return cap * *th;
    } else {
      *th = 0.f;
      return dot * scale;
    }
  }
};

__device__ __forceinline__ Score score_of(const Params& p) {
  return {p.scale, p.softcap > 0.f ? p.scale / p.softcap : 0.f, p.softcap};
}

// body(std::true_type()) where the scores are soft-capped, else
// body(std::false_type()): a loop over a tile's scores then holds no
// branch a score.  (Branches a score split the unrolled loop into a block
// a score, each waiting out its exp: at dh = 64 the kv kernel took half
// again as long.)
template <class F>
__device__ __forceinline__ void by_cap(const Params& p, F&& body) {
  if (p.softcap > 0.f)
    body(std::true_type());
  else
    body(std::false_type());
}

// The block's tile and (head, batch) from a linear block index, tiles
// slowest so that every head's first tile starts before any head's
// second: `reverse` walks the tiles from the last (the causal q tiles,
// whose rows see the most keys, then start first).
__device__ __forceinline__ void decode(int x, int heads, int B, int n_tiles,
                                       bool reverse, int* tile, int* head,
                                       int* b) {
  const int hb = heads * B, rank = x / hb, rem = x - rank * hb;
  *tile = reverse ? n_tiles - 1 - rank : rank;
  *b = rem / heads;
  *head = rem - *b * heads;
}

// Writes rows row0 and row0 + 8 of a 64 x (64 NC) accumulator into x
// (B, L, heads, dh) at head hh, rows below L and dims below dh: bf16
// (rounded) or f32.
__device__ __forceinline__ void store_pair(void* x, long long at, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(x) + at) =
      pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* x, long long at, float a,
                                           float b) {
  *reinterpret_cast<float2*>(x + at) = make_float2(a, b);
}

template <int NC, typename Out>
__device__ __forceinline__ void store_rows(Out* x, const float (&acc)[NC][32],
                                           int b, int row0, int L, int heads,
                                           int hh, int dh, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= L) continue;
    const long long at =
        ((static_cast<long long>(b) * L + row) * heads + hh) * dh;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * t;
        if (col < dh)  // dh is a multiple of 8: pairs never straddle
          store_pair(x, at + col, acc[c][4 * j + 2 * half],
                     acc[c][4 * j + 2 * half + 1]);
      }
  }
}

// (a) lse and D of query rows [128 q, 128 q + 128) of head h, batch b:
// the consumers' scores S = Q K^T over kv tiles of 64 keys with an online
// max and sum (masked scores -1e30, as the forward kernels), warps 9-11
// D = rowsum(dO o O), a warp four rows at a time.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    prologue_hw(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk, const Params p) {
  constexpr uint32_t kQBytes = NC * kQb * kRow;
  constexpr uint32_t kKBytes = NC * kKp * kRow;
  constexpr int kS = Tiles<NC>::pro;  // ring slots
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = smem_base(smem_raw);
  const uint32_t sk = sq + kQBytes;
  const uint32_t bars = sk + kS * kKBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) -> uint32_t { return bars + 8 + 8 * s; };
  auto k_empty = [&](int s) -> uint32_t {
    return bars + 8 + 8 * (kS + s);
  };
  const int n_qt = (p.T + kQb - 1) / kQb;
  int qt, h, b;
  decode(blockIdx.x, p.H, p.B, n_qt, p.causal, &qt, &h, &b);
  const Score sfn = score_of(p);
  const int hk = h / p.group, q0 = qt * kQb;
  int lo, hi;
  kv_range(p, q0, kQb, kKp, &lo, &hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, kQBytes);
      tma_rows<NC>(sq, &tq, q_full, kQb, h, q0, b);
      for (int i = 0; i < hi - lo; ++i) {
        const int s = i % kS;
        mbar_wait(k_empty(s), ((i / kS) & 1) ^ 1);
        mbar_expect_tx(k_full(s), kKBytes);
        tma_rows<NC>(sk + s * kKBytes, &tk, k_full(s), kKp, hk,
                     (lo + i) * kKp, b);
      }
    } else if (threadIdx.x >= 288) {
      // D = rowsum(dO o O): a warp four rows at a time (their loads in
      // flight together), lanes over dh in 16-byte runs, a fixed tree
      const uint4* o = static_cast<const uint4*>(p.o);
      const uint4* g = static_cast<const uint4*>(p.dout);
      const int chunks = p.dh / 8;
      for (int r0 = 4 * ((threadIdx.x - 288) / 32); r0 < kQb; r0 += 12) {
        uint4 ov[4], gv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = q0 + r0 + u;
          ov[u] = gv[u] = make_uint4(0, 0, 0, 0);
          if (row < p.T && lane < chunks) {
            const long long at =
                ((static_cast<long long>(b) * p.T + row) * p.H + h) * chunks +
                lane;
            ov[u] = o[at];
            gv[u] = g[at];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const __nv_bfloat16* oe =
              reinterpret_cast<const __nv_bfloat16*>(&ov[u]);
          const __nv_bfloat16* ge =
              reinterpret_cast<const __nv_bfloat16*>(&gv[u]);
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            sum = fmaf(__bfloat162float(ge[e]), __bfloat162float(oe[e]), sum);
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          const int row = q0 + r0 + u;
          if (lane == 0 && row < p.T)
            p.delta[(static_cast<long long>(b) * p.H + h) * p.T + row] = sum;
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  const int tid = threadIdx.x % 128, t = lane % 4;
  const int rq0 = q0 + 64 * wg;
  const int row0 = rq0 + 16 * (tid / 32) + lane / 4;  // and row0 + 8
  int wlo, whi;  // the kv tiles this warpgroup's rows may admit
  kv_range(p, rq0, 64, kKp, &wlo, &whi);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);
  for (int i = 0; i < hi - lo; ++i) {
    const int s = i % kS, j = lo + i, k0 = j * kKp;
    mbar_wait(k_full(s), (i / kS) & 1);
    const bool live = j >= wlo && j < whi;
    float sc[32];
    if (live) {
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc,
                     desc_kmajor(sq + (c * kQb + 64 * wg) * kRow + 32 * kk),
                     desc_kmajor(sk + s * kKBytes + c * kKp * kRow + 32 * kk),
                     c | kk);
      wg_commit();
      wg_wait_all();
      fence_regs(sc);
    }
    mbar_arrive(k_empty(s));
    if (!live) continue;
    const bool need_mask = k0 + kKp > p.S || (p.causal && k0 + kKp - 1 > rq0) ||
                           (p.window > 0 && rq0 + 63 - k0 >= p.window);
    by_cap(p, [&](auto cap) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qp = row0 + 8 * ((e >> 1) & 1);
        const int kp = k0 + 8 * (e / 4) + 2 * t + (e & 1);
        float th;
        const float v = sfn.at<decltype(cap)::value>(sc[e], &th);
        sc[e] = !need_mask || admits(p, qp, kp) ? v : kNegInf;
      }
    });
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        mt = fmaxf(mt, fmaxf(sc[4 * jj + 2 * hr], sc[4 * jj + 2 * hr + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[hr], mt);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        sum += __expf(sc[4 * jj + 2 * hr] - mn) +
               __expf(sc[4 * jj + 2 * hr + 1] - mn);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * __expf(m[hr] - mn) + sum;
      m[hr] = mn;
    }
  }
  if (t == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row < p.T)
        p.lse[(static_cast<long long>(b) * p.H + h) * p.T + row] =
            m[hr] + logf(l[hr]);
    }
  }
}

// (b) dk, dv of keys [64 x, 64 x + 64) of kv head hk, batch b.  K and V
// load once; the (query head, query tile of QS rows) pairs of the group
// stream through the ring in order.  Warpgroup 0 computes S^T = K Q^T,
// P and G = P (1 - tanh^2) scale (the factor of dS but dP - D), hands G
// to warpgroup 1 through shared memory in its own fragment order, and
// adds dV += P^T dO; warpgroup 1 computes dP^T = V dO^T, dS = G (dP - D)
// and adds dK += dS^T Q.  Each owns its accumulator over all of dh; the
// scores of a step are QS / 64 accumulators of 64 queries.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    kv_hw(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int QS = Tiles<NC>::kv_rows, NQ = QS / 64;
  constexpr uint32_t kTile = NC * kKv * kRow;  // K or V: 64 keys of dh
  constexpr uint32_t kQTile = NC * QS * kRow;  // Q or dO: QS rows of dh
  constexpr int kS = Tiles<NC>::kv;            // ring slots
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = smem_base(smem_raw);
  const uint32_t sv = sk + kTile;
  const uint32_t ring = sv + kTile;  // slot s: Q at 2 s kQTile, dO after
  const uint32_t sg = ring + kS * 2 * kQTile;  // G, 32 NQ x 128 floats
  float* g_s = reinterpret_cast<float*>(
      smem_raw +
      (sg - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw))));
  const uint32_t bars = sg + 32 * NQ * 128 * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int s) -> uint32_t { return bars + 8 + 8 * s; };
  auto empty = [&](int s) -> uint32_t { return bars + 8 + 8 * (kS + s); };
  auto sq = [&](int s) -> uint32_t { return ring + 2 * s * kQTile; };
  auto sdo = [&](int s) -> uint32_t { return ring + (2 * s + 1) * kQTile; };
  // blocks: kv tiles slowest (the causal tile 0 walks the most query
  // tiles and starts first), then kv head, batch
  int kt, hk, b;
  decode(blockIdx.x, p.Hkv, p.B, 0, false, &kt, &hk, &b);
  const int h0 = hk * p.group, nh = p.group;
  const Score sfn = score_of(p);
  const int c0 = kt * kKv;
  int lo, hi;
  q_range(p, c0, kKv, QS, &lo, &hi);
  const int nq = hi - lo, total = nh * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(kv_full, 2 * kTile);
      tma_rows<NC>(sk, &tk, kv_full, kKv, hk, c0, b);
      tma_rows<NC>(sv, &tv, kv_full, kKv, hk, c0, b);
      for (int i = 0; i < total; ++i) {
        const int s = i % kS;
        const int h = h0 + i / nq, r0 = (lo + i % nq) * QS;
        mbar_wait(empty(s), ((i / kS) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kQTile);
        tma_rows<NC>(sq(s), &tq, full(s), QS, h, r0, b);
        tma_rows<NC>(sdo(s), &tdo, full(s), QS, h, r0, b);
      }
    }
    return;
  }

  // ---- consumers: the block's 64 keys, warpgroup 0 dV, 1 dK ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x % 128, lane = tid % 32, t = lane % 4;
  const int kr0 = c0 + 16 * (tid / 32) + lane / 4;  // keys kr0, kr0 + 8
  float acc[NC][32];  // dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  mbar_wait(kv_full, 0);
  for (int i = 0; i < total; ++i) {
    const int s = i % kS;
    const int h = h0 + i / nq, r0 = (lo + i % nq) * QS;
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;
    // the pairs' admissions: every one, unless the tile crosses the
    // diagonal, the window's edge, T or S
    const bool need_mask = r0 + QS > p.T || c0 + kKv > p.S ||
                           (p.causal && c0 + kKv - 1 > r0) ||
                           (p.window > 0 && r0 + QS - 1 - c0 >= p.window);
    // this thread's query columns: r0 + 64 u + 8 jj + 2 t + e
    float rowv[NQ][16];  // lse (warpgroup 0) or D (1) of those queries
    const float* src = wg == 0 ? p.lse : p.delta;
#pragma unroll
    for (int u = 0; u < NQ; ++u)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = r0 + 64 * u + 8 * jj + 2 * t + e;
          rowv[u][2 * jj + e] = qp < p.T ? src[rows + qp] : 0.f;
        }
    mbar_wait(full(s), (i / kS) & 1);
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1), 64 queries an
    // accumulator
    float st[NQ][32];
    const uint32_t a_tile = wg == 0 ? sk : sv;
    const uint32_t b_tile = wg == 0 ? sq(s) : sdo(s);
    wg_fence();
#pragma unroll
    for (int u = 0; u < NQ; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(st[u], desc_kmajor(a_tile + c * kKv * kRow + 32 * kk),
                   desc_kmajor(b_tile + (c * QS + 64 * u) * kRow + 32 * kk),
                   c | kk);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int u = 0; u < NQ; ++u) fence_regs(st[u]);
    // element e of st[u]: key kr0 + 8 ((e >> 1) & 1), query r0 + 64 u +
    // 8 (e / 4) + 2 t + (e & 1)
    if (wg == 0) {
      if (i > 0) bar_sync(2);  // warpgroup 1 has read the last G
      by_cap(p, [&](auto cap) {
        constexpr bool kCap = decltype(cap)::value;
#pragma unroll
        for (int u = 0; u < NQ; ++u)
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int kp = kr0 + 8 * ((e >> 1) & 1);
            const int qp = r0 + 64 * u + 8 * (e / 4) + 2 * t + (e & 1);
            float th;
            const float sv_ = sfn.at<kCap>(st[u][e], &th);
            const float pv =
                !need_mask || admits(p, qp, kp)
                    ? __expf(sv_ - rowv[u][2 * (e / 4) + (e & 1)])
                    : 0.f;
            float gv = pv * p.scale;
            if constexpr (kCap) gv *= 1.f - th * th;
            st[u][e] = pv;
            g_s[(32 * u + e) * 128 + tid] = gv;
          }
      });
      bar_arrive(1);  // G is ready
    } else {
      bar_sync(1);
#pragma unroll
      for (int u = 0; u < NQ; ++u)
#pragma unroll
        for (int e = 0; e < 32; ++e)
          st[u][e] = g_s[(32 * u + e) * 128 + tid] *
                     (st[u][e] - rowv[u][2 * (e / 4) + (e & 1)]);
      if (i + 1 < total) bar_arrive(2);  // G is read
    }
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1): the k16 step 4 u +
    // kk of the QS queries takes blocks 2 kk and 2 kk + 1 of st[u],
    // rounded to bf16
    uint32_t pa[4 * NQ][4];
#pragma unroll
    for (int u = 0; u < NQ; ++u)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[4 * u + kk][r] =
              pack_bf16(st[u][8 * kk + 2 * r], st[u][8 * kk + 2 * r + 1]);
    const uint32_t bt = wg == 0 ? sdo(s) : sq(s);
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NQ; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_rs(acc[c], pa[kk],
                   desc_mnmajor(bt + (c * QS + 16 * kk) * kRow, QS));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
    fence_regs(pa);
    mbar_arrive(empty(s));
  }
  store_rows<NC>(wg == 0 ? p.dv : p.dk, acc, b, kr0, p.S, p.Hkv, hk, p.dh, t);
}

// (c) dq of query rows [128 x, 128 x + 128) of head h, batch b: Q and dO
// load once, kv tiles of KS keys stream through the ring; each consumer
// warpgroup recomputes S and dP for its 64 rows and adds dQ += dS K over
// all of dh.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    q_hw(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tdo,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr uint32_t kQTile = NC * kQb * kRow;  // 128 rows of dh
  constexpr int KS = Tiles<NC>::q_keys;
  constexpr uint32_t kKTile = NC * KS * kRow;  // K or V: KS keys of dh
  constexpr int kS = Tiles<NC>::q;  // ring slots
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = smem_base(smem_raw);
  const uint32_t sdo = sq + kQTile;
  const uint32_t ring = sdo + kQTile;  // slot s: K at 2 s kKTile, V after
  const uint32_t bars = ring + kS * 2 * kKTile;
  const uint32_t qd_full = bars;
  auto full = [&](int s) -> uint32_t { return bars + 8 + 8 * s; };
  auto empty = [&](int s) -> uint32_t { return bars + 8 + 8 * (kS + s); };
  auto sk = [&](int s) -> uint32_t { return ring + 2 * s * kKTile; };
  auto sv = [&](int s) -> uint32_t { return ring + (2 * s + 1) * kKTile; };
  const int n_qt = (p.T + kQb - 1) / kQb;
  int qt, h, b;
  decode(blockIdx.x, p.H, p.B, n_qt, p.causal, &qt, &h, &b);
  const Score sfn = score_of(p);
  const int hk = h / p.group, q0 = qt * kQb;
  int lo, hi;
  kv_range(p, q0, kQb, KS, &lo, &hi);

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qd_full, 2 * kQTile);
      tma_rows<NC>(sq, &tq, qd_full, kQb, h, q0, b);
      tma_rows<NC>(sdo, &tdo, qd_full, kQb, h, q0, b);
      for (int i = 0; i < hi - lo; ++i) {
        const int s = i % kS, k0 = (lo + i) * KS;
        mbar_wait(empty(s), ((i / kS) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kKTile);
        tma_rows<NC>(sk(s), &tk, full(s), KS, hk, k0, b);
        tma_rows<NC>(sv(s), &tv, full(s), KS, hk, k0, b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int tid = threadIdx.x % 128, lane = tid % 32, t = lane % 4;
  const int rq0 = q0 + 64 * wg;
  const int row0 = rq0 + 16 * (tid / 32) + lane / 4;  // and row0 + 8
  int wlo, whi;  // the kv tiles this warpgroup's rows may admit
  kv_range(p, rq0, 64, KS, &wlo, &whi);
  float lse[2], dd[2];
  {
    const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qp = row0 + 8 * hr;
      lse[hr] = qp < p.T ? p.lse[rows + qp] : 0.f;
      dd[hr] = qp < p.T ? p.delta[rows + qp] : 0.f;
    }
  }
  float acc[NC][32];  // dQ
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  const uint32_t q_rows = sq + 64 * wg * kRow, do_rows = sdo + 64 * wg * kRow;
  mbar_wait(qd_full, 0);
  for (int i = 0; i < hi - lo; ++i) {
    const int s = i % kS, j = lo + i, k0 = j * KS;
    mbar_wait(full(s), (i / kS) & 1);
    if (j >= wlo && j < whi) {
      // S = Q K^T and dP = dO V^T
      float sc[KS / 2], dp[KS / 2];
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss(sc, desc_kmajor(q_rows + c * kQb * kRow + 32 * kk),
                   desc_kmajor(sk(s) + c * KS * kRow + 32 * kk), c | kk);
          wgmma_ss(dp, desc_kmajor(do_rows + c * kQb * kRow + 32 * kk),
                   desc_kmajor(sv(s) + c * KS * kRow + 32 * kk), c | kk);
        }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      const bool need_mask = k0 + KS > p.S ||
                             (p.causal && k0 + KS - 1 > rq0) ||
                             (p.window > 0 && rq0 + 63 - k0 >= p.window);
      // element e: row row0 + 8 ((e >> 1) & 1), key k0 + 8 (e / 4) + 2 t +
      // (e & 1)
      by_cap(p, [&](auto cap) {
        constexpr bool kCap = decltype(cap)::value;
#pragma unroll
        for (int e = 0; e < KS / 2; ++e) {
          const int hr = (e >> 1) & 1;
          const int qp = row0 + 8 * hr;
          const int kp = k0 + 8 * (e / 4) + 2 * t + (e & 1);
          float th;
          const float sv_ = sfn.at<kCap>(sc[e], &th);
          float d = __expf(sv_ - lse[hr]) * (dp[e] - dd[hr]);
          if constexpr (kCap) d *= 1.f - th * th;
          dp[e] = !need_mask || admits(p, qp, kp) ? d * p.scale : 0.f;
        }
      });
      // dQ += dS K: dS in bf16 as the A operand (k16 step kk: blocks 2 kk,
      // 2 kk + 1), K read MN-major
      uint32_t da[KS / 16][4];
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_rs(acc[c], da[kk],
                     desc_mnmajor(sk(s) + (c * KS + 16 * kk) * kRow, KS));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      fence_regs(da);
    }
    mbar_arrive(empty(s));
  }
  store_rows<NC>(p.dq, acc, b, row0, p.T, p.H, h, p.dh, t);
}

}  // namespace hw

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

int launch_dh(const Params& p, cudaStream_t s) {
  if (p.dh <= 64) return launch<64>(p, s);
  if (p.dh <= 128) return launch<128>(p, s);
  return launch<256>(p, s);
}

// A contiguous bf16 (batch, rows, heads, dh) tensor as a 4-D map (dh,
// heads, rows, batch) with boxes of 64 dims x 1 head x box_rows rows x 1
// and the 128-byte swizzle; past dh and rows reads 0.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int dh, int heads, int rows, int batch, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t st_h = static_cast<cuuint64_t>(dh) * 2;
  const cuuint64_t strides[3] = {st_h, st_h * heads, st_h * heads * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// NC: 64-wide chunks of dh (dh <= 64 NC).
template <int NC>
int launch_hw(const Params& p, EncodeTiled encode, cudaStream_t s) {
  using S = hw::Tiles<NC>;
  // Q and dO in boxes of 128 rows (the q and prologue blocks) and of the
  // kv kernel's step; K and V in boxes of 64 (the kv and prologue blocks)
  // and of the q kernel's step
  CUtensorMap q128, qkv, do128, dokv, k64, kq, v64, vq;
  CUresult r = make_map(encode, &q128, p.q, p.dh, p.H, p.T, p.B, hw::kQb);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &qkv, p.q, p.dh, p.H, p.T, p.B, S::kv_rows);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &do128, p.dout, p.dh, p.H, p.T, p.B, hw::kQb);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &dokv, p.dout, p.dh, p.H, p.T, p.B, S::kv_rows);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &k64, p.k, p.dh, p.Hkv, p.S, p.B, hw::kKv);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &kq, p.k, p.dh, p.Hkv, p.S, p.B, S::q_keys);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &v64, p.v, p.dh, p.Hkv, p.S, p.B, hw::kKv);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &vq, p.v, p.dh, p.Hkv, p.S, p.B, S::q_keys);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  constexpr long long pro = 1024 + NC * (hw::kQb + S::pro * hw::kKp) *
                                       hw::kRow + 8 * (1 + 2 * S::pro);
  constexpr long long kv =
      1024 + NC * (2 * hw::kKv + 2 * S::kv * S::kv_rows) * hw::kRow +
      S::kv_rows / 2 * 128 * 4 + 8 * (1 + 2 * S::kv);
  constexpr long long qk =
      1024 + NC * (2 * hw::kQb + 2 * S::q * S::q_keys) * hw::kRow +
      8 * (1 + 2 * S::q);
  int err = set_smem(hw::prologue_hw<NC>, pro);
  if (err == 0) err = set_smem(hw::kv_hw<NC>, kv);
  if (err == 0) err = set_smem(hw::q_hw<NC>, qk);
  if (err != 0) return err;
  const unsigned qb =
      static_cast<unsigned>((p.T + hw::kQb - 1) / hw::kQb) * p.H * p.B;
  const unsigned kb =
      static_cast<unsigned>((p.S + hw::kKv - 1) / hw::kKv) * p.Hkv * p.B;
  hw::prologue_hw<NC><<<qb, hw::kThreads, pro, s>>>(q128, k64, p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  hw::kv_hw<NC><<<kb, hw::kThreads, kv, s>>>(qkv, dokv, k64, v64, p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  hw::q_hw<NC><<<qb, hw::kThreads, qk, s>>>(q128, do128, kq, vq, p);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh_hw(const Params& p, cudaStream_t s) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  switch ((p.dh + 63) / 64) {
    case 1: return launch_hw<1>(p, encode, s);
    case 2: return launch_hw<2>(p, encode, s);
    case 3: return launch_hw<3>(p, encode, s);
    default: return launch_hw<4>(p, encode, s);
  }
}

}  // namespace

// q, o, dout, dq (B, T, H, dh); k, v, dk, dv (B, S, Hkv, dh); all
// contiguous, f32 or (bf16 != 0) bf16, bf16 ones 16-byte aligned; scratch
// 2 B H T floats (the rows' lse and D).  softcap <= 0 means none,
// window <= 0 global.  Requires B, T, S, H > 0, H a multiple of Hkv, 1 <=
// dh <= 256 and, in bf16, dh a multiple of 8 (else cudaErrorInvalidValue),
// and every query row admitting a key.  Returns 0, the first failing
// launch's cudaGetLastError(), -1 when libcuda has no
// cuTensorMapEncodeTiled or -(1000 + r) when it refuses a map with
// CUresult r.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* scratch, int B,
    int T, int S, int H, int Hkv, int dh, int causal, int window,
    float scale, float softcap, int bf16, void* stream) {
  if (dh < 1 || dh > 256 || Hkv < 1 || H % Hkv || (bf16 && dh % 8))
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
  return bf16 ? launch_dh_hw(p, s) : launch_dh(p, s);
}
