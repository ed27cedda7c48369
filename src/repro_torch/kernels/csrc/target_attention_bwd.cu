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
// Given dOut (B, N, d) this returns dq (B, N, d), dkeys (B, T, d) and the
// attention MLP's dW1, db1, dW2, db2, dW3, db3.  Nothing of the forward
// is saved: each (b, n, t) pair's a1 and a2 are recomputed here.
//
// The algebra.  W1's row blocks Wq, Wk, Wd, Wp act on q, k, q - k, q*k,
// so with X = [k, q*k] (2d) and Wx = [Wk - Wd; Wp] (2d x h1)
//   z1 = Aq + X Wx,  Aq = q (Wq + Wd) + b1, formed once a candidate;
//   ds = mask <dOut, k>,  dz2 = ds W3 . a2 (1 - a2),
//   dz1 = (dz2 W2^T) . a1 (1 - a1),  P = dz1 Wx^T = [P1, P2] (2d):
//   dkeys[b, t] += P1 + q . P2 + w mask dOut  (one term a candidate),
//   dq = (sum_t dz1) (Wq + Wd)^T + sum_t k . P2,
//   dWk = sum X^T dz1 (its k rows), dWp = its q*k rows,
//   dWq = sum_n q (x) s_n with s_n = sum_t dz1, dWd = dWq - dWk,
//   db1 = sum_n s_n, dW2 = sum a1^T dz2, db2 = sum dz2,
//   dW3 = sum ds a2, db3 = sum ds.
// So per pair there are five products, z1 (2d x h1), z2 (h1 x h2), dz1
// (h2 x h1), P (h1 x 2d) and the weight gradients' X^T dz1 (2d x h1) and
// a1^T dz2 (h1 x h2); the q parts (Aq, dWq and dq's first term) are
// formed once a candidate.
//
// Bound: operations.  chip_smoke.py's attention_bwd_bound counts 6 d h1
// + 6 h1 h2 product flops a pair as 3xTF32 at 495/3 TFLOP/s (with W1's
// blocks folded into one (d, h1) matrix a candidate); this design runs
// 12 d h1 + 6 h1 h2, all of it on the tensor cores, since the fold would
// tie a tile to one candidate.
//
// Design (three launches: prep, pairs, finish):
// - prep: the B fragments of the four per-pair products (Wx, W2, W2^T,
//   Wx^T, zero-padded to d, h1, h2 multiples of 8) in fragment order,
//   (b0, b1) a lane, and Aq + b1 of every candidate, into scratch.
// - pairs (a fixed grid of kBlocks blocks, 512 threads, 16 warps): a
//   block owns a contiguous run of users and walks their pairs in (b, n,
//   t) order, in rounds of up to 128 (8 m16 tiles of 16 pairs, two warps
//   a tile), so at N = 1 a round spans users and every tile is full.  The
//   fragments are staged in shared memory once a block (DIN's widths; at
//   the limits they are read from L2).  A round:
//   1. stages the pairs' keys, mask and candidates (q, dOut, Aq; at most
//      kSlots candidates a round), every load of the keys issued before
//      the first store, and asks L2 for the next round's keys and mask;
//   2. the two warps of a tile run z1, z2 and dz1 on mma.sync m16n8k8 in
//      3xTF32 (each operand split hi = tf32(x), lo = tf32(x - hi) by two
//      integer ops, a_lo b_hi + a_hi b_lo + a_hi b_hi), each warp half of
//      a product's n tiles; a layer's output goes to shared memory (a1,
//      dz2, dz1, needed there by the weight gradients anyway) and, after
//      the pair's named barrier, is the next product's A operand, read as
//      column pairs (2t, 2t + 1 standing for k = t and t + 4; the
//      fragments are stored in that order); w's two halves meet there;
//   3. the weight gradients X^T dz1 and a1^T dz2 as tile products whose
//      k runs over the round's pairs: each warp owns fixed output tiles
//      (15 units of an m16 block and 5 n8 tiles at DIN's widths),
//      a round's chain starts at 0 and is then added to f32 sums held in
//      registers for the block's whole run (the tensor cores' own
//      accumulation drifts over long chains); dW3, db2, db3 go to
//      per-thread sums the same way;
//   4. a tile's warps run P = [P1, P2], one half each, and form its
//      pairs' dkeys (q . P2 + w mask dOut, then + P1) and dq terms;
//   5. dkeys: each (t, c) of a user has one writer, adding the round's
//      candidates' terms in order n to what earlier rounds wrote; each
//      candidate's sum_t dz1 and sum_t k . P2 are summed over each tile's
//      rows, then over its tiles in order (carried across rounds); a
//      candidate whose pairs are done writes its partial dq and s_n.
//   After its rounds the block forms dWq = sum q (x) s_n and db1 =
//   sum s_n over its candidates in order (held in registers only then,
//   which leaves the rounds more), and writes its weight-gradient
//   partial once.
// - finish: sums the kBlocks partials in block order, and adds
//   s_n (Wq + Wd)^T to dq.
// Every sum has a fixed order and no float atomics are used: the same
// inputs give the same bits.  Pairs of a tile whose mask is 0 everywhere
// are skipped (they add exactly 0).  The sigmoids take the fast form of
// the forward (__expf, __fdividef).
//
// Sizes: d <= 64, h1 <= 128, h2 <= 64, as the forward; the register tiles
// are compiled for DIN's d = 36, h1 = 80, h2 = 40 and for the limits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // 16 warps, a pair a 16-pair tile
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 264;   // two a card's SM; fixed, so sums are too
constexpr int kMaxRows = 128;  // pairs a round: 8 tiles of 16
constexpr int kSlots = 16;     // candidates a round, at most
constexpr int kFinCands = 16;  // candidates a finish block

__device__ __forceinline__ float sigmoidf(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// cvt.rna.tf32.f32 by two integer ops (bit-identical for finite values).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(float a0, float a1, float a2,
                                       float a3, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(a0, hi[0], lo[0]);
  split(a1, hi[1], lo[1]);
  split(a2, hi[2], lo[2]);
  split(a3, hi[3], lo[3]);
}

// 8-byte shared-memory accesses of a column pair.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The two warps of tile w meet (named barrier w + 1, 64 threads).
__device__ __forceinline__ void pair_sync(int w) {
  asm volatile("bar.sync %0, 64;" ::"r"(w + 1) : "memory");
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) b (8 x 8, tf32, col).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, a split, b = (b0, b1) in f32.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float2 b) {
  uint32_t h0, l0, h1, l1;
  split(b.x, h0, l0);
  split(b.y, h1, l1);
  mma_tf32(c, al, h0, h1);
  mma_tf32(c, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);
}

// Row strides of 8 mod 16 floats: the fragment walks (rows t, columns g;
// rows g, column pairs 2t) then hit 32 distinct banks.
__host__ __device__ constexpr int ld_of(int x) {
  return x % 16 == 8 ? x : x + 8;
}

__host__ __device__ constexpr int round4(long long x) {
  return static_cast<int>((x + 3) / 4 * 4);
}

template <int KD, int NJ1, int NJ2>
struct Cfg {
  static constexpr int kDp = 8 * KD, kH1p = 8 * NJ1, kH2p = 8 * NJ2;
  static constexpr int kXT = 2 * KD;  // X's k8 steps (and P's n8 tiles)
  static constexpr int kXp = 8 * kXT;
  static constexpr int kLdK = ld_of(kDp), kLdH1 = ld_of(kH1p),
                       kLdH2 = ld_of(kH2p);
  // fragment tiles of z1 (Wx), z2 (W2), dz1 (W2^T) and P (Wx^T)
  static constexpr int kTz1 = kXT * NJ1, kTz2 = NJ1 * NJ2,
                       kTdz1 = NJ2 * NJ1, kTp = NJ1 * kXT;
  static constexpr int kFrag = 64 * (kTz1 + kTz2 + kTdz1 + kTp);  // floats
  // weight-gradient work units: an m16 block and kNU n8 tiles, of
  // X^T dz1 (kXp x kH1p) and of a1^T dz2 (kH1p x kH2p)
  static constexpr int kNU = NJ2;
  static constexpr int kUnitsX = (kXp / 16) * (NJ1 / kNU);
  static constexpr int kUnits = kUnitsX + (kH1p / 16) * (NJ2 / kNU);
  static constexpr int kUpw = (kUnits + kWarps - 1) / kWarps;
  static constexpr int kQU = (kDp * kH1p + kThreads - 1) / kThreads;
  static_assert(NJ1 % kNU == 0 && kH1p % 16 == 0, "unit tiling");
  static_assert(2 * kDp <= kLdH1, "dkeys / dq terms alias a1");
  // the block's end: X^T dz1, a1^T dz2, dWq, db1, 8 warps' dW3 and db2
  static constexpr int kStage = kXp * kH1p + kH1p * kH2p + kDp * kH1p +
                                kH1p + kWarps * (2 * kH2p + 1);
};

// Shared memory of the pair kernel, in floats (each part a multiple of 4).
template <class C>
struct Layout {
  int frag, kbuf, a1, dz1, dz2, q, dout, aq, rmask, rwm, rslot, rn,
      rbt, wpart, tile, b2, w3, carry_s, carry_dq, total;
  __host__ __device__ Layout(int R, bool frag_smem) {
    int o = 0;
    frag = o;  o += frag_smem ? C::kFrag : 0;
    kbuf = o;  o += R * C::kLdK;
    a1 = o;    o += R * C::kLdH1;
    dz1 = o;   o += R * C::kLdH1;
    dz2 = o;   o += R * C::kLdH2;
    q = o;     o += kSlots * C::kLdK;
    dout = o;  o += kSlots * C::kLdK;
    aq = o;    o += kSlots * C::kLdH1;
    rmask = o; o += R;
    rwm = o;   o += R;
    rslot = o; o += R;
    rn = o;    o += R;
    rbt = o;   o += R;
    wpart = o; o += 2 * R;
    tile = o;  o += 2 * (kMaxRows / 16) + 4;
    b2 = o;    o += C::kH2p;
    w3 = o;    o += C::kH2p;
    carry_s = o;  o += C::kH1p;
    carry_dq = o; o += C::kDp;
    total = o;
  }
  // the round's buffers, reused for the block's weight-gradient staging
  __host__ __device__ int round_floats(int R) const {
    return R * (C::kLdK + 2 * C::kLdH1 + C::kLdH2);
  }
};

struct Params {
  const float *dout, *q, *keys, *mask, *w1, *b1, *w2, *b2, *w3, *b3;
  const float* frag;  // prep's fragments (kFrag floats)
  float* aq;          // (B N, kH1p): Aq + b1 from prep, then s_n
  float *dq, *dk, *part;
  int B, N, T, d, h1, h2, R, n_w;
};

// Wx (kXp x kH1p) = [Wk - Wd; Wp] and W2 (kH1p x kH2p), zero-padded.
template <class C>
__device__ float wx_at(const Params& p, int r, int c) {
  if (c >= p.h1) return 0.f;
  if (r < C::kDp) {
    if (r >= p.d) return 0.f;
    return p.w1[(p.d + r) * p.h1 + c] - p.w1[(2 * p.d + r) * p.h1 + c];
  }
  r -= C::kDp;
  return r < p.d ? p.w1[(3 * p.d + r) * p.h1 + c] : 0.f;
}

__device__ float w2_at(const Params& p, int r, int c) {
  return r < p.h1 && c < p.h2 ? p.w2[r * p.h2 + c] : 0.f;
}

// prep: blocks [0, nbf) write the fragments (b0, b1) = (W[8 s + 2 t][8 n +
// g], W[8 s + 2 t + 1][8 n + g]) of each product's k8 step s and n8 tile
// n for lane 4 g + t, at ((s * NT + n) * 32 + lane); the rest write
// aq[c][j] = b1[j] + sum_i q[c][i] (Wq + Wd)[i][j].
template <int KD, int NJ1, int NJ2>
__global__ void __launch_bounds__(kThreads)
    target_attention_bwd_prep_kernel(Params p, float* frag, int nbf,
                                     int n_cand) {
  using C = Cfg<KD, NJ1, NJ2>;
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < nbf) {
    int idx = blockIdx.x * kThreads + tid;
    if (idx >= C::kFrag / 2) return;
    const int lane = idx % 32, g = lane / 4, t = lane % 4;
    int tile = idx / 32;
    float b0, b1;
    if (tile < C::kTz1) {  // z1: Wx, k over X, n over h1
      const int s = tile / NJ1, n = tile % NJ1;
      b0 = wx_at<C>(p, 8 * s + 2 * t, 8 * n + g);
      b1 = wx_at<C>(p, 8 * s + 2 * t + 1, 8 * n + g);
    } else if ((tile -= C::kTz1) < C::kTz2) {  // z2: W2
      const int s = tile / NJ2, n = tile % NJ2;
      b0 = w2_at(p, 8 * s + 2 * t, 8 * n + g);
      b1 = w2_at(p, 8 * s + 2 * t + 1, 8 * n + g);
    } else if ((tile -= C::kTz2) < C::kTdz1) {  // dz1: W2^T
      const int s = tile / NJ1, n = tile % NJ1;
      b0 = w2_at(p, 8 * n + g, 8 * s + 2 * t);
      b1 = w2_at(p, 8 * n + g, 8 * s + 2 * t + 1);
    } else {  // P: Wx^T, k over h1, n over X
      tile -= C::kTdz1;
      const int s = tile / C::kXT, n = tile % C::kXT;
      b0 = wx_at<C>(p, 8 * n + g, 8 * s + 2 * t);
      b1 = wx_at<C>(p, 8 * n + g, 8 * s + 2 * t + 1);
    }
    reinterpret_cast<float2*>(frag)[idx] = make_float2(b0, b1);
    return;
  }
  const long long idx =
      static_cast<long long>(blockIdx.x - nbf) * kThreads + tid;
  if (idx >= static_cast<long long>(n_cand) * C::kH1p) return;
  const long long c = idx / C::kH1p;
  const int j = static_cast<int>(idx % C::kH1p);
  float v = 0.f;
  if (j < p.h1) {
    const float* qc = p.q + c * p.d;
    v = p.b1[j];
    for (int i = 0; i < p.d; ++i)
      v = fmaf(qc[i], p.w1[i * p.h1 + j] + p.w1[(2 * p.d + i) * p.h1 + j], v);
  }
  p.aq[idx] = v;
}

template <int KD, int NJ1, int NJ2, bool kFragSmem>
__global__ void __launch_bounds__(kThreads, 1)
    target_attention_bwd_kernel(Params p) {
  using C = Cfg<KD, NJ1, NJ2>;
  constexpr int kDp = C::kDp, kH1p = C::kH1p, kH2p = C::kH2p;
  constexpr int kXT = C::kXT, kLdK = C::kLdK, kLdH1 = C::kLdH1,
                kLdH2 = C::kLdH2, kNU = C::kNU;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int R = p.R;
  const Layout<C> L(R, kFragSmem);
  float* kbuf = sm + L.kbuf;
  float* a1buf = sm + L.a1;
  float* dz1buf = sm + L.dz1;
  float* dz2buf = sm + L.dz2;
  float* qS = sm + L.q;
  float* doS = sm + L.dout;
  float* aqS = sm + L.aq;
  float* rmask = sm + L.rmask;
  float* rwm = sm + L.rwm;
  int* rslot = reinterpret_cast<int*>(sm + L.rslot);
  int* rn = reinterpret_cast<int*>(sm + L.rn);
  int* rbt = reinterpret_cast<int*>(sm + L.rbt);
  float* wpart = sm + L.wpart;  // (2, R): each half's share of w
  int* tfirst = reinterpret_cast<int*>(sm + L.tile);  // (R / 16,)
  int* tpb = tfirst + kMaxRows / 16;                   // (R / 16 + 1,)
  float* b2s = sm + L.b2;
  float* w3s = sm + L.w3;
  float* carry_s = sm + L.carry_s;
  float* carry_dq = sm + L.carry_dq;
  float* dkt = a1buf;            // (R, kDp) after the weight gradients
  float* dqt = a1buf + R * kDp;  // (R, kDp)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int d = p.d, N = p.N, T = p.T;

  const float2* frag;
  if constexpr (kFragSmem) {
    float4* dst = smem4 + L.frag / 4;
    const float4* src = reinterpret_cast<const float4*>(p.frag);
    for (int i = tid; i < C::kFrag / 4; i += kThreads) dst[i] = src[i];
    frag = reinterpret_cast<const float2*>(sm + L.frag);
  } else {
    frag = reinterpret_cast<const float2*>(p.frag);
  }
  const float2* fz1 = frag;
  const float2* fz2 = fz1 + 32 * C::kTz1;
  const float2* fdz1 = fz2 + 32 * C::kTz2;
  const float2* fp = fdz1 + 32 * C::kTdz1;
  for (int k = tid; k < kH2p; k += kThreads) {
    b2s[k] = k < p.h2 ? p.b2[k] : 0.f;
    w3s[k] = k < p.h2 ? p.w3[k] : 0.f;
  }
  const float bias3 = p.b3[0];

  const long long u_lo = static_cast<long long>(blockIdx.x) * p.B / gridDim.x;
  const long long u_hi =
      static_cast<long long>(blockIdx.x + 1) * p.B / gridDim.x;
  const int NT = N * T;  // the launcher checks a block's pairs fit an int
  const int rows = static_cast<int>(u_hi - u_lo) * NT;
  const long long cbase = u_lo * N;  // the block's first candidate
  const float* kblock = p.keys + u_lo * T * d;  // the block's users' keys

  // the block's weight-gradient sums, for its whole run
  float wacc[C::kUpw][kNU][4];
#pragma unroll
  for (int u = 0; u < C::kUpw; ++u)
#pragma unroll
    for (int j = 0; j < kNU; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) wacc[u][j][e] = 0.f;
  float dw3a[(NJ2 + 1) / 2][2], db2a[(NJ2 + 1) / 2][2];  // this half's
#pragma unroll
  for (int j = 0; j < (NJ2 + 1) / 2; ++j)
    dw3a[j][0] = dw3a[j][1] = db2a[j][0] = db2a[j][1] = 0.f;
  float db3a = 0.f;

  if (T == 0) {  // no pairs: dq and s_n are 0
    const long long nc = (u_hi - u_lo) * N;
    for (long long i = tid; i < nc * d; i += kThreads)
      p.dq[cbase * d + i] = 0.f;
    for (long long i = tid; i < nc * kH1p; i += kThreads)
      p.aq[cbase * kH1p + i] = 0.f;
  }
  __syncthreads();

  int rr = 0;
  for (int r0 = 0; r0 < rows; r0 += rr) {
    // ---- 1. the round: up to R pairs of at most kSlots candidates ----
    const int c0 = r0 / T;  // the block's candidate of slot 0
    rr = min(R, min(rows - r0, (c0 + kSlots) * T - r0));
    const int ntile = (rr + 15) / 16;
    const int nslot = (r0 + rr - 1) / T - c0 + 1;
    const bool cont = c0 * T < r0;  // slot 0 began in an earlier round
    for (int i = tid; i < ntile * 16; i += kThreads) {
      float m = 0.f;
      int sl = 0, n = 0, bt = 0;
      if (i < rr) {
        const int r = r0 + i;
        const int ub = r / NT, t = r % T;
        n = (r / T) % N;
        bt = ub * T + t;  // within the block's users
        m = p.mask[u_lo * T + bt];
        sl = r / T - c0;
      }
      rmask[i] = m;
      rslot[i] = sl;
      rn[i] = n;
      rbt[i] = bt;
    }
    {  // the candidates' q, dOut and Aq: every load before the first store
      constexpr int kW = 2 * kDp + kH1p;
      constexpr int kPer = (kSlots * kW + kThreads - 1) / kThreads;
      float sv[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = tid + kThreads * u, x = idx % kW;
        const long long cg = cbase + c0 + min(idx / kW, nslot - 1);
        sv[u] = x < kDp       ? p.q[cg * d + min(x, d - 1)]
                : x < 2 * kDp ? p.dout[cg * d + min(x - kDp, d - 1)]
                              : p.aq[cg * kH1p + x - 2 * kDp];
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = tid + kThreads * u, s = idx / kW, x = idx % kW;
        if (s < nslot) {
          if (x < kDp)
            qS[s * kLdK + x] = x < d ? sv[u] : 0.f;
          else if (x < 2 * kDp)
            doS[s * kLdK + x - kDp] = x - kDp < d ? sv[u] : 0.f;
          else
            aqS[s * kLdH1 + x - 2 * kDp] = sv[u];
        }
      }
    }
    __syncthreads();
    if (tid == 0) {  // tile w holds candidates tfirst[w] .. (pairs tpb[w]..)
      int pb = 0;
      for (int w = 0; w < ntile; ++w) {
        tfirst[w] = rslot[16 * w];
        tpb[w] = pb;
        pb += rslot[min(16 * w + 15, rr - 1)] - rslot[16 * w] + 1;
      }
      tpb[ntile] = pb;
    }
    {  // the keys: every load issued before the first store
      constexpr int kPer = (kMaxRows * kDp + kThreads - 1) / kThreads;
      float kv[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = tid + kThreads * u, i = idx / kDp, c = idx % kDp;
        // unconditional (a valid key), so that the loads go together
        const float v = __ldg(kblock + static_cast<long long>(
                                           i < rr ? rbt[i] : 0) * d +
                              min(c, d - 1));
        kv[u] = i < rr && c < d ? v : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int idx = tid + kThreads * u, i = idx / kDp, c = idx % kDp;
        if (i < ntile * 16) kbuf[i * kLdK + c] = kv[u];
      }
    }
    {  // the next round's users' keys and mask into L2, while this one runs
      const int nb = r0 + rr;
      if (nb < rows) {
        const int u0 = nb / NT, u1 = min(nb + R - 1, rows - 1) / NT;
        const char* kp = reinterpret_cast<const char*>(
            kblock + static_cast<long long>(u0) * T * d);
        const int kl = ((u1 - u0 + 1) * T * d * 4 + 127) / 128;
        for (int l = tid; l < kl; l += kThreads)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(kp + 128LL * l));
        const char* mp = reinterpret_cast<const char*>(
            p.mask + (u_lo + u0) * T);
        const int ml = ((u1 - u0 + 1) * T * 4 + 127) / 128;
        for (int l = tid; l < ml; l += kThreads)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(mp + 128LL * l));
      }
    }
    __syncthreads();

    // ---- 2. a pair of warps a tile: z1, z2, dz2, dz1, each warp half of
    // each product's n tiles; the halves meet in shared memory ----
    const int tile = warp / 2, hf = warp % 2;
    const int ra = 16 * tile + g, rb = ra + 8;  // this thread's pairs
    constexpr int kJ1 = NJ1 / 2, kJ2 = (NJ2 + 1) / 2;
    const int j1o = hf * kJ1, j2o = hf * kJ2;  // this warp's first n tiles
    if (tile < ntile) {
      const float ma = rmask[ra], mb = rmask[rb];
      if (!__any_sync(0xffffffffu, ma != 0.f || mb != 0.f)) {
        // every pair of the tile masked: it adds exactly 0
        for (int x = t4 + 4 * hf; x < kLdH1 / 2; x += 8) {
          st2(a1buf + ra * kLdH1 + 2 * x, 0.f, 0.f);
          st2(a1buf + rb * kLdH1 + 2 * x, 0.f, 0.f);
          st2(dz1buf + ra * kLdH1 + 2 * x, 0.f, 0.f);
          st2(dz1buf + rb * kLdH1 + 2 * x, 0.f, 0.f);
        }
        for (int x = t4 + 4 * hf; x < kLdH2 / 2; x += 8) {
          st2(dz2buf + ra * kLdH2 + 2 * x, 0.f, 0.f);
          st2(dz2buf + rb * kLdH2 + 2 * x, 0.f, 0.f);
        }
        if (t4 == 0 && hf == 0) rwm[ra] = rwm[rb] = 0.f;
      } else {
        const int sa = rslot[ra], sb = rslot[rb];
        const float* qa = qS + sa * kLdK;
        const float* qb = qS + sb * kLdK;
        const float* ka = kbuf + ra * kLdK;
        const float* kb = kbuf + rb * kLdK;
        // z1 = Aq + [k, q*k] Wx; A columns 2t, 2t + 1 are k = t, t + 4
        float c1[kJ1][4];
#pragma unroll
        for (int j = 0; j < kJ1; ++j) {
          const float2 x = ld2(aqS + sa * kLdH1 + 8 * (j1o + j) + 2 * t4);
          const float2 y = ld2(aqS + sb * kLdH1 + 8 * (j1o + j) + 2 * t4);
          c1[j][0] = x.x;
          c1[j][1] = x.y;
          c1[j][2] = y.x;
          c1[j][3] = y.y;
        }
#pragma unroll
        for (int s = 0; s < KD; ++s) {
          const int o = 8 * s + 2 * t4;
          const float2 k0 = ld2(ka + o);
          const float2 k1 = ld2(kb + o);
          const float2 q0 = ld2(qa + o);
          const float2 q1 = ld2(qb + o);
          uint32_t kh[4], kl[4], ph[4], pl[4];
          split4(k0.x, k1.x, k0.y, k1.y, kh, kl);
          split4(q0.x * k0.x, q1.x * k1.x, q0.y * k0.y, q1.y * k1.y, ph, pl);
#pragma unroll
          for (int j = 0; j < kJ1; ++j) {
            mma3(c1[j], kh, kl, fz1[(s * NJ1 + j1o + j) * 32 + lane]);
            mma3(c1[j], ph, pl, fz1[((KD + s) * NJ1 + j1o + j) * 32 + lane]);
          }
        }
        // a1 into shared memory: z2's A, a1^T dz2 and dz1's factor
#pragma unroll
        for (int j = 0; j < kJ1; ++j) {
          const int o = 8 * (j1o + j) + 2 * t4;
#pragma unroll
          for (int e = 0; e < 4; ++e) c1[j][e] = sigmoidf(c1[j][e]);
          st2(a1buf + ra * kLdH1 + o, c1[j][0], c1[j][1]);
          st2(a1buf + rb * kLdH1 + o, c1[j][2], c1[j][3]);
        }
        pair_sync(tile);
        // z2 = b2 + a1 W2 on this warp's h2 tiles
        float c2[kJ2][4];
#pragma unroll
        for (int j = 0; j < kJ2; ++j) {
          const float2 bb = ld2(b2s + 8 * min(j2o + j, NJ2 - 1) + 2 * t4);
          c2[j][0] = c2[j][2] = bb.x;
          c2[j][1] = c2[j][3] = bb.y;
        }
#pragma unroll
        for (int j = 0; j < NJ1; ++j) {
          const float2 x = ld2(a1buf + ra * kLdH1 + 8 * j + 2 * t4);
          const float2 y = ld2(a1buf + rb * kLdH1 + 8 * j + 2 * t4);
          uint32_t ah[4], al[4];
          split4(x.x, y.x, x.y, y.y, ah, al);
#pragma unroll
          for (int j2 = 0; j2 < kJ2; ++j2)
            if (j2o + j2 < NJ2)
              mma3(c2[j2], ah, al, fz2[(j * NJ2 + j2o + j2) * 32 + lane]);
        }
        // this half's share of w = a2 W3 + b3, and <dOut, k>, over the quad
        float wa = 0.f, wb = 0.f, da = 0.f, dbt = 0.f;
#pragma unroll
        for (int j = 0; j < kJ2; ++j) {
          if (j2o + j < NJ2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) c2[j][e] = sigmoidf(c2[j][e]);
            const float2 v = ld2(w3s + 8 * (j2o + j) + 2 * t4);
            wa += c2[j][0] * v.x + c2[j][1] * v.y;
            wb += c2[j][2] * v.x + c2[j][3] * v.y;
          }
        }
        const float* goa = doS + sa * kLdK;
        const float* gob = doS + sb * kLdK;
#pragma unroll
        for (int s = 0; s < KD; ++s) {
          const int o = 8 * s + 2 * t4;
          const float2 k0 = ld2(ka + o);
          const float2 k1 = ld2(kb + o);
          const float2 g0 = ld2(goa + o);
          const float2 g1 = ld2(gob + o);
          da += g0.x * k0.x + g0.y * k0.y;
          dbt += g1.x * k1.x + g1.y * k1.y;
        }
#pragma unroll
        for (int s = 1; s <= 2; s <<= 1) {
          wa += __shfl_xor_sync(0xffffffffu, wa, s);
          wb += __shfl_xor_sync(0xffffffffu, wb, s);
          da += __shfl_xor_sync(0xffffffffu, da, s);
          dbt += __shfl_xor_sync(0xffffffffu, dbt, s);
        }
        const float dsa = ma * da, dsb = mb * dbt;
        if (t4 == 0) {
          wpart[hf * R + ra] = wa;
          wpart[hf * R + rb] = wb;
        }
        if (hf == 0) db3a += dsa + dsb;
        // dz2 = ds W3 . a2 (1 - a2); dW3 and db2 into this thread's sums
#pragma unroll
        for (int j = 0; j < kJ2; ++j) {
          if (j2o + j < NJ2) {
            const int o = 8 * (j2o + j) + 2 * t4;
            const float2 v = ld2(w3s + o);
            dw3a[j][0] += dsa * c2[j][0] + dsb * c2[j][2];
            dw3a[j][1] += dsa * c2[j][1] + dsb * c2[j][3];
            c2[j][0] = dsa * v.x * (c2[j][0] * (1.f - c2[j][0]));
            c2[j][1] = dsa * v.y * (c2[j][1] * (1.f - c2[j][1]));
            c2[j][2] = dsb * v.x * (c2[j][2] * (1.f - c2[j][2]));
            c2[j][3] = dsb * v.y * (c2[j][3] * (1.f - c2[j][3]));
            db2a[j][0] += c2[j][0] + c2[j][2];
            db2a[j][1] += c2[j][1] + c2[j][3];
            st2(dz2buf + ra * kLdH2 + o, c2[j][0], c2[j][1]);
            st2(dz2buf + rb * kLdH2 + o, c2[j][2], c2[j][3]);
          }
        }
        pair_sync(tile);
        if (hf == 0 && t4 == 0) {
          rwm[ra] = (wpart[ra] + wpart[R + ra] + bias3) * ma;
          rwm[rb] = (wpart[rb] + wpart[R + rb] + bias3) * mb;
        }
        // dz1 = (dz2 W2^T) . a1 (1 - a1) on this warp's h1 tiles
        float c3[kJ1][4];
#pragma unroll
        for (int j = 0; j < kJ1; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) c3[j][e] = 0.f;
#pragma unroll
        for (int j2 = 0; j2 < NJ2; ++j2) {
          const float2 x = ld2(dz2buf + ra * kLdH2 + 8 * j2 + 2 * t4);
          const float2 y = ld2(dz2buf + rb * kLdH2 + 8 * j2 + 2 * t4);
          uint32_t ah[4], al[4];
          split4(x.x, y.x, x.y, y.y, ah, al);
#pragma unroll
          for (int j = 0; j < kJ1; ++j)
            mma3(c3[j], ah, al, fdz1[(j2 * NJ1 + j1o + j) * 32 + lane]);
        }
#pragma unroll
        for (int j = 0; j < kJ1; ++j) {
          const int o = 8 * (j1o + j) + 2 * t4;
          const float2 x = ld2(a1buf + ra * kLdH1 + o);
          const float2 y = ld2(a1buf + rb * kLdH1 + o);
          st2(dz1buf + ra * kLdH1 + o, c3[j][0] * (x.x * (1.f - x.x)),
              c3[j][1] * (x.y * (1.f - x.y)));
          st2(dz1buf + rb * kLdH1 + o, c3[j][2] * (y.x * (1.f - y.x)),
              c3[j][3] * (y.y * (1.f - y.y)));
        }
      }
    }
    __syncthreads();

    // ---- 3. the weight gradients over the round's pairs ----
    const int nks = 2 * ntile;  // k8 steps
#pragma unroll
    for (int uu = 0; uu < C::kUpw; ++uu) {
      const int u = warp + kWarps * uu;
      if (u < C::kUnits) {
        const bool xu = u < C::kUnitsX;
        int mb, j0;
        if (xu) {
          mb = u / (NJ1 / kNU);
          j0 = (u % (NJ1 / kNU)) * kNU;
        } else {
          mb = (u - C::kUnitsX) / (NJ2 / kNU);
          j0 = ((u - C::kUnitsX) % (NJ2 / kNU)) * kNU;
        }
        const float* bop = xu ? dz1buf : dz2buf;
        const int ldb = xu ? kLdH1 : kLdH2;
        const int m0 = 16 * mb + g, m1 = m0 + 8;
        float cr[kNU][4];
#pragma unroll
        for (int j = 0; j < kNU; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cr[j][e] = 0.f;
        for (int s = 0; s < nks; ++s) {
          const int r0l = 8 * s + t4, r1l = r0l + 4;
          float a[4];
          if (xu) {  // X[row][m]: k, or q * k past kDp
            const int rs[4] = {r0l, r0l, r1l, r1l};
            const int ms[4] = {m0, m1, m0, m1};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int m = ms[e], row = rs[e];
              const bool kp = m < kDp;
              const int c = kp ? m : m - kDp;
              const float kv = kbuf[row * kLdK + c];
              a[e] = kp ? kv : kv * qS[rslot[row] * kLdK + c];
            }
          } else {
            a[0] = a1buf[r0l * kLdH1 + m0];
            a[1] = a1buf[r0l * kLdH1 + m1];
            a[2] = a1buf[r1l * kLdH1 + m0];
            a[3] = a1buf[r1l * kLdH1 + m1];
          }
          uint32_t ah[4], al[4];
          split4(a[0], a[1], a[2], a[3], ah, al);
#pragma unroll
          for (int j = 0; j < kNU; ++j) {
            const int col = 8 * (j0 + j) + g;
            mma3(cr[j], ah, al,
                 make_float2(bop[r0l * ldb + col], bop[r1l * ldb + col]));
          }
        }
#pragma unroll
        for (int j = 0; j < kNU; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) wacc[uu][j][e] += cr[j][e];
      }
    }
    __syncthreads();  // a1 is consumed: dkt and dqt take its place

    // ---- 4. P = dz1 Wx^T, the pairs' dkeys and dq terms: warp 0 of a
    // pair P1 (the k part), warp 1 P2 (the q*k part) ----
    if (tile < ntile) {
      const int sa = rslot[ra], sb = rslot[rb];
      float pc[KD][4];
#pragma unroll
      for (int j = 0; j < KD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pc[j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ1; ++j) {
        const int o = 8 * j + 2 * t4;
        const float2 x = ld2(dz1buf + ra * kLdH1 + o);
        const float2 y = ld2(dz1buf + rb * kLdH1 + o);
        uint32_t ah[4], al[4];
        split4(x.x, y.x, x.y, y.y, ah, al);
#pragma unroll
        for (int jj = 0; jj < KD; ++jj)
          mma3(pc[jj], ah, al, fp[(j * kXT + hf * KD + jj) * 32 + lane]);
      }
      if (hf == 1) {  // q . P2 + w mask dOut, and k . P2
        const float wma = rwm[ra], wmb = rwm[rb];
#pragma unroll
        for (int jj = 0; jj < KD; ++jj) {
          const int o = 8 * jj + 2 * t4;
          const float2 qa = ld2(qS + sa * kLdK + o);
          const float2 qb = ld2(qS + sb * kLdK + o);
          const float2 ga = ld2(doS + sa * kLdK + o);
          const float2 gb = ld2(doS + sb * kLdK + o);
          const float2 ka = ld2(kbuf + ra * kLdK + o);
          const float2 kb = ld2(kbuf + rb * kLdK + o);
          st2(dkt + ra * kDp + o, qa.x * pc[jj][0] + wma * ga.x,
              qa.y * pc[jj][1] + wma * ga.y);
          st2(dkt + rb * kDp + o, qb.x * pc[jj][2] + wmb * gb.x,
              qb.y * pc[jj][3] + wmb * gb.y);
          st2(dqt + ra * kDp + o, ka.x * pc[jj][0], ka.y * pc[jj][1]);
          st2(dqt + rb * kDp + o, kb.x * pc[jj][2], kb.y * pc[jj][3]);
        }
      }
      pair_sync(tile);
      if (hf == 0) {  // + P1
#pragma unroll
        for (int jj = 0; jj < KD; ++jj) {
          const int o = 8 * jj + 2 * t4;
          const float2 x = ld2(dkt + ra * kDp + o);
          const float2 y = ld2(dkt + rb * kDp + o);
          st2(dkt + ra * kDp + o, x.x + pc[jj][0], x.y + pc[jj][1]);
          st2(dkt + rb * kDp + o, y.x + pc[jj][2], y.y + pc[jj][3]);
        }
      }
    }
    __syncthreads();

    // ---- 5. dkeys, and each candidate's sums over its pairs ----
    for (int idx = tid; idx < rr * d; idx += kThreads) {
      const int i = idx / d, c = idx - i * d;
      const int n = rn[i];
      if (n > 0 && i >= T) continue;  // an earlier row of the round adds it
      float* dst = p.dk + (u_lo * T + rbt[i]) * d + c;
      float acc = n == 0 ? 0.f : *dst;
      for (int i2 = i, n2 = n; i2 < rr && n2 < N; i2 += T, ++n2)
        acc += dkt[i2 * kDp + c];
      *dst = acc;
    }
    // s_n into aqS and sum_t k . P2 into doS (both consumed), in two
    // fixed-order levels: first each (tile, candidate) pair's rows into
    // part (dz2's place, consumed), then each candidate's pairs in tile
    // order.  Tile w holds candidates rslot[16 w] .. rslot[last row].
    constexpr int kW = kH1p + kDp;
    float* part = dz2buf;
    for (int idx = tid; idx < tpb[ntile] * kW; idx += kThreads) {
      const int pr = idx / kW, x = idx % kW;
      int w = 0;
      while (w + 1 < ntile && tpb[w + 1] <= pr) ++w;  // the pair's tile
      const int sl = tfirst[w] + pr - tpb[w];
      const int lo = max(16 * w, (c0 + sl) * T - r0);
      const int hi = min(min(16 * w + 16, rr), (c0 + sl + 1) * T - r0);
      float acc = 0.f;
      if (x < kH1p)
        for (int i = lo; i < hi; ++i) acc += dz1buf[i * kLdH1 + x];
      else
        for (int i = lo; i < hi; ++i) acc += dqt[i * kDp + x - kH1p];
      part[pr * kW + x] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < nslot * kW; idx += kThreads) {
      const int sl = idx / kW, x = idx % kW;
      const int lo = max(0, (c0 + sl) * T - r0);
      const int hi = min(rr, (c0 + sl + 1) * T - r0);
      float acc = sl == 0 && cont ? (x < kH1p ? carry_s[x]
                                              : carry_dq[x - kH1p])
                                  : 0.f;
      for (int w = lo / 16; w <= (hi - 1) / 16; ++w)
        acc += part[(tpb[w] + sl - tfirst[w]) * kW + x];
      if (x < kH1p)
        aqS[sl * kLdH1 + x] = acc;
      else
        doS[sl * kLdK + x - kH1p] = acc;
    }
    __syncthreads();
    // candidates whose pairs are done; the last one may go on
    const bool last_done = (c0 + nslot) * T <= r0 + rr;
    const int ndone = last_done ? nslot : nslot - 1;
    for (int idx = tid; idx < ndone * kH1p; idx += kThreads) {
      const int s = idx / kH1p, j = idx % kH1p;
      p.aq[(cbase + c0 + s) * kH1p + j] = aqS[s * kLdH1 + j];
    }
    for (int idx = tid; idx < ndone * d; idx += kThreads) {
      const int s = idx / d, c = idx - s * d;
      p.dq[(cbase + c0 + s) * d + c] = doS[s * kLdK + c];
    }
    if (!last_done) {
      for (int x = tid; x < kH1p; x += kThreads)
        carry_s[x] = aqS[(nslot - 1) * kLdH1 + x];
      for (int c = tid; c < kDp; c += kThreads)
        carry_dq[c] = doS[(nslot - 1) * kLdK + c];
    }
    __syncthreads();
  }

  // ---- dWq and db1 from the block's candidates' s_n, in order ----
  float dwq[C::kQU], db1a = 0.f;
#pragma unroll
  for (int u = 0; u < C::kQU; ++u) dwq[u] = 0.f;
  {
    float* qc = sm + L.kbuf;          // (64, kDp)
    float* sc = qc + 64 * kDp;        // (64, kH1p)
    const long long nc = (u_hi - u_lo) * N;
    for (long long c0b = 0; c0b < nc; c0b += 64) {
      const int m = static_cast<int>(nc - c0b < 64 ? nc - c0b : 64);
      for (int x = tid; x < m * kDp; x += kThreads) {
        const int c = x / kDp, i = x % kDp;
        qc[x] = i < d ? p.q[(cbase + c0b + c) * d + i] : 0.f;
      }
      for (int x = tid; x < m * kH1p; x += kThreads)
        sc[x] = p.aq[(cbase + c0b) * kH1p + x];
      __syncthreads();
      for (int c = 0; c < m; ++c) {
        if (tid < kH1p) db1a += sc[c * kH1p + tid];
#pragma unroll
        for (int u = 0; u < C::kQU; ++u) {
          const int e = tid + kThreads * u;
          if (e < kDp * kH1p)
            dwq[u] = fmaf(qc[c * kDp + e / kH1p], sc[c * kH1p + e % kH1p],
                          dwq[u]);
        }
      }
      __syncthreads();
    }
  }

  // ---- the block's weight-gradient partial, written once ----
  float* stx = sm + L.kbuf;            // X^T dz1 (kXp, kH1p)
  float* st2 = stx + C::kXp * kH1p;    // a1^T dz2 (kH1p, kH2p)
  float* stq = st2 + kH1p * kH2p;      // dWq (kDp, kH1p)
  float* stb1 = stq + kDp * kH1p;      // db1 (kH1p)
  float* stw3 = stb1 + kH1p;           // [warp][kH2p]
  float* stb2 = stw3 + kWarps * kH2p;  // [warp][kH2p]
  float* stb3 = stb2 + kWarps * kH2p;  // [warp]
#pragma unroll
  for (int uu = 0; uu < C::kUpw; ++uu) {
    const int u = warp + kWarps * uu;
    if (u < C::kUnits) {
      const bool xu = u < C::kUnitsX;
      int mb, j0, width;
      float* dst;
      if (xu) {
        mb = u / (NJ1 / kNU);
        j0 = (u % (NJ1 / kNU)) * kNU;
        dst = stx;
        width = kH1p;
      } else {
        mb = (u - C::kUnitsX) / (NJ2 / kNU);
        j0 = ((u - C::kUnitsX) % (NJ2 / kNU)) * kNU;
        dst = st2;
        width = kH2p;
      }
#pragma unroll
      for (int j = 0; j < kNU; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mb + g + 8 * (e / 2);
          const int col = 8 * (j0 + j) + 2 * t4 + (e % 2);
          dst[row * width + col] = wacc[uu][j][e];
        }
    }
  }
#pragma unroll
  for (int u = 0; u < C::kQU; ++u) {
    const int e = tid + kThreads * u;
    if (e < kDp * kH1p) stq[e] = dwq[u];
  }
  if (tid < kH1p) stb1[tid] = db1a;
  // dW3, db2 and db3 over the rows g of the warp (lanes 4 g + t4); a
  // warp holds its half's h2 columns, the others stay 0
  for (int x = lane; x < kH2p; x += 32)
    stw3[warp * kH2p + x] = stb2[warp * kH2p + x] = 0.f;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < (NJ2 + 1) / 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = dw3a[j][e], b = db2a[j][e];
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, s);
        b += __shfl_xor_sync(0xffffffffu, b, s);
      }
      const int jg = (warp % 2) * ((NJ2 + 1) / 2) + j;
      if (g == 0 && jg < NJ2) {
        stw3[warp * kH2p + 8 * jg + 2 * t4 + e] = a;
        stb2[warp * kH2p + 8 * jg + 2 * t4 + e] = b;
      }
    }
#pragma unroll
  for (int s = 4; s < 32; s <<= 1)
    db3a += __shfl_xor_sync(0xffffffffu, db3a, s);
  if (lane == 0) stb3[warp] = db3a;
  __syncthreads();

  const int h1 = p.h1, h2 = p.h2;
  const int o_db1 = 4 * d * h1, o_dw2 = o_db1 + h1;
  const int o_db2 = o_dw2 + h1 * h2, o_dw3 = o_db2 + h2, o_db3 = o_dw3 + h2;
  float* my = p.part + static_cast<long long>(blockIdx.x) * p.n_w;
  for (int e = tid; e < p.n_w; e += kThreads) {
    float v;
    if (e < o_db1) {
      const int r = e / h1, j = e - r * h1;
      const int blk = r / d, i = r - blk * d;
      const float gk = stx[i * kH1p + j];
      if (blk == 0) v = stq[i * kH1p + j];
      else if (blk == 1) v = gk;
      else if (blk == 2) v = stq[i * kH1p + j] - gk;
      else v = stx[(kDp + i) * kH1p + j];
    } else if (e < o_dw2) {
      v = stb1[e - o_db1];
    } else if (e < o_db2) {
      const int i = (e - o_dw2) / h2, j = (e - o_dw2) - i * h2;
      v = st2[i * kH2p + j];
    } else if (e < o_dw3) {
      v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += stb2[w * kH2p + e - o_db2];
    } else if (e < o_db3) {
      v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += stw3[w * kH2p + e - o_dw3];
    } else {
      v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += stb3[w];
    }
    my[e] = v;
  }
}

// finish: blocks [0, nbw) sum the G partials in block order into dw;
// the rest add s_n (Wq + Wd)^T to dq, kFinCands candidates a block.
__global__ void __launch_bounds__(kThreads)
    target_attention_bwd_finish_kernel(const float* __restrict__ part,
                                       float* __restrict__ dw, int n_w,
                                       int G, int nbw,
                                       const float* __restrict__ s,
                                       int h1p, const float* __restrict__ w1,
                                       float* __restrict__ dq, long long n_cand,
                                       int d, int h1) {
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < nbw) {
    const int e = blockIdx.x * kThreads + tid;
    if (e >= n_w) return;
    float acc = 0.f;
    for (int b = 0; b < G; ++b)
      acc += part[static_cast<long long>(b) * n_w + e];
    dw[e] = acc;
    return;
  }
  extern __shared__ float fs[];
  const int ld = h1 | 1;  // odd: a walk over i is free of bank conflicts
  float* wqd = fs;            // (d, ld)
  float* ss = fs + d * ld;    // (kFinCands, ld)
  const long long c0 = static_cast<long long>(blockIdx.x - nbw) * kFinCands;
  const int nc = static_cast<int>(n_cand - c0 < kFinCands ? n_cand - c0
                                                          : kFinCands);
  for (int idx = tid; idx < d * h1; idx += kThreads) {
    const int i = idx / h1, j = idx - i * h1;
    wqd[i * ld + j] = w1[i * h1 + j] + w1[(2 * d + i) * h1 + j];
  }
  for (int idx = tid; idx < nc * h1; idx += kThreads) {
    const int c = idx / h1, j = idx - c * h1;
    ss[c * ld + j] = s[(c0 + c) * h1p + j];
  }
  __syncthreads();
  for (int idx = tid; idx < nc * d; idx += kThreads) {
    const int c = idx / d, i = idx - c * d;
    float acc = 0.f;
    for (int j = 0; j < h1; ++j)
      acc = fmaf(ss[c * ld + j], wqd[i * ld + j], acc);
    dq[(c0 + c) * d + i] += acc;
  }
}

struct Shape {
  int kd, nj1, nj2;
};

Shape shape_for(int d, int h1, int h2) {
  const int kd = (d + 7) / 8, nj1 = (h1 + 7) / 8, nj2 = (h2 + 7) / 8;
  if (kd <= 5 && nj1 <= 10 && nj2 <= 5) return {5, 10, 5};
  return {8, 16, 8};
}

int grid_for(int B) { return B < kBlocks ? B : kBlocks; }

int n_w_of(int d, int h1, int h2) {
  return 4 * d * h1 + h1 + h1 * h2 + 2 * h2 + 1;
}

// Scratch, in floats: the G partials, the fragments, aq.
struct Scratch {
  long long part, frag, aq, total;
  Scratch(int B, int N, int d, int h1, int h2) {
    const Shape s = shape_for(d, h1, h2);
    const int n_w = n_w_of(d, h1, h2);
    const long long frag_f = 64LL * (4 * s.kd * s.nj1 + 2 * s.nj1 * s.nj2);
    part = 0;
    frag = round4(static_cast<long long>(grid_for(B)) * n_w);
    aq = frag + frag_f;
    total = aq + static_cast<long long>(B) * N * 8 * s.nj1;
  }
};

template <int KD, int NJ1, int NJ2, bool kFragSmem>
int launch(Params p, float* dw, float* scratch, const Scratch& sc, int G,
           long long max_optin, cudaStream_t st) {
  using C = Cfg<KD, NJ1, NJ2>;
  // the largest round (a multiple of 16 pairs) whose shared memory fits
  // and whose buffers can hold the candidates' partial sums (in dz2's),
  // 64 candidates' q and s_n and the block's weight gradients
  int R = kMaxRows;
  for (; R >= 16; R -= 16) {
    const Layout<C> L(R, kFragSmem);
    if (4LL * L.total <= max_optin && L.round_floats(R) >= C::kStage &&
        L.round_floats(R) >= 64 * (C::kDp + C::kH1p) &&
        (kSlots + R / 16) * (C::kH1p + C::kDp) <= R * C::kLdH2)
      break;
  }
  if (R < 16) return static_cast<int>(cudaErrorInvalidValue);
  p.R = R;
  const long long n_cand = static_cast<long long>(p.B) * p.N;
  // prep
  const int nbf = (C::kFrag / 2 + kThreads - 1) / kThreads;
  const long long nba = (n_cand * C::kH1p + kThreads - 1) / kThreads;
  if (nbf + nba > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  target_attention_bwd_prep_kernel<KD, NJ1, NJ2>
      <<<static_cast<unsigned>(nbf + nba), kThreads, 0, st>>>(
          p, scratch + sc.frag, nbf, static_cast<int>(n_cand));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // pairs
  const size_t smem = 4 * static_cast<size_t>(Layout<C>(R, kFragSmem).total);
  auto* kern = target_attention_bwd_kernel<KD, NJ1, NJ2, kFragSmem>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<G, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // finish
  const int nbw = (p.n_w + kThreads - 1) / kThreads;
  const long long nbq = (n_cand + kFinCands - 1) / kFinCands;
  if (nbw + nbq > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t fsmem = 4 * static_cast<size_t>((p.d + kFinCands) * (p.h1 | 1));
  target_attention_bwd_finish_kernel<<<static_cast<unsigned>(nbw + nbq),
                                       kThreads, fsmem, st>>>(
      p.part, dw, p.n_w, G, nbw, p.aq, C::kH1p, p.w1, p.dq,
      n_cand, p.d, p.h1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch the launch needs: one weight-gradient partial a
// block, the B fragments and a (h1,) row a candidate.
extern "C" long long target_attention_bwd_scratch_floats(int B, int N, int d,
                                                         int h1, int h2) {
  return Scratch(B, N, d, h1, h2).total;
}

// dout, q (B, N, d), keys (B, T, d), mask (B, T), the MLP as in the
// forward, all contiguous f32.  Writes dq (B, N, d), dkeys (B, T, d) and
// the weight gradients, concatenated in the order dW1, db1, dW2, db2,
// dW3, db3, to dw (nW floats); scratch holds
// target_attention_bwd_scratch_floats.  Needs B, N > 0.
extern "C" int target_attention_bwd_launch(
    const float* dout, const float* q, const float* keys, const float* mask,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* w3, const float* b3, float* dq, float* dk, float* dw,
    float* scratch, int B, int N, int T, int d, int h1, int h2,
    void* stream) {
  if (d > 64 || h1 > 128 || h2 > 64 || B <= 0 || N <= 0 || T < 0 ||
      d <= 0 || h1 <= 0 || h2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Scratch sc(B, N, d, h1, h2);
  const int G = grid_for(B);
  // a block's pairs are counted in int
  if (((B + G - 1LL) / G * N + kSlots) * T >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{dout, q, keys, mask, w1, b1, w2, b2, w3, b3,
           scratch + sc.frag, scratch + sc.aq, dq, dk, scratch + sc.part,
           B, N, T, d, h1, h2, 0, n_w_of(d, h1, h2)};
  const auto st = static_cast<cudaStream_t>(stream);
  const Shape s = shape_for(d, h1, h2);
  if (s.kd == 5)
    return launch<5, 10, 5, true>(p, dw, scratch, sc, G, max_optin, st);
  return launch<8, 16, 8, false>(p, dw, scratch, sc, G, max_optin, st);
}
