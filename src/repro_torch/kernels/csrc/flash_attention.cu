// Flash attention in f32: q (B, T, H, dh), k/v (B, S, Hkv, dh) -> (B, T,
// H, dh) f32, with GQA (kv head h / (H / Hkv)), a scale, an optional tanh
// softcap c * tanh(s / c), the mask k_pos < S, causal (k_pos <= q_pos,
// both counted from 0) and a sliding window (q_pos - k_pos < window when
// window > 0).  Any dh in [1, 256]; only dh must be contiguous.  bf16
// calls run flash_attention_wgmma.cu instead.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention), the self-attention of models/lm.py.  Its grid runs
// the kv blocks of one (batch, head, q block) in order on one core,
// carrying the online-softmax state in VMEM scratch.  Here one block owns
// a 64-row q tile of one (batch, head) and walks the kv tiles in a loop
// of its own.
//
// Bound: operations.  A (query, key) pair costs 4 * dh flops (QK^T and
// PV) against 2 * dh values of k and v that every q tile of the head
// shares, so at T = S = 8k, dh = 256 the work is some 500 flops a byte.
// Both products run on the tensor cores in 3xTF32: each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna's rounding), and
// a_lo b_hi + a_hi b_lo + a_hi b_hi is summed in f32.  One TF32 pass
// would miss the 2e-5 gate; three meet it (tests/test_torch_tf32x3.py
// emulates both on the CPU).  Softmax, rescaling and the softcap stay in
// f32 on the CUDA cores: the softcap with the exact tanhf (tanh.approx
// brought the error close to the gate), the softmax with __expf
// (ex2.approx, whose error stays far inside it).
//
// Why mma.sync m16n8k8 and not wgmma: TF32 wgmma reads B from shared
// memory only K-major, which suits K (dh contiguous) but not V, whose
// reduction runs over keys; and its operands' hi and lo halves at
// dh = 256 (Q's as A, K's and V's as B) would not fit shared memory and
// registers beside each other.  mma.sync takes hand-loaded fragments in
// any layout, so the tiles stay f32 as they are stored, and each warp
// splits the fragments it loads.  Its TF32 rate is well below
// wgmma's.
//
// Design (256 threads, 8 warps; one block an SM at dh = 256):
// - Shared memory holds the block's Q tile (64 rows) and one K and one V
//   tile (64 keys each), f32, rows padded with zeros to dh rounded up to
//   32, plus 4 floats (so ldmatrix phases and the V fragment loads hit
//   distinct banks): 199,680 bytes at dh = 256.  They arrive by cp.async, 16
//   bytes a copy where dh, the strides and the bases allow it and 4
//   bytes otherwise, zero-filled past dh, T and S.  K and V have buffers
//   of their own, so the next K lands during this tile's softmax and PV,
//   and the next V during the next QK^T.  Tiles wholly above the
//   diagonal or outside the window are never loaded.
// - Warp (r, h) owns q rows 16 r .. 16 r + 15 and keys 32 h .. 32 h + 31
//   of every kv tile, and keeps an online softmax (max, sum, the 16 x dh
//   output in registers: 128 a thread at dh = 256) of its own; the two
//   halves are merged once at the end.
// - S = Q K^T: one ldmatrix.x4 gives a k8 step's A fragment of Q, and
//   two give the B fragments of four n8 tiles of K (the same mapping as
//   dot_interact.cu: f32 rows read as b16 pairs).  The tensor cores add
//   with less than f32's precision, so long chains drift: every 8 k8
//   steps the chains (the cross terms in one, a_hi b_hi in another, so
//   that more mma are in flight) are promoted into an f32 sum.
// - P is the A operand of PV straight from the S accumulator: its
//   columns 2t and 2t + 1 stand for k = t and t + 4, and the V fragment
//   is loaded from those keys' rows (two 4-byte loads).  PV runs one
//   dh n8 tile at a time, 4 k8 steps (12 mma, in the same two chains)
//   from zero, and is promoted into the output as O = alpha O + PV, the
//   online softmax's rescale.
// - q tiles start in reverse order, so the longest causal walks go first.
// - Masked scores are -1e30, not -inf: a row that has seen no admitted
//   key yet weighs its masked keys equally until one arrives, which then
//   rescales them to 0 (flash_attention_wgmma.cu does the same).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block, 16 a row group
constexpr int kBK = 64;         // keys per kv tile, 32 a key half
constexpr int kThreads = 256;   // 8 warps: 4 row groups x 2 key halves
constexpr int kPromote = 8;     // k8 steps per QK^T tensor-core chain,
constexpr int kRun = 4;         // in runs of 4 (rows are padded to 32)
constexpr float kNegInf = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_st, q_sh;  // element strides of (B, T, H); dh is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  int T, S, group, dh, n_qt, causal, window;
  int vec_q, vec_k, vec_v;  // 16-byte copies allowed
  float scale, softcap;     // softcap <= 0: none
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// cvt.rna.tf32.f32 by integer ops (two instructions; the cvt itself adds
// a guard for NaN, which only NaNs with a payload in the low 13 bits
// need): add half of the 13 dropped bits' range to the magnitude, then
// clear them.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + (what neither keeps): hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
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

// Rows [r0, r0 + 64) of one head into dst (64, ld) by cp.async, zero past
// the last row n and past dh (up to the padded width dh_pad).
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long base,
                                          long long row_stride, int r0, int n,
                                          int dh, int dh_pad, bool vec) {
  if (vec) {
    const int per_row = dh_pad / 4;
    for (int idx = threadIdx.x; idx < kBQ * per_row; idx += kThreads) {
      const int r = idx / per_row, c = 4 * (idx - r * per_row);
      const int row = r0 + r;
      const bool valid = row < n && c < dh;
      const float* from = src + base + (valid ? row * row_stride + c : 0);
      cp_async16(smem_addr(dst + r * ld + c), from, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBQ * dh_pad; idx += kThreads) {
      const int r = idx / dh_pad, d = idx - r * dh_pad;
      const int row = r0 + r;
      const bool valid = row < n && d < dh;
      const float* from = src + base + (valid ? row * row_stride + d : 0);
      cp_async4(smem_addr(dst + r * ld + d), from, valid);
    }
  }
}

// NT: n8 tiles of dh a warp's output holds (dh rounded up to 8 <= 8 NT).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // rows padded with zeros to whole runs of 4 k8 steps (32 floats)
  const int dh = p.dh, dh_pad = (dh + 31) & ~31, ld = dh_pad + 4;
  const int n_dt = (dh + 7) / 8;  // n8 tiles of the output in use
  float* q_s = smem;              // (64, ld)
  float* k_s = q_s + kBQ * ld;    // (64, ld)
  float* v_s = k_s + kBK * ld;    // (64, ld)

  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;

  // the kv tiles any row of this q tile can see
  const int q_last = min(q0 + kBQ, p.T) - 1;
  int k_end = p.S;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  k_begin = k_begin / kBK * kBK;

  const long long k_base = b * p.k_sb + hk * p.k_sh;
  const long long v_base = b * p.v_sb + hk * p.v_sh;

  load_tile(q_s, ld, p.q, b * p.q_sb + h * p.q_sh, p.q_st, q0, p.T, dh,
            dh_pad, p.vec_q);
  if (k_begin < k_end)
    load_tile(k_s, ld, p.k, k_base, p.k_ss, k_begin, p.S, dh, dh_pad,
              p.vec_k);
  cp_async_commit();
  if (k_begin < k_end)
    load_tile(v_s, ld, p.v, v_base, p.v_ss, k_begin, p.S, dh, dh_pad,
              p.vec_v);
  cp_async_commit();

  float o[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nd = 0; nd < NT; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  // ldmatrix rows: lane & 15, at float column 4 (lane >> 4) of a k8 step
  const int lrow = lane & 15, lcol = (lane >> 4) * 4;
  const uint32_t q_addr = smem_addr(q_s + (16 * rg + lrow) * ld + lcol);
  const uint32_t k_addr = smem_addr(k_s + (32 * half + lrow) * ld + lcol);
  const uint32_t k_pair = 16 * ld * 4;  // bytes to the next 16 keys
  const float* v_row = v_s + (32 * half + 2 * t) * ld + g;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    cp_async_wait<1>();  // K of this tile (and Q) landed
    __syncthreads();

    // s: 16 rows x 32 keys; tile j holds keys 8 j + 2 t (+1) of rows g,
    // g + 8 (c = 0, 1 and 2, 3)
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int ks0 = 0; ks0 < dh_pad / 8; ks0 += kPromote) {
      // the cross terms and the main term in chains of their own
      float cx[4][4], cm[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cx[j][e] = cm[j][e] = 0.f;
#pragma unroll
      for (int u = 0; u < kPromote; ++u) {
        const int ks = ks0 + u;
        if (u % kRun == 0 && ks >= dh_pad / 8) break;  // a whole run or none
        uint32_t a[4], kb[2][4], ah[4], al[4], bh[2][4], bl[2][4];
        ldsm_x4(a, q_addr + 32 * ks);
        ldsm_x4(kb[0], k_addr + 32 * ks);
        ldsm_x4(kb[1], k_addr + k_pair + 32 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split(__uint_as_float(a[e]), ah[e], al[e]);
          split(__uint_as_float(kb[0][e]), bh[0][e], bl[0][e]);
          split(__uint_as_float(kb[1][e]), bh[1][e], bl[1][e]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pr = j >> 1, od = j & 1;
          mma_tf32(cx[j], al, bh[pr][od], bh[pr][2 + od]);
          mma_tf32(cx[j], ah, bl[pr][od], bl[pr][2 + od]);
          mma_tf32(cm[j], ah, bh[pr][od], bh[pr][2 + od]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += cx[j][e] + cm[j][e];
    }
    __syncthreads();  // every warp is done with this K
    if (k0 + kBK < k_end)
      load_tile(k_s, ld, p.k, k_base, p.k_ss, k0 + kBK, p.S, dh, dh_pad,
                p.vec_k);
    cp_async_commit();

    // scale, softcap, mask, then the online softmax of rows g and g + 8;
    // a row's 32 keys lie in the 4 lanes of a quad
    const float inv_cap = 1.f / p.softcap;
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q_pos = q0 + 16 * rg + g + 8 * r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k_pos = k0 + 32 * half + 8 * j + 2 * t + e;
          float x = s[j][2 * r + e] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x * inv_cap);
          bool ok = k_pos < p.S;
          if (p.causal) ok = ok && k_pos <= q_pos;
          if (p.window > 0) ok = ok && (q_pos - k_pos) < p.window;
          x = ok ? x : kNegInf;
          s[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = __expf(s[j][2 * r + e] - m_new);
          s[j][2 * r + e] = pe;
          rs += pe;
        }
      alpha[r] = __expf(m[r] - m_new);
      l[r] = alpha[r] * l[r] + rs;  // this lane's keys; quad-summed at the end
      m[r] = m_new;
    }
    // P as the A fragments of PV's k8 steps j: a0 (row g, k t) = key 2t,
    // a2 (row g, k t + 4) = key 2t + 1, a1 and a3 the same for row g + 8
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split(s[j][0], ph[j][0], pl[j][0]);
      split(s[j][2], ph[j][1], pl[j][1]);
      split(s[j][1], ph[j][2], pl[j][2]);
      split(s[j][3], ph[j][3], pl[j][3]);
    }

    cp_async_wait<1>();  // V of this tile landed
    __syncthreads();
#pragma unroll
    for (int nd = 0; nd < NT; ++nd) {
      if (nd >= n_dt) break;
      // the cross terms and the main term in chains of their own
      float cx[4] = {0.f, 0.f, 0.f, 0.f}, cm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* vr = v_row + 8 * j * ld + 8 * nd;
        uint32_t b0h, b0l, b1h, b1l;
        split(vr[0], b0h, b0l);   // key 8 j + 2 t, column 8 nd + g
        split(vr[ld], b1h, b1l);  // key 8 j + 2 t + 1
        mma_tf32(cx, pl[j], b0h, b1h);
        mma_tf32(cx, ph[j], b0l, b1l);
        mma_tf32(cm, ph[j], b0h, b1h);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[nd][e] = fmaf(o[nd][e], alpha[e >> 1], cx[e] + cm[e]);
    }
    __syncthreads();  // every warp is done with this V
    if (k0 + kBK < k_end)
      load_tile(v_s, ld, p.v, v_base, p.v_ss, k0 + kBK, p.S, dh, dh_pad,
                p.vec_v);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // merge the two key halves of each row: the row sums over the quads,
  // then each half's (max, sum) through shared memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();  // the tiles are no longer read
  float* ml = k_s;  // (2 halves, 64 rows, 2)
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * rg + g + 8 * r;
      ml[(half * kBQ + row) * 2] = m[r];
      ml[(half * kBQ + row) * 2 + 1] = l[r];
    }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * rg + g + 8 * r;
    const float mo = ml[((1 - half) * kBQ + row) * 2];
    const float lo = ml[((1 - half) * kBQ + row) * 2 + 1];
    const float mx = fmaxf(m[r], mo);
    const float mine = expf(m[r] - mx);
    f[r] = mine / fmaxf(l[r] * mine + lo * expf(mo - mx), 1e-30f);
  }
  // half 0 writes columns of n8 tiles [0, split_dt), half 1 the rest; each
  // hands the other its scaled share of those columns
  const int split_dt = (n_dt + 1) / 2;
  float* ox = q_s;  // (64, ld)
#pragma unroll
  for (int nd = 0; nd < NT; ++nd) {
    if (nd >= n_dt) break;
    if ((nd < split_dt) == (half == 0)) continue;
    float* row0 = ox + (16 * rg + g) * ld + 8 * nd + 2 * t;
    row0[0] = f[0] * o[nd][0];
    row0[1] = f[0] * o[nd][1];
    row0[8 * ld] = f[1] * o[nd][2];
    row0[8 * ld + 1] = f[1] * o[nd][3];
  }
  __syncthreads();
#pragma unroll
  for (int nd = 0; nd < NT; ++nd) {
    if (nd >= n_dt) break;
    if ((nd < split_dt) != (half == 0)) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * rg + g + 8 * r, q_pos = q0 + row;
      if (q_pos >= p.T) continue;
      const float* other = ox + row * ld + 8 * nd + 2 * t;
      float* out = p.o + b * p.o_sb + q_pos * p.o_st + h * p.o_sh;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nd + 2 * t + e;
        if (col < dh) out[col] = fmaf(f[r], o[nd][2 * r + e], other[e]);
      }
    }
  }
}

template <int NT>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  const int dh_pad = (p.dh + 31) & ~31;
  const size_t smem = static_cast<size_t>(kBQ + 2 * kBK) * (dh_pad + 4) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_qt, H, B);
  flash_attention_kernel<NT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies need a 16-byte base, dh a multiple of 4 and every stride
// of a dimension longer than 1 a multiple of 4 elements.
bool vec_ok(const void* x, int dh, const long long* st, const int* sizes) {
  if (reinterpret_cast<uintptr_t>(x) % 16 || dh % 4) return false;
  for (int d = 0; d < 3; ++d)
    if (sizes[d] > 1 && st[d] % 4) return false;
  return true;
}

}  // namespace

// q, k, v, o: f32, the last dimension contiguous.  strides: 12 element
// strides, (b, t, h) of q, (b, s, h) of k, of v and (b, t, h) of o.
// softcap <= 0 means none, window <= 0 global.  Requires 1 <= dh <= 256,
// Hkv | H, B and H <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B,
                                      int T, int S, int H, int Hkv, int dh,
                                      int causal, int window, float scale,
                                      float softcap, void* stream) {
  if (dh < 1 || dh > 256 || Hkv < 1 || H % Hkv || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.q_sb = strides[0]; p.q_st = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_st = strides[10]; p.o_sh = strides[11];
  const int q_sizes[3] = {B, T, H}, kv_sizes[3] = {B, S, Hkv};
  p.vec_q = vec_ok(q, dh, strides, q_sizes);
  p.vec_k = vec_ok(k, dh, strides + 3, kv_sizes);
  p.vec_v = vec_ok(v, dh, strides + 6, kv_sizes);
  p.T = T;
  p.S = S;
  p.group = H / Hkv;
  p.dh = dh;
  p.n_qt = (T + kBQ - 1) / kBQ;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_dt = (dh + 7) / 8;
  if (n_dt <= 2) return launch<2>(p, B, H, s);
  if (n_dt <= 4) return launch<4>(p, B, H, s);
  if (n_dt <= 8) return launch<8>(p, B, H, s);
  if (n_dt <= 16) return launch<16>(p, B, H, s);
  return launch<32>(p, B, H, s);
}
