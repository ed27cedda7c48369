// Flash attention in f32: q (B, T, H, dh), k/v (B, S, Hkv, dh) -> (B, T,
// H, dh) f32, with GQA (kv head h / (H / Hkv)), a scale, an optional tanh
// softcap c * tanh(s / c), the mask k_pos < S, causal (k_pos <= q_pos,
// both counted from 0) and a sliding window (q_pos - k_pos < window when
// window > 0).  bf16 calls run flash_attention_wgmma.cu instead.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention), the self-attention of models/lm.py.  Its grid runs
// the kv blocks of one (batch, head, q block) in order on one core,
// carrying the online-softmax state in VMEM scratch.  Here one block of
// 256 threads owns a 64-row q tile of one (batch, head) and walks the kv
// tiles in a loop of its own; the running max, sum and the (64, dh)
// output accumulator stay in registers for the whole walk.
//
// Bound: operations.  A (query, key) pair costs 4 * dh flops (QK^T and
// PV) against 2 * dh values of k and v that every q tile of the head
// shares, so at T = S = 32k, dh = 256 the work is some 2,000 flops a
// byte, far above the card's ~20 f32 flops a byte.  It runs on the CUDA
// cores in full f32 (TF32 would miss the 2e-5 gate): every thread holds a
// 4 x 4 tile of the scores (rows ty + 16 i, keys tx + 16 j) and a 4 x 4NC
// tile of the output (rows ty + 16 i, columns 64 c + 4 tx .. + 3), and
// reads shared memory in 16-byte vectors, so a warp issues about three
// shared-memory wavefronts per 16 FMAs a thread.  Rows are padded by 4
// floats so that the 16 key rows a warp reads at one column fall in
// distinct banks.  K and V take turns in one shared buffer; at dh = 256
// a block holds 150,528 bytes (opted in above 48 KB), so one block runs
// per SM.  KV tiles wholly above the diagonal or wholly outside the
// window are never loaded (the work saving of the local layers), and q
// tiles start in reverse order so the longest causal walks go first.
// Ragged T and S are masked in the kernel; callers do not pad.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per kv tile
constexpr int kThreads = 256;   // 16 x 16 (ty, tx)
constexpr int kPS = kBK + 4;    // row stride of the P tile (floats)
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
  float scale, softcap;  // softcap <= 0: none
};

// Rows [r0, r0 + 64) of one head into dst (64, ds), zero past the last
// row n and past dh (up to the padded width dh_pad).
__device__ __forceinline__ void stage(float* dst, int ds, const float* src,
                                      long long base, long long row_stride,
                                      int r0, int n, int dh, int dh_pad) {
  for (int idx = threadIdx.x; idx < kBQ * dh_pad; idx += kThreads) {
    const int r = idx / dh_pad, d = idx - r * dh_pad;
    const int row = r0 + r;
    float x = 0.f;
    if (row < n && d < dh)
      x = src[base + row * row_stride + d];
    dst[r * ds + d] = x;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// NC: 64-column chunks of the output a thread row covers (dh <= 64 NC).
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dh = p.dh, dh_pad = (dh + 3) & ~3, ds = dh_pad + 4;
  float* q_s = smem;              // (64, ds)
  float* kv_s = q_s + kBQ * ds;   // (64, ds): K, then V
  float* p_s = kv_s + kBK * ds;   // (64, kPS) probabilities

  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  stage(q_s, ds, p.q, b * p.q_sb + h * p.q_sh, p.q_st, q0, p.T, dh,
               dh_pad);

  // the kv tiles any row of this q tile can see
  const int q_last = min(q0 + kBQ, p.T) - 1;
  int k_end = p.S;
  if (p.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  k_begin = k_begin / kBK * kBK;

  const long long k_base = b * p.k_sb + hk * p.k_sh;
  const long long v_base = b * p.v_sb + hk * p.v_sh;

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's V reads (or Q's staging) are done
    stage(kv_s, ds, p.k, k_base, p.k_ss, k0, p.S, dh, dh_pad);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh_pad; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * ds + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] =
            *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * ds + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, softcap, mask, then the online softmax of each row; the 16
    // threads of a row (one tx each) are 16 neighbouring lanes of a warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = k_pos < p.S;
        if (p.causal) ok = ok && k_pos <= q_pos;
        if (p.window > 0) ok = ok && (q_pos - k_pos) < p.window;
        x = ok ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * kPS + tx + 16 * j] = e;
        rs += e;
      }
      rs = row_sum16(rs);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P written, K no longer read
    stage(kv_s, ds, p.v, v_base, p.v_ss, k0, p.S, dh, dh_pad);
    __syncthreads();

    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] =
            *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPS + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = 64 * c + 4 * tx;
          if (col < dh_pad) {
            const float4 vv =
                *reinterpret_cast<const float4*>(kv_s + (j + e) * ds + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pe = comp(pv[i], e);
              acc[i][4 * c + 0] = fmaf(pe, vv.x, acc[i][4 * c + 0]);
              acc[i][4 * c + 1] = fmaf(pe, vv.y, acc[i][4 * c + 1]);
              acc[i][4 * c + 2] = fmaf(pe, vv.z, acc[i][4 * c + 2]);
              acc[i][4 * c + 3] = fmaf(pe, vv.w, acc[i][4 * c + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + ty + 16 * i;
    if (q_pos >= p.T) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const long long base = b * p.o_sb + q_pos * p.o_st + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 64 * c + 4 * tx + e;
        if (col < dh)
          p.o[base + col] = acc[i][4 * c + e] / denom;
      }
  }
}

template <int NC>
int launch(const Params& p, int B, int H, cudaStream_t stream) {
  const int dh_pad = (p.dh + 3) & ~3;
  const size_t smem =
      (static_cast<size_t>(kBQ + kBK) * (dh_pad + 4) +
       static_cast<size_t>(kBQ) * kPS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_qt, H, B);
  flash_attention_kernel<NC><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: f32, the last dimension contiguous.  strides: 12 element strides, (b, t, h) of q,
// (b, s, h) of k, of v and (b, t, h) of o.  softcap <= 0 means none,
// window <= 0 global.  Requires 1 <= dh <= 256, Hkv | H, B and H <= 65535.
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
  switch (((dh + 3) / 4 * 4 + 63) / 64) {
    case 1: return launch<1>(p, B, H, s);
    case 2: return launch<2>(p, B, H, s);
    case 3: return launch<3>(p, B, H, s);
    default: return launch<4>(p, B, H, s);
  }
}
