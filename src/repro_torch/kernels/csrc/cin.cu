// xDeepFM CIN layer: out[b,o,d] = sum_{h,j} w[o, h*m + j] *
// x_prev[b,h,d] * x0[b,j,d], w (H_out, Hp*m), x_prev (B, Hp, D),
// x0 (B, m, D), all f32 -> (B, H_out, D) f32.
//
// Replaces the Pallas kernel src/repro/kernels/cin.py (cin_layer), which
// forms Z = x_prev (x) x0 tile by tile in VMEM and contracts it with w on
// the MXU.
//
// Seen per (b, d) column, the layer is a product W Z with M = H_out,
// K = Hp*m and N = B*D, whose B operand z[h*m + j][b*D + d] =
// x_prev[b,h,d] * x0[b,j,d] is never stored anywhere: each thread forms
// the z values it needs in registers, one multiply per column and k.
//
// Bound: operations.  At the published widths (H_out = 200, m = 39,
// D = 10) a layer does 2*200*Hp*39*10 flops a sample (6.1 M for Hp = 39,
// 31.2 M for Hp = 200) on 4*(Hp + 39 + 200)*10 bytes: thousands of flops
// a byte.
//
// Design: a block owns kTO output channels and kTN columns (samples x D,
// in the output's flat b*D + d order, so any D works).  It stages its
// samples' x0 (m x kTN) in shared memory once, then walks h in chunks
// of kHC: it stages the W columns of those h (kHC*m x kTO, transposed,
// padded against bank conflicts) and the x_prev rows (kHC x kTN).  For
// each (h, j) a thread reads 8 x0 values and 8 W values (4 vector loads,
// the W ones broadcast across the warp), forms its 8 z values with one
// multiply each and accumulates an 8 x 8 register tile (8 channels,
// 8 columns) in 64 f32 FMAs, summing k = h*m + j in ascending order.
// No tensor cores: TF32 would miss the 1e-4 gate at K = 7800.

#include <cuda_runtime.h>

namespace {

constexpr int kTO = 40;   // output channels per block: 5 groups of 8
constexpr int kTN = 256;  // columns per block: 32 groups of 2 x 4
constexpr int kHC = 2;    // h per staged chunk of W and x_prev
constexpr int kLdW = kTO + 4;  // W tile row, 16-byte aligned
constexpr int kThreads = (kTO / 8) * (kTN / 8);  // 160
constexpr int kSmemMax = 227 * 1024;

// dynamic shared memory: x0 (m x kTN), x_prev (kHC x kTN), W (kHC*m x kLdW)
int smem_bytes(int m) {
  return 4 * (m * kTN + kHC * kTN + kHC * m * kLdW);
}

__global__ void __launch_bounds__(kThreads)
    cin_kernel(const float* __restrict__ w, const float* __restrict__ xp,
               const float* __restrict__ x0, float* __restrict__ out, int B,
               int Hp, int m, int D, int Ho) {
  extern __shared__ __align__(16) float smem[];
  float* x0_s = smem;                 // [m][kTN]
  float* xp_s = x0_s + m * kTN;       // [kHC][kTN]
  float* w_s = xp_s + kHC * kTN;      // [kHC*m][kLdW]
  __shared__ int xp_off[kTN];  // column -> offset in the block's x_prev
  __shared__ int x0_off[kTN];  // column -> offset in the block's x0, or -1

  const int K = Hp * m;
  const long long n_cols = static_cast<long long>(B) * D;
  const long long col0 = static_cast<long long>(blockIdx.x) * kTN;
  const int o0 = blockIdx.y * kTO;
  const long long b0 = col0 / D;  // the block's first sample
  const float* xpb = xp + b0 * Hp * D;
  const float* x0b = x0 + b0 * m * D;

  for (int n = threadIdx.x; n < kTN; n += kThreads) {
    const long long gc = col0 + n;
    if (gc < n_cols) {
      const int bl = static_cast<int>(gc / D - b0);
      const int d = static_cast<int>(gc % D);
      xp_off[n] = bl * Hp * D + d;
      x0_off[n] = bl * m * D + d;
    } else {
      xp_off[n] = -1;
      x0_off[n] = -1;
    }
  }
  __syncthreads();
  // x0 tile, once; threads along the columns (adjacent d of one sample)
  for (int e = threadIdx.x; e < m * kTN; e += kThreads) {
    const int j = e / kTN, n = e % kTN;
    x0_s[e] = x0_off[n] >= 0 ? x0b[x0_off[n] + j * D] : 0.f;
  }

  const int tg = threadIdx.x / (kTN / 8);  // channels o0 + 8*tg + a
  const int tc = threadIdx.x % (kTN / 8);  // columns 4*tc + q (+ kTN/2)
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  for (int h0 = 0; h0 < Hp; h0 += kHC) {
    const int hc = min(kHC, Hp - h0);
    const int kc = hc * m;  // W columns of this chunk
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < hc * kTN; e += kThreads) {
      const int hh = e / kTN, n = e % kTN;
      xp_s[e] = xp_off[n] >= 0 ? xpb[xp_off[n] + (h0 + hh) * D] : 0.f;
    }
    // W tile, threads along k: each warp reads a run of one W row
    for (int e = threadIdx.x; e < kc * kTO; e += kThreads) {
      const int o = e / kc, k = e - o * kc;
      w_s[k * kLdW + o] =
          o0 + o < Ho ? w[static_cast<long long>(o0 + o) * K + h0 * m + k]
                      : 0.f;
    }
    __syncthreads();
    for (int hh = 0; hh < hc; ++hh) {
      const float4 p0 =
          *reinterpret_cast<const float4*>(&xp_s[hh * kTN + 4 * tc]);
      const float4 p1 = *reinterpret_cast<const float4*>(
          &xp_s[hh * kTN + 4 * tc + kTN / 2]);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float* wrow = w_s + hh * m * kLdW + 8 * tg;
#pragma unroll 2
      for (int j = 0; j < m; ++j) {
        const float4 w0 = *reinterpret_cast<const float4*>(wrow + j * kLdW);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wrow + j * kLdW + 4);
        const float4 q0 =
            *reinterpret_cast<const float4*>(&x0_s[j * kTN + 4 * tc]);
        const float4 q1 = *reinterpret_cast<const float4*>(
            &x0_s[j * kTN + 4 * tc + kTN / 2]);
        const float wr[8] = {w0.x, w0.y, w0.z, w0.w,
                             w1.x, w1.y, w1.z, w1.w};
        const float zr[8] = {pr[0] * q0.x, pr[1] * q0.y, pr[2] * q0.z,
                             pr[3] * q0.w, pr[4] * q1.x, pr[5] * q1.y,
                             pr[6] * q1.z, pr[7] * q1.w};
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[a][c] = fmaf(wr[a], zr[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int n = 4 * tc + (c & 3) + (c >> 2) * (kTN / 2);
    const long long gc = col0 + n;
    if (gc >= n_cols) continue;
    const long long b = gc / D;
    const int d = static_cast<int>(gc % D);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int o = o0 + 8 * tg + a;
      if (o < Ho) out[(b * Ho + o) * D + d] = acc[a][c];
    }
  }
}

}  // namespace

// All pointers f32 and contiguous.  Requires B, Hp, m, D, Ho > 0 and
// m small enough for the x0 tile (m <= 200 or so).
extern "C" int cin_layer_launch(const float* w, const float* x_prev,
                                const float* x0, float* out, int B, int Hp,
                                int m, int D, int Ho, void* stream) {
  const long long n_cols = static_cast<long long>(B) * D;
  const long long gx = (n_cols + kTN - 1) / kTN;
  const int gy = (Ho + kTO - 1) / kTO;
  const int smem = smem_bytes(m);
  if (gx > 0x7fffffffLL || gy > 65535 || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(gx), gy);
  cin_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, x_prev, x0, out, B, Hp, m, D, Ho);
  return static_cast<int>(cudaGetLastError());
}
