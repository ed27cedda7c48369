// xDeepFM CIN layer: the backward pass.  With the forward out[b,o,d] =
// sum_c w[o,c] Z[b,c,d], Z[b,hm+j,d] = x_prev[b,h,d] x0[b,j,d] (c = hm+j),
// and dz (B, H_out, D) the gradient of out, it computes
//
//   dw[o,c]         = sum_{b,d} dz[b,o,d] Z[b,c,d]
//   dx_prev[b,h,d]  = sum_j x0[b,j,d] T[b,hm+j,d]
//   dx0[b,j,d]      = sum_h x_prev[b,h,d] T[b,hm+j,d],   T = w^T dz,
//
// all f32.  Z and T are (B, Hp*m, D): 20.4 GB each at xDeepFM's
// train_batch (B = 65,536, Hp = 200, m = 39, D = 10), so neither is ever
// written to memory; both are formed tile by tile on chip.
//
// Stands for jax.grad of the CIN oracle (src/repro/models/recsys/
// xdeepfm.py:79, cin_layer), which the JAX package differentiates as two
// einsums; the Pallas kernel src/repro/kernels/cin.py has no backward.
//
// Bound: operations.  dw and T are each 2 Ho (Hp m) (B D) flops: 4.09
// TFLOP for a 200-wide layer at train_batch, against some 1.8 GB moved.
// This first kernel runs them on the CUDA cores in plain f32 (67 TFLOP/s:
// a 61 ms bound a layer); a tensor-core redesign is later work.
//
// Determinism: every sum runs in one fixed order and no atomics are
// used, so the same inputs give the same bits.
//
// Design (columns n = b D + d of the batch):
// - dx kernel, a block 64 columns, max(64, 16 ceil(m / 4)) threads: dz's
//   (H_out, 64) and x0's columns are staged in shared memory once; then
//   for h = 0 .. Hp-1 in order the block loads w's columns hm .. hm+m-1
//   (H_out x m) and forms T_h = w_h^T dz (m x 64) in registers, a thread
//   4 rows j by 4 columns (a float4 of w and one of dz a step of o: 16
//   fma to 2 loads), adds x_prev[h] T_h into its dx0 rows (the sum over h
//   in order) and sums x0[j] T_h[j] over its 4 rows; 64 threads add the
//   row groups' sums in group order into dx_prev[h].
// - dw kernel, 256 threads, a block a 64 x 64 tile of dw (o, c) and one
//   part of the columns: 32 columns at a time it stages dz's rows and
//   Z's rows, formed from x_prev and x0 as it loads them (each thread's
//   c, hence its h and j, fixed; the next chunk loaded into registers
//   while this one is summed), and each thread adds a 4 x 4 tile (two
//   float4 loads a column).  Each
//   part's sum runs over its columns in order; with the columns cut into
//   P parts (P by shape only, so that a part holds some 10,000 columns
//   and the grid some four waves), the parts' partial dw go to scratch
//   and one more launch sums them in part order.
//
// Limits: m <= 64; B Hp D, B H_out D and B m D below 2^31; the dx
// kernel's staged tiles, (H_out + m + 16) 64 + H_out m' floats (m' = m
// rounded up to 4), must fit 227 KB (H_out = 200, m = 39: 97 KB, two
// blocks an SM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;        // columns of a dx block
constexpr int kTile = 64;        // dw tile edge (o and c)
constexpr int kChunk = 32;       // columns a dw step
constexpr int kThreads = 256;    // a dw block
constexpr int kPartCols = 4096;  // columns a dw part, at least
constexpr int kMaxParts = 64;
constexpr int kSmemMax = 227 * 1024;

struct Dims {
  int B, Hp, m, D, Ho;
  int N;  // B * D columns
  int C;  // Hp * m
};

// column n's offset of (b, 0, d) in a (B, rows, D) tensor
__device__ __forceinline__ int col_base(int n, int rows, int D) {
  const int b = n / D;
  return b * rows * D + (n - b * D);
}

__global__ void cin_bwd_dx_kernel(const float* __restrict__ w,
                                  const float* __restrict__ xp,
                                  const float* __restrict__ x0,
                                  const float* __restrict__ dz,
                                  float* __restrict__ dxp,
                                  float* __restrict__ dx0, Dims p) {
  extern __shared__ __align__(16) float smem[];
  const int mw = (p.m + 3) & ~3, groups = mw / 4;
  float* dz_s = smem;                     // Ho x 64
  float* x0_s = dz_s + p.Ho * kCols;      // m x 64
  float* red_s = x0_s + p.m * kCols;      // 16 x 64, a row group's sums
  float* w_s = red_s + 16 * kCols;        // Ho x mw
  const int n0 = blockIdx.x * kCols;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tx = tid % 16, ty = tid / 16;  // columns 4 tx.., rows 4 ty..
  const bool rows = ty < groups;

  for (int e = tid; e < p.Ho * kCols; e += nt) {
    const int r = e / kCols, n = n0 + e % kCols;
    dz_s[e] = n < p.N ? dz[col_base(n, p.Ho, p.D) + r * p.D] : 0.f;
  }
  for (int e = tid; e < p.m * kCols; e += nt) {
    const int r = e / kCols, n = n0 + e % kCols;
    x0_s[e] = n < p.N ? x0[col_base(n, p.m, p.D) + r * p.D] : 0.f;
  }
  int xb[4], x0b[4];  // this thread's columns' bases in x_prev and x0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * tx + i;
    xb[i] = n < p.N ? col_base(n, p.Hp, p.D) : -1;
    x0b[i] = n < p.N ? col_base(n, p.m, p.D) : -1;
  }
  __syncthreads();
  float x0r[4][4];  // x0 at this thread's rows and columns (0 past m)
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * ty + k;
      x0r[k][i] = j < p.m ? x0_s[j * kCols + 4 * tx + i] : 0.f;
    }

  // this thread loads w_s column wj of rows wo, wo + ostep, ... (no
  // division in the loop; nt >= 64 >= mw)
  const int ostep = nt / mw, wj = tid % mw;
  const int wo = tid < ostep * mw ? tid / mw : p.Ho;
  float acc0[4][4] = {};  // dx0 rows 4 ty + k, columns 4 tx + i
  for (int h = 0; h < p.Hp; ++h) {
    const float* wh = w + h * p.m + wj;
    for (int o = wo; o < p.Ho; o += ostep)
      w_s[o * mw + wj] = wj < p.m ? wh[o * p.C] : 0.f;
    float xv[4];  // x_prev[h] at this thread's columns
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = xb[i] >= 0 ? xp[xb[i] + h * p.D] : 0.f;
    __syncthreads();  // w_s ready; red_s's last sums read
    if (rows) {
      float t[4][4] = {};
      const float* wr = w_s + 4 * ty;
      const float* gr = dz_s + 4 * tx;
#pragma unroll 4
      for (int o = 0; o < p.Ho; ++o) {
        const float4 wv = *reinterpret_cast<const float4*>(wr + o * mw);
        const float4 g = *reinterpret_cast<const float4*>(gr + o * kCols);
        const float a[4] = {wv.x, wv.y, wv.z, wv.w};
        const float b[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) t[k][i] = fmaf(a[k], b[i], t[k][i]);
      }
      float part[4] = {};  // sum over this thread's rows of x0[j] T_h[j]
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc0[k][i] = fmaf(xv[i], t[k][i], acc0[k][i]);
          part[i] = fmaf(x0r[k][i], t[k][i], part[i]);
        }
      *reinterpret_cast<float4*>(red_s + ty * kCols + 4 * tx) =
          make_float4(part[0], part[1], part[2], part[3]);
    }
    __syncthreads();  // red_s complete; w_s free for the next h
    if (tid < kCols) {
      float sum = 0.f;
      for (int r = 0; r < groups; ++r) sum += red_s[r * kCols + tid];
      const int n = n0 + tid;
      if (n < p.N) dxp[col_base(n, p.Hp, p.D) + h * p.D] = sum;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * ty + k;
    if (!rows || j >= p.m) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (x0b[i] >= 0) dx0[x0b[i] + j * p.D] = acc0[k][i];
  }
}

// Partial dw of one 64 x 64 (o, c) tile over columns [n_lo, n_hi) of
// part blockIdx.z, into dst + blockIdx.z * part_stride.  Each thread
// stages one tile column (cs: its o and its c, hence h and j) in rows r0
// + 4 k, the next chunk's values loaded into registers while this one is
// summed.
__global__ void __launch_bounds__(kThreads)
    cin_bwd_dw_kernel(const float* __restrict__ xp,
                      const float* __restrict__ x0,
                      const float* __restrict__ dz, float* __restrict__ dst,
                      long long part_stride, int part_cols, Dims p) {
  constexpr int kRowsPer = kChunk * kTile / kThreads;  // 8
  constexpr int kRowStep = kThreads / kTile;           // 4
  __shared__ __align__(16) float a_s[kChunk][kTile];  // dz[n][o]
  __shared__ __align__(16) float z_s[kChunk][kTile];  // Z[n][c]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // c 4 tx + i, o 4 ty + k
  const int o0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const int n_lo = blockIdx.z * part_cols;
  const int n_hi = min(n_lo + part_cols, p.N);
  const int cs = tid % kTile, r0 = tid / kTile;
  const int o_st = o0 + cs, c_st = c0 + cs;
  const int h_st = c_st / p.m, j_st = c_st - h_st * p.m;
  const bool o_ok = o_st < p.Ho, c_ok = c_st < p.C;
  // (b, d) of each staged row's column, advanced a chunk at a time
  const int db = kChunk / p.D, dd = kChunk % p.D;
  int cb[kRowsPer], cd[kRowsPer];
#pragma unroll
  for (int k = 0; k < kRowsPer; ++k) {
    const int n = n_lo + r0 + kRowStep * k;
    cb[k] = n / p.D;
    cd[k] = n - cb[k] * p.D;
  }
  float av[kRowsPer], xv[kRowsPer], x0v[kRowsPer];
  auto fetch = [&](int nb) {
#pragma unroll
    for (int k = 0; k < kRowsPer; ++k) {
      const bool live = nb + r0 + kRowStep * k < n_hi;
      av[k] = live && o_ok ? dz[(cb[k] * p.Ho + o_st) * p.D + cd[k]] : 0.f;
      xv[k] = live && c_ok ? xp[(cb[k] * p.Hp + h_st) * p.D + cd[k]] : 0.f;
      x0v[k] = live && c_ok ? x0[(cb[k] * p.m + j_st) * p.D + cd[k]] : 0.f;
    }
  };
  float acc[4][4] = {};
  fetch(n_lo);
  for (int nb = n_lo; nb < n_hi; nb += kChunk) {
#pragma unroll
    for (int k = 0; k < kRowsPer; ++k) {
      a_s[r0 + kRowStep * k][cs] = av[k];
      z_s[r0 + kRowStep * k][cs] = xv[k] * x0v[k];
    }
    __syncthreads();
    if (nb + kChunk < n_hi) {
#pragma unroll
      for (int k = 0; k < kRowsPer; ++k) {
        cd[k] += dd;
        cb[k] += db;
        if (cd[k] >= p.D) {
          cd[k] -= p.D;
          ++cb[k];
        }
      }
      fetch(nb + kChunk);
    }
#pragma unroll 8
    for (int r = 0; r < kChunk; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[r][4 * ty]);
      const float4 z = *reinterpret_cast<const float4*>(&z_s[r][4 * tx]);
      const float avr[4] = {a.x, a.y, a.z, a.w};
      const float zvr[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[k][i] = fmaf(avr[k], zvr[i], acc[k][i]);
    }
    __syncthreads();
  }
  float* out = dst + blockIdx.z * part_stride;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int o = o0 + 4 * ty + k;
    if (o >= p.Ho) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + 4 * tx + i;
      if (c < p.C) out[static_cast<long long>(o) * p.C + c] = acc[k][i];
    }
  }
}

// dw = sum over parts, in part order.
__global__ void cin_bwd_sum_parts_kernel(const float* __restrict__ parts,
                                         float* __restrict__ dw, long long n,
                                         int n_parts) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = parts[e];
    for (int q = 1; q < n_parts; ++q) s += parts[q * n + e];
    dw[e] = s;
  }
}

// The dw plan: columns a part and the number of parts, by shape only.
void dw_plan(long long N, long long* part_cols, int* parts) {
  long long p = (N + kPartCols - 1) / kPartCols;
  if (p > kMaxParts) p = kMaxParts;
  if (p < 1) p = 1;
  long long cols = (N + p - 1) / p;
  cols = (cols + kChunk - 1) / kChunk * kChunk;
  *part_cols = cols;
  *parts = static_cast<int>((N + cols - 1) / cols);
}

long long dx_smem_bytes(int m, int Ho) {
  const long long mw = (m + 3) & ~3;
  return (static_cast<long long>(Ho + m + 16) * kCols + Ho * mw) * 4;
}

}  // namespace

// Scratch floats the launcher needs: the parts' partial dw when the
// batch's columns are cut into more than one part, else 0.
extern "C" long long cin_layer_bwd_scratch_floats(int B, int Hp, int m,
                                                  int D, int Ho) {
  long long cols;
  int parts;
  dw_plan(static_cast<long long>(B) * D, &cols, &parts);
  return parts > 1 ? static_cast<long long>(parts) * Ho * Hp * m : 0;
}

// w (Ho, Hp*m), x_prev (B, Hp, D), x0 (B, m, D), dz (B, Ho, D), all f32
// contiguous -> dw (Ho, Hp*m), dx_prev, dx0.  Requires B, D, Ho, Hp,
// m > 0, m <= 64, B D max(Hp, Ho, m) and Ho Hp m below 2^31 and the dx
// tiles within shared memory (else returns cudaErrorInvalidValue);
// scratch as cin_layer_bwd_scratch_floats says.  Returns the first
// failing launch's cudaGetLastError(), else 0.
extern "C" int cin_layer_bwd_launch(const float* w, const float* x_prev,
                                    const float* x0, const float* dz,
                                    float* dw, float* dx_prev, float* dx0,
                                    float* scratch, int B, int Hp, int m,
                                    int D, int Ho, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bd = static_cast<long long>(B) * D;
  const long long widest = Hp > Ho ? (Hp > m ? Hp : m) : (Ho > m ? Ho : m);
  const long long smem = dx_smem_bytes(m, Ho);
  if (m > 64 || smem > kSmemMax || bd * widest > INT32_MAX ||
      static_cast<long long>(Ho) * Hp * m > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims p{B, Hp, m, D, Ho, static_cast<int>(bd), Hp * m};
  cudaError_t e = cudaFuncSetAttribute(
      cin_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // 4 rows a thread-row, and at least the 64 threads that sum dx_prev
  const int threads = 16 * ((m + 3) / 4) > kCols ? 16 * ((m + 3) / 4)
                                                  : kCols;
  cin_bwd_dx_kernel<<<(p.N + kCols - 1) / kCols, threads, smem, s>>>(
      w, x_prev, x0, dz, dx_prev, dx0, p);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  long long cols;
  int parts;
  dw_plan(bd, &cols, &parts);
  const long long n_w = static_cast<long long>(Ho) * p.C;
  float* dst = parts > 1 ? scratch : dw;
  const dim3 grid((p.C + kTile - 1) / kTile, (Ho + kTile - 1) / kTile, parts);
  cin_bwd_dw_kernel<<<grid, kThreads, 0, s>>>(x_prev, x0, dz, dst, n_w,
                                              static_cast<int>(cols), p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || parts == 1) return err;
  long long blocks = (n_w + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  cin_bwd_sum_parts_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      scratch, dw, n_w, parts);
  return static_cast<int>(cudaGetLastError());
}
