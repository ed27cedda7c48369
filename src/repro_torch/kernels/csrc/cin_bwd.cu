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
// Both products run on the tensor cores in 3xTF32 (three TF32 wgmma a
// product, cin.cu's arithmetic: hi = tf32(x), lo = tf32(x - hi), lo*hi +
// hi*lo + hi*hi), so the least time counts them at 495/3 TFLOP/s, 24.8 ms
// a layer.
//
// Determinism: every sum runs in one fixed order and no atomics are
// used, so the same inputs give the same bits.
//
// Design (sm_90a; the two products are cin.cu's machinery: 384 threads,
// consumer warpgroups 0 and 1 of 64 rows each, producer warpgroup 2 with
// its registers given away and one thread issuing TMA loads into a ring
// of "full" (TMA bytes) and "empty" (256 consumer arrivals) mbarriers,
// 128-byte swizzled K-major B tiles, A formed in registers and split
// with cvt.rna.tf32; promotion: a wgmma chain spans two k-blocks of 32
// and is added into an f32 sum on the CUDA cores, as cin.cu found the
// 1e-4 gate needs).  Columns n = b D + d.
// - Layout pre-passes (cin_bwd_transpose_kernel, cin_bwd_split_wt_kernel):
//   TF32 wgmma takes both operands K-major, but for one channel dz, x0
//   and x_prev hold their columns in runs of D = 10 floats, which no TMA
//   box can deliver.  So dz is written once a call as dz^T (Ho, N) split
//   into hi and lo, x0 and x_prev as x0^T (m, N) and x_prev^T (Hp, N)
//   (x_prev^T is x0^T where x_prev is x0, layer 1), a thread a column
//   and the channels in order (reads of a sample's contiguous run,
//   writes of whole rows).  w is written as w^T (Hp mp, Ho) split into
//   hi and lo, rows h mp + j with j padded to mp, a multiple of 8 (m =
//   39: 40), so that a tile of channels holds whole h; padded rows are 0.
// - dw kernel: dw^T (c, o) = Z dz^T is M = c (Hp m), N = o, K = n.  A
//   block owns 128 channels c and 104 outputs o (xDeepFM's 200 are two
//   tiles) over one part of the columns.  Each ring slot holds a k-block
//   of 32 columns: the dz^T hi and lo boxes (104 x 32) and the block's
//   x0^T (m x 32) and x_prev^T rows (the h its channels span).  Each
//   consumer thread forms its Z values from the slot (its two channels'
//   h and j fixed, their x rows read through the swizzle), splits them
//   and issues three wgmma m64n104k8 a k8 step.  The columns are cut into
//   P parts by shape only (some 10,000 columns a part, at most 64); each
//   part writes its partial dw to a slab and one more launch adds the
//   slabs in part order (with P = 1 the block writes dw directly).
// - dx kernel: T = dz^T w is M = n, N = c, K = o (200).  A block owns 128
//   columns; the consumers stage their dz (Ho x 128, from the samples'
//   contiguous runs) in shared memory once, then walk the channel tiles
//   of NH whole h (mp NH channels: 120 at m = 39) in order, the producer
//   streaming w^T's hi and lo boxes (32 o x mp NH) through the ring.  For
//   each tile the A fragments (dz, split in registers) meet three wgmma
//   m64n(mp NH)k8 a k8 step (k8 steps wholly past Ho are skipped), and
//   the epilogue contracts T's tile in registers without storing it:
//   dx_prev[h] = sum_j x0[j] T[hm+j], each thread's mp/4 columns of an h
//   then a quad shuffle, in a fixed order; dx0[j] += x_prev[h] T[hm+j],
//   held in registers across the walk over h in order and written once.
//
// Limits: m <= 64 (m in 41..64 runs padded to mp = 64), H_out <= 256,
// B D Hp and B D Ho below 2^31; the dx kernel's staged dz (Ho rounded up
// to 32, x 136 floats) and two ring slots must fit 227 KB (H_out = 200:
// three slots).

#include "hopper.cuh"

#include <algorithm>

namespace {

using namespace hopper;

constexpr int kThreads = 384;   // consumers: warpgroups 0, 1; producer: 2
constexpr int kRows = 128;      // a block's columns (dx) or channels (dw)
constexpr int kKB = 32;         // k a k-block: one 128-byte row of f32
constexpr int kRowBytes = kKB * 4;
constexpr int kPromote = 2;     // k-blocks a wgmma chain
constexpr int kNW = 104;        // dw: outputs o an N tile
constexpr int kStagesW = 4;     // dw ring slots
constexpr int kMaxStagesX = 4;  // dx ring slots, at most
constexpr int kLdX = kRows + 8;  // dx: staged dz rows, padded against conflicts
constexpr int kSmemMax = 227 * 1024;
constexpr int kPartCols = 4096;  // dw: columns a part, at least
constexpr int kMaxParts = 64;
constexpr int kTCols = 128;      // transpose: columns a block

// -- layout pre-passes -------------------------------------------------------

// dst[r * ld + n] = src[(b R + r) D + d] for the columns n = b D + d < N
// and rows r < R: a thread a column, its sample's run read in order.
// With lo != nullptr each value is split: dst gets tf32(x), lo the rest.
__global__ void __launch_bounds__(kTCols)
    cin_bwd_transpose_kernel(const float* __restrict__ src,
                             float* __restrict__ dst, float* __restrict__ lo,
                             int R, int D, long long N, long long ld) {
  const long long n = blockIdx.x * static_cast<long long>(kTCols) +
                      threadIdx.x;
  if (n >= N) return;
  const long long b = n / D;
  const float* s = src + b * R * D + (n - b * D);
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    const float x = s[static_cast<long long>(r) * D];
    if (lo == nullptr) {
      dst[r * ld + n] = x;
    } else {
      uint32_t h, l;
      split_tf32(x, h, l);
      dst[r * ld + n] = __uint_as_float(h);
      lo[r * ld + n] = __uint_as_float(l);
    }
  }
}

// w (Ho, C = Hp m) -> w^T's TF32 halves (Hp mp, ldo): row h mp + j holds
// column h m + j of w, 0 for j >= m and o >= Ho.
__global__ void cin_bwd_split_wt_kernel(const float* __restrict__ w,
                                        float* __restrict__ hi,
                                        float* __restrict__ lo, int Ho, int C,
                                        int m, int mp, int ldo, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / ldo;
    const int o = static_cast<int>(i - r * ldo);
    const long long h = r / mp;
    const int j = static_cast<int>(r - h * mp);
    uint32_t vh = 0, vl = 0;
    if (j < m && o < Ho)
      split_tf32(w[static_cast<long long>(o) * C + h * m + j], vh, vl);
    hi[i] = __uint_as_float(vh);
    lo[i] = __uint_as_float(vl);
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

// -- dx: T = dz^T w on the tensor cores, contracted in registers -------------

struct DxParams {
  const float* dz;
  const float* xp;
  const float* x0;
  float* dxp;
  float* dx0;
  long long N;  // B * D columns
  int Hp, m, D, Ho;
  int n_kb;     // k-blocks of o: ceil(Ho / 32)
  int o_rows;   // staged dz rows: Ho rounded up to 32 (zero past Ho)
  int n_tiles;  // channel tiles: ceil(Hp / NH)
  int stages;   // ring slots
};

// column n's offset of (b, 0, d) in a (B, rows, D) tensor
__device__ __forceinline__ long long col_base(long long n, int rows, int D) {
  const long long b = n / D;
  return b * rows * D + (n - b * D);
}

// Stages dz's rows o < Ho of the block's columns n0 .. n0 + 127 into
// s[o * kLdX + n - n0], reading the samples' contiguous runs in order;
// columns past N and rows Ho .. o_rows - 1 are 0.  Run by the 256
// consumer threads.
__device__ __forceinline__ void stage_dz(float* s, const DxParams& p,
                                         long long n0, int ctid) {
  const long long n_end = min(n0 + kRows, p.N);
  const long long b_first = n0 / p.D;
  const int nb = static_cast<int>((n_end - 1) / p.D - b_first) + 1;
  const int run = p.Ho * p.D;  // floats of one sample's run
  const int first = static_cast<int>(n0 - b_first * p.D);
  const float* src = p.dz + b_first * run;
  for (int e = ctid; e < nb * run; e += 256) {
    const int bl = e / run, rem = e - bl * run;
    const int o = rem / p.D, d = rem - o * p.D;
    const int col = bl * p.D + d - first;
    if (col >= 0 && col < kRows)
      s[o * kLdX + col] = src[static_cast<long long>(bl) * run + rem];
  }
  const int valid = static_cast<int>(n_end - n0);
  if (valid < kRows) {
    const int pad = kRows - valid;
    for (int e = ctid; e < p.Ho * pad; e += 256)
      s[(e / pad) * kLdX + valid + e % pad] = 0.f;
  }
  for (int e = ctid; e < (p.o_rows - p.Ho) * kRows; e += 256)
    s[(p.Ho + e / kRows) * kLdX + e % kRows] = 0.f;
}

// Q = mp / 8 (a thread's columns of one h: 8 q + 2 t + e, q < Q, e < 2),
// NH = h a channel tile.
template <int Q, int NH>
__global__ void __launch_bounds__(kThreads, 1)
    cin_bwd_dx_kernel(const __grid_constant__ CUtensorMap twhi,
                      const __grid_constant__ CUtensorMap twlo,
                      const DxParams p) {
  constexpr int N = 8 * Q * NH;               // channels a tile
  constexpr uint32_t kTile = N * kRowBytes;   // one half's box (32 o x N)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  float* dz_s = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t ring =
      base + ((static_cast<uint32_t>(p.o_rows) * kLdX * 4 + 1023) & ~1023u);
  const uint32_t bars = ring + p.stages * 2 * kTile;
  auto full = [&](int s) -> uint32_t { return bars + 8 * s; };
  auto empty = [&](int s) -> uint32_t { return bars + 8 * (p.stages + s); };
  auto tile = [&](int s, int lo) -> uint32_t {
    return ring + (2 * s + lo) * kTile;
  };
  const long long n0 = static_cast<long long>(blockIdx.x) * kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread loads every w^T box, tiles in order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int i = 0;
      for (int tl = 0; tl < p.n_tiles; ++tl)
        for (int kb = 0; kb < p.n_kb; ++kb, ++i) {
          const int s = i % p.stages;
          mbar_wait(empty(s), ((i / p.stages) & 1) ^ 1);
          mbar_expect_tx(full(s), 2 * kTile);
          tma_load(tile(s, 0), &twhi, full(s), kb * kKB, tl * N);
          tma_load(tile(s, 1), &twlo, full(s), kb * kKB, tl * N);
        }
    }
  } else {
    // ---- consumers: 64 columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int ctid = threadIdx.x;
    const int lane = ctid % 32, t = lane % 4;
    const int r0 = 64 * wg + 16 * ((ctid % 128) / 32) + lane / 4;  // + 8
    stage_dz(dz_s, p, n0, ctid);

    long long xpb[2], x0b[2];  // (b, 0, d) of this thread's two columns
    bool ok[2];
    float x0r[2][2 * Q], dx0a[2][2 * Q];  // x0 and dx0 at j = 8q + 2t + e
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long n = n0 + r0 + 8 * hf;
      ok[hf] = n < p.N;
      xpb[hf] = ok[hf] ? col_base(n, p.Hp, p.D) : 0;
      x0b[hf] = ok[hf] ? col_base(n, p.m, p.D) : 0;
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * q + 2 * t + e;
          x0r[hf][2 * q + e] =
              ok[hf] && j < p.m
                  ? p.x0[x0b[hf] + static_cast<long long>(j) * p.D]
                  : 0.f;
          dx0a[hf][2 * q + e] = 0.f;
        }
    }
    bar_sync(1);  // dz_s staged

    // acc: the tensor cores' chain over kPromote k-blocks; sum: T's tile,
    // the chains added on the CUDA cores
    float acc[N / 2], sum[N / 2];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
    int i = 0;
    for (int tl = 0; tl < p.n_tiles; ++tl) {
      float xpv[2][NH];  // x_prev at this tile's h, for the epilogue
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int hl = 0; hl < NH; ++hl) {
          const int h = tl * NH + hl;
          xpv[hf][hl] = ok[hf] && h < p.Hp
                            ? p.xp[xpb[hf] + static_cast<long long>(h) * p.D]
                            : 0.f;
        }
#pragma unroll
      for (int e = 0; e < N / 2; ++e) sum[e] = 0.f;
      for (int kb = 0; kb < p.n_kb; ++kb, ++i) {
        // A fragments: k8 step kk holds o = 32 kb + 8 kk + t (regs 0, 1:
        // columns r0, r0 + 8) and o + 4 (regs 2, 3)
        const int kk_n = min(4, (p.Ho - kb * kKB + 7) / 8);
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* a = dz_s + (kb * kKB + 8 * kk + t) * kLdX + r0;
          split_tf32(a[0], ahi[kk][0], alo[kk][0]);
          split_tf32(a[8], ahi[kk][1], alo[kk][1]);
          split_tf32(a[4 * kLdX], ahi[kk][2], alo[kk][2]);
          split_tf32(a[4 * kLdX + 8], ahi[kk][3], alo[kk][3]);
        }
        const int s = i % p.stages;
        mbar_wait(full(s), (i / p.stages) & 1);
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < kk_n) {
            const uint64_t dhi = desc_kmajor(tile(s, 0) + 32 * kk);
            const uint64_t dlo = desc_kmajor(tile(s, 1) + 32 * kk);
            // the first product of a chain overwrites acc
            wgmma_tf32<N>(acc, alo[kk], dhi, kk > 0 || kb % kPromote != 0);
            wgmma_tf32<N>(acc, ahi[kk], dlo, 1);
            wgmma_tf32<N>(acc, ahi[kk], dhi, 1);
          }
        }
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
        fence_regs(ahi);
        fence_regs(alo);
        mbar_arrive(empty(s));
        if (kb % kPromote == kPromote - 1 || kb == p.n_kb - 1) {
#pragma unroll
          for (int e = 0; e < N / 2; ++e) sum[e] += acc[e];
        }
      }

      // T's tile: element 4 jj + 2 hf + e is column r0 + 8 hf, channel
      // 8 jj + 2 t + e of the tile, jj = hl Q + q: h = tl NH + hl, j =
      // 8 q + 2 t + e
#pragma unroll
      for (int hl = 0; hl < NH; ++hl) {
        const int h = tl * NH + hl;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float part = 0.f;
#pragma unroll
          for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              part = fmaf(x0r[hf][2 * q + e],
                          sum[4 * (hl * Q + q) + 2 * hf + e], part);
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          if (t == hl % 4 && ok[hf] && h < p.Hp)
            p.dxp[xpb[hf] + static_cast<long long>(h) * p.D] = part;
#pragma unroll
          for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              dx0a[hf][2 * q + e] =
                  fmaf(xpv[hf][hl], sum[4 * (hl * Q + q) + 2 * hf + e],
                       dx0a[hf][2 * q + e]);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * q + 2 * t + e;
          if (ok[hf] && j < p.m)
            p.dx0[x0b[hf] + static_cast<long long>(j) * p.D] =
                dx0a[hf][2 * q + e];
        }
  }
}

// -- dw: dw^T = Z dz^T on the tensor cores, Z formed in registers ------------

struct DwParams {
  float* dst;             // dw (Ho, C), or the part slabs when P > 1
  long long part_stride;  // floats between slabs (0 when P = 1)
  int Hp, m, Ho, C;
  int kb_per_part;        // k-blocks a part (the last may have fewer)
  int n_kb;               // k-blocks in all: ceil(N / 32)
  int hr;                 // x_prev rows a slot: the most h 128 channels span
  uint32_t x0_off, xp_off, slot;  // a slot's boxes (dz hi, lo at 0) and size
};

__global__ void __launch_bounds__(kThreads, 1)
    cin_bwd_dw_kernel(const __grid_constant__ CUtensorMap tdhi,
                      const __grid_constant__ CUtensorMap tdlo,
                      const __grid_constant__ CUtensorMap tx0,
                      const __grid_constant__ CUtensorMap txp,
                      const DwParams p) {
  constexpr uint32_t kDz = kNW * kRowBytes;  // one half's box (32 n x 104)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + kStagesW * p.slot;
  auto full = [&](int s) -> uint32_t { return bars + 8 * s; };
  auto empty = [&](int s) -> uint32_t { return bars + 8 * (kStagesW + s); };

  const int c0 = blockIdx.x * kRows;
  const int o0 = blockIdx.y * kNW;
  const int part = blockIdx.z;
  const int kb0 = part * p.kb_per_part;
  const int kb1 = min(p.n_kb, kb0 + p.kb_per_part);
  const int h_lo = c0 / p.m;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesW; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread loads every slot ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const uint32_t bytes = (2 * kNW + p.m + p.hr) * kRowBytes;
      for (int i = 0; i < kb1 - kb0; ++i) {
        const int s = i % kStagesW;
        mbar_wait(empty(s), ((i / kStagesW) & 1) ^ 1);
        mbar_expect_tx(full(s), bytes);
        const int n = (kb0 + i) * kKB;
        const uint32_t slot = base + s * p.slot;
        tma_load(slot, &tdhi, full(s), n, o0);
        tma_load(slot + kDz, &tdlo, full(s), n, o0);
        tma_load(slot + p.x0_off, &tx0, full(s), n, 0);
        tma_load(slot + p.xp_off, &txp, full(s), n, h_lo);
      }
    }
  } else {
    // ---- consumers: 64 channels each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int ctid = threadIdx.x;
    const int lane = ctid % 32, t = lane % 4;
    const int r0 = 64 * wg + 16 * ((ctid % 128) / 32) + lane / 4;  // + 8
    // this thread's two channels: their x rows' byte offsets in a slot and
    // swizzle keys (a box row's 16-byte chunk k/4 lies at (k/4) ^ (row & 7))
    bool cok[2];
    int x0_row[2], xp_row[2], x0_key[2], xp_key[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = c0 + r0 + 8 * hf;
      cok[hf] = c < p.C;
      const int h = cok[hf] ? c / p.m : h_lo;
      const int j = cok[hf] ? c - h * p.m : 0;
      x0_row[hf] = static_cast<int>(p.x0_off) + j * kRowBytes + 4 * t;
      xp_row[hf] = static_cast<int>(p.xp_off) + (h - h_lo) * kRowBytes + 4 * t;
      x0_key[hf] = j & 7;
      xp_key[hf] = (h - h_lo) & 7;
    }
    float acc[kNW / 2], sum[kNW / 2];
#pragma unroll
    for (int e = 0; e < kNW / 2; ++e) acc[e] = sum[e] = 0.f;

    for (int kb = kb0; kb < kb1; ++kb) {
      const int i = kb - kb0, s = i % kStagesW;
      mbar_wait(full(s), (i / kStagesW) & 1);
      const uint8_t* slot = gbase + s * p.slot;
      // A fragments: k8 step kk holds columns 8 kk + t (regs 0, 1:
      // channels r0, r0 + 8) and 8 kk + t + 4 (regs 2, 3)
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int k4 = 0; k4 < 2; ++k4)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int chunk = 2 * kk + k4;
            const float xp = *reinterpret_cast<const float*>(
                slot + xp_row[hf] + ((chunk ^ xp_key[hf]) << 4));
            const float x0 = *reinterpret_cast<const float*>(
                slot + x0_row[hf] + ((chunk ^ x0_key[hf]) << 4));
            split_tf32(cok[hf] ? xp * x0 : 0.f, ahi[kk][2 * k4 + hf],
                       alo[kk][2 * k4 + hf]);
          }
      fence_regs(acc);
      wg_fence();
      const uint32_t dhi = base + s * p.slot;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bhi = desc_kmajor(dhi + 32 * kk);
        const uint64_t blo = desc_kmajor(dhi + kDz + 32 * kk);
        // the first product of a chain overwrites acc
        wgmma_tf32<kNW>(acc, alo[kk], bhi, kk > 0 || i % kPromote != 0);
        wgmma_tf32<kNW>(acc, ahi[kk], blo, 1);
        wgmma_tf32<kNW>(acc, ahi[kk], bhi, 1);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      fence_regs(ahi);
      fence_regs(alo);
      mbar_arrive(empty(s));
      if (i % kPromote == kPromote - 1 || kb == kb1 - 1) {
#pragma unroll
        for (int e = 0; e < kNW / 2; ++e) sum[e] += acc[e];
      }
    }

    // accumulator: element 4 jj + 2 hf + e is channel r0 + 8 hf, output
    // 8 jj + 2 t + e
    float* dst = p.dst + part * p.part_stride;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (!cok[hf]) continue;
      const int c = c0 + r0 + 8 * hf;
#pragma unroll
      for (int jj = 0; jj < kNW / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + 8 * jj + 2 * t + e;
          if (o < p.Ho)
            dst[static_cast<long long>(o) * p.C + c] = sum[4 * jj + 2 * hf + e];
        }
    }
  }
}

// -- host side ---------------------------------------------------------------

// A (rows, cols) f32 matrix, row stride ld floats, as boxes of 32 columns
// x box_rows rows, 128-byte swizzle; past either extent reads 0.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const float* ptr,
                  long long rows, long long cols, long long ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {kKB, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

long long round_up(long long x, long long to) { return (x + to - 1) / to * to; }

// mp / 8 and the h a dx channel tile holds: m <= 8, 16, 32 take mp NH
// = 128, m <= 40 120 (three h of 40), m <= 64 64 (one h of 64, which
// leaves registers for its 32 x0 and dx0 values a column)
void dx_tiling(int m, int* Q, int* NH) {
  *Q = m <= 8 ? 1 : m <= 16 ? 2 : m <= 32 ? 4 : m <= 40 ? 5 : 8;
  *NH = *Q == 5 ? 3 : *Q == 8 ? 1 : 16 / *Q;
}

// The call's plan: a function of the shapes only, so every run of a shape
// sums in the same order.  Scratch floats, in order: dz^T hi and lo (Ho
// x ldn each), x0^T (m x ldn), x_prev^T (Hp x ldn), w^T hi and lo (Hp mp
// x ldo each), the dw part slabs (P x Ho x C when P > 1); each a multiple
// of 32 floats, so every piece starts 128-byte aligned.
struct Plan {
  long long N, ldn;
  int Q, NH, mp, ldo, n_kb_x, n_kb_w, kb_per_part, parts, hr;
  long long off_dlo, off_x0, off_xp, off_whi, off_wlo, off_parts, total;
};

Plan make_plan(int B, int Hp, int m, int D, int Ho) {
  Plan pl;
  pl.N = static_cast<long long>(B) * D;
  pl.ldn = round_up(pl.N, 32);
  dx_tiling(m, &pl.Q, &pl.NH);
  pl.mp = 8 * pl.Q;
  pl.ldo = static_cast<int>(round_up(Ho, 32));
  pl.n_kb_x = (Ho + kKB - 1) / kKB;
  pl.n_kb_w = static_cast<int>((pl.N + kKB - 1) / kKB);
  long long p = (pl.N + kPartCols - 1) / kPartCols;
  p = std::max(1LL, std::min<long long>(p, kMaxParts));
  pl.kb_per_part = static_cast<int>((pl.n_kb_w + p - 1) / p);
  pl.parts = (pl.n_kb_w + pl.kb_per_part - 1) / pl.kb_per_part;
  pl.hr = std::min(Hp, (kRows - 1) / m + 2);
  const long long dz = Ho * pl.ldn, wt = static_cast<long long>(Hp) * pl.mp *
                                          pl.ldo;
  pl.off_dlo = dz;
  pl.off_x0 = 2 * dz;
  pl.off_xp = pl.off_x0 + m * pl.ldn;
  pl.off_whi = pl.off_xp + Hp * pl.ldn;
  pl.off_wlo = pl.off_whi + wt;
  pl.off_parts = pl.off_wlo + wt;
  pl.total = pl.off_parts +
             (pl.parts > 1 ? round_up(static_cast<long long>(pl.parts) * Ho *
                                          Hp * m, 32)
                           : 0);
  return pl;
}

long long dx_fixed_bytes(int Ho) {
  return 1024 + round_up(round_up(Ho, 32) * kLdX * 4, 1024);
}

template <int Q, int NH>
int launch_dx(const CUtensorMap& thi, const CUtensorMap& tlo, DxParams p,
              cudaStream_t s) {
  constexpr long long slot = 2LL * 8 * Q * NH * kRowBytes;
  const long long fixed = dx_fixed_bytes(p.Ho);
  const long long room = kSmemMax - fixed - 16 * kMaxStagesX;
  p.stages = static_cast<int>(std::min<long long>(kMaxStagesX, room / slot));
  if (p.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = fixed + p.stages * slot + 16 * p.stages;
  cudaError_t err = cudaFuncSetAttribute(
      cin_bwd_dx_kernel<Q, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cin_bwd_dx_kernel<Q, NH>
      <<<static_cast<unsigned>((p.N + kRows - 1) / kRows), kThreads, smem,
         s>>>(thi, tlo, p);
  return static_cast<int>(cudaGetLastError());
}

int grid_for(long long n) {
  return static_cast<int>(std::min((n + 255) / 256, 4096LL));
}

}  // namespace

// Scratch floats the launcher needs (make_plan's pieces).
extern "C" long long cin_layer_bwd_scratch_floats(int B, int Hp, int m,
                                                  int D, int Ho) {
  return make_plan(B, Hp, m, D, Ho).total;
}

// w (Ho, Hp*m), x_prev (B, Hp, D), x0 (B, m, D), dz (B, Ho, D), all f32
// contiguous and 16-byte aligned -> dw (Ho, Hp*m), dx_prev, dx0.
// Requires B, D, Ho, Hp, m > 0, m <= 64, Ho <= 256, B D max(Hp, Ho, m)
// and Ho Hp m below 2^31 (else returns cudaErrorInvalidValue); scratch
// as cin_layer_bwd_scratch_floats says.  Launches the layout pre-passes,
// the dx and dw kernels and, when the plan cuts the columns into parts,
// their sum.  Returns 0, the first failing launch's cudaGetLastError(),
// -1 when libcuda has no cuTensorMapEncodeTiled or -(1000 + r) when it
// refuses a map with CUresult r.
extern "C" int cin_layer_bwd_launch(const float* w, const float* x_prev,
                                    const float* x0, const float* dz,
                                    float* dw, float* dx_prev, float* dx0,
                                    float* scratch, int B, int Hp, int m,
                                    int D, int Ho, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bd = static_cast<long long>(B) * D;
  const long long widest = std::max({Hp, Ho, m});
  if (B < 1 || D < 1 || Hp < 1 || m < 1 || Ho < 1 || m > 64 || Ho > 256 ||
      bd * widest > INT32_MAX ||
      static_cast<long long>(Ho) * Hp * m > INT32_MAX ||
      dx_fixed_bytes(Ho) + 2 * 2LL * 128 * kRowBytes + 64 > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const Plan pl = make_plan(B, Hp, m, D, Ho);
  const int C = Hp * m;
  float* const dhi = scratch;
  float* const dlo = scratch + pl.off_dlo;
  float* const x0t = scratch + pl.off_x0;
  // x_prev is x0 (layer 1) only where both pointers and both row counts
  // agree: x0 may also be x_prev's leading m rows
  float* const xpt =
      x_prev == x0 && Hp == m ? x0t : scratch + pl.off_xp;
  float* const whi = scratch + pl.off_whi;
  float* const wlo = scratch + pl.off_wlo;
  float* const parts = pl.parts > 1 ? scratch + pl.off_parts : dw;

  // layout pre-passes
  const unsigned tb = static_cast<unsigned>((bd + kTCols - 1) / kTCols);
  cin_bwd_transpose_kernel<<<tb, kTCols, 0, s>>>(dz, dhi, dlo, Ho, D, bd,
                                                 pl.ldn);
  cin_bwd_transpose_kernel<<<tb, kTCols, 0, s>>>(x0, x0t, nullptr, m, D, bd,
                                                 pl.ldn);
  if (xpt != x0t)
    cin_bwd_transpose_kernel<<<tb, kTCols, 0, s>>>(x_prev, xpt, nullptr, Hp,
                                                   D, bd, pl.ldn);
  const long long n_wt = static_cast<long long>(Hp) * pl.mp * pl.ldo;
  cin_bwd_split_wt_kernel<<<grid_for(n_wt), 256, 0, s>>>(
      w, whi, wlo, Ho, C, m, pl.mp, pl.ldo, n_wt);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;

  // dx
  CUtensorMap twhi, twlo, tdhi, tdlo, tx0, txp;
  const int n_dx = 8 * pl.Q * pl.NH;
  const long long wt_rows = static_cast<long long>(Hp) * pl.mp;
  CUresult r = make_map(encode, &twhi, whi, wt_rows, Ho, pl.ldo, n_dx);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &twlo, wlo, wt_rows, Ho, pl.ldo, n_dx);
  if (r == CUDA_SUCCESS) r = make_map(encode, &tdhi, dhi, Ho, bd, pl.ldn, kNW);
  if (r == CUDA_SUCCESS) r = make_map(encode, &tdlo, dlo, Ho, bd, pl.ldn, kNW);
  if (r == CUDA_SUCCESS) r = make_map(encode, &tx0, x0t, m, bd, pl.ldn, m);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &txp, xpt, Hp, bd, pl.ldn, pl.hr);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  DxParams px{dz, x_prev, x0, dx_prev, dx0, bd, Hp, m, D, Ho, pl.n_kb_x,
              static_cast<int>(round_up(Ho, 32)),
              (Hp + pl.NH - 1) / pl.NH, 0};
  switch (pl.Q) {
    case 1: err = launch_dx<1, 16>(twhi, twlo, px, s); break;
    case 2: err = launch_dx<2, 8>(twhi, twlo, px, s); break;
    case 4: err = launch_dx<4, 4>(twhi, twlo, px, s); break;
    case 5: err = launch_dx<5, 3>(twhi, twlo, px, s); break;
    default: err = launch_dx<8, 1>(twhi, twlo, px, s); break;
  }
  if (err != 0) return err;

  // dw
  DwParams wp;
  wp.dst = parts;
  wp.part_stride = pl.parts > 1 ? static_cast<long long>(Ho) * C : 0;
  wp.Hp = Hp;
  wp.m = m;
  wp.Ho = Ho;
  wp.C = C;
  wp.kb_per_part = pl.kb_per_part;
  wp.n_kb = pl.n_kb_w;
  wp.hr = pl.hr;
  wp.x0_off = 2 * kNW * kRowBytes;
  wp.xp_off = wp.x0_off +
              static_cast<uint32_t>(round_up(m * kRowBytes, 1024));
  wp.slot = wp.xp_off + static_cast<uint32_t>(round_up(pl.hr * kRowBytes,
                                                        1024));
  const size_t smem = 1024 + kStagesW * wp.slot + 16 * kStagesW;
  err = static_cast<int>(cudaFuncSetAttribute(
      cin_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err != 0) return err;
  const dim3 grid((C + kRows - 1) / kRows, (Ho + kNW - 1) / kNW, pl.parts);
  cin_bwd_dw_kernel<<<grid, kThreads, smem, s>>>(tdhi, tdlo, tx0, txp, wp);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || pl.parts == 1) return err;
  const long long n_w = static_cast<long long>(Ho) * C;
  cin_bwd_sum_parts_kernel<<<grid_for(n_w), 256, 0, s>>>(parts, dw, n_w,
                                                          pl.parts);
  return static_cast<int>(cudaGetLastError());
}
