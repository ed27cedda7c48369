// xDeepFM CIN layer: out[b,o,d] = sum_{h,j} w[o, h*m + j] *
// x_prev[b,h,d] * x0[b,j,d], w (H_out, Hp*m), x_prev (B, Hp, D),
// x0 (B, m, D), all f32 -> (B, H_out, D) f32.
//
// Replaces the Pallas kernel src/repro/kernels/cin.py (cin_layer), which
// forms Z = x_prev (x) x0 tile by tile in VMEM and contracts it with w on
// the MXU.
//
// Seen per (b, d) column, the layer is one product O = Z W^T with
// M = B*D rows, N = H_out and K = Hp*m, whose A operand
// Z[b*D + d][h*m + j] = x_prev[b,h,d] * x0[b,j,d] is never stored
// anywhere: each thread forms its z values in registers, in the layout
// of wgmma's A fragment, from x_prev and x0 staged in shared memory.
//
// Bound: operations.  At the published widths (H_out = 200, m = 39,
// D = 10) a layer does 2*200*Hp*39*10 flops a sample (6.1 M for Hp = 39,
// 31.2 M for Hp = 200) on 4*(Hp + 39 + 200)*10 bytes: thousands of flops
// a byte.  The products run on the tensor cores in 3xTF32, three TF32
// passes a product, so the least time counts them at 495/3 TFLOP/s.
//
// Why three passes: TF32 keeps 10 of f32's 23 mantissa bits, and one
// TF32 pass misses the 1e-4 gate at K = 7,800; splitting each operand
// into hi = tf32(x) and lo = tf32(x - hi) and summing a_lo*b_hi +
// a_hi*b_lo + a_hi*b_hi (the small terms first) meets it.
// tests/test_torch_tf32x3.py shows both on the CPU, for one pass whose
// sums round to nearest; the tensor cores' accumulation does not (see
// Promotion below), and the card test
// test_cin_kernel_stages_x_prev_in_chunks (K = 7,800 in one part) is
// what shows that the promotion interval holds the gate.
//
// Design (sm_90a, 384 threads: two consumer warpgroups, one producer):
// - A pre-pass (split_w_kernel) rounds w once a call into w_hi and w_lo,
//   (H_out, Kp) with K zero-padded to Kp, a multiple of 32 (at K = 1,521
//   the raw rows are 6,084 bytes, not a multiple of 16, which TMA needs).
// - A block owns 128 rows (64 a consumer warpgroup) and an N tile of 104
//   output channels (xDeepFM's H_out = 200 is two tiles).  The producer
//   warpgroup gives
//   its registers away (setmaxnreg 24), and one of its threads loads
//   the w_hi and w_lo tiles of each k-block (32 k, one 128-byte swizzled
//   row a channel) by TMA into a ring of four stages, with "full" (TMA
//   bytes) and "empty" (256 consumer arrivals) mbarriers.
// - The consumers stage x0 (m x 128 rows) once and x_prev a chunk of h
//   at a time (as many h as shared memory holds), rows padded to 136
//   floats so that the four k of a quad hit other banks.  For each
//   k-block each thread forms its 16 z values, steps (h, j) through k by
//   4 without a division, splits them with cvt.rna.tf32, and issues
//   three wgmma m64n104k8 per k8 step (tf32, A from registers, B from the
//   ring, K-major).  Past K the z values are 0, and w's pad is 0.
// - Promotion: the tensor cores add each product into their f32
//   accumulator with less than round-to-nearest (a first design that
//   chained all of K = 7,800 in one accumulator missed the 1e-4 gate:
//   3.1e-4 on the card).  So a wgmma chain spans two k-blocks (24
//   wgmma), starting from 0, and each chain is added into an f32 sum on
//   the CUDA cores, as FP8 GEMMs promote their accumulators.  The chain
//   and the sum take 104 registers a thread; a 200-wide tile would not
//   leave room for both.
// - Split K: where the row tiles alone leave the card's SMs idle (B =
//   512 gives 40 tiles of 128 rows), K is cut into P parts of whole
//   k-blocks (grid.z).  Each part writes its partial sums to a scratch
//   slab, and reduce_parts_kernel adds the slabs in order p = 0..P-1:
//   no float atomics, so every run gives the same bits.  With P = 1 the
//   consumers write the output directly.  The plan (P, chunk sizes)
//   depends only on the shapes and the card's SM count.
// - The sums go straight from registers to out[(b*H_out + o)*D + d]:
//   eight consecutive rows of a column are mostly consecutive d, and the
//   output is 1/300 of the bytes the products are worth.

#include "hopper.cuh"

#include <algorithm>

namespace {

using namespace hopper;

constexpr int kRows = 128;     // rows (b, d) per block, 64 per consumer
constexpr int kKB = 32;        // k per k-block: one 128-byte row of f32
constexpr int kStages = 4;     // ring slots, each a w_hi and a w_lo tile
constexpr int kPromote = 2;    // k-blocks per wgmma accumulation chain
constexpr int kThreads = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int kLd = kRows + 8;  // staged x rows, padded against conflicts
constexpr int kSmemMax = 227 * 1024;
constexpr int kRowBytes = kKB * 4;  // one swizzled row of a w tile
constexpr int kNT = 104;       // output channels per N tile

struct Params {
  const float* xp;
  const float* x0;
  float* dst;              // out, or the part slabs when P > 1
  long long part_stride;   // elements between part slabs (0 when P = 1)
  long long n_rows;        // B * D
  int Hp, m, D, Ho, K;
  int kb_per_part;         // k-blocks per part (the last may have fewer)
  int n_kb;                // k-blocks in all, ceil(K / 32)
  int kb_per_chunk;        // k-blocks per staged chunk of x_prev
  int hc;                  // x_prev rows (h) the chunk buffer holds
};

// -- the kernels ---------------------------------------------------------------

// w (Ho, K) -> w_hi, w_lo (Ho, Kp), zero past K.
__global__ void split_w_kernel(const float* __restrict__ w,
                               float* __restrict__ hi, float* __restrict__ lo,
                               int Ho, int K, int Kp) {
  const long long n = static_cast<long long>(Ho) * Kp;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long o = i / Kp;
    const int k = static_cast<int>(i - o * Kp);
    uint32_t h = 0, l = 0;
    if (k < K) split_tf32(w[o * K + k], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

// out[i] = ((parts[0][i] + parts[1][i]) + ...) + parts[P-1][i].
__global__ void reduce_parts_kernel(const float* __restrict__ parts,
                                    float* __restrict__ out, long long n,
                                    int P) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = parts[i];
    for (int q = 1; q < P; ++q) s += parts[q * n + i];
    out[i] = s;
  }
}

// Stages src rows i0 .. i0 + ni - 1 (x_prev's h or x0's j; `per_b` of
// them a sample) of the block's rows r0 .. r0 + 127 into s[i * kLd +
// row], reading the samples' contiguous runs in order; rows past n_rows
// are 0.  Run by the 256 consumer threads.
__device__ __forceinline__ void stage_rows(float* s, const float* src,
                                           long long r0, long long n_rows,
                                           int D, int per_b, int i0, int ni,
                                           int ctid) {
  const long long r_end = min(r0 + kRows, n_rows);
  const long long b_first = r0 / D;
  const int nb = static_cast<int>((r_end - 1) / D - b_first) + 1;
  const int run = ni * D;  // floats of one sample's run
  const int first = static_cast<int>(r0 - b_first * D);  // row of b_first, d 0 is -first
  const float* sb = src + (b_first * per_b + i0) * D;
  for (int e = ctid; e < nb * run; e += 256) {
    const int bl = e / run, rem = e - bl * run;
    const int i = rem / D, d = rem - i * D;
    const int row = bl * D + d - first;
    if (row >= 0 && row < kRows)
      s[i * kLd + row] = sb[static_cast<long long>(bl) * per_b * D + rem];
  }
  const int valid = static_cast<int>(r_end - r0);
  if (valid < kRows) {
    const int pad = kRows - valid;
    for (int e = ctid; e < ni * pad; e += 256)
      s[(e / pad) * kLd + valid + e % pad] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    cin_wgmma_kernel(const __grid_constant__ CUtensorMap thi,
                     const __grid_constant__ CUtensorMap tlo,
                     const Params p) {
  constexpr uint32_t kTile = kNT * kRowBytes;  // 104 channels x 32 k
  constexpr uint32_t kStage = 2 * kTile;      // w_hi tile, w_lo tile
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align every tile to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  float* x0_s = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                         kStages * kStage);  // [m][kLd]
  float* xp_s = x0_s + p.m * kLd;                            // [hc][kLd]
  const uint32_t bars = base + kStages * kStage +
                        static_cast<uint32_t>((p.m + p.hc) * kLd * 4);
  auto full = [&](int s) -> uint32_t { return bars + 8 * s; };
  auto empty = [&](int s) -> uint32_t { return bars + 8 * (kStages + s); };
  auto tile = [&](int s, int lo) -> uint32_t {
    return base + s * kStage + lo * kTile;
  };

  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int n0 = blockIdx.y * kNT;
  const int part = blockIdx.z;
  const int kb0 = part * p.kb_per_part;
  const int kb1 = min(p.n_kb, kb0 + p.kb_per_part);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread loads every w tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      for (int i = 0; i < kb1 - kb0; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kStage);
        const int k = (kb0 + i) * kKB;
        tma_load(tile(s, 0), &thi, full(s), k, n0);
        tma_load(tile(s, 1), &tlo, full(s), k, n0);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int ctid = threadIdx.x;
    const int lane = ctid % 32;
    const int t = lane % 4;  // the fragment's k column (and + 4)
    const int row0 = 64 * wg + 16 * ((ctid % 128) / 32) + lane / 4;  // + 8

    stage_rows(x0_s, p.x0, r0, p.n_rows, p.D, p.m, 0, p.m, ctid);
    // acc: the tensor cores' chain over kPromote k-blocks; sum: the f32
    // sum of the chains, added on the CUDA cores
    float acc[kNT / 2], sum[kNT / 2];
#pragma unroll
    for (int e = 0; e < kNT / 2; ++e) acc[e] = sum[e] = 0.f;

    for (int c0 = kb0; c0 < kb1; c0 += p.kb_per_chunk) {
      const int c1 = min(kb1, c0 + p.kb_per_chunk);
      const int h_lo = c0 * kKB / p.m;
      const int h_hi = min(p.Hp, (c1 * kKB - 1) / p.m + 1);
      bar_sync(1);  // the previous chunk's x_prev is consumed
      stage_rows(xp_s, p.xp, r0, p.n_rows, p.D, p.Hp, h_lo, h_hi - h_lo,
                 ctid);
      bar_sync(1);
      // this thread's k = c0 * 32 + t + 4 i, as (h, j) = (k / m, k % m)
      int k = c0 * kKB + t;
      int j = k % p.m;
      const float* xh = xp_s + (k / p.m - h_lo) * kLd;
      const float* xj = x0_s + j * kLd;
      for (int kb = c0; kb < c1; ++kb) {
        // A fragments: k8 step kk holds k = 8 kk + t (regs 0, 1: rows
        // row0, row0 + 8) and 8 kk + t + 4 (regs 2, 3)
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float z0 = 0.f, z1 = 0.f;
            if (k < p.K) {
              z0 = xh[row0] * xj[row0];
              z1 = xh[row0 + 8] * xj[row0 + 8];
            }
            split_tf32(z0, ahi[kk][2 * hf], alo[kk][2 * hf]);
            split_tf32(z1, ahi[kk][2 * hf + 1], alo[kk][2 * hf + 1]);
            k += 4;
            j += 4;
            xj += 4 * kLd;
            while (j >= p.m) {
              j -= p.m;
              xj -= p.m * kLd;
              xh += kLd;
            }
          }
        const int i = kb - kb0, s = i % kStages;
        mbar_wait(full(s), (i / kStages) & 1);
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dhi = desc_kmajor(tile(s, 0) + 32 * kk);
          const uint64_t dlo = desc_kmajor(tile(s, 1) + 32 * kk);
          // the first product of a chain overwrites acc
          wgmma_tf32<kNT>(acc, alo[kk], dhi, kk > 0 || i % kPromote != 0);
          wgmma_tf32<kNT>(acc, ahi[kk], dlo, 1);
          wgmma_tf32<kNT>(acc, ahi[kk], dhi, 1);
        }
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
        fence_regs(ahi);
        fence_regs(alo);
        mbar_arrive(empty(s));
        if (i % kPromote == kPromote - 1 || kb == kb1 - 1) {
#pragma unroll
          for (int e = 0; e < kNT / 2; ++e) sum[e] += acc[e];
        }
      }
    }

    // accumulator: element 4 jj + 2 half + e is row row0 + 8 half,
    // column 8 jj + 2 t + e
    float* dst = p.dst + part * p.part_stride;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = r0 + row0 + 8 * half;
      if (row >= p.n_rows) continue;
      const long long b = row / p.D;
      float* orow = dst + b * p.Ho * p.D + (row - b * p.D);
#pragma unroll
      for (int jj = 0; jj < kNT / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = n0 + 8 * jj + 2 * t + e;
          if (o < p.Ho)
            orow[static_cast<long long>(o) * p.D] = sum[4 * jj + 2 * half + e];
        }
    }
  }
}

// -- host side ---------------------------------------------------------------

// A (Ho, Kp) f32 matrix as boxes of 32 k x 104 channels, 128-byte
// swizzle; channels past Ho read as 0.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const float* ptr,
                  int Ho, long long Kp) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kp),
                              static_cast<cuuint64_t>(Ho)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kp) * 4};
  const cuuint32_t box[2] = {kKB, kNT};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Plan {
  int n_tiles;  // N tiles
  int parts;    // K parts (P)
  Params p;
  size_t smem;
};

// The launch plan: a function of the shapes and the SM count only, so
// every run of a shape sums in the same order.
int make_plan(int B, int Hp, int m, int D, int Ho, Plan* pl) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params& p = pl->p;
  pl->n_tiles = (Ho + kNT - 1) / kNT;
  p.Hp = Hp;
  p.m = m;
  p.D = D;
  p.Ho = Ho;
  p.K = Hp * m;
  p.n_kb = (p.K + kKB - 1) / kKB;
  p.n_rows = static_cast<long long>(B) * D;
  const long long fixed = 1024 + 2LL * kStages * kNT * kRowBytes +
                          static_cast<long long>(m) * kLd * 4 +
                          16 * kStages;
  const long long hc_max = (kSmemMax - fixed) / (kLd * 4);
  // a chunk of c k-blocks spans at most floor((32c - 1) / m) + 2 h
  const long long kbc_max = (hc_max - 1) * m / kKB;
  if (fixed >= kSmemMax || kbc_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Hp <= hc_max) {
    p.hc = Hp;
    p.kb_per_chunk = p.n_kb;
  } else {
    p.hc = static_cast<int>(hc_max);
    p.kb_per_chunk = static_cast<int>(kbc_max);
  }
  // Split K where the row tiles leave SMs idle: the fewest parts that
  // minimise waves / parts, a part costing 5 % more for its slab.
  const long long blocks = (p.n_rows + kRows - 1) / kRows * pl->n_tiles;
  const int max_parts = std::max(1, std::min(16, p.n_kb / 4));
  int best = 1;
  double best_cost = 1e300;
  for (int q = 1; q <= max_parts; ++q) {
    const double waves = static_cast<double>((blocks * q + n_sm - 1) / n_sm);
    const double cost = waves / q * (q > 1 ? 1.05 : 1.0);
    if (cost < best_cost) {
      best_cost = cost;
      best = q;
    }
  }
  p.kb_per_part = (p.n_kb + best - 1) / best;
  pl->parts = (p.n_kb + p.kb_per_part - 1) / p.kb_per_part;
  pl->smem = static_cast<size_t>(fixed) +
             static_cast<size_t>(p.hc) * kLd * 4;
  return 0;
}

int grid_for(long long n) {
  return static_cast<int>(std::min((n + 255) / 256, 2048LL));
}

}  // namespace

// All pointers f32 and contiguous.  The scratch comes from the caller:
// alloc(n, alloc_ctx) returns n floats on the current device that stay
// valid until the launches on `stream` have run, or null on failure.
// It is asked for w split into its TF32 halves (2 * Ho * Kp floats, K
// padded to Kp, a multiple of 32) and, when the plan cuts K into P > 1
// parts, for P partial outputs (P * B * Ho * D floats).  Requires B, Hp,
// m, D, Ho > 0, B * D / 128 < 2^31 and x0's m rows with one chunk of
// x_prev to fit shared memory (m up to about 220).  Launches
// split_w_kernel, the main kernel and, when P > 1, reduce_parts_kernel.
// Returns 0, a cudaError_t, or -1 when libcuda has no
// cuTensorMapEncodeTiled and -(1000 + r) when it refuses a map with
// CUresult r.
extern "C" int cin_layer_launch(const float* w, const float* x_prev,
                                const float* x0, float* out, int B, int Hp,
                                int m, int D, int Ho,
                                float* (*alloc)(long long, void*),
                                void* alloc_ctx, void* stream) {
  Plan pl;
  int err = make_plan(B, Hp, m, D, Ho, &pl);
  if (err != 0) return err;
  if ((pl.p.n_rows + kRows - 1) / kRows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long kp = static_cast<long long>(pl.p.n_kb) * kKB;
  const long long n_out = pl.p.n_rows * Ho;
  float* const w_split = alloc(2LL * Ho * kp, alloc_ctx);
  float* const parts_ws =
      pl.parts > 1 ? alloc(pl.parts * n_out, alloc_ctx) : nullptr;
  if (w_split == nullptr || (pl.parts > 1 && parts_ws == nullptr))
    return static_cast<int>(cudaErrorMemoryAllocation);
  float* w_hi = w_split;
  float* w_lo = w_split + static_cast<long long>(Ho) * kp;
  split_w_kernel<<<grid_for(Ho * kp), 256, 0, s>>>(w, w_hi, w_lo, Ho,
                                                   pl.p.K,
                                                   static_cast<int>(kp));
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  CUtensorMap thi, tlo;
  CUresult r = make_map(encode, &thi, w_hi, Ho, kp);
  if (r == CUDA_SUCCESS) r = make_map(encode, &tlo, w_lo, Ho, kp);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  pl.p.xp = x_prev;
  pl.p.x0 = x0;
  pl.p.dst = pl.parts > 1 ? parts_ws : out;
  pl.p.part_stride = pl.parts > 1 ? n_out : 0;
  err = static_cast<int>(cudaFuncSetAttribute(
      cin_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pl.smem)));
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>((pl.p.n_rows + kRows - 1) / kRows),
                  pl.n_tiles, pl.parts);
  cin_wgmma_kernel<<<grid, kThreads, pl.smem, s>>>(thi, tlo, pl.p);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || pl.parts == 1) return err;
  reduce_parts_kernel<<<grid_for(n_out), 256, 0, s>>>(parts_ws, out, n_out,
                                                      pl.parts);
  return static_cast<int>(cudaGetLastError());
}
