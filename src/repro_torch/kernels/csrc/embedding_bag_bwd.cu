// Embedding bag: the backward pass into the table.
//
// Stands for jax.grad of the fixed-size bag (src/repro/models/
// embedding.py:58, fixed_bag), which the JAX package trains through its
// jnp form (a take and a weighted sum); the Pallas kernel
// src/repro/kernels/embedding_bag.py has no backward.  With dOut (B, D)
// the gradient of the (B, D) bag sums, it computes the dense (V, D)
//
//   dtable[v] = sum over (b, l) with ids[b, l] = v of w[b, l] dOut[b]
//
// as JAX's gradient is dense.  Rows no id names are written as zero.
//
// Determinism: a row's terms are summed in one fixed order, that of the
// flat positions b L + l, one fmaf chain a column from zero, so the same
// inputs give the same bits and no float atomics are used.  An id whose
// weight is exactly 0 (padded history) or that lies outside [0, V) adds
// nothing and is skipped.
//
// Bound: bytes: dOut, ids and weights read once and the dense (V, D)
// gradient written once (at the serving window's V = 4000, D = 32,
// B = 512, L = 100 about 1.1 MB, a third of a microsecond at the card's
// memory rate); a launch costs more.
//
// Design: the kernels order the ids themselves, a two-level counting
// sort by row, in two launches and with no library sort:
// - chunk kernel, a block a chunk of kChunk flat positions: the rows fall
//   into row blocks of rpb rows (about 1024 row blocks, so that the few
//   popular rows of a skewed table fall into blocks of their own); each
//   lane loads its positions' ids and weights at once, the block counts
//   its positions a row block (warp by warp, __match_any_sync for equal
//   keys), scans, and writes each position's (bag, id, weight) grouped
//   by row block, each group in flat order, with the groups' offsets;
// - rows kernel, a block a row block: gathers its groups chunk by chunk
//   (so in flat order), counts its rows (integer atomics in shared
//   memory, one a row a warp step: the counts do not depend on the
//   order), scans them, and places each position's (bag, weight) row by
//   row in flat order, a piece at a time (8 warps each a slice with
//   cursors of their own where rpb is small, else one warp; stable, 32
//   at a time by __match_any_sync); then each warp owns rows and adds a
//   row's terms in that order, each lane a column (a pass of 32 columns
//   at a time), 64 terms loaded before they are added and the next 64
//   entries while these are, and zero where no id names the row.  A
//   skewed id that holds most positions is one long run of one warp: its
//   sum is a chain of fmaf as long as the run, which the fixed order
//   requires.
// Nothing runs before them but the allocation of the output and of their
// int32 scratch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;          // positions a chunk block
constexpr int kRowBlocks = 1024;      // row blocks aimed at
constexpr int kMaxRowsPerBlock = 8192;
constexpr int kMaxChunks = 16384;     // n up to 33.5 M positions
constexpr int kPiece = 2048;          // positions placed a pass
constexpr int kPlaceInts = 8192;      // cursors of the placing warps

struct Plan {
  int rpb, nrb, C;
  Plan(long long n, long long V) {
    long long r = (V + kRowBlocks - 1) / kRowBlocks;
    if (r < 1) r = 1;
    if (r > kMaxRowsPerBlock) r = kMaxRowsPerBlock;
    rpb = static_cast<int>(r);
    nrb = static_cast<int>((V + r - 1) / r);
    C = static_cast<int>((n + kChunk - 1) / kChunk);
  }
  // warps that place a piece: each needs rpb cursors of its own
  int nwp() const { return kWarps * rpb <= kPlaceInts ? kWarps : 1; }
  long long pos1() const { return 0; }
  long long pos2() const { return 4LL * C * kChunk; }  // pos1: int4s
  long long off(long long n) const { return pos2() + 2 * n; }  // int2s
  long long ints(long long n) const {
    return off(n) + static_cast<long long>(C) * (nrb + 1);
  }
  size_t chunk_smem() const {
    return 4 * (static_cast<size_t>(kWarps) * nrb + nrb + 1 + kWarps);
  }
  size_t rows_smem() const {
    return 4 * (2 * static_cast<size_t>(rpb) + 1 + 2 * static_cast<size_t>(C) +
                1 + 3 * kPiece + static_cast<size_t>(nwp()) * rpb + kWarps +
                2);
  }
};

// Exclusive scan of a[0, m) in place by the whole block, a[m] = the
// total; ws holds kWarps ints.  Every thread calls it.
__device__ void block_scan(int* a, int m, int* ws) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int seg = (m + kThreads - 1) / kThreads;
  const int lo = min(tid * seg, m), hi = min(lo + seg, m);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  int run = x - s, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) run += ws[w];
    total += ws[w];
  }
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  if (tid == 0) a[m] = total;
  __syncthreads();
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_bwd_chunk_kernel(const I* __restrict__ ids,
                                   const float* __restrict__ weights,
                                   int4* __restrict__ pos1,
                                   int* __restrict__ off, int n, int nrb,
                                   int rpb, int V, int L) {
  extern __shared__ int sh[];
  int* hist = sh;                  // [warp][row block]: counts, cursors
  int* tot = hist + kWarps * nrb;  // nrb + 1
  int* ws = tot + nrb + 1;         // kWarps
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid % 32,
            warp = tid / 32;
  constexpr int kSteps = kChunk / kWarps / 32;
  const int p0 = c * kChunk + warp * (kChunk / kWarps) + lane;
  for (int i = tid; i < kWarps * nrb; i += kThreads) hist[i] = 0;
  // this lane's positions p0 + 32 s: id, weight and row block (-1 if it
  // adds nothing), every load issued before the first use
  int id[kSteps], key[kSteps];
  float wt[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int p = min(p0 + 32 * s, n - 1);
    id[s] = static_cast<int>(ids[p]);
    wt[s] = weights ? weights[p] : 1.f;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const bool add = p0 + 32 * s < n && id[s] >= 0 && id[s] < V && wt[s] != 0.f;
    key[s] = add ? id[s] / rpb : -1;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const unsigned peers = __match_any_sync(0xffffffffu, key[s]);
    if (key[s] >= 0 && lane == __ffs(peers) - 1)
      hist[warp * nrb + key[s]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int rb = tid; rb < nrb; rb += kThreads) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += hist[w * nrb + rb];
    tot[rb] = t;
  }
  __syncthreads();
  block_scan(tot, nrb, ws);
  int* my_off = off + static_cast<long long>(c) * (nrb + 1);
  for (int rb = tid; rb <= nrb; rb += kThreads) {
    my_off[rb] = tot[rb];
    if (rb < nrb) {
      int run = tot[rb];
      for (int w = 0; w < kWarps; ++w) {
        const int h = hist[w * nrb + rb];
        hist[w * nrb + rb] = run;
        run += h;
      }
    }
  }
  __syncthreads();
  // (bag, id, weight) of each position, grouped by row block, in order
  int4* my_pos = pos1 + static_cast<long long>(c) * kChunk;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const unsigned peers = __match_any_sync(0xffffffffu, key[s]);
    const int rank = __popc(peers & lt);
    const int dst = key[s] >= 0 ? hist[warp * nrb + key[s]] + rank : 0;
    __syncwarp();
    if (key[s] >= 0) {
      my_pos[dst] = make_int4((p0 + 32 * s) / L, id[s], __float_as_int(wt[s]),
                              0);
      if (rank == 0) hist[warp * nrb + key[s]] += __popc(peers);
    }
    __syncwarp();
  }
}

// The segment c with seg[c] <= i < seg[c + 1].
__device__ __forceinline__ int find_seg(const int* seg, int C, int i) {
  int lo = 0, hi = C;  // seg[lo] <= i, seg[hi] > i
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (seg[mid] <= i) lo = mid;
    else hi = mid;
  }
  return lo;
}

// row[c0 + lane] = the run's terms (bag, weight) in pos2[s0, s1), one
// fmaf chain in order; the terms of a batch of 64 are all loaded before
// they are added, and the next batch's entries while they are.  The
// loads are unconditional (past the run a lane reads bag 0, past D the
// last column), so that they are issued together.
__device__ __forceinline__ void row_sum(const int2* __restrict__ pos2, int s0,
                                        int s1, const float* __restrict__ dout,
                                        int D, float* row, int c0, int lane) {
  const int c = c0 + lane;
  const int cc = min(c, D - 1);  // every lane loads: the loads go together
  const int2 zero = make_int2(0, 0);
  float acc = 0.f;
  int2 e0 = s0 + lane < s1 ? pos2[s0 + lane] : zero;
  int2 e1 = s0 + 32 + lane < s1 ? pos2[s0 + 32 + lane] : zero;
  for (int j0 = s0; j0 < s1; j0 += 64) {
    const int jn = j0 + 64 + lane;
    const int2 n0 = jn < s1 ? pos2[jn] : zero;
    const int2 n1 = jn + 32 < s1 ? pos2[jn + 32] : zero;
    const int cnt = min(64, s1 - j0);
    float gv[64];
#pragma unroll
    for (int u = 0; u < 64; ++u) {
      const int bs = __shfl_sync(0xffffffffu, u < 32 ? e0.x : e1.x, u % 32);
      gv[u] = dout[static_cast<long long>(bs) * D + cc];
    }
#pragma unroll
    for (int u = 0; u < 64; ++u) {
      const float w = __int_as_float(
          __shfl_sync(0xffffffffu, u < 32 ? e0.y : e1.y, u % 32));
      if (u < cnt) acc = fmaf(w, gv[u], acc);
    }
    e0 = n0;
    e1 = n1;
  }
  if (c < D) row[c] = acc;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_bwd_rows_kernel(const I* __restrict__ ids,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ dout,
                                  float* __restrict__ dtable,
                                  const int4* __restrict__ pos1,
                                  int2* __restrict__ pos2,
                                  const int* __restrict__ off, int C, int nrb,
                                  int rpb, int nwp, int V, int D, int L) {
  extern __shared__ int sh[];
  const int rb = blockIdx.x, tid = threadIdx.x, lane = tid % 32,
            warp = tid / 32;
  const int v0 = rb * rpb, nrows = min(rpb, V - v0);
  int* cnt = sh;              // nrows + 1: counts, then starts
  int* cur = cnt + rpb + 1;   // nrows: cursors
  int* seg = cur + rpb;       // C + 1: the groups' lengths, then starts
  int* sst = seg + C + 1;     // C: each group's place in pos1
  int* pb = sst + C;          // kPiece: a piece's bags
  int* pr = pb + kPiece;      // kPiece: its rows
  float* pw = reinterpret_cast<float*>(pr + kPiece);  // kPiece: weights
  int* hw = pr + 2 * kPiece;  // [nwp][rpb]: a placing warp's rows
  int* ws = hw + nwp * rpb;   // kWarps
  int* base_s = ws + kWarps;  // 1: this block's place in pos2
  if (tid == 0) *base_s = 0;
  for (int r = tid; r < nrows; r += kThreads) cnt[r] = 0;
  __syncthreads();
  int base_part = 0;
  for (int c = tid; c < C; c += kThreads) {
    const int* o = off + static_cast<long long>(c) * (nrb + 1) + rb;
    seg[c] = o[1] - o[0];
    sst[c] = c * kChunk + o[0];
    base_part += o[0];  // the positions of earlier row blocks in chunk c
  }
  if (base_part) atomicAdd(base_s, base_part);
  __syncthreads();
  block_scan(seg, C, ws);
  const int total = seg[C], base = *base_s;
  const unsigned lt = (1u << lane) - 1u;
  // count the rows, one atomic a row a warp step
  for (int i0 = 32 * warp; i0 < total; i0 += kThreads) {
    const int i = i0 + lane;
    int row = -1;
    if (i < total) {
      const int c = find_seg(seg, C, i);
      row = pos1[sst[c] + i - seg[c]].y - v0;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, row);
    if (row >= 0 && __popc(peers & lt) == 0)
      atomicAdd(&cnt[row], __popc(peers));
  }
  __syncthreads();
  block_scan(cnt, nrows, ws);
  for (int r = tid; r < nrows; r += kThreads) cur[r] = cnt[r];
  __syncthreads();
  // place (bag, weight) row by row in flat order, a piece at a time:
  // nwp warps each a slice of the piece, with cursors of their own
  for (int lo = 0; lo < total; lo += kPiece) {
    const int m = min(kPiece, total - lo);
    for (int j = tid; j < m; j += kThreads) {
      const int i = lo + j;
      const int c = find_seg(seg, C, i);
      const int4 e = pos1[sst[c] + i - seg[c]];
      pb[j] = e.x;
      pr[j] = e.y - v0;
      pw[j] = __int_as_float(e.z);
    }
    const int per = (m + nwp - 1) / nwp;
    const int a = min(m, warp * per), e = min(m, a + per);
    if (warp < nwp) {
      for (int r = lane; r < nrows; r += 32) hw[warp * rpb + r] = 0;
    }
    __syncthreads();
    if (warp < nwp) {
      for (int j0 = a; j0 < e; j0 += 32) {
        const int j = j0 + lane;
        const int row = j < e ? pr[j] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, row);
        if (row >= 0 && __popc(peers & lt) == 0)
          hw[warp * rpb + row] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    for (int r = tid; r < nrows; r += kThreads) {
      int run = cur[r];
      for (int w = 0; w < nwp; ++w) {
        const int h = hw[w * rpb + r];
        hw[w * rpb + r] = run;
        run += h;
      }
      cur[r] = run;
    }
    __syncthreads();
    if (warp < nwp) {
      for (int j0 = a; j0 < e; j0 += 32) {
        const int j = j0 + lane;
        const bool in = j < e;
        const int row = in ? pr[j] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, row);
        const int rank = __popc(peers & lt);
        const int dst = in ? hw[warp * rpb + row] + rank : 0;
        __syncwarp();
        if (in) {
          pos2[base + dst] = make_int2(pb[j], __float_as_int(pw[j]));
          if (rank == 0) hw[warp * rpb + row] += __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  // a warp a row: its terms in flat order, a lane a column; zero where no
  // id names the row
  for (int r = warp; r < nrows; r += kWarps) {
    const int s0 = base + cnt[r], s1 = base + cnt[r + 1];
    float* row = dtable + static_cast<long long>(v0 + r) * D;
    if (s0 == s1) {
      for (int c = lane; c < D; c += 32) row[c] = 0.f;
      continue;
    }
    for (int c0 = 0; c0 < D; c0 += 32)
      row_sum(pos2, s0, s1, dout, D, row, c0, lane);
  }
}

template <typename I>
int launch(const I* ids, const float* weights, const float* dout,
           float* dtable, int* scratch, int n, int D, int L, int V,
           const Plan& pl, int max_optin, cudaStream_t st) {
  const size_t s1 = pl.chunk_smem(), s2 = pl.rows_smem();
  if (s1 > static_cast<size_t>(max_optin) ||
      s2 > static_cast<size_t>(max_optin))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (s1 > 48 * 1024) {
    err = cudaFuncSetAttribute(embedding_bag_bwd_chunk_kernel<I>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s1));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (s2 > 48 * 1024) {
    err = cudaFuncSetAttribute(embedding_bag_bwd_rows_kernel<I>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s2));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int4* pos1 = reinterpret_cast<int4*>(scratch + pl.pos1());
  int2* pos2 = reinterpret_cast<int2*>(scratch + pl.pos2());
  int* off = scratch + pl.off(n);
  embedding_bag_bwd_chunk_kernel<I><<<pl.C, kThreads, s1, st>>>(
      ids, weights, pos1, off, n, pl.nrb, pl.rpb, V, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  embedding_bag_bwd_rows_kernel<I><<<pl.nrb, kThreads, s2, st>>>(
      ids, weights, dout, dtable, pos1, pos2, off, pl.C, pl.nrb, pl.rpb,
      pl.nwp(), V, D, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// int32 scratch the launch needs for n = B L ids into V rows.
extern "C" long long embedding_bag_bwd_scratch_ints(long long n,
                                                    long long V) {
  return Plan(n, V).ints(n);
}

// ids (B, L) int32 (ids64 = 0) or int64 (ids64 = 1), weights (B, L) or
// null (plain sums), dout (B, D), all contiguous; writes every row of
// dtable (V, D).  n = B L > 0, D > 0, V > 0.
extern "C" int embedding_bag_bwd_launch(const void* ids, int ids64,
                                        const float* weights,
                                        const float* dout, float* dtable,
                                        int* scratch, long long n, int D,
                                        int L, long long V, void* stream) {
  if (n <= 0 || D <= 0 || L <= 0 || V <= 0 || V > 0x7fffffffLL ||
      n > 0x7fffffffLL - kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl(n, V);
  if (pl.C > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), vi = static_cast<int>(V);
  if (ids64)
    return launch(static_cast<const int64_t*>(ids), weights, dout, dtable,
                  scratch, ni, D, L, vi, pl, max_optin, st);
  return launch(static_cast<const int32_t*>(ids), weights, dout, dtable,
                scratch, ni, D, L, vi, pl, max_optin, st);
}
