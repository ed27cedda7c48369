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
// as JAX's gradient is dense.  Rows no id names stay zero.
//
// Determinism: a row's terms are summed in one fixed order, that of the
// flat positions b L + l.  The binding builds that order on the device
// as index preparation: a stable sort of the flat ids, in which an id
// whose weight is exactly 0 (padded history) is keyed V and so sorts
// after every real row and is skipped.  The sums are this kernel's:
// a warp owns a run of equal keys and adds its terms in sorted order,
// each lane its columns, so the same inputs give the same bits and no
// float atomics are used.
//
// Bound: bytes: dOut, ids and weights read once and the dense (V, D)
// gradient written once (at the serving window's V = 4000, D = 32,
// B = 512, L = 100 about 1.1 MB, a third of a microsecond at the card's
// memory rate).  The sort and the zeroing of dtable are the binding's.
//
// Design: one warp per sorted position; a warp whose position does not
// start a run (or starts the skipped run) leaves at once.  A run's
// entries are read 32 at a time, one a lane (key, position, weight),
// and handed to every lane by __shfl_sync; each lane then adds weight *
// dOut[position / L] into its columns lane, lane + 32, ... (four a lane
// a pass, passes of 128 columns).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr int kCols = 4;   // columns a lane a pass

__global__ void __launch_bounds__(kWarps * 32)
    embedding_bag_bwd_kernel(const int64_t* __restrict__ keys,
                             const int64_t* __restrict__ perm,
                             const float* __restrict__ weights,
                             const float* __restrict__ dout,
                             float* __restrict__ dtable, long long n, int D,
                             int L, long long V) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int64_t key = keys[i];
  if (key >= V || (i > 0 && keys[i - 1] == key)) return;
  float* row = dtable + key * D;
  for (int c0 = 0; c0 < D; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
    for (long long j0 = i;; j0 += 32) {
      const long long j = j0 + lane;
      const bool in = j < n && keys[j] == key;  // a prefix of the lanes
      const int64_t pos = in ? perm[j] : 0;
      const float w = in ? (weights ? weights[pos] : 1.f) : 0.f;
      const int cnt = __popc(__ballot_sync(0xffffffffu, in));
      for (int s = 0; s < cnt; ++s) {
        const int64_t ps = __shfl_sync(0xffffffffu, pos, s);
        const float ws = __shfl_sync(0xffffffffu, w, s);
        const float* g = dout + (ps / L) * D;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < D) acc[k] = fmaf(ws, g[c], acc[k]);
        }
      }
      if (cnt < 32) break;
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < D) row[c] = acc[k];
    }
  }
}

}  // namespace

// keys (n,) sorted ascending, stable (ids, with V for skipped entries),
// perm (n,) their flat positions b L + l, weights (B, L) or null (plain
// sums), dout (B, D); dtable (V, D) zeroed by the caller.
extern "C" int embedding_bag_bwd_launch(const int64_t* keys,
                                        const int64_t* perm,
                                        const float* weights,
                                        const float* dout, float* dtable,
                                        long long n, int D, int L,
                                        long long V, void* stream) {
  if (n <= 0 || D <= 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  embedding_bag_bwd_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      keys, perm, weights, dout, dtable, n, D, L, V);
  return static_cast<int>(cudaGetLastError());
}
