// Embedding bag: (B, L) ids into a (V, D) table -> (B, D) bag sums,
// optionally weighted per id, with no (B, L, D) intermediate.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_bag.py
// (embedding_bag).  YDNN's mean history bag is its weighted form with
// weights = mask / max(count, 1).
//
// One block per bag, threads along D, accumulating in f32 in the order
// of the bag.  The bag's ids and weights are staged once in shared
// memory; ids whose weight is exactly 0 (padded history) are skipped,
// which adds nothing (0 * row) and saves their row reads.
//
// Bound: bytes.  Each kept id reads one D-wide row (consecutive threads
// read consecutive floats, so the row read is coalesced) for 2*D flops;
// the design reads each needed row once and writes each output once.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBag = 1024;  // ids staged per pass through the bag

__global__ void embedding_bag_kernel(const float* __restrict__ table,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ weights,
                                     float* __restrict__ out, int D,
                                     int L) {
  __shared__ int s_ids[kMaxBag];
  __shared__ float s_w[kMaxBag];
  const int b = blockIdx.x;
  const int* bag = ids + static_cast<long long>(b) * L;
  const float* bw =
      weights ? weights + static_cast<long long>(b) * L : nullptr;
  // each thread keeps up to 4 output columns in registers
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int l0 = 0; l0 < L; l0 += kMaxBag) {
    const int n = min(kMaxBag, L - l0);
    __syncthreads();  // previous pass done with the staged ids
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_ids[i] = bag[l0 + i];
      s_w[i] = bw ? bw[l0 + i] : 1.f;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float w = s_w[i];
      if (w == 0.f) continue;  // uniform across the block
      const float* row = table + static_cast<long long>(s_ids[i]) * D;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = threadIdx.x + k * blockDim.x;
        if (d < D) acc[k] += w * row[d];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = threadIdx.x + k * blockDim.x;
    if (d < D) out[static_cast<long long>(b) * D + d] = acc[k];
  }
}

}  // namespace

// weights may be null (plain sums).  Requires D <= 4 * 256.
extern "C" int embedding_bag_launch(const float* table, const int* ids,
                                    const float* weights, float* out,
                                    int B, int D, int L, void* stream) {
  int threads = ((D + 3) / 4 + 31) / 32 * 32;  // >= D / 4, whole warps
  if (threads < 32) threads = 32;
  if (threads > 256) return static_cast<int>(cudaErrorInvalidValue);
  embedding_bag_kernel<<<B, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, ids, weights, out, D, L);
  return static_cast<int>(cudaGetLastError());
}
