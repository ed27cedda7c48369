// CompactPlan truncation: revenue@expose per request.
//
// Replaces the Pallas kernel src/repro/kernels/cascade_truncate.py
// (compact_truncate_revenue), which computes engine._revenue_compact.
//
// One warp per request.  The warp gathers the request's row
// (groups[b], rows[b]) of the (G, U, C) tables 32 slots at a time; a
// ballot + popcount gives every lane the inclusive survivor count q of
// its slot (the prefix sum the TPU kernel ran as a triangular matmul on
// the MXU), and kept clicks (p < n3 and q <= expose) are summed per lane
// and reduced with shuffles.  The walk stops as soon as `expose`
// survivors were seen: later slots can never be exposed.
//
// Bound: bytes.  Per request it reads at most one C-wide int row and one
// float row (fewer with the early stop) and does a handful of integer
// ops per slot, far below the card's compute rate; the design reads each
// row once, coalesced, with no padding of C to the TPU's 128 lanes.
//
// Clicks are 0/1 on the serving path, so the float sum is exact and the
// result equals the reference bit for bit whatever the summation order.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void cascade_truncate_kernel(const int* __restrict__ p,
                                        const float* __restrict__ ck,
                                        const int* __restrict__ groups,
                                        const int* __restrict__ rows,
                                        const int* __restrict__ n3,
                                        float* __restrict__ out, int U,
                                        int C, int B, int expose) {
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= B) return;  // whole warps exit together
  const long long row =
      (static_cast<long long>(groups[warp]) * U + rows[warp]) * C;
  const int* prow = p + row;
  const float* crow = ck + row;
  const int thr = n3[warp];
  const unsigned upto_me = 0xffffffffu >> (31 - lane);  // lanes <= lane
  int carry = 0;
  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const bool m = (c < C) && (prow[c] < thr);
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    const int q = carry + __popc(bal & upto_me);  // inclusive count
    if (m && q <= expose) acc += crow[c];
    carry += __popc(bal);
    if (carry >= expose) break;  // uniform: carry is warp-wide
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[warp] = acc;
}

}  // namespace

extern "C" int cascade_truncate_launch(const int* p, const float* ck,
                                       const int* groups, const int* rows,
                                       const int* n3, float* out, int U,
                                       int C, int B, int expose,
                                       void* stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cascade_truncate_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, ck, groups, rows, n3, out, U, C, B, expose);
  return static_cast<int>(cudaGetLastError());
}
