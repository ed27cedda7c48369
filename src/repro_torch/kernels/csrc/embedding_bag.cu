// Embedding bag: (B, L) ids into a (V, D) table -> (B, D) bag sums,
// optionally weighted per id, with no (B, L, D) intermediate.
//
// Replaces the Pallas kernel src/repro/kernels/embedding_bag.py
// (embedding_bag).  YDNN's mean history bag is its weighted form with
// weights = mask / max(count, 1).
//
// Bound: bytes, one D-wide row read for each id of nonzero weight.  At
// the serving window's shape (B = 512 bags of L = 100 ids into a
// 4000 x 32 table, about half the history padded) that is 3.3 MB, about
// a microsecond at the card's memory rate, so what sets the time is
// how many dependent trips to memory each bag makes in sequence, and
// the design is cut to make few of them:
// - One warp a bag, four bags a block: B = 512 bags fill 128 blocks,
//   one on almost every SM.
// - A row is read in units of 4 floats (a 16-byte load through the
//   read-only path), R lanes to a row and 32 / R rows to one warp
//   instruction, R the smallest power of two that covers the row's
//   units (at most 32): at D = 32 eight lanes read a row and one
//   instruction reads four.  Each lane issues up to kInFlight loads
//   before its first add, so a warp has 32 rows of D = 32 in flight.
// - The bag's ids and weights are read 32 at a time, one a lane,
//   coalesced, and handed to the lanes that load their rows by
//   __shfl_sync; the next 32 are fetched before the current rows are
//   summed.  No shared memory, no block barrier.
// - An id whose weight is exactly 0 (padded history) predicates its
//   load off and adds nothing; 32 such ids in a row skip their chunk.
// So a bag of L ids costs about ceil(L / 32) row trips and one id trip.
//
// Rows wider than 32 units are summed in passes of 32 units, each
// walking the bag again (its ids come from the caches).  A table whose
// base or row stride is not a multiple of 16 bytes, or with D < 4, is
// read a float at a time; D % 4 != 0 on an aligned table (a padded
// view) takes its last columns a float at a time.
//
// Order: with P = 32 / R row slots, slot s sums the ids 32c + tP + s
// (chunk c, step t < R) in that order as fmaf(w, row, acc); the slots'
// partials are then added by a __shfl_xor_sync tree.  The order is
// fixed, so two calls on the same inputs are bitwise equal; it is not
// the plain version's in-bag order (the gate is 1e-5).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;     // bags a block, one a warp
constexpr int kInFlight = 8;  // row loads a lane issues before it adds

// One unit of VW adjacent floats at p, or zeros when the load is off.
template <int VW>
__device__ __forceinline__ void load_unit(const float* p, bool on,
                                          float (&v)[VW]) {
  if constexpr (VW == 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = on ? __ldg(p) : 0.f;
  }
}

// The bag's sums of columns [c0, c0 + VW * n_units), written to
// out_row.  Unit u (VW columns from c0 + VW * u) is lane u % R's of
// every row slot; the warp walks the bag once per R units.
template <int VW, int R>
__device__ void bag_pass(const float* __restrict__ table, long long ld,
                         const int* __restrict__ bag,
                         const float* __restrict__ bw,
                         float* __restrict__ out_row, int L, int c0,
                         int n_units, int lane) {
  constexpr int P = 32 / R;  // rows one warp instruction reads
  constexpr int G = R < kInFlight ? R : kInFlight;
  const int slot = lane / R;
  for (int u0 = 0; u0 < n_units; u0 += R) {
    const int u = u0 + lane % R;
    const bool col_on = u < n_units;
    const float* col = table + c0 + static_cast<long long>(u) * VW;
    float acc[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) acc[k] = 0.f;
    int nid = 0;
    float nw = 0.f;
    if (lane < L) {
      nid = __ldg(bag + lane);
      nw = bw ? __ldg(bw + lane) : 1.f;
    }
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int cid = nid;
      const float cw = nw;
      nid = 0;
      nw = 0.f;
      if (l0 + 32 + lane < L) {  // the next chunk's ids, ahead of its rows
        nid = __ldg(bag + l0 + 32 + lane);
        nw = bw ? __ldg(bw + l0 + 32 + lane) : 1.f;
      }
      if (__ballot_sync(0xffffffffu, cw != 0.f) == 0u) continue;
#pragma unroll 1
      for (int s0 = 0; s0 < R; s0 += G) {
        float v[G][VW];
        float w[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int src = (s0 + g) * P + slot;
          const int id = __shfl_sync(0xffffffffu, cid, src);
          w[g] = __shfl_sync(0xffffffffu, cw, src);
          load_unit<VW>(col + static_cast<long long>(id) * ld,
                        col_on && w[g] != 0.f, v[g]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k = 0; k < VW; ++k) acc[k] = fmaf(w[g], v[g][k], acc[k]);
      }
    }
#pragma unroll
    for (int off = R; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < VW; ++k)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    if (slot == 0 && col_on)
#pragma unroll
      for (int k = 0; k < VW; ++k) out_row[c0 + u * VW + k] = acc[k];
  }
}

template <int VW, int R>
__global__ void __launch_bounds__(kWarps * 32)
    embedding_bag_kernel(const float* __restrict__ table, long long ld,
                         const int* __restrict__ ids,
                         const float* __restrict__ weights,
                         float* __restrict__ out, int B, int D, int L) {
  const int b = blockIdx.x * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int* bag = ids + static_cast<long long>(b) * L;
  const float* bw = weights ? weights + static_cast<long long>(b) * L
                            : nullptr;
  float* out_row = out + static_cast<long long>(b) * D;
  const int units = D / VW;
  bag_pass<VW, R>(table, ld, bag, bw, out_row, L, 0, units, lane);
  if constexpr (VW > 1) {
    if (units * VW < D)  // the last D % 4 columns, a float at a time
      bag_pass<1, R>(table, ld, bag, bw, out_row, L, units * VW,
                     D - units * VW, lane);
  }
}

template <int VW>
cudaError_t launch(int r, const float* table, long long ld, const int* ids,
                   const float* weights, float* out, int B, int D, int L,
                   cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  const int threads = kWarps * 32;
#define REPRO_BAG_CASE(RR)                                                 \
  case RR:                                                                 \
    embedding_bag_kernel<VW, RR><<<blocks, threads, 0, stream>>>(          \
        table, ld, ids, weights, out, B, D, L);                            \
    break;
  switch (r) {
    REPRO_BAG_CASE(1)
    REPRO_BAG_CASE(2)
    REPRO_BAG_CASE(4)
    REPRO_BAG_CASE(8)
    REPRO_BAG_CASE(16)
    REPRO_BAG_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BAG_CASE
  return cudaGetLastError();
}

}  // namespace

// table (V, D) with row stride ld (floats; columns contiguous), ids and
// weights (B, L) contiguous; weights may be null (plain sums).  Any D
// and L.
extern "C" int embedding_bag_launch(const float* table, long long ld,
                                    const int* ids, const float* weights,
                                    float* out, int B, int D, int L,
                                    void* stream) {
  const bool vec = reinterpret_cast<std::uintptr_t>(table) % 16 == 0 &&
                   ld % 4 == 0 && D >= 4;
  const int units = vec ? D / 4 : D;
  int r = 1;  // lanes to a row
  while (r < units && r < 32) r <<= 1;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch<4>(r, table, ld, ids, weights, out, B, D, L, s)
          : launch<1>(r, table, ld, ids, weights, out, B, D, L, s);
  return static_cast<int>(err);
}
