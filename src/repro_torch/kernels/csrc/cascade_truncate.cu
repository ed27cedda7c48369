// CompactPlan truncation: revenue@expose per request.
//
// Replaces the Pallas kernel src/repro/kernels/cascade_truncate.py
// (compact_truncate_revenue), which computes engine._revenue_compact.
//
// Bound: bytes, and at the serving window's shape (B = 512 requests,
// rows of C = 200 slots) under 100 KB, a few hundredths of a
// microsecond at the card's memory rate; what sets the time is the
// number of dependent trips to memory, so the design makes two:
// - One warp a request, two a block: B = 512 requests fill 256 blocks
//   on all 132 SMs.
// - Trip 1: the request's group, row and n3.  Trip 2: the first
//   kHeld = 256 slots of its positions p and clicks, loaded into
//   registers unconditionally, before any scan.  Where C % 4 == 0 and
//   both tables are 16-byte aligned a lane loads 4 adjacent slots of
//   each as one 16-byte load (chunks of 128 slots); otherwise one slot
//   of each (chunks of 32).
// - The scan then runs on registers: a slot survives when p < n3; a
//   lane's inclusive survivor count q comes from a warp scan of its
//   per-lane counts (__shfl_up_sync; a ballot and popcount in the
//   one-slot form) plus the survivors of earlier chunks, and kept
//   clicks (survivors with q <= expose) are summed per lane and then
//   across the warp.  The scan stops at the chunk that reaches
//   `expose` survivors: later slots can never be exposed.
// - Rows wider than kHeld take one trip a further chunk, and only
//   until `expose` survivors were seen.
//
// Clicks are 0/1 on the serving path, so the f32 sums are exact and
// the result equals the reference bit for bit whatever the order.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 2;    // requests a block, one a warp
constexpr int kHeld = 256;   // slots a row holds in registers

// Slots s .. s + W - 1 of a row: positions (INT_MAX, never a survivor,
// past C) and clicks (0 past C).  C % W == 0, so the W are in or out
// together.
template <int W>
__device__ __forceinline__ void load_slots(const int* prow,
                                           const float* crow, int s, int C,
                                           int (&p)[W], float (&c)[W]) {
  if constexpr (W == 4) {
    int4 pv = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
    float4 cv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < C) {
      pv = __ldg(reinterpret_cast<const int4*>(prow + s));
      cv = __ldg(reinterpret_cast<const float4*>(crow + s));
    }
    p[0] = pv.x;
    p[1] = pv.y;
    p[2] = pv.z;
    p[3] = pv.w;
    c[0] = cv.x;
    c[1] = cv.y;
    c[2] = cv.z;
    c[3] = cv.w;
  } else {
    p[0] = s < C ? __ldg(prow + s) : INT_MAX;
    c[0] = s < C ? __ldg(crow + s) : 0.f;
  }
}

// One chunk of 32 W slots, lane l holding slots W l .. W l + W - 1:
// adds the lane's kept clicks to acc and returns carry plus the chunk's
// survivors (the same in every lane).
template <int W>
__device__ __forceinline__ int scan_chunk(const int (&p)[W],
                                          const float (&c)[W], int thr,
                                          int expose, int carry, int lane,
                                          float& acc) {
  bool m[W];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    m[k] = p[k] < thr;
    cnt += m[k];
  }
  int incl, total;
  if constexpr (W == 1) {
    const unsigned bal = __ballot_sync(0xffffffffu, m[0]);
    incl = __popc(bal & (0xffffffffu >> (31 - lane)));  // lanes <= lane
    total = __popc(bal);
  } else {
    incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    total = __shfl_sync(0xffffffffu, incl, 31);
  }
  int q = carry + incl - cnt;  // survivors before the lane's first slot
#pragma unroll
  for (int k = 0; k < W; ++k) {
    q += m[k];
    if (m[k] && q <= expose) acc += c[k];
  }
  return carry + total;
}

template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    cascade_truncate_kernel(const int* __restrict__ p,
                            const float* __restrict__ ck,
                            const int* __restrict__ groups,
                            const int* __restrict__ rows,
                            const int* __restrict__ n3,
                            float* __restrict__ out, int U, int C, int B,
                            int expose) {
  constexpr int kChunk = 32 * W;
  constexpr int kHeldChunks = kHeld / kChunk;
  const int b = blockIdx.x * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long row =
      (static_cast<long long>(__ldg(groups + b)) * U + __ldg(rows + b)) * C;
  const int thr = __ldg(n3 + b);
  const int* prow = p + row;
  const float* crow = ck + row;
  int ph[kHeldChunks][W];
  float ch[kHeldChunks][W];
#pragma unroll
  for (int i = 0; i < kHeldChunks; ++i)
    load_slots<W>(prow, crow, i * kChunk + lane * W, C, ph[i], ch[i]);
  int carry = 0;
  float acc = 0.f;
  bool done = expose == 0;
#pragma unroll
  for (int i = 0; i < kHeldChunks; ++i) {
    if (done || i * kChunk >= C) break;  // uniform across the warp
    carry = scan_chunk<W>(ph[i], ch[i], thr, expose, carry, lane, acc);
    done = carry >= expose;
  }
  for (int c0 = kHeld; !done && c0 < C; c0 += kChunk) {
    int pw[W];
    float cw[W];
    load_slots<W>(prow, crow, c0 + lane * W, C, pw, cw);
    carry = scan_chunk<W>(pw, cw, thr, expose, carry, lane, acc);
    done = carry >= expose;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[b] = acc;
}

}  // namespace

// p, ck (G, U, C) contiguous; groups, rows, n3, out (B,).
extern "C" int cascade_truncate_launch(const int* p, const float* ck,
                                       const int* groups, const int* rows,
                                       const int* n3, float* out, int U,
                                       int C, int B, int expose,
                                       void* stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(p) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(ck) % 16 == 0;
  if (vec)
    cascade_truncate_kernel<4><<<blocks, kWarps * 32, 0, s>>>(
        p, ck, groups, rows, n3, out, U, C, B, expose);
  else
    cascade_truncate_kernel<1><<<blocks, kWarps * 32, 0, s>>>(
        p, ck, groups, rows, n3, out, U, C, B, expose);
  return static_cast<int>(cudaGetLastError());
}
