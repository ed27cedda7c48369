// DLRM dot interaction: feats (B, F, D) -> (B, F(F-1)/2), the strictly
// lower triangle of each sample's Gram matrix, in the order of
// np.tril_indices(F, k=-1), summed in f32 and written in the input's
// dtype (f32 or bf16).  The (F, F) Gram matrix is never stored.
//
// Replaces the Pallas kernel src/repro/kernels/dot_interact.py
// (dot_interact), which computes the Gram matrix of a batch tile on the
// MXU and gathers its lower triangle in VMEM.
//
// Bound: bytes.  At DLRM-RM2's widths (F = 27, D = 64, bf16) a sample
// reads 3,456 bytes and writes 702 for 44,928 flops, 11 flops a byte,
// far below the ~295 bf16 flops a byte at which the card turns from
// bytes to operations.  So the design keeps the loads streaming and the
// math off their path.
//
// Design (sm_90a, blocks of 4 warps, up to 4 blocks an SM):
// - Every warp is a pipeline of its own: a persistent grid hands the
//   warps samples in turn, and each warp copies its next samples into a
//   ring of its own in shared memory (three slots at RM2's widths) with
//   cp.async (16 bytes a lane, zero-filled past D), so the copy of the
//   next samples overlaps the math on this one.  The ring has as many
//   slots (up to three) as leave room for 12 warps an SM: three in bf16
//   at RM2's widths (16 warps an SM), two in f32 (12).  No step waits for
//   another warp: the ring and the output need only __syncwarp.  Rows
//   are padded to a whole number of 32-byte k steps plus 16 bytes, which
//   puts the 8 rows an ldmatrix phase reads in 8 distinct bank groups.
//   Shapes whose rows are not 16-byte multiples (D = 63 in bf16) are
//   staged by plain loads instead, with the same layout.
// - The Gram products run on the tensor cores.  A 16-row strip of a
//   sample, loaded by one ldmatrix.x4 per 32-byte k step, is at once the
//   A fragment of its m16 tile and the B fragments of two n8 tiles (the
//   Gram matrix is X X^T, so A and B are the same rows).  bf16 runs
//   mma.sync m16n8k16 (bf16 products are exact in the f32 sum); f32 runs
//   m16n8k8 in 3xTF32: each fragment is split into hi = tf32(x) and
//   lo = tf32(x - hi), rounded as cvt.rna rounds, and a_lo b_hi +
//   a_hi b_lo + a_hi b_hi summed.  F is padded to strips of 16; only tiles that hold
//   lower-triangle entries are computed, as jobs of one strip against a
//   block of four n8 tiles (at F = 27, two jobs a sample).
// - Every 8 k steps a tile's tensor-core chain is added into an f32 sum
//   on the CUDA cores: the tensor cores add with less than f32's
//   precision, so long chains drift.
// - A sample's outputs go to the warp's shared memory in output order
//   and leave as 16-byte stores (a RM2 bf16 sample's 702 bytes are 43 of
//   them and the two part-words at its ends).  Where a sample's output
//   does not fit beside its rows, the values go straight to device
//   memory.
//
// Limits: B, F > 1; one sample's padded rows must fit a block's shared
// memory: F rows of D values' bytes rounded up to 32, plus 16, at most
// 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kThreads = 32 * kMaxWarps;
constexpr int kMaxStages = 3;
constexpr int kPromote = 8;              // k steps per tensor-core chain
constexpr int kWarpRoom = 18 * 1024;     // a warp's share at 12 warps an SM
constexpr int kSmemMax = 227 * 1024;     // the most a block may have

struct Plan {
  int B, F, D, P;
  int strips;        // 16-row strips of a sample
  int n_steps;       // 32-byte k steps of a row
  int row_stride;    // bytes of a staged row: 32 n_steps + 16
  int sample_bytes;  // F * row_stride
  int stages;        // ring slots a warp
  int warp_bytes;    // a warp's ring and output staging
  int staged_out;    // outputs leave through shared memory
  int vec;           // rows are 16-byte multiples on a 16-byte base
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's copy groups are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// cvt.rna.tf32.f32 by integer ops (two instructions; the cvt itself adds
// a guard for NaN, which only NaNs with a payload in the low 13 bits
// need): add half of the 13 dropped bits' range to the magnitude, then
// clear them.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + (what neither keeps): hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_rna(x[e]);
    lo[e] = tf32_rna(
        __float_as_uint(__uint_as_float(x[e]) - __uint_as_float(hi[e])));
  }
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) b (8 x 8, tf32, col).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A job: rows of strip mi against the columns of n8 tiles 4 nb .. 4 nb + 3
// (the rows of strips 2 nb and 2 nb + 1); tiles past strip mi hold no
// lower-triangle entry and are skipped.
struct Job {
  int mi, nb;
};

// One strip's ldmatrix.x4 at k step ks: r0 = rows 0-7, bytes 0-15 of the
// step; r1 = rows 8-15, bytes 0-15; r2, r3 the same at bytes 16-31.  As
// A (m16 x k) that is a0..a3 in both mma shapes; as B, n8 tile 2 q is
// (r0, r2) and tile 2 q + 1 is (r1, r3).
__device__ __forceinline__ uint32_t strip_addr(uint32_t sample, int strip,
                                               int F, int row_stride,
                                               int lane) {
  const int r = min(16 * strip + (lane & 15), F - 1);  // rows past F: any
  return sample + r * row_stride + (lane >> 4) * 16;
}

template <bool kBf16>
__device__ __forceinline__ void mma_tile(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&a_lo)[4],
                                         const uint32_t (&b)[4],
                                         const uint32_t (&b_lo)[4], int odd) {
  const uint32_t b0 = odd ? b[1] : b[0], b1 = odd ? b[3] : b[2];
  if constexpr (kBf16) {
    mma_bf16(c, a, b0, b1);
  } else {
    mma_tf32(c, a_lo, b0, b1);
    mma_tf32(c, a, odd ? b_lo[1] : b_lo[0], odd ? b_lo[3] : b_lo[2]);
    mma_tf32(c, a, b0, b1);
  }
}

// acc += the job's products over the sample's n_steps k steps.
template <bool kBf16>
__device__ __forceinline__ void job_steps(float (&acc)[4][4], const Job& j,
                                          uint32_t sample, int F,
                                          int row_stride, int n_steps,
                                          int lane) {
  const uint32_t a_addr = strip_addr(sample, j.mi, F, row_stride, lane);
  const uint32_t b0_addr = strip_addr(sample, 2 * j.nb, F, row_stride, lane);
  const uint32_t b1_addr =
      strip_addr(sample, min(2 * j.nb + 1, j.mi), F, row_stride, lane);
  const bool b0_is_a = 2 * j.nb == j.mi;
  const bool two = 2 * j.nb + 1 <= j.mi;
  const bool b1_is_a = 2 * j.nb + 1 == j.mi;
  float ch[4][4];
  for (int ks0 = 0; ks0 < n_steps; ks0 += kPromote) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) ch[t][e] = 0.f;
    const int ks1 = min(n_steps, ks0 + kPromote);
    for (int ks = ks0; ks < ks1; ++ks) {
      uint32_t a[4], b0[4], b1[4];
      uint32_t a_lo[4], b0_lo[4], b1_lo[4];
      ldsm_x4(a, a_addr + 32 * ks);
      if (!b0_is_a) ldsm_x4(b0, b0_addr + 32 * ks);
      if (two && !b1_is_a) ldsm_x4(b1, b1_addr + 32 * ks);
      if constexpr (!kBf16) {
        uint32_t hi[4];
        split4(a, hi, a_lo);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = hi[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (b0_is_a) b0[e] = a[e];
        if (b1_is_a) b1[e] = a[e];
        if constexpr (!kBf16) {
          if (b0_is_a) b0_lo[e] = a_lo[e];
          if (b1_is_a) b1_lo[e] = a_lo[e];
        }
      }
      if constexpr (!kBf16) {
        uint32_t hi[4];
        if (!b0_is_a) {
          split4(b0, hi, b0_lo);
#pragma unroll
          for (int e = 0; e < 4; ++e) b0[e] = hi[e];
        }
        if (two && !b1_is_a) {
          split4(b1, hi, b1_lo);
#pragma unroll
          for (int e = 0; e < 4; ++e) b1[e] = hi[e];
        }
      }
      mma_tile<kBf16>(ch[0], a, a_lo, b0, b0_lo, 0);
      mma_tile<kBf16>(ch[1], a, a_lo, b0, b0_lo, 1);
      if (two) {
        mma_tile<kBf16>(ch[2], a, a_lo, b1, b1_lo, 0);
        mma_tile<kBf16>(ch[3], a, a_lo, b1, b1_lo, 1);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] += ch[t][e];
  }
}

template <bool kBf16>
__device__ __forceinline__ void put(void* dst, long long i, float v) {
  if constexpr (kBf16)
    static_cast<__nv_bfloat16*>(dst)[i] = __float2bfloat16(v);  // nearest even
  else
    static_cast<float*>(dst)[i] = v;
}

// The job's lower-triangle values into dst, the sample's output p = 0:
// accumulator c of tile t holds (row 16 mi + g + 8 (c / 2), column
// 8 (4 nb + t) + 2 q + c % 2), g = lane / 4, q = lane % 4.
template <bool kBf16>
__device__ __forceinline__ void job_store(const float (&acc)[4][4],
                                          const Job& j, int F, void* dst,
                                          int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int nj = 4 * j.nb + t;
    if (nj > 2 * j.mi + 1) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 16 * j.mi + g + 8 * (c >> 1);
      const int col = 8 * nj + 2 * q + (c & 1);
      if (i < F && col < i)
        put<kBf16>(dst, i * (i - 1) / 2 + col, acc[t][c]);
    }
  }
}

// Stage sample s's F rows into one ring slot (the warp's lanes).
template <bool kBf16>
__device__ __forceinline__ void stage_sample(unsigned char* slot,
                                             const void* feats,
                                             const Plan& p, long long s,
                                             int lane) {
  constexpr int es = kBf16 ? 2 : 4;
  const int row_bytes = p.D * es;
  const unsigned char* src = static_cast<const unsigned char*>(feats) +
                             s * p.F * static_cast<long long>(row_bytes);
  if (p.vec) {
    const int per_row = 2 * p.n_steps;  // 16-byte chunks, zero past D
    const uint32_t base = smem_addr(slot);
    for (int idx = lane; idx < p.F * per_row; idx += 32) {
      const int r = idx / per_row, c = 16 * (idx - r * per_row);
      const bool valid = c < row_bytes;
      cp_async16(base + r * p.row_stride + c,
                 src + r * row_bytes + (valid ? c : 0), valid);
    }
  } else {
    const int per_row = 32 * p.n_steps / es;
    for (int idx = lane; idx < p.F * per_row; idx += 32) {
      const int r = idx / per_row, k = idx - r * per_row;
      unsigned char* to = slot + r * p.row_stride + k * es;
      const long long at = static_cast<long long>(r) * p.D + k;
      if constexpr (kBf16)
        *reinterpret_cast<uint16_t*>(to) =
            k < p.D ? reinterpret_cast<const uint16_t*>(src)[at] : 0;
      else
        *reinterpret_cast<uint32_t*>(to) =
            k < p.D ? reinterpret_cast<const uint32_t*>(src)[at] : 0u;
    }
  }
}

// A sample's P staged outputs (placed shift elements past a 16-byte
// boundary, the shift of their place in out) to out at element d0, 16
// bytes a store where a whole 16-byte word is theirs.
template <bool kBf16>
__device__ __forceinline__ void copy_out(void* out, const unsigned char* out_s,
                                         long long d0, int count, int shift,
                                         int lane) {
  constexpr int es = kBf16 ? 2 : 4;
  unsigned char* dst = static_cast<unsigned char*>(out) + (d0 - shift) * es;
  const int lo = shift * es, hi = (shift + count) * es;
  for (int b0 = 16 * lane; b0 < hi; b0 += 16 * 32) {
    if (b0 >= lo && b0 + 16 <= hi) {
      *reinterpret_cast<uint4*>(dst + b0) =
          *reinterpret_cast<const uint4*>(out_s + b0);
    } else {
      for (int b = max(b0, lo); b < min(b0 + 16, hi); b += es) {
        if constexpr (kBf16)
          *reinterpret_cast<uint16_t*>(dst + b) =
              *reinterpret_cast<const uint16_t*>(out_s + b);
        else
          *reinterpret_cast<uint32_t*>(dst + b) =
              *reinterpret_cast<const uint32_t*>(out_s + b);
      }
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 4)
    dot_interact_kernel(const void* __restrict__ feats, void* __restrict__ out,
                        const Plan p) {
  constexpr int es = kBf16 ? 2 : 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  unsigned char* ring = smem + warp * p.warp_bytes;
  unsigned char* out_s = ring + p.stages * p.sample_bytes;
  // this warp's samples: first, first + step, ...
  const long long first = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long step = static_cast<long long>(gridDim.x) * warps;
  const int n = first < p.B ? static_cast<int>((p.B - 1 - first) / step) + 1
                            : 0;
  auto fetch = [&](int k) {
    if (k < n)
      stage_sample<kBf16>(ring + (k % p.stages) * p.sample_bytes, feats, p,
                          first + k * step, lane);
    cp_async_commit();
  };

  for (int k = 0; k < p.stages - 1; ++k) fetch(k);
  for (int k = 0; k < n; ++k) {
    __syncwarp();  // slot (k - 1) % stages and the staging are free
    fetch(k + p.stages - 1);
    cp_async_wait(p.stages - 1);
    __syncwarp();  // sample k's rows are in shared memory

    const long long s = first + k * step;
    const uint32_t sample = smem_addr(ring + (k % p.stages) * p.sample_bytes);
    const int shift = static_cast<int>((s * p.P) % (16 / es));
    void* dst = p.staged_out
        ? static_cast<void*>(out_s + shift * es)
        : static_cast<void*>(static_cast<unsigned char*>(out) + s * p.P * es);
    for (int mi = 0; mi < p.strips; ++mi)
      for (int nb = 0; 2 * nb <= mi; ++nb) {
        const Job j{mi, nb};
        float acc[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
        job_steps<kBf16>(acc, j, sample, p.F, p.row_stride, p.n_steps, lane);
        job_store<kBf16>(acc, j, p.F, dst, lane);
      }
    if (p.staged_out) {
      __syncwarp();
      copy_out<kBf16>(out, out_s, s * p.P, p.P, shift, lane);
    }
  }
  cp_async_wait(0);
}

// A plan for these shapes, or false when a sample's rows do not fit.
bool make_plan(Plan& p, int& warps, const void* feats, const void* out,
               int B, int F, int D, int es, int n_sm) {
  p.B = B;
  p.F = F;
  p.D = D;
  p.P = F * (F - 1) / 2;
  p.strips = (F + 15) / 16;
  const long long row_bytes = static_cast<long long>(D) * es;
  p.n_steps = static_cast<int>((row_bytes + 31) / 32);
  p.row_stride = 32 * p.n_steps + 16;
  const long long sample = static_cast<long long>(F) * p.row_stride;
  if (sample > kSmemMax) return false;
  p.sample_bytes = static_cast<int>(sample);
  p.vec = reinterpret_cast<uintptr_t>(feats) % 16 == 0 && row_bytes % 16 == 0;
  const bool out_aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long out_bytes =
      ((static_cast<long long>(p.P) + 16 / es) * es + 15) / 16 * 16;
  // the most ring slots that leave room for 12 warps an SM, else the
  // most that fit at all; warps enough that a small batch still reaches
  // every SM
  const long long spread = (static_cast<long long>(B) + n_sm - 1) / n_sm;
  for (const int room : {kWarpRoom, kSmemMax})
    for (int stages = kMaxStages; stages >= 1; --stages)
      for (int staged = out_aligned; staged >= 0; --staged) {
        const long long per_warp =
            stages * sample + (staged ? out_bytes : 0);
        if (per_warp > room) continue;
        int w = kMaxWarps;
        while (w > 1 && (w > spread || w * per_warp > kSmemMax)) w /= 2;
        warps = w;
        p.stages = stages;
        p.warp_bytes = static_cast<int>(per_warp);
        p.staged_out = staged;
        return true;
      }
  return false;
}

template <bool kBf16>
int launch(const void* feats, void* out, int B, int F, int D,
           cudaStream_t stream) {
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  Plan p;
  int warps = 0;
  if (!make_plan(p, warps, feats, out, B, F, D, kBf16 ? 2 : 4, n_sm))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * warps, smem = warps * p.warp_bytes;
  e = cudaFuncSetAttribute(dot_interact_kernel<kBf16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dot_interact_kernel<kBf16>, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (static_cast<long long>(B) + warps - 1) / warps;
  const long long grid =
      std::min(blocks, static_cast<long long>(n_sm) * std::max(per_sm, 1));
  dot_interact_kernel<kBf16><<<static_cast<unsigned>(grid), threads, smem,
                               stream>>>(feats, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats and out are f32 (bf16 == 0) or raw bf16 bits (bf16 != 0); out is
// (B, F(F-1)/2) in the same type.  Requires B > 0 and F > 1.
extern "C" int dot_interact_launch(const void* feats, void* out, int B,
                                   int F, int D, int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(feats, out, B, F, D, s)
              : launch<false>(feats, out, B, F, D, s);
}
