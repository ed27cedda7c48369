// DLRM dot interaction: the backward pass.  dout (B, F(F-1)/2), the
// gradient of the strictly-lower-triangle dots in the order of
// np.tril_indices(F, k=-1), and feats (B, F, D) -> dfeats (B, F, D):
//
//   dfeats[b] = S X[b],  S = G + G^T,  G[i][j] = dout[b, i(i-1)/2 + j], i > j,
//
// summed in f32 and written in the input's dtype (f32 or bf16).
//
// Stands for jax.grad of the DLRM interaction oracle
// (src/repro/models/recsys/dlrm.py:99, dot_interact), which the JAX
// package differentiates as a plain einsum and gather; the Pallas kernel
// src/repro/kernels/dot_interact.py has no backward.
//
// Bound: bytes.  A sample reads F D inputs and F(F-1)/2 gradients and
// writes F D values for 2 F^2 D flops: at DLRM-RM2's widths (F = 27,
// D = 64, bf16) 7.6 kB moved for 93 kflops, 12 flops a byte, far below
// the ~295 at which the card turns from bytes to operations.  So the
// design keeps the loads streaming and the math off their path, as the
// forward (dot_interact.cu) does.
//
// Design (sm_90a, blocks of up to 4 warps):
// - Every warp is a pipeline of its own: a persistent grid hands the
//   warps samples in turn, and each warp copies its next samples' rows
//   of X and their packed gradients into a ring of its own in shared
//   memory with cp.async (16 bytes a lane), so the copy of the next
//   samples overlaps the math on this one.  The ring has two or three
//   slots at the most warps an SM that leave room for two (16, 12 or 8):
//   at RM2's widths two slots at 16 warps in bf16, two at 8 in f32 (more
//   warps beat a deeper ring: each sample's math is a chain of
//   shared-memory round trips that other warps hide).  Only __syncwarp
//   is needed.  X's rows are padded to a whole number of 32-byte steps
//   plus 16 bytes, which puts the 8 rows an ldmatrix phase reads in 8
//   distinct bank groups; rows that are not 16-byte multiples (D = 63 in
//   bf16), or a base that is not 16-byte aligned, are staged by plain
//   loads into the same layout.  A sample's gradients are
//   copied as the 16-byte words that hold them (any base: the words
//   start at the aligned address at or below the sample's first value).
// - bf16: S is formed in shared memory in bf16, padded to 16-row strips
//   (32 x 32 at RM2's widths).  Each entry is one gradient or 0, so S is
//   exact.  Lane l writes packed gradients l, l + 32, ... at (i, j) and
//   (j, i), walking (i, j) along the rows by adds, no divide; the
//   diagonal and the padding are zeroed once, when the kernel starts,
//   and never written again.  The product runs on the tensor
//   cores as mma.sync m16n8k16: S's strips by ldmatrix as the A operand,
//   X's rows by ldmatrix.trans as the B operand (two n8 tiles a 32-byte
//   column step), f32 accumulators; at F = 27, D = 64, 2 strips x 8 n8
//   tiles x 2 k16 steps, 32 MMAs a sample.  bf16 products are exact in
//   the f32 sum; every 8 k steps the tensor-core chain is added into an
//   f32 sum on the CUDA cores, so chains stay short at any F.
// - f32: SIMT fmaf chains.  The bound is bytes (0.30 ms at RM2's
//   train_batch) and the 6.1 GFLOP of products take about 0.09 ms at the
//   CUDA cores' 67 TFLOP/s, so 3xTF32's splits would buy nothing; each
//   output is one fmaf chain over j = 0 .. F - 1 in order.  A block of
//   32 rows of S is laid out column-major (row j of S's block = column j
//   of S, built from the staged gradients), each lane owns two adjacent
//   columns of the output, and a step of j is one float2 of X, eight
//   broadcast float4 of S and 64 fmaf.
// - Outputs: where F <= 32 (one pass of rows) a sample's outputs are
//   written over its X rows in the ring slot, once the columns they
//   replace have been read, and leave as 16-byte stores (a RM2 bf16
//   sample's 3,456 bytes are 216 of them); where rows are not 16-byte
//   multiples, as single values.  Where F > 32 they go straight to
//   device memory.
// - Every sum runs in a fixed order and no atomics are used, so each
//   call is bitwise repeatable.
//
// Limits: B, F, D > 0; one ring slot and S must fit a block's shared
// memory, 227 KB: F rows of D values' bytes rounded up to 32, plus 16,
// plus the sample's F(F-1)/2 gradients rounded up to 16 bytes, plus 16,
// plus S: in bf16 (16 s) x (32 s + 16) bytes for s = ceil(F / 16), in f32
// 128 F bytes.  Shapes past that are refused (cudaErrorInvalidValue).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kThreads = 32 * kMaxWarps;
constexpr int kMaxStages = 3;
constexpr int kPromote = 8;              // k steps per tensor-core chain
constexpr int kPassRows = 32;            // output rows a pass: 2 strips / f32
// a warp's share of an SM's shared memory at 16, 12 and 8 warps an SM
constexpr int kWarpRoom[] = {14 * 1024, 18 * 1024, 28 * 1024};
constexpr int kSmemMax = 227 * 1024;     // the most a block may have

struct Plan {
  int B, F, D, P;
  int strips;        // 16-row strips of S (bf16)
  int n_steps;       // 32-byte steps of a staged row
  int row_stride;    // bytes of a staged row: 32 n_steps + 16
  int x_bytes;       // F * row_stride
  int slot_bytes;    // x_bytes and the gradients' 16-byte words
  int s_stride;      // bytes of a row of S (bf16: 32 strips + 16; f32: 128)
  int s_bytes;       // S, at the head of the warp's share
  int stages;        // ring slots a warp
  int warp_bytes;    // s_bytes + stages * slot_bytes
  int staged;        // F <= kPassRows: outputs over X in the slot
  int vec;           // X rows by cp.async: 16-byte rows on a 16-byte base
  int vec_out;       // staged outputs leave as 16-byte stores
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
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Item lane, lane + 32, ... of rows of per_row items (16-byte chunks or
// values), as (row r, item c), stepped without a divide.
struct Chunk {
  int r, c, dr, dc;
  __device__ __forceinline__ Chunk(int lane, int per_row)
      : r(lane / per_row), c(lane % per_row), dr(32 / per_row),
        dc(32 % per_row) {}
  __device__ __forceinline__ void next(int per_row) {
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
};

// The first byte of sample s's gradients in device memory.
__device__ __forceinline__ uintptr_t dout_at(const void* dout, const Plan& p,
                                             long long s, int es) {
  return reinterpret_cast<uintptr_t>(dout) +
         static_cast<uintptr_t>(s * p.P * es);
}

// Stage sample s's F rows of X and its gradients' 16-byte words into one
// ring slot (the warp's lanes).
template <int es>
__device__ __forceinline__ void stage_sample(unsigned char* slot,
                                             const void* dout,
                                             const void* feats, const Plan& p,
                                             long long s, int lane) {
  const int row_bytes = p.D * es;
  const unsigned char* src = static_cast<const unsigned char*>(feats) +
                             s * p.F * static_cast<long long>(row_bytes);
  const uint32_t base = smem_addr(slot);
  if (p.vec) {
    const int per_row = 2 * p.n_steps;  // 16-byte chunks, zero past D
    for (Chunk k(lane, per_row); k.r < p.F; k.next(per_row)) {
      const int c = 16 * k.c;
      const bool valid = c < row_bytes;
      cp_async16(base + k.r * p.row_stride + c,
                 src + k.r * row_bytes + (valid ? c : 0), valid);
    }
  } else {
    const int per_row = 32 * p.n_steps / es;  // values, zero past D
    for (Chunk c(lane, per_row); c.r < p.F; c.next(per_row)) {
      const int r = c.r, k = c.c;
      unsigned char* to = slot + r * p.row_stride + k * es;
      const long long at = static_cast<long long>(r) * p.D + k;
      if constexpr (es == 2)
        *reinterpret_cast<uint16_t*>(to) =
            k < p.D ? reinterpret_cast<const uint16_t*>(src)[at] : 0;
      else
        *reinterpret_cast<uint32_t*>(to) =
            k < p.D ? reinterpret_cast<const uint32_t*>(src)[at] : 0u;
    }
  }
  if (p.P > 0) {
    const uintptr_t a = dout_at(dout, p, s, es), a0 = a & ~uintptr_t{15};
    const int words = static_cast<int>((a - a0 + p.P * es + 15) / 16);
    for (int c = lane; c < words; c += 32)
      cp_async16(base + p.x_bytes + 16 * c,
                 reinterpret_cast<const void*>(a0 + 16 * c), true);
  }
}

// (i, j) of packed gradient e: e = i(i-1)/2 + j, 0 <= j < i.
struct Walk {
  int i, j;
  __device__ __forceinline__ explicit Walk(int e) : i(1), j(e) { advance(0); }
  // to gradient e + n: past each row of i entries, the next
  __device__ __forceinline__ void advance(int n) {
    for (j += n; j >= i; ++i) j -= i;
  }
};

// S's off-diagonal entries (bf16) from the sample's staged gradients d:
// lane takes gradients lane, lane + 32, ... and writes each to (i, j) and
// (j, i), walking (i, j) along.  The diagonal and the padding past F are
// never written: they stay the zeros the kernel starts with.
__device__ __forceinline__ void build_s_bf16(unsigned char* s_buf,
                                             const uint16_t* d,
                                             const Plan& p, int lane) {
  Walk w(lane);
  for (int e = lane; e < p.P; e += 32, w.advance(32)) {
    const uint16_t v = d[e];
    *reinterpret_cast<uint16_t*>(s_buf + w.i * p.s_stride + 2 * w.j) = v;
    *reinterpret_cast<uint16_t*>(s_buf + w.j * p.s_stride + 2 * w.i) = v;
  }
}

// Sample outputs (rows i, columns n and n + 1) from a pair of f32 sums:
// staged over X in the slot (always in the padded row), else to device
// memory where the columns are inside D.
template <typename T>
__device__ __forceinline__ void put_pair(unsigned char* slot, T* out,
                                         const Plan& p, int i, int n,
                                         float v0, float v1) {
  if (i >= p.F) return;
  if (p.staged) {
    unsigned char* to = slot + i * p.row_stride + n * sizeof(T);
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(to) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(to) = make_float2(v0, v1);
  } else {
    T* o = out + static_cast<long long>(i) * p.D;
    if constexpr (sizeof(T) == 2) {
      if (n < p.D) o[n] = __float2bfloat16(v0);
      if (n + 1 < p.D) o[n + 1] = __float2bfloat16(v1);
    } else {
      if (n < p.D) o[n] = v0;
      if (n + 1 < p.D) o[n + 1] = v1;
    }
  }
}

// out_b = S X on the tensor cores, two strips of S at a time.  For each
// 32-byte column step np (n8 tiles 2 np and 2 np + 1) the k steps run in
// order; X's rows past F are read as row F - 1, which S's zero columns
// cancel.  C fragment c of a tile: row g + 8 (c / 2), column 2 q + c % 2.
__device__ __forceinline__ void product_bf16(unsigned char* slot,
                                             const unsigned char* s_buf,
                                             __nv_bfloat16* out_b,
                                             const Plan& p, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const uint32_t x_s = smem_addr(slot), s_s = smem_addr(s_buf);
  const int k_steps = p.strips;  // S is square: 16 k a strip
  for (int sg = 0; sg < p.strips; sg += 2) {
    const bool two = sg + 1 < p.strips;
    const uint32_t a0_addr =
        s_s + (16 * sg + (lane & 15)) * p.s_stride + (lane >> 4) * 16;
    const uint32_t a1_addr = a0_addr + 16 * p.s_stride;
    for (int np = 0; np < p.n_steps; ++np) {
      float acc[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
      for (int ks0 = 0; ks0 < k_steps; ks0 += kPromote) {
        float ch[2][2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) ch[m][t][e] = 0.f;
        const int ks1 = min(k_steps, ks0 + kPromote);
        for (int ks = ks0; ks < ks1; ++ks) {
          const int k = min(16 * ks + (lane & 15), p.F - 1);
          uint32_t b[4], a[4];
          ldsm_x4_trans(b,
                        x_s + k * p.row_stride + 32 * np + (lane >> 4) * 16);
          ldsm_x4(a, a0_addr + 32 * ks);
          mma_bf16(ch[0][0], a, b[0], b[1]);
          mma_bf16(ch[0][1], a, b[2], b[3]);
          if (two) {
            ldsm_x4(a, a1_addr + 32 * ks);
            mma_bf16(ch[1][0], a, b[0], b[1]);
            mma_bf16(ch[1][1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][t][e] += ch[m][t][e];
      }
      __syncwarp();  // every lane has read step np's columns of X
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !two) break;
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            put_pair(slot, out_b, p, 16 * (sg + m) + g + 8 * h,
                     16 * np + 8 * t + 2 * q, acc[m][t][2 * h],
                     acc[m][t][2 * h + 1]);
      }
    }
  }
}

// out_f = S X in f32 on the CUDA cores, 32 rows of S at a time: the block
// S[rb .. rb + 31][j] is laid out as F rows of 32 floats (row j: column
// j's entries), each lane sums columns c, c + 1 of its output rows over
// j = 0 .. F - 1 in order.
__device__ __forceinline__ void product_f32(unsigned char* slot,
                                            unsigned char* s_buf,
                                            const float* d, float* out_f,
                                            const Plan& p, int lane) {
  float* sb = reinterpret_cast<float*>(s_buf);
  const int width = 8 * p.n_steps;  // floats a staged row
  for (int rb = 0; rb < p.F; rb += kPassRows) {
    __syncwarp();  // the previous block of S has been read
    {
      const int i = rb + lane, ti = i * (i - 1) / 2;
      for (int j = 0, tj = 0; j < p.F; tj += j, ++j) {  // tj = j(j-1)/2
        float v = 0.f;
        if (i < p.F && i != j) v = d[i > j ? ti + j : tj + i];
        sb[j * kPassRows + lane] = v;
      }
    }
    __syncwarp();
    for (int c0 = 0; c0 < width; c0 += 2 * 32) {
      const int c = c0 + 2 * lane;
      if (c >= width) continue;
      float acc[kPassRows][2];
#pragma unroll
      for (int u = 0; u < kPassRows; ++u) acc[u][0] = acc[u][1] = 0.f;
      for (int j = 0; j < p.F; ++j) {
        const float2 x =
            *reinterpret_cast<const float2*>(slot + j * p.row_stride + 4 * c);
        const float4* sr =
            reinterpret_cast<const float4*>(sb + j * kPassRows);
#pragma unroll
        for (int u4 = 0; u4 < kPassRows / 4; ++u4) {
          const float4 s4 = sr[u4];
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[4 * u4 + e][0] = fmaf(sv[e], x.x, acc[4 * u4 + e][0]);
            acc[4 * u4 + e][1] = fmaf(sv[e], x.y, acc[4 * u4 + e][1]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPassRows; ++u)
        put_pair(slot, out_f, p, rb + u, c, acc[u][0], acc[u][1]);
    }
  }
}

// A staged sample's F rows of D values (stride row_stride in the slot)
// to out_s, 16 bytes a store where rows are 16-byte multiples.
template <int es>
__device__ __forceinline__ void copy_out(unsigned char* out_s,
                                         const unsigned char* slot,
                                         const Plan& p, int lane) {
  const int row_bytes = p.D * es;
  if (p.vec_out) {
    const int per_row = row_bytes / 16;
    for (Chunk k(lane, per_row); k.r < p.F; k.next(per_row)) {
      const int c = 16 * k.c;
      *reinterpret_cast<uint4*>(out_s + k.r * row_bytes + c) =
          *reinterpret_cast<const uint4*>(slot + k.r * p.row_stride + c);
    }
  } else {
    for (int r = 0; r < p.F; ++r)
      for (int k = lane; k < p.D; k += 32) {
        if constexpr (es == 2)
          reinterpret_cast<uint16_t*>(out_s + r * row_bytes)[k] =
              reinterpret_cast<const uint16_t*>(slot + r * p.row_stride)[k];
        else
          reinterpret_cast<uint32_t*>(out_s + r * row_bytes)[k] =
              reinterpret_cast<const uint32_t*>(slot + r * p.row_stride)[k];
      }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kBf16 ? 4 : 2)
    dot_interact_bwd_kernel(const void* __restrict__ dout,
                            const void* __restrict__ feats,
                            void* __restrict__ dfeats, const Plan p) {
  constexpr int es = kBf16 ? 2 : 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  unsigned char* s_buf = smem + warp * p.warp_bytes;
  unsigned char* ring = s_buf + p.s_bytes;
  if constexpr (kBf16) {  // S's diagonal and padding, for every sample
    for (int o = 16 * lane; o < p.s_bytes; o += 16 * 32)
      *reinterpret_cast<uint4*>(s_buf + o) = make_uint4(0, 0, 0, 0);
  }
  // this warp's samples: first, first + step, ...
  const long long first = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long step = static_cast<long long>(gridDim.x) * warps;
  const int n = first < p.B ? static_cast<int>((p.B - 1 - first) / step) + 1
                            : 0;
  auto fetch = [&](int k) {
    if (k < n)
      stage_sample<es>(ring + (k % p.stages) * p.slot_bytes, dout, feats, p,
                       first + k * step, lane);
    cp_async_commit();
  };

  for (int k = 0; k < p.stages - 1; ++k) fetch(k);
  for (int k = 0; k < n; ++k) {
    __syncwarp();  // slot (k - 1) % stages and S are free
    fetch(k + p.stages - 1);
    cp_async_wait(p.stages - 1);
    __syncwarp();  // sample k's rows and gradients are in shared memory

    const long long s = first + k * step;
    unsigned char* slot = ring + (k % p.stages) * p.slot_bytes;
    const int shift = static_cast<int>(dout_at(dout, p, s, es) & 15);
    const unsigned char* d = slot + p.x_bytes + shift;
    unsigned char* out_s = static_cast<unsigned char*>(dfeats) +
                           s * p.F * static_cast<long long>(p.D) * es;
    if constexpr (kBf16) {
      build_s_bf16(s_buf, reinterpret_cast<const uint16_t*>(d), p, lane);
      __syncwarp();
      product_bf16(slot, s_buf, reinterpret_cast<__nv_bfloat16*>(out_s), p,
                   lane);
    } else {
      product_f32(slot, s_buf, reinterpret_cast<const float*>(d),
                  reinterpret_cast<float*>(out_s), p, lane);
    }
    if (p.staged) {
      __syncwarp();
      copy_out<es>(out_s, slot, p, lane);
    }
  }
  cp_async_wait(0);
}

// A plan for these shapes, or false when a sample does not fit.
bool make_plan(Plan& p, int& warps, const void* feats, const void* out,
               int B, int F, int D, int es, int n_sm) {
  p.B = B;
  p.F = F;
  p.D = D;
  const long long pairs = static_cast<long long>(F) * (F - 1) / 2;
  if (pairs * es > kSmemMax) return false;
  const long long row_bytes = static_cast<long long>(D) * es;
  if (row_bytes > kSmemMax) return false;
  p.P = static_cast<int>(pairs);
  p.strips = (F + 15) / 16;
  p.n_steps = static_cast<int>((row_bytes + 31) / 32);
  p.row_stride = 32 * p.n_steps + 16;
  const long long x_bytes = static_cast<long long>(F) * p.row_stride;
  const long long slot = x_bytes + (pairs ? 16 * ((pairs * es + 31) / 16) : 0);
  p.s_stride = es == 2 ? 32 * p.strips + 16 : 4 * kPassRows;
  const long long s_bytes = es == 2 ? 16LL * p.strips * p.s_stride
                                    : static_cast<long long>(F) * p.s_stride;
  if (s_bytes + slot > kSmemMax) return false;
  p.x_bytes = static_cast<int>(x_bytes);
  p.slot_bytes = static_cast<int>(slot);
  p.s_bytes = static_cast<int>(s_bytes);
  p.staged = F <= kPassRows;
  p.vec = reinterpret_cast<uintptr_t>(feats) % 16 == 0 && row_bytes % 16 == 0;
  p.vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
              row_bytes % 16 == 0;
  // a ring of three or two slots at 16 warps an SM, else at 12, else at
  // 8, else the most slots that fit at all; warps enough that a small
  // batch still reaches every SM
  const long long spread = (static_cast<long long>(B) + n_sm - 1) / n_sm;
  for (const int room : {kWarpRoom[0], kWarpRoom[1], kWarpRoom[2], kSmemMax})
    for (int stages = kMaxStages; stages >= (room == kSmemMax ? 1 : 2);
         --stages) {
      const long long per_warp = s_bytes + stages * slot;
      if (per_warp > room) continue;
      int w = kMaxWarps;
      while (w > 1 && (w > spread || w * per_warp > kSmemMax)) w /= 2;
      warps = w;
      p.stages = stages;
      p.warp_bytes = static_cast<int>(per_warp);
      return true;
    }
  return false;
}

template <bool kBf16>
int launch(const void* dout, const void* feats, void* dfeats, int B, int F,
           int D, cudaStream_t stream) {
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  Plan p;
  int warps = 0;
  if (!make_plan(p, warps, feats, dfeats, B, F, D, kBf16 ? 2 : 4, n_sm))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 32 * warps, smem = warps * p.warp_bytes;
  e = cudaFuncSetAttribute(dot_interact_bwd_kernel<kBf16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dot_interact_bwd_kernel<kBf16>, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (static_cast<long long>(B) + warps - 1) / warps;
  const long long grid =
      std::min(blocks, static_cast<long long>(n_sm) * std::max(per_sm, 1));
  dot_interact_bwd_kernel<kBf16><<<static_cast<unsigned>(grid), threads,
                                   smem, stream>>>(dout, feats, dfeats, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dout (B, F(F-1)/2), feats and dfeats (B, F, D), contiguous, f32 or
// (bf16 != 0) bf16.  Requires B, F, D > 0.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue when a sample does not fit
// shared memory.
extern "C" int dot_interact_bwd_launch(const void* dout, const void* feats,
                                       void* dfeats, int B, int F, int D,
                                       int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(dout, feats, dfeats, B, F, D, s)
              : launch<false>(dout, feats, dfeats, B, F, D, s);
}
