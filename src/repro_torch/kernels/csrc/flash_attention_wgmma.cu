// Flash attention on Hopper's tensor cores, bf16: q (B, T, H, dh), k/v
// (B, S, Hkv, dh) -> (B, T, H, dh) bf16, with GQA (kv head h / (H / Hkv)),
// a scale, an optional tanh softcap c * tanh(s / c), the mask k_pos < S,
// causal (k_pos <= q_pos, both counted from 0) and a sliding window
// (q_pos - k_pos < window when window > 0).  dh is a multiple of 8 up to
// 256.  The f32 form of the same function is flash_attention.cu.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention), the self-attention of models/lm.py's prefill.  Its
// grid runs the kv blocks of one (batch, head, q block) in order on one
// core, carrying the online-softmax state in VMEM scratch.  Here a block
// owns 128 query rows of one (batch, head) and walks the kv tiles in a
// loop of its own.
//
// Bound: operations.  A (query, key) pair costs 4 * dh flops (QK^T and
// PV) against 2 * dh values of k and v that every q tile of the head
// shares: at T = S = 32k, dh = 256 some 2,000 flops a byte, far above
// the ~295 bf16 flops a byte at which the card turns from bytes to
// operations.  So both products run on the tensor cores (wgmma, bf16 in,
// f32 accumulate), and the loads are kept off the threads that run
// them.
//
// Design (sm_90a, one block an SM, 384 threads in three warpgroups):
// - Warpgroup 2 is the producer.  It gives its registers away
//   (setmaxnreg 24), and one of its threads starts every load by TMA:
//   the block's Q tile once (128 rows), then K and V tiles of 64 keys
//   into a two-stage ring.  Each ring slot has a "full" mbarrier (the
//   TMA's byte count) and an "empty" one (the 256 consumer threads'
//   arrivals), K and V separately, so K of the next tile lands while
//   the current V is still read.  Tiles wholly above the diagonal or
//   outside the window are never loaded.
// - Tensor maps are 4-D (dh, H, T or S, B), built on the host for each
//   call straight from the tensors' strides (so views of one fused qkv
//   need no copy), with the 128-byte swizzle and dh cut into boxes of
//   64: a tile is dh/64 chunks of rows x 128 bytes.  Past dh, T and S the
//   TMA fills zeros, which add nothing to either product.
// - Warpgroups 0 and 1 (setmaxnreg 240) each own 64 of the query rows.
//   S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//   (K-major).  Scale, softcap (tanh.approx) and the masks are applied
//   to S in registers, the masks only on tiles that cross the diagonal,
//   the window's edge or S.  Row max and sum take a quad shuffle; the
//   softmax runs in base 2 (ex2.approx).  P is rounded to bf16 in
//   registers, as the plain version rounds it, and fed back as the
//   register A operand of the PV wgmma (the m64nNk16 accumulator layout
//   is the A-fragment layout); V is the B operand read MN-major (the
//   transpose bit).  The (64, dh) output accumulator stays in registers
//   (128 a thread at dh = 256) and is written once, divided by the row
//   sum and rounded to bf16, through the output's strides.
// - Masked scores are -1e30, not -inf: a row that has seen no admitted
//   key yet weighs its masked keys equally until one arrives, which then
//   rescales them to 0 (flash_attention.cu does the same).
// - q tiles start in reverse order, so the longest causal walks go
//   first.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;        // query rows per block, 64 per consumer
constexpr int kBK = 64;         // keys per kv tile
constexpr int kStages = 2;      // ring slots for K and for V
constexpr int kThreads = 384;   // consumers: warpgroups 0, 1; producer: 2
constexpr int kRow = 128;       // bytes of one swizzled row: 64 bf16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;
  long long o_sb, o_st, o_sh;  // element strides of (B, T, H); dh is 1
  int T, S, group, dh, n_qt, causal, window;
  float scale_log2;  // scale * log2(e), used without a softcap
  float scale_cap;   // scale / softcap
  float cap_log2;    // softcap * log2(e); 0: no softcap
};

// -- wgmma and arithmetic ------------------------------------------------------

// MN-major (V as the B operand of PV): 8 keys of 128 bytes a group,
// groups 1024 bytes apart; the next 64 columns would be a chunk away.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_sw128(addr, kBK * kRow, 8 * kRow);
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// -- the kernel --------------------------------------------------------------

// NC: 64-column chunks of dh (dh <= 64 NC).
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const Params p) {
  constexpr uint32_t kQBytes = NC * kBQ * kRow;   // 16 KB a chunk
  constexpr uint32_t kKVBytes = NC * kBK * kRow;  // 8 KB a chunk
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: align every tile to it
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + kQBytes;
  const uint32_t sv = sk + kStages * kKVBytes;
  const uint32_t bars = sv + kStages * kKVBytes;
  const uint32_t q_full = bars;
  // per stage s: k_full, v_full, k_empty, v_empty
  auto bar = [&](int kind, int s) -> uint32_t {
    return bars + 8 + 8 * (kind * kStages + s);
  };

  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int q0 = qt * kBQ;

  // the kv tiles any row of this q tile can see
  const int q_last = min(q0 + kBQ, p.T) - 1;
  const int k_end = p.causal ? min(p.S, q_last + 1) : p.S;
  const int k_begin =
      p.window > 0 ? max(0, q0 - p.window + 1) / kBK * kBK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(0, s), 1);
      mbar_init(bar(1, s), 1);
      mbar_init(bar(2, s), 256);
      mbar_init(bar(3, s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread starts every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load(sq + c * kBQ * kRow, &tq, q_full, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t free_parity = ((i / kStages) & 1) ^ 1;
        const int k0 = k_begin + i * kBK;
        mbar_wait(bar(2, s), free_parity);
        mbar_expect_tx(bar(0, s), kKVBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sk + s * kKVBytes + c * kBK * kRow, &tk, bar(0, s), 64 * c,
                   hk, k0, b);
        mbar_wait(bar(3, s), free_parity);
        mbar_expect_tx(bar(1, s), kKVBytes);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load(sv + s * kKVBytes + c * kBK * kRow, &tv, bar(1, s), 64 * c,
                   hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int rq0 = q0 + 64 * wg;                   // this warpgroup's rows
    const int row0 = rq0 + 16 * (tid / 32) + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);  // + 8 j (+ 1) within a 64-wide block
    const uint32_t q_rows = sq + 64 * wg * kRow;

    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // running max, log2 units
    float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sum

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t full_parity = (i / kStages) & 1;
      const int k0 = k_begin + i * kBK;

      // S = Q K^T
      float sc[32];
      mbar_wait(bar(0, s), full_parity);
      const uint32_t kt = sk + s * kKVBytes;
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(sc, desc_kmajor(q_rows + c * kBQ * kRow + 32 * kk),
                   desc_kmajor(kt + c * kBK * kRow + 32 * kk), c | kk);
      wg_commit();
      wg_wait_all();
      fence_regs(sc);
      mbar_arrive(bar(2, s));

      // scale and softcap, in log2 units
      if (p.cap_log2 > 0.f) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          sc[e] = p.cap_log2 * tanh_approx(sc[e] * p.scale_cap);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] *= p.scale_log2;
      }
      const bool need_mask =
          k0 + kBK > p.S || (p.causal && k0 + kBK - 1 > rq0) ||
          (p.window > 0 && rq0 + 63 - k0 >= p.window);
      if (need_mask) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int row = row0 + ((e & 2) ? 8 : 0);
          const int col = k0 + 8 * (e / 4) + col0 + (e & 1);
          bool ok = col < p.S;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) ok = ok && row - col < p.window;
          if (!ok) sc[e] = kNegInf;
        }
      }

      // online softmax of rows row0 (e & 2 == 0) and row0 + 8
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[4 * j] = ex2(sc[4 * j] - mx0);
        sc[4 * j + 1] = ex2(sc[4 * j + 1] - mx0);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] - mx1);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] - mx1);
        rs0 += sc[4 * j] + sc[4 * j + 1];
        rs1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
      // P in bf16, laid out as the A operand: k16 step kk takes blocks
      // 2kk and 2kk + 1 of the accumulator
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j] *= a0;
          o[c][4 * j + 1] *= a0;
          o[c][4 * j + 2] *= a1;
          o[c][4 * j + 3] *= a1;
        }

      // O += P V
      mbar_wait(bar(1, s), full_parity);
      const uint32_t vt = sv + s * kKVBytes;
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_rs(o[c], pa[kk], desc_mnmajor(vt + c * kBK * kRow +
                                              16 * kk * kRow));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(o[c]);
      mbar_arrive(bar(3, s));
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row >= p.T) continue;
      const long long at = b * p.o_sb + row * p.o_st + h * p.o_sh;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + col0;
          if (col < p.dh) {  // dh is a multiple of 8: pairs never straddle
            const uint32_t v =
                pack_bf16(o[c][4 * j + 2 * half] * inv[half],
                          o[c][4 * j + 2 * half + 1] * inv[half]);
            *reinterpret_cast<uint32_t*>(out + at + col) = v;
          }
        }
    }
  }
}

// -- host side ---------------------------------------------------------------

// A 4-D bf16 map (dh, heads, rows, batch) with boxes of 64 x 1 x
// box_rows x 1 and the 128-byte swizzle; st_* are element strides.  A
// dimension of extent 1 is never stepped, so its stride is replaced by
// the packed one.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int dh, int heads, int rows, int batch, long long st_h,
                  long long st_r, long long st_b, int box_rows) {
  if (heads == 1) st_h = dh;
  if (rows == 1) st_r = st_h * heads;
  if (batch == 1) st_b = st_r * rows;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st_h) * 2,
                                 static_cast<cuuint64_t>(st_r) * 2,
                                 static_cast<cuuint64_t>(st_b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int NC>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Params& p, int B, int H, cudaStream_t stream) {
  const size_t smem = 1024 + static_cast<size_t>(NC) * (kBQ + 2 * kStages * kBK) *
                                 kRow + 8 * (1 + 4 * kStages);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.n_qt, H, B);
  flash_wgmma_kernel<NC><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: raw bf16 bits, the last dimension contiguous, base pointers
// 16-byte aligned and the other strides multiples of 8 elements (16
// bytes) where their extent is above 1.  strides: 12 element strides,
// (b, t, h) of q, (b, s, h) of k, of v and (b, t, h) of o.  softcap <= 0
// means none, window <= 0 global.  Requires dh a multiple of 8 in
// [8, 256], Hkv | H, B and H <= 65535.  Returns 0, a cudaError_t, or
// -1 when libcuda has no cuTensorMapEncodeTiled and -(1000 + r) when
// it refuses a map with CUresult r.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o,
    const long long* strides, int B, int T, int S, int H, int Hkv, int dh,
    int causal, int window, float scale, float softcap, void* stream) {
  if (dh < 8 || dh > 256 || dh % 8 || Hkv < 1 || H % Hkv || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(encode, &tq, q, dh, H, T, B, strides[2], strides[1],
                        strides[0], kBQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tk, k, dh, Hkv, S, B, strides[5], strides[4],
                 strides[3], kBK);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tv, v, dh, Hkv, S, B, strides[8], strides[7],
                 strides[6], kBK);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  Params p;
  p.o = o;
  p.o_sb = strides[9];
  p.o_st = strides[10];
  p.o_sh = strides[11];
  p.T = T;
  p.S = S;
  p.group = H / Hkv;
  p.dh = dh;
  p.n_qt = (T + kBQ - 1) / kBQ;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  p.scale_cap = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_log2 = softcap > 0.f ? softcap * kLog2e : 0.f;
  const auto s = static_cast<cudaStream_t>(stream);
  switch ((dh + 63) / 64) {
    case 1: return launch<1>(tq, tk, tv, p, B, H, s);
    case 2: return launch<2>(tq, tk, tv, p, B, H, s);
    case 3: return launch<3>(tq, tk, tv, p, B, H, s);
    default: return launch<4>(tq, tk, tv, p, B, H, s);
  }
}
