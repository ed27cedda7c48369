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
// far below the card's ~20 f32 flops a byte.
//
// Design: one block stages S whole samples (S*F*D contiguous values) in
// shared memory with 16-byte loads, converted to f32, each feature row
// padded to D + 1 floats so that threads reading different rows at the
// same column hit different banks.  Each thread then takes (sample,
// pair) items in output order, so a warp's 32 results are 32 adjacent
// output values (one coalesced store), and runs one row-against-row dot
// product in f32 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemTarget = 48 * 1024;   // shared memory a block aims at
constexpr int kSmemMax = 227 * 1024;     // the most a block may have
constexpr int kMaxSamples = 8;           // samples staged per block

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

template <bool kBf16>
__device__ __forceinline__ float load_one(const void* p, long long i) {
  if constexpr (kBf16)
    return bf16_bits_to_f32(static_cast<const uint16_t*>(p)[i]);
  else
    return static_cast<const float*>(p)[i];
}

template <bool kBf16>
__device__ __forceinline__ void store_one(void* p, long long i, float v) {
  if constexpr (kBf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);  // nearest even
  else
    static_cast<float*>(p)[i] = v;
}

// pair p of the strictly lower triangle -> (i, j), j < i, p = i(i-1)/2 + j
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  i = static_cast<int>((1.f + sqrtf(8.f * p + 1.f)) * 0.5f);
  while (i * (i - 1) / 2 > p) --i;
  while ((i + 1) * i / 2 <= p) ++i;
  j = p - i * (i - 1) / 2;
}

// vec: the block's values may be read 16 bytes at a time (aligned base,
// rows a whole number of 16-byte words).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    dot_interact_kernel(const void* __restrict__ feats,
                        void* __restrict__ out, int B, int F, int D, int S,
                        bool vec) {
  extern __shared__ float s_rows[];  // S x F rows of D + 1 floats
  const int ld = D + 1;
  const int P = F * (F - 1) / 2;
  const long long s0 = static_cast<long long>(blockIdx.x) * S;
  const int n = static_cast<int>(min(static_cast<long long>(S), B - s0));
  const long long base = s0 * F * D;  // first value of the block
  const int n_vals = n * F * D;

  if (vec) {
    constexpr int kPer = kBf16 ? 8 : 4;  // values in 16 bytes
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const char*>(feats) + base * (kBf16 ? 2 : 4));
    for (int v = threadIdx.x; v < n_vals / kPer; v += blockDim.x) {
      const uint4 u = src[v];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      const int e0 = v * kPer;
      const int r = e0 / D, c = e0 - r * D;  // 16 bytes lie in one row
      float* dst = s_rows + r * ld + c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (kBf16) {
          dst[2 * q] = bf16_bits_to_f32(w[q] & 0xffffu);
          dst[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
        } else {
          dst[q] = __uint_as_float(w[q]);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < n_vals; e += blockDim.x) {
      const int r = e / D, c = e - r * D;
      s_rows[r * ld + c] = load_one<kBf16>(feats, base + e);
    }
  }
  __syncthreads();

  const int tile = F * ld;
  for (int it = threadIdx.x; it < n * P; it += blockDim.x) {
    const int s = it / P, p = it - s * P;
    int i, j;
    pair_of(p, i, j);
    const float* a = s_rows + s * tile + i * ld;
    const float* b = s_rows + s * tile + j * ld;
    float acc = 0.f;
    for (int k = 0; k < D; ++k) acc = fmaf(a[k], b[k], acc);
    store_one<kBf16>(out, s0 * P + it, acc);
  }
}

template <bool kBf16>
int launch(const void* feats, void* out, int B, int F, int D,
           cudaStream_t stream) {
  const long long per_sample = static_cast<long long>(F) * (D + 1) * 4;
  if (per_sample > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  int S = static_cast<int>(kSmemTarget / per_sample);
  S = S < 1 ? 1 : (S > kMaxSamples ? kMaxSamples : S);
  const int smem = static_cast<int>(S * per_sample);
  const int esize = kBf16 ? 2 : 4;
  const bool vec = reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   (static_cast<long long>(D) * esize) % 16 == 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dot_interact_kernel<kBf16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (static_cast<long long>(B) + S - 1) / S;
  dot_interact_kernel<kBf16><<<static_cast<unsigned>(blocks), kThreads,
                               smem, stream>>>(feats, out, B, F, D, S, vec);
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
