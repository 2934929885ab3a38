// Device helpers shared by the flash-attention kernels (flash_fwd.cu and
// flash_bwd.cu): the [B, S, H, D] view's strides, the reference's mask,
// the SFU's exp2, and the swizzled bf16 tiles that the mma.sync kernels
// fill by cp.async and read by ldmatrix. ops/_build.py hashes this header
// (and hopper.cuh, which it includes) with both sources.

#pragma once

#include "hopper.cuh"

namespace flash {

using namespace hopper;

struct Strides {  // element strides of a [B, S, H, D] view (d contiguous)
  long long b, s, h;
};

constexpr float LOG2E = 1.4426950408889634f;

// The forward's mask (flash_attention.py `_causal_mask`): keep k <= q,
// and q - k < window.
__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return !causal || (kp <= qp && (window <= 0 || qp - kp < window));
}

// 2^x on the SFU (relative error 2^-22, subnormal results flushed to 0:
// a probability that small adds nothing to an fp32 sum that holds a 1)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled by the row's low three bits
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// rows [0, n) of a [B, S, H, D] bf16 view at sequence position s0 into a
// swizzled tile by `threads` threads, 16 bytes a cp.async; rows at or past
// S are zero-filled
template <int D, int THREADS>
__device__ __forceinline__ void cp_async_tile(uint32_t dst,
                                              const __nv_bfloat16* base,
                                              long long stride_s, int s0,
                                              int n, int S, int tid) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < n * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const int sp = s0 + r;
    cp_async16(dst + swz<D>(r, c),
               base + (long long)(sp < S ? sp : S - 1) * stride_s + c * 8,
               sp < S);
  }
}

// a 16-byte-aligned pointer, and 16-byte steps along every dimension of
// more than one element, for elements of `bytes` bytes
inline bool aligned16(const void* p, const Strides& st, int B, int H,
                      int bytes = 2) {
  const int e = 16 / bytes;  // elements in 16 bytes
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (B == 1 || st.b % e == 0) && st.s % e == 0 &&
         (H == 1 || st.h % e == 0);
}

}  // namespace flash
