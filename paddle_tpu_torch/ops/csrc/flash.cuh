// Device helpers shared by the flash-attention kernels (flash_fwd.cu and
// flash_bwd.cu): the [B, S, H, D] view's strides, the reference's mask,
// and the swizzled bf16 tiles that the mma.sync kernels fill by cp.async
// and read by ldmatrix (with its lanes' roles). The TF32 kernels' tiles
// and products build on it in flash_tf32.cuh, the streaming route's
// (head_dim above 512) on both in flash_stream.cuh. ops/_build.py hashes
// this header (and hopper.cuh, which it includes) with both sources.

#pragma once

#include "hopper.cuh"

namespace flash {

using namespace hopper;

struct Strides {  // element strides of a [B, S, H, D] view (d contiguous)
  long long b, s, h;
};

// The forward's mask (flash_attention.py `_causal_mask`): keep k <= q,
// and q - k < window.
__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return !causal || (kp <= qp && (window <= 0 || qp - kp < window));
}

// byte offset of 16-byte chunk c of row r in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled by the row's low three bits
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// ldmatrix lane roles (flash_fwd.cu's bf16 kernel): A fragments and the B
// fragments of a [k][n] tile (ldmatrix.trans) address row lane % 16, chunk
// lane / 16; the B fragments of an [n][k] tile row lane % 8 (+8 for lanes
// 16-31), chunk (lane / 8) % 2; g and t the mma fragments' lane / 4 and
// lane % 4
struct Lanes {
  int g, t, a_r, a_c, b_r, b_c;
  __device__ explicit Lanes(int lane)
      : g(lane >> 2), t(lane & 3), a_r(lane & 15), a_c(lane >> 4),
        b_r((lane & 7) + ((lane >> 4) << 3)), b_c((lane >> 3) & 1) {}
};

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

// the block's (b*h, tile): b*h on gridDim.x (no 65,535 limit), the tiles
// on gridDim.y; with `reverse` the last tile (a causal query tile's
// heaviest) first, as the tensor-core kernels launch them
__device__ __forceinline__ void bh_tile(bool reverse, int& bh, int& tile) {
  bh = blockIdx.x;
  tile = reverse ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
}

}  // namespace flash
