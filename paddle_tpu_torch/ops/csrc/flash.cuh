// Device helpers shared by the flash-attention kernels (flash_fwd.cu and
// flash_bwd.cu): the [B, S, H, D] view's strides, the reference's mask,
// and the swizzled bf16 tiles that the mma.sync kernels fill by cp.async
// and read by ldmatrix (with its lanes' roles). ops/_build.py hashes this
// header (and hopper.cuh, which it includes) with both sources.

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

// ---- the streaming route (head_dim above 512) -----------------------------
//
// No tile of a whole head's width fits in shared memory above 512, so the
// streaming kernels (flash_fwd_stream_kernel, flash_dq_stream_kernel,
// flash_dkv_stream_kernel) form S and dP over the head dim in 64-wide
// chunks of fp32 tiles, and each output in 64-wide chunks of its columns.
// 256 threads in a 16 x 16 grid; a thread holds a 4 x 4 slice of a 64 x 64
// tile.

constexpr int ST_ROWS = 64;            // rows of a query or key tile
constexpr int ST_LD = ST_ROWS + 1;     // the fp32 tiles' row stride
constexpr int ST_THREADS = 256;
constexpr int ST_TILE = ST_ROWS * ST_LD;  // floats of one staged tile

// dst[r][c] = src row r0 + r, column d0 + c, times mul: one 64 x 64 chunk
// of a strided view in fp32
template <typename T>
__device__ __forceinline__ void stage_chunk(float* dst, const T* src,
                                            long long row_stride, int r0,
                                            int d0, float mul) {
  for (int idx = threadIdx.x; idx < ST_ROWS * ST_ROWS; idx += ST_THREADS) {
    const int r = idx / ST_ROWS, c = idx % ST_ROWS;
    dst[r * ST_LD + c] =
        to_f(src[(long long)(r0 + r) * row_stride + d0 + c]) * mul;
  }
}

// acc[i][j] += the chunk's A[ty + 16 i] . B[tx + 16 j]
__device__ __forceinline__ void chunk_dot(const float* A, const float* B,
                                          float (&acc)[4][4], int ty,
                                          int tx) {
#pragma unroll 8
  for (int d = 0; d < ST_ROWS; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * ST_LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * ST_LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum over the 64 rows c of P[ty + 16 i][c] V[c][tx + 16 j]
// (with `trans`, P[c][ty + 16 i]: the dK/dV kernel's P^T and dS^T)
template <bool trans>
__device__ __forceinline__ void chunk_pv(const float* P, const float* V,
                                         float (&acc)[4][4], int ty,
                                         int tx) {
#pragma unroll 4
  for (int c = 0; c < ST_ROWS; ++c) {
    float p[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = trans ? P[c * ST_LD + ty + 16 * i] : P[(ty + 16 * i) * ST_LD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = V[c * ST_LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
  }
}

// s = (Q * scale) K^T of the query rows q0.. and key rows k0.. over the
// whole head dim D, staged 64 columns at a time through Qc and Kc; with
// DP also dp = dO V^T through dOc and Vc. Starts with a barrier (the
// previous readers of the four tiles are done) and ends without one.
template <typename T, bool DP>
__device__ __forceinline__ void stream_scores(
    float (&s)[4][4], float (&dp)[4][4], float* Qc, float* Kc, float* dOc,
    float* Vc, const T* qb, long long q_s, const T* kb, long long k_s,
    const T* dob, long long do_s, const T* vb, long long v_s, int q0, int k0,
    int D, float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += ST_ROWS) {
    __syncthreads();
    stage_chunk(Qc, qb, q_s, q0, d0, scale);
    stage_chunk(Kc, kb, k_s, k0, d0, 1.f);
    if constexpr (DP) {
      stage_chunk(dOc, dob, do_s, q0, d0, 1.f);
      stage_chunk(Vc, vb, v_s, k0, d0, 1.f);
    }
    __syncthreads();
    chunk_dot(Qc, Kc, s, ty, tx);
    if constexpr (DP) chunk_dot(dOc, Vc, dp, ty, tx);
  }
}

// the block's (b*h, tile): b*h on gridDim.x (no 65,535 limit), the tiles
// on gridDim.y; with `reverse` the last tile (a causal query tile's
// heaviest) first, as the tensor-core kernels launch them
__device__ __forceinline__ void bh_tile(bool reverse, int& bh, int& tile) {
  bh = blockIdx.x;
  tile = reverse ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
}

}  // namespace flash
