// The fp32 flash kernels' TF32 tensor-core building blocks, shared by
// flash_fwd.cu (flash_fwd_tf32_kernel) and flash_bwd.cu
// (flash_dq_tf32_kernel, flash_dkv_tf32_kernel): fp32 tiles staged by
// cp.async into rows of D + 4 floats, the two kinds of product formed in
// three TF32 passes (mma_tf32x3, hopper.cuh) with their k index permuted
// so that every fragment loads 16 bytes a lane without bank conflicts and
// an m16n8 accumulator is the next product's A fragment as it stands, and
// the accumulator's 16-byte stores. A warp owns 16 rows: the block of ROWS
// rows runs tf_threads<ROWS>() threads. ops/_build.py hashes this header
// (and flash.cuh, hopper.cuh) with both sources.

#pragma once

#include "flash.cuh"

namespace flash {

template <int ROWS> __host__ __device__ constexpr int tf_threads() {
  return 2 * ROWS;
}
// floats a row of a staged fp32 tile: D + 4, a whole number of 16-byte
// chunks whose bank group advances by one (mod 8) from a row to the next,
// so that no fragment load below has a bank conflict
template <int D> __host__ __device__ constexpr int tf_ld() { return D + 4; }

// rows [0, n) of a [B, S, H, D] fp32 view at sequence position s0 into a
// [n][D + 4] tile by `threads` threads, 16 bytes a cp.async; rows at or
// past S are zero-filled
template <int D, int THREADS>
__device__ __forceinline__ void cp_async_tile_f32(uint32_t dst,
                                                  const float* base,
                                                  long long stride_s, int s0,
                                                  int n, int S, int tid) {
  constexpr int CH = D / 4;
  for (int idx = tid; idx < n * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const int sp = s0 + r;
    cp_async16(dst + (r * tf_ld<D>() + 4 * c) * 4,
               base + (long long)(sp < S ? sp : S - 1) * stride_s + c * 4,
               sp < S);
  }
}

// the four floats of a 16-byte shared-memory load, split into TF32 big
// and small parts
__device__ __forceinline__ void split4(const float* p, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  split_tf32(x.x, big[0], small[0]);
  split_tf32(x.y, big[1], small[1]);
  split_tf32(x.z, big[2], small[2]);
  split_tf32(x.w, big[3], small[3]);
}

// X = A B^T over D in three TF32 passes: A the warp's 16 rows of a
// [rows][D + 4] fp32 tile from row ar0, B rows [0, N) of another. The
// head-dim index is summed, so it may be permuted: lane t reads 16-byte
// chunk 8 h + 2 t + s of a row (columns 32 h + 8 t + 4 s .. + 3), which
// feeds k-steps 4 h + 2 s + e (e = 0, 1): slot t from column 32 h + 8 t +
// 4 s + 2 e, slot t + 4 from the next. A and B read the same columns. One
// load gives a fragment row two k-steps, and a quarter warp (g in {2 q,
// 2 q + 1}, t = 0..3) touches eight distinct 16-byte bank groups. With
// UNROLL the loop over h is unrolled too: faster, but two chunks' split
// operands in flight at once need registers that the dQ kernel at head_dim
// 64 (168 a thread) and the dK/dV kernel at 128 (255) do not have.
// product_nt_add adds the products to X as it stands (the streaming
// kernels sum S over the head dim one chunk tile at a time); product_nt
// zeroes X first.
template <int D, int N, bool UNROLL>
__device__ __forceinline__ void product_nt_add(float (&x)[N / 8][4],
                                               const float* a,
                                               const float* b, int ar0,
                                               const Lanes& L) {
  constexpr int LD = tf_ld<D>();
  auto chunk = [&](int h) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int col = 32 * h + 8 * L.t + 4 * s;
      // rows g and g + 8, four columns each; the A fragment of k-step e
      // takes their columns 2 e and 2 e + 1
      uint32_t rb[2][4], rs[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        split4(a + (ar0 + L.g + 8 * r) * LD + col, rb[r], rs[r]);
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // fragment slot f: row f & 1
          ab[e][f] = rb[f & 1][2 * e + (f >> 1)];
          as[e][f] = rs[f & 1][2 * e + (f >> 1)];
        }
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        uint32_t bb[4], bs[4];
        split4(b + (8 * j + L.g) * LD + col, bb, bs);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mma_tf32x3(x[j], ab[e], as[e], bb[2 * e], bb[2 * e + 1],
                     bs[2 * e], bs[2 * e + 1]);
      }
    }
  };
  if constexpr (UNROLL) {
#pragma unroll
    for (int h = 0; h < D / 32; ++h) chunk(h);
  } else {
#pragma unroll 1
    for (int h = 0; h < D / 32; ++h) chunk(h);
  }
}

template <int D, int N, bool UNROLL>
__device__ __forceinline__ void product_nt(float (&x)[N / 8][4],
                                           const float* a, const float* b,
                                           int ar0, const Lanes& L) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) x[j][r] = 0.f;
  product_nt_add<D, N, UNROLL>(x, a, b, ar0, L);
}

// X += A B over K = 8 KS in three TF32 passes: A the fp32 accumulators of
// the warp's 16 rows (k-tile j: columns 8 j + 2 t and + 1 of rows g and
// g + 8), B rows [0, 8 KS) of a [k][D + 4] fp32 tile. The k index is
// summed, so k-step j takes slot t from accumulator column 8 j + 2 t and
// slot t + 4 from 8 j + 2 t + 1: the accumulator is the A fragment without
// a shuffle, and B comes from rows 8 j + 2 t and + 1. The output column is
// permuted too: n-tile 4 m + c's column g is head-dim column 32 m + 4 g +
// c, so a lane loads B 16 bytes at a time (a quarter warp on eight
// distinct bank groups) and holds, of each output row, the eight
// contiguous head-dim columns 32 m + 8 t .. + 7 (store_acc_f32).
template <int D, int KS>
__device__ __forceinline__ void product_acc(float (&x)[D / 8][4],
                                            const float (&a)[KS][4],
                                            const float* b, const Lanes& L) {
  constexpr int LD = tf_ld<D>();
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(a[j][0], ab[0], as[0]);  // row g, slot t
    split_tf32(a[j][2], ab[1], as[1]);  // row g + 8, slot t
    split_tf32(a[j][1], ab[2], as[2]);  // row g, slot t + 4
    split_tf32(a[j][3], ab[3], as[3]);  // row g + 8, slot t + 4
    const float* brow = b + (8 * j + 2 * L.t) * LD + 4 * L.g;
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      uint32_t lo_b[4], lo_s[4], hi_b[4], hi_s[4];  // rows 2 t, 2 t + 1
      split4(brow + 32 * m, lo_b, lo_s);
      split4(brow + LD + 32 * m, hi_b, hi_s);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        mma_tf32x3(x[4 * m + c], ab, as, lo_b[c], hi_b[c], lo_s[c],
                   hi_s[c]);
    }
  }
}

// the warp's 16 rows of product_acc's accumulators, times mul, to sequence
// positions s0.. of a [B, S, H, D] fp32 view: a lane writes 32 contiguous
// bytes of a row for every 32 columns; rows at or past S are not written
template <int D>
__device__ __forceinline__ void store_acc_f32(const float (&x)[D / 8][4],
                                              float mul, float* base,
                                              long long stride_s, int s0,
                                              int S, const Lanes& L) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sp = s0 + L.g + 8 * r;
    if (sp >= S) continue;
    float* row = base + (long long)sp * stride_s + 8 * L.t;
#pragma unroll
    for (int m = 0; m < D / 32; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)  // columns 32 m + 8 t + 4 e + c
        *reinterpret_cast<float4*>(row + 32 * m + 4 * e) = make_float4(
            x[4 * m][2 * r + e] * mul, x[4 * m + 1][2 * r + e] * mul,
            x[4 * m + 2][2 * r + e] * mul, x[4 * m + 3][2 * r + e] * mul);
  }
}

}  // namespace flash
