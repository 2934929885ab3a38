// The streaming route's tiles and products, shared by flash_fwd.cu
// (flash_fwd_stream_kernel) and flash_bwd.cu (flash_dq_stream_kernel,
// flash_dkv_stream_kernel): the head dims the other routes leave (the
// forward in bf16 from 320, the backward in bf16 and both in fp32 from
// 192, any width above 512). There a 64 x D fp32 accumulator does not fit
// in registers (D / 2 a thread), and above 512 no tile of a whole head fits
// the 227 KB of shared memory a block may take (the dK/dV kernel's four
// operands), so every operand is cut into chunk tiles
// of a few columns: 64 in bf16 (128 bytes a row, XOR-swizzled in 16-byte
// chunks for ldmatrix), 32 in fp32 (rows of 36 floats, product_nt's
// conflict-free stride). A chunk tile is filled by cp.async 16-byte
// copies, 8 a row, and feeds one of two products on the tensor cores:
//  - chunk_nt: X += A B^T over the chunk's columns, the warp's 16 rows of
//    A against N rows of B (S = Q K^T and dP = dO V^T summed over the
//    head dim, chunk by chunk);
//  - chunk_pv: X += P B, P the warp's 16 x N fp32 accumulator of an
//    earlier chunk_nt (rounded to bf16 A fragments in bf16, split into
//    three TF32 passes in fp32) and B N rows of a chunk tile: a 64- or
//    32-column slice of the output.
// bf16 on mma.sync.m16n8k16 (fp32 accumulate), fp32 on
// mma.sync.m16n8k8 TF32 in three passes (flash_tf32.cuh), so that fp32
// keeps its band. The kernels and what bounds them are in the sources.
// ops/_build.py hashes this header with both sources.

#pragma once

#include "flash_tf32.cuh"

namespace flash {

constexpr int ST_ROWS = 64;       // rows of the block's own tile: 4 warps
constexpr int ST_THREADS = 128;
constexpr int ST_STAGES = 3;      // chunk items in flight in the ring
// the largest dynamic shared memory a block may take (227 KB)
constexpr int ST_SMEM_MAX = 232448;

// columns of a chunk tile, bytes of one of its rows
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int COLS = 64, ROW = 128;
};
template <> struct Chunk<float> {
  static constexpr int COLS = 32, ROW = 4 * tf_ld<32>();
};

// byte offset of 16-byte chunk c (0..7) of row r in a chunk tile
template <typename T>
__device__ __forceinline__ uint32_t ch_off(int r, int c) {
  if constexpr (sizeof(T) == 2)
    return r * 128 + ((c ^ (r & 7)) << 4);
  else
    return r * Chunk<float>::ROW + (c << 4);
}

// rows [s0, s0 + ROWS) and columns [c0, c0 + COLS) of a [B, S, H, D] view
// (base at this (b, h), stride_s its sequence step) into a chunk tile;
// every row lies inside the sequence (S is a multiple of the tiles)
template <typename T, int ROWS>
__device__ __forceinline__ void cp_chunk(uint32_t dst, const T* base,
                                         long long stride_s, int s0, int c0,
                                         int tid) {
  constexpr int E = 16 / sizeof(T);  // elements a copy
#pragma unroll
  for (int it = 0; it < ROWS * 8 / ST_THREADS; ++it) {
    const int idx = tid + it * ST_THREADS;
    const int r = idx >> 3, c = idx & 7;
    cp_async16(dst + ch_off<T>(r, c),
               base + (long long)(s0 + r) * stride_s + c0 + c * E);
  }
}

// X += A B^T over one chunk: A the warp's 16 rows from row ar0 of chunk
// tile a, B rows [0, N) of chunk tile b
template <int N>
__device__ __forceinline__ void chunk_nt(float (&x)[N / 8][4],
                                         const unsigned char* a,
                                         const unsigned char* b, int ar0,
                                         const Lanes& L, __nv_bfloat16) {
  const uint32_t au = smem_u32(a), bu = smem_u32(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t fa[4];
    ldmatrix_x4(fa, au + ch_off<__nv_bfloat16>(ar0 + L.a_r, 2 * kk + L.a_c));
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t fb[4];
      ldmatrix_x4(fb,
                  bu + ch_off<__nv_bfloat16>(16 * nb + L.b_r, 2 * kk + L.b_c));
      mma_bf16(x[2 * nb], fa, fb[0], fb[1]);
      mma_bf16(x[2 * nb + 1], fa, fb[2], fb[3]);
    }
  }
}
template <int N>
__device__ __forceinline__ void chunk_nt(float (&x)[N / 8][4],
                                         const unsigned char* a,
                                         const unsigned char* b, int ar0,
                                         const Lanes& L, float) {
  product_nt_add<32, N, false>(x, reinterpret_cast<const float*>(a),
                               reinterpret_cast<const float*>(b), ar0, L);
}

// chunk_pv's A operand from a 16 x N fp32 accumulator: bf16 fragments of
// its k16 steps (the m16n8 accumulator is the m16n8k16 A fragment), or in
// fp32 the accumulator itself (product_acc splits it at each use)
template <typename T, int N> struct POperand {
  uint32_t a[N / 16][4];
  __device__ void set(const float (&p)[N / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    }
  }
};
template <int N> struct POperand<float, N> {
  float a[N / 8][4];
  __device__ void set(const float (&p)[N / 8][4]) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[j][e] = p[j][e];
  }
};

// the accumulator of one chunk's columns for the warp's 16 rows: bf16 64
// columns in mma's layout (n-tile j, columns 8 j + 2 t and + 1), fp32 32
// columns in product_acc's permuted one (store_chunk undoes both)
template <typename T>
using ChunkAcc = float[Chunk<T>::COLS / 8][4];

// X += P B over N keys: B rows [0, N) of chunk tile b
template <int N>
__device__ __forceinline__ void chunk_pv(
    float (&x)[8][4], const POperand<__nv_bfloat16, N>& p,
    const unsigned char* b, const Lanes& L) {
  const uint32_t bu = smem_u32(b);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int db = 0; db < 4; ++db) {
      uint32_t fb[4];
      ldmatrix_x4_trans(
          fb, bu + ch_off<__nv_bfloat16>(16 * kk + L.a_r, 2 * db + L.a_c));
      mma_bf16(x[2 * db], p.a[kk], fb[0], fb[1]);
      mma_bf16(x[2 * db + 1], p.a[kk], fb[2], fb[3]);
    }
}
template <int N>
__device__ __forceinline__ void chunk_pv(float (&x)[4][4],
                                         const POperand<float, N>& p,
                                         const unsigned char* b,
                                         const Lanes& L) {
  product_acc<32, N / 8>(x, p.a, reinterpret_cast<const float*>(b), L);
}

// the warp's 16 rows of one chunk's accumulator, row g times mul[0] and
// row g + 8 times mul[1], to sequence positions s0.. and columns c0.. of a
// [B, S, H, D] view: bf16 4 bytes a store, fp32 16
__device__ __forceinline__ void store_chunk(const float (&x)[8][4],
                                            const float (&mul)[2],
                                            __nv_bfloat16* base,
                                            long long stride_s, int s0,
                                            int c0, const Lanes& L) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* row =
        base + (long long)(s0 + L.g + 8 * r) * stride_s + c0 + 2 * L.t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(x[j][2 * r] * mul[r], x[j][2 * r + 1] * mul[r]);
  }
}
__device__ __forceinline__ void store_chunk(const float (&x)[4][4],
                                            const float (&mul)[2],
                                            float* base, long long stride_s,
                                            int s0, int c0, const Lanes& L) {
  // n-tile c holds columns 4 g + c (product_acc): a lane holds columns
  // 8 t .. 8 t + 7 of its rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = base + (long long)(s0 + L.g + 8 * r) * stride_s + c0 +
                 8 * L.t;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float4*>(row + 4 * e) =
          make_float4(x[0][2 * r + e] * mul[r], x[1][2 * r + e] * mul[r],
                      x[2][2 * r + e] * mul[r], x[3][2 * r + e] * mul[r]);
  }
}

// Whether a kernel keeps its own side's chunk tiles resident (read from L2
// once instead of once a step): where they fit beside the ring, and either
// two such blocks fit an SM (as many as the registers allow) or the grid
// has at most two blocks an SM. Otherwise the tiles are streamed with the
// rest, so that two blocks share an SM and hide each other's latency
// (tf32_variants.py stream_resident stream_streamed times both against
// this rule).
inline int sm_count() {  // the current card's SMs, 0 if unknown
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 0;
  return sms;
}

inline bool resident(long long blocks, int res_bytes) {
  constexpr int SM_SMEM = 233472, BLOCK_RESERVED = 1024;  // bytes
  return res_bytes <= ST_SMEM_MAX &&
         (2 * (res_bytes + BLOCK_RESERVED) <= SM_SMEM ||
          blocks <= 2LL * sm_count());
}

// Warpgroups a block for an output of G column groups at head dim D whose
// grid has `blocks` blocks with one group a block: 2 (design (b), two
// groups a block sharing S and dP) where G > 1 at head dims up to 512 and
// either that grid is more than one wave of the card's SMs or D is above
// 320, else 1 (design (a)). Where (a)'s grid fits one wave each of its
// blocks has an SM to itself, and at head dims up to 320 that beat
// forming S once in (b)'s half as many blocks; above 320 S is the larger
// share of a block's work. tf32_variants.py's wide_* variants time both
// designs and this rule.
inline int warpgroups(int G, int D, long long blocks) {
  return G > 1 && D <= 512 && (D > 320 || blocks > sm_count()) ? 2 : 1;
}

// The output's columns in G groups of WG (the last may be narrower), one
// grid step each: G = ceil(D / WMAX), WG = D / G rounded up to 64.
struct Groups {
  int G, WG;
};
__host__ __device__ constexpr Groups groups_of(int D, int WMAX) {
  const int G = (D + WMAX - 1) / WMAX;
  return {G, ((D + G - 1) / G + 63) / 64 * 64};
}

// The barrier of the threads that share a ring: with one warpgroup a
// block the block's, else the warpgroup's own named one (1 + its index,
// ST_THREADS threads)
template <int WGS>
__device__ __forceinline__ void group_sync() {
  if constexpr (WGS == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + threadIdx.x / ST_THREADS),
                 "n"(ST_THREADS)
                 : "memory");
}

// A ring of ST_STAGES chunk items of `stage` bytes each, filled by
// cp.async in the order its threads (the block, or with WGS warpgroups a
// block one of them, behind group_sync) consume them. issue(i) copies item i into its slot
// (nothing past the last item) and commits one group; next() waits until
// the oldest outstanding item has landed and every thread is done with the
// slot before it, refills that slot with the item ST_STAGES - 1 ahead and
// returns the landed item's slot. Every thread behind the barrier calls
// next() the same number of times.
template <int WGS, typename Issue>
struct Ring {
  unsigned char* base;
  int stage;
  Issue issue;
  int cur = 0, slot = 0;
  __device__ Ring(unsigned char* b, int st, Issue is)
      : base(b), stage(st), issue(is) {}
  __device__ void start() {
#pragma unroll
    for (int i = 0; i < ST_STAGES - 1; ++i)
      issue(i, base + i * stage);
  }
  __device__ const unsigned char* next() {
    cp_async_wait<ST_STAGES - 2>();
    group_sync<WGS>();
    const int refill = slot == 0 ? ST_STAGES - 1 : slot - 1;
    issue(cur + ST_STAGES - 1, base + refill * stage);
    const unsigned char* here = base + slot * stage;
    ++cur;
    slot = slot == ST_STAGES - 1 ? 0 : slot + 1;
    return here;
  }
};

// Design (b), column groups in one block: WGS warpgroups of ST_THREADS
// threads own WGS consecutive column groups of the output, and warpgroup w
// forms the partial products of S (and dP) over its share of the head
// dim's chunk tiles, `Split`. Summed through shared memory in warpgroup
// order they give every warpgroup the same S, bit for bit, so the block
// forms S once where WGS grid steps would form it WGS times.
template <int WGS>
struct Split {
  int c0, n;  // the warpgroup's first chunk of the head dim and its count
  __device__ Split(int nD, int wg) {
    if constexpr (WGS == 1) {
      c0 = 0;
      n = nD;
    } else {
      const int per = (nD + WGS - 1) / WGS;
      c0 = min(nD, wg * per);
      n = min(nD, c0 + per) - c0;
    }
  }
};

// v = the sum over the block's WGS warpgroups of their v, in warpgroup
// order, through x ([WGS][N][ST_THREADS] floats: a thread's N values
// ST_THREADS apart, so a warp's stores and loads hit 32 banks); `lt` the
// thread's index in its warpgroup. Every thread of the block calls it.
template <int WGS, int N>
__device__ __forceinline__ void exchange_sum(float* x, float* v, int wg,
                                             int lt) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[(wg * N + i) * ST_THREADS + lt] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float sum = x[i * ST_THREADS + lt];
#pragma unroll
    for (int w = 1; w < WGS; ++w) sum += x[(w * N + i) * ST_THREADS + lt];
    v[i] = sum;
  }
  __syncthreads();  // every warpgroup has read x before the next write
}

// bytes of exchange_sum's x for N floats a thread (none for one warpgroup)
template <int WGS>
__host__ __device__ constexpr int exchange_bytes(int n) {
  return WGS > 1 ? WGS * n * ST_THREADS * 4 : 0;
}

}  // namespace flash
