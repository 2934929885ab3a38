// Flash-attention backward for Hopper (sm_90a), with a plain C interface
// for ctypes (built by paddle_tpu_torch/ops/_build.py).
//
// Replaces: paddle_tpu/ops/flash_attention.py `_dq_kernel` (:282) and
// `_dkv_kernel` (:319), the two Pallas TPU kernels that `_flash_bwd`
// launches. Same function, fp32 math whatever the input type:
//   S  = (Q * scale) K^T, masked with the forward's rule (keep k <= q, and
//        q - k < window), P = exp(S - lse) from the forward's logsumexp,
//   dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(dO o O)
//        (`flash_delta_kernel`, a pre-pass, unless the caller passes it),
//   dQ = scale * dS K,  dK = dS^T (Q * scale),  dV = P^T dO,
// each written once in the input type.
//
// Block structure. The TPU kernels walk a sequential grid and carry their
// accumulators in VMEM across its innermost axis. Thread blocks on the card
// run in no order, so each block owns one output tile and loops itself:
// the dQ kernels one block per (b*h, query tile), walking the kv tiles the
// tile can see; the dK/dV kernels one block per (b*h, kv tile), walking the
// query tiles that can see it. Every block writes only its own tile, so
// there are no atomics and two calls give the same bits. The price: S and
// dP are computed in both kernels (14 d FLOPs a visible (q, k) pair against
// 10 d for one fused pass). Tiles wholly above the diagonal or outside the
// window are never loaded; the tiles that straddle the diagonal or the
// window's edge are masked per element, so a window that is no multiple of
// the tile (e.g. 100) gives the reference's result.
//
// What bounds it: per visited (q, k) pair, dQ does 6 d FLOPs (S, dP and
// dS K) and dK/dV 8 d (S, dP, P^T dO and dS^T Q), against q, k, v and dO
// read once, lse and delta read once and the outputs written once. At GPT-2
// small's training shapes (b16 h12 s1024 d64, causal, bf16) that is 38.7
// GFLOP / 127 MB for dQ and 51.6 GFLOP / 153 MB for dK/dV: the tensor
// cores bind both (39 and 52 us at 989 TFLOP/s).
//
// bf16 at head_dim 64 and 128 (`flash_dq_mma_kernel`,
// `flash_dkv_mma_kernel`): the forward's design (flash_fwd.cu) carried
// over. A block owns a 128-row tile of one (b, h); a warp owns 32 of its
// rows at head_dim 64 (two 16-row blocks that share every B fragment read
// from shared memory: half the ldmatrix traffic a FLOP of 16-row warps,
// which bounded the first version) and 16 at 128, where the accumulators
// of 32 rows would not fit in 255 registers. The tiles the block walks are
// double-buffered in shared memory by cp.async 16-byte copies into
// XOR-swizzled rows, the next tile in flight while this one computes.
// Every product is mma.sync.m16n8k16, bf16 in and fp32 accumulate; the
// exponent folds scale and log2(e) into the SFU's exp2.
//  - dK/dV: the block's K and V stay resident; it walks 32-row query
//    tiles. A warp computes S^T = K Q^T and dP^T = V dO^T (Q and dO through
//    ldmatrix), then P^T and dS^T in fp32 registers, with lse and delta of
//    the tile's columns from shared memory. P^T and dS^T rounded to bf16
//    are the A operands of dV += P^T dO and dK += dS^T Q directly (the
//    m16n8 accumulator fragment is the m16n8k16 A fragment), dO and Q read
//    through ldmatrix.trans. dK and dV stay in fp32 registers for the walk;
//    kv tile 0, which every causal query tile sees, launches first.
//  - dQ: the block's Q and dO stay resident, lse and delta in registers;
//    it walks kv tiles of 32 rows (64 at head_dim 128). S = Q K^T,
//    dP = dO V^T, dS in registers, then dQ += dS K with dS in bf16 as the
//    A operand and K through ldmatrix.trans; dQ is fp32 in registers, times
//    scale once at the end. The last causal tile (the heaviest) launches
//    first.
// Each warp stages its finished rows in its own rows of the resident tiles
// (no other warp reads them) and stores them as 16-byte chunks. At head_dim
// 192 the dK and dV accumulators of 16 rows alone would take 192 of a
// thread's 255 registers (ptxas spills), so the tensor-core kernels stop
// at 128.
//
// fp32 at head_dim 64 and 128 (`flash_dq_tf32_kernel`,
// `flash_dkv_tf32_kernel`, route 4): the bf16 pair's block structure on the
// TF32 tensor cores (mma.sync.m16n8k8; 494.7 dense TFLOP/s against 67 for
// fp32 FMAs). One TF32 product keeps 10 of an operand's 23 mantissa bits:
// with one pass the pair's dQ, dK and dV landed 2.9e-4 to 7.8e-4 x max(1,
// max|plain|) off the plain backward on an H100 (b4, s 1024 and 1088, d 64
// and 128, full, causal, windows 100 and 17; randn inputs;
// tf32_variants.py), 1.4-3.9x outside the fp32 band of 2e-4. So every
// product is formed in three passes: x = big + small, big = tf32(x), small
// = tf32(x - big), and A B = small(A) big(B) + big(A) small(B) + big(A)
// big(B) in that order into one fp32 accumulator (mma_tf32x3). The dropped
// small(A) small(B) and the split's rest are below 2^-22 of |A| |B|; on the
// same inputs the three passes land at most 2.0e-5 off the plain backward,
// and no nearer to an fp64 one, 10x inside the band. They triple the
// tensor-core work: the pair's bound is 3 x 90.3 GFLOP over 494.7 TFLOP/s,
// 0.548 ms at b16. A block owns a tile of 64 rows at head_dim 64 and 128 at
// 128 (warps of 16 rows) and walks 32-row kv tiles (dQ) or 32- / 16-row
// query tiles (dK/dV), double-buffered by cp.async 16-byte copies into rows
// of D + 4 floats. Fragments load 16 bytes a lane with no bank conflict:
// both kinds of product permute their k index (product_nt, product_acc:
// flash_tf32.cuh, shared with the fp32 forward), so
// the m16n8 accumulator of P or dS is the A fragment of the next product as
// it stands, and the operands read transposed (K in dS K, Q in dS^T Q, dO
// in P^T dO) come 16 bytes a lane too. Operands are split at every use, in
// registers (four instructions an element, tf32_rna and split_tf32):
// splitting them once, into big and small tiles, would double every
// fragment's shared-memory loads instead. A view whose pointer or (b, s, h)
// step is not 16-byte aligned takes the scalar kernels, chosen before any
// launch (route 2).
//
// bf16 from head_dim 192, and fp32 where the TF32 route does not take the
// views or the head dim (`flash_dq_kernel`, `flash_dkv_kernel`): scalar
// fp32 FMAs out of shared memory, the tiles staged in fp32, a 256-thread
// 16 x 16 grid. Tiles of 64 rows at head_dim 64 and 128, 32 at 192 and 256,
// 16 from 320 to 512 (the dK/dV kernel's K, V, Q and dO tiles take 133.6 KB
// at 512).
//
// Above head_dim 512, fp32 and bf16 (`flash_dq_stream_kernel`,
// `flash_dkv_stream_kernel`, the streaming route; flash_stream.cuh): the
// streaming forward's plan (flash_fwd.cu). Each output's columns split
// into groups, a grid step each: dQ's of at most 256 (bf16) or 192 (fp32)
// columns, dK and dV's of 128 (both accumulators live in registers). A dQ
// block owns (b*h, group, 64-row query tile) and walks 32-row kv tiles; a
// dK/dV block owns (b*h, group, 64-row kv tile) and walks 32-row (bf16) or
// 16-row (fp32, whose TF32 split operands spill at 32) query tiles. Each
// forms S and dP over the whole head once per tile it visits, from chunk
// tiles that the cp.async ring streams (in bf16 its own side's resident
// where `resident` finds room; fp32's never fit), then P and dS on the
// accumulators and its group's products, all on the tensor cores; every
// block writes only its own tile, no atomics. What bounds it: both kernels form S and dP once per
// group, (4 G_dq + 2) d + (4 G_dkv + 4) d FLOPs a visible pair against the
// function's 10 d (38 d at 576), and fp32 triples them (three TF32
// passes). Views must be 16-byte aligned; lse and delta are read an
// element at a time.
//
// delta pre-pass (`flash_delta_kernel`): rowsum(dO o O) in fp32, 8 lanes a
// row, 16-byte loads where the views allow them; the sum's order is fixed.
//
// Layout: q, k, v, o, dO and the outputs are [B, S, H, D] views with any
// element strides over (b, s, h) and a contiguous d (16-byte-aligned
// pointers and strides for the tensor-core kernels: the GPT path's q, k and
// v are slices of one packed qkv, read without a copy); lse and delta are
// contiguous [B * H, S] fp32 arrays; seq a multiple of 64.

#include "flash_stream.cuh"

namespace {

using namespace flash;

constexpr int NT = 256;  // threads per block

// ---- fp32, and bf16 from head_dim 192: scalar FMAs ------------------------

// Rows of a query tile and of a kv tile for head_dim D.
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D <= 128 ? 64 : D <= 256 ? 32 : 16;
}

// dQ: Q, dO, K, V tiles [BR, D + 1], dS [BR, BR + 1], lse and delta [BR].
template <int D>
constexpr int dq_smem_floats() {
  return 4 * tile_rows<D>() * (D + 1)
         + tile_rows<D>() * (tile_rows<D>() + 1) + 2 * tile_rows<D>();
}

// dK/dV: K, V, Q, dO tiles [BR, D + 1], P and dS [BR, BR + 1], lse, delta.
template <int D>
constexpr int dkv_smem_floats() {
  return 4 * tile_rows<D>() * (D + 1)
         + 2 * tile_rows<D>() * (tile_rows<D>() + 1) + 2 * tile_rows<D>();
}

// dst[r][c] = src row (r0 + r), column c, times mul: a [BR, D] tile of a
// strided view into shared memory with row stride D + 1.
template <typename T, int D, int BR>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           long long row_stride, int r0,
                                           float mul) {
  for (int idx = threadIdx.x; idx < BR * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] = to_f(src[(long long)(r0 + r) * row_stride + c]) * mul;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two [BR, D + 1]
// tiles: one thread's R x R slice of A B^T.
template <int D, int BR>
__device__ __forceinline__ void tile_dot(const float* A, const float* B,
                                         float (&acc)[BR / 16][BR / 16],
                                         int ty, int tx) {
  constexpr int R = BR / 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int S, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdq, int causal, float scale,
                    int window) {
  constexpr int BR = tile_rows<D>();
  constexpr int R = BR / 16, DJ = D / 16, LD = D + 1, LS = BR + 1;
  extern __shared__ float smem[];
  float* Qs = smem;            // Q tile * scale
  float* dOs = Qs + BR * LD;
  float* Ks = dOs + BR * LD;
  float* Vs = Ks + BR * LD;
  float* dSs = Vs + BR * LD;   // dS for the current kv tile
  float* lse_s = dSs + BR * LS;
  float* dl_s = lse_s + BR;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int bh, qt;
  bh_tile(true, bh, qt);  // the heaviest causal tile first
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BR;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  stage_tile<T, D, BR>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, scale);
  stage_tile<T, D, BR>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, 1.f);
  if (tid < BR) {
    lse_s[tid] = lse[(long long)bh * S + q0 + tid];
    dl_s[tid] = delta[(long long)bh * S + q0 + tid];
  }

  // kv tiles with any visible key for some row of this query tile
  int kt_begin = 0, kt_end = S / BR;
  if (causal) {
    kt_end = (q0 + BR - 1) / BR + 1;
    if (window > 0) {
      const int first_key = q0 - (window - 1);
      kt_begin = first_key > 0 ? first_key / BR : 0;
    }
  }

  float acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/dSs
    stage_tile<T, D, BR>(Ks, kb, sk.s, k0, 1.f);
    stage_tile<T, D, BR>(Vs, vb, sv.s, k0, 1.f);
    __syncthreads();

    float s[R][R], dp[R][R];
    tile_dot<D, BR>(Qs, Ks, s, ty, tx);
    tile_dot<D, BR>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, causal, window)
                            ? expf(s[i][j] - lse_s[r])
                            : 0.f;
        dSs[r * LS + c] = p * (dp[i][j] - dl_s[r]);
      }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < BR; ++c) {
      float ds[R], kk[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T* row = dqb + (long long)(q0 + ty + 16 * i) * sdq.s;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, Strides sq, Strides sk,
                     Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     int causal, float scale, int window) {
  constexpr int BR = tile_rows<D>();
  constexpr int R = BR / 16, DJ = D / 16, LD = D + 1, LS = BR + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BR * LD;
  float* Qs = Vs + BR * LD;    // Q tile * scale
  float* dOs = Qs + BR * LD;
  float* Ps = dOs + BR * LD;   // P for the current query tile
  float* dSs = Ps + BR * LS;   // dS for the current query tile
  float* lse_s = dSs + BR * LS;
  float* dl_s = lse_s + BR;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  int bh, kt;
  bh_tile(false, bh, kt);  // kv tile 0, the heaviest, first
  const int b = bh / H, h = bh % H;
  const int k0 = kt * BR;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;

  stage_tile<T, D, BR>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, 1.f);
  stage_tile<T, D, BR>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, 1.f);

  // query tiles with any row that sees some key of this kv tile
  int qt_begin = 0, qt_end = S / BR;
  if (causal) {
    qt_begin = k0 / BR;
    if (window > 0) {
      // the last query that sees the tile's last key
      const long long last_q = (long long)k0 + BR - 1 + window - 1;
      const long long e = last_q / BR + 1;
      if (e < qt_end) qt_end = (int)e;
    }
  }

  float dka[R][DJ], dva[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dka[i][j] = 0.f;
      dva[i][j] = 0.f;
    }

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BR;
    __syncthreads();  // the previous tile's readers are done with Qs..dl_s
    stage_tile<T, D, BR>(Qs, qb, sq.s, q0, scale);
    stage_tile<T, D, BR>(dOs, dob, sdo.s, q0, 1.f);
    if (tid < BR) {
      lse_s[tid] = lse[(long long)bh * S + q0 + tid];
      dl_s[tid] = delta[(long long)bh * S + q0 + tid];
    }
    __syncthreads();

    // rows: queries ty + 16 i; columns: keys tx + 16 j
    float s[R][R], dp[R][R];
    tile_dot<D, BR>(Qs, Ks, s, ty, tx);
    tile_dot<D, BR>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, causal, window)
                            ? expf(s[i][j] - lse_s[r])
                            : 0.f;
        Ps[r * LS + c] = p;
        dSs[r * LS + c] = p * (dp[i][j] - dl_s[r]);
      }
    __syncthreads();

    // this thread's keys ty + 16 i, head-dim columns tx + 16 j:
    // dV += P^T dO, dK += dS^T (Q * scale)
#pragma unroll 4
    for (int r = 0; r < BR; ++r) {
      float pp[R], dd[R], oo[DJ], qq[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pp[i] = Ps[r * LS + ty + 16 * i];
        dd[i] = dSs[r * LS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        oo[j] = dOs[r * LD + tx + 16 * j];
        qq[j] = Qs[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dva[i][j] = fmaf(pp[i], oo[j], dva[i][j]);
          dka[i][j] = fmaf(dd[i], qq[j], dka[i][j]);
        }
    }
  }

  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = k0 + ty + 16 * i;
    T* krow = dkb + (long long)r * sdk.s;
    T* vrow = dvb + (long long)r * sdv.s;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      krow[tx + 16 * j] = from_f<T>(dka[i][j]);
      vrow[tx + 16 * j] = from_f<T>(dva[i][j]);
    }
  }
}

// ---- head_dim above 512: the streaming route ------------------------------

// the widest column group of dQ, and of dK and dV together, a block owns
// (fp32 accumulators: dQ WMAX / 2 registers a thread, dK and dV WMAX
// between them), and the other side's rows a step (S and dP of a step take
// BO / 4 registers each; the fp32 dK/dV kernel, whose TF32 split operands
// need more, spills at 32)
template <typename T> __host__ __device__ constexpr int dq_st_wmax() {
  return sizeof(T) == 2 ? 256 : 192;
}
constexpr int DKV_ST_WMAX = 128;
constexpr int DQ_ST_BO = 32;
template <typename T> __host__ __device__ constexpr int dkv_st_bo() {
  return sizeof(T) == 2 ? 32 : 16;
}

// bytes of a block's shared memory, both kernels: with RES the own side's
// two operands stay resident (nD chunk tiles each) and a ring stage holds
// the other side's two chunks of BO rows; without, a stage holds all four
template <typename T, bool RES, int BO>
__host__ __device__ constexpr int bwd_st_smem(int D) {
  constexpr int OWN = ST_ROWS * Chunk<T>::ROW, OTH = BO * Chunk<T>::ROW;
  return RES ? D / Chunk<T>::COLS * 2 * OWN + ST_STAGES * 2 * OTH
             : ST_STAGES * 2 * (OTH + OWN);
}

// dQ[:, group] = scale * sum over the kv tiles of dS K[:, group]: one block
// a (b*h, column group, 64-row query tile), 4 warps of 16 rows. For each
// 32-row kv tile the block forms S = Q K^T and dP = dO V^T over the whole
// head dim, one chunk tile of each at a time (chunk_nt), then P = exp(S *
// scale - lse) and dS = P o (dP - delta) on the accumulators, then dQ[:,
// group] += dS K[:, group] one chunk of K at a time (chunk_pv).
template <typename T, bool RES>
__global__ void __launch_bounds__(ST_THREADS)
    flash_dq_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, T* __restrict__ dq,
                           int H, int S, int D, int G, int WG, Strides sq,
                           Strides sk, Strides sv, Strides sdo, Strides sdq,
                           int causal, float scale, int window) {
  constexpr int DC = Chunk<T>::COLS, BO = DQ_ST_BO, W = dq_st_wmax<T>();
  constexpr int OWN = ST_ROWS * Chunk<T>::ROW, OTH = BO * Chunk<T>::ROW;
  constexpr int STAGE = 2 * OTH + (RES ? 0 : 2 * OWN);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nD = D / DC;
  // RES: chunk c's Q tile at c * 2 OWN, its dO tile OWN further
  unsigned char* const own_res = smem_raw;
  unsigned char* const ring_base = smem_raw + (RES ? nD * 2 * OWN : 0);

  const int tid = threadIdx.x, warp = tid >> 5;
  const Lanes L(tid & 31);
  const int bh = blockIdx.x / G, g = blockIdx.x % G;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ST_ROWS;  // heaviest first
  const int c0 = g * WG, nW = min(WG, D - c0) / DC;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;

  // kv tiles with any visible key for some row of this query tile
  int kt_begin = 0, kt_end = S / BO;
  if (causal) {
    kt_end = (q0 + ST_ROWS - 1) / BO + 1;
    if (window > 0) {
      const int first_key = q0 - (window - 1);
      kt_begin = first_key > 0 ? first_key / BO : 0;
    }
  }
  // a kv tile's items: nD chunks of K and V (and Q and dO) for S and dP,
  // then nW chunks of K for dS K
  const int per = nD + nW, total = (kt_end - kt_begin) * per;
  auto issue = [&](int i, unsigned char* dst) {
    if (i < total) {
      const int kt = kt_begin + i / per, j = i % per;
      const uint32_t du = smem_u32(dst);
      if (j < nD) {
        cp_chunk<T, BO>(du, kb, sk.s, kt * BO, j * DC, tid);
        cp_chunk<T, BO>(du + OTH, vb, sv.s, kt * BO, j * DC, tid);
        if constexpr (!RES) {
          cp_chunk<T, ST_ROWS>(du + 2 * OTH, qb, sq.s, q0, j * DC, tid);
          cp_chunk<T, ST_ROWS>(du + 2 * OTH + OWN, dob, sdo.s, q0, j * DC,
                               tid);
        }
      } else {
        cp_chunk<T, BO>(du, kb, sk.s, kt * BO, c0 + (j - nD) * DC, tid);
      }
    }
    cp_async_commit();
  };
  if constexpr (RES)  // lands with the ring's first item
    for (int c = 0; c < nD; ++c) {
      const uint32_t du = smem_u32(own_res + c * 2 * OWN);
      cp_chunk<T, ST_ROWS>(du, qb, sq.s, q0, c * DC, tid);
      cp_chunk<T, ST_ROWS>(du + OWN, dob, sdo.s, q0, c * DC, tid);
    }
  Ring ring(ring_base, STAGE, issue);
  ring.start();

  const int wr0 = 16 * warp, wq0 = q0 + wr0;
  const float sl2 = scale * LOG2E;
  // -lse * log2(e) and delta of the thread's rows g and g + 8
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = (long long)bh * S + wq0 + L.g + 8 * r;
    nl[r] = -lse[row] * LOG2E;
    dl[r] = delta[row];
  }
  ChunkAcc<T> acc[W / DC];
#pragma unroll
  for (int cw = 0; cw < W / DC; ++cw)
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cw][j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BO;
    // a tile this warp's rows see nothing of: the ring still turns
    const bool skip = (causal && k0 > wq0 + 15) ||
                      (window > 0 && k0 + BO - 1 < wq0 - window + 1);
    float sc[BO / 8][4], dp[BO / 8][4];
#pragma unroll
    for (int j = 0; j < BO / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    for (int c = 0; c < nD; ++c) {
      const unsigned char* st = ring.next();
      if (!skip) {
        const unsigned char* own = RES ? own_res + c * 2 * OWN : st + 2 * OTH;
        chunk_nt<BO>(sc, own, st, wr0, L, T{});
        chunk_nt<BO>(dp, own + OWN, st + OTH, wr0, L, T{});
      }
    }
    // dS = P o (dP - delta), P masked where the diagonal or the window's
    // edge crosses the warp's rows
    POperand<T, BO> ds;
    if (!skip) {
      const bool edge = causal && (k0 + BO - 1 > wq0 ||
                                   (window > 0 && k0 < wq0 + 15 - window + 1));
#pragma unroll
      for (int j = 0; j < BO / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2_approx(fmaf(sc[j][e], sl2, nl[r]));
          if (edge && !visible(wq0 + L.g + 8 * r,
                               k0 + 8 * j + 2 * L.t + (e & 1), causal,
                               window))
            p = 0.f;
          sc[j][e] = p * (dp[j][e] - dl[r]);
        }
      ds.set(sc);
    }
    // dQ[:, group] += dS K[:, group], a chunk of K's columns at a time
#pragma unroll
    for (int cw = 0; cw < W / DC; ++cw)
      if (cw < nW) {
        const unsigned char* st = ring.next();
        if (!skip) chunk_pv<BO>(acc[cw], ds, st, L);
      }
  }
  cp_async_wait<0>();  // no copy in flight when the block ends

  const float mul[2] = {scale, scale};
  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int cw = 0; cw < W / DC; ++cw)
    if (cw < nW) store_chunk(acc[cw], mul, dqb, sdq.s, wq0, c0 + cw * DC, L);
}

// dK[:, group] = scale * sum over the query tiles of dS^T Q[:, group] and
// dV[:, group] = sum of P^T dO[:, group]: one block a (b*h, column group,
// 64-row kv tile), 4 warps of 16 keys. For each BO-row query tile the block
// forms S^T = K Q^T and dP^T = V dO^T over the whole head dim, one chunk
// tile of each at a time, then P^T and dS^T, then dV and dK over the
// group's columns, a chunk of dO and of Q at a time.
template <typename T, bool RES>
__global__ void __launch_bounds__(ST_THREADS)
    flash_dkv_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int H,
                            int S, int D, int G, int WG, Strides sq,
                            Strides sk, Strides sv, Strides sdo, Strides sdk,
                            Strides sdv, int causal, float scale,
                            int window) {
  constexpr int DC = Chunk<T>::COLS, BO = dkv_st_bo<T>(), W = DKV_ST_WMAX;
  constexpr int OWN = ST_ROWS * Chunk<T>::ROW, OTH = BO * Chunk<T>::ROW;
  constexpr int STAGE = 2 * OTH + (RES ? 0 : 2 * OWN);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nD = D / DC;
  // RES: chunk c's K tile at c * 2 OWN, its V tile OWN further
  unsigned char* const own_res = smem_raw;
  unsigned char* const ring_base = smem_raw + (RES ? nD * 2 * OWN : 0);

  const int tid = threadIdx.x, warp = tid >> 5;
  const Lanes L(tid & 31);
  const int bh = blockIdx.x / G, g = blockIdx.x % G;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * ST_ROWS;  // kv tile 0 (the heaviest) first
  const int c0 = g * WG, nW = min(WG, D - c0) / DC;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (long long)bh * S;
  const float* dl_b = delta + (long long)bh * S;

  // query tiles with any row that sees some key of this kv tile
  int qt_begin = 0, qt_end = S / BO;
  if (causal) {
    qt_begin = k0 / BO;
    if (window > 0) {
      const long long e = ((long long)k0 + ST_ROWS - 1 + window - 1) / BO + 1;
      if (e < qt_end) qt_end = (int)e;
    }
  }
  // a query tile's items: nD chunks of Q and dO (and K and V) for S^T and
  // dP^T, then nW chunks of Q and dO for dK and dV
  const int per = nD + nW, total = (qt_end - qt_begin) * per;
  auto issue = [&](int i, unsigned char* dst) {
    if (i < total) {
      const int qt = qt_begin + i / per, j = i % per;
      const int col = j < nD ? j * DC : c0 + (j - nD) * DC;
      const uint32_t du = smem_u32(dst);
      cp_chunk<T, BO>(du, qb, sq.s, qt * BO, col, tid);
      cp_chunk<T, BO>(du + OTH, dob, sdo.s, qt * BO, col, tid);
      if constexpr (!RES)
        if (j < nD) {
          cp_chunk<T, ST_ROWS>(du + 2 * OTH, kb, sk.s, k0, col, tid);
          cp_chunk<T, ST_ROWS>(du + 2 * OTH + OWN, vb, sv.s, k0, col, tid);
        }
    }
    cp_async_commit();
  };
  if constexpr (RES)  // lands with the ring's first item
    for (int c = 0; c < nD; ++c) {
      const uint32_t du = smem_u32(own_res + c * 2 * OWN);
      cp_chunk<T, ST_ROWS>(du, kb, sk.s, k0, c * DC, tid);
      cp_chunk<T, ST_ROWS>(du + OWN, vb, sv.s, k0, c * DC, tid);
    }
  Ring ring(ring_base, STAGE, issue);
  ring.start();

  const int wr0 = 16 * warp, wk0 = k0 + wr0;
  const float sl2 = scale * LOG2E;
  // the warp's keys' rows of dK (unscaled) and dV over the group
  ChunkAcc<T> dka[W / DC], dva[W / DC];
#pragma unroll
  for (int cw = 0; cw < W / DC; ++cw)
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[cw][j][e] = dva[cw][j][e] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * BO;
    // a tile no row of this warp's keys is seen by: the ring still turns
    const bool skip = (causal && q0 + BO - 1 < wk0) ||
                      (window > 0 && q0 > wk0 + 15 + window - 1);
    // S^T and dP^T: rows the warp's keys, columns the tile's queries
    float st_[BO / 8][4], dpt[BO / 8][4];
#pragma unroll
    for (int j = 0; j < BO / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st_[j][e] = dpt[j][e] = 0.f;
    for (int c = 0; c < nD; ++c) {
      const unsigned char* st = ring.next();
      if (!skip) {
        const unsigned char* own = RES ? own_res + c * 2 * OWN : st + 2 * OTH;
        chunk_nt<BO>(st_, own, st, wr0, L, T{});
        chunk_nt<BO>(dpt, own + OWN, st + OTH, wr0, L, T{});
      }
    }
    // P^T and dS^T = P^T o (dP^T - delta), masked where the diagonal or the
    // window's edge crosses the warp's keys
    POperand<T, BO> pt, dst;
    if (!skip) {
      const bool edge =
          causal && (q0 < wk0 + 15 ||
                     (window > 0 && q0 + BO - 1 - wk0 >= window));
#pragma unroll
      for (int j = 0; j < BO / 8; ++j) {
        const int c = q0 + 8 * j + 2 * L.t;  // this thread's two queries
        const float nl[2] = {-lse_b[c] * LOG2E, -lse_b[c + 1] * LOG2E};
        const float dl[2] = {dl_b[c], dl_b[c + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(st_[j][e], sl2, nl[e & 1]));
          if (edge && !visible(c + (e & 1), wk0 + L.g + 8 * (e >> 1), causal,
                               window))
            p = 0.f;
          st_[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl[e & 1]);
        }
      }
      pt.set(st_);
      dst.set(dpt);
    }
    // dV[:, group] += P^T dO[:, group], dK[:, group] += dS^T Q[:, group]
#pragma unroll
    for (int cw = 0; cw < W / DC; ++cw)
      if (cw < nW) {
        const unsigned char* st = ring.next();
        if (!skip) {
          chunk_pv<BO>(dva[cw], pt, st + OTH, L);
          chunk_pv<BO>(dka[cw], dst, st, L);
        }
      }
  }
  cp_async_wait<0>();  // no copy in flight when the block ends

  const float kmul[2] = {scale, scale}, vmul[2] = {1.f, 1.f};
  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int cw = 0; cw < W / DC; ++cw)
    if (cw < nW) {
      store_chunk(dka[cw], kmul, dkb, sdk.s, wk0, c0 + cw * DC, L);
      store_chunk(dva[cw], vmul, dvb, sdv.s, wk0, c0 + cw * DC, L);
    }
}

// ---- bf16 at head_dim 64 and 128: the tensor cores ------------------------

constexpr int MMA_TILE = 128;  // rows of the tile a block owns

// MB 16-row blocks a warp (two at head_dim 64: every B fragment read from
// shared memory serves 32 rows, half the ldmatrix traffic a FLOP; one at
// 128, where the dK and dV accumulators of 32 rows would not fit in 255
// registers): MMA_TILE / (16 MB) warps a block
template <int D> __host__ __device__ constexpr int mma_mb() {
  return D == 64 ? 2 : 1;
}
template <int D> __host__ __device__ constexpr int mma_threads() {
  return 32 * MMA_TILE / (16 * mma_mb<D>());
}
// the other side's rows a step: query rows in dK/dV, kv rows in dQ (S and
// dP of a step take MB * rows / 2 registers each)
constexpr int DKV_BQ = 32;
template <int D> __host__ __device__ constexpr int dq_bkv() {
  return D == 64 ? 32 : 64;
}

// the m16n8k16 A fragment of columns [16 kk, 16 kk + 16) of a 16-row fp32
// accumulator (n-tiles 2 kk and 2 kk + 1), rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&c)[N][4], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// X = A B^T and Y = C E^T over D: A and C the warp's MB 16-row blocks of
// swizzled [rows][D] tiles from row ar0, B and E rows [0, N) of two more
// ([n][k] fragments, each serving the MB blocks). N / 8 accumulator
// fragments a block.
template <int D, int N, int MB>
__device__ __forceinline__ void two_products(float (&x)[MB][N / 8][4],
                                             float (&y)[MB][N / 8][4],
                                             uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t e, int ar0,
                                             const Lanes& L) {
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) x[i][j][r] = y[i][j][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[MB][4], fc[MB][4];
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      ldmatrix_x4(fa[i], a + swz<D>(ar0 + 16 * i + L.a_r, 2 * kk + L.a_c));
      ldmatrix_x4(fc[i], c + swz<D>(ar0 + 16 * i + L.a_r, 2 * kk + L.a_c));
    }
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t fb[4], fe[4];
      ldmatrix_x4(fb, b + swz<D>(16 * nb + L.b_r, 2 * kk + L.b_c));
      ldmatrix_x4(fe, e + swz<D>(16 * nb + L.b_r, 2 * kk + L.b_c));
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        mma_bf16(x[i][2 * nb], fa[i], fb[0], fb[1]);
        mma_bf16(x[i][2 * nb + 1], fa[i], fb[2], fb[3]);
        mma_bf16(y[i][2 * nb], fc[i], fe[0], fe[1]);
        mma_bf16(y[i][2 * nb + 1], fc[i], fe[2], fe[3]);
      }
    }
  }
}

// X += A B and Y += C E over K = 16 KS: A and C fp32 accumulators of the
// warp's MB blocks (rounded to bf16: the A fragments), B and E rows [0, K)
// of swizzled [k][D] tiles through ldmatrix.trans
template <int D, int KS, int MB>
__device__ __forceinline__ void two_products_t(float (&x)[MB][D / 8][4],
                                               float (&y)[MB][D / 8][4],
                                               const float (&a)[MB][2 * KS][4],
                                               const float (&c)[MB][2 * KS][4],
                                               uint32_t b, uint32_t e,
                                               const Lanes& L) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t fa[MB][4], fc[MB][4];
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      acc_to_a(a[i], kk, fa[i]);
      acc_to_a(c[i], kk, fc[i]);
    }
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      uint32_t fb[4], fe[4];
      ldmatrix_x4_trans(fb, b + swz<D>(16 * kk + L.a_r, 2 * db + L.a_c));
      ldmatrix_x4_trans(fe, e + swz<D>(16 * kk + L.a_r, 2 * db + L.a_c));
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        mma_bf16(x[i][2 * db], fa[i], fb[0], fb[1]);
        mma_bf16(x[i][2 * db + 1], fa[i], fb[2], fb[3]);
        mma_bf16(y[i][2 * db], fc[i], fe[0], fe[1]);
        mma_bf16(y[i][2 * db + 1], fc[i], fe[2], fe[3]);
      }
    }
  }
}

// X += A B over K = 16 KS as two_products_t, for one product
template <int D, int KS, int MB>
__device__ __forceinline__ void product_t(float (&x)[MB][D / 8][4],
                                          const float (&a)[MB][2 * KS][4],
                                          uint32_t b, const Lanes& L) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t fa[MB][4];
#pragma unroll
    for (int i = 0; i < MB; ++i) acc_to_a(a[i], kk, fa[i]);
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, b + swz<D>(16 * kk + L.a_r, 2 * db + L.a_c));
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        mma_bf16(x[i][2 * db], fa[i], fb[0], fb[1]);
        mma_bf16(x[i][2 * db + 1], fa[i], fb[2], fb[3]);
      }
    }
  }
}

// rows [0, 16) of a warp's swizzled bf16 tile (staged at row r0 of the
// tile) to sequence positions s0.. of a [B, S, H, D] view, 16 bytes a
// store, a row's chunks contiguous; rows at or past S are not written
template <int D>
__device__ __forceinline__ void store_rows16(__nv_bfloat16* base,
                                             long long stride_s, int s0,
                                             int S,
                                             const unsigned char* tile,
                                             int r0, int lane) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    if (s0 + r < S)
      *reinterpret_cast<uint4*>(base + (s0 + r) * stride_s + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(r0 + r, c));
  }
}

// the warp's MB 16-row blocks of fp32 accumulators, times mul, in bf16 into
// its own rows (from row r0) of a swizzled tile, then to sequence
// positions s0.. of a [B, S, H, D] view
template <int D, int MB>
__device__ __forceinline__ void store_acc(const float (&x)[MB][D / 8][4],
                                          float mul, unsigned char* tile,
                                          int r0, __nv_bfloat16* base,
                                          long long stride_s, int s0, int S,
                                          const Lanes& L, int lane) {
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = r0 + 16 * i + L.g + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(tile + swz<D>(lr, j) + 4 * L.t) =
            pack_bf16(x[i][j][2 * r] * mul, x[i][j][2 * r + 1] * mul);
    }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < MB; ++i)
    store_rows16<D>(base, stride_s, s0 + 16 * i, S, tile, r0 + 16 * i, lane);
}

template <int D>
__host__ __device__ constexpr int dkv_mma_smem_bytes() {
  // K and V resident; Q and dO twice each; lse and delta twice each
  return 2 * MMA_TILE * D * 2 + 4 * DKV_BQ * D * 2
         + 4 * DKV_BQ * 4;
}

template <int D>
__global__ void __launch_bounds__(mma_threads<D>())
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int S,
                         Strides sq, Strides sk, Strides sv, Strides sdo,
                         Strides sdk, Strides sdv, int causal, float scale,
                         int window) {
  constexpr int MB = mma_mb<D>(), NTH = mma_threads<D>();
  constexpr int WR = 16 * MB;         // kv rows a warp
  constexpr int BQ = DKV_BQ;
  constexpr int Q_TILE = BQ * D * 2;  // bytes of one Q or dO tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t k_s = smem_u32(smem_raw);
  const uint32_t v_s = k_s + MMA_TILE * D * 2;
  const uint32_t q_s = v_s + MMA_TILE * D * 2;  // two Q tiles
  const uint32_t o_s = q_s + 2 * Q_TILE;        // two dO tiles
  // lse of two query tiles, then delta of two
  float* rows_s = reinterpret_cast<float*>(smem_raw + 2 * MMA_TILE * D * 2 +
                                           4 * Q_TILE);
  const uint32_t rows_u = smem_u32(rows_s);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Lanes L(lane);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * MMA_TILE;  // kv tile 0 (the heaviest) first
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* ob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (long long)bh * S;
  const float* dl_b = delta + (long long)bh * S;

  // query tiles with any row that sees some key of this kv tile
  const int k_last = (k0 + MMA_TILE < S ? k0 + MMA_TILE : S) - 1;
  int qt_begin = 0, qt_end = S / BQ;
  if (causal) {
    qt_begin = k0 / BQ;
    if (window > 0) {
      const long long e = ((long long)k_last + window - 1) / BQ + 1;
      if (e < qt_end) qt_end = (int)e;
    }
  }

  // one query tile's Q, dO, lse and delta into buffer `buf`
  auto load_q_tile = [&](int qt, int buf) {
    cp_async_tile<D, NTH>(q_s + buf * Q_TILE, qb, sq.s, qt * BQ, BQ, S, tid);
    cp_async_tile<D, NTH>(o_s + buf * Q_TILE, ob, sdo.s, qt * BQ, BQ, S, tid);
    if (tid < BQ / 2) {  // BQ / 4 chunks of lse, then BQ / 4 of delta
      const int c = tid % (BQ / 4), which = tid / (BQ / 4);
      const float* src = (which ? dl_b : lse_b) + qt * BQ + 4 * c;
      cp_async16(rows_u + ((2 * which + buf) * BQ + 4 * c) * 4, src);
    }
  };

  cp_async_tile<D, NTH>(k_s, k + b * sk.b + h * sk.h, sk.s, k0, MMA_TILE, S,
                        tid);
  cp_async_tile<D, NTH>(v_s, v + b * sv.b + h * sv.h, sv.s, k0, MMA_TILE, S,
                        tid);
  if (qt_begin < qt_end) load_q_tile(qt_begin, 0);
  cp_async_commit();

  const int wr0 = WR * warp;       // the warp's first row in K and V
  const int wk0 = k0 + wr0;        // and in the sequence
  const float sl2 = scale * LOG2E;
  // the warp's rows of dK (unscaled) and dV: block i's rows g and g + 8,
  // columns 8 j + 2 t and + 1
  float dka[MB][D / 8][4], dva[MB][D / 8][4];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][j][e] = dva[i][j][e] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int buf = (qt - qt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile qt has landed; every warp is done with qt - 1
    if (qt + 1 < qt_end) load_q_tile(qt + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = qt * BQ;
    // a tile no row of this warp's keys is seen by
    if (wk0 >= S || (causal && q0 + BQ - 1 < wk0) ||
        (window > 0 && q0 > wk0 + WR - 1 + window - 1))
      continue;
    const uint32_t qbuf = q_s + buf * Q_TILE, obuf = o_s + buf * Q_TILE;
    const float* lse_t = rows_s + buf * BQ;
    const float* dl_t = rows_s + (2 + buf) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows the warp's keys, columns the
    // tile's queries
    float st[MB][BQ / 8][4], dpt[MB][BQ / 8][4];
    two_products<D, BQ, MB>(st, dpt, k_s, qbuf, v_s, obuf, wr0, L);

    // P^T and dS^T = P^T o (dP^T - delta), masked where the diagonal or
    // the window's edge crosses the warp's part of the tile
    const bool edge = causal && (q0 < wk0 + WR - 1 ||
                                 (window > 0 && q0 + BQ - 1 - wk0 >= window));
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = 8 * j + 2 * L.t;  // this thread's two query columns
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_t + c);
      const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_approx(fmaf(st[i][j][e], sl2, nl[e & 1]));
          if (edge && !visible(q0 + c + (e & 1),
                               wk0 + 16 * i + L.g + 8 * (e >> 1), causal,
                               window))
            p = 0.f;
          st[i][j][e] = p;
          dpt[i][j][e] = p * (dpt[i][j][e] - dl[e & 1]);
        }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries: P^T and dS^T
    // rounded to bf16 are the A fragments; dO and Q through ldmatrix.trans
    two_products_t<D, BQ / 16, MB>(dva, dka, st, dpt, obuf, qbuf, L);
  }
  cp_async_wait<0>();
  __syncthreads();  // K and V landed even if the walk was empty

  // dK * scale and dV, staged in this warp's own rows of the K and V tiles
  store_acc<D, MB>(dka, scale, smem_raw, wr0, dk + b * sdk.b + h * sdk.h,
                   sdk.s, wk0, S, L, lane);
  store_acc<D, MB>(dva, 1.f, smem_raw + MMA_TILE * D * 2, wr0,
                   dv + b * sdv.b + h * sdv.h, sdv.s, wk0, S, L, lane);
}

template <int D>
__host__ __device__ constexpr int dq_mma_smem_bytes() {
  // Q and dO resident; K and V twice each
  return 2 * MMA_TILE * D * 2 + 4 * dq_bkv<D>() * D * 2;
}

template <int D>
__global__ void __launch_bounds__(mma_threads<D>())
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int S,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int causal, float scale, int window) {
  constexpr int MB = mma_mb<D>(), NTH = mma_threads<D>();
  constexpr int WR = 16 * MB;              // query rows a warp
  constexpr int BKV = dq_bkv<D>();
  constexpr int KV_TILE = BKV * D * 2;     // bytes of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t o_s = q_s + MMA_TILE * D * 2;
  const uint32_t k_s = o_s + MMA_TILE * D * 2;  // two K tiles
  const uint32_t v_s = k_s + 2 * KV_TILE;       // two V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Lanes L(lane);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // the last causal tile (the heaviest) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MMA_TILE;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  // kv tiles with any visible key for some row of this query tile
  const int q_last = (q0 + MMA_TILE < S ? q0 + MMA_TILE : S) - 1;
  int kt_begin = 0, kt_end = S / BKV;
  if (causal) {
    kt_end = q_last / BKV + 1;
    if (window > 0) {
      const int first_key = q0 - (window - 1);
      kt_begin = first_key > 0 ? first_key / BKV : 0;
    }
  }

  cp_async_tile<D, NTH>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, MMA_TILE, S,
                        tid);
  cp_async_tile<D, NTH>(o_s, dout + b * sdo.b + h * sdo.h, sdo.s, q0,
                        MMA_TILE, S, tid);
  cp_async_tile<D, NTH>(k_s, kb, sk.s, kt_begin * BKV, BKV, S, tid);
  cp_async_tile<D, NTH>(v_s, vb, sv.s, kt_begin * BKV, BKV, S, tid);
  cp_async_commit();

  const int wr0 = WR * warp;       // the warp's first row in Q and dO
  const int wq0 = q0 + wr0;        // and in the sequence
  const float sl2 = scale * LOG2E;
  // -lse * log2(e) and delta of the thread's rows g and g + 8 of block i
  float nl[MB][2], dl[MB][2];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = wq0 + 16 * i + L.g + 8 * r;
      nl[i][r] = qp < S ? -lse[(long long)bh * S + qp] * LOG2E : 0.f;
      dl[i][r] = qp < S ? delta[(long long)bh * S + qp] : 0.f;
    }
  float acc[MB][D / 8][4];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    if (kt + 1 < kt_end) {
      cp_async_tile<D, NTH>(k_s + (buf ^ 1) * KV_TILE, kb, sk.s,
                            (kt + 1) * BKV, BKV, S, tid);
      cp_async_tile<D, NTH>(v_s + (buf ^ 1) * KV_TILE, vb, sv.s,
                            (kt + 1) * BKV, BKV, S, tid);
    }
    cp_async_commit();
    const int k0 = kt * BKV;
    // a tile this warp's rows see nothing of
    if (wq0 >= S || (causal && k0 > wq0 + WR - 1) ||
        (window > 0 && k0 + BKV - 1 < wq0 - window + 1))
      continue;
    const uint32_t kbuf = k_s + buf * KV_TILE, vbuf = v_s + buf * KV_TILE;

    // S = Q K^T and dP = dO V^T
    float sc[MB][BKV / 8][4], dp[MB][BKV / 8][4];
    two_products<D, BKV, MB>(sc, dp, q_s, kbuf, o_s, vbuf, wr0, L);

    // dS = P o (dP - delta), P masked where the diagonal or the window's
    // edge crosses the warp's part of the tile
    const bool edge =
        causal && (k0 + BKV - 1 > wq0 ||
                   (window > 0 && k0 < wq0 + WR - 1 - window + 1));
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2_approx(fmaf(sc[i][j][e], sl2, nl[i][r]));
          if (edge && !visible(wq0 + 16 * i + L.g + 8 * r,
                               k0 + 8 * j + 2 * L.t + (e & 1), causal,
                               window))
            p = 0.f;
          sc[i][j][e] = p * (dp[i][j][e] - dl[i][r]);
        }

    // dQ += dS K: dS rounded to bf16 is the A fragment, K through
    // ldmatrix.trans
    product_t<D, BKV / 16, MB>(acc, sc, kbuf, L);
  }
  cp_async_wait<0>();
  __syncthreads();  // Q landed even if the walk was empty

  // dQ * scale, staged in this warp's own rows of the Q tile
  store_acc<D, MB>(acc, scale, smem_raw, wr0, dq + b * sdq.b + h * sdq.h,
                   sdq.s, wq0, S, L, lane);
}

// ---- fp32 at head_dim 64 and 128: the TF32 tensor cores, three passes ----

// Rows of the tile a block owns (a warp 16 of them), of the other side's
// tile a step, and the blocks an SM must hold (the launch bound that caps
// registers). At head_dim 64 the tiles are 64 rows: three dQ blocks (12
// warps) an SM within 168 registers a thread, two dK/dV blocks (the dK
// and dV accumulators need ~220). At 128 the dK and dV accumulators of a
// warp's 16 rows take 128 registers alone: one block of 128 rows an SM,
// 16-row query steps. (Chosen on the card among 64 / 128 rows, 8 / 16 /
// 32 / 64-row steps and one to three blocks: the fastest without spills.)
template <int D> __host__ __device__ constexpr int dq_tf_rows() {
  return D == 64 ? 64 : 128;
}
constexpr int DQ_TF_BKV = 32;
template <int D> __host__ __device__ constexpr int dq_tf_blocks() {
  return D == 64 ? 3 : 1;
}
template <int D> __host__ __device__ constexpr int dkv_tf_rows() {
  return D == 64 ? 64 : 128;
}
template <int D> __host__ __device__ constexpr int dkv_tf_bq() {
  return D == 64 ? 32 : 16;
}
template <int D> __host__ __device__ constexpr int dkv_tf_blocks() {
  return D == 64 ? 2 : 1;
}
// product_nt's UNROLL in the dK/dV kernel (the dQ kernel's is false)
template <int D> __host__ __device__ constexpr bool dkv_tf_unroll() {
  return D == 64;
}

template <int D>
__host__ __device__ constexpr int dkv_tf32_smem_bytes() {
  // K and V resident; Q and dO twice each; lse and delta twice each
  return (2 * dkv_tf_rows<D>() + 4 * dkv_tf_bq<D>()) * tf_ld<D>() * 4
         + 4 * dkv_tf_bq<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(tf_threads<dkv_tf_rows<D>()>(),
                                  dkv_tf_blocks<D>())
    flash_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int S, Strides sq, Strides sk, Strides sv,
                          Strides sdo, Strides sdk, Strides sdv, int causal,
                          float scale, int window) {
  constexpr int ROWS = dkv_tf_rows<D>(), NTH = tf_threads<ROWS>();
  constexpr int LD = tf_ld<D>(), BQ = dkv_tf_bq<D>();
  constexpr int Q_TILE = BQ * LD;     // floats of one Q or dO tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* const k_s = reinterpret_cast<float*>(smem_raw);
  float* const v_s = k_s + ROWS * LD;
  float* const q_s = v_s + ROWS * LD;      // two Q tiles
  float* const o_s = q_s + 2 * Q_TILE;     // two dO tiles
  float* const rows_s = o_s + 2 * Q_TILE;  // lse of two tiles, delta of two
  const uint32_t rows_u = smem_u32(rows_s);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Lanes L(lane);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * ROWS;  // kv tile 0 (the heaviest) first
  const float* qb = q + b * sq.b + h * sq.h;
  const float* ob = dout + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (long long)bh * S;
  const float* dl_b = delta + (long long)bh * S;

  // query tiles with any row that sees some key of this kv tile
  const int k_last = (k0 + ROWS < S ? k0 + ROWS : S) - 1;
  int qt_begin = 0, qt_end = S / BQ;
  if (causal) {
    qt_begin = k0 / BQ;
    if (window > 0) {
      const long long e = ((long long)k_last + window - 1) / BQ + 1;
      if (e < qt_end) qt_end = (int)e;
    }
  }

  // one query tile's Q, dO, lse and delta into buffer `buf`
  auto load_q_tile = [&](int qt, int buf) {
    cp_async_tile_f32<D, NTH>(smem_u32(q_s + buf * Q_TILE), qb, sq.s,
                              qt * BQ, BQ, S, tid);
    cp_async_tile_f32<D, NTH>(smem_u32(o_s + buf * Q_TILE), ob, sdo.s,
                              qt * BQ, BQ, S, tid);
    if (tid < BQ / 2) {  // BQ / 4 chunks of lse, then BQ / 4 of delta
      const int c = tid % (BQ / 4), which = tid / (BQ / 4);
      const float* src = (which ? dl_b : lse_b) + qt * BQ + 4 * c;
      cp_async16(rows_u + ((2 * which + buf) * BQ + 4 * c) * 4, src);
    }
  };

  cp_async_tile_f32<D, NTH>(smem_u32(k_s), k + b * sk.b + h * sk.h, sk.s,
                            k0, ROWS, S, tid);
  cp_async_tile_f32<D, NTH>(smem_u32(v_s), v + b * sv.b + h * sv.h, sv.s,
                            k0, ROWS, S, tid);
  if (qt_begin < qt_end) load_q_tile(qt_begin, 0);
  cp_async_commit();

  const int wr0 = 16 * warp;       // the warp's first row in K and V
  const int wk0 = k0 + wr0;        // and in the sequence
  const float sl2 = scale * LOG2E;
  // the warp's rows of dK (unscaled) and dV, in product_acc's layout
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int buf = (qt - qt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile qt has landed; every warp is done with qt - 1
    if (qt + 1 < qt_end) load_q_tile(qt + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = qt * BQ;
    // a tile no row of this warp's keys is seen by
    if (wk0 >= S || (causal && q0 + BQ - 1 < wk0) ||
        (window > 0 && q0 > wk0 + 15 + window - 1))
      continue;
    const float* qbuf = q_s + buf * Q_TILE;
    const float* obuf = o_s + buf * Q_TILE;
    const float* lse_t = rows_s + buf * BQ;
    const float* dl_t = rows_s + (2 + buf) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows the warp's keys, columns the
    // tile's queries
    float st[BQ / 8][4], dpt[BQ / 8][4];
    product_nt<D, BQ, dkv_tf_unroll<D>()>(st, k_s, qbuf, wr0, L);
    product_nt<D, BQ, dkv_tf_unroll<D>()>(dpt, v_s, obuf, wr0, L);

    // P^T and dS^T = P^T o (dP^T - delta), masked where the diagonal or
    // the window's edge crosses the warp's part of the tile
    const bool edge = causal && (q0 < wk0 + 15 ||
                                 (window > 0 && q0 + BQ - 1 - wk0 >= window));
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = 8 * j + 2 * L.t;  // this thread's two query columns
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_t + c);
      const float nl[2] = {-l2.x * LOG2E, -l2.y * LOG2E};
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(st[j][e], sl2, nl[e & 1]));
        if (edge && !visible(q0 + c + (e & 1), wk0 + L.g + 8 * (e >> 1),
                             causal, window))
          p = 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl[e & 1]);
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's queries
    product_acc<D, BQ / 8>(dva, st, obuf, L);
    product_acc<D, BQ / 8>(dka, dpt, qbuf, L);
  }
  cp_async_wait<0>();  // no copy in flight when the block ends

  store_acc_f32<D>(dka, scale, dk + b * sdk.b + h * sdk.h, sdk.s, wk0, S, L);
  store_acc_f32<D>(dva, 1.f, dv + b * sdv.b + h * sdv.h, sdv.s, wk0, S, L);
}

template <int D>
__host__ __device__ constexpr int dq_tf32_smem_bytes() {
  // Q and dO resident; K and V twice each
  return (2 * dq_tf_rows<D>() + 4 * DQ_TF_BKV) * tf_ld<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(tf_threads<dq_tf_rows<D>()>(),
                                  dq_tf_blocks<D>())
    flash_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int S, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sdq,
                         int causal, float scale, int window) {
  constexpr int ROWS = dq_tf_rows<D>(), NTH = tf_threads<ROWS>();
  constexpr int LD = tf_ld<D>(), BKV = DQ_TF_BKV;
  constexpr int KV_TILE = BKV * LD;        // floats of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* const q_s = reinterpret_cast<float*>(smem_raw);
  float* const o_s = q_s + ROWS * LD;
  float* const k_s = o_s + ROWS * LD;      // two K tiles
  float* const v_s = k_s + 2 * KV_TILE;    // two V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Lanes L(lane);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // the last causal tile (the heaviest) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  // kv tiles with any visible key for some row of this query tile
  const int q_last = (q0 + ROWS < S ? q0 + ROWS : S) - 1;
  int kt_begin = 0, kt_end = S / BKV;
  if (causal) {
    kt_end = q_last / BKV + 1;
    if (window > 0) {
      const int first_key = q0 - (window - 1);
      kt_begin = first_key > 0 ? first_key / BKV : 0;
    }
  }

  cp_async_tile_f32<D, NTH>(smem_u32(q_s), q + b * sq.b + h * sq.h, sq.s,
                            q0, ROWS, S, tid);
  cp_async_tile_f32<D, NTH>(smem_u32(o_s), dout + b * sdo.b + h * sdo.h,
                            sdo.s, q0, ROWS, S, tid);
  cp_async_tile_f32<D, NTH>(smem_u32(k_s), kb, sk.s, kt_begin * BKV, BKV, S,
                            tid);
  cp_async_tile_f32<D, NTH>(smem_u32(v_s), vb, sv.s, kt_begin * BKV, BKV, S,
                            tid);
  cp_async_commit();

  const int wr0 = 16 * warp;       // the warp's first row in Q and dO
  const int wq0 = q0 + wr0;        // and in the sequence
  const float sl2 = scale * LOG2E;
  // -lse * log2(e) and delta of the thread's rows g and g + 8
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = wq0 + L.g + 8 * r;
    nl[r] = qp < S ? -lse[(long long)bh * S + qp] * LOG2E : 0.f;
    dl[r] = qp < S ? delta[(long long)bh * S + qp] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with kt - 1
    if (kt + 1 < kt_end) {
      cp_async_tile_f32<D, NTH>(smem_u32(k_s + (buf ^ 1) * KV_TILE), kb,
                                sk.s, (kt + 1) * BKV, BKV, S, tid);
      cp_async_tile_f32<D, NTH>(smem_u32(v_s + (buf ^ 1) * KV_TILE), vb,
                                sv.s, (kt + 1) * BKV, BKV, S, tid);
    }
    cp_async_commit();
    const int k0 = kt * BKV;
    // a tile this warp's rows see nothing of
    if (wq0 >= S || (causal && k0 > wq0 + 15) ||
        (window > 0 && k0 + BKV - 1 < wq0 - window + 1))
      continue;
    const float* kbuf = k_s + buf * KV_TILE;
    const float* vbuf = v_s + buf * KV_TILE;

    // S = Q K^T and dP = dO V^T
    float sc[BKV / 8][4], dp[BKV / 8][4];
    product_nt<D, BKV, false>(sc, q_s, kbuf, wr0, L);
    product_nt<D, BKV, false>(dp, o_s, vbuf, wr0, L);

    // dS = P o (dP - delta), P masked where the diagonal or the window's
    // edge crosses the warp's part of the tile
    const bool edge = causal && (k0 + BKV - 1 > wq0 ||
                                 (window > 0 && k0 < wq0 + 15 - window + 1));
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2_approx(fmaf(sc[j][e], sl2, nl[r]));
        if (edge && !visible(wq0 + L.g + 8 * r, k0 + 8 * j + 2 * L.t + (e & 1),
                             causal, window))
          p = 0.f;
        sc[j][e] = p * (dp[j][e] - dl[r]);
      }

    // dQ += dS K
    product_acc<D, BKV / 8>(acc, sc, kbuf, L);
  }
  cp_async_wait<0>();  // no copy in flight when the block ends

  store_acc_f32<D>(acc, scale, dq + b * sdq.b + h * sdq.h, sdq.s, wq0, S, L);
}

// ---- delta = rowsum(dO o O), the pre-pass ----------------------------------

constexpr int DELTA_LANES = 8;                     // lanes a row
constexpr int DELTA_ROWS = NT / DELTA_LANES;       // rows a block

// VEC elements (16 bytes) a load
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf16(w[i]);
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int H, int S, int D,
                       Strides so, Strides sdo) {
  // B * H * S is a multiple of DELTA_ROWS (S of 64): every lane has a row
  const long long row =
      (long long)blockIdx.x * DELTA_ROWS + threadIdx.x / DELTA_LANES;
  const int part = threadIdx.x % DELTA_LANES;
  const int bh = (int)(row / S), s = (int)(row % S), b = bh / H, h = bh % H;
  const T* orow = o + b * so.b + h * so.h + (long long)s * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + (long long)s * sdo.s;
  float acc = 0.f;
  for (int c = part * VEC; c < D; c += DELTA_LANES * VEC) {
    float x[VEC], y[VEC];
    load_vec<T, VEC>(orow + c, x);
    load_vec<T, VEC>(drow + c, y);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc = fmaf(x[i], y[i], acc);
  }
#pragma unroll
  for (int off = 1; off < DELTA_LANES; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) delta[row] = acc;
}

// ---- launches --------------------------------------------------------------

struct Args {  // one backward call's arguments
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const float* delta;
  void *dq, *dk, *dv;
  int B, H, S;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int causal;
  float scale;
  int window;
  cudaStream_t stream;
};

// dynamic shared memory above 48 KB, set once per kernel
template <typename K>
cudaError_t smem_attr(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr int bytes = dq_smem_floats<D>() * sizeof(float);
  static bool attr_set = false;
  if (cudaError_t e = smem_attr(flash_dq_kernel<T, D>, bytes, attr_set))
    return e;
  const dim3 grid(a.B * a.H, a.S / tile_rows<D>());
  flash_dq_kernel<T, D><<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.H, a.S, a.sq, a.sk, a.sv, a.sdo,
      a.sdq, a.causal, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr int bytes = dkv_smem_floats<D>() * sizeof(float);
  static bool attr_set = false;
  if (cudaError_t e = smem_attr(flash_dkv_kernel<T, D>, bytes, attr_set))
    return e;
  const dim3 grid(a.B * a.H, a.S / tile_rows<D>());
  flash_dkv_kernel<T, D><<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.S, a.sq,
      a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.causal, a.scale, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const Args& a) {
  constexpr int bytes = dq_mma_smem_bytes<D>();
  static bool attr_set = false;
  if (cudaError_t e = smem_attr(flash_dq_mma_kernel<D>, bytes, attr_set))
    return e;
  using bf = __nv_bfloat16;
  dim3 grid(a.B * a.H, (a.S + MMA_TILE - 1) / MMA_TILE);
  flash_dq_mma_kernel<D><<<grid, mma_threads<D>(), bytes, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dq), a.H, a.S, a.sq, a.sk, a.sv, a.sdo,
      a.sdq, a.causal, a.scale, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const Args& a) {
  constexpr int bytes = dkv_mma_smem_bytes<D>();
  static bool attr_set = false;
  if (cudaError_t e = smem_attr(flash_dkv_mma_kernel<D>, bytes, attr_set))
    return e;
  using bf = __nv_bfloat16;
  dim3 grid(a.B * a.H, (a.S + MMA_TILE - 1) / MMA_TILE);
  flash_dkv_mma_kernel<D><<<grid, mma_threads<D>(), bytes, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
      a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.H, a.S,
      a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.causal, a.scale, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tf32(const Args& a) {
  constexpr int bytes = dq_tf32_smem_bytes<D>();
  static bool attr_set = false;
  if (cudaError_t e = smem_attr(flash_dq_tf32_kernel<D>, bytes, attr_set))
    return e;
  constexpr int rows = dq_tf_rows<D>();
  dim3 grid(a.B * a.H, (a.S + rows - 1) / rows);
  flash_dq_tf32_kernel<D><<<grid, tf_threads<rows>(), bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.S, a.sq, a.sk, a.sv,
      a.sdo, a.sdq, a.causal, a.scale, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tf32(const Args& a) {
  constexpr int bytes = dkv_tf32_smem_bytes<D>();
  static bool attr_set = false;
  if (cudaError_t e = smem_attr(flash_dkv_tf32_kernel<D>, bytes, attr_set))
    return e;
  constexpr int rows = dkv_tf_rows<D>();
  dim3 grid(a.B * a.H, (a.S + rows - 1) / rows);
  flash_dkv_tf32_kernel<D><<<grid, tf_threads<rows>(), bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.H, a.S, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.causal, a.scale,
      a.window);
  return cudaGetLastError();
}

// o and dO must be 16-byte aligned (the wrapper copies a view that is not)
template <typename T>
cudaError_t launch_delta(const Args& a, float* delta, int D) {
  if (!aligned16(a.o, a.so, a.B, a.H, sizeof(T)) ||
      !aligned16(a.dout, a.sdo, a.B, a.H, sizeof(T)))
    return cudaErrorInvalidValue;
  // one x dimension of DELTA_ROWS rows a block: no limit of b * h's own
  const long long rows = (long long)a.B * a.H * a.S;
  if (rows / DELTA_ROWS > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(rows / DELTA_ROWS);
  constexpr int VEC = 16 / sizeof(T);
  flash_delta_kernel<T, VEC><<<blocks, NT, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), delta, a.H,
      a.S, D, a.so, a.sdo);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_simt(const Args& a) {
  if (a.dq != nullptr)
    if (cudaError_t e = launch_dq<T, D>(a)) return e;
  return a.dk != nullptr ? launch_dkv<T, D>(a) : cudaSuccess;
}

// the tensor-core kernels' 16-byte copies and stores: every pointer and
// (b, s, h) step of the views, for elements of `bytes` bytes, and with
// `rows` the rows of lse and delta (which the streaming kernels read an
// element at a time)
bool views_aligned16(const Args& a, int bytes, bool rows = true) {
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv};
  const Strides strides[] = {a.sq, a.sk, a.sv, a.sdo, a.sdq, a.sdk, a.sdv};
  for (int i = 0; i < 7; ++i)
    if (ptrs[i] != nullptr &&
        !aligned16(ptrs[i], strides[i], a.B, a.H, bytes))
      return false;
  return !rows || ((reinterpret_cast<uintptr_t>(a.lse) |
                    reinterpret_cast<uintptr_t>(a.delta)) & 15) == 0;
}

template <int D>
cudaError_t launch_mma(const Args& a) {
  if (!views_aligned16(a, 2)) return cudaErrorInvalidValue;
  if (a.dq != nullptr)
    if (cudaError_t e = launch_dq_mma<D>(a)) return e;
  return a.dk != nullptr ? launch_dkv_mma<D>(a) : cudaSuccess;
}

template <typename T, bool RES>
cudaError_t launch_dq_stream(const Args& a, int D, const Groups& gr) {
  static bool attr_set = false;
  if (cudaError_t e =
          smem_attr(flash_dq_stream_kernel<T, RES>, ST_SMEM_MAX, attr_set))
    return e;
  const dim3 grid(a.B * a.H * gr.G, a.S / ST_ROWS);
  flash_dq_stream_kernel<T, RES>
      <<<grid, ST_THREADS, bwd_st_smem<T, RES, DQ_ST_BO>(D), a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
          a.delta, static_cast<T*>(a.dq), a.H, a.S, D, gr.G, gr.WG, a.sq,
          a.sk, a.sv, a.sdo, a.sdq, a.causal, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T, bool RES>
cudaError_t launch_dkv_stream(const Args& a, int D, const Groups& gr) {
  static bool attr_set = false;
  if (cudaError_t e =
          smem_attr(flash_dkv_stream_kernel<T, RES>, ST_SMEM_MAX, attr_set))
    return e;
  const dim3 grid(a.B * a.H * gr.G, a.S / ST_ROWS);
  flash_dkv_stream_kernel<T, RES>
      <<<grid, ST_THREADS, bwd_st_smem<T, RES, dkv_st_bo<T>()>(D),
         a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
          a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.S, D,
          gr.G, gr.WG, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.causal,
          a.scale, a.window);
  return cudaGetLastError();
}

// bf16 keeps each kernel's own side's chunk tiles resident where
// `resident` says. fp32's never fit beside the ring (bwd_st_smem<float,
// true, BO>(576), the smallest head dim on the route, is 345,600 bytes for
// dK/dV and 359,424 for dQ, over ST_SMEM_MAX), so fp32 builds only the
// streamed kernels.
template <typename T>
cudaError_t launch_stream(const Args& a, int D) {
  constexpr bool kMayReside = sizeof(T) == 2;
  const Groups gq = groups_of(D, dq_st_wmax<T>());
  const Groups gkv = groups_of(D, DKV_ST_WMAX);
  const long long bh = (long long)a.B * a.H, tiles = a.S / ST_ROWS;
  if (bh * gkv.G > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.dq != nullptr) {
    cudaError_t e;
    if constexpr (kMayReside)
      e = resident(bh * gq.G * tiles, bwd_st_smem<T, true, DQ_ST_BO>(D))
              ? launch_dq_stream<T, true>(a, D, gq)
              : launch_dq_stream<T, false>(a, D, gq);
    else
      e = launch_dq_stream<T, false>(a, D, gq);
    if (e != cudaSuccess) return e;
  }
  if (a.dk == nullptr) return cudaSuccess;
  if constexpr (kMayReside)
    return resident(bh * gkv.G * tiles,
                    bwd_st_smem<T, true, dkv_st_bo<T>()>(D))
               ? launch_dkv_stream<T, true>(a, D, gkv)
               : launch_dkv_stream<T, false>(a, D, gkv);
  else
    return launch_dkv_stream<T, false>(a, D, gkv);
}

template <int D>
cudaError_t launch_tf32(const Args& a) {
  if (a.dq != nullptr)
    if (cudaError_t e = launch_dq_tf32<D>(a)) return e;
  return a.dk != nullptr ? launch_dkv_tf32<D>(a) : cudaSuccess;
}

// the route by type, head dim and alignment: bf16 at 64 and 128 on the
// tensor cores (a view off 16 bytes is refused); fp32 at 64 and 128 on the
// TF32 tensor cores where every view is 16-byte aligned, else, as at the
// other head dims, on the scalar kernels
template <int D>
cudaError_t dispatch(const Args& a, int dtype, int* route) {
  if constexpr (D <= 128) {
    if (dtype == 1) {
      *route = 1;
      return launch_mma<D>(a);
    }
    if (views_aligned16(a, 4)) {
      *route = 4;
      return launch_tf32<D>(a);
    }
    *route = 2;
    return launch_simt<float, D>(a);
  } else {
    *route = 2;
    return dtype == 0 ? launch_simt<float, D>(a)
                      : launch_simt<__nv_bfloat16, D>(a);
  }
}

}  // namespace

extern "C" {

// One backward call. With `delta` null, the pre-pass writes rowsum(dO o O)
// into `delta_buf` (a [B * H, S] fp32 array) first and the kernels read it;
// else they read `delta` and `o` is not read. Then the dQ kernel runs when
// `dq` is not null, and the dK/dV kernel when `dk` (and `dv`) is not null;
// with neither, only the pre-pass (q, k and v unread). `strides` holds the
// (b, s, h) element strides of q, k, v, o, dout, dq, dk and dv in that
// order (24 values; those of an absent tensor unread). dtype: 0 = float32,
// 1 = bfloat16; window <= 0 means no window. *route is set to the kernels
// launched: 1 mma.sync (bf16), 2 scalar, 3 streaming, 4 mma.sync TF32 in
// three passes (fp32). b * h rides on gridDim.x,
// with no limit of its own (the pre-pass's grid too). Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernels do not take, else the
// first launch error.
int flash_bwd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, const void* delta,
              void* delta_buf, void* dq, void* dk, void* dv, int B, int H,
              int S, int D, const long long* strides, int causal,
              float scale, int window, int dtype, void* stream, int* route) {
  // b * h rides on gridDim.x, the tiles on gridDim.y
  if (B < 1 || H < 1 || S < 64 || S % 64 != 0 ||
      (long long)B * H > 0x7fffffffLL || S / 16 > 65535 ||
      (dtype != 0 && dtype != 1) || (window > 0 && !causal) ||
      strides == nullptr || route == nullptr ||
      (dk == nullptr) != (dv == nullptr) ||
      (delta == nullptr && (o == nullptr || delta_buf == nullptr)))
    return cudaErrorInvalidValue;
  const long long* st = strides;
  auto strided = [st](int i) { return Strides{st[3 * i], st[3 * i + 1],
                                              st[3 * i + 2]}; };
  Args a{q, k, v, o, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, dk, dv, B, H, S,
         strided(0), strided(1), strided(2), strided(3), strided(4),
         strided(5), strided(6), strided(7), causal, scale, window,
         static_cast<cudaStream_t>(stream)};
  *route = 0;
  if (D < 64 || D % 64 != 0)
    return cudaErrorInvalidValue;  // a head_dim the kernels have no tiling for
  if (delta == nullptr) {
    float* buf = static_cast<float*>(delta_buf);
    cudaError_t e = dtype == 0 ? launch_delta<float>(a, buf, D)
                               : launch_delta<__nv_bfloat16>(a, buf, D);
    if (e != cudaSuccess) return e;
    a.delta = buf;
  }
  if (dq == nullptr && dk == nullptr) return cudaSuccess;
  switch (D) {
    case 64: return dispatch<64>(a, dtype, route);
    case 128: return dispatch<128>(a, dtype, route);
    case 192: return dispatch<192>(a, dtype, route);
    case 256: return dispatch<256>(a, dtype, route);
    case 320: return dispatch<320>(a, dtype, route);
    case 384: return dispatch<384>(a, dtype, route);
    case 448: return dispatch<448>(a, dtype, route);
    case 512: return dispatch<512>(a, dtype, route);
  }
  *route = 3;  // above 512: stream the head dim (refused off 16 bytes)
  if (!views_aligned16(a, dtype == 0 ? 4 : 2, false))
    return cudaErrorInvalidValue;
  return dtype == 0 ? launch_stream<float>(a, D)
                    : launch_stream<__nv_bfloat16>(a, D);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
