// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// for ctypes (built by paddle_tpu_torch/ops/_build.py).
//
// Replaces: paddle_tpu/ops/flash_attention.py `_fwd_kernel`, the Pallas TPU
// kernel that `_flash_fwd` launches. Same function: FlashAttention-2
// forward with an online softmax whose running max, running sum and output
// accumulator stay in fp32; causal and sliding-window masking by the
// reference's `_causal_mask` rule (keep k_pos <= q_pos and q_pos - k_pos <
// window); writes the output in the input type and the per-row logsumexp
// `lse` in fp32 (the backward kernels recompute P = exp(S * scale - lse)
// from it).
//
// The TPU kernel walks a sequential (b*h, q-block, kv-block) grid and
// carries (acc, m, l) in VMEM scratch from one kv step to the next. Thread
// blocks on the card run in no order, so here a block owns one query tile
// of one (b, h) and loops over the kv tiles itself. Whole kv tiles above
// the diagonal (causal) or entirely outside the window are never computed;
// the tiles that straddle the diagonal or the window edge are masked per
// element, so a window smaller than a tile is exact.
//
// What bounds it: 4 * d FLOPs a visible (q, k) pair against 4 * s * d
// elements a head; at s 1024, d 64 in bf16 the bytes bind at b4 (7.6 us)
// and the tensor cores come close (b16: 30 us either way).
//
// bf16, `flash_fwd_mma_kernel`: FlashAttention-2 on the tensor cores. A
// block owns a 128-row query tile, each warp 32 rows at d 64 (two 16-row
// blocks sharing every K and V fragment) or 16 above (4 or 8 warps), and
// the tiles launch heaviest first (the last causal tile first). K and V
// tiles (64 rows at d <= 128, 32 at d 192/256) are double-buffered in shared
// memory by cp.async 16-byte copies, the next tile's copy in flight while
// this one computes; rows are XOR-swizzled in 16-byte chunks so ldmatrix
// reads them without bank conflicts. S = Q K^T is mma.sync.m16n8k16 (bf16
// in, fp32 accumulate; Q and K through ldmatrix); the scale is applied to
// S in fp32, folded into the SFU's exp2 with log2(e); the row max and sum
// reduce over the quad that shares a row by shuffles. P is rounded to bf16 in
// registers and used directly as the A operand of P V (the accumulator
// fragment of m16n8 is the A fragment of m16n8k16), V read through
// ldmatrix.trans. mma.sync and not wgmma: P stays in registers between the
// two products, which with wgmma needs FA3's layout exchange. q, k, v and
// o are [B, S, H, D] views with any 16-byte-aligned strides over (b, s, h)
// (the GPT path's q, k, v are slices of one packed qkv tensor), read and
// written without a copy; a warp stages its rows of o in its own rows of
// the Q tile and stores them as 16-byte chunks.
//
// fp32 at head_dim 64 and 128, `flash_fwd_tf32_kernel` (route 4): the
// same FlashAttention-2 loop on the TF32 tensor cores (mma.sync.m16n8k8;
// 494.7 dense TFLOP/s against 67 for fp32 FMAs), every product in three
// passes as the fp32 backward pair forms them (flash_tf32.cuh): x = big +
// small, big = tf32(x), small = tf32(x - big), and A B = small(A) big(B) +
// big(A) small(B) + big(A) big(B) into one fp32 accumulator. One TF32 pass
// keeps 10 of 23 mantissa bits and lands outside the fp32 band of 2e-4;
// three keep fp32 accuracy and triple the tensor-core work (3 x 4 d FLOPs
// a visible pair: 77.4 GFLOP, 0.156 ms at b16 h12 s1024 d64 causal). A
// block owns a tile of 64 query rows (a warp 16 of them) of one (b, h),
// heaviest causal tile first, and walks the kv tiles it can see; K and V
// tiles (64 rows at head_dim 64, 32 at 128) are double-buffered by
// cp.async 16-byte copies into rows of D + 4 floats, the next tile's copy
// in flight while this one computes. The scale is applied to q in fp32 in
// shared memory, where the reference applies it, before S = (Q scale) K^T
// (product_nt). Masked scores take the reference's _NEG where the diagonal
// or the window's edge crosses the warp's part of the tile; the online
// softmax runs on S's accumulator fragment (each row's max over the quad
// by shuffles, m, l and the rescale in registers, P = exp(S - m) on the
// SFU's exp2), and O = O alpha + P V (product_acc) takes P as the A
// operand as it stands: nothing goes through shared memory but the staged
// tiles. o = O / l leaves 16 bytes a lane (store_acc_f32), lse = m + log l.
// What holds it is issue slots, not the tensor pipe: each operand element
// is split (four integer and float instructions) at every use, beside the
// MMAs' own.
//
// The other head dims up to 512 (bf16 from 320, fp32 from 192) and every
// one above, fp32 and bf16, `flash_fwd_stream_kernel` (the streaming route;
// its tiles and products in flash_stream.cuh). A 64 x D fp32 accumulator
// does not fit in registers at these widths (D / 2 a thread), and above
// 512 no tile of a whole head fits in shared memory beside the others, so
// o's columns split into G = ceil(D / WMAX) groups of at most WMAX = 256
// (bf16) or 192 (fp32) columns, the last one narrower where D is no
// multiple (640: 192 x 3 + 64 in fp32). A warpgroup of 4 warps owns (b*h,
// group, 64-row query tile) and runs FlashAttention-2's one pass over the
// kv tiles it sees: S = Q K^T over the whole head from chunk tiles of 64
// (bf16) or 32 (fp32) columns that a cp.async ring keeps three deep, the
// online softmax on S's accumulator, O[:, group] += P V[:, group]; bf16 on
// mma.sync.m16n8k16, fp32 on TF32 mma.sync in three passes. Two designs
// place the groups (flash_stream.cuh `warpgroups` picks one): (a) a block
// a group, the group a grid step, so that every group's block forms the
// same S ((2 G + 2) d FLOPs a visible pair against the function's 4 d);
// (b), at head dims up to 512 where G > 1 and either D is above 320 or
// (a)'s grid would fill more than one wave of the SMs, a block of two
// warpgroups that own two groups (of at most 128 columns in fp32) and form
// S once between them: each its share of the head dim's chunks, the
// partial sums added through shared memory in warpgroup order, so that
// both hold the same S bit for bit ((2 ceil(G / 2) + 2) d). (a) keeps the
// query's chunk tiles resident where `resident` finds room, (b) wherever
// they fit. fp32 triples the FLOPs on the tensor cores and splits every
// operand at each use on the issue slots.
//
// The entry reports the kernel it launched (*route: 1 mma.sync, 3 the
// streaming one, 4 the TF32 one), which depends on the type and the head
// dim. Every view must be 16-byte aligned (the wrapper copies one that is
// not); seq a multiple of 64; lse is a contiguous [B * H, S] fp32 array.
// b * h rides on gridDim.x, with no limit of its own.

#include "flash_stream.cuh"

namespace {

using namespace flash;

constexpr float NEG = -1e30f; // the reference's masked score (_NEG)

// ---- the streaming route: bf16 from 320, fp32 from 192, any width above -----

// the widest column group of o a warpgroup owns: its fp32 accumulator
// takes WMAX / 2 registers a thread (128 in bf16; in fp32, where the TF32
// split operands need more of the 255, 96 with a warpgroup a block and 64
// with two, whose exchange and own addresses need more again)
template <typename T, int WGS>
__host__ __device__ constexpr int fwd_st_wmax() {
  return sizeof(T) == 2 ? 256 : WGS == 1 ? 192 : 128;
}
constexpr int FWD_ST_BKV = 64;  // kv rows a step

// bytes of the block's shared memory: exchange_sum's S (WGS > 1), then
// each warpgroup's own: with RES its share of the query chunk tiles stays
// resident and a ring stage holds a K or V chunk; without, a stage holds a
// K chunk and the query chunk beside it
template <typename T, bool RES, int WGS>
__host__ __device__ constexpr int fwd_st_smem(int D) {
  constexpr int OWN = ST_ROWS * Chunk<T>::ROW;
  constexpr int OTH = FWD_ST_BKV * Chunk<T>::ROW;
  const int per = (D / Chunk<T>::COLS + WGS - 1) / WGS;
  return exchange_bytes<WGS>(FWD_ST_BKV / 2) +
         WGS * (RES ? per * OWN + ST_STAGES * OTH
                    : ST_STAGES * (OTH + OWN));
}

// One block a (b*h, WGS column groups, 64-row query tile), each warpgroup
// 4 warps of 16 rows; FlashAttention-2's one pass. For each kv tile the
// block forms S = Q K^T over the whole head dim, one chunk tile at a time
// (chunk_nt; with WGS > 1 each warpgroup its share of the chunks, then
// exchange_sum), then the online softmax on S's accumulator (running m and
// l, the group's accumulator rescaled), then O[:, group] += P V[:, group]
// one chunk of V at a time (chunk_pv). Every warpgroup and every group's
// block forms the same S in the same order, so m, l and lse agree bit for
// bit across groups; group 0 writes lse. A warpgroup past the last group
// (G odd) forms its share of S and stores nothing.
template <typename T, bool RES, int WGS>
__global__ void __launch_bounds__(ST_THREADS * WGS)
    flash_fwd_stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse, int H, int S, int D,
                            int G, int WG, Strides sq, Strides sk, Strides sv,
                            Strides so, int causal, float scale, int window) {
  constexpr int DC = Chunk<T>::COLS, BKV = FWD_ST_BKV;
  constexpr int W = fwd_st_wmax<T, WGS>();
  constexpr int OWN = ST_ROWS * Chunk<T>::ROW, OTH = BKV * Chunk<T>::ROW;
  constexpr int STAGE = OTH + (RES ? 0 : OWN);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nD = D / DC;
  const int tid = threadIdx.x;
  // the thread's warpgroup, and its index there
  const int wg = WGS > 1 ? tid / ST_THREADS : 0;
  const int lt = WGS > 1 ? tid % ST_THREADS : tid;
  const int warp = lt >> 5;
  const Lanes L(tid & 31);
  const Split<WGS> part(nD, wg);
  // the warpgroup's own region: RES its query chunk tiles, then its ring
  const int per = (nD + WGS - 1) / WGS;
  float* const xch = reinterpret_cast<float*>(smem_raw);
  unsigned char* const q_res =
      smem_raw + exchange_bytes<WGS>(BKV / 2) +
      wg * ((RES ? per * OWN : 0) + ST_STAGES * STAGE);
  unsigned char* const ring_base = q_res + (RES ? per * OWN : 0);

  const int GP = (G + WGS - 1) / WGS;  // blocks a (b*h, query tile)
  const int bh = blockIdx.x / GP, g = blockIdx.x % GP * WGS + wg;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ST_ROWS;  // heaviest first
  const int c0 = g * WG, nW = WGS == 1 || g < G ? min(WG, D - c0) / DC : 0;
  // Q and K from the warpgroup's share of S's chunks
  const T* qb = q + b * sq.b + h * sq.h + part.c0 * DC;
  const T* kb = k + b * sk.b + h * sk.h + part.c0 * DC;
  const T* vb = v + b * sv.b + h * sv.h;

  // kv tiles with any visible key for some row of this query tile
  int kt_begin = 0, kt_end = S / BKV;
  if (causal) {
    kt_end = (q0 + ST_ROWS - 1) / BKV + 1;
    if (window > 0) {
      const int first_key = q0 - (window - 1);
      kt_begin = first_key > 0 ? first_key / BKV : 0;
    }
  }
  // a kv tile's items: the warpgroup's part.n chunks of K (and Q) for S,
  // then nW chunks of V
  const int items = part.n + nW, total = (kt_end - kt_begin) * items;
  auto issue = [&](int i, unsigned char* dst) {
    if (i < total) {
      const int kt = kt_begin + i / items, j = i % items;
      const uint32_t du = smem_u32(dst);
      if (j < part.n) {
        cp_chunk<T, BKV>(du, kb, sk.s, kt * BKV, j * DC, lt);
        if constexpr (!RES)
          cp_chunk<T, ST_ROWS>(du + OTH, qb, sq.s, q0, j * DC, lt);
      } else {
        cp_chunk<T, BKV>(du, vb, sv.s, kt * BKV, c0 + (j - part.n) * DC, lt);
      }
    }
    cp_async_commit();
  };
  if constexpr (RES)  // lands with the ring's first item
    for (int c = 0; c < part.n; ++c)
      cp_chunk<T, ST_ROWS>(smem_u32(q_res + c * OWN), qb, sq.s, q0, c * DC,
                           lt);
  Ring<WGS, decltype(issue)> ring(ring_base, STAGE, issue);
  ring.start();

  const int wr0 = 16 * warp, wq0 = q0 + wr0;
  // running max and sum of the thread's rows g and g + 8 (the sum this
  // thread's part: the quad's four parts add up at the end), the group's
  // accumulator a chunk of columns at a time
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  ChunkAcc<T> acc[W / DC];
#pragma unroll
  for (int cw = 0; cw < W / DC; ++cw)
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cw][j][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BKV;
    // a tile this warp's rows see nothing of: the ring still turns
    const bool skip = (causal && k0 > wq0 + 15) ||
                      (window > 0 && k0 + BKV - 1 < wq0 - window + 1);
    float sc[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    for (int c = 0; c < part.n; ++c) {
      const unsigned char* st = ring.next();
      if (!skip)
        chunk_nt<BKV>(sc, RES ? q_res + c * OWN : st + OTH, st, wr0, L, T{});
    }
    if constexpr (WGS > 1)
      exchange_sum<WGS, BKV / 2>(xch, &sc[0][0], wg, lt);
    POperand<T, BKV> p;
    if (!skip) {
      // S * scale in fp32, the reference's _NEG where the diagonal or the
      // window's edge crosses the warp's rows; then the online softmax on
      // the accumulator fragment, as flash_fwd_tf32_kernel runs it
      const bool edge = causal && (k0 + BKV - 1 > wq0 ||
                                   (window > 0 && k0 < wq0 + 15 - window + 1));
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= scale;
          if (edge && !visible(wq0 + L.g + 8 * (e >> 1),
                               k0 + 8 * j + 2 * L.t + (e & 1), causal, window))
            sc[j][e] = NEG;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_r[r];
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = exp2_approx((m_r[r] - mx) * LOG2E);
        m_r[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float pe = exp2_approx((sc[j][2 * r + c] - mx) * LOG2E);
            sc[j][2 * r + c] = pe;
            sum += pe;
          }
        l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
        for (int cw = 0; cw < W / DC; ++cw)
#pragma unroll
          for (int j = 0; j < DC / 8; ++j) {
            acc[cw][j][2 * r] *= alpha;
            acc[cw][j][2 * r + 1] *= alpha;
          }
      }
      p.set(sc);
    }
    // O[:, group] += P V[:, group], a chunk of V's columns at a time
#pragma unroll
    for (int cw = 0; cw < W / DC; ++cw)
      if (cw < nW) {
        const unsigned char* st = ring.next();
        if (!skip) chunk_pv<BKV>(acc[cw], p, st, L);
      }
  }
  cp_async_wait<0>();  // no copy in flight when the block ends

  // o = O / l, lse = m + log l (group 0)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    if (g == 0 && L.t == 0)
      lse[(long long)bh * S + wq0 + L.g + 8 * r] = m_r[r] + logf(l);
    if constexpr (sizeof(T) == 4) {  // fp32 divides, as the reference does
#pragma unroll
      for (int cw = 0; cw < W / DC; ++cw)
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          acc[cw][j][2 * r] /= l;
          acc[cw][j][2 * r + 1] /= l;
        }
      inv[r] = 1.f;
    }
  }
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int cw = 0; cw < W / DC; ++cw)
    if (cw < nW) store_chunk(acc[cw], inv, ob, so.s, wq0, c0 + cw * DC, L);
}

// ---- bf16: FlashAttention-2 on the tensor cores ---------------------------

constexpr int MQ = 128;  // query rows a block

// MB 16-row blocks a warp: MQ / (16 MB) warps a block
template <int MB> __host__ __device__ constexpr int mma_threads() {
  return 32 * MQ / (16 * MB);
}
template <int D> __host__ __device__ constexpr int mma_bkv() {
  return D <= 128 ? 64 : 32;
}
template <int D> __host__ __device__ constexpr int mma_smem_bytes() {
  return (MQ + 4 * mma_bkv<D>()) * D * 2;  // Q, then K and V twice each
}

template <int D, int MB>
__global__ void __launch_bounds__(mma_threads<MB>(), 1)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int H, int S, Strides sq,
                         Strides sk, Strides sv, Strides so, int causal,
                         float scale, int window) {
  constexpr int BKV = mma_bkv<D>();
  constexpr int NTH = mma_threads<MB>();
  constexpr int KV_TILE = BKV * D * 2;  // bytes of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t q_s = smem_u32(smem_raw);
  const uint32_t k_s = q_s + MQ * D * 2;     // two K tiles
  const uint32_t v_s = k_s + 2 * KV_TILE;    // two V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;  // heaviest tile first
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  // kv tiles with any visible key for some row of this query tile
  const int q_last = (q0 + MQ < S ? q0 + MQ : S) - 1;
  int kt_begin = 0, kt_end = S / BKV;
  if (causal) {
    kt_end = q_last / BKV + 1;
    if (window > 0) {
      const int first_key = q0 - (window - 1);
      kt_begin = first_key > 0 ? first_key / BKV : 0;
    }
  }

  cp_async_tile<D, NTH>(q_s, qb, sq.s, q0, MQ, S, tid);
  cp_async_tile<D, NTH>(k_s, kb, sk.s, kt_begin * BKV, BKV, S, tid);
  cp_async_tile<D, NTH>(v_s, vb, sv.s, kt_begin * BKV, BKV, S, tid);
  cp_async_commit();

  constexpr int WR = 16 * MB;               // query rows a warp
  const int wr0 = WR * warp;                // the warp's first row in Q
  const int wq0 = q0 + wr0;                 // and in the sequence
  const float sl2 = scale * LOG2E;
  // per 16-row block i: accumulator, running max and sum of rows g and
  // g + 8 ([i][0] and [i][1])
  float acc[MB][D / 8][4];
  float m_r[MB][2], l_r[MB][2];
#pragma unroll
  for (int i = 0; i < MB; ++i) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    m_r[i][0] = m_r[i][1] = -INFINITY;
    l_r[i][0] = l_r[i][1] = 0.f;
  }

  // ldmatrix lane roles: A (Q) and V^T fragments address row lane % 16,
  // chunk lane / 16; K fragments row lane % 8 (+8 for lanes 16-31), chunk
  // (lane / 8) % 2
  const int a_r = lane & 15, a_c = lane >> 4;
  const int k_r = (lane & 7) + ((lane >> 4) << 3), k_c = (lane >> 3) & 1;

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

    // S = Q K^T: BKV / 8 accumulator fragments of 16 x 8 a row block; each
    // K fragment serves the warp's MB row blocks
    float sc[MB][BKV / 8][4];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[MB][4];
#pragma unroll
      for (int i = 0; i < MB; ++i)
        ldmatrix_x4(qa[i], q_s + swz<D>(wr0 + 16 * i + a_r, 2 * kk + a_c));
#pragma unroll
      for (int nb = 0; nb < BKV / 16; ++nb) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kbuf + swz<D>(16 * nb + k_r, 2 * kk + k_c));
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          mma_bf16(sc[i][2 * nb], qa[i], kf[0], kf[1]);
          mma_bf16(sc[i][2 * nb + 1], qa[i], kf[2], kf[3]);
        }
      }
    }

    // the causal diagonal or the window edge crosses this tile: mask
    if (causal && (k0 + BKV - 1 > wq0 ||
                   (window > 0 && k0 < wq0 + WR - 1 - window + 1))) {
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = wq0 + 16 * i + g + 8 * (e >> 1);
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            if (kp > qp || (window > 0 && qp - kp >= window))
              sc[i][j][e] = -INFINITY;
          }
    }

    // online softmax, row by row (r 0: row g, r 1: row g + 8 of block i):
    // each row's max over the quad that holds it
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_r[i][r];
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[i][j][2 * r], sc[i][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a row with nothing visible yet keeps max -inf: subtract 0
        const float base = mx == -INFINITY ? 0.f : mx * sl2;
        const float alpha = exp2_approx(m_r[i][r] * sl2 - base);
        m_r[i][r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j) {
          sc[i][j][2 * r] = exp2_approx(fmaf(sc[i][j][2 * r], sl2, -base));
          sc[i][j][2 * r + 1] =
              exp2_approx(fmaf(sc[i][j][2 * r + 1], sl2, -base));
          sum += sc[i][j][2 * r] + sc[i][j][2 * r + 1];
        }
        l_r[i][r] = l_r[i][r] * alpha + sum;  // this thread's part
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[i][j][2 * r] *= alpha;
          acc[i][j][2 * r + 1] *= alpha;
        }
      }

    // O += P V: P's accumulator fragments, rounded to bf16, are the A
    // fragments of the k16 steps over this tile's keys; each V fragment
    // serves the warp's MB row blocks
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[MB][4];
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        pa[i][0] = pack_bf16(sc[i][2 * kk][0], sc[i][2 * kk][1]);
        pa[i][1] = pack_bf16(sc[i][2 * kk][2], sc[i][2 * kk][3]);
        pa[i][2] = pack_bf16(sc[i][2 * kk + 1][0], sc[i][2 * kk + 1][1]);
        pa[i][3] = pack_bf16(sc[i][2 * kk + 1][2], sc[i][2 * kk + 1][3]);
      }
#pragma unroll
      for (int db = 0; db < D / 16; ++db) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vbuf + swz<D>(16 * kk + a_r, 2 * db + a_c));
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          mma_bf16(acc[i][2 * db], pa[i], vf[0], vf[1]);
          mma_bf16(acc[i][2 * db + 1], pa[i], vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // o / l, staged in this warp's own rows of the Q tile (no other warp
  // reads them), then stored as 16-byte chunks, a row's chunks contiguous
  float* lrow = lse + (long long)bh * S;
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[i][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int lr = wr0 + 16 * i + g + 8 * r;  // row in the tile
      const float inv = 1.f / l;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(smem_raw + swz<D>(lr, j) + 4 * t) =
            pack_bf16(acc[i][j][2 * r] * inv, acc[i][j][2 * r + 1] * inv);
      if (t == 0 && q0 + lr < S) lrow[q0 + lr] = m_r[i][r] * scale + logf(l);
    }
  __syncwarp();
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
  constexpr int CH = D / 8;
#pragma unroll
  for (int idx = lane; idx < WR * CH; idx += 32) {
    const int r = idx / CH, c = idx % CH;
    if (wq0 + r < S)
      *reinterpret_cast<uint4*>(ob + (wq0 + r) * so.s + c * 8) =
          *reinterpret_cast<const uint4*>(smem_raw + swz<D>(wr0 + r, c));
  }
}

// ---- fp32 at head_dim 64 and 128: the TF32 tensor cores, three passes ----

// Query rows a block (16 a warp), kv rows a step, the blocks an SM must
// hold (the launch bound that caps registers) and product_nt's UNROLL.
// tf32_variants.py builds the other values side by side.
template <int D> __host__ __device__ constexpr int fwd_tf_rows() {
  return 64;
}
template <int D> __host__ __device__ constexpr int fwd_tf_bkv() {
  return D == 64 ? 64 : 32;
}
template <int D> __host__ __device__ constexpr int fwd_tf_blocks() {
  return 2;
}
template <int D> __host__ __device__ constexpr bool fwd_tf_unroll() {
  return D == 64;
}

template <int D>
__host__ __device__ constexpr int fwd_tf32_smem_bytes() {
  // Q resident; K and V twice each
  return (fwd_tf_rows<D>() + 4 * fwd_tf_bkv<D>()) * tf_ld<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(tf_threads<fwd_tf_rows<D>()>(),
                                  fwd_tf_blocks<D>())
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ o, float* __restrict__ lse,
                          int H, int S, Strides sq, Strides sk, Strides sv,
                          Strides so, int causal, float scale, int window) {
  constexpr int ROWS = fwd_tf_rows<D>(), NTH = tf_threads<ROWS>();
  constexpr int LD = tf_ld<D>(), BKV = fwd_tf_bkv<D>();
  constexpr int KV_TILE = BKV * LD;        // floats of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* const q_s = reinterpret_cast<float*>(smem_raw);
  float* const k_s = q_s + ROWS * LD;      // two K tiles
  float* const v_s = k_s + 2 * KV_TILE;    // two V tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Lanes L(lane);
  int bh, qt;
  bh_tile(true, bh, qt);  // the heaviest causal tile first
  const int b = bh / H, h = bh % H;
  const int q0 = qt * ROWS;
  const float* qb = q + b * sq.b + h * sq.h;
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

  cp_async_tile_f32<D, NTH>(smem_u32(q_s), qb, sq.s, q0, ROWS, S, tid);
  cp_async_tile_f32<D, NTH>(smem_u32(k_s), kb, sk.s, kt_begin * BKV, BKV,
                            S, tid);
  cp_async_tile_f32<D, NTH>(smem_u32(v_s), vb, sv.s, kt_begin * BKV, BKV,
                            S, tid);
  cp_async_commit();
  // Q * scale in fp32, where the reference applies the scale: each thread
  // scales the 16-byte chunks it copied once they have landed; a barrier
  // publishes them
  cp_async_wait<0>();
  for (int idx = tid; idx < ROWS * (D / 4); idx += NTH) {
    float4* p = reinterpret_cast<float4*>(q_s + (idx / (D / 4)) * LD +
                                          4 * (idx % (D / 4)));
    float4 x = *p;
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *p = x;
  }

  const int wr0 = 16 * warp;       // the warp's first row in Q
  const int wq0 = q0 + wr0;        // and in the sequence
  // running max and sum of the thread's rows g and g + 8 (the sum this
  // thread's part: the quad's four parts add up at the end), and the
  // warp's rows of O in product_acc's layout
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
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

    // S = (Q * scale) K^T
    float sc[BKV / 8][4];
    product_nt<D, BKV, fwd_tf_unroll<D>()>(sc, q_s, kbuf, wr0, L);

    // the reference's _NEG where the diagonal or the window's edge
    // crosses the warp's part of the tile
    if (causal && (k0 + BKV - 1 > wq0 ||
                   (window > 0 && k0 < wq0 + 15 - window + 1))) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(wq0 + L.g + 8 * (e >> 1),
                       k0 + 8 * j + 2 * L.t + (e & 1), causal, window))
            sc[j][e] = NEG;
    }

    // online softmax, the reference's rule, on the accumulator fragment:
    // each row's max over the quad that holds it, P = exp(S - m) in
    // registers, O and the sum rescaled by exp(m_prev - m). A row whose
    // every key so far was masked has m = NEG and sums a 1 per masked
    // key, wiped by exp(NEG - m_real) = 0 once a visible key arrives.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_r[r];
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2_approx((m_r[r] - mx) * LOG2E);
      m_r[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2_approx((sc[j][2 * r + c] - mx) * LOG2E);
          sc[j][2 * r + c] = p;
          sum += p;
        }
      l_r[r] = l_r[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator is the A operand as it stands
    product_acc<D, BKV / 8>(acc, sc, vbuf, L);
  }
  cp_async_wait<0>();  // no copy in flight when the block ends

  // o = O / l (divided, as the reference divides), lse = m + log l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][2 * r] /= l;
      acc[j][2 * r + 1] /= l;
    }
    const int qp = wq0 + L.g + 8 * r;
    if (L.t == 0 && qp < S) lse[(long long)bh * S + qp] = m_r[r] + logf(l);
  }
  store_acc_f32<D>(acc, 1.f, o + b * so.b + h * so.h, so.s, wq0, S, L);
}

// rows a warp: 32 at d 64 (two 16-row blocks share each K and V
// fragment: half the ldmatrix traffic a FLOP), 16 above, where the
// accumulators of 32 rows would not fit in 255 registers
template <int D> constexpr int mma_mb() { return D == 64 ? 2 : 1; }

struct Args {  // one forward call's arguments
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, S;
  Strides sq, sk, sv, so;
  int causal;
  float scale;
  int window;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_mma(const Args& a) {
  constexpr int MB = mma_mb<D>();
  constexpr int bytes = mma_smem_bytes<D>();
  static bool attr_set = false;  // dynamic shared memory above 48 KB
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D, MB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  using bf = __nv_bfloat16;
  dim3 grid(a.B * a.H, (a.S + MQ - 1) / MQ);
  flash_fwd_mma_kernel<D, MB><<<grid, mma_threads<MB>(), bytes, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<bf*>(a.o), a.lse, a.H, a.S,
      a.sq, a.sk, a.sv, a.so, a.causal, a.scale, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const Args& a) {
  constexpr int bytes = fwd_tf32_smem_bytes<D>();
  static bool attr_set = false;  // dynamic shared memory above 48 KB
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tf32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  constexpr int rows = fwd_tf_rows<D>();
  const dim3 grid(a.B * a.H, (a.S + rows - 1) / rows);
  flash_fwd_tf32_kernel<D><<<grid, tf_threads<rows>(), bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.H,
      a.S, a.sq, a.sk, a.sv, a.so, a.causal, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T, bool RES, int WGS>
cudaError_t launch_stream_res(const Args& a, int D, const Groups& gr) {
  static bool attr_set = false;  // dynamic shared memory above 48 KB
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_stream_kernel<T, RES, WGS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ST_SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(a.B * a.H * ((gr.G + WGS - 1) / WGS), a.S / ST_ROWS);
  flash_fwd_stream_kernel<T, RES, WGS>
      <<<grid, ST_THREADS * WGS, fwd_st_smem<T, RES, WGS>(D), a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.H, a.S,
          D, gr.G, gr.WG, a.sq, a.sk, a.sv, a.so, a.causal, a.scale,
          a.window);
  return cudaGetLastError();
}

// Design (a) keeps the query chunk tiles resident where `resident` says;
// (b), one block an SM whatever it does, wherever they fit: in bf16 always
// up to head_dim 512, in fp32 up to 448.
template <typename T>
cudaError_t launch_stream(const Args& a, int D) {
  const Groups gr = groups_of(D, fwd_st_wmax<T, 1>());
  const long long bhg = (long long)a.B * a.H * gr.G;
  if (bhg > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long blocks = bhg * (a.S / ST_ROWS);  // design (a)'s grid
  if (warpgroups(gr.G, D, blocks) == 2) {
    const Groups g2 = groups_of(D, fwd_st_wmax<T, 2>());
    if constexpr (sizeof(T) == 2)
      return launch_stream_res<T, true, 2>(a, D, g2);
    else
      return fwd_st_smem<T, true, 2>(D) <= ST_SMEM_MAX
                 ? launch_stream_res<T, true, 2>(a, D, g2)
                 : launch_stream_res<T, false, 2>(a, D, g2);
  }
  return resident(blocks, fwd_st_smem<T, true, 1>(D))
             ? launch_stream_res<T, true, 1>(a, D, gr)
             : launch_stream_res<T, false, 1>(a, D, gr);
}

// every view's pointer and (b, s, h) steps 16-byte aligned
bool views_aligned16(const Args& a, int bytes) {
  return aligned16(a.q, a.sq, a.B, a.H, bytes) &&
         aligned16(a.k, a.sk, a.B, a.H, bytes) &&
         aligned16(a.v, a.sv, a.B, a.H, bytes) &&
         aligned16(a.o, a.so, a.B, a.H, bytes);
}

// the route by type and head dim: 1 (mma.sync) for bf16 up to 256, 4
// (TF32, three passes) for fp32 at 64 and 128, else 3 (streaming)
int route_of(int dtype, int D) {
  if (dtype == 1 && D <= 256) return 1;
  if (dtype == 0 && (D == 64 || D == 128)) return 4;
  return 3;
}

template <int D>
cudaError_t launch_fixed(const Args& a, int route) {
  if constexpr (D == 64 || D == 128)
    if (route == 4) return launch_tf32<D>(a);
  return launch_mma<D>(a);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. Every
// pointer and (b, s, h) stride must be 16-byte aligned. *route is set to
// the kernel it launches, or refuses to (1 mma.sync, 3 streaming, 4 the
// TF32 three-pass kernel).
// Returns a cudaError_t: cudaErrorInvalidValue for arguments the kernel
// does not take, else the launch's own error.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int H, int S, int D, long long q_sb,
              long long q_ss, long long q_sh, long long k_sb, long long k_ss,
              long long k_sh, long long v_sb, long long v_ss, long long v_sh,
              long long o_sb, long long o_ss, long long o_sh, int causal,
              float scale, int window, int dtype, void* stream, int* route) {
  // b * h rides on gridDim.x, the query tiles on gridDim.y
  if (B < 1 || H < 1 || S < 64 || S % 64 != 0 ||
      (long long)B * H > 0x7fffffffLL || S / 64 > 65535 ||
      (dtype != 0 && dtype != 1) || (window > 0 && !causal) ||
      route == nullptr)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, H, S,
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
               {o_sb, o_ss, o_sh}, causal, scale, window,
               static_cast<cudaStream_t>(stream)};
  if (D < 64 || D % 64 != 0)
    return cudaErrorInvalidValue;  // a head_dim the kernels have no tiling for
  *route = route_of(dtype, D);
  if (!views_aligned16(a, dtype == 0 ? 4 : 2)) return cudaErrorInvalidValue;
  switch (*route) {
    case 1:
    case 4:
      switch (D) {
        case 64: return launch_fixed<64>(a, *route);
        case 128: return launch_fixed<128>(a, *route);
        case 192: return launch_fixed<192>(a, *route);
        default: return launch_fixed<256>(a, *route);
      }
  }
  return dtype == 0 ? launch_stream<float>(a, D)
                    : launch_stream<__nv_bfloat16>(a, D);
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
