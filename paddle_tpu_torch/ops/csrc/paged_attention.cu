// Block-table decode attention for Hopper (sm_90a), with a plain C interface
// for ctypes (built by paddle_tpu_torch/ops/_build.py).
//
// Replaces: paddle_tpu/ops/tpp.py `_paged_attention_kernel` (:251), the
// Pallas TPU kernel behind `paged_attention`. One query a row, over a KV
// cache kept in a pool of fixed-size frames:
//
//     q [B, H, hd]; kp, vp [NB, H, bs, hd] (a frame stride of our own, so
//     one layer of the serving pool [NB, L, H, bs, hd] goes in as a view);
//     tables int32 [B, maxb]; lengths int32 [B];
//     K[b, h, j*bs + r] = kp[tables[b, j], h, r] (times k_scales[...] for
//     int8 pages, f32 [NB, H, bs, 1], one scale a row); V likewise;
//     out[b, h] = softmax over c < lengths[b] of (q[b, h] . K[b, h, c] /
//     sqrt(hd)) . V[b, h, c], accumulated in f32, in q's dtype; a row of
//     length 0 gives zeros.
//
// Types: q f32, bf16 or f16 (read and written through a runtime switch: q
// is read once a block and out written once); pages f32, bf16 or f16 of
// any of q's types, or int8 with f32 scales. Every sum is in f32, as the
// reference casts q and the pages to f32.
//
// What bounds it: bytes. Each valid column's K and V row is read once (at
// GPT-2 small's full length, 8 rows x 1024 columns x 12 heads x 64: 25.2 MB
// of bf16 pages a layer, 7.5 us at 3.35 TB/s); the operations (4 a column
// and dim) are ~1% of that time at the f32 rate. So the design is about
// keeping enough 16-byte loads in flight on every SM.
//
// Design (flash-decoding). The TPU kernel walks a (b, j) grid in order, the
// table scalar-prefetched so each step's BlockSpec fetches the frame, and
// carries the online-softmax state (m, l, acc) in VMEM scratch from step to
// step. Here each row's frames are cut into splits of `fps` frames, and the
// grid is (b, h, split), one 128-thread block each; the host picks fps from
// B, H, bs and maxb alone so that the grid holds at least two waves of the
// 132 SMs (8 x 12 rows of 64 frames: 8 frames a split, 768 blocks).
//  - A block first reads its split's table entries into shared memory
//    once, beside the row's length and q; a split that starts at or past
//    its row's length writes m = -inf, l = 0 and exits. Columns past the
//    length are never read.
//  - The lanes of a warp split into groups of `lpr` lanes, one column a
//    group: each lane loads 16 bytes of the column's K row and 16 of its V
//    row (bf16 at hd 64: 8 lanes a 128-byte row, 4 columns a warp step;
//    fp32 16 lanes; int8 4), forms its part of q . k and the group reduces
//    the dot by xor shuffles. An int8 row's scale multiplies the dot once,
//    and p once before p . v.
//  - Each warp step issues the K and V loads of U columns a group before
//    any of their math, so U * 32 bytes a lane are in flight.
//  - Each group keeps its own online state (m, l, acc over its lanes'
//    dims): no barrier a frame. At the end of the split the groups of a
//    warp merge by shuffles and the warps through shared memory, once.
//  - The split writes its partial (m, l, acc[hd]) in fp32 to a workspace;
//    `paged_combine_kernel` merges a row's splits in split order with the
//    reference's rules (a max of -inf subtracts 0; l == 0 divides by 1).
//    With one split the block writes the output itself. Every sum is taken
//    in a fixed order: two calls give the same bits.
// Views that are not 16-byte aligned (a row of hd * sizeof(page) bytes that
// is no multiple of 16, or a misaligned frame stride or pointer) take the
// same kernel with one element a load.
//
// The stream route takes what the split kernel's registers and shared
// memory cannot: head dims above MAX_HD, frames above MAX_BS columns and
// more than 131,072 frames a row (`paged_ring_kernel`, see its notes). Same
// part workspace and the same combine pass.

#include <cuda_fp16.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::bulk_load;
using hopper::cp_async4;
using hopper::cp_async_mbar_arrive;
using hopper::fence_proxy_async_smem;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_expect_tx_only;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::to_f;
using hopper::unpack_bf16;
using hopper::warp_sum;

__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// q and out by the runtime dtype: 0 f32, 1 bf16, 2 f16
__device__ __forceinline__ float load_q(const void* q, int qdt, long long i) {
  if (qdt == 0) return static_cast<const float*>(q)[i];
  if (qdt == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
  return __half2float(static_cast<const __half*>(q)[i]);
}
__device__ __forceinline__ void store_o(void* o, int qdt, long long i,
                                        float v) {
  if (qdt == 0)
    static_cast<float*>(o)[i] = v;
  else if (qdt == 1)
    static_cast<__nv_bfloat16*>(o)[i] = __float2bfloat16(v);
  else
    static_cast<__half*>(o)[i] = __float2half_rn(v);
}

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int MAX_HD = 256;
constexpr int MAX_BS = 256;
constexpr int MAX_FPS = 128;  // frames a split: the host picks at most this
constexpr int U = 4;          // columns a group loads before their math
constexpr int NT_COMBINE = 64;
constexpr int MAX_SPLITS = 1024;  // splits a row: the host picks at most this
constexpr float NEG_INF = -INFINITY;

// CH elements of a page row from one load: 16 bytes, or one element
template <typename PT, int CH>
using Raw = typename std::conditional<CH == 1, PT, uint4>::type;

template <typename PT, int CH>
__device__ __forceinline__ void unpack(const Raw<PT, CH>& r, float (&x)[CH]) {
  if constexpr (CH == 1) {
    x[0] = to_f(r);
  } else {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same<PT, float>::value) {
        x[i] = __uint_as_float(w[i]);
      } else if constexpr (std::is_same<PT, __nv_bfloat16>::value) {
        const float2 f = unpack_bf16(w[i]);
        x[2 * i] = f.x, x[2 * i + 1] = f.y;
      } else if constexpr (std::is_same<PT, __half>::value) {
        const float2 f =
            __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
        x[2 * i] = f.x, x[2 * i + 1] = f.y;
      } else {  // int8: sign-extend each byte
#pragma unroll
        for (int k = 0; k < 4; ++k)
          x[4 * i + k] = static_cast<float>(
              static_cast<int>(w[i] << (24 - 8 * k)) >> 24);
      }
    }
  }
}

// One (b, h, split): the partial softmax state of the split's columns.
// part, for row bh: m [nsplit], l [nsplit], acc [nsplit][hd].
template <typename PT, bool QUANT, int CH, int CPL>
__global__ void __launch_bounds__(NT)
    paged_split_kernel(const void* __restrict__ q, const PT* __restrict__ kp,
                       const PT* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, void* __restrict__ out,
                       float* __restrict__ part, int qdt, int H, int hd,
                       int bs, int maxb, int fps, int nsplit,
                       long long frame_stride, long long scale_stride,
                       float scale) {
  __shared__ int tab[MAX_FPS];
  __shared__ float wm[NW], wl[NW];
  __shared__ float wacc[NW][MAX_HD];
  const int split = blockIdx.x % nsplit;
  const int bh = blockIdx.x / nsplit;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = split * fps * bs;  // the split's first column
  // the split's table entries, read with the length and not after it (an
  // entry past the length is never used)
  const int f_end = min(fps, maxb - split * fps);
  for (int i = tid; i < f_end; i += NT)
    tab[i] = tables[(long long)b * maxb + split * fps + i];
  const int len = lengths[b];
  float* pb = part + (long long)bh * nsplit * (hd + 2);
  if (c0 >= len) {  // nothing of this row in the split
    if (nsplit > 1) {
      if (tid == 0) {
        pb[split] = NEG_INF;
        pb[nsplit + split] = 0.f;
      }
    } else {
      for (int d = tid; d < hd; d += NT)
        store_o(out, qdt, (long long)bh * hd + d, 0.f);
    }
    return;
  }
  const int ncols = min(len - c0, fps * bs);

  // lane roles: lpr lanes a column (a power of two covering the row's
  // chunks, CPL chunks a lane), 32 / lpr columns a warp step
  const int nch = (hd + CH - 1) / CH;
  int lpr = 1;
  while (lpr < nch && lpr < 32) lpr <<= 1;
  const int cpw = 32 / lpr;
  const int sub = lane & (lpr - 1), grp = lane / lpr;

  float qv[CPL][CH], acc[CPL][CH];
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      const int d = (sub + i * lpr) * CH + e;
      qv[i][e] = d < hd ? load_q(q, qdt, (long long)bh * hd + d) : 0.f;
      acc[i][e] = 0.f;
    }
  float m = NEG_INF, l = 0.f;
  const long long head = (long long)h * bs;
  __syncthreads();

  for (int base = 0; base < ncols; base += U * NW * cpw) {
    Raw<PT, CH> kr[U][CPL], vr[U][CPL];
    float sk[U], sv[U];
    bool ok[U];
    // every load of the step first
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + (u * NW + warp) * cpw + grp;
      ok[u] = c < ncols;
      sk[u] = sv[u] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) kr[u][i] = vr[u][i] = Raw<PT, CH>{};
      if (ok[u]) {
        const int fi = c / bs, r = c - fi * bs;
        const long long frame = tab[fi];
        const long long row = frame * frame_stride + (head + r) * hd;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int cid = sub + i * lpr;
          if (cid < nch) {
            kr[u][i] = *reinterpret_cast<const Raw<PT, CH>*>(kp + row +
                                                              cid * CH);
            vr[u][i] = *reinterpret_cast<const Raw<PT, CH>*>(vp + row +
                                                              cid * CH);
          }
        }
        if constexpr (QUANT) {
          const long long so = frame * scale_stride + head + r;
          sk[u] = ks[so];
          sv[u] = vs[so];
        }
      }
    }
    // scores: this lane's part of each dot, then the group's sum
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float kx[CH];
        unpack<PT, CH>(kr[u][i], kx);
#pragma unroll
        for (int e = 0; e < CH; ++e) dot = fmaf(qv[i][e], kx[e], dot);
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if constexpr (QUANT) dot *= sk[u];
      s[u] = ok[u] ? dot * scale : NEG_INF;
    }
    // online softmax over the step's columns
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u]);
    const float ms = mx > NEG_INF ? mx : 0.f;
    const float alpha = expf(m - ms);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int e = 0; e < CH; ++e) acc[i][e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = expf(s[u] - ms);  // 0 for a column past the length
      l += p;
      const float pv = QUANT ? p * sv[u] : p;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float vx[CH];
        unpack<PT, CH>(vr[u][i], vx);
#pragma unroll
        for (int e = 0; e < CH; ++e) acc[i][e] = fmaf(pv, vx[e], acc[i][e]);
      }
    }
    m = mx;
  }

  // merge the warp's groups (lanes sub, sub + lpr, ...) by shuffles
  for (int o = lpr; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mx = fmaxf(m, mo);
    const float ms = mx > NEG_INF ? mx : 0.f;
    const float a = expf(m - ms), c = expf(mo - ms);
    l = l * a + lo * c;
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int e = 0; e < CH; ++e)
        acc[i][e] = acc[i][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[i][e], o) * c;
    m = mx;
  }
  // then the warps, in order, through shared memory
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        const int d = (sub + i * lpr) * CH + e;
        if (d < hd) wacc[warp][d] = acc[i][e];
      }
    if (lane == 0) {
      wm[warp] = m;
      wl[warp] = l;
    }
  }
  __syncthreads();
  float M = NEG_INF;
#pragma unroll
  for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w]);
  const float ms = M > NEG_INF ? M : 0.f;
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) L += wl[w] * expf(wm[w] - ms);
  for (int d = tid; d < hd; d += NT) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += wacc[w][d] * expf(wm[w] - ms);
    if (nsplit == 1)
      store_o(out, qdt, (long long)bh * hd + d, a / (L == 0.f ? 1.f : L));
    else
      pb[2 * nsplit + split * hd + d] = a;
  }
  if (nsplit > 1 && tid == 0) {
    pb[split] = M;
    pb[nsplit + split] = L;
  }
}

// One (b, h) and NT_COMBINE of its head dims (grid (B H, hd chunks)): the
// splits' partials merged in split order. A split with m = -inf (past the
// row's length) adds nothing; a row with no column gives zeros. The
// splits' (m, l) land in shared memory first, read in parallel, and each
// split's weight is taken once a block; a thread sums one head dim.
__global__ void __launch_bounds__(NT_COMBINE)
    paged_combine_kernel(const float* __restrict__ part, void* __restrict__ out,
                         int qdt, int hd, int nsplit) {
  __shared__ float sm[MAX_SPLITS], sw[MAX_SPLITS];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const float* pb = part + (long long)bh * nsplit * (hd + 2);
  for (int s = tid; s < nsplit; s += NT_COMBINE) {
    sm[s] = pb[s];
    sw[s] = pb[nsplit + s];  // l, until the weights replace it
  }
  __syncthreads();
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, sm[s]);
  const float ms = M > NEG_INF ? M : 0.f;
  float L = 0.f;
  for (int s = 0; s < nsplit; ++s)
    if (sm[s] > NEG_INF) L += sw[s] * expf(sm[s] - ms);
  __syncthreads();  // every l read
  for (int s = tid; s < nsplit; s += NT_COMBINE)
    sw[s] = sm[s] > NEG_INF ? expf(sm[s] - ms) : 0.f;
  __syncthreads();
  const float denom = L == 0.f ? 1.f : L;
  const float* acc = pb + 2 * nsplit;
  const int d = blockIdx.y * NT_COMBINE + tid;
  if (d < hd) {
    float a = 0.f;
#pragma unroll 16
    for (int s = 0; s < nsplit; ++s)
      if (sw[s] != 0.f) a += acc[s * hd + d] * sw[s];
    store_o(out, qdt, (long long)bh * hd + d, a / denom);
  }
}

// ---- the stream route ------------------------------------------------------
//
// `paged_ring_kernel`: one block a (b, h, split), where a split is a range
// of `cols` columns of the row's logical cache whose ends may fall inside a
// frame. The host picks `cols` from B, H, bs and maxb alone (tpp.py
// `_paged_stream_splits`) so that the grid holds two waves of the 132 SMs
// wherever the columns allow it (B 8, H 4, 4 frames of 512: 128 columns a
// split, 16 splits a row, 512 blocks).
//
// What bounds it: bytes, as on the split route (4 operations a column and
// dim against 2 hd bytes of bf16 K and V; a column is 2 KB at hd 512), so
// the design moves each K and V byte once with enough of them in flight,
// and keeps the math of one tile off the path of the next tile's bytes:
//  - RING (page rows of at most RING_MAX_ROW bytes; rows, frame stride and
//    pointers on 16 bytes): K and V arrive in tiles of at most `tc` columns
//    that never cross a frame, so a tile is one contiguous range of K and
//    one of V (`kp[frame, h, r0:r1, :]`), one 1-D bulk copy each
//    (cp.async.bulk) into a ring of STAGES slots in shared memory,
//    completing on the slot's full mbarrier. A producer warp issues them:
//    it refills a slot as soon as the four consumer warps have arrived on
//    its empty mbarrier. An int8 tile's row scales come with it, copied by
//    the producer's lanes with 4-byte cp.async onto the same full barrier.
//    The host sizes tc (tpp._paged_ring) so that a slot's K and V hold
//    about 32 KB (hd 512: 16 columns bf16, 8 fp32, 32 int8), STAGES (two)
//    slots deep: two or three blocks an SM.
//  - The length, the first table entries and q are asked for together; q
//    lands in shared memory in fp32 while the first tiles are in flight.
//  - The consumers' lanes form groups of lpr lanes over a row's 16-byte
//    chunks (32 lanes from hd 128 bf16 up; hd 64 bf16: 8 lanes, four groups
//    a warp), and group g takes the tile's columns g, g + G, ..., UB at a
//    time: one read of q's chunk from shared memory serves UB columns, each
//    group sums its dots by xor shuffles (every lane gets the same bits),
//    and the group updates its own online softmax state (m, l) and its
//    accumulator, hd / lpr floats a lane, in registers up to ACC_REGS
//    floats (hd 2,048), past that in shared memory. No barrier a tile: a
//    warp waits on the slot's full barrier and arrives on its empty one.
//  - Table entries: the producer alone reads them. Its lanes hold those of
//    the 32 frames from the split's first, read by one coalesced load and
//    handed out by shuffles; a split that spans more frames reads the next
//    32 when it gets there.
//  - At the end of the split the G groups merge once, in group order,
//    through shared memory, and the split writes (m, l, acc) to `part` once
//    (with one split, out itself).
//  - DIRECT (a row, frame stride or pointer off 16 bytes, or rows above
//    RING_MAX_ROW): the same grid, online softmax and end, with one element
//    a load from global memory: a warp a column forms the scores of a tile
//    of DIRECT_TC columns (with each column's row offset and table entry),
//    one __syncthreads, then every thread updates its own head dims of the
//    accumulator, in registers: the dims are cut into slices of DIRECT_DS
//    on a grid axis (each slice forms the scores whole and reads its part
//    of V), so any hd keeps it on chip.
// The C entry picks RING or DIRECT from the view (`dispatch`) and reports
// the one it launched. Every sum is taken in a fixed order: two calls give
// the same bits.
constexpr int RING_MAX_ROW = 8192;  // bytes of a page row on the RING path
constexpr int STAGES = 2;           // slots of the ring
constexpr int RW = 4;               // consumer warps of the RING path
constexpr int RT = RW * 32;         // (and one producer warp)
constexpr int UB = 4;               // columns a lane group takes at once
constexpr int ACC_REGS = 64;        // accumulator floats a lane in registers
constexpr int DIRECT_TC = 32;       // columns a tile on the DIRECT path
constexpr int DIRECT_KD = 8;        // head dims a thread on the DIRECT path
constexpr int DIRECT_DS = NT * DIRECT_KD;  // head dims a slice
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block

// the least power of two >= n, at most cap
__host__ __device__ __forceinline__ int lanes_over(int n, int cap) {
  int p = 1;
  while (p < n && p < cap) p <<= 1;
  return p;
}

// the RING path's lane groups: lpr lanes a group over a row's nch 16-byte
// chunks, RW * 32 / lpr groups a block
__host__ __device__ __forceinline__ int ring_groups(int nch) {
  return RW * (32 / lanes_over(nch, 32));
}

// the RING path's dynamic shared memory: the ring (reused after the loop
// for the groups' merge), q in fp32, the slots' scales, the groups'
// accumulators where they live in shared memory, the slots' mbarriers
// (full, then empty)
struct RingLayout {
  int row, slot, q_off, scale_off, acc_off, bar_off, total;
};
__host__ __device__ __forceinline__ RingLayout ring_layout(int hd, int item,
                                                           int tc,
                                                           bool quant,
                                                           bool smem_acc) {
  RingLayout L;
  L.row = hd * item;
  L.slot = 2 * tc * L.row;
  const int groups = ring_groups(L.row / 16);
  const int merge = groups * 8 + (smem_acc ? 0 : groups * hd * 4);
  const int ring = STAGES * L.slot;
  L.q_off = ((ring > merge ? ring : merge) + 15) & ~15;
  L.scale_off = L.q_off + ((hd * 4 + 15) & ~15);
  L.acc_off = L.scale_off + (quant ? 2 * STAGES * tc * 4 : 0);
  L.bar_off = (L.acc_off + (smem_acc ? groups * hd * 4 : 0) + 7) & ~7;
  L.total = L.bar_off + 16 * STAGES;
  return L;
}

// a walk over a split's tiles: each at most tc columns, inside one frame
// and inside the split's ncols; t the split column a tile starts at, r its
// row in its frame, f its frame's index in the row (32-bit: every column
// lies below a length)
struct Walk {
  int t, r, f;
  __device__ __forceinline__ int cols(int ncols, int bs, int tc) const {
    return min(min(tc, ncols - t), bs - r);
  }
  __device__ __forceinline__ void next(int nt, int bs) {
    t += nt;
    r += nt;
    if (r == bs) r = 0, ++f;
  }
};

struct Split {  // one block's split
  int b, h, bh, split, ncols, c0;
};

// the split's end: element d of its accumulator `a` (with one split, out
// = a / l, else a into the split's slot of part)
__device__ __forceinline__ void put(const Split& s, void* out, float* part,
                                    int qdt, int hd, int nsplit, int d,
                                    float a, float l) {
  if (nsplit == 1)
    store_o(out, qdt, (long long)s.bh * hd + d, a / (l == 0.f ? 1.f : l));
  else
    part[(long long)s.bh * nsplit * (hd + 2) + 2 * nsplit +
         (long long)s.split * hd + d] = a;
}
__device__ __forceinline__ void put_ml(const Split& s, float* part, int hd,
                                       int nsplit, float m, float l) {
  if (nsplit == 1) return;
  float* pb = part + (long long)s.bh * nsplit * (hd + 2);
  pb[s.split] = m;
  pb[nsplit + s.split] = l;
}
// a split that starts at or past its row's length: m = -inf, l = 0 (with
// one split, zeros in head dims d0 .. d1 of out)
__device__ __forceinline__ void put_empty(const Split& s, void* out,
                                          float* part, int qdt, int hd,
                                          int nsplit, int d0, int d1) {
  if (nsplit > 1) {
    if (threadIdx.x == 0 && blockIdx.y == 0)
      put_ml(s, part, hd, nsplit, NEG_INF, 0.f);
  } else {
    for (int d = d0 + threadIdx.x; d < d1; d += blockDim.x)
      store_o(out, qdt, (long long)s.bh * hd + d, 0.f);
  }
}

// the RING path's consumer warps (at the start and the end of a split)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(RT) : "memory");
}

// CPL: 16-byte chunks of the accumulator a lane holds in registers, or 0
// for a group accumulator in shared memory (rows past ACC_REGS floats a
// lane: hd above 2,048)
template <typename PT, bool QUANT, int CPL>
__device__ __forceinline__ void ring_split(
    Split s, int c0, int len, int cols, const void* __restrict__ q,
    const PT* __restrict__ kp, const PT* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ tables, void* __restrict__ out,
    float* __restrict__ part, int qdt, int hd, int bs, int maxb, int nsplit,
    int tc, long long frame_stride, long long scale_stride, float scale,
    unsigned char* smem) {
  constexpr int CH = 16 / sizeof(PT);
  constexpr bool SMEM_ACC = CPL == 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the producer warp: the table entries of 32 frames from the split's
  // first, asked for beside the length
  int fw = c0 / bs, went = 0;
  if (warp == RW && fw + lane < maxb)
    went = tables[(long long)s.b * maxb + fw + lane];
  if (c0 >= len) {  // nothing of this row in the split
    put_empty(s, out, part, qdt, hd, nsplit, 0, hd);
    return;
  }
  s.c0 = c0;
  s.ncols = min(len - c0, cols);
  const RingLayout L = ring_layout(hd, sizeof(PT), tc, QUANT, SMEM_ACC);
  const int nch = hd / CH, row = L.row, ncols = s.ncols;
  const Walk w0{0, s.c0 % bs, s.c0 / bs};
  float* qs = reinterpret_cast<float*>(smem + L.q_off);
  // the slots' scales, [STAGES][2][tc]
  float* ssc = reinterpret_cast<float*>(smem + L.scale_off);
  const uint32_t ring0 = smem_u32(smem);
  const uint32_t full0 = smem_u32(smem + L.bar_off);
  const uint32_t empty0 = full0 + 8 * STAGES;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, QUANT ? 32 : 1);
      mbar_init(empty0 + 8 * i, RW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == RW) {  // the producer: tile k into slot k % STAGES
    Walk w = w0;
    for (int k = 0; w.t < ncols; ++k) {
      const int nt = w.cols(ncols, bs, tc), slot = k % STAGES;
      if (k >= STAGES)  // the consumers are done with tile k - STAGES
        mbar_wait(empty0 + 8 * slot, (k / STAGES - 1) & 1);
      if (w.f - fw >= 32) {  // the next 32 entries (the same in every lane)
        fw = w.f;
        went = fw + lane < maxb ? tables[(long long)s.b * maxb + fw + lane] : 0;
      }
      const long long frame = __shfl_sync(0xffffffffu, went, w.f - fw);
      const long long off =
          frame * frame_stride + ((long long)s.h * bs + w.r) * hd;
      const uint32_t bar = full0 + 8 * slot, bytes = (uint32_t)(nt * row);
      const uint32_t dst = ring0 + slot * L.slot;
      if (lane == 0) {
        fence_proxy_async_smem();  // the slot's earlier reads before the copy
        if constexpr (QUANT)
          mbar_expect_tx_only(bar, 2 * bytes);
        else
          mbar_expect_tx(bar, 2 * bytes);  // with this thread's arrival
        bulk_load(dst, kp + off, bytes, bar);
        bulk_load(dst + tc * row, vp + off, bytes, bar);
      }
      if constexpr (QUANT) {  // 32 arrivals, each after its lane's copies
        const long long so =
            frame * scale_stride + (long long)s.h * bs + w.r;
        const uint32_t ds = smem_u32(ssc + slot * 2 * tc);
        for (int j = lane; j < nt; j += 32) {
          cp_async4(ds + 4 * j, ks + so + j);
          cp_async4(ds + 4 * (tc + j), vs + so + j);
        }
        cp_async_mbar_arrive(bar);
      }
      w.next(nt, bs);
    }
    return;
  }

  // the consumers: lane group grp takes the tile's columns grp, grp + G,
  // ..., UB at a time, with its own online softmax state and accumulator
  const int lpr = lanes_over(nch, 32), G = ring_groups(nch);
  const int grp = warp * (32 / lpr) + lane / lpr, sub = lane & (lpr - 1);
  // chunks a lane: at most NI, every loop over them unrolled (rows of at
  // most RING_MAX_ROW bytes have at most 16 a lane)
  constexpr int NI = SMEM_ACC ? RING_MAX_ROW / 16 / 32 : CPL;
  float* accs = reinterpret_cast<float*>(smem + L.acc_off) + grp * hd;
  float acc[SMEM_ACC ? 1 : CPL][CH];
  if constexpr (SMEM_ACC) {
    for (int c = sub; c < nch; c += lpr)
#pragma unroll
      for (int e = 0; e < CH; ++e) accs[c * CH + e] = 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int e = 0; e < CH; ++e) acc[i][e] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  for (int d = tid; d < hd; d += RT)
    qs[d] = load_q(q, qdt, (long long)s.bh * hd + d);
  consumers_sync();

  Walk w = w0;
  for (int k = 0; w.t < ncols; ++k) {
    const int nt = w.cols(ncols, bs, tc), slot = k % STAGES;
    const unsigned char* kt = smem + slot * L.slot;
    const unsigned char* vt = kt + tc * row;
    const float* scl = ssc + slot * 2 * tc;
    mbar_wait(full0 + 8 * slot, (k / STAGES) & 1);
    for (int base = 0; base < nt; base += G * UB) {  // the same in a warp
      float dot[UB];
#pragma unroll
      for (int u = 0; u < UB; ++u) dot[u] = 0.f;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int c = sub + i * lpr;
        if (c < nch) {
          float qx[CH];
#pragma unroll
          for (int e = 0; e < CH; e += 4) {
            const float4 f =
                *reinterpret_cast<const float4*>(qs + c * CH + e);
            qx[e] = f.x, qx[e + 1] = f.y, qx[e + 2] = f.z, qx[e + 3] = f.w;
          }
#pragma unroll
          for (int u = 0; u < UB; ++u) {
            const int j = base + grp + u * G;
            if (j < nt) {
              float kx[CH];
              unpack<PT, CH>(*reinterpret_cast<const uint4*>(
                                 kt + (size_t)j * row + c * 16),
                             kx);
#pragma unroll
              for (int e = 0; e < CH; ++e)
                dot[u] = fmaf(qx[e], kx[e], dot[u]);
            }
          }
        }
      }
      // every lane of the group gets the same sums (each xor step adds
      // the same two values in either lane)
      for (int o = lpr >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < UB; ++u)
          dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
      if (base + grp >= nt) continue;  // no column of this group here
      float sv[UB], mx = m;
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int j = base + grp + u * G;
        sv[u] = j < nt ? (QUANT ? dot[u] * scl[j] : dot[u]) * scale : NEG_INF;
        mx = fmaxf(mx, sv[u]);
      }
      const float ms = mx > NEG_INF ? mx : 0.f;
      const float alpha = expf(m - ms);
      float pv[UB];
      l *= alpha;
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int j = base + grp + u * G;
        pv[u] = expf(sv[u] - ms);  // 0 for a column past the tile
        l += pv[u];
        if (QUANT && j < nt) pv[u] *= scl[tc + j];
      }
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int c = sub + i * lpr;
        if (c < nch) {
          float a[CH];
#pragma unroll
          for (int e = 0; e < CH; ++e)
            a[e] = (SMEM_ACC ? accs[c * CH + e] : acc[SMEM_ACC ? 0 : i][e]) *
                   alpha;
#pragma unroll
          for (int u = 0; u < UB; ++u) {
            const int j = base + grp + u * G;
            if (j < nt) {
              float vx[CH];
              unpack<PT, CH>(*reinterpret_cast<const uint4*>(
                                 vt + (size_t)j * row + c * 16),
                             vx);
#pragma unroll
              for (int e = 0; e < CH; ++e) a[e] = fmaf(pv[u], vx[e], a[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < CH; ++e) {
            if constexpr (SMEM_ACC)
              accs[c * CH + e] = a[e];
            else
              acc[i][e] = a[e];
          }
        }
      }
      m = mx;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);  // this warp is done
    w.next(nt, bs);
  }

  // the groups merge, in group order, through shared memory
  consumers_sync();  // every read of the ring done (and every copy landed)
  float* gm = reinterpret_cast<float*>(smem);  // [G]
  float* gl = gm + G;                          // [G]
  float* ga = SMEM_ACC ? reinterpret_cast<float*>(smem + L.acc_off)
                       : gl + G;               // [G][hd]
  if (sub == 0) {
    gm[grp] = m;
    gl[grp] = l;
  }
  if constexpr (!SMEM_ACC) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = sub + i * lpr;
      if (c < nch)
#pragma unroll
        for (int e = 0; e < CH; ++e) ga[grp * hd + c * CH + e] = acc[i][e];
    }
  }
  consumers_sync();
  float M = NEG_INF;
  for (int g = 0; g < G; ++g) M = fmaxf(M, gm[g]);
  const float ms = M > NEG_INF ? M : 0.f;
  float Ls = 0.f;
  for (int g = 0; g < G; ++g) Ls += gl[g] * expf(gm[g] - ms);
  for (int d = tid; d < hd; d += RT) {
    float a = 0.f;
    for (int g = 0; g < G; ++g) a += ga[g * hd + d] * expf(gm[g] - ms);
    put(s, out, part, qdt, hd, nsplit, d, a, Ls);
  }
  if (tid == 0) put_ml(s, part, hd, nsplit, M, Ls);
}

template <typename PT, bool QUANT>
__device__ __forceinline__ void direct_split(
    const Split& s, const void* __restrict__ q, const PT* __restrict__ kp,
    const PT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ tables,
    void* __restrict__ out, float* __restrict__ part, int qdt, int hd, int bs,
    int maxb, int nsplit, long long frame_stride, long long scale_stride,
    float scale) {
  __shared__ float sc[2][DIRECT_TC], sw[2][DIRECT_TC];
  __shared__ long long roff[2][DIRECT_TC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.y * DIRECT_DS;
  const long long qo = (long long)s.bh * hd;
  float acc[DIRECT_KD];
#pragma unroll
  for (int i = 0; i < DIRECT_KD; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;
  for (int t0 = 0, k = 0; t0 < s.ncols; t0 += DIRECT_TC, ++k) {
    const int nt = min(DIRECT_TC, s.ncols - t0);
    float* sk = sc[k & 1];
    float* sv = sw[k & 1];
    long long* ro = roff[k & 1];
    // scores: a warp a column, its lanes over the head dim
    for (int j = warp; j < nt; j += NW) {
      const int c = s.c0 + t0 + j;
      const int fi = c / bs;
      const int r = c - fi * bs;
      const long long frame = tables[(long long)s.b * maxb + fi];
      const long long row =
          frame * frame_stride + ((long long)s.h * bs + r) * hd;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32)
        dot = fmaf(load_q(q, qdt, qo + d), to_f(kp[row + d]), dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        float w = 1.f;
        if constexpr (QUANT) {
          const long long so = frame * scale_stride + (long long)s.h * bs + r;
          dot *= ks[so];
          w = vs[so];
        }
        sk[j] = dot * scale;
        sv[j] = w;
        ro[j] = row;
      }
    }
    __syncthreads();  // the tile's scores; every thread is done with k - 1
    // every thread: the tile's weights, then its own head dims
    float mx = m;
    for (int j = 0; j < nt; ++j) mx = fmaxf(mx, sk[j]);
    const float ms = mx > NEG_INF ? mx : 0.f;
    const float alpha = expf(m - ms);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DIRECT_KD; ++i) acc[i] *= alpha;
    for (int j = 0; j < nt; ++j) {
      const float p = expf(sk[j] - ms);
      l += p;
      const float pv = QUANT ? p * sv[j] : p;
#pragma unroll
      for (int i = 0; i < DIRECT_KD; ++i) {
        const int d = d0 + tid + i * NT;
        if (d < hd) acc[i] = fmaf(pv, to_f(vp[ro[j] + d]), acc[i]);
      }
    }
    m = mx;
  }
  // every thread holds the same (m, l): its own dims go out
#pragma unroll
  for (int i = 0; i < DIRECT_KD; ++i) {
    const int d = d0 + tid + i * NT;
    if (d < hd) put(s, out, part, qdt, hd, nsplit, d, acc[i], l);
  }
  if (tid == 0 && blockIdx.y == 0) put_ml(s, part, hd, nsplit, m, l);
}

// The stream route's kernel: grid (B H nsplit, slices); RING or DIRECT
// (see the notes above). A split that starts at or past its row's length
// writes m = -inf, l = 0 (with one split, zeros) and exits.
// (a block an SM at the least: without it ptxas held the fp32 kernel of
// four chunks a lane to 56 registers and spilled 184 bytes)
template <typename PT, bool QUANT, int CPT, bool RING>
__global__ void __launch_bounds__(RT + 32, 1)
    paged_ring_kernel(const void* __restrict__ q, const PT* __restrict__ kp,
                      const PT* __restrict__ vp, const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ tables,
                      const int* __restrict__ lengths, void* __restrict__ out,
                      float* __restrict__ part, int qdt, int H, int hd, int bs,
                      int maxb, int cols, int nsplit, int tc,
                      long long frame_stride, long long scale_stride,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  Split s;
  s.split = blockIdx.x % nsplit;
  s.bh = blockIdx.x / nsplit;
  s.b = s.bh / H;
  s.h = s.bh - s.b * H;
  const int c0 = s.split * cols;  // below maxb * bs (the C entry's check)
  const int len = lengths[s.b];
  if constexpr (RING) {
    ring_split<PT, QUANT, CPT>(s, c0, len, cols, q, kp, vp, ks, vs, tables,
                               out, part, qdt, hd, bs, maxb, nsplit, tc,
                               frame_stride, scale_stride, scale, smem);
  } else {
    const int d0 = blockIdx.y * DIRECT_DS;
    if (c0 >= len) {  // nothing of this row in the split
      put_empty(s, out, part, qdt, hd, nsplit, d0, min(hd, d0 + DIRECT_DS));
      return;
    }
    s.c0 = c0;
    s.ncols = min(len - c0, cols);
    direct_split<PT, QUANT>(s, q, kp, vp, ks, vs, tables, out, part, qdt, hd,
                            bs, maxb, nsplit, frame_stride, scale_stride,
                            scale);
  }
}

struct Args {  // one call's arguments
  const void *q, *kp, *vp, *ks, *vs, *tables, *lengths;
  void* out;
  float* part;
  int qdt, B, H, hd, bs, maxb, cols, nsplit, tc;
  long long frame_stride, scale_stride;
  float scale;
  cudaStream_t stream;
};

cudaError_t combine(const Args& a) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  const dim3 grid(a.B * a.H, (a.hd + NT_COMBINE - 1) / NT_COMBINE);
  paged_combine_kernel<<<grid, NT_COMBINE, 0, a.stream>>>(
      a.part, a.out, a.qdt, a.hd, a.nsplit);
  return cudaGetLastError();
}

template <typename PT, bool QUANT, int CH, int CPL>
cudaError_t launch(const Args& a, unsigned blocks) {
  paged_split_kernel<PT, QUANT, CH, CPL><<<blocks, NT, 0, a.stream>>>(
      a.q, static_cast<const PT*>(a.kp), static_cast<const PT*>(a.vp),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      a.out, a.part, a.qdt, a.H, a.hd, a.bs, a.maxb, a.cols / a.bs, a.nsplit,
      a.frame_stride, a.scale_stride, a.scale);
  return combine(a);
}

template <typename PT, bool QUANT, int CPT, bool RING>
cudaError_t launch_stream(const Args& a, dim3 grid) {
  const auto kernel = paged_ring_kernel<PT, QUANT, CPT, RING>;
  int smem = 0;
  if constexpr (RING) {
    smem = ring_layout(a.hd, sizeof(PT), a.tc, QUANT, CPT == 0).total;
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
  }
  kernel<<<grid, RING ? RT + 32 : NT, smem, a.stream>>>(
      a.q, static_cast<const PT*>(a.kp), static_cast<const PT*>(a.vp),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      a.out, a.part, a.qdt, a.H, a.hd, a.bs, a.maxb, a.cols, a.nsplit, a.tc,
      a.frame_stride, a.scale_stride, a.scale);
  return combine(a);
}

// route 0 (split): 16-byte loads when every row of both page arrays
// starts on 16 bytes, else one element a load. Route 1 (stream): the RING
// path where it can copy the pages as they are (rows of at most
// RING_MAX_ROW bytes; rows, frame stride and pointers on 16 bytes; int8
// scales on 4 bytes), else the DIRECT path. *path: the kernel launched
// (0 split, 1 RING, 2 DIRECT)
template <typename PT, bool QUANT>
cudaError_t dispatch(const Args& a, int route, int* path) {
  const long long blocks = (long long)a.B * a.H * a.nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int CH = 16 / sizeof(PT);
  const bool vec = ((reinterpret_cast<uintptr_t>(a.kp) |
                     reinterpret_cast<uintptr_t>(a.vp)) & 15) == 0 &&
                   (a.frame_stride * (long long)sizeof(PT)) % 16 == 0 &&
                   (a.hd * sizeof(PT)) % 16 == 0;
  *path = 0;
  if (route == 1) {
    const bool ring =
        vec && a.hd * (long long)sizeof(PT) <= RING_MAX_ROW &&
        (!QUANT || ((reinterpret_cast<uintptr_t>(a.ks) |
                     reinterpret_cast<uintptr_t>(a.vs)) & 3) == 0);
    *path = ring ? 1 : 2;
    if (!ring) {
      const long long slices = (a.hd + DIRECT_DS - 1) / DIRECT_DS;
      if (slices > 65535) return cudaErrorInvalidValue;
      return launch_stream<PT, QUANT, 1, false>(
          a, dim3((unsigned)blocks, (unsigned)slices));
    }
    if (a.tc < 1) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)blocks);
    const int nch = a.hd / CH, cpl = (nch + 31) / 32;  // chunks a lane
    if (cpl <= 1) return launch_stream<PT, QUANT, 1, true>(a, grid);
    if (cpl <= 2) return launch_stream<PT, QUANT, 2, true>(a, grid);
    if (cpl <= 4) return launch_stream<PT, QUANT, 4, true>(a, grid);
    if constexpr (8 * CH <= ACC_REGS)
      if (cpl <= 8) return launch_stream<PT, QUANT, 8, true>(a, grid);
    if constexpr (16 * CH <= ACC_REGS)
      if (cpl <= 16) return launch_stream<PT, QUANT, 16, true>(a, grid);
    return launch_stream<PT, QUANT, 0, true>(a, grid);
  }
  if (!vec) return launch<PT, QUANT, 1, MAX_HD / 32>(a, (unsigned)blocks);
  if (a.hd / CH <= 32) return launch<PT, QUANT, CH, 1>(a, (unsigned)blocks);
  if constexpr (MAX_HD / CH > 32)
    return launch<PT, QUANT, CH, 2>(a, (unsigned)blocks);
  return cudaErrorInvalidValue;  // unreachable: hd <= MAX_HD
}

}  // namespace

extern "C" {

// q_dtype (q and out): 0 = f32, 1 = bf16, 2 = f16. page_dtype: 0 = f32,
// 1 = bf16, 2 = f16 (ks, vs unused), 3 = int8 with f32 row scales. route:
// 0 = the split kernel (hd <= 256, bs <= 256, cols a multiple of bs of at
// most 128 frames), 1 = the stream kernel (any hd, bs and view: its RING
// path, tiles of tc columns, where it can copy the pages as they are, else
// its DIRECT path). Strides are in elements. Each row's columns are cut
// into nsplit splits of `cols` columns (the last one starting below
// maxb * bs and ending at or past it; nsplit <= 1024);
// `part` is an fp32 workspace of B * H * nsplit * (hd + 2) values, needed
// with nsplit > 1. taken[0] gets the kernel launched (0 split, 1 the
// stream kernel's RING path, 2 its DIRECT path), taken[1] the ring's
// depth (0 off the RING path). Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernels do not take, else the
// launches' own error.
int paged_attention(const void* q, const void* kp, const void* vp,
                    const void* ks, const void* vs, const void* tables,
                    const void* lengths, void* out, void* part, int B, int H,
                    int hd, int bs, int maxb, int cols, int nsplit, int tc,
                    long long frame_stride, long long scale_stride,
                    float scale, int q_dtype, int page_dtype, int route,
                    void* stream, int* taken) {
  if (B < 1 || H < 1 || hd < 1 || bs < 1 || maxb < 1 || cols < 1 ||
      nsplit < 1 || nsplit > MAX_SPLITS ||
      (long long)cols * nsplit < (long long)maxb * bs ||
      (long long)cols * (nsplit - 1) >= (long long)maxb * bs ||
      (long long)maxb * bs > 0x7fffffffLL || q_dtype < 0 || q_dtype > 2 ||
      page_dtype < 0 || page_dtype > 3 || route < 0 || route > 1 ||
      (nsplit > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (route == 0 && (hd > MAX_HD || bs > MAX_BS || cols % bs != 0 ||
                     cols / bs > MAX_FPS))
    return cudaErrorInvalidValue;
  if (page_dtype == 3 && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, kp, vp, ks, vs, tables, lengths, out,
               static_cast<float*>(part), q_dtype, B, H, hd, bs, maxb, cols,
               nsplit, tc, frame_stride, scale_stride, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  switch (page_dtype) {
    case 0: e = dispatch<float, false>(a, route, taken); break;
    case 1: e = dispatch<__nv_bfloat16, false>(a, route, taken); break;
    case 2: e = dispatch<__half, false>(a, route, taken); break;
    default: e = dispatch<int8_t, true>(a, route, taken);
  }
  taken[1] = taken[0] == 1 ? STAGES : 0;
  return e;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
