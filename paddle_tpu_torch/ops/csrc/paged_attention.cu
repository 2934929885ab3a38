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
// The stream route (`paged_stream_kernel`) takes what the split kernel's
// registers and shared memory cannot: head dims above MAX_HD, frames above
// MAX_BS columns, and splits of more than MAX_FPS frames (over 131,072
// frames a row). Same grid and the same combine pass; a block walks its
// split's columns in tiles of TC: each warp forms the scores of its
// columns (lanes over the head dim, then a shuffle sum) into shared memory
// beside each column's row offset, every thread takes the tile's max and
// the block the tile's weights, and each thread then updates its own head
// dims of the accumulator, which lives in the split's fp32 slot of the
// workspace (hd floats, no cap) and never in shared memory. One element a
// load: a simple route for shapes no model of the repository has.

#include <cuda_fp16.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

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

// One (b, h): the splits' partials merged in split order. A split with
// m = -inf (past the row's length) adds nothing; a row with no column
// gives zeros. The splits' (m, l) land in shared memory first, read in
// parallel, and each split's weight is taken once.
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
  for (int d = tid; d < hd; d += NT_COMBINE) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s)
      if (sw[s] != 0.f) a += acc[s * hd + d] * sw[s];
    store_o(out, qdt, (long long)bh * hd + d, a / denom);
  }
}

// The stream route: one (b, h, split) a block, any hd, bs and fps (see the
// notes at the top). The split's accumulator is its slot of `part`, which
// the host always allocates on this route.
constexpr int TC = 32;  // columns a tile

template <typename PT, bool QUANT>
__global__ void __launch_bounds__(NT)
    paged_stream_kernel(const void* __restrict__ q, const PT* __restrict__ kp,
                        const PT* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        void* __restrict__ out, float* __restrict__ part,
                        int qdt, int H, int hd, int bs, int maxb, int fps,
                        int nsplit, long long frame_stride,
                        long long scale_stride, float scale) {
  __shared__ float sc[TC], pl[TC], pw[TC], svs[TC];
  __shared__ long long roff[TC];
  const int split = blockIdx.x % nsplit;
  const int bh = blockIdx.x / nsplit;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long c0 = (long long)split * fps * bs;
  const int len = lengths[b];
  float* pb = part + (long long)bh * nsplit * (hd + 2);
  float* acc = pb + 2 * nsplit + (long long)split * hd;
  const long long qo = (long long)bh * hd;
  if (c0 >= len) {  // nothing of this row in the split
    if (nsplit > 1) {
      if (tid == 0) {
        pb[split] = NEG_INF;
        pb[nsplit + split] = 0.f;
      }
    } else {
      for (int d = tid; d < hd; d += NT) store_o(out, qdt, qo + d, 0.f);
    }
    return;
  }
  const long long ncols = min((long long)len - c0, (long long)fps * bs);
  for (int d = tid; d < hd; d += NT) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;
  for (long long t0 = 0; t0 < ncols; t0 += TC) {
    const int nt = (int)min((long long)TC, ncols - t0);
    // scores: a warp a column, its lanes over the head dim
    for (int j = warp; j < nt; j += NW) {
      const long long c = c0 + t0 + j;
      const long long fi = c / bs;
      const long long r = c - fi * bs;
      const long long frame = tables[(long long)b * maxb + fi];
      const long long row = frame * frame_stride + ((long long)h * bs + r) * hd;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32)
        dot = fmaf(load_q(q, qdt, qo + d), to_f(kp[row + d]), dot);
      dot = warp_sum(dot);
      if (lane == 0) {
        if constexpr (QUANT) {
          const long long so = frame * scale_stride + (long long)h * bs + r;
          dot *= ks[so];
          svs[j] = vs[so];
        }
        sc[j] = dot * scale;
        roff[j] = row;
      }
    }
    __syncthreads();
    float mx = m;
    for (int j = 0; j < nt; ++j) mx = fmaxf(mx, sc[j]);
    const float ms = mx > NEG_INF ? mx : 0.f;
    const float alpha = expf(m - ms);
    if (tid < nt) {
      const float p = expf(sc[tid] - ms);
      pl[tid] = p;
      pw[tid] = QUANT ? p * svs[tid] : p;
    }
    __syncthreads();
    l *= alpha;  // every thread keeps the same (m, l), summed in one order
    for (int j = 0; j < nt; ++j) l += pl[j];
    for (int d = tid; d < hd; d += NT) {
      float a = acc[d] * alpha;
      for (int j = 0; j < nt; ++j) a = fmaf(pw[j], to_f(vp[roff[j] + d]), a);
      acc[d] = a;
    }
    m = mx;
    __syncthreads();  // the tile's shared arrays are read before the next
  }
  if (nsplit == 1) {
    const float denom = l == 0.f ? 1.f : l;
    for (int d = tid; d < hd; d += NT) store_o(out, qdt, qo + d, acc[d] / denom);
  } else if (tid == 0) {
    pb[split] = m;
    pb[nsplit + split] = l;
  }
}

struct Args {  // one call's arguments
  const void *q, *kp, *vp, *ks, *vs, *tables, *lengths;
  void* out;
  float* part;
  int qdt, B, H, hd, bs, maxb, fps, nsplit;
  long long frame_stride, scale_stride;
  float scale;
  cudaStream_t stream;
};

cudaError_t combine(const Args& a) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  paged_combine_kernel<<<a.B * a.H, NT_COMBINE, 0, a.stream>>>(
      a.part, a.out, a.qdt, a.hd, a.nsplit);
  return cudaGetLastError();
}

template <typename PT, bool QUANT, int CH, int CPL>
cudaError_t launch(const Args& a, unsigned blocks) {
  paged_split_kernel<PT, QUANT, CH, CPL><<<blocks, NT, 0, a.stream>>>(
      a.q, static_cast<const PT*>(a.kp), static_cast<const PT*>(a.vp),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      a.out, a.part, a.qdt, a.H, a.hd, a.bs, a.maxb, a.fps, a.nsplit,
      a.frame_stride, a.scale_stride, a.scale);
  return combine(a);
}

// route 0 (split): 16-byte loads when every row of both page arrays
// starts on 16 bytes, else one element a load; route 1: the stream kernel
template <typename PT, bool QUANT>
cudaError_t dispatch(const Args& a, int route) {
  const long long blocks = (long long)a.B * a.H * a.nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (route == 1) {
    paged_stream_kernel<PT, QUANT><<<(unsigned)blocks, NT, 0, a.stream>>>(
        a.q, static_cast<const PT*>(a.kp), static_cast<const PT*>(a.vp),
        static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
        static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
        a.out, a.part, a.qdt, a.H, a.hd, a.bs, a.maxb, a.fps, a.nsplit,
        a.frame_stride, a.scale_stride, a.scale);
    return combine(a);
  }
  constexpr int CH = 16 / sizeof(PT);
  const bool vec = ((reinterpret_cast<uintptr_t>(a.kp) |
                     reinterpret_cast<uintptr_t>(a.vp)) & 15) == 0 &&
                   (a.frame_stride * (long long)sizeof(PT)) % 16 == 0 &&
                   (a.hd * sizeof(PT)) % 16 == 0;
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
// 0 = the split kernel (hd <= 256, bs <= 256, fps <= 128), 1 = the stream
// kernel (any hd, bs, fps). Strides are in elements. Each row's frames are
// cut into nsplit splits of fps frames (fps * nsplit >= maxb, nsplit <=
// 1024); `part` is an fp32 workspace of B * H * nsplit * (hd + 2) values,
// needed with nsplit > 1 and on route 1. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernels do not take, else the
// launches' own error.
int paged_attention(const void* q, const void* kp, const void* vp,
                    const void* ks, const void* vs, const void* tables,
                    const void* lengths, void* out, void* part, int B, int H,
                    int hd, int bs, int maxb, int fps, int nsplit,
                    long long frame_stride, long long scale_stride,
                    float scale, int q_dtype, int page_dtype, int route,
                    void* stream) {
  if (B < 1 || H < 1 || hd < 1 || bs < 1 || maxb < 1 || fps < 1 ||
      nsplit < 1 || nsplit > MAX_SPLITS || (long long)fps * nsplit < maxb ||
      (long long)fps * nsplit * bs > 0x7fffffffLL || q_dtype < 0 ||
      q_dtype > 2 || page_dtype < 0 || page_dtype > 3 || route < 0 ||
      route > 1 || ((nsplit > 1 || route == 1) && part == nullptr))
    return cudaErrorInvalidValue;
  if (route == 0 && (hd > MAX_HD || bs > MAX_BS || fps > MAX_FPS))
    return cudaErrorInvalidValue;
  if (page_dtype == 3 && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, kp, vp, ks, vs, tables, lengths, out,
               static_cast<float*>(part), q_dtype, B, H, hd, bs, maxb, fps,
               nsplit, frame_stride, scale_stride, scale,
               static_cast<cudaStream_t>(stream)};
  switch (page_dtype) {
    case 0: return dispatch<float, false>(a, route);
    case 1: return dispatch<__nv_bfloat16, false>(a, route);
    case 2: return dispatch<__half, false>(a, route);
    default: return dispatch<int8_t, true>(a, route);
  }
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
