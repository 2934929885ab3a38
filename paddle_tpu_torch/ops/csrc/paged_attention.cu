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
// Types: q f32 or bf16; pages of q's type, or int8 with f32 scales.
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

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::from_f;
using hopper::to_f;
using hopper::unpack_bf16;

__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

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
template <typename QT, typename PT, bool QUANT, int CH, int CPL>
__global__ void __launch_bounds__(NT)
    paged_split_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                       const PT* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, QT* __restrict__ out,
                       float* __restrict__ part, int H, int hd, int bs,
                       int maxb, int fps, int nsplit, long long frame_stride,
                       long long scale_stride, float scale) {
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
        out[(long long)bh * hd + d] = from_f<QT>(0.f);
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
      qv[i][e] = d < hd ? to_f(q[(long long)bh * hd + d]) : 0.f;
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
      out[(long long)bh * hd + d] = from_f<QT>(a / (L == 0.f ? 1.f : L));
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
template <typename QT>
__global__ void __launch_bounds__(NT_COMBINE)
    paged_combine_kernel(const float* __restrict__ part, QT* __restrict__ out,
                         int hd, int nsplit) {
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
    out[(long long)bh * hd + d] = from_f<QT>(a / denom);
  }
}

struct Args {  // one call's arguments
  const void *q, *kp, *vp, *ks, *vs, *tables, *lengths;
  void* out;
  float* part;
  int B, H, hd, bs, maxb, fps, nsplit;
  long long frame_stride, scale_stride;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename PT, bool QUANT, int CH, int CPL>
cudaError_t launch(const Args& a) {
  const long long blocks = (long long)a.B * a.H * a.nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  paged_split_kernel<QT, PT, QUANT, CH, CPL>
      <<<(unsigned)blocks, NT, 0, a.stream>>>(
          static_cast<const QT*>(a.q), static_cast<const PT*>(a.kp),
          static_cast<const PT*>(a.vp), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
          static_cast<const int*>(a.lengths), static_cast<QT*>(a.out), a.part,
          a.H, a.hd, a.bs, a.maxb, a.fps, a.nsplit, a.frame_stride,
          a.scale_stride, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  paged_combine_kernel<QT><<<a.B * a.H, NT_COMBINE, 0, a.stream>>>(
      a.part, static_cast<QT*>(a.out), a.hd, a.nsplit);
  return cudaGetLastError();
}

// 16-byte loads when every row of both page arrays starts on 16 bytes,
// else one element a load
template <typename QT, typename PT, bool QUANT>
cudaError_t dispatch(const Args& a) {
  constexpr int CH = 16 / sizeof(PT);
  const bool vec = ((reinterpret_cast<uintptr_t>(a.kp) |
                     reinterpret_cast<uintptr_t>(a.vp)) & 15) == 0 &&
                   (a.frame_stride * (long long)sizeof(PT)) % 16 == 0 &&
                   (a.hd * sizeof(PT)) % 16 == 0;
  if (!vec) return launch<QT, PT, QUANT, 1, MAX_HD / 32>(a);
  if (a.hd / CH <= 32) return launch<QT, PT, QUANT, CH, 1>(a);
  if constexpr (MAX_HD / CH > 32) return launch<QT, PT, QUANT, CH, 2>(a);
  return cudaErrorInvalidValue;  // unreachable: hd <= MAX_HD
}

}  // namespace

extern "C" {

// q_dtype: 0 = f32, 1 = bf16. int8_pages: 0 = pages of q's type (ks, vs
// unused), 1 = int8 pages with f32 row scales. Strides are in elements.
// Each row's frames are cut into nsplit splits of fps frames (fps * nsplit
// >= maxb; fps <= 128, nsplit <= 1024); with nsplit > 1, `part` is an fp32
// workspace of B * H * nsplit * (hd + 2) values. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take, else the
// launches' own error.
int paged_attention(const void* q, const void* kp, const void* vp,
                    const void* ks, const void* vs, const void* tables,
                    const void* lengths, void* out, void* part, int B, int H,
                    int hd, int bs, int maxb, int fps, int nsplit,
                    long long frame_stride, long long scale_stride,
                    float scale, int q_dtype, int int8_pages, void* stream) {
  if (B < 1 || H < 1 || hd < 1 || hd > MAX_HD || bs < 1 || bs > MAX_BS ||
      maxb < 1 || fps < 1 || fps > MAX_FPS || nsplit < 1 ||
      nsplit > MAX_SPLITS ||
      (long long)fps * nsplit < maxb || (long long)fps * nsplit * bs > 0x7fffffffLL ||
      (nsplit > 1 && part == nullptr) || q_dtype < 0 || q_dtype > 1)
    return cudaErrorInvalidValue;
  if (int8_pages && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, kp, vp, ks, vs, tables, lengths, out,
               static_cast<float*>(part), B, H, hd, bs, maxb, fps, nsplit,
               frame_stride, scale_stride, scale,
               static_cast<cudaStream_t>(stream)};
  using bf = __nv_bfloat16;
  if (q_dtype == 0)
    return int8_pages ? dispatch<float, int8_t, true>(a)
                      : dispatch<float, float, false>(a);
  return int8_pages ? dispatch<bf, int8_t, true>(a)
                    : dispatch<bf, bf, false>(a);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
