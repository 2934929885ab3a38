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
// Design. The TPU kernel walks a (b, j) grid in order, the table
// scalar-prefetched so each step's BlockSpec fetches the frame, and carries
// the online-softmax state (m, l, acc) in VMEM scratch from step to step.
// Here one thread block owns one (b, h) and walks its row's frames
// j < ceil(lengths[b] / bs) in a loop, reading the table entries itself.
// The frames past the length are skipped: in the TPU kernel a fully masked
// frame leaves m, l and acc exactly as they were, so skipping gives the
// same result. q sits in shared memory as f32. For each frame, each warp
// takes a stride of its valid columns and forms the dot products over hd
// with lane-strided loads and a shuffle reduction; the scores land in
// shared memory. Then every thread, redundantly and in the same order,
// takes the frame's max, the rescale factor and the probabilities, and
// each thread accumulates its own dims of acc (a stride of hd) over the
// frame's valid columns. Columns at or past the length are never read.
// int8 pages multiply by their row scale as they load. The max, the sum
// and acc are f32; the m_safe substitution of the TPU kernel keeps the
// first frame's rescale finite.
//
// What bounds it: bytes. Each valid column's K and V row is read once
// (at GPT-2 small's full length, 8 rows x 1024 columns x 12 heads x 64:
// 25.2 MB of bf16 pages a layer, 7.5 us at 3.35 TB/s); the operations
// (4 a column and dim) are ~1% of that time at the f32 rate. This first
// design is simple and right, not fast: B * H blocks (96 at 8 x 12) fill
// under one wave of the 132 SMs, each walks its frames one after another
// with two barriers a frame, and the loads are 2-byte (bf16) or 1-byte
// (int8) lane strides. The next design splits each row's frames over
// several blocks with a combine pass (flash-decoding) and loads 16 bytes
// a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int MAX_HD = 256;
constexpr int MAX_BS = 256;
constexpr int PER = MAX_HD / NT;  // acc dims a thread owns

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename QT, typename PT, bool QUANT>
__global__ void __launch_bounds__(NT)
    paged_attention_kernel(const QT* __restrict__ q, const PT* __restrict__ kp,
                           const PT* __restrict__ vp,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const int* __restrict__ tables,
                           const int* __restrict__ lengths, QT* __restrict__ out,
                           int H, int hd, int bs, int maxb,
                           long long frame_stride, long long scale_stride,
                           float scale) {
  __shared__ float qs[MAX_HD];
  __shared__ float sc[MAX_BS];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int d = tid; d < hd; d += NT) qs[d] = to_f(q[(long long)bh * hd + d]);
  const int len = lengths[b];
  const int nblk = (len + bs - 1) / bs;
  const int* trow = tables + (long long)b * maxb;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;
  __syncthreads();
  for (int j = 0; j < nblk; ++j) {
    const long long frame = trow[j];
    const long long head = (long long)h * bs;
    const PT* kf = kp + frame * frame_stride + head * hd;
    const PT* vf = vp + frame * frame_stride + head * hd;
    const float* ksf = QUANT ? ks + frame * scale_stride + head : nullptr;
    const float* vsf = QUANT ? vs + frame * scale_stride + head : nullptr;
    const int nv = min(bs, len - j * bs);  // valid columns of this frame
    for (int c = warp; c < nv; c += NW) {
      const PT* krow = kf + (long long)c * hd;
      const float s_k = QUANT ? ksf[c] : 1.f;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) {
        float kv = to_f(krow[d]);
        if (QUANT) kv *= s_k;
        dot = fmaf(qs[d], kv, dot);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) sc[c] = dot * scale;
    }
    __syncthreads();
    float mb = -CUDART_INF_F;
    for (int c = 0; c < nv; ++c) mb = fmaxf(mb, sc[c]);
    const float m_new = fmaxf(m, mb);
    const float m_safe = m_new > -CUDART_INF_F ? m_new : 0.f;
    const float alpha = expf(m - m_safe);
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
    float psum = 0.f;
    for (int c = 0; c < nv; ++c) {
      const float p = expf(sc[c] - m_safe);
      psum += p;
      const PT* vrow = vf + (long long)c * hd;
      const float s_v = QUANT ? vsf[c] : 1.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int d = tid + i * NT;
        if (d < hd) {
          float vv = to_f(vrow[d]);
          if (QUANT) vv *= s_v;
          acc[i] = fmaf(p, vv, acc[i]);
        }
      }
    }
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();  // sc is rewritten by the next frame
  }
  const float denom = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = tid + i * NT;
    if (d < hd) put(out + (long long)bh * hd + d, acc[i] / denom);
  }
}

template <typename QT, typename PT, bool QUANT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* lengths, void* out,
           int B, int H, int hd, int bs, int maxb, long long frame_stride,
           long long scale_stride, float scale, cudaStream_t stream) {
  paged_attention_kernel<QT, PT, QUANT><<<B * H, NT, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), H, hd, bs, maxb,
      frame_stride, scale_stride, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q_dtype: 0 = f32, 1 = bf16. int8_pages: 0 = pages of q's type (ks, vs
// unused), 1 = int8 pages with f32 row scales. Strides are in elements.
// Returns a cudaError_t: cudaErrorInvalidValue for arguments the kernel
// does not take, else the launch's own error.
int paged_attention(const void* q, const void* kp, const void* vp,
                    const void* ks, const void* vs, const void* tables,
                    const void* lengths, void* out, int B, int H, int hd,
                    int bs, int maxb, long long frame_stride,
                    long long scale_stride, float scale, int q_dtype,
                    int int8_pages, void* stream) {
  if (B < 1 || H < 1 || hd < 1 || hd > MAX_HD || bs < 1 || bs > MAX_BS ||
      maxb < 1 || q_dtype < 0 || q_dtype > 1)
    return cudaErrorInvalidValue;
  if (int8_pages && (ks == nullptr || vs == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) {
    if (int8_pages)
      return launch<float, int8_t, true>(q, kp, vp, ks, vs, tables, lengths,
                                         out, B, H, hd, bs, maxb, frame_stride,
                                         scale_stride, scale, st);
    return launch<float, float, false>(q, kp, vp, ks, vs, tables, lengths, out,
                                       B, H, hd, bs, maxb, frame_stride,
                                       scale_stride, scale, st);
  }
  if (int8_pages)
    return launch<__nv_bfloat16, int8_t, true>(q, kp, vp, ks, vs, tables,
                                               lengths, out, B, H, hd, bs,
                                               maxb, frame_stride, scale_stride,
                                               scale, st);
  return launch<__nv_bfloat16, __nv_bfloat16, false>(
      q, kp, vp, ks, vs, tables, lengths, out, B, H, hd, bs, maxb,
      frame_stride, scale_stride, scale, st);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
