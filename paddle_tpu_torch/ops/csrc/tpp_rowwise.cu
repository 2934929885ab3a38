// The TPP row primitives for Hopper (sm_90a), with a plain C interface for
// ctypes (built by paddle_tpu_torch/ops/_build.py).
//
// Replaces three Pallas TPU kernels of paddle_tpu/ops/tpp.py:
//   `_bias_act_kernel`      (bias_act):      out = act(x + bias), fp32 math;
//   `_softmax_kernel`       (softmax_rows):  the stable row softmax, fp32
//                                            max and sum over the full row;
//   `_masked_reduce_kernel` (masked_reduce): the sum or max of each row over
//                                            the columns whose mask != 0
//                                            (0 or -inf for a row with none).
// Every output is cast back to x's type (fp32 or bf16).
//
// What bounds them: bytes. Each element is read once and written once (the
// reduction writes one value a row) with a handful of operations between,
// far below the card's ~20 operations per byte in fp32, so the aim is to
// keep the memory system busy:
//   - bias_act is a grid-stride loop over 16-byte vectors of x (4 fp32 or 8
//     bf16 values, which share a row when n is a multiple of the vector),
//     with a scalar path for any other shape or alignment;
//   - softmax_rows, the register route (`softmax_rows_reg_kernel`, rows
//     whose base is 16-byte aligned, n a multiple of the 16-byte vector and
//     at most 2,048): a row to one warp while a lane holds at most four
//     16-byte vectors (bf16 up to 1,024), else to two or four warps (fp32
//     at 1,024: two), 256 threads a block. Each lane issues all of its
//     row's 16-byte loads before any math and keeps the row in registers;
//     the max and then the sum reduce by warp shuffles (one warp a row: no
//     shared memory, no __syncthreads; more: one exchange through shared
//     memory for each), exp(x - max) is formed once an element on the
//     SFU's exp2 and kept, and the row leaves as e * (1 / sum) in 16-byte
//     stores. So the row is read from memory once, and every warp of the
//     SM has its part of a row in flight at once;
//   - softmax_rows on every other row (the block route,
//     `softmax_rows_kernel`) and masked_reduce give each row to one block
//     of 256 threads, which read the row with neighbouring threads on
//     neighbouring addresses and combine their partial max and sum with
//     warp shuffles and a 32-entry shared array. The block route reads its
//     row three times (max, sum, write); at a few KB a row the second and
//     third reads hit the L1/L2 caches, so device memory sees each element
//     once. The TPU kernels' row blocks become single rows here: there is
//     no carried state between rows, and a block per row fills the card at
//     the attention-score shapes (tens of thousands of rows).
// Any shape runs (ragged edges are masked); the Python wrappers keep the
// reference's contract on which shapes the registry accepts.

#include <math_constants.h>

#include <cstring>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NT = 256;  // threads a block: 8 warps

// act codes follow ops/tpp.py _ACTS: 0 none, 1 gelu, 2 gelu_tanh, 3 relu
__device__ __forceinline__ float apply_act(float x, int act) {
  switch (act) {
    case 1:
      return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case 2: {
      const float u = 0.79788456080286536f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(u));
    }
    case 3:
      return fmaxf(x, 0.f);
    default:
      return x;
  }
}

// ---- bias + activation -----------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
    bias_act_kernel(const T* __restrict__ x, const float* __restrict__ bias,
                    T* __restrict__ out, long long total, int n, int act) {
  const long long nvec = total / VEC;
  const long long stride = (long long)gridDim.x * NT;
  for (long long v = (long long)blockIdx.x * NT + threadIdx.x; v < nvec;
       v += stride) {
    const long long base = v * VEC;
    const int col = (int)(base % n);  // VEC divides n: one row per vector
    T in[VEC], res[VEC];
    if constexpr (VEC * sizeof(T) == 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + base);
      memcpy(in, &raw, 16);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) in[e] = x[base + e];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      res[e] = from_f<T>(apply_act(to_f(in[e]) + bias[col + e], act));
    if constexpr (VEC * sizeof(T) == 16) {
      uint4 raw;
      memcpy(&raw, res, 16);
      *reinterpret_cast<uint4*>(out + base) = raw;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[base + e] = res[e];
    }
  }
}

// ---- row reductions --------------------------------------------------------

// Combine one value per thread across the block; every thread gets the
// result. `red` is a 32-entry shared array; the trailing sync lets the
// caller reuse it.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < NT / 32 ? red[lane] : (MAX ? -CUDART_INF_F : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  __syncthreads();
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    softmax_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int n) {
  __shared__ float red[32];
  const T* xr = x + (long long)blockIdx.x * n;
  T* orow = out + (long long)blockIdx.x * n;
  float mx = -CUDART_INF_F;
  for (int j = threadIdx.x; j < n; j += NT) mx = fmaxf(mx, to_f(xr[j]));
  mx = block_reduce<true>(mx, red);
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += NT) s += expf(to_f(xr[j]) - mx);
  s = block_reduce<false>(s, red);
  for (int j = threadIdx.x; j < n; j += NT)
    orow[j] = from_f<T>(expf(to_f(xr[j]) - mx) / s);
}

// ---- softmax_rows in registers: a warp or a few a row --------------------

constexpr int REG_ROWS = NT / 32;   // rows a block at one warp a row
constexpr int REG_MAX_N = 2048;     // the longest row the route keeps

template <typename T> struct Vec;   // the elements of one 16-byte vector
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = unpack_bf16(w[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                      pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  }
};

// Combine one value a warp (lane 0's) over the WPR warps that share a
// row, through `red` (one entry a warp of the block) and a barrier: every
// warp of the row gets the same result, summed in the same order.
template <int WPR, bool MAX>
__device__ __forceinline__ float row_reduce(float v, float* red, int warp) {
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int w0 = warp - warp % WPR;
  v = red[w0];
#pragma unroll
  for (int w = 1; w < WPR; ++w)
    v = MAX ? fmaxf(v, red[w0 + w]) : v + red[w0 + w];
  return v;
}

// Row `blockIdx.x * REG_ROWS / WPR + warp / WPR` of [m, n] (rows past m
// idle), held by WPR warps: lane l of the row's warp p holds its 16-byte
// vectors 32 p + l, 32 (WPR + p) + l, .. (VPL of them, those past the
// row's end masked off). One warp a row reduces by shuffles alone; WPR
// warps add one exchange through shared memory for the max and one for
// the sum. exp(x - max) = 2^((x - max) log2(e)), one exp2 an element;
// x - max is formed first, as the plain version forms it, so a row whose
// max is near the type's largest finite value stays finite (max log2(e)
// alone would overflow). A row containing +inf or NaN gives NaN
// everywhere, as the plain version does (inf - inf, or the NaN, reaches
// the sum).
template <typename T, int VPL, int WPR>
__global__ void __launch_bounds__(NT)
    softmax_rows_reg_kernel(const T* __restrict__ x, T* __restrict__ out,
                            int m, int n) {
  constexpr int V = Vec<T>::N;
  __shared__ float red[2][WPR > 1 ? NT / 32 : 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (REG_ROWS / WPR) + warp / WPR;
  if (WPR == 1 && row >= m) return;  // with WPR > 1 every warp meets the
  const bool live = row < m;         // barriers
  const int nv = n / V;
  const int c0 = 32 * (warp % WPR) + lane;  // the lane's first vector
  const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * n);
  uint4 raw[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i)  // every load in flight before any math
    if (live && c0 + 32 * WPR * i < nv) raw[i] = xr[c0 + 32 * WPR * i];
  float e[VPL][V];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (live && c0 + 32 * WPR * i < nv) {
      Vec<T>::unpack(raw[i], e[i]);
#pragma unroll
      for (int c = 0; c < V; ++c) mx = fmaxf(mx, e[i][c]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if constexpr (WPR > 1) mx = row_reduce<WPR, true>(mx, red[0], warp);
  // a NaN is dropped by fmaxf but reaches the sum below
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (live && c0 + 32 * WPR * i < nv) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        e[i][c] = exp2_approx((e[i][c] - mx) * LOG2E);
        s += e[i][c];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if constexpr (WPR > 1) s = row_reduce<WPR, false>(s, red[1], warp);
  const float inv = 1.f / s;
  uint4* orow = reinterpret_cast<uint4*>(out + (live ? row : 0) * n);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (live && c0 + 32 * WPR * i < nv) {
#pragma unroll
      for (int c = 0; c < V; ++c) e[i][c] *= inv;
      orow[c0 + 32 * WPR * i] = Vec<T>::pack(e[i]);
    }
  }
}

template <typename T, typename M>
__global__ void __launch_bounds__(NT)
    masked_reduce_kernel(const T* __restrict__ x, const M* __restrict__ mask,
                         T* __restrict__ out, int n, int kind) {
  __shared__ float red[32];
  const long long off = (long long)blockIdx.x * n;
  float acc = kind ? -CUDART_INF_F : 0.f;
  for (int j = threadIdx.x; j < n; j += NT) {
    if (mask[off + j] == 0) continue;
    const float v = to_f(x[off + j]);
    acc = kind ? fmaxf(acc, v) : acc + v;
  }
  acc = kind ? block_reduce<true>(acc, red) : block_reduce<false>(acc, red);
  if (threadIdx.x == 0) out[blockIdx.x] = from_f<T>(acc);
}

int grid_for(long long work) {
  const long long blocks = (work + NT - 1) / NT;
  return (int)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

template <typename T>
cudaError_t bias_act(const void* x, const float* bias, void* out,
                     long long total, int n, int act, int vec,
                     cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    bias_act_kernel<T, V><<<grid_for(total / V), NT, 0, st>>>(
        static_cast<const T*>(x), bias, static_cast<T*>(out), total, n, act);
  } else {
    bias_act_kernel<T, 1><<<grid_for(total), NT, 0, st>>>(
        static_cast<const T*>(x), bias, static_cast<T*>(out), total, n, act);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t masked_reduce(const void* x, const void* mask, void* out, int m,
                          int n, int kind, int mask_dtype, cudaStream_t st) {
  if (mask_dtype == 0)
    masked_reduce_kernel<T, unsigned char><<<m, NT, 0, st>>>(
        static_cast<const T*>(x), static_cast<const unsigned char*>(mask),
        static_cast<T*>(out), n, kind);
  else
    masked_reduce_kernel<T, int><<<m, NT, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(mask),
        static_cast<T*>(out), n, kind);
  return cudaGetLastError();
}

// the register route's launch: at most four 16-byte vectors a lane (the
// row's loads all in flight at once, ~48 registers), so one warp a row up
// to 128 vectors (bf16 1,024), two up to 256 (fp32 1,024) and four up to
// 512 (REG_MAX_N = 2,048 in fp32); VPL the fewest vectors a lane, a power
// of two, that cover the row
template <typename T>
cudaError_t softmax_reg(const void* x, void* out, int m, int n,
                        cudaStream_t st) {
  const int nv = n / Vec<T>::N;  // vectors a row
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  auto grid = [m](int wpr) {
    return (int)(((long long)m + REG_ROWS / wpr - 1) / (REG_ROWS / wpr));
  };
  if (nv <= 32)
    softmax_rows_reg_kernel<T, 1, 1><<<grid(1), NT, 0, st>>>(xi, o, m, n);
  else if (nv <= 64)
    softmax_rows_reg_kernel<T, 2, 1><<<grid(1), NT, 0, st>>>(xi, o, m, n);
  else if (nv <= 128)
    softmax_rows_reg_kernel<T, 4, 1><<<grid(1), NT, 0, st>>>(xi, o, m, n);
  else if (nv <= 256)
    softmax_rows_reg_kernel<T, 4, 2><<<grid(2), NT, 0, st>>>(xi, o, m, n);
  else if (nv <= 512)
    softmax_rows_reg_kernel<T, 4, 4><<<grid(4), NT, 0, st>>>(xi, o, m, n);
  else
    return cudaErrorInvalidValue;  // longer than REG_MAX_N
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out). bias is fp32 [n]. vec != 0
// takes 16-byte vectors: x and out 16-byte aligned and n a multiple of the
// vector (4 fp32, 8 bf16). Every entry returns a cudaError_t:
// cudaErrorInvalidValue for arguments its kernel does not take, else the
// launch's own error.
int tpp_bias_act(const void* x, const void* bias, void* out, long long total,
                 int n, int act, int dtype, int vec, void* stream) {
  const int V = dtype == 0 ? 4 : 8;
  if (total < 1 || n < 1 || total % n || act < 0 || act > 3 ||
      (dtype != 0 && dtype != 1) || (vec && n % V))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return bias_act<float>(x, b, out, total, n, act, vec, st);
  return bias_act<__nv_bfloat16>(x, b, out, total, n, act, vec, st);
}

// x and out [m, n] contiguous. *route is set to the kernel launched: 1
// the register route (x and out 16-byte aligned, n a multiple of the
// 16-byte vector and at most REG_MAX_N), 2 the block route.
int tpp_softmax_rows(const void* x, void* out, int m, int n, int dtype,
                     void* stream, int* route) {
  if (m < 1 || n < 1 || (dtype != 0 && dtype != 1) || route == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = dtype == 0 ? 4 : 8;
  if (n % V == 0 && n <= REG_MAX_N &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0) {
    *route = 1;
    return dtype == 0 ? softmax_reg<float>(x, out, m, n, st)
                      : softmax_reg<__nv_bfloat16>(x, out, m, n, st);
  }
  *route = 2;
  if (dtype == 0)
    softmax_rows_kernel<float><<<m, NT, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n);
  else
    softmax_rows_kernel<__nv_bfloat16><<<m, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), n);
  return cudaGetLastError();
}

// x and mask [m, n] contiguous, out [m]. kind: 0 = sum, 1 = max.
// mask_dtype: 0 = one byte (bool, uint8), 1 = int32.
int tpp_masked_reduce(const void* x, const void* mask, void* out, int m,
                      int n, int kind, int dtype, int mask_dtype,
                      void* stream) {
  if (m < 1 || n < 1 || (kind != 0 && kind != 1) ||
      (dtype != 0 && dtype != 1) || (mask_dtype != 0 && mask_dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return masked_reduce<float>(x, mask, out, m, n, kind, mask_dtype, st);
  return masked_reduce<__nv_bfloat16>(x, mask, out, m, n, kind, mask_dtype,
                                      st);
}

const char* tpp_rowwise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
