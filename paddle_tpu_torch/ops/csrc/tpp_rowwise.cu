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
//   - softmax_rows and masked_reduce give each row to one block of 256
//     threads, which read the row with neighbouring threads on neighbouring
//     addresses and combine their partial max and sum with warp shuffles
//     and a 32-entry shared array. softmax_rows reads its row three times
//     (max, sum, write); at the rows it is called on (a few KB) the second
//     and third reads hit the L1/L2 caches, so device memory sees each
//     element once. The TPU kernels' row blocks become single rows here:
//     there is no carried state between rows, and a block per row fills the
//     card at the attention-score shapes (tens of thousands of rows).
// Any shape runs (ragged edges are masked); the Python wrappers keep the
// reference's contract on which shapes the registry accepts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstring>

namespace {

constexpr int NT = 256;  // threads a block: 8 warps

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// x and out [m, n] contiguous.
int tpp_softmax_rows(const void* x, void* out, int m, int n, int dtype,
                     void* stream) {
  if (m < 1 || n < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
