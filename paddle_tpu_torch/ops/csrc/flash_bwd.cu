// Flash-attention backward for Hopper (sm_90a), with a plain C interface
// for ctypes (built by paddle_tpu_torch/ops/_build.py).
//
// Replaces: paddle_tpu/ops/flash_attention.py `_dq_kernel` (:282) and
// `_dkv_kernel` (:319), the two Pallas TPU kernels that `_flash_bwd`
// launches. Same function, all in fp32 whatever the input type:
//   S  = (Q * scale) K^T, masked with the forward's rule (keep k <= q, and
//        q - k < window), P = exp(S - lse) from the forward's logsumexp,
//   dP = dO V^T,  dS = P o (dP - delta),  delta = rowsum(dO o O)
//        (computed by the wrapper with torch ops, or passed in),
//   dQ = scale * dS K,  dK = dS^T (Q * scale),  dV = P^T dO,
// each written once in the input type.
//
// Block structure. The TPU kernels walk a sequential grid and carry their
// accumulators in VMEM across its innermost axis. Thread blocks on the card
// run in no order, so each block owns one output tile and loops itself:
//  - flash_dq_kernel: one block per (b*h, query tile); Q, dO, lse and delta
//    of the tile stay in shared memory, the kernel walks the kv tiles the
//    tile can see, and each thread keeps its slice of dQ in fp32 registers;
//  - flash_dkv_kernel: one block per (b*h, kv tile); K and V stay in shared
//    memory, the kernel walks the query tiles that can see the tile, and
//    each thread keeps its slices of dK and dV in fp32 registers.
// Every block writes only its own tile, so there are no atomics and the
// result does not depend on the order blocks run in. Tiles wholly above
// the diagonal or outside the window are never loaded; the tiles that
// straddle the diagonal or the window's edge are masked per element, so a
// window that is no multiple of the tile (e.g. 100) gives the reference's
// result.
//
// What bounds it: per visited (q, k) pair, dQ does 6 * d FLOPs (S, dP and
// dS K) and dK/dV 8 * d (S, dP, P^T dO and dS^T Q), against q, k, v and dO
// read once, lse and delta read once and the outputs written once. At GPT-2
// small's training shapes (b16 h12 s1024 d64, causal, bf16) that is 38.7
// GFLOP / 127 MB for dQ and 51.6 GFLOP / 153 MB for dK/dV: the tensor
// cores' arithmetic bounds both (39 and 52 us at 989 TFLOP/s). This first
// version does the arithmetic as scalar fp32 FMAs out of shared memory
// (no mma.sync, wgmma or TMA), as the forward kernel does, so it runs far
// above that bound; its times stand in PERF.md.
//
// Tiles: 64 rows of queries and of keys for head_dim 64 and 128; 32 rows
// for head_dim 192 and 256, where five fp32 tiles of 64 rows (Q, dO, K, V
// and P) would pass the 227 KB of shared memory a block may have. Types:
// fp32 or bf16 in and out, fp32 math. q, k, v, dO and the outputs are
// [B, S, H, D] views with any element strides over (b, s, h) and a
// contiguous d; lse and delta are contiguous [B * H, S] fp32 arrays; seq a
// multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block: a 16 x 16 grid

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

struct Strides {  // element strides of a [B, S, H, D] view (d contiguous)
  long long b, s, h;
};

// Rows of a query tile and of a kv tile for head_dim D.
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D <= 128 ? 64 : 32;
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
__device__ __forceinline__ void load_tile(float* dst, const T* src,
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

// The forward's mask (flash_attention.py `_causal_mask`).
__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return !causal || (kp <= qp && (window <= 0 || qp - kp < window));
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
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BR;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  load_tile<T, D, BR>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, scale);
  load_tile<T, D, BR>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, 1.f);
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
    load_tile<T, D, BR>(Ks, kb, sk.s, k0, 1.f);
    load_tile<T, D, BR>(Vs, vb, sv.s, k0, 1.f);
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
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BR;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;

  load_tile<T, D, BR>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, 1.f);
  load_tile<T, D, BR>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, 1.f);

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
    load_tile<T, D, BR>(Qs, qb, sq.s, q0, scale);
    load_tile<T, D, BR>(dOs, dob, sdo.s, q0, 1.f);
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

struct Args {  // one backward call's arguments
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, S;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int causal;
  float scale;
  int window;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr int bytes = dq_smem_floats<D>() * sizeof(float);
  static bool attr_set = false;  // dynamic shared memory above 48 KB
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(a.S / tile_rows<D>(), a.B * a.H);
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
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(a.S / tile_rows<D>(), a.B * a.H);
  flash_dkv_kernel<T, D><<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.S, a.sq,
      a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.causal, a.scale, a.window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int D, bool dq) {
  switch (D) {
    case 64:
      return dq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return dq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    case 192:
      return dq ? launch_dq<T, 192>(a) : launch_dkv<T, 192>(a);
    case 256:
      return dq ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
  }
  return cudaErrorInvalidValue;  // a head_dim the kernels have no tiling for
}

int run(const Args& a, int D, int dtype, bool dq) {
  if (a.B < 1 || a.H < 1 || a.S < 64 || a.S % 64 != 0 ||
      a.B * a.H > 65535 || (dtype != 0 && dtype != 1) ||
      (a.window > 0 && !a.causal))
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(a, D, dq);
  return dispatch<__nv_bfloat16>(a, D, dq);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. Each
// tensor's strides are given as (b, s, h) element strides. Returns a
// cudaError_t: cudaErrorInvalidValue for arguments the kernel does not
// take, else the launch's own error.
int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int B, int H,
             int S, int D, long long q_sb, long long q_ss, long long q_sh,
             long long k_sb, long long k_ss, long long k_sh, long long v_sb,
             long long v_ss, long long v_sh, long long do_sb,
             long long do_ss, long long do_sh, long long dq_sb,
             long long dq_ss, long long dq_sh, int causal, float scale,
             int window, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.B = B;
  a.H = H;
  a.S = S;
  a.sq = {q_sb, q_ss, q_sh};
  a.sk = {k_sb, k_ss, k_sh};
  a.sv = {v_sb, v_ss, v_sh};
  a.sdo = {do_sb, do_ss, do_sh};
  a.sdq = {dq_sb, dq_ss, dq_sh};
  a.causal = causal;
  a.scale = scale;
  a.window = window;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(a, D, dtype, true);
}

int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int B,
              int H, int S, int D, long long q_sb, long long q_ss,
              long long q_sh, long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh,
              long long do_sb, long long do_ss, long long do_sh,
              long long dk_sb, long long dk_ss, long long dk_sh,
              long long dv_sb, long long dv_ss, long long dv_sh, int causal,
              float scale, int window, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.S = S;
  a.sq = {q_sb, q_ss, q_sh};
  a.sk = {k_sb, k_ss, k_sh};
  a.sv = {v_sb, v_ss, v_sh};
  a.sdo = {do_sb, do_ss, do_sh};
  a.sdk = {dk_sb, dk_ss, dk_sh};
  a.sdv = {dv_sb, dv_ss, dv_sh};
  a.causal = causal;
  a.scale = scale;
  a.window = window;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(a, D, dtype, false);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
