// TPP blocked matmul for Hopper (sm_90a), with a plain C interface for
// ctypes (built by paddle_tpu_torch/ops/_build.py).
//
// Replaces: paddle_tpu/ops/tpp.py `_matmul_kernel`, the Pallas TPU kernel
// built by `_build_matmul`. Same function:
//
//     out = act(in_act(LN?(x)) @ w + bias)
//
// with an fp32 accumulator and three optional stages, the product computed
// by the kernels here (no library call):
//   - the LayerNorm prologue (`ln_matmul`): each row's mean and variance
//     over the full K row in fp32, eps 1e-5, then gamma * x_hat + beta,
//     applied to the x tile on its way to the product, so the normalized
//     activation never goes to device memory;
//   - an input activation on the x tile (gelu erf, gelu_tanh, relu: the
//     gelu-on-load of `_fused_tail`);
//   - a bias + activation epilogue on the way out.
//
// What bounds it: at the GPT-2-small MLP shapes (4096 x 768 x 3072 and
// 4096 x 3072 x 768) the work is 2*M*N*K FLOPs against a few tens of MB,
// so the arithmetic binds: the bf16 tensor cores (19.5 us at m 4096) or,
// in fp32 (no TF32), the CUDA cores (0.29 ms). The TPU kernel walks an
// (M/bm, N/bn, K/bk) grid in order on one core and pins bk == K for the LN
// prologue; none of that carries over. Three kernels here:
//
// 1. `tpp_row_stats_kernel`: the LN mode's row mean and rstd, one warp a
//    row, two fp32 passes (mean, then mean squared deviation, as the
//    reference) over x read once from device memory (the second pass hits
//    cache), into an [2, M] fp32 scratch the wrapper allocates; the LN
//    mode's C entry launches it just before the matmul, one host call for
//    both. The main kernels read two floats a row instead of recomputing
//    the statistics in every column block.
//
// 2. `tpp_wgmma_kernel`, bf16: warp-specialised tensor-core GEMM. A block
//    owns a 128 x BN output tile (BN 128, 192 or 256, chosen per call so
//    the tiles fill whole waves of the 132 SMs: N 768 takes 192, four
//    tiles a row block). One producer thread keeps a ring of four K-stages
//    (BK 64) filled by TMA with 128-byte swizzle, completing on mbarriers
//    (gamma and beta of the stage ride along in the LN mode); two consumer
//    warpgroups each own 64 rows and issue `wgmma.m64nBNk16` with w from a
//    shared-memory descriptor (k-major for an nn.Linear weight, the
//    transpose bit for a [K, N] array). In the plain mode x comes from a
//    descriptor too. In the LN and gelu modes a consumer reads its x
//    fragment from the swizzled stage with ldmatrix, applies the LN and
//    the input activation in fp32 registers, rounds to bf16 and passes A
//    in registers; with two register sets the next stage's fragments load
//    and transform while this stage's wgmma runs. The activation is a
//    template argument of the loop, chosen once a call: a branch an
//    element cost more than the gelu. The transform is redone for every
//    column tile of the same rows, so the CUDA cores, not the tensor
//    cores, bound the gelu mode; hence the widest BN that fills the waves,
//    and a gelu from a fitted polynomial and one ex2 (`gelu_fit`, within
//    fp32 rounding of the exact gelu) instead of erff. TMA zero-fills the
//    ragged edges of M, N and K. The epilogue adds bias and the output
//    activation in fp32, stages each warpgroup's bf16 tile in the idle
//    stage memory and stores it as 16-byte row-contiguous chunks.
//
// 3. `tpp_simt_kernel`, fp32 (and bf16 calls TMA cannot take: K, or a
//    stride of w, not a multiple of 8, or an operand not 16-byte aligned):
//    fp32 stays fp32, no TF32. A 128 x 128 tile, 256 threads, 8 x 8 fp32
//    outputs a thread, two blocks an SM (128 registers), a K step of 16
//    double-buffered through registers (the next step's global loads in
//    flight during this step's FMAs), 16-byte loads where the shapes
//    allow; x is staged k-major, the LN and the input activation applied
//    between the FMAs and the store to shared memory. Ragged edges are
//    masked.
//
// Layouts: x is a contiguous [M, K] array, out a contiguous [M, N] array;
// w is read through element strides (swk, swn), so both a [K, N] array
// (the reference's layout) and a torch.nn.Linear weight [N, K] (read as its
// transpose) are taken without a copy. Types: fp32 or bf16 for every
// operand, fp32 accumulation.

#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)

#include <initializer_list>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float LN_EPS = 1e-5f;  // nn.LayerNorm's default

// The gelu x Phi(x) with Phi(x) = 1 - e for x >= 0 and e below, e =
// erfc(|x| / sqrt 2) / 2 = 2^(-u q(u) - 1), u = min(|x|, 5.5437) (e is 0
// in fp32's sum from there on), q a degree-8 least-squares fit of
// -log2(erfc(u / sqrt 2)) / u. Evaluated in fp32 the fit is within
// 1e-7 * max(1, |x|) of the exact gelu, and the SFU's ex2 adds at most two
// ulps of e (erff's own error is 2 ulps); ten FMAs, one ex2 and a select
// cost under half of erff, which matters where every column tile
// recomputes the gelu of its x tile.
__device__ __forceinline__ float gelu_fit(float x) {
  const float u = fminf(fabsf(x), 5.54371643f);
  float q = -5.123889650e-07f;
  q = fmaf(q, u, 9.554936696e-06f);
  q = fmaf(q, u, -7.495158934e-05f);
  q = fmaf(q, u, 2.843048424e-04f);
  q = fmaf(q, u, -1.495632750e-05f);
  q = fmaf(q, u, -6.931121461e-03f);
  q = fmaf(q, u, 5.243475363e-02f);
  q = fmaf(q, u, 4.592214525e-01f);
  q = fmaf(q, u, 1.151104212e+00f);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fmaf(-u, q, -1.f)));
  return x * (x >= 0.f ? 1.f - e : e);
}

// act codes follow ops/tpp.py _ACTS: 0 none, 1 gelu, 2 gelu_tanh, 3 relu
template <int ACT> __device__ __forceinline__ float act_fn(float x) {
  if constexpr (ACT == 1) {
    return gelu_fit(x);
  } else if constexpr (ACT == 2) {
    // tanh(u) = 1 - 2 / (e^(2u) + 1): within 1.2e-7 of tanhf in absolute
    // terms (so the gelu within 6e-8 * |x|), in fewer registers
    const float u = 0.79788456080286536f * (x + 0.044715f * x * x * x);
    const float th = 1.f - 2.f / (exp2f(2.8853900817779268f * u) + 1.f);
    return 0.5f * x * (1.f + th);
  } else if constexpr (ACT == 3) {
    return fmaxf(x, 0.f);
  } else {
    return x;
  }
}

template <int ACT> struct Act {
  static constexpr int value = ACT;
};

// f(Act<act>{}): one branch on the runtime code around a whole loop, so
// the loop's body is specialised and has no branch an element
template <typename F>
__device__ __forceinline__ void with_act(int act, F&& f) {
  switch (act) {
    case 1: f(Act<1>{}); break;
    case 2: f(Act<2>{}); break;
    case 3: f(Act<3>{}); break;
    default: f(Act<0>{}); break;
  }
}

// ---- 1. row statistics ----------------------------------------------------

constexpr int RS_THREADS = 256;  // 8 rows a block

template <typename T, bool VEC>
__global__ void __launch_bounds__(RS_THREADS)
    tpp_row_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                         float* __restrict__ rstd, int M, int K) {
  const int row = (blockIdx.x * RS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (long long)row * K;
  constexpr int E = 16 / sizeof(T);  // elements in 16 bytes
  float s = 0.f;
  if (VEC) {
    for (int k = lane * E; k < K; k += 32 * E) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) s += to_f(e[i]);
    }
  } else {
    for (int k = lane; k < K; k += 32) s += to_f(xr[k]);
  }
  const float mu = warp_sum(s) / K;
  float q = 0.f;
  if (VEC) {
    for (int k = lane * E; k < K; k += 32 * E) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float d = to_f(e[i]) - mu;
        q += d * d;
      }
    }
  } else {
    for (int k = lane; k < K; k += 32) {
      const float d = to_f(xr[k]) - mu;
      q += d * d;
    }
  }
  q = warp_sum(q);
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rsqrtf(q / K + LN_EPS);
  }
}

// ---- 2. bf16: TMA + wgmma, warp-specialised --------------------------------

constexpr int WG_BM = 128, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_THREADS = 384;  // a producer warpgroup + two consumers
constexpr int A_STAGE = WG_BM * WG_BK * 2;  // bytes of one x stage
constexpr int GB_STAGE = 2 * WG_BK * 2;       // gamma and beta of a stage

template <int BN> constexpr int wg_smem_bytes() {
  return 1024 /* alignment slack */ +
         WG_STAGES * (A_STAGE + BN * WG_BK * 2 + GB_STAGE) +
         2 * WG_STAGES * 8 /* mbarriers */;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// a barrier among `count` threads (whole warps) under id (0 is
// __syncthreads')
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma.m64nNk16, bf16 x bf16 -> fp32, A from registers, B from a
// descriptor; D += A B (scale-d 1). TRANS_B 1 reads B n-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "n"(TRANS_B), "r"(1));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n192(float (&d)[96],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, %101;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "n"(TRANS_B), "r"(1));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n256(float (&d)[128],
                                          const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %134, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %133;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "n"(TRANS_B), "r"(1));
}

// the same with A from a shared-memory descriptor (k-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %66;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(TRANS_B), "r"(1));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %99, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, %98;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "n"(TRANS_B), "r"(1));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %131, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %130;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "n"(TRANS_B), "r"(1));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (BN == 128)
    wgmma_n128<TB>(d, a, desc_b);
  else if constexpr (BN == 192)
    wgmma_n192<TB>(d, a, desc_b);
  else
    wgmma_n256<TB>(d, a, desc_b);
}
template <int BN, int TB>
__device__ __forceinline__ void wgmma_ss_bn(float (&d)[BN / 2],
                                            uint64_t desc_a,
                                            uint64_t desc_b) {
  if constexpr (BN == 128)
    wgmma_ss_n128<TB>(d, desc_a, desc_b);
  else if constexpr (BN == 192)
    wgmma_ss_n192<TB>(d, desc_a, desc_b);
  else
    wgmma_ss_n256<TB>(d, desc_a, desc_b);
}

// x is a [M, K] bf16 map (box 64 x 128); w a k-major map (box 64 x BN) or
// an n-major one (box 64 x 64, BN / 64 boxes a stage); gamma and beta 1-D
// maps (box 64), loaded beside each stage when ln != 0, when mean / rstd
// are read too.
template <int BN, bool KMAJOR>
__global__ void __launch_bounds__(WG_THREADS, 1)
    tpp_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_g,
                     const __grid_constant__ CUtensorMap map_b,
                     const __nv_bfloat16* __restrict__ bias,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K,
                     int in_act, int act, int ln) {
  constexpr int B_STAGE = BN * WG_BK * 2;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle is a function of address bits 4-9: 1024-aligned
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_st = base, b_st = base + WG_STAGES * A_STAGE;
  const uint32_t gb_st = b_st + WG_STAGES * B_STAGE;  // gamma, beta a stage
  const uint32_t full = gb_st + WG_STAGES * GB_STAGE;
  const uint32_t empty = full + WG_STAGES * 8;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * BN;
  const int KT = (K + WG_BK - 1) / WG_BK;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring of K-stages filled ----
    setmaxnreg_dec<40>();
    if (tid == 0) {
      const uint32_t tx = A_STAGE + B_STAGE + (ln ? GB_STAGE : 0);
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % WG_STAGES;
        mbar_wait(empty + 8 * s, ((kt / WG_STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, tx);
        tma_load_2d(a_st + s * A_STAGE, &map_x, bar, kt * WG_BK, m0);
        if (KMAJOR) {
          tma_load_2d(b_st + s * B_STAGE, &map_w, bar, kt * WG_BK, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(b_st + s * B_STAGE + j * 8192, &map_w, bar,
                        n0 + 64 * j, kt * WG_BK);
        }
        if (ln) {
          tma_load_1d(gb_st + s * GB_STAGE, &map_g, bar, kt * WG_BK);
          tma_load_1d(gb_st + s * GB_STAGE + GB_STAGE / 2, &map_b, bar,
                      kt * WG_BK);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each, x fragment through registers ----
    setmaxnreg_inc<232>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row_w = 64 * (wg - 1) + 16 * warp;  // the warp's 16 rows
    const int r_lo = m0 + row_w + g, r_hi = r_lo + 8;
    // x_hat = x * rstd - mean * rstd, one FMA an element
    float rs_lo = 0.f, sh_lo = 0.f, rs_hi = 0.f, sh_hi = 0.f;
    if (ln) {
      if (r_lo < M) rs_lo = rstd[r_lo], sh_lo = -mean[r_lo] * rs_lo;
      if (r_hi < M) rs_hi = rstd[r_hi], sh_hi = -mean[r_hi] * rs_hi;
    }
    const bool transform = ln || in_act != 0;
    const unsigned char* gb_ptr = smem_raw + (gb_st - raw);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // ldmatrix.x4 of a 16 x 16 A fragment: lane l addresses row l % 16,
    // 16-byte chunk l / 16 (+2 per k16 step), through the 128-byte swizzle
    const int lr = row_w + (lane & 15);
    const uint32_t a_row = lr * 128, a_sw = lr & 7;

    // wait for stage kt, load its x fragments, LN and in_act them
    auto load_a = [&](int kt, uint32_t(&af)[4][4]) {
      const int s = kt % WG_STAGES;
      mbar_wait(full + 8 * s, (kt / WG_STAGES) & 1);
      if (!transform) return;  // the wgmma reads x from the stage itself
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t ch = 2 * kk + (lane >> 4);
        ldmatrix_x4(af[kk], a_st + s * A_STAGE + a_row + ((ch ^ a_sw) << 4));
      }
      const __nv_bfloat162* gs =
          reinterpret_cast<const __nv_bfloat162*>(gb_ptr + s * GB_STAGE);
      const __nv_bfloat162* bs = gs + GB_STAGE / 8;
      with_act(in_act, [&](auto a) {
        constexpr int ACT = decltype(a)::value;
        // register 2h holds (row g, k .. k+1), 2h + 1 the same k at row
        // g + 8, with k = 16 kk + 8 h + 2 t
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2 lo = unpack_bf16(af[kk][2 * h]);
            float2 hi = unpack_bf16(af[kk][2 * h + 1]);
            if (ln) {  // gamma and beta are 0 past K (TMA's fill)
              const int kp = 8 * kk + 4 * h + t;
              const float2 gm = __bfloat1622float2(gs[kp]);
              const float2 bt = __bfloat1622float2(bs[kp]);
              lo.x = fmaf(fmaf(lo.x, rs_lo, sh_lo), gm.x, bt.x);
              lo.y = fmaf(fmaf(lo.y, rs_lo, sh_lo), gm.y, bt.y);
              hi.x = fmaf(fmaf(hi.x, rs_hi, sh_hi), gm.x, bt.x);
              hi.y = fmaf(fmaf(hi.y, rs_hi, sh_hi), gm.y, bt.y);
            }
            af[kk][2 * h] = pack_bf16(act_fn<ACT>(lo.x), act_fn<ACT>(lo.y));
            af[kk][2 * h + 1] =
                pack_bf16(act_fn<ACT>(hi.x), act_fn<ACT>(hi.y));
          }
      });
    };
    // issue stage kt's four k16 steps
    // this warpgroup's 64 rows of the x stage, for the plain mode's
    // descriptor (k-major like w: 8-row groups 1024 bytes apart)
    const uint32_t a_wg = a_st + (wg - 1) * 64 * 128;
    auto issue = [&](int kt, uint32_t(&af)[4][4]) {
      const int s = kt % WG_STAGES;
      const uint32_t b = b_st + s * B_STAGE;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // k-major: rows of 128 bytes, 8-row groups 1024 bytes apart, a k16
        // step 32 bytes along the row; n-major: 64-column boxes 8192 bytes
        // apart, 8-k groups 1024 bytes apart, a k16 step 16 rows
        const uint64_t desc = KMAJOR ? sw128_desc(b + kk * 32, 16, 1024)
                                     : sw128_desc(b + kk * 2048, 8192, 1024);
        if (transform)
          wgmma_bn<BN, KMAJOR ? 0 : 1>(acc, af[kk], desc);
        else
          wgmma_ss_bn<BN, KMAJOR ? 0 : 1>(
              acc, sw128_desc(a_wg + s * A_STAGE + kk * 32, 16, 1024), desc);
      }
      wgmma_commit();
    };
    // wait for stage kt's products, then hand the stage back; af stays
    // live (untouched by the compiler) until the wgmma that reads it is done
    auto retire = [&](int kt, uint32_t(&af)[4][4]) {
      wgmma_wait_all();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          asm volatile("" : "+r"(af[kk][i])::"memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (kt % WG_STAGES));
    };

    // the next stage's fragments load and transform while this stage's
    // wgmma runs: two register sets, alternating
    uint32_t fa[4][4], fb[4][4];
    load_a(0, fa);
    for (int kt = 0; kt < KT; kt += 2) {
      issue(kt, fa);
      if (kt + 1 < KT) load_a(kt + 1, fb);
      retire(kt, fa);
      if (kt + 1 >= KT) break;
      issue(kt + 1, fb);
      if (kt + 2 < KT) load_a(kt + 2, fa);
      retire(kt + 1, fb);
    }

    // epilogue: bias and the output activation in fp32 registers; the
    // warpgroup's 64 x BN bf16 tile is staged in the stage memory, idle
    // once both warpgroups have passed the barrier, then stored as 16-byte
    // row-contiguous chunks. Accumulator pair (4j, 4j+1) is row g, columns
    // 8j + 2t and + 1; (4j+2, 4j+3) the same columns at row g + 8.
    named_barrier_sync(1, 256);
    constexpr int ROW = BN * 2 + 16;  // bytes a staged row: 16 of padding
    unsigned char* tile = smem_raw + (base - raw) + (wg - 1) * 64 * ROW;
    with_act(act, [&](auto a) {
      constexpr int ACT = decltype(a)::value;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * t, gcol = n0 + col;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) {
          if (gcol < N) b0 = to_f(bias[gcol]);
          if (gcol + 1 < N) b1 = to_f(bias[gcol + 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(tile + (16 * warp + g + 8 * h) * ROW +
                                       col * 2) =
              pack_bf16(act_fn<ACT>(acc[4 * j + 2 * h] + b0),
                        act_fn<ACT>(acc[4 * j + 2 * h + 1] + b1));
      }
    });
    named_barrier_sync(1 + wg, 128);
    constexpr int CH = BN / 8;  // 16-byte chunks a row
    const bool vec = (N & 7) == 0;
    for (int idx = tid & 127; idx < 64 * CH; idx += 128) {
      const int r = idx / CH, c = idx % CH;
      const int gr = m0 + 64 * (wg - 1) + r, gc = n0 + 8 * c;
      if (gr >= M || gc >= N) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(tile + r * ROW + c * 16);
      __nv_bfloat16* o = out + (long long)gr * N + gc;
      if (vec) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
        for (int i = 0; i < 8 && gc + i < N; ++i) o[i] = e[i];
      }
    }
  }
}

// ---- 3. CUDA cores: fp32, and bf16 calls TMA cannot take -------------------

constexpr int SB_M = 128, SB_N = 128, SB_K = 16, SB_T = 256, SB_PAD = 4;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack_bf16(u.x), b = unpack_bf16(u.y);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// four consecutive elements p[0 .. 3] (p[i] valid while i < n), 16- or
// 8-byte loads when `vec` says p is aligned for them
template <typename T>
__device__ __forceinline__ void load_run(const T* p, int n, bool vec,
                                         float (&v)[4]) {
  if (vec && n >= 4) {
    load4(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < n ? to_f(p[i]) : 0.f;
  }
}

// one K step's raw operands for this thread: x (row lr, k lk .. lk+3 and
// lk+8 .. lk+11; zero past M and K) and w (k-major: n lr, the same k;
// n-major: k wk and wk + 8, n wn .. wn+3)
template <typename T>
__device__ __forceinline__ void simt_stage_load(
    const T* __restrict__ x, const T* __restrict__ w, int M, int N, int K,
    long long swk, long long swn, bool kmajor, int gm, int lk, int n_w,
    int wk, int wn, int k0, bool vec_x, bool vec_w, float (&xa)[2][4],
    float (&wb)[2][4]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int gk = k0 + lk + 8 * p;
    load_run(x + (long long)gm * K + gk, gm < M ? K - gk : 0, vec_x, xa[p]);
    if (kmajor)
      load_run(w + n_w * swn + gk, n_w < N ? K - gk : 0, vec_w, wb[p]);
    else
      load_run(w + (k0 + wk + 8 * p) * swk + wn,
               k0 + wk + 8 * p < K ? N - wn : 0, vec_w, wb[p]);
  }
}

// two blocks an SM: at most 128 registers a thread
template <typename T, int ACT>
__global__ void __launch_bounds__(SB_T, 2)
    tpp_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ gamma,
                    const T* __restrict__ beta, const float* __restrict__ mean,
                    const float* __restrict__ rstd, T* __restrict__ out,
                    int M, int N, int K, long long swk, long long swn,
                    int act, int ln, int vec_x, int vec_w, int vec_out) {
  __shared__ __align__(16) float As[2][SB_K][SB_M + SB_PAD];  // x, k-major
  __shared__ __align__(16) float Bs[2][SB_K][SB_N + SB_PAD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * SB_M, n0 = blockIdx.x * SB_N;
  const bool kmajor = swk == 1;
  // staging roles: x and a k-major w as (row, 4 k) twice, 8 k apart; an
  // n-major w as (k, 4 n) twice, 8 k apart
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const int wk = tid >> 5, wn = n0 + (tid & 31) * 4;
  const int gm = m0 + lr, n_w = n0 + lr;
  float mu = 0.f, rs = 0.f;
  if (ln && gm < M) mu = mean[gm], rs = rstd[gm];

  float xa[2][4], wb[2][4];
  // the LN and in_act are applied here, after this step's FMAs, so the
  // raw loads are all that stays live across them
  auto store_stage = [&](int buf, int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + lk + 8 * p + i;
        float a = 0.f;
        if (gm < M && k < K) {
          a = xa[p][i];
          if (ln) a = (a - mu) * rs * to_f(gamma[k]) + to_f(beta[k]);
          a = act_fn<ACT>(a);
        }
        As[buf][lk + 8 * p + i][lr] = a;
      }
      if (kmajor) {
#pragma unroll
        for (int i = 0; i < 4; ++i) Bs[buf][lk + 8 * p + i][lr] = wb[p][i];
      } else {
        *reinterpret_cast<float4*>(&Bs[buf][wk + 8 * p][(tid & 31) * 4]) =
            make_float4(wb[p][0], wb[p][1], wb[p][2], wb[p][3]);
      }
    }
  };

  const int KT = (K + SB_K - 1) / SB_K;
  simt_stage_load(x, w, M, N, K, swk, swn, kmajor, gm, lk, n_w, wk, wn, 0,
                  vec_x, vec_w, xa, wb);
  store_stage(0, 0);
  __syncthreads();

  const int ty = tid >> 4, tx = tid & 15;  // rows ty*4 (+64), cols tx*4 (+64)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT)  // the next step's loads fly during this step's FMAs
      simt_stage_load(x, w, M, N, K, swk, swn, kmajor, gm, lk, n_w, wk, wn,
                      (kt + 1) * SB_K, vec_x, vec_w, xa, wb);
#pragma unroll
    for (int kk = 0; kk < SB_K; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < KT) store_stage(cur ^ 1, (kt + 1) * SB_K);
    __syncthreads();
  }

  with_act(act, [&](auto a_) {
    constexpr int OUT_ACT = decltype(a_)::value;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (r >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + 64 * h + tx * 4;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float val = acc[i][4 * h + j];
          if (bias != nullptr && c + j < N) val += to_f(bias[c + j]);
          v[j] = act_fn<OUT_ACT>(val);
        }
        T* o = out + (long long)r * N + c;
        if (vec_out && c + 3 < N) {
          store4(o, v);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < N) o[j] = from_f<T>(v[j]);
        }
      }
    }
  });
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda
EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// a 1-D bf16 map of n elements, box 64, zero fill past the end
bool make_map_1d(CUtensorMap* map, const void* ptr, long long n) {
  const EncodeTiledFn enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // none for rank 1
  const cuuint32_t box[1] = {(cuuint32_t)WG_BK}, elem[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 1, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D bf16 map, inner dimension first, 128-byte swizzle, zero fill out
// of bounds
bool make_map(CUtensorMap* map, const void* ptr, long long inner,
              long long outer, long long stride, int box_inner,
              int box_outer) {
  const EncodeTiledFn enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the column tile: of 256, 192 and 128, the one whose tiles fill whole
// waves of the SMs with the least time a wave (the widest on a tie)
int pick_bn(int M, int N) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  const long long row_tiles = (M + WG_BM - 1) / WG_BM;
  int best = 256;
  long long best_cost = -1;
  for (int bn : {256, 192, 128}) {
    const long long tiles = row_tiles * ((N + bn - 1) / bn);
    const long long cost = (tiles + sms - 1) / sms * bn;
    if (best_cost < 0 || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

template <int BN, bool KMAJOR>
cudaError_t launch_wgmma(const CUtensorMap& mx, const CUtensorMap& mw,
                         const CUtensorMap& mg, const CUtensorMap& mb,
                         const void* bias, const float* mean,
                         const float* rstd, void* out, int M, int N, int K,
                         int in_act, int act, int ln, cudaStream_t stream) {
  constexpr int bytes = wg_smem_bytes<BN>();
  static bool attr_set = false;  // dynamic shared memory above 48 KB
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tpp_wgmma_kernel<BN, KMAJOR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  using bf = __nv_bfloat16;
  dim3 grid((N + BN - 1) / BN, (M + WG_BM - 1) / WG_BM);
  tpp_wgmma_kernel<BN, KMAJOR><<<grid, WG_THREADS, bytes, stream>>>(
      mx, mw, mg, mb, static_cast<const bf*>(bias), mean, rstd,
      static_cast<bf*>(out), M, N, K, in_act, act, ln);
  return cudaGetLastError();
}


// the bf16 tensor-core path, or cudaErrorNotSupported for a call TMA
// cannot take (K or a stride of w not a multiple of 8 elements, x, w,
// gamma or beta not 16-byte aligned)
cudaError_t try_wgmma(const void* x, const void* w, const void* bias,
                      const void* gamma, const void* beta, const float* mean,
                      const float* rstd, void* out, int M, int N, int K,
                      long long swk, long long swn, int in_act, int act,
                      int ln, cudaStream_t st) {
  const bool kmajor = swk == 1;
  const long long sw = kmajor ? swn : swk;  // the strided dimension's step
  if (K % 8 != 0 || sw % 8 != 0 || sw < (kmajor ? K : N) || !aligned16(x) ||
      !aligned16(w) || (ln && !(aligned16(gamma) && aligned16(beta))))
    return cudaErrorNotSupported;
  CUtensorMap mx, mw, mg, mb;
  const int bn = kmajor ? pick_bn(M, N) : 128;
  if (!make_map(&mx, x, K, M, K, WG_BK, WG_BM) ||
      !(kmajor ? make_map(&mw, w, K, N, swn, WG_BK, bn)
               : make_map(&mw, w, N, K, swk, 64, WG_BK)) ||
      !make_map_1d(&mg, ln ? gamma : x, K) ||
      !make_map_1d(&mb, ln ? beta : x, K))
    return cudaErrorInvalidValue;  // no encoder, or a map TMA refuses
  if (!kmajor)
    return launch_wgmma<128, false>(mx, mw, mg, mb, bias, mean, rstd, out, M,
                                    N, K, in_act, act, ln, st);
  if (bn == 256)
    return launch_wgmma<256, true>(mx, mw, mg, mb, bias, mean, rstd, out, M,
                                   N, K, in_act, act, ln, st);
  if (bn == 192)
    return launch_wgmma<192, true>(mx, mw, mg, mb, bias, mean, rstd, out, M,
                                   N, K, in_act, act, ln, st);
  return launch_wgmma<128, true>(mx, mw, mg, mb, bias, mean, rstd, out, M, N,
                                 K, in_act, act, ln, st);
}

template <typename T>
cudaError_t launch_simt(const void* x, const void* w, const void* bias,
                        const void* gamma, const void* beta, const float* mean,
                        const float* rstd, void* out, int M, int N, int K,
                        long long swk, long long swn, int in_act, int act,
                        int ln, cudaStream_t stream) {
  constexpr uintptr_t vec_bytes = 4 * sizeof(T);
  auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) % vec_bytes) == 0;
  };
  const bool kmajor = swk == 1;
  const int vec_x = K % 4 == 0 && al(x);
  const int vec_w = (kmajor ? swn % 4 == 0 : swk % 4 == 0) && al(w);
  const int vec_out = N % 4 == 0 && al(out);
  dim3 grid((N + SB_N - 1) / SB_N, (M + SB_M - 1) / SB_M);
  auto run = [&](auto kernel) {
    kernel<<<grid, SB_T, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(bias), static_cast<const T*>(gamma),
        static_cast<const T*>(beta), mean, rstd, static_cast<T*>(out), M, N,
        K, swk, swn, act, ln, vec_x, vec_w, vec_out);
  };
  switch (in_act) {  // the input activation is a template argument
    case 1: run(tpp_simt_kernel<T, 1>); break;
    case 2: run(tpp_simt_kernel<T, 2>); break;
    case 3: run(tpp_simt_kernel<T, 3>); break;
    default: run(tpp_simt_kernel<T, 0>); break;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_row_stats(const void* x, float* stats, int M, int K,
                             cudaStream_t stream) {
  const bool vec = K % (16 / sizeof(T)) == 0 && aligned16(x);
  const int blocks = (M + RS_THREADS / 32 - 1) / (RS_THREADS / 32);
  if (vec)
    tpp_row_stats_kernel<T, true><<<blocks, RS_THREADS, 0, stream>>>(
        static_cast<const T*>(x), stats, stats + M, M, K);
  else
    tpp_row_stats_kernel<T, false><<<blocks, RS_THREADS, 0, stream>>>(
        static_cast<const T*>(x), stats, stats + M, M, K);
  return cudaGetLastError();
}

cudaError_t tpp_row_stats_launch(const void* x, void* stats, int M, int K,
                                 int dtype, cudaStream_t st) {
  float* s = static_cast<float*>(stats);
  return dtype == 0 ? launch_row_stats<float>(x, s, M, K, st)
                    : launch_row_stats<__nv_bfloat16>(x, s, M, K, st);
}

}  // namespace

extern "C" {

// The LN mode's row statistics: stats is a float32 [2, M] array, mean in
// row 0 and rstd in row 1. dtype: 0 = float32, 1 = bfloat16.
int tpp_row_stats(const void* x, void* stats, int M, int K, int dtype,
                  void* stream) {
  if (M < 1 || K < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  return tpp_row_stats_launch(x, stats, M, K, dtype,
                              static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32, 1 = bfloat16. bias may be NULL; gamma, beta and
// stats are used only when ln != 0: the row-statistics pre-pass
// (tpp_row_stats) is launched first on the same stream and writes x's
// mean and rstd into stats, a float32 [2, M] scratch, which the matmul
// then reads (one call from the host for both launches). *route is set to
// the matmul kernel launched: 1 = the tensor-core tpp_wgmma_kernel, 2 =
// the CUDA-core tpp_simt_kernel. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernels do not take, else the
// first launch error.
int tpp_matmul(const void* x, const void* w, const void* bias,
               const void* gamma, const void* beta, void* stats, void* out,
               int M, int N, int K, long long swk, long long swn, int in_act,
               int act, int ln, int dtype, void* stream, int* route) {
  if (M < 1 || N < 1 || K < 1 || (M + SB_M - 1) / SB_M > 65535 ||
      in_act < 0 || in_act > 3 || act < 0 || act > 3 ||
      (dtype != 0 && dtype != 1) || (swk != 1 && swn != 1) ||
      (ln && (gamma == nullptr || beta == nullptr || stats == nullptr)) ||
      route == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ln) {
    const cudaError_t e = tpp_row_stats_launch(x, stats, M, K, dtype, st);
    if (e != cudaSuccess) return e;
  }
  const float* mean = static_cast<const float*>(stats);
  const float* rstd = ln ? mean + M : nullptr;
  *route = 2;
  if (dtype == 0)
    return launch_simt<float>(x, w, bias, gamma, beta, mean, rstd, out, M, N,
                              K, swk, swn, in_act, act, ln, st);
  *route = 1;
  const cudaError_t e = try_wgmma(x, w, bias, gamma, beta, mean, rstd, out, M,
                                  N, K, swk, swn, in_act, act, ln, st);
  if (e != cudaErrorNotSupported) return e;
  *route = 2;
  return launch_simt<__nv_bfloat16>(x, w, bias, gamma, beta, mean, rstd, out,
                                    M, N, K, swk, swn, in_act, act, ln, st);
}

const char* tpp_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
