// Alias-free SnakeBeta (2x kaiser-sinc upsample -> SnakeBeta -> 2x
// decimation), shared by snake_filtered.cu, residual_unit.cu and
// residual_stack.cu.
//
// With f the 12 taps of kaiser_sinc_filter1d(0.25, 0.3, 12) and x the
// (T, C) input, the reference chain is, per channel:
//
//   u[2p]   = 2 * sum_{k<6} f[2k+1] * x[clamp(p + 2 - k)]      (even phase)
//   u[2p+1] = 2 * sum_{k<6} f[2k]   * x[clamp(p + 3 - k)]      (odd phase)
//   s[i]    = u[i] + sin^2(e^a * u[i]) / (e^b + 1e-9)
//   z[t]    = sum_{j<12} f[j] * s[clamp2(2t + j - 5)]
//
// where clamp() clips a row index to [0, T) (the upsampler's replicate
// pad) and clamp2() clips a 2x-rate index to [0, 2T) (the decimator's
// replicate pad on the interleaved signal).  Applying both clips exactly
// makes every row right, the global edges included, so no host-side edge
// patch is needed.
//
// The io type IO is float or __nv_bfloat16: values are read from and
// written to memory as IO, all arithmetic is fp32, and a result is rounded
// to IO once, where it is stored.  Every floating-point operation is
// written as an explicit intrinsic or a single operation, so that the
// same element gets the same bits in every kernel that includes this file.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef SNAKE_TAPS
#error "SNAKE_TAPS (the 12 kaiser-sinc taps) must be defined by the build"
#endif

// Rows of output computed per pass of snake_rows; the 2x-rate window of a
// pass holds 2 * SNAKE_ROWS + 10 values per channel.
#define SNAKE_ROWS 32
#define SNAKE_SCRATCH_FLOATS ((2 * SNAKE_ROWS + 10) * 32)

__constant__ float c_taps[12] = {SNAKE_TAPS};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename IO>
__device__ __forceinline__ IO from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a + b rounded to IO (for bf16: the bf16 add, one rounding).
template <typename IO>
__device__ __forceinline__ IO io_add(IO a, IO b) {
  return from_f<IO>(__fadd_rn(to_f(a), to_f(b)));
}

// Reads row q (already in [0, T)) of a (T, C) array in device memory.
template <typename IO>
struct GlobalRows {
  const IO* p;
  int C;
  __device__ __forceinline__ float operator()(int q, int c) const {
    return to_f(p[(size_t)q * C + c]);
  }
};

// Reads row q of a (T, C) signal held in shared memory from row q0 on.
template <typename IO>
struct SharedRows {
  const IO* p;
  int C;
  int q0;
  __device__ __forceinline__ float operator()(int q, int c) const {
    return to_f(p[(q - q0) * C + c]);
  }
};

// The 2x-rate snake value s[i] for channel c; i must lie in [0, 2T).
template <class Src>
__device__ __forceinline__ float snake_value(const Src& src, int i, int T,
                                             int c, float alpha,
                                             float inv_beta) {
  const int p = i >> 1;
  const int odd = i & 1;
  float u = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int q = clampi(p + 2 + odd - k, 0, T - 1);
    u = fmaf(c_taps[2 * k + 1 - odd], src(q, c), u);
  }
  u = __fmul_rn(u, 2.f);
  const float sn = sinf(__fmul_rn(u, alpha));
  return fmaf(inv_beta, __fmul_rn(sn, sn), u);
}

// Writes z rows [r0, r0 + n) for channels [c_begin, c_end) into
// dst[(row - r0) * C + c], rounded to IO.  Rows outside [0, T) are written
// as zero (the zero padding of the conv that follows in a residual unit).
// Uses the whole block (blockDim.x a multiple of 32; lane = channel) and
// SNAKE_SCRATCH_FLOATS of shared scratch; ends on a barrier.
template <class Src, typename IO>
__device__ void snake_rows(const Src& src, int T, int C, int r0, int n,
                           int c_begin, int c_end, const float* log_alpha,
                           const float* log_beta, IO* dst, float* scr) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int c0 = c_begin; c0 < c_end; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < c_end;
    float alpha = 0.f, inv_beta = 0.f;
    if (live) {
      alpha = expf(log_alpha[c]);
      inv_beta = __fdiv_rn(1.f, __fadd_rn(expf(log_beta[c]), 1e-9f));
    }
    for (int m0 = 0; m0 < n; m0 += SNAKE_ROWS) {
      const int nr = min(SNAKE_ROWS, n - m0);
      const int base = 2 * (r0 + m0) - 5;
      for (int w = warp; w < 2 * nr + 10; w += n_warps) {
        float s = 0.f;
        if (live) {
          const int i = clampi(base + w, 0, 2 * T - 1);
          s = snake_value(src, i, T, c, alpha, inv_beta);
        }
        scr[w * 32 + lane] = s;
      }
      __syncthreads();
      for (int m = warp; m < nr; m += n_warps) {
        const int t = r0 + m0 + m;
        if (live) {
          float z = 0.f;
          if (t >= 0 && t < T) {
#pragma unroll
            for (int j = 0; j < 12; ++j) {
              z = fmaf(c_taps[j], scr[(2 * m + j) * 32 + lane], z);
            }
          }
          dst[(size_t)(m0 + m) * C + c] = from_f<IO>(z);
        }
      }
      __syncthreads();
    }
  }
}
