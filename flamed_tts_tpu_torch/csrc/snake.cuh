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

// Reads row q of a (T, C) signal held in shared memory from row q0 on, with
// ld values from one row to the next.
template <typename IO>
struct SharedRows {
  const IO* p;
  int ld;
  int q0;
  __device__ __forceinline__ float operator()(int q, int c) const {
    return to_f(p[(q - q0) * ld + c]);
  }
};

// u + sin^2(alpha * u) / beta for a 2x-rate sample u.
__device__ __forceinline__ float snake_act(float u, float alpha,
                                           float inv_beta) {
  u = __fmul_rn(u, 2.f);
  const float sn = sinf(__fmul_rn(u, alpha));
  return fmaf(inv_beta, __fmul_rn(sn, sn), u);
}

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
  return snake_act(u, alpha, inv_beta);
}

// s[2p + 1] and s[2p + 2] at once: the odd phase of row p and the even
// phase of row p + 1 read the same six rows p + 3 - k, so the pair costs
// six loads where two snake_value calls cost twelve.  Each sum runs over k
// in snake_value's order, so the bits are the same.  Both indices must lie
// in [0, 2T).
template <class Src>
__device__ __forceinline__ void snake_pair(const Src& src, int p, int T, int c,
                                           float alpha, float inv_beta,
                                           float& s_odd, float& s_even) {
  float uo = 0.f, ue = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float x = src(clampi(p + 3 - k, 0, T - 1), c);
    uo = fmaf(c_taps[2 * k], x, uo);
    ue = fmaf(c_taps[2 * k + 1], x, ue);
  }
  s_odd = snake_act(uo, alpha, inv_beta);
  s_even = snake_act(ue, alpha, inv_beta);
}

// Writes z rows [r0, r0 + n) for channels [c_begin, c_end) into
// dst[(row - r0) * ld + c], rounded to IO.  Rows outside [0, T) are written
// as zero (the zero padding of the conv that follows in a residual unit).
// Uses the whole block of WARPS warps (lane = channel) and
// SNAKE_SCRATCH_FLOATS of shared scratch; ends on a barrier.  A warp works
// on SNAKE_PAIRS pairs of 2x-rate samples, then on SNAKE_OUTS output rows,
// at once: independent chains for the scheduler to interleave (a block has
// few warps to hide sinf and the loads behind), sized so that the block
// covers the SNAKE_ROWS + 5 pairs and SNAKE_ROWS rows of a full pass in one
// sweep.
template <int WARPS, class Src, typename IO>
__device__ void snake_rows(const Src& src, int T, int C, int r0, int n,
                           int c_begin, int c_end, const float* log_alpha,
                           const float* log_beta, IO* dst, int ld, float* scr) {
  constexpr int SNAKE_PAIRS = (SNAKE_ROWS + 5 + WARPS - 1) / WARPS;
  constexpr int SNAKE_OUTS = (SNAKE_ROWS + WARPS - 1) / WARPS;
  constexpr int n_warps = WARPS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c0 = c_begin; c0 < c_end; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < c_end;
    const int cc = live ? c : c_begin;  // a channel that exists, to read from
    float alpha = 0.f, inv_beta = 0.f;
    if (live) {
      alpha = expf(log_alpha[c]);
      inv_beta = __fdiv_rn(1.f, __fadd_rn(expf(log_beta[c]), 1e-9f));
    }
    for (int m0 = 0; m0 < n; m0 += SNAKE_ROWS) {
      const int nr = min(SNAKE_ROWS, n - m0);
      // the 2x-rate window: 2 * nr + 10 samples from the odd index `base`
      // on, as nr + 5 pairs (base + 2j, base + 2j + 1)
      const int base = 2 * (r0 + m0) - 5;
      const int n_pairs = nr + 5;
      for (int j0 = warp; j0 < n_pairs; j0 += SNAKE_PAIRS * n_warps) {
        float so[SNAKE_PAIRS], se[SNAKE_PAIRS];
        const int j_last = min(j0 + (SNAKE_PAIRS - 1) * n_warps, n_pairs - 1);
        if (base + 2 * j0 >= 0 && base + 2 * j_last + 1 < 2 * T) {
          // no index of the sweep is clipped: straight-line pairs
#pragma unroll
          for (int u = 0; u < SNAKE_PAIRS; ++u) {
            const int j = min(j0 + u * n_warps, n_pairs - 1);
            snake_pair(src, (base + 2 * j - 1) >> 1, T, cc, alpha, inv_beta,
                       so[u], se[u]);
          }
        } else {
          for (int u = 0; u < SNAKE_PAIRS; ++u) {
            const int i = base + 2 * min(j0 + u * n_warps, n_pairs - 1);
            so[u] = snake_value(src, clampi(i, 0, 2 * T - 1), T, cc, alpha,
                                inv_beta);
            se[u] = snake_value(src, clampi(i + 1, 0, 2 * T - 1), T, cc, alpha,
                                inv_beta);
          }
        }
#pragma unroll
        for (int u = 0; u < SNAKE_PAIRS; ++u) {
          const int j = j0 + u * n_warps;
          if (j < n_pairs) {
            scr[(2 * j) * 32 + lane] = live ? so[u] : 0.f;
            scr[(2 * j + 1) * 32 + lane] = live ? se[u] : 0.f;
          }
        }
      }
      __syncthreads();
      for (int m1 = warp; m1 < nr; m1 += SNAKE_OUTS * n_warps) {
        float z[SNAKE_OUTS];
#pragma unroll
        for (int u = 0; u < SNAKE_OUTS; ++u) {
          const int m = min(m1 + u * n_warps, nr - 1);
          z[u] = 0.f;
#pragma unroll
          for (int j = 0; j < 12; ++j) {
            z[u] = fmaf(c_taps[j], scr[(2 * m + j) * 32 + lane], z[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < SNAKE_OUTS; ++u) {
          const int m = m1 + u * n_warps;
          const int t = r0 + m0 + m;
          if (live && m < nr) {
            dst[(size_t)(m0 + m) * ld + c] =
                from_f<IO>(t >= 0 && t < T ? z[u] : 0.f);
          }
        }
      }
      __syncthreads();
    }
  }
}
