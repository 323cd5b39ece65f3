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
// What bounds it on the H100 is the number of instructions a sample, not
// bytes: an output element is 24 FMAs and two sin^2 against one value read
// and one written.  The design spends as few instructions beside those as
// it can:
//   * A warp owns a run of rows of 32 or 64 channels (a lane = one channel,
//     or two neighbours where C is a multiple of 64: 8-byte fp32 and 4-byte
//     bf16 loads and stores) and walks down it.  The 2x-rate samples 2p + 1
//     and 2p + 2 read the same six rows p - 2 .. p + 3, and the next pair
//     the same rows but one, so a lane keeps the six rows and the twelve
//     2x-rate samples of a row's decimation window in registers and each
//     further row costs one load, one pair and one store.  Nothing goes
//     through shared memory and a pass needs no barrier but the one it ends
//     on.  Rows are loaded six ahead of their use.
//   * Work is dealt to the warps as (channel chunk, run of rows) with no
//     clamped duplicates: a pass of any length costs in proportion to its
//     rows, plus five pairs to fill the window at the head of each run.
//   * sin^2 has period pi, so its argument is reduced to [-pi/2, pi/2] by
//     one rounding and two FMAs (Cody-Waite with pi in two floats) and a
//     degree-9 odd polynomial gives the sine there, about 14 instructions
//     where the full-range sinf takes some thirty.  Against an exact sin^2
//     of the same float argument it is within 4e-7 for |argument| <= 65536
//     (sinf: 1.2e-7); larger arguments take sinf.
//
// The io type IO is float or __nv_bfloat16: values are read from and
// written to memory as IO, all arithmetic is fp32, and a result is rounded
// to IO once, where it is stored.  Every floating-point operation is
// written as an explicit intrinsic or a single operation, and a 2x-rate
// sample or an output is computed by the same operations in the same order
// wherever it falls in a run, so that the same element gets the same bits
// in every kernel that includes this file and from any split into runs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef SNAKE_TAPS
#error "SNAKE_TAPS (the 12 kaiser-sinc taps) must be defined by the build"
#endif

// Fewest rows of a run: a shorter run would spend more on the five pairs
// that fill its window than on its rows.
#define SNAKE_MIN_RUN 8

// sin^2 by its period: pi in two floats, and the coefficients of
// sin(r) = r + r * z * (C0 + C1 z + C2 z^2 + C3 z^3), z = r * r, on
// |r| <= 1.62 (a weighted least-squares fit to float64 sin at Chebyshev
// nodes, rounded to float).
#define SIN2_INV_PI 0.31830987334251404f
#define SIN2_PI_HI 3.1415927410125732f
#define SIN2_PI_LO -8.742277657347586e-08f
#define SIN2_C0 -0.16666653752326965f
#define SIN2_C1 0.008332953788340092f
#define SIN2_C2 -0.00019802156020887196f
#define SIN2_C3 2.5904334961524e-06f
#define SIN2_MAX_ARG 65536.0f

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

// N neighbouring channels (1 or 2) from p as floats; p is aligned to N
// values.
template <int N>
__device__ __forceinline__ void load_io(const float* p, float (&v)[N]) {
  if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void load_io(const __nv_bfloat16* p, float (&v)[N]) {
  if constexpr (N == 2) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(t);
    v[1] = __high2float(t);
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int N>
__device__ __forceinline__ void store_io(float* p, const float (&v)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}
template <int N>
__device__ __forceinline__ void store_io(__nv_bfloat16* p, const float (&v)[N]) {
  if constexpr (N == 2) {
    __nv_bfloat162 t;
    t.x = __float2bfloat16_rn(v[0]);
    t.y = __float2bfloat16_rn(v[1]);
    *reinterpret_cast<__nv_bfloat162*>(p) = t;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// Reads row q (already in [0, T)) of a (T, C) array in device memory.
template <typename IO>
struct GlobalRows {
  const IO* p;
  int C;
  template <int N>
  __device__ __forceinline__ void load(int q, int c, float (&v)[N]) const {
    load_io<N>(p + (size_t)q * C + c, v);
  }
};

// Reads row q of a (T, C) signal held in shared memory from row q0 on, with
// ld values from one row to the next.
template <typename IO>
struct SharedRows {
  const IO* p;
  int ld;
  int q0;
  template <int N>
  __device__ __forceinline__ void load(int q, int c, float (&v)[N]) const {
    load_io<N>(p + (q - q0) * ld + c, v);
  }
};

// sin^2(y) for |y| <= SIN2_MAX_ARG: r = y - rint(y / pi) * pi lies in
// [-pi/2, pi/2] and has the same sin^2.
__device__ __forceinline__ float sin2(float y) {
  const float k = rintf(__fmul_rn(y, SIN2_INV_PI));
  float r = __fmaf_rn(-k, SIN2_PI_HI, y);
  r = __fmaf_rn(-k, SIN2_PI_LO, r);
  const float z = __fmul_rn(r, r);
  float poly = __fmaf_rn(SIN2_C3, z, SIN2_C2);
  poly = __fmaf_rn(poly, z, SIN2_C1);
  poly = __fmaf_rn(poly, z, SIN2_C0);
  const float sn = __fmaf_rn(__fmul_rn(r, z), poly, r);
  return __fmul_rn(sn, sn);
}

// u + sin^2(alpha * u) / beta for 2x-rate samples u past the reduction's
// range (|alpha * u| > SIN2_MAX_ARG, where it would lose the quotient's last
// bits).  Not inlined: it is all but never called, and sinf's slow path is
// long.
__device__ __noinline__ float snake_act_large(float u, float alpha,
                                              float inv_beta) {
  const float sn = sinf(__fmul_rn(u, alpha));
  return __fmaf_rn(inv_beta, __fmul_rn(sn, sn), u);
}

// The raw pair s[2p + 1], s[2p + 2] (the odd phase of row p and the even
// phase of row p + 1) from the six rows w[0..5] = x[clamp(p - 2 .. p + 3)]:
// each phase sums over k = 0..5 with row p + 3 - k = w[5 - k].
__device__ __forceinline__ void snake_pair(const float (&w)[6], float alpha,
                                           float inv_beta, float& s_odd,
                                           float& s_even) {
  float uo = 0.f, ue = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    uo = __fmaf_rn(c_taps[2 * k], w[5 - k], uo);
    ue = __fmaf_rn(c_taps[2 * k + 1], w[5 - k], ue);
  }
  // s = u + sin^2(alpha * u) / beta, u twice the FIR sum
  uo = __fmul_rn(uo, 2.f);
  ue = __fmul_rn(ue, 2.f);
  const float yo = __fmul_rn(uo, alpha), ye = __fmul_rn(ue, alpha);
  s_odd = __fmaf_rn(inv_beta, sin2(yo), uo);
  s_even = __fmaf_rn(inv_beta, sin2(ye), ue);
  if (fmaxf(fabsf(yo), fabsf(ye)) > SIN2_MAX_ARG) {
    if (fabsf(yo) > SIN2_MAX_ARG) s_odd = snake_act_large(uo, alpha, inv_beta);
    if (fabsf(ye) > SIN2_MAX_ARG) s_even = snake_act_large(ue, alpha, inv_beta);
  }
}

// One run: output rows [ta, tb), 0 <= ta < tb <= T, of the N channels from c
// on; out points at the first of them and rows are ld values apart.
//
// Step p makes the pair (s[2p + 1], s[2p + 2]) from one new row, p + 3, and
// then row p - 2 has its whole window s[2t - 5 .. 2t + 6], the pairs
// t - 3 .. t + 2.  The steps run from p0 = max(ta - 3, -1) to tb + 1.  The
// decimator's replicate pad: an index below 0 reads s[0], which is the even
// half of pair -1, so the first step fills the window with its (corrected)
// odd half, right for p0 = -1 and unused otherwise; an index past 2T - 1
// reads s[2T - 1], the odd half of pair T - 1, which every later pair
// copies from the newest window slot.  Steps come in blocks of six so that
// every register index is static: the rows a block adds are loaded during
// the block before (xb), while xa keeps the six before them.
template <int N, class Src, typename IO>
__device__ __forceinline__ void snake_run(const Src& src, int T, int c, int ta,
                                          int tb, const float (&alpha)[N],
                                          const float (&inv_beta)[N], IO* out,
                                          int ld) {
  const int p0 = max(ta - 3, -1);
  const int p_end = tb + 1;
  const int q_last = min(p_end + 3, T - 1);  // the last row any step reads
  float xa[6][N], xb[6][N], s[12][N] = {};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    src.template load<N>(clampi(p0 - 3 + i, 0, q_last), c, xa[i]);
    src.template load<N>(clampi(p0 + 3 + i, 0, q_last), c, xb[i]);
  }
  for (int pb = p0; pb <= p_end; pb += 6) {
    float xc[6][N];
#pragma unroll
    for (int i = 0; i < 6; ++i)
      src.template load<N>(clampi(pb + 9 + i, 0, q_last), c, xc[i]);
    // no branch inside the six steps but snake_pair's for a huge argument,
    // so that one step's decimation and the next one's pair overlap; steps
    // past p_end (at most five) compute on clamped rows and store nothing
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int p = pb + i;
      const int t = p - 2;
      float z[N];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float w[6];
#pragma unroll
        for (int k = 0; k < 6; ++k)
          w[k] = i + 1 + k < 6 ? xa[i + 1 + k][e] : xb[i + k - 5][e];
        float so, se;
        snake_pair(w, alpha[e], inv_beta[e], so, se);
        so = p == -1 ? se : (p > T - 1 ? s[11][e] : so);
        se = p >= T - 1 ? so : se;
        const bool first = i == 0 && pb == p0;
#pragma unroll
        for (int j = 0; j < 10; ++j) s[j][e] = first ? so : s[j + 2][e];
        s[10][e] = so;
        s[11][e] = se;
        z[e] = 0.f;
#pragma unroll
        for (int j = 0; j < 12; ++j) z[e] = __fmaf_rn(c_taps[j], s[j][e], z[e]);
      }
      if (t >= ta && t < tb) store_io<N>(out + (size_t)(t - ta) * ld, z);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        xa[i][e] = xb[i][e];
        xb[i][e] = xc[i][e];
      }
  }
}

template <int WARPS, int N, class Src, typename IO>
__device__ __forceinline__ void snake_rows_n(const Src& src, int T, int r0,
                                             int n, int c_begin, int c_end,
                                             const float* log_alpha,
                                             const float* log_beta, IO* dst,
                                             int ld) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (c_end - c_begin + 32 * N - 1) / (32 * N);
  // runs of rows per chunk: enough to give every warp one, as long as a run
  // keeps SNAKE_MIN_RUN rows
  int run = (n + WARPS / min(chunks, WARPS) - 1) / (WARPS / min(chunks, WARPS));
  run = max(run, SNAKE_MIN_RUN);
  const int runs = (n + run - 1) / run;
  for (int item = warp; item < chunks * runs; item += WARPS) {
    const int c = c_begin + (item / runs) * 32 * N + lane * N;
    if (c >= c_end) continue;
    const int ra = r0 + (item % runs) * run;
    const int rb = min(ra + run, r0 + n);
    const int ta = max(ra, 0), tb = min(rb, T);
    IO* out = dst + (size_t)(ra - r0) * ld + c;
    float zero[N];
#pragma unroll
    for (int e = 0; e < N; ++e) zero[e] = 0.f;
    for (int t = ra; t < min(rb, ta); ++t)
      store_io<N>(out + (size_t)(t - ra) * ld, zero);
    for (int t = max(tb, ra); t < rb; ++t)
      store_io<N>(out + (size_t)(t - ra) * ld, zero);
    if (ta >= tb) continue;
    float alpha[N], inv_beta[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      alpha[e] = expf(log_alpha[c + e]);
      inv_beta[e] = __fdiv_rn(1.f, __fadd_rn(expf(log_beta[c + e]), 1e-9f));
    }
    snake_run<N>(src, T, c, ta, tb, alpha, inv_beta,
                 out + (size_t)(ta - ra) * ld, ld);
  }
}

// Writes z rows [r0, r0 + n) for channels [c_begin, c_end) into
// dst[(row - r0) * ld + c], rounded to IO.  Rows outside [0, T)
// are written as zero (the zero padding of the conv that follows in a
// residual unit).  The whole block of WARPS warps calls it; it ends on a
// barrier.  src, dst and c_begin must be aligned to two values where
// c_end - c_begin is a multiple of 64 (a lane then takes two channels).
template <int WARPS, class Src, typename IO>
__device__ void snake_rows(const Src& src, int T, int r0, int n, int c_begin,
                           int c_end, const float* log_alpha,
                           const float* log_beta, IO* dst, int ld) {
  if ((c_end - c_begin) % 64 == 0)
    snake_rows_n<WARPS, 2>(src, T, r0, n, c_begin, c_end, log_alpha, log_beta,
                           dst, ld);
  else
    snake_rows_n<WARPS, 1>(src, T, r0, n, c_begin, c_end, log_alpha, log_beta,
                           dst, ld);
  __syncthreads();
}
