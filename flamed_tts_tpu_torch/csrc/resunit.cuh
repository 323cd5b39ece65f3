// One FaCodec residual unit over a range of rows, as device code shared by
// residual_unit.cu (one unit per launch) and residual_stack.cu (a block's
// three units per launch):
//
//   h1 = snake1(x)                              alias-free SnakeBeta
//   h2 = conv7_d(h1) + b1                       dense C x C, k=7, dilation d,
//                                               zero pad 3d
//   h3 = snake2(h2)
//   out = x + (conv1(h3) + b2)                  dense C x C, k=1
//
// The io type IO is float or __nv_bfloat16.  Activations, weights and
// biases are IO in memory (device and shared); sums are fp32; a value is
// rounded to IO where the TPU kernel rounds it: h1 and h3 where the snakes
// store them, the conv sums before the bias is added, and the two adds
// (bias, residual) are IO adds.  With IO = float every rounding is the
// identity.
//
// conv_rows sums over k, then ci, in one fixed order with one fmaf per
// term, whatever tile the row falls in; snake_rows (snake.cuh) likewise.
// So an output element gets the same bits from any tiling, which is what
// lets the fused stack equal three single-unit launches exactly.
#pragma once

#include "snake.cuh"

#define RT 8               // rows per conv work item
#define SMEM_LIMIT 232448  // bytes of shared memory one block may use on Hopper
#define MAX_DEVICES 64

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Read-only load of one weight from device memory.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// acc[r][co] = sum_{k<K} sum_ci w[(k * C + ci) * C + co] *
//              in[(r + k * dil) * C + ci]          for r in [0, R), co in [0, C),
// y = round(acc) + bias[co] as an IO add.  Without residual, out[r][co] = y
// for every row.  With residual, out[r][co] = residual[r][co] + y (an IO
// add) and only rows in [r_lo, r_hi) are read and stored (the others lie
// outside [0, T)); out may be residual itself (each element is read and
// then written by the same thread).
template <typename IO, int CT, int K>
__device__ void conv_rows(const IO* __restrict__ in, const IO* __restrict__ w,
                          const IO* __restrict__ bias, IO* out,
                          const IO* residual, int R, int r_lo, int r_hi, int C,
                          int dil) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_cg = C / (32 * CT);
  const int n_rg = (R + RT - 1) / RT;
  if (!residual) {
    r_lo = 0;
    r_hi = R;
  }
  for (int item = warp; item < n_rg * n_cg; item += n_warps) {
    const int r0 = (item / n_cg) * RT;
    if (r0 >= r_hi || r0 + RT <= r_lo) continue;  // nothing to store
    const int co0 = (item % n_cg) * 32 * CT + lane;
    int row[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) row[r] = min(r0 + r, R - 1) * C;
    float acc[RT][CT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[r][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const IO* in_k = in + k * dil * C;
      const IO* w_k = w + (size_t)k * C * C + co0;
      for (int ci = 0; ci < C; ci += 4) {
        float wv[4][CT];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < CT; ++j)
            wv[u][j] = ldg_f(w_k + (size_t)(ci + u) * C + 32 * j);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 h = load4(in_k + row[r] + ci);
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            acc[r][j] = fmaf(h.x, wv[0][j], acc[r][j]);
            acc[r][j] = fmaf(h.y, wv[1][j], acc[r][j]);
            acc[r][j] = fmaf(h.z, wv[2][j], acc[r][j]);
            acc[r][j] = fmaf(h.w, wv[3][j], acc[r][j]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r0 + r < r_lo || r0 + r >= r_hi) continue;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int co = co0 + 32 * j;
        const size_t o = (size_t)(r0 + r) * C + co;
        const IO y = io_add<IO>(from_f<IO>(acc[r][j]), bias[co]);
        out[o] = residual ? io_add<IO>(residual[o], y) : y;
      }
    }
  }
}

// Parameters of one unit.  w1t: (7, C, C) laid out [k][ci][co]; w2t: (C, C)
// laid out [ci][co]; the snakes' log-scale alpha / beta stay fp32.
template <typename IO>
struct UnitParams {
  const float* la1;
  const float* lb1;
  const IO* w1t;
  const IO* b1;
  const float* la2;
  const float* lb2;
  const IO* w2t;
  const IO* b2;
};

// Rows of shared memory one unit needs for n output rows at dilation d:
// h1 (and h3 in its place) and h2.
__host__ __device__ inline int unit_h1_rows(int n, int d) { return n + 6 * d + 12; }
__host__ __device__ inline int unit_h2_rows(int n) { return n + 12; }

// The unit's output rows [a, a + n) (absolute row numbers; a may be
// negative and a + n may pass T).  src reads an input row in [0, T);
// res and dst point at the element (row a, channel 0) of the input (for the
// residual add) and of the output, both with row stride C; only rows inside
// [0, T) are read from res and stored to dst.  h1 holds unit_h1_rows(n, d)
// rows, h2 unit_h2_rows(n), scr SNAKE_SCRATCH_FLOATS.  The whole block
// calls it; it does not end on a barrier.
//   1. snake1 over rows [a - 3d - 6, a + n + 3d + 6) into h1, zero outside
//      [0, T) (the conv's zero pad); the snake's own replicate pads clamp to
//      [0, T) inside snake_rows.
//   2. conv7 into h2 for rows [a - 6, a + n + 6).
//   3. snake2 of h2 into h3 (h1's space) for rows [a, a + n); its replicate
//      pads clamp to [0, T), which stays inside h2's rows.
//   4. conv1, bias and the residual add.
template <typename IO, int CT, class Src>
__device__ void unit_rows(const Src& src, const IO* res, IO* dst, int a, int n,
                          int T, int C, int d, const UnitParams<IO>& u, IO* h1,
                          IO* h2, float* scr) {
  snake_rows(src, T, C, a - 3 * d - 6, unit_h1_rows(n, d), 0, C, u.la1, u.lb1,
             h1, scr);
  conv_rows<IO, CT, 7>(h1, u.w1t, u.b1, h2, nullptr, unit_h2_rows(n), 0, 0, C,
                       d);
  __syncthreads();
  IO* h3 = h1;
  snake_rows(SharedRows<IO>{h2, C, a - 6}, T, C, a, n, 0, C, u.la2, u.lb2, h3,
             scr);
  conv_rows<IO, CT, 1>(h3, u.w2t, u.b2, dst, res, n, max(0, -a), min(n, T - a),
                       C, 1);
}

// Raises a kernel's dynamic shared memory cap to SMEM_LIMIT once per
// device, not on every launch.  `done` is the caller's per-kernel table.
template <typename Kernel>
static cudaError_t allow_full_smem(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}
