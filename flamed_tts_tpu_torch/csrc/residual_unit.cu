// K2: one FaCodec residual unit, x (B, T, C) fp32 -> (B, T, C) fp32:
//
//   h1 = snake1(x)                              alias-free SnakeBeta
//   h2 = conv7_d(h1) + b1                       dense C x C, k=7, dilation d,
//                                               zero pad 3d
//   h3 = snake2(h2)
//   out = x + (conv1(h3) + b2)                  dense C x C, k=1
//
// Replaces the TPU kernel flamed_tts_tpu/ops/pallas_resunit.py
// (residual_unit_pallas, bodies _unit_kernel / _unit_core).
//
// Bound on the H100: operations.  The two convs do 2 * 8 * C^2 FLOPs per row
// against 8 bytes of activation traffic, far above the balance point; in
// this kernel they run as plain fp32 FMAs (the tensor cores are later work).
// Design: a block owns TILE output rows of one batch row and computes the
// whole unit for them, so nothing between the stages touches device memory:
//   1. snake1 over rows [t0 - 3d - 6, t0 + TILE + 3d + 6) into shared h1,
//      zero outside [0, T) (the conv's zero pad); the snake's own replicate
//      pads clamp to [0, T) inside snake_rows (snake.cuh).
//   2. conv7 into shared h2 for rows [t0 - 6, t0 + TILE + 6).
//   3. snake2 of h2 into shared h3 (reusing h1's space), rows [t0, t0+TILE);
//      its replicate pads clamp to [0, T), which stay inside h2's rows.
//   4. conv1, bias and the residual add, stored to out.
// Shared memory is the constraint: (2 * TILE + 6d + 24) * C floats plus the
// snake scratch.  The host wrapper picks TILE per (C, d) to fit 227 KB
// (at C = 512, d = 9 that leaves TILE = 12).  In the convs each warp owns a
// tile of RT rows x (32 * CT) output channels: a lane keeps RT x CT sums in
// registers, reads its weights coalesced from a [k][ci][co] copy (the
// wrapper makes it) and four input channels at a time as one float4
// broadcast from shared memory.
#include "snake.cuh"

#define RT 8
#define SMEM_LIMIT 232448  // bytes of shared memory one block may use on Hopper
#define MAX_DEVICES 64

// out[r][co] = bias[co] + sum_{k<K} sum_ci w[(k * C + ci) * C + co] *
//              in[(r + k * dil) * C + ci]  for r in [0, R), co in [0, C).
// With residual != nullptr the stored value is residual[r][co] + that, and
// only rows r < n_store are stored (the rest of the tile lies past T).
template <int CT, int K>
__device__ void conv_rows(const float* __restrict__ in, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ out,
                          const float* __restrict__ residual, int R, int n_store,
                          int C, int dil) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_cg = C / (32 * CT);
  const int n_rg = (R + RT - 1) / RT;
  for (int item = warp; item < n_rg * n_cg; item += n_warps) {
    const int r0 = (item / n_cg) * RT;
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
      const float* in_k = in + k * dil * C;
      const float* w_k = w + (size_t)k * C * C + co0;
      for (int ci = 0; ci < C; ci += 4) {
        float wv[4][CT];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < CT; ++j)
            wv[u][j] = __ldg(w_k + (size_t)(ci + u) * C + 32 * j);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 h = *reinterpret_cast<const float4*>(in_k + row[r] + ci);
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
      if (r0 + r >= (residual ? n_store : R)) continue;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int co = co0 + 32 * j;
        const size_t o = (size_t)(r0 + r) * C + co;
        const float y = acc[r][j] + bias[co];
        out[o] = residual ? residual[o] + y : y;
      }
    }
  }
}

template <int CT>
__global__ void __launch_bounds__(256)
residual_unit_kernel(const float* __restrict__ x, const float* __restrict__ la1,
                     const float* __restrict__ lb1, const float* __restrict__ w1t,
                     const float* __restrict__ b1, const float* __restrict__ la2,
                     const float* __restrict__ lb2, const float* __restrict__ w2t,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int T, int C, int d, int tile) {
  extern __shared__ __align__(16) float smem[];
  const int t0 = blockIdx.x * tile;
  const int r1 = tile + 6 * d + 12;  // h1 rows: t0 - 3d - 6 ...
  const int r2 = tile + 12;          // h2 rows: t0 - 6 ...
  float* h1 = smem;
  float* h2 = h1 + (size_t)r1 * C;
  float* scr = h2 + (size_t)r2 * C;
  const size_t batch = (size_t)blockIdx.y * T * C;
  const float* xb = x + batch;

  snake_rows(GlobalRows{xb, C}, T, C, t0 - 3 * d - 6, r1, 0, C, la1, lb1, h1,
             scr);
  conv_rows<CT, 7>(h1, w1t, b1, h2, nullptr, r2, r2, C, d);
  __syncthreads();
  float* h3 = h1;
  snake_rows(SharedRows{h2, C, t0 - 6}, T, C, t0, tile, 0, C, la2, lb2, h3,
             scr);
  const int n_store = min(tile, T - t0);
  conv_rows<CT, 1>(h3, w2t, b2, out + batch + (size_t)t0 * C,
                   xb + (size_t)t0 * C, tile, n_store, C, 1);
}

extern "C" int residual_unit_smem_bytes(int C, int d, int tile) {
  return (int)(((size_t)(2 * tile + 6 * d + 24) * C + SNAKE_SCRATCH_FLOATS) *
               sizeof(float));
}

template <int CT>
static int launch(const float* x, const float* la1, const float* lb1,
                  const float* w1t, const float* b1, const float* la2,
                  const float* lb2, const float* w2t, const float* b2,
                  float* out, int B, int T, int C, int d, int tile,
                  cudaStream_t stream) {
  const int smem = residual_unit_smem_bytes(C, d, tile);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // Raise the instantiation's dynamic shared memory cap to the limit once
  // per device, not on every launch.
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(residual_unit_kernel<CT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const dim3 grid((T + tile - 1) / tile, B);
  residual_unit_kernel<CT><<<grid, 256, smem, stream>>>(
      x, la1, lb1, w1t, b1, la2, lb2, w2t, b2, out, T, C, d, tile);
  return (int)cudaGetLastError();
}

// w1t: (7, C, C) laid out [k][ci][co]; w2t: (C, C) laid out [ci][co].
// C must be a multiple of 32.
extern "C" int residual_unit_launch(const float* x, const float* la1,
                                    const float* lb1, const float* w1t,
                                    const float* b1, const float* la2,
                                    const float* lb2, const float* w2t,
                                    const float* b2, float* out, int B, int T,
                                    int C, int d, int tile, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 32 != 0 || d <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C % 128 == 0)
    return launch<4>(x, la1, lb1, w1t, b1, la2, lb2, w2t, b2, out, B, T, C, d,
                     tile, s);
  if (C % 64 == 0)
    return launch<2>(x, la1, lb1, w1t, b1, la2, lb2, w2t, b2, out, B, T, C, d,
                     tile, s);
  return launch<1>(x, la1, lb1, w1t, b1, la2, lb2, w2t, b2, out, B, T, C, d,
                   tile, s);
}
