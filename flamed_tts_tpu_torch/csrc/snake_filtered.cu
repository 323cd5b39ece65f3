// K1: fused alias-free SnakeBeta, x (B, T, C) -> z (B, T, C), io fp32 or
// bf16 (fp32 arithmetic, the output rounded once).
//
// Replaces the TPU kernel flamed_tts_tpu/ops/pallas_resample.py
// (snake_filtered_pallas, body _kernel): 2x kaiser-sinc upsample, SnakeBeta,
// 12-tap 2x decimation, without storing the 2x-rate signal in device memory.
//
// Bound on the H100: memory.  Each element is read once and written once
// (8 bytes at fp32, 4 at bf16) against ~2 sinf and ~24 FMAs of work, far
// below the card's operations-per-byte balance.  Design: a block owns 32
// channels x SNAKE_ROWS output rows; lanes run over channels, so every
// global load and store of a warp is one line.  The 2x-rate window of the
// tile (2 * SNAKE_ROWS + 10 values per channel) is built once in shared
// memory, so each 2x-rate sample costs one sinf, and the decimation reads it
// from there.  The six input rows a pair of 2x-rate samples needs are
// re-read through L1, and a warp works on several pairs at once to hide
// sinf and the loads.  Row and 2x-rate indices are clamped exactly as the
// reference's replicate pads clamp them, so the global edges need no second
// pass (see snake.cuh).  The TPU kernel's lane fold is a 128-lane VPU trick
// and is not carried over.
#include "snake.cuh"

template <typename IO>
__global__ void __launch_bounds__(256)
snake_filtered_kernel(const IO* __restrict__ x,
                      const float* __restrict__ log_alpha,
                      const float* __restrict__ log_beta,
                      IO* __restrict__ out, int T, int C) {
  __shared__ float scr[SNAKE_SCRATCH_FLOATS];
  const int r0 = blockIdx.x * SNAKE_ROWS;
  const int c_begin = blockIdx.y * 32;
  const int c_end = min(C, c_begin + 32);
  const size_t batch = (size_t)blockIdx.z * T * C;
  snake_rows<8>(GlobalRows<IO>{x + batch, C}, T, C, r0, min(SNAKE_ROWS, T - r0),
             c_begin, c_end, log_alpha, log_beta,
             out + batch + (size_t)r0 * C, C, scr);
}

// bf16 != 0 selects the bf16 io type; log_alpha and log_beta are fp32.
extern "C" int snake_filtered_launch(const void* x, const float* log_alpha,
                                     const float* log_beta, void* out, int B,
                                     int T, int C, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + SNAKE_ROWS - 1) / SNAKE_ROWS, (C + 31) / 32, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    snake_filtered_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)x, log_alpha, log_beta, (__nv_bfloat16*)out, T,
        C);
  else
    snake_filtered_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)x, log_alpha, log_beta, (float*)out, T, C);
  return (int)cudaGetLastError();
}
