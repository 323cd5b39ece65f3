// K1: fused alias-free SnakeBeta, x (B, T, C) -> z (B, T, C), io fp32 or
// bf16 (fp32 arithmetic, the output rounded once).
//
// Replaces the TPU kernel flamed_tts_tpu/ops/pallas_resample.py
// (snake_filtered_pallas, body _kernel): 2x kaiser-sinc upsample, SnakeBeta,
// 12-tap 2x decimation, without storing the 2x-rate signal in device memory.
//
// Bound on the H100: by bytes on paper (each element is read once and
// written once, 8 bytes at fp32, 4 at bf16), by instructions in fact: 24
// FMAs and two sin^2 an element are some 80 instructions, and at the card's
// instruction rate that is several times the bytes' time.  So the design is
// the one that spends the fewest instructions a sample (snake_rows in
// snake.cuh): a warp walks down a run of 32 rows (8 to 16 where the input is
// short, to give the card blocks enough) of 32 channels (64 where C is a
// multiple of 64, two a lane) with the six input rows and the twelve 2x-rate
// samples of the decimation window in registers, so a row costs one
// coalesced load, one pair of 2x-rate samples with sin^2 by its period, and
// one store; no shared memory, no barrier.  A block is 8 such warps, one
// below the other.  Row and 2x-rate indices are clamped exactly as the
// reference's replicate pads clamp them, so the global edges need no second
// pass.  The TPU kernel's lane fold is a 128-lane VPU trick and is not
// carried over.
#include "snake.cuh"

#define K1_ROWS 256     // rows of a block: a run of 32 for each of its 8 warps,
#define K1_MIN_ROWS 64  // or, for a short input, of 8 at least
#define K1_BLOCKS 264   // blocks a launch should have: two for each SM

template <typename IO>
__global__ void __launch_bounds__(256)
snake_filtered_kernel(const IO* __restrict__ x,
                      const float* __restrict__ log_alpha,
                      const float* __restrict__ log_beta,
                      IO* __restrict__ out, int T, int C, int rows) {
  const int span = C % 64 == 0 ? 64 : 32;  // channels of a block
  const int r0 = blockIdx.x * rows;
  const int c_begin = blockIdx.y * span;
  const int c_end = min(C, c_begin + span);
  const size_t batch = (size_t)blockIdx.z * T * C;
  snake_rows<8>(GlobalRows<IO>{x + batch, C}, T, r0, min(rows, T - r0),
                c_begin, c_end, log_alpha, log_beta,
                out + batch + (size_t)r0 * C, C);
}

// bf16 != 0 selects the bf16 io type; log_alpha and log_beta are fp32.
extern "C" int snake_filtered_launch(const void* x, const float* log_alpha,
                                     const float* log_beta, void* out, int B,
                                     int T, int C, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int span = C % 64 == 0 ? 64 : 32;
  // a warp's time is its run's length, so a short input takes shorter runs
  // (which cost five more pairs each) until the card has blocks enough
  int rows = K1_ROWS;
  while (rows > K1_MIN_ROWS &&
         (long long)((T + rows - 1) / rows) * ((C + span - 1) / span) * B < K1_BLOCKS)
    rows >>= 1;
  const dim3 grid((T + rows - 1) / rows, (C + span - 1) / span, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    snake_filtered_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        (const __nv_bfloat16*)x, log_alpha, log_beta, (__nv_bfloat16*)out, T,
        C, rows);
  else
    snake_filtered_kernel<float><<<grid, 256, 0, s>>>(
        (const float*)x, log_alpha, log_beta, (float*)out, T, C, rows);
  return (int)cudaGetLastError();
}
