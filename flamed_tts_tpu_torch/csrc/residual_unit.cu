// K2: one FaCodec residual unit, x (B, T, C) -> (B, T, C), io fp32 or bf16:
//
//   out = x + (conv1(snake2(conv7_d(snake1(x)) + b1)) + b2)
//
// Replaces the TPU kernel flamed_tts_tpu/ops/pallas_resunit.py
// (residual_unit_pallas, bodies _unit_kernel / _unit_core).
//
// Bound on the H100: operations.  The two convs do 2 * 8 * C^2 FLOPs per row
// against two activation rows of traffic, far above the balance point; in
// this kernel they run as plain fp32 FMAs (the tensor cores are later work).
// Design: a block owns TILE output rows of one batch row and computes the
// whole unit for them (unit_rows in resunit.cuh), so nothing between the
// stages touches device memory.  Shared memory is the constraint:
// (2 * TILE + 6d + 24) * C values of the io type plus the snake scratch.
// The host wrapper picks TILE per (C, d, io type) to fit 227 KB (at C = 512,
// d = 9, fp32 that leaves TILE = 12).  In the convs each warp owns a tile of
// RT rows x (32 * CT) output channels: a lane keeps RT x CT sums in
// registers, reads its weights coalesced from a [k][ci][co] copy (the
// wrapper makes it) and four input channels at a time as one broadcast load
// from shared memory.
#include "resunit.cuh"

template <typename IO, int CT>
__global__ void __launch_bounds__(256)
residual_unit_kernel(const IO* __restrict__ x, UnitParams<IO> u,
                     IO* __restrict__ out, int T, int C, int d, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t0 = blockIdx.x * tile;
  IO* h1 = reinterpret_cast<IO*>(smem);
  IO* h2 = h1 + (size_t)unit_h1_rows(tile, d) * C;
  float* scr = reinterpret_cast<float*>(h2 + (size_t)unit_h2_rows(tile) * C);
  const size_t batch = (size_t)blockIdx.y * T * C;
  const IO* xb = x + batch;
  unit_rows<IO, CT>(GlobalRows<IO>{xb, C}, xb + (size_t)t0 * C,
                    out + batch + (size_t)t0 * C, t0, tile, T, C, d, u, h1, h2,
                    scr);
}

// itemsize: bytes of one io value (4 or 2).
extern "C" int residual_unit_smem_bytes(int C, int d, int tile, int itemsize) {
  return (int)((size_t)(unit_h1_rows(tile, d) + unit_h2_rows(tile)) * C *
                   itemsize +
               SNAKE_SCRATCH_FLOATS * sizeof(float));
}

template <typename IO, int CT>
static int launch(const void* x, const void* const* p, void* out, int B, int T,
                  int C, int d, int tile, cudaStream_t stream) {
  const int smem = residual_unit_smem_bytes(C, d, tile, (int)sizeof(IO));
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_full_smem(residual_unit_kernel<IO, CT>, smem_set);
  if (err != cudaSuccess) return (int)err;
  const UnitParams<IO> u = {(const float*)p[0], (const float*)p[1],
                            (const IO*)p[2],    (const IO*)p[3],
                            (const float*)p[4], (const float*)p[5],
                            (const IO*)p[6],    (const IO*)p[7]};
  const dim3 grid((T + tile - 1) / tile, B);
  residual_unit_kernel<IO, CT><<<grid, 256, smem, stream>>>(
      (const IO*)x, u, (IO*)out, T, C, d, tile);
  return (int)cudaGetLastError();
}

template <typename IO>
static int launch_ct(const void* x, const void* const* p, void* out, int B,
                     int T, int C, int d, int tile, cudaStream_t s) {
  if (C % 128 == 0) return launch<IO, 4>(x, p, out, B, T, C, d, tile, s);
  if (C % 64 == 0) return launch<IO, 2>(x, p, out, B, T, C, d, tile, s);
  return launch<IO, 1>(x, p, out, B, T, C, d, tile, s);
}

// params: host array of 8 device pointers, in the order of UnitParams
// (log alpha1, log beta1, w1t, b1, log alpha2, log beta2, w2t, b2).
// bf16 != 0 selects the bf16 io type.  C must be a multiple of 32.
extern "C" int residual_unit_launch(const void* x, const void* const* params,
                                    void* out, int B, int T, int C, int d,
                                    int tile, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 32 != 0 || d <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_ct<__nv_bfloat16>(x, params, out, B, T, C, d, tile, s);
  return launch_ct<float>(x, params, out, B, T, C, d, tile, s);
}
