// K2: one FaCodec residual unit, x (B, T, C) -> (B, T, C), io fp32 or bf16:
//
//   out = x + (conv1(snake2(conv7_d(snake1(x)) + b1)) + b2)
//
// Replaces the TPU kernel flamed_tts_tpu/ops/pallas_resunit.py
// (residual_unit_pallas, bodies _unit_kernel / _unit_core).
//
// Bound on the H100: operations.  The two convs do 2 * 8 * C^2 FLOPs per row
// against two activation rows of traffic, far above the balance point.
// Design: a block owns TILE output rows of one batch row and computes the
// whole unit for them (unit_rows in resunit.cuh), so nothing between the
// stages touches device memory; the halo rows (3d + 6 a side for snake 1, 6 a
// side for the dilated conv) are recomputed per block.
//
// bf16 io: the convs are implicit GEMMs on the tensor cores (conv_mma in
// resunit.cuh: mma.sync, A from the activation tile in shared memory by
// ldmatrix, B from weights packed on the host and streamed from L2 through
// two cp.async stages).  With the convs cheap, what bounds the kernel is
// (a) shared memory: (2 * TILE + 6d + 24) rows of C + 8 values, the snake
// scratch and 32 KB of weight stages must fit 227 KB, which caps TILE at 52
// for C = 512; (b) the weights, 16 C^2 bytes that every block streams
// once per pass whatever its TILE, so small tiles pay them more often; and
// (c) the number of blocks: a short input at a large TILE leaves most of the
// 132 SMs idle.  The host wrapper (pick_tile in ops/resunit.py) takes
// TILE + 12 a multiple of 16, the mma's M: the largest TILE up to 100 that
// gives three quarters of the SMs a block (and two blocks an SM below
// C = 256), else 20.
//
// fp32 io keeps scalar fp32 FMAs (conv_rows): each warp owns RT rows x
// (32 * CT) output channels, reads its weights coalesced from a [k][ci][co]
// copy and four input channels at a time as one broadcast load from shared
// memory.  It is bound by the rate of its loads; TF32 tensor-core
// products would not keep the digits the fp32 path is held to.
#include "resunit.cuh"

template <typename IO, int CT, int THREADS>
__global__ void __launch_bounds__(THREADS)
residual_unit_kernel(const IO* __restrict__ x, UnitParams<IO> u,
                     IO* __restrict__ out, int T, int C, int d, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t0 = blockIdx.x * tile;
  const int ld = smem_ld(C, (int)sizeof(IO));
  IO* h1 = reinterpret_cast<IO*>(smem);
  IO* h2 = h1 + (size_t)unit_h1_rows(tile, d) * ld;
  float* scr = reinterpret_cast<float*>(h2 + (size_t)unit_h2_rows(tile) * ld);
  unsigned char* stage =
      reinterpret_cast<unsigned char*>(scr + SNAKE_SCRATCH_FLOATS);
  const size_t batch = (size_t)blockIdx.y * T * C;
  const IO* xb = x + batch;
  unit_rows<IO, CT, THREADS>(GlobalRows<IO>{xb, C}, xb + (size_t)t0 * C, C,
                    out + batch + (size_t)t0 * C, C, t0, tile, T, C, d, u, h1,
                    h2, ld, scr, stage);
}

// itemsize: bytes of one io value (4 or 2).
extern "C" int residual_unit_smem_bytes(int C, int d, int tile, int itemsize) {
  return (int)((size_t)(unit_h1_rows(tile, d) + unit_h2_rows(tile)) *
                   smem_ld(C, itemsize) * itemsize +
               SNAKE_SCRATCH_FLOATS * sizeof(float) +
               conv_stage_bytes(itemsize));
}

template <typename IO, int CT, int THREADS>
static int launch(const void* x, const void* const* p, void* out, int B, int T,
                  int C, int d, int tile, cudaStream_t stream) {
  const int smem = residual_unit_smem_bytes(C, d, tile, (int)sizeof(IO));
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err =
      allow_full_smem(residual_unit_kernel<IO, CT, THREADS>, smem_set);
  if (err != cudaSuccess) return (int)err;
  const UnitParams<IO> u = {(const float*)p[0], (const float*)p[1],
                            (const IO*)p[2],    (const IO*)p[3],
                            (const float*)p[4], (const float*)p[5],
                            (const IO*)p[6],    (const IO*)p[7]};
  const dim3 grid((T + tile - 1) / tile, B);
  residual_unit_kernel<IO, CT, THREADS><<<grid, THREADS, smem, stream>>>(
      (const IO*)x, u, (IO*)out, T, C, d, tile);
  return (int)cudaGetLastError();
}

// params: host array of 8 device pointers, in the order of UnitParams
// (log alpha1, log beta1, w1t, b1, log alpha2, log beta2, w2t, b2).
// bf16 != 0 selects the bf16 io type, whose weights come in conv_mma's
// packed order.  C must be a multiple of 32, and at most MMA_MAX_C in bf16.
extern "C" int residual_unit_launch(const void* x, const void* const* params,
                                    void* out, int B, int T, int C, int d,
                                    int tile, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 32 != 0 || d <= 0 || tile <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (C > MMA_MAX_C) return (int)cudaErrorInvalidValue;
    // from C = 256 on, shared memory leaves an SM one block: 16 warps then
    // hide the snakes' and the weight copies' latency better than 8
    if (C >= 256)
      return launch<__nv_bfloat16, 1, 512>(x, params, out, B, T, C, d, tile, s);
    return launch<__nv_bfloat16, 1, 256>(x, params, out, B, T, C, d, tile, s);
  }
  // CT: groups of 32 output channels a warp of the fp32 conv owns
  if (C % 128 == 0)
    return launch<float, 4, 256>(x, params, out, B, T, C, d, tile, s);
  if (C % 64 == 0)
    return launch<float, 2, 256>(x, params, out, B, T, C, d, tile, s);
  return launch<float, 1, 256>(x, params, out, B, T, C, d, tile, s);
}
