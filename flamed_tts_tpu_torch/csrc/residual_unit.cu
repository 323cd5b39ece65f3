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
// The convs are implicit GEMMs on the tensor cores in both io types
// (conv_mma in resunit.cuh: mma.sync, bf16 operands or, for fp32 io, three
// TF32 products of split operands that keep fp32's digits; A from the
// activation tile in shared memory by ldmatrix, B from weights packed on the
// host and streamed from L2 through two cp.async stages).  With the convs on
// the tensor cores, what bounds the kernel is (a) shared memory:
// (2 * TILE + 6d + 24) rows of C values + 16 bytes and 32 KB of weight stages
// must fit 227 KB, which at C = 512 caps TILE at 52 in bf16 and, in fp32, at
// 20 for d <= 3 and 4 for d = 9 (past C = 512 in fp32, h1 holds half the
// channels at a time, unit_passes in resunit.cuh, and TILE is 20 at C = 640
// for every d); (b) the weights, 16 C^2 bytes in bf16 and
// 32 C^2 in fp32, that every block streams once per pass whatever its TILE,
// so small tiles pay them more often; (c) the number of blocks: a short input
// at a large TILE leaves most of the 132 SMs idle; and (d) the two snakes
// (snake.cuh), which are a large part of a unit's time at C <= 256.  The host
// wrapper (pick_tile in ops/resunit.py) takes TILE + 12 a multiple of 16, the
// mma's M: the largest TILE up to 100 that gives three quarters of the SMs a
// block (and two blocks an SM where rows are under 512 bytes), else 20, else
// 4.
#include "resunit.cuh"

// A block of 256 threads shares its SM with a second one (pick_tile leaves
// it half the shared memory), so it may use half the registers.
template <typename IO, int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 2 : 1)
residual_unit_kernel(const IO* __restrict__ x, UnitParams<IO> u,
                     IO* __restrict__ out, int T, int C, int d, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t0 = blockIdx.x * tile;
  const int ld = smem_ld(C, (int)sizeof(IO));
  IO* h1 = reinterpret_cast<IO*>(smem);
  IO* h2 = h1 + (size_t)unit_h1_values(tile, d, C, (int)sizeof(IO));
  unsigned char* stage =
      reinterpret_cast<unsigned char*>(h2 + (size_t)unit_h2_rows(tile) * ld);
  const size_t batch = (size_t)blockIdx.y * T * C;
  const IO* xb = x + batch;
  unit_rows<IO, THREADS>(GlobalRows<IO>{xb, C}, xb + (size_t)t0 * C, C,
                         out + batch + (size_t)t0 * C, C, t0, tile, T, C, d, u,
                         h1, h2, ld, stage);
}

// itemsize: bytes of one io value (4 or 2).
extern "C" int residual_unit_smem_bytes(int C, int d, int tile, int itemsize) {
  return (int)(((size_t)unit_h1_values(tile, d, C, itemsize) +
                (size_t)unit_h2_rows(tile) * smem_ld(C, itemsize)) *
                   itemsize +
               conv_stage_bytes());
}

template <typename IO, int THREADS>
static int launch(const void* x, const void* const* p, void* out, int B, int T,
                  int C, int d, int tile, cudaStream_t stream) {
  const int smem = residual_unit_smem_bytes(C, d, tile, (int)sizeof(IO));
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err =
      allow_full_smem(residual_unit_kernel<IO, THREADS>, smem_set);
  if (err != cudaSuccess) return (int)err;
  const UnitParams<IO> u = {(const float*)p[0], (const float*)p[1],
                            (const IO*)p[2],    (const IO*)p[3],
                            (const float*)p[4], (const float*)p[5],
                            (const IO*)p[6],    (const IO*)p[7]};
  const dim3 grid((T + tile - 1) / tile, B);
  residual_unit_kernel<IO, THREADS><<<grid, THREADS, smem, stream>>>(
      (const IO*)x, u, (IO*)out, T, C, d, tile);
  return (int)cudaGetLastError();
}

// params: host array of 8 device pointers, in the order of UnitParams
// (log alpha1, log beta1, w1t, b1, log alpha2, log beta2, w2t, b2), the
// weights in conv_mma's packed order for the io type.  bf16 != 0 selects the
// bf16 io type.  C must be a multiple of 32 and at most MMA_MAX_C (the
// wrapper zero-pads a width of 16 mod 32 to the next multiple of 32).
extern "C" int residual_unit_launch(const void* x, const void* const* params,
                                    void* out, int B, int T, int C, int d,
                                    int tile, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 32 != 0 || C > MMA_MAX_C || d <= 0 ||
      tile <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // from rows of 512 bytes on, shared memory leaves an SM one block: 16 warps
  // then hide the snakes' and the weight copies' latency better than 8
  if (bf16) {
    if (C >= 256)
      return launch<__nv_bfloat16, 512>(x, params, out, B, T, C, d, tile, s);
    return launch<__nv_bfloat16, 256>(x, params, out, B, T, C, d, tile, s);
  }
  if (C >= 128) return launch<float, 512>(x, params, out, B, T, C, d, tile, s);
  return launch<float, 256>(x, params, out, B, T, C, d, tile, s);
}
