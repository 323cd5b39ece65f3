// K3: a FaCodec block's three residual units (dilations d1, d2, d3; the
// codec uses 1, 3, 9) in one launch, x (B, T, C) -> (B, T, C), io fp32 or
// bf16.  The two intermediate (T, C) activations never reach device memory.
//
// Replaces the TPU kernel flamed_tts_tpu/ops/pallas_resunit.py
// (residual_stack_pallas, bodies _stack_kernel / _stack_kernel_folded).
//
// Bound on the H100: operations, as for the single unit (three times its
// FLOPs against one read and one write of the activation).  The convs run on
// the tensor cores in both io types (conv_mma in resunit.cuh: bf16 products,
// or three TF32 products of split operands for fp32 io).  The kernel redoes
// the halo rows, so its gain over three single-unit launches is two round
// trips of (T, C) through device memory and two launches, paid for with
// (n1 + n2 + n3) / (3 * TILE) times the arithmetic and the snakes; with the
// convs cheap, the snakes over the halo rows are the larger part of that
// price.
//
// Design: a block owns TILE output rows of one batch row.  Unit i needs
// 3 * d_i + 12 rows of context a side, so the block computes
//   unit 1 on n1 = TILE + 2 * (halo2 + halo3) rows,
//   unit 2 on n2 = TILE + 2 * halo3 rows,
//   unit 3 on n3 = TILE rows,
// each with unit_rows (resunit.cuh), the very code of the single-unit
// kernel, so an element gets the same bits as from three launches of it.
// Shared memory holds three buffers of the io type (rows of C values and 16
// bytes, see resunit.cuh):
//   Y  (n1 rows): unit 1's output; unit 2 adds its branch to it in place
//                 (its residual is read and its sum written by one thread);
//   H1 (max over the units of n_i + 6 d_i + 12 rows): snake 1, then snake 2;
//   H2 (n1 + 12 rows): the dilated conv's output;
// plus the two weight stages of conv_mma (32 KB).  Unit 1 reads x from
// device memory, unit 3 writes
// to it.  Per unit the global edges are handled where they arise: a row of
// an intermediate outside [0, T) is zero for the next conv (snake_rows
// writes the zero) and never read by the next snake, whose replicate pad
// clamps to [0, T) of that intermediate, not of x.
// 227 KB of shared memory limits the block to (3 * TILE + 390) rows; the host
// wrapper takes the stack only where a TILE of 64 or more fits (C <= 64 in
// fp32, C <= 128 in bf16) and launches the single-unit kernel three times
// elsewhere.
#include "resunit.cuh"

template <typename IO>
struct StackParams {
  UnitParams<IO> unit[3];
  int d[3];
};

struct StackRows {
  int n1, n2, n3;  // output rows of the units
  int y, h1, h2;   // rows of the three shared buffers
};

__host__ __device__ inline StackRows stack_rows(int tile, int d1, int d2,
                                                int d3) {
  StackRows r;
  r.n3 = tile;
  r.n2 = r.n3 + 2 * (3 * d3 + 12);
  r.n1 = r.n2 + 2 * (3 * d2 + 12);
  r.y = r.n1;
  r.h1 = unit_h1_rows(r.n1, d1);
  if (unit_h1_rows(r.n2, d2) > r.h1) r.h1 = unit_h1_rows(r.n2, d2);
  if (unit_h1_rows(r.n3, d3) > r.h1) r.h1 = unit_h1_rows(r.n3, d3);
  r.h2 = unit_h2_rows(r.n1);
  return r;
}

template <typename IO, int THREADS>
__global__ void __launch_bounds__(THREADS)
residual_stack_kernel(const IO* __restrict__ x, StackParams<IO> prm,
                      IO* __restrict__ out, int T, int C, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t0 = blockIdx.x * tile;
  const int d1 = prm.d[0], d2 = prm.d[1], d3 = prm.d[2];
  const StackRows rows = stack_rows(tile, d1, d2, d3);
  const int ld = smem_ld(C, (int)sizeof(IO));
  IO* Y = reinterpret_cast<IO*>(smem);
  IO* H1 = Y + (size_t)rows.y * ld;
  IO* H2 = H1 + (size_t)rows.h1 * ld;
  unsigned char* stage =
      reinterpret_cast<unsigned char*>(H2 + (size_t)rows.h2 * ld);
  const size_t batch = (size_t)blockIdx.y * T * C;
  const IO* xb = x + batch;

  const int a1 = t0 - (rows.n1 - tile) / 2;  // first row of Y
  const int a2 = t0 - (rows.n2 - tile) / 2;
  // unit 1: x (device memory) -> Y
  unit_rows<IO, THREADS>(GlobalRows<IO>{xb, C}, xb + (ptrdiff_t)a1 * C, C, Y,
                         ld, a1, rows.n1, T, C, d1, prm.unit[0], H1, H2, ld,
                         stage);
  __syncthreads();
  // unit 2: Y -> Y, in place on its rows [a2, a2 + n2)
  IO* y2 = Y + (size_t)(a2 - a1) * ld;
  unit_rows<IO, THREADS>(SharedRows<IO>{Y, ld, a1}, y2, ld, y2, ld, a2,
                         rows.n2, T, C, d2, prm.unit[1], H1, H2, ld, stage);
  __syncthreads();
  // unit 3: Y -> out (device memory)
  unit_rows<IO, THREADS>(SharedRows<IO>{Y, ld, a1},
                         Y + (size_t)(t0 - a1) * ld, ld,
                         out + batch + (size_t)t0 * C, C, t0, rows.n3, T, C, d3,
                         prm.unit[2], H1, H2, ld, stage);
}

// itemsize: bytes of one io value (4 or 2).
extern "C" int residual_stack_smem_bytes(int C, int tile, int d1, int d2,
                                         int d3, int itemsize) {
  const StackRows r = stack_rows(tile, d1, d2, d3);
  return (int)((size_t)(r.y + r.h1 + r.h2) * smem_ld(C, itemsize) * itemsize +
               conv_stage_bytes());
}

template <typename IO, int THREADS>
static int launch(const void* x, const void* const* p, void* out, int B, int T,
                  int C, int tile, const int* d, cudaStream_t stream) {
  const int smem =
      residual_stack_smem_bytes(C, tile, d[0], d[1], d[2], (int)sizeof(IO));
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err =
      allow_full_smem(residual_stack_kernel<IO, THREADS>, smem_set);
  if (err != cudaSuccess) return (int)err;
  StackParams<IO> prm;
  for (int i = 0; i < 3; ++i) {
    const void* const* q = p + 8 * i;
    prm.unit[i] = {(const float*)q[0], (const float*)q[1], (const IO*)q[2],
                   (const IO*)q[3],    (const float*)q[4], (const float*)q[5],
                   (const IO*)q[6],    (const IO*)q[7]};
    prm.d[i] = d[i];
  }
  const dim3 grid((T + tile - 1) / tile, B);
  residual_stack_kernel<IO, THREADS><<<grid, THREADS, smem, stream>>>(
      (const IO*)x, prm, (IO*)out, T, C, tile);
  return (int)cudaGetLastError();
}

// params: host array of 24 device pointers, 8 per unit in the order of
// UnitParams (log alpha1, log beta1, w1t, b1, log alpha2, log beta2, w2t,
// b2), the weights in conv_mma's packed order for the io type.  bf16 != 0
// selects the bf16 io type.  C must be a multiple of 32 and at most
// MMA_MAX_C.
extern "C" int residual_stack_launch(const void* x, const void* const* params,
                                     void* out, int B, int T, int C, int tile,
                                     int d1, int d2, int d3, int bf16,
                                     void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 32 != 0 || C > MMA_MAX_C || tile <= 0 ||
      d1 <= 0 || d2 <= 0 || d3 <= 0)
    return (int)cudaErrorInvalidValue;
  const int d[3] = {d1, d2, d3};
  cudaStream_t s = (cudaStream_t)stream;
  // the three buffers leave an SM one block: 16 warps, not 8, to hide the
  // snakes' latency
  if (bf16)
    return launch<__nv_bfloat16, 512>(x, params, out, B, T, C, tile, d, s);
  return launch<float, 512>(x, params, out, B, T, C, tile, d, s);
}
