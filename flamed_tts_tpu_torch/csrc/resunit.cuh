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
// The convs are where the operations are (16 C^2 FLOPs a row against ~120 C
// in the snakes), and they run on two routes:
//
//   IO = float: conv_rows, scalar fp32 FMAs (a warp owns RT rows x 32 * CT
//     output channels).  Bound by the rate of its loads; it stays as it
//     is because TF32 tensor-core products would not keep fp32's digits.
//   IO = __nv_bfloat16: conv_mma, an implicit GEMM on the tensor cores
//     (mma.sync m16n8k16, bf16 operands, fp32 sums; M = rows, N = C,
//     K = taps * C).  A is the activation tile as it lies in shared memory,
//     [row][ci]: tap k is a row offset of k * dil, so ldmatrix reads it at
//     any row and no im2col copy exists.  Rows are MMA_PAD values longer
//     than C, which spreads the eight rows of an ldmatrix over all banks.
//     B is the weight, packed once on the host into the order of the mma B
//     fragments (ops/resunit.py, pack_mma_weights), so a stage of it is a
//     flat copy: the block streams it from L2 through two 16 KB stages with
//     cp.async (the next stage lands while this one is multiplied) and every
//     lane reads its fragments as two 16-byte shared loads without bank
//     conflicts.  A warp holds a 64 x 32 tile of sums in registers (16 mma
//     per 4 ldmatrix and 2 weight loads).  What bounds it now: shared-memory
//     reads (3 KB per warp and k16 step against 32768 multiply-adds, about
//     two thirds of the mma.sync rate at best), the weights, which every
//     block streams whole whatever its rows (at C = 512 a block of 32 conv
//     rows spends as long on the copies and barriers as on the products),
//     and at C >= 256 the few blocks a short input gives 132 SMs.  With the
//     convs on the tensor cores the two snakes are a large part of a unit's
//     time, half or more at C <= 256.
//
// Both routes sum over k, then ci, in one fixed order whatever tile the row
// falls in (conv_mma: one accumulator per output element, k16 steps in
// order, and an mma sum depends on its own A row and B column only);
// snake_rows (snake.cuh) likewise.  So an output element gets the same bits
// from any tiling, which is what lets the fused stack equal three
// single-unit launches exactly.
#pragma once

#include <type_traits>

#include "snake.cuh"

#define RT 8               // rows per work item of the fp32 conv
#define SMEM_LIMIT 232448  // bytes of shared memory one block may use on Hopper
#define MAX_DEVICES 64
#define MMA_PAD 8              // bf16 values added to a shared-memory row
#define MMA_STAGE_BYTES 16384  // one weight stage of conv_mma
#define MMA_STAGES 2           // stages in its ring
#define MMA_MAX_C 512          // widest conv whose pass fits a stage

// Values from one shared-memory row to the next, and the bytes of the weight
// stages, for an io type of `itemsize` bytes.
__host__ __device__ inline int smem_ld(int C, int itemsize) {
  return itemsize == 2 ? C + MMA_PAD : C;
}
__host__ __device__ inline int conv_stage_bytes(int itemsize) {
  return itemsize == 2 ? MMA_STAGES * MMA_STAGE_BYTES : 0;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Read-only load of one weight from device memory.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }

// The fp32 route (IO = float).
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

// ---- the bf16 route: implicit GEMM on the tensor cores ----

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of row
// l % 16, column block l / 16 of a 16 x 16 tile, and gets the mma A fragment.
__device__ __forceinline__ void ldmatrix_x4(unsigned& a0, unsigned& a1,
                                            unsigned& a2, unsigned& a3,
                                            unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
      : "r"(addr)
      : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// What conv_rows computes, for bf16: acc[r][co] = sum_{k<K} sum_ci
// w[k][ci][co] * in[(r + k * dil) * in_ld + ci] for r in [0, R), co in
// [0, C), fp32 sums; y = bf16(acc) + bias[co] as a bf16 add; without
// residual out[r * out_ld + co] = y for every row, with it
// out = residual[r * res_ld + co] + y (a bf16 add) for rows in [r_lo, r_hi)
// only.  out may be residual (an element is read, then written, by one
// thread).
//
// in: shared memory, rows 16-byte aligned.  wp: the weights in device memory
// in the packed order [k * C / 16 + ci / 16][co / 16][lane][8]: the 16 x 16
// block (ci, co) of tap k as the B fragments of two m16n8k16 products, lane
// l holding, for co = 16 * (co / 16) + 8 * h + l / 4 and h = 0, 1, the four
// values ci % 16 = 2 * (l % 4) + {0, 1, 8, 9}.  One such row of blocks (16
// ci x C co, 32 * C bytes) is a "slab"; the K loop walks the slabs in order.
// stage: conv_stage_bytes(2) of shared memory, 16-byte aligned.
//
// A warp's work item is 64 rows x 32 output channels; a pass gives each warp
// of the block one item and streams the slabs' columns that the pass needs
// through the ring of NS = MMA_STAGES stages, NS - 1 of them in flight while
// one is multiplied.  (On an H100 four stages measured no faster than two,
// and their 32 KB more cost the small widths a block per SM.)  Rows of a
// ragged last tile are computed on a clamped row and not stored.  The whole
// block of THREADS threads calls it; `in` must be visible to the block on
// entry, and the stores are not followed by a barrier.
template <int K, int THREADS>
__device__ void conv_mma(const __nv_bfloat16* in, int in_ld,
                         const __nv_bfloat16* __restrict__ wp,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* out, int out_ld,
                         const __nv_bfloat16* residual, int res_ld, int R,
                         int r_lo, int r_hi, int C, int dil,
                         unsigned char* stage) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NS = MMA_STAGES;
  constexpr int n_warps = THREADS / 32;
  // 16-byte copies of one stage that a thread makes
  constexpr int MMA_COPIES = MMA_STAGE_BYTES / 16 / THREADS;
  const int n_ng = C >> 5;  // groups of 32 output channels
  const int n_items = ((R + 63) >> 6) * n_ng;
  const int cb = C >> 4;  // slabs per tap
  const int n_slabs = K * cb;
  if (!residual) {
    r_lo = 0;
    r_hi = R;
  }
  const unsigned char* wbytes = reinterpret_cast<const unsigned char*>(wp);
  const unsigned in_s = (unsigned)__cvta_generic_to_shared(in);

  for (int item0 = 0; item0 < n_items; item0 += n_warps) {
    // the channel groups this pass needs: a range when its items share one
    // row group, else all
    const int last = min(item0 + n_warps, n_items) - 1;
    int j_lo = 0, j_hi = n_ng - 1;
    if (item0 / n_ng == last / n_ng) {
      j_lo = item0 % n_ng;
      j_hi = last % n_ng;
    }
    const int piece = (j_hi - j_lo + 1) * 1024;  // bytes of a slab it needs
    const int per = piece >> 4;                  // 16-byte copies in them
    const int ks = MMA_STAGE_BYTES / piece;      // slabs per stage
    const int n_stages = (n_slabs + ks - 1) / ks;
    const int item = item0 + warp;
    const bool active = item < n_items;
    const int r0 = active ? (item / n_ng) * 64 : 0;
    const int ng = active ? item % n_ng : j_lo;

    // mma tiles of the item that hold rows
    const int n_mt = active ? min(4, (R - r0 + 15) >> 4) : 0;
    unsigned a_addr[4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = min(r0 + mt * 16 + (lane & 15), R - 1);
      a_addr[mt] = in_s + (unsigned)((row * in_ld + (lane >> 4) * 8) * 2);
    }
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    // this thread's copies of a stage, the same in every stage: where in the
    // pass's part of the slabs (source) and in the stage (destination)
    int cp_sl[MMA_COPIES], cp_src[MMA_COPIES], cp_dst[MMA_COPIES];
#pragma unroll
    for (int j = 0; j < MMA_COPIES; ++j) {
      const int i = tid + j * THREADS;
      cp_sl[j] = i / per;
      const int off = (i - cp_sl[j] * per) * 16;
      cp_src[j] = cp_sl[j] * 32 * C + j_lo * 1024 + off;
      cp_dst[j] = cp_sl[j] * piece + off;
    }
    // copies stage st into its place in the ring; always commits a group
    // (an empty one past the end), so that "all but the newest NS - 2
    // groups" below always means "up to stage st"
    auto copy_stage = [&](int st) {
      if (st < n_stages) {
        const int s0 = st * ks;
        const int nsl = min(ks, n_slabs - s0);
        unsigned char* buf = stage + (st % NS) * MMA_STAGE_BYTES;
        const unsigned char* src = wbytes + (size_t)s0 * 32 * C;
#pragma unroll
        for (int j = 0; j < MMA_COPIES; ++j)
          if (cp_sl[j] < nsl) cp_async16(buf + cp_dst[j], src + cp_src[j]);
      }
      cp_async_commit();
    };

    __syncthreads();  // the ring is free: the pass before has been multiplied
#pragma unroll
    for (int st = 0; st < NS - 1; ++st) copy_stage(st);
    // the slab at hand: its chunk of input channels within the tap, and the
    // byte offset of (tap, chunk) from an A row's first value
    int cib = 0;
    unsigned a_tap = 0, a_off = 0;
    for (int st = 0; st < n_stages; ++st) {
      cp_async_wait<NS - 2>();
      // stage st has landed for every thread, and every warp is done with
      // stage st - 1, whose place the next copy takes
      __syncthreads();
      copy_stage(st + NS - 1);
      if (active) {
        const int nsl = min(ks, n_slabs - st * ks);
        const unsigned char* b = stage + (st % NS) * MMA_STAGE_BYTES +
                                 (ng - j_lo) * 1024 + lane * 16;
        for (int sl = 0; sl < nsl; ++sl, b += piece) {
          const uint4 b01 = *reinterpret_cast<const uint4*>(b);
          const uint4 b23 = *reinterpret_cast<const uint4*>(b + 512);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            if (mt < n_mt) {  // the same for the whole warp
              unsigned a0, a1, a2, a3;
              ldmatrix_x4(a0, a1, a2, a3, a_addr[mt] + a_off);
              mma_bf16(acc[mt][0], a0, a1, a2, a3, b01.x, b01.y);
              mma_bf16(acc[mt][1], a0, a1, a2, a3, b01.z, b01.w);
              mma_bf16(acc[mt][2], a0, a1, a2, a3, b23.x, b23.y);
              mma_bf16(acc[mt][3], a0, a1, a2, a3, b23.z, b23.w);
            }
          }
          a_off += 32;  // the next 16 input channels
          if (++cib == cb) {
            cib = 0;
            a_tap += (unsigned)(dil * in_ld * 2);  // the next tap: dil rows on
            a_off = a_tap;
          }
        }
      }
    }

    if (active) {
      // lane l holds rows l / 4 and l / 4 + 8, columns 2 * (l % 4) + {0, 1}
      // of each 16 x 8 tile
      const int g = lane >> 2;
      const int q = lane & 3;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + mt * 16 + half * 8 + g;
          if (r < r_lo || r >= r_hi) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int co = ng * 32 + nt * 8 + q * 2;
            const __nv_bfloat162 bv =
                *reinterpret_cast<const __nv_bfloat162*>(bias + co);
            __nv_bfloat16 y0 = io_add<__nv_bfloat16>(
                __float2bfloat16_rn(acc[mt][nt][half * 2]), bv.x);
            __nv_bfloat16 y1 = io_add<__nv_bfloat16>(
                __float2bfloat16_rn(acc[mt][nt][half * 2 + 1]), bv.y);
            if (residual) {
              const __nv_bfloat162 rv =
                  *reinterpret_cast<const __nv_bfloat162*>(
                      residual + (size_t)r * res_ld + co);
              y0 = io_add<__nv_bfloat16>(rv.x, y0);
              y1 = io_add<__nv_bfloat16>(rv.y, y1);
            }
            __nv_bfloat162 yv;
            yv.x = y0;
            yv.y = y1;
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * out_ld +
                                               co) = yv;
          }
        }
      }
    }
  }
}

// Parameters of one unit.  IO = float: w1t (7, C, C) laid out [k][ci][co],
// w2t (C, C) laid out [ci][co].  IO = __nv_bfloat16: both in conv_mma's
// packed order.  The snakes' log-scale alpha / beta stay fp32.
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
// residual add) and of the output, with row strides res_ld and dst_ld; only
// rows inside [0, T) are read from res and stored to dst.  h1 holds
// unit_h1_rows(n, d) rows of ld values, h2 unit_h2_rows(n), scr
// SNAKE_SCRATCH_FLOATS, stage conv_stage_bytes(sizeof(IO)).  With IO = float
// ld, res_ld and dst_ld are C.  The whole block of THREADS threads calls it;
// it does not end on a barrier.
//   1. snake1 over rows [a - 3d - 6, a + n + 3d + 6) into h1, zero outside
//      [0, T) (the conv's zero pad); the snake's own replicate pads clamp to
//      [0, T) inside snake_rows.
//   2. conv7 into h2 for rows [a - 6, a + n + 6).
//   3. snake2 of h2 into h3 (h1's space) for rows [a, a + n); its replicate
//      pads clamp to [0, T), which stays inside h2's rows.
//   4. conv1, bias and the residual add.
template <typename IO, int CT, int THREADS, class Src>
__device__ void unit_rows(const Src& src, const IO* res, int res_ld, IO* dst,
                          int dst_ld, int a, int n, int T, int C, int d,
                          const UnitParams<IO>& u, IO* h1, IO* h2, int ld,
                          float* scr, unsigned char* stage) {
  snake_rows<THREADS / 32>(src, T, C, a - 3 * d - 6, unit_h1_rows(n, d), 0, C,
                           u.la1, u.lb1, h1, ld, scr);
  if constexpr (std::is_same<IO, float>::value) {
    conv_rows<IO, CT, 7>(h1, u.w1t, u.b1, h2, nullptr, unit_h2_rows(n), 0, 0,
                         C, d);
  } else {
    conv_mma<7, THREADS>(h1, ld, u.w1t, u.b1, h2, ld, nullptr, 0,
                         unit_h2_rows(n), 0, 0, C, d, stage);
  }
  __syncthreads();
  IO* h3 = h1;
  snake_rows<THREADS / 32>(SharedRows<IO>{h2, ld, a - 6}, T, C, a, n, 0, C,
                           u.la2, u.lb2, h3, ld, scr);
  if constexpr (std::is_same<IO, float>::value) {
    conv_rows<IO, CT, 1>(h3, u.w2t, u.b2, dst, res, n, max(0, -a),
                         min(n, T - a), C, 1);
  } else {
    conv_mma<1, THREADS>(h3, ld, u.w2t, u.b2, dst, dst_ld, res, res_ld, n,
                         max(0, -a), min(n, T - a), C, 1, stage);
  }
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
