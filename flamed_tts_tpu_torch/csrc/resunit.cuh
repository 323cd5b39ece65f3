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
// in the snakes).  Both io types run them as one implicit GEMM on the tensor
// cores, conv_mma (M = rows, N = C, K = taps * C, fp32 sums):
//
//   IO = __nv_bfloat16: mma.sync m16n8k16, bf16 operands.
//   IO = float: mma.sync m16n8k8 on TF32 operands, three products a step
//     ("3xTF32").  One TF32 product keeps 11 of fp32's 24 mantissa bits, so
//     each operand is split in registers into a = a_hi + a_lo (a_hi = a
//     rounded to TF32, a_lo = a - a_hi, exact, of which the tensor cores
//     read the upper 11 bits; split_tf32 below), and a_lo * b_hi,
//     a_hi * b_lo, a_hi * b_hi are summed on the tensor cores in that order,
//     small terms first, starting from zero.  What is dropped, a_lo * b_lo
//     and the cut bits of the low halves, is about 2^-20 of a product.  The
//     step's sum is then added to the accumulator
//     by an fp32 add outside the tensor cores: they add by truncation, and
//     letting them carry the running sum through the 1344 mma of a C = 512
//     conv put the unit 2.6e-4 from its plain version on the trained codec's
//     weights (a K step's own sum is small beside the running sum, so its
//     truncation costs little).  Against a float64 result the unit is then
//     closer than the plain fp32 version is (chip_smoke.py prints both).
//
//   A is the activation tile as it lies in shared memory, [row][ci]: tap k
//   is a row offset of k * dil, so ldmatrix reads it at any row and no
//   im2col copy exists (for fp32, ldmatrix's 8 x 16-byte matrices are 8 rows
//   x 4 floats, and a lane's 32 bits are exactly its m16n8k8 A value).  Rows
//   are 16 bytes longer than C values, which spreads the eight rows of an
//   ldmatrix over all banks.  B is the weight, packed once on the host into
//   the order of the mma B fragments (ops/resunit.py, pack_mma_weights), so
//   a stage of it is a flat copy: the block streams it from L2 through two
//   16 KB stages with cp.async (the next stage lands while this one is
//   multiplied) and every lane reads its fragments as two 16-byte shared
//   loads without bank conflicts.  Either type's K step is 32 bytes of an A
//   row and 32 * C bytes of weights (a "slab"), so the copies, the ring and
//   the addresses are the same code; only the product differs.  A warp
//   holds up to a 64 x 32 tile of sums in registers.  What bounds it: in
//   bf16, shared-memory reads (3 KB per warp and k16 step against 32768
//   multiply-adds).  In fp32, instructions: a warp's k8 step is 48 mma, a
//   third of them carrying the product, 72 integer and float operations for
//   the splits and 64 adds, and none of these alone is most of the time;
//   and shared memory's size, which at C = 512 leaves a block 96 rows: 20
//   output rows at d <= 3 and 4 at d = 9, where a launch is 320 blocks that
//   each stream all the weights for 16 conv rows and is the slowest of the
//   codec's.  In both, the weights, which every block streams whole whatever
//   its rows (16 C^2 bytes in bf16, 32 C^2 in fp32), and at C >= 256 the few
//   blocks a short input gives 132 SMs.
//
// The sum over k, then ci, runs in one fixed order whatever tile the row
// falls in (one accumulator per output element, K steps in order, and an
// mma sum depends on its own A row and B column only); snake_rows
// (snake.cuh) likewise.  So an output element gets the same bits from any
// tiling, which is what lets the fused stack equal three single-unit
// launches exactly.
//
// Past MMA_PASS_BYTES of values a row (fp32 at C > 512: the FaCodec
// redecoder's C = 640 at its reference width), h1's halo of 6d + 12 rows
// leaves no tile room in 227 KB, so the dilated conv reduces over its input
// channels in unit_passes() passes: each pass holds its slice of snake 1's
// rows in h1, sums its slabs over k, then ci, and keeps the running sums as
// fp32 in h2 for the next pass (CONV_SUMS_OUT / CONV_SUMS_IN), which adds on
// to them exactly as if the loop had not stopped.  The order there is pass,
// k, ci: a function of (C, io type) alone, so the bits still do not depend
// on the tile.  At C <= 512 (and for every bf16 width up to MMA_MAX_C)
// there is one pass and the order is the one above.
#pragma once

#include "snake.cuh"

#define SMEM_LIMIT 232448  // bytes of shared memory one block may use on Hopper
#define MAX_DEVICES 64
#define MMA_PAD_BYTES 16       // added to a shared-memory row
#define MMA_STAGE_BYTES 16384  // one weight stage of conv_mma
#define MMA_STAGES 2           // stages in its ring
#define MMA_MAX_C 640          // widest conv the kernels take (the redecoder's)
#define MMA_PASS_BYTES 2048    // widest slice of h1 one pass of the dilated conv holds

// conv_mma's running sums: start from the fp32 sums in `out` (CONV_SUMS_IN),
// and store them there as they are, with no bias, rounding or residual
// (CONV_SUMS_OUT); both for the passes of a split reduction, fp32 io only.
#define CONV_SUMS_IN 1
#define CONV_SUMS_OUT 2

// Values from one shared-memory row to the next for an io type of
// `itemsize` bytes, and the bytes of the weight stages.
__host__ __device__ inline int smem_ld(int C, int itemsize) {
  return C + MMA_PAD_BYTES / itemsize;
}
// Passes of the dilated conv's reduction over input channels: 1 up to
// MMA_PASS_BYTES of values a row (fp32 C <= 512, bf16 C <= 1024), else 2
// (C is at most MMA_MAX_C), each over C / passes channels.
__host__ __device__ inline int unit_passes(int C, int itemsize) {
  return (C * itemsize + MMA_PASS_BYTES - 1) / MMA_PASS_BYTES;
}
__host__ __device__ inline int conv_stage_bytes() {
  return MMA_STAGES * MMA_STAGE_BYTES;
}

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

// Four 8 x 16-byte matrices from shared memory: lane l gives the address of
// row l % 16, 16-byte column l / 16 of a tile of 16 rows x 32 bytes, and gets
// the mma A fragment of that tile (16 x 16 bf16 for m16n8k16, 16 x 8 fp32 for
// m16n8k8).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16) * b (16 x 8, bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, fp32) += a (16 x 8, TF32) * b (8 x 8, TF32).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, fp32) = a (16 x 8, TF32) * b (8 x 8, TF32).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// The fp32 bits v as hi + lo for the TF32 products: hi = v rounded to TF32's
// 10 mantissa bits, to nearest with ties away, which is what cvt.rna.tf32.f32
// gives, here by an integer add and a mask (the conversion instruction runs
// at a quarter of their rate, and a K step splits 48 values a lane); lo = the
// remainder v - hi, exact in fp32 and passed as it is: the tensor cores read
// the upper 19 bits of an operand, which cuts lo to TF32 at 2^-21 of v.
__device__ __forceinline__ void split_tf32(unsigned v, unsigned& hi,
                                           unsigned& lo) {
  hi = (v + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(__uint_as_float(v), __uint_as_float(hi)));
}

// The B fragments of one slab for a warp's four n8 tiles, as its lane read
// them from the stage: b[2 * nt], b[2 * nt + 1] are the two registers of
// tile nt.  In fp32 each is split once for the slab's (up to) four m16
// tiles.
template <typename IO>
struct BFrag;
template <>
struct BFrag<__nv_bfloat16> {
  unsigned b[8];
  __device__ __forceinline__ BFrag(const uint4& lo, const uint4& hi)
      : b{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w} {}
  // acc (16 rows x 32 columns) += a * this
  __device__ __forceinline__ void mma(float (&acc)[4][4],
                                      const unsigned (&a)[4]) const {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], a, b[2 * nt], b[2 * nt + 1]);
  }
};
template <>
struct BFrag<float> {
  unsigned bh[8], bl[8];
  __device__ __forceinline__ BFrag(const uint4& lo, const uint4& hi) {
    const unsigned b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) split_tf32(b[i], bh[i], bl[i]);
  }
  // acc += a * this: three TF32 products summed from zero on the tensor
  // cores, the two small ones first, then one fp32 add (to nearest)
  __device__ __forceinline__ void mma(float (&acc)[4][4],
                                      const unsigned (&a)[4]) const {
    unsigned ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float step[4];
      mma_tf32_zero(step, al, bh[2 * nt], bh[2 * nt + 1]);
      mma_tf32(step, ah, bl[2 * nt], bl[2 * nt + 1]);
      mma_tf32(step, ah, bh[2 * nt], bh[2 * nt + 1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], step[e]);
    }
  }
};

// Two neighbouring io values, as one load or store.
template <typename IO>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

// acc[r][co] = sum_{k<K} sum_{ci<C_in} w[k][ci][co] * in[(r + k * dil) * in_ld + ci]
// for r in [0, R), co in [0, C), fp32 sums; y = IO(acc) + bias[co] as an IO
// add; without residual out[r * out_ld + co] = y for every row, with it
// out = residual[r * res_ld + co] + y (an IO add) for rows in [r_lo, r_hi)
// only (the others lie outside [0, T)).  out may be residual (an element is
// read, then written, by one thread).
//
// With `sums` (CONV_SUMS_IN / CONV_SUMS_OUT, no residual) acc starts from,
// or is stored as, the fp32 sums in out (fp32 io only).
//
// in: shared memory, rows 16-byte aligned.  wp: the weights in device memory
// in the packed order [k * C_in / KS + ci / KS][co / 16][lane][16 bytes], where
// KS = 32 / sizeof(IO) input channels (16 in bf16, 8 in fp32) make one K
// step.  The 16 bytes are the lane's B fragments of the two n8 tiles
// h = 0, 1 of the block's 16 output channels, co = 16 * (co / 16) + 8 * h +
// l / 4: in bf16 the four values ci % 16 = 2 * (l % 4) + {0, 1, 8, 9} of
// each, in fp32 the two values ci % 8 = l % 4 + {0, 4}.  One such row of
// blocks (KS ci x C co, 32 * C bytes) is a "slab"; the K loop walks the
// slabs in order.  stage: conv_stage_bytes() of shared memory, 16-byte
// aligned.
//
// A warp's work item is 16 * MT rows x 32 output channels, MT = 4, 2 or 1
// mma tiles.  An item's rows share its B fragments and their splits, so more
// rows an item are cheaper, as long as the block's warps all have one: a
// C = 32 conv of 112 rows is 2 items of 64 rows, but 7 of 16.  MT is the one
// that makes passes * (MT + 1) least, an item's fixed cost (its B fragments,
// the stage's barrier) taken as one tile's.  A pass gives each warp of the
// block one item and streams the slabs' columns that the pass needs (the
// channel groups of its items, consecutive modulo C / 32, so at most one a
// warp: 16 KB for 16 warps, which is one stage whatever C is)
// through the ring of NS = MMA_STAGES stages, NS - 1 of them in flight while
// one is multiplied.  (On an H100 four stages measured no faster than two in
// bf16, and their 32 KB more cost the small widths a block per SM.)  Rows of
// a ragged last tile are computed on a clamped row and not stored.  The whole
// block of THREADS threads calls it; `in` must be visible to the block on
// entry, and the stores are not followed by a barrier.
template <typename IO, int K, int THREADS>
__device__ void conv_mma(const IO* in, int in_ld, int C_in,
                         const IO* __restrict__ wp,
                         const IO* __restrict__ bias, IO* out, int out_ld,
                         const IO* residual, int res_ld, int R, int r_lo,
                         int r_hi, int C, int dil, unsigned char* stage,
                         int sums = 0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int NS = MMA_STAGES;
  constexpr int n_warps = THREADS / 32;
  constexpr int KS = 32 / (int)sizeof(IO);  // input channels of a K step
  // 16-byte copies of one stage that a thread makes
  constexpr int MMA_COPIES = MMA_STAGE_BYTES / 16 / THREADS;
  const int n_ng = C >> 5;  // groups of 32 output channels
  // mma tiles (16 rows) of an item
  int item_mt = 4, least = 1 << 30;
  for (int mt = 4; mt >= 1; mt >>= 1) {
    const int items = ((R + 16 * mt - 1) / (16 * mt)) * n_ng;
    const int cost =
        ((items + n_warps - 1) / n_warps) * (min(mt, (R + 15) >> 4) + 1);
    if (cost < least) {
      least = cost;
      item_mt = mt;
    }
  }
  const int item_rows = 16 * item_mt;
  const int n_items = ((R + item_rows - 1) / item_rows) * n_ng;
  const int cb = C_in / KS;  // slabs per tap
  const int n_slabs = K * cb;
  if (!residual) {
    r_lo = 0;
    r_hi = R;
  }
  const unsigned char* wbytes = reinterpret_cast<const unsigned char*>(wp);
  const unsigned in_s = (unsigned)__cvta_generic_to_shared(in);
  const unsigned row_bytes = (unsigned)in_ld * (unsigned)sizeof(IO);

  for (int item0 = 0; item0 < n_items; item0 += n_warps) {
    // the channel groups this pass needs: its items' groups are consecutive
    // modulo n_ng, from j_lo on (all of them once it has n_ng items)
    const int count = min(n_warps, n_items - item0);
    const int n_pg = min(count, n_ng);
    const int j_lo = count >= n_ng ? 0 : item0 % n_ng;
    const int piece = n_pg * 1024;  // bytes of a slab it needs
    const int per = piece >> 4;                  // 16-byte copies in them
    const int ks = MMA_STAGE_BYTES / piece;      // slabs per stage
    const int n_stages = (n_slabs + ks - 1) / ks;
    const int item = item0 + warp;
    const bool active = item < n_items;
    const int r0 = active ? (item / n_ng) * item_rows : 0;
    const int ng = active ? item % n_ng : j_lo;

    // mma tiles of the item that hold rows
    const int n_mt = active ? min(item_mt, (R - r0 + 15) >> 4) : 0;
    unsigned a_addr[4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = min(r0 + mt * 16 + (lane & 15), R - 1);
      a_addr[mt] = in_s + (unsigned)row * row_bytes + (unsigned)(lane >> 4) * 16;
    }
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    using P = typename Pair<IO>::type;
    // lane l holds rows l / 4 and l / 4 + 8, columns 2 * (l % 4) + {0, 1}
    // of each 16 x 8 tile
    const int g = lane >> 2;
    const int q = lane & 3;
    if (active && (sums & CONV_SUMS_IN)) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + mt * 16 + half * 8 + g;
          if (mt >= n_mt || r >= R) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const P v = *reinterpret_cast<const P*>(
                out + (size_t)r * out_ld + ng * 32 + nt * 8 + q * 2);
            acc[mt][nt][half * 2] = to_f(v.x);
            acc[mt][nt][half * 2 + 1] = to_f(v.y);
          }
        }
      }
    }

    // this thread's copies of a stage, the same in every stage: where in the
    // pass's part of the slabs (source) and in the stage (destination)
    int cp_sl[MMA_COPIES], cp_src[MMA_COPIES], cp_dst[MMA_COPIES];
#pragma unroll
    for (int j = 0; j < MMA_COPIES; ++j) {
      const int i = tid + j * THREADS;
      cp_sl[j] = i / per;
      const int off = (i - cp_sl[j] * per) * 16;
      const int jj = j_lo + (off >> 10);  // the channel group, cyclically
      cp_src[j] = cp_sl[j] * 32 * C + (jj < n_ng ? jj : jj - n_ng) * 1024 +
                  (off & 1023);
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
                                 (ng >= j_lo ? ng - j_lo : ng - j_lo + n_ng) * 1024 +
                                 lane * 16;
        for (int sl = 0; sl < nsl; ++sl, b += piece) {
          const BFrag<IO> bf(*reinterpret_cast<const uint4*>(b),
                             *reinterpret_cast<const uint4*>(b + 512));
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            if (mt < n_mt) {  // the same for the whole warp
              unsigned a[4];
              ldmatrix_x4(a, a_addr[mt] + a_off);
              bf.mma(acc[mt], a);
            }
          }
          a_off += 32;  // the next KS input channels
          if (++cib == cb) {
            cib = 0;
            a_tap += (unsigned)dil * row_bytes;  // the next tap: dil rows on
            a_off = a_tap;
          }
        }
      }
    }

    if (active) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + mt * 16 + half * 8 + g;
          if (mt >= n_mt || r < r_lo || r >= r_hi) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int co = ng * 32 + nt * 8 + q * 2;
            P yv;
            if (sums & CONV_SUMS_OUT) {  // the running sums, as they are
              yv.x = from_f<IO>(acc[mt][nt][half * 2]);
              yv.y = from_f<IO>(acc[mt][nt][half * 2 + 1]);
              *reinterpret_cast<P*>(out + (size_t)r * out_ld + co) = yv;
              continue;
            }
            const P bv = *reinterpret_cast<const P*>(bias + co);
            yv.x = io_add<IO>(from_f<IO>(acc[mt][nt][half * 2]), bv.x);
            yv.y = io_add<IO>(from_f<IO>(acc[mt][nt][half * 2 + 1]), bv.y);
            if (residual) {
              const P rv = *reinterpret_cast<const P*>(
                  residual + (size_t)r * res_ld + co);
              yv.x = io_add<IO>(rv.x, yv.x);
              yv.y = io_add<IO>(rv.y, yv.y);
            }
            *reinterpret_cast<P*>(out + (size_t)r * out_ld + co) = yv;
          }
        }
      }
    }
  }
}

// Parameters of one unit: w1t (7 taps) and w2t (1 tap) in conv_mma's packed
// order for IO; w1t pass by pass where unit_passes(C) > 1 (the packed
// weights of each pass's input channels, one after the other).  The snakes' log-scale alpha / beta stay fp32.
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
// Values of h1 in K2's shared memory: unit_h1_rows of one pass's slice of
// the channels, or the n full rows of h3 that take its place, whichever is
// more.  With one pass, unit_h1_rows(n, d) * smem_ld(C).
__host__ __device__ inline int unit_h1_values(int n, int d, int C,
                                              int itemsize) {
  const int a = unit_h1_rows(n, d) * smem_ld(C / unit_passes(C, itemsize), itemsize);
  const int b = n * smem_ld(C, itemsize);
  return a > b ? a : b;
}

// The unit's output rows [a, a + n) (absolute row numbers; a may be
// negative and a + n may pass T).  src reads an input row in [0, T);
// res and dst point at the element (row a, channel 0) of the input (for the
// residual add) and of the output, with row strides res_ld and dst_ld; only
// rows inside [0, T) are read from res and stored to dst.  h1 holds
// unit_h1_values(n, d, C, sizeof(IO)) values, h2 unit_h2_rows(n) rows of ld
// values, stage conv_stage_bytes().  The whole block of THREADS threads
// calls it; it does not end on a barrier.
//   1. snake1 over rows [a - 3d - 6, a + n + 3d + 6) into h1, zero outside
//      [0, T) (the conv's zero pad); the snake's own replicate pads clamp to
//      [0, T) inside snake_rows.
//   2. conv7 into h2 for rows [a - 6, a + n + 6).  Past MMA_PASS_BYTES a
//      row, 1 and 2 run once per pass over a slice of the input channels
//      (h1 then holds the slice, rows ldp values apart), the sums carried
//      in h2 from one pass to the next.
//   3. snake2 of h2 into h3 (h1's space) for rows [a, a + n); its replicate
//      pads clamp to [0, T), which stays inside h2's rows.
//   4. conv1, bias and the residual add.
template <typename IO, int THREADS, class Src>
__device__ void unit_rows(const Src& src, const IO* res, int res_ld, IO* dst,
                          int dst_ld, int a, int n, int T, int C, int d,
                          const UnitParams<IO>& u, IO* h1, IO* h2, int ld,
                          unsigned char* stage) {
  const int np = unit_passes(C, (int)sizeof(IO));
  const int cp = C / np;                      // input channels of a pass
  const int ldp = smem_ld(cp, (int)sizeof(IO));
  for (int p = 0; p < np; ++p) {
    // every warp is done reading the last pass's slice from h1
    if (p) __syncthreads();
    // channels [p cp, (p + 1) cp) of snake 1, stored from h1's column 0
    snake_rows<THREADS / 32>(src, T, a - 3 * d - 6, unit_h1_rows(n, d), p * cp,
                             (p + 1) * cp, u.la1, u.lb1, h1 - p * cp, ldp);
    conv_mma<IO, 7, THREADS>(h1, ldp, cp, u.w1t + (size_t)p * 7 * cp * C, u.b1,
                             h2, ld, nullptr, 0, unit_h2_rows(n), 0, 0, C, d,
                             stage,
                             (p ? CONV_SUMS_IN : 0) |
                                 (p < np - 1 ? CONV_SUMS_OUT : 0));
  }
  __syncthreads();
  IO* h3 = h1;
  snake_rows<THREADS / 32>(SharedRows<IO>{h2, ld, a - 6}, T, a, n, 0, C, u.la2,
                           u.lb2, h3, ld);
  conv_mma<IO, 1, THREADS>(h3, ld, C, u.w2t, u.b2, dst, dst_ld, res, res_ld, n,
                           max(0, -a), min(n, T - a), C, 1, stage);
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
