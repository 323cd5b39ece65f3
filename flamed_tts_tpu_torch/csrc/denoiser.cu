// The denoiser step's chains between its GEMMs (ops/convnext.py:
// AdaLNResBlock, ConvNeXtBlock, FinalLayer) as three kernels; the GEMMs stay
// on cuBLAS.  Activations are fp32 (B, T, C), channel-last and contiguous;
// an output that feeds a GEMM is written as its operand, bf16 or fp32.
//
//   norm_modulate_kernel  s = x + gate * (r1 + rb), or with r2
//                         x + gate * (r1 + (r2 + rb)) (s = x + rb without
//                         r1; rb, the bias of the product that gave the
//                         last term, 0 where absent);
//                         out = (LN(s) [* w + b]) * (1 + scale) + shift,
//                         zero on padded frames where a mask is given.
//                         Writes s (fp32, where asked) and out, or out's
//                         k3 windows for the final layer's conv.
//   conv_norm_kernel      the k31 depthwise conv (zero padding) of the input
//                         with padded frames zeroed, then its per-channel
//                         norm over the row's valid frames (mean and
//                         variance over n = max(valid, 1) frames, eps),
//                         * w + b, zero on padded frames.
//   act_kernel            GELU (erf) or SiLU of a GEMM's fp32 output plus the
//                         GEMM's bias.
// The products run without their bias (cuBLAS would copy it into the output
// first, one more kernel each); the kernel that reads a product adds it.
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA, which
// fuses them.  Unfused, the port ran each op of them as its own PyTorch
// kernel, some 200 a denoiser step.
//
// Bound on the H100: bytes.  A step of the serving denoiser (B = 1, T ~ 832,
// C = 1024) moves some 3.4 MB per fp32 activation read or written, against
// a few operations an element (31 FMAs an element in the conv, also far
// below the card's rate).  So each kernel reads its inputs once and writes
// its outputs once:
//   * norm_modulate: a block a frame, a thread a quad of its channels (one
//     16-byte load of each input), every load issued before the first use
//     (which inputs there are is a template, so that no load waits behind a
//     branch); mean and variance by shuffles and a few floats of shared
//     memory, both outputs written once.  (One warp a frame, 32 values a
//     lane, took longer at the serving shapes: its loads went out in turns.)
//   * conv_norm: the norm's statistics span the whole row in time, and the
//     conv is per channel, so a block owns 8 channels of one batch row (4
//     where T is too long for 8 in shared memory) for all T frames.  It
//     stages the masked input in shared memory by channel (a zero halo at
//     both ends), one warp a channel computes the 31-tap sums (a lane
//     CONV_RUN neighbouring outputs from a window in registers; CONV_RUN is
//     odd, so lanes CONV_RUN values apart read distinct banks), keeps them
//     in shared memory and reduces the statistics within the warp; the block
//     then writes normalized rows, its channels of a frame at once.  No
//     reduction crosses blocks and nothing is atomic: a replay gives the
//     same bits.
//   * act: one float4 a thread.
// Elementwise arithmetic follows the plain chain's order, one rounding an
// operation (__fmul_rn / __fadd_rn, so no contraction into FMAs); only the
// order of the sums differs.  bf16 is written by round to nearest even, as
// PyTorch casts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SMEM_LIMIT 232448  // bytes of shared memory one block may use on Hopper
#define MAX_DEVICES 64
#define NM_MAX_THREADS 256 // a norm_modulate block: a frame, a quad of channels a thread
#define CONV_K 31          // taps of the depthwise conv
#define CONV_RUN 7         // outputs a lane computes from one window
#define CONV_LOADS 8       // input quads a conv_norm thread keeps in flight
#define ACT_THREADS 256

// a frame's modulation row: p + b * sb + t * st (st = 0: one row a batch row)
struct Mod {
  const float* p;
  int sb, st;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

// (n * (1 + scale)) + shift, as modulate() in ops/convnext.py
__device__ __forceinline__ float modulate(float n, float shift, float scale) {
  return __fadd_rn(__fmul_rn(n, __fadd_rn(1.0f, scale)), shift);
}

template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------- norm_modulate

// s of one frame: x (+ rb), or x + gate * (r1 + rb), or x + gate * (r1 + (r2 + rb))
#define NM_X 0
#define NM_X_RB 1
#define NM_R1 2
#define NM_R1_R2 3

template <int MODE, bool AFFINE, bool WIN, typename OUT>
__global__ void __launch_bounds__(NM_MAX_THREADS)
norm_modulate_kernel(const float* __restrict__ x, const float* __restrict__ r1,
                     const float* __restrict__ r2, const float* __restrict__ rb, Mod gate,
                     Mod shift, Mod scale, const float* __restrict__ w,
                     const float* __restrict__ bias, const unsigned char* __restrict__ pad,
                     float* __restrict__ s_out, OUT* __restrict__ out, int T, int C,
                     float eps) {
  __shared__ float part[2][NM_MAX_THREADS / 32];
  const int row = blockIdx.x, b = row / T, t = row - b * T;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  // a thread's quad of channels; a thread past C reads quad 0 and counts 0
  const int c = threadIdx.x * 4;
  const bool on = c < C;
  const int cq = on ? c : 0;
  const size_t base = (size_t)row * C;
  // every load first, none behind a branch, so that they are in flight at once
  float4 v = load4(x + base + cq);
  const float4 shv = load4(shift.p + (size_t)b * shift.sb + (size_t)t * shift.st + cq);
  const float4 scv = load4(scale.p + (size_t)b * scale.sb + (size_t)t * scale.st + cq);
  float4 wv, bv;
  if (AFFINE) {
    wv = load4(w + cq);
    bv = load4(bias + cq);
  }
  if (MODE == NM_X_RB) v = add4(v, load4(rb + cq));
  if (MODE >= NM_R1) {
    const float4 g = load4(gate.p + (size_t)b * gate.sb + (size_t)t * gate.st + cq);
    float4 r = MODE == NM_R1_R2 ? add4(load4(r2 + base + cq), load4(rb + cq))
                                : add4(load4(r1 + base + cq), load4(rb + cq));
    if (MODE == NM_R1_R2) r = add4(load4(r1 + base + cq), r);
    v = add4(v, mul4(g, r));
  }
  if (!on) v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // mean and variance over the row: warps' sums in smem, added in one order
  float sum = warp_sum((v.x + v.y) + (v.z + v.w));
  if (lane == 0) part[0][wp] = sum;
  __syncthreads();
  sum = 0.0f;
  for (int k = 0; k < nw; ++k) sum += part[0][k];
  const float mean = __fdiv_rn(sum, (float)C);
  const float dx = v.x - mean, dy = v.y - mean, dz = v.z - mean, dw = v.w - mean;
  float sq = on ? (dx * dx + dy * dy) + (dz * dz + dw * dw) : 0.0f;
  sq = warp_sum(sq);
  if (lane == 0) part[1][wp] = sq;
  __syncthreads();
  sq = 0.0f;
  for (int k = 0; k < nw; ++k) sq += part[1][k];
  const float sd = sqrtf(__fdiv_rn(sq, (float)C) + eps);
  if (!on) return;
  if (s_out != nullptr) store4(s_out + base + c, v);
  float n[4] = {__fdiv_rn(dx, sd), __fdiv_rn(dy, sd), __fdiv_rn(dz, sd), __fdiv_rn(dw, sd)};
  if (AFFINE) {
    n[0] = __fadd_rn(__fmul_rn(n[0], wv.x), bv.x);
    n[1] = __fadd_rn(__fmul_rn(n[1], wv.y), bv.y);
    n[2] = __fadd_rn(__fmul_rn(n[2], wv.z), bv.z);
    n[3] = __fadd_rn(__fmul_rn(n[3], wv.w), bv.w);
  }
  float4 o = make_float4(modulate(n[0], shv.x, scv.x), modulate(n[1], shv.y, scv.y),
                         modulate(n[2], shv.z, scv.z), modulate(n[3], shv.w, scv.w));
  if (pad != nullptr && pad[row]) o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (!WIN) {
    store4(out + base + c, o);
    return;
  }
  // the k3 windows of the next product, tap-major: row t holds frame
  // t + j - 1 at j C + c (zero beyond the row's ends)
  OUT* r = out + 3 * base + c;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  store4(r + C, o);                                       // tap 1 of row t
  if (t + 1 < T) store4(r + 3 * (size_t)C, o);            // tap 0 of row t + 1
  if (t > 0) store4(r - 3 * (size_t)C + 2 * C, o);        // tap 2 of row t - 1
  if (t == 0) store4(r, zero4);                           // tap 0 of row 0
  if (t + 1 == T) store4(r + 2 * C, zero4);               // tap 2 of row T - 1
}

template <int MODE, bool AFFINE, bool WIN>
static void nm_run(const float* x, const float* r1, const float* r2, const float* rb, Mod gate,
                   Mod shift, Mod scale, const float* w, const float* bias,
                   const unsigned char* pad, float* s_out, void* out, int rows, int T, int C,
                   float eps, int bf16, cudaStream_t stream) {
  const int threads = ((C / 4 + 31) / 32) * 32;
  if (bf16)
    norm_modulate_kernel<MODE, AFFINE, WIN, __nv_bfloat16><<<rows, threads, 0, stream>>>(
        x, r1, r2, rb, gate, shift, scale, w, bias, pad, s_out, (__nv_bfloat16*)out, T, C, eps);
  else
    norm_modulate_kernel<MODE, AFFINE, WIN, float><<<rows, threads, 0, stream>>>(
        x, r1, r2, rb, gate, shift, scale, w, bias, pad, s_out, (float*)out, T, C, eps);
}

template <int MODE>
static void nm_mode(const float* x, const float* r1, const float* r2, const float* rb, Mod gate,
                    Mod shift, Mod scale, const float* w, const float* bias,
                    const unsigned char* pad, float* s_out, void* out, int rows, int T, int C,
                    float eps, int win, int bf16, cudaStream_t s) {
  if (w != nullptr && win)
    nm_run<MODE, true, true>(x, r1, r2, rb, gate, shift, scale, w, bias, pad, s_out, out, rows,
                             T, C, eps, bf16, s);
  else if (w != nullptr)
    nm_run<MODE, true, false>(x, r1, r2, rb, gate, shift, scale, w, bias, pad, s_out, out, rows,
                              T, C, eps, bf16, s);
  else if (win)
    nm_run<MODE, false, true>(x, r1, r2, rb, gate, shift, scale, w, bias, pad, s_out, out, rows,
                              T, C, eps, bf16, s);
  else
    nm_run<MODE, false, false>(x, r1, r2, rb, gate, shift, scale, w, bias, pad, s_out, out,
                               rows, T, C, eps, bf16, s);
}

// x, r1, r2, s_out: (B, T, C) fp32; s = x where r1 and rb are null, x + rb
// where r1 is null, else x + gate * (r1 + rb), or with r2 x + gate * (r1 +
// (r2 + rb)), rb (C,) required then; gate, shift, scale: modulation rows
// (see Mod), 16-byte aligned; w, bias: (C,) or both null (no affine); pad:
// (B, T) bytes, nonzero = padded frame, or null (no mask on out); s_out
// null: s not written.  win != 0: out is (B, T, 3 C), the k3 windows of the
// normalized rows, tap-major (row t holds frame t + j - 1 at j C + c, zero
// beyond the ends).  C a multiple of 4 up to 4 * NM_MAX_THREADS.  bf16 != 0:
// out is bf16.
extern "C" int norm_modulate_launch(const float* x, const float* r1, const float* r2,
                                    const float* rb, const float* gate, int gate_sb, int gate_st,
                                    const float* shift, const float* scale, int mod_sb,
                                    int mod_st, const float* w, const float* bias,
                                    const unsigned char* pad, float* s_out, void* out, int B,
                                    int T, int C, float eps, int win, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || C > 4 * NM_MAX_THREADS ||
      (r1 != nullptr && rb == nullptr) || (w == nullptr) != (bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const Mod g = {gate, gate_sb, gate_st}, sh = {shift, mod_sb, mod_st},
            sc = {scale, mod_sb, mod_st};
  const int rows = B * T;
  cudaStream_t s = (cudaStream_t)stream;
  if (r1 == nullptr && rb == nullptr)
    nm_mode<NM_X>(x, r1, r2, rb, g, sh, sc, w, bias, pad, s_out, out, rows, T, C, eps, win, bf16, s);
  else if (r1 == nullptr)
    nm_mode<NM_X_RB>(x, r1, r2, rb, g, sh, sc, w, bias, pad, s_out, out, rows, T, C, eps, win,
                     bf16, s);
  else if (r2 == nullptr)
    nm_mode<NM_R1>(x, r1, r2, rb, g, sh, sc, w, bias, pad, s_out, out, rows, T, C, eps, win, bf16,
                   s);
  else
    nm_mode<NM_R1_R2>(x, r1, r2, rb, g, sh, sc, w, bias, pad, s_out, out, rows, T, C, eps, win,
                      bf16, s);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- conv_norm

// floats of a channel's staged input: T frames, the conv's halo at both
// ends, and CONV_RUN more zeros that the last window may read
__host__ __device__ inline int conv_ld(int T) { return T + CONV_K - 1 + CONV_RUN; }

extern "C" int conv_norm_smem_bytes(int T, int ch) {
  return (int)(((size_t)ch * conv_ld(T) + 2 * ch) * sizeof(float) + T);
}

template <int CH, typename OUT>
__global__ void __launch_bounds__(CH * 32)
conv_norm_kernel(const float* __restrict__ x, const float* __restrict__ cw,
                 const float* __restrict__ cb, const float* __restrict__ gw,
                 const float* __restrict__ gb, const unsigned char* __restrict__ pad,
                 OUT* __restrict__ out, int T, int C, float eps) {
  constexpr int NT = CH * 32, Q = CH / 4, HALO = CONV_K / 2;
  extern __shared__ __align__(16) float smem[];
  const int ld = conv_ld(T);
  // [CH][ld]: the masked input by channel (frame t at HALO + t), then the
  // conv's sums in its place (frame t at t)
  float* in = smem;
  float* stat = in + CH * ld;         // [CH][2]: mean, 1 / sqrt(var + eps)
  unsigned char* valid = reinterpret_cast<unsigned char*>(stat + 2 * CH);  // [T]
  const int b = blockIdx.y, c0 = blockIdx.x * CH, tid = threadIdx.x;
  const int wp = tid >> 5, lane = tid & 31, c = c0 + wp, q = tid % Q;
  const size_t row0 = (size_t)b * T;
  // the parameters first: their loads are in flight while the input arrives
  // (a warp's channel's taps and bias; a thread's quad's affine, NT % Q == 0)
  float tap[CONV_K], w4[4], b4[4];
#pragma unroll
  for (int k = 0; k < CONV_K; ++k) tap[k] = __ldg(cw + (size_t)c * CONV_K + k);
  const float bias = __ldg(cb + c);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w4[j] = __ldg(gw + c0 + 4 * q + j);
    b4[j] = __ldg(gb + c0 + 4 * q + j);
  }

  for (int i = tid; i < CH * (ld - T); i += NT) {
    const int ch = i / (ld - T), j = i - ch * (ld - T);
    in[ch * ld + (j < HALO ? j : T + j)] = 0.0f;
  }
  // the masked input, CONV_LOADS quads of a thread in flight at once (their
  // frames' mask bytes first); the thread of a frame's first quad records
  // whether the frame is valid
  for (int i0 = tid; i0 < T * Q; i0 += CONV_LOADS * NT) {
    bool ok[CONV_LOADS];
#pragma unroll
    for (int u = 0; u < CONV_LOADS; ++u) {
      const int i = i0 + u * NT;
      ok[u] = i < T * Q && (pad == nullptr || !pad[row0 + i / Q]);
    }
    float4 v[CONV_LOADS];
#pragma unroll
    for (int u = 0; u < CONV_LOADS; ++u) {
      const int i = i0 + u * NT, t = i / Q;
      v[u] = ok[u] ? load4(x + (row0 + t) * C + c0 + 4 * (i - t * Q))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < CONV_LOADS; ++u) {
      const int i = i0 + u * NT, t = i / Q, q = i - t * Q;
      if (i < T * Q) {
        if (q == 0) valid[t] = ok[u];
        float* dst = in + 4 * q * ld + HALO + t;
        dst[0] = v[u].x;
        dst[ld] = v[u].y;
        dst[2 * ld] = v[u].z;
        dst[3 * ld] = v[u].w;
      }
    }
  }
  __syncthreads();

  // a warp a channel: the conv, then the statistics over the valid frames
  float* yc = in + wp * ld;
  float sum = 0.0f;
  int n_valid = 0;
  // a pass of the warp reads the inputs of frames from its first one on and
  // writes the sums of its frames in place, below the next pass's inputs;
  // the lanes have read their windows before any lane writes
  for (int t0 = lane * CONV_RUN; t0 - lane * CONV_RUN < T; t0 += 32 * CONV_RUN) {
    float win[CONV_RUN + CONV_K - 1];
#pragma unroll
    for (int m = 0; m < CONV_RUN + CONV_K - 1; ++m) win[m] = t0 < T ? yc[t0 + m] : 0.0f;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CONV_RUN; ++j) {
      float acc = bias;
#pragma unroll
      for (int k = 0; k < CONV_K; ++k) acc = fmaf(tap[k], win[j + k], acc);
      if (t0 + j < T) {
        yc[t0 + j] = acc;
        if (valid[t0 + j]) {
          sum += acc;
          ++n_valid;
        }
      }
    }
  }
  const float n = (float)max(warp_sum_int(n_valid), 1);
  const float mean = __fdiv_rn(warp_sum(sum), n);
  float sq = 0.0f;
  for (int t = lane; t < T; t += 32)
    if (valid[t]) {
      const float d = yc[t] - mean;
      sq += d * d;
    }
  const float rsd = __frcp_rn(sqrtf(__fdiv_rn(warp_sum(sq), n) + eps));
  if (lane == 0) {
    stat[2 * wp] = mean;
    stat[2 * wp + 1] = rsd;
  }
  __syncthreads();

  // rows of CH channels: a thread writes its quad of channels
  float m4[4], s4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m4[j] = stat[2 * (4 * q + j)];
    s4[j] = stat[2 * (4 * q + j) + 1];
  }
  for (int i = tid; i < T * Q; i += NT) {
    const int t = i / Q;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = __fmul_rn(in[(4 * q + j) * ld + t] - m4[j], s4[j]);
      o[j] = valid[t] ? __fadd_rn(__fmul_rn(v, w4[j]), b4[j]) : 0.0f;
    }
    store4(out + (row0 + t) * C + c0 + 4 * q, make_float4(o[0], o[1], o[2], o[3]));
  }
}

template <int CH, typename OUT>
static int cn_launch(const float* x, const float* cw, const float* cb, const float* gw,
                     const float* gb, const unsigned char* pad, void* out, int B, int T, int C,
                     float eps, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(conv_norm_kernel<CH, OUT>, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(C / CH, B);
  conv_norm_kernel<CH, OUT><<<grid, CH * 32, conv_norm_smem_bytes(T, CH), stream>>>(
      x, cw, cb, gw, gb, pad, (OUT*)out, T, C, eps);
  return (int)cudaGetLastError();
}

// x: (B, T, C) fp32; cw: (C, CONV_K) taps; cb, gw, gb: (C,); pad: (B, T)
// bytes or null.  Eight channels a block, four where T is too long for
// eight in shared memory.  C a multiple of 8.  bf16 != 0: out is bf16.
extern "C" int conv_norm_launch(const float* x, const float* cw, const float* cb,
                                const float* gw, const float* gb, const unsigned char* pad,
                                void* out, int B, int T, int C, float eps, int bf16,
                                void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (conv_norm_smem_bytes(T, 8) <= SMEM_LIMIT)
    return bf16 ? cn_launch<8, __nv_bfloat16>(x, cw, cb, gw, gb, pad, out, B, T, C, eps, s)
                : cn_launch<8, float>(x, cw, cb, gw, gb, pad, out, B, T, C, eps, s);
  if (conv_norm_smem_bytes(T, 4) <= SMEM_LIMIT)
    return bf16 ? cn_launch<4, __nv_bfloat16>(x, cw, cb, gw, gb, pad, out, B, T, C, eps, s)
                : cn_launch<4, float>(x, cw, cb, gw, gb, pad, out, B, T, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- act

#define ACT_GELU 0
#define ACT_SILU 1

template <int ACT>
__device__ __forceinline__ float act(float v) {
  if (ACT == ACT_GELU)  // x * 0.5 * (1 + erf(x / sqrt(2)))
    return __fmul_rn(__fmul_rn(v, 0.5f),
                     __fadd_rn(1.0f, erff(__fmul_rn(v, 0.7071067811865476f))));
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));  // x / (1 + exp(-x))
}

template <int ACT, typename OUT>
__global__ void __launch_bounds__(ACT_THREADS)
act_kernel(const float* __restrict__ y, const float* __restrict__ bias, OUT* __restrict__ out,
           int n4, int N) {
  const int i = blockIdx.x * ACT_THREADS + threadIdx.x;
  if (i >= n4) return;
  float4 v = load4(y + 4 * (size_t)i);
  if (bias != nullptr) v = add4(v, load4(bias + (4 * i) % N));
  store4(out + 4 * (size_t)i, make_float4(act<ACT>(v.x), act<ACT>(v.y), act<ACT>(v.z),
                                          act<ACT>(v.w)));
}

template <int ACT>
static void act_run(const float* y, const float* bias, void* out, int n4, int N, int bf16,
                    cudaStream_t s) {
  const int grid = (n4 + ACT_THREADS - 1) / ACT_THREADS;
  if (bf16)
    act_kernel<ACT, __nv_bfloat16><<<grid, ACT_THREADS, 0, s>>>(y, bias, (__nv_bfloat16*)out,
                                                                n4, N);
  else
    act_kernel<ACT, float><<<grid, ACT_THREADS, 0, s>>>(y, bias, (float*)out, n4, N);
}

// y: n fp32 values, rows of N (n and N multiples of 4, n below 2^33);
// bias: (N,) or null; act: ACT_GELU or ACT_SILU.  bf16 != 0: out is bf16.
extern "C" int act_launch(const float* y, const float* bias, void* out, long long n, int N,
                          int act, int bf16, void* stream) {
  if (n <= 0 || N <= 0 || n % N != 0 || N % 4 != 0 || n / 4 > 0x7fffffffLL ||
      (act != ACT_GELU && act != ACT_SILU))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (act == ACT_GELU)
    act_run<ACT_GELU>(y, bias, out, (int)(n / 4), N, bf16, s);
  else
    act_run<ACT_SILU>(y, bias, out, (int)(n / 4), N, bf16, s);
  return (int)cudaGetLastError();
}
