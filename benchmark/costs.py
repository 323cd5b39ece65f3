"""The yardstick's arithmetic: peak rates, the hand kernels' least time,
and the floating-point operations of each stage from the configuration's
widths and the shapes alone.

Nothing here reads the program.  ``kernel_cost`` is a frozen copy of the
port's count for its K1 / K2 / K3 kernels (each input read once, each
output written once, each unit's parameters read once); the stage counts
are the matmul and conv operations of the plain reference at the given
lengths, an FMA counted as 2, as ``torch.utils.flop_counter`` counts them
(the tests hold the two equal), plus the Snakes' arithmetic as
``kernel_cost`` counts it.  No count depends on what implements the work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

SNAKE_FLOP_PER_ELEM = 58  # 12 upsample FMAs + 2 snakes (mul, sin, square, FMA) + 12 decimation FMAs
KERNEL_UNITS = {"snake_filtered": 0, "residual_unit": 1, "residual_stack": 3}
KERNEL_NAMES = {"snake_filtered": "snake_filtered_kernel", "residual_unit": "residual_unit_kernel",
                "residual_stack": "residual_stack_kernel"}
DILATIONS = (1, 3, 9)


@dataclass(frozen=True)
class Peaks:
    """Dense peak rates of one card (NVIDIA's data sheet, at its 700 W
    limit): FLOP/s by arithmetic, bytes/s of HBM."""
    bf16: float
    tf32: float
    fp32: float
    bytes_per_s: float

    def flop_per_s(self, arithmetic: str) -> float:
        return {"bf16": self.bf16, "tf32": self.tf32, "fp32": self.fp32}[arithmetic]


PEAKS: Dict[str, Peaks] = {"NVIDIA H100 80GB HBM3": Peaks(989e12, 495e12, 67e12, 3.35e12)}


def kernel_cost(name: str, rows: int, c: int, io_bytes: int) -> Tuple[int, int]:
    """(flops, bytes) of one K1 / K2 / K3 call on ``rows`` = B * T rows of
    ``c`` channels with ``io_bytes`` a value (2 bfloat16, 4 float32)."""
    n, item = rows * c, io_bytes
    units = KERNEL_UNITS[name]
    if units == 0:
        return SNAKE_FLOP_PER_ELEM * n, 2 * item * n + 8 * c
    nbytes = 2 * item * n + units * (item * (8 * c * c + 2 * c) + 16 * c)
    flops = units * (16 * rows * c * c + 2 * SNAKE_FLOP_PER_ELEM * n + 2 * n)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, arithmetic: str, peaks: Peaks) -> float:
    """The larger of the operations over the peak and the bytes over HBM."""
    return max(flops / peaks.flop_per_s(arithmetic), nbytes / peaks.bytes_per_s)


# --- the codec's kernel launches at a length --------------------------------


def encoder_launches(samples: int, ngf: int, up: Sequence[int]) -> List[Tuple[str, int, int]]:
    """(kernel, rows, channels) of the encoder over ``samples`` (B = 1), one
    K2 a residual unit."""
    out, t, c = [], samples, ngf
    for s in up:
        out += [("residual_unit", t, c)] * len(DILATIONS) + [("snake_filtered", t, c)]
        t, c = t // s, 2 * c
    return out + [("snake_filtered", t, c)]


def decoder_launches(frames: int, channels: int, up: Sequence[int]) -> List[Tuple[str, int, int]]:
    """(kernel, rows, channels) of the decoder over ``frames`` (B = 1)."""
    out, t, c = [], frames, channels
    for s in up:
        out.append(("snake_filtered", t, c))
        t, c = t * s, c // 2
        out += [("residual_unit", t, c)] * len(DILATIONS)
    return out + [("snake_filtered", t, c)]


# --- stage operations (B = 1, exact lengths unless a bucket is named) --------


def _lin(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def _conv(t_out: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * t_out * c_in * c_out * k


def fft_layer(l: int, d: int, d_inner: int, kernels: Sequence[int]) -> int:
    """Self-attention (projections and both products) and conv feed-forward."""
    return 4 * _lin(l, d, d) + 2 * 2 * l * l * d + _conv(l, d, d_inner, kernels[0]) + _conv(
        l, d_inner, d, kernels[1])


def prior_encode(cfg: Dict, l: int) -> int:
    t = cfg["prior_generator"]["transformer"]
    return t["encoder_layer"] * fft_layer(l, t["encoder_hidden"], t["encoder_conv_filter_size"],
                                          t["encoder_conv_kernel_size"])


def pva(cfg: Dict, l: int, nfe: int) -> int:
    """Both flows' fields at every Euler step."""
    total = 0
    for g in ("duration_generator", "sil_generator"):
        v = cfg["prior_generator"]["variance_adaptor"][g]
        h, f, k, ts = v["input_size"], v["filter_size"], v["kernel_size"], v["time_scale"]
        total += (_lin(l, h + 1, h) + _lin(1, h, h * ts) + _lin(1, h * ts, h) + _conv(l, h, f, k)
                  + _conv(l, f, f, 3) + _lin(l, f, 1))
    return nfe * total


def prior_decode(cfg: Dict, t: int, p: int) -> int:
    """Bridge, shared decoder over the target, per quantizer a decoder over
    [prompt ‖ target], the head."""
    tc, codec = cfg["prior_generator"]["transformer"], cfg["prior_generator"]["codec"]
    d, f, k = tc["decoder_hidden"], tc["decoder_conv_filter_size"], tc["decoder_conv_kernel_size"]
    total = _lin(t, tc["encoder_hidden"], d) + tc["decoder_shared_layers"] * fft_layer(t, d, f, k)
    total += sum(tc["decoder_layers"]) * fft_layer(p + t, d, f, k)
    return total + codec["n_quantizers"] * _lin(t, d, codec["vocab_size"] + 1)


def prob_condition(cfg: Dict, t: int) -> int:
    pc = cfg["prob_generator"]
    c, total = pc["n_quantizers"] * pc["cond_dim"], 0
    for _ in range(pc["downsampling_stages"]):
        total += _lin(t, c, c) + _lin(t, c, c // 2)
        c //= 2
    return total + _lin(t, c, pc["target_dim"])


def prob_modulations(cfg: Dict, nfe: int) -> int:
    pc = cfg["prob_generator"]
    h, blocks = pc["hidden_dim"], pc["n_layers"]
    return (_lin(nfe, 256, h) + _lin(nfe, h, h) + _lin(1, pc["spk_dim"], h)
            + blocks * _lin(nfe, h, 6 * h) + _lin(nfe, h, 5 * h))


def prob_step(cfg: Dict, t: int) -> int:
    """One denoiser call over ``t`` frames."""
    pc = cfg["prob_generator"]
    h, k, e = pc["hidden_dim"], pc["convnext"]["kernel_size"], pc["convnext"]["expand"]
    convnext = 2 * t * h * k + _lin(t, h, h * e) + _lin(t, h * e, h)
    return (_lin(t, pc["target_dim"], h) + pc["n_layers"] * (convnext + 2 * _lin(t, h, h))
            + convnext + _conv(t, h, pc["target_dim"], 3))


def prob_sample(cfg: Dict, t: int, nfe: int) -> int:
    return prob_condition(cfg, t) + prob_modulations(cfg, nfe) + nfe * prob_step(cfg, t)


def _units(launches, io_bytes: int) -> int:
    return sum(kernel_cost(k, rows, c, io_bytes)[0] for k, rows, c in launches)


def kernel_elementwise(launches) -> int:
    """The Snakes' and residual adds' share of ``kernel_cost`` over
    ``launches``: all but the residual units' two convs."""
    return sum(kernel_cost(k, rows, c, 4)[0] - KERNEL_UNITS[k] * 16 * rows * c * c
               for k, rows, c in launches)


def codec_encode(codec: Dict, samples: int, io_bytes: int = 4) -> int:
    """Stem, strided convs, output conv, and the K1 / K2 work."""
    e = codec["encoder"]
    c, t = e["ngf"], samples
    total = _conv(t, 1, c, 7)
    for s in e["up_ratios"]:
        t = t // s
        total += _conv(t, c, 2 * c, 2 * s)
        c *= 2
    total += _conv(t, c, e["out_channels"], 3)
    return total + _units(encoder_launches(samples, e["ngf"], e["up_ratios"]), io_bytes)


def codec_analyze(codec: Dict, frames: int) -> int:
    """Six factorized VQ layers (projections in and out, the cosines against
    the codebook) and the timbre encoder."""
    d = codec["decoder"]
    dim, cb, size = d["vq_dim"], d["codebook_dim"], d["codebook_size"]
    n_vq = d["vq_num_q_p"] + d["vq_num_q_c"] + d["vq_num_q_r"]
    tm = codec["timbre"]
    layer = (_lin(frames, dim, 3 * dim) + 2 * 2 * frames * frames * dim + _lin(frames, dim, dim)
             + _conv(frames, dim, tm["ffn"], tm["kernel"]) + _lin(frames, tm["ffn"], dim))
    return n_vq * (_lin(frames, dim, cb) + 2 * frames * cb * size + _lin(frames, cb, dim)) + tm["layers"] * layer


def codec_embed(codec: Dict, frames: int) -> int:
    d = codec["decoder"]
    n_vq = d["vq_num_q_p"] + d["vq_num_q_c"] + d["vq_num_q_r"]
    return n_vq * _lin(frames, d["codebook_dim"], d["vq_dim"])


def codec_decode(codec: Dict, frames: int, io_bytes: int = 4) -> int:
    """Style projection, stem, transposed convs, output conv, and the K1 / K2
    work."""
    d = codec["decoder"]
    c, t = d["upsample_initial_channel"], frames
    total = _lin(1, d["vq_dim"], 2 * d["vq_dim"]) + _conv(t, d["in_channels"], c, 7)
    for s in d["up_ratios"]:
        total += 2 * t * c * (c // 2) * 2 * s  # transposed conv: every input row meets every tap
        t, c = t * s, c // 2
    total += _conv(t, c, 1, 7)
    return total + _units(decoder_launches(frames, d["upsample_initial_channel"], d["up_ratios"]),
                          io_bytes)


def synthesis_call(cfg: Dict, codec: Dict, l: int, t: int, p: int, prompt_samples: int, nfe_dur: int,
                   nfe_den: int, io_bytes: int) -> int:
    """One utterance of the served call: the prompt's analysis where
    ``prompt_samples``, both stages at the exact lengths, the codec's
    synthesis."""
    total = 0
    if prompt_samples:
        total += codec_encode(codec, prompt_samples, io_bytes) + codec_analyze(codec, prompt_samples // 200)
    total += prior_encode(cfg, l) + pva(cfg, l, nfe_dur) + prior_decode(cfg, t, p)
    return total + prob_sample(cfg, t, nfe_den) + codec_decode(codec, t, io_bytes)
