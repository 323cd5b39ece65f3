"""Component benchmark of the port: per-stage device time, work counts and
shares of the card's peaks at the serving shapes.

    python -m flamed_tts_tpu_torch.bench_components [--which codec,pieces,prior,convforms,mfu]
        [--dtype bf16|fp32] [--batch 1] [--nfe 64] [--device cuda|cpu]

The JAX package's ``tools/bench_components.py`` on PyTorch: the same
sections, rows, shapes and order (B = --batch for mfu, 1 elsewhere; P =
256 prompt codes, L = 768 frames, 64 phonemes, a 3 s prompt of 240
frames), random weights from seeded ``torch.Generator``s and inputs from
``numpy.random.RandomState`` seeds.  It prints a header, the rows, and as
its last line one JSON object with every row.

Timing.  On the card a stage's N calls are captured in one CUDA graph and
the graph is replayed once under CUDA events (``utils.profiling.graph_ms``):
device time, with no host launch cost (``graph`` rows; the header prints
what a captured call of one trivial kernel costs, the floor of a row).  A
stage that reads the host inside (a synchronising copy or read, found by
running it once under ``torch.cuda.set_sync_debug_mode("error")``), or
whose capture fails, is timed by CUDA events around N back-to-back calls
(``events`` rows, the host's launch cost included).  On the CPU
(``--device cpu``) ``time.perf_counter`` over N calls (``host`` rows).
TF32 is off for the run (matmuls and cuDNN), so float32 arithmetic is
float32 and the float32 peak bounds it.

Counting.  A stage's FLOPs are ``FlopCounterMode``'s (matmul, convolution,
attention) plus the hand kernels' analytic count (``ops/costs.py``), and
its bytes every aten op's tensor inputs and outputs (views excluded) plus
the hand kernels' least bytes: unfused bytes, an upper bound on what a
fusing compiler moves, not XLA's fused "bytes accessed".  Loops are counted
whole (the PVA flow, the denoiser's nfe steps), never one step scaled.  The
count is the same on the card and on the CPU, whichever route a hand
kernel takes.  The shares are of the peaks of ``--dtype`` on this card
(``ops/costs.py::PEAKS``); a share above 100 % means the count or the timer
is wrong, and the tool raises.

bf16 is the port's serving precision: the codec's parameters and
activations in bfloat16 (K1 / K2 bfloat16 io, cuDNN bfloat16 convs), the
prior's and the denoiser's weights rounded to bfloat16 with float32
activations (``Flamed.cast_inference_params``), so their rows compute in
float32 under either --dtype.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.config import load_default_config
from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.facodec.decoder import analyze, decoder_block, init_decoder_params
from flamed_tts_tpu_torch.models.facodec.encoder import encoder_forward, init_encoder_params
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.models.prior.sampling import pva_sample
from flamed_tts_tpu_torch.ops import costs
from flamed_tts_tpu_torch.ops.conv1d import conv1d, conv_transpose1d
from flamed_tts_tpu_torch.ops.length_regulator import length_regulate
from flamed_tts_tpu_torch.ops.resunit import residual_unit
from flamed_tts_tpu_torch.ops.snake import snake_filtered
from flamed_tts_tpu_torch.utils.profiling import events_ms, graph_ms, nvidia_smi_line

N_ITERS = 50  # calls a timing; the JAX tool's n = 10 and 20 rows take N_ITERS // 5 and 2 * N_ITERS // 5
P, L = 256, 768  # prompt codes, target frames (the serving bucket)
LSRC = 64  # phonemes
PROMPT_FRAMES = 240  # a 3 s prompt
TEMPERATURE = 0.3  # the PVA flow's, as the JAX tool's
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
SECTIONS = ("codec", "pieces", "prior", "convforms", "mfu")


@dataclass
class Stage:
    """One row: ``run()`` is one call of the stage (what is timed), ``n``
    its calls a timing, ``times`` what one call's ms is multiplied by
    (the denoiser step: nfe), ``count`` what the count runs (default:
    ``run``)."""
    name: str
    run: Callable
    n: int
    times: int = 1
    count: Optional[Callable] = None


def _iters(jax_n: int) -> int:
    """Calls a timing for a JAX tool row of ``jax_n`` fori-loop iterations."""
    return max(1, N_ITERS * jax_n // 50)


class Bench:
    """The device, io type, peaks and timers of one run; ``row`` times and
    counts a stage."""

    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.on_card = device.type == "cuda"
        self.peaks = costs.device_peaks(device) if self.on_card else None
        self.rows: List[Dict] = []

    def time(self, fn: Callable, n: int):
        """(ms per call, 'graph' | 'events' | 'host')."""
        if not self.on_card:
            fn()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return 1e3 * (time.perf_counter() - t0) / n, "host"
        if _reads_host(fn):
            return events_ms(fn, n), "events"
        try:
            return graph_ms(fn, n), "graph"
        except RuntimeError as exc:  # a capture the stage does not allow
            torch.cuda.synchronize()
            print(f"[bench_components] capture failed ({str(exc).splitlines()[0]}): CUDA events instead",
                  flush=True)
            return events_ms(fn, n), "events"

    def count(self, stage: Stage) -> Dict:
        """One call of ``stage.count`` under a ``CostCounter``: FLOPs, bytes,
        the hand-kernel calls it counted and (on the card) the launches the
        wrappers made."""
        if self.on_card:
            torch.cuda.synchronize()
        kernels.reset_launches()
        with costs.CostCounter() as cc:
            (stage.count or stage.run)()
        if self.on_card:
            torch.cuda.synchronize()
        return {"flops": cc.flops, "bytes": cc.bytes, "kernel_calls": dict(cc.kernels),
                "launches": dict(kernels.launches)}

    def row(self, section: str, stage: Stage, quiet: bool = False, **extra) -> Dict:
        counted = self.count(stage)
        ms, how = self.time(stage.run, stage.n)
        ms *= stage.times
        if not (np.isfinite(ms) and ms > 0):
            raise RuntimeError(f"{stage.name}: {ms} ms")
        flops, nbytes = counted["flops"], counted["bytes"]
        tflops, gbs = flops / (ms * 1e-3) / 1e12, nbytes / (ms * 1e-3) / 1e9
        r = {"section": section, "name": stage.name, "ms": ms, "timing": how, "n": stage.n,
             "gflop": flops / 1e9, "gb": nbytes / 1e9, "tflops": tflops, "gbs": gbs,
             "flop_pct": None, "hbm_pct": None, **counted, **extra}
        if self.on_card:
            r["flop_pct"] = 100 * tflops * 1e12 / self.peaks.flop_per_s(self.dtype)
            r["hbm_pct"] = 100 * gbs * 1e9 / self.peaks.bytes_per_s
            if r["flop_pct"] > 100 or r["hbm_pct"] > 100:
                raise RuntimeError(f"{stage.name}: {r['flop_pct']:.1f} % of the FLOP peak, "
                                   f"{r['hbm_pct']:.1f} % of the HBM rate: the count or the timer "
                                   "is wrong")
        if not quiet:
            print(self.format(r), flush=True)
        self.rows.append(r)
        return r

    def format(self, r: Dict) -> str:
        share = (f"{r['tflops']:7.2f} TF/s ({r['flop_pct']:5.1f}% peak)  {r['gbs']:7.1f} GB/s "
                 f"({r['hbm_pct']:5.1f}% HBM)" if self.on_card else
                 f"{r['tflops']:7.3f} TF/s  {r['gbs']:7.2f} GB/s (host)")
        return (f"  {r['name']:<44} {r['ms']:9.3f} ms {r['timing']:<6}  {r['gflop']:9.2f} GF "
                f"{r['gb']:7.3f} GB  {share}")


def _reads_host(fn: Callable) -> bool:
    """Whether one call of ``fn`` synchronises with the host (a read, or a
    copy from pageable memory): then no CUDA graph can hold it."""
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return False
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode(before)
        torch.cuda.synchronize()


def graph_floor_ms() -> float:
    """Device ms of one captured call of a trivial kernel (a one-element
    add): the floor under every ``graph`` row."""
    x = torch.zeros(1, device="cuda")
    return graph_ms(lambda: x.add_(1.0), N_ITERS)


# ----- the models and inputs (full width from configs/*.yaml) -------------


def make_codec(cfg: Dict, dtype: torch.dtype, device: torch.device) -> FaCodec:
    """Random encoder and decoder, each from a generator seeded 0 (the JAX
    tool's PRNGKey(0) for both), rounded to ``dtype``."""
    enc, dec = cfg["codec_cfg"]["encoder"], cfg["codec_cfg"]["decoder"]
    codec = FaCodec(init_encoder_params(torch.Generator().manual_seed(0), enc["ngf"], enc["up_ratios"],
                                        enc["out_channels"]),
                    init_decoder_params(torch.Generator().manual_seed(0), dec["in_channels"],
                                        dec["upsample_initial_channel"], dec["up_ratios"]),
                    device=device, up_ratios_enc=enc["up_ratios"], up_ratios_dec=dec["up_ratios"])
    if dtype == torch.bfloat16:
        codec.cast_inference_params()
    return codec


def make_model(cfg: Dict, dtype: torch.dtype, device: torch.device) -> Flamed:
    """Random prior and prob generators from a generator seeded 0; bf16:
    their weights rounded as the port serves them."""
    model = Flamed(cfg, device=device, generator=torch.Generator().manual_seed(0))
    if dtype == torch.bfloat16:
        model.cast_inference_params()
    return model


def _normal(rng: np.random.RandomState, shape, dtype, device) -> torch.Tensor:
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device=device, dtype=dtype)


def _block_shapes(codec: FaCodec, frames: int) -> List[tuple]:
    """(L, C in, C out, stride) of each decoder block over ``frames``."""
    shapes, t = [], frames
    for blk, s in zip(codec.dec_params["blocks"], codec.up_ratios_dec):
        ci, co = blk["up"]["w"].shape[:2]
        shapes.append((t, int(ci), int(co), s))
        t *= s
    return shapes


# ----- the sections ---------------------------------------------------------


def bench_codec(bench: Bench, codec: FaCodec) -> None:
    dp, dtype, dev = codec.dec_params, bench.dtype, bench.device
    rng = np.random.RandomState(1)
    lat = _normal(rng, (1, L, dp["stem"]["w"].shape[1]), dtype, dev)
    timbre = _normal(np.random.RandomState(2), (1, 256), dtype, dev)
    bench.row("codec", Stage("codec synthesize total", lambda: codec.decode(lat, timbre), _iters(10)))
    stem = lambda: conv1d(lat, dp["stem"]["w"], dp["stem"]["b"], padding=3)
    c_in, c_out = dp["stem"]["w"].shape[1], dp["stem"]["w"].shape[0]
    bench.row("codec", Stage(f"stem conv {c_in}->{c_out} @ {L}", stem, N_ITERS))
    x = stem()
    for i, (blk, stride, prepared) in enumerate(zip(dp["blocks"], codec.up_ratios_dec, codec.dec_prepared)):
        run = lambda x=x, blk=blk, s=stride, w=prepared: decoder_block(x, blk, s, prepared=w)
        bench.row("codec", Stage(f"block{i} C{x.shape[2]}->{x.shape[2] // 2} L{x.shape[1]} stride{stride}",
                                 run, _iters(20)))
        x = run()


def bench_codec_pieces(bench: Bench, codec: FaCodec) -> None:
    """Inside one decoder block: snake vs conv-transpose vs the residual
    units (K2 x 3 at d = 1, 3, 9)."""
    dp = codec.dec_params
    for i, (t, ci, co, s) in enumerate(_block_shapes(codec, L)):
        p, prepared = dp["blocks"][i], codec.dec_prepared[i]
        x = _normal(np.random.RandomState(i), (1, t, ci), bench.dtype, bench.device)
        up = lambda p=p, s=s, x=x: conv_transpose1d(x, p["up"]["w"], p["up"]["b"], stride=s,
                                               padding=s // 2 + s % 2, output_padding=s % 2)
        y = up()

        def res(p=p, w=prepared, y=y):
            v = y
            for unit, prep, d in zip(p["res"], w, (1, 3, 9)):
                v = residual_unit(v, unit, d, prep)
            return v

        label = f"block{i} L{t} C{ci}"
        bench.row("pieces", Stage(f"{label}: snake",
                                  lambda p=p, x=x: snake_filtered(x, p["act"]["alpha"], p["act"]["beta"]),
                                  N_ITERS))
        bench.row("pieces", Stage(f"{label}: convT", up, N_ITERS))
        bench.row("pieces", Stage(f"{label}: res x3", res, _iters(20)))


def bench_prior(bench: Bench, model: Flamed) -> None:
    inp = _prior_inputs(np.random.RandomState(0), 1, model, bench.device)
    bench.row("prior", Stage(f"prior decode (shared+6 dec, {P}+{L})",
                             lambda: model.prior.decode(inp["lr_out"], inp["tgt_mask"], inp["prompts"],
                                                        inp["p_lens"]), _iters(10)))


def _prior_inputs(rng, b: int, model: Flamed, dev) -> Dict:
    n_q = model.prior.n_quantizers
    return {"lr_out": _normal(rng, (b, L, model.prior.enc_hidden), torch.float32, dev),
            "tgt_mask": torch.zeros((b, L), dtype=torch.bool, device=dev),
            "prompts": torch.ones((b, n_q, P), dtype=torch.int64, device=dev),
            "p_lens": torch.full((b,), P, dtype=torch.int64, device=dev)}


def poly_weights(w: torch.Tensor, s: int, pad: int) -> torch.Tensor:
    """conv_transpose1d's weight (C in, C out, 2s) as the polyphase taps
    (s, 3, C in, C out): output phase r takes x[l + 1], x[l], x[l - 1]."""
    ci, co, k = w.shape
    taps = torch.zeros((s, 3, ci, co), dtype=torch.float32)
    for r in range(s):
        for p_, j in enumerate((-1, 0, 1)):
            tap = j * s + r + pad
            if 0 <= tap < k:
                taps[r, p_] = w[:, :, tap].float().cpu()
    return taps.to(device=w.device, dtype=w.dtype)


def poly_conv_transpose(v: torch.Tensor, wt: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The strided conv-transpose as one matmul over (x[l + 1], x[l], x[l - 1])."""
    bsz, length, ci = v.shape
    s, co = wt.shape[0], wt.shape[3]
    zero = torch.zeros((bsz, 1, ci), dtype=v.dtype, device=v.device)
    xx = torch.stack([torch.cat([v[:, 1:], zero], 1), v, torch.cat([zero, v[:, :-1]], 1)], dim=2)
    y = torch.einsum("blpc,rpcd->blrd", xx, wt)
    return y.reshape(bsz, length * s, co) + b


def im2col_weights(w: torch.Tensor) -> torch.Tensor:
    """conv1d's weight (C out, C in, k) as the (k * C in, C out) matrix."""
    co, ci, k = w.shape
    return w.permute(2, 1, 0).reshape(k * ci, co).contiguous()


def im2col_conv(v: torch.Tensor, wm: torch.Tensor, b: torch.Tensor, k: int, dil: int) -> torch.Tensor:
    """The same-padded dilated conv as one matmul over the k shifted copies."""
    length = v.shape[1]
    padc = ((k - 1) * dil) // 2
    vp = F.pad(v, (0, 0, padc, padc))
    cols = torch.cat([vp[:, i * dil: i * dil + length] for i in range(k)], dim=-1)
    return cols @ wm + b


def conv1d_shapes(codec: FaCodec) -> List[tuple]:
    """(L, C in, C out, dilation) of the k7 conv rows: the stem, then a
    residual unit's conv at the first two blocks' and the last widths (the
    JAX tool's (768, 256, 1024, 1), (3840, 512, 512, 1 and 9), (19200, 256,
    256, 1), (76800, 64, 64, 1) at full width)."""
    dp = codec.dec_params
    blocks = _block_shapes(codec, L)
    t1, t2, t3 = (t * s for t, _, _, s in blocks[:3])
    c1, c2, c4 = blocks[0][2], blocks[1][2], blocks[3][2]
    return [(L, int(dp["stem"]["w"].shape[1]), int(dp["stem"]["w"].shape[0]), 1), (t1, c1, c1, 1),
            (t1, c1, c1, 9), (t2, c2, c2, 1), (t3, c4, c4, 1)]


def bench_convforms(bench: Bench, codec: FaCodec) -> None:
    """PyTorch's conv-transpose (cuDNN on the card) vs the polyphase
    matmul; its conv1d vs im2col; the max abs difference of each pair
    (``max_abs_err``, beside the library output's peak, ``out_max_abs``)."""
    dtype, dev = bench.dtype, bench.device
    print("conv_transpose: F.conv_transpose1d vs polyphase matmul", flush=True)
    for t, ci, co, s in _block_shapes(codec, L):
        k, pad = 2 * s, s // 2 + s % 2
        w = _normal(np.random.RandomState(0), (ci, co, k), dtype, dev) * 0.02
        b = torch.zeros(co, dtype=dtype, device=dev)
        x = _normal(np.random.RandomState(1), (1, t, ci), dtype, dev)
        wt = poly_weights(w, s, pad)
        ref = lambda: conv_transpose1d(x, w, b, stride=s, padding=pad, output_padding=s % 2)
        poly = lambda: poly_conv_transpose(x, wt, b)
        out = ref().float()
        err, peak = float((poly().float() - out).abs().max()), float(out.abs().max())
        label = f"convT L{t} {ci}->{co} s{s}"
        r0 = bench.row("convforms", Stage(f"{label}: convT", ref, N_ITERS), quiet=True, max_abs_err=err,
                       out_max_abs=peak)
        r1 = bench.row("convforms", Stage(f"{label}: poly", poly, N_ITERS), quiet=True, max_abs_err=err,
                       out_max_abs=peak)
        print(f"  {label}: convT {r0['ms']:7.3f}  poly {r1['ms']:7.3f} ms  (maxerr {err:.2e})", flush=True)
    print("conv1d k7: F.conv1d vs im2col matmul", flush=True)
    for t, ci, co, dil in conv1d_shapes(codec):
        k, padc = 7, (6 * dil) // 2
        w = _normal(np.random.RandomState(0), (co, ci, k), dtype, dev) * 0.02
        b = torch.zeros(co, dtype=dtype, device=dev)
        x = _normal(np.random.RandomState(1), (1, t, ci), dtype, dev)
        wm = im2col_weights(w)
        ref = lambda: conv1d(x, w, b, padding=padc, dilation=dil)
        i2c = lambda: im2col_conv(x, wm, b, k, dil)
        out = ref().float()
        err, peak = float((i2c().float() - out).abs().max()), float(out.abs().max())
        label = f"conv1d L{t} {ci}->{co} d{dil}"
        r0 = bench.row("convforms", Stage(f"{label}: conv", ref, N_ITERS), quiet=True, max_abs_err=err,
                       out_max_abs=peak)
        r1 = bench.row("convforms", Stage(f"{label}: im2col", i2c, N_ITERS), quiet=True, max_abs_err=err,
                       out_max_abs=peak)
        print(f"  {label}: conv {r0['ms']:7.3f}  im2col {r1['ms']:7.3f} ms  (maxerr {err:.2e})", flush=True)


def mfu_stages(model: Flamed, codec: FaCodec, dtype: torch.dtype, batch: int, nfe: int,
               device: torch.device) -> tuple:
    """(the ten stages of the mfu table in the JAX tool's order, their
    inputs).  Every stage reads its inputs from the returned dict when it
    runs, so a caller may replace one (a test hands in the JAX draws)."""
    prior, prob, dec = model.prior, model.prob, codec.dec_params
    cfg = model.cfg["prob_generator"]
    b, dev = batch, device
    rng = np.random.RandomState(0)
    inp: Dict = {
        "ts": torch.linspace(0.0, 1.0, nfe + 1, dtype=torch.float32, device=dev)[:-1],
        "spk": _normal(rng, (b, cfg["spk_dim"]), torch.float32, dev),
        "pad": torch.zeros((b, L), dtype=torch.bool, device=dev),
        "x": _normal(rng, (b, L, cfg["target_dim"]), torch.float32, dev),
        **_prior_inputs(rng, b, model, dev),
        "lat": _normal(rng, (b, L, dec["stem"]["w"].shape[1]), dtype, dev),
        "timbre": _normal(rng, (b, 256), dtype, dev),
        "wav": _normal(rng, (b, PROMPT_FRAMES * codec.hop, 1), dtype, dev),
        "phonemes": torch.ones((b, LSRC), dtype=torch.int64, device=dev),
        "src_mask": torch.zeros((b, LSRC), dtype=torch.bool, device=dev),
        "enc_out": _normal(rng, (b, LSRC, prior.enc_hidden), torch.float32, dev),
        "dur_noise": _normal(rng, (b, LSRC), torch.float32, dev),
        "sil_noise": _normal(rng, (b, LSRC), torch.float32, dev),
        "phone_dur": torch.full((b, LSRC), 7.0, dtype=torch.float32, device=dev),
        "sil_dur": torch.full((b, LSRC), 1.0, dtype=torch.float32, device=dev),
        "src_lens": torch.full((b,), LSRC, dtype=torch.int64, device=dev),
        "plat": _normal(rng, (b, PROMPT_FRAMES, dec["stem"]["w"].shape[1]), dtype, dev),
        "pmask": torch.zeros((b, PROMPT_FRAMES), dtype=torch.bool, device=dev),
        "hid": _normal(rng, (b, prob.n_quantizers, L, cfg["cond_dim"]), torch.float32, dev),
    }
    inp["mods"] = prob.denoiser.compute_mods(inp["ts"], inp["spk"])
    den = prob.denoiser

    def step():
        return den(inp["x"], [m[0] for m in inp["mods"]], inp["pad"])

    def all_steps():
        for i in range(nfe):
            den(inp["x"], [m[i] for m in inp["mods"]], inp["pad"])

    seconds = PROMPT_FRAMES * codec.hop / codec.sr
    stages = [
        Stage(f"denoiser step x{nfe} (extrapolated)", step, N_ITERS, times=nfe, count=all_steps),
        Stage(f"prior decode (shared+6 dec, {P}+{L})",
              lambda: prior.decode(inp["lr_out"], inp["tgt_mask"], inp["prompts"], inp["p_lens"]),
              _iters(10)),
        Stage(f"codec decode ({L}f -> {L * codec.hop / codec.sr:.1f}s wav)",
              lambda: codec.decode(inp["lat"], inp["timbre"]), _iters(10)),
        Stage(f"prompt encode ({seconds:g} s wav)",
              lambda: encoder_forward(codec.enc_params, inp["wav"], codec.up_ratios_enc,
                                      prepared=codec.enc_prepared), _iters(10)),
        Stage(f"phoneme encode (L={LSRC})", lambda: prior.encode(inp["phonemes"], inp["src_mask"]),
              _iters(10)),
        Stage(f"PVA dur+sil flow x{nfe} (scan)",
              lambda: pva_sample(prior, inp["enc_out"], inp["src_mask"], inp["dur_noise"],
                                 inp["sil_noise"], nfe, TEMPERATURE), _iters(10)),
        Stage(f"length regulator ({LSRC} -> {L})",
              lambda: length_regulate(inp["enc_out"], inp["phone_dur"], inp["sil_dur"], inp["src_lens"],
                                      L)[0], _iters(10)),
        Stage(f"codec analyze (RVQ+timbre, {PROMPT_FRAMES}f)", lambda: analyze(dec, inp["plat"], inp["pmask"]),
              _iters(10)),
        Stage("denoiser condition path (once)", lambda: prob.encode_condition(inp["hid"], inp["pad"]),
              _iters(10)),
        Stage(f"adaLN mods precompute ({nfe} steps, once)", lambda: den.compute_mods(inp["ts"], inp["spk"]),
              _iters(10)),
    ]
    return stages, inp


def bench_mfu(bench: Bench, model: Flamed, codec: FaCodec, batch: int, nfe: int) -> Dict:
    """The ten stages of one serving call, then the compute floor: their
    summed ms over the audio's seconds, and the whole call's FLOP share of
    the --dtype peak."""
    stages, _ = mfu_stages(model, codec, bench.dtype, batch, nfe, bench.device)
    name = "bf16" if bench.dtype == torch.bfloat16 else "fp32"
    peaks = (f"peaks: {bench.peaks.flop_per_s(bench.dtype) / 1e12:.0f} TF/s {name}, "
             f"{bench.peaks.bytes_per_s / 1e9:.0f} GB/s HBM" if bench.on_card else "no peaks (host)")
    print(f"MFU accounting (B={batch}, frames={L}, nfe={nfe}, {name}; {peaks})", flush=True)
    rows = [bench.row("mfu", st) for st in stages]
    total_ms = sum(r["ms"] for r in rows)
    flops = sum(r["gflop"] for r in rows) * 1e9
    audio_s = batch * L * codec.hop / codec.sr
    total = {"compute_ms": total_ms, "audio_s": audio_s, "rtf_compute_floor": total_ms / 1e3 / audio_s,
             "gflop": flops / 1e9, "gb": sum(r["gb"] for r in rows), "mfu_whole_call": None}
    if bench.on_card:
        total["mfu_whole_call"] = 100 * flops / (total_ms * 1e-3) / bench.peaks.flop_per_s(bench.dtype)
        if total["mfu_whole_call"] > 100:
            raise RuntimeError(f"the whole call at {total['mfu_whole_call']:.1f} % of the FLOP peak")
    share = f", {total['mfu_whole_call']:.2f} % of the {name} peak" if bench.on_card else ""
    print(f"  total compute {total_ms:.1f} ms / {audio_s:.1f} s audio = RTF "
          f"{total['rtf_compute_floor']:.4f} compute floor; {total['gflop']:.1f} GFLOP{share}", flush=True)
    return total


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the sections and prints the rows and the JSON line.  Returns
    {"rows", "total" (mfu, or None), "report" (the JSON line), "codec",
    "model"}."""
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.bench_components",
                                     description="Per-stage device time and work of the port.")
    parser.add_argument("--which", default="codec,pieces,prior,convforms")
    parser.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    parser.add_argument("--batch", type=int, default=1, help="Batch size for --which mfu.")
    parser.add_argument("--nfe", type=int, default=64, help="Euler steps for --which mfu.")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    which = args.which.split(",")
    unknown = set(which) - set(SECTIONS)
    if unknown:
        parser.error(f"unknown --which {sorted(unknown)}; choose from {','.join(SECTIONS)}")
    device, dtype = resolve_device(args.device), DTYPES[args.dtype]
    switches = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _run(which, dtype, args, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = switches


def _run(which: List[str], dtype: torch.dtype, args, device: torch.device) -> Dict:
    bench = Bench(device, dtype)
    head = {"device": device.type, "dtype": args.dtype, "batch": args.batch, "nfe": args.nfe,
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                     "cudnn": torch.backends.cudnn.allow_tf32}}
    if bench.on_card:
        head.update(card=nvidia_smi_line(), graph_floor_ms=graph_floor_ms(),
                    peaks={"flop_per_s": bench.peaks.flop_per_s(dtype),
                           "bytes_per_s": bench.peaks.bytes_per_s})
        print(f"[bench_components] {head['card']} | torch {torch.__version__} | {args.dtype}, TF32 "
              f"matmul off, cuDNN off | a captured call of one trivial kernel: "
              f"{head['graph_floor_ms']:.5f} ms (the floor of a graph row)", flush=True)
    else:
        print(f"[bench_components] the CPU ({args.dtype}): host times, no device metric", flush=True)
    print("[bench_components] FLOPs: matmul/conv/attention (FlopCounterMode) + the hand kernels' "
          "analytic count; bytes: each aten op's inputs and outputs unfused + the hand kernels' least "
          "bytes (an upper bound, not a fused program's bytes accessed)", flush=True)
    cfg = load_default_config()
    codec = make_codec(cfg, dtype, device)
    model = make_model(cfg, dtype, device) if {"prior", "mfu"} & set(which) else None
    total = None
    for section in SECTIONS:
        if section not in which:
            continue
        if section == "codec":
            bench_codec(bench, codec)
        elif section == "pieces":
            bench_codec_pieces(bench, codec)
        elif section == "prior":
            bench_prior(bench, model)
        elif section == "convforms":
            bench_convforms(bench, codec)
        else:
            total = bench_mfu(bench, model, codec, args.batch, args.nfe)
    report = {**head, "rows": bench.rows, "total": total}
    print(json.dumps(report), flush=True)
    return {"rows": bench.rows, "total": total, "report": report, "codec": codec, "model": model}


if __name__ == "__main__":
    main()
