"""Headline benchmark of the port: single-utterance RTF at nsteps-denoiser 64.

    python -m flamed_tts_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line on stdout, with the keys of the repository's root
``bench.py``:

  {"metric": "rtf_single_utt_nfe64", "value": R, "unit": "rtf",
   "vs_baseline": 0.05 / R, "precision": ..., "contended": ...,
   "load1": ..., "probe_ms": ..., "dropped_runs": ...}

R = warm wall time / generated audio seconds of ``Flamed.sample`` over the
whole pipeline (text -> frontend -> prompt analysis, prior, denoiser and
codec decode in the fused call -> host wav).  The weights are random
(``torch.Generator`` seeded 0) at the full width of ``configs/*.yaml``, with
the duration and silence heads pinned (``pin_durations``) so that an
utterance gets the 6-7 frames a phoneme of a trained model.  ``BENCH_PRECISION``
is ``bf16`` (the default: the model's and the codec's parameters stored in
bfloat16, at the ``"default"`` matmul precision of ``precision.py``) or
``fp32`` (float32 parameters at ``"highest"``, as the root bench sets it).
With no card the run prints an ``"error": "gpu_unavailable"`` line and exits
2; ``--device cpu`` runs the plain PyTorch path on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from flamed_tts_tpu_torch.config import load_default_config
from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.precision import set_matmul_precision

METRIC = "rtf_single_utt_nfe64"
NSTEPS_DURGEN = 64
NSTEPS_DENOISER = 64
TEMPERATURE = 0.3
# RTF < 0.05 a single utterance at nsteps-denoiser 64 is the repository's
# target (BASELINE.json); vs_baseline > 1 means it is beaten.  Kept for the
# schema of the root bench.py's line.
TARGET_RTF = 0.05
TEXT = (
    "The quick brown fox jumps over the lazy dog while the curious cat "
    "watches from a sunny window sill in the early morning light."
)
# The pin: the duration flow's output layer gives the constant velocity
# log 7, so a duration is round(7 * exp(0.3 * n) - 1) for a standard normal
# n, at least 1 (mean 6.33, sd 2.27); silences are 0 (a silence needs
# n > 4.7).  Over the ~85 phonemes of TEXT the mean is 6.33 +- 0.25, so
# FRAMES_PER_PHONEME holds a call's frames a phoneme with room of 5 sd.
DURATION_BIAS = math.log(7.0)
SILENCE_BIAS = -1.0
FRAMES_PER_PHONEME = (5.0, 8.0)
WARM_SEEDS = range(3)
TIMED_SEEDS = range(1, 6)
DROP_FACTOR = 1.3  # a timed call above this times the fastest is dropped
# Contention guards: the host's load average, and the median of five
# trivial device round trips (an add and a host read).  DISPATCH_LIMIT_MS is
# about ten times the floor that probe read on an idle host with the card
# PERF.md names (its value and the card are written there); a busy host
# stretches the round trip past it.
LOAD_LIMIT = 1.5
DISPATCH_LIMIT_MS = 0.3


def emit_unavailable(metric: str, detail: str) -> None:
    """The root bench's error line for a missing accelerator; exit 2."""
    print(json.dumps({"metric": metric, "value": None, "unit": "rtf", "vs_baseline": None,
                      "error": "gpu_unavailable", "detail": detail[:200]}))
    sys.exit(2)


def probe_gpu(metric: str = METRIC) -> None:
    """Fail fast, with one machine-readable line, if CUDA is unavailable
    or a trivial device round trip does not come back right."""
    if not torch.cuda.is_available():
        emit_unavailable(metric, "torch.cuda.is_available() is false")
    try:
        val = float(torch.ones(4, device="cuda").sum().item())
    except RuntimeError as exc:
        emit_unavailable(metric, f"device round trip failed: {exc}")
    if val != 4.0:
        emit_unavailable(metric, f"device round trip returned {val}, expected 4.0")
    print(f"[bench] backend up: cuda ({torch.cuda.get_device_name(0)})", file=sys.stderr)


def pin_durations(model: Flamed) -> None:
    """Zero the duration and silence flows' output weights and set their
    biases (``DURATION_BIAS``, ``SILENCE_BIAS``), as the root bench does."""
    with torch.no_grad():
        for name, bias in (("duration_generator", DURATION_BIAS), ("sil_generator", SILENCE_BIAS)):
            layer = getattr(model.prior, name).linear_layer
            layer.weight.zero_()
            layer.bias.fill_(bias)


def build(cfg: Dict, precision: str, device, cast_codec: bool = True):
    """(model, codec): random prior/prob and codec weights from generators
    seeded 0, the durations pinned, and with ``precision`` bf16 the model's
    (and with ``cast_codec`` the codec's) parameters stored in bfloat16.
    The pin comes before the rounding, so the pinned values are rounded as
    the root bench's (which pins bfloat16 leaves) are."""
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"precision must be bf16 or fp32, got {precision!r}")
    model = Flamed(cfg, device=device, generator=torch.Generator().manual_seed(0))
    codec = FaCodec.random_init(torch.Generator().manual_seed(0), device=device,
                                codec_cfg=cfg["codec_cfg"])
    pin_durations(model)
    if precision == "bf16":
        model.cast_inference_params()
        if cast_codec:
            codec.cast_inference_params()
    return model, codec


def prompt_wav() -> np.ndarray:
    """3 s of a 220 Hz sine at 0.1 amplitude, 16 kHz."""
    t_axis = np.arange(3 * 16000) / 16000.0
    return (0.1 * np.sin(2 * np.pi * 220 * t_axis)).astype(np.float32)


def make_run(model: Flamed, codec: FaCodec, prompt: np.ndarray,
             nsteps_durgen: int = NSTEPS_DURGEN,
             nsteps_denoiser: int = NSTEPS_DENOISER) -> Callable[[int], Dict]:
    """``run(seed)``: one pinned ``Flamed.sample`` of TEXT (the tests give
    fewer Euler steps)."""
    def run(seed: int) -> Dict:
        return model.sample(text=TEXT, prompt_raw=prompt, codec=codec,
                            nsteps_durgen=nsteps_durgen, nsteps_denoiser=nsteps_denoiser,
                            temp_durgen=TEMPERATURE, temp_denoiser=TEMPERATURE, seed=seed)
    return run


def warm(run: Callable[[int], Dict], seeds: Sequence[int] = WARM_SEEDS) -> None:
    """The first call seeds the sampler's frames-a-phoneme history, which
    can move the speculative frame bucket of the second; three calls let
    the bucket settle before anything is timed."""
    for seed in seeds:
        run(seed)


def dispatch_floor_ms(device: torch.device) -> float:
    """Median of five trivial device round trips (an add, a host read)."""
    x = torch.ones((), device=device)
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        float((x + 1).item())
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def contention(device: torch.device) -> Dict:
    load1 = os.getloadavg()[0]
    floor_ms = dispatch_floor_ms(device)
    return {"load1": load1, "probe_ms": floor_ms,
            "contended": load1 > LOAD_LIMIT or floor_ms > DISPATCH_LIMIT_MS}


def measure(run: Callable[[int], Dict], seeds: Sequence[int] = TIMED_SEEDS) -> List[Dict]:
    """One timed call a seed: host-clock seconds, audio seconds, tgt_len
    and frame bucket.  The call ends in a host read of the wav (and the
    sampler's synchronize), so the clock stops after the device's work."""
    calls = []
    for seed in seeds:
        t0 = time.perf_counter()
        out = run(seed)
        seconds = time.perf_counter() - t0
        calls.append({"seed": seed, "seconds": seconds, "audio_s": len(out["wav"]) / 16000.0,
                      "tgt_len": int(out["tgt_len"][0]), "frame_bucket": int(out["frame_bucket"])})
    return calls


def aggregate(times: Sequence[float], seconds: Sequence[float]) -> Dict:
    """Drop calls above ``DROP_FACTOR`` times the fastest, keeping each
    call's time paired with its own audio seconds (each seed samples other
    durations); RTF = kept time / kept audio seconds."""
    t_min = min(times)
    kept = [(t, s) for t, s in zip(times, seconds) if t <= DROP_FACTOR * t_min]
    kept_t = sum(t for t, _ in kept)
    kept_s = sum(s for _, s in kept)
    return {"rtf": kept_t / kept_s, "dropped": len(times) - len(kept), "kept": len(kept),
            "kept_t": kept_t, "kept_s": kept_s, "t_min": t_min}


def report(rtf: float, precision: str, guard: Dict, dropped: int) -> Dict:
    """The JSON line, with the root bench's keys and rounding (``probe_ms``
    to 1 us here)."""
    return {
        "metric": METRIC,
        "value": round(rtf, 5),
        "unit": "rtf",
        "vs_baseline": round(TARGET_RTF / rtf, 3),
        "precision": precision,
        "contended": guard["contended"],
        "load1": round(guard["load1"], 2),
        "probe_ms": round(guard["probe_ms"], 3),  # a card's round trip is tens of us
        "dropped_runs": dropped,
    }


def frames_per_phoneme(model: Flamed, calls: Sequence[Dict]) -> List[float]:
    n_phonemes = model._get_frontend()(TEXT)[0].shape[1]
    return [c["tgt_len"] / n_phonemes for c in calls]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Runs the benchmark and prints its line.  Returns {"report", "calls",
    "run", "model", "codec"} for a caller that inspects the run."""
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.bench",
                                     description="Single-utterance RTF at nfe 64 (port).")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.device == "cuda":
        probe_gpu()
    device = resolve_device(args.device)
    precision = os.environ.get("BENCH_PRECISION", "bf16")
    if precision == "fp32":
        set_matmul_precision("highest")

    model, codec = build(load_default_config(), precision, device)
    run = make_run(model, codec, prompt_wav())
    warm(run)
    guard = contention(device)
    if guard["contended"]:
        print(f"[bench] WARNING: host looks busy (load1={guard['load1']:.2f}, dispatch probe "
              f"{guard['probe_ms']:.2f} ms vs a {DISPATCH_LIMIT_MS} ms limit); timings will be "
              "inflated: rerun on an idle host", file=sys.stderr)
    calls = measure(run)
    times = [c["seconds"] for c in calls]
    agg = aggregate(times, [c["audio_s"] for c in calls])
    if agg["dropped"]:
        print(f"[bench] dropped {agg['dropped']}/{len(times)} outlier runs (min "
              f"{agg['t_min']:.3f}s, all: {[round(t, 3) for t in times]})", file=sys.stderr)
    print(f"[bench] timed calls (s): {[round(t, 4) for t in times]}", file=sys.stderr)
    print(f"[bench] audio={agg['kept_s'] / agg['kept']:.2f}s per-run={agg['kept_t'] / agg['kept']:.3f}s "
          f"(precision={precision}, load1={guard['load1']:.2f}, probe={guard['probe_ms']:.2f}ms)",
          file=sys.stderr)
    line = report(agg["rtf"], precision, guard, agg["dropped"])
    print(json.dumps(line), flush=True)
    return {"report": line, "calls": calls, "run": run, "model": model, "codec": codec}


if __name__ == "__main__":
    main()
