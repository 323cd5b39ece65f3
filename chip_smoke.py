"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. build the CUDA kernels from flamed_tts_tpu_torch/csrc (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at edge shapes;
  3. drive the main path, Flamed.sample at full width (random prior/prob
     weights from seed 0, the trained codec in artifacts/codec_r5, a 3 s
     prompt, 64 + 64 Euler steps), with every kernel's launch count set to
     0 just before and read just after; time five warm calls;
  4. break a warm call down by stage and by device kernel (torch.profiler);
     check the output: a finite wav of tgt_len * 200 samples, and a short
     utterance on the card against the same on the CPU (plain versions);
  5. at each main-path shape, hold the kernel against its plain version
     again and time both beside the kernel's bound: the kernel's device
     time from a CUDA graph replay, and per-call time from CUDA events
     around back-to-back calls, which includes the host's launch cost; print the kernels line, the card's name and
     power limit, and last the device line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
TOL = 1e-4  # fp32 both sides; sinf and the order of the FIR/conv sums differ
SNAKE_FLOP_PER_ELEM = 58  # 12 upsample FMAs + 2 snakes (mul, sin, sq, fma) + 12 decimation FMAs, x2 per FMA
ROOT = os.path.dirname(os.path.abspath(__file__))
CODEC_DIR = os.path.join(ROOT, "artifacts", "codec_r5")
PHONEMES = [int(v) for v in np.random.RandomState(11).randint(64, 148, 60)]
SOURCES = {"snake_filtered": "flamed_tts_tpu_torch/csrc/snake_filtered.cu",
           "residual_unit": "flamed_tts_tpu_torch/csrc/residual_unit.cu"}
REPLACES = {"snake_filtered": "flamed_tts_tpu/ops/pallas_resample.py:159",
            "residual_unit": "flamed_tts_tpu/ops/pallas_resunit.py:455"}


def log(*a):
    print(*a, flush=True)


def prompt_wav(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    wav = sum(np.sin(k * phase) / k for k in range(1, 6)) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
    return (0.2 * wav + 0.01 * rng.randn(t.size)).astype(np.float32)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time per call with the host's launch cost taken out: ``reps``
    calls captured in one CUDA graph, one replay timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(name: str, t: int, c: int) -> tuple:
    """Least time for one call at (1, t, c): bytes over HBM rate, operations
    over the fp32 rate; returns (ms, 'bytes' | 'operations')."""
    n = t * c
    if name == "snake_filtered":
        nbytes, flops = 8 * n + 8 * c, SNAKE_FLOP_PER_ELEM * n
    else:
        nbytes = 8 * n + 4 * (8 * c * c + 6 * c)
        flops = 16 * t * c * c + 2 * SNAKE_FLOP_PER_ELEM * n + 2 * n
    tb, to = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return (1e3 * max(tb, to), "bytes" if tb >= to else "operations")


def main_path_calls(codec, n_samples: int, f_bucket: int) -> list:
    """(kernel, T, C, dilation or 0, params) of every kernel call in one
    Flamed.sample: the encoder over the padded prompt, the decoder over the
    frame bucket."""
    calls = []
    t = n_samples
    for blk, stride in zip(codec.enc_params["blocks"], codec.up_ratios_enc):
        c = blk["act"]["alpha"].numel()
        calls += [("residual_unit", t, c, d, u) for u, d in zip(blk["res"], (1, 3, 9))]
        calls.append(("snake_filtered", t, c, 0, blk["act"]))
        t //= stride
    calls.append(("snake_filtered", t, codec.enc_params["final_act"]["alpha"].numel(), 0,
                  codec.enc_params["final_act"]))
    t = f_bucket
    for blk, stride in zip(codec.dec_params["blocks"], codec.up_ratios_dec):
        calls.append(("snake_filtered", t, blk["act"]["alpha"].numel(), 0, blk["act"]))
        t *= stride
        c = blk["up"]["w"].shape[1]
        calls += [("residual_unit", t, c, d, u) for u, d in zip(blk["res"], (1, 3, 9))]
    calls.append(("snake_filtered", t, codec.dec_params["final_act"]["alpha"].numel(), 0,
                  codec.dec_params["final_act"]))
    return calls


def breakdown(model, codec, wav_in) -> None:
    """Where a warm call's time goes: the three stages timed apart on the
    host clock (each ends in a synchronize), and the device's busy share
    and top kernels from torch.profiler over one whole call."""
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0)

    (codes, timbre), enc_ms = timed(lambda: codec.encode_prompt(wav_in))
    ids = np.asarray(PHONEMES)[None]
    gen = torch.Generator(device="cuda").manual_seed(0)
    res, sample_ms = timed(lambda: model.sampler.sample(
        ids, np.array([ids.shape[1]]), codes[None].astype(np.int64), np.array([codes.shape[-1]]),
        timbre[None], model.device, vocab_pad=model.vocab_size, generator=gen))
    _, dec_ms = timed(lambda: codec.decode(res["latents"], torch.as_tensor(timbre[None], device="cuda")))
    log(f"[breakdown] encode_prompt {enc_ms:.1f} ms; prior + denoiser (64 + 64 Euler steps) "
        f"{sample_ms:.1f} ms; codec decode {dec_ms:.1f} ms ({res['frame_bucket']} frames)")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(lambda: model.sample(phonemes=PHONEMES, prompt_raw=wav_in, codec=codec, seed=0))
    # device-side events only (the CPU ops that launch them carry the same time)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    n_launch = sum(e.count for e in events)
    log(f"[breakdown] profiled call {wall:.1f} ms: device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f} %), {n_launch} device kernels/copies")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[breakdown]   {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flamed_tts_tpu_torch import kernels
    from flamed_tts_tpu_torch.config import load_default_config
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
    from flamed_tts_tpu_torch.models.flamed import Flamed
    from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference
    from flamed_tts_tpu_torch.ops.resunit import pick_tile, residual_unit_cuda, residual_unit_reference
    from flamed_tts_tpu_torch.ops.snake import snake_filtered_cuda

    dev = torch.device("cuda")
    log("device:", torch.cuda.get_device_name(0), "| torch", torch.__version__, "| cuda", torch.version.cuda)

    # 1. build
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall; per kernel (s): "
        + json.dumps({k: round(v, 1) for k, v in built.items()}))
    for name, text in kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")

    codec = FaCodec.from_pretrained(CODEC_DIR, device=dev)
    rng = np.random.RandomState(0)

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    def snake_args(c):
        for blk in codec.enc_params["blocks"] + codec.dec_params["blocks"]:
            if blk["act"]["alpha"].numel() == c:
                return blk["act"]
        return {"alpha": rand(c) * 0.3, "beta": rand(c) * 0.3}

    def unit_args(c, d):
        for blk in codec.enc_params["blocks"] + codec.dec_params["blocks"]:
            if blk["res"][0]["act1"]["alpha"].numel() == c:
                return blk["res"][(1, 3, 9).index(d)]
        raise KeyError(c)

    # 2. kernels against their plain versions
    max_err = {"snake_filtered": 0.0, "residual_unit": 0.0}

    def compare(name, out, ref, label):
        diff = (out - ref).abs()
        err = float(diff.max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        ok = bool(torch.all(diff <= TOL + TOL * ref.abs()))
        max_err[name] = max(max_err[name], err)
        log(f"[check] {name} {label}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
            f"{'ok' if ok else 'FAIL'} (tol {TOL} abs + {TOL} rel)")
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")

    for t, c in [(80000, 64), (2000, 512), (48000, 32), (1, 64), (2, 64), (5, 64), (20, 64)]:
        x, a = rand(1, t, c), snake_args(c)
        compare("snake_filtered", snake_filtered_cuda(x, a["alpha"], a["beta"]),
                snake_filtered_reference(x, a["alpha"], a["beta"]), f"(1, {t}, {c})")
    for t, c in [(48000, 32), (2000, 512), (80000, 64), (30, 64)]:
        for d in (1, 3, 9):
            x, p = rand(1, t, c), unit_args(c, d)
            compare("residual_unit", residual_unit_cuda(x, p, d), residual_unit_reference(x, p, d),
                    f"(1, {t}, {c}) d={d} tile={pick_tile(min(t, 128), c, d)}")
    torch.cuda.synchronize()

    # 3. the main path
    cfg = load_default_config()
    model = Flamed(cfg, device=dev)  # random weights from torch.Generator().manual_seed(0)
    log(f"[main] Flamed: {model.num_params() / 1e6:.1f} M params (prior + prob), codec_r5 codec")
    wav_in = prompt_wav(3.0, seed=1)
    kernels.reset_launches()
    out = model.sample(phonemes=PHONEMES, prompt_raw=wav_in, codec=codec,
                       nsteps_durgen=64, nsteps_denoiser=64, seed=0)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    tgt_len, f_bucket = int(out["tgt_len"][0]), int(out["frame_bucket"])
    wav = out["wav"]
    log(f"[main] phonemes {len(PHONEMES)}, prompt {len(wav_in)} samples; tgt_len {tgt_len} "
        f"frames, frame bucket {f_bucket}; wav {wav.shape[0]} samples, rms {np.sqrt(np.mean(wav ** 2)):.4f}, "
        f"finite {bool(np.isfinite(wav).all())}")
    log(f"[main] kernel launches in the main-path call: {json.dumps(launches)}")
    padded_len = len(codec.pad_prompt_wav(wav_in)[0])
    calls = main_path_calls(codec, padded_len, f_bucket)
    expected = {k: sum(1 for c in calls if c[0] == k) for k in launches}
    for name in launches:
        if launches[name] == 0 or launches[name] != expected[name]:
            raise AssertionError(f"{name}: {launches[name]} launches in the main path, "
                                 f"expected {expected[name]}")
    if wav.shape != (tgt_len * codec.hop,) or not np.isfinite(wav).all() or tgt_len <= 0:
        raise AssertionError("main path output is not a finite wav of tgt_len * hop samples")

    # warm calls: the host clock varies from call to call on a shared host,
    # so take five and report each and their median
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        out2 = model.sample(phonemes=PHONEMES, prompt_raw=wav_in, codec=codec,
                            nsteps_durgen=64, nsteps_denoiser=64, seed=0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - w0)
        if not np.array_equal(out2["tgt_len"], out["tgt_len"]):
            raise AssertionError("a warm call sampled another length from the same seed")
    wall = float(np.median(walls))
    audio_s = tgt_len * codec.hop / 16000
    log(f"[main] warm calls: wall {', '.join(f'{1e3 * w:.1f}' for w in walls)} ms (host clock, each "
        f"ends in synchronize); median {wall * 1e3:.1f} ms; audio {audio_s:.2f} s; median RTF "
        f"{wall / audio_s:.4f}; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    breakdown(model, codec, wav_in)

    # 4. a short utterance on the card against the same on the CPU
    cpu_model = Flamed(cfg, params={"prior": model.prior.state_dict(),
                                    "prob": model.prob.state_dict()}, device="cpu")
    cpu_codec = FaCodec.from_pretrained(CODEC_DIR, device="cpu")
    nrng = np.random.RandomState(5)
    short = dict(phonemes=PHONEMES[:10], prompt_raw=prompt_wav(1.0, seed=2),
                 nsteps_durgen=4, nsteps_denoiser=4)
    noise = {"dur": nrng.randn(1, 64).astype(np.float32), "sil": nrng.randn(1, 64).astype(np.float32)}
    probe = model.sample(codec=codec, noise=noise, seed=0, **short)
    noise["latents"] = nrng.randn(1, probe["frame_bucket"], 256).astype(np.float32)
    g = model.sample(codec=codec, noise=noise, **short)
    c = cpu_model.sample(codec=cpu_codec, noise=noise, **short)
    err = float(np.abs(g["wav"] - c["wav"]).max()) if g["wav"].shape == c["wav"].shape else math.inf
    log(f"[reference] short utterance card vs CPU: tgt_len {g['tgt_len'][0]} vs {c['tgt_len'][0]}, "
        f"wav max abs diff {err:.3e} (tol 1e-5: fp32, cuBLAS/cuDNN and the kernels vs CPU "
        f"summation order and sinf)")
    if not np.array_equal(g["tgt_len"], c["tgt_len"]) or not err <= 1e-5:
        raise AssertionError("the card's short utterance disagrees with the CPU run")
    del cpu_model, cpu_codec

    # 5. each main-path shape: the kernel against its plain version, then
    # both timed
    per = {k: {} for k in launches}
    for name, t, ch, d, p in calls:
        key = (t, ch, d)
        if key in per[name]:
            per[name][key]["calls"] += 1
            continue
        x = rand(1, t, ch)
        if name == "snake_filtered":
            run = lambda: snake_filtered_cuda(x, p["alpha"], p["beta"])
            plain = lambda: snake_filtered_reference(x, p["alpha"], p["beta"])
        else:
            run = lambda: residual_unit_cuda(x, p, d)
            plain = lambda: residual_unit_reference(x, p, d)
        compare(name, run(), plain(), f"main-path shape (1, {t}, {ch}) d={d}")
        reps = max(3, min(50, int(2e8 // (t * ch * (1 + ch // 64)))))
        k_ms, k_wall, p_ms = graph_ms(run, reps), time_ms(run, reps), time_ms(plain, reps)
        b_ms, b_by = bound_ms(name, t, ch)
        per[name][key] = {"T": t, "C": ch, "d": d, "calls": 1, "ms": round(k_ms, 4),
                          "wall_ms": round(k_wall, 4), "plain_ms": round(p_ms, 4),
                          "bound_ms": round(b_ms, 5), "bound_by": b_by}
        log(f"[time] {name} (1, {t}, {ch}) d={d}: kernel {k_ms:.4f} ms (graph) / {k_wall:.4f} ms "
            f"(per call), plain {p_ms:.4f} ms (per call), bound {b_ms:.5f} ms ({b_by})")
    entries = []
    for name, shapes in per.items():
        rows = list(shapes.values())
        tot = {k: sum(r[k] * r["calls"] for r in rows)
               for k in ("ms", "wall_ms", "plain_ms", "bound_ms")}
        by_ops = sum(r["bound_ms"] * r["calls"] for r in rows if r["bound_by"] == "operations")
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": round(tot["ms"], 4), "plain_ms": round(tot["plain_ms"], 4),
            "bound_ms": round(tot["bound_ms"], 5),
            "wall_ms": round(tot["wall_ms"], 4),
            "bound_by": "operations" if by_ops * 2 >= tot["bound_ms"] else "bytes",
            "library_ms": None,
            "note": "sums over one utterance's launches at the shapes below; ms is the "
                    "wrapper's device time (CUDA graph replay), wall_ms and plain_ms per-call "
                    "CUDA-event time including the host's launch cost",
            "shapes": rows,
        })
    log(json.dumps({"kernels": entries}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
