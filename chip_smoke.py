"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. build the CUDA kernels from flamed_tts_tpu_torch/csrc (nvcc, sm_90a)
     and check in their SASS (cuobjdump) that every residual kernel, fp32 and
     bf16, holds tensor-core instructions (HMMA / HGMMA);
  2. hold each kernel against its plain PyTorch version on the card, in
     fp32 and bf16, at the main paths' shapes and at edge shapes (for K2 and
     K3 also lengths that leave the last 16-row mma tile ragged); hold the
     fused stack (K3) bit for bit against three single-unit (K2) launches;
     print the fp32 K2's error against a float64 plain version beside the
     fp32 plain version's own, at one main-path shape per width; hold K2 at
     the FaCodec redecoder's shapes at its reference width for a 3 s source
     ((1200, 640), (6000, 320), (24000, 160), (48000, 80); d = 1, 3, 9; fp32
     and bf16), with the same bits from another tile;
  3. drive the two main paths at full width (random prior/prob weights from
     seed 0, the trained codec in artifacts/codec_r5, a 3 s prompt, 64 + 64
     Euler steps), each with every kernel's launch count set to 0 just
     before and read just after, and time five warm calls of each:
       A. phonemes -> staged path, fp32 at the "highest" matmul precision
          (flamed_tts_tpu_torch/precision.py), one K2 launch a residual unit;
       B. text -> frontend -> fused prompt path, bf16 parameters at
          "default" (bf16 operands in the prior's and the denoiser's
          matmuls), fuse_blocks=True (K3 where stack_tile admits the block);
     then path B's utterance at "default" against the same at "highest",
     the same noise: the durations that differ, and on the "highest"
     durations the latents' relative error and the decoded wavs' mel-L2
     (LATENT_REL_TOL, MEL_L2_TOL); no GEMM kernel off the tensor cores in
     its prior and denoiser stages (profiled); the prior's and prob's
     parameter bytes;
  4. break a warm call of each path down by stage and by device kernel
     (torch.profiler); check the outputs: a finite wav of tgt_len * 200
     samples, a short utterance on the card against the same on the CPU
     (plain versions) for each path (A at "highest"; B at "default" against
     the CPU forced to the same arithmetic), with the count of the prompt's
     RVQ codes that differ between the two, and one forced overflow retry on B;
  5. at each main-path shape, hold the kernel against its plain version
     again and time both beside the kernel's bound: the kernel's device
     time from a CUDA graph replay, and per-call time from CUDA events
     around back-to-back calls, which includes the host's launch cost; K3
     also beside three K2 launches at its shape, and K2 and K3 beside what
     their scalar-FMA predecessors read;
  6. the training path: fabricate 32 utterances of 3-16 s (wav + "phones"
     TextGrid, one of 15.6 s for the 17 s bucket); precompute them on the
     card (codec_r5, fp32: K1 and K2 at up to (272000, 32)), with launch
     counts asserted; the 15.6 s utterance analysed again with its launches
     counted and its codes held equal to the CPU's; K1 / K2 held against
     their plain versions at (272000, 32) and (136000, 64); 30 steps of
     ``python -m flamed_tts_tpu_torch.train`` at the full width of
     configs/*.yaml, batch 16, with validation audio (K1, K2; launches held
     to the decodes it reports); the loss on one fixed batch falling over
     20 steps at lr 1e-3, and a warm step of it broken down (forward,
     backward, AdamW; FLOPs; profiler); one deterministic step on the card
     at "highest" against the same on the CPU, and at "default" (the
     trainer's): each of its matmul and conv calls replayed on its inputs
     and incoming gradient against the CPU forced to the card's arithmetic
     (LAYER_REL; a control with results rounded to bf16 must fail it), and
     its gradients' departure from the CPU's float32 step against the
     emulation's (STEP_NOISE_RATIO); resume for 2 steps from train_state.pt
     and serve an utterance from last.npz; then K1 and K2 held against
     their plain versions and timed as in phase 5 at the shapes of one 17 s
     utterance's analysis and of the validation audio's decodes.  The
     precompute and the trainer run under PyTorch's own TF32 switches
     (cuDNN convolutions in TF32 by default), every comparison and every
     other phase with TF32 off;
  7. the serving path's measurement and ingestion entry points at the full
     width of configs/*.yaml, under PyTorch's own TF32 switches as a user
     runs them: ``python -m flamed_tts_tpu_torch.bench`` (bf16, the pinned
     durations: its JSON line, each timed call's tgt_len, frame bucket and
     audio seconds, frames a phoneme held to bench.FRAMES_PER_PHONEME, the
     five times, the dispatch-floor probe and load1; the kernel launches of
     one timed call, held to those of its shapes; a profiled call's device
     kernels and its GEMM kernels off the tensor cores; the bench's utterance at
     "default" against "highest", as path B's in phase 3), ``bench_throughput``
     (batch 4, nfe 128), ``profile_sample`` (its span line; the fused
     call's dispatch and host read must be most of the wall), ``synthesize
     --profile-dir`` (the trace must hold CUDA kernel events, the hand
     kernels among them), the bench's weights as a reference-format .ckpt
     through Flamed.from_pretrained held bit for bit against the .npz
     route (state and wav); then K1 and K2 held against their plain
     versions and timed as in phase 5 at the bench call's shapes (bf16, a
     random codec);
  8. codec training and voice conversion: K2 at d = 2 and K1 at
     cnn_predictor's width (C = 256), fp32 and bf16, against their plain
     versions; under grad, each kernel's autograd Function (K1, K2 at every
     shape of a codec-trainer step, K3 at the encoder's fp32 shapes) against
     autograd through the plain chain, TF32 off: the forward, and the
     gradients of the input and every parameter; ``python -m
     flamed_tts_tpu_torch.train_codec`` at the JAX tool's defaults (batch 8,
     160-frame crops, the default widths) on a fabricated corpus of four
     speakers, under PyTorch's own TF32 switches: median step ms, steps/s,
     peak memory, the mel L1 falling, one step's forward launches held to
     its shapes, the kernels on the trained weights against their plain
     versions, one dead-code revival; one deterministic step on the card
     against the same on the CPU; the saved codec through
     FaCodec.from_pretrained (its prompt codes on card and CPU); the
     training decode with all three GRL heads at the reference's head sizes
     (finite forward and backward, the GRL's sign); V2 voice conversion
     and the redecoder at its reference width (1280: K2 at C = 640 ... 80,
     launches held to its shapes) with random weights, a 3 s source and
     target each; then K1 and K2 timed as in phase 5 at the trainer's and
     the redecoder's shapes, with the backward of each Function beside
     autograd's through the plain chain.
  9. evaluation: fabricate 48 utterances of up to 8 s by 8 speakers
     (``fabricate_corpus``, phone-dependent formant audio); ``python -m
     flamed_tts_tpu_torch.dump_decoded`` on the card (codec_r5, fp32: K1 10
     and K2 24 a round trip, held), a short utterance's round trip against
     the CPU's (codes equal, the wav to phase 4's tolerance); ``train_asr``
     at the JAX tool's defaults (256 x 8, batch 16, lr 2e-3, 30 epochs) on
     the clean and decoded audio: median step ms, frames/s, peak memory,
     the loss falling, the valid frame accuracy beside the silence share,
     and one step on the card against the CPU's; the committed recognizer
     on the card against the CPU (logits, transcripts), its ms per audio
     second beside the host's Viterbi decode; ``evaluate`` (codec_r5, the
     committed recognizer; K1 10 and K2 24 an entry, held);
     ``eval_discrimination`` stage 1 (launches held; a crop's timbre and
     ASR embedding against the CPU's) and stage 2 with random full-width
     weights as .npz (finite rows); then K1 and K2 held against their plain
     versions and timed as in phase 5 at the longest utterance's round
     trip.  The tools run under PyTorch's own TF32 switches, the
     comparisons with TF32 off.
  10. data and tensor parallelism, the native WAV codec and the G2P tools:
     ``torchrun --standalone --nproc-per-node 1 -m flamed_tts_tpu_torch.train
     --devices 1,1`` (NCCL) for 3 steps on phase 6's corpus, its first step
     against the same step without a mesh; ``Flamed.sample_batch`` on a
     1 x 1 mesh, a batch of 3 with prompt wavs (K1 and K2 launches held to
     its shapes), against the same call without one; the native WAV codec
     (``utils/native_audio.py``, built with g++) against scipy on phase 6's
     files; ``train_g2p`` at the tool's widths and batch for G2P_EPOCHS of
     its 120 epochs (step ms, held-out PER) and two updates on the card
     against the CPU; ``expand_lexicon`` and ``lexicon_coverage`` against
     the CPU's outputs; then K1 and K2 timed as in phase 5 at the mesh
     call's shapes.
  11. the component benchmark, ``python -m flamed_tts_tpu_torch.bench_components``
     at full width: every section in bf16, the mfu table in fp32, and the
     mfu table at batch 4 and nfe 128 (bench_throughput's shape); every row
     finite, under both peaks, its counted hand-kernel calls equal to the
     launches its wrappers made, and the codec rows' K1 / K2 launches equal
     to their shapes; the convforms pairs within CONVFORM_BF16_STEPS; the
     codec decode's and the prompt encode's FLOPs and bytes equal to the
     same rows counted on the CPU; the compute-floor RTF at or under phase
     7's wall RTF of the same shape.
     Last: the kernels line (paths A, B, precompute, validation, bench,
     codec_train, redecoder, eval and mesh), the card's name and power
     limit, the device line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from flamed_tts_tpu_torch.ops import costs
from flamed_tts_tpu_torch.utils.profiling import events_ms, graph_ms, nvidia_smi_line

# fp32 both sides.  What differs: the order of the FIR and conv sums; the
# kernels' sin^2, which reduces its argument by the period pi and is within
# 4e-7 of the exact value where the plain version's sin is within 1.2e-7
# (tests/test_torch_tf32_layout.py), times 1 / beta; and the kernels' conv
# products, three TF32 products of split operands, each about 2^-20 of a
# product off where an fp32 FMA is exact (the [float64] lines show both
# sides' distance from a float64 result).
TOL = 1e-4
# bf16 io: kernel and plain version round at the same places, but their fp32
# sums differ in order, so a value near a rounding boundary may land one bf16
# step away and the step feeds the next stage.  An element may be off by
# BF16_STEPS steps of 2^-7 relative to max(|ref|, mean |ref|).  The same
# bound serves the tensor-core convs: an mma adds the same exact bf16 x bf16
# products in fp32 as the FMA loop did, in yet another order, which is the
# one freedom the bound was sized for.
BF16_STEPS = 8
ROOT = os.path.dirname(os.path.abspath(__file__))
CODEC_DIR = os.path.join(ROOT, "artifacts", "codec_r5")
PHONEMES = [int(v) for v in np.random.RandomState(11).randint(64, 148, 60)]
TEXT = "The quick brown fox jumps over the lazy dog, and 3 more follow it."
SOURCES = {"snake_filtered": "flamed_tts_tpu_torch/csrc/snake_filtered.cu",
           "residual_unit": "flamed_tts_tpu_torch/csrc/residual_unit.cu",
           "residual_stack": "flamed_tts_tpu_torch/csrc/residual_stack.cu"}
REPLACES = {"snake_filtered": "flamed_tts_tpu/ops/pallas_resample.py:159",
            "residual_unit": "flamed_tts_tpu/ops/pallas_resunit.py:455",
            "residual_stack": "flamed_tts_tpu/ops/pallas_resunit.py:496"}
DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
# Device ms (CUDA graph replay) of K2 and K3 while their convs were scalar
# fp32 FMA loops, as this script read them on an NVIDIA H100 80GB HBM3 at
# 700.00 W before the tensor-core convs replaced the loops (bf16: before
# mma.sync m16n8k16; fp32: before the split-TF32 m16n8k8 products, with the
# snakes already computing their samples in pairs): (dtype, kernel, T, C,
# dilation or 0) -> ms.  Printed on the [time] log line of the same shape and
# nowhere in the kernels line, which holds this run's measurements only.
FMA_LOOP_MS = {
    ("bf16", "residual_unit", 1200, 256, 1): 1.842, ("bf16", "residual_unit", 1200, 256, 3): 1.854,
    ("bf16", "residual_unit", 1200, 256, 9): 1.882, ("bf16", "residual_unit", 12800, 256, 1): 1.869,
    ("bf16", "residual_unit", 12800, 256, 3): 1.879, ("bf16", "residual_unit", 12800, 256, 9): 1.917,
    ("bf16", "residual_unit", 2560, 512, 1): 4.903, ("bf16", "residual_unit", 2560, 512, 3): 4.385,
    ("bf16", "residual_unit", 2560, 512, 9): 3.748,
    ("bf16", "residual_stack", 48000, 32, 0): 0.6359, ("bf16", "residual_stack", 24000, 64, 0): 0.9713,
    ("bf16", "residual_stack", 6000, 128, 0): 1.9490, ("bf16", "residual_stack", 51200, 128, 0): 5.7814,
    ("bf16", "residual_stack", 102400, 64, 0): 3.7543,
    ("fp32", "residual_unit", 48000, 32, 1): 0.1011, ("fp32", "residual_unit", 48000, 32, 3): 0.1033, ("fp32", "residual_unit", 48000, 32, 9): 0.1056,
    ("fp32", "residual_unit", 24000, 64, 1): 0.1739, ("fp32", "residual_unit", 24000, 64, 3): 0.1751, ("fp32", "residual_unit", 24000, 64, 9): 0.1804,
    ("fp32", "residual_unit", 6000, 128, 1): 0.3679, ("fp32", "residual_unit", 6000, 128, 3): 0.3680, ("fp32", "residual_unit", 6000, 128, 9): 0.3797,
    ("fp32", "residual_unit", 1200, 256, 1): 0.9033, ("fp32", "residual_unit", 1200, 256, 3): 0.7534, ("fp32", "residual_unit", 1200, 256, 9): 0.7373,
    ("fp32", "residual_unit", 1280, 512, 1): 1.4121, ("fp32", "residual_unit", 1280, 512, 3): 1.2680, ("fp32", "residual_unit", 1280, 512, 9): 0.8833,
    ("fp32", "residual_unit", 6400, 256, 1): 0.9198, ("fp32", "residual_unit", 6400, 256, 3): 0.7693, ("fp32", "residual_unit", 6400, 256, 9): 0.7476,
    ("fp32", "residual_unit", 25600, 128, 1): 0.7237, ("fp32", "residual_unit", 25600, 128, 3): 0.7233, ("fp32", "residual_unit", 25600, 128, 9): 0.7486,
    ("fp32", "residual_unit", 51200, 64, 1): 0.3296, ("fp32", "residual_unit", 51200, 64, 3): 0.3353, ("fp32", "residual_unit", 51200, 64, 9): 0.3499,
}
# lengths that end inside a 16-row mma tile: one row, one short of and one
# past a tile, the same around three tiles, and one no K2 or K3 tile divides
MMA_PADDING_T = (1, 15, 17, 47, 49, 333)
TRAIN_UTTERANCES = 32  # the training phase's synthetic corpus
TRAIN_STEPS = 30
# phase 8: the codec trainer at the JAX tool's defaults (batch 8, crops of
# 160 frames) on a corpus of a few speakers
CODEC_UTTERANCES, CODEC_SPEAKERS = 24, 4
CODEC_BATCH, CODEC_CROP, CODEC_STEPS = 8, 160, 40
CODEC_UP_ENC, CODEC_UP_DEC = (2, 4, 5, 5), (5, 5, 4, 2)
REDECODER_WIDTH = 1280  # the redecoder's reference default: blocks of 640, 320, 160 and 80 channels
# K2 at the redecoder's shapes for a 3 s source (240 frames, up 5x, 5x, 4x, 2x)
REDECODER_K2_SHAPES = [(1200, 640), (6000, 320), (24000, 160), (48000, 80)]
TRAIN_CODEC_WEIGHTS = {"mel": 1.0, "wav": 10.0, "commit": 1.0, "phone": 2.0, "spk": 1.0, "latreg": 1.0}
# phase 9: the evaluation tools on a fabricated corpus of eight voices, cut
# from the JAX tools' 300 utterances of up to 15 s by 24 speakers
EVAL_UTTERANCES, EVAL_SPEAKERS, EVAL_DUR_MAX = 48, 8, 8.0
EVAL_ENTRIES = 8  # lines of the evaluate run's metadata
# phase 10: train_g2p cut from the tool's 120 epochs; the lexicon tools'
# outputs as this repository's CPU run gives them (sha256 of the file
# expand_lexicon writes, and of the JSON line lexicon_coverage prints on its
# built-in sample)
G2P_EPOCHS = 3
EXPANDED_LEXICON_SHA256 = "84f1048cc5bc2bdeaee7d84b6a0adb7353ab8e1fa47a623629ab5097ebfdfecb"
COVERAGE_LINE_SHA256 = "ac822448436c2553a81842a419b810d4c0f6628fa2be69cffd88e83337a663dd"
# phase 11: the convforms pairs' largest difference, in bf16 steps (2^-7) of
# the library output's peak
CONVFORM_BF16_STEPS = 2
# a Function's gradients against autograd through the plain chain: both are
# the plain chain's VJP at the same input, so only cuDNN's choice of
# backward algorithm between two calls may part them
GRAD_TOL = 1e-5
GRAD_FUNCTIONS = {"snake_filtered": "SnakeFiltered", "residual_unit": "ResidualUnit",
                  "residual_stack": "ResidualStack"}
# bf16 serving at the "default" matmul precision against the same call at
# "highest" (flamed_tts_tpu_torch/precision.py), the same noise and the
# "highest" run's durations passed to both: the relative latent error and
# the decoded wavs' mel-L2 bounds of tests/test_bf16_quality.py
LATENT_REL_TOL, MEL_L2_TOL = 0.05, 2.0
# a GEMM or implicit-GEMM convolution off the tensor cores: cuBLAS's and
# cuDNN's float32 "ffma" / "f32f32_f32f32" kernels, CUTLASS's SIMT sgemm,
# cuDNN's "implicit_convolve_sgemm" (of any type).  None may run in the prior
# and denoiser stages at "default"
CUDA_CORE_GEMM = re.compile(r"ffma|simt|sgemm|f32f32_f32f32", re.IGNORECASE)
# the trainer's step at "default" on the card (bf16 operands), checked two
# ways.  Each matmul and conv of the prior and the prob, replayed on the
# inputs and the incoming gradient it had in that step, against the CPU
# with the card's arithmetic forced onto it (precision.bf16_on_cpu: the
# same code, the same roundings of the same values): the output and the
# input and weight gradients within LAYER_REL relative L2 of the CPU's
# (only the order of the float32 sums differs, ~1e-6 relative); the same
# replay with every product's result rounded to bf16, as torch.autocast
# rounds them (a half bf16 step, ~1.5e-3 relative L2), must exceed it at
# every layer.  The whole step against the CPU's float32 step: bf16
# operands depart from float32 by a noise that the card and the CPU's
# emulation share in distribution (over 1e8 gradient elements the two
# departures' sizes agree closely), so the card's gradients' relative L2
# departure is held to STEP_NOISE_RATIO times the emulation's: above, a
# product rounded or computed wrong; below, float32 kept where bf16 was
# asked for.  PERF.md section 6 has what the card read
LAYER_REL = 3e-5
STEP_NOISE_RATIO = (0.5, 2.0)
# PyTorch's own TF32 switches (matmul, cuDNN), read before main() turns TF32
# off for the comparisons: the precompute and the trainer are timed under
# these, as whoever starts them on their own runs them
DEFAULT_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def log(*a):
    print(*a, flush=True)


def prompt_wav(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000.0
    wav = sum(np.sin(k * phase) / k for k in range(1, 6)) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2)
    return (0.2 * wav + 0.01 * rng.randn(t.size)).astype(np.float32)


@contextlib.contextmanager
def tf32(matmul: bool, cudnn: bool):
    """PyTorch's TF32 switches set for the span, then put back."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def tf32_label() -> str:
    return (f"TF32 matmul {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}, cuDNN "
            f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}")


@contextlib.contextmanager
def results_in_bf16():
    """precision.py's products with their float32 results rounded to bf16,
    as torch.autocast gives them: the control that the "default" bounds
    must refuse."""
    from flamed_tts_tpu_torch import precision

    mm, bmm = precision._mm, precision._bmm
    precision._mm = lambda *a: mm(*a).to(torch.bfloat16).float()
    precision._bmm = lambda *a: bmm(*a).to(torch.bfloat16).float()
    try:
        yield
    finally:
        precision._mm, precision._bmm = mm, bmm


def capture_products(modules):
    """Hooks on every precision.Linear / Conv1d under ``modules`` (name ->
    module): each call's input, output and incoming gradient, appended to
    the returned list as [name, layer, x, y, g] (g once the backward has
    run), and the hooks' handles."""
    from flamed_tts_tpu_torch import precision

    calls, handles = [], []
    for part, root in modules.items():
        for name, layer in root.named_modules():
            if not isinstance(layer, (precision.Linear, precision.Conv1d)):
                continue

            def hook(layer, inputs, output, key=f"{part}.{name}"):
                rec = [key, layer, inputs[0].detach().float().clone(), output.detach().clone(), None]
                calls.append(rec)
                if output.requires_grad:
                    output.register_hook(lambda g: rec.__setitem__(4, g.detach().clone()))

            handles.append(layer.register_forward_hook(hook))
    return calls, handles


def replay_product(layer, weight, bias, x, g, device):
    """One product's forward and backward on ``device`` at the process's
    precision, from the given parameters, input and incoming gradient:
    [output, input gradient, weight gradient]."""
    from flamed_tts_tpu_torch import precision

    def leaf(t):
        return None if t is None else t.detach().to(device, copy=True).requires_grad_()

    x, w, b = leaf(x), leaf(weight), leaf(bias)
    if isinstance(layer, precision.Conv1d):
        y = precision.conv1d(x, w, b, layer.padding[0])
    else:
        y = precision.linear(x, w, b)
    y.backward(g.to(device))
    return [y.detach().cpu(), x.grad.cpu(), w.grad.cpu()]


def replay_products(calls, start, dev):
    """Each captured product call (``capture_products``) replayed from the
    ``start`` parameters on ``dev``, plainly and with its results rounded to
    bf16, and on the CPU with ``dev``'s arithmetic forced onto it.  Returns
    (the worst rel L2 of the output, input and weight gradients against the
    CPU's, and of the step's own output against the replay's, with that
    call's name; the control's least per call; the number of calls)."""
    from flamed_tts_tpu_torch.precision import bf16_on_cpu

    worst, least, n = (0.0, ""), float("inf"), 0
    for key, layer, x, y, g in calls:
        if g is None or not bool(g.any()):
            continue  # a product no gradient reached
        part, name = key.split(".", 1)
        args = (layer, start[part][f"{name}.weight"], start[part].get(f"{name}.bias"), x, g)
        card = replay_product(*args, dev)
        with results_in_bf16():
            ctl = replay_product(*args, dev)
        with bf16_on_cpu():
            cpu = replay_product(*args, torch.device("cpu"))
        errs = [rel_l2(y.cpu(), card[0])] + [rel_l2(a, c) for a, c in zip(card, cpu)]
        if max(errs) > worst[0]:
            worst = (max(errs), f"{key} {tuple(x.shape)}")
        least = min(least, max(rel_l2(a, c) for a, c in zip(ctl, cpu)))
        n += 1
    return worst, least, n


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def bound_ms(name: str, t: int, c: int, dtype: torch.dtype) -> tuple:
    """Least time for one call at (1, t, c) on this card, by
    ``ops/costs.py`` (``kernel_cost``: x read once, the output written once,
    the parameters read once; the operations at the peak rate of the io
    type, float32 outside the tensor cores, bfloat16 on them); returns (ms,
    'bytes' | 'operations')."""
    flops, nbytes = costs.kernel_cost(name, t, c, dtype)
    return costs.bound_ms(flops, nbytes, dtype, costs.device_peaks())


def tensor_core_counts(kernels) -> dict:
    """{kernel function in the built K2 / K3 libraries: HMMA + HGMMA
    instructions in its SASS}, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for name in ("residual_unit", "residual_stack"):
        res = subprocess.run([tool, "-sass", kernels.library_path(name)], capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"cuobjdump failed on {name}: {res.stderr}")
        fn = None
        for line in res.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn is not None and re.search(r"\bHG?MMA\b", line):
                counts[fn] += 1
    return counts


def encoder_calls(codec, n_samples: int) -> list:
    """(kernel, T, C, dilation or 0, params, prepared weights or None) of
    every kernel call of the codec's encoder over ``n_samples`` samples.  A
    block's three residual units are one residual_stack call where the codec
    fuses blocks and stack_tile admits the block."""
    calls = []
    t = n_samples
    for blk, prepared, stride in zip(codec.enc_params["blocks"], codec.enc_prepared, codec.up_ratios_enc):
        c = blk["act"]["alpha"].numel()
        calls += _block_calls(codec, t, c, blk["res"], prepared)
        calls.append(("snake_filtered", t, c, 0, blk["act"], None))
        t //= stride
    calls.append(("snake_filtered", t, codec.enc_params["final_act"]["alpha"].numel(), 0,
                  codec.enc_params["final_act"], None))
    return calls


def _block_calls(codec, t, c, res, prepared) -> list:
    from flamed_tts_tpu_torch.ops.resunit import stack_tile

    if codec.fuse_blocks and stack_tile(c, codec.dec_params["stem"]["w"].dtype) is not None:
        return [("residual_stack", t, c, 0, res, prepared)]
    return [("residual_unit", t, c, d, u, w) for u, w, d in zip(res, prepared, (1, 3, 9))]


def decoder_calls(codec, frames: int) -> list:
    """The kernel calls (as ``encoder_calls``) of ``codec.decode`` over
    ``frames`` latent frames."""
    calls, t = [], frames
    for blk, prepared, stride in zip(codec.dec_params["blocks"], codec.dec_prepared, codec.up_ratios_dec):
        calls.append(("snake_filtered", t, blk["act"]["alpha"].numel(), 0, blk["act"], None))
        t *= stride
        calls += _block_calls(codec, t, blk["up"]["w"].shape[1], blk["res"], prepared)
    calls.append(("snake_filtered", t, codec.dec_params["final_act"]["alpha"].numel(), 0,
                  codec.dec_params["final_act"], None))
    return calls


def synth_calls(synth: dict, frames: int, up_ratios=CODEC_UP_DEC) -> list:
    """The kernel calls (as ``encoder_calls``, one K2 launch a unit) of
    ``facodec.decoder.synthesize`` with parameters ``synth`` over
    ``frames`` latent frames: the redecoder's."""
    calls, t = [], frames
    for blk, stride in zip(synth["blocks"], up_ratios):
        calls.append(("snake_filtered", t, blk["act"]["alpha"].numel(), 0, blk["act"], None))
        t *= stride
        calls += [("residual_unit", t, blk["up"]["w"].shape[1], d, u, None)
                  for u, d in zip(blk["res"], (1, 3, 9))]
    calls.append(("snake_filtered", t, synth["final_act"]["alpha"].numel(), 0, synth["final_act"], None))
    return calls


def main_path_calls(codec, n_samples: int, f_bucket: int) -> list:
    """The kernel calls of one Flamed.sample: the encoder over the padded
    prompt, the decoder over the frame bucket."""
    return encoder_calls(codec, n_samples) + decoder_calls(codec, f_bucket)


def launch_counts(calls) -> dict:
    return {k: sum(1 for c in calls if c[0] == k) for k in SOURCES}


def training_phase(kernels, compare, codec, dev, tmp: str) -> dict:
    """Phase 6, the training path (see the module docstring).  ``codec`` is
    the fp32 codec of path A (one K2 launch a residual unit); the corpus,
    its precomputed set and the configs go under ``tmp``, which phase 10
    reads again.  The precompute and the trainer run under PyTorch's own
    TF32 switches (``DEFAULT_TF32``), every comparison with TF32 off.
    Returns, for the kernels line, {"precompute": one 17 s utterance's
    analysis, "validation": the trainer run's validation audio}, each
    {"calls", "launches"}."""
    from flamed_tts_tpu_torch.config import load_yaml, save_yaml
    from flamed_tts_tpu_torch.data.dataset import batch_iterator
    from flamed_tts_tpu_torch.data.synthetic import fabricate_corpus
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
    from flamed_tts_tpu_torch.models.flamed import Flamed
    from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference
    from flamed_tts_tpu_torch.ops.resunit import residual_unit_cuda, residual_unit_reference
    from flamed_tts_tpu_torch.ops.snake import snake_filtered_cuda
    from flamed_tts_tpu_torch.precision import bf16_on_cpu, matmul_precision
    from flamed_tts_tpu_torch.precompute import analyze_utterance, precompute
    from flamed_tts_tpu_torch.train import cli as train_cli
    from flamed_tts_tpu_torch.train.step import batch_to_device, init_train_state, train_step
    from flamed_tts_tpu_torch.utils.audio import load_wav

    gib = 2.0 ** 30
    # 6.1 a corpus of 32 utterances of 3-16 s; the first one 15.6 s, so
    # that its analysis runs at the 17 s bucket (272000 samples)
    seconds = np.random.RandomState(0).uniform(3.0, 16.0, TRAIN_UTTERANCES)
    seconds[0] = 15.6
    manifest = fabricate_corpus(os.path.join(tmp, "corpus"), seconds, seed=0)
    with open(manifest, encoding="utf-8") as fin:
        lines = [ln.strip() for ln in fin if ln.strip()]

    # 6.2 precompute on the card, under PyTorch's own TF32 switches
    npz_dir = os.path.join(tmp, "npz")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with tf32(*DEFAULT_TF32):
        setting = tf32_label()
        stats = precompute(lines, npz_dir, codec)
        torch.cuda.synchronize()
    run_launches = dict(kernels.launches)
    audio_s, wall = stats["audio_s"], stats["seconds"]
    log(f"[train precompute] {stats['done']} utterances ({stats['failed']} failed), "
        f"{audio_s:.1f} s of audio in {wall:.2f} s ({setting}): {stats['done'] / wall:.2f} "
        f"utterances/s, {audio_s / wall:.1f} audio-s/s; launches {json.dumps(run_launches)}; "
        f"peak memory {torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    expected = {"snake_filtered": 5 * TRAIN_UTTERANCES, "residual_unit": 12 * TRAIN_UTTERANCES,
                "residual_stack": 0}
    if stats["done"] != TRAIN_UTTERANCES or stats["failed"] or run_launches != expected:
        raise AssertionError(f"precompute: {stats}, launches {run_launches}, expected {expected}")
    # one >= 12 s utterance analysed again on the card, TF32 off and its
    # launches counted, against the CPU's plain path
    wav = load_wav(lines[0].split("|")[0])
    padded = len(codec.pad_prompt_wav(wav)[0])
    kernels.reset_launches()
    card = analyze_utterance(codec, wav)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    ref = analyze_utterance(FaCodec.from_pretrained(CODEC_DIR, device="cpu"), wav)
    n_diff = int((card["code"] != ref["code"]).sum())
    errs = {k: float(np.abs(card[k] - ref[k]).max()) for k in ("emb", "spk")}
    ok = n_diff == 0 and all(np.all(np.abs(card[k] - ref[k]) <= TOL + TOL * np.abs(ref[k]))
                             for k in ("emb", "spk"))
    log(f"[train precompute] utterance 0 ({len(wav)} samples, padded to {padded}) on the card "
        f"({tf32_label()}; launches {json.dumps(launches)}) vs CPU: {n_diff} of "
        f"{ref['code'].size} RVQ codes differ; emb max abs diff {errs['emb']:.3e}, spk "
        f"{errs['spk']:.3e} (tol {TOL} abs + {TOL} rel: fp32, other summation orders) "
        f"{'ok' if ok else 'FAIL'}")
    with np.load(os.path.join(npz_dir, "utt00000.npz")) as got:
        got = {k: got[k] for k in ("code", "emb", "spk")}
    log(f"[train precompute] utterance 0 as the precompute wrote it ({setting}) vs CPU: "
        f"{int((got['code'] != ref['code']).sum())} of {ref['code'].size} RVQ codes differ; emb "
        f"max abs diff {float(np.abs(got['emb'] - ref['emb']).max()):.3e}, spk "
        f"{float(np.abs(got['spk'] - ref['spk']).max()):.3e} (not held: TF32 convolutions)")
    calls = encoder_calls(codec, padded)
    if not ok or padded != 17 * 16000 or launches != launch_counts(calls):
        raise AssertionError(f"the card's analysis of utterance 0 disagrees with the CPU's, or "
                             f"its launches {launches} are not those of {padded} samples")
    # K1 and K2 at the first two encoder blocks' lengths of the 17 s bucket
    # (and one row short of the first), with the trained codec's weights
    gen = torch.Generator(device=dev).manual_seed(3)
    for blk, t in zip(codec.enc_params["blocks"][:2], (272000, 136000)):
        c = blk["act"]["alpha"].numel()
        for t_len in ((t, t - 1) if c == 32 else (t,)):
            x = torch.randn((1, t_len, c), generator=gen, device=dev)
            compare("snake_filtered", snake_filtered_cuda(x, blk["act"]["alpha"], blk["act"]["beta"]),
                    snake_filtered_reference(x, blk["act"]["alpha"], blk["act"]["beta"]),
                    f"precompute (1, {t_len}, {c})", path="precompute")
            for u, d in zip(blk["res"], (1, 3, 9)):
                compare("residual_unit", residual_unit_cuda(x, u, d),
                        residual_unit_reference(x, u, d), f"precompute (1, {t_len}, {c}) d={d}",
                        path="precompute")

    # 6.3 the trainer CLI at full width, under PyTorch's own TF32
    # switches: configs/*.yaml with the data config pointed at the
    # precomputed set
    cfg_dir, exp = os.path.join(tmp, "configs"), os.path.join(tmp, "exp")
    for name in ("prior", "prob", "codec", "optimizer", "data"):
        part = load_yaml(os.path.join(ROOT, "configs", f"{name}.yaml"))
        if name == "data":
            part.update(data_root=npz_dir, use_precomputed=True)
        save_yaml(part, os.path.join(cfg_dir, f"{name}.yaml"))
    args = ["--config-dir", cfg_dir, "--exp-dir", exp, "--val-every", "15",
            "--codec-dir", CODEC_DIR, "--audio-log-after", "0", "--device", dev.type]
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tf32(*DEFAULT_TF32):
        setting = tf32_label()
        state = train_cli.main(args + ["--max-steps", str(TRAIN_STEPS), "--log-every", "5"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = dict(kernels.launches)
    with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fin:
        records = [json.loads(x) for x in fin]
    steps = [r for r in records if "total_loss" in r]
    timed = [r for r in steps if "steps_per_sec" in r]
    vals = [r["total_loss_val"] for r in records if "total_loss_val" in r]
    loss_keys = ("dur_loss", "sil_loss", "prior_loss", "fm_loss", "anchor_loss", "total_loss",
                 "grad_norm")
    finite = all(np.isfinite(r[k]) for r in steps for k in loss_keys) and all(np.isfinite(vals))
    files = [os.path.join(exp, f) for f in ("metrics.jsonl", "config.yaml", "checkpoints/last.npz",
                                            "checkpoints/train_state.pt")]
    wavs = [os.path.join(exp, "val_audio", f"step{s}_{k}.wav") for s in (15, 30)
            for k in ("synth", "gt")]
    rate = {k: float(np.median([r[k] for r in timed])) for k in
            ("steps_per_sec", "samples_per_sec", "frames_per_sec")}
    # the validation audio's decodes: the synthesis at its frame bucket,
    # the ground truth at its length (metrics.jsonl holds floats)
    audio = [r for r in records if "val_audio_frame_bucket" in r]
    val_calls = [c for r in audio for k in ("val_audio_frame_bucket", "val_audio_gt_frames")
                 for c in decoder_calls(codec, int(r[k]))]
    log(f"[train cli] {setting}; {state.step} steps at batch 16 in {wall:.1f} s (first step "
        f"{next(r['first_step_s'] for r in records if 'first_step_s' in r):.1f} s); warm "
        f"intervals of 5 steps: median step {1e3 / rate['steps_per_sec']:.1f} ms, "
        f"{rate['samples_per_sec']:.2f} samples/s, {rate['frames_per_sec']:.0f} valid frames/s "
        f"(each {', '.join(f'{1e3 / r['steps_per_sec']:.1f}' for r in timed)} ms a step); "
        f"peak memory {torch.cuda.max_memory_allocated() / gib:.2f} GiB")
    log(f"[train cli] total_loss at steps {[r['step'] for r in steps]}: "
        f"{[round(r['total_loss'], 4) for r in steps]}; grad_norm "
        f"{[round(r['grad_norm'], 3) for r in steps]}; total_loss_val {vals}; "
        f"launches {json.dumps(train_launches)} (validation audio at steps "
        f"{[r['step'] for r in audio]}: synthesis decoded at "
        f"{[int(r['val_audio_frame_bucket']) for r in audio]} frames, ground truth at "
        f"{[int(r['val_audio_gt_frames']) for r in audio]})")
    missing = [f for f in files + wavs if not os.path.isfile(f)]
    if (state.step != TRAIN_STEPS or not finite or len(vals) != 2 or missing or len(audio) != 2
            or train_launches != launch_counts(val_calls) or not train_launches["snake_filtered"]
            or not train_launches["residual_unit"]):
        raise AssertionError(f"trainer: step {state.step}, finite {finite}, validations {vals}, "
                             f"missing {missing}, validation audio {audio}, launches "
                             f"{train_launches}, expected {launch_counts(val_calls)}")
    del state
    torch.cuda.empty_cache()

    # 6.4 the loss falls on one fixed batch at lr 1e-3, no warmup (the
    # trainer's TF32 switches)
    cfg = train_cli.load_training_config(
        cfg_dir, overrides={"optimizer_cfg": {"lr": 1e-3, "warmup_steps": 0}})
    trainset, _ = train_cli.make_datasets(cfg["dataset_cfg"])
    collator = train_cli.make_collator(cfg["dataset_cfg"], 0)
    batch = next(batch_iterator(trainset, collator, 16, shuffle=True, seed=0))
    model = Flamed(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    state = init_train_state(model.prior, model.prob, cfg["optimizer_cfg"], seed=0)
    on_card = batch_to_device(batch, dev)
    with tf32(*DEFAULT_TF32):
        losses = [float(train_step(state, on_card)["total_loss"]) for _ in range(20)]
        log(f"[train fixed batch] {tf32_label()}; total_loss over 20 steps at lr 1e-3 (frames "
            f"{batch['codes'].shape[-1]}, phonemes {batch['phonemes'].shape[-1]}): "
            f"{[round(v, 4) for v in losses]}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError("the loss did not fall over 20 steps on one batch")
        train_step_breakdown(state, on_card, batch)
    del model, state, on_card
    torch.cuda.empty_cache()

    # 6.5 one deterministic step (dropout rates 0) on the card, at "highest"
    # (TF32 off) and at "default", and on the CPU, from the same parameters
    # and the same draws.  eps 1e-4 in
    # place of 1e-9: a parameter whose gradient is zero in exact
    # arithmetic (the attention's key biases, the depthwise conv biases
    # before a per-channel norm) holds rounding noise that differs
    # between the devices, and Adam's first step scales it to +-lr at
    # eps 1e-9
    cfg = train_cli.load_training_config(cfg_dir, overrides={
        "optimizer_cfg": {"warmup_steps": 0, "eps": 1e-4},
        "prior_generator": {"transformer": {"encoder_dropout": 0.0, "decoder_dropout": 0.0},
                            "variance_adaptor": {g: {"drop_out": 0.0} for g in
                                                 ("duration_generator", "sil_generator")}}})
    order = np.argsort([trainset[i]["code"].shape[-1] for i in range(len(trainset))])
    batch = collator([trainset[int(i)] for i in order[:2]])
    b, l = batch["phonemes"].shape
    lf = batch["codes"].shape[-1]
    nrng = np.random.RandomState(7)
    draws = {"pva_t": nrng.rand(b, 1), "dur_noise": nrng.randn(b, l),
             "sil_noise": nrng.randn(b, l), "prob_t": nrng.rand(b, lf, 1),
             "prob_noise": nrng.randn(b, lf, 256)}
    params = Flamed(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    start = {k: {n: v.clone() for n, v in getattr(params, k).state_dict().items()}
             for k in ("prior", "prob")}
    del params
    out = {}
    # each run from the same start: the card at "highest" and at "default"
    # (the trainer's, its products captured), the CPU at "highest" (float32)
    # and at "default" with the card's arithmetic forced onto it
    products = []
    for where, precision in (("card", "highest"), ("card default", "default"), ("cpu", "highest"),
                             ("cpu default", "default")):
        model = Flamed(cfg, params={k: {n: v.clone() for n, v in sd.items()} for k, sd in start.items()},
                       device="cpu" if where.startswith("cpu") else dev)
        device = model.device
        state = init_train_state(model.prior, model.prob, cfg["optimizer_cfg"], seed=0)
        handles = []
        if where == "card default":
            products, handles = capture_products({"prior": model.prior, "prob": model.prob})
        with contextlib.ExitStack() as stack:
            stack.enter_context(matmul_precision(precision))
            if where == "cpu default":
                stack.enter_context(bf16_on_cpu())
            metrics = train_step(state, batch_to_device(batch, device),
                                 draws={k: torch.as_tensor(v, dtype=torch.float32, device=device)
                                        for k, v in draws.items()})
        for h in handles:
            h.remove()
        out[where] = ({k: float(v) for k, v in metrics.items()},
                      {k: {n: v.float().cpu() for n, v in sd.items()} for k, sd in
                       (("prior", model.prior.state_dict()), ("prob", model.prob.state_dict()))},
                      torch.cat([p.grad.float().flatten().cpu() for p in state.parameters()]))
        del model, state
    (mg, pg, _), (mc, pc, gc) = out["card"], out["cpu"]
    loss_rel = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc if k != "grad_norm")
    norm_rel = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
    worst, moved = 0.0, 0.0
    for part in pc:
        for n, vc in pc[part].items():
            excess = (pg[part][n] - vc).abs() - (1e-5 + 1e-4 * vc.abs())
            worst = max(worst, float(excess.max()))
            moved = max(moved, float((vc - start[part][n]).abs().max()))
    log(f"[train card vs CPU] one step at \"highest\", batch of 2 (phonemes {l}, frames {lf}): losses max rel "
        f"diff {loss_rel:.3e} (tol 1e-4), grad_norm {mg['grad_norm']:.4f} vs {mc['grad_norm']:.4f}, "
        f"rel {norm_rel:.3e} (tol 1e-3); parameters after AdamW: worst excess over 1e-5 abs + "
        f"1e-4 rel {worst:.3e} (<= 0 passes), largest move {moved:.3e}")
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-3 and worst <= 0.0 and moved > 1e-5):
        raise AssertionError("a training step on the card disagrees with the same on the CPU")

    # the "default" step's products, replayed: the card against the CPU's
    # emulation, and the control (results rounded to bf16) against the same
    with matmul_precision("default"):
        worst_layer, control_least, n_replayed = replay_products(products, start, dev)
    del products
    log(f"[train card vs CPU] the \"default\" step's {n_replayed} matmul / conv calls replayed on their "
        f"inputs and incoming gradients, card against the CPU's emulation (output, input and weight "
        f"gradients; and the step's own output): worst rel L2 {worst_layer[0]:.3e} at {worst_layer[1]} "
        f"(tol {LAYER_REL}); the control with results rounded to bf16: least per call {control_least:.3e} "
        f"(must exceed {LAYER_REL})")
    if not (n_replayed > 0 and worst_layer[0] <= LAYER_REL):
        raise AssertionError("a product of the \"default\" step on the card disagrees with the CPU's "
                             "emulation of the card's arithmetic")
    if not control_least > LAYER_REL:
        raise AssertionError("the per-product bound admits results rounded to bf16")

    (md, _, gd), (me, _, ge) = out["card default"], out["cpu default"]

    def off(m, g):
        """(losses' max rel diff, grad norm rel diff, gradients' rel L2
        diff) against the CPU's float32 step."""
        return (max(abs(m[k] - mc[k]) / abs(mc[k]) for k in mc if k != "grad_norm"),
                abs(m["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"], rel_l2(g, gc))

    card_off, emul_off = off(md, gd), off(me, ge)
    ratio = card_off[2] / emul_off[2]
    log("[train card vs CPU] off the CPU's float32 step (losses max rel, grad norm rel, gradients rel "
        f"L2): the card at \"default\" {', '.join(f'{d:.3e}' for d in card_off)}; the CPU's emulation "
        f"{', '.join(f'{d:.3e}' for d in emul_off)}; gradients' ratio {ratio:.3f} "
        f"(tol {STEP_NOISE_RATIO[0]}-{STEP_NOISE_RATIO[1]}); the card's gradients against the "
        f"emulation's {rel_l2(gd, ge):.3e} rel L2 (the sum order's flipped roundings, cascaded)")
    if not STEP_NOISE_RATIO[0] <= ratio <= STEP_NOISE_RATIO[1]:
        raise AssertionError("the \"default\" step on the card departs from the CPU's float32 step "
                             "otherwise than bf16 operands take it")
    torch.cuda.empty_cache()

    # 6.6 resume for two more steps, then serve from last.npz
    with tf32(*DEFAULT_TF32):
        state = train_cli.main(args + ["--max-steps", str(TRAIN_STEPS + 2), "--log-every", "1",
                                       "--resume-full"])
    with open(os.path.join(exp, "metrics.jsonl"), encoding="utf-8") as fin:
        resumed = [json.loads(x) for x in fin][len(records):]
    losses = [r["total_loss"] for r in resumed if "total_loss" in r]
    log(f"[train resume] from step {TRAIN_STEPS} to {state.step}: total_loss {losses}")
    if state.step != TRAIN_STEPS + 2 or len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError("resume did not continue the step count with finite losses")
    del state
    cfg = train_cli.load_training_config(cfg_dir)
    model = Flamed.from_pretrained(cfg, os.path.join(exp, "checkpoints", "last.npz"), device=dev)
    res = model.sample(text=TEXT, prompt_raw=prompt_wav(3.0, seed=4), codec=codec, seed=0,
                       nsteps_durgen=32, nsteps_denoiser=32)
    n = int(res["tgt_len"][0])
    log(f"[train serve] last.npz through Flamed.from_pretrained: tgt_len {n}, wav "
        f"{res['wav'].shape[0]} samples, finite {bool(np.isfinite(res['wav']).all())}")
    if res["wav"].shape != (n * codec.hop,) or n <= 0 or not np.isfinite(res["wav"]).all():
        raise AssertionError("the trained checkpoint did not serve a finite wav")
    return {"precompute": {"calls": calls, "launches": launches},
            "validation": {"calls": val_calls, "launches": train_launches}}


def bench_phase(kernels, dev) -> dict:
    """Phase 7, the serving path's measurement and ingestion entry points
    (see the module docstring).  Returns, for the kernels line, {"bench":
    {"calls", "launches"}} of one timed bench call, with the bench's RTF
    ("rtf") and bench_throughput's ("throughput_rtf") for phase 11."""
    import tempfile

    from flamed_tts_tpu_torch import bench, bench_throughput, profile_sample
    from flamed_tts_tpu_torch import synthesize as synth_cli
    from flamed_tts_tpu_torch.config import load_default_config
    from flamed_tts_tpu_torch.convert import params_to_jax
    from flamed_tts_tpu_torch.convert_ckpt import flamed_state_dict
    from flamed_tts_tpu_torch.models.flamed import Flamed
    from flamed_tts_tpu_torch.runtime.pytree_io import flatten_pytree
    from flamed_tts_tpu_torch.utils.audio import save_wav
    from flamed_tts_tpu_torch.utils.profiling import TRACE_FILE

    t_phase = time.perf_counter()

    def elapsed(step):
        log(f"[phase 7] {step} done at {time.perf_counter() - t_phase:.1f} s")

    # 7.1 the headline bench, as a user runs it (it prints its JSON line)
    with tf32(*DEFAULT_TF32):
        setting = tf32_label()
        res = bench.main([])
    model, codec, run = res["model"], res["codec"], res["run"]
    n_phonemes = model._get_frontend()(bench.TEXT)[0].shape[1]
    log(f"[bench] {setting}; {n_phonemes} phonemes; the line above: {json.dumps(res['report'])}")
    lo, hi = bench.FRAMES_PER_PHONEME
    for c, fpp in zip(res["calls"], bench.frames_per_phoneme(model, res["calls"])):
        log(f"[bench] timed call seed {c['seed']}: {1e3 * c['seconds']:.1f} ms, tgt_len {c['tgt_len']} "
            f"({fpp:.2f} frames a phoneme), frame bucket {c['frame_bucket']}, audio "
            f"{c['audio_s']:.3f} s")
        if not (lo <= fpp <= hi and c["frame_bucket"] >= c["tgt_len"]):
            raise AssertionError(f"bench: {fpp:.2f} frames a phoneme outside [{lo}, {hi}] ({c})")
    log(f"[bench] five timed calls (ms): {[round(1e3 * c['seconds'], 1) for c in res['calls']]}; "
        f"dispatch-floor probe {res['report']['probe_ms']} ms (limit {bench.DISPATCH_LIMIT_MS} ms), "
        f"load1 {res['report']['load1']}")
    kernels.reset_launches()
    with tf32(*DEFAULT_TF32):
        out = run(1)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    calls = main_path_calls(codec, len(codec.pad_prompt_wav(bench.prompt_wav())[0]),
                            int(out["frame_bucket"]))
    log(f"[bench] kernel launches in one timed call (seed 1, frame bucket {out['frame_bucket']}): "
        f"{json.dumps(launches)}")
    if (launches != launch_counts(calls) or not launches["snake_filtered"]
            or not launches["residual_unit"]):
        raise AssertionError(f"bench: launches {launches}, expected {launch_counts(calls)}")

    # where one warm bench call's time goes on the device
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tf32(*DEFAULT_TF32), torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        run(1)
        wall = 1e3 * (time.perf_counter() - w0)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[bench] profiled call {wall:.1f} ms: device busy {busy:.1f} ms ({100 * busy / wall:.1f} %), "
        f"{sum(e.count for e in events)} device kernels/copies")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
        log(f"[bench]   {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")
    core_gemm = {e.key[:90]: round(e.self_device_time_total / 1e3, 3) for e in events
                 if CUDA_CORE_GEMM.search(e.key)}
    log(f"[bench] the profiled call's GEMM kernels off the tensor cores (ms; the codec's): "
        f"{json.dumps(core_gemm)}")
    precision_check("bench", model, codec, model._get_frontend()(bench.TEXT)[0], bench.prompt_wav(), dev)
    elapsed("bench")

    # 7.2 the throughput bench, batch 4 at nfe 128 (it prints its JSON line)
    with tf32(*DEFAULT_TF32):
        setting = tf32_label()
        thr = bench_throughput.main([])
    log(f"[bench_throughput] {setting}; the line above: {json.dumps(thr['report'])}; batch "
        f"times (ms) {[round(1e3 * t, 1) for t in thr['times']]}, audio s a batch {thr['seconds']}")
    elapsed("bench_throughput")

    # 7.3 host spans of the bench call (it prints its JSON line)
    with tf32(*DEFAULT_TF32):
        setting = tf32_label()
        prof = profile_sample.main([])
    spans = prof["spans_ms"]
    fused = spans.get("fused_dispatch", 0.0) + spans.get("fused_get", 0.0)
    log(f"[profile_sample] {setting}; spans (ms a call): {json.dumps(spans)}; residual {prof['residual_ms']} ms; "
        f"wall {prof['wall_ms']} ms; fused_dispatch + fused_get {fused:.2f} ms "
        f"({100 * fused / prof['wall_ms']:.1f} % of the wall)")
    if set(spans) != {"frontend", "prompt_prep", "input_place", "prompt_place", "fused_dispatch",
                      "fused_get"} or fused < 0.5 * prof["wall_ms"]:
        raise AssertionError("profile_sample: spans missing, or the fused call is not most of the wall")
    elapsed("profile_sample")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        # 7.4 synthesize --profile-dir: a torch.profiler trace with the card's kernels
        save_wav(os.path.join(tmp, "p.wav"), bench.prompt_wav())
        args = synth_cli.build_arg_parser().parse_args([
            "--ckpt-path", "random", "--cfg-path", os.path.join(ROOT, "configs"), "--codec-dir",
            "random", "--text", "Hello world.", "--prompt-list", "p.wav", "--prompt-dir", tmp,
            "--output-dir", os.path.join(tmp, "out"), "--nsteps-durgen", "8", "--nsteps-denoiser",
            "8", "--seed", "0", "--precision", "bf16", "--profile-dir", os.path.join(tmp, "prof")])
        synth_cli.main(args)
        trace_path = os.path.join(tmp, "prof", TRACE_FILE)
        with open(trace_path, encoding="utf-8") as fin:
            events = json.load(fin)["traceEvents"]
        gpu = [e for e in events if e.get("cat") == "kernel"]
        hand = {k: sum(1 for e in gpu if f"{k}_kernel" in e.get("name", "")) for k in SOURCES}
        log(f"[synthesize --profile-dir] {trace_path}: {os.path.getsize(trace_path)} bytes, "
            f"{len(events)} events, {len(gpu)} CUDA kernel events; hand kernels {json.dumps(hand)}")
        if not gpu or not hand["snake_filtered"] or not hand["residual_unit"]:
            raise AssertionError("the profile trace holds no CUDA kernel events of the hand kernels")
        elapsed("synthesize --profile-dir")

        # 7.5 the bench's weights as the reference's checkpoint: .ckpt and
        # .npz through Flamed.from_pretrained, bit for bit
        cfg = load_default_config()
        params = {"prior": params_to_jax(model.prior.state_dict()),
                  "prob": params_to_jax(model.prob.state_dict())}
        ckpt, npz = os.path.join(tmp, "model.ckpt"), os.path.join(tmp, "model.npz")
        torch.save({"state_dict": flamed_state_dict(params), "epoch": 0}, ckpt)
        # uncompressed (the loader reads either): compressing these 480 MB
        # takes a minute and a half
        np.savez(npz, **flatten_pytree(params))
        wavs, states = {}, {}
        for name, path in (("ckpt", ckpt), ("npz", npz)):
            m = Flamed.from_pretrained(cfg, path, device=dev)
            states[name] = {k: v for mod in (m.prior, m.prob) for k, v in mod.state_dict().items()}
            o = m.sample(text=bench.TEXT, prompt_raw=bench.prompt_wav(), codec=codec, seed=0)
            wavs[name] = (o["wav"], int(o["tgt_len"][0]))
            del m
        same_state = all(torch.equal(v, states["npz"][k]) for k, v in states["ckpt"].items())
        same_wav = wavs["ckpt"][1] == wavs["npz"][1] and np.array_equal(wavs["ckpt"][0], wavs["npz"][0])
        log(f"[ckpt] {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB reference-format .ckpt and "
            f"{os.path.getsize(npz) / 2 ** 20:.1f} MiB .npz of the bench's weights through "
            f"Flamed.from_pretrained on the card: state equal bit for bit {same_state}; seed 0: "
            f"tgt_len {wavs['ckpt'][1]} vs {wavs['npz'][1]}, wav equal bit for bit {same_wav}")
        if not (same_state and same_wav and len(states["ckpt"]) == len(states["npz"])):
            raise AssertionError("the .ckpt route disagrees with the .npz route")
        del states, wavs
        elapsed("the .ckpt route")

    return {"bench": {"calls": calls, "launches": launches, "rtf": res["report"]["value"],
                      "throughput_rtf": thr["report"]["value"]}}


def codec_train_calls(params, batch: int, n_samples: int) -> list:
    """(kernel, T, C, dilation or 0, params, None, batch) of every forward
    kernel launch of one codec-trainer step: the encoder over ``batch``
    crops of ``n_samples`` samples, then the synthesis over their frames
    (one K2 launch a unit, no K3)."""
    unprepared = [[None] * 3 for _ in range(4)]
    view = types.SimpleNamespace(enc_params=params["enc"], dec_params=params["dec"], fuse_blocks=False,
                                 enc_prepared=unprepared, dec_prepared=unprepared,
                                 up_ratios_enc=CODEC_UP_ENC, up_ratios_dec=CODEC_UP_DEC)
    calls = encoder_calls(view, n_samples) + decoder_calls(view, n_samples // math.prod(CODEC_UP_ENC))
    return [c + (batch,) for c in calls]


def grad_check(name: str, kernel_fn, plain_fn, x, leaves, label: str, gen) -> tuple:
    """The kernel's Function under grad against autograd through the plain
    chain, on the card with TF32 off: the forward (TOL) and the gradients
    of ``x`` and each of ``leaves`` for one upstream gradient, each within
    GRAD_TOL of its leaf's largest gradient.  Returns (the largest error
    over the leaf scale, the Function's backward ms, autograd's backward ms
    through the plain chain), both backward times from CUDA events over
    retained graphs."""
    x = x.detach().requires_grad_()
    out, ref = kernel_fn(x), plain_fn(x)
    if out.grad_fn is None or type(out.grad_fn).__name__.split("Backward")[0] not in GRAD_FUNCTIONS[name]:
        raise AssertionError(f"{name} {label}: the result carries no gradient of the kernel's Function "
                             f"({out.grad_fn})")
    g = torch.randn(out.shape, generator=gen, device=out.device)
    wrt = [x, *leaves]
    got = torch.autograd.grad(out, wrt, g, retain_graph=True)
    want = torch.autograd.grad(ref, wrt, g, retain_graph=True)
    fwd_ok = bool(torch.all((out - ref).abs() <= TOL + TOL * ref.abs()))
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(got, want))
    k_ms = events_ms(lambda: torch.autograd.grad(out, wrt, g, retain_graph=True), 3)
    p_ms = events_ms(lambda: torch.autograd.grad(ref, wrt, g, retain_graph=True), 3)
    log(f"[phase 8] [grad] {name} {label}: forward {'ok' if fwd_ok else 'FAIL'}; gradients of x and "
        f"{len(leaves)} parameters: largest error {worst:.3e} of the leaf's largest gradient (tol "
        f"{GRAD_TOL:g}: the same plain VJP at the same input, cuDNN's backward algorithms); backward "
        f"{k_ms:.3f} ms (plain forward recomputed + its VJP) vs autograd through the plain chain "
        f"{p_ms:.3f} ms")
    if not fwd_ok or not worst <= GRAD_TOL:
        raise AssertionError(f"{name} {label}: the Function's gradient disagrees with the plain chain's")
    return worst, k_ms, p_ms


def codec_step_breakdown(params, opt, batch, n_q) -> None:
    """Where a warm codec-trainer step's time goes, under PyTorch's own TF32
    switches: the forward (loss), the backward and the update timed apart
    on the host clock (each ends in a synchronize); the device's busy share
    and top kernels from torch.profiler over one step."""
    from flamed_tts_tpu_torch import train_codec

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0)

    flat = train_codec.leaves(params)
    with tf32(*DEFAULT_TF32):
        setting = tf32_label()
        (total, _), fwd_ms = timed(lambda: train_codec.loss_fn(params, *batch, n_q, TRAIN_CODEC_WEIGHTS))
        grads, bwd_ms = timed(lambda: torch.autograd.grad(total, flat, allow_unused=True))
        _, opt_ms = timed(lambda: opt.step([torch.zeros_like(p) if g is None else g
                                            for p, g in zip(flat, grads)]))
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, wall = timed(lambda: train_codec.train_step(params, opt, *batch, n_q, TRAIN_CODEC_WEIGHTS))
    log(f"[phase 8] [codec breakdown] {setting}: forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, "
        f"update {opt_ms:.1f} ms")
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[phase 8] [codec breakdown] profiled step {wall:.1f} ms: device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f} %), {sum(e.count for e in events)} device kernels/copies")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[phase 8] [codec breakdown]   {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} "
            f"{e.key[:90]}")


def codec_train_phase(kernels, compare, dev) -> dict:
    """Phase 8, codec training and voice conversion (see the module
    docstring).  Returns, for the kernels line, {"codec_train": {"calls",
    "launches", "backward"}}: one trainer step's forward kernel calls, its
    launches and the backward times per (kernel, T, C, d, batch)."""
    import tempfile

    from flamed_tts_tpu_torch import train_codec
    from flamed_tts_tpu_torch.convert import params_to_jax
    from flamed_tts_tpu_torch.data.synthetic import fabricate_speaker_corpus
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
    from flamed_tts_tpu_torch.models.facodec import extras
    from flamed_tts_tpu_torch.models.facodec.encoder import init_encoder_params
    from flamed_tts_tpu_torch.ops.resample import snake_filtered_reference
    from flamed_tts_tpu_torch.ops.resunit import (pick_tile, residual_stack_cuda, residual_stack_reference,
                                                  residual_unit_cuda, residual_unit_reference,
                                                  stack_tile, unit_smem_bytes)
    from flamed_tts_tpu_torch.ops.snake import snake_filtered_cuda
    from flamed_tts_tpu_torch.runtime.pytree_io import flatten_pytree

    t_phase = time.perf_counter()
    gib = 2.0 ** 30

    def elapsed(step):
        log(f"[phase 8] {step} done at {time.perf_counter() - t_phase:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(8)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def unit(c, dtype=torch.float32):
        s = 1.0 / math.sqrt(7 * c)
        return {"act1": {"alpha": rnd(c, scale=0.3), "beta": rnd(c, scale=0.3)},
                "act2": {"alpha": rnd(c, scale=0.3), "beta": rnd(c, scale=0.3)},
                "conv1": {"w": rnd(c, c, 7, scale=s, dtype=dtype), "b": rnd(c, scale=0.1, dtype=dtype)},
                "conv2": {"w": rnd(c, c, 1, scale=s, dtype=dtype), "b": rnd(c, scale=0.1, dtype=dtype)}}

    # 8.1 K2 at d = 2 and K1 at cnn_predictor's shapes (C = 256), fp32 and bf16,
    # and K2 at d = 2 where the last 16-row mma tile is ragged
    unit_fn = kernels.library("residual_unit").residual_unit_smem_bytes
    for dtype in (torch.float32, torch.bfloat16):
        item = 2 if dtype == torch.bfloat16 else 4
        units = [unit(256, dtype) for _ in range(3)]
        for t in (160, 1200) + MMA_PADDING_T:
            tile = pick_tile(t, 256, 2, item)
            if unit_fn(256, 2, tile, item) != unit_smem_bytes(256, 2, tile, item):
                raise AssertionError("unit_smem_bytes disagrees with residual_unit.cu at d = 2")
            x = rnd(8 if t == 160 else 1, t, 256, dtype=dtype)
            for p, d in zip(units, (1, 2, 3)):
                compare("residual_unit", residual_unit_cuda(x, p, d), residual_unit_reference(x, p, d),
                        f"[phase 8] cnn_predictor ({x.shape[0]}, {t}, 256) d={d} tile={tile if d == 2 else '-'}")
            a = units[0]["act1"]
            compare("snake_filtered", snake_filtered_cuda(x, a["alpha"], a["beta"]),
                    snake_filtered_reference(x, a["alpha"], a["beta"]),
                    f"[phase 8] cnn_predictor ({x.shape[0]}, {t}, 256)")
        # d = 2 beside d = 1 and 3 at the training decode's predictor shape
        x = rnd(8, 160, 256, dtype=dtype)
        ms = [graph_ms(lambda: residual_unit_cuda(x, p, d), 20) for p, d in zip(units, (1, 2, 3))]
        log(f"[phase 8] [time] residual_unit {DTYPE_NAMES[dtype]} (8, 160, 256) d = 1 / 2 / 3: "
            f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms (graph)")
    elapsed("8.1 K2 at d = 2 and K1 at C = 256")

    # 8.2 gradients through the kernels at the codec trainer's shapes, TF32 off
    params = train_codec.tree_map(lambda t: t.to(dev).requires_grad_(),
                                  train_codec.init_params(torch.Generator().manual_seed(0), 3))
    calls = codec_train_calls(params, CODEC_BATCH, CODEC_CROP * 200)
    backward, seen = {}, set()
    ggen = torch.Generator(device=dev).manual_seed(9)
    worst_all = 0.0
    for name, t, c, d, p, _, b in calls:
        if (name, t, c, d) in seen:
            continue
        seen.add((name, t, c, d))
        x = rnd(b, t, c)
        if name == "snake_filtered":
            leaves = [p["alpha"], p["beta"]]
            kfn = lambda x: snake_filtered_cuda(x, p["alpha"], p["beta"])  # noqa: E731
            pfn = lambda x: snake_filtered_reference(x, p["alpha"], p["beta"])  # noqa: E731
        else:
            leaves = [p[m][k] for m in ("act1", "conv1", "act2", "conv2") for k in p[m]]
            kfn = lambda x: residual_unit_cuda(x, p, d)  # noqa: E731
            pfn = lambda x: residual_unit_reference(x, p, d)  # noqa: E731
        worst, k_ms, p_ms = grad_check(name, kfn, pfn, x, leaves, f"({b}, {t}, {c}) d={d}", ggen)
        worst_all = max(worst_all, worst)
        backward[(name, t, c, d)] = (k_ms, p_ms)
    # K3 at the encoder shapes stack_tile admits in fp32 (the trainer runs K2 per unit)
    for blk, t in zip(params["enc"]["blocks"][:2], (CODEC_CROP * 200, CODEC_CROP * 100)):
        c = blk["act"]["alpha"].numel()
        if stack_tile(c, torch.float32) is None:
            continue
        leaves = [u[m][k] for u in blk["res"] for m in ("act1", "conv1", "act2", "conv2") for k in u[m]]
        grad_check("residual_stack", lambda x: residual_stack_cuda(x, blk["res"]),
                   lambda x: residual_stack_reference(x, blk["res"]), rnd(CODEC_BATCH, t, c), leaves,
                   f"({CODEC_BATCH}, {t}, {c})", ggen)
    torch.cuda.empty_cache()
    elapsed(f"8.2 gradients through K1/K2/K3 (largest error {worst_all:.3e} of a leaf's scale)")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_codec_") as tmp:
        # 8.3 the codec trainer CLI at the JAX tool's defaults, under PyTorch's
        # own TF32 switches
        seconds = np.random.RandomState(1).uniform(3.0, 8.0, CODEC_UTTERANCES)
        corpus = fabricate_speaker_corpus(os.path.join(tmp, "corpus"), seconds, CODEC_SPEAKERS, seed=0)
        out_dir = os.path.join(tmp, "codec")
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with tf32(*DEFAULT_TF32):
            setting = tf32_label()
            res = train_codec.main(["--corpus", corpus, "--out-dir", out_dir, "--steps", str(CODEC_STEPS),
                                    "--batch", str(CODEC_BATCH), "--crop-frames", str(CODEC_CROP),
                                    "--log-every", "5", "--device", dev.type])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(out_dir, "metrics.jsonl"), encoding="utf-8") as fin:
            rows = [json.loads(x) for x in fin]
        warm = res["step_s"][3:]
        mel = [r["mel_l1"] for r in rows]
        finite = all(np.isfinite(r[k]) for r in rows for k in ("total", "mel_l1", "wav_l1", "commit",
                                                                "phone_ce", "spk_ce"))
        log(f"[phase 8] [train_codec] {setting}; {CODEC_STEPS} steps at batch {CODEC_BATCH}, crop "
            f"{CODEC_CROP} frames, {CODEC_UTTERANCES} utterances of {CODEC_SPEAKERS} speakers "
            f"({seconds.sum():.1f} s) in {wall:.1f} s; median step {1e3 * np.median(warm):.1f} ms "
            f"(steps 4-{CODEC_STEPS}, host clock), {1 / np.median(warm):.2f} steps/s, first step "
            f"{1e3 * res['step_s'][0]:.0f} ms; peak memory {torch.cuda.max_memory_allocated() / gib:.2f} GiB; "
            f"skipped updates {res['opt'].total_notfinite}")
        log(f"[phase 8] [train_codec] mel_l1 at steps {[r['step'] for r in rows]}: {mel}; total "
            f"{[r['total'] for r in rows]}; code usage at the last log {rows[-1]['code_usage']}")
        saved = sorted(os.listdir(out_dir))
        if (not finite or len(res["step_s"]) != CODEC_STEPS or not mel[-1] < mel[0]
                or res["opt"].total_notfinite or "ns3_facodec_decoder.npz" not in saved):
            raise AssertionError(f"codec trainer: finite {finite}, mel_l1 {mel}, files {saved}")
        # one step's forward launches, held to the count of its shapes
        trained = res["params"]
        wav_b, lab_b, spk_b = (torch.as_tensor(a, device=dev) for a in train_codec.make_batch(
            np.random.RandomState(5), *train_codec.load_corpus(corpus, set())[:3], CODEC_BATCH, CODEC_CROP))
        n_q = [extras.quantizer_counts(CODEC_BATCH, len(g), 0.25, torch.Generator(device=dev).manual_seed(0),
                                       dev) for g in trained["dec"]["quantizers"]]
        opt = train_codec.FiniteAdam(train_codec.leaves(trained), train_codec.warmup_cosine_decay(0.0, 10))
        kernels.reset_launches()
        with tf32(*DEFAULT_TF32):
            train_codec.train_step(trained, opt, wav_b, lab_b, spk_b, n_q, TRAIN_CODEC_WEIGHTS)
        torch.cuda.synchronize()
        step_launches = dict(kernels.launches)
        expected = launch_counts(calls)
        log(f"[phase 8] [train_codec] one step's launches {json.dumps(step_launches)}, expected from its "
            f"shapes {json.dumps(expected)} (forward only: the backward is the plain chains' VJPs)")
        if step_launches != expected:
            raise AssertionError("the codec trainer's step launched other kernels than its shapes give")
        codec_step_breakdown(trained, opt, (wav_b, lab_b, spk_b), n_q)
        # the kernels after optimizer steps read the live weights: each encoder
        # block's first unit and snake against their plain versions on them
        with torch.no_grad():
            for blk, t in zip(trained["enc"]["blocks"], (32000, 16000, 4000, 800)):
                c = blk["act"]["alpha"].numel()
                x = rnd(1, t, c)
                compare("residual_unit", residual_unit_cuda(x, blk["res"][0], 1),
                        residual_unit_reference(x, blk["res"][0], 1),
                        f"[phase 8] trained weights after {CODEC_STEPS + 1} steps (1, {t}, {c}) d=1")
        # dead-code revival once on the card's parameters
        n_rev = train_codec.revive_dead_codes(trained, wav_b.cpu().numpy(), np.random.RandomState(6))
        fin = all(bool(torch.isfinite(t).all()) for t in train_codec.leaves(trained))
        log(f"[phase 8] [train_codec] revive_dead_codes on the card's parameters: {n_rev} rows revived, "
            f"parameters finite {fin}")
        if not fin:
            raise AssertionError("dead-code revival left non-finite parameters")
        del res, trained, opt
        torch.cuda.empty_cache()
        elapsed("8.3 the codec trainer")

        # one deterministic step on the card and on the CPU, TF32 off: two
        # updates (the first at the schedule's lr 0) on a smaller batch, eps
        # 1e-4 in place of 1e-8 (a parameter whose gradient is rounding noise,
        # a bias before a norm, moves +-lr at 1e-8 with a sign that differs
        # between the devices)
        start = train_codec.init_params(torch.Generator().manual_seed(3), CODEC_SPEAKERS)
        batch = train_codec.make_batch(np.random.RandomState(7), *train_codec.load_corpus(corpus, set())[:3],
                                       2, 40)
        n_q_cpu = [extras.quantizer_counts(2, n, 0.5, torch.Generator().manual_seed(1)) for n in (1, 2, 3)]
        out = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            p = train_codec.tree_map(lambda t: t.clone().to(device).requires_grad_(), start)
            flat = train_codec.leaves(p)
            opt = train_codec.FiniteAdam(flat, train_codec.warmup_cosine_decay(2e-4, 10), eps=1e-4)
            args = [torch.as_tensor(a, device=device) for a in batch]
            m = train_codec.train_step(p, opt, *args, [n.to(device) for n in n_q_cpu], TRAIN_CODEC_WEIGHTS)
            total, _ = train_codec.loss_fn(p, *args, [n.to(device) for n in n_q_cpu], TRAIN_CODEC_WEIGHTS)
            grads = torch.autograd.grad(total, flat, allow_unused=True)
            g_norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads if g is not None])))
            opt.step([torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)])
            out[where] = ({k: float(v) for k, v in m.items() if k != "code_usage"}, g_norm,
                          [t.detach().cpu() for t in flat])
        (mg, ng, pg), (mc, nc, pc) = out["card"], out["cpu"]
        loss_rel = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc)
        norm_rel = abs(ng - nc) / nc
        paths = list(flatten_pytree(params_to_jax(start)))
        excess = {k: (a - b).abs() - (1e-5 + 1e-4 * b.abs()) for k, a, b in zip(paths, pg, pc)}
        worst = max(float(e.max()) for e in excess.values())
        # a ReLU input of a transformer's conv FFN within rounding of 0 takes the
        # other branch on one device and moves the update of the one output
        # channel it belongs to: the only place a parameter may lie outside
        outside = {k: e for k, e in excess.items() if float(e.max()) > 0.0}
        channels = {(k.rsplit("/", 1)[0], int(c)) for k, e in outside.items()
                    for c in torch.nonzero(e > 0)[:, 0]}
        ties_only = all(k.endswith(("/ffn1/w", "/ffn1/b")) for k in outside) and len(channels) <= 8
        moved = max(float((b - s).abs().max()) for b, s in zip(pc, train_codec.leaves(start)))
        log(f"[phase 8] [train_codec card vs CPU] one step, batch 2 x 40 frames, TF32 off: losses max rel "
            f"diff {loss_rel:.3e} (tol 1e-4), grad_norm {ng:.5f} vs {nc:.5f}, rel {norm_rel:.3e} (tol "
            f"1e-3); parameters after two updates: worst excess over 1e-5 abs + 1e-4 rel {worst:.3e} "
            f"(<= 0 passes), {sum(int((e > 0).sum()) for e in outside.values())} of "
            f"{sum(t.numel() for t in pc)} elements outside, in {sorted(outside)}: conv-FFN output "
            f"channels {sorted(channels)} (ReLU ties, at most 8 pass), largest move {moved:.3e}")
        if not (loss_rel <= 1e-4 and norm_rel <= 1e-3 and ties_only and moved > 1e-5):
            raise AssertionError("a codec-trainer step on the card disagrees with the same on the CPU")
        del out, pg, pc
        elapsed("8.3 card vs CPU step")

        # the saved codec through FaCodec.from_pretrained: prompt codes on the
        # card and on the CPU (TF32 off)
        prompt = prompt_wav(3.0, seed=8)
        codes_g, timbre_g = FaCodec.from_pretrained(out_dir, device=dev).encode_prompt(prompt)
        codes_c, timbre_c = FaCodec.from_pretrained(out_dir, device="cpu").encode_prompt(prompt)
        n_diff = int((codes_g != codes_c).sum())
        log(f"[phase 8] [train_codec] the saved codec through FaCodec.from_pretrained, a 3 s prompt: "
            f"{n_diff} of {codes_c.size} RVQ codes differ between the card and the CPU; timbre max abs "
            f"diff {float(np.abs(timbre_g - timbre_c).max()):.3e}")
        if codes_g.shape != (6, 240) or not np.isfinite(timbre_g).all():
            raise AssertionError("the trained codec did not analyse a prompt on the card")
        elapsed("8.3 the saved codec")

    # 8.4 the training decode with all three GRL heads at the reference's head
    # sizes (phone 5003, speaker 245200), random decoder from a seed
    g = torch.Generator().manual_seed(4)
    dec = train_codec.tree_map(lambda t: t.to(dev), train_codec.init_params(g, 3)["dec"])
    heads = train_codec.tree_map(lambda t: t.to(dev).requires_grad_(), extras.init_decoder_training_heads(
        g, use_gr_residual_f0=True, use_gr_residual_phone=True, use_gr_x_timbre=True))
    quantized = [rnd(2, 160, 256).requires_grad_() for _ in range(3)]
    spk = rnd(2, 256, scale=0.3)
    draw = torch.rand(2, generator=gen, device=dev)
    kernels.reset_launches()
    out = extras.decoder_training_forward(dec, heads, quantized, spk, draw, use_gr_residual_f0=True,
                                          use_gr_residual_phone=True, use_gr_x_timbre=True)
    loss = sum(v.float().pow(2).mean() for v in out.values())
    grads = torch.autograd.grad(loss, quantized + train_codec.leaves(heads))
    torch.cuda.synchronize()
    dec_launches = dict(kernels.launches)
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(x).all()) for x in grads)
    probe = quantized[2].detach().requires_grad_()
    g_grl, = torch.autograd.grad(extras.cnn_predictor(extras.gradient_reversal(probe),
                                                      heads["res_phone_predictor"])[0].sum(), probe)
    g_plain, = torch.autograd.grad(extras.cnn_predictor(probe, heads["res_phone_predictor"])[0].sum(), probe)
    sign_err = float((g_grl + g_plain).abs().max()) / float(g_plain.abs().max())
    log(f"[phase 8] [training decode] outputs {({k: tuple(v.shape) for k, v in out.items()})}; forward and "
        f"backward finite {finite}; launches {json.dumps(dec_launches)}; the residual phone probe's "
        f"gradient through the GRL plus its gradient without: max abs {sign_err:.3e} of the gradient's "
        f"largest (tol {GRAD_TOL:g}: negated)")
    # K1: five heads' snakes + five of the synthesis; K2: five heads' three
    # units + twelve of the synthesis
    if (not finite or out["audio"].shape != (2, 160 * 200, 1) or not sign_err <= GRAD_TOL
            or dec_launches != {"snake_filtered": 10, "residual_unit": 27, "residual_stack": 0}):
        raise AssertionError("the training decode failed on the card")
    del dec, heads, out, grads, quantized
    torch.cuda.empty_cache()
    elapsed("8.4 the training decode")

    # 8.5 voice conversion with random weights (seed): V2 and the redecoder,
    # each a 3 s source and a 3 s prompt -> wav, on the card and the CPU
    g = torch.Generator().manual_seed(5)
    v2_enc, v2_dec = init_encoder_params(g), extras.init_decoder_v2_params(g)
    # the redecoder at its reference width (1280): units of 640 channels (K2's
    # dilated conv in two passes in fp32) and of 80 (zero-padded to 96)
    redec = extras.init_redecoder_params(g, upsample_initial_channel=REDECODER_WIDTH)
    src, tgt = prompt_wav(3.0, seed=10), prompt_wav(3.0, seed=11) * 0.8
    codec = FaCodec.from_pretrained(CODEC_DIR, device=dev)
    cpu_codec = FaCodec.from_pretrained(CODEC_DIR, device="cpu")
    with torch.no_grad():
        vc = {}
        for where, device, cd in (("card", dev, codec), ("cpu", torch.device("cpu"), cpu_codec)):
            e, d = (train_codec.tree_map(lambda t: t.to(device), tr) for tr in (v2_enc, v2_dec))
            s_t = torch.as_tensor(src, device=device)[None, :, None]
            lat = extras.encoder_v2_forward(e, s_t)
            feat = extras.encoder_v2_prosody_feature(s_t[:, :, 0])[:, :, : lat.shape[1]]
            vc[where] = (extras.decoder_v2_quantize(d, lat, feat)[0].cpu().numpy(), cd.encode_prompt(src)[0])
        e, d, r = (train_codec.tree_map(lambda t: t.to(dev), tr) for tr in (v2_enc, v2_dec, redec))
        s_t, t_t = (torch.as_tensor(w, device=dev)[None, :, None] for w in (src, tgt))
        kernels.reset_launches()
        v2_wav = extras.v2_voice_conversion(e, d, s_t, t_t).cpu().numpy()
        v2_launches = dict(kernels.launches)
        tgt_timbre = torch.as_tensor(codec.encode_prompt(tgt)[1][None], device=dev)
        kernels.reset_launches()
        re_wav = extras.redecoder_forward(r, torch.as_tensor(vc["card"][1][:, None, :], device=dev),
                                          tgt_timbre).cpu().numpy()
        re_launches = dict(kernels.launches)
    (c2g, scg), (c2c, scc) = vc["card"], vc["cpu"]
    log(f"[phase 8] [voice conversion] V2 (random weights, seed 5), a 3 s source and a 3 s target: wav "
        f"{v2_wav.shape}, finite {bool(np.isfinite(v2_wav).all())}, launches {json.dumps(v2_launches)}; "
        f"{int((c2g != c2c).sum())} of {c2c.size} of the source's V2 codes differ between the card and "
        f"the CPU (TF32 off)")
    log(f"[phase 8] [voice conversion] redecoder (random weights) on codec_r5's codes of the source and "
        f"the target's timbre: wav {re_wav.shape}, finite {bool(np.isfinite(re_wav).all())}, launches "
        f"{json.dumps(re_launches)}; {int((scg != scc).sum())} of {scc.size} of the source's codes differ "
        f"between the card and the CPU")
    re_calls = synth_calls(r["synth"], vc["card"][1].shape[1])
    if (v2_wav.shape != (1, 48000, 1) or re_wav.shape != (1, 48000, 1) or not np.isfinite(v2_wav).all()
            or not np.isfinite(re_wav).all() or re_launches != launch_counts(re_calls)
            or sorted({(t, c) for k, t, c, *_ in re_calls if k == "residual_unit"})
            != sorted(REDECODER_K2_SHAPES)):
        raise AssertionError("voice conversion did not give a finite 3 s wav on the card, or the "
                             f"redecoder's launches {re_launches} are not those of its shapes")
    elapsed("8.5 voice conversion")
    calls = codec_train_calls(train_codec.tree_map(lambda t: t.detach(), params), CODEC_BATCH, CODEC_CROP * 200)
    return {"codec_train": {"calls": calls, "launches": step_launches, "backward": backward},
            "redecoder": {"calls": re_calls, "launches": re_launches}}


def eval_phase(kernels, codec, dev) -> dict:
    """Phase 9, evaluation (see the module docstring).  ``codec`` is path
    A's fp32 codec.  The tools run under PyTorch's own TF32 switches, every
    comparison with TF32 off.  Returns, for the kernels line, {"eval":
    {"calls", "launches"}}: the kernel calls of the longest utterance's round
    trip and the launches of one round trip in the dump_decoded run."""
    import tempfile

    from flamed_tts_tpu_torch import (asr, dump_decoded, eval_discrimination, evaluate,
                                      fabricate_corpus, train_asr)
    from flamed_tts_tpu_torch.config import load_default_config
    from flamed_tts_tpu_torch.convert import params_to_jax
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
    from flamed_tts_tpu_torch.models.flamed import Flamed
    from flamed_tts_tpu_torch.runtime.pytree_io import flatten_pytree
    from flamed_tts_tpu_torch.train_codec import FiniteAdam, cosine_schedule, leaves, tree_map
    from flamed_tts_tpu_torch.utils.audio import load_wav

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    wav_tol = 1e-5 + 1.0 / 32767  # phase 4's

    def elapsed(step):
        log(f"[phase 9] {step} done at {time.perf_counter() - t_phase:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        # 9.1 the corpus
        corpus, decoded = os.path.join(tmp, "corpus"), os.path.join(tmp, "decoded")
        t0 = time.perf_counter()
        durations = fabricate_corpus.fabricate(corpus, n=EVAL_UTTERANCES, seed=0, n_speakers=EVAL_SPEAKERS,
                                               dur_max=EVAL_DUR_MAX)
        items = eval_discrimination.read_corpus(corpus)
        by_spk = {}
        for wav_path, text, spk in items:
            by_spk.setdefault(spk, []).append((wav_path, text))
        log(f"[phase 9] [fabricate] {len(durations)} utterances by {len(by_spk)} speakers "
            f"({sorted(len(v) for v in by_spk.values())} each), {sum(durations):.1f} s of audio "
            f"({min(durations):.2f}-{max(durations):.2f} s) in {time.perf_counter() - t0:.1f} s on the host")
        elapsed("9.1 fabricate")

        # 9.2 dump_decoded on the card (codec_r5, fp32), as a user runs it
        kernels.reset_launches()
        with tf32(*DEFAULT_TF32):
            setting = tf32_label()
            stats = dump_decoded.main(["--corpus", corpus, "--codec-dir", CODEC_DIR, "--out-dir", decoded])
            torch.cuda.synchronize()
        dump_launches = dict(kernels.launches)
        n = EVAL_UTTERANCES
        per_utt = {k: v / n for k, v in dump_launches.items()}
        log(f"[phase 9] [dump_decoded] {setting}; {stats['decoded']} round trips, {stats['audio_s']:.1f} s of "
            f"audio in {stats['seconds']:.2f} s: {stats['decoded'] / stats['seconds']:.2f} utterances/s, "
            f"{stats['audio_s'] / stats['seconds']:.1f} audio-s/s (host clock, wav files read and "
            f"written); launches {json.dumps(dump_launches)}, per utterance {json.dumps(per_utt)}")
        if stats["decoded"] != n or per_utt != {"snake_filtered": 10, "residual_unit": 24, "residual_stack": 0}:
            raise AssertionError(f"dump_decoded: {stats}, launches {dump_launches}: expected K1 10, K2 24 a "
                                 "round trip")
        # one short utterance's round trip, card (TF32 off) against the CPU
        cpu_codec = FaCodec.from_pretrained(CODEC_DIR, device="cpu")
        shortest = int(np.argmin(durations))
        wav = load_wav(os.path.join(corpus, f"utt{shortest:05d}.wav"))[:32000]
        kernels.reset_launches()
        rt_g = codec.round_trip(wav)
        torch.cuda.synchronize()
        rt_launches = dict(kernels.launches)
        rt_c = cpu_codec.round_trip(wav)
        codes_g, codes_c = codec.encode_prompt(wav)[0], cpu_codec.encode_prompt(wav)[0]
        err = float(np.abs(rt_g - rt_c).max()) if rt_g.shape == rt_c.shape else math.inf
        n_diff = int((codes_g != codes_c).sum()) if codes_g.shape == codes_c.shape else -1
        log(f"[phase 9] [round trip card vs CPU] utterance {shortest} cut to {len(wav)} samples "
            f"({tf32_label()}; launches {json.dumps(rt_launches)}): {n_diff} of {codes_c.size} RVQ codes "
            f"differ; wav max abs diff {err:.3e} (tol {wav_tol:.3e}, phase 4's)")
        if n_diff != 0 or not err <= wav_tol or rt_launches != {"snake_filtered": 10, "residual_unit": 24,
                                                                 "residual_stack": 0}:
            raise AssertionError("the card's round trip disagrees with the CPU's")
        elapsed("9.2 dump_decoded")

        # 9.3 train_asr at the JAX tool's defaults on the clean and decoded audio
        asr_out = os.path.join(tmp, "asr.npz")
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with tf32(*DEFAULT_TF32):
            setting = tf32_label()
            res = train_asr.main(["--corpus", corpus, "--out", asr_out, "--train-on", "decoded",
                                  "--decoded-cache", decoded])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_ms = 1e3 * float(np.median(res["step_s"]))
        frames_s = float(np.median(res["step_frames"])) / float(np.median(res["step_s"]))
        log(f"[phase 9] [train_asr] {setting}; {len(res['step_s'])} steps of batch 16 x 512 frames "
            f"(256 x 8, 30 epochs) in {wall:.1f} s with the featurization and the closing WER; median step "
            f"{step_ms:.2f} ms (host clock, each ending in the optimizer's host read), {frames_s:.0f} "
            f"labelled frames/s; peak memory {torch.cuda.max_memory_allocated() / gib:.2f} GiB; launches "
            f"{json.dumps(dict(kernels.launches))}")
        log(f"[phase 9] [train_asr] epoch loss {[round(v, 4) for v in res['epoch_loss'][:3]]} ... "
            f"{[round(v, 4) for v in res['epoch_loss'][-3:]]}; valid frame accuracy "
            f"{[(e, round(a, 4)) for e, a in res['valid_acc']]} beside a silence-class share of "
            f"{res['valid_sil_share']:.4f} of the valid frames; speaker accuracy {res['spk_acc']}; "
            f"free-decoding WER on the valid utterances {res['wer']:.4f}")
        if (not np.isfinite(res["epoch_loss"]).all() or not res["epoch_loss"][-1] < res["epoch_loss"][0]
                or any(kernels.launches.values())):
            raise AssertionError("train_asr: the loss did not fall, or a hand kernel was launched")
        # one step from the same parameters and batch on the card (TF32 off)
        # and the CPU; eps 1e-4 in place of 1e-8, as in phase 6: Adam's first
        # step scales a gradient element within rounding of 0 to +-lr
        train_items = train_asr.load_corpus(corpus)[0][max(n // 10, 2):]
        mels, labels, spks = train_asr.featurize(train_items[:16], device=dev)
        params = asr.init_params(np.random.RandomState(0), n_speakers=len(by_spk))
        out = {}
        for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
            p = tree_map(lambda t: t.requires_grad_(), asr.to_tensors(params, device))
            opt = FiniteAdam(leaves(p), cosine_schedule(2e-3, 0, 5), eps=1e-4, weight_decay=1e-4)
            loss = train_asr.train_step(p, opt, *(torch.as_tensor(a[:16], device=device)
                                                   for a in (mels, labels, spks)))
            out[where] = (float(loss), asr.to_numpy(p))
        (lg, pg), (lc, pc) = out["card"], out["cpu"]
        worst, moved = 0.0, 0.0
        for a, b, start in zip(leaves(pg), leaves(pc), leaves(params)):
            worst = max(worst, float((np.abs(a - b) - (1e-5 + 1e-4 * np.abs(b))).max()))
            moved = max(moved, float(np.abs(b - start).max()))
        log(f"[phase 9] [train_asr card vs CPU] one step, batch 16 x 512 frames ({tf32_label()}): loss "
            f"{lg:.6f} vs {lc:.6f} (abs diff {abs(lg - lc):.3e}, tol 1e-4); parameters: worst excess over "
            f"1e-5 abs + 1e-4 rel {worst:.3e} (<= 0 passes), largest move {moved:.3e}")
        if not (abs(lg - lc) <= 1e-4 and worst <= 0.0 and moved > 1e-4):
            raise AssertionError("an ASR training step on the card disagrees with the same on the CPU")
        # where a warm step's time goes: five steps under torch.profiler
        p = tree_map(lambda t: t.requires_grad_(), asr.to_tensors(res["params"], dev))
        opt = train_asr.make_optimizer(p, 2e-3, 150)
        batch = [torch.as_tensor(a[:16], device=dev) for a in (mels, labels, spks)]
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with tf32(*DEFAULT_TF32):
            for _ in range(3):
                train_asr.train_step(p, opt, *batch)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for _ in range(5):
                    train_asr.train_step(p, opt, *batch)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / 5
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e3 / 5
        log(f"[phase 9] [train_asr breakdown] a profiled step {wall:.2f} ms: device busy {busy:.2f} ms "
            f"({100 * busy / wall:.1f} %), {sum(e.count for e in events) / 5:.0f} device kernels and copies")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"[phase 9] [train_asr breakdown]   {e.self_device_time_total / 5e3:8.3f} ms  "
                f"x{e.count // 5:<5d} {e.key[:90]}")
        elapsed("9.3 train_asr")

        # 9.4 the committed recognizer, card (TF32 off) against the CPU
        rec, rec_cpu = asr.PhonemeRecognizer(device=dev), asr.PhonemeRecognizer(device="cpu")
        dev_ms, host_ms, secs = [], [], []
        for u in range(3):
            wav = load_wav(items[u][0])
            lg, lc = rec.frame_logits(wav), rec_cpu.frame_logits(wav)
            excess = float((np.abs(lg - lc) - 2e-4 * (1 + np.abs(lc))).max())
            same = rec.transcribe(wav) == rec_cpu.transcribe(wav)
            log(f"[phase 9] [recognizer card vs CPU] utterance {u} ({len(wav) / 16000:.2f} s, {lc.shape[0]} "
                f"frames): logits max abs diff {float(np.abs(lg - lc).max()):.3e} (tol 2e-4 abs + rel), "
                f"phones and words {'equal' if same else 'DIFFER'}")
            if excess > 0 or not same:
                raise AssertionError("the recognizer on the card disagrees with the CPU")
            dev_ms.append(events_ms(lambda: asr.forward(rec.tensors, rec.mel(wav)), 10))
            t0 = time.perf_counter()
            rec.decode_words(lg)
            host_ms.append(1e3 * (time.perf_counter() - t0))
            secs.append(len(wav) / 16000)
        log(f"[phase 9] [recognizer] log-mel + trunk on the card {sum(dev_ms) / sum(secs):.3f} ms per second "
            f"of audio (CUDA events over 10 back-to-back calls, host launch cost included); Viterbi word "
            f"decode on the host {sum(host_ms) / sum(secs):.1f} ms per second of audio")
        elapsed("9.4 recognizer")

        # 9.5 evaluate: the round trips as the synthesized wavs, another
        # utterance of the speaker as the prompt, the clean wav as the reference
        meta, name = os.path.join(tmp, "meta.txt"), os.path.basename  # a round trip has its wav's name
        entries = []
        for spk in sorted(by_spk):
            lst = by_spk[spk]
            entries += [f"{name(lst[i][0])}|{name(lst[i + 1][0])}|{lst[i][1]}" for i in range(2)]
        with open(meta, "w", encoding="utf-8") as f:
            f.write("\n".join(entries[:EVAL_ENTRIES]) + "\n")
        kernels.reset_launches()
        t0 = time.perf_counter()
        with tf32(*DEFAULT_TF32), contextlib.redirect_stdout(sys.stderr):
            setting = tf32_label()
            report = evaluate.main(["--synth-dir", decoded, "--metadata-file", meta, "--prompt-dir", corpus,
                                    "--ref-dir", corpus, "--codec-dir", CODEC_DIR, "--asr-ckpt", "default"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_entry = {k: v / EVAL_ENTRIES for k, v in kernels.launches.items()}
        log(f"[phase 9] [evaluate] {json.dumps(report)}")
        log(f"[phase 9] [evaluate] {setting}; {EVAL_ENTRIES} entries in "
            f"{wall:.2f} s ({wall / EVAL_ENTRIES:.2f} s an entry with the codec's, the recognizer's and "
            f"the frontend's loading); launches per entry {json.dumps(per_entry)}")
        finite = all(report[k] is not None and np.isfinite(report[k]) for k in report)
        if (report["n_evaluated"] != EVAL_ENTRIES or not finite
                or per_entry != {"snake_filtered": 10, "residual_unit": 24, "residual_stack": 0}):
            raise AssertionError("evaluate: missing entries, a non-finite metric, or launches other than "
                                 "two encode_prompt calls an entry")
        elapsed("9.5 evaluate")

        # 9.6 eval_discrimination stage 1: codec_r5 and the committed recognizer
        kernels.reset_launches()
        with tf32(*DEFAULT_TF32), contextlib.redirect_stdout(sys.stderr):
            disc = eval_discrimination.main(["--corpus", corpus, "--codec-dir", CODEC_DIR])
            torch.cuda.synchronize()
        n_wavs = sum(min(len(v), max(2, 48 // len(by_spk))) for v in by_spk.values())
        s1 = disc["stage1"]
        log(f"[phase 9] [stage 1] " + "; ".join(
            f"{k} same {s1[k]['same_mean']} diff {s1[k]['diff_mean']} margin {s1[k]['margin']:+.4f} rank_acc "
            f"{s1[k]['rank_acc']}" for k in ("codec_timbre", "melstats", "asr_spk"))
            + f" ({s1['codec_timbre']['n_same_pairs']} / {s1['codec_timbre']['n_diff_pairs']} pairs); "
            f"launches {json.dumps(kernels.launches)} for {n_wavs} 3 s crops")
        if (set(s1) != {"codec_timbre", "melstats", "asr_spk", "n_speakers"}
                or kernels.launches != {"snake_filtered": 5 * n_wavs, "residual_unit": 12 * n_wavs,
                                        "residual_stack": 0}):
            raise AssertionError("stage 1: an embedder is missing, or launches other than one "
                                 "encode_prompt a crop")
        wav = eval_discrimination.trim_to_speech(load_wav(items[0][0]))
        t_err = float(np.abs(codec.encode_prompt(wav)[1] - cpu_codec.encode_prompt(wav)[1]).max())
        a_err = float(np.abs(rec.speaker_embedding(wav) - rec_cpu.speaker_embedding(wav)).max())
        log(f"[phase 9] [stage 1 card vs CPU] a 3 s crop ({tf32_label()}): codec timbre max abs diff "
            f"{t_err:.3e}, ASR speaker embedding {a_err:.3e} (tol 1e-4)")
        if not (t_err <= 1e-4 and a_err <= 1e-4):
            raise AssertionError("a stage-1 embedding on the card disagrees with the CPU's")
        elapsed("9.6 stage 1")

        # 9.7 stage 2 with random full-width prior/prob weights (seed 0) as .npz
        model = Flamed(load_default_config(), device="cpu")
        ckpt = os.path.join(tmp, "flamed.npz")
        np.savez(ckpt, **flatten_pytree({"prior": params_to_jax(model.prior.state_dict()),
                                         "prob": params_to_jax(model.prob.state_dict())}))
        del model
        kernels.reset_launches()
        t0 = time.perf_counter()
        out, err = sys.stdout, sys.stderr  # the items' lines into the log, the JSON line out of it
        with tf32(*DEFAULT_TF32), contextlib.redirect_stderr(out), contextlib.redirect_stdout(err):
            disc = eval_discrimination.main(["--corpus", corpus, "--codec-dir", CODEC_DIR, "--ckpt", ckpt,
                                             "--cfg", os.path.join(ROOT, "configs"), "--n-utts", "16",
                                             "--nsteps", "32", "--n-synth", "4"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s2 = disc["stage2"]
        keys = ("dur_s", "margin_codec", "margin_mel", "margin_asr", "wer")
        finite = len(s2["items"]) == 4 and all(np.isfinite(r[k]) for r in s2["items"] for k in keys)
        log(f"[phase 9] [stage 2] random full-width weights, nfe 32: "
            f"{json.dumps({k: v for k, v in s2.items() if k != 'items'})}; rows finite {finite}; "
            f"{wall:.1f} s with stage 1 over 16 crops and the model's loading; launches "
            f"{json.dumps(kernels.launches)} (each item: the prompt's encoder and the decoder in the "
            f"sample, three encode_prompt calls in the scoring)")
        if not finite:
            raise AssertionError("stage 2: a row is missing or not finite")
        elapsed("9.7 stage 2")

        # the kernels' shapes: the longest utterance's round trip (the
        # encoder over its padded seconds, the decoder over their frames)
        padded = len(codec.pad_prompt_wav(np.zeros(int(round(max(durations) * 16000)), np.float32))[0])
        calls = encoder_calls(codec, padded) + decoder_calls(codec, padded // codec.hop)
    return {"eval": {"calls": calls, "launches": {k: int(v) for k, v in per_utt.items()}}}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _g2p_card_vs_cpu(dev) -> None:
    """Two updates of train_g2p (the second at lr / 2: the schedule warms up
    over 2 of 20 steps) from the same parameters on the same 256 words and
    dropout masks, on the card and on the CPU, TF32 off."""
    from flamed_tts_tpu_torch import train_g2p
    from flamed_tts_tpu_torch.text import neural_g2p as g2p

    train_lex = train_g2p.build_dataset()[0]
    src, tgt = train_g2p.to_arrays(sorted(train_lex.items())[:512])
    params = train_g2p.init_params(np.random.RandomState(0))
    params["pos"] = g2p.sinusoid_table(max(g2p.MAX_SRC, g2p.MAX_TGT), g2p.D_MODEL)
    rng = np.random.RandomState(1)
    shapes = ([(256, g2p.MAX_SRC, g2p.D_MODEL)] * (2 * g2p.N_ENC)
              + [(256, g2p.MAX_TGT - 1, g2p.D_MODEL)] * (3 * g2p.N_DEC))
    masks = [[rng.rand(*sh) >= 0.15 for sh in shapes] for _ in range(2)]
    out = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        p = train_g2p.tree_map(lambda a: torch.from_numpy(a.copy()).to(device).requires_grad_(), params)
        opt = train_g2p.make_optimizer(p, 3e-4, 20)
        losses = [float(train_g2p.train_step(p, opt, torch.from_numpy(src[i * 256:(i + 1) * 256]).to(device),
                                             torch.from_numpy(tgt[i * 256:(i + 1) * 256]).to(device),
                                             [torch.from_numpy(m).to(device) for m in masks[i]], 0.15, 0.1))
                  for i in range(2)]
        out[where] = (losses, g2p.flatten(train_g2p.tree_map(lambda t: t.detach().cpu().numpy(), p)))
    (lg, pg), (lc, pc) = out["card"], out["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    worst = max(float((np.abs(pg[k] - pc[k]) - (1e-5 + 1e-4 * np.abs(pc[k]))).max()) for k in pc)
    moved = max(float(np.abs(pc[k] - v).max()) for k, v in g2p.flatten(params).items())
    log(f"[phase 10] [train_g2p card vs CPU] two updates, 256 words each ({tf32_label()}): losses "
        f"{[round(v, 6) for v in lg]} vs {[round(v, 6) for v in lc]}, max rel diff {loss_rel:.3e} (tol "
        f"1e-4); parameters' largest excess over 1e-5 abs + 1e-4 rel {worst:.3e} (<= 0 passes), "
        f"largest move {moved:.3e}")
    if not (loss_rel <= 1e-4 and worst <= 0.0 and moved > 1e-5):
        raise AssertionError("train_g2p's step on the card disagrees with the CPU's")


def components_phase(kernels, dev, bench: dict) -> None:
    """Phase 11, the component benchmark (see the module docstring).
    ``bench`` is phase 7's {"rtf", "throughput_rtf"}: a compute floor above
    the wall of the same bucket is a fault of the count or the timer."""
    from flamed_tts_tpu_torch import bench_components as bc

    t_phase = time.perf_counter()
    log(f"[phase 11] {nvidia_smi_line()}")
    runs = {}
    for label, argv in (("bf16", ["--which", "codec,pieces,prior,convforms,mfu", "--dtype", "bf16"]),
                        ("fp32", ["--which", "mfu", "--dtype", "fp32"]),
                        ("batch4", ["--which", "mfu", "--batch", "4", "--nfe", "128"])):
        res = runs[label] = bc.main(argv)  # prints its rows and its JSON line
        codec = res["codec"]
        for r in res["rows"]:
            if not (math.isfinite(r["ms"]) and r["ms"] > 0 and r["flop_pct"] <= 100 and r["hbm_pct"] <= 100):
                raise AssertionError(f"bench_components {label}: row {r['name']!r} reads {r['ms']} ms, "
                                     f"{r['flop_pct']} % / {r['hbm_pct']} % of the peaks")
            # the counter's hand-kernel calls are the launches the wrappers made
            if {k: v for k, v in r["launches"].items() if v} != r["kernel_calls"]:
                raise AssertionError(f"bench_components {label} {r['name']!r}: launches {r['launches']}, "
                                     f"counted {r['kernel_calls']}")
        expected = {"codec synthesize total": decoder_calls(codec, bc.L)}
        for i, (t, ci, co, s) in enumerate(bc._block_shapes(codec, bc.L)):
            blk = codec.dec_params["blocks"][i]
            expected[f"block{i} C{ci}->{co} L{t} stride{s}"] = (
                [("snake_filtered", t, ci, 0, blk["act"], None)]
                + [("residual_unit", t * s, co, d, u, None) for u, d in zip(blk["res"], (1, 3, 9))])
            expected[f"block{i} L{t} C{ci}: snake"] = [("snake_filtered", t, ci, 0, blk["act"], None)]
            expected[f"block{i} L{t} C{ci}: res x3"] = [("residual_unit", t * s, co, d, u, None)
                                                        for u, d in zip(blk["res"], (1, 3, 9))]
        expected[f"codec decode ({bc.L}f -> {bc.L * codec.hop / codec.sr:.1f}s wav)"] = decoder_calls(codec, bc.L)
        expected[f"prompt encode ({bc.PROMPT_FRAMES * codec.hop / codec.sr:g} s wav)"] = encoder_calls(
            codec, bc.PROMPT_FRAMES * codec.hop)
        checked = 0
        for r in res["rows"]:
            want = launch_counts(expected.get(r["name"], []))
            if r["launches"] != want:
                raise AssertionError(f"bench_components {label} {r['name']!r}: launches {r['launches']}, "
                                     f"expected from its shapes {want}")
            checked += r["name"] in expected
        for r in res["rows"]:
            if r["section"] == "convforms" and not r["max_abs_err"] <= CONVFORM_BF16_STEPS * 2.0 ** -7 * r["out_max_abs"]:
                raise AssertionError(f"bench_components convforms {r['name']!r}: max abs err "
                                     f"{r['max_abs_err']:.3e} at an output peak of {r['out_max_abs']:.3f}")
        log(f"[phase 11] [{label}] {len(res['rows'])} rows finite, under both peaks, the counted hand-kernel "
            f"calls equal to the launches; {checked} rows' K1 / K2 launches held to their shapes")
    conv = [r for r in runs["bf16"]["rows"] if r["section"] == "convforms"]
    log(f"[phase 11] [convforms] bf16 max abs err {max(r['max_abs_err'] for r in conv):.3e}, at most "
        f"{max(r['max_abs_err'] / r['out_max_abs'] for r in conv) / 2.0 ** -7:.2f} bf16 steps of the output "
        f"peak (tol {CONVFORM_BF16_STEPS}: both forms round one float32 sum a sample, in another order)")

    # the codec rows counted on the CPU (float32, the plain versions) equal
    # the card's count of the same rows (float32 run)
    from flamed_tts_tpu_torch.config import load_default_config

    cpu = torch.device("cpu")
    with torch.no_grad():
        cfg = load_default_config()
        stages, _ = bc.mfu_stages(bc.make_model(cfg, torch.float32, cpu), bc.make_codec(cfg, torch.float32, cpu),
                                  torch.float32, 1, 64, cpu)
        on_cpu = {st.name: bc.Bench(cpu, torch.float32).count(st) for st in stages[2:4]}
    card = {r["name"]: r for r in runs["fp32"]["rows"]}
    for name, c in on_cpu.items():
        r = card[name]
        log(f"[phase 11] [count] {name}: card {r['flops']} FLOP, {r['bytes']} bytes, {r['kernel_calls']}; "
            f"CPU {c['flops']} FLOP, {c['bytes']} bytes, {c['kernel_calls']}")
        if (r["flops"], r["bytes"], r["kernel_calls"]) != (c["flops"], c["bytes"], c["kernel_calls"]):
            raise AssertionError(f"bench_components: {name} counts otherwise on the card than on the CPU")

    for label, wall, what in (("bf16", bench["rtf"], "bench (phase 7, B = 1, nfe 64, bucket 768)"),
                              ("batch4", bench["throughput_rtf"], "bench_throughput (phase 7, B = 4, nfe 128)")):
        total = runs[label]["total"]
        log(f"[phase 11] [floor] {label}: compute floor RTF {total['rtf_compute_floor']:.5f} "
            f"({total['compute_ms']:.1f} device ms for {total['audio_s']:.1f} s), {total['gflop']:.1f} GFLOP, "
            f"mfu_whole_call {total['mfu_whole_call']:.3f} %; {what} RTF {wall}")
        if not total["rtf_compute_floor"] <= wall:
            raise AssertionError(f"the compute floor ({label}) reads above the wall RTF of {what}")
    log(f"[phase 11] done in {time.perf_counter() - t_phase:.1f} s")


def parallel_phase(kernels, codec, model, dev, work: str) -> dict:
    """Phase 10 (see the module docstring): the trainer under torchrun on a
    1 x 1 mesh against the same step without one, ``sample_batch`` on a
    1 x 1 mesh against no mesh, the native WAV codec, ``train_g2p``,
    ``expand_lexicon`` and ``lexicon_coverage``.  ``model`` and ``codec``
    are path A's (fp32, one K2 launch a unit); ``work`` holds phase 6's
    corpus and configs.  Returns, for the kernels line, {"mesh": the mesh
    call's calls and launches}."""
    import hashlib
    import io

    from scipy.io import wavfile

    from flamed_tts_tpu_torch import expand_lexicon, lexicon_coverage, train_g2p
    from flamed_tts_tpu_torch.config import load_yaml, save_yaml
    from flamed_tts_tpu_torch.data.dataset import batch_iterator
    from flamed_tts_tpu_torch.models.flamed import Flamed
    from flamed_tts_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from flamed_tts_tpu_torch.train.step import batch_to_device, init_train_state, train_step
    from flamed_tts_tpu_torch.text import neural_g2p as g2p
    from flamed_tts_tpu_torch.train import cli as train_cli
    from flamed_tts_tpu_torch.utils import native_audio

    t_phase = time.perf_counter()

    def elapsed(step):
        log(f"[phase 10] {step} done at {time.perf_counter() - t_phase:.1f} s")

    # 10.1 the trainer under torchrun on a 1 x 1 mesh (NCCL), 3 steps on
    # phase 6's precomputed corpus, against its first step without a mesh;
    # both under PyTorch's own TF32 switches, the data order fixed (seed 0)
    cfg_dir = os.path.join(work, "configs10")
    for name in ("prior", "prob", "codec", "optimizer", "data"):
        part = load_yaml(os.path.join(work, "configs", f"{name}.yaml"))
        if name == "data":
            part["seed"] = 0
        save_yaml(part, os.path.join(cfg_dir, f"{name}.yaml"))
    common = ["--config-dir", cfg_dir, "--log-every", "1", "--val-every", "1000", "--device", dev.type]
    exp_mesh = os.path.join(work, "exp_mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
           "-m", "flamed_tts_tpu_torch.train", "--devices", "1,1", "--exp-dir", exp_mesh,
           "--max-steps", "3", *common]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun trainer failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    mesh_line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("Mesh:"))
    # the same first step without a mesh, as the CLI makes it (datasets, the
    # collator's first batch, the model and the state from seed 0), without
    # the CLI's checkpoint writes
    cfg = train_cli.load_training_config(cfg_dir)
    trainset, _ = train_cli.make_datasets(cfg["dataset_cfg"])
    collator = train_cli.make_collator(cfg["dataset_cfg"], 0)
    first = next(batch_iterator(trainset, collator, int(cfg["dataset_cfg"]["batch_size"]), shuffle=True,
                                seed=0))
    one = Flamed(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    state = init_train_state(one.prior, one.prob, cfg["optimizer_cfg"], 0)
    with tf32(*DEFAULT_TF32):
        setting = tf32_label()
        first_one = {k: float(v) for k, v in train_step(state, batch_to_device(first, dev)).items()}
    del one, state
    torch.cuda.empty_cache()
    with open(os.path.join(exp_mesh, "metrics.jsonl"), encoding="utf-8") as fin:
        rec_mesh = [json.loads(x) for x in fin]
    first_mesh = next(r for r in rec_mesh if r["step"] == 1 and "total_loss" in r)
    loss_rel = abs(first_mesh["total_loss"] - first_one["total_loss"]) / abs(first_one["total_loss"])
    norm_rel = abs(first_mesh["grad_norm"] - first_one["grad_norm"]) / abs(first_one["grad_norm"])
    losses = [r["total_loss"] for r in rec_mesh if "total_loss" in r]
    rates = [r["steps_per_sec"] for r in rec_mesh if "steps_per_sec" in r]
    batch = load_yaml(os.path.join(cfg_dir, "data.yaml"))["batch_size"]
    log(f"[phase 10] [train torchrun] {mesh_line.strip()!r}; {' '.join(cmd[2:])} ({setting}): 3 steps "
        f"at batch {batch} in {wall:.1f} s with start-up, total_loss {[round(v, 4) for v in losses]}, "
        f"steps/s after the first {[round(v, 2) for v in rates]}; step 1 against the same step "
        f"without a mesh: total_loss {first_mesh['total_loss']:.6f} vs {first_one['total_loss']:.6f}, "
        f"gap {loss_rel:.3e} (tol 1e-4), grad_norm {first_mesh['grad_norm']:.4f} vs "
        f"{first_one['grad_norm']:.4f}, gap {norm_rel:.3e} (tol 1e-3: phase 6's)")
    if not (len(losses) == 3 and np.isfinite(losses).all() and loss_rel <= 1e-4 and norm_rel <= 1e-3
            and os.path.isfile(os.path.join(exp_mesh, "checkpoints", "last.npz"))):
        raise AssertionError("the trainer on a 1 x 1 mesh disagrees with one process")
    elapsed("10.1 the trainer under torchrun")

    # 10.2 sample_batch on a 1 x 1 mesh (NCCL, this process): a batch of 3
    # with prompt wavs (the encoder per rank: K1, K2), against the same call
    # without a mesh; TF32 off
    device = init_distributed(dev.type, f"tcp://127.0.0.1:{_free_port()}", 1, 0)
    mesh = make_mesh(1, 1, dev.type)
    ids = np.zeros((3, 60), np.int64)
    src_lens = np.array([60, 47, 33], np.int64)
    for i, n in enumerate(src_lens):
        ids[i, :n] = PHONEMES[:n]
    pads = [codec.pad_prompt_wav(prompt_wav(s, seed=20 + i)) for i, s in enumerate((3.0, 2.5, 2.0))]
    width = max(len(w) for w, _ in pads)
    wavs = np.stack([np.pad(w, (0, width - len(w))) for w, _ in pads])
    frames = np.array([f for _, f in pads], np.int64)
    outs = {}
    for where, m in (("none", None), ("mesh", mesh)):
        model.sampler._ratio_history.clear()  # both take a first call's speculative bucket
        kernels.reset_launches()
        outs[where] = model.sample_batch(phonemes=ids, src_lens=src_lens, prompt_wav=wavs,
                                         prompt_frames=frames, codec=codec, seed=3, nsteps_durgen=32,
                                         nsteps_denoiser=32, mesh=m)
        torch.cuda.synchronize()
        outs[where]["launches"] = dict(kernels.launches)
    torch.distributed.destroy_process_group()
    a, b = outs["mesh"], outs["none"]
    wav_tol = 1e-5 + 1.0 / 32767  # phase 4's
    wav_err = float(np.abs(a["wav"] - b["wav"]).max()) if a["wav"].shape == b["wav"].shape else math.inf
    codes_equal = torch.equal(a["prior_logits"].argmax(-1), b["prior_logits"].argmax(-1))
    calls = [(*c, 3) for c in main_path_calls(codec, width, a["frame_bucket"])]
    expected = launch_counts(calls)
    log(f"[phase 10] [sample_batch mesh 1x1] {device}: batch 3, src_lens {src_lens.tolist()}, prompts "
        f"of {frames.tolist()} frames: tgt_len {a['tgt_len'].tolist()} vs {b['tgt_len'].tolist()} "
        f"without a mesh, frame bucket {a['frame_bucket']} vs {b['frame_bucket']}, the prior's codes "
        f"{'equal' if codes_equal else 'DIFFER'}, wav {a['wav'].shape} max abs diff {wav_err:.3e} (tol "
        f"{wav_tol:.3e}, phase 4's); launches {json.dumps(a['launches'])} (expected from its shapes "
        f"{json.dumps(expected)}), without a mesh {json.dumps(b['launches'])}")
    if (not np.array_equal(a["tgt_len"], b["tgt_len"]) or not np.array_equal(a["tgt_mask"], b["tgt_mask"])
            or a["frame_bucket"] != b["frame_bucket"] or not codes_equal or not wav_err <= wav_tol
            or not np.isfinite(a["wav"]).all() or a["launches"] != expected
            or a["launches"]["residual_unit"] == 0 or a["launches"]["snake_filtered"] == 0):
        raise AssertionError("sample_batch on a 1 x 1 mesh disagrees with the call without one")
    elapsed("10.2 sample_batch on a mesh")

    # 10.3 the native WAV codec (g++ at first use) on phase 6's corpus
    # against scipy: decode, and encode byte for byte
    t0 = time.perf_counter()
    if native_audio.library() is None:
        raise AssertionError(f"the native WAV codec did not build: {native_audio.build_error}")
    build_s = time.perf_counter() - t0
    corpus = os.path.join(work, "corpus")
    paths = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(corpus) for f in fs if f.endswith(".wav"))[:8]
    n_samples, same = 0, True
    for path in paths:
        with open(path, "rb") as fin:
            raw = fin.read()
        wav, sr = native_audio.decode_wav(raw)
        ref_sr, data = wavfile.read(path)
        same &= sr == ref_sr and data.dtype == np.int16 and np.array_equal(wav, (data / 32768.0).astype(np.float32))
        buf = io.BytesIO()
        wavfile.write(buf, sr, (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16))
        same &= native_audio.encode_wav(wav, sr) == buf.getvalue()
        n_samples += len(wav)
    log(f"[wavio] {native_audio.library_path()} built in {build_s:.2f} s (g++); {len(paths)} of phase "
        f"6's files ({n_samples} samples): decoded {'equal to' if same else 'UNLIKE'} scipy's, "
        f"re-encoded byte for byte {'equal to' if same else 'UNLIKE'} scipy's 16-bit PCM")
    if not same or not paths:
        raise AssertionError("the native WAV codec disagrees with scipy")
    elapsed("10.3 native audio")

    # 10.4 train_g2p at the tool's widths and batch (256), cut from 120
    # epochs to G2P_EPOCHS; one step on the card against the CPU
    out = os.path.join(work, "g2p", "g2p_weights.npz")
    with tf32(*DEFAULT_TF32):
        setting = tf32_label()
        res = train_g2p.main(["--out", out, "--epochs", str(G2P_EPOCHS), "--device", dev.type])
    words = {w: g2p.NeuralG2P(out)(w) for w in ("okonkwo", "reykjavik", "quinoa")}
    log(f"[phase 10] [train_g2p] {setting}; {G2P_EPOCHS} of the tool's 120 epochs at batch 256 "
        f"({res['steps']} steps): median step {res['step_ms']:.2f} ms, last epoch's loss "
        f"{res['loss']:.4f}; held-out PER (stress) {res['heldout_per']:.4f}, proper nouns "
        f"{res['gold_per']:.4f}; {json.dumps(words)}")
    if not (np.isfinite(res["loss"]) and 0.0 <= res["heldout_per"] <= 1.5):
        raise AssertionError("train_g2p did not train on the card")
    _g2p_card_vs_cpu(dev)
    elapsed("10.4 train_g2p")

    # 10.5 the lexicon tools: their outputs against this repository's CPU
    # run of them (tests/test_torch_g2p_tools.py holds the same outputs to
    # the JAX tools')
    lex = os.path.join(work, "english-expanded.txt")
    expand_lexicon.main(["--out", lex])
    with open(lex, "rb") as fin:
        lex_sha = hashlib.sha256(fin.read()).hexdigest()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lexicon_coverage.main([])
    cov_sha = hashlib.sha256(buf.getvalue().strip().encode()).hexdigest()
    log(f"[phase 10] [lexicon tools] expand_lexicon sha256 {lex_sha} "
        f"({'equal to' if lex_sha == EXPANDED_LEXICON_SHA256 else 'UNLIKE'} the CPU's); "
        f"lexicon_coverage {buf.getvalue().strip()[:120]}... sha256 {cov_sha} "
        f"({'equal to' if cov_sha == COVERAGE_LINE_SHA256 else 'UNLIKE'} the CPU's)")
    if lex_sha != EXPANDED_LEXICON_SHA256 or cov_sha != COVERAGE_LINE_SHA256:
        raise AssertionError("the lexicon tools' outputs differ from the CPU's")
    elapsed("10.5 lexicon tools")
    return {"mesh": {"calls": calls, "launches": a["launches"]}}


def train_step_breakdown(state, on_card, batch) -> None:
    """Where a warm training step's time goes: forward, backward and the
    AdamW update timed apart on the host clock (each ends in a
    synchronize); the matmul and conv FLOPs of a step
    (torch.utils.flop_counter) over its wall; the device's busy share and
    top kernels from torch.profiler over one step."""
    from torch.utils.flop_counter import FlopCounterMode

    from flamed_tts_tpu_torch.precision import get_matmul_precision
    from flamed_tts_tpu_torch.train.losses import compute_losses
    from flamed_tts_tpu_torch.train.step import train_step

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0)

    state.optimizer.zero_grad(set_to_none=True)
    losses, fwd_ms = timed(lambda: compute_losses(state.prior, state.prob, on_card, state.generator))
    _, bwd_ms = timed(lambda: losses["total_loss"].backward())
    _, opt_ms = timed(state.optimizer.step)
    with FlopCounterMode(display=False, custom_mapping=costs.FLOP_FORMULAS) as counter:
        train_step(state, on_card)
    flops = counter.get_total_flops()
    _, wall = timed(lambda: train_step(state, on_card))
    precision = get_matmul_precision()
    dtype = torch.bfloat16 if precision == "default" else torch.float32
    share = 100 * flops / wall / 1e9 / (costs.device_peaks().flop_per_s(dtype) / 1e12)
    log(f"[train breakdown] batch {batch['phonemes'].shape[0]}, frames {batch['codes'].shape[-1]}, phonemes "
        f"{batch['phonemes'].shape[-1]}, prompt {batch['prompts'].shape[-1]}: forward {fwd_ms:.1f} ms, "
        f"backward {bwd_ms:.1f} ms, AdamW {opt_ms:.1f} ms; a step {wall:.1f} ms (matmul precision "
        f"{precision}, {tf32_label()}), {flops / 1e12:.2f} TFLOP of matmuls and convs, "
        f"{flops / wall / 1e9:.1f} TFLOP/s ({share:.2f} % of the {DTYPE_NAMES[dtype]} peak)")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(lambda: train_step(state, on_card))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    core_gemm = sum(e.self_device_time_total for e in events if CUDA_CORE_GEMM.search(e.key)) / 1e3
    log(f"[train breakdown] profiled step {wall:.1f} ms: device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f} %), {sum(e.count for e in events)} device kernels/copies; "
        f"{core_gemm:.2f} ms in GEMM kernels off the tensor cores")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[train breakdown]   {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")


def precision_check(label: str, model, codec, ids: np.ndarray, wav_in: np.ndarray, dev) -> dict:
    """One utterance of a cast model (bf16 storage) through the staged
    path's two stages at "default" and at "highest" with the same noise:
    the durations that differ between the two first stages, then both
    second stages on the "highest" durations (each on its own first
    stage's encoder output): the latents' relative error and the decoded
    wavs' mel-L2.  Then the two stages alone (no codec) profiled at
    "default": no GEMM kernel off the tensor cores may run.  Prints the prior's and
    the prob's parameter bytes beside float32 storage's."""
    from flamed_tts_tpu_torch.ops.melspec import mel_spectrogram
    from flamed_tts_tpu_torch.precision import bf16_on_cpu, matmul_precision
    from flamed_tts_tpu_torch.runtime.buckets import pick_bucket

    sampler = model.sampler
    codes, timbre = codec.encode_prompt(wav_in)
    l_in, p_in = ids.shape[1], codes.shape[-1]
    l_bucket = pick_bucket(l_in, sampler.phoneme_buckets)
    p_bucket = pick_bucket(p_in, sampler.prompt_buckets)
    phonemes = np.zeros((1, l_bucket), np.int64)
    phonemes[:, :l_in] = ids
    prompts = np.full((1, codes.shape[0], p_bucket), model.vocab_size, np.int64)
    prompts[0, :, :min(p_in, p_bucket)] = codes[:, :p_bucket]
    on = {k: torch.as_tensor(v, device=dev) for k, v in (
        ("phonemes", phonemes), ("src_lens", np.array([l_in])), ("prompts", prompts),
        ("prompt_lens", np.array([min(p_in, p_bucket)])), ("timbres", timbre[None].astype(np.float32)))}
    rng = np.random.RandomState(21)
    noise = {"dur": rng.randn(1, l_bucket).astype(np.float32), "sil": rng.randn(1, l_bucket).astype(np.float32)}

    def stage1(name):
        with matmul_precision(name):
            return sampler._stage1(on["phonemes"], on["src_lens"], noise, None, 64, 0.3)

    def stage2(name, first, f_bucket, with_codec=True):
        with matmul_precision(name):
            return sampler._stage2(first[0], durs[0], durs[1], on["src_lens"], on["prompts"],
                                   on["prompt_lens"], f_bucket, on["timbres"], noise, None, 64, 0.3,
                                   codec if with_codec else None)

    first = {name: stage1(name) for name in ("highest", "default")}
    durs = first["highest"][1:3]
    valid = slice(0, l_in)
    flips = [int((first["highest"][i][0, valid] != first["default"][i][0, valid]).sum()) for i in (1, 2)]
    tgt = [int(first[k][3][0]) for k in ("highest", "default")]
    f_bucket = pick_bucket(tgt[0], sampler.frame_buckets)
    noise["latents"] = rng.randn(1, f_bucket, 256).astype(np.float32)
    second = {name: stage2(name, first[name], f_bucket) for name in ("highest", "default")}
    n = int(second["highest"][3][0])
    lat = {k: v[0][0, :n].float().cpu().numpy() for k, v in second.items()}
    rel = float(np.linalg.norm(lat["default"] - lat["highest"]) / np.linalg.norm(lat["highest"]))
    wav = {k: v[5][:, :n * codec.hop, 0].float().cpu() / 32767.0 for k, v in second.items()}
    mel = {k: mel_spectrogram(w).numpy() for k, w in wav.items()}
    mel_l2 = float(np.sqrt(((mel["default"] - mel["highest"]) ** 2).sum(axis=1)).mean())
    finite = all(np.isfinite(x).all() for x in (*lat.values(), *mel.values()))

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        stage2("default", stage1("default"), f_bucket, with_codec=False)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    core_gemm = [e.key for e in events if CUDA_CORE_GEMM.search(e.key)]
    gemm_ms = sum(e.self_device_time_total for e in events if "gemm" in e.key.lower() or "nvjet" in e.key)
    params = [p for m in (model.prior, model.prob) for p in m.parameters()]
    n_bytes, n_params = sum(p.numel() * p.element_size() for p in params), sum(p.numel() for p in params)
    log(f"[precision {label}] bf16 \"default\" against \"highest\", the same noise ({l_in} phonemes, "
        f"nfe 64 + 64): {flips[0]} phone and {flips[1]} silence durations of {l_in} differ, tgt_len "
        f"{tgt[1]} vs {tgt[0]}; on the \"highest\" durations (tgt_len {n}, bucket {f_bucket}): latents "
        f"rel L2 {rel:.3e} (tol {LATENT_REL_TOL}), codec mel-L2 of the decoded wavs {mel_l2:.4f} "
        f"(tol {MEL_L2_TOL})")
    log(f"[precision {label}] the prior and denoiser stages at \"default\" (profiled, no codec): "
        f"{sum(e.count for e in events)} device kernels/copies, {gemm_ms / 1e3:.2f} ms in GEMM kernels, "
        f"GEMM kernels off the tensor cores {core_gemm or 'none'}; top: " + "; ".join(
            f"{e.self_device_time_total / 1e3:.2f} ms x{e.count} {e.key[:60]}"
            for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]))
    log(f"[precision {label}] prior + prob parameters on the card: {n_bytes / 1e6:.1f} MB "
        f"({', '.join(sorted({str(p.dtype) for p in params}))}; "
        f"{n_params / 1e6:.1f} M parameters), {4 * n_params / 1e6:.1f} MB in float32 storage")
    if not (finite and rel < LATENT_REL_TOL and mel_l2 < MEL_L2_TOL and not core_gemm
            and n_bytes == 2 * n_params):
        raise AssertionError(f"precision {label}: latents rel {rel}, mel-L2 {mel_l2}, finite {finite}, "
                             f"GEMM kernels off the tensor cores {core_gemm}, {n_bytes} parameter bytes")
    return {"flips": flips, "latent_rel": rel, "mel_l2": mel_l2, "param_bytes": n_bytes}


def breakdown(label: str, model, codec, wav_in, sample_kwargs: dict) -> None:
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
    ids = (np.asarray(sample_kwargs["phonemes"])[None] if "phonemes" in sample_kwargs
           else model._get_frontend()(sample_kwargs["text"])[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    res, sample_ms = timed(lambda: model.sampler.sample(
        ids, np.array([ids.shape[1]]), codes[None].astype(np.int64), np.array([codes.shape[-1]]),
        timbre[None], model.device, vocab_pad=model.vocab_size, generator=gen,
        fused=sample_kwargs.get("fused", True)))
    _, dec_ms = timed(lambda: codec.decode(res["latents"], torch.as_tensor(timbre[None], device="cuda")))
    log(f"[breakdown {label}] encode_prompt {enc_ms:.1f} ms; prior + denoiser (64 + 64 Euler steps) "
        f"{sample_ms:.1f} ms; codec decode {dec_ms:.1f} ms ({res['frame_bucket']} frames)")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(lambda: model.sample(prompt_raw=wav_in, codec=codec, seed=0, **sample_kwargs))
    # device-side events only (the CPU ops that launch them carry the same time)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    n_launch = sum(e.count for e in events)
    log(f"[breakdown {label}] profiled call {wall:.1f} ms: device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f} %), {n_launch} device kernels/copies")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[breakdown {label}]   {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<6d} {e.key[:90]}")


def drive(label: str, model, codec, wav_in, sample_kwargs: dict, kernels) -> dict:
    """One counted call of a main path, its checks, and five warm calls."""
    kernels.reset_launches()
    out = model.sample(prompt_raw=wav_in, codec=codec, nsteps_durgen=64, nsteps_denoiser=64,
                       seed=0, **sample_kwargs)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    tgt_len, f_bucket = int(out["tgt_len"][0]), int(out["frame_bucket"])
    wav = out["wav"]
    log(f"[main {label}] prompt {len(wav_in)} samples; tgt_len {tgt_len} frames, frame bucket "
        f"{f_bucket}; wav {wav.shape[0]} samples, rms {np.sqrt(np.mean(wav ** 2)):.4f}, "
        f"finite {bool(np.isfinite(wav).all())}")
    log(f"[main {label}] kernel launches in the main-path call: {json.dumps(launches)}")
    calls = main_path_calls(codec, len(codec.pad_prompt_wav(wav_in)[0]), f_bucket)
    expected = {k: sum(1 for c in calls if c[0] == k) for k in launches}
    if launches != expected:
        raise AssertionError(f"path {label}: launches {launches}, expected {expected}")
    if wav.shape != (tgt_len * codec.hop,) or not np.isfinite(wav).all() or tgt_len <= 0:
        raise AssertionError(f"path {label}: output is not a finite wav of tgt_len * hop samples")

    # warm calls: the host clock varies from call to call on a shared host,
    # so take five and report each and their median
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        out2 = model.sample(prompt_raw=wav_in, codec=codec, nsteps_durgen=64, nsteps_denoiser=64,
                            seed=0, **sample_kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - w0)
        if not np.array_equal(out2["tgt_len"], out["tgt_len"]):
            raise AssertionError("a warm call sampled another length from the same seed")
    wall = float(np.median(walls))
    audio_s = tgt_len * codec.hop / 16000
    log(f"[main {label}] warm calls: wall {', '.join(f'{1e3 * w:.1f}' for w in walls)} ms (host "
        f"clock, each ends in synchronize); median {wall * 1e3:.1f} ms; audio {audio_s:.2f} s; "
        f"median RTF {wall / audio_s:.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return {"launches": launches, "calls": calls, "f_bucket": f_bucket}


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
    from flamed_tts_tpu_torch.ops.resunit import (pick_tile, prepare_unit, residual_stack_cuda,
                                                  residual_stack_reference, residual_unit_cuda,
                                                  residual_unit_reference, stack_smem_bytes,
                                                  stack_tile, unit_smem_bytes)
    from flamed_tts_tpu_torch.ops.snake import snake_filtered_cuda
    from flamed_tts_tpu_torch.precision import bf16_on_cpu, matmul_precision

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
    counts = tensor_core_counts(kernels)
    for fn, n in counts.items():
        log(f"[sass] {fn}: {n} HMMA/HGMMA instructions")
    # K2 and K3 each in fp32 ("If" in the mangled name) and bf16
    if (sum("bfloat16" in fn for fn in counts) < 2 or sum("If" in fn for fn in counts) < 2
            or any(n == 0 for n in counts.values())):
        raise AssertionError("every residual kernel, fp32 and bf16, must hold tensor-core "
                             "instructions")

    codec = FaCodec.from_pretrained(CODEC_DIR, device=dev)            # path A: fp32, K2 per unit
    codec_b = FaCodec.from_pretrained(CODEC_DIR, device=dev, fuse_blocks=True)
    codec_b.cast_inference_params()                                    # path B: bf16, K3 blocks
    codecs = {torch.float32: codec, torch.bfloat16: codec_b}
    rng = np.random.RandomState(0)

    def rand(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev).to(dtype)

    def snake_args(c, dtype=torch.float32):
        cd = codecs[dtype]
        for blk in cd.enc_params["blocks"] + cd.dec_params["blocks"]:
            if blk["act"]["alpha"].numel() == c:
                return blk["act"]
        return {"alpha": rand(c) * 0.3, "beta": rand(c) * 0.3}

    def stack_args(c, dtype=torch.float32):
        """Three units of width c: the trained codec's where it has the
        width, else random ones."""
        cd = codecs[dtype]
        for blk in cd.enc_params["blocks"] + cd.dec_params["blocks"]:
            if blk["res"][0]["act1"]["alpha"].numel() == c:
                return blk["res"]
        scale = 1.0 / math.sqrt(7 * c)
        return [{"act1": {"alpha": rand(c) * 0.3, "beta": rand(c) * 0.3},
                 "act2": {"alpha": rand(c) * 0.3, "beta": rand(c) * 0.3},
                 "conv1": {"w": rand(c, c, 7, dtype=dtype) * scale, "b": rand(c, dtype=dtype) * 0.1},
                 "conv2": {"w": rand(c, c, 1, dtype=dtype) * scale, "b": rand(c, dtype=dtype) * 0.1}}
                for _ in range(3)]

    # 2. kernels against their plain versions
    max_err = {}

    def compare(name, out, ref, label, path=None):
        """The kernel's output against its plain version's; the largest
        error is kept per (kernel, io type, path) for the kernels line."""
        dtype = out.dtype
        out, ref = out.float(), ref.float()
        diff = (out - ref).abs()
        err = float(diff.max())
        if dtype == torch.bfloat16:
            steps = float((diff / (2.0 ** -7 * torch.maximum(ref.abs(), ref.abs().mean()))).max())
            share = float((diff > 0).float().mean())
            ok = steps <= BF16_STEPS
            how = f"{steps:.2f} bf16 steps, {100 * share:.2f} % of elements differ (tol {BF16_STEPS} steps)"
        else:
            ok = bool(torch.all(diff <= TOL + TOL * ref.abs()))
            how = f"max_rel_err {err / max(float(ref.abs().max()), 1e-30):.3e} (tol {TOL} abs + {TOL} rel)"
        key = (name, DTYPE_NAMES[dtype], path)
        max_err[key] = max(max_err.get(key, 0.0), err)
        log(f"[check] {name} {DTYPE_NAMES[dtype]} {label}: max_abs_err {err:.3e}, {how} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")

    def three_units(x, units, prepared=(None, None, None)):
        for p, w, d in zip(units, prepared, (1, 3, 9)):
            x = residual_unit_cuda(x, p, d, w)
        return x

    for dtype in (torch.float32, torch.bfloat16):
        for t, c in [(80000, 64), (2000, 512), (48000, 32), (1, 64), (2, 64), (5, 64), (20, 64)]:
            x, a = rand(1, t, c, dtype=dtype), snake_args(c, dtype)
            compare("snake_filtered", snake_filtered_cuda(x, a["alpha"], a["beta"]),
                    snake_filtered_reference(x, a["alpha"], a["beta"]), f"(1, {t}, {c})")
        for t, c in [(48000, 32), (2000, 512), (80000, 64), (30, 64)]:
            for p, d in zip(stack_args(c, dtype), (1, 3, 9)):
                x = rand(1, t, c, dtype=dtype)
                compare("residual_unit", residual_unit_cuda(x, p, d), residual_unit_reference(x, p, d),
                        f"(1, {t}, {c}) d={d}")
        # K3 at every (C, dtype) stack_tile admits, at edge shapes (shorter
        # than the stack's halo of 75 rows, around twice it, a non-multiple
        # of the tile) and at main-path lengths
        smem_fn = kernels.library("residual_stack").residual_stack_smem_bytes
        for c in (32, 64, 128, 256, 512):
            tile = stack_tile(c, dtype)
            if tile is None:
                continue
            item = 2 if dtype == torch.bfloat16 else 4
            if smem_fn(c, tile, 1, 3, 9, item) != stack_smem_bytes(c, tile, item):
                raise AssertionError("stack_smem_bytes disagrees with residual_stack.cu")
            units = stack_args(c, dtype)
            for t in (1, 30, 149, 151, 3 * tile + 17, 24000):
                x = rand(1, t, c, dtype=dtype)
                out = residual_stack_cuda(x, units)
                compare("residual_stack", out, residual_stack_reference(x, units),
                        f"(1, {t}, {c}) tile={tile}")
                if not torch.equal(out, three_units(x, units)):
                    raise AssertionError(f"residual_stack (1, {t}, {c}) {dtype} is not bit for bit "
                                         "three residual_unit launches")
            log(f"[check] residual_stack {DTYPE_NAMES[dtype]} C={c} tile={tile}: equal to three "
                f"residual_unit launches bit for bit at T = 1, 30, 149, 151, {3 * tile + 17}, 24000")
    # K2 and K3 where the last mma tile of 16 rows is ragged
    unit_fn = kernels.library("residual_unit").residual_unit_smem_bytes
    for dtype in (torch.float32, torch.bfloat16):
        item = 2 if dtype == torch.bfloat16 else 4
        for c in (32, 96, 512):
            units = stack_args(c, dtype)
            for d in (1, 3, 9):
                tile = pick_tile(333, c, d, item)
                if unit_fn(c, d, tile, item) != unit_smem_bytes(c, d, tile, item):
                    raise AssertionError("unit_smem_bytes disagrees with residual_unit.cu")
            for t in MMA_PADDING_T:
                x = rand(1, t, c, dtype=dtype)
                chain = x
                for p, d in zip(units, (1, 3, 9)):
                    out = residual_unit_cuda(chain, p, d)
                    compare("residual_unit", out, residual_unit_reference(chain, p, d),
                            f"(1, {t}, {c}) d={d} tile={pick_tile(t, c, d, item)}")
                    chain = out
                if stack_tile(c, dtype) is not None:
                    out = residual_stack_cuda(x, units)
                    compare("residual_stack", out, residual_stack_reference(x, units), f"(1, {t}, {c})")
                    if not torch.equal(out, chain):
                        raise AssertionError(f"residual_stack (1, {t}, {c}) {dtype} is not bit for bit "
                                             "three residual_unit launches")
    log(f"[check] residual_unit / residual_stack fp32 and bf16 at T = {MMA_PADDING_T}, C = 32, 96, 512: "
        f"within tolerance, K3 equal to three K2 launches bit for bit where stack_tile admits the "
        f"width (fp32: C = 32; bf16: C = 32, 96)")
    # K2 at the redecoder's widths (upsample_initial_channel 1280) for a 3 s
    # source: C = 640 (fp32: the dilated conv in two passes over the input
    # channels), 320, 160 and 80 (zero-padded to 96 for the launch), with the
    # same bits from another tile that fits
    from flamed_tts_tpu_torch.ops import resunit

    for dtype in (torch.float32, torch.bfloat16):
        item = 2 if dtype == torch.bfloat16 else 4
        for t, c in REDECODER_K2_SHAPES:
            cw = resunit.kernel_width(c)
            for p, d in zip(stack_args(c, dtype), (1, 3, 9)):
                tile = pick_tile(t, cw, d, item)
                if unit_fn(cw, d, tile, item) != unit_smem_bytes(cw, d, tile, item):
                    raise AssertionError("unit_smem_bytes disagrees with residual_unit.cu")
                x = rand(1, t, c, dtype=dtype)
                out = residual_unit_cuda(x, p, d)
                compare("residual_unit", out, residual_unit_reference(x, p, d),
                        f"redecoder (1, {t}, {c}) d={d} tile={tile} passes={resunit.unit_passes(cw, item)}")
                other = 4 if tile != 4 else 20
                pick = resunit.pick_tile
                resunit.pick_tile = lambda *a: other
                try:
                    same = torch.equal(out, residual_unit_cuda(x, p, d))
                finally:
                    resunit.pick_tile = pick
                if not same:
                    raise AssertionError(f"residual_unit (1, {t}, {c}) d={d} {dtype}: another tile "
                                         "gave other bits")
    log(f"[check] residual_unit fp32 and bf16 at the redecoder's shapes {REDECODER_K2_SHAPES}, "
        f"d = 1, 3, 9: within tolerance, the same bits at tile 4 (or 20)")

    # the fp32 K2 (three TF32 products of split operands) and the fp32 plain
    # version (cuDNN, TF32 off) against the plain version in float64, at one
    # path A shape per width: does the split keep fp32's digits?
    def to_double(tree):
        if isinstance(tree, dict):
            return {k: to_double(v) for k, v in tree.items()}
        return tree.double()

    for t, c in [(48000, 32), (24000, 64), (6000, 128), (1200, 256), (1280, 512)]:
        x = rand(1, t, c)
        for p, d in zip(stack_args(c), (1, 3, 9)):
            exact = residual_unit_reference(x.double(), to_double(p), d)
            err_k = float((residual_unit_cuda(x, p, d).double() - exact).abs().max())
            err_p = float((residual_unit_reference(x, p, d).double() - exact).abs().max())
            log(f"[float64] residual_unit fp32 (1, {t}, {c}) d={d}: max abs error against the float64 "
                f"plain version: kernel {err_k:.3e}, fp32 plain version {err_p:.3e} "
                f"(output peak {float(exact.abs().max()):.3f})")
            if not err_k <= max(4 * err_p, 1e-5):
                raise AssertionError("the fp32 residual_unit kernel lost digits against float64")
    torch.cuda.synchronize()

    # 3. the main paths
    cfg = load_default_config()
    model = Flamed(cfg, device=dev)  # random weights from torch.Generator().manual_seed(0)
    model_b = Flamed(cfg, params={"prior": model.prior.state_dict(), "prob": model.prob.state_dict()},
                     device=dev)
    model_b.cast_inference_params()
    log(f"[main] Flamed: {model.num_params() / 1e6:.1f} M params (prior + prob), codec_r5 codec")
    wav_in = prompt_wav(3.0, seed=1)
    kwargs_a = {"phonemes": PHONEMES, "fused": False}
    kwargs_b = {"text": TEXT}
    log(f"[main B] text {TEXT!r}: {model_b._get_frontend()(TEXT)[0].shape[1]} phonemes")
    # path A is fp32 serving, at "highest" as the root scripts run fp32; path
    # B bf16 serving at the process's "default" (flamed_tts_tpu_torch/precision.py)
    with matmul_precision("highest"):
        run_a = drive("A", model, codec, wav_in, kwargs_a, kernels)
    run_b = drive("B", model_b, codec_b, wav_in, kwargs_b, kernels)
    for name in ("snake_filtered", "residual_unit"):
        if run_a["launches"][name] == 0:
            raise AssertionError(f"path A launched {name} no time")
    n_k3 = run_b["launches"]["residual_stack"]
    if not (run_b["launches"]["snake_filtered"] == 10 and n_k3 > 0
            and run_b["launches"]["residual_unit"] == 3 * (8 - n_k3)):
        raise AssertionError(f"path B launches {run_b['launches']}: expected K1 = 10, K3 > 0, "
                             "K2 = 3 * (8 - K3)")

    with matmul_precision("highest"):
        breakdown("A", model, codec, wav_in, kwargs_a)
    breakdown("B", model_b, codec_b, wav_in, kwargs_b)
    precision_check("B", model_b, codec_b, model_b._get_frontend()(TEXT)[0], wav_in, dev)

    # 4. a short utterance on the card against the same on the CPU, per path
    nrng = np.random.RandomState(5)
    short = dict(prompt_raw=prompt_wav(1.0, seed=2), nsteps_durgen=4, nsteps_denoiser=4)
    noise = {"dur": nrng.randn(1, 64).astype(np.float32), "sil": nrng.randn(1, 64).astype(np.float32),
             "latents": nrng.randn(1, 256, 256).astype(np.float32)}
    params = {"prior": model.prior.state_dict(), "prob": model.prob.state_dict()}
    cpu_model = Flamed(cfg, params=params, device="cpu")
    cpu_codec = FaCodec.from_pretrained(CODEC_DIR, device="cpu")
    with matmul_precision("highest"):
        g = model.sample(codec=codec, noise=noise, phonemes=PHONEMES[:10], fused=False, **short)
    c = cpu_model.sample(codec=cpu_codec, noise=noise, phonemes=PHONEMES[:10], fused=False, **short)
    err = float(np.abs(g["wav"] - c["wav"]).max()) if g["wav"].shape == c["wav"].shape else math.inf
    tol = 1e-5 + 1.0 / 32767
    # the prompt's RVQ codes are an argmax over the encoder's output: the one
    # discrete decision between the fp32 kernels and the wav
    codes_g, codes_c = codec.encode_prompt(short["prompt_raw"])[0], cpu_codec.encode_prompt(short["prompt_raw"])[0]
    log(f"[reference A] short utterance card vs CPU, \"highest\": tgt_len {g['tgt_len'][0]} vs {c['tgt_len'][0]}, "
        f"{int((codes_g != codes_c).sum())} of the prompt's {codes_g.size} RVQ codes differ, "
        f"wav max abs diff {err:.3e} (tol {tol:.3e}: fp32, cuBLAS/cuDNN and the kernels vs CPU "
        f"summation order, sin^2 and split-TF32 products, 1e-5, then one step of the int16 PCM either "
        f"side quantizes to)")
    if not np.array_equal(g["tgt_len"], c["tgt_len"]) or not err <= tol:
        raise AssertionError("the card's short utterance disagrees with the CPU run (path A)")

    cpu_model.cast_inference_params()
    cpu_codec.cast_inference_params()
    cpu_codec.fuse_blocks = True
    for m in (model_b, cpu_model):
        m.sampler._ratio_history.clear()  # both take a first call's speculative bucket
    # the card at "default" against the same arithmetic on the CPU (bf16
    # operands, float32 sums; only the order of the sums differs)
    g = model_b.sample(codec=codec_b, noise=noise, text="Good morning.", **short)
    with bf16_on_cpu():
        c = cpu_model.sample(codec=cpu_codec, noise=noise, text="Good morning.", **short)
    n = int(g["tgt_len"][0])
    lat_g, lat_c = g["latents"][0, :n].float().cpu().numpy(), c["latents"][0, :n].numpy()
    rel = float(np.linalg.norm(lat_g - lat_c) / np.linalg.norm(lat_c))
    # the decoder alone, on the card's latents: no discrete decision in between
    timbre = torch.from_numpy(nrng.randn(1, 256).astype(np.float32))
    wav_g = codec_b.decode(g["latents"], timbre.to(dev)).float().cpu().numpy()
    wav_c = cpu_codec.decode(g["latents"].cpu(), timbre).float().numpy()
    err, peak = float(np.abs(wav_g - wav_c).max()), float(np.abs(wav_c).max())
    log(f"[reference B] short bf16 utterance card vs CPU, both \"default\" arithmetic: tgt_len "
        f"{g['tgt_len'][0]} vs {c['tgt_len'][0]}, frame bucket {g['frame_bucket']} vs "
        f"{c['frame_bucket']}, latents rel L2 diff {rel:.3e} (tol 0.05: the bf16 prompt encoders on "
        f"the two devices round apart and may pick other RVQ codes for some frames, and a bf16 "
        f"operand near a rounding edge rounds apart in another sum order); bf16 decoder on the same latents: wav "
        f"max abs diff {err:.3e}, peak {peak:.3f} (tol 0.1 * peak, about 13 bf16 steps there: "
        f"bf16 activations through 27 rounding stages, where one flipped rounding spreads "
        f"through the next conv)")
    if (not np.array_equal(g["tgt_len"], c["tgt_len"]) or g["frame_bucket"] != c["frame_bucket"]
            or not rel <= 0.05 or not err <= 0.1 * peak or not np.isfinite(g["wav"]).all()):
        raise AssertionError("the card's short bf16 utterance disagrees with the CPU run (path B)")
    del cpu_model, cpu_codec

    # one forced overflow retry on path B: half a frame per phoneme cannot hold
    # an utterance (a phoneme takes one frame at least)
    ids = model_b._get_frontend()(TEXT)[0]
    padded, n_frames = codec_b.pad_prompt_wav(wav_in)
    sampler = model_b.sampler
    buckets = sampler.frame_buckets
    sampler.frame_buckets = [16] + buckets
    try:
        kernels.reset_launches()
        o = sampler.sample(ids, np.array([ids.shape[1]]), None, None, None, dev, codec=codec_b,
                           vocab_pad=model_b.vocab_size, nsteps_durgen=8, nsteps_denoiser=8,
                           generator=torch.Generator(device=dev).manual_seed(0), fused=True,
                           frames_per_phoneme_budget=0.5 * 16 / ids.shape[1],
                           prompt_wav=padded[None], prompt_frames=np.array([n_frames]))
    finally:
        sampler.frame_buckets = buckets
    tgt = int(o["tgt_len"][0])
    log(f"[overflow B] speculative bucket 16 frames, tgt_len {tgt}, answered from bucket "
        f"{o['frame_bucket']}; launches {json.dumps(kernels.launches)} (the prompt's encoder once, "
        f"the decoder twice)")
    if not (tgt > 16 and o["frame_bucket"] >= tgt and o["wav"].shape[1] == o["frame_bucket"] * 200
            and np.isfinite(o["wav"]).all() and kernels.launches["snake_filtered"] == 15):
        raise AssertionError("the forced overflow retry did not answer from a larger bucket")

    # 5. each main-path shape: the kernel against its plain version, then
    # both timed
    per, backward = {}, {}

    def time_path(path, calls, dtype):
        """Each call's shape once: the kernel against its plain version, then
        both timed; repeated shapes count their calls."""
        for name, t, ch, d, p, w, *batch in calls:
            b = batch[0] if batch else 1
            rows = per.setdefault((name, DTYPE_NAMES[dtype], path), {})
            if (b, t, ch, d) in rows:
                rows[(b, t, ch, d)]["calls"] += 1
                continue
            x = rand(b, t, ch, dtype=dtype)
            if name == "snake_filtered":
                run_k = lambda: snake_filtered_cuda(x, p["alpha"], p["beta"])
                plain = lambda: snake_filtered_reference(x, p["alpha"], p["beta"])
            elif name == "residual_unit":
                run_k = lambda: residual_unit_cuda(x, p, d, w)
                plain = lambda: residual_unit_reference(x, p, d)
            else:
                run_k = lambda: residual_stack_cuda(x, p, prepared=w)
                plain = lambda: residual_stack_reference(x, p)
            compare(name, run_k(), plain(), f"path {path} shape ({b}, {t}, {ch}) d={d}", path=path)
            work = b * t * ch * (1 + ch // 64) * (3 if name == "residual_stack" else 1)
            reps = max(3, min(50, int(2e8 // work)))
            k_ms, k_wall, p_ms = graph_ms(run_k, reps), events_ms(run_k, reps), events_ms(plain, reps)
            b_ms, b_by = bound_ms(name, b * t, ch, dtype)
            row = {**({"B": b} if batch else {}), "T": t, "C": ch, "d": d, "calls": 1, "ms": round(k_ms, 4),
                   "wall_ms": round(k_wall, 4), "plain_ms": round(p_ms, 4),
                   "bound_ms": round(b_ms, 5), "bound_by": b_by}
            extra = ""
            if name == "residual_stack":
                row["three_unit_ms"] = round(graph_ms(lambda: three_units(x, p, w), reps), 4)
                row["three_unit_wall_ms"] = round(events_ms(lambda: three_units(x, p, w), reps), 4)
                extra = (f", three residual_unit launches {row['three_unit_ms']:.4f} ms (graph) / "
                         f"{row['three_unit_wall_ms']:.4f} ms (per call)")
            before = FMA_LOOP_MS.get((DTYPE_NAMES[dtype], name, t, ch, d))
            if before is not None:
                extra += f"; its scalar-FMA predecessor read {before} ms (graph)"
            if (name, t, ch, d) in backward.get(path, {}):
                row["backward_ms"], row["plain_backward_ms"] = (round(v, 4) for v in backward[path][(name, t, ch, d)])
                extra += (f"; backward (Function) {row['backward_ms']:.4f} ms, autograd through the plain "
                          f"chain {row['plain_backward_ms']:.4f} ms")
            rows[(b, t, ch, d)] = row
            log(f"[time] path {path} {name} {DTYPE_NAMES[dtype]} ({b}, {t}, {ch}) d={d}: kernel "
                f"{k_ms:.4f} ms (graph) / {k_wall:.4f} ms (per call), plain {p_ms:.4f} ms (per call), "
                f"bound {b_ms:.5f} ms ({b_by}){extra}")

    for path, run, cd in (("A", run_a, codec), ("B", run_b, codec_b)):
        time_path(path, run["calls"], cd.dec_params["stem"]["w"].dtype)
    # K3 in fp32 is on neither main path (path A launches K2 per unit): its
    # time at the two encoder shapes stack_tile admits in fp32, beside three K2
    # launches, on log lines only
    for t, ch in [(48000, 32), (24000, 64)]:
        units, x = stack_args(ch), rand(1, t, ch)
        prepared = [prepare_unit(p) for p in units]
        compare("residual_stack", residual_stack_cuda(x, units, prepared=prepared),
                residual_stack_reference(x, units), f"off-path shape (1, {t}, {ch})")
        k3 = graph_ms(lambda: residual_stack_cuda(x, units, prepared=prepared), 20)
        k2 = graph_ms(lambda: three_units(x, units, prepared), 20)
        p_ms = events_ms(lambda: residual_stack_reference(x, units), 20)
        b_ms, b_by = bound_ms("residual_stack", t, ch, torch.float32)
        log(f"[time] off-path residual_stack fp32 (1, {t}, {ch}) tile={stack_tile(ch, torch.float32)}: "
            f"kernel {k3:.4f} ms (graph), three residual_unit launches {k2:.4f} ms (graph), plain "
            f"{p_ms:.4f} ms (per call), bound {b_ms:.5f} ms ({b_by})")

    # 6. the training path: precompute on the card, training at full width,
    # resume and serve; then its kernels at the shapes of one 17 s
    # utterance's analysis and of the trainer run's validation audio
    work = tempfile.mkdtemp(prefix="chip_smoke_")  # phase 6's corpus and configs, read again in phase 10
    runs = {"A": run_a, "B": run_b, **training_phase(kernels, compare, codec, dev, work)}
    for path in ("precompute", "validation"):
        time_path(path, runs[path]["calls"], torch.float32)

    # 7. the serving path's measurement and ingestion entry points; then its
    # kernels at the bench call's shapes (bf16, the random codec)
    runs.update(bench_phase(kernels, dev))
    time_path("bench", runs["bench"]["calls"], torch.bfloat16)

    # 8. codec training and voice conversion; then K1 and K2 at the codec
    # trainer's shapes, with the backward times of 8.2
    t8 = time.perf_counter()
    runs.update(codec_train_phase(kernels, compare, dev))
    backward["codec_train"] = runs["codec_train"]["backward"]
    time_path("codec_train", runs["codec_train"]["calls"], torch.float32)
    time_path("redecoder", runs["redecoder"]["calls"], torch.float32)
    log(f"[phase 8] done in {time.perf_counter() - t8:.1f} s (the timing of its shapes included)")

    # 9. evaluation; then K1 and K2 at the longest utterance's round trip
    t9 = time.perf_counter()
    runs.update(eval_phase(kernels, codec, dev))
    time_path("eval", runs["eval"]["calls"], torch.float32)
    log(f"[phase 9] done in {time.perf_counter() - t9:.1f} s (the timing of its shapes included)")

    # 10. data and tensor parallelism, the native WAV codec and the G2P
    # tools; then K1 and K2 at the mesh call's shapes
    t10 = time.perf_counter()
    runs.update(parallel_phase(kernels, codec, model, dev, work))
    time_path("mesh", runs["mesh"]["calls"], torch.float32)
    log(f"[phase 10] done in {time.perf_counter() - t10:.1f} s (the timing of its shapes included)")
    shutil.rmtree(work, ignore_errors=True)

    # 11. the component benchmark: per-stage device ms, FLOPs and bytes, the
    # compute floor beside phase 7's wall
    components_phase(kernels, dev, runs["bench"])

    notes = {"A": "one utterance's launches on path A", "B": "one utterance's launches on path B",
             "precompute": "one 17 s utterance's analysis in the precompute step (the encoder at "
                           "272000 samples)",
             "validation": "the trainer run's two validation-audio logs (steps 15 and 30: each "
                           "decodes one synthesized utterance at its frame bucket and its ground "
                           "truth at its length)",
             "bench": "one timed call of python -m flamed_tts_tpu_torch.bench (bf16, a random "
                      "codec, the pinned durations: the encoder over the 3 s prompt, the decoder "
                      "over the call's frame bucket)",
             "codec_train": "the forward launches of one step of python -m "
                            "flamed_tts_tpu_torch.train_codec (fp32, batch 8 crops of 160 frames: the "
                            "encoder over 32000 samples, the synthesis over 160 frames; backward_ms is "
                            "the Function's backward, the plain chain recomputed and its VJP, beside "
                            "plain_backward_ms, autograd's backward through the plain chain)",
             "eval": "one entry of the evaluation tools: a round trip of python -m "
                     "flamed_tts_tpu_torch.dump_decoded (codec_r5, fp32; launches per utterance), at "
                     "the shapes of the longest utterance's (the encoder over its 8 s bucket, the "
                     "decoder over the bucket's frames); an evaluate entry launches the same counts "
                     "(two encode_prompt calls)",
             "redecoder": "the FaCodec redecoder at its reference width (upsample_initial_channel "
                          "1280: K2 at C = 640, 320, 160 and 80) with random weights, synthesizing "
                          "a 3 s source's codes (240 frames), fp32, one K2 launch a unit",
             "mesh": "one Flamed.sample_batch call on a 1 x 1 mesh (NCCL): a batch of 3 with "
                     "prompt wavs, fused, fp32 (codec_r5, one K2 launch a unit; the encoder over "
                     "the padded prompts, the decoder over the frame bucket, B = 3)"}
    entries = []
    for (name, dtype_name, path), shapes in per.items():
        rows = list(shapes.values())
        tot = {k: sum(r[k] * r["calls"] for r in rows)
               for k in ("ms", "wall_ms", "plain_ms", "bound_ms")}
        back = {k: round(sum(r[k] * r["calls"] for r in rows), 4)
                for k in ("backward_ms", "plain_backward_ms") if all(k in r for r in rows)}
        by_ops = sum(r["bound_ms"] * r["calls"] for r in rows if r["bound_by"] == "operations")
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "dtype": dtype_name, "path": path,
            "launches": runs[path]["launches"][name], "max_abs_err": max_err[(name, dtype_name, path)],
            "ms": round(tot["ms"], 4), "plain_ms": round(tot["plain_ms"], 4),
            "bound_ms": round(tot["bound_ms"], 5),
            "wall_ms": round(tot["wall_ms"], 4),
            "bound_by": "operations" if by_ops * 2 >= tot["bound_ms"] else "bytes",
            "library_ms": None, **back,
            "note": f"sums over {notes[path]} at the shapes below; "
                    "ms is the wrapper's device time (CUDA graph replay), wall_ms and plain_ms "
                    "per-call CUDA-event time including the host's launch cost; library_ms is "
                    "null because no single PyTorch call computes the function (the nearest, "
                    "cuDNN convolutions, cover the convs only)",
            "shapes": rows,
        })
    log(json.dumps({"kernels": entries}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
