"""The yardstick's counts: each stage's matmul and conv operations from
``benchmark/costs.py`` equal ``torch.utils.flop_counter`` over the plain
reference at small widths, and the frozen ``kernel_cost`` equals the
program's."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import costs, weights
from benchmark.reference.codec import PlainCodec, stored
from benchmark.reference.flamed import PlainFlamed, mask_from_length
from benchmark.tests import tiny

CFG = {"prior_generator": tiny.PRIOR, "prob_generator": tiny.PROB}


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def model():
    from flamed_tts_tpu_torch.models.prior.prior_generator import PriorGenerator
    from flamed_tts_tpu_torch.models.prob.prob_generator import ProbGenerator

    with torch.device("meta"):
        shapes = {"prior": weights.shapes_of(PriorGenerator(tiny.PRIOR).state_dict()),
                  "prob": weights.shapes_of(ProbGenerator(tiny.PROB).state_dict())}
    state = weights.flamed_state(shapes, 3, "cpu", math.log(7.0), -1.0)
    return PlainFlamed(CFG, state["prior"], state["prob"])


@pytest.fixture(scope="module")
def codec():
    trees = weights.codec_tree(4, tiny.CODEC["encoder"], tiny.CODEC["decoder"], tiny.CODEC["timbre"])
    return PlainCodec(stored(trees["encoder"], None, "cpu"), stored(trees["decoder"], None, "cpu"))


@torch.no_grad()
def test_prior_stages(model):
    l, t, p, nfe = 13, 41, 17, 3
    ids = torch.randint(64, 148, (1, l))
    assert counted(lambda: model.encode(ids)) == costs.prior_encode(CFG, l)
    enc = model.encode(ids)
    noise = torch.randn(1, l)
    assert counted(lambda: model.pva_durations(enc, noise, noise, nfe, 0.3)) == costs.pva(CFG, l, nfe)
    lr = torch.randn(1, t, tiny.PRIOR["transformer"]["encoder_hidden"])
    prompt = torch.randint(0, 1024, (6, p))
    assert counted(lambda: model.decode(lr, prompt)) == costs.prior_decode(CFG, t, p)


@torch.no_grad()
def test_prob_stages(model):
    t, f, nfe = 29, 40, 3
    hiddens = torch.randn(1, 6, t, tiny.PROB["cond_dim"])
    pad = mask_from_length(t, t, "cpu")
    spk = torch.randn(1, 256)
    assert counted(lambda: model.condition(hiddens, pad)) == costs.prob_condition(CFG, t)
    assert counted(lambda: model.modulations(nfe, spk)) == costs.prob_modulations(CFG, nfe)
    mods = [m[0] for m in model.modulations(nfe, spk)]
    x = torch.randn(1, t, 256)
    assert counted(lambda: model.denoiser(x, mods, pad)) == costs.prob_step(CFG, t)
    assert costs.prob_step(CFG, f) > costs.prob_step(CFG, t)


@torch.no_grad()
def test_codec_stages(codec):
    c, samples = tiny.CODEC, 4000
    frames = samples // 200
    enc = costs.encoder_launches(samples, c["encoder"]["ngf"], c["encoder"]["up_ratios"])
    assert counted(lambda: codec.encode(torch.randn(1, samples, 1))) == (
        costs.codec_encode(c, samples) - costs.kernel_elementwise(enc))
    latents = codec.encode(torch.randn(1, samples, 1))
    assert counted(lambda: codec.analyze(latents, frames)) == costs.codec_analyze(c, frames)
    codes, timbre = codec.analyze(latents, frames)
    assert counted(lambda: codec.embed(codes)) == costs.codec_embed(c, frames)
    dec = costs.decoder_launches(frames, c["decoder"]["upsample_initial_channel"], c["decoder"]["up_ratios"])
    assert counted(lambda: codec.decode(codec.embed(codes), timbre)) == (
        costs.codec_embed(c, frames) + costs.codec_decode(c, frames) - costs.kernel_elementwise(dec))


def test_kernel_cost_is_the_programs():
    from flamed_tts_tpu_torch.ops import costs as program_costs

    for name in ("snake_filtered", "residual_unit", "residual_stack"):
        for rows in (1, 240, 48000, 128000):
            for c in (16, 32, 96, 256, 512, 640, 1024):
                for dtype, item in ((torch.float32, 4), (torch.bfloat16, 2)):
                    assert costs.kernel_cost(name, rows, c, item) == program_costs.kernel_cost(name, rows, c, dtype)


def test_peaks_are_the_data_sheets():
    p = costs.PEAKS["NVIDIA H100 80GB HBM3"]
    assert (p.bf16, p.tf32, p.fp32, p.bytes_per_s) == (989e12, 495e12, 67e12, 3.35e12)
