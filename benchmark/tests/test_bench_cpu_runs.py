"""Whole runs of each cell on the CPU at small widths (the look for a card
skipped), held against the plain reference: the sound program comes out
correct; its control and the faults a cell can have come out not correct.
And on a host without a card ``python -m benchmark.run`` fails and prints
no result."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control, run
from benchmark.harness import ROOT
from benchmark.tests import tiny

CELLS = ("flamed_serve_single", "facodec_roundtrip", "flamed_batch4_offline")


def one_run(workload, seed, extra=None):
    ov = control.merge(tiny.overrides(workload), extra or {})
    return run.run(["--workload", workload, "--seed", str(seed), "--seconds", "1", "--trace", "0"],
                   device="cpu", overrides=ov)


def test_without_a_card_the_run_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "flamed_serve_single",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_reports_no_cpu_number(workload):
    res = one_run(workload, 2**31 + 17)
    assert res["correct"], res["compared"]
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "compared" and res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    res = control.control_runs(workload, [23], 1, device="cpu", extra=tiny.overrides(workload))[0]
    assert not res["correct"], res["compared"]
    # each gap is the control's own: none reads as if it had been compared with itself
    assert all(c["value"] > 0 for k, c in res["compared"].items() if k != "length_mismatches"), res["compared"]


def _still_denoiser(monkeypatch):
    """Every Euler step of the denoiser returns its state unchanged."""
    from flamed_tts_tpu_torch.runtime import sampler

    def prob_sample(prob, hiddens, spk, pad_mask, noise, nfe, temperature):
        return noise.float() * temperature + prob.encode_condition(hiddens, pad_mask)

    monkeypatch.setattr(sampler, "prob_sample", prob_sample)


def _altered_latents(monkeypatch):
    """The latents altered where they are produced."""
    from flamed_tts_tpu_torch.runtime import sampler

    prob_sample = sampler.prob_sample
    monkeypatch.setattr(sampler, "prob_sample", lambda *a: 0.8 * prob_sample(*a))


def _altered_wav(monkeypatch):
    """The wav altered where it is produced."""
    from flamed_tts_tpu_torch.runtime import sampler

    pcm16 = sampler.pcm16
    monkeypatch.setattr(sampler, "pcm16", lambda wav: pcm16(0.5 * wav))


def _zeroed_prompt_timbre(monkeypatch):
    """The served call's prompt analysis gives a zero timbre."""
    from flamed_tts_tpu_torch.runtime.sampler import BucketedSampler

    analyze = BucketedSampler._analyze_prompt

    def zeroed(self, *args):
        prompts, lens, timbre = analyze(self, *args)
        return prompts, lens, 0.0 * timbre

    monkeypatch.setattr(BucketedSampler, "_analyze_prompt", zeroed)


def _zeroed_cache_timbre(monkeypatch):
    """The prompt cache holds zero timbres."""
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec

    encode = FaCodec.encode_prompt

    def zeroed(self, wav):
        codes, timbre = encode(self, wav)
        return codes, 0.0 * timbre

    monkeypatch.setattr(FaCodec, "encode_prompt", zeroed)


def _half_batch(monkeypatch):
    """Half of the batch left out: its rows repeat the first half's."""
    from flamed_tts_tpu_torch.runtime.sampler import BucketedSampler

    frames = BucketedSampler._frames

    def half(self, *args):
        out = list(frames(self, *args))
        h = out[0].shape[0] // 2
        for i in (0, 5):
            if out[i] is not None and h:
                out[i] = torch.cat([out[i][:h], out[i][:out[i].shape[0] - h]])
        return tuple(out)

    monkeypatch.setattr(BucketedSampler, "_frames", half)


def _still_codec_unit(monkeypatch):
    """Every residual unit of the codec returns its input unchanged."""
    from flamed_tts_tpu_torch.models.facodec import decoder, encoder

    for mod in (encoder, decoder):
        monkeypatch.setattr(mod, "residual_stack", lambda x, units, **kw: x)


def _altered_round_trip(monkeypatch):
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec

    rt = FaCodec.round_trip
    monkeypatch.setattr(FaCodec, "round_trip", lambda self, wav: 0.5 * rt(self, wav))


FAULTS = [
    ("flamed_serve_single", _still_denoiser), ("flamed_serve_single", _altered_latents),
    ("flamed_serve_single", _altered_wav), ("flamed_serve_single", _zeroed_prompt_timbre),
    ("flamed_batch4_offline", _still_denoiser), ("flamed_batch4_offline", _altered_latents),
    ("flamed_batch4_offline", _altered_wav), ("flamed_batch4_offline", _zeroed_cache_timbre),
    ("flamed_batch4_offline", _half_batch),
    ("facodec_roundtrip", _still_codec_unit), ("facodec_roundtrip", _altered_round_trip),
]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = one_run(workload, 31)
    assert not res["correct"], res["compared"]


def test_result_is_one_json_line():
    res = one_run("facodec_roundtrip", 5)
    assert json.loads(json.dumps(res)) == res
