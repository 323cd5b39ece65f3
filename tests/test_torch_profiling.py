"""The port's profiling and host-side entry points on the CPU: the
StageTimer against the JAX package's, the host spans and device stage marks
of ``Flamed.sample`` / ``sample_batch`` / ``FaCodec.round_trip``, ``trace`` and ``synthesize --profile-dir``, the training
summary against ``tools/summarize_training.py``, and
``synthesize_via_metadata``'s refusal without a metadata file."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from flamed_tts_tpu.utils import profiling as jprofiling

from flamed_tts_tpu_torch import bench, synthesize_via_metadata
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.utils import profiling
from flamed_tts_tpu_torch.utils.audio import save_wav

from torch_parity_utils import ROOT, prompt_wav, small_config, summaries_equal

SPANS = {"frontend", "prompt_prep", "input_place", "prompt_place", "fused_dispatch", "fused_get"}
STAGES = ("codec_encode", "durations", "prior_decode", "denoiser", "codec_decode")


def device_keys(timer):
    """The timer's device readings, in the order they were first read."""
    return [k for k in timer.totals if k.startswith("device")]


def narrow_config():
    cfg = small_config()
    cfg["codec_cfg"]["encoder"]["ngf"] = 4
    cfg["codec_cfg"]["decoder"]["upsample_initial_channel"] = 64
    return cfg


def test_stage_timer_summary_and_report_equal_jax():
    spans = [("fused_get", 0.123456), ("frontend", 0.0011), ("fused_get", 0.2), ("b", 0.00004)]
    timers = []
    for cls in (profiling.StageTimer, jprofiling.StageTimer):
        timer = cls()
        for name, seconds in spans:
            with timer.span(name):
                pass
            timer.totals[name] += seconds
        timers.append(timer)
    port, ref = timers
    assert set(port.summary()) == set(ref.summary()) == {"fused_get", "frontend", "b"}
    assert port.counts == ref.counts and port.counts["fused_get"] == 2
    # the spans' own (tiny, host-clock) times differ: compare the formatting
    # on equal totals
    port.totals.update(ref.totals)
    assert port.summary() == ref.summary()
    assert port.report() == ref.report()
    assert port.report().startswith("b: 0.0ms | frontend: 1.1ms | fused_get: 161.7ms")


@pytest.fixture(scope="module")
def small_model():
    cfg = narrow_config()
    model = Flamed(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    bench.pin_durations(model)  # ~6 frames a phoneme, so that a small bucket overflows
    codec = FaCodec.random_init(torch.Generator().manual_seed(0), device="cpu",
                                codec_cfg=cfg["codec_cfg"])
    return model, codec


def test_sample_records_the_six_spans_only_with_a_timer(small_model):
    model, codec = small_model

    def run():
        return model.sample(text="Good morning.", prompt_raw=prompt_wav(0.5), codec=codec,
                            nsteps_durgen=2, nsteps_denoiser=2, seed=0)

    assert profiling.SAMPLE_TIMER is None
    timer = profiling.StageTimer()
    profiling.SAMPLE_TIMER = timer
    try:
        with_timer = run()
    finally:
        profiling.SAMPLE_TIMER = None
    assert set(timer.summary()) - set(device_keys(timer)) == SPANS
    # each stage once, in the order the device ran them (eager on the CPU)
    assert device_keys(timer) == ["device." + s for s in STAGES]
    assert all(n == 1 for n in timer.counts.values())  # no overflow retry here
    assert all(v >= 0 for v in timer.totals.values())
    assert all(timer.totals[k] > 0 for k in device_keys(timer))
    # no timer installed: the old one records nothing more, no mark is
    # made, and the spans and marks change nothing
    counts = dict(timer.counts)
    made = []
    add = profiling.Marks.add
    profiling.Marks.add = lambda self, *a, **k: made.append(a) or add(self, *a, **k)
    try:
        without = run()
    finally:
        profiling.Marks.add = add
    assert timer.counts == counts and profiling.SAMPLE_TIMER is None and made == []
    np.testing.assert_array_equal(without["wav"], with_timer["wav"])


def test_overflow_retry_falls_under_the_same_spans(small_model):
    model, codec = small_model
    padded, n_frames = codec.pad_prompt_wav(prompt_wav(0.5))
    ids = model._get_frontend()("Good morning to you.")[0]
    timer = profiling.StageTimer()
    profiling.SAMPLE_TIMER = timer
    try:
        out = model.sampler.sample(ids, np.array([ids.shape[1]]), None, None, None, model.device,
                                   codec=codec, vocab_pad=model.vocab_size, nsteps_durgen=2,
                                   nsteps_denoiser=2, generator=torch.Generator().manual_seed(0),
                                   frames_per_phoneme_budget=0.01, prompt_wav=padded[None],
                                   prompt_frames=np.array([n_frames]))
    finally:
        profiling.SAMPLE_TIMER = None
    assert out["frame_bucket"] > model.sampler.frame_buckets[0]  # it overflowed the first
    assert timer.counts["fused_dispatch"] == timer.counts["fused_get"] == 2
    assert timer.counts["input_place"] == timer.counts["prompt_place"] == 1
    # the device ran the stages after the durations twice
    assert {k: timer.counts[k] for k in device_keys(timer)} == {
        "device.codec_encode": 1, "device.durations": 1, "device.prior_decode": 2,
        "device.denoiser": 2, "device.codec_decode": 2}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_sample_batch_records_the_stages_after_the_prompt(small_model, fused, monkeypatch):
    """Prompt codes and timbre given (no prompt analysis on the device):
    the fused and the staged path mark the same four stages, once each."""
    model, codec = small_model
    codes, timbre = codec.encode_prompt(prompt_wav(0.5))
    ids = model._get_frontend()("Good morning.")[0]
    timer = profiling.StageTimer()
    monkeypatch.setattr(profiling, "SAMPLE_TIMER", timer)
    model.sample_batch(ids, np.array([ids.shape[1]]), prompts=codes[None].astype(np.int64),
                       timbres=timbre[None], codec=codec, nsteps_durgen=2, nsteps_denoiser=2, seed=0,
                       fused=fused)
    assert device_keys(timer) == ["device." + s for s in STAGES[1:]]
    assert all(timer.counts[k] == 1 and timer.totals[k] > 0 for k in device_keys(timer))


def test_round_trip_records_its_spans_and_stages(small_model, monkeypatch):
    _, codec = small_model
    wav = prompt_wav(0.5)
    plain = codec.round_trip(wav)
    timer = profiling.StageTimer()
    monkeypatch.setattr(profiling, "SAMPLE_TIMER", timer)
    np.testing.assert_array_equal(codec.round_trip(wav), plain)
    assert set(timer.totals) == {"codec_encode", "codec_decode", "device.codec_encode",
                                 "device.codec_decode"}
    assert device_keys(timer) == ["device.codec_encode", "device.codec_decode"]
    assert all(timer.counts[k] == 1 and timer.totals[k] > 0 for k in timer.totals)


class FakeEvent:
    """torch.cuda.Event on a host without a card: recorded at 1 ms steps."""

    made: list = []

    def __init__(self, enable_timing=False, blocking=False, interprocess=False, external=False):
        assert enable_timing and external  # timed, and a graph node under capture
        self.made.append(self)

    def record(self):
        self.ms = float(len(self.made))

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_cuda_marks_are_events_only_under_a_timer(monkeypatch):
    """A mark on a CUDA device records one timing event, and none while no
    timer is installed; consecutive events become the stages' seconds, an
    ``end`` mark closing a stage, a gap mark read under ``device_gap.``."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(FakeEvent, "made", [])
    cuda = torch.device("cuda")
    assert profiling.SAMPLE_TIMER is None and profiling.call_marks(cuda) is None
    assert not profiling.marking()
    timer = profiling.StageTimer()
    marks = profiling.Marks(cuda, timer)
    with profiling.collect(marks):
        profiling.mark("a")
    assert FakeEvent.made == [] and marks.stamps == []
    monkeypatch.setattr(profiling, "SAMPLE_TIMER", timer)
    profiling.mark("a")  # no collector open
    assert FakeEvent.made == [] and profiling.marking()
    with profiling.collect(marks):
        for name in ("a", "b"):
            profiling.mark(name)
        profiling.mark("launch", gap=True)
        profiling.mark(profiling.END)
        profiling.mark("c")
    assert len(FakeEvent.made) == 5
    marks.read()
    assert dict(timer.totals) == {"device.a": 1e-3, "device.b": 1e-3, "device_gap.launch": 1e-3}
    assert dict(timer.counts) == {"device.a": 1, "device.b": 1, "device_gap.launch": 1}
    assert marks.stamps == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    with open(tmp_path / "t" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)
    with profiling.trace(None):  # no directory: nothing is traced or written
        torch.ones(8).sum()
    with profiling.trace(""):
        pass


def test_synthesize_cli_profile_dir(tmp_path):
    with open(tmp_path / "config.yaml", "w") as f:
        yaml.safe_dump(narrow_config(), f)
    os.makedirs(tmp_path / "prompts")
    save_wav(str(tmp_path / "prompts" / "p.wav"), prompt_wav(0.5))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "flamed_tts_tpu_torch.synthesize", "--ckpt-path", "random",
         "--cfg-path", str(tmp_path / "config.yaml"), "--codec-dir", "random", "--text", "Hi.",
         "--prompt-list", "p.wav", "--prompt-dir", str(tmp_path / "prompts"), "--output-dir",
         str(tmp_path / "out"), "--nsteps-durgen", "2", "--nsteps-denoiser", "2", "--seed", "0",
         "--device", "cpu", "--profile-dir", str(tmp_path / "prof")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Avg RTF" in res.stdout and os.path.isfile(tmp_path / "out" / "p-2-2-0.3-0.3.wav")
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv1d" in names


def test_summarize_training_equals_the_tool(tmp_path, capsys, monkeypatch):
    rng = np.random.RandomState(0)
    rows = [{"first_step_s": 12.3, "step": 1}]
    for step in range(1, 12):
        row = {"step": step, "total_loss": 10.0 / step, "dur_loss": rng.rand(),
               "sil_loss": rng.rand(), "prior_loss": rng.rand(), "fm_loss": rng.rand(),
               "anchor_loss": rng.rand(), "grad_norm": 3.0 * rng.rand()}
        if step > 1:
            row["steps_per_sec"] = 0.01 if step == 5 else 2.0 + rng.rand()
        rows.append(row)
        if step % 5 == 0:
            rows.append({"step": step, "total_loss_val": 9.0 / step})
    with open(tmp_path / "metrics.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n\n")
    rc, text = summaries_equal(tmp_path, capsys, monkeypatch, every=4)
    assert rc == 0 and "time-to-first-step" in text and "| 11 |" in text
    assert "over 9 windows" in text and "val loss: step 5: 1.800, step 10: 0.900" in text

    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "metrics.jsonl").write_text(json.dumps({"step": 1, "total_loss_val": 1.0}) + "\n")
    rc, _ = summaries_equal(empty, capsys, monkeypatch)
    assert rc == 1


def test_synthesize_via_metadata_requires_a_metadata_file(capsys):
    with pytest.raises(SystemExit) as exc:
        synthesize_via_metadata.main(["--ckpt-path", "random", "--cfg-path", "configs",
                                      "--prompt-dir", "p"])
    assert exc.value.code == 2
    assert "requires --text-file" in capsys.readouterr().err
