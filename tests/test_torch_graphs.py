"""The sampler's compile-once executor (``runtime/graphs.py``, the graph
bookkeeping of ``runtime/sampler.py``) on the CPU, and the tables it needs
made once.

A CUDA graph exists only on the card (``tests/test_torch_graphs_cuda.py``
holds the real one).  Here a stand-in (``EagerGraph``, defined in this file
and set on the sampler by the tests, never a default) records the path at
its capture and replays it eagerly on its static buffers, writing into its
static outputs: a path that read anything but its inputs, or a call that
returned the static outputs themselves, would show against the eager call.
Small random prior and prob weights, a narrow random codec, 2 Euler steps,
fp32; every comparison is bit for bit."""

import numpy as np
import pytest
import torch

from flamed_tts_tpu.models.facodec.timbre import batch_constant_positional_bias as j_bias
from flamed_tts_tpu.ops.embeddings import sinusoid_position_table as j_table

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.facodec import timbre
from flamed_tts_tpu_torch.models.facodec.decoder import init_decoder_params
from flamed_tts_tpu_torch.models.facodec.encoder import init_encoder_params
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.ops import embeddings, snake
from flamed_tts_tpu_torch.runtime import graphs
from flamed_tts_tpu_torch.utils import profiling

from torch_parity_utils import one_torch_thread, prompt_wav, small_config  # noqa: F401

NSTEPS = 2
N_PHON = 12
OUTPUTS = ("latents", "prior_embs", "prior_logits", "tgt_len", "tgt_mask", "wav", "frame_bucket")


class EagerGraph(graphs.CapturedCall):
    """Stand-in for a CUDA graph on the CPU (tests only): the capture runs
    the path once on the static buffers and keeps what it returns as the
    static outputs; a replay runs it again on the buffers and writes the
    results into those outputs.  The stage marks of the capture stand for
    the graph's event nodes: a replay records them again, in their place."""

    def _warm_up(self, fn):
        pass

    def _capture(self, fn):
        self.fn = fn
        return tuple(fn(**self.inputs))

    def _replay(self):
        # a graph's replay runs no wrapper: the counters move by what the
        # capture recorded, which the base class adds
        counters = dict(kernels.launches)
        nodes = None if self.marks is None else profiling.Marks("cpu", self.marks.timer)
        with profiling.collect(nodes):
            outputs = self.fn(**self.inputs)
        if nodes is not None:
            assert [m[:2] for m in nodes.stamps] == [m[:2] for m in self.marks.stamps]
            self.marks = nodes
        for static, new in zip(self.outputs, outputs):
            if static is not None:
                static.copy_(new)
        kernels.launches.update(counters)


# --- the tables, made once ----------------------------------------------------

TABLES = {
    "position": (embeddings, "position_table_np", embeddings._position_table,
                 lambda: embeddings.sinusoid_position_table(37, 48), lambda: j_table(37, 48),
                 lambda build: build(37, 48)),
    "timbre_bias": (timbre, "positional_buffer_np", timbre._positional_bias,
                    lambda: timbre.batch_constant_positional_bias(3, 256), lambda: j_bias(3, 256),
                    lambda build: build(256, 5000)[:3, None, :]),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_made_once_equals_a_fresh_build_and_jax(name, monkeypatch):
    module, build_name, cache, table, jax_table, fresh = TABLES[name]
    build = getattr(module, build_name)
    calls = []
    monkeypatch.setattr(module, build_name, lambda *a: calls.append(a) or build(*a))
    cache.cache_clear()
    first = table()
    assert len(calls) == 1
    assert table() is first and len(calls) == 1  # the second call builds nothing
    assert first.dtype == torch.float32
    assert torch.equal(first, torch.as_tensor(fresh(build), dtype=torch.float32))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jax_table()))


# --- the sampler ----------------------------------------------------------------


@pytest.fixture(scope="module")
def parts():
    cfg = small_config()
    params = Flamed(cfg, device="cpu").init_params(torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(0)
    codec = FaCodec(init_encoder_params(g, ngf=4), init_decoder_params(g, upsample_initial_channel=64),
                    device="cpu")
    phonemes = np.random.RandomState(3).randint(1, 300, (1, N_PHON))
    rng = np.random.RandomState(4)
    prompts = rng.randint(0, 1024, (1, 6, 20))
    timbre_ = rng.randn(1, 256).astype(np.float32)
    return cfg, params, codec, phonemes, prompts, timbre_


def _pair(parts):
    """(eager model, model whose sampler captures through ``EagerGraph``)."""
    cfg, params = parts[:2]
    eager = Flamed(cfg, params, device="cpu", graphs=False)
    captured = Flamed(cfg, params, device="cpu")
    captured.sampler.graph_class = EagerGraph
    return eager, captured


CALLS = {
    "staged": lambda m, p, seed: m.sample_batch(
        p[3], np.array([N_PHON]), prompts=p[4], timbres=p[5], codec=p[2], seed=seed, fused=False,
        nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS),
    "fused": lambda m, p, seed: m.sample_batch(
        p[3], np.array([N_PHON]), prompts=p[4], timbres=p[5], codec=p[2], seed=seed,
        nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS),
    "fused_p": lambda m, p, seed: m.sample_batch(
        p[3], np.array([N_PHON]), prompt_wav=p[2].pad_prompt_wav(prompt_wav(0.5, seed=2))[0][None],
        prompt_frames=np.array([p[2].pad_prompt_wav(prompt_wav(0.5, seed=2))[1]]), codec=p[2],
        seed=seed, nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS),
}
PATHS = {"staged": {"stage1", "stage2"}, "fused": {"fused"}, "fused_p": {"fused_p"}}


def _assert_equal(a, b):
    assert set(a) - {"time"} == set(b) - {"time"}
    for k in OUTPUTS:
        if k not in a:
            assert k == "wav" and k not in b
            continue
        x, y = (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (a[k], b[k]))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("path", sorted(CALLS))
def test_captured_call_equals_the_eager_call(parts, path):
    """(b) Each path through the stand-in graph, its first call (capture and
    replay) and a second with the same seed, against the eager call; then
    (c) another seed at the same shapes replays the same graphs and equals
    that seed's eager call, and the first call's outputs are untouched."""
    eager, captured = _pair(parts)
    call = CALLS[path]
    ref = call(eager, parts, 0)
    first = call(captured, parts, 0)
    _assert_equal(first, ref)
    assert {k[0] for k in captured.sampler._graphs} == PATHS[path]
    n = captured.sampler.captures
    assert n == len(PATHS[path]) and eager.sampler.captures == 0
    _assert_equal(call(captured, parts, 0), ref)
    assert captured.sampler.captures == n
    ref_other = call(eager, parts, 5)
    other = call(captured, parts, 5)
    assert captured.sampler.captures == n
    _assert_equal(other, ref_other)
    assert not np.array_equal(other["latents"].numpy(), ref["latents"].numpy())
    _assert_equal(first, ref)  # the replays wrote into the graph's outputs, not into these


def test_overflow_retry_replays_the_stage2_graph(parts):
    """(b) A forced overflow: the fused graph at a speculative bucket of 8
    frames, then the stage2 graph at the bucket the target length needs,
    on the fused graph's encoder output and durations (and the prompt's
    analysis, with a prompt wav)."""
    wav, frames = parts[2].pad_prompt_wav(prompt_wav(0.5, seed=2))
    outs = {}
    for name, model in zip(("eager", "captured"), _pair(parts)):
        model.sampler.frame_buckets = [8, 32, 64, 128, 256]
        outs[name] = [model.sampler.sample(
            parts[3], np.array([N_PHON]), None, None, None, torch.device("cpu"), codec=parts[2],
            nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS, fused=True,
            frames_per_phoneme_budget=0.5, prompt_wav=wav[None], prompt_frames=np.array([frames]),
            generator=torch.Generator().manual_seed(seed)) for seed in (0, 1)]
        if name == "captured":
            assert sorted(k[0] for k in model.sampler._graphs) == ["fused_p", "stage2"]
            assert model.sampler.captures == 2
    for ref, out in zip(outs["eager"], outs["captured"]):
        assert int(out["tgt_len"][0]) > 8 and out["frame_bucket"] > 8
        _assert_equal(out, ref)


def test_cpu_runs_eagerly_unless_a_graph_type_is_set(parts):
    eager, captured = _pair(parts)
    captured.sampler.graph_class = None  # the default: CUDA graphs on the card only
    _assert_equal(CALLS["fused"](captured, parts, 0), CALLS["fused"](eager, parts, 0))
    assert captured.sampler.captures == 0


def test_capture_span_and_a_warm_call_builds_no_table(parts, monkeypatch):
    """The first call of a signature runs under a ``capture`` span, later
    ones do not; and a warm call builds no host table."""
    _, captured = _pair(parts)
    timer = profiling.StageTimer()
    monkeypatch.setattr(profiling, "SAMPLE_TIMER", timer)
    CALLS["fused_p"](captured, parts, 0)
    assert timer.counts["capture"] == 1 and timer.counts["fused_dispatch"] == 1
    builds = []
    for module, name in ((embeddings, "position_table_np"), (timbre, "positional_buffer_np")):
        build = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, build=build: builds.append(a) or build(*a))
    CALLS["fused_p"](captured, parts, 1)
    assert timer.counts["capture"] == 1 and timer.counts["fused_dispatch"] == 2
    assert builds == []


def test_launch_counters_count_replays(parts, monkeypatch):
    """(d) The capture adds nothing to the launch counters; each replay adds
    what its graph recorded, which is what the eager call counts."""
    plain = snake.snake_filtered_reference

    def counted(*a):
        kernels.launches["snake_filtered"] += 1
        return plain(*a)

    monkeypatch.setattr(snake, "snake_filtered_reference", counted)
    eager, captured = _pair(parts)
    kernels.reset_launches()
    CALLS["fused_p"](eager, parts, 0)
    per_call = dict(kernels.launches)
    assert per_call["snake_filtered"] > 0
    kernels.reset_launches()
    CALLS["fused_p"](captured, parts, 0)  # capture, then one replay
    assert kernels.launches == per_call
    (graph,) = captured.sampler._graphs.values()
    assert graph.launches == per_call
    CALLS["fused_p"](captured, parts, 1)
    assert kernels.launches == {k: 2 * n for k, n in per_call.items()}

    kernels.reset_launches()
    x = torch.ones(1, 40, 64)
    alpha = torch.zeros(64)
    g = EagerGraph(lambda x: (snake.snake_filtered(x, alpha, alpha),), {"x": x})
    assert sum(kernels.launches.values()) == 0 and g.launches["snake_filtered"] == 1
    (y,) = g({"x": 2 * x})
    assert kernels.launches["snake_filtered"] == 1
    assert torch.equal(y, snake.snake_filtered(2 * x, alpha, alpha))
    with pytest.raises(ValueError, match="the graph's"):
        g({"x": torch.ones(1, 41, 64)})


def test_graph_marks_only_under_a_timer_and_in_the_signature(parts, monkeypatch):
    """A signature captured while a timer is installed holds the stages'
    marks as its nodes (the warm-up records none); one captured without holds
    none, and installing or removing the timer captures anew.  A replay
    reads the input copies, the launch gap, the graph's stages and the
    output clones, in that order, each once."""
    _, captured = _pair(parts)
    timer = profiling.StageTimer()
    monkeypatch.setattr(profiling, "SAMPLE_TIMER", timer)
    CALLS["fused_p"](captured, parts, 0)
    (marked,) = captured.sampler._graphs.values()
    assert [m[0] for m in marked.marks.stamps] == [
        "codec_encode", "end", "durations", "end", "prior_decode", "denoiser", "codec_decode", "end"]
    assert [k for k in timer.totals if k.startswith("device")] == [
        "device.graph_copy_in", "device_gap.graph_launch", "device.codec_encode", "device.durations",
        "device.prior_decode", "device.denoiser", "device.codec_decode", "device.graph_copy_out"]
    assert all(timer.counts[k] == 1 and timer.totals[k] >= 0 for k in timer.totals
               if k.startswith("device"))
    monkeypatch.setattr(profiling, "SAMPLE_TIMER", None)
    CALLS["fused_p"](captured, parts, 0)
    assert captured.sampler.captures == 2
    plain = [g for g in captured.sampler._graphs.values() if g is not marked]
    assert len(plain) == 1 and plain[0].marks is None
    monkeypatch.setattr(profiling, "SAMPLE_TIMER", timer)
    CALLS["fused_p"](captured, parts, 1)
    assert captured.sampler.captures == 2 and timer.counts["device.denoiser"] == 2
