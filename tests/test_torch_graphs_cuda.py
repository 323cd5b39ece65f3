"""The sampler's captured calls on the card (``runtime/graphs.py``): each
path captured as CUDA graphs against the same call run eagerly, bit for
bit, at small prior and prob widths with the trained codec; a capture
that fails raises; and at the serving widths the device stage marks, event
nodes of the graph, time a replay.  Needs a card (``cuda`` marker); imports nothing of JAX,
so it runs where only the port is installed:

    python -m pytest tests/test_torch_graphs_cuda.py -q -m cuda
"""

import copy
import os

import numpy as np
import pytest
import torch

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.config import load_default_config
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.precision import matmul_precision
from flamed_tts_tpu_torch.runtime.graphs import CapturedCall
from flamed_tts_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

CODEC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "artifacts", "codec_r5")
OUTPUTS = ("latents", "prior_embs", "prior_logits", "tgt_len", "tgt_mask", "wav")
N_PHON = 12


def _config():
    """configs/*.yaml at narrow prior and prob widths (the codec-facing
    widths stay, so the trained codec plugs in)."""
    cfg = copy.deepcopy(load_default_config())
    prior = cfg["prior_generator"]
    prior["transformer"].update(
        encoder_layer=2, encoder_head=2, encoder_hidden=32, encoder_conv_filter_size=64,
        decoder_shared_layers=1, decoder_layers=[1, 2, 1, 1, 1, 1], decoder_head=4,
        decoder_hidden=48, decoder_conv_filter_size=96)
    for g in ("duration_generator", "sil_generator"):
        prior["variance_adaptor"][g].update(input_size=32, filter_size=64)
    cfg["prob_generator"].update(cond_dim=48, hidden_dim=64, n_layers=2)
    cfg["dataset_cfg"].update(phoneme_buckets=[16, 32], frame_buckets=[8, 32, 64, 128, 256],
                              prompt_buckets=[64, 128])
    return cfg


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = Flamed(_config(), device=dev, generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(0)
    t = np.arange(8000) / 16000.0
    wav = (0.2 * np.sin(2 * np.pi * 150 * t) + 0.01 * rng.randn(t.size)).astype(np.float32)
    return dev, model, wav, rng.randint(1, 300, (1, N_PHON))


def _run(model, call, graphs):
    model.sampler.graphs = graphs
    model.sampler._ratio_history.clear()  # the same speculative bucket each time
    kernels.reset_launches()
    out = call()
    torch.cuda.synchronize()
    return out, dict(kernels.launches)


@pytest.mark.parametrize("path", ["staged_fp32", "fused_prompt_bf16_k3", "overflow_bf16"])
def test_captured_call_equals_the_eager_call(card, path):
    dev, model, wav, phonemes = card
    codec = FaCodec.from_pretrained(CODEC_DIR, device=dev, fuse_blocks=path != "staged_fp32")
    if path == "staged_fp32":
        codes, timbre = codec.encode_prompt(wav)
        precision = "highest"

        def call():
            return model.sample_batch(phonemes, np.array([N_PHON]), prompts=codes[None].astype(np.int64),
                                      timbres=timbre[None], codec=codec, seed=0, fused=False,
                                      nsteps_durgen=4, nsteps_denoiser=4)
    else:
        model = Flamed(_config(), params={"prior": model.prior.state_dict(),
                                          "prob": model.prob.state_dict()}, device=dev)
        model.cast_inference_params()
        codec.cast_inference_params()
        padded, n_frames = codec.pad_prompt_wav(wav)
        precision = "default"
        budget = 0.5 if path == "overflow_bf16" else None

        def call():
            return model.sampler.sample(
                phonemes, np.array([N_PHON]), None, None, None, dev, codec=codec,
                vocab_pad=model.vocab_size, nsteps_durgen=4, nsteps_denoiser=4, fused=True,
                generator=torch.Generator(device=dev).manual_seed(0),
                frames_per_phoneme_budget=budget, prompt_wav=padded[None],
                prompt_frames=np.array([n_frames]))
    with matmul_precision(precision):
        ref, eager_launches = _run(model, call, False)
        first, _ = _run(model, call, True)
        replayed, launches = _run(model, call, True)
    model.sampler.graphs = True
    paths = sorted(k[0] for k in model.sampler._graphs)
    assert paths == {"staged_fp32": ["stage1", "stage2"], "fused_prompt_bf16_k3": ["fused_p"],
                     "overflow_bf16": ["fused_p", "stage2"]}[path]
    if path == "overflow_bf16":
        assert ref["frame_bucket"] > 8
    if path == "fused_prompt_bf16_k3":
        assert launches["residual_stack"] > 0
    assert launches == eager_launches and launches["snake_filtered"] > 0
    for out in (first, replayed):
        assert out["frame_bucket"] == ref["frame_bucket"]
        for k in OUTPUTS:
            a, b = (v.cpu().numpy() if isinstance(v, torch.Tensor) else v for v in (out[k], ref[k]))
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_failed_capture_raises(card):
    """A host-to-device copy from pageable memory inside the captured
    function ends the capture: the construction raises, nothing runs
    eagerly in its place, and the card takes work afterwards."""
    dev = card[0]
    x = torch.ones(4, device=dev)
    host = np.arange(4, dtype=np.float32)
    with pytest.raises(RuntimeError):
        CapturedCall(lambda x: (x + torch.as_tensor(host, device=dev),), {"x": x})
    torch.cuda.synchronize()
    assert float((x * 2).sum()) == 8.0


def test_stage_marks_sum_to_the_replay(card, monkeypatch):
    """The bench's bf16 call at the serving widths (``bench.build``: the
    pinned durations, 64 + 64 Euler steps, a 3 s prompt), warmed up under a
    timer so that its fused graph holds the marks: one replay's stages on
    the device, the input copies to the output clones, sum to within 2 % of
    CUDA events around the whole ``CapturedCall.__call__``, each stage
    read once and above 0."""
    from flamed_tts_tpu_torch import bench

    dev = card[0]
    model, codec = bench.build(load_default_config(), "bf16", dev)
    run = bench.make_run(model, codec, bench.prompt_wav())
    monkeypatch.setattr(profiling, "SAMPLE_TIMER", profiling.StageTimer())
    bench.warm(run)
    timer = profiling.StageTimer()
    monkeypatch.setattr(profiling, "SAMPLE_TIMER", timer)
    around = []
    call = CapturedCall.__call__

    def timed(self, inputs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = call(self, inputs)
        end.record()
        around.append((start, end))
        return out

    monkeypatch.setattr(CapturedCall, "__call__", timed)
    captures = model.sampler.captures
    run(1)
    torch.cuda.synchronize()
    assert model.sampler.captures == captures and len(around) == 1
    outer = around[0][0].elapsed_time(around[0][1])
    stages = {k: 1e3 * timer.totals[k] for k in timer.totals if k.startswith("device")}
    assert list(stages) == ["device.graph_copy_in", "device_gap.graph_launch", "device.codec_encode",
                            "device.durations", "device.prior_decode", "device.denoiser",
                            "device.codec_decode", "device.graph_copy_out"]
    assert all(timer.counts[k] == 1 for k in stages)
    assert all(v > 0 for k, v in stages.items() if k.startswith("device."))
    busy = sum(v for k, v in stages.items() if k.startswith("device."))
    print(f"[stage marks] replay {outer:.3f} ms (events around the call), stages {busy:.3f} ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    assert abs(busy - outer) <= 0.02 * outer
