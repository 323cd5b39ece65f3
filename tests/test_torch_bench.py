"""The port's benchmark entry points (``bench``, ``bench_throughput``) on the
CPU at small widths: the duration pin against the JAX package's (the root
``bench.py``'s pin on a JAX ``Flamed``, the same noise), frames a phoneme
in the range the chip smoke asserts, the aggregation, the JSON keys of the
root scripts, the no-card exit, and the throughput bench's batch assembly."""

import ast
import json
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flamed_tts_tpu_torch import bench, bench_throughput, profile_sample
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed

from torch_parity_utils import ROOT, jax_params, small_config

NSTEPS = 2
L_BUCKET = 128


def bench_config():
    """The small widths, with the buckets the pinned TEXT and the 3 s
    prompt land in (85 phonemes -> 128; ~540 frames -> 768; 240 prompt
    frames -> 256) and a narrow codec."""
    cfg = small_config()
    cfg["dataset_cfg"].update(phoneme_buckets=[64, 128], frame_buckets=[256, 512, 768, 1024],
                              prompt_buckets=[64, 256])
    cfg["codec_cfg"]["encoder"]["ngf"] = 4
    cfg["codec_cfg"]["decoder"]["upsample_initial_channel"] = 64
    return cfg


def _pin_jax(params):
    """The root bench.py's pin (bench.py:140-145) on a JAX parameter tree."""
    params = jax.tree.map(lambda x: x, params)
    dg = params["prior"]["params"]["duration_generator"]["linear_layer"]
    dg["kernel"] = jnp.zeros_like(dg["kernel"])
    dg["bias"] = jnp.full_like(dg["bias"], math.log(7.0))
    sg = params["prior"]["params"]["sil_generator"]["linear_layer"]
    sg["kernel"] = jnp.zeros_like(sg["kernel"])
    sg["bias"] = jnp.full_like(sg["bias"], -1.0)
    return params


@pytest.fixture(scope="module")
def pinned():
    cfg = bench_config()
    jmodel, params = jax_params(cfg, seed=2)
    jmodel.params = _pin_jax(jmodel.params)
    model = Flamed(cfg, params, device="cpu")
    bench.pin_durations(model)
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, 1024, (6, 40))
    timbre = rng.randn(256).astype(np.float32)
    return cfg, jmodel, model, prompt, timbre


def _jax_noise(rng, f_bucket):
    """The draws the JAX fused path makes from ``rng``."""
    rng1, rng2 = jax.random.split(rng)
    rng_dur, rng_sil = jax.random.split(rng1)
    return {"dur": np.asarray(jax.random.normal(rng_dur, (1, L_BUCKET))),
            "sil": np.asarray(jax.random.normal(rng_sil, (1, L_BUCKET))),
            "latents": np.asarray(jax.random.normal(rng2, (1, f_bucket, 256)))}


def test_pin_sets_the_same_parameters(pinned):
    _, jmodel, model, _, _ = pinned
    for name, bias in (("duration_generator", math.log(7.0)), ("sil_generator", -1.0)):
        layer = getattr(model.prior, name).linear_layer
        jlayer = jmodel.params["prior"]["params"][name]["linear_layer"]
        assert not layer.weight.any() and not np.asarray(jlayer["kernel"]).any()
        np.testing.assert_array_equal(layer.bias.detach().numpy(), np.asarray(jlayer["bias"]))
        assert float(layer.bias[0].detach()) == np.float32(bias)


def test_pinned_durations_equal_jax(pinned):
    """The pinned duration and silence flows through stage 1 of both
    samplers, from the same draws: the same integer durations and tgt_len."""
    _, jmodel, model, _, _ = pinned
    ids = jmodel._get_frontend()(bench.TEXT)[0]
    n = ids.shape[1]
    phonemes = np.zeros((1, L_BUCKET), np.int64)
    phonemes[0, :n] = ids[0]
    rng1 = jax.random.split(jax.random.PRNGKey(11))[0]
    noise = _jax_noise(jax.random.PRNGKey(11), 8)
    _, j_dur, j_sil, j_tgt = jmodel.sampler._stage1_impl(
        jmodel.params["prior"], jnp.asarray(phonemes, jnp.int32), jnp.asarray([n], jnp.int32),
        rng1, NSTEPS, 0.3)
    _, dur, sil, tgt = model.sampler._stage1(torch.from_numpy(phonemes), torch.tensor([n]),
                                             noise, None, NSTEPS, 0.3)
    np.testing.assert_array_equal(dur.numpy(), np.asarray(j_dur))
    np.testing.assert_array_equal(sil.numpy(), np.asarray(j_sil))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(j_tgt))
    assert not sil[0, :n].any()  # past n the fields are masked to 0
    lo, hi = bench.FRAMES_PER_PHONEME
    assert lo <= int(tgt[0]) / n <= hi


def test_pinned_sample_lengths_and_bucket_equal_jax(pinned):
    """A whole fused Flamed.sample on each side (text, processed prompt):
    the same tgt_len and speculative frame bucket."""
    _, jmodel, model, prompt, timbre = pinned
    rng = jax.random.PRNGKey(7)
    ref = jmodel.sample(text=bench.TEXT, prompt_processed=prompt.astype(np.int32), timbre=timbre,
                        nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS, rng=rng)
    f_bucket = int(ref["latents"].shape[1])
    out = model.sample(text=bench.TEXT, prompt_processed=prompt, timbre=timbre,
                       nsteps_durgen=NSTEPS, nsteps_denoiser=NSTEPS,
                       noise=_jax_noise(rng, f_bucket))
    np.testing.assert_array_equal(out["tgt_len"], np.asarray(ref["tgt_len"]))
    assert out["frame_bucket"] == f_bucket == 768


def test_bench_pipeline_at_small_widths():
    """build -> warm -> measure -> aggregate -> report at small widths on
    the CPU, in bf16 as the bench runs: every timed call's frames a phoneme
    in the range the chip smoke asserts, its audio seconds tgt_len * hop."""
    model, codec = bench.build(bench_config(), "bf16", "cpu")
    assert model.prior.duration_generator.linear_layer.bias[0] == torch.tensor(
        math.log(7.0)).to(torch.bfloat16).float()  # pinned, then rounded as the root bench's
    run = bench.make_run(model, codec, bench.prompt_wav(), nsteps_durgen=NSTEPS,
                         nsteps_denoiser=NSTEPS)
    bench.warm(run, seeds=range(1))
    calls = bench.measure(run, seeds=range(1, 3))
    lo, hi = bench.FRAMES_PER_PHONEME
    for c, fpp in zip(calls, bench.frames_per_phoneme(model, calls)):
        assert lo <= fpp <= hi
        assert c["audio_s"] == c["tgt_len"] * codec.hop / 16000.0
        assert c["frame_bucket"] >= c["tgt_len"] and c["seconds"] > 0
    agg = bench.aggregate([c["seconds"] for c in calls], [c["audio_s"] for c in calls])
    line = bench.report(agg["rtf"], "bf16", bench.contention(torch.device("cpu")), agg["dropped"])
    assert line["value"] > 0 and line["precision"] == "bf16"
    json.dumps(line)


def test_aggregate_drops_slow_calls_with_their_seconds():
    agg = bench.aggregate([1.0, 1.2, 1.31, 3.0, 1.1], [10.0, 20.0, 30.0, 40.0, 50.0])
    assert agg["dropped"] == 2 and agg["kept"] == 3
    assert agg["kept_t"] == pytest.approx(3.3) and agg["kept_s"] == 80.0
    assert agg["rtf"] == pytest.approx(3.3 / 80.0)
    assert bench.aggregate([2.0], [4.0])["rtf"] == 0.5
    guard = {"contended": False, "load1": 0.123, "probe_ms": 0.04567}
    line = bench.report(0.0123456, "bf16", guard, 2)
    assert line == {"metric": "rtf_single_utt_nfe64", "value": 0.01235, "unit": "rtf",
                    "vs_baseline": 4.05, "precision": "bf16", "contended": False,
                    "load1": 0.12, "probe_ms": 0.046, "dropped_runs": 2}


def _dict_keys(path, must_have):
    """Key sets of the dict literals in a root script that hold ``must_have``."""
    with open(os.path.join(ROOT, path), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if must_have <= keys:
                found.append(keys)
    assert found, (path, must_have)
    return found


def test_json_keys_equal_the_root_scripts():
    guard = {"contended": True, "load1": 2.0, "probe_ms": 1.0}
    assert [set(bench.report(0.1, "fp32", guard, 0))] == _dict_keys("bench.py", {"dropped_runs"})
    assert set(_dict_keys("bench.py", {"error"})[0]) == {
        "metric", "value", "unit", "vs_baseline", "error", "detail"}
    assert _dict_keys("bench_throughput.py", {"metric"}) == [
        {"metric", "value", "unit", "vs_baseline"}]
    assert _dict_keys("tools/profile_sample.py", {"wall_ms"}) == [
        {"wall_ms", "audio_s", "rtf", "spans_ms", "residual_ms", "all_walls_ms"}]


@pytest.mark.parametrize("module,metric", [(bench, "rtf_single_utt_nfe64"),
                                           (bench_throughput, "rtf_batch4_nfe128"),
                                           (profile_sample, "rtf_single_utt_nfe64")])
def test_main_without_a_card_prints_gpu_unavailable(module, metric, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == metric and line["error"] == "gpu_unavailable"
    assert line["value"] is None and line["vs_baseline"] is None
    assert set(line) == set(_dict_keys("bench.py", {"error"})[0])


def test_throughput_batch_assembly(pinned):
    """Texts, phoneme rows and prompts as the root bench_throughput.py
    assembles them (its lines 55-79), prompts of several lengths."""
    cfg, jmodel, model, _, _ = pinned
    assert bench_throughput.batch_texts(4) == bench_throughput.TEXTS[:4]
    assert bench_throughput.batch_texts(10) == bench_throughput.TEXTS + bench_throughput.TEXTS[:2]
    texts = bench_throughput.batch_texts(3)
    phonemes, src_lens = bench_throughput.batch_phonemes(model, texts)
    jrows = [jmodel._get_frontend()(t)[0][0] for t in texts]
    assert src_lens.tolist() == [len(r) for r in jrows]
    assert phonemes.shape == (3, max(src_lens))
    for row, jrow, n in zip(phonemes, jrows, src_lens):
        np.testing.assert_array_equal(row[:n], jrow)
        assert not row[n:].any()

    codec = FaCodec.random_init(torch.Generator().manual_seed(0), device="cpu",
                                codec_cfg=cfg["codec_cfg"])
    wavs = [w[: 8000 * (i + 1)] for i, w in enumerate(bench_throughput.prompt_wavs(2))]
    prompts, p_lens, timbres = bench_throughput.encode_prompts(codec, wavs, model.vocab_size)
    assert p_lens.tolist() == [40, 80] and prompts.shape == (2, 6, 80) and timbres.shape == (2, 256)
    for i, w in enumerate(wavs):
        codes, timbre = codec.encode_prompt(w)
        np.testing.assert_array_equal(prompts[i, :, : p_lens[i]], codes)
        np.testing.assert_array_equal(timbres[i], timbre)
    assert (prompts[0, :, 40:] == model.vocab_size).all()
    assert bench_throughput.audio_seconds(np.array([400, 80])) == 6.0


def test_bench_ab_alternates_the_checkouts(monkeypatch, tmp_path, capsys):
    """bench_ab runs the two checkouts' benches in the order other, this,
    this, other, ... in their own directories, then one profile and one
    component run each, and prints the report as its last line."""
    from flamed_tts_tpu_torch import bench_ab

    calls = []

    def fake(root, argv):
        calls.append((root, argv[-1] if argv[0] == "-m" else argv[:2]))
        if argv[:2] == ["-m", "flamed_tts_tpu_torch.bench_components"]:
            return {"rows": [{"name": "denoiser", "ms": 1.0}],
                    "total": {"rtf_compute_floor": 0.01, "compute_ms": 1.0, "mfu_whole_call": 1.0}}
        return {"value": 0.1 if root == bench_ab.HERE else 0.2, "device_kernels": 1}

    monkeypatch.setattr(bench_ab, "_last_json", fake)
    monkeypatch.setattr(bench_ab, "nvidia_smi_line", lambda: "card")
    report = bench_ab.main(["--other", str(tmp_path)])
    assert report["order"] == ["other", "this", "this", "other", "other", "this"]
    assert report["rtf"] == {"other": [0.2] * 3, "this": [0.1] * 3}
    assert [c[0] for c in calls[:6]] == [str(tmp_path), bench_ab.HERE, bench_ab.HERE, str(tmp_path),
                                         str(tmp_path), bench_ab.HERE]
    assert report["components"]["this"]["rows_ms"] == {"denoiser": 1.0}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
