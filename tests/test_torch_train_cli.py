"""The port's training entry points on the CPU at small widths: the trainer
CLI (steps, resume, validation audio, serving the checkpoint), ``avg_weights``
against the root script (.npz and the reference's checkpoints) and the smoke
test against the root ``test.py``.  Split from tests/test_torch_train.py, whose
helpers write the samples and the tiny config, so that the two files run on
two test workers."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from flamed_tts_tpu.runtime.pytree_io import load_pytree_npz as j_load_pytree_npz

from flamed_tts_tpu_torch.config import save_yaml
from flamed_tts_tpu_torch.runtime.pytree_io import save_pytree_npz

from test_torch_train import _tiny_config_dir, _write_samples
from torch_parity_utils import ROOT, small_config, summaries_equal


def test_train_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """Three steps of ``python -m flamed_tts_tpu_torch.train --device cpu`` on
    a tiny config and five .npz samples, then two more from the full
    state, then the checkpoint serves through Flamed.from_pretrained; the
    port's summary of its metrics.jsonl is the tool's."""
    from flamed_tts_tpu_torch.models.flamed import Flamed
    from flamed_tts_tpu_torch.train.cli import main

    data, cfg_dir, exp = tmp_path / "data", tmp_path / "cfg", tmp_path / "exp"
    data.mkdir()
    cfg_dir.mkdir()
    _write_samples(str(data), 5, seed=0)
    cfg = _tiny_config_dir(str(cfg_dir), str(data))
    args = ["--config-dir", str(cfg_dir), "--exp-dir", str(exp), "--val-every", "2",
            "--log-every", "1", "--device", "cpu"]
    state = main(args + ["--max-steps", "3"])
    assert state.step == 3
    lines = [json.loads(x) for x in open(exp / "metrics.jsonl")]
    losses = [x["total_loss"] for x in lines if "total_loss" in x]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert [x["step"] for x in lines if "steps_per_sec" in x] == [2, 3]  # step 1 is timed apart
    assert any(np.isfinite(x.get("total_loss_val", np.nan)) for x in lines)
    ckpts = set(os.listdir(exp / "checkpoints"))
    assert {"last.npz", "train_state.pt"} <= ckpts and any(c.startswith("step2-val") for c in ckpts)
    assert (exp / "config.yaml").exists()
    assert main(args + ["--max-steps", "5", "--resume-full"]).step == 5
    rc, text = summaries_equal(exp, capsys, monkeypatch, every=1)
    assert rc == 0 and "| 5 |" in text and "val loss: step 2:" in text
    model = Flamed.from_pretrained(cfg, str(exp / "checkpoints" / "last.npz"), device="cpu")
    for name, module in (("prior", state.prior), ("prob", state.prob)):
        assert set(getattr(model, name).state_dict()) == set(module.state_dict())


def test_train_cli_validation_audio_on_cpu(tmp_path):
    """Validation audio through the trainer CLI (a narrow random codec): the
    synthesized and ground-truth wavs are written, and the frame counts the
    codec decoded them at are in the metrics."""
    from flamed_tts_tpu_torch.train.cli import main
    from flamed_tts_tpu_torch.utils.audio import load_wav

    data, cfg_dir, exp = tmp_path / "data", tmp_path / "cfg", tmp_path / "exp"
    data.mkdir()
    cfg_dir.mkdir()
    _write_samples(str(data), 5, seed=0)
    cfg = _tiny_config_dir(str(cfg_dir), str(data))
    codec_cfg = copy.deepcopy(cfg["codec_cfg"])
    codec_cfg["encoder"]["ngf"] = 4
    codec_cfg["decoder"]["upsample_initial_channel"] = 64
    save_yaml(codec_cfg, str(cfg_dir / "codec.yaml"))
    state = main(["--config-dir", str(cfg_dir), "--exp-dir", str(exp), "--max-steps", "2",
                  "--val-every", "2", "--log-every", "1", "--codec-dir", "random",
                  "--audio-log-after", "0", "--device", "cpu"])
    assert state.step == 2
    audio = [x for x in map(json.loads, open(exp / "metrics.jsonl")) if "val_audio_frame_bucket" in x]
    assert len(audio) == 1 and audio[0]["step"] == 2
    bucket, gt_frames = audio[0]["val_audio_frame_bucket"], audio[0]["val_audio_gt_frames"]
    assert bucket in cfg["dataset_cfg"]["frame_buckets"] and gt_frames > 0
    synth, gt = (load_wav(str(exp / "val_audio" / f"step2_{k}.wav")) for k in ("synth", "gt"))
    assert 0 < synth.shape[-1] <= bucket * 200 and synth.shape[-1] % 200 == 0
    assert gt.shape[-1] == gt_frames * 200
    assert np.isfinite(synth).all() and np.isfinite(gt).all()


def test_train_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from flamed_tts_tpu_torch.train.cli import main

    data, cfg_dir = tmp_path / "data", tmp_path / "cfg"
    data.mkdir()
    cfg_dir.mkdir()
    _write_samples(str(data), 5, seed=0)
    _tiny_config_dir(str(cfg_dir), str(data))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config-dir", str(cfg_dir), "--exp-dir", str(tmp_path / "exp"), "--max-steps", "1"])


def _load_root_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"root_{name}", os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_avg_weights_matches_the_root_script(tmp_path):
    from flamed_tts_tpu_torch.avg_weights import average_checkpoints, main

    rng = np.random.RandomState(0)
    paths = []
    for i in range(3):
        tree = {"prior": {"params": {"head": {"kernel": rng.randn(4, 5).astype(np.float32),
                                              "bias": rng.randn(5).astype(np.float32)}}},
                "step": np.array(7, np.int32)}
        paths.append(str(tmp_path / f"c{i}.npz"))
        save_pytree_npz(paths[-1], tree)
    ours, theirs = average_checkpoints(paths), _load_root_script("avg_weights").average_checkpoints(paths)
    assert ours.keys() == theirs.keys()
    assert all(ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]) for k in ours)
    main([str(tmp_path / "avg.npz"), *paths])
    loaded = j_load_pytree_npz(str(tmp_path / "avg.npz"))
    np.testing.assert_array_equal(loaded["prior"]["params"]["head"]["bias"],
                                  ours["prior/params/head/bias"])
    save_pytree_npz(paths[0], {"step": np.array(8, np.int32), "prior": {"params": {"head": {
        "kernel": np.zeros((4, 5), np.float32), "bias": np.zeros(5, np.float32)}}}})
    with pytest.raises(ValueError, match="differs"):
        average_checkpoints(paths)


@pytest.mark.parametrize("lightning", [True, False], ids=["ckpt-lightning", "pt-bare"])
def test_avg_weights_reads_reference_checkpoints_as_the_root_script(tmp_path, lightning):
    """Two reference-format checkpoints (``convert_ckpt.flamed_state_dict`` of
    random trees): the port's average equals the root script's bit for bit."""
    from flamed_tts_tpu_torch.avg_weights import average_checkpoints
    from flamed_tts_tpu_torch.convert import params_to_jax
    from flamed_tts_tpu_torch.convert_ckpt import flamed_state_dict
    from flamed_tts_tpu_torch.models.flamed import Flamed

    cfg = small_config()
    paths = []
    for seed in (0, 1):
        model = Flamed(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        sd = flamed_state_dict({"prior": params_to_jax(model.prior.state_dict()),
                                "prob": params_to_jax(model.prob.state_dict())})
        paths.append(str(tmp_path / f"m{seed}.{'ckpt' if lightning else 'pt'}"))
        torch.save({"state_dict": sd, "epoch": seed} if lightning else sd, paths[-1])
    ours, theirs = average_checkpoints(paths), _load_root_script("avg_weights").average_checkpoints(paths)
    assert ours.keys() == theirs.keys() and len(ours) > 100
    assert all(ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]) for k in ours)
    one = average_checkpoints(paths[:1] * 2)
    assert not all(np.array_equal(ours[k], one[k]) for k in ours)


def test_smoke_cli_on_cpu():
    """The nine-tensor smoke test: the same batch as the root test.py
    makes from the same seed, finite losses and sampling shapes."""
    from flamed_tts_tpu_torch.smoke import build_cfg, dummy_training_batch, main

    cfg = build_cfg(small=True)
    ours = dummy_training_batch(np.random.RandomState(3), cfg)
    theirs = _load_root_script("test").fabricate_dummy_training_batch(np.random.RandomState(3), cfg)
    assert list(ours) == list(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    losses = main(["--device", "cpu", "--small", "--nsteps", "2"])
    assert set(losses) == {"dur_loss", "sil_loss", "prior_loss", "fm_loss", "anchor_loss",
                           "total_loss"}
