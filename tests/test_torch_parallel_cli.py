"""The trainer CLI on a mesh: ``torchrun --nproc-per-node 2 -m
flamed_tts_tpu_torch.train --devices D,M --device cpu`` (gloo) against the
same CLI in one process, on a tiny config and five .npz samples.  The
validation set is one utterance, so on two data ranks its batch leaves
rank 1 no rows."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from flamed_tts_tpu_torch.config import load_yaml, save_yaml
from flamed_tts_tpu_torch.runtime.pytree_io import flatten_pytree, load_pytree_npz

from test_torch_train import _tiny_config_dir, _write_samples
from torch_parity_utils import ROOT

STEPS = 3


def _losses(exp):
    lines = [json.loads(x) for x in open(os.path.join(exp, "metrics.jsonl"))]
    return ([x["total_loss"] for x in lines if "total_loss" in x],
            [x["grad_norm"] for x in lines if "grad_norm" in x],
            [x["total_loss_val"] for x in lines if "total_loss_val" in x])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    data, cfg_dir = tmp / "data", tmp / "cfg"
    data.mkdir()
    cfg_dir.mkdir()
    _write_samples(str(data), 5, seed=0)
    _tiny_config_dir(str(cfg_dir), str(data))
    # no warmup, and eps 1e-4 (tests/test_torch_train.py says why) so that
    # rounding-noise gradients do not move parameters by +-lr
    opt = dict(load_yaml(os.path.join(cfg_dir, "optimizer.yaml")), warmup_steps=0, eps=1e-4)
    save_yaml(opt, os.path.join(cfg_dir, "optimizer.yaml"))
    # one sample order for every run (a null seed draws a fresh one a run)
    save_yaml(dict(load_yaml(os.path.join(cfg_dir, "data.yaml")), seed=0),
              os.path.join(cfg_dir, "data.yaml"))
    common = ["--config-dir", str(cfg_dir), "--val-every", "2", "--log-every", "1", "--device", "cpu",
              "--max-steps", str(STEPS)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    out = {}
    for name, devices in (("one", None), ("dp", "2,1"), ("tp", "1,2")):
        exp = str(tmp / name)
        if devices is None:
            cmd = [sys.executable, "-m", "flamed_tts_tpu_torch.train", "--exp-dir", exp, *common]
        else:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                   "-m", "flamed_tts_tpu_torch.train", "--devices", devices, "--exp-dir", exp, *common]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        out[name] = exp
    return out


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_trainer_cli_on_a_mesh_equals_one_process(runs, mesh):
    """2 x 1 and 1 x 2 under torchrun: the same logged losses, grad norms
    and validation loss as one process, rank 0's files alone (one
    metrics.jsonl line a step and log), and a last.npz of the whole
    parameters equal to one process's."""
    one, ours = _losses(runs["one"]), _losses(runs[mesh])
    assert len(ours[0]) == STEPS and len(ours[2]) == 1
    for a, b in zip(ours, one):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    ref = flatten_pytree(load_pytree_npz(os.path.join(runs["one"], "checkpoints", "last.npz")))
    got = flatten_pytree(load_pytree_npz(os.path.join(runs[mesh], "checkpoints", "last.npz")))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=2e-5, rtol=2e-4, err_msg=k)
    assert os.path.isfile(os.path.join(runs[mesh], "config.yaml"))
    assert os.path.isfile(os.path.join(runs[mesh], "checkpoints", "train_state.pt"))
