"""The port's make surface (flamed_tts_tpu_torch/Makefile): ``make -n`` of
every target names only ``python -m flamed_tts_tpu_torch.*`` entry points
(and ``cp``), and each one's parser takes the flags the target gives it."""

import argparse
import os
import runpy
import shlex
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAKEFILE = os.path.join("flamed_tts_tpu_torch", "Makefile")
TARGETS = ["train", "synth", "synth-meta", "eval", "avg", "test", "bench", "corpus",
           "train-codec", "train-g2p", "train-asr", "eval-disc"]


class _Parsed(Exception):
    pass


def _commands(target, *assignments):
    if shutil.which("make") is None:
        pytest.skip("make is not installed")
    out = subprocess.run(["make", "-s", "-n", "-f", MAKEFILE, target, *assignments], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    return [shlex.split(line) for line in out.replace("\\\n", " ").splitlines() if line.strip()]


def _parse(module, argv, monkeypatch):
    """Run ``python -m module argv`` up to its parser, which must take argv."""
    def parse_args(self, args=None, namespace=None):
        ns, unknown = self.parse_known_args(args, namespace)
        if unknown:
            raise AssertionError(f"{module} does not take {unknown}")
        raise _Parsed(ns)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    monkeypatch.setattr(sys, "argv", [module, *argv])
    with pytest.raises(_Parsed):
        runpy.run_module(module, run_name="__main__", alter_sys=False)


@pytest.mark.parametrize("target,assignments", [(t, ()) for t in TARGETS]
                         + [("train", ("DEVICES=2,1",)), ("eval", ("REF_DIR=refs",))])
def test_make_targets_run_port_entry_points(target, assignments, monkeypatch):
    commands = _commands(target, "OUT=avg.npz", "INPUTS=a.npz b.npz", *assignments)
    assert commands
    for argv in commands:
        if argv[0] == "cp":
            continue
        assert argv[:2] == ["python", "-m"], argv
        if argv[2] == "torch.distributed.run":
            assert argv[3:7] == ["--standalone", "--nproc-per-node", "2", "-m"], argv
            argv = argv[:2] + argv[7:]
        module = argv[2]
        assert module.startswith("flamed_tts_tpu_torch."), argv
        assert "tpu" not in argv[3:], argv
        _parse(module, argv[3:], monkeypatch)
