"""The port's corpus fabricator (``flamed_tts_tpu_torch/fabricate_corpus.py``)
against the JAX package's ``tools/fabricate_corpus.py``: the same files,
bit for bit, for the same flags, and the same audio a phone."""

import importlib.util
import os
import sys

import numpy as np
import pytest

from flamed_tts_tpu_torch import fabricate_corpus as fab
from flamed_tts_tpu_torch.utils.audio import load_wav

from torch_parity_utils import ROOT


def _tool():
    spec = importlib.util.spec_from_file_location("fabricate_corpus_tool",
                                                  os.path.join(ROOT, "tools", "fabricate_corpus.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("flags", [["--n", "3", "--n-speakers", "2"],
                                   ["--n", "2", "--n-speakers", "5", "--seed", "4", "--dur-max", "3",
                                    "--prefix", "b"]])
def test_files_equal_the_tool(tmp_path, monkeypatch, capsys, flags):
    """Wav samples equal as read back; TextGrids, fab_manifest.txt and
    speakers.txt equal byte for byte once the output directory in the
    paths is replaced; the printed summary too."""
    ref_dir, our_dir = str(tmp_path / "ref"), str(tmp_path / "ours")
    monkeypatch.setattr(sys, "argv", ["fabricate_corpus.py", "--out-dir", ref_dir, *flags])
    _tool().main()
    ref_out = capsys.readouterr().out
    fab.main(["--out-dir", our_dir, *flags])
    assert capsys.readouterr().out == ref_out.replace(ref_dir, our_dir)
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(our_dir))
    n = int(flags[1])
    assert sum(x.endswith(".wav") for x in names) == n and "speakers.txt" in names
    for name in names:
        a, b = os.path.join(ref_dir, name), os.path.join(our_dir, name)
        if name.endswith(".wav"):
            ref = load_wav(a)
            np.testing.assert_array_equal(load_wav(b), ref)
            assert 16000 <= len(ref) and len(ref) % 200 == 0
        else:
            with open(a, encoding="utf-8") as fa, open(b, encoding="utf-8") as fb:
                assert fb.read() == fa.read().replace(ref_dir, our_dir), name


@pytest.mark.parametrize("phone", ["IY", "M", "S", "ZH", "T", "G", "CH", "sil", "XX"])
def test_phone_audio_equal_the_tool(phone):
    tool = _tool()
    for spk_id in (0, 7):
        assert fab.make_speaker(spk_id) == tool.make_speaker(spk_id)
        spk = fab.make_speaker(spk_id)
        ours = fab.phone_audio(phone, 1234, 0.3, spk, np.random.RandomState(spk_id))
        np.testing.assert_array_equal(ours, tool._phone_audio(phone, 1234, 0.3, spk,
                                                              np.random.RandomState(spk_id)))
