"""The port's phone recognizer (``flamed_tts_tpu_torch/asr.py``) against the
JAX package's (``flamed_tts_tpu/asr.py``) on the CPU: the same random
parameters from a seed, the forward and speaker embedding (the committed
weights and a narrow random model), the weights file read by either side,
the host decoders, and whole transcriptions of a fabricated utterance."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamed_tts_tpu import asr as jasr

from flamed_tts_tpu_torch import asr
from flamed_tts_tpu_torch.fabricate_corpus import fabricate
from flamed_tts_tpu_torch.text.frontend import read_lexicon
from flamed_tts_tpu_torch.utils.audio import load_wav

from torch_parity_utils import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-4  # abs + rel: the JAX package's own numpy-vs-jnp tolerance (tests/test_asr.py)


def _jnp_tree(t):
    if isinstance(t, dict):
        return {k: _jnp_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jnp_tree(v) for v in t]
    return jnp.asarray(t)


def _models():
    """(name, numpy parameters): the committed weights (192 x 6, speaker
    head of 24) and a narrow random model with a speaker head of 5."""
    return {"committed": asr.load_weights(),
            "narrow": asr.init_params(np.random.RandomState(0), n_speakers=5, d_model=48, n_layers=7)}


@pytest.fixture(scope="module")
def utterance(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("asr_corpus"))
    fabricate(out, n=1, seed=3, n_speakers=4, dur_max=4.0)
    return load_wav(os.path.join(out, "utt00000.wav"))


@pytest.mark.parametrize("n_speakers", [None, 5])
def test_init_params_equal_bit_for_bit(n_speakers):
    ours = asr.init_params(np.random.RandomState(0), n_speakers=n_speakers)
    ref = jasr.init_params(np.random.RandomState(0), n_speakers=n_speakers)
    assert ours.keys() == ref.keys() and len(ours["layers"]) == len(ref["layers"]) == jasr.N_LAYERS
    for k in ref:
        if k != "layers":
            np.testing.assert_array_equal(ours[k], ref[k])
    for a, b in zip(ours["layers"], ref["layers"]):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("model", ["committed", "narrow"])
def test_forward_matches_jax(model):
    params = _models()[model]
    mel = np.random.RandomState(1).randn(2, 70, 80).astype(np.float32)
    ours = asr.forward(asr.to_tensors(params), torch.from_numpy(mel)).numpy()
    assert ours.shape == (2, 70, asr.N_CLASSES)
    np.testing.assert_allclose(ours, jasr.forward(params, np, mel), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours, np.asarray(jasr.forward(_jnp_tree(params), jnp, jnp.asarray(mel))),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("model", ["committed", "narrow"])
@pytest.mark.parametrize("masked", [False, True])
def test_speaker_embed_matches_jax(model, masked):
    params = _models()[model]
    rng = np.random.RandomState(2)
    mel = rng.randn(3, 50, 80).astype(np.float32)
    mask = (np.arange(50)[None, :] < np.array([[50], [31], [7]])) if masked else None
    ours = asr.speaker_embed(asr.to_tensors(params), torch.from_numpy(mel),
                             None if mask is None else torch.from_numpy(mask)).numpy()
    ref = jasr.speaker_embed(params, np, mel, frame_mask=mask)
    assert ours.shape == (3, asr.SPK_EMB_DIM)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_weights_file_read_by_either_package(tmp_path, writer):
    """The npz one package writes gives the other package's load the same
    forward (and the same arrays)."""
    params = asr.init_params(np.random.RandomState(4), n_speakers=3, d_model=32, n_layers=3)
    path = str(tmp_path / "asr.npz")
    (asr.save_weights if writer == "port" else jasr.save_weights)(params, path)
    loaded = (jasr.load_weights if writer == "port" else asr.load_weights)(path)
    mel = np.random.RandomState(5).randn(1, 40, 80).astype(np.float32)
    np.testing.assert_allclose(asr.forward(asr.to_tensors(loaded), torch.from_numpy(mel)).numpy(),
                               jasr.forward(params, np, mel), rtol=TOL, atol=TOL)
    assert sorted(loaded) == sorted(params) and len(loaded["layers"]) == 3
    np.testing.assert_array_equal(loaded["spk_cls"], params["spk_cls"])
    np.testing.assert_array_equal(loaded["layers"][2]["dw"], params["layers"][2]["dw"])


def test_missing_weights_file():
    assert asr.load_weights("/nonexistent/asr.npz") is None
    with pytest.raises(FileNotFoundError):
        asr.PhonemeRecognizer("/nonexistent/asr.npz", device="cpu")


@pytest.fixture(scope="module")
def trie():
    return asr.LexiconTrie(read_lexicon(asr.BUILTIN_LEXICON)), jasr.LexiconTrie(read_lexicon(asr.BUILTIN_LEXICON))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decoders_match_jax(trie, seed):
    """Seeded random log-probs over the built-in lexicon's trie: a run of
    frames a phone, with noise, so that the decoders have words to find."""
    ours_trie, ref_trie = trie
    assert ours_trie.root == ref_trie.root
    rng = np.random.RandomState(seed)
    phones = rng.randint(1, asr.N_CLASSES, 12)
    runs = rng.randint(1, 6, 12)
    frame_ids = np.repeat(phones, runs)
    frame_ids[rng.rand(len(frame_ids)) < 0.15] = asr.SIL
    assert asr.collapse_frames(frame_ids) == jasr.collapse_frames(frame_ids)
    assert asr.collapse_frames(frame_ids, min_run=1) == jasr.collapse_frames(frame_ids, min_run=1)
    ids = asr.collapse_frames(frame_ids, min_run=1)
    # one trie for both: the beam breaks cost ties by the nodes' id()
    assert asr.beam_decode_words(ids, ref_trie) == jasr.beam_decode_words(ids, ref_trie)
    logits = rng.randn(len(frame_ids), asr.N_CLASSES).astype(np.float32)
    logits[np.arange(len(frame_ids)), frame_ids] += 4.0
    logprobs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    got = asr.viterbi_decode_words(logprobs, ours_trie)
    assert got == jasr.viterbi_decode_words(logprobs, ref_trie) and got


def test_transcribe_matches_jax(utterance):
    """The committed recognizer on a fabricated utterance: frame logits
    within 2e-4, the same phones and words, the speaker embedding within
    1e-5."""
    ours, ref = asr.PhonemeRecognizer(device="cpu"), jasr.PhonemeRecognizer()
    np.testing.assert_allclose(ours.frame_logits(utterance), ref.frame_logits(utterance), rtol=TOL, atol=TOL)
    phones, words = ours.transcribe(utterance)
    assert (phones, words) == ref.transcribe(utterance) and phones and words
    np.testing.assert_allclose(ours.speaker_embedding(utterance), ref.speaker_embedding(utterance),
                               atol=1e-5, rtol=0)
    # zero padding to the whole second, as the JAX recognizer: a wav of a
    # whole number of seconds is not padded at all
    cut = utterance[: 16000 * (len(utterance) // 16000)]
    np.testing.assert_array_equal(ours.frame_ids(cut), np.argmax(ref.frame_logits(cut), -1))


def test_canon_equal_over_the_lexicon():
    ours, ref = asr.PhonemeRecognizer(device="cpu"), jasr.PhonemeRecognizer()
    assert ours._canon == ref._canon and len(ours._canon) > 1000
    for word in ("their", "there", "THERE", "zzyzx"):
        assert ours.canon(word) == ref.canon(word)
