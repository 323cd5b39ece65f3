"""The port's host side: the text frontend against the JAX package's, WAV
I/O, and the CLI in both modes on the CPU with small random weights."""

import os

import numpy as np
import pytest
import yaml

from flamed_tts_tpu.text.frontend import EnglishFrontend as JEnglishFrontend
from flamed_tts_tpu.text.symbols import symbols as jsymbols
from flamed_tts_tpu.utils import audio as jaudio

from flamed_tts_tpu_torch import synthesize as syn
from flamed_tts_tpu_torch.models.prior.prior_generator import N_SYMBOLS
from flamed_tts_tpu_torch.text import sequence_to_text, text_to_sequence
from flamed_tts_tpu_torch.text.frontend import EnglishFrontend
from flamed_tts_tpu_torch.text.neural_g2p import DEFAULT_LEXICON_DIR
from flamed_tts_tpu_torch.text.symbols import symbols
from flamed_tts_tpu_torch.utils.audio import load_wav, save_wav, synth_filename

from torch_parity_utils import prompt_wav, small_config

SENTENCES = [
    "Hello world.",
    "The quick brown fox jumps over the lazy dog!",
    "It costs $3.50, or 1,200 yen, in 1999.",                 # numbers, currency, a year
    "Dr. Smith and Mr. Jones met Mrs. Brown on the 2nd of May.",  # abbreviations, an ordinal
    "Wait; what? No... yes: maybe - fine!",                   # punctuation
    "The unhappiest walkers were jogging quickly.",           # inflections of lexicon stems
    "Zyxgrommet flibbertigibbeted the blorptastic qwertyuiop.",  # out of lexicon: neural G2P
    "Xqzvk",                                                  # no vowel: G2P of last resort
    "café naïve — “quoted” text",                             # unicode folding
    "",                                                       # empty text
]


@pytest.fixture(scope="module")
def frontends():
    return EnglishFrontend(), JEnglishFrontend()


@pytest.mark.parametrize("text", SENTENCES)
def test_frontend_ids_equal(frontends, text):
    port, ref = frontends
    ids, original, phones = port(text)
    ref_ids, _, ref_phones = ref(text)
    assert phones == ref_phones
    np.testing.assert_array_equal(ids, ref_ids)
    assert ids.ndim == 2 and ids.shape[0] == 1 and original == text
    assert ids.max() < N_SYMBOLS


def test_symbol_table():
    assert symbols == jsymbols and N_SYMBOLS == len(symbols) == 360
    seq = text_to_sequence("{HH AH0 L OW1} world", ["english_cleaners"])
    assert sequence_to_text(seq) == "{HH AH0 L OW1} world"


def test_lexicon_is_read_in_place(frontends):
    port, ref = frontends
    assert os.path.samefile(DEFAULT_LEXICON_DIR,
                            os.path.join(os.path.dirname(jaudio.__file__), "..", "lexicon"))
    assert len(port.builtin) == len(ref.builtin) > 1000
    assert len(port.expanded) == len(ref.expanded) > 100000
    empty = EnglishFrontend(lexicon_dir=os.path.join(DEFAULT_LEXICON_DIR, "nowhere"))
    assert not empty.builtin and empty._neural_g2p() is None
    assert empty.word_to_phones("cat")  # letter-to-sound rules still answer


def test_wav_round_trip(tmp_path):
    wav = prompt_wav(0.25, seed=4)
    path = str(tmp_path / "sub" / "a.wav")
    save_wav(path, wav)
    back = load_wav(path)
    assert back.dtype == np.float32 and back.shape == wav.shape
    # 16-bit PCM: written as trunc(x * 32767) (one step at most), read as
    # / 32768 (|x| / 32768 more, under one step)
    np.testing.assert_allclose(back, wav, atol=2.0 / 32767)
    np.testing.assert_array_equal(back, jaudio.load_wav(path))
    jaudio.save_wav(str(tmp_path / "b.wav"), wav)
    with open(path, "rb") as f, open(tmp_path / "b.wav", "rb") as g:
        assert f.read() == g.read()
    save_wav(str(tmp_path / "c.wav"), wav, sr=8000)  # resampled on the way in
    assert load_wav(str(tmp_path / "c.wav")).shape == (2 * len(wav),)
    assert synth_filename("dir/p1.wav", 4, 8, 0.3, 0.5) == \
        jaudio.synth_filename("dir/p1.wav", 4, 8, 0.3, 0.5) == ("p1-4-8-0.3-0.5.wav", "nfe8-temp0.5")


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = small_config()
    cfg["codec_cfg"]["encoder"]["ngf"] = 4
    cfg["codec_cfg"]["decoder"]["upsample_initial_channel"] = 64
    with open(root / "config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    os.makedirs(root / "prompts")
    for i, name in enumerate(("p1.wav", "p2.wav")):
        save_wav(str(root / "prompts" / name), prompt_wav(0.4 + 0.2 * i, seed=i))
    return root


def _cli(root, *extra):
    args = syn.build_arg_parser().parse_args([
        "--ckpt-path", "random", "--cfg-path", str(root / "config.yaml"), "--codec-dir", "random",
        "--prompt-dir", str(root / "prompts"), "--device", "cpu", "--nsteps-durgen", "2",
        "--nsteps-denoiser", "2", "--seed", "3", *extra])
    return syn.main(args)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_cli_prompt_list_mode(cli_dirs, precision, capsys):
    out_dir = cli_dirs / f"out_{precision}"
    rtf = _cli(cli_dirs, "--text", "Hi there.", "--prompt-list", "p1.wav", "p2.wav",
               "--output-dir", str(out_dir), "--precision", precision)
    assert rtf is not None and rtf > 0 and "Avg RTF" in capsys.readouterr().out
    for stem in ("p1", "p2"):
        wav = load_wav(str(out_dir / f"{stem}-2-2-0.3-0.3.wav"))
        assert wav.size > 0 and wav.size % 200 == 0 and np.isfinite(wav).all()


def test_cli_metadata_mode(cli_dirs, capsys):
    meta = cli_dirs / "meta.txt"
    meta.write_text("a.wav|p1.wav|Hello.\nb.wav|p2.wav|Good morning to you.\nbroken line\n"
                    "c.wav|p1.wav|One more.\n")
    out_dir = cli_dirs / "out_meta"
    rtf = _cli(cli_dirs, "--metadata-file", str(meta), "--output-dir", str(out_dir),
               "--batch-size", "2")
    out = capsys.readouterr().out
    assert rtf is not None and "Malformed line skipped" in out and "batch 2/2 done" in out
    lens = [load_wav(str(out_dir / "nfe2-temp0.3" / n)).size for n in ("a.wav", "b.wav", "c.wav")]
    assert all(n > 0 and n % 200 == 0 for n in lens)
    # everything exists now: a second run has nothing to do
    assert _cli(cli_dirs, "--metadata-file", str(meta), "--output-dir", str(out_dir)) is None


def test_cli_argument_validation(cli_dirs):
    parser = syn.build_arg_parser()
    base = ["--ckpt-path", "random", "--cfg-path", "x"]
    with pytest.raises(ValueError, match="but not both"):
        syn._validate_args(parser.parse_args(base + ["--prompt-dir", "d"]))
    with pytest.raises(ValueError, match="--text is required"):
        syn._validate_args(parser.parse_args(base + ["--prompt-dir", "d", "--prompt-list", "a.wav"]))
    with pytest.raises(ValueError, match="prompt-dir"):
        syn._validate_args(parser.parse_args(base + ["--prompt-list", "a.wav", "--text", "hi"]))
    with pytest.raises(ValueError, match="not found"):
        syn._validate_args(parser.parse_args(base + ["--prompt-dir", "d", "--metadata-file", "/no/m"]))
    assert parser.parse_args(base).device == "cuda"  # the card unless the caller asks for the CPU
    # the root script's flags: a torch.profiler trace here, torch.load's weights_only
    args = parser.parse_args(base + ["--profile-dir", "x", "--weights-only", "false"])
    assert args.profile_dir == "x" and args.weights_only is False
    assert parser.parse_args(base).weights_only is True and parser.parse_args(base).profile_dir is None
    with pytest.raises(SystemExit):
        parser.parse_args(base + ["--weights-only", "maybe"])
