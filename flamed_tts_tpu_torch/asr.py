"""The phone recognizer of the evaluation tools: a framewise phone
classifier over log-mel frames (hop 200: one frame a codec frame), with a
speaker head, and the host-side decoders that turn its frame log-probs into
phones and lexicon words.

Model: Dense(80 -> D) -> N x [LayerNorm -> depthwise dilated conv (k5,
dilation 2**min(i, 5), SAME) -> tanh-GELU -> Dense(D -> D) + residual] ->
Dense(D -> N_CLASSES).  The speaker head mean-pools the trunk over (masked)
time, projects to SPK_EMB_DIM and L2-normalizes; ``spk_cls`` classifies that
embedding in training only.  The parameters are a dict of arrays with the
JAX package's names (``in_w``, ``layers[i]["dw"]``, ...), and the weights file
is its npz (``layers/{i}/dw``, ...): one file serves both packages.  The
model functions take a dict of tensors (``to_tensors``); the decoders are
numpy on the host.

``PhonemeRecognizer`` pads a wav with zeros to a whole number of seconds
before the log-mel and keeps the frames of the true length, as the JAX
package's recognizer does.  Its trainer (``train_asr.py``) pads with a
reflection of the wav instead, as the JAX trainer does, so the last few
frames before the true end differ between training and inference in both
packages.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.ops.melspec import mel_spectrogram
from flamed_tts_tpu_torch.text.frontend import read_lexicon
from flamed_tts_tpu_torch.text.neural_g2p import DEFAULT_LEXICON_DIR

BASE_PHONES = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG",
    "OW", "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W",
    "Y", "Z", "ZH",
]
SIL = 0  # covers sil/sp/spn/empty
PHONE_TO_ID: Dict[str, int] = {p: i + 1 for i, p in enumerate(BASE_PHONES)}
N_CLASSES = len(BASE_PHONES) + 1

# Widths of a new model; a weights file carries its own (the committed one
# is 192 wide with 6 layers).
D_MODEL = 256
N_LAYERS = 8
KERNEL = 5
SPK_EMB_DIM = 64
SR = 16000
HOP = 200

# The JAX package's data files, read in place: the committed recognizer
# weights and the built-in lexicon its word decoder searches.
DEFAULT_WEIGHTS = os.path.join(DEFAULT_LEXICON_DIR, "asr_weights.npz")
BUILTIN_LEXICON = os.path.join(DEFAULT_LEXICON_DIR, "english-core.txt")
LAYER_KEYS = ("dw", "pw_w", "pw_b", "ln_g", "ln_b")
SPEAKER_KEYS = ("spk_w", "spk_b", "spk_cls")


def phone_label(text: str) -> int:
    """A TextGrid phone ("AH0", "sil", "") -> its class id."""
    return PHONE_TO_ID.get(text.rstrip("012"), SIL)


# --- the model ------------------------------------------------------------


def init_params(rng: np.random.RandomState, n_speakers: Optional[int] = None,
                d_model: int = D_MODEL, n_layers: int = N_LAYERS) -> Dict:
    """Random numpy parameters: the JAX package's draws from ``rng`` in its
    order, so one seed gives the same weights in both packages.  With
    ``n_speakers``, the speaker head and its classifier too."""

    def dense(n_in, n_out):
        return (rng.randn(n_in, n_out) / np.sqrt(n_in)).astype(np.float32)

    params: Dict = {"in_w": dense(80, d_model), "in_b": np.zeros(d_model, np.float32), "layers": [],
                    "out_w": dense(d_model, N_CLASSES), "out_b": np.zeros(N_CLASSES, np.float32)}
    for _ in range(n_layers):
        params["layers"].append({"dw": (rng.randn(KERNEL, d_model) * 0.1).astype(np.float32),
                                 "pw_w": dense(d_model, d_model),
                                 "pw_b": np.zeros(d_model, np.float32),
                                 "ln_g": np.ones(d_model, np.float32),
                                 "ln_b": np.zeros(d_model, np.float32)})
    if n_speakers is not None:
        params["spk_w"] = dense(d_model, SPK_EMB_DIM)
        params["spk_b"] = np.zeros(SPK_EMB_DIM, np.float32)
        params["spk_cls"] = dense(SPK_EMB_DIM, n_speakers)
    return params


def to_tensors(params: Dict, device: Union[str, torch.device] = "cpu") -> Dict:
    """A parameter dict of arrays -> the same dict of float32 tensors
    (copies: an update in place leaves the arrays as they were)."""
    if isinstance(params, dict):
        return {k: to_tensors(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_tensors(v, device) for v in params]
    return torch.tensor(np.asarray(params, dtype=np.float32), device=device)


def to_numpy(params: Dict) -> Dict:
    """The inverse of ``to_tensors``."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [to_numpy(v) for v in params]
    return params.detach().cpu().numpy()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def _dilated_dwconv(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """Depthwise conv along time, SAME padding, as K shifted adds in the
    JAX package's order.  x (B, T, D), w (K, D)."""
    pad = (w.shape[0] // 2) * dilation
    xpad = F.pad(x, (0, 0, pad, pad))
    t = x.shape[1]
    out = torch.zeros_like(x)
    for k in range(w.shape[0]):
        out = out + xpad[:, k * dilation: k * dilation + t, :] * w[k]
    return out


def trunk(params: Dict, mel: torch.Tensor) -> torch.Tensor:
    """Log-mel (B, T, 80) -> trunk features (B, T, D)."""
    x = mel @ params["in_w"] + params["in_b"]
    for i, layer in enumerate(params["layers"]):
        h = F.layer_norm(x, x.shape[-1:], layer["ln_g"], layer["ln_b"], eps=1e-5)
        h = _dilated_dwconv(h, layer["dw"], 2 ** min(i, 5))
        x = x + (_gelu(h) @ layer["pw_w"] + layer["pw_b"])
    return x


def phone_head(params: Dict, h: torch.Tensor) -> torch.Tensor:
    return h @ params["out_w"] + params["out_b"]


def speaker_head(params: Dict, h: torch.Tensor, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trunk features (B, T, D) -> L2-normalized speaker embedding (B,
    SPK_EMB_DIM): the mean over the frames of ``frame_mask`` (all frames
    without one), projected."""
    if frame_mask is not None:
        w = frame_mask[..., None].to(h.dtype)
        pooled = (h * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
    else:
        pooled = h.mean(dim=1)
    e = pooled @ params["spk_w"] + params["spk_b"]
    return e / torch.sqrt((e * e).sum(dim=-1, keepdim=True) + 1e-12)


def forward(params: Dict, mel: torch.Tensor) -> torch.Tensor:
    """Log-mel (B, T, 80) -> frame logits (B, T, N_CLASSES)."""
    return phone_head(params, trunk(params, mel))


def speaker_embed(params: Dict, mel: torch.Tensor, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Log-mel (B, T, 80) -> L2-normalized utterance speaker embedding."""
    return speaker_head(params, trunk(params, mel), frame_mask)


# --- decoding (host, numpy) -------------------------------------------------


def collapse_frames(frame_ids: np.ndarray, min_run: int = 2) -> List[int]:
    """Framewise argmax ids -> phone sequence (drop sil, short runs)."""
    seq: List[int] = []
    run_id, run_len = -1, 0
    for fid in list(frame_ids) + [-2]:
        if fid == run_id:
            run_len += 1
            continue
        if run_id > SIL and run_len >= min_run:
            seq.append(int(run_id))
        run_id, run_len = fid, 1
    return seq


class LexiconTrie:
    """Phone-sequence trie over a word list for free word decoding."""

    def __init__(self, words_to_phones: Dict[str, Sequence[str]]):
        self.root: Dict = {}
        for word, phones in words_to_phones.items():
            node = self.root
            for pid in (phone_label(p) for p in phones):
                if pid == SIL:
                    continue
                node = node.setdefault(pid, {})
            node.setdefault("$", []).append(word)


def beam_decode_words(phone_ids: List[int], trie: LexiconTrie, beam: int = 24, sub_cost: float = 1.0,
                      indel_cost: float = 1.0, word_bonus: float = 0.4) -> List[str]:
    """Segment a phone sequence into lexicon words (weighted trie beam).

    State: (position in the phones, trie node, words so far, cost).
    Transitions: consume a phone on a matching trie edge (0), substitute
    (``sub_cost``), skip a phone (``indel_cost``), advance the trie without
    consuming (``indel_cost``), emit a word at a terminal node
    (-``word_bonus``, back to the root).  It never sees a reference
    transcript.
    """
    start = (0.0, 0, id(trie.root), trie.root, ())
    frontier: List[Tuple[float, int, int, Dict, tuple]] = [start]
    best_done: Optional[Tuple[float, tuple]] = None
    n = len(phone_ids)
    for _ in range(3 * n + 8):
        nxt: Dict[Tuple[int, int], Tuple[float, int, int, Dict, tuple]] = {}

        def push(cost, pos, node, words):
            key = (pos, id(node))
            old = nxt.get(key)
            if old is None or cost < old[0]:
                nxt[key] = (cost, pos, id(node), node, words)

        for cost, pos, _, node, words in frontier:
            if "$" in node:  # emit a finished word
                new_words = words + (node["$"][0],)
                if pos == n:
                    cand = (cost - word_bonus, new_words)
                    if best_done is None or cand[0] < best_done[0]:
                        best_done = cand
                push(cost - word_bonus, pos, trie.root, new_words)
            if pos < n:
                pid = phone_ids[pos]
                hit = node.get(pid)
                if hit is not None:  # match
                    push(cost, pos + 1, hit, words)
                for edge, child in node.items():  # substitution
                    if edge in ("$", pid):
                        continue
                    push(cost + sub_cost, pos + 1, child, words)
                push(cost + indel_cost, pos + 1, node, words)  # skip a phone
            for edge, child in node.items():  # trie advance (deletion)
                if edge != "$":
                    push(cost + indel_cost, pos, child, words)
        if not nxt:
            break
        frontier = sorted(nxt.values())[:beam]
        if best_done is not None and frontier and frontier[0][0] > best_done[0] + 4.0:
            break
    if best_done is not None:
        return list(best_done[1])
    return list(frontier[0][4]) if frontier else []  # the cheapest frontier's words


def viterbi_decode_words(logprobs: np.ndarray, trie: LexiconTrie, beam: int = 48,
                         word_penalty: float = 12.0, entry_penalty: float = 3.0) -> List[str]:
    """Frame-synchronous lexicon-constrained Viterbi beam over (T,
    N_CLASSES) log-posteriors.  Token states are (trie node, phone being
    consumed); a word end jumps back to the root with ``word_penalty``, each
    phone entry costs ``entry_penalty``; silence only at word boundaries."""
    root = trie.root
    states: Dict[Tuple[int, int], Tuple[float, Dict, tuple]] = {(id(root), SIL): (0.0, root, ())}
    for t in range(logprobs.shape[0]):
        lp = logprobs[t]
        nxt: Dict[Tuple[int, int], Tuple[float, Dict, tuple]] = {}

        def push(node, cur, score, words):
            key = (id(node), cur)
            old = nxt.get(key)
            if old is None or score > old[0]:
                nxt[key] = (score, node, words)

        for (_, cur), (score, node, words) in states.items():
            push(node, cur, score + lp[cur], words)  # continue the phone (or silence)
            for p, child in node.items():  # enter a new phone along a trie edge
                if p != "$":
                    push(child, p, score + lp[p] - entry_penalty, words)
            if "$" in node:  # word boundary: emit, back to the root
                nw = words + (node["$"][0],)
                s2 = score - word_penalty
                push(root, SIL, s2 + lp[SIL], nw)
                for p, child in root.items():
                    if p != "$":
                        push(child, p, s2 + lp[p] - entry_penalty, nw)
        states = dict(sorted(nxt.items(), key=lambda kv: -kv[1][0])[:beam])
    best: Optional[Tuple[float, tuple]] = None
    fallback: Optional[Tuple[float, tuple]] = None
    for score, node, words in states.values():
        if "$" in node:  # finish inside a completed word
            cand = (score - word_penalty, words + (node["$"][0],))
        elif node is root:  # finish at a word boundary
            cand = (score, words)
        else:  # mid-word: only if nothing completes
            if fallback is None or score > fallback[0]:
                fallback = (score, words)
            continue
        if best is None or cand[0] > best[0]:
            best = cand
    best = best or fallback
    return list(best[1]) if best else []


# --- weights io -------------------------------------------------------------


def save_weights(params: Dict, path: str) -> None:
    """Numpy parameters -> the npz both packages read."""
    flat = {k: params[k] for k in ("in_w", "in_b", "out_w", "out_b") + SPEAKER_KEYS if k in params}
    for i, layer in enumerate(params["layers"]):
        for key, val in layer.items():
            flat[f"layers/{i}/{key}"] = val
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_weights(path: Optional[str] = None) -> Optional[Dict]:
    """The npz at ``path`` (default: the committed weights) -> numpy
    parameters; None where there is no such file."""
    path = path or DEFAULT_WEIGHTS
    if not os.path.isfile(path):
        return None
    with np.load(path) as data:
        params: Dict = {k: data[k] for k in ("in_w", "in_b", "out_w", "out_b")}
        params.update({k: data[k] for k in SPEAKER_KEYS if k in data.files})
        params["layers"] = []
        i = 0
        while f"layers/{i}/dw" in data.files:
            params["layers"].append({k: data[f"layers/{i}/{k}"] for k in LAYER_KEYS})
            i += 1
    return params


class PhonemeRecognizer:
    """wav -> (phone sequence, free-decoded words), the model on
    ``device`` (the card unless the caller asks for the CPU) and the
    decoders on the host."""

    def __init__(self, weights_path: Optional[str] = None, lexicon: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None):
        params = load_weights(weights_path)
        if params is None:
            raise FileNotFoundError(weights_path or DEFAULT_WEIGHTS)
        self.device = resolve_device(device)
        self.params = params
        self.tensors = to_tensors(params, self.device)
        if lexicon is None:
            lexicon = read_lexicon(BUILTIN_LEXICON)
        self.trie = LexiconTrie(lexicon)
        # homophone classes: the decoder emits ONE spelling per trie
        # terminal, so WER scoring maps each word to its pronunciation class
        self._canon: Dict[str, str] = {}
        for word, phones in lexicon.items():
            key = " ".join(str(phone_label(p)) for p in phones if phone_label(p) != SIL)
            self._canon[word.lower()] = f"~{key}"

    def canon(self, word: str) -> str:
        """Word -> pronunciation-class key (homophones map together)."""
        return self._canon.get(word.lower(), word.lower())

    def mel(self, wav: np.ndarray) -> torch.Tensor:
        """(1, T, 80) log-mel on the device of the wav zero-padded to whole
        seconds, cut to the true length's frames."""
        true_frames = len(wav) // HOP
        wav = np.pad(np.asarray(wav, dtype=np.float32), (0, (-len(wav)) % SR))
        mel = mel_spectrogram(torch.as_tensor(wav, device=self.device)[None])
        return mel[0].T[None, :true_frames]

    @torch.no_grad()
    def frame_logits(self, wav: np.ndarray) -> np.ndarray:
        """(T, N_CLASSES) float32 on the host."""
        return forward(self.tensors, self.mel(wav))[0].cpu().numpy()

    def frame_ids(self, wav: np.ndarray) -> np.ndarray:
        return np.argmax(self.frame_logits(wav), axis=-1)

    @staticmethod
    def decode_phones(logits: np.ndarray) -> List[str]:
        return [BASE_PHONES[i - 1] for i in collapse_frames(np.argmax(logits, axis=-1))]

    def decode_words(self, logits: np.ndarray) -> str:
        lmax = logits.max(axis=-1, keepdims=True)
        logprobs = logits - (lmax + np.log(np.exp(logits - lmax).sum(-1, keepdims=True)))
        return " ".join(viterbi_decode_words(logprobs, self.trie))

    def transcribe(self, wav: np.ndarray) -> Tuple[List[str], str]:
        logits = self.frame_logits(wav)
        return self.decode_phones(logits), self.decode_words(logits)

    @torch.no_grad()
    def speaker_embedding(self, wav: np.ndarray) -> np.ndarray:
        """(SPK_EMB_DIM,) learned speaker embedding of a waveform; needs
        weights trained with a speaker head."""
        if "spk_w" not in self.params:
            raise ValueError("ASR weights were trained without a speaker head")
        return speaker_embed(self.tensors, self.mel(wav))[0].cpu().numpy()
