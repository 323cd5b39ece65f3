"""Compact neural grapheme-to-phoneme model (char -> ARPAbet).

A small encoder-decoder transformer trained on the bundled lexicon; it is
the frontend's fallback for words the lexicons and the inflection rules
miss, ahead of the letter-to-sound rules.  The weights are the JAX
package's ``flamed_tts_tpu/lexicon/g2p_weights.npz``, read in place.

* The forward pass is plain numpy on the host: the frontend needs no
  device, and a word decodes in about a millisecond.
* Greedy decoding; words are short (<= 18 chars / 15 phones in the
  lexicon), so a beam buys little.
* Pre-LN transformer, sinusoidal positions, tanh-approximated GELU.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from flamed_tts_tpu_torch.text.inventories import ARPABET_SYMBOLS

# --- vocabularies -------------------------------------------------------

PAD, BOS, EOS = 0, 1, 2
SRC_CHARS = "abcdefghijklmnopqrstuvwxyz'-"
SRC_VOCAB: Dict[str, int] = {c: i + 3 for i, c in enumerate(SRC_CHARS)}
SRC_SIZE = len(SRC_VOCAB) + 3

# Output tokens: the 84 stress-marked ARPAbet symbols used by the symbol
# table (inventories.py) — the exact inventory text_to_sequence accepts.
TGT_SYMS: List[str] = list(ARPABET_SYMBOLS)
TGT_VOCAB: Dict[str, int] = {s: i + 3 for i, s in enumerate(TGT_SYMS)}
TGT_SIZE = len(TGT_SYMS) + 3

MAX_SRC = 20   # 18 chars + BOS/EOS
MAX_TGT = 20   # 15 phones + BOS/EOS headroom

# Model dims (kept in the weights file too, for forward compatibility).
D_MODEL = 192
N_HEADS = 4
N_ENC = 2
N_DEC = 2
D_FF = 4 * D_MODEL


def encode_word(word: str) -> Optional[np.ndarray]:
    """Char ids [L] with BOS/EOS, or None if nothing encodable."""
    ids = [SRC_VOCAB[c] for c in word.lower() if c in SRC_VOCAB]
    if not ids:
        return None
    ids = ids[: MAX_SRC - 2]
    return np.asarray([BOS] + ids + [EOS], dtype=np.int32)


def encode_phones(phones: List[str]) -> Optional[np.ndarray]:
    """Phone ids [L] with BOS/EOS, or None where a phone is not in the
    inventory (the training targets of ``train_g2p``)."""
    ids = [TGT_VOCAB[p] for p in phones if p in TGT_VOCAB]
    if not ids or len(ids) != len(phones):
        return None
    ids = ids[: MAX_TGT - 2]
    return np.asarray([BOS] + ids + [EOS], dtype=np.int32)


# --- the transformer, pure functions over a parameter dict -------------


def _gelu(x):
    # tanh approximation, as the weights were trained with
    return 0.5 * x * (1.0 + np.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def _layernorm(x, g, b, eps=1e-5):
    mu = x.mean(axis=-1, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * g + b


def _softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def sinusoid_table(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / dim)
    table = np.zeros((length, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _mha(p, q_in, kv_in, mask):
    """Multi-head attention.  mask: additive [..., Lq, Lk] or None."""
    d_head = D_MODEL // N_HEADS

    def proj(x, w):  # [..., L, D] @ [D, D]
        return x @ w

    q = proj(q_in, p["wq"])
    k = proj(kv_in, p["wk"])
    v = proj(kv_in, p["wv"])

    def split(x):  # [B, L, D] -> [B, H, L, d]
        B, L, _ = x.shape
        return x.reshape(B, L, N_HEADS, d_head).transpose(0, 2, 1, 3)

    q, k, v = split(q), split(k), split(v)
    scores = q @ k.transpose(0, 1, 3, 2) / np.sqrt(d_head).astype(np.float32)
    if mask is not None:
        scores = scores + mask
    attn = _softmax(scores)
    out = attn @ v  # [B, H, Lq, d]
    B, H, Lq, _ = out.shape
    out = out.transpose(0, 2, 1, 3).reshape(B, Lq, D_MODEL)
    return out @ p["wo"]


def _ffn(p, x):
    return _gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def encode(params, src):  # src: [B, Ls] int
    pad_mask = (src == PAD)  # [B, Ls]
    x = params["src_emb"][src] + params["pos"][: src.shape[1]]
    attn_mask = np.where(pad_mask[:, None, None, :], -1e9, 0.0)
    for layer in params["enc"]:
        h = _layernorm(x, layer["ln1_g"], layer["ln1_b"])
        x = x + _mha(layer["attn"], h, h, attn_mask)
        h = _layernorm(x, layer["ln2_g"], layer["ln2_b"])
        x = x + _ffn(layer["ffn"], h)
    x = _layernorm(x, params["enc_ln_g"], params["enc_ln_b"])
    return x, pad_mask


def decode_logits(params, memory, mem_pad, tgt):
    """Teacher-forced decoder logits [B, Lt, TGT_SIZE]."""
    Lt = tgt.shape[1]
    x = params["tgt_emb"][tgt] + params["pos"][:Lt]
    causal = np.triu(np.full((Lt, Lt), -1e9, dtype=np.float32), k=1)
    self_mask = np.asarray(causal)[None, None] + np.where(
        (tgt == PAD)[:, None, None, :], -1e9, 0.0
    )
    cross_mask = np.where(mem_pad[:, None, None, :], -1e9, 0.0)
    for layer in params["dec"]:
        h = _layernorm(x, layer["ln1_g"], layer["ln1_b"])
        x = x + _mha(layer["self"], h, h, self_mask)
        h = _layernorm(x, layer["ln2_g"], layer["ln2_b"])
        x = x + _mha(layer["cross"], h, memory, cross_mask)
        h = _layernorm(x, layer["ln3_g"], layer["ln3_b"])
        x = x + _ffn(layer["ffn"], h)
    x = _layernorm(x, params["dec_ln_g"], params["dec_ln_b"])
    return x @ params["out_w"] + params["out_b"]


# --- host-side greedy decoding (numpy) ----------------------------------


def greedy_decode(params, src: np.ndarray, max_len: int = MAX_TGT) -> List[int]:
    """Greedy phone-id sequence for one encoded word [Ls]."""
    src = src[None, :]
    memory, mem_pad = encode(params, src)
    tgt = [BOS]
    for _ in range(max_len - 1):
        logits = decode_logits(params, memory, mem_pad, np.asarray(tgt, dtype=np.int32)[None, :])
        nxt = int(np.argmax(logits[0, -1]))
        if nxt == EOS:
            break
        tgt.append(nxt)
    return tgt[1:]


def ids_to_phones(ids: List[int]) -> List[str]:
    return [TGT_SYMS[i - 3] for i in ids if i >= 3]


# --- weights io ----------------------------------------------------------

DEFAULT_LEXICON_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "flamed_tts_tpu", "lexicon",
)
_DEFAULT_WEIGHTS = os.path.join(DEFAULT_LEXICON_DIR, "g2p_weights.npz")


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    params: Dict = {"enc": [{} for _ in range(N_ENC)], "dec": [{} for _ in range(N_DEC)]}
    for key, val in flat.items():
        parts = key.split("/")
        node = params
        for part in parts[:-1]:
            if isinstance(node, list):
                node = node[int(part)]
            else:
                node = node.setdefault(part, {})
        node[parts[-1]] = val
    return params


def flatten(params: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """The parameter tree as the weights file's flat "enc/0/attn/wq" keys
    (the inverse of ``_unflatten``)."""
    flat: Dict[str, np.ndarray] = {}
    if isinstance(params, list):
        for i, item in enumerate(params):
            flat.update(flatten(item, f"{prefix}{i}/"))
    elif isinstance(params, dict):
        for key, val in params.items():
            flat.update(flatten(val, f"{prefix}{key}/"))
    else:
        flat[prefix[:-1]] = np.asarray(params)
    return flat


def load_weights(path: Optional[str] = None) -> Optional[Dict]:
    path = path or _DEFAULT_WEIGHTS
    if not os.path.isfile(path):
        return None
    with np.load(path) as data:
        flat = {k: data[k].astype(np.float32) for k in data.files if k != "_meta"}
    params = _unflatten(flat)
    params["pos"] = sinusoid_table(max(MAX_SRC, MAX_TGT), D_MODEL)
    return params


class NeuralG2P:
    """Word -> ARPAbet phones via the committed transformer weights."""

    def __init__(self, weights_path: Optional[str] = None):
        params = load_weights(weights_path)
        if params is None:
            raise FileNotFoundError(weights_path or _DEFAULT_WEIGHTS)
        self.params = params
        self._cache: Dict[str, List[str]] = {}

    def __call__(self, word: str) -> List[str]:
        key = word.lower()
        hit = self._cache.get(key)
        if hit is not None:
            return list(hit)
        src = encode_word(key)
        if src is None:
            return []
        phones = ids_to_phones(greedy_decode(self.params, src))
        self._cache[key] = phones
        return list(phones)


def try_load_neural_g2p(weights_path: Optional[str] = None) -> Optional[NeuralG2P]:
    try:
        return NeuralG2P(weights_path)
    except FileNotFoundError:
        return None
