"""Train the neural G2P (``text/neural_g2p.py``) on the lexicon, as the JAX
package's ``tools/train_g2p.py`` does, on the card:

    python -m flamed_tts_tpu_torch.train_g2p --out g2p_weights.npz \
        [--epochs 120] [--batch 256] [--lr 3e-4] [--dropout 0.15] \
        [--label-smooth 0.1] [--seed 0] [--limit N] [--device cuda|cpu] \
        [--lexicon-dir DIR]

The JAX tool's flags, with ``--device`` ``cuda`` (the default) or ``cpu``.
``--out`` is required: the JAX default writes into the JAX package's
``lexicon/`` directory.  The held-out gold sets (``g2p_heldout.txt``,
``g2p_gold_heldout.txt``) go beside ``--out``.  The lexicons are read in
place from ``--lexicon-dir`` (by default the JAX package's ``lexicon/``).

What is the JAX tool's, bit for bit: the dataset (``build_dataset``: the
held-out split, the morphological augmentation over train stems with its
``RandomState`` shuffle, the synthetic names), the arrays, the initial
parameters (``init_params`` from ``RandomState(seed)``), the epoch order
(``RandomState(seed + 1)``).  The update is optax's
``chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay, weight_decay
1e-4))`` with no ``apply_if_finite`` (``train_codec.FiniteAdam`` with
``if_finite=False``), the loss the label-smoothed cross entropy over the
target's valid positions.  As in the JAX tool the sinusoid position table
is trained with the rest and dropped at save, where ``load_weights``
rebuilds it.  The dropout masks (ten a step, one per residual branch, in
the order the forward uses them) come from a ``torch.Generator`` seeded
with ``--seed``, or are passed in (``loss_fn(masks=...)``), which is how a
test hands both implementations the same ones.  The saved ``.npz`` loads in
both packages' ``neural_g2p``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.text import neural_g2p as g2p
from flamed_tts_tpu_torch.text.frontend import inflect_oov, read_lexicon
from flamed_tts_tpu_torch.text.g2p_fallback import rule_g2p
from flamed_tts_tpu_torch.train_codec import FiniteAdam, cosine_schedule

CORE_LEXICON = "english-core.txt"
GOLD_LEXICON = "proper-nouns-gold.txt"

_NAME_ONSETS = {
    "brad": "B R AE1 D", "carl": "K AA1 R L", "clark": "K L AA1 R K",
    "dav": "D EY1 V", "ed": "EH1 D", "frank": "F R AE1 NG K",
    "gar": "G AA1 R", "har": "HH AE1 R", "hen": "HH EH1 N",
    "jack": "JH AE1 K", "john": "JH AA1 N", "lin": "L IH1 N",
    "mar": "M AA1 R", "nor": "N AO1 R", "os": "AA1 S",
    "pat": "P AE1 T", "rob": "R AA1 B", "rich": "R IH1 CH",
    "stan": "S T AE1 N", "tom": "T AA1 M", "walt": "W AO1 L T",
    "wat": "W AA1 T", "west": "W EH1 S T", "wil": "W IH1 L",
    "ash": "AE1 SH", "black": "B L AE1 K", "brook": "B R UH1 K",
    "fair": "F EH1 R", "glen": "G L EH1 N", "green": "G R IY1 N",
    "hill": "HH IH1 L", "kings": "K IH1 NG Z", "lake": "L EY1 K",
    "long": "L AO1 NG", "mill": "M IH1 L", "oak": "OW1 K",
    "ray": "R EY1", "stone": "S T OW1 N", "spring": "S P R IH1 NG",
}
_NAME_SUFFIXES = {
    "son": "S AH0 N", "ton": "T AH0 N", "ville": "V IH2 L",
    "ford": "F ER0 D", "berg": "B ER0 G", "burg": "B ER0 G",
    "land": "L AH0 N D", "wood": "W UH2 D", "field": "F IY2 L D",
    "man": "M AH0 N", "worth": "W ER0 TH", "ley": "L IY0",
    "by": "B IY0", "dale": "D EY2 L", "mont": "M AA2 N T",
    "well": "W EH2 L", "ington": "IH0 NG T AH0 N",
}


def synthetic_names():
    """Compound proper names from authored morphemes: the onset keeps
    primary stress, the suffix reduces — the dominant stress pattern of
    English surnames/toponyms ("Bradford", "Hillsdale", "Watson")."""
    out = {}
    for on, on_ph in _NAME_ONSETS.items():
        for sfx, sfx_ph in _NAME_SUFFIXES.items():
            out[on + sfx] = (on_ph + " " + sfx_ph).split()
    return out


def build_dataset(heldout_every: int = 20, aug_ratio: float = 1.0, seed: int = 0,
                  lexicon_dir: str = g2p.DEFAULT_LEXICON_DIR):
    """(train lexicon, names, held-out lexicon, held-out gold names, base
    count, augmented count), as the JAX tool builds them: every 20th core
    word (index 7 mod 20) and the odd-indexed gold names are held out;
    inflections of train stems (capped at ``aug_ratio`` x base, shuffled by
    ``RandomState(seed)``) that collide with neither join the train set."""
    lex = read_lexicon(os.path.join(lexicon_dir, CORE_LEXICON))
    gold = read_lexicon(os.path.join(lexicon_dir, GOLD_LEXICON))
    gold_sorted = sorted(gold)
    gold_train = {w: gold[w] for w in gold_sorted[0::2]}
    gold_eval = {w: gold[w] for w in gold_sorted[1::2]}
    words = sorted(lex.keys())
    heldout = {w for i, w in enumerate(words) if i % heldout_every == 7}
    heldout |= set(gold_eval)
    train = {w: lex[w] for w in words if w not in heldout}

    candidates = []
    lookup = train.get
    suffix_forms = ("s", "es", "ed", "ing", "ly", "er", "est", "ness")
    for stem in sorted(train):
        if len(stem) < 3:
            continue
        for sfx in suffix_forms:
            for surface in _surface_forms(stem, sfx):
                if surface in train or surface in heldout:
                    continue
                phones = inflect_oov(surface, lookup)
                if phones:
                    candidates.append((surface, phones))
    rng = np.random.RandomState(seed)
    rng.shuffle(candidates)
    aug = dict(candidates[: int(aug_ratio * len(train))])
    merged = dict(train)
    merged.update(aug)
    names = dict(gold_train)
    names.update({w: p for w, p in synthetic_names().items()
                  if w not in heldout and w not in gold_eval})
    heldout_lex = {w: lex[w] for w in heldout if w in lex}
    return merged, names, heldout_lex, gold_eval, len(train), len(aug)


def _surface_forms(stem: str, sfx: str):
    """Plausible spellings of stem+suffix (inverse of _stem_candidates)."""
    forms = [stem + sfx]
    if stem.endswith("e") and sfx in ("ed", "ing", "er", "est", "es"):
        forms.append(stem[:-1] + sfx)  # make -> making
    if stem.endswith("y") and sfx in ("s", "ed", "er", "est", "ness"):
        mapped = {"s": "ies", "ed": "ied", "er": "ier", "est": "iest", "ness": "iness"}
        forms.append(stem[:-1] + mapped[sfx])  # carry -> carried
    return forms


def to_arrays(pairs):
    """(word, phones) pairs -> padded int32 (N, MAX_SRC) sources and (N,
    MAX_TGT) targets; a pair either side cannot encode is skipped."""
    srcs, tgts = [], []
    for word, phones in pairs:
        s = g2p.encode_word(word)
        t = g2p.encode_phones(phones)
        if s is None or t is None:
            continue
        srcs.append(np.pad(s, (0, g2p.MAX_SRC - len(s))))
        tgts.append(np.pad(t, (0, g2p.MAX_TGT - len(t))))
    return np.stack(srcs).astype(np.int32), np.stack(tgts).astype(np.int32)


def init_params(rng: np.random.RandomState) -> Dict:
    """The JAX tool's initial parameters, drawn from ``rng`` in its order."""
    def dense(n_in, n_out):
        return (rng.randn(n_in, n_out) * (1.0 / np.sqrt(n_in))).astype(np.float32)

    def attn():
        return {"wq": dense(g2p.D_MODEL, g2p.D_MODEL), "wk": dense(g2p.D_MODEL, g2p.D_MODEL),
                "wv": dense(g2p.D_MODEL, g2p.D_MODEL), "wo": dense(g2p.D_MODEL, g2p.D_MODEL)}

    def ffn():
        return {"w1": dense(g2p.D_MODEL, g2p.D_FF), "b1": np.zeros(g2p.D_FF, np.float32),
                "w2": dense(g2p.D_FF, g2p.D_MODEL), "b2": np.zeros(g2p.D_MODEL, np.float32)}

    def lns(names):
        out = {}
        for name in names:
            out[f"{name}_g"] = np.ones(g2p.D_MODEL, np.float32)
            out[f"{name}_b"] = np.zeros(g2p.D_MODEL, np.float32)
        return out

    return {
        "src_emb": (rng.randn(g2p.SRC_SIZE, g2p.D_MODEL) * 0.02).astype(np.float32),
        "tgt_emb": (rng.randn(g2p.TGT_SIZE, g2p.D_MODEL) * 0.02).astype(np.float32),
        "enc": [{"attn": attn(), "ffn": ffn(), **lns(["ln1", "ln2"])} for _ in range(g2p.N_ENC)],
        "dec": [{"self": attn(), "cross": attn(), "ffn": ffn(), **lns(["ln1", "ln2", "ln3"])}
                for _ in range(g2p.N_DEC)],
        "enc_ln_g": np.ones(g2p.D_MODEL, np.float32),
        "enc_ln_b": np.zeros(g2p.D_MODEL, np.float32),
        "dec_ln_g": np.ones(g2p.D_MODEL, np.float32),
        "dec_ln_b": np.zeros(g2p.D_MODEL, np.float32),
        "out_w": dense(g2p.D_MODEL, g2p.TGT_SIZE),
        "out_b": np.zeros(g2p.TGT_SIZE, np.float32),
    }


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree) -> List:
    """The tree's leaves in key order (a fixed order for the optimizer)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


# --- the transformer in torch (the JAX tool runs neural_g2p's xp code) ----

def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x * x * x)))


def _layernorm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def _mha(p, q_in, kv_in, mask):
    d_head = g2p.D_MODEL // g2p.N_HEADS

    def split(x):  # [B, L, D] -> [B, H, L, d]
        b, l, _ = x.shape
        return x.reshape(b, l, g2p.N_HEADS, d_head).permute(0, 2, 1, 3)

    q, k, v = split(q_in @ p["wq"]), split(kv_in @ p["wk"]), split(kv_in @ p["wv"])
    scores = q @ k.transpose(-1, -2) / np.float32(np.sqrt(d_head)) + mask
    scores = scores - scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores)
    out = (e / e.sum(dim=-1, keepdim=True)) @ v
    b, _, lq, _ = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, lq, g2p.D_MODEL) @ p["wo"]


def _ffn(p, x):
    return _gelu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def forward_logits(p: Dict, src: torch.Tensor, tgt_in: torch.Tensor, drop=lambda x: x) -> torch.Tensor:
    """Teacher-forced logits [B, Lt, TGT_SIZE] (neural_g2p.forward_logits of
    the JAX package); ``drop`` is applied to every residual branch."""
    neg = torch.tensor(-1e9, dtype=torch.float32, device=src.device)
    zero = torch.zeros((), dtype=torch.float32, device=src.device)
    mem_pad = src == g2p.PAD
    x = p["src_emb"][src] + p["pos"][: src.shape[1]]
    attn_mask = torch.where(mem_pad[:, None, None, :], neg, zero)
    for layer in p["enc"]:
        h = _layernorm(x, layer["ln1_g"], layer["ln1_b"])
        x = x + drop(_mha(layer["attn"], h, h, attn_mask))
        h = _layernorm(x, layer["ln2_g"], layer["ln2_b"])
        x = x + drop(_ffn(layer["ffn"], h))
    memory = _layernorm(x, p["enc_ln_g"], p["enc_ln_b"])

    lt = tgt_in.shape[1]
    x = p["tgt_emb"][tgt_in] + p["pos"][:lt]
    causal = torch.from_numpy(np.triu(np.full((lt, lt), -1e9, dtype=np.float32), k=1)).to(src.device)
    self_mask = causal[None, None] + torch.where((tgt_in == g2p.PAD)[:, None, None, :], neg, zero)
    cross_mask = torch.where(mem_pad[:, None, None, :], neg, zero)
    for layer in p["dec"]:
        h = _layernorm(x, layer["ln1_g"], layer["ln1_b"])
        x = x + drop(_mha(layer["self"], h, h, self_mask))
        h = _layernorm(x, layer["ln2_g"], layer["ln2_b"])
        x = x + drop(_mha(layer["cross"], h, memory, cross_mask))
        h = _layernorm(x, layer["ln3_g"], layer["ln3_b"])
        x = x + drop(_ffn(layer["ffn"], h))
    x = _layernorm(x, p["dec_ln_g"], p["dec_ln_b"])
    return x @ p["out_w"] + p["out_b"]


def draw_masks(batch: int, dropout: float, generator: torch.Generator, device) -> List[torch.Tensor]:
    """The ten keep masks of one step, in the forward's order: per encoder
    layer (attention, FFN) over (B, MAX_SRC, D), per decoder layer (self,
    cross, FFN) over (B, MAX_TGT - 1, D)."""
    shapes = ([(batch, g2p.MAX_SRC, g2p.D_MODEL)] * (2 * g2p.N_ENC)
              + [(batch, g2p.MAX_TGT - 1, g2p.D_MODEL)] * (3 * g2p.N_DEC))
    return [torch.rand(s, generator=generator, device=device) >= dropout for s in shapes]


def loss_fn(p: Dict, src: torch.Tensor, tgt: torch.Tensor, masks: Sequence[torch.Tensor],
            dropout: float, label_smooth: float) -> torch.Tensor:
    """The label-smoothed cross entropy over the target's valid positions,
    with dropout by the keep ``masks`` (kept values scaled by 1 / (1 - p))."""
    calls = iter(masks)

    def drop(x):
        return torch.where(next(calls), x / (1.0 - dropout), torch.zeros((), device=x.device))

    tgt_in, tgt_out = tgt[:, :-1], tgt[:, 1:]
    logits = forward_logits(p, src, tgt_in, drop)
    valid = (tgt_out != g2p.PAD).float()
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(tgt_out.long(), g2p.TGT_SIZE).float()
    smoothed = (1 - label_smooth) * onehot + label_smooth / g2p.TGT_SIZE
    ce = -(smoothed * logp).sum(-1)
    return (ce * valid).sum() / valid.sum()


def make_optimizer(p: Dict, lr: float, total_steps: int) -> FiniteAdam:
    """The JAX tool's chain over ``leaves(p)``: clip to global norm 1, AdamW
    at weight decay 1e-4 on warmup_cosine_decay(0, lr, min(1000, total / 10),
    total, 0.05 lr)."""
    return FiniteAdam(leaves(p), cosine_schedule(lr, min(1000, total_steps // 10), total_steps,
                                                 lr * 0.05),
                      weight_decay=1e-4, if_finite=False)


def train_step(p: Dict, opt: FiniteAdam, src: torch.Tensor, tgt: torch.Tensor,
               masks: Sequence[torch.Tensor], dropout: float, label_smooth: float) -> torch.Tensor:
    """One update of ``p`` in place; returns the loss before it."""
    loss = loss_fn(p, src, tgt, masks, dropout, label_smooth)
    opt.step(list(torch.autograd.grad(loss, opt.params)))
    return loss.detach()


def to_numpy_weights(p: Dict) -> Dict:
    """The trained tree as numpy, without the position table (as saved)."""
    out = tree_map(lambda t: t.detach().cpu().numpy(), p)
    out.pop("pos", None)
    return out


def save_weights(p: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **g2p.flatten(to_numpy_weights(p)))


def per(hyp, ref):
    """Levenshtein phone error count."""
    dist = np.arange(len(ref) + 1)
    for i, h in enumerate(hyp, 1):
        prev, dist[0] = dist[0], i
        for j, r in enumerate(ref, 1):
            cur = min(dist[j] + 1, dist[j - 1] + 1, prev + (h != r))
            prev, dist[j] = dist[j], cur
    return int(dist[-1])


def evaluate(params, gold, tag, log=print):
    """(PER with stress, PER of base phones) of greedy decoding over
    ``gold``; prints the JAX tool's line."""
    err_s = tot_s = err_b = tot_b = exact = 0
    strip = lambda seq: [q.rstrip("012") for q in seq]  # noqa: E731
    for word, ref in sorted(gold.items()):
        src = g2p.encode_word(word)
        if src is None:
            continue
        hyp = g2p.ids_to_phones(g2p.greedy_decode(params, src))
        err_s += per(hyp, ref)
        tot_s += len(ref)
        err_b += per(strip(hyp), strip(ref))
        tot_b += len(ref)
        exact += int(hyp == ref)
    n = len(gold)
    log(f"[{tag}] PER(stress)={err_s / max(tot_s, 1):.4f} PER(base)={err_b / max(tot_b, 1):.4f} "
        f"word-acc={exact / max(n, 1):.3f} (n={n})")
    return err_s / max(tot_s, 1), err_b / max(tot_b, 1)


def rule_baseline(gold):
    err = tot = 0
    for word, ref in gold.items():
        hyp = rule_g2p(word)
        err += per([q.rstrip("012") for q in hyp], [q.rstrip("012") for q in ref])
        tot += len(ref)
    print(f"[rule-engine baseline] PER(base)={err / max(tot, 1):.4f}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.train_g2p",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=120)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--dropout", type=float, default=0.15)
    parser.add_argument("--label-smooth", type=float, default=0.1)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--limit", type=int, default=0, help="Smoke mode: train on only N examples.")
    parser.add_argument("--out", required=True, help="The weights file (.npz) to write.")
    parser.add_argument("--lexicon-dir", default=g2p.DEFAULT_LEXICON_DIR,
                        help="Where english-core.txt and proper-nouns-gold.txt are read.")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Trains, saves and evaluates; returns {"step_ms": median step time,
    "steps", "loss" (last epoch's mean), "heldout_per", "gold_per" (with
    stress)}."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    train_lex, names, heldout, gold_eval, n_base, n_aug = build_dataset(lexicon_dir=args.lexicon_dir)
    print(f"train: {n_base} lexicon + {n_aug} augmented + {len(names)} names (x4); "
          f"held-out: {len(heldout)} common + {len(gold_eval)} gold names")
    src, tgt = to_arrays(sorted(train_lex.items()) + 4 * sorted(names.items()))
    if args.limit:
        src, tgt = src[: args.limit], tgt[: args.limit]
    n = src.shape[0]
    print(f"examples: {n}  (src {src.shape}, tgt {tgt.shape}) on {device}")

    params = init_params(np.random.RandomState(args.seed))
    params["pos"] = g2p.sinusoid_table(max(g2p.MAX_SRC, g2p.MAX_TGT), g2p.D_MODEL)
    p = tree_map(lambda a: torch.from_numpy(a).to(device).requires_grad_(), params)
    steps_per_epoch = max(n // args.batch, 1)
    total_steps = steps_per_epoch * args.epochs
    opt = make_optimizer(p, args.lr, total_steps)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    src_t, tgt_t = torch.from_numpy(src).to(device), torch.from_numpy(tgt).to(device)

    rng_np = np.random.RandomState(args.seed + 1)
    t0 = time.time()
    step, step_s, loss = 0, [], float("nan")
    for epoch in range(args.epochs):
        order = rng_np.permutation(n)
        losses = []
        for b in range(steps_per_epoch):
            idx = order[b * args.batch: (b + 1) * args.batch]
            if len(idx) < args.batch:  # the JAX tool's static shapes: wrap around
                idx = np.concatenate([idx, order[: args.batch - len(idx)]])
            idx_t = torch.from_numpy(idx).to(device)
            t_step = time.perf_counter()
            masks = draw_masks(len(idx), args.dropout, generator, device)
            losses.append(train_step(p, opt, src_t[idx_t], tgt_t[idx_t], masks, args.dropout,
                                     args.label_smooth))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - t_step)
            step += 1
        if epoch % 10 == 9 or epoch == 0 or epoch == args.epochs - 1:
            loss = float(torch.stack(losses).mean())
            print(f"epoch {epoch + 1}/{args.epochs} loss={loss:.4f} ({step} steps, "
                  f"{time.time() - t0:.0f}s)", flush=True)
        if epoch % 10 == 9 and epoch != args.epochs - 1:
            save_weights(p, args.out)  # an interrupted run still leaves weights

    save_weights(p, args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    out_dir = os.path.dirname(os.path.abspath(args.out))
    with open(os.path.join(out_dir, "g2p_heldout.txt"), "w") as fout:
        for word in sorted(heldout):
            fout.write(f"{word.upper()}\t{' '.join(heldout[word])}\n")
    with open(os.path.join(out_dir, "g2p_gold_heldout.txt"), "w") as fout:
        for word in sorted(gold_eval):
            fout.write(f"{word.upper()}\t{' '.join(gold_eval[word])}\n")

    loaded = g2p.load_weights(args.out)
    rule_baseline(heldout)
    heldout_per = evaluate(loaded, heldout, "held-out")[0]
    rule_baseline(gold_eval)
    gold_per = evaluate(loaded, gold_eval, "proper-nouns-heldout")[0]
    return {"step_ms": 1e3 * float(np.median(step_s)), "steps": step, "loss": loss,
            "heldout_per": heldout_per, "gold_per": gold_per}


if __name__ == "__main__":
    main()
