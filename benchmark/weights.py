"""Weights the benchmark makes from the seed, on the device: the same
values whoever asks, so the program and the reference are handed the same.

``flamed_state``: every parameter of the prior and prob generators drawn
in one call of a ``torch.Generator`` on the device, then scaled: fan-in
normal for matrices, convolutions and embedding tables, zero biases, unit
norm weights.  The duration and silence flows are then pinned: their
output layers give the constant velocities ``duration_bias`` and
``silence_bias``, so a phoneme lasts round(e^(b + 0.3 n) - 1) frames for a
standard normal n (mean 6.33 at b = log 7: a trained model's rate) and a
silence almost never.  There are no trained prior or prob weights.

``codec_tree``: a codec's flat parameter tree (the checkpoint's paths)
with random values, for configurations that run without the trained
codec.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

PIN = ("duration_generator", "sil_generator")


def fill(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if name.endswith(".bias"):
            v = torch.zeros_like(v)
        elif len(shape) == 1:
            v = torch.ones_like(v)
        else:
            v = v * (1.0 / math.sqrt(n // shape[0]))
        out[name] = v
    return out


def flamed_state(shapes: Dict[str, Dict[str, torch.Size]], seed: int, device,
                 duration_bias: float, silence_bias: float) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"prior": state dict, "prob": state dict} for the parameter shapes
    given, float32 on ``device``."""
    prior = fill(shapes["prior"], seed, device)
    prob = fill(shapes["prob"], seed + 1, device)
    for name, bias in zip(PIN, (duration_bias, silence_bias)):
        prior[f"{name}.linear_layer.weight"] = torch.zeros_like(prior[f"{name}.linear_layer.weight"])
        prior[f"{name}.linear_layer.bias"] = torch.full_like(prior[f"{name}.linear_layer.bias"], bias)
    return {"prior": prior, "prob": prob}


def codec_tree(seed: int, enc: Dict, dec: Dict, timbre: Dict) -> Dict[str, Dict[str, np.ndarray]]:
    """{"encoder", "decoder"}: flat trees of the checkpoint's structure,
    fan-in normal convs, zero biases and snake logs, unit norms; the output
    conv scaled by 0.01 so the tanh starts in its linear region."""
    r = np.random.default_rng(abs(int(seed)))

    def conv(tree, name, c_out, c_in, k):
        tree[name + "/w"] = (r.standard_normal((c_out, c_in, k)) / math.sqrt(c_in * k)).astype(np.float32)
        tree[name + "/b"] = np.zeros(c_out, np.float32)

    def act(tree, name, c):
        tree[name + "/alpha"] = np.zeros(c, np.float32)
        tree[name + "/beta"] = np.zeros(c, np.float32)

    def units(tree, pre, c):
        for i in range(3):
            act(tree, f"{pre}/res/{i}/act1", c)
            act(tree, f"{pre}/res/{i}/act2", c)
            conv(tree, f"{pre}/res/{i}/conv1", c, c, 7)
            conv(tree, f"{pre}/res/{i}/conv2", c, c, 1)

    e: Dict[str, np.ndarray] = {}
    c = enc["ngf"]
    conv(e, "stem", c, 1, 7)
    for i, s in enumerate(enc["up_ratios"]):
        units(e, f"blocks/{i}", c)
        act(e, f"blocks/{i}/act", c)
        conv(e, f"blocks/{i}/down", 2 * c, c, 2 * s)
        c *= 2
    act(e, "final_act", c)
    conv(e, "out", enc["out_channels"], c, 3)

    d: Dict[str, np.ndarray] = {}
    dim, ch = dec["vq_dim"], dec["upsample_initial_channel"]
    for g, n in enumerate((dec["vq_num_q_p"], dec["vq_num_q_c"], dec["vq_num_q_r"])):
        for j in range(n):
            pre = f"quantizers/{g}/{j}"
            d[pre + "/in_proj/w"] = (0.02 * r.standard_normal((dec["codebook_dim"], dim))).astype(np.float32)
            d[pre + "/in_proj/b"] = np.zeros(dec["codebook_dim"], np.float32)
            d[pre + "/out_proj/w"] = (0.02 * r.standard_normal((dim, dec["codebook_dim"]))).astype(np.float32)
            d[pre + "/out_proj/b"] = np.zeros(dim, np.float32)
            d[pre + "/codebook"] = r.standard_normal((dec["codebook_size"], dec["codebook_dim"])).astype(np.float32)
    for i in range(timbre["layers"]):
        pre = f"timbre_encoder/layers/{i}"
        for ln in ("ln1", "ln2"):
            d[f"{pre}/{ln}/g"], d[f"{pre}/{ln}/b"] = np.ones(dim, np.float32), np.zeros(dim, np.float32)
        d[pre + "/attn/in_proj_w"] = (0.02 * r.standard_normal((3 * dim, dim))).astype(np.float32)
        d[pre + "/attn/in_proj_b"] = np.zeros(3 * dim, np.float32)
        d[pre + "/attn/out_proj_w"] = (0.02 * r.standard_normal((dim, dim))).astype(np.float32)
        d[pre + "/attn/out_proj_b"] = np.zeros(dim, np.float32)
        conv(d, pre + "/ffn1", timbre["ffn"], dim, timbre["kernel"])
        d[pre + "/ffn2/w"] = (0.02 * r.standard_normal((dim, timbre["ffn"]))).astype(np.float32)
        d[pre + "/ffn2/b"] = np.zeros(dim, np.float32)
    d["timbre_encoder/last_ln/g"], d["timbre_encoder/last_ln/b"] = np.ones(dim, np.float32), np.zeros(dim, np.float32)
    d["timbre_linear/w"] = (0.02 * r.standard_normal((2 * dim, dim))).astype(np.float32)
    d["timbre_linear/b"] = np.concatenate([np.ones(dim), np.zeros(dim)]).astype(np.float32)
    conv(d, "stem", ch, dec["in_channels"], 7)
    for i, s in enumerate(dec["up_ratios"]):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        act(d, f"blocks/{i}/act", c_in)
        d[f"blocks/{i}/up/w"] = (r.standard_normal((c_in, c_out, 2 * s)) / math.sqrt(2 * c_in)).astype(np.float32)
        d[f"blocks/{i}/up/b"] = np.zeros(c_out, np.float32)
        units(d, f"blocks/{i}", c_out)
    final = ch // 2 ** len(dec["up_ratios"])
    act(d, "final_act", final)
    conv(d, "out", 1, final, 7)
    d["out/w"] = d["out/w"] * np.float32(0.01)
    return {"encoder": e, "decoder": d}


def unflatten(flat: Dict[str, np.ndarray]):
    """'/'-paths -> nested dicts and lists (numeric components are list
    indices), the tree the program's codec takes."""
    root: Dict = {}
    for path, value in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def shapes_of(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in state.items()}
