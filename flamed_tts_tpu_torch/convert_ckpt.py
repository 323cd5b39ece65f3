"""Convert the reference's PyTorch checkpoints to the JAX package's
parameter trees, written as its ``.npz`` layout.

    python -m flamed_tts_tpu_torch.convert_ckpt --kind codec-encoder IN.bin OUT.npz
    python -m flamed_tts_tpu_torch.convert_ckpt --kind codec-decoder IN.bin OUT.npz
    python -m flamed_tts_tpu_torch.convert_ckpt --kind flamed IN.ckpt OUT.npz

The port's copy of the repository's ``tools/convert_torch_ckpt.py``, in
numpy, with the same mappings and the same output (``FaCodec.from_pretrained``
and ``Flamed.from_pretrained`` of either package read it):

* FaCodec encoder / decoder state_dicts (``ns3_facodec_{encoder,decoder}.bin``;
  V2, the timbre encoder and the ``cnn_predictor`` training heads);
* the Flamed checkpoint (a Lightning ckpt with ``state_dict``, or a bare
  weight dict saved weights-only): prior and prob generators.

Conversions applied:

* weight-norm folding: weight = g * v / ||v|| in float64, then float32;
* torch Linear (out, in)      -> flax Dense kernel (in, out);
* torch Conv1d (O, I/g, K)    -> flax Conv kernel (K, I/g, O);
* torch Embedding             -> flax Embed 'embedding' (identity);
* torch LayerNorm weight/bias -> flax 'scale'/'bias';
* FaCodec convs keep the torch layout (the codec ops consume it).

``flamed_state_dict`` is the inverse of ``convert_flamed_checkpoint``: a
``{"prior", "prob"}`` pair of flax trees back to the reference's key names
and layouts, for building a reference-format checkpoint from random weights.
"""

from __future__ import annotations

import argparse
import re
from typing import Any, Dict

import numpy as np
import torch

from flamed_tts_tpu_torch.runtime.pytree_io import save_pytree_npz


def fold_weight_norm(weight_v: np.ndarray, weight_g: np.ndarray) -> np.ndarray:
    """Fold torch weight_norm(v, g) -> g * v / ||v|| (norm over dims 1..)."""
    v = np.asarray(weight_v, dtype=np.float64)
    g = np.asarray(weight_g, dtype=np.float64)
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return (g * v / norm).astype(np.float32)


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _f32(sd: Dict, key: str) -> np.ndarray:
    return _np(sd[key]).astype(np.float32)


def _wn_conv(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    """Weight-normed conv/linear -> folded {'w','b'} (torch layout)."""
    if f"{prefix}.weight_v" in sd:
        w = fold_weight_norm(_np(sd[f"{prefix}.weight_v"]), _np(sd[f"{prefix}.weight_g"]))
    # torch >= 2.1 parametrized naming
    elif f"{prefix}.parametrizations.weight.original1" in sd:
        w = fold_weight_norm(_np(sd[f"{prefix}.parametrizations.weight.original1"]),
                             _np(sd[f"{prefix}.parametrizations.weight.original0"]))
    else:
        w = _f32(sd, f"{prefix}.weight")
    out = {"w": w}
    if f"{prefix}.bias" in sd:
        out["b"] = _f32(sd, f"{prefix}.bias")
    return out


def _act(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"alpha": _f32(sd, f"{prefix}.alpha"), "beta": _f32(sd, f"{prefix}.beta")}


def _res_unit(sd: Dict, prefix: str) -> Dict[str, Any]:
    """ResidualUnit.block = [Activation1d, WNConv1d, Activation1d, WNConv1d]."""
    return {
        "act1": _act(sd, f"{prefix}.block.0.act"),
        "conv1": _wn_conv(sd, f"{prefix}.block.1"),
        "act2": _act(sd, f"{prefix}.block.2.act"),
        "conv2": _wn_conv(sd, f"{prefix}.block.3"),
    }


def convert_facodec_encoder(sd: Dict) -> Dict[str, Any]:
    """Encoder Sequential: [stem, EncBlock x4, Activation1d, out]."""
    params: Dict[str, Any] = {"stem": _wn_conv(sd, "block.0"), "blocks": []}
    for i in range(1, 5):
        params["blocks"].append({
            "res": [_res_unit(sd, f"block.{i}.block.{j}") for j in range(3)],
            "act": _act(sd, f"block.{i}.block.3.act"),
            "down": _wn_conv(sd, f"block.{i}.block.4"),
        })
    params["final_act"] = _act(sd, "block.5.act")
    params["out"] = _wn_conv(sd, "block.6")
    return params


def _fvq(sd: Dict, prefix: str) -> Dict[str, Any]:
    return {
        "in_proj": _wn_conv(sd, f"{prefix}.in_proj"),
        "out_proj": _wn_conv(sd, f"{prefix}.out_proj"),
        "codebook": _f32(sd, f"{prefix}._codebook.weight"),
    }


def _timbre_encoder(sd: Dict, prefix: str, n_layers: int = 4) -> Dict[str, Any]:
    def pair(p, w="weight", b="bias", names=("g", "b")):
        return {names[0]: _f32(sd, f"{p}.{w}"), names[1]: _f32(sd, f"{p}.{b}")}

    layers = []
    for i in range(n_layers):
        lp = f"{prefix}.layers.{i}"
        layers.append({
            "ln1": pair(f"{lp}.ln_1"),
            "attn": {
                "in_proj_w": _f32(sd, f"{lp}.self_attn.in_proj_weight"),
                "in_proj_b": _f32(sd, f"{lp}.self_attn.in_proj_bias"),
                "out_proj_w": _f32(sd, f"{lp}.self_attn.out_proj.weight"),
                "out_proj_b": _f32(sd, f"{lp}.self_attn.out_proj.bias"),
            },
            "ln2": pair(f"{lp}.ln_2"),
            "ffn1": pair(f"{lp}.ffn.ffn_1", names=("w", "b")),
            "ffn2": pair(f"{lp}.ffn.ffn_2", names=("w", "b")),
        })
    return {"layers": layers, "last_ln": pair(f"{prefix}.last_ln")}


def convert_facodec_decoder(sd: Dict) -> Dict[str, Any]:
    """Decoder: quantizers + timbre encoder + synthesis stack."""
    group_sizes = (1, 2, 3)
    params: Dict[str, Any] = {
        "quantizers": [[_fvq(sd, f"quantizer.{g}.layers.{q}") for q in range(n)]
                       for g, n in enumerate(group_sizes)],
        "timbre_encoder": _timbre_encoder(sd, "timbre_encoder"),
        "timbre_linear": {"w": _f32(sd, "timbre_linear.weight"), "b": _f32(sd, "timbre_linear.bias")},
        "stem": _wn_conv(sd, "model.0"),
        "blocks": [],
    }
    for i in range(1, 5):
        params["blocks"].append({
            "act": _act(sd, f"model.{i}.block.0.act"),
            "up": _wn_conv(sd, f"model.{i}.block.1"),
            "res": [_res_unit(sd, f"model.{i}.block.{j}") for j in range(2, 5)],
        })
    params["final_act"] = _act(sd, "model.5.act")
    params["out"] = _wn_conv(sd, "model.6")
    return params


def convert_cnn_predictor(sd: Dict, prefix: str, n_heads: int) -> Dict[str, Any]:
    """CNNLSTM head: 3 residual units + Activation1d + Linear heads.
    ``prefix`` addresses the CNNLSTM module itself (add '.1' for
    GradientReversal-wrapped heads)."""
    return {
        "res": [_res_unit(sd, f"{prefix}.model.{j}") for j in range(3)],
        "act": _act(sd, f"{prefix}.model.3.act"),
        "heads": [{"w": _f32(sd, f"{prefix}.heads.{i}.weight"),
                   "b": _f32(sd, f"{prefix}.heads.{i}.bias")} for i in range(n_heads)],
    }


def convert_decoder_training_heads(sd: Dict) -> Dict[str, Any]:
    """Predictor heads of FACodecDecoder(.V2) for the training forward;
    GR-wrapped heads live under '<name>.1'."""
    heads = {
        "f0_predictor": convert_cnn_predictor(sd, "f0_predictor", 2),
        "phone_predictor": convert_cnn_predictor(sd, "phone_predictor", 1),
    }
    for name, n in (("res_f0_predictor", 2), ("res_phone_predictor", 1),
                    ("x_timbre_predictor", 1)):
        if f"{name}.1.heads.0.bias" in sd:
            heads[name] = convert_cnn_predictor(sd, f"{name}.1", n)
    return heads


def convert_facodec_encoder_v2(sd: Dict) -> Dict[str, Any]:
    """FACodecEncoderV2: the conv topology of V1 (its mel transform has no
    parameters)."""
    return convert_facodec_encoder(sd)


def convert_facodec_decoder_v2(sd: Dict) -> Dict[str, Any]:
    """FACodecDecoderV2: V1's layout plus the prosody-from-mel branch
    (melspec_linear 20->256 + 4-layer transformer encoder)."""
    params = convert_facodec_decoder(sd)
    params["melspec_linear"] = {"w": _f32(sd, "melspec_linear.weight"),
                                "b": _f32(sd, "melspec_linear.bias")}
    params["melspec_encoder"] = _timbre_encoder(sd, "melspec_encoder")
    return params


# ----- Flamed model checkpoint ------------------------------------------


def _dense(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _f32(sd, f"{prefix}.weight").T, "bias": _f32(sd, f"{prefix}.bias")}


def _conv_flax(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    w = _f32(sd, f"{prefix}.weight")  # (O, I/g, K)
    return {"kernel": np.transpose(w, (2, 1, 0)), "bias": _f32(sd, f"{prefix}.bias")}


def _conv1x1_as_dense(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    w = _f32(sd, f"{prefix}.weight")  # (O, I, 1)
    return {"kernel": w[:, :, 0].T, "bias": _f32(sd, f"{prefix}.bias")}


def _ln(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _f32(sd, f"{prefix}.weight"), "bias": _f32(sd, f"{prefix}.bias")}


def _embed(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"embedding": _f32(sd, f"{prefix}.weight")}


def _fft_layer(sd: Dict, prefix: str) -> Dict[str, Any]:
    return {
        "slf_attn": {
            "w_qs": _dense(sd, f"{prefix}.slf_attn.w_qs"),
            "w_ks": _dense(sd, f"{prefix}.slf_attn.w_ks"),
            "w_vs": _dense(sd, f"{prefix}.slf_attn.w_vs"),
            "fc": _dense(sd, f"{prefix}.slf_attn.fc"),
            "layer_norm": _ln(sd, f"{prefix}.slf_attn.layer_norm"),
        },
        "pos_ffn": {
            "w_1": _conv_flax(sd, f"{prefix}.pos_ffn.w_1"),
            "w_2": _conv_flax(sd, f"{prefix}.pos_ffn.w_2"),
            "layer_norm": _ln(sd, f"{prefix}.pos_ffn.layer_norm"),
        },
    }


def _fft_stack(sd: Dict, prefix: str, n_layers: int) -> Dict[str, Any]:
    return {f"layer_{i}": _fft_layer(sd, f"{prefix}.layer_stack.{i}") for i in range(n_layers)}


def _count_layers(sd: Dict, prefix: str) -> int:
    pattern = re.compile(re.escape(prefix) + r"\.layer_stack\.(\d+)\.")
    indices = {int(m.group(1)) for k in sd for m in [pattern.match(k)] if m}
    return max(indices) + 1 if indices else 0


def _prob_module(sd: Dict, prefix: str) -> Dict[str, Any]:
    """The PVA's ProbabilisticModule -> the flax module tree."""
    return {
        "proj": _dense(sd, f"{prefix}.proj"),
        "time_emb": {"mlp_1": _dense(sd, f"{prefix}.time_emb.time_emb.1"),
                     "mlp_3": _dense(sd, f"{prefix}.time_emb.time_emb.3")},
        "conv1d_1": _conv_flax(sd, f"{prefix}.conv_layer.conv1d_1.conv"),
        "layer_norm_1": _ln(sd, f"{prefix}.conv_layer.layer_norm_1"),
        "conv1d_2": _conv_flax(sd, f"{prefix}.conv_layer.conv1d_2.conv"),
        "layer_norm_2": _ln(sd, f"{prefix}.conv_layer.layer_norm_2"),
        "linear_layer": _dense(sd, f"{prefix}.linear_layer"),
    }


def convert_prior_generator(sd: Dict, prefix: str = "prior_generator") -> Dict[str, Any]:
    n_enc = _count_layers(sd, f"{prefix}.encoder")
    n_shared = _count_layers(sd, f"{prefix}.shared_decoder")
    params: Dict[str, Any] = {
        "src_word_emb": _embed(sd, f"{prefix}.encoder.src_word_emb"),
        "encoder": _fft_stack(sd, f"{prefix}.encoder", n_enc),
        "duration_generator": _prob_module(sd, f"{prefix}.pva.duration_generator"),
        "sil_generator": _prob_module(sd, f"{prefix}.pva.sil_generator"),
        "bridge": _dense(sd, f"{prefix}.bridge"),
        "code_embedding": _embed(sd, f"{prefix}.code_embedding"),
        "shared_decoder": _fft_stack(sd, f"{prefix}.shared_decoder", n_shared),
        "prompt_seg_emb": _f32(sd, f"{prefix}.pre_encode.prompt_emb"),
        "target_seg_emb": _f32(sd, f"{prefix}.pre_encode.target_emb"),
        "quantizer_emb": _embed(sd, f"{prefix}.pre_encode.quantizer_emb"),
        "head": _dense(sd, f"{prefix}.head"),
    }
    q = 0
    while _count_layers(sd, f"{prefix}.prior_decoder.{q}"):
        params[f"prior_decoder_{q}"] = _fft_stack(
            sd, f"{prefix}.prior_decoder.{q}", _count_layers(sd, f"{prefix}.prior_decoder.{q}"))
        q += 1
    return params


def _convnext(sd: Dict, prefix: str) -> Dict[str, Any]:
    return {
        "conv_1": _conv_flax(sd, f"{prefix}.conv_1"),
        "ln_1": _ln(sd, f"{prefix}.ln_1"),
        "conv_2": _conv1x1_as_dense(sd, f"{prefix}.conv_2"),
        "conv_3": _conv1x1_as_dense(sd, f"{prefix}.conv_3"),
    }


def convert_prob_generator(sd: Dict, prefix: str = "prob_generator") -> Dict[str, Any]:
    params: Dict[str, Any] = {
        "quantizer_emb": _embed(sd, f"{prefix}.quantizer_encoding.quantizer_emb"),
    }
    cd: Dict[str, Any] = {}
    i = 0
    while f"{prefix}.cond_downsampling.resblocks.{i}.block.block.0.weight" in sd:
        rb = f"{prefix}.cond_downsampling.resblocks.{i}.block.block"
        cd[f"resblock_{i}"] = {"conv": _conv1x1_as_dense(sd, f"{rb}.0"), "norm": _ln(sd, f"{rb}.1")}
        cd[f"down_conv_{i}"] = _conv1x1_as_dense(sd, f"{prefix}.cond_downsampling.downblocks.{i}.0")
        cd[f"down_norm_{i}"] = _ln(sd, f"{prefix}.cond_downsampling.downblocks.{i}.1")
        i += 1
    cd["proj_out"] = _dense(sd, f"{prefix}.cond_downsampling.proj_out.0")
    params["cond_downsampling"] = cd

    den: Dict[str, Any] = {
        "time_embed": {"mlp_0": _dense(sd, f"{prefix}.denoiser.time_embed.mlp.0"),
                       "mlp_2": _dense(sd, f"{prefix}.denoiser.time_embed.mlp.2")},
        "cond_embed": _dense(sd, f"{prefix}.denoiser.cond_embed"),
        "proj_in": _dense(sd, f"{prefix}.denoiser.proj_in"),
    }
    i = 0
    while f"{prefix}.denoiser.res_blocks.{i}.ln_conv.weight" in sd:
        rb = f"{prefix}.denoiser.res_blocks.{i}"
        den[f"res_block_{i}"] = {
            "adaLN_modulation": _dense(sd, f"{rb}.adaLN_modulation.1"),
            "ln_conv": _ln(sd, f"{rb}.ln_conv"),
            "conv_in": _convnext(sd, f"{rb}.conv_in"),
            "ln_mlp": _ln(sd, f"{rb}.ln_mlp"),
            "mlp_0": _dense(sd, f"{rb}.mlp.0"),
            "mlp_2": _dense(sd, f"{rb}.mlp.2"),
        }
        i += 1
    fl = f"{prefix}.denoiser.final_layer"
    den["final_layer"] = {
        "adaLN_modulation": _dense(sd, f"{fl}.adaLN_modulation.1"),
        "conv_in": _convnext(sd, f"{fl}.conv_in"),
        "conv_out": _conv_flax(sd, f"{fl}.conv_out"),
    }
    params["denoiser"] = den
    return params


def convert_flamed_checkpoint(sd: Dict) -> Dict[str, Any]:
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {
        "prior": {"params": convert_prior_generator(sd)},
        "prob": {"params": convert_prob_generator(sd)},
    }


# ----- the inverse: flax trees -> the reference's Flamed state_dict ------

_FLAX_TO_TORCH = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _leaves(tree: Dict, prefix: str, sd: Dict[str, torch.Tensor], conv1x1: bool = False) -> None:
    """One flax module (a dict of leaves) -> torch names under ``prefix``:
    Dense kernels transposed (or made (O, I, 1) convs with ``conv1x1``),
    Conv kernels (K, I, O) -> (O, I, K)."""
    for key, value in tree.items():
        v = np.asarray(value, dtype=np.float32)
        if key == "kernel":
            v = v.T if v.ndim == 2 else np.transpose(v, (2, 1, 0))
            if conv1x1:
                v = v[:, :, None]
        sd[f"{prefix}.{_FLAX_TO_TORCH.get(key, key)}"] = _tensor(v)


def _fft_stack_sd(tree: Dict, prefix: str, sd: Dict) -> None:
    for name, layer in tree.items():
        lp = f"{prefix}.layer_stack.{int(name.removeprefix('layer_'))}"
        for sub in ("w_qs", "w_ks", "w_vs", "fc", "layer_norm"):
            _leaves(layer["slf_attn"][sub], f"{lp}.slf_attn.{sub}", sd)
        for sub in ("w_1", "w_2", "layer_norm"):
            _leaves(layer["pos_ffn"][sub], f"{lp}.pos_ffn.{sub}", sd)


def _convnext_sd(tree: Dict, prefix: str, sd: Dict) -> None:
    _leaves(tree["conv_1"], f"{prefix}.conv_1", sd)
    _leaves(tree["ln_1"], f"{prefix}.ln_1", sd)
    _leaves(tree["conv_2"], f"{prefix}.conv_2", sd, conv1x1=True)
    _leaves(tree["conv_3"], f"{prefix}.conv_3", sd, conv1x1=True)


def flamed_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """{"prior": {"params": tree}, "prob": {"params": tree}} (the JAX
    package's layout) -> the reference's bare Flamed state_dict, which
    ``convert_flamed_checkpoint`` maps back to the same trees."""
    sd: Dict[str, torch.Tensor] = {}
    pr, p = params["prior"]["params"], "prior_generator"
    _leaves(pr["src_word_emb"], f"{p}.encoder.src_word_emb", sd)
    _fft_stack_sd(pr["encoder"], f"{p}.encoder", sd)
    for gen in ("duration_generator", "sil_generator"):
        g, gp = pr[gen], f"{p}.pva.{gen}"
        _leaves(g["proj"], f"{gp}.proj", sd)
        _leaves(g["time_emb"]["mlp_1"], f"{gp}.time_emb.time_emb.1", sd)
        _leaves(g["time_emb"]["mlp_3"], f"{gp}.time_emb.time_emb.3", sd)
        for i in (1, 2):
            _leaves(g[f"conv1d_{i}"], f"{gp}.conv_layer.conv1d_{i}.conv", sd)
            _leaves(g[f"layer_norm_{i}"], f"{gp}.conv_layer.layer_norm_{i}", sd)
        _leaves(g["linear_layer"], f"{gp}.linear_layer", sd)
    _leaves(pr["bridge"], f"{p}.bridge", sd)
    _leaves(pr["code_embedding"], f"{p}.code_embedding", sd)
    _fft_stack_sd(pr["shared_decoder"], f"{p}.shared_decoder", sd)
    sd[f"{p}.pre_encode.prompt_emb"] = _tensor(pr["prompt_seg_emb"])
    sd[f"{p}.pre_encode.target_emb"] = _tensor(pr["target_seg_emb"])
    _leaves(pr["quantizer_emb"], f"{p}.pre_encode.quantizer_emb", sd)
    _leaves(pr["head"], f"{p}.head", sd)
    q = 0
    while f"prior_decoder_{q}" in pr:
        _fft_stack_sd(pr[f"prior_decoder_{q}"], f"{p}.prior_decoder.{q}", sd)
        q += 1

    pb, p = params["prob"]["params"], "prob_generator"
    _leaves(pb["quantizer_emb"], f"{p}.quantizer_encoding.quantizer_emb", sd)
    cd, cp = pb["cond_downsampling"], f"{p}.cond_downsampling"
    i = 0
    while f"resblock_{i}" in cd:
        _leaves(cd[f"resblock_{i}"]["conv"], f"{cp}.resblocks.{i}.block.block.0", sd, conv1x1=True)
        _leaves(cd[f"resblock_{i}"]["norm"], f"{cp}.resblocks.{i}.block.block.1", sd)
        _leaves(cd[f"down_conv_{i}"], f"{cp}.downblocks.{i}.0", sd, conv1x1=True)
        _leaves(cd[f"down_norm_{i}"], f"{cp}.downblocks.{i}.1", sd)
        i += 1
    _leaves(cd["proj_out"], f"{cp}.proj_out.0", sd)
    den, dp = pb["denoiser"], f"{p}.denoiser"
    _leaves(den["time_embed"]["mlp_0"], f"{dp}.time_embed.mlp.0", sd)
    _leaves(den["time_embed"]["mlp_2"], f"{dp}.time_embed.mlp.2", sd)
    for name in ("cond_embed", "proj_in"):
        _leaves(den[name], f"{dp}.{name}", sd)
    i = 0
    while f"res_block_{i}" in den:
        rb, rp = den[f"res_block_{i}"], f"{dp}.res_blocks.{i}"
        _leaves(rb["adaLN_modulation"], f"{rp}.adaLN_modulation.1", sd)
        for name in ("ln_conv", "ln_mlp"):
            _leaves(rb[name], f"{rp}.{name}", sd)
        _convnext_sd(rb["conv_in"], f"{rp}.conv_in", sd)
        _leaves(rb["mlp_0"], f"{rp}.mlp.0", sd)
        _leaves(rb["mlp_2"], f"{rp}.mlp.2", sd)
        i += 1
    fl, fp = den["final_layer"], f"{dp}.final_layer"
    _leaves(fl["adaLN_modulation"], f"{fp}.adaLN_modulation.1", sd)
    _convnext_sd(fl["conv_in"], f"{fp}.conv_in", sd)
    _leaves(fl["conv_out"], f"{fp}.conv_out", sd)
    return sd


CONVERTERS = {"codec-encoder": convert_facodec_encoder, "codec-decoder": convert_facodec_decoder,
              "flamed": convert_flamed_checkpoint}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.convert_ckpt",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--kind", required=True, choices=list(CONVERTERS))
    parser.add_argument("input")
    parser.add_argument("output")
    args = parser.parse_args(argv)
    sd = torch.load(args.input, map_location="cpu", weights_only=False)
    save_pytree_npz(args.output, CONVERTERS[args.kind](sd))
    print(f"Converted {args.kind}: {args.input} -> {args.output}")


if __name__ == "__main__":
    main()
