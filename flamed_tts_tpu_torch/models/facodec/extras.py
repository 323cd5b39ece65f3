"""FaCodec's training path and its voice-conversion variants:

* ``gradient_reversal``: identity forward, gradient times -alpha backward;
* ``cnn_predictor``: three residual units (d = 1, 2, 3), a filtered Snake
  and one Linear per head (the F0 / UV / phone / speaker probes);
* the VQ training path: ``fvq_train`` / ``rvq_train`` / ``analyze_train``
  (straight-through, commitment and codebook losses, quantizer dropout,
  batch-statistics whitening ``_whiten_sg``, folded into ``in_proj`` by
  ``whitening_fold``);
* ``decoder_training_forward``: the predictor heads on the quantized
  groups, the random residual mask and the synthesis stack;
* the redecoder (codes + a new speaker -> wav through a style-adaptive
  transformer) and the V2 codec (prosody from the log-mel).

Every random draw is an argument: quantizer-dropout counts ``n_q`` and the
residual mask's uniform draws.  On the card the residual units are K2 and
the Snakes K1, through their autograd Functions under grad.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from flamed_tts_tpu_torch.models.facodec.decoder import (GROUP_SIZES, init_decoder_params,
                                                         synthesize, vq2emb)
from flamed_tts_tpu_torch.models.facodec.encoder import encoder_forward, init_act, init_unit
from flamed_tts_tpu_torch.models.facodec.quantize import linear, rvq_encode
from flamed_tts_tpu_torch.models.facodec.timbre import (_layer_norm, _mha,
                                                        batch_constant_positional_bias, init_linear,
                                                        init_timbre_params, timbre_encoder_forward)
from flamed_tts_tpu_torch.ops.conv1d import conv1d
from flamed_tts_tpu_torch.ops.melspec import mel_spectrogram
from flamed_tts_tpu_torch.ops.resunit import residual_unit
from flamed_tts_tpu_torch.ops.snake import snake_filtered


# --- gradient reversal ---------------------------------------------------

class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return -ctx.alpha * grad, None


def gradient_reversal(x: Tensor, alpha: float = 1.0) -> Tensor:
    """Identity forward; the backward multiplies the gradient by -alpha."""
    return _GradientReversal.apply(x, float(alpha))


# --- CNN predictor head ("CNNLSTM": no LSTM) ------------------------------

def cnn_predictor(x: Tensor, params: Dict, global_pred: bool = False) -> List[Tensor]:
    """(B, T, C) -> one (B, T, out) per head ((B, out) with ``global_pred``,
    which averages over time before the heads)."""
    for unit, dilation in zip(params["res"], (1, 2, 3)):
        x = residual_unit(x, unit, dilation)
    x = snake_filtered(x, params["act"]["alpha"], params["act"]["beta"])
    if global_pred:
        x = x.mean(dim=1)
    return [linear(x, h) for h in params["heads"]]


def init_cnn_predictor(g: torch.Generator, indim: int, outdim: int, n_heads: int) -> Dict:
    return {"res": [init_unit(g, indim) for _ in range(3)], "act": init_act(indim),
            "heads": [init_linear(g, outdim, indim) for _ in range(n_heads)]}


# --- FVQ training path ---------------------------------------------------

def _l2n(x: Tensor) -> Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _nearest(z_e: Tensor, codebook: Tensor) -> Tuple[Tensor, Tensor]:
    """Cosine nearest neighbour: (codes (B, T) int32, similarities)."""
    sim = torch.einsum("btd,nd->btn", _l2n(z_e), _l2n(codebook))
    return torch.argmax(sim, dim=-1).to(torch.int32), sim


def _whiten_sg(z_e: Tensor) -> Tensor:
    """Whiten (B, T, D) with batch statistics that carry no gradient: zero
    mean, ~identity covariance over the B*T samples.  The inverse square
    root of the (floored) covariance is a 25-step Newton-Schulz iteration
    of matmuls (no eigensolver); where it yields a non-finite entry, an
    isotropic scale stands in."""
    flat = z_e.reshape(-1, z_e.shape[-1])
    d = flat.shape[-1]
    with torch.no_grad():
        mu = flat.mean(0)
        zc = flat - mu
        cov = (zc.t() @ zc) / zc.shape[0]
        eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
        cov = cov + (1e-3 * torch.trace(cov) / d + 1e-8) * eye  # conditioning floor
        t = torch.trace(cov)
        y, z = cov / t, eye
        for _ in range(25):  # eigenvalues of y in (0, 1]: globally convergent
            s = 0.5 * (3.0 * eye - z @ y)
            y = y @ s
            z = s @ z
        w = z / torch.sqrt(t)  # cov^{-1/2}
        iso = eye / torch.sqrt(torch.clamp(t / d, min=1e-12))
        w = torch.where(torch.isfinite(w).all(), w, iso)
    return ((flat - mu) @ w).reshape(z_e.shape)


def whitening_fold(w_in: np.ndarray, b_in: np.ndarray, z_samples: np.ndarray, eps: float = 1e-5):
    """The whitening measured on ``z_samples`` (N, D) folded into an affine
    in_proj (numpy): (w', b') with in_proj'(x) == whiten(in_proj(x)) for
    the samples' statistics."""
    mu = z_samples.mean(0)
    zc = z_samples - mu
    cov = (zc.T @ zc) / len(zc)
    evals, evecs = np.linalg.eigh(cov + eps * np.eye(cov.shape[0]))
    w = evecs @ np.diag(1.0 / np.sqrt(np.maximum(evals, eps))) @ evecs.T
    return w.T @ w_in, (b_in - mu) @ w


def fvq_train(x: Tensor, p: Dict, commitment: float = 0.005, normalized_losses: bool = False,
              center: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Training forward of one factorized VQ layer: (quantized through the
    straight-through estimator, codes, commitment + codebook loss per batch
    element).  ``normalized_losses`` takes both terms on the unit sphere
    (commitment at least 0.25); ``center`` whitens z_e first."""
    z_e = linear(x, p["in_proj"])
    if center:
        z_e = _whiten_sg(z_e)
    codes, _ = _nearest(z_e, p["codebook"])
    z_q = p["codebook"][codes.long()]
    if normalized_losses:
        z_e_c, z_q_c = _l2n(z_e), _l2n(z_q)
        commitment = max(commitment, 0.25)
    else:
        z_e_c, z_q_c = z_e, z_q
    commit_loss = ((z_e_c - z_q_c.detach()) ** 2).mean(dim=(1, 2)) * commitment
    codebook_loss = ((z_q_c - z_e_c.detach()) ** 2).mean(dim=(1, 2))
    z_q = z_e + (z_q - z_e).detach()  # straight-through
    return linear(z_q, p["out_proj"]), codes, commit_loss + codebook_loss


def quantizer_counts(b: int, n_layers: int, quantizer_dropout: float,
                     generator: Optional[torch.Generator] = None, device=None) -> Tensor:
    """Per batch element, how many of ``n_layers`` layers count: the first
    int(b * quantizer_dropout) elements draw 1 .. n_layers, the rest keep
    all (n_layers + 1 means every layer)."""
    n_q = torch.full((b,), n_layers + 1, dtype=torch.int32, device=device)
    n_drop = int(b * quantizer_dropout)
    if n_drop:
        n_q[:n_drop] = torch.randint(1, n_layers + 1, (n_drop,), generator=generator,
                                     device=device, dtype=torch.int32)
    return n_q


def rvq_train(x: Tensor, layers: List[Dict], n_q: Optional[Tensor] = None,
              normalized_losses: bool = False, center: bool = False
              ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Residual VQ training loop: (quantized sum, codes (L, B, T), loss per
    layer (L,), per-layer quantized (L, B, T, D)).  Layer ``idx`` counts
    for element b where idx < n_q[b] (``quantizer_counts``); None keeps
    every layer."""
    residual = x
    quantized_out = torch.zeros_like(x)
    codes, losses, per_layer = [], [], []
    for idx, layer in enumerate(layers):
        z_q, c, loss = fvq_train(residual, layer, normalized_losses=normalized_losses, center=center)
        mask = torch.ones(x.shape[0], dtype=x.dtype, device=x.device) if n_q is None else \
            (idx < n_q).to(x.dtype)
        residual = residual - z_q
        quantized_out = quantized_out + z_q * mask[:, None, None]
        losses.append((loss * mask).mean())
        codes.append(c)
        per_layer.append(z_q)
    return quantized_out, torch.stack(codes), torch.stack(losses), torch.stack(per_layer)


def analyze_train(params: Dict, latents: Tensor, n_q: Optional[Sequence[Tensor]] = None,
                  normalized_losses: bool = False, center: bool = False
                  ) -> Tuple[Tensor, Tensor, Tensor, List[Tensor], Tensor]:
    """Training-mode analysis: the three RVQ groups on their training path,
    the residual group on latents - (prosody + content) without gradient
    through the subtrahend.  ``n_q`` holds one ``quantizer_counts`` per
    group (None: every layer).  Returns (quantized sum, codes (6, B, T),
    losses (6,), per-group quantized sums [3 x (B, T, D)], timbre (B, D))."""
    n_q = list(n_q) if n_q is not None else [None, None, None]
    outs, codes, losses, buf = 0.0, [], [], []
    for gi in range(3):
        x = latents if gi < 2 else latents - (buf[0] + buf[1]).detach()
        q_out, q_codes, q_losses, per_layer = rvq_train(
            x, params["quantizers"][gi], n_q[gi], normalized_losses=normalized_losses, center=center)
        outs = outs + q_out
        codes.append(q_codes)
        losses.append(q_losses)
        buf.append(per_layer.sum(0))
    timbre = timbre_encoder_forward(params["timbre_encoder"], latents, None)
    return outs, torch.cat(codes), torch.cat(losses), buf, timbre


# --- the codec's training decode -----------------------------------------

def decoder_training_forward(params: Dict, heads: Dict, quantized: Sequence[Tensor],
                             speaker_embedding: Tensor, residual_draw: Optional[Tensor] = None,
                             prob_random_mask_residual: float = 0.75,
                             use_gr_residual_f0: bool = False, use_gr_residual_phone: bool = False,
                             use_gr_x_timbre: bool = False,
                             up_ratios: Sequence[int] = (5, 5, 4, 2)) -> Dict[str, Tensor]:
    """The codec's training decode: predictor heads on the quantized
    groups (GRL probes on the residual group and on the sum where asked),
    the residual group dropped per element where ``residual_draw`` (B,)
    uniform draws fall below ``prob_random_mask_residual`` (None keeps it),
    the timbre-affine norm and the synthesis stack."""
    out: Dict[str, Tensor] = {}
    f0, uv = cnn_predictor(quantized[0], heads["f0_predictor"])
    out["f0"], out["uv"] = f0[..., 0], uv[..., 0]
    (out["phone"],) = cnn_predictor(quantized[1], heads["phone_predictor"])
    if use_gr_residual_f0:
        res_f0, res_uv = cnn_predictor(gradient_reversal(quantized[2]), heads["res_f0_predictor"])
        out["res_f0"], out["res_uv"] = res_f0[..., 0], res_uv[..., 0]
    if use_gr_residual_phone:
        (out["res_phone"],) = cnn_predictor(gradient_reversal(quantized[2]), heads["res_phone_predictor"])
    b = quantized[2].shape[0]
    if residual_draw is None:
        keep = torch.ones((b, 1, 1), dtype=quantized[2].dtype, device=quantized[2].device)
    else:
        keep = (residual_draw.reshape(b, 1, 1) >= prob_random_mask_residual).to(quantized[2].dtype)
    x = quantized[0].detach() + quantized[1].detach() + quantized[2] * keep
    if use_gr_x_timbre:
        (out["x_timbre"],) = cnn_predictor(gradient_reversal(x), heads["x_timbre_predictor"],
                                           global_pred=True)
    out["audio"] = synthesize(params, x, speaker_embedding, up_ratios=up_ratios)
    return out


def init_decoder_training_heads(g: torch.Generator, in_channels: int = 256, phone_classes: int = 5003,
                                speaker_classes: int = 245200, use_gr_residual_f0: bool = False,
                                use_gr_residual_phone: bool = False,
                                use_gr_x_timbre: bool = False) -> Dict:
    """The reference's head shapes: f0 (1 out, 2 heads: F0 and UV), phone
    (``phone_classes``), x-timbre (``speaker_classes``, pooled)."""
    heads = {"f0_predictor": init_cnn_predictor(g, in_channels, 1, 2),
             "phone_predictor": init_cnn_predictor(g, in_channels, phone_classes, 1)}
    if use_gr_residual_f0:
        heads["res_f0_predictor"] = init_cnn_predictor(g, in_channels, 1, 2)
    if use_gr_residual_phone:
        heads["res_phone_predictor"] = init_cnn_predictor(g, in_channels, phone_classes, 1)
    if use_gr_x_timbre:
        heads["x_timbre_predictor"] = init_cnn_predictor(g, in_channels, speaker_classes, 1)
    return heads


# --- style-adaptive (cln) transformer ------------------------------------

def _style_adaptive_ln(x: Tensor, p: Dict, condition: Tensor) -> Tensor:
    """LayerNorm whose gamma / beta come from the time-mean of the
    condition."""
    gamma, beta = linear(condition.mean(dim=1, keepdim=True), p).chunk(2, dim=-1)
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return gamma * ((x - mean) / torch.sqrt(var + 1e-5)) + beta


def _ffn(h: Tensor, layer: Dict, pad_mask: Optional[Tensor], conv_kernel: int) -> Tensor:
    if pad_mask is not None:
        h = h.masked_fill(pad_mask[:, :, None], 0.0)
    h = F.relu(conv1d(h, layer["ffn1"]["w"], layer["ffn1"]["b"], padding=conv_kernel // 2))
    return linear(h, layer["ffn2"])


def cln_transformer_forward(params: Dict, x: Tensor, condition: Tensor,
                            pad_mask: Optional[Tensor] = None, n_head: int = 4,
                            conv_kernel: int = 5) -> Tensor:
    """The style-adaptive transformer encoder: (B, T, d) -> (B, T, d)."""
    x = x + batch_constant_positional_bias(x.shape[0], x.shape[-1], x.device)
    for layer in params["layers"]:
        x = x + _mha(_style_adaptive_ln(x, layer["ln1"], condition), layer["attn"], n_head, pad_mask)
        x = x + _ffn(_style_adaptive_ln(x, layer["ln2"], condition), layer, pad_mask, conv_kernel)
    return _style_adaptive_ln(x, params["last_ln"], condition)


def init_cln_transformer(g: torch.Generator, d_model: int = 256, n_layers: int = 4, d_ffn: int = 1024,
                         conv_kernel: int = 5) -> Dict:
    def sln():
        p = init_linear(g, 2 * d_model, d_model)
        p["b"] = torch.cat([torch.ones(d_model), torch.zeros(d_model)])  # gamma 1, beta 0
        return p

    layers = []
    for _ in range(n_layers):
        qkv, out = init_linear(g, 3 * d_model, d_model), init_linear(g, d_model, d_model)
        ffn1 = torch.randn((d_ffn, d_model, conv_kernel), generator=g) * 0.02
        layers.append({"ln1": sln(),
                       "attn": {"in_proj_w": qkv["w"], "in_proj_b": qkv["b"],
                                "out_proj_w": out["w"], "out_proj_b": out["b"]},
                       "ln2": sln(), "ffn1": {"w": ffn1, "b": torch.zeros(d_ffn)},
                       "ffn2": init_linear(g, d_model, d_ffn)})
    return {"layers": layers, "last_ln": sln()}


# --- the redecoder (voice conversion) -------------------------------------

def redecoder_forward(params: Dict, codes: Tensor, speaker_embedding: Tensor,
                      use_residual_code: bool = False, up_ratios: Sequence[int] = (5, 5, 4, 2),
                      group_sizes: Sequence[int] = GROUP_SIZES) -> Tensor:
    """codes (6, B, T) + a speaker (B, 256) -> wav: the prosody codes are
    embedded again through the speaker-conditioned transformer, then
    content (and residual) embeddings are added and synthesized."""
    n_p, n_c, n_r = group_sizes
    codes = codes.long()
    x_p = sum(params["prosody_embs"][i][codes[i]] for i in range(n_p))
    cond = speaker_embedding[:, None, :].expand(x_p.shape[0], x_p.shape[1], speaker_embedding.shape[-1])
    x = cln_transformer_forward(params["prosody_enc"], x_p, cond)
    x = x + sum(params["content_embs"][i][codes[n_p + i]] for i in range(n_c))
    if use_residual_code:
        x = x + sum(params["residual_embs"][i][codes[n_p + n_c + i]] for i in range(n_r))
    return synthesize(params["synth"], x, speaker_embedding, up_ratios=up_ratios)


def init_redecoder_params(g: torch.Generator, in_channels: int = 256,
                          upsample_initial_channel: int = 1280,
                          up_ratios: Sequence[int] = (5, 5, 4, 2),
                          codebook_sizes: Sequence[int] = (1024, 1024, 1024),
                          group_sizes: Sequence[int] = GROUP_SIZES) -> Dict:
    dec = init_decoder_params(g, in_channels, upsample_initial_channel, up_ratios)
    synth = {k: dec[k] for k in ("timbre_linear", "stem", "blocks", "final_act", "out")}

    def embs(n):
        return [torch.randn((codebook_sizes[0], in_channels), generator=g) * 1e-5 for _ in range(n)]

    return {"prosody_embs": embs(group_sizes[0]), "content_embs": embs(group_sizes[1]),
            "residual_embs": embs(group_sizes[2]),
            "prosody_enc": init_cln_transformer(g, d_model=in_channels), "synth": synth}


# --- V2 encoder / decoder (prosody from the log-mel) ----------------------

def encoder_v2_prosody_feature(wav: Tensor) -> Tensor:
    """wav (B, T) -> the first 20 log-mel bins (B, 20, frames)."""
    return mel_spectrogram(wav)[:, :20, :]


def _melspec_encode(enc_params: Dict, x: Tensor, pad_mask: Optional[Tensor]) -> Tensor:
    """The V2 melspec encoder: a plain (not style-adaptive) transformer
    encoder returning per-frame features."""
    x = x + batch_constant_positional_bias(x.shape[0], x.shape[-1], x.device)
    for layer in enc_params["layers"]:
        x = x + _mha(_layer_norm(x, layer["ln1"]), layer["attn"], 4, pad_mask)
        x = x + _ffn(_layer_norm(x, layer["ln2"]), layer, pad_mask, 5)
    return _layer_norm(x, enc_params["last_ln"])


def decoder_v2_quantize(params: Dict, latents: Tensor, prosody_feature: Tensor,
                        pad_mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """V2 analysis: the prosody group quantizes the encoded log-mel feature
    (B, 20, T); content and residual and the timbre are as in V1.  Returns
    (codes (6, B, T), timbre (B, 256))."""
    f0_in = linear(prosody_feature.transpose(1, 2), params["melspec_linear"])
    f0_in = _melspec_encode(params["melspec_encoder"], f0_in, pad_mask)
    prosody_codes, prosody_q = rvq_encode(f0_in, params["quantizers"][0])
    content_codes, content_q = rvq_encode(latents, params["quantizers"][1])
    residual_codes, _ = rvq_encode(latents - (prosody_q + content_q), params["quantizers"][2])
    codes = torch.cat([prosody_codes, content_codes, residual_codes], dim=0)
    return codes, timbre_encoder_forward(params["timbre_encoder"], latents, pad_mask)


def encoder_v2_forward(params: Dict, wav: Tensor, up_ratios: Sequence[int] = (2, 4, 5, 5)) -> Tensor:
    """The V2 encoder has the V1 topology; only its widths differ."""
    return encoder_forward(params, wav, up_ratios)


def decoder_v2_vq2emb(params: Dict, codes: Tensor, use_residual: bool = True) -> Tensor:
    return vq2emb(params, codes, use_residual=use_residual)


def decoder_v2_inference(params: Dict, latents: Tensor, speaker_embedding: Tensor,
                         up_ratios: Sequence[int] = (5, 5, 4, 2)) -> Tensor:
    return synthesize(params, latents, speaker_embedding, up_ratios=up_ratios)


def v2_voice_conversion(enc_params: Dict, dec_params: Dict, source_wav: Tensor, target_wav: Tensor,
                        enc_up_ratios: Sequence[int] = (2, 4, 5, 5),
                        dec_up_ratios: Sequence[int] = (5, 5, 4, 2),
                        use_residual: bool = False) -> Tensor:
    """Source prosody (from the log-mel) and content codes, synthesized in
    the target's timbre: source (B, T, 1), target (B, T', 1) -> wav.  The
    residual codes carry the source speaker and are dropped by default."""
    src_latents = encoder_v2_forward(enc_params, source_wav, enc_up_ratios)
    # the mel grid may hold a frame more than the codec's
    src_prosody = encoder_v2_prosody_feature(source_wav[:, :, 0])[:, :, : src_latents.shape[1]]
    codes, _ = decoder_v2_quantize(dec_params, src_latents, src_prosody)
    tgt_latents = encoder_v2_forward(enc_params, target_wav, enc_up_ratios)
    tgt_spk = timbre_encoder_forward(dec_params["timbre_encoder"], tgt_latents, None)
    x = decoder_v2_vq2emb(dec_params, codes, use_residual=use_residual)
    return decoder_v2_inference(dec_params, x, tgt_spk, dec_up_ratios)


def init_decoder_v2_params(g: torch.Generator, in_channels: int = 256,
                           upsample_initial_channel: int = 1024,
                           up_ratios: Sequence[int] = (5, 5, 4, 2), n_mels: int = 20) -> Dict:
    """Random V2 decoder parameters: the V1 decoder's, the melspec linear
    (n_mels -> in_channels) and a melspec encoder of the timbre encoder's
    structure (the tree ``convert_ckpt`` makes of a V2 state dict)."""
    p = init_decoder_params(g, in_channels, upsample_initial_channel, up_ratios)
    p["melspec_linear"] = init_linear(g, in_channels, n_mels)
    p["melspec_encoder"] = init_timbre_params(g, in_channels)
    return p
