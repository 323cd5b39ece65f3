"""Training losses of the full model:

    total = dur_loss + sil_loss + prior_loss + fm_loss + anchor_loss

Two normalizations (``loss_norm``), as in the JAX package
(``flamed_tts_tpu/train/losses.py``): ``"masked"`` (the default) takes every
mean over the valid positions; ``"reference"`` reproduces the reference's
means over the whole padded buffer, pad positions included (the cross
entropy then adds a gradient-free log(V + 1) per pad position).

Dropout follows the modules' mode: put them in ``.train()`` for a training
step and ``.eval()`` for a validation loss.  The flow-matching times and
noises come from ``draws`` where given, else from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from flamed_tts_tpu_torch.models.prior.sampling import pva_loss
from flamed_tts_tpu_torch.models.prob.prob_generator import prob_loss
from flamed_tts_tpu_torch.ops.dropout import BatchRows, denominator
from flamed_tts_tpu_torch.ops.length_regulator import length_regulate
from flamed_tts_tpu_torch.ops.masking import mask_from_lengths

# what ``draws`` may hold: pva_t (B, 1), dur_noise / sil_noise (B, L),
# prob_t (B, Lf, 1), prob_noise (B, Lf, target_dim)
DRAW_KEYS = ("pva_t", "dur_noise", "sil_noise", "prob_t", "prob_noise")


def prior_ce_loss(logits: Tensor, codes: Tensor, tgt_mask: Tensor,
                  loss_norm: str = "masked", rows: Optional[BatchRows] = None) -> Tensor:
    """Mean per-quantizer cross-entropy of logits (B, n_q, L, V + 1),
    zero-masked at pads, against codes (B, n_q, L) (pad = V).  With
    ``rows``, this rank's share of the whole batch's mean."""
    log_probs = F.log_softmax(logits, dim=-1)
    picked = torch.gather(log_probs, -1, codes.long()[..., None])[..., 0]
    if loss_norm == "reference":
        if rows is None:
            return -picked.mean()
        return -picked.sum() / denominator(torch.tensor(float(picked.numel()), device=picked.device), rows)
    valid = (~tgt_mask)[:, None, :].float()
    # the numerator spans all n_q rows, so the denominator does too
    return -(picked * valid).sum() / denominator(valid.sum() * logits.shape[1], rows)


def compute_losses(prior, prob, batch: Dict[str, Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, Tensor]] = None, sigma_min_pva: float = 1e-4,
                   sigma_min_prob: float = 1e-6, loss_norm: str = "masked",
                   rows: Optional[BatchRows] = None) -> Dict[str, Tensor]:
    """The loss dict of one batch, with ``total_loss`` the sum of the five.

    ``batch`` holds tensors on the modules' device: phonemes (B, L), x_len
    (B,), codes (B, n_q, Lf), y_len (B,), phone_dur, sil_dur (B, L), embs
    (B, Lf, 256), prompts (B, n_q, P), spks (B, 256) and, from a collator
    with prompt buckets, prompt_lens (B,).  With ``rows`` the batch is this
    rank's rows of a batch split over a data group: the draws are the whole
    batch's (sliced) and each loss is this rank's share of the whole
    batch's (the group's sum is the loss)."""
    draws = draws or {}
    unknown = set(draws) - set(DRAW_KEYS)
    if unknown:
        raise ValueError(f"unknown draws {sorted(unknown)}; expected some of {DRAW_KEYS}")
    phonemes, x_len, y_len = batch["phonemes"], batch["x_len"], batch["y_len"]
    codes, prompts = batch["codes"], batch["prompts"]
    b, l = phonemes.shape
    lf = codes.shape[-1]

    src_mask = mask_from_lengths(x_len, l)
    tgt_mask = mask_from_lengths(y_len, lf)
    enc_out = prior.encode(phonemes.long(), src_mask)
    noise = None
    if "dur_noise" in draws or "sil_noise" in draws:
        noise = (draws["dur_noise"], draws["sil_noise"])
    losses = pva_loss(prior, enc_out, src_mask, batch["phone_dur"], batch["sil_dur"],
                      sigma_min_pva, generator, draws.get("pva_t"), noise, loss_norm, rows)

    # teacher-forced length regulation
    lr_out, _ = length_regulate(enc_out, batch["phone_dur"], batch["sil_dur"], x_len, lf)
    prompt_lens = batch.get("prompt_lens")
    if prompt_lens is None:  # a batch without prompt buckets: the whole prompt is valid
        prompt_lens = torch.full((b,), prompts.shape[-1], dtype=torch.long, device=prompts.device)
    hiddens, logits = prior.decode(lr_out, tgt_mask, prompts.long(), prompt_lens)
    losses["prior_loss"] = prior_ce_loss(logits, codes, tgt_mask, loss_norm, rows)
    losses.update(prob_loss(prob, batch["embs"], hiddens, batch["spks"], tgt_mask,
                            sigma_min_prob, generator, draws.get("prob_t"),
                            draws.get("prob_noise"), loss_norm, rows))
    losses["total_loss"] = sum(v for k, v in losses.items() if k.endswith("_loss"))
    return losses
