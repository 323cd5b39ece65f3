"""Prior generator: phoneme encoder -> PVA fields -> shared and
per-quantizer FFT decoders over a compacted [prompt ‖ target] layout.

Target token i sits right after the last real prompt token and gets
position ``prompt_len + i``, as in the reference's exact-length
concatenation, whatever the prompt bucket; padded prompt slots are masked
out of attention.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import Tensor, nn

from flamed_tts_tpu_torch import precision
from flamed_tts_tpu_torch.models.prior.pva import ProbabilisticModule
from flamed_tts_tpu_torch.ops.embeddings import sinusoid_position_table
from flamed_tts_tpu_torch.ops.fft_block import FFTBlock
from flamed_tts_tpu_torch.ops.masking import apply_mask
from flamed_tts_tpu_torch.text.symbols import symbols

# Size of the phoneme symbol table (text/symbols.py); the embedding has
# N_SYMBOLS + 1 rows.
N_SYMBOLS = len(symbols)


class FFTStack(nn.Module):
    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int, kernel_sizes,
                 dropout: float = 0.0):
        super().__init__()
        d_k = d_model // n_head
        for i in range(n_layers):
            self.add_module(f"layer_{i}", FFTBlock(d_model, n_head, d_k, d_k, d_inner, kernel_sizes,
                                                   dropout))

    def forward(self, x: Tensor, pad_mask: Tensor) -> Tensor:
        for layer in self.children():
            x = layer(x, pad_mask)
        return x


class PriorGenerator(nn.Module):
    def __init__(self, config: Dict):
        super().__init__()
        tcfg, vcfg, ccfg = config["transformer"], config["variance_adaptor"], config["codec"]
        self.enc_hidden = tcfg["encoder_hidden"]
        self.dec_hidden = tcfg["decoder_hidden"]
        self.vocab_size = ccfg["vocab_size"]
        self.n_quantizers = ccfg["n_quantizers"]
        self.enc_max_len = tcfg["encoder_max_seq_len"]
        self.dec_max_len = tcfg["decoder_max_seq_len"]

        self.src_word_emb = precision.Embedding(N_SYMBOLS + 1, self.enc_hidden)
        self.encoder = FFTStack(tcfg["encoder_layer"], self.enc_hidden, tcfg["encoder_head"],
                                tcfg["encoder_conv_filter_size"], tcfg["encoder_conv_kernel_size"],
                                tcfg["encoder_dropout"])
        for name in ("duration_generator", "sil_generator"):
            g = vcfg[name]
            self.add_module(name, ProbabilisticModule(g["input_size"], g["filter_size"],
                                                      g["kernel_size"], g["time_scale"],
                                                      g["drop_out"]))
        self.bridge = precision.Linear(self.enc_hidden, self.dec_hidden)
        # the last id is padding (zero row in converted checkpoints)
        self.code_embedding = precision.Embedding(self.vocab_size + 1, self.dec_hidden)

        def decoder(n_layers):
            return FFTStack(n_layers, self.dec_hidden, tcfg["decoder_head"],
                            tcfg["decoder_conv_filter_size"], tcfg["decoder_conv_kernel_size"],
                            tcfg["decoder_dropout"])

        self.shared_decoder = decoder(tcfg["decoder_shared_layers"])
        self.n_prior_decoders = len(tcfg["decoder_layers"])
        for i, n in enumerate(tcfg["decoder_layers"]):
            self.add_module(f"prior_decoder_{i}", decoder(n))
        self.prompt_seg_emb = nn.Parameter(torch.zeros(1, 1, self.dec_hidden))
        self.target_seg_emb = nn.Parameter(torch.zeros(1, 1, self.dec_hidden))
        self.quantizer_emb = precision.Embedding(self.n_quantizers, self.dec_hidden)
        self.head = precision.Linear(self.dec_hidden, self.vocab_size + 1)

    def encode(self, phonemes: Tensor, src_mask: Tensor) -> Tensor:
        l = phonemes.shape[1]
        if l > self.enc_max_len:
            raise ValueError(f"phoneme length {l} exceeds encoder table")
        pos = sinusoid_position_table(l, self.enc_hidden, phonemes.device)
        return self.encoder(self.src_word_emb(phonemes) + pos[None], src_mask)

    def pva_fields(self, dur_t: Tensor, sil_t: Tensor, enc_out: Tensor, t: Tensor,
                   src_mask: Tensor) -> Tuple[Tensor, Tensor]:
        return (self.duration_generator(dur_t, enc_out, t, src_mask),
                self.sil_generator(sil_t, enc_out, t, src_mask))

    def decode(self, lr_out: Tensor, tgt_mask: Tensor, prompts: Tensor,
               prompt_lens: Tensor) -> Tuple[Tensor, Tensor]:
        """lr_out (B, L, H), prompts (B, n_q, P) -> (hiddens (B, n_q, L, D),
        logits (B, n_q, L, vocab + 1))."""
        b, l, _ = lr_out.shape
        p = prompts.shape[-1]
        concat_len = p + l
        if concat_len > self.dec_max_len:
            raise ValueError(f"[prompt‖target] length {concat_len} exceeds table")
        dev = lr_out.device
        pos_table = sinusoid_position_table(concat_len, self.dec_hidden, dev)
        output = self.shared_decoder(self.bridge(lr_out) + pos_table[None, :l], tgt_mask)

        p_lens = prompt_lens.long()
        slots = torch.arange(concat_len, device=dev)[None, :]
        in_prompt = slots < p_lens[:, None]
        gather_idx = torch.where(in_prompt, torch.clamp(slots, max=p - 1),
                                 torch.clamp(p + slots - p_lens[:, None], 0, concat_len - 1))
        tgt_lens = (~tgt_mask).sum(dim=1)
        concat_mask = slots >= (p_lens + tgt_lens)[:, None]
        scatter_idx = torch.clamp(p_lens[:, None] + torch.arange(l, device=dev)[None, :],
                                  max=concat_len - 1)
        seg = torch.where(in_prompt[:, :, None], self.prompt_seg_emb, self.target_seg_emb)
        prompt_embs = self.code_embedding(prompts.long())
        d = self.dec_hidden

        hiddens = []
        for ith in range(self.n_prior_decoders):
            cat = torch.cat([prompt_embs[:, ith], output], dim=1)
            x = torch.gather(cat, 1, gather_idx[:, :, None].expand(b, concat_len, d))
            x = x + seg + self.quantizer_emb.weight[ith] + pos_table[None]
            x = getattr(self, f"prior_decoder_{ith}")(x, concat_mask)
            output = apply_mask(torch.gather(x, 1, scatter_idx[:, :, None].expand(b, l, d)), tgt_mask)
            hiddens.append(output)
        hiddens = torch.stack(hiddens, dim=1)
        logits = apply_mask(self.head(hiddens), tgt_mask[:, None, :])
        return hiddens, logits
