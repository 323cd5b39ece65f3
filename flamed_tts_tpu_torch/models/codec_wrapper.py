"""FaCodec: frozen codec parameters on one device, with prompt analysis
(``encode_prompt``), waveform synthesis (``decode``) and the whole
analysis-synthesis loop (``round_trip``).

The prompt wav is zero-padded to a seconds bucket, as the JAX package
pads it, so that the codes and the timbre equal its outputs.
``cast_inference_params`` rounds the parameters to bfloat16; the codec's
activations then follow them (ops/conv1d.py).  ``fuse_blocks`` chooses the
kernel behind a block's three residual units on the card: one K2 launch a
unit (the default), or one K3 launch a block where
``ops.resunit.stack_tile`` admits it.  The residual units' conv weights are
laid out for those kernels once, where the parameters are taken or cast
(``enc_prepared`` / ``dec_prepared``, beside the parameter trees), not on
every launch.

``round_trip`` runs under the host spans ``codec_encode`` (the encoder and
``analyze``) and ``codec_decode`` (``vq2emb`` and the decoder), and marks
the same stages on the device (``utils/profiling.py``), read after its one
host read.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from flamed_tts_tpu_torch.config import load_default_config
from flamed_tts_tpu_torch.convert import codec_tree
from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.models.facodec.decoder import (analyze, init_decoder_params, synthesize,
                                                         vq2emb)
from flamed_tts_tpu_torch.models.facodec.encoder import encoder_forward, init_encoder_params
from flamed_tts_tpu_torch.ops.masking import mask_from_lengths
from flamed_tts_tpu_torch.ops.resunit import prepare_unit
from flamed_tts_tpu_torch.runtime.buckets import DEFAULT_WAV_SECOND_BUCKETS, pick_bucket
from flamed_tts_tpu_torch.runtime.pytree_io import load_pytree_npz
from flamed_tts_tpu_torch.utils import profiling
from flamed_tts_tpu_torch.utils.profiling import END, mark, sample_span


class FaCodec:
    def __init__(self, enc_params, dec_params, device: Union[str, torch.device, None] = None,
                 sr: int = 16000, up_ratios_enc=(2, 4, 5, 5), up_ratios_dec=(5, 5, 4, 2),
                 fuse_blocks: bool = False):
        self.device = resolve_device(device)
        self.fuse_blocks = bool(fuse_blocks)
        self.enc_params = codec_tree(enc_params, self.device)
        self.dec_params = codec_tree(dec_params, self.device)
        self.sr = sr
        self.up_ratios_enc = tuple(up_ratios_enc)
        self.up_ratios_dec = tuple(up_ratios_dec)
        self.hop = int(np.prod(self.up_ratios_enc))
        self._prepare_kernel_weights()

    def _prepare_kernel_weights(self) -> None:
        """Per block, its residual units' conv weights in the kernels'
        layout for the parameters' type.  Call again after the parameters
        change."""
        self.enc_prepared = [[prepare_unit(u) for u in blk["res"]] for blk in self.enc_params["blocks"]]
        self.dec_prepared = [[prepare_unit(u) for u in blk["res"]] for blk in self.dec_params["blocks"]]

    @classmethod
    def from_pretrained(cls, ckpt_dir: str, codec_cfg: Optional[Dict] = None,
                        device: Union[str, torch.device, None] = None,
                        fuse_blocks: bool = False) -> "FaCodec":
        """Load the converted .npz checkpoints named by ``codec_cfg``
        (default ``configs/codec.yaml``) from ``ckpt_dir``."""
        device = resolve_device(device)
        cfg = codec_cfg or load_default_config()["codec_cfg"]
        trees = []
        for part in ("encoder", "decoder"):
            path = os.path.join(ckpt_dir, cfg[part]["ckpt_filename"])
            if not os.path.isfile(path):
                raise FileNotFoundError(f"codec checkpoint not found: {path}")
            trees.append(load_pytree_npz(path))
        return cls(*trees, device=device, sr=cfg.get("sr", 16000),
                   up_ratios_enc=cfg["encoder"]["up_ratios"],
                   up_ratios_dec=cfg["decoder"]["up_ratios"], fuse_blocks=fuse_blocks)

    @classmethod
    def random_init(cls, generator: torch.Generator, device: Union[str, torch.device, None] = None,
                    codec_cfg: Optional[Dict] = None, fuse_blocks: bool = False) -> "FaCodec":
        """Random weights with the converted checkpoints' structure."""
        cfg = codec_cfg or load_default_config()["codec_cfg"]
        enc, dec = cfg["encoder"], cfg["decoder"]
        return cls(init_encoder_params(generator, enc["ngf"], enc["up_ratios"], enc["out_channels"]),
                   init_decoder_params(generator, dec["in_channels"], dec["upsample_initial_channel"],
                                       dec["up_ratios"]),
                   device=device, sr=cfg.get("sr", 16000),
                   up_ratios_enc=enc["up_ratios"], up_ratios_dec=dec["up_ratios"],
                   fuse_blocks=fuse_blocks)

    def cast_inference_params(self, dtype: torch.dtype = torch.bfloat16) -> None:
        """Round every float parameter to ``dtype``.  The values equal the
        JAX package's after its cast.  The snakes' log alpha / beta are kept
        in float32 storage after the rounding: every snake reads them as
        float32, and an upcast in each of its calls would cost a launch."""
        def cast(tree, under_act=False):
            if isinstance(tree, dict):
                return {k: cast(v, under_act or k in ("act", "act1", "act2", "final_act"))
                        for k, v in tree.items()}
            if isinstance(tree, list):
                return [cast(v, under_act) for v in tree]
            if not tree.is_floating_point():
                return tree
            return tree.to(dtype).float() if under_act else tree.to(dtype)

        self.enc_params = cast(self.enc_params)
        self.dec_params = cast(self.dec_params)
        self._prepare_kernel_weights()

    def pad_prompt_wav(self, wav: np.ndarray) -> Tuple[np.ndarray, int]:
        """Prompt wav (T,) -> (seconds-bucket padded wav, true frame count)."""
        wav = np.asarray(wav, dtype=np.float32).squeeze()
        n = wav.shape[-1]
        bucket_s = pick_bucket(max(1, int(np.ceil(n / self.sr))), DEFAULT_WAV_SECOND_BUCKETS)
        padded = np.zeros(bucket_s * self.sr, dtype=np.float32)
        padded[: min(n, len(padded))] = wav[: len(padded)]
        return padded, n // self.hop

    def _analyze(self, wav: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """wav (T,) -> (codes (6, 1, T'), timbre (1, 256), true frame count)
        of the seconds-bucket padded wav."""
        padded, n_frames = self.pad_prompt_wav(wav)
        wav_t = torch.as_tensor(padded, device=self.device)[None, :, None]
        pad_mask = mask_from_lengths(torch.tensor([n_frames], device=self.device),
                                     len(padded) // self.hop)
        mark("codec_encode")
        latents = encoder_forward(self.enc_params, wav_t, self.up_ratios_enc, self.fuse_blocks,
                                  self.enc_prepared)
        codes, timbre = analyze(self.dec_params, latents, pad_mask)
        return codes, timbre, n_frames

    @torch.no_grad()
    def encode_prompt(self, wav: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Prompt wav (T,) float32 -> (codes (6, T') int32, timbre (256,))."""
        codes, timbre, n_frames = self._analyze(wav)
        return codes[:, 0, :n_frames].cpu().numpy(), timbre[0].float().cpu().numpy()

    @torch.no_grad()
    def decode(self, latents: torch.Tensor, timbre: torch.Tensor) -> torch.Tensor:
        """latents (B, T, 256) + timbre (B, 256) -> wav (B, T * hop, 1)."""
        return synthesize(self.dec_params, latents, timbre, self.up_ratios_dec, self.fuse_blocks,
                          self.dec_prepared)

    @torch.no_grad()
    def round_trip(self, wav: np.ndarray) -> np.ndarray:
        """wav (T,) -> decode(vq2emb(analyze(encode(wav)))) (T',) float32:
        the full analysis-synthesis loop, cut to the whole frames of the
        input."""
        marks = profiling.call_marks(self.device)
        with profiling.collect(marks):
            with sample_span("codec_encode"):
                codes, timbre, n_frames = self._analyze(wav)
            with sample_span("codec_decode"):
                mark("codec_decode")
                out = self.decode(vq2emb(self.dec_params, codes), timbre)
                mark(END)
            out = out[0, : n_frames * self.hop, 0].float().cpu().numpy()
        profiling.read_marks(marks)
        return out
