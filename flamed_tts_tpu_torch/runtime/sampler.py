"""Bucketed sampling: the JAX package's staged and fused paths.

Staged (``fused=False``):
  stage 1 (phoneme bucket L): encode + PVA Euler loop -> integer
      durations and the target length;
  the host reads the target length and picks the tightest frame bucket F;
  stage 2 (L, F, prompt bucket P): length regulation -> per-quantizer
      decoders -> denoiser Euler loop -> latents -> codec synthesis.

Fused (``fused=True``): the same stages queued on the device back to back
at a speculative frame bucket (the phoneme count times a frames-per-phoneme
budget learnt from earlier calls), with no host read between the duration
sampler and the denoiser; one transfer at the end brings the raw target
length, the clipped one, the mask and the wav, and where the target length
overflowed the bucket, the stages after the duration sampler run once more
at the bucket it needs.  With
``prompt_wav`` the prompt's encode + analyze runs on the device in the same
queue (the wav goes up as int16 PCM), so the whole utterance is one upload,
one queue of work and one download.

Inputs are padded to the same buckets as in the JAX package, so for the
same noise the outputs are the same.  Noise is drawn from ``generator``
unless given in ``noise`` ({"dur", "sil": (B, L), "latents": (B, F, 256)},
standard normal, at the bucket shapes; in the fused path F is the
speculative bucket, or the retry's bucket after an overflow).  With a
codec the wav is quantized to int16 PCM on the device and comes back as
float32 / 32767.

With ``mesh`` (``parallel/mesh.py``) the batch is split over the mesh's
``data`` axis, as the JAX sampler shards it (throughput mode): every rank
calls ``sample`` with the whole batch, which is padded with repeats of row
0 up to a multiple of the axis; the phoneme, prompt and frame buckets are
picked from the whole batch; each rank samples its rows (with a prompt
wav, its own prompt analysis through K1/K2); the speculative bucket's
overflow retry, and the staged path's frame bucket, follow the largest
target length over the ranks (the target lengths are gathered before the
decision, so every rank makes the same one); and the outputs are gathered,
so that every rank returns the whole batch with the pad rows cut off.
Noise drawn from
the generator is drawn for the real rows of the whole batch, a pad row
taking row 0's, and sliced, so each row gets the noise it gets without a
mesh; noise given in ``noise`` is the whole batch's and is sliced so too.

Compiled once (``graphs``, the default): on the card each signature of a
call (the path: ``stage1``, ``stage2``, ``fused`` or ``fused_p`` with a
prompt wav; the batch, the phoneme, prompt and frame buckets, the prompt
wav's padded length, the Euler step counts, the codec, the parameters'
type, the matmul precision and the TF32 switches) is captured once as a
CUDA graph (``runtime/graphs.py``) and every later call replays it, as the
JAX package compiles each signature once under ``jax.jit``.  The noise is
drawn from the generator outside the graph, in the order the eager call
draws it, and goes in with the other inputs, the temperatures as device
scalars; so the replayed call computes what the eager one computes, with
the same kernels in the same order.  The fused path's overflow retry
replays the ``stage2`` graph at the larger bucket.  ``graphs=False`` runs
every call eagerly (the counterpart of ``jax.disable_jit``); so does a
call on the CPU, and one with a ``mesh`` (its collectives stay eager).
``captures`` counts the signatures captured; the graphs read the
parameters where they lay at the capture, so after the parameters are
replaced ``reset_graphs()`` must drop them.

Device time per stage (``utils/profiling.py``'s marks, while a timer is
installed): ``codec_encode`` (the prompt's encode + analyze), ``durations``
(the encoder and the PVA loop), ``prior_decode`` (length regulation and
the prior's decoders), ``denoiser`` (the denoiser's Euler loop) and
``codec_decode`` (the codec's synthesis and the int16 quantization), in
the graph as event nodes or recorded eagerly, read after each host read
(outside the ``fused_get`` span).  An overflow retry counts its stages
again: the device ran them twice.  Whether marks are on is part of a
graph's signature.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from flamed_tts_tpu_torch import precision
from flamed_tts_tpu_torch.models.facodec.decoder import analyze
from flamed_tts_tpu_torch.models.facodec.encoder import encoder_forward
from flamed_tts_tpu_torch.models.prior.sampling import pva_sample
from flamed_tts_tpu_torch.models.prob.prob_generator import prob_sample
from flamed_tts_tpu_torch.ops.length_regulator import length_regulate
from flamed_tts_tpu_torch.ops.masking import mask_from_lengths
from flamed_tts_tpu_torch.parallel.mesh import axis_size, gather_rows, pad_rows, rows_of
from flamed_tts_tpu_torch.runtime.buckets import pick_bucket
from flamed_tts_tpu_torch.runtime.graphs import CapturedCall
from flamed_tts_tpu_torch.utils import profiling
from flamed_tts_tpu_torch.utils.profiling import END, mark, sample_span

PCM_SCALE = 32767.0
FIRST_FRAMES_PER_PHONEME = 9.0  # the budget before any call has been observed
MIN_FRAMES_PER_PHONEME = 7.0    # floor under the learnt budget
RATIO_HISTORY = 256             # observed ratios kept


class _Rows:
    """This rank's rows [lo, hi) of a batch of ``real`` rows padded to
    ``total`` with repeats of row 0."""

    def __init__(self, lo: int, hi: int, real: int, total: int):
        self.lo, self.hi, self.real, self.total = lo, hi, real, total

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """The whole real batch's ``t`` -> this rank's rows of it padded."""
        if self.total > self.real:
            t = torch.cat([t, t[:1].expand(self.total - self.real, *t.shape[1:])])
        return t[self.lo:self.hi]


def _noise(noise: Optional[Dict], key: str, shape, device, generator,
           rows: Optional[_Rows] = None) -> torch.Tensor:
    """Standard-normal noise of ``shape`` (this rank's rows where ``rows``
    is given: drawn, or given, for the whole real batch and sliced)."""
    if rows is not None:
        shape = (rows.real, *shape[1:])
    given = (noise or {}).get(key)
    if given is None:
        out = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        out = torch.as_tensor(np.array(given, dtype=np.float32), device=device)
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"noise[{key!r}] has shape {tuple(out.shape)}, expected {tuple(shape)}")
    return out if rows is None else rows.take(out)


def pcm16(wav: torch.Tensor) -> torch.Tensor:
    """Float wav -> int16 PCM, the quantization a 16-bit WAV file applies."""
    return torch.round(torch.clamp(wav.float(), -1.0, 1.0) * PCM_SCALE).to(torch.int16)


class BucketedSampler:
    def __init__(self, prior, prob, phoneme_buckets: Sequence[int],
                 frame_buckets: Sequence[int], prompt_buckets: Sequence[int], graphs: bool = True):
        self.prior = prior
        self.prob = prob
        self.phoneme_buckets = list(phoneme_buckets)
        self.frame_buckets = list(frame_buckets)
        self.prompt_buckets = list(prompt_buckets)
        # observed frames per phoneme, for the fused path's speculative bucket
        self._ratio_history: list = []
        # compiled once: a CapturedCall a signature, all in one memory pool
        # (a call clones its outputs before another graph replays)
        self.graphs = graphs
        # the type a signature is captured in; None: a CUDA graph for a call
        # on the card, none on the CPU (the tests set a stand-in)
        self.graph_class = None
        self._graphs: Dict[tuple, CapturedCall] = {}
        self._pool = None

    @property
    def captures(self) -> int:
        """Signatures captured so far: the size of the JAX package's jit cache."""
        return len(self._graphs)

    def reset_graphs(self) -> None:
        """Drop the captured graphs: they read the parameters where they lay."""
        self._graphs.clear()
        self._pool = None

    def _signature(self, codec) -> tuple:
        """What a graph depends on beside its path, shapes and step counts."""
        return (next(self.prior.parameters()).dtype, next(self.prob.parameters()).dtype,
                precision.get_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32, profiling.marking(),
                None if codec is None else (codec, codec.fuse_blocks,
                                            codec.dec_params["stem"]["w"].dtype))

    def _run(self, key: Optional[tuple], fn, inputs: Dict[str, torch.Tensor]) -> tuple:
        """``fn(**inputs)``: eagerly where ``key`` is None, else by replaying
        the graph of signature ``key``, captured at its first call."""
        if key is None:
            return fn(**inputs)
        call = self._graphs.get(key)
        if call is None:
            with sample_span("capture"):
                call = (self.graph_class or CapturedCall)(fn, inputs, self._pool)
            self._graphs[key] = call
            self._pool = call.pool
        return call(inputs)

    # --- the stages, all on the device -----------------------------------

    def _durations(self, nfe, phonemes, src_lens, dur, sil, temperature):
        """Stage 1 on the noise ``dur``, ``sil`` (B, L): (enc_out, phone_dur,
        sil_dur, the raw target length)."""
        mark("durations")
        src_mask = mask_from_lengths(src_lens, phonemes.shape[1])
        enc_out = self.prior.encode(phonemes, src_mask)
        phone_dur, sil_dur = pva_sample(self.prior, enc_out, src_mask, dur, sil, nfe, temperature)
        valid = (~src_mask).float()
        tgt_len = ((torch.clamp(phone_dur, min=1.0) * valid).sum(1)
                   + (sil_dur * valid).sum(1)).to(torch.int64)
        mark(END)
        return enc_out, phone_dur, sil_dur, tgt_len

    def _frames(self, nfe, f_bucket, codec, enc_out, phone_dur, sil_dur, src_lens, prompts,
                prompt_lens, timbres, latents, temperature):
        """Stage 2 at frame bucket ``f_bucket`` on the noise ``latents``
        (B, F, 256): (latents, hiddens, logits, tgt_len, tgt_mask, int16 wav
        or None)."""
        mark("prior_decode")
        lr_out, tgt_len = length_regulate(enc_out, phone_dur, sil_dur, src_lens, f_bucket)
        tgt_mask = mask_from_lengths(tgt_len, f_bucket)
        hiddens, logits = self.prior.decode(lr_out, tgt_mask, prompts, prompt_lens)
        mark("denoiser")
        latents = prob_sample(self.prob, hiddens, timbres, tgt_mask, latents, nfe, temperature)
        wav = None
        if codec is not None:
            mark("codec_decode")
            wav = pcm16(codec.decode(latents, timbres.to(latents.dtype)))
        mark(END)
        return latents, hiddens, logits, tgt_len, tgt_mask, wav

    def _fused(self, nsteps_durgen, nsteps_denoiser, f_bucket, codec, p_bucket, vocab_pad, *,
               phonemes, src_lens, dur, sil, latents, temp_durgen, temp_denoiser, prompts=None,
               prompt_lens=None, timbres=None, wav=None, wav_frames=None):
        """The fused call: the prompt's analysis where ``wav`` is given, stage
        1, stage 2 at ``f_bucket``.  Returns stage 1's outputs and the prompt's
        (what an overflow retry reads), then stage 2's."""
        if wav is not None:
            prompts, prompt_lens, timbres = self._analyze_prompt(codec, wav, wav_frames, p_bucket,
                                                                 vocab_pad)
        first = self._durations(nsteps_durgen, phonemes, src_lens, dur, sil, temp_durgen)
        return (*first, prompts, prompt_lens, timbres,
                *self._frames(nsteps_denoiser, f_bucket, codec, *first[:3], src_lens, prompts,
                              prompt_lens, timbres, latents, temp_denoiser))

    def _stage1(self, phonemes, src_lens, noise, generator, nfe, temperature, rows=None):
        """``_durations`` on noise given in ``noise`` or drawn from ``generator``."""
        b, l_bucket = phonemes.shape
        return self._durations(
            nfe, phonemes, src_lens,
            _noise(noise, "dur", (b, l_bucket), phonemes.device, generator, rows),
            _noise(noise, "sil", (b, l_bucket), phonemes.device, generator, rows), temperature)

    def _stage2(self, enc_out, phone_dur, sil_dur, src_lens, prompts, prompt_lens, f_bucket,
                timbres, noise, generator, nfe, temperature, codec, rows=None):
        """``_frames`` on noise given in ``noise`` or drawn from ``generator``."""
        latents = _noise(noise, "latents", (enc_out.shape[0], f_bucket, self.prob.target_dim),
                         enc_out.device, generator, rows)
        return self._frames(nfe, f_bucket, codec, enc_out, phone_dur, sil_dur, src_lens, prompts,
                            prompt_lens, timbres, latents, temperature)

    def _analyze_prompt(self, codec, wav, wav_frames, p_bucket, vocab_pad):
        """Prompt audio (B, T, 1) int16 PCM (or float) + true frame counts
        -> (codes (B, n_q, p_bucket) with ``vocab_pad`` past the true
        length, prompt_lens, timbres float32), all on the device."""
        mark("codec_encode")
        if not wav.is_floating_point():
            wav = wav.to(torch.float32) * (1.0 / PCM_SCALE)
        n_frames_total = wav.shape[1] // codec.hop
        # a prompt longer than the largest seconds bucket arrives cut short
        wav_frames = torch.clamp(wav_frames, max=n_frames_total)
        pad_mask = mask_from_lengths(wav_frames, n_frames_total)
        latents = encoder_forward(codec.enc_params, wav, codec.up_ratios_enc, codec.fuse_blocks,
                                  codec.enc_prepared)
        codes, timbre = analyze(codec.dec_params, latents, pad_mask)
        prompts = codes.permute(1, 0, 2).to(torch.int64)  # (B, n_q, T')
        if p_bucket <= n_frames_total:
            prompts = prompts[:, :, :p_bucket]
        else:
            prompts = torch.nn.functional.pad(prompts, (0, p_bucket - n_frames_total))
        slot = torch.arange(p_bucket, device=wav.device)[None, None, :]
        prompts = torch.where(slot < wav_frames[:, None, None], prompts,
                              torch.full_like(prompts, vocab_pad))
        prompt_lens, timbre = torch.clamp(wav_frames, max=p_bucket), timbre.float()
        mark(END)
        return prompts, prompt_lens, timbre

    # --- public API --------------------------------------------------------

    @torch.no_grad()
    def sample(self, phonemes: np.ndarray, src_lens: np.ndarray, prompts: Optional[np.ndarray],
               prompt_lens: Optional[np.ndarray], timbres: Optional[np.ndarray],
               device: torch.device,
               nsteps_durgen: int = 64, nsteps_denoiser: int = 64,
               temp_durgen: float = 0.3, temp_denoiser: float = 0.3, vocab_pad: int = 1024,
               codec=None, noise: Optional[Dict] = None,
               generator: Optional[torch.Generator] = None,
               fused: bool = True, frames_per_phoneme_budget: Optional[float] = None,
               prompt_wav: Optional[np.ndarray] = None,
               prompt_frames: Optional[np.ndarray] = None, mesh=None) -> Dict:
        """phonemes (B, L) with src_lens (B,), and either prompts (B, n_q, P)
        + prompt_lens + timbres (B, 256), or prompt_wav (B, T) padded audio
        + prompt_frames (B,) true frame counts (fused only, needs ``codec``).
        ``mesh``: the batch split over its data axis (module docstring).

        Returns {"latents" (B, F, 256), "prior_embs", "prior_logits",
        "tgt_len" (B,) numpy, "tgt_mask" (B, F) numpy, "frame_bucket" F} and
        with a codec "wav" (B, F * hop, 1) float32 numpy."""
        if prompt_wav is not None and not fused:
            raise ValueError(
                "prompt_wav (prompt analysis queued with the sampling) requires fused=True; "
                "use codec.encode_prompt + prompts/timbres for the staged path")
        b_real = phonemes.shape[0]
        rows = None
        if mesh is not None:
            total = b_real + (-b_real) % axis_size(mesh, "data")
            phonemes, src_lens = pad_rows(phonemes, total - b_real), pad_rows(src_lens, total - b_real)
            if prompt_wav is not None:
                prompt_wav = pad_rows(np.asarray(prompt_wav), total - b_real)
                prompt_frames = pad_rows(np.asarray(prompt_frames), total - b_real)
            else:
                prompts, prompt_lens, timbres = (pad_rows(a, total - b_real)
                                                 for a in (prompts, prompt_lens, timbres))
            rows = _Rows(*rows_of(total, mesh), b_real, total)
        b, l_in = phonemes.shape
        l_bucket = pick_bucket(l_in, self.phoneme_buckets)
        if l_in > l_bucket:
            warnings.warn(f"phoneme length {l_in} exceeds the largest bucket {l_bucket}; "
                          "input truncated (raise phoneme_buckets)", stacklevel=2)
        phonemes_b = np.zeros((b, l_bucket), dtype=np.int64)
        phonemes_b[:, : min(l_in, l_bucket)] = phonemes[:, :l_bucket]
        src_lens = np.minimum(np.asarray(src_lens, dtype=np.int64), l_bucket)

        if prompt_wav is not None:
            if codec is None:
                raise ValueError("prompt_wav requires `codec`")
            p_in = int(np.max(np.asarray(prompt_frames)))
        else:
            p_in = prompts.shape[-1]
        p_bucket = pick_bucket(p_in, self.prompt_buckets)
        if p_in > p_bucket:
            warnings.warn(f"prompt length {p_in} frames exceeds the largest bucket "
                          f"{p_bucket}; prompt truncated (raise prompt_buckets)", stacklevel=2)

        def dev(a):
            """This rank's rows of a whole-batch array, on the device."""
            return torch.as_tensor(a if rows is None else a[rows.lo:rows.hi], device=device)

        def whole(t):
            """Every rank's rows of a device tensor, the pad rows cut off."""
            return t if rows is None else gather_rows(t, mesh)[:b_real]

        with sample_span("input_place"):
            if prompt_wav is None:
                prompts_b = np.full((b, prompts.shape[1], p_bucket), vocab_pad, dtype=np.int64)
                prompts_b[:, :, : min(p_in, p_bucket)] = prompts[:, :, :p_bucket]
                prompts_t = dev(prompts_b)
                prompt_lens_t = dev(np.minimum(np.asarray(prompt_lens, dtype=np.int64), p_bucket))
                timbres_t = dev(np.asarray(timbres, dtype=np.float32))
            phonemes_t, src_lens_t = dev(phonemes_b), dev(src_lens)

        def result(latents, hiddens, logits, tgt_len_h, tgt_mask_h, wav_h):
            latents, hiddens, logits = whole(latents), whole(hiddens), whole(logits)
            out = {"latents": latents, "prior_embs": hiddens, "prior_logits": logits,
                   "tgt_len": tgt_len_h, "tgt_mask": tgt_mask_h,
                   "frame_bucket": int(latents.shape[1])}
            if wav_h is not None:
                # inverse of the int16 quantization on the device
                out["wav"] = wav_h.astype(np.float32) / PCM_SCALE
            return out

        def observe(tgt_raw_h):
            """tgt_raw_h: the whole batch's raw target lengths (real rows)."""
            ratios = tgt_raw_h / np.maximum(np.asarray(src_lens[:b_real], np.float32), 1.0)
            self._ratio_history.extend(float(r) for r in ratios)
            del self._ratio_history[:-RATIO_HISTORY]
            if int(tgt_raw_h.max()) > self.frame_buckets[-1]:
                warnings.warn(f"sampled target length {int(tgt_raw_h.max())} frames exceeds the "
                              f"largest frame bucket {self.frame_buckets[-1]}; output clipped "
                              "(raise frame_buckets)", stacklevel=3)

        # the signatures' keys, None where the call runs eagerly (module docstring)
        captured = (self.graphs and mesh is None
                    and (self.graph_class is not None or device.type == "cuda"))

        def key(path, *shape, codec=codec):
            return (path, b, l_bucket, *shape, *self._signature(codec)) if captured else None

        def draw(name, shape):
            """Noise ``name`` of ``shape`` (B first): given, or drawn now."""
            return _noise(noise, name, shape, device, generator, rows)

        # one call's device stage marks, read after each host read
        marks = profiling.call_marks(device)
        # the temperatures as device scalars, inputs of a graph like the noise
        temps = [torch.full((), float(t), dtype=torch.float32, device=device)
                 for t in (temp_durgen, temp_denoiser)]

        def stage2(f_bucket, first):
            """Stage 2 at ``f_bucket`` on stage 1's ``first`` (enc_out,
            phone_dur, sil_dur)."""
            inputs = dict(zip(("enc_out", "phone_dur", "sil_dur"), first), src_lens=src_lens_t,
                          prompts=prompts_t, prompt_lens=prompt_lens_t, timbres=timbres_t,
                          latents=draw("latents", (b, f_bucket, self.prob.target_dim)),
                          temperature=temps[1])
            return self._run(key("stage2", p_bucket, f_bucket, nsteps_denoiser),
                             functools.partial(self._frames, nsteps_denoiser, f_bucket, codec), inputs)

        if fused:
            if frames_per_phoneme_budget is None:
                if self._ratio_history:
                    # p95 * margin of the observed speech rates, floored so
                    # that one fast utterance cannot provoke overflow retries
                    frames_per_phoneme_budget = max(
                        float(np.percentile(self._ratio_history[-64:], 95) * 1.2),
                        MIN_FRAMES_PER_PHONEME)
                else:
                    frames_per_phoneme_budget = FIRST_FRAMES_PER_PHONEME
            f_guess = pick_bucket(int(np.max(src_lens) * frames_per_phoneme_budget),
                                  self.frame_buckets)
            if prompt_wav is not None:
                with sample_span("prompt_place"):
                    # int16 PCM on the wire, as on the way out: the prompt
                    # comes from a 16-bit file, so nothing is lost and the
                    # upload halves
                    wav_q = np.round(np.clip(np.asarray(prompt_wav, dtype=np.float32), -1.0, 1.0)
                                     * PCM_SCALE).astype(np.int16)
                    wav_t = dev(wav_q[:, :, None])
                    frames_t = dev(np.asarray(prompt_frames, dtype=np.int64))

            def fetch(res, *more):
                """The one transfer: lengths, mask and wav together (the whole
                batch's on a mesh)."""
                host = [whole(t).cpu().numpy() for t in more + (res[3], res[4])]
                return host + [None if res[5] is None else whole(res[5]).cpu().numpy()]

            # fused_dispatch: the host's time to enqueue the whole fused call
            # (prompt analysis, both Euler loops, the decoder), or the replay
            # of its graph.  Nothing is read back before fetch(); the one host
            # read is fused_get, which waits for the device.
            with profiling.collect(marks):
                with sample_span("fused_dispatch"):
                    inputs = dict(phonemes=phonemes_t, src_lens=src_lens_t,
                                  dur=draw("dur", (b, l_bucket)), sil=draw("sil", (b, l_bucket)),
                                  latents=draw("latents", (b, f_guess, self.prob.target_dim)),
                                  temp_durgen=temps[0], temp_denoiser=temps[1])
                    if prompt_wav is not None:
                        inputs.update(wav=wav_t, wav_frames=frames_t)
                        path = key("fused_p", p_bucket, wav_t.shape[1], f_guess, nsteps_durgen,
                                   nsteps_denoiser, vocab_pad)
                    else:
                        inputs.update(prompts=prompts_t, prompt_lens=prompt_lens_t, timbres=timbres_t)
                        path = key("fused", p_bucket, f_guess, nsteps_durgen, nsteps_denoiser)
                    out = self._run(path, functools.partial(self._fused, nsteps_durgen, nsteps_denoiser,
                                                            f_guess, codec, p_bucket, vocab_pad), inputs)
                    first, tgt_raw = out[:3], out[3]
                    prompts_t, prompt_lens_t, timbres_t = out[4:7]
                    res = out[7:]
                with sample_span("fused_get"):
                    tgt_raw_h, tgt_len_h, tgt_mask_h, wav_h = fetch(res, tgt_raw)
            profiling.read_marks(marks)
            observe(tgt_raw_h)
            if int(tgt_raw_h.max()) > f_guess and f_guess < self.frame_buckets[-1]:
                # overflow: the durations stand (the JAX package gets the same
                # ones again from the same key); only the stages that depend on
                # the bucket run again
                with profiling.collect(marks):
                    with sample_span("fused_dispatch"):
                        res = stage2(pick_bucket(int(tgt_raw_h.max()), self.frame_buckets), first)
                    with sample_span("fused_get"):
                        tgt_len_h, tgt_mask_h, wav_h = fetch(res)
                profiling.read_marks(marks)
            return result(res[0], res[1], res[2], tgt_len_h, tgt_mask_h, wav_h)

        inputs = dict(phonemes=phonemes_t, src_lens=src_lens_t, dur=draw("dur", (b, l_bucket)),
                      sil=draw("sil", (b, l_bucket)), temperature=temps[0])
        with profiling.collect(marks):
            *first, tgt_est = self._run(key("stage1", nsteps_durgen, codec=None),
                                        functools.partial(self._durations, nsteps_durgen), inputs)
            tgt_est_h = whole(tgt_est).cpu().numpy()  # the one host read between the stages
        profiling.read_marks(marks)
        observe(tgt_est_h)
        with profiling.collect(marks):
            latents, hiddens, logits, tgt_len, tgt_mask, wav = stage2(
                pick_bucket(int(tgt_est_h.max()), self.frame_buckets), first)
            host = [whole(t).cpu().numpy() for t in (tgt_len, tgt_mask)]
            wav_h = None if wav is None else whole(wav).cpu().numpy()
        profiling.read_marks(marks)
        return result(latents, hiddens, logits, *host, wav_h)
