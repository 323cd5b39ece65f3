"""Flamed-TTS serving, a closed loop of one client.

* ``batch`` 1: ``Flamed.sample(text=..., prompt_raw=wav, codec=...)``, the
  text through the program's frontend and each request's own prompt wav
  analysed in the same call; latency is that call, ending in the wav on
  the host.
* ``batch`` > 1: ``Flamed.sample_batch`` on phoneme rows padded to the
  longest, the prompts as codes and timbre from a prompt cache filled at
  set-up (``FaCodec.encode_prompt`` of the mix's ``speakers``).

The prior and prob weights are made from the seed on the card (``weights``),
the codec read from the configuration's checkpoint, both cast as the
configuration states.  Warm-up runs the mix's sizes until a pass adds no
captured signature.  The check runs the plain reference
(``benchmark/reference``) on a sample of the window's requests.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import costs, generator, weights
from benchmark.harness import Ctx, PooledGap, sample
from benchmark.reference import codec as ref_codec
from benchmark.reference import flamed as ref_flamed
from benchmark.reference.frontend import read_words, text_to_ids
from benchmark.reference.numerics import Numerics, exact_float32
from benchmark.reference.serving import (MIN_BUDGET, FrameBudget, PlainServing, noise_draws, pcm,
                                         pick_bucket)

HOP = 200
SR = 16000
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(cfg: Dict) -> Dict:
    """The program's merged configuration for the benchmark's file."""
    b = cfg["buckets"]
    return {"prior_generator": cfg["prior_generator"], "prob_generator": cfg["prob_generator"],
            "dataset_cfg": {"phoneme_buckets": b["phoneme"], "frame_buckets": b["frame"],
                            "prompt_buckets": b["prompt"]}}


def codec_trees(ctx: Ctx) -> Dict[str, Dict[str, np.ndarray]]:
    """The codec's flat parameter trees: the checkpoint, or random ones from
    the seed where the configuration names no checkpoint."""
    c = ctx.cfg["codec"]
    if c.get("weights"):
        return {part: ref_codec.load_tree(f"{ctx.root}/{c['weights']}/{c[part]['file']}")
                for part in ("encoder", "decoder")}
    return weights.codec_tree(ctx.seed, c["encoder"], c["decoder"], c["timbre"])


def build_codec(ctx: Ctx, trees, dtype: Optional[torch.dtype]):
    from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec

    c = ctx.cfg["codec"]
    codec = FaCodec(weights.unflatten(trees["encoder"]), weights.unflatten(trees["decoder"]),
                    device=ctx.device, sr=c["sr"], up_ratios_enc=c["encoder"]["up_ratios"],
                    up_ratios_dec=c["decoder"]["up_ratios"], fuse_blocks=ctx.cfg["fuse_blocks"])
    if dtype is not None and dtype != torch.float32:
        codec.cast_inference_params(dtype)
    return codec


def flamed_weights(ctx: Ctx) -> Dict[str, Dict[str, torch.Tensor]]:
    """The prior and prob weights of this seed, float32 on the device."""
    from flamed_tts_tpu_torch.models.prior.prior_generator import PriorGenerator
    from flamed_tts_tpu_torch.models.prob.prob_generator import ProbGenerator

    with torch.device("meta"):
        shapes = {"prior": weights.shapes_of(PriorGenerator(ctx.cfg["prior_generator"]).state_dict()),
                  "prob": weights.shapes_of(ProbGenerator(ctx.cfg["prob_generator"]).state_dict())}
    pin = ctx.cfg["pin"]
    return weights.flamed_state(shapes, ctx.seed, ctx.device, pin["duration_bias"], pin["silence_bias"])


class Serve:
    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.batch = int(self.mix.get("batch", 1))
        self.nfe = self.mix["nfe"]
        self.temperature = self.mix["temperature"]
        prec = ctx.cfg["precision"]
        self.arithmetic = prec["arithmetic"]
        self.io_bytes = 2 if prec["codec"] == "bfloat16" else 4
        self.calls: List[Dict] = []  # every call, warm-up included, in order

    # --- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from flamed_tts_tpu_torch import precision
        from flamed_tts_tpu_torch.models.flamed import Flamed

        ctx, prec = self.ctx, self.ctx.cfg["precision"]
        precision.set_matmul_precision(prec["matmul"])
        state = flamed_weights(ctx)
        with torch.device(ctx.device):
            self.model = Flamed(program_config(ctx.cfg), params=state, device=ctx.device,
                                graphs=ctx.cfg["graphs"])
        del state
        if prec["params"] != "float32":
            self.model.cast_inference_params(DTYPES[prec["params"]])
        self.codec = build_codec(ctx, codec_trees(ctx), DTYPES[prec["codec"]])
        self.words = read_words()
        # enough requests for the window at the mix's highest call rate,
        # and the traced slice after it
        pool = int(ctx.seconds * self.mix["max_calls_per_second"]) + int(self.mix["trace_calls"])
        if self.batch == 1:
            self.requests = generator.utterances(self.mix, ctx.seed, pool)
            warm = generator.utterances(self.mix, ctx.seed, self._range(), stream=1)
        else:
            self.voices = generator.speakers(self.mix, ctx.seed)
            self.cache = [self.codec.encode_prompt(v) for v in self.voices]
            self.requests = self._batches(generator.utterances(self.mix, ctx.seed, pool * self.batch), 0)
            warm = self._batches(generator.utterances(self.mix, ctx.seed, self._range(), stream=1), 1)
        self._warm_up(warm)
        self.next = 0

    def _range(self) -> int:
        return self.mix["phonemes"]["max"] - self.mix["phonemes"]["min"] + 1

    def _batches(self, utts: List[Dict], stream: int) -> List[Dict]:
        r = generator.rng(self.ctx.seed, 201, stream)
        out = []
        for i in range(0, len(utts) - self.batch + 1, self.batch):
            rows = utts[i:i + self.batch]
            out.append({"rows": rows, "speakers": [int(r.integers(len(self.voices))) for _ in rows],
                        "seed": rows[0]["seed"]})
        return out

    def _warm_up(self, warm: List) -> None:
        """Every signature the window can reach, then passes over the mix's
        sizes until one adds no captured signature.

        The served call's frame bucket is speculative: the longest row's
        phoneme count times a budget the sampler learns from the calls
        before, between its floor and the mix's ``budget_max``.  So each
        (phoneme bucket, frame bucket) pair that a length of the mix and a
        budget in that range reach is called once first, with that budget."""
        buckets, seen = self.ctx.cfg["buckets"], set()
        budgets = np.arange(MIN_BUDGET, self.mix["budget_max"] + 1e-9, 0.25)
        for n in range(self.mix["phonemes"]["min"], self.mix["phonemes"]["max"] + 1):
            for b in budgets:
                sig = (pick_bucket(n, buckets["phoneme"]), pick_bucket(int(n * b), buckets["frame"]))
                if sig in seen:
                    continue
                seen.add(sig)
                utts = generator.utterances(dict(self.mix, phonemes={"min": n, "max": n}), self.ctx.seed,
                                            self.batch, stream=3 + len(seen))
                req = utts[0] if self.batch == 1 else self._batches(utts, 3 + len(seen))[0]
                self.serve(req, "warmup", budget=float(b))
        for _ in range(int(self.mix.get("warmup_passes_max", 4))):
            before = self.model.sampler.captures
            for req in warm:
                self.serve(req, "warmup")
            if self.model.sampler.captures == before:
                break

    # --- the window -------------------------------------------------------------

    def call(self) -> Dict:
        req = self.requests[self.next % len(self.requests)]
        self.next += 1
        return self.serve(req, "window")

    def serve(self, req: Dict, phase: str, budget: Optional[float] = None) -> Dict:
        """One call; with ``budget`` the sampler's own entry at that
        frames-per-phoneme budget (warm-up only)."""
        spans = self.ctx.spans
        n0 = spans.counts["fused_dispatch"]
        nf = self.nfe
        t0 = time.perf_counter()
        if budget is not None:
            out = self._forced(req, budget)
            latency = time.perf_counter() - t0
            tgt = [int(x) for x in out["tgt_len"]]
            wavs, n_ids, timbres = [], [len(x) for x in self._ids(req)], None
        elif self.batch == 1:
            out = self.model.sample(text=req["text"], prompt_raw=req["prompt"], codec=self.codec,
                                    temp_durgen=self.temperature, temp_denoiser=self.temperature,
                                    nsteps_durgen=nf[0], nsteps_denoiser=nf[1], seed=req["seed"])
            latency = time.perf_counter() - t0
            tgt = [int(out["tgt_len"][0])]
            wavs = [out["wav"]]
            n_ids = [req["n_ids"]]
            timbres = None  # analysed inside the call; ``keep`` asks for them after the window
        else:
            ids = [text_to_ids(u["text"], self.words) for u in req["rows"]]
            n_ids = [len(x) for x in ids]
            phon = np.zeros((len(ids), max(n_ids)), np.int64)
            for r, x in enumerate(ids):
                phon[r, :len(x)] = x
            codes = [self.cache[s][0] for s in req["speakers"]]
            p_max = max(c.shape[1] for c in codes)
            prompts = np.zeros((len(ids), codes[0].shape[0], p_max), np.int64)
            for r, c in enumerate(codes):
                prompts[r, :, :c.shape[1]] = c
            out = self.model.sample_batch(
                phonemes=phon, src_lens=np.asarray(n_ids), prompts=prompts,
                timbres=np.stack([self.cache[s][1] for s in req["speakers"]]),
                prompt_lens=np.asarray([c.shape[1] for c in codes]), codec=self.codec,
                temp_durgen=self.temperature, temp_denoiser=self.temperature,
                nsteps_durgen=nf[0], nsteps_denoiser=nf[1], seed=req["seed"])
            latency = time.perf_counter() - t0
            tgt = [int(x) for x in out["tgt_len"]]
            wavs = [out["wav"][r, :t * HOP, 0] for r, t in enumerate(tgt)]
            timbres = [self.cache[s][1] for s in req["speakers"]]
        f = int(out["frame_bucket"])
        rec = {"phase": phase, "req": req, "latency_s": latency, "audio_s": sum(tgt) * HOP / SR,
               "tgt_len": tgt, "n_ids": n_ids, "frame_bucket": f,
               "dispatches": spans.counts["fused_dispatch"] - n0,
               "true_frames": sum(tgt), "bucket_frames": f * len(tgt), "index": len(self.calls)}
        if phase != "warmup":
            rec.update(latents=out["latents"], wavs=wavs, timbres=timbres, flops=self.flops(rec),
                       launches=self.launches(rec))
        self.calls.append(rec)
        return rec

    def _forced(self, req: Dict, budget: float) -> Dict:
        """``BucketedSampler.sample`` with the arguments ``Flamed.sample`` /
        ``sample_batch`` pass it, and the frames-per-phoneme budget given."""
        ids = self._ids(req)
        phon = np.zeros((len(ids), max(len(x) for x in ids)), np.int64)
        for r, x in enumerate(ids):
            phon[r, :len(x)] = x
        kw = dict(nsteps_durgen=self.nfe[0], nsteps_denoiser=self.nfe[1], temp_durgen=self.temperature,
                  temp_denoiser=self.temperature, vocab_pad=self.model.vocab_size, codec=self.codec,
                  generator=self.model._generator(req["seed"]), fused=True,
                  frames_per_phoneme_budget=budget)
        src = np.asarray([len(x) for x in ids], np.int64)
        if self.batch == 1:
            padded, frames = self.codec.pad_prompt_wav(req["prompt"])
            return self.model.sampler.sample(phon, src, None, None, None, self.ctx.device,
                                             prompt_wav=padded[None], prompt_frames=np.asarray([frames]), **kw)
        codes = [self.cache[s][0] for s in req["speakers"]]
        prompts = np.zeros((len(ids), codes[0].shape[0], max(c.shape[1] for c in codes)), np.int64)
        for r, c in enumerate(codes):
            prompts[r, :, :c.shape[1]] = c
        return self.model.sampler.sample(phon, src, prompts, np.asarray([c.shape[1] for c in codes]),
                                         np.stack([self.cache[s][1] for s in req["speakers"]]),
                                         self.ctx.device, **kw)

    # --- counts -----------------------------------------------------------------

    def flops(self, rec: Dict) -> int:
        """The call's work at its true lengths (``costs``)."""
        cfg, c = self.ctx.cfg, self.ctx.cfg["codec"]
        prompt_samples = int(self.mix["prompt_seconds"] * SR) if self.batch == 1 else 0
        p = prompt_samples // HOP if self.batch == 1 else self.cache[0][0].shape[1]
        return sum(costs.synthesis_call(cfg, c, l, t, p, prompt_samples, self.nfe[0], self.nfe[1],
                                        self.io_bytes) for l, t in zip(rec["n_ids"], rec["tgt_len"]))

    def launches(self, rec: Dict) -> List:
        """(kernel, rows, channels) of the call's K1 / K2 launches: the
        prompt's encoder at its seconds bucket, the decoder over the batch's
        frame bucket."""
        c = self.ctx.cfg["codec"]
        out = []
        if self.batch == 1:
            samples = pick_bucket(max(1, math.ceil(self.mix["prompt_seconds"])), (1, 2, 3, 4, 5, 8, 11, 17)) * SR
            out += costs.encoder_launches(samples, c["encoder"]["ngf"], c["encoder"]["up_ratios"])
        dec = costs.decoder_launches(rec["frame_bucket"], c["decoder"]["upsample_initial_channel"],
                                     c["decoder"]["up_ratios"])
        return out + [(k, rows * len(rec["tgt_len"]), ch) for k, rows, ch in dec]

    def counters(self) -> Dict[str, float]:
        return {"captures": float(self.model.sampler.captures)}

    def free(self) -> None:
        del self.model, self.codec
        self.model = self.codec = None

    # --- correct -------------------------------------------------------------

    def reference(self, numerics: Numerics):
        """The plain reference at this seed's weights, as the program stores them."""
        exact_float32()
        state = flamed_weights(self.ctx)
        prec = self.ctx.cfg["precision"]
        pdt, cdt = DTYPES[prec["params"]], DTYPES[prec["codec"]]
        model = ref_flamed.PlainFlamed(self.ctx.cfg, ref_flamed.stored(state["prior"], pdt),
                                       ref_flamed.stored(state["prob"], pdt), numerics)
        del state
        trees = codec_trees(self.ctx)
        dev = self.ctx.device
        codec = ref_codec.PlainCodec(ref_codec.stored(trees["encoder"], cdt, dev),
                                     ref_codec.stored(trees["decoder"], cdt, dev), numerics,
                                     self.ctx.cfg["codec"]["encoder"]["up_ratios"],
                                     self.ctx.cfg["codec"]["decoder"]["up_ratios"])
        return PlainServing(model, codec, self.ctx.cfg["buckets"], dev)

    def picked(self, window: List[Dict], sample_seed: int) -> List[Dict]:
        """The window's calls the check compares: drawn from the seed, the
        longest among them."""
        longest = max(range(len(window)), key=lambda i: max(window[i]["tgt_len"]))
        return [window[i] for i in sample(len(window), int(self.mix["check_sample"]), sample_seed, longest)]

    def keep(self, window: List[Dict], sample_seed: int) -> None:
        """The timbre the program gives each sampled request's prompt
        (``FaCodec.encode_prompt`` of the wav as the served call uploads it,
        int16 PCM), taken after the window while the program is up.  A
        prompt cache's timbres are the program's already."""
        if self.batch > 1:
            return
        for rec in self.picked(window, sample_seed):
            q = np.round(np.clip(np.asarray(rec["req"]["prompt"], np.float32), -1.0, 1.0) * 32767.0)
            rec["timbres"] = [self.codec.encode_prompt(q.astype(np.float32) * np.float32(1.0 / 32767.0))[1]]

    def check(self, window: List[Dict], sample_seed: int) -> Dict[str, float]:
        """The sampled requests against the reference: the rows whose target
        length or frame bucket differs; the relative L2 gap of the latents on
        the valid frames, pooled over the sampled rows; the pooled gap of the
        program's timbres (``keep``, or the prompt cache's) to the reference's
        analysis of the same prompts; and the pooled gap of the served wav to
        the reference codec's decoding of the program's latents with the
        program's timbres.  For the speculative bucket the reference replays
        the target lengths of every call before the last sampled one, warm-up
        included (stage 1, rows of one length batched)."""
        ref = self.reference(Numerics("fp32"))
        picked = {rec["index"] for rec in self.picked(window, sample_seed)}
        calls = self.calls[:max(picked) + 1]
        raws = self._target_lengths(ref, calls)
        budget = FrameBudget(self.ctx.cfg["buckets"]["frame"])
        mismatches, latents, timbres, wav = 0, PooledGap(), PooledGap(), PooledGap()
        with torch.no_grad():
            for rec, raw in zip(calls, raws):
                if rec["index"] not in picked:
                    budget.observe(raw, [len(x) for x in self._ids(rec["req"])])
                    continue
                got = self._reference_call(ref, rec, budget)
                for r in range(len(rec["tgt_len"])):
                    timbre = torch.as_tensor(rec["timbres"][r], device=ref.device).float()
                    timbres.add(timbre, got["timbres"][r])
                    if (rec["tgt_len"][r] != got["tgt_len"][r]
                            or rec["frame_bucket"] != got["frame_bucket"]):
                        mismatches += 1
                        continue
                    t = got["tgt_len"][r]
                    latents.add(rec["latents"][r, :t], got["latents"][r][:t])
                    wav.add(rec["wavs"][r],
                            pcm(ref.codec.decode(rec["latents"][r:r + 1].float(), timbre))[0, :t * HOP])
        print(f"[check] widest single gap: latents {latents.widest!r}, timbre {timbres.widest!r}, "
              f"wav decode {wav.widest!r}", file=sys.stderr)
        return {"length_mismatches": float(mismatches), "latents_rel_l2": latents.value,
                "timbre_rel_l2": timbres.value, "wav_decode_rel_l2": wav.value}

    def _ids(self, req: Dict) -> List[List[int]]:
        return [text_to_ids(u["text"], self.words) for u in ([req] if self.batch == 1 else req["rows"])]

    def _target_lengths(self, ref: PlainServing, calls: List[Dict]) -> List[List[int]]:
        """Each call's rows' raw target lengths by the reference's stage 1
        on the call's noise."""
        rows: Dict[int, List] = {}  # phoneme count -> [(call, row, ids, dur, sil)]
        for c, rec in enumerate(calls):
            ids = self._ids(rec["req"])
            l_bucket = pick_bucket(max(len(x) for x in ids), ref.buckets["phoneme"])
            dur, sil = noise_draws(rec["req"]["seed"], [(len(ids), l_bucket)] * 2, ref.device)
            for r, x in enumerate(ids):
                rows.setdefault(len(x), []).append((c, r, x, dur[r, :len(x)], sil[r, :len(x)]))
        out = [[0] * len(self._ids(rec["req"])) for rec in calls]
        with torch.no_grad():
            for group in rows.values():
                raws = ref.target_lengths([g[2] for g in group], torch.stack([g[3] for g in group]),
                                          torch.stack([g[4] for g in group]), self.nfe[0], self.temperature)
                for (c, r, *_), raw in zip(group, raws):
                    out[c][r] = raw
        return out

    def _reference_call(self, ref: PlainServing, rec: Dict, budget: FrameBudget) -> Dict:
        """One call worked out by ``ref``: the speculative bucket from the
        calls before (``budget``), the noise, both stages of every row and
        the wav."""
        req, dev, nf, temp = rec["req"], ref.device, self.nfe, self.temperature
        rows = [req] if self.batch == 1 else req["rows"]
        ids = [text_to_ids(u["text"], self.words) for u in rows]
        b, l_max = len(ids), max(len(x) for x in ids)
        l_bucket = pick_bucket(l_max, ref.buckets["phoneme"])
        guess = budget.guess(l_max)
        draws = noise_draws(req["seed"], [(b, l_bucket), (b, l_bucket), (b, guess, 256)], dev)
        firsts = [ref.durations(x, draws[0][r], draws[1][r], nf[0], temp) for r, x in enumerate(ids)]
        raws = [f[3] for f in firsts]
        budget.observe(raws, [len(x) for x in ids])
        f_bucket = budget.bucket_after(guess, max(raws))
        out = {"frame_bucket": f_bucket,
               "tgt_len": [min(r, f_bucket) for r in raws]}
        gen_noise = draws[2]
        if f_bucket != guess:
            gen_noise = noise_draws(req["seed"], [(b, l_bucket), (b, l_bucket), (b, guess, 256),
                                                  (b, f_bucket, 256)], dev)[3]
        lat, wav, tim = [], [], []
        for r in range(b):
            if self.batch == 1:
                codes, timbre = ref.prompt(req["prompt"], as_pcm=True)
            else:
                codes, timbre = self._voice(ref, req["speakers"][r])
            la, wa, _ = ref.synthesize(firsts[r], codes, timbre, f_bucket, gen_noise[r], nf[1], temp)
            lat.append(la)
            wav.append(wa)
            tim.append(timbre)
        out.update(latents=lat, wavs=wav, timbres=tim)
        return out

    def _voice(self, ref: PlainServing, k: int):
        """A cached speaker's codes and timbre, worked out by ``ref`` once
        (kept on ``ref``: the control's and the check's never mix)."""
        memo = ref.__dict__.setdefault("voices", {})
        if k not in memo:
            memo[k] = ref.prompt(self.voices[k], as_pcm=False)
        return memo[k]


DRIVER = Serve
