"""FaCodec analysis-synthesis round trips, a closed loop of one client:
``FaCodec.round_trip(wav)`` on each request's wav, which the program pads
to a seconds bucket, encodes, quantizes, embeds and decodes, and cuts to
the whole frames of the input.  The check runs the plain reference codec
on a sample of the window's wavs."""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List

import torch

from benchmark import costs, generator
from benchmark.drivers.serve import DTYPES, build_codec, codec_trees
from benchmark.harness import Ctx, PooledGap, sample
from benchmark.reference import codec as ref_codec
from benchmark.reference.numerics import Numerics, exact_float32
from benchmark.reference.serving import WAV_SECOND_BUCKETS, pad_to_seconds, pick_bucket

HOP = 200
SR = 16000


class RoundTrip:
    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.arithmetic = ctx.cfg["precision"]["arithmetic"]
        self.calls: List[Dict] = []

    def _precision(self) -> None:
        prec = self.ctx.cfg["precision"]
        torch.backends.cudnn.allow_tf32 = bool(prec["cudnn_tf32"])
        torch.backends.cuda.matmul.allow_tf32 = bool(prec["matmul_tf32"])

    def setup(self) -> None:
        self._precision()
        self.codec = build_codec(self.ctx, codec_trees(self.ctx), DTYPES[self.ctx.cfg["precision"]["codec"]])
        self.requests = generator.waves(self.mix, self.ctx.seed, int(self.mix["pool"]))
        # one call at the longest wav of each seconds bucket the mix reaches
        longest: Dict[int, Dict] = {}
        for req in generator.waves(self.mix, self.ctx.seed, len(generator.lognormal_levels(self.mix["seconds"])),
                                 stream=1):
            b = self.bucket_seconds(req["wav"].size)
            if b not in longest or req["wav"].size > longest[b]["wav"].size:
                longest[b] = req
        for req in longest.values():
            self.serve(req, "warmup")
        self.next = 0

    @staticmethod
    def bucket_seconds(samples: int) -> int:
        return pick_bucket(max(1, math.ceil(samples / SR)), WAV_SECOND_BUCKETS)

    def call(self) -> Dict:
        req = self.requests[self.next % len(self.requests)]
        self.next += 1
        return self.serve(req, "window")

    def serve(self, req: Dict, phase: str) -> Dict:
        t0 = time.perf_counter()
        wav = self.codec.round_trip(req["wav"])
        latency = time.perf_counter() - t0
        n = req["wav"].size
        bucket = self.bucket_seconds(n) * SR
        rec = {"phase": phase, "req": req, "latency_s": latency, "audio_s": wav.size / SR,
               "true_frames": n, "bucket_frames": bucket, "index": len(self.calls)}
        if phase != "warmup":
            c = self.ctx.cfg["codec"]
            frames = n // HOP
            rec.update(wav=wav,
                       flops=(costs.codec_encode(c, n) + costs.codec_analyze(c, frames)
                              + costs.codec_embed(c, frames) + costs.codec_decode(c, frames)),
                       launches=(costs.encoder_launches(bucket, c["encoder"]["ngf"], c["encoder"]["up_ratios"])
                                 + costs.decoder_launches(bucket // HOP, c["decoder"]["upsample_initial_channel"],
                                                          c["decoder"]["up_ratios"])))
        self.calls.append(rec)
        return rec

    def counters(self) -> Dict[str, float]:
        return {}

    def free(self) -> None:
        del self.codec
        self.codec = None

    def reference(self) -> ref_codec.PlainCodec:
        exact_float32()
        trees, dev, c = codec_trees(self.ctx), self.ctx.device, self.ctx.cfg["codec"]
        return ref_codec.PlainCodec(ref_codec.stored(trees["encoder"], None, dev),
                                    ref_codec.stored(trees["decoder"], None, dev), Numerics("fp32"),
                                    c["encoder"]["up_ratios"], c["decoder"]["up_ratios"])

    def check(self, window: List[Dict], sample_seed: int) -> Dict[str, float]:
        """The relative L2 gap of the sampled round trips' wavs to the
        reference's, pooled, and the number whose length differs."""
        ref = self.reference()
        longest = max(range(len(window)), key=lambda i: window[i]["true_frames"])
        gap, mismatches = PooledGap(), 0
        with torch.no_grad():
            for i in sample(len(window), int(self.mix["check_sample"]), sample_seed, longest):
                rec = window[i]
                padded, n_frames = pad_to_seconds(rec["req"]["wav"])
                latents = ref.encode(torch.as_tensor(padded, device=self.ctx.device)[None, :, None])
                codes, timbre = ref.analyze(latents, n_frames)
                want = ref.decode(ref.embed(codes), timbre)[0, :n_frames * HOP]
                if rec["wav"].shape[0] != want.shape[0]:
                    mismatches += 1
                    continue
                gap.add(rec["wav"], want)
        print(f"[check] widest single gap: wav {gap.widest!r}", file=sys.stderr)
        return {"length_mismatches": float(mismatches), "wav_rel_l2": gap.value}


DRIVER = RoundTrip
