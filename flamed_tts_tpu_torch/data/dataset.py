"""Training data: manifest datasets and a bucketed numpy collator.

The JAX package's data layer (``flamed_tts_tpu/data/dataset.py``) carried
over as it is: plain-Python datasets and a collator whose batches have the
bucket shapes of the data config, with the same crops for the same seed
(``random.Random``), so the two packages train on the same batches.

Sample contract: phoneme (L,), code (n_q, Lf), emb (Lf, 256), spk (256,),
phone_dur, sil_dur (L,).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from flamed_tts_tpu_torch.runtime.buckets import pick_bucket
from flamed_tts_tpu_torch.text import text_to_sequence
from flamed_tts_tpu_torch.utils.textgrid import get_tier

REQUIRED_FIELDS = ("phoneme", "code", "emb", "spk", "phone_dur", "sil_dur")
DEFAULT_SIL_PHONES = ("sil", "sp", "spn", "")


def compute_alignment(
    intervals,
    sampling_rate: int,
    down_factor: int,
    sil_phones: Sequence[str] = DEFAULT_SIL_PHONES,
):
    """Phone intervals -> (phones, code-frame durations, trailing-silence
    durations); silences fold into the preceding phone and the leading
    bos is relabeled 'sp'."""
    pre_phones, pre_durations = ["bos"], [0]
    for interval in intervals:
        phone = interval.text or "sp"
        start_code = interval.start_time * sampling_rate // down_factor
        end_code = interval.end_time * sampling_rate // down_factor
        pre_phones.append(phone if phone != "" else "sp")
        pre_durations.append(int(end_code - start_code))

    phones, phone_durations, sil_durations = [], [], []
    for idx, phone in enumerate(pre_phones):
        if phone in sil_phones:
            continue
        phones.append(phone)
        phone_durations.append(pre_durations[idx])
        if idx == len(pre_phones) - 1:
            sil_durations.append(0)
        elif pre_phones[idx + 1] in sil_phones:
            sil_durations.append(pre_durations[idx + 1])
        else:
            sil_durations.append(0)
    if phones:
        phones[0] = "sp"
    return phones, phone_durations, sil_durations


def _filter_manifest(lines, dur_min, dur_max, n_words_min):
    samples, filtered, dur_total = [], [], 0.0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        parts = line.split("|")
        if len(parts) < 3:
            filtered.append(line)
            continue
        try:
            duration = float(parts[1])
        except ValueError:
            filtered.append(line)
            continue
        n_words = len(parts[2].split())
        if duration < dur_min or duration > dur_max or n_words < n_words_min:
            filtered.append(line)
            continue
        samples.append(line)
        dur_total += duration
    return samples, filtered, dur_total


class TextCodesDataset:
    """Manifest-driven dataset reading MFA TextGrids + precomputed codec
    JSON dumps (lines ``...|...|...|...|textgrid|codes.json|...``)."""

    def __init__(
        self,
        data_root: str,
        manifest: str,
        cleaners: Sequence[str],
        dur_min: float = 0.3,
        dur_max: float = 15.0,
        n_words_min: int = 3,
        sampling_rate: int = 16000,
        down_factors: Optional[Sequence[int]] = None,
        sil_phones: Optional[Sequence[str]] = None,
        seed: Optional[int] = None,
    ):
        self.data_root = data_root
        self.cleaners = list(cleaners)
        self.sampling_rate = sampling_rate
        self.down_factor = int(np.prod(down_factors or [2, 4, 5, 5]))
        self.sil_phones = tuple(sil_phones) if sil_phones else DEFAULT_SIL_PHONES

        path = os.path.join(data_root, manifest)
        with open(path, encoding="utf-8") as fin:
            lines = fin.readlines()
        self.samples, filtered, dur_total = _filter_manifest(
            lines, dur_min, dur_max, n_words_min
        )
        print(
            f">>> {manifest}: {dur_total / 3600:.3f} hours | "
            f"{len(self.samples)} valid | {len(filtered)} filtered"
        )
        random.Random(seed).shuffle(self.samples)

    def get_alignment(self, intervals):
        return compute_alignment(
            intervals, self.sampling_rate, self.down_factor, self.sil_phones
        )

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        fields = self.samples[index].split("|")
        (_, _, _, _, textgrid_path, tgt_codes_path, _) = tuple(fields[:7])

        intervals = get_tier(textgrid_path, "phones")
        phones, phone_dur, sil_dur = self.get_alignment(intervals)

        with open(tgt_codes_path, encoding="utf-8") as fin:
            gt = json.load(fin)
        spk = np.asarray(gt["spkemb"], dtype=np.float32)
        codes = np.stack([np.asarray(q, dtype=np.int32) for q in gt["quantizers"]])
        embs = np.stack([np.asarray(e, dtype=np.float32) for e in gt["vqemb"]])

        phonemes = np.asarray(
            text_to_sequence("{" + " ".join(phones) + "}", self.cleaners),
            dtype=np.int32,
        )
        return {
            "phoneme": phonemes,
            "code": codes,
            "emb": embs,
            "spk": spk,
            "phone_dur": np.asarray(phone_dur, dtype=np.int32),
            "sil_dur": np.asarray(sil_dur, dtype=np.int32),
        }


class PrecomputedDataset:
    """Per-utterance .npz (or torch .pt) files named by the manifest's first
    field, relative to ``data_root``."""

    def __init__(
        self,
        data_root: str,
        manifest: str,
        dur_min: float = 0.3,
        dur_max: float = 15.0,
        n_words_min: int = 3,
        seed: Optional[int] = None,
    ):
        self.data_root = data_root
        path = os.path.join(data_root, manifest)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"Manifest not found: {path}")
        with open(path, encoding="utf-8") as fin:
            lines = fin.readlines()
        samples, filtered, dur_total = _filter_manifest(
            lines, dur_min, dur_max, n_words_min
        )
        self.samples = []
        for line in samples:
            rel = line.split("|")[0]
            abs_path = os.path.join(data_root, rel)
            if not os.path.isfile(abs_path):
                raise FileNotFoundError(f"Missing precomputed sample: {abs_path}")
            self.samples.append(abs_path)
        print(
            f">>> {manifest}: {dur_total / 3600:.3f} hours | "
            f"{len(self.samples)} valid | {len(filtered)} filtered"
        )
        random.Random(seed).shuffle(self.samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        path = self.samples[index]
        if path.endswith(".npz"):
            with np.load(path) as data:
                sample = {k: data[k] for k in data.files}
        else:  # torch .pt dumps from the reference pipeline
            import torch

            loaded = torch.load(path, map_location="cpu", weights_only=True)
            sample = {k: np.asarray(v) for k, v in loaded.items()}
        for field in REQUIRED_FIELDS:
            if field not in sample:
                raise KeyError(f"Missing field '{field}' in {path}")
        return {k: sample[k] for k in REQUIRED_FIELDS}


class BucketedCollator:
    """Batch dict builder with prompt crop + content-quantizer masking and
    bucketed shapes."""

    def __init__(
        self,
        vocab_size: int = 1024,
        prompt_max_len: int = 400,
        prompt_reduced_factor: float = 0.8,
        phoneme_buckets: Sequence[int] = (64, 128, 192, 256),
        frame_buckets: Sequence[int] = (256, 512, 768, 1024, 1408),
        prompt_buckets: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
    ):
        self.vocab_size = vocab_size
        self.prompt_max_len = prompt_max_len
        self.prompt_reduced_factor = prompt_reduced_factor
        self.phoneme_buckets = list(phoneme_buckets)
        self.frame_buckets = list(frame_buckets)
        # Without prompt buckets the cropped prompt length follows the
        # batch's shortest item.  Bucketing pads prompts to a fixed length
        # and reports the true length in ``prompt_lens``; the prior's decode
        # masks the pad positions.
        self.prompt_buckets = list(prompt_buckets) if prompt_buckets else None
        self.rng = random.Random(seed)

    def _crop_prompts(self, codes_list: List[np.ndarray]) -> Tuple[np.ndarray, int]:
        max_len = min([c.shape[1] for c in codes_list] + [self.prompt_max_len])
        crop = max(1, int(self.prompt_reduced_factor * max_len))
        segments = []
        for codes in codes_list:
            start = self.rng.randint(0, codes.shape[1] - crop)
            segments.append(codes[:, start : start + crop])
        prompts = np.stack(segments).astype(np.int32)
        # Content quantizers carry the transcript: mask rows [1:3] so the
        # prompt provides prosody/residual/timbre only.
        prompts[:, 1:3, :] = self.vocab_size
        if self.prompt_buckets is not None:
            pb = pick_bucket(crop, self.prompt_buckets)
            if pb > crop:
                pad = np.full(
                    (prompts.shape[0], prompts.shape[1], pb - crop),
                    self.vocab_size, np.int32,
                )
                prompts = np.concatenate([prompts, pad], axis=-1)
            elif pb < crop:
                # As in the sampler: the largest bucket caps the prompt.
                prompts = prompts[:, :, :pb]
                crop = pb
        return prompts, crop

    def __call__(self, items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        b = len(items)
        x_len = np.asarray([it["phoneme"].shape[-1] for it in items], np.int32)
        y_len = np.asarray([it["code"].shape[-1] for it in items], np.int32)
        l = pick_bucket(int(x_len.max()), self.phoneme_buckets)
        lf = pick_bucket(int(y_len.max()), self.frame_buckets)
        n_q = items[0]["code"].shape[0]
        emb_dim = items[0]["emb"].shape[-1]

        phonemes = np.zeros((b, l), np.int32)
        codes = np.full((b, n_q, lf), self.vocab_size, np.int32)
        embs = np.zeros((b, lf, emb_dim), np.float32)
        phone_dur = np.zeros((b, l), np.int32)
        sil_dur = np.zeros((b, l), np.int32)
        for i, item in enumerate(items):
            n, m = int(x_len[i]), int(y_len[i])
            n = min(n, l)
            m = min(m, lf)
            phonemes[i, :n] = item["phoneme"][:n]
            codes[i, :, :m] = item["code"][:, :m]
            embs[i, :m] = item["emb"][:m]
            phone_dur[i, :n] = item["phone_dur"][:n]
            sil_dur[i, :n] = item["sil_dur"][:n]

        prompts, crop = self._crop_prompts([np.asarray(it["code"]) for it in items])
        spks = np.stack([it["spk"] for it in items]).astype(np.float32)

        return {
            "phonemes": phonemes,
            "x_len": np.minimum(x_len, l),
            "codes": codes,
            "y_len": np.minimum(y_len, lf),
            "phone_dur": phone_dur,
            "sil_dur": sil_dur,
            "embs": embs,
            "prompts": prompts,
            "prompt_lens": np.full((b,), crop, np.int32),
            "spks": spks,
        }


def batch_iterator(
    dataset,
    collator: BucketedCollator,
    batch_size: int,
    shuffle: bool = True,
    seed: Optional[int] = 0,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    indices = list(range(len(dataset)))
    if shuffle:
        random.Random(seed).shuffle(indices)
    for start in range(0, len(indices), batch_size):
        chunk = indices[start : start + batch_size]
        if drop_last and len(chunk) < batch_size:
            break
        yield collator([dataset[i] for i in chunk])
