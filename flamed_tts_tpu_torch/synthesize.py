"""Synthesis CLI of the PyTorch/CUDA port.

    python -m flamed_tts_tpu_torch.synthesize --ckpt-path model.npz --cfg-path configs \\
        --codec-dir artifacts/codec_r5 --text "Hello world" \\
        --prompt-list prompt.wav --prompt-dir prompts --output-dir out

The flags of the repository's root ``synthesize.py``, with two modes:

* ``--prompt-list``  : one text x N prompt WAVs (direct mode), each through
  ``Flamed.sample(text=..., prompt_raw=path)``: the text frontend and the
  fused prompt path;
* ``--metadata-file``: batched ``target|prompt|text`` lines (metadata mode)
  through ``Flamed.sample_batch``;

the same output names (``{prompt}-{nd}-{nn}-{td}-{tn}.wav``, and a
``nfe{n}-temp{t}/`` sub-directory in metadata mode) and the same Avg-RTF
printout.  ``--ckpt-path`` takes a converted ``.npz`` or the reference's
PyTorch checkpoint (read with ``torch.load(weights_only=--weights-only)``).
``--device`` is ``cuda`` (the default) or ``cpu``; ``--precision bf16``
rounds the model's and the codec's parameters to bfloat16; ``--profile-dir``
writes a ``torch.profiler`` Chrome trace of the synthesis there.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flamed_tts_tpu_torch.config import load_default_config, load_yaml
from flamed_tts_tpu_torch.models.codec_wrapper import FaCodec
from flamed_tts_tpu_torch.models.flamed import Flamed
from flamed_tts_tpu_torch.utils.audio import load_wav, save_wav, synth_filename
from flamed_tts_tpu_torch.utils.profiling import trace

SR = 16000


def str2bool(value) -> bool:
    if isinstance(value, bool):
        return value
    value = str(value).strip().lower()
    if value in {"true", "1", "yes", "y"}:
        return True
    if value in {"false", "0", "no", "n"}:
        return False
    raise argparse.ArgumentTypeError(f"Cannot interpret '{value}' as boolean.")


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m flamed_tts_tpu_torch.synthesize",
        description="Flamed-TTS synthesis on one NVIDIA GPU (PyTorch/CUDA port).")
    parser.add_argument("--ckpt-path", type=str, required=True,
                        help="Converted .npz / PyTorch checkpoint, or 'random' for random init.")
    parser.add_argument("--cfg-path", type=str, required=True,
                        help="Merged config.yaml, or a directory of the config files.")
    parser.add_argument("--text", type=str, default=None, help="Text content (prompt-list mode).")
    parser.add_argument("--prompt-list", nargs="+", default=None,
                        help="Prompt filenames for direct synthesis.")
    parser.add_argument("--prompt-dir", "--input-dir", dest="prompt_dir", type=str, default=None,
                        help="Directory containing prompt WAV files.")
    parser.add_argument("--metadata-file", "--text-file", dest="metadata_file", type=str,
                        default=None, help="Metadata file with lines formatted as target|prompt|text.")
    parser.add_argument("--output-dir", type=str, default=".", help="Directory to store outputs.")
    parser.add_argument("--weights-only", type=str2bool, default=True,
                        help="PyTorch checkpoint weights_only loading flag.")
    parser.add_argument("--nsteps-durgen", type=int, default=64)
    parser.add_argument("--nsteps-denoiser", type=int, default=64)
    parser.add_argument("--temp-durgen", type=float, default=0.3)
    parser.add_argument("--temp-denoiser", type=float, default=0.3)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default) or cpu (the kernels' plain PyTorch versions).")
    parser.add_argument("--skip-existing", type=str2bool, default=True)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--codec-dir", type=str, default=None,
                        help="Directory with converted codec .npz checkpoints ('random' for random init).")
    parser.add_argument("--precision", type=str, default="fp32", choices=["fp32", "bf16"],
                        help="fp32, or bf16: the model's and the codec's parameters rounded to "
                             "bfloat16 (the codec then computes in bfloat16).")
    parser.add_argument("--seed", type=int, default=None, help="Sampling seed.")
    parser.add_argument("--lexicon-path", type=str, default=None)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler trace (trace.json) of the run to this directory.")
    return parser


def _validate_args(args: argparse.Namespace) -> None:
    metadata_mode = args.metadata_file is not None
    prompt_mode = args.prompt_list is not None
    if metadata_mode == prompt_mode:
        raise ValueError("Specify either --prompt-list (direct mode) or --metadata-file "
                         "(batch mode), but not both.")
    if args.prompt_dir is None:
        raise ValueError("--prompt-dir/--input-dir is required.")
    if prompt_mode and not args.text:
        raise ValueError("--text is required when using --prompt-list.")
    if metadata_mode:
        if not os.path.isfile(args.metadata_file):
            raise ValueError(f"Metadata file not found: {args.metadata_file}")
        if args.batch_size < 1:
            raise ValueError("--batch-size must be >= 1.")


def load_config(cfg_path: str) -> Dict:
    return load_default_config(cfg_path) if os.path.isdir(cfg_path) else load_yaml(cfg_path)


def prepare_model(cfg: Dict, ckpt_path: str, device: str, weights_only: bool = True) -> Flamed:
    if ckpt_path == "random":
        return Flamed(cfg, device=device)
    return Flamed.from_pretrained(cfg, ckpt_path, weights_only=weights_only, device=device)


def get_codec(cfg: Dict, codec_dir: Optional[str], device: str) -> FaCodec:
    if codec_dir == "random":
        return FaCodec.random_init(torch.Generator().manual_seed(0), device=device,
                                   codec_cfg=cfg["codec_cfg"])
    if codec_dir is None:
        raise ValueError("--codec-dir is required (a directory, or 'random').")
    return FaCodec.from_pretrained(codec_dir, cfg["codec_cfg"], device=device)


def _resolve_prompt_path(prompt_dir: str, prompt_name: str) -> str:
    return prompt_name if os.path.isabs(prompt_name) else os.path.join(prompt_dir, prompt_name)


def _seeds(seed: Optional[int]):
    seed = int(time.time()) if seed is None else seed
    while True:
        yield seed
        seed += 1


def _avg_rtf(infer_times: List[float], output_durations: List[float]) -> Optional[float]:
    if not infer_times:
        return None
    rtf = [t / d for t, d in zip(infer_times, output_durations)]
    return sum(rtf) / len(rtf)


def synthesize_with_prompts(model: Flamed, codec: FaCodec, args) -> Optional[float]:
    os.makedirs(args.output_dir, exist_ok=True)
    infer_times, output_durations = [], []
    seeds = _seeds(args.seed)
    for prompt_name in args.prompt_list:
        results = model.sample(
            text=args.text, prompt_raw=_resolve_prompt_path(args.prompt_dir, prompt_name), sr=SR,
            codec=codec, nsteps_durgen=args.nsteps_durgen, nsteps_denoiser=args.nsteps_denoiser,
            temp_durgen=args.temp_durgen, temp_denoiser=args.temp_denoiser,
            lexicon_path=args.lexicon_path, seed=next(seeds))
        infer_times.append(results["time"])
        output_durations.append(len(results["wav"]) / SR)
        out_name, _ = synth_filename(prompt_name, args.nsteps_durgen, args.nsteps_denoiser,
                                     args.temp_durgen, args.temp_denoiser)
        save_wav(os.path.join(args.output_dir, out_name), results["wav"], SR)
        print(f"  wrote {out_name} ({output_durations[-1]:.2f}s in {results['time']:.2f}s)")
    return _avg_rtf(infer_times, output_durations)


def synthesize_with_metadata(model: Flamed, codec: FaCodec, args) -> Optional[float]:
    with open(args.metadata_file, "r", encoding="utf-8") as fin:
        entries = [line.strip() for line in fin if line.strip()]
    target_dir = os.path.join(args.output_dir, f"nfe{args.nsteps_denoiser}-temp{args.temp_denoiser}")
    os.makedirs(target_dir, exist_ok=True)

    pending: List[Dict[str, str]] = []
    for entry in entries:
        try:
            filename, prompt_filename, transcript = entry.split("|", 2)
        except ValueError:
            print(f"[WARN] Malformed line skipped: {entry}")
            continue
        out_path = os.path.join(target_dir, filename)
        if args.skip_existing and os.path.exists(out_path):
            continue
        pending.append({"prompt_path": _resolve_prompt_path(args.prompt_dir, prompt_filename),
                        "text": transcript, "out_path": out_path})
    if not pending:
        return None

    prompt_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    infer_times, output_durations = [], []
    seeds = _seeds(args.seed)
    frontend = model._get_frontend(args.lexicon_path)
    num_batches = math.ceil(len(pending) / args.batch_size)
    for bi in range(num_batches):
        batch = pending[bi * args.batch_size: (bi + 1) * args.batch_size]
        phoneme_list, prompt_list, timbre_list = [], [], []
        for item in batch:
            phoneme_list.append(frontend(item["text"])[0][0])
            if item["prompt_path"] not in prompt_cache:
                prompt_cache[item["prompt_path"]] = codec.encode_prompt(
                    load_wav(item["prompt_path"], sr=SR))
            codes, timbre = prompt_cache[item["prompt_path"]]
            prompt_list.append(codes)
            timbre_list.append(timbre)

        b = len(batch)
        src_lens = np.array([len(p) for p in phoneme_list], dtype=np.int64)
        phonemes = np.zeros((b, int(src_lens.max())), dtype=np.int64)
        for i, p in enumerate(phoneme_list):
            phonemes[i, : len(p)] = p
        p_lens = np.array([c.shape[-1] for c in prompt_list], dtype=np.int64)
        prompts = np.full((b, prompt_list[0].shape[0], int(p_lens.max())), model.vocab_size,
                          dtype=np.int64)
        for i, c in enumerate(prompt_list):
            prompts[i, :, : c.shape[-1]] = c

        outputs = model.sample_batch(
            phonemes=phonemes, src_lens=src_lens, prompts=prompts, prompt_lens=p_lens,
            timbres=np.stack(timbre_list), codec=codec,
            temp_durgen=args.temp_durgen, temp_denoiser=args.temp_denoiser,
            nsteps_durgen=args.nsteps_durgen, nsteps_denoiser=args.nsteps_denoiser,
            seed=next(seeds))
        for i, item in enumerate(batch):
            wav = outputs["wav"][i, : int(outputs["tgt_len"][i]) * codec.hop, 0]
            save_wav(item["out_path"], wav, SR)
            infer_times.append(outputs["time"] / b)
            output_durations.append(len(wav) / SR)
        print(f"  batch {bi + 1}/{num_batches} done ({outputs['time']:.2f}s)")
    return _avg_rtf(infer_times, output_durations)


def main(args: Optional[argparse.Namespace] = None) -> Optional[float]:
    parser = build_arg_parser()
    cli_invocation = args is None
    if cli_invocation:
        args = parser.parse_args()
    try:
        _validate_args(args)
    except ValueError as exc:
        if cli_invocation:
            parser.error(str(exc))
        raise

    cfg = load_config(args.cfg_path)
    codec = get_codec(cfg, args.codec_dir, args.device)
    model = prepare_model(cfg, args.ckpt_path, args.device, args.weights_only)
    if args.precision == "bf16":
        model.cast_inference_params()
        codec.cast_inference_params()

    with trace(args.profile_dir):
        if args.metadata_file:
            rtf = synthesize_with_metadata(model, codec, args)
        else:
            rtf = synthesize_with_prompts(model, codec, args)

    if rtf is not None:
        print("=" * 20, "Avg RTF", "=" * 20)
        print(">" * 5, "RTF:", round(rtf, 3))
    else:
        print("No samples were generated.")
    return rtf


if __name__ == "__main__":
    main()
