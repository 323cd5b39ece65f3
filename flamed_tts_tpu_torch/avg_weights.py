"""Average checkpoints: N parameter trees -> one .npz.

    python -m flamed_tts_tpu_torch.avg_weights OUT.npz IN1 IN2 [...]

The repository's root ``avg_weights.py``: an input is a .npz tree (the JAX
package's and this package's checkpoints) or the reference's PyTorch
checkpoint (.ckpt / .pt: a Lightning checkpoint's ``state_dict`` or a bare
weight dict), converted by ``convert_ckpt.convert_flamed_checkpoint``.  A
PyTorch checkpoint is read with full unpickling, as the root script reads
it: give it only files you trust.  The sum is taken in float64 and cast
back; the key sets, shapes and types must agree, and a non-float parameter
must be the same in every input.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from flamed_tts_tpu_torch.convert_ckpt import convert_flamed_checkpoint
from flamed_tts_tpu_torch.runtime.pytree_io import (flatten_pytree, load_pytree_npz,
                                                    save_pytree_npz, unflatten_pytree)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """The '/'-joined flat tree of one checkpoint (.npz, or a PyTorch one)."""
    if path.endswith(".npz"):
        return flatten_pytree(load_pytree_npz(path))
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return flatten_pytree(convert_flamed_checkpoint(sd))


def average_checkpoints(paths: Sequence[str]) -> Dict[str, np.ndarray]:
    """The '/'-joined flat average of the checkpoints at ``paths``."""
    flats = [load_flat(p) for p in paths]
    base = flats[0]
    for path, flat in zip(paths[1:], flats[1:]):
        if base.keys() != flat.keys():
            raise ValueError(f"{path}: key mismatch ({sorted(base.keys() ^ flat.keys())[:5]} ...)")
        for key in base:
            if base[key].shape != flat[key].shape or base[key].dtype != flat[key].dtype:
                raise ValueError(f"{path}: shape or dtype mismatch at {key}")
    out: Dict[str, np.ndarray] = {}
    for key, value in base.items():
        if np.issubdtype(value.dtype, np.floating):
            acc = sum(flat[key].astype(np.float64) for flat in flats)
            out[key] = (acc / len(flats)).astype(value.dtype)
        elif all(np.array_equal(value, flat[key]) for flat in flats[1:]):
            out[key] = value
        else:
            raise ValueError(f"Non-float parameter {key} differs across checkpoints")
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="python -m flamed_tts_tpu_torch.avg_weights",
                                     description="Average checkpoints (.npz, .ckpt, .pt) into one .npz.")
    parser.add_argument("output")
    parser.add_argument("inputs", nargs="+")
    args = parser.parse_args(argv)
    if len(args.inputs) < 2:
        parser.error("Need at least two checkpoints to average.")
    save_pytree_npz(args.output, unflatten_pytree(average_checkpoints(args.inputs)))
    print(f"Averaged {len(args.inputs)} checkpoints -> {args.output}")


if __name__ == "__main__":
    main()
