"""Average checkpoints: N .npz parameter trees -> one.

    python -m flamed_tts_tpu_torch.avg_weights OUT.npz IN1.npz IN2.npz [...]

The repository's root ``avg_weights.py`` for the .npz format (the JAX
package's and this package's checkpoints): the sum is taken in float64 and
cast back; the key sets, shapes and types must agree, and a non-float
parameter must be the same in every input.  The root script's reading of
the reference's PyTorch Lightning checkpoints is not carried over.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from flamed_tts_tpu_torch.runtime.pytree_io import (flatten_pytree, load_pytree_npz,
                                                    save_pytree_npz, unflatten_pytree)


def average_checkpoints(paths: Sequence[str]) -> Dict[str, np.ndarray]:
    """The '/'-joined flat average of the .npz trees at ``paths``."""
    flats = [flatten_pytree(load_pytree_npz(p)) for p in paths]
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
                                     description="Average .npz checkpoints into one.")
    parser.add_argument("output")
    parser.add_argument("inputs", nargs="+")
    args = parser.parse_args(argv)
    if len(args.inputs) < 2:
        parser.error("Need at least two checkpoints to average.")
    save_pytree_npz(args.output, unflatten_pytree(average_checkpoints(args.inputs)))
    print(f"Averaged {len(args.inputs)} checkpoints -> {args.output}")


if __name__ == "__main__":
    main()
