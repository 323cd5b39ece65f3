"""PyTorch/CUDA port of Flamed-TTS inference.

A second package beside the JAX one, with the same module layout
(``ops/``, ``models/facodec``, ``models/prior``, ``models/prob``,
``runtime/``) and the same channel-last (B, T, C) layout at its public
functions.  It imports ``torch`` and nothing of JAX.  The codec's two hot
paths, the alias-free Snake and the residual unit, run as hand-written
CUDA kernels for Hopper (``csrc/``, built at first use by ``kernels.py``);
on CPU tensors the same functions run their plain PyTorch versions.

Entry point: ``models.flamed.Flamed(cfg, params, device).sample(...)``.
"""
