"""PyTorch/CUDA port of Flamed-TTS inference.

A second package beside the JAX one, with the same module layout
(``ops/``, ``models/facodec``, ``models/prior``, ``models/prob``,
``runtime/``, ``text/``, ``utils/``) and the same channel-last (B, T, C)
layout at its public functions.  It imports ``torch`` and nothing of JAX.
The codec's hot paths, the alias-free Snake, the residual unit and a
block's stack of three units, run as hand-written CUDA kernels for Hopper
(``csrc/``, built at first use by ``kernels.py``) with float32 or bfloat16
io; on CPU tensors the same functions run their plain PyTorch versions.

Entry points: ``models.flamed.Flamed(cfg, params, device).sample(...)``
and the CLI ``python -m flamed_tts_tpu_torch.synthesize``.
"""
