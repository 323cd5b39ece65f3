"""Tensor parallelism over the mesh's ``model`` axis: which parameters are
split, and on which axis.

The rule table is the JAX package's (``flamed_tts_tpu/parallel/sharding.py``),
first match wins, on the same flax paths: the npz names of ``convert.py``
("prob/params/denoiser/res_block_0/mlp_0/kernel").  The denoiser's Dense
pairs are split Megatron-style, column then row (the time embedding's and
the adaLN modulations' Dense layers by column), the depthwise ConvNeXt conv
and the per-channel LayerNorm parameters on channels; everything else
replicates, and with ``n_model == 1`` every split is the whole tensor, on
the same code path.

``param_spec(path, shape)`` turns a rule's flax ``PartitionSpec`` into the
axis of the port's tensor that is split: a flax Dense kernel (in, out) is
a Linear weight (out, in), so a column-parallel kernel splits the port's
axis 0 and a row-parallel one its axis 1; a flax Conv kernel (K, in, out)
is a Conv1d weight (out, in, K).  A tensor whose split axis stacks several
modulations (the adaLN Linear's 6 C or 5 C outputs) is cut in each
modulation's block, so that a rank holds its channels of every one of them
and computes its modulations alone (``split_chunks``).

What the split asks of the forward (``tensor_parallel.py``): the residual
stream of the denoiser is split on channels, so its LayerNorms sum their
statistics over the model group; a column-parallel Dense takes its whole
input (gathered); a row-parallel Dense sums its partial products over the
group and adds its bias once, after the sum.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from flamed_tts_tpu_torch.convert import EMBEDDINGS
from flamed_tts_tpu_torch.parallel.mesh import axis_rank, axis_size

MODEL = "model"

# (path substring, the flax kernel's PartitionSpec) -- first match wins
DENOISER_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # column-parallel producers of hidden-width activations
    ("denoiser/proj_in/kernel", (None, MODEL)),
    ("denoiser/cond_embed/kernel", (None, MODEL)),
    ("time_embed/mlp_0/kernel", (None, MODEL)),
    ("time_embed/mlp_2/kernel", (None, MODEL)),
    ("adaLN_modulation/kernel", (None, MODEL)),
    ("adaLN_modulation/bias", (MODEL,)),
    # ConvNeXt: the depthwise conv splits on channels (last dim = features)
    ("conv_in/conv_1/kernel", (None, None, MODEL)),
    ("conv_in/conv_1/bias", (MODEL,)),
    ("conv_in/ln_1/scale", (MODEL,)),
    ("conv_in/ln_1/bias", (MODEL,)),
    ("conv_in/conv_2/kernel", (MODEL, None)),
    ("conv_in/conv_3/kernel", (None, MODEL)),
    # gated MLP: column then row parallel
    ("mlp_0/kernel", (None, MODEL)),
    ("mlp_0/bias", (MODEL,)),
    ("mlp_2/kernel", (MODEL, None)),
    # per-hidden-channel LayerNorm params
    ("ln_conv/scale", (MODEL,)),
    ("ln_conv/bias", (MODEL,)),
    ("ln_mlp/scale", (MODEL,)),
    ("ln_mlp/bias", (MODEL,)),
    ("time_embed/mlp_0/bias", (MODEL,)),
    ("time_embed/mlp_2/bias", (MODEL,)),
    ("proj_in/bias", (MODEL,)),
    ("cond_embed/bias", (MODEL,)),
)


def flax_spec(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The rule table's PartitionSpec (as a tuple) for a flax path, () for
    a replicated leaf: the JAX ``param_spec``."""
    if "denoiser" in path or "time_embed" in path:
        for pattern, spec in DENOISER_RULES:
            if pattern in path and len(spec) <= ndim:
                return spec
    return ()


def param_spec(path: str, shape: Sequence[int]) -> Optional[int]:
    """The axis of the port's tensor (of ``shape``) at flax ``path`` that
    is split over the model axis, or None where it replicates."""
    spec = flax_spec(path, len(shape))
    if MODEL not in spec:
        return None
    axis = spec.index(MODEL)
    if path.endswith("/kernel"):  # Dense (in, out) -> (out, in); Conv (K, in, out) -> (out, in, K)
        return len(shape) - 1 - axis
    return axis


def flax_path(name: str, ndim: int) -> str:
    """A prior or prob state-dict name -> its flax path (``convert.py``'s
    renaming): "denoiser.proj_in.weight" -> "denoiser/proj_in/kernel"."""
    *path, leaf = name.split(".")
    if leaf == "weight":
        leaf = "scale" if ndim == 1 else ("embedding" if path[-1] in EMBEDDINGS else "kernel")
    return "/".join(path + [leaf])


def split_chunks(name: str) -> int:
    """How many blocks the split axis of parameter ``name`` stacks: 6 (or
    5 in the final layer) for the adaLN modulations, else 1."""
    if "adaLN_modulation" in name:
        return 5 if "final_layer" in name else 6
    return 1


def _slice(t: torch.Tensor, axis: int, chunks: int, n: int, r: int) -> torch.Tensor:
    """Rank r's part of ``t`` on ``axis``: in each of ``chunks`` equal
    blocks, its 1/n."""
    blocks = t.chunk(chunks, dim=axis)
    return torch.cat([b.chunk(n, dim=axis)[r] for b in blocks], dim=axis).contiguous()


def _unslice(parts: Sequence[torch.Tensor], axis: int, chunks: int) -> torch.Tensor:
    """The inverse of ``_slice`` over every rank's part, in rank order."""
    per_rank = [p.chunk(chunks, dim=axis) for p in parts]
    return torch.cat([torch.cat([p[j] for p in per_rank], dim=axis) for j in range(chunks)], dim=axis)


def shard_specs(module: nn.Module, prefix: str = "prob/params/") -> Dict[str, Optional[int]]:
    """{parameter name: split axis or None} of ``module`` (a ProbGenerator;
    a PriorGenerator replicates whole)."""
    return {name: param_spec(prefix + flax_path(name, p.dim()), p.shape)
            for name, p in module.named_parameters()}


def shard_params(module: nn.Module, mesh, prefix: str = "prob/params/") -> nn.Module:
    """Split ``module``'s parameters over the mesh's model axis in place
    (each Parameter keeps its identity and holds this rank's part) and mark
    its denoiser as split (``SimpleMLPAdaLN.tp``), so that its forward
    runs the tensor-parallel one.  Replicated parameters stay as they are.
    With ``n_model == 1`` each part is the whole tensor."""
    n, r = axis_size(mesh, MODEL), axis_rank(mesh, MODEL)
    specs = shard_specs(module, prefix)
    with torch.no_grad():
        for name, p in module.named_parameters():
            axis = specs[name]
            if axis is not None:
                if p.shape[axis] % (n * split_chunks(name)):
                    raise ValueError(f"{name} {tuple(p.shape)} does not split {n} ways on axis {axis}")
                p.data = _slice(p.data, axis, split_chunks(name), n, r)
    denoiser = getattr(module, "denoiser", None)
    if denoiser is not None:
        denoiser.tp = TensorParallel(mesh, specs)
    return module


def shard_tensor(name: str, t: torch.Tensor, specs: Dict[str, Optional[int]], mesh) -> torch.Tensor:
    """This rank's part of a whole tensor laid out as parameter ``name``
    (an optimizer moment, a gradient)."""
    axis = specs.get(name)
    if axis is None:
        return t
    return _slice(t, axis, split_chunks(name), axis_size(mesh, MODEL), axis_rank(mesh, MODEL))


def gather_tensor(name: str, t: torch.Tensor, specs: Dict[str, Optional[int]], mesh) -> torch.Tensor:
    """The whole tensor of parameter ``name`` from every model rank's part
    (a collective: every rank of the model group calls it)."""
    axis = specs.get(name)
    n = axis_size(mesh, MODEL)
    if axis is None or n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=mesh[MODEL].get_group())
    return _unslice(parts, axis, split_chunks(name))


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every split parameter gathered whole
    (every rank of the model group calls it)."""
    tp = getattr(getattr(module, "denoiser", None), "tp", None)
    state = module.state_dict()
    if tp is None:
        return state
    return {k: gather_tensor(k, v, tp.specs, tp.mesh) for k, v in state.items()}


class TensorParallel:
    """What a split denoiser's forward needs: the mesh, its model group and
    this rank's place in it, and the split axis of every parameter."""

    def __init__(self, mesh, specs: Dict[str, Optional[int]]):
        self.mesh = mesh
        self.specs = specs
        self.size = axis_size(mesh, MODEL)
        self.rank = axis_rank(mesh, MODEL)
        self.group = mesh[MODEL].get_group() if mesh is not None else None
