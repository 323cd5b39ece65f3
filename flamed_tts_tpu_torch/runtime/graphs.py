"""One sampling stage captured once as a CUDA graph and replayed: the port's
counterpart of the JAX package's ``jax.jit`` around each sampling path.

``CapturedCall(fn, inputs)`` is one signature (a path at fixed shapes,
step counts and model settings).  On construction it

1. copies ``inputs`` (a dict of tensors) into static buffers of its own;
2. runs ``fn(**buffers)`` once eagerly on a side stream, the warm-up: the
   kernels' first-use work (shared-memory attributes, loading modules),
   cuBLAS's workspace and the cached tables happen there, outside the
   capture;
3. captures ``fn(**buffers)`` in a ``torch.cuda.CUDAGraph``, in ``pool``
   where one is given (the sampler shares one pool between its
   signatures), and keeps what it returns (a tuple of tensors or None) as
   the static outputs.

``call(inputs)`` then copies the inputs into the buffers, replays the graph
and returns clones of the static outputs, so that what it returns outlives
the next replay of this graph or of another graph in the same pool.  A
capture or replay that fails raises: nothing falls back to eager.

``fn`` must read nothing but its arguments and the model's parameters, and
must not read the host (a host read or a copy from pageable memory ends a
capture).  The graph reads the parameters where they lay at the capture:
after they are replaced (a cast, a load) the graphs must be made anew.

The kernels' launch counters (``kernels.launches``) keep meaning "ran on
the device": the warm-up is an eager run and counts, the capture adds
nothing, and each replay adds the launches its graph recorded.

Device stage marks (``utils/profiling.py``): where a timer is installed at
the capture, the marks ``fn``'s stages make become event-record nodes of
the graph (``marks``; the warm-up records none), and a call adds to the
open collector ``graph_copy_in`` (the input copies), the gap
``graph_launch`` (from just before the replay to the graph's first node:
the device's wait for the launch), the graph's own marks and
``graph_copy_out`` (the output clones).  A graph captured without a timer
has no such nodes.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from flamed_tts_tpu_torch import kernels
from flamed_tts_tpu_torch.utils import profiling


class CapturedCall:
    def __init__(self, fn: Callable[..., Tuple], inputs: Dict[str, torch.Tensor], pool=None):
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.pool = pool
        with profiling.collect(None):
            self._warm_up(fn)
        before = dict(kernels.launches)
        self.marks = profiling.call_marks(next(iter(self.inputs.values())).device)
        with profiling.collect(self.marks):
            self.outputs = self._capture(fn)
        # the launches recorded in the graph, taken back out of the counters
        self.launches = {k: kernels.launches[k] - n for k, n in before.items()}
        kernels.launches.update(before)

    def __call__(self, inputs: Dict[str, torch.Tensor]) -> Tuple:
        profiling.mark("graph_copy_in")
        for k, buf in self.inputs.items():
            v = inputs[k]
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise ValueError(f"input {k!r} is {v.dtype} {tuple(v.shape)}, the graph's "
                                 f"{buf.dtype} {tuple(buf.shape)}")
            buf.copy_(v)
        profiling.mark("graph_launch", gap=True)
        self._replay()
        profiling.extend_marks(self.marks)
        profiling.mark("graph_copy_out")
        for k, n in self.launches.items():
            kernels.launches[k] += n
        outputs = tuple(None if t is None else t.clone() for t in self.outputs)
        profiling.mark(profiling.END)
        return outputs

    # --- the CUDA graph ------------------------------------------------------

    def _warm_up(self, fn) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(**self.inputs)
        torch.cuda.current_stream().wait_stream(side)

    def _capture(self, fn) -> Tuple:
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=self.pool):
            outputs = tuple(fn(**self.inputs))
        self.pool = self.graph.pool()
        return outputs

    def _replay(self) -> None:
        self.graph.replay()
