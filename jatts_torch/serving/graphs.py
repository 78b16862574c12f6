"""CUDA graphs of the serving programs (the port's counterpart of the JAX
artifact's compiled bucket programs).

:class:`GraphedCall` captures one call of a program on static input buffers
once, at load, and replays it: a call copies its inputs into the buffers,
replays the graph and hands back the static outputs, which the next replay
overwrites. Before the capture the program runs eagerly on a side stream, so
every kernel is built and loaded, every cuBLAS/cuDNN plan and every cached
table made, and nothing of that happens inside the capture. A generator that
the program draws from is registered with the graph, so a replay after
``generator.manual_seed(seed)`` draws what the eager program draws from a
generator seeded ``seed``. The hand-written kernels count their launches in
Python, once while the graph is captured and never on a replay: each call
records the launches its capture made (:attr:`GraphedCall.launches`) and
counts its replays, and a bundle reports launches a replay times replays.

A capture that fails raises; nothing falls back to the eager program.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch


def launch_counts() -> Dict[str, int]:
    """The hand-written kernels' launch counters, by module and name."""
    from jatts_torch.ops import flash_attention, mas

    return {
        f"{m.__name__.rsplit('.', 1)[1]}.{k}": v
        for m in (flash_attention, mas) for k, v in vars(m).items()
        if "launches" in k and isinstance(v, int)
    }


class GraphedCall:
    """``fn(*inputs)`` captured once as a CUDA graph into ``pool``.

    ``inputs`` are the static buffers (tensors, or None for an absent
    optional input) and stay owned by the caller; ``fn`` returns a tensor,
    or a dict or list of tensors, the static outputs. ``generator``, when
    given, is registered with the graph."""

    def __init__(self, fn: Callable, inputs: Sequence[Optional[torch.Tensor]], pool,
                 generator: Optional[torch.Generator] = None, warmup: int = 2):
        self.inputs = list(inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(warmup):
                fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = launch_counts()
        with torch.no_grad(), torch.cuda.graph(self.graph, pool=pool):
            self.outputs = fn(*self.inputs)
        self.launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        self.replays = 0

    def __call__(self, *inputs: Optional[torch.Tensor]):
        """Copy each given input into its buffer (None leaves the buffer as
        it is), replay, and return the static outputs."""
        for buf, x in zip(self.inputs, inputs):
            if x is not None and x is not buf:
                buf.copy_(x)
        self.graph.replay()
        self.replays += 1
        return self.outputs


def replayed_launches(calls) -> Dict[str, int]:
    """Kernel launches the replays of ``calls`` made: each call's launches a
    replay times its replays, summed by counter."""
    total: Dict[str, int] = {}
    for c in calls:
        for k, n in c.launches.items():
            total[k] = total.get(k, 0) + n * c.replays
    return total
