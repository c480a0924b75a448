"""CUDA graphs of the offline decode's fixed-shape parts: the encoders
(``inference._encode``) and the regression head (``inference._reg_decode``).

``inference.run_multifuture_inference`` pads every batch to one size,
packs every batch's scene table to one number of rows and decodes every
batch the same number of steps. So these two parts launch the same
kernels on the same shapes batch after batch, and neither makes a host
decision that depends on the data or runs a hand-written kernel. Eager,
they cost ~600 PyTorch launches a batch on the host; replayed, one graph
launch each.

A part is captured the first time its key is met: it runs once eagerly
(its lazy set-up: cuDNN's choice of algorithm, the allocator's blocks),
then ``torch.cuda.graph`` captures it on a side stream, and the batch is
replayed. Every later batch with that key copies its tensors into the
graph's static inputs (device to device, on the current stream) and
replays. The key (:func:`graph_key`) holds everything a capture depends
on, down to the addresses of the weights the part reads: weights
replaced by new tensors miss the cache and are captured anew, weights
updated in place are read by the replay.

The regression head reads only the batch, so its replay runs on a side
stream (:meth:`GraphCache.run` with ``side``) under the encoders and the
class decode, after the work enqueued before it; the decode's stream
waits for it (:meth:`GraphCache.join`) before anything reads its output.

The outputs live in the graph's own memory pool and the next replay of
that graph overwrites them. That is safe because every reader of a
batch's outputs (the beam search, the trajectory reconstruction, the
copies to pinned memory) is enqueued on the decode's stream before the
next batch's replay, which waits for that stream's work: keep it so.

Only the offline decode passes a cache (:func:`graph_cache`): serving,
``parallel/mesh.py``, training and every CPU tensor run the parts
eagerly, since their shapes do not repeat or there is no graph.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch

from multiverse_torch.utils import count

# four batch shapes, two parts each
CAPACITY = 8


def graphs_apply(graphs: Optional["GraphCache"],
                 inputs: Sequence[torch.Tensor]) -> bool:
    """Whether a part runs as a graph: the caller gave a cache (it
    repeats its shapes) and every input is on a CUDA device."""
    return graphs is not None and all(t.is_cuda for t in inputs)


def graph_key(part: str, cfg, T: int, inputs: Sequence[torch.Tensor],
              weights: Sequence[torch.Tensor]) -> tuple:
    """What a capture of ``part`` depends on: the configuration (the tier
    with it), the steps ``T``, each input's shape, dtype and device (the
    batch size N with them), and each weight's address, shape and
    dtype."""
    return (part, cfg, T,
            tuple((tuple(t.shape), t.dtype, t.device) for t in inputs),
            tuple((w.data_ptr(), tuple(w.shape), w.dtype) for w in weights))


class PartGraph:
    """One part captured: its static inputs, the graph and the outputs
    that each replay writes."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        # the pool of a graph just evicted is reused only once its last
        # replay has ended
        torch.cuda.synchronize(inputs[0].device)
        self.inputs = [t.clone() for t in inputs]
        side = torch.cuda.Stream(self.inputs[0].device)
        side.wait_stream(torch.cuda.current_stream(side.device))
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream(side.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the offline decode's resolver thread may wait on
        # an earlier batch's copies while this thread captures
        with torch.cuda.graph(self.graph,
                              capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs)

    def __call__(self, inputs: Sequence[torch.Tensor],
                 stream: Optional[torch.cuda.Stream] = None):
        """Copy ``inputs`` in on the current stream and replay, there or
        on ``stream`` after the work enqueued so far."""
        here = torch.cuda.current_stream(self.inputs[0].device)
        if stream is not None:
            # the last replay there has read the static inputs
            here.wait_stream(stream)
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        if stream is None:
            self.graph.replay()
            return self.outputs
        stream.wait_stream(here)
        with torch.cuda.stream(stream):
            self.graph.replay()
        return self.outputs


class GraphCache:
    """Captured parts by key; the ``capacity`` most recently used are
    kept, the oldest evicted first."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._parts: OrderedDict = OrderedDict()
        self._side: dict = {}       # device -> the side stream

    def __len__(self) -> int:
        return len(self._parts)

    def __contains__(self, key) -> bool:
        return key in self._parts

    def get(self, key, make: Callable):
        """The entry of ``key``, made by ``make()`` (a capture) where
        there is none."""
        part = self._parts.get(key)
        if part is not None:
            self._parts.move_to_end(key)
            return part
        while len(self._parts) >= self.capacity:
            self._parts.popitem(last=False)
        part = self._parts[key] = make()
        count("decode.graph_captures", 1)
        return part

    def run(self, key, fn: Callable, inputs: Sequence[torch.Tensor],
            side: bool = False):
        """``fn(*inputs)``'s outputs, by a replay of its graph; with
        ``side``, on the cache's side stream, read only after
        :meth:`join`."""
        part = self.get(key, lambda: PartGraph(fn, inputs))
        count("decode.graph_replays", 1)
        stream = self.side_stream(inputs[0].device) if side else None
        return part(inputs, stream)

    def side_stream(self, device) -> torch.cuda.Stream:
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device)
        return self._side[device]

    def join(self, device) -> None:
        """The current stream waits for the side stream's replays."""
        torch.cuda.current_stream(device).wait_stream(
            self.side_stream(device))


_CACHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def graph_cache(params: torch.nn.Module) -> GraphCache:
    """The cache of the offline decodes of ``params``: kept across calls
    and dropped with the parameters object."""
    cache = _CACHES.get(params)
    if cache is None:
        cache = _CACHES[params] = GraphCache()
    return cache
