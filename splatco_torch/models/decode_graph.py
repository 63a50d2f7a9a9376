"""The inference decode replayed as one captured CUDA graph.

A frame's decode (`renderer.generate_neural_gaussians`) is some 200 small
operations on shapes that never change: every anchor keeps its padded
slot.  Launched one by one, they take the host longer than the card takes
to run them, so the card idles through most of a frame.  Captured once in
a CUDA graph, they are launched by one call, and the same kernels run in
the same order on the same addresses: a replayed decode equals the eager
one bit for bit.

`decode` replays only where the caller passes a key, which
`renderer.generate_neural_gaussians` does where a graph can repeat the
eager decode and it can see so (`engages`): the anchors on a CUDA device,
autograd off (`inference_mode` or `no_grad`), no quantization noise (no
random draws in the graph), no `group` (the sharded step's BatchNorm sums
over ranks) and no precomputed plane features.  Everything else runs the
eager decode: training, the sharded step, the CPU.

The key holds what the captured launches read by value or by address:
the decode's level and flags, the camera's uid where the appearance
embedding reads it (so cameras with embeddings of their own stay eager),
and the address, shape, strides and type of every parameter and
contractor tensor.  A replay reads the parameters where they are, so an
update in place is seen; parameters allocated anew change the key.  A
key seen for the first time decodes eagerly.  Seen again on the next
decode, it decodes eagerly on a side stream (the capture's warm-up) and
is captured there.  Each later decode with that key copies its two
per-frame inputs, the visible mask and the camera centre, into the
graph's own, replays the graph and clones its outputs, so that nothing a
caller keeps lies in the graph's memory.  One graph is kept at a time:
another key frees it, and so does freeing the anchors it was captured on
(a trainer's eval captures one, and its next step allocates new ones).

`STATS` counts the decodes made eagerly ("eager") and by replay
("replays"), and the graphs captured ("captures").  A capture records the
wrappers' launches apart from `cuda_lib.LAUNCHES` (it runs nothing), and
each replay adds them there.
"""
from __future__ import annotations

import collections
import threading
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from splatco_torch.ops import cuda_lib

STATS: collections.Counter = collections.Counter()

Outputs = Dict[str, torch.Tensor]


class _Graph(NamedTuple):
    key: tuple
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]  # the per-frame inputs' static copies
    outputs: Outputs                  # in the graph's memory
    launches: collections.Counter     # the wrappers' launches it holds
    finalizer: weakref.finalize       # frees it with its anchors


_graph: Optional[_Graph] = None
# the captures' side stream on each device: one, so that the blocks its
# warm-ups leave in the allocator's cache serve the next warm-up
_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
# the key of the last eager decode and its anchors
_seen: Optional[Tuple[tuple, weakref.ref]] = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def _count(what: str) -> None:
    with _count_lock:
        STATS[what] += 1


def engages(anchor: torch.Tensor, q_noise: float, generator, group,
            plane_feats) -> bool:
    """Whether a decode with these arguments may be replayed."""
    return (anchor.is_cuda and not torch.is_grad_enabled()
            and not (q_noise > 0.0 and generator is not None)
            and group is None and plane_feats is None)


def key_of(tensors, inputs, *values) -> tuple:
    """The key of a decode that reads `tensors` by address, copies
    `inputs` into the graph each frame, and reads the hashable
    `values`."""
    return (tuple((t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)
                  for t in tensors),
            tuple((t.shape, t.dtype, t.device) for t in inputs), values)


def _forget(graph_id: int) -> None:
    global _graph
    g = _graph
    if g is not None and id(g.graph) == graph_id:
        _graph = None


def _free() -> None:
    global _graph
    if _graph is not None:
        _graph.finalizer.detach()
        _graph = None


def _capture(fn: Callable[..., Outputs], inputs, key: tuple,
             anchor: torch.Tensor) -> Outputs:
    """This decode, eagerly on a side stream (the capture's warm-up),
    then captured there as the graph kept for `key`."""
    global _graph
    dev = anchor.device
    with torch.inference_mode(False):
        static = tuple(t.clone() for t in inputs)
    side = _streams.get(dev)
    if side is None:
        side = _streams[dev] = torch.cuda.Stream(dev)
    current = torch.cuda.current_stream(dev)
    side.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        out = fn(*static)
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            with cuda_lib.captured_launches() as launches:
                static_out = fn(*static)
        finally:
            graph.capture_end()
    current.wait_stream(side)
    for t in out.values():
        t.record_stream(current)
    finalizer = weakref.finalize(anchor, _forget, id(graph))
    finalizer.atexit = False
    _graph = _Graph(key, graph, static, static_out, launches, finalizer)
    _count("captures")
    return out


def _replay(g: _Graph, inputs) -> Outputs:
    with torch.profiler.record_function("decode_graph"):
        for static, t in zip(g.inputs, inputs):
            static.copy_(t)
        g.graph.replay()
        cuda_lib.count_replay(g.launches)
        out = {k: v.clone() for k, v in g.outputs.items()}
    _count("replays")
    return out


def decode(fn: Callable[..., Outputs], inputs: Tuple[torch.Tensor, ...],
           key: Optional[tuple], anchor: torch.Tensor) -> Outputs:
    """fn(*inputs), a dict of tensors: eagerly where `key` is None or new,
    captured where `key` is the last decode's, else replayed.  `fn` must
    read every tensor it does not take as an input at the addresses that
    `key` holds, and `anchor` is the tensor whose freeing frees the
    graph."""
    global _seen
    if key is None:
        _count("eager")
        return fn(*inputs)
    with _lock:
        g = _graph
        if g is not None and g.key == key:
            return _replay(g, inputs)
        _free()
        _count("eager")
        if _seen is not None and _seen[0] == key and _seen[1]() is anchor:
            _seen = None
            return _capture(fn, inputs, key, anchor)
        _seen = (key, weakref.ref(anchor))
        return fn(*inputs)
