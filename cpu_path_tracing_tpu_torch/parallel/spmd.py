"""One function on every entry of a ('tiles', 'samples') mesh, its work on
every device at once.

The port's counterpart of ``jax.shard_map`` (the JAX package's
``parallel/render.py:62`` and ``grad.py:465``, ``:560``): ``run(mesh, fn)``
calls ``fn(t, s, device)`` for every entry ``(t, s)`` of the mesh, in mesh
order, each call inside ``torch.cuda.device(device)`` and
``torch.cuda.stream(st)``, ``st`` the entry's own CUDA stream
(``entry_stream``).  A call only enqueues its shard's work; a host read
inside it (``int(t)``, ``.item()``) waits on that entry's stream
alone.  So the host enqueues every shard without waiting for the one before
it, and the shards run at once: each on its own card, and on a mesh that
repeats a card (``[cuda:0] * 4``) each on its own stream of it, as far as
the kernels leave the card room.  A whole-render kernel fills the card:
there the next shard's small kernels, and the host read behind them, wait
for it to drain.  On the CPU the same calls run without streams.

One host thread enqueues all the shards.  A worker thread an entry, as
``torch.nn.parallel.parallel_apply`` runs, measured slower on the H100's
host: the shards' host work is thousands of small torch calls, each of which
drops and takes back the interpreter lock, and between four threads each
handoff costs more than the call (PERF.md, Findings: the mesh's SPMD
execution).  Where that host work outweighs the cards' (the accumulating
inverse step on a mesh over several devices), ``parallel/cards.py`` gives
each device a process instead.

The streams hand work over on the device, never by a host wait:

* before the first call, each entry's stream waits on the caller's current
  stream of its device, so what the caller enqueued (a cotangent, the
  params) is ready before a shard reads it.  A shard reads tensors of its
  own device only: the caller copies an input to each entry's device
  before the call, since a copy made inside a call would run on the source
  device's current stream, which orders nothing with the entry's;
* after the last call, the caller's current stream of each device waits on
  every entry's stream there, and each CUDA tensor of the results is
  ``record_stream``-ed on the caller's current stream of its device: what
  the caller then does with a shard's result (an add on the tile's first
  device, a copy to another card) runs after the shard's work, and the
  caching allocator hands no block of a result back to the entry's stream
  while the caller still reads it.

The reduction across shards (the ``psum``) stays the caller's: an ordered
sum on one device (``parallel/render.sum_shards``), so every mesh shape keeps
one association of its sums.  NCCL is not used inside one process: its
all-reduce fixes no order of the sum, and it refuses a mesh that repeats a
card.

If a call raises, ``run`` raises it with a note naming the entry, after the
caller's streams have waited on what the earlier entries enqueued: there is
no partial result and no retry.  A mesh of one entry runs ``fn`` on the
caller's current stream: there is nothing to overlap.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, TypeVar

import torch

from .mesh import Mesh

T = TypeVar("T")


@functools.cache
def entry_stream(device: torch.device, index: int) -> torch.cuda.Stream:
    """The CUDA stream of the mesh entry at row-major ``index`` on
    ``device``, the same from call to call, so an entry's backward follows
    its forward on one stream.  Streams come from PyTorch's pool, in turn:
    the first 32 an application takes on a device are distinct."""
    return torch.cuda.Stream(device)


def _placement(device: torch.device, stream):
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def _record_on_callers_streams(tree) -> None:
    """``record_stream`` every CUDA tensor of ``tree`` (nested lists and
    tuples) on the caller's current stream of its device."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            tree.record_stream(torch.cuda.current_stream(tree.device))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _record_on_callers_streams(x)


def run(mesh: Mesh, fn: Callable[[int, int, torch.device], T]) -> list[list[T]]:
    """``fn(t, s, device)`` on every entry of ``mesh``, each on its own
    stream; returns the results as ``out[t][s]`` (module docstring)."""
    entries = [(t, s, d) for t, row in enumerate(mesh.devices) for s, d in enumerate(row)]
    if len(entries) == 1:
        return [[fn(*entries[0])]]
    streams = [entry_stream(d, i) if d.type == "cuda" else None
               for i, (_, _, d) in enumerate(entries)]
    for (_, _, d), st in zip(entries, streams):
        if st is not None:
            st.wait_stream(torch.cuda.current_stream(d))
    results = []
    try:
        for (t, s, d), st in zip(entries, streams):
            try:
                with _placement(d, st):
                    results.append(fn(t, s, d))
            except BaseException as exc:
                exc.add_note(f"in mesh entry ({t}, {s}) on {d}")
                raise
    finally:
        for (_, _, d), st in zip(entries, streams):
            if st is not None:
                torch.cuda.current_stream(d).wait_stream(st)
    _record_on_callers_streams(results)
    n_samples = len(mesh.devices[0])
    return [results[t * n_samples:(t + 1) * n_samples] for t in range(len(mesh.devices))]
