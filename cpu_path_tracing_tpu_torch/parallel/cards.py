"""A worker process a device for the accumulating inverse step on a mesh
that spans several devices (``grad.make_sharded_accum_loss_grad``).

One host thread issues every shard's host work in turn (``spmd.py``), and a
thread a shard is slower still: the step's host work is thousands of small
torch calls under the interpreter lock (PERF.md, Findings: the mesh's SPMD
execution).  So on a mesh of several devices each device gets a process of
its own, started with ``spawn``, holding its copy of the scene and its
span.  The calling process keeps the loop: each chunk it asks every worker
for its shards' sums, adds each tile's sample shards in shard order on the
tile's first device and forms the cotangent there, and hands each shard its
tile's cotangent; each worker sums its shards' gradients over the step's
chunks and hands the sums over once a step.  The association of every sum is
the in-process runner's.

The sums, cotangents and gradient sums pass through buffers that each
worker allocates once on its device and shares once (``torch.
multiprocessing``: CUDA memory by IPC handle, shared memory on the CPU),
since opening an IPC handle costs more than a chunk's work.  On a card two
interprocess CUDA events order them: the worker records ``ready`` after
writing, the caller's stream waits on it before reading, and the caller
records ``done`` after its reads and its cotangent writes, which the
worker's stream waits on before writing again.  No host waits on a device
for this.

A request that fails in a worker raises in the caller, the worker's
traceback in a note; a worker that dies raises ``RuntimeError``.  The
workers stop when the ``CardShards`` is closed or collected, and with the
calling process.
"""

from __future__ import annotations

import copy
import pickle
import traceback
import weakref

import torch
import torch.multiprocessing as mp

from ..utils import debug

# Seconds between checks that a worker is still alive while its reply is awaited.
_POLL_S = 1.0


def _serve(conn, device, scene, cfg, spp_local, sample_chunk, compact, replay, entries,
           max_per):
    """A worker's loop: first its buffers and ``ready`` event, then one
    request at a time from ``conn``, one reply each (``("ok", value)`` or
    ``("error", exception, traceback)``)."""
    from ..grad import make_diff_render_span, shard_backward, shard_forward  # grad imports this

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    span = make_diff_render_span(scene.to(device), cfg, spp_local, sample_chunk,
                                 compact=compact, replay=replay)
    sums_out = [torch.zeros(max_per, 3, dtype=scene.dtype, device=device) for _ in entries]
    cts_in = [torch.zeros(max_per, 3, dtype=scene.dtype, device=device) for _ in entries]
    ready = done = grads_out = None
    if cuda:
        ready = torch.cuda.Event(interprocess=True)
        ready.record()
    conn.send(("ok", (sums_out, cts_in, ready.ipc_handle() if cuda else None)))
    names = leaves = sums = acc = None
    guard = False
    while True:
        op, *args = conn.recv()
        if op == "stop":
            return
        try:
            if done is not None:
                done.wait()  # the caller's reads and writes of the buffers
            with debug.debug_context(nans=guard):
                reply = None
                if op == "start":
                    names, values, guard, done_handle = args
                    if cuda and done is None:
                        done = torch.cuda.Event.from_ipc_handle(device, done_handle)
                    leaves = [[v.to(device).requires_grad_(True) for v in values]
                              for _ in entries]
                    acc = None
                elif op == "forward":
                    chunk, per = args
                    sums = [shard_forward(span, names, lv, chunk + t * per, per, s * spp_local)
                            for (t, s), lv in zip(entries, leaves)]
                    for out, x in zip(sums_out, sums):
                        out[:per].copy_(x.detach())
                elif op == "backward":
                    (per,) = args
                    acc = [shard_backward(x, lv, ct[:per], prev) for x, lv, ct, prev in
                           zip(sums, leaves, cts_in, acc or [None] * len(entries))]
                    sums = None
                elif op == "grads":
                    if grads_out is None or [g.shape for g in grads_out[0]] != [
                            g.shape for g in acc[0]]:
                        grads_out = reply = [[torch.empty_like(g) for g in a] for a in acc]
                    for out, a in zip(grads_out, acc):
                        for o, g in zip(out, a):
                            o.copy_(g)
            if cuda:
                ready.record()
            conn.send(("ok", reply))
        except Exception as exc:  # the caller raises it
            try:
                pickle.dumps(exc)
            except Exception:
                exc = RuntimeError(repr(exc))
            conn.send(("error", exc, traceback.format_exc()))


def _close(workers) -> None:
    for w in workers:
        for key in ("sums", "cts", "grads", "ready", "done"):
            w.pop(key, None)  # let go of the workers' memory before they stop
        try:
            w["conn"].send(("stop",))
        except (BrokenPipeError, OSError):
            pass
    for w in workers:
        w["proc"].join(timeout=10)
        if w["proc"].is_alive():
            w["proc"].terminate()
            w["proc"].join()
        w["conn"].close()


class CardShards:
    """The shards of a mesh, a worker process for each of its devices; the
    in-process counterpart is ``grad._Shards``, with the same methods.
    ``max_per`` is the most cells a tile takes in a chunk."""

    def __init__(self, mesh, scene, cfg, spp_local: int, sample_chunk, compact: bool,
                 replay: bool, max_per: int):
        self.mesh = mesh
        by_device = {}
        for t, row in enumerate(mesh.devices):
            for s, d in enumerate(row):
                by_device.setdefault(d, []).append((t, s))
        host_scene = copy.deepcopy(scene).to("cpu")
        ctx = mp.get_context("spawn")
        self.workers = []
        self._finalizer = weakref.finalize(self, _close, self.workers)
        for d, entries in by_device.items():
            conn, child = ctx.Pipe()
            proc = ctx.Process(target=_serve, name=f"mesh-{d}", daemon=True,
                               args=(child, d, host_scene, cfg, spp_local, sample_chunk,
                                     compact, replay, entries, max_per))
            proc.start()
            child.close()
            self.workers.append({"device": d, "entries": entries, "proc": proc, "conn": conn,
                                 "grads": None})
        for w in self.workers:
            w["sums"], w["cts"], ready = self._reply(w)
            w["ready"] = w["done"] = None
            if ready is not None:
                w["ready"] = torch.cuda.Event.from_ipc_handle(w["device"], ready)
                w["done"] = torch.cuda.Event(interprocess=True)
                w["done"].record(torch.cuda.current_stream(w["device"]))

    @staticmethod
    def _died(w) -> RuntimeError:
        w["proc"].join(timeout=_POLL_S)
        return RuntimeError(f"the mesh worker of {w['device']} died "
                            f"(exit code {w['proc'].exitcode})")

    def _reply(self, w):
        while not w["conn"].poll(_POLL_S):
            if not w["proc"].is_alive():
                raise self._died(w)
        try:
            status, *value = w["conn"].recv()
        except (EOFError, ConnectionResetError):
            raise self._died(w) from None
        if status == "error":
            exc, tb = value
            exc.add_note(f"in the mesh worker of {w['device']}:\n{tb}")
            raise exc
        return value[0]

    def _ask(self, requests) -> list:
        """One request to each worker, then every reply, read before the
        first failure is raised so that no reply is left for the next; the
        caller's streams then wait on each worker's ``ready``."""
        failures, sent = [], []
        for w, request in zip(self.workers, requests):
            try:
                w["conn"].send(request)
                sent.append(True)
            except (BrokenPipeError, ConnectionResetError):
                failures.append(self._died(w))
                sent.append(False)
        replies = []
        for w, was_sent in zip(self.workers, sent):
            try:
                replies.append(self._reply(w) if was_sent else None)
            except Exception as exc:  # raised below, after the other replies
                failures.append(exc)
        if failures:
            raise failures[0]
        for w in self.workers:
            if w["ready"] is not None:
                w["ready"].wait(torch.cuda.current_stream(w["device"]))
        return replies

    def _grid(self, key, per=None) -> list:
        grid = [[None] * len(row) for row in self.mesh.devices]
        for w in self.workers:
            for (t, s), x in zip(w["entries"], w[key]):
                grid[t][s] = x if per is None else x[:per]
        return grid

    def _done(self) -> None:
        for w in self.workers:
            if w["done"] is not None:
                w["done"].record(torch.cuda.current_stream(w["device"]))

    def start(self, names, values) -> None:
        """A step's params (leaves of ``flatten_params``); zero the sums."""
        host = [v.detach().to("cpu") for v in values]
        self._ask([("start", names, host, debug.guard_on(),
                    w["done"].ipc_handle() if w["done"] is not None else None)
                   for w in self.workers])

    def forward(self, chunk: int, per: int) -> list:
        """Every shard's sums [per, 3] of tile t's cells ``chunk + t*per``
        onward, as ``out[t][s]`` on the shard's device: views of the
        worker's buffer, valid until the next ``backward``."""
        self._ask([("forward", chunk, per)] * len(self.workers))
        return self._grid("sums", per)

    def backward(self, cts) -> None:
        """Add each shard's gradients for its tile's cotangent ``cts[t]``."""
        per = cts[0].shape[0]
        for w in self.workers:
            for (t, _), buf in zip(w["entries"], w["cts"]):
                buf[:per].copy_(cts[t])
        self._done()
        self._ask([("backward", per)] * len(self.workers))

    def grads(self) -> list:
        """Each shard's gradient sums over the step's chunks, ``out[t][s]``:
        the worker's buffers, valid until the next step."""
        for w, reply in zip(self.workers, self._ask([("grads",)] * len(self.workers))):
            if reply is not None:
                w["grads"] = reply
        return self._grid("grads")

    def close(self) -> None:
        self._finalizer()
