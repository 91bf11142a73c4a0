"""Background-thread prefetch of the scanned train loop's chunks
(counterpart of ``repro.data.prefetch``).

The scanned loop alternates two host costs: building the next
(unroll_k, agents, batch, seq) chunk in numpy and waiting on the chunk in
flight.  `Prefetcher` moves the building onto a daemon worker thread
behind a bounded queue, so the next chunk is ready when the current one
retires.

Placement (`make_placer`): for a CUDA device the worker turns each numpy
leaf into a pinned host tensor; the consumer copies it to the card on its
own stream without blocking (the CUDA graph's `core.pdsgd._copy_in`, or
`kernels.build.to_device` in the eager loop), so the copy is ordered with
the steps that read it and no stream or event crosses threads.  For the
CPU the leaves are the numpy arrays as tensors.  With a ``mesh`` each
batch (agents, batch, seq) or chunk (k, agents, batch, seq) becomes a
DTensor placed by the rule table's spec, every rank keeping its block.
"""
from __future__ import annotations

import queue
import threading
import warnings
import weakref
from typing import Any, Callable, Iterable, Iterator

import numpy as np

from .worker import END as _END
from .worker import bounded_put as _bounded_put
from .worker import shutdown_worker as _shutdown_worker

__all__ = ["Prefetcher", "make_placer", "prefetch_chunks"]


def _worker_loop(it: Iterator, place: Callable | None,
                 stop: threading.Event, q: queue.Queue):
    # Module-level (no Prefetcher reference): the thread must not keep the
    # owning Prefetcher alive, or its GC finalizer could never run.
    end = (_END, None)  # clean end-of-stream
    try:
        for item in it:
            if stop.is_set():
                return
            _bounded_put(stop, q,
                         (place(item) if place is not None else item, None))
    except BaseException as e:  # re-raised by the consumer
        end = (_END, e)
    finally:
        _bounded_put(stop, q, end)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_placer(device=None, mesh=None,
                rules=None) -> Callable[[Any], Any]:
    """``place(batch_or_chunk)``: a tree of numpy leaves -> a tree of
    tensors staged for ``device`` (pinned host memory for a CUDA device,
    plain host tensors otherwise; see the module docstring).

    With ``mesh`` (a `DeviceMesh`; ``rules`` default TRAIN_RULES) a leaf
    of ``BATCH_LOGICAL``'s rank is a per-step batch and one of
    ``CHUNK_LOGICAL``'s a scanned chunk: each becomes a DTensor on the
    mesh's device placed by its spec (`dist.sharding.logical_spec`),
    each rank keeping its block of the pipeline's batch (the same numpy
    batch on every rank, so no rank sends any); other leaves become
    plain tensors there."""
    import torch  # here, so the checkpoint writer's child runs on numpy
    if mesh is not None:
        return _mesh_placer(mesh, rules)
    pin = device is not None and torch.device(device).type == "cuda"

    def place_leaf(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory() if pin else t

    return lambda tree: _tree_map(place_leaf, tree)


def _mesh_placer(mesh, rules):
    import torch

    from ..dist.sharding import (TRAIN_RULES, local_block, logical_spec,
                                 placements)
    from .pipeline import BATCH_LOGICAL, CHUNK_LOGICAL
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise TypeError("make_placer(mesh=...) places over a DeviceMesh "
                        f"with named axes, not {type(mesh).__name__}")
    rules = TRAIN_RULES if rules is None else rules
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))

    def place_leaf(x):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        logical = {len(CHUNK_LOGICAL): CHUNK_LOGICAL,
                   len(BATCH_LOGICAL): BATCH_LOGICAL}.get(t.dim())
        if logical is None:
            return t
        spec = logical_spec(mesh, t.shape, logical, rules)
        return local_block(mesh, t, placements(spec, mesh, t.dim()))

    return lambda tree: _tree_map(place_leaf, tree)


class Prefetcher:
    """Iterate ``source`` on a daemon thread, ``depth`` items ahead.

    ``place`` (e.g. from `make_placer`) runs on the worker thread.
    Iteration ends when the source is exhausted; a worker exception
    re-raises in the consumer, and a worker that died without posting
    end-of-stream raises instead of hanging.  `close()` (also the context
    manager's exit) stops the worker even when the queue is full and
    joins it; an abandoned Prefetcher is stopped by its GC finalizer.
    """

    def __init__(self, source: Iterable, place: Callable | None = None,
                 depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(
            target=_worker_loop,
            args=(iter(source), place, self._stop, self._queue),
            name="repro-torch-data-prefetch", daemon=True)
        self._thread.start()
        self._finalizer = weakref.finalize(
            self, _shutdown_worker, self._stop, self._queue, self._thread,
            0.2)

    def __iter__(self):
        return self

    # how often a waiting consumer checks that the worker is still alive
    _POLL_S = 1.0

    def __next__(self):
        if self._exhausted or self._stop.is_set():
            raise StopIteration
        while True:
            try:
                item, err = self._queue.get(timeout=self._POLL_S)
                break
            except queue.Empty:
                if self._thread.is_alive():
                    continue
            # dead worker: it may have posted between the timeout and the
            # liveness check, so drain once more without blocking
            try:
                item, err = self._queue.get_nowait()
                break
            except queue.Empty:
                self._exhausted = True
                raise RuntimeError(
                    "prefetch worker thread died without posting "
                    "end-of-stream; the chunk stream is torn (not an "
                    "exhausted source — those end with a sentinel)"
                ) from None
        if err is not None:
            self._exhausted = True
            raise err
        if item is _END:
            self._exhausted = True
            raise StopIteration
        return item

    def close(self, join_timeout: float = 5.0):
        """Stop the worker and join it; idempotent.  A worker still
        building an item after ``join_timeout`` is reported."""
        _shutdown_worker(self._stop, self._queue, self._thread, join_timeout)
        if self._thread.is_alive():
            warnings.warn(
                f"prefetch worker still synthesizing an item after "
                f"{join_timeout}s; it will exit after the current item "
                "(daemon thread, safe at interpreter shutdown)")
        self._exhausted = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def prefetch_chunks(pipeline, unroll_k: int, start_step: int = 0,
                    num_chunks: int | None = None, device=None, mesh=None,
                    place: Callable | None = None, depth: int = 2,
                    agent_slice: tuple[int, int] | None = None) -> Prefetcher:
    """A `Prefetcher` of ``pipeline.chunks(...)``, each chunk placed by
    ``place`` (default `make_placer(device, mesh)`).  Use it as a context
    manager so an early exit still joins the worker."""
    if place is None:
        place = make_placer(device, mesh)
    return Prefetcher(
        pipeline.chunks(unroll_k, start_step=start_step,
                        num_chunks=num_chunks, agent_slice=agent_slice),
        place=place, depth=depth)
