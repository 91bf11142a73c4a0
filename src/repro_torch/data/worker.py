"""Shared daemon-worker primitives for background host-side work (a copy
of ``repro.data.worker``, which imports nothing of jax).

Both ends of the train loop's host I/O run on daemon threads behind
bounded queues: `data.prefetch.Prefetcher` *produces* chunks ahead of the
consumer, and `checkpoint.CheckpointManager` *consumes* snapshot jobs
behind the hot loop.  The lifecycle plumbing is identical — a stop event
polled so no put/get can deadlock against shutdown, a drain + join helper,
and a `weakref.finalize` safety net that must not keep the owner alive —
so it lives here once.

Everything in this module is free of references to the owning object:
`weakref.finalize` callbacks and worker threads holding only these
functions (plus the queue/event) can never prevent the owner's GC.
"""
from __future__ import annotations

import queue
import threading

__all__ = ["END", "bounded_put", "drain_queue", "shutdown_worker"]

# End-of-stream / end-of-work sentinel placed in the item slot of a queue
# payload.  Distinct from any user value, so a source legitimately yielding
# None is passed through, not truncated.
END = object()


def bounded_put(stop: threading.Event, q: queue.Queue, payload) -> bool:
    """Put onto a bounded queue without ever deadlocking against shutdown.

    Polls ``stop`` instead of blocking forever on a full queue; returns
    True if the payload was enqueued, False if the stop event fired first.
    """
    while not stop.is_set():
        try:
            q.put(payload, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def drain_queue(q: queue.Queue) -> list:
    """Remove and return everything currently buffered (non-blocking)."""
    items = []
    while True:
        try:
            items.append(q.get_nowait())
        except queue.Empty:
            return items


def shutdown_worker(stop: threading.Event, q: queue.Queue,
                    thread: threading.Thread, join_timeout: float) -> None:
    """Signal stop, unblock a worker stuck on a full queue, and join.

    Module-level (never a bound method) so `weakref.finalize` can call it
    without keeping the owning object alive.
    """
    stop.set()
    drain_queue(q)
    thread.join(timeout=join_timeout)
