"""Crash-safe, non-blocking checkpoint manager for the train loop
(counterpart of ``repro.checkpoint.manager``).

`CheckpointManager` splits a save at the only boundary that must stay on
the caller's thread:

  1. **snapshot** (caller thread): `io.snapshot_tree` clones the state's
     buffers on the card, on the current stream, and records an event —
     no host sync, yet ordered before the next step updates the buffers
     in place;
  2. **commit** (daemon writer thread): the device-to-host copy (after
     the snapshot's event), npz write + tree.json, staged in
     ``step_<n>.tmp-<pid>`` and `os.rename`d into place, so readers only
     ever see complete steps (`io.commit_snapshot`);
  3. **retention** (writer thread): after each commit, superseded steps
     beyond ``keep_last`` are GC'd (``keep_every`` pins periodic steps
     forever, the newest complete step is never deleted) and
     ``manifest.json`` records the surviving completed steps.

The writer follows the `data.worker` daemon-thread pattern shared with
`data.prefetch.Prefetcher`: bounded queue (backpressure, never unbounded
memory), first exception parked and re-raised in the train loop on the
next `save()`/`wait()`/`close()`, `close()` drains in-flight writes, and a
`weakref.finalize` safety net stops an abandoned writer without keeping
the manager alive.

The queue bounds how many snapshots (device clones) are alive at once:
``QUEUE_DEPTH`` queued plus the one being committed; a full queue
back-pressures `save()` rather than keeping unbounded device clones.

Single-writer assumption: one live manager owns a checkpoint directory
(stale ``*.tmp-*`` debris from crashed predecessors is swept on open).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import threading
import time as _time
import weakref
from multiprocessing import shared_memory
from typing import Any, Callable

import numpy as np

from ..data import worker as _w
from . import io

__all__ = ["CheckpointManager"]

MANIFEST = "manifest.json"
QUEUE_DEPTH = 2  # snapshots queued behind the one being committed


class _WriterState:
    """Mutable state shared with the writer thread (never holds the
    manager itself, so the finalizer can run)."""

    def __init__(self, completed: list[int]):
        self.lock = threading.Lock()
        self.error: BaseException | None = None
        self.completed: set[int] = set(completed)
        self.retries = 0  # transient commit OSErrors survived (cumulative)
        self.commit_s: list[float] = []  # wall seconds of each commit


def _retained(completed: set[int], keep_last: int | None,
              keep_every: int | None) -> set[int]:
    """Steps that survive GC.  ``keep_last=None`` disables GC entirely."""
    if keep_last is None or not completed:
        return set(completed)
    # The slice always contains max(completed) (keep_last >= 1 enforced in
    # __init__), so the newest complete step is never collected.
    keep = set(sorted(completed)[-keep_last:])
    if keep_every:
        keep |= {s for s in completed if s % keep_every == 0}
    return keep


def _remove_debris(path: str) -> None:
    # Debris can be a DIR or a plain FILE (manifest.json.tmp-<pid>) —
    # rmtree on a file is a silent no-op under ignore_errors, so branch.
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            os.remove(path)
        except OSError:
            pass


def _recover_or_sweep(directory: str) -> None:
    """Handle a crashed predecessor's leftovers.

    ``step_<n>.tmp-<pid>`` staging dirs and torn ``*.tmp-<pid>`` files are
    deleted.  A ``step_<n>.old-<pid>`` dir is the OLD copy parked by a
    re-save (`io.commit_snapshot`); if the process died between its two
    renames, that parked dir is the only durable copy of step n — rename
    it back into place rather than destroying it.  Only when the final
    dir exists (the re-save completed) is the parked copy superseded
    debris.
    """
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if io._OLD_SUFFIX in name:
            base = name.split(io._OLD_SUFFIX)[0]
            final = os.path.join(directory, base)
            if (io._STEP_RE.fullmatch(base) and not os.path.exists(final)
                    and io.is_complete(path)):
                os.rename(path, final)
                continue
            _remove_debris(path)
        elif io._TMP_SUFFIX in name:
            _remove_debris(path)


def _abandon_writer(q: queue.Queue, thread: threading.Thread,
                    join_timeout: float) -> None:
    """Finalizer for a manager GC'd without close(): drop queued jobs and
    unblock the writer (it waits in an untimed q.get(), so a stop event
    alone could never reach it — only an END sentinel does)."""
    _w.drain_queue(q)
    try:
        q.put_nowait(_w.END)
    except queue.Full:
        pass  # writer is mid-job with a refilled queue; daemon dies at exit
    thread.join(timeout=join_timeout)


def _write_manifest(directory: str, state: _WriterState,
                    keep_last: int | None, keep_every: int | None) -> None:
    io._atomic_write_json(os.path.join(directory, MANIFEST), {
        "format": 1,
        "completed": sorted(state.completed),
        "policy": {"keep_last": keep_last, "keep_every": keep_every},
        "retries": state.retries,
    })


def _commit_and_gc(directory: str, step: int, arrays: dict, meta: dict,
                   state: _WriterState, keep_last: int | None,
                   keep_every: int | None) -> None:
    io.commit_snapshot(directory, step, arrays, meta)
    with state.lock:
        state.completed.add(step)
        drop = state.completed - _retained(state.completed, keep_last,
                                           keep_every)
        state.completed -= drop
        _write_manifest(directory, state, keep_last, keep_every)
    for s in sorted(drop):
        shutil.rmtree(os.path.join(directory, io.step_dirname(s)),
                      ignore_errors=True)


# Transient-OSError retry policy for commits.  NFS blips, ENOSPC races
# with a concurrent GC, EINTR-adjacent weirdness: parking the manager
# fatal on the FIRST such error turns a 100ms filesystem hiccup into a
# dead train run.  `io.commit_snapshot` cleans up its staging dir on any
# failure, so re-running it is safe; attempts are bounded and backed off
# so a genuinely broken disk still fails fast-ish, and the count of
# survived retries is surfaced in manifest.json for post-mortems.
COMMIT_RETRIES = 3        # total attempts = 1 + COMMIT_RETRIES
COMMIT_BACKOFF_S = 0.1    # doubles per retry: 0.1, 0.2, 0.4


def _commit_with_retry(directory: str, step: int, arrays: dict, meta: dict,
                       state: _WriterState, keep_last: int | None,
                       keep_every: int | None) -> None:
    for attempt in range(1 + COMMIT_RETRIES):
        try:
            _commit_and_gc(directory, step, arrays, meta, state,
                           keep_last, keep_every)
            return
        except OSError:
            if attempt == COMMIT_RETRIES:
                raise
            with state.lock:
                state.retries += 1
            _time.sleep(COMMIT_BACKOFF_S * (2 ** attempt))


def _writer_loop(directory: str, q: queue.Queue, state: _WriterState,
                 keep_last: int | None, keep_every: int | None,
                 commit: Callable | None = None,
                 shutdown: Callable | None = None) -> None:
    # Module-level (no CheckpointManager reference): the thread must not
    # keep the owning manager alive, or its GC finalizer could never run.
    # ``commit`` defaults to the in-thread commit; the subprocess writer
    # substitutes a round-trip through its child (see _spawn_commit_child).
    if commit is None:
        def commit(step, arrays, meta):
            _commit_with_retry(directory, step, arrays, meta, state,
                               keep_last, keep_every)
    while True:
        job = q.get()
        try:
            if job is _w.END:
                if shutdown is not None:
                    try:
                        shutdown()
                    except BaseException as e:
                        if state.error is None:
                            state.error = e
                return
            if state.error is not None:
                continue  # park the first error, drain the rest unwritten
            step, arrays, meta = job
            job = None
            t0 = _time.perf_counter()
            commit(step, arrays, meta)
            state.commit_s.append(_time.perf_counter() - t0)
            arrays = None  # the snapshot's host copy, until the next job
        except BaseException as e:
            state.error = e
        finally:
            q.task_done()


# -- subprocess writer (the GIL-free commit path) -------------------------
#
# The thread writer's npz serialization holds the GIL while the train loop
# launches work.  ``writer="subprocess"`` keeps the thread writer's
# queue/END/error plumbing, but the thread only brings the snapshot to the
# host, into one shared-memory segment, and round-trips the job (the
# segment's name and the arrays' dtypes, shapes and offsets) through a
# spawned child process, which runs the same `_commit_with_retry` +
# manifest + retention code on numpy views of the segment, so the on-disk
# semantics are identical by construction.  (The reference pickles the
# arrays through the queue's pipe: for the main path's 7.15 GB state that
# took 125-155 s a commit on the card's host, against 8-10 s in a thread.)
# `checkpoint.manager` and `io` import numpy-level code only (`io` imports
# torch inside its torch functions) and the child never touches CUDA; as
# with any spawned child, it also imports the parent's main module.


def _subprocess_commit_loop(directory: str, keep_last: int | None,
                            keep_every: int | None, completed0: list[int],
                            jobq, ackq) -> None:
    """Child-process main: commit jobs until the None sentinel."""
    state = _WriterState(completed0)
    # the parent owns each segment and unlinks it (a spawned child shares
    # the parent's resource tracker); the child keeps its mapping
    attached: dict = {}
    while True:
        job = jobq.get()
        if job is None:
            for seg in attached.values():
                seg.close()
            ackq.put(("end", None, None))
            return
        step, name, spec, meta = job
        try:
            if name not in attached:
                for seg in attached.values():
                    seg.close()
                attached = {name: shared_memory.SharedMemory(name=name)}
            buf = attached[name].buf
            arrays = {k: np.ndarray(shape, np.dtype(dt), buffer=buf,
                                    offset=off)
                      for k, dt, shape, off in spec}
            _commit_with_retry(directory, step, arrays, meta, state,
                               keep_last, keep_every)
            del arrays, buf
            with state.lock:
                ackq.put(("ok", sorted(state.completed), state.retries))
        except BaseException as e:  # surfaced as the writer error upstream
            ackq.put(("err", repr(e), None))


def _to_segment(arrays: dict, held: list):
    """Copy host arrays into the shared-memory segment ``held[0]`` (made,
    or made larger, first; it is reused across commits, so its pages are
    faulted in once): the spec, a list of (key, dtype str, shape, byte
    offset)."""
    total = max(sum(a.nbytes for a in arrays.values()), 1)
    if held[0] is not None and held[0].size < total:
        _release(held)
    if held[0] is None:
        held[0] = shared_memory.SharedMemory(create=True, size=total)
    spec, off = [], 0
    for k, a in arrays.items():
        np.copyto(np.ndarray(a.shape, a.dtype, buffer=held[0].buf,
                             offset=off), a)
        spec.append((k, a.dtype.str, tuple(a.shape), off))
        off += a.nbytes
    return spec


def _release(held: list) -> None:
    if held[0] is not None:
        held[0].close()
        held[0].unlink()
        held[0] = None


def _spawn_commit_child(directory: str, state: _WriterState,
                        keep_last: int | None, keep_every: int | None
                        ) -> tuple[Callable, Callable]:
    """Start the commit child; returns (commit, shutdown) for _writer_loop."""
    ctx = mp.get_context("spawn")  # never fork a live CUDA context
    jobq, ackq = ctx.Queue(), ctx.Queue()
    with state.lock:
        completed0 = sorted(state.completed)
    child = ctx.Process(
        target=_subprocess_commit_loop,
        args=(directory, keep_last, keep_every, completed0, jobq, ackq),
        name="repro-torch-checkpoint-commit", daemon=True)
    child.start()
    held = [None]  # the shared-memory segment the commits go through

    def commit(step, arrays, meta):
        # Device->host here on the writer thread, then into shared memory;
        # the child only ever sees plain numpy.
        spec = _to_segment(io.host_arrays(arrays), held)
        del arrays
        jobq.put((step, held[0].name, spec, meta))
        while True:
            try:
                kind, a, b = ackq.get(timeout=1.0)
                break
            except queue.Empty:
                if not child.is_alive():
                    raise RuntimeError(
                        "checkpoint commit subprocess died mid-write")
        if kind == "err":
            raise RuntimeError(f"checkpoint commit subprocess failed: {a}")
        with state.lock:  # mirror the child's authoritative view
            state.completed = set(a)
            state.retries = b

    def shutdown():
        try:
            jobq.put(None)
            deadline = _time.monotonic() + 60.0
            while _time.monotonic() < deadline:
                try:
                    if ackq.get(timeout=1.0)[0] == "end":
                        break
                except queue.Empty:
                    if not child.is_alive():
                        break
        finally:
            child.join(timeout=10.0)
            if child.is_alive():  # wedged: daemon child dies with us
                child.terminate()
            _release(held)

    return commit, shutdown


class CheckpointManager:
    """Background-writing checkpoint store with retention.

    Parameters
    ----------
    directory:    checkpoint root (`<dir>/step_<n>/...` + manifest.json).
    keep_last:    retain this many newest complete steps (None = keep all).
    keep_every:   additionally pin every step divisible by this, forever
                  (e.g. ``keep_last=3, keep_every=1000`` keeps a rolling
                  window plus durable millennial checkpoints).
    writer:       "thread" (default), "subprocess", or "sync".  "sync"
                  serializes commits on the caller thread (same
                  atomicity/retention, no worker).  "subprocess" keeps the
                  writer thread as the queue conduit but runs the npz
                  commit + retention + manifest in a spawned child
                  process, so the serialization never competes with the
                  train loop for the GIL; on-disk semantics are identical
                  (the child runs the same commit code).
    fresh:        True CLEARS any existing steps/manifest on open (after
                  crash-debris recovery).  A fresh run reusing a directory
                  must not leave another trajectory's states behind: stale
                  higher-numbered steps would both poison retention GC
                  (the new run's saves look "oldest" and get collected)
                  and hand a later --resume the wrong trajectory.  The
                  default adopts what's on disk (the resume case).
    run_meta:     JSON-stable dict recorded under ``"run"`` in every
                  step's tree.json (e.g. the mixing-config fingerprint) —
                  read back via `io.read_run_meta` so a --resume under a
                  different configuration fails fast.
    """

    def __init__(self, directory: str, *, keep_last: int | None = None,
                 keep_every: int | None = None, fresh: bool = False,
                 run_meta: dict | None = None, writer: str = "thread"):
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if keep_every is not None and keep_every < 1:
            raise ValueError(f"keep_every must be >= 1, got {keep_every}")
        if writer not in ("thread", "subprocess", "sync"):
            raise ValueError(
                f"writer must be 'thread', 'subprocess' or 'sync', "
                f"got {writer!r}")
        self.writer = writer
        self.directory = directory
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.run_meta = run_meta
        os.makedirs(directory, exist_ok=True)
        _recover_or_sweep(directory)  # a crashed predecessor's leftovers
        if fresh:
            for s in io.complete_steps(directory):
                shutil.rmtree(os.path.join(directory, io.step_dirname(s)),
                              ignore_errors=True)
            _remove_debris(os.path.join(directory, MANIFEST))
        self._state = _WriterState(io.complete_steps(directory))
        # Idempotence is scoped to THIS manager's lifetime (terminal +
        # boundary saves of one run dedupe) — steps already on disk from a
        # previous run are overwritten, not skipped: a fresh run reusing a
        # checkpoint dir must not silently keep a different trajectory's
        # states.
        self._submitted: set[int] = set()
        self._save_s: list[float] = []
        self._closed = False
        self._queue: queue.Queue | None = None
        self._thread = None
        if writer != "sync":
            commit = shutdown = None
            if writer == "subprocess":
                commit, shutdown = _spawn_commit_child(
                    directory, self._state, keep_last, keep_every)
            self._queue = queue.Queue(maxsize=QUEUE_DEPTH)
            self._thread = threading.Thread(
                target=_writer_loop,
                args=(directory, self._queue, self._state, keep_last,
                      keep_every, commit, shutdown),
                name="repro-torch-checkpoint-writer", daemon=True)
            self._thread.start()
            # Abandoned-manager safety net: drops queued (not yet started)
            # writes, which is exactly what interpreter teardown would do —
            # call close() to guarantee queued saves land.
            self._finalizer = weakref.finalize(
                self, _abandon_writer, self._queue, self._thread, 1.0)

    # -- introspection ----------------------------------------------------
    @property
    def completed_steps(self) -> list[int]:
        """Sorted steps with committed on-disk payloads (post-GC)."""
        with self._state.lock:
            return sorted(self._state.completed)

    def latest_step(self) -> int | None:
        steps = self.completed_steps
        return steps[-1] if steps else None

    @property
    def retries(self) -> int:
        """Transient commit OSErrors survived so far (also in manifest)."""
        with self._state.lock:
            return self._state.retries

    @property
    def timings(self) -> dict:
        """Wall seconds of each `save` call on the caller's thread (the
        snapshot, and any wait on a full queue) and of each commit on the
        writer (device-to-host copy, serialization, disk and retention)."""
        return {"save_s": list(self._save_s),
                "commit_s": list(self._state.commit_s)}

    # -- error plumbing ---------------------------------------------------
    def _raise_pending(self) -> None:
        err = self._state.error
        if err is not None:
            raise RuntimeError(
                f"checkpoint writer failed for {self.directory!r}; the "
                "train loop must not continue as if its state were "
                "durable") from err

    # -- the API ----------------------------------------------------------
    def save(self, step: int, tree: Any) -> bool:
        """Snapshot ``tree`` now; commit (a)synchronously.  Idempotent:
        a step already committed or in flight is skipped (returns False).
        Re-raises a prior writer failure into the caller."""
        self._raise_pending()
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        step = int(step)
        if step in self._submitted:
            return False
        t0 = _time.perf_counter()
        arrays, meta = io.snapshot_tree(step, tree, run_meta=self.run_meta)
        self._submitted.add(step)
        if self._queue is None:
            _commit_with_retry(self.directory, step, arrays, meta,
                               self._state, self.keep_last, self.keep_every)
            self._save_s.append(_time.perf_counter() - t0)
            self._state.commit_s.append(self._save_s[-1])
            return True
        while True:  # bounded put that notices a dying writer
            self._raise_pending()
            try:
                self._queue.put((step, arrays, meta), timeout=0.05)
                self._save_s.append(_time.perf_counter() - t0)
                return True
            except queue.Full:
                continue

    def wait(self) -> None:
        """Block until every submitted snapshot is on disk (or raise the
        writer's failure).  The manager stays usable."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()

    def close(self, join_timeout: float = 300.0) -> None:
        """Drain in-flight writes, stop the writer, surface any failure.

        Unlike the prefetcher's close (which discards — data is
        re-synthesizable), a checkpoint close must LAND what was queued:
        an END sentinel follows the last job, and we join on it."""
        if self._closed:
            self._raise_pending()
            return
        self._closed = True
        if self._queue is not None:
            # Timed put: an untimed one on a full queue would block before
            # join_timeout could ever apply if the writer is wedged in a
            # stalled filesystem call.
            deadline = _time.monotonic() + join_timeout
            while True:
                try:
                    self._queue.put(_w.END, timeout=0.1)
                    break
                except queue.Full:
                    if _time.monotonic() >= deadline:
                        self._finalizer.detach()
                        raise TimeoutError(
                            f"checkpoint writer wedged (queue still full "
                            f"after {join_timeout}s)")
            self._thread.join(timeout=max(0.0,
                                          deadline - _time.monotonic()))
            self._finalizer.detach()
            if self._thread.is_alive():
                raise TimeoutError(
                    f"checkpoint writer still running after {join_timeout}s")
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
