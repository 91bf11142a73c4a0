"""Checkpoints in the reference's on-disk layout (counterpart of
``repro.checkpoint.io``).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``tree.json``, byte for byte the
reference's where its writer is deterministic.  The archive holds one
``a<i>`` entry per leaf of the reference's pytree, in jax's flatten
order; ``tree.json`` records the step, the leaves' ``keystr`` paths,
dtypes and shapes, and the run's metadata under ``"run"``.

Trees.  A `core.pdsgd.DecentralizedState` is saved as the reference's
state: one ``(m, ...)`` leaf per `FlatLayout` leaf under
``.params[...]``, ``.step`` as a 0-d int32, and for DSGT the tracker
pair under ``.tracker[0][...]`` and ``.tracker[1][...]``.  The flat
buffer's zero padding is not saved (the reference has none; no step
writes it), and a load copies into the template state's own buffers and
zeroes their padding, so the buffers keep their addresses (the scanned
step's CUDA graph is keyed on them).  A nested dict (or tuple) of
tensors or numpy arrays works too, for tools and tests.

bfloat16.  A bfloat16 leaf is written as the reference writes one (its
2-byte words under npy descr ``'<V2'``, ``"bfloat16"`` in ``tree.json``)
and read back by that recorded dtype, as int16 words viewed as
``torch.bfloat16``; the reference itself cannot load such a leaf
(ROADMAP §C).

Snapshots.  The train step updates the state in place, so
`snapshot_tree` clones it device-side on the current stream and records
a CUDA event; whichever thread commits waits on that event and copies
the clone to pinned host memory on a side stream (`host_arrays`).  On
the CPU a snapshot is a host copy.

Crash safety: a step is staged as ``step_<n>.tmp-<pid>`` and renamed
into place once both files are written; discovery (`latest_step`)
ignores staging debris and steps missing a payload file.

This module imports torch only inside the functions that need it, so
the subprocess writer's child (`checkpoint.manager`) runs on numpy.
"""
from __future__ import annotations

import dataclasses
import io as _io
import json
import os
import re
import shutil
import struct
import zipfile
import zlib
from typing import Any

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "complete_steps", "snapshot_tree", "commit_snapshot",
           "step_dirname", "read_run_meta", "is_complete", "host_arrays"]

_STEP_RE = re.compile(r"step_(\d{8,})")  # {8,}: steps >= 10^8 widen past 8
_TMP_SUFFIX = ".tmp-"
_OLD_SUFFIX = ".old-"
# Past this the plain ZIP u32 size/offset fields can't hold the archive;
# the ZIP64 writer takes over.  Margin under 2^32 covers npy headers and
# zip bookkeeping.
_ZIP64_THRESHOLD = (1 << 32) - (1 << 20)
# numpy has no bfloat16: a bfloat16 leaf travels as 2-byte void words,
# whose npy descr is written '<V2' as the reference's ml_dtypes leaf's is
_BF16_HOST = np.dtype("V2")


def step_dirname(step: int) -> str:
    # %08d is a zero-pad minimum, not a cap: step 10^8 yields 9 digits and
    # keeps round-tripping through _STEP_RE (discovery compares ints)
    return f"step_{step:08d}"


# -- trees ---------------------------------------------------------------

def _key(k) -> str:
    return f"[{k!r}]"


def _flatten(tree, prefix: str, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], prefix + _key(k), out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}[{i}]", out)
    elif tree is not None:
        out.append((prefix, tree))


def _layout_keys(layout) -> list[str]:
    # FlatLayout paths are '/'-joined dict keys
    return ["".join(_key(k) for k in p.split("/")) for p in layout.paths]


def _is_state(tree) -> bool:
    return hasattr(tree, "flat") and hasattr(tree, "layout")


def tree_leaves_with_path(tree) -> list[tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in jax's flatten order and under its
    ``keystr`` names.  A `DecentralizedState` gives its leaves as views
    of its buffers (``.step`` as an int)."""
    if not _is_state(tree):
        out: list = []
        _flatten(tree, "", out)
        return out
    keys = _layout_keys(tree.layout)
    out = [(".params" + k, v)
           for k, v in zip(keys, tree.layout.leaf_views(tree.flat))]
    out.append((".step", tree.step))
    for i, buf in enumerate(tree.tracker or ()):
        out += [(f".tracker[{i}]" + k, v)
                for k, v in zip(keys, tree.layout.leaf_views(buf))]
    return out


def _dtype_name(leaf) -> str:
    dt = getattr(leaf, "dtype", None)
    if dt is None:  # a Python scalar: the state's step counter
        return "int32"
    return str(dt).replace("torch.", "")


def _shape(leaf) -> list[int]:
    return [int(s) for s in getattr(leaf, "shape", ())]


# -- snapshots -----------------------------------------------------------

class _Staged:
    """A device-side clone of a buffer and the event after it; `host()`
    waits on the event and copies it to pinned host memory once."""

    def __init__(self, buf):
        import torch
        self.clone = buf.clone()
        self.event = None
        self._host = None
        if self.clone.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def host(self):
        import torch
        if self._host is None:
            if self.event is None:
                self._host = self.clone
            else:
                self.event.synchronize()
                dev = self.clone.device
                out = torch.empty(self.clone.shape, dtype=self.clone.dtype,
                                  pin_memory=True)
                with torch.cuda.device(dev), torch.cuda.stream(
                        _side_stream(dev)):
                    out.copy_(self.clone)
                    torch.cuda.current_stream().synchronize()
                self._host = out
            self.clone = None  # the device copy is no longer needed
        return self._host


_SIDE_STREAMS: dict = {}


def _side_stream(device):
    import torch
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _LeafOf:
    """Leaf ``l`` of a staged flat buffer: columns [lo, hi) of every row,
    viewed as ``shape``."""

    def __init__(self, staged: _Staged, lo: int, hi: int, shape):
        self.staged, self.lo, self.hi, self.shape = staged, lo, hi, shape


def _to_numpy(t) -> np.ndarray:
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_HOST)
    return t.numpy()


def _host(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, _LeafOf):
        return _to_numpy(v.staged.host()[..., v.lo:v.hi].view(v.shape))
    if isinstance(v, _Staged):
        return _to_numpy(v.host())
    return np.asarray(v)


def host_arrays(arrays: dict) -> dict:
    """A snapshot's arrays as numpy (the device-to-host copy of a staged
    clone happens here, on the calling thread)."""
    return {k: _host(v) for k, v in arrays.items()}


def _stage_state(state) -> dict:
    """A `DecentralizedState`'s arrays: one clone per buffer, each leaf a
    column range of it, ``.step`` an int32 scalar."""
    layout = state.layout
    arrays: dict = {}

    def stage(buf):
        s = _Staged(buf)
        lead = (int(buf.shape[0]),)
        for lo, hi, shape in zip(layout.offsets, layout.offsets[1:],
                                 layout.shapes):
            arrays[f"a{len(arrays)}"] = _LeafOf(s, lo, hi, lead + shape)

    stage(state.flat)
    arrays[f"a{len(arrays)}"] = np.asarray(int(state.step), dtype=np.int32)
    for buf in state.tracker or ():
        stage(buf)
    return arrays


def snapshot_tree(step: int, tree: Any,
                  run_meta: dict | None = None) -> tuple[dict, dict]:
    """Stage ``tree``'s leaves for a save without a host sync:
    ``(arrays, meta)``.  Tensors are cloned on their device (a
    `DecentralizedState`'s flat buffer and each tracker buffer in one
    clone each); numpy leaves are copied.  The device-to-host copy
    happens in `commit_snapshot`, on whichever thread commits."""
    import torch
    pairs = tree_leaves_with_path(tree)
    if _is_state(tree):
        arrays = _stage_state(tree)
    else:
        arrays = {f"a{i}": (_Staged(leaf) if isinstance(leaf, torch.Tensor)
                            else np.array(leaf, copy=True))
                  for i, (_, leaf) in enumerate(pairs)}
    meta = {
        "step": step,
        "paths": [p for p, _ in pairs],
        "dtypes": [_dtype_name(leaf) for _, leaf in pairs],
        "shapes": [_shape(leaf) for _, leaf in pairs],
    }
    if run_meta is not None:
        # JSON-stable run configuration (the mixing and fault fingerprints)
        # so a --resume under a different setup fails fast
        meta["run"] = run_meta
    return arrays, meta


# -- the archive -----------------------------------------------------------

def _npy_header(arr: np.ndarray) -> bytes:
    """The npy header the reference writes for ``arr``'s values in C order
    (a bfloat16 leaf's void words under descr '<V2', as ml_dtypes'
    bfloat16 is written)."""
    buf = _io.BytesIO()
    descr = ("<V2" if arr.dtype == _BF16_HOST
             else np.lib.format.dtype_to_descr(arr.dtype))
    np.lib.format.write_array_header_1_0(
        buf, {"descr": descr, "fortran_order": False, "shape": arr.shape})
    return buf.getvalue()


def _npy_bytes(arr: np.ndarray) -> bytes:
    return _npy_header(arr) + arr.tobytes(order="C")


def _c_blocks(arr: np.ndarray, block: int = 1 << 26):
    """``arr``'s bytes in C order as slices of at most ``block`` bytes,
    without copying a C-contiguous array or a C-contiguous row of one
    (a leaf of a flat buffer's host copy is a row-strided view)."""
    if arr.ndim > 1 and not arr.flags.c_contiguous:
        for row in arr:
            yield from _c_blocks(row, block)
        return
    raw = np.asarray(arr, order="C").reshape(-1).view(np.uint8)
    for s in range(0, raw.size, block):
        yield raw[s:s + block]


def _write_npz_zip64(path: str, arrays: dict) -> None:
    """`np.savez`'s archive (stored, ZIP64 entries), with each entry's npy
    header from `_npy_header`; the data goes out in slices, without a
    second copy of a leaf."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            arr = np.asarray(arr)
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                fid.write(_npy_header(arr))
                for part in _c_blocks(arr):
                    fid.write(part)


def _write_npz(path: str, arrays: dict) -> None:
    """Minimal uncompressed ZIP-of-.npy writer (np.load-compatible), the
    reference's byte layout: local headers + stored data + central
    directory, CRCs via zlib.  An archive that would overflow the plain
    ZIP u32 size/offset fields (>= ~4 GiB) takes the ZIP64 route, as the
    reference's `np.savez` fallback does."""
    if (len(arrays) > 0xFFFF  # entry count is a u16 in the end record
            or (sum(np.asarray(a).nbytes for a in arrays.values())
                + (1 << 10) * max(1, len(arrays))) >= _ZIP64_THRESHOLD):
        _write_npz_zip64(path, arrays)
        return
    entries = []  # (name, size, crc, local header offset)
    with open(path, "wb") as f:
        offset = 0
        for name, arr in arrays.items():
            fname = (name + ".npy").encode()
            data = _npy_bytes(np.asarray(arr))
            crc = zlib.crc32(data) & 0xFFFFFFFF
            local = struct.pack("<4s5H3I2H", b"PK\x03\x04", 20, 0, 0, 0, 0,
                                crc, len(data), len(data), len(fname), 0)
            f.write(local + fname)
            f.write(data)
            entries.append((fname, len(data), crc, offset))
            offset += len(local) + len(fname) + len(data)
        cd_size = 0
        for fname, n, crc, off in entries:
            central = struct.pack("<4s6H3I5H2I", b"PK\x01\x02", 20, 20, 0,
                                  0, 0, 0, crc, n, n, len(fname), 0, 0, 0,
                                  0, 0, off)
            f.write(central + fname)
            cd_size += len(central) + len(fname)
        f.write(struct.pack("<4s4H2IH", b"PK\x05\x06", 0, 0, len(entries),
                            len(entries), cd_size, offset, 0))


def commit_snapshot(directory: str, step: int, arrays: dict,
                    meta: dict) -> str:
    """Atomically write one step: stage in step_<n>.tmp-<pid>, then rename.

    A reader never observes a half-written step directory: either the
    rename happened and both files are complete, or the debris still
    carries the ``.tmp-<pid>`` suffix.  A staged device clone comes to
    the host here, on the committing thread."""
    arrays = host_arrays(arrays)
    final = os.path.join(directory, step_dirname(step))
    tmp = final + f"{_TMP_SUFFIX}{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    try:
        _write_npz(os.path.join(tmp, "arrays.npz"), arrays)
        # the staging directory's rename below is the commit point
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        old = None
        if os.path.isdir(final):
            # Re-save of an existing step: park the old directory aside
            # rather than deleting it before the rename, so a crash here
            # never destroys the only durable copy (the manager renames an
            # orphaned parked directory back on its next open).
            old = final + f"{_OLD_SUFFIX}{os.getpid()}"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
        os.rename(tmp, final)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _atomic_write_json(path: str, payload: dict) -> None:
    # Atomic against process death (the rename is the commit point), not
    # fsync'd: a step torn by a power loss is caught by `is_complete` or
    # np.load and skipped like any other incomplete directory.
    tmp = path + f"{_TMP_SUFFIX}{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def save_checkpoint(directory: str, step: int, tree: Any,
                    run_meta: dict | None = None) -> str:
    """Synchronous atomic save (snapshot + commit on the caller's thread);
    the train loop uses `CheckpointManager`, which commits in the
    background, with the same on-disk format."""
    os.makedirs(directory, exist_ok=True)
    arrays, meta = snapshot_tree(step, tree, run_meta=run_meta)
    return commit_snapshot(directory, step, arrays, meta)


def read_run_meta(directory: str, step: int) -> dict:
    """The ``run`` metadata recorded with a step ({} for checkpoints from
    writers that recorded none)."""
    with open(os.path.join(directory, step_dirname(step), "tree.json")) as f:
        return json.load(f).get("run", {})


# -- restore ---------------------------------------------------------------

def _from_numpy(arr: np.ndarray, saved: str):
    import torch
    if saved == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf holds {arr.dtype} words")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(like, it):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, it) for v in like)
    return None if like is None else next(it)


def load_checkpoint(directory: str, step: int, like: Any, *,
                    allow_cast: bool = False) -> Any:
    """Restore into the structure of ``like``, validating paths, shapes and
    dtypes (a precision change needs ``allow_cast=True``).

    A `DecentralizedState` is restored in place: each leaf is copied into
    ``like``'s own buffers, their padding set to zero, and the state is
    returned with the checkpoint's step.  Another tree comes back as a
    new tree of tensors on each template leaf's device, in its dtype."""
    import torch
    src = os.path.join(directory, step_dirname(step))
    with open(os.path.join(src, "tree.json")) as f:
        meta = json.load(f)
    pairs = tree_leaves_with_path(like)
    if len(pairs) != len(meta["paths"]):
        raise ValueError(f"checkpoint has {len(meta['paths'])} leaves, "
                         f"expected {len(pairs)}")
    leaves = []
    with np.load(os.path.join(src, "arrays.npz")) as data:
        for i, (path, leaf) in enumerate(pairs):
            if path != meta["paths"][i]:
                raise ValueError(f"leaf {i} path mismatch: {path} vs "
                                 f"{meta['paths'][i]}")
            arr = data[f"a{i}"]
            if list(arr.shape) != _shape(leaf):
                raise ValueError(f"leaf {i} shape mismatch: {arr.shape} vs "
                                 f"{tuple(_shape(leaf))}")
            want, saved = _dtype_name(leaf), meta["dtypes"][i]
            if saved != want and not allow_cast:
                raise ValueError(
                    f"leaf {i} ({meta['paths'][i]}) dtype mismatch: "
                    f"checkpoint has {saved}, target wants {want}; pass "
                    "allow_cast=True for a deliberate cast")
            leaves.append(_from_numpy(arr, saved))
    if _is_state(like):
        new_step = like.step
        for (path, dst), src_t in zip(pairs, leaves):
            if path == ".step":
                new_step = int(src_t)
            else:
                dst.copy_(src_t)
        for buf in (like.flat,) + tuple(like.tracker or ()):
            buf[:, like.layout.size:].zero_()
        return dataclasses.replace(like, step=new_step)
    out = []
    for (_, leaf), t in zip(pairs, leaves):
        if isinstance(leaf, torch.Tensor):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        elif isinstance(leaf, np.ndarray) and t.dtype != torch.bfloat16:
            t = t.numpy().astype(leaf.dtype)
        out.append(t)
    return _rebuild(like, iter(out))


# -- discovery -------------------------------------------------------------

def is_complete(step_dir: str) -> bool:
    """A step directory counts only with both payload files present and
    non-empty (zero-length files are what a torn, never-fsync'd write
    leaves behind)."""

    def ok(name: str) -> bool:
        try:
            return os.path.getsize(os.path.join(step_dir, name)) > 0
        except OSError:
            return False

    return ok("tree.json") and ok("arrays.npz")


def complete_steps(directory: str) -> list[int]:
    """Sorted steps with complete on-disk payloads (temp/partial skipped)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.fullmatch(name)  # fullmatch: never a .tmp-<pid> dir
        if m and is_complete(os.path.join(directory, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    """Newest step safe to resume from, or None (incomplete steps are
    skipped, so a crash mid-write falls back to the previous one)."""
    steps = complete_steps(directory)
    return steps[-1] if steps else None
