#!/usr/bin/env python3
"""Where a checkpoint of the main path's state spends its time on one
CUDA card, and whether a commit running beside the train loop slows it.

    python3 scripts/checkpoint_probe.py

The state is the main path's: stablelm-3b at full width, depth 8, m 4,
bf16, one (4, 893,998,080) flat buffer (7.15 GB an archive).  Prints one
JSON line per measurement, then the card's name and power limit:

* ``disk``: 4 GiB written to the checkpoint directory's filesystem in
  64 MiB blocks (into the page cache), its fsync, and read back;
* ``crc32``: zlib's crc32 over 1 GiB (the zip format's checksum);
* ``commit_parts`` (twice: the first pays the pinned host buffer's
  allocation): the snapshot (host and synced seconds), the device-to-host
  copy (`checkpoint.io.host_arrays`), and the npz write;
* ``save_load``: a synchronous `save_checkpoint` and an in-place
  `load_checkpoint`;
* ``writer``: two saves through `CheckpointManager` with the thread and
  the subprocess writer (the caller's seconds a save, each commit's);
* ``interference``: a CUDA graph of 120 bf16 8192³ matmuls replayed in a
  loop on one thread while another runs one part of a commit (idle, the
  device-to-host copy, crc32 over 7.15 GB, 7.15 GB of file writes, a
  copy into shared memory, a whole commit): the loop's median and largest
  ms an iteration beside the part's seconds.

Its files go under build/checkpoint_probe/ in the checkout and are
removed at the end; the shared-memory segments (the subprocess writer's
and the ``copy_to_shared_memory`` part's) take unique names and are
unlinked.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import zlib
from multiprocessing import shared_memory
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "checkpoint_probe"
BLOCK = 1 << 26


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def disk(path: Path, gib: int = 4) -> dict:
    path.mkdir(parents=True, exist_ok=True)
    f = path / "probe.bin"
    buf = np.ones(BLOCK, np.uint8)
    t0 = time.perf_counter()
    with open(f, "wb") as fh:
        for _ in range(gib * (1 << 30) // BLOCK):
            fh.write(buf)
        t1 = time.perf_counter()
        fh.flush()
        os.fsync(fh.fileno())
    t2 = time.perf_counter()
    with open(f, "rb") as fh:
        while fh.read(BLOCK):
            pass
    t3 = time.perf_counter()
    f.unlink()
    return {"probe": "disk", "path": str(path), "gib": gib,
            "write_s": t1 - t0, "fsync_s": t2 - t1, "read_s": t3 - t2}


def main_state(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.pdsgd import init_state
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("stablelm-3b"), num_layers=8)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_state(build_model(cfg).init(gen, "cuda"), 4, device="cuda")
    torch.cuda.synchronize()
    return state


def commit_parts(torch, io, state, rep: int) -> dict:
    r = {"probe": "commit_parts", "rep": rep}
    t0 = time.perf_counter()
    arrays, _ = io.snapshot_tree(12, state)
    r["snapshot_host_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    r["snapshot_synced_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = io.host_arrays(arrays)
    r["host_arrays_s"] = time.perf_counter() - t0
    d = WORK / "parts"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    io._write_npz(str(d / "arrays.npz"), host)
    r["write_npz_s"] = time.perf_counter() - t0
    r["archive_bytes"] = (d / "arrays.npz").stat().st_size
    shutil.rmtree(d)
    return r


def interference(torch, io, state) -> list[dict]:
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            a @ a
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(120):
            a @ a

    def loop(stop, out):
        while not stop.is_set():
            t = time.perf_counter()
            graph.replay()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)

    host = np.ones(7_151_984_640, np.uint8)

    def d2h():
        io.host_arrays(io.snapshot_tree(8, state)[0])

    def crc():
        c = 0
        for s in range(0, host.size, BLOCK):
            c = zlib.crc32(host[s:s + BLOCK], c)

    def write():
        with open(WORK / "interference.bin", "wb") as f:
            for s in range(0, host.size, BLOCK):
                f.write(host[s:s + BLOCK])
        (WORK / "interference.bin").unlink()

    def to_shm():
        seg = shared_memory.SharedMemory(create=True, size=host.size)
        np.copyto(np.ndarray(host.shape, host.dtype, buffer=seg.buf), host)
        seg.close()
        seg.unlink()

    def commit():
        arrays, meta = io.snapshot_tree(8, state)
        io.commit_snapshot(str(WORK / "ck"), 8, arrays, meta)
        shutil.rmtree(WORK / "ck")

    d2h()  # the pinned host buffer, allocated once
    out = []
    for name, job in (("idle", lambda: time.sleep(3)), ("d2h", d2h),
                      ("crc32", crc), ("write", write),
                      ("copy_to_shared_memory", to_shm), ("commit", commit)):
        stop, iters = threading.Event(), []
        th = threading.Thread(target=loop, args=(stop, iters))
        th.start()
        time.sleep(1.0)
        t0 = time.perf_counter()
        job()
        job_s = time.perf_counter() - t0
        stop.set()
        th.join()
        iters.sort()
        out.append({"probe": "interference", "part": name, "part_s": job_s,
                    "iterations": len(iters),
                    "median_ms": 1e3 * iters[len(iters) // 2],
                    "max_ms": 1e3 * iters[-1]})
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("checkpoint_probe: no CUDA card", file=sys.stderr)
        return 3
    from repro_torch.checkpoint import (CheckpointManager, io,
                                        load_checkpoint, save_checkpoint)
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    try:
        emit(disk(WORK))
        block = np.ones(1 << 30, np.uint8)
        t0 = time.perf_counter()
        zlib.crc32(block)
        emit({"probe": "crc32", "gib": 1,
              "seconds": time.perf_counter() - t0})
        del block
        state = main_state(torch)
        state.step = 12
        for rep in range(2):
            emit(commit_parts(torch, io, state, rep))
        d = str(WORK / "save_load")
        t0 = time.perf_counter()
        save_checkpoint(d, 12, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_checkpoint(d, 12, like=state)
        torch.cuda.synchronize()
        emit({"probe": "save_load", "save_s": save_s,
              "load_s": time.perf_counter() - t0})
        shutil.rmtree(d)
        for writer in ("thread", "subprocess"):
            d = str(WORK / writer)
            m = CheckpointManager(d, keep_last=1, writer=writer)
            for s in (4, 8):
                state.step = s
                m.save(s, state)
            t0 = time.perf_counter()
            m.close(join_timeout=900)
            emit({"probe": "writer", "writer": writer,
                  "close_s": time.perf_counter() - t0, **m.timings})
            shutil.rmtree(d)
        for rec in interference(torch, io, state):
            emit(rec)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
