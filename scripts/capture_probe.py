#!/usr/bin/env python3
"""Repeat chip_smoke.py's scanned stablelm-3b cells (the CUDA graph of
``--unroll-k 4`` steps: warm-up chunk, capture, replays) many times in one
process, to look for a fault that shows only now and then.

    python3 -X faulthandler scripts/capture_probe.py [--root DIR]
        [--steps 8] [--repeats 4] [--script] [--nodes]

``--root`` names the checkout whose ``chip_smoke.py`` and ``src/`` run
(default: this one), so an older tree unpacked beside it runs the same
probe.  The probe runs ``phase_main_path_scanned`` and
``phase_dropout_path_scanned`` as the script does, with SCANNED_STEPS set
to ``--steps``, then ``--repeats`` more scanned runs of each of the
dropout cell's modes without their eager comparison.  ``--script`` instead
runs ``chip_smoke.main()`` itself, every phase before the stablelm
scanned cells included, and stops after them (before
``phase_checkpoint_path``).  ``--nodes`` prints, for every graph
captured, its nodes by type (libcuda's ``CUgraphNodeType``) and each
memcpy node's source and destination memory types and bytes: a host node
or a copy from host memory would be replayed from host state that may be
gone.  Under ``-X faulthandler``
a crash prints every thread's Python stack.  One JSON line per run, with
its seconds; the last line ``{"probe": "done", ...}``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait_event", "event_record", "ext_semas_signal",
               "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
               "conditional")
_MEM_TYPES = {1: "host", 2: "device", 3: "array", 4: "unified"}


class _Memcpy3D(ctypes.Structure):
    """libcuda's CUDA_MEMCPY3D."""
    _fields_ = [(n, t) for side in ("src", "dst") for n, t in (
        (f"{side}XInBytes", ctypes.c_size_t), (f"{side}Y", ctypes.c_size_t),
        (f"{side}Z", ctypes.c_size_t), (f"{side}LOD", ctypes.c_size_t),
        (f"{side}MemoryType", ctypes.c_int), (f"{side}Host", ctypes.c_void_p),
        (f"{side}Device", ctypes.c_uint64), (f"{side}Array", ctypes.c_void_p),
        (f"{side}Reserved", ctypes.c_void_p),
        (f"{side}Pitch", ctypes.c_size_t),
        (f"{side}Height", ctypes.c_size_t))] + [
        ("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
        ("Depth", ctypes.c_size_t)]


def graph_nodes(stream) -> dict:
    """The nodes of the graph ``stream`` is capturing, by type."""
    cuda = ctypes.CDLL("libcuda.so.1")
    vp, sz, P = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER
    info = cuda.cuStreamGetCaptureInfo_v3
    info.argtypes = [vp, P(ctypes.c_int), P(ctypes.c_uint64), P(vp), P(vp),
                     P(vp), P(sz)]
    status, cid, graph, deps, edges, ndeps = (
        ctypes.c_int(), ctypes.c_uint64(), vp(), vp(), vp(), sz())
    rc = info(stream.cuda_stream, ctypes.byref(status), ctypes.byref(cid),
              ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(edges),
              ctypes.byref(ndeps))
    if rc != 0 or not graph.value:
        return {"error": f"cuStreamGetCaptureInfo_v3 {rc}"}
    n = sz()
    cuda.cuGraphGetNodes.argtypes = [vp, vp, P(sz)]
    cuda.cuGraphGetNodes(graph, None, ctypes.byref(n))
    nodes = (vp * n.value)()
    cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    cuda.cuGraphNodeGetType.argtypes = [vp, P(ctypes.c_int)]
    cuda.cuGraphMemcpyNodeGetParams.argtypes = [vp, P(_Memcpy3D)]
    types: dict = {}
    copies: dict = {}
    for node in nodes:
        t = ctypes.c_int()
        cuda.cuGraphNodeGetType(node, ctypes.byref(t))
        name = _NODE_TYPES[t.value] if t.value < len(_NODE_TYPES) \
            else str(t.value)
        types[name] = types.get(name, 0) + 1
        if name == "memcpy":
            p = _Memcpy3D()
            cuda.cuGraphMemcpyNodeGetParams(node, ctypes.byref(p))
            key = (f"{_MEM_TYPES.get(p.srcMemoryType, p.srcMemoryType)}->"
                   f"{_MEM_TYPES.get(p.dstMemoryType, p.dstMemoryType)}")
            c = copies.setdefault(key, [0, 0])
            c[0] += 1
            c[1] += p.WidthInBytes * max(p.Height, 1) * max(p.Depth, 1)
    return {"nodes": n.value, "types": types, "memcpy": copies}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--script", action="store_true")
    ap.add_argument("--nodes", action="store_true")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("capture_probe: no CUDA card", file=sys.stderr)
        return 3
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    if opts.nodes:
        from repro_torch.core import pdsgd
        count = pdsgd._capture_nodes

        def nodes_by_type(stream):
            emit({"probe": "graph", **graph_nodes(stream)})
            return count(stream)
        pdsgd._capture_nodes = nodes_by_type
    cs.RECORDS = root / "build" / "capture_probe.jsonl"
    cs.RECORDS.parent.mkdir(parents=True, exist_ok=True)
    cs.SCANNED_STEPS = opts.steps
    cfg = dataclasses.replace(get_config("stablelm-3b"),
                              num_layers=cs.MAIN_LAYERS)
    emit({"probe": "start", "root": str(root), "steps": opts.steps,
          "script": opts.script,
          "torch": torch.__version__})
    t0 = time.perf_counter()
    if opts.script:
        class Stop(Exception):
            pass

        def stop(*_, **__):
            raise Stop

        cs.phase_checkpoint_path = stop
        try:
            cs.main([])
        except Stop:
            pass
        emit({"probe": "done", "through": "ring_path_scanned",
              "s": time.perf_counter() - t0})
        return 0
    for name, phase in (("main_path_scanned", cs.phase_main_path_scanned),
                        ("dropout_path_scanned",
                         cs.phase_dropout_path_scanned)):
        phase(torch, K, train, cfg)
        emit({"probe": name, "s": time.perf_counter() - t0})
    runs = 0
    for r in range(opts.repeats):
        for mode, flags in cs.DROPOUT_SCANNED_RUNS:
            t = time.perf_counter()
            res, counts, _, _ = cs._run_path(
                torch, K, train, cfg, opts.steps, True,
                (*flags, "--unroll-k", str(cs.SCANNED_UNROLL)))
            losses = [h["loss"] for h in res["history"] if "loss" in h]
            cs.check(len(losses) == opts.steps, f"{mode}: steps run")
            del res
            runs += 1
            emit({"probe": "repeat", "repeat": r, "mode": mode,
                  "losses_tail": losses[-2:], "s": time.perf_counter() - t})
    emit({"probe": "done", "scanned_runs": runs + 4,
          "s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
