#!/usr/bin/env python3
"""Time versions of B9 (``ring_obfuscate_gossip_krng``, `csrc/ring.cu`) and
B11 (``ssd_intra_chunk``, `csrc/ssm_scan.cu`) in turns on one CUDA card:
the sources as they stand and any other copies named on the command line
(an earlier commit's, unpacked with ``git archive``, or a patched copy).

    python3 scripts/b9_b11_variants.py [--other NAME=DIR ...] [--only b9|b11]

Each DIR holds a ``ring.cu`` and an ``ssm_scan.cu`` (and the headers they
include).  Every version is built with the repo's nvcc flags into its own
library under build/kernels/variants/ (one nvcc each, in parallel) and
called through its C entry point with the port's wrappers; an entry point
of B11 that still takes a (G, Q, Q) scratch (before the one-launch
design) is given one.  Each version's output is compared with the current
source's and the result printed beside its time (a version with work
taken out, to see where the time goes, differs): for B9 bitwise
(``same``), for B11 the largest difference over B11's gate (y 2^-8 |y| +
1e-5 (1 + mag), states 1e-5 (1 + mag); ``gate_ratio``).

B9 runs at the ring path's shape, (4, 893,998,080) bf16, ndirs 2, with 97
leaves and 4096 padding columns, in turns with B3 and B2 on the same
buffers (CUDA events, 5 calls each).  B11 runs at each shape the xLSTM
paths give it, f32 and bf16: device time from a CUDA graph of 50 calls
replayed.  Prints one JSON line per measurement, then the card's name and
power limit; ptxas's register and spill lines go to
chiprun_out/b9_b11_ptxas.txt.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCES = ("ring", "ssm_scan")
RING_SHAPE = (4, 893_998_080)


def build_versions(build, others: dict) -> dict:
    """{version: {source: CDLL}}; the current sources through the repo's
    own build, the others into build/kernels/variants/<version>/."""
    out_dir = build.build_dir() / "variants"
    procs = {}
    for ver, d in others.items():
        for name in SOURCES:
            lib = out_dir / ver / f"lib{name}.so"
            lib.parent.mkdir(parents=True, exist_ok=True)
            procs[ver, name] = (lib, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                 str(Path(d) / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    started = {n: build._start_build(n) for n in SOURCES}
    logs = {("current", n): build._finish_build(n, s)
            for n, s in started.items()}
    libs = {"current": {n: build.library(n) for n in SOURCES}}
    for (ver, name), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {ver}/{name}.cu:\n{log}")
        logs[ver, name] = log
        libs.setdefault(ver, {})[name] = ctypes.CDLL(str(lib))
    report = ROOT / "chiprun_out" / "b9_b11_ptxas.txt"
    report.parent.mkdir(exist_ok=True)
    with open(report, "w") as f:
        for (ver, name), log in logs.items():
            f.write(f"== {ver} {name}\n")
            f.writelines(ln + "\n" for ln in log.splitlines()
                         if "entry function" in ln or "Used" in ln
                         or "spill" in ln)
    return libs


def set_signatures(build, lib, name: str, scratch: bool) -> None:
    for fn, argtypes in build._SIGNATURES[name].items():
        at = list(argtypes)
        if scratch and fn == "ssd_intra_chunk_fwd":
            at.insert(8, ctypes.c_void_p)  # the (G, Q, Q) scores scratch
        getattr(lib, fn).argtypes = at
        getattr(lib, fn).restype = ctypes.c_int


def b9(torch, cs, K, build, libs, iters: int) -> None:
    from repro_torch.dist import collectives as C
    dev = torch.device("cuda")
    m, width = RING_SHAPE
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    X = torch.randn(m, width, generator=g, device=dev, dtype=torch.bfloat16)
    G = torch.randn(m, width, generator=g, device=dev, dtype=torch.bfloat16)
    sizes = [width // 97] * 96
    sizes.append(width - sum(sizes) - 4096)
    offsets = torch.tensor([0, *itertools.accumulate(sizes)],
                           dtype=torch.int64)
    keys = torch.randint(0, 2**32, (m, len(sizes), 2), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(1))
    src = C.source_table(m, 1)
    w = torch.rand(m, 3, generator=g, device=dev)
    b = torch.rand(m, 3, generator=g, device=dev)
    lam = torch.tensor(0.01, device=dev)
    out, V, Xn = (torch.empty_like(X) for _ in range(3))
    Wm = torch.rand(m, m, generator=g, device=dev)
    Bm = torch.rand(m, m, generator=g, device=dev)
    current = build._loaded["ring"]

    def call(ver):
        def fn():
            build._loaded["ring"] = libs[ver]["ring"]
            try:
                return K.ring_obfuscate_gossip_krng(w, b, src, X, G, keys,
                                                    offsets, lam, out=out)
            finally:
                build._loaded["ring"] = current
        return fn

    want = call("current")().clone()
    same = {}
    for ver in libs:
        got = call(ver)()
        same[ver] = torch.equal(got.view(torch.int16), want.view(torch.int16))
    del want
    fns = {f"B9 {ver}": call(ver) for ver in libs}
    fns["B3"] = lambda: K.obfuscate_update_krng(X, G, keys, offsets, lam,
                                                0.0, -1.0, out=V)
    fns["B2"] = lambda: K.gossip_update(Wm, Bm, X, V, out=Xn)
    order = list(fns) + list(reversed(fns))
    times: dict = {}
    for name in order:
        times.setdefault(name, []).append(cs.time_ms(torch, fns[name],
                                                     iters=iters))
    n = m * width
    print(json.dumps({"b9": {k: v for k, v in times.items()}, "same": same,
                      "shape": list(RING_SHAPE), "leaves": len(sizes),
                      "bound_int_ms": n * cs.THREEFRY_INT_OPS
                      / cs.INT32_OPS * 1e3,
                      "bound_bytes_ms": n * 6 / cs.HBM_BYTES_PER_S * 1e3}),
          flush=True)


def b11(torch, cs, K, build, libs, scratch_versions) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    current = build._loaded["ssm_scan"]
    for name, shape in cs.SSD_PATH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            ins = cs.ssd_inputs(torch, shape, dtype, g, dev)
            Gq, Q = shape[0], shape[1]
            y0, s0 = K.ssd_intra_chunk(*ins)
            mag_y, mag_s = K.ref.ssd_intra_chunk_ref(
                ins[0].float().abs(), ins[1], ins[2], ins[3].float().abs(),
                ins[4].float().abs())
            row = {"call": name, "dtype": str(dtype)[6:],
                   "shape": list(shape)}
            for ver, lib in libs.items():
                def fn(ver=ver, lib=lib):
                    if ver in scratch_versions:
                        return old_call(torch, K, lib["ssm_scan"], ins)
                    build._loaded["ssm_scan"] = lib["ssm_scan"]
                    try:
                        return K.ssd_intra_chunk(*ins)
                    finally:
                        build._loaded["ssm_scan"] = current
                y, s = fn()
                torch.cuda.synchronize()
                r = max(float(((y.float() - y0.float()).abs()
                               / (cs.BF16_U * y0.float().abs()
                                  + 1e-5 * (1 + mag_y))).max()),
                        float(((s - s0).abs() / (1e-5 * (1 + mag_s))).max()))
                row[ver] = {**cs.device_ms(torch, fn), "gate_ratio": r}
            print(json.dumps({"b11": row}), flush=True)


def old_call(torch, K, lib, ins):
    """An entry point that still takes the (G, Q, Q) scores scratch."""
    from repro_torch.kernels.build import dtype_code, stream_ptr
    x, dt, a_cum, Bm, Cm = ins
    G, Q, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    states = torch.empty((G, H, P, N), dtype=torch.float32, device=x.device)
    scores = torch.empty((G, Q, Q), dtype=torch.float32, device=x.device)
    status = lib.ssd_intra_chunk_fwd(
        dtype_code(x.dtype), x.data_ptr(), dt.data_ptr(), a_cum.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
        scores.data_ptr(), G, Q, H, P, N, stream_ptr(x.device))
    if status != 0:
        raise RuntimeError(f"ssd_intra_chunk_fwd: CUDA error {status}")
    return y, states


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR holding ring.cu and ssm_scan.cu")
    ap.add_argument("--only", choices=("b9", "b11"))
    ap.add_argument("--iters", type=int, default=5)
    opts = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("b9_b11_variants: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    others = dict(o.split("=", 1) for o in opts.other)
    libs = build_versions(build, others)
    scratch = {ver for ver, d in others.items()
               if "void* scores" in (Path(d) / "ssm_scan.cu").read_text()}
    for ver, lib in libs.items():
        for name in SOURCES:
            set_signatures(build, lib[name], name, ver in scratch
                           and name == "ssm_scan")
    if opts.only in (None, "b11"):
        b11(torch, cs, K, build, libs, scratch)
    if opts.only in (None, "b9"):
        b9(torch, cs, K, build, libs, opts.iters)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
