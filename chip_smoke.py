#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the hand-written kernels, holds each against its plain
PyTorch version, trains stablelm-3b at full width through the port's entry
point, and reports what ran.

    python3 chip_smoke.py            # everything (one card)
    python3 chip_smoke.py --quick    # build + kernel phases only
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # main-path steps (chiprun_out/)

Phases, one JSON line each (any failure raises and exits non-zero):
  device      card, power limit, versions, TF32 off, kernel build time
  kernel      B1 obfuscate_update, B3 obfuscate_update_krng, B2 gossip_update
              at (rows, 2^22) against the plain versions
  step_parity stablelm-3b-smoke f32, 4 agents, 2 steps: card vs CPU
  main_path   stablelm-3b (full width, depth 8), 4 agents on a ring, bf16,
              1 warm-up + 5 timed steps through run_training; then B3 and
              B2 timed and checked at the shapes that run gave them
  bits_path   the same entry point with kernel_rng=False (Lambda bits drawn
              outside the kernel, the reference's HBM-bits route) at depth
              2: B1 + B2, B1 timed and checked at that path's shapes
  kernels     every kernel with its launches, error, times and bound
Then the card's name and power limit, then the result line.

Bounds: bytes each kernel must move (inputs read once, outputs written
once) over 3.35e12 B/s, or its float operations over 67e12 FLOP/s (f32
outside the tensor cores), whichever is larger (H100 SXM data sheet).
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
MAIN_LAYERS = 8
# record_function ranges of core/pdsgd.py's step
STEP_RANGES = ("agent_grads", "pdsgd_update", "consensus_error")
BITS_PATH_LAYERS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def same_bits(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bf16_ulps(torch, got, exact, scale) -> float:
    """Max over elements of |got - exact| / (bf16 spacing at |exact| +
    1e-6 * scale): got is a bf16 gossip result, exact the f32 one, scale
    |W| |X| + |B| |U| (the f32 summation-order allowance where the sum
    cancels).  <= 1 means within one bf16 ulp."""
    e = exact.float()
    spacing = torch.exp2(torch.floor(torch.log2(e.abs().clamp_min(1e-30)))
                         - 7)
    return float(((got.float() - e).abs() / (spacing + 1e-6 * scale)).max())


def gossip_scale(W, B, X, U):
    return W.abs() @ X.float().abs() + B.abs() @ U.float().abs()


# --------------------------------------------------------------------------


def phase_device(torch, build):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    built = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in built["logs"].items()}
    rec = {"phase": "device", "nvidia_smi": smi,
           "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0],
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32,
           "build_s": built["seconds"], "ptxas": ptxas}
    emit(rec)
    return smi


def phase_kernels(torch, K, prng):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows, cols = 4, 1 << 22
    out = {}
    # B1: bitwise against the plain version, f32 and bf16, step scalars
    # and general ones
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(rows, cols, generator=g, device=dev).to(dtype)
        gr = torch.randn(rows, cols, generator=g, device=dev).to(dtype)
        bits = torch.randint(0, 2**32, (rows, cols), generator=g, device=dev,
                             dtype=torch.int64).to(torch.uint32)
        for scal in ((0.07, 0.0, -1.0), (0.13, 0.3, -0.7)):
            v = K.obfuscate_update(x, gr, bits, *scal)
            p = K.ref.obfuscate_ref(x, gr, bits, *scal)
            torch.cuda.synchronize()
            check(same_bits(torch, v, p), f"B1 {dtype} {scal} not bitwise")
        out[f"B1_{str(dtype)[6:]}_bitwise"] = True
    # B3: ragged multi-leaf layout; bits vs prng, v vs plain and vs B1
    sizes = [1_000_003, 5, 2_097_152, 77, 999_999, 1]
    offsets = torch.tensor([0, *itertools.accumulate(sizes)],
                           dtype=torch.int64)
    keys = torch.stack([prng.split(prng.fold_in(prng.key(11), a), len(sizes))
                        for a in range(rows)])
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(rows, cols, generator=g, device=dev).to(dtype)
        gr = torch.randn(rows, cols, generator=g, device=dev).to(dtype)
        v, bits = K.obfuscate_update_krng(x, gr, keys, offsets, 0.05, 0.0,
                                          -1.0, return_bits=True)
        want_bits = prng.leaf_bits(keys.to(dev), offsets, rows, cols)
        torch.cuda.synchronize()
        check(torch.equal(bits, want_bits), f"B3 {dtype} bits differ")
        check(same_bits(torch, v, K.ref.obfuscate_ref(x, gr, want_bits, 0.05,
                                                      0.0, -1.0)),
              f"B3 {dtype} v differs from the plain version")
        check(same_bits(torch, v, K.obfuscate_update(x, gr, bits, 0.05, 0.0,
                                                     -1.0)),
              f"B3 {dtype} v differs from B1 fed its bits")
        out[f"B3_{str(dtype)[6:]}_bitwise"] = True
    # B2: f32 max abs/rel error; bf16 within 1 bf16 ulp of the f32 result
    for m in (4, 5, 32):
        W = torch.rand(m, m, generator=g, device=dev)
        B = torch.rand(m, m, generator=g, device=dev)
        W, B = W / W.sum(0), B / B.sum(0)
        X = torch.randn(m, cols, generator=g, device=dev)
        U = torch.randn(m, cols, generator=g, device=dev)
        got = K.gossip_update(W, B, X, U)
        want = K.ref.gossip_ref(W, B, X, U)
        err = (got - want).abs()
        abs_err = float(err.max())
        rel_err = float((err / want.abs().clamp_min(1e-6)).max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"B2 f32 m={m} abs {abs_err}")
        got16 = K.gossip_update(W, B, X.bfloat16(), U.bfloat16())
        exact = K.ref.gossip_ref(W, B, X.bfloat16().float(),
                                 U.bfloat16().float())
        ulps = bf16_ulps(torch, got16, exact,
                         gossip_scale(W, B, X.bfloat16(), U.bfloat16()))
        check(ulps <= 1.0, f"B2 bf16 m={m}: {ulps} bf16 ulps")
        out[f"B2_m{m}"] = {"f32_max_abs_err": abs_err,
                           "f32_max_rel_err": rel_err,
                           "bf16_max_ulps_vs_f32": ulps}
    emit({"phase": "kernel", "shape": [rows, cols],
          "tolerances": {"B1": "bitwise", "B3": "bitwise",
                         "B2_f32": "rtol 1e-5 atol 1e-5",
                         "B2_bf16": "1 bf16 ulp of the f32 result, plus 1e-6 (|W||X|+|B||U|) where the sum cancels"},
          "results": out})


def phase_step_parity(torch, train):
    """2 steps of stablelm-3b-smoke (f32) through run_training on the card
    (kernels) and on the CPU (plain versions), same weights and batches.
    Tolerance: losses rtol 1e-5; params atol 1e-3 + rtol 1e-4 — the smoke
    model's 0.02-scale embeddings under LayerNorm amplify the first
    step's summation-order difference (as on the CPU against the
    reference, tests/test_torch_train.py)."""
    from repro_torch.core.privacy import tree_leaves
    from repro_torch.models import build_model
    from repro_torch.configs import get_config
    cfg = get_config("stablelm-3b-smoke")
    gen = torch.Generator()
    gen.manual_seed(5)
    p0 = build_model(cfg).init(gen, "cpu")
    flags = ["--arch", "stablelm-3b-smoke", "--agents", "4", "--steps", "2",
             "--log-every", "1", "--seq-len", "64", "--seed", "5"]
    gpu = train.run_training(train.build_parser().parse_args(
        flags + ["--device", "cuda"]), init_params=p0)
    cpu = train.run_training(train.build_parser().parse_args(
        flags + ["--device", "cpu"]), init_params=p0)
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(gpu["history"], cpu["history"]))
    check(loss_rel <= 1e-5, f"step_parity loss rel {loss_rel}")
    max_abs = 0.0
    for a, b in zip(tree_leaves(gpu["state"].params),
                    tree_leaves(cpu["state"].params)):
        a = a.cpu()
        max_abs = max(max_abs, float((a - b).abs().max()))
        check(torch.allclose(a, b, atol=1e-3, rtol=1e-4),
              "step_parity params")
    emit({"phase": "step_parity", "arch": "stablelm-3b-smoke",
          "dtype": "float32", "agents": 4, "steps": 2,
          "losses_gpu": [r["loss"] for r in gpu["history"]],
          "losses_cpu": [r["loss"] for r in cpu["history"]],
          "max_loss_rel_err": loss_rel, "max_param_abs_err": max_abs,
          "tolerance": "loss rtol 1e-5; params atol 1e-3 + rtol 1e-4"})


def _chunks(n: int, size: int = 1 << 24):
    for s in range(0, n, size):
        yield s, min(n, s + size)


def _run_path(torch, K, train, cfg, steps: int, kernel_rng: bool):
    args = train.build_parser().parse_args(
        ["--agents", "4", "--topology", "ring", "--per-agent-batch", "2",
         "--seq-len", "512", "--steps", str(steps), "--log-every", "1",
         "--lr", "0.4", "--warmup-hold", "200", "--seed", "0",
         "--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.run_training(args, cfg=cfg, kernel_rng=kernel_rng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    return res, counts, wall, torch.cuda.max_memory_allocated()


def _finite_flat(torch, flat) -> bool:
    return all(bool(torch.isfinite(flat[:, s:e]).all())
               for s, e in _chunks(flat.shape[1]))


def phase_main_path(torch, K, train, prng, cfg):
    from repro_torch.core.pdsgd import lambda_key_table
    from repro_torch.core.privacy import sample_B
    steps = 6
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True)
    hist = res["history"]
    losses = [r["loss"] for r in hist]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(X.dtype == torch.bfloat16 and width % 512 == 0, "buffer")
    check(_finite_flat(torch, X), "non-finite parameters")
    check(counts.get("obfuscate_update_krng", 0) == steps
          and counts.get("gossip_update", 0) == steps
          and counts.get("obfuscate_update", 0) == 0,
          f"main-path launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    emit({"phase": "main_path", "arch": cfg.name, "num_layers":
          cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "dtype": cfg.dtype, "agents": m, "topology": "ring",
          "per_agent_batch": 2, "seq_len": 512,
          "params_per_agent": state.layout.size, "width": width,
          "losses": losses, "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})

    # the kernels at this path's shapes, on its own buffer: u and x' over a
    # gradient-like buffer, the layout's leaves and the step's key table
    gen = torch.Generator(device=X.device)
    gen.manual_seed(1)
    G = torch.randn(X.shape, generator=gen, device=X.device,
                    dtype=torch.bfloat16)
    G[:, state.layout.size:] = 0
    offsets = torch.tensor(state.layout.offsets, dtype=torch.int64)
    keys = lambda_key_table(prng.fold_in(prng.key(1), steps), steps, m,
                            state.layout.n_leaves)
    lam = torch.tensor(0.01, device=X.device)
    n = m * width
    # B3
    V = K.obfuscate_update_krng(X, G, keys, offsets, lam, 0.0, -1.0)
    kd = keys.to(X.device)
    for s, e in _chunks(width):
        bits = prng.leaf_bits(kd, offsets, m, width, start=s, stop=e)
        check(same_bits(torch, V[:, s:e], K.ref.obfuscate_ref(
            X[:, s:e], G[:, s:e], bits, lam, 0.0, -1.0)),
            f"B3 main-path shape differs at columns {s}:{e}")
    b3 = {"ms": time_ms(torch, lambda: K.obfuscate_update_krng(
              X, G, keys, offsets, lam, 0.0, -1.0, out=V), iters=5),
          "max_abs_err": 0.0}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s, e in _chunks(width):
        bits = prng.leaf_bits(kd, offsets, m, width, start=s, stop=e)
        K.ref.obfuscate_ref(X[:, s:e], G[:, s:e], bits, lam, 0.0, -1.0)
    torch.cuda.synchronize()
    b3["plain_ms"] = (time.perf_counter() - t) * 1e3
    b3["bound_ms"], b3["bound_by"] = bound_ms(n * 6, n * 5)
    b3["library_ms"] = None
    # B2 on (X, V), bf16
    from repro_torch.core.topology import make_topology
    top = make_topology("ring", m)
    W = torch.tensor(top.weights, dtype=torch.float32, device=X.device)
    B = sample_B(prng.key(3), torch.tensor(top.adjacency,
                                           dtype=torch.float32,
                                           device=X.device))
    Xn = K.gossip_update(W, B, X, V)
    ulps = 0.0
    for s, e in _chunks(width):
        exact = W @ X[:, s:e].float() - B @ V[:, s:e].float()
        ulps = max(ulps, bf16_ulps(torch, Xn[:, s:e], exact, gossip_scale(
            W, B, X[:, s:e], V[:, s:e])))
    check(ulps <= 1.0, f"B2 main-path shape: {ulps} bf16 ulps")
    max_err = 0.0
    for s, e in _chunks(width):
        p = K.ref.gossip_ref(W, B, X[:, s:e], V[:, s:e])
        max_err = max(max_err, float((Xn[:, s:e].float() - p.float())
                                     .abs().max()))
    b2 = {"ms": time_ms(torch, lambda: K.gossip_update(W, B, X, V, out=Xn),
                        iters=10), "max_abs_err": max_err,
          "max_bf16_ulps_vs_f32": ulps}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s, e in _chunks(width):
        K.ref.gossip_ref(W, B, X[:, s:e], V[:, s:e])
    torch.cuda.synchronize()
    b2["plain_ms"] = (time.perf_counter() - t) * 1e3
    Wb, Bb = W.bfloat16(), B.bfloat16()
    b2["library_ms"] = time_ms(torch, lambda: Wb @ X - Bb @ V, iters=5)
    b2["bound_ms"], b2["bound_by"] = bound_ms(n * 6, width * 4 * m * m)
    emit({"phase": "main_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B3": b3, "B2": b2})
    del G, V, Xn
    return {"obfuscate_update_krng": (counts, b3),
            "gossip_update": (counts, b2)}


def phase_bits_path(torch, K, train, prng, cfg):
    steps = 2
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, False)
    hist = res["history"]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(r["loss"]) for r in hist), "bits_path losses")
    check(_finite_flat(torch, X), "bits_path non-finite parameters")
    check(counts.get("obfuscate_update", 0) == steps
          and counts.get("gossip_update", 0) == steps
          and counts.get("obfuscate_update_krng", 0) == 0,
          f"bits_path launches {counts}")
    emit({"phase": "bits_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "agents": m,
          "losses": [r["loss"] for r in hist], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})
    from repro_torch.core.pdsgd import per_agent_bits
    gen = torch.Generator(device=X.device)
    gen.manual_seed(2)
    G = torch.randn(X.shape, generator=gen, device=X.device,
                    dtype=torch.bfloat16)
    bits = per_agent_bits(prng.fold_in(prng.key(1), steps), steps,
                          state.layout, m, device=X.device)
    lam = torch.tensor(0.01, device=X.device)
    V = K.obfuscate_update(X, G, bits, lam, 0.0, -1.0)
    for s, e in _chunks(width):
        check(same_bits(torch, V[:, s:e], K.ref.obfuscate_ref(
            X[:, s:e], G[:, s:e], bits[:, s:e], lam, 0.0, -1.0)),
            f"B1 bits-path shape differs at columns {s}:{e}")
    n = m * width
    b1 = {"ms": time_ms(torch, lambda: K.obfuscate_update(
              X, G, bits, lam, 0.0, -1.0, out=V), iters=10),
          "max_abs_err": 0.0}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s, e in _chunks(width):
        K.ref.obfuscate_ref(X[:, s:e], G[:, s:e], bits[:, s:e], lam, 0.0,
                            -1.0)
    torch.cuda.synchronize()
    b1["plain_ms"] = (time.perf_counter() - t) * 1e3

    def library():
        # the same expression in as few torch eager ops as it goes
        u01 = ((bits.view(torch.int32) >> 9) & 0x7FFFFF
               | 0x3F800000).view(torch.float32) - 1.0
        return torch.addcmul(0.0 * X.float(), 2.0 * lam * u01, G.float(),
                             value=1.0).bfloat16()

    b1["library_ms"] = time_ms(torch, library, iters=3, warmup=1)
    b1["bound_ms"], b1["bound_by"] = bound_ms(n * 10, n * 5)
    emit({"phase": "bits_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B1": b1})
    return {"obfuscate_update": (counts, b1)}


def phase_profile(torch, train, cfg, steps: int = 4):
    """Device time by kernel over main-path steps 1..steps-1 (step 0 warms
    up), from a torch.profiler trace of run_training; each step is the
    range ``train_step_<k>``.  Writes the full table to
    chiprun_out/profile_main_path.json."""
    from torch.profiler import ProfilerActivity, profile
    args = train.build_parser().parse_args(
        ["--agents", "4", "--topology", "ring", "--per-agent-batch", "2",
         "--seq-len", "512", "--steps", str(steps), "--log-every", "1",
         "--device", "cuda"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train.run_training(args, cfg=cfg)
    torch.cuda.synchronize()
    events = prof.events()
    # the GPU finishes each step before the next starts (the loop reads the
    # loss), so every kernel that starts after step 1's range opened
    # belongs to steps 1..steps-1
    lo = min(e.time_range.start for e in events
             if e.name == "train_step_1")
    # (the step's named ranges also appear on the device timeline; they
    # are not kernels)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.start >= lo
               and e.name not in STEP_RANGES
               and not e.name.startswith("train_step_")]
    hi = max(e.time_range.end for e in kernels)
    by_name: dict[str, float] = {}
    busy = 0.0
    for e in kernels:
        dur = (e.time_range.end - e.time_range.start) / 1e3  # us -> ms
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        busy += dur
    n = steps - 1
    window_ms = (hi - lo) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    table = [{"kernel": k[:120], "ms_per_step": v / n,
              "share_of_device": v / busy} for k, v in top]
    # host side: the step's named ranges, and CPU ops by self time
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.time_range.start >= lo]
    ranges: dict[str, float] = {}
    self_ms: dict[str, float] = {}
    for e in host:
        if e.name in STEP_RANGES or e.name.startswith("train_step_"):
            key = "train_step" if e.name.startswith("train_step_") \
                else e.name
            ranges[key] = ranges.get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / n
        self_ms[e.name] = self_ms.get(e.name, 0.0) + \
            e.self_cpu_time_total / 1e3 / n
    host_top = [{"op": k[:80], "self_ms_per_step": v} for k, v in
                sorted(self_ms.items(), key=lambda kv: -kv[1])[:15]]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_main_path.json").write_text(json.dumps(
        {"steps": n, "window_ms": window_ms, "busy_ms": busy,
         "kernels": table, "host_ranges_ms_per_step": ranges,
         "host_ops": host_top}, indent=1))
    emit({"phase": "profile", "steps_profiled": n,
          "step_ms": window_ms / n, "device_busy_ms_per_step": busy / n,
          "idle_share": 1.0 - busy / window_ms,
          "host_ranges_ms_per_step": ranges, "host_top": host_top[:8],
          "top": table[:12]})


SOURCES = {
    "obfuscate_update": ("src/repro_torch/csrc/obfuscate.cu",
                         "src/repro/kernels/obfuscate.py:85"),
    "obfuscate_update_krng": ("src/repro_torch/csrc/obfuscate.cu",
                              "src/repro/kernels/obfuscate.py:153"),
    "gossip_update": ("src/repro_torch/csrc/gossip.cu",
                      "src/repro/kernels/gossip.py:78"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel phases only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile main-path steps with torch.profiler")
    opts = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels run only on a CUDA card", file=sys.stderr)
        return 3
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import build
    from repro_torch.launch import train

    smi = phase_device(torch, build)
    phase_kernels(torch, K, prng)
    rows = {}
    if not opts.quick:
        phase_step_parity(torch, train)
        full = get_config("stablelm-3b")
        rows.update(phase_main_path(
            torch, K, train, prng,
            dataclasses.replace(full, num_layers=MAIN_LAYERS)))
        torch.cuda.empty_cache()
        if opts.profile:
            phase_profile(torch, train, dataclasses.replace(
                full, num_layers=MAIN_LAYERS))
            torch.cuda.empty_cache()
        rows.update(phase_bits_path(
            torch, K, train, prng,
            dataclasses.replace(full, num_layers=BITS_PATH_LAYERS)))
        kernels = []
        for name, (counts, r) in rows.items():
            src, replaces = SOURCES[name]
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": counts.get(name, 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
