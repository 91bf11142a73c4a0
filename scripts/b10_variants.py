#!/usr/bin/env python3
"""Where B10's time goes: build variants of the bf16 flash-attention kernel
(`src/repro_torch/csrc/flash_attention.cu`), each with one part of its
work taken out or one parameter changed, and time them in turns at the
serve path's prefill shape (1, 2000, 32, 80) bf16 causal beside
``scaled_dot_product_attention``, on one CUDA card.

    python3 scripts/b10_variants.py [--iters 50]

A variant is a set of text substitutions in the kernel's source; one
whose text no longer matches the source is reported as skipped.  Each
variant is built with the repo's nvcc flags into its own library under
build/kernels/variants/ (one nvcc each, in parallel) and called through
its C entry point.  Variants that keep the arithmetic (scheduling and
pipeline depth) must give the kernel's output bit for bit; the others
(work taken out) give no meaningful output and are timed only.  Prints
one JSON line per variant, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
SHAPE = (1, 2000, 32, 80)

SOFTMAX_CALL = """      if (mask) {
        softmax_tile<true>(sc, m, l, alpha, row, k0, t4, S, causal, window,
                           scale_log2);
      } else {
        softmax_tile<false>(sc, m, l, alpha, row, k0, t4, S, causal, window,
                            scale_log2);
      }"""

# name -> (same output as the kernel, substitutions)
VARIANTS = {
    "kernel": (True, []),
    # the producer's copies and the ring alone: consumers wait for every
    # tile and release it untouched
    "loads_only": (False, [("      const bool any = my_lo < my_hi;",
                            "      const bool any = false;")]),
    # the copies and both products; the scores go to P V as they are
    "no_softmax": (False, [(SOFTMAX_CALL, "alpha[0] = alpha[1] = 1.0f;")]),
    # the softmax without its exp2 (the special-function unit's work)
    "no_exp2": (False, [("x = fast_exp2(fmaf(x, scale_log2, shift));",
                         "x = fmaf(x, scale_log2, shift);")]),
    # the two consumer warpgroups issue their products without taking turns
    "no_pingpong": (True, [("auto turn = [&]() { bar_sync(1 + cw); };",
                            "auto turn = [&]() {};"),
                           ("auto pass = [&]() { bar_arrive(2 - cw); };",
                            "auto pass = [&]() {};")]),
    "stages_2": (True, [("constexpr int kStages = 3;",
                         "constexpr int kStages = 2;")]),
    "stages_4": (True, [("constexpr int kStages = 3;",
                         "constexpr int kStages = 4;")]),
}


def time_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    opts = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("b10_variants: needs a CUDA card", file=sys.stderr)
        return 3
    from repro_torch.kernels import build

    src = SOURCE.read_text()
    out_dir = build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        missing = [old for old, _ in subs if old not in text]
        if missing:
            print(json.dumps({"variant": name, "skipped":
                              "source no longer has: " + missing[0][:60]}))
            continue
        for old, new in subs:
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        f = ctypes.CDLL(str(out_dir / f"lib{name}.so")).flash_attention_fwd
        f.argtypes = build._SIGNATURES["flash_attention"][
            "flash_attention_fwd"]
        f.restype = ctypes.c_int
        fns[name] = f

    B, S, H, hd = SHAPE
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    q, k, v = (torch.randn(B, S, H, hd, generator=g, device=dev).bfloat16()
               for _ in range(3))
    outs = {name: torch.empty_like(q) for name in fns}
    stream = torch.cuda.current_stream().cuda_stream

    def call(name):
        status = fns[name](1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           outs[name].data_ptr(), B, S, H, hd, 1, 0, stream)
        build.check_status(name, status)

    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    order = ["sdpa", *fns]
    times: dict = {name: [] for name in order}
    # in turns, forward then backward, so drift reaches every variant alike
    for turn in (order, order[::-1]):
        for name in turn:
            fn = ((lambda: sdpa(qh, kh, vh, is_causal=True)) if name == "sdpa"
                  else (lambda n=name: call(n)))
            times[name].append(time_ms(torch, fn, opts.iters))
    flops = 4 * hd * H * B * S * (S + 1) // 2
    for name in order:
        rec = {"variant": name, "shape": list(SHAPE), "ms": times[name],
               "tflops": flops / min(times[name]) / 1e9}
        if name in fns and VARIANTS[name][0] and name != "kernel":
            rec["same_output_as_kernel"] = bool(torch.equal(
                outs[name], outs["kernel"]))
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi unavailable")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
