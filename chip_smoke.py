#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the hand-written kernels, holds each against its plain
PyTorch version, trains stablelm-3b at full width and serves it at full
width and depth, trains and serves xlstm-125m at full width and depth,
all through the port's entry points, and reports what ran.

    python3 chip_smoke.py            # everything (one card)
    python3 chip_smoke.py --quick    # build + kernel phases only
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown of
                                     # main-, dropout-, fault-, ring- and
                                     # xLSTM train-path steps, of the
                                     # scanned main path's replayed chunks
                                     # and of both serve paths' prefills
                                     # and decode chunks
                                     # (chiprun_out/profile_<path>.json)

Phases, one JSON line each (any failure raises and exits non-zero):
  device      card, power limit, versions, TF32 off, kernel build time
  kernel      B1 obfuscate_update, B3 obfuscate_update_krng, B2 gossip_update
              at (rows, 2^22) against the plain versions; B4
              masked_gossip_update, B5 masked_gossip_update_krng and B6
              guarded_gossip_update at m = 4, 5, 32 in f32 and bf16
  step_parity stablelm-3b-smoke f32, 4 agents, 2 steps: card vs CPU, for
              PDSGD, DSGD, DSGT, DP-DSGD and PDSGD with the gradient clip
  main_path   stablelm-3b (full width, depth 8), 4 agents on a ring, bf16,
              1 warm-up + 5 timed steps through run_training; then B3 and
              B2 timed and checked at the shapes that run gave them
  fig2_path   the paper's Fig. 2 workload (the North star): 600 PDSGD
              steps (B3 + B2) through the eager loop and through the
              scanned step (a CUDA graph of 100 steps, replayed), in jax's
              earlier threefry stream (partitionable=False); gates: graph
              == eager bitwise, final_err within a relative 1e-3 of
              0.07891825798133546; then one replay traced by
              torch.profiler: kernels and device time a replayed step, B3
              and B2 kernels counted in the trace
  main_path_scanned  the main path with --unroll-k 4: a warm-up chunk,
              then 8 steps replayed from the CUDA graph, beside the same
              12 steps eager; the states equal bit for bit; launches
              counted on the warm-up chunk and, for the replays, from the
              capture
  dropout_path_scanned  the main path with --topology-dropout 0.25 and
              --unroll-k 4 (a warm-up chunk, then 8 steps replayed from the
              CUDA graph, each W_k realized in it from the device step
              counter, B3 + B4), beside the same 12 steps eager; then with
              --topology-resample-every 4 and 3 (3: redraws inside the
              replayed chunks); the states equal bit for bit;
              B4's launches from the capture
  privacy_audit  launch/audit.main on the card at the reference's defaults
              (m 5, dim 3, 8 parity steps, 40 attack steps, 200,000
              samples; B3 + B2), then with --topology-dropout 0.3 (B4 in
              the CUDA graph); gates: capture-on == capture-off bitwise on
              every path, the four paths' streams bitwise and ok,
              theta (kNN and binned) within 0.02 of 1.0322, DSGD's
              recovery exact (relative error < 1e-6), PDSGD's least-squares
              MSE at or above the Theorem-5 bound, theorem5 equal to a CPU
              run's; the attack numbers beside the CPU run's, capture on
              against off microseconds a replayed step
  privacy_capture_path  stablelm-3b at full width, depth 2, m 4, bf16: one
              step from one state with capture off, auditor() and
              external_eavesdropper() (concat: B3 + B2), then off and the
              eavesdropper on the ring layout (B9); V is (4, 4, D) f32,
              26.8 GB; gates: x' equal to capture-off bitwise, V's
              diagonal zero, concat V = w x - b u of B3's own u, ring V
              within u's bf16 rounding of concat V; ms on against off,
              peak memory, V's bytes bound
  baselines_path  the main path's configuration, eager, 3 steps each:
              --algorithm dsgt (peak carries the tracker pair), dp_dsgd
              --sigma-dp 0.01, pdsgd --grad-clip-kappa 1.0 (B3 + B2), dsgd
              (6 steps), then dsgd --unroll-k 3 equal to it bit for bit;
              then the plain dsgd and dsgt updates alone, device ms
              beside their bytes bounds; no
              B-kernel for the baselines
  dropout_path  the same model and entry point with --topology-dropout
              0.25 (B3 + B4), 1 warm-up + 6 timed steps, then one
              fused_pdsgd_flat(mask_key=...) update on its buffers (B5);
              B4 and B5 timed and checked there
  fault_path  the same model with Markov crash/restart, nan-corrupt
              senders, guard clip 1e3 and --nan-policy skip (B3 + B6), 6
              steps; B6 timed and checked at that path's shapes
  kernel_attention  B10 flash_attention against ref.flash_attention_ref,
              f32 and bf16, S in {1, 7, 127, 128, 129, 130, 255, 257, 2000}
              x hd in {8, 16, 32, 40, 64, 80, 128} x (causal, causal +
              window 256, non-causal, non-causal + window 100); grouped-query
              prefill through
              models.transformer._attn (k, v repeated to H heads for B10)
              at granite-8b's H = 32, KV = 8, hd = 128, S in {130, 2000},
              f32 and bf16, against the plain grouped attention; timed at
              the serve path's (1, 2000, 32, 80) bf16 causal with its plain
              version and scaled_dot_product_attention (library, timed
              only)
  kernel_ssd  B11 ssd_intra_chunk against ref.ssd_intra_chunk_ref, f32 and
              bf16 (bf16 held against f32 on the same inputs), over the
              reference sweep, xlstm-125m's folded shapes (P in {384, 1},
              N = 384, Q in {1, 7, 52, 64}) and zamba2-7b's (G, 64, 112,
              64), N = 64, and both sides of the kernel's routes and tiles
              (Q in {2, 15, 16, 17, 63, 65, 127}, ragged P and N); the
              autograd Function's gradients against autograd through the
              plain version; timed at the xLSTM serve prefill's (32, 64, 1,
              384), N = 384, bf16 and f32, then at each shape the xLSTM
              paths give it (training, prefill and decode; memory and
              normalizer calls), f32 and bf16, each beside its own bound:
              device time from a CUDA graph of the calls replayed, the
              host's microseconds a call beside it
  kernel_ring B7 ring_gossip_update, B8 ring_obfuscate_gossip and B9
              ring_obfuscate_gossip_krng bitwise against their plain
              versions, f32 and bf16, on rings of m = 2, 4, 5, 32 and the
              (4, 2) torus: capture, a dropped direction, a planted nan, B9's
              bits and B9 == B8 on them; then B9 over leaf layouts that
              stress its per-tile leaf lookup (a boundary inside a tile, a
              leaf of many tiles, one-column leaves, padding past the last
              leaf, n no multiple of a tile)
  ring_path   the main path's model and flags with --kernel-layout ring (B9
              only, one launch a step), 1 warm-up + 6 timed steps, then one
              torus_gossip_pdsgd(None, ..., fused=True) on its buffers (B7);
              B9 and B7 checked and timed (B9 in turns with B3 and B2 on
              the same buffers) there, and the ring update held
              against the concat update (B3 + B2) on the same draws
  bits_path   the same entry point with kernel_rng=False (Lambda bits drawn
              outside the kernel, the reference's HBM-bits route) at depth
              2: B1 + B2, B1 timed and checked at that path's shapes
  ring_bits_path  the bits path with --kernel-layout ring: B8 every step,
              checked and timed at that path's shapes
  serve_parity  stablelm-3b-smoke f32, 4 requests on 2 slots, greedy,
              through launch/serve.run_serving on the card (B10) and on the
              CPU (naive attention), same weights: equal token streams,
              prefill logits within 1e-4
  serve_path  launch/serve with --arch stablelm-3b --slots 8 --requests 16
              --prompt-len 2000 --gen-tokens 64 --decode-chunk 8
              --parity-check: full width and depth, bf16, B10 32 times a
              prefill; gate: the engine's streams equal the same-width
              oracle's exactly (below); --parity-check's M = 1 comparison
              printed, and where it differs the batched-vs-B=1 logit
              spread, the margin rule's record (the first near tie, a top-2
              margin below the spread) and a layer-by-layer trace of the two
              residual streams in bf16 and in f32
  xlstm_step_parity  xlstm-125m-smoke f32, 4 agents, 2 steps: card vs CPU
  xlstm_train_path  run_training --arch xlstm-125m, 12 blocks, d_model 768,
              4 agents on a ring, bf16, PDSGD, per-agent batch 2, seq 128
              (cut for the sLSTM's host loop), 1 warm-up + 3 timed steps:
              B3 + B2 every step, B11 48 times a step
  xlstm_serve_parity  xlstm-125m-smoke f32, 4 requests on 2 slots: card vs
              CPU
  xlstm_serve_path  launch/serve with --arch xlstm-125m --slots 8
              --requests 16 --prompt-len 500 (cut for the sLSTM's host loop)
              --gen-tokens 32 --decode-chunk 8 --parity-check: full width
              and depth, bf16; B11 12 times a prefill and a decode step; the
              same gate as serve_path
  kernels     every kernel with its launches in its own path's run (B3
              and B2: main_path; B11: the xLSTM train and serve paths),
              error, times and bound
Then B10's time and TFLOP/s at the serve shape beside those of
scaled_dot_product_attention in the same run, the card's name and power
limit, and the result line.  Each phase's line is also appended to
chiprun_out/chip_smoke.jsonl (emptied at the start).

The serve paths' gate is a same-width oracle: each request decoded alone,
its prefill paged into every row of a batch ``--slots`` rows wide and
decoded there at per-row positions, so every product has the engine's
shapes (M = slots); the engine's streams must equal it exactly.  The
M = 1 sequential decode (--parity-check) rounds its products differently
and is a diagnostic only.

Bounds: B1-B9 (elementwise and m <= 32 mixing): bytes each kernel must
move (inputs read once, outputs written once) over 3.35e12 B/s, or its
float operations over 67e12 FLOP/s (f32 outside the tensor cores), or,
for the kernels that draw threefry bits (B3, B9 one word an element, B5
one an edge), their 32-bit integer operations (73 a word, counted from
csrc/threefry.cuh) over 16.7e12 op/s (64 INT32 lanes an SM), whichever is
larger.  B10 (matmul-shaped): its bytes over 3.35e12 B/s or
its FLOPs over the unmasked (query, key) pairs, 4 hd per pair, over
989e12 FLOP/s (dense bf16 tensor cores), whichever is larger; its f32
CUDA-core bound (67e12) is printed beside it.  B11 (its products on tensor
cores): its bytes (x, Bm, Cm, dt, a_cum read once, y and the f32 states
written once) over 3.35e12 B/s or its FLOPs over 989e12 FLOP/s,
whichever is larger: 2 N per causal (i, j) pair for the scores, 2 H P per
pair for y, 2 Q H P N for the states, a chunk; its f32 CUDA-core bound
(67e12, the bound of the FMA kernel it replaced) is printed beside it.
(H100 SXM data sheet.)
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# 32-bit integer operations: 64 INT32 lanes an SM (Hopper white paper) x
# 132 SMs x 1.98 GHz, the clock of the f32 rate (132 x 128 x 2 x 1.98e9 =
# 67e12)
INT32_OPS = 132 * 64 * 1.98e9
# integer operations of one threefry draw as csrc/threefry.cuh does it: 2
# initial adds, 20 rounds of add, rotate and xor, 5 key injections of 2
# adds, the final xor (the key-only work, k2 and the injection constants,
# is per key and not counted)
THREEFRY_INT_OPS = 2 + 20 * 3 + 5 * 2 + 1
MAIN_LAYERS = 8
# record_function ranges of core/pdsgd.py's step
STEP_RANGES = ("coupling", "held_state", "agent_grads", "pdsgd_update",
               "dsgd_update", "dsgt_update", "dp_dsgd_update",
               "consensus_error")
BITS_PATH_LAYERS = 2


# every phase record is also kept here: the run's standard output is
# longer than what a caller may see of it
RECORDS = ROOT / "chiprun_out" / "chip_smoke.jsonl"


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with RECORDS.open("a") as f:
        f.write(line + "\n")


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


def device_ms(torch, fn, iters: int = 50, replays: int = 5) -> dict:
    """Device time of one call of ``fn`` apart from its host cost:
    ``iters`` calls captured in a CUDA graph and the graph replayed
    ``replays`` times between CUDA events (``device_ms``, the kernels back
    to back with the graph's launch gaps), and the host's microseconds a
    call with the calls issued eagerly one after another, no sync
    (``host_us``: the wrapper's dispatch, what a host-bound loop pays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    dev = t0.elapsed_time(t1) / (replays * iters)
    del graph
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - h0) / iters * 1e6
    torch.cuda.synchronize()
    return {"device_ms": dev, "host_us": host}


def bound_ms(nbytes: float, flops: float = 0.0,
             int_ops: float = 0.0) -> tuple[float, str]:
    """The least time of a kernel on the card: its bytes over the memory
    rate, its f32 operations over the f32 rate, its 32-bit integer
    operations over the integer rate, whichever is largest."""
    by = nbytes / HBM_BYTES_PER_S * 1e3
    op = max(flops / F32_FLOPS, int_ops / INT32_OPS) * 1e3
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


def same_values(torch, a, b) -> bool:
    """Equal values, nan where the other has nan (payloads aside)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def rand_mask(torch, m: int, gen, dev, p: float = 0.6):
    """A symmetric 0/1 off-diagonal edge mask with agent 0 cut off (the
    row of a down agent)."""
    keep = torch.triu((torch.rand(m, m, generator=gen, device=dev) < p)
                      .float(), diagonal=1)
    mask = keep + keep.T
    mask[0, :] = 0.0
    mask[:, 0] = 0.0
    return mask


def col_stochastic(torch, support, gen):
    B = torch.rand(support.shape, generator=gen,
                   device=support.device) * support
    return B / B.sum(0)


def guarded_abs(torch, K, mask, B, X, U, XT, UT, clip):
    """|w_ii x_i| + |b_ii u_i| + sum_j |guard(w_ij xt_j - b_ij ut_j)|, the
    magnitude the guarded sum is rounded at (a non-finite link counts 0):
    where large clipped links cancel, a summation-order difference is
    relative to this, not to the result."""
    m = X.shape[0]
    w = K.ref.metropolis_ref(mask)
    eye = torch.eye(m, device=w.device)
    x, u = X.float(), U.float()
    total = ((torch.diagonal(w)[:, None] * x).abs()
             + (torch.diagonal(B)[:, None] * u).abs())
    v = ((w * (1 - eye))[:, :, None] * XT.float()[None]
         - (B * (1 - eye))[:, :, None] * UT.float()[None])
    if clip is not None:
        v = torch.clamp(v, -clip, clip)
    return total + v.abs().nan_to_num(0.0, 0.0, 0.0).sum(dim=1)


def guarded_check(torch, K, got, want, exact, mask, B, X, U, XT, UT, clip,
                  what: str):
    """B6 against its plain version: nan and inf exactly where the plain
    version has them; finite entries to B2's tolerances taken relative to
    the magnitude of the summed terms (`guarded_abs`): f32 |got - want| <=
    1e-5 (1 + scale); bf16 within one bf16 ulp of the f32 result ``exact``
    plus 1e-6 scale.  Returns (max abs error, max bf16 ulps) over the
    finite entries."""
    check(torch.equal(torch.isnan(got), torch.isnan(want))
          and torch.equal(torch.isinf(got), torch.isinf(want)),
          f"B6 {what}: non-finite positions differ from the plain version")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0, 0.0
    scale = guarded_abs(torch, K, mask, B, X, U, XT, UT, clip)
    diff = (got.float() - want.float()).abs()
    err = float(diff[fin].max())
    if got.dtype == torch.float32:
        ratio = float((diff / (1e-5 * (1.0 + scale)))[fin].max())
        check(ratio <= 1.0, f"B6 {what}: abs {err}, {ratio} of the "
                            f"tolerance")
        return err, 0.0
    e = exact.float()
    spacing = torch.exp2(torch.floor(torch.log2(
        e.abs().clamp_min(1e-30))) - 7)
    ulps = float(((got.float() - e).abs() / (spacing + 1e-6 * scale))[fin]
                 .max())
    check(ulps <= 1.0, f"B6 {what}: {ulps} bf16 ulps")
    return err, ulps


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
        # jax's earlier threefry stream (the Fig. 2 target's), odd and
        # even leaves
        v, bits = K.obfuscate_update_krng(x, gr, keys, offsets, 0.05, 0.0,
                                          -1.0, return_bits=True,
                                          partitionable=False)
        want_bits = prng.leaf_bits(keys.to(dev), offsets, rows, cols,
                                   partitionable=False)
        torch.cuda.synchronize()
        check(torch.equal(bits, want_bits),
              f"B3 {dtype} original-stream bits differ")
        check(same_bits(torch, v, K.ref.obfuscate_ref(x, gr, want_bits, 0.05,
                                                      0.0, -1.0)),
              f"B3 {dtype} original-stream v differs")
        out[f"B3_{str(dtype)[6:]}_original_stream_bitwise"] = True
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


def phase_kernels_coupled(torch, K):
    """B4, B5 and B6 against their plain versions at m = 4, 5, 32, f32 and
    bf16; B4's W_k and B5's mask bitwise."""
    from repro_torch.core.mixing import make_mixing
    from repro_torch.core.topology import make_topology
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    cols, gcols = 1 << 22, 1 << 18
    out = {}
    for m in (4, 5, 32):
        eye = torch.eye(m, device=dev)
        mask = rand_mask(torch, m, g, dev)
        B = col_stochastic(torch, mask + eye, g)
        Wk = K.ref.metropolis_ref(mask)
        X = torch.randn(m, cols, generator=g, device=dev)
        U = torch.randn(m, cols, generator=g, device=dev)
        rec = {}
        # B4: f32 to rtol/atol 1e-5, bf16 to one bf16 ulp of the f32 result
        got = K.masked_gossip_update(mask, B, X, U)
        want = K.ref.masked_gossip_ref(mask, B, X, U)
        rec["B4_f32_max_abs_err"] = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"B4 f32 m={m} abs {rec['B4_f32_max_abs_err']}")
        Xb, Ub = X.bfloat16(), U.bfloat16()
        got16 = K.masked_gossip_update(mask, B, Xb, Ub)
        exact = K.ref.gossip_ref(Wk, B, Xb.float(), Ub.float())
        rec["B4_bf16_max_ulps"] = bf16_ulps(torch, got16, exact,
                                            gossip_scale(Wk, B, Xb, Ub))
        check(rec["B4_bf16_max_ulps"] <= 1.0,
              f"B4 bf16 m={m}: {rec['B4_bf16_max_ulps']} bf16 ulps")
        # B4's on-chip W_k: with X = [I | 0] and U = 0 the first m columns
        # of the output are W_k exactly
        Xi = torch.zeros(m, 64, device=dev)
        Xi[:, :m] = eye
        Wgot = K.masked_gossip_update(mask, B, Xi, torch.zeros_like(Xi))
        check(same_bits(torch, Wgot[:, :m].contiguous(), Wk),
              f"B4 m={m}: on-chip W_k not bitwise metropolis_from_mask")
        rec["B4_Wk_bitwise"] = True
        # B5: the exported mask bitwise MixingProcess.realize's, in dropout
        # and resample mode over several steps; the output bitwise B4's on
        # that mask and to B2's tolerance of the plain version
        top = make_topology("ring", m)
        for mode, proc in (
                ("dropout", make_mixing(top, rate=0.25, seed=7)),
                ("resample", make_mixing(top, resample_every=3,
                                         resample_p=0.5, seed=9))):
            adj = proc.mask_adj().to(dev)
            for step in range(6):
                for Xs, Us in ((X, U), (Xb, Ub)):
                    o5, mk = K.masked_gossip_update_krng(
                        proc.mask_key(step), proc.keep_prob, adj, B, Xs, Us)
                    torch.cuda.synchronize()
                    check(same_bits(torch, mk.cpu(), proc.realize_mask(step)),
                          f"B5 m={m} {mode} step {step}: mask differs from "
                          f"MixingProcess.realize")
                    check(same_bits(torch, o5, K.masked_gossip_update(
                        mk, B, Xs, Us)),
                        f"B5 m={m} {mode} step {step}: output differs from "
                        f"B4 on its mask")
            o5, _ = K.masked_gossip_update_krng(
                proc.mask_key(5), proc.keep_prob, adj, B, X, U)
            p5, _ = K.ref.masked_gossip_krng_ref(
                proc.mask_key(5), proc.keep_prob, adj, B, X, U)
            check(torch.allclose(o5, p5, rtol=1e-5, atol=1e-5),
                  f"B5 m={m} {mode}: differs from the plain version")
            rec[f"B5_{mode}_mask_bitwise"] = True
        # B6: every corrupt mode, guard clip 1e3 and none
        corrupt = torch.zeros(m)
        corrupt[1] = corrupt[m - 1] = 1.0
        for dtype in (torch.float32, torch.bfloat16):
            Xg = torch.randn(m, gcols, generator=g, device=dev).to(dtype)
            Ug = torch.randn(m, gcols, generator=g, device=dev).to(dtype)
            for cmode in ("nan", "inf", "scale"):
                XT = K.ref.poison_transmit(Xg, corrupt, cmode, 1e4)
                UT = K.ref.poison_transmit(Ug, corrupt, cmode, 1e4)
                for clip in (1e3, None):
                    what = f"m={m} {str(dtype)[6:]} {cmode} clip={clip}"
                    got = K.guarded_gossip_update(
                        mask, B, Xg, Ug, clip=clip, corrupt=corrupt,
                        mode=cmode, scale=1e4)
                    check(same_values(torch, got, K.guarded_gossip_update(
                        mask, B, Xg, Ug, XT, UT, clip)),
                        f"B6 {what}: in-register transmits differ from "
                        f"staged ones")
                    want = K.ref.guarded_gossip_ref(mask, B, Xg, Ug, XT, UT,
                                                    clip)
                    exact = K.ref.guarded_gossip_ref(
                        mask, B, Xg.float(), Ug.float(), XT.float(),
                        UT.float(), clip)
                    err, ulps = guarded_check(torch, K, got, want, exact,
                                              mask, B, Xg, Ug, XT, UT, clip,
                                              what)
                    rec[f"B6_{str(dtype)[6:]}_{cmode}_clip{clip}"] = {
                        "max_abs_err": err, "max_bf16_ulps": ulps,
                        "nonfinite": int((~torch.isfinite(got)).sum())}
        out[f"m{m}"] = rec
    emit({"phase": "kernel_coupled", "shape_B4_B5": [None, cols],
          "shape_B6": [None, gcols],
          "tolerances": {
              "B4_f32": "rtol 1e-5 atol 1e-5", "B4_bf16": "1 bf16 ulp",
              "B4_Wk": "bitwise", "B5_mask": "bitwise",
              "B5_out": "bitwise B4 on its mask",
              "B6": "nan/inf positions exact; finite: f32 1e-5 (1 + S), "
                    "bf16 1 bf16 ulp + 1e-6 S, S = sum of |terms|"},
          "results": out})


RING_TORI = ((2, 1), (4, 1), (5, 1), (32, 1), (4, 2))
# (leaf sizes, columns) that stress B9's per-tile leaf lookup (a warp's
# tile is 32 VEC columns: 128, 64 or 32 as m <= 4, 8, 32): boundaries
# inside tiles, a leaf of many tiles, one-column leaves, padding starting
# inside a tile, columns no multiple of any tile
RING_LEAF_LAYOUTS = {
    "boundary_in_tile": ([200, 3000, 56, 700], 3960),
    "long_leaf": ([128 * 40 + 40, 8], 5176),
    "one_column": ([1] * 40 + [100], 144),
    "padding": ([1000], 1536),
    "ragged_n": ([600, 560], 1160),
}


def phase_kernels_ring(torch, K, prng):
    """B7, B8 and B9 bitwise against their plain versions on the card, f32
    and bf16, on rings of m = 2, 4, 5, 32 (ndirs 1, 2, 2, 2) and the (4, 2)
    torus (ndirs 3): the capture streams, the output with capture off, a
    dropped direction's v exactly 0, a nan planted in one sender's g at
    the plain version's positions, B9's exported bits = `prng.leaf_bits`
    and B9 = B8 on them; then, on every ring and torus, B9 over
    RING_LEAF_LAYOUTS: bits = `prng.leaf_bits`, output = B8's on them, and
    the same written over X."""
    from repro_torch.dist import collectives as C
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    cols = 1 << 20
    sizes = [300_003, 5, 524_288, 77, 99_999, 1]
    offsets = torch.tensor([0, *itertools.accumulate(sizes)],
                           dtype=torch.int64)
    out = {}
    for n_data, n_pod in RING_TORI:
        m = n_data * n_pod
        P = C.perm_stack(n_data, n_pod)
        src = C.source_table(n_data, n_pod)
        Pd = P.to(dev)
        nd = P.shape[0]
        w = torch.rand(m, 1 + nd, generator=g, device=dev)
        b = C.mask_b_draws(torch.rand(m, 1 + nd, generator=g, device=dev),
                           torch.ones(m, nd, device=dev))
        # direction 0 dropped: its weight folded into the self term, b
        # renormalized onto the other directions
        keep = torch.ones(m, nd, device=dev)
        keep[:, 0] = 0.0
        b_drop = C.mask_b_draws(b, keep)
        w_drop = w.clone()
        w_drop[:, 0] += w_drop[:, 1]
        w_drop[:, 1] = 0.0
        keys = torch.stack([prng.split(prng.fold_in(prng.key(m), a),
                                       len(sizes)) for a in range(m)])
        bits = prng.leaf_bits(keys.to(dev), offsets, m, cols)
        rec = {}
        for dtype in (torch.float32, torch.bfloat16):
            X = torch.randn(m, cols, generator=g, device=dev).to(dtype)
            U = torch.randn(m, cols, generator=g, device=dev).to(dtype)
            G = torch.randn(m, cols, generator=g, device=dev).to(dtype)
            what = f"{n_data}x{n_pod} {str(dtype)[6:]}"
            # B7
            o7, v7 = K.ring_gossip_update(w, b, P, X, U, capture=True)
            p7 = K.ref.ring_gossip_ref(w, b, Pd, X, U)
            check(same_bits(torch, o7, p7[0]) and same_bits(torch, v7, p7[1]),
                  f"B7 {what}: differs from the plain version")
            check(same_bits(torch, K.ring_gossip_update(w, b, src, X, U), o7),
                  f"B7 {what}: capture changes the output")
            od, vd = K.ring_gossip_update(w_drop, b_drop, src, X, U,
                                          capture=True)
            check(bool((vd[0] == 0).all()) and bool((vd[1:] != 0).any()
                                                     or nd == 1),
                  f"B7 {what}: a dropped direction's v is not exactly 0")
            check(same_bits(torch, od, K.ref.ring_gossip_ref(
                w_drop, b_drop, Pd, X, U)[0]),
                f"B7 {what}: dropped direction differs from the plain "
                f"version")
            # B8, with a nan planted in one sender's g
            o8, v8, u8 = K.ring_obfuscate_gossip(w, b, src, X, G, bits, 0.05,
                                                 capture=True)
            p8 = K.ref.ring_obfuscate_gossip_ref(w, b, Pd, X, G, bits, 0.05)
            check(all(same_bits(torch, a, c) for a, c in zip((o8, v8, u8),
                                                             p8)),
                  f"B8 {what}: differs from the plain version")
            check(same_bits(torch, K.ring_obfuscate_gossip(
                w, b, P, X, G, bits, 0.05), o8),
                f"B8 {what}: capture changes the output")
            Gn = G.clone()
            Gn[m - 1, 4099] = float("nan")
            on = K.ring_obfuscate_gossip(w, b, src, X, Gn, bits, 0.05)
            pn = K.ref.ring_obfuscate_gossip_ref(w, b, Pd, X, Gn, bits,
                                                 0.05)[0]
            check(same_values(torch, on.float(), pn.float())
                  and bool(torch.isnan(on[:, 4099]).all()),
                  f"B8 {what}: a planted nan reaches other positions than "
                  f"in the plain version")
            # B9: its bits are leaf_bits, its output B8's on them
            o9, v9, u9, b9 = K.ring_obfuscate_gossip_krng(
                w, b, src, X, G, keys, offsets, 0.05, capture=True,
                export_bits=True)
            check(torch.equal(b9, bits), f"B9 {what}: bits differ from "
                                         f"prng.leaf_bits")
            check(all(same_bits(torch, a, c) for a, c in zip(
                (o9, v9, u9), (o8, v8, u8))),
                f"B9 {what}: differs from B8 on its bits")
            check(same_bits(torch, K.ring_obfuscate_gossip_krng(
                w, b, src, X, G, keys, offsets, 0.05), o8),
                f"B9 {what}: capture changes the output")
            rec[str(dtype)[6:]] = {"bitwise": True, "nan_positions": int(
                torch.isnan(on).sum())}
        out[f"{n_data}x{n_pod}"] = {"m": m, "ndirs": nd, **rec}
    layouts = {}
    for name, (lsizes, lcols) in RING_LEAF_LAYOUTS.items():
        for n_data, n_pod in RING_TORI:
            m = n_data * n_pod
            src = C.source_table(n_data, n_pod)
            nd = src.shape[0]
            w = torch.rand(m, 1 + nd, generator=g, device=dev)
            b = torch.rand(m, 1 + nd, generator=g, device=dev)
            loff = torch.tensor([0, *itertools.accumulate(lsizes)],
                                dtype=torch.int64)
            keys = torch.stack([prng.split(prng.fold_in(prng.key(m + 7), a),
                                           len(lsizes)) for a in range(m)])
            bits = prng.leaf_bits(keys.to(dev), loff, m, lcols)
            for dtype in (torch.float32, torch.bfloat16):
                X = torch.randn(m, lcols, generator=g, device=dev).to(dtype)
                G = torch.randn(m, lcols, generator=g, device=dev).to(dtype)
                what = f"{name} {n_data}x{n_pod} {str(dtype)[6:]}"
                o9, b9 = K.ring_obfuscate_gossip_krng(
                    w, b, src, X, G, keys, loff, 0.05, export_bits=True)
                o8 = K.ring_obfuscate_gossip(w, b, src, X, G, bits, 0.05)
                check(torch.equal(b9, bits), f"B9 {what}: bits differ from "
                                             f"prng.leaf_bits")
                check(same_bits(torch, o9, o8), f"B9 {what}: differs from "
                                                f"B8 on its bits")
                Xi = X.clone()
                K.ring_obfuscate_gossip_krng(w, b, src, Xi, G, keys, loff,
                                             0.05, out=Xi)
                check(same_bits(torch, Xi, o8), f"B9 {what}: in place "
                                                f"differs")
        layouts[name] = {"cols": lcols, "leaves": len(lsizes),
                         "bitwise": True}
    emit({"phase": "kernel_ring", "cols": cols, "leaf_sizes": sizes,
          "tolerances": {"B7": "bitwise", "B8": "bitwise (nan positions "
                         "exact)", "B9": "bitwise, bits = prng.leaf_bits, "
                         "= B8 on its bits"},
          "results": out, "b9_leaf_layouts": layouts})


# 127, 129, 255, 257: both sides of B10's 128-row tile edges
ATTN_SEQS = (1, 7, 127, 128, 129, 130, 255, 257, 2000)
# 8 and 40: hd padded to a multiple of 16 on the tensor-core path; 80 one
# 128-byte and one 32-byte box; 128 two 128-byte boxes
ATTN_HEAD_DIMS = (8, 16, 32, 40, 64, 80, 128)
# (causal, window): the three modes the serve path and the reference's
# sweep use, and a non-causal window (tiles whose rows are all masked)
ATTN_MODES = ((True, None), (True, 256), (False, None), (False, 100))
# the serve path's prefill attention: (1, prompt 2000, 32 heads, 80) bf16
SERVE_ATTN_SHAPE = (1, 2000, 32, 80)
# grouped-query prefill through models.transformer._attn: granite-8b's
# heads (H = 32 query, KV = 8, hd = 128)
GQA_HEADS = (32, 8, 128)
GQA_SEQS = (130, 2000)


def attn_tolerance(torch, dtype, S: int) -> float:
    """B10 against its plain version: the reference's sweep tolerance
    (tests/test_kernels.py:31), atol = rtol = 2e-6 in f32 (1e-5 at S =
    2000, where the sums run over 2000 keys in another order) and 2e-2 in
    bf16 (the plain version rounds its logits to bf16, the kernel keeps
    its scores in f32)."""
    if dtype == torch.float32:
        return 1e-5 if S >= 2000 else 2e-6
    return 2e-2


def attn_bound(B: int, S: int, H: int, hd: int, elem: int, causal: bool,
               window):
    """(bytes, FLOPs) B10 must move and do: q, k, v read once and o written
    once; 4 hd FLOPs (q.k and p.v) per unmasked (query, key) pair."""
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        pairs += hi - lo
    return 4 * B * S * H * hd * elem, 4 * hd * H * B * pairs


def phase_kernel_attention(torch, K):
    """B10 flash_attention against ref.flash_attention_ref, f32 and bf16,
    over S x hd x mode; then timed at the serve path's shape with its plain
    version and scaled_dot_product_attention (the library call, timed only),
    and B10's and models.common.attention's bf16 error against f32 on the
    same bf16 inputs."""
    from repro_torch.models.common import attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    worst = {}
    n_cases = 0
    for S, hd, (causal, window), dtype in itertools.product(
            ATTN_SEQS, ATTN_HEAD_DIMS, ATTN_MODES,
            (torch.float32, torch.bfloat16)):
        B, H = 2, 2
        q, k, v = (torch.randn(B, S, H, hd, generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        got = K.flash_attention(q, k, v, causal=causal, window=window)
        want = K.ref.flash_attention_ref(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        tol = attn_tolerance(torch, dtype, S)
        diff = (got.float() - want.float()).abs()
        ratio = float((diff / (tol + tol * want.float().abs())).max())
        what = (f"B10 {str(dtype)[6:]} S={S} hd={hd} causal={causal} "
                f"window={window}")
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        check(ratio <= 1.0, f"{what}: max abs {float(diff.max())}, "
                            f"{ratio} of the tolerance")
        key = str(dtype)[6:]
        w = worst.setdefault(key, {"max_abs_err": 0.0, "max_tol_ratio": 0.0})
        w["max_abs_err"] = max(w["max_abs_err"], float(diff.max()))
        w["max_tol_ratio"] = max(w["max_tol_ratio"], ratio)
        if S == 2000:
            w["max_abs_err_S2000"] = max(w.get("max_abs_err_S2000", 0.0),
                                         float(diff.max()))
        n_cases += 1
    # grouped-query prefill: _attn repeats k and v to H heads for B10;
    # held against the plain grouped attention on the same inputs
    from repro_torch.models.transformer import _attn
    H, KV, hd = GQA_HEADS
    gqa = {}
    for S, dtype in itertools.product(GQA_SEQS,
                                      (torch.float32, torch.bfloat16)):
        q = torch.randn(1, S, H, hd, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(1, S, KV, hd, generator=g, device=dev).to(dtype)
                for _ in range(2))
        got = _attn(q, k, v, None)
        want = attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        tol = attn_tolerance(torch, dtype, S)
        diff = (got.float() - want.float()).abs()
        ratio = float((diff / (tol + tol * want.float().abs())).max())
        what = f"GQA _attn {str(dtype)[6:]} S={S} H={H} KV={KV} hd={hd}"
        check(got.shape == q.shape and bool(torch.isfinite(got).all()),
              f"{what}: shape or non-finite")
        check(ratio <= 1.0, f"{what}: max abs {float(diff.max())}, {ratio} "
                            f"of the tolerance")
        gqa[f"{str(dtype)[6:]} S={S}"] = {"max_abs_err": float(diff.max()),
                                          "tol_ratio": ratio}
    # the serve path's shape
    B, S, H, hd = SERVE_ATTN_SHAPE
    q, k, v = (torch.randn(B, S, H, hd, generator=g, device=dev)
               .bfloat16() for _ in range(3))
    got = K.flash_attention(q, k, v, causal=True)
    want = K.ref.flash_attention_ref(q, k, v, causal=True)
    exact = K.ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                      causal=True)
    naive = attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
          f"B10 serve shape: max abs {err}")
    vs_f32 = {"B10": float((got.float() - exact).abs().max()),
              "attention": float((naive.float() - exact).abs().max()),
              "ref": float((want.float() - exact).abs().max())}
    row = {"ms": time_ms(torch, lambda: K.flash_attention(q, k, v,
                                                          causal=True),
                         iters=20),
           "max_abs_err": err}
    row["plain_ms"] = time_ms(torch, lambda: K.ref.flash_attention_ref(
        q, k, v, causal=True), iters=5)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["library_ms"] = time_ms(torch, lambda: sdpa(qh, kh, vh,
                                                    is_causal=True),
                                iters=20)
    nbytes, flops = attn_bound(B, S, H, hd, 2, True, None)
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_TC_FLOPS * 1e3
    row["bound_ms"], row["bound_by"] = (by, "bytes") if by >= op else (
        op, "operations")
    row["bound_f32_cuda_cores_ms"] = flops / F32_FLOPS * 1e3
    row["tflops"] = flops / row["ms"] / 1e9
    row["library_tflops"] = flops / row["library_ms"] / 1e9
    row["ms_over_library"] = row["ms"] / row["library_ms"]
    emit({"phase": "kernel_attention", "cases": n_cases,
          "seqs": ATTN_SEQS, "head_dims": ATTN_HEAD_DIMS,
          "modes": [list(m) for m in ATTN_MODES],
          "tolerance": "allclose atol = rtol = 2e-6 f32 (1e-5 at S=2000), "
                       "2e-2 bf16, vs ref.flash_attention_ref",
          "results": worst, "gqa_heads": list(GQA_HEADS),
          "gqa_vs_attention": gqa, "serve_shape": list(SERVE_ATTN_SHAPE),
          "serve_shape_bf16_max_abs_err_vs_f32": vs_f32,
          "serve_shape_flops": flops, "serve_shape_bytes": nbytes,
          "B10": row})
    return row


# B11 (G, Q, H, P, N): the reference sweep (tests/test_kernels.py:67-68);
# xlstm-125m's mLSTM with its heads folded into G (H = 1, N = 384): the
# memory (P = 384) and normalizer (P = 1) calls at Q = 1 (decode), 7 and
# 52 (short prompts) and 64 (full chunks); zamba2-7b's native Mamba2 form
# (112 heads, P = N = 64, B and C shared)
SSD_SHAPES = ((2, 64, 2, 8, 16), (4, 32, 3, 16, 8), (1, 128, 1, 4, 32),
              *((16, Q, 1, P, 384) for P in (384, 1) for Q in (1, 7, 52, 64)),
              (4, 64, 112, 64, 64),
              # both sides of the decode route's Q < 16 and of the tensor
              # cores' padded chunk (16, 32, 64, 128); P and N past a tile
              # (vector staging), then odd ones (element staging)
              *((3, Q, 2, 72, 80) for Q in (2, 15, 16, 17, 63, 65, 127)),
              (2, 33, 1, 5, 13), (2, 9, 3, 37, 261))
# the xLSTM serve prefill's memory call: a 500-token prompt padded to 8
# chunks of 64, 4 heads folded: G = 32, P = N = 384
SSD_SERVE_SHAPE = (32, 64, 1, 384, 384)
# every shape the xLSTM paths give B11 (G, Q, H, P, N): each mLSTM block
# makes a memory call (P = 384) and a normalizer call (P = 1); training
# folds per-agent batch 2 x 2 chunks x 4 heads, a prefill 8 chunks x 4
# heads, a decode step 8 slots x 4 heads at Q = 1
SSD_PATH_SHAPES = {
    f"{path} {call}": (G, Q, 1, P, 384)
    for path, G, Q in (("train", 16, 64), ("prefill", 32, 64),
                       ("decode", 32, 1))
    for call, P in (("memory", 384), ("normalizer", 1))}
BF16_U = 2.0 ** -8  # bf16's unit roundoff


def ssd_inputs(torch, shape, dtype, g, dev):
    """x, dt, a_cum, Bm, Cm as the reference sweep draws them: dt = |z| / 2,
    a_cum the within-chunk cumsum of dt A with A < 0."""
    G, Q, H, P, N = shape
    x = torch.randn(G, Q, H, P, generator=g, device=dev).to(dtype)
    dt = torch.randn(G, Q, H, generator=g, device=dev).abs() * 0.5
    A = -torch.randn(H, generator=g, device=dev).abs()
    a_cum = torch.cumsum(dt * A, dim=1)
    Bm, Cm = (torch.randn(G, Q, N, generator=g, device=dev).to(dtype)
              for _ in range(2))
    return x, dt, a_cum, Bm, Cm


def ssd_bound(G: int, Q: int, H: int, P: int, N: int, elem: int):
    """(bytes, FLOPs) B11 must move and do: x, Bm, Cm (elem bytes), dt and
    a_cum (f32) read once, y (elem) and the f32 states written once; the
    scores over the causal pairs 2 N Q(Q+1)/2 a chunk, y 2 H P Q(Q+1)/2,
    the states 2 Q H P N."""
    nbytes = (G * Q * H * P * elem * 2 + 2 * G * Q * N * elem
              + 2 * G * Q * H * 4 + G * H * P * N * 4)
    pairs = Q * (Q + 1) // 2
    flops = G * (2 * N * pairs + 2 * H * P * pairs + 2 * Q * H * P * N)
    return nbytes, flops


def ssd_tc_bound(nbytes: float, flops: float) -> tuple[float, str]:
    """B11's bound on tensor cores: its bytes over the memory rate or its
    FLOPs over the dense bf16 tensor-core rate, whichever is larger."""
    by = nbytes / HBM_BYTES_PER_S * 1e3
    op = flops / BF16_TC_FLOPS * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def phase_kernel_ssd(torch, K):
    """B11 ssd_intra_chunk against ref.ssd_intra_chunk_ref over SSD_SHAPES,
    f32 and bf16, each tolerance taken relative to ``mag``, the plain
    version on |x|, |Bm|, |Cm| (the sum of the absolute terms): f32
    |B11 - plain| <= 1e-5 (1 + mag); bf16 held against the f32 computation
    on the same bf16 inputs (``exact``): B11's y within one bf16 rounding,
    2^-8 |exact| + 1e-5 (1 + mag), its f32 states within 1e-5 (1 + mag);
    the plain version's y within 2^-7 mag + 2^-8 |exact| + 1e-5 (1 + mag)
    (it rounds the scores and the weights to bf16 too).  Then the autograd
    Function's gradients (B11 forward, the plain version's backward)
    against autograd through the plain version, f32, atol = rtol = 1e-6;
    then B11 timed at the xLSTM serve prefill's memory call, bf16 (and f32,
    the dtype of the blocks after the first), beside its plain version, and
    at each shape the xLSTM paths give it: device time from a CUDA graph of
    50 calls replayed (`device_ms`), the host's microseconds a call beside
    it, and the eager CUDA-event time (``events_ms``, which at a few
    microseconds of device time measures the host's dispatch)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    plain = K.ref.ssd_intra_chunk_ref
    worst: dict = {}
    n_cases = 0

    def ratio(err, bound):
        return float((err / bound).max())

    for shape, dtype in itertools.product(SSD_SHAPES,
                                          (torch.float32, torch.bfloat16)):
        x, dt, a_cum, Bm, Cm = ssd_inputs(torch, shape, dtype, g, dev)
        y, s = K.ssd_intra_chunk(x, dt, a_cum, Bm, Cm)
        y_p, s_p = plain(x, dt, a_cum, Bm, Cm)
        ex_y, ex_s = plain(x.float(), dt, a_cum, Bm.float(), Cm.float())
        mag_y, mag_s = plain(x.float().abs(), dt, a_cum, Bm.float().abs(),
                             Cm.float().abs())
        torch.cuda.synchronize()
        what = f"B11 {str(dtype)[6:]} (G, Q, H, P, N) = {shape}"
        check(y.shape == x.shape and y.dtype == dtype
              and s.shape == (shape[0], shape[2], shape[3], shape[4])
              and s.dtype == torch.float32, f"{what}: output shapes")
        check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()),
              f"{what}: non-finite")
        tol_y, tol_s = 1e-5 * (1 + mag_y), 1e-5 * (1 + mag_s)
        err_y = (y.float() - y_p.float()).abs()
        err_s = (s - s_p).abs()
        if dtype == torch.float32:
            r = {"y": ratio(err_y, tol_y), "states": ratio(err_s, tol_s)}
        else:
            r = {"y_vs_f32": ratio((y.float() - ex_y).abs(),
                                   BF16_U * ex_y.abs() + tol_y),
                 "states_vs_f32": ratio((s - ex_s).abs(), tol_s),
                 "plain_y_vs_f32": ratio(
                     (y_p.float() - ex_y).abs(),
                     2 * BF16_U * mag_y + BF16_U * ex_y.abs() + tol_y)}
        check(max(r.values()) <= 1.0, f"{what}: {r} of the tolerance")
        w = worst.setdefault(str(dtype)[6:], {"max_abs_err_y": 0.0,
                                              "max_abs_err_states": 0.0})
        w["max_abs_err_y"] = max(w["max_abs_err_y"], float(err_y.max()))
        w["max_abs_err_states"] = max(w["max_abs_err_states"],
                                      float(err_s.max()))
        for k, v in r.items():
            w[f"max_tol_ratio_{k}"] = max(w.get(f"max_tol_ratio_{k}", 0.0),
                                          v)
        n_cases += 1
    # training: the Function's backward is autograd through the plain
    # version recomputed from the saved inputs
    grads_err = {}
    for shape in ((4, 64, 1, 48, 48), (2, 64, 2, 8, 16)):
        ins = ssd_inputs(torch, shape, torch.float32, g, dev)
        gy = torch.randn(shape[:4], generator=g, device=dev)
        gs = torch.randn((shape[0], shape[2], shape[3], shape[4]),
                         generator=g, device=dev)
        got, want = [], []
        for fn, out in ((K.ssd_intra_chunk, got), (plain, want)):
            leaves = [t.clone().requires_grad_() for t in ins]
            out.extend(torch.autograd.grad(fn(*leaves), leaves, (gy, gs)))
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        check(all(torch.allclose(a, b, atol=1e-6, rtol=1e-6)
                  for a, b in zip(got, want)),
              f"B11 gradients at {shape}: {errs}")
        grads_err[str(shape)] = max(errs)
    # timed at the serve prefill's memory call
    G, Q, H, P, N = SSD_SERVE_SHAPE
    x, dt, a_cum, Bm, Cm = ssd_inputs(torch, SSD_SERVE_SHAPE, torch.bfloat16,
                                      g, dev)
    y, s = K.ssd_intra_chunk(x, dt, a_cum, Bm, Cm)
    y_p, s_p = plain(x, dt, a_cum, Bm, Cm)
    torch.cuda.synchronize()
    timed = device_ms(torch, lambda: K.ssd_intra_chunk(x, dt, a_cum, Bm,
                                                       Cm))
    row = {"ms": timed["device_ms"], "host_us": timed["host_us"],
           "max_abs_err": max(float((y.float() - y_p.float()).abs().max()),
                              float((s - s_p).abs().max())),
           "plain_ms": time_ms(torch, lambda: plain(x, dt, a_cum, Bm, Cm),
                               iters=10),
           "library_ms": None}
    x32, B32, C32 = x.float(), Bm.float(), Cm.float()
    timed = device_ms(torch, lambda: K.ssd_intra_chunk(x32, dt, a_cum, B32,
                                                       C32))
    row["ms_f32"], row["host_us_f32"] = timed["device_ms"], timed["host_us"]
    row["plain_ms_f32"] = time_ms(torch, lambda: plain(x32, dt, a_cum, B32,
                                                       C32), iters=10)
    nbytes, flops = ssd_bound(G, Q, H, P, N, 2)
    row["bound_ms"], row["bound_by"] = ssd_tc_bound(nbytes, flops)
    row["bound_f32_fma_ms"] = bound_ms(nbytes, flops)[0]
    nbytes32, _ = ssd_bound(G, Q, H, P, N, 4)
    row["bound_f32_ms"] = ssd_tc_bound(nbytes32, flops)[0]
    # by shape: each call the xLSTM paths make, beside its own bound
    by_shape = {}
    for name, shape in SSD_PATH_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            ins = ssd_inputs(torch, shape, dtype, g, dev)
            nb, fl = ssd_bound(*shape, 4 if dtype == torch.float32 else 2)
            bms, bby = ssd_tc_bound(nb, fl)
            timed = device_ms(torch, lambda: K.ssd_intra_chunk(*ins))
            by_shape[f"{name} {str(dtype)[6:]}"] = {
                "shape": list(shape), "ms": timed["device_ms"],
                "host_us": timed["host_us"],
                "events_ms": time_ms(torch, lambda: K.ssd_intra_chunk(*ins),
                                     iters=50),
                "bound_ms": bms, "bound_by": bby,
                "bound_f32_fma_ms": bound_ms(nb, fl)[0]}
    row["by_shape"] = by_shape
    emit({"phase": "kernel_ssd", "cases": n_cases,
          "shapes": [list(t) for t in SSD_SHAPES],
          "tolerance": "relative to mag (plain version on |x|, |B|, |C|): "
                       "f32 1e-5 (1 + mag); bf16 vs f32 on the same inputs: "
                       "y 2^-8 |exact| + 1e-5 (1 + mag), states 1e-5 (1 + "
                       "mag), plain y 2^-7 mag + 2^-8 |exact| + 1e-5 (1 + "
                       "mag); gradients atol = rtol = 1e-6",
          "results": worst, "grad_max_abs_err": grads_err,
          "serve_shape": list(SSD_SERVE_SHAPE), "serve_shape_flops": flops,
          "serve_shape_bytes": nbytes, "B11": row,
          "library": "none: no single PyTorch call computes the SSD "
                     "intra-chunk block"})
    return row


PARITY_RUNS = (("pdsgd", ()), ("dsgd", ("--algorithm", "dsgd")),
               ("dsgt", ("--algorithm", "dsgt")),
               ("dp_dsgd", ("--algorithm", "dp_dsgd", "--sigma-dp", "0.01")),
               ("pdsgd_clip", ("--grad-clip-kappa", "0.05")))


def phase_step_parity(torch, train):
    """2 steps of stablelm-3b-smoke (f32) through run_training on the card
    (kernels) and on the CPU (plain versions), same weights and batches,
    for PDSGD, each baseline and the clip.  Tolerance: losses rtol 1e-5;
    params atol 1e-3 + rtol 1e-4 — the smoke model's 0.02-scale embeddings
    under LayerNorm amplify the first step's summation-order difference
    (as on the CPU against the reference, tests/test_torch_train.py)."""
    from repro_torch.core.privacy import tree_leaves
    from repro_torch.models import build_model
    from repro_torch.configs import get_config
    cfg = get_config("stablelm-3b-smoke")
    gen = torch.Generator()
    gen.manual_seed(5)
    p0 = build_model(cfg).init(gen, "cpu")
    for name, extra in PARITY_RUNS:
        flags = ["--arch", "stablelm-3b-smoke", "--agents", "4", "--steps",
                 "2", "--log-every", "1", "--seq-len", "64", "--seed", "5",
                 *extra]
        gpu = train.run_training(train.build_parser().parse_args(
            flags + ["--device", "cuda"]), init_params=p0)
        cpu = train.run_training(train.build_parser().parse_args(
            flags + ["--device", "cpu"]), init_params=p0)
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(gpu["history"], cpu["history"]))
        check(loss_rel <= 1e-5, f"step_parity {name} loss rel {loss_rel}")
        max_abs = 0.0
        for a, b in zip(tree_leaves(gpu["state"].params),
                        tree_leaves(cpu["state"].params)):
            a = a.cpu()
            max_abs = max(max_abs, float((a - b).abs().max()))
            check(torch.allclose(a, b, atol=1e-3, rtol=1e-4),
                  f"step_parity {name} params")
        emit({"phase": "step_parity", "run": name, "flags": list(extra),
              "arch": "stablelm-3b-smoke", "dtype": "float32", "agents": 4,
              "steps": 2,
              "losses_gpu": [r["loss"] for r in gpu["history"]],
              "losses_cpu": [r["loss"] for r in cpu["history"]],
              "max_loss_rel_err": loss_rel, "max_param_abs_err": max_abs,
              "tolerance": "loss rtol 1e-5; params atol 1e-3 + rtol 1e-4"})


def _chunks(n: int, size: int = 1 << 24):
    for s in range(0, n, size):
        yield s, min(n, s + size)


def _plain_ms(torch, fn, width: int) -> float:
    """Host time of ``fn(s, e)`` over every column chunk, synchronized."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s, e in _chunks(width):
        fn(s, e)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def _path_args(train, steps: int, extra=(), seq_len: int = 512):
    return train.build_parser().parse_args(
        ["--agents", "4", "--topology", "ring", "--per-agent-batch", "2",
         "--seq-len", str(seq_len), "--steps", str(steps), "--log-every",
         "1", "--lr", "0.4", "--warmup-hold", "200", "--seed", "0",
         "--device", "cuda", *extra])


def _run_path(torch, K, train, cfg, steps: int, kernel_rng: bool,
              extra=(), seq_len: int = 512, held: bool = False):
    """run_training with the launch counts set to 0 just before it.  The
    counts returned are read just after it.  Earlier phases' buffers are
    collected first, so the peak is this run's; with ``held`` the caller
    keeps an earlier run's state for a comparison, and the peak returned
    is this run's above what was allocated before it."""
    args = _path_args(train, steps, extra, seq_len)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    check(held or base < 1 << 30,
          f"{base} B still allocated before a path")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.run_training(args, cfg=cfg, kernel_rng=kernel_rng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    peak = torch.cuda.max_memory_allocated() - (base if held else 0)
    return res, counts, wall, peak


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
    b3["plain_ms"] = _plain_ms(torch, lambda s, e: K.ref.obfuscate_ref(
        X[:, s:e], G[:, s:e],
        prng.leaf_bits(kd, offsets, m, width, start=s, stop=e), lam, 0.0,
        -1.0), width)
    b3["bound_ms"], b3["bound_by"] = bound_ms(n * 6, n * 5,
                                              n * THREEFRY_INT_OPS)
    b3["bound_bytes_ms"] = bound_ms(n * 6)[0]
    b3["bound_int_ms"] = n * THREEFRY_INT_OPS / INT32_OPS * 1e3
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
    b2["plain_ms"] = _plain_ms(torch, lambda s, e: K.ref.gossip_ref(
        W, B, X[:, s:e], V[:, s:e]), width)
    Wb, Bb = W.bfloat16(), B.bfloat16()
    b2["library_ms"] = time_ms(torch, lambda: Wb @ X - Bb @ V, iters=5)
    b2["bound_ms"], b2["bound_by"] = bound_ms(n * 6, width * 4 * m * m)
    emit({"phase": "main_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B3": b3, "B2": b2})
    del G, V, Xn
    return {"obfuscate_update_krng": (counts, b3),
            "gossip_update": (counts, b2)}


def _step_records(res):
    return [r for r in res["history"] if "loss" in r]


DROPOUT_FLAGS = ("--topology-dropout", "0.25")


def phase_dropout_path(torch, K, train, prng, cfg):
    """The trainer with link dropout (B3 + B4 every step), then one update
    through ``fused_pdsgd_flat(mask_key=...)`` on its buffers (B5: the mask
    of the next step drawn in-kernel).  The launch counts cover both."""
    from repro_torch.core.mixing import metropolis_from_mask
    from repro_torch.core.pdsgd import lambda_key_table
    from repro_torch.core.privacy import agent_key, sample_B
    steps = 7
    extra = DROPOUT_FLAGS
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        extra)
    hist = _step_records(res)
    losses = [r["loss"] for r in hist]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    mixing = train.build_mixing(_path_args(train, steps, extra))
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(_finite_flat(torch, X), "non-finite parameters")
    check(counts.get("obfuscate_update_krng", 0) == steps
          and counts.get("masked_gossip_update", 0) == steps
          and counts.get("gossip_update", 0) == 0,
          f"dropout-path launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    # step `steps`'s update with its mask drawn in the kernel
    k = steps
    dev = X.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    G = torch.randn(X.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    G[:, state.layout.size:] = 0
    key_k = prng.fold_in(prng.key(1), k)
    mask_k = mixing.realize_mask(k)
    support = (mask_k + torch.eye(m)).to(dev)
    B = sample_B(agent_key(prng.fold_in(key_k, 2), k, 0), support)
    lam = torch.tensor(0.01, device=dev)
    X5, U5 = K.fused_pdsgd_flat(
        metropolis_from_mask(mask_k).to(dev), B, X, G, lam,
        keys=lambda_key_table(key_k, k, m, state.layout.n_leaves),
        offsets=torch.tensor(state.layout.offsets, dtype=torch.int64),
        mask_key=mixing.mask_key(k), mask_keep_prob=mixing.keep_prob,
        mask_adj=mixing.mask_adj())
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    check(counts.get("masked_gossip_update_krng", 0) == 1,
          f"dropout-path launches {counts}")
    del G
    edges = [int(mixing.realize_mask(i).sum()) // 2 for i in range(steps)]
    emit({"phase": "dropout_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "agents": m, "topology": "ring",
          "dropout": 0.25, "per_agent_batch": 2, "seq_len": 512,
          "params_per_agent": state.layout.size, "width": width,
          "losses": losses, "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "edges_per_step": edges,
          "base_edges": int(mixing.base_mask.sum()) // 2,
          "b_window": [{key: r[key] for key in r
                        if key.startswith("b_window")} for r in hist],
          "launches": counts})

    # B5 vs the realized mask and vs B4, then both timed at this shape
    adj = mixing.mask_adj().to(dev)
    Y, mask5 = K.masked_gossip_update_krng(mixing.mask_key(k),
                                           mixing.keep_prob, adj, B, X, U5)
    torch.cuda.synchronize()
    check(same_bits(torch, mask5.cpu(), mask_k),
          "B5 main-path shape: exported mask differs from "
          "MixingProcess.realize")
    check(same_bits(torch, Y, X5), "B5 differs between two launches")
    K.masked_gossip_update(mask5, B, X, U5, out=Y)
    check(same_bits(torch, Y, X5),
          "B5 main-path shape: output differs from B4 on its mask")
    Wk = K.ref.metropolis_ref(mask5)
    ulps = err4 = err5 = 0.0
    for s, e in _chunks(width):
        exact = Wk @ X[:, s:e].float() - B @ U5[:, s:e].float()
        ulps = max(ulps, bf16_ulps(torch, Y[:, s:e], exact, gossip_scale(
            Wk, B, X[:, s:e], U5[:, s:e])))
        p4 = K.ref.masked_gossip_ref(mask5, B, X[:, s:e], U5[:, s:e])
        err4 = max(err4, float((Y[:, s:e].float() - p4.float()).abs().max()))
        p5, _ = K.ref.masked_gossip_krng_ref(mixing.mask_key(k),
                                             mixing.keep_prob, adj, B,
                                             X[:, s:e], U5[:, s:e])
        err5 = max(err5, float((X5[:, s:e].float() - p5.float())
                               .abs().max()))
    check(ulps <= 1.0, f"B4 main-path shape: {ulps} bf16 ulps")
    n = m * width
    bound = bound_ms(n * 6, width * 4 * m * m)
    b4 = {"ms": time_ms(torch, lambda: K.masked_gossip_update(
              mask5, B, X, U5, out=Y), iters=10),
          "max_abs_err": err4, "max_bf16_ulps_vs_f32": ulps,
          "plain_ms": _plain_ms(torch, lambda s, e: K.ref.masked_gossip_ref(
              mask5, B, X[:, s:e], U5[:, s:e]), width),
          "bound_ms": bound[0], "bound_by": bound[1]}
    Bb = B.bfloat16()
    b4["library_ms"] = time_ms(
        torch, lambda: metropolis_from_mask(mask5).bfloat16() @ X - Bb @ U5,
        iters=5)
    key5 = mixing.mask_key(k)
    # B5 draws one threefry word per undirected edge
    draws = m * (m - 1) // 2
    bound5 = bound_ms(n * 6, width * 4 * m * m, draws * THREEFRY_INT_OPS)
    b5 = {"ms": time_ms(torch, lambda: K.masked_gossip_update_krng(
              key5, mixing.keep_prob, adj, B, X, U5, out=Y), iters=10),
          "max_abs_err": err5,
          "plain_ms": _plain_ms(torch, lambda s, e:
                                K.ref.masked_gossip_krng_ref(
                                    key5, mixing.keep_prob, adj, B,
                                    X[:, s:e], U5[:, s:e]), width),
          "bound_ms": bound5[0], "bound_by": bound5[1],
          "bound_int_ms": draws * THREEFRY_INT_OPS / INT32_OPS * 1e3,
          "library_ms": None}
    emit({"phase": "dropout_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B4": b4, "B5": b5})
    del X5, U5, Y
    return {"masked_gossip_update": (counts, b4),
            "masked_gossip_update_krng": (counts, b5)}


FAULT_FLAGS = ("--fault-crash-rate", "0.2", "--fault-restart-rate", "0.5",
               "--fault-corrupt-rate", "0.25", "--fault-corrupt-mode", "nan",
               "--fault-guard-clip", "1e3", "--nan-policy", "skip")


def fault_seed(train, steps: int):
    """The first fault seed whose realization over ``steps`` steps has a
    down agent and a corrupt sender, from FaultProcess.realize on the CPU:
    ``(seed, faults)``."""
    for seed in range(100):
        faults = train.build_faults(_path_args(
            train, steps, (*FAULT_FLAGS, "--fault-seed", str(seed))))
        rows = [faults.realize(k) for k in range(steps)]
        if (any(bool((a == 0).any()) for a, _ in rows)
                and any(bool(c.any()) for _, c in rows)):
            return seed, faults
    raise AssertionError("no fault seed below 100 fires in the run")


def phase_fault_path(torch, K, train, prng, cfg):
    """The trainer with Markov crash/restart, nan-corrupt senders, guard
    clip 1e3 and --nan-policy skip (B3 + B6 every step)."""
    from repro_torch.core.pdsgd import lambda_key_table
    from repro_torch.core.privacy import agent_key, sample_B
    from repro_torch.faults import guarded_gossip_mix, realize_coupling
    steps = 6
    seed, faults = fault_seed(train, steps)
    extra = (*FAULT_FLAGS, "--fault-seed", str(seed))
    realized = [{"down": int((faults.alive_at(k) == 0).sum()),
                 "corrupt": int(faults.realize(k)[1].sum()),
                 "rejoin": int(faults.rejoin_mask(k).sum())}
                for k in range(steps)]
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        extra)
    hist = _step_records(res)
    losses = [r["loss"] for r in hist]
    totals = res["fault_totals"]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(_finite_flat(torch, X), "non-finite parameters")
    check(totals.get("fault_down", 0) > 0 and totals.get("fault_corrupt", 0)
          > 0, f"fault path had no down agent or no corrupt sender: {totals}")
    check(counts.get("obfuscate_update_krng", 0) == steps
          and counts.get("guarded_gossip_update", 0) == steps
          and counts.get("masked_gossip_update", 0) == 0
          and counts.get("gossip_update", 0) == 0,
          f"fault-path launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    emit({"phase": "fault_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "agents": m, "topology": "ring",
          "flags": list(extra), "fault_seed": seed, "realized": realized,
          "fault_totals": totals, "losses": losses, "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})

    # B6 at this shape, on the realization of a step with a corrupt sender
    # (and a down agent, where one step has both)
    k = max(range(steps), key=lambda i: (realized[i]["corrupt"] > 0,
                                         realized[i]["down"] > 0, -i))
    dev = X.device
    mixing = train.build_mixing(_path_args(train, steps, extra))
    W, support, mask, alive, corrupt = realize_coupling(mixing, faults, k,
                                                        dev)
    key_k = prng.fold_in(prng.key(1), k)
    B = sample_B(agent_key(prng.fold_in(key_k, 2), k, 0), support)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    V = torch.randn(X.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    V[:, state.layout.size:] = 0
    K.obfuscate_update_krng(
        X, V, lambda_key_table(key_k, k, m, state.layout.n_leaves),
        torch.tensor(state.layout.offsets, dtype=torch.int64),
        torch.tensor(0.01, device=dev), 0.0, -1.0, out=V)
    Y = K.guarded_gossip_update(mask, B, X, V, clip=1e3, corrupt=corrupt,
                                mode="nan", scale=1e4)
    cdev = corrupt.to(dev)
    err = ulps = 0.0
    for s, e in _chunks(width):
        x, v = X[:, s:e], V[:, s:e]
        XT = K.ref.poison_transmit(x, cdev, "nan", 1e4)
        UT = K.ref.poison_transmit(v, cdev, "nan", 1e4)
        want = K.ref.guarded_gossip_ref(mask, B, x, v, XT, UT, 1e3)
        exact = K.ref.guarded_gossip_ref(mask, B, x.float(), v.float(),
                                         XT.float(), UT.float(), 1e3)
        e1, u1 = guarded_check(torch, K, Y[:, s:e], want, exact, mask, B, x,
                               v, XT, UT, 1e3,
                               f"main-path shape, columns {s}:{e}")
        err, ulps = max(err, e1), max(ulps, u1)
    n = m * width
    bound = bound_ms(n * 6, width * 7 * m * m)

    def plain(s, e):
        x, v = X[:, s:e], V[:, s:e]
        K.ref.guarded_gossip_ref(
            mask, B, x, v, K.ref.poison_transmit(x, cdev, "nan", 1e4),
            K.ref.poison_transmit(v, cdev, "nan", 1e4), 1e3)

    b6 = {"ms": time_ms(torch, lambda: K.guarded_gossip_update(
              mask, B, X, V, clip=1e3, corrupt=corrupt, mode="nan",
              scale=1e4, out=Y), iters=10),
          "max_abs_err": err, "max_bf16_ulps_vs_f32": ulps,
          "plain_ms": _plain_ms(torch, plain, width),
          "library_ms": _plain_ms(torch, lambda s, e: guarded_gossip_mix(
              W, B, X[:, s:e], V[:, s:e], cdev, mode="nan", scale=1e4,
              clip=1e3), width),
          "bound_ms": bound[0], "bound_by": bound[1],
          "step": k, "corrupt": corrupt.tolist(), "alive": alive.tolist()}
    emit({"phase": "fault_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B6": b6})
    del V, Y
    return {"guarded_gossip_update": (counts, b6)}


RING_FLAGS = ("--kernel-layout", "ring")


def phase_ring_path(torch, K, train, prng, cfg):
    """The trainer with --kernel-layout ring (B9 once a step, no B3 or B2),
    then one torus_gossip_pdsgd(None, ..., fused=True) on its buffers (B7);
    the launch counts cover both.  Then B9 and B7 against their plain
    versions at this shape, timed, and one step's ring update against the
    concat update (B3 + B2) on the same draws."""
    from repro_torch.core.pdsgd import lambda_key_table
    from repro_torch.core.privacy import agent_key, sample_B
    from repro_torch.dist import collectives as C
    steps = 7
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        RING_FLAGS)
    hist = _step_records(res)
    losses = [r["loss"] for r in hist]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"ring-path losses do not fall: {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(_finite_flat(torch, X), "non-finite parameters")
    check(counts.get("ring_obfuscate_gossip_krng", 0) == steps
          and counts.get("obfuscate_update_krng", 0) == 0
          and counts.get("gossip_update", 0) == 0,
          f"ring-path launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    # step `steps`'s draws, on this path's buffer
    k = steps
    dev = X.device
    mixing = train.build_mixing(_path_args(train, steps, RING_FLAGS))
    W, support, _ = mixing.realize(k, dev)
    key_k = prng.fold_in(prng.key(1), k)
    B = sample_B(agent_key(prng.fold_in(key_k, 2), k, 0), support)
    tabs = C.directional_weights(W, m, 1)
    w_tab = torch.cat([tabs["w_self"][:, None], tabs["w_dir"]], dim=1)
    b_tab = C.rows_from_dense(B, m, 1)
    src, P = C.source_table(m, 1), C.perm_stack(m, 1).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    G = torch.randn(X.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    G[:, state.layout.size:] = 0
    # B7 as the single-device torus gossip runs it, u given (here G)
    Y7 = C.torus_gossip_pdsgd(None, X, G, b_tab, W=W, fused=True)
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    check(counts.get("ring_gossip_update", 0) == 1,
          f"ring-path launches {counts}")
    emit({"phase": "ring_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "d_model": cfg.d_model,
          "agents": m, "topology": "ring", "flags": list(RING_FLAGS),
          "dtype": cfg.dtype, "per_agent_batch": 2, "seq_len": 512,
          "params_per_agent": state.layout.size, "width": width,
          "losses": losses, "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})

    n = m * width
    # B7 against its plain version, then timed
    for s, e in _chunks(width):
        check(same_bits(torch, Y7[:, s:e], K.ref.ring_gossip_ref(
            w_tab, b_tab, P, X[:, s:e], G[:, s:e])[0]),
            f"B7 ring-path shape differs at columns {s}:{e}")
    del Y7
    Y = torch.empty_like(X)
    b7 = {"ms": time_ms(torch, lambda: K.ring_gossip_update(
              w_tab, b_tab, src, X, G, out=Y), iters=10),
          "max_abs_err": 0.0,
          "plain_ms": _plain_ms(torch, lambda s, e: K.ref.ring_gossip_ref(
              w_tab, b_tab, P, X[:, s:e], G[:, s:e]), width)}
    Wd, Bd = C.dense_coupling(b_tab, m, 1, W=W)
    Wb, Bb = Wd.bfloat16(), Bd.bfloat16()
    b7["library_ms"] = time_ms(torch, lambda: Wb @ X - Bb @ G, iters=5)
    nd = P.shape[0]
    b7["bound_ms"], b7["bound_by"] = bound_ms(n * 6, n * (3 + 4 * nd))

    # one step's update, ring (B9) and concat (B3 + B2) on the same draws:
    # each within one bf16 ulp of the f32 result of its own u (the ring
    # keeps u in f32, the concat path rounds it to bf16 over G)
    keys = lambda_key_table(key_k, k, m, state.layout.n_leaves)
    offsets = torch.tensor(state.layout.offsets, dtype=torch.int64)
    lam = torch.tensor(0.01, device=dev)
    Xr = X.clone()
    K.ring_pdsgd_flat(w_tab, b_tab, src, Xr, G, lam, keys=keys,
                      offsets=offsets, in_place=True)
    Xc, Gc = X.clone(), G.clone()
    K.fused_pdsgd_flat(W, B, Xc, Gc, lam, keys=keys, offsets=offsets,
                       in_place=True)
    kd = keys.to(dev)
    ulps_r = ulps_c = ring_vs_concat = 0.0
    for s, e in _chunks(width):
        bits = prng.leaf_bits(kd, offsets, m, width, start=s, stop=e)
        po, _, pu = K.ref.ring_obfuscate_gossip_ref(
            w_tab, b_tab, P, X[:, s:e], G[:, s:e], bits, lam)
        check(same_bits(torch, Xr[:, s:e], po),
              f"B9 ring-path shape differs at columns {s}:{e}")
        x = X[:, s:e].float()
        exact_r = W @ x - B @ pu
        ulps_r = max(ulps_r, bf16_ulps(torch, Xr[:, s:e], exact_r,
                                       W @ x.abs() + B @ pu.abs()))
        uc = Gc[:, s:e].float()
        exact_c = W @ x - B @ uc
        ulps_c = max(ulps_c, bf16_ulps(torch, Xc[:, s:e], exact_c,
                                       W @ x.abs() + B @ uc.abs()))
        ring_vs_concat = max(ring_vs_concat, float(
            (Xr[:, s:e].float() - Xc[:, s:e].float()).abs().max()))
    check(ulps_r <= 1.0 and ulps_c <= 1.0,
          f"ring {ulps_r} / concat {ulps_c} bf16 ulps from the f32 result")
    del Xc, Gc
    b9 = {"ms": time_ms(torch, lambda: K.ring_obfuscate_gossip_krng(
              w_tab, b_tab, src, X, G, keys, offsets, lam, out=Xr),
              iters=5),
          "max_abs_err": 0.0,
          "plain_ms": _plain_ms(torch, lambda s, e:
                                K.ref.ring_obfuscate_gossip_ref(
                                    w_tab, b_tab, P, X[:, s:e], G[:, s:e],
                                    prng.leaf_bits(kd, offsets, m, width,
                                                   start=s, stop=e), lam),
                                width),
          "library_ms": None}
    b9["bound_ms"], b9["bound_by"] = bound_ms(n * 6, n * (6 + 4 * nd),
                                              n * THREEFRY_INT_OPS)
    b9["bound_bytes_ms"] = bound_ms(n * 6)[0]
    b9["bound_int_ms"] = n * THREEFRY_INT_OPS / INT32_OPS * 1e3
    # in turns with what the concat path runs for the same update: B3 (the
    # same words) and B2 (the same bytes) on these buffers, then B9 again
    V, Xn = Y, torch.empty_like(X)
    b9["b3_ms"] = time_ms(torch, lambda: K.obfuscate_update_krng(
        X, G, keys, offsets, lam, 0.0, -1.0, out=V), iters=5)
    b9["b2_ms"] = time_ms(torch, lambda: K.gossip_update(W, B, X, V, out=Xn),
                          iters=5)
    b9["ms_again"] = time_ms(torch, lambda: K.ring_obfuscate_gossip_krng(
        w_tab, b_tab, src, X, G, keys, offsets, lam, out=Xr), iters=5)
    del V, Xn
    emit({"phase": "ring_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B9": b9, "B7": b7,
          "ring_vs_concat": {"ring_max_bf16_ulps_vs_f32": ulps_r,
                             "concat_max_bf16_ulps_vs_f32": ulps_c,
                             "max_abs_diff": ring_vs_concat}})
    del G, Xr, Y
    return {"ring_obfuscate_gossip_krng": (counts, b9),
            "ring_gossip_update": (counts, b7)}


def phase_ring_bits_path(torch, K, train, prng, cfg):
    """The bits path with --kernel-layout ring: B8 every step (no B1, B2);
    B8 checked and timed at that path's shape."""
    from repro_torch.core.pdsgd import per_agent_bits
    from repro_torch.core.privacy import agent_key, sample_B
    from repro_torch.dist import collectives as C
    steps = 2
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, False,
                                        RING_FLAGS)
    hist = res["history"]
    state = res["state"]
    X = state.flat
    m, width = X.shape
    check(all(math.isfinite(r["loss"]) for r in hist), "ring bits losses")
    check(_finite_flat(torch, X), "ring bits path non-finite parameters")
    check(counts.get("ring_obfuscate_gossip", 0) == steps
          and counts.get("obfuscate_update", 0) == 0
          and counts.get("gossip_update", 0) == 0,
          f"ring bits path launches {counts}")
    emit({"phase": "ring_bits_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "agents": m,
          "losses": [r["loss"] for r in hist], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})
    k, dev = steps, X.device
    mixing = train.build_mixing(_path_args(train, steps, RING_FLAGS))
    W, support, _ = mixing.realize(k, dev)
    key_k = prng.fold_in(prng.key(1), k)
    B = sample_B(agent_key(prng.fold_in(key_k, 2), k, 0), support)
    tabs = C.directional_weights(W, m, 1)
    w_tab = torch.cat([tabs["w_self"][:, None], tabs["w_dir"]], dim=1)
    b_tab = C.rows_from_dense(B, m, 1)
    src, P = C.source_table(m, 1), C.perm_stack(m, 1).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    G = torch.randn(X.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    bits = per_agent_bits(key_k, k, state.layout, m, device=dev)
    lam = torch.tensor(0.01, device=dev)
    Y = K.ring_obfuscate_gossip(w_tab, b_tab, src, X, G, bits, lam)
    for s, e in _chunks(width):
        check(same_bits(torch, Y[:, s:e], K.ref.ring_obfuscate_gossip_ref(
            w_tab, b_tab, P, X[:, s:e], G[:, s:e], bits[:, s:e], lam)[0]),
            f"B8 ring-bits-path shape differs at columns {s}:{e}")
    n = m * width
    nd = P.shape[0]
    b8 = {"ms": time_ms(torch, lambda: K.ring_obfuscate_gossip(
              w_tab, b_tab, src, X, G, bits, lam, out=Y), iters=10),
          "max_abs_err": 0.0,
          "plain_ms": _plain_ms(torch, lambda s, e:
                                K.ref.ring_obfuscate_gossip_ref(
                                    w_tab, b_tab, P, X[:, s:e], G[:, s:e],
                                    bits[:, s:e], lam), width)}
    del Y
    Wd, Bd = C.dense_coupling(b_tab, m, 1, W=W)

    def library():
        # the same update as eager torch ops on the whole buffer
        u01 = ((bits.view(torch.int32) >> 9) & 0x7FFFFF
               | 0x3F800000).view(torch.float32) - 1.0
        u = (2.0 * lam * u01).mul_(G.float())
        return torch.addmm(Wd @ X.float(), Bd, u, alpha=-1.0).bfloat16()

    b8["library_ms"] = time_ms(torch, library, iters=3, warmup=1)
    b8["bound_ms"], b8["bound_by"] = bound_ms(n * 10, n * (6 + 4 * nd))
    emit({"phase": "ring_bits_path_kernels", "shape": [m, width],
          "dtype": "bfloat16", "B8": b8})
    del G, bits
    return {"ring_obfuscate_gossip": (counts, b8)}


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
    b1["plain_ms"] = _plain_ms(torch, lambda s, e: K.ref.obfuscate_ref(
        X[:, s:e], G[:, s:e], bits[:, s:e], lam, 0.0, -1.0), width)

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


FIG2_ITERS = 600
FIG2_UNROLL = 100
# the reference's recorded final_err_scanned of the Fig. 2 workload
# (BENCH_pdsgd.json), drawn from jax's earlier threefry stream
NORTH_STAR = 0.07891825798133546
SCANNED_UNROLL = 4
SCANNED_STEPS = 12  # a warm-up chunk, then two replayed chunks
BASELINE_STEPS = 3


def _fig2_workload(torch, prng, dev, partitionable: bool):
    """`benchmarks/run.py::bench_step_path`'s workload on the card: m = 5,
    d = 2, paper_fig1, paper_experiment(0.05), estimation_problem(5, d=2,
    s=3, n_per_agent=100, seed=0), sample indices from default_rng(0),
    keys split(key(0), 600); every draw in the threefry stream
    ``partitionable`` names."""
    import numpy as np
    from repro_torch.core.pdsgd import make_decentralized_step
    from repro_torch.core.schedules import paper_experiment
    from repro_torch.core.topology import make_topology
    from repro_torch.data import estimation_problem
    m, d = 5, 2
    prob = estimation_problem(m, d=d, s=3, n_per_agent=100, seed=0)
    idx = np.random.default_rng(0).integers(0, 100,
                                            size=(FIG2_ITERS, m, 8))
    zb = torch.from_numpy(prob["Z"][np.arange(m)[None, :, None], idx])
    M = torch.from_numpy(prob["M"])

    def loss(p, batch):
        z, Mi = batch
        return torch.mean(torch.sum((z - p @ Mi.T) ** 2, -1))

    step = make_decentralized_step(loss, make_topology("paper_fig1", m),
                                   paper_experiment(0.05),
                                   partitionable=partitionable)
    keys = prng.split(prng.key(0), FIG2_ITERS, partitionable)

    def err(state):
        # as bench_step_path takes it: the f32 agent mean, then the norm
        x = state.flat[:, :d].cpu().numpy()
        return float(np.linalg.norm(x.mean(0) - prob["theta_opt"]))
    return step, zb.to(dev), M.to(dev), keys, err


def _fig2_eager(torch, K, step, zb, M, keys, iters):
    from repro_torch.core.pdsgd import init_state
    state = init_state(torch.zeros(2), 5, device=zb.device)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(iters):
        state, aux = step(state, (zb[k], M), keys[k])
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / iters * 1e6
    return state, aux, us, dict(K.launch_counts)


# kernel names of B3 and B2 in a trace (csrc/obfuscate.cu, csrc/gossip.cu)
TRACE_NAMES = {"obfuscate_update_krng": "obfuscate_krng_kernel",
               "gossip_update": "gossip_kernel"}


def _trace_replay(torch, run, steps: int) -> dict:
    """Device kernels of one call of ``run`` (a replayed chunk of
    ``steps`` steps) from a torch.profiler trace: kernels a step, device
    busy µs a step, the chunk's window, B3's and B2's kernels counted
    (their launches inside the replay, which no wrapper counts) and the
    top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        return {"kernel_events": 0}
    lo = min(e.time_range.start for e in kernels)
    hi = max(e.time_range.end for e in kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.end - e.time_range.start
    busy = sum(t for _, t in by_name.values())
    traced = {n: sum(c for k, (c, _) in by_name.items() if sub in k)
              for n, sub in TRACE_NAMES.items()}
    top = [{"kernel": k[:100], "per_step": c / steps, "us_per_step": t / steps}
           for k, (c, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:10]]
    return {"kernel_events": len(kernels),
            "kernels_per_step": len(kernels) / steps,
            "device_busy_us_per_step": busy / steps,
            "window_us_per_step": (hi - lo) / steps,
            "idle_share": 1.0 - busy / (hi - lo) if hi > lo else None,
            "b_kernels_traced": traced, "top": top}


def phase_fig2_path(torch, K, prng):
    """The North star's workload (paper Fig. 2) on the card: 600 PDSGD steps
    (B3 + B2 each) through the eager loop, then through the scanned step
    (`make_scanned_steps`, a CUDA graph of 100 steps: its first chunk the
    warm-up, five replays), every draw in jax's earlier threefry stream,
    the one the target was drawn from (``partitionable=False``); then one
    more replay under torch.profiler, whose trace counts the kernels a
    replayed step runs.  Gates: the graph's state equal to the eager
    loop's bit for bit, final_err within a relative 1e-3 of
    0.07891825798133546, 600 launches of B3 and of B2 counted on the
    eager loop, 100 counted on the graph's warm-up chunk, and the traced
    replay's B3 and B2 kernels equal to what its capture counted (100)."""
    from repro_torch.core.pdsgd import init_state, make_scanned_steps
    dev = torch.device("cuda")
    step, zb, M, keys, err = _fig2_workload(torch, prng, dev, False)
    _fig2_eager(torch, K, step, zb, M, keys, 5)  # warm-up
    eager, aux_e, us_eager, c_eager = _fig2_eager(
        torch, K, step, zb, M, keys, FIG2_ITERS)
    scanned = make_scanned_steps(step, FIG2_UNROLL)
    state = init_state(torch.zeros(2), 5, device=dev)
    Mk = M.expand(FIG2_UNROLL, *M.shape)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    chunk_us = []
    losses = []
    for c in range(FIG2_ITERS // FIG2_UNROLL):
        sl = slice(c * FIG2_UNROLL, (c + 1) * FIG2_UNROLL)
        t0 = time.perf_counter()
        state, aux = scanned(state, (zb[sl], Mk), keys[sl])
        losses.append(aux["loss"])
        torch.cuda.synchronize()
        chunk_us.append((time.perf_counter() - t0) / FIG2_UNROLL * 1e6)
    c_graph = dict(K.launch_counts)
    replayed = scanned.replayed_launches()
    e_eager, e_graph = err(eager), err(state)
    check(same_bits(torch, state.flat, eager.flat),
          "fig2_path: graph state differs from the eager loop's")
    # one more replay (steps 600-699 on the last chunk's batches), traced
    last = slice(FIG2_ITERS - FIG2_UNROLL, FIG2_ITERS)
    trace = _trace_replay(torch, lambda: scanned(state, (zb[last], Mk),
                                                 keys[last]), FIG2_UNROLL)
    step_p, zb_p, M_p, keys_p, _ = _fig2_workload(torch, prng, dev, True)
    part, _, _, _ = _fig2_eager(torch, K, step_p, zb_p, M_p, keys_p,
                                FIG2_ITERS)
    gap = abs(e_graph - NORTH_STAR) / NORTH_STAR
    losses = torch.cat(losses)
    check(bool(torch.isfinite(losses).all()), "fig2_path losses")
    check(gap <= 1e-3, f"fig2_path final_err {e_graph}: {gap} from "
                       f"{NORTH_STAR}")
    replays = FIG2_ITERS // FIG2_UNROLL - 1
    for name, c, n in (("eager", c_eager, FIG2_ITERS),
                       ("graph warm-up", c_graph, FIG2_UNROLL),
                       ("graph replays", replayed, replays * FIG2_UNROLL)):
        check(all(c.get(b, 0) == n for b in TRACE_NAMES),
              f"fig2_path {name} launches {c}")
    check(trace.get("b_kernels_traced") == {b: FIG2_UNROLL
                                             for b in TRACE_NAMES},
          f"fig2_path traced replay {trace.get('b_kernels_traced')}")
    emit({"phase": "fig2_path", "workload": "fig2_estimation d=2 m=5 "
          "iters=600, paper_fig1, paper_experiment(0.05)",
          "threefry": "partitionable=False (jax_threefry_partitionable="
                      "False)",
          "us_per_step_eager": us_eager,
          "us_per_step_graph": sum(chunk_us) / len(chunk_us),
          "us_per_step_graph_replays": sum(chunk_us[1:]) / len(chunk_us[1:]),
          "us_per_step_graph_first_chunk": chunk_us[0],
          "unroll_k": FIG2_UNROLL, "final_err_eager": e_eager,
          "final_err_graph": e_graph, "north_star": NORTH_STAR,
          "rel_gap_to_north_star": gap,
          "final_err_eager_partitionable": err(part),
          "graph_equals_eager_bitwise": True,
          "launches_eager": c_eager,
          "launches_graph_warmup_counted": c_graph,
          "launches_graph_replays_from_capture": replayed,
          "replays": replays, "traced_replay": trace})


def _ms_per_step(hist, first: int) -> float:
    """Host ms a step between the records of steps ``first`` and the last
    (each record's time is taken after its step's, or chunk's, sync)."""
    recs = {r["step"]: r["elapsed_s"] for r in hist if "step" in r}
    last = max(recs)
    return (recs[last] - recs[first]) / (last - first) * 1e3


def phase_main_path_scanned(torch, K, train, cfg):
    """The main path's configuration through `--unroll-k 4`: a warm-up chunk
    (the graph's code path run eagerly, then captured), then two chunks
    replayed (8 steps); beside it the same 12 steps through the eager
    loop.  Gates: finite losses; the scanned run's state equal to the
    eager run's bit for bit after the warm-up and both replays; B3 and B2
    counted once a step of the warm-up chunk, and once a step of each
    replay from the capture (no wrapper sees a replay; `--profile`'s
    trace counts their kernels)."""
    steps, k = SCANNED_STEPS, SCANNED_UNROLL
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        ("--unroll-k", str(k)))
    hist = res["history"]
    losses = [r["loss"] for r in hist]
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and res["state"].step == steps, "steps run")
    replayed = res["replayed_launches"]
    for what, c, n in (("counted", counts, k),
                       ("replayed", replayed, steps - k)):
        check(all(c.get(b, 0) == n for b in TRACE_NAMES),
              f"main_path_scanned {what} launches {c}")
    ms_scanned = _ms_per_step(hist, k - 1)
    scanned_state = res["state"]
    del res
    eager, e_counts, e_wall, e_peak = _run_path(torch, K, train, cfg, steps,
                                                True, held=True)
    same = same_bits(torch, scanned_state.flat, eager["state"].flat)
    check(same, "main_path_scanned: the graph's state differs from the "
                "eager loop's")
    ms_eager = _ms_per_step(eager["history"], k - 1)
    emit({"phase": "main_path_scanned", "arch": cfg.name,
          "num_layers": cfg.num_layers, "dtype": cfg.dtype, "agents": 4,
          "topology": "ring", "per_agent_batch": 2, "seq_len": 512,
          "unroll_k": k, "steps": steps, "losses": losses,
          "ms_per_step_replayed": ms_scanned,
          "ms_per_step_eager_same_steps": ms_eager,
          "first_chunk_s": hist[k - 1]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak,
          "max_memory_allocated_eager": e_peak,
          "state_equals_eager_bitwise": same,
          "launches_warmup_counted": counts,
          "launches_replays_from_capture": replayed})


# resample 4 redraws at each chunk's first step; 3 inside the replayed
# chunks (steps 6 and 9), at a different offset in each
DROPOUT_SCANNED_RUNS = (("dropout", DROPOUT_FLAGS),
                        ("resample", ("--topology-resample-every", "4")),
                        ("resample_3", ("--topology-resample-every", "3")))


def phase_dropout_path_scanned(torch, K, train, cfg):
    """The dropout path through `--unroll-k 4` (a warm-up chunk, then two
    chunks replayed from the CUDA graph, each W_k realized in the graph
    from the device step counter and B4 computing its Metropolis weights),
    beside the same 12 steps eager; then the same with
    `--topology-resample-every 4` and 3 (3 redraws inside the replayed
    chunks).  Gate: the states equal bit for bit.
    B3 and B4 counted once a step of the warm-up chunk, and once a step of
    each replay from the capture."""
    steps, k = SCANNED_STEPS, SCANNED_UNROLL
    out = {}
    for name, flags in DROPOUT_SCANNED_RUNS:
        res, counts, wall, peak = _run_path(
            torch, K, train, cfg, steps, True,
            (*flags, "--unroll-k", str(k)))
        hist = _step_records(res)
        losses = [r["loss"] for r in hist]
        check(all(math.isfinite(l) for l in losses), f"losses {losses}")
        check(len(hist) == steps and res["state"].step == steps,
              "steps run")
        replayed = res["replayed_launches"]
        for what, c, n in (("counted", counts, k),
                           ("replayed", replayed, steps - k)):
            check(c.get("obfuscate_update_krng", 0) == n
                  and c.get("masked_gossip_update", 0) == n
                  and c.get("gossip_update", 0) == 0,
                  f"dropout_path_scanned {name} {what} launches {c}")
        ms_scanned = _ms_per_step(hist, k - 1)
        scanned_state = res["state"]
        del res
        eager, _, e_wall, e_peak = _run_path(torch, K, train, cfg, steps,
                                             True, flags, held=True)
        same = same_bits(torch, scanned_state.flat, eager["state"].flat)
        check(same, f"dropout_path_scanned {name}: the graph's state "
                    f"differs from the eager loop's")
        windows = [r.get("b_window_connected") for r in hist]
        rec = {"phase": "dropout_path_scanned", "mode": name,
               "flags": list(flags), "arch": cfg.name,
               "num_layers": cfg.num_layers, "dtype": cfg.dtype,
               "agents": 4, "topology": "ring", "per_agent_batch": 2,
               "seq_len": 512, "unroll_k": k, "steps": steps,
               "losses": losses,
               "ms_per_step_replayed": ms_scanned,
               "ms_per_step_eager_same_steps": _ms_per_step(
                   _step_records(eager), k - 1),
               "first_chunk_s": hist[k - 1]["elapsed_s"],
               "run_wall_s": wall, "eager_wall_s": e_wall,
               "max_memory_allocated": peak,
               "max_memory_allocated_eager": e_peak,
               "b_window_connected": windows,
               "state_equals_eager_bitwise": same,
               "launches_warmup_counted": counts,
               "launches_replays_from_capture": replayed}
        emit(rec)
        out[name] = rec
        del scanned_state, eager
        gc.collect()
        torch.cuda.empty_cache()
    return out


# theta of Theorem 5 at kappa = 5 (Remark 5), the estimators' target
THETA_REMARK5 = 1.0322
THETA_TOL = 0.02
AUDIT_RUNS = (("static", ()), ("dropout", ("--topology-dropout", "0.3")))


def phase_privacy_audit(torch, K):
    """`launch/audit.main` on the card at the reference's defaults (m 5,
    dim 3, 8 parity steps, 40 attack steps, 200,000 samples) through B3 +
    B2, then with --topology-dropout 0.3 (the scanned path under a
    time-varying graph: B4 in the CUDA graph).  First the oracle's mix
    (`core.pdsgd.oracle_mix`, which the eager and ring paths use) against
    B2, bitwise, at m = 4, 5, 32.  Gates: capture-on == capture-off
    bitwise on every path; the four paths' streams bitwise (every
    deviation 0) and the report ``ok``; theta (kNN and binned) within 0.02
    of 1.0322; dsgd_recovery_rel_err < 1e-6; the PDSGD inversion's MSE at
    or above the Theorem-5 bound; the theorem5 section equal to a CPU
    run's on the same config.  The attack numbers printed beside the CPU
    run's, and the report's capture overhead."""
    from repro_torch.core.pdsgd import oracle_mix
    from repro_torch.launch import audit as AU
    # the oracle's mix on the card is B2's FMA chain: bitwise B2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for m in (4, 5, 32):
        W, B = (torch.rand((m, m), device="cuda", generator=gen)
                for _ in range(2))
        X, U = (torch.randn((m, 1 << 18), device="cuda", generator=gen)
                for _ in range(2))
        check(same_bits(torch, K.gossip_update(W, B, X, U),
                        oracle_mix(W, X) - oracle_mix(B, U)),
              f"privacy_audit: the oracle's mix differs from B2 at m={m}")
    out = {}
    for name, extra in AUDIT_RUNS:
        path = RECORDS.parent / f"privacy_report_{name}.json"
        argv = ["--device", "cuda", "--out", str(path), *extra]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rc = AU.main(argv)
        wall = time.perf_counter() - t0
        counts = dict(K.launch_counts)
        rep = json.loads(path.read_text())
        cfg = AU.config_from_args(AU.build_parser().parse_args(argv))
        par = rep["parity"]
        check(all(par["trajectory_bitwise"].values()),
              f"privacy_audit {name}: capture changed a trajectory "
              f"{par['trajectory_bitwise']}")
        worst = max(v for dev in par["max_abs_deviation"].values()
                    for v in dev.values())
        check(all(par["observations_bitwise"].values()) and worst == 0.0,
              f"privacy_audit {name}: the paths' streams differ, "
              f"max deviation {worst}")
        check(rc == 0 and rep["ok"], f"privacy_audit {name}: report not ok")
        t5 = rep["theorem5"]
        for est in ("theta_knn", "theta_binned"):
            check(abs(t5[est] - THETA_REMARK5) <= THETA_TOL,
                  f"privacy_audit {name}: {est} {t5[est]}")
        cpu_t5 = json.loads(json.dumps(AU.theorem5_report(cfg)))
        check(t5 == cpu_t5, f"privacy_audit {name}: theorem5 differs "
                            f"from the CPU run's")
        att = rep["attacks"]
        check(att["dsgd_recovery_rel_err"] < 1e-6,
              f"privacy_audit {name}: dsgd {att['dsgd_recovery_rel_err']}")
        check(att["pdsgd_ls_recovery_mse"] >= att["theorem5_mse_bound"],
              f"privacy_audit {name}: PDSGD under the Theorem-5 bound")
        cpu_att = AU.attack_report(cfg, device="cpu")
        check(counts.get("obfuscate_update_krng", 0) > 0
              and counts.get("masked_gossip_update" if extra
                             else "gossip_update", 0) > 0,
              f"privacy_audit {name} launches {counts}")
        rec = {"phase": "privacy_audit", "mode": name, "argv": argv,
               "ok": rep["ok"], "wall_s": wall,
               "trajectory_bitwise": par["trajectory_bitwise"],
               "observations_bitwise": par["observations_bitwise"],
               "max_abs_deviation": par["max_abs_deviation"],
               "theta_knn": t5["theta_knn"],
               "theta_binned": t5["theta_binned"],
               "theorem5_equals_cpu": True,
               "attacks": {k: att[k] for k in (
                   "dsgd_recovery_rel_err", "pdsgd_ls_recovery_mse",
                   "theorem5_mse_bound", "pdsgd_mse_over_bound",
                   "recovery_gap", "kappa")},
               "attacks_cpu": {k: cpu_att[k] for k in (
                   "dsgd_recovery_rel_err", "pdsgd_ls_recovery_mse",
                   "theorem5_mse_bound", "pdsgd_mse_over_bound",
                   "recovery_gap", "kappa")},
               "overhead": rep["overhead"], "launches": counts,
               "memory_allocated_after": torch.cuda.memory_allocated()}
        emit(rec)
        out[name] = rec
    return out


def _step_fn(torch, train, cfg, args, observer):
    """The trainer's step (`run_training`'s configuration) with an
    observer, and its batch 0 on the card."""
    from repro_torch.core.pdsgd import make_decentralized_step
    from repro_torch.core.schedules import warmup_harmonic
    from repro_torch.models import build_model
    bundle = build_model(cfg)
    kernel_layout = "concat" if args.kernel_layout == "auto" \
        else args.kernel_layout
    return make_decentralized_step(
        bundle.loss_fn, train.build_mixing(args),
        warmup_harmonic(args.lr, hold=args.warmup_hold),
        kernel_layout=kernel_layout, observer=observer), bundle


# steps timed per capture configuration (each from the same x^0)
CAPTURE_REPS = 3


def phase_privacy_capture_path(torch, K, train, prng, cfg):
    """stablelm-3b at full width, depth 2, m 4 on a ring, bf16: one step
    from the same state with capture off, with ``auditor()`` and with
    ``external_eavesdropper()`` through the concat layout (B3 + B2), then
    capture off and the eavesdropper through the ring layout (B9).  V is
    (4, 4, D) f32.  Gates: the parameters equal capture-off bit for bit;
    V's diagonal exactly zero; concat V equal to w x - b u formed from the
    auditor record's x and the kernel's own u; ring V equal to concat V
    within the bf16 rounding of u (B9 keeps u in f32, B3 writes it in
    bf16): |dV| <= 2^-8 |b_ij u_j| + 2^-22 (|w_ij x_j| + |b_ij u_j|) (2^-8
    is bf16's half ulp, relative)."""
    from repro_torch.core.pdsgd import DecentralizedState, init_state
    from repro_torch.data import make_lm_pipeline
    from repro_torch.privacy import observe as O
    dev = torch.device("cuda")
    args = _path_args(train, 1)
    gc.collect()
    torch.cuda.synchronize()
    step_off, bundle = _step_fn(torch, train, cfg, args, None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state0 = init_state(bundle.init(gen, dev), 4, device=dev)
    X0 = state0.flat.clone()
    layout = state0.layout
    D, m = layout.size, 4
    pipe = make_lm_pipeline(cfg.vocab_size, args.agents,
                            args.per_agent_batch, args.seq_len,
                            seed=args.seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    key = prng.fold_in(prng.key(1), 0)

    def run(step, label):
        """CAPTURE_REPS steps from x^0, one at a time (the last one's
        record kept): host ms each, ending in a sync, their median and
        minimum; the peak over them; the last step's launches."""
        times, peak, obs = [], 0, None
        for _ in range(CAPTURE_REPS):
            obs = None  # the previous record's V goes before the next
            state0.flat.copy_(X0)
            st = DecentralizedState(flat=state0.flat, layout=layout)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            st, aux = step(st, batch, key)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated())
            obs = aux.get("observation")
            del aux
        return st.flat, obs, {
            "ms": statistics.median(times), "ms_min": min(times),
            "ms_all": times, "peak": peak,
            "launches": dict(K.launch_counts), "label": label}

    runs = []
    run(step_off, "warm-up")
    out, _, r = run(step_off, "concat_off")
    X_off = out.clone()
    runs.append(r)
    # the auditor: V from x^k and B3's own u
    step_aud, _ = _step_fn(torch, train, cfg, args, O.auditor())
    out, rec, r = run(step_aud, "concat_auditor")
    runs.append(r)
    check(same_bits(torch, out, X_off), "auditor capture changed x'")
    check(rec["v"].shape == (m, m, D) and rec["v"].dtype == torch.float32,
          "record shape")
    check(torch.equal(rec["x"], X0[:, :D].float()), "record x is not x^k")
    W, B = rec["W"], rec["B"]
    formed = True
    for s, e in _chunks(D, 1 << 22):
        want = (W[:, :, None] * rec["x"][None, :, s:e]
                - B[:, :, None] * rec["u"][None, :, s:e]) \
            * (1.0 - torch.eye(m, device=dev))[:, :, None]
        formed &= bool(torch.equal(rec["v"][:, :, s:e], want))
    check(formed, "concat V is not w x - b u of the kernel's own u")
    check(all(bool((rec["v"][i, i] == 0).all()) for i in range(m)),
          "V's diagonal is not zero")
    u_concat = rec["u"].to(X0.dtype)
    check(torch.equal(u_concat.float(), rec["u"]),
          "u is not B3's own u (in the parameters' dtype)")
    half_ulp = torch.finfo(X0.dtype).eps / 2
    del rec, out
    gc.collect()
    torch.cuda.empty_cache()
    # the external eavesdropper: V and the support only
    step_eav, _ = _step_fn(torch, train, cfg, args,
                           O.external_eavesdropper())
    out, rec, r = run(step_eav, "concat_eavesdropper")
    runs.append(r)
    check(same_bits(torch, out, X_off), "eavesdropper capture changed x'")
    check(set(rec) == {"v", "support"}, f"eavesdropper view {set(rec)}")
    check(all(bool((rec["v"][i, i] == 0).all()) for i in range(m)),
          "V's diagonal is not zero")
    V_host = rec["v"].cpu()
    del rec, out, X_off
    gc.collect()
    torch.cuda.empty_cache()
    # the ring layout, B9 once: its own staged messages scattered to V
    ring_args = _path_args(train, 1, RING_FLAGS)
    ring_off, _ = _step_fn(torch, train, cfg, ring_args, None)
    out, _, r = run(ring_off, "ring_off")
    runs.append(r)
    X_ring_off = out.clone()
    ring_eav, _ = _step_fn(torch, train, cfg, ring_args,
                           O.external_eavesdropper())
    out, rec, r = run(ring_eav, "ring_eavesdropper")
    runs.append(r)
    check(same_bits(torch, out, X_ring_off), "ring capture changed x'")
    check(r["launches"].get("ring_obfuscate_gossip_krng", 0) == 1,
          f"ring launches {r['launches']}")
    Vr = rec["v"]
    worst, bitwise = 0.0, True
    x0 = X0[:, :D]
    for i in range(m):
        for j in range(m):
            vc = V_host[i, j].to(dev)
            d = (Vr[i, j] - vc).abs()
            bitwise &= bool(torch.equal(Vr[i, j], vc))
            wx = (W[i, j] * x0[j].float()).abs()
            bu = (B[i, j] * u_concat[j].float()).abs()
            tol = bu * half_ulp + (wx + bu) * 2.0 ** -22
            check(bool((d <= tol).all()), f"ring V[{i}, {j}] off concat V")
            worst = max(worst, float(d.max()))
            del vc, d, wx, bu, tol
    v_bytes = m * m * D * 4
    emit({"phase": "privacy_capture_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "dtype": cfg.dtype, "agents": m,
          "topology": "ring", "params_per_agent": D,
          "v_shape": [m, m, D], "v_bytes": v_bytes,
          "v_bytes_bound_ms": v_bytes / HBM_BYTES_PER_S * 1e3,
          "steps": runs, "params_equal_capture_off": True,
          "v_diagonal_zero": True, "concat_v_is_wx_minus_bu": formed,
          "ring_v_equals_concat_bitwise": bitwise,
          "ring_v_max_abs_diff": worst,
          "ms_capture_on_minus_off": {
              "concat_auditor": runs[1]["ms"] - runs[0]["ms"],
              "concat_eavesdropper": runs[2]["ms"] - runs[0]["ms"],
              "ring_eavesdropper": runs[4]["ms"] - runs[3]["ms"]},
          "capture_reps": CAPTURE_REPS})
    del Vr, rec, out, V_host, X0, X_ring_off, u_concat, state0
    gc.collect()
    torch.cuda.empty_cache()


# dsgd last but one: its state is held for the comparison with the graph
BASELINE_RUNS = (
    ("dsgt", ("--algorithm", "dsgt"), BASELINE_STEPS),
    ("dp_dsgd", ("--algorithm", "dp_dsgd", "--sigma-dp", "0.01"),
     BASELINE_STEPS),
    ("pdsgd_clip", ("--grad-clip-kappa", "1.0"), BASELINE_STEPS),
    ("dsgd", ("--algorithm", "dsgd"), 2 * BASELINE_STEPS),
    ("dsgd_unroll3", ("--algorithm", "dsgd", "--unroll-k", "3"),
     2 * BASELINE_STEPS),
)


def phase_baselines_path(torch, K, train, cfg):
    """The paper's baselines on the main path's configuration, eager: DSGT
    (its tracker pair two more (m, width) buffers), DP-DSGD (sigma 0.01;
    its normal draws are int64 threefry in torch ops), PDSGD with
    --grad-clip-kappa 1.0, DSGD (6 steps, the reference for the graph
    below), then DSGD through --unroll-k 3 (a warm-up chunk and a replay;
    its peak taken above the held DSGD state) against the eager DSGD run
    bit for bit.  Gates: finite losses; no B-kernel for the baselines
    (counted or replayed), B3 + B2 once a step with the clip; DSGT's peak
    at least 0.9 x two buffers above DSGD's.  Then the plain updates alone
    at this shape (`_baseline_updates`)."""
    out, states = {}, {}
    b_kernels = tuple(SOURCES)
    for name, extra, steps in BASELINE_RUNS:
        res, counts, wall, peak = _run_path(torch, K, train, cfg, steps,
                                            True, extra,
                                            held=name == "dsgd_unroll3")
        hist = res["history"]
        losses = [r["loss"] for r in hist]
        check(all(math.isfinite(l) for l in losses),
              f"baselines_path {name} losses {losses}")
        check(res["state"].step == steps, f"baselines_path {name} steps")
        if name == "pdsgd_clip":
            check(counts.get("obfuscate_update_krng", 0) == steps
                  and counts.get("gossip_update", 0) == steps,
                  f"baselines_path {name} launches {counts}")
        else:
            replayed = res["replayed_launches"]
            check(not any(counts.get(b, 0) or replayed.get(b, 0)
                          for b in b_kernels),
                  f"baselines_path {name} launched {counts}, {replayed}")
        first = 2 if name == "dsgd_unroll3" else 0
        rec = {"steps": steps, "losses": losses,
               "ms_per_step": _ms_per_step(hist, first),
               "run_wall_s": wall, "max_memory_allocated": peak,
               "launches": counts}
        if name in ("dsgd", "dsgd_unroll3"):
            states[name] = res["state"]
        else:
            del res
        out[name] = rec
    same = same_bits(torch, states["dsgd"].flat, states["dsgd_unroll3"].flat)
    check(same, "baselines_path: dsgd --unroll-k 3 differs from eager dsgd")
    X = states["dsgd"].flat
    two = 2 * X.numel() * X.element_size()
    extra_b = out["dsgt"]["max_memory_allocated"] - \
        out["dsgd"]["max_memory_allocated"]
    check(extra_b >= 0.9 * two,
          f"dsgt's peak carries {extra_b} B more than dsgd's, tracker "
          f"pair {two} B")
    shape, dtype = tuple(X.shape), X.dtype
    del states, X
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "baselines_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "dtype": cfg.dtype, "agents": 4,
          "topology": "ring", "per_agent_batch": 2, "seq_len": 512,
          "runs": out, "dsgt_extra_peak_bytes": extra_b,
          "tracker_pair_bytes": two,
          "dsgd_unroll3_equals_eager_bitwise": same,
          "updates": _baseline_updates(torch, shape, dtype)})


def _baseline_updates(torch, shape, dtype) -> dict:
    """Device ms of the plain baseline updates on (m, width) buffers of the
    main path (CUDA events, 3 calls after one warm-up, each its own
    record): `dsgd_update` in place (bound: read X and G, write X) and the
    step's DSGT `_dsgt_step_` (read X, Y, g^{k-1}, G, write X, Y,
    g^{k-1}), beside their bytes bounds."""
    from repro_torch.core.pdsgd import _dsgt_step_, dsgd_update
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    bufs = [torch.empty(shape, dtype=dtype, device=dev) for _ in range(4)]
    for b in bufs:
        b.normal_(generator=g)
    X, Y, Gp, G = bufs
    W = torch.full((shape[0], shape[0]), 1.0 / shape[0], device=dev)
    lam = torch.full((), 0.01, device=dev)
    one = X.numel() * X.element_size()
    out = {}
    for name, fn, passes in (
            ("dsgd_update", lambda: dsgd_update(X, G, W=W, lam=lam, out=X),
             3),
            ("dsgt_step", lambda: _dsgt_step_(X, Y, Gp, G, W=W, lam=lam),
             7)):
        fn()
        ms = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        check(all(math.isfinite(v) for v in ms), f"{name} timing")
        out[name] = {"ms": ms, "bound_ms": bound_ms(passes * one)[0],
                     "bound_by": "bytes"}
    check(_finite_flat(torch, X), "baseline updates left non-finite X")
    del bufs, X, Y, Gp, G
    return out


def phase_profile_scanned(torch, train, cfg):
    """Device busy and idle within the replayed chunks of the scanned main
    path (--unroll-k 4, 12 steps: kernels that start after the second
    chunk's range opened), from a torch.profiler trace; written to
    chiprun_out/profile_main_path_scanned.json."""
    from torch.profiler import ProfilerActivity, profile
    args = _path_args(train, SCANNED_STEPS,
                      ("--unroll-k", str(SCANNED_UNROLL)))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train.run_training(args, cfg=cfg)
    torch.cuda.synchronize()
    events = prof.events()
    lo = min(e.time_range.start for e in events
             if e.name == f"train_chunk_{SCANNED_UNROLL}")
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.start >= lo
               and not e.name.startswith("train_chunk_")]
    hi = max(e.time_range.end for e in kernels) if kernels else lo
    busy = sum((e.time_range.end - e.time_range.start) / 1e3
               for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    n = SCANNED_STEPS - SCANNED_UNROLL
    # B3's and B2's kernels in the replays: launches no wrapper counts
    traced = {b: sum(1 for e in kernels if sub in e.name)
              for b, sub in TRACE_NAMES.items()}
    check(traced == {b: n for b in TRACE_NAMES},
          f"main_path_scanned traced replays {traced}")
    window = (hi - lo) / 1e3
    top = [{"kernel": k[:120], "ms_per_step": v / n}
           for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_main_path_scanned.json").write_text(json.dumps(
        {"steps": n, "window_ms": window, "busy_ms": busy,
         "kernel_events": len(kernels), "kernels": top}, indent=1))
    emit({"phase": "profile", "path": "main_path_scanned",
          "steps_profiled": n, "kernel_events": len(kernels),
          "b_kernels_traced": traced,
          "step_ms": window / n, "device_busy_ms_per_step": busy / n,
          "idle_share": (1.0 - busy / window) if window > 0 else None,
          "top": top[:12]})


def phase_profile(torch, train, cfg, path: str = "main_path", extra=(),
                  steps: int = 4, seq_len: int = 512):
    """Device time by kernel over steps 1..steps-1 (step 0 warms up) of a
    path (``extra``: its flags), from a torch.profiler trace of
    run_training; each step is the range ``train_step_<k>``.  Writes the
    full table to chiprun_out/profile_<path>.json."""
    from torch.profiler import ProfilerActivity, profile
    args = _path_args(train, steps, extra, seq_len)
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
    (out / f"profile_{path}.json").write_text(json.dumps(
        {"steps": n, "window_ms": window_ms, "busy_ms": busy,
         "kernels": table, "host_ranges_ms_per_step": ranges,
         "host_ops": host_top}, indent=1))
    emit({"phase": "profile", "path": path, "steps_profiled": n,
          "step_ms": window_ms / n, "device_busy_ms_per_step": busy / n,
          "idle_share": 1.0 - busy / window_ms,
          "host_ranges_ms_per_step": ranges, "host_top": host_top[:8],
          "top": table[:12]})


SERVE_RANGES = ("serve_prefill", "serve_chunk")


def phase_profile_serve(torch, serve, requests: int = 8, gen: int = 24,
                        path_args=None, path: str = "serve_path"):
    """Device time by kernel in a serve path's steady prefills and decode
    chunks (``path_args``, default SERVE_PATH_ARGS, with ``requests``
    requests of ``gen`` tokens, no parity check), from a torch.profiler
    trace of run_serving: the engine names each prefill ``serve_prefill``
    and each chunk ``serve_chunk``; the first of each (the warm-up
    request's) is left out.  Both end in a device sync, so the kernels that
    start inside a range are its own.  Writes
    chiprun_out/profile_<path>.json."""
    from torch.profiler import ProfilerActivity, profile
    argv = [a for a in (path_args or SERVE_PATH_ARGS)
            if a != "--parity-check"]
    argv[argv.index("--requests") + 1] = str(requests)
    argv[argv.index("--gen-tokens") + 1] = str(gen)
    args = serve.build_parser().parse_args(argv)
    gc.collect()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve.run_serving(args)
    torch.cuda.synchronize()
    events = prof.events()
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.name not in SERVE_RANGES),
                     key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in kernels]
    out, table = {}, {}
    for name in SERVE_RANGES:
        ranges = sorted((e.time_range.start, e.time_range.end)
                        for e in events if e.name == name
                        and e.device_type == torch.autograd.DeviceType.CPU)
        ranges = ranges[1:]
        window = busy = 0.0
        by_name: dict[str, float] = {}
        for lo, hi in ranges:
            window += (hi - lo) / 1e3
            i = bisect.bisect_left(starts, lo)
            while i < len(kernels) and starts[i] <= hi:
                e = kernels[i]
                dur = (e.time_range.end - e.time_range.start) / 1e3
                by_name[e.name] = by_name.get(e.name, 0.0) + dur
                busy += dur
                i += 1
        n = max(len(ranges), 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        table[name] = [{"kernel": k[:120], "ms_each": v / n,
                        "share_of_device": v / max(busy, 1e-9)}
                       for k, v in top]
        out[name] = {"count": len(ranges), "ms_each": window / n,
                     "device_busy_ms_each": busy / n,
                     "idle_share": 1.0 - busy / max(window, 1e-9),
                     "top": table[name][:10]}
    path_dir = ROOT / "chiprun_out"
    path_dir.mkdir(exist_ok=True)
    (path_dir / f"profile_{path}.json").write_text(json.dumps(
        {"args": argv, "ranges": out, "kernels": table}, indent=1))
    emit({"phase": "profile", "path": path, "args": argv, **out})


SERVE_PATH_ARGS = ("--arch", "stablelm-3b", "--slots", "8", "--requests",
                   "16", "--prompt-len", "2000", "--gen-tokens", "64",
                   "--decode-chunk", "8", "--parity-check")
# xlstm-125m at full width and depth: prompts of 500 (no multiple of 64,
# so the dt = 0 padding runs), cut from stablelm's 2000 for the sLSTM's
# host loop (a few ops a token and block); 16 requests on 8 slots
XLSTM_SERVE_ARGS = ("--arch", "xlstm-125m", "--slots", "8", "--requests",
                    "16", "--prompt-len", "500", "--gen-tokens", "32",
                    "--decode-chunk", "8", "--parity-check")
# xlstm-125m training: sequence 128, cut from the reference's train shapes
# for the sLSTM's host loop (forward and backward, per token and agent)
XLSTM_TRAIN_SEQ = 128
XLSTM_TRAIN_STEPS = 4


def _serve_parity(torch, serve, arch: str, kernel: str):
    """``arch`` in f32, 4 requests on 2 slots, greedy, through run_serving
    on the card (kernels) and on the CPU (plain versions), same weights:
    equal token streams, both --parity-check ok, and every prompt's
    prefill logits within atol = rtol = 1e-4.  Returns (config, card
    streams, max logit error, launches of ``kernel`` on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    cfg = get_config(arch)
    gen = torch.Generator()
    gen.manual_seed(7)
    p0 = build_model(cfg).init(gen, "cpu")
    flags = ["--arch", cfg.name, "--slots", "2", "--requests", "4",
             "--prompt-len", "37", "--gen-tokens", "12", "--decode-chunk",
             "4", "--parity-check"]
    reset_launch_counts()
    gpu = serve.run_serving(serve.build_parser().parse_args(
        flags + ["--device", "cuda"]), init_params=p0)
    torch.cuda.synchronize()
    launches = launch_counts[kernel]
    cpu = serve.run_serving(serve.build_parser().parse_args(
        flags + ["--device", "cpu"]), init_params=p0)
    streams = [{c.req_id: c.tokens for c in run["completions"]}
               for run in (gpu, cpu)]
    check(streams[0] == streams[1], f"{arch} serve parity streams {streams}")
    check(gpu["result"]["parity"] == "ok" and cpu["result"]["parity"] == "ok",
          f"{arch} serve parity --parity-check")
    max_err = 0.0
    with torch.no_grad():
        for r in gpu["requests"]:
            tok = torch.as_tensor(r.tokens)[None]
            a = gpu["bundle"].prefill_fn(gpu["params"], {"tokens": tok.cuda()})
            b = cpu["bundle"].prefill_fn(cpu["params"], {"tokens": tok})
            a, b = a["logits"].cpu(), b["logits"]
            max_err = max(max_err, float((a - b).abs().max()))
            check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
                  f"{arch} serve parity prefill logits of request {r.req_id}")
    return cfg, streams[0], max_err, launches


def phase_serve_parity(torch, serve):
    """stablelm-3b-smoke in f32 (`_serve_parity`): prefill attention through
    B10 on the card, the naive attention on the CPU; the logits tolerance
    is the f32 conditioning of the smoke model's sharp attention
    (tests/test_torch_serve.py)."""
    cfg, tokens, max_err, b10 = _serve_parity(torch, serve,
                                              "stablelm-3b-smoke",
                                              "flash_attention")
    # prefills: warm-up + 4 requests + 4 sequential, 2 layers each
    check(b10 == cfg.num_layers * 9, f"serve_parity B10 launches {b10}")
    emit({"phase": "serve_parity", "arch": cfg.name, "dtype": "float32",
          "slots": 2, "requests": 4, "tokens_gpu": tokens,
          "streams_equal": True, "prefill_logits_max_abs_err": max_err,
          "flash_attention_launches_gpu": b10,
          "tolerance": "tokens equal; prefill logits atol = rtol = 1e-4"})


def phase_xlstm_serve_parity(torch, serve):
    """xlstm-125m-smoke in f32 (`_serve_parity`): the mLSTM's SSD through
    B11 on the card (prefill and every decode step), its plain version on
    the CPU."""
    cfg, tokens, max_err, b11 = _serve_parity(torch, serve,
                                              "xlstm-125m-smoke",
                                              "ssd_intra_chunk")
    # at least the 9 prefills' two calls in the one mLSTM block
    check(b11 >= 2 * 9, f"xlstm_serve_parity B11 launches {b11}")
    emit({"phase": "xlstm_serve_parity", "arch": cfg.name,
          "dtype": "float32", "slots": 2, "requests": 4,
          "tokens_gpu": tokens, "streams_equal": True,
          "prefill_logits_max_abs_err": max_err,
          "ssd_intra_chunk_launches_gpu": b11,
          "tolerance": "tokens equal; prefill logits atol = rtol = 1e-4"})


def decode_logit_spread(torch, ctx, args, steps: int = 8):
    """(max, per step) of the max |logit difference| between a batched
    decode step (all slots at once, as the engine decodes) and the same
    rows decoded one at a time (B = 1, as the sequential reference
    decodes), over ``steps`` greedy steps of the path's first ``slots``
    prompts, both fed the B = 1 stream's tokens."""
    from repro_torch.serve import make_layout, write_slot
    bundle, params = ctx["bundle"], ctx["params"]
    reqs = ctx["requests"][:args.slots]
    V = bundle.cfg.vocab_size
    cap = args.prompt_len + args.gen_tokens
    layout, one = make_layout(bundle, len(reqs), cap), make_layout(bundle, 1,
                                                                   cap)
    slab, singles, toks = layout.init("cuda"), [], []
    for s, r in enumerate(reqs):
        out = bundle.prefill_fn(params, {"tokens": torch.as_tensor(
            r.tokens)[None].cuda()})
        write_slot(layout, slab, out["cache"], s)
        singles.append(write_slot(one, one.init("cuda"), out["cache"], 0))
        toks.append(int(out["logits"][0, :V].float().argmax()))
    pos = torch.tensor([len(r.tokens) for r in reqs], dtype=torch.int32,
                       device="cuda")
    per_step = []
    for t in range(steps):
        cur = torch.tensor(toks, dtype=torch.int32, device="cuda")
        batched = bundle.decode_fn(params, cur, slab, pos)["logits"]
        worst = 0.0
        for s in range(len(reqs)):
            row = bundle.decode_fn(params, cur[s:s + 1], singles[s],
                                   int(pos[s]))["logits"][0]
            worst = max(worst, float((batched[s, :V].float()
                                      - row[:V].float()).abs().max()))
            toks[s] = int(row[:V].float().argmax())
        per_step.append(worst)
        pos = pos + 1
    return max(per_step), per_step


def decode_layer_growth(torch, ctx, args, slots: int = 4) -> list[float]:
    """Where a batched decode step leaves the B = 1 one: after each layer,
    the max |residual stream difference| between the path's first
    ``slots`` prompts decoded together (per-slot positions) and each
    decoded alone (scalar position), from the same prefill caches and
    tokens."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import (decode_cache_valid,
                                           decode_positions, rope_tables_at)
    from repro_torch.serve import make_layout, write_slot
    bundle, params = ctx["bundle"], ctx["params"]
    cfg = bundle.cfg
    reqs = ctx["requests"][:slots]
    cap = args.prompt_len + args.gen_tokens
    layout, one = make_layout(bundle, len(reqs), cap), make_layout(bundle, 1,
                                                                   cap)
    slab, singles, toks = layout.init("cuda"), [], []
    for s, r in enumerate(reqs):
        out = bundle.prefill_fn(params, {"tokens": torch.as_tensor(
            r.tokens)[None].cuda()})
        write_slot(layout, slab, out["cache"], s)
        singles.append(write_slot(one, one.init("cuda"), out["cache"], 0))
        toks.append(int(out["logits"][0, :cfg.vocab_size].float().argmax()))
    cur = torch.tensor(toks, dtype=torch.int32, device="cuda")
    pos = torch.full((len(reqs),), args.prompt_len, dtype=torch.int32,
                     device="cuda")
    p0 = torch.tensor(args.prompt_len, device="cuda")
    C = slab["k"].shape[2]

    def tables(at, n):
        return decode_cache_valid(at, C), rope_tables_at(
            decode_positions(at, n), cfg.head_dim, cfg.rotary_frac,
            cfg.rope_theta)

    (valid_b, rope_b), (valid_1, rope_1) = tables(pos, len(reqs)), tables(
        p0, 1)
    x_b = params["embed"][cur.long()][:, None, :]
    x_1 = [params["embed"][cur[s:s + 1].long()][:, None, :]
           for s in range(len(reqs))]
    growth = []
    for i, p in enumerate(tf._layers(params)):
        x_b = tf._layer_decode(p, x_b, slab["k"][i], slab["v"][i], pos,
                               rope_b, cfg, valid_b)
        for s in range(len(reqs)):
            x_1[s] = tf._layer_decode(p, x_1[s], singles[s]["k"][i],
                                      singles[s]["v"][i], p0, rope_1, cfg,
                                      valid_1)
        growth.append(max(float((x_b[s] - x_1[s][0]).float().abs().max())
                          for s in range(len(reqs))))
    return growth


def margin_rule(torch, ctx, args, spread: float) -> list[dict]:
    """A diagnostic of the M = 1 comparison (not a gate): where the
    engine's stream leaves the sequential B = 1 one, the first diverging
    position, the sequential logits' top-2 margin there, and the first
    position whose margin is below ``spread`` (a near tie that the batched
    and B = 1 products may order differently), if any up to there."""
    from repro_torch.core import prng
    from repro_torch.serve import sequential_decode
    bundle, params = ctx["bundle"], ctx["params"]
    V = bundle.cfg.vocab_size
    got = {c.req_id: c.tokens for c in ctx["completions"]}
    found = []
    for r in ctx["requests"]:
        rows: list = []
        seq = sequential_decode(
            bundle, params, {"tokens": torch.as_tensor(r.tokens)[None]
                             .cuda()}, r.req_id, r.max_new_tokens,
            base_key=prng.key(args.seed),
            max_seq_len=args.prompt_len + args.gen_tokens, logits_out=rows)
        eng = got[r.req_id]
        if eng == seq:
            continue
        p = next((j for j, (a, b) in enumerate(zip(eng, seq)) if a != b),
                 min(len(eng), len(seq)))
        margins = [float(t[0] - t[1]) for t in
                   (torch.topk(x[:V], 2).values for x in rows[:p + 1])]
        found.append({"req": r.req_id, "first_diverging_pos": p,
                      "margin_there": margins[-1],
                      "first_near_tie_pos": next(
                          (j for j, m in enumerate(margins) if m < spread),
                          None),
                      "min_margin_to_there": min(margins)})
    return found


def same_width_decode(torch, bundle, params, req, slots: int, cap: int,
                      seed: int = 0, temperature: float = 0.0):
    """The serve gate's oracle: ``req`` decoded alone, but in a batch
    ``slots`` rows wide, so that every product has the engine's shapes.
    Its B = 1 prefill is paged into every row of a ``slots``-row slab of
    capacity ``cap`` (`write_slot`); each step decodes all rows at per-row
    positions (`bundle.decode_fn`) with the same sampled token, drawn from
    row 0's logits with the engine's (request, position) key.  Returns
    (row 0's tokens, whether every row gave the same logits at every
    step)."""
    from repro_torch.core import prng
    from repro_torch.serve import (make_layout, sample_token, sampling_key,
                                   write_slot)
    dev = params["embed"].device
    V = bundle.cfg.vocab_size
    out = bundle.prefill_fn(params, {"tokens": torch.as_tensor(
        req.tokens)[None].to(dev)})
    layout = make_layout(bundle, slots, cap)
    slab = layout.init(dev)
    for s in range(slots):
        write_slot(layout, slab, out["cache"], s)
    logits = out["logits"].float().expand(slots, -1)
    p = int(out["pos"])
    pos = torch.full((slots,), p, dtype=torch.int32, device=dev)
    base = prng.key(seed).to(dev)
    toks, rows_equal = [], True
    while True:
        key = sampling_key(base, req.req_id, p) if temperature > 0 else None
        tok = int(sample_token(logits[0], key, temperature, V))
        toks.append(tok)
        if len(toks) >= req.max_new_tokens:
            return toks, rows_equal
        cur = torch.full((slots,), tok, dtype=torch.int32, device=dev)
        logits = bundle.decode_fn(params, cur, slab, pos)["logits"].float()
        rows_equal &= bool((logits == logits[0]).all())
        pos, p = pos + 1, p + 1


def same_width_gate(torch, ctx, args) -> dict:
    """The engine's streams against `same_width_decode` for every request:
    a record of the requests whose streams differ (with the first
    diverging position); the caller fails the phase on any."""
    bundle, params = ctx["bundle"], ctx["params"]
    got = {c.req_id: c.tokens for c in ctx["completions"]}
    cap = args.prompt_len + args.gen_tokens
    mismatches, rows_equal = [], True
    t0 = time.perf_counter()
    for r in ctx["requests"]:
        toks, equal = same_width_decode(torch, bundle, params, r, args.slots,
                                        cap, args.seed, args.temperature)
        rows_equal &= equal
        eng = got[r.req_id]
        if toks != eng:
            p = next((j for j, (a, b) in enumerate(zip(eng, toks))
                      if a != b), min(len(eng), len(toks)))
            mismatches.append({"req": r.req_id, "first_diverging_pos": p,
                               "engine": eng[p:p + 4],
                               "oracle": toks[p:p + 4]})
    return {"oracle": f"same-width decode, {args.slots} rows",
            "requests": len(ctx["requests"]), "equal": not mismatches,
            "mismatches": mismatches, "rows_equal_every_step": rows_equal,
            "seconds": time.perf_counter() - t0}


def _drive_serve(torch, K, serve, argv):
    """run_serving on ``argv`` with the launch counts set to 0 just before
    it and read just after it; earlier phases' buffers collected first, so
    the peak is this run's."""
    args = serve.build_parser().parse_args(list(argv))
    gc.collect()
    torch.cuda.synchronize()
    check(torch.cuda.memory_allocated() < 1 << 30,
          f"{torch.cuda.memory_allocated()} B still allocated before a path")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    ctx = serve.run_serving(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launch_counts)
    return args, ctx, counts, torch.cuda.max_memory_allocated(), wall


def _checked(res) -> int:
    """Requests --parity-check re-decoded sequentially: it stops at the
    first mismatching request, as the reference's does."""
    if res["parity"] == "ok":
        return res["requests"]
    return 1 + int(re.match(r"mismatch req (\d+)", res["parity"]).group(1))


def _serve_record(phase: str, res, args, peak, wall, counts, gate) -> dict:
    return {"phase": phase, "entry_point": res,
            "steady_prefill_ms": res["steady_prefill_ms"],
            "steady_chunk_ms": res["steady_chunk_ms"],
            "ms_per_decode_step": res["steady_chunk_ms"] / args.decode_chunk,
            "ms_per_token": 1e3 / res["tokens_per_s"],
            "tokens_per_s": res["tokens_per_s"],
            "ttft_p50_ms": res["ttft_p50_ms"],
            "latency_p50_ms": res["latency_p50_ms"],
            "latency_p99_ms": res["latency_p99_ms"],
            "max_memory_allocated": peak, "run_wall_s": wall,
            "gate": gate, "parity_m1": res["parity"], "launches": counts}


def phase_serve_path(torch, K, serve):
    """`python -m repro_torch.launch.serve` with SERVE_PATH_ARGS: stablelm-3b
    at full width and depth, bf16, 16 requests of 2000-token prompts on 8
    slots, 64 tokens each in chunks of 8, every prefill attention through
    B10 (32 launches a prefill).  Gate: the engine's streams equal the
    same-width oracle's exactly.  --parity-check's M = 1 sequential decode
    is a diagnostic: where it differs, the batched-vs-B=1 logit spread,
    the margin rule's record and a layer-by-layer trace of the two
    residual streams, in bf16 and in f32, are printed."""
    from repro_torch.models import build_model
    args, ctx, counts, peak, wall = _drive_serve(torch, K, serve,
                                                 SERVE_PATH_ARGS)
    res = ctx["result"]
    cfg = ctx["bundle"].cfg
    check(cfg.num_layers == 32 and cfg.d_model == 2560, "full stablelm-3b")
    check(res["completed"] == 16 and res["generated_tokens"] == 16 * 64,
          f"served {res['completed']} / {res['generated_tokens']}")
    # prefills: the warm-up request, 16 admissions, and the sequential
    # re-decodes of --parity-check
    prefills = 1 + 16 + _checked(res)
    check(counts.get("flash_attention", 0) == cfg.num_layers * prefills,
          f"serve_path launches {counts} for {prefills} prefills")
    del ctx["engine"]
    gc.collect()
    with torch.no_grad():
        gate = same_width_gate(torch, ctx, args)
    divergence, spread, per_step, spread_f32 = [], None, None, None
    growth = growth_f32 = None
    if res["parity"] != "ok":
        gc.collect()
        with torch.no_grad():
            spread, per_step = decode_logit_spread(torch, ctx, args)
            divergence = margin_rule(torch, ctx, args, spread)
            # why the M = 1 streams part: the batched and B = 1 residual
            # streams after each layer of one decode step, in bf16 and with
            # the same weights in f32
            growth = decode_layer_growth(torch, ctx, args)
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            ctx32 = {"bundle": build_model(cfg32),
                     "params": {k: v.float() if k != "layers" else
                                {n: t.float() for n, t in v.items()}
                                for k, v in ctx["params"].items()},
                     "requests": ctx["requests"]}
            spread_f32 = decode_logit_spread(torch, ctx32, args, steps=2)
            growth_f32 = decode_layer_growth(torch, ctx32, args)
            del ctx32
    rec = _serve_record("serve_path", res, args, peak, wall, counts, gate)
    rec.update({"flash_attention_launches": counts.get("flash_attention", 0),
                "prefills": prefills, "parity": res["parity"],
                "decode_logit_spread": spread,
                "decode_logit_spread_per_step": per_step,
                "decode_logit_spread_f32_per_step": (spread_f32[1]
                                                     if spread_f32 else None),
                "decode_layer_growth_bf16": growth,
                "decode_layer_growth_f32": growth_f32,
                "divergence_m1": divergence})
    emit(rec)
    check(gate["equal"], f"serve_path: the engine's streams differ from the "
                         f"same-width oracle's: {gate['mismatches']}")
    # the first token comes from the B = 1 prefill in both: exact
    check(all(d["first_diverging_pos"] > 0 for d in divergence),
          "serve_path: a first token differs from the sequential one")
    del ctx
    return {"flash_attention": counts}


def phase_xlstm_serve_path(torch, K, serve):
    """`python -m repro_torch.launch.serve` with XLSTM_SERVE_ARGS:
    xlstm-125m at full width and depth (12 blocks), bf16, 16 requests of
    500-token prompts on 8 slots, 32 tokens each in chunks of 8.  B11
    twice in each of the 6 mLSTM blocks of every prefill (Q = 64, 8 chunks)
    and every decode step (Q = 1); the launches are checked against the
    prefills and decode steps the run made.  Gate: the engine's streams
    equal the same-width oracle's exactly; --parity-check's M = 1
    comparison and, where it differs, the logit spread and the margin
    rule's record are printed."""
    args, ctx, counts, peak, wall = _drive_serve(torch, K, serve,
                                                 XLSTM_SERVE_ARGS)
    res = ctx["result"]
    cfg = ctx["bundle"].cfg
    n = args.requests
    check(cfg.num_layers == 12 and cfg.d_model == 768
          and cfg.family == "xlstm", "full xlstm-125m")
    check(res["completed"] == n and res["generated_tokens"] == n
          * args.gen_tokens,
          f"served {res['completed']} / {res['generated_tokens']}")
    checked = _checked(res)
    prefills = 1 + n + checked
    # decode steps: the warm-up's chunk and the timed chunks, then the
    # sequential re-decodes (a token per step after the first)
    steps = (args.decode_chunk * (1 + len(ctx["engine"].chunk_times))
             + (args.gen_tokens - 1) * checked)
    per_call = 2 * sum(1 for i in range(cfg.num_layers)
                       if i % cfg.slstm_every != 1)
    b11 = counts.get("ssd_intra_chunk", 0)
    check(b11 == per_call * (prefills + steps),
          f"xlstm_serve_path B11 launches {b11}, expected {per_call} x "
          f"({prefills} prefills + {steps} decode steps)")
    del ctx["engine"]
    gc.collect()
    with torch.no_grad():
        gate = same_width_gate(torch, ctx, args)
        spread, per_step, divergence = None, None, []
        if res["parity"] != "ok":
            spread, per_step = decode_logit_spread(torch, ctx, args)
            divergence = margin_rule(torch, ctx, args, spread)
    rec = _serve_record("xlstm_serve_path", res, args, peak, wall, counts,
                        gate)
    rec.update({"ssd_intra_chunk_launches": b11, "prefills": prefills,
                "decode_steps": steps, "parity": res["parity"],
                "decode_logit_spread": spread,
                "decode_logit_spread_per_step": per_step,
                "divergence_m1": divergence})
    emit(rec)
    check(gate["equal"], f"xlstm_serve_path: the engine's streams differ "
                         f"from the same-width oracle's: "
                         f"{gate['mismatches']}")
    del ctx
    return counts


def phase_xlstm_step_parity(torch, K, train):
    """2 steps of xlstm-125m-smoke (f32, one mLSTM and one sLSTM block)
    through run_training on the card (B3 + B2, and B11 in each mLSTM
    forward) and on the CPU (plain versions), same weights and batches;
    seq 70 pads the scan to 128.  Tolerance: losses rtol 1e-5, params
    atol = rtol = 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.core.privacy import tree_leaves
    from repro_torch.models import build_model
    cfg = get_config("xlstm-125m-smoke")
    gen = torch.Generator()
    gen.manual_seed(5)
    p0 = build_model(cfg).init(gen, "cpu")
    flags = ["--arch", cfg.name, "--agents", "4", "--steps", "2",
             "--log-every", "1", "--seq-len", "70", "--seed", "5"]
    K.reset_launch_counts()
    gpu = train.run_training(train.build_parser().parse_args(
        flags + ["--device", "cuda"]), init_params=p0)
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    cpu = train.run_training(train.build_parser().parse_args(
        flags + ["--device", "cpu"]), init_params=p0)
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(gpu["history"], cpu["history"]))
    check(loss_rel <= 1e-5, f"xlstm_step_parity loss rel {loss_rel}")
    max_abs = 0.0
    for a, b in zip(tree_leaves(gpu["state"].params),
                    tree_leaves(cpu["state"].params)):
        a = a.cpu()
        max_abs = max(max_abs, float((a - b).abs().max()))
        check(torch.allclose(a, b, atol=1e-4, rtol=1e-4),
              f"xlstm_step_parity params, max abs {max_abs}")
    # 2 steps x 4 agents x 1 mLSTM block x 2 calls
    check(counts.get("ssd_intra_chunk", 0) == 16
          and counts.get("obfuscate_update_krng", 0) == 2
          and counts.get("gossip_update", 0) == 2,
          f"xlstm_step_parity launches {counts}")
    emit({"phase": "xlstm_step_parity", "arch": cfg.name,
          "dtype": "float32", "agents": 4, "steps": 2, "seq_len": 70,
          "losses_gpu": [r["loss"] for r in gpu["history"]],
          "losses_cpu": [r["loss"] for r in cpu["history"]],
          "max_loss_rel_err": loss_rel, "max_param_abs_err": max_abs,
          "launches": counts,
          "tolerance": "loss rtol 1e-5; params atol = rtol = 1e-4"})


def phase_xlstm_train_path(torch, K, train, cfg):
    """run_training --arch xlstm-125m at full width and depth (12 blocks,
    d_model 768), 4 agents on a ring, bf16, PDSGD, per-agent batch 2,
    seq XLSTM_TRAIN_SEQ, 1 warm-up + 3 timed steps: B3 + B2 every step, B11
    in every mLSTM forward (4 agents x 6 blocks x 2 calls a step; its
    backward is the plain version's autograd)."""
    steps = XLSTM_TRAIN_STEPS
    res, counts, wall, peak = _run_path(torch, K, train, cfg, steps, True,
                                        seq_len=XLSTM_TRAIN_SEQ)
    hist = res["history"]
    losses = [r["loss"] for r in hist]
    state = res["state"]
    m, width = state.flat.shape
    n_m = sum(1 for i in range(cfg.num_layers) if i % cfg.slstm_every != 1)
    check(cfg.num_layers == 12 and cfg.d_model == 768, "full xlstm-125m")
    check(all(math.isfinite(l) for l in losses), f"losses {losses}")
    check(len(hist) == steps and state.step == steps, "steps run")
    check(state.flat.dtype == torch.bfloat16, "bf16 buffer")
    check(_finite_flat(torch, state.flat), "non-finite parameters")
    check(counts.get("obfuscate_update_krng", 0) == steps
          and counts.get("gossip_update", 0) == steps
          and counts.get("ssd_intra_chunk", 0) == m * n_m * 2 * steps,
          f"xlstm_train_path launches {counts}")
    ms_step = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (steps - 1) \
        * 1e3
    emit({"phase": "xlstm_train_path", "arch": cfg.name,
          "num_layers": cfg.num_layers, "d_model": cfg.d_model,
          "dtype": cfg.dtype, "agents": m, "topology": "ring",
          "per_agent_batch": 2, "seq_len": XLSTM_TRAIN_SEQ,
          "params_per_agent": state.layout.size, "width": width,
          "losses": losses, "ms_per_step": ms_step,
          "first_step_s": hist[0]["elapsed_s"], "run_wall_s": wall,
          "max_memory_allocated": peak, "launches": counts})
    return counts


SOURCES = {
    "obfuscate_update": ("src/repro_torch/csrc/obfuscate.cu",
                         "src/repro/kernels/obfuscate.py:85"),
    "obfuscate_update_krng": ("src/repro_torch/csrc/obfuscate.cu",
                              "src/repro/kernels/obfuscate.py:153"),
    "gossip_update": ("src/repro_torch/csrc/gossip.cu",
                      "src/repro/kernels/gossip.py:78"),
    "masked_gossip_update": ("src/repro_torch/csrc/gossip.cu",
                             "src/repro/kernels/gossip.py:151"),
    "masked_gossip_update_krng": ("src/repro_torch/csrc/gossip.cu",
                                  "src/repro/kernels/gossip.py:228"),
    "guarded_gossip_update": ("src/repro_torch/csrc/gossip.cu",
                              "src/repro/kernels/gossip.py:316"),
    "ring_gossip_update": ("src/repro_torch/csrc/ring.cu",
                           "src/repro/kernels/gossip.py:446"),
    "ring_obfuscate_gossip": ("src/repro_torch/csrc/ring.cu",
                              "src/repro/kernels/gossip.py:506"),
    "ring_obfuscate_gossip_krng": ("src/repro_torch/csrc/ring.cu",
                                   "src/repro/kernels/gossip.py:598"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:100"),
    "ssd_intra_chunk": ("src/repro_torch/csrc/ssm_scan.cu",
                        "src/repro/kernels/ssm_scan.py:64"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel phases only")
    ap.add_argument("--profile", action="store_true",
                    help="also profile main-, dropout-, fault-, ring- and "
                         "xLSTM train-path steps, the scanned main path's "
                         "replayed chunks and both serve paths with "
                         "torch.profiler")
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
    RECORDS.parent.mkdir(exist_ok=True)
    RECORDS.write_text("")
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import build
    from repro_torch.launch import serve, train

    smi = phase_device(torch, build)
    phase_kernels(torch, K, prng)
    phase_kernels_coupled(torch, K)
    phase_kernels_ring(torch, K, prng)
    b10 = phase_kernel_attention(torch, K)
    b11 = phase_kernel_ssd(torch, K)
    rows = {}
    if not opts.quick:
        phase_step_parity(torch, train)
        full = get_config("stablelm-3b")
        main_cfg = dataclasses.replace(full, num_layers=MAIN_LAYERS)
        rows.update(phase_main_path(torch, K, train, prng, main_cfg))
        torch.cuda.empty_cache()
        if opts.profile:
            phase_profile(torch, train, main_cfg)
            torch.cuda.empty_cache()
        phase_fig2_path(torch, K, prng)
        gc.collect()
        torch.cuda.empty_cache()
        phase_main_path_scanned(torch, K, train, main_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_dropout_path_scanned(torch, K, train, main_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_privacy_audit(torch, K)
        gc.collect()
        torch.cuda.empty_cache()
        if opts.profile:
            phase_profile_scanned(torch, train, main_cfg)
            gc.collect()
            torch.cuda.empty_cache()
        phase_baselines_path(torch, K, train, main_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        rows.update(phase_dropout_path(torch, K, train, prng, main_cfg))
        torch.cuda.empty_cache()
        rows.update(phase_fault_path(torch, K, train, prng, main_cfg))
        torch.cuda.empty_cache()
        rows.update(phase_ring_path(torch, K, train, prng, main_cfg))
        torch.cuda.empty_cache()
        if opts.profile:
            for path, extra in (
                    ("dropout_path", DROPOUT_FLAGS),
                    ("fault_path", (*FAULT_FLAGS, "--fault-seed",
                                    str(fault_seed(train, 6)[0]))),
                    ("ring_path", RING_FLAGS)):
                gc.collect()
                phase_profile(torch, train, main_cfg, path, extra)
                torch.cuda.empty_cache()
        bits_cfg = dataclasses.replace(full, num_layers=BITS_PATH_LAYERS)
        rows.update(phase_bits_path(torch, K, train, prng, bits_cfg))
        torch.cuda.empty_cache()
        rows.update(phase_ring_bits_path(torch, K, train, prng, bits_cfg))
        torch.cuda.empty_cache()
        phase_privacy_capture_path(torch, K, train, prng, bits_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_parity(torch, serve)
        gc.collect()
        torch.cuda.empty_cache()
        counts = phase_serve_path(torch, K, serve)["flash_attention"]
        rows["flash_attention"] = (counts, b10)
        if opts.profile:
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_serve(torch, serve)
        gc.collect()
        torch.cuda.empty_cache()
        phase_xlstm_step_parity(torch, K, train)
        xlstm_cfg = get_config("xlstm-125m")
        train_counts = phase_xlstm_train_path(torch, K, train, xlstm_cfg)
        torch.cuda.empty_cache()
        if opts.profile:
            gc.collect()
            # one profiled step and two requests: the profiler's events of
            # the sLSTM loop's small ops take minutes to collect
            phase_profile(torch, train, xlstm_cfg, "xlstm_train_path",
                          steps=2, seq_len=XLSTM_TRAIN_SEQ)
            torch.cuda.empty_cache()
        phase_xlstm_serve_parity(torch, serve)
        gc.collect()
        torch.cuda.empty_cache()
        serve_counts = phase_xlstm_serve_path(torch, K, serve)
        # B11's launches: the xLSTM train and serve paths' runs
        rows["ssd_intra_chunk"] = ({"ssd_intra_chunk": sum(
            c.get("ssd_intra_chunk", 0) for c in (train_counts,
                                                  serve_counts))}, b11)
        if opts.profile:
            gc.collect()
            torch.cuda.empty_cache()
            phase_profile_serve(torch, serve, requests=2, gen=16,
                                path_args=XLSTM_SERVE_ARGS,
                                path="xlstm_serve_path")
        # each kernel's launches from its own path's run, counted there
        # with the counts set to 0 just before it
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
    # B10 at the serve shape against the library call of the same run
    print(json.dumps({"B10_serve_shape": {
        "shape": list(SERVE_ATTN_SHAPE), "ms": b10["ms"],
        "tflops": b10["tflops"], "sdpa_ms": b10["library_ms"],
        "sdpa_tflops": b10["library_tflops"],
        "ms_over_sdpa": b10["ms_over_library"]}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
