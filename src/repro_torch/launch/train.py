"""Decentralized training driver (counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch stablelm-3b-smoke --agents 4 --steps 50 --device cpu \
        [--algorithm pdsgd|dsgd|dsgt|dp_dsgd] [--sigma-dp 0.01]
        [--grad-clip-kappa 1.0] [--unroll-k 4]
        [--topology-dropout 0.25] [--fault-crash-rate 0.2 ...]
        [--kernel-layout ring]

Runs on ``cuda`` unless ``--device cpu`` is given.  Batches come from the
random-access numpy pipeline and the step key of step k is
``fold_in(key(seed + 1), k)``, both as in the reference, so the same
flags (and the same initial weights, `run_training(init_params=...)`)
walk the reference's trajectory.  ``--algorithm`` picks PDSGD or one of
the paper's baselines (``--sigma-dp`` is DP-DSGD's noise scale);
``--grad-clip-kappa`` clips every gradient element to [-kappa, kappa]
before the update.  ``--unroll-k K`` (K > 1) runs K steps per call of
`core.pdsgd.make_scanned_steps` — on the card one CUDA graph of K steps,
replayed per chunk — and the remaining steps eagerly; both loops walk
the same trajectory bit for bit, and the history keeps one record per
logged step either way.  The time-varying topology (``--topology-*``),
agent faults (``--fault-*``) and the ``--nan-policy`` sentinels are the
reference's flags, and so is ``--kernel-layout ring`` (the whole update
as one ring kernel; needs ``--topology ring``); none of them, nor the
xLSTM family, runs under ``--unroll-k > 1`` yet (ROADMAP 0a).  The
leafwise layout of sharded agents, checkpoints, resume, rollback,
prefetch and the privacy audit are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..core import prng
from ..core.mixing import make_mixing
from ..core.pdsgd import (ALGORITHMS, init_state, make_decentralized_step,
                          make_scanned_steps)
from ..core.schedules import warmup_harmonic
from ..core.topology import make_topology
from ..data import make_lm_pipeline
from ..faults import make_faults
from ..kernels.build import to_device
from ..models import build_model
from .steps import per_step_keys

__all__ = ["build_parser", "build_mixing", "build_faults", "run_training",
           "main"]

FAULT_COUNTERS = ("fault_down", "fault_corrupt", "fault_rejoin",
                  "fault_nonfinite")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="stablelm-3b-smoke")
    p.add_argument("--agents", type=int, default=4)
    p.add_argument("--topology", default="ring",
                   choices=["ring", "paper_fig1", "complete", "star",
                            "erdos"])
    p.add_argument("--topology-p", type=float, default=0.4,
                   help="edge probability for --topology erdos")
    p.add_argument("--topology-seed", type=int, default=None,
                   help="graph seed for --topology erdos and the "
                        "time-varying mixing draw stream (default: --seed)")
    p.add_argument("--topology-dropout", type=float, default=0.0,
                   help="per-step probability that each link fails "
                        "(time-varying W_k, Metropolis weights on chip; "
                        "0 = static)")
    p.add_argument("--topology-resample-every", type=int, default=0,
                   help="redraw the graph as Erdos-Renyi every N steps "
                        "(0 = never); exclusive with --topology-dropout")
    p.add_argument("--b-window", type=int, default=None,
                   help="B-connectivity diagnostic window: log whether the "
                        "union graph of the last N realized supports is "
                        "connected (default: 8 when the topology is "
                        "time-varying, off otherwise; 0 disables)")
    p.add_argument("--fault-crash-rate", type=float, default=0.0,
                   help="per-step probability that each live agent "
                        "crashes (0 = no crash faults)")
    p.add_argument("--fault-restart-rate", type=float, default=0.0,
                   help="per-step recovery probability of a crashed agent "
                        "(geometric outages); 0 with a crash rate = "
                        "permanent failstop")
    p.add_argument("--fault-corrupt-rate", type=float, default=0.0,
                   help="per-step probability that each live agent "
                        "poisons what it transmits (0 = off)")
    p.add_argument("--fault-corrupt-mode", default="nan",
                   choices=["nan", "inf", "scale"],
                   help="what a corrupt sender puts on the wire")
    p.add_argument("--fault-rejoin", default="hold",
                   choices=["hold", "neighbor-avg"],
                   help="warm start of a recovering agent; 'neighbor-avg' "
                        "has its neighbours send their states in the clear "
                        "for that step")
    p.add_argument("--fault-guard-clip", type=float, default=1e3,
                   help="receive-side per-link finite-guard clip; 0 "
                        "DISABLES the guard (raw poison reaches receivers)")
    p.add_argument("--fault-seed", type=int, default=None,
                   help="seed of the fault draw stream (default: --seed)")
    p.add_argument("--nan-policy", default="off",
                   choices=["off", "warn", "skip"],
                   help="isfinite sentinels on loss and updated state: "
                        "'warn' counts non-finite steps, 'skip' also holds "
                        "the last finite state")
    p.add_argument("--kernel-layout", default="auto",
                   choices=["auto", "concat", "ring"],
                   help="fused update layout: auto = concat (obfuscate "
                        "kernel, then gossip kernel); 'ring' = Lambda-draw, "
                        "obfuscate and the per-direction exchange in one "
                        "kernel (requires --topology ring)")
    p.add_argument("--algorithm", default="pdsgd", choices=list(ALGORITHMS))
    p.add_argument("--grad-clip-kappa", type=float, default=None,
                   help="clip every gradient element to [-kappa, kappa] "
                        "before the update (Theorem 5's bounded-gradient "
                        "premise; see core.privacy.clip_gradients / "
                        "lambda_stats)")
    p.add_argument("--sigma-dp", type=float, default=0.0,
                   help="noise scale of --algorithm dp_dsgd")
    p.add_argument("--unroll-k", type=int, default=1,
                   help="steps per call of the scanned step (a CUDA graph "
                        "of K steps on the card); 1 = eager")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--per-agent-batch", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.4)
    p.add_argument("--warmup-hold", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    return p


def build_mixing(args):
    """The run's `MixingProcess` from the topology flags; the topology
    seed (default ``--seed``) drives both the erdos graph and the
    time-varying draw stream."""
    topo_seed = (args.topology_seed if args.topology_seed is not None
                 else args.seed)
    top = make_topology(args.topology, args.agents, p=args.topology_p,
                        seed=topo_seed)
    return make_mixing(top, rate=args.topology_dropout,
                       resample_every=args.topology_resample_every,
                       seed=topo_seed)


def build_faults(args):
    """The run's `FaultProcess` from the fault flags, or None when no
    injection is configured.  ``--fault-guard-clip 0`` means no guard."""
    if args.fault_crash_rate <= 0.0 and args.fault_corrupt_rate <= 0.0:
        return None
    fault_seed = (args.fault_seed if args.fault_seed is not None
                  else args.seed)
    clip = args.fault_guard_clip if args.fault_guard_clip > 0 else None
    return make_faults(args.agents, crash_rate=args.fault_crash_rate,
                       restart_rate=args.fault_restart_rate,
                       corrupt_rate=args.fault_corrupt_rate,
                       corrupt_mode=args.fault_corrupt_mode,
                       rejoin=args.fault_rejoin, guard_clip=clip,
                       seed=fault_seed)


def run_training(args, cfg=None, init_params=None,
                 kernel_rng: bool = True) -> dict:
    """Run the training loop (chunks of ``--unroll-k`` steps through the
    scanned step, then the eager loop); returns ``{"state", "history",
    "fault_totals", "replayed_launches"}`` (the last: the kernels the
    CUDA graph's replays ran, from its capture, `make_scanned_steps`).

    ``cfg`` overrides ``--arch`` (e.g. a depth-cut config object);
    ``init_params`` (a single-agent tree) replaces the random init from a
    ``torch.Generator`` seeded with ``--seed``.  ``kernel_rng`` picks how
    the obfuscate kernel gets Lambda's bits (`core.pdsgd.pdsgd_update`).
    A step record carries the B-connectivity window fields when a window
    is on and the cumulative fault counters when faults or sentinels are;
    with either, a last record ``{"fault_summary": ...}`` closes the
    history.
    """
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    cfg = cfg if cfg is not None else get_config(args.arch)
    kernel_layout = "concat" if args.kernel_layout == "auto" \
        else args.kernel_layout
    if kernel_layout == "ring":
        # the ring tables need the coupling's support inside the (m, 1)
        # ring's adjacency; other graphs keep the concat layout
        if args.topology != "ring":
            raise SystemExit("--kernel-layout ring requires "
                             "--topology ring")
        if args.fault_corrupt_rate > 0.0:
            raise SystemExit("--kernel-layout ring does not carry "
                             "corrupt-link injection; drop "
                             "--fault-corrupt-rate or use --kernel-layout "
                             "concat")
    if args.unroll_k < 1:
        raise SystemExit("--unroll-k must be >= 1")
    if args.unroll_k > 1 and cfg.family == "xlstm":
        raise ValueError("--unroll-k > 1: the xLSTM family does not run "
                         "under the CUDA graph of steps yet (ROADMAP 0a); "
                         "use --unroll-k 1")
    bundle = build_model(cfg)
    mixing = build_mixing(args)
    faults = build_faults(args)
    sched = warmup_harmonic(args.lr, hold=args.warmup_hold)
    step = make_decentralized_step(bundle.loss_fn, mixing, sched,
                                   kernel_rng=kernel_rng,
                                   algorithm=args.algorithm,
                                   sigma_dp=args.sigma_dp,
                                   grad_clip=args.grad_clip_kappa,
                                   faults=faults,
                                   nan_policy=args.nan_policy,
                                   kernel_layout=kernel_layout)
    scanned = (make_scanned_steps(step, args.unroll_k)
               if args.unroll_k > 1 else None)
    b_window = args.b_window
    if b_window is None:
        b_window = 8 if not mixing.is_static else 0
    monitor = mixing.window_monitor(b_window) if b_window > 0 else None
    pipeline = make_lm_pipeline(cfg.vocab_size, args.agents,
                                args.per_agent_batch, args.seq_len,
                                seed=args.seed)
    if init_params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        init_params = bundle.init(gen, device)
    state = init_state(init_params, args.agents, device=device,
                       algorithm=args.algorithm)
    del init_params
    key = prng.key(args.seed + 1)

    history: list[dict] = []
    fault_totals: dict[str, int] = {}
    t0 = time.perf_counter()

    def logged(k: int) -> bool:
        return k % args.log_every == 0 or k == args.steps - 1

    def log(k: int, loss: float, cons: float) -> None:
        rec = {"step": k, "loss": loss, "consensus_error": cons,
               "elapsed_s": time.perf_counter() - t0}
        if monitor is not None:
            diag = monitor(k)
            rec.update(b_window=b_window,
                       b_window_connected=diag["connected"],
                       b_window_union_min_degree=diag["union_min_degree"])
        rec.update(fault_totals)  # cumulative, not per interval
        history.append(rec)
        print(json.dumps(rec), flush=True)

    k = 0
    # the scanned loop: whole chunks of --unroll-k steps, one sync a chunk
    while scanned is not None and args.steps - k >= args.unroll_k:
        with torch.profiler.record_function(f"train_chunk_{k}"):
            per_step = [pipeline.batch_at(k + i)
                        for i in range(args.unroll_k)]
            batches = {name: torch.from_numpy(np.stack(
                [b[name] for b in per_step])) for name in per_step[0]}
            state, aux = scanned(state, batches,
                                 per_step_keys(key, k, args.unroll_k))
        losses = aux["loss"].tolist()
        cons = aux["consensus_error"].tolist()
        for i in range(args.unroll_k):
            if logged(k + i):
                log(k + i, losses[i], cons[i])
        k += args.unroll_k
    # the eager loop: the whole run at --unroll-k 1, the tail otherwise
    for k in range(k, args.steps):
        # the range names each step in a torch.profiler trace
        with torch.profiler.record_function(f"train_step_{k}"):
            batch = {name: to_device(torch.from_numpy(v), device)
                     for name, v in pipeline.batch_at(k).items()}
            state, aux = step(state, batch, prng.fold_in(key, k))
        for name in FAULT_COUNTERS:
            if name in aux:
                fault_totals[name] = fault_totals.get(name, 0) + aux[name]
        if logged(k):
            log(k, float(aux["loss"]), float(aux["consensus_error"]))
    if faults is not None or args.nan_policy != "off":
        summary = {"fault_summary": dict(fault_totals)}
        history.append(summary)
        print(json.dumps(summary), flush=True)
    return {"state": state, "history": history,
            "fault_totals": fault_totals,
            "replayed_launches": (scanned.replayed_launches()
                                  if scanned is not None else {})}


def main(argv=None) -> int:
    run_training(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
