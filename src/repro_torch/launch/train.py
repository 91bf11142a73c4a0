"""Decentralized training driver (counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch stablelm-3b-smoke --agents 4 --steps 50 --device cpu \
        [--algorithm pdsgd|dsgd|dsgt|dp_dsgd] [--sigma-dp 0.01]
        [--grad-clip-kappa 1.0] [--unroll-k 4]
        [--topology-dropout 0.25] [--fault-crash-rate 0.2 ...]
        [--kernel-layout ring|leafwise] [--privacy-audit]
        [--checkpoint-dir ck --checkpoint-every 50 [--resume]]
        [--scan-layers] [--mesh-fsdp 2] [--mesh-tensor 2]

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
reference's flags, and so are ``--kernel-layout ring`` (the whole update
as one ring kernel; needs ``--topology ring``) and ``--kernel-layout
leafwise`` (the obfuscate kernel reading the step's Lambda bits, then the
gossip kernel, once per leaf on its columns of the flat buffer: bit for
bit the concat layout's bits path; ``auto`` stays ``concat`` on one
card).  Every one of them runs
under ``--unroll-k > 1``, as under the reference's ``lax.scan``, and so
do trimmed-mean steps and the xLSTM family: W_k, the faults and the
sentinel flag are realized in the graph from the device step counter,
and the fault counters come back stacked, read once a chunk.
``--privacy-audit`` runs `launch.audit` after training with the run's
agents, clip, dropout and seed, writes ``privacy_report.json`` next to
the checkpoints (or to the working directory) and prints the
reference's summary line.

Checkpoints (``--checkpoint-dir``, ``--checkpoint-every``) hold the whole
`DecentralizedState` (parameters, the step counter, DSGT's tracker) in
the reference's ``arrays.npz`` + ``tree.json`` layout (`checkpoint`).
A save clones the state on the card and a writer thread (or, with
``--checkpoint-writer subprocess``, a child process) commits it;
``--checkpoint-sync`` commits on the loop's thread.  ``--keep-last`` /
``--keep-every`` bound the disk, and a terminal checkpoint is always
written.  ``--resume`` restores the newest complete step into the
state's own buffers and continues from its step counter, so batches,
keys and draws of consumed steps are never re-issued; it refuses a
checkpoint written under other mixing or fault flags.  The mixing and
fault fingerprints and the audit's configuration go into every
checkpoint's ``run`` metadata, as in the reference.  With a checkpoint
directory, ``--rollback-patience`` non-finite observations in a row
(chunks in the scanned loop, steps in the eager loop) restore the newest
durable checkpoint (after ``--rollback-backoff`` seconds, doubling), at
most ``--max-rollbacks`` times before the run fails.  The scanned loop
takes its chunks from `data.prefetch_chunks`, built ``--prefetch-depth``
chunks ahead on a worker thread; a rollback there closes that stream and
opens a new one at the restored step, and the restore writes into the
graph's own buffers, so the captured graph replays on.

``--mesh-fsdp F`` / ``--mesh-tensor T`` (either above 1) turn on the
sharded execution: one process a rank (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``; gloo on the CPU, NCCL on the card, one
card a rank), the ("data", "fsdp", "model") mesh of
`launch.mesh.make_sharded_mesh` with one agent a "data" rank, the
sharding audit record first, each agent's parameters DTensors placed by
TRAIN_RULES (`optim.shard_like`), batches by `data.make_placer(mesh=)`,
the loss and its gradient by DTensor propagation and the update leafwise
(`launch.steps.sharded_pdsgd_step`).  It trains the dense transformer
family with pdsgd on a ring; the trainer's other options are refused
there.  Each record of rank 0's history carries the agents' mean loss;
a last record ``{"sharded_summary": ...}`` counts the leaves still
sharded after the update.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                          read_run_meta)
from ..configs import get_config
from ..core import prng
from ..core.mixing import make_mixing
from ..core.pdsgd import (ALGORITHMS, init_state, make_decentralized_step,
                          make_scanned_steps)
from ..core.schedules import warmup_harmonic
from ..core.topology import make_topology
from ..data import make_lm_pipeline, make_placer, prefetch_chunks
from ..faults import make_faults
from ..kernels.build import to_device
from ..models import build_model
from .steps import per_step_keys

__all__ = ["build_parser", "build_mixing", "build_faults", "audit_config",
           "run_meta", "run_training", "main"]

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
                   choices=["auto", "concat", "leafwise", "ring"],
                   help="fused update layout: auto = concat (obfuscate "
                        "kernel, then gossip kernel); 'leafwise' = the two "
                        "kernels once per leaf (Lambda from the bits "
                        "buffer); 'ring' = Lambda-draw, obfuscate and the "
                        "per-direction exchange in one kernel (requires "
                        "--topology ring)")
    p.add_argument("--algorithm", default="pdsgd", choices=list(ALGORITHMS))
    p.add_argument("--grad-clip-kappa", type=float, default=None,
                   help="clip every gradient element to [-kappa, kappa] "
                        "before the update (Theorem 5's bounded-gradient "
                        "premise; see core.privacy.clip_gradients / "
                        "lambda_stats)")
    p.add_argument("--privacy-audit", action="store_true",
                   help="after training, run the launch.audit adversary "
                        "suite (parity, Theorem-5 estimators, inversion "
                        "attacks) with this run's agents, clip, dropout "
                        "and seed, and write privacy_report.json next to "
                        "the checkpoints (or to the working directory); "
                        "the audit config goes into checkpoint run_meta")
    p.add_argument("--max-rollbacks", type=int, default=3,
                   help="checkpoint rollbacks attempted on a sustained "
                        "non-finite streak before the run fails")
    p.add_argument("--rollback-patience", type=int, default=2,
                   help="consecutive non-finite observations (chunks in "
                        "the scanned loop, steps in the eager loop) "
                        "before a rollback fires")
    p.add_argument("--rollback-backoff", type=float, default=0.5,
                   help="base rollback delay in seconds, doubling per "
                        "rollback")
    p.add_argument("--sigma-dp", type=float, default=0.0,
                   help="noise scale of --algorithm dp_dsgd")
    p.add_argument("--unroll-k", type=int, default=1,
                   help="steps per call of the scanned step (a CUDA graph "
                        "of K steps on the card); 1 = eager")
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="chunks built ahead by the prefetch thread")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--checkpoint-sync", action="store_true",
                   help="commit checkpoints on the loop's thread (blocks "
                        "the loop; default is the writer thread)")
    p.add_argument("--checkpoint-writer", default=None,
                   choices=["thread", "subprocess"],
                   help="async writer: 'thread' (default) commits on a "
                        "daemon thread; 'subprocess' ships the "
                        "serialization to a spawned child (same manifest "
                        "and retention)")
    p.add_argument("--keep-last", type=int, default=None,
                   help="retain only this many newest checkpoints "
                        "(default: keep all)")
    p.add_argument("--keep-every", type=int, default=None,
                   help="additionally pin every step divisible by this, "
                        "exempt from --keep-last")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest full state (with its step "
                        "counter) from --checkpoint-dir and continue")
    p.add_argument("--mesh-fsdp", type=int, default=1,
                   help="shard each agent's parameters over this many "
                        "ranks (FSDP within the agent; agents x fsdp x "
                        "tensor ranks).  >1 turns on the sharded "
                        "execution: the mesh of launch.mesh."
                        "make_sharded_mesh, parameters placed by the "
                        "logical-axis rules, the update leafwise over the "
                        "sharded tree.  One process a rank (RANK, "
                        "WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--mesh-tensor", type=int, default=1,
                   help="tensor-parallel ('model' axis) ranks per agent; "
                        "composes with --mesh-fsdp")
    p.add_argument("--scan-layers", action="store_true",
                   help="sets the config's scan_layers (the reference's "
                        "lax.scan over the layer stack); the port's layer "
                        "loop is the same either way, so it changes "
                        "neither values nor memory")
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


def audit_config(args):
    """The `launch.audit.AuditConfig` of ``--privacy-audit``: the paper's
    estimation workload under this run's agents, clip, dropout and seed,
    as the reference builds it."""
    from .audit import AuditConfig
    return AuditConfig(agents=args.agents, kappa=args.grad_clip_kappa,
                       dropout=args.topology_dropout, seed=args.seed)


def run_meta(args, mixing, faults) -> dict:
    """The ``run`` metadata every checkpoint records: the mixing
    fingerprint, the fault fingerprint when faults are on, and under
    ``--privacy-audit`` the audit's fingerprint (the reference's keys)."""
    meta = {"mixing": mixing.fingerprint()}
    if faults is not None:
        meta["faults"] = faults.fingerprint()
    if args.privacy_audit:
        from .audit import audit_fingerprint
        meta["privacy_audit"] = audit_fingerprint(audit_config(args))
    return meta


def run_training(args, cfg=None, init_params=None,
                 kernel_rng: bool = True) -> dict:
    """Run the training loop (chunks of ``--unroll-k`` steps through the
    scanned step, then the eager loop); returns ``{"state", "history",
    "resumed_from", "rollbacks", "checkpoint", "fault_totals",
    "replayed_launches", "graphs", "privacy_audit"}`` (``checkpoint``: the
    manager's save and commit seconds, `CheckpointManager.timings`, or
    None; ``replayed_launches``: the kernels the CUDA graph's replays ran,
    from its capture, and ``graphs`` each graph's warm-up and capture
    seconds and nodes, `make_scanned_steps`; the ``--privacy-audit``
    report, or None).

    ``cfg`` overrides ``--arch`` (e.g. a depth-cut config object);
    ``init_params`` (a single-agent tree) replaces the random init from a
    ``torch.Generator`` seeded with ``--seed``.  ``kernel_rng`` picks how
    the obfuscate kernel gets Lambda's bits (`core.pdsgd.pdsgd_update`).
    A step record carries the B-connectivity window fields when a window
    is on and the cumulative fault counters when faults or sentinels are;
    with either, a last record ``{"fault_summary": ..., "rollbacks": ...}``
    closes the history.
    """
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    cfg = cfg if cfg is not None else get_config(args.arch)
    if args.scan_layers:
        cfg = dataclasses.replace(cfg, scan_layers=True)
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
    if args.checkpoint_dir and args.checkpoint_every < 1:
        raise ValueError("--checkpoint-every must be >= 1 (omit "
                         "--checkpoint-dir to disable checkpoints)")
    if args.resume and not args.checkpoint_dir:
        raise ValueError("--resume requires --checkpoint-dir")
    if args.checkpoint_sync and args.checkpoint_writer:
        raise ValueError("--checkpoint-sync and --checkpoint-writer "
                         "are mutually exclusive")
    if args.mesh_fsdp > 1 or args.mesh_tensor > 1:
        return _run_sharded(args, cfg, init_params, device)
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
    place = make_placer(device)
    if init_params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        init_params = bundle.init(gen, device)
    state = init_state(init_params, args.agents, device=device,
                       algorithm=args.algorithm)
    del init_params
    key = prng.key(args.seed + 1)

    # Opened before resume is selected: opening recovers a predecessor's
    # crash debris (a step parked mid-re-save is renamed back), so
    # latest_step sees everything recoverable; a fresh run clears stale
    # steps, which would otherwise poison retention or a later --resume.
    meta = run_meta(args, mixing, faults)
    manager = None
    if args.checkpoint_dir:
        manager = CheckpointManager(
            args.checkpoint_dir, keep_last=args.keep_last,
            keep_every=args.keep_every,
            writer=("sync" if args.checkpoint_sync
                    else args.checkpoint_writer or "thread"),
            fresh=not args.resume, run_meta=meta)

    history: list[dict] = []
    fault_totals: dict[str, int] = {}
    rollbacks = 0
    streak = 0  # consecutive non-finite observations (chunks or steps)
    warned_no_rollback = False
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

    def checkpoint_due(k_prev: int, k_next: int) -> bool:
        # (k_prev, k_next] crosses a --checkpoint-every boundary; the
        # scanned loop saves at chunk ends only
        return manager is not None and (
            k_next // args.checkpoint_every > k_prev // args.checkpoint_every)

    def warn_once(text: str) -> None:
        nonlocal warned_no_rollback
        if not warned_no_rollback:
            warned_no_rollback = True
            print(json.dumps({"warning": text}), flush=True)

    def try_rollback(state):
        """After --rollback-patience non-finite observations in a row (chunks
        in the scanned loop, steps in the eager loop), restore the newest
        durable checkpoint in place after an exponential backoff,
        at most --max-rollbacks times (batches, keys and fault draws come
        from the absolute step, so a replay meets the same failure; the
        retries buy time for transient causes, then the run fails).
        Returns ``(state, restored_step or None)``."""
        nonlocal rollbacks, streak
        if streak < args.rollback_patience:
            return state, None
        if manager is None:
            warn_once("sustained non-finite state but no --checkpoint-dir; "
                      "rollback unavailable (nan-policy sentinels still "
                      "hold the last finite state)")
            return state, None
        if rollbacks >= args.max_rollbacks:
            raise RuntimeError(
                f"training state stayed non-finite through {rollbacks} "
                f"rollback(s) (--max-rollbacks={args.max_rollbacks}); "
                "the failure replays deterministically — fix the fault "
                "config instead of retrying")
        manager.wait()  # only committed steps are rollback targets
        last = latest_step(args.checkpoint_dir)
        if last is None:
            warn_once("sustained non-finite state before any durable "
                      "checkpoint; rollback unavailable")
            return state, None
        time.sleep(args.rollback_backoff * (2 ** rollbacks))
        rollbacks += 1
        streak = 0
        state = load_checkpoint(args.checkpoint_dir, last, like=state)
        rec = {"rollback": rollbacks, "restored_step": last}
        history.append(rec)
        print(json.dumps(rec), flush=True)
        return state, last

    start = 0
    try:
        if args.resume:
            state = _resume(args, state, meta)
            start = state.step
        k = start
        # the scanned loop: whole chunks of --unroll-k steps, one sync a
        # chunk, built ahead by the prefetch thread
        if scanned is not None and args.steps - k >= args.unroll_k \
                and manager is not None \
                and args.checkpoint_every % args.unroll_k:
            print(json.dumps({
                "warning": f"checkpoint_every={args.checkpoint_every} "
                           f"is not a multiple of unroll_k="
                           f"{args.unroll_k}: checkpoints land on chunk "
                           "boundaries only"}), flush=True)
        # a rollback abandons the in-flight prefetch stream (its chunks lie
        # past the restored step) and opens a new one from there
        while scanned is not None and args.steps - k >= args.unroll_k:
            rolled = False
            n_chunks = (args.steps - k) // args.unroll_k
            with prefetch_chunks(pipeline, args.unroll_k, start_step=k,
                                 num_chunks=n_chunks, place=place,
                                 depth=args.prefetch_depth) as chunks:
                for chunk in chunks:
                    with torch.profiler.record_function(f"train_chunk_{k}"):
                        state, aux = scanned(
                            state, chunk, per_step_keys(key, k, args.unroll_k))
                    losses = aux["loss"].tolist()
                    cons = aux["consensus_error"].tolist()
                    # the chunk's counters in one host read; the records
                    # carry the running totals step by step
                    names = [n for n in FAULT_COUNTERS if n in aux]
                    counters = dict(zip(names, torch.stack(
                        [aux[n] for n in names]).tolist() if names else []))
                    for i in range(args.unroll_k):
                        for n, v in counters.items():
                            fault_totals[n] = fault_totals.get(n, 0) + v[i]
                        if logged(k + i):
                            log(k + i, losses[i], cons[i])
                    nonf = sum(counters.get("fault_nonfinite", ()))
                    streak = streak + 1 if nonf else 0
                    k_next = k + args.unroll_k
                    if nonf:
                        state, restored = try_rollback(state)
                        if restored is not None:
                            k, rolled = restored, True
                            break
                    # under 'warn' a non-finite chunk may have poisoned the
                    # state: never make it a rollback target
                    if checkpoint_due(k, k_next) and not (
                            nonf and args.nan_policy == "warn"):
                        manager.save(k_next, state)
                    k = k_next
            if not rolled:
                break
        # the eager loop: the whole run at --unroll-k 1, the tail otherwise
        while k < args.steps:
            # the range names each step in a torch.profiler trace
            with torch.profiler.record_function(f"train_step_{k}"):
                batch = {name: to_device(v, device)
                         for name, v in place(pipeline.batch_at(k)).items()}
                state, aux = step(state, batch, prng.fold_in(key, k))
            for name in FAULT_COUNTERS:
                if name in aux:
                    fault_totals[name] = (fault_totals.get(name, 0)
                                          + int(aux[name]))
            nonf = int(aux.get("fault_nonfinite", 0))
            streak = streak + 1 if nonf else 0
            if logged(k):
                log(k, float(aux["loss"]), float(aux["consensus_error"]))
            if nonf:
                state, restored = try_rollback(state)
                if restored is not None:
                    k = restored
                    continue
            # under 'warn' a non-finite step may have poisoned the state:
            # never make it a rollback target ('skip' held the last finite)
            if checkpoint_due(k, k + 1) and not (
                    nonf and args.nan_policy == "warn"):
                manager.save(k + 1, state)
            k += 1
        if manager is not None:
            # the terminal checkpoint: a finished run resumes from its end
            # (save is idempotent; max(start, steps) is what state.step
            # holds even when a resume starts past --steps)
            manager.save(max(start, args.steps), state)
    finally:
        if manager is not None:
            # lands the queued writes; re-raises a writer failure, so the
            # loop never reports success on a checkpoint that never landed
            manager.close()
    if faults is not None or args.nan_policy != "off":
        summary = {"fault_summary": dict(fault_totals),
                   "rollbacks": rollbacks}
        if manager is not None:
            summary["checkpoint_retries"] = manager.retries
        history.append(summary)
        print(json.dumps(summary), flush=True)
    audit_report = None
    if args.privacy_audit:
        from .audit import run_audit
        out_path = os.path.join(args.checkpoint_dir or ".",
                                "privacy_report.json")
        audit_report = run_audit(audit_config(args), out=out_path,
                                 device=device)
        print(json.dumps({
            "privacy_audit": "ok" if audit_report["ok"] else "FAILED",
            "parity_all_pass": audit_report["parity"]["all_pass"],
            "pdsgd_recovery_mse":
                audit_report["attacks"]["pdsgd_ls_recovery_mse"],
            "theorem5_mse_bound":
                audit_report["attacks"]["theorem5_mse_bound"],
            "report": out_path}), flush=True)
    return {"state": state, "history": history,
            "resumed_from": start or None, "rollbacks": rollbacks,
            "checkpoint": manager.timings if manager is not None else None,
            "fault_totals": fault_totals,
            "replayed_launches": (scanned.replayed_launches()
                                  if scanned is not None else {}),
            "graphs": scanned.graph_stats() if scanned is not None else [],
            "privacy_audit": audit_report}


def _resume(args, state, meta: dict):
    """``--resume``: the newest complete checkpoint, restored into
    ``state``'s buffers, after the reference's checks (a checkpoint
    exists; fault and mixing fingerprints match; its state.step is its
    directory's step)."""
    last = latest_step(args.checkpoint_dir)
    if last is None:
        # never restart at step 0 silently: re-deriving the keys of
        # consumed steps is the key reuse the privacy argument forbids
        raise FileNotFoundError(
            f"--resume: no checkpoint found under {args.checkpoint_dir!r}; "
            "drop --resume for a fresh run")
    stored = read_run_meta(args.checkpoint_dir, last)
    faults_fp = meta.get("faults")
    if stored.get("faults") != faults_fp:
        # a missing key means the run had no faults: None against a
        # fingerprint refuses too
        raise ValueError(
            f"--resume: checkpoint step_{last:08d} was written with fault "
            f"config {stored.get('faults')}, but this run built "
            f"{faults_fp}; pass matching --fault-* flags (or start a fresh "
            "run without --resume)")
    stored_fp = stored.get("mixing")
    if stored_fp is None:
        print(json.dumps({
            "warning": "checkpoint records no mixing fingerprint "
                       "(written pre-PR4); cannot verify the --topology* "
                       "flags match the original run"}), flush=True)
    elif stored_fp != meta["mixing"]:
        raise ValueError(
            f"--resume: checkpoint step_{last:08d} was written with mixing "
            f"config {stored_fp}, but this run built {meta['mixing']}; "
            "pass matching --topology* flags (or start a fresh run without "
            "--resume)")
    state = load_checkpoint(args.checkpoint_dir, last, like=state)
    if int(state.step) != last:
        raise ValueError(
            f"checkpoint step_{last:08d} holds state.step={int(state.step)}; "
            "refusing to resume from a mislabeled checkpoint")
    print(json.dumps({"resumed_from": last, "state_step": int(state.step)}),
          flush=True)
    return state


_SHARDED_ONLY = ("the sharded execution (--mesh-fsdp/--mesh-tensor > 1) "
                 "trains pdsgd on --topology ring, eagerly, with "
                 "--kernel-layout auto or leafwise; {} waits for the rest "
                 "of ROADMAP 7b (7c)")


def _refuse_sharded(args) -> None:
    """The trainer options the sharded execution does not carry."""
    checks = (
        (args.algorithm != "pdsgd", f"--algorithm {args.algorithm}"),
        (args.topology != "ring", f"--topology {args.topology}"),
        (args.topology_resample_every > 0, "--topology-resample-every"),
        (args.kernel_layout not in ("auto", "leafwise"),
         f"--kernel-layout {args.kernel_layout}"),
        (args.unroll_k > 1, "--unroll-k > 1"),
        (args.fault_crash_rate > 0 or args.fault_corrupt_rate > 0,
         "fault injection"),
        (args.nan_policy != "off", "--nan-policy"),
        (args.grad_clip_kappa is not None, "--grad-clip-kappa"),
        (bool(args.checkpoint_dir), "--checkpoint-dir"),
        (args.privacy_audit, "--privacy-audit"))
    for bad, what in checks:
        if bad:
            raise SystemExit(_SHARDED_ONLY.format(what))


def _run_sharded(args, cfg, init_params, device) -> dict:
    """The sharded execution (see the module docstring); returns
    ``{"params", "history", "mesh"}``, ``params`` the (m, ...) DTensor
    tree."""
    import torch.distributed as dist

    from ..core.privacy import tree_leaves, tree_unflatten
    from ..dist.sharding import (TRAIN_RULES, MeshSharding, audit_rules,
                                 local_block, sharding_tree)
    from ..optim import shard_like
    from .mesh import make_sharded_mesh, num_agents
    from .specs import with_agent_axis
    from ..dist.collectives import gather_agents
    from .steps import _leaf_specs, _sub_placements, sharded_pdsgd_step
    _refuse_sharded(args)
    if not dist.is_initialized():
        raise SystemExit("--mesh-fsdp/--mesh-tensor need one process a rank "
                         "(set RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    mesh = make_sharded_mesh(agents=args.agents, fsdp=args.mesh_fsdp,
                             tensor=args.mesh_tensor,
                             device_type=device.type)
    m = num_agents(mesh)
    if m != args.agents:
        raise SystemExit(f"the sharded execution takes one agent a 'data' "
                         f"rank: {m} slots for --agents {args.agents}")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    bundle = build_model(cfg, mesh=mesh)
    findings = audit_rules(bundle.abstract(), bundle.logical_axes(), mesh)
    errors = [f for f in findings if f["severity"] == "error"]
    if errors:
        raise ValueError(
            "sharding audit failed (unknown logical axes):\n"
            + "\n".join(f"  {f['path']}: {f['issue']}" for f in errors))
    rank0 = dist.get_rank() == 0
    if rank0:
        print(json.dumps({"sharding_audit": "ok",
                          "mesh": dict(zip(mesh.mesh_dim_names,
                                           tuple(mesh.shape))),
                          "replicated_leaves": len(findings)}), flush=True)
    p_abs, p_log = with_agent_axis(bundle.abstract(), bundle.logical_axes(),
                                   m)
    sh = shard_like({"params": p_abs, "step": 0}, p_abs,
                    sharding_tree(mesh, p_abs, p_log, TRAIN_RULES),
                    scalar_sharding=MeshSharding(mesh, ()))
    if init_params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        init_params = bundle.init(gen, device)
    sub = mesh[tuple(n for n in mesh.mesh_dim_names
                     if n not in ("pod", "data"))]
    leaves = []
    # every agent starts from the same parameters: each rank places its
    # block of them, nothing is sent
    for p, s_ in zip(tree_leaves(init_params), tree_leaves(sh["params"])):
        pls = s_.placements
        blk = local_block(sub, p.to(device), _sub_placements(mesh, pls))
        leaves.append(torch.distributed.tensor.DTensor.from_local(
            blk.to_local()[None], mesh, pls, shape=(m,) + tuple(p.shape),
            stride=tuple((p.numel(),) + p.stride()), run_check=False))
    params = tree_unflatten(init_params, leaves)
    del init_params
    specs = _leaf_specs(bundle, mesh, m)
    mixing = build_mixing(args)
    sched = warmup_harmonic(args.lr, hold=args.warmup_hold)
    pipeline = make_lm_pipeline(cfg.vocab_size, args.agents,
                                args.per_agent_batch, args.seq_len,
                                seed=args.seed)
    place = make_placer(device, mesh=mesh)
    key = prng.key(args.seed + 1)
    history: list[dict] = []
    t0 = time.perf_counter()
    for k in range(args.steps):
        W, support, mask = mixing.realize(k, device)
        lam = sched(torch.full((), float(k), dtype=torch.float32,
                               device=device))
        params, loss = sharded_pdsgd_step(
            bundle, mesh, params, place(pipeline.batch_at(k)),
            prng.fold_in(key, k), k, W, support, mask, lam, specs)
        loss = gather_agents(mesh, loss).mean()
        if k % args.log_every == 0 or k == args.steps - 1:
            rec = {"step": k, "loss": float(loss),
                   "elapsed_s": time.perf_counter() - t0}
            history.append(rec)
            if rank0:
                print(json.dumps(rec), flush=True)
    sharded = sum(any(not pl.is_replicate() for pl in t.placements[1:])
                  for t in tree_leaves(params))
    summary = {"sharded_summary": {
        "mesh": dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
        "leaves": len(tree_leaves(params)), "sharded_leaves": sharded}}
    history.append(summary)
    if rank0:
        print(json.dumps(summary), flush=True)
    return {"params": params, "history": history, "mesh": mesh}


def _init_process_group(device: str) -> None:
    """One process a rank when the environment names a multi-rank job
    (``WORLD_SIZE`` > 1): gloo on the CPU, NCCL with this rank's local
    card on CUDA, a timeout of ``TORCH_DIST_TIMEOUT_S`` (default 300)."""
    import datetime

    import torch.distributed as dist
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    timeout = datetime.timedelta(
        seconds=float(os.environ.get("TORCH_DIST_TIMEOUT_S", "300")))
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", timeout=timeout,
                                device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo", timeout=timeout)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _init_process_group(args.device)
    try:
        run_training(args)
    finally:
        import torch.distributed as dist
        if dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
