"""Decentralized PDSGD training driver (counterpart of
``repro.launch.train``; the eager loop).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch stablelm-3b-smoke --agents 4 --steps 50 --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given.  Batches come from the
random-access numpy pipeline and the step key of step k is
``fold_in(key(seed + 1), k)``, both as in the reference, so the same
flags (and the same initial weights, `run_training(init_params=...)`)
walk the reference's trajectory (the reference's default algorithm,
pdsgd, and its eager loop, ``--unroll-k 1``).  The other algorithms,
checkpoints, resume, prefetch, the scanned loop, faults and the privacy
audit are not ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_config
from ..core import prng
from ..core.mixing import make_mixing
from ..core.pdsgd import init_state, make_decentralized_step
from ..core.schedules import warmup_harmonic
from ..core.topology import make_topology
from ..data import make_lm_pipeline
from ..kernels.build import to_device
from ..models import build_model

__all__ = ["build_parser", "run_training", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="stablelm-3b-smoke")
    p.add_argument("--agents", type=int, default=4)
    p.add_argument("--topology", default="ring",
                   choices=["ring", "paper_fig1"])
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


def run_training(args, cfg=None, init_params=None,
                 kernel_rng: bool = True) -> dict:
    """Run the eager loop; returns ``{"state", "history"}``.

    ``cfg`` overrides ``--arch`` (e.g. a depth-cut config object);
    ``init_params`` (a single-agent tree) replaces the random init from a
    ``torch.Generator`` seeded with ``--seed``.  ``kernel_rng`` picks how
    the obfuscate kernel gets Lambda's bits (`core.pdsgd.pdsgd_update`).
    """
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    cfg = cfg if cfg is not None else get_config(args.arch)
    bundle = build_model(cfg)
    mixing = make_mixing(make_topology(args.topology, args.agents))
    sched = warmup_harmonic(args.lr, hold=args.warmup_hold)
    step = make_decentralized_step(bundle.loss_fn, mixing, sched,
                                   kernel_rng=kernel_rng)
    pipeline = make_lm_pipeline(cfg.vocab_size, args.agents,
                                args.per_agent_batch, args.seq_len,
                                seed=args.seed)
    if init_params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        init_params = bundle.init(gen, device)
    state = init_state(init_params, args.agents, device=device)
    del init_params
    key = prng.key(args.seed + 1)

    history: list[dict] = []
    t0 = time.perf_counter()
    for k in range(args.steps):
        # the range names each step in a torch.profiler trace
        with torch.profiler.record_function(f"train_step_{k}"):
            batch = {name: to_device(torch.from_numpy(v), device)
                     for name, v in pipeline.batch_at(k).items()}
            state, aux = step(state, batch, prng.fold_in(key, k))
        if k % args.log_every == 0 or k == args.steps - 1:
            rec = {"step": k, "loss": float(aux["loss"]),
                   "consensus_error": float(aux["consensus_error"]),
                   "elapsed_s": time.perf_counter() - t0}
            history.append(rec)
            print(json.dumps(rec), flush=True)
    return {"state": state, "history": history}


def main(argv=None) -> int:
    run_training(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
