"""Multi-controller PDSGD: N processes own N/world agents each
(counterpart of ``repro.launch.multihost``).

The paper's threat model is honest-but-curious separate parties; this
launcher makes the party boundary an OS process boundary.  Each rank
process owns a contiguous block of agents: their Lambda keys (derived in
the process, never serialized), their data stream (`DataPipeline`
``agent_slice``) and their checkpoint shard (``<root>/host_<r>``).  The
only bytes that cross a rank boundary are the framed mixed messages
``v_ij = w_ij x_j - b_ij u_j`` of `dist.transport.SocketTransport`.

    PYTHONPATH=src python -m repro_torch.launch.multihost \
        --world 4 --agents 4 --arch stablelm-3b-tiny --steps 20 \
        --checkpoint-dir /tmp/mh --checkpoint-every 5 [--device cpu]

The ranks run on ``cuda`` unless ``--device cpu`` is given; several
ranks may share one card.  ``--num-layers N`` cuts the config's depth
(the ranks are separate processes, so a depth-cut config travels as a
flag).

The per-rank program.  For each owned agent: loss and gradients at its
row of the rank's (L, width) f32 parameter buffer on the device, the
optional clip, the ``warmup_harmonic`` lambda_bar, and u = Lambda^k ∘ g
through the obfuscate kernel drawing Lambda in-kernel (B3,
`core.pdsgd.obfuscate_flat`, its plain version on the CPU), each row
keyed by the agent's global id.  The rank trains on f32 parameters
whatever the config's dtype, as the reference (its ``unflatten_one``
hands the model f32 leaves).  W_k and B^k are realized on the host over
the believed-alive set, and the exchange runs on the host in numpy.

Determinism.  Keys, batches, coupling realizations and B^k all derive
from the absolute step and the shared run seed, so a world=N run is bit
identical (final parameters and captured wire stream) to the world=1 run
of this driver at fault rate 0.  ``--private-lambda-keys`` draws each
rank's Lambda root from os.urandom instead (true key locality, no
cross-world reproducibility).

Faults, quorum and the key generation.  A SIGKILLed rank is seen twice:
the coordinator broadcasts ``{"dead": r}`` on the control sockets, and
the transport sees the dead peer (EOF or timeout).  From the next step
the survivors re-realize the Metropolis coupling over the alive overlay
(doubly stochastic for every realization).  ``--resume`` restarts every
rank from the quorum step (the newest step every shard completed).  A
run that recorded casualties had diverged from the deterministic
trajectory, so replaying its steps with the same Lambda^k stream would
pair old draws with new gradients, the key reuse the privacy argument
forbids: the launcher bumps a key generation in the spanning manifest,
folded into every per-step key root (B^k's too), and a clean resume
keeps it (a bit-identical replay).

Shard layout (the reference's):

    <root>/multihost.json        spanning manifest (rank 0 + launcher)
    <root>/wiretap_merged.npz    merged wire stream (launcher, --wiretap)
    <root>/host_<r>/step_<n>/... rank r's shard: only its agents' rows
    <root>/host_<r>/manifest.json
    <root>/host_<r>/wiretap.npz  rank r's sender-side wire columns
    <root>/host_<r>/fault_log.json

A shard holds {"x": (L, D) float32, "step"}: no key material and no other
rank's rows.
"""
from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import hashlib
import json
import os
import resource
import select
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..checkpoint import io as ckpt_io
from ..configs import get_config
from ..core import prng
from ..core.mixing import metropolis_from_mask
from ..core.pdsgd import DecentralizedState, _agent_grads, obfuscate_flat
from ..core.privacy import agent_key, clip_gradients, sample_B
from ..core.schedules import warmup_harmonic
from ..data import make_lm_pipeline
from ..dist.transport import (InProcessTransport, PipelinedSocketTransport,
                              SocketTransport, derive_wire_secret,
                              flatten_one)
from ..kernels.build import launch_counts, library
from ..kernels.ops import FlatLayout
from ..models import build_model
from .train import build_mixing, build_parser

__all__ = ["build_multihost_parser", "run_rank", "launch", "main",
           "host_dir", "quorum_step", "read_manifest", "next_generation",
           "merge_wiretaps", "MANIFEST"]

MANIFEST = "multihost.json"


def host_dir(root: str, rank: int) -> str:
    return os.path.join(root, f"host_{rank}")


def quorum_step(root: str, world: int) -> int | None:
    """Newest step every rank's shard has durably committed, or None."""
    common: set[int] | None = None
    for r in range(world):
        d = host_dir(root, r)
        steps = set(ckpt_io.complete_steps(d)) if os.path.isdir(d) else set()
        common = steps if common is None else (common & steps)
    return max(common) if common else None


def read_manifest(root: str) -> dict | None:
    path = os.path.join(root, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def next_generation(root: str, resume: bool) -> int:
    """The Lambda-key generation of this run: bumped on a resume after a
    run that recorded casualties, carried otherwise, 0 for a fresh run."""
    if not resume:
        return 0
    man = read_manifest(root)
    if man is None:
        return 0
    gen = int(man.get("generation", 0))
    if man.get("casualties"):
        gen += 1
    return gen


def merge_wiretaps(root: str, world: int) -> str | None:
    """Gather the ranks' sender-side wire columns into the dense stream.

    Each ``host_<r>/wiretap.npz`` holds ``v`` (T, m, L, D) and the step
    ids; the merge concatenates the sender axis over the steps every rank
    captured, giving the (T, m, m, D) tensor a single-process capture
    sees.  Returns the merged path, or None when a rank captured nothing.
    """
    blocks, step_sets = [], []
    for r in range(world):
        path = os.path.join(host_dir(root, r), "wiretap.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            blocks.append(z["v"])
            step_sets.append(list(z["steps"]))
    common = sorted(set(step_sets[0]).intersection(*map(set, step_sets)))
    if not common:
        return None
    sel = [blocks[r][[step_sets[r].index(s) for s in common]]
           for r in range(world)]
    merged = np.concatenate(sel, axis=2)  # -> (T, m, m, D)
    out = os.path.join(root, "wiretap_merged.npz")
    np.savez(out, v=merged, steps=np.asarray(common, np.int64))
    return out


def build_multihost_parser() -> argparse.ArgumentParser:
    p = build_parser()
    p.description = "multi-controller PDSGD launcher / rank driver"
    p.add_argument("--world", type=int, default=1,
                   help="number of rank processes (agents % world == 0)")
    p.add_argument("--transport", default="auto",
                   choices=["auto", "socket", "inproc"],
                   help="auto: sockets when world > 1, in-process "
                        "otherwise")
    p.add_argument("--wiretap", action="store_true",
                   help="capture each rank's sender-side wire columns to "
                        "host_<r>/wiretap.npz; the launcher merges them "
                        "into wiretap_merged.npz")
    p.add_argument("--private-lambda-keys", action="store_true",
                   help="derive each rank's Lambda root from os.urandom "
                        "instead of the shared seed (no cross-world "
                        "bit-reproducibility)")
    p.add_argument("--chaos-kill-rank", type=int, default=None,
                   help="rank that SIGKILLs itself mid-run (chaos test)")
    p.add_argument("--chaos-kill-step", type=int, default=None,
                   help="step at which --chaos-kill-rank dies")
    p.add_argument("--timeout", type=float, default=120.0,
                   help="socket/rendezvous timeout in seconds")
    p.add_argument("--frames-ahead", type=int, default=0,
                   help="0: blocking SocketTransport (lockstep); >0: "
                        "PipelinedSocketTransport, which stages frames "
                        "lazily, sends from a background thread and lets "
                        "this rank run up to N steps ahead of its slowest "
                        "live peer")
    p.add_argument("--outbox-frames", type=int, default=64,
                   help="bounded send-queue depth of the pipelined "
                        "transport (backpressure when full)")
    p.add_argument("--num-layers", type=int, default=None,
                   help="cut the config to this many layers (default: "
                        "the config's depth)")
    # internal (launcher -> rank):
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--coord", default=None, help=argparse.SUPPRESS)
    p.add_argument("--generation", type=int, default=None,
                   help=argparse.SUPPRESS)
    return p


# -- control-plane plumbing (JSON lines over the rendezvous socket) -------


def _send_json(sock: socket.socket, obj: dict) -> None:
    sock.sendall((json.dumps(obj) + "\n").encode())


class _LineReader:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def poll(self, timeout: float = 0.0) -> list[dict]:
        """Drain whatever JSON lines are available within ``timeout``."""
        out = []
        while True:
            nl = self.buf.find(b"\n")
            if nl >= 0:
                line, self.buf = self.buf[:nl], self.buf[nl + 1:]
                if line.strip():
                    out.append(json.loads(line))
                continue
            try:
                if self.sock.fileno() < 0:  # closed under us
                    return out
                r, _, _ = select.select([self.sock], [], [],
                                        timeout if not out else 0.0)
            except (OSError, ValueError):
                return out
            if not r:
                return out
            try:
                part = self.sock.recv(65536)
            except OSError:
                return out
            if not part:
                return out
            self.buf += part

    def wait_for(self, key: str, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for msg in self.poll(min(1.0, deadline - time.monotonic())):
                if key in msg:
                    return msg
        raise TimeoutError(f"no {key!r} message from coordinator within "
                           f"{timeout}s")


# -- the per-rank driver --------------------------------------------------


def _fingerprint(args, rank: int) -> dict:
    """Identity of a multihost shard, recorded in its run metadata: a
    resume whose world, agents, rank, seed or arch disagree fails."""
    return {"format": 1, "world": int(args.world),
            "agents": int(args.agents), "rank": int(rank),
            "seed": int(args.seed), "arch": args.arch}


def _peak_rss_bytes() -> int:
    """This process's peak resident bytes: VmHWM where the kernel gives
    it, else ru_maxrss (which, after an exec, starts from the parent's
    peak)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class _RankProgram:
    """One rank's local step on ``device``: loss and gradients of each
    owned agent at its row of an (L, width) f32 buffer, the clip, and
    u = Lambda^k ∘ g by the obfuscate kernel (B3) keyed by the agents'
    global ids.  Returns the losses and u (L, D) on the host."""

    def __init__(self, bundle, template, L: int, lo: int, device,
                 kappa, sched):
        self.layout = FlatLayout.of(template)
        self.D = self.layout.size
        self.device = device
        self.kappa = kappa
        self.sched = sched
        self.bundle = bundle
        self.X = torch.zeros((L, self.layout.width), dtype=torch.float32,
                             device=device)
        self.G = torch.zeros_like(self.X)
        self.state = DecentralizedState(flat=self.X, layout=self.layout)
        self.agents = torch.arange(lo, lo + L, dtype=torch.int64)

    def grads(self, x: np.ndarray, batch: dict):
        """x (L, D) into the buffer; each agent's loss and (clipped)
        gradients into G.  Returns the (L,) losses on the device."""
        self.X[:, :self.D].copy_(torch.from_numpy(x))
        batch = {n: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                 for n, v in batch.items()}
        losses = _agent_grads(self.bundle.loss_fn, self.state, batch, self.G)
        if self.kappa is not None:
            with torch.no_grad():
                clip_gradients(self.G, self.kappa)
        return losses

    def lam_bar(self, k: int):
        return self.sched(torch.tensor(float(k), dtype=torch.float32), 0)

    def obfuscate(self, k: int, lam_root):
        """u = Lambda^k ∘ g over G, in place, by B3 (its plain version on
        the CPU); returns the (L, width) buffer."""
        with torch.no_grad():
            return obfuscate_flat(self.X, self.G, self.layout,
                                  key=prng.fold_in(lam_root, k), step=k,
                                  lam_bar=self.lam_bar(k),
                                  agents=self.agents)

    def __call__(self, x: np.ndarray, batch: dict, k: int, lam_root):
        losses = self.grads(x, batch)
        u = self.obfuscate(k, lam_root)
        return losses.cpu().numpy(), u[:, :self.D].cpu().numpy()


def _digests(x: np.ndarray) -> dict:
    """``x_sha256`` (the whole (L, D) block) and ``row_sha256`` (one a
    row), hashed from the array's memory on a few threads (hashlib
    releases the GIL), no copy made."""
    x = np.ascontiguousarray(x)

    def digest(a):
        return hashlib.sha256(memoryview(a).cast("B")).hexdigest()

    with ThreadPoolExecutor(min(len(x) + 1, 8)) as ex:
        whole = ex.submit(digest, x) if len(x) > 1 else None
        rows = list(ex.map(digest, x))
    return {"x_sha256": whole.result() if whole is not None else rows[0],
            "row_sha256": rows}


def _key_roots(args, gen: int):
    """(shared_root, lam_root): the run's key root, a generation > 0
    folded in twice (0x5eed, then the generation, so a generation never
    collides with a step index), and the Lambda root (the shared one, or
    os.urandom's under --private-lambda-keys)."""
    shared_root = prng.key(args.seed + 1)
    if gen > 0:
        shared_root = prng.fold_in(prng.fold_in(shared_root, 0x5eed), gen)
    if args.private_lambda_keys:
        return shared_root, prng.key(int.from_bytes(os.urandom(4), "little"))
    return shared_root, shared_root


def _coupler(mixing, shared_root, m: int):
    """``couple(k, alive) -> (W, B, support)`` for step k as f32 numpy,
    realized on the host over the believed-alive set (eager torch ops on
    the CPU, one rounding each: the v math downstream stays FMA-free)."""
    adj_off = torch.as_tensor(mixing.base_mask, dtype=torch.float32)
    eye = torch.eye(m, dtype=torch.float32)

    def couple(k: int, alive):
        W, support, mask = mixing.realize(k)
        if alive is not None:
            base = mask if mask is not None else adj_off
            a = torch.as_tensor(alive, dtype=torch.float32)
            mask = base * a[:, None] * a[None, :]
            W = metropolis_from_mask(mask)
            support = mask + eye
        sk = prng.fold_in(shared_root, k)
        B = sample_B(agent_key(prng.fold_in(sk, 2), k, 0), support)
        return tuple(t.to(torch.float32).numpy() for t in (W, B, support))

    return couple


def run_rank(args, init_params=None) -> dict:
    """One controller process: own agents, own keys, own shard.

    ``init_params`` (a single-agent parameter tree, e.g. the reference's
    template through `repro_torch.convert`) replaces the random init from
    a ``torch.Generator`` seeded with ``--seed``, as in `run_training`.
    Returns (and prints as its last JSON line) a summary: the final step,
    finiteness, a digest of the final x, timing, the transport's counters,
    the kernel launches of this rank's loop, and its peak host and device
    memory.
    """
    faulthandler.enable()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to run the ranks on the "
                           "CPU)")
    rank = args.rank or 0
    world, m = args.world, args.agents
    if m % world:
        raise ValueError(f"{m} agents do not split over {world} ranks")
    L = m // world
    lo, hi = rank * L, (rank + 1) * L
    root = args.checkpoint_dir
    if world > 1 and not root:
        raise ValueError("--world > 1 requires --checkpoint-dir (shards + "
                         "spanning manifest live there)")
    if args.resume and not root:
        raise ValueError("--resume requires --checkpoint-dir")
    if args.checkpoint_sync and args.checkpoint_writer:
        raise ValueError("--checkpoint-sync and --checkpoint-writer are "
                         "mutually exclusive")
    writer = ("sync" if args.checkpoint_sync
              else args.checkpoint_writer or "thread")

    # --- rendezvous -----------------------------------------------------
    coord = reader = listen = None
    endpoints: dict[int, tuple[str, int]] = {}
    use_socket = args.transport == "socket" or (
        args.transport == "auto" and world > 1)
    if world > 1:
        if args.coord is None:
            raise ValueError("rank mode with --world > 1 needs --coord "
                             "(spawn through the launcher)")
        listen = socket.socket()
        listen.bind(("127.0.0.1", 0))
        listen.listen(world)
        host, port = args.coord.rsplit(":", 1)
        coord = socket.create_connection((host, int(port)),
                                         timeout=args.timeout)
        _send_json(coord, {"hello": rank,
                           "port": listen.getsockname()[1]})
        reader = _LineReader(coord)
        msg = reader.wait_for("endpoints", args.timeout)
        endpoints = {int(r): tuple(ep) for r, ep in msg["endpoints"].items()}

    # --- model / mixing / data ------------------------------------------
    cfg = get_config(args.arch)
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    bundle = build_model(cfg)
    mixing = build_mixing(args)
    pipeline = make_lm_pipeline(cfg.vocab_size, m, args.per_agent_batch,
                                args.seq_len, seed=args.seed)
    if init_params is None:
        gen_t = torch.Generator(device=device)
        gen_t.manual_seed(args.seed)
        init_params = bundle.init(gen_t, device)
    program = _RankProgram(bundle, init_params, L, lo, device,
                           args.grad_clip_kappa,
                           warmup_harmonic(args.lr, hold=args.warmup_hold))
    x = np.tile(flatten_one(init_params), (L, 1))  # (L, D): this rank's
    del init_params
    D = program.D
    adjacency = (np.asarray(mixing.base_mask, np.float32) > 0).astype(
        np.int64)

    # --- keys and coupling ---------------------------------------------
    gen = args.generation
    if gen is None:
        gen = next_generation(root, args.resume) if root else 0
    shared_root, lam_root = _key_roots(args, gen)
    couple = _coupler(mixing, shared_root, m)

    # --- transport -------------------------------------------------------
    if use_socket and world > 1:
        # per-run frame auth: every rank derives the same key from (seed,
        # generation), so a frame of another run or generation fails
        secret = derive_wire_secret(args.seed, gen)
        if args.frames_ahead > 0:
            transport = PipelinedSocketTransport(
                adjacency, rank, world, endpoints, listen,
                timeout=args.timeout, secret=secret,
                outbox_frames=args.outbox_frames,
                frames_ahead=args.frames_ahead)
        else:
            transport = SocketTransport(adjacency, rank, world, endpoints,
                                        listen, timeout=args.timeout,
                                        secret=secret)
    else:
        transport = InProcessTransport(adjacency)

    # --- checkpoint shard ------------------------------------------------
    manager = None
    start = 0
    run_meta = {"mixing": mixing.fingerprint(),
                "multihost": _fingerprint(args, rank)}
    if root:
        my_dir = host_dir(root, rank)
        if args.resume:
            q = quorum_step(root, world)
            if q is None:
                raise FileNotFoundError(
                    f"--resume: no step completed by ALL {world} shards "
                    f"under {root!r}; drop --resume for a fresh run")
            stored = ckpt_io.read_run_meta(my_dir, q)
            if stored.get("mixing") != run_meta["mixing"]:
                raise ValueError(
                    f"--resume: shard step_{q:08d} was written with mixing "
                    f"config {stored.get('mixing')}, this run built "
                    f"{run_meta['mixing']}; pass matching --topology* flags")
            if stored.get("multihost") != run_meta["multihost"]:
                raise ValueError(
                    f"--resume: shard step_{q:08d} belongs to deployment "
                    f"{stored.get('multihost')}, this run is "
                    f"{run_meta['multihost']}")
            newest = ckpt_io.latest_step(my_dir)
            manager = CheckpointManager(my_dir, keep_last=args.keep_last,
                                        keep_every=args.keep_every,
                                        writer=writer, fresh=False,
                                        run_meta=run_meta)
            like = {"x": np.zeros((L, D), np.float32),
                    "step": np.int32(0)}
            loaded = ckpt_io.load_checkpoint(my_dir, q, like=like)
            if int(loaded["step"]) != q:
                raise ValueError(
                    f"shard step_{q:08d} holds state.step="
                    f"{int(loaded['step'])}; refusing a mislabeled shard")
            x = np.asarray(loaded["x"], np.float32).copy()
            start = q
            print(json.dumps({"rank": rank, "resumed_from": q,
                              "own_newest": newest,
                              "rolled_back": bool(newest is not None
                                                  and newest > q),
                              "generation": gen}), flush=True)
        else:
            manager = CheckpointManager(my_dir, keep_last=args.keep_last,
                                        keep_every=args.keep_every,
                                        writer=writer, fresh=True,
                                        run_meta=run_meta)
        if rank == 0:
            # the spanning manifest; the launcher adds the casualties
            ckpt_io._atomic_write_json(os.path.join(root, MANIFEST), {
                "format": 1, "world": world, "agents": m, "per_rank": L,
                "arch": args.arch, "seed": int(args.seed),
                "steps": int(args.steps), "generation": gen,
                "transport": ("socket" if (use_socket and world > 1)
                              else "inproc"),
                "hosts": [f"host_{r}" for r in range(world)],
                "casualties": [],
            })

    # --- the loop --------------------------------------------------------
    dead_agents: set[int] = set()
    dead_ranks: set[int] = set()
    fault_log: list[dict] = []
    taps: list[np.ndarray] = []
    tap_steps: list[int] = []
    nonfinite = 0
    losses = np.zeros(L, np.float32)
    compute_s = 0.0  # the local program's wall time
    comm_s = 0.0     # wall time inside transport.exchange
    launches0 = dict(launch_counts)
    t0 = time.monotonic()
    k = start
    try:
        while k < args.steps:
            if (args.chaos_kill_rank == rank
                    and args.chaos_kill_step == k):
                os.kill(os.getpid(), signal.SIGKILL)
            if reader is not None:
                for msg in reader.poll(0.0):
                    if "dead" in msg:
                        dead_ranks.add(int(msg["dead"]))
            dead_ranks |= set(getattr(transport, "dead_ranks", ()))
            if dead_ranks:
                if isinstance(transport, SocketTransport):
                    for r in dead_ranks:
                        transport.mark_dead(r)
                dead_agents |= {a for r in dead_ranks
                                for a in range(r * L, (r + 1) * L)}
            alive = None
            if dead_agents:
                alive = np.ones(m, np.float32)
                alive[sorted(dead_agents)] = 0.0
            W, B, _ = couple(k, alive)
            if dead_agents and (not fault_log
                                or fault_log[-1]["dead"]
                                != sorted(dead_agents)):
                live = np.asarray(sorted(set(range(m)) - dead_agents))
                Wl = W[np.ix_(live, live)]
                fault_log.append({
                    "step": k, "dead": sorted(dead_agents),
                    "row_sum_err": float(np.abs(Wl.sum(1) - 1).max()),
                    "col_sum_err": float(np.abs(Wl.sum(0) - 1).max()),
                })
            batch = pipeline.batch_at(k, agent_slice=(lo, hi))
            tc = time.monotonic()
            losses, u = program(x, batch, k, lam_root)
            tx = time.monotonic()
            compute_s += tx - tc
            out = transport.exchange(x, u, W, B, step=k,
                                     capture=args.wiretap)
            del u
            comm_s += time.monotonic() - tx
            if args.wiretap:
                out, cols = out
                taps.append(cols)
                tap_steps.append(k)
            finite = bool(np.isfinite(out).all())
            if not finite:
                nonfinite += 1
                if args.nan_policy == "skip":
                    out = x  # hold the last finite local block
            x = np.asarray(out, np.float32)
            del out
            k += 1
            if manager is not None and k % args.checkpoint_every == 0:
                manager.save(k, {"x": x, "step": np.int32(k)})
            if (k - 1) % args.log_every == 0 or k == args.steps:
                print(json.dumps({
                    "rank": rank, "step": k - 1,
                    "loss_local": round(float(losses.mean()), 6),
                    "dead": sorted(dead_agents),
                    "elapsed_s": round(time.monotonic() - t0, 2)}),
                    flush=True)
        if manager is not None:
            final = max(start, args.steps)
            manager.save(final, {"x": x, "step": np.int32(final)})
    finally:
        if manager is not None:
            manager.close()
        transport.close()

    steps_run = max(0, args.steps - start)
    us_per_step = ((time.monotonic() - t0) / steps_run * 1e6
                   if steps_run else 0.0)
    comm = {
        "transport": type(transport).__name__,
        "steps": steps_run,
        "compute_s": round(compute_s, 4),
        "comm_s": round(comm_s, 4),
        "comm_wait_s": round(float(getattr(transport, "comm_wait_s",
                                           0.0)), 4),
        "drops": int(getattr(transport, "drops", 0)),
        "tag_failures": int(getattr(transport, "tag_failures", 0)),
        "bytes_sent": int(getattr(transport, "bytes_sent", 0)),
        "hmac_s": round(float(getattr(transport, "hmac_s", 0.0)), 4),
    }
    if root:
        if args.wiretap and taps:
            np.savez(os.path.join(host_dir(root, rank), "wiretap.npz"),
                     v=np.stack(taps),
                     steps=np.asarray(tap_steps, np.int64))
        if fault_log or isinstance(transport, SocketTransport):
            ckpt_io._atomic_write_json(
                os.path.join(host_dir(root, rank), "fault_log.json"),
                {"events": fault_log, "comm": comm})
    summary = {
        "rank": rank, "pid": os.getpid(),
        "final_step": int(max(start, args.steps)),
        "finite": bool(np.isfinite(x).all()),
        **_digests(x),
        "nonfinite_steps": nonfinite,
        "dead_seen": sorted(dead_ranks),
        "generation": gen,
        "us_per_step": round(us_per_step, 1),
        "comm": comm,
        "launches": {n: c - launches0.get(n, 0)
                     for n, c in launch_counts.items()
                     if c != launches0.get(n, 0)},
        "peak_rss_bytes": _peak_rss_bytes(),
        "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
    }
    print(json.dumps({"rank_summary": summary}), flush=True)
    if coord is not None:
        try:
            _send_json(coord, {"done": rank, **summary})
            coord.close()
        except OSError:
            pass
    return summary


# -- the launcher ---------------------------------------------------------


class _Coordinator(threading.Thread):
    """Rendezvous and death broadcast: collects one hello per rank,
    broadcasts the endpoint table, then relays launcher-detected deaths
    to the surviving control connections."""

    def __init__(self, world: int, timeout: float):
        super().__init__(name="repro-torch-multihost-coord", daemon=True)
        self.world = world
        self.timeout = timeout
        self.listen = socket.socket()
        self.listen.bind(("127.0.0.1", 0))
        self.listen.listen(world)
        self.port = self.listen.getsockname()[1]
        self.conns: dict[int, socket.socket] = {}
        self.done: dict[int, dict] = {}
        self.lock = threading.Lock()
        self.ready = threading.Event()
        self.stop = threading.Event()

    def run(self):
        endpoints = {}
        deadline = time.monotonic() + self.timeout
        self.listen.settimeout(1.0)
        while len(self.conns) < self.world:
            if self.stop.is_set() or time.monotonic() > deadline:
                return
            try:
                conn, _ = self.listen.accept()
            except socket.timeout:
                continue
            msg = _LineReader(conn).wait_for("hello", self.timeout)
            r = int(msg["hello"])
            with self.lock:
                self.conns[r] = conn
            endpoints[r] = ["127.0.0.1", int(msg["port"])]
        table = {"endpoints": endpoints}
        with self.lock:
            for conn in self.conns.values():
                try:
                    _send_json(conn, table)
                except OSError:
                    pass
        self.ready.set()
        readers = {r: _LineReader(c) for r, c in self.conns.items()}
        while not self.stop.is_set():
            with self.lock:
                items = [(r, rd) for r, rd in readers.items()
                         if r in self.conns]  # broadcast_dead closes conns
            for r, rd in items:
                for msg in rd.poll(0.05):
                    if "done" in msg:
                        self.done[r] = msg
            time.sleep(0.02)

    def broadcast_dead(self, rank: int):
        with self.lock:
            conn = self.conns.pop(rank, None)
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            for conn in self.conns.values():
                try:
                    _send_json(conn, {"dead": rank})
                except OSError:
                    pass

    def shutdown(self):
        self.stop.set()
        self.join(timeout=5.0)
        with self.lock:
            for conn in self.conns.values():
                try:
                    conn.close()
                except OSError:
                    pass
        try:
            self.listen.close()
        except OSError:
            pass


def _sum_launches(summaries) -> dict:
    total: dict[str, int] = {}
    for s in summaries:
        for n, c in ((s or {}).get("launches") or {}).items():
            total[n] = total.get(n, 0) + int(c)
    return total


def launch(args, init_params=None) -> dict:
    """Spawn ``--world`` rank processes (``python -m
    repro_torch.launch.multihost``), monitor them, merge their artifacts.

    Returns the run summary (also printed as the last JSON line): the
    rank summaries, the casualties (ranks that died), the generation, the
    summed kernel launches of the ranks, and ``ok`` (false when a rank
    that was not killed failed).  ``world == 1`` without a chaos kill runs
    the rank in this process (``init_params`` goes to it).
    """
    world = args.world
    root = args.checkpoint_dir
    if args.agents % world:
        raise ValueError(f"--agents {args.agents} does not split over "
                         f"--world {world}")
    gen = next_generation(root, args.resume) if root else 0
    if world == 1 and args.chaos_kill_rank is None:
        summary = run_rank(argparse.Namespace(**{**vars(args), "rank": 0,
                                                 "generation": gen}),
                           init_params=init_params)
        merged = merge_wiretaps(root, 1) if (args.wiretap and root) else None
        out = {"world": 1, "ranks": {"0": summary}, "casualties": [],
               "generation": gen, "wiretap_merged": merged,
               "launches": _sum_launches([summary]), "ok": True}
        _finalize(root, out)
        print(json.dumps({"multihost_summary": out}), flush=True)
        return out
    if init_params is not None:
        raise ValueError("init_params reaches an in-process rank only "
                         "(world 1 without a chaos kill)")
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but no CUDA device is "
                               "available (pass --device cpu to run the "
                               "ranks on the CPU)")
        # the ranks load the kernels' library: build it once here, not
        # once per rank
        library("obfuscate")

    coord = _Coordinator(world, args.timeout)
    coord.start()
    procs: dict[int, subprocess.Popen] = {}
    env = dict(os.environ)
    src_dir = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src_dir + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    passthrough = _args_to_argv(args)
    for r in range(world):
        cmd = [sys.executable, "-m", "repro_torch.launch.multihost",
               *passthrough, "--rank", str(r),
               "--coord", f"127.0.0.1:{coord.port}",
               "--generation", str(gen)]
        procs[r] = subprocess.Popen(cmd, env=env)
    casualties: list[int] = []
    alive = set(procs)
    try:
        while alive:
            time.sleep(0.1)
            for r in sorted(alive):
                rc = procs[r].poll()
                if rc is None:
                    continue
                alive.discard(r)
                if rc != 0:
                    casualties.append(r)
                    coord.broadcast_dead(r)
    finally:
        coord.shutdown()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    merged = merge_wiretaps(root, world) if (args.wiretap and root) else None
    ok = all(procs[r].returncode == 0 for r in range(world)
             if r not in casualties)
    ranks = {str(r): coord.done.get(r) for r in range(world)}
    out = {"world": world, "agents": args.agents, "ranks": ranks,
           "casualties": sorted(casualties), "generation": gen,
           "wiretap_merged": merged,
           "launches": _sum_launches(ranks.values()), "ok": ok}
    _finalize(root, out)
    print(json.dumps({"multihost_summary": out}), flush=True)
    return out


def _finalize(root: str | None, out: dict) -> None:
    """Record the run's outcome in the spanning manifest (the casualties
    drive the next run's key generation)."""
    if not root:
        return
    man = read_manifest(root) or {"format": 1}
    man["casualties"] = out["casualties"]
    man["generation"] = out["generation"]
    man["ok"] = out["ok"]
    ckpt_io._atomic_write_json(os.path.join(root, MANIFEST), man)


def _args_to_argv(args) -> list[str]:
    """Parsed args back to argv for the rank processes (a programmatic
    `launch` does not come through sys.argv)."""
    argv: list[str] = []
    skip = {"rank", "coord", "generation"}
    for name, val in vars(args).items():
        if name in skip or val is None:
            continue
        opt = "--" + name.replace("_", "-")
        if isinstance(val, bool):
            if val:
                argv.append(opt)
            continue
        argv.extend([opt, str(val)])
    return argv


def main(argv=None):
    args = build_multihost_parser().parse_args(argv)
    if args.rank is not None:
        run_rank(args)
        return 0
    out = launch(args)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
