"""Privacy-audit entry point (counterpart of ``repro.launch.audit``): run the
adversary suite, write a JSON report.

    PYTHONPATH=src python -m repro_torch.launch.audit [--device cpu] \
        [--topology-dropout 0.3] [--out privacy_report.json]

Runs on ``cuda`` unless ``--device cpu`` is given.  The report has the
reference's sections and keys:

* ``parity``    — capture-on walks the trajectory of capture-off bit for
                  bit on each of the four execution paths, and the paths
                  emit the same observation streams for the same seed:
                  "eager" (the unfused oracle, ``eager=True``), "fused"
                  (the kernels: obfuscate, then gossip), "scanned"
                  (`core.pdsgd.make_scanned_steps`: a CUDA graph on the
                  card, replayed) and "ring" (`dist.collectives.
                  torus_gossip_pdsgd(None, ..., capture=True)`, the dense
                  form, driven with the same B^k through
                  `rows_from_dense`).  Where two paths' streams are not
                  bitwise equal the report says so (false) and
                  ``max_abs_deviation`` gives each field's deviation.
* ``theorem5``  — the entropy estimators (`privacy.estimators`, numpy on
                  the host) against the closed forms of `core.entropy`.
* ``attacks``   — least-squares inversion on the distributed-estimation
                  workload: exact gradient recovery under DSGD, a PDSGD
                  reconstruction MSE above the Theorem-5 floor; the DLG
                  sweep with ``--dlg-steps > 0``.
* ``overhead``  — capture-on against capture-off microseconds a step of
                  the scanned step on the (static) estimation workload:
                  the median of a few calls, on the card replays of its
                  CUDA graph timed between CUDA events.

`launch.train --privacy-audit` runs this suite after training with the
run's topology and clipping knobs.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import time

import numpy as np
import torch

from ..core import entropy as E
from ..core import prng
from ..core import schedules as S
from ..core.mixing import make_mixing
from ..core.pdsgd import (DecentralizedState, _agent_grads, _obfuscated_rows,
                          init_state, make_decentralized_step,
                          make_scanned_steps)
from ..core.privacy import agent_key, sample_B, tree_leaves
from ..core.topology import make_topology
from ..dist import collectives as C
from ..privacy import attacks as A
from ..privacy import estimators as PE
from ..privacy import observe as O
from .steps import per_step_keys

__all__ = ["AuditConfig", "audit_fingerprint", "capture_trajectories",
           "parity_report", "theorem5_report", "attack_report", "run_audit",
           "main"]

AUDIT_VERSION = 1
# timed calls of each scanned step in `_overhead_report`
_OVERHEAD_ROUNDS = 5


@dataclasses.dataclass(frozen=True)
class AuditConfig:
    """Knobs of one audit run — everything `audit_fingerprint` hashes (the
    reference's fields)."""

    agents: int = 5
    dim: int = 3
    parity_steps: int = 8
    attack_steps: int = 40
    lam_base: float = 0.05
    kappa: float | None = None      # grad clip bound; None = report max|g|
    samples: int = 200_000
    est_lam_bar: float = 0.5
    est_kappa: float = 5.0
    dlg_steps: int = 0              # 0 = skip the (slow) DLG sweep
    dropout: float = 0.0            # time-varying parity scenario
    seed: int = 0


def audit_fingerprint(cfg: AuditConfig) -> dict:
    """JSON-stable identity of the audit configuration."""
    d = dataclasses.asdict(cfg)
    d["version"] = AUDIT_VERSION
    return d


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _host_tree(rec: dict) -> dict:
    return {k: _host(v) for k, v in rec.items()}


def _stack_records(records: list) -> dict | None:
    if not records:
        return None
    return {k: np.stack([r[k] for r in records]) for k in records[0]}


# ---------------------------------------------------------------------------
# parity: the four execution paths under the wire-tap


def _parity_setup(cfg: AuditConfig, device):
    """Ring topology (the 1 x m torus, so the ring form carries the same
    graph) and the quadratic per-agent objective."""
    m, d = cfg.agents, cfg.dim
    top = make_topology("ring", m)
    process = make_mixing(top, rate=cfg.dropout, seed=cfg.seed + 1)
    rng = np.random.default_rng(cfg.seed)
    batch = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(
        device)

    def loss(p, b):
        return torch.sum((p - b) ** 2)

    sched = S.paper_experiment(cfg.lam_base)
    keys = per_step_keys(prng.key(cfg.seed + 2), 0, cfg.parity_steps)
    return top, process, loss, batch, sched, keys


def _ring_audit_step(process, loss, sched):
    """One PDSGD step through `torus_gossip_pdsgd(capture=...)`, driven with
    the core paths' (W_k, B^k, Lambda^k): B^k is `privacy.sample_B`'s
    draw, handed to the ring as per-direction rows (`rows_from_dense`),
    which `dense_coupling` turns back into B^k exactly."""
    m = process.num_agents

    def step(state: DecentralizedState, batch, key, k: int, capture: bool):
        X, layout, dev = state.flat, state.layout, state.flat.device
        lam_bar = sched(torch.full((), float(k), dtype=torch.float32,
                                   device=dev))
        W, support, _ = process.realize(k, dev)
        G = torch.empty_like(X)
        _agent_grads(loss, state, batch, G)
        B = sample_B(agent_key(prng.fold_in(key, 2), k, 0), support)
        U = _obfuscated_rows(G, layout, key, k, lam_bar)
        b = C.rows_from_dense(B, n_data=m, n_pod=1)
        out = C.torus_gossip_pdsgd(None, layout.tree(X), layout.tree(U), b,
                                   n_data=m, n_pod=1, W=W, capture=capture)
        record = None
        if capture:
            out, V = out
            D = layout.size
            record = O.full_record(
                v=V, support=support, x_flat=X[:, :D].float(),
                u_flat=U[:, :D].float(), g_flat=G[:, :D].float(), W=W, B=B)
            record = _host_tree(record)
        for view, leaf in zip(layout.leaf_views(X), tree_leaves(out)):
            view.copy_(leaf)
        return DecentralizedState(flat=X, layout=layout, step=k + 1), record

    return step


def capture_trajectories(cfg: AuditConfig, device="cpu") -> dict:
    """Run the four execution paths with and without the wire-tap; per
    path the per-step parameters (T, m, d), the final parameters and
    (capture on) the stacked auditor observation stream."""
    top, process, loss, batch, sched, keys = _parity_setup(cfg, device)
    m, d, T = cfg.agents, cfg.dim, cfg.parity_steps
    zeros = torch.zeros((d,), device=device)
    out: dict = {}

    def run_eager(eager: bool, observer):
        step = make_decentralized_step(loss, process, sched, eager=eager,
                                       observer=observer)
        state = init_state(zeros, m)
        traj, obs = [], []
        for k in range(T):
            state, aux = step(state, batch, keys[k])
            traj.append(_host(state.flat[:, :d]))
            if observer is not None:
                obs.append(_host_tree(aux["observation"]))
        return {"traj": np.stack(traj), "obs": _stack_records(obs)}

    for name, eager in (("eager", True), ("fused", False)):
        out[name] = run_eager(eager, O.auditor())
        out[name + "_off"] = run_eager(eager, None)

    # scanned: T steps a call.  On the card the first call runs them
    # eagerly and captures the graph; the state is reset in its own
    # buffers and the second call replays the graph: that is the path.
    batches = batch[None].expand((T,) + tuple(batch.shape)).contiguous()
    for name, observer in (("scanned", O.auditor()), ("scanned_off", None)):
        step = make_decentralized_step(loss, process, sched,
                                       observer=observer)
        scanned = make_scanned_steps(step, T)
        state = init_state(zeros, m)
        init = state.flat.clone()
        scanned(state, batches, keys)
        state.flat.copy_(init)
        state = DecentralizedState(flat=state.flat, layout=state.layout)
        state, aux = scanned(state, batches, keys)
        out[name] = {"final": _host(state.flat[:, :d]),
                     "loss_stream": _host(aux["loss"])}
        if observer is not None:
            out[name]["obs"] = _host_tree(aux["observation"])

    ring_step = _ring_audit_step(process, loss, sched)
    for name, capture in (("ring", True), ("ring_off", False)):
        state = init_state(zeros, m)
        traj, obs = [], []
        for k in range(T):
            state, rec = ring_step(state, batch, keys[k], k, capture)
            traj.append(_host(state.flat[:, :d]))
            if rec is not None:
                obs.append(rec)
        out[name] = {"traj": np.stack(traj), "obs": _stack_records(obs)}

    for name in ("eager", "fused", "ring", "eager_off", "fused_off",
                 "ring_off"):
        out[name]["final"] = out[name]["traj"][-1]
    return out


def parity_report(cfg: AuditConfig, device="cpu", runs=None) -> dict:
    """The two bit-parity guarantees: bools and max deviations."""
    runs = runs if runs is not None else capture_trajectories(cfg, device)

    def bit_equal(a, b):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))

    trajectory = {
        name: bit_equal(runs[name]["final"], runs[name + "_off"]["final"])
        for name in ("eager", "fused", "ring")
    }
    trajectory["scanned"] = bit_equal(
        runs["scanned"]["final"], runs["scanned_off"]["final"]) and bit_equal(
        runs["scanned"]["loss_stream"], runs["scanned_off"]["loss_stream"])
    trajectory["eager_steps"] = bit_equal(runs["eager"]["traj"],
                                          runs["eager_off"]["traj"])
    trajectory["ring_steps"] = bit_equal(runs["ring"]["traj"],
                                         runs["ring_off"]["traj"])

    ref = runs["eager"]["obs"]
    observations = {}
    deviations = {}
    for name in ("fused", "scanned", "ring"):
        obs = runs[name]["obs"]
        fields = {k: bit_equal(obs[k], ref[k]) for k in ref}
        observations[name + "_vs_eager"] = all(fields.values())
        deviations[name + "_vs_eager"] = {
            k: float(np.max(np.abs(np.asarray(obs[k], np.float64)
                                   - np.asarray(ref[k], np.float64))))
            for k in ref}
    return {"trajectory_bitwise": trajectory,
            "observations_bitwise": observations,
            "max_abs_deviation": deviations,
            "all_pass": all(trajectory.values())
            and all(observations.values())}


# ---------------------------------------------------------------------------
# Theorem 5: estimators against the closed forms (numpy, on the host)


def theorem5_report(cfg: AuditConfig) -> dict:
    lam_bar, kappa = cfg.est_lam_bar, cfg.est_kappa
    g, y = PE.sample_observations(lam_bar, kappa, cfg.samples,
                                  seed=cfg.seed + 3)
    theta_cl = E.theta_closed(lam_bar, kappa)
    h_y_cl = E.product_entropy_closed(lam_bar, kappa)
    report = {
        "lam_bar": lam_bar, "kappa": kappa, "samples": cfg.samples,
        "h_y_closed": h_y_cl,
        "h_y_binned": PE.binned_entropy(y),
        "h_y_knn": PE.knn_entropy(y),
        "theta_closed": theta_cl,
        "theta_binned": PE.estimate_theta(y, lam_bar, kappa,
                                          method="binned"),
        "theta_knn": PE.estimate_theta(y, lam_bar, kappa, method="knn"),
        "mse_lower_bound": E.mse_lower_bound(theta_cl),
        "empirical_best_estimator_mse": PE.empirical_recovery_floor(g, y),
    }
    report["theta_abs_err_binned"] = abs(report["theta_binned"] - theta_cl)
    report["theta_abs_err_knn"] = abs(report["theta_knn"] - theta_cl)
    report["floor_respected"] = bool(
        report["empirical_best_estimator_mse"] >= report["mse_lower_bound"])
    return report


# ---------------------------------------------------------------------------
# attacks: DSGD recovers, PDSGD does not


def _estimation_workload(cfg: AuditConfig, device):
    from ..data import estimation_problem
    m = cfg.agents
    top = (make_topology("paper_fig1", 5) if m == 5
           else make_topology("ring", m))
    prob = estimation_problem(m, d=2, s=3, n_per_agent=100, seed=cfg.seed)
    Z, M = prob["Z"], prob["M"]

    def loss(p, batch):
        z, Mi = batch
        return torch.mean(torch.sum((z - p @ Mi.T) ** 2, -1))

    rng = np.random.default_rng(cfg.seed)
    T = cfg.attack_steps + 1
    idx = rng.integers(0, 100, size=(T, m, 8))
    z = Z[np.arange(m)[None, :, None], idx]
    Ms = np.broadcast_to(M[None], (T,) + M.shape)
    batches = (torch.from_numpy(np.ascontiguousarray(z)).to(device),
               torch.from_numpy(np.ascontiguousarray(Ms)).to(device))
    return top, loss, batches


def _observed_run(cfg: AuditConfig, algorithm: str, device):
    """T+1 audited steps of the estimation workload, scanned; the stacked
    records on the host."""
    top, loss, batches = _estimation_workload(cfg, device)
    sched = S.paper_experiment(cfg.lam_base)
    step = make_decentralized_step(loss, top, sched, algorithm=algorithm,
                                   observer=O.auditor(),
                                   grad_clip=cfg.kappa)
    T = cfg.attack_steps + 1
    scanned = make_scanned_steps(step, T)
    keys = per_step_keys(prng.key(cfg.seed + 4), 0, T)
    state = init_state(torch.zeros((2,), device=device), cfg.agents)
    _, aux = scanned(state, batches, keys)
    obs = _host_tree(aux["observation"])
    lam_stream = np.asarray(sched(np.arange(T, dtype=np.float64), 0),
                            np.float32)
    return obs, lam_stream


def attack_report(cfg: AuditConfig, device="cpu") -> dict:
    T = cfg.attack_steps
    obs_d, lam_d = _observed_run(cfg, "dsgd", device)
    x_stream = A.states_from_broadcast(obs_d["v"], obs_d["support"])
    g_hat_d = A.dsgd_exact_recovery(x_stream, torch.from_numpy(
        obs_d["W"][0]), torch.from_numpy(lam_d[:T]))
    mse_dsgd = A.recovery_mse(g_hat_d, torch.from_numpy(obs_d["g"][:T]))
    g_scale = float(np.mean(np.asarray(obs_d["g"][:T]) ** 2))

    obs_p, lam_p = _observed_run(cfg, "pdsgd", device)
    g_true = torch.from_numpy(obs_p["g"][:T])
    g_hat_p = A.pdsgd_ls_recovery(
        torch.from_numpy(obs_p["v"][:T]), torch.from_numpy(obs_p["x"][:T]),
        torch.from_numpy(obs_p["W"][:T]),
        torch.from_numpy(obs_p["support"][:T]), torch.from_numpy(lam_p[:T]))
    mse_pdsgd = A.recovery_mse(g_hat_p, g_true)

    kappa_eff = (cfg.kappa if cfg.kappa is not None
                 else float(np.max(np.abs(np.asarray(obs_p["g"][:T])))))
    theta = E.theta_closed(cfg.lam_base, kappa_eff)
    bound = E.mse_lower_bound(theta)

    report = {
        "steps": T,
        "dsgd_exact_recovery_mse": mse_dsgd,
        "dsgd_recovery_rel_err": mse_dsgd / max(g_scale, 1e-30),
        "pdsgd_ls_recovery_mse": mse_pdsgd,
        "gradient_mean_square": g_scale,
        "kappa": kappa_eff,
        "kappa_source": "grad_clip" if cfg.kappa is not None else "max|g|",
        "theorem5_theta": theta,
        "theorem5_mse_bound": bound,
        "pdsgd_mse_over_bound": mse_pdsgd / max(bound, 1e-30),
        "pdsgd_respects_bound": bool(mse_pdsgd >= bound),
        "recovery_gap": mse_pdsgd / max(mse_dsgd, 1e-30),
    }
    if cfg.dlg_steps > 0:
        report["dlg"] = _dlg_report(cfg, device)
    return report


def _dlg_model(seed: int, device):
    """The Sec. VII digits model and its loss, the reference's weights."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    params = {"w1": t(rng.normal(size=(36, 24)).astype(np.float32) * 0.3),
              "b1": torch.zeros((24,), device=device),
              "w2": t(rng.normal(size=(24, 4)).astype(np.float32) * 0.3),
              "b2": torch.zeros((4,), device=device)}

    def loss(p, x, soft):
        h = torch.tanh(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"])
        return -torch.mean(torch.sum(
            soft * torch.log_softmax(h @ p["w2"] + p["b2"], dim=-1), -1))

    return params, loss


def _dlg_report(cfg: AuditConfig, device="cpu") -> dict:
    """The Sec. VII DLG sweep on the digits model: the exact gradient
    (conventional DSGD's observable) against the Lambda∘g observation."""
    from ..core.privacy import obfuscated_gradient
    from ..data import synthetic_digits

    params, loss = _dlg_model(cfg.seed, device)
    x, yl = synthetic_digits(1, seed=cfg.seed + 5, size=6, classes=4)
    x = torch.from_numpy(x).to(device)
    soft = torch.nn.functional.one_hot(torch.from_numpy(yl).long(),
                                       4).float().to(device)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    names = sorted(params)
    gl = torch.autograd.grad(loss(dict(zip(names, leaves)), x, soft), leaves)
    g = dict(zip(names, gl))
    res_c = A.dlg_attack(loss, params, g, tuple(x.shape), 4,
                         key=prng.key(cfg.seed), steps=cfg.dlg_steps,
                         lr=0.1, true_x=x)
    obs = obfuscated_gradient(prng.key(cfg.seed + 6), g, cfg.lam_base)
    res_p = A.dlg_attack(loss, params, obs, tuple(x.shape), 4,
                         key=prng.key(cfg.seed), steps=cfg.dlg_steps,
                         lr=0.1, true_x=x)
    mse_c = float(torch.mean((res_c.recon_x - x) ** 2))
    mse_p = float(torch.mean((res_p.recon_x - x) ** 2))
    return {"steps": cfg.dlg_steps, "conventional_mse": mse_c,
            "pdsgd_mse": mse_p,
            "degradation": mse_p / max(mse_c, 1e-30)}


# ---------------------------------------------------------------------------
# capture overhead


def _timed(fn, device) -> float:
    """Seconds ``fn()`` takes: on the card between CUDA events recorded
    around it on the current stream, elsewhere on the host clock."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize(device)
        return t0.elapsed_time(t1) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _overhead_report(cfg: AuditConfig, device="cpu") -> dict:
    """Microseconds a step of the scanned step on the estimation workload
    (static, as the reference's: ``dropout`` does not reach it), capture
    off and on (the external eavesdropper).  Each is called once first
    (on the card: the warm-up chunk and the graph's capture), then both
    are called in turns ``_OVERHEAD_ROUNDS`` times from the same x^0 — on
    the card each call a replay of the graph between CUDA events — and
    the median of each is reported."""
    top, loss, batches = _estimation_workload(cfg, device)
    sched = S.paper_experiment(cfg.lam_base)
    T = cfg.attack_steps + 1
    keys = per_step_keys(prng.key(cfg.seed + 4), 0, T)
    runs = {}
    for name, observer in (("capture_off", None),
                           ("capture_on", O.external_eavesdropper())):
        step = make_decentralized_step(loss, top, sched, observer=observer)
        scanned = make_scanned_steps(step, T)
        state = init_state(torch.zeros((2,), device=device), cfg.agents)
        init = state.flat.clone()
        scanned(state, batches, keys)  # on the card: warm-up and capture
        runs[name] = (scanned, state, init)
    times = {name: [] for name in runs}
    for _ in range(_OVERHEAD_ROUNDS):
        for name, (scanned, state, init) in runs.items():
            state.flat.copy_(init)
            st = DecentralizedState(flat=state.flat, layout=state.layout)
            times[name].append(_timed(
                functools.partial(scanned, st, batches, keys), device)
                / T * 1e6)
    med = {name: statistics.median(t) for name, t in times.items()}
    return {"us_per_step": {k: round(v, 2) for k, v in med.items()},
            "capture_overhead": round(
                med["capture_on"] / med["capture_off"], 3)}


# ---------------------------------------------------------------------------


def run_audit(cfg: AuditConfig, out: str | None = None,
              device="cpu") -> dict:
    report = {
        "audit": audit_fingerprint(cfg),
        "adversary_models": list(O.ADVERSARY_KINDS),
        "parity": parity_report(cfg, device),
        "theorem5": theorem5_report(cfg),
        "attacks": attack_report(cfg, device),
        "overhead": _overhead_report(cfg, device),
    }
    report["ok"] = bool(
        report["parity"]["all_pass"]
        and report["theorem5"]["floor_respected"]
        and report["attacks"]["pdsgd_respects_bound"]
        and report["attacks"]["dsgd_recovery_rel_err"] < 1e-4)
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2)
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    d = AuditConfig()
    p.add_argument("--agents", type=int, default=d.agents)
    p.add_argument("--dim", type=int, default=d.dim)
    p.add_argument("--parity-steps", type=int, default=d.parity_steps)
    p.add_argument("--attack-steps", type=int, default=d.attack_steps)
    p.add_argument("--lam-base", type=float, default=d.lam_base)
    p.add_argument("--grad-clip-kappa", type=float, default=None)
    p.add_argument("--samples", type=int, default=d.samples)
    p.add_argument("--est-lam-bar", type=float, default=d.est_lam_bar)
    p.add_argument("--est-kappa", type=float, default=d.est_kappa)
    p.add_argument("--dlg-steps", type=int, default=d.dlg_steps)
    p.add_argument("--topology-dropout", type=float, default=d.dropout)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--out", default="privacy_report.json")
    p.add_argument("--device", default="cuda",
                   help="torch device to run the paths on (default cuda)")
    return p


def config_from_args(args) -> AuditConfig:
    return AuditConfig(
        agents=args.agents, dim=args.dim, parity_steps=args.parity_steps,
        attack_steps=args.attack_steps, lam_base=args.lam_base,
        kappa=args.grad_clip_kappa, samples=args.samples,
        est_lam_bar=args.est_lam_bar, est_kappa=args.est_kappa,
        dlg_steps=args.dlg_steps, dropout=args.topology_dropout,
        seed=args.seed)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to audit on the CPU)")
    report = run_audit(config_from_args(args), out=args.out, device=device)
    print(json.dumps({
        "privacy_audit": "ok" if report["ok"] else "FAILED",
        "parity_all_pass": report["parity"]["all_pass"],
        "theta_closed": report["theorem5"]["theta_closed"],
        "theta_knn": report["theorem5"]["theta_knn"],
        "dsgd_recovery_mse": report["attacks"]["dsgd_exact_recovery_mse"],
        "pdsgd_recovery_mse": report["attacks"]["pdsgd_ls_recovery_mse"],
        "mse_bound": report["attacks"]["theorem5_mse_bound"],
        "report": args.out,
    }))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
