"""The wire-tap on the port's step and the audit entry point
(`core.pdsgd.make_decentralized_step(observer=...)`, `make_scanned_steps`,
`core.mixing.MixingProcess.realize` on a device counter,
`launch.audit`, ``launch.train --privacy-audit``) against the reference on
the CPU, on the same numpy inputs; the card-only checks are marked gpu.

Measured deviations behind the tolerances (this CPU):
* step records against the reference's: B^k's exponential draws differ
  by up to an ulp (`prng.exponential`), and the states then by ulps; every
  field within 1e-6 relative + 1e-7 absolute over 4 steps (held at rtol
  1e-5, atol 1e-7);
* within the port: capture-on == capture-off and the four paths' streams
  bitwise (eager oracle, kernels' plain versions, scanned loop, ring
  form), the ring layout's record == the concat layout's in f32;
* `run_audit` against the reference's on the same small config:
  ``theorem5`` equal exactly (numpy on the same samples); the attack
  numbers within 1e-4 relative (recovery MSEs of f32 inversions: the
  exact DSGD recovery's MSE is rounding noise, ~1e-14, held at its
  relative error < 1e-6 in both).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_state as jax_init_state
from repro.core import make_decentralized_step as jax_step
from repro.core import make_mixing as jax_make_mixing
from repro.core import make_topology as jax_topology
from repro.core import schedules as JS
from repro.launch import audit as JAU
from repro.launch.steps import per_step_keys as jax_keys
from repro.privacy import observe as JO
from repro_torch.core import prng
from repro_torch.core import schedules as S
from repro_torch.core.mixing import make_mixing
from repro_torch.core.pdsgd import (init_state, make_decentralized_step,
                                    make_scanned_steps)
from repro_torch.core.topology import make_topology
from repro_torch.faults import make_faults
from repro_torch.launch import audit as AU
from repro_torch.launch.steps import per_step_keys
from repro_torch.privacy import observe as O

M, D, T = 5, 3, 4


def _batch(seed=0):
    return np.random.default_rng(seed).normal(size=(M, D)).astype(
        np.float32)


def _port_loss(p, b):
    return torch.sum((p - b) ** 2)


def _jax_loss(p, b):
    return jnp.sum((p - b) ** 2)


def _port_run(observer, steps=T, rate=0.0, topo="ring", **kw):
    proc = make_mixing(make_topology(topo, M), rate=rate, seed=1)
    step = make_decentralized_step(_port_loss, proc,
                                   S.paper_experiment(0.05),
                                   observer=observer, **kw)
    state = init_state(torch.zeros(D), M, algorithm=kw.get("algorithm",
                                                           "pdsgd"))
    keys = per_step_keys(prng.key(2), 0, steps)
    batch = torch.from_numpy(_batch())
    traj, obs = [], []
    for k in range(steps):
        state, aux = step(state, batch, keys[k])
        traj.append(state.flat[:, :D].clone())
        obs.append(aux.get("observation"))
    return torch.stack(traj), obs


def _jax_run(observer, steps=T, rate=0.0, topo="ring", **kw):
    proc = jax_make_mixing(jax_topology(topo, M), rate=rate, seed=1)
    step = jax_step(_jax_loss, proc, JS.paper_experiment(0.05),
                    use_pallas=False, donate=False, observer=observer, **kw)
    state = jax_init_state(jnp.zeros((D,)), M,
                           algorithm=kw.get("algorithm", "pdsgd"))
    keys = jax_keys(jax.random.key(2), 0, steps)
    obs = []
    for k in range(steps):
        state, aux = step(state, jnp.asarray(_batch()), keys[k])
        obs.append(jax.tree.map(np.asarray, aux["observation"]))
    return obs


# -- the step's records against the reference -------------------------------

@pytest.mark.parametrize("case", [
    ("pdsgd_eager", {"eager": True}, {}),
    ("pdsgd_fused", {}, {}),
    ("pdsgd_fused_bits", {"kernel_rng": False}, {}),
    ("dsgd", {"algorithm": "dsgd"}, {"algorithm": "dsgd"}),
    ("dp_dsgd", {"algorithm": "dp_dsgd", "sigma_dp": 0.01},
     {"algorithm": "dp_dsgd", "sigma_dp": 0.01}),
], ids=lambda c: c[0])
@pytest.mark.parametrize("rate", [0.0, 0.4], ids=["static", "dropout"])
def test_step_records_against_reference(case, rate):
    _, port_kw, jax_kw = case
    _, got = _port_run(O.auditor(), rate=rate, **port_kw)
    want = _jax_run(JO.auditor(), rate=rate, **jax_kw)
    for k in range(T):
        assert set(got[k]) == set(want[k])
        for f, w in want[k].items():
            assert got[k][f].dtype == torch.float32
            assert tuple(got[k][f].shape) == w.shape, f
            np.testing.assert_allclose(got[k][f].numpy(), w, rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {k} {f}")
    if rate:
        sup = np.stack([o["support"].numpy() for o in got])
        base = make_topology("ring", M).adjacency.astype(np.float32)
        assert (sup < base[None]).any()


@pytest.mark.parametrize("adv", [O.external_eavesdropper(),
                                 O.curious_neighbor(1)],
                         ids=["eavesdropper", "curious_neighbor"])
def test_adversary_views_on_the_step(adv):
    """A view built by the step (only the fields it reads) equals the view
    of the auditor's record, and the reference's within tolerance."""
    traj_v, got = _port_run(adv)
    traj_a, full = _port_run(O.auditor())
    assert torch.equal(traj_v, traj_a)
    jadv = (JO.external_eavesdropper() if adv.kind != "curious_neighbor"
            else JO.curious_neighbor(1))
    want = _jax_run(jadv)
    for k in range(T):
        view = O.adversary_view(adv, full[k])
        assert set(got[k]) == set(view) == set(want[k])
        for f in view:
            assert torch.equal(got[k][f], view[f]), f
            np.testing.assert_allclose(got[k][f].numpy(), want[k][f],
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kernel_rng", [True, False], ids=["krng", "bits"])
@pytest.mark.parametrize("rate", [0.0, 0.4], ids=["static", "dropout"])
def test_ring_layout_record_equals_concat_bitwise(kernel_rng, rate):
    """From the same state, the ring kernel's own messages (its plain
    version here), scattered to the dense V, equal the concat layout's
    record in f32, every field (x' itself differs by the two layouts'
    summation orders, so each step starts both from the concat state)."""
    proc = make_mixing(make_topology("ring", M), rate=rate, seed=1)

    def build(observer, layout):
        return make_decentralized_step(
            _port_loss, proc, S.paper_experiment(0.05), observer=observer,
            kernel_rng=kernel_rng, kernel_layout=layout)

    ring, ring_off = build(O.auditor(), "ring"), build(None, "ring")
    eav = build(O.external_eavesdropper(), "ring")
    concat = build(O.auditor(), "concat")
    state = init_state(torch.zeros(D), M)
    keys = per_step_keys(prng.key(2), 0, T)
    batch = torch.from_numpy(_batch())

    def fork(st):
        return type(st)(flat=st.flat.clone(), layout=st.layout,
                        step=st.step)

    for k in range(T):
        sr, ar = ring(fork(state), batch, keys[k])
        so, _ = ring_off(fork(state), batch, keys[k])
        _, ae = eav(fork(state), batch, keys[k])
        state, ac = concat(state, batch, keys[k])
        assert torch.equal(sr.flat, so.flat)
        assert set(ar["observation"]) == set(ac["observation"])
        for f, t in ac["observation"].items():
            assert torch.equal(ar["observation"][f], t), (k, f)
        assert set(ae["observation"]) == {"v", "support"}
        assert torch.equal(ae["observation"]["v"], ac["observation"]["v"])
        torch.testing.assert_close(sr.flat, state.flat, rtol=0, atol=1e-7)


@pytest.mark.parametrize("kw", [{"eager": True}, {}, {"algorithm": "dsgd"},
                                {"algorithm": "dp_dsgd", "sigma_dp": 0.01},
                                {"kernel_layout": "ring"}],
                         ids=["eager", "fused", "dsgd", "dp_dsgd", "ring"])
def test_capture_never_perturbs_the_trajectory(kw):
    for rate in (0.0, 0.4):
        on, _ = _port_run(O.auditor(), rate=rate, **kw)
        off, _ = _port_run(None, rate=rate, **kw)
        assert torch.equal(on, off)


def test_capture_composes_with_crash_faults():
    """Crash/restart faults with the observer (`tests/test_faults.py`'s
    combination): the same bits as without it; the record's x is the held
    state the update read."""
    faults = make_faults(M, crash_rate=0.3, restart_rate=0.5, seed=4)
    on, obs = _port_run(O.auditor(), steps=6, faults=faults)
    off, _ = _port_run(None, steps=6, faults=faults)
    assert torch.equal(on, off)
    for k in range(1, 6):
        assert torch.equal(obs[k]["x"], on[k - 1])


def test_observer_refusals():
    top = make_topology("ring", 4)
    sched = S.harmonic(0.1)
    with pytest.raises(ValueError, match="dsgt"):
        make_decentralized_step(_port_loss, top, sched, algorithm="dsgt",
                                observer=O.auditor())
    with pytest.raises(ValueError, match="corrupt links"):
        make_decentralized_step(_port_loss, top, sched,
                                observer=O.auditor(),
                                faults=make_faults(4, corrupt_rate=0.2))
    with pytest.raises(ValueError, match="trimmed-mean|raw neighbor"):
        make_decentralized_step(_port_loss, top, sched,
                                observer=O.auditor(),
                                aggregation="trimmed_mean")
    with pytest.raises(ValueError, match="leafwise"):
        make_decentralized_step(_port_loss, top, sched,
                                observer=O.auditor(),
                                kernel_layout="leafwise")


# -- the oracle's mix on the card: B2's fused multiply-add chain -----------

def _fmaf(a, b, c) -> np.float32:
    """C's fmaf on float32 scalars, from exact rational arithmetic: the
    float32 nearest a * b + c, ties to even."""
    from fractions import Fraction
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(v))
    cands = (np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf)))
    return min(cands, key=lambda t: (abs(Fraction(float(t)) - v),
                                     int(np.float32(t).view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """`fma_f32` equals fmaf on random operands over 16 decades of c and on
    sums that f64 rounds onto a float32 tie (there a sum rounded in f64,
    then to f32, is one ulp off)."""
    from repro_torch.core.pdsgd import fma_f32
    rng = np.random.default_rng(0)
    n = 600
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    c = (rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n)).astype(
        np.float32)
    tie = [(1 + 2.0 ** -23, 2.0 ** -24 * (1 - 2.0 ** -23)),
           (1 + 2.0 ** -23, 2.0 ** -24),
           (1 - 2.0 ** -24, 2.0 ** -24 * (1 + 2.0 ** -22)),
           (-(1 + 2.0 ** -23), 2.0 ** -24 * (1 - 2.0 ** -23))]
    ta, tb, tc = zip(*[(x, y, 1.0 + k * 2.0 ** -23) for k in range(8)
                       for x, y in tie])
    a = np.concatenate([a, np.float32(ta)])
    b = np.concatenate([b, np.float32(tb)])
    c = np.concatenate([c, np.float32(tc)])
    got = fma_f32(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    want = np.array([_fmaf(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want).any()  # the ties do reach the correction


def test_fma_gossip_mix_is_the_ascending_chain():
    """`fma_gossip_mix` is B2's per-row chain fmaf(w_ij, x_j, acc) over
    ascending j from 0; on the CPU `oracle_mix` is `gossip_mix`."""
    from repro_torch.core.pdsgd import fma_gossip_mix, gossip_mix, oracle_mix
    rng = np.random.default_rng(1)
    W = rng.random((M, M)).astype(np.float32)
    X = rng.normal(size=(M, 2, 3)).astype(np.float32)
    got = fma_gossip_mix(torch.from_numpy(W), torch.from_numpy(X)).numpy()
    assert got.shape == X.shape
    flat = X.reshape(M, -1)
    for i in range(M):
        for t in range(flat.shape[1]):
            acc = np.float32(0.0)
            for j in range(M):
                acc = _fmaf(W[i, j], flat[j, t], acc)
            assert got.reshape(M, -1)[i, t] == acc, (i, t)
    assert torch.equal(oracle_mix(torch.from_numpy(W), torch.from_numpy(X)),
                       gossip_mix(torch.from_numpy(W), torch.from_numpy(X)))


# -- the device counter: realize and the step's inner ----------------------

@pytest.mark.parametrize("kw", [{"rate": 0.4}, {"resample_every": 3}],
                         ids=["dropout", "resample"])
def test_realize_and_inner_on_a_counter_tensor_bitwise(kw):
    """`MixingProcess.realize` on a 0-d int64 counter (the CUDA graph's)
    equals the int-step realization bit for bit, and so does the step's
    ``inner`` driven by the counter, observation included."""
    proc = make_mixing(make_topology("ring", M), seed=3, **kw)
    for k in range(9):
        a = proc.realize(k)
        b = proc.realize(torch.tensor(k))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y), k
    step = make_decentralized_step(_port_loss, proc,
                                   S.paper_experiment(0.05),
                                   observer=O.auditor())
    sa, sb = init_state(torch.zeros(D), M), init_state(torch.zeros(D), M)
    keys = per_step_keys(prng.key(2), 0, 6)
    batch = torch.from_numpy(_batch())
    counter = torch.zeros((), dtype=torch.int64)
    for k in range(6):
        sa, aa = step.inner(sa, batch, keys[k], k)
        sb, ab = step.inner(sb, batch, keys[k], counter)
        counter += 1
        assert torch.equal(sa.flat, sb.flat)
        for f in aa["observation"]:
            assert torch.equal(aa["observation"][f], ab["observation"][f])
    assert step.graph_refusal is None


def test_scanned_observations_stack_as_the_eager_loop():
    proc = make_mixing(make_topology("ring", M), rate=0.4, seed=1)
    step = make_decentralized_step(_port_loss, proc,
                                   S.paper_experiment(0.05),
                                   observer=O.external_eavesdropper())
    _, eager = _port_run(O.external_eavesdropper(), steps=6, rate=0.4)
    scanned = make_scanned_steps(step, 3)
    state = init_state(torch.zeros(D), M)
    keys = per_step_keys(prng.key(2), 0, 6)
    batches = torch.from_numpy(_batch())[None].expand(3, M, D)
    got = []
    for c in range(2):
        state, aux = scanned(state, batches, keys[3 * c:3 * c + 3])
        assert aux["observation"]["v"].shape == (3, M, M, D)
        got += [{f: t[i] for f, t in aux["observation"].items()}
                for i in range(3)]
    for g, e in zip(got, eager):
        assert all(torch.equal(g[f], e[f]) for f in e)


# -- the audit entry point ---------------------------------------------------

SMALL = dict(agents=5, dim=2, parity_steps=3, attack_steps=12,
             samples=30_000)


@pytest.fixture(scope="module")
def reports():
    port = AU.run_audit(AU.AuditConfig(**SMALL), device="cpu")
    ref = JAU.run_audit(JAU.AuditConfig(**SMALL))
    return port, ref


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_run_audit_against_reference(reports):
    port, ref = reports
    assert port["ok"] and ref["ok"]
    assert _keys(port) == _keys(ref)
    assert port["audit"] == ref["audit"]
    assert port["adversary_models"] == ref["adversary_models"]
    assert port["theorem5"] == ref["theorem5"]
    assert port["parity"]["all_pass"]
    assert all(v == 0.0 for dev in port["parity"]["max_abs_deviation"]
               .values() for v in dev.values())
    pa, ra = port["attacks"], ref["attacks"]
    for k in ("pdsgd_ls_recovery_mse", "gradient_mean_square", "kappa",
              "theorem5_theta", "theorem5_mse_bound",
              "pdsgd_mse_over_bound"):
        assert pa[k] == pytest.approx(ra[k], rel=1e-4), k
    assert pa["dsgd_recovery_rel_err"] < 1e-6
    assert ra["dsgd_recovery_rel_err"] < 1e-6
    assert pa["pdsgd_respects_bound"] and pa["recovery_gap"] > 1e6
    assert pa["steps"] == ra["steps"] and pa["kappa_source"] == "max|g|"


def test_parity_under_dropout_and_the_wire_content():
    """The time-varying scenario: the four paths agree bit for bit, a
    link dropped, and V is w x - b u on realized links, zero off them and
    on the diagonal."""
    cfg = AU.AuditConfig(agents=5, dim=2, parity_steps=5, dropout=0.4)
    runs = AU.capture_trajectories(cfg)
    rep = AU.parity_report(cfg, runs=runs)
    assert rep["all_pass"], rep
    obs = runs["eager"]["obs"]
    base = make_topology("ring", 5).adjacency.astype(np.float32)
    assert (obs["support"] < base[None]).any()
    v, W, B, x, u, sup = (obs[k] for k in ("v", "W", "B", "x", "u",
                                           "support"))
    for k in range(v.shape[0]):
        want = (W[k][:, :, None] * x[k][None] - B[k][:, :, None]
                * u[k][None]) * (1.0 - np.eye(5))[:, :, None]
        np.testing.assert_array_equal(v[k], want.astype(np.float32))
        assert np.all(v[k][sup[k] == 0.0] == 0.0)


def test_audit_cli_writes_report(tmp_path):
    out = tmp_path / "r.json"
    rc = AU.main(["--device", "cpu", "--agents", "4", "--dim", "2",
                  "--parity-steps", "2", "--attack-steps", "6",
                  "--samples", "20000", "--out", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["audit"]["version"] == AU.AUDIT_VERSION
    assert rep["audit"] == JAU.audit_fingerprint(JAU.AuditConfig(
        agents=4, dim=2, parity_steps=2, attack_steps=6, samples=20000))
    assert AU.build_parser().parse_args([]).device == "cuda"


def test_train_privacy_audit_wiring(tmp_path, monkeypatch):
    """``--privacy-audit``: the reference's AuditConfig from the run's
    flags, the audit run after training, privacy_report.json in the
    working directory."""
    from repro.launch.train import build_parser as jax_parser
    from repro_torch.launch import train as TR
    flags = ["--agents", "4", "--grad-clip-kappa", "2.5",
             "--topology-dropout", "0.3", "--seed", "5", "--privacy-audit"]
    args = TR.build_parser().parse_args(flags)
    jargs = jax_parser().parse_args(flags)
    assert args.privacy_audit and jargs.privacy_audit
    assert AU.audit_fingerprint(TR.audit_config(args)) == \
        JAU.audit_fingerprint(JAU.AuditConfig(
            agents=jargs.agents, kappa=jargs.grad_clip_kappa,
            dropout=jargs.topology_dropout, seed=jargs.seed))
    assert not TR.build_parser().parse_args([]).privacy_audit
    # the run: a small audit config (the wiring, not the audit's cost)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(TR, "audit_config", lambda a: AU.AuditConfig(
        agents=a.agents, kappa=a.grad_clip_kappa, dropout=a.topology_dropout,
        seed=a.seed, parity_steps=2, attack_steps=4, samples=20_000))
    res = TR.run_training(TR.build_parser().parse_args(
        ["--arch", "stablelm-3b-tiny", "--steps", "1", "--seq-len", "32",
         "--device", "cpu", *flags]))
    rep = json.loads((tmp_path / "privacy_report.json").read_text())
    assert res["privacy_audit"]["ok"] and rep["ok"]
    assert rep["audit"]["kappa"] == 2.5 and rep["audit"]["dropout"] == 0.3
    assert rep["attacks"]["kappa_source"] == "grad_clip"


# -- on the card -------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and the CUDA graph run "
                    "only there")


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, {"kernel_rng": False},
                                {"kernel_layout": "ring"},
                                {"algorithm": "dsgd"}],
                         ids=["concat", "bits", "ring", "dsgd"])
def test_cuda_capture_never_perturbs(kw):
    """On the card through the kernels: capture-on == capture-off bitwise,
    and the record matches the CPU run's within the kernels' rounding."""
    _need_cuda()
    dev = torch.device("cuda")
    proc = make_mixing(make_topology("ring", M), rate=0.4, seed=1)
    runs = []
    for observer in (O.auditor(), None):
        step = make_decentralized_step(_port_loss, proc,
                                       S.paper_experiment(0.05),
                                       observer=observer, **kw)
        state = init_state(torch.zeros(D), M, device=dev)
        keys = per_step_keys(prng.key(2), 0, T)
        batch = torch.from_numpy(_batch()).to(dev)
        obs = []
        for k in range(T):
            state, aux = step(state, batch, keys[k])
            obs.append(aux.get("observation"))
        runs.append((state.flat.clone(), obs))
    assert torch.equal(runs[0][0], runs[1][0])
    _, cpu = _port_run(O.auditor(), rate=0.4, **kw)
    for g, c in zip(runs[0][1], cpu):
        for f in c:
            np.testing.assert_allclose(g[f].cpu().numpy(), c[f].numpy(),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["static", "dropout"])
def test_cuda_audit_ok(dropout):
    """The audit on the card: capture never perturbs, the four paths'
    streams bitwise (the oracle and the dense ring form sum as B2 does,
    `core.pdsgd.oracle_mix`), so every deviation is 0 and the report is
    ok; theorem5 equal to the CPU's."""
    _need_cuda()
    cfg = AU.AuditConfig(**SMALL, dropout=dropout)
    rep = AU.run_audit(cfg, device="cuda")
    par = rep["parity"]
    assert all(par["trajectory_bitwise"].values()), par
    for path, same in par["observations_bitwise"].items():
        dev = par["max_abs_deviation"][path]
        assert same == all(v == 0.0 for v in dev.values()), (path, dev)
    assert all(par["observations_bitwise"].values()), par
    assert rep["ok"]
    assert rep["theorem5"] == AU.theorem5_report(cfg)
    assert rep["attacks"]["pdsgd_respects_bound"]
