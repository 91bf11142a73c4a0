"""The port's agent faults (`repro_torch.faults`, the guarded gossip plain
version, the faulty step) against the reference on the CPU, inputs made
from numpy seeds.

Tolerances:
* fault realizations and composed couplings: bitwise over 128 steps (a
  Markov outage length comes from ``log1p`` and ``floor``; if torch's
  ``log1p`` ever forked one from XLA's, the test names the step);
* `poison_transmit`, `finite_guard`, `neighbor_avg_warmstart`: bitwise on
  explicit inputs; `trimmed_mean_mix`: rtol 1e-6 (the mean of the kept
  entries is summed in another order: 1.2e-7 measured);
  `guarded_gossip_mix`: its link sum runs in another order, so f32 values
  within 1e-6 of the summed magnitude, non-finite positions exact;
* B6's plain version against the interpreted Pallas kernel: non-finite
  positions exact; finite entries in f32 within 1e-6 (1 + S), S the sum
  of the terms' magnitudes (large clipped links can cancel), in bf16
  within one bf16 ulp of the reference (+ 1e-6 S);
* the fused step against the port's eager step under faults: rtol/atol
  1e-5 after 40 steps (the guarded sums run in another order);
* the Fig. 2 workload with crash and corrupt faults: final error within
  rtol 1e-6 of the reference's, parameters within atol 1e-7 (measured
  2.3e-10 after 300 steps), fault counters equal step for step.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import init_state as jax_init_state
from repro.core import make_decentralized_step as jax_make_step
from repro.core import make_mixing as jax_make_mixing
from repro.core import make_topology as jax_make_topology
from repro.core.schedules import paper_experiment as jax_paper_experiment
from repro.data import estimation_problem
from repro.faults import inject as JI
from repro.faults import make_faults as jax_make_faults
from repro.faults import realize_coupling as jax_realize_coupling
from repro.kernels import guarded_gossip_update as jax_guarded
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.core.mixing import make_mixing
from repro_torch.core.pdsgd import init_state, make_decentralized_step
from repro_torch.core.schedules import paper_experiment, warmup_harmonic
from repro_torch.core.topology import make_topology
from repro_torch.faults import (FaultProcess, finite_guard,
                                guarded_gossip_mix, make_faults,
                                neighbor_avg_warmstart, poison_transmit,
                                realize_coupling, trimmed_mean_mix)
from repro_torch.kernels import guarded_gossip_update, ref
from repro_torch.launch.train import build_faults, build_parser

RNG = np.random.default_rng(21)
MODES = {"markov": dict(crash_rate=0.2, restart_rate=0.5),
         "markov_slow": dict(crash_rate=0.1, restart_rate=0.15),
         "failstop": dict(crash_rate=0.05),
         "corrupt": dict(corrupt_rate=0.3),
         "all": dict(crash_rate=0.15, restart_rate=0.4, corrupt_rate=0.25)}


def _t(a: np.ndarray) -> torch.Tensor:
    return params_from_numpy(np.ascontiguousarray(a))


def _same(a, b):
    """Bitwise equal, nan where the other has nan."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    na, nb = np.isnan(a.astype(np.float32)), np.isnan(b.astype(np.float32))
    np.testing.assert_array_equal(na, nb)
    np.testing.assert_array_equal(a[~na].view(np.uint8) if a.ndim == 0 else
                                  a[~na], b[~nb])


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("m", [4, 5, 16])
@pytest.mark.parametrize("mode", list(MODES))
def test_realize_bitwise_over_128_steps(mode, m):
    kw = dict(MODES[mode], seed=3 + m)
    jf, tf = jax_make_faults(m, **kw), make_faults(m, **kw)
    realize = jax.jit(jf.realize)
    rejoin = jax.jit(jf.rejoin_mask)
    for step in range(128):
        ja, jc = (np.asarray(a) for a in realize(jnp.asarray(step,
                                                            jnp.int32)))
        ta, tc = tf.realize(step)
        assert np.array_equal(ja, ta.numpy()), (
            f"{mode} m={m}: alive forks at step {step}: {ja} vs {ta}")
        assert np.array_equal(jc, tc.numpy()), (
            f"{mode} m={m}: corrupt forks at step {step}")
        np.testing.assert_array_equal(
            np.asarray(rejoin(jnp.asarray(step, jnp.int32))),
            tf.rejoin_mask(step).numpy())
    assert tf.fingerprint() == jf.fingerprint()


def test_realization_is_random_access():
    kw = dict(crash_rate=0.2, restart_rate=0.4, corrupt_rate=0.3, seed=7)
    forward = [make_faults(5, **kw).realize(k) for k in range(20)]
    back = make_faults(5, **kw)
    for k in reversed(range(20)):
        a, c = back.realize(k)
        assert torch.equal(a, forward[k][0]) and torch.equal(c,
                                                             forward[k][1])


@pytest.mark.parametrize("mix", [dict(), dict(rate=0.3, seed=2),
                                 dict(resample_every=3, seed=4)],
                         ids=["static", "dropout", "resample"])
def test_realize_coupling_bitwise(mix):
    m = 6
    jp = jax_make_mixing(jax_make_topology("ring", m), **mix)
    tp = make_mixing(make_topology("ring", m), **mix)
    kw = dict(crash_rate=0.25, restart_rate=0.5, corrupt_rate=0.2, seed=9)
    jf, tf = jax_make_faults(m, **kw), make_faults(m, **kw)
    couple = jax.jit(lambda s: jax_realize_coupling(jp, jf, s))
    for step in range(24):
        want = couple(jnp.asarray(step, jnp.int32))
        got = realize_coupling(tp, tf, step)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                          b.numpy().view(np.int32))


def test_validation_and_fingerprints_mirror_reference():
    with pytest.raises(ValueError, match="crash-mode knob"):
        FaultProcess(num_agents=4, restart_rate=0.5)
    with pytest.raises(ValueError, match="crash-restart"):
        FaultProcess(num_agents=4, crash_rate=0.1, rejoin="neighbor-avg")
    with pytest.raises(ValueError, match="corruption knobs"):
        FaultProcess(num_agents=4, corrupt_mode="inf")
    with pytest.raises(ValueError, match="guard_clip"):
        FaultProcess(num_agents=4, corrupt_rate=0.1, guard_clip=0.0)
    with pytest.raises(ValueError, match="unknown rejoin"):
        make_faults(4, crash_rate=0.1, restart_rate=0.5, rejoin="teleport")
    with pytest.raises(ValueError, match="unknown corrupt_mode"):
        make_faults(4, corrupt_rate=0.1, corrupt_mode="zero")
    assert make_faults(4).is_inert
    for kw in (dict(), dict(corrupt_mode="inf"),
               dict(crash_rate=0.1, seed=3, max_outage=99),
               dict(corrupt_rate=0.2, guard_clip=None),
               dict(corrupt_rate=0.2, corrupt_mode="scale",
                    corrupt_scale=50.0),
               dict(crash_rate=0.1, restart_rate=0.3,
                    rejoin="neighbor-avg", seed=5)):
        assert make_faults(4, **kw).fingerprint() == \
            jax_make_faults(4, **kw).fingerprint()


def test_build_faults_cli_wiring_mirrors_reference():
    from repro.launch.train import build_faults as jax_build_faults
    from repro.launch.train import build_parser as jax_parser
    base = ["--arch", "stablelm-3b-smoke", "--agents", "4", "--steps", "2"]
    assert build_faults(build_parser().parse_args(base)) is None
    for extra in (["--fault-crash-rate", "0.1", "--fault-restart-rate",
                   "0.5", "--fault-guard-clip", "0", "--seed", "11"],
                  ["--fault-corrupt-rate", "0.3", "--fault-corrupt-mode",
                   "scale", "--fault-seed", "4"]):
        got = build_faults(build_parser().parse_args(base + extra))
        want = jax_build_faults(jax_parser().parse_args(base + extra))
        assert got.fingerprint() == want.fingerprint()
    assert build_faults(build_parser().parse_args(
        base + ["--fault-crash-rate", "0.1", "--fault-guard-clip", "0"])
    ).guard_clip is None


# -- the degradation mechanics on explicit inputs ------------------------

@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("mode,scale", [("nan", 1e4), ("inf", 1e4),
                                        ("scale", 1e4), ("scale", 3.7)])
def test_poison_transmit_bitwise(dtype, mode, scale):
    x = RNG.normal(size=(5, 3, 7)).astype(dtype)
    corrupt = np.array([0, 1, 0, 1, 1], np.float32)
    want = np.asarray(JI.poison_transmit(jnp.asarray(x), jnp.asarray(corrupt),
                                         mode, scale))
    got = _np(poison_transmit(_t(x), torch.from_numpy(corrupt), mode, scale))
    _same(want, got)


def test_finite_guard_bitwise():
    v = RNG.normal(size=(4, 4, 33)).astype(np.float32) * 3e3
    v[0, 1, :5] = np.nan
    v[2, 3, 5:9] = np.inf
    v[1, 1, 9:11] = -np.inf
    want = np.asarray(JI.finite_guard(jnp.asarray(v), 1e3))
    _same(want, finite_guard(torch.from_numpy(v), 1e3).numpy())


def _coupling(m, seed=0):
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((m, m)) < 0.6, 1)
    mask = (upper | upper.T).astype(np.float32)
    mask[0, :] = mask[:, 0] = 0.0  # agent 0 down
    support = mask + np.eye(m, dtype=np.float32)
    B = rng.random((m, m)).astype(np.float32) * support
    B = (B / B.sum(0)).astype(np.float32)
    return mask, B


@pytest.mark.parametrize("mode", ["nan", "inf", "scale"])
@pytest.mark.parametrize("clip", [1e3, None])
def test_guarded_gossip_mix_vs_reference(mode, clip):
    m = 5
    mask, B = _coupling(m)
    from repro.core.mixing import metropolis_from_mask
    W = np.array(metropolis_from_mask(jnp.asarray(mask)))
    x = RNG.normal(size=(m, 6, 5)).astype(np.float32)
    u = RNG.normal(size=(m, 6, 5)).astype(np.float32)
    corrupt = np.array([0, 1, 0, 0, 1], np.float32)
    want = np.asarray(JI.guarded_gossip_mix(
        jnp.asarray(W), jnp.asarray(B), jnp.asarray(x), jnp.asarray(u),
        jnp.asarray(corrupt), mode=mode, scale=1e4, clip=clip))
    got = guarded_gossip_mix(*map(torch.from_numpy, (W, B, x, u, corrupt)),
                             mode=mode, scale=1e4, clip=clip).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    # the eager form poisons in f32
    xt = np.asarray(JI.poison_transmit(jnp.asarray(x), jnp.asarray(corrupt),
                                       mode, 1e4))
    ut = np.asarray(JI.poison_transmit(jnp.asarray(u), jnp.asarray(corrupt),
                                       mode, 1e4))
    s = _guarded_scale(mask, B, x.reshape(m, -1), u.reshape(m, -1),
                       xt.reshape(m, -1), ut.reshape(m, -1), clip)
    s = s.reshape(x.shape)
    assert np.all(np.abs(got - want)[fin] <= 1e-6 * (1 + s[fin]))


def test_neighbor_avg_warmstart_bitwise():
    m = 6
    mask, _ = _coupling(m, seed=3)
    x = RNG.normal(size=(m, 4, 3)).astype(np.float32)
    alive = np.array([1, 1, 1, 0, 1, 1], np.float32)
    prev = np.array([1, 0, 1, 1, 0, 1], np.float32)
    want, wr = JI.neighbor_avg_warmstart(jnp.asarray(x), jnp.asarray(mask),
                                         jnp.asarray(alive),
                                         jnp.asarray(prev))
    got, gr = neighbor_avg_warmstart(*map(torch.from_numpy,
                                          (x, mask, alive, prev)))
    np.testing.assert_array_equal(np.asarray(wr), gr.numpy())
    assert gr.sum() == 2
    _same(np.asarray(want), got.numpy())
    assert not np.array_equal(got.numpy()[1], x[1])  # healed


@pytest.mark.parametrize("mode,scale", [("scale", 1e6), ("nan", 1e4),
                                        ("inf", 1e4)])
def test_trimmed_mean_mix_bitwise_on_explicit_inputs(mode, scale):
    """Held on explicit inputs: the reference's own step-level trimmed-mean
    test rests on one seeded realization and fails at take-up."""
    m = 5
    support = np.ones((m, m), np.float32)
    support[0, 3] = support[3, 0] = 0.0
    x = RNG.normal(size=(m, 4, 6)).astype(np.float32)
    u = RNG.normal(size=(m, 4, 6)).astype(np.float32) * 0.1
    corrupt = np.array([0, 0, 1, 0, 0], np.float32)
    want = np.asarray(JI.trimmed_mean_mix(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(support),
        jnp.asarray(corrupt), trim=1, mode=mode, scale=scale))
    got = trimmed_mean_mix(*map(torch.from_numpy, (x, u, support, corrupt)),
                           trim=1, mode=mode, scale=scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(np.abs(got) < 10.0)  # the corrupt sender is out-voted
    with pytest.raises(ValueError, match="trim"):
        trimmed_mean_mix(*map(torch.from_numpy, (x, u, support, corrupt)),
                         trim=3, mode=mode, scale=scale)


# -- B6's plain version against the interpreted Pallas kernel -------------

def _guarded_scale(mask, B, X, U, XT, UT, clip):
    """|self terms| + sum_j |guarded links|, in f32 (nan links count 0)."""
    m = X.shape[0]
    w = ref.metropolis_ref(torch.from_numpy(mask)).numpy()
    eye = np.eye(m, dtype=np.float32)
    x, u = X.astype(np.float32), U.astype(np.float32)
    xt, ut = XT.astype(np.float32), UT.astype(np.float32)
    total = np.abs(np.diag(w)[:, None] * x) + np.abs(np.diag(B)[:, None] * u)
    with np.errstate(invalid="ignore"):
        v = ((w * (1 - eye))[:, :, None] * xt[None]
             - (B * (1 - eye))[:, :, None] * ut[None])
    if clip is not None:
        v = np.clip(v, -clip, clip)
    return total + np.nan_to_num(np.abs(v), nan=0.0, posinf=0.0).sum(1)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("mode", ["nan", "inf", "scale"])
@pytest.mark.parametrize("clip", [1e3, None])
def test_guarded_gossip_plain_vs_pallas(dtype, mode, clip):
    m, n = 5, 1024
    mask, B = _coupling(m, seed=1)
    X = RNG.normal(size=(m, n)).astype(dtype)
    U = RNG.normal(size=(m, n)).astype(dtype)
    corrupt = np.array([0, 1, 0, 0, 1], np.float32)
    XT = np.asarray(JI.poison_transmit(jnp.asarray(X), jnp.asarray(corrupt),
                                       mode, 1e4))
    UT = np.asarray(JI.poison_transmit(jnp.asarray(U), jnp.asarray(corrupt),
                                       mode, 1e4))
    want = np.asarray(jax_guarded(*map(jnp.asarray, (mask, B, X, U, XT, UT)),
                                  clip, interpret=True)).astype(np.float32)
    # the wrapper forms the transmits itself from corrupt/mode/scale
    got = _np(guarded_gossip_update(
        *map(_t, (mask, B, X, U)), clip=clip,
        corrupt=torch.from_numpy(corrupt), mode=mode, scale=1e4)
    ).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    s = _guarded_scale(mask, B, X, U, XT, UT, clip)
    if dtype == np.float32:
        assert np.all(np.abs(got - want)[fin] <= 1e-6 * (1 + s[fin]))
    else:
        spacing = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
        assert np.all(np.abs(got - want)[fin]
                      <= (spacing + 1e-6 * s)[fin])
    if clip is not None:
        assert fin.all()


# -- the faulty step ------------------------------------------------------

def _quadratic(m=5, d=3, seed=0):
    rng = np.random.default_rng(seed)
    targets = rng.normal(size=(m, d)).astype(np.float32)

    def loss(p, b):
        return torch.sum((p - b) ** 2)

    return torch.from_numpy(targets), loss


def _run(step, m, d, batch, steps, start=None):
    state = init_state(torch.zeros(d), m, device="cpu") if start is None \
        else start
    keys = prng.split(prng.key(0), steps)
    aux = []
    for k in range(steps):
        state, a = step(state, batch, keys[k])
        aux.append(a)
    return state, aux


@pytest.mark.parametrize("nan_policy", ["warn", "skip"])
def test_rate_zero_is_bitwise_the_fault_free_step(nan_policy):
    m, d = 5, 3
    batch, loss = _quadratic(m, d)
    top = make_topology("paper_fig1", m)
    plain = make_decentralized_step(loss, top, warmup_harmonic(0.2, hold=5))
    inert = make_decentralized_step(loss, top, warmup_harmonic(0.2, hold=5),
                                    faults=make_faults(m, seed=4),
                                    nan_policy=nan_policy)
    a, _ = _run(plain, m, d, batch, 25)
    b, aux = _run(inert, m, d, batch, 25)
    assert torch.equal(a.flat.view(torch.int32), b.flat.view(torch.int32))
    assert "fault_down" not in aux[-1] and aux[-1]["fault_nonfinite"] == 0


@pytest.mark.parametrize("kw", [
    dict(crash_rate=0.3, restart_rate=0.5, corrupt_rate=0.3,
         corrupt_mode="nan", seed=2),
    dict(crash_rate=0.3, restart_rate=0.5, corrupt_rate=0.3,
         corrupt_mode="scale", corrupt_scale=30.0, rejoin="neighbor-avg",
         seed=5),
    dict(crash_rate=0.1, corrupt_rate=0.2, corrupt_mode="inf", seed=6)],
    ids=["markov_nan", "markov_scale_neighbor_avg", "failstop_inf"])
def test_fused_step_matches_eager_step_with_faults(kw):
    m, d = 5, 3
    batch, loss = _quadratic(m, d)
    top = make_mixing(make_topology("paper_fig1", m), rate=0.2, seed=1)
    faults = make_faults(m, **kw)
    fused = make_decentralized_step(loss, top, warmup_harmonic(0.2, hold=5), faults=faults,
                                    nan_policy="skip")
    eager = make_decentralized_step(loss, top, warmup_harmonic(0.2, hold=5), faults=faults,
                                    nan_policy="skip", eager=True)
    a, aux_a = _run(fused, m, d, batch, 40)
    b, aux_b = _run(eager, m, d, batch, 40)
    assert sum(x["fault_down"] for x in aux_a) > 0
    assert sum(x["fault_corrupt"] for x in aux_a) > 0
    for x, y in zip(aux_a, aux_b):
        for k in ("fault_down", "fault_corrupt", "fault_rejoin"):
            assert x[k] == y[k]
    torch.testing.assert_close(a.flat, b.flat, rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(a.flat).all())


def test_skip_holds_the_pre_update_buffer_on_a_poisoned_unguarded_step():
    m, d = 4, 3
    batch, loss = _quadratic(m, d)
    top = make_topology("ring", m)
    chaos = dict(corrupt_rate=1.0, corrupt_mode="nan", guard_clip=None,
                 seed=1)
    start = init_state(torch.arange(d, dtype=torch.float32) * 0.1, m,
                       device="cpu")
    before = start.flat.clone()
    step = make_decentralized_step(loss, top, warmup_harmonic(0.2, hold=5),
                                   faults=make_faults(m, **chaos),
                                   nan_policy="skip")
    state, aux = step(start, batch, prng.key(3))
    assert aux["fault_nonfinite"] == 1 and aux["fault_corrupt"] == m
    assert state.step == 1
    assert torch.equal(state.flat.view(torch.int32),
                       before.view(torch.int32))
    warn = make_decentralized_step(loss, top, warmup_harmonic(0.2, hold=5),
                                   faults=make_faults(m, **chaos),
                                   nan_policy="warn")
    state, aux = warn(init_state(torch.zeros(d), m, device="cpu"), batch,
                      prng.key(3))
    assert aux["fault_nonfinite"] == 1
    assert not bool(torch.isfinite(state.flat).all())


@pytest.mark.parametrize("eager", [False, True])
def test_down_rows_are_frozen_despite_the_in_place_update(eager):
    m, d = 5, 4
    batch, loss = _quadratic(m, d)
    top = make_topology("paper_fig1", m)
    faults = make_faults(m, crash_rate=0.3, restart_rate=0.3,
                         corrupt_rate=0.3, seed=3)
    step = make_decentralized_step(loss, top, warmup_harmonic(0.2, hold=5), faults=faults,
                                   eager=eager)
    state = init_state(torch.zeros(d), m, device="cpu")
    state.flat[:, :d] = torch.from_numpy(
        RNG.normal(size=(m, d)).astype(np.float32))
    keys = prng.split(prng.key(1), 30)
    seen_down = 0
    for k in range(30):
        before = state.flat.clone()
        alive = faults.alive_at(k)
        state, aux = step(state, batch, keys[k])
        for i in range(m):
            if alive[i] == 0:
                seen_down += 1
                assert torch.equal(state.flat[i], before[i]), (k, i)
            else:
                assert not torch.equal(state.flat[i], before[i]), (k, i)
    assert seen_down > 0


def _fig2(faults_kw, iters=300):
    """The Fig. 2 workload (m=5, paper_fig1, paper_experiment(0.05)) with
    faults through each package's step: ((ref params, ref aux), (port
    params, port aux), theta_opt)."""
    m, d = 5, 2
    prob = estimation_problem(m, d=d, s=3, n_per_agent=100, seed=0)
    idx = np.random.default_rng(0).integers(0, 100, size=(iters, m, 8))
    zb = prob["Z"][np.arange(m)[None, :, None], idx]
    M = prob["M"]

    def jax_loss(p, batch):
        z, Mi = batch
        return jnp.mean(jnp.sum((z - p @ Mi.T) ** 2, -1))

    def loss(p, batch):
        z, Mi = batch
        return torch.mean(torch.sum((z - p @ Mi.T) ** 2, -1))

    jstep = jax_make_step(jax_loss, jax_make_topology("paper_fig1", m),
                          jax_paper_experiment(0.05),
                          faults=jax_make_faults(m, **faults_kw),
                          nan_policy="skip")
    tstep = make_decentralized_step(loss, make_topology("paper_fig1", m),
                                    paper_experiment(0.05),
                                    faults=make_faults(m, **faults_kw),
                                    nan_policy="skip")
    js = jax_init_state(jnp.zeros((d,)), m)
    ts = init_state(torch.zeros(d), m, device="cpu")
    jkeys = jax.random.split(jax.random.key(0), iters)
    tkeys = prng.split(prng.key(0), iters)
    Mt = torch.from_numpy(M)
    jaux, taux = [], []
    for k in range(iters):
        js, ja = jstep(js, (jnp.asarray(zb[k]), jnp.asarray(M)), jkeys[k])
        ts, ta = tstep(ts, (torch.from_numpy(zb[k]), Mt), tkeys[k])
        jaux.append({n: int(ja[n]) for n in ("fault_down", "fault_corrupt",
                                             "fault_rejoin",
                                             "fault_nonfinite")})
        taux.append({n: ta[n] for n in jaux[-1]})
    return ((np.asarray(js.params), jaux), (ts.params.numpy(), taux),
            prob["theta_opt"])


def test_fig2_with_crash_and_corrupt_faults_matches_reference():
    (want, jaux), (got, taux), theta = _fig2(dict(
        crash_rate=0.1, restart_rate=0.5, corrupt_rate=0.1,
        corrupt_mode="nan", seed=3))
    assert jaux == taux
    assert sum(a["fault_down"] for a in taux) > 0
    assert sum(a["fault_corrupt"] for a in taux) > 0
    err = lambda p: float(np.linalg.norm(p.mean(0) - theta))
    np.testing.assert_allclose(err(got), err(want), rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("faults_kw", [
    None, dict(corrupt_rate=0.2, corrupt_mode="scale", corrupt_scale=50.0,
               crash_rate=0.1, restart_rate=0.5, seed=4)],
    ids=["clean", "crash_and_scale_corrupt"])
def test_trimmed_mean_step_matches_reference(faults_kw):
    """aggregation='trimmed_mean' through each package's step (the same
    draws), and the port's fused and eager forms of it, for 12 steps."""
    m, d = 5, 3
    rng = np.random.default_rng(2)
    targets = rng.normal(size=(m, d)).astype(np.float32)

    def jax_loss(p, b):
        return jnp.sum((p - b) ** 2)

    def loss(p, b):
        return torch.sum((p - b) ** 2)

    jf = jax_make_faults(m, **faults_kw) if faults_kw else None
    tf = make_faults(m, **faults_kw) if faults_kw else None
    jstep = jax_make_step(jax_loss, jax_make_topology("complete", m),
                          jax_paper_experiment(0.05), faults=jf,
                          aggregation="trimmed_mean", trim=1)
    steps = [make_decentralized_step(loss, make_topology("complete", m),
                                     paper_experiment(0.05), faults=tf,
                                     aggregation="trimmed_mean", trim=1,
                                     eager=eager) for eager in (False, True)]
    js = jax_init_state(jnp.zeros((d,)), m)
    states = [init_state(torch.zeros(d), m, device="cpu") for _ in steps]
    jkeys = jax.random.split(jax.random.key(1), 12)
    tkeys = prng.split(prng.key(1), 12)
    for k in range(12):
        js, _ = jstep(js, jnp.asarray(targets), jkeys[k])
        states = [s(st, torch.from_numpy(targets), tkeys[k])[0]
                  for s, st in zip(steps, states)]
    want = np.asarray(js.params)
    for st in states:
        np.testing.assert_allclose(st.params.numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="trim"):
        make_decentralized_step(loss, make_topology("complete", m),
                                paper_experiment(0.05),
                                aggregation="trimmed_mean", trim=3)
    with pytest.raises(ValueError, match="aggregation"):
        make_decentralized_step(loss, make_topology("complete", m),
                                paper_experiment(0.05), aggregation="median")
    with pytest.raises(ValueError, match="nan_policy"):
        make_decentralized_step(loss, make_topology("complete", m),
                                paper_experiment(0.05), nan_policy="panic")
    with pytest.raises(ValueError, match="4 agents"):
        make_decentralized_step(loss, make_topology("complete", m),
                                paper_experiment(0.05),
                                faults=make_faults(4, crash_rate=0.1))
