"""The paper's baselines (DSGD, DSGT, DP-DSGD), gradient clipping, the
further stepsize schedules and the entropy module of the port, against
the reference on the CPU, on the same numpy inputs.

Measured deviations behind the tolerances (this CPU):
* schedules: bitwise with the reference's float32 device evaluation at
  the steps held here (polynomial takes its power in float64 and rounds
  once; XLA's powf misrounds 11-21 of the first 20,000 steps, none of
  them here); ``check_conditions`` sums within 1e-15 relative;
* ``prng.normal``: bfloat16 bitwise; float32 up to 3 ulps of |x| (0.94 %
  of 6 x 10^6 draws differ at all): `prng.erfinv32` is XLA's polynomial,
  and XLA's float32 log1p differs from a rounded float64 one — held at 3;
* the update functions: the W x products differ in f32 summation order
  only, <= 1 ulp of the summed magnitudes (held at atol 1e-6 on O(1)
  inputs); DP-DSGD's noise adds sigma x the normal's gap;
* Fig. 2, 100 steps: final errors within 4e-8 relative for every
  algorithm and the clip, DP-DSGD included (held at rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.entropy as jax_entropy
import repro.core.schedules as jax_sched
from repro.core import make_decentralized_step as jax_step
from repro.core import make_topology as jax_topology
from repro.core.pdsgd import dp_dsgd_update as jax_dp_dsgd_update
from repro.core.pdsgd import dsgd_update as jax_dsgd_update
from repro.core.pdsgd import dsgt_update as jax_dsgt_update
from repro.core.pdsgd import gossip_mix as jax_gossip_mix
from repro.core.privacy import clip_gradients as jax_clip
from repro.core.privacy import lambda_stats as jax_lambda_stats
from repro.faults import make_faults as jax_make_faults
from repro_torch.core import entropy, prng
from repro_torch.core import schedules as sched
from repro_torch.core.mixing import make_mixing
from repro_torch.core.pdsgd import (_dsgt_step_, dp_dsgd_update,
                                    dsgd_update, dsgt_update, gossip_mix,
                                    init_state, make_decentralized_step)
from repro_torch.core.privacy import clip_gradients, lambda_stats
from repro_torch.core.topology import make_topology
from repro_torch.faults import make_faults
from repro_torch.kernels.ops import FlatLayout
from test_torch_scanned import jax_fig2_run, port_fig2_eager, port_fig2_step

KS = (0, 1, 57, 199, 200, 201, 5000)


def _schedule_pairs():
    return [
        ("harmonic", jax_sched.harmonic(0.3), sched.harmonic(0.3)),
        ("poly0.75", jax_sched.polynomial(0.5, 0.75),
         sched.polynomial(0.5, 0.75)),
        ("poly0.6", jax_sched.polynomial(1.0, 0.6),
         sched.polynomial(1.0, 0.6)),
        ("deviating", jax_sched.deviating(jax_sched.harmonic(0.2), 4, seed=3),
         sched.deviating(sched.harmonic(0.2), 4, seed=3)),
        ("deviating_warmup",
         jax_sched.deviating(jax_sched.warmup_harmonic(0.4, 200), 3),
         sched.deviating(sched.warmup_harmonic(0.4, 200), 3)),
    ]


@pytest.mark.parametrize("name,theirs,ours", _schedule_pairs(),
                         ids=[p[0] for p in _schedule_pairs()])
def test_schedules_bitwise_with_reference_device_evaluation(name, theirs,
                                                            ours):
    """Every agent (4 with tables, one without) at the steps KS and, for
    the deviating schedules, at every private deviation step of agent 0
    (tolerance: none)."""
    steps = list(KS)
    if name.startswith("deviating"):
        seed = 3 if name == "deviating" else 0
        steps += [int(i) for i in np.random.default_rng(seed).choice(
            10_000, size=20, replace=False)]
    for agent in range(5):
        for k in steps:
            want = np.float32(theirs(jnp.float32(k), agent))
            got = ours(torch.tensor(float(k)), agent).numpy()
            assert want.view(np.int32) == got.view(np.int32), \
                (name, agent, k, want, got)


@pytest.mark.parametrize("name,theirs,ours", _schedule_pairs(),
                         ids=[p[0] for p in _schedule_pairs()])
def test_check_conditions_same_verdicts_and_sums(name, theirs, ours):
    """Host evaluation in float64: the same verdicts, the sums at rtol
    1e-12."""
    want = jax_sched.check_conditions(theirs, 4, horizon=20_000)
    got = sched.check_conditions(ours, 4, horizon=20_000)
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], bool):
            assert got[key] == want[key], key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                       err_msg=key)


def test_polynomial_refuses_powers_outside_the_conditions():
    for power in (0.5, 1.2):
        with pytest.raises(ValueError):
            jax_sched.polynomial(1.0, power)
        with pytest.raises(ValueError):
            sched.polynomial(1.0, power)


def test_lambda_stats_and_entropy_equal_reference():
    for lam, kappa in ((0.05, None), (0.05, 5.0), (0.3, 1.0), (1e-3, 0.2)):
        assert lambda_stats(lam, kappa) == jax_lambda_stats(lam, kappa)
    for lam, kappa in ((0.1, 5.0), (0.02, 1.0)):
        assert entropy.joint_entropy(lam, kappa) == \
            jax_entropy.joint_entropy(lam, kappa)
        assert entropy.product_entropy_closed(lam, kappa) == \
            jax_entropy.product_entropy_closed(lam, kappa)
        assert entropy.theta_closed(lam, kappa) == \
            jax_entropy.theta_closed(lam, kappa)
        assert entropy.product_entropy_numeric(lam, kappa, n=4000) == \
            jax_entropy.product_entropy_numeric(lam, kappa, n=4000)
        assert entropy.mse_lower_bound(1.03) == \
            jax_entropy.mse_lower_bound(1.03)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_gradients_bitwise(dtype):
    """A tree and the flat buffer (in place), kappa 0.3 and 1.003 (not a
    bfloat16 number), with nan and inf entries (tolerance: none)."""
    rng = np.random.default_rng(4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    a = (rng.standard_normal((4, 9)) * 2).astype(np.float32)
    a[0, 0], a[1, 1], a[2, 2] = np.nan, np.inf, -np.inf
    b = (rng.standard_normal((4, 3, 2)) * 2).astype(np.float32)
    for kappa in (0.3, 1.003):
        want = jax_clip({"a": jnp.asarray(a, jdt), "b": jnp.asarray(b, jdt)},
                        kappa)
        got = clip_gradients({"a": torch.from_numpy(a).to(tdt),
                              "b": torch.from_numpy(b).to(tdt)}, kappa)
        for k in ("a", "b"):
            w = np.asarray(want[k].astype(jnp.float32))
            np.testing.assert_array_equal(got[k].float().numpy(), w)
        flat = torch.from_numpy(a).to(tdt)
        assert clip_gradients(flat, kappa) is flat
        np.testing.assert_array_equal(flat.float().numpy(),
                                      np.asarray(want["a"].astype(
                                          jnp.float32)))


def _normal_gap_report(seed, partitionable, at, got, want):
    """The worst element of a failed comparison, with each side's distance
    in ulps from a float64 oracle on the same threefry words: the side
    that moved is the one far from it (ROADMAP §C)."""
    from scipy.special import erfinv
    b = prng._bits64(prng.key(seed), got.shape, False, partitionable)
    lo = prng._NORMAL_LO[torch.float32]
    u = float(torch.clamp_min(prng.bits_to_uniform(b) * 2.0 + lo, lo)[at])
    oracle = float(erfinv(np.float64(u)) * np.sqrt(2.0))
    ulp = float(np.spacing(np.float32(abs(oracle))))
    return {"seed": seed, "at": at, "u": u, "port": float(got[at]),
            "jax": float(want[at]), "oracle": oracle,
            "port_ulps_from_oracle": abs(float(got[at]) - oracle) / ulp,
            "jax_ulps_from_oracle": abs(float(want[at]) - oracle) / ulp,
            "torch_threads": torch.get_num_threads()}


@pytest.mark.parametrize("partitionable", [True, False])
def test_normal_against_jax(partitionable):
    """float32 within 3 ulps of |x| (3 measured), bfloat16 bitwise, in
    both threefry streams; `bits_at` blocks equal the whole draw."""
    with jax.threefry_partitionable(partitionable):
        for seed in (0, 7):
            want = np.asarray(jax.random.normal(jax.random.key(seed),
                                                (400, 500)))
            got = prng.normal(prng.key(seed), (400, 500),
                              partitionable=partitionable).numpy()
            ulp = np.spacing(np.abs(want).astype(np.float32))
            assert np.isfinite(got).all()
            gap = np.abs(got - want) / ulp
            at = np.unravel_index(gap.argmax(), gap.shape)
            assert gap.max() <= 3, _normal_gap_report(seed, partitionable,
                                                      at, got, want)
            wb = np.asarray(jax.random.normal(jax.random.key(seed), (9, 7),
                                              dtype=jnp.bfloat16))
            gb = prng.normal(prng.key(seed), (9, 7), torch.bfloat16,
                             partitionable)
            np.testing.assert_array_equal(gb.float().numpy(),
                                          wb.astype(np.float32))
    idx = torch.arange(10, 63)
    for seed in (0, 7):
        for byte in (False, True):
            assert torch.equal(
                prng.bits_at(prng.key(seed), idx, 63, byte, partitionable),
                prng._bits64(prng.key(seed), (63,), byte,
                             partitionable)[10:])


def _trees(m=4, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": (7,), "c": {"d": (2, 2, 3)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.standard_normal((m,) + s).astype(dtype)
    return draw(shapes)


def _flat(tree, m=4):
    t = jax.tree.map(torch.from_numpy, tree)
    one = jax.tree.map(lambda x: x[0], t)
    layout = FlatLayout.of(one)
    return layout, layout.flatten(t, m)


def _unflat(layout, buf):
    return jax.tree.map(lambda x: x.numpy(), layout.tree(buf))


def _W(m=4, seed=1):
    rng = np.random.default_rng(seed)
    w = rng.random((m, m)).astype(np.float32)
    return w / w.sum(1, keepdims=True)


def _close(got_tree, want_tree, atol):
    for g, w in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0)


def test_dsgd_and_dsgt_updates_match_reference():
    """The same (x, y, g, g_prev, W, lam); atol 1e-6 (f32 summation order
    of W x)."""
    X, Y, G, Gp = (_trees(seed=s) for s in range(4))
    W, lam = _W(), np.float32(0.07)
    layout, Xf = _flat(X)
    Yf, Gf, Gpf = (_flat(t)[1] for t in (Y, G, Gp))
    Wt, lt = torch.from_numpy(W), torch.tensor(lam)
    want = jax_dsgd_update(X, G, W=jnp.asarray(W), lam=jnp.asarray(lam))
    _close(_unflat(layout, dsgd_update(Xf, Gf, W=Wt, lam=lt)), want, 1e-6)
    wx, wy = jax_dsgt_update(X, Y, G, Gp, W=jnp.asarray(W),
                             lam=jnp.asarray(lam))
    gx, gy = dsgt_update(Xf, Yf, Gf, Gpf, W=Wt, lam=lt)
    _close(_unflat(layout, gx), wx, 1e-6)
    _close(_unflat(layout, gy), wy, 1e-6)


def _direct_descend(mixed, d, lam):
    return (mixed.float() - lam * d.float()).to(mixed.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_pieces_equal_whole_buffer_formula(dtype):
    """`dsgd_update` and the step's in-place `_dsgt_step_` run a column
    piece at a time (never a one-column piece): for every piece width
    they equal the whole-buffer formula (`gossip_mix`, then the f32
    descent rounded once; y = W y + g - g_prev in the dtype) bit for bit
    (tolerance: none)."""
    rng = np.random.default_rng(3)
    X, Y, G, Gp = (torch.from_numpy(rng.standard_normal((4, 1031)).astype(
        np.float32)).to(dtype) for _ in range(4))
    W, lam = torch.from_numpy(_W()), torch.tensor(np.float32(0.07))
    want_x = _direct_descend(gossip_mix(W, X), G, lam)
    y = gossip_mix(W, Y) + G - Gp
    want_dsgt = (_direct_descend(gossip_mix(W, X), y, lam), y)
    for chunk in (1, 7, 512, 1030, 1 << 20):
        got = dsgd_update(X, G, W=W, lam=lam, chunk=chunk)
        assert torch.equal(got.view(torch.uint8), want_x.view(torch.uint8))
        x2, y2, gp2 = X.clone(), Y.clone(), Gp.clone()
        _dsgt_step_(x2, y2, gp2, G, W=W, lam=lam, chunk=chunk)
        for a, b in zip((x2, y2, gp2), (*want_dsgt, G)):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    x3 = X.clone()
    assert dsgd_update(x3, G, W=W, lam=lam, out=x3, chunk=7) is x3
    assert torch.equal(x3.view(torch.uint8), want_x.view(torch.uint8))


@pytest.mark.parametrize("partitionable", [True, False])
def test_dp_dsgd_update_matches_reference(partitionable):
    """Noise per leaf from split(key, n_leaves) over the (m, ...) leaf;
    sigma 0.5: atol 1e-6 + 0.5 x the normal's float32 gap (3 ulps of |x|
    <= 4) ~ 1e-6."""
    X, G = _trees(seed=5), _trees(seed=6)
    W, lam = _W(seed=2), np.float32(0.05)
    with jax.threefry_partitionable(partitionable):
        want = jax_dp_dsgd_update(X, G, key=jax.random.key(11),
                                  W=jnp.asarray(W), lam=jnp.asarray(lam),
                                  sigma_dp=0.5)
    layout, Xf = _flat(X)
    Gf = _flat(G)[1]
    got = dp_dsgd_update(Xf, Gf, layout, key=prng.key(11),
                         W=torch.from_numpy(W), lam=torch.tensor(lam),
                         sigma_dp=0.5, partitionable=partitionable)
    _close(_unflat(layout, got), want, 2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gossip_mix_chunked_equals_unchunked(dtype):
    """Column chunks change no value (tolerance: none; a piece is never
    one column wide, a matrix-vector product that sums in another order),
    and the result is the reference's gossip_mix to one rounding of the
    f32 sum."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((5, 1031)).astype(
        np.float32)).to(dtype)
    W = torch.from_numpy(_W(5, 3))
    whole = gossip_mix(W, x, chunk=1 << 30)
    for chunk in (1, 7, 512, 1030):
        assert torch.equal(gossip_mix(W, x, chunk=chunk).view(torch.uint8),
                           whole.view(torch.uint8))
    assert whole.dtype == dtype and whole.shape == x.shape
    leaf = x[:, :1029].reshape(5, 3, 7, 49)
    assert torch.equal(gossip_mix(W, leaf, chunk=100).reshape(5, -1),
                       whole[:, :1029])
    want = np.asarray(jax_gossip_mix(
        jnp.asarray(W.numpy()),
        jnp.asarray(x.float().numpy()).astype(
            jnp.float32 if dtype == torch.float32 else jnp.bfloat16))
        .astype(jnp.float32))
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(whole.float().numpy(), want, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("kw", [
    {"algorithm": "dsgd"}, {"algorithm": "dsgt"},
    {"algorithm": "dp_dsgd", "sigma_dp": 0.05}, {"grad_clip": 0.5},
    {"algorithm": "dsgd", "grad_clip": 0.5}],
    ids=["dsgd", "dsgt", "dp_dsgd", "clip", "dsgd_clip"])
def test_fig2_100_steps_match_reference(kw):
    """The Fig. 2 workload, 100 eager steps in each package: final error
    at rtol 1e-5 (DP-DSGD included: sigma 0.05 times the normal's gap
    moves it 3e-8 relative)."""
    got, state, auxes = port_fig2_eager(100, **kw)
    want = jax_fig2_run(100, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isfinite(float(auxes[-1]["loss"]))
    if kw.get("algorithm") == "dsgt":
        assert state.tracker is not None


def test_track_mean_is_the_agent_mean():
    step = port_fig2_step(track_mean=True)
    state = init_state(torch.ones(2), 5, device="cpu")
    state.flat[:, :2] = torch.arange(10.0).reshape(5, 2)
    z, M = torch.zeros(5, 8, 3), torch.ones(5, 3, 2)
    new, aux = step(state, (z, M), prng.key(0))
    torch.testing.assert_close(aux["params_mean"], new.flat[:, :2].mean(0),
                               rtol=0, atol=1e-6)


def test_earlier_stream_is_an_argument_and_refuses_what_it_cannot_draw():
    """``partitionable=False`` is the step's own argument: a step built
    with it leaves the next step's draws in the partitionable stream, and
    what draws that stream only (a time-varying process's masks, faults,
    the ring layout's kernels) is refused with it."""
    loss = lambda p, b: p.sum()
    with pytest.raises(ValueError, match="partitionable"):
        make_decentralized_step(
            loss, make_mixing(make_topology("ring", 4), rate=0.25),
            sched.harmonic(), partitionable=False)
    with pytest.raises(ValueError, match="partitionable"):
        make_decentralized_step(loss, make_topology("ring", 4),
                                sched.harmonic(), partitionable=False,
                                faults=make_faults(4, crash_rate=0.2,
                                                   restart_rate=0.5))
    with pytest.raises(ValueError, match="partitionable"):
        make_decentralized_step(loss, make_topology("ring", 4),
                                sched.harmonic(), partitionable=False,
                                kernel_layout="ring")
    early = port_fig2_eager(5, partitionable=False)[1].flat
    after = port_fig2_eager(5)[1].flat
    before = port_fig2_eager(5)[1].flat
    assert torch.equal(after, before) and not torch.equal(after, early)


def test_refusals_match_reference():
    """Faults and trimmed-mean are pdsgd-only and grad_clip must be > 0,
    with the reference's messages."""
    loss = lambda p, b: p.sum()
    cases = [
        ({"algorithm": "dsgd"}, {"faults": "crash"}),
        ({"algorithm": "dp_dsgd"}, {"faults": "corrupt"}),
        ({"algorithm": "dsgt"}, {"aggregation": "trimmed_mean"}),
        ({"grad_clip": 0.0}, {}),
        ({"grad_clip": -1.0}, {}),
        ({"algorithm": "adam"}, {}),
    ]
    for kw, extra in cases:
        msgs = []
        for pkg in ("jax", "torch"):
            faults = None
            if "faults" in extra:
                mk = jax_make_faults if pkg == "jax" else make_faults
                faults = mk(4, crash_rate=0.2, restart_rate=0.5) \
                    if extra["faults"] == "crash" else mk(4, corrupt_rate=0.3)
            args = dict(kw, faults=faults,
                        aggregation=extra.get("aggregation", "gossip"))
            with pytest.raises(ValueError) as err:
                if pkg == "jax":
                    jax_step(loss, jax_topology("ring", 4),
                             jax_sched.harmonic(), **args)
                else:
                    make_decentralized_step(loss, make_topology("ring", 4),
                                            sched.harmonic(), **args)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], msgs
