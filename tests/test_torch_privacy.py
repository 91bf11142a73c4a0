"""The privacy subsystem of the port (`repro_torch.privacy`, `optim`,
`faults.audit`, `core.privacy.sample_lambda_tree`, `data.synthetic_digits`)
against the reference on the CPU, on the same numpy inputs.

Measured deviations behind the tolerances (this CPU):
* `observe.wire_messages`: bitwise with the reference's un-jitted
  function; under ``jax.jit`` XLA contracts ``w*x - b*u`` to a fused
  multiply-add, and 20-24 % of the entries differ, by at most 2.0 x 2^-24
  of |w x| + |b u| (held at 2^-23 of it);
* the estimators are the reference's numpy code: equal exactly;
* the attacks' inversions: float32 sums in another order, within 1e-6
  relative of the gradients' scale;
* `optim`: sgd and momentum bitwise, adam within 2 ulps (XLA's powf for
  the bias corrections; held at rtol 1e-6);
* DLG: the dummy's normal draws are within 3 ulps (`prng.normal`), the
  gradients of the matching loss differ in summation order; five steps
  agree within rtol 1e-4 (matching loss) and atol 1e-5 (the image).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_mixing as jax_make_mixing
from repro.core import make_topology as jax_topology
from repro.core.privacy import sample_lambda_tree as jax_sample_lambda
from repro.data import synthetic_digits as jax_digits
from repro.faults import rejoin_leakage_report as jax_rejoin_report
from repro.optim import adam as jax_adam
from repro.optim import apply_updates as jax_apply
from repro.optim import momentum as jax_momentum
from repro.optim import sgd as jax_sgd
from repro.privacy import attacks as JA
from repro.privacy import estimators as JE
from repro.privacy import observe as JO
from repro_torch.core import prng
from repro_torch.core.mixing import make_mixing
from repro_torch.core.privacy import obfuscated_gradient, sample_lambda_tree
from repro_torch.core.topology import make_topology
from repro_torch.data import synthetic_digits
from repro_torch.faults.audit import rejoin_leakage_report
from repro_torch.optim import adam, apply_updates, momentum, sgd
from repro_torch.privacy import attacks as A
from repro_torch.privacy import estimators as E
from repro_torch.privacy import observe as O


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _coupling(m, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.random((m, m)).astype(np.float32)
    B = rng.random((m, m)).astype(np.float32)
    return W, B


# -- observe -------------------------------------------------------------

@pytest.mark.parametrize("m,D,chunk", [(5, 7, 3), (4, 1000, 1 << 22),
                                       (8, 513, 128)])
def test_wire_messages_against_reference(m, D, chunk):
    W, B = _coupling(m)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(m, D)).astype(np.float32)
    u = (rng.normal(size=(m, D)) * 0.1).astype(np.float32)
    got = O.wire_messages(_t(W), _t(B), _t(x), _t(u), chunk=chunk).numpy()
    args = [jnp.asarray(a) for a in (W, B, x, u)]
    np.testing.assert_array_equal(got, np.asarray(JO.wire_messages(*args)))
    jitted = np.asarray(jax.jit(JO.wire_messages)(*args))
    scale = (np.abs(W[:, :, None] * x[None]) + np.abs(B[:, :, None]
                                                       * u[None]))
    assert np.all(np.abs(got - jitted) <= scale * 2.0 ** -23)
    assert np.all(got[np.arange(m), np.arange(m)] == 0.0)
    # a bf16 buffer is cast a piece at a time: the f32 copy's values
    xb = _t(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        O.wire_messages(_t(W), _t(B), xb, _t(u), chunk=chunk).numpy(),
        O.wire_messages(_t(W), _t(B), xb.float(), _t(u)).numpy())


def test_flatten_broadcast_and_records_against_reference():
    m, rng = 4, np.random.default_rng(2)
    tree = {"b": rng.normal(size=(m, 3)).astype(np.float32),
            "a": rng.normal(size=(m, 2, 5)).astype(np.float32)}
    got = O.flatten_agents({k: _t(v) for k, v in tree.items()})
    want = JO.flatten_agents({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    support = (rng.random((m, m)) < 0.6).astype(np.float32)
    np.fill_diagonal(support, 1.0)
    np.testing.assert_array_equal(
        O.broadcast_messages(got, _t(support)).numpy(),
        np.asarray(JO.broadcast_messages(want, jnp.asarray(support))))
    W, B = _coupling(m, 3)
    u = (rng.normal(size=got.shape) * 0.1).astype(np.float32)
    g = rng.normal(size=got.shape).astype(np.float32)
    kw = dict(support=support, x_flat=_np(got), u_flat=u, g_flat=g, W=W,
              B=B)
    v = O.wire_messages(_t(W), _t(B), got, _t(u))
    rec = O.full_record(v=v, **{k: _t(a) for k, a in kw.items()})
    jrec = JO.full_record(v=jnp.asarray(v.numpy()),
                          **{k: jnp.asarray(a) for k, a in kw.items()})
    assert set(rec) == set(jrec) == set(O.RECORD_FIELDS)
    srec = O.state_record(support=_t(support), x_flat=got, g_flat=_t(g),
                          W=_t(W), lam=0.25)
    jsrec = JO.state_record(support=jnp.asarray(support), x_flat=want,
                            g_flat=jnp.asarray(g), W=jnp.asarray(W),
                            lam=0.25)
    for adv, jadv in ((O.auditor(), JO.auditor()),
                      (O.external_eavesdropper(),
                       JO.external_eavesdropper()),
                      (O.curious_neighbor(2), JO.curious_neighbor(2))):
        for r, jr in ((rec, jrec), (srec, jsrec)):
            view = O.adversary_view(adv, r)
            jview = JO.adversary_view(jadv, jr)
            assert set(view) == set(jview)
            for f in jview:
                assert view[f].dtype == torch.float32
                np.testing.assert_array_equal(view[f].numpy(),
                                              np.asarray(jview[f]), f)
    # a record built with fewer fields keeps only them
    assert set(O.full_record(v=v, support=_t(support))) == {"v", "support"}
    assert O.external_eavesdropper().fields == ("v", "support")


def test_adversary_refusals():
    with pytest.raises(ValueError, match="agent"):
        O.Adversary("curious_neighbor")
    with pytest.raises(ValueError, match="unknown adversary"):
        O.Adversary("nsa")
    with pytest.raises(ValueError, match="no agent index"):
        O.Adversary("auditor", agent=1)
    assert O.ADVERSARY_KINDS == JO.ADVERSARY_KINDS


# -- estimators ------------------------------------------------------------

def test_estimators_equal_reference_exactly():
    g, y = E.sample_observations(0.5, 5.0, 20_000, seed=4)
    jg, jy = JE.sample_observations(0.5, 5.0, 20_000, seed=4)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(y, jy)
    assert E.binned_entropy(y) == JE.binned_entropy(y)
    assert E.knn_entropy(y) == JE.knn_entropy(y)
    x2 = np.random.default_rng(0).normal(size=(1500, 2))
    assert E.knn_entropy(x2, max_n=1000) == JE.knn_entropy(x2, max_n=1000)
    for method in ("knn", "binned"):
        assert E.estimate_h_y(y, method) == JE.estimate_h_y(y, method)
        assert (E.estimate_theta(y, 0.5, 5.0, method)
                == JE.estimate_theta(y, 0.5, 5.0, method))
    assert (E.empirical_recovery_floor(g, y)
            == JE.empirical_recovery_floor(g, y))
    u = np.random.default_rng(1).normal(size=(3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(E.observations_from_capture(u),
                                  JE.observations_from_capture(u))
    with pytest.raises(ValueError, match="estimator"):
        E.estimate_h_y(y, "bogus")


# -- attacks -----------------------------------------------------------------

def test_states_from_broadcast_against_reference_and_refusal():
    m, D, T = 4, 2, 3
    sup = np.ones((m, m), np.float32)
    x = np.arange(T * m * D, dtype=np.float32).reshape(T, m, D)
    sup_stream = np.stack([sup] * T)
    sup_stream[1, 0, 1] = sup_stream[1, 1, 0] = 0.0
    v = np.stack([O.broadcast_messages(_t(x[t]), _t(sup_stream[t])).numpy()
                  for t in range(T)])
    for s in (sup, sup_stream):
        got = A.states_from_broadcast(v, s).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JA.states_from_broadcast(v, s)))
    np.testing.assert_array_equal(A.states_from_broadcast(v, sup_stream)
                                  .numpy(), x)
    sup_iso = np.stack([sup] * T)
    sup_iso[1, :, 2] = 0.0
    sup_iso[1, 2, 2] = 1.0
    with pytest.raises(ValueError, match="no live receiver"):
        A.states_from_broadcast(v, sup_iso)


def test_inversions_against_reference():
    """`dsgd_exact_recovery`, `pdsgd_ls_recovery`, `eavesdropper_aggregate`
    and `recovery_mse` on the same streams: within 1e-6 of the scale."""
    rng = np.random.default_rng(5)
    T, m, D = 6, 5, 3
    W, _ = _coupling(m, 6)
    x = rng.normal(size=(T + 1, m, D)).astype(np.float32)
    lam = (0.05 / (1 + np.arange(T))).astype(np.float32)
    got = A.dsgd_exact_recovery(_t(x), _t(W), _t(lam)).numpy()
    want = np.asarray(JA.dsgd_exact_recovery(jnp.asarray(x), jnp.asarray(W),
                                             jnp.asarray(lam)))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    v = rng.normal(size=(T, m, m, D)).astype(np.float32)
    Ws = rng.random((T, m, m)).astype(np.float32)
    sup = (rng.random((T, m, m)) < 0.7).astype(np.float32)
    sup[:, np.arange(m), np.arange(m)] = 1.0
    np.testing.assert_allclose(
        A.eavesdropper_aggregate(_t(v)).numpy(),
        np.asarray(JA.eavesdropper_aggregate(jnp.asarray(v))), rtol=1e-6,
        atol=1e-6)
    got = A.pdsgd_ls_recovery(_t(v), _t(x[:T]), _t(Ws), _t(sup), _t(lam))
    want = JA.pdsgd_ls_recovery(*(jnp.asarray(a) for a in
                                  (v, x[:T], Ws, sup, lam)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6 * float(jnp.abs(want).max()))
    g = rng.normal(size=want.shape).astype(np.float32)
    assert A.recovery_mse(got, _t(g)) == pytest.approx(
        JA.recovery_mse(want, jnp.asarray(g)), rel=1e-6)


def test_eavesdropper_observation_with_mixing_against_reference():
    """The realized W_k of a dropout process (a step where one of agent j's
    links dropped), the same key derivations: the port's aggregate equals
    the reference's within 1e-6; the frozen-W model differs; refusals."""
    m, j = 5, 2
    top, jtop = make_topology("paper_fig1", m), jax_topology("paper_fig1", m)
    mix = make_mixing(top, rate=0.5, seed=3)
    jmix = jax_make_mixing(jtop, rate=0.5, seed=3)
    step = next(k for k in range(40)
                if float(mix.realize(k)[1][:, j].sum())
                < top.adjacency[:, j].sum())
    rng = np.random.default_rng(0)
    x_j = {"w": rng.normal(size=(4,)).astype(np.float32)}
    g_j = {"w": rng.normal(size=(4,)).astype(np.float32)}
    got = A.eavesdropper_observation(
        prng.key(7), step, j, {"w": _t(x_j["w"])}, {"w": _t(g_j["w"])},
        lam_bar=0.1, mixing=mix)["w"]
    want = JA.eavesdropper_observation(
        jax.random.key(7), jnp.int32(step), j,
        {"w": jnp.asarray(x_j["w"])}, {"w": jnp.asarray(g_j["w"])},
        lam_bar=jnp.float32(0.1), mixing=jmix)["w"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    frozen = A.eavesdropper_observation(
        prng.key(7), step, j, {"w": _t(x_j["w"])}, {"w": _t(g_j["w"])},
        W=torch.from_numpy(top.weights).float(),
        support=torch.from_numpy(top.adjacency).float(), lam_bar=0.1)["w"]
    assert not np.allclose(got.numpy(), frozen.numpy())
    W_k, sup_k, _ = mix.realize(step)
    with pytest.raises(ValueError, match="not both"):
        A.eavesdropper_observation(prng.key(7), 0, j, x_j, g_j, W=W_k,
                                   support=sup_k, lam_bar=0.1, mixing=mix)
    with pytest.raises(ValueError, match="lam_bar"):
        A.eavesdropper_observation(prng.key(7), 0, j, x_j, g_j, mixing=mix)


def test_sample_lambda_tree_and_digits_bitwise():
    rng = np.random.default_rng(3)
    g = {"w": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    for step in (0, 7):
        key = prng.fold_in(prng.key(11), step)
        got = sample_lambda_tree(key, {k: _t(v) for k, v in g.items()}, 0.3)
        want = jax_sample_lambda(jax.random.fold_in(jax.random.key(11),
                                                    step),
                                 {k: jnp.asarray(v) for k, v in g.items()},
                                 jnp.float32(0.3))
        for k in g:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    for kw in ({"seed": 3, "size": 6, "classes": 4}, {"seed": 0}):
        for a, b in zip(synthetic_digits(5, **kw), jax_digits(5, **kw)):
            np.testing.assert_array_equal(a, b)


def test_rejoin_leakage_report_against_reference():
    """The reference's scenario (`tests/test_faults.py:411`): the warm
    start's broadcast is recovered exactly, the masked wire leaves the
    residual; the port's numbers equal the reference's within 1e-6."""
    from repro.core.mixing import metropolis_from_mask as jax_metropolis
    from repro_torch.core.mixing import metropolis_from_mask
    m, d = 6, 5
    rng = np.random.default_rng(1)
    x = rng.normal(size=(m, d)).astype(np.float32)
    u = rng.normal(size=(m, d)).astype(np.float32)
    alive_prev = np.asarray([1.0, 0.0, 1.0, 1.0, 1.0, 1.0], np.float32)
    alive = np.ones((m,), np.float32)
    mask = np.ones((m, m), np.float32) - np.eye(m, dtype=np.float32)
    B = rng.dirichlet(np.ones(m), m).T.astype(np.float32)
    W = metropolis_from_mask(_t(mask))
    np.testing.assert_array_equal(W.numpy(), np.asarray(
        jax_metropolis(jnp.asarray(mask))))
    rep = rejoin_leakage_report(params=_t(x), u=_t(u), W=W, B=_t(B),
                                mask=_t(mask), alive=_t(alive),
                                alive_prev=_t(alive_prev))
    jrep = jax_rejoin_report(params=jnp.asarray(x), u=jnp.asarray(u),
                             W=jnp.asarray(W.numpy()), B=jnp.asarray(B),
                             mask=jnp.asarray(mask),
                             alive=jnp.asarray(alive),
                             alive_prev=jnp.asarray(alive_prev))
    assert int(rep["links"]) == int(jrep["links"]) == m - 1
    assert float(rep["broadcast_mse"]) < 1e-10
    assert float(rep["pdsgd_wire_mse"]) > 1e-3
    assert float(rep["pdsgd_wire_mse"]) == pytest.approx(
        float(jrep["pdsgd_wire_mse"]), rel=1e-6)


# -- optim -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adam",
                                  "adamw"])
def test_optimizers_five_updates_against_reference(name):
    make = {"sgd": (lambda: sgd(0.1), lambda: jax_sgd(0.1)),
            "momentum": (lambda: momentum(0.1, 0.8),
                         lambda: jax_momentum(0.1, 0.8)),
            "nesterov": (lambda: momentum(0.1, 0.8, nesterov=True),
                         lambda: jax_momentum(0.1, 0.8, nesterov=True)),
            "adam": (lambda: adam(0.05), lambda: jax_adam(0.05)),
            "adamw": (lambda: adam(0.05, weight_decay=0.01),
                      lambda: jax_adam(0.05, weight_decay=0.01))}[name]
    opt, jopt = make[0](), make[1]()
    rng = np.random.default_rng(4)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    p = {k: _t(v) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st, jst = opt.init(p), jopt.init(jp)
    for _ in range(5):
        g0 = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()}
        upd, st = opt.update({k: _t(v) for k, v in g0.items()}, st, p)
        jupd, jst = jopt.update({k: jnp.asarray(v) for k, v in g0.items()},
                                jst, jp)
        p, jp = apply_updates(p, upd), jax_apply(jp, jupd)
    for k in p0:
        if name.startswith("adam"):
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))


# -- DLG ---------------------------------------------------------------------

CLASSES, SIZE = 4, 6


def _dlg_setup():
    """tests/test_attacks.py's tiny model and example, in both packages."""
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(SIZE * SIZE, 24)).astype(np.float32) * 0.3
    w2 = rng.normal(size=(24, CLASSES)).astype(np.float32) * 0.3
    x, y = synthetic_digits(1, seed=3, size=SIZE, classes=CLASSES)
    params = {"w1": _t(w1), "b1": torch.zeros(24), "w2": _t(w2),
              "b2": torch.zeros(CLASSES)}
    jparams = {"w1": jnp.asarray(w1), "b1": jnp.zeros((24,)),
               "w2": jnp.asarray(w2), "b2": jnp.zeros((CLASSES,))}

    def loss(p, x, soft):
        h = torch.tanh(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"])
        return -torch.mean(torch.sum(
            soft * torch.log_softmax(h @ p["w2"] + p["b2"], -1), -1))

    def jloss(p, x, soft):
        h = jnp.tanh(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"])
        return -jnp.mean(jnp.sum(
            soft * jax.nn.log_softmax(h @ p["w2"] + p["b2"]), -1))

    soft = torch.nn.functional.one_hot(_t(y).long(), CLASSES).float()
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    grads = torch.autograd.grad(loss(leaves, _t(x), soft),
                                list(leaves.values()))
    g = dict(zip(leaves, grads))
    jg = jax.grad(jloss)(jparams, jnp.asarray(x),
                         jax.nn.one_hot(jnp.asarray(y), CLASSES))
    return params, loss, _t(x), soft, g, jparams, jloss, jg


@pytest.fixture(scope="module")
def dlg_setup():
    return _dlg_setup()


def test_dlg_first_steps_against_reference(dlg_setup):
    params, loss, x, soft, g, jparams, jloss, jg = dlg_setup
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-7)
    res = A.dlg_attack(loss, params, g, tuple(x.shape), CLASSES,
                       key=prng.key(0), steps=5, lr=0.1, true_x=x)
    jres = JA.dlg_attack(jloss, jparams, jg, x.shape, CLASSES,
                         key=jax.random.key(0), steps=5, lr=0.1,
                         true_x=jnp.asarray(x.numpy()))
    np.testing.assert_allclose(res.match_history.numpy(),
                               np.asarray(jres.match_history), rtol=1e-4)
    np.testing.assert_allclose(res.recon_x.numpy(), np.asarray(jres.recon_x),
                               atol=1e-5)
    np.testing.assert_allclose(res.mse_history.numpy(),
                               np.asarray(jres.mse_history), rtol=1e-4)
    grid = A.dlg_attack_grid(
        loss, params, {k: torch.stack([v, 2 * v]) for k, v in g.items()},
        tuple(x.shape), CLASSES, key=prng.key(0), steps=3, true_x=x)
    assert grid.recon_x.shape == (2,) + tuple(x.shape)
    one = A.dlg_attack(loss, params, g, tuple(x.shape), CLASSES,
                       key=prng.fold_in(prng.key(0), 0), steps=3, true_x=x)
    assert torch.equal(grid.recon_x[0], one.recon_x)


def test_dlg_recovers_data_from_exact_gradient(dlg_setup):
    """`tests/test_attacks.py`'s claim at its 600 steps, on the port."""
    params, loss, x, soft, g, *_ = dlg_setup
    res = A.dlg_attack(loss, params, g, tuple(x.shape), CLASSES,
                       key=prng.key(0), steps=600, lr=0.1, true_x=x)
    mse = float(torch.mean((res.recon_x - x) ** 2))
    assert mse < 0.02, mse
    assert int(torch.argmax(res.recon_label_logits)) == int(
        torch.argmax(soft))
    hist = res.match_history.numpy()
    assert hist[-1] < hist[0] * 0.1


def test_dlg_degrades_against_pdsgd_obfuscation(dlg_setup):
    """The Lambda∘g observation degrades DLG's reconstruction by a large
    factor (`tests/test_attacks.py`, 600 steps)."""
    params, loss, x, soft, g, *_ = dlg_setup
    mses = []
    for obs in (g, obfuscated_gradient(prng.key(9), g, 0.05)):
        res = A.dlg_attack(loss, params, obs, tuple(x.shape), CLASSES,
                           key=prng.key(0), steps=600, lr=0.1, true_x=x)
        mses.append(float(torch.mean((res.recon_x - x) ** 2)))
    assert mses[1] > 2.5 * mses[0], mses


def test_dlg_attack_grid_sweeps_agents(dlg_setup):
    """The reference's grid test (`tests/test_privacy_audit.py`, marked
    slow there; under 2 s here) on the port: exact gradients reconstruct,
    obfuscated ones degrade (400 steps a cell)."""
    params, loss, x, soft, g, *_ = dlg_setup
    obs = {k: torch.stack([g[k],
                           obfuscated_gradient(prng.key(1), g, 0.05)[k],
                           obfuscated_gradient(prng.key(2), g, 0.05)[k]])
           for k in g}
    res = A.dlg_attack_grid(loss, params, obs, tuple(x.shape), CLASSES,
                            key=prng.key(0), steps=400, lr=0.1, true_x=x)
    mses = [float(torch.mean((res.recon_x[i] - x) ** 2)) for i in range(3)]
    assert mses[0] < 0.02, mses
    assert min(mses[1], mses[2]) > 2.5 * mses[0], mses


def test_core_attacks_shim():
    from repro_torch.core import attacks as shim
    assert shim.dlg_attack is A.dlg_attack
    assert shim.eavesdropper_observation is A.eavesdropper_observation
