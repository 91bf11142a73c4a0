"""`launch.steps.make_train_step` on a stand-in mesh (all agents on one
device) against the reference's `make_train_step`, on the same numpy
inputs.

* The reference's quadratic bundle (tests/test_mixing.py:357,
  tests/test_privacy_audit.py:175: loss mean_i |p - b|^2 per agent),
  m = 4 on ``{"data": 4, "model": 1}``, 6 steps: dense (the unfused
  formula, and the kernels' plain versions), static and dropout mixing,
  crash faults, dsgd, dsgt and the wire-tap views.  Parameters within
  atol 1e-6 (values O(1): the reference's jitted einsums contract to
  FMAs), losses within rtol 1e-6, the tapped V within atol 1e-6.
* stablelm-3b-smoke, 2 steps at seq 16: dense through the kernels' plain
  versions, and the ring with its dense fallback and with the ring
  kernel's plain version (``ring_fused``).  The reference's ring on a
  stand-in runs its single-host fallback, so the reference side is its
  own step body with ``mesh=None``: `_per_agent_obfuscated`,
  `sample_b_draws` on ``agent_key(fold_in(key, 2), step, 0)`` and
  `torus_gossip_pdsgd(None, n_data=4)` (for ``ring_fused`` too: the
  reference's interpreted ring kernel takes ~20 s a step, and the two
  differ in summation order only).  Losses rtol 1e-5, parameters atol
  1e-3 + rtol 1e-4 after the two steps (test_torch_train.py's tolerance
  past one step: the smoke model's 0.02-scale embeddings under LayerNorm
  amplify the first step's f32 rounding ~40x a step; measured 6.5e-4 on
  ``embed``, 2.5e-5 elsewhere).
* The refusals carry the reference's messages.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import make_mixing as jax_mixing
from repro.core.pdsgd import _per_agent_obfuscated
from repro.core.privacy import agent_key as jax_agent_key
from repro.dist import collectives as JC
from repro.faults import make_faults as jax_faults
from repro.launch.steps import dsgt_carry as jax_carry
from repro.launch.steps import make_train_step as jax_step
from repro.launch.steps import torus_topology as jax_torus
from repro.models import build_model as jax_build
from repro.privacy import observe as JO
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.mixing import make_mixing
from repro_torch.core.privacy import tree_leaves, tree_paths
from repro_torch.faults import make_faults
from repro_torch.launch.steps import dsgt_carry, make_train_step
from repro_torch.launch.steps import torus_topology
from repro_torch.models import build_model
from repro_torch.privacy import observe as O

M, D, STEPS = 4, 3, 6
SMOKE = "stablelm-3b-smoke"


class StandIn:
    def __init__(self, **axes):
        self.shape = axes


MESH = StandIn(data=M, model=1)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tests stay fast beside other xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quadratic():
    jb = types.SimpleNamespace(
        loss_fn=lambda p, b: jnp.mean(jnp.sum((p - b) ** 2, -1)))
    tb = types.SimpleNamespace(
        loss_fn=lambda p, b: torch.mean(torch.sum((p - b) ** 2, -1)))
    return jb, tb


QUADRATIC_FORMS = {
    "dense": ({}, {}),
    "dense_kernels": ({}, {"use_pallas": True}),
    "static_mixing": ({"mixing": "static"}, {"mixing": "static"}),
    "dropout": ({"mixing": "dropout"}, {"mixing": "dropout"}),
    "dropout_kernels": ({"mixing": "dropout"},
                        {"mixing": "dropout", "use_pallas": True}),
    "crash": ({"faults": "crash"}, {"faults": "crash", "use_pallas": True}),
    "dsgd": ({"algorithm": "dsgd"}, {"algorithm": "dsgd"}),
    "dsgt": ({"algorithm": "dsgt"}, {"algorithm": "dsgt"}),
    "eavesdropper": ({"observer": "eavesdropper"},
                     {"observer": "eavesdropper"}),
    "dsgd_auditor": ({"algorithm": "dsgd", "observer": "auditor"},
                     {"algorithm": "dsgd", "observer": "auditor"}),
}


def _resolve(kw: dict, jax_side: bool) -> dict:
    out = dict(kw)
    tt = (jax_torus if jax_side else torus_topology)(MESH)
    mk = jax_mixing if jax_side else make_mixing
    if out.get("mixing") == "static":
        out["mixing"] = mk(tt)
    elif out.get("mixing") == "dropout":
        out["mixing"] = mk(tt, rate=0.3, seed=1)
    if out.get("faults") == "crash":
        out["faults"] = (jax_faults if jax_side else make_faults)(
            M, crash_rate=0.4, restart_rate=0.5, seed=2)
    obs = {"eavesdropper": (JO.external_eavesdropper,
                            O.external_eavesdropper),
           "auditor": (JO.auditor, O.auditor)}
    if "observer" in out:
        out["observer"] = obs[out["observer"]][0 if jax_side else 1]()
    return out


@pytest.mark.parametrize("name", list(QUADRATIC_FORMS))
def test_quadratic_bundle_against_reference(name):
    jkw, tkw = QUADRATIC_FORMS[name]
    jb, tb = _quadratic()
    js = jax.jit(jax_step(jb, MESH, lam_base=0.1, **_resolve(jkw, True)))
    ts = make_train_step(tb, MESH, lam_base=0.1, **_resolve(tkw, False))
    rng = np.random.default_rng(0)
    T = rng.normal(size=(M, D)).astype(np.float32)
    p0 = rng.normal(size=(M, D)).astype(np.float32)
    pj, pt = jnp.asarray(p0), torch.from_numpy(p0.copy())
    if name == "dsgt":
        pj, pt = jax_carry(pj), dsgt_carry(pt)
    for k in range(STEPS):
        pj, lj = js(pj, jnp.asarray(T), jnp.int32(7), jnp.int32(k))
        pt, lt = ts(pt, torch.from_numpy(T), 7, k)
        if isinstance(lj, dict):
            for f in lj["observation"]:
                np.testing.assert_allclose(
                    lt["observation"][f].numpy(),
                    np.asarray(lj["observation"][f]), atol=1e-6,
                    err_msg=f)
            lj, lt = lj["loss"], lt["loss"]
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    if name == "dsgt":
        for a, b in zip(jax.tree.leaves(pj), [pt[0], *pt[1]]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    else:
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)


def _jax_ring_step(bundle, lam_base: float = 0.1):
    """The reference's ring branch on one device (its single-host
    fallback: ``mesh=None``, the torus given as (4, 1))."""
    grad_fn = jax.vmap(jax.value_and_grad(bundle.loss_fn))

    def step(params, batch, seed, k):
        key = jax.random.key(seed)
        lam_bar = lam_base / (k.astype(jnp.float32) + 1.0)
        losses, grads = grad_fn(params, batch)
        u = _per_agent_obfuscated(jax.random.fold_in(key, 1), k, grads,
                                  lam_bar)
        b = JC.sample_b_draws(jax_agent_key(jax.random.fold_in(key, 2), k, 0),
                              M, M, 1)
        out = JC.torus_gossip_pdsgd(None, params, u, b, n_data=M, n_pod=1)
        return out, losses.mean()
    return jax.jit(step)


@pytest.fixture(scope="module")
def smoke():
    jb = jax_build(jax_config(SMOKE))
    p = jax.tree.map(np.asarray, jb.init(jax.random.key(0)))
    rng = np.random.default_rng(4)
    V = jax_config(SMOKE).vocab_size
    batches = [{"tokens": rng.integers(0, V, (M, 1, 16), np.int32),
                "labels": rng.integers(0, V, (M, 1, 16), np.int32)}
               for _ in range(2)]
    return jb, build_model(get_config(SMOKE)), p, batches


_REF_RUNS: dict = {}


def _reference_run(smoke, schedule: str):
    """The reference's two steps (``"dense"``: its make_train_step;
    ``"ring"``: its ring branch's fallback), run once for the module."""
    if schedule not in _REF_RUNS:
        jb, _, p, batches = smoke
        pj = jax.tree.map(lambda t: jnp.asarray(
            np.broadcast_to(t[None], (M,) + t.shape)), p)
        js = (jax.jit(jax_step(jb, MESH, lam_base=0.1))
              if schedule == "dense" else _jax_ring_step(jb))
        losses = []
        for k, b in enumerate(batches):
            pj, lj = js(pj, jax.tree.map(jnp.asarray, b), jnp.int32(3),
                        jnp.int32(k))
            losses.append(float(lj))
        _REF_RUNS[schedule] = (jax.tree.map(np.asarray, pj), losses)
    return _REF_RUNS[schedule]


@pytest.mark.parametrize("form", ["dense_kernels", "ring", "ring_fused"])
def test_smoke_model_against_reference(smoke, form):
    _, tb, p, batches = smoke
    pt = params_from_numpy(jax.tree.map(
        lambda t: np.broadcast_to(t[None], (M,) + t.shape).copy(), p))
    if form == "dense_kernels":
        want, want_losses = _reference_run(smoke, "dense")
        ts = make_train_step(tb, MESH, lam_base=0.1, use_pallas=True)
    else:
        # the reference's fallback for both (its interpreted ring kernel
        # takes ~20 s a step; the two differ in summation order only)
        want, want_losses = _reference_run(smoke, "ring")
        ts = make_train_step(tb, MESH, gossip="ring", lam_base=0.1,
                             ring_fused=form == "ring_fused")
    for k, b in enumerate(batches):
        pt, lt = ts(pt, {n: torch.from_numpy(v) for n, v in b.items()}, 3,
                    k)
        np.testing.assert_allclose(float(lt), want_losses[k], rtol=1e-5)
    for path, a, b in zip(tree_paths(pt), jax.tree.leaves(want),
                          tree_leaves(pt)):
        np.testing.assert_allclose(b.numpy(), a, atol=1e-3, rtol=1e-4,
                                   err_msg=path)


def test_refusals_carry_reference_messages():
    _, tb = _quadratic()
    tt = torus_topology(MESH)
    cases = [
        ({"algorithm": "dsgt", "gossip": "ring"}, "dense"),
        ({"algorithm": "dsgt", "observer": O.auditor()}, "pdsgd/dsgd"),
        ({"mixing": make_mixing(tt, resample_every=4), "gossip": "ring"},
         "resample"),
        ({"mixing": make_mixing(torus_topology(StandIn(data=5)))},
         "agent torus"),
        ({"faults": make_faults(M, crash_rate=0.2), "algorithm": "dsgd"},
         "fault injection"),
        ({"faults": make_faults(M, corrupt_rate=0.2)}, "corrupt-link"),
        ({"faults": make_faults(M, crash_rate=0.2, restart_rate=0.5,
                                rejoin="neighbor-avg")}, "neighbor-avg"),
        ({"faults": make_faults(5, crash_rate=0.2)}, "faults built for 5"),
        ({"ring_schedule": "eager"}, "schedule"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            make_train_step(tb, MESH, **kw)
    # an inert fault process is no process
    make_train_step(tb, MESH, algorithm="dsgd", faults=make_faults(M))
    bundle = build_model(get_config("stablelm-3b-tiny"))
    with pytest.raises(ValueError, match="non-agent dims replicated"):
        make_train_step(bundle, StandIn(data=2, model=2), gossip="ring",
                        observer=O.auditor())


def test_dense_step_is_the_decentralized_step():
    """The reference's dense make_train_step walks its
    make_decentralized_step's trajectory bit for bit (harmonic(0.1) is
    lam_base / (k + 1), key(seed) the step key); so do the port's, through
    the kernels' plain versions (B1 reading the bits, then B2): the
    bitwise gate `chip_smoke.py`'s mesh_train_step holds on the card."""
    from repro.core import init_state as jax_init
    from repro.core import make_decentralized_step as jax_core
    from repro.core.schedules import harmonic as jax_harmonic
    from repro_torch.core import prng
    from repro_torch.core.pdsgd import init_state, make_decentralized_step
    from repro_torch.core.schedules import harmonic
    jb, tb = _quadratic()
    rng = np.random.default_rng(1)
    T = rng.normal(size=(M, D)).astype(np.float32)
    js = jax.jit(jax_step(jb, MESH, lam_base=0.1))
    jc = jax_core(jb.loss_fn, jax_torus(MESH), jax_harmonic(0.1))
    ts = make_train_step(tb, MESH, lam_base=0.1, use_pallas=True)
    tc = make_decentralized_step(tb.loss_fn, torus_topology(MESH),
                                 harmonic(0.1), kernel_rng=False)
    pj, sj = jnp.zeros((M, D)), jax_init(jnp.zeros((D,)), M)
    pt, st = torch.zeros(M, D), init_state(torch.zeros(D), M)
    for k in range(STEPS):
        pj, lj = js(pj, jnp.asarray(T), jnp.int32(2), jnp.int32(k))
        sj, aj = jc(sj, jnp.asarray(T), jax.random.key(2))
        pt, lt = ts(pt, torch.from_numpy(T), 2, k)
        st.step = k
        st, at = tc(st, torch.from_numpy(T), prng.key(2))
        assert np.array_equal(np.asarray(pj),
                              np.asarray(jax.tree.leaves(sj.params)[0]))
        assert float(lj) == float(aj["loss"])
        assert torch.equal(pt, st.layout.leaf_views(st.flat)[0])
        assert float(lt) == float(at["loss"])
