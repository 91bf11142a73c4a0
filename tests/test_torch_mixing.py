"""The port's time-varying coupling (`repro_torch.core.mixing`, the masked
gossip plain versions) against the reference on the CPU, inputs made from
numpy seeds.

Tolerances:
* edge masks, supports and W_k: bitwise (the masks come from the same
  threefry stream; `metropolis_from_mask` sums each row in the
  reference's ascending order, so W_k is bitwise too);
* B4's plain version against the interpreted Pallas kernel: rtol/atol
  1e-6 in f32 (B2's tolerance: the sums run in another order);
* B5's mask: bitwise against the reference's ``symmetric_edge_mask`` under
  the same key (the TPU kernel's in-kernel PRNG cannot lower on the CPU,
  and no other device reproduces its stream);
* trajectories: the Fig. 2 workload with dropout 0.3 ends within rtol
  1e-5 of the reference's final error; `run_training` on
  stablelm-3b-smoke with dropout 0.3 to PR 12's tolerances (losses rtol
  1e-5; parameters atol 1e-5 after one step and atol 1e-3 after two, with
  rtol 1e-4; see test_torch_train.py for the mechanism).  Measured on this
  CPU: parameters 4.0e-6 after one step and 5.3e-5 after two (static
  ring: 2.5e-6 and 1.1e-4).  After three steps the embeddings drift
  4.2e-3 and the third loss 1.45e-5 relative: the smoke model's
  0.02-scale embeddings under LayerNorm amplify f32 rounding, and the port
  against itself, with its initial parameters scaled by 1 + 1e-7, drifts
  1.2e-3 in the same three steps.  So the run is held over two steps.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import init_state as jax_init_state
from repro.core import make_decentralized_step as jax_make_step
from repro.core import make_topology as jax_make_topology
from repro.core import mixing as JM
from repro.core.schedules import paper_experiment as jax_paper_experiment
from repro.data import estimation_problem
from repro.kernels import masked_gossip_update as jax_masked_gossip
from repro.kernels.gossip import _mask_from_bits as jax_mask_from_bits
from repro.launch.train import build_parser as jax_parser
from repro.launch.train import run_training as jax_run_training
from repro.models import build_model as jax_build
from repro_torch.convert import params_from_numpy
from repro_torch.core import mixing as TM
from repro_torch.core import prng
from repro_torch.core.pdsgd import init_state, make_decentralized_step
from repro_torch.core.privacy import tree_leaves
from repro_torch.core.schedules import paper_experiment
from repro_torch.core.topology import make_topology
from repro_torch.kernels import masked_gossip_update, ref
from repro_torch.launch.train import build_parser, run_training

ARCH = "stablelm-3b-smoke"
RNG = np.random.default_rng(13)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tests stay fast beside other xdist workers
    (each comparison is between runs made with one thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed):
    return jax.tree.map(np.asarray,
                        jax_build(jax_config(ARCH)).init(jax.random.key(seed)))


def _jkey(k: torch.Tensor):
    """A port key as the reference's typed key."""
    return jax.random.wrap_key_data(jnp.asarray(k.numpy().astype(np.uint32)))


def _bitwise(a: np.ndarray, b: np.ndarray):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _pair(m: int, **kw):
    """The same process built by both packages (ring base graph)."""
    return (JM.make_mixing(jax_make_topology("ring", m), **kw),
            TM.make_mixing(make_topology("ring", m), **kw))


@pytest.mark.parametrize("m", [4, 5, 16])
def test_symmetric_edge_mask_bitwise(m):
    for seed in range(4):
        k = prng.fold_in(prng.key(seed), 3)
        for keep in (0.5, 0.9, 0.75):
            want = np.asarray(JM.symmetric_edge_mask(_jkey(k), m, keep))
            _bitwise(want, TM.symmetric_edge_mask(k, m, keep).numpy())


@pytest.mark.parametrize("m", [4, 5, 16])
@pytest.mark.parametrize("kw", [dict(rate=0.1, seed=2), dict(rate=0.5, seed=3),
                                dict(resample_every=4, seed=5),
                                dict(resample_every=3, resample_p=0.5,
                                     seed=7)],
                         ids=["dropout0.1", "dropout0.5", "resample",
                              "resample_p0.5"])
def test_realize_bitwise_over_64_steps(m, kw):
    """Masks, supports and W_k bitwise for 64 steps (W_k: bitwise, not to
    an ulp)."""
    jp, tp = _pair(m, **kw)
    realize = jax.jit(jp.realize)
    for step in range(64):
        jW, jsup, jmask = (np.asarray(a) for a in
                           realize(jnp.asarray(step, jnp.int32)))
        tW, tsup, tmask = tp.realize(step)
        _bitwise(jmask, tmask.numpy())
        _bitwise(jsup, tsup.numpy())
        _bitwise(jW, tW.numpy())
        _bitwise(jmask, tp.realize_mask(step).numpy())


def test_static_realize_is_the_topology_constant():
    jp, tp = _pair(5)
    assert tp.is_static and tp.realize(3)[2] is None
    jW, jsup, _ = jp.realize(jnp.asarray(3, jnp.int32))
    tW, tsup, _ = tp.realize(3)
    _bitwise(np.asarray(jW), tW.numpy())
    _bitwise(np.asarray(jsup), tsup.numpy())
    # a dropout process at rate 0 is the static one
    assert TM.make_mixing(make_topology("ring", 5), rate=0.0).is_static


@pytest.mark.parametrize("m", [4, 5, 16])
def test_metropolis_from_mask_bitwise_on_random_masks(m):
    for _ in range(20):
        upper = np.triu(RNG.random((m, m)) < RNG.uniform(0.2, 0.9), 1)
        mask = (upper | upper.T).astype(np.float32)
        _bitwise(np.asarray(JM.metropolis_from_mask(jnp.asarray(mask))),
                 TM.metropolis_from_mask(torch.from_numpy(mask)).numpy())


@pytest.mark.parametrize("kw", [dict(rate=0.5, seed=1),
                                dict(resample_every=2, resample_p=0.4,
                                     seed=2)])
def test_union_support_and_window_monitor_match(kw):
    jp, tp = _pair(6, **kw)
    jmon, tmon = jp.window_monitor(4), tp.window_monitor(4)
    for step in (0, 1, 3, 7, 12):
        _bitwise(np.asarray(jp.union_support(jnp.asarray(step), 4)),
                 tp.union_support(step, 4).numpy())
        want = {k: np.asarray(v).item() for k, v in
                jmon(jnp.asarray(step, jnp.int32)).items()}
        assert tmon(step) == want
    for p in ((np.ones((5, 5)), True), (np.eye(5), False)):
        assert TM.is_connected_mask(torch.from_numpy(p[0]).float()) is p[1]
        assert bool(JM.is_connected_mask(jnp.asarray(p[0],
                                                     jnp.float32))) is p[1]


def test_fingerprints_equal_and_normalize_inert_knobs():
    for kw in (dict(), dict(seed=3), dict(rate=0.0, seed=7),
               dict(rate=0.2, seed=1), dict(resample_every=4, seed=2),
               dict(resample_every=4, resample_p=0.3, seed=2)):
        for top in ("ring", "paper_fig1"):
            m = 5
            want = JM.make_mixing(jax_make_topology(top, m), **kw)
            got = TM.make_mixing(make_topology(top, m), **kw)
            assert got.fingerprint() == want.fingerprint()
            assert got.fingerprint() == json.loads(
                json.dumps(got.fingerprint()))
    base = TM.make_mixing(make_topology("paper_fig1", 5)).fingerprint()
    assert base["mode"] == "static" and base["seed"] is None
    assert TM.make_mixing(make_topology("paper_fig1", 5), rate=0.0,
                          seed=7).fingerprint() == base


def test_make_mixing_validation_mirrors_reference():
    top = make_topology("ring", 4)
    with pytest.raises(ValueError, match="separate modes"):
        TM.make_mixing(top, rate=0.2, resample_every=5)
    with pytest.raises(ValueError, match="rate"):
        TM.make_mixing(top, rate=1.0)
    with pytest.raises(ValueError, match="resample_every"):
        TM.MixingProcess(mode="resample", topology=top)
    with pytest.raises(ValueError, match="unknown mixing mode"):
        TM.MixingProcess(mode="bogus", topology=top)
    with pytest.raises(ValueError, match="dropout-mode knob"):
        TM.make_mixing(top, rate=0.2, resample_every=10, mode="resample")
    with pytest.raises(ValueError, match="resample-mode knobs"):
        TM.make_mixing(top, rate=0.2, resample_every=10, mode="dropout")
    with pytest.raises(ValueError, match="resample-mode knobs"):
        TM.make_mixing(top, resample_p=0.5)
    with pytest.raises(ValueError, match="resample_p"):
        TM.make_mixing(top, resample_every=2, resample_p=1.5)
    with pytest.raises(TypeError):
        TM.as_process(np.ones((3, 3)))
    with pytest.raises(ValueError, match="window"):
        TM.make_mixing(top, rate=0.1).window_monitor(0)
    assert TM.as_process(top).is_static
    assert not TM.make_mixing(top, rate=0.1).is_static


@pytest.mark.parametrize("name,kw", [("complete", {}), ("star", {}),
                                     ("erdos", dict(p=0.4, seed=3)),
                                     ("erdos", dict(p=0.7, seed=11)),
                                     ("torus", dict(rows=2))])
def test_new_topologies_equal_reference(name, kw):
    m = 8
    want = jax_make_topology(name, m, **kw)
    got = make_topology(name, m, **kw)
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    np.testing.assert_array_equal(got.weights, want.weights)


@pytest.mark.parametrize("m,n", [(4, 512), (5, 1024), (32, 512)])
def test_masked_gossip_plain_vs_pallas(m, n):
    upper = np.triu(RNG.random((m, m)) < 0.5, 1)
    mask = (upper | upper.T).astype(np.float32)
    B = RNG.dirichlet(np.ones(m), m).T.astype(np.float32)
    X = RNG.normal(size=(m, n)).astype(np.float32)
    U = RNG.normal(size=(m, n)).astype(np.float32)
    want = np.asarray(jax_masked_gossip(*map(jnp.asarray, (mask, B, X, U)),
                                        interpret=True))
    got = masked_gossip_update(*map(torch.from_numpy, (mask, B, X, U)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", [4, 5, 16])
def test_mask_from_bits_bitwise(m):
    bits = RNG.integers(0, 2**32, size=(m, m), dtype=np.uint64).astype(
        np.uint32)
    adj = np.triu(RNG.random((m, m)) < 0.7, 1)
    adj = (adj | adj.T).astype(np.float32)
    for keep in (0.25, 0.5, 0.9):
        want = np.asarray(jax_mask_from_bits(jnp.asarray(bits), keep,
                                             jnp.asarray(adj)))
        got = ref.mask_from_bits(torch.from_numpy(bits.astype(np.int64))
                                 .to(torch.uint32), keep,
                                 torch.from_numpy(adj))
        _bitwise(want, got.numpy())


@pytest.mark.parametrize("m", [4, 5, 16])
def test_krng_mask_is_reference_edge_mask_under_same_key(m):
    """B5's plain mask (threefry over prng.bits(key, (m, m))) against the
    reference's symmetric_edge_mask: the dropout contract (base adjacency)
    and the resample one (complete graph, the ER probability)."""
    n = 512
    X = torch.from_numpy(RNG.normal(size=(m, n)).astype(np.float32))
    U = torch.from_numpy(RNG.normal(size=(m, n)).astype(np.float32))
    for kw in (dict(rate=0.25, seed=4), dict(resample_every=3, seed=6)):
        jp, tp = _pair(m, **kw)
        realize = jax.jit(jp.realize)
        adj = tp.mask_adj()
        B = torch.eye(m)
        for step in range(8):
            k = tp.mask_key(step)
            want = np.asarray(JM.symmetric_edge_mask(_jkey(k), m,
                                                     tp.keep_prob))
            want = want * np.asarray(jp.base_mask) if "rate" in kw else want
            out, mask = ref.masked_gossip_krng_ref(k, tp.keep_prob, adj, B,
                                                   X, U)
            _bitwise(want.astype(np.float32), mask.numpy())
            _bitwise(np.asarray(realize(jnp.asarray(step, jnp.int32))[2]),
                     mask.numpy())
            np.testing.assert_array_equal(
                out.numpy(), ref.masked_gossip_ref(mask, B, X, U).numpy())


def test_fig2_estimation_300_eager_steps_with_dropout_match_reference():
    """Paper Fig. 2 workload (m=5, paper_fig1, paper_experiment(0.05)) with
    link dropout 0.3, 300 steps through each package's step."""
    m, d, iters = 5, 2, 300
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

    jmix = JM.make_mixing(jax_make_topology("paper_fig1", m), rate=0.3,
                          seed=1)
    tmix = TM.make_mixing(make_topology("paper_fig1", m), rate=0.3, seed=1)
    jstep = jax_make_step(jax_loss, jmix, jax_paper_experiment(0.05))
    tstep = make_decentralized_step(loss, tmix, paper_experiment(0.05))
    js = jax_init_state(jnp.zeros((d,)), m)
    ts = init_state(torch.zeros(d), m, device="cpu")
    jkeys = jax.random.split(jax.random.key(0), iters)
    tkeys = prng.split(prng.key(0), iters)
    Mt = torch.from_numpy(M)
    for k in range(iters):
        js, _ = jstep(js, (jnp.asarray(zb[k]), jnp.asarray(M)), jkeys[k])
        ts, aux = tstep(ts, (torch.from_numpy(zb[k]), Mt), tkeys[k])
    err = lambda p: float(np.linalg.norm(p.mean(0) - prob["theta_opt"]))
    want, got = err(np.asarray(js.params)), err(ts.params.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(ts.params.numpy(), np.asarray(js.params),
                               rtol=1e-5, atol=1e-6)
    assert got < 0.3 and np.isfinite(float(aux["loss"]))


@pytest.mark.parametrize("steps,atol", [(1, 1e-5), (2, 1e-3)])
def test_run_training_with_dropout_walks_reference_trajectory(steps, atol):
    seed = 3
    flags = ["--arch", ARCH, "--agents", "4", "--topology", "ring",
             "--steps", str(steps), "--log-every", "1", "--seq-len", "32",
             "--seed", str(seed), "--topology-dropout", "0.3"]
    want = jax_run_training(jax_parser().parse_args(flags))
    got = run_training(build_parser().parse_args(flags + ["--device", "cpu"]),
                       init_params=params_from_numpy(_jax_params(seed)))
    assert len(got["history"]) == len(want["history"]) == steps
    for a, b in zip(want["history"], got["history"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        for k in ("b_window", "b_window_connected",
                  "b_window_union_min_degree"):
            assert b[k] == a[k], k
    for a, b in zip(jax.tree.leaves(want["state"].params),
                    tree_leaves(got["state"].params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=atol,
                                   rtol=1e-4)
