"""The port's ring layout (`repro_torch.dist.collectives`, the ring kernels'
plain versions, ``pdsgd_update(kernel_layout="ring")``, ``--kernel-layout
ring``) against the reference on the CPU, inputs made from numpy seeds.

Tolerances:
* the table helpers (``perm_stack``, ``dense_coupling``,
  ``directional_keep``/``_weights``, ``rows_from_dense``,
  ``mask_b_draws``): bitwise — every entry is copied, never recombined,
  and the row sums run in the reference's ascending order;
  ``sample_b_draws`` within 2 f32 ulp, the bound of ``prng.exponential``
  (1 ulp measured, on the 3x3 torus);
* the plain versions of B7/B8: bitwise against the reference's un-jitted
  ``ref.ring_gossip_ref``/``ring_obfuscate_gossip_ref`` (op by op, no
  FMA), and within rtol/atol 1e-6 of the interpreted Pallas kernels,
  which XLA:CPU contracts into FMAs (measured <= 9.5e-7 absolute);
* the krng plain version: bitwise the bits plain version on
  ``per_agent_bits`` (the same key table);
* trajectories: the Fig. 2 estimation problem on ring(5), 100 steps,
  final error rtol 1e-5 of the reference's ring layout; the port's ring
  update against its concat update on the same draws to rtol/atol 1e-6
  (``run_training --kernel-layout ring`` against the reference's is in
  test_torch_ring_train.py).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import init_state as jax_init_state
from repro.core import make_decentralized_step as jax_make_step
from repro.core import make_topology as jax_make_topology
from repro.core import mixing as JM
from repro.core.schedules import paper_experiment as jax_paper_experiment
from repro.data import estimation_problem
from repro.dist import collectives as JC
from repro.kernels import ref as jax_ref
from repro.kernels import ring_gossip_update as jax_ring_gossip
from repro.kernels import ring_obfuscate_gossip as jax_ring_obfuscate
from repro.kernels import ring_pdsgd_tree as jax_ring_tree
from repro_torch.convert import params_from_numpy
from repro_torch.core import mixing as TM
from repro_torch.core import prng
from repro_torch.core.pdsgd import (init_state, lambda_key_table,
                                    make_decentralized_step, pdsgd_update,
                                    per_agent_bits)
from repro_torch.core.privacy import tree_leaves
from repro_torch.core.schedules import paper_experiment
from repro_torch.core.topology import make_topology
from repro_torch.dist import collectives as TC
from repro_torch.kernels import (FlatLayout, launch_counts,
                                 reset_launch_counts, ring_gossip_update,
                                 ring_obfuscate_gossip,
                                 ring_obfuscate_gossip_krng, ring_pdsgd_flat,
                                 ring_pdsgd_tree)
from repro_torch.launch.train import build_parser, run_training

ARCH = "stablelm-3b-smoke"
RNG = np.random.default_rng(14)
TORI = [(2, 1), (3, 1), (4, 1), (5, 1), (8, 1), (4, 2), (3, 3)]
KERNEL_TORI = [(3, 1), (4, 1), (8, 1), (4, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tests stay fast beside other xdist workers
    (each comparison is between runs made with one thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _ndirs(n_data, n_pod):
    return len(JC._directions(n_data, n_pod))


def _tables(n_data, n_pod, seed=0):
    """Random positive (m, 1+ndirs) w and b tables (b rows summing to 1)."""
    rng = np.random.default_rng(seed)
    m, nd = n_data * n_pod, _ndirs(n_data, n_pod)
    w = rng.random((m, 1 + nd)).astype(np.float32)
    b = rng.dirichlet(np.ones(1 + nd), m).astype(np.float32)
    return w, b


def _bits(shape) -> np.ndarray:
    return RNG.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _torch_bits(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64)).to(torch.uint32)


# -- 1. table helpers ------------------------------------------------------

@pytest.mark.parametrize("n_data,n_pod", TORI)
def test_table_helpers_bitwise(n_data, n_pod):
    m = n_data * n_pod
    rng = np.random.default_rng(m + 7 * n_pod)
    assert TC._directions(n_data, n_pod) == JC._directions(n_data, n_pod)
    assert TC.torus_weights(n_data, n_pod) == JC.torus_weights(n_data,
                                                               n_pod)
    perms = TC.perm_stack(n_data, n_pod)
    _bitwise(np.asarray(JC.perm_stack(n_data, n_pod)), perms.numpy())
    src = TC.source_table(n_data, n_pod)
    assert torch.equal(torch.nn.functional.one_hot(src.long(), m).float(),
                       perms)
    nd = _ndirs(n_data, n_pod)
    b = rng.dirichlet(np.ones(1 + nd), m).astype(np.float32)
    Wj, Bj = JC.dense_coupling(jnp.asarray(b), n_data, n_pod)
    Wt, Bt = TC.dense_coupling(_t(b), n_data, n_pod)
    _bitwise(Wj, Wt.numpy())
    _bitwise(Bj, Bt.numpy())
    _bitwise(JC.rows_from_dense(Bj, n_data, n_pod),
             TC.rows_from_dense(Bt, n_data, n_pod).numpy())
    M = rng.random((m, m)).astype(np.float32)
    tj = JC.directional_weights(jnp.asarray(M), n_data, n_pod)
    tt = TC.directional_weights(_t(M), n_data, n_pod)
    _bitwise(tj["w_self"], tt["w_self"].contiguous().numpy())
    _bitwise(tj["w_dir"], tt["w_dir"].contiguous().numpy())
    support = (rng.random((m, m)) < 0.6).astype(np.float32)
    support = np.maximum(support, support.T)
    _bitwise(JC.directional_keep(jnp.asarray(support), n_data, n_pod),
             TC.directional_keep(_t(support), n_data,
                                 n_pod).contiguous().numpy())
    keep = (rng.random((m, nd)) < 0.5).astype(np.float32)
    _bitwise(JC.mask_b_draws(jnp.asarray(b), jnp.asarray(keep)),
             TC.mask_b_draws(_t(b), _t(keep)).numpy())
    Wd = np.asarray(Wj)
    Wj2, _ = JC.dense_coupling(jnp.asarray(b), n_data, n_pod,
                               W=jnp.asarray(Wd))
    Wt2, _ = TC.dense_coupling(_t(b), n_data, n_pod, W=_t(Wd))
    _bitwise(Wj2, Wt2.numpy())
    for seed in range(4):
        want = np.asarray(JC.sample_b_draws(jax.random.key(seed), m, n_data,
                                            n_pod))
        got = TC.sample_b_draws(prng.key(seed), m, n_data, n_pod).numpy()
        ulps = np.abs(want.view(np.int32).astype(np.int64)
                      - got.view(np.int32))
        assert ulps.max() <= 2, ulps.max()


def test_realized_tables_of_a_dropout_ring_are_the_references():
    """The ring path's per-step tables from a realized dropout coupling:
    W_k bitwise the reference's, so its direction tables are too, and a
    dropped link is a zero slot in both the keep and the weight table."""
    m, k = 6, 5
    jp = JM.make_mixing(jax_make_topology("ring", m), rate=0.4, seed=3)
    tp = TM.make_mixing(make_topology("ring", m), rate=0.4, seed=3)
    Wj, Sj, _ = jp.realize(jnp.int32(k))
    Wt, St, _ = tp.realize(k)
    _bitwise(Wj, Wt.numpy())
    keep_t = TC.directional_keep(St, m, 1)
    _bitwise(JC.directional_keep(Sj, m, 1), keep_t.contiguous().numpy())
    assert bool((keep_t == 0).any())
    tj = JC.directional_weights(Wj, m, 1)
    tt = TC.directional_weights(Wt, m, 1)
    _bitwise(tj["w_dir"], tt["w_dir"].contiguous().numpy())
    assert torch.equal(tt["w_dir"] == 0, keep_t == 0)


# -- 2. plain versions -----------------------------------------------------

@pytest.mark.parametrize("n_data,n_pod", KERNEL_TORI)
@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_ring_plain_bitwise_vs_unjitted_reference(n_data, n_pod, n, dtype):
    m = n_data * n_pod
    w, b = _tables(n_data, n_pod, seed=n + m)
    perms = JC.perm_stack(n_data, n_pod)
    X = RNG.normal(size=(m, n)).astype(dtype)
    U = RNG.normal(size=(m, n)).astype(dtype)
    G = RNG.normal(size=(m, n)).astype(dtype)
    bits = _bits((m, n))
    lam = 0.07
    want_o, want_v = jax_ref.ring_gossip_ref(jnp.asarray(w), jnp.asarray(b),
                                             perms, jnp.asarray(X),
                                             jnp.asarray(U))
    got_o, got_v = ring_gossip_update(_t(w), _t(b), TC.perm_stack(n_data,
                                                                  n_pod),
                                      params_from_numpy(X),
                                      params_from_numpy(U), capture=True)
    _bitwise(want_o, got_o.float().numpy().astype(dtype))
    _bitwise(want_v, got_v.numpy())
    want = jax_ref.ring_obfuscate_gossip_ref(
        jnp.asarray(w), jnp.asarray(b), perms, jnp.asarray(X),
        jnp.asarray(G), jnp.asarray(bits), lam)
    got = ring_obfuscate_gossip(
        _t(w), _t(b), TC.source_table(n_data, n_pod), params_from_numpy(X),
        params_from_numpy(G), _torch_bits(bits), lam, capture=True)
    _bitwise(want[0], got[0].float().numpy().astype(dtype))
    _bitwise(want[1], got[1].numpy())
    _bitwise(want[2], got[2].numpy())
    # capture does not change the update
    assert torch.equal(got[0], ring_obfuscate_gossip(
        _t(w), _t(b), TC.perm_stack(n_data, n_pod), params_from_numpy(X),
        params_from_numpy(G), _torch_bits(bits), lam))


@pytest.mark.parametrize("n_data,n_pod", KERNEL_TORI)
@pytest.mark.parametrize("n", [512, 1024])
def test_ring_plain_vs_interpreted_pallas(n_data, n_pod, n):
    m = n_data * n_pod
    w, b = _tables(n_data, n_pod, seed=3 * n + m)
    perms = JC.perm_stack(n_data, n_pod)
    X = RNG.normal(size=(m, n)).astype(np.float32)
    U = RNG.normal(size=(m, n)).astype(np.float32)
    bits = _bits((m, n))
    want_o, want_v = jax_ring_gossip(jnp.asarray(w), jnp.asarray(b), perms,
                                     jnp.asarray(X), jnp.asarray(U),
                                     capture=True, interpret=True)
    got_o, got_v = ring_gossip_update(_t(w), _t(b), TC.perm_stack(n_data,
                                                                  n_pod),
                                      _t(X), _t(U), capture=True)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=1e-6, atol=1e-6)
    want = jax_ring_obfuscate(jnp.asarray(w), jnp.asarray(b), perms,
                              jnp.asarray(X), jnp.asarray(U),
                              jnp.asarray(bits), 0.05, capture=True,
                              interpret=True)
    got = ring_obfuscate_gossip(_t(w), _t(b), TC.perm_stack(n_data, n_pod),
                                _t(X), _t(U), _torch_bits(bits), 0.05,
                                capture=True)
    for a, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-6, atol=1e-6)


def test_dropped_direction_sends_exactly_zero():
    """A dropped link is a zero table slot: direction 0's message is
    exactly zero from every sender, as in the reference's test."""
    n_data, m = 8, 8
    w, b = _tables(n_data, 1, seed=7)
    keep = np.ones((m, 2), np.float32)
    keep[:, 0] = 0.0
    b_m = TC.mask_b_draws(_t(b), _t(keep))
    w_m = _t(w).clone()
    w_m[:, 0] += w_m[:, 1]
    w_m[:, 1] = 0.0
    X = _t(RNG.normal(size=(m, 512)).astype(np.float32))
    U = _t(RNG.normal(size=(m, 512)).astype(np.float32))
    _, v = ring_gossip_update(w_m, b_m, TC.perm_stack(n_data, 1), X, U,
                              capture=True)
    assert bool((v[0] == 0).all()) and bool((v[1] != 0).any())
    _, jv = jax_ring_gossip(jnp.asarray(w_m.numpy()), jnp.asarray(
        b_m.numpy()), JC.perm_stack(n_data, 1), jnp.asarray(X.numpy()),
        jnp.asarray(U.numpy()), capture=True, interpret=True)
    assert np.all(np.asarray(jv)[0] == 0.0)


def test_nonfinite_message_reaches_every_receiver_of_its_column():
    """As the reference's 0/1 product: a nan in one sender's g makes the
    whole column nan after the first direction's shift."""
    n_data, m = 4, 4
    w, b = _tables(n_data, 1, seed=9)
    X = RNG.normal(size=(m, 512)).astype(np.float32)
    G = RNG.normal(size=(m, 512)).astype(np.float32)
    G[2, 17] = np.nan
    bits = _bits((m, 512))
    perms = JC.perm_stack(n_data, 1)
    want = jax_ref.ring_obfuscate_gossip_ref(
        jnp.asarray(w), jnp.asarray(b), perms, jnp.asarray(X),
        jnp.asarray(G), jnp.asarray(bits), 0.1)[0]
    got = ring_obfuscate_gossip(_t(w), _t(b), TC.perm_stack(n_data, 1),
                                _t(X), _t(G), _torch_bits(bits), 0.1)
    assert torch.isnan(got[:, 17]).all()
    np.testing.assert_array_equal(np.isnan(np.asarray(want)),
                                  torch.isnan(got).numpy())
    assert int(torch.isnan(got).sum()) == m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_krng_plain_equals_bits_plain_on_per_agent_bits(dtype):
    """B9's plain version draws `per_agent_bits` from the step's key table:
    its output is B8's on those bits, bit for bit."""
    m, sizes = 4, [(3, 5), (7,), (2, 2, 2)]
    tree = {f"l{i}": torch.zeros(s) for i, s in enumerate(sizes)}
    layout = FlatLayout.of(tree)
    key = prng.key(5)
    keys = lambda_key_table(key, 3, m, layout.n_leaves)
    bits = per_agent_bits(key, 3, layout, m)
    w, b = _tables(m, 1, seed=2)
    X = torch.randn(m, layout.width).to(dtype)
    G = torch.randn(m, layout.width).to(dtype)
    offsets = torch.tensor(layout.offsets)
    got = ring_obfuscate_gossip_krng(_t(w), _t(b), TC.perm_stack(m, 1), X,
                                     G, keys, offsets, 0.2, capture=True,
                                     export_bits=True)
    want = ring_obfuscate_gossip(_t(w), _t(b), TC.perm_stack(m, 1), X, G,
                                 bits, 0.2, capture=True)
    assert torch.equal(got[3], bits)
    for a, c in zip(got[:3], want):
        assert torch.equal(a.view(torch.uint8), c.view(torch.uint8))
    assert torch.equal(ring_obfuscate_gossip_krng(
        _t(w), _t(b), TC.perm_stack(m, 1), X, G, keys, offsets, 0.2),
        want[0])


def test_ring_wrappers_take_plain_version_only_on_cpu():
    """CPU tensors go to the plain version and count no launch; a tensor
    on any other non-CUDA device is refused, never computed."""
    reset_launch_counts()
    w, b = _tables(4, 1)
    x = torch.zeros(4, 512)
    bits = torch.zeros(4, 512, dtype=torch.uint32)
    perms = TC.perm_stack(4, 1)
    keys = lambda_key_table(prng.key(1), 0, 4, 1)
    ring_gossip_update(_t(w), _t(b), perms, x, x)
    ring_obfuscate_gossip(_t(w), _t(b), perms, x, x, bits, 0.1)
    ring_obfuscate_gossip_krng(_t(w), _t(b), perms, x, x, keys, [0, 512],
                               0.1)
    assert sum(launch_counts.values()) == 0
    meta = torch.empty(4, 512, device="meta")
    wm, bm = _t(w).to("meta"), _t(b).to("meta")
    with pytest.raises(ValueError):
        ring_gossip_update(wm, bm, perms, meta, meta)
    with pytest.raises(ValueError):
        ring_obfuscate_gossip_krng(wm, bm, perms, meta, meta, keys,
                                   [0, 512], 0.1)
    with pytest.raises(ValueError, match="direction tables"):
        ring_gossip_update(_t(w)[:, :2], _t(b), perms, x, x)
    with pytest.raises(ValueError, match="bits"):
        ring_obfuscate_gossip(_t(w), _t(b), perms, x, x, bits[:, :256], 0.1)


# -- 3. tree form, collectives ---------------------------------------------

def _small_tree(m, rng, dtype=np.float32):
    return {"a": rng.normal(size=(m, 3, 5)).astype(dtype),
            "b": {"c": rng.normal(size=(m, 7)).astype(dtype),
                  "d": rng.normal(size=(m, 2, 300)).astype(dtype)}}


@pytest.mark.parametrize("n_data,n_pod", [(4, 1), (4, 2)])
def test_ring_pdsgd_tree_matches_reference(n_data, n_pod):
    m = n_data * n_pod
    rng = np.random.default_rng(21)
    x, g = _small_tree(m, rng), _small_tree(m, rng)
    bits = jax.tree.map(lambda a: _bits(a.shape), x)
    w, b = _tables(n_data, n_pod, seed=4)
    want, wf = jax_ring_tree(jnp.asarray(w), jnp.asarray(b),
                             JC.perm_stack(n_data, n_pod),
                             jax.tree.map(jnp.asarray, x),
                             jax.tree.map(jnp.asarray, g),
                             jax.tree.map(jnp.asarray, bits), 0.05,
                             interpret=True, observe=True, kernel_rng=False)
    got, gf = ring_pdsgd_tree(
        _t(w), _t(b), TC.perm_stack(n_data, n_pod), params_from_numpy(x),
        params_from_numpy(g), 0.05,
        bits_tree=jax.tree.map(_torch_bits, bits), observe=True)
    for a, c in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    for name in ("x", "u", "v"):
        np.testing.assert_allclose(gf[name].numpy(), np.asarray(wf[name]),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exactly one of keys"):
        ring_pdsgd_tree(_t(w), _t(b), TC.perm_stack(n_data, n_pod),
                        params_from_numpy(x), params_from_numpy(g), 0.05)


@pytest.mark.parametrize("n_data,n_pod", [(5, 1), (4, 2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_torus_gossip_single_device_matches_reference(n_data, n_pod, masked,
                                                      fused):
    """`torus_gossip_pdsgd(None, ...)`: the dense fallback and the fused
    ring kernel against the reference's, static and with a dropout
    realization (``W`` and `mask_b_draws`), with the wire capture."""
    m = n_data * n_pod
    rng = np.random.default_rng(m + 10 * masked)
    params = {"w": rng.normal(size=(m, 6, 2)).astype(np.float32),
              "z": rng.normal(size=(m, 5)).astype(np.float32)}
    u = {"w": rng.normal(size=(m, 6, 2)).astype(np.float32),
         "z": rng.normal(size=(m, 5)).astype(np.float32)}
    b = np.asarray(JC.sample_b_draws(jax.random.key(0), m, n_data, n_pod))
    kw_j, kw_t = {}, {}
    if masked:
        adj = np.asarray(jax_make_topology(
            "ring", m).adjacency) if n_pod == 1 else None
        if adj is None:
            from repro.core.topology import Topology, metropolis_weights
            from repro.core.topology import torus2d
            a2 = torus2d(n_pod, n_data)
            top = Topology(name="torus", adjacency=a2,
                           weights=metropolis_weights(a2))
        else:
            top = jax_make_topology("ring", m)
        proc = JM.make_mixing(top, rate=0.35, seed=7)
        W, support, _ = proc.realize(jnp.int32(11))
        keep = JC.directional_keep(support, n_data, n_pod)
        b = np.asarray(JC.mask_b_draws(jnp.asarray(b), keep))
        kw_j["W"], kw_t["W"] = W, _t(np.asarray(W))
    want, wV = JC.torus_gossip_pdsgd(
        None, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, u),
        jnp.asarray(b), n_data=n_data, n_pod=n_pod, capture=True,
        fused=fused, **kw_j)
    got, gV = TC.torus_gossip_pdsgd(
        None, params_from_numpy(params), params_from_numpy(u), _t(b),
        n_data=n_data, n_pod=n_pod, capture=True, fused=fused, **kw_t)
    for a, c in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(gV.numpy(), np.asarray(wV), rtol=1e-6,
                               atol=1e-6)
    assert tuple(gV.shape) == (m, m, 17)


def test_torus_gossip_refusals():
    m = 4
    p = {"w": torch.zeros(m, 3)}
    b = TC.sample_b_draws(prng.key(0), m, m, 1)
    with pytest.raises(ValueError, match="schedule"):
        TC.torus_gossip_pdsgd(None, p, p, b, schedule="eager")
    with pytest.raises(ValueError, match="finite_guard"):
        TC.torus_gossip_pdsgd(None, p, p, b, fused=True, finite_guard=True)
    with pytest.raises(ValueError, match="leaf_specs"):
        TC.torus_gossip_pdsgd(None, p, p, b, capture=True, leaf_specs=p)
    with pytest.raises(ValueError, match="does not hold"):
        TC.torus_gossip_pdsgd(None, p, p, b, n_data=3, n_pod=1)
    with pytest.raises(ValueError, match="neighbor directions"):
        TC.torus_gossip_pdsgd(None, p, p, b[:, :2])
    with pytest.raises(TypeError, match="mesh"):
        TC.torus_gossip_pdsgd(object(), p, p, b)
    # the guarded dense fallback: identity on finite inputs
    guarded = TC.torus_gossip_pdsgd(None, p, p, b, finite_guard=True)
    plain = TC.torus_gossip_pdsgd(None, p, p, b)
    assert torch.allclose(guarded["w"], plain["w"])


# -- 4. trajectories -------------------------------------------------------

def _fig2(iters):
    m, d = 5, 2
    prob = estimation_problem(m, d=d, s=3, n_per_agent=100, seed=0)
    idx = np.random.default_rng(0).integers(0, 100, size=(iters, m, 8))
    zb = prob["Z"][np.arange(m)[None, :, None], idx]
    return prob, zb, m, d


def test_fig2_ring_layout_100_steps_matches_reference_ring_layout():
    iters = 100
    prob, zb, m, d = _fig2(iters)
    M = prob["M"]

    def jax_loss(p, batch):
        z, Mi = batch
        return jnp.mean(jnp.sum((z - p @ Mi.T) ** 2, -1))

    def loss(p, batch):
        z, Mi = batch
        return torch.mean(torch.sum((z - p @ Mi.T) ** 2, -1))

    jstep = jax_make_step(jax_loss, jax_make_topology("ring", m),
                          jax_paper_experiment(0.05), use_pallas=True,
                          interpret=True, kernel_layout="ring",
                          kernel_rng=False)
    js = jax_init_state(jnp.zeros((d,)), m)
    jkeys = jax.random.split(jax.random.key(0), iters)
    tstep = make_decentralized_step(loss, make_topology("ring", m),
                                    paper_experiment(0.05),
                                    kernel_layout="ring")
    ts = init_state(torch.zeros(d), m, device="cpu")
    tkeys = prng.split(prng.key(0), iters)
    Mt = torch.from_numpy(M)
    for k in range(iters):
        js, _ = jstep(js, (jnp.asarray(zb[k]), jnp.asarray(M)), jkeys[k])
        ts, aux = tstep(ts, (torch.from_numpy(zb[k]), Mt), tkeys[k])
    err = lambda p: float(np.linalg.norm(p.mean(0) - prob["theta_opt"]))
    want, got = err(np.asarray(js.params)), err(ts.params.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isfinite(float(aux["loss"]))


@pytest.mark.parametrize("kernel_rng", [True, False])
def test_ring_update_equals_concat_update_on_same_draws(kernel_rng):
    """One update of the port's ring layout against its concat layout
    (obfuscate, then gossip) on the same W_k, B^k and Lambda^k, on a
    dropout realization of ring(6)."""
    m = 6
    rng = np.random.default_rng(5)
    tree = _small_tree(m, rng)
    layout = FlatLayout.of({k: v for k, v in params_from_numpy(
        jax.tree.map(lambda a: a[0], tree)).items()})
    X = layout.flatten(params_from_numpy(tree), m)
    G = layout.flatten(params_from_numpy(_small_tree(m, rng)), m)
    proc = TM.make_mixing(make_topology("ring", m), rate=0.3, seed=1)
    W, support, mask = proc.realize(4)
    kw = dict(key=prng.key(8), step=4, W=W, support=support, lam_bar=0.05,
              kernel_rng=kernel_rng, mask=mask)
    ring = pdsgd_update(X.clone(), G.clone(), layout, kernel_layout="ring",
                        **kw)
    concat = pdsgd_update(X.clone(), G.clone(), layout, **kw)
    eager = pdsgd_update(X, G, layout, eager=True, kernel_layout="ring",
                         **kw)
    np.testing.assert_allclose(ring.numpy(), concat.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ring.numpy(), eager.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_ring_layout_trains_in_place_with_crash_faults():
    """Crash-only faults on the ring layout: down agents keep their held
    rows around the in-place ring update, as on the concat layout."""
    args = build_parser().parse_args(
        ["--arch", ARCH, "--agents", "4", "--steps", "3", "--log-every",
         "1", "--seq-len", "16", "--device", "cpu", "--fault-crash-rate",
         "0.5", "--fault-restart-rate", "0.5", "--fault-seed", "1"])
    concat = run_training(args)
    args.kernel_layout = "ring"
    ring = run_training(args)
    assert ring["fault_totals"]["fault_down"] > 0
    assert ring["fault_totals"] == concat["fault_totals"]
    for a, b in zip(tree_leaves(concat["state"].params),
                    tree_leaves(ring["state"].params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5)


# -- 5. refusals -----------------------------------------------------------

def test_ring_layout_refusals():
    base = ["--arch", ARCH, "--agents", "4", "--steps", "1", "--device",
            "cpu", "--kernel-layout", "ring"]
    with pytest.raises(SystemExit, match="requires --topology ring"):
        run_training(build_parser().parse_args(base + ["--topology",
                                                       "complete"]))
    with pytest.raises(SystemExit, match="corrupt"):
        run_training(build_parser().parse_args(
            base + ["--fault-corrupt-rate", "0.2"]))
    with pytest.raises(SystemExit):
        build_parser().parse_args(base[:-1] + ["bogus"])
    m = 4
    tree = {"w": torch.zeros(3)}
    layout = FlatLayout.of(tree)
    X = torch.zeros(m, layout.width)
    top = make_topology("ring", m)
    W = torch.tensor(top.weights, dtype=torch.float32)
    S = torch.tensor(top.adjacency, dtype=torch.float32)
    kw = dict(key=prng.key(0), step=0, W=W, support=S, lam_bar=0.1)
    with pytest.raises(ValueError, match="does not hold"):
        pdsgd_update(X, X.clone(), layout, kernel_layout="ring",
                     torus_shape=(3, 1), **kw)
    with pytest.raises(ValueError, match="corrupt-link"):
        pdsgd_update(X, X.clone(), layout, kernel_layout="ring",
                     corrupt=torch.zeros(m), **kw)
    with pytest.raises(ValueError, match="unknown kernel_layout"):
        pdsgd_update(X, X.clone(), layout, kernel_layout="bogus", **kw)
    from repro_torch.faults import make_faults
    with pytest.raises(ValueError, match="corrupt-link"):
        make_decentralized_step(lambda p, b: p["w"].sum(), top,
                                paper_experiment(0.05),
                                faults=make_faults(m, corrupt_rate=0.3),
                                kernel_layout="ring")
    w, b = _tables(m, 1)
    bits = torch.zeros(m, layout.width, dtype=torch.uint32)
    with pytest.raises(ValueError, match="exactly one of keys"):
        ring_pdsgd_flat(_t(w), _t(b), TC.perm_stack(m, 1), X, X, 0.1,
                        keys=lambda_key_table(prng.key(0), 0, m, 1),
                        offsets=[0, 3], bits=bits)
