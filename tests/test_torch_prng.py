"""The port's threefry randomness (`repro_torch.core.prng`) against
``jax.random`` under jax_threefry_partitionable: keys, fold_in, split, bits
and uniform bitwise; exponential within 2 ulp (a transcendental); and the
per-(agent, leaf) Lambda bits bitwise against
``repro.core.pdsgd._per_agent_bits`` on a stablelm-3b-tiny tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.pdsgd import _per_agent_bits
from repro.core.privacy import agent_key as jax_agent_key
from repro.core.privacy import sample_B as jax_sample_B
from repro.models import build_model as jax_build
from repro_torch.core import prng
from repro_torch.core.pdsgd import per_agent_bits
from repro_torch.core.privacy import agent_key, sample_B
from repro_torch.kernels import FlatLayout

SEEDS = [0, 1, 2, 7, 42, 1234, 99991, 2**31 - 1]
SHAPES = [(1,), (17,), (1000,), (2, 3, 4), (3, 5, 7), (7, 13), (4, 1, 9)]


def _key_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.int64).numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bitwise(seed):
    k, t = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_key_words(k), t.numpy())
    for data in (0, 1, 5, 2**31 + 3, 2**32 - 1):
        np.testing.assert_array_equal(_key_words(jax.random.fold_in(k, data)),
                                      prng.fold_in(t, data).numpy())
    for n in (1, 2, 3, 15):
        np.testing.assert_array_equal(_key_words(jax.random.split(k, n)),
                                      prng.split(t, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bitwise_and_exponential_2ulp(seed):
    k = jax.random.fold_in(jax.random.key(seed), 3)
    t = prng.fold_in(prng.key(seed), 3)
    for shape in SHAPES:
        b = np.asarray(jax.random.bits(k, shape, jnp.uint32))
        np.testing.assert_array_equal(b.astype(np.int64),
                                      _u32(prng.bits(t, shape)))
        u = np.asarray(jax.random.uniform(k, shape, jnp.float32))
        np.testing.assert_array_equal(
            u.view(np.int32), prng.uniform(t, shape).numpy().view(np.int32))
        e = np.asarray(jax.random.exponential(k, shape, jnp.float32))
        te = prng.exponential(t, shape).numpy()
        ulps = np.abs(e.view(np.int32).astype(np.int64)
                      - te.view(np.int32).astype(np.int64))
        assert ulps.max() <= 2, ulps.max()


def test_agent_key_batched_matches_reference():
    k, t = jax.random.key(5), prng.key(5)
    agents = torch.arange(6)
    batched = agent_key(t, 11, agents).numpy()
    for a in range(6):
        np.testing.assert_array_equal(
            _key_words(jax_agent_key(k, 11, a)), batched[a])


def test_sample_B_column_stochastic_and_matches_reference():
    from repro_torch.core.topology import make_topology
    top = make_topology("paper_fig1", 5)
    sup = np.asarray(top.adjacency, np.float32)
    jb = np.asarray(jax_sample_B(jax_agent_key(jax.random.key(9), 4, 0),
                                 jnp.asarray(sup)))
    tb = sample_B(agent_key(prng.key(9), 4, 0), torch.from_numpy(sup))
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tb.sum(0).numpy(), 1.0, rtol=1e-6)
    assert ((tb.numpy() > 0) == (sup > 0)).all()


@pytest.mark.parametrize("step", [0, 7])
def test_per_agent_bits_bitwise_on_tiny_tree(step):
    """The flat Lambda bits equal the reference's per-leaf
    ``_per_agent_bits``, flattened in tree order and zero-padded."""
    m = 3
    bundle = jax_build(jax_config("stablelm-3b-tiny"))
    p = jax.tree.map(lambda a: jnp.broadcast_to(a, (m,) + a.shape),
                     bundle.init(jax.random.key(0)))
    key = jax.random.fold_in(jax.random.key(1), 4)
    ref_bits = _per_agent_bits(jax.random.fold_in(key, 1), jnp.asarray(step),
                               p)
    flat_ref = np.concatenate(
        [np.asarray(b).reshape(m, -1) for b in jax.tree.leaves(ref_bits)],
        axis=1).astype(np.int64)
    tree0 = jax.tree.map(lambda a: torch.zeros(a.shape[1:]), p)
    layout = FlatLayout.of(tree0)
    assert layout.paths[0] == "embed" and layout.paths[-1] == "unembed"
    got = _u32(per_agent_bits(prng.fold_in(prng.key(1), 4), step, layout, m))
    D = layout.size
    np.testing.assert_array_equal(got[:, :D], flat_ref)
    assert (got[:, D:] == 0).all()


def _normal_oracle(seed, shape, partitionable):
    """jax's normal from the same threefry words, the inverse error
    function taken in float64 (scipy)."""
    from scipy.special import erfinv
    b = prng._bits64(prng.key(seed), shape, False, partitionable)
    lo = prng._NORMAL_LO[torch.float32]
    u = torch.clamp_min(prng.bits_to_uniform(b) * 2.0 + lo, lo).numpy()
    return erfinv(u.astype(np.float64)) * np.sqrt(2.0)


@pytest.mark.parametrize("partitionable", [True, False])
def test_normal_is_thread_invariant_and_near_float64_oracle(partitionable):
    """The port's float32 normal does not move with torch's thread count
    (bitwise over 1-4 threads), and each side of
    `test_torch_baselines.py::test_normal_against_jax` lies within 92 ulps
    of a float64 oracle built from the same words, the port no farther
    than jax plus 3 ulps at any element.  92: XLA's algorithm squares u
    in float32 before log1p(-u^2), which costs up to 91 ulps in the tails
    (measured); an element 3524 ulps off, as in that test's one
    unexplained failure (ROADMAP §C), would show here as the side that
    moved."""
    shape = (400, 500)
    before = torch.get_num_threads()
    try:
        draws = []
        for n in (1, 2, 3, 4):
            torch.set_num_threads(n)
            draws.append(prng.normal(prng.key(7), shape,
                                     partitionable=partitionable).numpy())
    finally:
        torch.set_num_threads(before)
    for d in draws[1:]:
        np.testing.assert_array_equal(d, draws[0])
    with jax.threefry_partitionable(partitionable):
        want = np.asarray(jax.random.normal(jax.random.key(7), shape))
    oracle = _normal_oracle(7, shape, partitionable)
    ulp = np.spacing(np.abs(oracle).astype(np.float32)).astype(np.float64)
    port_gap = np.abs(draws[0] - oracle) / ulp
    jax_gap = np.abs(want - oracle) / ulp
    assert port_gap.max() <= 92 and jax_gap.max() <= 92
    assert (port_gap <= jax_gap + 3).all()


def test_gumbel_within_half_ulp_of_float64_oracle():
    """`prng.gumbel` takes both logs in float64 and rounds once, so on
    the keys of `test_torch_serve.py::test_gumbel_and_categorical_match_
    jax` (64 x 4000 draws) it lies within half an ulp of -log(-log(u))
    evaluated in float64 from the same threefry words (numpy's log; the
    slack 1e-6 ulp covers float64's own rounding).  jax's float32 logs
    are up to ~1.4 ulps from that oracle, so the serve test's 2-ulp bound
    against jax is unchanged; a port-side outlier, as in that test's one
    failure under xdist (ROADMAP §C), would show here."""
    keys = jax.random.split(jax.random.key(3), 300)[:64]
    tkeys = torch.from_numpy(np.asarray(jax.random.key_data(keys))
                             .astype(np.int64))
    got = prng.gumbel(tkeys, 4000).numpy()
    u = (prng.bits_to_uniform(prng._bits_batched(tkeys, 4000))
         + torch.finfo(torch.float32).tiny).numpy().astype(np.float64)
    oracle = -np.log(-np.log(u))
    ulp = np.spacing(np.abs(oracle).astype(np.float32)).astype(np.float64)
    gap = np.abs(got - oracle) / ulp
    want = np.stack([np.asarray(jax.random.gumbel(k, (4000,)))
                     for k in keys])
    jax_gap = np.abs(want - oracle) / ulp
    assert gap.max() <= 0.5 + 1e-6, (
        f"port {gap.max()} ulps from the float64 oracle at "
        f"{np.unravel_index(gap.argmax(), gap.shape)}; jax {jax_gap.max()}")
