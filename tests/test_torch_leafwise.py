"""The tree forms and the leafwise layout of the PDSGD update
(`kernels.ops.obfuscate_tree`, `gossip_tree`, `sharded_pdsgd_tree`,
`leafwise_pdsgd_flat`, ``kernel_layout="leafwise"``) against the
reference on the CPU, where the kernels' plain versions run.

* ``sharded_pdsgd_tree(mesh=None)`` is bitwise the concat layout's
  update (`fused_pdsgd_flat` over the concatenated, padded buffer) at m =
  3, 4, 5, static, masked and corrupt, and the reference's
  ``sharded_pdsgd_tree`` (Pallas in interpret mode) on the same bits
  (bitwise; the guarded sums, which run in the kernel's order, to
  atol = rtol = 1e-6), on
  the reference's awkward leaf shapes (tests/test_sharded_pdsgd.py:54)
  plus a one-column leaf.
* `obfuscate_tree` and `gossip_tree` against the reference's at
  tests/test_kernels.py:83's shapes: the bits drawn from one key over the
  256-padded concatenated buffer bitwise, v within 2 ulp of its terms
  (XLA associates and contracts the interpreted kernel's products
  otherwise), x' to 1e-6.
* Three leafwise steps of stablelm-3b-tiny are bitwise three concat steps
  of the bits path (static, dropout, faults), and within the trajectory
  tolerance (losses rtol 1e-5, parameters atol 1e-5 + rtol 1e-4) of the
  reference's leafwise step (tests/test_sharded_pdsgd.py:269, Pallas
  interpreted).
* The refusals carry the reference's messages.
* The trivial mesh: the mesh form (`dist.sharding.mesh_pdsgd_tree`) on
  a one-rank gloo group (an
  in-process HashStore, destroyed after the test) and the (1, 1, 1)
  ("data", "fsdp", "model") mesh of `launch.mesh.make_sharded_mesh`,
  leaf specs from TRAIN_RULES.  Its gossip is B2 over the agents'
  gathered local shards (`dist.collectives.gather_agents`), so it is
  ``mesh=None``'s bit for bit; it is held against ``mesh=None`` within
  B2's tolerance (f32 atol = rtol = 1e-5; bf16 one bf16 ulp of (|W||X| +
  |B||U|) per entry), with the max deviation printed; the step one update
  at a time from the same state, so the losses are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.core import init_state as jax_init_state
from repro.core import make_decentralized_step as jax_make_step
from repro.core import make_topology as jax_make_topology
from repro.core.mixing import as_process as jax_as_process
from repro.core.schedules import warmup_harmonic as jax_warmup
from repro.data import make_lm_pipeline as jax_pipeline
from repro.kernels import obfuscate_tree as jax_obfuscate_tree
from repro.kernels import gossip_tree as jax_gossip_tree
from repro.kernels.ops import sharded_pdsgd_tree as jax_sharded_tree
from repro.models import build_model as jax_build
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.core.pdsgd import (init_state, make_decentralized_step,
                                    pdsgd_update)
from repro_torch.core.privacy import tree_leaves, tree_unflatten
from repro_torch.core.schedules import warmup_harmonic
from repro_torch.core.topology import make_topology
from repro_torch.data import make_lm_pipeline
from repro_torch.dist.sharding import (TRAIN_RULES, logical_spec,
                                       mesh_pdsgd_tree)
from repro_torch.kernels.ops import (FlatLayout, fused_pdsgd_flat,
                                     sharded_pdsgd_tree)
from repro_torch.launch.mesh import make_sharded_mesh
from repro_torch.launch.specs import with_agent_axis
from repro_torch.launch.train import build_parser, run_training
from repro_torch.models import build_model

# the reference's awkward shapes (odd column counts, ranks 1-3) and a
# one-column leaf
SHAPES = {"b": (3, 2, 2), "emb": (5, 7), "one": (1,), "w": (33,)}
TINY = "stablelm-3b-tiny"


def _coupling(m, seed):
    rng = np.random.default_rng(seed)
    W = rng.dirichlet(np.ones(m), m).T.astype(np.float32)
    B = rng.dirichlet(np.ones(m), m).T.astype(np.float32)
    mask = (rng.random((m, m)) > 0.3).astype(np.float32)
    mask = mask * mask.T * (1 - np.eye(m, dtype=np.float32))
    return W, B, mask


def _trees(m, seed, dtype=np.float32):
    rng = np.random.default_rng(seed + 1)
    x = {k: rng.standard_normal((m,) + s).astype(dtype)
         for k, s in SHAPES.items()}
    g = {k: rng.standard_normal((m,) + s).astype(dtype)
         for k, s in SHAPES.items()}
    bits = {k: rng.integers(0, 2**32, (m,) + s, dtype=np.uint64).astype(
        np.uint32) for k, s in SHAPES.items()}
    return x, g, bits


def _t(tree):
    """numpy tree -> torch (uint32 leaves as torch.uint32)."""
    return {k: torch.from_numpy(v.astype(np.int64)).to(torch.uint32)
            if v.dtype == np.uint32 else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _concat(W, B, x, g, bits, lam, **kw):
    """The concat layout's update of the same trees: one padded buffer."""
    layout = FlatLayout.of({k: v[0] for k, v in x.items()})
    m = x["w"].shape[0]
    X, G, Bits = (layout.flatten(t, m) for t in (x, g, bits))
    out, _ = fused_pdsgd_flat(W, B, X, G, lam, bits=Bits, **kw)
    return layout.tree(out)


@pytest.mark.parametrize("m", [3, 4, 5])
@pytest.mark.parametrize("mode", ["static", "masked", "corrupt"])
def test_leafwise_tree_bitwise_concat_and_reference(m, mode):
    Wn, Bn, maskn = _coupling(m, 10 + m)
    xn, gn, bn = _trees(m, m)
    W, B, mask = (torch.from_numpy(a) for a in (Wn, Bn, maskn))
    lam = torch.tensor(0.05)
    kw, jkw = {}, {}
    if mode != "static":
        kw["mask"], jkw["mask"] = mask, jnp.asarray(maskn)
    if mode == "corrupt":
        c = np.zeros(m, np.float32)
        c[m - 1] = 1.0
        kw.update(corrupt=torch.from_numpy(c), corrupt_mode="scale",
                  guard_clip=1e3)
        jkw.update(corrupt=jnp.asarray(c), corrupt_mode="scale",
                   guard_clip=1e3)
    got = sharded_pdsgd_tree(W, B, _t(xn), _t(gn), _t(bn), lam, **kw)
    want = _concat(W, B, _t(xn), _t(gn), _t(bn), lam, **kw)
    ref = jax_sharded_tree(jnp.asarray(Wn), jnp.asarray(Bn),
                           jax.tree.map(jnp.asarray, xn),
                           jax.tree.map(jnp.asarray, gn),
                           jax.tree.map(jnp.asarray, bn), jnp.float32(0.05),
                           interpret=True, **jkw)
    for k in SHAPES:
        assert torch.equal(got[k], want[k]), (mode, k)
        if mode == "corrupt":
            # the guarded sums run in the kernel's order (ascending j),
            # the reference's in its own: B6's tolerance
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{mode} {k}")
        else:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(ref[k]),
                                          err_msg=f"{mode} {k}")


def test_tree_forms_match_reference():
    """tests/test_kernels.py:83's trees (m = 6, leaves (8, 4) and (10,))."""
    m = 6
    rng = np.random.default_rng(3)
    xn = {"a": rng.standard_normal((m, 8, 4)).astype(np.float32),
          "b": rng.standard_normal((m, 10)).astype(np.float32)}
    un = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in xn.items()}
    Wn = rng.dirichlet(np.ones(m), m).T.astype(np.float32)
    Bn = rng.dirichlet(np.ones(m), m).T.astype(np.float32)
    jx, ju = (jax.tree.map(jnp.asarray, t) for t in (xn, un))
    want = jax_gossip_tree(jnp.asarray(Wn), jnp.asarray(Bn), jx, ju,
                           interpret=True)
    got = K.gossip_tree(torch.from_numpy(Wn), torch.from_numpy(Bn), _t(xn),
                        _t(un))
    for k in xn:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
    layout = FlatLayout.of({k: v[0] for k, v in _t(xn).items()})
    D = layout.size
    want_bits = jax.random.bits(jax.random.PRNGKey(11),
                                (m, -(-D // 256) * 256), dtype=jnp.uint32)
    np.testing.assert_array_equal(
        K.ops.tree_bits(prng.key(11), m, layout)[:, :D].to(
            torch.int64).numpy(), np.asarray(want_bits)[:, :D])
    for lam, w_self, b_self in ((0.07, 0.0, -1.0), (0.13, 0.3, -0.7)):
        want = jax_obfuscate_tree(jax.random.PRNGKey(11), jx, ju,
                                  jnp.float32(lam), jnp.float32(w_self),
                                  jnp.float32(b_self), interpret=True)
        got = K.obfuscate_tree(prng.key(11), _t(xn), _t(un), lam, w_self,
                               b_self)
        for k in xn:
            # the interpreted kernel's products associate and contract
            # otherwise under XLA (ROADMAP C): within 2 ulp of the terms
            terms = (abs(w_self) * np.abs(xn[k])
                     + abs(b_self) * 2 * lam * np.abs(un[k]))
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=2.5e-7 * terms.max(),
                                       err_msg=k)


def _tiny_run(layout, extra=(), steps=3, unroll=1):
    torch.set_num_threads(1)
    try:
        args = build_parser().parse_args(
            ["--arch", TINY, "--agents", "4", "--topology", "ring",
             "--steps", str(steps), "--log-every", "1", "--seq-len", "16",
             "--per-agent-batch", "1", "--device", "cpu", "--seed", "2",
             "--kernel-layout", layout, "--unroll-k", str(unroll),
             *extra])
        return run_training(args, kernel_rng=False)
    finally:
        torch.set_num_threads(_THREADS)


_THREADS = torch.get_num_threads()
FLAGS = {"static": (), "dropout": ("--topology-dropout", "0.25"),
         "fault": ("--fault-crash-rate", "0.2", "--fault-restart-rate", "0.5",
                   "--fault-corrupt-rate", "0.25", "--fault-corrupt-mode",
                   "nan", "--nan-policy", "skip", "--fault-seed", "0")}


def _records(res):
    return [{k: v for k, v in r.items() if k != "elapsed_s"}
            for r in res["history"]]


@pytest.mark.parametrize("mode", list(FLAGS))
def test_leafwise_steps_bitwise_concat(mode):
    a = _tiny_run("concat", FLAGS[mode])
    b = _tiny_run("leafwise", FLAGS[mode])
    assert torch.equal(a["state"].flat, b["state"].flat)
    assert _records(a) == _records(b)
    if mode == "fault":  # fault seed 0 has a down agent and a corrupt sender
        assert b["fault_totals"]["fault_down"] > 0
        assert b["fault_totals"]["fault_corrupt"] > 0


def test_leafwise_scanned_bitwise_eager():
    """``--unroll-k 2`` (on the CPU: step.inner at a counter tensor, the
    form the graph captures) against the eager leafwise loop."""
    a = _tiny_run("leafwise", steps=4, unroll=2)
    b = _tiny_run("leafwise", steps=4)
    assert torch.equal(a["state"].flat, b["state"].flat)
    assert _records(a) == _records(b)


def test_leafwise_step_matches_reference():
    m, steps = 4, 3
    jcfg = jax_config(TINY)
    jb = jax_build(jcfg)
    jp = jb.init(jax.random.key(0))
    jstep = jax_make_step(jb.loss_fn, jax_as_process(jax_make_topology(
        "ring", m)), jax_warmup(0.4, hold=10), use_pallas=True,
        interpret=True, kernel_layout="leafwise")
    pb = build_model(get_config(TINY))
    step = make_decentralized_step(pb.loss_fn, make_topology("ring", m),
                                   warmup_harmonic(0.4, hold=10),
                                   kernel_rng=False, kernel_layout="leafwise")
    jpipe = jax_pipeline(jcfg.vocab_size, m, 1, 8, seed=5)
    pipe = make_lm_pipeline(jcfg.vocab_size, m, 1, 8, seed=5)
    js = jax_init_state(jp, m)
    state = init_state(params_from_numpy(jax.tree.map(np.asarray, jp)), m)
    torch.set_num_threads(1)
    try:
        for k in range(steps):
            js, jaux = jstep(js, jpipe.batch_at(k),
                             jax.random.fold_in(jax.random.key(1), k))
            batch = {n: torch.from_numpy(np.asarray(v))
                     for n, v in pipe.batch_at(k).items()}
            state, aux = step(state, batch, prng.fold_in(prng.key(1), k))
            np.testing.assert_allclose(float(aux["loss"]),
                                       float(jaux["loss"]), rtol=1e-5)
    finally:
        torch.set_num_threads(_THREADS)
    for a, b in zip(jax.tree.leaves(js.params), tree_leaves(state.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-4)


def test_refusals_carry_reference_messages():
    from repro_torch.privacy import observe as O
    pb = build_model(get_config(TINY))
    top = make_topology("ring", 4)
    with pytest.raises(ValueError, match="concatenated wire buffer"):
        make_decentralized_step(pb.loss_fn, top, warmup_harmonic(0.4),
                                kernel_layout="leafwise",
                                observer=O.auditor())
    state = init_state(pb.init(torch.Generator().manual_seed(0), "cpu"), 4)
    X = state.flat
    W = torch.eye(4)
    with pytest.raises(ValueError, match="concatenated wire buffer"):
        pdsgd_update(X, X.clone(), state.layout, key=prng.key(0), step=0,
                     W=W, support=W > 0, lam_bar=0.1,
                     kernel_layout="leafwise", observe=True)
    x, g, bits = (_t(t) for t in _trees(2, 3))
    with pytest.raises(ValueError, match="leaf_specs"):
        mesh_pdsgd_tree(W[:2, :2], W[:2, :2], x, g, bits, 0.1,
                        mesh=object())
    with pytest.raises(NotImplementedError, match="fault"):
        mesh_pdsgd_tree(W[:2, :2], W[:2, :2], x, g, bits, 0.1,
                        mesh=object(), leaf_specs={}, corrupt=torch.ones(2))


@pytest.fixture()
def one_rank_group():
    """A one-rank gloo process group on an in-process HashStore."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _leaf_specs(bundle_like, mesh, m):
    abs_m, log_m = with_agent_axis(*bundle_like, m)
    return tree_unflatten(abs_m, [
        logical_spec(mesh, a.shape, log, TRAIN_RULES)
        for a, log in zip(tree_leaves(abs_m), tree_leaves(log_m))])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_trivial_mesh_tree_against_mesh_none(one_rank_group, dtype):
    m = 4
    mesh = make_sharded_mesh(agents=m, fsdp=1, tensor=1, device_type="cpu")
    Wn, Bn, _ = _coupling(m, 7)
    xn, gn, bn = _trees(m, 7)
    x, g, bits = _t(xn), _t(gn), _t(bn)
    if dtype == "bfloat16":
        x = {k: v.bfloat16() for k, v in x.items()}
        g = {k: v.bfloat16() for k, v in g.items()}
    W, B = torch.from_numpy(Wn), torch.from_numpy(Bn)
    single = {k: torch.empty(v.shape[1:], dtype=v.dtype, device="meta")
              for k, v in x.items()}
    specs = _leaf_specs((single, {k: ("embed",) + (None,) * (len(s) - 1)
                                  for k, s in SHAPES.items()}), mesh, m)
    assert all(s == () for s in tree_leaves(specs))
    lam = torch.tensor(0.1)
    got = mesh_pdsgd_tree(W, B, x, g, bits, lam, mesh=mesh,
                          leaf_specs=specs)
    want = sharded_pdsgd_tree(W, B, x, g, bits, lam)
    u = sharded_pdsgd_tree(torch.zeros_like(W), -torch.eye(m), x, g, bits,
                           lam)
    dev = 0.0
    for k in SHAPES:
        out = got[k].full_tensor()
        diff = (out.float() - want[k].float()).abs()
        dev = max(dev, float(diff.max()))
        if dtype == np.float32:
            assert torch.allclose(out, want[k], rtol=1e-5, atol=1e-5), k
        else:
            scale = (torch.einsum("ij,j...->i...", W.abs(),
                                  x[k].float().abs())
                     + torch.einsum("ij,j...->i...", B.abs(),
                                    u[k].float().abs()))
            assert bool((diff <= scale * 2.0 ** -7 + 1e-30).all()), k
    print(f"trivial mesh {dtype}: max deviation from mesh=None {dev}")


def test_trivial_mesh_step_against_mesh_none(one_rank_group):
    """Three leafwise steps of stablelm-3b-tiny (f32) on the (1, 1, 1) mesh,
    leaf specs from TRAIN_RULES, each from the mesh=None trajectory's
    state: equal losses, parameters within B2's f32 tolerance."""
    m = 4
    mesh = make_sharded_mesh(agents=m, fsdp=1, tensor=1, device_type="cpu")
    pb = build_model(get_config(TINY))
    specs = _leaf_specs((pb.abstract(), pb.logical_axes()), mesh, m)
    top = make_topology("ring", m)
    sched = warmup_harmonic(0.4, hold=10)
    steps = {
        "mesh": make_decentralized_step(
            pb.loss_fn, top, sched, kernel_rng=False,
            kernel_layout="leafwise", mesh=mesh, leaf_specs=specs),
        "none": make_decentralized_step(pb.loss_fn, top, sched,
                                        kernel_rng=False,
                                        kernel_layout="leafwise")}
    assert steps["mesh"].graph_refusal == "the leafwise layout over a mesh"
    params = pb.init(torch.Generator().manual_seed(0), "cpu")
    pipe = make_lm_pipeline(pb.cfg.vocab_size, m, 1, 8, seed=5)
    state = init_state(params, m)
    dev = 0.0
    torch.set_num_threads(1)
    try:
        for k in range(3):
            batch = {n: torch.from_numpy(np.asarray(v))
                     for n, v in pipe.batch_at(k).items()}
            key = prng.fold_in(prng.key(1), k)
            other = init_state(params, m)
            other.flat.copy_(state.flat)
            other.step = state.step
            other, aux_m = steps["mesh"](other, batch, key)
            state, aux = steps["none"](state, batch, key)
            assert float(aux_m["loss"]) == float(aux["loss"])
            dev = max(dev, float((other.flat - state.flat).abs().max()))
            assert torch.allclose(other.flat, state.flat, rtol=1e-5,
                                  atol=1e-5), k
    finally:
        torch.set_num_threads(_THREADS)
    print(f"trivial mesh step: max deviation from mesh=None {dev}")
