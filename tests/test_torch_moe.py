"""The port's MoE family (olmoe-1b-7b, granite-moe-1b-a400m: the
transformer with `models.moe` as its FFN) against the reference on the
CPU, on shared weights (the reference's init carried over with
`repro_torch.convert.params_from_numpy`).

Covered: the routing of one group (`_route_group`): each pair's expert,
which pairs capacity keeps and drops, and the output, on an input where
pairs are dropped; jax's top-k tie order (lower expert first) on zero
router weights, where every probability ties; `moe_ffn_train` over a
batch of groups and `moe_ffn_decode` (the dense all-expert mixture);
``moe_impl="deferred"``; the load-balance auxiliary; loss and every
gradient of the smoke models; prefill (with drops) and three decode steps
against the reference's; decode continuing prefill at capacity_factor 16
(the reference's `test_decode_continues_prefill`); three PDSGD steps of
granite-moe-1b-a400m-tiny through `run_training` against the reference's
trainer; the ``moe`` subtree across `params_from_numpy` in bf16 bit for
bit; a MoE state's checkpoint byte for byte the reference's, restored
bitwise.

Tolerances (f32; measured on this CPU in brackets):
* expert indices, kept and dropped pairs, the tie order: equal;
* routed outputs, decode mixture: atol = rtol = 1e-5;
* loss: rtol 1e-6; gradients rtol 1e-4 + atol 1e-3 x the leaf's largest
  reference entry (the smoke models' 0.02-scale embeddings feed an
  RMSNorm, as in tests/test_torch_gqa.py);
* prefill logits, cache leaves, decode logits: atol = rtol = 1e-4;
* decode continuing prefill: the reference test's atol 2e-4, rtol 2e-3;
* training: losses rtol 1e-5, parameters after three steps atol 1e-5 +
  rtol 1e-4.
"""
import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_config
from repro.core import init_state as jax_init_state
from repro.data import make_lm_pipeline
from repro.launch.train import build_parser as jax_train_parser
from repro.launch.train import run_training as jax_run_training
from repro.models import build_model as jax_build
from repro.models import moe as jax_moe
from repro.models.common import init_params as jax_init_params
from repro_torch import kernels  # noqa: F401  (before core.privacy)
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.io import step_dirname
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.pdsgd import init_state
from repro_torch.core.privacy import tree_leaves, tree_paths, tree_unflatten
from repro_torch.launch import train
from repro_torch.models import build_model, moe

OLMOE = "olmoe-1b-7b-smoke"
GRANITE_TINY = "granite-moe-1b-a400m-tiny"
TOL = 1e-4
_BUNDLES = {}


def _bundles(arch, seed=0, **replace):
    key = (arch, seed, tuple(sorted(replace.items())))
    if key not in _BUNDLES:
        jcfg, cfg = (dataclasses.replace(c, **replace)
                     for c in (jax_config(arch), get_config(arch)))
        jb = jax_build(jcfg)
        jp = jb.init(jax.random.key(seed))
        _BUNDLES[key] = (jb, jp, build_model(cfg),
                         params_from_numpy(jax.tree.map(np.asarray, jp)))
    return _BUNDLES[key]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tests stay fast beside other xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def _layer(E=8, k=2, d=32, ff=16, capacity_factor=1.0, seed=0):
    """(reference config, port config, one layer's ``moe`` weights in each
    package) with E experts, top k."""
    jcfg, cfg = (dataclasses.replace(
        c, num_experts=E, num_experts_per_tok=k, d_model=d, d_ff=ff,
        capacity_factor=capacity_factor)
        for c in (jax_config(OLMOE), get_config(OLMOE)))
    jp = jax.tree.map(lambda a: a[0], jax_init_params(
        jax.random.key(seed), jax_moe.moe_defs(1, jcfg), jnp.float32))
    return jcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _jax_plan(probs, cfg):
    """The reference `_route_group`'s indices, step by step in jax: each
    (token, choice) pair's expert and whether capacity keeps it, (T, k)."""
    T = probs.shape[0]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = max(1, min(int(-(-T * k // E) * cfg.capacity_factor), T))
    _, eidx = jax.lax.top_k(probs, k)
    flat_e = eidx.reshape(T * k)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(E), side="left")
    valid = (jnp.arange(T * k) - seg_start[sorted_e]) < C
    kept = valid[jnp.argsort(order, stable=True)].reshape(T, k)
    return np.asarray(eidx), np.asarray(kept), C


def _port_plan(probs: torch.Tensor, cfg):
    T = probs.shape[0]
    _, eidx = moe.top_k(probs, cfg.num_experts_per_tok)
    C = moe.capacity(T, cfg)
    order, buf_idx = moe.dispatch(eidx[None], C, cfg.num_experts)
    kept = torch.gather(buf_idx < cfg.num_experts * C, 1,
                        torch.argsort(order, dim=-1, stable=True))
    return eidx.numpy(), kept.reshape(T, -1).numpy(), C


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_route_group_indices_drops_and_output_match_reference(
        capacity_factor):
    """One group of 64 tokens, 8 experts, top 2, router probabilities
    skewed towards two experts so that capacity drops pairs (asserted):
    the experts, the kept pairs and the output equal the reference's."""
    jcfg, cfg, jp, pp = _layer(capacity_factor=capacity_factor)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, cfg.d_model)).astype(np.float32)
    logits = rng.normal(size=(64, cfg.num_experts)).astype(np.float32)
    logits[:, :2] += 2.0
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want_e, want_kept, C = _jax_plan(jnp.asarray(probs), jcfg)
    got_e, got_kept, C_port = _port_plan(torch.from_numpy(probs), cfg)
    assert C_port == C
    np.testing.assert_array_equal(got_e, want_e)
    np.testing.assert_array_equal(got_kept, want_kept)
    assert not want_kept.all() and want_kept.any()
    want = jax.jit(lambda x, p, w: jax_moe._route_group(
        x, p, w["w_gate"], w["w_up"], w["w_down"], jcfg))(x, probs, jp)
    got = moe._route_group(torch.from_numpy(x), torch.from_numpy(probs),
                           pp["w_gate"], pp["w_up"], pp["w_down"], cfg)
    _close(got, want, 1e-5)


def test_topk_ties_take_the_lower_expert_like_jax():
    """Zero router weights: every probability is 1/E, so every top-k is a
    tie.  jax.lax.top_k takes experts 0..k-1 in order; the port takes the
    same, so the routing (experts 0 and 1 fill, the rest stay empty, the
    overflow is dropped) and the output equal the reference's."""
    jcfg, cfg, jp, pp = _layer(E=8, k=2)
    probs = np.full((5, 8), 1 / 8, np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(np.asarray(jidx), [[0, 1, 2]] * 5)
    _, tidx = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # partial ties: the lower index first among the equal values only
    row = np.array([[0.1, 0.3, 0.1, 0.3, 0.2]], np.float32)
    np.testing.assert_array_equal(
        moe.top_k(torch.from_numpy(row), 4)[1].numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(row), 4)[1]))
    jp["router"] = jnp.zeros_like(jp["router"])
    pp["router"] = torch.zeros_like(pp["router"])
    x = np.random.default_rng(2).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jax_moe.moe_ffn_train(p, x, jcfg))(jp, x)
    got = moe.moe_ffn_train(pp, torch.from_numpy(x), cfg)
    _close(got, want, 1e-5)
    want_d = jax.jit(lambda p, x: jax_moe.moe_ffn_decode(p, x, jcfg))(
        jp, x[:, :1])
    _close(moe.moe_ffn_decode(pp, torch.from_numpy(x[:, :1]), cfg), want_d,
           1e-5)


@pytest.mark.parametrize("capacity_factor", [0.25, 8.0])
def test_moe_ffn_train_and_decode_match_reference(capacity_factor):
    """A batch of 3 sequences of 40 tokens (each its own routing group),
    with drops at 0.25, none at 8; decode's dense mixture on one token a
    row."""
    jcfg, cfg, jp, pp = _layer(E=4, k=2, capacity_factor=capacity_factor,
                               seed=3)
    x = np.random.default_rng(4).normal(size=(3, 40, cfg.d_model)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jax_moe.moe_ffn_train(p, x, jcfg))(jp, x)
    _close(moe.moe_ffn_train(pp, torch.from_numpy(x), cfg), want, 1e-5)
    want = jax.jit(lambda p, x: jax_moe.moe_ffn_decode(p, x, jcfg))(
        jp, x[:, :1])
    _close(moe.moe_ffn_decode(pp, torch.from_numpy(x[:, :1]), cfg), want,
           1e-5)


def test_deferred_impl_and_aux_loss():
    """``moe_impl="deferred"`` without a mesh is the allreduce path, as in
    the reference; with a mesh it waits for ROADMAP item 7.  The
    load-balance auxiliary equals the reference's."""
    jcfg, cfg, jp, pp = _layer()
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32))
    deferred = dataclasses.replace(cfg, moe_impl="deferred")
    assert torch.equal(moe.moe_ffn_train(pp, x, deferred),
                       moe.moe_ffn_train(pp, x, cfg))
    with pytest.raises(NotImplementedError, match="item 7"):
        moe.moe_ffn_train(pp, x, deferred, mesh=object())
    logits = np.random.default_rng(6).normal(size=(2, 12, 8)).astype(
        np.float32)
    eidx = np.asarray(jax.lax.top_k(jnp.asarray(logits), 2)[1])
    want = jax_moe.aux_load_balance_loss(jnp.asarray(logits),
                                         jnp.asarray(eidx), 8)
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(eidx), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_loss_and_gradients_match_reference():
    """Loss and every gradient of olmoe-smoke (4 experts top 2) at seq 70:
    44 slots an expert of a sequence's 140 pairs, so pairs drop.
    (granite-moe-tiny's gradients, top 1, are held through
    `test_run_training_walks_reference_trajectory`.)"""
    jb, jp, pb, pp = _bundles(OLMOE)
    batch = make_lm_pipeline(pb.cfg.vocab_size, 1, 2, 70, seed=1).batch_at(0)
    b0 = {k: v[0] for k, v in batch.items()}
    want_l, want_g = jax.jit(jax.value_and_grad(jb.loss_fn))(
        jp, jax.tree.map(jnp.asarray, b0))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(pp)]
    loss = pb.loss_fn(tree_unflatten(pp, leaves),
                      {k: torch.from_numpy(v) for k, v in b0.items()})
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-6)
    grads = torch.autograd.grad(loss, leaves)
    assert "layers/moe/router" in tree_paths(pp)
    for path, a, g in zip(tree_paths(pp), jax.tree.leaves(want_g), grads):
        a = np.asarray(a)
        np.testing.assert_allclose(
            g.numpy(), a, atol=1e-3 * np.abs(a).max(), rtol=1e-4,
            err_msg=path)


def test_prefill_and_decode_match_reference():
    """olmoe-smoke at the reference's capacity factor 1.25: a prefill of 2
    x 30 tokens that drops pairs (held by `_jax_plan` on its first layer's
    router), then 3 decode steps through the dense mixture; logits and the
    KV cache, written in place, against the reference's."""
    jb, jp, pb, pp = _bundles(OLMOE)
    cfg = pb.cfg
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 30),
                                               np.int32)
    want = jax.jit(jb.prefill_fn)(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = pb.prefill_fn(pp, {"tokens": torch.from_numpy(tokens)})
    _close(got["logits"], want["logits"])
    for name in ("k", "v"):
        _close(got["cache"][name], want["cache"][name])
    cache = {n: c.clone() for n, c in got["cache"].items()}
    jcache = want["cache"]
    rng = np.random.default_rng(8)
    decode = jax.jit(jb.decode_fn)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2,), np.int32)
        w = decode(jp, jnp.asarray(tok), jcache, jnp.int32(30 + step))
        with torch.no_grad():
            g = pb.decode_fn(pp, torch.from_numpy(tok), cache, 30 + step)
        _close(g["logits"], w["logits"])
        for name in jcache:
            _close(cache[name], w["cache"][name])
        jcache = w["cache"]


def test_prefill_drops_pairs_at_the_default_capacity():
    """The prefill above drops pairs in its first layer: 30 tokens top 2
    on 4 experts give each expert ceil(60 / 4) x 1.25 = 18 slots a
    sequence, and the router fills some past that.  The kept pairs equal
    `_jax_plan`'s on the same probabilities."""
    _, jp, pb, pp = _bundles(OLMOE)
    cfg = pb.cfg
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 30),
                                               np.int32)
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import layer_views, rope_tables
    p = layer_views(pp["layers"])[0]
    with torch.no_grad():
        x = tfm.embed_tokens(pp, {"tokens": torch.from_numpy(tokens)}, cfg)
        rope = rope_tables(30, cfg.head_dim, cfg.rotary_frac, cfg.rope_theta,
                           "cpu")
        h = tfm._norm(x, p["attn_norm_gamma"], None, cfg)
        q, k, v = tfm._qkv(p, h, rope)
        x = x + torch.einsum("bshk,hkd->bsd", tfm._plain_attn(q, k, v, None),
                             p["wo"])
        h = tfm._norm(x, p["mlp_norm_gamma"], None, cfg)
        probs = torch.softmax(torch.einsum("bsd,de->bse", h,
                                           p["moe"]["router"]), -1)
    assert moe.capacity(30, cfg) == 18
    kept = np.concatenate([_port_plan(probs[b], cfg)[1] for b in range(2)])
    want = np.concatenate([_jax_plan(jnp.asarray(probs[b].numpy()),
                                     jax_config(OLMOE))[1]
                           for b in range(2)])
    np.testing.assert_array_equal(kept, want)
    assert not kept.all()


def test_decode_continues_prefill():
    """The reference's tests/test_models_smoke.py::
    test_decode_continues_prefill on the port: olmoe-smoke at
    capacity_factor 16 (no drops, so prefill's routing equals decode's
    dense mixture), B = 2, S = 64, the smoke model's own init."""
    cfg = dataclasses.replace(get_config(OLMOE), capacity_factor=16.0)
    pb = build_model(cfg)
    params = pb.init(torch.Generator().manual_seed(2), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 65), np.int32))
    with torch.no_grad():
        pre = pb.prefill_fn(params, {"tokens": toks[:, :64]})
        dec = pb.decode_fn(params, toks[:, 64], pre["cache"], pre["pos"])
        full = pb.prefill_fn(params, {"tokens": toks})
    np.testing.assert_allclose(dec["logits"].numpy(), full["logits"].numpy(),
                               atol=2e-4, rtol=2e-3)


def test_run_training_walks_reference_trajectory():
    """Three PDSGD steps of granite-moe-1b-a400m-tiny (2 experts top 1),
    4 agents on a ring, seq 32, same flags and initial weights."""
    flags = ["--arch", GRANITE_TINY, "--agents", "4", "--topology", "ring",
             "--steps", "3", "--log-every", "1", "--seq-len", "32",
             "--seed", "3"]
    want = jax_run_training(jax_train_parser().parse_args(flags))
    _, jp, _, _ = _bundles(GRANITE_TINY, seed=3)
    got = train.run_training(train.build_parser().parse_args(
        flags + ["--device", "cpu"]), init_params=params_from_numpy(
            jax.tree.map(np.asarray, jp)))
    assert [r["step"] for r in got["history"]] == [0, 1, 2]
    for a, b in zip(want["history"], got["history"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for path, a, b in zip(tree_paths(got["state"].params),
                          jax.tree.leaves(want["state"].params),
                          tree_leaves(got["state"].params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-4, err_msg=path)


def test_bf16_moe_tree_converts_and_checkpoints_like_reference(tmp_path):
    """granite-moe-tiny in bf16: `params_from_numpy` carries the ``moe``
    subtree leaf for leaf, bit for bit; a 3-agent state of it saves to the
    reference's bytes (arrays.npz and tree.json) and restores bitwise, in
    place."""
    jcfg = dataclasses.replace(jax_config(GRANITE_TINY), dtype="bfloat16")
    jp = jax_build(jcfg).init(jax.random.key(1))
    host = jax.tree.map(np.asarray, jp)
    pp = params_from_numpy(host)
    assert set(pp["layers"]["moe"]) == {"router", "w_gate", "w_up",
                                        "w_down"}
    jpaths = ["/".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert tree_paths(pp) == jpaths
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(pp)):
        assert b.dtype == torch.bfloat16 and b.shape == a.shape
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    js = jax_init_state(jp, 3)
    js.step = jnp.asarray(4, jnp.int32)
    ps = init_state(pp, 3)
    ps.step = 4
    jax_save(str(tmp_path / "j"), 4, js)
    save_checkpoint(str(tmp_path / "t"), 4, ps)
    for f in ("arrays.npz", "tree.json"):
        assert filecmp.cmp(os.path.join(tmp_path, "j", step_dirname(4), f),
                           os.path.join(tmp_path, "t", step_dirname(4), f),
                           shallow=False), f
    like = init_state(params_from_numpy(jax.tree.map(np.zeros_like, host)),
                      3)
    got = load_checkpoint(str(tmp_path / "t"), 4, like)
    assert got.step == 4 and got.flat.data_ptr() == like.flat.data_ptr()
    assert torch.equal(got.flat.view(torch.int16), ps.flat.view(torch.int16))
