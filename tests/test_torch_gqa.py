"""The port's dense grouped-query configs (granite-8b, mistral-nemo-12b,
chatglm3-6b) and the registry of the five archs this slice adds, against
the reference on the CPU, on shared weights (the reference's init carried
over with `repro_torch.convert.params_from_numpy`).

The smoke reduction sets head_dim 32 and heads = min(H, 8), which leaves
granite-8b-smoke and mistral-nemo-12b-smoke with KV = H and H hd =
d_model.  So beside chatglm3-6b-smoke (KV 2 of 8 heads, rotary 0.5,
untied embeddings) the tests run ``MISTRAL_GQA``: mistral-nemo-12b-smoke
with 8 query heads of 16 on 2 KV heads (H hd = 128 against d_model 256),
rope_theta 1e6, built by the same `dataclasses.replace` in both packages.

Covered: every config field of the five archs and their -smoke and -tiny
variants; the full models' parameter trees; `chunked_attention` against
the reference's (S = 70, chunk 32: padded tails and skipped blocks,
causal, with and without a window, KV < H, values and gradients); loss
and every gradient; prefill logits and every cache leaf, then three
decode steps from that cache written in place; training and a CPU
prefill through ``attn_impl="chunked"``.  (`run_training` on this family
is held against the reference's trainer in tests/test_torch_moe.py and
tests/test_torch_train.py.)

Tolerances (f32; measured on this CPU in brackets):
* loss: rtol 1e-6 [equal];
* gradients: rtol 1e-4 + atol 1e-3 x the leaf's largest reference entry
  [2.1e-4 on chatglm3's ``embed``, 2.8e-4 on the chunked variant's].
  The smoke models' random attention is sharp (tests/test_torch_serve.py)
  and the 0.02-scale embeddings feed an RMSNorm: against a float64
  evaluation of the port's gradients the reference's own f32 gradients
  are off by as much (3.9e-4 and 3.1e-4 of the largest entry) as the
  port's (2.0e-4 and 3.4e-4);
* prefill logits, cache leaves and decode logits: atol = rtol = 1e-4, the
  dense family's serve tolerance (tests/test_torch_serve.py);
* `chunked_attention`: atol = rtol = 1e-5 against the reference's and
  against the port's `attention` (the online softmax sums in another
  order);
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import make_lm_pipeline
from repro.models import build_model as jax_build
from repro.models import common as jax_common
from repro.models import transformer as jax_tfm
from repro_torch import kernels  # noqa: F401  (before core.privacy)
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.privacy import tree_leaves, tree_paths, tree_unflatten
from repro_torch.models import build_model, common

NEW_ARCHS = ("granite-8b", "mistral-nemo-12b", "chatglm3-6b",
             "granite-moe-1b-a400m", "olmoe-1b-7b")
CHATGLM, MISTRAL_GQA = "chatglm3-6b-smoke", "mistral-nemo-gqa"
TOL = 1e-4
_BUNDLES = {}


def _configs(arch):
    """(reference config, port config)."""
    if arch == MISTRAL_GQA:
        return tuple(dataclasses.replace(
            c, name=MISTRAL_GQA, num_heads=8, num_kv_heads=2, head_dim=16)
            for c in (jax_config("mistral-nemo-12b-smoke"),
                      get_config("mistral-nemo-12b-smoke")))
    return jax_config(arch), get_config(arch)


def _bundles(arch, seed=0, **replace):
    key = (arch, seed, tuple(sorted(replace.items())))
    if key not in _BUNDLES:
        jcfg, cfg = (dataclasses.replace(c, **replace)
                     for c in _configs(arch))
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


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_and_param_trees_match_reference(arch):
    """Every field of the config and of its -smoke and -tiny variants
    equals the reference's; the full model's parameter definitions equal
    the reference's leaf for leaf (paths, shapes, axes, init)."""
    assert arch in ARCH_NAMES
    for name in (arch, arch + "-smoke", arch + "-tiny"):
        ours, theirs = get_config(name), jax_config(name)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (
                name, f.name)
    ours = build_model(get_config(arch)).param_defs
    theirs = jax_tfm.param_defs(jax_config(arch))
    jleaves = jax.tree_util.tree_flatten_with_path(
        theirs, is_leaf=lambda d: hasattr(d, "shape"))[0]
    assert tree_paths(ours) == ["/".join(str(k.key) for k in path)
                                for path, _ in jleaves]
    for a, (_, b) in zip(tree_leaves(ours), jleaves):
        assert (a.shape, a.logical, a.init, a.scale) == (
            b.shape, b.logical, b.init, b.scale)


def test_full_configs_shapes():
    """The widths this slice brings to the card: KV < H, H hd != d_model
    (mistral-nemo-12b), half rotary (chatglm3-6b), and the parameter
    counts the chip phases size their buffers by."""
    n = {a: sum(int(np.prod(d.shape)) for d in tree_leaves(
        build_model(get_config(a)).param_defs)) for a in NEW_ARCHS}
    assert n["mistral-nemo-12b"] == 11_576_693_760
    assert n["olmoe-1b-7b"] == 6_816_860_160
    assert n["granite-moe-1b-a400m"] == 1_335_149_568
    cut = dataclasses.replace(get_config("chatglm3-6b"), num_layers=4)
    assert sum(int(np.prod(d.shape)) for d in tree_leaves(
        build_model(cut).param_defs)) == 1_348_505_600
    m = get_config("mistral-nemo-12b")
    assert m.num_heads * m.head_dim == 4096 != m.d_model == 5120
    assert (m.num_kv_heads, m.rope_theta, m.long_context_mode) == (
        8, 1e6, "full_kv")
    c = get_config("chatglm3-6b")
    assert (c.num_kv_heads, c.rotary_frac, c.tie_embeddings) == (
        2, 0.5, False)
    assert get_config(CHATGLM).num_kv_heads == 2


def _qkv(rng, B, S, H, KV, hd):
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 20])
def test_chunked_attention_matches_reference(window):
    """S = 70 in blocks of 32: both tails padded (70 -> 96), the blocks
    above the diagonal skipped, with window 20 the blocks behind it too; 4
    query heads on 2 KV heads.  Values against the reference's
    `chunked_attention` and the port's `attention`; gradients against
    autograd through `attention`."""
    q, k, v = _qkv(np.random.default_rng(1), 2, 70, 4, 2, 16)
    want = jax.jit(lambda q, k, v: jax_common.chunked_attention(
        q, k, v, causal=True, window=window, chunk=32))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = common.chunked_attention(tq, tk, tv, causal=True, window=window,
                                   chunk=32)
    _close(got.detach(), want, 1e-5)
    plain = common.attention(tq, tk, tv, causal=True, window=window)
    _close(got.detach(), plain.detach().numpy(), 1e-5)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=got.shape).astype(np.float32))
    g_chunk = torch.autograd.grad((got * w).sum(), (tq, tk, tv))
    g_plain = torch.autograd.grad((plain * w).sum(), (tq, tk, tv))
    for a, b in zip(g_chunk, g_plain):
        assert torch.isfinite(a).all()
        _close(a, b.numpy(), 1e-5)


def test_chunked_attention_one_block_and_skipped_rows():
    """chunk >= S is one block (the naive path's values); a window of 1
    leaves each row its own key only."""
    q, k, v = _qkv(np.random.default_rng(3), 1, 9, 4, 4, 8)
    for window in (None, 1):
        want = jax_common.chunked_attention(q, k, v, causal=True,
                                            window=window, chunk=64)
        got = common.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                       causal=True, window=window, chunk=64)
        _close(got, want, 1e-5)
        if window == 1:
            _close(got, v, 1e-6)


@pytest.mark.parametrize("arch,replace", [
    (CHATGLM, ()),
    (MISTRAL_GQA, (("attn_impl", "chunked"), ("attn_chunk", 32)))])
def test_loss_and_gradients_match_reference(arch, replace):
    """Loss and every gradient at seq 70 (the MISTRAL_GQA variant with
    ``attn_impl="chunked"``: blocks of 32 in both packages; its naive
    path's forward is held in the prefill test)."""
    jb, jp, pb, pp = _bundles(arch, **dict(replace))
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
    for path, a, g in zip(tree_paths(pp), jax.tree.leaves(want_g), grads):
        a = np.asarray(a)
        np.testing.assert_allclose(g.numpy(), a, atol=1e-3 * np.abs(a).max(),
                                   rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch", [CHATGLM, MISTRAL_GQA])
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 9 tokens, then 3 decode steps from the prefill's cache
    (per-slot positions on the last): each step's logits and the KV cache
    (KV heads, not H) against the reference's, the port's cache written
    in place."""
    jb, jp, pb, pp = _bundles(arch)
    cfg = pb.cfg
    V = cfg.vocab_size
    tokens = np.random.default_rng(1).integers(0, V, (2, 9), np.int32)
    want = jax.jit(jb.prefill_fn)(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = pb.prefill_fn(pp, {"tokens": torch.from_numpy(tokens)})
    assert got["pos"] == int(want["pos"]) == 9
    _close(got["logits"], want["logits"])
    for name in ("k", "v"):
        assert tuple(got["cache"][name].shape) == (
            cfg.num_layers, 2, 9, cfg.num_kv_heads, cfg.head_dim)
        _close(got["cache"][name], want["cache"][name])
    cache = {n: c.clone() for n, c in got["cache"].items()}
    ptrs = {n: c.data_ptr() for n, c in cache.items()}
    jcache = want["cache"]
    rng = np.random.default_rng(2)
    decode = jax.jit(jb.decode_fn)
    for step in range(3):
        tok = rng.integers(0, V, (2,), np.int32)
        pos = (np.array([9 + step, 9 + step], np.int32) if step == 2
               else 9 + step)
        w = decode(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.no_grad():
            g = pb.decode_fn(pp, torch.from_numpy(tok), cache,
                             torch.as_tensor(pos))
        assert g["cache"] is cache
        assert {n: c.data_ptr() for n, c in cache.items()} == ptrs
        _close(g["logits"], w["logits"])
        for name in jcache:
            _close(cache[name], w["cache"][name])
        jcache = w["cache"]


def test_chunked_prefill_on_cpu_follows_attn_impl():
    """On the CPU a prefill runs `_plain_attn`, so ``attn_impl="chunked"``
    reaches `chunked_attention` there, as in the reference's prefill."""
    jb, jp, pb, pp = _bundles(MISTRAL_GQA, attn_impl="chunked",
                              attn_chunk=4)
    tokens = np.random.default_rng(4).integers(0, pb.cfg.vocab_size, (2, 9),
                                               np.int32)
    want = jax.jit(jb.prefill_fn)(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = pb.prefill_fn(pp, {"tokens": torch.from_numpy(tokens)})
    _close(got["logits"], want["logits"])
