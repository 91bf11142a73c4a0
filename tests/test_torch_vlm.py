"""The port's VLM family, llava-next-34b (the dense transformer whose first
``num_prefix_embeds`` positions are image embeddings from a stub
frontend), against the reference on the CPU, on shared weights (the
reference's init carried over with `repro_torch.convert.params_from_numpy`)
and inputs made from a numpy seed.

The smoke reduction (8 heads of 32 on min(8, 8) KV heads) leaves KV = H,
so beside llava-next-34b-smoke the tests run ``GQA``: the same model with
``num_kv_heads = 2`` (4 query heads a KV head), built by the same
`dataclasses.replace` in both packages.

Covered: configs and the parameter tree; `embed_tokens` with S > P and S
< P (a sequence of P); the prefix-weighted `loss_fn` (value and every
gradient); prefill with a prefix (logits and caches) and three decode
steps; the synthetic prefix draw; the continuous engine on the CPU with
``--parity-check``, and its streams against the reference's engine.

Tolerances (f32; measured on this CPU in brackets):
* `embed_tokens`: bitwise;
* loss: rtol 1e-5 [2.6e-7];
* gradients: atol 1e-3 x the leaf's largest entry + rtol 1e-4, as the
  dense GQA smoke models' (tests/test_torch_gqa.py) [2.5e-4 of it];
* prefill and decode logits: atol = rtol = 1e-4, the dense family's
  serve tolerance [2.7e-5];
* cache leaves: atol 2e-5 x the leaf's largest entry + rtol 1e-4 [1.8e-4
  on entries up to 22 (8e-6 of it), on a near-zero entry: each package
  lies 1e-4 from a float64 evaluation of the port there (reference
  1.2e-4 and 3.0e-4, port 9.8e-5 and 4.5e-4 on the GQA variant's caches
  of scale 43), so 1e-4 absolute is below what f32 attains];
* the prefix draw: bfloat16 bitwise; float32 within 3 ulp of the normal
  draw, then the product's rounding (ROADMAP C: XLA's float32 log1p);
* engine streams: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import serve as jax_serve
from repro.models import build_model as jax_build
from repro.models import transformer as jax_tfm
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro_torch import kernels  # noqa: F401  (before core.privacy)
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.privacy import tree_leaves, tree_paths, tree_unflatten
from repro_torch.launch import serve
from repro_torch.models import build_model, transformer
from repro_torch.serve import Request, ServeEngine

ARCH = "llava-next-34b"
SMOKE, GQA = ARCH + "-smoke", "llava-next-34b-gqa-smoke"
TOL = 1e-4
_BUNDLES = {}


def _configs(arch):
    """(reference config, port config)."""
    if arch == GQA:
        return tuple(dataclasses.replace(c, name=GQA, num_kv_heads=2)
                     for c in (jax_config(SMOKE), get_config(SMOKE)))
    return jax_config(arch), get_config(arch)


def _bundles(arch):
    """(reference bundle, reference params, port bundle, port params)."""
    if arch not in _BUNDLES:
        jcfg, cfg = _configs(arch)
        jb = jax_build(jcfg)
        jp = jb.init(jax.random.key(0))
        _BUNDLES[arch] = (jb, jp, build_model(cfg),
                          params_from_numpy(jax.tree.map(np.asarray, jp)))
    return _BUNDLES[arch]


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


def _close_cache(got: torch.Tensor, want):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2e-5 * np.abs(want).max(), rtol=TOL)


def _batch(cfg, S, seed=0, B=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
            "prefix_embeds": (rng.normal(size=(
                B, cfg.num_prefix_embeds, cfg.d_model)) * 0.1
                ).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_configs_and_param_tree_match_reference():
    """Every field of the config and of its -smoke and -tiny variants
    equals the reference's (2304 prefix embeds, 16 on -smoke, 4 on
    -tiny); the parameter definitions equal the reference's; the 24-layer
    cut the card serves has 13,847,321,600 parameters."""
    assert ARCH in ARCH_NAMES
    for name in (ARCH, SMOKE, ARCH + "-tiny"):
        ours, theirs = get_config(name), jax_config(name)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (
                name, f.name)
    assert [get_config(n).num_prefix_embeds for n in (
        ARCH, SMOKE, ARCH + "-tiny")] == [2304, 16, 4]
    ours = build_model(get_config(ARCH)).param_defs
    jleaves = jax.tree_util.tree_flatten_with_path(
        jax_tfm.param_defs(jax_config(ARCH)),
        is_leaf=lambda d: hasattr(d, "shape"))[0]
    assert tree_paths(ours) == ["/".join(str(k.key) for k in path)
                                for path, _ in jleaves]
    for a, (_, b) in zip(tree_leaves(ours), jleaves):
        assert (a.shape, a.logical, a.init, a.scale) == (
            b.shape, b.logical, b.init, b.scale)
    cut = dataclasses.replace(get_config(ARCH), num_layers=24)
    assert sum(int(np.prod(d.shape)) for d in tree_leaves(
        build_model(cut).param_defs)) == 13_847_321_600


@pytest.mark.parametrize("S", [24, 10], ids=["S_gt_P", "S_lt_P"])
def test_embed_tokens_replaces_the_first_positions(S):
    """The first P = 16 positions are the prefix embeds (replaced, not
    prepended); a prompt of 10 < P tokens gives a sequence of P."""
    jb, jp, pb, pp = _bundles(SMOKE)
    batch = {k: v for k, v in _batch(pb.cfg, S).items() if k != "labels"}
    want = np.asarray(jax_tfm.embed_tokens(
        jp, jax.tree.map(jnp.asarray, batch), jb.cfg))
    got = transformer.embed_tokens(pp, _torch(batch), pb.cfg)
    assert got.shape == (2, max(S, 16), pb.cfg.d_model)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, :16].numpy(),
                                  batch["prefix_embeds"])


@pytest.mark.parametrize("arch", [SMOKE, GQA])
def test_prefix_weighted_loss_and_gradients_match_reference(arch):
    """S = 24 with P = 16: the loss averages the 8 text positions only
    (the prefix positions weighted 0 over the whole padded vocab, as the
    reference's); value and every gradient."""
    jb, jp, pb, pp = _bundles(arch)
    batch = _batch(pb.cfg, 24, seed=1)
    want_l, want_g = jax.jit(jax.value_and_grad(jb.loss_fn))(
        jp, jax.tree.map(jnp.asarray, batch))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(pp)]
    loss = pb.loss_fn(tree_unflatten(pp, leaves), _torch(batch))
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    for path, a, g in zip(tree_paths(pp), jax.tree.leaves(want_g), grads):
        a = np.asarray(a)
        np.testing.assert_allclose(g.numpy(), a, atol=1e-3 * np.abs(a).max(),
                                   rtol=1e-4, err_msg=path)
    # the prefix positions carry no loss: their labels change nothing
    moved = dict(batch, labels=batch["labels"].copy())
    moved["labels"][:, :16] = 0
    with torch.no_grad():
        assert float(pb.loss_fn(pp, _torch(moved))) == float(loss)


@pytest.mark.parametrize("arch", [SMOKE, GQA])
def test_prefill_and_decode_with_prefix_match_reference(arch):
    """Prefill of a 24-token prompt whose first 16 positions are the
    prefix, then 3 decode steps (per-slot positions on the last): logits
    and the KV cache (KV heads) against the reference's, written in
    place."""
    jb, jp, pb, pp = _bundles(arch)
    cfg = pb.cfg
    batch = {k: v for k, v in _batch(cfg, 24, seed=2).items()
             if k != "labels"}
    want = jax.jit(jb.prefill_fn)(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = pb.prefill_fn(pp, _torch(batch))
    assert got["pos"] == int(want["pos"]) == 24
    _close(got["logits"], want["logits"])
    for name in ("k", "v"):
        assert tuple(got["cache"][name].shape) == (
            cfg.num_layers, 2, 24, cfg.num_kv_heads, cfg.head_dim)
        _close_cache(got["cache"][name], want["cache"][name])
    cache = got["cache"]
    jcache = want["cache"]
    rng = np.random.default_rng(3)
    decode = jax.jit(jb.decode_fn)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2,), np.int32)
        pos = (np.array([24 + step, 24 + step], np.int32) if step == 2
               else np.int32(24 + step))
        w = decode(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.no_grad():
            g = pb.decode_fn(pp, torch.from_numpy(tok), cache,
                             torch.as_tensor(pos))
        assert g["cache"] is cache
        _close(g["logits"], w["logits"])
        for name in jcache:
            _close_cache(cache[name], w["cache"][name])
        jcache = w["cache"]


def _args(argv):
    args = serve.build_parser().parse_args(argv)
    jargs = jax_serve.main.__globals__["argparse"].Namespace(**{
        **vars(args), "model_parallel": 1})
    return args, jargs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_prefix_draw_matches_reference(dtype):
    """`launch.serve._synthetic_requests`' prompts and prefix embeds
    (``normal(fold_in(key(seed + 1), 2), (n, P, d), dtype) * 0.1``)
    against the reference's: prompts and bf16 prefixes bitwise, f32
    prefixes within 3 ulp of the draw."""
    _, jargs = _args(["--requests", "3", "--prompt-len", "20", "--seed", "5"])
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype)
                 for c in _configs(SMOKE))
    want = jax_serve._synthetic_requests(jcfg, jax_build(jcfg), jargs)
    got = serve._synthetic_requests(cfg, jargs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.prefix_embeds.dtype == getattr(torch, dtype)
        assert tuple(a.prefix_embeds.shape) == (16, cfg.d_model)
        g = a.prefix_embeds.float().numpy()
        w = np.asarray(b.prefix_embeds).astype(np.float32)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(g, w)
        else:
            bound = (3 * np.spacing(np.abs(w / np.float32(0.1))) * 0.1
                     + np.spacing(np.abs(w)))
            assert (np.abs(g - w) <= bound).all()


@pytest.mark.parametrize("arch", [SMOKE, GQA])
def test_engine_with_prefix_matches_reference_engine(arch):
    """6 requests (prompts of 10 and 20 tokens, so some shorter than P =
    16) on 3 slots: the port's engine equals its sequential decode and the
    reference's engine on the same requests, prefixes included."""
    jb, jp, pb, pp = _bundles(arch)
    cfg = pb.cfg
    rng = np.random.default_rng(4)
    reqs = [(i, rng.integers(0, cfg.vocab_size, 10 + 10 * (i % 2),
                             np.int32),
             (rng.normal(size=(16, cfg.d_model)) * 0.1).astype(np.float32))
            for i in range(6)]
    cap = 20 + 5 + 16
    eng = ServeEngine(pb, pp, slots=3, max_seq_len=cap, decode_chunk=2)
    got = {c.req_id: c.tokens for c in eng.run([
        Request(req_id=i, tokens=t, max_new_tokens=5,
                prefix_embeds=torch.from_numpy(p)) for i, t, p in reqs])}
    jeng = JaxEngine(jb, jp, slots=3, max_seq_len=cap, decode_chunk=2)
    want = {c.req_id: c.tokens for c in jeng.run([
        JaxRequest(req_id=i, tokens=t, max_new_tokens=5, prefix_embeds=p)
        for i, t, p in reqs])}
    assert got == want
    assert all(len(t) == 5 for t in got.values())


def test_cli_engine_with_prefix_parity(capsys):
    """``python -m repro_torch.launch.serve --arch llava-next-34b-smoke
    --device cpu --parity-check``: continuous mode with the synthetic
    prefix embeds, every request equal to its sequential decode."""
    import json
    argv = ["--arch", SMOKE, "--slots", "2", "--requests", "3",
            "--prompt-len", "20", "--gen-tokens", "4", "--decode-chunk", "2",
            "--device", "cpu", "--parity-check"]
    assert serve.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "continuous" and out["parity"] == "ok"
    assert out["completed"] == 3 and out["generated_tokens"] == 12
