"""The port's hybrid family (Zamba2: a Mamba2 trunk with shared attention
blocks) against the reference on the CPU, on shared weights (the
reference's init, carried over with `repro_torch.convert.params_from_numpy`):
zamba2-7b-smoke (f32, two mamba layers, a shared block after the second),
zamba2-7b-tiny (one mamba layer and a shared block after it) and a 4-layer
smoke variant whose two sites use both shared blocks.  The SSD runs
through `repro_torch.kernels.ssd_intra_chunk` (B11's plain version on the
CPU, with the wrapper's autograd Function in training), its B and C shared
by the heads.

Covered: configs, the parameter tree and zamba2-7b's 6,842,307,792
parameters; the three mamba blocks; the loss and every gradient;
`forward_prefill`'s logits and every cache leaf, then decode steps with
the cache written in place; decode continuing prefill (the reference's
`test_decode_continues_prefill` on the port); the bf16 dtype promotion
(f32 residual stream after the first mamba block); the engine against the
port's sequential decode and the reference's engine; the serve and train
CLIs; three PDSGD steps of `run_training` against the reference's.

Tolerances (f32 unless said; measured on this CPU in brackets):
* loss: rtol 1e-6 [7e-8 relative];
* gradients: rtol 1e-4 + atol ``scale`` x the leaf's largest reference
  entry, ``scale`` 1e-4 on -tiny and -smoke [8e-6 and 3.8e-5 of it, on
  ``embed``] and 1e-3 at 4 layers [3.1e-4].  The random mamba stack
  amplifies f32 rounding: against a float64 evaluation of the port's
  gradients the reference's own f32 gradients are off by as much (smoke
  6.1e-5, 4 layers 2.6e-3 on ``embed``) as the port's (5.9e-5, 2.0e-3);
* mamba blocks, prefill logits and cache leaves, decode steps: atol = rtol
  = 1e-4 on -tiny and -smoke [2.6e-5 on the ``k`` cache, entries up to
  ~10], 1e-3 at 4 layers [1.1e-4];
* decode continuing prefill: the reference test's atol 2e-4, rtol 2e-3;
* bf16: |port - reference| <= 2^-8 (1 + max |reference|) per tensor, one
  bf16 rounding of its largest entry (the first block's projections round
  to bf16 in both, maybe in another order) [3.5e-6 of it at most];
* token streams: equal;
* training (-tiny, where that rounding stays small): losses rtol 1e-5;
  parameters after three steps atol 1e-5 + rtol 1e-4 [3.2e-7; 2.7 % of
  the tolerance at most].
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import make_lm_pipeline
from repro.launch.train import build_parser as jax_train_parser
from repro.launch.train import run_training as jax_run_training
from repro.models import build_model as jax_build
from repro.models import hybrid as jax_hybrid
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tfm
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro_torch import kernels  # noqa: F401  (before core.privacy)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.core.privacy import tree_leaves, tree_paths, tree_unflatten
from repro_torch.launch import serve, train
from repro_torch.models import build_model, hybrid, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (einsum_promoted, layer_views,
                                       rope_tables)
from repro_torch.serve import Request, ServeEngine, sequential_decode

SMOKE, TINY, FOUR = "zamba2-7b-smoke", "zamba2-7b-tiny", "four-layer"
TOL = 1e-4
_BUNDLES = {}


def _configs(arch):
    """(reference config, port config); FOUR is the smoke model at 4
    layers, sites 1 and 3 on shared blocks 0 and 1."""
    if arch == FOUR:
        return tuple(dataclasses.replace(c, num_layers=4) for c in
                     (jax_config(SMOKE), get_config(SMOKE)))
    return jax_config(arch), get_config(arch)


def _bundles(arch=SMOKE, seed=0):
    """(reference bundle, reference params, port bundle, port params) on
    the reference's init, built once per module."""
    key = (arch, seed)
    if key not in _BUNDLES:
        jcfg, cfg = _configs(arch)
        jb = jax_build(jcfg)
        jp = jb.init(jax.random.key(seed))
        pb = build_model(cfg)
        pp = params_from_numpy(jax.tree.map(np.asarray, jp))
        _BUNDLES[key] = (jb, jp, pb, pp)
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


def test_configs_and_param_tree_match_reference():
    """Configs resolve to the reference's fields and attention sites; the
    full model's parameter definitions equal the reference's leaf for leaf
    (6,842,307,792 parameters); the smoke and tiny trees cross
    `params_from_numpy` with the reference's paths, shapes, dtypes and
    values."""
    fields = ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "d_ff", "vocab_size", "head_dim",
              "rotary_frac", "ssm_state", "ssm_conv", "ssm_expand",
              "ssm_head_dim", "hybrid_attn_every", "hybrid_num_shared",
              "d_inner", "ssm_heads", "dtype", "source", "tie_embeddings")
    for arch in ("zamba2-7b", SMOKE, TINY):
        ours, theirs = get_config(arch), jax_config(arch)
        for f in fields:
            assert getattr(ours, f) == getattr(theirs, f), (arch, f)
        assert hybrid._attn_sites(ours) == jax_hybrid._attn_sites(theirs)
    assert hybrid._attn_sites(get_config("zamba2-7b")) == list(
        range(5, 81, 6))
    ours = build_model(get_config("zamba2-7b")).param_defs
    theirs = jax_hybrid.param_defs(jax_config("zamba2-7b"))
    jleaves = jax.tree_util.tree_flatten_with_path(
        theirs, is_leaf=lambda d: hasattr(d, "shape"))[0]
    assert tree_paths(ours) == ["/".join(str(k.key) for k in path)
                                for path, _ in jleaves]
    for a, (_, b) in zip(tree_leaves(ours), jleaves):
        assert (a.shape, a.logical, a.init, a.scale) == (
            b.shape, b.logical, b.init, b.scale)
    assert sum(int(np.prod(d.shape)) for d in tree_leaves(ours)) \
        == 6_842_307_792
    for arch in (SMOKE, TINY):
        _, jp, pb, pp = _bundles(arch)
        jpaths = ["/".join(str(k.key) for k in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(jp)[0]]
        assert tree_paths(pp) == jpaths == tree_paths(pb.param_defs)
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(pp)):
            assert b.dtype == torch.float32 and a.dtype == jnp.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_bf16_params_cross_unchanged():
    """`params_from_numpy` takes a bf16 hybrid tree bit for bit."""
    jcfg = dataclasses.replace(jax_config(TINY), dtype="bfloat16")
    jp = jax_build(jcfg).init(jax.random.key(1))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(pp)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            b.view(torch.int16).numpy(),
            np.asarray(a).view(np.int16))


def test_cache_spec_matches_reference():
    for arch in ("zamba2-7b", SMOKE, TINY):
        want = jax_hybrid.cache_spec(jax_config(arch), 3, 50)
        got = hybrid.cache_spec(get_config(arch), 3, 50)
        assert set(got) == set(want)
        for name, (shape, logical, dtype) in got.items():
            assert (shape, logical) == want[name][:2]
            assert (dtype, want[name][2]) in ((None, None),
                                              (torch.float32, "float32"))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_mamba_blocks_match_reference(kind):
    """One smoke mamba layer on a random residual stream: seq 70 pads the
    chunked scan to two chunks of 64; decode continues from random states
    at two per-slot positions."""
    _, jp, pb, pp = _bundles()
    jcfg, cfg = _configs(SMOKE)
    rng = np.random.default_rng(3)
    jl = jax_tfm.layer_slice(jp["mamba"], 1)
    tl = layer_views(pp["mamba"])[1]
    S = 1 if kind == "decode" else 70
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        if kind == "train":
            want = jax.jit(lambda p, x: jax_ssm.mamba_block_train(
                p, x, jcfg))(jl, x)
            _close(ssm.mamba_block_train(tl, torch.from_numpy(x), cfg), want)
            return
        if kind == "prefill":
            want, wst = jax.jit(lambda p, x: jax_ssm.mamba_block_prefill(
                p, x, jcfg))(jl, x)
            got, gst = ssm.mamba_block_prefill(tl, torch.from_numpy(x), cfg)
        else:
            st = (rng.normal(size=(2, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state)).astype(np.float32),
                  rng.normal(size=(2, cfg.ssm_conv - 1, cfg.d_inner
                                   + 2 * cfg.ssm_state)).astype(np.float32))
            want, wst = jax.jit(lambda p, x, s: jax_ssm.mamba_block_decode(
                p, x, s, jcfg))(jl, x, st)
            got, gst = ssm.mamba_block_decode(
                tl, torch.from_numpy(x), tuple(map(torch.from_numpy, st)),
                cfg)
    _close(got, want)
    for g, w in zip(gst, wst):
        _close(g, w)


@pytest.mark.parametrize("arch,scale", [(SMOKE, 1e-4), (TINY, 1e-4),
                                        (FOUR, 1e-3)])
def test_loss_and_gradients_match_reference(arch, scale):
    """S = 70 pads the chunked scan from 70 to 128 (two chunks of 64).
    -tiny's second shared block is never used: its gradient is zero in
    both."""
    jb, jp, pb, pp = _bundles(arch)
    batch = make_lm_pipeline(pb.cfg.vocab_size, 1, 2, 70, seed=1).batch_at(0)
    b0 = {k: v[0] for k, v in batch.items()}
    want_l, want_g = jax.jit(jax.value_and_grad(jb.loss_fn))(
        jp, jax.tree.map(jnp.asarray, b0))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(pp)]
    loss = pb.loss_fn(tree_unflatten(pp, leaves),
                      {k: torch.from_numpy(v) for k, v in b0.items()})
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-6)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for path, a, g in zip(tree_paths(pp), jax.tree.leaves(want_g), grads):
        a = np.asarray(a)
        g = np.zeros_like(a) if g is None else g.numpy()
        np.testing.assert_allclose(g, a, atol=scale * np.abs(a).max(),
                                   rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch,tol", [(SMOKE, TOL), (TINY, TOL),
                                      (FOUR, 1e-3)])
def test_prefill_and_decode_match_reference(arch, tol):
    """Prefill of 9 tokens, then 3 decode steps from the prefill's cache;
    each step's logits and every cache leaf against the reference's, the
    port's cache written in place."""
    jb, jp, pb, pp = _bundles(arch)
    V = pb.cfg.vocab_size
    tokens = np.random.default_rng(1).integers(0, V, (2, 9), np.int32)
    want = jax.jit(jb.prefill_fn)(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = pb.prefill_fn(pp, {"tokens": torch.from_numpy(tokens)})
    assert got["pos"] == int(want["pos"]) == 9
    _close(got["logits"], want["logits"], tol)
    assert set(got["cache"]) == set(want["cache"]) == {"ssm", "conv", "k",
                                                       "v"}
    for name in want["cache"]:
        _close(got["cache"][name], want["cache"][name], tol)
    cache = {n: c.clone() for n, c in got["cache"].items()}
    ptrs = {n: c.data_ptr() for n, c in cache.items()}
    jcache, pos = want["cache"], 9
    rng = np.random.default_rng(2)
    decode = jax.jit(jb.decode_fn)
    for _ in range(3):
        tok = rng.integers(0, V, (2,), np.int32)
        w = decode(jp, jnp.asarray(tok), jcache, jnp.int32(pos))
        with torch.no_grad():
            g = pb.decode_fn(pp, torch.from_numpy(tok), cache, pos)
        assert g["cache"] is cache and int(g["pos"]) == pos + 1
        assert {n: c.data_ptr() for n, c in cache.items()} == ptrs
        _close(g["logits"], w["logits"], tol)
        for name in jcache:
            _close(cache[name], w["cache"][name], tol)
        jcache, pos = w["cache"], pos + 1


def test_decode_continues_prefill():
    """The reference's tests/test_models_smoke.py::
    test_decode_continues_prefill on the port: decoding token S from the
    prefill of S tokens gives the logits of the prefill of S + 1 tokens
    (B = 2, S = 64, the smoke model's own init)."""
    cfg = get_config(SMOKE)
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


def _bf16_close(got: torch.Tensor, want, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 2.0 ** -8 * (1.0 + float(np.abs(want).max())), (what, err)


def test_bf16_residual_stream_promotes_like_reference():
    """zamba2-7b-tiny in bf16 at 2 layers (a shared block after each): the
    residual stream is bf16 into the first mamba block and f32 after it,
    block by block as the reference's; the prefill logits and every cache
    leaf are f32, as the reference's, with values within a bf16
    tolerance."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16", num_layers=2)
                 for c in _configs(TINY))
    jp = jax_build(jcfg).init(jax.random.key(4))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 20),
                                               np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    xj = jax_tfm.embed_tokens(jp, batch, jcfg)
    mamba = jax.jit(lambda p, x: jax_ssm.mamba_block_train(p, x, jcfg))
    site = jax.jit(lambda p, x: jax_tfm._layer_train(p, x, jcfg, None))
    with torch.no_grad():
        xt = tfm.embed_tokens(pp, {"tokens": torch.from_numpy(tokens)}, cfg)
        rope = rope_tables(20, cfg.head_dim, cfg.rotary_frac, cfg.rope_theta,
                           "cpu")
        shared = layer_views(pp["shared"])
        dtypes = []
        for i, p in enumerate(layer_views(pp["mamba"])):
            xj = mamba(jax_tfm.layer_slice(jp["mamba"], i), xj)
            xt = ssm.mamba_block_train(p, xt, cfg)
            _bf16_close(xt, xj, f"mamba {i}")
            xj = site(jax_hybrid._shared_slice(jp, i, jcfg), xj)
            xt = tfm._layer_train(shared[i % 2], xt, rope, cfg)
            _bf16_close(xt, xj, f"site {i}")
            dtypes.append((str(xt.dtype), str(xj.dtype)))
        assert dtypes == [("torch.float32", "float32")] * 2
        got = hybrid.forward_prefill(pp, {"tokens": torch.from_numpy(
            tokens)}, cfg)
    want = jax.jit(lambda p, b: jax_hybrid.forward_prefill(p, b, jcfg))(
        jp, batch)
    assert got["logits"].dtype == torch.float32
    assert want["logits"].dtype == jnp.float32
    _bf16_close(got["logits"], want["logits"], "logits")
    for name, leaf in want["cache"].items():
        assert str(got["cache"][name].dtype)[6:] == str(leaf.dtype) \
            == "float32", name
        _bf16_close(got["cache"][name], leaf, name)


def test_einsum_promoted_keeps_single_dtype_bits():
    """The dense and xLSTM blocks keep their bits: on operands of one
    dtype `einsum_promoted` is `torch.einsum`; on bf16 against f32 it
    computes in f32."""
    g = torch.Generator().manual_seed(6)
    a, b = torch.randn(3, 5, 8, generator=g), torch.randn(8, 4, generator=g)
    for dt in (torch.float32, torch.bfloat16):
        got = einsum_promoted("bsd,df->bsf", a.to(dt), b.to(dt))
        want = torch.einsum("bsd,df->bsf", a.to(dt), b.to(dt))
        assert got.dtype == dt and torch.equal(got, want)
    mixed = einsum_promoted("bsd,df->bsf", a, b.bfloat16())
    assert mixed.dtype == torch.float32
    assert torch.equal(mixed, torch.einsum("bsd,df->bsf", a,
                                           b.bfloat16().float()))


def _requests(cls, V, n_req=6, prompt_len=6, gen=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(req_id=i, tokens=rng.integers(0, V, prompt_len + (i % 3),
                                              dtype=np.int32),
                max_new_tokens=gen - (i % 2)) for i in range(n_req)]


def test_engine_matches_sequential_and_reference_engine():
    """6 requests on 3 slots with ragged prompts and budgets, greedy: the
    engine decodes exactly the tokens of the port's sequential decode and
    of the reference's engine.  A decode that returned fresh states
    without writing the slab would serve stale states here."""
    jb, jp, pb, pp = _bundles()
    V = pb.cfg.vocab_size
    max_seq_len = 6 + 2 + 5
    eng = ServeEngine(pb, pp, slots=3, max_seq_len=max_seq_len,
                      decode_chunk=3, seed=0)
    with torch.no_grad():
        got = {c.req_id: c.tokens for c in eng.run(_requests(Request, V))}
        assert sorted(got) == list(range(6))
        for r in _requests(Request, V):
            seq = sequential_decode(
                pb, pp, {"tokens": torch.from_numpy(r.tokens)[None]},
                r.req_id, r.max_new_tokens, base_key=prng.key(0),
                max_seq_len=max_seq_len)
            assert got[r.req_id] == seq, (r.req_id, got[r.req_id], seq)
    jeng = JaxEngine(jb, jp, slots=3, max_seq_len=max_seq_len,
                     decode_chunk=3, seed=0)
    want = {c.req_id: c.tokens for c in jeng.run(_requests(JaxRequest, V))}
    assert got == want


@pytest.mark.parametrize("arch", [SMOKE, TINY])
def test_serve_cli_parity(arch, capsys):
    argv = ["--arch", arch, "--slots", "2", "--requests", "3",
            "--prompt-len", "7", "--gen-tokens", "4", "--decode-chunk", "2",
            "--device", "cpu", "--parity-check"]
    assert serve.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["parity"] == "ok" and out["arch"] == arch
    assert out["completed"] == 3 and out["generated_tokens"] == 12


def test_run_training_walks_reference_trajectory():
    """Three PDSGD steps of -tiny, 4 agents on a ring, seq 32, same flags
    and initial weights: the gradients go through the autograd Function
    around B11's plain version, B and C shared by the heads."""
    flags = ["--arch", TINY, "--agents", "4", "--topology", "ring",
             "--steps", "3", "--log-every", "1", "--seq-len", "32",
             "--seed", "3"]
    want = jax_run_training(jax_train_parser().parse_args(flags))
    _, jp, _, _ = _bundles(TINY, seed=3)
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


def test_train_cli_runs_on_cpu(capsys):
    assert train.main(["--arch", TINY, "--agents", "3", "--steps", "2",
                       "--seq-len", "16", "--log-every", "1", "--device",
                       "cpu"]) == 0
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)
