"""The port's enc-dec (audio) family, seamless-m4t-medium, against the
reference on the CPU, on shared weights (the reference's init carried over
with `repro_torch.convert.params_from_numpy`) and inputs made from a numpy
seed: configs and the parameter tree, `gelu_mlp`, loss and gradients,
prefill (logits and the ``k``, ``v``, ``xk``, ``xv`` caches), three decode
steps with a scalar and with per-slot positions, the windowed
cross-attention, and the oneshot CLI's synthetic frames and streams.

The smoke model (2 + 2 layers, d_model 256, 8 heads of 32) is as
ill-conditioned as the dense smoke models (tests/test_torch_serve.py): its
random attention is sharp and its LayerNorms amplify f32 rounding.
Against a float64 evaluation of the port on the same weights the
reference's own f32 gradients are off by up to 3.5e-3 of a leaf's largest
entry and the port's by up to 4.5e-3; its ``k`` cache (entries up to 22.5)
by 1.2e-3 and 2.9e-3, its decode logits (entries up to 1.3) by up to
1.5e-4 and 3.1e-4.  So the smoke model's gradients are held against
float64, its logits and caches against the reference at 1e-3 of the
tensor's largest entry, and the -tiny model (1 + 1 layers, d_model 32)
carries the tight comparison with the reference.

Tolerances (f32; measured on this CPU in brackets):
* loss: rtol 1e-5 [1.3e-6 smoke, 1.1e-7 tiny];
* gradients, -tiny: atol 1e-3 x the leaf's largest entry + rtol 1e-4
  [9.4e-5 of the largest entry]; -smoke: each leaf within twice the
  reference's largest distance from float64 (relative to the leaf's
  largest float64 entry) [port 4.5e-3 against 2 x 3.5e-3];
* prefill and decode logits and cache leaves: -tiny atol = rtol = 1e-4
  [2.2e-6 on the logits, 8.8e-5 on ``xv``]; -smoke atol 1e-3 x the
  tensor's largest entry, rtol 1e-4 [2.1e-4 of it on the decode logits,
  4.4e-4 on the windowed variant's ``k``];
* `gelu_mlp`: atol = rtol = 1e-5 f32 [1.0e-5 on entries up to 13: the
  40-term sums in another order], bf16 bitwise;
* synthetic frames: bfloat16 bitwise; float32 within 3 ulp of the
  normal draw, then the product's rounding (the known ``prng.normal``
  deviation, XLA's float32 log1p: ROADMAP C) [22 of 2040 draws differ,
  by up to 3 ulp]; greedy streams: equal.
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
from repro.models import common as jax_common
from repro.models import encdec as jax_encdec
from repro_torch import kernels  # noqa: F401  (before core.privacy)
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.core.privacy import tree_leaves, tree_paths, tree_unflatten
from repro_torch.launch import serve
from repro_torch.models import build_model, common

ARCH = "seamless-m4t-medium"
SMOKE, TINY = ARCH + "-smoke", ARCH + "-tiny"
TOL = 1e-4
B, S, S_ENC = 2, 12, 24
_BUNDLES = {}


def _bundles(arch, **replace):
    """(reference bundle, reference params, port bundle, port params)."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _BUNDLES:
        jb = jax_build(dataclasses.replace(jax_config(arch), **replace))
        jp = jb.init(jax.random.key(0))
        pb = build_model(dataclasses.replace(get_config(arch), **replace))
        _BUNDLES[key] = (jb, jp, pb,
                         params_from_numpy(jax.tree.map(np.asarray, jp)))
    return _BUNDLES[key]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tests stay fast beside other xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
            "frames": (rng.normal(size=(B, S_ENC, cfg.d_model)) * 0.5
                       ).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got: torch.Tensor, want, tol=TOL, atol=None):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=tol if atol is None else atol, rtol=tol)


def _close_model(got, want, arch):
    """Logits and cache leaves: -tiny atol = rtol = 1e-4; -smoke atol 1e-3
    of the tensor's largest entry (module docstring)."""
    want = np.asarray(want, np.float32)
    _close(got, want, atol=1e-3 * np.abs(want).max() if arch == SMOKE
           else None)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def test_configs_and_param_tree_match_reference():
    """Every field of the config and of its -smoke and -tiny variants
    equals the reference's (``num_encoder_layers`` reduced to 2 and 1);
    the parameter definitions equal `repro.models.encdec.param_defs` leaf
    for leaf; the full model has 615,114,752 parameters (vocab 256206
    padded to 256512)."""
    assert ARCH in ARCH_NAMES
    for name in (ARCH, SMOKE, TINY):
        ours, theirs = get_config(name), jax_config(name)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (
                name, f.name)
    assert [get_config(n).num_encoder_layers for n in (ARCH, SMOKE, TINY)
            ] == [12, 2, 1]
    for name in (ARCH, TINY):
        ours = build_model(get_config(name)).param_defs
        jleaves = jax.tree_util.tree_flatten_with_path(
            jax_encdec.param_defs(jax_config(name)),
            is_leaf=lambda d: hasattr(d, "shape"))[0]
        assert tree_paths(ours) == ["/".join(str(k.key) for k in path)
                                    for path, _ in jleaves]
        for a, (_, b) in zip(tree_leaves(ours), jleaves):
            assert (a.shape, a.logical, a.init, a.scale) == (
                b.shape, b.logical, b.init, b.scale)
    defs = build_model(get_config(ARCH)).param_defs
    assert sum(int(np.prod(d.shape)) for d in tree_leaves(defs)) == \
        615_114_752
    assert defs["embed"].shape == (256512, 1024)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    """`common.gelu_mlp` against the reference's (``jax.nn.gelu``'s tanh
    form in f32, cast back)."""
    rng = np.random.default_rng(5)
    x, wu, wd = (rng.normal(size=s).astype(np.float32)
                 for s in ((3, 7, 16), (16, 40), (40, 16)))
    jt = getattr(jnp, dtype)
    want = np.asarray(jax_common.gelu_mlp(*(jnp.asarray(a, jt)
                                            for a in (x, wu, wd)))
                      .astype(jnp.float32))
    got = common.gelu_mlp(*(torch.from_numpy(a).to(getattr(torch, dtype))
                            for a in (x, wu, wd)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


def _value_and_grad(pb, params, batch):
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    loss = pb.loss_fn(tree_unflatten(params, leaves), batch)
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", [TINY, SMOKE])
def test_loss_and_gradients_match_reference(arch):
    """Loss and every gradient at S = 12 decoder tokens over 24 frames;
    the smoke model's gradients held against a float64 evaluation of the
    port (module docstring)."""
    jb, jp, pb, pp = _bundles(arch)
    batch = _batch(pb.cfg)
    want_l, want_g = jax.jit(jax.value_and_grad(jb.loss_fn))(
        jp, jax.tree.map(jnp.asarray, batch))
    loss, grads = _value_and_grad(pb, pp, _torch(batch))
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5)
    want_g = [np.asarray(a) for a in jax.tree.leaves(want_g)]
    paths = tree_paths(pp)
    if arch == TINY:
        for path, a, g in zip(paths, want_g, grads):
            np.testing.assert_allclose(g.numpy(), a,
                                       atol=1e-3 * np.abs(a).max(),
                                       rtol=1e-4, err_msg=path)
        return
    b64 = _torch(batch)
    b64["frames"] = b64["frames"].double()
    loss64, g64 = _value_and_grad(pb, _cast(pp, torch.float64), b64)
    np.testing.assert_allclose(float(loss.detach()), float(loss64.detach()),
                               rtol=1e-5)
    g64 = [g.numpy() for g in g64]
    ref_off = max(np.abs(a - c).max() / np.abs(c).max()
                  for a, c in zip(want_g, g64))
    for path, g, c in zip(paths, grads, g64):
        off = np.abs(g.numpy() - c).max() / np.abs(c).max()
        assert off <= 2 * ref_off, (path, off, ref_off)


def _prefill_then_decode(arch, per_slot: bool, **replace):
    """Prefill of 12 tokens over 24 frames, then 3 decode steps from that
    cache (``per_slot``: (B,) positions, the rows one apart), against the
    reference step by step; the port's cache written in place."""
    jb, jp, pb, pp = _bundles(arch, **replace)
    cfg = pb.cfg
    batch = {k: v for k, v in _batch(cfg, seed=1).items() if k != "labels"}
    want = jax.jit(jb.prefill_fn)(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = pb.prefill_fn(pp, _torch(batch))
    assert got["pos"] == int(want["pos"]) == S
    _close_model(got["logits"], want["logits"], arch)
    shapes = {"k": (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim),
              "xk": (cfg.num_layers, B, S_ENC, cfg.num_kv_heads,
                     cfg.head_dim)}
    for name in ("k", "v", "xk", "xv"):
        assert tuple(got["cache"][name].shape) == shapes[name.replace(
            "v", "k")]
        _close_model(got["cache"][name], want["cache"][name], arch)
    cache = {n: c.clone() for n, c in got["cache"].items()}
    ptrs = {n: c.data_ptr() for n, c in cache.items()}
    jcache = want["cache"]
    rng = np.random.default_rng(2)
    decode = jax.jit(jb.decode_fn)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B,), np.int32)
        pos = (np.array([S + step, S + step - 1], np.int32) if per_slot
               else np.int32(S + step))
        w = decode(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.no_grad():
            g = pb.decode_fn(pp, torch.from_numpy(tok), cache,
                             torch.as_tensor(pos))
        assert g["cache"] is cache
        assert {n: c.data_ptr() for n, c in cache.items()} == ptrs
        np.testing.assert_array_equal(g["pos"].numpy(), np.asarray(w["pos"]))
        _close_model(g["logits"], w["logits"], arch)
        for name in jcache:
            _close_model(cache[name], w["cache"][name], arch)
        jcache = w["cache"]


@pytest.mark.parametrize("arch", [TINY, SMOKE])
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar_pos",
                                                         "per_slot_pos"])
def test_prefill_and_decode_match_reference(arch, per_slot):
    _prefill_then_decode(arch, per_slot)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar_pos",
                                                         "per_slot_pos"])
def test_windowed_cross_attention_matches_reference(per_slot):
    """``cross_attn_window = 8`` (each decoder position attends to the
    frames within 4 of its scaled position: 9 of the 24) in training
    (loss), prefill and decode."""
    _prefill_then_decode(SMOKE, per_slot, cross_attn_window=8)
    jb, jp, pb, pp = _bundles(SMOKE, cross_attn_window=8)
    batch = _batch(pb.cfg)
    want = jax.jit(jb.loss_fn)(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = pb.loss_fn(pp, _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    unwindowed = _bundles(SMOKE)[2].loss_fn(pp, _torch(batch))
    assert abs(float(unwindowed) - float(got)) > 1e-3


def test_encoder_chunked_attention_on_cpu():
    """``attn_impl = "chunked"`` sends the CPU encoder's bidirectional
    attention (and the decoder's causal one) through `chunked_attention`
    (blocks of 8 over 24 frames), as the reference's: equal prefill
    logits."""
    jb, jp, pb, pp = _bundles(TINY, attn_impl="chunked", attn_chunk=8)
    batch = {k: v for k, v in _batch(pb.cfg, 3).items() if k != "labels"}
    want = jax.jit(jb.prefill_fn)(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = pb.prefill_fn(pp, _torch(batch))
    _close(got["logits"], want["logits"])
    _close(got["cache"]["xk"], want["cache"]["xk"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_frames_bitwise(dtype):
    """`launch.serve.synthetic_normal` (drawn row by row) is the
    reference's ``jax.random.normal(fold_in(key(seed + 1), 1), shape,
    dtype) * 0.1``: bit for bit in bfloat16, within 3 ulp of the draw in
    float32 (module docstring)."""
    shape = (3, 17, 40)
    key = jax.random.fold_in(jax.random.key(4), 1)
    want = np.asarray((jax.random.normal(key, shape, getattr(jnp, dtype))
                       * 0.1).astype(jnp.float32))
    got = serve.synthetic_normal(prng.fold_in(prng.key(4), 1), shape,
                                 getattr(torch, dtype), "cpu")
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        # 3 ulp of the draw, carried through the product, and its rounding
        bound = (3 * np.spacing(np.abs(want / np.float32(0.1))) * 0.1
                 + np.spacing(np.abs(want)))
        assert (np.abs(got.numpy() - want) <= bound).all()


def test_cli_oneshot_matches_reference(capsys):
    """``python -m repro_torch.launch.serve --arch seamless-m4t-medium-smoke
    --device cpu --parity-check``: ``--mode auto`` is oneshot, every row
    equals its sequential decode, and on the reference's weights the
    first request's greedy stream equals the reference CLI's
    ``generated_first_req`` for the same seed (the reference's
    ``_run_oneshot`` on the same flags)."""
    import json
    argv = ["--arch", SMOKE, "--device", "cpu", "--parity-check"]
    assert serve.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["mode"] == "oneshot" and out["parity"] == "ok"
    assert out["completed"] == 4 and out["generated_tokens"] == 64
    jb, jp, pb, pp = _bundles(SMOKE)
    args = serve.build_parser().parse_args(argv)
    got = serve.run_serving(args, init_params=pp)["result"]
    jargs = jax_serve.main.__globals__["argparse"].Namespace(**{
        **vars(args), "model_parallel": 1})
    want = jax_serve._run_oneshot(jb, jp, jargs)
    assert got["parity"] == "ok"
    assert got["generated_first_req"] == want["generated_first_req"]
