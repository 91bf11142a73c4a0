"""Per-layer recompute in training (`models.common.remat`, the reference's
per-layer ``jax.checkpoint``), one smoke config of each family: dense
(stablelm-3b), MoE (granite-moe-1b-a400m), VLM (llava-next-34b, 16
prefix embeds), enc-dec (seamless-m4t-medium), xLSTM (xlstm-125m) and
hybrid (zamba2-7b).

* Under ``remat_policy="full"`` and ``"save_collectives"`` the loss and
  every gradient are bitwise those of the same layer bodies run without
  recompute (the loops below, written out here).
* Both are within each family's existing tolerance of the reference's
  ``value_and_grad`` under the same policy, on shared weights (the
  reference's init through `repro_torch.convert.params_from_numpy`) and
  the same numpy inputs (the enc-dec family on -tiny, where its existing
  tight comparison runs: its smoke model is ill-conditioned,
  tests/test_torch_encdec.py).
* Recompute is real, as ``torch.autograd.graph.saved_tensors_hooks``
  sees it: with recompute no tensor is packed while a layer body runs
  (without it, every body packs its activations), and "save_collectives"
  packs exactly one tensor more per transformer layer than "full": the
  output of the attention's ``wo`` projection (``attn_out``).  That is
  the reference's residual set: its ``print_saved_residuals`` shows the
  ``attn_out`` of ``transformer.py:140`` once per layer under
  "save_collectives" and ``ffn_out`` (``:144:12``) never, as the FFN's
  output feeds only an addition, whose backward keeps no value.  The
  other families recompute fully under either policy, as the
  reference's ``jax.checkpoint`` without a policy does.

Tolerances (f32): loss rtol 1e-5; gradients as each family's own test
file holds them: atol 1e-3 x the leaf's largest reference entry + rtol
1e-4 (dense, MoE, VLM, enc-dec -tiny), atol 2e-6 + rtol 1e-4 (xLSTM),
atol 1e-4 x the leaf's largest entry + rtol 1e-4 (hybrid).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch import kernels  # noqa: F401  (before core.privacy)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.privacy import tree_leaves, tree_paths, tree_unflatten
from repro_torch.models import build_model, common, encdec, hybrid, xlstm
from repro_torch.models import transformer as tfm

# family -> (arch, S, gradient tolerance (scale of the leaf's largest
# entry, or an absolute atol))
FAMILIES = {
    "dense": ("stablelm-3b-smoke", 16, ("scale", 1e-3)),
    "moe": ("granite-moe-1b-a400m-smoke", 16, ("scale", 1e-3)),
    "vlm": ("llava-next-34b-smoke", 24, ("scale", 1e-3)),
    "encdec": ("seamless-m4t-medium-smoke", 16, ("scale", 1e-3)),
    "xlstm": ("xlstm-125m-smoke", 16, ("atol", 2e-6)),
    "hybrid": ("zamba2-7b-smoke", 16, ("scale", 1e-4)),
}
POLICIES = ("full", "save_collectives")
TRANSFORMER = ("dense", "moe", "vlm")
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: CPU reductions' bits depend on the thread count
    (the embedding's backward accumulates in parallel)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    B = 2
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if cfg.family == "audio":
        batch["frames"] = (rng.normal(size=(B, S, cfg.d_model))
                           * 0.5).astype(np.float32)
    if cfg.num_prefix_embeds:
        batch["prefix_embeds"] = (rng.normal(size=(
            B, cfg.num_prefix_embeds, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _shared(arch: str, policy: str):
    """(reference bundle, its params, port params) on the reference's
    init, the config at ``policy``."""
    key = (arch, policy)
    if key not in _CACHE:
        jb = jax_build(dataclasses.replace(jax_config(arch),
                                           remat_policy=policy))
        jp = jb.init(jax.random.key(0))
        _CACHE[key] = (jb, jp, params_from_numpy(jax.tree.map(np.asarray,
                                                              jp)))
    return _CACHE[key]


# -- the layer bodies run without recompute -------------------------------


def _plain_transformer(params, batch, cfg):
    x = tfm.embed_tokens(params, batch, cfg)
    rope = common.rope_tables(x.shape[1], cfg.head_dim, cfg.rotary_frac,
                              cfg.rope_theta, x.device)
    for p in common.layer_views(params["layers"]):
        x = tfm._layer_train(p, x, rope, cfg)
    return tfm.unembed(params, tfm._final_norm(params, x, cfg), cfg)


def _plain_xlstm(params, batch, cfg):
    x = tfm.embed_tokens(params, batch, cfg)
    for kind, _, p in xlstm._blocks(params, cfg):
        x = xlstm._BLOCK[kind](p, x, cfg)
    return tfm.unembed(params, common.rms_norm(x, params["final_norm_gamma"]),
                       cfg)


def _plain_hybrid(params, batch, cfg):
    x = tfm.embed_tokens(params, batch, cfg)
    rope = hybrid._rope(cfg, x.shape[1], x.device)
    for p, site in hybrid._blocks(params, cfg):
        x = hybrid.ssm.mamba_block_train(p, x, cfg)
        if site is not None:
            x = tfm._layer_train(site[1], x, rope, cfg)
    return tfm.unembed(params, common.rms_norm(x, params["final_norm_gamma"]),
                       cfg)


def _plain_encdec(params, batch, cfg):
    frames = batch["frames"]
    B, S, d = frames.shape
    x = frames + encdec._sinusoidal_positions(S, d, frames.dtype,
                                              frames.device)[None]
    rope = encdec._rope(S, cfg, x.device)
    for p in common.layer_views(params["encoder"]):
        x = encdec._enc_layer(p, x, rope, cfg, False)
    enc_out = x
    x = params["embed"][batch["tokens"].long()]
    rope = encdec._rope(x.shape[1], cfg, x.device)
    for p in common.layer_views(params["decoder"]):
        x = encdec._dec_layer_train(p, x, enc_out, rope, cfg)
    return tfm.unembed(params, tfm._final_norm(params, x, cfg), cfg)


# family -> (module whose forward_train the plain loop stands in for,
# the loop, the module attributes that are layer bodies)
PLAIN = {
    "dense": (tfm, _plain_transformer,
              ("_layer_train", "_attn_out", "_ffn_residual")),
    "encdec": (encdec, _plain_encdec, ("_enc_layer", "_dec_layer_train")),
    "xlstm": (xlstm, _plain_xlstm, ()),
    "hybrid": (hybrid, _plain_hybrid, ()),
}
PLAIN["moe"] = PLAIN["vlm"] = PLAIN["dense"]


def _loss_grads(family, policy, monkeypatch, plain=False):
    """The port's loss and gradients under ``policy`` (``plain``: the
    layer bodies run without recompute, by the loop above)."""
    arch, S, _ = FAMILIES[family]
    cfg = dataclasses.replace(get_config(arch), remat_policy=policy)
    mod, loop, _ = PLAIN[family]
    if plain:
        monkeypatch.setattr(mod, "forward_train", loop)
    params = _shared(arch, policy)[2]
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, S).items()}
    loss = build_model(cfg).loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    monkeypatch.undo()
    return loss.detach(), grads


@pytest.mark.parametrize("family", list(FAMILIES))
def test_recompute_bitwise_the_plain_loop(family, monkeypatch):
    want_l, want_g = _loss_grads(family, "full", monkeypatch, plain=True)
    for policy in POLICIES:
        loss, grads = _loss_grads(family, policy, monkeypatch)
        assert torch.equal(loss, want_l), (family, policy)
        for path, g, w in zip(tree_paths(_shared(FAMILIES[family][0],
                                                 policy)[2]), grads, want_g):
            assert (g is None) == (w is None), (family, policy, path)
            assert g is None or torch.equal(g, w), (family, policy, path)


def _reference_arch(family):
    arch = FAMILIES[family][0]
    return arch.replace("-smoke", "-tiny") if family == "encdec" else arch


@pytest.mark.parametrize("family", list(FAMILIES))
def test_recompute_matches_reference(family, monkeypatch):
    """The reference's value_and_grad under each policy the port runs (the
    policy changes only the transformer family's residuals in either
    package, so the others compare both against the default's)."""
    arch, S, (kind, tol) = FAMILIES[family]
    arch = _reference_arch(family)
    want = {}
    for policy in POLICIES:
        ref_policy = policy if family in TRANSFORMER else "full"
        jb, jp, pp = _shared(arch, ref_policy)
        cfg = dataclasses.replace(get_config(arch), remat_policy=policy)
        batch = _batch(cfg, S)
        if ref_policy not in want:
            want[ref_policy] = jax.jit(jax.value_and_grad(jb.loss_fn))(
                jp, jax.tree.map(jnp.asarray, batch))
        want_l, want_g = want[ref_policy]
        leaves = [t.clone().requires_grad_() for t in tree_leaves(pp)]
        loss = build_model(cfg).loss_fn(
            tree_unflatten(pp, leaves),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(loss.detach()), float(want_l),
                                   rtol=1e-5)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for path, a, g in zip(tree_paths(pp), jax.tree.leaves(want_g),
                              grads):
            a = np.asarray(a)
            g = np.zeros_like(a) if g is None else g.numpy()
            atol = tol * np.abs(a).max() if kind == "scale" else tol
            np.testing.assert_allclose(g, a, atol=atol, rtol=1e-4,
                                       err_msg=f"{family} {policy} {path}")


def _packs(family, policy, monkeypatch, plain=False):
    """(packs while a layer body runs, tensors packed outside the bodies,
    the ``attn_out`` tensors) of one forward under ``policy``."""
    arch, S, _ = FAMILIES[family]
    mod, loop, bodies = PLAIN[family]
    depth = [0]
    attn_outs = []

    def enter(fn, name):
        def body(*args):
            depth[0] += 1
            try:
                out = fn(*args)
            finally:
                depth[0] -= 1
            if name == "_attn_out" and depth[0] == 0:
                attn_outs.append(out)
            return out
        return body

    for name in bodies:
        monkeypatch.setattr(mod, name, enter(getattr(mod, name), name))
    if family == "xlstm":
        monkeypatch.setattr(xlstm, "_BLOCK", {
            k: enter(f, k) for k, f in xlstm._BLOCK.items()})
    if family == "hybrid":
        monkeypatch.setattr(hybrid.ssm, "mamba_block_train", enter(
            hybrid.ssm.mamba_block_train, "mamba"))
        monkeypatch.setattr(tfm, "_layer_train", enter(tfm._layer_train,
                                                       "shared"))
    if plain:
        monkeypatch.setattr(mod, "forward_train", loop)
    cfg = dataclasses.replace(get_config(arch), remat_policy=policy)
    params = _shared(arch, "full")[2]
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, S).items()}
    inside, outside = [0], []

    def pack(t):
        if depth[0]:
            inside[0] += 1
        else:
            outside.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        build_model(cfg).loss_fn(tree_unflatten(params, leaves), batch)
    monkeypatch.undo()
    return inside[0], outside, attn_outs


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


def _distinct(ts: list) -> list:
    out = []
    for t in ts:
        if not any(_same(t, u) for u in out):
            out.append(t)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_recompute_saves_only_layer_inputs(family, monkeypatch):
    n_plain, _, _ = _packs(family, "full", monkeypatch, plain=True)
    n_full, out_full, _ = _packs(family, "full", monkeypatch)
    n_sc, out_sc, attn = _packs(family, "save_collectives", monkeypatch)
    assert n_plain > 0
    assert n_full == 0 and n_sc == 0
    # a region's tensor arguments are packed once per region: count each
    # tensor once
    out_full, out_sc = _distinct(out_full), _distinct(out_sc)
    extra = len(out_sc) - len(out_full)
    if family not in TRANSFORMER:
        assert extra == 0 and not attn
        return
    layers = get_config(FAMILIES[family][0]).num_layers
    assert len(attn) == layers and extra == layers
    kept = [t for t in out_sc if any(_same(t, a) for a in attn)]
    assert len(kept) == layers
    assert not any(_same(t, a) for t in out_full for a in attn)


@pytest.mark.parametrize("policy", POLICIES)
def test_reference_residuals_keep_attn_out_only(policy, capsys):
    """What the port's save_collectives keeps beside the layer inputs is
    the reference's own residual set under that policy."""
    jb, jp, _ = _shared("stablelm-3b-smoke", policy)
    batch = _batch(jb.cfg, 16)
    print_saved_residuals(jb.loss_fn, jp, jax.tree.map(jnp.asarray, batch))
    text = capsys.readouterr().out
    # the named values are reduce_precision outputs at :140:12 and
    # :144:12; the add at :144:8 is a layer's output, the next one's input
    attn = text.count("transformer.py:140:12")
    ffn = text.count("transformer.py:144:12")
    assert ffn == 0
    assert attn == (jb.cfg.num_layers if policy == "save_collectives" else 0)
