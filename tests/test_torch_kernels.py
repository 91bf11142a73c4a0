"""The port's kernels (`repro_torch.kernels`) against the reference's Pallas
kernels, run as the reference's own tests run them on the CPU
(``interpret=True``).  On CPU tensors the wrappers take their plain PyTorch
versions, so these hold the plain versions' arithmetic; the tests marked
``gpu`` hold the CUDA kernels against the plain versions on the card.

Tolerances:
* obfuscate (B1/B3) with the step's scalars (w_self=0, b_self=-1): bitwise
  against the interpreted Pallas kernel, f32 and bf16.  With general
  (w_self, b_self) in f32 the reference's CPU compiler fuses
  w·x − b·(λg) into multiply-adds, so there the plain version is held
  bitwise against the reference's unfused ``ref.obfuscate_ref`` instead
  (in bf16 the final rounding hides the difference and it is bitwise
  against the kernel too).
* gossip (B2): rtol 1e-6 / atol 1e-6 in f32 — the sums run in another
  order.
* on the card (tests marked ``gpu``): B4 and B5 to B2's tolerance (f32
  rtol/atol 1e-5), B4's on-chip W_k and B5's mask bitwise; B6's
  non-finite positions exact and its finite entries within 1e-5 (1 + S),
  S the summed magnitude of the terms (clipped links can cancel); the
  ring kernels B7, B8, B9 bitwise against their plain versions on the
  card (nan positions exact), B9's bits bitwise `prng.leaf_bits`.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.pdsgd import _per_agent_bits
from repro.kernels import fused_pdsgd_tree as jax_fused
from repro.kernels import gossip_update as jax_gossip
from repro.kernels import obfuscate_update as jax_obfuscate
from repro.kernels import ref as jax_ref
from repro.models import build_model as jax_build
from repro_torch.core import prng
from repro_torch.core.pdsgd import lambda_key_table, pdsgd_update
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import (FlatLayout, fused_pdsgd_flat,
                                 fused_pdsgd_tree, gossip_update,
                                 guarded_gossip_update, launch_counts,
                                 masked_gossip_update,
                                 masked_gossip_update_krng, obfuscate_update,
                                 obfuscate_update_krng, ref,
                                 reset_launch_counts)

RNG = np.random.default_rng(0)
SCALARS_STEP = [(0.07, 0.0, -1.0), (0.0031, 0.0, -1.0), (1.5, 0.0, -1.0)]


def _bits(shape) -> np.ndarray:
    return RNG.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _torch(a: np.ndarray) -> torch.Tensor:
    return params_from_numpy(a)


def _same_bits(a: np.ndarray, b: torch.Tensor):
    if b.dtype == torch.bfloat16:
        np.testing.assert_array_equal(a.view(np.int16),
                                      b.view(torch.int16).numpy())
    else:
        np.testing.assert_array_equal(a.view(np.int32),
                                      b.view(torch.int32).numpy())


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("lam_bar,w_self,b_self", SCALARS_STEP)
def test_obfuscate_plain_bitwise_vs_pallas(dtype, lam_bar, w_self, b_self):
    R, C = 4, 1536
    x = RNG.normal(size=(R, C)).astype(dtype)
    g = RNG.normal(size=(R, C)).astype(dtype)
    bits = _bits((R, C))
    want = np.asarray(jax_obfuscate(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(bits),
        jnp.float32(lam_bar), jnp.float32(w_self), jnp.float32(b_self),
        block=(R, 256), interpret=True))
    got = obfuscate_update(_torch(x), _torch(g), _torch(bits), lam_bar,
                           w_self, b_self)
    _same_bits(want, got)


def test_obfuscate_general_scalars():
    R, C = 4, 1024
    bits = _bits((R, C))
    x = RNG.normal(size=(R, C)).astype(np.float32)
    g = RNG.normal(size=(R, C)).astype(np.float32)
    s = (jnp.float32(0.13), jnp.float32(0.6), jnp.float32(0.3))
    want = np.asarray(jax_ref.obfuscate_ref(jnp.asarray(x), jnp.asarray(g),
                                            jnp.asarray(bits), *s))
    got = obfuscate_update(_torch(x), _torch(g), _torch(bits), 0.13, 0.6, 0.3)
    _same_bits(want, got)
    xb, gb = x.astype(ml_dtypes.bfloat16), g.astype(ml_dtypes.bfloat16)
    want = np.asarray(jax_obfuscate(jnp.asarray(xb), jnp.asarray(gb),
                                    jnp.asarray(bits), *s, block=(R, 256),
                                    interpret=True))
    _same_bits(want, obfuscate_update(_torch(xb), _torch(gb), _torch(bits),
                                      0.13, 0.6, 0.3))


# (leaf sizes, columns): B9 on the card finds a tile's leaf once for 32
# VEC columns (128, 64 or 32 as m <= 4, 8, 32); these stress that lookup
LEAF_LAYOUTS = {
    "ragged": ([5, 1, 300, 77, 1024, 3], 1536),
    # leaf boundaries inside tiles
    "boundary_in_tile": ([200, 3000, 56, 700], 3960),
    # a leaf of many tiles
    "long_leaf": ([128 * 40 + 40, 8], 5176),
    # one-column leaves, then a short one
    "one_column": ([1] * 40 + [100], 144),
    # padding past the last leaf, its start inside a tile
    "padding": ([1000], 1536),
    # columns no multiple of any tile
    "ragged_n": ([600, 560], 1160),
}


def _leaf_layout(m, name="ragged"):
    """Keys and offsets for one of LEAF_LAYOUTS."""
    sizes, cols = LEAF_LAYOUTS[name]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    keys = torch.stack([prng.split(prng.fold_in(prng.key(3), a), len(sizes))
                        for a in range(m)])
    return sizes, torch.from_numpy(offsets.astype(np.int64)), cols, keys


def _jax_leaf_bits(keys, sizes, offsets, m, cols):
    """Per-(row, leaf) jax.random.bits laid side by side, padding 0."""
    want = np.zeros((m, cols), np.uint32)
    for a in range(m):
        for l, n in enumerate(sizes):
            jk = jax.random.wrap_key_data(
                jnp.asarray(keys[a, l].numpy().astype(np.uint32)))
            o = int(offsets[l])
            want[a, o:o + n] = np.asarray(jax.random.bits(jk, (n,),
                                                          jnp.uint32))
    return want


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_obfuscate_krng_plain_bitwise(dtype):
    """B3's bits are jax.random.bits of each (row, leaf) key over the leaf;
    v equals the Pallas B1 kernel fed those bits."""
    m = 4
    sizes, offsets, cols, keys = _leaf_layout(m)
    want_bits = _jax_leaf_bits(keys, sizes, offsets, m, cols)
    x = RNG.normal(size=(m, cols)).astype(dtype)
    g = RNG.normal(size=(m, cols)).astype(dtype)
    v, bits = obfuscate_update_krng(_torch(x), _torch(g), keys, offsets,
                                    0.05, 0.0, -1.0, return_bits=True)
    np.testing.assert_array_equal(bits.to(torch.int64).numpy(),
                                  want_bits.astype(np.int64))
    want_v = np.asarray(jax_obfuscate(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(want_bits),
        jnp.float32(0.05), jnp.float32(0.0), jnp.float32(-1.0),
        block=(m, 256), interpret=True))
    _same_bits(want_v, v)


@pytest.mark.parametrize("m,n", [(4, 512), (5, 1024), (32, 2048)])
def test_gossip_plain_vs_pallas(m, n):
    W = RNG.dirichlet(np.ones(m), m).T.astype(np.float32)
    B = RNG.dirichlet(np.ones(m), m).T.astype(np.float32)
    X = RNG.normal(size=(m, n)).astype(np.float32)
    U = RNG.normal(size=(m, n)).astype(np.float32)
    want = np.asarray(jax_gossip(*map(jnp.asarray, (W, B, X, U)),
                                 interpret=True))
    got = gossip_update(*map(_torch, (W, B, X, U))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _tiny_trees(m):
    bundle = jax_build(jax_config("stablelm-3b-tiny"))
    p = bundle.init(jax.random.key(0))
    x = jax.tree.map(
        lambda a: a[None] + 0.1 * jax.random.normal(
            jax.random.key(1), (m,) + a.shape), p)
    g = jax.tree.map(
        lambda a: jax.random.normal(jax.random.key(2), (m,) + a.shape), p)
    return x, g


def test_fused_pdsgd_tree_vs_reference_on_tiny_tree():
    """u bitwise and x' to the gossip tolerance, with the port drawing
    Lambda from the key table (B3) and the reference reading the
    `_per_agent_bits` it derives from the same key."""
    m = 4
    x, g = _tiny_trees(m)
    from repro_torch.core.topology import make_topology
    top = make_topology("ring", m)
    W = np.asarray(top.weights, np.float32)
    B = RNG.dirichlet(np.ones(m), m).T.astype(np.float32) * (
        top.adjacency > 0)
    B = (B / B.sum(0, keepdims=True)).astype(np.float32)
    step, lam = 6, 0.03
    jkey = jax.random.fold_in(jax.random.key(8), step)
    bits = _per_agent_bits(jax.random.fold_in(jkey, 1), jnp.asarray(step), g)
    want_tree, want = jax_fused(jnp.asarray(W), jnp.asarray(B), x, g, bits,
                                jnp.float32(lam), interpret=True,
                                observe=True, kernel_rng=False)
    tx = params_from_numpy(jax.tree.map(np.asarray, x))
    tg = params_from_numpy(jax.tree.map(np.asarray, g))
    layout = FlatLayout.of(jax.tree.map(lambda a: a[0], tx))
    keys = lambda_key_table(prng.fold_in(prng.key(8), step), step, m,
                            layout.n_leaves)
    got_tree, got = fused_pdsgd_tree(_torch(W), _torch(B), tx, tg, lam,
                                     keys=keys)
    _same_bits(np.asarray(want["u"]), got["u"])
    np.testing.assert_array_equal(np.asarray(want["x"]), got["x"].numpy())
    for a, b in zip(jax.tree.leaves(want_tree), jax.tree.leaves(got_tree)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def test_flat_layout_matches_reference_concat_and_pad():
    x, _ = _tiny_trees(2)
    leaves = jax.tree.leaves(x)
    ref_flat = np.concatenate([np.asarray(l).reshape(2, -1) for l in leaves],
                              axis=1)
    tx = params_from_numpy(jax.tree.map(np.asarray, x))
    layout = FlatLayout.of(jax.tree.map(lambda a: a[0], tx))
    buf = layout.flatten(tx, 2)
    assert buf.shape[1] % 512 == 0 and buf.shape[1] - ref_flat.shape[1] < 512
    np.testing.assert_array_equal(buf[:, :ref_flat.shape[1]].numpy(),
                                  ref_flat)
    assert (buf[:, ref_flat.shape[1]:] == 0).all()
    for a, b in zip(layout.leaf_views(buf), jax.tree.leaves(tx)):
        assert a.data_ptr() >= buf.data_ptr()  # views, not copies
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fused_update_matches_in_port_eager_formula():
    """The step's fused branch (key table -> obfuscate -> gossip) realizes
    the reference's unfused per-leaf formula: same Lambda, same B."""
    m = 4
    x, g = _tiny_trees(m)
    tx = params_from_numpy(jax.tree.map(np.asarray, x))
    tg = params_from_numpy(jax.tree.map(np.asarray, g))
    layout = FlatLayout.of(jax.tree.map(lambda a: a[0], tx))
    X, G = layout.flatten(tx, m), layout.flatten(tg, m)
    from repro_torch.core.topology import make_topology
    top = make_topology("ring", m)
    kw = dict(key=prng.fold_in(prng.key(2), 9), step=9,
              W=torch.tensor(top.weights, dtype=torch.float32),
              support=torch.tensor(top.adjacency, dtype=torch.float32),
              lam_bar=torch.tensor(0.02))
    eager = pdsgd_update(X, G, layout, eager=True, **kw)
    bits_path = pdsgd_update(X, G, layout, kernel_rng=False, **kw)
    fused = pdsgd_update(X.clone(), G.clone(), layout, in_place=True, **kw)
    np.testing.assert_array_equal(fused.numpy(), bits_path.numpy())
    np.testing.assert_allclose(fused.numpy(), eager.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_wrappers_take_plain_version_only_on_cpu():
    """CPU tensors go to the plain version and count no launch; a tensor on
    any other non-CUDA device is refused, never computed."""
    reset_launch_counts()
    x = torch.zeros(2, 512)
    bits = torch.zeros(2, 512, dtype=torch.uint32)
    mask = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
    obfuscate_update(x, x, bits, 0.1, 0.0, -1.0)
    gossip_update(torch.eye(2), torch.eye(2), x, x)
    masked_gossip_update(mask, torch.eye(2), x, x)
    masked_gossip_update_krng(prng.key(1), 0.5, mask, torch.eye(2), x, x)
    guarded_gossip_update(mask, torch.eye(2), x, x, clip=1e3,
                          corrupt=torch.tensor([1.0, 0.0]))
    guarded_gossip_update(mask, torch.eye(2), x, x, x, x, None)
    assert sum(launch_counts.values()) == 0
    meta = torch.empty(2, 512, device="meta")
    meta_mm = torch.eye(2, device="meta")
    with pytest.raises(ValueError):
        obfuscate_update(meta, meta, torch.empty(2, 512, dtype=torch.uint32,
                                                 device="meta"),
                         0.1, 0.0, -1.0)
    with pytest.raises(ValueError):
        gossip_update(meta_mm, meta_mm, meta, meta)
    with pytest.raises(ValueError):
        masked_gossip_update(meta_mm, meta_mm, meta, meta)
    with pytest.raises(ValueError):
        masked_gossip_update_krng(prng.key(1), 0.5, meta_mm, meta_mm, meta,
                                  meta)
    with pytest.raises(ValueError):
        guarded_gossip_update(meta_mm, meta_mm, meta, meta, clip=1e3,
                              corrupt=torch.zeros(2))
    with pytest.raises(ValueError):
        obfuscate_update(x, x[:, :256], bits, 0.1, 0.0, -1.0)
    with pytest.raises(ValueError):
        guarded_gossip_update(mask, torch.eye(2), x, x, x, None, 1e3)
    with pytest.raises(ValueError):
        guarded_gossip_update(mask, torch.eye(2), x, x, clip=1e3,
                              mode="zero")


def test_fused_flat_routes_the_coupling_and_keeps_the_refusals():
    """`fused_pdsgd_flat` picks the gossip kernel as the reference's
    ``fused_pdsgd_tree`` does: mask -> B4, mask_key -> B5 (the same mask
    drawn in-kernel), corrupt -> B6; the reference's refusals stand."""
    from repro_torch.core.mixing import make_mixing
    from repro_torch.core.topology import make_topology
    m, n = 5, 1024
    proc = make_mixing(make_topology("ring", m), rate=0.4, seed=2)
    X = torch.from_numpy(RNG.normal(size=(m, n)).astype(np.float32))
    G = torch.from_numpy(RNG.normal(size=(m, n)).astype(np.float32))
    B = torch.from_numpy(RNG.dirichlet(np.ones(m), m).T.astype(np.float32))
    bits = torch.from_numpy(_bits((m, n)).astype(np.int64)).to(torch.uint32)
    W, _, mask = proc.realize(3)
    U = obfuscate_update(X, G, bits, 0.05, 0.0, -1.0)
    masked, _ = fused_pdsgd_flat(W, B, X, G, 0.05, bits=bits, mask=mask)
    assert torch.equal(masked, ref.masked_gossip_ref(mask, B, X, U))
    drawn, _ = fused_pdsgd_flat(W, B, X, G, 0.05, bits=bits,
                                mask_key=proc.mask_key(3),
                                mask_keep_prob=proc.keep_prob,
                                mask_adj=proc.mask_adj())
    assert torch.equal(drawn, masked)
    corrupt = torch.tensor([0.0, 1.0, 0.0, 0.0, 0.0])
    guarded, _ = fused_pdsgd_flat(W, B, X, G, 0.05, bits=bits, mask=mask,
                                  corrupt=corrupt, corrupt_mode="scale",
                                  corrupt_scale=20.0, guard_clip=None)
    want = ref.guarded_gossip_ref(
        mask, B, X, U, ref.poison_transmit(X, corrupt, "scale", 20.0),
        ref.poison_transmit(U, corrupt, "scale", 20.0), None)
    assert torch.equal(guarded, want)
    with pytest.raises(ValueError, match="mask_keep_prob"):
        fused_pdsgd_flat(W, B, X, G, 0.05, bits=bits,
                         mask_key=proc.mask_key(3))
    with pytest.raises(ValueError, match="does not compose"):
        fused_pdsgd_flat(W, B, X, G, 0.05, bits=bits,
                         mask_key=proc.mask_key(3), mask_keep_prob=0.6,
                         mask=mask, corrupt=corrupt)
    with pytest.raises(ValueError, match="realized edge mask"):
        fused_pdsgd_flat(W, B, X, G, 0.05, bits=bits, corrupt=corrupt)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only there")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_obfuscate_kernels_bitwise_vs_plain(dtype):
    _need_cuda()
    dev = torch.device("cuda")
    m = 4
    sizes, offsets, cols, keys = _leaf_layout(m)
    x = torch.randn(m, cols, dtype=torch.float32).to(dtype)
    g = torch.randn(m, cols, dtype=torch.float32).to(dtype)
    v, bits = obfuscate_update_krng(x.to(dev), g.to(dev), keys, offsets,
                                    0.05, 0.3, -0.7, return_bits=True)
    pv, pbits = ref.obfuscate_krng_ref(x, g, keys, offsets, 0.05, 0.3, -0.7)
    assert torch.equal(bits.cpu(), pbits)
    assert torch.equal(v.cpu().view(torch.uint8), pv.view(torch.uint8))
    v1 = obfuscate_update(x.to(dev), g.to(dev), pbits.to(dev), 0.05, 0.3,
                          -0.7)
    assert torch.equal(v1.cpu().view(torch.uint8), pv.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 5, 32])
def test_cuda_gossip_kernel_vs_plain(m):
    _need_cuda()
    dev = torch.device("cuda")
    n = 4096
    W = torch.rand(m, m)
    B = torch.rand(m, m)
    X, U = torch.randn(m, n), torch.randn(m, n)
    got = gossip_update(W.to(dev), B.to(dev), X.to(dev), U.to(dev)).cpu()
    torch.testing.assert_close(got, ref.gossip_ref(W, B, X, U), rtol=1e-5,
                               atol=1e-5)


def _rand_mask(m, gen):
    keep = torch.triu((torch.rand(m, m, generator=gen) < 0.6).float(),
                      diagonal=1)
    mask = keep + keep.T
    mask[0, :] = mask[:, 0] = 0.0  # a down agent's row
    return mask


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 5, 32])
def test_cuda_masked_gossip_kernels_vs_plain(m):
    """B4 to B2's tolerance with W_k bitwise; B5's mask bitwise the
    process's realized mask and its output bitwise B4's on it."""
    _need_cuda()
    from repro_torch.core.mixing import make_mixing
    from repro_torch.core.topology import make_topology
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(m)
    mask = _rand_mask(m, gen)
    B = torch.rand(m, m, generator=gen) * (mask + torch.eye(m))
    B = B / B.sum(0)
    X, U = torch.randn(m, 4096, generator=gen), torch.randn(m, 4096,
                                                            generator=gen)
    got = masked_gossip_update(mask.to(dev), B.to(dev), X.to(dev),
                               U.to(dev)).cpu()
    torch.testing.assert_close(got, ref.masked_gossip_ref(mask, B, X, U),
                               rtol=1e-5, atol=1e-5)
    eye_x = torch.zeros(m, 64)
    eye_x[:, :m] = torch.eye(m)
    w = masked_gossip_update(mask.to(dev), B.to(dev), eye_x.to(dev),
                             torch.zeros(m, 64, device=dev)).cpu()
    assert torch.equal(w[:, :m].contiguous().view(torch.int32),
                       ref.metropolis_ref(mask).view(torch.int32))
    for proc in (make_mixing(make_topology("ring", m), rate=0.3, seed=1),
                 make_mixing(make_topology("ring", m), resample_every=2,
                             seed=2)):
        for step in range(4):
            out, drawn = masked_gossip_update_krng(
                proc.mask_key(step), proc.keep_prob,
                proc.mask_adj().to(dev), B.to(dev), X.to(dev), U.to(dev))
            assert torch.equal(drawn.cpu(), proc.realize_mask(step))
            assert torch.equal(out, masked_gossip_update(
                drawn, B.to(dev), X.to(dev), U.to(dev)))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 5, 32])
@pytest.mark.parametrize("mode", ["nan", "inf", "scale"])
@pytest.mark.parametrize("clip", [1e3, None])
def test_cuda_guarded_gossip_kernel_vs_plain(m, mode, clip):
    _need_cuda()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7 * m)
    mask = _rand_mask(m, gen)
    B = torch.rand(m, m, generator=gen) * (mask + torch.eye(m))
    B = B / B.sum(0)
    X, U = torch.randn(m, 2048, generator=gen), torch.randn(m, 2048,
                                                            generator=gen)
    corrupt = torch.zeros(m)
    corrupt[1] = corrupt[m - 1] = 1.0
    XT = ref.poison_transmit(X, corrupt, mode, 1e4)
    UT = ref.poison_transmit(U, corrupt, mode, 1e4)
    want = ref.guarded_gossip_ref(mask, B, X, U, XT, UT, clip)
    got = guarded_gossip_update(mask.to(dev), B.to(dev), X.to(dev),
                                U.to(dev), clip=clip, corrupt=corrupt.to(dev),
                                mode=mode, scale=1e4).cpu()
    staged = guarded_gossip_update(mask.to(dev), B.to(dev), X.to(dev),
                                   U.to(dev), XT.to(dev), UT.to(dev),
                                   clip).cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got.nan_to_num(0.0), staged.nan_to_num(0.0))
    w = ref.metropolis_ref(mask)
    eye = torch.eye(m)
    v = ((w * (1 - eye))[:, :, None] * XT[None]
         - (B * (1 - eye))[:, :, None] * UT[None])
    if clip is not None:
        v = v.clamp(-clip, clip)
    scale = ((torch.diagonal(w)[:, None] * X).abs()
             + (torch.diagonal(B)[:, None] * U).abs()
             + v.abs().nan_to_num(0.0, 0.0, 0.0).sum(1))
    fin = torch.isfinite(want)
    assert bool(((got - want).abs() <= 1e-5 * (1 + scale))[fin].all())


def _same_values(a, b):
    """Bitwise equal, nan exactly where the other has nan (payloads
    aside)."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0).view(torch.uint8),
                            b.nan_to_num(0.0).view(torch.uint8)))


@pytest.mark.parametrize("layout", sorted(LEAF_LAYOUTS))
def test_ring_krng_plain_bits_over_leaf_layouts(layout):
    """B9's plain version over the leaf layouts that stress the CUDA
    kernel's per-tile leaf lookup: its bits are jax.random.bits of each
    (row, leaf) key over the leaf and 0 past the last leaf, its output B8's
    plain version on those bits, bit for bit, also written over X."""
    from repro_torch.dist import collectives as C
    from repro_torch.kernels import (ring_obfuscate_gossip,
                                     ring_obfuscate_gossip_krng)
    m = 4
    sizes, offsets, cols, keys = _leaf_layout(m, layout)
    want_bits = _jax_leaf_bits(keys, sizes, offsets, m, cols)
    gen = torch.Generator().manual_seed(cols)
    perms = C.perm_stack(m, 1)
    w = torch.rand(m, 1 + perms.shape[0], generator=gen)
    b = torch.rand(m, 1 + perms.shape[0], generator=gen)
    X = torch.randn(m, cols, generator=gen).bfloat16()
    G = torch.randn(m, cols, generator=gen).bfloat16()
    o9, bits = ring_obfuscate_gossip_krng(w, b, perms, X, G, keys, offsets,
                                          0.05, export_bits=True)
    np.testing.assert_array_equal(bits.to(torch.int64).numpy(),
                                  want_bits.astype(np.int64))
    o8 = ring_obfuscate_gossip(w, b, perms, X, G, bits, 0.05)
    assert torch.equal(o9.view(torch.int16), o8.view(torch.int16))
    Xi = X.clone()
    ring_obfuscate_gossip_krng(w, b, perms, Xi, G, keys, offsets, 0.05,
                               out=Xi)
    assert torch.equal(Xi.view(torch.int16), o8.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(LEAF_LAYOUTS))
@pytest.mark.parametrize("m", [2, 4, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ring_kernels_bitwise_vs_plain(m, dtype, layout):
    """B7, B8 and B9 against their plain versions on the card, over leaf
    layouts that stress B9's per-tile leaf lookup: outputs, captured v and
    u bitwise, capture not changing the output, a nan planted in one
    sender's g at the plain version's positions, B9 equal to B8 on its
    exported bits, and B9 written over X."""
    _need_cuda()
    from repro_torch.dist import collectives as C
    from repro_torch.kernels import (ring_gossip_update, ring_obfuscate_gossip,
                                     ring_obfuscate_gossip_krng)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(m)
    perms = C.perm_stack(m, 1)
    nd = perms.shape[0]
    w = torch.rand(m, 1 + nd, generator=gen).to(dev)
    b = torch.rand(m, 1 + nd, generator=gen).to(dev)
    _, offsets, cols, keys = _leaf_layout(m, layout)
    nan_col = 300 if cols > 300 else cols // 2
    X = torch.randn(m, cols, generator=gen).to(dtype).to(dev)
    U = torch.randn(m, cols, generator=gen).to(dtype).to(dev)
    G = torch.randn(m, cols, generator=gen).to(dtype)
    G[m - 1, nan_col] = float("nan")
    G = G.to(dev)
    out, v = ring_gossip_update(w, b, perms, X, U, capture=True)
    po, pv = ref.ring_gossip_ref(w, b, perms.to(dev), X, U)
    assert torch.equal(out.view(torch.uint8), po.view(torch.uint8))
    assert torch.equal(v.view(torch.uint8), pv.view(torch.uint8))
    assert torch.equal(ring_gossip_update(w, b, perms, X, U), out)
    bits = prng.leaf_bits(keys.to(dev), offsets, m, cols)
    o8, v8, u8 = ring_obfuscate_gossip(w, b, perms, X, G, bits, 0.05,
                                       capture=True)
    p8 = ref.ring_obfuscate_gossip_ref(w, b, perms.to(dev), X, G, bits, 0.05)
    assert bool(torch.isnan(o8[:, nan_col]).all())
    for a, c in zip((o8, v8, u8), p8):
        assert _same_values(a, c)
    assert _same_values(ring_obfuscate_gossip(w, b, perms, X, G, bits, 0.05),
                        o8)
    o9, v9, u9, b9 = ring_obfuscate_gossip_krng(
        w, b, perms, X, G, keys, offsets, 0.05, capture=True,
        export_bits=True)
    assert torch.equal(b9, bits)
    for a, c in zip((o9, v9, u9), (o8, v8, u8)):
        assert _same_values(a, c)
    Xi = X.clone()
    ring_obfuscate_gossip_krng(w, b, perms, Xi, G, keys, offsets, 0.05,
                               out=Xi)
    assert _same_values(Xi, o8)
