"""Attention for serving in the port against the reference on the CPU:
B10's plain version (`repro_torch.kernels.ref.flash_attention_ref`)
against the reference's Pallas flash-attention kernel run as its own tests
run it (``interpret=True``) and against ``repro.models.common.attention``;
the decode helpers of `repro_torch.models.common` (rotary tables at
positions, `decode_attention`, `ring_buffer_write`, `decode_cache_valid`,
`decode_positions`) against the reference's.  On CPU tensors the B10
wrapper takes its plain version; the test marked ``gpu`` holds the CUDA
kernel against it on the card.

Tolerances:
* plain B10 vs the interpreted Pallas kernel (one tile of S where 64 does
  not divide S): the reference sweep's own (tests/test_kernels.py:31),
  atol = rtol = 2e-6 in f32, 2e-2 in bf16
  (the kernel keeps its scores in f32, the plain version rounds logits
  and probabilities to bf16);
* plain B10 vs ``models.common.attention`` in f32: atol = rtol = 2e-6 (the
  same softmax, masked with -inf instead of -1e30);
* decode helpers in f32: ``decode_attention`` atol = rtol = 1e-6 (einsum
  summation order); ``ring_buffer_write``, ``decode_cache_valid``,
  ``decode_positions`` exact; the rotary tables' cos/sin within 1 ulp
  (torch's and XLA's cos/sin differ by an ulp; the angle is bitwise).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.models import common as jax_common
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention, launch_counts, ref
from repro_torch.models import common

RNG = np.random.default_rng(0)

# the reference sweep's shapes (tests/test_kernels.py:21-26), then
# stablelm's hd = 80 at S on both sides of B10's 128-row tile edges, causal
# with and without a window
SWEEP = [(2, 128, 2, 64, True, None), (1, 256, 4, 32, True, 64),
         (2, 64, 1, 128, False, None), (1, 512, 2, 16, True, 256),
         *((1, S, 2, 80, True, w) for S in (127, 129, 257) for w in (None, 64))]
# B10's tile edges on the card: every hd it takes at S around 128 and 256
EDGE_SEQS = (127, 129, 257)


def _normal(shape, dtype=np.float32) -> np.ndarray:
    return RNG.normal(size=shape).astype(np.float32).astype(dtype)


def _allclose(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("B,S,H,hd,causal,window", SWEEP)
def test_flash_plain_vs_interpreted_pallas(B, S, H, hd, causal, window,
                                           dtype):
    q, k, v = (_normal((B, S, H, hd), dtype) for _ in range(3))
    # the reference kernel asserts S % bq == 0: one tile where 64 does not
    # divide S
    bq = 64 if S % 64 == 0 else S
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, bq=bq, bk=bq,
                     interpret=True)
    got = ref.flash_attention_ref(params_from_numpy(q), params_from_numpy(k),
                                  params_from_numpy(v), causal=causal,
                                  window=window)
    _allclose(got, want, 2e-6 if dtype == np.float32 else 2e-2)


@pytest.mark.parametrize("S,causal,window", [
    (130, True, None), (130, True, 17), (77, False, None), (1, True, None),
    (2, True, 1)])
def test_flash_plain_vs_reference_attention(S, causal, window):
    """Ragged S (no multiple of any tile) and windows: the serve path's
    prefill replaces ``attention`` by B10 on the card."""
    q, k, v = (_normal((2, S, 3, 16)) for _ in range(3))
    want = jax_common.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
    _allclose(got, want, 2e-6)
    # the port's naive attention agrees too
    port = common.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal, window=window)
    _allclose(port, want, 2e-6)


def test_flash_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    q, k, v = (torch.from_numpy(_normal((1, 9, 2, 8))) for _ in range(3))
    before = launch_counts["flash_attention"]
    got = flash_attention(q, k, v, causal=True, window=4)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=True,
                                                    window=4))
    assert launch_counts["flash_attention"] == before
    with pytest.raises(ValueError, match="equal"):
        flash_attention(q, k[:, :5], v)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    # neither the CPU nor a card: refused, never computed some other way
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        flash_attention(*meta)


@pytest.mark.parametrize("pos", [0, 5, 11, [3, 12, 7]])
def test_rope_tables_at_positions(pos):
    hd, frac, theta = 32, 0.25, 10000.0
    B = 3
    positions = np.broadcast_to(np.asarray(pos, np.int32).reshape(-1, 1),
                                (B, 1)).copy()
    x = _normal((B, 1, 2, hd))
    want = np.asarray(jax_common.apply_rope(jnp.asarray(x),
                                            jnp.asarray(positions), frac,
                                            theta))
    cos, sin = common.rope_tables_at(torch.from_numpy(positions), hd, frac,
                                     theta)
    got = common.apply_rope(torch.from_numpy(x), cos, sin).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, ulps.max()
    # decode's per-slot positions equal the prefill tables' rows
    cos_s, sin_s = common.rope_tables(13, hd, frac, theta, "cpu")
    p = torch.from_numpy(positions)[:, 0].long()
    assert torch.equal(cos[:, 0], cos_s[p]) and torch.equal(sin[:, 0],
                                                            sin_s[p])


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_attention_and_cache_helpers(per_slot):
    B, C, H, KV, hd = 3, 10, 4, 2, 16
    q = _normal((B, 1, H, hd))
    k_new, v_new = _normal((B, 1, KV, hd)), _normal((B, 1, KV, hd))
    kc, vc = _normal((B, C, KV, hd)), _normal((B, C, KV, hd))
    pos = np.asarray([4, 13, 9], np.int32) if per_slot else np.int32(6)
    valid_ref = np.asarray(jax_common.decode_cache_valid(jnp.asarray(pos),
                                                         C))
    valid = common.decode_cache_valid(torch.from_numpy(np.asarray(pos)), C)
    np.testing.assert_array_equal(valid.numpy(), valid_ref)
    np.testing.assert_array_equal(
        common.decode_positions(torch.from_numpy(np.asarray(pos)), B).numpy(),
        np.asarray(jax_common.decode_positions(jnp.asarray(pos), B)))
    want = jax_common.decode_attention(*(jnp.asarray(a) for a in
                                         (q, k_new, v_new, kc, vc)),
                                       jnp.asarray(valid_ref))
    got = common.decode_attention(*(torch.from_numpy(a) for a in
                                    (q, k_new, v_new, kc, vc)), valid)
    _allclose(got, want, 1e-6)
    # the ring write: in place, the reference's values exactly
    want_c = np.asarray(jax_common.ring_buffer_write(
        jnp.asarray(kc), jnp.asarray(k_new), jnp.asarray(pos)))
    cache = torch.from_numpy(kc.copy())
    out = common.ring_buffer_write(cache, torch.from_numpy(k_new),
                                   torch.from_numpy(np.asarray(pos)))
    assert out.data_ptr() == cache.data_ptr()
    np.testing.assert_array_equal(cache.numpy(), want_c)
    if not per_slot:
        cache2 = torch.from_numpy(kc.copy())
        common.ring_buffer_write(cache2, torch.from_numpy(k_new), int(pos))
        np.testing.assert_array_equal(cache2.numpy(), want_c)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only there")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,hd,causal,window", [
    (1, 16, True, None), (130, 80, True, None), (257, 32, True, 64),
    (200, 128, False, None), (300, 40, False, 100),
    *((S, hd, True, w) for S in EDGE_SEQS for hd in range(8, 129, 8)
      for w in (None, 64))])
def test_cuda_flash_attention_vs_plain(S, hd, causal, window, dtype):
    _need_cuda()
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(_normal((2, S, 3, hd))).to(dtype)
               for _ in range(3))
    before = launch_counts["flash_attention"]
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=causal,
                          window=window)
    assert launch_counts["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q.to(dev), k.to(dev), v.to(dev),
                                   causal=causal, window=window)
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_zamba2_prefill_shape(dtype):
    """zamba2-7b's shared attention at a 2000-token prefill: (1, 2000, 32,
    112) causal, f32 in the model (every site follows a mamba block) and
    bf16; atol = rtol 1e-5 in f32 (sums over 2000 keys in another order)
    and 2e-2 in bf16."""
    _need_cuda()
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(_normal((1, 2000, 32, 112))).to(dtype)
               .to(dev) for _ in range(3))
    before = launch_counts["flash_attention"]
    got = flash_attention(q, k, v, causal=True)
    assert launch_counts["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=True)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [130, 257])
def test_cuda_gqa_prefill_attention_vs_plain(S, dtype):
    """The prefill's `_attn` with fewer KV heads than query heads (k and v
    repeated to H heads for B10) against the plain grouped attention."""
    _need_cuda()
    from repro_torch.models.transformer import _attn
    dev = torch.device("cuda")
    q = torch.from_numpy(_normal((1, S, 8, 32))).to(dtype).to(dev)
    k, v = (torch.from_numpy(_normal((1, S, 2, 32))).to(dtype).to(dev)
            for _ in range(2))
    before = launch_counts["flash_attention"]
    got = _attn(q, k, v, None)
    assert launch_counts["flash_attention"] == before + 1
    want = common.attention(q, k, v, causal=True)
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
