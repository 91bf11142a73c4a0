"""The port's SSD core against the reference on the CPU: B11's plain version
(`repro_torch.kernels.ref.ssd_intra_chunk_ref`, which the wrapper
`repro_torch.kernels.ssd_intra_chunk` takes on CPU tensors) against the
reference's Pallas `ssd_intra_chunk` run as its own tests run it
(interpreted, `repro.kernels.runtime`) and against its
`ref.ssd_intra_chunk_ref`; the wrapper's autograd; `models.ssm`'s
`ssd_chunked`, `ssd_step`, `causal_conv` and `causal_conv_step` against
the reference's; and the reference's own SSD properties
(tests/test_ssm.py) on the port.  The test marked ``gpu`` holds the CUDA
kernel against the plain version on the card.

Tolerances (f32):
* plain B11 vs the interpreted Pallas kernel and the reference's plain
  version: atol 1e-5, the reference sweep's own (tests/test_kernels.py:77);
* the autograd Function's gradients vs autograd through the plain
  version: atol = rtol = 1e-6 (the same computation, recomputed);
* ``ssd_chunked`` vs the reference's: atol = rtol = 2e-5 (einsum and
  cumsum summation orders over chunks of 64; measured <= 4e-6 on entries
  up to ~30);
* ``ssd_step``, the convs: atol = rtol = 1e-6;
* the properties: the reference's tolerances (chunked == sequential atol
  5e-4 + rtol 1e-3; split-chunk carry atol 1e-4 + rtol 1e-3; conv step
  atol 1e-5);
* the card: f32 atol = rtol = 1e-4 (the kernel sums the N scores and the
  Q rows in another order, on tensor cores split 3xTF32 for Q >= 16);
  one launch a call; bf16 against an f32 computation on the same
  bf16 inputs, y within 2e-2 relative to its scale (the kernel rounds only
  y; the plain version also rounds the scores and the weights).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.ssm_scan import ssd_intra_chunk as jax_ssd_intra_chunk
from repro.models import ssm as jax_ssm
from repro_torch.kernels import launch_counts, ref, ssd_intra_chunk
from repro_torch.models import ssm

# the reference sweep (tests/test_kernels.py:67-68), the folded per-head
# form (H = 1, P = N), the normalizer (P = 1) and decode (Q = 1)
SHAPES = [(2, 64, 2, 8, 16), (4, 32, 3, 16, 8), (1, 128, 1, 4, 32),
          (8, 64, 1, 24, 24), (8, 52, 1, 1, 24), (6, 1, 1, 16, 16),
          (4, 1, 3, 8, 8)]
# both sides of the CUDA kernel's routes: Q < 16 on the f32 decode route,
# the chunk padded to 16, 32, 64 or 128 on the tensor-core one (on the card
# with P and N past a 64-wide tile; on the CPU at the reference sweep's
# widths, where its atol 1e-5 holds)
ROUTE_QS = (1, 2, 15, 16, 17, 63, 64, 65, 127, 128)
ROUTE_SHAPES = [(3, Q, 2, 72, 80) for Q in ROUTE_QS]
# the shapes the xLSTM paths give B11 (training, prefill, decode; memory
# and normalizer calls) and zamba2-7b's native form: 112 heads sharing B
# and C, P = N = 64, at a few chunks and at its training (batch 2 x 8
# chunks) and 2000-token prefill (32 chunks) calls
PATH_SHAPES = [(G, Q, 1, P, 384) for G, Q in ((16, 64), (32, 64), (32, 1))
               for P in (384, 1)] + [(G, 64, 112, 64, 64)
                                     for G in (4, 16, 32)]


def _inputs(G, Q, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, Q, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(G, Q, H))) * 0.5).astype(np.float32)
    A = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    acum = np.cumsum(dt * A, axis=1).astype(np.float32)
    Bm = rng.normal(size=(G, Q, N)).astype(np.float32)
    Cm = rng.normal(size=(G, Q, N)).astype(np.float32)
    return x, dt, acum, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("G,Q,H,P,N", SHAPES + [(2, Q, 2, 8, 16)
                                                for Q in ROUTE_QS])
def test_plain_b11_matches_reference_kernel_and_plain_version(G, Q, H, P, N):
    arrays = _inputs(G, Q, H, P, N)
    y_k, s_k = jax_ssd_intra_chunk(*map(jnp.asarray, arrays))
    y_r, s_r = jax_ref.ssd_intra_chunk_ref(*map(jnp.asarray, arrays))
    y, s = ssd_intra_chunk(*_t(*arrays))
    assert y.shape == (G, Q, H, P) and s.shape == (G, H, P, N)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    for want in (y_k, y_r):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=1e-5)
    for want in (s_k, s_r):
        np.testing.assert_allclose(s.numpy(), np.asarray(want), atol=1e-5)


def test_folded_per_head_equals_per_head_blocks():
    """Folding the heads into G (H = 1) gives each head's own block."""
    G, Q, H, P, N = 3, 16, 4, 8, 8
    x, dt, acum, _, _ = _inputs(G, Q, H, P, N)
    rng = np.random.default_rng(1)
    Bh = rng.normal(size=(G, Q, H, N)).astype(np.float32)
    Ch = rng.normal(size=(G, Q, H, N)).astype(np.float32)

    def fold(a):
        return np.ascontiguousarray(np.moveaxis(a, 2, 1)).reshape(
            G * H, Q, *a.shape[3:])

    y, s = ssd_intra_chunk(*_t(fold(x)[:, :, None], fold(dt)[..., None],
                               fold(acum)[..., None], fold(Bh), fold(Ch)))
    for h in range(H):
        yh, sh = ref.ssd_intra_chunk_ref(*_t(
            x[:, :, h:h + 1], dt[:, :, h:h + 1], acum[:, :, h:h + 1],
            Bh[:, :, h], Ch[:, :, h]))
        np.testing.assert_array_equal(
            y.reshape(G, H, Q, P)[:, h].numpy(), yh[:, :, 0].numpy())
        np.testing.assert_array_equal(s.reshape(G, H, P, N)[:, h].numpy(),
                                      sh[:, 0].numpy())


@pytest.mark.parametrize("steep", [False, True])
def test_autograd_function_matches_autograd_through_plain(steep):
    """The wrapper's backward (the plain version recomputed) gives autograd's
    gradients; with a steep decay the anti-causal exponents overflow f32
    and the gradients stay finite (the mask is inside the exp)."""
    G, Q, H, P, N = 3, 16, 2, 8, 8
    x, dt, acum, Bm, Cm = _inputs(G, Q, H, P, N, seed=2)
    if steep:
        acum = np.cumsum(np.full((G, Q, H), -20.0, np.float32), axis=1)
    rng = np.random.default_rng(3)
    gy = torch.from_numpy(rng.normal(size=(G, Q, H, P)).astype(np.float32))
    gs = torch.from_numpy(rng.normal(size=(G, H, P, N)).astype(np.float32))
    grads = []
    for fn in (ssd_intra_chunk, ref.ssd_intra_chunk_ref):
        ins = [t.requires_grad_() for t in _t(x, dt, acum, Bm, Cm)]
        y, s = fn(*ins)
        grads.append(torch.autograd.grad((y, s), ins, (gy, gs)))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def _ssd_inputs(B, S, H, P, N, per_head, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, H))) * 0.5).astype(np.float32)
    bc_shape = (B, S, H, N) if per_head else (B, S, N)
    Bm = rng.normal(size=bc_shape).astype(np.float32)
    Cm = rng.normal(size=bc_shape).astype(np.float32)
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32)
    A = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    log_decay = np.log(1.0 / (1.0 + np.exp(-rng.normal(size=(B, S, H)) - 1))
                       ).astype(np.float32)
    D = np.abs(rng.normal(size=(H,))).astype(np.float32)
    return x, dt, A, Bm, Cm, D, h0, log_decay


@pytest.mark.parametrize("S", [1, 64, 130])
@pytest.mark.parametrize("form", ["shared", "per_head", "normalizer"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(S, form, with_h0):
    """Mamba2's shared B/C with A and D; mLSTM's per-head k/q with a
    log-decay; its normalizer (x = ones, P = 1).  S = 130 pads to 192."""
    B, H, N = 2, 3, 8
    P = 1 if form == "normalizer" else 6
    x, dt, A, Bm, Cm, D, h0, log_decay = _ssd_inputs(
        B, S, H, P, N, form != "shared", seed=S)
    if form == "normalizer":
        x = np.ones_like(x)
    args = ((x, dt, A, Bm, Cm, D, h0, None) if form == "shared" else
            (x, dt, None, Bm, Cm, None, h0, log_decay))
    if not with_h0:
        args = args[:6] + (None,) + args[7:]
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    y_want, h_want = jax_ssm.ssd_chunked(*jargs[:7], log_decay=jargs[7])
    y, h = ssm.ssd_chunked(*targs[:7], log_decay=targs[7])
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=2e-5,
                               rtol=2e-5)


def test_ssd_step_and_convs_match_reference():
    rng = np.random.default_rng(7)
    B, H, P, N, C, K, S = 2, 3, 4, 5, 6, 4, 9
    x_t = rng.normal(size=(B, H, P)).astype(np.float32)
    dt_t = np.abs(rng.normal(size=(B, H))).astype(np.float32)
    A = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    B_t, C_t = (rng.normal(size=(B, N)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)
    h = rng.normal(size=(B, H, P, N)).astype(np.float32)
    args = (x_t, dt_t, A, B_t, C_t, D, h)
    for got, want in zip(ssm.ssd_step(*_t(*args)),
                         jax_ssm.ssd_step(*map(jnp.asarray, args))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    x = rng.normal(size=(B, S, C)).astype(np.float32)
    w = rng.normal(size=(K, C)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    tail = rng.normal(size=(B, K - 1, C)).astype(np.float32)
    np.testing.assert_allclose(
        ssm.causal_conv(*_t(x, w, b)).numpy(),
        np.asarray(jax_ssm.causal_conv(*map(jnp.asarray, (x, w, b)))),
        atol=1e-6, rtol=1e-6)
    got = ssm.causal_conv_step(*_t(x[:, 0], tail, w, b))
    want = jax_ssm.causal_conv_step(*map(jnp.asarray, (x[:, 0], tail, w, b)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-6,
                                   rtol=1e-6)


# -- the reference's properties (tests/test_ssm.py), on the port -----------

@pytest.mark.parametrize("seed,S,H", [(0, 64, 1), (11, 128, 3), (42, 256, 4)])
def test_port_ssd_chunked_matches_sequential(seed, S, H):
    rng = np.random.default_rng(seed)
    B, P, N = 2, 8, 16
    x = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    dt = torch.from_numpy(
        np.abs(rng.normal(size=(B, S, H))).astype(np.float32) * 0.5)
    A = -torch.from_numpy(np.abs(rng.normal(size=(H,))).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
    Cm = torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
    D = torch.from_numpy(np.abs(rng.normal(size=(H,))).astype(np.float32))
    y_c, h_c = ssm.ssd_chunked(x, dt, A, Bm, Cm, D)
    h = torch.zeros((B, H, P, N))
    ys = []
    for t in range(S):
        y_t, h = ssm.ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D, h)
        ys.append(y_t)
    np.testing.assert_allclose(y_c.numpy(), torch.stack(ys, 1).numpy(),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(h_c.numpy(), h.numpy(), atol=5e-4, rtol=1e-3)


def test_port_ssd_state_continuation():
    """[0:S/2] then [S/2:S] with the carried state equals one pass: the
    prefill/decode state handoff."""
    rng = np.random.default_rng(3)
    B, S, H, P, N = 1, 128, 2, 4, 8
    x = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    dt = torch.from_numpy(
        np.abs(rng.normal(size=(B, S, H))).astype(np.float32) * 0.3)
    A = -torch.from_numpy(np.abs(rng.normal(size=(H,))).astype(np.float32))
    Bm = torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
    Cm = torch.from_numpy(rng.normal(size=(B, S, N)).astype(np.float32))
    D = torch.zeros((H,))
    y_full, h_full = ssm.ssd_chunked(x, dt, A, Bm, Cm, D)
    half = S // 2
    y1, h1 = ssm.ssd_chunked(x[:, :half], dt[:, :half], A, Bm[:, :half],
                             Cm[:, :half], D)
    y2, h2 = ssm.ssd_chunked(x[:, half:], dt[:, half:], A, Bm[:, half:],
                             Cm[:, half:], D, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_port_causal_conv_step_matches_full():
    rng = np.random.default_rng(5)
    B, S, C, K = 2, 16, 6, 4
    x = torch.from_numpy(rng.normal(size=(B, S, C)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(K, C)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(C,)).astype(np.float32))
    full = ssm.causal_conv(x, w, b)
    tail = torch.zeros((B, K - 1, C))
    outs = []
    for t in range(S):
        o, tail = ssm.causal_conv_step(x[:, t], tail, w, b)
        outs.append(o)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("per_head", [False, True])
def test_ssd_chunked_hands_b11_contiguous_operands(per_head, monkeypatch):
    """The card's kernel takes contiguous operands with Q <= 128 only: the
    reshapes and folds of `ssd_chunked` give them at every batch and
    sequence length (a fold of one chunk may otherwise be a strided
    view)."""
    seen = []

    def spy(*args):
        seen.append([tuple(a.shape) for a in args])
        assert all(a.is_contiguous() for a in args), seen[-1]
        assert args[0].shape[1] <= 128
        return ref.ssd_intra_chunk_ref(*args)

    monkeypatch.setattr(ssm, "ssd_intra_chunk", spy)
    for B, S in ((1, 1), (1, 37), (2, 64), (1, 130), (3, 200)):
        x, dt, A, Bm, Cm, D, h0, log_decay = _ssd_inputs(B, S, 4, 5, 6,
                                                         per_head, seed=S)
        ssm.ssd_chunked(*_t(x, dt), None, *_t(Bm, Cm), None, None,
                        log_decay=torch.from_numpy(log_decay))
    assert len(seen) == 5


def test_wrapper_refuses_bad_shapes_and_dtypes():
    x, dt, acum, Bm, Cm = _t(*_inputs(2, 8, 1, 4, 4))
    with pytest.raises(ValueError):
        ssd_intra_chunk(x, dt[:, :4], acum, Bm, Cm)
    with pytest.raises(TypeError):
        ssd_intra_chunk(x, dt, acum, Bm.double(), Cm.double())
    with pytest.raises(TypeError):
        ssd_intra_chunk(x.bfloat16(), dt, acum, Bm, Cm)


# -- on the card -----------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels run only there")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Q,H,P,N", SHAPES + [(3, 64, 1, 384, 384),
                                                (2, 64, 112, 64, 64)]
                         + ROUTE_SHAPES + PATH_SHAPES)
def test_cuda_ssd_intra_chunk_vs_plain(G, Q, H, P, N, dtype):
    _need_cuda()
    dev = torch.device("cuda")
    x, dt, acum, Bm, Cm = (t.to(dev) for t in _t(*_inputs(G, Q, H, P, N)))
    x, Bm, Cm = x.to(dtype), Bm.to(dtype), Cm.to(dtype)
    before = launch_counts["ssd_intra_chunk"]
    y, s = ssd_intra_chunk(x, dt, acum, Bm, Cm)
    assert launch_counts["ssd_intra_chunk"] == before + 1
    y32, s32 = ref.ssd_intra_chunk_ref(x.float(), dt, acum, Bm.float(),
                                       Cm.float())
    if dtype == torch.float32:
        torch.testing.assert_close(y, y32, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(s, s32, atol=1e-4, rtol=1e-4)
    else:
        scale = float(y32.abs().max()) + 1.0
        assert float((y.float() - y32).abs().max()) <= 2e-2 * scale
        torch.testing.assert_close(s, s32, atol=1e-4, rtol=1e-4)
