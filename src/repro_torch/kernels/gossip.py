"""Gossip kernels (counterparts of ``repro.kernels.gossip``), hand-written in
CUDA in ``csrc/gossip.cu``; each accumulates in f32 and writes its output
in X's dtype:

* `gossip_update` (B2): x' = W X - B U;
* `masked_gossip_update` (B4): W_k = Metropolis(mask) computed on chip,
  then W_k X - B U;
* `masked_gossip_update_krng` (B5): B4 with the edge mask drawn in the
  kernel from a threefry key, the mask exported;
* `guarded_gossip_update` (B6): B4 with every off-diagonal link passed
  through a finite guard, the transmits of corrupt senders poisoned;

and, in ``csrc/ring.cu``, the ring layout's update from per-direction
tables (the reference's ``gossip.py:337-616``):

* `ring_gossip_update` (B7): self term, then each direction's message
  v_d = w_d x - b_d u shifted to its receivers, in direction order;
* `ring_obfuscate_gossip` (B8): B7 with u = Lambda ∘ g formed in the kernel
  from bits in memory;
* `ring_obfuscate_gossip_krng` (B9): B8 with the bits drawn in the kernel.

A tensor on the CPU goes to the plain version in `ref`; a CUDA tensor
launches the kernel (and counts the launch) or raises.  ``out`` may be
``X`` itself: the step writes x' over the parameters in place.
"""
from __future__ import annotations

import torch

from . import ref
from .build import (check_status, dtype_code, launch_counts, library,
                    stream_ptr, to_device)

__all__ = ["gossip_update", "masked_gossip_update",
           "masked_gossip_update_krng", "guarded_gossip_update",
           "ring_gossip_update", "ring_obfuscate_gossip",
           "ring_obfuscate_gossip_krng", "MAX_AGENTS", "MAX_DIRECTIONS"]

MAX_AGENTS = 32
MAX_DIRECTIONS = 4


def _check(name: str, X: torch.Tensor, U: torch.Tensor, out,
           mats: dict) -> bool:
    """Validate the shared arguments; True when every tensor lies on the
    CPU (the plain version's case), False for one CUDA device."""
    if X.dim() != 2 or U.shape != X.shape or U.dtype != X.dtype:
        raise ValueError(f"X and U must be equal (m, n) matrices of one "
                         f"dtype, got {tuple(X.shape)} {X.dtype} and "
                         f"{tuple(U.shape)} {U.dtype}")
    m = X.shape[0]
    for label, t in mats.items():
        if t.shape != (m, m):
            raise ValueError(f"{label} must be ({m}, {m}), got "
                             f"{tuple(t.shape)}")
    if not 1 <= m <= MAX_AGENTS:
        raise ValueError(f"{name} takes 1..{MAX_AGENTS} agents, got {m}")
    if out is not None and (out.shape != X.shape or out.dtype != X.dtype
                            or out.device != X.device):
        raise ValueError("out must match X in shape, dtype and device")
    devices = {t.device for t in (X, U, *mats.values())}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or X.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors on one "
                         f"device, got {sorted(map(str, devices))}")
    if any(t.dtype != torch.float32 for t in mats.values()):
        raise TypeError(f"{name}: {', '.join(mats)} must be float32")
    return False


def _columns(name: str, *bufs: torch.Tensor) -> None:
    """The kernels' layout: contiguous rows, n a multiple of 8, rows
    aligned to 8 elements."""
    n = bufs[0].shape[1]
    vec_bytes = 8 * bufs[0].element_size()
    if n % 8 or not all(t.is_contiguous() and t.data_ptr() % vec_bytes == 0
                        for t in bufs):
        raise ValueError(f"{name} needs contiguous buffers with n a "
                         f"multiple of 8 and rows aligned to 8 elements")


def _plain_out(v: torch.Tensor, out):
    return v if out is None else out.copy_(v)


def gossip_update(W: torch.Tensor, B: torch.Tensor, X: torch.Tensor,
                  U: torch.Tensor,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """W, B: (m, m) float32; X, U: (m, n) float32/bfloat16, m <= 32."""
    if _check("gossip_update", X, U, out, {"W": W, "B": B}):
        return _plain_out(ref.gossip_ref(W, B, X, U), out)
    if out is None:
        out = torch.empty_like(X)
    _columns("gossip_update", X, U, out)
    W, B = W.contiguous(), B.contiguous()
    status = library("gossip").gossip_update(
        dtype_code(X.dtype), W.data_ptr(), B.data_ptr(), X.data_ptr(),
        U.data_ptr(), out.data_ptr(), X.shape[0], X.shape[1],
        stream_ptr(X.device))
    check_status("gossip_update", status)
    launch_counts["gossip_update"] += 1
    return out


def masked_gossip_update(mask: torch.Tensor, B: torch.Tensor,
                         X: torch.Tensor, U: torch.Tensor,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """x' = metropolis(mask) X - B U.  ``mask``: (m, m) float32 symmetric
    0/1 with a zero diagonal (`core.mixing.MixingProcess.realize`); the
    kernel computes W_k from it, bit for bit `ref.metropolis_ref`."""
    if _check("masked_gossip_update", X, U, out, {"mask": mask, "B": B}):
        return _plain_out(ref.masked_gossip_ref(mask, B, X, U), out)
    if out is None:
        out = torch.empty_like(X)
    _columns("masked_gossip_update", X, U, out)
    mask, B = mask.contiguous(), B.contiguous()
    status = library("gossip").masked_gossip_update(
        dtype_code(X.dtype), mask.data_ptr(), B.data_ptr(), X.data_ptr(),
        U.data_ptr(), out.data_ptr(), X.shape[0], X.shape[1],
        stream_ptr(X.device))
    check_status("masked_gossip_update", status)
    launch_counts["masked_gossip_update"] += 1
    return out


def masked_gossip_update_krng(key: torch.Tensor, keep_prob,
                              adj: torch.Tensor, B: torch.Tensor,
                              X: torch.Tensor, U: torch.Tensor,
                              out: torch.Tensor | None = None):
    """`masked_gossip_update` on the mask drawn in the kernel: returns
    ``(out, mask)``.

    ``key``: a (2,) threefry key (int64 words) — on the CPU, or on X's
    device (a key derived there from a CUDA graph's step counter: the
    kernel reads it from device memory, so the wrapper neither syncs nor
    copies from the host) — the mask is that of ``prng.bits(key, (m,
    m))``: one U[0, 1) per undirected edge, kept if below ``keep_prob`` (a
    float, compared in float32) and if ``adj`` (m, m off-diagonal 0/1) has
    the edge.  With ``MixingProcess.mask_key(step)``, ``keep_prob`` and
    ``mask_adj()`` it is that process's realized mask bit for bit."""
    if not isinstance(key, torch.Tensor):
        key = torch.as_tensor(key)
    if key.shape != (2,):
        raise ValueError(f"key must be a (2,) threefry key, got "
                         f"{tuple(key.shape)}")
    keep_prob = float(keep_prob)
    if _check("masked_gossip_update_krng", X, U, out, {"adj": adj, "B": B}):
        v, mask = ref.masked_gossip_krng_ref(key, keep_prob, adj, B, X, U)
        return _plain_out(v, out), mask
    if out is None:
        out = torch.empty_like(X)
    _columns("masked_gossip_update_krng", X, U, out)
    m = X.shape[0]
    key32 = to_device(key.to(torch.int64), X.device).to(torch.uint32)
    mask = torch.empty((m, m), dtype=torch.float32, device=X.device)
    adj, B = adj.contiguous(), B.contiguous()
    status = library("gossip").masked_gossip_update_krng(
        dtype_code(X.dtype), key32.data_ptr(), keep_prob, adj.data_ptr(),
        B.data_ptr(), X.data_ptr(), U.data_ptr(), out.data_ptr(),
        mask.data_ptr(), m, X.shape[1], stream_ptr(X.device))
    check_status("masked_gossip_update_krng", status)
    launch_counts["masked_gossip_update_krng"] += 1
    return out, mask


_MODE_CODES = {"nan": 0, "inf": 1, "scale": 2}


def guarded_gossip_update(mask: torch.Tensor, B: torch.Tensor,
                          X: torch.Tensor, U: torch.Tensor,
                          XT: torch.Tensor | None = None,
                          UT: torch.Tensor | None = None,
                          clip: float | None = 1e3, *,
                          corrupt: torch.Tensor | None = None,
                          mode: str = "nan", scale: float = 1e4,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Gossip with a per-link finite guard (`ref.guarded_gossip_ref`):
    Metropolis weights from ``mask`` as `masked_gossip_update`, self terms
    from the clean X, U, and every off-diagonal link w_ij xt_j - b_ij ut_j
    passed through ``where(isfinite(v), clip(v, ±clip), 0)`` before the sum
    (``clip=None``: no guard).

    The transmit buffers are either given (``XT``, ``UT``, the reference's
    form) or formed from X, U and the (m,) 0/1 ``corrupt`` vector by
    ``mode``/``scale`` (`ref.poison_transmit`) — on the card in registers,
    so the step stages no transmit buffer."""
    if (XT is None) != (UT is None):
        raise ValueError("pass both XT and UT, or neither")
    if XT is not None and corrupt is not None:
        raise ValueError("pass the transmit buffers or corrupt, not both")
    if mode not in _MODE_CODES:
        raise ValueError(f"unknown corrupt mode {mode!r}; have "
                         f"{tuple(_MODE_CODES)}")
    if XT is not None and (XT.shape != X.shape or UT.shape != X.shape
                           or XT.dtype != X.dtype or UT.dtype != X.dtype
                           or XT.device != X.device
                           or UT.device != X.device):
        raise ValueError("XT and UT must match X in shape, dtype and device")
    m = X.shape[0]
    if corrupt is not None and corrupt.shape != (m,):
        raise ValueError(f"corrupt must be ({m},), got "
                         f"{tuple(corrupt.shape)}")
    if _check("guarded_gossip_update", X, U, out, {"mask": mask, "B": B}):
        if XT is None:
            c = corrupt if corrupt is not None else torch.zeros(m)
            XT = ref.poison_transmit(X, c, mode, scale)
            UT = ref.poison_transmit(U, c, mode, scale)
        return _plain_out(ref.guarded_gossip_ref(mask, B, X, U, XT, UT,
                                                 clip), out)
    if out is None:
        out = torch.empty_like(X)
    staged = XT is not None
    _columns("guarded_gossip_update", X, U, out,
             *((XT, UT) if staged else ()))
    corrupt_dev = (to_device(corrupt.to(torch.float32).contiguous(),
                             X.device) if corrupt is not None else None)
    # the scale as the buffer's dtype holds it (bf16: 1e4 -> 9984)
    scale_t = float(torch.tensor(scale, dtype=X.dtype))
    mask, B = mask.contiguous(), B.contiguous()
    status = library("gossip").guarded_gossip_update(
        dtype_code(X.dtype), mask.data_ptr(), B.data_ptr(), X.data_ptr(),
        U.data_ptr(), XT.data_ptr() if staged else None,
        UT.data_ptr() if staged else None,
        corrupt_dev.data_ptr() if corrupt_dev is not None else None,
        _MODE_CODES[mode], scale_t, 0.0 if clip is None else float(clip),
        int(clip is not None), out.data_ptr(), m, X.shape[1],
        stream_ptr(X.device))
    check_status("guarded_gossip_update", status)
    launch_counts["guarded_gossip_update"] += 1
    return out


# --------------------------------------------------------------------------
# The ring layout


def _ring_check(name: str, w_tab: torch.Tensor, b_tab: torch.Tensor,
                perms: torch.Tensor, X: torch.Tensor, U: torch.Tensor,
                out) -> bool:
    """Validate the ring kernels' shared arguments; True when the data lie
    on the CPU (the plain version's case).  ``perms`` stays on the host."""
    if X.dim() != 2 or U.shape != X.shape or U.dtype != X.dtype:
        raise ValueError(f"X and the second buffer must be equal (m, n) "
                         f"matrices of one dtype, got {tuple(X.shape)} "
                         f"{X.dtype} and {tuple(U.shape)} {U.dtype}")
    m = X.shape[0]
    ndirs = _ndirs(perms, m)
    if w_tab.shape != (m, 1 + ndirs) or b_tab.shape != (m, 1 + ndirs):
        raise ValueError(
            f"direction tables must be (m, 1+ndirs) = {(m, 1 + ndirs)}: w "
            f"{tuple(w_tab.shape)}, b {tuple(b_tab.shape)}, perms "
            f"{tuple(perms.shape)}")
    if not 1 <= m <= MAX_AGENTS:
        raise ValueError(f"{name} takes 1..{MAX_AGENTS} agents, got {m}")
    if out is not None and (out.shape != X.shape or out.dtype != X.dtype
                            or out.device != X.device):
        raise ValueError("out must match X in shape, dtype and device")
    devices = {t.device for t in (X, U, w_tab, b_tab)}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or X.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors on one "
                         f"device, got {sorted(map(str, devices))}")
    if w_tab.dtype != torch.float32 or b_tab.dtype != torch.float32:
        raise TypeError(f"{name}: w_tab and b_tab must be float32")
    if ndirs > MAX_DIRECTIONS:
        raise ValueError(f"{name} takes at most {MAX_DIRECTIONS} "
                         f"directions, got {ndirs}")
    return False


def _is_table(perms: torch.Tensor) -> bool:
    return perms.dim() == 2 and not perms.is_floating_point()


def _ndirs(perms: torch.Tensor, m: int) -> int:
    """Directions of ``perms``: (ndirs, m, m) 0/1 matrices, or the
    (ndirs, m) integer source table (`dist.collectives.source_table`)."""
    if _is_table(perms) and perms.shape[1] == m:
        return perms.shape[0]
    if perms.dim() == 3 and perms.shape[1:] == (m, m):
        return perms.shape[0]
    raise ValueError(f"perms must be (ndirs, {m}, {m}) 0/1 matrices or an "
                     f"(ndirs, {m}) source table, got {tuple(perms.shape)}")


def _perm_matrices(perms: torch.Tensor, m: int) -> torch.Tensor:
    """The (ndirs, m, m) float 0/1 form: row i of direction d has its one
    at the sender agent i receives from."""
    if _is_table(perms):
        return torch.nn.functional.one_hot(perms.long(), m).float()
    return perms.float()


def _sources(perms: torch.Tensor, m: int) -> torch.Tensor:
    """The (ndirs, m) int32 source table the kernels take, on the host;
    raises unless every direction is a permutation."""
    p = perms.cpu()
    if not _is_table(p):
        if not bool(((p == 0) | (p == 1)).all()):
            raise ValueError("perms must be 0/1 matrices")
        if not (bool((p.sum(2) == 1).all()) and bool((p.sum(1) == 1).all())):
            raise ValueError("each perms[d] must be a permutation matrix")
        p = p.argmax(dim=2)
    if not bool((p.sort(dim=1).values == torch.arange(m)).all()):
        raise ValueError("each row of the source table must be a "
                         "permutation of the agents")
    return p.to(torch.int32).contiguous()


def _lam(lam_bar, device) -> torch.Tensor:
    """lam_bar as a (1,) f32 tensor on ``device``; a python number becomes
    a device fill, not a host-to-device copy."""
    if isinstance(lam_bar, torch.Tensor):
        return lam_bar.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(lam_bar), dtype=torch.float32,
                      device=device)


def _ring_launch(fn: str, w_tab, b_tab, perms, X, out, capture: bool,
                 *args, tail=()):
    """Allocate the capture outputs, launch ``fn`` of ``csrc/ring.cu`` on
    X's stream and count it; every tensor the kernel reads stays referenced
    until the launch is queued.  ``args``: the arguments between X and out;
    ``tail``: those after the capture outputs.  Returns (v, u), None
    without capture; ``capture="v"`` captures v alone (u None)."""
    m, n = X.shape
    ndirs = _ndirs(perms, m)
    src = to_device(_sources(perms, m), X.device)
    w_tab, b_tab = w_tab.contiguous(), b_tab.contiguous()
    v = (torch.empty((ndirs, m, n), dtype=torch.float32, device=X.device)
         if capture else None)
    u = (torch.empty((m, n), dtype=torch.float32, device=X.device)
         if capture and capture != "v" and fn != "ring_gossip_update"
         else None)
    outs = [v.data_ptr() if v is not None else None]
    if fn != "ring_gossip_update":
        outs.append(u.data_ptr() if u is not None else None)
    status = getattr(library("ring"), fn)(
        dtype_code(X.dtype), w_tab.data_ptr(), b_tab.data_ptr(),
        src.data_ptr(), ndirs, X.data_ptr(), *args, out.data_ptr(), *outs,
        *tail, m, n, stream_ptr(X.device))
    check_status(fn, status)
    launch_counts[fn] += 1
    return v, u


def ring_gossip_update(w_tab: torch.Tensor, b_tab: torch.Tensor,
                       perms: torch.Tensor, X: torch.Tensor, U: torch.Tensor,
                       capture: bool = False,
                       out: torch.Tensor | None = None):
    """x' = W X - B U from direction tables (`ref.ring_gossip_ref`).

    ``w_tab``/``b_tab``: (m, 1 + ndirs) float32 — column 0 the self term,
    column 1 + d agent j's weight on its direction-d message
    (`dist.collectives.directional_weights`, `rows_from_dense`); ``perms``:
    (ndirs, m, m) 0/1 receiver <- sender permutations
    (`dist.collectives.perm_stack`) or their (ndirs, m) source table
    (`dist.collectives.source_table`), on the host; X, U: (m, n) float32
    or bfloat16, m <= 32, ndirs <= 4.  Returns out in X's dtype, or
    ``(out, v)`` with ``capture``: v (ndirs, m, n) f32, v[d][j] what agent
    j sent toward direction d.  The kernel is bitwise with the plain
    version."""
    if _ring_check("ring_gossip_update", w_tab, b_tab, perms, X, U, out):
        o, v = ref.ring_gossip_ref(w_tab, b_tab,
                                   _perm_matrices(perms, X.shape[0]), X, U)
        o = _plain_out(o, out)
        return (o, v) if capture else o
    if out is None:
        out = torch.empty_like(X)
    _columns("ring_gossip_update", X, U, out)
    v, _ = _ring_launch("ring_gossip_update", w_tab, b_tab, perms, X, out,
                        capture, U.data_ptr())
    return (out, v) if capture else out


def _check_bits(bits: torch.Tensor, X: torch.Tensor) -> None:
    if bits.shape != X.shape or bits.dtype != torch.uint32 \
            or bits.device != X.device:
        raise ValueError("bits must be a torch.uint32 tensor shaped like X "
                         "on its device")


def ring_obfuscate_gossip(w_tab: torch.Tensor, b_tab: torch.Tensor,
                          perms: torch.Tensor, X: torch.Tensor,
                          G: torch.Tensor, bits: torch.Tensor, lam_bar,
                          capture: bool = False,
                          out: torch.Tensor | None = None):
    """The whole Eq. (4) step in one pass: u = (2 lam_bar) U(bits) ∘ g
    formed in the kernel (never stored), then `ring_gossip_update`'s
    accumulation (`ref.ring_obfuscate_gossip_ref`).  ``bits``: (m, n)
    uint32; ``lam_bar`` a float or a device scalar.  Returns out, or
    ``(out, v, u)`` with ``capture`` (v (ndirs, m, n), u (m, n), f32;
    ``capture="v"``: the kernel writes no u, which is then None on a
    card)."""
    _check_bits(bits, X)
    if _ring_check("ring_obfuscate_gossip", w_tab, b_tab, perms, X, G, out):
        o, v, u = ref.ring_obfuscate_gossip_ref(
            w_tab, b_tab, _perm_matrices(perms, X.shape[0]), X, G, bits,
            lam_bar)
        o = _plain_out(o, out)
        return (o, v, u) if capture else o
    if out is None:
        out = torch.empty_like(X)
    _columns("ring_obfuscate_gossip", X, G, out, bits)
    lam = _lam(lam_bar, X.device)
    v, u = _ring_launch("ring_obfuscate_gossip", w_tab, b_tab, perms, X, out,
                        capture, G.data_ptr(), bits.data_ptr(),
                        lam.data_ptr())
    return (out, v, u) if capture else out


def ring_obfuscate_gossip_krng(w_tab: torch.Tensor, b_tab: torch.Tensor,
                               perms: torch.Tensor, X: torch.Tensor,
                               G: torch.Tensor, keys: torch.Tensor, offsets,
                               lam_bar, capture: bool = False,
                               export_bits: bool = False,
                               out: torch.Tensor | None = None):
    """`ring_obfuscate_gossip` with Lambda's bits drawn in the kernel by
    threefry2x32 from the per-(agent, leaf) key table of
    `obfuscate_update_krng`: ``keys`` (m, n_leaves, 2) uint32 words (uint32
    or int64 holding them), ``offsets`` (n_leaves + 1,) column offsets of
    the leaves (columns past ``offsets[-1]`` are padding and draw 0).  With
    `core.pdsgd.lambda_key_table` the bits are `core.pdsgd.per_agent_bits`,
    so the output equals `ring_obfuscate_gossip`'s on those bits, bit for
    bit.

    This is the port's contract, not the reference's: the reference's
    kernel seeds the TPU's own generator from a (2,) seed, a stream no
    other device reproduces (and which the reference refuses on the CPU).

    Returns out, then ``(v, u)`` with ``capture`` (``capture="v"``: u
    None on a card, as `ring_obfuscate_gossip`), then the drawn (m, n)
    uint32 bits with ``export_bits``, as one tuple when either is on."""
    m, n = X.shape
    offsets = torch.as_tensor(offsets, dtype=torch.int64)
    n_leaves = offsets.numel() - 1
    if keys.shape != (m, n_leaves, 2):
        raise ValueError(f"keys must be (m, n_leaves, 2) = "
                         f"{(m, n_leaves, 2)}, got {tuple(keys.shape)}")
    if _ring_check("ring_obfuscate_gossip_krng", w_tab, b_tab, perms, X, G,
                   out):
        o, v, u, bits = ref.ring_obfuscate_gossip_krng_ref(
            w_tab, b_tab, _perm_matrices(perms, m), X, G, keys, offsets,
            lam_bar)
        o = _plain_out(o, out)
    else:
        if not 1 <= n_leaves <= 1024:
            raise ValueError(f"needs 1..1024 leaves, got {n_leaves}")
        if out is None:
            out = torch.empty_like(X)
        _columns("ring_obfuscate_gossip_krng", X, G, out)
        keys32 = to_device(keys.to(torch.int64).to(torch.uint32)
                           .contiguous(), X.device)
        offsets = to_device(offsets, X.device)
        bits = (torch.empty((m, n), dtype=torch.uint32, device=X.device)
                if export_bits else None)
        lam = _lam(lam_bar, X.device)
        v, u = _ring_launch(
            "ring_obfuscate_gossip_krng", w_tab, b_tab, perms, X, out,
            capture, G.data_ptr(), keys32.data_ptr(), offsets.data_ptr(),
            n_leaves, lam.data_ptr(),
            tail=(bits.data_ptr() if bits is not None else None,))
        o = out
    res = (o,) + ((v, u) if capture else ()) + ((bits,) if export_bits
                                                else ())
    return res if len(res) > 1 else o
