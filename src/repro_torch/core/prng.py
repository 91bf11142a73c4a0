"""Threefry-2x32 counter randomness, bit-for-bit with ``jax.random``.

The reference draws every privacy-relevant random number (the stepsize
diagonal Lambda^k, the column-stochastic B^k) from ``jax.random`` keys under
``jax_threefry_partitionable=True`` (jax's default since 0.5).
Reproducing that stream exactly is what lets the port's trajectory be held
against the reference step for step, so this module re-implements the few
pieces the port needs in plain torch integer ops:

* a key is a (..., 2) int64 tensor holding two uint32 words;
* ``key(seed)``       = (seed >> 32, seed & 0xFFFFFFFF);
* ``fold_in(k, d)``   = threefry2x32(k, (0, d));
* ``split(k, n)[i]``  = threefry2x32(k, (hi(i), lo(i)));
* ``bits(k, shape)``  = x0 ^ x1 of threefry2x32(k, (hi(i), lo(i))) over the
  row-major flat index i of ``shape``;
* ``uniform``         = the mantissa trick on ``bits``:
  bitcast((bits >> 9) | 0x3F800000) - 1;
* ``exponential``     = -log1p(-uniform);
* ``normal``          = sqrt(2) erfinv(u), u uniform on (nextafter(-1, 0), 1)
  by the same mantissa trick (float32; bfloat16 from the low byte);
* ``randint``         = jax's two-draw modulus rule for int32;
* ``gumbel``          = -log(-log(uniform(tiny, 1))), jax's default "low"
  mode, and ``categorical`` = argmax(logits + gumbel), first index on ties.

The draws a training step makes (``split``, ``bits``, ``bits_at``,
``uniform``, ``exponential``, ``normal``, ``leaf_bits``) take
``partitionable`` (default True, the stream above).  False draws jax's earlier default stream (``jax_threefry_partitionable=
False``, jax < 0.5), the one the repo's recorded Fig. 2 target
(``BENCH_pdsgd.json``'s ``final_err_scanned``) was drawn from: ``split(k,
n)`` ciphers the pairs (i, n + i) and interleaves the two output halves;
``bits`` of n words ciphers the pairs (i, i + h), h = ceil(n / 2) (the
last one (h - 1, 0) for odd n), word i < h the first output of pair i,
word i >= h the second of pair i - h; an 8-bit draw takes byte i % 4 of
word i // 4 of a ceil(n / 4)-word draw.  ``fold_in`` and ``key`` are the
same in both streams.  The stream is an argument, never a mode: a caller
that draws from the earlier one says so at every draw.

All arithmetic runs in int64 masked to 32 bits, so it is exact on any
device: a key derived on the card (from a device step counter, as a CUDA
graph of steps does) has the bits of the same key derived on the host.
``fold_in``'s data may be a device int tensor.  ``bits`` returns
``torch.uint32``; the helpers below convert.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["key", "fold_in", "split", "bits", "bits_at", "uniform",
           "exponential", "normal", "normal_from_bits", "erfinv32", "randint",
           "gumbel",
           "categorical", "threefry2x32", "bits_to_uniform", "leaf_bits",
           "MASK32"]

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round Threefry-2x32 block cipher on int64 tensors holding
    uint32 values (jax ``_threefry2x32_lowering``, unrolled form)."""
    k0 = torch.as_tensor(k0, dtype=torch.int64, device=x0.device)
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=x0.device)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` as a (2,) int64 tensor of uint32 words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: k may carry leading batch dims (..., 2);
    ``data`` is an int or an int tensor broadcastable to those dims (on
    k's device: a device step counter folds in without a host sync)."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=k.device, dtype=torch.int64)
    else:  # a fill, not a host copy: legal inside a CUDA graph's capture
        data = torch.full((), int(data), dtype=torch.int64, device=k.device)
    data = data & MASK32
    zero = torch.zeros_like(data)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], zero + 0 * k[..., 0],
                          data + 0 * k[..., 0])
    return torch.stack([y0, y1], dim=-1)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return (i >> 32) & MASK32, i & MASK32


def split(k: torch.Tensor, num: int,
          partitionable: bool = True) -> torch.Tensor:
    """``jax.random.split(k, num)`` -> (num, 2) keys; a (..., 2) table of
    keys gives (..., num, 2), each key split on its own."""
    if partitionable:
        hi, lo = _counters(num, k.device)
        y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], hi, lo)
        return torch.stack([y0, y1], dim=-1)
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], i, i + num)
    out = torch.cat([y0, y1], dim=-1)
    return out.reshape(out.shape[:-1] + (num, 2))


def _words(k0, k1, idx: torch.Tensor, n: int, byte: bool = False,
           partitionable: bool = True) -> torch.Tensor:
    """The words of an n-element ``jax.random.bits`` draw at the flat
    indices ``idx`` (int64), as int64 holding uint32, in the stream
    ``partitionable`` names.  ``byte``: of an 8-bit draw, the word whose
    low byte is the draw's byte (the 32-bit word itself in the
    partitionable stream)."""
    if partitionable:
        y0, y1 = threefry2x32(k0, k1, (idx >> 32) & MASK32, idx & MASK32)
        return y0 ^ y1
    if n >= 1 << 32:
        raise ValueError("the original threefry stream draws fewer than "
                         "2^32 words at once here")
    shift = None
    if byte:
        idx, shift = idx // 4, (idx % 4) * 8
        n = -(-n // 4)
    h = (n + 1) // 2
    first = idx < h
    x0 = torch.where(first, idx, idx - h)
    second = torch.where(idx + h < n, idx + h, torch.zeros_like(idx))
    y0, y1 = threefry2x32(k0, k1, x0, torch.where(first, second, idx))
    w = torch.where(first, y0, y1)
    return w if shift is None else w >> shift


def _bits_batched(keys: torch.Tensor, n: int, byte: bool = False,
                  partitionable: bool = True) -> torch.Tensor:
    """``bits(key, (n,))`` for every key of a (..., 2) table at once:
    (..., n) int64 holding uint32 values."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    return _words(keys[..., 0:1], keys[..., 1:2], idx, n, byte,
                  partitionable)


def _bits64(k: torch.Tensor, shape, byte: bool = False,
            partitionable: bool = True) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    return _bits_batched(k, n, byte, partitionable).reshape(tuple(shape))


def bits_at(k: torch.Tensor, idx: torch.Tensor, n: int, byte: bool = False,
            partitionable: bool = True) -> torch.Tensor:
    """The words of ``bits(k, shape)`` (n elements) at the row-major flat
    indices ``idx`` (an int64 tensor on k's device), as int64 holding
    uint32: a block of a large draw without the rest of it (``byte``: of
    an 8-bit draw, see `_words`)."""
    return _words(k[..., 0], k[..., 1], idx, n, byte, partitionable)


def bits(k: torch.Tensor, shape, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as a ``torch.uint32`` tensor."""
    return _bits64(k, shape, partitionable=partitionable).to(torch.uint32)


def bits_to_uniform(b: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1) by the mantissa trick (exact)."""
    b = b.to(torch.int64)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k: torch.Tensor, shape,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` (minval 0, maxval 1)."""
    return torch.clamp_min(bits_to_uniform(
        _bits64(k, shape, partitionable=partitionable)), 0.0)


def exponential(k: torch.Tensor, shape,
                partitionable: bool = True) -> torch.Tensor:
    """``jax.random.exponential(k, shape, float32)`` = -log1p(-u).  The
    transcendental may differ from XLA's by an ulp or two."""
    return -torch.log1p(-uniform(k, shape, partitionable))


# jax's normal: u = max(lo, f * (1 - lo) + lo) with f the mantissa draw on
# [0, 1) and lo = nextafter(-1, 0) in the dtype; (1 - lo) rounds to 2 in
# float32 and in bfloat16 alike, so f * 2 is exact and the sum rounds once
_NORMAL_LO = {torch.float32: float(np.nextafter(np.float32(-1.0),
                                                np.float32(0.0))),
              torch.bfloat16: -0.99609375}
_SQRT2 = {torch.float32: float(np.float32(np.sqrt(2.0))),
          torch.bfloat16: 1.4140625}


# XLA's float32 erf_inv (Giles' single-precision approximation): with
# w = -log1p(-x^2), a degree-8 polynomial in w - 2.5 (w < 5) or in
# sqrt(w) - 3, times x
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on a float32 tensor, written so that every
    device and every vector width gives the same bits (``torch.erfinv``
    does not: its vectorized and scalar CPU paths differ by up to 7.5e-5
    in the tails, so its result moved with the thread partition).  The
    log1p is taken in float64 and rounded, each polynomial step c + p w in
    float64 and rounded (a fused multiply-add, as XLA emits it); XLA's own
    float32 log1p leaves up to 3 ulps between the two (measured)."""
    w = (-torch.log1p(-(x * x).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]).float()

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef(i).double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal_from_bits(b: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` from its threefry words ``b`` (int64 holding
    uint32, `bits_at`): float32 from the top 23 bits, bfloat16 from bits
    7..1 (jax draws a dtype of fewer than 8 mantissa bits from 8-bit
    words: ``byte=True`` draws).  The inverse error function is
    `erfinv32`, in float32 for both dtypes (XLA's upcast for bfloat16)."""
    if dtype == torch.float32:
        f = bits_to_uniform(b)
    elif dtype == torch.bfloat16:
        w = ((b & 0xFF) >> 1) | 0x3F80
        f = w.to(torch.int16).view(torch.bfloat16) - 1.0
    else:
        raise TypeError(f"normal draws float32 or bfloat16, got {dtype}")
    lo = _NORMAL_LO[dtype]
    u = torch.clamp_min(f * 2.0 + lo, lo)
    return erfinv32(u.float()).to(dtype) * _SQRT2[dtype]


def normal(k: torch.Tensor, shape, dtype=torch.float32,
           partitionable: bool = True) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)`` for float32 or bfloat16, on
    k's device."""
    return normal_from_bits(
        _bits64(k, shape, dtype == torch.bfloat16, partitionable), dtype)


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` for int32, bit for
    bit (``jax._src.random._randint``): two draws from ``split(k)``, the
    high one folded in by ``2^32 mod span``, all in uint32 arithmetic that
    wraps.  Returns an int32 tensor on ``k``'s device."""
    span = maxval - minval if maxval > minval else 1
    if not 1 <= span <= 2**31 - 1:
        raise ValueError(f"randint span {span} out of the int32 range")
    k1, k2 = split(k, 2)
    hi, lo = _bits64(k1, shape), _bits64(k2, shape)
    mult = ((2**16 % span) ** 2 & MASK32) % span
    off = (((hi % span) * mult) & MASK32) + lo % span
    off = (off & MASK32) % span
    return (off + minval).to(torch.int32)


_TINY = torch.finfo(torch.float32).tiny


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (mode "low") for every key
    of a (..., 2) table: (..., n) float32.  The uniform on [tiny, 1) is the
    mantissa draw plus tiny, as jax forms it (never below tiny, so jax's
    max with tiny changes nothing).  The two logs are taken in float64 and
    rounded once to float32, within half an ulp of the exact
    -log(-log(u)): no float32 vector log of the library (whose accuracy
    may vary with the build and the thread) enters the result."""
    u = bits_to_uniform(_bits_batched(keys.to(torch.int64), n)) + _TINY
    return (-torch.log(-torch.log(u.double()))).float()


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one key
    (..., 2) per row of ``logits`` (..., V): the argmax of logits + gumbel
    noise, the first index on ties (int64)."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)


def leaf_bits(keys: torch.Tensor, offsets, rows: int, cols: int,
              start: int = 0, stop: int | None = None,
              chunk: int = 1 << 22,
              partitionable: bool = True) -> torch.Tensor:
    """Per-(row, leaf) `bits` laid side by side: row a, column c of leaf l
    (columns ``[offsets[l], offsets[l+1])``) is
    ``bits(keys[a, l], (n_l,))[c - offsets[l]]``, and padding columns past
    ``offsets[-1]`` are 0.  ``keys``: (rows, n_leaves, 2).  Only columns
    ``[start, stop)`` are computed (default: all ``cols``), ``chunk``
    columns at a time to bound the int64 temporaries.  Returns
    (rows, stop - start) ``torch.uint32`` on ``keys``' device."""
    stop = cols if stop is None else stop
    dev = keys.device
    out = torch.zeros((rows, stop - start), dtype=torch.uint32, device=dev)
    k = keys.to(torch.int64)
    off = [int(o) for o in torch.as_tensor(offsets).cpu()]
    for l in range(len(off) - 1):
        lo, hi = max(off[l], start), min(off[l + 1], stop)
        for c in range(lo, hi, chunk):
            n = min(chunk, hi - c)
            i = torch.arange(c - off[l], c - off[l] + n, dtype=torch.int64,
                             device=dev)[None, :]
            w = _words(k[:, l, 0:1], k[:, l, 1:2], i, off[l + 1] - off[l],
                       partitionable=partitionable)
            out[:, c - start:c - start + n] = w.to(torch.uint32)
    return out
