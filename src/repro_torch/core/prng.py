"""Threefry-2x32 counter randomness, bit-for-bit with ``jax.random``.

The reference draws every privacy-relevant random number (the stepsize
diagonal Lambda^k, the column-stochastic B^k) from ``jax.random`` keys under
``jax_threefry_partitionable=True`` (jax's default).  Reproducing that
stream exactly is what lets the port's trajectory be held against the
reference step for step, so this module re-implements the few pieces the
port needs in plain torch integer ops:

* a key is a (..., 2) int64 tensor holding two uint32 words;
* ``key(seed)``       = (seed >> 32, seed & 0xFFFFFFFF);
* ``fold_in(k, d)``   = threefry2x32(k, (0, d));
* ``split(k, n)[i]``  = threefry2x32(k, (hi(i), lo(i)));
* ``bits(k, shape)``  = x0 ^ x1 of threefry2x32(k, (hi(i), lo(i))) over the
  row-major flat index i of ``shape``;
* ``uniform``         = the mantissa trick on ``bits``:
  bitcast((bits >> 9) | 0x3F800000) - 1;
* ``exponential``     = -log1p(-uniform);
* ``randint``         = jax's two-draw modulus rule for int32;
* ``gumbel``          = -log(-log(uniform(tiny, 1))), jax's default "low"
  mode, and ``categorical`` = argmax(logits + gumbel), first index on ties.

All arithmetic runs in int64 masked to 32 bits, so it is exact on any
device.  ``bits`` returns ``torch.uint32``; the helpers below convert.
"""
from __future__ import annotations

import torch

__all__ = ["key", "fold_in", "split", "bits", "uniform", "exponential",
           "randint", "gumbel", "categorical", "threefry2x32",
           "bits_to_uniform", "leaf_bits", "MASK32"]

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
    ``data`` is an int or an int tensor broadcastable to those dims."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK32
    zero = torch.zeros_like(data)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], zero + 0 * k[..., 0],
                          data + 0 * k[..., 0])
    return torch.stack([y0, y1], dim=-1)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return (i >> 32) & MASK32, i & MASK32


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(k, num)`` -> (num, 2) keys."""
    hi, lo = _counters(num, k.device)
    y0, y1 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def _bits_batched(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``bits(key, (n,))`` for every key of a (..., 2) table at once:
    (..., n) int64 holding uint32 values."""
    hi, lo = _counters(n, keys.device)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], hi, lo)
    return y0 ^ y1


def _bits64(k: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    return _bits_batched(k, n).reshape(tuple(shape))


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as a ``torch.uint32`` tensor."""
    return _bits64(k, shape).to(torch.uint32)


def bits_to_uniform(b: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1) by the mantissa trick (exact)."""
    b = b.to(torch.int64)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32)`` (minval 0, maxval 1)."""
    return torch.clamp_min(bits_to_uniform(_bits64(k, shape)), 0.0)


def exponential(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.exponential(k, shape, float32)`` = -log1p(-u).  The
    transcendental may differ from XLA's by an ulp or two."""
    return -torch.log1p(-uniform(k, shape))


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
    max with tiny changes nothing); the two logs may differ from XLA's by
    an ulp."""
    u = bits_to_uniform(_bits_batched(keys.to(torch.int64), n)) + _TINY
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one key
    (..., 2) per row of ``logits`` (..., V): the argmax of logits + gumbel
    noise, the first index on ties (int64)."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)


def leaf_bits(keys: torch.Tensor, offsets, rows: int, cols: int,
              start: int = 0, stop: int | None = None,
              chunk: int = 1 << 22) -> torch.Tensor:
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
            y0, y1 = threefry2x32(k[:, l, 0:1], k[:, l, 1:2],
                                  (i >> 32) & MASK32, i & MASK32)
            out[:, c - start:c - start + n] = (y0 ^ y1).to(torch.uint32)
    return out
