"""Device-resident decode loop: K tokens per host round trip (counterpart
of ``repro.serve.loop``).

The reference's ``lax.scan`` over ``chunk`` steps becomes a Python loop
of ``chunk`` decode steps on device tensors: sample -> decode -> retire,
with no host sync inside (no ``.item()``, no host-side branch on device
values), the cache slab updated in place.  The (chunk, slots) token and
emitted blocks come to the host once, at the chunk's end.  Retirement
(EOS / token budget) is computed on the device: a finished slot stops
emitting and holds its position, but stays in the fixed-shape batch until
the engine re-fills it.

Sampling keys derive from a dedicated fold_in DOMAIN off the serve base
key, then per (request id, absolute position) with the port's threefry
(`core.prng`, bitwise ``jax.random``): disjoint from the prompt-synthesis
streams and slot-independent, so a request draws the same tokens whether
it decodes alone or packed in a full batch.
"""
from __future__ import annotations

import torch

from ..core import prng

__all__ = ["SAMPLE_DOMAIN", "sampling_key", "sample_token",
           "init_loop_state", "make_decode_loop", "sequential_decode"]

# fold_in domain separating sampling keys from every data-synthesis stream
SAMPLE_DOMAIN = 0x5E12


def sampling_key(base_key: torch.Tensor, req_id, pos) -> torch.Tensor:
    """Per-(request, position) sampling key, slot- and batch-independent.
    ``req_id`` and ``pos`` may be (S,) tensors: then (S, 2) keys."""
    k = prng.fold_in(base_key, SAMPLE_DOMAIN)
    return prng.fold_in(prng.fold_in(k, req_id), pos)


def sample_token(logits: torch.Tensor, key: torch.Tensor | None,
                 temperature: float,
                 vocab_size: int | None = None) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature sampling over the last axis
    of ``logits`` (..., V), one key (..., 2) per row; int32 ids.
    ``vocab_size`` masks the padded vocab tail so pad ids are never
    emitted.  The division by the temperature is a true f32 division, as
    the reference's (a Python-scalar divisor on a CUDA tensor would be a
    multiply by its reciprocal)."""
    lf = logits.float()
    if vocab_size is not None and vocab_size < lf.shape[-1]:
        pad = torch.arange(lf.shape[-1], device=lf.device) >= vocab_size
        lf = lf.masked_fill(pad, -1e30)
    if temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    temp = torch.full((), temperature, dtype=torch.float32, device=lf.device)
    return prng.categorical(key, lf / temp).to(torch.int32)


def init_loop_state(cache: dict, slots: int, vocab: int,
                    base_key: torch.Tensor) -> dict:
    """All-slots-free device state consumed by `make_decode_loop`, on the
    cache's device."""
    dev = next(iter(cache.values())).device
    return {
        "cache": cache,
        "logits": torch.zeros((slots, vocab), dtype=torch.float32,
                              device=dev),
        "pos": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "req_id": torch.full((slots,), -1, dtype=torch.int32, device=dev),
        "active": torch.zeros((slots,), dtype=torch.bool, device=dev),
        "remaining": torch.zeros((slots,), dtype=torch.int32, device=dev),
        "key": base_key.to(dev),
    }


def make_decode_loop(bundle, *, chunk: int, temperature: float = 0.0,
                     eos_id: int | None = None):
    """Build the K-token decode step.

    Returns ``run(params, state) -> (state, tokens (K, S) int32, emitted
    (K, S) bool)``, all on the device; ``state`` is updated in place (its
    cache slab by the decode's in-place writes)."""
    decode = bundle.decode_fn
    vocab_size = bundle.cfg.vocab_size

    def run(params, state):
        toks_k, emitted_k = [], []
        for _ in range(chunk):
            active, pos = state["active"], state["pos"]
            keys = (sampling_key(state["key"], state["req_id"], pos)
                    if temperature > 0.0 else None)
            toks = sample_token(state["logits"], keys, temperature,
                                vocab_size)
            remaining = state["remaining"] - active.to(torch.int32)
            done = remaining <= 0
            if eos_id is not None:
                done = done | (toks == eos_id)
            out = decode(params, toks, state["cache"], pos)
            state["logits"] = torch.where(active[:, None],
                                          out["logits"].float(),
                                          state["logits"])
            state["pos"] = torch.where(active, pos + 1, pos)
            state["remaining"] = torch.where(active, remaining,
                                             state["remaining"])
            state["active"] = active & ~done
            toks_k.append(toks)
            emitted_k.append(active)
        return state, torch.stack(toks_k), torch.stack(emitted_k)

    return run


def sequential_decode(bundle, params, batch: dict, req_id: int,
                      max_new: int, *, temperature: float = 0.0,
                      eos_id: int | None = None, base_key: torch.Tensor,
                      max_seq_len: int | None = None, prefill=None,
                      decode=None, logits_out: list | None = None
                      ) -> list[int]:
    """Per-request (B=1) host-loop reference: prefill the prompt, then
    sample/decode one token per step with the SAME (request, position)
    sampling keys as the batched loop; the parity oracle for the engine.

    ``max_seq_len`` re-pages the prompt-length prefill cache into a 1-slot
    slab of the engine's ring capacity (prefill alone gives a C=prompt_len
    ring, which wraps earlier); pass the engine's value when comparing
    against it.  ``logits_out``, when given, receives each sampled
    position's f32 logits row."""
    from .cache import make_layout, write_slot
    prefill = prefill or bundle.prefill_fn
    decode = decode or bundle.decode_fn
    out = prefill(params, batch)
    logits, cache = out["logits"], out["cache"]
    dev = logits.device
    if max_seq_len is not None:
        layout = make_layout(bundle, 1, max_seq_len)
        cache = write_slot(layout, layout.init(dev), cache, 0)
    p = int(out["pos"])
    key = base_key.to(dev)
    toks: list[int] = []
    for _ in range(max_new):
        k = sampling_key(key, req_id, p) if temperature > 0.0 else None
        if logits_out is not None:
            logits_out.append(logits[0].float())
        tok = int(sample_token(logits[0], k, temperature,
                               bundle.cfg.vocab_size))
        toks.append(tok)
        if eos_id is not None and tok == eos_id:
            break
        if len(toks) >= max_new:
            break
        out = decode(params, torch.tensor([tok], dtype=torch.int32,
                                          device=dev), cache, p)
        logits, cache = out["logits"], out["cache"]
        p += 1
    return toks
