"""Serving CLI, a thin driver over `repro_torch.serve` (counterpart of
``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
      --slots 8 --requests 16 --prompt-len 2000 --gen-tokens 64

Modes (``--mode auto``: oneshot for the enc-dec (audio) family,
continuous for the others):

* ``continuous``: `serve.ServeEngine` slot-based continuous batching;
  queued requests prefill into free slots while the rest of the batch
  keeps decoding.  ``--arrival-rate`` turns the queue into an open-loop
  Poisson arrival process.
* ``static``: the same engine with gang admission (run-to-completion
  waves), the baseline continuous batching is measured against.
* ``oneshot``: one fixed uniform batch through the device-resident chunk
  loop (`serve.loop`); the only mode for the enc-dec family, whose
  cross-attention cache is encoder-length-shaped per request.

The synthetic data are the reference's, bitwise: prompts from
``key(seed + 1)``, an enc-dec batch's frames (B, prompt_len, d) from its
``fold_in(., 1)`` and a VLM's prefix embeds (n, P, d) from its ``fold_in(.,
2)``, both ``normal * 0.1`` in the model's dtype.  First-call and
steady-state times are reported apart; sampling keys live in
`serve.loop.SAMPLE_DOMAIN`, keyed per (request, position), disjoint from
the data streams.  Runs on the card unless ``--device cpu``; the
reference's ``--model-parallel`` is not ported yet.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ..configs import get_config
from ..core import prng
from ..models import build_model
from ..models.common import pad_vocab
from ..serve import (Request, ServeEngine, init_loop_state, make_decode_loop,
                     request_batch, sequential_decode)
from ..serve.engine import Completion, _sync

__all__ = ["build_parser", "synthetic_normal", "run_serving", "main"]


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def synthetic_normal(key: torch.Tensor, shape, dtype: torch.dtype,
                     device) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype) * 0.1`` bit for bit (the
    reference's synthetic frames and prefix embeds), drawn on ``device``
    one leading row at a time.  The 0.1 is rounded to ``dtype`` before the
    product, as jnp rounds a Python scalar."""
    n = math.prod(shape)
    row = n // shape[0]
    key = key.to(device)
    scale = torch.tensor(0.1, dtype=dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        idx = torch.arange(i * row, (i + 1) * row, dtype=torch.int64,
                           device=device)
        bits = prng.bits_at(key, idx, n, byte=dtype == torch.bfloat16)
        out[i] = (prng.normal_from_bits(bits, dtype) * scale).reshape(
            shape[1:])
    return out


def _synthetic_requests(cfg, args, device="cpu") -> list[Request]:
    """Prompts from the data key stream ``key(seed + 1)`` (bitwise the
    reference's ``jax.random.randint`` draw) and, for a VLM, each
    request's prefix embeds from its ``fold_in(., 2)`` (`synthetic_normal`,
    on ``device``); sampling keys never touch them (SAMPLE_DOMAIN
    separation)."""
    n = args.requests
    key = prng.key(args.seed + 1)
    prompts = prng.randint(key, (n, args.prompt_len), 0,
                           cfg.vocab_size).numpy()
    prefix = [None] * n
    if cfg.num_prefix_embeds:
        prefix = synthetic_normal(
            prng.fold_in(key, 2), (n, cfg.num_prefix_embeds, cfg.d_model),
            getattr(torch, cfg.dtype), device)
    arrivals = np.zeros(n)
    if args.arrival_rate > 0:
        rng = np.random.default_rng(args.seed)
        arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate, n))
    return [Request(req_id=i, tokens=prompts[i],
                    max_new_tokens=args.gen_tokens,
                    arrival_time=float(arrivals[i]),
                    prefix_embeds=prefix[i]) for i in range(n)]


def _summarize(completions: list[Completion], steady_chunk_s, compile_stats):
    done = [c for c in completions if c.first_token_at is not None]
    total_toks = sum(len(c.tokens) for c in completions)
    span = (max(c.finished_at for c in completions)
            - min(c.admitted_at for c in completions)) if completions else 0.0
    return {
        "completed": len(completions),
        "generated_tokens": total_toks,
        "tokens_per_s": round(total_toks / max(span, 1e-9), 1),
        "ttft_p50_ms": round(1e3 * _percentile(
            [c.ttft for c in done], 50), 2) if done else None,
        "latency_p50_ms": round(1e3 * _percentile(
            [c.latency for c in completions], 50), 2),
        "latency_p99_ms": round(1e3 * _percentile(
            [c.latency for c in completions], 99), 2),
        "steady_chunk_ms": (round(1e3 * float(np.median(steady_chunk_s)), 3)
                            if steady_chunk_s else None),
        "compile": {k: round(v, 3) for k, v in compile_stats.items()},
    }


def _total_len(cfg, args):
    # prefix embeds occupy cache positions ahead of the prompt (vlm)
    return args.prompt_len + args.gen_tokens + (cfg.num_prefix_embeds or 0)


def _run_engine(bundle, params, args, ctx: dict):
    eng = ServeEngine(
        bundle, params, slots=args.slots,
        max_seq_len=_total_len(bundle.cfg, args),
        decode_chunk=args.decode_chunk, temperature=args.temperature,
        eos_id=args.eos_id, seed=args.seed,
        admission="gang" if args.mode == "static" else "continuous")
    compile_stats = eng.warmup(args.prompt_len)
    reqs = _synthetic_requests(bundle.cfg, args, eng.device)
    completions = eng.run(reqs)
    ctx.update(engine=eng, requests=reqs, completions=completions)
    out = _summarize(completions, eng.chunk_times[1:], compile_stats)
    out["steady_prefill_ms"] = round(
        1e3 * float(np.median(eng.prefill_times)), 3)
    first = min(completions, key=lambda c: c.req_id)
    out["generated_first_req"] = first.tokens
    if args.parity_check:
        out["parity"] = _parity(bundle, params, reqs, completions, args)
    return out


def _parity(bundle, params, reqs, completions, args):
    got = {c.req_id: c.tokens for c in completions}
    device = params["embed"].device
    for r in reqs:
        ref = sequential_decode(
            bundle, params, request_batch(r, device, bundle.dtype), r.req_id,
            r.max_new_tokens, temperature=args.temperature,
            eos_id=args.eos_id, base_key=prng.key(args.seed),
            max_seq_len=_total_len(bundle.cfg, args))
        if got.get(r.req_id) != ref:
            return f"mismatch req {r.req_id}: {got.get(r.req_id)} != {ref}"
    return "ok"


def _run_oneshot(bundle, params, args, ctx: dict):
    """One fixed uniform batch through the chunk loop (with an enc-dec's
    frames and a VLM's prefix embeds); first-call and steady-state
    prefill timed apart."""
    cfg = bundle.cfg
    device = params["embed"].device
    B = args.slots
    key = prng.key(args.seed + 1)
    batch = {"tokens": prng.randint(key, (B, args.prompt_len), 0,
                                    cfg.vocab_size).to(device)}
    if cfg.family == "audio":
        batch["frames"] = synthetic_normal(
            prng.fold_in(key, 1), (B, args.prompt_len, cfg.d_model),
            bundle.dtype, device)
    if cfg.num_prefix_embeds:
        batch["prefix_embeds"] = synthetic_normal(
            prng.fold_in(key, 2), (B, cfg.num_prefix_embeds, cfg.d_model),
            bundle.dtype, device)
    # the ranges name the prefills and chunks in a torch.profiler trace, as
    # the engine's do
    t0 = time.perf_counter()
    with torch.profiler.record_function("serve_prefill"):
        bundle.prefill_fn(params, batch)
        _sync(device)
    prefill_compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.profiler.record_function("serve_prefill"):
        out = bundle.prefill_fn(params, batch)
        _sync(device)
    prefill_s = time.perf_counter() - t0

    loop = make_decode_loop(bundle, chunk=args.decode_chunk,
                            temperature=args.temperature, eos_id=args.eos_id)
    state = init_loop_state(out["cache"], B, pad_vocab(cfg.vocab_size),
                            prng.key(args.seed))
    state.update(
        logits=out["logits"].float(),
        pos=torch.full((B,), args.prompt_len, dtype=torch.int32,
                       device=device),
        req_id=torch.arange(B, dtype=torch.int32, device=device),
        active=torch.ones((B,), dtype=torch.bool, device=device),
        remaining=torch.full((B,), args.gen_tokens, dtype=torch.int32,
                             device=device))
    toks_rows = [[] for _ in range(B)]
    chunk_times = []
    n_chunks = -(-args.gen_tokens // args.decode_chunk)
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        with torch.profiler.record_function("serve_chunk"):
            state, toks, emitted = loop(params, state)
            toks, emitted = toks.cpu().numpy(), emitted.cpu().numpy()
        chunk_times.append(time.perf_counter() - t0)
        for b in range(B):
            toks_rows[b].extend(toks[emitted[:, b], b].tolist())
    steady = chunk_times[1:] or chunk_times
    total = sum(len(r) for r in toks_rows)
    steady_tokens = total - min(args.decode_chunk * B, total)
    result = {
        "completed": B,
        "generated_tokens": total,
        "tokens_per_s": round(steady_tokens / max(sum(steady), 1e-9), 1)
        if len(chunk_times) > 1
        else round(total / max(sum(chunk_times), 1e-9), 1),
        "steady_chunk_ms": round(1e3 * float(np.median(steady)), 3),
        "steady_prefill_ms": round(1e3 * prefill_s, 3),
        "compile": {"prefill_compile_s": round(prefill_compile_s, 3),
                    "chunk_compile_s": round(chunk_times[0], 3)},
        "generated_first_req": toks_rows[0],
    }
    ctx.update(batch=batch, rows=toks_rows)
    if args.parity_check:
        ok = "ok"
        for b in range(B):
            ref = sequential_decode(
                bundle, params, {k: v[b:b + 1] for k, v in batch.items()},
                b, args.gen_tokens, temperature=args.temperature,
                eos_id=args.eos_id, base_key=prng.key(args.seed))
            if ref != toks_rows[b]:
                ok = f"mismatch row {b}: {toks_rows[b]} != {ref}"
                break
        result["parity"] = ok
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="stablelm-3b-smoke")
    p.add_argument("--slots", type=int, default=4,
                   help="decode-batch capacity (requests in flight)")
    p.add_argument("--requests", type=int, default=None,
                   help="total requests to serve (default: slots)")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen-tokens", type=int, default=16)
    p.add_argument("--decode-chunk", type=int, default=8,
                   help="tokens decoded per host round trip")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--eos-id", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mode", default="auto",
                   choices=["auto", "continuous", "static", "oneshot"])
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="open-loop Poisson arrivals per second (0: all at "
                        "t0)")
    p.add_argument("--parity-check", action="store_true",
                   help="re-decode every request sequentially and compare")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda)")
    return p


def run_serving(args, init_params=None, cfg=None) -> dict:
    """Serve ``args``' synthetic requests; returns ``{"result": the JSON
    summary, "bundle", "params"}`` and, in continuous/static mode, the
    ``"engine"``, its ``"requests"`` and ``"completions"``; in oneshot
    mode the ``"batch"`` and each row's tokens, ``"rows"``.
    ``init_params`` (a parameter tree) replaces the random init from a
    ``torch.Generator`` seeded with ``--seed``; ``cfg`` overrides
    ``--arch`` (e.g. a depth-cut config object), as in `run_training`."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available "
                           "(pass --device cpu to serve on the CPU)")
    cfg = cfg if cfg is not None else get_config(args.arch)
    if args.mode == "auto":
        args.mode = "oneshot" if cfg.family == "audio" else "continuous"
    if args.requests is None:
        args.requests = args.slots
    bundle = build_model(cfg)
    if init_params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.seed)
        params = bundle.init(gen, device)
    else:
        params = _to_device(init_params, device)
    ctx = {"bundle": bundle, "params": params}
    with torch.no_grad():
        if args.mode == "oneshot":
            result = _run_oneshot(bundle, params, args, ctx)
        else:
            result = _run_engine(bundle, params, args, ctx)
    ctx["result"] = dict({"arch": cfg.name, "mode": args.mode,
                          "slots": args.slots, "requests": args.requests,
                          "device": str(device)}, **result)
    return ctx


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def main(argv=None) -> int:
    result = run_serving(build_parser().parse_args(argv))["result"]
    print(json.dumps(result))
    return 0 if result.get("parity", "ok") == "ok" else 1


if __name__ == "__main__":
    raise SystemExit(main())
