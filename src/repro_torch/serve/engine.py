"""Slot-based continuous-batching serve engine (counterpart of
``repro.serve.engine``).

A fixed decode batch of ``slots`` rows runs the device-resident chunk
loop (`serve.loop`); finished or empty slots are re-filled by prefilling
the next queued request (B=1, exact prompt length) and paging its cache
into that slot of the slab in place (`serve.cache.write_slot`) while the
other slots keep their state: admission never drains or reshapes the live
batch.

``admission="gang"`` is the run-to-completion static-batching baseline:
requests are admitted only when EVERY slot is free.

A VLM request carries its image tokens as ``prefix_embeds`` (P, d); they
go into its prefill batch, and the slot's position is the prefill's
``pos`` (a prompt shorter than P still fills P positions).  The enc-dec
(audio) family is refused, as the reference's engine refuses it: its
cross-attention cache is encoder-length-shaped per request.

The reference's model-parallel placement (``mesh``/``rules``) waits for
the port's distributed layer and is refused.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from ..core import prng
from ..models.common import pad_vocab
from . import cache as slot_cache
from .loop import init_loop_state, make_decode_loop

__all__ = ["Request", "Completion", "ServeEngine", "request_batch"]


@dataclasses.dataclass
class Request:
    req_id: int
    tokens: np.ndarray            # (Lp,) int32 prompt token ids
    max_new_tokens: int
    arrival_time: float = 0.0     # offset from run() start (open loop)
    prefix_embeds: torch.Tensor | None = None  # (P, d) image tokens (vlm)


def request_batch(req: Request, device, dtype: torch.dtype) -> dict:
    """The B=1 prefill batch of ``req``: its tokens and, for a VLM request,
    its prefix embeds in the model's dtype."""
    batch = {"tokens": torch.as_tensor(
        np.asarray(req.tokens, np.int32))[None].to(device)}
    if req.prefix_embeds is not None:
        batch["prefix_embeds"] = req.prefix_embeds.to(device, dtype)[None]
    return batch


@dataclasses.dataclass
class Completion:
    req_id: int
    prompt_len: int
    tokens: list[int]
    arrival_time: float
    admitted_at: float            # prefill finished, slot occupied
    first_token_at: float | None  # first generated token visible on host
    finished_at: float

    @property
    def ttft(self) -> float | None:
        return (None if self.first_token_at is None
                else self.first_token_at - self.arrival_time)

    @property
    def latency(self) -> float:
        return self.finished_at - self.arrival_time


@dataclasses.dataclass
class _SlotMeta:
    """Host mirror of one occupied slot."""
    req: Request
    admitted_at: float
    first_token_at: float | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    def __init__(self, bundle, params, *, slots: int, max_seq_len: int,
                 decode_chunk: int = 8, temperature: float = 0.0,
                 eos_id: int | None = None, seed: int = 0,
                 admission: str = "continuous", mesh=None, rules=None):
        if bundle.cfg.family == "audio":
            raise NotImplementedError(
                "enc-dec serving: the cross-attention cache is encoder-"
                "length-shaped per request and cannot be paged into a "
                "fixed slab; use the oneshot path in launch.serve")
        if admission not in ("continuous", "gang"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "model-parallel serving (mesh/rules) is not ported yet")
        self.bundle = bundle
        self.params = params
        self.device = params["embed"].device
        self.slots = slots
        self.max_seq_len = max_seq_len
        self.decode_chunk = decode_chunk
        self.admission = admission
        self.layout = slot_cache.make_layout(bundle, slots, max_seq_len)
        self._vocab = pad_vocab(bundle.cfg.vocab_size)
        self._seed = seed
        self._state = init_loop_state(self.layout.init(self.device), slots,
                                      self._vocab, prng.key(seed))
        self._prefill = bundle.prefill_fn
        self._loop = make_decode_loop(bundle, chunk=decode_chunk,
                                      temperature=temperature, eos_id=eos_id)
        self._queue: collections.deque[Request] = collections.deque()
        self._slot_meta: list[_SlotMeta | None] = [None] * slots
        self.completions: list[Completion] = []
        # wall-clock samples: the first call's (kernel build and load,
        # library handles) apart from the steady state
        self.prefill_times: list[float] = []
        self.chunk_times: list[float] = []

    # -- admission ---------------------------------------------------------

    def _admit_state(self, slot: int, page: dict, logits_row: torch.Tensor,
                     pos: int, req_id: int, max_new: int) -> None:
        st = self._state
        slot_cache.write_slot(self.layout, st["cache"], page, slot)
        st["logits"][slot] = logits_row.float()
        st["pos"][slot] = pos
        st["req_id"][slot] = req_id
        st["active"][slot] = True
        st["remaining"][slot] = max_new

    def submit(self, req: Request):
        if len(req.tokens) > self.max_seq_len:
            raise ValueError(f"request {req.req_id}: prompt length "
                             f"{len(req.tokens)} > max_seq_len "
                             f"{self.max_seq_len}")
        self._queue.append(req)

    def _free_slots(self) -> list[int]:
        return [i for i, m in enumerate(self._slot_meta) if m is None]

    def _admit_one(self, req: Request, slot: int, now: float):
        batch = request_batch(req, self.device, self.bundle.dtype)
        t0 = time.perf_counter()
        # the range names the prefill in a torch.profiler trace
        with torch.profiler.record_function("serve_prefill"):
            out = self._prefill(self.params, batch)
            _sync(self.device)
        self.prefill_times.append(time.perf_counter() - t0)
        # the slot's position is the prefill's: prefix embeds (vlm) can
        # reach past the prompt
        self._admit_state(slot, out["cache"], out["logits"][0],
                          int(out["pos"]), req.req_id, req.max_new_tokens)
        self._slot_meta[slot] = _SlotMeta(req=req, admitted_at=now)

    def _try_admit(self, now: float):
        free = self._free_slots()
        if self.admission == "gang" and len(free) < self.slots:
            return
        for slot in free:
            if not self._queue or self._queue[0].arrival_time > now:
                break
            self._admit_one(self._queue.popleft(), slot, now)

    # -- decode + harvest --------------------------------------------------

    def _run_chunk(self, now_fn):
        t0 = time.perf_counter()
        with torch.profiler.record_function("serve_chunk"):
            self._state, toks, emitted = self._loop(self.params, self._state)
            # the one host sync: tokens, emitted and active flags together
            block = torch.cat([toks, emitted.to(torch.int32),
                               self._state["active"].to(torch.int32)[None]])
            block = block.cpu().numpy()
        self.chunk_times.append(time.perf_counter() - t0)
        K = toks.shape[0]
        toks, emitted, active = block[:K], block[K:2 * K] != 0, block[-1]
        now = now_fn()
        for s, meta in enumerate(self._slot_meta):
            if meta is None:
                continue
            new = toks[emitted[:, s], s].tolist()
            if new and meta.first_token_at is None:
                meta.first_token_at = now
            meta.tokens.extend(new)
            if not active[s]:
                req = meta.req
                self.completions.append(Completion(
                    req_id=req.req_id, prompt_len=len(req.tokens),
                    tokens=meta.tokens, arrival_time=req.arrival_time,
                    admitted_at=meta.admitted_at,
                    first_token_at=meta.first_token_at, finished_at=now))
                self._slot_meta[s] = None

    def step(self, now_fn=None) -> bool:
        """Admit what fits, decode one chunk.  Returns False when idle
        (no live slot and nothing admissible)."""
        now_fn = now_fn or time.perf_counter
        self._try_admit(now_fn())
        if not any(m is not None for m in self._slot_meta):
            return False
        self._run_chunk(now_fn)
        return True

    def run(self, requests: list[Request] | None = None) -> list[Completion]:
        """Drive to completion.  ``arrival_time`` offsets are honoured
        against a clock starting at this call (open-loop arrivals)."""
        if requests:
            for r in sorted(requests, key=lambda r: r.arrival_time):
                self.submit(r)
        t_start = time.perf_counter()
        now_fn = lambda: time.perf_counter() - t_start  # noqa: E731
        while self._queue or any(m is not None for m in self._slot_meta):
            if not self.step(now_fn):
                # idle with a non-empty queue: the next arrival is ahead
                wait = self._queue[0].arrival_time - now_fn()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        return self.completions

    # -- warmup / reset ----------------------------------------------------

    def warmup(self, prompt_len: int, max_new: int | None = None):
        """Run the prefill/admit/chunk path on a throwaway request and
        reset, so that `prefill_times`/`chunk_times` sample the steady
        state only.  Returns the first calls' times."""
        req = Request(req_id=-1, tokens=np.zeros((prompt_len,), np.int32),
                      max_new_tokens=max_new or self.decode_chunk)
        self.submit(req)
        while self.step():
            pass
        compile_stats = {
            "prefill_compile_s": self.prefill_times[0],
            "chunk_compile_s": self.chunk_times[0],
        }
        self.reset()
        return compile_stats

    def reset(self):
        """Free every slot and clear host-side records: the slab is zeroed
        in place, the loop state and timing samples start afresh."""
        cache = self._state["cache"]
        for leaf in cache.values():
            leaf.zero_()
        self._state = init_loop_state(cache, self.slots, self._vocab,
                                      prng.key(self._seed))
        self._queue.clear()
        self._slot_meta = [None] * self.slots
        self.completions = []
        self.prefill_times = []
        self.chunk_times = []
