"""Continuous-batching serving of the consensus model (counterpart of
``repro.serve``).

`engine.ServeEngine`: slot-based admission over a device-resident chunk
decode loop (`loop`) and a slot-paged cache slab (`cache`).  The CLI is
`repro_torch.launch.serve`.
"""
from .cache import SlotCacheLayout, make_layout, read_slot, write_slot
from .engine import Completion, Request, ServeEngine, request_batch
from .loop import (SAMPLE_DOMAIN, init_loop_state, make_decode_loop,
                   sample_token, sampling_key, sequential_decode)

__all__ = ["ServeEngine", "Request", "Completion", "request_batch",
           "SlotCacheLayout",
           "make_layout", "write_slot", "read_slot", "make_decode_loop",
           "init_loop_state", "sequential_decode", "sampling_key",
           "sample_token", "SAMPLE_DOMAIN"]
