"""Build and load the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for ``sm_90a``
into ``build/kernels/lib<name>-<hash>.so`` (the hash is of the source and
the shared headers ``csrc/*.cuh``, so an edited source never loads a stale
library) and loaded with ctypes; the sources expose plain C functions, so
no PyTorch header is compiled and a build takes seconds.  `build_all` starts one ``nvcc`` per source in
parallel.  Set ``REPRO_TORCH_BUILD_DIR`` to build elsewhere.

Every kernel wrapper counts its launches in `launch_counts` (one per call
that launches its kernel, nowhere else; a strided call of B1, B2, B4 or
B6 whose columns do not start and end on a vector boundary launches it
twice, the body and a one-block edge), so a run can show which kernels
its path went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "build_all", "library", "launch_counts", "dtype_code",
           "reset_launch_counts", "check_status", "stream_ptr", "build_dir",
           "to_device"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("obfuscate", "gossip", "ring", "flash_attention", "ssm_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name of the wrapper -> launches of its kernel since the last reset
launch_counts: collections.Counter = collections.Counter()

_loaded: dict[str, ctypes.CDLL] = {}
_VOIDP, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FLOAT = ctypes.c_float
_SIGNATURES = {
    "obfuscate": {
        "obfuscate_update": [_INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                             _LL, _LL, _LL, _VOIDP],
        "obfuscate_update_krng": [_INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT,
                                  _LL, _LL, _VOIDP, _VOIDP, _VOIDP, _INT,
                                  _VOIDP],
    },
    "gossip": {
        "gossip_update": [_INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT,
                          _LL, _LL, _VOIDP],
        "masked_gossip_update": [_INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                                 _VOIDP, _INT, _LL, _LL, _VOIDP],
        "masked_gossip_update_krng": [_INT, _VOIDP, _FLOAT, _VOIDP,
                                      _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                                      _INT, _LL, _VOIDP],
        "guarded_gossip_update": [_INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                                  _VOIDP, _VOIDP, _VOIDP, _INT, _FLOAT,
                                  _FLOAT, _INT, _VOIDP, _INT, _LL, _LL,
                                  _VOIDP],
    },
    "ring": {
        "ring_gossip_update": [_INT, _VOIDP, _VOIDP, _VOIDP, _INT, _VOIDP,
                               _VOIDP, _VOIDP, _VOIDP, _INT, _LL, _VOIDP],
        "ring_obfuscate_gossip": [_INT, _VOIDP, _VOIDP, _VOIDP, _INT, _VOIDP,
                                  _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                                  _VOIDP, _INT, _LL, _VOIDP],
        "ring_obfuscate_gossip_krng": [_INT, _VOIDP, _VOIDP, _VOIDP, _INT,
                                       _VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT,
                                       _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                                       _INT, _LL, _VOIDP],
    },
    "flash_attention": {
        "flash_attention_fwd": [_INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _INT,
                                _INT, _INT, _INT, _INT, _INT, _VOIDP],
    },
    "ssm_scan": {
        "ssd_intra_chunk_fwd": [_INT, _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,
                                _VOIDP, _VOIDP, _LL, _INT, _INT, _INT, _INT,
                                _VOIDP],
    },
}


def reset_launch_counts() -> None:
    launch_counts.clear()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # every source may include any header: hash them all
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()
    return build_dir() / f"lib{name}-{digest[:12]}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Compile every source not yet built, one ``nvcc`` each, all at once.
    Returns ``{"seconds": wall time, "logs": {name: ptxas report}}``."""
    t0 = time.perf_counter()
    started = {name: _start_build(name) for name in SOURCES}
    logs = {name: _finish_build(name, s) for name, s in started.items()}
    return {"seconds": time.perf_counter() - t0, "logs": logs}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    _finish_build(name, _start_build(name))
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check_status(fn: str, status: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{fn}: CUDA error {status} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """Copy a small host tensor (key tables, offsets, B) to ``device``.  To
    a card it goes through pinned memory without blocking: a copy from
    pageable memory would wait for all the work queued on the stream."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
