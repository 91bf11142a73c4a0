"""PyTorch/CUDA port of the PDSGD reproduction in ``repro``.

It imports torch and numpy only — never jax, nothing of ``repro`` — and
mirrors ``repro``'s module names so each module's counterpart is easy to
find.  The hot path's kernels are hand-written CUDA for Hopper
(`kernels`); each has a plain PyTorch version that CPU tensors take.
"""
