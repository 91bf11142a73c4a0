"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407]: dense decoder,
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, 128k context;
32 x 128 = 4096 query channels against d_model 5120.  ``full_kv``: with
an ``attn_window`` set, decode still caches every position (no ring of
the window); without one it changes nothing."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    rope_theta=1_000_000.0, long_context_mode="full_kv",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
