"""olmoe-1b-7b [arXiv:2409.02060]: MoE, 16L d_model=2048 16H kv=16
d_ff=1024(per-expert) vocab=50304, 64 experts top-8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    num_experts=64, num_experts_per_tok=8,
    source="arXiv:2409.02060",
)
