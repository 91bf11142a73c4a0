"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]: MoE,
24L d_model=1024 16H (GQA kv=8) d_ff=512(per-expert) vocab=49155,
32 experts top-8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=32, num_experts_per_tok=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
