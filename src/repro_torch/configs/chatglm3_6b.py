"""chatglm3-6b [arXiv:2406.12793]: dense decoder, 28L d_model=4096 32H
(GQA kv=2) d_ff=13696 vocab=65024, 2D/half RoPE (rotary_frac=0.5)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    rotary_frac=0.5, tie_embeddings=False,
    source="arXiv:2406.12793",
)
