"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b family]: dense decoder,
32L d_model=2560 32H (MHA: kv=32) d_ff=6912 vocab=50304, partial rotary."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304, head_dim=80,
    rotary_frac=0.25, norm="layernorm", mlp="swiglu", tie_embeddings=False,
    source="hf:stabilityai/stablelm-2-1_6b",
)
