"""seamless-m4t-medium [arXiv:2308.11596]: enc-dec audio backbone,
12L(enc)+12L(dec) d_model=1024 16H kv=16 d_ff=4096 vocab=256206.
The frontend (mel spectrogram + conv feature extractor) is a stub: the
caller provides frame embeddings (``batch["frames"]``)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, num_encoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    norm="layernorm", mlp="gelu", cross_attn_window=None,
    source="arXiv:2308.11596",
)
