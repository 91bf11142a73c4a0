"""llava-next-34b [hf:llava-hf/llava-v1.6 family]: VLM.  The vision tower
and anyres tiling are a stub frontend (the caller provides patch
embeddings, ``batch["prefix_embeds"]``); the 60L d_model=7168 56H (GQA
kv=8) d_ff=20480 vocab=64000 language decoder is real.  2304 image tokens
(anyres 4+1 tiles + base)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    num_prefix_embeds=2304, rope_theta=5_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (scaled per assignment)",
)
