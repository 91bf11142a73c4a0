"""zamba2-7b [arXiv:2411.15242]: Mamba2 trunk + 2 alternating shared GQA
attention blocks every 6 layers; 81L d_model=3584 32H kv=32 d_ff=14336
vocab=32000 ssm_state=64."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    hybrid_attn_every=6, hybrid_num_shared=2,
    source="arXiv:2411.15242",
)
