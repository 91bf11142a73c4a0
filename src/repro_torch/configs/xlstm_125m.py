"""xlstm-125m [arXiv:2405.04517]: 12 blocks d_model=768 4H, alternating
mLSTM (matrix memory) / sLSTM (scalar memory) blocks; d_ff=0 (blocks carry
their own projections)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="xlstm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=192,
    slstm_every=2,
    source="arXiv:2405.04517",
)
