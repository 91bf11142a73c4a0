"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions.

Every wrapper takes CPU tensors to the plain version in `ref` and CUDA
tensors to its kernel (``csrc/*.cu``, built at first use by `build`).
"""
from . import ref
from .build import build_all, launch_counts, reset_launch_counts
from .flash_attention import flash_attention
from .gossip import (gossip_update, guarded_gossip_update,
                     masked_gossip_update, masked_gossip_update_krng,
                     ring_gossip_update, ring_obfuscate_gossip,
                     ring_obfuscate_gossip_krng)
from .obfuscate import obfuscate_update, obfuscate_update_krng
from .ssm_scan import ssd_intra_chunk
from .ops import (FlatLayout, fused_pdsgd_flat, fused_pdsgd_tree,
                  gossip_tree, leafwise_pdsgd_flat, obfuscate_tree,
                  ring_pdsgd_flat, ring_pdsgd_tree, sharded_pdsgd_tree)

__all__ = ["ref", "build_all", "launch_counts", "reset_launch_counts",
           "gossip_update", "masked_gossip_update",
           "masked_gossip_update_krng", "guarded_gossip_update",
           "ring_gossip_update", "ring_obfuscate_gossip",
           "ring_obfuscate_gossip_krng", "obfuscate_update",
           "obfuscate_update_krng", "FlatLayout", "fused_pdsgd_flat",
           "fused_pdsgd_tree", "ring_pdsgd_flat", "ring_pdsgd_tree",
           "obfuscate_tree", "gossip_tree", "leafwise_pdsgd_flat",
           "sharded_pdsgd_tree",
           "flash_attention", "ssd_intra_chunk"]
