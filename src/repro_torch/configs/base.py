"""Architecture configuration (counterpart of ``repro.configs.base``; the
fields the dense, MoE, xLSTM, hybrid, enc-dec and VLM families use).
Field names and the ``-smoke``/``-tiny`` reductions equal the
reference's, so a config resolves to the same shapes in both packages."""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "reduced_variant",
           "tiny_variant"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "xlstm", "hybrid", "encdec", "vlm",
                    "audio"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    rotary_frac: float = 1.0
    rope_theta: float = 10000.0
    attn_window: int | None = None
    # how a windowed model caches for decode: "window" keeps a ring of
    # attn_window positions, "full_kv" every position
    long_context_mode: Literal["window", "full_kv"] = "window"
    # training attention: "naive" materializes the scores, "chunked" is the
    # blocked online-softmax form over attn_chunk-wide query and key blocks
    attn_impl: Literal["naive", "chunked"] = "naive"
    attn_chunk: int = 4096
    # per-layer recompute in training: "full" keeps only each layer's
    # input for the backward, "save_collectives" also the attention's
    # output projection (the dense, MoE and VLM layers; the other
    # families recompute fully under either, as the reference's); the
    # reference's lax.scan traversal changes its compile time, not values
    remat_policy: Literal["full", "save_collectives"] = "full"
    scan_layers: bool = False
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    mlp: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = True
    # MoE: num_experts_per_tok of num_experts routed a token, each expert
    # holding capacity_factor x its even share of a sequence's tokens;
    # "deferred" (a combine on the tensor-parallel partials) needs a mesh
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    moe_impl: Literal["allreduce", "deferred"] = "allreduce"
    # enc-dec (audio): encoder depth, and a local monotonic window of
    # encoder frames for each decoder position's cross-attention
    num_encoder_layers: int = 0
    cross_attn_window: int | None = None
    # modality embeddings (a VLM's image tokens) replacing the first
    # positions of the prompt; 0 for the text-only families
    num_prefix_embeds: int = 0
    # Mamba2 (hybrid): state N, conv taps, inner width factor, head dim
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # hybrid: a shared attention block after every hybrid_attn_every-th
    # mamba layer, alternating over hybrid_num_shared weight sets
    hybrid_attn_every: int = 6
    hybrid_num_shared: int = 2
    # xLSTM: every slstm_every-th block (blocks 1, 3, ... for 2) is sLSTM
    slstm_every: int = 2
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One workload's input: ``global_batch`` sequences of ``seq_len``
    tokens, for training, a prefill or decoding."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced_variant(cfg: ArchConfig) -> ArchConfig:
    """``-smoke``: 2 layers (and <= 2 encoder layers), d_model <= 256,
    head_dim 32, vocab <= 1024, <= 4 experts with top <= 2, ssm_state <= 16
    with ssm_head_dim 32, a shared attention block every 2 layers, <= 16
    prefix embeds, float32 (the reference's CPU smoke reduction)."""
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    heads = max(2, min(cfg.num_heads, d_model // head_dim))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", num_layers=2, d_model=d_model,
        num_heads=heads, num_kv_heads=kv, head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512), vocab_size=min(cfg.vocab_size, 1024),
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        hybrid_attn_every=2,
        num_prefix_embeds=min(cfg.num_prefix_embeds, 16), dtype="float32")


def tiny_variant(cfg: ArchConfig) -> ArchConfig:
    """``-tiny``: 1 layer (and 1 encoder layer for an enc-dec), d_model 32,
    head_dim 16, vocab <= 64, 2 experts with top 1 (a MoE config),
    ssm_state <= 8 with ssm_head_dim 16, a shared attention block after
    every layer, <= 4 prefix embeds."""
    base = reduced_variant(cfg)
    d_model, head_dim = 32, 16
    heads = max(2, d_model // head_dim)
    kv = max(1, min(base.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return dataclasses.replace(
        base, name=cfg.name + "-tiny", num_layers=1, d_model=d_model,
        num_heads=heads, num_kv_heads=kv, head_dim=head_dim,
        d_ff=min(base.d_ff, 64), vocab_size=min(base.vocab_size, 64),
        num_experts=min(base.num_experts, 2),
        num_experts_per_tok=1 if base.num_experts_per_tok else 0,
        ssm_state=min(base.ssm_state, 8),
        ssm_head_dim=16 if base.ssm_state else base.ssm_head_dim,
        num_encoder_layers=min(base.num_encoder_layers, 1),
        hybrid_attn_every=1,
        num_prefix_embeds=min(base.num_prefix_embeds, 4))
