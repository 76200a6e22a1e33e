# Copied from src/repro/configs/base.py; only the imports and the port-only block may differ.
"""Model configuration schema + registry for the assigned architectures."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["ModelConfig", "register", "get_config", "list_configs",
           "scale_down"]


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | vlm | encdec
    # trunk
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0            # 0 → d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1024
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0            # expert hidden size (0 → d_ff)
    moe_layer_period: int = 1    # every n-th layer is MoE (1 = all)
    capacity_factor: float = 1.25
    dispatch_policy: str = "priority"   # strategy scheduling | "arrival"
    dispatch_resteal: bool = True       # second-choice restealing
    #: dropless dispatch (capacity = T, nothing sheds).  Routing then
    #: depends only on each token's own router scores — the property that
    #: makes prefill+decode bit-consistent with the full forward (capacity
    #: competition is a whole-batch function, which a single decode step
    #: cannot see).  Set False to study capacity pressure / dead tasks
    #: (hillclimb + dryrun dispatch cells do).
    moe_dropless: bool = True
    router_aux_coef: float = 0.01
    # hybrid (attention : SSM interleave, Jamba-style superblocks)
    attn_every: int = 0          # within a superblock of this size, 1 attn
    attn_index: int = 0          # position of the attention layer in block
    # SSM
    ssm_type: str = ""           # "rwkv6" | "mamba"
    rwkv_head_size: int = 64
    rwkv_lora_rank: int = 32
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0       # 0 → ceil(d_model / 16)
    ssm_chunk: int = 64          # chunked-scan length (time axis)
    # encoder-decoder
    num_encoder_layers: int = 0  # >0 → enc-dec (decoder uses num_layers)
    # modality frontends (STUBS: inputs are precomputed embeddings)
    vision_embed_dim: int = 0    # >0 → VLM; projector vision→d_model
    num_image_tokens: int = 256
    audio_embed_dim: int = 0     # >0 → audio encoder input embeddings
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # runtime knobs
    remat: bool = True
    #: fully unroll every lax.scan (analysis compiles: exact cost_analysis)
    unroll_scans: bool = False
    #: chunk the vocab dim of the loss logsumexp (0 = off): cuts peak logits
    #: memory + HBM traffic for the 150k-vocab architectures
    loss_vocab_chunk: int = 0
    #: matmul-based (one-hot) embedding lookup: shards cleanly when the
    #: table is vocab-sharded (avoids XLA's gather replication fallback)
    onehot_embed: bool = False
    #: pin per-layer activations to batch-sharded layout (stops XLA SPMD
    #: from round-tripping activations through replicated layouts)
    activation_sharding: bool = False
    #: with activation_sharding on a MoE trunk: also shard the hidden dim
    #: over 'model' at layer boundaries (aligns with the EP dispatch)
    activation_sharding_moe_model: bool = False
    use_flash: bool = False      # Pallas flash-attention path (TPU target)
    norm_eps: float = 1e-5
    # -- port-only: fields the JAX package has not; each default is the
    # behaviour both packages share
    #: Mamba's RMSNorms over x_proj's three parts (Δ, B, C) before dt_proj,
    #: as Jamba's published mixer has them (``models/ssm.py``)
    mamba_inner_norm: bool = False
    #: renormalise the top-k router probabilities to sum to 1 (Mixtral's
    #: rule); False keeps them as the softmax over every expert gave them
    #: (Jamba's)
    moe_renormalize: bool = True
    # -- end port-only

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM, hybrid, or sliding-window attention."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from . import _load_all  # populate registry lazily
        _load_all()
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    from . import _load_all
    _load_all()
    return tuple(sorted(_REGISTRY))


def scale_down(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
               d_ff: int = 128, vocab: int = 512, experts: int = 0,
               heads: int = 0) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    nh = heads or max(2, min(cfg.num_heads, 4))
    nkv = max(1, min(cfg.num_kv_heads, nh))
    if nh % nkv:
        nkv = 1
    kw = dict(
        num_layers=layers, d_model=d_model, num_heads=nh, num_kv_heads=nkv,
        head_dim=d_model // nh, d_ff=d_ff, vocab_size=vocab,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window
        else None,
        remat=False,
    )
    if cfg.num_experts:
        kw["num_experts"] = experts or min(cfg.num_experts, 4)
        kw["num_experts_per_tok"] = min(cfg.num_experts_per_tok, 2)
        kw["moe_d_ff"] = d_ff
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = layers
    if cfg.vision_embed_dim:
        kw["vision_embed_dim"] = 48
        kw["num_image_tokens"] = 8
    if cfg.audio_embed_dim:
        kw["audio_embed_dim"] = d_model
    if cfg.ssm_type:
        kw["rwkv_head_size"] = d_model // nh
        kw["rwkv_lora_rank"] = 8
        kw["mamba_d_state"] = 8
        kw["ssm_chunk"] = 16
    if cfg.attn_every:
        kw["attn_every"] = min(cfg.attn_every, layers) or layers
        kw["attn_index"] = 0
        kw["num_layers"] = max(layers, kw["attn_every"])
    return cfg.replace(**kw)
