# Copied from src/repro/configs/jamba_v01_52b.py; only the imports may differ.
"""Jamba v0.1 52B — Mamba + attention 1:7 interleave, MoE 16e top-2 every
second layer (superblocks of 8 with attention at index 4).
[arXiv:2403.19887; hf]"""
from .base import ModelConfig, register

JAMBA_V01_52B = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    ssm_type="mamba",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    moe_layer_period=2,      # MoE every 2nd layer
    attn_every=8,            # one attention layer per 8-layer superblock
    attn_index=4,
    rope_theta=0.0,          # Jamba uses no positional encoding
))
