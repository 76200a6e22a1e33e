# Copied from src/repro/configs/mixtral_8x22b.py; only the imports may differ.
"""Mixtral 8x22B — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from .base import ModelConfig, register

MIXTRAL_8X22B = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    moe_d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    num_experts_per_tok=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
))
