# Copied from src/repro/configs/qwen3_8b.py; only the imports may differ.
"""Qwen3 8B — qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig, register

QWEN3_8B = register(ModelConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
))
