# Copied from src/repro/configs/qwen2_1_5b.py; only the imports may differ.
"""Qwen2 1.5B — GQA kv=2, QKV bias. [arXiv:2407.10671; hf]"""
from .base import ModelConfig, register

QWEN2_1_5B = register(ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
))
