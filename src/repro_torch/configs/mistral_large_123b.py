# Copied from src/repro/configs/mistral_large_123b.py; only the imports may differ.
"""Mistral Large 2 (123B dense).
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from .base import ModelConfig, register

MISTRAL_LARGE_123B = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
))
