# Copied from src/repro/configs/rwkv6_3b.py; only the imports may differ.
"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from .base import ModelConfig, register

RWKV6_3B = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    ssm_type="rwkv6",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # 2560 / head_size 64
    num_kv_heads=40,
    head_dim=64,
    rwkv_head_size=64,
    d_ff=8960,
    vocab_size=65536,
))
