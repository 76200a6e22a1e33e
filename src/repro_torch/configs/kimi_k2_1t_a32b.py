# Copied from src/repro/configs/kimi_k2_1t_a32b.py; only the imports may differ.
"""Kimi K2 — trillion-parameter MoE, 384 experts top-8, 2048-wide experts.
Paper-table config; head_dim set to the hardware-aligned 128 (the released
model uses MLA with 192-dim heads; the assigned spec simplifies to GQA kv=8).
[arXiv:2501.kimi2; unverified]"""
from .base import ModelConfig, register

KIMI_K2_1T = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    moe_d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    num_experts_per_tok=8,
    rope_theta=50_000.0,
))
