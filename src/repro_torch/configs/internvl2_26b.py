# Copied from src/repro/configs/internvl2_26b.py; only the imports may differ.
"""InternVL2-26B — InternViT-6B (STUB frontend: precomputed patch
embeddings, hidden 3200) + InternLM2-20B language trunk.
[arXiv:2404.16821; hf]"""
from .base import ModelConfig, register

INTERNVL2_26B = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    vision_embed_dim=3200,
    num_image_tokens=256,
    rope_theta=1_000_000.0,
))
