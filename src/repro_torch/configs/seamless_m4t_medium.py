# Copied from src/repro/configs/seamless_m4t_medium.py; only the imports may differ.
"""SeamlessM4T medium — encoder-decoder, multimodal; the speech frontend is
a STUB (inputs are precomputed frame embeddings). [arXiv:2308.11596; hf]"""
from .base import ModelConfig, register

SEAMLESS_M4T_MEDIUM = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,            # decoder
    num_encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    audio_embed_dim=1024,
))
