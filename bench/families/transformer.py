"""The decoder-only transformer (Mixtral, Mistral-Large): attention and a
dense or sparse-expert feed-forward in every layer, rotary positions.

Configuration files carry Hugging Face's keys.  The weights are the port's
layer-stacked tree (``init`` of ``repro_torch.models``): ``[L, ...]``
leaves under ``blocks``, linear weights ``[d_in, d_out]`` applied as
``x @ w``, the MoE router in fp32.  Distributions: embedding 0.02 N(0, 1);
linears and experts N(0, 1/fan_in) (the port's He-normal); norm scales
1 + 0.1 N(0, 1), so that the comparison sees each norm's weight applied.
The reference is ``bench/reference/model.py``, the counts
``bench/counts/step.py``."""
from __future__ import annotations

from bench.counts.step import chunk_flops, decode_flops
from bench.reference import forward_logits

__all__ = ["port_fields", "sizes_of", "leaf_specs", "forward_logits",
           "chunk_flops", "decode_flops", "attention_layers"]

#: the configuration file's keys (Hugging Face's names) and the port's
#: ``ModelConfig`` fields they set
PORT_FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
               "num_attention_heads": "num_heads",
               "num_key_value_heads": "num_kv_heads",
               "head_dim": "head_dim", "num_hidden_layers": "num_layers",
               "vocab_size": "vocab_size", "rope_theta": "rope_theta",
               "rms_norm_eps": "norm_eps",
               "sliding_window": "sliding_window",
               "num_local_experts": "num_experts",
               "num_experts_per_tok": "num_experts_per_tok",
               "tie_word_embeddings": "tie_embeddings",
               "torch_dtype": "dtype"}


def port_fields(config: dict) -> dict:
    if config.get("tie_word_embeddings"):
        raise ValueError("the reference has an untied output head")
    kw = {f: config[k] for k, f in PORT_FIELDS.items() if k in config}
    if config.get("num_local_experts"):
        kw["moe_d_ff"] = config["intermediate_size"]
    return kw


def sizes_of(config: dict) -> dict:
    return {"d_model": config["hidden_size"],
            "d_ff": config["intermediate_size"],
            "num_heads": config["num_attention_heads"],
            "num_kv_heads": config["num_key_value_heads"],
            "head_dim": config["head_dim"],
            "num_layers": config["num_hidden_layers"],
            "vocab_size": config["vocab_size"],
            "rope_theta": float(config["rope_theta"]),
            "norm_eps": float(config["rms_norm_eps"]),
            "sliding_window": config.get("sliding_window"),
            "num_experts": config.get("num_local_experts", 0),
            "top_k": config.get("num_experts_per_tok", 0),
            "dtype": config["torch_dtype"]}


def leaf_specs(s: dict) -> list:
    d, L, v = s["d_model"], s["num_layers"], s["vocab_size"]
    h, hkv, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    f, e = s["d_ff"], s["num_experts"]
    specs = [(("embed", "table"), (v, d), None, 0.0, 0.02),
             (("blocks", "ln1", "scale"), (L, d), None, 1.0, 0.1),
             (("blocks", "attn", "wq", "w"), (L, d, h * hd), None, 0.0,
              d ** -0.5),
             (("blocks", "attn", "wk", "w"), (L, d, hkv * hd), None, 0.0,
              d ** -0.5),
             (("blocks", "attn", "wv", "w"), (L, d, hkv * hd), None, 0.0,
              d ** -0.5),
             (("blocks", "attn", "wo", "w"), (L, h * hd, d), None, 0.0,
              (h * hd) ** -0.5),
             (("blocks", "ln2", "scale"), (L, d), None, 1.0, 0.1)]
    if e:
        specs += [(("blocks", "moe", "router", "w"), (L, d, e), "float32",
                   0.0, d ** -0.5),
                  (("blocks", "moe", "w_gate"), (L, e, d, f), None, 0.0,
                   d ** -0.5),
                  (("blocks", "moe", "w_up"), (L, e, d, f), None, 0.0,
                   d ** -0.5),
                  (("blocks", "moe", "w_down"), (L, e, f, d), None, 0.0,
                   f ** -0.5)]
    else:
        specs += [(("blocks", "mlp", "gate", "w"), (L, d, f), None, 0.0,
                   d ** -0.5),
                  (("blocks", "mlp", "up", "w"), (L, d, f), None, 0.0,
                   d ** -0.5),
                  (("blocks", "mlp", "down", "w"), (L, f, d), None, 0.0,
                   f ** -0.5)]
    specs += [(("ln_f", "scale"), (d,), None, 1.0, 0.1),
              (("lm_head", "w"), (d, v), None, 0.0, d ** -0.5)]
    return specs


def attention_layers(s: dict) -> int:
    return s["num_layers"]
