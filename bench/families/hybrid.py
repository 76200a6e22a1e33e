"""The hybrid of attention, Mamba-1 and sparse experts (Jamba): periods of
``attn_layer_period`` layers, attention at ``attn_layer_offset`` and
Mamba-1 elsewhere; MoE where ``i % expert_layer_period ==
expert_layer_offset`` and a dense SwiGLU elsewhere; no positional
encoding.

Configuration files carry Hugging Face's keys (``JambaConfig``).  The
weights are the port's superblock tree (``init_hybrid_lm`` of
``repro_torch.models.hybrid``): ``superblocks/layers/<i>/...``, a list of
the ``attn_layer_period`` layers of a period, each leaf ``[n_sb, ...]``,
linear weights ``[d_in, d_out]`` applied as ``x @ w``, and the Mamba
mixer's three inner RMSNorm scales (``dt_norm``, ``b_norm``, ``c_norm``).
Distributions: embedding 0.02 N(0, 1); linears and experts N(0, 1/fan_in);
norm scales 1 + 0.1 N(0, 1); the Mamba mixer's own leaves as the
configuration file's ``assumed`` states them, so that Δ·A leaves part of
the state carrying information over hundreds of tokens.  The reference is
``bench/reference/hybrid.py``."""
from __future__ import annotations

from bench.reference.hybrid import forward_logits

__all__ = ["port_fields", "sizes_of", "leaf_specs", "forward_logits",
           "chunk_flops", "decode_flops", "attention_layers"]

#: the configuration file's keys (Hugging Face's names) and the port's
#: ``ModelConfig`` fields they set
PORT_FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
               "num_attention_heads": "num_heads",
               "num_key_value_heads": "num_kv_heads",
               "head_dim": "head_dim", "num_hidden_layers": "num_layers",
               "vocab_size": "vocab_size", "rms_norm_eps": "norm_eps",
               "sliding_window": "sliding_window",
               "num_experts": "num_experts",
               "num_experts_per_tok": "num_experts_per_tok",
               "tie_word_embeddings": "tie_embeddings",
               "attn_layer_period": "attn_every",
               "attn_layer_offset": "attn_index",
               "expert_layer_period": "moe_layer_period",
               "mamba_d_state": "mamba_d_state",
               "mamba_d_conv": "mamba_d_conv",
               "mamba_expand": "mamba_expand",
               "mamba_dt_rank": "mamba_dt_rank",
               "torch_dtype": "dtype"}

#: A_log's and the dt bias's distributions (mean, std): the mean and the
#: spread of log(1..16), and of log(dt) for dt log-uniform in [1e-3, 1e-1]
A_LOG = (1.92, 0.75)
DT_BIAS = (-4.6, 1.33)
#: the conv's taps and bias: PyTorch's Conv1d default, uniform in
#: ±1/sqrt(d_conv), whose std is 0.29 at d_conv 4
CONV_STD = 0.29


def port_fields(config: dict) -> dict:
    """The port places MoE at ``i % period == period - 1``, has an untied
    head, a conv bias and no bias on in_proj and out_proj, and SiLU: a file
    that says otherwise is refused."""
    checks = {
        "model_type": (config.get("model_type") == "jamba", "jamba"),
        "expert_layer_offset": (
            config["expert_layer_offset"]
            == config["expert_layer_period"] - 1,
            "expert_layer_period - 1"),
        "tie_word_embeddings": (not config.get("tie_word_embeddings"),
                                "false"),
        "mamba_conv_bias": (config.get("mamba_conv_bias") is True, "true"),
        "mamba_proj_bias": (config.get("mamba_proj_bias") is False,
                            "false"),
        "hidden_act": (config.get("hidden_act") == "silu", "silu"),
        "sliding_window": (config.get("sliding_window") is None, "null")}
    for key, (ok, want) in checks.items():
        if not ok:
            raise ValueError(f"the port's hybrid needs {key} = {want}; the "
                             f"file has {config.get(key)!r}")
    kw = {f: config[k] for k, f in PORT_FIELDS.items() if k in config}
    kw.update(moe_d_ff=config["intermediate_size"], rope_theta=0.0,
              mamba_inner_norm=True, moe_renormalize=False)
    return kw


def sizes_of(config: dict) -> dict:
    d = config["hidden_size"]
    return {"d_model": d,
            "d_ff": config["intermediate_size"],
            "num_heads": config["num_attention_heads"],
            "num_kv_heads": config["num_key_value_heads"],
            "head_dim": config["head_dim"],
            "num_layers": config["num_hidden_layers"],
            "vocab_size": config["vocab_size"],
            "norm_eps": float(config["rms_norm_eps"]),
            "num_experts": config["num_experts"],
            "top_k": config["num_experts_per_tok"],
            "period": config["attn_layer_period"],
            "attn_offset": config["attn_layer_offset"],
            "expert_period": config["expert_layer_period"],
            "expert_offset": config["expert_layer_offset"],
            "d_inner": config["mamba_expand"] * d,
            "d_state": config["mamba_d_state"],
            "d_conv": config["mamba_d_conv"],
            "dt_rank": config["mamba_dt_rank"],
            "dtype": config["torch_dtype"]}


def kind_of(s: dict, i: int) -> tuple:
    """Layer ``i``'s (mixer, feed-forward): ("attn" or "mamba", "moe" or
    "mlp")."""
    mixer = "attn" if i % s["period"] == s["attn_offset"] else "mamba"
    ffn = "moe" if i % s["expert_period"] == s["expert_offset"] else "mlp"
    return mixer, ffn


def leaf_specs(s: dict) -> list:
    d, v, L, p = s["d_model"], s["vocab_size"], s["num_layers"], s["period"]
    h, hkv, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
    f, e = s["d_ff"], s["num_experts"]
    di, ds, dc, dtr = s["d_inner"], s["d_state"], s["d_conv"], s["dt_rank"]
    if L % p:
        raise ValueError(f"{L} layers do not tile into periods of {p}")
    n = L // p
    specs = [(("embed", "table"), (v, d), None, 0.0, 0.02)]
    for i in range(p):
        pre = ("superblocks", "layers", i)
        mixer, ffn = kind_of(s, i)
        specs.append((pre + ("ln1", "scale"), (n, d), None, 1.0, 0.1))
        if mixer == "attn":
            specs += [(pre + ("attn", "wq", "w"), (n, d, h * hd), None, 0.0,
                       d ** -0.5),
                      (pre + ("attn", "wk", "w"), (n, d, hkv * hd), None,
                       0.0, d ** -0.5),
                      (pre + ("attn", "wv", "w"), (n, d, hkv * hd), None,
                       0.0, d ** -0.5),
                      (pre + ("attn", "wo", "w"), (n, h * hd, d), None, 0.0,
                       (h * hd) ** -0.5)]
        else:
            m = pre + ("mamba",)
            specs += [(m + ("in_proj", "w"), (n, d, 2 * di), None, 0.0,
                       d ** -0.5),
                      (m + ("conv_w",), (n, dc, di), None, 0.0, CONV_STD),
                      (m + ("conv_b",), (n, di), None, 0.0, CONV_STD),
                      (m + ("x_proj", "w"), (n, di, dtr + 2 * ds), None, 0.0,
                       di ** -0.5),
                      (m + ("dt_proj", "w"), (n, dtr, di), None, 0.0,
                       (3 * dtr) ** -0.5),
                      (m + ("dt_proj", "b"), (n, di), None) + DT_BIAS,
                      (m + ("a_log",), (n, di, ds), "float32") + A_LOG,
                      (m + ("d_skip",), (n, di), "float32", 1.0, 0.1),
                      (m + ("out_proj", "w"), (n, di, d), None, 0.0,
                       di ** -0.5),
                      (m + ("dt_norm", "scale"), (n, dtr), None, 1.0, 0.1),
                      (m + ("b_norm", "scale"), (n, ds), None, 1.0, 0.1),
                      (m + ("c_norm", "scale"), (n, ds), None, 1.0, 0.1)]
        specs.append((pre + ("ln2", "scale"), (n, d), None, 1.0, 0.1))
        if ffn == "moe":
            specs += [(pre + ("moe", "router", "w"), (n, d, e), "float32",
                       0.0, d ** -0.5),
                      (pre + ("moe", "w_gate"), (n, e, d, f), None, 0.0,
                       d ** -0.5),
                      (pre + ("moe", "w_up"), (n, e, d, f), None, 0.0,
                       d ** -0.5),
                      (pre + ("moe", "w_down"), (n, e, f, d), None, 0.0,
                       f ** -0.5)]
        else:
            specs += [(pre + ("mlp", "gate", "w"), (n, d, f), None, 0.0,
                       d ** -0.5),
                      (pre + ("mlp", "up", "w"), (n, d, f), None, 0.0,
                       d ** -0.5),
                      (pre + ("mlp", "down", "w"), (n, f, d), None, 0.0,
                       f ** -0.5)]
    specs += [(("ln_f", "scale"), (d,), None, 1.0, 0.1),
              (("lm_head", "w"), (d, v), None, 0.0, d ** -0.5)]
    return specs


def attention_layers(s: dict) -> int:
    return sum(kind_of(s, i)[0] == "attn" for i in range(s["num_layers"]))


def _mamba_flops(s: dict, n: int) -> int:
    """A Mamba layer over ``n`` tokens: its projections (in_proj, x_proj,
    dt_proj, out_proj), the depthwise conv, and the scan: 9 FLOPs a state
    element a token (the decay's product and exponent, Δ·x·B, the update's
    multiply and add, C's product and sum; Δ·x once a channel) and D's skip
    and the gate (3 a channel)."""
    d, di, ds, dc, dtr = (s["d_model"], s["d_inner"], s["d_state"],
                          s["d_conv"], s["dt_rank"])
    proj = d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * d
    return n * (2 * proj + 2 * dc * di + 9 * di * ds + 3 * di)


def _ffn_flops(s: dict, ffn: str) -> int:
    d, f = s["d_model"], s["d_ff"]
    if ffn == "moe":
        return 2 * (s["top_k"] * 3 * d * f + d * s["num_experts"])
    return 2 * 3 * d * f


def _attn_proj_flops(s: dict) -> int:
    d, h, hkv, hd = s["d_model"], s["num_heads"], s["num_kv_heads"], \
        s["head_dim"]
    return 2 * (d * (h + 2 * hkv) * hd + h * hd * d)


def chunk_flops(s: dict, start: int, n: int) -> int:
    """A prefill chunk of ``n`` tokens at positions start..start+n-1, the
    logits of its last row only: every layer's mixer and feed-forward, and
    attention's 4 * head_dim FLOPs a query head for each key it sees, in
    the attention layers only."""
    keys = n * start + n * (n + 1) // 2
    total = 2 * s["d_model"] * s["vocab_size"]
    for i in range(s["num_layers"]):
        mixer, ffn = kind_of(s, i)
        if mixer == "attn":
            total += n * _attn_proj_flops(s) \
                + 4 * s["head_dim"] * s["num_heads"] * keys
        else:
            total += _mamba_flops(s, n)
        total += n * _ffn_flops(s, ffn)
    return total


def decode_flops(s: dict, positions) -> int:
    """One decode step of the live sequences at ``positions``."""
    return sum(chunk_flops(s, int(p), 1) for p in positions)
