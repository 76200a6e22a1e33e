"""A copy of the benchmark with tiny cells, for the CPU tests: the cells'
files are added as new files (a configuration, a traffic mix, a cell and
their entries in ``BENCHMARK.json``), as a later change would add them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_MOE = {"name": "tiny-moe", "arch": "mixtral-8x22b",
            "family": "transformer", "source": "test",
            "hidden_size": 64, "intermediate_size": 128,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 512,
            "rope_theta": 1000000.0, "rms_norm_eps": 1e-05,
            "sliding_window": 4096, "num_local_experts": 4,
            "num_experts_per_tok": 2, "tie_word_embeddings": False,
            "torch_dtype": "bfloat16"}
TINY_DENSE = {"name": "tiny-dense", "arch": "mistral-large-123b",
              "family": "transformer", "source": "test", "hidden_size": 64, "intermediate_size": 128,
              "num_attention_heads": 8, "num_key_value_heads": 2,
              "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 512,
              "rope_theta": 1000000.0, "rms_norm_eps": 1e-05,
              "sliding_window": None, "tie_word_embeddings": False,
              "torch_dtype": "bfloat16"}
TINY_MIX = {"name": "tinymix", "base_seed": 5,
            "classes": [
                {"name": "interactive", "share": 0.75, "priority": 0,
                 "arrival": {"process": "poisson"},
                 "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.8,
                            "min": 8, "max": 200},
                 "output": {"dist": "lognormal", "median": 12,
                            "sigma": 0.6, "min": 4, "max": 24}},
                {"name": "bulk", "share": 0.25, "priority": 2,
                 "arrival": {"process": "burst", "size": 2},
                 "prompt": {"dist": "uniform", "min": 64, "max": 220},
                 "output": {"dist": "uniform", "min": 4, "max": 16}}]}


def tiny_cell(name: str, config: str, **kw) -> dict:
    cell = {"name": name, "config": config, "traffic": "tinymix",
            "rate_per_s": 6.0,
            "engine": {"max_batch": 4, "s_max": 256, "block_size": 16,
                       "prefill_chunk": 32, "prefill_token_budget": 64,
                       "admission": "strategy"},
            "lead_in_s": 0.5, "drain_cap_s": 60, "span_s": 1.0,
            "profile_a_s": 0.5, "profile_b_s": 0.5, "program_span_s": 1.0,
            "compare": {"served": 64, "limits": {"gap_max": 0.5}},
            "why": "a tiny cell for the CPU tests"}
    cell.update(kw)
    return cell


def _dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def add_config(root: Path, config: dict) -> None:
    _dump(root / "bench" / "configs" / f"{config['name']}.json", config)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config["name"], "source": "test",
                            "file": f"bench/configs/{config['name']}.json",
                            "reduced": [], "why": "tiny"})
    _dump(root / "BENCHMARK.json", spec)


def add_cell(root: Path, cell: dict) -> None:
    _dump(root / "bench" / "workloads" / f"{cell['name']}.json", cell)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": cell["name"], "config": cell["config"],
                              "traffic": cell["traffic"], "chips": 1,
                              "why": "tiny"})
    _dump(root / "BENCHMARK.json", spec)


def tiny_tree(dst: Path) -> Path:
    """``dst`` holding ``BENCHMARK.json``, a copy of ``bench/``, a link to
    ``src/`` and the tiny cells ``tiny-moe.chat`` and ``tiny-dense.chat``."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "src").symlink_to(ROOT / "src")
    _dump(dst / "bench" / "traffic" / "tinymix.json", TINY_MIX)
    add_config(dst, TINY_MOE)
    add_config(dst, TINY_DENSE)
    add_cell(dst, tiny_cell("tiny-moe.chat", "tiny-moe"))
    add_cell(dst, tiny_cell("tiny-dense.chat", "tiny-dense"))
    return dst
