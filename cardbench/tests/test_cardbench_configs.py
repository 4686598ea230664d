"""Each configuration file against its stated source's widths (the
published config.json, as this table holds it) and against the program's
configuration of the same name; the billed memory's arithmetic."""
from __future__ import annotations

import json
import math

import pytest

from cardbench.harness import ROOT, program_config

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: c for c in BENCH["configs"]}

#: the published config.json values of each source's widths
PUBLISHED = {
    "deepseek-7b": {
        "source": "https://huggingface.co/deepseek-ai/deepseek-llm-7b-base/"
                  "blob/main/config.json",
        "hidden_size": 4096, "intermediate_size": 11008,
        "num_attention_heads": 32, "num_key_value_heads": 32,
        "num_hidden_layers": 30, "vocab_size": 102400,
        "max_position_embeddings": 4096, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0, "tie_word_embeddings": False},
    "granite-moe-3b-a800m": {
        "source": "https://huggingface.co/ibm-granite/granite-3.0-3b-a800m-"
                  "base/blob/main/config.json",
        "hidden_size": 1536, "intermediate_size": 512,
        "num_attention_heads": 24, "num_key_value_heads": 8,
        "num_hidden_layers": 32, "num_local_experts": 40,
        "num_experts_per_tok": 8, "vocab_size": 49155,
        "max_position_embeddings": 4096, "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0, "tie_word_embeddings": True,
        "embedding_multiplier": 12.0, "attention_multiplier": 0.015625,
        "residual_multiplier": 0.22, "logits_scaling": 6.0},
}
#: the port's field of each published width
PORT = {"hidden_size": "d_model", "intermediate_size": "d_ff",
        "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
        "num_hidden_layers": "n_layers", "vocab_size": "vocab",
        "num_local_experts": "n_experts", "num_experts_per_tok": "top_k",
        "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
        "tie_word_embeddings": "tie_embeddings"}


def load(name):
    return json.loads((ROOT / CONFIGS[name]["file"]).read_text())


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_widths_as_published(name):
    conf, pub = load(name), PUBLISHED[name]
    assert CONFIGS[name]["source"] == pub["source"] == conf["source"]
    reduced = set(CONFIGS[name]["reduced"])
    assert reduced == set(conf["reduced"])
    for key, value in pub.items():
        if key == "source":
            continue
        if key in reduced:
            assert conf[key] != value
        else:
            assert conf[key] == value, key
        if key in PORT:
            assert conf["port"][PORT[key]] == conf[key], key
    assert conf["port"]["head_dim"] == conf["hidden_size"] // conf[
        "num_attention_heads"]


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_no_width_is_reduced(name):
    for key in CONFIGS[name]["reduced"]:
        assert not any(w in key for w in (
            "size", "_dim", "_rank", "heads", "experts", "expansion"))


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_program_runs_the_file(name):
    """The program's configuration is its registry's, with every field the
    file names at the file's value."""
    from repro_torch.configs import get_config
    conf = load(name)
    cfg = program_config(type("C", (), {"config": conf})())
    reg = get_config(conf["port_arch"])
    for field, value in conf["port"].items():
        assert getattr(cfg, field) == value
        if field != "head_dim":
            assert getattr(reg, field) == value, field
    assert cfg.hd == reg.hd
    assert cfg.ms_per_token_decode == conf["scheduler_model"][
        "modelled_step_ms"]


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_billed_memory(name):
    conf = load(name)
    p = conf["port"]
    d, hd, E = p["d_model"], p["head_dim"], p["n_experts"]
    attn = d * hd * (2 * p["n_heads"] + 2 * p["n_kv_heads"])
    ffn = d * E + E * 3 * d * p["d_ff"] if E else 3 * d * p["d_ff"]
    params = p["n_layers"] * (attn + ffn) + p["vocab"] * d * (
        1 if p["tie_embeddings"] else 2)
    from repro_torch.params import count_params
    norms = (2 * p["n_layers"] + 1) * d      # f32, left out of the bill
    assert params == conf["billing"]["params"]
    assert params + norms == count_params(
        program_config(type("C", (), {"config": conf})()))
    lane = p["n_layers"] * 2 * p["n_kv_heads"] * hd * conf["engine"][
        "max_len"] * 2
    billed = params * 2 / 1e9 / conf["engine"]["n_slots"] + lane / 1e9
    assert conf["billing"]["billed_gb"] == pytest.approx(billed, rel=1e-12)
    assert math.isclose(billed, {"deepseek-7b": 5.468,
                                 "granite-moe-3b-a800m": 1.918}[name],
                        abs_tol=5e-4)
