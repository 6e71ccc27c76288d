"""Shared fixtures of the benchmark's tests: the repository root, a
``card`` fixture that skips a test on a host with no CUDA device, and
``BENCHMARK.json`` with the cells whose files are in the tree but which
the benchmark does not hold yet."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch sees none")
    return torch.cuda.get_device_name(0)


#: cells whose configuration, mix and readers are in the tree
TREE_CELLS = {"crowd1m.queries": ("crowd1m", "queries"),
              "zones64.local": ("zones64", "local"),
              "crowd1m.churn": ("crowd1m", "churn")}
QUERIES_LAYER = ("dispatch_ms", "collect_ms", "tick_p95_ms",
                 "device_idle_pct")


def bench_with_tree_cells() -> dict:
    """``BENCHMARK.json`` with ``TREE_CELLS`` and their metrics added."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if "zones64" not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": "zones64",
                                 "file": "wqlbench/configs/zones64.json"})
    have = {w["name"] for w in bench["workloads"]}
    for name, (config, mix) in TREE_CELLS.items():
        if name not in have:
            bench["workloads"].append({"name": name, "config": config,
                                       "traffic": mix, "chips": 1})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["card_us_per_kmsg"]["workloads"] = sorted(
        set(e2e["card_us_per_kmsg"]["workloads"])
        | {"zones64.local", "crowd1m.churn"})
    if "queries_per_s" not in e2e:
        bench["end_to_end"].append({
            "name": "queries_per_s", "unit": "queries/s",
            "workloads": ["crowd1m.queries"]})
    have = {m["name"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        if m["moves"] == "card_us_per_kmsg":
            m["workloads"] = sorted(set(m["workloads"]) | {"zones64.local"})
    for base in QUERIES_LAYER:
        if f"{base}.queries" not in have:
            bench["per_layer"].append({
                "name": f"{base}.queries", "unit": "ms",
                "moves": "queries_per_s", "workloads": ["crowd1m.queries"]})
    return bench
