"""The harness end to end on the CPU at a tiny size: its result line,
its refusals, files found by name, and faults it must catch."""

import json
import os
import shutil
import subprocess
import sys
import time
import uuid

import pytest

from wqlbench import harness
from wqlbench.harness import Pipeline, result_line, run_cell

from .conftest import ROOT, bench_with_tree_cells

SCALE = 256


def _cli(args, cwd=ROOT, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "wqlbench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_result_line_schema():
    checks = {"wrong_answers": {"value": 0, "limit": 0}}
    line = result_line(True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
                       {"platform": "gpu", "kind": "k", "count": 1,
                        "memory_peak_bytes": 5},
                       {"device_ops": [], "idle_gaps": []}, checks, {})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "info", "checks"]
    line = result_line(False, 10, 1, None, None, None, checks, {})
    assert "metrics" not in line and "device" not in line
    assert line["rehearsal"] is True and list(line)[-1] == "checks"


def test_rehearsal_prints_its_check_last():
    res = _cli(["--workload", "crowd1m.local", "--seed", str(2**31 + 5),
                "--seconds", "1", "--trace", "0", "--rehearse", str(SCALE)])
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert "metrics" not in out and "device" not in out
    assert res.stderr.strip().splitlines()[-1] == \
        "check wrong_answers 0 limit 0"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _cli(["--workload", "crowd1m.local", "--seed", "1", "--seconds",
                "1", "--trace", "0"])
    assert res.returncode != 0
    assert not res.stdout.strip()


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "wqlbench", tmp_path / "wqlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _cli(["--workload", "crowd1m.local", "--seed", "1", "--seconds",
                "1", "--trace", "0", "--rehearse", str(SCALE)], cwd=tmp_path)
    assert res.returncode != 0
    assert not res.stdout.strip()


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "worldql_server_tpu_torch.fake",
                        sys.modules["json"])
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "worldql_server_tpu.fake",
                        sys.modules["json"])
    monkeypatch.setitem(sys.modules, "jaxlib", sys.modules["json"])
    assert harness.forbidden_modules() == ["jaxlib", "worldql_server_tpu"]


def test_jax_loaded_by_a_metric_reader_refuses_the_run(tmp_path):
    """The import check runs after every reader: one that loads a module
    named ``jax`` leaves the run without a result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "wqlbench", tmp_path / "wqlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "wqlbench/metrics/loads_jax.local.py").write_text(
        "import sys\nimport types\n\n\n"
        "def read(run):\n    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return 1.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "loads_jax.local", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "tick", "moves":
        "card_us_per_kmsg", "workloads": ["crowd1m.local"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _cli(["--workload", "crowd1m.local", "--seed", "4", "--seconds",
                "0.5", "--trace", "1", "--rehearse", str(SCALE)],
               cwd=tmp_path, env_extra={"PYTHONPATH": str(ROOT)})
    assert res.returncode != 0
    assert "['jax']" in res.stderr
    assert not any(line.startswith("{") for line in res.stdout.splitlines())


def test_a_mix_and_a_metric_added_as_files(tmp_path):
    """A later change adds a traffic mix and a per-layer metric as new
    files and new entries, and edits no file that exists."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "wqlbench", tmp_path / "wqlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((ROOT / "wqlbench/traffic/local.json").read_text())
    mix.update(what="dummy", messages_per_tick=8192,
               senders="with_replacement", speak_from="own_position",
               replication=1)
    (tmp_path / "wqlbench/traffic/dummy.json").write_text(json.dumps(mix))
    (tmp_path / "wqlbench/metrics/generate_ms.local.py").write_text(
        "from wqlbench.readers import span_mean_ms\n\n\n"
        "def read(run):\n    return span_mean_ms(run, 'generate')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "crowd1m.dummy", "config": "crowd1m",
                               "traffic": "dummy", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "generate_ms.local", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "traffic", "moves":
        "card_us_per_kmsg", "workloads": ["crowd1m.dummy"]})
    for m in bench["end_to_end"]:
        if m["name"] == "card_us_per_kmsg":
            m["workloads"].append("crowd1m.dummy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _cli(["--workload", "crowd1m.dummy", "--seed", "3", "--seconds",
                "1", "--trace", "1", "--rehearse", str(SCALE)], cwd=tmp_path,
               env_extra={"PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-2000:]
    info = json.loads(res.stdout.splitlines()[-2][len("wqlbench info "):])
    assert info["readers"]["generate_ms.local"] is True
    assert info["batch"] == 8192 // SCALE
    assert json.loads(res.stdout.splitlines()[-1])["correct"] is True


HOT_CUBE = """\
import numpy as np


def messages(traffic, tick):
    # every other tick the whole batch speaks from one random sender
    msg = traffic.base_messages(tick)
    if tick % 2:
        hot = int(traffic.rng(0, tick).integers(traffic.n))
        msg.senders[:] = hot
        msg.worlds[:] = traffic.world_of[hot]
        msg.positions[:] = traffic.positions[hot]
    return msg
"""


def test_a_mix_with_its_own_generator_file(tmp_path):
    """A mix whose traffic its parameters cannot state brings its own
    generator file beside it, at a fixed tick rate; the reference replays
    it and the check holds."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "wqlbench", tmp_path / "wqlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((ROOT / "wqlbench/traffic/local.json").read_text())
    mix.update(what="hot", generator="hot_cube.py", tick_interval_s=0.25)
    (tmp_path / "wqlbench/traffic/hot.json").write_text(json.dumps(mix))
    (tmp_path / "wqlbench/traffic/hot_cube.py").write_text(HOT_CUBE)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "crowd1m.hot", "config": "crowd1m",
                               "traffic": "hot", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "card_us_per_kmsg":
            m["workloads"].append("crowd1m.hot")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _cli(["--workload", "crowd1m.hot", "--seed", "5", "--seconds",
                "1", "--trace", "0", "--rehearse", str(SCALE)], cwd=tmp_path,
               env_extra={"PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-2000:]
    info = json.loads(res.stdout.splitlines()[-2][len("wqlbench info "):])
    # four ticks a second: the window closes after the fourth or fifth
    assert 4 <= info["window_ticks"] <= 6
    # a hot tick is among those the reference checked
    assert any(t % 2 for t in info["ticks_checked"])
    assert json.loads(res.stdout.splitlines()[-1])["correct"] is True


def _run(monkeypatch, workload, scale=SCALE, **kw):
    # the JAX package may be loaded by other tests of this process; the
    # subprocess test above holds the harness to its own import check
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    return run_cell(workload, 2**31 + 11, 0.5, False,
                    t_process=time.perf_counter(), rehearse=scale,
                    bench=bench_with_tree_cells(), **kw)


@pytest.mark.parametrize("workload,scale", [
    ("crowd1m.local", SCALE), ("crowd1m.queries", SCALE),
    ("crowd1m.churn", SCALE),
    # 64 worlds: cubes over 64 subscribers need 625 of them a world
    ("zones64.local", 16)])
def test_sound_run_is_correct_and_control_is_not(monkeypatch, workload,
                                                 scale):
    assert _run(monkeypatch, workload, scale)["correct"] is True
    bad = _run(monkeypatch, workload, scale, control="cap64")
    assert bad["correct"] is False
    assert bad["checks"]["wrong_answers"]["value"] > 0


def _broken_collect(monkeypatch, alter):
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)

    real = CudaSpatialBackend.collect_local_batch

    def collect(self, handle):
        return alter(real(self, handle))

    monkeypatch.setattr(CudaSpatialBackend, "collect_local_batch", collect)


@pytest.mark.parametrize("workload", ["crowd1m.local", "crowd1m.queries"])
def test_half_the_batch_left_out(monkeypatch, workload):
    _broken_collect(monkeypatch, lambda out: out[: len(out) // 2]
                    + [[] for _ in range(len(out) - len(out) // 2)])
    assert _run(monkeypatch, workload)["correct"] is False


@pytest.mark.parametrize("workload", ["crowd1m.local", "crowd1m.queries",
                                      "crowd1m.churn"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, workload):
    def alter(out):
        for i, a in enumerate(out):
            peers = getattr(a, "peers", a)
            if peers:
                peers[0] = uuid.UUID(int=peers[0].int + 1)
                return out
        return out

    _broken_collect(monkeypatch, alter)
    assert _run(monkeypatch, workload)["correct"] is False


def test_a_step_that_leaves_the_index_unchanged(monkeypatch):
    def mutate(self, t):
        self.traffic.moves(t)

    monkeypatch.setattr(Pipeline, "mutate", mutate)
    assert _run(monkeypatch, "crowd1m.churn")["correct"] is False
