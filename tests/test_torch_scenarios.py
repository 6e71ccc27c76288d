"""The adversarial scenario library: the port against the JAX package.

* The two catalogs list the same eleven scenarios in the same order,
  with the same ``ci_smoke``, ``concurrent_boot`` and ``description``.
* ``build_config(shape)`` gives equal ``Config`` fields at both shapes,
  except ``spatial_backend`` (the reference's ``tpu`` is the port's
  ``cuda``) and the fields a free port or a temporary directory fills;
  the WAL that ``reconnect_storm_replay`` fabricates is byte-equal.
* ``build_backend()`` gives the port's device index with the
  reference's cube size and compaction threshold, on the device
  ``resolve_device`` gives (the CPU here, ``WQL_TORCH_DEVICE=cpu``).
* Smoke runs, on the CPU: the device-index scenarios and the
  cluster's ``mega_city`` (under a deadline) run green on the port; ``--check --json flash_crowd`` through the port's CLI exits 0
  with one JSON report; an unknown name exits 2 as the reference's CLI
  does. The three scenarios the reference's tier-1 runs are held to the
  reference's reports in tests/test_torch_scenarios_twin.py.
* The reference fault that the port's ``reconnect_storm_replay`` fixes
  is pinned on both packages (ROADMAP Queue C).
* ``chip_smoke.index_matches_host``, which holds ``battle_royale``'s
  device index to its host mirror on the card, passes an index whose
  segments match and catches a device row that differs.

Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import uuid

import pytest

import chip_smoke
import worldql_server_tpu.scenarios as ref
import worldql_server_tpu.scenarios.__main__ as ref_cli
import worldql_server_tpu_torch.scenarios as port
import worldql_server_tpu_torch.scenarios.__main__ as port_cli
from worldql_server_tpu_torch.protocol.types import Vector3
from worldql_server_tpu_torch.robustness import failpoints as t_failpoints
from worldql_server_tpu_torch.scenarios.engine import _run_async
from worldql_server_tpu_torch.spatial.cuda_backend import CudaSpatialBackend
from worldql_server_tpu_torch.spatial.torchconf import resolve_device

from tests.torch_twin import pin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = list(ref.CATALOG)
#: Config fields a free port or a temporary directory fills
PER_RUN = ("zmq_server_port", "wal_dir")
#: the port's runs on its device index (the CPU here); ``bandwidth_cap``
#: is left to chip_smoke.py: at smoke shape its victim defers exactly
#: once in both packages, and on a loaded CPU, not at all
DEVICE_RUNS = ("battle_royale", "sniper_scope", "projectile_storm")
DEADLINE_S = 90


@pytest.fixture(autouse=True)
def port_on_the_cpu(monkeypatch):
    """Shard processes and CLI subprocesses inherit the environment: the
    port's device is the CPU here."""
    monkeypatch.setenv("WQL_TORCH_DEVICE", "cpu")
    t_failpoints.registry.reset()
    yield
    t_failpoints.registry.reset()


def assert_green(report):
    failed = [c for c in report["checks"] if not c["ok"]]
    assert not failed, (
        f"scenario {report['scenario']} failed checks: "
        f"{[c['name'] for c in failed]} (error={report['error']}) "
        f"slo={report['slo']}")


def test_catalogs_list_the_same_scenarios_in_order():
    assert list(port.CATALOG) == NAMES
    assert len(NAMES) == 11


@pytest.mark.parametrize("name", NAMES)
def test_scenario_attributes_match_the_reference(name):
    ours, theirs = port.CATALOG[name], ref.CATALOG[name]
    assert ours.name == theirs.name == name
    for attr in ("ci_smoke", "concurrent_boot", "description"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr


def _wal_bytes(config):
    with open(os.path.join(config.wal_dir, "wal-00000000.log"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("shape", ["smoke", "full"])
@pytest.mark.parametrize("name", NAMES)
def test_build_config_matches_the_reference(name, shape):
    ours = port.CATALOG[name]().build_config(shape)
    theirs = ref.CATALOG[name]().build_config(shape)
    try:
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert a.keys() == b.keys()
        assert a.pop("spatial_backend") == {
            "tpu": "cuda"}.get(b["spatial_backend"], b["spatial_backend"])
        b.pop("spatial_backend")
        assert isinstance(a["zmq_server_port"], int)
        assert a["zmq_server_port"] > 0
        assert (a["wal_dir"] is None) == (b["wal_dir"] is None)
        if name == "reconnect_storm_replay":
            assert _wal_bytes(ours) == _wal_bytes(theirs)
        for key in PER_RUN:
            a.pop(key), b.pop(key)
        assert a == b
    finally:
        for config in (ours, theirs):
            if config.wal_dir is not None:
                shutil.rmtree(config.wal_dir, ignore_errors=True)


@pytest.mark.parametrize("name", NAMES)
def test_build_backend_matches_the_reference(name):
    ours = port.CATALOG[name]().build_backend()
    theirs = ref.CATALOG[name]().build_backend()
    if theirs is None:
        assert ours is None
        return
    assert isinstance(ours, CudaSpatialBackend)
    assert ours.device == resolve_device()
    assert ours.cube_size == theirs.cube_size
    assert (ours._compact_threshold_override
            == theirs._compact_threshold_override)


def test_cli_check_json_runs_flash_crowd():
    """``python -m worldql_server_tpu_torch.scenarios --check --json
    flash_crowd`` exits 0 (no check failed) and prints one JSON
    report."""
    proc = subprocess.run(
        [sys.executable, "-m", "worldql_server_tpu_torch.scenarios",
         "--check", "--json", "flash_crowd"],
        cwd=REPO, capture_output=True, text=True, timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, proc.stdout
    report = json.loads(lines[0])
    assert report["scenario"] == "flash_crowd"
    assert report["shape"] == "smoke"
    assert_green(report)


@pytest.mark.parametrize("name", DEVICE_RUNS)
def test_port_smoke_run_on_the_device_index(name):
    report = port.run_scenario(name, shape="smoke")
    assert_green(report)
    assert report["device"]["index"] == str(resolve_device())
    if port.CATALOG[name]().build_config("smoke").entity_sim:
        assert report["device"]["entity_plane"] == str(resolve_device())


def test_port_mega_city_smoke_reshards_under_a_deadline():
    """The cluster scenario: the port's router and two shard processes
    on the host index, a live reshard of the city mid-traffic."""
    report = asyncio.run(asyncio.wait_for(
        _run_async(port.CATALOG["mega_city"](), "smoke"), DEADLINE_S))
    assert_green(report)
    assert report["device"] is None  # the shards report their own
    assert report["slo"]["parked_replayed"] > 0


def test_cli_unknown_name_exits_2_like_the_reference(capsys):
    def run(cli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["no_such_scenario"])
        return exc.value.code, capsys.readouterr().err.splitlines()[-1]

    code, ours = run(port_cli)
    ref_code, theirs = run(ref_cli)
    assert code == ref_code == 2
    assert ours == theirs.replace(
        "worldql_server_tpu.scenarios", "worldql_server_tpu_torch.scenarios")
    assert "unknown scenario(s): no_such_scenario (have: " in ours


def test_replay_storm_handshake_p99_excludes_the_replay():
    """``reconnect_storm_replay`` bounds the storm's handshake p99 "once
    serving opens". The reference measures each handshake from the
    client's first attempt, during the replay, so its p99 holds the
    whole replay (the failpoint's 5 ms a WAL entry: 1.5 s at smoke, 15 s
    at full, three times the full shape's 5,000 ms limit); the port
    measures from the instant recovery returns."""
    def p99_and_replay(pkg):
        report = pkg.run_scenario("reconnect_storm_replay", shape="smoke")
        assert report["slo"]["records_recovered"] == 300
        # the replay lasts at least 5 ms a fired batch
        return (report["slo"]["handshake_p99_ms"],
                report["slo"]["replay_batches_fired"] * 5.0)

    ours, our_replay = p99_and_replay(port)
    theirs, their_replay = p99_and_replay(ref)
    pin(ours < 0.8 * our_replay, theirs < 0.8 * their_replay,
         "the replay storm's handshake p99 excludes the replay")


@pytest.mark.parametrize("segment", ["base", "delta"])
def test_index_matches_host_catches_a_device_row_that_differs(segment):
    index = CudaSpatialBackend(
        16, compact_threshold=8 if segment == "base" else 1000)
    peers = [uuid.UUID(int=i + 1) for i in range(40)]
    for i, p in enumerate(peers):
        index.add_subscription("w", p, Vector3(i * 16.0, 0.0, 0.0))
    index.flush()
    for i, p in enumerate(peers[:30]):
        index.add_subscription("w", p, Vector3(i * 16.0 + 300, 0.0, 0.0))
    for i, p in enumerate(peers[:5]):
        index.remove_subscription("w", p, Vector3(i * 16.0, 0.0, 0.0))
    rows = chip_smoke.index_matches_host(index)
    assert rows[segment] == 65
    bundle = getattr(index, f"_{segment}_bundle")
    peer = bundle["dev"][2].clone()
    peer[int((peer >= 0).nonzero()[0])] = -1  # one live row tombstoned
    setattr(index, f"_{segment}_bundle", {
        **bundle, "dev": (*bundle["dev"][:2], peer, *bundle["dev"][3:])})
    with pytest.raises(AssertionError, match=f"device {segment}"):
        chip_smoke.index_matches_host(index)
