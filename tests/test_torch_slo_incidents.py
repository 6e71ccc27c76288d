"""The SLO engine and incident capsules: the port against the JAX package.

* The single-process cases of tests/test_slo_incidents.py (the objective
  loader and its validation, the burn state machine on a fake clock, the
  per-kind burn math, the incident recorder's debounce and bounded ring,
  the capsule's stable shape, the off-by-default surface, and the forced
  breach on a real-socket server) run once on each package: on the port
  their source runs with the JAX package's imports pointed at the port
  (tests/torch_twin.py), and the breach server asks for the port's
  device index (``cuda``, on the CPU) where the JAX one asks for
  ``tpu``.
* Twin engines: one series of metric updates on one injected clock goes
  into the JAX package's ``SloEngine`` and the port's. After every
  evaluation the status, the gauge and the healthz block are equal, and
  so are the ``on_burning`` firings and the trajectories.
* Capsule sections: a JAX server and a port server booted alike give
  ``capsule_sections`` of the same shape (section names, keys and value
  types). Values are not compared: the flight recorder and the loop
  monitor carry clocks, and the ``device`` section counts jit compiles in
  the JAX package where the port, which compiles nothing, reads 0 and
  reports torch's allocator for the live bytes.

Tolerance: exact (the engines do float arithmetic in the same order).
"""

from __future__ import annotations

import numpy as np
import pytest

import tests.test_slo_incidents as ref
from tests.torch_twin import call, case_id, cases, port_module
from worldql_server_tpu.engine.config import Config as JConfig
from worldql_server_tpu.engine.metrics import Metrics as JMetrics
from worldql_server_tpu.engine.server import WorldQLServer as JServer
from worldql_server_tpu.observability import incidents as j_incidents
from worldql_server_tpu.observability.slo import SloEngine as JEngine
from worldql_server_tpu.robustness import failpoints as j_failpoints
from worldql_server_tpu_torch.engine.config import Config as TConfig
from worldql_server_tpu_torch.engine.metrics import Metrics as TMetrics
from worldql_server_tpu_torch.engine.server import WorldQLServer as TServer
from worldql_server_tpu_torch.observability import incidents as t_incidents
from worldql_server_tpu_torch.observability.slo import SloEngine as TEngine
from worldql_server_tpu_torch.robustness import failpoints as t_failpoints

PORT = port_module(ref, replace=[
    ('spatial_backend="tpu"', 'spatial_backend="cuda"'),
])
CASES = cases(ref, [
    "test_load_objectives_defaults_are_copies",
    "test_default_latency_targets_sit_on_bucket_edges",
    "test_load_objectives_file_forms",
    "test_load_objectives_rejects_malformed",
    "test_config_slo_validation",
    "test_burn_state_machine_fires_on_burning_exactly_once",
    "test_latency_objective_burns_on_over_target_fraction",
    "test_gauge_floor_objective_ignores_unmeasured_samples",
    "test_incident_recorder_debounce_ring_and_introspection",
    "test_incident_capsule_survives_collect_failure",
    "test_capsule_sections_stable_shape_when_everything_off",
    "test_slo_off_surface_stays_reference_shaped",
    "test_single_process_breach_one_capsule_then_recovery",
])


@pytest.fixture(autouse=True)
def clean_registries(monkeypatch):
    """Both packages' failpoint registries are process-global and the
    breach case arms one mid-flight; the port's device is the CPU."""
    monkeypatch.setenv("WQL_TORCH_DEVICE", "cpu")
    for registry in (j_failpoints.registry, t_failpoints.registry):
        registry.reset()
    yield
    for registry in (j_failpoints.registry, t_failpoints.registry):
        registry.reset()


@pytest.mark.parametrize("case", CASES, ids=map(case_id, CASES))
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_reference_case(pkg, case, request):
    name, params = case
    call(getattr(ref if pkg == "jax" else PORT, name), params, request)


OBJECTIVES = [
    {"name": "lat", "series": "t.ms", "kind": "latency_p99",
     "target_ms": 10.0, "budget": 0.2, "fast_s": 2.0, "slow_s": 6.0},
    {"name": "drops", "series": "t.drops", "kind": "rate",
     "max_per_s": 3.0, "fast_s": 1.0, "slow_s": 4.0},
    {"name": "cap", "series": "t.cap", "kind": "gauge_floor",
     "floor": 50.0, "fast_s": 2.0, "slow_s": 5.0},
]


def test_twin_engines_walk_the_same_states():
    rng = np.random.default_rng(20)
    clock = [0.0]
    value = [0.0]
    sides = []
    for metrics_cls, engine_cls in ((JMetrics, JEngine),
                                    (TMetrics, TEngine)):
        metrics = metrics_cls()
        metrics.gauge("t.cap", lambda: value[0])
        engine = engine_cls(metrics, [dict(o) for o in OBJECTIVES],
                            eval_interval_s=0.5, clock=lambda: clock[0])
        fired = []
        engine.on_burning = lambda obj, fired=fired: fired.append(
            (clock[0], obj.name))
        sides.append((metrics, engine, fired))

    levels = set()
    for step in range(120):
        # calm, then two excursions of every kind, then calm again
        hot = 30 <= step < 50 or 80 <= step < 95
        lat = rng.exponential(25.0 if hot else 3.0, rng.integers(1, 20))
        drops = int(rng.poisson(8.0 if hot else 0.5))
        value[0] = float(rng.uniform(20, 60) if hot else
                         rng.uniform(60, 200))
        clock[0] += 0.5
        states = []
        for metrics, engine, _ in sides:
            for ms in lat:
                metrics.observe_ms("t.ms", float(ms))
            metrics.inc("t.drops", drops)
            engine.evaluate()
            states.append((engine.status(), engine.gauge(),
                           engine.healthz()))
        assert states[0] == states[1], step
        levels.update(states[0][1].values())
    (_, j, j_fired), (_, t, t_fired) = sides
    assert j_fired == t_fired and len(t_fired) >= 2
    assert levels == {0, 1, 2}
    for obj in OBJECTIVES:
        assert j.trajectory(obj["name"]) == t.trajectory(obj["name"])


def _shape(value):
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return "list"
    if isinstance(value, bool) or value is None:
        return type(value).__name__
    if isinstance(value, (int, float)):
        return "number"
    return type(value).__name__


def test_capsule_sections_have_the_same_shape(tmp_path):
    def config(cls, backend):
        return cls(store_url="memory://", ws_enabled=False,
                   zmq_enabled=False, http_enabled=False,
                   spatial_backend=backend, tick_interval=0.03,
                   trace=True, overload="on", slo="on",
                   precompile_tiers=False,
                   incident_dir=str(tmp_path / backend))

    jsrv = JServer(config(JConfig, "tpu"))
    tsrv = TServer(config(TConfig, "cuda"), device="cpu")
    js = j_incidents.capsule_sections(jsrv)
    ts = t_incidents.capsule_sections(tsrv)
    assert set(js) == set(ts) == ref.SECTION_KEYS
    assert _shape(js) == _shape(ts)
    for section in ("flight_recorder", "governor", "device"):
        assert ts[section].get("enabled", True) is True, section
    assert ts["device"]["compiles"] == 0
