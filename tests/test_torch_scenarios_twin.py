"""The three scenarios the reference's tier-1 runs (tests/test_scenarios.py:
``flash_crowd``, ``game_tick``, ``reconnect_storm``), at smoke shape on
the CPU, through the port and through the JAX package: the port green,
the reference with the same checks and the same ``ok`` flags, except
that it may fail ``flash_crowd``'s ``broker_answers_after_storm``, a
fault of its own.

The port's floods yield to the event loop after every send, where the
reference's run until their socket is full: the server shares the loop,
so a reference flood runs its window alone, the floods one after
another, while the broker starves (ROADMAP Queue C). That fault is
pinned on both packages.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import time

import pytest

import worldql_server_tpu.scenarios as ref
import worldql_server_tpu_torch.scenarios as port
from worldql_server_tpu_torch.robustness import failpoints as t_failpoints

from tests.torch_twin import pin

#: the reference's tier-1 scenarios
TWIN_RUNS = ("flash_crowd", "game_tick", "reconnect_storm")


@pytest.fixture(autouse=True)
def port_on_the_cpu(monkeypatch):
    monkeypatch.setenv("WQL_TORCH_DEVICE", "cpu")
    t_failpoints.registry.reset()
    yield
    t_failpoints.registry.reset()


def _checks(report):
    return [(c["name"], c["ok"]) for c in report["checks"]]


def _run_with_flood_spy(pkg, name, monkeypatch):
    """Run ``name`` at smoke shape on ``pkg`` with its wire client's
    ``send`` wrapped: returns the report and, per flooding client, the
    instant of its first flood message (``flash_crowd``'s ``crowd``)."""
    client = importlib.import_module(pkg.__name__ + ".client").ZmqPeer
    send = client.send
    first: dict[int, float] = {}

    async def spy(self, message):
        if message.parameter == "crowd":
            first.setdefault(id(self), time.perf_counter())
        await send(self, message)

    monkeypatch.setattr(client, "send", spy)
    report = pkg.run_scenario(name, shape="smoke")
    monkeypatch.setattr(client, "send", send)
    return report, sorted(first.values())


@pytest.mark.parametrize("name", TWIN_RUNS)
def test_smoke_run_matches_the_reference(name, monkeypatch):
    ours, our_floods = _run_with_flood_spy(port, name, monkeypatch)
    theirs, their_floods = _run_with_flood_spy(ref, name, monkeypatch)
    failed = [c["name"] for c in ours["checks"] if not c["ok"]]
    assert not failed, (failed, ours["error"], ours["slo"])
    got = _checks(theirs)
    if name == "flash_crowd":
        # the reference's starved broker evicts its silent flooders
        # when its storm outlasts zmq_timeout_secs, as it does on a
        # loaded host, and then drops the probe's heartbeat (the fault
        # pinned below): the reference may fail this one check
        got = [(check, ok or check == "broker_answers_after_storm")
               for check, ok in got]
    assert got == _checks(ours)
    if name == "flash_crowd":
        # every flooder of the crowd sends within 0.1 s of the first
        # crowd message: the floods run side by side, as the scenario's
        # converge window means them to, and the broker's loop runs
        # between their sends
        def side_by_side(floods):
            return (len(floods) == ours["slo"]["clients"]
                    and floods[-1] - floods[0] < 0.1)

        pin(side_by_side(our_floods), side_by_side(their_floods),
            "the flash crowd's floods run side by side")
