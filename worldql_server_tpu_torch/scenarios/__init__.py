"""Adversarial scenario library, on the port's server.

First-class hostile workloads driving a real server over real ZeroMQ:
``CATALOG`` maps names to :class:`~.engine.Scenario` classes;
:func:`run_scenario` produces one structured survival + SLO report.
Consumed by ``python -m worldql_server_tpu_torch.scenarios`` (the
scenario smoke), ``chip_smoke.py`` (all eleven at ``--shape full`` on
the card) and tests/test_torch_scenarios.py.
"""

from .catalog import (
    BandwidthCap, BattleRoyale, ClusterFlashCrowd, FlashCrowd, GameTick,
    MegaCity, ProjectileStorm, ReconnectStorm, ReconnectStormReplay,
    RollingRestart, SniperScope,
)
from .engine import Check, Scenario, ScenarioContext, format_report, run_scenario

CATALOG = {
    scenario.name: scenario
    for scenario in (
        FlashCrowd, BattleRoyale, ReconnectStorm, GameTick,
        ReconnectStormReplay, ClusterFlashCrowd,
        SniperScope, ProjectileStorm, BandwidthCap,
        MegaCity, RollingRestart,
    )
}

__all__ = [
    "CATALOG",
    "BandwidthCap",
    "BattleRoyale",
    "Check",
    "ClusterFlashCrowd",
    "FlashCrowd",
    "GameTick",
    "MegaCity",
    "ProjectileStorm",
    "ReconnectStorm",
    "ReconnectStormReplay",
    "RollingRestart",
    "Scenario",
    "ScenarioContext",
    "SniperScope",
    "format_report",
    "run_scenario",
]
