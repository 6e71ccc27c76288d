"""The one traffic generator: a configuration's crowd and a mix's ticks.

Everything comes from ``--seed``. The crowd, each tick's moves and each
tick's messages draw from their own ``numpy`` streams, keyed by
``(seed, stream, tick)``, so a tick's inputs do not depend on how many
ticks came before it or on the time they took, and the reference can
replay them after the window.

The crowd is BASELINE config 5's (copied from the port's
``tools/index_bench.py::make_positions``): Zipf(s) cube popularity over
a grid of cubes spanning ``±span_m``, occupancy capped per cube with the
excess spilled down the ranking, positions uniform inside a cube.
Subscriber ``i`` is in world ``i * worlds // subscriptions`` and
subscribes to the cube that holds its position.

A mix is a JSON file of parameters (see ``traffic/*.json``):

``messages_per_tick``
    LocalMessages (or queries) in each tick's batch.
``senders``
    ``"without_replacement"``: each sender is the next subscriber of a
    seeded permutation of the crowd (a fresh one once it is used up),
    so no subscriber speaks twice from one place within a pass;
    ``"with_replacement"``: each tick draws its senders uniformly.
``speak_from``
    ``"own_cube"``: a message comes from a point drawn afresh inside the
    sender's cube, so no two messages share a position and the index's
    result reuse finds nothing to replay; ``"own_position"``: from the
    sender's position as generated.
``miss_share``
    share of messages sent from a fresh crowd point instead of from the
    sender (they mostly find no subscriber).
``replication``
    0 every subscriber of the cube but the sender, 1 all, 2 the sender.
``kinds``
    the kinds, interleaved by message index modulo their count;
    ``kind_params`` gives each kind's parameter ranges, drawn as the
    broker's wire parsers clamp them (``tools/index_bench.py::kind_cols``).
``movers_share``, ``move_cubes``
    each tick, that share of the subscribers moves ``move_cubes`` cubes
    along one random axis, before the tick's messages.
``warmup_ticks``
    ticks run through the whole path in set-up, before the window.
``tick_interval_s``
    optional: ticks start at this fixed interval (a fixed arrival
    rate) instead of as soon as the one tick ahead allows.
``generator``
    optional: a Python file beside the mix (``traffic/<file>.py``) whose
    ``messages(traffic, tick)`` and, if it has one,
    ``moves(traffic, tick)`` take the place of this generator's, for
    traffic that its parameters cannot state. They may build on
    ``Traffic.base_messages`` and ``Traffic.base_moves``; they draw only
    from ``traffic.rng(stream, tick)``, so the reference replays them.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .reference.index import (
    KIND_CONE, KIND_DENSITY, KIND_KNN, KIND_RADIUS, KIND_RAYCAST)
from .reference.quantize import cube_labels

KIND_IDS = {"radius": KIND_RADIUS, "cone": KIND_CONE,
            "raycast": KIND_RAYCAST, "knn": KIND_KNN,
            "density": KIND_DENSITY}
#: staged parameter lanes of a query row
PARAM_LANES = 6

_CROWD, _MESSAGES, _MOVES, _ORDER = range(4)
#: the first ``rng`` stream a mix's own generator file may use
OWN_STREAMS = 16
TRAFFIC = Path(__file__).resolve().parent / "traffic"


def seed_words(seed: int) -> list[int]:
    """Any whole number as non-negative words for ``SeedSequence``."""
    seed = int(seed)
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, int(seed < 0)]


def make_positions(rng: np.random.Generator, n: int, crowd: dict,
                   stats: dict | None = None) -> np.ndarray:
    """[n, 3] positions of a Zipf-popularity crowd (see module doc)."""
    span, cube = float(crowd["span_m"]), float(crowd["cube_m"])
    cap = int(crowd["occupancy_cap"])
    cells_axis = int(span * 2 / cube)
    n_ranked = min(max(int(n * crowd["ranked_cubes_share"]),
                       int(crowd["ranked_cubes_min"])), cells_axis ** 3)
    cell_ids = rng.choice(cells_axis ** 3, n_ranked, replace=False)
    p = 1.0 / np.arange(1, n_ranked + 1, dtype=np.float64) ** crowd["zipf_s"]
    counts = rng.multinomial(n, p / p.sum())
    excess = int(np.maximum(counts - cap, 0).sum())
    counts = np.minimum(counts, cap)
    if excess:
        free = cap - counts
        counts += np.minimum(free, np.maximum(
            excess - (np.cumsum(free) - free), 0))
        if int(counts.sum()) != n:
            raise ValueError("the crowd does not fit under its occupancy cap")
    if stats is not None:
        stats.update(max_cube_occupancy=int(counts.max()),
                     occupied_cubes=int((counts > 0).sum()))
    cid = np.repeat(cell_ids, counts)
    corner = np.stack([cid % cells_axis, (cid // cells_axis) % cells_axis,
                       cid // (cells_axis * cells_axis)], axis=1)
    return corner * cube - span + rng.uniform(0.0, cube, (n, 3))


def point_in_cube(cubes: np.ndarray, size: int, u: np.ndarray) -> np.ndarray:
    """A point of each cube from ``u`` in [0, 1): a cube label ``L`` holds
    the coordinates of sign ``L`` and magnitude in ``(|L| - size, |L|]``."""
    mag = np.abs(cubes).astype(np.float64)
    return np.sign(cubes) * (mag - size * u)


def kind_params(rng: np.random.Generator, m: int, kind: int,
                spec: dict) -> np.ndarray:
    """[m, PARAM_LANES] parameter rows of one kind."""
    params = np.zeros((m, PARAM_LANES), np.float64)
    if kind in (KIND_CONE, KIND_RAYCAST):
        d = rng.normal(size=(m, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        params[:, 0:3] = d
    if kind == KIND_CONE:
        params[:, 3] = np.cos(np.radians(rng.uniform(
            *spec["half_angle_deg"], m)))
        params[:, 4] = rng.uniform(*spec["range"], m)
    elif kind == KIND_RAYCAST:
        params[:, 3] = rng.uniform(*spec["max_t"], m)
        params[:, 4] = np.where(rng.random(m) < spec["all_hits_share"],
                                1.0, 0.0)
    elif kind == KIND_KNN:
        params[:, 0] = rng.integers(*spec["k"], m).astype(np.float64)
        params[:, 1] = rng.uniform(*spec["max_range"], m)
    elif kind == KIND_DENSITY:
        params[:, 0] = rng.integers(*spec["extent"], m).astype(np.float64)
        params[:, 1] = float(spec["top_n"])
    return params


@dataclass
class Moves:
    """One tick's moves: subscriber indices, old and new cube labels."""

    idx: np.ndarray
    old: np.ndarray
    new: np.ndarray


@dataclass
class Messages:
    """One tick's batch as staged columns (subscriber and world indices
    of the crowd, not the program's interned ids)."""

    worlds: np.ndarray
    positions: np.ndarray
    senders: np.ndarray
    repls: np.ndarray
    kinds: np.ndarray | None
    params: np.ndarray | None


class Traffic:
    """A configuration's crowd and a mix's ticks, from one seed.

    ``scale`` divides the crowd and the per-tick counts (CPU rehearsals
    and tests only)."""

    def __init__(self, config: dict, mix: dict, seed: int, scale: int = 1):
        self.config, self.mix, self.scale = config, mix, scale
        self.words = seed_words(seed)
        self.n = max(256, int(config["subscriptions"]) // scale)
        self.n_worlds = int(config["worlds"])
        self.cube = int(config["cube_size"])
        self.crowd = dict(config["crowd"], cube_m=float(self.cube))
        self.m = max(32, int(mix["messages_per_tick"]) // scale)
        self.movers = int(round(self.n * float(mix.get("movers_share", 0))))
        self.kinds = [KIND_IDS[k] for k in mix.get("kinds", ["radius"])]
        self.stats: dict = {}
        rng = self._rng(_CROWD, 0)
        self.positions = make_positions(rng, self.n, self.crowd, self.stats)
        self.world_of = (np.arange(self.n) * self.n_worlds
                         // self.n).astype(np.int32)
        self.cubes = cube_labels(self.positions, self.cube)
        self._order: dict[int, np.ndarray] = {}
        self.next_tick = 0
        self.entry = load_entry(mix["generator"]) if "generator" in mix \
            else None

    def _rng(self, stream: int, tick: int) -> np.random.Generator:
        return np.random.default_rng([*self.words, stream, tick])

    def rng(self, stream: int, tick: int) -> np.random.Generator:
        """A stream of a mix's own generator file, keyed by the seed:
        its streams are numbered from 0 and kept apart from this
        generator's."""
        return self._rng(OWN_STREAMS + int(stream), tick)

    @property
    def has_kinds(self) -> bool:
        return any(k != KIND_RADIUS for k in self.kinds)

    def _senders(self, tick: int, rng: np.random.Generator) -> np.ndarray:
        if self.mix["senders"] == "with_replacement":
            return rng.integers(0, self.n, self.m)
        if self.mix["senders"] != "without_replacement":
            raise ValueError(f"unknown senders {self.mix['senders']!r}")
        g = tick * self.m + np.arange(self.m)
        out = np.empty(self.m, np.int64)
        for c in np.unique(g // self.n):
            if c not in self._order:
                self._order = {c: self._rng(_ORDER, int(c)).permutation(
                    self.n)}
            sel = g // self.n == c
            out[sel] = self._order[c][g[sel] % self.n]
        return out

    def moves(self, tick: int) -> Moves | None:
        """Tick ``tick``'s moves, applied to the crowd; ticks must be
        taken in order."""
        if tick != self.next_tick:
            raise ValueError(f"tick {tick} out of order ({self.next_tick})")
        self.next_tick += 1
        if self.entry is not None and hasattr(self.entry, "moves"):
            return self.entry.moves(self, tick)
        return self.base_moves(tick)

    def base_moves(self, tick: int) -> Moves | None:
        """The moves that the mix's parameters state."""
        if not self.movers:
            return None
        rng = self._rng(_MOVES, tick)
        idx = np.sort(rng.choice(self.n, self.movers, replace=False))
        axis = rng.integers(0, 3, self.movers)
        step = np.where(rng.random(self.movers) < 0.5, -1.0, 1.0) \
            * float(self.mix["move_cubes"]) * self.cube
        pos = self.positions[idx]
        pos[np.arange(self.movers), axis] += step
        new = cube_labels(pos, self.cube)
        old = self.cubes[idx]
        self.positions[idx] = pos
        self.cubes[idx] = new
        return Moves(idx, old, new)

    def messages(self, tick: int) -> Messages:
        """Tick ``tick``'s batch from the crowd as it stands."""
        if self.entry is not None:
            return self.entry.messages(self, tick)
        return self.base_messages(tick)

    def base_messages(self, tick: int) -> Messages:
        """The batch that the mix's parameters state."""
        rng = self._rng(_MESSAGES, tick)
        senders = self._senders(tick, rng)
        if self.mix["speak_from"] == "own_cube":
            positions = point_in_cube(self.cubes[senders], self.cube,
                                      rng.random((self.m, 3)))
            off = np.any(cube_labels(positions, self.cube)
                         != self.cubes[senders], axis=1)
            positions[off] = self.positions[senders[off]]
        elif self.mix["speak_from"] == "own_position":
            positions = self.positions[senders].copy()
        else:
            raise ValueError(f"unknown speak_from {self.mix['speak_from']!r}")
        miss = rng.random(self.m) < float(self.mix["miss_share"])
        positions[miss] = make_positions(rng, int(miss.sum()), self.crowd)
        kinds = params = None
        if self.has_kinds:
            kinds = np.zeros(self.m, np.int8)
            params = np.zeros((self.m, PARAM_LANES), np.float64)
            names = self.mix["kinds"]
            for j, kid in enumerate(self.kinds):
                sel = np.flatnonzero(np.arange(self.m) % len(names) == j)
                kinds[sel] = kid
                if kid != KIND_RADIUS:
                    params[sel] = kind_params(
                        rng, sel.size, kid, self.mix["kind_params"][names[j]])
        return Messages(self.world_of[senders], positions, senders,
                        np.full(self.m, int(self.mix["replication"]), np.int8),
                        kinds, params)


def load_entry(name: str):
    """The module of a mix's own generator file ``traffic/<name>``."""
    path = TRAFFIC / name
    if path.suffix != ".py" or path.parent != TRAFFIC or not path.exists():
        raise ValueError(f"no traffic generator file {name!r} in {TRAFFIC}")
    spec = importlib.util.spec_from_file_location(
        "wqlbench_traffic_" + path.stem.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
