"""The reference agrees with a brute-force walk over every subscription
at a tiny size, and with the port's own CPU semantics."""

import ast
import json
import math
import uuid

import numpy as np
import pytest

from wqlbench.generator import Traffic
from wqlbench.harness import PKG
from wqlbench.reference import index as ref
from wqlbench.reference.quantize import cube_labels


def _scalar_label(c: float, size: int) -> int:
    """The cube rule for one finite coordinate, written out."""
    if c != 0.0 and math.fmod(abs(c), size) == 0.0:
        return int(c)
    up = math.ceil(abs(c) / size) * size if c != 0.0 else size
    lab = up if up > c or c < 0 else up + size
    return int(lab) * (-1 if c < 0 else 1)


def test_quantize_matches_the_written_rule():
    rng = np.random.default_rng(1)
    xs = np.concatenate([rng.uniform(-100, 100, 2000),
                         [0.0, 16.0, -16.0, 32.0, -0.5, 15.999, 16.001]])
    got = cube_labels(xs, 16)
    assert [int(v) for v in got] == [_scalar_label(float(x), 16) for x in xs]


def _crowd(mix, seed=11, scale=512):
    config = json.loads((PKG / "configs/crowd1m.json").read_text())
    tr = Traffic(config, json.loads((PKG / f"traffic/{mix}.json").read_text()),
                 seed, scale=scale)
    return tr, ref.SubscriptionTable(tr.world_of, tr.cubes, np.arange(tr.n),
                                     tr.cube)


def _brute_cube(tr, world, cube, sender, repl):
    """Every subscriber of (world, cube) after the replication filter,
    by a walk over all subscriptions."""
    hit = [i for i in range(tr.n) if tr.world_of[i] == world
           and tuple(tr.cubes[i]) == tuple(cube)]
    if repl == 0:
        return [i for i in hit if i != sender]
    if repl == 2:
        return [i for i in hit if i == sender]
    return hit


@pytest.mark.parametrize("repl", [0, 1, 2])
def test_fanout_matches_brute_force(repl):
    tr, table = _crowd("local")
    msg = tr.messages(0)
    repls = np.full(tr.m, repl, np.int8)
    rows, peers = ref.fanout(table, msg.worlds, msg.positions, msg.senders,
                             repls)
    cubes = cube_labels(msg.positions, tr.cube)
    for q in range(tr.m):
        want = _brute_cube(tr, msg.worlds[q], cubes[q], msg.senders[q], repl)
        assert peers[rows == q].tolist() == sorted(want)


def _brute_kind(tr, q, msg, stencil_max=3, ray_steps=64):
    """One query answered by the cube-sampled contract, in loops."""
    kind, p = int(msg.kinds[q]), msg.params[q]
    pos, w, s, r = (msg.positions[q], msg.worlds[q], msg.senders[q],
                    int(msg.repls[q]))
    size = tr.cube

    def rad(reach):
        return max(1, min(stencil_max, math.ceil(reach / size)
                          if reach > 0 else 1))

    def offsets(radius):
        span = range(-radius, radius + 1)
        return [(x, y, z) for x in span for y in span for z in span]

    def cube_at(pt):
        return tuple(int(v) for v in cube_labels(np.array(pt), size))

    if kind == 0:
        return (0, tuple(sorted(_brute_cube(tr, w, cube_at(pos), s, r))),
                None)
    if kind == 1:
        seen = set()
        for o in offsets(rad(p[4])):
            d = np.array(o, np.float64) * size
            d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            dist = math.sqrt(d2)
            dot = d[0] * p[0] + d[1] * p[1] + d[2] * p[2]
            if dist <= p[4] and (dot >= dist * p[3] or d2 == 0.0):
                seen.update(_brute_cube(tr, w, cube_at(pos + d), s, r))
        return (1, tuple(sorted(seen)), {})
    if kind == 2:
        peers, ts, done = [], [], set()
        for j in range(ray_steps + 1):
            t = j * (size / 2.0)
            if t > p[3]:
                break
            c = cube_at(pos + p[0:3] * t)
            if c in done:
                continue
            done.add(c)
            hit = sorted(set(_brute_cube(tr, w, c, s, r)))
            if hit and p[4] == 0.0:
                return (2, tuple(hit), {"t": t, "mode": "first_hit"})
            for u in hit:
                if u not in peers:
                    peers.append(u)
                    ts.append(t)
        if p[4] == 0.0:
            return (2, (), {"t": None, "mode": "first_hit"})
        return (2, tuple(peers), {"ts": ts, "mode": "all_hits"})
    if kind == 3:
        k = int(p[0])
        offs = offsets(rad(p[1]))
        d2s = [np.float32(sum((v * size) ** 2 for v in o)) for o in offs]
        order = sorted(range(len(offs)), key=lambda i: (d2s[i], i))
        peers, done = [], set()
        for i in order:
            d = np.array(offs[i], np.float64) * size
            if math.sqrt(float(d @ d)) > p[1] or len(peers) >= k:
                continue
            c = cube_at(pos + d)
            if c in done:
                continue
            done.add(c)
            for u in sorted(set(_brute_cube(tr, w, c, s, r))):
                if u not in peers and len(peers) < k:
                    peers.append(u)
        return (3, tuple(peers), {"k": k})
    ext = int(p[0])
    cubes = []
    for o in offsets(max(1, min(stencil_max, ext))):
        if max(abs(v) for v in o) <= p[0]:
            c = cube_at(pos + np.array(o, np.float64) * size)
            if c not in cubes:
                cubes.append(c)
    entries = [(*c, len(_brute_cube(tr, w, c, -1, 1))) for c in cubes]
    entries = sorted((e for e in entries if e[3]),
                     key=lambda e: (-e[3], e[0], e[1], e[2]))
    return (4, (), {"cubes": [list(e) for e in entries[:int(p[1])]]})


def test_queries_match_brute_force():
    tr, table = _crowd("queries", seed=12, scale=256)
    msg = tr.messages(0)
    got = ref.queries(table, msg.worlds, msg.positions, msg.senders,
                      msg.repls, msg.kinds, msg.params, stencil_max=3,
                      ray_steps=64)
    for q in range(tr.m):
        assert got[q] == _brute_kind(tr, q, msg), q
    # the sample is worth checking: cones and knn find peers
    assert sum(len(a[1]) for a in got if a[0] == 1) > 0


def test_queries_match_the_ports_cpu_semantics():
    """The port's CPU backend answers the same batch the same way (the
    reference itself imports nothing of the port)."""
    from worldql_server_tpu_torch.protocol.types import Replication, Vector3
    from worldql_server_tpu_torch.spatial.backend import LocalQuery
    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)

    tr, table = _crowd("queries", seed=13, scale=128)
    msg = tr.messages(0)
    peers = [uuid.UUID(int=i + 1) for i in range(tr.n)]
    cpu = CpuSpatialBackend(tr.cube)
    for w in range(tr.n_worlds):
        sel = np.flatnonzero(tr.world_of == w)
        cpu.bulk_add_subscriptions(f"world_{w}", [peers[i] for i in sel],
                                   tr.cubes[sel])
    batch = [LocalQuery(f"world_{msg.worlds[q]}", Vector3(*msg.positions[q]),
                        peers[msg.senders[q]], Replication(int(msg.repls[q])),
                        int(msg.kinds[q]), tuple(msg.params[q]))
             for q in range(tr.m)]
    from wqlbench.harness import canonical

    port = [canonical(a) for a in cpu.match_local_batch(batch)]
    want = ref.queries(table, msg.worlds, msg.positions, msg.senders,
                       msg.repls, msg.kinds, msg.params, stencil_max=3,
                       ray_steps=64)
    assert port == want


def test_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in ("numpy", "__future__"), (path, n)
