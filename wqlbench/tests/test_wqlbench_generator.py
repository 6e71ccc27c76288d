"""The traffic generator repeats exactly from a seed."""

import json

import numpy as np
import pytest

from wqlbench.generator import Traffic, point_in_cube
from wqlbench.harness import PKG
from wqlbench.reference.quantize import cube_labels


def _load(kind, name):
    return json.loads((PKG / kind / f"{name}.json").read_text())


def _ticks(config, mix, seed, n=4):
    tr = Traffic(_load("configs", config), _load("traffic", mix), seed,
                 scale=256)
    out = [tr.positions.copy(), tr.cubes.copy()]
    for t in range(n):
        mv = tr.moves(t)
        msg = tr.messages(t)
        out += [msg.worlds, msg.positions, msg.senders, msg.repls]
        if msg.kinds is not None:
            out += [msg.kinds, msg.params]
        if mv is not None:
            out += [mv.idx, mv.old, mv.new]
    return out


@pytest.mark.parametrize("config,mix", [
    ("crowd1m", "local"), ("crowd1m", "queries"), ("crowd1m", "churn"),
    ("zones64", "local")])
def test_same_seed_same_inputs(config, mix):
    a = _ticks(config, mix, 2**31 + 7)
    b = _ticks(config, mix, 2**31 + 7)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = _ticks(config, mix, 2**31 + 8)
    assert any(x.shape != y.shape or not np.array_equal(x, y)
               for x, y in zip(a, c))


def test_ticks_must_be_taken_in_order():
    tr = Traffic(_load("configs", "crowd1m"), _load("traffic", "churn"), 1,
                 scale=256)
    tr.moves(0)
    with pytest.raises(ValueError):
        tr.moves(2)


def test_messages_come_from_the_senders_cubes():
    tr = Traffic(_load("configs", "crowd1m"), _load("traffic", "local"), 3,
                 scale=16)
    msg = tr.messages(0)
    own = cube_labels(msg.positions, tr.cube)
    same = np.all(own == tr.cubes[msg.senders], axis=1)
    # every message not drawn as a miss speaks from its sender's cube
    assert same.mean() > 0.75
    assert len(np.unique(msg.senders)) == len(msg.senders)


def test_point_in_cube_stays_in_its_cube():
    rng = np.random.default_rng(0)
    cubes = cube_labels(rng.uniform(-900, 900, (50_000, 3)), 16)
    # (u next to 1 can round onto the cube's lower face; the generator
    # then speaks from the sender's own position instead)
    for u in (rng.random(cubes.shape), np.zeros(cubes.shape)):
        got = cube_labels(point_in_cube(cubes, 16, u), 16)
        np.testing.assert_array_equal(got, cubes)


def test_churn_moves_one_cube_along_one_axis():
    tr = Traffic(_load("configs", "crowd1m"), _load("traffic", "churn"), 4,
                 scale=64)
    mv = tr.moves(0)
    assert mv.idx.size == tr.movers == round(tr.n * 0.01)
    step = np.abs(mv.new - mv.old)
    # a unit step crosses one cube face, except across the origin, where
    # the labels jump from -16 to +16
    assert np.all((step != 0).sum(axis=1) == 1)
    assert set(np.unique(step[step != 0])) <= {16, 32}
    np.testing.assert_array_equal(tr.cubes[mv.idx], mv.new)


def test_query_params_in_their_ranges():
    mix = _load("traffic", "queries")
    tr = Traffic(_load("configs", "crowd1m"), mix, 5, scale=16)
    msg = tr.messages(0)
    kinds, p = msg.kinds, msg.params
    assert np.array_equal(kinds, np.arange(tr.m) % 5)
    cone = p[kinds == 1]
    assert np.allclose(np.linalg.norm(cone[:, :3], axis=1), 1.0)
    assert cone[:, 4].min() >= 12.0 and cone[:, 4].max() <= 48.0
    knn = p[kinds == 3]
    assert knn[:, 0].min() >= 1 and knn[:, 0].max() <= 11
    dens = p[kinds == 4]
    assert set(np.unique(dens[:, 0])) <= {1.0, 2.0}


def test_a_mix_names_its_own_generator_file(tmp_path, monkeypatch):
    from wqlbench import generator

    from .test_wqlbench_harness import HOT_CUBE

    (tmp_path / "hot_cube.py").write_text(HOT_CUBE)
    monkeypatch.setattr(generator, "TRAFFIC", tmp_path)
    mix = dict(_load("traffic", "local"), generator="hot_cube.py")
    tr = Traffic(_load("configs", "crowd1m"), mix, 9, scale=256)
    plain = Traffic(_load("configs", "crowd1m"), _load("traffic", "local"),
                    9, scale=256)
    for t in range(4):
        assert tr.moves(t) is None
        msg, base = tr.messages(t), plain.messages(t)
        if t % 2:
            assert np.unique(msg.senders).size == 1
        else:
            np.testing.assert_array_equal(msg.senders, base.senders)
    with pytest.raises(ValueError):
        Traffic(_load("configs", "crowd1m"),
                dict(mix, generator="../generator.py"), 9, scale=256)
