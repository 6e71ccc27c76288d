"""The port's ``ResilientBackend`` around its ``CudaSpatialBackend`` (on
the CPU), against the JAX package's ``ResilientBackend`` around its
``TpuSpatialBackend`` (JAX on the CPU): each scenario runs on both
packages from the same seeded subscriptions and forced failpoints, and
the two transcripts — every resolved batch, the failure, rebuild and
failover counts, the metrics — must be equal; each batch is also held to
an independent cpu index.

The cases are those of ``tests/test_resilient_backend.py`` (containment,
rebuild, failover, bricked inner backends, the mirror's snapshot
surface, the ticker integration) and the kind-query degradation of
``tests/test_queries.py``. Tolerance: exact (peer sets per query; kind
results by kind, peers and extra).
"""

from __future__ import annotations

import asyncio
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

import worldql_server_tpu.engine.metrics as j_metrics
import worldql_server_tpu.engine.peers as j_peers
import worldql_server_tpu.engine.ticker as j_ticker
import worldql_server_tpu.protocol as j_protocol
import worldql_server_tpu.protocol.types as j_types
import worldql_server_tpu.robustness.failpoints as j_failpoints
import worldql_server_tpu.robustness.resilient as j_resilient
import worldql_server_tpu.spatial.backend as j_backend
import worldql_server_tpu.spatial.cpu_backend as j_cpu
import worldql_server_tpu_torch.engine.metrics as t_metrics
import worldql_server_tpu_torch.engine.peers as t_peers
import worldql_server_tpu_torch.engine.ticker as t_ticker
import worldql_server_tpu_torch.protocol as t_protocol
import worldql_server_tpu_torch.protocol.types as t_types
import worldql_server_tpu_torch.robustness.failpoints as t_failpoints
import worldql_server_tpu_torch.robustness.resilient as t_resilient
import worldql_server_tpu_torch.spatial.backend as t_backend
import worldql_server_tpu_torch.spatial.cpu_backend as t_cpu
from worldql_server_tpu.spatial.tpu_backend import TpuSpatialBackend
from worldql_server_tpu_torch.spatial.cuda_backend import CudaSpatialBackend
from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch
from worldql_server_tpu_torch.tools.index_bench import (
    mixed_cols, query_results_match)

CUBE = 16


def _pkg(types, backend, cpu, resilient, failpoints, metrics, peers,
         ticker, protocol, device):
    return SimpleNamespace(
        Vector3=types.Vector3, Replication=types.Replication,
        LocalQuery=backend.LocalQuery, Cpu=cpu.CpuSpatialBackend,
        Resilient=resilient.ResilientBackend, failpoints=failpoints,
        Metrics=metrics.Metrics, Peer=peers.Peer, PeerMap=peers.PeerMap,
        TickBatcher=ticker.TickBatcher, Instruction=protocol.Instruction,
        Message=protocol.Message, deserialize=protocol.deserialize_message,
        Device=device,
    )


PORT = _pkg(t_types, t_backend, t_cpu, t_resilient, t_failpoints, t_metrics,
            t_peers, t_ticker, t_protocol,
            lambda: CudaSpatialBackend(CUBE, device="cpu"))
JAX = _pkg(j_types, j_backend, j_cpu, j_resilient, j_failpoints, j_metrics,
           j_peers, j_ticker, j_protocol, lambda: TpuSpatialBackend(CUBE))


@pytest.fixture(autouse=True)
def clean_registries():
    for pkg in (PORT, JAX):
        pkg.failpoints.registry.reset()
    yield
    for pkg in (PORT, JAX):
        pkg.failpoints.registry.reset()


PEERS = [uuid.UUID(int=0x5000 + i) for i in range(6)]


def make_world(pkg, backend):
    """n peers across two cubes of "w"; every third also in "other"."""
    for i, p in enumerate(PEERS):
        backend.add_subscription(
            "w", p, pkg.Vector3(5.0 + 16 * (i % 2), 1.0, 1.0))
        if i % 3 == 0:
            backend.add_subscription("other", p, pkg.Vector3(1.0, 1.0, 1.0))
    backend.flush()


def queries_for(pkg):
    V, R, Q = pkg.Vector3, pkg.Replication, pkg.LocalQuery
    return [
        Q("w", V(5.0, 1.0, 1.0), PEERS[0], R.EXCEPT_SELF),
        Q("w", V(21.0, 1.0, 1.0), PEERS[1], R.INCLUDING_SELF),
        Q("other", V(1.0, 1.0, 1.0), PEERS[3], R.ONLY_SELF),
        Q("w", V(500.0, 1.0, 1.0), PEERS[0], R.EXCEPT_SELF),
    ]


def resolve(backend, queries):
    return [sorted(str(u) for u in row) for row in backend.collect_local_batch(
        backend.dispatch_local_batch(queries))]


def reference(pkg):
    ref = pkg.Cpu(CUBE)
    make_world(pkg, ref)
    return resolve(ref, queries_for(pkg))


def on_both(scenario):
    """Run ``scenario(pkg)`` for the port and for JAX; their transcripts
    must be equal. Returns the port's."""
    port, ref = scenario(PORT), scenario(JAX)
    assert port == ref
    return port


def _status(backend):
    st = dict(backend.status())
    return st.pop("inner"), st


def test_collect_failures_fail_over_to_the_mirror():
    def scenario(pkg):
        metrics = pkg.Metrics()
        backend = pkg.Resilient(pkg.Device(), factory=pkg.Device,
                                failover_after=3, metrics=metrics)
        make_world(pkg, backend)
        queries = queries_for(pkg)
        expected = reference(pkg)
        out = [resolve(backend, queries) == expected]
        pkg.failpoints.registry.configure("backend.collect=error")
        for _ in range(3):
            out.append((resolve(backend, queries) == expected,
                        backend.total_failures, backend.rebuilds))
        inner, status = _status(backend)
        out.append((status, metrics.counters["resilience.failovers"],
                    metrics.counters["resilience.failures"]))
        pkg.failpoints.registry.reset()
        newcomer = uuid.UUID(int=0x77)
        backend.add_subscription("w", newcomer, pkg.Vector3(5.0, 1.0, 1.0))
        out.append(str(newcomer) in resolve(backend, queries)[0])
        here = pkg.Vector3(5.0, 1.0, 1.0)
        out.append(backend.query_cube("w", here)
                   == backend.mirror.query_cube("w", here))
        return out, inner

    out, inner = scenario(PORT)
    assert inner == "CudaSpatialBackend"
    assert out == scenario(JAX)[0]
    assert out[0] and all(ok for ok, *_ in out[1:4])
    assert out[3][1:] == (3, 2)  # failures 1, 2 rebuilt; the 3rd failed over
    assert out[4] == ({"degraded": True, "failed_over": True,
                       "consecutive_failures": 3, "failures": 3,
                       "rebuilds": 2, "degraded_batches": 3}, 1, 3)
    assert out[5] and out[6]


def test_dispatch_failure_rebuilds_the_device_index():
    def scenario(pkg):
        built = []

        def factory():
            built.append(pkg.Device())
            return built[-1]

        backend = pkg.Resilient(pkg.Device(), factory=factory,
                                failover_after=3)
        make_world(pkg, backend)
        queries = queries_for(pkg)
        expected = reference(pkg)
        pkg.failpoints.registry.configure("backend.dispatch=error:1:x1")
        out = [resolve(backend, queries) == expected,
               backend.failures, backend.rebuilds,
               backend.inner is built[-1]]
        out += [resolve(backend, queries) == expected, backend.failures,
                backend.failed_over, _status(backend)[1]]
        return out, type(backend.inner).__name__

    out, inner = scenario(PORT)
    assert inner == "CudaSpatialBackend"  # the REBUILT device index
    assert out == scenario(JAX)[0]
    assert out[:4] == [True, 1, 1, True]
    assert out[4:7] == [True, 0, False]


def _exploding(pkg):
    class Exploding(pkg.Cpu):
        """A backend whose every call raises once ``exploding`` is set:
        the bricked card."""

        exploding = False

        def _maybe(self):
            if self.exploding:
                raise RuntimeError("device is gone")

        def add_subscription(self, *a, **k):
            self._maybe()
            return super().add_subscription(*a, **k)

        def dispatch_local_batch(self, queries):
            self._maybe()
            return super().dispatch_local_batch(queries)

        def collect_local_batch(self, handle):
            self._maybe()
            return super().collect_local_batch(handle)

        def query_cube(self, *a):
            self._maybe()
            return super().query_cube(*a)

    return Exploding(CUBE)


def test_bricked_inner_backend_scenarios():
    """Mutations reach the mirror while the inner backend raises; with
    no factory the wrapper goes straight to failover; the snapshot
    surface and unsubscribes are served by the mirror."""
    def scenario(pkg):
        V, out = pkg.Vector3, []
        p, q = uuid.UUID(int=1), uuid.UUID(int=2)
        inner = _exploding(pkg)
        backend = pkg.Resilient(inner, failover_after=2)
        out.append(backend.add_subscription("w", p, V(1, 1, 1)))
        inner.exploding = True
        out.append(backend.add_subscription("w", q, V(1, 1, 1)))
        out.append(sorted(backend.query_cube("w", V(1, 1, 1))))
        queries = [pkg.LocalQuery("w", V(1, 1, 1), uuid.UUID(int=9),
                                  pkg.Replication.EXCEPT_SELF)]
        out += [resolve(backend, queries), resolve(backend, queries),
                backend.failed_over, backend.rebuilds,
                backend.total_failures]
        worlds, peers, _, _, _ = backend.export_rows()
        out += [worlds, sorted(peers), backend.subscription_count(),
                backend.world_names(), backend.cube_count("w")]
        plain = pkg.Resilient(pkg.Cpu(CUBE), failover_after=3)
        plain.add_subscription("w", p, V(1, 1, 1))
        plain.add_subscription("w", q, V(1, 1, 1))
        out += [plain.remove_subscription("w", q, V(1, 1, 1)),
                sorted(plain.query_cube("w", V(1, 1, 1))),
                plain.remove_peer(p), plain.query_cube("w", V(1, 1, 1)),
                plain.total_failures]
        return out

    out = on_both(scenario)
    assert out[2] == [uuid.UUID(int=1), uuid.UUID(int=2)]
    assert out[5] is True and out[6] == 0


def test_ticker_degrades_instead_of_dropping_ticks():
    def scenario(pkg):
        async def run():
            backend = pkg.Resilient(pkg.Device(), factory=pkg.Device,
                                    failover_after=2)
            peer_map = pkg.PeerMap()
            inbox = []
            sender, listener = uuid.UUID(int=10), uuid.UUID(int=11)

            async def send_raw(data):
                inbox.append(pkg.deserialize(data).parameter)

            await peer_map.insert(pkg.Peer(listener, "loop", send_raw,
                                           "test"))
            backend.add_subscription("w", listener, pkg.Vector3(5, 1, 1))
            backend.flush()
            ticker = pkg.TickBatcher(backend, peer_map, interval=3600)
            pkg.failpoints.registry.configure("backend.collect=error")
            for i in range(2):
                await ticker.enqueue(
                    pkg.Message(instruction=pkg.Instruction.LOCAL_MESSAGE,
                                sender_uuid=sender, world_name="w",
                                position=pkg.Vector3(5, 1, 1),
                                parameter=f"m{i}"),
                    pkg.LocalQuery("w", pkg.Vector3(5, 1, 1), sender,
                                   pkg.Replication.EXCEPT_SELF))
                await ticker.flush()
            pkg.failpoints.registry.reset()
            await ticker.stop()
            return inbox, backend.failed_over, backend.degraded_batches

        return asyncio.run(asyncio.wait_for(run(), 30))

    assert on_both(scenario) == (["m0", "m1"], True, 2)


def test_kind_queries_degrade_through_the_mirror():
    """A mixed kind batch with failpoints on each leg of the two-phase
    batch: dispatch fails, then collect fails — both answered through
    the mirror's oracles — then the device path again; every lane
    equals the cpu index and the JAX wrapper's."""
    rng = np.random.default_rng(19)
    positions = rng.uniform(-40.0, 40.0, (24, 3))
    cubes = cube_coords_batch(positions, CUBE)
    peers = [uuid.UUID(int=0x1000 + i) for i in range(24)]
    m = 20
    senders = rng.integers(0, len(peers), m)
    kinds, params = mixed_cols(rng, m)
    pos = np.ascontiguousarray(positions[senders], np.float64)

    def scenario(pkg):
        inner = pkg.Device()
        backend = pkg.Resilient(inner, failover_after=5)
        backend.bulk_add_subscriptions("world_0", peers, cubes)
        inner.flush()
        inner.wait_compaction()
        oracle = pkg.Cpu(CUBE)
        oracle.bulk_add_subscriptions("world_0", peers, cubes)
        wid = np.full(m, inner._world_ids["world_0"], np.int32)
        sid = np.array([inner._peer_ids[peers[s]] for s in senders],
                       np.int32)
        repl = np.zeros(m, np.int8)
        fallback = [(None, pkg.LocalQuery(
            "world_0", pkg.Vector3(*pos[i]), peers[senders[i]],
            pkg.Replication.EXCEPT_SELF, kind=int(kinds[i]),
            params=tuple(params[i]))) for i in range(m)]
        want = oracle.match_local_batch([q for _, q in fallback])
        out = []
        for leg in ("backend.dispatch", "backend.collect", None):
            if leg is not None:
                pkg.failpoints.registry.set(leg, "error:1:x1")
            got = backend.collect_local_batch(backend.dispatch_staged_batch(
                wid, pos, sid, repl, kinds, params, fallback=fallback))
            assert all(query_results_match(g, w) for g, w in zip(got, want))
            out.append((backend.degraded_batches, backend.failed_over,
                        [(int(r.kind), list(r.peers), r.extra)
                         if hasattr(r, "extra") else sorted(r)
                         for r in got]))
        return out

    out = on_both(scenario)
    assert [o[:2] for o in out] == [(1, False), (2, False), (2, False)]
