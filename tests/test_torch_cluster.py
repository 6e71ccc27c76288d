"""The cluster tier: the port against the JAX package.

* The reference's process-free cases run once on each package (the port
  runs their source with the JAX package's imports pointed at the port,
  tests/torch_twin.py): ``WorldMap`` and the router's shed mirror
  (tests/test_cluster.py); the trace context, the bus frame, metrics
  federation and the shard's frame-stage accounting
  (tests/test_cluster_observability.py); placement, the chunk codec,
  epoch fences, stale frames, the kill-at-every-protocol-state property
  and parked-frame shedding (tests/test_resharding.py).
* Two tests spawn shard processes of the port (``python -m
  worldql_server_tpu_torch --cluster-role shard``, on the CPU through the
  inherited ``WQL_TORCH_DEVICE=cpu``), each under a 90 s deadline:
  - the reference's two-shard end to end (tests/test_cluster.py: cross-
    shard LocalMessage and GlobalMessage, WAL-durable records through a
    shard SIGKILL and restart, session resume, the drain inside the
    device window) run against the port's router and shards;
  - a live reshard of a world served by ``--entity-sim`` shards over the
    port's device index, through worldql_server_tpu_torch/tools/
    cluster_drive.py: each shard's ``/healthz`` names the CPU for its
    index and plane; every world's peers get entity frames; a probe
    LocalMessage per world reaches exactly the peers a single-process
    server gives; ``POST /reshard`` moves a world to the other shard and
    back, then moves a world the other way. The capsule the target
    imports counts what the source exported; the index rows
    (``export_rows``, sorted) and entity rows the second move exports
    from the target equal those the first exported from the source;
    every LocalMessage sent across the move reaches each subscriber
    exactly once; the world's peers get entity frames from the target
    after the flip; every record created before, during and after the
    move reads back; a world of the other shard then moves too, and its
    frames cross the inter-shard ring after the flip with none
    dropped.
* The reference's resharding faults that the port's copies fix are
  pinned as invariants checked on both packages (``torch_twin.pin``),
  and the port's fence flush is held to run no sim tick.

Tolerance: exact.
"""

from __future__ import annotations

import asyncio

import pytest

import tests.test_cluster as ref_cluster
import tests.test_cluster_observability as ref_obs
import tests.test_resharding as ref_reshard
from tests.torch_twin import call, case_id, cases, pin, port_module
from worldql_server_tpu_torch.robustness import failpoints as t_failpoints
from worldql_server_tpu_torch.tools.cluster_drive import drive_cluster

PORTS = {ref: port_module(ref)
         for ref in (ref_cluster, ref_obs, ref_reshard)}
CASES = [(ref, case) for ref, names in (
    (ref_cluster, ["test_world_map_stable_and_covering",
                   "test_shed_mirror_admission_classes"]),
    (ref_obs, ["test_tracectx_roundtrip_and_passthrough",
               "test_trace_ids_nonzero_and_hex_stable",
               "test_bus_frame_carries_trace_context",
               "test_federation_merges_aggregate_and_per_shard_series",
               "test_federation_restart_monotone_after_reset",
               "test_federation_freshness_and_per_core_gauge",
               "test_frame_stages_attribute_at_least_90_percent",
               "test_close_frames_observes_router_ingress_clock",
               "test_stitch_grafts_forward_and_ring_dwell_under_drain",
               "test_chrome_trace_names_process_lanes"]),
    (ref_reshard, ["test_placement_is_worldmap_at_epoch_zero",
                   "test_move_world_bumps_epoch_and_overrides_routing",
                   "test_spec_roundtrip_and_monotone_convergence",
                   "test_chunk_codec_roundtrip_reorder_and_repeat",
                   "test_chunk_codec_fails_loudly_on_corruption",
                   "test_transfer_buffer_bounded_counted_arrival_order",
                   "test_epoch_prefix_and_fence_wire_format",
                   "test_frame_stale_only_for_older_nonzero_epochs",
                   "test_stale_frame_for_moved_world_bounces_as_reroute",
                   "test_kill_at_every_protocol_state",
                   "test_parked_frames_shed_past_budget_counted"]),
) for case in cases(ref, names)]
DEADLINE_S = 90


@pytest.fixture(autouse=True)
def port_on_the_cpu(monkeypatch):
    """Shard processes inherit the environment: the port's device is
    the CPU here."""
    monkeypatch.setenv("WQL_TORCH_DEVICE", "cpu")
    t_failpoints.registry.reset()
    yield
    t_failpoints.registry.reset()


@pytest.mark.parametrize("ref,case", CASES,
                         ids=[case_id(c) for _, c in CASES])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_reference_case(pkg, ref, case, request):
    name, params = case
    module = ref if pkg == "jax" else PORTS[ref]
    call(getattr(module, name), params, request)


def test_port_cluster_end_to_end(tmp_path):
    """tests/test_cluster.py's end to end, on the port's router and
    shard processes."""
    port = PORTS[ref_cluster]
    asyncio.run(asyncio.wait_for(port._drain_cluster_e2e(tmp_path),
                                 DEADLINE_S))


def test_port_live_reshard_moves_an_entity_world():
    """tools/cluster_drive.py at a few hundred static entities on the
    CPU (chip_smoke.py drives it on the card at 60,000)."""
    report = asyncio.run(asyncio.wait_for(drive_cluster(
        n_entities=400, n_peers=8, moving=0.0, k=4, spread=24.0,
        device="cpu", move_back=True, move_large=True, tick_timeout_s=30,
        probe_timeout_s=20, extra_args=("--no-precompile-tiers",)),
        DEADLINE_S))
    mig = report["migration"]
    assert mig["exported"]["entities"] == 100
    assert mig["imported"]["subs"] == mig["exported"]["subs"] > 0
    assert report["move_back"]["exported"] == mig["exported"] | {
        "records": report["records"]}
    assert report["probes_across_move"] > 3
    assert report["moved_world_frames_after_flip"] > 0
    # shard 1's first world, far below one ring drain here: its frames
    # cross the ring from the target with none dropped
    large = report["move_large"]
    assert large["entities"] == 100 and large["frames_after_flip"] > 0
    assert large["ring"][large["target"]]["sent"] > 0
    assert [r["dropped"] for r in large["ring"]] == [0, 0]


def _control_datagrams_kept(ext_cls, n=6):
    """Run a shard's control loop on one end of a socket pair; send
    ``n`` datagrams, each followed by a tick that holds the event loop
    past the loop's poll timeout. Returns the datagrams handled."""
    import json
    import socket
    import time
    import types

    ours, theirs = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
    ours.setblocking(False)
    got = []

    async def handle(data):
        got.append(json.loads(data)["i"])

    async def scenario():
        stub = types.SimpleNamespace(
            _ctl=ours, _handle_control=handle,
            _maybe_push_state=lambda: None,
            server=types.SimpleNamespace(
                shutdown_requested=asyncio.Event()))
        task = asyncio.ensure_future(ext_cls._control_loop(stub))
        await asyncio.sleep(0.05)
        for i in range(n):
            theirs.send(json.dumps({"op": "x", "i": i}).encode())
            time.sleep(0.25)  # wql: allow(async-blocking-call) — a long tick holding the shard's loop, on purpose
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.3)
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)

    try:
        asyncio.run(scenario())
    finally:
        ours.close()
        theirs.close()
    return got


def test_control_loop_keeps_datagrams_through_long_ticks():
    """A fault of the reference, fixed in the port: the JAX shard's
    control loop cancels its receive on every 0.1 s poll timeout
    (``asyncio.wait_for``), which drops a datagram that arrives in the
    loop iteration the timer fires in — every datagram that lands
    during a tick longer than the poll. A dropped reshard chunk or
    export request stalls a migration until it aborts. The port keeps
    one receive pending across timeouts and handles every datagram."""
    from worldql_server_tpu.cluster.shard import (
        ClusterShardExtension as JExt)
    from worldql_server_tpu_torch.cluster.shard import (
        ClusterShardExtension as TExt)

    every = list(range(6))
    pin(_control_datagrams_kept(TExt) == every,
         _control_datagrams_kept(JExt) == every,
         "the control loop handles every datagram through long ticks")


def _fence_order(transport_cls, with_fast):
    """Feed a shard transport's batch classifier two frames, a freeze
    fence and one more frame; returns the events in order and the frames
    still waiting for the batch."""
    import types

    from worldql_server_tpu_torch.cluster.resharding.migration import (
        FENCE_MAGIC, fence_payload)

    events = []
    cluster = types.SimpleNamespace(
        FENCE_MAGIC=FENCE_MAGIC,
        unwrap=lambda data: (0, 0, 0, data),
        frame_stale=lambda epoch: False,
        on_fence=lambda data: events.append("fence ack"))

    class Fast:
        async def process_batch(self, datas, route, ctxs=None):
            events.append(("batch", list(datas)))

    transport = transport_cls.__new__(transport_cls)
    datas, ctxs = [], []

    async def scenario():
        for data in (b"a", b"b", fence_payload(7), b"c"):
            args = (cluster, data, datas, ctxs)
            await transport._absorb_inbound(
                *args, *((Fast(),) if with_fast else ()))

    asyncio.run(scenario())
    return events, datas


def test_fence_is_acked_after_the_frames_before_it():
    """A fault of the reference, fixed in the port: with the columnar
    fast path armed (``--entity-sim``), the JAX shard batches the frames
    of one receive and acks a freeze fence the moment it meets it,
    before the frames ahead of it in the same batch are applied. The
    router then exports the frozen world, and a record created just
    before the freeze is written on the source after the export and
    deleted with the source's copy of the world: lost (seen on the card
    at config 3's width, where a tick holds the shard for seconds). The
    port hands the batch on before the fence is acked."""
    from worldql_server_tpu.transports.zeromq import ZmqTransport as JZmq
    from worldql_server_tpu_torch.transports.zeromq import (
        ZmqTransport as TZmq)

    # the batch ahead of the fence handed on, then the ack; the frame
    # after the fence waits for the next batch
    want = ([("batch", [b"a", b"b"]), "fence ack"], [b"c"])
    pin(_fence_order(TZmq, with_fast=True) == want,
         # the reference's classifier takes no fast path to hand on to
         _fence_order(JZmq, with_fast=False) == want,
         "a fence is acked after the frames batched ahead of it")


def _chunks_streamed(migration, monkeypatch, busy_s=8.0):
    """Stream three capsule chunks to a target whose control socket is
    full for ``busy_s`` seconds (a fake clock: each refused send is half
    a second). Returns the chunks that got through."""
    import types

    clock = [0.0]
    sent = []

    class Supervisor:
        def ctl_send(self, shard, msg):
            clock[0] += 0.5
            if clock[0] < busy_s:
                return False
            sent.append(msg["chunk"])
            return True

    monkeypatch.setattr(migration, "time", types.SimpleNamespace(
        monotonic=lambda: clock[0]))
    router = types.SimpleNamespace(supervisor=Supervisor())
    coord = migration.MigrationCoordinator(router, "w", 0, 1, 7, 1 << 20)
    coord.chunks = [{"seq": i} for i in range(3)]
    asyncio.run(coord._stream_to_target())
    return sent


def test_chunk_stream_waits_out_a_busy_target(monkeypatch):
    """A fault of the reference, fixed in the port: the router gives up
    streaming a capsule when the target's control socket stays full for
    5 s, and the migration then aborts at its import timeout. A shard
    reads that socket between ticks, and at config 3's width a tick
    holds it for ~10 s (the card run that found it). The port keeps
    sending for as long as the import may take."""
    import worldql_server_tpu.cluster.resharding.migration as j_mig
    import worldql_server_tpu_torch.cluster.resharding.migration as t_mig

    every = [{"seq": 0}, {"seq": 1}, {"seq": 2}]
    pin(_chunks_streamed(t_mig, monkeypatch) == every,
         _chunks_streamed(j_mig, monkeypatch) == every,
         "the capsule stream waits out a busy target")


def _fence_events(ext_cls):
    """A shard extension's response to a freeze fence: the ticker
    flushes and control packets it sends, in order."""
    import types

    from worldql_server_tpu_torch.cluster.resharding.migration import (
        fence_payload)

    events = []

    class Ticker:
        async def flush(self, *, sim=True):
            await asyncio.sleep(0.01)
            events.append("ticker flush" + ("" if sim else ", no sim"))

    ext = ext_cls.__new__(ext_cls)
    ext.server = types.SimpleNamespace(
        ticker=Ticker(), metrics=types.SimpleNamespace(inc=lambda *a: None))
    ext._reshard_tasks = set()
    ext._ctl_send = lambda packet: events.append(packet["op"]) or True

    async def scenario():
        ext.on_fence(fence_payload(3))
        while ext._reshard_tasks:
            await asyncio.sleep(0.01)

    asyncio.run(scenario())
    return events


def test_fence_ack_follows_a_ticker_flush():
    """A fault of the reference, fixed in the port: a shard acks a
    freeze fence once the frames ahead of it are handled, but a handled
    LocalMessage may still wait in the ticker's queue. The world is then
    exported, moved and tombstoned on the source, and the queued message
    reaches no one (a LocalMessage sent as the move began was lost under
    CPU load). The port flushes the ticker before the ack, with no sim
    tick: the fence owes the queue its delivery, not a sim step off the
    timer's cadence."""
    from worldql_server_tpu.cluster.shard import (
        ClusterShardExtension as JExt)
    from worldql_server_tpu_torch.cluster.shard import (
        ClusterShardExtension as TExt)

    want = ["ticker flush, no sim", "fence_ack"]
    pin(_fence_events(TExt) == want, _fence_events(JExt) == want,
         "a fence is acked after the ticker's queue is delivered")


def test_fence_flush_delivers_the_queue_without_a_sim_tick():
    """The port's ``TickBatcher.flush(sim=False)``, which a shard runs
    before it acks a fence: with an active entity plane it resolves and
    delivers the queued message and dispatches no sim tick, where the
    timer's ``flush()`` dispatches one."""
    import types

    from worldql_server_tpu_torch.engine.ticker import TickBatcher
    from worldql_server_tpu_torch.protocol import Instruction, Message

    class Plane:
        dispatched = 0

        def active(self):
            return True

        def dispatch_tick(self):
            Plane.dispatched += 1
            raise RuntimeError("no sim on this stub")  # logged, skipped

    delivered = []

    async def deliver_batch(pairs, t_ingress_ns):
        delivered.extend(m.parameter for m, _ in pairs)

    backend = types.SimpleNamespace(
        dispatch_local_batch=lambda queries: queries,
        collect_local_batch=lambda handle: [[] for _ in handle])
    ticker = TickBatcher(backend, types.SimpleNamespace(
        deliver_batch=deliver_batch), interval=60.0, entity_plane=Plane())
    ticker._dispatch_batch = backend.dispatch_local_batch
    ticker._build_pairs = lambda batch, targets: [
        (m, t) for (m, _), t in zip(batch, targets)]

    async def scenario():
        ticker._queue.append((Message(
            instruction=Instruction.LOCAL_MESSAGE, parameter="queued"),
            None))
        await ticker.flush(sim=False)
        assert delivered == ["queued"] and Plane.dispatched == 0
        await ticker.flush(sim=False)   # nothing queued: nothing runs
        assert Plane.dispatched == 0
        await ticker.flush()
        assert Plane.dispatched == 1

    asyncio.run(scenario())
