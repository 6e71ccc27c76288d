"""Two-process ``torch.distributed`` run of the port's mesh index
(parallel/mesh.py, parallel/sharded_backend.py) — the counterpart of
the JAX package's ``tests/test_mesh_distributed.py``.

Two REAL processes (``worldql_server_tpu_torch/tools/mesh_drive.py``)
join one gloo process group over the ``WQL_DIST_*`` environment
variables (the contract a multi-process deployment uses, through the
same ``maybe_initialize_distributed()`` the server boot calls), form
the fan-out mesh over both processes' devices — one CPU each, so the
mesh is 1 x 2 with the ``space`` axis split across the ranks — and run
one real sharded batch: the same seeded index in both (a base segment
folded on the device, a delta segment, tombstones), the dense and the
CSR dispatch, each rank matching its own shard and the merge one
``all_reduce(MAX)``. Rank 0 holds the result to the single-process
1 x 2 mesh on virtual CPU shards (exact) and to the port's
``CpuSpatialBackend`` (as sets); both ranks must end with the same
merged result. If the runtime refuses the group, the test SKIPS with
the runtime's own refusal as its reason.

Tolerance: exact (integer results; fan-out as sets against the oracle).
"""

import pytest

from worldql_server_tpu_torch.tools.mesh_drive import spawn


def test_two_process_gloo_mesh_parity():
    outs = spawn(2, device="cpu", timeout=180)
    for out in outs:
        if not out["ok"] and "world_size" not in out:
            # the group never formed: the runtime's own refusal
            pytest.skip(f"two-process gloo group refused: {out['error']}")
    for out in outs:
        assert out["ok"], out
        assert out["world_size"] == 2 and out["backend"] == "gloo"
        assert out["mesh"] == {"batch": 1, "space": 2}
        assert out["ranks"] == [[0, 1]]
        assert out["local"] == [[0, out["rank"]]]
        assert out["segments"] == ["base", "delta"]
        assert min(out["shard_rows"]) > 0  # both shards hold base rows
    assert outs[0]["checked"]
    assert outs[0]["fanout"] > 0
    # one all-reduce merged the shards: both ranks hold the same result
    assert outs[0]["digest"] == outs[1]["digest"]
