"""The port's stencil kNN (``worldql_server_tpu_torch.ops.knn``) against
the JAX package's Pallas kernel (interpret mode, as its own tests run
it on the CPU) and the numpy oracle ``reference_knn``.

On CPU tensors the port's ``knn_select`` computes with its plain
version, so these tests hold the plain version — the function the CUDA
kernel is compared with on the card — to the reference. Tolerance:
exact (every output is an integer peer id).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from worldql_server_tpu.spatial import jaxconf  # noqa: F401
import jax.numpy as jnp

from tests.test_knn_pallas import make_world, reference_knn
from worldql_server_tpu.ops.knn_pallas import knn_select as jax_knn
from worldql_server_tpu_torch.ops.knn import knn_select, knn_select_plain


def _port(rid, peer, pos, k):
    out = knn_select(torch.from_numpy(rid), torch.from_numpy(peer),
                     torch.from_numpy(pos), k=k)
    assert out.dtype == torch.int32 and out.shape == (rid.shape[0], k)
    return out.numpy()


def _jax(rid, peer, pos, k, tile=128):
    return np.asarray(jax_knn(jnp.asarray(rid), jnp.asarray(peer),
                              jnp.asarray(pos), k=k, tile=tile,
                              interpret=True))


def _check(rid, peer, pos, k, tile=128):
    got = _port(rid, peer, pos, k)
    np.testing.assert_array_equal(got, reference_knn(rid, peer, pos, k))
    np.testing.assert_array_equal(got, _jax(rid, peer, pos, k, tile))
    return got


@pytest.mark.parametrize("n,k,runs", [
    (64, 4, 5), (500, 8, 30), (1000, 8, 400), (300, 16, 3),
])
def test_matches_pallas_and_reference(n, k, runs):
    rng = np.random.default_rng(n + k)
    _check(*make_world(rng, n, runs), k)


def test_masked_rows_and_halo():
    """rid -1 rows emit no targets and are never candidates; runs that
    cross a 64-row Pallas tile still resolve."""
    rng = np.random.default_rng(7)
    rid, peer, pos = make_world(rng, 256, 4)
    rid[:10] = -1
    rid[-5:] = -1
    got = _check(rid, peer, pos, 8, tile=64)
    assert (got[:10] == -1).all() and (got[-5:] == -1).all()


def test_nan_positions_sort_between_finite_and_invalid():
    """A NaN distance is kept (after every finite one, before the
    invalid sentinel), exactly as the Pallas kernel orders it."""
    rng = np.random.default_rng(3)
    rid, peer, pos = make_world(rng, 200, 6)
    pos[::17, 1] = np.nan
    got = _check(rid, peer, pos, 8)
    assert (got[::17] >= 0).any()


def test_heavy_ties_break_by_peer_id():
    """Integer grid positions: many equal distances, ordered by peer."""
    rng = np.random.default_rng(11)
    n = 400
    rid = np.sort(rng.integers(0, 12, n)).astype(np.int32)
    peer = rng.permutation(n).astype(np.int32)
    pos = rng.integers(-2, 3, (n, 3)).astype(np.float32)
    _check(rid, peer, pos, 16)


def test_duplicate_peer_ids_within_a_run():
    """A peer owns many entities: same-peer candidates are masked, and
    the same peer may fill several target lanes from other rows."""
    rng = np.random.default_rng(5)
    n = 300
    rid = np.sort(rng.integers(0, 8, n)).astype(np.int32)
    peer = rng.integers(0, 6, n).astype(np.int32)
    pos = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    got = _check(rid, peer, pos, 8)
    assert (got != peer[:, None]).all()


@pytest.mark.parametrize("k", [1, 2])
def test_window_edges(k):
    rng = np.random.default_rng(k)
    _check(*make_world(rng, 150, 4), k)


def test_k32_against_reference():
    """K=32 (the server phase's k): against the oracle only — the
    Pallas kernel's interpret-mode compile at K=32 takes minutes on the
    CPU; tests/test_torch_tick.py holds K=32 to the JAX XLA stencil."""
    rng = np.random.default_rng(32)
    rid, peer, pos = make_world(rng, 400, 6)
    np.testing.assert_array_equal(_port(rid, peer, pos, 32),
                                  reference_knn(rid, peer, pos, 32))


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(2)
    rid, peer, pos = make_world(rng, 128, 5)
    before = knn_select.launches
    got = _port(rid, peer, pos, 4)
    plain = knn_select_plain(torch.from_numpy(rid), torch.from_numpy(peer),
                             torch.from_numpy(pos), k=4).numpy()
    np.testing.assert_array_equal(got, plain)
    assert knn_select.launches == before  # no kernel launched on the CPU


# --- a CPU model of the CUDA network kernel (csrc/knn_select.cu) -------

_SIGN32 = 1 << 31


def _cx(col, i, j):
    """Compare-exchange of columns i and j: col[i] <= col[j] after."""
    lo, hi = torch.minimum(col[i], col[j]), torch.maximum(col[i], col[j])
    col[i], col[j] = lo, hi


def _sort_network(col, r):
    """knn_select.cu::sort_network: Batcher's odd-even merge sort of the
    first ``r`` columns, the same comparators in the same order."""
    n = len(col)
    log = n.bit_length() - 1
    for lp in range(log):
        p = 1 << lp
        for lk in range(lp, -1, -1):
            k = 1 << lk
            j0 = k % p
            for e in range(n):
                if (e + k < r and e >= j0 and (e - j0) % (2 * k) < k
                        and e // (2 * p) == (e + k) // (2 * p)):
                    _cx(col, e, e + k)


def _bitonic_merge(col):
    n = len(col)
    for lt in range(n.bit_length() - 2, -1, -1):
        for i in range(n):
            j = i ^ (1 << lt)
            if j > i:
                _cx(col, i, j)


def _network_model(rid, peer, pos, k):
    """Per-row schedule of ``knn_network_kernel<W>``, all rows at once:
    W = next_pow2(2K-1) slots of packed keys (the u64 (d2_bits << 32) |
    (peer ^ 0x80000000) less 2^63, so int64 order is its unsigned
    order), the invalid pair in the self, pad and dropped slots, both
    halves sorted ascending (odd-even merge sort; at K = W/2 the last
    slot of each half is left out of it), slot-wise minimum of the first
    half against the second reversed, bitonic merge,
    first K low words with the sign bit flipped back."""
    n = rid.shape[0]
    w = max(2, 1 << (2 * k - 2).bit_length())
    rid, peer, pos = (torch.from_numpy(a) for a in (rid, peer, pos))
    pad_l, pad_r = k - 1, w
    rid_p = torch.cat([torch.full((pad_l,), -1, dtype=torch.int32), rid,
                       torch.full((pad_r,), -1, dtype=torch.int32)])
    peer_p = torch.cat([torch.full((pad_l,), -1, dtype=torch.int32), peer,
                        torch.full((pad_r,), -1, dtype=torch.int32)])
    pos_p = torch.cat([torch.zeros((pad_l, 3)), pos, torch.zeros((pad_r, 3))])
    invalid = (0xFFFFFFFF - _SIGN32) * (1 << 32) + 0x7FFFFFFF
    col = []
    for s in range(w):
        q_rid, q_peer, q_pos = (a[s:s + n] for a in (rid_p, peer_p, pos_p))
        keep = ((rid >= 0) & (s <= 2 * k - 2) & (q_rid == rid)
                & (q_peer != peer))
        d = q_pos - pos
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        hi = (d2.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) - _SIGN32
        key = hi * (1 << 32) + (q_peer.to(torch.int64) + _SIGN32)
        col.append(torch.where(keep, key, torch.full_like(key, invalid)))
    h = w // 2
    r = h - 1 if 2 * k == w else h
    a, b = col[:h], col[h:]
    _sort_network(a, r)
    _sort_network(b, r)
    m = [torch.minimum(x, y) for x, y in zip(a, b[::-1])]
    _bitonic_merge(m)
    out = torch.stack(m[:k], dim=1)
    return ((out & 0xFFFFFFFF) - _SIGN32).to(torch.int32).numpy()


@pytest.mark.parametrize("k", [1, 2, 8, 16, 32])
def test_network_model_matches_plain_and_reference(k):
    """The kernel's algorithm, checked on the CPU before it runs on the
    card: masked rows, NaN distances, integer-grid ties, peers shared
    within runs, runs longer than the window."""
    rng = np.random.default_rng(100 + k)
    n = 300
    rid = np.sort(rng.integers(0, 6, n)).astype(np.int32)
    rid[::41] = -1
    peer = rng.integers(0, 40, n).astype(np.int32)
    pos = rng.integers(-3, 4, (n, 3)).astype(np.float32)
    pos[::23, 2] = np.nan
    got = _network_model(rid, peer, pos, k)
    plain = knn_select_plain(torch.from_numpy(rid), torch.from_numpy(peer),
                             torch.from_numpy(pos), k=k).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, reference_knn(rid, peer, pos, k))


def test_ptxas_report_parses_registers_and_spills():
    from worldql_server_tpu_torch.ops.build import parse_ptxas

    text = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118knn_"
        "network_kernelILi64EEEvPKiS2_PKfiiPi' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_118knn_"
        "network_kernelILi64EEEvPKiS2_PKfiiPi\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 392 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117knn_"
        "insert_kernelILi256EEEvPKiS2_PKfiiPi' for 'sm_90a'\n"
        "    2048 bytes stack frame, 1024 bytes spill stores, 512 bytes "
        "spill loads\n"
        "ptxas info    : Used 255 registers, 64 bytes smem, 392 bytes "
        "cmem[0]\n"
    )
    rep = parse_ptxas(text)
    net, ins = (next(v for name, v in rep.items() if key in name)
                for key in ("knn_network_kernelILi64E",
                            "knn_insert_kernelILi256E"))
    assert (net["regs"], net["spill_bytes"], len(net["lines"])) == (168, 0, 2)
    assert (ins["regs"], ins["spill_bytes"]) == (255, 1024)
    assert "64 bytes smem" in ins["lines"][-1]


def test_bound_counts_the_candidates_these_inputs_keep():
    """knn_bench's bound counts kept candidates as the oracle does, and
    the byte term binds at these rates."""
    from worldql_server_tpu_torch.tools.knn_bench import knn_bound, zipf_world

    k = 8
    rid, peer, pos = zipf_world(2000, k, 5)
    kept = 0
    for i in range(rid.shape[0]):
        for j in range(max(0, i - k + 1), min(rid.shape[0], i + k)):
            kept += bool(j != i and rid[i] >= 0 and rid[j] == rid[i]
                         and peer[j] != peer[i])
    rates = {"hbm": 3.35e12, "f32": 33.5e12, "int": 16.7e12}
    b = knn_bound(torch.from_numpy(rid), torch.from_numpy(peer), k, rates)
    assert b["kept"] == kept and b["int_ops"] == kept * 3
    assert b["bytes"] == 2000 * (20 + 4 * k) and b["bound_by"] == "bytes"
