"""Timing and bounds of the stencil-kNN kernel on the card, and an A/B of
two builds of ``csrc/knn_select.cu`` in one process.

``chip_smoke.py`` takes its input generator, timer and bound from here.
Run alone (from the repository root, on a host with one card) it holds an
earlier version of the kernel source against the current one at the chip
check's two shapes, timing them in turns (old, new, new, old) on the same
inputs, and prints each build's ``-Xptxas -v`` lines and the SASS
instruction counts of the kernel instance each shape runs:

    python -m worldql_server_tpu_torch.tools.knn_bench --old OLD.cu

The old source must keep the C entry point ``wql_knn_select``. The result
is printed as one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import statistics
import subprocess

import numpy as np
import torch

from ..ops import build
from ..ops.knn import _bind, kernel_info, knn_select, knn_select_plain

#: device-memory rate by card (bytes/s): NVIDIA data sheets
_HBM_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12))
#: lanes a Hopper SM issues per clock: f32 add/multiply, and 32-bit
#: integer compare/select (CUDA C++ programming guide, throughput table,
#: compute capability 9.0)
_F32_LANES = 128
_INT_LANES = 64
#: the chip check's two shapes: (N, K), its input seed and launches timed
SHAPES = ((131_072, 32), (1_048_576, 8))
SEED = 20261016
ITERS = 30


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def card_rates() -> dict:
    """Peak rates of card 0: device memory (bytes/s) from its data
    sheet, f32 and integer issue (operations/s) from its SM count and
    its maximum SM clock."""
    name = torch.cuda.get_device_name(0)
    hbm = next((rate for key, rate in _HBM_RATE if key in name), None)
    if hbm is None:
        raise RuntimeError(f"no memory rate on record for card {name!r}")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"hbm": hbm, "f32": sms * _F32_LANES * mhz * 1e6,
            "int": sms * _INT_LANES * mhz * 1e6, "sms": sms,
            "max_sm_mhz": mhz}


def zipf_world(n, k, seed):
    """Sorted runs with Zipf-skewed lengths (over-full cubes occur),
    peers shared across rows, positions inside a 16-cube per run."""
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(1.6, n), 4 * k)
    starts = np.cumsum(lengths)
    n_runs = int(np.searchsorted(starts, n)) + 1
    rid = np.repeat(np.arange(n_runs, dtype=np.int32),
                    lengths[:n_runs])[:n]
    peer = rng.integers(0, max(n // 4, 1), n).astype(np.int32)
    pos = (rng.uniform(0, 16, (n, 3))
           + rid[:, None].astype(np.float64) * 16).astype(np.float32)
    rid[rng.random(n) < 0.001] = -1  # a few masked rows
    return rid, peer, pos


def cuda_time_ms(fn, iters, flush):
    """Median device time of ``fn`` over ``iters`` launches, each after
    a read of ``flush`` (a buffer larger than L2): the launch finds a
    cold L2 holding no dirty lines, as the tick finds it after its own
    sort, and no write-back of the eviction falls in the timed window."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.sum()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kept_candidates(rid, peer, k) -> int:
    """Candidates the rows of these inputs keep (same run, other peer,
    live row), over the 2K-2 offsets of the window."""
    n = rid.shape[0]
    h = k - 1
    fill = torch.full((h,), -1, dtype=torch.int32, device=rid.device)
    rid_p = torch.cat([fill, rid, fill])
    peer_p = torch.cat([fill, peer, fill])
    kept = 0
    for s in range(2 * k - 1):
        if s == h:
            continue
        same = ((rid_p[s:s + n] == rid) & (peer_p[s:s + n] != peer)
                & (rid >= 0))
        kept += int(same.sum())
    return kept


def knn_bound(rid, peer, k, rates) -> dict:
    """Least time for the kernel's work on these inputs, the larger of
    two terms. Bytes: rid, peer and pos read once, [N, K] ids written
    once, over the memory rate. Operations, each kind at the rate it
    issues: 8 f32 operations for each kept candidate's distance over the
    f32 rate, against ceil(log2 K) compares to place it among K over the
    integer rate (the two run on separate pipes, so the larger counts)."""
    n = rid.shape[0]
    nbytes = n * (4 + 4 + 12) + n * k * 4
    kept = kept_candidates(rid, peer, k)
    compares = kept * (k - 1).bit_length()
    t_bytes = nbytes / rates["hbm"] * 1e3
    t_f32 = kept * 8 / rates["f32"] * 1e3
    t_int = compares / rates["int"] * 1e3
    t_ops = max(t_f32, t_int)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "bytes_ms": t_bytes, "kept": kept,
            "f32_ops": kept * 8, "f32_ms": t_f32, "int_ops": compares,
            "int_ms": t_int}


_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(lib_path: str, mangled: str) -> dict:
    """Instruction counts of one kernel in ``cuobjdump -sass`` of a
    built library: the total without NOPs, and by opcode (modifiers
    dropped), largest first."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    funcs: dict[str, collections.Counter] = {}
    ops = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            ops = funcs.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSN.search(line)
        if m and ops is not None and not m.group(1).startswith("NOP"):
            ops[m.group(1).split(".")[0]] += 1
    ops = funcs[mangled]
    return {"total": sum(ops.values()), "by_opcode": dict(ops.most_common())}


def _insertion_only_kernel(lib_path: str, k: int) -> dict:
    """What the first version of the source (insertion kernel only, no
    wql_knn_kernel_info) launches for K: the insertion kernel at the
    smallest KMAX >= K from 8."""
    kmax = 8 << max(0, (k - 1).bit_length() - 3)
    pattern = f"knn_select_kernelILi{kmax}E"
    (mangled, rep), = [(name, v) for name, v in build.ptxas_report(
        lib_path).items() if pattern in name]
    return {"kernel": f"knn_select_kernel<{kmax}>", "regs": rep["regs"],
            "spill_bytes": rep["spill_bytes"], "ptxas": rep["lines"],
            "mangled": mangled}


def _run_lib(lib_path):
    fn = _bind(ctypes.CDLL(lib_path)).wql_knn_select

    def run(rid, peer, pos, k):
        out = torch.empty((rid.shape[0], k), dtype=torch.int32,
                          device=rid.device)
        err = fn(rid.data_ptr(), peer.data_ptr(), pos.data_ptr(),
                 rid.shape[0], k, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"old kernel launch failed: cudaError {err}")
        return out
    return run


def ab(old_src: str) -> dict:
    """Old build against the current one, in turns, at ``SHAPES``."""
    old_lib = build.build_file(old_src, "knn_select_old")
    new_lib = build.library_path("knn_select")
    runs = {"old": _run_lib(old_lib),
            "new": lambda rid, peer, pos, k: knn_select(rid, peer, pos, k=k)}
    rates = card_rates()
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rows = []
    for n, k in SHAPES:
        rid, peer, pos = (torch.from_numpy(a).cuda()
                          for a in zipf_world(n, k, SEED + n))
        want = knn_select_plain(rid, peer, pos, k=k)
        for name, run in runs.items():
            if not torch.equal(run(rid, peer, pos, k), want):
                raise AssertionError(f"{name} kernel != plain at N={n} K={k}")
        turns = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            turns[name].append(cuda_time_ms(
                lambda: runs[name](rid, peer, pos, k), ITERS, flush))
        old_info = (kernel_info(k, old_lib) if hasattr(
            ctypes.CDLL(old_lib), "wql_knn_kernel_info")
            else _insertion_only_kernel(old_lib, k))
        new_info = kernel_info(k)
        rows.append({
            "n": n, "k": k, "old_turns_ms": turns["old"],
            "new_turns_ms": turns["new"],
            "old_ms": statistics.median(turns["old"]),
            "new_ms": statistics.median(turns["new"]),
            **knn_bound(rid, peer, k, rates),
            "old_kernel": {**old_info, "sass": sass_counts(
                old_lib, old_info["mangled"])},
            "new_kernel": {**new_info, "sass": sass_counts(
                new_lib, new_info["mangled"])},
        })
    return {"card": card_line(), "device": torch.cuda.get_device_name(0),
            "rates": rates, "iters": ITERS, "shapes": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="an earlier knn_select.cu (entry wql_knn_select)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("knn_bench: torch sees no CUDA card")
    print(json.dumps(ab(args.old)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
