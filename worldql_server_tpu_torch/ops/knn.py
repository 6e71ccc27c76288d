"""Stencil k-nearest selection for the simulation tick.

``knn_select`` replaces the JAX package's Pallas kernel
(``worldql_server_tpu/ops/knn_pallas.py::knn_select``). For CUDA tensors
it launches the hand-written kernel in ``csrc/knn_select.cu`` (its
header states the bound and the design); for CPU tensors it computes
the same function with ``knn_select_plain``, the pad + stack-of-slices +
packed row sort of the JAX tick's XLA stencil. There is no fallback
between the two: a CUDA tensor launches the kernel or raises.

Contract (identical in both versions and to the JAX kernels):
* candidates of sorted row i are rows i-(K-1) .. i+(K-1) with the same
  run id, a different peer, and ``rid[i] >= 0``;
* the key is (IEEE bits of the f32 ``dx*dx + dy*dy + dz*dz`` as u32,
  peer as i32), compared lexicographically — ties break by peer;
* invalid candidates carry (0xFFFFFFFF, -1), so NaN distances sort
  after finite ones and before invalid slots;
* the result is [N, K] i32 peer ids, nearest first, -1-padded.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

#: the kernels serve K up to this (csrc/knn_select.cu): the selection
#: network for K <= NETWORK_MAX_K, the insertion kernel above it
MAX_K = 256
NETWORK_MAX_K = 32

_INVALID = 0xFFFFFFFF
_LOW32 = 0xFFFFFFFF
_SIGN32 = 1 << 31


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.wql_knn_select
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        if hasattr(lib, "wql_knn_kernel_info"):
            info = lib.wql_knn_kernel_info
            info.argtypes = [ctypes.c_int, ctypes.c_void_p]
            info.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    return _bind(build.load("knn_select"))


def kernel_info(k: int, lib_path: str | None = None) -> dict:
    """Which kernel of ``csrc/knn_select.cu`` (or of the build at
    ``lib_path``) serves K, and what it holds on the card: ``kernel``
    (``knn_network_kernel<W, FULL>`` or ``knn_insert_kernel<KMAX>``),
    ``regs`` and ``local_bytes`` a thread and ``smem_bytes`` a block
    (from the runtime), ``spill_bytes`` and ``ptxas`` (its lines of the
    build's ``-Xptxas -v`` report), ``mangled`` (its symbol). Needs the
    card."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_select: k={k} outside [1, {MAX_K}]")
    if lib_path is None:
        lib, lib_path = _lib(), build.library_path("knn_select")
    else:
        lib = _bind(ctypes.CDLL(lib_path))
    info = (ctypes.c_int * 6)()
    err = lib.wql_knn_kernel_info(k, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"wql_knn_kernel_info failed: cudaError {err}")
    kind, width, full, regs, local_bytes, smem_bytes = info
    if kind == 0:
        name = f"knn_network_kernel<{width}, {('false', 'true')[full]}>"
        pattern = f"knn_network_kernelILi{width}ELb{full}E"
    else:
        name = f"knn_insert_kernel<{width}>"
        pattern = f"knn_insert_kernelILi{width}E"
    report = [(sym, v) for sym, v in build.ptxas_report(lib_path).items()
              if pattern in sym]
    if len(report) != 1:
        raise RuntimeError(f"no single ptxas entry for {pattern}")
    (mangled, rep), = report
    return {"kernel": name, "regs": regs,
            "local_bytes": local_bytes, "smem_bytes": smem_bytes,
            "spill_bytes": rep["spill_bytes"], "ptxas": rep["lines"],
            "mangled": mangled}


def knn_select_plain(rid: torch.Tensor, peer: torch.Tensor,
                     pos: torch.Tensor, *, k: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: materialize the [N, 2K-1]
    candidate window as a stack of shifted slices of the padded columns
    and row-sort one packed int64 per candidate.

    The packed key is ``(key - 2^31) * 2^32 + (peer + 2^31)``: the
    offset key (its top bit flipped) keeps the u32 order as a signed
    int64 order (a plain ``key << 32`` would turn negative for keys >=
    0x80000000 and sort the invalid key first), and the offset peer
    makes the low word's unsigned order the signed order of the peer."""
    n = rid.shape[0]
    h = k - 1
    w = 2 * k - 1
    dev = rid.device
    rid = rid.to(torch.int32)
    peer = peer.to(torch.int32)
    pos = pos.to(torch.float32)
    fill = torch.full((h,), -1, dtype=torch.int32, device=dev)
    rid_p = torch.cat([fill, rid, fill])
    peer_p = torch.cat([fill, peer, fill])
    zpos = torch.zeros((h, 3), dtype=torch.float32, device=dev)
    pos_p = torch.cat([zpos, pos, zpos])
    rid_w = torch.stack([rid_p[s:s + n] for s in range(w)], dim=1)
    peer_w = torch.stack([peer_p[s:s + n] for s in range(w)], dim=1)
    pos_w = torch.stack([pos_p[s:s + n] for s in range(w)], dim=1)
    same = (
        (rid_w == rid[:, None])
        & (peer_w != peer[:, None])
        & (rid[:, None] >= 0)
    )
    # explicit left-to-right sum of separately rounded products: a
    # reduction over the last axis may add in another order
    dx = pos_w[..., 0] - pos[:, None, 0]
    dy = pos_w[..., 1] - pos[:, None, 1]
    dz = pos_w[..., 2] - pos[:, None, 2]
    d2 = dx * dx + dy * dy + dz * dz
    bits = d2.view(torch.int32).to(torch.int64) & _LOW32
    key = torch.where(same, bits, torch.full_like(bits, _INVALID))
    val = torch.where(same, peer_w, torch.full_like(peer_w, -1))
    packed = (key - _SIGN32) * (1 << 32) + (val.to(torch.int64) + _SIGN32)
    packed = torch.sort(packed, dim=1).values[:, :k]
    return ((packed & _LOW32) - _SIGN32).to(torch.int32)


def knn_select(rid: torch.Tensor, peer: torch.Tensor, pos: torch.Tensor,
               *, k: int) -> torch.Tensor:
    """[N] i32 run ids (sorted order; -1 = masked row), [N] i32 peers,
    [N, 3] f32 positions → [N, K] i32 nearest co-run peers per row,
    nearest first, -1-padded. CUDA tensors launch the kernel; CPU
    tensors take ``knn_select_plain``."""
    if rid.device.type == "cpu":
        return knn_select_plain(rid, peer, pos, k=k)
    if rid.device.type != "cuda":
        raise ValueError(f"knn_select: unsupported device {rid.device}")
    n = rid.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_select: k={k} outside [1, {MAX_K}]")
    if rid.dtype != torch.int32 or peer.dtype != torch.int32:
        raise TypeError("knn_select: rid and peer must be int32")
    if pos.dtype != torch.float32:
        raise TypeError("knn_select: pos must be float32")
    if rid.shape != (n,) or peer.shape != (n,) or pos.shape != (n, 3):
        raise ValueError(
            "knn_select: want rid [N], peer [N], pos [N, 3]; got "
            f"{tuple(rid.shape)}, {tuple(peer.shape)}, {tuple(pos.shape)}"
        )
    if not (rid.device == peer.device == pos.device):
        raise ValueError("knn_select: inputs on different devices")
    if not (rid.is_contiguous() and peer.is_contiguous()
            and pos.is_contiguous()):
        raise ValueError("knn_select: inputs must be contiguous")
    if n >= 2**31:
        raise ValueError(f"knn_select: n={n} does not fit the kernel's int")
    out = torch.empty((n, k), dtype=torch.int32, device=rid.device)
    if n == 0:
        return out
    fn = _lib().wql_knn_select
    with torch.cuda.device(rid.device):
        stream = torch.cuda.current_stream(rid.device).cuda_stream
        err = fn(rid.data_ptr(), peer.data_ptr(), pos.data_ptr(), n, k,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"knn_select kernel launch failed: cudaError {err} "
            f"(n={n}, k={k})"
        )
    knn_select.launches += 1
    knn_select.shapes[(n, k)] = knn_select.shapes.get((n, k), 0) + 1
    return out


#: kernel launches since the last reset (chip_smoke resets it to 0
#: before driving the server and reads it after), and the same launches
#: by ``(N, K)``, so a check of the kernel can cover the shapes a path
#: gave it
knn_select.launches = 0
knn_select.shapes = {}
