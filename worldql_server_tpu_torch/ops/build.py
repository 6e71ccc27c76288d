"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/kernels/`` beside the package (listed in
``.gitignore``), keyed by the hash of its source and flags, and loaded
with ``ctypes``. No PyTorch headers are included, so a build takes
seconds. Nothing here runs at import time: the CPU test suite imports
every module on a host without ``nvcc``.

``--fmad=false`` is part of every build: the kernels reproduce f32
arithmetic bit for bit against their plain PyTorch versions, and a
contracted multiply-add changes the rounding. ``-Xptxas -v`` is too:
ptxas's report of each kernel's registers, spills and shared memory is
kept beside the library (``<library>.ptxas.txt``) and parsed by
``ptxas_report``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: seconds each library took to compile in this process (0.0 = cached)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from csrc/ at first use on the card"
    )


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def keyed_path(src_path: str, stem: str) -> str:
    """Where a source builds to: keyed by its bytes + the flags."""
    with open(src_path, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to."""
    return keyed_path(source_path(name), name)


def build_file(src_path: str, stem: str) -> str:
    """Compile one ``.cu`` file with the port's flags unless its keyed
    library exists; ptxas's report goes beside it. Returns the library
    path; raises with nvcc's output on failure."""
    out = keyed_path(src_path, stem)
    if os.path.exists(out):
        build_seconds.setdefault(stem, 0.0)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src_path} (rc={proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        with open(out + ".ptxas.txt", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[stem] = time.perf_counter() - t0
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists."""
    return build_file(source_path(name), name)


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores")
_USED = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> dict[str, dict]:
    """``-Xptxas -v`` output → {mangled kernel name: {"regs",
    "spill_bytes" (spill stores), "lines" (its stack-frame and usage
    lines, shared memory and barriers included)}}."""
    out: dict[str, dict] = {}
    cur = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {
                "regs": None, "spill_bytes": 0, "lines": []})
            continue
        if cur is None:
            continue
        spill, used = _SPILL.search(line), _USED.search(line)
        if spill:
            cur["spill_bytes"] = int(spill.group(1))
        if used:
            cur["regs"] = int(used.group(1))
        if spill or used:
            cur["lines"].append(line.strip())
    return out


def ptxas_report(lib_path: str) -> dict[str, dict]:
    """The parsed ``-Xptxas -v`` report kept beside a built library."""
    with open(lib_path + ".ptxas.txt") as f:
        return parse_ptxas(f.read())


def load(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build(name))
        return lib
