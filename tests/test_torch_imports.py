"""The port stands alone: no module under ``worldql_server_tpu_torch/``
and not ``chip_smoke.py`` imports ``jax`` or the JAX package, the port
imports with both poisoned in ``sys.modules``, and its default device
is ``cuda`` — asking for it on a host without a card raises.

``jax`` is imported at interpreter start-up in this environment (see
tests/conftest.py), so only poisoning ``sys.modules`` in a fresh
process shows that the port never reaches for it.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
import torch

from worldql_server_tpu_torch.spatial import torchconf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "worldql_server_tpu")


def _port_files():
    root = os.path.join(REPO, "worldql_server_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = list(_port_files())
    assert len(files) > 60
    bad = [
        (os.path.relpath(f, REPO), root)
        for f in files for root in _imported_roots(f) if root in FORBIDDEN
    ]
    assert bad == []


def test_port_imports_with_jax_and_the_jax_package_poisoned():
    code = (
        "import sys\n"
        "for name in [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'worldql_server_tpu'))]:\n"
        "    del sys.modules[name]\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['worldql_server_tpu'] = None\n"
        "import worldql_server_tpu_torch.__main__\n"
        "import worldql_server_tpu_torch.engine.server\n"
        "import worldql_server_tpu_torch.entities.plane\n"
        "import worldql_server_tpu_torch.ops.tick\n"
        "import worldql_server_tpu_torch.ops.knn\n"
        "import worldql_server_tpu_torch.ops.index\n"
        "import worldql_server_tpu_torch.spatial.cuda_backend\n"
        "import worldql_server_tpu_torch.spatial.precompile\n"
        "import worldql_server_tpu_torch.observability.device\n"
        "import worldql_server_tpu_torch.tools.index_bench\n"
        "from worldql_server_tpu_torch.spatial import CudaSpatialBackend\n"
        "CudaSpatialBackend(16, device='cpu')\n"
        "import worldql_server_tpu_torch.transports.zeromq\n"
        "import worldql_server_tpu_torch.transports.http\n"
        "import worldql_server_tpu_torch.transports.websocket\n"
        "import worldql_server_tpu_torch.delivery.plane\n"
        "import worldql_server_tpu_torch.delivery.worker\n"
        "import worldql_server_tpu_torch.interest.manager\n"
        "import worldql_server_tpu_torch.interest.replay\n"
        "import worldql_server_tpu_torch.robustness.sessions\n"
        "import worldql_server_tpu_torch.robustness.overload\n"
        "import worldql_server_tpu_torch.spatial.snapshot\n"
        "import worldql_server_tpu_torch.storage.pgwire\n"
        "import worldql_server_tpu_torch.storage.postgres_store\n"
        "import worldql_server_tpu_torch.observability.slo\n"
        "import worldql_server_tpu_torch.observability.incidents\n"
        "import worldql_server_tpu_torch.cluster\n"
        "import worldql_server_tpu_torch.cluster.dump_client\n"
        "import worldql_server_tpu_torch.cluster.federation\n"
        "import worldql_server_tpu_torch.cluster.tracectx\n"
        "import worldql_server_tpu_torch.cluster.resharding\n"
        "import worldql_server_tpu_torch.scenarios\n"
        "import worldql_server_tpu_torch.scenarios.__main__\n"
        "from worldql_server_tpu_torch.scenarios import CATALOG\n"
        "assert len(CATALOG) == 11\n"
        "import worldql_server_tpu_torch.parallel\n"
        "import worldql_server_tpu_torch.parallel.mesh\n"
        "import worldql_server_tpu_torch.parallel.sharded_backend\n"
        "from worldql_server_tpu_torch.parallel import (\n"
        "    ShardedCudaSpatialBackend, make_fanout_mesh)\n"
        "ShardedCudaSpatialBackend(\n"
        "    16, make_fanout_mesh(2, 2, devices=['cpu'] * 4))\n"
        "print('ok')\n"
    )
    env = dict(os.environ, WQL_TORCH_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.delenv(torchconf.DEVICE_ENV, raising=False)
    assert torchconf.DEFAULT_DEVICE == "cuda"
    if torch.cuda.is_available():
        assert torchconf.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            torchconf.resolve_device()


def test_cpu_is_chosen_only_when_asked(monkeypatch):
    monkeypatch.setenv(torchconf.DEVICE_ENV, "cpu")
    assert torchconf.resolve_device().type == "cpu"
    monkeypatch.delenv(torchconf.DEVICE_ENV)
    assert torchconf.resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            torchconf.resolve_device("cuda")
