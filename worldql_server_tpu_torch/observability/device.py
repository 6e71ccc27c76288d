"""Device telemetry: the per-tick timing split and the live-memory gauge.

Port of the JAX package's ``observability/device.py``. The server
builds it for any backend with ``device_stats`` (the ``cuda`` index)
when ``device_telemetry`` is on (the default):

* **Per-tick device split** — :meth:`DeviceTelemetry.on_tick` tags the
  tick root trace with the backend's ``last_device_timing`` (encode_ms
  / h2d_ms / compute_ms / d2h_ms: host-side brackets of the dispatch
  and collect, see spatial/cuda_backend.py) and feeds the
  ``device.{encode,h2d,compute,d2h}_ms`` histograms.
* **Live buffer gauge** — :func:`live_device_bytes` reads
  ``torch.cuda.memory_allocated`` for the backend's card at scrape time
  (the ``device`` gauge); a backend on the CPU reports 0.
* **Compile events** — the JAX package counts jit compiles and
  retraces here. Torch runs eagerly and compiles nothing, so
  ``compiles``, ``retraces`` and ``compile_ms_total`` keep their names
  and read 0.
"""

from __future__ import annotations

import torch


def live_device_bytes(device) -> int:
    """Bytes the caching allocator holds in live tensors on ``device``
    right now (0 for the CPU). Pull-gauge cost only: evaluated per
    /metrics scrape, never on the tick path."""
    if device is None or torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.memory_allocated(device))


class DeviceTelemetry:
    """Per-server device telemetry hub (one per WorldQLServer)."""

    def __init__(self, metrics=None, backend=None):
        self.metrics = metrics
        self.backend = backend

    def on_tick(self, trace) -> None:
        """Per-tick hook (TickBatcher._note_collect_stats)."""
        timing = getattr(self.backend, "last_device_timing", None)
        if not timing:
            return
        trace.tag(device_timing={
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in timing.items()
        })
        if self.metrics is not None:
            for leg in ("encode_ms", "h2d_ms", "compute_ms", "d2h_ms"):
                value = timing.get(leg)
                if isinstance(value, (int, float)):
                    self.metrics.observe_ms(
                        f"device.{leg}", max(float(value), 0.0)
                    )

    def stats(self) -> dict:
        """The ``device`` pull gauge."""
        return {
            "compiles": 0,
            "retraces": 0,
            "compile_ms_total": 0.0,
            "buffer_bytes": live_device_bytes(
                getattr(self.backend, "device", None)),
        }
