"""Device health of the port: its own breaker and heartbeat.

Port of qatzip_tpu/engine/health.py.  The breaker (consecutive failures
trip it, a cooldown and one recovery probe close it) is the reference's
``DeviceHealth``, inherited unchanged.  The optional active heartbeat
(QATZIP_TPU_HEARTBEAT_S seconds, 0 = off, the default) probes the port's
device: it makes a tiny tensor there and, on a CUDA device, synchronises.
"""
from __future__ import annotations

import os
import threading
import time

import torch

from qatzip_tpu.engine.health import DeviceHealth


def probe(device: torch.device) -> None:
    """One heartbeat probe: a trivial op on ``device`` that must complete."""
    torch.zeros(8, dtype=torch.int32, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GpuHealth(DeviceHealth):
    def start_heartbeat(self, device: torch.device) -> None:
        """Start the active probe thread if QATZIP_TPU_HEARTBEAT_S > 0."""
        interval = float(os.environ.get("QATZIP_TPU_HEARTBEAT_S", "0") or 0)
        if interval <= 0 or self._hb_thread is not None:
            return

        def loop():
            while True:
                time.sleep(interval)
                try:
                    probe(device)
                    self.record_success()
                except RuntimeError:
                    self.record_failure()

        t = threading.Thread(target=loop, name="qz-heartbeat", daemon=True)
        t.start()
        self._hb_thread = t


health = GpuHealth()
