"""Device health of the port: its breaker and heartbeat.

A copy of qatzip_tpu/engine/health.py.  The breaker (consecutive failures
trip it, a cooldown and one recovery probe close it) is the reference's
``DeviceHealth`` unchanged.  The optional active heartbeat
(QATZIP_TPU_HEARTBEAT_S seconds, 0 = off, the default) probes the port's
device: it makes a tiny tensor there and, on a CUDA device, synchronises.
"""
from __future__ import annotations

import os
import threading
import time

import torch

FAILURE_TRIP = 3          # consecutive failures that trip the breaker
COOLDOWN_S = 30.0         # breaker-open interval before a probe is allowed
PROBE_TIMEOUT_S = 10.0    # re-offer the probe slot if no outcome arrives


def probe(device: torch.device) -> None:
    """One heartbeat probe: a trivial op on ``device`` that must complete."""
    torch.zeros(8, dtype=torch.int32, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DeviceHealth:
    def __init__(self):
        self._lock = threading.Lock()
        self._consec_failures = 0
        self._tripped_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0
        self.total_failures = 0
        self._hb_thread: threading.Thread | None = None

    # -- outcome reporting --------------------------------------------------
    def record_success(self) -> None:
        with self._lock:
            self._consec_failures = 0
            self._tripped_at = 0.0
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self._consec_failures += 1
            self.total_failures += 1
            self._probe_inflight = False
            if self._consec_failures >= FAILURE_TRIP:
                self._tripped_at = time.monotonic()

    # -- routing gate -------------------------------------------------------
    def healthy(self) -> bool:
        """True if the device should receive requests right now.  After a
        trip + cooldown, exactly one caller is admitted as the recovery
        probe; its outcome closes or re-opens the breaker."""
        with self._lock:
            if self._consec_failures < FAILURE_TRIP:
                return True
            now = time.monotonic()
            if now - self._tripped_at < COOLDOWN_S:
                return False
            # Re-offer the probe slot after a timeout: an admitted probe can
            # be rerouted to the CPU by later gates (input_sz_thrshold,
            # devcal) and then never reports an outcome — without expiry the
            # device would stay blacklisted forever.
            if self._probe_inflight and now - self._probe_started < PROBE_TIMEOUT_S:
                return False
            self._probe_inflight = True  # this caller is the probe
            self._probe_started = now
            return True

    # -- optional active heartbeat -----------------------------------------
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


health = DeviceHealth()
