"""Observability: structured progress logging + phase timers + counters.

Replaces the reference's timestamped stdout logger (lib/base/logger.ml:3-9),
its ``Node: %05s Priority: %3d - msg`` progress lines
(lib/base/job_processor.ml:125-126), and the ``echo Start-Single`` date
stamps injected into task scripts (lib/base/mugsy_task.ml:22-36) with an
in-process metrics registry.
"""
from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


def timestamp() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())


class Logger:
    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream or sys.stderr
        self.enabled = enabled
        self._lock = threading.Lock()

    def log(self, msg: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.stream.write(f"{timestamp()} {msg}\n")
            self.stream.flush()

    def node(self, node: str, priority: int, msg: str) -> None:
        self.log(f"Node: {node:>5s} Priority: {priority:3d} - {msg}")


@dataclass
class PhaseStats:
    count: int = 0
    total_s: float = 0.0
    total_items: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class TraceRecorder:
    """Chrome trace-event recorder (chrome://tracing / Perfetto format).

    The reference's only tracing was date-stamp echoes in task scripts;
    here every metrics phase becomes a complete ("X") event with real
    thread ids, so scheduler overlap is directly visible.  Disabled until
    `enable()`; `save()` writes the JSON file.
    """

    def __init__(self):
        self.enabled = False
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def enable(self) -> None:
        self.enabled = True
        self._t0 = time.perf_counter()

    def add_complete(self, name: str, start_s: float, dur_s: float) -> None:
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "X",
            "ts": round((start_s - self._t0) * 1e6, 1),
            "dur": round(dur_s * 1e6, 1),
            "pid": 0,
            "tid": threading.get_ident() % 100000,
        }
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str) -> None:
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "i",
            "ts": round((time.perf_counter() - self._t0) * 1e6, 1),
            "pid": 0,
            "tid": threading.get_ident() % 100000,
            "s": "t",
        }
        with self._lock:
            self._events.append(ev)

    def save(self, path: str) -> None:
        import json

        with self._lock:
            events = list(self._events)
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


class Metrics:
    """Thread-safe phase timing + throughput counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.phases: dict[str, PhaseStats] = {}

    @contextmanager
    def phase(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            TRACE.add_complete(name, t0, dt)
            with self._lock:
                st = self.phases.setdefault(name, PhaseStats())
                st.count += 1
                st.total_s += dt
                st.total_items += items

    def add(self, name: str, seconds: float, items: int = 0) -> None:
        with self._lock:
            st = self.phases.setdefault(name, PhaseStats())
            st.count += 1
            st.total_s += seconds
            st.total_items += items

    def report(self) -> str:
        lines = [f"{'phase':<24}{'count':>8}{'total_s':>10}{'mean_s':>10}{'items':>10}"]
        with self._lock:
            for name in sorted(self.phases):
                st = self.phases[name]
                lines.append(
                    f"{name:<24}{st.count:>8}{st.total_s:>10.2f}"
                    f"{st.mean_s:>10.3f}{st.total_items:>10}"
                )
        return "\n".join(lines)


LOGGER = Logger(enabled=False)
TRACE = TraceRecorder()
METRICS = Metrics()


class MemoryMonitor:
    """Periodic RSS sampler (the scripts/memory_monitor.sh role).

    The reference scraped `ps` for nucmer/mugsy RSS every 10 s; here a
    daemon thread samples /proc/self/status and keeps the peak.
    """

    def __init__(self, interval_s: float = 10.0):
        self.interval_s = interval_s
        self.peak_rss_kb = 0
        self.samples: list[tuple[float, int]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def _rss_kb() -> int:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1])
        except OSError:
            pass
        return 0

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            rss = self._rss_kb()
            self.samples.append((time.time(), rss))
            self.peak_rss_kb = max(self.peak_rss_kb, rss)

    def start(self) -> "MemoryMonitor":
        self.peak_rss_kb = self._rss_kb()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.peak_rss_kb = max(self.peak_rss_kb, self._rss_kb())
        return self.peak_rss_kb
