"""Structured throughput metrics and observability.

The reference's only measurement is criterion wall clock (SURVEY.md §5);
here per-batch and aggregate throughput are first-class: Gbp/s (giga base
pairs per second), GiB/s, reads/s, and cluster-wide scaling efficiency against a
single-host baseline — the BASELINE north-star metrics.  Emits structured
JSON lines so logs are machine-consumable.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time


@dataclasses.dataclass
class BatchStat:
    nt: int
    reads: int
    seconds: float


class ThroughputLogger:
    """Accumulates per-batch stats; logs JSON lines; reports aggregates."""

    def __init__(self, *, name: str = "encode", stream=None, log_every: int = 0):
        self.name = name
        self.stream = stream if stream is not None else sys.stderr
        self.log_every = log_every
        self.stats: list[BatchStat] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def batch_done(self, nt: int, reads: int) -> None:
        if self._t0 is None:
            raise RuntimeError("call start() before batch_done()")
        dt = time.perf_counter() - self._t0
        self.stats.append(BatchStat(nt, reads, dt))
        if self.log_every and len(self.stats) % self.log_every == 0:
            self.emit(
                {
                    "event": "batch",
                    "name": self.name,
                    "batch": len(self.stats),
                    "gbps": round(nt / dt / 1e9, 3),
                    "reads_per_s": round(reads / dt, 1),
                }
            )
        self._t0 = time.perf_counter()

    def emit(self, obj: dict) -> None:
        print(json.dumps(obj), file=self.stream, flush=True)

    @property
    def total_nt(self) -> int:
        return sum(s.nt for s in self.stats)

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.stats)

    def aggregate(self) -> dict:
        nt = self.total_nt
        secs = self.total_seconds or 1e-12
        return {
            "event": "aggregate",
            "name": self.name,
            "batches": len(self.stats),
            "total_nt": nt,
            "total_reads": sum(s.reads for s in self.stats),
            "seconds": round(secs, 6),
            "gbps": round(nt / secs / 1e9, 3),
            "gib_per_s": round(nt / secs / 2**30, 3),
            "reads_per_s": round(sum(s.reads for s in self.stats) / secs, 1),
        }


def scaling_efficiency(single_host_rps: float, n_hosts: int, pod_rps: float) -> float:
    """reads/s scaling efficiency vs linear (1.0 == perfectly linear)."""
    if single_host_rps <= 0 or n_hosts <= 0:
        return 0.0
    return pod_rps / (single_host_rps * n_hosts)
