"""Profiling and roofline helpers (jax.profiler wrappers, device peaks).

The reference README does manual ns/iteration and port-pressure analysis
(reference README.md:383-402); the device equivalents are a profiler trace
(``jax.profiler``) and a bytes-based roofline: every codec op is integer
arithmetic over a byte stream, so its speed-of-light is device-memory
bandwidth divided by bytes moved.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import shutil
import subprocess


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace viewable in Perfetto/TensorBoard."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def parse_device_durations(log_dir: str) -> dict[str, list[float]]:
    """Per-kernel device durations of the newest :func:`trace` capture.

    Returns ``{kernel_name: [seconds, ...]}`` for every event on a
    ``/device:`` plane of the capture's ``.xplane.pb`` (on a GPU: one event
    per kernel launch, named after the XLA fusion or custom kernel, with
    the kernel's own start and duration).  A backend without device planes
    (the CPU) yields ``{}``.
    """
    import jax

    paths = sorted(glob.glob(f"{log_dir}/plugins/profile/*/*.xplane.pb"))
    if not paths:
        return {}
    out: dict[str, list[float]] = {}
    for plane in jax.profiler.ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.setdefault(ev.name, []).append(ev.duration_ns * 1e-9)
    return out


def measure_device_seconds(fn, *args, iters: int = 5, log_dir: str):
    """Mean device-busy seconds per call of a jitted ``fn``.

    Runs ``fn(*args)`` once to compile, then ``iters`` times under a trace,
    and divides the summed durations of every device event by ``iters``
    (kernels of one call run back to back on one stream, so the sum is the
    call's busy time).  Returns ``None`` when the backend recorded no
    device events.  ``log_dir`` is emptied before the capture.
    """
    import jax

    jax.block_until_ready(fn(*args))
    shutil.rmtree(log_dir, ignore_errors=True)
    with trace(log_dir):
        r = None
        for _ in range(iters):
            r = fn(*args)
        jax.block_until_ready(r)
    by_name = parse_device_durations(log_dir)
    if not by_name:
        return None
    return sum(sum(v) for v in by_name.values()) / iters


#: published peaks per ``device_kind`` (as ``jax.devices()[0].device_kind``
#: reports it): device-memory bytes/s and dense bf16 FLOP/s.  Source:
#: NVIDIA H100 SXM data sheet (dense, no sparsity), rated at 700 W — a card
#: set to a lower ``power.limit`` cannot hold its top clock under load, so
#: every measurement prints the limit beside it (:func:`gpu_name_power`).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12},
}


def peaks(device_kind: str) -> dict:
    """The peak table row for ``device_kind``; an unknown device raises."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device {device_kind!r}; add a row to "
            "utils.profiling.PEAKS with its source"
        ) from None


def gpu_name_power() -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for each card (the card
    and the power limit every reported rate is taken under)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found: no NVIDIA card to report")
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


@dataclasses.dataclass
class Roofline:
    """Bytes-moved model of one op at a given input size."""

    read_bytes: int
    write_bytes: int

    @property
    def total(self) -> int:
        return self.read_bytes + self.write_bytes

    def memory_s(self, hbm_bytes_per_s: float) -> float:
        """Least seconds the bytes take at the given memory bandwidth."""
        return self.total / hbm_bytes_per_s

    def efficiency(self, measured_s: float, hbm_bytes_per_s: float) -> float:
        """Fraction of the memory roofline achieved (1.0 == at the bound)."""
        return self.memory_s(hbm_bytes_per_s) / max(measured_s, 1e-12)


def encode_2bit_roofline(nt: int) -> Roofline:
    """2-bit encode reads nt bytes, writes nt/4 packed bytes."""
    return Roofline(nt, nt // 4)


def decode_2bit_roofline(nt: int) -> Roofline:
    return Roofline(nt // 4, nt)


def encode_b5_roofline(nt: int) -> Roofline:
    """base-5: 8 packed bytes per 27 nt."""
    return Roofline(nt, 8 * (nt // 27))


def decode_b5_roofline(nt: int) -> Roofline:
    return Roofline(8 * (nt // 27), nt)

