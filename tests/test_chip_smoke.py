"""chip_smoke.py's contract: it refuses to run without a GPU, and passes on one."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(env: dict, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=timeout, cwd=ROOT,
    )


def test_chip_smoke_refuses_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    p = _run(env, timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs a GPU" in p.stderr


@pytest.mark.chip
def test_chip_smoke_passes_on_gpu(chip):
    # the child is the only process that opens the card (this one stays on
    # the CPU), so it gets the card's memory to itself
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    p = _run(env, timeout=1200)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
