"""True multi-process runtime test: 2 JAX processes, shared coordinator.

Spawns two CPU-backend processes that `jax.distributed.initialize` against a
local coordinator, stream a shared record set through
:class:`StreamingEncoder` (host-sharded by record index), and write their
encoded shards; the parent asserts the union covers every record bit-exactly
and that each host consumed exactly its residue class (SURVEY.md §4c/§5).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from cute_nucleotides_jax.ops import oracle, spec

_WORKER = r"""
import json, os, sys
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception:
    pass

proc_id = int(sys.argv[1])
coord = sys.argv[2]
outdir = sys.argv[3]

from cute_nucleotides_jax.parallel import runtime
from cute_nucleotides_jax.utils import io as io_lib

info = runtime.initialize(coordinator_address=coord, num_processes=2, process_id=proc_id)
assert info["process_count"] == 2, info

reads = [("r%d" % i).encode() for i in range(10)]
seqs = [bytes((b"ACGT" * (i + 3))[: 4 * (i + 3)]) for i in range(10)]
records = [io_lib.Record(n, s) for n, s in zip(reads, seqs)]

got = {}
enc = runtime.StreamingEncoder(batch_size=4, max_len=64, tier="xla")
def sink(words, batch):
    for row in range(batch.count):
        got[int(batch.indices[row])] = words[row].tolist()
agg = enc.run(records, sink=sink)
with open(os.path.join(outdir, "h%d.json" % proc_id), "w") as f:
    json.dump({"agg": agg, "got": {str(k): v for k, v in got.items()}}, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_streaming(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    # the conftest's virtual device count would give each worker 8 CPU
    # devices; the workers must see one each
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))
    )
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), coord, str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            if "distributed" in se.lower() and "unavailable" in se.lower():
                pytest.skip(f"jax.distributed unavailable: {se[-200:]}")
            raise AssertionError(f"worker failed rc={p.returncode}:\n{se[-2000:]}")

    results = [
        json.load(open(tmp_path / f"h{i}.json")) for i in range(2)
    ]
    seqs = [bytes((b"ACGT" * (i + 3))[: 4 * (i + 3)]) for i in range(10)]
    seen = {}
    for h, res in enumerate(results):
        for k, words in res["got"].items():
            idx = int(k)
            assert idx % 2 == h, f"record {idx} on wrong host {h}"
            seen[idx] = np.asarray(words, dtype=np.uint32)
    assert sorted(seen) == list(range(10))
    for idx, w32 in seen.items():
        want = oracle.n_to_bits_lut(np.frombuffer(seqs[idx], np.uint8))
        got = spec.u32_pairs_to_u64(w32)[: want.size]
        assert np.array_equal(got, want), idx
    total_reads = sum(r["agg"]["total_reads"] for r in results)
    assert total_reads == 10
