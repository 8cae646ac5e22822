"""Multi-host (multi-process) object sharding: two coordinated CPU
processes with 4 virtual devices each form the global 8-device "obj" mesh
and must reproduce the single-process train-step losses to fp32 tolerance
(rtol 1e-5 — SPMD partitioning may reorder reductions).

This exercises the DCN-era deployment path (parallel/multihost.py) as far
as a single machine allows: real jax.distributed coordination, global
arrays assembled from process-local rows, and SPMD execution where each
process owns only its shard — zero collectives by design (objects are
embarrassingly parallel, SURVEY.md §2.3).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_losses_match_single_process():
    if jax.default_backend() != "cpu":
        pytest.skip("workers are CPU-pinned fp32; an accelerator parent "
                    "(bf16) is not comparable at fp32 tolerance")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own 4-device flag
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(repo, "tests", "multihost_worker.py"),
             str(port), "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=repo,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
            assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    results = {}
    for out in outs:
        line = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert line, f"no RESULT line in:\n{out[-3000:]}"
        r = json.loads(line[-1][len("RESULT "):])
        results[r["pid"]] = r
    assert results[0]["rows"] == [0, 4] and results[1]["rows"] == [4, 8]
    merged = np.array(results[0]["loss"] + results[1]["loss"])

    # single-process oracle on this test's own 8-device CPU mesh
    from romap_tpu.data.world import build_synthetic_world
    from romap_tpu.models import nerf
    from tests.test_train_step import tiny_cfg

    cfg = tiny_cfg()
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_synthetic_world(
        n_objects=4, n_frames=4, res=48, capacity=8
    )
    oracle = nerf.train_objects(
        nerf.init_train_state(jax.random.PRNGKey(0), 8, cfg, spec),
        objs, store.arrays(), cfg, spec, 3
    )
    np.testing.assert_allclose(
        merged, np.asarray(oracle.loss), rtol=1e-5, atol=1e-6
    )
