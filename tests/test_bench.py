"""bench.py names the device it measured, and refuses to run without a GPU
unless the CPU is asked for explicitly."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(**env_over):
    env = dict(os.environ, ROMAP_BENCH_OBJECTS="2", ROMAP_BENCH_ITERS="1")
    env.pop("ROMAP_BENCH_PLATFORM", None)
    env.update(env_over)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )


def test_bench_cpu_opt_in_names_the_cpu():
    out = _run_bench(ROMAP_BENCH_PLATFORM="cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["value"] > 0
    assert rec["unit"] == "obj-iters/s"
    assert rec["metric"].startswith("aggregate NeRF train obj-iters/sec")
    assert rec["platform"] == "cpu" and rec["count"] >= 1
    assert "device_kind" in rec


def test_bench_without_gpu_exits_nonzero():
    out = _run_bench(JAX_PLATFORMS="cpu")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "gpu" in out.stderr
