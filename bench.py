"""Headline benchmark: aggregate NeRF training throughput, 10 concurrent
objects, reference batch geometry (4096 rays x 32 samples per object per
iteration — ref nerf_model.h:172-175).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "platform",
"device_kind", "count", ...}.

Runs on a GPU and exits non-zero when JAX finds none. ROMAP_BENCH_PLATFORM=cpu
is an explicit opt-in for tests; the line then says "platform": "cpu" and
its number is not a device measurement.

Baseline: the reference trains each object NeRF with tiny-cuda-nn on an
RTX 4090 (README.md:35). The repo publishes no timing tables (BASELINE.md);
tcnn instant-ngp at 131072 network inputs/step runs ~2 ms/step on a 4090, and
the 10 per-object CUDA streams time-slice one GPU, so the aggregate online
throughput is ~500 object-iterations/sec. vs_baseline = value / 500.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

BASELINE_OBJ_ITERS_PER_SEC = 500.0  # RTX-4090 estimate, see module docstring
N_OBJECTS = int(os.environ.get("ROMAP_BENCH_OBJECTS", "10"))


def main() -> int:
    from romap_tpu.utils import jax_env

    platform = os.environ.get("ROMAP_BENCH_PLATFORM", "gpu")
    if platform not in ("gpu", "cpu"):
        print(f"bench: ROMAP_BENCH_PLATFORM must be gpu or cpu, not "
              f"{platform!r}", file=sys.stderr)
        return 2
    try:
        jax_env.select_platform(platform)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    jax_env.setup_compile_cache()

    from romap_tpu.config import NerfConfig
    from romap_tpu.data.world import build_synthetic_world
    from romap_tpu.models import nerf

    cfg = NerfConfig()
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_synthetic_world(
        n_objects=N_OBJECTS, n_frames=16, res=128
    )
    frames = store.arrays()
    state = nerf.init_train_state(jax.random.PRNGKey(cfg.seed), N_OBJECTS, cfg, spec)

    # warmup: compile both wave shapes outside the timed blocks
    state = jax.block_until_ready(
        nerf.train_objects(state, objs, frames, cfg, spec, 1))
    iters = int(os.environ.get("ROMAP_BENCH_ITERS", "50"))
    state = jax.block_until_ready(
        nerf.train_objects(state, objs, frames, cfg, spec, iters))

    reps = 5
    best_dt = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(
            nerf.train_objects(state, objs, frames, cfg, spec, iters))
        best_dt = min(best_dt, time.perf_counter() - t0)

    value = N_OBJECTS * iters / best_dt
    dev = jax.devices()[0]
    out = {
        "metric": f"aggregate NeRF train obj-iters/sec ({N_OBJECTS} objects, 4096 rays x 32 samples)",
        "value": round(value, 2),
        "unit": "obj-iters/s",
        "vs_baseline": round(value / BASELINE_OBJ_ITERS_PER_SEC, 4),
        "baseline_note": "500 obj-iters/s is an ESTIMATE of the "
        "reference RTX-4090 online aggregate (repo publishes no "
        "timings; tcnn ~2 ms/step at 131072 inputs, 10 streams)",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
