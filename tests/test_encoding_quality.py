"""Encoding quality parity: the gather-free mxgrid must match (or beat) the
reference-semantics hash grid on the same scene/budget — the evidence behind
making mxgrid the flagship (BASELINE.md targets per-object PSNR parity)."""

import dataclasses

import numpy as np
import pytest

import jax

from romap_tpu.config import EncodingConfig, NerfConfig, TrainConfig
from romap_tpu.data.world import build_synthetic_world
from romap_tpu.models import nerf
from romap_tpu.ops.geometry import camera_rays, ray_aabb_intersect

import jax.numpy as jnp


def _train_and_psnr(kind: str, iters: int = 120):
    if kind == "mxgrid":
        enc = EncodingConfig(kind="mxgrid", mx_levels=3, mx_max_resolution=64,
                             mx_features=16, mx_plane_res=64,
                             mx_plane_features=16)
    else:
        enc = EncodingConfig(kind="hashgrid", n_levels=6, log2_hashmap_size=13,
                             base_resolution=4, desired_resolution=64.0)
    cfg = NerfConfig(
        encoding=enc,
        train=TrainConfig(rays_per_batch=512, samples_per_ray=16),
    )
    spec = nerf.make_field_spec(cfg)
    cam, objects, frames, store, objs = build_synthetic_world(1, 10, 64)
    state = nerf.init_train_state(jax.random.PRNGKey(0), 1, cfg, spec)
    state = nerf.train_objects(state, objs, store.arrays(), cfg, spec, iters)

    # held-out view PSNR on object pixels
    test = frames[len(frames) // 2]
    bb = test["bboxes"][objects[0].instance_id]
    x0, y0, h, w = bb
    ys, xs = np.mgrid[y0 : y0 + h, x0 : x0 + w]
    params = jax.tree.map(lambda a: a[0], state.ema)
    o, d, dn = camera_rays(
        jnp.asarray(xs.ravel(), jnp.float32), jnp.asarray(ys.ravel(), jnp.float32),
        jnp.asarray(cam.intrinsics), jnp.asarray(test["twc"]), objs.tow[0],
    )
    tmin, tmax, hit = ray_aabb_intersect(o, d, objs.aabb_min[0], objs.aabb_max[0])
    jitter = jax.random.uniform(jax.random.PRNGKey(1), (o.shape[0], 32))
    rgb, _, _ = nerf.render_rays(
        params, o, d, dn, jnp.maximum(tmin, 0), tmax, hit, jitter,
        objs.aabb_min[0], objs.aabb_max[0], cfg, spec, n_samples=32,
    )
    rgb = np.asarray(rgb).reshape(h, w, 3)
    gt = test["rgb"][y0 : y0 + h, x0 : x0 + w].astype(np.float32) / 255.0
    m = test["instance"][y0 : y0 + h, x0 : x0 + w] == objects[0].instance_id
    mse = float(np.mean((rgb[m] - gt[m]) ** 2))
    return -10 * np.log10(max(mse, 1e-9))


def test_mxgrid_tracks_hashgrid_quality():
    """Micro-budget regression guard (120 iters, shrunken encoders, CPU).

    Measured at this budget: CP-only mxgrid trails the hash grid by ~7 dB;
    adding the VM plane components recovers it to within ~1 dB — this test
    pins that property. The flagship-config comparison (full ladders, 300+
    iters) is the BASELINE.md 0.5 dB criterion and runs on hardware."""
    psnr_mx = _train_and_psnr("mxgrid")
    psnr_hash = _train_and_psnr("hashgrid")
    print(f"mxgrid {psnr_mx:.2f} dB vs hashgrid {psnr_hash:.2f} dB")
    assert psnr_mx > psnr_hash - 2.0, (psnr_mx, psnr_hash)
    assert psnr_mx > 20.0  # absolute quality floor at this tiny budget
