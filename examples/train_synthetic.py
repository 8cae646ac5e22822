"""End-to-end demo: train object NeRFs on a synthetic scene and render them.

Drives the public romap_tpu API exactly the way the offline runner does:
build a frame store + object table from a generated scene, run the batched
train step, then render a held-out view and report PSNR.

Usage: python examples/train_synthetic.py [--objects N] [--iters N] [--res R]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from romap_tpu.config import NerfConfig
from romap_tpu.data.world import build_synthetic_world
from romap_tpu.models import nerf
from romap_tpu.ops.geometry import camera_rays, ray_aabb_intersect


def render_object_view(state, objs, cam, frame, obj_idx, cfg, spec, bbox):
    """Render the object's bbox rect from a frame pose, reference-style."""
    x0, y0, h, w = bbox
    ys, xs = np.mgrid[y0 : y0 + h, x0 : x0 + w]
    params = jax.tree.map(lambda a: a[obj_idx], state.ema)
    o, d, dn = camera_rays(
        jnp.asarray(xs.ravel(), jnp.float32), jnp.asarray(ys.ravel(), jnp.float32),
        jnp.asarray(cam.intrinsics), jnp.asarray(frame["twc"]),
        objs.tow[obj_idx],
    )
    tmin, tmax, hit = ray_aabb_intersect(o, d, objs.aabb_min[obj_idx], objs.aabb_max[obj_idx])
    tmin = jnp.maximum(tmin, 0.0)
    jitter = jax.random.uniform(jax.random.PRNGKey(0), (o.shape[0], cfg.train.render_samples_per_ray))
    rgb, depth, mask = nerf.render_rays(
        params, o, d, dn, tmin, tmax, hit, jitter,
        objs.aabb_min[obj_idx], objs.aabb_max[obj_idx], cfg, spec,
        n_samples=cfg.train.render_samples_per_ray,
    )
    return (np.asarray(rgb).reshape(h, w, 3), np.asarray(depth).reshape(h, w),
            np.asarray(mask).reshape(h, w))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=1)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--use-depth", action="store_true")
    ap.add_argument("--encoding", default="mxgrid", choices=["mxgrid", "hashgrid"])
    args = ap.parse_args()
    from romap_tpu.utils import jax_env

    jax_env.setup_compile_cache()
    import dataclasses
    cfg = NerfConfig()
    cfg = dataclasses.replace(cfg, encoding=dataclasses.replace(cfg.encoding, kind=args.encoding))
    spec = nerf.make_field_spec(cfg)
    cam, objects, frames, store, objs = build_synthetic_world(
        args.objects, args.frames, args.res, args.use_depth
    )
    print(f"devices: {jax.devices()}")
    print(f"objects: {args.objects}, frames: {len(frames)}, img {args.res}x{args.res}")

    state = nerf.init_train_state(jax.random.PRNGKey(cfg.seed), args.objects, cfg, spec)
    arrays = store.arrays()

    # compile
    t0 = time.perf_counter()
    state = nerf.train_objects(state, objs, arrays, cfg, spec, 1, args.use_depth)
    jax.block_until_ready(state.loss)
    print(f"compile+first step: {time.perf_counter() - t0:.1f}s  loss={np.asarray(state.loss)}")

    waves = 4
    per_wave = max(args.iters // waves, 1)
    for wv in range(waves):
        t0 = time.perf_counter()
        state = nerf.train_objects(state, objs, arrays, cfg, spec, per_wave, args.use_depth)
        jax.block_until_ready(state.loss)
        dt = time.perf_counter() - t0
        print(
            f"wave {wv}: {per_wave} iters x {args.objects} obj in {dt:.2f}s "
            f"({per_wave * args.objects / dt:.1f} obj-iters/s) loss={np.asarray(state.loss)}"
        )

    # held-out render vs analytic ground truth
    test_frame = frames[len(frames) // 2]
    for oi, obj in enumerate(objects):
        bb = test_frame["bboxes"][obj.instance_id]
        if bb is None:
            continue
        rgb, depth, mask = render_object_view(state, objs, cam, test_frame, oi, cfg, spec, bb)
        x0, y0, h, w = bb
        gt = test_frame["rgb"][y0 : y0 + h, x0 : x0 + w].astype(np.float32) / 255.0
        gt_inst = test_frame["instance"][y0 : y0 + h, x0 : x0 + w] == obj.instance_id
        mse = float(np.mean((rgb[gt_inst] - gt[gt_inst]) ** 2))
        psnr = -10 * np.log10(mse) if mse > 0 else np.inf
        iou = float(np.sum((mask > 0.5) & gt_inst) / max(np.sum((mask > 0.5) | gt_inst), 1))
        print(f"object {oi}: held-out PSNR(obj px) = {psnr:.2f} dB, mask IoU = {iou:.3f}")


if __name__ == "__main__":
    main()
