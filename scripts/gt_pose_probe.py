"""Split the online eval gap: pose error vs field quality.

Loads a captured session (ROMAP_SAVE_STATE checkpoint + refine pkl) and the
synthetic room dataset's groundtruth.txt, Sim3-aligns the eval views' raw
SLAM poses to their GT poses (Umeyama on camera centers + rotation
average), then measures the photometric+silhouette refinement loss at:

  raw      — the poses the frontend shipped (tracking or BA-recomposed)
  refined  — after the production pose refiner (pose_refine.refine_poses)
  gt       — GT poses mapped into the SLAM gauge (per-view tracking noise
             removed; only the global Sim3 fit remains)

If loss(gt) << loss(refined): the refiner leaves pose error on the table —
invest in refinement. If loss(gt) ~= loss(refined): eval poses are solved
and the residual PSNR gap is field quality — invest in training.

usage: python scripts/gt_pose_probe.py /tmp/romap_dbg/ckpt \
          /tmp/romap_tpu_E/dataset [--steps 300]
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp


def load_gt(path):
    gt = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = line.split()
            if len(v) != 8:
                continue
            stamp = float(v[0])
            tx, ty, tz, qx, qy, qz, qw = map(float, v[1:])
            # quaternion -> rotation (w last, TUM convention)
            x, y, z, w = qx, qy, qz, qw
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            gt[round(stamp, 4)] = T
    return gt


def umeyama(src, dst):
    """Similarity (s, R, t) minimizing ||dst - (s R src + t)||."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    var = (xs ** 2).sum() / len(src)
    s = np.trace(np.diag(S) @ D) / var
    t = mu_d - s * R @ mu_s
    return s, R, t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("dataset")
    ap.add_argument("--obj", type=int, default=0)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()

    from romap_tpu.config import EncodingConfig, NerfConfig
    from romap_tpu.models import nerf
    from romap_tpu.runtime import pose_refine as pr
    from romap_tpu.utils.checkpoint import load_checkpoint

    # run-E capture used the round-4 flagship (cp256_k64 + one 128x128x4
    # plane level) — the session default at capture time
    cfg = NerfConfig(encoding=EncodingConfig(
        mx_max_resolution=256, mx_features=64))
    spec = nerf.make_field_spec(cfg)

    ck = load_checkpoint(args.ckpt)
    with open(f"{args.ckpt}.refine_obj{args.obj}.pkl", "rb") as f:
        d = pickle.load(f)

    def _retuple(node):
        if isinstance(node, dict):
            return {k: _retuple(v) for k, v in node.items()}
        if isinstance(node, list):
            return tuple(_retuple(v) for v in node)
        return node

    params = jax.tree.map(
        lambda a: jnp.asarray(a[args.obj]), _retuple(dict(ck["state"]))["ema"]
    )

    stamps = [float(s) for s in d["stamps"]]
    twcs_raw = [np.asarray(t, np.float32) for t in d["twcs"]]
    gt = load_gt(os.path.join(args.dataset, "groundtruth.txt"))
    gt_twc = [gt[round(s, 4)] for s in stamps]

    # Sim3: SLAM <- GT on camera centers, rotation residual averaged out by
    # the center fit; per-view rotation mapped with the fitted R
    c_slam = np.stack([t[:3, 3] for t in twcs_raw])
    c_gt = np.stack([t[:3, 3] for t in gt_twc])
    s, R, t = umeyama(c_gt, c_slam)
    res = c_slam - (s * (R @ c_gt.T).T + t)
    print(f"sim3 fit: scale {s:.4f}, center residual mean "
          f"{np.linalg.norm(res, axis=1).mean():.4f} max "
          f"{np.linalg.norm(res, axis=1).max():.4f} (SLAM units)")

    twcs_gt = []
    for T in gt_twc:
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = (R @ T[:3, :3]).astype(np.float32)
        M[:3, 3] = (s * R @ T[:3, 3] + t).astype(np.float32)
        twcs_gt.append(M)

    batch = pr.build_refine_batch(
        [tuple(int(v) for v in b) for b in d["boxes"]], d["pixels"]
    )
    assert batch is not None
    v_pad = batch["xy"].shape[0]

    def pad_poses(lst):
        out = np.tile(np.eye(4, dtype=np.float32), (v_pad, 1, 1))
        for i, m in enumerate(lst):
            out[i] = m
        return jnp.asarray(out)

    common = dict(
        params_one=params,
        intrinsics=jnp.asarray(d["intrinsics"], jnp.float32),
        tow=jnp.asarray(d["tow"], jnp.float32),
        aabb_min=jnp.asarray(d["aabb_min"], jnp.float32),
        aabb_max=jnp.asarray(d["aabb_max"], jnp.float32),
        xy=jnp.asarray(batch["xy"]),
        rgb_t=jnp.asarray(batch["rgb"]),
        w_rgb=jnp.asarray(batch["w_rgb"]),
        mask_t=jnp.asarray(batch["mask"]),
        view_valid=jnp.asarray(batch["valid"]),
        cfg=cfg,
        spec=spec,
    )
    n = len(stamps)
    valid = batch["valid"][:n]

    def loss_at(twc_list, n_steps):
        tw, l0, lf = pr.refine_poses(
            twc0=pad_poses(twc_list), n_steps=n_steps, **common
        )
        l0 = np.asarray(jax.device_get(l0))[:n]
        lf = np.asarray(jax.device_get(lf))[:n]
        return l0, np.minimum(l0, lf)

    l_raw, l_raw_ref = loss_at(twcs_raw, args.steps)
    l_gt, l_gt_ref = loss_at(twcs_gt, args.steps)
    print(f"views {int(valid.sum())}/{n}")
    print(f"loss raw        : {l_raw[valid].mean():.4f}")
    print(f"loss refined    : {l_raw_ref[valid].mean():.4f}  (production path)")
    print(f"loss GT-aligned : {l_gt[valid].mean():.4f}")
    print(f"loss GT+refine  : {l_gt_ref[valid].mean():.4f}  (field-quality floor)")


if __name__ == "__main__":
    main()
