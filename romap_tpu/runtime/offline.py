"""Offline multi-object NeRF training — the OfflineNeRF equivalent.

Mirrors the reference pipeline (ref dependencies/Multi-Object-NeRF/main.cpp:
287-343 + NerfManagerOffline nerf_manager.cu:9-130) with the batched
architecture: instead of one dataset replica + one training thread per
object, ONE device frame store and ONE batched train step advance every
object together. The reference's fixed schedule is 10 waves x 500 steps with
mesh extraction every 2 waves (ref nerf_manager.cu:89, nerf_model.cu:1635,
nerf.cu:135-146).
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

from romap_tpu.config import NerfConfig, load_network_config
from romap_tpu.data.formats import (
    DatasetMeta,
    load_dataset_meta,
    load_frame_images,
    load_object_file,
)
from romap_tpu.data.frame_store import FrameStore
from romap_tpu.models import nerf
from romap_tpu.parallel import sharding as shardlib
from romap_tpu.runtime import artifacts
from romap_tpu.utils.mesh_io import save_ply


class OfflineRunner:
    def __init__(
        self,
        dataset_path: str,
        network_config: str | NerfConfig | None = None,
        use_depth: bool = False,
        mesh: bool = True,
        device_mesh: "jax.sharding.Mesh | None" = None,
        holdout: int | None = None,
    ):
        if isinstance(network_config, NerfConfig):
            self.cfg = network_config
        elif isinstance(network_config, str):
            self.cfg = load_network_config(network_config)
        else:
            self.cfg = NerfConfig()
        self.spec = nerf.make_field_spec(self.cfg)
        self.use_depth = use_depth
        self.mesh_enabled = mesh
        # holdout=N: every Nth per-object view is EXCLUDED from training
        # supervision and becomes the eval view set. The reference's offline
        # path trains on every view and external tooling scores a subset of
        # the SAME views (train-set leakage when quoting the result as a
        # quality ceiling); the online pipeline never uploads its held-out
        # eval frames (mono_tum.cc dense_holdout). Ceiling studies must
        # compare like with like, so None (reference parity) stays the
        # default and seed/adversarial studies pass the online protocol's 4.
        self.holdout = holdout
        # Multi-device by default: object-axis dp over the local device
        # mesh, capacity padded to a mesh multiple; frames replicated (the
        # batched form of the reference's one-replica-per-GPU offline path,
        # ref nerf_manager.cu:9-130). device_mesh pins the devices.
        self.device_mesh = device_mesh or shardlib.make_mesh()

        self.meta: DatasetMeta = load_dataset_meta(dataset_path, use_depth)
        n = len(self.meta.stamps)
        self.store = FrameStore(
            n, self.meta.h, self.meta.w, self.meta.intrinsics, use_depth,
            depth_scale=1.0,  # scaling applied at load time below
        )
        print("Load Images to device ...")
        for i in range(n):
            rgb, depth, inst = load_frame_images(self.meta, i, use_depth)
            self.store.add_frame(i, self.meta.stamps[i], rgb, inst,
                                 self.meta.poses[i], depth=depth)
        print("Load Images to device completed...")

        self.objects: list[dict] = []
        self.state: nerf.TrainState | None = None
        self.objs_state: nerf.ObjectsState | None = None

    # -- NerfManagerOffline::CreateNeRF equivalent ---------------------------
    def create_nerf(self, object_file: str) -> int:
        data = load_object_file(object_file)
        idx = len(self.objects)
        self.objects.append(dict(data=data, path=object_file))
        return idx

    def create_nerfs_from_dir(self, obj_dir: str | None = None) -> int:
        obj_dir = obj_dir or os.path.join(self.meta.root, "obj_offline")
        files = sorted(glob.glob(os.path.join(obj_dir, "*.txt")))
        for f in files:
            self.create_nerf(f)
        return len(files)

    def _build_object_table(self) -> None:
        cap = shardlib.pad_capacity(max(len(self.objects), 1),
                                    self.device_mesh)
        stamp_to_idx = self.meta.stamp_to_idx
        max_b = max((len(o["data"].stamps) for o in self.objects), default=1)
        objs = dict(
            aabb_min=np.zeros((cap, 3), np.float32),
            aabb_max=np.ones((cap, 3), np.float32),
            tow=np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1)),
            instance_id=np.zeros(cap, np.int32),
            bboxes=np.zeros((cap, max_b, 5), np.int32),
            n_bbox=np.zeros(cap, np.int32),
            active=np.zeros(cap, bool),
        )
        for oi, o in enumerate(self.objects):
            d = o["data"]
            objs["aabb_min"][oi] = -d.half_extents
            objs["aabb_max"][oi] = d.half_extents
            objs["tow"][oi] = d.tow
            objs["instance_id"][oi] = d.cls  # mInstanceId = uint8(class)
            nb = 0
            held = o.setdefault("holdout_views", [])
            for serial, (stamp, box) in enumerate(zip(d.stamps, d.bboxes)):
                fid = stamp_to_idx.get(stamp)
                if fid is None:
                    continue
                if self.holdout and serial % self.holdout == 0:
                    held.append(dict(stamp=stamp, twc=self.meta.poses[fid],
                                     box=tuple(int(v) for v in box)))
                    continue
                objs["bboxes"][oi, nb] = (fid, box[0], box[1], box[2], box[3])
                nb += 1
            objs["n_bbox"][oi] = nb
            objs["active"][oi] = nb > 0
        self.objs_state = shardlib.shard_objects(
            nerf.ObjectsState(**{k: jnp.asarray(v) for k, v in objs.items()}),
            self.device_mesh,
        )
        self.state = shardlib.shard_objects(
            nerf.init_train_state(
                jax.random.PRNGKey(self.cfg.seed), cap, self.cfg, self.spec
            ),
            self.device_mesh,
        )

    # -- training (ref NeRF::TrainOffline nerf.cu:120-152) --------------------
    def train(self, waves: int = 10, steps_per_wave: int = 500,
              mesh_every: int = 2, out_dir: str = "./output") -> None:
        if self.state is None:
            self._build_object_table()
        frames = self.store.arrays(
            sharding=shardlib.replicated(self.device_mesh)
        )
        os.makedirs(out_dir, exist_ok=True)
        self.meshes: dict[int, object] = {}
        for wave in range(1, waves + 1):
            t0 = time.perf_counter()
            self.state = nerf.train_objects(
                self.state, self.objs_state, frames, self.cfg, self.spec,
                steps_per_wave, self.use_depth,
            )
            losses = jax.device_get(self.state.loss)
            dt = (time.perf_counter() - t0) * 1000
            for oi in range(len(self.objects)):
                print(
                    f"Id: {oi} train_time: {dt:.0f} Step: "
                    f"{int(jax.device_get(self.state.step)[oi])} loss: {losses[oi]:.6f}"
                )
            if self.mesh_enabled and wave % mesh_every == 0:
                self.extract_meshes()
        self.save_meshes(out_dir)
        print("Training completed")

    def params_of(self, oi: int):
        return jax.tree.map(lambda a: a[oi], self.state.ema)

    def extract_meshes(self) -> None:
        for oi in range(len(self.objects)):
            self.meshes[oi] = artifacts.extract_object_mesh(
                self.params_of(oi),
                self.objs_state.aabb_min[oi], self.objs_state.aabb_max[oi],
                self.cfg, self.spec,
            )

    def save_meshes(self, out_dir: str) -> None:
        if not self.mesh_enabled:
            return
        self.extract_meshes()
        for oi, mesh in self.meshes.items():
            save_ply(mesh, os.path.join(out_dir, f"{oi}.ply"))

    # -- optional evaluation artifacts (online contract, SURVEY §3.4) --------
    def render_test_artifacts(self, out_dir: str, test_every: int = 8,
                              video: bool = True) -> None:
        for oi, o in enumerate(self.objects):
            d = o["data"]
            views = []
            for stamp, box in zip(d.stamps, d.bboxes):
                fid = self.meta.stamp_to_idx.get(stamp)
                if fid is None:
                    continue
                views.append(dict(stamp=stamp, twc=self.meta.poses[fid],
                                  box=tuple(int(v) for v in box)))
            # leakage-free protocol: when training held views out, those
            # exact views are the eval set (they were never supervision)
            test_views = (o.get("holdout_views") or views[::test_every])
            radius = 5.0 * float(np.max(d.half_extents))
            artifacts.render_test_artifacts(
                out_dir, oi, self.params_of(oi), self.meta.intrinsics,
                d.tow, -d.half_extents, d.half_extents,
                (self.meta.h, self.meta.w), test_views, views, d.cls,
                radius, self.cfg, self.spec, video=video,
            )


def main(argv: list[str] | None = None) -> None:
    """CLI mirroring `./OfflineNeRF <network_config> <dataset> <use_gt_depth>`
    (ref main.cpp:287-343; object files discovered in <dataset>/obj_offline/
    instead of the reference's hard-coded 0..3). Extra flags scale the run
    down for small machines/tests."""
    import argparse
    import dataclasses

    ap = argparse.ArgumentParser(prog="romap-offline-nerf")
    ap.add_argument("network_config", help="reference-format network JSON, or '-'")
    ap.add_argument("dataset")
    ap.add_argument("use_gt_depth", type=int, choices=[0, 1])
    ap.add_argument("--waves", type=int, default=10)
    ap.add_argument("--steps-per-wave", type=int, default=500)
    ap.add_argument("--out", default="./output")
    ap.add_argument("--no-video", action="store_true")
    ap.add_argument("--no-artifacts", action="store_true")
    ap.add_argument("--rays", type=int, help="rays/batch override (default 4096)")
    ap.add_argument("--samples", type=int, help="samples/ray override (default 32)")
    ap.add_argument("--mc-res", type=int, help="marching cubes res (default 64)")
    ap.add_argument("--mx-features", type=int, help="mxgrid channels (default 64)")
    ap.add_argument("--mx-max-res", type=int, help="mxgrid max resolution")
    ap.add_argument("--holdout", type=int, default=None,
                    help="exclude every Nth per-object view from training "
                    "and evaluate on exactly those views (leakage-free "
                    "ceiling protocol matching the online pipeline's "
                    "dense_holdout; default: reference parity, train on "
                    "all views)")
    args = ap.parse_args(argv)
    from romap_tpu.utils import jax_env

    jax_env.setup_compile_cache()
    cfg = (NerfConfig() if args.network_config == "-"
           else load_network_config(args.network_config))
    train_kw = {}
    if args.rays:
        train_kw["rays_per_batch"] = args.rays
    if args.samples:
        train_kw["samples_per_ray"] = args.samples
    if args.mc_res:
        train_kw["mc_resolution"] = args.mc_res
    if train_kw:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))
    enc_kw = {}
    if args.mx_features:
        enc_kw["mx_features"] = args.mx_features
    if args.mx_max_res:
        enc_kw["mx_max_resolution"] = args.mx_max_res
    if enc_kw:
        cfg = dataclasses.replace(cfg, encoding=dataclasses.replace(cfg.encoding, **enc_kw))

    runner = OfflineRunner(args.dataset, cfg, use_depth=bool(args.use_gt_depth),
                           holdout=args.holdout)
    n = runner.create_nerfs_from_dir()
    print(f"Create {n} NeRF instances ...")
    runner.train(waves=args.waves, steps_per_wave=args.steps_per_wave,
                 out_dir=args.out)
    if not args.no_artifacts:
        runner.render_test_artifacts(args.out, video=not args.no_video)


if __name__ == "__main__":
    main()
