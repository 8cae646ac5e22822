"""Online multi-object NeRF manager — the NerfManagerOnline equivalent.

API surface preserved from the reference (ref nerf_manager.h:54-91 /
nerf_manager.cu:134-312) so a SLAM frontend can drive it unchanged:

  Init                 -> constructor
  DatasetInit          -> dataset_init(fx, fy, cx, cy, H, W, imgs)
  NewFrameToDataset    -> new_frame_to_dataset(img_id, stamp, rgb, instance,
                          depth, pose)
  UpdateDataset        -> update_dataset(cur_id, frame_num, poses)
  CreateNeRF           -> create_nerf(cls, obj_tow, bbox_min, bbox_max) -> idx
  UpdateNeRFBbox       -> update_nerf_bbox(idx, frame_bboxes, train_step)
  GetFrameIdx          -> get_frame_idx(stamp)
  WaitThreadsEnd       -> wait_threads_end()
  RenderNeRFsTest      -> render_nerfs_test(out, idx, stamps, boxes, twcs, r)
  DrawMesh             -> get_mesh(idx) (returns mesh data; no GL here)

Concurrency model INVERTED from the reference: instead of one std::thread +
CUDA stream pair per object (ref nerf_manager.cu:256-260), every object is a
row of the batched TrainState and a single pump loop executes training in
fixed quanta of `train_step_iterations`, masking slots by their pending-
iteration budget. Reference semantics preserved:
  * bbox inflation 1.1x (1.2x for classes 41/73)      (ref nerf.cu:162-172)
  * an object only trains once it has > 10 bboxes     (ref nerf.cu:222)
  * each UpdateNeRFBbox credits train_step waves of train_step_iterations
    iterations                                        (ref nerf.cu:204-237)
  * mesh extraction every 2 waves                     (ref nerf.cu:228-236)
  * WaitThreadsEnd runs one final wave + mesh         (ref nerf.cu:246-251)

Call pump() to execute pending work synchronously (deterministic replay /
tests), or start()/stop() to run it on a background thread like the
reference's training threads.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

import jax
import jax.numpy as jnp

import math

from romap_tpu.config import NerfConfig, load_network_config
from romap_tpu.data.frame_store import FrameStore
from romap_tpu.models import nerf
from romap_tpu.parallel import sharding as shardlib
from romap_tpu.runtime import artifacts

MIN_BBOXES_TO_TRAIN = 10  # ref nerf.cu:222


class NerfManagerOnline:
    def __init__(
        self,
        network_config: str | NerfConfig | None = None,
        use_sparse_depth: bool = False,
        train_step_iterations: int = 500,
        capacity: int = 16,
        mesh_every_waves: int = 2,
        mesh_enabled: bool = True,
        final_waves: int = 1,
        mesh: "jax.sharding.Mesh | None" = None,
        joint_ba_iters: int = 0,
        final_retrain: bool = True,
    ):
        if isinstance(network_config, NerfConfig):
            self.cfg = network_config
        elif isinstance(network_config, str):
            self.cfg = load_network_config(network_config)
        else:
            self.cfg = NerfConfig()
        self.spec = nerf.make_field_spec(self.cfg)
        self.use_depth = use_sparse_depth
        self.iters_per_wave = train_step_iterations
        self.capacity = capacity
        self.mesh_every_waves = mesh_every_waves
        self.mesh_enabled = mesh_enabled
        # Waves run at shutdown per still-active object. 1 = reference
        # parity (ref nerf.cu:246-251 runs one last Train_Step_Online);
        # more buys extra convergence on the final keyframe set — useful
        # because online waves are angle-gated and
        # a short sequence may end long before the offline 5000-step
        # budget. Reuses the compiled wave shape (no recompile).
        self.final_waves = max(1, int(final_waves))
        # Shutdown joint photometric BA (beyond the reference): optimize a
        # shared per-keyframe SE(3) correction table JOINTLY with the fields
        # for this many iterations before the final waves (BARF-style; see
        # nerf.train_objects_joint_ba). 0 = off, the PRODUCTION default
        # (reference parity: SLAM poses trained as-is). Measured online
        # (ARCHITECTURE "Joint-BA hardening"): with shutdown BA already at
        # 0.8 px, the photometric pose gradient is noise-dominated and
        # joint BA REGRESSES held-out eval 23 -> 16 dB even with the trust
        # region, depth-free objective and gauge transport; the +0.26 dB
        # synthetic win only exists when input poses carry real (0.02+)
        # error. Enable only for high-pose-error regimes.
        self.joint_ba_iters = max(0, int(joint_ba_iters))
        # Shutdown from-scratch retrain (beyond the reference): re-init
        # every active slot and re-credit its spent waves after the
        # frontend's final BA-recomposed pose upload, so the eval-facing
        # field is trained end to end on the REFINED pose graph instead of
        # carrying content baked in at noisy tracking-time poses. Measured
        # on the room demo: the accidental version of this (a trigger bug
        # re-initializing slots all run long, the last time late) scored
        # 25.29 dB / IoU 0.988 where the same pipeline without a final
        # retrain scored 23.62 / 0.921. Cost: one extra wave-budget drain
        # at shutdown.
        self.final_retrain = bool(final_retrain)
        # set by _joint_ba: (kf stamps, old Twc, corrected Twc) — transports
        # eval-view poses into the corrected gauge in render_nerfs_test
        self._jba_transport = None

        # Multi-device by default: object-axis dp over a 1-D device mesh
        # (the batched form of the reference's replicate-dataset +
        # round-robin objects multi-GPU path, ref nerf_manager.cu:189-218,
        # nerf.cu:27-33). An explicit `mesh` pins the devices (capacity is
        # padded to a multiple of its size); by default the mesh adapts to
        # gcd(capacity, local devices) so capacity semantics are identical
        # on 1 card and on 4.
        self._mesh_arg = mesh
        if mesh is not None:
            self.capacity = shardlib.pad_capacity(self.capacity, mesh)
        self.mesh = mesh or shardlib.make_mesh(
            math.gcd(self.capacity, len(jax.devices()))
        )

        self.store: FrameStore | None = None
        self.state: nerf.TrainState | None = None

        self._lock = threading.RLock()
        # train_objects DONATES its state argument: while a wave is in
        # flight the buffers behind self.state are dead. Every consumer of
        # self.state (grow, losses, mesh/render snapshots, the final train)
        # must wait for _train_busy to clear; pump() sets it around the
        # un-locked device step and publishes the result under the lock.
        self._cond = threading.Condition(self._lock)
        self._train_busy = False
        self._n_objects = 0
        self._classes: list[int] = []
        self._pending_waves = np.zeros(capacity, np.int64)
        self._wave_count = np.zeros(capacity, np.int64)
        # cumulative bbox-earned wave budget, NEVER reset by re-inits: any
        # from-scratch retrain (mid-run volume update or shutdown
        # final_retrain) restores pending to exactly this — "retrain on the
        # full accumulated supervision". _wave_count alone can't express
        # that: it counts waves since the last reinit, so crediting it
        # starved a late-volume-update slot's shutdown retrain to 1-2 waves
        # (measured -1.0 dB on the round-5 seed study), while the round-4
        # code that never zeroed it compounded 2^k (ADVICE r4 medium).
        self._waves_earned = np.zeros(capacity, np.int64)
        # per-slot re-initialization count: folded into the reinit PRNG key
        # so repeated grow updates / the shutdown retrain draw FRESH inits
        # instead of restoring the same byte-identical params every time
        self._reinit_count = np.zeros(capacity, np.int64)
        self._meshes: dict[int, object] = {}
        self._objs: dict[str, np.ndarray] | None = None
        self._precompiled: set[int] = set()  # capacities with a warm jit

        self._thread: threading.Thread | None = None
        self._finish = threading.Event()

    # ------------------------------------------------------------------ data
    def dataset_init(self, fx, fy, cx, cy, h, w, imgs: int) -> None:
        """ref NerfManagerOnline::DatasetInit nerf_manager.cu:160-187.
        `imgs` is the preallocated keyframe budget (caller passes nimages/3,
        ref src/System.cc:135-138)."""
        self.store = FrameStore(
            int(imgs), int(h), int(w), np.array([fx, fy, cx, cy], np.float32),
            use_depth=self.use_depth, depth_scale=1.0,
        )
        self._max_bboxes = int(imgs)
        self._objs = dict(
            aabb_min=np.zeros((self.capacity, 3), np.float32),
            aabb_max=np.ones((self.capacity, 3), np.float32),
            tow=np.tile(np.eye(4, dtype=np.float32), (self.capacity, 1, 1)),
            instance_id=np.zeros(self.capacity, np.int32),
            bboxes=np.zeros((self.capacity, self._max_bboxes, 5), np.int32),
            n_bbox=np.zeros(self.capacity, np.int32),
            active=np.zeros(self.capacity, bool),
        )
        self.state = shardlib.shard_objects(
            nerf.init_train_state(
                jax.random.PRNGKey(self.cfg.seed), self.capacity, self.cfg,
                self.spec,
            ),
            self.mesh,
        )
        # warm this capacity's programs (train wave + reinit_slot) while
        # the frontend is still bootstrapping, so the first wave does not
        # compile inline in the serving path (PERF.md has the card's cold
        # and warm compile times; CPU compiles are cheap and tests churn
        # managers: skip there)
        if (jax.default_backend() != "cpu"
                and self.capacity not in self._precompiled):
            self._precompiled.add(self.capacity)
            threading.Thread(
                target=self._precompile, args=(self.capacity,), daemon=True,
            ).start()

    def new_frame_to_dataset(self, img_id: int, stamp: str, rgb, instance,
                             depth=None, pose=None) -> None:
        """ref NewFrameToDataset nerf_manager.cu:189-218 (rgb is RGB u8 here;
        the cv-BGR conversion belongs to the caller/loader)."""
        with self._lock:
            self.store.add_frame(int(img_id), stamp, rgb, instance, pose, depth)

    def update_dataset(self, cur_id: int, frame_num: int, poses) -> None:
        """Pose-window rewrite (ref UpdateDataset nerf_manager.cu:220-235)."""
        with self._lock:
            self.store.update_poses(int(cur_id) - int(frame_num), poses)

    def get_frame_idx(self, stamp: str) -> int:
        """ref GetFrameIdx nerf_manager.cu:288-296."""
        return self.store.stamp_to_idx.get(stamp, -1)

    # --------------------------------------------------------------- objects
    def create_nerf(self, cls: int, obj_tow, bbox_min, bbox_max) -> int:
        """ref CreateNeRF nerf_manager.cu:237-261 + SetAttributes nerf.cu:
        155-176 (bbox inflation)."""
        with self._lock:
            if self._n_objects >= self.capacity:
                self._grow()
            idx = self._n_objects
            self._n_objects += 1
            # warm the next capacity's jit off-thread once 3/4 full, so the
            # doubling in _grow never stalls the online pipeline for a
            # recompile
            if (self._n_objects * 4 >= self.capacity * 3
                    and self.capacity * 2 not in self._precompiled):
                self._precompiled.add(self.capacity * 2)
                threading.Thread(
                    target=self._precompile, args=(self.capacity * 2,),
                    daemon=True,
                ).start()
            scale = 1.2 if cls in (41, 73) else 1.1
            self._objs["aabb_min"][idx] = np.asarray(bbox_min, np.float32) * scale
            self._objs["aabb_max"][idx] = np.asarray(bbox_max, np.float32) * scale
            self._objs["tow"][idx] = np.asarray(obj_tow, np.float32)
            self._objs["instance_id"][idx] = int(cls)
            self._classes.append(int(cls))
            self._objs["n_bbox"][idx] = 0
            self._objs["active"][idx] = False
            return idx

    def aabb_half(self, idx: int) -> np.ndarray:
        """The object's actual training-volume half-widths (object frame,
        inflation included) — the single source of truth for anything that
        must reason about the field volume (e.g. mesh-support clipping)."""
        with self._lock:
            return np.array(self._objs["aabb_max"][idx], np.float32)

    def _wait_idle_locked(self) -> None:
        """Block (lock held via the condition) until no wave is in flight."""
        while self._train_busy:
            self._cond.wait()

    def _precompile(self, cap: int) -> None:
        """AOT-compile the train step for a future capacity: jit lower +
        compile on ShapeDtypeStructs. Warms XLA's executable cache without
        allocating device buffers or executing anything, so it cannot OOM a
        live session. Runs on a daemon thread — jit compilation is
        thread-safe."""
        try:
            with self._lock:
                # same sharding as _frames() so this never flips the
                # store's placement cache (a None-sharded call would force
                # two full-store device re-uploads around the next wave)
                frames = self.store.arrays(
                    sharding=shardlib.replicated(self.mesh)
                )
                # the mesh _grow will pick for this capacity — the AOT
                # signature must carry the REAL input shardings or the
                # warmed executable misses the jit cache at wave time
                future_mesh = (
                    self.mesh if self._mesh_arg is not None
                    else shardlib.make_mesh(math.gcd(cap, len(jax.devices())))
                )
            obj_sh = shardlib.object_sharding(future_mesh)
            rep_sh = shardlib.replicated(future_mesh)
            struct = lambda t, sh: jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(
                    np.shape(x), x.dtype, sharding=sh), t
            )
            state_s = struct(
                jax.eval_shape(
                    lambda k: nerf.init_train_state(
                        k, cap, self.cfg, self.spec),
                    jax.random.PRNGKey(0),
                ),
                obj_sh,
            )
            objs_s = struct(
                jax.eval_shape(
                    lambda: nerf.empty_objects(cap, self._max_bboxes)
                ),
                obj_sh,
            )
            nerf.train_objects.lower(
                state_s, objs_s, struct(frames, rep_sh), self.cfg, self.spec,
                self.iters_per_wave, self.use_depth,
            ).compile()
            # reinit_slot fires mid-pipeline on the first grow-triggered
            # volume update; pay its compile here instead of inline in the
            # serving path
            key_s = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype),
                jax.eval_shape(lambda: jax.random.PRNGKey(0)),
            )
            nerf.reinit_slot.lower(
                state_s, key_s, jax.ShapeDtypeStruct((), np.int32),
                self.cfg, self.spec,
            ).compile()
        except Exception as e:  # noqa: BLE001 — warm-up is best-effort
            print(f"[manager] precompile for capacity {cap} failed: {e!r}")
            with self._lock:
                self._precompiled.discard(cap)  # retry on the next create

    def _grow(self) -> None:
        """Double the slot capacity (re-inits padding params; recompile on
        next pump — the batched analog of spawning more threads). Caller
        holds the lock; waits out any in-flight wave so the concatenation
        never touches donated buffers."""
        self._wait_idle_locked()
        old_cap, new_cap = self.capacity, self.capacity * 2
        for k, v in self._objs.items():
            pad = np.zeros((new_cap - old_cap,) + v.shape[1:], v.dtype)
            if k == "aabb_max":
                pad[:] = 1.0
            if k == "tow":
                pad[:] = np.eye(4, dtype=np.float32)
            self._objs[k] = np.concatenate([v, pad], 0)
        extra = nerf.init_train_state(
            jax.random.PRNGKey(self.cfg.seed + old_cap), new_cap - old_cap,
            self.cfg, self.spec,
        )
        if self._mesh_arg is None:
            # adapt the mesh to the doubled table (more devices can carry
            # object rows now); resharding happens in the device_put below
            self.mesh = shardlib.make_mesh(
                math.gcd(new_cap, len(jax.devices()))
            )
        self.state = shardlib.shard_objects(
            jax.tree.map(
                lambda a, b: jnp.concatenate([a, b], 0), self.state, extra
            ),
            self.mesh,
        )
        self._pending_waves = np.concatenate(
            [self._pending_waves, np.zeros(new_cap - old_cap, np.int64)]
        )
        self._wave_count = np.concatenate(
            [self._wave_count, np.zeros(new_cap - old_cap, np.int64)]
        )
        self._waves_earned = np.concatenate(
            [self._waves_earned, np.zeros(new_cap - old_cap, np.int64)]
        )
        self._reinit_count = np.concatenate(
            [self._reinit_count, np.zeros(new_cap - old_cap, np.int64)]
        )
        self.capacity = new_cap

    def update_nerf_bbox(self, idx: int, frame_bboxes, train_step: int = 1) -> None:
        """Append (frame_id, x, y, h, w) rows + credit training waves
        (ref UpdateNeRFBbox nerf_manager.cu:298-303 -> UpdateFrameBBox
        nerf.cu:406-421)."""
        rows = np.asarray(frame_bboxes, np.int32).reshape(-1, 5)
        if len(rows) == 0:
            return
        with self._lock:
            nb = int(self._objs["n_bbox"][idx])
            while nb + len(rows) > self._max_bboxes:
                self._grow_bboxes()
            end = nb + len(rows)
            self._objs["bboxes"][idx, nb:end] = rows
            self._objs["n_bbox"][idx] = end
            self._pending_waves[idx] += int(train_step)
            self._waves_earned[idx] += int(train_step)

    def _grow_bboxes(self) -> None:
        """Double the per-object bbox-row capacity. The keyframe-mode
        prealloc (stamps/2+8 rows) can overflow on long sessions with
        re-credited retrains; dropping rows silently starves late
        supervision, so grow like the frame store instead (costs one
        train-step recompile on the next pump). Caller holds the lock."""
        old = self._max_bboxes
        self._max_bboxes = old * 2
        b = self._objs["bboxes"]
        pad = np.zeros((b.shape[0], old, 5), b.dtype)
        self._objs["bboxes"] = np.concatenate([b, pad], axis=1)
        print(f"[manager] bbox table grown {old} -> {self._max_bboxes} "
              "rows/object (train step recompiles at the new shape)",
              flush=True)

    def update_nerf_volume(self, idx: int, obj_tow, bbox_min, bbox_max) -> bool:
        """Grow-triggered pose + training-volume replacement (beyond the
        reference, which freezes SetAttributes at creation — ref nerf.cu:
        155-176): the frontend calls this when the SLAM cuboid outgrows the
        frozen box (an immature creation-time shape otherwise squashes the
        field forever — measured 7 dB vs 24 dB on the room demo). The
        slot's params/EMA/optimizer re-init (learned content is tied to the
        old unit-cube warp) and the waves already spent are re-credited so
        the field retrains from the full accumulated bbox supervision.
        Returns False (no-op) for an out-of-range slot index: this op is
        triggered asynchronously by the mapping thread, so a stale idx after
        a SLAM reset must not kill the runtime session."""
        with self._lock:
            if not (0 <= idx < self._n_objects):
                print(f"[manager] update_nerf_volume: slot {idx} out of "
                      f"range (n_objects={self._n_objects}); ignored",
                      flush=True)
                return False
            self._wait_idle_locked()
            cls = int(self._objs["instance_id"][idx])
            scale = 1.2 if cls in (41, 73) else 1.1
            self._objs["aabb_min"][idx] = np.asarray(bbox_min, np.float32) * scale
            self._objs["aabb_max"][idx] = np.asarray(bbox_max, np.float32) * scale
            self._objs["tow"][idx] = np.asarray(obj_tow, np.float32)
            if self.state is not None:
                self.state = shardlib.shard_objects(
                    nerf.reinit_slot(
                        self.state, self._next_reinit_key(idx),
                        np.int32(idx), self.cfg, self.spec,
                    ),
                    self.mesh,
                )
            # the slot retrains from scratch, so pending is RESTORED to the
            # full bbox-earned lifetime budget (not incremented by the
            # since-last-reinit count — that compounds 2^k if never zeroed
            # and starves the shutdown retrain if zeroed here)
            self._pending_waves[idx] = self._waves_earned[idx]
            self._wave_count[idx] = 0
            self._meshes.pop(idx, None)  # stale mesh from the old field
            return True

    def _next_reinit_key(self, idx: int):
        """Fresh PRNG key per re-initialization of a slot (folds a per-slot
        reinit counter into the base key so a pathological init draw is
        recoverable)."""
        key = jax.random.fold_in(
            jax.random.PRNGKey(self.cfg.seed + 7919 + idx),
            int(self._reinit_count[idx]),
        )
        self._reinit_count[idx] += 1
        return key

    # -------------------------------------------------------------- training
    def _objects_state(self, active_mask: np.ndarray) -> nerf.ObjectsState:
        o = self._objs
        put = lambda x: jax.device_put(x, shardlib.object_sharding(self.mesh))
        return nerf.ObjectsState(
            aabb_min=put(o["aabb_min"]),
            aabb_max=put(o["aabb_max"]),
            tow=put(o["tow"]),
            instance_id=put(o["instance_id"]),
            bboxes=put(o["bboxes"]),
            n_bbox=put(o["n_bbox"]),
            active=put(active_mask),
        )

    def _frames(self):
        return self.store.arrays(sharding=shardlib.replicated(self.mesh))

    def _trainable(self) -> np.ndarray:
        return (self._pending_waves > 0) & (self._objs["n_bbox"] > MIN_BBOXES_TO_TRAIN)

    def pump(self, max_waves: int | None = None) -> int:
        """Execute pending training waves; returns the number of quanta run.
        Each quantum = iters_per_wave iterations for every slot whose wave
        budget is positive (and bbox-gated), exactly the per-object semantics
        of NeRF::TrainOnline batched across slots."""
        waves_run = 0
        while max_waves is None or waves_run < max_waves:
            with self._cond:
                self._wait_idle_locked()  # serialize concurrent pumps
                mask = self._trainable()
                if not mask.any():
                    break
                objs = self._objects_state(mask)
                frames = self._frames()
                state = self.state
                self._train_busy = True
            try:
                state = nerf.train_objects(
                    state, objs, frames, self.cfg, self.spec,
                    self.iters_per_wave, self.use_depth,
                )
                jax.block_until_ready(state)  # the wave ends on the device
            except BaseException:
                with self._cond:
                    self._train_busy = False
                    self._cond.notify_all()
                raise
            with self._cond:
                self.state = state
                self._pending_waves[mask] -= 1
                self._wave_count[mask] += 1
                mesh_due = mask & (self._wave_count % self.mesh_every_waves == 0)
                self._train_busy = False
                self._cond.notify_all()
            if self.mesh_enabled:
                for oi in np.nonzero(mesh_due)[0]:
                    self._extract_mesh(int(oi))
            waves_run += 1
        return waves_run

    def _extract_mesh(self, oi: int) -> None:
        with self._cond:
            self._wait_idle_locked()
            # dispatch the slice while holding the lock: ops dispatched here
            # are ordered before any later donating wave
            params = jax.tree.map(lambda a: a[oi], self.state.ema)
        mesh = artifacts.extract_object_mesh(
            params, self._objs["aabb_min"][oi], self._objs["aabb_max"][oi],
            self.cfg, self.spec,
        )
        with self._lock:
            self._meshes[oi] = mesh

    # ---------------------------------------------------------- thread pump
    def start(self) -> None:
        """Run the pump on a background thread (the reference's per-object
        training threads collapsed into one)."""
        if self._thread is not None:
            return
        self._finish.clear()

        def run():
            while not self._finish.is_set():
                if self.pump(max_waves=1) == 0:
                    time.sleep(0.003)  # ref nerf.cu:243 usleep(3000)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _joint_ba(self, objs: nerf.ObjectsState) -> None:
        """Shutdown joint photometric BA: optimize the shared keyframe-pose
        correction table jointly with every active field, then fold the
        SE(3) deltas into the frame store's Twc poses. The eval path's
        per-view refinement then aligns held-out views to a field trained
        at the corrected (mutually-consistent) poses. Caller holds the
        lock with training idle."""
        frames = self._frames()
        ps = jax.device_put(
            nerf.init_pose_ba_state(int(frames.poses.shape[0])),
            shardlib.replicated(self.mesh),
        )
        # depth stays OUT of the joint objective: sparse-depth targets were
        # triangulated against the ORIGINAL pose graph, so once poses move
        # they anchor stale geometry and fight the photometric term
        # (measured on the room demo: depth-in-BA runs landed ~17 dB vs the
        # ~23 dB no-BA baseline even with the trust-region clip)
        self.state, ps = nerf.train_objects_joint_ba(
            self.state, ps, objs, frames, self.cfg, self.spec,
            self.joint_ba_iters, use_depth=False,
        )
        n = self.store.count
        old = np.asarray(self.store._poses[:n], np.float32).copy()
        corrected = nerf.apply_pose_ba(
            old, jax.tree.map(lambda a: a[:n] if a.ndim else a, ps),
        )
        delta_t = np.linalg.norm(corrected[:, :3, 3] - old[:, :3, 3], axis=1)
        self.store._poses[:n] = corrected
        self.store.mark_poses_dirty()
        # gauge transport for eval views: the fields now live in the
        # corrected-pose gauge, but RenderNeRFsTest views arrive with
        # frontend poses. Each eval view is transported rigidly with its
        # nearest-in-time keyframe — the camera-to-camera relative pose is
        # preserved: Twc_view' = Twc_kf' @ inv(Twc_kf) @ Twc_view (the
        # world-side correction of the keyframe, applied on the left) —
        # before per-view photometric refinement.
        kf_stamps = np.full(n, np.nan)
        for s, i in self.store.stamp_to_idx.items():
            if i < n:
                try:
                    kf_stamps[i] = float(s)
                except ValueError:
                    pass
        self._jba_transport = (kf_stamps, old, corrected.copy())
        print(f"joint BA: {self.joint_ba_iters} iters over {n} keyframes, "
              f"mean |dt| {delta_t.mean():.4f} max {delta_t.max():.4f}",
              flush=True)

    def wait_threads_end(self) -> None:
        """ref WaitThreadsEnd nerf_manager.cu:263-278: drain pending work,
        then one final wave + mesh per active object (ref nerf.cu:246-251).
        With joint_ba_iters > 0, a joint (field, keyframe-pose) photometric
        BA block runs first (beyond the reference)."""
        self._finish.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.final_retrain:
            with self._lock:
                self._wait_idle_locked()
                n_slots = 0
                n_waves = 0
                if self.state is not None:
                    for idx in range(self._n_objects):
                        # gate on the LIFETIME budget: _wave_count is zeroed
                        # by mid-run volume updates, so a slot whose last
                        # reinit came after its last wave would be skipped
                        # (and one reinitialized late would retrain with
                        # only its post-reinit waves — measured -1.0 dB)
                        if self._waves_earned[idx] <= 0:
                            continue
                        self.state = shardlib.shard_objects(
                            nerf.reinit_slot(
                                self.state, self._next_reinit_key(idx),
                                np.int32(idx), self.cfg, self.spec,
                            ),
                            self.mesh,
                        )
                        self._pending_waves[idx] = self._waves_earned[idx]
                        n_waves += int(self._waves_earned[idx])
                        self._wave_count[idx] = 0
                        n_slots += 1
                        self._meshes.pop(idx, None)
                if n_slots:
                    print(f"final retrain: re-initialized {n_slots} slot(s), "
                          f"re-credited {n_waves} wave(s) on the refined "
                          "pose graph", flush=True)
        self.pump()  # drain
        with self._cond:
            self._wait_idle_locked()
            mask = self._objs["n_bbox"] > MIN_BBOXES_TO_TRAIN
            if mask.any():
                objs = self._objects_state(mask)
                if self.joint_ba_iters > 0:
                    self._joint_ba(objs)
                for _ in range(self.final_waves):
                    self.state = nerf.train_objects(
                        self.state, objs, self._frames(), self.cfg,
                        self.spec, self.iters_per_wave, self.use_depth,
                    )
                jax.block_until_ready(self.state)
        if mask.any() and self.mesh_enabled:
            for oi in np.nonzero(mask)[0]:
                self._extract_mesh(int(oi))
        # session snapshot for offline debugging/resume (beyond the
        # reference, whose params die with the process — SURVEY §5)
        ckpt = os.environ.get("ROMAP_SAVE_STATE")
        if ckpt:
            from romap_tpu.utils.checkpoint import save_checkpoint

            with self._cond:
                self._wait_idle_locked()
                save_checkpoint(
                    ckpt, self.state,
                    extra={"objs": {k: np.asarray(v).tolist()
                                    for k, v in self._objs.items()
                                    if k in ("aabb_min", "aabb_max",
                                             "instance_id", "n_bbox")},
                           "tow": np.asarray(self._objs["tow"]).tolist(),
                           "n_objects": self._n_objects},
                )
            print(f"state checkpoint saved to {ckpt}", flush=True)
        print("All NeRF slots completed ...")

    # ------------------------------------------------------------ inference
    def get_mesh(self, idx: int):
        """Viewer-side mesh fetch (ref DrawMesh -> DrawCPUMesh)."""
        with self._lock:
            return self._meshes.get(idx)

    def losses(self) -> np.ndarray:
        with self._cond:
            self._wait_idle_locked()
            return np.asarray(jax.device_get(self.state.loss))[: self._n_objects]

    def render_nerfs_test(self, out_path: str, idx: int, stamps, boxes, twcs,
                          radius: float, video: bool = True,
                          pixels=None) -> None:
        """ref RenderNeRFsTest nerf_manager.cu:280-285 -> RenderTestImg.

        `pixels`: optional per-view (rgb u8 crop, object-mask u8 crop) of
        the ORIGINAL image at the bbox. When present, each such view's pose
        is photometrically refined against the trained frozen field before
        rendering (held-out views keep raw tracking poses otherwise — the
        dominant online eval error; see runtime/pose_refine.py)."""
        with self._cond:
            self._wait_idle_locked()
            params = jax.tree.map(lambda a: a[idx], self.state.ema)
        twcs = [np.asarray(t, np.float32) for t in twcs]
        transport = getattr(self, "_jba_transport", None)
        if transport is not None:
            kf_stamps, old_twc, new_twc = transport
            valid = np.isfinite(kf_stamps)
            for i, s in enumerate(stamps):
                try:
                    t = float(s)
                except ValueError:
                    continue
                cand = np.where(valid)[0]
                if not len(cand):
                    break
                k = cand[np.argmin(np.abs(kf_stamps[cand] - t))]
                twcs[i] = new_twc[k] @ np.linalg.inv(old_twc[k]) @ twcs[i]
        dbg = os.environ.get("ROMAP_SAVE_STATE")
        if dbg and pixels is not None:
            import pickle

            with open(f"{dbg}.refine_obj{idx}.pkl", "wb") as f:
                pickle.dump({
                    "stamps": stamps, "boxes": boxes, "twcs": twcs,
                    "pixels": pixels, "tow": self._objs["tow"][idx],
                    "aabb_min": self._objs["aabb_min"][idx],
                    "aabb_max": self._objs["aabb_max"][idx],
                    "intrinsics": np.asarray(self.store._intrinsics),
                    "radius": radius,
                }, f)
        if pixels is not None and any(p is not None for p in pixels):
            from romap_tpu.runtime import pose_refine

            sel = [i for i, p in enumerate(pixels) if p is not None]
            refined, stats = pose_refine.refine_view_poses_host(
                params, self.store._intrinsics,
                [twcs[i] for i in sel], self._objs["tow"][idx],
                self._objs["aabb_min"][idx], self._objs["aabb_max"][idx],
                [tuple(int(v) for v in boxes[i]) for i in sel],
                [pixels[i] for i in sel], self.cfg, self.spec,
            )
            for i, t in zip(sel, refined):
                twcs[i] = t
            print(f"pose refine: object {idx}: {stats['refined']}/{len(sel)} "
                  f"views improved, loss {stats.get('mean_loss_before', 0):.4f}"
                  f" -> {stats.get('mean_loss_after', 0):.4f}", flush=True)
        test_views = [
            dict(stamp=s, twc=np.asarray(t, np.float32),
                 box=tuple(int(v) for v in b))
            for s, b, t in zip(stamps, boxes, twcs)
        ]
        # training manifest from the slot's bbox table
        nb = int(self._objs["n_bbox"][idx])
        idx_to_stamp = {v: k for k, v in self.store.stamp_to_idx.items()}
        train_views = []
        for row in self._objs["bboxes"][idx, :nb]:
            fid = int(row[0])
            train_views.append(
                dict(stamp=idx_to_stamp.get(fid, str(fid)),
                     twc=self.store._poses[fid],
                     box=(int(row[1]), int(row[2]), int(row[3]), int(row[4])))
            )
        artifacts.render_test_artifacts(
            out_path, idx, params, self.store._intrinsics,
            self._objs["tow"][idx], self._objs["aabb_min"][idx],
            self._objs["aabb_max"][idx], (self.store.h, self.store.w),
            test_views, train_views, self._classes[idx], radius,
            self.cfg, self.spec, video=video,
        )
