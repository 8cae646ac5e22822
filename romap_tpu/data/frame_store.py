"""Device-resident keyframe store shared by every object NeRF.

Equivalent of the reference's NeRF_Dataset GPU arrays (ref
Core/src/nerf_data.cu: MetaData{pixels, depth, instance, Pose}, intrinsics),
with these changes:

  * pixels are stored as uint8 in device memory (the reference stores fp32, 4x the
    bandwidth/footprint; we convert after the gather);
  * struct-of-arrays with a fixed frame capacity (static shapes for jit);
    the online mode preallocates capacity like the reference preallocates
    nimages/3 slots (ref src/System.cc:135-138);
  * a single store serves all objects (the reference replicates the dataset
    per GPU; on a device mesh the store is replicated across devices by
    the sharding layer, see parallel/sharding.py).

Host-side bookkeeping (stamp -> index) lives in FrameStore; the jnp arrays
(FrameArrays) are what flows into jitted train/render steps.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class FrameArrays(NamedTuple):
    """Device arrays with a fixed frame capacity F (leading axis)."""

    pixels: jax.Array  # [F, H, W, 3] uint8, RGB
    depth: jax.Array  # [F, H, W] float32 ray-independent z-depth, or [1,1,1]
    instance: jax.Array  # [F, H, W] uint8 instance/class mask
    poses: jax.Array  # [F, 4, 4] float32 Twc (camera-to-world)
    intrinsics: jax.Array  # [4] float32 (fx, fy, cx, cy)

    @property
    def has_depth(self) -> bool:
        return self.depth.ndim == 3 and self.depth.shape[1] > 1


@jax.jit
def _set_frame(arr: jax.Array, idx, block: jax.Array) -> jax.Array:
    """Scatter one frame's block into the resident device array (a device-
    side dynamic-update-slice: no host transfer beyond the block itself)."""
    return arr.at[idx].set(block)


class FrameStore:
    """Host coordinator over FrameArrays (stamp->idx map + incremental upload)."""

    def __init__(
        self,
        capacity: int,
        h: int,
        w: int,
        intrinsics,
        use_depth: bool,
        depth_scale: float = 1.0,
    ):
        self.capacity = capacity
        self.h = h
        self.w = w
        self.use_depth = use_depth
        self.depth_scale = depth_scale
        self.stamp_to_idx: dict[str, int] = {}
        self.count = 0
        # Host staging buffers (numpy); pushed to device lazily in batches.
        self._pixels = np.zeros((capacity, h, w, 3), np.uint8)
        self._depth = (
            np.zeros((capacity, h, w), np.float32)
            if use_depth
            else np.zeros((1, 1, 1), np.float32)
        )
        self._instance = np.zeros((capacity, h, w), np.uint8)
        self._poses = np.tile(np.eye(4, dtype=np.float32), (capacity, 1, 1))
        self._intrinsics = np.asarray(intrinsics, np.float32)
        # Incremental dirty tracking. A store-wide dirty bit re-uploads the
        # WHOLE store on any change — ~150 MB per keyframe on the online
        # room demo (every post-BA pose rewrite dragged all pixels along),
        # starving the training waves.
        # Instead: changed frames scatter device-side one block at a time,
        # and a pose rewrite re-uploads only the [F,4,4] pose table (~KB).
        self._dirty_full = True  # init / growth / placement change
        self._dirty_frames: set[int] = set()
        self._dirty_poses = False
        self._arrays: FrameArrays | None = None

    def _grow(self, min_capacity: int) -> None:
        """Grow the frame budget (the reference hard-crashes when its
        preallocated nimages/3 slots run out; we reallocate instead — the
        next jitted step recompiles once for the new shape)."""
        new_cap = max(min_capacity, int(self.capacity * 3 / 2) + 1)
        pad = new_cap - self.capacity

        def grow(a):
            return np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
            )

        self._pixels = grow(self._pixels)
        self._instance = grow(self._instance)
        if self.use_depth:
            self._depth = grow(self._depth)
        eye = np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))
        self._poses = np.concatenate([self._poses, eye], axis=0)
        self.capacity = new_cap
        self._dirty_full = True

    def add_frame(
        self, idx: int, stamp: str, rgb_u8, instance_u8, pose_twc, depth=None
    ) -> None:
        """Upload one keyframe (ref NeRF_Dataset::FrameDataToGPU nerf_data.cu:273-339)."""
        if idx >= self.capacity:
            self._grow(idx + 1)
        self.stamp_to_idx[stamp] = idx
        self._pixels[idx] = rgb_u8
        self._instance[idx] = instance_u8
        self._poses[idx] = np.asarray(pose_twc, np.float32)
        if self.use_depth and depth is not None:
            self._depth[idx] = np.asarray(depth, np.float32) * self.depth_scale
        self.count = max(self.count, idx + 1)
        self._dirty_frames.add(idx)
        self._dirty_poses = True

    def update_poses(self, start: int, poses) -> None:
        """Rewrite a pose window (ref NeRF_Dataset::UpdateDataGPU nerf_data.cu:341-353)."""
        poses = np.asarray(poses, np.float32)
        self._poses[start : start + len(poses)] = poses
        self._dirty_poses = True

    def mark_poses_dirty(self) -> None:
        """For callers that rewrite self._poses in place (joint BA)."""
        self._dirty_poses = True

    def arrays(self, sharding=None) -> FrameArrays:
        """Device view, updated incrementally: new/changed frames scatter
        into the resident device arrays block-by-block; pose rewrites
        re-upload only the pose table. A full re-upload happens only at
        init, growth, a placement change, or when most of the store
        changed at once (bulk offline load)."""
        placement_changed = sharding != getattr(self, "_last_sharding", ())
        full = (
            self._dirty_full
            or self._arrays is None
            or placement_changed
            # bulk load: scattering frame-by-frame would be slower than
            # one contiguous transfer
            or 2 * len(self._dirty_frames) >= max(self.count, 1)
        )
        put = (lambda x: jax.device_put(x, sharding)) if sharding else jnp.asarray
        if full:
            self._last_sharding = sharding
            self._arrays = FrameArrays(
                pixels=put(self._pixels),
                depth=put(self._depth),
                instance=put(self._instance),
                poses=put(self._poses),
                intrinsics=put(self._intrinsics),
            )
        elif self._dirty_frames or self._dirty_poses:
            a = self._arrays
            for idx in sorted(self._dirty_frames):
                a = a._replace(
                    pixels=_set_frame(a.pixels, idx, put(self._pixels[idx])),
                    instance=_set_frame(
                        a.instance, idx, put(self._instance[idx])),
                )
                if self.use_depth:
                    a = a._replace(
                        depth=_set_frame(a.depth, idx, put(self._depth[idx])))
            if self._dirty_poses:
                a = a._replace(poses=put(self._poses))
            self._arrays = a
        self._dirty_full = False
        self._dirty_frames.clear()
        self._dirty_poses = False
        return self._arrays
