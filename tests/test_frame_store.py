"""FrameStore incremental-upload semantics: pose rewrites and single-frame
additions must NOT re-upload the whole store (~150 MB per keyframe on the
online room demo before this), while contents stay exactly equal to a
from-scratch upload."""

import numpy as np
import pytest

from romap_tpu.data.frame_store import FrameStore


def make_store(n=6, res=16, use_depth=True):
    store = FrameStore(n, res, res, [res, res, res / 2, res / 2],
                       use_depth=use_depth)
    rng = np.random.default_rng(0)
    for i in range(n):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [i, 0, 0]
        store.add_frame(
            i, f"{i:.6f}",
            rng.integers(0, 255, (res, res, 3), dtype=np.uint8),
            (rng.random((res, res)) < 0.5).astype(np.uint8),
            pose,
            rng.random((res, res)).astype(np.float32) if use_depth else None,
        )
    return store, rng


def test_pose_rewrite_does_not_reupload_pixels():
    store, _ = make_store()
    a0 = store.arrays()
    new_poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    new_poses[:, :3, 3] = [[9, 9, 9], [8, 8, 8], [7, 7, 7]]
    store.update_poses(1, new_poses)
    a1 = store.arrays()
    # pixels/instance/depth buffers are the SAME device arrays (no transfer)
    assert a1.pixels is a0.pixels
    assert a1.instance is a0.instance
    assert a1.depth is a0.depth
    # poses were re-uploaded and carry the rewrite
    np.testing.assert_allclose(np.asarray(a1.poses[2]), new_poses[1])


def test_single_frame_add_scatters_incrementally():
    store, rng = make_store()
    a0 = store.arrays()
    px = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    inst = np.ones((16, 16), np.uint8)
    pose = np.eye(4, dtype=np.float32)
    store.add_frame(3, "3.000000", px, inst, pose,
                    np.full((16, 16), 2.0, np.float32))
    a1 = store.arrays()
    # scattered block landed, untouched frames identical
    np.testing.assert_array_equal(np.asarray(a1.pixels[3]), px)
    np.testing.assert_array_equal(np.asarray(a1.instance[3]), inst)
    np.testing.assert_allclose(np.asarray(a1.depth[3]), 2.0)
    np.testing.assert_array_equal(np.asarray(a1.pixels[0]),
                                  np.asarray(a0.pixels[0]))


@pytest.mark.parametrize("use_depth", [False, True])
def test_incremental_equals_fresh_upload(use_depth):
    """Interleaved adds/rewrites through the incremental path match a
    from-scratch device upload of the same host state bit-for-bit."""
    store, rng = make_store(use_depth=use_depth)
    store.arrays()
    # a few incremental mutations, pulling arrays() between them
    for step in range(3):
        px = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
        store.add_frame(step, f"{step}.000000", px,
                        np.full((16, 16), step, np.uint8),
                        np.eye(4, dtype=np.float32),
                        np.full((16, 16), step, np.float32)
                        if use_depth else None)
        store.arrays()
    pz = np.tile(np.eye(4, dtype=np.float32), (store.count, 1, 1))
    pz[:, 2, 3] = np.arange(store.count)
    store.update_poses(0, pz)
    inc = store.arrays()

    fresh = FrameStore(store.count, 16, 16, np.asarray(store._intrinsics),
                       use_depth=use_depth)
    fresh._pixels[:] = store._pixels[: store.count]
    fresh._instance[:] = store._instance[: store.count]
    if use_depth:
        fresh._depth[:] = store._depth[: store.count]
    fresh._poses[:] = store._poses[: store.count]
    fresh.count = store.count
    ref = fresh.arrays()
    np.testing.assert_array_equal(np.asarray(inc.pixels),
                                  np.asarray(ref.pixels))
    np.testing.assert_array_equal(np.asarray(inc.instance),
                                  np.asarray(ref.instance))
    np.testing.assert_array_equal(np.asarray(inc.depth),
                                  np.asarray(ref.depth))
    np.testing.assert_array_equal(np.asarray(inc.poses),
                                  np.asarray(ref.poses))


def test_growth_forces_full_reupload_and_keeps_content():
    store, rng = make_store(n=2)
    store.arrays()
    px = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    store.add_frame(4, "4.000000", px, np.zeros((16, 16), np.uint8),
                    np.eye(4, dtype=np.float32),
                    np.zeros((16, 16), np.float32))
    a = store.arrays()
    assert a.pixels.shape[0] == store.capacity >= 5
    np.testing.assert_array_equal(np.asarray(a.pixels[4]), px)
