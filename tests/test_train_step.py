"""Batched multi-object train step: convergence, slot masking, determinism.

Runs on CPU with a shrunken config (few rays/samples, small encoding) — the
pipeline is identical to the flagship, only sizes differ.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from romap_tpu.config import EncodingConfig, NerfConfig, TrainConfig
from romap_tpu.data.world import build_synthetic_world
from romap_tpu.models import nerf


def tiny_cfg(**train_kw):
    return NerfConfig(
        encoding=EncodingConfig(kind="mxgrid", mx_levels=3, mx_max_resolution=64,
                                mx_features=16, mx_plane_res=32, mx_plane_features=8),
        train=TrainConfig(rays_per_batch=512, samples_per_ray=16, **train_kw),
    )


def build_tiny_world(n_objects=2, res=48, n_frames=6, use_depth=False):
    # one extra INACTIVE slot beyond the real objects
    return build_synthetic_world(
        n_objects, n_frames, res, use_depth=use_depth, capacity=n_objects + 1
    )


def test_training_decreases_loss_and_masks_inactive_slots():
    cfg = tiny_cfg()
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_tiny_world()
    state = nerf.init_train_state(jax.random.PRNGKey(0), objs.capacity, cfg, spec)
    p0 = jax.tree.map(np.asarray, state.params)
    arrays = store.arrays()

    state = nerf.train_objects(state, objs, arrays, cfg, spec, 5)
    loss_early = np.asarray(state.loss)
    state = nerf.train_objects(state, objs, arrays, cfg, spec, 60)
    loss_late = np.asarray(state.loss)

    active = np.asarray(objs.active)
    assert (loss_late[active] < loss_early[active]).all(), (loss_early, loss_late)
    assert np.isfinite(loss_late[active]).all()
    # the inactive slot must be bit-identical to its init
    p1 = jax.tree.map(np.asarray, state.params)
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
        np.testing.assert_array_equal(a[~active], b[~active])
        assert (a[active] != b[active]).any()
    assert (np.asarray(state.step)[~active] == 0).all()
    assert (np.asarray(state.step)[active] == 65).all()


def test_train_step_deterministic():
    cfg = tiny_cfg()
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_tiny_world(n_objects=1)
    arrays = store.arrays()
    s1 = nerf.init_train_state(jax.random.PRNGKey(3), objs.capacity, cfg, spec)
    s2 = nerf.init_train_state(jax.random.PRNGKey(3), objs.capacity, cfg, spec)
    s1 = nerf.train_objects(s1, objs, arrays, cfg, spec, 3)
    s2 = nerf.train_objects(s2, objs, arrays, cfg, spec, 3)
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_depth_supervision_path():
    cfg = tiny_cfg()
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_tiny_world(n_objects=1, use_depth=True)
    state = nerf.init_train_state(jax.random.PRNGKey(1), objs.capacity, cfg, spec)
    state = nerf.train_objects(state, objs, store.arrays(), cfg, spec, 20,
                               use_depth=True)
    assert np.isfinite(np.asarray(state.loss)[0])


def test_ema_tracks_params():
    cfg = tiny_cfg()
    spec = nerf.make_field_spec(cfg)
    _, _, _, store, objs = build_tiny_world(n_objects=1)
    state = nerf.init_train_state(jax.random.PRNGKey(2), objs.capacity, cfg, spec)
    state = nerf.train_objects(state, objs, store.arrays(), cfg, spec, 10)
    # EMA should lag params but not equal them, and not equal init
    p = np.asarray(jax.tree.leaves(state.params)[0][0])
    e = np.asarray(jax.tree.leaves(state.ema)[0][0])
    assert not np.array_equal(p, e)
    assert np.abs(p - e).mean() < np.abs(p).mean()  # EMA is closer to the path
