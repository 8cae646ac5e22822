"""Multi-device object-axis sharding on the 8-virtual-device CPU mesh
(stand-in for a multi-card host, SURVEY.md §4e) + the driver entry contract."""

import jax
import numpy as np
import pytest

from romap_tpu.parallel import sharding


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual CPU devices"


def test_sharded_train_step_matches_single_device():
    from romap_tpu.data.world import build_synthetic_world
    from romap_tpu.models import nerf
    from tests.test_train_step import tiny_cfg

    cfg = tiny_cfg()
    spec = nerf.make_field_spec(cfg)
    capacity = 8
    _, _, _, store, objs = build_synthetic_world(
        n_objects=4, n_frames=4, res=48, capacity=capacity
    )
    frames = store.arrays()
    state0 = nerf.init_train_state(jax.random.PRNGKey(0), capacity, cfg, spec)

    # single-device result
    s_single = nerf.train_objects(
        jax.tree.map(np.copy, state0), objs, frames, cfg, spec, 3
    )

    # sharded over the 8-device mesh
    mesh = sharding.make_mesh()
    state = sharding.shard_objects(jax.tree.map(np.copy, state0), mesh)
    objs_s = sharding.shard_objects(objs, mesh)
    frames_r = sharding.replicate(frames, mesh)
    s_shard = nerf.train_objects(state, objs_s, frames_r, cfg, spec, 3)

    # numerically identical parameters
    for a, b in zip(jax.tree.leaves(s_single.params), jax.tree.leaves(s_shard.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    # and the sharding actually spans the mesh
    leaf = jax.tree.leaves(s_shard.params)[0]
    assert len(leaf.sharding.device_set) == 8


def test_graft_entry_contract():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    shapes = jax.tree.map(lambda x: x.shape, out)
    assert shapes[0] == (4, 256, 3)

    ge.dryrun_multichip(8)
