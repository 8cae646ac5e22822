"""The batched multi-object NeRF: one parameter table, one train step.

This module inverts the reference's thread-per-object architecture
(ref Core/src/nerf_manager.cu:256-260): every object NeRF lives as one row of
a batched parameter pytree (hash table [O, T, F], MLP weights [O, ...]) inside
a fixed-capacity object table. A single jitted, vmapped `train_objects` step
trains all active objects at once — 64-wide MLPs only fill an accelerator
when the object x ray x sample axes are fused into large matmuls — and one shared
optimizer update advances them, with per-object masking standing in for
object creation/finish (no threads, no locks; device state is functional).

Pipeline per object (all static shapes):
  generate_batch   <- GenerateRays + fill_rollover_rays + GenerateInputPoints
                      (ref nerf_model.cu:369-446, 280-294, 536-591); the CUDA
                      atomicAdd compaction becomes a stable argsort + modular
                      rollover gather.
  field_apply      <- tcnn NetworkWithInputEncoding (hash grid + tiny MLP)
  composite_loss   <- VolumeRender + VolumeRenderGradient_No_Compacted via
                      jax.grad (ops/losses.py)
  optimizer        <- Adam(1e-2,.9,.99,eps 1e-15) + l2 1e-6 + exp-decay
                      schedule + params-EMA(.95) (ref base.json:5-22)
"""

from __future__ import annotations

import os
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from romap_tpu.config import NerfConfig
from romap_tpu.data.frame_store import FrameArrays
from romap_tpu.ops import hashgrid, mxgrid
from romap_tpu.ops.geometry import (
    camera_rays,
    ray_aabb_intersect,
    stratified_distances,
    warp_point,
)
from romap_tpu.ops.losses import RayBatch, composite_loss
from romap_tpu.ops.mlp import apply_mlp, init_mlp
from romap_tpu.ops.render import render_composite, volume_render


# --------------------------------------------------------------------------
# Parameters and state
# --------------------------------------------------------------------------


def make_field_spec(cfg: NerfConfig):
    """Static encoding spec from config (mxgrid or hashgrid)."""
    if cfg.encoding.kind == "mxgrid":
        snap_env = os.environ.get("MX_SNAP")
        return mxgrid.make_mxspec(
            n_levels=cfg.encoding.mx_levels,
            base_resolution=cfg.encoding.base_resolution,
            max_resolution=cfg.encoding.mx_max_resolution,
            features=cfg.encoding.mx_features,
            plane_specs=cfg.encoding.plane_specs,
            plane_axes=cfg.encoding.mx_plane_axes,
            snap_levels=(cfg.encoding.mx_snap_levels if snap_env is None
                         else snap_env != "0"),
        )
    return hashgrid.make_spec(cfg.encoding)


def init_object_params(key: jax.Array, cfg: NerfConfig, spec):
    """Parameters of ONE object NeRF (vmap over keys for the batched table)."""
    k_table, k_mlp = jax.random.split(key)
    if isinstance(spec, mxgrid.MXGridSpec):
        table = mxgrid.init_mxgrid(k_table, spec)
    else:
        table = hashgrid.init_table(k_table, spec)
    return {
        "table": table,
        "mlp": init_mlp(k_mlp, spec.n_output_dims, cfg.network),
    }


def field_apply(
    params, points: jax.Array, cfg: NerfConfig, spec, dtype=None
) -> jax.Array:
    """points [..., 3] in [0,1]^3 -> raw (rgb logits, log-sigma) [..., 4].

    `dtype` overrides the compute dtype (params are stored fp32 and cast at
    use); the render/mesh paths pass fp32 to match the reference's fp32
    inference (ref nerf_model.cu:1795) while training runs the config dtype.
    With `dtype` given, matmuls also run at full fp32 ("highest"): under
    TF32, the GPU's default for fp32 matmuls, a trained field's render
    differed from the CPU's by up to 1.0 in mask and 0.45 in rgb (PERF.md).
    """
    if dtype is not None:
        with jax.default_matmul_precision("highest"):
            return _field_apply(params, points, cfg, spec, dtype)
    return _field_apply(params, points, cfg, spec, None)


def _field_apply(params, points, cfg: NerfConfig, spec, dtype) -> jax.Array:
    if dtype is None:
        cd = cfg.train.compute_dtype
        if cd == "auto":
            cd = "float32" if jax.default_backend() == "cpu" else "bfloat16"
        dtype = jnp.bfloat16 if cd == "bfloat16" else jnp.float32
    table = jax.tree.map(lambda a: a.astype(dtype), params["table"])
    mlp = jax.tree.map(lambda a: a.astype(dtype), params["mlp"])
    with jax.named_scope("encode"):
        if isinstance(spec, mxgrid.MXGridSpec):
            feats = mxgrid.encode(table, points, spec)
        else:
            feats = hashgrid.encode(table, points, spec,
                                    impl=cfg.encoding.hash_impl)
    with jax.named_scope("mlp"):
        return apply_mlp(mlp, feats.astype(dtype), cfg.network)


class ObjectsState(NamedTuple):
    """Fixed-capacity object table (leading axis O = object slots)."""

    aabb_min: jax.Array  # [O, 3] object-frame bbox (already inflated)
    aabb_max: jax.Array  # [O, 3]
    tow: jax.Array  # [O, 4, 4] world->object transforms
    instance_id: jax.Array  # [O] int32 instance/class id in the masks
    bboxes: jax.Array  # [O, B, 5] int32 (frame_id, x, y, h, w)
    n_bbox: jax.Array  # [O] int32 valid rows in bboxes
    active: jax.Array  # [O] bool slot in use & allowed to train

    @property
    def capacity(self) -> int:
        return self.aabb_min.shape[0]


def empty_objects(capacity: int, max_bboxes: int) -> ObjectsState:
    return ObjectsState(
        aabb_min=jnp.zeros((capacity, 3), jnp.float32),
        aabb_max=jnp.ones((capacity, 3), jnp.float32),
        tow=jnp.tile(jnp.eye(4, dtype=jnp.float32), (capacity, 1, 1)),
        instance_id=jnp.zeros((capacity,), jnp.int32),
        bboxes=jnp.zeros((capacity, max_bboxes, 5), jnp.int32),
        n_bbox=jnp.zeros((capacity,), jnp.int32),
        active=jnp.zeros((capacity,), bool),
    )


class TrainState(NamedTuple):
    """Per-object training state, all leaves carry a leading O axis."""

    params: Any  # batched pytree
    ema: Any  # EMA of params, used for inference/render/mesh (tcnn Ema)
    opt_state: Any  # optax state (batched)
    key: jax.Array  # [O, 2] uint32 per-object PRNG keys
    step: jax.Array  # [O] int32 per-object training step counter
    loss: jax.Array  # [O] float32 last logged loss (ref mfPerTrainLoss)


def make_optimizer(cfg: NerfConfig) -> optax.GradientTransformation:
    """Adam + additive L2, lr applied separately via the exp-decay schedule.

    zero_nans guards against a single bad batch poisoning a slot's params
    (tcnn's fp16 pipeline drops inf/nan steps via its loss-scaler; this is
    the fp32 equivalent).
    """
    o = cfg.optimizer
    return optax.chain(
        optax.zero_nans(),
        optax.add_decayed_weights(o.l2_reg),
        optax.scale_by_adam(b1=o.beta1, b2=o.beta2, eps=o.epsilon),
    )


def learning_rate(cfg: NerfConfig, step: jax.Array) -> jax.Array:
    """ExponentialDecay(start 20k, interval 10k, base .33) around Adam.

    (ref base.json:10-14; tcnn multiplies by decay_base once at decay_start and
    again every decay_interval steps.)
    """
    o = cfg.optimizer
    n = jnp.maximum(0, (step - o.decay_start) // o.decay_interval + 1)
    return o.learning_rate * o.decay_base ** n.astype(jnp.float32)


def init_train_state(
    key: jax.Array, capacity: int, cfg: NerfConfig, spec
) -> TrainState:
    keys = jax.random.split(key, capacity)
    params = jax.vmap(lambda k: init_object_params(k, cfg, spec))(keys)
    tx = make_optimizer(cfg)
    opt_state = jax.vmap(tx.init)(params)
    return TrainState(
        params=params,
        ema=jax.tree.map(jnp.copy, params),
        opt_state=opt_state,
        key=jax.vmap(lambda k: jax.random.fold_in(k, 7))(keys),
        step=jnp.zeros((capacity,), jnp.int32),
        loss=jnp.zeros((capacity,), jnp.float32),
    )


@partial(jax.jit, static_argnames=("cfg", "spec"), donate_argnums=0)
def reinit_slot(
    state: TrainState, key: jax.Array, idx: jax.Array, cfg: NerfConfig, spec
) -> TrainState:
    """Re-initialize one object row (params/EMA/optimizer/step) in place.

    Used when the object's training volume changes (the learned field is
    tied to the old unit-cube warp, so its content is meaningless in the
    new box). Every TrainState leaf carries a leading object axis, so the
    fresh single-object state scatters in with a row write. One jitted
    program, so a reinit is one dispatch and one compile, not one per
    leaf."""
    fresh = init_train_state(key, 1, cfg, spec)
    return jax.tree.map(lambda a, b: a.at[idx].set(b[0]), state, fresh)


# --------------------------------------------------------------------------
# Batch generation (ref GenerateRays nerf_model.cu:369-446)
# --------------------------------------------------------------------------


def generate_batch(
    key: jax.Array,
    frames: FrameArrays,
    aabb_min: jax.Array,
    aabb_max: jax.Array,
    tow: jax.Array,
    instance_id: jax.Array,
    bboxes: jax.Array,
    n_bbox: jax.Array,
    cfg: NerfConfig,
    *,
    use_depth: bool,
) -> RayBatch:
    """Sample one training batch of R rays x S samples for one object.

    Rays are drawn uniformly inside the per-frame 2D bboxes, round-robin over
    bboxes (ref :381). Pixels of OTHER objects are occluders and their rays
    are dropped (ref :398-401); rays missing the object AABB are dropped
    (ref :415-424). Surviving rays are compacted (stable, deterministic —
    the CUDA version's atomicAdd order is not) and rolled over modulo the
    valid count to fill the batch (ref fill_rollover_rays :280-294).
    """
    r = cfg.train.rays_per_batch
    s = cfg.train.samples_per_ray
    k_xy, k_color, k_jitter = jax.random.split(key, 3)

    # Row lookups as one-hot matmuls instead of gathers — exact only with
    # HIGHEST precision: a reduced-precision f32 dot (bf16 passes, TF32)
    # would round fids/coords > 256 and truncate pose entries.
    i = jnp.arange(r)
    idx_box = i % jnp.maximum(n_bbox, 1)
    oh_box = jax.nn.one_hot(idx_box, bboxes.shape[0], dtype=jnp.float32)
    box = jnp.matmul(  # [R, 5] (fid, x, y, h, w)
        oh_box, bboxes.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    fid = box[:, 0].astype(jnp.int32)
    bx, by = box[:, 1].astype(jnp.int32), box[:, 2].astype(jnp.int32)
    bh, bw = box[:, 3], box[:, 4]

    u = jax.random.uniform(k_xy, (r, 2))
    x = bx + (u[:, 0] * bw).astype(jnp.int32)
    y = by + (u[:, 1] * bh).astype(jnp.int32)

    # Flat 1-D image gathers.
    f, h, w = frames.instance.shape
    lin = (fid * h + y) * w + x
    inst = frames.instance.reshape(-1)[lin].astype(jnp.int32)  # [R]
    occluded = (inst != 0) & (inst != instance_id)

    oh_f = jax.nn.one_hot(fid, f, dtype=jnp.float32)
    pose = jnp.matmul(
        oh_f, frames.poses.reshape(f, 16),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(r, 4, 4)
    o, d, d_norm = camera_rays(x, y, frames.intrinsics, pose, tow)
    tmin, tmax, hit = ray_aabb_intersect(o, d, aabb_min, aabb_max)
    tmin = jnp.maximum(tmin, 0.0)

    valid = hit & ~occluded
    is_obj = valid & (inst != 0)

    rgb_pix = frames.pixels.reshape(-1, 3)[lin].astype(jnp.float32) / 255.0
    colors = jax.random.uniform(k_color, (r, 3))
    rgb_target = jnp.where(is_obj[:, None], rgb_pix, colors)

    if use_depth:
        depth_target = jnp.where(
            is_obj, frames.depth.reshape(-1)[lin] * d_norm, 0.0
        )
    else:
        depth_target = jnp.zeros((r,), jnp.float32)

    # Deterministic compaction + modular rollover. The permutation that a
    # stable argsort of ~valid would produce, built O(R) from cumsum ranks
    # and one tiny scatter instead of a sort.
    cs_valid = jnp.cumsum(valid)
    n_valid = cs_valid[-1]
    rank = jnp.where(valid, cs_valid - 1, n_valid + jnp.cumsum(~valid) - 1)
    order = jnp.zeros((r,), jnp.int32).at[rank].set(
        i, unique_indices=True, mode="promise_in_bounds"
    )
    take = order[i % jnp.maximum(n_valid, 1)]

    # One stacked payload gather instead of nine.
    payload = jnp.concatenate(
        [o, d, d_norm[:, None], tmin[:, None], tmax[:, None], rgb_target,
         depth_target[:, None], is_obj[:, None].astype(jnp.float32), colors],
        axis=1,
    )[take]
    o, d = payload[:, 0:3], payload[:, 3:6]
    d_norm, tmin, tmax = payload[:, 6], payload[:, 7], payload[:, 8]
    rgb_target, depth_target = payload[:, 9:12], payload[:, 12]
    is_obj = payload[:, 13] > 0.5
    colors = payload[:, 14:17]

    jitter = jax.random.uniform(k_jitter, (r, s))
    t = stratified_distances(tmin, tmax, jitter, s)  # [R, S]
    pts = o[:, None, :] + t[..., None] * d[:, None, :]
    pts = warp_point(pts, aabb_min, aabb_max)

    return RayBatch(
        points=pts,
        t=t,
        rgb_target=rgb_target,
        depth_target=depth_target,
        is_object=is_obj,
        bg_color=colors,
        valid=n_valid > 0,
    )


# --------------------------------------------------------------------------
# Train step (single object -> vmapped over the object table)
# --------------------------------------------------------------------------


def _object_train_step(params, ema, opt_state, key, step, frames, obj, cfg, spec, tx, use_depth):
    """One SGD step for one object slot. Closed over static cfg/spec/tx."""
    aabb_min, aabb_max, tow, instance_id, bboxes, n_bbox, active = obj
    key, k_batch = jax.random.split(key)
    batch = generate_batch(
        k_batch, frames, aabb_min, aabb_max, tow, instance_id, bboxes, n_bbox,
        cfg, use_depth=use_depth,
    )

    def loss_fn(p):
        raw = field_apply(p, batch.points, cfg, spec)
        return composite_loss(raw, batch, cfg.train)

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    updates, new_opt_state = tx.update(grads, opt_state, params)
    lr = learning_rate(cfg, step)
    new_params = jax.tree.map(lambda p, u: p - lr * u, params, updates)
    decay = cfg.optimizer.ema_decay
    new_ema = jax.tree.map(lambda e, p: decay * e + (1.0 - decay) * p, ema, new_params)

    # Inactive slots / empty batches: keep ALL state unchanged.
    ok = active & batch.valid
    keep = lambda old, new: jax.tree.map(lambda a, b: jnp.where(ok, b, a), old, new)
    params = keep(params, new_params)
    ema = keep(ema, new_ema)
    opt_state = keep(opt_state, new_opt_state)
    step = jnp.where(ok, step + 1, step)
    logged = jnp.where(ok, aux["logged_loss"], 0.0)
    return params, ema, opt_state, key, step, logged


@partial(jax.jit, static_argnames=("cfg", "spec", "n_iters", "use_depth"),
         donate_argnames=("state",))
def train_objects(
    state: TrainState,
    objects: ObjectsState,
    frames: FrameArrays,
    cfg: NerfConfig,
    spec: hashgrid.HashGridSpec,
    n_iters: int,
    use_depth: bool = False,
) -> TrainState:
    """Run n_iters synchronized training steps over ALL object slots.

    The per-object step is vmapped over the object axis; the reference's
    per-object threads x 500-iteration waves (ref Train_Step nerf_model.cu:
    1630-1665) become a fori_loop around one fused step.
    """
    tx = make_optimizer(cfg)
    obj_tuple = (
        objects.aabb_min, objects.aabb_max, objects.tow, objects.instance_id,
        objects.bboxes, objects.n_bbox, objects.active,
    )

    step_fn = jax.vmap(
        lambda p, e, s, k, st, ob: _object_train_step(
            p, e, s, k, st, frames, ob, cfg, spec, tx, use_depth
        ),
        in_axes=(0, 0, 0, 0, 0, 0),
    )

    def body(_, st: TrainState) -> TrainState:
        params, ema, opt_state, key, step, logged = step_fn(
            st.params, st.ema, st.opt_state, st.key, st.step, obj_tuple
        )
        return TrainState(params, ema, opt_state, key, step, logged)

    return jax.lax.fori_loop(0, n_iters, body, state)


# --------------------------------------------------------------------------
# Joint photometric bundle adjustment: field + keyframe poses (BARF-style)
# --------------------------------------------------------------------------


class PoseBAState(NamedTuple):
    """Shared per-keyframe SE(3) correction optimized jointly with the
    fields. delta[0] is the gauge anchor (pinned to zero)."""

    delta: jax.Array  # [F, 6]
    m: jax.Array  # [F, 6] Adam moment 1
    v: jax.Array  # [F, 6] Adam moment 2
    step: jax.Array  # [] int32


def init_pose_ba_state(n_frames: int) -> PoseBAState:
    z = jnp.zeros((n_frames, 6), jnp.float32)
    return PoseBAState(z, jnp.zeros_like(z), jnp.zeros_like(z),
                       jnp.zeros((), jnp.int32))


@partial(jax.jit, static_argnames=("cfg", "spec", "n_iters", "use_depth"),
         donate_argnames=("state", "pose_state"))
def train_objects_joint_ba(
    state: TrainState,
    pose_state: PoseBAState,
    objects: ObjectsState,
    frames: FrameArrays,
    cfg: NerfConfig,
    spec,
    n_iters: int,
    use_depth: bool = False,
    pose_lr: float = 3e-3,
    pose_clip: float = 0.03,
) -> tuple[TrainState, PoseBAState]:
    """Joint (field, keyframe-pose) photometric optimization.

    Unlike per-view pose refinement against a FROZEN field (which is
    self-referential for the very poses the field trained on), the shared
    pose table here is constrained by multi-view consistency across every
    object's rays simultaneously while the fields keep adapting — the
    BARF/NeRF-SLAM block: poses Twc_f <- Twc_f @ exp(delta_f), delta_0
    pinned as the gauge anchor. Beyond the reference (which trains with
    SLAM poses as-is).

    pose_clip is a hard trust region (per-coordinate |delta| bound).
    Without it, Adam's magnitude-normalized steps let weakly-constrained
    keyframes random-walk at pose_lr per iteration — measured on the room
    demo at 800 iters: mean |dt| 0.26, max 1.43, held-out PSNR collapsed
    to 6 dB because the fields follow the drifting gauge while eval views
    are refined locally from raw SLAM poses and cannot recover a >1-unit
    shift. The clip bounds worst-case gauge drift to pose_clip*sqrt(6)
    (~0.07 at the default), well inside the eval refiner's multi-start
    capture basin, while still admitting the ~0.01-0.03 corrections that
    win on the synthetic diagnostic (+0.26 dB vs matched-budget control).
    """
    from romap_tpu.ops.geometry import se3_exp

    tx = make_optimizer(cfg)
    obj_tuple = (
        objects.aabb_min, objects.aabb_max, objects.tow, objects.instance_id,
        objects.bboxes, objects.n_bbox, objects.active,
    )

    def total_loss(params, delta, k_batch):
        posed = frames.poses @ se3_exp(delta)
        fr = frames._replace(poses=posed)

        def obj_loss(p, kb, ob):
            aabb_min, aabb_max, tow, iid, bboxes, n_bbox, active = ob
            batch = generate_batch(
                kb, fr, aabb_min, aabb_max, tow, iid, bboxes, n_bbox, cfg,
                use_depth=use_depth,
            )
            loss, aux = composite_loss(
                field_apply(p, batch.points, cfg, spec), batch, cfg.train
            )
            return loss, (aux["logged_loss"], batch.valid, active)

        losses, (logged, valid, active) = jax.vmap(obj_loss)(
            params, k_batch, obj_tuple
        )
        ok = active & valid
        return jnp.sum(jnp.where(ok, losses, 0.0)), (logged, ok)

    grad_fn = jax.value_and_grad(total_loss, argnums=(0, 1), has_aux=True)

    def body(_, carry):
        st, ps = carry
        keys = jax.vmap(lambda k: jax.random.split(k))(st.key)  # [O, 2, 2]
        key_next, k_batch = keys[:, 0], keys[:, 1]

        (_, (logged, ok)), (gp, gd) = grad_fn(st.params, ps.delta, k_batch)

        # field update (per-object optax, masked like _object_train_step)
        updates, new_opt = jax.vmap(tx.update)(gp, st.opt_state, st.params)
        lr = learning_rate(cfg, st.step)
        new_params = jax.tree.map(
            lambda p, u: p - lr.reshape((-1,) + (1,) * (u.ndim - 1)) * u,
            st.params, updates,
        )
        decay = cfg.optimizer.ema_decay
        new_ema = jax.tree.map(
            lambda e, p: decay * e + (1.0 - decay) * p, st.ema, new_params
        )
        keep = lambda old, new: jax.tree.map(
            lambda a, b: jnp.where(
                ok.reshape((-1,) + (1,) * (b.ndim - 1)), b, a
            ),
            old, new,
        )
        params = keep(st.params, new_params)
        ema = keep(st.ema, new_ema)
        opt_state = keep(st.opt_state, new_opt)
        step = jnp.where(ok, st.step + 1, st.step)
        logged = jnp.where(ok, logged, st.loss)

        # pose update (shared Adam; gauge row 0 pinned)
        gd = gd.at[0].set(0.0)
        it = (ps.step + 1).astype(jnp.float32)
        m = 0.9 * ps.m + 0.1 * gd
        v = 0.99 * ps.v + 0.01 * gd * gd
        mh = m / (1.0 - 0.9 ** it)
        vh = v / (1.0 - 0.99 ** it)
        delta = ps.delta - pose_lr * mh / (jnp.sqrt(vh) + 1e-8)
        delta = jnp.clip(delta, -pose_clip, pose_clip)
        delta = delta.at[0].set(0.0)
        return (
            TrainState(params, ema, opt_state, key_next, step, logged),
            PoseBAState(delta, m, v, ps.step + 1),
        )

    return jax.lax.fori_loop(0, n_iters, body, (state, pose_state))


def apply_pose_ba(poses: np.ndarray, pose_state: PoseBAState) -> np.ndarray:
    """Fold the optimized deltas into host Twc poses (Twc @ exp(delta))."""
    from romap_tpu.ops.geometry import se3_exp

    corr = np.asarray(jax.device_get(se3_exp(pose_state.delta)))
    return np.einsum("fij,fjk->fik", np.asarray(poses, np.float32), corr)


# --------------------------------------------------------------------------
# Inference: ray rendering + density grid (use EMA params, like tcnn's Ema)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "spec", "n_samples", "background"))
def render_rays(
    params,
    o: jax.Array,
    d: jax.Array,
    d_norm: jax.Array,
    tmin: jax.Array,
    tmax: jax.Array,
    in_bbox: jax.Array,
    jitter: jax.Array,
    aabb_min: jax.Array,
    aabb_max: jax.Array,
    cfg: NerfConfig,
    spec,
    n_samples: int = 64,
    background: float = 1.0,
):
    """Render a padded bundle of rays for ONE object (fp32, 64 samples/ray).

    Equivalent of GenerateRenderInputPoints + inference + VolumeRender_Render
    (ref nerf_model.cu:593-626, 1134-1229): gray background, mask threshold
    0.5, depth divided by d_norm.
    """
    t = stratified_distances(tmin, tmax, jitter, n_samples)
    pts = warp_point(o[:, None, :] + t[..., None] * d[:, None, :], aabb_min, aabb_max)
    raw = field_apply(params, pts, cfg, spec, dtype=jnp.float32)
    out = volume_render(raw, t, jnp.full((3,), background, jnp.float32))
    return render_composite(out, d_norm, in_bbox, background)


@partial(jax.jit, static_argnames=("cfg", "spec", "res"))
def density_on_grid(params, cfg: NerfConfig, spec, res: int) -> jax.Array:
    """Densities on a uniform res^3 grid over the unit cube (z-major flat order)
    (ref generate_grid_samples_nerf_uniform + GetDensityOnGrid,
    nerf_model.cu:296-309, 2007-2043).
    """
    lin = jnp.arange(res, dtype=jnp.float32) / (res - 1)
    z, y, x = jnp.meshgrid(lin, lin, lin, indexing="ij")  # idx = x + y*res + z*res^2
    pts = jnp.stack([x, y, z], axis=-1).reshape(-1, 3)
    raw = field_apply(params, pts, cfg, spec, dtype=jnp.float32)
    # same clipped exponential as the train/render path (ops/render.py:29-38)
    # so mesh extraction sees the rendered density field, never inf.
    from romap_tpu.ops.render import density_activation

    return density_activation(raw[..., 3].astype(jnp.float32))


@partial(jax.jit, static_argnames=("cfg", "spec"))
def colors_at_points(params, pts: jax.Array, cfg: NerfConfig, spec) -> jax.Array:
    """RGB (logistic-activated) at warped points — mesh vertex colors
    (ref compute_mesh_vertex_colors nerf_model.cu:2045-2067)."""
    raw = field_apply(params, pts, cfg, spec, dtype=jnp.float32)
    return jax.nn.sigmoid(raw[..., :3])
