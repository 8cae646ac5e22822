"""Multiresolution hash-grid encoding (instant-ngp) in JAX.

Functional equivalent of tiny-cuda-nn's HashGrid encoding as configured by the
reference (ref Core/configs/base.json:23-29, nerf_model.cu:1299-1306):
L=16 levels, F=2 features/level, T=2^16 entries/level, Nmin=16, per-level
scale b derived from desired resolution 2048.

Faithful to tcnn semantics (third_party/tiny-cuda-nn grid encoding):
  * level scale_l   = 2^(l*log2(b)) * Nmin - 1
  * resolution_l    = ceil(scale_l) + 1
  * pos             = x * scale_l + 0.5 ; cell = floor(pos) ; frac = pos - cell
  * per-level size  = next_multiple(min(T, resolution^3), 8)
  * dense index     = cx + cy*res + cz*res^2        (when res^3 fits in T)
  * hashed index    = cx ^ (cy*2654435761) ^ (cz*805459861)   (uint32 wrap)
  * final index     = index % level_size
  * trilinear interpolation over the 8 cell corners
  * init            U[-1e-4, 1e-4]

Design: all levels live in ONE [total_params, F] table per object; the
forward pass computes corner indices for all L levels and 8 corners and issues
a single XLA gather of [P, L*8] rows, then does the trilinear reduction as
dense vector math. The backward pass is XLA's gather transpose (scatter-add),
so `jax.grad` through this encoding replaces the reference's hand-written
CUDA backward. Batching over objects is an outer `vmap` over the table.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from romap_tpu.config import EncodingConfig

_PRIME_Y = np.uint32(2654435761)
_PRIME_Z = np.uint32(805459861)


def _next_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static (trace-time) layout of the concatenated level tables."""

    n_levels: int
    n_features: int
    scales: tuple[float, ...]  # scale_l (grid units)
    resolutions: tuple[int, ...]
    sizes: tuple[int, ...]  # entries per level
    offsets: tuple[int, ...]  # row offset of each level in the big table
    total_params: int  # total rows

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features


def make_spec(cfg: EncodingConfig) -> HashGridSpec:
    max_size = 1 << cfg.log2_hashmap_size
    log2_b = math.log2(cfg.per_level_scale)
    scales, resolutions, sizes, offsets = [], [], [], []
    offset = 0
    for lvl in range(cfg.n_levels):
        scale = math.pow(2.0, lvl * log2_b) * cfg.base_resolution - 1.0
        res = int(math.ceil(scale)) + 1
        dense = res**3 if res < 2048 else max_size + 1  # avoid overflow blowups
        size = _next_multiple(min(max_size, dense), 8)
        scales.append(scale)
        resolutions.append(res)
        sizes.append(size)
        offsets.append(offset)
        offset += size
    return HashGridSpec(
        n_levels=cfg.n_levels,
        n_features=cfg.n_features_per_level,
        scales=tuple(scales),
        resolutions=tuple(resolutions),
        sizes=tuple(sizes),
        offsets=tuple(offsets),
        total_params=offset,
    )


def init_table(key: jax.Array, spec: HashGridSpec, dtype=jnp.float32) -> jax.Array:
    """U[-1e-4, 1e-4], matching tcnn's hash-table initialization."""
    return jax.random.uniform(
        key, (spec.total_params, spec.n_features), dtype, minval=-1e-4, maxval=1e-4
    )


# The 8 corner offsets of a cell, as a (8, 3) {0,1} array.
_CORNERS = np.stack(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)]
).astype(np.int32)


def corner_indices(spec: HashGridSpec) -> tuple[np.ndarray, np.ndarray]:
    """Static per-(level, corner) table metadata used by encode()."""
    return _CORNERS


def encode(table: jax.Array, x: jax.Array, spec: HashGridSpec,
           impl: str = "gather") -> jax.Array:
    """Encode points with the multiresolution hash grid.

    Args:
      table: [total_params, F] parameter table (all levels concatenated).
      x: [..., 3] points in the unit cube (warped object coords).
      spec: static layout.
      impl: "gather" (direct XLA gather; backward is XLA's scatter-add
        transpose) or "sorted" (argsort the corner indices once, gather in
        sorted order, and accumulate the table gradient with a SORTED
        segment-sum — a hash table guarantees index collisions, on which
        a scatter-add can serialize; sorting removes them). Both are exact
        in fp32 up to summation order.

    Returns:
      [..., L*F] features (level-major), dtype = table.dtype.
    """
    batch_shape = x.shape[:-1]
    p = x.reshape(-1, 3)  # [P, 3]
    n = p.shape[0]

    idx_levels = []
    w_levels = []
    for lvl in range(spec.n_levels):
        scale = spec.scales[lvl]
        res = spec.resolutions[lvl]
        size = spec.sizes[lvl]
        offset = spec.offsets[lvl]
        pos = p.astype(jnp.float32) * jnp.float32(scale) + 0.5
        cell = jnp.floor(pos)
        frac = pos - cell  # [P, 3]
        cell = cell.astype(jnp.int32)  # [P, 3]

        corners = cell[:, None, :] + _CORNERS[None, :, :]  # [P, 8, 3]
        cu = corners.astype(jnp.uint32)
        if res**3 <= size:
            idx = cu[..., 0] + cu[..., 1] * np.uint32(res) + cu[..., 2] * np.uint32(res * res)
        else:
            idx = cu[..., 0] ^ (cu[..., 1] * _PRIME_Y) ^ (cu[..., 2] * _PRIME_Z)
        idx = (idx % np.uint32(size)).astype(jnp.int32) + np.int32(offset)  # [P, 8]

        # trilinear weights: prod over dims of (corner ? frac : 1-frac)
        cw = jnp.where(
            _CORNERS[None, :, :].astype(bool), frac[:, None, :], 1.0 - frac[:, None, :]
        )  # [P, 8, 3]
        w = cw[..., 0] * cw[..., 1] * cw[..., 2]  # [P, 8]

        idx_levels.append(idx)
        w_levels.append(w)

    idx_all = jnp.stack(idx_levels, axis=1)  # [P, L, 8]
    w_all = jnp.stack(w_levels, axis=1)  # [P, L, 8]

    if impl == "sorted":
        out = _sorted_combine(
            (n, spec.n_levels, spec.n_features), table,
            idx_all.reshape(-1), w_all.reshape(-1).astype(table.dtype),
        )
        return out.reshape(*batch_shape, spec.n_levels * spec.n_features)

    # One big gather: [P, L, 8, F]
    feats = jnp.take(table, idx_all.reshape(n, -1), axis=0).reshape(
        n, spec.n_levels, 8, spec.n_features
    )
    out = jnp.sum(feats * w_all[..., None].astype(table.dtype), axis=2)  # [P, L, F]
    return out.reshape(*batch_shape, spec.n_levels * spec.n_features)


# ------------------------------------------------------------- sorted impl
# Scatter-adds can serialize on duplicate indices, and a hash grid
# guarantees duplicates (collisions + shared cell corners at coarse
# levels). Sorting the flat corner indices once per call turns the
# backward into a sorted segment-sum and lets the forward gather declare
# indices_are_sorted. Differentiable in (table, w); the integer indices
# carry no gradient (x-gradients flow through w, as in the gather path).


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _sorted_combine(dims, table, idx, w):
    out, _ = _sorted_combine_fwd(dims, table, idx, w)
    return out


def _sorted_gather(dims, table, idx, w, order):
    """Shared fwd/bwd compute: corner features in original order [N, F]."""
    n_idx = idx.shape[0]
    sidx = jnp.take(idx, order, unique_indices=True)
    feats_s = jnp.take(table, sidx, axis=0, indices_are_sorted=True)
    inv = jnp.zeros_like(order).at[order].set(
        jnp.arange(n_idx, dtype=order.dtype), unique_indices=True
    )
    return jnp.take(feats_s, inv, axis=0, unique_indices=True)


def _sorted_combine_fwd(dims, table, idx, w):
    n, levels, f = dims
    order = jnp.argsort(idx)
    feats = _sorted_gather(dims, table, idx, w, order)  # [N, F]
    out = (feats * w[:, None]).reshape(n, levels, 8, f).sum(axis=2)
    return out, (table, idx, w, order)


def _sorted_combine_bwd(dims, res, cot):
    n, levels, f = dims
    table, idx, w, order = res
    # broadcast the [P, L, F] cotangent back to the 8 corners -> [N, F]
    cot_n = jnp.broadcast_to(
        cot[:, :, None, :], (n, levels, 8, f)
    ).reshape(-1, f)
    # d/d table: sorted segment-sum of w * cot at the sorted indices
    g = cot_n * w[:, None]
    sidx = jnp.take(idx, order, unique_indices=True)
    gs = jnp.take(g, order, axis=0, unique_indices=True)
    grad_table = jax.ops.segment_sum(
        gs, sidx, num_segments=table.shape[0], indices_are_sorted=True
    ).astype(table.dtype)
    # d/d w: feature . cotangent per corner (recompute the sorted gather)
    feats = _sorted_gather(dims, table, idx, w, order)
    grad_w = jnp.sum(feats * cot_n, axis=-1).astype(w.dtype)
    return grad_table, None, grad_w


_sorted_combine.defvjp(_sorted_combine_fwd, _sorted_combine_bwd)
