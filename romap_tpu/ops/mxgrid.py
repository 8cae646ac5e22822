"""MX-grid: a gather-free learned positional encoding built from matmuls.

The reference's hash-grid encoding (tiny-cuda-nn HashGrid, ref
nerf_model.cu:1299-1306) reads eight random table rows per point and level.
This encoding expresses the same idea -- a learned multi-resolution spatial
table with linear interpolation -- as dense matrix products:

  1. hat basis   H_d(p) = concat_l hat_{R_l}(p_d)   in [P, sum_l R_l]
     where hat_R(x)[i] = max(0, 1 - |x*(R-1) - i|) is the linear-
     interpolation (tent) basis at resolution R. Two nonzeros per row, but
     built and consumed dense.
  2. axis factors A_d = H_d @ W_d,  W_d in [sum_l R_l, K]   (one per axis)
  3. feature      f(p) = A_x * A_y * A_z   in [P, K]  (CP / TensoRF-style
     rank decomposition: product of per-axis factors)

Forward and parameter gradient (dW_d = H_d^T @ (df * A_e * A_f)) are matrix
products; there is no gather and no scatter. Capacity knobs: per-axis
resolutions (multi-level, like instant-ngp's geometric ladder) and K
channels. W_d is dense over the concatenated ladder, so each channel learns
its own multi-resolution 1D basis.

Precision contract (bf16 parameters): coordinates and tent bases are built
in float32; a basis is cast to the parameter dtype only as a matmul operand;
every product accumulates in float32 (`preferred_element_type`); the CP
products and plane contractions run in float32 and the features are cast
once, at the end. A bf16 coordinate is ~0.75 of a cell coarse at resolution
192, so rounding the points themselves would wreck the encoding; rounding
only the parameters costs ~0.5% relative error at flagship width.

This is the flagship encoding (config.encoding.kind == "mxgrid");
"hashgrid" remains available for reference-parity experiments.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class MXGridSpec:
    resolutions: tuple[int, ...]  # 1D resolution ladder (shared by x, y, z)
    features: int  # K output channels of the CP part
    offsets: tuple[int, ...]  # column offset of each level in the basis
    total_res: int  # sum of resolutions
    chunk: int = 4096  # points per hat-basis tile (bounds the [C, total_res]
    # intermediate; the full [P, total_res] basis must never materialize)
    # VM (TensoRF-style) plane-x-line components: rank-limited CP lines
    # underfit full-rank 3D texture; 2D planes restore it, still gather-free
    # (plane sampling = hat matmul + per-point contraction). A LADDER of
    # (res_u, res_v, channels) levels. The two resolutions are independent:
    # the u axis is contracted by a matmul (K * res_u * res_v MACs per
    # point per plane pair) while v reduces elementwise per point.
    plane_specs: tuple[tuple[int, int, int], ...] = ()  # ((ru, rv, k), ...)
    # (u, v, orthogonal-line) axis assignment of the three plane pairs.
    # Default "uuv" contracts x,x,y by matmul (u) — with rectangular
    # planes (rv < ru) that starves z (it only ever appears as a coarse v
    # axis). "balanced" = ((0,1,2),(2,0,1),(1,2,0)) gives every axis one
    # fine-u and one coarse-v appearance.
    plane_axes: tuple[tuple[int, int, int], ...] = (
        (0, 1, 2), (0, 2, 1), (1, 2, 0))
    # snap_levels: evaluate the multi-level CP basis THROUGH the finest
    # level's tent basis: every coarse hat is (re)defined as its linear
    # interpolation on the finest grid, hat_l = C_l @ hat_fine, and the
    # constant fold matrix C is absorbed into the line weights per step
    # (W_eff = C^T W — one tiny matmul per step, not per point). The encode
    # then builds ONE [T, r_fine] basis per axis instead of the [T,
    # total_res] concatenated stack — for the flagship ladder (16..192,
    # total 465) that is 2.4x less hat-building AND 2.4x less CP-matmul
    # work per axis. Semantics: coarse-level features become piecewise-
    # linear with knots on the FINE grid (identical at fine nodes); when
    # every (r_l - 1) divides (r_fine - 1) the fold is EXACT, otherwise
    # hat corners shift by < 1/(r_fine-1) — a new (equally valid) basis
    # that must pass the 3-seed 0.5 dB parity gate before becoming default.
    snap_levels: bool = False

    @property
    def plane_out_dims(self) -> int:
        return 3 * sum(k for _, _, k in self.plane_specs)

    @property
    def fold_res(self) -> int:
        """Resolution of the folded basis: the finest level's."""
        return max(self.resolutions)

    @property
    def n_output_dims(self) -> int:
        return self.features + self.plane_out_dims


def fold_matrix(spec: MXGridSpec) -> np.ndarray:
    """[total_res, rf] fold: row (level l, index b) holds coarse hat b of
    level l sampled at the finest grid's nodes, so C @ hat_fine(x) is the
    fine-grid linear interpolation of the whole concatenated multi-level
    basis. The finest level's block is the identity."""
    rf = spec.fold_res
    c = np.zeros((spec.total_res, rf), np.float32)
    nodes = np.arange(rf, dtype=np.float64) / (rf - 1)
    for r, off in zip(spec.resolutions, spec.offsets):
        z = nodes[None, :] * (r - 1) - np.arange(r, dtype=np.float64)[:, None]
        c[off : off + r] = np.maximum(0.0, 1.0 - np.abs(z))
    return c


def fold_lines(lines: jax.Array, spec: MXGridSpec) -> jax.Array:
    """W [3, total_res, K] -> effective fine-basis weights [3, rf, K]
    (fp32 contraction, cast back to the parameter dtype)."""
    c = jnp.asarray(fold_matrix(spec))
    out = jnp.einsum("drk,rf->dfk", lines.astype(jnp.float32), c,
                     preferred_element_type=jnp.float32)
    return out.astype(lines.dtype)


def make_mxspec(
    n_levels: int = 8,
    base_resolution: int = 16,
    max_resolution: int = 1024,
    features: int = 64,
    chunk: int = 4096,
    plane_res: int = 0,
    plane_features: int = 0,
    plane_specs: tuple[tuple[int, int], ...] | None = None,
    plane_axes: str = "uuv",
    snap_levels: bool = False,
) -> MXGridSpec:
    if n_levels > 1:
        b = (max_resolution / base_resolution) ** (1.0 / (n_levels - 1))
    else:
        b = 1.0
    res = tuple(int(round(base_resolution * b**l)) for l in range(n_levels))
    offsets, off = [], 0
    for r in res:
        offsets.append(off)
        off += r
    if plane_specs is None:
        plane_specs = ((plane_res, plane_features),) if plane_features > 0 else ()
    # normalize (r, k) pairs to (ru, rv, k) triples
    norm = tuple(
        (p[0], p[0], p[1]) if len(p) == 2 else tuple(p) for p in plane_specs
    )
    axes = {"uuv": ((0, 1, 2), (0, 2, 1), (1, 2, 0)),
            "balanced": ((0, 1, 2), (2, 0, 1), (1, 2, 0))}[plane_axes]
    return MXGridSpec(
        resolutions=res, features=features, offsets=tuple(offsets), total_res=off,
        chunk=chunk, plane_specs=norm, plane_axes=axes,
        snap_levels=snap_levels,
    )


def init_mxgrid(key: jax.Array, spec: MXGridSpec, dtype=jnp.float32):
    """Parameters: CP factors W_d [3, total_res, K]; with planes enabled, a
    dict {lines, planes: tuple of [3, R_l, R_l, K_l], plane_lines: tuple of
    [3, R_l, K_l]} — one entry per plane-ladder level.

    Scale: a hat-basis row sums to 1, so A_d ~ N(0, ~0.6 sigma^2). sigma=0.3
    keeps the 3-way product ~ O(1e-2..1e-1) at init — small but alive.
    """
    k1, k2, k3 = jax.random.split(key, 3)
    lines = 0.3 * jax.random.normal(k1, (3, spec.total_res, spec.features), dtype)
    if not spec.plane_specs:
        return lines
    kps = jax.random.split(k2, len(spec.plane_specs))
    kls = jax.random.split(k3, len(spec.plane_specs))
    return {
        "lines": lines,
        "planes": tuple(
            0.3 * jax.random.normal(kp, (3, ru, rv, k), dtype)
            for kp, (ru, rv, k) in zip(kps, spec.plane_specs)
        ),
        "plane_lines": tuple(
            0.3 * jax.random.normal(kl, (3, max(ru, rv), k), dtype)
            for kl, (ru, rv, k) in zip(kls, spec.plane_specs)
        ),
    }


def hat_basis(x: jax.Array, spec: MXGridSpec) -> jax.Array:
    """[P] coords in [0,1] -> [P, total_res] concatenated tent bases."""
    cols = []
    for r in spec.resolutions:
        xs = x * (r - 1)
        i = jnp.arange(r, dtype=x.dtype)
        cols.append(jnp.maximum(0.0, 1.0 - jnp.abs(xs[:, None] - i[None, :])))
    return jnp.concatenate(cols, axis=-1)


def _hat1(x: jax.Array, r: int) -> jax.Array:
    """[C] -> [C, r] single-resolution tent basis."""
    xs = x * (r - 1)
    i = jnp.arange(r, dtype=x.dtype)
    return jnp.maximum(0.0, 1.0 - jnp.abs(xs[:, None] - i[None, :]))


_PLANE_AXES = ((0, 1, 2), (0, 2, 1), (1, 2, 0))  # (u, v, orthogonal line)


def _dot(basis: jax.Array, w: jax.Array) -> jax.Array:
    """fp32 tent basis x weights: the basis is rounded to the weights' dtype
    only as a matmul operand, and the product accumulates in fp32."""
    return jnp.dot(basis.astype(w.dtype), w, preferred_element_type=jnp.float32)


def _encode_chunk(factors, pts: jax.Array, spec: MXGridSpec) -> jax.Array:
    """fp32 [C, 3] -> fp32 [C, n_output_dims]; hat bases live only here."""
    lines = factors["lines"] if isinstance(factors, dict) else factors
    ax = []
    for d in range(3):
        if spec.snap_levels:
            # lines arrive pre-folded ([3, rf, K], see encode()): one
            # finest-level hat replaces the concatenated ladder stack
            h = _hat1(pts[:, d], spec.fold_res)
            w = lines[d]
        else:
            h = hat_basis(pts[:, d], spec)
            w = lines[d]
        ax.append(_dot(h, w))
    out = ax[0] * ax[1] * ax[2]
    if not isinstance(factors, dict):
        return out

    # VM components: bilinear plane sample x linear orthogonal-line sample,
    # all dense (hat matmul over u + per-point contraction over v)
    c = pts.shape[0]
    blocks = [out]
    for lvl, (ru, rv, kp) in enumerate(spec.plane_specs):
        for i, (u, v, w) in enumerate(spec.plane_axes):
            hu = _hat1(pts[:, u], ru)  # [C, Ru]
            hv = _hat1(pts[:, v], rv)
            t = _dot(hu, factors["planes"][lvl][i].reshape(ru, rv * kp))  # [C, Rv*Kp]
            f_pl = jnp.sum(t.reshape(c, rv, kp) * hv[:, :, None], axis=1)  # [C, Kp]
            f_li = _dot(_hat1(pts[:, w], max(ru, rv)),
                        factors["plane_lines"][lvl][i])  # [C, Kp]
            blocks.append(f_pl * f_li)
    return jnp.concatenate(blocks, axis=-1)


def encode(factors: jax.Array, p: jax.Array, spec: MXGridSpec) -> jax.Array:
    """Encode points.

    Points are processed in chunks of spec.chunk under jax.checkpoint: the
    [C, total_res] hat basis is rebuilt in the backward pass instead of being
    saved (it is 2 elementwise ops per entry — far cheaper than storing
    ~GBs). Points and bases stay fp32 whatever the parameter dtype (see the
    module docstring's precision contract).

    Args:
      factors: [3, total_res, K].
      p: [..., 3] points in the unit cube.
    Returns:
      [..., K] features (dtype of factors).
    """
    batch_shape = p.shape[:-1]
    dtype = (factors["lines"] if isinstance(factors, dict) else factors).dtype
    if spec.snap_levels:
        # fold ONCE per call (outside the chunk loop and the checkpoint):
        # the chunks then see effective fine-basis weights. Gradients flow
        # through the fold einsum — exact, since the fold is linear.
        if isinstance(factors, dict):
            factors = dict(factors, lines=fold_lines(factors["lines"], spec))
        else:
            factors = fold_lines(factors, spec)
    pts = p.reshape(-1, 3).astype(jnp.float32)
    n = pts.shape[0]
    chunk = spec.chunk
    k = spec.n_output_dims
    chunk_fn = jax.checkpoint(lambda f, q: _encode_chunk(f, q, spec))
    if n <= chunk:
        out = chunk_fn(factors, pts)
    else:
        n_pad = (-n) % chunk
        padded = jnp.pad(pts, ((0, n_pad), (0, 0)))
        tiles = padded.reshape(-1, chunk, 3)
        out = jax.lax.map(lambda q: chunk_fn(factors, q), tiles)
        out = out.reshape(-1, k)[:n]
    return out.reshape(*batch_shape, k).astype(dtype)
