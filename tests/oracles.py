"""Tiny NumPy oracles mirroring the reference CUDA kernels, used as golden
implementations in unit tests. Deliberately written as straight-line per-ray
loops (like the CUDA) so they are independent of the vectorized jnp code.
"""

from __future__ import annotations

import numpy as np


def ray_aabb_ref(box_min, box_max, pos, d):
    """Sequential slab method, transliterated logic of ref nerf_model.cu:87-138."""
    tmin = (box_min[0] - pos[0]) / d[0]
    tmax = (box_max[0] - pos[0]) / d[0]
    if tmin > tmax:
        tmin, tmax = tmax, tmin
    tymin = (box_min[1] - pos[1]) / d[1]
    tymax = (box_max[1] - pos[1]) / d[1]
    if tymin > tymax:
        tymin, tymax = tymax, tymin
    if tmin > tymax or tymin > tmax:
        return None
    tmin = max(tmin, tymin)
    tmax = min(tmax, tymax)
    tzmin = (box_min[2] - pos[2]) / d[2]
    tzmax = (box_max[2] - pos[2]) / d[2]
    if tzmin > tzmax:
        tzmin, tzmax = tzmax, tzmin
    if tmin > tzmax or tzmin > tmax:
        return None
    tmin = max(tmin, tzmin)
    tmax = min(tmax, tzmax)
    return tmin, tmax


def volume_render_ref(raw, t, bg, early_exit=True):
    """Per-ray sequential emission-absorption (ref VolumeRender :735-815).

    raw: [S, 4] raw outputs; t: [S]; bg: [3]. Returns (rgb, depth, mask).
    """
    T = 1.0
    rgb_ray = np.zeros(3)
    depth_ray = 0.0
    last = 0.0
    for n in range(raw.shape[0]):
        if early_exit and T < 1e-4:
            break
        rgb = 1.0 / (1.0 + np.exp(-raw[n, :3].astype(np.float64)))
        cur = float(t[n])
        dt = cur - last
        sigma = np.exp(float(raw[n, 3]))
        alpha = 1.0 - np.exp(-sigma * dt)
        w = alpha * T
        rgb_ray += w * rgb
        depth_ray += w * cur
        T *= 1.0 - alpha
        last = cur
    rgb_ray += T * np.asarray(bg, np.float64)
    return rgb_ray, depth_ray, 1.0 - T


def hashgrid_encode_ref(table, x, spec):
    """Per-point, per-level loop oracle of the tcnn hash grid (ops/hashgrid.py)."""
    p_y = np.uint64(2654435761)
    p_z = np.uint64(805459861)
    out = np.zeros((x.shape[0], spec.n_levels * spec.n_features), np.float64)
    for pi in range(x.shape[0]):
        for lvl in range(spec.n_levels):
            scale = spec.scales[lvl]
            res = spec.resolutions[lvl]
            size = spec.sizes[lvl]
            off = spec.offsets[lvl]
            pos = x[pi].astype(np.float64) * scale + 0.5
            cell = np.floor(pos).astype(np.int64)
            frac = pos - cell
            acc = np.zeros(spec.n_features, np.float64)
            for c in range(8):
                corner = cell + np.array([(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1])
                cu = corner.astype(np.uint64) & np.uint64(0xFFFFFFFF)
                if res**3 <= size:
                    idx = int(cu[0] + cu[1] * res + cu[2] * res * res)
                else:
                    idx = int(
                        (cu[0] ^ ((cu[1] * p_y) & np.uint64(0xFFFFFFFF))
                         ^ ((cu[2] * p_z) & np.uint64(0xFFFFFFFF)))
                        & np.uint64(0xFFFFFFFF)
                    )
                idx %= size
                w = 1.0
                for dim in range(3):
                    bit = (c >> dim) & 1
                    w *= frac[dim] if bit else 1.0 - frac[dim]
                acc += w * table[off + idx].astype(np.float64)
            out[pi, lvl * spec.n_features : (lvl + 1) * spec.n_features] = acc
    return out


def _tent(xv: float, r: int) -> np.ndarray:
    """Linear-interpolation weights of coordinate xv in [0,1] at resolution r."""
    xs = float(xv) * (r - 1)
    return np.array([max(0.0, 1.0 - abs(xs - i)) for i in range(r)])


def mxgrid_encode_ref(factors, x, spec):
    """Per-point loop oracle of ops/mxgrid.encode, in float64.

    CP part: per axis, the concatenated tent basis of every ladder level
    dotted with that axis' line weights, then the product of the three axis
    factors. With spec.snap_levels each coarse tent is evaluated through the
    finest level: its value at the fine grid's nodes, interpolated by the
    fine tent weights. Plane part: per level and axis triple (u, v, w), the
    bilinear plane sample times the linear sample of the orthogonal line.
    """
    if isinstance(factors, dict):
        lines = np.asarray(factors["lines"], np.float64)
    else:
        lines = np.asarray(factors, np.float64)
    x = np.asarray(x, np.float64)
    rf = max(spec.resolutions)
    nodes = np.arange(rf) / (rf - 1)
    out = []
    for p in x:
        cp = np.ones(spec.features)
        for d in range(3):
            basis = []
            for r in spec.resolutions:
                if spec.snap_levels:
                    fine = _tent(p[d], rf)
                    basis.extend(
                        sum(fine[j] * _tent(nodes[j], r)[b] for j in range(rf))
                        for b in range(r))
                else:
                    basis.extend(_tent(p[d], r))
            cp = cp * (np.asarray(basis) @ lines[d])
        feats = [cp]
        for lvl, (ru, rv, kp) in enumerate(spec.plane_specs):
            for i, (u, v, w) in enumerate(spec.plane_axes):
                plane = np.asarray(factors["planes"][lvl][i], np.float64)
                line = np.asarray(factors["plane_lines"][lvl][i], np.float64)
                hu, hv = _tent(p[u], ru), _tent(p[v], rv)
                f_pl = np.einsum("a,b,abk->k", hu, hv, plane)
                f_li = _tent(p[w], max(ru, rv)) @ line
                feats.append(f_pl * f_li)
        out.append(np.concatenate(feats))
    return np.stack(out)
