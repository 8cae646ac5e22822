"""Marching cubes, vectorized: two array passes + host compaction.

Replaces the reference's atomic-counter CUDA implementation (instant-ngp's
gen_vertices / gen_faces, ref marching_cubes.cu:41-470) with:

  pass 1 (jnp): edge-crossing masks and lerped vertex positions for the three
    edge directions over the whole grid; vertex ids assigned by an exclusive
    cumsum over the flattened crossing mask (deterministic, vs. the CUDA
    version's nondeterministic atomicAdd order);
  pass 2 (jnp): per-cell 8-corner sign mask -> triangle table row -> edge ids
    mapped to vertex ids through the three id grids (gathers over static
    offsets);
  compaction (host numpy): drop the -1 padding — the only dynamic-shape step.

The triangle table is GENERATED at import time (not copied from any
implementation): for each of the 256 corner-sign configurations we run
marching squares on the 6 faces (ambiguous faces resolved by the fixed,
view-consistent rule "separate the positive diagonal"), link the resulting
segments into closed loops, fan-triangulate each loop, and orient by the
inside->outside direction. Tables built this way are validated by the mesh
topology tests (closed 2-manifold on random fields, Euler characteristic 2
on a sphere, outward normals).

Cell/corner/edge conventions match the reference so meshes are comparable
(ref marching_cubes.cu:382-420): corner bit order c0=(0,0,0), c1=(1,0,0),
c2=(1,1,0), c3=(0,1,0), c4..c7 = +z; edges 0-11 with e0=x@(0,0,0),
e1=y@(1,0,0), e2=x@(0,1,0), e3=y@(0,0,0), e4-7 same at z=1, e8-11 = z-edges
at (0,0,0),(1,0,0),(1,1,0),(0,1,0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# corner index -> (dx, dy, dz), bit order of the reference's cell mask
CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int32
)
# edge index -> (corner a, corner b)
EDGE_CORNERS = np.array(
    [(0, 1), (1, 2), (3, 2), (0, 3),
     (4, 5), (5, 6), (7, 6), (4, 7),
     (0, 4), (1, 5), (2, 6), (3, 7)], np.int32
)
# edge index -> (axis, dx, dy, dz): direction of the edge grid it lives in
# and the offset of its anchor lattice point within the cell.
EDGE_GRID = np.array(
    [(0, 0, 0, 0), (1, 1, 0, 0), (0, 0, 1, 0), (1, 0, 0, 0),
     (0, 0, 0, 1), (1, 1, 0, 1), (0, 0, 1, 1), (1, 0, 0, 1),
     (2, 0, 0, 0), (2, 1, 0, 0), (2, 1, 1, 0), (2, 0, 1, 0)], np.int32
)

# faces: 4 corners in cyclic order (so consecutive pairs are face edges)
_FACES = [
    (0, 1, 2, 3),  # z = 0
    (4, 5, 6, 7),  # z = 1
    (0, 1, 5, 4),  # y = 0
    (3, 2, 6, 7),  # y = 1
    (0, 3, 7, 4),  # x = 0
    (1, 2, 6, 5),  # x = 1
]


def _edge_between(ca: int, cb: int) -> int:
    for e, (a, b) in enumerate(EDGE_CORNERS):
        if {a, b} == {ca, cb}:
            return e
    raise ValueError((ca, cb))


@functools.cache
def build_triangle_table() -> np.ndarray:
    """[256, 16] int8 triangle table (edge ids, -1 padded), generated."""
    table = np.full((256, 16), -1, np.int8)
    midpoints = (CORNERS[EDGE_CORNERS[:, 0]] + CORNERS[EDGE_CORNERS[:, 1]]) / 2.0

    for mask in range(1, 255):
        inside = [(mask >> c) & 1 == 1 for c in range(8)]
        # pair cut edges on each face (marching squares per face)
        links: dict[int, list[int]] = {}

        def link(e1, e2):
            links.setdefault(e1, []).append(e2)
            links.setdefault(e2, []).append(e1)

        for f in _FACES:
            cut = []
            for k in range(4):
                a, b = f[k], f[(k + 1) % 4]
                if inside[a] != inside[b]:
                    cut.append((k, _edge_between(a, b)))
            if len(cut) == 2:
                link(cut[0][1], cut[1][1])
            elif len(cut) == 4:
                # ambiguous face: separate the inside(positive) diagonal —
                # pair each cut edge with its neighbor around an OUTSIDE corner,
                # a rule that depends only on the face's corner states (view-
                # consistent between the two cells sharing the face).
                # cut edges are at positions k0<k1<k2<k3 = 0,1,2,3 (alternating
                # corners); pair (edge after corner f[1], edge after f[2]) etc.
                # Walk corners: segments must isolate each inside corner.
                # corners alternate inside/outside; pair edges adjacent to the
                # same INSIDE corner.
                for k in range(4):
                    if inside[f[k]]:
                        e_prev = _edge_between(f[(k + 3) % 4], f[k])
                        e_next = _edge_between(f[k], f[(k + 1) % 4])
                        link(e_prev, e_next)
            # len(cut) == 0: nothing

        # trace closed loops
        cut_edges = sorted(links.keys())
        visited: set[int] = set()
        tris: list[tuple[int, int, int]] = []

        for start in cut_edges:
            if start in visited:
                continue
            loop = [start]
            visited.add(start)
            prev, cur = None, start
            while True:
                nxt = next(e for e in links[cur] if e != prev)
                if nxt == start:
                    break
                loop.append(nxt)
                visited.add(nxt)
                prev, cur = cur, nxt

            # Orient the loop so triangles are CCW seen from OUTSIDE (normal
            # (p1-p0)x(p2-p0) points inside -> outside). Robust local rule:
            # every cut edge's inside->outside corner direction has positive
            # dot with the true surface normal, so vote them against the
            # loop's Newell normal.
            pts = midpoints[loop]
            n = np.zeros(3)
            for i in range(len(loop)):
                p0, p1 = pts[i], pts[(i + 1) % len(loop)]
                n += np.cross(p0, p1)
            vote = 0.0
            for e in loop:
                a, b = EDGE_CORNERS[e]
                if not inside[a]:
                    a, b = b, a  # a inside, b outside
                vote += np.dot(n, CORNERS[b] - CORNERS[a])
            if vote < 0:
                loop = loop[::-1]
            for i in range(1, len(loop) - 1):
                tris.append((loop[0], loop[i], loop[i + 1]))

        flat = [e for t in tris for e in t]
        assert len(flat) <= 16, (mask, len(flat))
        table[mask, : len(flat)] = flat
    return table


class Mesh(NamedTuple):
    verts: np.ndarray  # [V, 3] float32, object-frame coordinates
    faces: np.ndarray  # [T, 3] int32 vertex indices
    normals: np.ndarray | None = None  # [V, 3]
    colors: np.ndarray | None = None  # [V, 3] float in [0,1]


@functools.partial(jax.jit, static_argnames=("res",))
def _mc_passes(density: jax.Array, thresh: float, res: int):
    """Vectorized crossing/vertex/face passes. density: [res^3] flat with
    index = x + y*res + z*res^2 (matching models.nerf.density_on_grid)."""
    d = density.reshape(res, res, res)  # [z, y, x]
    inside = d > thresh

    # --- vertex pass: crossings along x, y, z ---------------------------
    def crossings(axis):
        # axis: 0=x (last dim), 1=y, 2=z in (z, y, x) layout
        dim = 2 - axis
        n0 = jax.lax.slice_in_dim(inside, 0, res - 1, axis=dim)
        n1 = jax.lax.slice_in_dim(inside, 1, res, axis=dim)
        f0 = jax.lax.slice_in_dim(d, 0, res - 1, axis=dim)
        f1 = jax.lax.slice_in_dim(d, 1, res, axis=dim)
        cross = n0 != n1
        frac = (thresh - f0) / (f1 - f0)
        # pad back to full res along dim for uniform indexing
        pad = [(0, 0)] * 3
        pad[dim] = (0, 1)
        return jnp.pad(cross, pad), jnp.pad(frac, pad)

    cross_x, frac_x = crossings(0)
    cross_y, frac_y = crossings(1)
    cross_z, frac_z = crossings(2)

    cross_flat = jnp.stack(
        [cross_x.reshape(-1), cross_y.reshape(-1), cross_z.reshape(-1)]
    )  # [3, res^3]  (z,y,x flattened: idx = x + y*res + z*res^2 after transpose?)
    # note: reshape of [z,y,x] flattens as idx = x + y*res + z*res^2 ✓
    vid = jnp.cumsum(cross_flat.reshape(-1)) - 1  # exclusive ids where cross
    vid = jnp.where(cross_flat.reshape(-1), vid, -1).reshape(3, res, res, res)
    n_verts = jnp.sum(cross_flat)

    # vertex positions in grid units
    zz, yy, xx = jnp.meshgrid(
        jnp.arange(res, dtype=jnp.float32),
        jnp.arange(res, dtype=jnp.float32),
        jnp.arange(res, dtype=jnp.float32),
        indexing="ij",
    )
    base = jnp.stack([xx, yy, zz], -1)  # [z, y, x, 3]
    pos_x = base.at[..., 0].add(frac_x)
    pos_y = base.at[..., 1].add(frac_y)
    pos_z = base.at[..., 2].add(frac_z)
    verts_all = jnp.stack(
        [pos_x.reshape(-1, 3), pos_y.reshape(-1, 3), pos_z.reshape(-1, 3)]
    )  # [3, res^3, 3]

    # --- face pass over cells [res-1]^3 ----------------------------------
    c = res - 1
    cell_inside = inside  # corner (x+dx, y+dy, z+dz)

    def corner(dx, dy, dz):
        return jax.lax.dynamic_slice(
            cell_inside.astype(jnp.int32), (dz, dy, dx), (c, c, c)
        )

    mask = jnp.zeros((c, c, c), jnp.int32)
    for bit, (dx, dy, dz) in enumerate(CORNERS):
        mask |= corner(int(dx), int(dy), int(dz)) << bit

    table = jnp.asarray(build_triangle_table(), jnp.int32)  # [256, 16]
    tri_edges = table[mask.reshape(-1)]  # [cells, 16]

    # map edge id -> vertex id through the three id grids
    local = []
    for e in range(12):
        axis, dx, dy, dz = (int(v) for v in EDGE_GRID[e])
        ids = jax.lax.dynamic_slice(vid[axis], (dz, dy, dx), (c, c, c))
        local.append(ids.reshape(-1))
    local = jnp.stack(local, axis=1)  # [cells, 12]

    face_vids = jnp.where(
        tri_edges >= 0, jnp.take_along_axis(
            local, jnp.maximum(tri_edges, 0), axis=1
        ), -1,
    )  # [cells, 16]
    return cross_flat.reshape(3, -1), verts_all, face_vids, n_verts


def marching_cubes(
    density: np.ndarray, box_min, box_max, res: int, thresh: float = 2.0
) -> Mesh:
    """Extract the iso-surface mesh (ref MarchingCubes marching_cubes.cu:478-517).

    Args:
      density: [res^3] flat density grid (index = x + y*res + z*res^2).
      box_min/box_max: object-frame AABB; vertices are mapped into it (the
        grid spans the AABB with res lattice points per axis, ref
        gen_vertices scale = (max-min)/(res-1)).
    """
    cross, verts_all, face_vids, _ = _mc_passes(jnp.asarray(density), float(thresh), res)
    cross = np.asarray(cross).reshape(3, -1)
    verts_all = np.asarray(verts_all)
    face_vids = np.asarray(face_vids)

    # host compaction (the -1 padding is a suffix per row, so row-major
    # flattening keeps triples intact)
    sel = cross.reshape(-1).astype(bool)
    verts = verts_all.reshape(-1, 3)[sel]
    faces = face_vids[face_vids >= 0].reshape(-1, 3).astype(np.int32)

    scale = (np.asarray(box_max) - np.asarray(box_min)) / (res - 1)
    verts = verts.astype(np.float32) * scale.astype(np.float32) + np.asarray(
        box_min, np.float32
    )
    return Mesh(verts=verts, faces=faces)


def compute_normals(mesh: Mesh) -> Mesh:
    """Area-weighted vertex normals via 1-ring accumulation
    (ref accumulate_1ring marching_cubes.cu:441-475, n=(pb-pa)x(pa-pc))."""
    v, f = mesh.verts, mesh.faces
    if len(f) == 0:
        return mesh._replace(normals=np.zeros_like(v))
    pa, pb, pc = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    # faces are CCW from outside, so (pb-pa)x(pc-pa) is the outward
    # area-weighted normal (the reference accumulates the same quantity for
    # its winding, ref accumulate_1ring marching_cubes.cu:462)
    n = np.cross(pb - pa, pc - pa)
    normals = np.zeros_like(v)
    np.add.at(normals, f[:, 0], n)
    np.add.at(normals, f[:, 1], n)
    np.add.at(normals, f[:, 2], n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(lens, 1e-12)
    return mesh._replace(normals=normals.astype(np.float32))
