"""Density-field → triangle-mesh extraction (PLY export) (counterpart of
``boostmvsnerfs_tpu/utils/mesh.py``, the same meshes for the same fields).

Equivalent of the reference ``lib/utils/mesh_utils.py`` (45 LoC:
grid query + ``skimage.measure.marching_cubes_lewiner`` + trimesh export).
Neither skimage nor trimesh is a dependency here, so the isosurfacer is our
own **vectorized marching tetrahedra** over the 6-tet cube decomposition —
a simpler case table than full marching cubes with the same capability
(watertight triangle isosurface of a sampled scalar field), and the grid
query batches through the caller's ``queryfn``, which may run the density
MLP on the card and return its densities to the host.

API:
    extract_mesh(queryfn, level, bbox, output_path, N=256, batch=8192)
    marching_tetrahedra(volume, level, spacing, origin) -> (verts, faces)
"""

from __future__ import annotations

import numpy as np

# cube corner c -> (dx, dy, dz)
_CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    np.int64,
)
# 6-tetrahedron decomposition of the cube around the 0-6 diagonal
_TETS = np.array(
    [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
     (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)],
    np.int64,
)
# local tet edges e -> (corner a, corner b) with a < b
_EDGES = np.array(
    [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], np.int64
)
# triangles (edge-id triples) per 4-bit inside-mask; single-vertex cases
# produce one triangle, two-vertex cases a quad split into two. Complement
# masks reuse the same crossed edges with flipped winding.
_TRI_TABLE: list[list[tuple[int, int, int]]] = [
    [],                                # 0000
    [(0, 1, 2)],                       # v0 in
    [(0, 4, 3)],                       # v1 in
    [(1, 3, 4), (1, 4, 2)],            # v0 v1
    [(1, 3, 5)],                       # v2 in  (edges 0-2, 2-1, 2-3)
    [(0, 2, 5), (0, 5, 3)],            # v0 v2
    [(0, 5, 4), (0, 1, 5)],            # v1 v2
    [(2, 4, 5)],                       # v3 out
    [(2, 5, 4)],                       # v3 in
    [(0, 4, 5), (0, 5, 1)],            # v0 v3
    [(0, 5, 2), (0, 3, 5)],            # v1 v3
    [(1, 5, 3)],                       # v2 out
    [(1, 4, 3), (1, 2, 4)],            # v2 v3
    [(0, 3, 4)],                       # v1 out
    [(0, 2, 1)],                       # v0 out
    [],                                # 1111
]


def marching_tetrahedra(
    volume: np.ndarray,
    level: float,
    spacing=(1.0, 1.0, 1.0),
    origin=(0.0, 0.0, 0.0),
    dedup: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Isosurface of ``volume`` (X, Y, Z scalar grid) at ``level``.

    Returns (vertices (V, 3) float32 in world units, faces (F, 3) int32).
    """
    vol = np.asarray(volume, np.float32)
    X, Y, Z = vol.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # cell-corner value grid: (X-1, Y-1, Z-1, 8)
    cx, cy, cz = np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
    )
    base = np.stack([cx, cy, cz], -1).reshape(-1, 1, 3)  # (C, 1, 3)
    corner_idx = base + _CORNERS[None]  # (C, 8, 3)
    vals8 = vol[
        corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]
    ]  # (C, 8)

    # drop cells the surface cannot cross
    lo = vals8.min(1)
    hi = vals8.max(1)
    active = (lo <= level) & (hi > level)
    if not active.any():
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    vals8 = vals8[active]
    pos8 = corner_idx[active].astype(np.float32)  # (A, 8, 3) grid coords

    # tetrahedra: (A, 6, 4) values / positions
    tv = vals8[:, _TETS]  # (A, 6, 4)
    tp = pos8[:, _TETS]  # (A, 6, 4, 3)
    tv = tv.reshape(-1, 4)
    tp = tp.reshape(-1, 4, 3)
    mask = (
        (tv[:, 0] > level).astype(np.int8)
        | ((tv[:, 1] > level) << 1)
        | ((tv[:, 2] > level) << 2)
        | ((tv[:, 3] > level) << 3)
    )

    tris = []
    for m in range(1, 15):
        sel = np.nonzero(mask == m)[0]
        if sel.size == 0 or not _TRI_TABLE[m]:
            continue
        v = tv[sel]  # (S, 4)
        p = tp[sel]  # (S, 4, 3)
        for tri in _TRI_TABLE[m]:
            pts = []
            for e in tri:
                a, b = _EDGES[e]
                va, vb = v[:, a], v[:, b]
                # linear interpolation to the crossing; denominators are
                # nonzero on crossed edges by construction
                t = (level - va) / np.where(vb == va, 1.0, vb - va)
                t = np.clip(t, 0.0, 1.0)
                pts.append(p[:, a] + t[:, None] * (p[:, b] - p[:, a]))
            tris.append(np.stack(pts, 1))  # (S, 3, 3)
    if not tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tri_pts = np.concatenate(tris, 0)  # (F, 3, 3) grid coords

    verts = tri_pts.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    if dedup:
        # exact dedup is safe: coincident vertices come from the same edge
        # interpolation and are bitwise equal
        verts, inv = np.unique(verts, axis=0, return_inverse=True)
        faces = inv.reshape(-1, 3).astype(np.int32)
        # drop degenerate triangles produced by level==corner touches
        ok = (
            (faces[:, 0] != faces[:, 1])
            & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2])
        )
        faces = faces[ok]

    verts = verts * np.asarray(spacing, np.float32) + np.asarray(
        origin, np.float32
    )
    return verts.astype(np.float32), faces


def query_density_grid(
    queryfn, bbox, N: int = 256, batch: int = 8192
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample ``queryfn((M, 3)) -> (M, ...)`` densities over an N^3 grid in
    ``bbox`` [[x0,y0,z0],[x1,y1,z1]] (reference mesh_utils.py:8-45 grid
    construction). Returns (volume (N,N,N), spacing (3,), origin (3,))."""
    bbox = np.asarray(bbox, np.float32).reshape(2, 3)
    axes = [np.linspace(bbox[0, i], bbox[1, i], N, dtype=np.float32)
            for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    dens = np.empty(len(pts), np.float32)
    for s in range(0, len(pts), batch):
        out = np.asarray(queryfn(pts[s : s + batch]))
        dens[s : s + batch] = out.reshape(len(out), -1)[:, 0]
    spacing = (bbox[1] - bbox[0]) / max(N - 1, 1)
    return dens.reshape(N, N, N), spacing, bbox[0]


def extract_mesh(
    queryfn,
    level: float,
    bbox,
    output_path: str = "mesh.ply",
    N: int = 256,
    batch: int = 8192,
) -> tuple[np.ndarray, np.ndarray]:
    """Grid-sample a density field and export its isosurface as PLY
    (reference lib/utils/mesh_utils.py extract_mesh API)."""
    from boostmvsnerfs_torch.utils.ply import write_ply

    vol, spacing, origin = query_density_grid(queryfn, bbox, N, batch)
    verts, faces = marching_tetrahedra(vol, level, spacing, origin)
    write_ply(output_path, verts, faces)
    return verts, faces
