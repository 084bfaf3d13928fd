"""Triangle-mesh utilities: OBJ loading + procedural generators
(raytracing_engine_tpu/accel/mesh.py, copied: numpy only).

The BVH benchmark configs call for ~70k-triangle meshes (BASELINE config 3);
procedural generators (subdivided icosphere, torus knot) provide meshes of
any size. ``load_obj`` handles user meshes. Every function equals the JAX
package's array for array (tests/test_torch_accel.py).
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str, normals: bool = False, uvs: bool = False):
    """Minimal OBJ reader: v / vt / vn + f (tri or fan-triangulated).

    Returns (T, 3, 3) vertex positions; with normals=True additionally
    returns vnormals, a (T, 3, 3) per-corner shading normal array (from
    the file's `vn` records and `f v//vn` indices) or None when the file
    carries no normals — callers fall back to ``smooth_vertex_normals``
    or flat shading. With uvs=True additionally returns vuvs, a (T, 3, 2)
    per-corner texture-coordinate array (`vt` records and `f v/vt`
    indices) or None when the file has no complete UV set — feeds
    ``build_clusters(vertex_uvs=...)`` / ``build_pt_scene(tri_uvs=...)``.
    Return shape: tris | (tris, vn) | (tris, vuv) | (tris, vn, vuv)."""
    verts, vns, vts, faces, nfaces, tfaces = [], [], [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                vts.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                comp = [p.split("/") for p in parts[1:]]
                idx = [int(c[0]) for c in comp]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                nidx = [int(c[2]) if len(c) >= 3 and c[2] else 0
                        for c in comp]
                nidx = [i - 1 if i > 0 else (len(vns) + i if i < 0 else -1)
                        for i in nidx]
                tidx = [int(c[1]) if len(c) >= 2 and c[1] else 0
                        for c in comp]
                tidx = [i - 1 if i > 0 else (len(vts) + i if i < 0 else -1)
                        for i in tidx]
                for k in range(1, len(idx) - 1):  # fan
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    nfaces.append([nidx[0], nidx[k], nidx[k + 1]])
                    tfaces.append([tidx[0], tidx[k], tidx[k + 1]])
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    tris = v[f]
    out = (tris,)
    if normals:
        nf = np.asarray(nfaces, np.int64)
        if not vns or (nf < 0).any():
            out += (None,)
        else:
            out += (np.asarray(vns, np.float32)[nf],)
    if uvs:
        tf = np.asarray(tfaces, np.int64)
        if not vts or (tf < 0).any():
            out += (None,)
        else:
            out += (np.asarray(vts, np.float32)[tf],)
    return out[0] if len(out) == 1 else out


def smooth_vertex_normals(triangles: np.ndarray,
                          weld_tol: float = 1e-6) -> np.ndarray:
    """Area-weighted smooth per-corner normals for a (T, 3, 3) triangle
    soup: corners are welded by position (quantized to weld_tol of the
    bbox diagonal), each welded vertex accumulates the unnormalized face
    normals (cross product = area weighting) of its incident faces, and
    each corner reads back its vertex's normalized sum. Degenerate sums
    (opposing faces cancel) fall back to the face normal."""
    tris = np.asarray(triangles, np.float64)
    face_n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    pts = tris.reshape(-1, 3)
    diag = float(np.linalg.norm(pts.max(0) - pts.min(0))) or 1.0
    q = np.round(pts / (weld_tol * diag)).astype(np.int64)
    _, inv = np.unique(q, axis=0, return_inverse=True)
    acc = np.zeros((inv.max() + 1, 3), np.float64)
    np.add.at(acc, inv, np.repeat(face_n, 3, axis=0))
    vn = acc[inv].reshape(-1, 3, 3)
    ln = np.linalg.norm(vn, axis=-1, keepdims=True)
    face_rep = np.repeat(face_n[:, None, :], 3, axis=1)
    fln = np.maximum(np.linalg.norm(face_rep, axis=-1, keepdims=True),
                     1e-30)
    vn = np.where(ln > 1e-12 * diag * diag, vn / np.maximum(ln, 1e-30),
                  face_rep / fln)
    return vn.astype(np.float32)


def icosphere(subdivisions: int = 4, radius: float = 1.0,
              center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Subdivided icosahedron: 20 * 4^n triangles (n=6 → 81920 ≈ bunny-class).
    Returns (T, 3, 3) float32."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    tris = verts[faces]  # (F, 3, 3)
    for _ in range(subdivisions):
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab = (a + b) / 2
        bc = (b + c) / 2
        ca = (c + a) / 2
        for m in (ab, bc, ca):
            m /= np.linalg.norm(m, axis=1, keepdims=True)
        tris = np.concatenate(
            [
                np.stack([a, ab, ca], 1),
                np.stack([ab, b, bc], 1),
                np.stack([ca, bc, c], 1),
                np.stack([ab, bc, ca], 1),
            ]
        )
    out = tris * radius + np.asarray(center, np.float64)
    return out.astype(np.float32)


def torus_knot(p: int = 2, q: int = 3, segments: int = 400, sides: int = 32,
               radius: float = 2.0, tube: float = 0.4,
               center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """(p,q) torus-knot tube mesh: 2 * segments * sides triangles.
    segments=1100, sides=32 → ~70k tris (BVH bench scale). Returns (T, 3, 3)."""
    t = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    r = np.cos(q * t) + 2.0
    path = np.stack(
        [r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], axis=1
    ) * (radius / 3.0)

    # Frenet-ish frame
    nxt = np.roll(path, -1, axis=0)
    tang = nxt - path
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    side = np.cross(tang, up)
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    up2 = np.cross(side, tang)

    theta = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    circ = (
        np.cos(theta)[None, :, None] * side[:, None, :]
        + np.sin(theta)[None, :, None] * up2[:, None, :]
    )
    ring = path[:, None, :] + tube * circ  # (segments, sides, 3)

    i = np.arange(segments)
    j = np.arange(sides)
    i1 = (i + 1) % segments
    j1 = (j + 1) % sides
    a = ring[i][:, j]        # (segments, sides, 3)
    b = ring[i1][:, j]
    c = ring[i1][:, j1]
    d = ring[i][:, j1]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    tris = np.concatenate([t1, t2]) + np.asarray(center, np.float64)
    return tris.astype(np.float32)


def save_obj(path: str, triangles: np.ndarray, uvs=None) -> None:
    """Write a (T, 3, 3) triangle array as an OBJ (vertices deduplicated).
    Round-trips with load_obj; useful for exporting generated meshes
    (torus_knot/icosphere) to external tools. uvs: optional (T, 3, 2)
    per-corner texture coordinates, written as `vt` records with
    `f v/vt` faces (deduplicated the same way)."""
    tris = np.asarray(triangles, np.float32).reshape(-1, 3)
    verts, inverse = np.unique(tris, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        if uvs is None:
            for a, b, c in faces + 1:
                f.write(f"f {a} {b} {c}\n")
            return
        uv = np.asarray(uvs, np.float32).reshape(-1, 2)
        if uv.shape[0] != tris.shape[0]:
            raise ValueError(
                f"uvs must be (T, 3, 2) matching triangles; got "
                f"{np.shape(uvs)} for {tris.shape[0] // 3} triangles")
        uvd, uvinv = np.unique(uv, axis=0, return_inverse=True)
        tfaces = uvinv.reshape(-1, 3)
        for t in uvd:
            f.write(f"vt {t[0]:.9g} {t[1]:.9g}\n")
        for (a, b, c), (ta, tb, tc) in zip(faces + 1, tfaces + 1):
            f.write(f"f {a}/{ta} {b}/{tb} {c}/{tc}\n")
