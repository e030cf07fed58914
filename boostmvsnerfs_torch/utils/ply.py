"""Minimal PLY mesh / point-cloud I/O (counterpart of
``boostmvsnerfs_tpu/utils/ply.py``).

The reference vendors the general-purpose ``plyfile`` package
(``lib/utils/colmap/plyfile.py``, 918 LoC) for the
custom-capture pipeline and mesh export.  We need only the subset this
framework produces/consumes — vertex (+ optional color/normal) and face
elements, ascii or binary little-endian — implemented directly on numpy
structured arrays.

API:
    write_ply(path, vertices, faces=None, colors=None, normals=None,
              binary=True)
    read_ply(path) -> {"vertex": structured array, "face": (F, 3) int array}
"""

from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
              "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def write_ply(
    path: str,
    vertices: np.ndarray,
    faces: np.ndarray | None = None,
    colors: np.ndarray | None = None,
    normals: np.ndarray | None = None,
    binary: bool = True,
):
    """Write a triangle mesh / point cloud.

    vertices (N, 3) float; faces (F, 3) int; colors (N, 3) uint8 or float
    in [0, 1]; normals (N, 3) float.
    """
    v = np.asarray(vertices, np.float32).reshape(-1, 3)
    n = len(v)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    cols = [v]
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
        cols.append(np.asarray(normals, np.float32).reshape(n, 3))
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = np.clip(np.asarray(c, np.float64) * 255.0, 0, 255).astype(
                np.uint8
            )
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols.append(c.reshape(n, 3))

    vert = np.empty(n, dtype=props)
    k = 0
    for arr in cols:
        for j in range(arr.shape[1]):
            vert[props[k][0]] = arr[:, j]
            k += 1

    fmt = "binary_little_endian" if binary else "ascii"
    header = [f"ply", f"format {fmt} 1.0",
              f"element vertex {n}"]
    header += [f"property {_NP_TO_PLY[d]} {name}" for name, d in props]
    if faces is not None:
        f = np.asarray(faces, np.int32).reshape(-1, 3)
        header += [f"element face {len(f)}",
                   "property list uchar int vertex_indices"]
    header += ["end_header"]

    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            fh.write(vert.tobytes())
            if faces is not None:
                rec = np.empty(
                    len(f), dtype=[("n", "u1"), ("idx", "i4", (3,))]
                )
                rec["n"] = 3
                rec["idx"] = f
                fh.write(rec.tobytes())
        else:
            for row in vert:
                fh.write((" ".join(str(x) for x in row) + "\n").encode())
            if faces is not None:
                for tri in f:
                    fh.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode())


def _parse_header(fh):
    if fh.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, np_dtype | ('list', ct, it))])
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("truncated PLY header")
        tok = line.decode("ascii", "replace").split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(
                    (tok[4], ("list", _PLY_TO_NP[tok[2]], _PLY_TO_NP[tok[3]]))
                )
            else:
                elements[-1][2].append((tok[2], _PLY_TO_NP[tok[1]]))
        elif tok[0] == "end_header":
            return fmt, elements


def read_ply(path: str) -> dict:
    """Read vertex/face elements. Returns {"vertex": structured (N,) array,
    "face": (F, 3) int32} (face omitted when absent). Supports ascii and
    binary_little_endian, and list properties for faces."""
    out: dict = {}
    with open(path, "rb") as fh:
        fmt, elements = _parse_header(fh)
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format {fmt}")
        for name, count, props in elements:
            is_list = any(isinstance(d, tuple) for _, d in props)
            if not is_list:
                dt = np.dtype([(p, "<" + d) for p, d in props])
                if fmt == "ascii":
                    rows = [fh.readline().split() for _ in range(count)]
                    arr = np.zeros(count, dt)
                    for j, (p, d) in enumerate(props):
                        arr[p] = np.array(
                            [r[j] for r in rows], dtype="<" + d
                        )
                else:
                    arr = np.frombuffer(
                        fh.read(dt.itemsize * count), dt
                    ).copy()
                out[name] = arr
            else:
                # list element (faces): parse row by row; assume all-triangle
                # for the binary fast path read (count byte + 3 indices)
                if fmt == "ascii":
                    faces = []
                    for _ in range(count):
                        vals = fh.readline().split()
                        k = int(vals[0])
                        faces.append([int(x) for x in vals[1 : 1 + k]])
                    arr = np.asarray(faces, np.int32)
                else:
                    (pname, (_, cnt_t, idx_t)), = props
                    rec = np.dtype(
                        [("n", "<" + cnt_t), ("idx", "<" + idx_t, (3,))]
                    )
                    raw = np.frombuffer(fh.read(rec.itemsize * count), rec)
                    if not (raw["n"] == 3).all():
                        raise ValueError("non-triangle binary PLY faces")
                    arr = raw["idx"].astype(np.int32)
                out[name] = arr
    return out
