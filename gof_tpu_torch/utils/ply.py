"""Minimal binary PLY I/O (numpy), no external deps.

Used for Gaussian model snapshots (the reference's save_ply/load_ply,
gaussian_model.py:374-430/486-530, including the filter_3D attribute), the
input point cloud copies, and mesh export.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}
_NAMES = {"<f4": "float", "<f8": "double", "u1": "uchar", "<i4": "int", "<u4": "uint"}


def write_ply(path: str, vertex_props: dict[str, np.ndarray], faces: np.ndarray | None = None) -> None:
    """Write a binary-little-endian PLY.

    vertex_props: ordered {name: (N,) array}; faces: optional (F, 3) int array.
    """
    names = list(vertex_props)
    n = len(vertex_props[names[0]])
    cols = []
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name in names:
        a = np.asarray(vertex_props[name])
        dt = np.dtype(a.dtype).newbyteorder("<") if a.dtype != np.uint8 else np.dtype("u1")
        key = dt.str.lstrip("=|")
        if key not in _NAMES:
            a = a.astype(np.float32)
            key = "<f4"
        header.append(f"property {_NAMES[key]} {name}")
        cols.append(a.astype(key))
    if faces is not None:
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    rec = np.rec.fromarrays(cols, names=names)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        f.write(rec.tobytes())
        if faces is not None:
            F = len(faces)
            buf = np.empty(F, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            buf["n"] = 3
            buf["idx"] = faces.astype("<i4")
            f.write(buf.tobytes())


def read_ply(path: str):
    """Read a binary or ascii PLY. Returns (vertex dict of arrays, faces or None)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        fmt = None
        n_vertex = n_face = 0
        props = []
        in_face = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_vertex = int(line.split()[2])
                in_face = False
            elif line.startswith("element face"):
                n_face = int(line.split()[2])
                in_face = True
            elif line.startswith("property") and not in_face:
                _, typ, name = line.split()[:3]
                props.append((name, _DTYPES[typ]))
            elif line == "end_header":
                break

        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(n_vertex)]
            arr = np.array(rows, dtype=np.float64)
            verts = {name: arr[:, i].astype(dt) for i, (name, dt) in enumerate(props)}
            faces = None
            if n_face:
                faces = np.array(
                    [list(map(int, f.readline().split()[1:4])) for _ in range(n_face)]
                )
            return verts, faces

        dt = np.dtype([(name, d) for name, d in props])
        data = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt)
        verts = {name: np.ascontiguousarray(data[name]) for name, _ in props}
        faces = None
        if n_face:
            fbuf = np.frombuffer(
                f.read(n_face * (1 + 12)), dtype=[("n", "u1"), ("idx", "<i4", (3,))]
            )
            faces = np.ascontiguousarray(fbuf["idx"])
        return verts, faces
