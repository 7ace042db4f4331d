"""Minimal PLY reader/writer (binary little-endian + ascii).

Produces the same PLY payloads the reference pipeline exchanges via
open3d/plantdb.io (point clouds with normals/colors, triangle meshes).
"""

from __future__ import annotations

import numpy as np

from .geometry import PointCloud, TriangleMesh

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def write_ply(path, pcd_or_mesh, binary=True):
    if isinstance(pcd_or_mesh, TriangleMesh):
        _write_mesh(path, pcd_or_mesh, binary)
    else:
        _write_pcd(path, pcd_or_mesh, binary)


def _header(num_vertices, props, num_faces=None, binary=True):
    fmt = "binary_little_endian" if binary else "ascii"
    lines = ["ply", f"format {fmt} 1.0", "comment plant3dvision_tpu",
             f"element vertex {num_vertices}"]
    lines += [f"property {t} {n}" for t, n in props]
    if num_faces is not None:
        lines += [f"element face {num_faces}", "property list uchar int vertex_indices"]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode()


def _write_pcd(path, pcd: PointCloud, binary=True):
    props = [("double", "x"), ("double", "y"), ("double", "z")]
    cols = [pcd.points.astype("<f8")]
    if pcd.has_normals():
        props += [("double", "nx"), ("double", "ny"), ("double", "nz")]
        cols.append(pcd.normals.astype("<f8"))
    if pcd.has_colors():
        props += [("uchar", "red"), ("uchar", "green"), ("uchar", "blue")]
        cols.append(np.clip(pcd.colors * 255.0, 0, 255).astype("u1"))
    n = len(pcd)
    with open(path, "wb") as f:
        f.write(_header(n, props, None, binary))
        if binary:
            rec = np.empty(n, dtype=[(f"c{i}", c.dtype, c.shape[1]) for i, c in enumerate(cols)])
            for i, c in enumerate(cols):
                rec[f"c{i}"] = c
            f.write(rec.tobytes())
        else:
            flat = np.concatenate([c.astype(np.float64) for c in cols], axis=1)
            np.savetxt(f, flat, fmt="%.10g")


def _write_mesh(path, mesh: TriangleMesh, binary=True):
    props = [("double", "x"), ("double", "y"), ("double", "z")]
    v = mesh.vertices.astype("<f8")
    t = mesh.triangles.astype("<i4")
    with open(path, "wb") as f:
        f.write(_header(len(v), props, len(t), binary))
        if binary:
            f.write(v.tobytes())
            rec = np.empty(len(t), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            rec["n"] = 3
            rec["idx"] = t
            f.write(rec.tobytes())
        else:
            np.savetxt(f, v, fmt="%.10g")
            np.savetxt(f, np.concatenate([np.full((len(t), 1), 3), t], axis=1), fmt="%d")


def read_ply(path):
    """Returns a PointCloud or a TriangleMesh depending on file contents."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"Not a PLY file: {path}")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]
    body = body[body.find(b"\n") + 1:]

    fmt = None
    elements = []  # list of (name, count, [(dtype, propname)...] or 'list')
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append({"name": parts[1], "count": int(parts[2]), "props": []})
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1]["props"].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1]["props"].append((parts[1], parts[2]))

    if fmt == "ascii":
        return _read_ascii(body, elements)
    byteorder = "<" if "little" in fmt else ">"
    return _read_binary(body, elements, byteorder)


def _assemble(vertex_data, face_idx):
    names = vertex_data.dtype.names
    pts = np.stack([vertex_data[c] for c in ("x", "y", "z")], axis=1).astype(np.float64)
    normals = None
    colors = None
    if names and all(c in names for c in ("nx", "ny", "nz")):
        normals = np.stack([vertex_data[c] for c in ("nx", "ny", "nz")], axis=1).astype(np.float64)
    if names and all(c in names for c in ("red", "green", "blue")):
        colors = np.stack([vertex_data[c] for c in ("red", "green", "blue")], axis=1).astype(np.float64)
        if colors.size and colors.max() > 1.0:
            colors = colors / 255.0
    if face_idx is not None:
        return TriangleMesh(pts, face_idx, vertex_colors=colors)
    return PointCloud(pts, normals, colors)


def _read_binary(body, elements, bo):
    offset = 0
    vertex_data, face_idx = None, None
    for el in elements:
        if any(p[0] == "list" for p in el["props"]):
            # Parse list properties (faces). Fast path: uniform triangles.
            count_t = np.dtype(bo + _PLY_TYPES[el["props"][0][1]])
            idx_t = np.dtype(bo + _PLY_TYPES[el["props"][0][2]])
            stride = count_t.itemsize + 3 * idx_t.itemsize
            raw = body[offset: offset + el["count"] * stride]
            counts = np.frombuffer(raw, dtype=count_t,
                                   offset=0)[:: stride // count_t.itemsize] if el["count"] else np.array([])
            if el["count"] and not np.all(counts == 3):
                # general (slow) path
                idx_list = []
                pos = offset
                for _ in range(el["count"]):
                    n = int(np.frombuffer(body, dtype=count_t, count=1, offset=pos)[0])
                    pos += count_t.itemsize
                    idx = np.frombuffer(body, dtype=idx_t, count=n, offset=pos)
                    pos += n * idx_t.itemsize
                    for k in range(1, n - 1):
                        idx_list.append([idx[0], idx[k], idx[k + 1]])
                offset = pos
                face = np.array(idx_list, dtype=np.int64)
            else:
                rec = np.frombuffer(raw, dtype=[("n", count_t), ("idx", idx_t, 3)])
                face = rec["idx"].astype(np.int64)
                offset += el["count"] * stride
            if el["name"] == "face":
                face_idx = face
        else:
            dt = np.dtype([(name, bo + _PLY_TYPES[t]) for t, name in el["props"]])
            raw_n = el["count"] * dt.itemsize
            arr = np.frombuffer(body[offset: offset + raw_n], dtype=dt)
            offset += raw_n
            if el["name"] == "vertex":
                vertex_data = arr
    return _assemble(vertex_data, face_idx)


def _read_ascii(body, elements):
    lines = body.decode().splitlines()
    pos = 0
    vertex_data, face_idx = None, None
    for el in elements:
        chunk = lines[pos: pos + el["count"]]
        pos += el["count"]
        if any(p[0] == "list" for p in el["props"]):
            faces = []
            for ln in chunk:
                vals = ln.split()
                n = int(vals[0])
                idx = list(map(int, vals[1: 1 + n]))
                for k in range(1, n - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
            if el["name"] == "face":
                face_idx = np.array(faces, dtype=np.int64) if faces else np.zeros((0, 3), np.int64)
        else:
            names = [name for _, name in el["props"]]
            arr = np.loadtxt(chunk, ndmin=2) if chunk else np.zeros((0, len(names)))
            rec = np.rec.fromarrays(arr.T, names=names) if len(arr) else None
            if el["name"] == "vertex":
                vertex_data = rec
    return _assemble(vertex_data, face_idx)
