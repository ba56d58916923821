"""Minimal PLY mesh reader and writer (vertices, faces, colours), numpy
only.

Port of pvnet_tpu/data/ply.py. The reference loads every mesh through the
``plyfile`` package (ref lib/utils/base_utils.py:8, data_utils.py model
loading); this reader covers the ascii and binary files the LINEMOD data
ships, with colours and normals when present.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclasses.dataclass
class PlyMesh:
    vertices: np.ndarray                      # [n, 3] float32
    faces: Optional[np.ndarray] = None        # [m, 3] int32
    colors: Optional[np.ndarray] = None       # [n, 3] uint8
    normals: Optional[np.ndarray] = None      # [n, 3] float32


def load_ply(path: str) -> PlyMesh:
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = None
    elements: List[Tuple[str, int, list]] = []
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                continue
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))

    if fmt == "ascii":
        return _parse_ascii(body, elements)
    if fmt == "binary_little_endian":
        return _parse_binary(body, elements, "<")
    if fmt == "binary_big_endian":
        return _parse_binary(body, elements, ">")
    raise ValueError(f"{path}: unsupported PLY format {fmt}")


def _assemble(vertex_props: Dict[str, np.ndarray],
              faces: Optional[np.ndarray]) -> PlyMesh:
    verts = np.stack([vertex_props[k].astype(np.float32)
                      for k in ("x", "y", "z")], axis=-1)
    colors = None
    if all(k in vertex_props for k in ("red", "green", "blue")):
        colors = np.stack([vertex_props[k].astype(np.uint8)
                           for k in ("red", "green", "blue")], axis=-1)
    normals = None
    if all(k in vertex_props for k in ("nx", "ny", "nz")):
        normals = np.stack([vertex_props[k].astype(np.float32)
                            for k in ("nx", "ny", "nz")], axis=-1)
    return PlyMesh(vertices=verts, faces=faces, colors=colors,
                   normals=normals)


def _parse_ascii(body: bytes, elements) -> PlyMesh:
    lines = body.decode("ascii", errors="replace").splitlines()
    cursor = 0
    vertex_props: Dict[str, np.ndarray] = {}
    faces = None
    for name, count, props in elements:
        rows = lines[cursor:cursor + count]
        cursor += count
        if name == "vertex":
            scalars = [p for p in props if p[0] == "scalar"]
            arr = np.array([r.split()[:len(scalars)] for r in rows],
                           np.float64)
            for i, (_, _, pname) in enumerate(scalars):
                vertex_props[pname] = arr[:, i]
        elif name == "face":
            face_rows = []
            for r in rows:
                vals = r.split()
                n = int(vals[0])
                face_rows.append([int(v) for v in vals[1:1 + n]][:3])
            faces = np.asarray(face_rows, np.int32)
    return _assemble(vertex_props, faces)


def _parse_binary(body: bytes, elements, endian: str) -> PlyMesh:
    offset = 0
    vertex_props: Dict[str, np.ndarray] = {}
    faces = None
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            dtype = np.dtype([(p[2], endian + _PLY_TYPES[p[1]])
                              for p in props])
            arr = np.frombuffer(body, dtype=dtype, count=count,
                                offset=offset)
            offset += dtype.itemsize * count
            if name == "vertex":
                for p in props:
                    vertex_props[p[2]] = np.array(arr[p[2]])
        else:
            # list properties (faces): parse row by row
            rows = []
            for _ in range(count):
                row_vals = {}
                for p in props:
                    if p[0] == "list":
                        cnt_dt = np.dtype(endian + _PLY_TYPES[p[1]])
                        val_dt = np.dtype(endian + _PLY_TYPES[p[2]])
                        n = int(np.frombuffer(body, cnt_dt, 1, offset)[0])
                        offset += cnt_dt.itemsize
                        vals = np.frombuffer(body, val_dt, n, offset)
                        offset += val_dt.itemsize * n
                        row_vals[p[3]] = vals
                    else:
                        dt = np.dtype(endian + _PLY_TYPES[p[1]])
                        row_vals[p[2]] = np.frombuffer(body, dt, 1, offset)[0]
                        offset += dt.itemsize
                if name == "face":
                    key = next(iter(row_vals))
                    rows.append(list(row_vals[key][:3]))
            if name == "face" and rows:
                faces = np.asarray(rows, np.int32)
    return _assemble(vertex_props, faces)


def save_ply_ascii(path: str, mesh: PlyMesh) -> None:
    """Write an ascii PLY (testing / interchange utility)."""
    n = mesh.vertices.shape[0]
    m = 0 if mesh.faces is None else mesh.faces.shape[0]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if mesh.colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        if m:
            f.write(f"element face {m}\n"
                    "property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{mesh.vertices[i, 0]} {mesh.vertices[i, 1]} " \
                  f"{mesh.vertices[i, 2]}"
            if mesh.colors is not None:
                row += f" {mesh.colors[i, 0]} {mesh.colors[i, 1]} " \
                       f"{mesh.colors[i, 2]}"
            f.write(row + "\n")
        for i in range(m):
            f.write(f"3 {mesh.faces[i, 0]} {mesh.faces[i, 1]} "
                    f"{mesh.faces[i, 2]}\n")
