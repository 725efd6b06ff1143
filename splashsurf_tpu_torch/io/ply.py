"""PLY particle/mesh IO: ascii and binary little/big endian
(reference: io/ply_format.rs)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_PLY_DTYPES = {
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
}


def _parse_header(data: bytes):
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    if header[0].strip() != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # list of (name, count, [(prop_name, dtype | ('list', cdt, idt))])
    for line in header[1:]:
        parts = line.split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], ("list", parts[2], parts[3])))
            else:
                elements[-1][2].append((parts[2], parts[1]))
    return fmt, elements, end


def _read_ply(path: str):
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, offset = _parse_header(data)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    if fmt == "ascii":
        tokens = data[offset:].split()
        ti = 0
        for name, count, props in elements:
            cols: Dict[str, list] = {p: [] for p, _ in props}
            lists: Dict[str, list] = {}
            for _ in range(count):
                for pname, ptype in props:
                    if isinstance(ptype, tuple):
                        n = int(tokens[ti]); ti += 1
                        vals = [int(tokens[ti + k]) for k in range(n)]
                        ti += n
                        lists.setdefault(pname, []).append(vals)
                    else:
                        kind = np.dtype(_PLY_DTYPES[ptype]).kind
                        v = float(tokens[ti]) if kind == "f" else int(tokens[ti])
                        ti += 1
                        cols[pname].append(v)
            out[name] = {
                p: np.asarray(v)
                for p, v in cols.items()
                if v
            }
            for p, v in lists.items():
                out[name][p] = v  # ragged
    else:
        endian = "<" if "little" in fmt else ">"
        pos = offset
        for name, count, props in elements:
            has_list = any(isinstance(t, tuple) for _, t in props)
            if not has_list:
                dt = np.dtype(
                    [(p, endian + _PLY_DTYPES[t]) for p, t in props]
                )
                arr = np.frombuffer(data, dtype=dt, count=count, offset=pos)
                pos += dt.itemsize * count
                out[name] = {p: np.ascontiguousarray(arr[p]) for p, _ in props}
            else:
                rows: Dict[str, list] = {p: [] for p, _ in props}
                for _ in range(count):
                    for pname, ptype in props:
                        if isinstance(ptype, tuple):
                            _, cdt, idt = ptype
                            cdtype = np.dtype(endian + _PLY_DTYPES[cdt])
                            n = int(
                                np.frombuffer(data, dtype=cdtype, count=1, offset=pos)[0]
                            )
                            pos += cdtype.itemsize
                            idtype = np.dtype(endian + _PLY_DTYPES[idt])
                            vals = np.frombuffer(data, dtype=idtype, count=n, offset=pos)
                            pos += idtype.itemsize * n
                            rows[pname].append(vals.tolist())
                        else:
                            pdt = np.dtype(endian + _PLY_DTYPES[ptype])
                            rows[pname].append(
                                np.frombuffer(data, dtype=pdt, count=1, offset=pos)[0]
                            )
                            pos += pdt.itemsize
                out[name] = {
                    p: (np.asarray(v) if v and not isinstance(v[0], list) else v)
                    for p, v in rows.items()
                }
    return out


def particles_from_ply(path: str, dtype=np.float32):
    data = _read_ply(path)
    vert = data.get("vertex")
    if vert is None:
        raise ValueError(f"no vertex element in {path}")
    pos = np.stack(
        [vert["x"], vert["y"], vert["z"]], axis=1
    ).astype(dtype)
    attrs = {
        k: np.asarray(v).astype(dtype)
        for k, v in vert.items()
        if k not in ("x", "y", "z") and not isinstance(v, list)
    }
    # group nx/ny/nz into a normals vector like the reference
    if all(k in attrs for k in ("nx", "ny", "nz")):
        attrs["normals"] = np.stack(
            [attrs.pop("nx"), attrs.pop("ny"), attrs.pop("nz")], axis=1
        )
    return pos, attrs


def mesh_from_ply(path: str):
    from splashsurf_tpu_torch.mesh import TriMesh3d

    data = _read_ply(path)
    pos, _ = particles_from_ply(path)
    faces = None
    face_el = data.get("face")
    if face_el:
        for key in ("vertex_indices", "vertex_index"):
            if key in face_el:
                faces = face_el[key]
                break
    tris = []
    if faces is not None:
        for ids in faces:
            for i in range(1, len(ids) - 1):
                tris.append([ids[0], ids[i], ids[i + 1]])
    return TriMesh3d(
        vertices=pos,
        triangles=np.asarray(tris, dtype=np.int32).reshape(-1, 3),
    )


def write_mesh_ply(path: str, mesh, point_attributes=None) -> None:
    verts = np.asarray(mesh.vertices, dtype=np.float32)
    tris = np.asarray(mesh.triangles, dtype=np.int32)
    normals = None
    if point_attributes:
        for name, d in point_attributes.items():
            if name.lower() in ("normals", "normal") and np.ndim(d) == 2:
                normals = np.asarray(d, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"comment splashsurf_tpu_torch surface mesh\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if normals is not None:
            f.write(b"property float nx\nproperty float ny\nproperty float nz\n")
        f.write(f"element face {len(tris)}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        if normals is not None:
            inter = np.hstack([verts, normals]).astype("<f4")
        else:
            inter = verts.astype("<f4")
        f.write(inter.tobytes())
        counts = np.full((len(tris), 1), 3, dtype="u1")
        for c, t in zip(counts, tris.astype("<i4")):
            f.write(c.tobytes())
            f.write(t.tobytes())
