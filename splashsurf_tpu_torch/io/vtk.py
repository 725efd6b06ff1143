"""Legacy VTK and XML VTU readers/writers (pure Python).

Covers what the reference reads/writes via vtkio (io/vtk_format.rs): legacy
DataFile v2-5.1 ASCII/BINARY unstructured grids and polydata for particles
and meshes, plus XML .vtu with inline/appended data (raw or base64, with
optional zlib compression).
"""

from __future__ import annotations

import base64
import re
import struct
import zlib
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Tuple

import numpy as np

_VTK_DTYPES = {
    "float": ">f4",
    "double": ">f8",
    "int": ">i4",
    "long": ">i8",
    "unsigned_int": ">u4",
    "unsigned_long": ">u8",
    "unsigned_char": ">u1",
    "char": ">i1",
    "short": ">i2",
    "unsigned_short": ">u2",
    "vtktypeint64": ">i8",
    "vtktypeuint64": ">u8",
    "vtktypeint32": ">i4",
    "vtktypeuint32": ">u4",
}

_XML_DTYPES = {
    "Float32": "f4",
    "Float64": "f8",
    "Int8": "i1",
    "UInt8": "u1",
    "Int16": "i2",
    "UInt16": "u2",
    "Int32": "i4",
    "UInt32": "u4",
    "Int64": "i8",
    "UInt64": "u8",
}


# ---------------------------------------------------------------------------
# legacy VTK reading
# ---------------------------------------------------------------------------


class _LegacyVtk:
    """Tokenizing reader over a legacy VTK file (handles BINARY payloads)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = f.read()
        self.pos = 0

    def readline(self) -> str:
        end = self.data.find(b"\n", self.pos)
        if end == -1:
            line = self.data[self.pos :]
            self.pos = len(self.data)
        else:
            line = self.data[self.pos : end]
            self.pos = end + 1
        return line.decode("ascii", errors="replace").strip()

    def next_nonempty_line(self) -> str:
        while self.pos < len(self.data):
            line = self.readline()
            if line:
                return line
        return ""

    def read_array_binary(self, count: int, vtk_type: str) -> np.ndarray:
        dt = np.dtype(_VTK_DTYPES[vtk_type])
        nbytes = count * dt.itemsize
        arr = np.frombuffer(self.data, dtype=dt, count=count, offset=self.pos)
        self.pos += nbytes
        # binary sections are terminated by a newline
        if self.pos < len(self.data) and self.data[self.pos : self.pos + 1] == b"\n":
            self.pos += 1
        return arr.astype(dt.newbyteorder("="))

    def read_array_ascii(self, count: int, vtk_type: str) -> np.ndarray:
        values = []
        while len(values) < count:
            line = self.next_nonempty_line()
            if not line:
                raise ValueError("unexpected EOF in ASCII data section")
            values.extend(line.split())
        kind = np.dtype(_VTK_DTYPES[vtk_type]).kind
        cast = float if kind == "f" else int
        return np.array([cast(v) for v in values[:count]])


def _read_legacy(path: str):
    """Parse a legacy VTK file into (points, point_data dict, cells info)."""
    r = _LegacyVtk(path)
    header = r.readline()
    if not header.startswith("# vtk DataFile"):
        raise ValueError(f"not a legacy VTK file: {path}")
    vm = re.search(r"Version\s+(\d+)\.(\d+)", header)
    version = (int(vm.group(1)), int(vm.group(2))) if vm else (4, 2)
    _title = r.readline()
    fmt = r.next_nonempty_line().upper()
    if fmt not in ("ASCII", "BINARY"):
        raise ValueError(f"unknown VTK format {fmt!r}")
    binary = fmt == "BINARY"

    def read_array(count, vtk_type):
        return (
            r.read_array_binary(count, vtk_type)
            if binary
            else r.read_array_ascii(count, vtk_type)
        )

    points = None
    point_data: Dict[str, np.ndarray] = {}
    connectivity = None
    offsets = None
    cell_types = None
    num_points = 0

    line = r.next_nonempty_line()
    while line:
        upper = line.upper()
        parts = line.split()
        if upper.startswith("DATASET"):
            pass
        elif upper.startswith("POINTS"):
            num_points = int(parts[1])
            vtk_type = parts[2].lower()
            arr = read_array(num_points * 3, vtk_type)
            points = np.asarray(arr, dtype=np.float64).reshape(num_points, 3)
        elif upper.startswith("METADATA"):
            # Skip metadata blocks (INFORMATION n ... followed by entries).
            while True:
                sub = r.next_nonempty_line()
                if not sub or sub.upper().startswith(
                    ("POINTS", "CELLS", "CELL_TYPES", "POINT_DATA", "CELL_DATA",
                     "POLYGONS", "VERTICES", "OFFSETS", "CONNECTIVITY", "FIELD")
                ):
                    line = sub
                    break
            continue
        elif upper.startswith("CELLS"):
            n_cells, n_ints = int(parts[1]), int(parts[2])
            if version >= (5, 0):
                # VTK 5.x style: OFFSETS <dtype> then CONNECTIVITY <dtype>;
                # the CELLS counts are (n_offsets, n_connectivity).
                nxt = r.next_nonempty_line()
                if not nxt.upper().startswith("OFFSETS"):
                    raise ValueError(f"expected OFFSETS in v5 CELLS, got {nxt!r}")
                off_type = nxt.split()[1].lower()
                offsets = read_array(n_cells, off_type)
                conn_line = r.next_nonempty_line()
                conn_type = conn_line.split()[1].lower()
                n_conn = int(offsets[-1]) if len(offsets) else 0
                connectivity = read_array(n_conn, conn_type)
                offsets = offsets[1:] if len(offsets) and offsets[0] == 0 else offsets
            else:
                # classic style: n_ints ints of [count, ids..., count, ids...]
                flat = np.asarray(read_array(n_ints, "int"), dtype=np.int64)
                conn, offs, i = [], [0], 0
                while i < len(flat):
                    c = int(flat[i])
                    conn.extend(flat[i + 1 : i + 1 + c].tolist())
                    offs.append(offs[-1] + c)
                    i += 1 + c
                connectivity = np.array(conn, dtype=np.int64)
                offsets = np.array(offs[1:], dtype=np.int64)
        elif upper.startswith("CELL_TYPES"):
            n = int(parts[1])
            cell_types = read_array(n, "int" if binary else "int")
        elif upper.startswith("POINT_DATA"):
            n = int(parts[1])
            line = _read_attributes(r, read_array, n, point_data)
            continue
        elif upper.startswith("CELL_DATA"):
            n = int(parts[1])
            dummy: Dict[str, np.ndarray] = {}
            line = _read_attributes(r, read_array, n, dummy)
            continue
        line = r.next_nonempty_line()

    return points, point_data, connectivity, offsets, cell_types


def _read_attributes(r, read_array, n, out: Dict[str, np.ndarray]) -> str:
    """Read SCALARS/VECTORS/NORMALS/FIELD blocks; returns the next section line."""
    while True:
        line = r.next_nonempty_line()
        if not line:
            return ""
        upper = line.upper()
        parts = line.split()
        if upper.startswith("SCALARS"):
            name, vtk_type = parts[1], parts[2].lower()
            ncomp = int(parts[3]) if len(parts) > 3 else 1
            lookup = r.next_nonempty_line()  # LOOKUP_TABLE default
            if not lookup.upper().startswith("LOOKUP_TABLE"):
                raise ValueError("expected LOOKUP_TABLE after SCALARS")
            arr = read_array(n * ncomp, vtk_type)
            out[name] = arr.reshape(n, ncomp) if ncomp > 1 else arr
        elif upper.startswith(("VECTORS", "NORMALS")):
            name, vtk_type = parts[1], parts[2].lower()
            out[name] = read_array(n * 3, vtk_type).reshape(n, 3)
        elif upper.startswith("FIELD"):
            n_arrays = int(parts[2])
            for _ in range(n_arrays):
                fl = r.next_nonempty_line().split()
                fname, ncomp, tuples, vtk_type = (
                    fl[0],
                    int(fl[1]),
                    int(fl[2]),
                    fl[3].lower(),
                )
                arr = read_array(tuples * ncomp, vtk_type)
                out[fname] = arr.reshape(tuples, ncomp) if ncomp > 1 else arr
        else:
            return line


def particles_from_vtk(path: str, dtype=np.float32):
    points, point_data, _, _, _ = _read_legacy(path)
    if points is None:
        raise ValueError(f"no POINTS section in {path}")
    return points.astype(dtype), {
        k: v.astype(dtype) if v.dtype.kind == "f" else v
        for k, v in point_data.items()
    }


def mesh_from_vtk(path: str):
    from splashsurf_tpu_torch.mesh import TriMesh3d

    points, _, connectivity, offsets, cell_types = _read_legacy(path)
    if connectivity is None:
        raise ValueError(f"no cells in {path}")
    tris = []
    start = 0
    for end in offsets:
        ids = connectivity[start:end]
        if len(ids) == 3:
            tris.append(ids)
        elif len(ids) == 4:
            tris.append([ids[0], ids[1], ids[2]])
            tris.append([ids[0], ids[2], ids[3]])
        start = end
    return TriMesh3d(
        vertices=points.astype(np.float32),
        triangles=np.array(tris, dtype=np.int32),
    )


# ---------------------------------------------------------------------------
# XML VTU reading
# ---------------------------------------------------------------------------


def _b64_chars(nbytes: int) -> int:
    return ((nbytes + 2) // 3) * 4


def _vtu_read_appended(
    raw: bytes, offset: int, header_dtype, compressed: bool, encoding: str = "raw"
) -> bytes:
    """Extract one DataArray payload from the appended section.

    For ``raw`` encoding, ``offset`` indexes bytes; for ``base64`` it indexes
    characters of the encoded stream (each array is encoded standalone; with
    compression the block header and the blocks are encoded separately).
    """
    hs = header_dtype.itemsize
    if encoding == "base64":
        if not compressed:
            head = base64.b64decode(raw[offset : offset + _b64_chars(hs) + 4][: _b64_chars(hs + 2)])
            (n,) = np.frombuffer(head[:hs], dtype=header_dtype, count=1)
            total = base64.b64decode(raw[offset : offset + _b64_chars(hs + int(n))])
            return total[hs : hs + int(n)]
        # compressed: base64(header) || base64(blocks)
        head3 = base64.b64decode(raw[offset : offset + _b64_chars(3 * hs)])
        n_blocks = int(np.frombuffer(head3, dtype=header_dtype, count=1)[0])
        hdr_len = (3 + n_blocks) * hs
        header = base64.b64decode(raw[offset : offset + _b64_chars(hdr_len)])
        sizes = np.frombuffer(header, dtype=header_dtype, count=n_blocks, offset=3 * hs)
        body_off = offset + _b64_chars(hdr_len)
        body = base64.b64decode(
            raw[body_off : body_off + _b64_chars(int(sizes.sum()))]
        )
        out = bytearray()
        pos = 0
        for s in sizes:
            out.extend(zlib.decompress(body[pos : pos + int(s)]))
            pos += int(s)
        return bytes(out)

    if not compressed:
        (n,) = np.frombuffer(raw, dtype=header_dtype, count=1, offset=offset)
        start = offset + hs
        return raw[start : start + int(n)]
    hdr = np.frombuffer(raw, dtype=header_dtype, count=3, offset=offset)
    n_blocks = int(hdr[0])
    sizes = np.frombuffer(raw, dtype=header_dtype, count=n_blocks, offset=offset + 3 * hs)
    pos = offset + (3 + n_blocks) * hs
    out = bytearray()
    for s in sizes:
        out.extend(zlib.decompress(raw[pos : pos + int(s)]))
        pos += int(s)
    return bytes(out)


def _vtu_data_array(
    elem,
    appended: Optional[bytes],
    header_dtype,
    compressed: bool,
    byte_order: str,
    encoding: str = "raw",
):
    dt = np.dtype(_XML_DTYPES[elem.get("type")]).newbyteorder(
        "<" if byte_order == "LittleEndian" else ">"
    )
    fmt = elem.get("format", "ascii")
    if fmt == "ascii":
        text = elem.text or ""
        kind = dt.kind
        cast = float if kind == "f" else int
        return np.array([cast(t) for t in text.split()], dtype=dt)
    elif fmt == "appended":
        payload = _vtu_read_appended(
            appended, int(elem.get("offset", "0")), header_dtype, compressed, encoding
        )
        return np.frombuffer(payload, dtype=dt)
    elif fmt == "binary":
        text = re.sub(r"\s", "", elem.text or "")
        raw = base64.b64decode(text)
        if compressed:
            hdr1 = np.frombuffer(raw, dtype=header_dtype, count=3)
            n_blocks = int(hdr1[0])
            hdr_len = (3 + n_blocks) * header_dtype.itemsize
            # base64 splits header and body at the 4-header boundary; decode of
            # the concatenated stream still yields header||body for our writer
            # and vtk's (single-stream b64).
            sizes = np.frombuffer(raw, dtype=header_dtype, count=n_blocks, offset=3 * header_dtype.itemsize)
            pos = hdr_len
            out = bytearray()
            for s in sizes:
                out.extend(zlib.decompress(raw[pos : pos + int(s)]))
                pos += int(s)
            return np.frombuffer(bytes(out), dtype=dt)
        (n,) = np.frombuffer(raw, dtype=header_dtype, count=1)
        return np.frombuffer(raw, dtype=dt, count=int(n) // dt.itemsize, offset=header_dtype.itemsize)
    else:
        raise ValueError(f"unsupported DataArray format {fmt!r}")


def particles_from_vtu(path: str, dtype=np.float32):
    with open(path, "rb") as f:
        content = f.read()

    # Split out the appended data section (may contain raw bytes that break XML).
    appended = None
    encoding = "raw"
    m = re.search(rb'<AppendedData\s+encoding="(\w+)"\s*>', content)
    if m:
        encoding = m.group(1).decode()
        start = content.index(b"_", m.end()) + 1
        end = content.rindex(b"</AppendedData>")
        payload = content[start:end]
        if encoding == "base64":
            appended = re.sub(rb"\s", b"", payload)
        else:
            appended = payload
        content = content[: m.start()] + b"</VTKFile>"

    root = ET.fromstring(content.decode("utf-8", errors="replace"))
    byte_order = root.get("byte_order", "LittleEndian")
    header_type = root.get("header_type", "UInt32")
    header_dtype = np.dtype(_XML_DTYPES[header_type]).newbyteorder(
        "<" if byte_order == "LittleEndian" else ">"
    )
    compressed = root.get("compressor") is not None

    piece = root.find(".//Piece")
    n_points = int(piece.get("NumberOfPoints"))
    pts_elem = piece.find("./Points/DataArray")
    pts = _vtu_data_array(pts_elem, appended, header_dtype, compressed, byte_order, encoding)
    positions = np.asarray(pts, dtype=np.float64).reshape(n_points, 3).astype(dtype)

    attributes: Dict[str, np.ndarray] = {}
    pd = piece.find("./PointData")
    if pd is not None:
        for arr_elem in pd.findall("./DataArray"):
            name = arr_elem.get("Name")
            ncomp = int(arr_elem.get("NumberOfComponents", "1"))
            arr = _vtu_data_array(arr_elem, appended, header_dtype, compressed, byte_order, encoding)
            arr = np.asarray(arr)
            if ncomp > 1:
                arr = arr.reshape(n_points, ncomp)
            if arr.dtype.kind == "f":
                arr = arr.astype(dtype)
            attributes[name] = arr
    return positions, attributes


# ---------------------------------------------------------------------------
# legacy VTK writing
# ---------------------------------------------------------------------------


def _write_attributes_legacy(f, attributes: Optional[Dict[str, np.ndarray]], n: int):
    if not attributes:
        return
    f.write(f"POINT_DATA {n}\n".encode())
    for name, data in attributes.items():
        data = np.asarray(data)
        if data.ndim == 2 and data.shape[1] == 3:
            f.write(f"VECTORS {name} float\n".encode())
            f.write(np.ascontiguousarray(data, dtype=">f4").tobytes())
            f.write(b"\n")
        else:
            vtk_type = "float" if data.dtype.kind == "f" else "long"
            np_type = ">f4" if data.dtype.kind == "f" else ">i8"
            f.write(f"SCALARS {name} {vtk_type} 1\nLOOKUP_TABLE default\n".encode())
            f.write(np.ascontiguousarray(data.reshape(-1), dtype=np_type).tobytes())
            f.write(b"\n")


def write_mesh_vtk(path: str, mesh, point_attributes=None) -> None:
    """Write a triangle / tri-quad / hex / point-cloud mesh as legacy binary VTK."""
    verts = np.asarray(mesh.vertices)
    hex_cells = getattr(mesh, "cells", None)
    if hex_cells is not None and not hasattr(mesh, "triangles"):
        # hexahedral mesh (VTK_HEXAHEDRON = 12)
        hex_cells = np.asarray(hex_cells, dtype=np.int64)
        with open(path, "wb") as f:
            f.write(b"# vtk DataFile Version 4.2\n")
            f.write(b"splashsurf_tpu_torch hex mesh\n")
            f.write(b"BINARY\nDATASET UNSTRUCTURED_GRID\n")
            f.write(f"POINTS {len(verts)} float\n".encode())
            f.write(np.ascontiguousarray(verts, dtype=">f4").tobytes())
            f.write(b"\n")
            n = len(hex_cells)
            f.write(f"CELLS {n} {9 * n}\n".encode())
            cells = np.column_stack([np.full(n, 8, np.int64), hex_cells])
            f.write(np.ascontiguousarray(cells, dtype=">i4").tobytes())
            f.write(b"\n")
            f.write(f"CELL_TYPES {n}\n".encode())
            f.write(np.full(n, 12, dtype=">i4").tobytes())
            f.write(b"\n")
            _write_attributes_legacy(f, point_attributes, len(verts))
        return
    if not hasattr(mesh, "triangles"):
        write_particles_vtk(path, verts, point_attributes)
        return
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 4.2\n")
        f.write(b"splashsurf_tpu_torch surface mesh\n")
        f.write(b"BINARY\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(verts)} float\n".encode())
        f.write(np.ascontiguousarray(verts, dtype=">f4").tobytes())
        f.write(b"\n")

        quads = getattr(mesh, "quads", None)
        tris = np.asarray(mesh.triangles, dtype=np.int64)
        n_cells = len(tris) + (len(quads) if quads is not None else 0)
        size = len(tris) * 4 + (len(quads) * 5 if quads is not None else 0)
        f.write(f"CELLS {n_cells} {size}\n".encode())
        cells = np.column_stack([np.full(len(tris), 3, dtype=np.int64), tris])
        f.write(np.ascontiguousarray(cells, dtype=">i4").tobytes())
        if quads is not None and len(quads):
            qcells = np.column_stack(
                [np.full(len(quads), 4, dtype=np.int64), np.asarray(quads, np.int64)]
            )
            f.write(np.ascontiguousarray(qcells, dtype=">i4").tobytes())
        f.write(b"\n")
        f.write(f"CELL_TYPES {n_cells}\n".encode())
        types = np.full(len(tris), 5, dtype=">i4")  # VTK_TRIANGLE
        f.write(types.tobytes())
        if quads is not None and len(quads):
            f.write(np.full(len(quads), 9, dtype=">i4").tobytes())  # VTK_QUAD
        f.write(b"\n")
        _write_attributes_legacy(f, point_attributes, len(verts))


def write_particles_vtk(path: str, positions: np.ndarray, attributes=None) -> None:
    """Write particles as legacy binary VTK unstructured grid of VTK_VERTEX."""
    positions = np.asarray(positions)
    n = len(positions)
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 4.2\n")
        f.write(b"splashsurf_tpu_torch particle data\n")
        f.write(b"BINARY\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {n} float\n".encode())
        f.write(np.ascontiguousarray(positions, dtype=">f4").tobytes())
        f.write(b"\n")
        f.write(f"CELLS {n} {2 * n}\n".encode())
        cells = np.column_stack(
            [np.ones(n, dtype=np.int64), np.arange(n, dtype=np.int64)]
        )
        f.write(np.ascontiguousarray(cells, dtype=">i4").tobytes())
        f.write(b"\n")
        f.write(f"CELL_TYPES {n}\n".encode())
        f.write(np.full(n, 1, dtype=">i4").tobytes())  # VTK_VERTEX
        f.write(b"\n")
        _write_attributes_legacy(f, attributes, n)


# ---------------------------------------------------------------------------
# XML VTU writing
# ---------------------------------------------------------------------------


def write_mesh_vtu(path: str, mesh, point_attributes=None) -> None:
    """Write a triangle mesh as XML VTU with raw appended data."""
    verts = np.ascontiguousarray(mesh.vertices, dtype="<f8")
    tris = np.ascontiguousarray(mesh.triangles, dtype="<i8")
    n_pts, n_cells = len(verts), len(tris)
    conn = tris.reshape(-1)
    offs = (np.arange(1, n_cells + 1, dtype="<i8") * 3)
    types = np.full(n_cells, 5, dtype="u1")  # VTK_TRIANGLE

    blocks = [verts.tobytes(), conn.tobytes(), offs.tobytes(), types.tobytes()]
    attr_meta = []
    for name, data in (point_attributes or {}).items():
        data = np.asarray(data)
        ncomp = 1 if data.ndim == 1 else data.shape[1]
        payload = np.ascontiguousarray(data, dtype="<f8").tobytes()
        attr_meta.append((name, ncomp))
        blocks.append(payload)

    offsets, pos = [], 0
    for b in blocks:
        offsets.append(pos)
        pos += 8 + len(b)  # UInt64 size header + payload

    def da(dtype, name, ncomp, off):
        nc = f' NumberOfComponents="{ncomp}"' if ncomp else ""
        nm = f' Name="{name}"' if name else ""
        return (
            f'        <DataArray type="{dtype}"{nm}{nc} format="appended" '
            f'offset="{off}"/>\n'
        )

    with open(path, "wb") as f:
        f.write(b'<?xml version="1.0"?>\n')
        f.write(
            b'<VTKFile type="UnstructuredGrid" version="1.0" '
            b'byte_order="LittleEndian" header_type="UInt64">\n'
        )
        f.write(b"  <UnstructuredGrid>\n")
        f.write(
            f'    <Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">\n'.encode()
        )
        f.write(b"      <Points>\n")
        f.write(da("Float64", "Points", 3, offsets[0]).encode())
        f.write(b"      </Points>\n      <Cells>\n")
        f.write(da("Int64", "connectivity", 0, offsets[1]).encode())
        f.write(da("Int64", "offsets", 0, offsets[2]).encode())
        f.write(da("UInt8", "types", 0, offsets[3]).encode())
        f.write(b"      </Cells>\n")
        if attr_meta:
            f.write(b"      <PointData>\n")
            for (name, ncomp), off in zip(attr_meta, offsets[4:]):
                f.write(da("Float64", name, ncomp if ncomp > 1 else 0, off).encode())
            f.write(b"      </PointData>\n")
        f.write(b"    </Piece>\n  </UnstructuredGrid>\n")
        f.write(b'  <AppendedData encoding="raw">\n_')
        for b in blocks:
            f.write(struct.pack("<Q", len(b)))
            f.write(b)
        f.write(b"\n  </AppendedData>\n</VTKFile>\n")


def mesh_from_vtu(path: str):
    """Read a triangle mesh from a VTU file."""
    from splashsurf_tpu_torch.mesh import TriMesh3d

    with open(path, "rb") as f:
        content = f.read()
    appended = None
    encoding = "raw"
    m = re.search(rb'<AppendedData\s+encoding="(\w+)"\s*>', content)
    if m:
        encoding = m.group(1).decode()
        start = content.index(b"_", m.end()) + 1
        end = content.rindex(b"</AppendedData>")
        payload = content[start:end]
        appended = (
            re.sub(rb"\s", b"", payload) if encoding == "base64" else payload
        )
        content = content[: m.start()] + b"</VTKFile>"
    root = ET.fromstring(content.decode("utf-8", errors="replace"))
    byte_order = root.get("byte_order", "LittleEndian")
    header_dtype = np.dtype(
        _XML_DTYPES[root.get("header_type", "UInt32")]
    ).newbyteorder("<" if byte_order == "LittleEndian" else ">")
    compressed = root.get("compressor") is not None
    piece = root.find(".//Piece")
    pts = _vtu_data_array(
        piece.find("./Points/DataArray"), appended, header_dtype, compressed,
        byte_order, encoding,
    )
    n_points = int(piece.get("NumberOfPoints"))
    verts = np.asarray(pts, np.float64).reshape(n_points, 3).astype(np.float32)
    cells = {e.get("Name"): e for e in piece.findall("./Cells/DataArray")}
    conn = np.asarray(
        _vtu_data_array(cells["connectivity"], appended, header_dtype, compressed, byte_order, encoding),
        np.int64,
    )
    offs = np.asarray(
        _vtu_data_array(cells["offsets"], appended, header_dtype, compressed, byte_order, encoding),
        np.int64,
    )
    tris = []
    start = 0
    for end in offs:
        ids = conn[start:end]
        if len(ids) == 3:
            tris.append(ids)
        start = end
    return TriMesh3d(verts, np.asarray(tris, np.int32).reshape(-1, 3))
