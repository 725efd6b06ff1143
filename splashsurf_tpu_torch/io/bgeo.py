"""Houdini classic BGEO (v5, "BgeoV") particle IO, gzip-aware.

Pure-Python reimplementation of the capability of the reference's nom-based
parser (splashsurf_lib/src/io/bgeo_format.rs:23-1004): big-endian classic
GEO binary with magic ``BgeoV``, version 5, homogeneous points of
(x, y, z, w) float32 plus declared point attributes, terminated by the
``\\x00\\xff`` extra marker.
"""

from __future__ import annotations

import gzip
import struct
from typing import Dict, Optional, Tuple

import numpy as np

_MAGIC = b"BgeoV"

# classic GEO attribute storage types
_TYPE_FLOAT = 0
_TYPE_INT = 1
_TYPE_STRING = 2
_TYPE_INDEX = 4
_TYPE_VECTOR = 5


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.decompress(f.read())
        return f.read()


def particles_from_bgeo(path: str, dtype=np.float32):
    data = _read_bytes(path)
    if data[:5] != _MAGIC:
        raise ValueError(f"not a BGEO v5 file (bad magic): {path}")
    (version,) = struct.unpack(">i", data[5:9])
    if version != 5:
        raise ValueError(f"unsupported BGEO version {version} in {path}")
    n_points, _n_prims = struct.unpack(">ii", data[9:17])
    (
        _n_point_groups,
        _n_prim_groups,
        n_point_attribs,
        _n_vertex_attribs,
        _n_prim_attribs,
        _n_attribs,
    ) = struct.unpack(">iiiiii", data[17:41])

    off = 41
    attribs = []  # (name, size, type)
    for _ in range(n_point_attribs):
        (nlen,) = struct.unpack(">H", data[off : off + 2])
        off += 2
        name = data[off : off + nlen].decode("ascii")
        off += nlen
        size, typ = struct.unpack(">Hi", data[off : off + 6])
        off += 6
        if typ == _TYPE_INDEX:
            # index attribute: defaults are a string table
            (n_strings,) = struct.unpack(">i", data[off : off + 4])
            off += 4
            strings = []
            for _ in range(n_strings):
                (slen,) = struct.unpack(">H", data[off : off + 2])
                off += 2
                strings.append(data[off : off + slen].decode("ascii"))
                off += slen
            attribs.append((name, size, typ, strings))
        else:
            off += size * 4  # default values
            attribs.append((name, size, typ, None))

    # Per point: 4 floats position (x, y, z, w) + attribute payloads.
    attr_words = sum(a[1] for a in attribs)
    stride = 4 + attr_words
    raw = np.frombuffer(data, dtype=">f4", count=n_points * stride, offset=off)
    table = raw.reshape(n_points, stride)
    positions = np.ascontiguousarray(table[:, :3]).astype(dtype)

    attributes: Dict[str, np.ndarray] = {}
    col = 4
    for name, size, typ, _extra in attribs:
        block = table[:, col : col + size]
        if typ == _TYPE_INT or typ == _TYPE_INDEX:
            vals = np.ascontiguousarray(block).view(">i4").astype(np.int32)
            attributes[name] = vals[:, 0] if size == 1 else vals.reshape(n_points, size)
        else:
            vals = np.ascontiguousarray(block).astype(dtype)
            attributes[name] = vals[:, 0] if size == 1 else vals.reshape(n_points, size)
        col += size
    return positions, attributes


def write_particles_bgeo(path: str, positions: np.ndarray, attributes=None) -> None:
    """Write particles as (optionally gzipped) BGEO v5."""
    positions = np.asarray(positions, dtype=np.float32)
    attributes = attributes or {}
    n = len(positions)

    attr_defs = []
    payload_cols = []
    for name, data in attributes.items():
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        size = data.shape[1]
        is_int = data.dtype.kind in "iu"
        attr_defs.append((name, size, _TYPE_INT if is_int else _TYPE_FLOAT))
        payload_cols.append(
            data.astype(">i4").view(">f4") if is_int else data.astype(">f4")
        )

    out = bytearray()
    out += _MAGIC
    out += struct.pack(">i", 5)
    out += struct.pack(">ii", n, 0)
    out += struct.pack(">iiiiii", 0, 0, len(attr_defs), 0, 0, 0)
    for name, size, typ in attr_defs:
        nb = name.encode("ascii")
        out += struct.pack(">H", len(nb)) + nb
        out += struct.pack(">Hi", size, typ)
        out += b"\x00\x00\x00\x00" * size  # defaults

    table = np.empty((n, 4 + sum(s for _, s, _ in attr_defs)), dtype=">f4")
    table[:, :3] = positions
    table[:, 3] = 1.0
    col = 4
    for (name, size, _typ), payload in zip(attr_defs, payload_cols):
        table[:, col : col + size] = payload
        col += size
    out += table.tobytes()
    out += b"\x00\xff"  # extra/end marker

    data = bytes(out)
    if path.endswith(".gz") or path.endswith(".bgeo"):
        # the reference always gzips .bgeo output (bgeo_format.rs writer)
        data = gzip.compress(data)
    with open(path, "wb") as f:
        f.write(data)
