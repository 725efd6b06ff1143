"""File-sequence expansion for animation frames (a copy of
``splashsurf_tpu.sequence``).

Mirrors the reference's sequence runner (splashsurf/src/reconstruct.rs:
700-979): an input path containing a ``{}`` placeholder expands to all
files matching ``prefix(\\d+)suffix``, naturally sorted, optionally
filtered to a [start, end] frame-index range; the output pattern's ``{}``
is replaced by each frame's index string.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional


@dataclasses.dataclass
class SequencePaths:
    input_file: str
    output_file: str
    index: Optional[int] = None


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


def collect_sequence(
    input_pattern: str,
    output_pattern: str,
    start_index: Optional[int] = None,
    end_index: Optional[int] = None,
) -> List[SequencePaths]:
    """Expand a ``{}`` input pattern into per-frame (input, output) paths."""
    directory = os.path.dirname(input_pattern) or "."
    in_name = os.path.basename(input_pattern)
    out_dir = os.path.dirname(output_pattern)
    out_name = os.path.basename(output_pattern)
    if "{}" not in in_name:
        raise ValueError("sequence input filename must contain a {} placeholder")
    prefix, suffix = in_name.split("{}", 1)
    pattern = re.compile(
        rf"^{re.escape(prefix)}(\d+){re.escape(suffix)}$"
    )

    entries = []
    for fname in os.listdir(directory):
        m = pattern.match(fname)
        if not m:
            continue
        idx = int(m.group(1))
        if start_index is not None and idx < start_index:
            continue
        if end_index is not None and idx > end_index:
            continue
        out_file = os.path.join(out_dir, out_name.replace("{}", m.group(1)))
        entries.append(
            SequencePaths(
                input_file=os.path.join(directory, fname),
                output_file=out_file,
                index=idx,
            )
        )
    entries.sort(key=lambda e: _natural_key(os.path.basename(e.input_file)))
    return entries


def is_sequence(path: str) -> bool:
    return "{}" in os.path.basename(path)


def default_output_name(input_file: str, output_dir: Optional[str] = None) -> str:
    """'{original_filename}_surface.vtk' (reconstruct.rs:43,939-944)."""
    base = os.path.basename(input_file)
    stem, _ext = os.path.splitext(base)
    if "{}" in stem:
        name = stem.replace("{}", "surface_{}") + ".vtk"
    else:
        name = f"{stem}_surface.vtk"
    return os.path.join(output_dir or os.path.dirname(input_file) or ".", name)
