"""VTK unstructured-grid readers/writers (no pyvista dependency); a copy
of tpufem/io/vtk.py, which is numpy only.  The one change: the writers
take torch tensors (on any device) as well as arrays, and bring them to
host numpy first; for the same numpy inputs they write tpufem's bytes.

Capability parity with reference vtk_loader_to_torch (solver/element.py:39-90)
— that function shells out to pyvista, which reads both the legacy .vtk
format and the XML .vtu format that SimJEB-era pipelines actually emit.
Self-contained parsers for both:

* legacy .vtk — ASCII and big-endian binary, DATASET UNSTRUCTURED_GRID;
* XML .vtu — ascii / inline-base64 / appended (raw and base64) data
  arrays, optionally zlib-compressed (vtkZLibDataCompressor), both
  UInt32 and UInt64 headers, either byte order;

plus writers for results inspection and round-trip tests.

VTK cell type ids <-> element types:
  10 c3d4, 24 c3d10, 12 c3d8, 25 c3d20, 13 c3d6, 26 c3d15,
  5 s3, 22 s6, 9 s4, 23 s8.
"""
from __future__ import annotations

import base64
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

VTK_TO_ETYPE = {10: "c3d4", 24: "c3d10", 12: "c3d8", 25: "c3d20",
                13: "c3d6", 26: "c3d15", 5: "s3", 22: "s6", 9: "s4", 23: "s8"}
ETYPE_TO_VTK = {v: k for k, v in VTK_TO_ETYPE.items()}
_NODES = {"c3d4": 4, "c3d10": 10, "c3d8": 8, "c3d20": 20, "c3d6": 6,
          "c3d15": 15, "s3": 3, "s6": 6, "s4": 4, "s8": 8}

_DTYPES = {"float": ">f4", "double": ">f8", "int": ">i4", "long": ">i8",
           "unsigned_int": ">u4", "vtktypeint64": ">i8", "vtktypeint32": ">i4",
           "char": ">i1", "unsigned_char": ">u1", "short": ">i2"}


def _host(x):
    """A torch tensor as a host numpy array; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _host_args(points, blocks, point_data):
    return (_host(points), {et: _host(c) for et, c in blocks.items()},
            ({name: _host(a) for name, a in point_data.items()}
             if point_data else point_data))


def _read_tokens_ascii(data: bytes, offset: int, count: int, dtype):
    toks = []
    pos = offset
    while len(toks) < count:
        eol = data.find(b"\n", pos)
        if eol < 0:
            eol = len(data)
        toks.extend(data[pos:eol].split())
        pos = eol + 1
    arr = np.array(toks[:count], dtype=dtype)
    return arr, pos


def read_vtk(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Parse a legacy .vtk unstructured grid.

    Returns (points [N, 3] float64, {etype: connectivity [M_t, k]}).
    """
    with open(path, "rb") as f:
        data = f.read()

    lines_end = 0
    header_lines = []
    pos = 0
    for _ in range(4):
        eol = data.find(b"\n", pos)
        header_lines.append(data[pos:eol].strip().decode("latin1"))
        pos = eol + 1
    binary = header_lines[2].upper() == "BINARY"
    if "UNSTRUCTURED_GRID" not in header_lines[3].upper():
        raise ValueError(f"not an unstructured grid: {header_lines[3]}")

    points = None
    conn_flat = None
    offsets = None
    cell_types = None

    while pos < len(data):
        eol = data.find(b"\n", pos)
        if eol < 0:
            break
        line = data[pos:eol].strip().decode("latin1")
        pos = eol + 1
        if not line:
            continue
        parts = line.split()
        kw = parts[0].upper()
        if kw == "POINTS":
            n = int(parts[1])
            dt = _DTYPES[parts[2].lower()]
            if binary:
                nbytes = n * 3 * np.dtype(dt).itemsize
                points = np.frombuffer(data[pos:pos + nbytes], dtype=dt
                                       ).astype(np.float64).reshape(n, 3)
                pos += nbytes + 1
            else:
                arr, pos = _read_tokens_ascii(data, pos, n * 3, np.float64)
                points = arr.reshape(n, 3)
        elif kw == "CELLS":
            ncells, total = int(parts[1]), int(parts[2])
            if binary:
                nbytes = total * 4
                raw = np.frombuffer(data[pos:pos + nbytes], dtype=">i4"
                                    ).astype(np.int64)
                pos += nbytes + 1
            else:
                raw, pos = _read_tokens_ascii(data, pos, total, np.int64)
            if ncells + 1 == total or (total == ncells + 1):
                offsets = raw  # rare OFFSETS form
            else:
                conn_flat = raw
        elif kw in ("OFFSETS", "CONNECTIVITY"):
            n = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else None
            dt = _DTYPES.get(parts[-1].lower(), ">i8")
            count = n if n is not None else 0
            if binary:
                nbytes = count * np.dtype(dt).itemsize
                raw = np.frombuffer(data[pos:pos + nbytes], dtype=dt
                                    ).astype(np.int64)
                pos += nbytes + 1
            else:
                raw, pos = _read_tokens_ascii(data, pos, count, np.int64)
            if kw == "OFFSETS":
                offsets = raw
            else:
                conn_flat = raw
        elif kw == "CELL_TYPES":
            n = int(parts[1])
            if binary:
                nbytes = n * 4
                cell_types = np.frombuffer(data[pos:pos + nbytes], dtype=">i4"
                                           ).astype(np.int64)
                pos += nbytes + 1
            else:
                cell_types, pos = _read_tokens_ascii(data, pos, n, np.int64)
        elif kw in ("POINT_DATA", "CELL_DATA", "FIELD"):
            break  # attributes not needed for mesh loading

    if points is None or conn_flat is None or cell_types is None:
        raise ValueError("incomplete VTK file (need POINTS, CELLS, CELL_TYPES)")

    blocks: Dict[str, list] = {}
    if offsets is not None and conn_flat is not None and offsets.size == cell_types.size + 1:
        for ci, ct in enumerate(cell_types):
            et = VTK_TO_ETYPE.get(int(ct))
            if et is None:
                continue
            blocks.setdefault(et, []).append(
                conn_flat[offsets[ci]:offsets[ci + 1]])
    else:
        # classic [n, id0, ..., idn-1] stream
        i = 0
        ci = 0
        while i < conn_flat.size:
            n = int(conn_flat[i])
            et = VTK_TO_ETYPE.get(int(cell_types[ci]))
            if et is not None:
                blocks.setdefault(et, []).append(conn_flat[i + 1:i + 1 + n])
            i += n + 1
            ci += 1
    out = {et: np.stack(v).astype(np.int32) for et, v in blocks.items()}
    return points, out


# ---------------------------------------------------------------------------
# XML .vtu (the pyvista/VTK default output format)
# ---------------------------------------------------------------------------

_VTU_DTYPES = {
    "float32": "f4", "float64": "f8", "int8": "i1", "uint8": "u1",
    "int16": "i2", "uint16": "u2", "int32": "i4", "uint32": "u4",
    "int64": "i8", "uint64": "u8",
}


def _b64_take(txt: str, start: int, nbytes: int) -> bytes:
    """Decode exactly nbytes from a 4-char-aligned offset of a base64
    stream (decoding only as many chars as needed: VTK appends further
    arrays after this one in the same stream, so decoding to the end
    would hit their padding)."""
    nchars = 4 * (-(-nbytes // 3))
    return base64.b64decode(txt[start:start + nchars])[:nbytes]


def _vtu_decode(elem, appended, byte_order: str,
                header_dtype, compressed: bool) -> np.ndarray:
    """Decode one <DataArray> element to a flat numpy array.

    appended: None, ("raw", bytes) or ("b64", str).  VTK encodes each
    appended array SEPARATELY (offset attributes count encoded chars),
    and under compression the header is a separate base64 segment from
    the body — both for inline `binary` format and base64 appended data
    (vtkXMLWriter behavior; reference loader gets this via pyvista,
    solver/element.py:39-90)."""
    dt = np.dtype(byte_order + _VTU_DTYPES[elem.get("type").lower()])
    fmt = (elem.get("format") or "ascii").lower()
    if fmt == "ascii":
        return np.array((elem.text or "").split(), dtype=dt)
    hd = np.dtype(header_dtype)
    txt = None
    if fmt == "binary":
        txt = "".join((elem.text or "").split())
    elif fmt == "appended":
        if appended is None:
            raise ValueError("appended DataArray but no AppendedData section")
        enc, payload = appended
        off = int(elem.get("offset", "0"))
        if enc == "b64":
            txt = payload[off:]
        else:
            raw = payload[off:]
    else:
        raise ValueError(f"unknown DataArray format {fmt!r}")
    if compressed:
        if txt is not None:
            # header and body are SEPARATE base64 segments
            first = _b64_take(txt, 0, hd.itemsize)
            nb = int(np.frombuffer(first, hd, 1, 0)[0])
            hlen = (3 + nb) * hd.itemsize
            head = np.frombuffer(_b64_take(txt, 0, hlen), hd, 3 + nb, 0)
            hb64 = 4 * (-(-hlen // 3))
            raw = _b64_take(txt, hb64, int(head[3:].sum()))
            pos = 0
        else:
            nb = int(np.frombuffer(raw, hd, 1, 0)[0])
            head = np.frombuffer(raw, hd, 3 + nb, 0)
            pos = (3 + nb) * hd.itemsize
        # header: [nblocks, blocksize, last_blocksize, compressed sizes...]
        chunks = []
        for s in head[3:]:
            chunks.append(zlib.decompress(raw[pos:pos + int(s)]))
            pos += int(s)
        return np.frombuffer(b"".join(chunks), dtype=dt)
    if txt is not None:
        first = _b64_take(txt, 0, hd.itemsize)
        nbytes = int(np.frombuffer(first, hd, 1, 0)[0])
        raw = _b64_take(txt, 0, hd.itemsize + nbytes)
    else:
        nbytes = int(np.frombuffer(raw, hd, 1, 0)[0])
    return np.frombuffer(raw, dt, nbytes // dt.itemsize, hd.itemsize)


def read_vtu(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Parse an XML .vtu unstructured grid.

    Returns (points [N, 3] float64, {etype: connectivity [M_t, k]}) —
    the same contract as read_vtk.  Handles ascii, inline-base64 and
    appended (raw or base64) data, optionally zlib-compressed.
    """
    import xml.etree.ElementTree as ET

    with open(path, "rb") as f:
        data = f.read()

    # appended raw bytes are not valid XML: split them out before parsing
    appended = None
    mark = data.find(b"<AppendedData")
    if mark >= 0:
        enc_m = data.find(b"encoding=", mark)
        gt = data.find(b">", mark)
        start = data.find(b"_", gt) + 1
        end = data.rfind(b"</AppendedData>")
        payload = data[start:end]
        encoding = b"base64" if (0 <= enc_m < gt
                                 and b"base64" in data[enc_m:gt]) else b"raw"
        if encoding == b"base64":
            appended = ("b64", b"".join(payload.split()).decode("ascii"))
        else:
            appended = ("raw", bytes(payload))
        data = data[:start] + data[end:]

    root = ET.fromstring(data.decode("latin1"))
    if root.tag.split("}")[-1] != "VTKFile":
        raise ValueError(f"not a VTKFile: {root.tag}")
    if (root.get("type") or "") != "UnstructuredGrid":
        raise ValueError(f"not an UnstructuredGrid .vtu: {root.get('type')}")
    byte_order = "<" if (root.get("byte_order", "LittleEndian")
                         == "LittleEndian") else ">"
    header_dtype = byte_order + _VTU_DTYPES[
        (root.get("header_type") or "UInt32").lower()]
    compressed = root.get("compressor") is not None

    def find(el, tag):
        for child in el.iter():
            if child.tag.split("}")[-1] == tag:
                yield child

    points_list = []
    blocks: Dict[str, list] = {}
    n_prev = 0
    for piece in find(root, "Piece"):
        n_pts = int(piece.get("NumberOfPoints"))
        pts_el = next(iter(find(next(iter(find(piece, "Points"))),
                                "DataArray")))
        pts = _vtu_decode(pts_el, appended, byte_order, header_dtype,
                          compressed).astype(np.float64)
        points_list.append(pts.reshape(n_pts, 3))
        arrays = {}
        for da in find(next(iter(find(piece, "Cells"))), "DataArray"):
            arrays[da.get("Name")] = _vtu_decode(
                da, appended, byte_order, header_dtype, compressed
            ).astype(np.int64)
        conn, offs, types = (arrays["connectivity"], arrays["offsets"],
                             arrays["types"])
        begin = np.concatenate([[0], offs[:-1]])
        for ci, ct in enumerate(types):
            et = VTK_TO_ETYPE.get(int(ct))
            if et is None:
                continue
            blocks.setdefault(et, []).append(
                conn[begin[ci]:offs[ci]] + n_prev)
        n_prev += n_pts
    points = np.concatenate(points_list, axis=0)
    out = {et: np.stack(v).astype(np.int32) for et, v in blocks.items()}
    return points, out


def write_vtu(path: str, points, blocks: Dict[str, np.ndarray],
              point_data: Optional[Dict[str, np.ndarray]] = None,
              compress: bool = False) -> None:
    """Write a .vtu (appended raw encoding, little-endian, UInt64 headers,
    optional single-block zlib compression) with optional nodal data."""
    points, blocks, point_data = _host_args(points, blocks, point_data)
    points = np.ascontiguousarray(np.asarray(points, dtype=np.float64))
    n_pts = points.shape[0]
    conn_parts, offs_parts, type_parts = [], [], []
    base = 0
    ncells = 0
    for et, conn in blocks.items():
        conn = np.asarray(conn, dtype=np.int64)
        m, k = conn.shape
        conn_parts.append(conn.reshape(-1))
        offs_parts.append(base + np.arange(1, m + 1, dtype=np.int64) * k)
        base = int(offs_parts[-1][-1])
        type_parts.append(np.full(m, ETYPE_TO_VTK[et.lower()], np.uint8))
        ncells += m
    conn_all = (np.concatenate(conn_parts) if conn_parts
                else np.zeros(0, np.int64))
    offs_all = (np.concatenate(offs_parts) if offs_parts
                else np.zeros(0, np.int64))
    types_all = (np.concatenate(type_parts) if type_parts
                 else np.zeros(0, np.uint8))

    payload = bytearray()
    entries = []                   # (name inserted later via offsets)

    def append(arr) -> int:
        raw = np.ascontiguousarray(arr).tobytes()
        off = len(payload)
        if compress:
            comp = zlib.compress(raw)
            payload.extend(struct.pack("<QQQQ", 1, len(raw), len(raw),
                                       len(comp)))
            payload.extend(comp)
        else:
            payload.extend(struct.pack("<Q", len(raw)))
            payload.extend(raw)
        return off

    pts_off = append(points)
    conn_off = append(conn_all)
    offs_off = append(offs_all)
    types_off = append(types_all)
    pd_entries = []
    if point_data:
        for name, arr in point_data.items():
            arr = np.asarray(arr, dtype=np.float64)
            ncomp = 1 if arr.ndim == 1 else arr.shape[1]
            pd_entries.append((name, ncomp, append(arr)))

    with open(path, "wb") as f:
        comp_attr = (' compressor="vtkZLibDataCompressor"' if compress
                     else "")
        f.write((
            '<?xml version="1.0"?>\n'
            '<VTKFile type="UnstructuredGrid" version="1.0" '
            f'byte_order="LittleEndian" header_type="UInt64"{comp_attr}>\n'
            '  <UnstructuredGrid>\n'
            f'    <Piece NumberOfPoints="{n_pts}" NumberOfCells="{ncells}">\n'
            '      <Points>\n'
            '        <DataArray type="Float64" NumberOfComponents="3" '
            f'format="appended" offset="{pts_off}"/>\n'
            '      </Points>\n'
            '      <Cells>\n'
            '        <DataArray type="Int64" Name="connectivity" '
            f'format="appended" offset="{conn_off}"/>\n'
            '        <DataArray type="Int64" Name="offsets" '
            f'format="appended" offset="{offs_off}"/>\n'
            '        <DataArray type="UInt8" Name="types" '
            f'format="appended" offset="{types_off}"/>\n'
            '      </Cells>\n').encode())
        if pd_entries:
            f.write(b'      <PointData>\n')
            for name, ncomp, off in pd_entries:
                f.write((
                    f'        <DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="appended" '
                    f'offset="{off}"/>\n').encode())
            f.write(b'      </PointData>\n')
        f.write(b'    </Piece>\n  </UnstructuredGrid>\n'
                b'  <AppendedData encoding="raw">\n_')
        f.write(bytes(payload))
        f.write(b'\n  </AppendedData>\n</VTKFile>\n')


def load_mesh(path: str, element_type: Optional[str] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(points, conn) for one element type — vtk_loader_to_torch parity.

    Dispatches on extension: .vtu -> XML reader, anything else -> legacy."""
    reader = read_vtu if path.lower().endswith(".vtu") else read_vtk
    points, blocks = reader(path)
    if element_type is None:
        if len(blocks) != 1:
            raise ValueError(f"mesh has multiple cell types {list(blocks)}; "
                             "pass element_type")
        return points, next(iter(blocks.values()))
    et = element_type.lower()
    if et not in blocks:
        raise ValueError(f"no {et} cells in {path} (has {list(blocks)})")
    return points, blocks[et]


def write_vtk(path: str, points, blocks: Dict[str, np.ndarray],
              point_data: Optional[Dict[str, np.ndarray]] = None,
              title: str = "tpufem output") -> None:
    """Write an ASCII legacy .vtk unstructured grid with optional nodal data."""
    points, blocks, point_data = _host_args(points, blocks, point_data)
    points = np.asarray(points, dtype=np.float64)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(title + "\n")
        f.write("ASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {points.shape[0]} double\n")
        np.savetxt(f, points, fmt="%.17g")
        ncells = sum(np.asarray(c).shape[0] for c in blocks.values())
        total = sum(np.asarray(c).size + np.asarray(c).shape[0]
                    for c in blocks.values())
        f.write(f"CELLS {ncells} {total}\n")
        for et, conn in blocks.items():
            conn = np.asarray(conn)
            k = conn.shape[1]
            with_n = np.concatenate(
                [np.full((conn.shape[0], 1), k, conn.dtype), conn], axis=1)
            np.savetxt(f, with_n, fmt="%d")
        f.write(f"CELL_TYPES {ncells}\n")
        for et, conn in blocks.items():
            ct = ETYPE_TO_VTK[et.lower()]
            np.savetxt(f, np.full(np.asarray(conn).shape[0], ct, np.int64),
                       fmt="%d")
        if point_data:
            f.write(f"POINT_DATA {points.shape[0]}\n")
            for name, arr in point_data.items():
                arr = np.asarray(arr)
                if arr.ndim == 1:
                    f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    np.savetxt(f, arr, fmt="%.17g")
                else:
                    f.write(f"VECTORS {name} double\n")
                    np.savetxt(f, arr, fmt="%.17g")
