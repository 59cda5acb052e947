"""tpufem_torch's host I/O against tpufem's: the VTK writers give tpufem's
bytes on the same numpy inputs (legacy .vtk, .vtu raw and zlib) and from
torch tensors, each package reads the other's files to equal arrays, both
readers agree on the hand-built .vtu variants of tpufem's tests/test_io.py
(ascii, inline base64, compressed inline base64, VTK-style multiblock
compressed appended data, UInt8 headers); the h5 sample loader, the YAML
boundary loader, rbe2_mask, human_readable_number and the plotly viewers'
boundary triangles are held equal to tpufem's."""
import base64
import struct
import zlib

import numpy as np
import pytest
import torch

from tpufem.io import h5 as j_h5
from tpufem.io import vtk as j_vtk
from tpufem.utils import meshgen
from tpufem.utils.format import human_readable_number as j_hrn
from tpufem.viz import plot as j_plot

from tpufem_torch.io import h5 as t_h5
from tpufem_torch.io import vtk as t_vtk
from tpufem_torch.utils.format import human_readable_number as t_hrn
from tpufem_torch.viz import plot as t_plot


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs (it runs no torch work of
    size; under the suite's parallel workers the pool costs more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(nx=1, ny=2):
    coords, hexes = meshgen.box_hex(nx, ny, 1)
    _, quads = meshgen.grid_quad(ny, nx)
    return coords, {"c3d8": hexes, "s4": quads}


def _single(gen, etype):
    coords, conn = gen()
    return coords, {etype: conn}


# (name, writer, mesh, point data?, compress)
WRITES = [
    ("vtk_tet", "vtk", lambda: _single(lambda: meshgen.box_tet(2, 2, 2),
                                       "c3d4"), True, False),
    ("vtk_mixed", "vtk", lambda: _mixed(1, 1), False, False),
    ("vtk_tet10", "vtk", lambda: _single(lambda: meshgen.box_tet10(1, 1, 1),
                                         "c3d10"), False, False),
    ("vtu_mixed_raw", "vtu", _mixed, True, False),
    ("vtu_mixed_zlib", "vtu", _mixed, True, True),
    ("vtu_c3d4", "vtu", lambda: _single(lambda: meshgen.box_tet(2, 2, 2),
                                        "c3d4"), False, False),
    ("vtu_c3d10", "vtu", lambda: _single(lambda: meshgen.box_tet10(1, 1, 1),
                                         "c3d10"), False, True),
    ("vtu_c3d6", "vtu", lambda: _single(lambda: meshgen.box_wedge(1, 1, 1),
                                        "c3d6"), True, False),
]


def _point_data(coords):
    return {"z": coords[:, 2], "disp": coords * 0.1}


@pytest.mark.parametrize("name,kind,mesh,with_pd,compress", WRITES,
                         ids=[w[0] for w in WRITES])
def test_writers_bytes_and_cross_read(tmp_path, name, kind, mesh, with_pd,
                                      compress):
    """tpufem's write_vtk / write_vtu cases: the port writes tpufem's bytes
    from the same numpy arrays and from CPU tensors, and each package reads
    the other's file to the arrays written."""
    coords, blocks = mesh()
    pd = _point_data(coords) if with_pd else None
    ext = "." + kind
    pj, pt, pq = (tmp_path / f"j{ext}", tmp_path / f"t{ext}",
                  tmp_path / f"q{ext}")
    kw = {"compress": compress} if kind == "vtu" else {}
    getattr(j_vtk, f"write_{kind}")(str(pj), coords, blocks, point_data=pd,
                                     **kw)
    getattr(t_vtk, f"write_{kind}")(str(pt), coords, blocks, point_data=pd,
                                     **kw)
    as_t = {k: torch.as_tensor(np.asarray(v)) for k, v in (pd or {}).items()}
    getattr(t_vtk, f"write_{kind}")(
        str(pq), torch.as_tensor(coords),
        {et: torch.as_tensor(c) for et, c in blocks.items()},
        point_data=as_t or None, **kw)
    assert pj.read_bytes() == pt.read_bytes() == pq.read_bytes()
    for reader, path in ((getattr(t_vtk, f"read_{kind}"), pj),
                         (getattr(j_vtk, f"read_{kind}"), pt)):
        pts, got = reader(str(path))
        np.testing.assert_allclose(pts, coords, rtol=0, atol=0)
        assert set(got) == set(blocks)
        for et, conn in blocks.items():
            np.testing.assert_array_equal(got[et], conn)
    if len(blocks) > 1:
        for mod in (j_vtk, t_vtk):
            with pytest.raises(ValueError):
                mod.load_mesh(str(pt))         # ambiguous without a type
            with pytest.raises(ValueError):
                mod.load_mesh(str(pt), "c3d10")
    et = next(iter(blocks))
    for a, b in zip(j_vtk.load_mesh(str(pt), et), t_vtk.load_mesh(str(pj),
                                                                   et)):
        np.testing.assert_array_equal(a, b)


# -- hand-built .vtu files in the formats write_vtu does not emit ----------

def _ascii_vtu(coords, conn):
    n, m = coords.shape[0], conn.shape[0]
    offs = np.arange(1, m + 1) * 4
    return (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="UnstructuredGrid" byte_order="LittleEndian">\n'
        '<UnstructuredGrid>'
        f'<Piece NumberOfPoints="{n}" NumberOfCells="{m}">\n'
        '<Points><DataArray type="Float32" NumberOfComponents="3" '
        'format="ascii">\n'
        + " ".join(f"{v:.7g}" for v in coords.reshape(-1)) +
        '</DataArray></Points>\n'
        '<Cells><DataArray type="Int32" Name="connectivity" format="ascii">\n'
        + " ".join(str(v) for v in conn.reshape(-1)) +
        '</DataArray>\n'
        '<DataArray type="Int32" Name="offsets" format="ascii">\n'
        + " ".join(str(v) for v in offs) +
        '</DataArray>\n'
        '<DataArray type="UInt8" Name="types" format="ascii">\n'
        + " ".join("10" for _ in range(m)) +
        '</DataArray></Cells></Piece></UnstructuredGrid></VTKFile>\n'
    ).encode()


def _inline_vtu(coords, conn, enc, header, ftype=("Float64", "<f8"),
                itype=("Int64", "<i8"), compressor=False):
    n, m = coords.shape[0], conn.shape[0]
    offs = np.arange(1, m + 1) * 4
    comp = ' compressor="vtkZLibDataCompressor"' if compressor else ""
    return (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="UnstructuredGrid" byte_order="LittleEndian" '
        f'header_type="{header}"{comp}>\n'
        '<UnstructuredGrid>'
        f'<Piece NumberOfPoints="{n}" NumberOfCells="{m}">\n'
        f'<Points><DataArray type="{ftype[0]}" NumberOfComponents="3" '
        'format="binary">' + enc(coords.astype(ftype[1])) +
        '</DataArray></Points>\n'
        f'<Cells><DataArray type="{itype[0]}" Name="connectivity" '
        'format="binary">' + enc(conn.astype(itype[1])) + '</DataArray>\n'
        f'<DataArray type="{itype[0]}" Name="offsets" format="binary">'
        + enc(offs.astype(itype[1])) + '</DataArray>\n'
        '<DataArray type="UInt8" Name="types" format="binary">'
        + enc(np.full(m, 10, "u1")) + '</DataArray>'
        '</Cells></Piece></UnstructuredGrid></VTKFile>\n').encode()


def _b64_u32(arr):
    raw = np.ascontiguousarray(arr).tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def _b64z_u64(arr):
    raw = np.ascontiguousarray(arr).tobytes()
    comp = zlib.compress(raw)
    head = struct.pack("<QQQQ", 1, len(raw), len(raw), len(comp))
    return base64.b64encode(head).decode() + base64.b64encode(comp).decode()


def _b64_u8(arr):
    raw = np.ascontiguousarray(arr).tobytes()
    assert len(raw) < 256
    return base64.b64encode(bytes([len(raw)]) + raw).decode()


def _vtk_style_compressed_appended(coords, conn, header_dtype, blocksize,
                                   encode_b64):
    """vtkXMLUnstructuredGridWriter's layout: appended zlib data in
    `blocksize` blocks, each array base64'd separately when encoded
    (offsets in encoded space, header segment apart from the body)."""
    hd = np.dtype(header_dtype)
    hname = {"<u4": "UInt32", "<u8": "UInt64", "<i4": "Int32"}[hd.str]
    n, m = coords.shape[0], conn.shape[0]
    offs = np.arange(1, m + 1) * conn.shape[1]
    arrays = [coords.astype("<f8"), conn.astype("<i8"), offs.astype("<i8"),
              np.full(m, t_vtk.ETYPE_TO_VTK["c3d4"], "u1")]
    payload = "" if encode_b64 else b""
    offsets = []
    for arr in arrays:
        raw = np.ascontiguousarray(arr).tobytes()
        blocks = [raw[i:i + blocksize] for i in range(0, len(raw), blocksize)]
        comp = [zlib.compress(b) for b in blocks]
        head = np.array([len(blocks), blocksize, len(blocks[-1])]
                        + [len(c) for c in comp], hd).tobytes()
        offsets.append(len(payload))
        if encode_b64:
            payload += (base64.b64encode(head).decode()
                        + base64.b64encode(b"".join(comp)).decode())
        else:
            payload += head + b"".join(comp)
    enc = "base64" if encode_b64 else "raw"
    xml = (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        f'byte_order="LittleEndian" header_type="{hname}" '
        'compressor="vtkZLibDataCompressor">\n'
        '<UnstructuredGrid>'
        f'<Piece NumberOfPoints="{n}" NumberOfCells="{m}">\n'
        '<Points><DataArray type="Float64" NumberOfComponents="3" '
        f'format="appended" offset="{offsets[0]}"/></Points>\n'
        '<Cells>'
        '<DataArray type="Int64" Name="connectivity" format="appended" '
        f'offset="{offsets[1]}"/>\n'
        '<DataArray type="Int64" Name="offsets" format="appended" '
        f'offset="{offsets[2]}"/>\n'
        '<DataArray type="UInt8" Name="types" format="appended" '
        f'offset="{offsets[3]}"/>'
        '</Cells></Piece></UnstructuredGrid>\n'
        f'<AppendedData encoding="{enc}">_')
    tail = '</AppendedData>\n</VTKFile>\n'
    if encode_b64:
        return (xml + payload + tail).encode()
    return xml.encode() + payload + tail.encode()


def _tet1():
    return meshgen.box_tet(1, 1, 1)


HAND_BUILT = [
    ("ascii", lambda c, e: _ascii_vtu(c, e), _tet1, 1e-6),
    ("inline_b64_uint32", lambda c, e: _inline_vtu(c, e, _b64_u32, "UInt32"),
     _tet1, 0.0),
    ("inline_b64_compressed",
     lambda c, e: _inline_vtu(c, e, _b64z_u64, "UInt64", compressor=True),
     _tet1, 0.0),
    ("inline_b64_uint8",
     lambda c, e: _inline_vtu(c, e, _b64_u8, "UInt8", ("Float32", "<f4"),
                              ("Int32", "<i4")), _tet1, 1e-6),
] + [
    (f"multiblock_{h[1:]}_{'b64' if b else 'raw'}",
     lambda c, e, h=h, b=b: _vtk_style_compressed_appended(c, e, h, 8192, b),
     lambda: meshgen.box_tet(6, 6, 6), 0.0)
    for h in ("<u4", "<u8", "<i4") for b in (False, True)
]


@pytest.mark.parametrize("name,build,mesh,rtol", HAND_BUILT,
                         ids=[h[0] for h in HAND_BUILT])
def test_readers_agree_on_hand_built_vtu(tmp_path, name, build, mesh, rtol):
    """Both packages' read_vtu give the same arrays, the mesh's own, on the
    .vtu variants of tpufem's tests (the multiblock ones span more than one
    8 KB zlib block)."""
    coords, conn = mesh()
    p = tmp_path / f"{name}.vtu"
    p.write_bytes(build(coords, conn))
    pj, bj = j_vtk.read_vtu(str(p))
    pt, bt = t_vtk.read_vtu(str(p))
    np.testing.assert_array_equal(pj, pt)
    assert set(bj) == set(bt) == {"c3d4"}
    np.testing.assert_array_equal(bj["c3d4"], bt["c3d4"])
    np.testing.assert_allclose(pt, coords, rtol=rtol)
    np.testing.assert_array_equal(bt["c3d4"], conn)


def test_h5_sample_and_masks(tmp_path):
    """tpufem's h5 round trip, rbe2_mask and the YAML boundary file, through
    both packages."""
    import h5py

    p = tmp_path / "sample_0.h5"
    rng = np.random.default_rng(0)
    forces = rng.standard_normal((10, 6))
    rbe2 = np.array([1, 2, 3])
    outputs = rng.standard_normal((10, 1, 6))
    with h5py.File(p, "w") as f:
        f["forces"] = forces
        f["rbe2"] = rbe2
        f["outputs"] = outputs
    dj, dt = j_h5.load_simjeb_sample(str(p)), t_h5.load_simjeb_sample(str(p))
    assert set(dj) == set(dt) == {"forces", "rbe2", "outputs"}
    for k in dj:
        assert dj[k].dtype == dt[k].dtype
        np.testing.assert_array_equal(dj[k], dt[k])
    np.testing.assert_array_equal(dt["forces"], forces)
    m = t_h5.rbe2_mask(10, dt["rbe2"])
    np.testing.assert_array_equal(m, j_h5.rbe2_mask(10, dj["rbe2"]))
    assert m.dtype == np.int32 and m.sum() == 3 and m[1] == 1

    y = tmp_path / "boundary.yaml"
    y.write_text("rbe2:\n  - slaves: [4, 5, 6]\n  - slaves: [9]\n"
                 "rbe3:\n  - slaves: [0, 1]\n")
    bj, bt = j_h5.load_boundary_yaml(str(y)), t_h5.load_boundary_yaml(str(y))
    assert set(bj) == set(bt) == {"rbe2", "rbe3"}
    for k in bj:
        np.testing.assert_array_equal(bj[k], bt[k])
    np.testing.assert_array_equal(bt["rbe2"], [4, 5, 6, 9])


@pytest.mark.parametrize("num", [1234, 2.5e9, 3.2, -4.5e6, 0.0, 999.9,
                                 1e3, 7.25e12, 3e15, -2e18, 1e21])
def test_human_readable_number(num):
    assert t_hrn(num) == j_hrn(num)


@pytest.mark.parametrize("etype,gen", [
    ("c3d4", lambda: meshgen.box_tet(2, 1, 2)),
    ("c3d10", lambda: meshgen.box_tet10(1, 2, 1)),
    ("s3", lambda: meshgen.grid_tri(2, 3)),
    ("s4", lambda: meshgen.grid_quad(3, 2)),
])
def test_viz_boundary_triangles(etype, gen):
    """The surface triangles every plotly view draws, from arrays and from
    tensors, equal tpufem's."""
    coords, conn = gen()
    want = j_plot._boundary_triangles(coords, conn, etype)
    np.testing.assert_array_equal(
        t_plot._boundary_triangles(coords, conn, etype), want)
    np.testing.assert_array_equal(
        t_plot._boundary_triangles(torch.as_tensor(coords),
                                   torch.as_tensor(conn), etype), want)


def test_viz_gated_without_plotly():
    try:
        import plotly  # noqa: F401
        has_plotly = True
    except ImportError:
        has_plotly = False
    coords, conn = meshgen.box_tet(1, 1, 1)
    if not has_plotly:
        with pytest.raises(ImportError, match="plotly"):
            t_plot.visualize_mesh(coords, conn, "c3d4")
        with pytest.raises(ImportError, match="plotly"):
            t_plot.visualize_node_with_value(torch.as_tensor(coords),
                                             torch.ones(coords.shape[0]))
    else:
        assert t_plot.visualize_mesh(torch.as_tensor(coords), conn,
                                     "c3d4") is not None
