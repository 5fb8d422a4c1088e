"""tpufem_torch.native (the port's own meshcore.cpp, built with g++ into
build/) against the port's numpy paths, mirroring tests/test_native.py with
the port's meshes; skipped where g++ is missing (decided in a fixture).

Also: parse_msh2 goes native (msh2_parse_native.calls moves) and returns
what the numpy parser returns; and on a host without g++ available() is
False, every entry point returns None, the build's error text is kept, and
parse_msh2 still parses through numpy.
"""

import numpy as np
import pytest

from tpufem_torch import msh2, native
from tpufem_torch.mesher import COARSE, boundary_faces, structured_wing_mesh


@pytest.fixture(scope="module")
def mesh():
    if not native.available():
        pytest.skip(f"native toolchain unavailable: {native.build_error}")
    return structured_wing_mesh(1.2, 0.35, 15.0, 0.10, COARSE)


def test_boundary_faces_match_numpy(mesh):
    ref = boundary_faces(mesh.tets.astype(np.int64))
    nat = native.boundary_faces_native(mesh.tets)
    assert nat is not None
    assert len(nat) == len(ref)
    # same oriented face set (order may differ)
    a = {tuple(np.roll(f, -np.argmin(f))) for f in ref}
    b = {tuple(np.roll(f, -np.argmin(f))) for f in nat}
    assert a == b


def test_unique_edges_match_numpy(mesh):
    from tpufem_torch.fem.tet10 import _EDGES

    tets = mesh.tets.astype(np.int64)
    edges = np.sort(tets[:, _EDGES].reshape(-1, 2), axis=1)
    ref = np.unique(edges, axis=0)
    nat = native.unique_edges_native(mesh.tets)
    assert nat is not None
    np.testing.assert_array_equal(np.asarray(nat, dtype=np.int64), ref)


def test_unique_tri_edges(mesh):
    f = mesh.surf_faces.astype(np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    ref = np.unique(np.sort(e, axis=1), axis=0)
    nat = native.unique_tri_edges_native(mesh.surf_faces)
    np.testing.assert_array_equal(np.asarray(nat, dtype=np.int64), ref)


def write_msh2(path, mesh):
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(mesh.num_nodes)]
    lines += [f"{i} {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}" for i, p in enumerate(mesh.nodes, 1)]
    lines += ["$EndNodes", "$Elements", str(mesh.num_tets)]
    lines += [f"{i} 4 2 0 1 {t[0]} {t[1]} {t[2]} {t[3]}" for i, t in enumerate(mesh.tets + 1, 1)]
    lines += ["$EndElements", ""]
    path.write_text("\n".join(lines))


def test_msh2_native_roundtrip(tmp_path, mesh):
    """Write an MSH2 file from the wing mesh, parse with native + python,
    compare."""
    p = tmp_path / "wing.msh"
    write_msh2(p, mesh)
    out = native.msh2_parse_native(p.read_text())
    assert out is not None
    node_ids, node_xyz, tris, tets = out
    assert len(node_ids) == mesh.num_nodes
    np.testing.assert_allclose(node_xyz, mesh.nodes, rtol=1e-6)
    np.testing.assert_array_equal(tets - 1, mesh.tets)

    m2 = msh2.parse_msh2(p)
    assert m2.num_nodes == mesh.num_nodes
    assert m2.num_tets == mesh.num_tets
    assert (m2.tet_volumes() > 0).all()


def test_parse_msh2_goes_native_and_equals_numpy(tmp_path, mesh, monkeypatch):
    p = tmp_path / "wing.msh"
    write_msh2(p, mesh)
    text = p.read_text()
    for ours, theirs in zip(native.msh2_parse_native(text),
                            msh2._parse_nodes(text) + msh2._parse_elements(text)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    calls = native.msh2_parse_native.calls
    m = msh2.parse_msh2(p)
    assert native.msh2_parse_native.calls == calls + 1
    monkeypatch.setattr(msh2, "msh2_parse_native", lambda text: None)
    m_numpy = msh2.parse_msh2(p)
    for k in ("nodes", "tets", "surf_faces"):
        a, b = getattr(m, k), getattr(m_numpy, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert m.meta == m_numpy.meta


def test_without_gxx_everything_falls_back(tmp_path, monkeypatch):
    """tpufem's contract for a host without g++, and the build's error kept."""
    monkeypatch.setattr(native, "_SO", tmp_path / "libmeshcore.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build_error", None)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    assert not native.available()
    assert "g++" in native.build_error
    src = structured_wing_mesh(1.2, 0.35, 15.0, 0.10, COARSE)
    assert native.boundary_faces_native(src.tets) is None
    assert native.unique_edges_native(src.tets) is None
    assert native.unique_tri_edges_native(src.surf_faces) is None
    p = tmp_path / "wing.msh"
    write_msh2(p, src)
    assert native.msh2_parse_native(p.read_text()) is None
    calls = native.msh2_parse_native.calls
    m = msh2.parse_msh2(p)
    assert native.msh2_parse_native.calls == calls
    assert m.num_tets == src.num_tets and (m.tet_volumes() > 0).all()
