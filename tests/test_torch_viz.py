"""The port's GLB writers, colormaps, STL reader and MSH2 parser against
tpufem's, on the same numpy inputs: every file byte-identical, every array
equal."""

import numpy as np
import pytest

from tpufem.geometry import generate_wing_surface as jgenerate_wing_surface
from tpufem.mesher import COARSE as JCOARSE
from tpufem.mesher import structured_wing_mesh as jstructured_wing_mesh
from tpufem.msh2 import _parse_elements as j_parse_elements
from tpufem.msh2 import _parse_nodes as j_parse_nodes
from tpufem.msh2 import parse_msh2 as jparse_msh2
from tpufem.pipeline.mesh_stage import _write_surf_sets_glb as j_write_surf_sets_glb
from tpufem.sets import build_boundary_sets as jbuild_boundary_sets
from tpufem.utils.stl import read_stl as jread_stl
from tpufem.viz.arrows import make_pressure_arrows as jmake_pressure_arrows
from tpufem.viz.colormaps import hot as jhot
from tpufem.viz.colormaps import normalize_range as jnormalize_range
from tpufem.viz.colormaps import viridis as jviridis
from tpufem.viz.glb import GLBMesh as JGLBMesh
from tpufem.viz.results import stl_to_glb as jstl_to_glb
from tpufem.viz.results import surface_results_to_glb as jsurface_results_to_glb
from tpufem.viz.results import (
    surface_results_to_glb_with_extras as jsurface_results_to_glb_with_extras,
)
from tpufem_torch.fem.driver import FemSolution, surface_results
from tpufem_torch.mesher import COARSE, structured_wing_mesh
from tpufem_torch.msh2 import parse_msh2
from tpufem_torch.pipeline.mesh_stage import _write_surf_sets_glb
from tpufem_torch.sets import build_boundary_sets
from tpufem_torch.utils.stl import read_stl, write_stl
from tpufem_torch.viz.arrows import make_pressure_arrows
from tpufem_torch.viz.colormaps import hot, normalize_range, viridis
from tpufem_torch.viz.glb import GLBMesh, is_binary_glb, read_glb, write_glb
from tpufem_torch.viz.results import (
    color_range_from_masked,
    stl_to_glb,
    surface_results_to_glb,
    surface_results_to_glb_with_extras,
)


@pytest.fixture(scope="module")
def case():
    """A COARSE wing with a seeded stress/displacement field on its surface."""
    m = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, COARSE)
    bs = build_boundary_sets(m)
    rng = np.random.default_rng(0)
    sol = FemSolution(u=rng.normal(size=(m.num_nodes, 3)) * 1e-4, stress6=None,
                      vm=rng.uniform(1e5, 5e7, m.num_nodes), iters=0, rel_residual=0.0,
                      converged=True)
    return m, bs, surface_results(m, bs, sol, span_m=1.2)


def _same_file(tmp_path, name, ours, theirs):
    a, b = tmp_path / f"port_{name}", tmp_path / f"tpufem_{name}"
    ours(a)
    theirs(b)
    assert a.read_bytes() == b.read_bytes(), name
    return a


def test_result_and_arrow_glbs_byte_identical(case, tmp_path):
    m, bs, surf = case
    faces = m.surf_faces[bs.surf_all_faces]
    upper = m.surf_faces[bs.surf_upper_faces]
    _same_file(tmp_path, "result.glb", lambda p: surface_results_to_glb(p, surf, faces),
               lambda p: jsurface_results_to_glb(p, surf, faces))
    av, af = make_pressure_arrows(m.nodes, upper, "001")
    jav, jaf = jmake_pressure_arrows(m.nodes, upper, "001")
    np.testing.assert_array_equal(av, jav)
    np.testing.assert_array_equal(af, jaf)
    col = np.tile(np.array([0.9, 0.45, 0.1, 1.0]), (len(av), 1))
    path = _same_file(
        tmp_path, "arrows.glb",
        lambda p: surface_results_to_glb_with_extras(
            p, surf, faces, [GLBMesh(av, af, col, name="pressure_arrows")], vmin=0.0, vmax=3e7),
        lambda p: jsurface_results_to_glb_with_extras(
            p, surf, faces, [JGLBMesh(jav, jaf, col, name="pressure_arrows")], vmin=0.0,
            vmax=3e7),
    )
    g = read_glb(path)["json"]
    assert [n["name"] for n in g["nodes"]] == ["result", "pressure_arrows"]
    # the error map of inference: hot colormap, fixed range
    err = np.abs(surf["stress_vm"] - 1e7).astype(np.float32)
    _same_file(tmp_path, "error.glb",
               lambda p: surface_results_to_glb(p, surf, faces, values=err, vmin=0.0,
                                                vmax=float(err.max()), colormap=hot),
               lambda p: jsurface_results_to_glb(p, surf, faces, values=err, vmin=0.0,
                                                 vmax=float(err.max()), colormap=jhot))


def test_surf_sets_and_wing_viz_glbs_byte_identical(tmp_path):
    m = structured_wing_mesh(1.5, 0.30, 20.0, 0.08, COARSE)
    jm = jstructured_wing_mesh(1.5, 0.30, 20.0, 0.08, JCOARSE)
    _same_file(tmp_path, "surf_sets.glb",
               lambda p: _write_surf_sets_glb(p, m, build_boundary_sets(m)),
               lambda p: j_write_surf_sets_glb(p, jm, jbuild_boundary_sets(jm)))
    s = jgenerate_wing_surface(1.2, 0.35, 10.0, 0.1, n_chord=16, n_span=4)
    stl = tmp_path / "wing.stl"
    write_stl(stl, s.vertices, s.faces)
    _same_file(tmp_path, "wing_viz.glb", lambda p: stl_to_glb(stl, p),
               lambda p: jstl_to_glb(stl, p))


def test_colormaps_match_tpufem():
    t = np.linspace(-0.2, 1.2, 301)
    np.testing.assert_array_equal(viridis(t), jviridis(t))
    np.testing.assert_array_equal(hot(t), jhot(t))
    v = np.random.default_rng(1).normal(size=50)
    np.testing.assert_array_equal(normalize_range(v, -1.0, 0.5), jnormalize_range(v, -1.0, 0.5))
    assert color_range_from_masked(v, v > 0) == (v[v > 0].min(), np.percentile(v[v > 0], 98))


def test_read_stl_matches_tpufem(tmp_path):
    s = jgenerate_wing_surface(1.2, 0.35, 10.0, 0.1, n_chord=16, n_span=4)
    binary = tmp_path / "wing.stl"
    write_stl(binary, s.vertices, s.faces)
    ascii_ = tmp_path / "tri.stl"
    ascii_.write_text("solid t\n facet normal 0 0 1\n  outer loop\n   vertex 0 0 0\n"
                      "   vertex 1 0 0\n   vertex 0 1 0\n  endloop\n endfacet\nendsolid t\n")
    for path in (binary, ascii_):
        v, f = read_stl(path)
        jv, jf = jread_stl(path)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
    v, f = read_stl(binary)
    assert len(f) == s.num_faces and len(v) == s.num_vertices
    bad = tmp_path / "bad.stl"
    bad.write_bytes(binary.read_bytes()[:200])
    with pytest.raises(ValueError, match="truncated"):
        read_stl(bad)


def test_glb_roundtrip(tmp_path):
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=np.float64)
    f = np.array([[0, 1, 2], [0, 2, 3]])
    p = tmp_path / "sq.glb"
    write_glb(p, [GLBMesh(v, f, np.eye(4), name="a"), GLBMesh(v + 2.0, f, name="b")])
    assert is_binary_glb(p) and not is_binary_glb(tmp_path / "missing.glb")
    out = read_glb(p)
    g = out["json"]
    assert out["version"] == 2 and g["scenes"][0]["nodes"] == [0, 1]
    acc = g["accessors"][g["meshes"][0]["primitives"][0]["attributes"]["POSITION"]]
    view = g["bufferViews"][acc["bufferView"]]
    pos = np.frombuffer(out["bin"][view["byteOffset"]:view["byteOffset"] + view["byteLength"]],
                        dtype=np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(pos, v)
    assert all(bv["byteOffset"] % 4 == 0 for bv in g["bufferViews"])
    (tmp_path / "x.glb").write_bytes(b"nope")
    with pytest.raises(ValueError):
        read_glb(tmp_path / "x.glb")


def _write_msh2(path, mesh, tris=0):
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(mesh.num_nodes)]
    for i, p in enumerate(mesh.nodes, 1):
        lines.append(f"{i} {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}")
    lines += ["$EndNodes", "$Elements", str(mesh.num_tets + tris)]
    for i, f in enumerate(mesh.surf_faces[:tris] + 1, 1):
        lines.append(f"{i} 2 2 0 1 {f[0]} {f[1]} {f[2]}")
    for i, t in enumerate(mesh.tets + 1, tris + 1):
        # odd tets flipped: the parser restores the positive orientation
        a, b, c, d = (t[0], t[1], t[3], t[2]) if i % 2 else t
        lines.append(f"{i} 4 2 0 1 {a} {b} {c} {d}")
    lines += ["$EndElements", ""]
    path.write_text("\n".join(lines))


def test_parse_msh2_matches_tpufem(tmp_path):
    src = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, COARSE)
    path = tmp_path / "wing.msh"
    _write_msh2(path, src, tris=7)
    m, jm = parse_msh2(path), jparse_msh2(path)
    for k in ("nodes", "tets", "surf_faces"):
        a, b = getattr(m, k), getattr(jm, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert m.meta == jm.meta and m.meta["n_file_tris"] == 7
    assert (m.tet_volumes() > 0).all() and m.num_tets == src.num_tets
    text = path.read_text()
    from tpufem_torch.msh2 import _parse_elements, _parse_nodes

    for ours, theirs in zip(_parse_nodes(text) + _parse_elements(text),
                            j_parse_nodes(text) + j_parse_elements(text)):
        np.testing.assert_array_equal(ours, theirs)
    (tmp_path / "bad.msh").write_text("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="Nodes"):
        parse_msh2(tmp_path / "bad.msh")
