"""The plain reference accepts the port's certified solve and refuses the
lower-precision control, at a size a CPU test holds: a 16x16x4 tet4 mesh.
Its mesh, sets and numbering are the program's."""

import copy

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import tet4, wing
from benchmark.traffic import Traffic

CELL = harness.read_json(harness.ROOT / "BENCHMARK.json")["workloads"][0]["name"]
SMALL4 = {"n_chord": 16, "n_span": 16, "n_thick": 4, "te_floor_frac": 0.006, "spacing": "le"}


def small_cell(name, mesh, batch):
    c = copy.deepcopy(harness.load_cell(name))
    c["config"]["mesh"] = dict(mesh)
    c["traffic"]["batch"] = batch
    return c


@pytest.mark.parametrize("mesh", [SMALL4, harness.load_cell(CELL)["config"]["mesh"]],
                         ids=["16x16x4", "cell"])
def test_mesh_and_sets_are_the_programs(mesh):
    from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh, wing_topology
    from tpufem_torch.sets import build_boundary_sets

    res = WingMeshResolution(**mesh)
    topo, ptopo = wing.topology(mesh), wing_topology(res)
    assert np.array_equal(topo["tets"], ptopo.tets)
    assert np.array_equal(topo["basis"], ptopo.node_basis)
    ref_mesh = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, res)
    sets = build_boundary_sets(ref_mesh)
    key = lambda f: {tuple(sorted(t)) for t in f.tolist()}  # noqa: E731
    assert key(topo["faces"]) == key(ref_mesh.surf_faces)
    assert key(wing.upper_faces(topo, [1.2, 0.35, 10.0, 0.10])) == key(
        ref_mesh.surf_faces[sets.surf_upper_faces])
    assert np.array_equal(wing.root_nodes(topo), np.sort(sets.nroot_nodes))


def _readings(c, seed):
    drv = harness.load_module("drivers", c["config"]["driver"]).Driver(c["config"], "cpu")
    ref64 = tet4.Reference(c["config"], "cpu")
    ref32 = tet4.Reference(c["config"], "cpu", torch.float32)
    p4 = Traffic(c["traffic"], c["config"], seed).batch(0)
    out = drv.solve(p4)
    ctrl = drv.solve_control(p4)
    lim = c["config"]["limits"]
    return {"program": ref64.judge(p4, out["u"], out["vm"]),
            "rounded": ref64.judge(p4, torch.as_tensor(out["u"]).float(), out["vm"]),
            "control": ref64.judge(p4, ctrl["u"], ref32.vm(p4, ctrl["u"])),
            "limits": lim}


def test_tet4_accepts_the_certified_solve_and_refuses_the_control():
    r = _readings(small_cell(CELL, SMALL4, 2), 11)
    lim = r["limits"]
    assert (r["program"]["rel"] <= lim["true_rel"]).all()
    assert (r["program"]["vm_gap"] <= lim["vm_gap"]).all()
    assert (r["rounded"]["rel"] > lim["true_rel"]).all()  # the certified u rounded to float32
    assert (r["control"]["rel"] > lim["true_rel"]).all()  # outer_f64=False
    assert (r["control"]["vm_gap"] > lim["vm_gap"]).any()

