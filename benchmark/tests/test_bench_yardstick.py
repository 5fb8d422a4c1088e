"""The yardstick's arithmetic against hand-worked cases, and against the
program's own numbers where the program has them."""

import numpy as np
import pytest

from benchmark import readers, tracing
from benchmark import yardstick as ys
from benchmark.drivers import tet4_stencil


def test_b_apply_by_hand():
    # 2 x 1 x 1 cells, one lane, f64: g 72 x 2, vol 6 x 2, u and y 3 x 12 each, the span mask 2
    c = ys.b_apply(2, 1, 1, 1, "float64")
    assert c.nbytes == (144 + 12 + 72 + 2) * 8
    assert c.flops == {"float64": 170 * 12}
    assert c.bound_s() == pytest.approx(c.nbytes / 3.35e12)


def test_b_apply_dof100k_is_chip_smokes_bound():
    # PERF.md's kernel table: DOF100K B = 8, f64 167.5 MB, 50.0 us; f32 83.8 MB, 25.0 us
    assert ys.b_apply(64, 6, 80, 8, "float64").nbytes == pytest.approx(167.5e6, rel=1e-3)
    assert ys.b_apply(64, 6, 80, 8, "float64").bound_s() == pytest.approx(50.0e-6, rel=1e-3)
    assert ys.b_apply(64, 6, 80, 8, "float32").nbytes == pytest.approx(83.8e6, rel=1e-3)


def test_line_solve_and_vectors_by_hand():
    c = ys.line_solve(stations=3, D=2, lanes=2, dtype="float32")
    assert c.nbytes == 3 * 2 * (4 + 4) * 4
    assert c.flops == {"float32": 2 * 4 * 3 * 2}
    assert ys.vectors(10, 3, "float64").nbytes == 240


def test_cost_sums_and_mixed_dtypes():
    c = ys.Cost(0, {"float64": 34e12}) + 2 * ys.Cost(0, {"float32": 67e12})
    assert c.bound_s() == pytest.approx(3.0)
    assert (ys.Cost(3.35e12) + ys.Cost(0, {"float64": 1.0})).bound_s() == pytest.approx(1.0)


def test_busy_is_the_union():
    assert ys.busy_s([(0, 10), (5, 15), (20, 30), (21, 22)]) == pytest.approx(25e-9)
    assert ys.busy_s([]) == 0


def test_hierarchy_is_the_programs():
    from tpufem_torch.fem.stencil_mg import hierarchy_resolutions
    from tpufem_torch.mesher import DOF100K, DOF1M_TET10

    for res in (DOF100K, DOF1M_TET10):
        mesh = {"n_chord": res.n_chord, "n_span": res.n_span, "n_thick": res.n_thick}
        assert tet4_stencil.hierarchy(mesh) == [(r.n_chord, r.n_thick, r.n_span)
                                                for r in hierarchy_resolutions(res)]


def test_coarsest_inverse_is_the_programs():
    import torch

    from tpufem_torch.fem.stencil_mg import StencilMG
    from tpufem_torch.mesher import WingMeshResolution

    res = WingMeshResolution(16, 16, 4, te_floor_frac=0.006, spacing="le")
    smg = StencilMG(res, device="cpu")
    st = smg.setup(np.array([[1.2, 0.3, 10.0, 0.1]]), 5e10, 2.6e10)
    n = st[-1]["Kinv"].shape[-1]
    levels = tet4_stencil.hierarchy({"n_chord": 16, "n_span": 16, "n_thick": 4})
    c = tet4_stencil.vcycle_cost(levels[-1:], 1, False, "float32")
    assert c.nbytes == (n * n + 2 * n) * 4, (n, torch.float32)


def test_step_costs_by_parts():
    cfg = {"mesh": {"n_chord": 8, "n_span": 8, "n_thick": 2, "te_floor_frac": 0.006}}
    levels = tet4_stencil.hierarchy(cfg["mesh"])
    v = tet4_stencil.vcycle_cost(levels, 3, False, "float32")
    s4 = tet4_stencil.step_cost(cfg, 3)
    n = 3 * 9 * 3 * 9 * 3
    assert s4.nbytes == pytest.approx(v.nbytes + ys.b_apply(8, 2, 8, 3, "float64").nbytes
                                      + 10 * n * 8)


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_roofline_matches_launches_from_the_end():
    args = (None,) * 5 + (8, 65, 7, 81)
    bound = ys.b_apply(64, 6, 80, 8, "float64").bound_s()
    trace = {"launches": {"tpufem_strain_apply_f64": [args + (0,), args + (2,)],
                          "tpufem_strain_apply_f32": [args + (1,)]},
             "device": [(0, int(4 * bound * 1e9), "strain_apply_kernel<double>"),
                        (10**6, 10**6 + 5, "other")]}
    entries = {"tpufem_strain_apply_f64": "float64", "tpufem_strain_apply_f32": "float32"}
    # one activity, three launches: it is the last launch's (f64)
    r = readers.roofline(_Run(trace), entries, "strain_apply_kernel", readers.b_cost)
    assert r == pytest.approx(25.0, rel=1e-4)  # the duration is whole ns
    trace["launches"] = {}
    assert readers.roofline(_Run(trace), entries, "strain_apply_kernel", readers.b_cost) is None
    assert readers.roofline(_Run(None), entries, "strain_apply_kernel", readers.b_cost) is None


def test_idle_gaps_named_by_the_host():
    dev = [(100_000, 110_000, "k"), (200_000, 210_000, "k"), (210_005, 210_010, "k")]
    host = [(120_000, 190_000, "cudaMemcpyAsync"), (0, 300_000, "outer")]
    gaps = dict(tracing.idle_gaps(dev, host, 0, 300_000))
    assert gaps["cudaMemcpyAsync"] == pytest.approx(90e-6)
    assert gaps["outer"] == pytest.approx(100e-6 + 89.99e-6)
    assert gaps["launch gaps < 20 us"] == pytest.approx(5e-9)
