"""The span recorder inside WingStencilT.solve(outer_f64=True), on a small
CPU batch: the phase spans agree with last_timing, the lane counters equal
a count by hand from each CG's per-lane residuals and the rounds' TRUE
residuals, and the recorder changes no bit of the solve."""

import numpy as np
import pytest
import torch

from tpufem_torch.fem import stencil_mg
from tpufem_torch.fem.stencil_mg import WingStencilT
from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.utils import profiling

RES = WingMeshResolution(16, 16, 4, te_floor_frac=0.006, spacing="le")  # 3 V-cycle levels
# Three wings whose TRUE rel after the third round straddles TOL (3.7e-7, 7.5e-7,
# 6.4e-7): the fourth round's correction runs on all three lanes, one of them
# already certified.
P4 = np.array([[1.0409735, 0.44475606, 8.991357, 0.149721],
               [1.9127556, 0.21007568, 3.7284982, 0.11504593],
               [1.6369617, 0.3630875, 25.895369, 0.11153851]], np.float32)
TOL = 5e-7


def _solve(record: bool):
    solver = WingStencilT(RES, device="cpu")
    profiling.drain()
    profiling.recording(record)
    try:
        out = solver.solve(P4, tol=TOL, maxiter=2000, outer_f64=True)
    finally:
        profiling.recording(False)
    return solver, out, profiling.drain()


@pytest.fixture(scope="module")
def spied():
    """A solve with the recorder on, every CG's rr = dot(r, r) readings and
    every TRUE residual of the rounds kept on the side."""
    cgs, rels = [], []
    mp = pytest.MonkeyPatch()
    orig_run, orig_resid = stencil_mg._cg_grid_run, WingStencilT._resid64

    def run(A, M, dot, cg, tol, maxiter, lanes=stencil_mg._lanes, needs=None):
        rrs = []

        def dot_spy(u, v):
            d = dot(u, v)
            if u is v:  # the loop's rr, then the final rel's
                rrs.append(d.clone())
            return d

        out = orig_run(A, M, dot_spy, cg, tol, maxiter, lanes, needs)
        cgs.append({"rr": rrs[:-1], "tol2": (tol * cg[5]) ** 2, "iters": out[1]})
        return out

    def resid(self, state, x, lam64, mu64):
        r, rel = orig_resid(self, state, x, lam64, mu64)
        rels.append(rel.clone())
        return r, rel

    mp.setattr(stencil_mg, "_cg_grid_run", run)
    mp.setattr(WingStencilT, "_resid64", resid)
    try:
        solver, out, rec = _solve(True)
    finally:
        mp.undo()
    return {"solver": solver, "out": out, "rec": rec, "cgs": cgs, "rels": rels}


def test_spans_are_there_and_agree_with_last_timing(spied):
    spans, tm = spied["rec"]["spans"], spied["solver"].last_timing
    names = {n for n, *_ in spans}
    assert {"setup", "setup.coarsest_inverse", "cg", "cg.wait", "vcycle.L0", "vcycle.L1",
            "vcycle.L2", "recover"} <= names, sorted(names)
    assert "vcycle.L3" not in names
    for name, key in (("setup", "setup_s"), ("cg", "solve_s"), ("recover", "recover_s")):
        (s0, s1), = [(s0, s1) for n, s0, s1, _ in spans if n == name]
        assert abs((s1 - s0) * 1e-9 - tm[key]) < 1e-3, (name, (s1 - s0) * 1e-9, tm[key])
    depth = {n: d for n, _, _, d in spans}
    assert depth["setup"] == depth["cg"] == depth["recover"] == 0
    assert depth["setup.coarsest_inverse"] == 1 and depth["vcycle.L0"] == 1
    assert depth["cg.wait"] == 1
    # every V-cycle span nests its coarser levels' spans
    assert {d for n, _, _, d in spans if n == "vcycle.L2"} == {3}
    (c0, c1), = [(s0, s1) for n, s0, s1, _ in spans if n == "cg"]
    assert all(c0 <= s0 <= s1 <= c1 for n, s0, s1, _ in spans
               if n.startswith(("cg.", "vcycle.")))


def test_lane_counters_by_hand(spied):
    """cg.lane_steps: lanes x steps run; cg.lane_steps_useful: steps of lanes
    not converged in their CG and above tol at their round's start. The
    steps are replayed from each CG's rr readings by the loop's stopping
    rule (a look every _CHECK_EVERY steps); the k-th CG is the correction
    of the k-th round, whose start is the k-th TRUE residual."""
    cgs, rels, out = spied["cgs"], spied["rels"], spied["out"]
    assert len(rels) == len(cgs) + 1  # the last round's residual ends the solve
    lane_steps = useful = 0
    skipped_lanes = 0
    for cg, rel in zip(cgs, rels):
        needs = rel > TOL
        skipped_lanes += int((~needs).sum())
        count = torch.zeros(len(P4), dtype=torch.int64)
        steps = 0
        for k, rr in enumerate(cg["rr"]):
            if k % stencil_mg._CHECK_EVERY == 0 and not bool((rr > cg["tol2"]).any()):
                break
            steps += 1
            count += ~((rr <= cg["tol2"]) | ~torch.isfinite(rr))
        assert int(count.max()) == cg["iters"]
        lane_steps += steps * len(P4)
        useful += int((count * needs).sum())
    assert skipped_lanes > 0, "no round left a lane out: the case does not test `needs`"
    assert sum(cg["iters"] for cg in cgs) == out.iters
    assert spied["rec"]["counters"] == {"cg.lane_steps": lane_steps,
                                        "cg.lane_steps_useful": useful}
    assert 0 < useful < lane_steps


def test_recorder_changes_no_bit(spied):
    _, out, rec = _solve(False)
    assert rec == {"spans": [], "counters": {}}
    assert out.iters == spied["out"].iters
    assert torch.equal(out.u, spied["out"].u) and torch.equal(out.vm, spied["out"].vm)
    assert bool(out.converged.all())
