"""A whole run of the cell, the harness's look for a chip skipped, on the CPU
at an 8x8x2 mesh: `correct` is true on the program as it is, and false with
the timed path broken underneath by each fault this cell can have (it runs
on one chip: there is no exchange to leave out), and false with the control
in the program's place."""

import time

import pytest
import torch

from benchmark import control, harness
from benchmark.reference import tet4
from benchmark.tests.test_bench_reference import CELL, SMALL4, small_cell

MESH = {"n_chord": 8, "n_span": 8, "n_thick": 2, "te_floor_frac": 0.006, "spacing": "le"}


class Broken:
    """The driver, its output altered by `fault` where it is produced."""

    def __init__(self, driver, fault):
        self.driver, self.fault = driver, fault

    def warm_up(self, p4):
        self.driver.warm_up(p4)

    def solve(self, p4):
        out = dict(self.driver.solve(p4))
        u, vm = out["u"].clone(), out["vm"].clone()
        if self.fault == "state unchanged":  # the solve hands back its start, x = 0
            u.zero_()
            vm.zero_()
        elif self.fault == "half the batch left out":
            half = u.shape[-1] // 2
            u[..., half:] = 0.0
            vm[..., half:] = 0.0
        elif self.fault == "displacement altered":
            u[..., 0] *= 1.0 + 1e-4
        elif self.fault == "stress altered":
            vm[..., 0] *= 1.0 + 1e-2
        out["u"], out["vm"] = u, vm
        return out


class Control:
    """The control (control.control_solve) in the program's place."""

    def __init__(self, driver, cfg):
        self.driver, self.ref32 = driver, tet4.Reference(cfg, "cpu", torch.float32)

    def warm_up(self, p4):
        self.driver.warm_up(p4)

    def solve(self, p4):
        return control.control_solve(self.driver, self.ref32, p4)


def run(fault=None, mesh=MESH, batch=4):
    c = small_cell(CELL, mesh, batch)
    if fault == "control":
        wrap = lambda d: Control(d, c["config"])  # noqa: E731
    else:
        wrap = None if fault is None else (lambda d: Broken(d, fault))
    out = harness.run_cell(c, 2**31 + 5, 0.0, False, "cpu", time.perf_counter(),
                           wrap_driver=wrap, say=lambda *a, **k: None)
    return out["line"]


def test_sound_run_is_correct():
    line = run()
    assert line["correct"] and line["failed"] == 0 and line["attempted"] == 4
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"tet4_wings_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch left out",
                                   "displacement altered", "stress altered"])
def test_fault_is_caught(fault):
    line = run(fault)
    assert not line["correct"] and line["failed"] >= 1


@pytest.mark.parametrize("mesh", [MESH, SMALL4], ids=["8x8x2", "16x16x4"])
def test_control_is_not_correct(mesh):
    line = run("control", mesh, 2)
    ck = line["checks"]["true_rel_max"]
    assert not line["correct"] and ck["value"] > ck["limit"], line["checks"]


@pytest.mark.gpu
def test_certified_solve_on_the_card_at_cell_size():
    """The cell's own batch size and mesh on the card: every wing certified."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.load_cell(CELL)
    out = harness.run_cell(c, 7, 0.0, False, "cuda", time.perf_counter(),
                           say=lambda *a, **k: None)
    assert out["line"]["correct"], out["line"]["checks"]
