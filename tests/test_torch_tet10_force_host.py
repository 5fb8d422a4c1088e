"""Kernels N (csrc/tet10_force.cu, the incidence-gather tet10 operator) and D
(csrc/tet4_force.cu, the tet4 one), which share the incidence walk of
csrc/incidence_walk.cuh, on the CPU, without nvcc: the CUDA sources compiled
with g++ against tests/cuda_emulation/cuda_runtime.h (each block's threads as
std::threads, the blocks in a shuffled order, shared memory NaN before each
block). Kernel N on the tet10 promotion of a 6x4x2 sharp-TE and an 8x6x2
floored wing, f64 and f32, masked and unmasked:

- within 1e-12 (f64) / 1e-5 (f32) of the largest entry of
  tet10_force_plain, the same bits on a second call;
- at the plan's own cut (SLOTS rows a block, one block here) and at odd cuts
  (a block of 37 and of 101 rows: a tet evaluated by up to 10 blocks);
- the plans' shared memory within a Hopper block's 232,448 bytes, and at
  the flagship's connectivity, which also holds the numbers PERF.md quotes
  (blocks, overlap).

Kernel D on the same two wings' tet4 meshes, f64 and f32, masked and
unmasked, at the plan's own cut and at 37 rows a block: within 1e-12 (f64)
of stiffness_apply_plain's largest entry, f32 no worse than 2x the plain f32
version against f64, the same bits twice, the Dirichlet rows x itself.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpufem_torch.fem import assembly as asm
from tpufem_torch.fem import tet10 as tt10
from tpufem_torch.fem.elements import tet4_setup
from tpufem_torch.fem.material import Material, lame_params
from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh
from tpufem_torch.sets import build_boundary_sets

CSRC = Path(tt10.__file__).resolve().parents[1] / "csrc"
STUB = Path(__file__).resolve().parent / "cuda_emulation"
HOPPER_SMEM = 232448  # a Hopper block's most shared memory
LAM, MU = lame_params(Material())
GRIDS = {"6x4x2 sharp TE": WingMeshResolution(6, 4, 2, 0.0, "le"),
         "8x6x2 floored": WingMeshResolution(8, 6, 2, 0.006, "le")}
DTYPES = {"f64": (torch.float64, 1e-12), "f32": (torch.float32, 1e-5)}
CUTS = (None, 37, 101)  # the plan's own SLOTS, and odd block cuts


SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem_raw[];"


def emulate(out: Path, source: str, entry: str):
    """csrc/`source` compiled with g++ against the emulation header, as a
    ctypes library whose f32/f64 `entry` points take the kernels' C
    signature: the kernel launch rewritten into emu_launch, the dynamic
    shared array (in the walk's header) into emu_smem."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    for h in CSRC.glob("*.cuh"):
        (out / h.name).write_text(h.read_text().replace(SMEM_DECL,
                                                        "unsigned char* smem_raw = emu_smem;"))
    assert SMEM_DECL in (CSRC / "incidence_walk.cuh").read_text()
    s = (CSRC / source).read_text()
    assert SMEM_DECL not in s  # the walk holds it
    s, n = re.subn(r"(\w+<\w+>)<<<(.*?), (\w+), .*?>>>\((.*?)\);",
                   r"emu_launch(\2, \3, [&]() { \1(\4); });", s, flags=re.S)
    assert n == 1
    cpp = out / (Path(source).stem + ".cpp")
    cpp.write_text(s)
    lib = out / f"lib{cpp.stem}.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread", "-I", str(STUB),
                    "-I", str(out), "-o", str(lib), str(cpp)], check=True)
    lib = ctypes.CDLL(str(lib))
    for d in ("f32", "f64"):
        fn = getattr(lib, f"{entry}_{d}")
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                                 ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Kernel N's source under the emulation, as a ctypes library."""
    return emulate(tmp_path_factory.mktemp("cuda_emulation"), "tet10_force.cu",
                   "tpufem_tet10_force")


@pytest.fixture(scope="module")
def emulated_d(tmp_path_factory):
    """Kernel D's source under the emulation, as a ctypes library."""
    return emulate(tmp_path_factory.mktemp("cuda_emulation_d"), "tet4_force.cu",
                   "tpufem_stiffness_apply")


@pytest.fixture(scope="module")
def meshes():
    """{grid: (Jinv64, vols64, conn int32, x64, free64)} of a seeded field."""
    torch.set_num_threads(1)
    out = {}
    for i, (name, res) in enumerate(GRIDS.items()):
        mesh = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, res)
        t10 = tt10.tet10_from_tet4(mesh)
        conn = torch.as_tensor(t10.tet10, dtype=torch.int32)
        Jinv, vols = tt10.tet10_setup(torch.as_tensor(t10.nodes10(mesh.nodes)), conn)
        rng = np.random.default_rng(i)
        x = torch.as_tensor(rng.normal(size=(t10.num_nodes, 3)) * 1e-3)
        free = torch.ones((t10.num_nodes, 3), dtype=torch.float64)
        free[tt10.tet10_root_nodes(t10)] = 0.0
        out[name] = (Jinv, vols, conn, x, free)
    return out


def emulated_force(lib, Jinv, vols, conn, x, free, plan, entry="tpufem_tet10_force"):
    """y of one emulated launch of `entry` (kernel N's, or D's with the
    gradients in Jinv's place)."""
    y = torch.full_like(x, float("nan"))
    fn = getattr(lib, f"{entry}_" + ("f64" if x.dtype == torch.float64 else "f32"))
    assert fn(Jinv.data_ptr(), vols.data_ptr(), conn.data_ptr(), plan.pos.data_ptr(),
              plan.btet.data_ptr(), plan.bt_start.data_ptr(), plan.bnode.data_ptr(),
              plan.starts.data_ptr(), x.data_ptr(), None if free is None else free.data_ptr(),
              y.data_ptr(), plan.bnode.shape[0] - 1, plan.slots, LAM, MU, None) == 0
    return y


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_kernel_emulated_matches_plain(emulated, meshes, grid, dtype, masked, cut):
    Jinv, vols, conn, x, free = meshes[grid]
    dt, tol = DTYPES[dtype]
    plan = asm.build_incidence(conn, x.shape[0], slots=cut)
    assert plan.slots * 3 * 8 <= HOPPER_SMEM and (cut is None or plan.bnode.numel() > 5)
    ref64 = tt10.tet10_force_plain(Jinv, vols, conn, x, LAM, MU, plan, free if masked else None)
    J, v, xx = Jinv.to(dt), vols.to(dt), x.to(dt)
    fr = free.to(dt) if masked else None
    y = emulated_force(emulated, J, v, conn, xx, fr, plan)
    ref = tt10.tet10_force_plain(J, v, conn, xx, LAM, MU, plan, fr)
    scale = ref64.abs().max().item()
    assert (y - ref).abs().max().item() <= tol * scale
    if dtype == "f32":  # no worse than 2x the plain f32 version, both against f64
        assert (y.double() - ref64).abs().max() <= 2 * (ref.double() - ref64).abs().max() + \
            1e-7 * scale
    assert torch.equal(y, emulated_force(emulated, J, v, conn, xx, fr, plan))
    if masked:  # the Dirichlet identity rows
        root = free[:, 0] == 0
        assert torch.equal(y[root], xx[root])


def test_flagship_plan_fits_and_overlap():
    """At the flagship's connectivity (96x128x8, 586,752 tets, 837,049
    nodes) every block's forces fit its shared memory in f64, and each tet is
    evaluated by a handful of blocks (the midside nodes, numbered after all
    corners, put a tet's nodes in several node ranges)."""
    from tpufem_torch.mesher import DOF1M_TET10

    t10 = tt10.tet10_from_tet4(structured_wing_mesh(1.6, 0.4, 20.0, 0.10, DOF1M_TET10))
    plan = asm.build_incidence(t10.tet10, t10.num_nodes)
    T = len(t10.tet10)
    assert (T, t10.num_nodes) == (586752, 837049)
    assert plan.slots * 3 * 8 <= 48 * 1024 <= HOPPER_SMEM
    starts = plan.starts_host
    bnode = plan.bnode.numpy()
    assert (starts[bnode[1:]] - starts[bnode[:-1]] <= plan.slots).all()
    assert 2.0 <= plan.overlap <= 10.0


@pytest.fixture(scope="module")
def meshes4():
    """{grid: (grads64, vols64, tets int32, x64, free64)} of the tet4 meshes."""
    out = {}
    for i, (name, res) in enumerate(GRIDS.items()):
        mesh = structured_wing_mesh(1.2, 0.35, 10.0, 0.10, res)
        tets = torch.as_tensor(mesh.tets.astype(np.int32))
        grads, vols = tet4_setup(torch.as_tensor(mesh.nodes, dtype=torch.float64), tets)
        rng = np.random.default_rng(10 + i)
        x = torch.as_tensor(rng.normal(size=(mesh.num_nodes, 3)) * 1e-3)
        free = torch.ones((mesh.num_nodes, 3), dtype=torch.float64)
        free[torch.as_tensor(build_boundary_sets(mesh).nroot_nodes)] = 0.0
        out[name] = (grads, vols, tets, x, free)
    return out


@pytest.mark.parametrize("cut", CUTS[:2])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_kernel_D_emulated_matches_plain(emulated_d, meshes4, grid, dtype, masked, cut):
    """Kernel D on the shared walk: the tet4 stiffness apply against its
    plain version, twice with the same bits."""
    g64, v64, tets, x64, free64 = meshes4[grid]
    dt = DTYPES[dtype][0]
    plan = asm.build_incidence(tets, x64.shape[0], slots=cut)
    assert cut is None or plan.bnode.numel() > 5
    ref64 = asm.stiffness_apply_plain(g64, v64, tets, x64, LAM, MU, plan,
                                      free64 if masked else None)
    g, v, x = g64.to(dt), v64.to(dt), x64.to(dt)
    fr = free64.to(dt) if masked else None
    y = emulated_force(emulated_d, g, v, tets, x, fr, plan, "tpufem_stiffness_apply")
    err = (y.double() - ref64).abs().max().item()
    if dt == torch.float64:
        assert err <= 1e-12 * ref64.abs().max().item()
    else:
        ref = asm.stiffness_apply_plain(g, v, tets, x, LAM, MU, plan, fr)
        assert err <= 2 * (ref.double() - ref64).abs().max().item()
    assert torch.equal(y, emulated_force(emulated_d, g, v, tets, x, fr, plan,
                                         "tpufem_stiffness_apply"))
    if masked:
        root = free64[:, 0] == 0
        assert root.any() and torch.equal(y[root], x[root])
