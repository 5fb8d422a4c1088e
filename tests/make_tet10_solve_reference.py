"""Write tpufem_torch/reference/tet10_stencil_6x4x2_solve.npz: tpufem's own
Tet10StencilT.solve on the CPU (outer_f64 and refine_steps=8, maxiter 2000)
of wings at 6x4x2 cells with a sharp trailing edge: wings 0 and 2 at tol
1e-10, and all three at tol 1e-6 (outer_f64) and 1e-10 (refine_steps), the
references of tests/test_torch_tet10_stencil.py's solve tests.

tpufem's solve costs minutes of JAX compilation on one core at any size,
more than a test may take; its result is kept instead. Run from the
repository root:

    PYTHONPATH=. python tests/make_tet10_solve_reference.py
"""

from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpufem.fem.tet10_stencil import Tet10StencilT  # noqa: E402
from tpufem.mesher import WingMeshResolution, structured_wing_mesh  # noqa: E402
from tpufem.sets import build_boundary_sets  # noqa: E402

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07], [1.5, 0.3, 5.0, 0.12]])
RES = WingMeshResolution(6, 4, 2, te_floor_frac=0.0, spacing="le")
# name: (wings, tol, solve options). The thin wing 1 stalls near a TRUE rel
# of 5e-7 under outer_f64 and does not converge under refine_steps, so its
# cases are solved at a tol its floor reaches and at the test's 1e-10.
CASES = {
    "outer": ([0, 2], 1e-10, {"outer_f64": True}),
    "refine": ([0, 2], 1e-10, {"refine_steps": 8}),
    "thin_outer": ([0, 1, 2], 1e-6, {"outer_f64": True}),
    "thin_refine": ([0, 1, 2], 1e-10, {"refine_steps": 8}),
}
OUT = Path(__file__).resolve().parents[1] / "tpufem_torch" / "reference" / (
    "tet10_stencil_6x4x2_solve.npz")


def main():
    bs = build_boundary_sets(structured_wing_mesh(*P4[0], RES))
    solver = Tet10StencilT(RES, dtype=jnp.float32)
    out = {"p4": P4}
    for name, (wings, tol, kw) in CASES.items():
        r = solver.solve(P4[wings], bs.surf_upper_faces, tol=tol, maxiter=2000, **kw)
        out.update({f"{name}_u": np.asarray(r.u), f"{name}_vm": np.asarray(r.vm),
                    f"{name}_rel": np.asarray(r.rel_residual),
                    f"{name}_iters": np.asarray(r.iters)})
        print(name, r.iters, np.asarray(r.rel_residual))
    np.savez_compressed(OUT, **out)


if __name__ == "__main__":
    main()
