"""Where Tet10StencilT's correction rounds stop on the 6x4x2 sharp-TE test
wings, in tpufem and in the port, on the CPU.

For each package, each of outer_f64 and refine_steps=8, and tol 1e-8 and
1e-10, the three wings of tests/test_torch_tet10_stencil.py are solved at
B = 3 with progress on (each round's TRUE f64 residual is printed), then
every wing's u is judged twice: by the f64 residual and by the 80-bit one
(tpufem_torch.fem.xprec) of the same system. Run from the repository root
(a few minutes, most of them JAX compilation):

    PYTHONPATH=. python tests/probe_tet10_thin_wing.py
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import tpufem.fem.tet10_stencil as jts  # noqa: E402
import tpufem_torch.fem.tet10_stencil as tts  # noqa: E402
from tpufem_torch.fem.material import Material, lame_params  # noqa: E402
from tpufem_torch.fem.tet10 import (  # noqa: E402
    pressure_loads_t6,
    tet10_force,
    tet10_root_nodes,
    tet10_setup,
    tet10_upper_t6,
)
from tpufem_torch.fem.xprec import tet10_residual_xprec  # noqa: E402
from tpufem_torch.mesher import WingMeshResolution, structured_wing_mesh  # noqa: E402
from tpufem_torch.sets import build_boundary_sets  # noqa: E402

P4 = np.array([[1.2, 0.35, 10.0, 0.10], [1.8, 0.25, 25.0, 0.07], [1.5, 0.3, 5.0, 0.12]])
GRID = (6, 4, 2, 0.0, "le")
MODES = {"outer_f64": {"outer_f64": True}, "refine_steps=8": {"refine_steps": 8}}


def residuals(tb, ut6, free, u):
    """(f64 rel, 80-bit rel) of each wing's u (N10,3,B) on its own system."""
    lam, mu = lame_params(Material())
    conn = torch.as_tensor(tb.t10.tet10, dtype=torch.long)
    out = []
    for b in range(P4.shape[0]):
        X = tts.nodes_grid2(tb.res, torch.tensor(P4[b:b + 1]), torch.float64)
        n10 = tts.from_grid2(tb.res, X)[:, :, 0]
        Jinv, vols = tet10_setup(n10, conn)
        b64 = pressure_loads_t6(n10, ut6, 5e3, tb.N10).numpy() * free
        x = u[:, :, b] * free
        r = b64 - tet10_force(Jinv, vols, conn, torch.tensor(x), lam, mu, tb.N10).numpy() * free
        rel80, _ = tet10_residual_xprec(Jinv.numpy(), vols.numpy(), tb.t10.tet10, b64, x, free,
                                        lam, mu)
        out.append((float(np.linalg.norm(r) / np.linalg.norm(b64)), rel80))
    return out


def main():
    torch.set_num_threads(2)
    mesh = structured_wing_mesh(*P4[0], WingMeshResolution(*GRID))
    bs = build_boundary_sets(mesh)
    tb = tts.Tet10StencilT(WingMeshResolution(*GRID), device="cpu")
    ja = jts.Tet10StencilT(jts.WingMeshResolution(*GRID), dtype=jnp.float32)
    ut6 = tet10_upper_t6(tb.t10, bs.surf_upper_faces)
    free = np.ones((tb.N10, 3))
    free[tet10_root_nodes(tb.t10)] = 0.0
    for tol in (1e-8, 1e-10):
        for mode, kw in MODES.items():
            for name, solver in (("tpufem", ja), ("port", tb)):
                print(f"--- {name}, {mode}, tol {tol:g}", flush=True)
                r = solver.solve(P4, bs.surf_upper_faces, tol=tol, maxiter=2000, progress=True,
                                 **kw)
                rel = np.asarray(r.rel_residual)
                judged = residuals(tb, ut6, free, np.asarray(r.u, np.float64))
                print(f"{name} {mode} tol {tol:g}: iters {int(r.iters)}, TRUE rel "
                      f"{[f'{v:.3e}' for v in rel]}; f64 / 80-bit rel of u per wing "
                      f"{[f'{a:.3e} / {b:.3e}' for a, b in judged]}", flush=True)


if __name__ == "__main__":
    main()
