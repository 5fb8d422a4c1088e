"""Probe (not a test): how far the f32 two-level engine's stress sits from
the f64 solution at DOF100K, in both packages, on the CPU.

generate_fem_dataset --engine twolevel solves each wing with
fem.batched.solve_wing_batch in float32 (tpufem's default) to a recurred
relative residual of 1e-6. This solves wing 2 of chip_smoke.py's seeded
batch that way in the port and in tpufem, and a scipy direct factorization
of the same f64 system (fem.refsolve.direct_solve), and prints each f32
engine's largest displacement and von Mises differences from the direct
solution (relative to the largest value) and from each other, with the
station and slot of the worst von Mises node.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/probe_twolevel_f32_stress.py

(about 1 minute; the port at 8 torch threads)
"""

import time

import numpy as np
import torch

WING = 2


def main():
    import jax.numpy as jnp  # noqa: F401  (tpufem's JAX, on the CPU)

    from tpufem.fem.batched import solve_wing_batch as j_solve
    from tpufem.mesher import WingMeshResolution as JRes
    from tpufem_torch.fem.batched import solve_wing_batch
    from tpufem_torch.fem.refsolve import direct_solve
    from tpufem_torch.mesher import DOF100K, structured_wing_mesh, wing_topology
    from tpufem_torch.profile_solve import seeded_batch
    from tpufem_torch.sets import build_boundary_sets

    torch.set_num_threads(8)
    p = [float(v) for v in seeded_batch(8)[WING]]
    params = [dict(span_m=p[0], chord_m=p[1], sweep_deg=p[2], thickness_ratio=p[3])]
    t0 = time.time()
    port, _ = solve_wing_batch(params, DOF100K, tol=1e-6, device="cpu")
    print(f"port f32 two-level: {int(port.iters[0])} iterations, rel "
          f"{float(port.rel_residual[0]):.3e}, {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    ref, _ = j_solve(params, JRes(*DOF100K.key), tol=1e-6)
    print(f"tpufem f32 two-level: {int(np.asarray(ref.iters)[0])} iterations, rel "
          f"{float(np.asarray(ref.rel_residual)[0]):.3e}, {time.time() - t0:.1f} s", flush=True)
    mesh = structured_wing_mesh(*p, DOF100K)
    u64, _, vm64 = direct_solve(mesh, build_boundary_sets(mesh), pressure=5e3)

    def gap(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.abs(a - b).max() / np.abs(b).max()

    runs = {"port": (port.u[0].numpy(), port.vm[0].numpy()),
            "tpufem": (np.asarray(ref.u[0]), np.asarray(ref.vm[0]))}
    for name, (u, vm) in runs.items():
        print(f"{name} f32 vs the f64 direct solve: u {gap(u, u64):.3e}, vm {gap(vm, vm64):.3e}")
    print(f"port f32 vs tpufem f32: u {gap(runs['port'][0], runs['tpufem'][0]):.3e}, vm "
          f"{gap(runs['port'][1], runs['tpufem'][1]):.3e}")
    topo = wing_topology(DOF100K)
    n = int(np.argmax(np.abs(runs["port"][1].astype(np.float64) - vm64)))
    nj = DOF100K.n_span + 1
    print(f"worst vm node {n}: chord station {topo.station_id[n] // nj}, span station "
          f"{topo.station_id[n] % nj}, slot {topo.slot[n]}; f64 vm {vm64[n]:.4e}, port f32 "
          f"{runs['port'][1][n]:.4e}; largest f64 vm {vm64.max():.4e}")


if __name__ == "__main__":
    main()
