"""The port's multi-device layer — counterpart of ``tpufem/parallel/``.

tpufem ran its sharded solves and data-parallel training inside one JAX
program over a ``jax.sharding.Mesh`` (shard_map with ppermute / psum, or
GSPMD annotations). The port runs one process per rank under
``torch.distributed`` and makes every collective explicit:

  - meshes.make_mesh / DeviceGroup: the rank's group, backend and device;
  - comm: the layer exchanges, halo shifts, all-reduce and all-gather, with
    gloo's host staging chosen by backend;
  - launch.run_ranks: spawn, rendezvous, join against a deadline;
  - shard_stencil: the span-sharded stencil multigrid (tet4, tet10);
  - halo_pcg: the halo-exchange line+RBM PCG on uneven slabs;
  - sharded_solver: the node-sharded Jacobi PCG (f64 cross-check);
  - data_parallel: the data-parallel training step.

Importing this package imports nothing but torch, numpy and the port.
"""

from tpufem_torch.parallel.meshes import DeviceGroup, make_mesh  # noqa: F401
from tpufem_torch.parallel.launch import run_ranks  # noqa: F401
