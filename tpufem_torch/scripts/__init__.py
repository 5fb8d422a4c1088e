"""Command-line entry points of the port, run as
``python -m tpufem_torch.scripts.<name>``: the dataset pipeline
(generate_geometry_dataset -> generate_mesh_dataset -> generate_fem_dataset,
validate_dataset, repair_geometry_glb), the surrogate's train_gnn /
inference_gnn, and the dynamics analyses modal_analysis, buckling_analysis
and prestress_sweep. Each has a ``main(argv)``."""

import torch

from tpufem_torch.device import resolve_device


def device_arg(name: str) -> torch.device:
    """The torch device a CLI's --device names; raises if it names CUDA and
    no CUDA device is present (never falls back to the CPU)."""
    return resolve_device(name, hint="pass --device cpu to run on the CPU")
