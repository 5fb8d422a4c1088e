"""Command-line entry points of the port, run as
``python -m tpufem_torch.scripts.<name>``: the dataset pipeline
(generate_geometry_dataset -> generate_mesh_dataset -> generate_fem_dataset)
and the surrogate's train_gnn / inference_gnn. Each has a ``main(argv)``."""

import torch


def device_arg(name: str) -> torch.device:
    """The torch device a CLI's --device names; raises if it names CUDA and
    no CUDA device is present (never falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device here; pass --device cpu "
                           "to run on the CPU")
    return dev
