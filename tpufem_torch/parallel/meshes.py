"""The rank's device group — counterpart of ``tpufem/parallel/meshes.py``.

tpufem's ``make_mesh`` built a 1-D ``jax.sharding.Mesh`` over the first n
devices of one program. The port runs one process per rank: ``make_mesh``
wraps the initialised ``torch.distributed`` group (or, at world size 1 with
no group, the process alone) into a DeviceGroup, which the collectives of
``parallel.comm`` take.

Backends. NCCL is the default on the card and needs a card per rank; gloo
runs anywhere, several ranks may share one card, and the exchanges stage
its CUDA tensors through pinned host buffers (comm). The choice is the
caller's and is never switched after a failure.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from tpufem_torch.device import resolve_device


@dataclass
class DeviceGroup:
    """One rank's view of the group: its rank and the world size, the
    backend ("nccl" or "gloo"), the device its tensors live on, the process
    group (None: the default group, or no group at world size 1), and
    `stats`, the seconds and calls spent inside the exchange layer
    (comm.timed), which the solvers read for their exchange share."""

    rank: int
    world: int
    backend: str
    device: torch.device
    pg: object = None
    stats: dict = field(default_factory=lambda: {"exchange_s": 0.0, "calls": 0})
    buffers: dict = field(default_factory=dict)  # pinned staging buffers (comm)

    @property
    def staged(self) -> bool:
        """Whether the collectives stage through host memory: gloo with
        CUDA tensors (gloo's send, recv and all_gather take CPU tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def reset_stats(self) -> None:
        self.stats.update(exchange_s=0.0, calls=0)


def default_backend(device) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, world: int, device) -> None:
    """Raise unless `backend` can run `world` ranks on `device`: NCCL needs a
    CUDA card for every rank (it refuses two ranks on one device); gloo takes
    any world on the CPU or on shared cards."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        dev = torch.device(device)
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.type != "cuda" or have < world:
            raise ValueError(
                f"backend='nccl' needs a CUDA card for each of {world} ranks, and device "
                f"{str(device)!r} has {have if dev.type == 'cuda' else 0}: pass "
                f"backend=\"gloo\" (several ranks may share one card) or fewer ranks")


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of `rank`: the CPU, or under NCCL card `rank`, under gloo
    card rank mod the cards present (ranks share cards)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is not None and backend == "gloo":
        return dev
    n = torch.cuda.device_count()
    return torch.device("cuda", rank if backend == "nccl" else rank % n)


def make_mesh(n_devices: int | None = None, backend: str | None = None,
              device="cuda") -> DeviceGroup:
    """The DeviceGroup of this process inside an initialised group (or of
    the process alone where no group is initialised: world size 1).
    `n_devices`, where given, must equal the world size; `backend`, where
    given, must be the group's. Under NCCL or on a card the current CUDA
    device is set to the rank's."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        got = dist.get_backend()
        if backend is not None and backend != got:
            raise ValueError(f"make_mesh: the group runs {got!r}, not {backend!r}")
        backend = got
    else:
        rank, world = 0, 1
        backend = backend or default_backend(device)
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices requested in a group of {world}")
    check_backend(backend, world, device)
    dev = rank_device(device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceGroup(rank, world, backend, dev)
