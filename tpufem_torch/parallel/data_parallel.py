"""Data-parallel surrogate training — port of
``tpufem/parallel/data_parallel.py``.

tpufem sharded the stacked padded-graph batch over a 1-D device mesh and
jitted the whole step, XLA turning the gradient mean into a psum. Here each
rank takes its share of the stacked batch (shard_batch), the parameters are
replicated (every rank starts from the same weights and applies the same
update), and the loss is the mean over the WHOLE batch of each graph's
masked MSE: each rank backpropagates its graphs' losses divided by the
batch size, the gradients are summed over the ranks with one all-reduce of
the flattened gradient, and the port's AdamW (torch.optim.AdamW, as the
Trainer) steps.

Dropout draws come from one generator per graph, seeded from (seed, the
graph's index in the whole batch), so a step at world size W equals the
single-process step (world size 1) over the same graphs, up to the order
in which the gradients are summed. tpufem split one key per graph the same
way (jax.random.split(rng, B)).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpufem_torch.models.metrics import masked_mse
from tpufem_torch.models.sage import GraphSAGE, SAGEConfig
from tpufem_torch.parallel.comm import all_reduce_sum
from tpufem_torch.parallel.meshes import DeviceGroup


class GraphStack(NamedTuple):
    """B padded graphs of one size, stacked (tpufem's GraphBatchArrays), and
    each graph's index in the whole batch."""

    x: torch.Tensor  # (B, N, in_dim)
    edge_index: torch.Tensor  # (B, 2, E) int32
    edge_mask: torch.Tensor  # (B, E)
    y: torch.Tensor  # (B, N)
    loss_mask: torch.Tensor  # (B, N): loss_mask * node_mask
    ids: torch.Tensor  # (B,) int64


def shard_batch(batch: GraphStack, group: DeviceGroup) -> GraphStack:
    """This rank's share of the batch: graphs [r B/W, (r + 1) B/W) (B must be
    a multiple of the world size, as tpufem's sharding requires), on the
    group's device."""
    B, W = batch.x.shape[0], group.world
    if B % W:
        raise ValueError(f"a batch of {B} graphs does not split over {W} ranks")
    n = B // W
    return GraphStack(*(a[group.rank * n:(group.rank + 1) * n].to(group.device) for a in batch))


def graph_generator(seed: int, index: int, device) -> torch.Generator:
    """The dropout generator of graph `index` of the batch under `seed`."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def make_dp_train_step(model: GraphSAGE, opt: torch.optim.Optimizer, group: DeviceGroup,
                       axis: str = "mesh"):
    """step(batch, seed) -> loss: one data-parallel AdamW step of `model` on
    this rank's `batch` (shard_batch), the loss and the gradient being those
    of the mean masked MSE over all ranks' graphs (the batch size is the
    local size times the world size). Every rank calls it; the returned loss
    (a 0-d tensor) is the same on every rank. `axis` is tpufem's, ignored."""
    del axis
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: GraphStack, seed: int = 0) -> torch.Tensor:
        model.train()
        opt.zero_grad(set_to_none=False)
        n_total = batch.x.shape[0] * group.world
        local = torch.zeros((), dtype=torch.float32, device=group.device)
        for i in range(batch.x.shape[0]):
            gen = graph_generator(seed, int(batch.ids[i]), group.device)
            pred = model(batch.x[i], batch.edge_index[i], batch.edge_mask[i], generator=gen)
            li = masked_mse(pred, batch.y[i], batch.loss_mask[i]) / n_total
            li.backward()
            local = local + li.detach()
        flat = all_reduce_sum(group, torch.cat([p.grad.reshape(-1) for p in params]))
        for p, g in zip(params, flat.split([p.numel() for p in params]), strict=True):
            p.grad.copy_(g.reshape(p.shape))
        opt.step()
        return all_reduce_sum(group, local)

    return step


def dp_train(group: DeviceGroup, config: SAGEConfig, graphs: dict, steps: int = 1,
             seed: int = 0, weights: dict | None = None, lr: float = 1e-3,
             weight_decay: float = 1e-4) -> dict:
    """`steps` data-parallel steps on this rank, as run_ranks runs them:
    a GraphSAGE(config) with weights drawn from `seed` (or the state dict
    `weights`, numpy), its AdamW (lr, weight_decay, as tpufem's optax.adamw),
    the stacked graphs `graphs` (GraphStack's fields as numpy arrays, the
    whole batch) sharded over the group. Returns the losses, the parameters
    (numpy) after the last step and after the first, and the launches of the
    aggregation kernels."""
    from tpufem_torch.ops import gather_scatter as gs

    dev = group.device
    model = GraphSAGE(config, generator=torch.Generator().manual_seed(seed), device=dev)
    if weights is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in weights.items()})
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    stack = GraphStack(*(torch.as_tensor(graphs[k]) for k in GraphStack._fields))
    batch = shard_batch(stack, group)
    step = make_dp_train_step(model, opt, group)
    counters = (gs.gather_row_sum, gs.segment_rowptr, gs.sorted_segment_sum, gs.segment_gather)
    for c in counters:
        c.launches = 0

    def params():  # a copy: a CPU tensor's numpy view would follow later steps
        return {k: v.detach().cpu().clone().numpy() for k, v in model.state_dict().items()}

    losses, first = [], None
    for k in range(steps):
        losses.append(float(step(batch, seed + k)))
        first = first or params()
    return {"losses": losses, "params": params(), "params_step1": first,
            "launches": {c.__name__: c.launches for c in counters}}
