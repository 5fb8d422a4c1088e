"""GraphSAGE stress-field model as torch ``nn.Module``s — port of
``tpufem/models/sage.py``.

  encoder MLP 10 -> 64 -> 128
  num_layers x [SAGEConv(128,128) -> LayerNorm -> ReLU -> dropout -> residual]
  decoder MLP 128 -> 64 -> 1

SAGEConv matches PyG's default: h' = W_l h_i + b + W_r mean_{j in N(i)} h_j.
The mean aggregation goes through tpufem_torch.ops.gather_scatter, planned
once per forward (one stable sort by destination for all layers), and
``SAGEConfig.aggregate_impl`` has tpufem's two meanings:
  "segment" (default)  the fused neighbour mean, ``segment_mean_aggregate``:
                       one launch of CUDA kernel A entry (b) per layer
                       forward, one more backward, no (E, C) tensor (tpufem's
                       function of that name, which XLA fuses);
  "pallas"             ``gather_mean_aggregate``: the messages materialised,
                       then the sorted segment sum, kernel A entry (a) forward
                       and kernel C backward (tpufem's route through
                       ``sorted_segment_sum_pallas``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tpufem_torch.ops.gather_scatter import (
    AggregationPlan,
    aggregation_plan,
    gather_mean_aggregate,
    segment_mean_aggregate,
)

# flax.linen.LayerNorm's epsilon (torch's default is 1e-5)
LAYERNORM_EPS = 1e-6
AGGREGATIONS = {"segment": segment_mean_aggregate, "pallas": gather_mean_aggregate}


@dataclass(frozen=True)
class SAGEConfig:
    in_dim: int = 10
    hidden: int = 128
    encoder_hidden: int = 64
    decoder_hidden: int = 64
    num_layers: int = 4
    dropout: float = 0.1
    aggregate_impl: str = "segment"  # "segment" | "pallas"

    def to_json_dict(self) -> dict:
        return {
            "in_dim": self.in_dim,
            "hidden": self.hidden,
            "encoder_hidden": self.encoder_hidden,
            "decoder_hidden": self.decoder_hidden,
            "num_layers": self.num_layers,
            "dropout": self.dropout,
            "aggregate_impl": self.aggregate_impl,
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "SAGEConfig":
        return cls(**d)


class SAGEConv(nn.Module):
    """PyG-equivalent SAGEConv with mean aggregation."""

    def __init__(self, in_features: int, features: int, aggregate_impl: str = "segment"):
        super().__init__()
        if aggregate_impl not in AGGREGATIONS:
            raise ValueError(f"aggregate_impl {aggregate_impl!r} is not one of "
                             f"{sorted(AGGREGATIONS)}")
        self.aggregate = AGGREGATIONS[aggregate_impl]
        self.lin_self = nn.Linear(in_features, features)
        self.lin_neigh = nn.Linear(in_features, features, bias=False)

    def forward(self, h, plan: AggregationPlan):
        agg = self.aggregate(h, plan)
        return self.lin_self(h) + self.lin_neigh(agg)


class GraphSAGE(nn.Module):
    """Surface-node stress surrogate: (x (N,in_dim), edge_index (2,E) int32,
    edge_mask (E,)) -> (N,) log1p-stress prediction. Dropout is active only in
    train() mode, with its draws from `generator` when one is given (the
    trainer's seeded one); serving runs in eval() mode.

    With a torch.Generator the weights are drawn from it (normal, fan-in
    scaled, zero biases) on the CPU, so a seed gives the same model on any
    device; the module is then moved to `device`.
    """

    def __init__(self, config: SAGEConfig | None = None, *, generator=None, device="cpu"):
        super().__init__()
        cfg = config or SAGEConfig()
        self.config = cfg
        self.enc1 = nn.Linear(cfg.in_dim, cfg.encoder_hidden)
        self.enc2 = nn.Linear(cfg.encoder_hidden, cfg.hidden)
        self.sage = nn.ModuleList(SAGEConv(cfg.hidden, cfg.hidden, cfg.aggregate_impl)
                                  for _ in range(cfg.num_layers))
        self.ln = nn.ModuleList(
            nn.LayerNorm(cfg.hidden, eps=LAYERNORM_EPS) for _ in range(cfg.num_layers)
        )
        self.dec1 = nn.Linear(cfg.hidden, cfg.decoder_hidden)
        self.dec2 = nn.Linear(cfg.decoder_hidden, 1)
        if generator is not None:
            with torch.no_grad():
                for m in self.modules():
                    if isinstance(m, nn.Linear):
                        m.weight.normal_(0.0, m.in_features**-0.5, generator=generator)
                        if m.bias is not None:
                            m.bias.zero_()
        self.to(device)

    def _dropout(self, h, generator):
        """flax.linen.Dropout: keep with probability 1-p, scale by 1/(1-p)."""
        p = self.config.dropout
        if not self.training or p == 0.0:
            return h
        keep = torch.rand(h.shape, generator=generator, device=h.device) >= p
        return torch.where(keep, h / (1.0 - p), torch.zeros_like(h))

    def forward(self, x, edge_index, edge_mask, generator=None):
        h = torch.relu(self.enc1(x))
        h = torch.relu(self.enc2(h))
        plan = aggregation_plan(edge_index, edge_mask, x.shape[0])  # one sort for all layers
        for conv, ln in zip(self.sage, self.ln):
            res = h
            h = conv(h, plan)
            h = torch.relu(ln(h))
            h = self._dropout(h, generator)
            h = h + res
        h = torch.relu(self.dec1(h))
        return self.dec2(h)[:, 0]


def flax_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Map tpufem GraphSAGE flax params (a nested dict of arrays, with or
    without the top-level "params" key) to this module's state_dict.

    Dense ``kernel (in,out)`` becomes ``Linear.weight (out,in)``; ``lin_neigh``
    has no bias; LayerNorm ``scale``/``bias`` become ``weight``/``bias``.
    """
    p = params.get("params", params)

    def t(a, transpose=False):
        a = np.asarray(a, dtype=np.float32)
        return torch.tensor(a.T if transpose else a)  # a copy, contiguous

    def dense(prefix, d):
        out = {f"{prefix}.weight": t(d["kernel"], transpose=True)}
        if "bias" in d:
            out[f"{prefix}.bias"] = t(d["bias"])
        return out

    sd = {}
    for name in ("enc1", "enc2", "dec1", "dec2"):
        sd.update(dense(name, p[name]))
    i = 0
    while f"sage{i}" in p:
        sd.update(dense(f"sage.{i}.lin_self", p[f"sage{i}"]["lin_self"]))
        sd.update(dense(f"sage.{i}.lin_neigh", p[f"sage{i}"]["lin_neigh"]))
        sd[f"ln.{i}.weight"] = t(p[f"ln{i}"]["scale"])
        sd[f"ln.{i}.bias"] = t(p[f"ln{i}"]["bias"])
        i += 1
    return sd
