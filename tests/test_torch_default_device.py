"""GraphSAGE and WingBatchT, like every entry point of the port, run on the
card unless the caller asks for the CPU: without a CUDA device, building one
without a device raises with the hint, and with device="cpu" it runs as
before. (torch.cuda.is_available is patched to False, so these hold on a
machine with a card too.)"""

import numpy as np
import pytest
import torch

from tpufem_torch.fem.batched_t import WingBatchT
from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.models.sage import GraphSAGE, SAGEConfig

SMALL = SAGEConfig(in_dim=10, hidden=16, encoder_hidden=8, decoder_hidden=8, num_layers=2)
RES = WingMeshResolution(8, 6, 3, te_floor_frac=0.006, spacing="le")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_graphsage_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device here; pass device='cpu'"):
        GraphSAGE(SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphSAGE(SMALL, device="cuda:0")
    model = GraphSAGE(SMALL, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(30, 10)), dtype=torch.float32)
    ei = torch.as_tensor(rng.integers(0, 30, size=(2, 120)), dtype=torch.int32)
    with torch.no_grad():
        out = model(x, ei, torch.ones(120))
    assert out.shape == (30,) and torch.isfinite(out).all()


def test_wing_batch_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device here; pass device='cpu'"):
        WingBatchT(RES)
    bt = WingBatchT(RES, device="cpu")
    assert bt.device == torch.device("cpu") and bt.tets.device.type == "cpu"
    nodes = bt._nodes(torch.tensor([[1.2, 0.35, 10.0, 0.10]], dtype=torch.float64),
                      torch.float64)
    assert nodes.shape == (bt.num_nodes, 3, 1) and torch.isfinite(nodes).all()
