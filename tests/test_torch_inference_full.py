"""Inference alone at full size: the port's GraphSAGE at SAGEConfig() width,
with weights carried across from tpufem's flax GraphSAGE by
flax_to_state_dict (its LayerNorm affine made non-trivial, as
tests/test_torch_sage.py does), against tpufem's forward on one full DOF100K
seeded surface graph (profile_train.seeded_graphs(1): 11,520 padded nodes,
68,992 padded edges), under both aggregate_impl values (tpufem's "pallas"
route runs its Pallas kernel in interpret mode here), to the tolerance of
test_forward_matches_flax (2e-4). Each case takes a few seconds of JAX on
the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.models.sage import GraphSAGE as FlaxSAGE
from tpufem.models.sage import SAGEConfig as FlaxConfig
from tpufem_torch.models.sage import GraphSAGE, SAGEConfig, flax_to_state_dict
from tpufem_torch.profile_train import seeded_graphs


@pytest.fixture(scope="module")
def wing_graph():
    return seeded_graphs(1)[0]


@pytest.fixture(scope="module")
def flax_params(wing_graph):
    g = wing_graph
    params = FlaxSAGE(FlaxConfig()).init(jax.random.PRNGKey(0), jnp.asarray(g.x),
                                         jnp.asarray(g.edge_index), jnp.asarray(g.edge_mask))
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jnp.sin(jnp.arange(v.size).reshape(v.shape) + 1.0)
        if "ln" in jax.tree_util.keystr(path) else v, params)


@pytest.mark.parametrize("impl", ["segment", "pallas"])
def test_full_size_inference_matches_tpufem(wing_graph, flax_params, impl):
    g = wing_graph
    assert g.x.shape == (11520, 10) and g.edge_index.shape == (2, 68992)
    ref = np.asarray(jax.jit(FlaxSAGE(FlaxConfig(aggregate_impl=impl)).apply)(
        flax_params, jnp.asarray(g.x), jnp.asarray(g.edge_index), jnp.asarray(g.edge_mask)))
    model = GraphSAGE(SAGEConfig(aggregate_impl=impl), device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, flax_params)))
    model.eval()
    with torch.no_grad():
        out = model(torch.as_tensor(g.x), torch.as_tensor(g.edge_index),
                    torch.as_tensor(g.edge_mask)).numpy()
    assert out.shape == (11520,) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
