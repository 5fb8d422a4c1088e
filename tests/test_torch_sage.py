"""Port parity: GraphSAGE as a torch nn.Module with weights converted from
tpufem's flax params, against tpufem.models.sage.GraphSAGE.apply, at hidden
16, 2 layers. Tolerance 2e-4 (f32, the bar tests/test_pallas_ops.py uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.models.sage import GraphSAGE as FlaxSAGE
from tpufem.models.sage import SAGEConfig as FlaxConfig
from tpufem_torch.models.sage import GraphSAGE, SAGEConfig, flax_to_state_dict

CFG = dict(in_dim=10, hidden=16, encoder_hidden=8, decoder_hidden=8, num_layers=2)


@pytest.fixture(scope="module")
def flax_model():
    rng = np.random.default_rng(2)
    N, E = 60, 300
    x = rng.normal(size=(N, 10)).astype(np.float32)
    ei = rng.integers(0, N, size=(2, E)).astype(np.int32)
    em = (rng.uniform(size=E) > 0.1).astype(np.float32)
    model = FlaxSAGE(FlaxConfig(**CFG))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ei), jnp.asarray(em))
    # non-trivial LayerNorm affine, so the converter's scale/bias mapping counts
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.1 * jnp.sin(jnp.arange(v.size).reshape(v.shape) + 1.0)
        if "ln" in jax.tree_util.keystr(path) else v, params)
    return model, params, x, ei, em


def test_flax_to_state_dict_covers_every_parameter(flax_model):
    _, params, *_ = flax_model
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    model = GraphSAGE(SAGEConfig(**CFG))
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    np.testing.assert_array_equal(
        sd["sage.1.lin_neigh.weight"].numpy(),
        np.asarray(params["params"]["sage1"]["lin_neigh"]["kernel"]).T)
    assert model.ln[0].eps == 1e-6  # flax LayerNorm's epsilon


def test_forward_matches_flax(flax_model):
    model_a, params, x, ei, em = flax_model
    ref = np.asarray(model_a.apply(params, jnp.asarray(x), jnp.asarray(ei), jnp.asarray(em)))
    model = GraphSAGE(SAGEConfig(**CFG))
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    with torch.no_grad():
        out = model(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(em)).numpy()
    assert out.shape == (60,)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("impl", ["segment", "pallas"])
def test_forward_matches_flax_under_both_impls(flax_model, impl):
    """aggregate_impl has tpufem's two meanings: each route of the port
    against the same route of tpufem (XLA segment mean | the Pallas kernel in
    interpret mode), same converted weights, f32 tolerance."""
    _, params, x, ei, em = flax_model
    ref = np.asarray(FlaxSAGE(FlaxConfig(**CFG, aggregate_impl=impl)).apply(
        params, jnp.asarray(x), jnp.asarray(ei), jnp.asarray(em)))
    model = GraphSAGE(SAGEConfig(**CFG, aggregate_impl=impl))
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    model.eval()
    with torch.no_grad():
        out = model(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(em)).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_the_two_impls_agree_and_share_checkpoints(flax_model):
    """The fused mean and the message route give the same forward and the
    same parameter gradients (1e-5), from one state_dict."""
    _, params, x, ei, em = flax_model
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    outs, grads = {}, {}
    for impl in ("segment", "pallas"):
        model = GraphSAGE(SAGEConfig(**CFG, dropout=0.0, aggregate_impl=impl)).train()
        model.load_state_dict(sd)
        out = model(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(em))
        (out * out).mean().backward()
        outs[impl] = out.detach().numpy()
        grads[impl] = {n: p.grad.numpy() for n, p in model.named_parameters()}
    np.testing.assert_allclose(outs["segment"], outs["pallas"], rtol=1e-5, atol=1e-5)
    for name, g in grads["segment"].items():
        np.testing.assert_allclose(g, grads["pallas"][name], rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)


def test_forward_plans_the_graph_once(flax_model, monkeypatch):
    """GraphSAGE.forward sorts the edges once for all its layers."""
    import tpufem_torch.models.sage as tsage

    _, _, x, ei, em = flax_model
    calls = []
    orig = tsage.aggregation_plan
    monkeypatch.setattr(tsage, "aggregation_plan", lambda *a: calls.append(1) or orig(*a))
    for impl in ("segment", "pallas"):
        model = GraphSAGE(SAGEConfig(**CFG, aggregate_impl=impl)).eval()
        with torch.no_grad():
            model(torch.as_tensor(x), torch.as_tensor(ei), torch.as_tensor(em))
    assert len(calls) == 2


def test_config_round_trip_and_seeded_init():
    for impl in ("segment", "pallas"):
        cfg = SAGEConfig(aggregate_impl=impl)
        assert SAGEConfig.from_json_dict(cfg.to_json_dict()) == cfg
        assert cfg.to_json_dict() == FlaxConfig(aggregate_impl=impl).to_json_dict()
    a = GraphSAGE(SAGEConfig(**CFG), generator=torch.Generator().manual_seed(7))
    b = GraphSAGE(SAGEConfig(**CFG), generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
