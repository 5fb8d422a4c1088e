"""Port parity of training: the differentiable segment sum (SortedSegmentSum,
whose CPU path runs the backward formula that kernel C runs on the card),
the loss and gradients of one merged batch, the optimizer against optax, and
the ports of tests/test_gnn.py's trainer tests. Small widths (hidden 32, 2
layers) on the tiny graphs of tests/test_gnn.py.

Tolerances: gradients to 1e-5 of each tensor's max |grad| (f32, two sum
orders); the optimizer to 1e-6 (f32, the same arithmetic in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem.ops.gather_scatter as jgs
from tpufem.models.graph import build_graph as jbuild_graph
from tpufem.models.graph import pad_graph as jpad_graph
from tpufem.models.sage import SAGEConfig as FlaxConfig
from tpufem.models.train import TrainConfig as JTrainConfig
from tpufem.models.train import Trainer as JTrainer
from tpufem.models.train import stack_graphs
from tpufem_torch.models.graph import build_graph, pad_graph
from tpufem_torch.models.sage import GraphSAGE, SAGEConfig, flax_to_state_dict
from tpufem_torch.models.train import GraphSet, TrainConfig, Trainer
from tpufem_torch.ops import gather_scatter as tgs

PARAMS = {"span_m": 1.2, "chord_m": 0.35, "sweep_deg": 15.0, "thickness_ratio": 0.10}
SMALL = dict(hidden=32, encoder_hidden=16, decoder_hidden=16, num_layers=2)


def tiny_surface(n=40, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, size=(n, 3))
    return {
        "node_id": np.arange(n, dtype=np.int64),
        "pos": pos.astype(np.float32),
        "normal": np.tile(np.array([0, 0, 1.0], dtype=np.float32), (n, 1)),
        "stress_vm": rng.uniform(1e5, 1e7, size=n).astype(np.float32),
        "disp": rng.normal(size=(n, 3)).astype(np.float32),
        "loss_mask": pos[:, 1] > 0.05,
    }


def tiny_faces(n=40, seed=0):
    rng = np.random.default_rng(seed + 1)
    f = rng.integers(0, n, size=(3 * n, 3))
    return f[(f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])]


def padded_graphs(builder, padder, seeds, n=40):
    raw = [builder(tiny_surface(n, seed=s), tiny_faces(n, seed=s), PARAMS) for s in seeds]
    n_max = max(g.num_nodes for g in raw) + 7
    e_max = max(g.num_edges for g in raw) + 13
    return [padder(g, n_max, e_max) for g in raw]


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------ the segment sum's backward


def test_sorted_segment_sum_gradcheck_f64():
    rng = np.random.default_rng(0)
    E, C, N = 60, 3, 9
    seg = torch.as_tensor(np.sort(rng.integers(0, N + 1, size=E)).astype(np.int32))
    msgs = torch.tensor(rng.normal(size=(E, C)), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda m: tgs.sorted_segment_sum(m, seg, N), (msgs,))
    # the VJP is the row gather of the cotangent, dump rows get 0
    g = torch.as_tensor(rng.normal(size=(N, C)))
    (vjp,) = torch.autograd.grad(tgs.sorted_segment_sum(msgs, seg, N), msgs, g)
    seg_l = seg.long()
    want = torch.where((seg_l < N)[:, None], g[seg_l.clamp(max=N - 1)], torch.zeros(()))
    torch.testing.assert_close(vjp, want, rtol=0, atol=0)


def test_gather_mean_gradient_matches_pallas_vjp():
    """The port's gradient of gather_mean_aggregate equals jax.grad through
    tpufem's Pallas kernel (interpret mode) and its custom_vjp."""
    rng = np.random.default_rng(1)
    N, E, C = 50, 400, 8
    h = rng.normal(size=(N, C)).astype(np.float32)
    ei = rng.integers(0, N, size=(2, E)).astype(np.int32)
    em = (rng.uniform(size=E) > 0.2).astype(np.float32)
    w = rng.normal(size=(N, C)).astype(np.float32)

    def jloss(hh):
        agg = jgs.gather_mean_aggregate(hh, jnp.asarray(ei), jnp.asarray(em), N)
        return jnp.sum(agg * jnp.asarray(w))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(h)))
    ht = torch.tensor(h, requires_grad=True)
    out = tgs.gather_mean_aggregate(
        ht, tgs.aggregation_plan(torch.as_tensor(ei), torch.as_tensor(em), N))
    (out * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_degree_sum_runs_no_backward():
    """Only the message sum of a layer needs the VJP: the degree sum's
    weights carry no gradient, so the backward runs once per layer."""
    calls = []
    orig = tgs.segment_gather
    h = torch.randn(10, 4, requires_grad=True)
    ei = torch.tensor([[1, 2, 3, 4], [0, 0, 5, 5]], dtype=torch.int32)
    # the forward gathers h[src] through segment_gather too: count the backward's calls
    loss = tgs.gather_mean_aggregate(h, tgs.aggregation_plan(ei, torch.ones(4), 10)).sum()
    tgs.segment_gather = lambda *a: calls.append(1) or orig(*a)
    try:
        loss.backward()
    finally:
        tgs.segment_gather = orig
    assert len(calls) == 1


# ------------------------------------------------------ loss and gradients


@pytest.mark.parametrize("impl", ["segment", "pallas"])
def test_loss_and_gradients_match_tpufem(impl):
    """One batch of 3 padded graphs: the port's merged-graph loss and every
    gradient equal tpufem's vmapped jax.value_and_grad(Trainer._loss_fn)
    (dropout 0, weights converted with flax_to_state_dict)."""
    jgraphs = padded_graphs(jbuild_graph, jpad_graph, range(3))
    tgraphs = padded_graphs(build_graph, pad_graph, range(3))
    jtr = JTrainer(JTrainConfig(model=FlaxConfig(**SMALL, dropout=0.0, aggregate_impl=impl)))
    params, _ = jtr.init(jgraphs[0])
    loss_j, grads_j = jax.value_and_grad(jtr._loss_fn)(
        params, stack_graphs(jgraphs), jax.random.PRNGKey(1))

    model = GraphSAGE(SAGEConfig(**SMALL, dropout=0.0, aggregate_impl=impl))
    model.load_state_dict(flax_to_state_dict(to_np(params)))
    model.train()
    loss = Trainer._loss_fn(model, GraphSet(tgraphs, "cpu").batch(range(3)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    want = flax_to_state_dict(to_np(grads_j))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        g = g.numpy()
        np.testing.assert_allclose(got[name].grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)


def test_optimizer_matches_optax():
    """AdamW + optax-style global-norm clip + EMA + plateau LR scale against
    tpufem's optax transform on the same seeded gradient sequence."""
    jgraphs = padded_graphs(jbuild_graph, jpad_graph, [0])
    cfg_kw = dict(lr=3e-3, weight_decay=1e-2, clip_norm=1.0, ema_decay=0.9)
    jtr = JTrainer(JTrainConfig(**cfg_kw, model=FlaxConfig(**SMALL)))
    params, state = jtr.init(jgraphs[0])
    ema_j = params
    tr = Trainer(TrainConfig(**cfg_kw, model=SAGEConfig(**SMALL)), device="cpu")
    model, opt = tr.init()
    model.load_state_dict(flax_to_state_dict(to_np(params)))
    ema = GraphSAGE(SAGEConfig(**SMALL))
    ema.load_state_dict(model.state_dict())

    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    named = dict(model.named_parameters())
    norms = []
    for step in range(12):
        scale = 1.0 if step < 6 else 0.5  # a plateau cut half way
        amp = 0.005 if step % 3 else 1.0  # clipping triggers on every third step
        g_leaves = [rng.normal(size=np.shape(x)).astype(np.float32) * amp for x in leaves]
        grads = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in g_leaves])
        norms.append(float(np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g_leaves))))
        # tpufem's update (Trainer._train_step after value_and_grad)
        state.hyperparams["learning_rate"] = cfg_kw["lr"] * scale
        updates, state = jtr.opt.update(grads, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        ema_j = jax.tree_util.tree_map(lambda e, p: 0.9 * e + 0.1 * p, ema_j, params)
        # the port's
        for name, g in flax_to_state_dict(to_np(grads)).items():
            named[name].grad = g.clone()
        tr._lr_scale = scale
        tr._apply_grads(model, opt, ema)
    assert min(norms) < 1.0 < max(norms)
    for mod, ref in ((model, params), (ema, ema_j)):
        want = flax_to_state_dict(to_np(ref))
        for name, p in mod.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)


# ------------------------------------------- ports of test_gnn.py's trainer


def _overfit_graphs():
    return padded_graphs(build_graph, pad_graph, range(2))


def test_trainer_overfits_tiny_dataset(tmp_path):
    """Training sanity: loss decreases by >10x overfitting two tiny graphs."""
    graphs = _overfit_graphs()
    cfg = TrainConfig(lr=3e-3, batch_size=2, max_epochs=60, early_stop_patience=60,
                      model=SAGEConfig(**SMALL))
    summary = Trainer(cfg, device="cpu").fit(graphs, graphs, tmp_path, verbose=False)
    losses = [r["train_loss"] for r in summary["log"]]
    assert losses[-1] < losses[0] / 10
    assert summary["stopped_reason"] == "max_epochs"
    assert (tmp_path / "best_model.pt").exists() and (tmp_path / "final_model.json").exists()


def test_trainer_ema_checkpoints_averaged_params(tmp_path):
    """With ema_decay>0 the best checkpoint holds the EMA iterate and
    training still converges on a tiny overfit."""
    graphs = _overfit_graphs()
    cfg = TrainConfig(lr=3e-3, batch_size=2, max_epochs=60, early_stop_patience=60,
                      ema_decay=0.9, model=SAGEConfig(**SMALL))
    tr = Trainer(cfg, device="cpu")
    summary = tr.fit(graphs, graphs, tmp_path, verbose=False)
    losses = [r["train_loss"] for r in summary["log"]]
    assert losses[-1] < losses[0] / 10
    # the checkpointed (EMA) params evaluate to the logged best val loss:
    # model selection really used the averaged iterate
    model, _ = Trainer.load_checkpoint(tmp_path / "best_model.pt", device="cpu")
    ev = tr.evaluate(model, graphs)
    assert ev["loss"] <= summary["best_val_loss"] * 1.5 + 1e-9
    np.testing.assert_allclose(ev["loss"], summary["best_val_loss"], rtol=1e-5)


def test_checkpoint_roundtrip(tmp_path):
    graph = build_graph(tiny_surface(), tiny_faces(), PARAMS)
    tr = Trainer(TrainConfig(model=SAGEConfig(**SMALL)), device="cpu")
    model, _ = tr.init()
    tr.save_checkpoint(tmp_path / "ck.pt", model, epoch=3, val_loss=0.5)
    model2, cfg2 = Trainer.load_checkpoint(tmp_path / "ck.pt", device="cpu")
    assert cfg2.hidden == 32 and cfg2 == model.config
    np.testing.assert_allclose(tr.predict(model, graph), tr.predict(model2, graph), atol=1e-7)


def test_merged_batch_equals_per_graph_losses():
    """The merged disjoint graph gives each graph the loss it has alone."""
    graphs = padded_graphs(build_graph, pad_graph, range(3))
    model = GraphSAGE(SAGEConfig(**SMALL), generator=torch.Generator().manual_seed(0)).eval()
    gset = GraphSet(graphs, "cpu")
    with torch.no_grad():
        merged = float(Trainer._loss_fn(model, gset.batch([2, 0, 1])))
        alone = [float(Trainer._loss_fn(model, gset.batch([i]))) for i in (2, 0, 1)]
    np.testing.assert_allclose(merged, np.mean(alone), rtol=1e-6)
