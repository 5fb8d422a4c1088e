"""The port's multi-device layer (tpufem_torch.parallel) on the CPU under gloo,
against tpufem's on the same inputs:

- the exchange layer (comm.check_exchanges) gives the values its
  collectives must give at 2 and 3 ranks;
- a rank that raises makes run_ranks raise, with that rank's traceback,
  within its deadline; NCCL on a machine without cards raises up front with
  the backend="gloo" hint;
- build_halo_partition equals tpufem's arrays at RES_UNEVEN over 4 and 8
  ranks, and keeps tpufem's invariants (test_parallel.py:111-119);
- halo_pcg_solve: tet4 at RES over 2 and 4 ranks and at RES_UNEVEN over 4,
  relative error under 1e-8 against tpufem's solve_wing_case f64 at tol
  1e-10 (test_parallel.py:32-80's bar); tet10 at RES_UNEVEN over 2 against
  the port's solve_tet10_case f64;
- sharded_pcg_solve at RES over 2: error under 1e-7 against the same
  reference (test_parallel.py:139-156), TypeError off f64;
- the data-parallel step: at 2 ranks with a small config and dropout on, one
  step equals the single-process step over the same 4 graphs (loss 1e-6,
  params 1e-6 of their largest); at dropout 0, weights carried across by
  models.sage.flax_to_state_dict, the loss and the updated params equal
  tpufem's make_dp_train_step on its 8-device CPU mesh to 1e-5.

Each world size spawns once (module-scoped fixtures run its cases in one
run_ranks call); every collective has its timeout.
"""

import numpy as np
import pytest
import torch

from tpufem_torch.mesher import WingMeshResolution
from tpufem_torch.models.sage import SAGEConfig
from tpufem_torch.parallel.comm import check_exchanges
from tpufem_torch.parallel.data_parallel import dp_train
from tpufem_torch.parallel.halo_pcg import build_halo_partition, halo_solve
from tpufem_torch.parallel.launch import RankError, run_all, run_ranks
from tpufem_torch.parallel.sharded_solver import node_sharded_solve, sharded_pcg_solve
from tpufem_torch.scripts.dryrun_multichip import stacked_graphs, tiny_graph

RES = WingMeshResolution(12, 15, 2)  # 16 span stations
RES_UNEVEN = WingMeshResolution(12, 18, 2)  # 19 span stations: NOT divisible
PARAMS = (1.2, 0.35, 10.0, 0.10)
TIMEOUT = 240.0
SMALL = SAGEConfig(hidden=16, encoder_hidden=8, decoder_hidden=8, num_layers=2, dropout=0.1)


def _jres(r):
    from tpufem.mesher import WingMeshResolution as JR

    return JR(r.n_chord, r.n_span, r.n_thick, r.te_floor_frac, r.spacing)


@pytest.fixture(scope="module")
def graphs4():
    return stacked_graphs([tiny_graph(seed=s) for s in range(4)])


@pytest.fixture(scope="module")
def graphs8():
    return stacked_graphs([tiny_graph(seed=s) for s in range(8)])


@pytest.fixture(scope="module")
def tpufem_dp(graphs8):
    """tpufem's DP step on its 8-device CPU mesh at dropout 0, its initial
    weights carried into the port's state dict."""
    import jax
    import optax

    from tpufem.models.sage import GraphSAGE, SAGEConfig as JC
    from tpufem.models.train import GraphBatchArrays
    from tpufem.parallel.data_parallel import make_dp_train_step, shard_batch
    from tpufem.parallel.meshes import make_mesh
    from tpufem_torch.models.sage import flax_to_state_dict

    mesh = make_mesh(8)
    jcfg = JC(hidden=16, encoder_hidden=8, decoder_hidden=8, num_layers=2, dropout=0.0)
    model = GraphSAGE(jcfg)
    g = graphs8
    batch = GraphBatchArrays(x=g["x"], edge_index=g["edge_index"], edge_mask=g["edge_mask"],
                             y=g["y"], loss_mask=g["loss_mask"], node_mask=g["loss_mask"] * 0 + 1)
    params = model.init(jax.random.PRNGKey(0), g["x"][0], g["edge_index"][0], g["edge_mask"][0])
    w0 = {k: v.numpy() for k, v in flax_to_state_dict(jax.device_get(params)).items()}
    opt = optax.adamw(1e-3, weight_decay=1e-4)
    with mesh:
        step = make_dp_train_step(model, opt, mesh)
        p2, _, loss = step(params, opt.init(params), shard_batch(batch, mesh),
                           jax.random.PRNGKey(1))
    w1 = {k: v.numpy() for k, v in flax_to_state_dict(jax.device_get(p2)).items()}
    return w0, w1, float(loss)


@pytest.fixture(scope="module")
def runs(graphs4, graphs8, tpufem_dp):
    """Every rank's results, by world size (one spawn each)."""
    w0 = tpufem_dp[0]
    cases = {
        2: [(check_exchanges, ()),
            (halo_solve, (RES, PARAMS, "tet4")),
            (halo_solve, (RES_UNEVEN, PARAMS, "tet10")),
            (node_sharded_solve, (RES, PARAMS)),
            (dp_train, (SMALL, graphs4), {"seed": 3}),
            (dp_train, (SAGEConfig(hidden=16, encoder_hidden=8, decoder_hidden=8, num_layers=2,
                                   dropout=0.0), graphs8), {"weights": w0})],
        3: [(check_exchanges, ())],
        4: [(halo_solve, (RES, PARAMS, "tet4")), (halo_solve, (RES_UNEVEN, PARAMS, "tet4"))],
    }
    return {w: run_ranks(run_all, w, "gloo", "cpu", args=(c,), timeout_s=TIMEOUT)
            for w, c in cases.items()}


def _tpufem_ref(res, pressure=200.0):
    import jax.numpy as jnp

    from tpufem.fem import WingSolveConfig, solve_wing_case
    from tpufem.mesher import structured_wing_mesh
    from tpufem.sets import build_boundary_sets

    m = structured_wing_mesh(*PARAMS, _jres(res))
    sol = solve_wing_case(m, build_boundary_sets(m), WingSolveConfig(
        pressure=pressure, dtype=jnp.float64, tol=1e-10, maxiter=20000))
    assert sol.converged
    return np.asarray(sol.u)


@pytest.fixture(scope="module")
def ref_res():
    return _tpufem_ref(RES)


@pytest.fixture(scope="module")
def ref_uneven():
    return _tpufem_ref(RES_UNEVEN)


def _rel(u, ref):
    return np.linalg.norm(u - ref) / np.linalg.norm(ref)


# ------------------------------------------------------------ the layer


@pytest.mark.parametrize("world", [2, 3])
def test_exchanges_give_their_values(runs, world):
    outs = [r[0] for r in runs[world]]
    base = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    slabs = [base + 100.0 * d for d in range(world)]
    full = np.concatenate([s[..., :-1] for s in slabs[:-1]] + [slabs[-1]], axis=-1)
    for d, o in enumerate(outs):
        want = slabs[d].copy()
        if d + 1 < world:
            want[..., -1] += slabs[d + 1][..., 0]
        if d > 0:
            want[..., 0] += slabs[d - 1][..., -1]
        np.testing.assert_array_equal(o["sync"], want)
        own = slabs[d].copy()
        if d > 0:
            own[..., 0] = 0.0
        np.testing.assert_array_equal(o["own"], own)
        np.testing.assert_array_equal(o["full"], full)
        np.testing.assert_array_equal(o["slice"], full[..., 3 * d: 3 * d + 4])
        np.testing.assert_array_equal(o["sum"], [world, sum(range(world))])
        nxt = slabs[d + 1][:, :1] if d + 1 < world else np.zeros((2, 1, 4))
        prv = slabs[d - 1][:, -1:] if d > 0 else np.zeros((2, 1, 4))
        np.testing.assert_array_equal(o["next"], nxt)
        np.testing.assert_array_equal(o["prev"], prv)


def test_a_failing_rank_ends_the_run():
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        run_ranks(check_exchanges, 2, "gloo", "cpu", args=(1,), timeout_s=60.0)


def test_nccl_without_cards_names_gloo():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(ValueError, match='backend="gloo"'):
        run_ranks(check_exchanges, 2, "nccl", "cpu")


# ------------------------------------------------------- the partition


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("element", ["tet4", "tet10"])
def test_halo_partition_equals_tpufem(n, element):
    from tpufem.parallel.halo_pcg import build_halo_partition as jbuild

    part = build_halo_partition(RES_UNEVEN, n, *PARAMS, element=element)
    jpart = jbuild(_jres(RES_UNEVEN), n, *PARAMS, element=element)
    for k, v in vars(jpart).items():
        got = getattr(part, k)
        if isinstance(v, np.ndarray):
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            assert got == v, k
    # tpufem's invariants
    assert int(part.node_mask.sum()) == part.num_nodes
    assert len(np.unique(part.perm)) == part.num_nodes
    assert part.elems.min() >= 0
    assert part.elems.max() < part.n_max + part.g_max


# ------------------------------------------------------------- the solves


@pytest.mark.parametrize("world,res,case", [(2, "RES", 1), (4, "RES", 0), (4, "RES_UNEVEN", 1)])
def test_halo_pcg_tet4_matches_tpufem(runs, ref_res, ref_uneven, world, res, case):
    ref = ref_res if res == "RES" else ref_uneven
    for r in runs[world]:
        out = r[case]
        assert out["rel"] <= 1e-10
        assert _rel(out["u"], ref) < 1e-8


def test_halo_pcg_tet10_matches_solve_tet10_case(runs):
    from tpufem_torch.fem.tet10 import (
        solve_tet10_case,
        tet10_from_tet4,
        tet10_root_nodes,
        tet10_upper_t6,
    )
    from tpufem_torch.mesher import structured_wing_mesh
    from tpufem_torch.sets import build_boundary_sets

    m = structured_wing_mesh(*PARAMS, RES_UNEVEN)
    t10 = tet10_from_tet4(m)
    upper = tet10_upper_t6(t10, build_boundary_sets(m).surf_upper_faces)
    u_ref, _, _, _, conv = solve_tet10_case(
        t10, tet10_root_nodes(t10), upper, pressure=200.0, tol=1e-10, maxiter=30000,
        dtype=torch.float64, nj2=2 * (RES_UNEVEN.n_span + 1) - 1, device="cpu")
    assert conv
    for r in runs[2]:
        out = r[2]
        assert out["rel"] <= 1e-10
        assert _rel(out["u"], np.asarray(u_ref)) < 1e-8


def test_node_sharded_pcg_matches_tpufem(runs, ref_res):
    for r in runs[2]:
        assert _rel(r[3]["u"], ref_res) < 1e-7


def test_node_sharded_pcg_takes_f64_only():
    from tpufem_torch.parallel.meshes import make_mesh

    with pytest.raises(TypeError, match="f64"):
        sharded_pcg_solve(make_mesh(1, "gloo", "cpu"), np.zeros((4, 3), np.float32),
                          np.zeros((1, 4), np.int32), np.zeros((1, 3), np.int32),
                          np.ones(12), 1.0, 1.0, 1.0)


# ---------------------------------------------------------- data parallel


def test_dp_step_equals_single_process_step(runs, graphs4):
    from tpufem_torch.parallel.meshes import make_mesh

    single = dp_train(make_mesh(1, "gloo", "cpu"), SMALL, graphs4, seed=3)
    for r in runs[2]:
        out = r[4]
        assert abs(out["losses"][0] - single["losses"][0]) <= 1e-6 * abs(single["losses"][0])
        for k, v in single["params"].items():
            assert np.abs(out["params"][k] - v).max() <= 1e-6 * np.abs(v).max(), k


def test_dp_step_equals_tpufem(runs, tpufem_dp):
    _, w1, loss = tpufem_dp
    for r in runs[2]:
        out = r[5]
        assert abs(out["losses"][0] - loss) <= 1e-5 * abs(loss)
        for k, v in w1.items():
            assert np.abs(out["params"][k] - v).max() <= 1e-5 * np.abs(v).max(), k
