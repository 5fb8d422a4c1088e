"""tpufem_torch.ops.segment, the three segment-sum formulations, against
tpufem.ops.segment on the CPU.

- segment_sum_plain, make_sorted_plan, segment_sum_sorted in f32 and f64,
  with unsorted and already sorted ids, with and without ids equal to
  num_segments (and one past it, and negative: they land nowhere, as in
  jax.ops.segment_sum): the sorted formulation equal to
  sorted_segment_sum_plain in f64 (tolerance 0), each against tpufem's to
  1e-6 relative in f32 and 1e-14 in f64; make_sorted_plan's arrays and
  dtypes equal tpufem's;
- incidence_gather_sum with tpufem's build_incidence pair on the COARSE wing
  against tpufem's (same tolerances), equal to the port's own CSR
  IncidencePlan through gather_accumulate, whose padded pair equals
  tpufem's arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.fem.assembly import build_incidence as jbuild_incidence
from tpufem.mesher import COARSE as JCOARSE
from tpufem.mesher import structured_wing_mesh as jstructured_wing_mesh
from tpufem.ops import segment as jseg
from tpufem_torch.fem.assembly import build_incidence, gather_accumulate, padded_incidence
from tpufem_torch.ops import segment as seg
from tpufem_torch.ops.gather_scatter import sorted_segment_sum_plain

E, N, C = 3000, 257, 5
RTOL = {np.float32: 1e-6, np.float64: 1e-14}


def close(ours: torch.Tensor, theirs, dt) -> None:
    theirs = np.asarray(theirs)
    assert ours.dtype == {np.float32: torch.float32, np.float64: torch.float64}[dt]
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                               atol=RTOL[dt] * np.abs(theirs).max())


def case(dt, order: str, dump: bool):
    rng = np.random.default_rng(7)
    ids = rng.integers(0, N, E)
    if dump:  # rows that land nowhere: ids num_segments, one past it, and negative
        ids[rng.choice(E, 60, replace=False)] = rng.choice([N, N + 1, -1], 60)
    if order == "sorted":
        ids = np.sort(ids)
    return rng.standard_normal((E, C)).astype(dt), ids


@pytest.mark.parametrize("dump", [False, True], ids=["in range", "with dump ids"])
@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_segment_formulations_match_tpufem(dt, order, dump):
    v, ids = case(dt, order, dump)
    vt, vj = torch.as_tensor(v), jnp.asarray(v)
    close(seg.segment_sum_plain(vt, ids, N), jseg.segment_sum_plain(vj, jnp.asarray(ids), N), dt)

    perm, sorted_ids = seg.make_sorted_plan(ids)
    jperm, jsorted = jseg.make_sorted_plan(ids)
    for a, b in ((perm, jperm), (sorted_ids, jsorted)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    out = seg.segment_sum_sorted(vt, perm, sorted_ids, N)
    close(out, jseg.segment_sum_sorted(vj, jnp.asarray(jperm), jnp.asarray(jsorted), N), dt)
    # the sorted formulation is the plain sorted sum of the permuted rows
    kept = (sorted_ids >= 0) & (sorted_ids < N)
    ref = sorted_segment_sum_plain(vt[perm[kept]], torch.as_tensor(sorted_ids[kept]), N)
    assert torch.equal(out, ref)
    if dt == np.float64:  # and every formulation sums the same rows
        np.testing.assert_allclose(out.numpy(), seg.segment_sum_plain(vt, ids, N).numpy(),
                                   rtol=0, atol=1e-13 * out.abs().max().item())


def test_segment_sum_takes_trailing_axes():
    v, ids = case(np.float64, "unsorted", True)
    v3 = torch.as_tensor(v.reshape(E, C, 1))
    perm, sorted_ids = seg.make_sorted_plan(ids)
    for ours, flat in ((seg.segment_sum_plain(v3, ids, N),
                        seg.segment_sum_plain(v3[..., 0], ids, N)),
                       (seg.segment_sum_sorted(v3, perm, sorted_ids, N),
                        seg.segment_sum_sorted(v3[..., 0], perm, sorted_ids, N))):
        assert ours.shape == (N, C, 1) and torch.equal(ours[..., 0], flat)


@pytest.fixture(scope="module")
def coarse():
    mesh = jstructured_wing_mesh(1.2, 0.35, 15.0, 0.10, JCOARSE)
    inc, mask = jbuild_incidence(mesh.tets, mesh.num_nodes)
    return mesh, inc, mask


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_incidence_gather_sum_matches_tpufem(coarse, dt):
    mesh, inc, mask = coarse
    v = np.random.default_rng(3).standard_normal((4 * mesh.num_tets, 3)).astype(dt)
    out = seg.incidence_gather_sum(torch.as_tensor(v), inc, mask)
    close(out, jseg.incidence_gather_sum(jnp.asarray(v), inc, mask), dt)
    # tensors in, and the port's CSR plan in place of the padded pair: the same bits
    assert torch.equal(out, seg.incidence_gather_sum(torch.as_tensor(v), torch.as_tensor(inc),
                                                     torch.as_tensor(mask)))
    plan = build_incidence(mesh.tets, mesh.num_nodes)
    assert torch.equal(out, gather_accumulate(torch.as_tensor(v), plan))
    # the node sums of the flattened connectivity, as the scatter formulation gives them
    np.testing.assert_allclose(
        out.numpy(), seg.segment_sum_plain(torch.as_tensor(v), mesh.tets.reshape(-1),
                                           mesh.num_nodes).numpy(),
        rtol=0, atol=RTOL[dt] * 10 * out.abs().max().item())


def test_padded_incidence_is_tpufem_build_incidence(coarse):
    mesh, inc, mask = coarse
    pi, pm = padded_incidence(build_incidence(mesh.tets, mesh.num_nodes))
    for a, b in ((pi, inc), (pm, mask)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
