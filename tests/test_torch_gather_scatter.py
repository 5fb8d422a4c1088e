"""Port parity: the sorted segment sum and mean aggregation of
tpufem_torch.ops.gather_scatter (its plain version, as on the CPU) against
tpufem's Pallas kernel in interpret mode and its XLA segment mean, in the
three cases of tests/test_pallas_ops.py, with the tolerances used there.

The CUDA kernel itself is checked against the plain version in the
gpu-marked tests of tests/test_torch_kernels.py and in chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import torch

from tpufem.models.sage import segment_mean_aggregate
from tpufem.ops.gather_scatter import gather_mean_aggregate, sorted_segment_sum_pallas
from tpufem_torch.ops import gather_scatter as tgs


def test_sorted_segment_sum_matches_pallas_random():
    rng = np.random.default_rng(0)
    E, C, N = 1000, 16, 73
    seg = np.sort(rng.integers(0, N, size=E)).astype(np.int32)
    msgs = rng.normal(size=(E, C)).astype(np.float32)
    pallas = np.asarray(sorted_segment_sum_pallas(jnp.asarray(msgs), jnp.asarray(seg), N, True))
    before = tgs.sorted_segment_sum.launches
    out = tgs.sorted_segment_sum(torch.as_tensor(msgs), torch.as_tensor(seg), N).numpy()
    assert tgs.sorted_segment_sum.launches == before  # the CPU takes the plain version
    ref = np.zeros((N, C), dtype=np.float64)
    np.add.at(ref, seg, msgs.astype(np.float64))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, pallas, rtol=1e-4, atol=1e-4)


def test_sorted_segment_sum_gaps_and_dump_rows():
    # large id gaps, and rows in the dump segment (id == num_segments)
    seg = np.array([0, 0, 5, 5, 5, 60, 61, 61, 64, 64], dtype=np.int32)
    msgs = np.arange(10, dtype=np.float32).reshape(-1, 1) + 1
    N = 64
    pallas = np.asarray(sorted_segment_sum_pallas(jnp.asarray(msgs), jnp.asarray(seg), N, True))
    out = tgs.sorted_segment_sum(torch.as_tensor(msgs), torch.as_tensor(seg), N).numpy()
    assert out.shape == (N, 1)
    assert out[0, 0] == 3.0 and out[5, 0] == 12.0 and out[60, 0] == 6.0 and out[61, 0] == 15.0
    assert out[1:5].sum() == 0 and out[62:].sum() == 0  # dump rows 9, 10 land nowhere
    np.testing.assert_array_equal(out, pallas)


def test_gather_mean_matches_with_masked_edges():
    rng = np.random.default_rng(1)
    N, E, C = 50, 400, 8
    h = rng.normal(size=(N, C)).astype(np.float32)
    ei = rng.integers(0, N, size=(2, E)).astype(np.int32)
    em = (rng.uniform(size=E) > 0.2).astype(np.float32)
    ref = np.asarray(segment_mean_aggregate(jnp.asarray(h), jnp.asarray(ei), jnp.asarray(em), N))
    pallas = np.asarray(gather_mean_aggregate(jnp.asarray(h), jnp.asarray(ei), jnp.asarray(em), N))
    plan = tgs.aggregation_plan(torch.as_tensor(ei), torch.as_tensor(em), N)
    out = tgs.gather_mean_aggregate(torch.as_tensor(h), plan).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out, pallas, rtol=2e-4, atol=2e-5)
