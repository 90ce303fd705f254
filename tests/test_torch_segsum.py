"""PyTorch port: the segment-sum (the per-gaussian reduction of the payload
gradients) against the JAX package's Pallas segment-sum in interpret mode,
on the same numpy rows; and the payload gather's backward.

Tolerance: |diff| <= 1e-5 x max |sum| (the two sum in another order); the
bf16 variant rounds the same rows the same way, so it holds the same
tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu.ops import segsum as jseg
from luisacomputegaussiansplatting_tpu.ops.render import gather_payload as jgather
from luisacomputegaussiansplatting_tpu_torch.ops import segsum as pseg
from luisacomputegaussiansplatting_tpu_torch.ops.render import gather_payload

torch.set_num_threads(2)

E = jseg.E
TOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def close(port, want):
    port, want = np.asarray(port), np.asarray(want)
    assert port.shape == want.shape
    assert np.isfinite(port).all()
    scale = np.abs(want).max() + 1e-30
    assert np.abs(port - want).max() <= TOL * scale


def sorted_ids(seed, n_out, length, drop):
    """Clustered ascending ids with gaps, then ``drop`` rows in the drop bin
    (== n_out)."""
    rng = np.random.default_rng(seed)
    gid = np.sort(rng.integers(0, n_out, length - drop).astype(np.int32))
    return np.concatenate([gid, np.full(drop, n_out, np.int32)])


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_sorted_matches_jax(seed):
    n_out, length = 300, 2 * E
    gid = sorted_ids(seed, n_out, length, 100)
    rows = np.random.default_rng(seed + 10).normal(size=(length, 9)).astype(np.float32)
    want = jseg.segment_sum_sorted(jnp.asarray(gid), jnp.asarray(rows), n_out,
                                   interpret=True)
    close(pseg.segment_sum_sorted(t(gid), t(rows), n_out), want)


def test_segment_spanning_many_chunks():
    """One id whose rows straddle several of the JAX kernel's chunks."""
    n_out, length = 10, 3 * E
    gid = np.full(length, 4, np.int32)
    gid[: E // 2] = 1
    gid[-3:] = 7
    rows = np.random.default_rng(4).normal(size=(length, 9)).astype(np.float32)
    want = jseg.segment_sum_sorted(jnp.asarray(gid), jnp.asarray(rows), n_out,
                                   interpret=True)
    close(pseg.segment_sum_sorted(t(gid), t(rows), n_out), want)


def test_huge_id_gap_multi_window():
    """Ids far apart (several of the JAX kernel's windows); the ids in the
    gap get exact zeros."""
    n_out, length = 5 * E, E
    gid = np.sort(np.concatenate([np.zeros(E // 2, np.int32),
                                  np.full(E // 2, n_out - 1, np.int32)]))
    rows = np.arange(length * 2, dtype=np.float32).reshape(length, 2)
    want = jseg.segment_sum_sorted(jnp.asarray(gid), jnp.asarray(rows), n_out,
                                   interpret=True)
    out = pseg.segment_sum_sorted(t(gid), t(rows), n_out)
    close(out, want)
    assert torch.all(out[1:n_out - 1] == 0.0)


def _ascending(*parts):
    return np.sort(np.concatenate(parts)).astype(np.int32)


_rng = np.random.default_rng(21)
#: (ascending ids, n_out) for the segment starts: the clustered ids of the
#: segment-sum tests, then ids < 0, ids >= n_out, ids with no rows at both
#: ends, and no rows at all
STARTS_CASES = {
    "clustered0": (sorted_ids(0, 300, 2 * E, 100), 300),
    "clustered1": (sorted_ids(1, 300, 2 * E, 100), 300),
    "negative": (_ascending(np.full(7, -1), np.full(3, -5),
                            _rng.integers(0, 40, 200)), 40),
    "beyond": (_ascending(_rng.integers(0, 40, 200), np.full(9, 40),
                          np.full(4, 57)), 40),
    "empty_ends": (_ascending(_rng.integers(20, 44, 300)), 64),
    "zero_rows": (np.zeros(0, np.int32), 10),
}


@pytest.mark.parametrize("case", sorted(STARTS_CASES))
def test_segment_starts_match_jnp_searchsorted(case):
    """The plain version of the kernel's first pass is the lower bound of
    every id in [0, n_out], as the JAX kernel's window cuts take it; the
    rows of id g are exactly [starts[g], starts[g + 1])."""
    ids, n_out = STARTS_CASES[case]
    want = jnp.searchsorted(jnp.asarray(ids),
                            jnp.arange(n_out + 1, dtype=jnp.int32),
                            side="left")
    got = pseg.segment_starts_reference(t(ids), n_out)
    assert got.dtype == torch.int32 and got.shape == (n_out + 1,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    starts = got.numpy()
    for g in range(n_out):
        assert np.all(ids[starts[g]:starts[g + 1]] == g)
    assert starts[n_out] - starts[0] == int(((ids >= 0) & (ids < n_out)).sum())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_every_row_dropped_matches_jax(dtype):
    """Every id is -1 (NaN rows, dropped by the reduction) or, sorted, the
    drop bin n_out: every sum is exactly zero, as in the JAX package."""
    n_out, length = 50, 3000
    gid = np.full(length, -1, np.int32)
    rows = np.full((length, 9), np.nan, np.float32)
    want = jseg.reduce_fields_by_id(
        jnp.asarray(gid), tuple(jnp.asarray(rows[:, i]) for i in range(9)),
        n_out, interpret=True, dtype=dtype)
    got = pseg.reduce_fields_by_id(t(gid), t(rows.T), n_out, dtype=dtype)
    close(got, want)
    assert torch.all(got == 0)
    binned = np.full(length, n_out, np.int32)
    finite = np.random.default_rng(5).normal(size=(length, 9)).astype(np.float32)
    want = jseg.segment_sum_sorted(jnp.asarray(binned), jnp.asarray(finite),
                                   n_out, interpret=True)
    got = pseg.segment_sum_sorted(t(binned), t(finite), n_out, dtype)
    close(got, want)
    assert torch.all(got == 0)


def invalid_rows(seed, n_out, length):
    """Unsorted ids in [-1, n_out) and normal rows, NaN where the id is -1
    (garbage that must not leak into any sum)."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(-1, n_out, length).astype(np.int32)
    rows = rng.normal(size=(length, 9)).astype(np.float32)
    rows[gid == -1] = np.nan
    return gid, rows


def test_reduce_rows_by_id_with_invalid_matches_jax():
    gid, rows = invalid_rows(3, 64, 5000)
    want = jseg.reduce_rows_by_id(jnp.asarray(gid), jnp.asarray(rows), 64,
                                  interpret=True)
    close(pseg.reduce_rows_by_id(t(gid), t(rows), 64), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", ["ride", "rowgather"])
def test_reduce_fields_by_id_matches_jax(dtype, method):
    n_out = 200
    gid, rows = invalid_rows(9, n_out, 9000)
    fields = [rows[:, i] for i in range(9)]
    want = jseg.reduce_fields_by_id(
        jnp.asarray(gid), tuple(jnp.asarray(f) for f in fields), n_out,
        interpret=True, dtype=dtype, method=method)
    # a sequence of fields and one (cols, L) tensor give the same sums
    got = pseg.reduce_fields_by_id(t(gid), [t(f) for f in fields], n_out,
                                   dtype=dtype, method=method)
    close(got, want)
    assert torch.equal(got, pseg.reduce_fields_by_id(t(gid), t(rows.T), n_out,
                                                     dtype=dtype,
                                                     method=method))


def test_bf16_rounds_each_row_before_the_add():
    """Two rows of 1 + 2^-10 round to 1 each in bf16: the sum is 2, not
    2 + 2^-9."""
    gid = torch.zeros(2, dtype=torch.int32)
    rows = torch.full((2, 1), 1.0 + 2.0**-10)
    assert float(pseg.reduce_rows_by_id(gid, rows, 1, dtype="bf16")) == 2.0
    assert float(pseg.reduce_rows_by_id(gid, rows, 1)) == 2.0 + 2.0**-9


def test_bad_arguments_raise():
    gid = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        pseg.reduce_rows_by_id(gid, torch.zeros(4, 9), 2, dtype="f16")
    with pytest.raises(ValueError, match="method"):
        pseg.reduce_fields_by_id(gid, torch.zeros(9, 4), 2, method="scan")
    with pytest.raises(ValueError, match="columns"):
        pseg.reduce_rows_by_id(gid, torch.zeros(4, 17), 2)
    with pytest.raises(ValueError, match="CUDA"):
        pseg.segment_sum_kernel(gid.to("meta"), torch.zeros(4, 9, device="meta"), 2)


@pytest.mark.parametrize("reduce_dtype", ["f32", "bf16"])
def test_gather_payload_backward_matches_jax(reduce_dtype):
    """The payload gather's VJP: per-gaussian sums of the cotangent rows,
    padding slots (gid -1) dropped even where the cotangent is NaN."""
    rng = np.random.default_rng(7)
    n, cap = 37, 4096
    table = rng.normal(size=(n, 9)).astype(np.float32)
    gid = np.where(rng.random(cap) < 0.2, -1,
                   rng.integers(0, n, cap)).astype(np.int32)
    ct = rng.normal(size=(16, cap)).astype(np.float32)
    ct[:, gid < 0] = np.nan

    def jloss(tab):
        out = jgather(tab, jnp.asarray(gid), n, reduce_dtype)
        return jnp.sum(jnp.where(jnp.isnan(ct), 0.0, out * ct))

    import jax

    want = jax.grad(jloss)(jnp.asarray(table))
    x = t(table).requires_grad_()
    payload = gather_payload(x, t(gid), reduce_dtype=reduce_dtype)
    payload.backward(t(ct[:9]))
    close(x.grad.numpy(), want)
