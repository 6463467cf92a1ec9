"""Format parity: the PyTorch port's ME-BCRS builders against the JAX
package's, array for array, on every vendored matrix."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.core as jcore
from repro.core.autodiff import ad_plan as jax_ad_plan
from repro.core.validate import ValidationError as JaxValidationError
from repro.data.datasets import load_vendored, vendored_names
from repro_torch.core import format as tf
from repro_torch.core.autodiff import ad_plan
from repro_torch.core.validate import ValidationError

VENDORED = vendored_names()
CANONICAL = ("row_pointers", "column_indices", "values", "mask")
BLOCKED = ("vals", "cols", "mask", "block_win", "win_ptr")


def _same(port, ref, fields):
    for f in fields:
        got, want = getattr(port, f).cpu().numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _check_all(rows, cols, vals, shape, v=8, k_blk=8, duplicates="sum"):
    port = tf.from_coo(rows, cols, vals, shape, vector_size=v,
                       duplicates=duplicates)
    ref = jcore.from_coo(rows, cols, vals, shape, vector_size=v,
                         duplicates=duplicates)
    _same(port, ref, CANONICAL)
    assert port.shape == ref.shape and port.nnz == ref.nnz
    _same(port.transpose(), ref.transpose(), CANONICAL)
    assert port.transpose() is port.transpose()            # memoized
    _same(tf.block_format(port, k_blk, device="cpu"),
          jcore.block_format(ref, k_blk), BLOCKED)
    plan = ad_plan(port, impl="blocked", k_blk=k_blk, device="cpu")
    jplan = jax_ad_plan(ref, impl="blocked", k_blk=k_blk)
    _same(plan.fwd, jplan.fwd, BLOCKED)
    _same(plan.bwd, jplan.bwd, BLOCKED)
    np.testing.assert_array_equal(plan.perm.numpy(), np.asarray(jplan.perm))
    return port, plan


@pytest.mark.parametrize("duplicates", ["sum", "error"])
@pytest.mark.parametrize("name", VENDORED)
def test_vendored_matrix_arrays_equal_jax(name, duplicates):
    s = load_vendored([name])[0]
    _check_all(s.rows, s.cols, s.vals, s.shape, duplicates=duplicates)


@pytest.mark.parametrize("name", VENDORED)
def test_vendored_matrix_v16_kblk4_arrays_equal_jax(name):
    s = load_vendored([name])[0]
    _check_all(s.rows, s.cols, s.vals, s.shape, v=16, k_blk=4)


def test_all_empty_matrix_has_one_unowned_dummy_block():
    empty = np.zeros(0, np.int64)
    port, plan = _check_all(empty, empty, np.zeros(0, np.float32), (20, 13))
    blocked = plan.fwd
    assert blocked.num_blocks == 1 and int(blocked.win_ptr[-1]) == 0
    assert not bool(blocked.mask.any())


def test_duplicates_are_summed_like_jax():
    rows = np.array([0, 3, 3, 9, 0, 3])
    cols = np.array([1, 2, 2, 4, 1, 5])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 0.5, -1.0], np.float32)
    port, _ = _check_all(rows, cols, vals, (12, 6))
    dense = tf.to_dense(port).numpy()
    assert dense[0, 1] == 1.5 and dense[3, 2] == 5.0


def test_duplicates_error_raises_the_same_invariant():
    rows, cols = np.array([0, 0]), np.array([1, 1])
    vals = np.ones(2, np.float32)
    with pytest.raises(JaxValidationError) as jerr:
        jcore.from_coo(rows, cols, vals, (4, 4), duplicates="error")
    with pytest.raises(ValidationError) as err:
        tf.from_coo(rows, cols, vals, (4, 4), duplicates="error")
    assert err.value.invariant == jerr.value.invariant == "duplicate-coords"


@pytest.mark.parametrize("rows, cols", [([0, 4], [1, 1]), ([0, -1], [1, 1]),
                                        ([0, 1], [4, 1])])
def test_out_of_bounds_coo_raises(rows, cols):
    with pytest.raises(ValidationError) as err:
        tf.from_coo(np.array(rows), np.array(cols), np.ones(2), (4, 4))
    assert err.value.invariant == "coo-in-bounds"


@pytest.mark.parametrize("k_blk", [0, 4097, 2.0])
def test_block_config_raises(k_blk):
    fmt = tf.from_dense(np.eye(8, dtype=np.float32))
    with pytest.raises(ValidationError) as err:
        tf.block_format(fmt, k_blk, device="cpu")
    assert err.value.invariant == "block-config"


def test_from_dense_to_dense_round_trip_and_dtype():
    rng = np.random.default_rng(3)
    a = (rng.random((37, 29)) < 0.2) * rng.standard_normal((37, 29))
    fmt = tf.from_dense(a)                      # float64 → float32, as JAX
    assert fmt.values.dtype == torch.float32
    assert np.asarray(jcore.from_dense(a).values).dtype == np.float32
    np.testing.assert_allclose(tf.to_dense(fmt).numpy(), a.astype(np.float32))
    np.testing.assert_allclose(tf.to_dense(fmt).numpy(),
                               np.asarray(jcore.to_dense(jcore.from_dense(a))))


def test_to_coo_matches_jax_for_both_views():
    rng = np.random.default_rng(4)
    a = ((rng.random((30, 30)) < 0.15) * rng.standard_normal((30, 30))
         ).astype(np.float32)
    fmt, jfmt = tf.from_dense(a), jcore.from_dense(a)
    pairs = [(fmt, jfmt), (tf.block_format(fmt, 4, device="cpu"),
                           jcore.block_format(jfmt, 4))]
    for port, ref in pairs:
        for got, want in zip(tf.to_coo(port), jcore.to_coo(ref)):
            np.testing.assert_array_equal(got, np.asarray(want))


def test_to_device_moves_every_tensor():
    fmt = tf.from_dense(np.eye(9, dtype=np.float32))
    blocked = tf.block_format(fmt, 8, device="cpu").to("cpu")
    assert all(getattr(blocked, f).device.type == "cpu" for f in BLOCKED)
    assert fmt.to("cpu").values.device.type == "cpu"


def test_transpose_values_relayout_matches_jax():
    rng = np.random.default_rng(5)
    a = ((rng.random((40, 33)) < 0.2) * rng.standard_normal((40, 33))
         ).astype(np.float32)
    plan = ad_plan(tf.from_dense(a), impl="cuda", device="cpu")
    jplan = jax_ad_plan(jcore.from_dense(a), impl="pallas")
    vals = rng.standard_normal(tuple(plan.fwd.vals.shape)).astype(np.float32)
    np.testing.assert_array_equal(
        plan.transpose_vals(torch.from_numpy(vals)).numpy(),
        np.asarray(jplan.transpose_vals(jnp.asarray(vals))))
    fmt = tf.from_dense(a)
    assert ad_plan(fmt, device="cpu") is ad_plan(fmt, device="cpu")


def test_unported_plan_impls_name_the_roadmap():
    fmt = tf.from_dense(np.eye(8, dtype=np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ad_plan(fmt, impl="cuda_balanced", device="cpu")
    with pytest.raises(ValueError, match="canonical"):
        ad_plan(tf.block_format(fmt, device="cpu"), device="cpu")


def test_jax_stays_on_the_cpu():
    assert jax.default_backend() == "cpu"
