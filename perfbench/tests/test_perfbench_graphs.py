"""The frozen generator against the program's ``make_dataset`` (a test
may import the program; the harness does not), and the cache."""

import numpy as np
import pytest

from perfbench import graphs

from repro_torch.sparse.graphs import DATASET_PRESETS, make_dataset


def _spec(name, scale, seed=0):
    nodes, deg, kind = DATASET_PRESETS[name]
    spec = {"name": name, "generator": kind, "avg_degree": deg,
            "num_nodes": max(int(nodes * scale), 16), "seed": seed,
            "self_loops": True, "normalize": True}
    if kind == "power_law":
        spec["alpha"] = 1.8
    return spec


@pytest.mark.parametrize("name,seed", [("Amazon", 0), ("Reddit", 0),
                                       ("Amazon", 3), ("DD", 0)])
def test_generator_matches_make_dataset(name, seed):
    want = make_dataset(name, 0.01, seed=seed)
    n, rows, cols, vals = graphs.generate(_spec(name, 0.01, seed))
    assert n == want.num_nodes
    np.testing.assert_array_equal(rows, want.rows)
    np.testing.assert_array_equal(cols, want.cols)
    np.testing.assert_array_equal(vals, want.vals)


def test_coalesce_sums_repeated_coordinates():
    rows, cols, vals = graphs.coalesce(
        4, np.array([2, 0, 2, 1]), np.array([2, 3, 2, 0]),
        np.array([0.5, 1.0, 0.25, 2.0], np.float32))
    np.testing.assert_array_equal(rows, [0, 1, 2])
    np.testing.assert_array_equal(cols, [3, 0, 2])
    np.testing.assert_array_equal(vals, [1.0, 2.0, 0.75])


def test_cache_round_trip(tmp_path):
    spec = _spec("Amazon", 0.005)
    first, generated = graphs.load_graph(spec, tmp_path)
    path = graphs.cache_path(spec, tmp_path)
    assert generated and path.exists() and list(tmp_path.iterdir()) == [path]
    again, generated = graphs.load_graph(spec, tmp_path)
    assert not generated
    for a, b in ((first.rows, again.rows), (first.cols, again.cols),
                 (first.vals, again.vals)):
        np.testing.assert_array_equal(a, b)
    # coalesced: sorted by (row, col), no repeats
    keys = first.rows.astype(np.int64) * first.num_nodes + first.cols
    assert (np.diff(keys) > 0).all()
    other = dict(spec, seed=1)
    assert graphs.cache_path(other, tmp_path) != path
