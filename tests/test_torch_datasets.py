"""The port's dataset layer against the reference's
(``repro_torch.data.datasets`` vs ``repro.data.datasets``).

The loaders' arrays equal the reference's on every file of ``tests/data``,
the canonical formats they build hold the same numbers, and malformed
inputs raise the same line-numbered errors, word for word.
"""

import io

import numpy as np
import pytest

from repro.data import datasets as jds
from repro_torch.data import datasets as tds
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

_SIZE = "%%MatrixMarket matrix coordinate real general\n"
_MALFORMED = [
    "%%MatrixMarket matrix coordinate complex general\n2 2 1\n1 1 1\n",
    "%%MatrixMarket matrix array pattern general\n2 2\n1\n",
    _SIZE,                                         # no size line
    _SIZE + "2 x 1\n1 1 1\n",
    _SIZE + "2 2 2\n1 1 1\n",                      # truncated body
    _SIZE + "2 2 1\n1 1 1\n2 2 2\n",               # trailing data
    _SIZE + "2 2 1\n1 1 abc\n",
    _SIZE + "2 2 1\n3 1 1\n",                      # out of bounds
    "%%MatrixMarket matrix coordinate real symmetric\n3 3 1\n1 2 1\n",
    "%%MatrixMarket matrix coordinate real skew-symmetric\n2 2 1\n1 1 4\n",
    "%%MatrixMarket matrix array real general\n2 2\n1\n2\nxx\n4\n",
    "%%MatrixMarket matrix array real symmetric\n2 3\n1\n2\n3\n",
]
_BAD_EDGES = [("0 1\nnope nope\n", None), ("-1 2\n", None),
              ("0 7\n", 3), ("0 1 2 3\n", None)]


def _same_error(call_ref, call_port):
    with pytest.raises(Exception) as want:
        call_ref()
    with pytest.raises(type(want.value)) as got:
        call_port()
    assert str(got.value) == str(want.value)


def test_vendored_files_load_to_the_reference_arrays():
    names = tds.vendored_names()
    assert names == jds.vendored_names() and len(names) == 14
    assert tds.vendored_dir() == jds.vendored_dir()
    for mine, theirs in zip(tds.load_vendored(), jds.load_vendored()):
        assert mine.name == theirs.name and mine.shape == theirs.shape
        for field in ("rows", "cols", "vals"):
            got, want = getattr(mine, field), getattr(theirs, field)
            assert got.dtype == want.dtype, (mine.name, field)
            np.testing.assert_array_equal(got, want, err_msg=mine.name)
        assert mine.meta == theirs.meta
        np.testing.assert_array_equal(mine.dense(), theirs.dense())
        assert mine.structure_class() == theirs.structure_class()


def test_vendored_formats_equal_the_reference_formats():
    for mine, theirs in zip(tds.load_vendored(), jds.load_vendored()):
        f, g = mine.to_format(), theirs.to_format()
        for field in ("row_pointers", "column_indices", "values", "mask"):
            np.testing.assert_array_equal(
                getattr(f, field).numpy(), np.asarray(getattr(g, field)),
                err_msg=f"{mine.name}.{field}")


@pytest.mark.parametrize("text", _MALFORMED, ids=range(len(_MALFORMED)))
def test_malformed_matrix_market_same_line_numbered_error(text):
    _same_error(lambda: jds.loads_mtx(text), lambda: tds.loads_mtx(text))


@pytest.mark.parametrize("text,n", _BAD_EDGES, ids=range(len(_BAD_EDGES)))
def test_malformed_edge_list_same_error(text, n):
    _same_error(lambda: jds.loads_edgelist(text, num_nodes=n),
                lambda: tds.loads_edgelist(text, num_nodes=n))


def test_writer_round_trip_and_duplicates_policy():
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 9, 30), rng.integers(0, 7, 30)
    vals = rng.standard_normal(30)
    for field in ("real", "integer", "pattern"):
        mine, theirs = io.StringIO(), io.StringIO()
        tds.save_mtx(mine, rows, cols, vals, (9, 7), field=field)
        jds.save_mtx(theirs, rows, cols, vals, (9, 7), field=field)
        assert mine.getvalue() == theirs.getvalue()
        back = tds.loads_mtx(mine.getvalue())
        np.testing.assert_array_equal(back.rows, rows)
    sample = tds.loads_mtx(mine.getvalue())
    from repro_torch.core.validate import ValidationError

    if np.unique(rows * 7 + cols).size < rows.size:
        with pytest.raises(ValidationError, match="duplicate-coords"):
            sample.to_format(duplicates="error")
    np.testing.assert_array_equal(
        sample.to_format().values.numpy(),
        np.asarray(jds.loads_mtx(mine.getvalue()).to_format().values))


def test_datasets_dir_override_and_missing_manifest(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_DATASETS_DIR", str(tmp_path))
    assert tds.vendored_dir() == tmp_path
    _same_error(jds.load_manifest, tds.load_manifest)
    monkeypatch.delenv("REPRO_DATASETS_DIR")
    _same_error(lambda: jds.load_vendored(["no_such"]),
                lambda: tds.load_vendored(["no_such"]))
