"""Real-matrix dataset layer: MatrixMarket / edge-list loaders + vendored set.

Counterpart of ``repro.data.datasets`` (the port keeps its own copy; the
parsing is numpy only).  Three pieces:

  * a dependency-free MatrixMarket ``.mtx`` parser/writer (coordinate and
    array formats; real/integer/pattern fields; general/symmetric/
    skew-symmetric symmetries: symmetric expansion mirrors strictly
    off-diagonal entries so diagonals are never counted twice, and all
    coalescing goes through :func:`repro_torch.core.format.from_coo`'s
    ``duplicates=`` contract);
  * an OGB-style edge-list loader (``src dst [weight]`` lines, ``#``
    comments);
  * the vendored sample set under ``tests/data/`` (banded, mesh,
    block-diagonal, power-law hub, uniform; ``tests/data/manifest.json``)
    for offline runs, the set the conformance harness
    (:mod:`repro_torch.testing.conformance`) runs on.

Malformed input raises :class:`ValueError` with a line-numbered message,
the reference's messages word for word.  ``$REPRO_DATASETS_DIR`` keeps the
reference's name: it names the same files.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "MatrixSample",
    "loads_mtx",
    "load_mtx",
    "save_mtx",
    "load_edgelist",
    "loads_edgelist",
    "vendored_dir",
    "load_manifest",
    "vendored_names",
    "load_vendored",
]

_FORMATS = ("coordinate", "array")
_FIELDS = ("real", "integer", "pattern")
_SYMMETRIES = ("general", "symmetric", "skew-symmetric")

# Override of the vendored/downloaded data directory, for runs outside
# the repository layout (e.g. an installed package).
_DATA_ENV = "REPRO_DATASETS_DIR"


@dataclasses.dataclass(frozen=True)
class MatrixSample:
    """One loaded real matrix: canonical COO triplets + provenance.

    ``rows``/``cols`` are 0-based int64; symmetric inputs arrive already
    expanded (both triangles present, diagonal stored once).  ``meta``
    carries parse provenance (source format/field/symmetry, entry counts)
    and, for vendored matrices, the manifest's expected structure class.
    """

    name: str
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: Tuple[int, int]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def is_square(self) -> bool:
        return self.shape[0] == self.shape[1]

    def dense(self) -> np.ndarray:
        """Dense fp32 oracle (duplicates summed, the ``from_coo`` default)."""
        a = np.zeros(self.shape, np.float32)
        np.add.at(a, (self.rows, self.cols), self.vals.astype(np.float32))
        return a

    def to_format(self, vector_size: int = 8, dtype=None, *,
                  duplicates: str = "sum", check: Optional[str] = None):
        """Build the canonical ME-BCRS format (on the CPU) via
        :func:`repro_torch.core.format.from_coo` (``duplicates``/``check``
        forwarded: ``duplicates="error"`` treats repeated coordinates as
        a corrupted stream, the right setting for external files)."""
        import torch

        from repro_torch.core.format import from_coo

        return from_coo(self.rows, self.cols, self.vals, self.shape,
                        vector_size=vector_size,
                        dtype=dtype or torch.float32,
                        duplicates=duplicates, check=check)

    def structure_class(self) -> str:
        """Taxonomy class (:mod:`repro_torch.sparse.structure`) of this
        matrix."""
        from repro_torch.sparse.structure import (classify_structure,
                                                  structure_stats)

        return classify_structure(
            structure_stats(self.rows, self.cols, self.shape))


# ---------------------------------------------------------------------------
# MatrixMarket parser
# ---------------------------------------------------------------------------


def _bad(lineno: int, msg: str) -> ValueError:
    return ValueError(f"MatrixMarket line {lineno}: {msg}")


def _parse_header(line: str) -> Tuple[str, str, str]:
    tok = line.strip().split()
    if len(tok) < 5 or tok[0] != "%%MatrixMarket" or tok[1].lower() != "matrix":
        raise _bad(1, f"bad header {line.strip()!r}; expected "
                      "'%%MatrixMarket matrix <format> <field> <symmetry>'")
    fmt, field, symmetry = tok[2].lower(), tok[3].lower(), tok[4].lower()
    if fmt not in _FORMATS:
        raise _bad(1, f"unsupported format {fmt!r} (supported: "
                      f"{', '.join(_FORMATS)})")
    if field not in _FIELDS:
        raise _bad(1, f"unsupported field {field!r} (supported: "
                      f"{', '.join(_FIELDS)}; complex matrices are out of "
                      "scope for a real-valued SpMM suite)")
    if symmetry not in _SYMMETRIES:
        raise _bad(1, f"unsupported symmetry {symmetry!r} (supported: "
                      f"{', '.join(_SYMMETRIES)})")
    if fmt == "array" and field == "pattern":
        raise _bad(1, "array format cannot carry a pattern field")
    return fmt, field, symmetry


def _data_lines(text: str):
    """Yield ``(lineno, line)`` for non-comment, non-blank body lines."""
    for lineno, line in enumerate(text.splitlines(), start=1):
        if lineno == 1:
            continue
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        yield lineno, s


def _parse_size(lineno: int, line: str, want: int) -> List[int]:
    tok = line.split()
    if len(tok) != want:
        raise _bad(lineno, f"size line needs {want} integers, got {line!r}")
    try:
        dims = [int(t) for t in tok]
    except ValueError:
        raise _bad(lineno, f"non-integer size entry in {line!r}") from None
    if any(d < 0 for d in dims):
        raise _bad(lineno, f"negative size entry in {line!r}")
    return dims


def _expand_symmetry(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     symmetry: str, lineno_by_entry: np.ndarray):
    """Mirror the stored triangle of a symmetric/skew-symmetric matrix.

    Only strictly off-diagonal entries are mirrored — a diagonal entry is
    stored once and must stay stored once, otherwise the expansion both
    doubles the value under ``from_coo(duplicates="sum")`` and
    manufactures phantom duplicate coordinates under
    ``duplicates="error"``.  Skew-symmetric matrices mirror with negated
    values and reject explicit nonzero diagonal entries (A = −Aᵀ forces
    a zero diagonal).
    """
    if symmetry == "general":
        return rows, cols, vals
    off = rows != cols
    if symmetry == "skew-symmetric":
        bad = (~off) & (vals != 0)
        if bad.any():
            first = int(lineno_by_entry[bad][0])
            raise _bad(first, "skew-symmetric matrix carries a nonzero "
                              "diagonal entry (A = -A^T forces it to zero)")
    mirror_vals = -vals[off] if symmetry == "skew-symmetric" else vals[off]
    return (np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, mirror_vals]))


def loads_mtx(text: str, name: str = "<string>") -> MatrixSample:
    """Parse MatrixMarket text into a :class:`MatrixSample`.

    Supports coordinate and array formats, real/integer/pattern fields,
    general/symmetric/skew-symmetric symmetries (symmetric inputs come
    back fully expanded; diagonals are never duplicated).  1-based
    indices per the spec.  Every malformed construct — bad header, bad
    size line, truncated body, trailing entries, out-of-bounds or
    non-numeric coordinates — raises :class:`ValueError` naming the line.
    """
    first_nl = text.find("\n")
    header = text if first_nl < 0 else text[:first_nl]
    fmt, field, symmetry = _parse_header(header)

    body = list(_data_lines(text))
    if not body:
        raise _bad(1, "missing size line (file has no data lines)")
    size_lineno, size_line = body[0]
    entries = body[1:]

    if fmt == "coordinate":
        m, k, nnz = _parse_size(size_lineno, size_line, 3)
        want_tok = 2 if field == "pattern" else 3
        if len(entries) < nnz:
            raise _bad(size_lineno, f"truncated body: size line promises "
                                    f"{nnz} entries, found {len(entries)}")
        if len(entries) > nnz:
            raise _bad(entries[nnz][0],
                       f"trailing data: size line promises {nnz} entries, "
                       f"found {len(entries)}")
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        vals = np.ones(nnz, np.float64)
        linenos = np.empty(nnz, np.int64)
        for e, (lineno, line) in enumerate(entries):
            tok = line.split()
            if len(tok) != want_tok:
                raise _bad(lineno, f"entry needs {want_tok} tokens for a "
                                   f"{field} matrix, got {line!r}")
            try:
                i, j = int(tok[0]), int(tok[1])
                if field != "pattern":
                    vals[e] = (int(tok[2]) if field == "integer"
                               else float(tok[2]))
            except ValueError:
                raise _bad(lineno, f"non-numeric entry {line!r}") from None
            if not (1 <= i <= m and 1 <= j <= k):
                raise _bad(lineno, f"coordinate ({i}, {j}) out of bounds "
                                   f"for a {m}x{k} matrix")
            rows[e], cols[e], linenos[e] = i - 1, j - 1, lineno
        if symmetry != "general":
            above = rows < cols
            if above.any():
                first = int(linenos[above][0])
                raise _bad(first, f"{symmetry} matrix stores an upper-"
                                  "triangle entry; the spec stores the "
                                  "lower triangle only")
        rows, cols, vals = _expand_symmetry(rows, cols, vals, symmetry,
                                            linenos)
        stored = nnz
    else:  # array: column-major dense values
        m, k = _parse_size(size_lineno, size_line, 2)
        if symmetry == "general":
            want = m * k
            cc, rr = np.divmod(np.arange(want), m)
        else:
            # lower triangle (incl. diagonal), column-major per the spec
            rr, cc = np.tril_indices(m)
            order = np.lexsort((rr, cc))  # column-major walk
            rr, cc = rr[order], cc[order]
            want = rr.size
            if m != k:
                raise _bad(size_lineno, f"{symmetry} array matrix must be "
                                        f"square, got {m}x{k}")
        if len(entries) != want:
            which = "truncated body" if len(entries) < want else "trailing data"
            lineno = (entries[want][0] if len(entries) > want
                      else size_lineno)
            raise _bad(lineno, f"{which}: array size {m}x{k} "
                               f"({symmetry}) needs {want} values, found "
                               f"{len(entries)}")
        dense_vals = np.empty(want, np.float64)
        linenos = np.empty(want, np.int64)
        for e, (lineno, line) in enumerate(entries):
            tok = line.split()
            if len(tok) != 1:
                raise _bad(lineno, f"array entry must be one value, "
                                   f"got {line!r}")
            try:
                dense_vals[e] = (int(tok[0]) if field == "integer"
                                 else float(tok[0]))
            except ValueError:
                raise _bad(lineno, f"non-numeric entry {line!r}") from None
            linenos[e] = lineno
        keep = dense_vals != 0
        rows, cols, vals = rr[keep].astype(np.int64), \
            cc[keep].astype(np.int64), dense_vals[keep]
        rows, cols, vals = _expand_symmetry(rows, cols, vals, symmetry,
                                            linenos[keep])
        stored = want

    return MatrixSample(
        name=name, rows=rows, cols=cols, vals=vals.astype(np.float32),
        shape=(m, k),
        meta={"source_format": fmt, "field": field, "symmetry": symmetry,
              "stored_entries": stored})


def load_mtx(path, name: Optional[str] = None) -> MatrixSample:
    """Read a ``.mtx`` file (see :func:`loads_mtx`)."""
    path = pathlib.Path(path)
    return loads_mtx(path.read_text(),
                     name=name or path.name.removesuffix(".mtx"))


def save_mtx(path_or_buf, rows, cols, vals, shape: Tuple[int, int],
             field: str = "real", comment: Optional[str] = None) -> None:
    """Write COO triplets as MatrixMarket coordinate/general text.

    The writer half of the round-trip property tests: 0-based triplets
    in, 1-based spec-conformant text out.  ``field="pattern"`` drops the
    value column; ``"integer"`` writes integer literals.  Entries are
    written in the order given (the parser does not require sorting).
    """
    if field not in _FIELDS:
        raise ValueError(f"unsupported field {field!r} (supported: "
                         f"{', '.join(_FIELDS)})")
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    m, k = int(shape[0]), int(shape[1])
    if rows.size and (rows.min() < 0 or cols.min() < 0
                      or rows.max() >= m or cols.max() >= k):
        raise ValueError(f"COO indices out of bounds for shape {shape}")
    buf = io.StringIO()
    buf.write(f"%%MatrixMarket matrix coordinate {field} general\n")
    if comment:
        for line in comment.splitlines():
            buf.write(f"% {line}\n")
    buf.write(f"{m} {k} {rows.size}\n")
    for e in range(rows.size):
        if field == "pattern":
            buf.write(f"{rows[e] + 1} {cols[e] + 1}\n")
        elif field == "integer":
            buf.write(f"{rows[e] + 1} {cols[e] + 1} {int(vals[e])}\n")
        else:
            buf.write(f"{rows[e] + 1} {cols[e] + 1} {float(vals[e]):.17g}\n")
    text = buf.getvalue()
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(text)
    else:
        pathlib.Path(path_or_buf).write_text(text)


# ---------------------------------------------------------------------------
# Edge-list loader (OGB-style)
# ---------------------------------------------------------------------------


def loads_edgelist(text: str, name: str = "<string>",
                   num_nodes: Optional[int] = None) -> MatrixSample:
    """Parse an OGB-style edge list: ``src dst [weight]`` per line.

    0-based node ids; ``#`` starts a comment; weights default to 1.0.
    ``num_nodes`` fixes the (square) shape — omitted, it is inferred as
    ``max(id) + 1``.  Malformed lines raise :class:`ValueError` naming
    the line, like the ``.mtx`` parser.
    """
    srcs: List[int] = []
    dsts: List[int] = []
    wts: List[float] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        tok = line.replace(",", " ").split()
        if len(tok) not in (2, 3):
            raise ValueError(f"edge list line {lineno}: expected "
                             f"'src dst [weight]', got {raw.strip()!r}")
        try:
            s, d = int(tok[0]), int(tok[1])
            w = float(tok[2]) if len(tok) == 3 else 1.0
        except ValueError:
            raise ValueError(f"edge list line {lineno}: non-numeric "
                             f"token in {raw.strip()!r}") from None
        if s < 0 or d < 0:
            raise ValueError(f"edge list line {lineno}: negative node id "
                             f"in {raw.strip()!r}")
        srcs.append(s)
        dsts.append(d)
        wts.append(w)
    rows = np.asarray(srcs, np.int64)
    cols = np.asarray(dsts, np.int64)
    n = num_nodes if num_nodes is not None else (
        int(max(rows.max(), cols.max())) + 1 if rows.size else 0)
    if rows.size and (rows.max() >= n or cols.max() >= n):
        raise ValueError(f"edge list: node id "
                         f"{int(max(rows.max(), cols.max()))} out of bounds "
                         f"for num_nodes={n}")
    return MatrixSample(name=name, rows=rows, cols=cols,
                        vals=np.asarray(wts, np.float32), shape=(n, n),
                        meta={"source_format": "edgelist",
                              "stored_entries": int(rows.size)})


def load_edgelist(path, name: Optional[str] = None,
                  num_nodes: Optional[int] = None) -> MatrixSample:
    """Read an edge-list file (see :func:`loads_edgelist`)."""
    path = pathlib.Path(path)
    stem = path.name
    for suffix in (".edges", ".edgelist", ".txt"):
        stem = stem.removesuffix(suffix)
    return loads_edgelist(path.read_text(), name=name or stem,
                          num_nodes=num_nodes)


# ---------------------------------------------------------------------------
# Vendored set + download manifest
# ---------------------------------------------------------------------------


def vendored_dir() -> pathlib.Path:
    """Directory of the vendored sample set (and downloaded matrices).

    ``$REPRO_DATASETS_DIR`` wins; otherwise the repo-layout ``tests/data``
    next to the ``src`` tree this module was imported from.
    """
    env = os.environ.get(_DATA_ENV)
    if env:
        return pathlib.Path(env)
    here = pathlib.Path(__file__).resolve()
    for parent in here.parents:
        cand = parent / "tests" / "data"
        if (cand / "manifest.json").exists():
            return cand
    return pathlib.Path("tests") / "data"


def load_manifest(data_dir: Optional[os.PathLike] = None) -> Dict:
    """Load ``manifest.json``: the vendored set + the download catalog.

    Each entry: ``name``, ``structure_class`` (expected taxonomy class),
    and either ``file`` (vendored, relative to the data dir) or ``url``
    (+ optional ``extract`` member path) for ``scripts/fetch_datasets.py``
    to pull for full offline-independent runs.
    """
    data_dir = pathlib.Path(data_dir) if data_dir else vendored_dir()
    path = data_dir / "manifest.json"
    try:
        manifest = json.loads(path.read_text())
    except FileNotFoundError:
        raise FileNotFoundError(
            f"dataset manifest not found at {path}; set ${_DATA_ENV} or "
            "run from the repo checkout") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupted dataset manifest {path}: {e}") from None
    if not isinstance(manifest, dict) or "datasets" not in manifest:
        raise ValueError(f"dataset manifest {path} has no 'datasets' list")
    return manifest


def vendored_names(data_dir: Optional[os.PathLike] = None) -> List[str]:
    """Names of the manifest entries shipped in-repo (no download needed)."""
    return [d["name"] for d in load_manifest(data_dir)["datasets"]
            if d.get("file")]


def _load_entry(entry: Dict, data_dir: pathlib.Path) -> MatrixSample:
    rel = entry.get("file") or entry.get("extract") or f"{entry['name']}.mtx"
    path = data_dir / rel
    if not path.exists():
        raise FileNotFoundError(
            f"dataset {entry['name']!r} not present at {path}; vendored "
            "matrices ship with the repo, downloadable ones need "
            "`python scripts/fetch_datasets.py` first")
    if path.suffix in (".edges", ".edgelist"):
        sample = load_edgelist(path, name=entry["name"],
                               num_nodes=entry.get("num_nodes"))
    else:
        sample = load_mtx(path, name=entry["name"])
    sample.meta["structure_class"] = entry.get("structure_class")
    sample.meta["description"] = entry.get("description", "")
    return sample


def load_vendored(names: Optional[Sequence[str]] = None,
                  data_dir: Optional[os.PathLike] = None
                  ) -> List[MatrixSample]:
    """Load vendored matrices (all of them, or the named subset).

    Also loads previously *downloaded* manifest entries when they exist
    in the data dir, so a post-``fetch_datasets`` run picks up the full
    set with the same call; purely-offline runs get exactly the vendored
    files.
    """
    data_dir = pathlib.Path(data_dir) if data_dir else vendored_dir()
    manifest = load_manifest(data_dir)
    out: List[MatrixSample] = []
    known = set()
    for entry in manifest["datasets"]:
        known.add(entry["name"])
        if names is not None and entry["name"] not in names:
            continue
        if not entry.get("file"):
            rel = entry.get("extract") or f"{entry['name']}.mtx"
            if not (data_dir / rel).exists():
                if names is not None:
                    raise FileNotFoundError(
                        f"dataset {entry['name']!r} is download-only and "
                        f"not fetched yet (scripts/fetch_datasets.py)")
                continue
        out.append(_load_entry(entry, data_dir))
    if names is not None:
        missing = [n for n in names if n not in known]
        if missing:
            raise KeyError(f"unknown dataset name(s) {missing}; manifest "
                           f"knows: {sorted(known)}")
    return out
