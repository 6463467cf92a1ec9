"""Real-matrix datasets: the MatrixMarket / edge-list loaders and the
vendored sample set (:mod:`repro_torch.data.datasets`)."""

from . import datasets
from .datasets import (MatrixSample, load_edgelist, load_manifest, load_mtx,
                       load_vendored, loads_edgelist, loads_mtx, save_mtx,
                       vendored_dir, vendored_names)

__all__ = [
    "MatrixSample",
    "datasets",
    "load_edgelist",
    "load_manifest",
    "load_mtx",
    "load_vendored",
    "loads_edgelist",
    "loads_mtx",
    "save_mtx",
    "vendored_dir",
    "vendored_names",
]
