"""Data pipelines: deterministic synthetic LM batches
(:mod:`repro_torch.data.synthetic`) and the real-matrix datasets, the
MatrixMarket / edge-list loaders and the vendored sample set
(:mod:`repro_torch.data.datasets`)."""

from . import datasets
from .datasets import (MatrixSample, load_edgelist, load_manifest, load_mtx,
                       load_vendored, loads_edgelist, loads_mtx, save_mtx,
                       vendored_dir, vendored_names)
from .synthetic import SyntheticLMData, input_specs, make_batch

__all__ = [
    "MatrixSample",
    "SyntheticLMData",
    "datasets",
    "input_specs",
    "load_edgelist",
    "load_manifest",
    "load_mtx",
    "load_vendored",
    "loads_edgelist",
    "loads_mtx",
    "make_batch",
    "save_mtx",
    "vendored_dir",
    "vendored_names",
]
