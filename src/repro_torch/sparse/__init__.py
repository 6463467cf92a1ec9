"""Sparse data: synthetic graph generators, the paper's dataset presets
and the structure taxonomy.  Exports the reference's ``repro.sparse``
names plus the port's ``hub_row_graph``."""

from .graphs import (
    DATASET_PRESETS,
    GraphData,
    erdos_renyi_graph,
    gcn_normalized,
    hub_row_graph,
    make_dataset,
    power_law_graph,
)
from .structure import (
    STRUCTURE_CLASSES,
    classify_format,
    classify_structure,
    structure_stats,
)

__all__ = [
    "DATASET_PRESETS",
    "GraphData",
    "STRUCTURE_CLASSES",
    "classify_format",
    "classify_structure",
    "erdos_renyi_graph",
    "gcn_normalized",
    "hub_row_graph",
    "make_dataset",
    "power_law_graph",
    "structure_stats",
]
