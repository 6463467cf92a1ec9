"""Sparse data: synthetic graph generators and the paper's dataset presets."""

from .graphs import (
    DATASET_PRESETS,
    GraphData,
    erdos_renyi_graph,
    gcn_normalized,
    hub_row_graph,
    make_dataset,
    power_law_graph,
)

__all__ = [
    "DATASET_PRESETS",
    "GraphData",
    "erdos_renyi_graph",
    "gcn_normalized",
    "hub_row_graph",
    "make_dataset",
    "power_law_graph",
]
