"""The benchmark of the PyTorch and CUDA port: full-graph GNN training
cells on one card, driven by ``BENCHMARK.json`` (``perfbench/run.py``)."""
