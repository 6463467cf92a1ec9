"""Models on the port's sparse operators: GCN and AGNN (paper §4.4), and
the block-sparse attention layers (``layers``)."""
