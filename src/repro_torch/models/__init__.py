"""Models on the port's sparse operators: GCN and AGNN (paper §4.4)."""
