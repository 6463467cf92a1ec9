"""Training: the GNN train step and the ``gnn_train`` smoke."""
