"""GNN train step (paper §4.4 end-to-end case).

Counterpart of the GNN part of ``repro.train.train_step``.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["make_gnn_train_step"]


def make_gnn_train_step(cfg, model: nn.Module, lr: float = 1e-2):
    """SGD-with-momentum train step for a GNN ``model`` (``GCN``/``AGNN``).

    Checks ``cfg.impl`` against the sparse-op registry first: the impl must
    carry the ``differentiable`` capability flag (``blocked`` natively; the
    ``cuda`` impls through the autograd Functions of
    :mod:`repro_torch.core.autodiff`, which need the adjacency as an
    ``ADPlan``).  A non-differentiable impl fails here with the list of
    usable ones.

    The update is the reference's ``mom = 0.9 * mom + g; p -= lr * mom``
    from ``mom = 0``, which is exactly ``torch.optim.SGD(lr=lr,
    momentum=0.9)`` (``dampening=0``, no Nesterov, no weight decay: its
    first step sets the buffer to ``g``).

    ``step(adj, x, labels, train_mask) -> (loss, acc)`` runs one step and
    returns the loss and accuracy before the update; the step's gradients
    stay in each parameter's ``.grad`` until the next step.
    """
    from repro_torch.core import dispatch as sparse_dispatch
    from repro_torch.core.autodiff import ADPlan
    from repro_torch.models.gnn import gnn_loss

    sparse_dispatch.require("spmm", cfg.impl, differentiable=True)
    if cfg.model == "agnn":
        sparse_dispatch.require("sddmm", cfg.impl, differentiable=True)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)

    def step(adj, x, labels, train_mask):
        # The kernel impls differentiate only through the autograd
        # Functions, which need the ADPlan's cached transpose.
        if cfg.impl != "blocked" and not isinstance(adj, ADPlan):
            raise ValueError(
                f"impl={cfg.impl!r} trains only through an ADPlan adjacency "
                f"(build one with ad_plan(fmt, impl={cfg.impl!r})); got "
                f"{type(adj).__name__}")
        opt.zero_grad(set_to_none=True)
        loss, acc = gnn_loss(model.params(), adj, x, labels, train_mask, cfg)
        loss.backward()
        opt.step()
        return loss.detach(), acc.detach()

    step.optimizer = opt
    return step
