"""GCN and AGNN on FlashSparse operators (paper §4.4 end-to-end case).

Counterpart of ``repro.models.gnn``:

GCN layer:   H' = σ( Â @ H @ W )                         — SpMM
AGNN layer:  P = softmax_sparse( β · cos(h_i, h_j) )      — sparse attention
             H' = P @ H                                     (q=k=ĥ, v=h,
                                                             scale=β)

The adjacency arrives either as

  * an :class:`~repro_torch.core.autodiff.ADPlan` — the AGNN layer runs the
    sparse-attention pipeline through ``attention_ad`` (``cuda`` runs the
    single-pass fused kernel, ``blocked`` the staged composition); or
  * a bare :class:`BlockedMEBCRS` — SDDMM, ``sparse_softmax`` and SpMM
    dispatch through the registry one by one.

``cfg.impl`` selects the impl of every sparse op.  Weights are
``(fan_in, fan_out)`` and applied as ``h @ w``, as in the JAX package.

Over an ``ADPlan`` every impl trains: the sparse ops are autograd
Functions whose backward runs the dispatched duality on the same kernels
(:mod:`repro_torch.core.autodiff`).  Over a bare blocked view only the
plain ``blocked`` impl has a gradient, as in the reference.
``gnn_loss`` gives the masked loss and accuracy; :func:`make_train_step`
the SGD-with-momentum step.

Precision (DESIGN.md §13): ``GNNConfig.dtype = torch.bfloat16`` runs the
model in bf16 end to end (weights, features and adjacency values in bf16,
the kernels' bf16 variants), as the reference's ``--dtype bf16``; an
``ADPlan`` built with ``precision="int8"`` runs fp32 masters with int8
adjacency values in the forward SpMMs and bf16 everywhere else.  A dense
product of a bf16 activation and an fp32 weight runs in fp32, the type
the reference promotes the pair to, and the logits go to fp32 before
the loss.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core import dispatch as sparse_dispatch
from repro_torch.core.autodiff import ADPlan, attention_ad, sddmm_ad, spmm_ad
from repro_torch.core.format import BlockedMEBCRS, resolve_device
from repro_torch.core.sddmm import with_values
from repro_torch.core.softmax import sparse_softmax

__all__ = ["GNNConfig", "Adjacency", "GCN", "AGNN", "gcn_forward",
           "agnn_forward", "gnn_loss", "make_train_step", "params_from_jax"]

Adjacency = Union[ADPlan, BlockedMEBCRS]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "gcn"              # "gcn" | "agnn"
    in_dim: int = 128
    hidden_dim: int = 128           # paper: 128 (GCN), 32 (AGNN)
    num_classes: int = 16
    num_layers: int = 5             # paper: 5-layer GCN
    impl: str = "blocked"           # "blocked" | "cuda" | "cuda_balanced"
    #                                 | "cuda_tuned"
    dtype: torch.dtype = torch.float32


def _dense_init(rng: np.random.Generator, fan_in: int, fan_out: int,
                cfg: GNNConfig, device) -> nn.Parameter:
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    w = rng.standard_normal((fan_in, fan_out)).astype(np.float32) * scale
    return nn.Parameter(torch.from_numpy(w).to(device=device, dtype=cfg.dtype))


def _aggregate(adj: Adjacency, h: torch.Tensor, cfg: GNNConfig,
               vals: torch.Tensor | None = None) -> torch.Tensor:
    """SpMM aggregation through the registry, honoring ``cfg.impl``.
    ``vals`` rebinds the sparse values (AGNN attention probabilities)."""
    if isinstance(adj, ADPlan):
        return spmm_ad(adj, adj.vals if vals is None else vals, h,
                       impl=cfg.impl)
    blocked = adj if vals is None else with_values(adj, vals)
    return sparse_dispatch.dispatch("spmm", cfg.impl, blocked, h,
                                    k_blk=blocked.k_blk)


def _edge_scores(adj: Adjacency, q: torch.Tensor, k: torch.Tensor,
                 cfg: GNNConfig) -> torch.Tensor:
    """SDDMM through the registry, honoring ``cfg.impl``."""
    if isinstance(adj, ADPlan):
        return sddmm_ad(adj, q, k, impl=cfg.impl)
    return sparse_dispatch.dispatch("sddmm", cfg.impl, adj, q, k,
                                    k_blk=adj.k_blk)


def _matmul(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` in the promoted type of the pair (a bf16 aggregation under
    an int8 plan meets fp32 weights), as the reference's ``h @ w``."""
    dtype = torch.promote_types(h.dtype, w.dtype)
    return h.to(dtype) @ w.to(dtype)


def gcn_forward(params: Dict, adj: Adjacency, x: torch.Tensor,
                cfg: GNNConfig) -> torch.Tensor:
    """GCN logits; ``params = {"w": [(fan_in, fan_out), ...]}``."""
    h = x
    n_layers = len(params["w"])
    for i, w in enumerate(params["w"]):
        h = _aggregate(adj, h, cfg)             # feature aggregation (SpMM)
        h = _matmul(h, w)                       # feature update (dense)
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def agnn_forward(params: Dict, adj: Adjacency, x: torch.Tensor,
                 cfg: GNNConfig) -> torch.Tensor:
    """AGNN logits; ``params = {"w_in", "beta": [0-d, ...], "w_out"}``."""
    h = torch.relu(_matmul(x, params["w_in"]))
    for beta in params["beta"]:
        hn = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                             min=1e-6)
        if isinstance(adj, ADPlan):
            # softmax(β·cos) aggregation is the sparse-attention pipeline
            # with q = k = ĥ, v = h, scale = β.
            h = attention_ad(adj, hn, hn, h, scale=beta, impl=cfg.impl)
        else:
            scores = _edge_scores(adj, hn, hn, cfg)      # cosine via SDDMM
            p = sparse_softmax(adj, beta * scores)
            h = _aggregate(adj, h, cfg, vals=p.to(h.dtype))
    return _matmul(h, params["w_out"])


class GCN(nn.Module):
    """GCN with weights initialised from ``seed`` (numpy), on ``device``
    (the card unless ``device`` says otherwise)."""

    def __init__(self, cfg: GNNConfig, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        dims = ([cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
                + [cfg.num_classes])
        self.cfg = cfg
        self.w = nn.ParameterList([_dense_init(rng, dims[i], dims[i + 1],
                                               cfg, device)
                                   for i in range(cfg.num_layers)])

    def params(self) -> Dict:
        return {"w": list(self.w)}

    def forward(self, adj: Adjacency, x: torch.Tensor) -> torch.Tensor:
        return gcn_forward(self.params(), adj, x, self.cfg)


class AGNN(nn.Module):
    """AGNN with weights initialised from ``seed`` (numpy) and β = 1, on
    ``device`` (the card unless ``device`` says otherwise)."""

    def __init__(self, cfg: GNNConfig, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.cfg = cfg
        self.w_in = _dense_init(rng, cfg.in_dim, cfg.hidden_dim, cfg, device)
        self.beta = nn.ParameterList([
            nn.Parameter(torch.ones((), dtype=cfg.dtype, device=device))
            for _ in range(cfg.num_layers)])
        self.w_out = _dense_init(rng, cfg.hidden_dim, cfg.num_classes, cfg,
                                 device)

    def params(self) -> Dict:
        return {"w_in": self.w_in, "beta": list(self.beta),
                "w_out": self.w_out}

    def forward(self, adj: Adjacency, x: torch.Tensor) -> torch.Tensor:
        return agnn_forward(self.params(), adj, x, self.cfg)


def gnn_loss(params: Dict, adj: Adjacency, x: torch.Tensor,
             labels: torch.Tensor, train_mask: torch.Tensor, cfg: GNNConfig):
    """Masked mean cross-entropy and accuracy of the model's logits."""
    fwd = gcn_forward if cfg.model == "gcn" else agnn_forward
    logits = fwd(params, adj, x, cfg).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    denom = torch.clamp(train_mask.sum(), min=1)
    loss = (nll * train_mask).sum() / denom
    acc = ((logits.argmax(-1) == labels) * train_mask).sum() / denom
    return loss, acc


def make_train_step(cfg: GNNConfig, model: nn.Module, lr: float = 1e-2):
    """GNN train step — delegates to :mod:`repro_torch.train.train_step`,
    which checks ``cfg.impl``'s ``differentiable`` capability in the
    registry before the first step."""
    from repro_torch.train.train_step import make_gnn_train_step

    return make_gnn_train_step(cfg, model, lr=lr)


def params_from_jax(cfg: GNNConfig, params: Dict, *, device=None) -> nn.Module:
    """The port's module holding the JAX package's parameters, so both
    compute the same function.

    ``params`` is the JAX parameter pytree with numpy arrays as leaves:
    ``{"w": [...]}`` for GCN, ``{"w_in", "beta": [0-d], "w_out"}`` for
    AGNN.  bf16 leaves (``ml_dtypes.bfloat16`` arrays, which torch does not
    read) pass through float32, which holds every bf16 value exactly.
    """
    model = (GCN if cfg.model == "gcn" else AGNN)(cfg, device=device)
    if cfg.model == "gcn":
        pairs = list(zip(model.w, params["w"]))
        if len(params["w"]) != len(model.w):
            raise ValueError(f"expected {len(model.w)} GCN weights, got "
                             f"{len(params['w'])}")
    else:
        pairs = ([(model.w_in, params["w_in"]), (model.w_out, params["w_out"])]
                 + list(zip(model.beta, params["beta"])))
        if len(params["beta"]) != len(model.beta):
            raise ValueError(f"expected {len(model.beta)} AGNN betas, got "
                             f"{len(params['beta'])}")
    with torch.no_grad():
        for p, arr in pairs:
            arr = np.asarray(arr)
            if arr.dtype.kind not in "fiub":     # ml_dtypes.bfloat16
                arr = arr.astype(np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"parameter shape {tuple(arr.shape)} does "
                                 f"not match the model's {tuple(p.shape)}")
            p.copy_(torch.tensor(arr))
    return model
