"""Card-only checks of the port's CUDA kernels (marker ``gpu``).

Each kernel against its plain PyTorch version on the card (the balanced
ones over split schedules, with one and two heads), the launch counters,
the refusals of the wrappers, and gradients of a train step against the
plain ``blocked`` impl.  They skip on a host without a CUDA device; on
one, run

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import ad_plan, block_format, from_dense
from repro_torch.core.sddmm import with_values
from repro_torch.kernels import (attention_balanced_cuda,
                                 attention_balanced_plain, attention_cuda,
                                 attention_plain, sddmm_balanced_cuda,
                                 sddmm_balanced_plain, sddmm_cuda,
                                 sddmm_plain, spmm_balanced_cuda,
                                 spmm_balanced_plain, spmm_cuda, spmm_plain)
from repro_torch.models import gnn

pytestmark = pytest.mark.gpu

# fp32 kernel against fp32 plain version, sums in another order.
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _matrix(rng, m, k, density, empty_rows=()):
    a = ((rng.random((m, k)) < density) * rng.standard_normal((m, k))
         ).astype(np.float32)
    a[list(empty_rows)] = 0.0
    return a


# (M, K, density, empty rows, V, k_blk, N, F, DV)
CASES = [
    (100, 90, 0.1, range(16, 40), 8, 8, 200, 24, 40),
    (45, 45, 0.2, (), 8, 8, 20, 32, 32),
    (64, 64, 0.15, (), 8, 4, 130, 7, 5),
    (64, 64, 0.3, (), 8, 16, 64, 33, 65),
    (300, 1000, 0.05, (), 8, 8, 128, 32, 32),
    (77, 77, 0.2, (), 16, 8, 96, 24, 40),
    (50, 61, 0.25, (), 16, 4, 33, 16, 16),
    (30, 30, 0.0, (), 8, 8, 40, 8, 8),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}")
def test_kernels_match_plain_on_card(device, case):
    m, k, density, empty, v, k_blk, n, f, dv = case
    rng = np.random.default_rng(m * k)
    a = _matrix(rng, m, k, density, empty)
    blocked = block_format(from_dense(a, vector_size=v), k_blk, device=device)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    b, q, kk, vv = t(k, n), t(m, f), t(k, f), t(k, dv)
    torch.testing.assert_close(spmm_cuda(blocked, b), spmm_plain(blocked, b),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(sddmm_cuda(blocked, q, kk),
                               sddmm_plain(blocked, q, kk), rtol=RTOL, atol=ATOL)
    scale = torch.tensor(0.8, device=device)
    torch.testing.assert_close(attention_cuda(blocked, q, kk, vv, scale=scale),
                               attention_plain(blocked, q, kk, vv, scale=scale),
                               rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()


def test_each_wrapper_counts_its_launches(device):
    blocked = block_format(from_dense(np.eye(16, dtype=np.float32)), 8,
                           device=device)
    x = torch.ones(16, 8, device=device)
    before = (spmm_cuda.launches, sddmm_cuda.launches, attention_cuda.launches)
    spmm_cuda(blocked, x)
    sddmm_cuda(blocked, x, x)
    attention_cuda(blocked, x, x, x)
    spmm_plain(blocked, x)
    assert (spmm_cuda.launches, sddmm_cuda.launches,
            attention_cuda.launches) == tuple(c + 1 for c in before)


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    fmt = from_dense(np.eye(16, dtype=np.float32))
    blocked = block_format(fmt, 8, device=device)
    x = torch.ones(16, 8, device=device)
    with pytest.raises(ValueError, match="n_blk"):
        spmm_cuda(blocked, x, n_blk=48)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_cuda(blocked, torch.ones(8, 16, device=device).T)
    with pytest.raises(ValueError, match="CUDA device"):
        spmm_cuda(blocked, x.cpu())
    with pytest.raises(ValueError, match="vector_size"):
        spmm_cuda(block_format(from_dense(np.eye(16, dtype=np.float32),
                                          vector_size=4), 8, device=device), x)
    wide = torch.ones(16, 8192, device=device)
    with pytest.raises(RuntimeError, match="attention kernel launch failed"):
        attention_cuda(blocked, wide, wide, wide)
    # the refused launch leaves no error behind for the next one
    attention_cuda(blocked, x, x, x)
    torch.cuda.synchronize()


def test_gcn_forward_on_card_matches_blocked(device):
    rng = np.random.default_rng(0)
    a = _matrix(rng, 200, 200, 0.03) + np.eye(200, dtype=np.float32)
    plan = ad_plan(from_dense(a), impl="cuda", device=device)
    cfg = gnn.GNNConfig(in_dim=32, hidden_dim=32, num_classes=4,
                        num_layers=3, impl="cuda")
    model = gnn.GCN(cfg, device=device)
    x = torch.from_numpy(rng.standard_normal((200, 32)).astype(np.float32)).to(device)
    with torch.inference_mode():
        got = model(plan, x)
        want = gnn.gcn_forward(model.params(), plan, x,
                               gnn.GNNConfig(in_dim=32, hidden_dim=32,
                                             num_classes=4, num_layers=3))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("split", [0, 1, 3])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}")
def test_balanced_kernels_match_plain_on_card(device, case, h, split):
    m, k, density, empty, v, k_blk, n, f, dv = case
    rng = np.random.default_rng(m * k + h)
    a = _matrix(rng, m, k, density, empty)
    blocked = block_format(from_dense(a, vector_size=v), k_blk, device=device)
    sched = blocked.schedule(split)
    hs = (h,) if h > 1 else ()

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    # two heads: per-head vals, B, Q, V; shared K
    bv = with_values(blocked, t(*hs, *blocked.vals.shape) * blocked.mask)
    b, q, kk, vv = t(*hs, k, n), t(*hs, m, f), t(k, f), t(*hs, k, dv)
    torch.testing.assert_close(spmm_balanced_cuda(bv, b, schedule=sched),
                               spmm_balanced_plain(bv, b, sched),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(sddmm_balanced_cuda(blocked, q, kk,
                                                   schedule=sched),
                               sddmm_balanced_plain(blocked, q, kk, sched),
                               rtol=RTOL, atol=ATOL)
    scale = torch.tensor(0.8, device=device)
    torch.testing.assert_close(
        attention_balanced_cuda(blocked, q, kk, vv, scale=scale,
                                schedule=sched),
        attention_balanced_plain(blocked, q, kk, vv, sched, scale),
        rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()


def test_all_empty_matrix_launches_no_balanced_sddmm(device):
    blocked = block_format(from_dense(np.zeros((30, 30), np.float32)), 8,
                           device=device)
    x = torch.ones(30, 8, device=device)
    before = sddmm_balanced_cuda.launches
    out = sddmm_balanced_cuda(blocked, x, x)
    assert sddmm_balanced_cuda.launches == before
    assert out.shape == blocked.vals.shape and not out.any()
    assert not spmm_balanced_cuda(blocked, x).any()
    assert not attention_balanced_cuda(blocked, x, x, x).any()


@pytest.mark.parametrize("impl", ["cuda", "cuda_balanced"])
@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_train_step_gradients_on_card_match_blocked(device, model, impl):
    rng = np.random.default_rng(1)
    a = _matrix(rng, 300, 300, 0.02) + np.eye(300, dtype=np.float32)
    fmt = from_dense(a)
    x = torch.from_numpy(rng.standard_normal((300, 32)).astype(np.float32)).to(device)
    kw = dict(model=model, in_dim=32, hidden_dim=32 if model == "gcn" else 16,
              num_classes=4, num_layers=3)
    grads = {}
    for name in (impl, "blocked"):
        cfg = gnn.GNNConfig(impl=name, **kw)
        net = (gnn.GCN if model == "gcn" else gnn.AGNN)(cfg, device=device)
        net(ad_plan(fmt, impl=name, device=device), x).square().mean().backward()
        grads[name] = [p.grad for p in net.parameters()]
    for got, want in zip(grads[impl], grads["blocked"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
