"""Card-only checks of the port's CUDA kernels (marker ``gpu``).

Each kernel against its plain PyTorch version on the card (the balanced
ones over split schedules, with one and two heads), the head-grid
kernels and the non-coalesced SpMM bitwise against the one-head launches
they stand for, the launch counters, the refusals of the wrappers, and
gradients of a train step and of multi-head attention against the plain
``blocked`` impl.  They skip on a host without a CUDA device; on
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
                                 attention_cuda_staged, attention_plain,
                                 sddmm_balanced_cuda, sddmm_balanced_plain,
                                 sddmm_batched_cuda, sddmm_batched_plain,
                                 sddmm_cuda, sddmm_plain, spmm_balanced_cuda,
                                 spmm_balanced_plain, spmm_batched_cuda,
                                 spmm_batched_plain, spmm_cuda,
                                 spmm_noncoalesced_cuda, spmm_plain,
                                 spmm_staged_cuda, spmm_staged_plain)
from repro_torch.models import gnn
from repro_torch.models.layers import sparse_attention
from repro_torch.train import sparse_attention_train as sat

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


def _head(t, h):
    return t[h] if t.dim() == 3 else t


@pytest.mark.parametrize("mix", ["first", "second", "both"])
@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}")
def test_head_grid_kernels_are_bitwise_the_per_head_launches(device, case, h,
                                                             mix):
    m, k, density, empty, v, k_blk, n, f, dv = case
    rng = np.random.default_rng(m * k + 7 * h)
    a = _matrix(rng, m, k, density, empty)
    blocked = block_format(from_dense(a, vector_size=v), k_blk, device=device)

    def t(per_head, *shape):
        hs = (h,) if per_head else ()
        return torch.from_numpy(rng.standard_normal(hs + shape).astype(
            np.float32)).to(device)

    first, second = mix in ("first", "both"), mix in ("second", "both")
    bv = with_values(blocked, t(first, *blocked.vals.shape) * blocked.mask)
    b, q, kk = t(second, k, n), t(first, m, f), t(second, k, f)
    out = spmm_batched_cuda(bv, b)
    want = torch.stack([spmm_cuda(with_values(blocked, _head(bv.vals, i)),
                                  _head(b, i)) for i in range(h)])
    assert torch.equal(out, want)
    torch.testing.assert_close(out, spmm_batched_plain(bv, b), rtol=RTOL,
                               atol=ATOL)
    out = sddmm_batched_cuda(blocked, q, kk)
    assert torch.equal(out, torch.stack([
        sddmm_cuda(blocked, _head(q, i), _head(kk, i)) for i in range(h)]))
    torch.testing.assert_close(out, sddmm_batched_plain(blocked, q, kk),
                               rtol=RTOL, atol=ATOL)
    # attention: per-head Q with shared K, V ("first"), shared Q with
    # per-head K, V ("second"), or all per head
    vv = t(second, k, dv)
    scale = torch.tensor(0.8, device=device)
    out = attention_cuda(blocked, q, kk, vv, scale=scale)
    assert torch.equal(out, torch.stack([
        attention_cuda(blocked, _head(q, i), _head(kk, i), _head(vv, i),
                       scale=scale) for i in range(h)]))
    torch.testing.assert_close(out, attention_plain(blocked, q, kk, vv, scale),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        attention_cuda_staged(blocked, q, kk, vv, scale=scale),
        attention_plain(blocked, q, kk, vv, scale), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}")
def test_spmm_baselines_on_card(device, case):
    m, k, density, empty, v, k_blk, n, f, dv = case
    rng = np.random.default_rng(m * k + 3)
    a = _matrix(rng, m, k, density, empty)
    blocked = block_format(from_dense(a, vector_size=v), k_blk, device=device)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)
    # the Fig. 15 baseline keeps spmm.cu's per-output order
    assert torch.equal(spmm_noncoalesced_cuda(blocked, b), spmm_cuda(blocked, b))
    torch.testing.assert_close(spmm_staged_cuda(blocked, b),
                               spmm_staged_plain(blocked, b), rtol=RTOL,
                               atol=ATOL)
    torch.cuda.synchronize()


def test_new_wrappers_count_their_launches(device):
    blocked = block_format(from_dense(np.eye(16, dtype=np.float32)), 8,
                           device=device)
    x = torch.ones(16, 8, device=device)
    x3 = torch.ones(2, 16, 8, device=device)
    wrappers = (spmm_batched_cuda, sddmm_batched_cuda, spmm_staged_cuda,
                spmm_noncoalesced_cuda, spmm_cuda, sddmm_cuda)
    before = [w.launches for w in wrappers]
    spmm_batched_cuda(blocked, x3)
    sddmm_batched_cuda(blocked, x3, x)
    spmm_staged_cuda(blocked, x)
    spmm_noncoalesced_cuda(blocked, x)
    spmm_batched_cuda(blocked, x)          # 2-D: the single-head kernel
    assert [w.launches - n for w, n in zip(wrappers, before)] == [
        1, 1, 1, 1, 1, 0]


@pytest.mark.parametrize("impl", ["cuda", "cuda_balanced"])
def test_multi_head_attention_gradients_on_card_match_blocked(device, impl):
    seq, heads, d = 300, 3, 16
    rows, cols = sat.block_sparse_causal_pattern(seq)
    fmt = from_dense(np.asarray(sat.dense_mask(rows, cols, seq, "cpu"),
                                np.float32))
    q, k, v = (torch.from_numpy(x).to(device)
               for x in sat.make_inputs(seq, heads, d))
    grads = {}
    for name in (impl, "blocked"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plan = ad_plan(fmt, impl=name, device=device)
        sparse_attention(plan, *leaves).square().sum().backward()
        grads[name] = [t.grad for t in leaves]
    for got, want in zip(grads[impl], grads["blocked"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
