"""Card-only checks of the port's CUDA kernels (marker ``gpu``).

Each kernel against its plain PyTorch version on the card (the balanced
ones over split schedules, with one and two heads, and the run-carried
SpMM and attention over runs that cut a hub window, each against a second
launch for the same bits; the window-parallel SpMM with windows split over
slice groups and thread-block clusters; the tensor-core attention at the
edge widths), the head-grid kernels and the non-coalesced SpMM bitwise
against the one-head launches they stand for (the non-coalesced SpMM on
the windows the SpMM does not split), the launch counters, the refusals
of the wrappers, and gradients of a train step and of multi-head
attention against the plain ``blocked`` impl.  The bf16 and int8
variants of the window SpMM, the SDDMM and the fused attention are held
to their plain versions within one bf16 ulp with at least 99% of the
entries bitwise equal; the attention over value bands (DV > 128) and
over the SDDMM/SpMM composition (D beyond its shared memory), and the
window SpMM's 64-bit-index instantiation on a 4 GiB bf16 B.  The
tensor-core SDDMM tile shared by the window, head-grid and balanced
SDDMMs: the same bits per sampled row from all three and from a second
launch, at odd F, F = 720 and 1,500, V = 16, k_blk 3, 4 and 16, H 1, 2
and 12 with shared and per-head operands, fp32 and bf16 (bf16 bitwise the
fp32 kernel on widened operands, rounded).  They skip on a host without a
CUDA device; on one, run

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (ad_plan, block_format, from_coo, from_dense,
                              to_coo)
from repro_torch.core.quantize import quantize_format
from repro_torch.core.spmm import dequantized
from repro_torch.core.sddmm import with_values
from repro_torch.core.softmax import sparse_softmax
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
from repro_torch.kernels._combine import run_plan
from repro_torch.kernels._window import SPLIT_BLK
from repro_torch.kernels.attention_cuda import rings_fit, value_bands
from repro_torch.kernels.spmm_cuda import wide_index
from repro_torch.kernels.attention_balanced_cuda import RUN_BLK as ATTN_RUN
from repro_torch.kernels.spmm_balanced_cuda import RUN_BLK as SPMM_RUN
from repro_torch.models import gnn
from repro_torch.models.layers import sparse_attention
from repro_torch.train import sparse_attention_train as sat

pytestmark = pytest.mark.gpu

# fp32 kernel against fp32 plain version, sums in another order.
RTOL, ATOL = 1e-4, 1e-5
# bf16 outputs: both sides sum in fp32 and round once, so every entry is
# within one bf16 ulp (plus 1e-6 of the largest entry) and at least 99%
# are bitwise equal.
BF16 = torch.bfloat16
ULP_RTOL, ULP_ATOL_OF_MAX, BITWISE_SHARE = 2.0 ** -7, 1e-6, 0.99


def _one_ulp(got, want):
    assert got.dtype == want.dtype == BF16
    got, want = got.float(), want.float()
    atol = ULP_ATOL_OF_MAX * max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=ULP_RTOL, atol=atol)
    share = (got == want).float().mean().item() if got.numel() else 1.0
    assert share >= BITWISE_SHARE, f"{share:.4f} bitwise equal"


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
    with pytest.raises(TypeError, match="variants"):
        spmm_cuda(blocked, x.to(BF16))    # fp32 values with bf16 B
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
    _balanced_on_card(device, case, h, split)


# Two windows of about 1,000 vectors (125 K-blocks at k_blk = 8): at
# split_blk >= 1 the run-carried kernels cut each into several runs.  (At
# split_blk = 0 such a window is one fp32 running sum, as in the
# window-parallel kernels; the CASES above hold that order.)
HUB_CASE = (16, 1600, 0.1, (), 8, 8, 64, 32, 32)


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("h", [1, 2])
def test_balanced_kernels_cut_a_hub_window_on_card(device, h, split):
    blocked = _balanced_on_card(device, HUB_CASE, h, split)
    sched = blocked.schedule(split)
    for run_blk in (SPMM_RUN, ATTN_RUN):
        plan = run_plan("test", sched, blocked.num_windows, run_blk)
        win = plan.pieces[:, 0].cpu().numpy()
        assert (np.bincount(win, minlength=2)[:2] >= 2).all()  # cut, each


def _balanced_on_card(device, case, h, split):
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
    out = spmm_balanced_cuda(bv, b, schedule=sched)
    # a fixed summation order: a second launch gives the same bits
    assert torch.equal(out, spmm_balanced_cuda(bv, b, schedule=sched))
    torch.testing.assert_close(out, spmm_balanced_plain(bv, b, sched),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(sddmm_balanced_cuda(blocked, q, kk,
                                                   schedule=sched),
                               sddmm_balanced_plain(blocked, q, kk, sched),
                               rtol=RTOL, atol=ATOL)
    scale = torch.tensor(0.8, device=device)
    out = attention_balanced_cuda(blocked, q, kk, vv, scale=scale,
                                  schedule=sched)
    assert torch.equal(out, attention_balanced_cuda(blocked, q, kk, vv,
                                                    scale=scale,
                                                    schedule=sched))
    torch.testing.assert_close(
        out, attention_balanced_plain(blocked, q, kk, vv, sched, scale),
        rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()
    return blocked


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


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("mix", ["first", "second", "both"])
@pytest.mark.parametrize("h", [1, 3])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}")
def test_head_grid_kernels_are_bitwise_the_per_head_launches(device, case, h,
                                                             mix, prec):
    """One launch of a head-grid kernel for H heads is bitwise H one-head
    launches and agrees with its plain version: fp32 at the kernel
    tolerance; bf16, and int8 values (shared by the heads) with bf16 B,
    within one bf16 ulp."""
    m, k, density, empty, v, k_blk, n, f, dv = case
    rng = np.random.default_rng(m * k + 7 * h)
    a = _matrix(rng, m, k, density, empty)
    blocked = block_format(from_dense(a, vector_size=v), k_blk, device=device)
    dtype = BF16 if prec == "bf16" else torch.float32

    def t(per_head, *shape):
        hs = (h,) if per_head else ()
        return torch.from_numpy(rng.standard_normal(hs + shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    def agree(got, want):
        if prec == "bf16":
            _one_ulp(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)

    first, second = mix in ("first", "both"), mix in ("second", "both")
    views = {prec: with_values(blocked,
                               t(first, *blocked.vals.shape) * blocked.mask)}
    b, q, kk = t(second, k, n), t(first, m, f), t(second, k, f)
    if prec == "bf16" and second:
        views["int8"] = quantize_format(blocked)  # values shared by the heads
    for var, bv in views.items():
        before = spmm_batched_cuda.variant_launches[var]
        out = spmm_batched_cuda(bv, b)
        assert spmm_batched_cuda.variant_launches[var] == before + 1
        assert torch.equal(out, torch.stack([
            spmm_cuda(with_values(bv, _head(bv.vals, i)), _head(b, i))
            for i in range(h)]))
        agree(out, spmm_batched_plain(bv, b))
    out = sddmm_batched_cuda(blocked, q, kk)
    assert torch.equal(out, torch.stack([
        sddmm_cuda(blocked, _head(q, i), _head(kk, i)) for i in range(h)]))
    agree(out, sddmm_batched_plain(blocked, q, kk))
    # attention: per-head Q with shared K, V ("first"), shared Q with
    # per-head K, V ("second"), or all per head
    vv = t(second, k, dv)
    scale = torch.tensor(0.8, device=device)
    out = attention_cuda(blocked, q, kk, vv, scale=scale)
    assert torch.equal(out, torch.stack([
        attention_cuda(blocked, _head(q, i), _head(kk, i), _head(vv, i),
                       scale=scale) for i in range(h)]))
    agree(out, attention_plain(blocked, q, kk, vv, scale))
    if prec == "fp32":
        agree(attention_cuda_staged(blocked, q, kk, vv, scale=scale),
              attention_plain(blocked, q, kk, vv, scale))
    else:
        # the staged composition: the softmax of the SDDMM kernel's bf16
        # scores in fp32, the probabilities at bf16 through the SpMM kernel
        probs = sparse_softmax(blocked, sddmm_batched_cuda(
            blocked, q, kk).float() * scale).to(BF16)
        agree(attention_cuda_staged(blocked, q, kk, vv, scale=scale),
              spmm_batched_plain(with_values(blocked, probs), vv))
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}")
def test_spmm_baselines_on_card(device, case):
    m, k, density, empty, v, k_blk, n, f, dv = case
    rng = np.random.default_rng(m * k + 3)
    a = _matrix(rng, m, k, density, empty)
    blocked = block_format(from_dense(a, vector_size=v), k_blk, device=device)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)
    # the Fig. 15 baseline keeps spmm.cu's per-output order on the windows
    # spmm.cu walks unsplit; spmm.cu sums a longer window by slices
    out, ref = spmm_noncoalesced_cuda(blocked, b), spmm_cuda(blocked, b)
    unsplit = (torch.diff(blocked.win_ptr.long()) <= SPLIT_BLK
               ).repeat_interleave(v)[:m]
    assert torch.equal(out[unsplit], ref[unsplit])
    plain = spmm_plain(blocked, b)
    for got in (out, ref):
        torch.testing.assert_close(got[~unsplit], plain[~unsplit], rtol=RTOL,
                                   atol=ATOL)
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


# (M, K, density, V, k_blk, N): windows longer than SPLIT_BLK K-blocks, cut
# into slices over the groups of a block (medium: 75 K-blocks), of a
# cluster of 4 (300 K-blocks at N = 128; 1,125 at N = 32, over 16 groups a
# block) and of 16 blocks (1,125 K-blocks at N = 128), at V = 16 and
# k_blk = 4, and at k_blk = 3 with a ragged column tile; short windows
# beside them in every case
WINDOW_CASES = [(24, 600, 0.6, 8, 8, 128), (24, 2400, 0.6, 8, 8, 128),
                (16, 9000, 0.95, 8, 8, 128), (16, 9000, 0.95, 8, 8, 32),
                (40, 3000, 0.3, 16, 4, 64), (40, 1200, 0.5, 8, 3, 20)]


# A long window's row is a sum of up to 9,000 products; an fp32 sum of n
# terms is off the exact one by up to about sqrt(n) 2^-24 sum|a b| (the
# probabilistic bound of Higham and Mary, SIAM J. Sci. Comput. 41(5),
# 2019), in the plain version as in the kernel, beyond RTOL/ATOL where the
# terms cancel.  The rows of split windows are held to an fp64 product
# within 3 times that bound (chip_smoke.py's check of hub windows), the
# other rows to the plain version.
HUB_LAMBDA = 3.0


@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: f"{c[0]}x{c[1]}-V{c[3]}-kblk{c[4]}-N{c[5]}")
def test_window_spmm_splits_long_windows_on_card(device, case):
    """Rows of split windows against fp64, the others against the plain
    version; the same bits on a second launch, and the head grid
    bitwise-equal to one-head launches."""
    m, k, density, v, k_blk, n = case
    rng = np.random.default_rng(m + k + n)
    a = _matrix(rng, m, k, 0.02)
    a[8:16] = _matrix(rng, 8, k, density)      # one long window
    blocked = block_format(from_dense(a, vector_size=v), k_blk, device=device)
    per_win = torch.diff(blocked.win_ptr.long())
    assert int(per_win.max()) > SPLIT_BLK
    b = torch.from_numpy(rng.standard_normal((2, k, n)).astype(np.float32)).to(device)
    out = spmm_cuda(blocked, b[0])
    assert torch.equal(out, spmm_cuda(blocked, b[0]))
    split = (per_win > SPLIT_BLK).repeat_interleave(v)[:m]
    torch.testing.assert_close(out[~split], spmm_plain(blocked, b[0])[~split],
                               rtol=RTOL, atol=ATOL)
    a64, b64 = torch.from_numpy(a).to(device).double(), b[0].double()
    terms = (per_win * k_blk).double().repeat_interleave(v)[:m, None]
    limit = ATOL + HUB_LAMBDA * terms.sqrt() * 2.0 ** -24 * (a64.abs() @ b64.abs())
    assert bool(((out.double() - a64 @ b64).abs() <= limit)[split].all())
    heads = spmm_batched_cuda(blocked, b)
    assert torch.equal(heads, torch.stack([spmm_cuda(blocked, b[i])
                                           for i in range(2)]))


# (M, K, density, V, k_blk, D, DV): the tensor-core attention's edge widths
# (D and DV not multiples of 8 or of 4, zero-padded in shared memory; V = 16
# as two n8 tiles; DV up to 128) and a window longer than one chunk
ATTN_WIDTHS = [(45, 60, 0.3, 8, 8, 7, 5), (64, 64, 0.3, 8, 4, 9, 65),
               (40, 90, 0.4, 8, 3, 33, 16), (50, 61, 0.25, 16, 4, 9, 16),
               (77, 77, 0.2, 16, 8, 64, 128), (16, 400, 0.5, 8, 8, 64, 64)]


@pytest.mark.parametrize("case", ATTN_WIDTHS, ids=lambda c: f"D{c[5]}-DV{c[6]}-V{c[3]}")
def test_tensor_core_attention_at_edge_widths_on_card(device, case):
    m, k, density, v, k_blk, d, dv = case
    rng = np.random.default_rng(m + d + dv)
    blocked = block_format(from_dense(_matrix(rng, m, k, density),
                                      vector_size=v), k_blk, device=device)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    q, kk, vv = t(3, m, d), t(k, d), t(3, k, dv)
    scale = torch.tensor(0.6, device=device)
    out = attention_cuda(blocked, q, kk, vv, scale=scale)
    assert torch.equal(out, attention_cuda(blocked, q, kk, vv, scale=scale))
    assert torch.equal(out, torch.stack([attention_cuda(
        blocked, q[i], kk, vv[i], scale=scale) for i in range(3)]))
    torch.testing.assert_close(out, attention_plain(blocked, q, kk, vv, scale),
                               rtol=RTOL, atol=ATOL)


# (M, K, density, V, k_blk, D, DV): value bands (DV > 128, one launch a
# band) and a D whose K and Q rings do not fit shared memory (the
# SDDMM -> softmax -> SpMM composition instead: above 712 fp32 columns,
# above 1,420 bf16 ones, at V = 8)
WIDE_ATTENTION = [(64, 80, 0.2, 8, 8, 16, 129), (64, 80, 0.2, 8, 8, 32, 256),
                  (40, 90, 0.3, 16, 4, 24, 200), (64, 80, 0.2, 8, 8, 720, 32),
                  (48, 64, 0.25, 8, 8, 1500, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("case", WIDE_ATTENTION, ids=lambda c: f"D{c[5]}-DV{c[6]}-V{c[3]}")
def test_attention_wide_values_and_large_d_on_card(device, case, dtype):
    m, k, density, v, k_blk, d, dv = case
    rng = np.random.default_rng(m + d + dv)
    blocked = block_format(from_dense(_matrix(rng, m, k, density),
                                      vector_size=v), k_blk, device=device)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    q, kk, vv = t(m, d), t(k, d), t(k, dv)
    scale = torch.tensor(0.3, device=device)
    fits = rings_fit(v, d, dtype)
    before = (attention_cuda.launches, sddmm_cuda.launches,
              spmm_cuda.launches)
    out = attention_cuda(blocked, q, kk, vv, scale=scale)
    got = (attention_cuda.launches - before[0], sddmm_cuda.launches
           - before[1], spmm_cuda.launches - before[2])
    assert got == ((len(value_bands(dv)), 0, 0) if fits else (0, 1, 1))
    assert fits == (d != 1500 and (d != 720 or dtype == BF16))
    want = attention_plain(blocked, q, kk, vv, scale)
    if dtype == BF16:
        _one_ulp(out, want)
    else:
        torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()


# (M, K, density, V, k_blk, N): the edge CASES' shapes for the narrow
# variants, and a window of about 1,400 K-blocks cut over a cluster
NARROW = [c[:6] + (c[6],) for c in CASES] + [(8, 20000, 0.1, (), 8, 8, 64)]


@pytest.mark.parametrize("case", NARROW, ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}-N{c[6]}")
def test_bf16_and_int8_kernels_match_plain_on_card(device, case):
    m, k, density, empty, v, k_blk, n = case
    rng = np.random.default_rng(m * k + 5)
    blocked = block_format(from_dense(_matrix(rng, m, k, density, empty),
                                      vector_size=v), k_blk, device=device)

    def t(*shape, dtype=BF16):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    b16, b32 = t(k, n), t(k, n, dtype=torch.float32)
    p16 = with_values(blocked, blocked.vals.to(BF16))
    out = spmm_cuda(p16, b16)
    assert torch.equal(out, spmm_cuda(p16, b16))   # same bits each launch
    _one_ulp(out, spmm_plain(p16, b16))
    q8 = quantize_format(blocked)
    out = spmm_cuda(q8, b16)
    assert torch.equal(out, spmm_cuda(q8, b16))
    _one_ulp(out, spmm_plain(q8, b16))
    # fp32 B gives fp32 C: a window of n vectors is one running sum, held
    # against fp64 within the recursive-sum bound (the split windows' test)
    out = spmm_cuda(q8, b32).double()
    rows, cols, vals = to_coo(dequantized(q8))
    a64 = torch.zeros((m, k), dtype=torch.float64)
    a64[rows, cols] = torch.from_numpy(vals).double()
    a64 = a64.to(device)
    per_win = torch.diff(blocked.win_ptr.long())
    terms = (per_win * k_blk).double().repeat_interleave(v)[:m, None]
    limit = ATOL + HUB_LAMBDA * terms.sqrt() * 2.0 ** -24 * (
        a64.abs() @ b32.double().abs())
    assert bool(((out - a64 @ b32.double()).abs() <= limit).all())
    f = 24 if m * k < 10**6 else 32
    q, kk = t(m, f), t(k, f)
    _one_ulp(sddmm_cuda(blocked, q, kk), sddmm_plain(blocked, q, kk))
    if k <= 4000:
        vv = t(k, 40)
        scale = torch.tensor(0.8, device=device)
        _one_ulp(attention_cuda(blocked, q, kk, vv, scale=scale),
                 attention_plain(blocked, q, kk, vv, scale))
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [32, 64, 127, 128, 130, 200, 256])
@pytest.mark.parametrize("case", [CASES[0], CASES[5], NARROW[-1]],
                         ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}")
def test_bf16_window_spmm_two_columns_match_fp32_kernel_bitwise(device, case,
                                                                n):
    """bf16 B of a tile of 64 columns or more takes two columns a thread
    (one 32-bit load per pair, 16-bit loads at an odd N, a ragged tile's
    last column or a B two bytes off a 4-byte boundary); every column's
    products are taken in the fp32 kernel's order, so the result is that
    kernel's on the widened operands, rounded to bf16, bit for bit."""
    m, k, density, empty, v, k_blk = case[:6]
    rng = np.random.default_rng(m + k + n)
    blocked = block_format(from_dense(_matrix(rng, m, k, density, empty),
                                      vector_size=v), k_blk, device=device)
    b32 = torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(device).to(BF16).float()
    # the same B at an element offset of one: pairs not 4-byte aligned
    store = torch.empty(k * n + 1, dtype=BF16, device=device)
    off = store[1:].view(k, n)
    off.copy_(b32)
    views = {"bf16": (with_values(blocked, blocked.vals.to(BF16)),
                      lambda p: with_values(p, p.vals.float())),
             "int8": (quantize_format(blocked), lambda p: p)}
    for p16, widen in views.values():
        want = spmm_cuda(widen(p16), b32).to(BF16)
        assert torch.equal(spmm_cuda(p16, b32.to(BF16)), want)
        assert torch.equal(spmm_cuda(p16, off), want)
    torch.cuda.synchronize()


def test_window_spmm_64_bit_index_on_a_4_gib_bf16_b(device):
    """B of K x N = 2^31 + 8,192 bf16 elements (4 GiB), the nonzeros of A
    in its last rows: the kernel takes its 64-bit-index instantiation."""
    n = 128
    k = 2**31 // n + 64
    rows = np.array([0, 3, 3, 9, 15, 15, 20])
    cols = np.array([k - 1, k - 2, 7, k - 64, k - 1, k - 9, k - 1])
    vals = np.linspace(0.5, 2.0, rows.size)
    blocked = block_format(from_coo(rows, cols, vals, (21, k), dtype=BF16),
                           8, device=device)
    assert wide_index(k * n, blocked.vals.shape[0] * 8)
    b = torch.empty((k, n), dtype=BF16, device=device)
    b.normal_(generator=torch.Generator(device).manual_seed(0))
    out = spmm_cuda(blocked, b)
    _one_ulp(out, spmm_plain(blocked, b))
    assert out[9].abs().sum() > 0 and not out[1].any()
    del b
    torch.cuda.synchronize()


def _widened(view):
    """``view`` with fp32 values: bf16 values widened, int8 values as
    ``q · scale`` in fp32 (what the narrow kernels multiply by)."""
    return with_values(dequantized(view), dequantized(view).vals.float())


@pytest.mark.parametrize("split", [0, 1, 3])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("case", CASES + [HUB_CASE], ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}")
def test_narrow_balanced_kernels_match_plain_on_card(device, case, h, split):
    """The balanced SpMM at bf16 and int8, SDDMM and attention at bf16:
    within one bf16 ulp of their plain versions, the same bits on a
    second launch, and bitwise the fp32 kernel's result on the widened
    operands, rounded once (the same sums in the same order)."""
    m, k, density, empty, v, k_blk, n, f, dv = case
    rng = np.random.default_rng(m * k + 13 * h + split)
    blocked = block_format(from_dense(_matrix(rng, m, k, density, empty),
                                      vector_size=v), k_blk, device=device)
    sched = blocked.schedule(split)
    hs = (h,) if h > 1 else ()

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=BF16)

    b = t(*hs, k, n)
    views = {"bf16": with_values(blocked, t(*hs, *blocked.vals.shape)
                                 * blocked.mask),
             "int8": quantize_format(blocked)}
    for var, bv in views.items():
        out = spmm_balanced_cuda(bv, b, schedule=sched)
        assert out.dtype == BF16
        assert torch.equal(out, spmm_balanced_cuda(bv, b, schedule=sched))
        assert torch.equal(out, spmm_balanced_cuda(
            _widened(bv), b.float(), schedule=sched).to(BF16))
        _one_ulp(out, spmm_balanced_plain(bv, b, sched))
    # int8 values with fp32 B: the fp32 kernel on q * scale, bit for bit
    q8, b32 = views["int8"], b.float()
    assert torch.equal(spmm_balanced_cuda(q8, b32, schedule=sched),
                       spmm_balanced_cuda(_widened(q8), b32, schedule=sched))
    q, kk, vv = t(*hs, m, f), t(k, f), t(*hs, k, dv)
    out = sddmm_balanced_cuda(blocked, q, kk, schedule=sched)
    assert torch.equal(out, sddmm_balanced_cuda(
        blocked, q.float(), kk.float(), schedule=sched).to(BF16))
    _one_ulp(out, sddmm_balanced_plain(blocked, q, kk, sched))
    scale = torch.tensor(0.8, device=device)
    out = attention_balanced_cuda(blocked, q, kk, vv, scale=scale,
                                  schedule=sched)
    assert torch.equal(out, attention_balanced_cuda(
        blocked, q, kk, vv, scale=scale, schedule=sched))
    qs = (q.float() * scale).to(BF16).float()
    assert torch.equal(out, attention_balanced_cuda(
        blocked, qs, kk.float(), vv.float(), scale=1.0,
        schedule=sched).to(BF16))
    _one_ulp(out, attention_balanced_plain(blocked, q, kk, vv, sched, scale))
    torch.cuda.synchronize()


@pytest.mark.parametrize("mode", ["gcn-bf16", "agnn-bf16", "gcn-int8"])
def test_balanced_narrow_train_step_on_card_matches_blocked(device, mode):
    """The first step's gradients of a bf16 or int8-plan model on
    cuda_balanced against the blocked route's at the same precision,
    within four bf16 ulps of the largest entry (chip_smoke.py's gate)."""
    model, prec = mode.split("-")
    dtype = BF16 if prec == "bf16" else torch.float32
    rng = np.random.default_rng(2)
    a = _matrix(rng, 300, 300, 0.02) + np.eye(300, dtype=np.float32)
    fmt = from_dense(a) if prec == "int8" else from_coo(
        *to_coo(from_dense(a)), (300, 300), dtype=BF16)
    x = torch.from_numpy(rng.standard_normal((300, 32)).astype(
        np.float32)).to(device=device, dtype=dtype)
    kw = dict(model=model, in_dim=32, hidden_dim=32 if model == "gcn" else 16,
              num_classes=4, num_layers=3, dtype=dtype)
    grads = {}
    for name in ("cuda_balanced", "blocked"):
        cfg = gnn.GNNConfig(impl=name, **kw)
        net = (gnn.GCN if model == "gcn" else gnn.AGNN)(cfg, device=device)
        plan = ad_plan(fmt, impl=name, device=device,
                       precision="int8" if prec == "int8" else None)
        net(plan, x).float().square().mean().backward()
        grads[name] = [p.grad.float() for p in net.parameters()]
    top = max(g.abs().max().item() for g in grads["blocked"])
    for got, want in zip(grads["cuda_balanced"], grads["blocked"]):
        torch.testing.assert_close(got, want, rtol=0.0,
                                   atol=4 * 2.0 ** -7 * top)


@pytest.mark.parametrize("impl", ["cuda", "cuda_balanced"])
def test_bf16_multi_head_attention_gradients_on_card_match_blocked(device,
                                                                  impl):
    seq, heads, d = 300, 3, 16
    rows, cols = sat.block_sparse_causal_pattern(seq)
    fmt = from_dense(np.asarray(sat.dense_mask(rows, cols, seq, "cpu"),
                                np.float32))
    q, k, v = (torch.from_numpy(x).to(device)
               for x in sat.make_inputs(seq, heads, d, precision="bf16"))
    grads, launches = {}, {}
    for name in (impl, "blocked"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plan = ad_plan(fmt, impl=name, device=device, precision="bf16")
        before = (sddmm_batched_cuda.variant_launches["bf16"],
                  spmm_batched_cuda.variant_launches["bf16"])
        out = sparse_attention(plan, *leaves)
        assert out.dtype == BF16
        out.float().square().sum().backward()
        launches[name] = (sddmm_batched_cuda.variant_launches["bf16"]
                          - before[0],
                          spmm_batched_cuda.variant_launches["bf16"]
                          - before[1])
        grads[name] = [t.grad for t in leaves]
    # the cuda route's backward: the recomputed scores and dProbs, and dV,
    # dQ and dK, each one head-grid launch at bf16
    assert launches[impl] == ((2, 3) if impl == "cuda" else (0, 0))
    for got, want in zip(grads[impl], grads["blocked"]):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0.0,
                                   atol=4 * 2.0 ** -7 * want.abs().max().item())


# (M, K, density, V, k_blk, F): the tensor-core SDDMM tile at odd F (a
# cut k-step, element-wise loads), F past one stage of 64 features
# (720, 1,500: the attention's SDDMM route for a D past its shared
# memory), V = 16 (two n8 tiles), k_blk 3, 4 and 16 (up to seven, four
# and one windows a tile), rows past M, and the all-empty matrix
TILE_CASES = [(45, 45, 0.2, 8, 8, 1), (45, 45, 0.2, 8, 8, 7),
              (64, 64, 0.15, 8, 4, 33), (64, 64, 0.3, 8, 16, 9),
              (40, 200, 0.5, 8, 3, 16), (77, 77, 0.2, 16, 8, 64),
              (50, 61, 0.25, 16, 4, 30), (300, 1000, 0.05, 8, 8, 32),
              (64, 80, 0.2, 8, 8, 720), (48, 64, 0.25, 16, 16, 1500),
              (30, 30, 0.0, 8, 8, 8)]


def _unit(rng, *shape):
    """Rows of unit norm, as the main path gives them to the SDDMM (AGNN's
    normalized features, the attention's scaled queries): an fp32 sum in
    any order is then within the kernel tolerance of another at any F."""
    x = rng.standard_normal(shape)
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-6)
            ).astype(np.float32)


@pytest.mark.parametrize("case", TILE_CASES, ids=lambda c: f"{c[0]}x{c[1]}-V{c[3]}-kblk{c[4]}-F{c[5]}")
def test_sddmm_tiles_agree_per_row_on_card(device, case):
    """The window (row 6), head-grid (row 7) and balanced (row 8) SDDMMs
    share one tile: a sampled row gets the same bits from each, whatever
    tile and windows hold it (split_blk 0, 1, 3), and from a second launch;
    fp32 within the kernel tolerance of the plain version; bf16 bitwise
    the fp32 kernel on the widened operands, rounded once (rows 6 and 8),
    within one bf16 ulp of the plain version, >= 99% bitwise."""
    m, k, density, v, k_blk, f = case
    rng = np.random.default_rng(m * k + f)
    blocked = block_format(from_dense(_matrix(rng, m, k, density),
                                      vector_size=v), k_blk, device=device)
    q, kk = (torch.from_numpy(_unit(rng, r, f)).to(device) for r in (m, k))
    for x, y in ((q, kk), (q.to(BF16), kk.to(BF16))):
        out = sddmm_cuda(blocked, x, y)
        assert torch.equal(out, sddmm_cuda(blocked, x, y))
        assert torch.equal(out, sddmm_batched_cuda(blocked, x[None], y)[0])
        for split in (0, 1, 3):
            sched = blocked.schedule(split)
            got = sddmm_balanced_cuda(blocked, x, y, schedule=sched)
            if sched.num_blocks:
                assert torch.equal(got, out)
            else:
                assert not bool(got.any()) and not bool(out.any())
        want = sddmm_plain(blocked, x, y)
        if x.dtype == BF16:
            _one_ulp(out, want)
            assert torch.equal(out, sddmm_cuda(blocked, x.float(),
                                               y.float()).to(BF16))
            sched = blocked.schedule(1)
            if sched.num_blocks:
                assert torch.equal(
                    sddmm_balanced_cuda(blocked, x, y, schedule=sched),
                    sddmm_balanced_cuda(blocked, x.float(), y.float(),
                                        schedule=sched).to(BF16))
        else:
            torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("h", [1, 2, 12])
@pytest.mark.parametrize("case", [TILE_CASES[i] for i in (1, 2, 3, 6, 8)],
                         ids=lambda c: f"V{c[3]}-kblk{c[4]}-F{c[5]}")
def test_sddmm_tile_head_grids_on_card(device, case, h, dtype):
    """The head-grid and balanced SDDMMs at H in {1, 2, 12} with per-head
    and shared Q and K: bitwise H one-head launches of the window SDDMM,
    and within the kernel tolerance (fp32) or one bf16 ulp (bf16) of the
    plain version."""
    m, k, density, v, k_blk, f = case
    rng = np.random.default_rng(m + k + f + h)
    blocked = block_format(from_dense(_matrix(rng, m, k, density),
                                      vector_size=v), k_blk, device=device)
    sched = blocked.schedule(1)
    for qh, kh in ((True, False), (False, True), (True, True)):
        q = torch.from_numpy(_unit(rng, *((h,) if qh else ()), m, f)).to(
            device=device, dtype=dtype)
        kk = torch.from_numpy(_unit(rng, *((h,) if kh else ()), k, f)).to(
            device=device, dtype=dtype)
        heads = torch.stack([sddmm_cuda(blocked, _head(q, i), _head(kk, i))
                             for i in range(h)])
        out = sddmm_batched_cuda(blocked, q, kk)
        assert torch.equal(out, heads)
        assert torch.equal(sddmm_balanced_cuda(blocked, q, kk,
                                               schedule=sched), heads)
        want = sddmm_batched_plain(blocked, q, kk)
        if dtype == BF16:
            _one_ulp(out, want)
        else:
            torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()
