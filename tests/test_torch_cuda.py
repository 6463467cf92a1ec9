"""Card-only checks of the port's CUDA kernels (marker ``gpu``).

Each kernel against its plain PyTorch version on the card (the balanced
ones over split schedules, with one and two heads, and the run-carried
SpMM and attention over runs that cut a hub window, each against a second
launch for the same bits; the window-parallel SpMM with windows split over
slice groups and thread-block clusters; the tensor-core attention at the
edge widths), the head-grid kernels bitwise against the one-head launches
they stand for, the non-coalesced SpMM and the window SpMM (which sum in
different orders) each against its plain version, the launch counters, the refusals
of the wrappers (the same arguments and messages as on CPU tensors), the
bf16 overflow rescued by ``guard_nonfinite``, and gradients of a train step and of multi-head
attention against the plain ``blocked`` impl.  The bf16 and int8
variants of the window SpMM, the SDDMM and the fused attention are held
to their plain versions within one bf16 ulp with at least 99% of the
entries bitwise equal; the attention over value bands (DV > 128) and
over the SDDMM/SpMM composition (D beyond its shared memory), the
run-carried attention at the same widths (one launch: a block per band,
K fragments from global memory past its ring) and at D not a multiple
of 4, V = 16 and runs over windows shorter than a chunk, and the
window SpMM's 64-bit-index instantiation on a 4 GiB bf16 B; the narrow
variants of the two SpMM baselines, and both redesigned baselines on a
hub matrix's transpose (the non-coalesced SpMM's slices, runs and
partials at every precision; the staged SpMM's gather bitwise ``B[cols]``
and its output bitwise the window SpMM's); every kernel the autotuner times at
k_blk 16 and 32, a tuned plan whose directions differ in k_blk and route
against ``blocked``, and a sweep on the card.  The tensor-core SDDMM
tile shared by the window, head-grid and balanced SDDMMs: the same bits
per sampled row from all three and from a second launch, at odd F,
F = 720 and 1,500, V = 16, k_blk 3, 4 and 16, H 1, 2 and 12 with shared
and per-head operands, fp32 and bf16 (bf16 bitwise the fp32 kernel on
widened operands, rounded).  The multi-device layer's rank-local
launches of rows 4, 8 and 10 over partitions of 2 and 4 ranks against
their plain versions and summing to the unsharded launch, and a GCN step
on the sharded plans over a one-rank NCCL mesh.  The LM train step
(plain PyTorch, no sparse kernel) at ``get_reduced`` size for qwen3,
moonshot and mamba2 against the same step on the CPU.  The sharded LM
(plain PyTorch and collectives): reduced qwen3's train step with its
state as DTensors on a one-rank NCCL mesh against the plain step, and the
expert-parallel MoE's rank bodies summed against the dense MoE.  They
skip on a host
without a
CUDA device; on one, run

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (ad_plan, block_format, from_coo, from_dense,
                              to_coo, to_dense)
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
                                 spmm_noncoalesced_cuda,
                                 spmm_noncoalesced_plain, spmm_plain,
                                 spmm_staged_cuda, spmm_staged_plain,
                                 staged_gather, staged_gather_plain)
from repro_torch.kernels._combine import run_plan
from repro_torch.kernels._window import SPLIT_BLK, lane_plan
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
    # the Fig. 15 baseline (CUDA-core products in vector order) and
    # spmm.cu (tensor-core k-steps of 8 vectors) sum in different orders:
    # each against the plain version on every row
    out, ref = spmm_noncoalesced_cuda(blocked, b), spmm_cuda(blocked, b)
    plain = spmm_plain(blocked, b)
    for got in (out, ref):
        torch.testing.assert_close(got, plain, rtol=RTOL, atol=ATOL)
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
# other rows to the plain version.  A hub window has more K-blocks than
# HUB_OF_MEDIAN times the median window, as in chip_smoke.py.
HUB_LAMBDA, HUB_OF_MEDIAN = 3.0, 4


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


# The run-carried attention (row 10) at the widths WIDE_ATTENTION holds
# row 9 to: value bands (DV > 128: a block per band), D = 720 and 1,500
# (at fp32 a K ring of two chunks no longer fits a block's shared memory,
# so the K fragments come from global memory); and (M, K, density, V,
# k_blk, D, DV) with D not a multiple of 4 and runs whose pieces span
# several windows shorter than a chunk.
BALANCED_WIDE = WIDE_ATTENTION + [(64, 80, 0.2, 8, 8, 13, 24),
                                  (96, 50, 0.12, 16, 2, 30, 40),
                                  (240, 60, 0.02, 8, 2, 32, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
@pytest.mark.parametrize("case", BALANCED_WIDE, ids=lambda c: f"D{c[5]}-DV{c[6]}-V{c[3]}-kblk{c[4]}")
def test_attention_balanced_wide_values_and_large_d_on_card(device, case,
                                                            dtype):
    m, k, density, v, k_blk, d, dv = case
    rng = np.random.default_rng(m + d + dv + 1)
    blocked = block_format(from_dense(_matrix(rng, m, k, density),
                                      vector_size=v), k_blk, device=device)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    q, kk, vv = t(2, m, d), t(k, d), t(2, k, dv)
    scale = torch.tensor(0.3, device=device)
    for split, run_blk in ((0, ATTN_RUN), (1, 4)):
        sched = blocked.schedule(split)
        before = attention_balanced_cuda.launches
        out = attention_balanced_cuda(blocked, q, kk, vv, scale=scale,
                                      schedule=sched, run_blk=run_blk)
        assert attention_balanced_cuda.launches == before + 1
        assert torch.equal(out, attention_balanced_cuda(
            blocked, q, kk, vv, scale=scale, schedule=sched,
            run_blk=run_blk))
        want = attention_balanced_plain(blocked, q, kk, vv, sched, scale,
                                        run_blk)
        if dtype == BF16:
            qs = (q.float() * scale).to(BF16).float()
            assert torch.equal(out, attention_balanced_cuda(
                blocked, qs, kk.float(), vv.float(), scale=1.0,
                schedule=sched, run_blk=run_blk).to(BF16))
            _one_ulp(out, want)
        else:
            torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()


# (M, K, density, V, k_blk, N): the edge CASES' shapes for the narrow
# variants, and a window of about 1,400 K-blocks cut over a cluster
NARROW =[c[:6] + (c[6],) for c in CASES] + [(8, 20000, 0.1, (), 8, 8, 64)]


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
    """bf16 B: a lane reads four neighbouring columns of a B row with one
    8-byte load, or element by element where N is not a multiple of 4, at
    a ragged tile's last columns or for a B two bytes off an 8-byte
    boundary; bf16 and int8 values with bf16 B take the fp32 kernel's
    k-steps without the products of a small part that is zero, so the
    result is that kernel's on the widened operands, rounded to bf16, bit
    for bit."""
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


# ------------------------------------------- narrow baselines, tuned route ----


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}")
def test_narrow_spmm_baselines_on_card(device, case):
    """Rows 2 (bf16, int8) and 5 (bf16): within one bf16 ulp of their plain
    versions, as the window SpMM's variant (row 1, which sums in another
    order) is; int8 refused by the staged SpMM, as by the reference's."""
    m, k, density, empty, v, k_blk, n, f, dv = case
    rng = np.random.default_rng(m * k + 5)
    a = _matrix(rng, m, k, density, empty)
    blocked = block_format(from_dense(a, vector_size=v), k_blk, device=device)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(
        device).to(BF16)
    views = {"bf16": with_values(blocked, blocked.vals.to(BF16)),
             "int8": quantize_format(blocked)}
    for var, view in views.items():
        before = spmm_noncoalesced_cuda.variant_launches[var]
        out = spmm_noncoalesced_cuda(view, b)
        assert spmm_noncoalesced_cuda.variant_launches[var] == before + 1
        _one_ulp(out, spmm_noncoalesced_plain(view, b))
        _one_ulp(spmm_cuda(view, b), spmm_plain(view, b))
    out = spmm_staged_cuda(views["bf16"], b)
    assert out.dtype == BF16
    _one_ulp(out, spmm_staged_plain(views["bf16"], b))
    with pytest.raises(ValueError, match="no int8 path"):
        spmm_staged_cuda(views["int8"], b)
    torch.cuda.synchronize()


def _hub_transpose(rng):
    """The transpose of a 1600 x 200 matrix whose columns 0-15 are hubs
    (density 0.4): 200 x 1600 with two hub windows (about 196 K-blocks each
    at k_blk 8), windows of about 16 K-blocks, and an empty window (rows
    96-103)."""
    a = _matrix(rng, 1600, 200, 0.01)
    a[:, :16] = _matrix(rng, 1600, 16, 0.4)
    a[:, 96:104] = 0.0
    return from_dense(a).transpose()


def _view_dense64(view):
    """The (dequantized) matrix of a blocked view in fp64, dense."""
    dq = dequantized(view)
    m, k = view.shape
    v = view.vector_size
    win = dq.block_win.long().repeat_interleave(view.k_blk)
    rows = win[:, None] * v + torch.arange(v, device=win.device)
    dense = torch.zeros((view.num_windows * v, k), dtype=torch.float64,
                        device=win.device)
    dense.index_put_((rows.reshape(-1),
                      dq.cols.long()[:, None].expand(-1, v).reshape(-1)),
                     dq.vals.double().reshape(-1), accumulate=True)
    return dense[:m]


def _straddle(rng):
    """264 x 600 at V = 8, k_blk = 8: 31 windows of 20 K-blocks (one slice
    each: lanes 0-30 of the first lane group), a window of 65 K-blocks
    (three slices on lanes 31-33, so its runs straddle the first two lane
    groups: a scan within the second, fp32 partials across them; not a hub
    at 65 / 20 K-blocks) and an empty window; one nonzero a column of a
    window."""
    a = np.zeros((264, 600), np.float32)
    for w, blocks in enumerate([20] * 31 + [65]):
        cols = rng.choice(600, blocks * 8, replace=False)
        a[8 * w + rng.integers(0, 8, cols.size), cols] = rng.standard_normal(
            cols.size)
    return from_dense(a)


@pytest.mark.parametrize("matrix", ["hub_transpose", "straddle"])
@pytest.mark.parametrize("variant", ["fp32", "bf16", "int8", "int8_fp32_b"])
def test_noncoalesced_splits_hub_windows_on_card(device, variant, matrix):
    """Row 2 over its lane plan, at every precision, on a hub matrix's
    transpose and on a matrix whose split window straddles two lane
    groups: the rows of split windows (slices summed by a segmented scan
    over the lanes, runs across lane groups by fp32 partials) within the
    running-sum bound of fp64 (plus the rounding to bf16), and the rows of
    every window that is not a hub, split or not, at the kernel tolerance
    of the plain version (one bf16 ulp for a bf16 output); the empty
    window zero; a second launch the same bits."""
    rng = np.random.default_rng(21)
    bl = block_format((_hub_transpose if matrix == "hub_transpose"
                       else _straddle)(rng), 8, device=device)
    if matrix == "straddle":
        assert lane_plan("test", bl.win_ptr, SPLIT_BLK).num_partials == 2
    m, k = bl.shape
    b = torch.from_numpy(rng.standard_normal((k, 96)).astype(np.float32)).to(
        device)
    if variant == "fp32":
        view = bl
    elif variant == "bf16":
        view = with_values(bl, bl.vals.to(BF16))
    else:
        view = quantize_format(bl)
    if variant in ("bf16", "int8"):
        b = b.to(BF16)
    out = spmm_noncoalesced_cuda(view, b)
    assert out.dtype == b.dtype
    assert torch.equal(out, spmm_noncoalesced_cuda(view, b))
    per_win = torch.diff(bl.win_ptr.long())
    unsplit = (per_win <= SPLIT_BLK).repeat_interleave(bl.vector_size)[:m]
    assert bool((~unsplit).any())
    a64 = _view_dense64(view)
    exact = a64 @ b.double()
    terms = (per_win * bl.k_blk).double().repeat_interleave(
        bl.vector_size)[:m, None]
    limit = ATOL + HUB_LAMBDA * terms.sqrt() * 2.0 ** -24 * (
        a64.abs() @ b.double().abs())
    if out.dtype == BF16:
        limit = limit + 2.0 ** -8 * exact.abs()
    assert bool(((out.double() - exact).abs() <= limit)[~unsplit].all())
    hub = (per_win > HUB_OF_MEDIAN * per_win.median()).repeat_interleave(
        bl.vector_size)[:m]
    rows = ~hub
    plain = spmm_noncoalesced_plain(view, b)
    if out.dtype == BF16:
        _one_ulp(out[rows], plain[rows])
    else:
        torch.testing.assert_close(out[rows], plain[rows], rtol=RTOL,
                                   atol=ATOL)
    empty = (per_win == 0).repeat_interleave(bl.vector_size)[:m]
    assert bool(empty.any()) and not out[empty].any()
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [33, 96])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_staged_reads_back_its_copy_on_card(device, dtype, n):
    """Row 5 on a hub matrix's transpose with an empty window: the staged
    gather bitwise ``B[cols]`` (16-byte pieces at N = 96, elements at odd
    N), the output bitwise ``spmm_cuda``'s (the same window kernel, plan
    and order, reading the staged copy; bf16 one rounding of the same fp32
    sum), the empty window's rows zero, a second launch the same bits, and
    one launch of each kernel counted per call."""
    rng = np.random.default_rng(23)
    bl = block_format(_hub_transpose(rng), 8, device=device)
    view = bl if dtype == torch.float32 else with_values(bl,
                                                         bl.vals.to(BF16))
    b = torch.from_numpy(rng.standard_normal((bl.shape[1], n)).astype(
        np.float32)).to(device).to(dtype)
    assert torch.equal(staged_gather(view, b), staged_gather_plain(view, b))
    before = (spmm_staged_cuda.launches, staged_gather.launches)
    out = spmm_staged_cuda(view, b)
    assert (spmm_staged_cuda.launches, staged_gather.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == dtype
    assert torch.equal(out, spmm_staged_cuda(view, b))
    assert torch.equal(out, spmm_cuda(view, b))
    assert not out[96:104].any()
    torch.cuda.synchronize()


def _hub_fmt(rng):
    """200 x 1600 with two hub windows (rows 0-15 at density 0.4: about
    1,570 nonzero vectors each, 98 and 49 K-blocks at k_blk 16 and 32, so
    the window SpMM splits them) over a sparse rest, and an empty
    window."""
    a = _matrix(rng, 200, 1600, 0.01, empty_rows=range(48, 56))
    a[:16] = _matrix(rng, 16, 1600, 0.4)
    return from_dense(a)


@pytest.mark.parametrize("n", [32, 128])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("k_blk", [16, 32])
def test_tuned_candidates_at_deep_k_blocks_on_card(device, k_blk, transposed,
                                                   n):
    """Every kernel the sweep times (rows 1 and 4 at each column tile and
    split_blk 0 / 1, and on A rows 6, 8, 9, 10) at k_blk 16 and 32 against
    its plain version, on a matrix with hub windows and on its transpose
    (hub columns).  The window SpMM's split windows (more than SPLIT_BLK
    K-blocks, summed by slices) are held against fp64 within the
    running-sum bound, as in test_window_spmm_splits_long_windows_on_card."""
    from repro_torch.core.format import blocked_view
    rng = np.random.default_rng(k_blk + n)
    fmt = _hub_fmt(rng)
    fmt = fmt.transpose() if transposed else fmt
    bl = blocked_view(fmt, k_blk, device)
    m, k = fmt.shape

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    b = t(k, n)
    per_win = torch.diff(bl.win_ptr.long())
    split = (per_win > SPLIT_BLK).repeat_interleave(bl.vector_size)[:m]
    a64 = to_dense(fmt).to(device).double()
    terms = (per_win * k_blk).double().repeat_interleave(
        bl.vector_size)[:m, None]
    limit = ATOL + HUB_LAMBDA * terms.sqrt() * 2.0 ** -24 * (
        a64.abs() @ b.double().abs())
    exact = a64 @ b.double()
    for n_blk in (64, 128, 256):
        out = spmm_cuda(bl, b, n_blk=n_blk)
        torch.testing.assert_close(out[~split], spmm_plain(bl, b)[~split],
                                   rtol=RTOL, atol=ATOL)
        assert bool(((out.double() - exact).abs() <= limit)[split].all())
        for split in (0, 1):
            sched = bl.schedule(split)
            torch.testing.assert_close(
                spmm_balanced_cuda(bl, b, schedule=sched, n_blk=n_blk),
                spmm_balanced_plain(bl, b, sched), rtol=RTOL, atol=ATOL)
    q, kk, vv = t(m, n), t(k, n), t(k, n)
    scale = torch.tensor(0.7, device=device)
    torch.testing.assert_close(sddmm_cuda(bl, q, kk), sddmm_plain(bl, q, kk),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(attention_cuda(bl, q, kk, vv, scale=scale),
                               attention_plain(bl, q, kk, vv, scale=scale),
                               rtol=RTOL, atol=ATOL)
    sched = bl.schedule(1)
    torch.testing.assert_close(sddmm_balanced_cuda(bl, q, kk, schedule=sched),
                               sddmm_balanced_plain(bl, q, kk, sched),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        attention_balanced_cuda(bl, q, kk, vv, scale=scale, schedule=sched),
        attention_balanced_plain(bl, q, kk, vv, sched, scale), rtol=RTOL,
        atol=ATOL)
    torch.cuda.synchronize()


def _seed_tuned(cache, fmt, n, device, fwd, bwd):
    """Put the winners ``fwd`` and ``bwd`` (k_blk, n_blk, split_blk) of a
    cuda_tuned plan with ``n_example = n`` into ``cache``, so building the
    plan sweeps nothing."""
    from repro_torch.kernels import autotune
    for f, cfg in ((fmt, fwd), (fmt.transpose(), bwd)):
        key = autotune.matrix_stats_key(f, n, "spmm", device=device,
                                        dtype=torch.float32)
        cache.put(autotune.sweep_key(key),
                  autotune.TuneConfig(cfg[0], cfg[1], 1.0, split_blk=cfg[2]))
    key = autotune.matrix_stats_key(fmt, n, "sddmm", device=device,
                                    dtype=torch.float32)
    cache.put(autotune.sweep_key(key, k_blks=(fwd[0],), split_blks=(0,)),
              autotune.TuneConfig(fwd[0], n, 1.0))


@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_tuned_plan_directions_differ_on_card(device, model, tmp_path):
    """A cuda_tuned plan with A on the window kernels at k_blk 16 and A^T
    on the balanced ones at k_blk 8 (seeded winners): one step's gradients
    within 1e-4 of blocked, each direction on its own kernel."""
    from repro_torch.kernels import autotune
    rng = np.random.default_rng(3)
    a = _matrix(rng, 300, 300, 0.02) + np.eye(300, dtype=np.float32)
    a[:8] = _matrix(rng, 8, 300, 0.6)          # a hub window of A
    fmt = from_dense(a)
    hidden = 32 if model == "gcn" else 16
    cache = autotune.AutotuneCache(str(tmp_path / "cache.json"))
    _seed_tuned(cache, fmt, hidden, device, (16, 64, 0), (8, 128, 1))
    autotune.reset_counters()
    plan = ad_plan(fmt, impl="cuda_tuned", n_example=hidden, cache=cache,
                   device=device)
    assert not autotune.timed
    assert (plan.fwd.k_blk, plan.bwd.k_blk, plan.n_blk, plan.n_blk_t) == (
        16, 8, 64, 128)
    assert plan.fwd_sched is None and plan.bwd_sched.split_blk == 1
    x = torch.from_numpy(rng.standard_normal((300, 32)).astype(np.float32)).to(device)
    kw = dict(model=model, in_dim=32, hidden_dim=hidden, num_classes=4,
              num_layers=3)
    grads = {}
    for name, adj in (("cuda_tuned", plan),
                      ("blocked", ad_plan(fmt, impl="blocked",
                                          device=device))):
        cfg = gnn.GNNConfig(impl=name, **kw)
        net = (gnn.GCN if model == "gcn" else gnn.AGNN)(cfg, device=device)
        before = (spmm_cuda.launches, spmm_balanced_cuda.launches)
        net(adj, x).square().mean().backward()
        grads[name] = [p.grad for p in net.parameters()]
        if name == "cuda_tuned":
            fwd, bwd = (spmm_cuda.launches - before[0],
                        spmm_balanced_cuda.launches - before[1])
            # GCN: 3 forward SpMMs on A, 2 dB on A^T; AGNN: dQ on A, dV
            # and dK on A^T, per layer
            assert (fwd, bwd) == ((3, 2) if model == "gcn" else (3, 6))
    # the hub window's products summed in another order (k_blk 16 against
    # 8), and GCN's gradients reach a few hundred on this matrix: each is
    # held at rtol 1e-4 and 1e-4 of its own largest entry (chip_smoke.py
    # phase 4b's floor)
    for got, want in zip(grads["cuda_tuned"], grads["blocked"]):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())


def test_tuned_sweep_on_card_times_every_candidate_and_caches(device,
                                                               tmp_path):
    from repro_torch.kernels import autotune
    rng = np.random.default_rng(4)
    fmt = _hub_fmt(rng)
    cache = autotune.AutotuneCache(str(tmp_path / "cache.json"))
    autotune.reset_counters()
    plan = ad_plan(fmt, impl="cuda_tuned", n_example=128, cache=cache,
                   device=device)
    assert autotune.failed_candidates == 0, autotune.last_error
    # A and A^T: 3 k_blks x 2 routes x 2 tiles; the SDDMM: one
    assert len(autotune.timed) == 2 * 12 + 1
    assert all(key.split("|")[9:11] == ["cuda", "kernel"]
               for key, _ in autotune.timed)
    again = ad_plan(from_dense(to_dense(fmt).numpy()), impl="cuda_tuned",
                    n_example=128, cache=autotune.AutotuneCache(cache.path),
                    device=device)
    assert len(autotune.timed) == 25
    assert (again.fwd.k_blk, again.bwd.k_blk, again.n_blk, again.n_blk_t) == (
        plan.fwd.k_blk, plan.bwd.k_blk, plan.n_blk, plan.n_blk_t)



def _refusals(dev):
    """What the ten wrappers say, on ``dev``, to a column tile of 0 (and
    the staged SpMM to one of 1024, above its 512), a wrongly shaped operand, vector size 4 and another view's schedule
    (the all-empty view's among them): each call's message, or
    ``"ran"``."""
    rng = np.random.default_rng(0)
    a = _matrix(rng, 40, 36, 0.3)
    views = [block_format(from_dense(a, vector_size=v), 8, device=dev)
             for v in (8, 4)]
    # the all-empty view's zero-block schedule, as many windows as views[0]
    empty = block_format(from_dense(np.zeros((40, 36), np.float32)), 8,
                         device=dev).schedule(1)

    def d(*shape):
        return torch.ones(shape, device=dev)

    calls = [
        lambda bl: spmm_cuda(bl, d(36, 16), n_blk=0),
        lambda bl: spmm_cuda(bl, d(35, 16)),
        lambda bl: spmm_batched_cuda(bl, d(2, 36, 16), n_blk=0),
        lambda bl: spmm_batched_cuda(bl, d(2, 35, 16)),
        lambda bl: spmm_balanced_cuda(bl, d(36, 16), n_blk=0),
        lambda bl: spmm_balanced_cuda(bl, d(35, 16)),
        lambda bl: spmm_staged_cuda(bl, d(36, 16), n_blk=0),
        lambda bl: spmm_staged_cuda(bl, d(36, 16), n_blk=1024),
        lambda bl: spmm_staged_cuda(bl, d(35, 16)),
        lambda bl: spmm_noncoalesced_cuda(bl, d(35, 16)),
        lambda bl: sddmm_cuda(bl, d(40, 8), d(36, 7)),
        lambda bl: sddmm_batched_cuda(bl, d(2, 41, 8), d(36, 8)),
        lambda bl: sddmm_balanced_cuda(bl, d(40, 8), d(37, 8)),
        lambda bl: sddmm_balanced_cuda(bl, d(40, 8), d(36, 8),
                                       schedule=views[1 - views.index(bl)]
                                       .schedule(1)),
        lambda bl: sddmm_balanced_cuda(bl, d(40, 8), d(36, 8),
                                       schedule=empty),
        lambda bl: spmm_balanced_cuda(bl, d(36, 16), schedule=empty),
        lambda bl: attention_balanced_cuda(bl, d(40, 8), d(36, 8), d(36, 4),
                                           schedule=empty),
        lambda bl: attention_cuda(bl, d(40, 8), d(36, 8), d(35, 4)),
        lambda bl: attention_cuda_staged(bl, d(40, 8), d(36, 8), d(36, 4),
                                         n_blk=0),
        lambda bl: attention_balanced_cuda(bl, d(40, 8), d(36, 7), d(36, 4)),
    ]
    said = []
    for call in calls:
        for bl in views:
            try:
                call(bl)
                said.append("ran")
            except ValueError as e:
                said.append(str(e))
    return said


def test_wrappers_refuse_the_same_arguments_on_cpu_and_card(device):
    """The argument checks run before the device branch: the CPU and the
    card refuse the same arguments with the same message."""
    on_card = _refusals(device)
    torch.cuda.synchronize()
    assert on_card == _refusals("cpu")
    assert "ran" not in on_card


def test_the_ladder_keeps_to_kernel_rungs_on_card(device):
    """On CUDA operands a refused kernel never gives way to a plain rung:
    a refusal no kernel rung below takes raises, and another view's
    schedule on ``cuda_balanced`` is served by the next kernel rung."""
    from repro_torch.core import dispatch, metrics, spmm
    from repro_torch.testing import faults

    rng = np.random.default_rng(15)
    fmt = from_dense(_matrix(rng, 40, 36, 0.3))
    b = torch.ones((36, 16), device=device)
    metrics.reset_counters("dispatch_fallback")
    with dispatch.record_calls() as log:
        with pytest.raises(RuntimeError, match="kernel rungs only"):
            spmm(fmt, b, impl="cuda", n_blk=0, strict=False)
    assert log == [("spmm", "cuda")]
    for op in ("spmm", "sddmm", "attention"):
        rec = faults.run_rung_recovery(op, device=device)
        assert rec["detail"].startswith("fallback:cuda_balanced->cuda")
    assert metrics.counters()["dispatch_fallback"] == 3


def test_guard_nonfinite_rescues_bf16_overflow_on_card(device):
    from repro_torch.core import dispatch, metrics, spmm, spmm_ad

    rng = np.random.default_rng(14)
    a = _matrix(rng, 40, 40, 0.3)
    a[3, 5] = 3.3999e38             # finite in fp32, inf in bf16
    fmt = from_dense(a)
    b = torch.from_numpy((rng.standard_normal((40, 16)) * 1e-5)
                         .astype(np.float32)).to(device)
    assert not torch.isfinite(spmm(fmt, b, impl="cuda",
                                   precision="bf16")).all()
    metrics.reset_counters("guard_nonfinite_rerun")
    with pytest.warns(dispatch.FallbackWarning, match="non-finite"):
        out = spmm(fmt, b, impl="cuda", precision="bf16",
                   guard_nonfinite=True)
    assert out.dtype == torch.float32
    ref = a.astype(np.float64) @ b.cpu().double().numpy()
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=1e-4,
                               atol=1e-12)
    assert metrics.counters()["guard_nonfinite_rerun"] == 1
    plan = ad_plan(fmt, impl="cuda", precision="bf16", guard_nonfinite=True,
                   device=device)
    with pytest.warns(dispatch.FallbackWarning, match="non-finite"):
        fwd = spmm_ad(plan, plan.fwd.vals, b)
    assert fwd.dtype == torch.float32 and torch.isfinite(fwd).all()
    assert metrics.counters()["guard_nonfinite_rerun"] == 2
    benign = from_dense(_matrix(rng, 40, 40, 0.3))
    plain = spmm(benign, b, impl="cuda", precision="bf16")
    guarded = spmm(benign, b, impl="cuda", precision="bf16",
                   guard_nonfinite=True)
    assert torch.equal(plain.float(), guarded)
    assert metrics.counters()["guard_nonfinite_rerun"] == 2


# ------------------------------------------------- the multi-device layer ----


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", [CASES[0], CASES[4], HUB_CASE],
                         ids=lambda c: f"{c[0]}x{c[1]}-V{c[4]}-kblk{c[5]}")
def test_rank_local_launches_match_plain_on_card(device, case, d):
    """Rows 4, 8 and 10 over each rank's range of a partition (cuts inside
    hub windows for the SpMM and SDDMM, window-aligned for the attention)
    against their plain versions, bf16 within one ulp, and the ranks'
    partials summing to the unsharded launch."""
    from repro_torch.distributed import (attention_sharded_local,
                                         sddmm_sharded_local,
                                         sharded_schedule,
                                         spmm_sharded_local)

    m, k, density, empty, v, k_blk, n, f, dv = case
    rng = np.random.default_rng(m + k + d)
    a = _matrix(rng, m, k, density, empty)
    blocked = block_format(from_dense(a, vector_size=v), k_blk,
                           device=device)
    part = sharded_schedule(blocked, d)
    aligned = sharded_schedule(blocked, d, window_split=False)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    b, q, kk, vv = t(k, n), t(m, f), t(k, f), t(k, dv)
    sums = {}
    for r in range(d):
        loc, loc_a = part.local(r), aligned.local(r)
        outs = {"spmm": spmm_sharded_local(blocked, b, part, r),
                "sddmm": sddmm_sharded_local(blocked, q, kk, part, r),
                "attn": attention_sharded_local(blocked, q, kk, vv, aligned,
                                                r, scale=0.5)}
        torch.testing.assert_close(outs["spmm"],
                                   spmm_balanced_plain(blocked, b, loc),
                                   rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(outs["sddmm"],
                                   sddmm_balanced_plain(blocked, q, kk, loc),
                                   rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(
            outs["attn"], attention_balanced_plain(blocked, q, kk, vv, loc_a,
                                                   0.5), rtol=RTOL, atol=ATOL)
        if k_blk == 8 and n % 2 == 0:
            b16 = b.to(BF16)
            _one_ulp(spmm_sharded_local(with_values(blocked, blocked.vals.to(
                BF16)), b16, part, r), spmm_balanced_plain(
                    with_values(blocked, blocked.vals.to(BF16)), b16, loc))
        for key, x in outs.items():
            sums[key] = sums.get(key, 0) + x
    torch.testing.assert_close(sums["spmm"], spmm_balanced_cuda(blocked, b),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(sums["sddmm"],
                               sddmm_balanced_cuda(blocked, q, kk),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        sums["attn"], attention_balanced_cuda(blocked, q, kk, vv, scale=0.5),
        rtol=RTOL, atol=ATOL)


def test_sharded_plan_trains_on_a_one_rank_nccl_mesh(device):
    """A GCN step on ``cuda_sharded`` and ``cuda_sharded_overlap`` plans
    over a one-rank NCCL mesh against the ``cuda_balanced`` plan."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import one_rank_mesh

    rng = np.random.default_rng(31)
    a = _matrix(rng, 120, 120, 0.08)
    np.fill_diagonal(a, 1.0)
    fmt = from_dense(a)
    cfg_kw = dict(model="gcn", in_dim=16, hidden_dim=32, num_classes=4,
                  num_layers=3)
    x = torch.from_numpy(rng.standard_normal((120, 16)).astype(
        np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 4, 120)).to(device)
    mask = torch.ones(120, device=device)

    def grads(impl, mesh=None):
        cfg = gnn.GNNConfig(impl=impl, **cfg_kw)
        net = gnn.GCN(cfg, device=device, seed=0)
        plan = ad_plan(fmt, impl=impl, device=device, mesh=mesh)
        loss, _ = gnn.gnn_loss(net.params(), plan, x, labels, mask, cfg)
        loss.backward()
        return loss.item(), [p.grad for p in net.parameters()]

    want_loss, want = grads("cuda_balanced")
    with one_rank_mesh(device) as mesh:
        assert dist.get_backend() == "nccl"
        for impl in ("cuda_sharded", "cuda_sharded_overlap"):
            loss, got = grads(impl, mesh)
            assert loss == pytest.approx(want_loss, rel=1e-5)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "moonshot-v1-16b-a3b",
                                  "mamba2-2.7b"])
def test_lm_train_step_on_card_matches_cpu(device, arch, monkeypatch):
    """The LM train step at ``get_reduced`` size, fp32 (TF32 off): the
    card's loss and gradients against the CPU's from the same state and
    batch (loss ``rtol=1e-5``; gradients ``rtol=1e-3`` and ``1e-4`` of
    the largest, fp32 sums in another order), then one step each: the
    metrics, and every parameter within ``2 lr`` (Adam moves an entry by
    about ``lr`` either way, so a gradient within rounding of 0 may step
    the other way)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.synthetic import make_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.pytree import leaf_paths, tree_map
    from repro_torch.train.train_step import (TrainStepConfig,
                                              accumulate_grads,
                                              init_train_state,
                                              make_train_step)

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_reduced(arch)
    lr = 1e-3
    ts = TrainStepConfig(opt=AdamWConfig(lr=lr, warmup_steps=1),
                         microbatches=2)
    host = init_train_state(cfg, ts, torch.Generator().manual_seed(0),
                            device="cpu")
    card = tree_map(lambda t: t.to(device), host)
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, 4, 32, step=0, seed=0).items()}
    batch_card = {k: v.to(device) for k, v in batch.items()}

    loss_c, _, grads_c = accumulate_grads(cfg, ts, card["params"], batch_card)
    loss_h, _, grads_h = accumulate_grads(cfg, ts, host["params"], batch)
    assert float(loss_c) == pytest.approx(float(loss_h), rel=1e-5)
    top = max(float(g.abs().max()) for _, g in leaf_paths(grads_h))
    for (path, gc), (_, gh) in zip(leaf_paths(grads_c), leaf_paths(grads_h)):
        torch.testing.assert_close(gc.cpu(), gh, rtol=1e-3, atol=1e-4 * top,
                                   msg=path)

    step = make_train_step(cfg, ts)
    card, m_c = step(card, batch_card)
    host, m_h = step(host, batch)
    torch.cuda.synchronize()
    assert float(m_c["loss"]) == pytest.approx(float(m_h["loss"]), rel=1e-5)
    assert float(m_c["grad_norm"]) == pytest.approx(float(m_h["grad_norm"]),
                                                    rel=1e-3)
    assert float(m_c["lr"]) == pytest.approx(float(m_h["lr"]), rel=1e-6)
    assert int(card["step"]) == int(host["step"]) == 1
    for (path, pc), (_, ph) in zip(leaf_paths(card["params"]),
                                   leaf_paths(host["params"])):
        assert pc.device.type == "cuda"
        torch.testing.assert_close(pc.cpu(), ph, rtol=0, atol=2 * lr,
                                   msg=path)


def test_sharded_lm_step_on_a_one_rank_nccl_mesh_matches_plain(device,
                                                                monkeypatch):
    """Two train steps of reduced qwen3 with the state as DTensors on a
    one-rank NCCL mesh against two plain steps from the same state, fp32
    (TF32 off): one rank runs the plain ops on whole shards, so the
    losses and every leaf agree within ``1e-6`` of the leaf's largest."""
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.distributed.elastic import reshard_state, whole
    from repro_torch.distributed.sharding import batch_pspec, placements
    from repro_torch.launch.mesh import one_rank_mesh
    from repro_torch.pytree import leaf_paths
    from repro_torch.train.train_step import (TrainStepConfig,
                                              init_train_state,
                                              make_train_step)
    from torch.distributed.tensor import DTensor, distribute_tensor

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_reduced("qwen3-0.6b")
    ts = TrainStepConfig()
    state = init_train_state(cfg, ts, torch.Generator(device).manual_seed(0),
                             device)
    step = make_train_step(cfg, ts)
    rng = np.random.default_rng(0)
    with one_rank_mesh(device) as mesh:
        assert dist.get_backend() == "nccl"
        sharded = reshard_state(state, mesh)
        for _ in range(2):
            tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))
                                      ).to(device)
            state, met = step(state, {"tokens": tokens})
            sharded, met_s = step(sharded, {"tokens": distribute_tensor(
                tokens, mesh, placements(batch_pspec(mesh), mesh),
                src_data_rank=None)})
            assert float(met_s["loss"]) == pytest.approx(float(met["loss"]),
                                                         rel=1e-6)
        for (path, want), (_, got) in zip(leaf_paths(state),
                                          leaf_paths(sharded)):
            assert isinstance(got, DTensor), path
            g = whole(got)
            top = float(want.abs().max()) if want.numel() else 0.0
            assert float((g.double() - want.double()).abs().max()) <= \
                1e-6 * max(top, 1e-30), path
    assert not dist.is_initialized()


@pytest.mark.parametrize("model", [2, 4])
def test_moe_ep_rank_bodies_sum_to_the_dense_moe_on_card(device, model):
    """Every rank's ``moe_ffn_ep_local`` of reduced moonshot ("data" = 1,
    dropless) summed on the card against the dense ``moe_ffn``, fp32
    (TF32 off): the same routing, sums in another order."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.layers import (init_moe, mlp, moe_ep_capacity,
                                           moe_ffn, moe_ffn_ep_local)

    cfg = get_reduced("moonshot-v1-16b-a3b", capacity_factor=4.0)
    gen = torch.Generator(device).manual_seed(0)
    p = init_moe(cfg, gen, device)
    x = torch.randn((4, 16, cfg.d_model), generator=gen, device=device)
    want, aux = moe_ffn(p, x, cfg)
    xt = x.reshape(-1, cfg.d_model)
    e_loc = cfg.moe_experts // model
    total = 0.0
    for j in range(model):
        loc = {"router": p["router"],
               **{k: p[k][j * e_loc:(j + 1) * e_loc]
                  for k in ("w_gate", "w_up", "w_down")}}
        part, me, ce, _ = moe_ffn_ep_local(
            loc, xt, cfg, j0=j * e_loc,
            cap_loc=moe_ep_capacity(xt.shape[0], cfg))
        total = total + part
    got = total + mlp(p["shared"], xt)
    torch.testing.assert_close(got, want.reshape(got.shape), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert float(cfg.moe_experts * torch.sum(me * ce)) == pytest.approx(
        float(aux), rel=1e-6)


def test_dryrun_flop_count_on_card_equals_meta(device):
    """The training phase's bf16 step at full width, 2 of 28 layers (8 x
    4,096 tokens in 4 microbatches, a one-rank mesh), traced on ``meta``
    and on the card's tensors: the same flops and bytes (exact), and the
    predicted peak within the dry-run phase's gate of
    ``max_memory_allocated``."""
    from repro_torch.testing import dryrun_card

    out = dryrun_card.count_twice(device, log=lambda *_: None, n_layers=2)
    assert out["flops_meta"] == out["flops_card"] > 0
    assert out["bytes_meta"] == out["bytes_card"]
    assert out["peak_error"] <= dryrun_card.PEAK_GATE
