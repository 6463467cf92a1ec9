"""The port's structural validator and the wrappers' argument contract.

* Every CUDA wrapper refuses, on CPU tensors, what its card path refuses
  (a column tile of 0, a wrongly shaped operand, a vector size the
  kernels do not take), with the card path's message: the checks run
  before the device branch.
* ``repro_torch.core.validate`` names the invariant ``repro.core.validate``
  names, at the same level, for each corruption of a vendored matrix's
  canonical format, blocked view and schedule.
* The levels resolve as the reference's (explicit, context,
  ``REPRO_TORCH_CHECK``, ``"none"``), the builders take ``check=``, and
  at the default level the entry points and a train step run no
  validation code.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import format as jformat
from repro.core import quantize as jquantize
from repro.core import validate as jvalidate
from repro.data import datasets as jds
from repro_torch.core import format as tformat
from repro_torch.core import quantize as tquantize
from repro_torch.core import validate as tvalidate
from repro_torch.core.validate import ValidationError
from repro_torch.data import datasets as tds
from repro_torch.kernels import (attention_balanced_cuda, attention_cuda,
                                 sddmm_balanced_cuda, sddmm_batched_cuda,
                                 sddmm_cuda, spmm_balanced_cuda,
                                 spmm_batched_cuda, spmm_cuda,
                                 spmm_noncoalesced_cuda, spmm_staged_cuda)
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

MATRIX = "hub_96"  # hub windows: schedules with several segments a window


def _pair():
    """(reference sample, port sample) of MATRIX."""
    return jds.load_vendored([MATRIX])[0], tds.load_vendored([MATRIX])[0]


def _outcome(fn):
    """The invariant a call names, ``"pass"``, or another error's type."""
    try:
        fn()
    except (ValidationError, jvalidate.ValidationError) as e:
        return e.invariant
    except Exception as e:  # noqa: BLE001 — compared between packages
        return type(e).__name__
    return "pass"


def _corrupt(ref_obj, port_obj, **fields):
    """Both objects with ``fields`` replaced by the same numpy arrays
    (``None`` drops an optional field)."""
    def conv(x, to):
        return None if x is None else to(np.array(x))
    return (dataclasses.replace(ref_obj, **{
        k: conv(v, jnp.asarray) for k, v in fields.items()}),
            dataclasses.replace(port_obj, **{
                k: conv(v, torch.from_numpy) for k, v in fields.items()}))


def _first(mask, value=True):
    pos = np.argwhere(mask == value)
    return tuple(pos[0])


# ---------------------------------------------------------------------------
# The wrappers refuse on the CPU what they refuse on the card
# ---------------------------------------------------------------------------


def _view(vector_size=8):
    rng = np.random.default_rng(0)
    a = ((rng.random((40, 36)) < 0.3)
         * rng.standard_normal((40, 36))).astype(np.float32)
    return tformat.block_format(tformat.from_dense(a, vector_size), 8,
                                device="cpu")


def _dense(*shape):
    return torch.ones(shape, dtype=torch.float32)


# wrapper -> (the call on a view, the column tile it takes or None, the
# wrong-shape call, its message)
_SPMM_B = "b must be"
_WRAPPERS = {
    "spmm_cuda": (lambda bl, **kw: spmm_cuda(bl, _dense(36, 16), **kw),
                  True, lambda bl: spmm_cuda(bl, _dense(35, 16)), _SPMM_B),
    "spmm_batched_cuda": (
        lambda bl, **kw: spmm_batched_cuda(bl, _dense(2, 36, 16), **kw),
        True, lambda bl: spmm_batched_cuda(bl, _dense(2, 35, 16)), _SPMM_B),
    "spmm_balanced_cuda": (
        lambda bl, **kw: spmm_balanced_cuda(bl, _dense(36, 16), **kw),
        True, lambda bl: spmm_balanced_cuda(bl, _dense(35, 16)), _SPMM_B),
    "spmm_staged_cuda": (
        lambda bl, **kw: spmm_staged_cuda(bl, _dense(36, 16), **kw),
        True, lambda bl: spmm_staged_cuda(bl, _dense(35, 16)), "need vals"),
    "spmm_noncoalesced_cuda": (
        lambda bl: spmm_noncoalesced_cuda(bl, _dense(36, 16)), False,
        lambda bl: spmm_noncoalesced_cuda(bl, _dense(35, 16)), "need vals"),
    "sddmm_cuda": (lambda bl: sddmm_cuda(bl, _dense(40, 8), _dense(36, 8)),
                   False, lambda bl: sddmm_cuda(bl, _dense(40, 8),
                                                _dense(36, 7)), "need q"),
    "sddmm_batched_cuda": (
        lambda bl: sddmm_batched_cuda(bl, _dense(2, 40, 8), _dense(36, 8)),
        False, lambda bl: sddmm_batched_cuda(bl, _dense(2, 41, 8),
                                             _dense(36, 8)), "need q"),
    "sddmm_balanced_cuda": (
        lambda bl: sddmm_balanced_cuda(bl, _dense(40, 8), _dense(36, 8)),
        False, lambda bl: sddmm_balanced_cuda(bl, _dense(40, 8),
                                              _dense(37, 8)), "need q"),
    "attention_cuda": (
        lambda bl: attention_cuda(bl, _dense(40, 8), _dense(36, 8),
                                  _dense(36, 4)), False,
        lambda bl: attention_cuda(bl, _dense(40, 8), _dense(36, 8),
                                  _dense(35, 4)), "need q"),
    "attention_balanced_cuda": (
        lambda bl: attention_balanced_cuda(bl, _dense(40, 8), _dense(36, 8),
                                           _dense(36, 4)), False,
        lambda bl: attention_balanced_cuda(bl, _dense(40, 8), _dense(36, 7),
                                           _dense(36, 4)), "need q"),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrapper_refuses_on_cpu_with_the_card_message(name):
    call, tiled, wrong_shape, shape_msg = _WRAPPERS[name]
    blocked = _view()
    assert call(blocked) is not None              # accepted arguments run
    if tiled:  # the tiled kernels take 32 to at most 512 columns
        for n_blk in (0, 1024):
            with pytest.raises(ValueError, match=rf"^{name}: n_blk={n_blk} "
                               r"must be a multiple of 32 in \[32, \d+\]$"):
                call(blocked, n_blk=n_blk)
    with pytest.raises(ValueError, match=rf"^{name}: {shape_msg}"):
        wrong_shape(blocked)
    with pytest.raises(ValueError, match=rf"^{name}: vector_size 4 not in "
                       r"\(8, 16\)$"):
        call(_view(vector_size=4))


def test_balanced_wrappers_refuse_a_foreign_schedule_on_cpu():
    blocked, other = _view(), _view(vector_size=16)
    # the all-empty view of the same shape: as many windows, no block
    empty = tformat.block_format(
        tformat.from_dense(np.zeros((40, 36), np.float32)), 8, device="cpu")
    for sched in (other.schedule(1), empty.schedule(1)):
        with pytest.raises(ValueError, match="spmm_balanced_cuda"):
            spmm_balanced_cuda(blocked, _dense(36, 16), schedule=sched)
        with pytest.raises(ValueError, match="attention_balanced_cuda"):
            attention_balanced_cuda(blocked, _dense(40, 8), _dense(36, 8),
                                    _dense(36, 4), schedule=sched)
        with pytest.raises(ValueError, match="schedule is not this view's"):
            sddmm_balanced_cuda(blocked, _dense(40, 8), _dense(36, 8),
                                schedule=sched)
    # the empty view's own schedule is served: all zeros
    assert not spmm_balanced_cuda(empty, _dense(36, 16)).any()
    assert not sddmm_balanced_cuda(empty, _dense(40, 8), _dense(36, 8)).any()


# ---------------------------------------------------------------------------
# The validator names the reference's invariant
# ---------------------------------------------------------------------------


def _format_corruptions(f):
    rp, ci = np.asarray(f.row_pointers), np.asarray(f.column_indices)
    vals, mask = np.asarray(f.values), np.asarray(f.mask)
    w, k = rp.shape[0] - 1, f.shape[1]
    swapped = rp.copy()
    swapped[1], swapped[-1] = swapped[-1], swapped[1]
    nan, pad = vals.copy(), vals.copy()
    nan[_first(mask)] = np.nan
    pad[_first(mask, False)] = 1.0
    dup = ci.copy()
    win = int(np.nonzero(np.diff(rp) >= 2)[0][0])
    dup[rp[win] + 1] = dup[rp[win]]
    oob = ci.copy()
    oob[0] = k + 3
    return {
        "row_ptr_short": dict(row_pointers=rp[:-1]),
        "row_ptr_float": dict(row_pointers=rp.astype(np.float32)),
        "row_ptr_swapped": dict(row_pointers=swapped),
        "row_ptr_past_end": dict(row_pointers=np.append(rp[:-1], rp[-1] + 1)),
        "cols_short": dict(column_indices=ci[:-1]),
        "cols_oob": dict(column_indices=oob),
        "values_narrow": dict(values=vals[:, :-1]),
        "mask_float": dict(mask=mask.astype(np.float32)),
        "values_nan": dict(values=nan),
        "masked_nonzero": dict(values=pad),
        "duplicate_vector": dict(column_indices=dup),
        "clean": {},
    }, w


def _blocked_corruptions(bl, qbl):
    vals, cols = np.asarray(bl.vals), np.asarray(bl.cols)
    mask, bwin = np.asarray(bl.mask), np.asarray(bl.block_win)
    wp = np.asarray(bl.win_ptr)
    swapped = wp.copy()
    swapped[1], swapped[-1] = swapped[-1], swapped[1]
    nan, pad = vals.copy(), vals.copy()
    nan[_first(mask)] = np.nan
    pad[_first(mask, False)] = 1.0
    oob = cols.copy()
    oob[0] = bl.shape[1] + 7
    moved = bwin.copy()
    moved[0] += 1
    sc = np.asarray(qbl.scales)
    bad_sc = sc.copy()
    bad_sc[0] = -1.0
    return {
        "win_ptr_short": (dict(win_ptr=wp[:-1]), False),
        "win_ptr_float": (dict(win_ptr=wp.astype(np.float32)), False),
        "win_ptr_swapped": (dict(win_ptr=swapped), False),
        "win_ptr_past_end": (dict(win_ptr=np.append(wp[:-1], wp[-1] + 9)),
                             False),
        "vals_short": (dict(vals=vals[:-bl.k_blk]), False),
        "mask_float": (dict(mask=mask.astype(np.float32)), False),
        "cols_oob": (dict(cols=oob), False),
        "block_win_moved": (dict(block_win=moved), False),
        "vals_nan": (dict(vals=nan), False),
        "padding_nonzero": (dict(vals=pad), False),
        "scales_short": (dict(scales=sc[:-1]), True),
        "scales_negative": (dict(scales=bad_sc), True),
        "scales_nan": (dict(scales=np.full_like(sc, np.nan)), True),
        "scales_on_fp32": (dict(scales=sc), False),
        "int8_without_scales": (dict(scales=None), True),
        "clean": ({}, False),
        "clean_int8": ({}, True),
    }


def _schedule_corruptions(s):
    sw, sm = np.asarray(s.seg_win), np.asarray(s.seg_meta)
    blk_id, blk_win = np.asarray(s.blk_id), np.asarray(s.blk_win)
    out = {"meta_3_cols": dict(seg_meta=sm[:, :3]), "clean": {}}
    neg, flag2, lo, ln = sm.copy(), sm.copy(), sm.copy(), sm.copy()
    neg[0, 1] = -1
    flag2[0, 2] = 2
    busy = int(np.nonzero(sm[:, 1] > 0)[0][0])
    lo[busy, 0] += 1
    ln[busy, 1] += 1
    out.update(neg_len=dict(seg_meta=neg), flag_2=dict(seg_meta=flag2),
               lo_shifted=dict(seg_meta=lo), len_plus_1=dict(seg_meta=ln))
    # a window with two segments: its second also flagged first
    two = int(np.nonzero(sm[:, 2] == 0)[0][0])
    first2 = sm.copy()
    first2[two, 2] = 1
    out["second_flagged_first"] = dict(seg_meta=first2)
    win_oob = sw.copy()
    win_oob[-1] = sw.max() + 1
    swap = sw.copy()
    swap[two - 1], swap[two + 1] = sw[two + 1], sw[two - 1]
    out.update(seg_win_oob=dict(seg_win=win_oob),
               seg_win_swapped=dict(seg_win=swap))
    bid = blk_id.copy()
    bid[0] = blk_id.shape[0]
    bw = blk_win.copy()
    bw[-1] += 1
    out.update(blk_id_oob=dict(blk_id=bid), blk_id_short=dict(blk_id=bid[:-1]),
               blk_win_moved=dict(blk_win=bw))
    return out


@pytest.mark.parametrize("level", ["cheap", "full"])
def test_format_corruptions_name_the_reference_invariant(level):
    jsample, tsample = _pair()
    jf, tf = jsample.to_format(), tsample.to_format()
    cases, _ = _format_corruptions(jf)
    for name, fields in cases.items():
        jbad, tbad = _corrupt(jf, tf, **fields)
        want = _outcome(lambda: jvalidate.validate(jbad, check=level))
        got = _outcome(lambda: tvalidate.validate(tbad, check=level))
        assert got == want, (name, level)
    assert _outcome(lambda: tvalidate.validate(tf, check=level)) == "pass"


@pytest.mark.parametrize("level", ["cheap", "full"])
def test_blocked_corruptions_name_the_reference_invariant(level):
    jsample, tsample = _pair()
    jbl = jformat.block_format(jsample.to_format(), 8)
    tbl = tformat.block_format(tsample.to_format(), 8, device="cpu")
    jq, tq = jquantize.quantize_format(jbl), tquantize.quantize_format(tbl)
    named = set()
    for name, (fields, quant) in _blocked_corruptions(jbl, jq).items():
        jbad, tbad = _corrupt(jq if quant else jbl, tq if quant else tbl,
                              **fields)
        want = _outcome(lambda: jvalidate.validate(jbad, check=level))
        got = _outcome(lambda: tvalidate.validate(tbad, check=level))
        assert got == want, (name, level)
        named.add(got)
    jk, tk = (dataclasses.replace(x, k_blk=0) for x in (jbl, tbl))
    assert (_outcome(lambda: tvalidate.validate(tk, check=level))
            == _outcome(lambda: jvalidate.validate(jk, check=level)))
    if level == "full":
        assert {"win-ptr-shape", "dtype-mismatch", "win-ptr-monotone",
                "win-ptr-bounds", "leaf-length", "mask-dtype",
                "col-in-bounds", "block-win-consistent", "values-finite",
                "masked-zeros", "scales-shape", "scales-finite"} <= named


@pytest.mark.parametrize("level", ["cheap", "full"])
@pytest.mark.parametrize("split", [1, 2])
def test_schedule_corruptions_name_the_reference_invariant(level, split):
    jsample, tsample = _pair()
    jbl = jformat.block_format(jsample.to_format(), 8)
    tbl = tformat.block_format(tsample.to_format(), 8, device="cpu")
    js, ts = jformat.build_schedule(jbl, split), tformat.build_schedule(
        tbl, split)
    for name, fields in _schedule_corruptions(js).items():
        jbad, tbad = _corrupt(js, ts, **fields)
        for with_view in (False, True):
            want = _outcome(lambda: jvalidate.validate(
                jbad, blocked=jbl if with_view else None, check=level))
            got = _outcome(lambda: tvalidate.validate(
                tbad, blocked=tbl if with_view else None, check=level))
            assert got == want, (name, level, with_view)


def test_the_vendored_set_validates_clean_at_full():
    for sample in tds.load_vendored():
        fmt = sample.to_format(check="full")
        blocked = tformat.block_format(fmt, 8, device="cpu", check="full")
        for split in (0, 1, 2):
            tformat.build_schedule(blocked, split, check="full")


# ---------------------------------------------------------------------------
# Levels, builders, and the default path
# ---------------------------------------------------------------------------


def test_check_level_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_CHECK", raising=False)
    assert tvalidate.check_level() == "none"
    monkeypatch.setenv("REPRO_TORCH_CHECK", "full")
    assert tvalidate.check_level() == "full"
    with tvalidate.checking("cheap"):
        assert tvalidate.resolve_check(None) == "cheap"
        assert tvalidate.resolve_check("none") == "none"
        assert tvalidate.effective_check(None) == "cheap"
    monkeypatch.setenv("REPRO_TORCH_CHECK", "bogus")
    assert tvalidate.check_level() == "none"
    for bad in (lambda: tvalidate.resolve_check("everything"),
                lambda: tvalidate.checking("x").__enter__()):
        with pytest.raises(ValueError, match="check must be one of"):
            bad()
    assert tvalidate.CHECK_LEVELS == jvalidate.CHECK_LEVELS


def test_builders_take_check_with_the_reference_semantics():
    rows, cols = np.array([0, 1, 1, 5]), np.array([0, 2, 2, 3])
    vals = np.ones(4, np.float32)
    with pytest.warns(tvalidate.ValidationWarning, match="coalesced 1"):
        tformat.from_coo(rows, cols, vals, (8, 4), check="full")
    for kw in ({"duplicates": "error"}, {"duplicates": "error",
                                         "check": "none"}):
        with pytest.raises(ValidationError, match="duplicate-coords"):
            tformat.from_coo(rows, cols, vals, (8, 4), **kw)
    with pytest.raises(ValidationError, match="coo-in-bounds"):
        tformat.from_coo(rows, cols + 2, vals, (8, 4), check="none")
    fmt = tformat.from_coo(rows[:3], cols[:3] + np.array([0, 0, 1]),
                           vals[:3], (8, 4))
    bad = dataclasses.replace(fmt, values=fmt.values * float("nan"))
    with pytest.raises(ValidationError, match="values-finite"):
        tformat.block_format(bad, 8, device="cpu", check="cheap")
    blocked = tformat.block_format(bad, 8, device="cpu")  # level none
    with pytest.raises(ValidationError, match="values-finite"):
        tformat.build_schedule(blocked, 1, check="full")
    with tvalidate.checking("full"):
        with pytest.raises(ValidationError, match="values-finite"):
            tformat.build_schedule(blocked, 1)
    tformat.build_schedule(blocked, 1, check="none")


def test_default_level_runs_no_validation(monkeypatch):
    """With ``check`` and ``REPRO_TORCH_CHECK`` unset, the entry points
    and a train step run on a validator that would raise on any call."""
    from repro_torch.core import ad_plan, attention, sddmm, spmm
    from repro_torch.models import gnn
    from repro_torch.train.train_step import make_gnn_train_step

    monkeypatch.delenv("REPRO_TORCH_CHECK", raising=False)

    def boom(*a, **k):
        raise AssertionError("validation ran at level none")

    for name in ("validate", "validate_format", "validate_blocked",
                 "validate_schedule", "cheap_guard", "guard_operand"):
        monkeypatch.setattr(tvalidate, name, boom)
    rng = np.random.default_rng(1)
    a = ((rng.random((32, 32)) < 0.3)
         * rng.standard_normal((32, 32))).astype(np.float32)
    fmt = tformat.from_dense(a)
    x = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    for impl in ("blocked", "cuda", "cuda_balanced"):
        spmm(fmt, x, impl=impl)
        sddmm(fmt, x, x, impl=impl)
    attention(fmt, x, x, x, impl="cuda_fused_attn")
    with pytest.raises(AssertionError, match="level none"):
        spmm(fmt, x, impl="cuda", check="cheap")
    cfg = gnn.GNNConfig(model="gcn", in_dim=8, hidden_dim=8, num_classes=3,
                        num_layers=2, impl="cuda_balanced")
    plan = ad_plan(fmt, impl="cuda_balanced", device="cpu")
    model = gnn.GCN(cfg, device="cpu")
    step = make_gnn_train_step(cfg, model, lr=0.1)
    labels = torch.zeros(32, dtype=torch.long)
    loss, _ = step(plan, x, labels, torch.ones(32))
    assert torch.isfinite(torch.as_tensor(loss)).all()
