"""The port's gradient compression (``repro_torch.train.compression``,
``compressed_psum``) against the JAX package's on the CPU.

Both packages compress the same gradients (numpy, the reduced qwen3's
tree in the stacked layout, where ``layers/attn_norm`` is ``(2, 128)``:
at block 256 one block spans both layers).  The int8 codes, scales and
error buffers are bitwise the reference's (one quantizer,
``core/quantize.py``, on both sides); top-k selects the same index set
with the same values.  ``compressed_psum`` runs on two gloo ranks in one
spawn, against the reference's under ``jax.vmap`` with a named axis and
against the exact mean.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import lm as jlm
from repro.train import compression as jcomp
from repro.train import train_step as jts
from repro_torch import configs as tcfg
from repro_torch.testing.multirank import spawn
from repro_torch.train import compression as tcomp
from repro_torch.pytree import leaf_paths, tree_map
from repro_torch.train.train_step import train_state_from_jax
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

CFG_T = tcfg.get_reduced("qwen3-0.6b")


@pytest.fixture(scope="module")
def grads():
    """Two rounds of gradients at the reduced qwen3's stacked leaves."""
    params = jlm.init_lm(jax.random.key(0), jcfg.get_reduced("qwen3-0.6b"))
    rng = np.random.default_rng(0)
    return [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2
                                    ).astype(np.float32), params)
            for _ in range(2)]


def _port(tree):
    return train_state_from_jax(CFG_T, {"params": tree}, device="cpu")[
        "params"]


def _bitwise(port, ref, label=""):
    want = dict(leaf_paths(jax.tree.map(np.asarray, ref)))
    got = leaf_paths(port)
    assert sorted(p for p, _ in got) == sorted(want), label
    for path, t in got:
        w = want[path]
        assert tuple(t.shape) == w.shape, f"{label} {path}"
        assert str(t.dtype).removeprefix("torch.") == w.dtype.name, path
        assert np.array_equal(t.numpy(), w), f"{label} {path}"


def _leaf_at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("block", [256, 128])
def test_int8_matches_jax_bitwise_with_error_feedback(grads, block):
    """Two rounds with error feedback: codes, scales, new errors and the
    decompressed gradients, bitwise."""
    cj = jcomp.CompressionConfig(kind="int8", block=block)
    ct = tcomp.CompressionConfig(kind="int8", block=block)
    err_j = jcomp.init_error(grads[0])
    err_t = tcomp.init_error(_port(grads[0]))
    for rnd, g in enumerate(grads):
        comp_j, err_j = jcomp.compress_int8(g, err_j, cj)
        comp_t, err_t = tcomp.compress_int8(_port(g), err_t, ct)
        _bitwise(comp_t, comp_j, f"round {rnd} comp")
        _bitwise(err_t, err_j, f"round {rnd} err")
        _bitwise(tcomp.decompress_int8(comp_t, _port(g)),
                 jcomp.decompress_int8(comp_j, g), f"round {rnd} g_hat")
    # the (2, 128) per-layer norm is one leaf: at block 256 one block
    # spans both layers, with one scale
    norm = comp_t["layers"]["attn_norm"]
    assert tuple(norm["scale"].shape) == ((1,) if block == 256 else (2,))


def test_topk_matches_jax(grads):
    """The same index set and values per leaf (``k`` over the whole
    stacked leaf), the same errors and decompressed gradients."""
    cj = jcomp.CompressionConfig(kind="topk", topk_frac=0.05)
    ct = tcomp.CompressionConfig(kind="topk", topk_frac=0.05)
    err_j = jcomp.init_error(grads[0])
    err_t = tcomp.init_error(_port(grads[0]))
    for rnd, g in enumerate(grads):
        comp_j, err_j = jcomp.compress_topk(g, err_j, cj)
        comp_t, err_t = tcomp.compress_topk(_port(g), err_t, ct)
        want = dict(leaf_paths(jax.tree.map(np.asarray, comp_j)))
        for path, _ in leaf_paths(_port(g)):
            idx_t = _leaf_at(comp_t, path)["idx"].numpy()
            val_t = _leaf_at(comp_t, path)["val"].numpy()
            idx_j, val_j = want[f"{path}/idx"], want[f"{path}/val"]
            assert idx_t.dtype == np.int32 and idx_t.shape == idx_j.shape
            order_t, order_j = np.argsort(idx_t), np.argsort(idx_j)
            assert np.array_equal(idx_t[order_t], idx_j[order_j]), path
            assert np.array_equal(val_t[order_t], val_j[order_j]), path
        _bitwise(err_t, err_j, f"round {rnd} err")
        _bitwise(tcomp.decompress_topk(comp_t, _port(g)),
                 jcomp.decompress_topk(comp_j, g), f"round {rnd} g_hat")
    size = CFG_T.n_layers * CFG_T.d_model
    assert comp_t["layers"]["attn_norm"]["idx"].numel() == int(size * 0.05)


def test_error_feedback_keeps_what_was_dropped(grads):
    """Over rounds, the decompressed gradients plus the last error equal
    the sum of the gradients: compression delays, never loses."""
    for cfg in (tcomp.CompressionConfig(kind="int8", block=256),
                tcomp.CompressionConfig(kind="topk", topk_frac=0.05)):
        compress = (tcomp.compress_int8 if cfg.kind == "int8"
                    else tcomp.compress_topk)
        decompress = (tcomp.decompress_int8 if cfg.kind == "int8"
                      else tcomp.decompress_topk)
        gs = [_port(g) for g in grads]
        err = tcomp.init_error(gs[0])
        sent = None
        for g in gs:
            comp, err = compress(g, err, cfg)
            ghat = decompress(comp, g)
            sent = ghat if sent is None else tree_map(
                lambda a, b: a + b, sent, ghat)
        for (path, s), (_, e), (_, g0), (_, g1) in zip(
                leaf_paths(sent), leaf_paths(err), leaf_paths(gs[0]),
                leaf_paths(gs[1])):
            torch.testing.assert_close(s + e, g0 + g1, rtol=1e-6, atol=1e-7,
                                       msg=f"{cfg.kind} {path}")


def test_byte_counts_match_jax(grads):
    g = grads[0]
    gt = _port(g)
    assert tcomp.raw_bytes(gt) == jcomp.raw_bytes(g)
    for kind in ("int8", "topk"):
        cj = jcomp.CompressionConfig(kind=kind)
        ct = tcomp.CompressionConfig(kind=kind)
        fj = jcomp.compress_int8 if kind == "int8" else jcomp.compress_topk
        ft = tcomp.compress_int8 if kind == "int8" else tcomp.compress_topk
        comp_j, _ = fj(g, jcomp.init_error(g), cj)
        comp_t, _ = ft(gt, tcomp.init_error(gt), ct)
        assert tcomp.compressed_bytes(comp_t) == jcomp.compressed_bytes(comp_j)
    assert tcomp.compressed_bytes(comp_t) < tcomp.raw_bytes(gt) / 4


def test_compressed_psum_on_two_gloo_ranks(tmp_path):
    """Two ranks' int8-compressed mean against the reference's (under a
    named ``vmap`` axis) and against the exact mean, within one
    quantization step of each rank's block."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 123)) * [[[1.0]], [[30.0]]]
         ).astype(np.float32)
    block = 64
    res = spawn(2, [("psum", (2, 1), "compressed_psum",
                     {"x": x, "block": block})], tmp_path)
    want = np.asarray(jax.vmap(
        lambda v: jts.compressed_psum(v, "ranks", block=block),
        axis_name="ranks")(jnp.asarray(x)))
    for r in range(2):
        got = res[r]["psum"]["fp32"]
        assert got.dtype == torch.float32 and tuple(got.shape) == (5, 123)
        np.testing.assert_allclose(got.numpy(), want[r], rtol=1e-6,
                                   atol=1e-7 * np.abs(want).max())
        step = np.abs(x).max() / 127.0
        np.testing.assert_allclose(got.numpy(), x.mean(axis=0), rtol=0,
                                   atol=step)
        assert torch.equal(got, res[1 - r]["psum"]["fp32"])
        assert res[r]["psum"]["bf16"].dtype == torch.bfloat16
