"""The port's synthetic data (``repro_torch.data.synthetic``) against the
JAX package's (``repro.data.synthetic``) on the CPU.

Batches are numpy on both sides and must be bitwise equal for every
architecture family, several steps, seeds and host shards; the ``meta``
specs must give each batch's shapes and dtypes; the synthetic sparse
matrices must be the reference's COO and ME-BCRS arrays.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import format as jformat
from repro.data import synthetic as jsyn
from repro_torch import configs as tcfg
from repro_torch.core.format import to_dense
from repro_torch.data import synthetic as tsyn
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

FAMILIES = {
    "dense": "qwen3-0.6b",
    "moe": "moonshot-v1-16b-a3b",
    "mla": "deepseek-v3-671b",
    "ssm": "mamba2-2.7b",
    "hybrid": "zamba2-1.2b",
    "encdec": "seamless-m4t-medium",
    "vlm": "internvl2-76b",
}


def _same(port: dict, ref: dict) -> None:
    assert sorted(port) == sorted(ref)
    for key, val in ref.items():
        assert port[key].dtype == val.dtype, key
        assert port[key].shape == val.shape, key
        assert np.array_equal(port[key], val), key


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batches_are_bitwise_the_references(family):
    """Every family at reduced and published size: steps 0-3, two seeds,
    two host shards."""
    arch = FAMILIES[family]
    for jc, tc in ((jcfg.get_reduced(arch), tcfg.get_reduced(arch)),
                   (jcfg.get_config(arch), tcfg.get_config(arch))):
        for seed, shard in ((0, 0), (3, 1)):
            ref = jsyn.SyntheticLMData(jc, 4, 40, seed=seed, host_shard=shard)
            port = tsyn.SyntheticLMData(tc, 4, 40, seed=seed,
                                        host_shard=shard)
            for step in range(4):
                _same(port.batch(step), ref.batch(step))
    _same(tsyn.make_batch(tcfg.get_reduced(arch), 2, 16, step=5, seed=2),
          jsyn.make_batch(jcfg.get_reduced(arch), 2, 16, step=5, seed=2))


def test_batches_are_a_function_of_the_step_alone():
    cfg = tcfg.get_reduced("qwen3-0.6b")
    data = tsyn.SyntheticLMData(cfg, 2, 128)
    again = tsyn.SyntheticLMData(cfg, 2, 128)
    assert np.array_equal(data.batch(7)["tokens"], again.batch(7)["tokens"])
    assert not np.array_equal(data.batch(7)["tokens"],
                              data.batch(8)["tokens"])
    tokens = data.batch(0)["tokens"]
    assert tokens.min() >= 0 and tokens.max() < cfg.vocab


def test_zero_extras_without_a_generator():
    for arch in ("seamless-m4t-medium", "internvl2-76b", "qwen3-0.6b"):
        ref = jsyn._family_extras(jcfg.get_reduced(arch), 2, 16, None)
        _same(tsyn._family_extras(tcfg.get_reduced(arch), 2, 16, None), ref)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_specs_describe_the_batches(family):
    """``input_specs`` on the meta device against a real batch and the
    reference's ShapeDtypeStructs; ``decode_specs`` likewise."""
    arch = FAMILIES[family]
    cfg = tcfg.get_reduced(arch)
    specs = tsyn.input_specs(cfg, 3, 24)
    batch = tsyn.make_batch(cfg, 3, 24)
    ref = jsyn.input_specs(jcfg.get_reduced(arch), 3, 24)
    assert sorted(specs) == sorted(batch) == sorted(ref)
    for key, spec in specs.items():
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == batch[key].shape == tuple(ref[key].shape)
        assert spec.dtype == torch.from_numpy(batch[key]).dtype
        assert str(spec.dtype).removeprefix("torch.") == ref[key].dtype.name
    dec = tsyn.decode_specs(cfg, 3)["tokens"]
    assert dec.device.type == "meta" and tuple(dec.shape) == (3, 1)
    assert dec.dtype == torch.int32


@pytest.mark.parametrize("kind,skew", [("hub_row", 1.5), ("power_law", 1.8),
                                       ("uniform", 1.5)])
def test_sparse_coo_and_format_match_the_reference(kind, skew):
    port = tsyn.synthetic_sparse_coo(300, 6.0, kind=kind, skew=skew, seed=4)
    ref = jsyn.synthetic_sparse_coo(300, 6.0, kind=kind, skew=skew, seed=4)
    for p, r in zip(port[:3], ref[:3]):
        assert np.array_equal(np.asarray(p), np.asarray(r))
    assert tuple(port[3]) == tuple(ref[3])
    fmt = tsyn.synthetic_sparse_format(300, 6.0, kind=kind, skew=skew,
                                       seed=4)
    jfmt = jsyn.synthetic_sparse_format(300, 6.0, kind=kind, skew=skew,
                                        seed=4)
    assert fmt.shape == tuple(jfmt.shape)
    assert np.array_equal(fmt.row_pointers.numpy(),
                          np.asarray(jfmt.row_pointers))
    assert np.array_equal(fmt.column_indices.numpy(),
                          np.asarray(jfmt.column_indices))
    assert np.array_equal(fmt.values.numpy(), np.asarray(jfmt.values))
    assert np.array_equal(fmt.mask.numpy(), np.asarray(jfmt.mask))
    assert np.array_equal(to_dense(fmt).numpy(),
                          np.asarray(jformat.to_dense(jfmt)))


def test_unknown_sparse_kind_raises():
    with pytest.raises(ValueError, match="unknown kind"):
        tsyn.synthetic_sparse_coo(16, kind="ring")
