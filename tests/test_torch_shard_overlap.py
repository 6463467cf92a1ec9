"""The overlapped sharded ops (``cuda_sharded_overlap``) on 2 and 4 gloo
ranks of the CPU: each rank's range cut into two segment batches, one
balanced launch (plain version) per batch, and the compact partials
carried round the data group's send/recv ring, held against the JAX
package's single-device functions (``tests/_torch_shard_ref.py`` has the
gates; one module-scoped spawn runs every case, as in
``test_torch_shard.py``).  Also the ring's one-rank form, the refusal of
a partition without batches, and the conformance harness's ``overlap``
variant on a one-rank mesh."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_shard_ref as ref
from repro_torch.core import from_dense
from repro_torch.core.format import block_format
from repro_torch.data import datasets as tds
from repro_torch.distributed import (partition_schedule,
                                     ring_scatter_pipeline,
                                     spmm_sharded_overlap)
from repro_torch.launch.mesh import one_rank_mesh
from repro_torch.testing import conformance as conf
from _torch_threads import one_intraop_thread  # noqa: F401

IMPL = "cuda_sharded_overlap"

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ref.run_jobs(IMPL, tmp_path_factory.mktemp("overlap"))


@pytest.mark.parametrize("op", ["spmm", "sddmm", "attn"])
@pytest.mark.parametrize("mesh", ref.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_overlapped_ops_match_jax(results, op, mesh):
    d, m = mesh
    out = {k: v for k, v in results[0][f"hub{d}{m}"].items()
           if k.startswith(op)}
    inp = ref.ops_inputs(ref.hub_matrix())
    ref.check_ops(out, inp, d, m, overlap=True)


def test_ranks_agree_up_to_summation_order(results):
    """Each rank folds the partials in its own ring order: the ranks agree
    to fp32 summation order, and bit for bit wherever a row has one
    owner (the SDDMM and the attention)."""
    for name, out in results[0].items():
        for other in results[1:]:
            if name not in other or name.startswith("train"):
                continue
            for key, got in out.items():
                want = other[name][key]
                if key.startswith(("sddmm", "attn")):
                    assert got.equal(want), (name, key)
                else:
                    torch.testing.assert_close(got.float(), want.float(),
                                               rtol=1e-5, atol=1e-5)


def test_store_only_ranks_and_the_all_empty_pattern(results):
    ref.check_dense(results[0]["tiny"], ref.tiny_matrix(),
                    ref.ops_inputs(ref.tiny_matrix(), 1))
    assert all(not t.float().abs().sum()
               for t in results[0]["empty"].values())


@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_gnn_on_an_overlapped_plan_matches_jax(results, model):
    ref.check_train(results[0][f"train_{model}"], model)


def test_one_rank_ring_is_a_local_loop():
    seen = []

    def compute(t):
        seen.append(t)
        return torch.full((1, 2, 3), float(t + 1)), torch.tensor([0, 2])

    def scatter(acc, buf, idx):
        return acc.index_add_(1, idx.long(), buf)

    acc = ring_scatter_pipeline(compute, scatter, torch.zeros(1, 3, 3),
                                n_batches=3)
    assert seen == [0, 1, 2]
    assert acc[0, 0].tolist() == [6.0] * 3 and acc[0, 1].abs().sum() == 0
    with pytest.raises(ValueError, match="n_batches must be >= 1"):
        ring_scatter_pipeline(compute, scatter, acc, n_batches=0)


def test_overlap_needs_a_batched_partition():
    a = ref.hub_matrix()
    blocked = block_format(from_dense(a), 8, device="cpu")
    part = partition_schedule(blocked, None, 1)
    part = dataclasses.replace(part, bseg_win=None)
    with one_rank_mesh("cpu") as mesh:
        with pytest.raises(ValueError, match="segment-batched partition"):
            spmm_sharded_overlap(blocked, torch.ones(a.shape[1], 4),
                                 mesh=mesh, part=part)
    assert not dist.is_initialized()


def test_conformance_overlap_variant_on_a_one_rank_mesh():
    cases = conf.enumerate_cases()
    overlap = {(c.op, c.impl) for c in cases if c.variant == "overlap"}
    assert overlap == {(op, IMPL) for op in conf.OPS}
    samples = tds.load_vendored(["hub_96", "rect_120x40"])
    records = conf.run_conformance(
        samples, impl_names=["cuda_sharded", IMPL], device="cpu")
    s = conf.summarize(records)
    assert s["fail"] == 0, conf.format_report(records)
    variants = {(r.impl, r.variant) for r in records if r.status == "pass"}
    assert (IMPL, "overlap") in variants and ("cuda_sharded", "split") \
        in variants
    assert not dist.is_initialized()    # the harness's group is gone
    # the mesh route agrees with the single-device one bit for bit at fp32
    # on a one-rank mesh: the rank holds every segment
    a = samples[0].dense()
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (a.shape[1], 8)).astype(np.float32))
    fmt = from_dense(a)
    from repro_torch.core import spmm
    with one_rank_mesh("cpu") as mesh:
        got = spmm(fmt, b, impl=IMPL, mesh=mesh, n_batches=1)
    assert got.equal(spmm(fmt, b, impl="cuda_balanced"))
