"""The bulk sharded ops (``cuda_sharded``) on 2 and 4 gloo ranks of the
CPU: one rank-local launch of the balanced kernels' plain versions per
rank and an ``all_reduce``, held against the JAX package's single-device
functions on the same seeded inputs (``tests/_torch_shard_ref.py`` has
the gates).

One module-scoped spawn runs every case: the SpMM, SDDMM and attention
on ``tests/data/hub_96`` at meshes (4, 1), (2, 2) (heads, output columns
and the contracted features over ``"model"``) and (2, 1), fp32 and bf16,
2-D and per-head, the SpMM at int8; a pattern with fewer segments than
ranks (store-only ranks) and the all-empty one; and a GCN and an AGNN on
a ``cuda_sharded`` plan at 2 ranks (logits, gradients, two steps)."""

import pytest

import _torch_shard_ref as ref
from _torch_threads import one_intraop_thread  # noqa: F401

IMPL = "cuda_sharded"

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ref.run_jobs(IMPL, tmp_path_factory.mktemp("shard"))


@pytest.mark.parametrize("op", ["spmm", "sddmm", "attn"])
@pytest.mark.parametrize("mesh", ref.MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_ops_match_jax(results, op, mesh):
    d, m = mesh
    out = {k: v for k, v in results[0][f"hub{d}{m}"].items()
           if k.startswith(op)}
    inp = ref.ops_inputs(ref.hub_matrix())
    ref.check_ops(out, inp, d, m, overlap=False)


def test_every_rank_returns_the_same_output(results):
    for name, out in results[0].items():
        for other in results[1:]:
            if name in other and not name.startswith("train"):
                for key, got in out.items():
                    assert got.equal(other[name][key]), (name, key)
    # ranks 2 and 3 stand outside the (2, 1) mesh
    assert "hub21" not in results[2] and "hub41" in results[3]


def test_store_only_ranks_and_the_all_empty_pattern(results):
    ref.check_dense(results[0]["tiny"], ref.tiny_matrix(),
                    ref.ops_inputs(ref.tiny_matrix(), 1))
    empty = results[0]["empty"]
    assert all(not t.float().abs().sum() for t in empty.values())
    assert empty["sddmm2_fp32"].shape == (8, 8)   # one dummy block


@pytest.mark.parametrize("model", ["gcn", "agnn"])
def test_gnn_on_a_sharded_plan_matches_jax(results, model):
    ref.check_train(results[0][f"train_{model}"], model)
