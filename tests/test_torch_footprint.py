"""The port's Table 7 footprints and package exports against the JAX
package's, on the CPU.

  * ``memory_footprint_me_bcrs`` and ``memory_footprint_sr_bcrs`` equal
    the reference's (exact integers) on the 14 vendored matrices at
    V = 8 and 16, SR-BCRS at k = 8 (and 4), values of 2 and 4 bytes;
  * ``repro_torch.core.__all__`` and ``repro_torch.sparse.__all__`` hold
    the reference's names but the recorded differences, and every name
    resolves.
"""

import pytest

import repro.core as jcore
import repro.sparse as jsparse
import repro_torch.core as tcore
import repro_torch.sparse as tsparse
from repro.data.datasets import load_vendored, vendored_names
from repro_torch.core import (from_coo, memory_footprint_me_bcrs,
                              memory_footprint_sr_bcrs)
from _torch_threads import one_intraop_thread  # noqa: F401

pytestmark = pytest.mark.filterwarnings(
    "error::repro_torch.core.dispatch.FallbackWarning")

# The reference warns from inside a JAX trace; the port has no tracer.
CORE_ONLY_REFERENCE = {"ValidationWarning"}
# The port's own: the entry points' device rule and the softmax operator
# (the reference keeps the latter in ``repro.core.softmax`` only).
CORE_ONLY_PORT = {"resolve_device", "sparse_softmax"}
SPARSE_ONLY_PORT = {"hub_row_graph"}


@pytest.mark.parametrize("v", [8, 16])
def test_footprints_equal_the_reference_on_vendored_matrices(v):
    for s in load_vendored(vendored_names()):
        port = from_coo(s.rows, s.cols, s.vals, s.shape, vector_size=v)
        ref = jcore.from_coo(s.rows, s.cols, s.vals, s.shape, vector_size=v)
        for vb in (2, 4):
            got = memory_footprint_me_bcrs(port, value_bytes=vb)
            assert type(got) is int
            assert got == jcore.memory_footprint_me_bcrs(ref, value_bytes=vb)
            for k in (8, 4):
                got = memory_footprint_sr_bcrs(port, k=k, value_bytes=vb)
                assert type(got) is int
                assert got == jcore.memory_footprint_sr_bcrs(
                    ref, k=k, value_bytes=vb), (s.name, v, k, vb)
        # zero padding never makes the format smaller
        assert memory_footprint_sr_bcrs(port) >= \
            memory_footprint_me_bcrs(port) - 4 * port.num_windows


@pytest.mark.parametrize("port,ref,only_ref,only_port", [
    (tcore, jcore, CORE_ONLY_REFERENCE, CORE_ONLY_PORT),
    (tsparse, jsparse, set(), SPARSE_ONLY_PORT)], ids=["core", "sparse"])
def test_package_exports_equal_the_reference(port, ref, only_ref, only_port):
    assert set(ref.__all__) - set(port.__all__) == only_ref
    assert set(port.__all__) - set(ref.__all__) == only_port
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert len(port.__all__) == len(set(port.__all__))
