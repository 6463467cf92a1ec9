#!/usr/bin/env python3
"""The balanced SpMM (row 4) on the hub rows of the Amazon replica's
transpose: how far it, and variants of its source, sit from fp64 and from
the plain version, on one card.

    python3 scripts/spmm_hub_accuracy.py [VARIANTS.json [OTHER_CSRC]]

It builds the kernels, replays ``chip_smoke.py``'s random draws up to its
phase 3b (the phase-3a edge checks draw from the same generator) so that
B is the B that script holds row 4 to, and for split_blk 0, 1 and 3 prints
the plain version's and each build's largest error against an fp64
product, each build's largest distance from the plain version, the
entries beyond the kernel tolerance (rtol 1e-4, atol 1e-5) with their
window, and each build's time.  ``VARIANTS.json`` and ``OTHER_CSRC`` are
``scripts/spmm_variants.py``'s: edits of this tree's ``csrc`` and another
tree's ``csrc``, whose ``spmm_balanced.cu`` are built beside this tree's
and swapped into the wrapper in turn.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402  (puts this checkout's src on the path)
from spmm_variants import CSRC, _prepare  # noqa: E402


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("spmm_hub_accuracy: needs a CUDA card")
    from repro_torch.core.autodiff import ad_plan
    from repro_torch.core.format import from_coo
    from repro_torch.kernels import (_build, spmm_balanced_cuda,
                                     spmm_balanced_plain)
    from repro_torch.sparse.graphs import make_dataset

    dirs = {}
    if len(sys.argv) > 1:
        for name, edits in json.loads(
                pathlib.Path(sys.argv[1]).read_text()).items():
            dirs[name] = _prepare(name, CSRC, edits)
    if len(sys.argv) > 2:
        dirs["other"] = _prepare("other", pathlib.Path(sys.argv[2]), [])

    def compile_one(d):
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(d / "libspmm_balanced.so"), str(d / "spmm_balanced.cu")],
            capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"spmm_hub_accuracy: nvcc failed on {d.name}:\n"
                     f"{proc.stderr}")

    libs = {"this tree": _build.library("spmm_balanced")}
    with ThreadPoolExecutor(max(len(dirs), 1)) as ex:
        list(ex.map(compile_one, dirs.values()))
    entry, argtypes = _build.SOURCES["spmm_balanced"]
    for name, d in dirs.items():
        lib = ctypes.CDLL(str(d / "libspmm_balanced.so"))
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        err = getattr(lib, "spmm_balanced_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = lib

    rng = np.random.default_rng(0)          # chip_smoke.py's phase 3a
    chip_smoke.check_kernels_edge(rng)
    chip_smoke.check_head_grids_edge(rng)
    g = make_dataset("Amazon", 1.0, seed=0)
    m = g.num_nodes
    b = torch.from_numpy(rng.standard_normal((m, 128)).astype(
        np.float32)).cuda()                 # its phase 3b's B
    fmt = from_coo(g.rows, g.cols, g.vals, (m, m), vector_size=8)
    bl = ad_plan(fmt, impl="cuda_balanced", k_blk=8, split_blk=1,
                 device="cuda").bwd
    kb, v, nb = bl.k_blk, bl.vector_size, bl.num_blocks
    win = bl.block_win.long()
    per_win = torch.diff(bl.win_ptr.long())
    vals4 = bl.vals.reshape(nb, kb, v).double()
    cols = bl.cols.long().reshape(nb, kb)
    exact = torch.zeros((bl.num_windows, v, 128), dtype=torch.float64,
                        device="cuda")
    for s in range(0, nb, 65536):
        sl = slice(s, min(s + 65536, nb))
        exact.index_add_(0, win[sl], torch.einsum(
            "bkv,bkn->bvn", vals4[sl], b[cols[sl]].double()))
    exact = exact.reshape(-1, 128)[:m]
    rows = {}
    for split in (0, 1, 3):
        sched = bl.schedule(split)
        ref = spmm_balanced_plain(bl, b, sched)
        plain_err = (ref.double() - exact).abs().max().item()
        print(f"split_blk={split}: plain vs fp64 {plain_err:.3e}")
        for name, lib in libs.items():
            _build._libs["spmm_balanced"] = lib
            out = spmm_balanced_cuda(bl, b, schedule=sched)
            dist = (out - ref).abs()
            off = dist > (chip_smoke.KERNEL_ATOL
                          + chip_smoke.KERNEL_RTOL * ref.abs())
            row = {"vs_fp64": (out.double() - exact).abs().max().item(),
                   "vs_plain": dist.max().item(), "off": int(off.sum()),
                   "ms": chip_smoke.cuda_ms(
                       lambda: spmm_balanced_cuda(bl, b, schedule=sched))}
            rows[f"{name} split_blk={split}"] = row
            print(f"  {name}: {row['ms']:.4f} ms, vs fp64 "
                  f"{row['vs_fp64']:.3e}, vs plain {row['vs_plain']:.3e}, "
                  f"{row['off']} entries beyond the kernel tolerance",
                  flush=True)
            for r, c in torch.nonzero(off)[:5].tolist():
                w = r // v
                print(f"    row {r} (window {w}, {int(per_win[w])} K-blocks)"
                      f" column {c}: kernel {out[r, c].item():.7e}, plain "
                      f"{ref[r, c].item():.7e}, fp64 {exact[r, c].item():.7e}")
    _build._libs["spmm_balanced"] = libs["this tree"]
    print(json.dumps({"card": chip_smoke.card_line(), "rows": rows}))


if __name__ == "__main__":
    main()
