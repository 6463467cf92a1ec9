#!/usr/bin/env python3
"""Time variants of the SpMM (or attention) kernels' sources against each
other and against another tree's, on the Amazon replica, in one process
on one card.

    python3 scripts/spmm_variants.py VARIANTS.json [OTHER_CSRC] [--attention]

``VARIANTS.json`` maps a variant's name to a list of ``[file, old text,
new text]`` edits of ``src/repro_torch/kernels/csrc`` (an empty list is
the sources as they are), for example

    {"steps4": [["spmm_window.cuh", "kSpmmSteps = 2;", "kSpmmSteps = 4;"]]}

or to ``{"edits": [...], "chunks_per_warp": N}``, which also sets the
chunks a warp of row 10 walks (``attention_balanced_cuda``'s
``CHUNKS_PER_WARP``, hence its runs a warp) while that variant runs.

Each variant (and ``OTHER_CSRC``, another tree's ``csrc`` unpacked with
``git archive``, named ``other``) is copied into
``build/spmm_variants/<name>/`` with its edits and its ``spmm.cu`` and
``spmm_balanced.cu`` are compiled there with ``kernels/_build.py``'s
flags, all at once.  It prints the registers of the fp32 and bf16
instantiations at V = 8 from ``-Xptxas -v``, then, with each variant's
two libraries swapped into the wrappers in turn (every variant, then
every variant again in reverse order), times row 1 (``spmm_cuda``) and
row 4 (``spmm_balanced_cuda`` over the split_blk = 1 schedule) on A and
A^T at N = 128 (fp32, bf16, int8 values with bf16 B) and N = 32 (fp32)
with ``chip_smoke.cuda_ms``, and checks each output against the first
variant's (fp32 rows of A and row 4 at the kernel tolerance, the others
to 2% of the largest entry).  With ``--attention`` it builds and swaps
``attention.cu`` and ``attention_balanced.cu`` instead and times rows 9
(``attention_cuda``) and 10 (``attention_balanced_cuda`` over the
split_blk = 1 schedules) at AGNN's one head (D = DV = 32, unit rows, on
A; row 10 on A^T too) and at the 12-head attention of
``chip_smoke.attention_setup``, fp32 and bf16 (fp32 held to the first
variant at the kernel tolerance, bf16 to 2%).  The last line is one JSON
object: the card's name and power limit and every variant's times, both
turns.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src on the path)

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "spmm_variants"
LIBS = {"spmm": ("spmm", "spmm_balanced"),
        "attention": ("attention", "attention_balanced")}


def _prepare(name, src, edits):
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(src, d)
    for fname, old, new in edits:
        path = d / fname
        text = path.read_text()
        if old not in text:
            sys.exit(f"spmm_variants: {name}: {fname} has no {old!r}")
        path.write_text(text.replace(old, new))
    return d


def _registers(d, lib):
    """``{kernel: registers}`` of one build's ptxas report, demangled (with
    the bytes of spill stores beside the count where there are any)."""
    out, cur, spill = {}, None, 0
    for line in (d / f"{lib}.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            name = subprocess.run(["c++filt", cur], capture_output=True,
                                  text=True).stdout.strip()
            name = name.replace("(anonymous namespace)::", "")
            out[re.sub(r"\(.*$", "", name).replace("repro::", "")] = (
                f"{m.group(1)} (+{spill} B spilled)" if spill
                else int(m.group(1)))
            cur, spill = None, 0
    return out


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("spmm_variants: needs a CUDA card")
    from repro_torch.core.autodiff import ad_plan
    from repro_torch.core.format import from_coo
    from repro_torch.core.quantize import quantize_format
    from repro_torch.core.sddmm import with_values
    from repro_torch.kernels import (_build, attention_balanced_cuda,
                                     attention_cuda, spmm_balanced_cuda,
                                     spmm_cuda)
    from repro_torch.sparse.graphs import make_dataset

    args = [a for a in sys.argv[1:] if a != "--attention"]
    kind = "attention" if "--attention" in sys.argv else "spmm"
    libs_of = LIBS[kind]
    variants = {name: v if isinstance(v, dict) else {"edits": v}
                for name, v in json.loads(
                    pathlib.Path(args[0]).read_text()).items()}
    dirs = {name: _prepare(name, CSRC, v["edits"])
            for name, v in variants.items()}
    if len(args) > 1:
        dirs["other"] = _prepare("other", pathlib.Path(args[1]), [])

    def compile_one(job):
        d, lib = job
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(d / f"lib{lib}.so"), str(d / f"{lib}.cu")],
                              capture_output=True, text=True)
        (d / f"{lib}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode:
            sys.exit(f"spmm_variants: nvcc failed on {d.name}/{lib}.cu:\n"
                     f"{proc.stderr}")

    _build.build()
    jobs = [(d, lib) for d in dirs.values() for lib in libs_of]
    with ThreadPoolExecutor(len(jobs)) as ex:
        list(ex.map(compile_one, jobs))
    libs = {}
    for name, d in dirs.items():
        regs = {k: v for lib in libs_of for k, v in _registers(d, lib).items()}
        print(name, json.dumps({k: v for k, v in regs.items()
                                if "<8," in k and "long" not in k
                                and "signed char" not in k}), flush=True)
        libs[name] = {}
        for lib in libs_of:
            handle = ctypes.CDLL(str(d / f"lib{lib}.so"))
            entry, argtypes = _build.SOURCES[lib]
            fn = getattr(handle, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            err = getattr(handle, f"{lib}_error_string")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            libs[name][lib] = handle
    built = dict(_build._libs)

    bf16 = torch.bfloat16
    g = make_dataset("Amazon", 1.0, seed=0)
    fmt = from_coo(g.rows, g.cols, g.vals, (g.num_nodes, g.num_nodes),
                   vector_size=8)
    plan = ad_plan(fmt, impl="cuda", k_blk=8, device="cuda")
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(
        (g.num_nodes, 128)).astype(np.float32)).cuda()
    b32, b16 = b[:, :32].contiguous(), b.to(bf16)
    cases = {}
    if kind == "attention":
        h32 = chip_smoke.unit_rows(rng, g.num_nodes, 32).cuda()
        v32 = b[:, :32].contiguous()
        beta = torch.ones((), device="cuda")
        att = chip_smoke.attention_setup(np.random.default_rng(0))
        ablk, abblk = att["plan"].fwd, att["bplan"].fwd
        for var, dt in (("", torch.float32), ("_bf16", bf16)):
            hh, vv = h32.to(dt), v32.to(dt)
            aq, ak, av = (att[x].to(dt) for x in "qkv")
            cases[f"r9_A{var}"] = (
                lambda hh=hh, vv=vv: attention_cuda(plan.fwd, hh, hh, vv,
                                                    scale=beta))
            cases[f"r9_h12{var}"] = (
                lambda aq=aq, ak=ak, av=av: attention_cuda(
                    ablk, aq, ak, av, scale=att["scale"]))
            for d, view in (("A", plan.fwd), ("At", plan.bwd)):
                cases[f"r10_{d}{var}"] = (
                    lambda hh=hh, vv=vv, view=view, s=view.schedule(1):
                    attention_balanced_cuda(view, hh, hh, vv, scale=beta,
                                            schedule=s))
            cases[f"r10_h12{var}"] = (
                lambda aq=aq, ak=ak, av=av: attention_balanced_cuda(
                    abblk, aq, ak, av, scale=att["scale"],
                    schedule=att["bplan"].fwd_sched))
    for d, view in ((("A", plan.fwd), ("At", plan.bwd)) if kind == "spmm"
                    else ()):
        sched = view.schedule(1)
        for var, v_, bb in (("", view, b),
                            ("_bf16", with_values(view, view.vals.to(bf16)),
                             b16),
                            ("_int8", quantize_format(view), b16),
                            ("_n32", view, b32)):
            cases[f"r1_{d}{var}"] = (
                lambda v_=v_, bb=bb: spmm_cuda(v_, bb))
            cases[f"r4_{d}{var}"] = (
                lambda v_=v_, bb=bb, s=sched: spmm_balanced_cuda(
                    v_, bb, schedule=s))
    names = list(dirs)
    res = {name: {k: [] for k in cases} for name in names}
    ref = {}
    balanced = sys.modules[attention_balanced_cuda.__module__]
    chunks_per_warp = balanced.CHUNKS_PER_WARP
    for name in names + names[::-1]:
        _build._libs.update(libs[name])
        balanced.CHUNKS_PER_WARP = variants.get(name, {}).get(
            "chunks_per_warp", chunks_per_warp)
        for key, fn in cases.items():
            out = fn()
            want = ref.setdefault(key, out)
            if out.dtype == torch.float32 and (
                    "_At" not in key or key.startswith(("r4", "r9", "r10"))):
                ok = torch.allclose(out, want, rtol=chip_smoke.KERNEL_RTOL,
                                    atol=chip_smoke.KERNEL_ATOL)
            else:
                ok = bool((out.float() - want.float()).abs().max() <=
                          0.02 * want.float().abs().max())
            if not ok:
                sys.exit(f"spmm_variants: {name} {key} disagrees")
            res[name][key].append(chip_smoke.cuda_ms(fn))
    _build._libs.update(built)
    balanced.CHUNKS_PER_WARP = chunks_per_warp
    for name in names:
        print(name, json.dumps({k: round(min(v), 4)
                                for k, v in res[name].items()}), flush=True)
    print(json.dumps({"card": chip_smoke.card_line(), "times": res}))


if __name__ == "__main__":
    main()
