"""Shared set-up of the benchmark's CPU tests: the repository's root and
``src`` on the path, and a copy of the benchmark with tiny cells.

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_NODES = 1500


def add_cell(root: pathlib.Path, name: str, config: str, traffic: str,
             limits_of: str) -> None:
    """A new cell in ``root``'s copy: an entry in its ``BENCHMARK.json``
    and a limits file, as a later change adds one."""
    path = root / "BENCHMARK.json"
    manifest = json.loads(path.read_text())
    manifest["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "a test cell"})
    path.write_text(json.dumps(manifest, indent=1))
    shutil.copy(root / "perfbench" / "limits" / f"{limits_of}.json",
                root / "perfbench" / "limits" / f"{name}.json")


def copy_benchmark(dst: pathlib.Path) -> pathlib.Path:
    """``BENCHMARK.json`` and ``perfbench/`` copied under ``dst``, the
    program's sources linked."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "src").symlink_to(ROOT / "src")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    """A copy with a tiny Amazon-like traffic and the cells ``gcn-tiny``
    and ``agnn-tiny`` (the Amazon cells' configurations and limits)."""
    from perfbench import graphs

    root = copy_benchmark(tmp_path_factory.mktemp("bench"))
    traffic = json.loads((root / "perfbench/traffic/amazon-replica-f32.json")
                         .read_text())
    traffic["graph"].update(name="AmazonTiny", num_nodes=TINY_NODES)
    n, *coo = graphs.generate(traffic["graph"])
    traffic["replica"] = {"num_nodes": n,
                          "nnz": len(graphs.coalesce(n, *coo)[0])}
    (root / "perfbench/traffic/tiny.json").write_text(json.dumps(traffic))
    add_cell(root, "gcn-tiny", "gcn-5l-h128", "tiny", "gcn-amazon-replica-f32")
    add_cell(root, "agnn-tiny", "agnn-5l-h32", "tiny",
             "agnn-amazon-replica-f32")
    return root
