"""Parity: presto_tpu_torch plans every TPC-H query as presto_tpu does, and
the port stands alone (no jax, no presto_tpu).

For all 22 queries, `plan/nodes.py::plan_tree_str` of the port's plan
equals the reference's, over the same SF 0.01 catalog.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from presto_tpu.benchmark.tpch_sql import QUERIES as RQUERIES
from presto_tpu.connectors.tpch import TpchCatalog as RCatalog
from presto_tpu.plan.nodes import plan_tree_str as r_plan_tree_str
from presto_tpu.session import Session as RSession
from presto_tpu_torch.benchmark.tpch_sql import QUERIES
from presto_tpu_torch.connectors.tpch import TpchCatalog
from presto_tpu_torch.plan.nodes import plan_tree_str
from presto_tpu_torch.session import Session

# one torch thread: the suite runs in parallel worker processes
# (pytest-xdist), and a thread per core in each oversubscribes the host
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def sessions():
    """presto_tpu's session without plan and result caches and without its
    dynamic filters (a runtime feature: the plans are the same)."""
    ref = RSession(RCatalog(0.01), plan_cache=False, result_cache=False)
    ref.executor.dynamic_filtering = False
    return Session(TpchCatalog(0.01, device="cpu"), device="cpu"), ref


@pytest.mark.parametrize("q", sorted(RQUERIES))
def test_tpch_plan_equals_reference(q, sessions):
    port, ref = sessions
    assert QUERIES[q] == RQUERIES[q]
    assert plan_tree_str(port.plan(QUERIES[q])) == r_plan_tree_str(ref.plan(RQUERIES[q]))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((REPO / "presto_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "presto_tpu"), f"{f}: imports {mod}"


def test_port_modules_import_with_jax_and_reference_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'presto_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import presto_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(presto_tpu_torch.__path__, "
        "'presto_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for n in ('ops.join_kernel', 'ops.join', 'ops.bloomfilter', 'ops.union', "
        "'exec.dynfilter'):\n"
        "    assert 'presto_tpu_torch.' + n in names, n\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'presto_tpu.')) "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 35
