"""run_sf100 of presto_tpu_torch (benchmark/scale.py) against the JAX
package's, on the CPU at SF 0.01: the six north stars (Q6, Q1, Q3, Q5,
Q17, Q18) streamed from ChunkedTpchCatalog must return the reference's
rows (the first four rows of each, as the runner reports them). The port
runs once more under a budget that offloads the joins (1 MiB, 4,096-row
batches) and must return the same rows with pool.peak within it. Kept
apart from test_torch_scale.py so each file stays under a minute (the
reference's jit compiles take most of this one)."""

import torch

from presto_tpu.benchmark import scale as rscale
from presto_tpu_torch.benchmark import scale
from presto_tpu_torch.exec import spillspace

torch.set_num_threads(1)

SF = 0.01


def test_run_sf100_equals_reference():
    want = rscale.run_sf100(SF)
    got = scale.run_sf100(SF, device="cpu")
    tight = scale.run_sf100(SF, device="cpu", batch_rows=4096, memory_budget=64 << 10)
    assert got["rows"] == want["rows"]
    assert list(got["queries"]) == list(want["queries"])
    for q, w in want["queries"].items():
        assert got["queries"][q]["result"] == w["result"], q
        assert tight["queries"][q]["result"] == w["result"], q
        assert tight["queries"][q]["peak_device_bytes"] <= 64 << 10
    for q in ("q3", "q5", "q17", "q18"):
        assert "hybrid_hash_join" in tight["queries"][q]["spill"], q
    assert spillspace.all_active_bytes() == 0
