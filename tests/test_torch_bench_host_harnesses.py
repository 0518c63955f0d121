"""The port's host harnesses outside ``bench``: ``ledger_scale`` and
``memory_bound`` against the reference's.

``memory_bound`` builds one store (byte-identical to the JAX package's)
and resumes it in fresh ``python -m p1_tpu_torch.benchmarks.memory_bound
--measure`` processes that import no torch; the blocks, evicted bodies
and resident body bytes are the reference's.
"""

import random

from benchmarks import ledger_scale as ref_ledger
from benchmarks import memory_bound as ref_memory
from p1_tpu_torch.benchmarks import ledger_scale, memory_bound


def test_ledger_representations_and_apply():
    names = ledger_scale._accounts(5_000)
    two = ledger_scale.bench_two_dict(names, 0.1, random.Random(1))
    slotted = ledger_scale.bench_slotted(names, 0.1, random.Random(1))
    assert set(two) == set(ref_ledger.bench_two_dict(names, 0.1, random.Random(1)))
    assert set(slotted) == set(two)
    assert ledger_scale.bench_apply(5_000, random.Random(0))["apply_undo_us_per_block"] > 0


def test_memory_bound_stores_and_resumes_are_the_references(tmp_path):
    mine = memory_bound.build_store([60, 120], tmp_path / "port")
    theirs = ref_memory.build_store([60, 120], tmp_path / "ref")
    for height in (60, 120):
        assert mine[height].read_bytes() == theirs[height].read_bytes()
    got = memory_bound.measure_in_process(mine[120], 16)
    want = ref_memory.measure(theirs[120], 16)
    assert got.pop("torch_imported") is False
    assert set(got) == set(want)
    for key in ("blocks", "bodies_evicted", "resident_body_bytes", "refetch_samples"):
        assert got[key] == want[key], key
    assert got["peak_rss_bytes"] > 0
