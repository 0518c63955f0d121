"""``p1_tpu_torch/benchmarks/query_plane.py`` against the reference's.

The fixture chain's blocks and every transfer's inclusion-proof bytes
equal the JAX package's; the serial, batched and cached proof rates, the
filter and replica figures carry the reference's keys, the deterministic
ones (filter bytes, matched blocks) its values.
"""

import pytest

from benchmarks import query_plane as ref
from p1_tpu.node import protocol as ref_protocol
from p1_tpu_torch.benchmarks import query_plane as port
from p1_tpu_torch.node import protocol


@pytest.fixture(scope="module")
def chains():
    return port.build_chain(5, 4), ref.build_chain(5, 4)


def test_chain_and_proof_bytes_are_the_references(chains):
    mine, theirs = chains
    assert mine.height == theirs.height == 5
    assert [b.serialize() for b in mine.main_chain()] == [b.serialize() for b in theirs.main_chain()]
    txids = port._transfer_txids(mine)
    assert txids == ref._transfer_txids(theirs) and len(txids) == 16
    for txid in txids:
        assert protocol.encode_proof(mine.tx_proof(txid)) == ref_protocol.encode_proof(theirs.tx_proof(txid))


def test_rates_and_figures(chains):
    mine, theirs = chains
    txids = port._transfer_txids(mine)
    proofs = port.bench_proofs(mine, txids, repeats=1)
    assert set(proofs) == set(ref.bench_proofs(theirs, txids, repeats=1))
    assert proofs["proofs_sampled"] == 16 and min(proofs.values()) > 0
    filt, ref_filt = port.bench_filters(mine, repeats=1), ref.bench_filters(theirs, repeats=1)
    for key in ("filter_bytes_per_block", "filter_matched_blocks"):
        assert filt[key] == ref_filt[key]
    assert filt["filter_build_bps"] > 0 and filt["filter_match_bps"] > 0
    assert port.bench_replica(mine, 1)["replica_index_bps"] > 0


def test_quick_probe_keys():
    out = port.bench_quick(blocks=3, txs=2, repeats=1)
    assert set(out) == {"proof_serial_qps", "proof_batched_qps", "proof_cached_qps", "proofs_sampled"}
    assert out["proofs_sampled"] == 4
