from p1_tpu_torch.chain.chain import AddResult, AddStatus, Chain
from p1_tpu_torch.chain.filters import FilterIndex, block_filter, matches_any
from p1_tpu_torch.chain.ledger import balances
from p1_tpu_torch.chain.proof import (
    ProofCache,
    SPVError,
    TxProof,
    build_block_proofs,
    verify_tx_proof,
)
from p1_tpu_torch.chain.replay import (
    ReplayReport,
    generate_headers,
    headers_to_words,
    pack_headers,
    pad_to_segments,
    parse_headers,
    replay_device,
    replay_fast,
    replay_host,
    replay_native,
    replay_packed,
)
from p1_tpu_torch.chain.snapshot import (
    LedgerSnapshot,
    SnapshotError,
    load_snapshot,
    state_root,
    write_snapshot,
)
from p1_tpu_torch.chain.headerplane import (
    ArchiveChain,
    HeaderPlane,
    SegmentIndex,
    write_segment_index,
)
from p1_tpu_torch.chain.segstore import SegmentedStore, is_segmented, open_store
from p1_tpu_torch.chain.store import ChainStore, save_chain
from p1_tpu_torch.chain.validate import (
    PREVERIFY_WINDOW,
    ValidationError,
    check_block,
    preverify_signatures,
)

__all__ = [
    "AddResult",
    "AddStatus",
    "ArchiveChain",
    "Chain",
    "ChainStore",
    "HeaderPlane",
    "SegmentIndex",
    "SegmentedStore",
    "is_segmented",
    "open_store",
    "write_segment_index",
    "FilterIndex",
    "LedgerSnapshot",
    "ProofCache",
    "SnapshotError",
    "load_snapshot",
    "state_root",
    "write_snapshot",
    "block_filter",
    "build_block_proofs",
    "matches_any",
    "PREVERIFY_WINDOW",
    "ReplayReport",
    "SPVError",
    "TxProof",
    "ValidationError",
    "verify_tx_proof",
    "balances",
    "check_block",
    "generate_headers",
    "headers_to_words",
    "pack_headers",
    "pad_to_segments",
    "parse_headers",
    "preverify_signatures",
    "replay_device",
    "replay_fast",
    "replay_host",
    "replay_native",
    "replay_packed",
    "save_chain",
]
