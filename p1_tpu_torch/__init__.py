"""p1-tpu on PyTorch and CUDA: the port of ``p1_tpu`` to an NVIDIA H100.

A second package beside ``p1_tpu``, which stays the reference it is held
against.  It imports ``torch``, numpy and the standard library, never
``jax`` and never ``p1_tpu``: where it needs one of the reference's
JAX-free modules it keeps its own copy under the same module path.

It carries the mining, replay and signature-validation paths, the chain
state and its stores, and the integer-ALU roofline:

- ``p1_tpu_torch.core``   — ``BlockHeader`` (the reference's 80-byte
  encoding), target math, the genesis header and block (fixed difficulty
  or with the retarget rule's commitment), ``RetargetRule``,
  ``Transaction``, ``Block`` and the merkle functions, Ed25519 keys and
  the signature-backend ladder (``keys``), the verify-once cache.
- ``p1_tpu_torch.hashx``  — its own ``HashBackend`` registry: ``cpu``
  (hashlib) and ``cuda``, the SHA-256d nonce search as a hand-written
  CUDA kernel for Hopper (``hashx/csrc/sha256d_search.cu``); the
  header-chain verify kernel (``hashx/csrc/verify_chain.cu``); their plain
  PyTorch versions (``hashx/torch_sha256.py``); Ed25519 batch
  verification with the subgroup gate and the MSM on the card
  (``hashx/ed25519_msm.py``, kernel ``hashx/csrc/ed25519_msm.cu``); SASS
  counting (``hashx/sass.py``).
- ``p1_tpu_torch.miner``  — ``Miner.search_nonce()``.
- ``p1_tpu_torch.chain``  — header-chain generation and replay; block
  validation (``check_block``, ``preverify_signatures``); the block index
  with fork choice and the account ledger (``Chain``), compact filters,
  SPV proofs, ledger snapshots and state deltas; the stores
  (``ChainStore``, ``SegmentedStore``, the header plane), whose untrusted
  loads revalidate signature windows on the card; the offline store
  tools (``tooling``) and disk-fault stores (``testing``).
- ``p1_tpu_torch.node``   — the p2p node, its clients and ``net``; the
  network simulator (``netsim``: full nodes in virtual time, sealing on the
  card), its scenarios, the far field and the chaos plane; the read-only
  query plane (``queryplane``) and replica provisioning (``provision``).
- ``p1_tpu_torch.benchmarks`` — the integer-ALU roofline
  (``benchmarks/csrc/int_roofline.cu``), ``verify_chain``'s device time,
  the signature-verification bench (``sig_verify``, store revalidation
  included), and the planes ``bench`` reads: host ingest, telemetry
  overhead, the query and wallet planes, the simulator's scale, the chaos
  rate, snapshot boot, the archive and the maintenance cadence; beside
  them the ledger-scale and memory-bound harnesses.
- ``p1_tpu_torch.bench``  — the headline benchmark: hashes/s per card,
  time to a block, every plane against its pin (``hashx/perf_record``).
- ``p1_tpu_torch.cli``    — ``python -m p1_tpu_torch
  mine|sweep|replay|keygen|balances|compact|fsck|snapshot``, the node
  and client commands, ``pod``, ``sim|chaos|serve``, ``lint`` and
  ``bench``; ``mine --profile`` traces the mining loop.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``); without a card they raise.
"""

__version__ = "0.1.0"
