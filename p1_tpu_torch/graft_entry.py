"""Entry points of the port: one search step, and a multi-slot dry run.

The port of the root ``__graft_entry__.py`` (which stays the JAX
package's).  ``entry()`` exposes the miner's hot loop, one SHA-256d
nonce-search step, with its example inputs.  ``dryrun_multichip(n)``
builds an ``n``-slot mesh (virtual: ``n`` slots on one device, each on its
own stream, the counterpart of the JAX package's
``--xla_force_host_platform_device_count`` CPU mesh), runs one FULL
sharded mining search over it through the ``sharded`` backend (each slot
a search step, the min over slots, the pipelined host loop), and checks
the mined nonce against the host ``cpu`` backend for first-hit parity.

    python -m p1_tpu_torch.graft_entry                    # 8 slots on the card
    python -m p1_tpu_torch.graft_entry --device cpu       # 8 slots on the CPU
    python -m p1_tpu_torch.graft_entry --devices 4        # 4 slots
"""

from __future__ import annotations

import argparse


def _example_arrays(difficulty: int, device: str = "cpu"):
    import numpy as np

    from p1_tpu_torch.core.genesis import genesis_header
    from p1_tpu_torch.core.header import target_from_difficulty, target_to_words
    from p1_tpu_torch.hashx.sha256_ref import header_midstate, header_tail_words
    from p1_tpu_torch.hashx.torch_backend import search_arrays

    prefix = genesis_header(difficulty).mining_prefix()
    arrays = search_arrays(
        np.array(header_midstate(prefix), dtype=np.uint32),
        np.array(header_tail_words(prefix), dtype=np.uint32),
        np.array(target_to_words(target_from_difficulty(difficulty)), dtype=np.uint32),
        device,
    )
    return prefix, arrays


def entry(device: str = "cuda"):
    """(fn, example_args) for one search step of the miner: the search
    kernel's step on ``device`` (the card by default, raising without
    one; its plain version with ``device="cpu"``)."""
    from p1_tpu_torch.hashx.cuda_backend import cuda_search_fn

    _, arrays = _example_arrays(difficulty=16, device=device)
    return cuda_search_fn(4096), (arrays, 0)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One full sharded mining search on an ``n_devices``-slot mesh on
    ``device`` (``cuda``, the default: every slot on the first card,
    raising without one; ``cpu``: the plain version).  Asserts that it finds exactly the nonce the host ``cpu``
    backend finds (bit-exact first-hit parity)."""
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.hashx.sharded import ShardedBackend

    difficulty = 10
    prefix, _ = _example_arrays(difficulty)
    slot_device = "cuda:0" if device == "cuda" else device
    # 1,024 a slot: one tile of the search kernel.
    backend = ShardedBackend(batch=1024, n_devices=n_devices, device=slot_device, slots_per_device=n_devices)
    assert backend.n_devices == n_devices

    count = 1 << 14  # ~16 expected hits at difficulty 10: finds one fast
    got = backend.search(prefix, 0, count, difficulty)
    truth = get_backend("cpu").search(prefix, 0, count, difficulty)
    assert truth.nonce is not None, "dry-run range must contain a hit"
    assert got.nonce == truth.nonce, (
        f"sharded mesh found nonce {got.nonce}, host scan found {truth.nonce}"
    )
    print(
        f"dryrun_multichip ok: {n_devices}-device mesh (platform={device}) "
        f"found nonce {got.nonce} == host cpu backend"
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="one sharded search on an n-slot mesh")
    parser.add_argument("--devices", type=int, default=8, help="mesh slots (default 8)")
    parser.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="cuda (default; the search kernel, fails without a card) or cpu (the plain version)",
    )
    args = parser.parse_args(argv)
    dryrun_multichip(args.devices, device=args.device)


if __name__ == "__main__":
    main()
