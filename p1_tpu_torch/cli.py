"""Command line of the port: ``python -m p1_tpu_torch mine``.

The port of ``p1_tpu/cli.py``'s ``mine`` subcommand (benchmark configs 1/2):
mine N blocks from the genesis header and print one JSON line on stdout
with the same keys as ``p1_tpu``'s ``cmd_mine``.  Logs go to stderr.

  python -m p1_tpu_torch mine --difficulty 20 --blocks 10            # on the card
  python -m p1_tpu_torch mine --difficulty 8 --blocks 2 --device cpu  # plain version

The other subcommands arrive with later slices of the port.
"""

from __future__ import annotations

import argparse
import json
import logging
import statistics
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="p1_tpu_torch",
        description="proof-of-work blockchain on PyTorch and CUDA (port of p1_tpu)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mine", help="mine N blocks from genesis (configs 1/2)")
    p.add_argument("--difficulty", type=int, default=16)
    p.add_argument(
        "--backend", default="cuda", help="hash backend registry name (cuda, cpu)"
    )
    p.add_argument("--batch", type=int, default=None, help="device batch override")
    p.add_argument("--chunk", type=int, default=None, help="miner abort granularity")
    p.add_argument(
        "--device",
        default="cuda",
        help="where the backend runs: cuda (default; fails without a card) "
        "or cpu (the plain PyTorch version)",
    )
    p.add_argument("--blocks", type=int, default=10)
    return parser


# -- mine ----------------------------------------------------------------


def mine_chain(miner, difficulty: int, blocks: int):
    """Mine ``blocks`` headers from genesis; return (headers, times, hashes)."""
    from p1_tpu_torch.core.genesis import genesis_header
    from p1_tpu_torch.core.header import BlockHeader

    if blocks < 1:
        raise SystemExit("--blocks must be >= 1")

    tip = genesis_header(difficulty)
    headers, times, hashes = [], [], 0
    for height in range(1, blocks + 1):
        draft = BlockHeader(1, tip.block_hash(), bytes(32), tip.timestamp + 1, difficulty, 0)
        t0 = time.perf_counter()
        sealed = miner.search_nonce(draft)
        dt = time.perf_counter() - t0
        if sealed is None:
            raise RuntimeError(f"no seal found for height {height}")
        times.append(dt)
        hashes += miner.last_stats.hashes_done
        logging.info(
            "block d=%d height=%d nonce=%d t=%.3fs hps=%.0f",
            difficulty,
            height,
            sealed.nonce,
            dt,
            miner.last_stats.hashes_per_sec,
        )
        headers.append(sealed)
        tip = sealed
    return headers, times, hashes


def mine_report(backend: str, difficulty: int, times: list[float], hashes: int) -> dict:
    """The ``cmd_mine`` JSON object of ``p1_tpu``, key for key."""
    total = sum(times)
    return {
        "config": "mine",
        "backend": backend,
        "difficulty": difficulty,
        "blocks": len(times),
        "hashes_per_sec": round(hashes / total) if total else 0,
        "time_to_block_s": round(statistics.median(times), 4),
        "total_s": round(total, 3),
    }


def cmd_mine(args) -> int:
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    kwargs = {"batch": args.batch} if args.batch else {}
    backend = get_backend(args.backend, device=args.device, **kwargs)
    miner = Miner(backend=backend, chunk=args.chunk)
    _, times, hashes = mine_chain(miner, args.difficulty, args.blocks)
    print(json.dumps(mine_report(args.backend, args.difficulty, times, hashes)))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    handler = {"mine": cmd_mine}[args.cmd]
    return handler(args)


if __name__ == "__main__":
    sys.exit(main())
