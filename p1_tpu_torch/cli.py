"""Command line of the port: ``python -m p1_tpu_torch <command>``.

The port of ``p1_tpu/cli.py``'s ``mine`` and ``sweep`` (benchmark configs
1/2), ``replay`` (config 3), ``keygen`` and the offline store commands
``balances``, ``compact``, ``fsck`` and ``snapshot``, with the reference's
flags, exit codes and JSON keys.  Each prints JSON on stdout; logs go to
stderr.

  python -m p1_tpu_torch mine --difficulty 20 --blocks 10              # on the card
  python -m p1_tpu_torch mine --difficulty 8 --blocks 2 --device cpu    # plain version
  python -m p1_tpu_torch sweep --difficulties 16:22 --blocks 5
  python -m p1_tpu_torch replay --n 10000 --difficulty 16               # on the card
  python -m p1_tpu_torch replay --n 32 --difficulty 8 --device cpu      # plain version
  python -m p1_tpu_torch keygen --out key.json
  python -m p1_tpu_torch balances --store chain.p1                     # on the card
  python -m p1_tpu_torch fsck --store chain.p1 --device cpu            # plain version

The store commands load the store untrusted, so every signature window
is revalidated: on the card (``hashx/csrc/ed25519_msm.cu``) by default,
with the plain PyTorch version under ``--device cpu``.  The node and
network commands arrive with later slices of the port.
"""

from __future__ import annotations

import argparse
import json
import logging
import statistics
import sys
import time


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--difficulty", type=int, default=16)
    p.add_argument(
        "--backend", default="cuda", help="hash backend registry name (cuda, cpu)"
    )
    p.add_argument("--batch", type=int, default=None, help="device batch override")
    p.add_argument(
        "--device",
        default="cuda",
        help="where the backend runs: cuda (default; fails without a card) "
        "or cpu (the plain PyTorch version)",
    )


def _add_retarget(p: argparse.ArgumentParser) -> None:
    """Chain-identity flags for opt-in difficulty retargeting: the rule is
    committed into genesis, so they select the chain."""
    p.add_argument(
        "--retarget-window",
        type=int,
        default=0,
        help="adjust difficulty every N blocks (0 = fixed difficulty; "
        "the rule is part of the chain's genesis identity)",
    )
    p.add_argument(
        "--target-spacing",
        type=int,
        default=0,
        help="target seconds per block for retargeting (set together "
        "with --retarget-window)",
    )


def _add_sig_device(p: argparse.ArgumentParser) -> None:
    """Where an untrusted store load verifies its signature batches."""
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where signature batches are verified: cuda (default; the "
        "ed25519_msm kernel, fails without a card) or cpu (the plain "
        "PyTorch version)",
    )


def _pin_sig_device(args) -> None:
    """The ``device`` signature rung, on the card or (``--device cpu``)
    on its plain version."""
    from p1_tpu_torch.core import keys

    keys.set_sig_backend("device", device=args.device)


def _retarget_rule(args):
    """The ``RetargetRule`` selected by the flags, or None (fixed)."""
    from p1_tpu_torch.core.retarget import RetargetRule

    try:
        return RetargetRule.from_params(args.retarget_window, args.target_spacing)
    except ValueError as e:
        raise SystemExit(str(e))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="p1_tpu_torch",
        description="proof-of-work blockchain on PyTorch and CUDA (port of p1_tpu)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("mine", help="mine N blocks from genesis (configs 1/2)")
    _add_common(p)
    p.add_argument("--chunk", type=int, default=None, help="miner abort granularity")
    p.add_argument("--blocks", type=int, default=10)

    p = sub.add_parser(
        "sweep", help="difficulty sweep: time-to-block scaling (config 2)"
    )
    _add_common(p)
    p.add_argument("--chunk", type=int, default=None, help="miner abort granularity")
    p.add_argument(
        "--difficulties",
        default="16:25",
        help="half-open range LO:HI (e.g. 16:25) or comma list (16,20,24)",
    )
    p.add_argument("--blocks", type=int, default=5, help="blocks per difficulty")

    p = sub.add_parser("replay", help="generate+verify a header chain (config 3)")
    _add_common(p)
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument(
        "--method",
        choices=["host", "native", "device", "both", "all"],
        default="both",
        help="verification engine(s): host=hashlib oracle, device=one kernel "
        "launch on --device; both=host+device (native and all wait for a "
        "later slice of the port)",
    )
    p.add_argument("--out", default=None, help="write generated headers here")
    p.add_argument("--verify", default=None, help="verify this header file instead")
    _add_retarget(p)

    p = sub.add_parser(
        "keygen", help="create an Ed25519 spending key (account = fingerprint)"
    )
    p.add_argument("--out", required=True, help="key file to write (0600)")
    p.add_argument(
        "--seed-text",
        default=None,
        help="derive deterministically from this label (TESTS ONLY: the "
        "seed is sha256(label), so the account is publicly spendable)",
    )
    p.add_argument(
        "--force",
        action="store_true",
        help="overwrite an existing key file (DESTROYS the old seed — "
        "coins held by its account become unspendable)",
    )

    p = sub.add_parser(
        "balances", help="account balances from a persisted chain"
    )
    p.add_argument(
        "--difficulty",
        type=int,
        default=None,
        help="chain selector (default: inferred from the store's records)",
    )
    p.add_argument("--store", required=True, help="chain persistence path")
    p.add_argument(
        "--account", default=None, help="print one account instead of all"
    )
    _add_retarget(p)
    _add_sig_device(p)

    p = sub.add_parser(
        "compact", help="rewrite a chain store to just its main branch"
    )
    p.add_argument("--store", required=True, help="chain persistence path")
    p.add_argument(
        "--out",
        default=None,
        help="write here instead of replacing the store in place",
    )
    _add_retarget(p)
    _add_sig_device(p)

    p = sub.add_parser(
        "fsck",
        help="scan a chain store offline: report per-record integrity and "
        "salvage every checksum-valid record into a fresh verified store "
        "(also upgrades v2 stores to the checksummed v3 framing); exit 0 "
        "= clean, 1 = salvaged with losses, 2 = unrecoverable",
    )
    p.add_argument("--store", required=True, help="chain persistence path")
    p.add_argument(
        "--out",
        default=None,
        help="write the salvaged store here instead of replacing in place",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="machine-readable per-segment report (one row per segment "
        "with its own verdict/spans/salvage counts; single-file stores "
        "report as one segment)",
    )
    _add_sig_device(p)

    p = sub.add_parser(
        "snapshot",
        help="ledger-state snapshots (chain/snapshot.py): create one "
        "from a chain store's latest checkpoint, verify a snapshot "
        "file's integrity (manifest, chunk digests, state root), or "
        "print its manifest; exit 0 clean / 1 salvageable issue / 2 "
        "unrecoverable",
    )
    p.add_argument(
        "action",
        choices=["create", "verify", "info"],
        help="create: --store -> --file; verify/info: --file",
    )
    p.add_argument("--store", default=None, help="chain store (create)")
    p.add_argument(
        "--file", default=None, help="snapshot file path (all actions)"
    )
    p.add_argument(
        "--interval",
        type=int,
        default=0,
        help="checkpoint interval override for create (0 = the chain "
        "default: the retarget window, else 64); the snapshot lands on "
        "the latest multiple at or below the store's tip",
    )
    _add_retarget(p)
    _add_sig_device(p)
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


def _parse_difficulties(spec: str) -> list[int]:
    try:
        if ":" in spec:
            lo, _, hi = spec.partition(":")
            out = list(range(int(lo), int(hi)))
        else:
            out = [int(d) for d in spec.split(",") if d]
    except ValueError:
        out = []
    if not out or not all(0 <= d <= 255 for d in out):
        raise SystemExit(
            f"bad difficulty spec {spec!r} (want LO:HI or a comma list)"
        )
    return out


def cmd_sweep(args) -> int:
    """Benchmark config 2: nonce-space scaling across difficulties.

    One JSON line per difficulty with median time-to-block and the
    aggregate hash rate, so the scaling curve (time ~ 2^d / rate, floored
    by launch latency) is reproducible from a single command.
    """
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    kwargs = {"batch": args.batch} if args.batch else {}
    backend = get_backend(args.backend, device=args.device, **kwargs)
    miner = Miner(backend=backend, chunk=args.chunk)
    for difficulty in _parse_difficulties(args.difficulties):
        _, times, hashes = mine_chain(miner, difficulty, args.blocks)
        total = sum(times)
        print(
            json.dumps(
                {
                    "config": "sweep",
                    "backend": args.backend,
                    "difficulty": difficulty,
                    "blocks": args.blocks,
                    "time_to_block_s": round(statistics.median(times), 4),
                    "hashes_per_sec": round(hashes / total) if total else 0,
                    "total_s": round(total, 3),
                }
            ),
            flush=True,
        )
    return 0


# -- replay --------------------------------------------------------------


def cmd_replay(args) -> int:
    from p1_tpu_torch.chain import generate_headers, parse_headers, replay_device, replay_host
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.header import HEADER_SIZE
    from p1_tpu_torch.hashx import get_backend

    if args.method in ("native", "all"):
        print(
            "the native (C++ SHA-NI) replay engine is not ported yet: it waits "
            "for the slice that ports replay_native/replay_fast/replay_packed; "
            "use --method host, device or both",
            file=sys.stderr,
        )
        return 2
    rule = _retarget_rule(args)
    if rule is not None and args.method in ("device", "both"):
        # The host oracle is retarget-aware; the device kernel implements
        # the benchmark-config form (one target for the whole chain) and
        # would mis-report an honest retargeting chain as invalid at the
        # first adjustment.
        print(
            "retargeting chains verify with --method host "
            "(the device engine is fixed-difficulty)",
            file=sys.stderr,
        )
        return 2
    if args.verify:
        with open(args.verify, "rb") as fh:
            raw = fh.read()
        if len(raw) % HEADER_SIZE:
            print(f"{args.verify}: not a multiple of {HEADER_SIZE} bytes", file=sys.stderr)
            return 2
        headers = parse_headers(raw)
        # Pin the file to the chain the operator selected: header[0] is
        # otherwise SELF-attested, and a forged file whose genesis claims
        # difficulty 1 would "verify" with no meaningful work behind it.
        if not headers or headers[0].block_hash() != genesis_hash(args.difficulty, rule):
            print(
                f"{args.verify}: does not start at this chain's genesis "
                "(check --difficulty / retarget flags)",
                file=sys.stderr,
            )
            return 2
    else:
        kwargs = {"batch": args.batch} if args.batch else {}
        backend = get_backend(args.backend, device=args.device, **kwargs)
        t0 = time.perf_counter()
        headers = generate_headers(args.n, args.difficulty, backend=backend, retarget=rule)
        logging.info("generated %d headers in %.1fs", args.n, time.perf_counter() - t0)
        if args.out:
            with open(args.out, "wb") as fh:
                for h in headers:
                    fh.write(h.serialize())

    reports = []
    if args.method in ("host", "both"):
        reports.append(replay_host(headers, retarget=rule))
    if args.method in ("device", "both"):
        reports.append(replay_device(headers, device=args.device))
        reports.append(replay_device(headers, device=args.device))  # warm (build amortized)
    ok = all(r.valid for r in reports)
    print(
        json.dumps(
            {
                "config": "replay",
                "n_headers": len(headers),
                "valid": ok,
                "first_invalid": next((r.first_invalid for r in reports if not r.valid), None),
                "results": [
                    {
                        "method": r.method,
                        "headers_per_sec": round(r.headers_per_sec),
                        "elapsed_s": round(r.elapsed_s, 4),
                    }
                    for r in reports
                ],
            }
        )
    )
    return 0 if ok else 1


# -- keygen and the store tools (engines in chain/tooling.py) --------------


def cmd_keygen(args) -> int:
    from p1_tpu_torch.core.keys import Keypair

    key = (
        Keypair.from_seed_text(args.seed_text)
        if args.seed_text is not None
        else Keypair.generate()
    )
    try:
        key.save(args.out, overwrite=args.force)
    except FileExistsError:
        print(
            f"{args.out} already exists; refusing to destroy its seed "
            "(use --force to overwrite)",
            file=sys.stderr,
        )
        return 2
    print(json.dumps({"config": "keygen", "account": key.account, "path": args.out}))
    return 0


def cmd_balances(args) -> int:
    from p1_tpu_torch.chain.tooling import run_balances

    _pin_sig_device(args)
    return run_balances(
        args.store,
        args.account,
        expected_difficulty=args.difficulty,
        retarget=_retarget_rule(args),
    )


def cmd_compact(args) -> int:
    from p1_tpu_torch.chain.tooling import run_compact

    _pin_sig_device(args)
    return run_compact(args.store, args.out, retarget=_retarget_rule(args))


def cmd_fsck(args) -> int:
    from p1_tpu_torch.chain.tooling import run_fsck

    _pin_sig_device(args)
    return run_fsck(args.store, args.out, json_out=args.json)


def cmd_snapshot(args) -> int:
    from p1_tpu_torch.chain.tooling import run_snapshot

    _pin_sig_device(args)
    return run_snapshot(
        args.action,
        args.store,
        args.file,
        interval=args.interval,
        retarget=_retarget_rule(args),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    handler = {
        "mine": cmd_mine,
        "sweep": cmd_sweep,
        "replay": cmd_replay,
        "keygen": cmd_keygen,
        "balances": cmd_balances,
        "compact": cmd_compact,
        "fsck": cmd_fsck,
        "snapshot": cmd_snapshot,
    }[args.cmd]
    return handler(args)


if __name__ == "__main__":
    sys.exit(main())
