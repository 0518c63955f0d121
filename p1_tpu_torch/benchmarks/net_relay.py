"""Block admission at the card's block rate: ``chip_smoke.py``'s phase 12
net (BASELINE config 4), ``--runs`` times, optionally beside another
checkout of the port.

    python -m p1_tpu_torch.benchmarks.net_relay [--runs 3] [--against CHECKOUT]

Four nodes at difficulty 20 on one card mine hundreds of blocks a second,
and every peer relays each block it accepts: the duplicate pushes that
the blocks admission budget (``node/governor.py``) charges, less what the
node refunds (``node/node.py`` ``RELAY_RACE_BLOCKS``).  Each net runs
``phase_net`` of its checkout's ``chip_smoke.py`` in a process of its own,
with that checkout's package; with ``--against`` (a directory holding
``chip_smoke.py`` and ``p1_tpu_torch``, such as a copy of this tree with a
change to compare) the two run in turns, the other first.  Prints each
net's phase line with its checkout, then one summary line per checkout
(nets converged, block admission drops, banned hosts, transfers failed,
mean µs of pool admission per admitted transfer), then the card's name
and power limit.  ``--device cpu`` and trailing net arguments (after
``--``) run it on a host at a small size.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve()
WORKER = "import sys, chip_smoke; chip_smoke.phase_net(sys.argv[1], tuple(sys.argv[2:]) or chip_smoke.NET_ARGS)"


def run_net(root: pathlib.Path, device: str, net_args: list[str]) -> dict:
    """One net through ``root``'s ``chip_smoke.phase_net``: its phase line,
    or the failure it raised."""
    proc = subprocess.run(
        [sys.executable, "-c", WORKER, device, *net_args],
        cwd=root, capture_output=True, text=True, timeout=900,
    )  # fmt: skip
    lines = [line for line in proc.stdout.splitlines() if line.startswith('{"phase": "net"')]
    if proc.returncode != 0 or not lines:
        return {"ok": False, "error": (proc.stderr or proc.stdout)[-2000:]}
    return {"ok": True, **json.loads(lines[-1])}


def summary(root: pathlib.Path, nets: list[dict]) -> dict:
    ok = [n for n in nets if n["ok"]]
    admission = [us for n in ok for us in n["admission_us_per_tx"].values() if us is not None]
    return {
        "checkout": str(root),
        "nets": len(nets),
        "converged": len(ok),
        "blocks_dropped": [n["admission_dropped_total"]["blocks"] for n in ok],
        "banned_hosts": [n["banned_hosts_total"] for n in ok],
        "txs_failed": [n["txs_failed"] for n in ok],
        "blocks_mined_total": [n["blocks_mined_total"] for n in ok],
        "admission_us_per_tx_median": statistics.median(admission) if admission else None,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3, help="nets per checkout")
    ap.add_argument("--against", type=pathlib.Path, help="another checkout of the port")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("net_args", nargs="*", help="net arguments in place of chip_smoke.NET_ARGS")
    args = ap.parse_args(argv)
    here = HERE.parents[2]
    roots = [here]
    if args.against is not None:
        other = args.against.resolve()
        if not (other / "chip_smoke.py").is_file() or not (other / "p1_tpu_torch").is_dir():
            raise SystemExit(f"{other} holds no chip_smoke.py and p1_tpu_torch")
        roots = [other, here]
    nets: dict[pathlib.Path, list[dict]] = {root: [] for root in roots}
    for r in range(args.runs):
        for root in roots if r % 2 == 0 else roots[::-1]:
            net = run_net(root, args.device, args.net_args)
            nets[root].append(net)
            print(json.dumps({"checkout": str(root), **net}), flush=True)
    for root in roots:
        print(json.dumps(summary(root, nets[root])), flush=True)
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()  # fmt: skip
        print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
