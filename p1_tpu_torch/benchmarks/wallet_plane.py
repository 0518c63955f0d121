"""Wallet push-plane benchmark of the port: live subscriptions at scale.

    python -m p1_tpu_torch.benchmarks.wallet_plane [--subs 100000]
        [--blocks 12] [--txs 24] [--skip-e2e] [--fleet] [--device cpu]

The port of ``benchmarks/wallet_plane.py``: one process holding >= 100k
live wallet subscriptions on a ``SubscriptionManager``, its per-block
notify latency (p95), and a small real-socket submit -> confirm -> push
measurement.  Notify cost is O(filter decode + subs x items), not
O(subs x filter decode): one decode is amortized across every session
(node/subscriptions.py).

Measurements:

- **wallet_subs** — live subscriptions held while the notify figures
  below were taken (the scale knob, default 100_000).
- **notify_p95_ms / notify_mean_ms** — per-block connect-to-delivered
  latency of ``SubscriptionManager.notify()`` across the measured
  blocks.
- **notify_events_per_sec** — delivered events/s during those blocks
  (subs x blocks / total notify time).
- **push_e2e_ms** — real sockets: a node mining on loopback (the
  ``cuda`` backend: ``hashx/csrc/sha256d_search.cu`` on the card, its
  plain PyTorch version under ``--device cpu``), a ``client.watch``
  session subscribed to the recipient account; wall time from
  ``send_tx()`` to the verified matched EVENT arriving.
- **fleet_*** — ``fleet_cold_start_s`` is ``serve --bootstrap``'s
  decide-to-serving-ready wall time (snapshot-based, bounded by blocks
  above the base, not chain length), and the ``bench_fleet`` family is
  the kill-one-replica proof: N replicas x many ReplicaSet-spread
  sessions on one store, the most-loaded replica killed mid-push,
  per-event notify p95 split before/after the kill, failovers, peak
  ``subs.queue_depth_bytes`` on survivors, and ``fleet_missed``
  (sessions whose stream went non-contiguous or unmatched; must be 0).

JSON: {"metric": "wallet_subs", "value": ..., "notify_p95_ms": ...}
— one line, measured, no estimates.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from pathlib import Path

from p1_tpu_torch.benchmarks.query_plane import build_chain


class _ThrottledSource:
    """ChainSubSource with a movable tip: the fixture chain is fully
    built up front, then 'connected' one block at a time so each
    notify() measures exactly one block's push cost."""

    def __init__(self, chain):
        self._chain = chain
        self.tip = 0

    @property
    def tip_height(self) -> int:
        return self.tip

    def hash_at(self, height: int):
        if not 0 <= height <= self.tip:
            return None
        return self._chain.main_hash_at(height)

    def raw_header_at(self, height: int):
        bh = self.hash_at(height)
        return None if bh is None else self._chain.header_of(bh).serialize()

    def filter_at(self, height: int):
        bh = self.hash_at(height)
        return None if bh is None else self._chain.block_filter(bh)

    def fheader_at(self, height: int):
        if height > self.tip:
            return None
        return self._chain.filter_headers.header_at(height)

    def block_items_at(self, height: int):
        from p1_tpu_torch.node.subscriptions import block_items_index

        bh = self.hash_at(height)
        return None if bh is None else block_items_index(self._chain.get(bh))


def bench_subs(
    subs: int = 100_000,
    warm_blocks: int = 4,
    measure_blocks: int = 12,
    txs: int = 24,
    matched_fraction: float = 0.01,
) -> dict:
    """>= ``subs`` live sessions on one SubscriptionManager; p95 notify
    latency per connected block.  ``matched_fraction`` of the sessions
    watch an account the fixture blocks actually pay (every block's
    transfers go to "bob"), the rest watch cold accounts — the
    realistic shape: almost every wallet is a non-match almost always.
    Delivery sinks count bytes and never backpressure (buffer 0), so
    the figure isolates the push plane, not the benchmark's sockets."""
    from p1_tpu_torch.node.subscriptions import SubscriptionManager

    chain = build_chain(warm_blocks + measure_blocks, txs, difficulty=1)
    source = _ThrottledSource(chain)
    mgr = SubscriptionManager(source)

    delivered = [0]

    async def _sink(payload: bytes) -> None:
        delivered[0] += 1

    def _buf() -> int:
        return 0

    def _close() -> None:
        pass

    async def _run() -> dict:
        n_matched = int(subs * matched_fraction)
        for i in range(subs):
            items = (
                [b"bob"]
                if i < n_matched
                else [b"cold-account-%d" % i, b"cold-change-%d" % i]
            )
            ok = await mgr.subscribe(
                i, items, None, send=_sink, buffer_size=_buf, close=_close
            )
            assert ok
        assert len(mgr) == subs

        # Warm-up: first connects touch cold caches (filter decode path).
        for h in range(1, warm_blocks + 1):
            source.tip = h
            await mgr.notify()

        samples_ms = []
        t_total = 0.0
        for h in range(warm_blocks + 1, warm_blocks + measure_blocks + 1):
            source.tip = h
            t0 = time.perf_counter()
            await mgr.notify()
            dt = time.perf_counter() - t0
            samples_ms.append(dt * 1000.0)
            t_total += dt
        samples_ms.sort()
        p95 = samples_ms[min(len(samples_ms) - 1, int(0.95 * len(samples_ms)))]
        return {
            "wallet_subs": len(mgr),
            "notify_p95_ms": round(p95, 2),
            "notify_mean_ms": round(
                sum(samples_ms) / len(samples_ms), 2
            ),
            "notify_events_per_sec": round(subs * measure_blocks / t_total),
            "events_delivered": delivered[0],
            "measure_blocks": measure_blocks,
        }

    return asyncio.run(_run())


def bench_push_e2e(difficulty: int = 20, timeout: float = 60.0, device: str = "cuda") -> dict:
    """submit -> confirm -> push over real loopback sockets: a mining
    node, one watch session on the recipient account, wall time from
    send_tx to the verified matched EVENT.

    The node mines through the ``cuda`` backend on ``device``.  At
    test-grade difficulties a host mines hundreds of blocks a second,
    which measures the watch client's replay treadmill instead of the
    push path."""
    from p1_tpu_torch.config import NodeConfig
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction
    from p1_tpu_torch.node.client import send_tx, watch
    from p1_tpu_torch.node.node import Node

    alice = Keypair.from_seed_text("wallet-plane-alice")

    async def _run() -> dict:
        node = Node(
            NodeConfig(
                host="127.0.0.1",
                port=0,
                difficulty=difficulty,
                mine=True,
                miner_id=alice.account,
                device=device,
            )
        )
        await node.start()
        try:
            # Let the miner fund alice before the spend.
            for _ in range(600):
                if node.chain.balance(alice.account) >= 2:
                    break
                await asyncio.sleep(0.05)
            gen = watch(
                "127.0.0.1",
                node.port,
                ["bob-wallet-plane"],
                difficulty,
                max_session_failures=3,
            )
            t0 = None
            latency_ms = None
            try:
                agen = gen.__aiter__()
                # First event proves the session is live before we time.
                await asyncio.wait_for(agen.__anext__(), timeout)
                tx = Transaction.transfer(
                    alice,
                    "bob-wallet-plane",
                    1,
                    1,
                    0,
                    chain=node.chain.genesis.block_hash(),
                )
                t0 = time.perf_counter()
                await send_tx("127.0.0.1", node.port, tx, difficulty)
                while True:
                    ev = await asyncio.wait_for(agen.__anext__(), timeout)
                    if ev["matched"]:
                        latency_ms = (time.perf_counter() - t0) * 1000.0
                        break
            finally:
                await gen.aclose()
            return {"push_e2e_ms": round(latency_ms, 1)}
        finally:
            await node.stop()

    return asyncio.run(_run())


def bench_quick(subs: int = 20_000, measure_blocks: int = 8) -> dict:
    """The ``bench`` hook: the same notify measurement at a size that
    keeps the headline bench fast; the 100k figure is main()'s job."""
    return bench_subs(subs=subs, warm_blocks=2, measure_blocks=measure_blocks)


def bench_cold_start(
    chain_blocks: int = 60,
    difficulty: int = 12,
    snapshot_interval: int = 16,
    device: str = "cuda",
) -> dict:
    """Replica cold-start figure: wall seconds from ``serve --bootstrap
    <node>`` deciding to join until its store is
    serving-ready — PoW-verified header skeleton, chunk-verified
    snapshot pinned to it, adopted filter headers, bodies above the
    base (node/provision.py bootstrap_store).  The point of the figure:
    it is bounded by blocks ABOVE the snapshot base, not by chain
    length — an IBD is bounded by chain length."""
    import tempfile

    from p1_tpu_torch.chain.store import ChainStore
    from p1_tpu_torch.config import NodeConfig
    from p1_tpu_torch.node.node import Node
    from p1_tpu_torch.node.provision import bootstrap_store
    from p1_tpu_torch.node.testing import make_blocks

    blocks = make_blocks(chain_blocks, difficulty, miner_id="fleet-src")

    async def _run() -> dict:
        with tempfile.TemporaryDirectory() as d:
            src = str(Path(d) / "node.dat")
            st = ChainStore(src, fsync=False)
            try:
                for b in blocks[1:]:
                    st.append(b)
                st.sync()
            finally:
                st.close()
            node = Node(
                NodeConfig(
                    host="127.0.0.1",
                    port=0,
                    difficulty=difficulty,
                    mine=False,
                    store_path=src,
                    snapshot_interval=snapshot_interval,
                    device=device,
                )
            )
            await node.start()
            try:
                report = await bootstrap_store(
                    str(Path(d) / "replica.dat"),
                    [("127.0.0.1", node.port)],
                    difficulty,
                )
            finally:
                await node.stop()
            return {
                "fleet_cold_start_s": report["cold_start_s"],
                "fleet_cold_start_base": report["base"],
                "fleet_cold_start_tip": report["tip"],
                "fleet_cold_start_blocks_fetched": report["blocks_fetched"],
            }

    return asyncio.run(_run())


def bench_fleet(
    replicas: int = 3,
    sessions: int = 48,
    blocks: int = 12,
    kill_at: int = 6,
    difficulty: int = 12,
    interval_s: float = 0.2,
) -> dict:
    """The kill-one-replica figure: ``replicas`` replica
    workers on ONE chain store, ``sessions`` wallet watch sessions
    spread across them by ReplicaSet policy (distinct spread keys), a
    writer appending one block per ``interval_s`` — and the most-loaded
    replica killed mid-push at height ``kill_at``.  Measured: per-event
    notify latency (append-to-verified-arrival) p95 overall and split
    before/after the kill (the "p95 stays flat" claim), total
    failovers, peak ``subs.queue_depth_bytes`` on the survivors, and
    missed confirmations (every block pays the watched account, so a
    session's stream must stay contiguous and fully matched — missed ==
    0 is the acceptance bar, not a statistic)."""
    import tempfile

    from p1_tpu_torch.chain.store import ChainStore
    from p1_tpu_torch.node.client import ReplicaSet, watch
    from p1_tpu_torch.node.queryplane import serve_replica
    from p1_tpu_torch.node.testing import make_blocks

    WARM = 2
    chain_blocks = make_blocks(blocks, difficulty, miner_id="fleet-acct")

    async def _run() -> dict:
        with tempfile.TemporaryDirectory() as d:
            store_path = str(Path(d) / "fleet.dat")
            store = ChainStore(store_path, fsync=False)
            for h in range(1, WARM + 1):
                store.append(chain_blocks[h], h)
            store.sync()

            srvs = [
                await serve_replica(
                    store_path, difficulty, refresh_interval_s=0.02
                )
                for _ in range(replicas)
            ]
            targets = [("127.0.0.1", s.port) for s in srvs]
            sets = [
                ReplicaSet(targets, spread_key=k) for k in range(sessions)
            ]
            arrivals: list[dict[int, float]] = [{} for _ in range(sessions)]
            streams: list[list] = [[] for _ in range(sessions)]

            async def _session(k: int) -> None:
                try:
                    async for ev in watch(
                        "127.0.0.1", srvs[0].port, ["fleet-acct"],
                        difficulty, replica_set=sets[k],
                        cross_check_every=0, reconnect_delay_s=0.05,
                        max_session_failures=None,
                    ):
                        arrivals[k][ev["height"]] = time.perf_counter()
                        streams[k].append(ev)
                except asyncio.CancelledError:
                    raise

            tasks = [
                asyncio.create_task(_session(k)) for k in range(sessions)
            ]
            # All ears before the measured appends.
            for _ in range(600):
                if sum(len(s.subscriptions) for s in srvs) >= sessions:
                    break
                await asyncio.sleep(0.02)

            appended_at: dict[int, float] = {}
            killed = None
            queue_peak = 0
            for h in range(WARM + 1, blocks + 1):
                store.append(chain_blocks[h], h)
                store.sync()
                appended_at[h] = time.perf_counter()
                if h == kill_at:
                    # The directed kill: the replica carrying the most
                    # active sessions, mid-push.
                    tally = {}
                    for s in sets:
                        if s.active is not None:
                            tally[s.active] = tally.get(s.active, 0) + 1
                    victim = max(sorted(tally), key=lambda t: tally[t])
                    killed = targets.index(victim)
                    await srvs[killed].stop()
                await asyncio.sleep(interval_s)
                queue_peak = max(
                    queue_peak,
                    *(
                        s.subscriptions.queue_depth_bytes
                        for i, s in enumerate(srvs)
                        if i != killed
                    ),
                )
            # Every session must reach the final height (failover done).
            for _ in range(600):
                if all(blocks in a for a in arrivals):
                    break
                await asyncio.sleep(0.05)
            for task in tasks:
                task.cancel()
            for task in tasks:
                try:
                    await task
                except asyncio.CancelledError:
                    pass
            for i, s in enumerate(srvs):
                if i != killed:
                    await s.stop()
            store.close()

            pre, post = [], []
            for a in arrivals:
                for h, t in a.items():
                    if h in appended_at:
                        (pre if h <= kill_at else post).append(
                            (t - appended_at[h]) * 1000.0
                        )
            def _p95(xs):
                if not xs:
                    return None
                xs = sorted(xs)
                return round(xs[min(len(xs) - 1, int(0.95 * len(xs)))], 2)
            missed = 0
            for s in streams:
                hs = [ev["height"] for ev in s]
                if hs != list(range(hs[0], hs[0] + len(hs))) or not all(
                    ev["matched"] for ev in s
                ):
                    missed += 1
            return {
                "fleet_replicas": replicas,
                "fleet_sessions": sessions,
                "fleet_killed_replica": killed,
                "fleet_failovers": sum(s.failovers for s in sets),
                "fleet_missed": missed,
                "fleet_notify_p95_ms": _p95(pre + post),
                "fleet_notify_p95_pre_kill_ms": _p95(pre),
                "fleet_notify_p95_post_kill_ms": _p95(post),
                "fleet_queue_depth_bytes_peak": queue_peak,
            }

    return asyncio.run(_run())


def bench_fleet_quick(replicas: int = 3, sessions: int = 24, device: str = "cuda") -> dict:
    """The ``bench`` hook: a small kill-one-replica run plus the
    cold-start figure — fast enough for the headline bench, shaped
    exactly like the acceptance run."""
    out = bench_fleet(replicas=replicas, sessions=sessions, blocks=10, kill_at=5)
    out.update(bench_cold_start(chain_blocks=48, device=device))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--subs", type=int, default=100_000)
    ap.add_argument("--blocks", type=int, default=12, help="measured blocks")
    ap.add_argument("--txs", type=int, default=24, help="transfers per block")
    ap.add_argument(
        "--skip-e2e",
        action="store_true",
        help="skip the real-socket submit->confirm->push measurement",
    )
    ap.add_argument(
        "--fleet",
        action="store_true",
        help="run the kill-one-replica fleet figure instead of the "
        "single-node push plane",
    )
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument(
        "--sessions",
        type=int,
        default=48,
        help="wallet sessions spread across the fleet (--fleet)",
    )
    args = ap.parse_args()

    if args.fleet:
        res = bench_fleet(replicas=args.replicas, sessions=args.sessions)
        res.update(bench_cold_start(device=args.device))
        import os

        print(
            json.dumps(
                {
                    "metric": "fleet_notify_p95_ms",
                    "value": res["fleet_notify_p95_ms"],
                    "unit": "ms",
                    "cpu_count": os.cpu_count(),
                    **res,
                }
            )
        )
        return

    res = bench_subs(
        subs=args.subs, measure_blocks=args.blocks, txs=args.txs
    )
    if not args.skip_e2e:
        res.update(bench_push_e2e(device=args.device))

    import os

    try:
        load_1m, load_5m, _ = os.getloadavg()
    except OSError:
        load_1m = load_5m = None

    print(
        json.dumps(
            {
                "metric": "wallet_subs",
                "value": res["wallet_subs"],
                "unit": "live subscriptions",
                "load_avg_1m": load_1m,
                "load_avg_5m": load_5m,
                "cpu_count": os.cpu_count(),
                **res,
            }
        )
    )


if __name__ == "__main__":
    main()
