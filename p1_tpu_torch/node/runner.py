"""The `p1 node` process runner: args namespace -> configured Node loop.

Extracted from ``cli.py`` (which keeps only parsing + dispatch): builds
the ``NodeConfig``, runs the node through its deadline/duration/status
loop, and owns the quiesce dance and the ``--store-degraded-exit``
watch.  `p1 pod`'s leader reuses it with its own arg namespace and a
``PodMiner`` injected.

The port's copy of ``p1_tpu/node/runner.py``; ``--device`` becomes the
config's ``device``, the native Ed25519 engine is loaded before the node
starts, and at exit the node logs each kernel wrapper's launch count
(``kernel_launches``).
"""

from __future__ import annotations

import asyncio
import json
import sys
import time


async def run_node(args, miner=None) -> int:
    from p1_tpu_torch.config import NodeConfig
    from p1_tpu_torch.node import Node

    config = NodeConfig(
        difficulty=args.difficulty,
        backend=args.backend,
        device=args.device,
        host=args.host,
        port=args.port,
        peers=tuple(args.peers),
        mine=not args.no_mine,
        store_path=args.store,
        batch=args.batch,
        chunk=args.chunk,
        miner_id=args.miner_id,
        # getattr: `p1 pod` reuses this runner with its own arg namespace,
        # which has no retarget or compact-gossip flags (pod mining is
        # fixed-difficulty — config 5's shape).
        retarget_window=getattr(args, "retarget_window", 0),
        target_spacing=getattr(args, "target_spacing", 0),
        compact_gossip=not getattr(args, "no_compact_gossip", False),
        target_peers=getattr(args, "target_peers", 0),
        mempool_ttl_s=getattr(args, "mempool_ttl", 3600.0),
        handshake_timeout_s=getattr(args, "handshake_timeout", 10.0),
        ping_interval_s=getattr(args, "ping_interval", 60.0),
        pong_timeout_s=getattr(args, "pong_timeout", 20.0),
        sync_stall_timeout_s=getattr(args, "sync_stall_timeout", 10.0),
        sync_attempts_max=getattr(args, "sync_attempts", 8),
        revalidate_store=getattr(args, "revalidate_store", False),
        verify_workers=getattr(args, "verify_workers", 0),
        pipeline_workers=getattr(args, "pipeline_workers", 0),
        sig_backend=getattr(args, "sig_backend", "auto"),
        store_degraded_exit=getattr(args, "store_degraded_exit", False),
        # Overload resilience (node/governor.py): the watermark flag is
        # MB on the command line, bytes in the config.
        admission_control=not getattr(args, "no_admission_control", False),
        mem_watermark_bytes=int(
            getattr(args, "mem_watermark_mb", 0.0) * (1 << 20)
        ),
        body_cache_blocks=getattr(args, "body_cache", 0),
        telemetry=not getattr(args, "no_telemetry", False),
        # Archive-scale layout (chain/segstore.py): segment size is MB
        # on the command line, bytes in the config.
        store_segment_bytes=int(
            getattr(args, "store_segment_mb", 0.0) * (1 << 20)
        ),
        prune_keep_blocks=getattr(args, "prune", 0),
        snapshot_interval=getattr(args, "snapshot_interval", 0),
    )
    # The serial signature rung's library loads here, before the node
    # serves (and on a host that has not built it, compiles: one g++),
    # not inside the event loop on the first transfer it admits.
    from p1_tpu_torch.core import _ed25519_native

    _ed25519_native.load()
    node = Node(config, miner=miner)
    await node.start()
    # --store-degraded-exit watch: the node signals instead of exiting
    # itself so teardown (final status line, mempool save, store close)
    # still runs through the one path below.  Exit code 4.
    fatal = asyncio.ensure_future(node.store_fatal.wait())
    rc = 0
    try:
        if args.deadline is not None or args.duration is not None:
            if args.deadline == "stdin":
                print(json.dumps({"ready": node.port}), flush=True)
                loop = asyncio.get_running_loop()
                line = await loop.run_in_executor(None, sys.stdin.readline)
                deadline = float(line.strip())
            elif args.deadline is not None:
                deadline = float(args.deadline)
            else:
                deadline = time.time() + args.duration
            window = max(0.0, deadline - time.time())
            # Through the node's identity adapter (node/telemetry.py
            # NodeLogAdapter): in a multi-node process (`p1 net`,
            # netharness workers sharing stderr) this line must say
            # WHICH node's window it is.
            node.log.info("mining window: %.2fs until deadline", window)
            await asyncio.wait({fatal}, timeout=window)
            if fatal.done():
                rc = 4
            else:
                # Quiesce: stop producing, then wait for the gossip
                # backlog to drain (GIL-bound mining starves the event
                # loop, so a fixed sleep can undershoot): exit once the
                # chain has been stable for a full second, or after 20s
                # regardless.
                await node.stop_mining()
                await node.request_sync()
                t_end = time.monotonic() + 20.0
                stable = (node.chain.tip_hash, node.metrics.blocks_accepted)
                stable_since = time.monotonic()
                while time.monotonic() < t_end:
                    await asyncio.sleep(0.1)
                    now_state = (
                        node.chain.tip_hash,
                        node.metrics.blocks_accepted,
                    )
                    if now_state != stable:
                        stable, stable_since = now_state, time.monotonic()
                        await node.request_sync()
                    elif time.monotonic() - stable_since >= 1.0:
                        break
        else:
            while True:
                await asyncio.wait({fatal}, timeout=args.status_interval)
                if fatal.done():
                    rc = 4
                    break
                print(json.dumps(node.status()), flush=True)
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        fatal.cancel()
        print(json.dumps(node.status()), flush=True)
        await node.stop()
        node.log.info("kernel launches: %s", json.dumps(kernel_launches()))
        admission = {
            "port": node.port,
            "txs_accepted": node.metrics.txs_accepted,
            "s": node.tx_admission_s,
        }
        node.log.info("tx admission: %s", json.dumps(admission))
    return rc


#: The kernel wrappers a node can launch: (name, module, wrapper).
_KERNEL_WRAPPERS = (
    ("sha256d_search", "p1_tpu_torch.hashx.cuda_backend", "sha256d_search"),
    ("ed25519_msm", "p1_tpu_torch.hashx.cuda_ed25519", "ed25519_msm"),
)


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count in this process, for the
    wrappers it loaded (a node whose work stayed on the host loads none).
    The node logs it at exit: the card's share of a node's run, which
    ``status()`` does not carry."""
    return {
        name: getattr(sys.modules[module], wrapper).launches
        for name, module, wrapper in _KERNEL_WRAPPERS
        if module in sys.modules
    }
