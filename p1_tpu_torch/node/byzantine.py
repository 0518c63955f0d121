"""Byzantine actor suite: actively malicious net-soak participants.

Extracted from ``cli.py`` (which keeps only parsing + dispatch): the
whole hostile repertoire one `p1 net --byzantine N` actor cycles —
invalid signatures, overdraws, replays of confirmed transfers, forged
compact-block material, unsolicited BLOCKTXN, ADDR spam, oversized
frames, random garbage, and the silent camping session the liveness
layer exists to reap.  Test/soak infrastructure, not product: nothing in
the node imports this.  It lives in the package (like ``testing.py``'s
HostilePeer/GreedyPeer) so external rigs can drive the same adversaries
against real nodes without vendoring CLI internals.

The port's copy of ``p1_tpu/node/byzantine.py``.
"""

from __future__ import annotations

import asyncio

from p1_tpu_torch.node.transport import SOCKET_TRANSPORT


def new_stats() -> dict:
    """The shared mutable stats dict every actor feeds (one per soak)."""
    return {
        "attacks": {},
        "refused_connects": 0,
        "slow_hellos": 0,
        "camp_evictions": 0,
    }


async def sketch_poisoner(
    host, port, difficulty, deadline, retarget, stats: dict,
    transport=None,
) -> None:
    """A recon-plane adversary: a LISTENING peer that
    completes an honest handshake with a real node nonce — so victims
    that dial it treat the link as reconciliation-capable — then poisons
    every reconciliation primitive it touches:

    - answers each REQRECON with a garbage sketch (random bytes of a
      plausible length), so the victim's decode fails every round;
    - initiates its own REQRECON spam, burning responder sketch serves;
    - closes the victim's sketches with RECONCILDIFF frames full of
      fabricated short ids the victim will chase (bounded by its GETTX
      one-shot) and sprays GETTX for ids nothing maps to (bounded by
      the responder's pool-scan cap).

    A separate actor from ``byzantine_actor`` ON PURPOSE: that actor's
    seeded ``rng.choice`` attack schedule is pinned by existing scenario
    traces, and extending its tuple would silently re-roll every one.

    The honest invariant it exists to prove (asserted by the scenario,
    not here): relay cannot be stalled — the victim burns a few failed
    rounds, demotes the link to plain flood (``recon_demotions``), and
    every honest transaction still propagates mesh-wide.  Runs until
    ``deadline`` on the transport's wall clock."""
    import random

    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.node import protocol
    from p1_tpu_torch.node.protocol import Hello, MsgType

    transport = transport if transport is not None else SOCKET_TRANSPORT
    clock = transport.clock
    rng = random.Random(0x5EED ^ port)
    gh = make_genesis(difficulty, retarget).block_hash()
    nonce = rng.getrandbits(64) | 1  # a "real node", per the handshake

    def bump(name: str) -> None:
        stats["attacks"][name] = stats["attacks"].get(name, 0) + 1

    async def session(reader, writer) -> None:
        try:
            await protocol.write_frame(
                writer, protocol.encode_hello(Hello(gh, 0, port, nonce))
            )
            await asyncio.wait_for(protocol.read_frame(reader), 10)
            last_spam = clock.wall()
            while clock.wall() < deadline:
                payload = await asyncio.wait_for(
                    protocol.read_frame(reader),
                    timeout=max(0.1, deadline - clock.wall()),
                )
                if not payload:
                    continue
                if payload[0] == MsgType.REQRECON:
                    # A garbage sketch of a believable size: syndrome
                    # words drawn uniformly decode to None with
                    # overwhelming probability — every round the victim
                    # initiates on this link fails.
                    words = rng.randrange(2, 34)
                    await protocol.write_frame(
                        writer,
                        protocol.encode_sketch(
                            rng.randrange(1, 512),
                            rng.randbytes(4 * words),
                        ),
                    )
                    bump("garbage_sketch")
                elif payload[0] == MsgType.SKETCH:
                    # Our own spam round came back: claim success with
                    # fabricated "theirs" ids the victim will chase.
                    await protocol.write_frame(
                        writer,
                        protocol.encode_recondiff(
                            True,
                            tuple(
                                rng.randrange(1, 1 << 32) for _ in range(32)
                            ),
                        ),
                    )
                    bump("fake_diff")
                if clock.wall() - last_spam >= 0.5:
                    last_spam = clock.wall()
                    await protocol.write_frame(
                        writer,
                        protocol.encode_reqrecon(rng.randrange(0, 4096)),
                    )
                    bump("reqrecon_spam")
                    await protocol.write_frame(
                        writer,
                        protocol.encode_gettx(
                            tuple(
                                rng.randrange(1, 1 << 32) for _ in range(64)
                            )
                        ),
                    )
                    bump("gettx_spray")
        except (
            asyncio.TimeoutError,
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
            ValueError,
        ):
            pass  # victim hung up or the clock ran out: session over
        finally:
            writer.close()

    # The session coroutine doubles as the accept callback: both the
    # socket transport (asyncio.start_server) and the simulator wrap it
    # in a task per inbound connection.
    listener = await transport.listen(session, host, port)
    try:
        while clock.wall() < deadline:
            await asyncio.sleep(0.25)
    finally:
        listener.close()


async def byzantine_actor(
    actor: int, ports, difficulty, deadline, retarget, stats: dict,
    transport=None,
) -> None:
    """One actively malicious participant: connects
    to honest nodes from its own loopback alias (127.0.0.{10+actor}, so
    misbehavior bans hit the attacker's address, not the honest mesh's)
    and cycles the whole hostile repertoire.  Counts what it sent and how
    often the node refused it at accept time (= an active ban).  Every
    attack is fire-and-observe: the honest invariants are asserted from
    the nodes' final statuses, not from here.

    ``ports`` entries are localhost port numbers (the historical `p1
    net` shape) or explicit ``(host, port)`` targets; ``transport``
    (node/transport.py) defaults to real sockets — a netsim facade runs
    the identical repertoire, clock included, against a simulated mesh
    (the scenario corpus's containment runs).  ``deadline`` is read
    against the transport's wall clock either way."""
    import dataclasses
    import random
    import struct

    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.core.header import BlockHeader
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction
    from p1_tpu_torch.node import protocol
    from p1_tpu_torch.node.protocol import Hello, MsgType

    transport = transport if transport is not None else SOCKET_TRANSPORT
    clock = transport.clock
    targets = [
        ("127.0.0.1", p) if isinstance(p, int) else (p[0], int(p[1]))
        for p in ports
    ]
    rng = random.Random(0xBAD + actor)
    source = f"127.0.0.{10 + actor}"
    genesis = make_genesis(difficulty, retarget)
    gh = genesis.block_hash()
    tag = gh
    key = Keypair.from_seed_text(f"p1-byz-{actor}")
    harvested_txs: list[bytes] = []  # raw TX payloads seen in gossip
    harvested_headers: list[BlockHeader] = []

    def bump(name: str) -> None:
        stats["attacks"][name] = stats["attacks"].get(name, 0) + 1

    while clock.wall() < deadline - 1.0:
        host, port = targets[rng.randrange(len(targets))]
        try:
            reader, writer = await transport.connect(
                host, port, local_addr=(source, 0)
            )
        except OSError:
            await asyncio.sleep(0.2)
            continue
        try:
            first = await asyncio.wait_for(protocol.read_frame(reader), 5)
            mtype, _ = protocol.decode(first)
            assert mtype is MsgType.HELLO
        except asyncio.TimeoutError:
            # Slow HELLO ≠ ban: a GIL-loaded honest node can take
            # seconds — counting it as a refusal would let bans_fired
            # read true with the ban machinery broken.
            stats["slow_hellos"] = stats.get("slow_hellos", 0) + 1
            writer.close()
            await asyncio.sleep(0.2)
            continue
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
            ValueError,
        ):
            # Immediate hang-up before HELLO: the accept-time ban said no.
            stats["refused_connects"] += 1
            writer.close()
            await asyncio.sleep(0.2)
            continue
        harvester = None
        try:
            await protocol.write_frame(
                writer, protocol.encode_hello(Hello(gh, 0, 0, 0))
            )
            session_end = min(deadline - 0.5, clock.wall() + 2.0)

            async def harvest() -> None:
                try:
                    while True:
                        payload = await protocol.read_frame(reader)
                        if not payload:
                            continue
                        if (
                            payload[0] == MsgType.TX
                            and len(harvested_txs) < 64
                        ):
                            harvested_txs.append(payload)
                        elif payload[0] == MsgType.BLOCK:
                            try:
                                _, (_ts, blk) = protocol.decode(payload)
                                if len(harvested_headers) < 16:
                                    harvested_headers.append(blk.header)
                            except ValueError:
                                pass
                except (
                    asyncio.IncompleteReadError,
                    ConnectionError,
                    OSError,
                ):
                    return  # node hung up on us (a ban working) — done

            harvester = asyncio.create_task(harvest())
            if deadline - clock.wall() >= 25.0 and rng.random() < 0.25:
                # A CAMPING session — the exact
                # slot-pinning profile: hold the connection, reading but
                # never sending, until the liveness layer reaps us.
                # Decided ONCE per session with small probability (a
                # per-iteration draw converted ~99% of sessions into
                # camps and starved the ban machinery the containment
                # contract asserts), and skipped near the deadline so
                # short runs still exercise every other attack.  The
                # session sends nothing after HELLO, so a teardown here
                # is attributable to the keepalive probe (accept-time
                # bans close pre-HELLO and never reach this point).
                bump("camp")
                camp_end = clock.wall() + 20.0
                while clock.wall() < camp_end:
                    if writer.is_closing() or harvester.done():
                        stats["camp_evictions"] += 1
                        break
                    await asyncio.sleep(0.5)
            else:
                while clock.wall() < session_end:
                    attack = rng.choice(
                        (
                            "badsig",
                            "overdraw",
                            "replay",
                            "cblock",
                            "blocktxn",
                            "addr_spam",
                            "garbage",
                        )
                    )
                    if attack == "replay" and not harvested_txs:
                        attack = "garbage"  # nothing harvested yet
                    if attack == "cblock" and not harvested_headers:
                        attack = "garbage"
                    if attack == "badsig":
                        tx = Transaction.transfer(
                            key, "p1deadbeefdeadbeef", 1, 1, 0, chain=tag
                        )
                        forged = dataclasses.replace(
                            tx, sig=bytes(64)  # zeroed signature
                        )
                        await protocol.write_frame(
                            writer, protocol.encode_tx(forged)
                        )
                    elif attack == "overdraw":
                        tx = Transaction.transfer(
                            key,
                            "p1deadbeefdeadbeef",
                            10**12,  # the attacker's balance is zero
                            1,
                            0,
                            chain=tag,
                        )
                        await protocol.write_frame(writer, protocol.encode_tx(tx))
                    elif attack == "replay":
                        # A transfer harvested from gossip earlier: by now
                        # confirmed on-chain — a definite nonce replay.
                        await protocol.write_frame(
                            writer, harvested_txs[rng.randrange(len(harvested_txs))]
                        )
                    elif attack == "cblock":
                        # Real recent header with the nonce bumped: parent
                        # known, PoW broken — must die at the work gate.
                        h = harvested_headers[-1]
                        fake = dataclasses.replace(h, nonce=h.nonce ^ 1)
                        payload = (
                            bytes([MsgType.CBLOCK])
                            + struct.pack(">d", clock.wall())
                            + fake.serialize()
                            + struct.pack(">HH", 1, 0)
                            + bytes(32)
                        )
                        await protocol.write_frame(writer, payload)
                    elif attack == "blocktxn":
                        await protocol.write_frame(
                            writer,
                            protocol.encode_blocktxn(
                                rng.randbytes(32), [rng.randbytes(40)]
                            ),
                        )
                    elif attack == "addr_spam":
                        addrs = [
                            (f"10.66.{rng.randrange(256)}.{rng.randrange(256)}",
                             rng.randrange(1, 0xFFFF))
                            for _ in range(64)
                        ]
                        await protocol.write_frame(
                            writer, protocol.encode_addr(addrs)
                        )
                    else:  # garbage: malformed bytes — a scorable violation
                        writer.write(
                            (rng.randrange(1, 64)).to_bytes(4, "big")
                            + rng.randbytes(rng.randrange(1, 64))
                        )
                        await writer.drain()
                    bump(attack)
                    await asyncio.sleep(0.05)
                # Sign off with the canonical scorable violation so bans
                # accumulate: a hostile length prefix.
                writer.write((64 << 20).to_bytes(4, "big"))
                await writer.drain()
                bump("oversized")
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass  # node dropped us mid-attack: working as intended
        finally:
            if harvester is not None:
                harvester.cancel()  # no-op if it already returned; its
                # own except clause swallows disconnects, so no
                # unretrieved-exception warnings either way
            writer.close()
        await asyncio.sleep(0.1)
