"""Multi-process pod mining: many processes, one miner on the gossip network.

The port of ``p1_tpu/parallel/pod.py``.  ``init_distributed`` forms one
``torch.distributed`` group of every process; the ``sharded`` backend's
mesh then spans them (each process runs the search kernel on its own
slots, ``hashx/sharded.py``), and only the leader process speaks the p2p
gossip protocol.

Every collective of the pod rides **gloo**, on the card too.  None of them
carries device data: the 96-byte START/SHUTDOWN frame, one CONTINUE/ABORT
byte a chunk, the construction handshake, and one 8-byte min a search
step, which the pipelined host loop reads back to the host anyway.  Gloo
also runs two processes on one card, which NCCL refuses.

**Lockstep design**: every process must issue the same sequence of
collectives.  Everything inside a nonce search is deterministic given its
inputs: the sharded backend's fixed step spans (no opening ramp), the
chunk loop, the same masked partial last step, the timestamp roll, and
the min that every process reduces at the same drain point of every step
before any hit decision.  So only two things need host-level agreement,
both broadcast from the leader:

1. what to search (START: the 80-byte draft header + start nonce), and
2. whether to keep going (one CONTINUE/ABORT byte per chunk, hooked into
   ``Miner._chunk_sync``: the leader's abort event, e.g. "new tip arrived
   via gossip", reaches every process at the same chunk boundary).

A follower therefore runs the IDENTICAL ``Miner.search_nonce`` loop and
leaves it at the same iteration with the same result; it just discards
the sealed header (the leader's node gossips the block).

A lost peer makes a collective raise or block.  ``heartbeat`` runs only
after a collective has completed, so either way the watchdog
(``parallel/watchdog.py``) sees no progress and ends the process.
"""

from __future__ import annotations

import datetime
import threading

import torch

from p1_tpu_torch.core.header import HEADER_SIZE, BlockHeader
from p1_tpu_torch.miner import Miner

# START/SHUTDOWN frame: op(1) + pad(7) + start_nonce(u64) + header(80).
_CTRL = 96
_OP_START = 1
_OP_SHUTDOWN = 2


def init_distributed(
    coordinator: str, num_processes: int, process_id: int, timeout_s: float = 600.0
) -> None:
    """Join the pod's gloo process group at ``coordinator`` (host:port of
    process 0, which serves the rendezvous).

    After this, ``get_backend("sharded")`` shards nonce ranges over every
    slot of every process.  ``timeout_s`` bounds the rendezvous and every
    collective: a peer silent for that long is lost.
    """
    import torch.distributed as dist

    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _broadcast_bytes(data: bytes | None, size: int) -> bytes:
    """Leader (data != None) -> everyone; returns the agreed bytes."""
    import torch.distributed as dist

    buf = torch.zeros(size, dtype=torch.uint8)
    if data is not None:
        if len(data) > size:
            raise ValueError(f"control frame {len(data)} > {size}")
        buf[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    dist.broadcast(buf, src=0)
    return bytes(buf.tolist())


def _allgather(values: list[int]) -> list[list[int]]:
    import torch.distributed as dist

    mine = torch.tensor(values, dtype=torch.int64)
    everyone = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(everyone, mine)
    return [t.tolist() for t in everyone]


class PodMiner(Miner):
    """A Miner whose chunk loop runs in lockstep across all processes.

    Leader (process 0): plug into a ``Node`` like any Miner — every
    ``search_nonce`` broadcasts a START frame, then mines normally with
    per-chunk CONTINUE/ABORT broadcasts.  Followers: call ``follow()``,
    which mirrors each search until ``shutdown()``.
    """

    def __init__(self, *, is_leader: bool, **kwargs):
        super().__init__(**kwargs)
        self.is_leader = is_leader
        self._cv = threading.Condition()
        self._busy = False
        #: Optional liveness callback, invoked after every lockstep point
        #: (search start, each chunk, each mirrored search) — the CLI
        #: wires a watchdog to it so a vanished peer doesn't hang the
        #: survivor in a collective forever.
        self.heartbeat = None
        #: Searches started (leader) or mirrored (follower): equal across
        #: the pod once it has shut down.
        self.searches = 0
        # Construction-time config handshake: lockstep depends on every
        # process using the same chunk and per-step span — a mismatch would
        # diverge the collective sequence and hang the pod with no
        # diagnostic.  allgather (not broadcast) so EVERY rank — leader
        # included — sees the disagreement and fails loudly.
        mine = [self.chunk, getattr(self.backend, "step_span", 0)]
        everyone = _allgather(mine)
        if any(row != mine for row in everyone):
            raise ValueError(
                "pod config mismatch: per-process (chunk, step_span) = "
                f"{everyone} — launch every process with identical "
                "--chunk/--batch"
            )

    def _beat(self) -> None:
        if self.heartbeat is not None:
            self.heartbeat()

    # -- leader ----------------------------------------------------------

    def search_nonce(
        self,
        header: BlockHeader,
        abort: threading.Event | None = None,
        start_nonce: int = 0,
    ) -> BlockHeader | None:
        if not self.is_leader:
            raise RuntimeError("followers mirror via follow(), not search_nonce")
        with self._cv:
            self._busy = True
        try:
            frame = (
                bytes([_OP_START])
                + bytes(7)
                + int(start_nonce).to_bytes(8, "big")
                + header.serialize()
            )
            _broadcast_bytes(frame, _CTRL)
            self._beat()
            self.searches += 1
            return super().search_nonce(header, abort, start_nonce)
        finally:
            with self._cv:
                self._busy = False
                self._cv.notify_all()

    def shutdown(self, timeout: float = 120.0) -> None:
        """Leader: release followers from ``follow()``.

        Joins any in-flight search first: its worker thread still owes the
        followers per-chunk broadcasts, and a SHUTDOWN frame interleaved
        with those would desync the collective sequence pod-wide.  The
        caller must have aborted the search already (Node.stop_mining does)
        or this times out.
        """
        if not self.is_leader:
            return
        with self._cv:
            if not self._cv.wait_for(lambda: not self._busy, timeout=timeout):
                raise RuntimeError(
                    "shutdown() while a search is still running — abort it "
                    "first (stop_mining)"
                )
        _broadcast_bytes(bytes([_OP_SHUTDOWN]), _CTRL)

    # -- follower --------------------------------------------------------

    def follow(self) -> int:
        """Mirror the leader's searches until SHUTDOWN; returns how many
        searches were mirrored."""
        if self.is_leader:
            raise RuntimeError("the leader drives searches itself")
        while True:
            frame = _broadcast_bytes(None, _CTRL)
            self._beat()
            op = frame[0]
            if op == _OP_SHUTDOWN:
                return self.searches
            if op != _OP_START:
                raise ValueError(f"unexpected pod control op {op}")
            start_nonce = int.from_bytes(frame[8:16], "big")
            header = BlockHeader.deserialize(frame[16 : 16 + HEADER_SIZE])
            self.searches += 1
            super().search_nonce(header, abort=None, start_nonce=start_nonce)

    # -- lockstep chunk gate ---------------------------------------------

    def _chunk_sync(self, abort: threading.Event | None) -> bool:
        """One byte of leader truth per chunk: every process leaves the
        chunk loop at the same iteration."""
        if self.is_leader:
            stop = abort is not None and abort.is_set()
            out = _broadcast_bytes(bytes([int(stop)]), 1)
        else:
            out = _broadcast_bytes(None, 1)
        self._beat()
        return out[0] != 0
