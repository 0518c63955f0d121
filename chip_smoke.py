#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``p1_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's paths, ``mine``, ``replay``, signature validation
(``check_block`` under the ``device`` rung), the untrusted load of a
chain store, a node and the 4-node net, the native host tier, and the
multi-chip plane (sharded search and MSM, a pod), on the GPU and its
host in phases, one JSON line each, and fails (non-zero exit, no last
line) if any phase fails:

1. card and build — the card's name and power limit, the kernel built from
   ``p1_tpu_torch/hashx/csrc/sha256d_search.cu`` with ``nvcc`` for
   ``sm_90a``, its registers and local-memory (spill) bytes, its SASS count;
   the native host core built from ``p1_tpu_torch/native/*.cpp`` with one
   ``g++`` beside the ``nvcc`` runs (``native_build_s``);
2. kernel vs plain version — raw steps of ``cuda_search_fn`` against
   ``torch_sha256.search_step`` on the card, on seeded headers at
   difficulty 0/8/16/64, nonce bases 0, 0x1000 and 0xFFFFF000 (wrap), at
   the ramp-floor span and the default batch: every offset must be equal;
3. the main path — ``Miner(backend=get_backend("cuda"))`` mines 10 blocks
   at difficulty 20 from the genesis header through ``cli.mine_chain``;
   every seal is checked with hashlib, linked to its parent, and proven the
   earliest by the plain version scanning ``[0, nonce)`` on the card; the
   kernel's launch count over that run must be > 0;
4. throughput — kernel time per step (CUDA events), end-to-end hashes/s of
   a full 2**32 scan through ``backend.search``, the plain version's time,
   the operations bound from the SASS at the white paper's rate, and the
   batch × threads × sub sweep;
5. roofline — ``int_roofline.cu`` against ``vpu_roofline.bench_step`` on the
   card for 4 mixes × chains {1, 4, 8} × grids {7, 132} × iters {16, 40};
   each instance's registers, spills, occupancy and loop-body SASS; then
   the roofline entry point ``run_bench`` (the path whose launches are
   counted): the rate per mix in the reference's op units and in
   integer-ALU instructions per clock per SM at the SM clock the kernel
   sampled; every shape it launched against ``bench_step`` on the same
   seeds; kernel 1's bound restated at the measured rate and clock;
6. replay — ``verify_chain.cu`` (one thread per header) against the plain
   ``verify_header_chain_segments`` on the card on seeded fixtures, block
   and chain ends among them; the ``replay`` command at --n 10000
   --difficulty 16 (mined through the search kernel, verified by
   ``replay_host`` and ``replay_device``: the path whose launches are
   counted); corruptions that both must flag at the same index; the kernel
   against the plain version on the 10,000-header chain; its device time
   at 10,000 and 2**20 headers from a CUDA graph of 50 launches
   (``benchmarks/verify_time.py``), the profiler's kernel time, and the
   host loop's time (``ms_enqueue``).  verify_chain's bound counts a
   pinned work per header (``VERIFY_ALU_PER_HEADER``), or the kernel's own
   where that is less, and ed25519_msm's the reference's operations
   (``ED_OPS_PER_POINT``, ``ED_OPS_PER_BATCH``);
7. ed25519_kernel_vs_plain — ``ed25519_msm.cu`` (decompression, tables,
   gate and Horner MSM, then the sum) against the plain
   ``plain_decode_gate_msm`` on the card: the encodings of random
   subgroup points, the identity, points of order 2, 4 and 8 and points
   with a torsion component, each times scalars 0, 1, q − 1, a 128-bit
   and a 253-bit one, and crafted encodings (y = 0, 1, p − 1 with and
   without the sign, a non-square y, y ≥ p, random bytes); the decoded
   points must equal the plain version's and ``_pt_decompress``'s limb for
   limb, the flags the plain version's and ``_in_prime_subgroup``'s, and
   the canonical sum the plain version's and the big-integer Σ; then the
   same at the 1,024-signature batch;
8. sig_verify — ``verify_batch_device`` at 1,024 signed triples of the
   bench's eight keys: valid, one bad signature at 0 / 511 / 1023, a
   torsion-cancelling and a torsion-rejecting triple and an R that does
   not decode, each verdict equal to ``_ed25519.verify_batch``'s; a
   malformed batch returns False with no launch; µs per signature and
   its host/copy/kernel/read-back/close split at 64, 256, 1,024 and
   4,096; the kernels' device time at 1,024 from a CUDA graph of 50
   launches, block 0's cycles per phase (``phase_clocks``), the plain
   version's time the median of 3 calls after a warm one;
9. check_block — the main path whose launches are counted: on the
   default signature rung (``device``, on the card), ``check_block`` on a
   block of a coinbase and 999 signed transfers (one launch, 999 device
   signatures)
   and ``preverify_signatures`` on a 4,096-signature window (four
   launches); the block with one bad signature raises ``ValidationError
   ("bad transaction signature")``.
10. revalidate — the store path whose launches are counted: a store of
   520 blocks and 4,152 signed transfers (``host_ingest.build_blocks(520,
   8, difficulty=1)``, ``save_chain``) loaded untrusted through
   ``ChainStore.load_chain(trusted=False)`` on the default rung: one full
   4,096-signature window (four launches) and a 56-signature tail (one),
   5 launches and 4,152 device signatures; the tip, height, balances and
   every nonce equal to the built chain's and a trusted load's; wall times
   (median of three) of the untrusted load (blocks/s, µs per signature),
   of a load with the cache warm and of the trusted load; the
   ``balances`` command on the store through ``cli.main`` (its launches
   counted: 5 again) and as
   ``python -m p1_tpu_torch balances`` (exit 0, the same JSON); one
   signature flipped in the record at height 300 with its CRC fixed: the
   untrusted load stops at height 299, as the serial lane's load (every
   transfer verified alone, on the native rung) does.
11. node — ``python -m p1_tpu_torch node`` processes on the card (each
   logs its kernel wrappers' launch counts at exit, which the phase reads):
   (a) ``--no-mine --store S --revalidate-store --deadline stdin`` on phase
   10's store boots through the untrusted load (its status: the store's
   tip and height, 4,152 device signatures; 5 ``ed25519_msm`` launches),
   then 200 signed transfers pushed down one session, and a GETSTATUS
   after them on the same session, time its admission (the serial check on
   the native rung, µs per transaction, on the sending side and as the
   node logs it; the node's ``validation.backends`` must have counted the
   200 under ``native`` and none under ``pure-python``); (b) a second node
   with an empty store and ``--peers`` the first deep-syncs the chain and
   the pool (same tip, device signatures > 0, launches > 0); (c) a mining
   node at difficulty 20 for 10 s (``blocks_mined`` > 0, search launches
   > 0), every block of its store checked by hashlib for its target and
   its link.  Wall times, heights, device signatures and each child's
   start time are printed.
12. net — ``python -m p1_tpu_torch net --nodes 4 --difficulty 20
   --duration 20 --tx-rate 2`` (BASELINE config 4), four node processes on
   the one card, on a block of ports free at run time: exit 0,
   ``converged`` and ``economy.ledger_conserved``; height, blocks mined,
   reorgs, propagation delay, transfers submitted and accepted, each
   node's ``validation.backends`` (no signature on ``pure-python``; with
   transfers, some on ``native``), launches, bans and admission drops, and
   its mean µs of pool admission per admitted transfer (logged at exit).
13. native — the host tier on the card's host: the native library must
   load and be the serial signature rung (else the phase fails: the
   card's path never passes quietly on pure Python); ``has_shani``; the
   native backend's first hit equal to the search kernel's and the plain
   version's on phase 2's fixtures, in both compressions
   (``force_scalar``); ``replay --n 10000 --difficulty 16 --method all
   --device cuda`` through ``cli.main`` (exit 0; host, native and
   ``verify_chain.cu`` valid, each with its headers/s; its search and
   verify launches counted); native, host and device naming the same first
   invalid header on phase 6's corruptions; µs per signature of a serial
   native verify, a 1,024 native batch and the device rung on the same
   triples (``sig_verify.bench_native``).
14. multichip — the multi-chip plane on the one card (``hashx/sharded.py``,
   ``parallel/``, ``graft_entry.py``; every figure beside the
   ``nvidia-smi`` line): the ``sharded`` backend on a one-slot and a
   4-slot mesh (four streams of ``cuda:0``) gives phase 2's first hits
   (misses: the span), a hit in slot 2 or 3 (equal to the kernel's and
   the plain version's), and on 63 slots (span 2**32 - 2**26) the miss
   and a hit past 2**31; its rate over full 2**32 scans at difficulty 64
   and the 4-slot step's device time beside 4x the search bound; the
   4-slot step at 2**22 a slot equal to its plain body on a miss and on
   a hit past slot 0;
   ``mine --backend sharded --difficulty 28`` (BASELINE config 5) for 8
   blocks on both meshes (``cli.mine_chain``, the path whose launches are
   counted) seals ``cuda``'s headers; ``verify_batch_device`` on phase
   8's 1,024 triples on 4 slots and 1 (one launch a slot): the same
   verdicts valid, with another R in each slot, and on the torsion
   crafts, µs per signature; each of the 4 slices through the kernels on
   its slot's stream equal to the plain version (decoded limbs, flags,
   all-ok, canonical partial sum) and the big-integer oracle, and the 4
   slices' device time; a pod of two
   ``python -m p1_tpu_torch pod`` processes on gloo with a listener node
   (the leader's blocks reach it and pass hashlib, the follower mirrored
   every search, each process's launches), then a pod whose follower is
   SIGKILLed (the leader fails over to solo mining, its store grows, exit
   codes); ``dryrun_multichip(4, device="cuda")``.

Every ``bound_ms`` of the ``kernels`` line is taken at the card's peak
integer rate: the larger of the white paper's rate and the one phase 5
measured, at the larger of ``clocks.max.sm`` and the SM clock phase 5
measured; the white paper's bound rides beside it.  Then the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Without
a CUDA device it exits 2.  It stops every process it starts: it adopts
its children's orphans (``PR_SET_CHILD_SUBREAPER``), and before the
``kernels`` line it stops ``multiprocessing``'s resource tracker (which
phase 8's spawn pools start) and fails if any child is still running; on
any exit it kills and reaps what is left.  The four kernel sources are built at the start,
one ``nvcc`` each, all at once, with the native library's ``g++``; a node
child loads what is built.  The ``launches`` of ``sha256d_search`` and
``ed25519_msm`` add phases 11 and 12's children to this process's paths
(``launches_node``, ``launches_net`` beside them); phase 13's replay
launches ride beside the search and verify kernels' totals
(``launches_native_replay``); phase 14's sharded mining and pod
processes add to ``sha256d_search``'s (``launches_multichip``,
``launches_pod``), its sharded MSM to ``ed25519_msm``'s.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import pathlib
import random
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

DIFFICULTY = 20
BLOCKS = 10
NO_HIT = 64  # difficulty at which a step's whole batch is hashed
PLAIN_CHUNK = 1 << 22  # lanes per plain-version call (int64 lanes: ~GBs live)
REPLAY_N = 10_000  # BASELINE config 3
REPLAY_DIFFICULTY = 16
SIG_BATCH = 1024  # keys.BATCH_CHUNK: one device launch
BLOCK_TXS = 1000  # config.max_block_txs: a coinbase and 999 transfers
PREVERIFY_N = 4096  # chain/validate.py PREVERIFY_WINDOW
SIG_DIFFICULTY = 8  # the check_block fixture chain
REVAL_BLOCKS = 520  # the revalidated store: 519 blocks of 8 transfers
REVAL_TXS = 8
TAMPER_HEIGHT = 300  # the record whose signature is flipped
ROOT = pathlib.Path(__file__).resolve().parent  # where ``python -m p1_tpu_torch`` resolves
ADMIT_TXS = 200  # transfers pushed to a live node to time its admission
NODE_MINE_DIFFICULTY = 20  # phase 11's mining node: BASELINE's difficulty
NODE_MINE_S = 10
NET_ARGS = ("--nodes", "4", "--difficulty", "20", "--duration", "20", "--tx-rate", "2")  # BASELINE config 4
CHILD_TIMEOUT_S = 300  # a node child's start, sync or exit
#: q = 2^252 + 27742317777372353535851937790883648493 in 4-bit digits,
#: least significant first: the gate's scalar, the same for every point.
ED_Q_DIGITS = tuple(((2**252 + 27742317777372353535851937790883648493) >> (4 * w)) & 15 for w in range(64))
#: ed25519_msm's work, pinned from the reference's operation count rather
#: than from a design's SASS, counting only the operations this run's
#: data needs: per point, one decompression (ref10's pow22523 chain, 251
#: squarings and 11 products, and around it 3 squarings and 9 products: 254
#: and 20), a window table of 14 point additions, the gate's 33 additions
#: (one per non-zero digit of q) and 252 doublings (q's top digit is 1, so
#: the four doublings before it would act on the identity), and the MSM's
#: 64 additions (one table row per point per window, summed); per batch,
#: the Horner accumulator's 252 doublings and 63 additions (its top window
#: likewise starts from the identity), less the 64 that a window's sum of N
#: rows saves (N - 1 additions, not N): -1 addition.  Per operation, in ten
#: limbs: a point addition is 9 field products and 9 field additions or
#: subtractions, a doubling 4 squares, 4 products and 6 additions.  A
#: product costs 100 limb products (IMAD.WIDE, FMA pipe, each accumulating
#: into its 64-bit column) and 5 doublings of odd limbs (ALU); a square 55
#: limb products and 10 doublings.  Either one's reduction: 9 wrapped
#: columns folded by 19 (a 64-bit multiply-add, 2 FMA each), a carry pass on
#: 64-bit limbs (8 ALU a limb: rounding add, shift, subtract, carry add,
#: each on two words) and one on 32-bit limbs (4 ALU a limb), each pass's
#: top carry folded by 19 (1 FMA): 120 ALU and 20 FMA.  An addition or
#: subtraction is 10 ALU.  So (ALU, FMA): a product (125, 120), a square
#: (130, 75), a point addition (1,215, 1,080), a doubling (1,080, 780).  A
#: point is 111 · 1,215 + 252 · 1,080 + 254 · 130 + 20 · 125 = 442,545 ALU
#: and 111 · 1,080 + 252 · 780 + 254 · 75 + 20 · 120 = 337,890 FMA; a batch
#: adds 252 · 1,080 − 1,215 = 270,945 ALU and 252 · 780 − 1,080 = 195,480
#: FMA.  At 1,033 points (a 1,024-signature chunk of eight keys and the
#: base point): 457.42 M ALU instructions, ~27.3 µs at 64 a clock per SM on
#: 132 SMs at 1,980 MHz.  The bound takes these alone: the count is the
#: reference's, whatever the design, so a rewrite that adds instructions
#: cannot loosen it.
ED_GATE_ADDS = sum(d != 0 for d in ED_Q_DIGITS)
ED_GATE_DOUBLES = 4 * max(w for w, d in enumerate(ED_Q_DIGITS) if d)
ED_OPS_PER_POINT = {"add": 14 + ED_GATE_ADDS + 64, "double": ED_GATE_DOUBLES, "square": 254, "product": 20}
ED_OPS_PER_BATCH = {"add": 63 - 64, "double": 4 * 63, "square": 0, "product": 0}
#: The least y < p that is no point's (x² = u/v has no root): an R that
#: passes the host's checks and that decompression rejects.
NOT_A_POINT_Y = 2
ED_OP_ALU_FMA = {"add": (1215, 1080), "double": (1080, 780), "square": (130, 75), "product": (125, 120)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (data sheet)
T0 = time.perf_counter()


def emit(obj: dict) -> None:
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 1)}), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip


PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


def adopt_orphans() -> None:
    """Make this process the reaper of its descendants' orphans, so that a
    grandchild whose parent died is still this process's to stop."""
    import ctypes

    if ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def stop_resource_tracker() -> None:
    """Stop and reap the process that ``multiprocessing``'s spawn context
    starts beside its first pool (phase 8, ``sig_verify.sign_many``).  It
    lives until its pipe from this process closes, so left alone it would
    outlive this script by the moment it takes to see the exit."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    with tracker._lock:
        if tracker._pid is not None:
            os.close(tracker._fd)  # the tracker's loop ends at end of file
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None


def child_pids() -> list[int]:
    """This process's children, adopted orphans included, from ``/proc``."""
    me, pids = os.getpid(), []
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            ppid = int(stat.read_text().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue  # gone meanwhile
        if ppid == me:
            pids.append(int(stat.parent.name))
    return pids


def stop_children() -> list[str]:
    """Kill and reap every child of this process; the command line of each
    that was still running (a zombie, already ended, is reaped unnamed)."""
    running = []
    for pid in child_pids():
        try:
            cmd = pathlib.Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")
            os.kill(pid, signal.SIGKILL)
        except OSError:
            cmd = ""
        with contextlib.suppress(ChildProcessError):
            os.waitpid(pid, 0)
        if cmd.strip():
            running.append(f"pid {pid}: {cmd.strip()}")
    return running


def prefix_for(seed: int, difficulty: int) -> bytes:
    from p1_tpu_torch.core import BlockHeader

    rng = random.Random(seed)
    return BlockHeader(
        1, rng.randbytes(32), rng.randbytes(32), 1735689700, difficulty, 0
    ).mining_prefix()


def arrays_for(prefix: bytes, difficulty: int, device: str):
    import numpy as np

    from p1_tpu_torch.core import target_from_difficulty, target_to_words
    from p1_tpu_torch.hashx.sha256_ref import header_midstate, header_tail_words
    from p1_tpu_torch.hashx.torch_backend import search_arrays

    return search_arrays(
        np.array(header_midstate(prefix), dtype=np.uint32),
        np.array(header_tail_words(prefix), dtype=np.uint32),
        np.array(target_to_words(target_from_difficulty(difficulty)), dtype=np.uint32),
        device,
    )


def plain_first_hit(arrays, base: int, batch: int) -> int:
    """The plain version over [base, base+batch) in PLAIN_CHUNK calls:
    earliest offset or ``batch``."""
    from p1_tpu_torch.hashx.torch_sha256 import search_step

    for off in range(0, batch, PLAIN_CHUNK):
        n = min(PLAIN_CHUNK, batch - off)
        idx = int(search_step(arrays.midstate, arrays.tail, arrays.target, base + off, n))
        if idx < n:
            return off + idx
    return batch


def calls_ms(fn, reps: int = 3) -> list[float]:
    """Milliseconds of each of ``reps`` calls of ``fn()`` on the card
    (events), after one untimed call."""
    fn()
    return [cuda_ms(fn, reps=1, warm=False) for _ in range(reps)]


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs (events),
    after one untimed run unless ``warm`` is false."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@dataclasses.dataclass(frozen=True)
class Rate:
    """An integer issue rate of the card: integer-ALU and all-instruction
    lanes per clock per SM, at an SM clock."""

    alu_per_clk: float
    issue_per_clk: float
    mhz: float

    def bound_ms(self, alu: float, insns: float, sms: int, fma: float = 0.0) -> float:
        """Least milliseconds for ``alu`` integer-ALU, ``fma`` FMA-pipe
        (``sass.FMA_PER_SM_CLK`` a clock) and ``insns`` instructions in all
        (thread-instructions) on ``sms`` SMs."""
        from p1_tpu_torch.hashx.sass import FMA_PER_SM_CLK

        hz = self.mhz * 1e6 * sms
        return 1e3 * max(
            alu / (self.alu_per_clk * hz), fma / (FMA_PER_SM_CLK * hz), insns / (self.issue_per_clk * hz)
        )


def ptxas_lines(log: str, function: str) -> list[str]:
    """The registers and spill lines of ``-Xptxas -v`` for the functions
    whose mangled name contains ``function``."""
    lines, current = [], ""
    for line in log.splitlines():
        for marker in ("Compiling entry function '", "Function properties for "):
            if marker in line:
                current = line.split(marker, 1)[1].split("'")[0]
        if function in current and ("spill" in line or "registers" in line):
            lines.append(line.strip())
    return lines


def phase_roofline(vr, sass, sms: int, white_paper: Rate) -> tuple[dict, Rate, Rate]:
    """Phase 5: the roofline kernel against its plain version, its build
    and SASS, then the entry point ``run_bench`` and every shape it
    launched against the plain version.  Returns the kernel's entry of the
    ``kernels`` line, the measured rate (the best row's, at its clock) and
    the peak rate (the larger of ``white_paper`` and the measured one, at
    the fastest clock either saw)."""
    import torch

    cases = max_err = 0
    for grid in (7, 132):  # 7: ragged, far from a whole wave
        for mix in vr.MIXES:
            for chains in (1, 4, 8):
                for iters in (16, 40):  # 40: not a multiple of 16
                    seeds = vr.seeds_for(chains, cases)
                    got = int(vr.roofline_step(seeds, grid, iters, chains, mix)[0])
                    want = int(vr.bench_step(seeds, grid, iters, chains, mix, "cuda")[0])
                    max_err = max(max_err, abs(got - want))
                    if got != want:
                        raise AssertionError(
                            f"int_roofline {got} != plain {want} ({mix}, chains {chains}, "
                            f"grid {grid}, iters {iters})"
                        )
                    cases += 1
    torch.cuda.synchronize()
    log = vr.int_roofline.built().ptxas_log
    instances = []
    for mix in vr.MIXES:
        for chains in (1, 4, 8):
            info = vr.int_roofline.info(mix, chains)
            lc = vr.loop_counts(mix, chains)
            name = f"int_roofline_kernelILi{vr.MIXES.index(mix)}ELi{chains}EE"
            instances.append({
                "mix": mix, "chains": chains, **dataclasses.asdict(info),
                "ptxas": ptxas_lines(log, name),
                "loop_insns": lc.insns, "loop_alu": lc.alu, "chain_iters_per_loop": lc.per_iter,
                "alu_per_iter": lc.alu_per_iter, "insns_per_iter": lc.insns_per_iter,
                "ref_ops_per_iter": vr.OPS_PER_ITER[mix],
                "opcodes": sass.opcode_histogram(vr.int_roofline.loop_insns(mix, chains)),
            })  # fmt: skip
    emit({"phase": "roofline_vs_plain", "cases": cases, "max_abs_err": max_err,
          "instances": instances})  # fmt: skip

    # The main path: the roofline entry point, launches counted.
    vr.int_roofline.launches = 0
    rows = vr.run_bench()
    launches = vr.int_roofline.launches
    if launches <= 0:
        raise AssertionError("run_bench launched the roofline kernel no time")
    best = max(rows, key=lambda r: r["alu_per_clk_sm"])
    measured = Rate(best["alu_per_clk_sm"], max(r["issue_per_clk_sm"] for r in rows), best["sm_mhz"])
    peak = Rate(
        max(white_paper.alu_per_clk, measured.alu_per_clk),
        max(white_paper.issue_per_clk, measured.issue_per_clk),
        max(white_paper.mhz, *(r["sm_mhz"] for r in rows)),
    )
    emit({"phase": "roofline", "launches": launches, "grid": vr.GRID, "rows": rows,
          "rate_from": f"{best['mix']}/{best['chains']}", "measured": dataclasses.asdict(measured),
          "white_paper": dataclasses.asdict(white_paper), "peak": dataclasses.asdict(peak)})  # fmt: skip

    # Every shape the main path launched, against the plain version on the
    # seeds of the row's last timed launch (whose cell the row holds).
    plain_ms = {}
    for r in rows:
        seeds = vr.seeds_for(r["chains"], vr.REPS)
        want = []
        key = f"{r['mix']}/{r['chains']}"
        plain_ms[key] = cuda_ms(
            lambda r=r, seeds=seeds, want=want: want.append(
                int(vr.bench_step(seeds, vr.GRID, r["iters"], r["chains"], r["mix"], "cuda")[0])
            ),
            reps=1, warm=False,
        )  # fmt: skip
        max_err = max(max_err, abs(r["out"] - want[0]))
        if r["out"] != want[0]:
            raise AssertionError(f"int_roofline {r['out']} != plain {want[0]} in run_bench's {key}")
    emit({"phase": "roofline_main_vs_plain", "cases": len(rows), "max_abs_err": max_err,
          "plain_ms": plain_ms})  # fmt: skip

    # The kernels-line entry: the SHA-round-like mix at 8 chains.
    row = next(r for r in rows if (r["mix"], r["chains"]) == ("round", 8))
    lc = vr.loop_counts("round", 8)
    passes = row["iters"] // vr.INNER * row["threads"] * vr.GRID
    return {
        "name": "int_roofline", "route": "cuda",
        "source": "p1_tpu_torch/benchmarks/csrc/int_roofline.cu",
        "replaces": "benchmarks/vpu_roofline.py:102",
        "launches": launches, "max_abs_err": max_err,
        "ms": row["ms"], "plain_ms": plain_ms["round/8"],
        "bound_ms": peak.bound_ms(passes * lc.alu, passes * lc.insns, sms),
        "bound_by": "operations", "library_ms": None,
        "bound_ms_white_paper": white_paper.bound_ms(passes * lc.alu, passes * lc.insns, sms),
        "shape": f"round mix, 8 chains, grid {vr.GRID}, iters {row['iters']}",
    }, measured, peak  # fmt: skip


def profiler_ms(fn, kernel: str, reps: int = 50) -> float | None:
    """Mean device milliseconds per launch of the CUDA kernel whose name
    contains ``kernel`` over ``reps`` eager calls of ``fn``, from
    ``torch.profiler``; None where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for event in prof.key_averages():
        device_us = getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0)
        if kernel in event.key and device_us and event.count == reps:
            return device_us / reps / 1e3
    return None


def verify_both(cuda_verify, words, segment: int, difficulty: int) -> int:
    """The first-invalid index of ``words`` on the card, after checking that
    the kernel over the padded chain equals the plain
    ``verify_header_chain_segments`` over its segments, and that the kernel
    over the unpadded chain (as ``replay_device`` launches it) equals that
    answer clamped to the chain's length."""
    import numpy as np
    import torch

    from p1_tpu_torch.chain import pad_to_segments
    from p1_tpu_torch.core import target_from_difficulty, target_to_words

    target = target_to_words(target_from_difficulty(difficulty))
    words3 = pad_to_segments(words, segment)
    padded = cuda_verify.first_invalid(torch.from_numpy(words3.view(np.int32)).cuda(), target, difficulty)
    want = cuda_verify.plain_first_invalid(
        torch.from_numpy(words3.astype(np.int64)).cuda(), target, difficulty
    )
    flat = cuda_verify.first_invalid(torch.from_numpy(words.view(np.int32)).cuda(), target, difficulty)
    if padded != want or flat != min(want, len(words)):
        raise AssertionError(f"verify_chain padded {padded}, unpadded {flat}; plain {want}")
    return want


#: verify_chain's work per header, pinned at the kernel with fully unrolled
#: compressions that came before the rolled one (its static SASS is one
#: header's): 4,165 instructions, 3,714 on the integer-ALU pipe, counted on
#: an H100 (PERF.md).  The bound counts the three compressions, not a
#: design's loop overhead or handoffs; a design that needs fewer
#: instructions per header lowers it.
VERIFY_INSNS_PER_HEADER = 4165
VERIFY_ALU_PER_HEADER = 3714


def phase_replay(cuda_verify, sass, sms: int, peak: Rate, white_paper: Rate) -> tuple[dict, int]:
    """Phase 6: the verify kernel against the plain version, the
    ``replay`` command at BASELINE config 3, corruptions, timings.  Returns
    the kernel's entry of the ``kernels`` line and the search kernel's
    launches in the replay run."""
    import numpy as np
    import torch

    from p1_tpu_torch import cli
    from p1_tpu_torch.benchmarks.verify_time import d0_chain_words, time_launch
    from p1_tpu_torch.chain import (
        generate_headers,
        headers_to_words,
        pad_to_segments,
        parse_headers,
        replay_device,
        replay_host,
    )
    from p1_tpu_torch.core import target_from_difficulty, target_to_words
    from p1_tpu_torch.hashx import cuda_backend, get_backend

    # The kernel vs the plain version on seeded fixtures.
    rng = np.random.default_rng(6)
    fixtures = []  # (name, words, segment, difficulty, expected or None)
    d0 = d0_chain_words(REPLAY_N)
    d3k = d0[:3000]
    fixtures.append(("d0 clean", d3k, 1024, 0, 3000))
    for name, (i, word, xor) in {
        "d0 nonce flip": (int(rng.integers(1, 2999)), 19, 1),  # breaks the next link
        "d0 difficulty word": (int(rng.integers(1, 3000)), 18, 1),
        "d0 prev-hash word": (int(rng.integers(1, 3000)), 1 + int(rng.integers(0, 8)), 1 << 31),
        "d0 genesis prev-hash": (0, 3, 5),
        "d0 last nonce": (2999, 19, 1),  # no next header: still valid
    }.items():
        w = d3k.copy()
        w[i, word] ^= xor
        expect = {"d0 nonce flip": i + 1, "d0 last nonce": 3000}.get(name, i)
        fixtures.append((name, w, 1024, 0, expect))
    # Where a warp (32 headers) or a block (64) ends: the link to the next
    # one's first header.
    for i in (31, 32, 63, 64, 127, 128):
        w = d3k.copy()
        w[i, 19] ^= 1
        fixtures.append((f"d0 nonce flip {i}", w, 1024, 0, i + 1))
    for i in (32, 64):
        w = d3k.copy()
        w[i, 8] ^= 1
        fixtures.append((f"d0 prev-hash word {i}", w, 1024, 0, i))
    for n in (1, 31, 32, 33, REPLAY_N):
        fixtures.append((f"d0 chain of {n}", d0[:n], 1024, 0, n))
        if n > 1:  # the chain's last link
            w = d0[:n].copy()
            w[n - 2, 19] ^= 1
            fixtures.append((f"d0 chain of {n}, last link", w, 1024, 0, n - 1))
    mined = headers_to_words(generate_headers(256, 8, backend=get_backend("cuda")))
    for segment in (64, 100):
        fixtures.append((f"d8 clean /{segment}", mined, segment, 8, 256))
        w = mined.copy()
        w[100, 19] ^= 1
        fixtures.append((f"d8 nonce flip /{segment}", w, segment, 8, None))
        w = mined.copy()
        w[50, 18] = 9
        fixtures.append((f"d8 difficulty word /{segment}", w, segment, 8, 50))
    noise = rng.integers(0, 1 << 32, size=(1000, 20), dtype=np.uint64).astype(np.uint32)
    fixtures.append(("random words", noise, 256, 16, 0))
    fixtures.append(("genesis only", d0[:1], 1, 0, 1))
    results = {}
    for name, words, segment, difficulty, expect in fixtures:
        got = verify_both(cuda_verify, words, segment, difficulty)
        if expect is not None and got != expect:
            raise AssertionError(f"verify_chain {name}: {got}, expected {expect}")
        results[name] = got
    torch.cuda.synchronize()
    vk = cuda_verify.verify_chain
    text = sass.disassemble(vk.built().path)
    # Rounds 16..63 of each compression run as 3 passes of 16: every loop
    # of the kernel runs 3 times per header.
    own = sass.per_item_counts(sass.function_insns(text, "verify_chain_kernel"), 3)
    emit({"phase": "verify_vs_plain", "cases": len(fixtures), "max_abs_err": 0,
          "first_invalid": results, "registers_local_bytes": vk.attributes(),
          "ptxas": ptxas_lines(vk.built().ptxas_log, "verify_chain_kernel"),
          "per_header_insns_alu": own,
          "pinned_per_header_insns_alu": [VERIFY_INSNS_PER_HEADER, VERIFY_ALU_PER_HEADER]})  # fmt: skip

    # The main path: ``replay`` at BASELINE config 3, launches counted.
    search = cuda_backend.sha256d_search
    search.launches = vk.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out_file = pathlib.Path(tmp) / "headers.bin"
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["replay", "--n", str(REPLAY_N), "--difficulty", str(REPLAY_DIFFICULTY),
                           "--method", "both", "--out", str(out_file)])  # fmt: skip
        cli_s = time.perf_counter() - t0
        search_launches, verify_launches = search.launches, vk.launches
        line = json.loads(stdout.getvalue().strip().splitlines()[-1])
        headers = parse_headers(out_file.read_bytes())
    if rc != 0 or not line["valid"] or [r["method"] for r in line["results"]] != ["host", "device", "device"]:
        raise AssertionError(f"replay run failed (exit {rc}): {line}")
    if search_launches <= 0 or verify_launches <= 0:
        raise AssertionError(f"replay launched search {search_launches}, verify {verify_launches} times")
    emit({"phase": "replay", **line, "exit": rc, "wall_s": cli_s,
          "launches": {"sha256d_search": search_launches, "verify_chain": verify_launches},
          "verify_grid": [cuda_verify.blocks_for(REPLAY_N), cuda_verify.THREADS]})  # fmt: skip

    # Corruptions of header i: host oracle and device kernel must name i.
    flagged = {}
    for name, i, bad in replay_corruptions(headers):
        host, device = replay_host(bad), replay_device(bad)
        if not host.first_invalid == device.first_invalid == i:
            raise AssertionError(f"{name}: host {host.first_invalid}, device {device.first_invalid}")
        flagged[name] = device.first_invalid
    emit({"phase": "replay_corruptions", "first_invalid": flagged})

    # The kernel against the plain version on the chain the main path
    # verified: the kernel over its 10,000 headers as ``replay_device``
    # launches it, the plain version over its segments of 8,192.
    target = target_to_words(target_from_difficulty(REPLAY_DIFFICULTY))
    words = headers_to_words(headers)
    w3 = torch.from_numpy(pad_to_segments(words, 8192).astype(np.int64)).cuda()
    plain = []
    plain_ms = cuda_ms(
        lambda: plain.append(cuda_verify.plain_first_invalid(w3, target, REPLAY_DIFFICULTY)), reps=2
    )
    got = cuda_verify.first_invalid(torch.from_numpy(words.view(np.int32)).cuda(), target, REPLAY_DIFFICULTY)
    if got != REPLAY_N or any(p != REPLAY_N for p in plain):
        raise AssertionError(f"10k chain: kernel {got}, plain {plain}, expected {REPLAY_N}")

    # Timings at 10,000 and 2**20 headers (a tiled chain: every header is
    # hashed whatever the result): device time from a CUDA graph of 50
    # launches, the profiler's kernel time, and the host loop of 50 calls
    # through the wrapper (``ms_enqueue``), which at 10,000 times the
    # host's enqueue.
    mhz = peak.mhz
    insns = min(VERIFY_INSNS_PER_HEADER, own[0])
    alu = min(VERIFY_ALU_PER_HEADER, own[1])
    timing = {}
    for label, n in (("10k", REPLAY_N), ("2p20", 1 << 20)):
        w = torch.from_numpy(np.resize(words, (n, 20)).view(np.int32)).cuda()
        cell = torch.full((1,), n, dtype=torch.int32, device="cuda")
        row = {"n": n, "blocks": cuda_verify.blocks_for(n), "threads": cuda_verify.THREADS,
               **time_launch(lambda w=w, cell=cell: vk(w, target, REPLAY_DIFFICULTY, cell))}  # fmt: skip
        row["ms_profiler"] = profiler_ms(
            lambda w=w, cell=cell: vk(w, target, REPLAY_DIFFICULTY, cell), "verify_chain_kernel"
        )
        bytes_ms = 1e3 * 80 * n / HBM_BYTES_PER_S
        ops_ms = peak.bound_ms(n * alu, n * insns, sms)
        row.update({
            "headers_per_s": n / row["ms"] * 1e3,
            "bound_ms": max(ops_ms, bytes_ms), "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms_white_paper": white_paper.bound_ms(n * alu, n * insns, sms),
            # One warp's issue floor: a thread's ALU instructions, one
            # every second clock, on the warp's one scheduler.
            "issue_floor_ms": 2 * own[1] / (mhz * 1e3),
        })  # fmt: skip
        timing[label] = row
    tiled = parse_headers(np.resize(words, (1 << 20, 20)).astype(">u4").tobytes())
    e2e_2p20 = [replay_device(tiled) for _ in range(3)]
    emit({"phase": "replay_timing", "kernel": timing, "plain_ms_10k": plain_ms, "sm_mhz": mhz,
          "replay_device_2p20_s": [r.elapsed_s for r in e2e_2p20],
          "replay_device_2p20_headers_per_s": [r.headers_per_sec for r in e2e_2p20]})  # fmt: skip
    t10k, t2p20 = timing["10k"], timing["2p20"]
    return {
        "name": "verify_chain", "route": "cuda",
        "source": "p1_tpu_torch/hashx/csrc/verify_chain.cu",
        "replaces": "p1_tpu/hashx/jax_sha256.py:230", "replaces_kind": "XLA program, not Pallas",
        "launches": verify_launches, "max_abs_err": 0,
        "ms": t10k["ms"], "plain_ms": plain_ms, "bound_ms": t10k["bound_ms"],
        "bound_by": "operations" if t10k["ops_bound_ms"] >= t10k["bytes_bound_ms"] else "bytes",
        "library_ms": None,
        "ms_enqueue": t10k["ms_enqueue"], "ms_profiler": t10k["ms_profiler"],
        "issue_floor_ms": t10k["issue_floor_ms"],
        "bound_ms_white_paper": max(t10k["ops_bound_ms_white_paper"], t10k["bytes_bound_ms"]),
        "ms_2p20": t2p20["ms"], "bound_ms_2p20": t2p20["bound_ms"],
    }, search_launches  # fmt: skip


def replay_corruptions(headers) -> list[tuple[str, int, list]]:
    """Phase 6's corruptions of the 10,000-header chain: (name, the index
    every engine must name, the corrupted chain).  The re-parented header
    is re-mined on the card."""
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    miner = Miner(backend=get_backend("cuda"))

    def flip(h):
        return h.with_nonce(h.nonce ^ 1)

    def reparent(h):  # re-mined onto its grandparent
        return miner.search_nonce(dataclasses.replace(h.with_nonce(0), prev_hash=headers[698].block_hash()))

    corruptions = [
        ("nonce 37", 37, flip), ("nonce 8191", 8191, flip), ("nonce 8192", 8192, flip),
        ("difficulty 5000", 5000, lambda h: dataclasses.replace(h, difficulty=17)),
        ("re-parent 700", 700, reparent),
        ("genesis prev-hash", 0, lambda h: dataclasses.replace(h, prev_hash=b"\x01" + bytes(31))),
    ]  # fmt: skip
    out = []
    for name, i, corrupt in corruptions:
        bad = list(headers)
        bad[i] = corrupt(bad[i])
        out.append((name, i, bad))
    return out


def compressed(m, e, limbs) -> "np.ndarray":
    """The canonical 32-byte encodings of (N, 4, 10) limbs, (N, 32) uint8."""
    import numpy as np

    rows = limbs.cpu().numpy().reshape(-1, 4 * m.FE_LIMBS)
    raw = b"".join(e._pt_compress(m.decode_point(r)) for r in rows)
    return np.frombuffer(raw, dtype=np.uint8).reshape(-1, 32).astype(np.int64)


def decode_gate_msm_vs_plain(ce, m, e, encodings, scalars) -> tuple[int, bool, object]:
    """The kernels against the plain version and the big-integer oracle on
    the same card tensors: the largest difference between the decoded
    limbs, the flags, the all-ok flags and the canonical encodings of the
    sums; whether the decoded limbs equal ``_pt_decompress``'s (the
    identity's where it returns None), the decode bits its verdicts, the
    gate bits ``_in_prime_subgroup``'s and the sum the big-integer Σ; the
    kernels' output."""
    import torch

    got = ce.decode_gate_msm(encodings, scalars)
    want = ce.plain_decode_gate_msm(encodings, scalars)
    torch.cuda.synchronize()
    err = max(
        int((got.decoded - want.decoded).abs().max()),
        int((got.flags - want.flags).abs().max()),
        abs(int(got.result[0]) - int(want.result[0])),
        int(abs(compressed(m, e, got.result[1:]) - compressed(m, e, want.result[1:])).max()),
    )
    raws = [bytes(r) for r in encodings.cpu().numpy().view("uint8").reshape(-1, 32)]
    words = scalars.cpu().numpy().view("<u4")
    flags = got.flags.tolist()
    total, oracle = e._IDENT, True
    for i, raw in enumerate(raws):
        pt = e._pt_decompress(raw)
        want_limbs = m.encode_points([pt if pt is not None else e._IDENT])[0]
        oracle &= got.decoded[i].cpu().numpy().tolist() == want_limbs.tolist()
        oracle &= bool(flags[i] & 1) is (pt is not None)
        if pt is not None:
            oracle &= bool(flags[i] & 2) is e._in_prime_subgroup(pt)
            total = e._pt_add(total, e._pt_mul(int.from_bytes(words[i].tobytes(), "little"), pt))
    oracle &= e._pt_equal(m.decode_point(got.result[1:].cpu()), total)
    return err, oracle, got


def phase_ed25519(sass, sms: int, peak: Rate) -> dict:
    """Phases 7-9: the Ed25519 kernels against the plain version on
    crafted, small-order and random fixtures and at the 1,024-signature
    shape; ``verify_batch_device`` verdicts and timings; the main path,
    ``check_block`` on a full block and ``preverify_signatures`` on a
    4,096-signature window under the ``device`` rung.  Returns the
    kernel's entry of the ``kernels`` line and the 1,024 triples."""
    import concurrent.futures
    import multiprocessing

    import numpy as np
    import torch

    from p1_tpu_torch.benchmarks import sig_verify as sv
    from p1_tpu_torch.benchmarks.verify_time import graph_ms
    from p1_tpu_torch.chain import ValidationError, check_block, preverify_signatures
    from p1_tpu_torch.core import Block, BlockHeader, Transaction, genesis_hash, make_genesis, merkle_root
    from p1_tpu_torch.core import _ed25519 as e
    from p1_tpu_torch.core import keys
    from p1_tpu_torch.core.sigcache import SignatureCache
    from p1_tpu_torch.hashx import cuda_ed25519 as ce
    from p1_tpu_torch.hashx import ed25519_msm as m
    from p1_tpu_torch.hashx import get_backend
    from p1_tpu_torch.miner import Miner

    kernel = ce.ed25519_msm
    t0 = time.perf_counter()
    # 4,096 transfers from the bench's eight keys, signed in worker processes.
    tag = genesis_hash(SIG_DIFFICULTY)
    pubs = [e.public_key(seed) for seed in sv.SEEDS]
    unsigned = [Transaction(keys.account_id(pubs[i % 8]), f"smoke-r{i % 13}", 1 + i % 7, 1, i // 8, chain=tag)
                for i in range(PREVERIFY_N)]  # fmt: skip
    sigs = sv.sign_many((sv.SEEDS[i % 8], tx.signing_bytes()) for i, tx in enumerate(unsigned))
    txs = [dataclasses.replace(tx, pubkey=pubs[i % 8], sig=sig) for i, (tx, sig) in enumerate(zip(unsigned, sigs))]
    triples = [(tx.pubkey, tx.sig, tx.signing_bytes()) for tx in txs]
    fixtures_s = time.perf_counter() - t0

    # -- 7. the kernels vs the plain version --------------------------------
    rng = random.Random(25519)
    t2, t4, t8 = (e._pt_decompress(enc) for enc in (sv.T2_ENC, sv.T4_ENC, sv.T8_ENC))
    subgroup = [e._pt_mul(rng.randrange(1, e._Q), e._B) for _ in range(6)]
    named = {**{f"random {i}": p for i, p in enumerate(subgroup)}, "identity": e._IDENT,
             "order 2": t2, "order 4": t4, "order 8": t8,
             "random + order 8": e._pt_add(subgroup[0], t8), "random + order 4": e._pt_add(subgroup[1], t4)}  # fmt: skip
    scalars = {"0": 0, "1": 1, "q-1": e._Q - 1, "128-bit": rng.getrandbits(128), "253-bit": rng.getrandbits(253)}
    crafted = {"y=0": 0, "y=0 sign": 1 << 255, "y=1 sign": 1 | 1 << 255, "y=p-1": e._P - 1,
               "y=p-1 sign": e._P - 1 | 1 << 255, "non-square y=2": 2, "y=p": e._P, "y=2^255-1": (1 << 255) - 1,
               **{f"random bytes {i}": rng.getrandbits(256) for i in range(4)}}  # fmt: skip
    pairs = [(e._pt_compress(p), s) for p in named.values() for s in scalars.values()]
    pairs += [(y.to_bytes(32, "little"), rng.getrandbits(253)) for y in crafted.values()]
    enc_t = torch.from_numpy(m.encode_encodings([r for r, _ in pairs]).view(np.int32)).cuda()
    scalars_t = torch.from_numpy(m.encode_scalars([s for _, s in pairs]).view(np.int32)).cuda()
    max_err, oracle_ok, got = decode_gate_msm_vs_plain(ce, m, e, enc_t, scalars_t)
    if max_err or not oracle_ok:
        raise AssertionError(f"ed25519 kernel vs plain: max_abs_err {max_err}, oracle {oracle_ok}")
    # The main path's shape: the 1,024-signature batch as verify_batch_device
    # launches it (coefficients from a seed, so both see the same scalars).
    prep = m.prepare(triples[:SIG_BATCH], random.Random(1024))
    enc_1k, scalars_1k = m.to_device(prep, torch.device("cuda"))
    err_1k, oracle_1k, got_1k = decode_gate_msm_vs_plain(ce, m, e, enc_1k, scalars_1k)
    if err_1k or not oracle_1k or int(got_1k.result[0]) != 1:
        raise AssertionError(f"ed25519 kernel vs plain at {SIG_BATCH} signatures: max_abs_err {err_1k}, "
                             f"oracle {oracle_1k}, all-ok {int(got_1k.result[0])}")  # fmt: skip
    plain_calls = calls_ms(lambda: ce.plain_decode_gate_msm(enc_1k, scalars_1k))
    plain_ms = statistics.median(plain_calls)
    log = kernel.built().ptxas_log
    attrs = {name: kernel.attributes(i) for i, name in enumerate(kernel.KERNELS)}
    emit({"phase": "ed25519_kernel_vs_plain", "cases": len(pairs), "points": list(named), "crafted": list(crafted),
          "scalars": list(scalars), "max_abs_err": max_err, "decoded_limbs_equal": True, "oracle": True,
          "flags": got.flags.tolist(), "batch_points": int(enc_1k.shape[0]), "batch_blocks": ce.blocks_for(int(enc_1k.shape[0])),
          "threads": ce.THREADS, "attributes": attrs,
          "ptxas": ptxas_lines(log, "decode_gate_msm_kernel") + ptxas_lines(log, "point_sum_kernel"),
          "plain_ms_1024": plain_ms, "plain_ms_1024_calls": plain_calls, "fixtures_s": fixtures_s})  # fmt: skip

    # -- 8. verify_batch_device: verdicts, timings --------------------------
    batch = triples[:SIG_BATCH]

    def corrupt(tr, pos):
        out = list(tr)
        pub, sig, msg = out[pos]
        out[pos] = (pub, sig[:20] + bytes([sig[20] ^ 1]) + sig[21:], msg)
        return out

    def swap(tr, pos, triple):
        out = list(tr)
        out[pos] = triple
        return out

    cases = {
        "valid": (batch, True),
        **{f"bad sig {pos}": (corrupt(batch, pos), False) for pos in (0, SIG_BATCH // 2 - 1, SIG_BATCH - 1)},
        f"torsion cancel {SIG_BATCH * 2 // 3}": (
            swap(batch, SIG_BATCH * 2 // 3, sv.torsion_triple(cancel=True)), False),
        f"torsion reject {SIG_BATCH // 3}": (swap(batch, SIG_BATCH // 3, sv.torsion_triple(cancel=False)), False),
        # An R with y < p that is no point: it passes the host's checks and
        # the card's decompression rejects it.
        f"undecodable R {SIG_BATCH // 4}": (swap(batch, SIG_BATCH // 4, (
            batch[SIG_BATCH // 4][0], NOT_A_POINT_Y.to_bytes(32, "little") + batch[SIG_BATCH // 4][1][32:],
            batch[SIG_BATCH // 4][2])), False),
    }
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(cases), mp_context=ctx) as ex:
        host = dict(zip(cases, ex.map(e.verify_batch, [tr for tr, _ in cases.values()])))
    verdicts, case_launches = {}, {}
    for name, (tr, want) in cases.items():
        before = kernel.launches
        verdicts[name] = m.verify_batch_device(tr)
        case_launches[name] = kernel.launches - before
        if not verdicts[name] == host[name] == want or case_launches[name] != 1:
            raise AssertionError(f"verify_batch_device {name}: device {verdicts[name]}, host {host[name]}, "
                                 f"{case_launches[name]} launches")  # fmt: skip
    before = kernel.launches
    malformed = swap(batch, 7, (batch[7][0][:31], batch[7][1], batch[7][2]))
    if m.verify_batch_device(malformed) is not False or kernel.launches != before:
        raise AssertionError("a malformed batch reached the card")
    rows = [sv.device_split(triples[:n]) for n in (64, 256, SIG_BATCH, PREVERIFY_N)]
    out, partials = ce.outputs_for(enc_1k)
    kernel_ms = graph_ms(lambda: kernel(enc_1k, scalars_1k, out.decoded, out.flags, partials, out.result))
    # Where block 0's time goes, by the SM clock: each phase's cycles, and
    # per dependent point operation (four lanes) or field operation (one).
    clocks = torch.zeros(len(ce.PHASES), dtype=torch.int64, device="cuda")
    kernel(enc_1k, scalars_1k, out.decoded, out.flags, partials, out.result, clocks)
    at = dict(zip(ce.PHASES, clocks.tolist()))
    phase_cycles = {
        "decompression": at["decoded"] - at["start"], "tables": at["tables"] - at["decoded"],
        "gate": at["gate"] - at["tables"], "window_sums": at["window_sums"] - at["tables"],
        "horner_high": at["horner_high"] - at["window_sums"], "accumulator": at["accumulator"] - at["start"],
    }
    per_op_cycles = {
        "decompression_field_op": phase_cycles["decompression"] / (ED_OPS_PER_POINT["square"] + ED_OPS_PER_POINT["product"]),
        "gate_point_op": phase_cycles["gate"] / (ED_GATE_DOUBLES + ED_GATE_ADDS),
        "horner_point_op": phase_cycles["horner_high"] / (31 * 4 + 32 + 128),
    }  # fmt: skip
    emit({"phase": "sig_verify", "verdicts": verdicts, "host_verdicts": host, "case_launches": case_launches,
          "malformed": False, "malformed_launches": 0, "rows": rows,
          "kernel_ms_1024": kernel_ms, "graph_launches": 50, "phase_cycles_block0": phase_cycles,
          "cycles_per_op": per_op_cycles})  # fmt: skip

    # -- 9. the main path: check_block and preverify_signatures -------------
    miner = Miner(backend=get_backend("cuda"))
    parent = make_genesis(SIG_DIFFICULTY)

    def block_of(body_txs):
        body = (Transaction.coinbase("smoke-miner", 1), *body_txs)
        header = BlockHeader(1, parent.block_hash(), merkle_root([t.txid() for t in body]),
                             parent.header.timestamp + 60, SIG_DIFFICULTY, 0)  # fmt: skip
        return Block(miner.search_nonce(header), body)

    good = block_of(txs[: BLOCK_TXS - 1])
    bad_txs = list(txs[: BLOCK_TXS - 1])
    bad_at = BLOCK_TXS // 2
    bad_txs[bad_at] = dataclasses.replace(bad_txs[bad_at], sig=corrupt([triples[bad_at]], 0)[0][1])
    bad = block_of(bad_txs)
    keys.set_sig_backend(None)  # the default rung: the card's
    if keys.backend() != "device":
        raise AssertionError(f"the default signature rung is {keys.backend()!r}, not 'device'")
    try:
        keys.STATS.reset()
        kernel.launches = 0
        t1 = time.perf_counter()
        check_block(good, SIG_DIFFICULTY, sig_cache=SignatureCache())
        block_s = time.perf_counter() - t1
        block_launches, device_sigs = kernel.launches, keys.STATS.backends["device"]
        t1 = time.perf_counter()
        proven = preverify_signatures(txs, tag, SignatureCache())
        preverify_s = time.perf_counter() - t1
        launches = kernel.launches
        want_launches = 1 + PREVERIFY_N // keys.BATCH_CHUNK
        if (device_sigs, block_launches, proven, launches) != (BLOCK_TXS - 1, 1, PREVERIFY_N, want_launches):
            raise AssertionError(f"check_block: {device_sigs} device signatures, {block_launches} launches; "
                                 f"preverify: {proven} proven, {launches - block_launches} launches")  # fmt: skip
        t1 = time.perf_counter()
        try:
            check_block(bad, SIG_DIFFICULTY, sig_cache=SignatureCache())
            raise AssertionError("a block with a bad signature passed check_block")
        except ValidationError as exc:
            if str(exc) != "bad transaction signature":
                raise
            bad_error = str(exc)
        bad_s = time.perf_counter() - t1
    finally:
        keys.set_sig_backend(None)
    emit({"phase": "check_block", "txs": len(good.txs), "device_signatures": device_sigs,
          "launches": {"check_block": block_launches, "preverify": launches - block_launches},
          "check_block_s": block_s, "preverify_proven": proven, "preverify_s": preverify_s,
          "bad_block_error": bad_error, "bad_block_s": bad_s})  # fmt: skip

    # The bound: the reference's operations on this run's points, at the
    # pinned cost per operation (ED_OP_ALU_FMA).
    points = int(enc_1k.shape[0])
    insns = sass.function_insns(sass.disassemble(kernel.built().path), "decode_gate_msm_kernel")
    alu, fma = ed25519_work(points, ED_OP_ALU_FMA)
    ops_ms = peak.bound_ms(alu, alu + fma, sms, fma=fma)
    bytes_ms = 1e3 * (points * (32 + 32 + 4 * 40 + 4) + 4 * ce.RESULT_LEN) / HBM_BYTES_PER_S
    return {
        "name": "ed25519_msm", "route": "cuda",
        "source": "p1_tpu_torch/hashx/csrc/ed25519_msm.cu",
        "replaces": "p1_tpu/hashx/ed25519_msm.py:361", "replaces_kind": "XLA program, not Pallas",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
        "shape": f"{SIG_BATCH} signatures, {points} points, {ce.blocks_for(points)} blocks of {ce.THREADS}",
        "bound_alu_fma": [alu, fma], "pinned_per_op_alu_fma": ED_OP_ALU_FMA,
        "pinned_ops_per_point": ED_OPS_PER_POINT, "pinned_ops_per_batch": ED_OPS_PER_BATCH,
        "sass_insns_alu_fma": [len(insns), sum(sass.is_alu(i.opcode) for i in insns),
                               sum(sass.is_fma(i.opcode) for i in insns)],
        "attributes": attrs,
        "us_per_sig_1024": next(r["us_per_sig"] for r in rows if r["n"] == SIG_BATCH),
    }, batch  # fmt: skip


def phase_revalidate(kernel) -> dict:
    """Phase 10: the untrusted load of a chain store on the default
    signature rung, its launches counted around the loads only (the
    build's ``add_block`` calls launch too).  Returns the phase's counts
    and times for the ``kernels`` line."""
    import struct
    import zlib

    from p1_tpu_torch import cli
    from p1_tpu_torch.benchmarks.host_ingest import build_blocks
    from p1_tpu_torch.chain import ChainStore, save_chain
    from p1_tpu_torch.chain import store as store_mod
    from p1_tpu_torch.core import keys, sigcache
    from p1_tpu_torch.core.sigcache import SignatureCache

    keys.set_sig_backend(None)  # the default rung: the card's
    t0 = time.perf_counter()
    built, _ = build_blocks(REVAL_BLOCKS, REVAL_TXS, difficulty=1)
    build_s = time.perf_counter() - t0
    signatures = (REVAL_BLOCKS - 1) * REVAL_TXS
    accounts = sorted({a for b in built.main_chain() for t in b.txs for a in (t.sender, t.recipient)})

    def state(chain):
        return (chain.tip_hash, chain.height, chain.balances_snapshot(), [chain.nonce(a) for a in accounts])

    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "revalidate.chain"
        save_chain(built, path)

        def load(**kwargs):
            store = ChainStore(path)
            try:
                t1 = time.perf_counter()
                chain = store.load_chain(1, **kwargs)
                return chain, time.perf_counter() - t1
            finally:
                store.close()

        cache = SignatureCache()
        keys.STATS.reset()
        kernel.launches = 0
        untrusted, untrusted_s = load(trusted=False, sig_cache=cache)
        launches, device_sigs = kernel.launches, keys.STATS.backends["device"]
        want_launches = -(-PREVERIFY_N // keys.BATCH_CHUNK) + 1
        if (launches, device_sigs) != (want_launches, signatures):
            raise AssertionError(f"untrusted load: {launches} launches, {device_sigs} device signatures; "
                                 f"want {want_launches} and {signatures}")  # fmt: skip
        # Two more of each load for the times (median of three).
        untrusted_runs = [untrusted_s] + [load(trusted=False, sig_cache=SignatureCache())[1] for _ in range(2)]
        kernel.launches = 0
        warm, _ = load(trusted=False, sig_cache=cache)
        warm_runs = [load(trusted=False, sig_cache=cache)[1] for _ in range(3)]
        warm_launches = kernel.launches
        trusted, _ = load(trusted=True)
        trusted_runs = [load(trusted=True)[1] for _ in range(3)]
        if warm_launches or not state(untrusted) == state(warm) == state(trusted) == state(built):
            raise AssertionError(f"loads disagree with the built chain (warm loads launched {warm_launches})")
        untrusted_s = statistics.median(untrusted_runs)

        # The balances command: in this process through cli.main, with the
        # process's cache emptied as a new process starts, so its launches
        # count; then as a new process.
        old_default = sigcache.DEFAULT
        sigcache.DEFAULT = SignatureCache()
        out = io.StringIO()
        kernel.launches = 0
        try:
            with contextlib.redirect_stdout(out):
                rc = cli.main(["balances", "--store", str(path)])
        finally:
            sigcache.DEFAULT = old_default
            keys.set_sig_backend(None)
        cli_launches = kernel.launches
        report = json.loads(out.getvalue().strip().splitlines()[-1])
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "p1_tpu_torch", "balances", "--store", str(path)],
                              capture_output=True, text=True, timeout=300)  # fmt: skip
        cli_process_s = time.perf_counter() - t1
        if proc.returncode != 0:
            raise AssertionError(f"balances exited {proc.returncode}: {proc.stderr[-2000:]}")
        want_report = {"config": "balances", "height": built.height, "conserved": True,
                       "balances": dict(sorted(built.balances_snapshot().items()))}  # fmt: skip
        if (rc, cli_launches, report) != (0, want_launches, want_report) or json.loads(proc.stdout) != report:
            raise AssertionError(f"balances: exit {rc}, {cli_launches} launches, {report}, {proc.stdout!r}")

        # A hostile editor: one signature flipped in the record at height
        # TAMPER_HEIGHT, the record's CRC fixed so that validation, not the
        # storage layer, must catch it.
        raw = bytearray(path.read_bytes())
        off, length = ChainStore.scan(bytes(raw)).spans[TAMPER_HEIGHT]
        victim = built.get(built.main_hash_at(TAMPER_HEIGHT))
        raw[raw.find(victim.txs[1].sig, off)] ^= 1
        struct.pack_into(">I", raw, off + length, zlib.crc32(raw[off - 4 : off + length]))
        path.write_bytes(bytes(raw))
        kernel.launches = 0
        tampered, tampered_s = load(trusted=False, sig_cache=SignatureCache())
        tampered_launches = kernel.launches
        old = keys.BATCH_MIN, store_mod._preverify_stream
        keys.BATCH_MIN, store_mod._preverify_stream = 1 << 30, lambda blocks, tag, cache: blocks
        try:  # the serial lane: every transfer verified alone, on the serial (native) rung
            serial, serial_s = load(trusted=False, sig_cache=SignatureCache())
        finally:
            keys.BATCH_MIN, store_mod._preverify_stream = old
        if not tampered.height == serial.height == TAMPER_HEIGHT - 1:
            raise AssertionError(f"tampered store: device lane stops at {tampered.height}, serial at {serial.height}")
    line = {"blocks": REVAL_BLOCKS, "signatures": signatures, "launches": launches,
            "device_signatures": device_sigs, "build_s": build_s, "untrusted_s": untrusted_s,
            "untrusted_runs_s": untrusted_runs, "blocks_per_s": REVAL_BLOCKS / untrusted_s,
            "us_per_sig": 1e6 * untrusted_s / signatures, "warm_cache_s": statistics.median(warm_runs),
            "warm_cache_runs_s": warm_runs, "trusted_s": statistics.median(trusted_runs),
            "trusted_runs_s": trusted_runs, "cli_balances_launches": cli_launches,
            "cli_process_s": cli_process_s, "tampered_height": tampered.height,
            "tampered_launches": tampered_launches, "tampered_s": tampered_s,
            "serial_height": serial.height, "serial_s": serial_s}  # fmt: skip
    emit({"phase": "revalidate", **line})
    return line, built


# -- phases 11 and 12: node processes -----------------------------------------


def spawn_node(args: list[str], log: pathlib.Path, device: str, children: list) -> subprocess.Popen:
    """``python -m p1_tpu_torch node --device DEVICE ARGS``, its log (stderr)
    to ``log`` (a mining node logs a line or two per block), added to
    ``children`` so that the phase stops it whatever happens."""
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "p1_tpu_torch", "node", "--device", device, *args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=fh, text=True, cwd=ROOT,
        )  # fmt: skip
    children.append(proc)
    return proc


@contextlib.contextmanager
def stopped_at_exit(children: list):
    """Kill and reap every child still running when the block exits."""
    try:
        yield children
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def read_line(proc: subprocess.Popen, timeout: float = CHILD_TIMEOUT_S) -> str:
    """The child's next stdout line, or an error naming its exit."""
    import selectors

    with selectors.DefaultSelector() as sel:
        sel.register(proc.stdout, selectors.EVENT_READ)
        if not sel.select(timeout):
            proc.kill()
            raise AssertionError(f"node pid {proc.pid} printed nothing in {timeout} s")
    line = proc.stdout.readline()
    if not line:
        raise AssertionError(f"node pid {proc.pid} exited {proc.wait()} before printing")
    return line


def stop_node(proc: subprocess.Popen) -> dict:
    """Send a ``--deadline stdin`` node its deadline (now) and return its
    final status line."""
    out, _ = proc.communicate(input=f"{time.time()!r}\n", timeout=CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"node pid {proc.pid} exited {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])


def logged_launches(log: pathlib.Path) -> list[dict]:
    """Every ``kernel launches`` line a node (or a net's nodes) logged at
    exit, in order."""
    marker = "kernel launches: "
    return [json.loads(line.split(marker, 1)[1]) for line in log.read_text().splitlines() if marker in line]


def logged_admission(log: pathlib.Path) -> list[dict]:
    """Every ``tx admission`` line a node (or a net's nodes) logged at exit
    (its port, transfers admitted, seconds in pool admission), in order,
    with the mean µs per admitted transfer."""
    marker = "tx admission: "
    lines = [json.loads(line.split(marker, 1)[1]) for line in log.read_text().splitlines() if marker in line]
    return [{**a, "us_per_tx": 1e6 * a["s"] / a["txs_accepted"] if a["txs_accepted"] else None} for a in lines]


def stored_blocks(path: pathlib.Path, difficulty: int) -> list:
    """The blocks of a node's store (none if it is not written yet), each
    checked by hashlib for its target and its link to a block before it."""
    from p1_tpu_torch.chain import ChainStore
    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.core.hashutil import sha256d
    from p1_tpu_torch.core.header import meets_target

    if not path.exists():
        return []
    store = ChainStore(path)
    try:
        blocks = store.load_blocks()
    finally:
        store.close()
    seen = {make_genesis(difficulty).block_hash()}
    for block in blocks:
        raw = block.header.serialize()
        if block.header.prev_hash not in seen or not meets_target(sha256d(raw), difficulty):
            raise AssertionError(f"stored block fails its target or link: {raw.hex()}")
        seen.add(sha256d(raw))
    return blocks


def free_port_block(n: int) -> int:
    """A base port whose ``n`` ports from it are all free on 127.0.0.1 now:
    a net's nodes listen on base..base+n-1, and a fixed base would meet
    another net (or another checkout's smoke) on the same host."""
    for _ in range(64):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            base = probe.getsockname()[1]
        if base + n > 65536:
            continue
        held = []
        try:
            for port in range(base, base + n):
                held.append(socket.socket())
                held[-1].bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for sock in held:
                sock.close()
    raise AssertionError(f"no block of {n} free ports on 127.0.0.1")


def status_of(port: int, difficulty: int, tries: int = 5) -> dict:
    """The node's status over the wire; a node whose loop is busy (a
    signature window) may miss a query's deadline, so a few tries."""
    import asyncio

    from p1_tpu_torch.node.client import get_status

    for attempt in range(tries):
        try:
            return asyncio.run(get_status("127.0.0.1", port, difficulty))
        except (TimeoutError, OSError):
            if attempt == tries - 1:
                raise
    raise AssertionError("unreachable")


def measure_admission(port: int, chain, n: int = ADMIT_TXS) -> dict:
    """Push ``n`` signed transfers of the store's funded sender down one
    session to the node at ``port``, then a GETSTATUS on the same session,
    and time from the first frame to its reply: the node handles a
    session's frames in order, so the reply comes once every transfer has
    been through admission (frame decode, the serial signature check on
    the native rung, the pool), with no poll in the window.  Should the
    reply show fewer than ``n`` admitted, the status is polled until it
    does.  The node's ``validation.backends`` must have grown by ``n`` on
    ``native`` and by none on ``pure-python``."""
    import asyncio

    from p1_tpu_torch.benchmarks.sig_verify import sign_many
    from p1_tpu_torch.core.keys import Keypair
    from p1_tpu_torch.core.tx import Transaction
    from p1_tpu_torch.node import protocol
    from p1_tpu_torch.node.client import _read_msg, _session, get_status
    from p1_tpu_torch.node.protocol import MsgType

    alice = Keypair.from_seed_text("host-ingest-alice")  # build_blocks' sender
    tag, seq0 = chain.genesis.block_hash(), chain.nonce(alice.account)
    unsigned = [Transaction(alice.account, "bob", 1, 1, seq0 + i, chain=tag) for i in range(n)]
    sigs = sign_many((alice._seed, tx.signing_bytes()) for tx in unsigned)
    frames = [protocol.encode_tx(dataclasses.replace(tx, pubkey=alice.pubkey, sig=sig))
              for tx, sig in zip(unsigned, sigs)]  # fmt: skip

    async def push() -> tuple[dict, float, dict, int]:
        before = await get_status("127.0.0.1", port, 1)
        async with _session("127.0.0.1", port, 1, None) as (reader, writer, _hello):
            t0 = time.perf_counter()
            for frame in frames:
                await protocol.write_frame(writer, frame)
            await protocol.write_frame(writer, protocol.encode_getstatus())
            while (reply := await _read_msg(reader, writer))[0] is not MsgType.STATUS:
                pass
            status, polls = reply[1], 0
            deadline = t0 + CHILD_TIMEOUT_S
            while status["txs_accepted"] - before["txs_accepted"] < n and time.perf_counter() < deadline:
                await asyncio.sleep(0.005)
                status, polls = await get_status("127.0.0.1", port, 1), polls + 1
            return before, time.perf_counter() - t0, status, polls

    before, wall_s, status, polls = asyncio.run(push())
    if status["mempool"] != n:
        raise AssertionError(f"admission: {status['mempool']} of {n} transfers in the pool")
    backends = {k: v - before["validation"]["backends"][k] for k, v in status["validation"]["backends"].items()}
    if backends["native"] != n or backends["pure-python"] != 0:
        raise AssertionError(f"admission of {n} transfers: {backends} signatures by rung, not all native")
    return {"txs": n, "wall_s": wall_s, "us_per_tx": 1e6 * wall_s / n, "status_polls": polls,
            "serial_verifies": status["validation"]["serial"], "validation_backends": backends,
            "backend_label": status["validation"]["backend"]}  # fmt: skip


def phase_node(built, device: str = "cuda", mine_difficulty: int = NODE_MINE_DIFFICULTY,
               mine_s: float = NODE_MINE_S) -> dict:  # fmt: skip
    """Phase 11: ``python -m p1_tpu_torch node`` on the card.  (a) A node
    boots on phase 10's store with ``--revalidate-store`` (the untrusted
    load: every signature window on ``ed25519_msm.cu``), and its admission
    of signed transfers is timed; (b) a second node with an empty store
    deep-syncs the chain and the first node's pool from it; (c) a mining
    node at difficulty 20 seals blocks through ``sha256d_search.cu``, and
    every block of its store passes hashlib's target and link check."""
    from p1_tpu_torch.chain import save_chain

    signatures = (REVAL_BLOCKS - 1) * REVAL_TXS
    tip = built.tip_hash.hex()
    with tempfile.TemporaryDirectory() as tmp, stopped_at_exit([]) as children:
        tmp = pathlib.Path(tmp)
        save_chain(built, tmp / "a.chain")
        common = ["--port", "0", "--deadline", "stdin", "--no-mine", "--difficulty", "1"]
        t0 = time.perf_counter()
        a = spawn_node([*common, "--store", str(tmp / "a.chain"), "--revalidate-store"], tmp / "a.log", device,
                       children)  # fmt: skip
        port_a = json.loads(read_line(a))["ready"]
        boot_s = time.perf_counter() - t0
        booted = status_of(port_a, 1)
        if (booted["tip"], booted["height"], booted["validation"]["backends"]["device"]) != (
            tip, built.height, signatures
        ):
            raise AssertionError(f"revalidating boot: {booted['tip']} at {booted['height']}, "
                                 f"{booted['validation']['backends']} device signatures")  # fmt: skip
        admission = measure_admission(port_a, built)

        t1 = time.perf_counter()
        b = spawn_node([*common, "--store", str(tmp / "b.chain"), "--peers", f"127.0.0.1:{port_a}"],
                       tmp / "b.log", device, children)  # fmt: skip
        port_b = json.loads(read_line(b))["ready"]
        start_s = time.perf_counter() - t1
        synced = {"height": None, "mempool": None}
        while True:
            with contextlib.suppress(TimeoutError, OSError):  # a busy loop misses a query
                synced = status_of(port_b, 1, tries=1)
                if synced["tip"] == tip and synced["mempool"] == ADMIT_TXS:
                    break
            if time.perf_counter() - t1 > CHILD_TIMEOUT_S:
                raise AssertionError(f"deep sync stuck at height {synced['height']}, pool {synced['mempool']}")
            time.sleep(0.1)
        sync_s = time.perf_counter() - t1 - start_s
        final_b, final_a = stop_node(b), stop_node(a)
        (launches_a,), (launches_b,) = logged_launches(tmp / "a.log"), logged_launches(tmp / "b.log")
        (admitted_a,) = logged_admission(tmp / "a.log")
        if final_b["tip"] != final_a["tip"] or final_b["validation"]["backends"]["device"] <= 0:
            raise AssertionError(f"synced node: tip {final_b['tip']}, {final_b['validation']['backends']}")
        if device == "cuda" and (launches_a["ed25519_msm"] != 5 or launches_b["ed25519_msm"] <= 0):
            raise AssertionError(f"ed25519_msm launches: boot {launches_a}, sync {launches_b}")

        t2 = time.perf_counter()
        c = spawn_node(["--port", "0", "--difficulty", str(mine_difficulty), "--store", str(tmp / "c.chain"),
                        "--duration", str(mine_s)], tmp / "c.log", device, children)  # fmt: skip
        out, _ = c.communicate(timeout=mine_s + CHILD_TIMEOUT_S)
        mine_wall_s = time.perf_counter() - t2
        final_c = json.loads(out.strip().splitlines()[-1])
        (launches_c,) = logged_launches(tmp / "c.log")
        if c.returncode != 0 or final_c["blocks_mined"] <= 0:
            raise AssertionError(f"mining node: exit {c.returncode}, {final_c['blocks_mined']} blocks mined")
        if device == "cuda" and launches_c["sha256d_search"] <= 0:
            raise AssertionError(f"mining node launched the search kernel no time: {launches_c}")
        blocks = stored_blocks(tmp / "c.chain", mine_difficulty)
        if final_c["tip"] != blocks[-1].block_hash().hex() or len(blocks) < final_c["height"]:
            raise AssertionError(f"store of {len(blocks)} blocks, node at {final_c['height']} {final_c['tip']}")
    line = {"boot_revalidate_s": boot_s, "boot_height": booted["height"], "boot_tip": booted["tip"],
            "boot_device_signatures": booted["validation"]["backends"]["device"],
            "launches_boot": launches_a, "admission": {**admission, "node_us_per_tx": admitted_a["us_per_tx"]},
            "start_s": start_s, "sync_s": sync_s, "synced_height": final_b["height"],
            "synced_device_signatures": final_b["validation"]["backends"]["device"],
            "launches_sync": launches_b, "mine_wall_s": mine_wall_s, "mined_height": final_c["height"],
            "blocks_mined": final_c["blocks_mined"], "stored_blocks_checked": len(blocks),
            "hashes_per_sec": final_c["hashes_per_sec"], "time_to_block_s": final_c["time_to_block_s"],
            "launches_mine": launches_c}  # fmt: skip
    emit({"phase": "node", **line})
    return line


def phase_net(device: str = "cuda", net_args: tuple = NET_ARGS) -> dict:
    """Phase 12: ``python -m p1_tpu_torch net`` (BASELINE config 4), four
    node processes on the one card with a live transfer economy; it must
    exit 0, converged, with every ledger conserved.  Each node's bans and
    admission drops, and its mean µs of pool admission per admitted
    transfer (logged at its exit), are printed."""
    nodes = int(net_args[net_args.index("--nodes") + 1])
    base_port = free_port_block(nodes)
    with tempfile.TemporaryDirectory() as tmp:
        log = pathlib.Path(tmp) / "net.log"
        t0 = time.perf_counter()
        with open(log, "w") as fh:
            # A session of its own: should the net hang, its node children
            # go down with it.
            proc = subprocess.Popen([sys.executable, "-m", "p1_tpu_torch", "net", "--device", device, *net_args,
                                     "--base-port", str(base_port)],
                                    stdout=subprocess.PIPE, stderr=fh, text=True, cwd=ROOT,
                                    start_new_session=True)  # fmt: skip
        try:
            stdout, _ = proc.communicate(timeout=4 * CHILD_TIMEOUT_S)
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        wall_s = time.perf_counter() - t0
        launches, admitted = logged_launches(log), logged_admission(log)
        tail = log.read_text()[-3000:]
    try:
        out = json.loads(stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        raise AssertionError(f"net exited {proc.returncode} with no summary: {tail}") from None
    per_node = [{"height": s["height"], "tip": s["tip"][:16], "peers": s["peers"], "banned_hosts": s["banned_hosts"],
                 "reorgs": s["reorgs"], "admission_dropped": s["overload"]["admission_dropped"]}
                for s in out["statuses"]]  # fmt: skip
    converged = out["converged"] and out["economy"]["ledger_conserved"]
    if proc.returncode != 0 or not converged or len(launches) != nodes or len(admitted) != nodes:
        raise AssertionError(f"net: exit {proc.returncode}, converged {out['converged']}, economy "
                             f"{out.get('economy')}, {len(launches)} launch lines, nodes {per_node}")  # fmt: skip
    if device == "cuda" and not all(n.get("sha256d_search", 0) > 0 for n in launches):
        raise AssertionError(f"a net node launched the search kernel no time: {launches}")
    statuses = out["statuses"]
    rungs = [s["validation"]["backends"] for s in statuses]
    native_missing = out["economy"]["txs_accepted_total"] and not all(r["native"] for r in rungs)
    if native_missing or any(r["pure-python"] for r in rungs):
        raise AssertionError(f"net nodes' signatures by rung: {rungs}; serial work must run on the native rung")
    line = {"wall_s": wall_s, "height": out["height"], "blocks_mined_total": out["blocks_mined_total"],
            "reorgs_total": out["reorgs_total"], "propagation_delay_ms": out["propagation_delay_ms"],
            "txs_submitted": out["economy"]["txs_submitted"], "txs_failed": out["economy"]["txs_failed"],
            "txs_accepted_total": out["economy"]["txs_accepted_total"],
            "heights": [s["height"] for s in statuses], "blocks_mined": [s["blocks_mined"] for s in statuses],
            "hashes_per_sec": [s["hashes_per_sec"] for s in statuses],
            "time_to_block_s": [s["time_to_block_s"] for s in statuses],
            "validation_backends": [s["validation"]["backends"] for s in statuses],
            "banned_hosts_total": sum(n["banned_hosts"] for n in per_node),
            "admission_dropped_total": {cls: sum(n["admission_dropped"][cls] for n in per_node)
                                        for cls in per_node[0]["admission_dropped"]},
            "admission_us_per_tx": {str(a["port"]): a["us_per_tx"] for a in admitted},
            "nodes": per_node, "launches": launches}  # fmt: skip
    emit({"phase": "net", **line})
    return line


# -- phase 13: the native host tier ------------------------------------------


def native_first_offset(backend, prefix: bytes, base: int, span: int, difficulty: int) -> int:
    """The native backend's earliest hit in the ``span`` nonces from
    ``base`` (wrapping past 2**32, as a kernel step does) as an offset, or
    ``span``: the kernel step's contract."""
    first = min(span, (1 << 32) - base)
    res = backend.search(prefix, base, first, difficulty)
    if res.nonce is not None:
        return res.nonce - base
    if first < span:
        res = backend.search(prefix, 0, span - first, difficulty)
        if res.nonce is not None:
            return first + res.nonce
    return span


def phase_native(native_build_s: float, search_fn, batch: int) -> tuple[dict, dict]:
    """Phase 13: the native host tier on the card's host.  The library
    (``p1_tpu_torch/native/*.cpp``, one ``g++``, built in phase 1) must
    load and be the serial signature rung; the native backend's first hit
    equals the search kernel's and the plain version's on phase 2's
    fixtures in both compressions; ``replay --method all`` at BASELINE
    config 3 (host, native and ``verify_chain.cu`` agree; its search and
    verify launches counted); the three engines name the same first
    invalid header on phase 6's corruptions; µs per signature of the
    native serial and batch rungs beside the device rung on the same
    triples.  Returns the phase's line and its launches."""
    from p1_tpu_torch import cli
    from p1_tpu_torch.benchmarks.sig_verify import bench_native
    from p1_tpu_torch.chain import parse_headers, replay_device, replay_host, replay_native
    from p1_tpu_torch.core import _ed25519_native, keys
    from p1_tpu_torch.hashx import cuda_backend, cuda_verify, get_backend, native_build
    from p1_tpu_torch.hashx.torch_backend import _RAMP_FLOOR

    keys.set_sig_backend(None)
    if not _ed25519_native.available() or keys._serial_backend() != "native":
        raise AssertionError(f"the native Ed25519 engine did not load: serial rung {keys._serial_backend()}")
    native = get_backend("native")
    has_shani, cases = native.has_shani, 0
    for scalar in (False, True):  # the runtime-dispatched compression, then the portable one
        native.force_scalar(scalar)
        for span in (_RAMP_FLOOR, batch):
            for seed, diff in enumerate((0, 8, 16, NO_HIT)):
                if span == batch and diff == NO_HIT:
                    continue  # a 2**26 host scan per base: the ramp-floor span covers the miss
                prefix = prefix_for(seed, diff)
                arrays = arrays_for(prefix, diff, "cuda")
                for base in (0, 0x1000, 0xFFFFF000):
                    got = native_first_offset(native, prefix, base, span, diff)
                    kernel = int(search_fn(span)(arrays, base)[0])
                    plain = plain_first_hit(arrays, base, span)
                    if not got == kernel == plain:
                        raise AssertionError(f"native {got}, kernel {kernel}, plain {plain} "
                                             f"(span {span}, d{diff}, base {base:#x}, scalar {scalar})")  # fmt: skip
                    cases += 1
    native.force_scalar(False)

    search, verify = cuda_backend.sha256d_search, cuda_verify.verify_chain
    search.launches = verify.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out_file = pathlib.Path(tmp) / "headers.bin"
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            rc = cli.main(["replay", "--n", str(REPLAY_N), "--difficulty", str(REPLAY_DIFFICULTY),
                           "--method", "all", "--device", "cuda", "--out", str(out_file)])  # fmt: skip
        cli_s = time.perf_counter() - t0
        launches = {"sha256d_search": search.launches, "verify_chain": verify.launches}
        line = json.loads(stdout.getvalue().strip().splitlines()[-1])
        headers = parse_headers(out_file.read_bytes())
    methods = [r["method"] for r in line["results"]]
    if rc != 0 or not line["valid"] or methods != ["host", "native", "device", "device"]:
        raise AssertionError(f"replay --method all failed (exit {rc}): {line}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"replay --method all launched {launches}")
    flagged = {}
    for name, i, bad in replay_corruptions(headers):
        got = (replay_native(bad).first_invalid, replay_host(bad).first_invalid, replay_device(bad).first_invalid)
        if got != (i, i, i):
            raise AssertionError(f"{name}: native, host, device first invalid {got}, expected {i}")
        flagged[name] = i
    sigs = bench_native(SIG_BATCH, device="cuda")
    result = {"build_s": native_build_s, "library": native_build.library_path().name, "has_shani": has_shani,
              "serial_rung": keys._serial_backend(), "backend_label": keys.backend_label(),
              "search_cases": cases, "compressions": ["sha-ni" if has_shani else "scalar", "scalar"],
              "replay": {**line, "exit": rc, "wall_s": cli_s, "launches": launches},
              "replay_headers_per_s": {r["method"]: r["headers_per_sec"] for r in line["results"]},
              "corruptions_first_invalid": flagged, "signatures": sigs}  # fmt: skip
    emit({"phase": "native", **result})
    return result, launches


# -- phase 14: the multi-chip plane -------------------------------------------

MESH_SLOTS = 4  # the virtual mesh on one card: four slots, four streams
MESH_DIFFICULTY = 28  # BASELINE config 5
MESH_BLOCKS = 8
LATE_BATCH = 1 << 20  # per slot: a 4-slot step of 2**22, hits expected at ~2**21 ...
LATE_DIFFICULTY = 21  # ... so some seed's earliest hit lies in slot 2 or 3
NEAR_SLOTS = 63  # 63 x 2**26 = 2**32 - 2**26: the widest step under 2**32 at the default batch
NEAR_DIFFICULTY = 32  # about one hit per 2**32: some seed's earliest lies past 2**31
SCAN_COUNT = 1 << 32  # the full scans' nonces
POD_DIFFICULTY = 20
POD_ARGS = ("--num-hosts", "2", "--difficulty", str(POD_DIFFICULTY))
POD_S = 10  # the gossiping pod's window
POD_FAILOVER_S = 45  # the failover pod's window, which its solo node inherits
POD_GRACE_S = "15"  # P1_POD_GRACE_S of the failover pod: no kernel build in a gap


def spawn_pod(coord: int, host_id: int, args: list[str], log: pathlib.Path, device: str, children: list,
              env: dict | None = None) -> subprocess.Popen:  # fmt: skip
    """``python -m p1_tpu_torch pod`` process ``host_id`` of the pod whose
    rendezvous is at ``coord``, its log to ``log``, stopped with the phase."""
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "p1_tpu_torch", "pod", "--coordinator", f"127.0.0.1:{coord}",
             "--host-id", str(host_id), "--device", device, *POD_ARGS, *args],
            stdout=subprocess.PIPE, stderr=fh, text=True, cwd=ROOT, env=env,
        )  # fmt: skip
    children.append(proc)
    return proc


def wait_blocks(path: pathlib.Path, difficulty: int, target: int, timeout: float) -> int:
    deadline = time.monotonic() + timeout
    while (n := len(stored_blocks(path, difficulty))) < target:
        if time.monotonic() > deadline:
            raise AssertionError(f"{path.name}: {n} blocks after {timeout} s, waiting for {target}")
        time.sleep(0.5)
    return n


def mesh_ms(mesh, launch, reps: int = 20) -> float:
    """Mean device milliseconds of ``launch(i)`` on every slot i of
    ``mesh``, each on its slot's stream, from an event on the current
    stream to one recorded after every slot's stream is done."""
    import torch

    current = torch.cuda.current_stream()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(len(mesh.devices)):  # warm
        with mesh.stream(i):
            launch(i)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        for s in mesh.streams:
            s.wait_stream(current)
        for i in range(len(mesh.devices)):
            with mesh.stream(i):
                launch(i)
        for s in mesh.streams:
            current.wait_stream(s)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_multichip(fixtures: list, batch: int, sub: int, threads: int, search_bound_ms: float, sig_batch: list,
                    msm_bound, smi: str, device: str = "cuda") -> tuple[dict, dict]:  # fmt: skip
    """Phase 14: the multi-chip plane on one card.  The ``sharded`` backend
    on a one-slot and a ``MESH_SLOTS``-slot mesh (each slot a stream of
    ``cuda:0``): phase 2's first hits, a hit in slot 2 or 3, the no-hit
    span, a 63-slot span just under 2**32 with a hit past 2**31; full
    2**32 scans' rates and the slots' step time; BASELINE config 5,
    ``mine --backend sharded --difficulty 28`` (the path whose launches
    are counted) on both meshes sealing ``cuda``'s nonces; the sharded
    MSM on the 1,024 triples at both mesh sizes (one launch a slot, the
    same verdicts); a two-process pod on gloo and a listener (blocks
    gossiped and valid, searches mirrored, each process's launches), then
    a pod whose follower is SIGKILLed (the leader fails over to solo
    mining and the store keeps growing); ``dryrun_multichip``.  Returns
    the phase's line and its launches per kernel."""
    import torch

    from p1_tpu_torch import graft_entry
    from p1_tpu_torch.benchmarks import sig_verify as sv
    from p1_tpu_torch.cli import mine_chain, mine_report
    from p1_tpu_torch.core import _ed25519 as e
    from p1_tpu_torch.core.hashutil import sha256d
    from p1_tpu_torch.core.header import meets_target
    from p1_tpu_torch.hashx import cuda_backend as cb
    from p1_tpu_torch.hashx import cuda_ed25519 as ce
    from p1_tpu_torch.hashx import ed25519_msm as m
    from p1_tpu_torch.hashx import get_backend, sharded
    from p1_tpu_torch.miner import Miner

    on_card = device == "cuda"
    search, msm = cb.sha256d_search, ce.ed25519_msm
    slot_dev = "cuda:0" if on_card else "cpu"

    def mesh_backend(slots: int, per_slot: int | None = None):
        kwargs = {} if per_slot is None else {"batch": per_slot}
        return get_backend("sharded", n_devices=slots, device=slot_dev, slots_per_device=slots, sub=sub,
                           threads=threads, **kwargs)  # fmt: skip

    def counted(n_before: int, want: int, what: str) -> None:
        if on_card and search.launches - n_before != want:
            raise AssertionError(f"{what}: {search.launches - n_before} search launches, expected {want}")

    # -- first hits: phase 2's fixtures, a late hit, the span under 2**32 --
    cases = 0
    for slots in (1, MESH_SLOTS):
        for span, seed, diff, base, want in fixtures:
            step = mesh_backend(slots, span // slots)._make_step(span)
            before = search.launches
            got = int(step(arrays_for(prefix_for(seed, diff), diff, device), base)[0])
            if got != want:
                raise AssertionError(f"{slots}-slot step {got} != cuda's {want} (span {span}, d{diff}, base {base:#x})")
            counted(before, slots, f"{slots}-slot step")
            cases += 1
    late_span = MESH_SLOTS * LATE_BATCH
    single = cb.cuda_search_fn(late_span, sub, threads)
    for seed in range(100, 164):
        arrays = arrays_for(prefix_for(seed, LATE_DIFFICULTY), LATE_DIFFICULTY, device)
        want = int(single(arrays, 0)[0])
        if 2 * LATE_BATCH <= want < late_span:
            break
    else:
        raise AssertionError("no seed with its earliest hit in slot 2 or 3")
    got = int(mesh_backend(MESH_SLOTS, LATE_BATCH)._make_step(late_span)(arrays, 0)[0])
    plain = plain_first_hit(arrays, 0, late_span)
    if not got == want == plain:
        raise AssertionError(f"late hit: {MESH_SLOTS} slots {got}, cuda {want}, plain {plain}")
    late = {"seed": seed, "difficulty": LATE_DIFFICULTY, "offset": got, "slot": got // LATE_BATCH}

    near = mesh_backend(NEAR_SLOTS, batch)
    near_step = near._make_step(near.step_span)
    miss = int(near_step(arrays_for(prefix_for(99, NO_HIT), NO_HIT, device), 0)[0])
    if miss != near.step_span:
        raise AssertionError(f"{NEAR_SLOTS}-slot miss {miss} != span {near.step_span}")
    past = 1 << 31 if near.step_span > 1 << 31 else near.step_span // 2
    solo = get_backend("cuda", batch=batch, sub=sub, threads=threads, device=device)
    for seed in range(200, 232):
        prefix = prefix_for(seed, NEAR_DIFFICULTY)
        truth = solo.search(prefix, 0, near.step_span, NEAR_DIFFICULTY)
        if truth.nonce is not None and truth.nonce >= past:
            break
    else:
        raise AssertionError(f"no seed with its earliest hit past {past}")
    got = int(near_step(arrays_for(prefix, NEAR_DIFFICULTY, device), 0)[0])
    res = near.search(prefix, 0, near.step_span, NEAR_DIFFICULTY)
    if not got == truth.nonce == res.nonce or res.hashes_done != truth.hashes_done:
        raise AssertionError(f"{NEAR_SLOTS}-slot step {got}, search {res}, cuda {truth}")
    if not meets_target(sha256d(prefix + got.to_bytes(4, "big")), NEAR_DIFFICULTY):
        raise AssertionError(f"near-2**32 hit {got} fails its target")
    near_line = {"slots": NEAR_SLOTS, "span": near.step_span, "miss": miss, "seed": seed,
                 "difficulty": NEAR_DIFFICULTY, "offset": got, "slot": got // batch}  # fmt: skip

    # -- rates: full scans and the slots' step ---------------------------
    scans = {}
    for slots in (1, MESH_SLOTS):
        be = mesh_backend(slots, batch)
        t0 = time.perf_counter()
        res = be.search(prefix_for(99, NO_HIT), 0, SCAN_COUNT, NO_HIT)
        scan_s = time.perf_counter() - t0
        if res.nonce is not None or res.hashes_done != SCAN_COUNT:
            raise AssertionError(f"{slots}-slot scan returned {res}")
        scans[slots] = {"step_span": be.step_span, "scan_s": scan_s, "ghps": SCAN_COUNT / scan_s / 1e9}
    arrays = arrays_for(prefix_for(99, NO_HIT), NO_HIT, device)
    step4 = mesh_backend(MESH_SLOTS, batch)._make_step(MESH_SLOTS * batch)
    step_ms = cuda_ms(lambda: step4(arrays, 0), reps=5) if on_card else None
    # The plain body on the same slots, at PLAIN_CHUNK a slot (the kernel's
    # step at that shape beside it).
    small = mesh_backend(MESH_SLOTS, PLAIN_CHUNK)
    plain_step = sharded.jit_sharded_step(small.mesh, PLAIN_CHUNK, "plain")
    small_step = small._make_step(small.step_span)
    # The kernel's 4-slot step against the plain one on the same inputs: a
    # miss, and a fixture whose earliest hit lies past slot 0 (about two
    # hits a span at this difficulty).
    small_diff = small.step_span.bit_length() - 2
    whole = cb.cuda_search_fn(small.step_span, sub, threads)
    for seed in range(300, 364):
        hit_arrays = arrays_for(prefix_for(seed, small_diff), small_diff, device)
        if PLAIN_CHUNK <= int(whole(hit_arrays, 0)[0]) < small.step_span:
            break
    else:
        raise AssertionError(f"no seed with its earliest hit past slot 0 at difficulty {small_diff}")
    small_cases = {}
    for name, case in (("miss", arrays), ("hit", hit_arrays)):
        got, want = int(small_step(case, 0)[0]), int(plain_step(case, 0)[0])
        if got != want or (name == "miss") != (got == small.step_span):
            raise AssertionError(f"{MESH_SLOTS}-slot step on the {name}: kernel {got}, plain {want}")
        small_cases[name] = got
    mesh_err = 0  # every comparison above raised unless exact
    small_ms = {"slot_batch": PLAIN_CHUNK, "plain_ms": cuda_ms(lambda: plain_step(arrays, 0), reps=1),
                "ms": cuda_ms(lambda: small_step(arrays, 0), reps=5)} if on_card else {}  # fmt: skip
    small_ms.update({"difficulty": small_diff, "seed": seed, "offsets": small_cases, "max_abs_err": mesh_err})

    # -- BASELINE config 5: mine --backend sharded --difficulty 28 --------
    mined = {}
    headers, times, hashes = mine_chain(Miner(backend=get_backend("cuda", device=device)), MESH_DIFFICULTY, MESH_BLOCKS)
    want_nonces = [h.serialize() for h in headers]
    mined["cuda"] = mine_report("cuda", MESH_DIFFICULTY, times, hashes)
    launches_mine = 0
    for slots in (1, MESH_SLOTS):
        backend = get_backend("sharded", device=slot_dev, slots_per_device=slots)
        search.launches = 0
        headers, times, hashes = mine_chain(Miner(backend=backend), MESH_DIFFICULTY, MESH_BLOCKS)
        launches = search.launches
        if on_card and launches <= 0:
            raise AssertionError(f"{slots}-slot mining launched the search kernel no time")
        if [h.serialize() for h in headers] != want_nonces:
            raise AssertionError(f"{slots}-slot sharded mining sealed other headers than cuda's")
        mined[f"sharded_{slots}"] = {**mine_report("sharded", MESH_DIFFICULTY, times, hashes), "launches": launches,
                                     "nonces": [h.nonce for h in headers]}  # fmt: skip
        launches_mine += launches

    # -- the sharded MSM ---------------------------------------------------
    meshes = {s: sharded.make_mesh(s, slot_dev, s, across_processes=False) for s in (1, MESH_SLOTS)}
    rows = [r.tobytes() for r in m.prepare(sig_batch).encodings]
    per = -(-len(rows) // MESH_SLOTS)

    def bad_r_in(slot: int) -> list:
        tr = list(sig_batch)
        i = next(i for i, t in enumerate(tr) if rows.index(t[1][:32]) // per == slot)
        pub, sig, msg = tr[i]
        tr[i] = (pub, tr[i - 1][1][:32] + sig[32:], msg)  # another valid point: only the sum catches it
        return tr

    n = len(sig_batch)
    msm_cases = {
        "valid": (sig_batch, True),
        **{f"bad R in slot {k}": (bad_r_in(k), False) for k in range(MESH_SLOTS)},
        "torsion cancel": (sig_batch[:-1] + [sv.torsion_triple(cancel=True)], False),
        "torsion reject": (sig_batch[:-1] + [sv.torsion_triple(cancel=False)], False),
    }
    verdicts, msm_launches = {}, 0
    for name, (tr, want) in msm_cases.items():
        for slots, mesh in meshes.items():
            before = msm.launches
            verdicts[f"{name} @{slots}"] = got = m.verify_batch_device(tr, mesh=mesh)
            if got is not want or (on_card and msm.launches - before != slots):
                raise AssertionError(f"MSM {name} on {slots} slots: {got}, {msm.launches - before} launches")
            msm_launches += msm.launches - before
    msm_us = {}
    for slots, mesh in meshes.items():
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            if not m.verify_batch_device(sig_batch, mesh=mesh):
                raise AssertionError(f"the valid batch failed on {slots} slots")
            runs.append(time.perf_counter() - t0)
        msm_us[slots] = 1e6 * min(runs) / n
    msm_launches_timed = 0
    msm_ms = msm_plain_ms = msm_err = None
    points = [len(p.encodings) for p in m.split(m.prepare(sig_batch), MESH_SLOTS)]
    if on_card:
        mesh4 = meshes[MESH_SLOTS]
        inputs = []
        for i, part in enumerate(m.split(m.prepare(sig_batch), MESH_SLOTS)):
            with mesh4.stream(i):
                inputs.append(m.to_device(part, mesh4.devices[i]))
        # Each slot's slice through the kernels on its stream against the
        # plain version on the same tensors: decoded limbs, flags, all-ok
        # and the canonical partial sum, exact; and the big-integer oracle.
        msm_err = 0
        for i in range(MESH_SLOTS):
            with mesh4.stream(i):
                err, oracle, got = decode_gate_msm_vs_plain(ce, m, e, *inputs[i])
            if err or not oracle or int(got.result[0]) != 1:
                raise AssertionError(f"MSM slice {i} of {MESH_SLOTS}: kernel vs plain max_abs_err {err}, "
                                     f"oracle {oracle}, all-ok {int(got.result[0])}")  # fmt: skip
            msm_err = max(msm_err, err)
        before = msm.launches
        msm_ms = mesh_ms(mesh4, lambda i: ce.decode_gate_msm(*inputs[i]))
        msm_launches_timed = msm.launches - before
        msm_plain_ms = mesh_ms(mesh4, lambda i: ce.plain_decode_gate_msm(*inputs[i]), reps=1)
    msm_line = {"verdicts": verdicts, "launches": msm_launches, "us_per_sig": msm_us, "slice_points": points,
                "ms_4_slots": msm_ms, "plain_ms_4_slots": msm_plain_ms, "bound_ms_4_slots": msm_bound(points),
                "timing_launches": msm_launches_timed, "max_abs_err_4_slots": msm_err}  # fmt: skip

    # -- a pod of two processes on the card, then its follower killed ------
    with tempfile.TemporaryDirectory() as tmp, stopped_at_exit([]) as children:
        tmp = pathlib.Path(tmp)
        listener = spawn_node(["--port", "0", "--difficulty", str(POD_DIFFICULTY), "--no-mine", "--deadline", "stdin"],
                              tmp / "listener.log", device, children)  # fmt: skip
        listen_port = json.loads(read_line(listener))["ready"]
        coord = free_port_block(1)
        t0 = time.perf_counter()
        leader = spawn_pod(coord, 0, ["--duration", str(POD_S), "--port", "0", "--peers", f"127.0.0.1:{listen_port}",
                                      "--miner-id", "pod", "--store", str(tmp / "pod.chain")],
                           tmp / "leader.log", device, children)  # fmt: skip
        follower = spawn_pod(coord, 1, ["--duration", str(POD_S)], tmp / "follower.log", device, children)
        leader_out, _ = leader.communicate(timeout=POD_S + CHILD_TIMEOUT_S)
        follower_out, _ = follower.communicate(timeout=CHILD_TIMEOUT_S)
        pod_wall_s = time.perf_counter() - t0
        final_listener = stop_node(listener)
        if leader.returncode != 0 or follower.returncode != 0:
            raise AssertionError(f"pod exits: leader {leader.returncode}, follower {follower.returncode}")
        exits = {"leader": leader.returncode, "follower": follower.returncode, "listener": listener.returncode}
        final_leader = json.loads(leader_out.strip().splitlines()[-1])
        mirrored = json.loads(follower_out.strip().splitlines()[-1])
        marker = "pod searches: "
        (searches,) = [int(line.split(marker, 1)[1]) for line in (tmp / "leader.log").read_text().splitlines()
                       if marker in line]  # fmt: skip
        if mirrored != {"config": "pod", "role": "follower", "searches": searches} or searches <= 0:
            raise AssertionError(f"follower {mirrored}, leader searches {searches}")
        if (final_listener["tip"], final_listener["height"]) != (final_leader["tip"], final_leader["height"]):
            raise AssertionError(f"listener at {final_listener['height']}, leader at {final_leader['height']}")
        if final_leader["height"] <= 0 or final_listener["blocks_mined"] != 0:
            raise AssertionError(f"pod mined {final_leader['height']}; listener mined {final_listener['blocks_mined']}")
        pod_blocks = stored_blocks(tmp / "pod.chain", POD_DIFFICULTY)
        if len(pod_blocks) != final_leader["height"]:
            raise AssertionError(f"pod store of {len(pod_blocks)} blocks, leader at {final_leader['height']}")
        (launches_leader,), (launches_follower,) = logged_launches(tmp / "leader.log"), logged_launches(tmp / "follower.log")
        if on_card and min(launches_leader["sha256d_search"], launches_follower["sha256d_search"]) <= 0:
            raise AssertionError(f"pod launches: leader {launches_leader}, follower {launches_follower}")

        env = {**os.environ, "P1_POD_GRACE_S": POD_GRACE_S}
        coord = free_port_block(1)
        chain = tmp / "failover.chain"
        t1 = time.perf_counter()
        leader = spawn_pod(coord, 0, ["--duration", str(POD_FAILOVER_S), "--port", "0", "--miner-id", "pod",
                                      "--store", str(chain)], tmp / "leader2.log", device, children, env)  # fmt: skip
        follower = spawn_pod(coord, 1, ["--duration", str(POD_FAILOVER_S)], tmp / "follower2.log", device,
                             children, env)  # fmt: skip
        pre_kill = wait_blocks(chain, POD_DIFFICULTY, 3, CHILD_TIMEOUT_S)
        follower.send_signal(signal.SIGKILL)
        follower_rc = follower.wait(timeout=30)
        t_kill = time.perf_counter()
        wait_blocks(chain, POD_DIFFICULTY, pre_kill + 3, float(POD_GRACE_S) + CHILD_TIMEOUT_S)
        regrow_s = time.perf_counter() - t_kill
        leader.communicate(timeout=POD_FAILOVER_S + CHILD_TIMEOUT_S)
        failover_wall_s = time.perf_counter() - t1
        log2 = (tmp / "leader2.log").read_text()
        if "failing over to solo mining" not in log2 or leader.returncode != 0:
            raise AssertionError(f"leader exit {leader.returncode} without failover: {log2[-2000:]}")
        final_blocks = len(stored_blocks(chain, POD_DIFFICULTY))
        solo_launches = logged_launches(tmp / "leader2.log")
    pod_line = {
        "wall_s": pod_wall_s, "height": final_leader["height"], "tip": final_leader["tip"],
        "listener_height": final_listener["height"], "searches_leader": searches, "searches_follower": mirrored["searches"],
        "hashes_per_sec": final_leader["hashes_per_sec"], "time_to_block_s": final_leader["time_to_block_s"],
        "launches_leader": launches_leader, "launches_follower": launches_follower,
        "exits": exits,
        "failover": {"blocks_before_kill": pre_kill, "follower_exit": follower_rc, "regrow_3_blocks_s": regrow_s,
                     "leader_exit": leader.returncode, "final_blocks": final_blocks, "wall_s": failover_wall_s,
                     "grace_s": float(POD_GRACE_S), "launches_logged": solo_launches},
    }  # fmt: skip

    # -- dryrun_multichip ------------------------------------------------
    out = io.StringIO()
    before, t0 = search.launches, time.perf_counter()
    with contextlib.redirect_stdout(out):
        graft_entry.dryrun_multichip(MESH_SLOTS, device=device)
    dryrun_s, dryrun_launches = time.perf_counter() - t0, search.launches - before
    dryrun = out.getvalue().strip()
    if not dryrun.startswith(f"dryrun_multichip ok: {MESH_SLOTS}-device mesh (platform={device})"):
        raise AssertionError(f"dryrun_multichip: {dryrun!r}")

    pod_search = launches_leader.get("sha256d_search", 0) + launches_follower.get("sha256d_search", 0)
    line = {"nvidia_smi": smi, "first_hit_cases": cases, "late_hit": late, "near_2p32": near_line,
            "scans": scans, "step_ms_4_slots": step_ms, "bound_ms_4_slots": MESH_SLOTS * search_bound_ms,
            "step_small": small_ms, "mine": mined, "msm": msm_line, "pod": pod_line,
            "dryrun": {"line": dryrun, "s": dryrun_s, "launches": dryrun_launches}}  # fmt: skip
    emit({"phase": "multichip", **line})
    return line, {"sha256d_search": launches_mine + pod_search, "ed25519_msm": msm_launches,
                  "sha256d_search_mine": launches_mine, "sha256d_search_pod": pod_search,
                  "sha256d_search_err": mesh_err, "ed25519_msm_err": msm_err or 0}


def ed25519_work(points: int, per_op: dict) -> tuple[int, int]:
    """(ALU, FMA) instructions of the reference's operations on ``points``
    points and one batch, at ``per_op``'s (ALU, FMA) cost per operation."""
    alu = fma = 0
    for op, (a, f) in per_op.items():
        count = points * ED_OPS_PER_POINT[op] + ED_OPS_PER_BATCH[op]
        alu, fma = alu + count * a, fma + count * f
    return alu, fma


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    adopt_orphans()

    from p1_tpu_torch.benchmarks import vpu_roofline as vr
    from p1_tpu_torch.cli import mine_chain, mine_report
    from p1_tpu_torch.core import genesis_header, meets_target
    from p1_tpu_torch.core.hashutil import sha256d
    from p1_tpu_torch.hashx import cuda_ed25519, cuda_verify, get_backend, kernel_build, native_build, sass
    from p1_tpu_torch.hashx import cuda_backend as cb
    from p1_tpu_torch.hashx.torch_backend import _RAMP_FLOOR
    from p1_tpu_torch.hashx.torch_sha256 import search_step
    from p1_tpu_torch.miner import Miner

    kernel = cb.sha256d_search
    dev = "cuda"
    batch, sub, threads = cb._DEFAULT_BATCH, cb._DEFAULT_SUB, cb._DEFAULT_THREADS

    # -- 1. card and build ------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    white_paper = Rate(sass.ALU_PER_SM_CLK, sass.DISPATCH_PER_SM_CLK, max_sm_mhz)
    t_build = time.perf_counter()

    def build_native() -> float:  # the host core's g++, beside the four nvcc
        t0 = time.perf_counter()
        native_build.build_lib(force=True)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build_job = pool.submit(build_native)
        builds = kernel_build.build_all([
            (cb.SearchKernel.SOURCE, kernel_build.CSRC),
            (vr.RooflineKernel.SOURCE, vr.RooflineKernel.CSRC),
            (cuda_verify.VerifyKernel.SOURCE, kernel_build.CSRC),
            (cuda_ed25519.Ed25519Kernel.SOURCE, kernel_build.CSRC),
        ])  # fmt: skip
        native_build_s = native_build_job.result()
    build_wall_s = time.perf_counter() - t_build
    built = kernel.built()
    regs, local_bytes = kernel.attributes()
    search_insns = sass.function_insns(sass.disassemble(built.path), "sha256d_search_kernel")
    sass_total, sass_alu = sass.counts(search_insns)
    spill_lines = ptxas_lines(built.ptxas_log, "sha256d_search_kernel")
    emit({
        "phase": "build", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": round(builds[0].build_s, 3), "library": built.path.name,
        "build_wall_s": round(build_wall_s, 3),
        "builds": {b.path.name: round(b.build_s, 3) for b in builds},
        "native_build_s": round(native_build_s, 3),
        "registers": regs, "local_bytes": local_bytes, "ptxas": spill_lines,
        "sass_instructions": sass_total, "sass_alu_instructions": sass_alu,
        "sass_opcodes": sass.opcode_histogram(search_insns),
        "sms": sms, "max_sm_mhz": max_sm_mhz,
    })  # fmt: skip

    # -- 2. kernel vs plain version ---------------------------------------
    cases = 0
    max_err = 0
    fixtures = []  # (span, seed, difficulty, base, first hit): phase 14 runs them on meshes
    for batch_ in (_RAMP_FLOOR, batch):
        step = cb.cuda_search_fn(batch_, sub, threads)
        for seed, diff in enumerate((0, 8, 16, NO_HIT)):
            arrays = arrays_for(prefix_for(seed, diff), diff, dev)
            for base in (0, 0x1000, 0xFFFFF000):
                got = int(step(arrays, base)[0])
                want = plain_first_hit(arrays, base, batch_)
                max_err = max(max_err, abs(got - want))
                if got != want:
                    raise AssertionError(
                        f"kernel {got} != plain {want} (batch {batch_}, d{diff}, base {base:#x})"
                    )
                fixtures.append((batch_, seed, diff, base, want))
                cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "cases": cases, "max_abs_err": max_err})

    # -- 3. the main path --------------------------------------------------
    backend = get_backend("cuda")
    miner = Miner(backend=backend)
    kernel.launches = 0
    headers, times, hashes = mine_chain(miner, DIFFICULTY, BLOCKS)
    launches = kernel.launches
    if launches <= 0:
        raise AssertionError("the main path launched the search kernel no time")
    parent = genesis_header(DIFFICULTY).block_hash()
    for h in headers:
        raw = h.serialize()
        if not meets_target(sha256d(raw), DIFFICULTY):
            raise AssertionError(f"seal fails its target: {raw.hex()}")
        if h.prev_hash != parent:
            raise AssertionError(f"broken prev-hash link at nonce {h.nonce}")
        earlier = plain_first_hit(arrays_for(h.mining_prefix(), DIFFICULTY, dev), 0, h.nonce)
        if earlier != h.nonce:
            raise AssertionError(f"nonce {h.nonce} is not the earliest: {earlier} hits")
        parent = h.block_hash()
    report = mine_report("cuda", DIFFICULTY, times, hashes)
    emit({"phase": "mine", **report, "launches": launches,
          "nonces": [h.nonce for h in headers], "earliest_checked": len(headers)})  # fmt: skip

    # -- 4. throughput -----------------------------------------------------
    arrays = arrays_for(prefix_for(99, NO_HIT), NO_HIT, dev)
    step = cb.cuda_search_fn(batch, sub, threads)
    kernel_ms = cuda_ms(lambda: step(arrays, 0), reps=20)
    t0 = time.perf_counter()
    res = backend.search(prefix_for(99, NO_HIT), 0, 1 << 32, NO_HIT)
    scan_s = time.perf_counter() - t0
    if res.nonce is not None or res.hashes_done != 1 << 32:
        raise AssertionError(f"difficulty-64 full scan returned {res}")
    def plain_batch(n: int) -> None:  # the plain version over [0, n) in 2**24 calls
        for off in range(0, n, 1 << 24):
            search_step(arrays.midstate, arrays.tail, arrays.target, off, min(1 << 24, n - off))

    plain_2p24_ms = cuda_ms(lambda: plain_batch(1 << 24), reps=2)
    plain_ms = cuda_ms(lambda: plain_batch(batch), reps=1)
    bound_wp_ms = white_paper.bound_ms(batch * sass_alu, batch * sass_total, sms)
    sweep = []
    check = arrays_for(prefix_for(3, 16), 16, dev)
    want16 = plain_first_hit(check, 0, _RAMP_FLOOR)
    for log2 in range(24, 29):
        for thr in (128, 256, 512):
            for sb in (1, 4, 16):
                fn = cb.cuda_search_fn(1 << log2, sb, thr)
                got = int(fn(check, 0)[0])
                if got != want16:
                    raise AssertionError(f"sweep config {log2}/{thr}/{sb}: {got} != {want16}")
                ms = cuda_ms(lambda: fn(arrays, 0), reps=3)
                sweep.append({"batch_log2": log2, "threads": thr, "sub": sb,
                              "ms": round(ms, 4), "ghps": round((1 << log2) / ms / 1e6, 4)})  # fmt: skip
    e2e = []
    for log2 in range(24, 29):
        be = get_backend("cuda", batch=1 << log2)
        t1 = time.perf_counter()
        be.search(prefix_for(99, NO_HIT), 0, 1 << 32, NO_HIT)
        e2e.append({"batch_log2": log2, "ghps": round((1 << 32) / (time.perf_counter() - t1) / 1e9, 4)})
    emit({
        "phase": "throughput", "batch": batch, "sub": sub, "threads": threads,
        "kernel_ms": kernel_ms, "kernel_ghps": batch / kernel_ms / 1e6,
        "scan_2p32_s": scan_s, "e2e_ghps": (1 << 32) / scan_s / 1e9,
        "plain_2p24_ms": plain_2p24_ms, "bound_ms_white_paper": bound_wp_ms,
        "bound_ghps_white_paper": batch / bound_wp_ms / 1e6, "sweep": sweep, "e2e_sweep": e2e,
    })  # fmt: skip

    # -- 5. roofline: the integer issue rate the bounds assume -------------
    roof, measured, peak = phase_roofline(vr, sass, sms, white_paper)
    bound_measured_ms = measured.bound_ms(batch * sass_alu, batch * sass_total, sms)
    bound_ms = peak.bound_ms(batch * sass_alu, batch * sass_total, sms)
    emit({"phase": "search_bound_restated", "kernel": "sha256d_search", "ms": kernel_ms,
          "bound_ms_white_paper": bound_wp_ms, "white_paper": dataclasses.asdict(white_paper),
          "bound_ms_measured": bound_measured_ms, "measured": dataclasses.asdict(measured),
          "bound_ms": bound_ms, "peak": dataclasses.asdict(peak),
          "pct_of_bound_white_paper": 100 * bound_wp_ms / kernel_ms,
          "pct_of_bound_measured": 100 * bound_measured_ms / kernel_ms,
          "pct_of_bound": 100 * bound_ms / kernel_ms})  # fmt: skip

    # -- 6. replay: BASELINE config 3 ---------------------------------------
    verify, search_launches = phase_replay(cuda_verify, sass, sms, peak, white_paper)

    # -- 7-9. Ed25519 signature validation on the card ----------------------
    ed25519, sig_batch = phase_ed25519(sass, sms, peak)

    # -- 10. the untrusted load of a chain store -----------------------------
    revalidate, built_store = phase_revalidate(cuda_ed25519.ed25519_msm)
    ed25519["launches_check_block"] = ed25519["launches"]
    ed25519["launches_revalidate"] = revalidate["launches"]
    ed25519["launches"] += revalidate["launches"]

    # -- 11-12. the node and the 4-node net, in processes of their own -------
    node = phase_node(built_store)
    net = phase_net()
    node_children = (node["launches_boot"], node["launches_sync"], node["launches_mine"])
    ed25519["launches_node"] = sum(n.get("ed25519_msm", 0) for n in node_children)
    ed25519["launches_net"] = sum(n.get("ed25519_msm", 0) for n in net["launches"])
    ed25519["launches"] += ed25519["launches_node"] + ed25519["launches_net"]
    search_node = sum(n.get("sha256d_search", 0) for n in node_children)
    search_net = sum(n.get("sha256d_search", 0) for n in net["launches"])

    # -- 13. the native host tier, and replay --method all -----------------
    _, native_launches = phase_native(native_build_s, lambda span: cb.cuda_search_fn(span, sub, threads), batch)
    verify["launches_native_replay"] = native_launches["verify_chain"]

    # -- 14. the multi-chip plane: meshes of slots, the sharded MSM, a pod --
    def msm_bound_ms(slice_points: list[int]) -> float:  # each slice a batch of its own
        alu = fma = 0
        for n in slice_points:
            a, f = ed25519_work(n, ED_OP_ALU_FMA)
            alu, fma = alu + a, fma + f
        return peak.bound_ms(alu, alu + fma, sms, fma=fma)

    _, mesh_launches = phase_multichip(fixtures, batch, sub, threads, bound_ms, sig_batch, msm_bound_ms, smi)
    ed25519["launches_multichip"] = mesh_launches["ed25519_msm"]
    ed25519["launches"] += mesh_launches["ed25519_msm"]
    ed25519["max_abs_err"] = max(ed25519["max_abs_err"], mesh_launches["ed25519_msm_err"])
    max_err = max(max_err, mesh_launches["sha256d_search_err"])
    ed25519["revalidate"] = {k: revalidate[k] for k in ("blocks", "signatures", "untrusted_s", "blocks_per_s", "us_per_sig")}

    # -- every process this run started has ended --------------------------
    stop_resource_tracker()
    if left := stop_children():
        raise AssertionError(f"processes still running at the end: {left}")

    print(json.dumps({"kernels": [
        {
            "name": "sha256d_search", "route": "cuda",
            "source": "p1_tpu_torch/hashx/csrc/sha256d_search.cu",
            "replaces": "p1_tpu/hashx/pallas_backend.py:67",
            "launches": launches + search_node + search_net + mesh_launches["sha256d_search"], "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None,
            "bound_ms_white_paper": bound_wp_ms, "bound_ms_measured_rate": bound_measured_ms,
            "launches_mine": launches, "launches_replay": search_launches,
            "launches_node": search_node, "launches_net": search_net,
            "launches_native_replay": native_launches["sha256d_search"],
            "launches_multichip": mesh_launches["sha256d_search_mine"],
            "launches_pod": mesh_launches["sha256d_search_pod"],
        },
        roof,
        verify,
        ed25519,
    ]}), flush=True)  # fmt: skip
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)  # fmt: skip
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:  # a failed phase leaves no process behind either
        stop_resource_tracker()
        stop_children()
