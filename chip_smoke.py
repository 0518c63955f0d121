#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``p1_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's paths, ``mine``, ``replay`` and signature validation
(``check_block`` under the ``device`` rung), on the GPU in phases, one JSON
line each, and fails (non-zero exit, no last line) if any phase fails:

1. card and build — the card's name and power limit, the kernel built from
   ``p1_tpu_torch/hashx/csrc/sha256d_search.cu`` with ``nvcc`` for
   ``sm_90a``, its registers and local-memory (spill) bytes, its SASS count;
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

Every ``bound_ms`` of the ``kernels`` line is taken at the card's peak
integer rate: the larger of the white paper's rate and the one phase 5
measured, at the larger of ``clocks.max.sm`` and the SM clock phase 5
measured; the white paper's bound rides beside it.  Then the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Without
a CUDA device it exits 2.  The four kernel sources are built at the start,
one ``nvcc`` each, all at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
import random
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
    from p1_tpu_torch.miner import Miner

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
    flagged = {}
    for name, i, corrupt in corruptions:
        bad = list(headers)
        bad[i] = corrupt(bad[i])
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
    kernel's entry of the ``kernels`` line."""
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
    }  # fmt: skip


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

    from p1_tpu_torch.benchmarks import vpu_roofline as vr
    from p1_tpu_torch.cli import mine_chain, mine_report
    from p1_tpu_torch.core import genesis_header, meets_target
    from p1_tpu_torch.core.hashutil import sha256d
    from p1_tpu_torch.hashx import cuda_ed25519, cuda_verify, get_backend, kernel_build, sass
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
    builds = kernel_build.build_all([
        (cb.SearchKernel.SOURCE, kernel_build.CSRC),
        (vr.RooflineKernel.SOURCE, vr.RooflineKernel.CSRC),
        (cuda_verify.VerifyKernel.SOURCE, kernel_build.CSRC),
        (cuda_ed25519.Ed25519Kernel.SOURCE, kernel_build.CSRC),
    ])  # fmt: skip
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
        "registers": regs, "local_bytes": local_bytes, "ptxas": spill_lines,
        "sass_instructions": sass_total, "sass_alu_instructions": sass_alu,
        "sass_opcodes": sass.opcode_histogram(search_insns),
        "sms": sms, "max_sm_mhz": max_sm_mhz,
    })  # fmt: skip

    # -- 2. kernel vs plain version ---------------------------------------
    cases = 0
    max_err = 0
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
    ed25519 = phase_ed25519(sass, sms, peak)

    print(json.dumps({"kernels": [
        {
            "name": "sha256d_search", "route": "cuda",
            "source": "p1_tpu_torch/hashx/csrc/sha256d_search.cu",
            "replaces": "p1_tpu/hashx/pallas_backend.py:67",
            "launches": launches, "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None,
            "bound_ms_white_paper": bound_wp_ms, "bound_ms_measured_rate": bound_measured_ms,
            "launches_replay": search_launches,
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
    sys.exit(main())
