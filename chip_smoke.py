#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``p1_tpu_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path, ``mine``, on the GPU in phases, one JSON line
each, and fails (non-zero exit, no last line) if any phase fails:

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
6. replay — ``verify_chain.cu`` against the plain
   ``verify_header_chain_segments`` on the card on seeded fixtures; the
   ``replay`` command at --n 10000 --difficulty 16 (mined through the search
   kernel, verified by ``replay_host`` and ``replay_device``: the path whose
   launches are counted); corruptions that both must flag at the same
   index; the kernel against the plain version on the 10,000-header chain,
   and its time at 10,000 and 2**20 headers.

Every ``bound_ms`` of the ``kernels`` line is taken at the card's peak
integer rate: the larger of the white paper's rate and the one phase 5
measured, at the larger of ``clocks.max.sm`` and the SM clock phase 5
measured; the white paper's bound rides beside it.  Then the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Without
a CUDA device it exits 2.  The three kernels are built at the start, one
``nvcc`` each, all at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
import random
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

    def bound_ms(self, alu: float, insns: float, sms: int) -> float:
        """Least milliseconds for ``alu`` integer-ALU and ``insns``
        instructions in all (thread-instructions) on ``sms`` SMs."""
        hz = self.mhz * 1e6 * sms
        return 1e3 * max(alu / (self.alu_per_clk * hz), insns / (self.issue_per_clk * hz))


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


def d0_chain_words(n: int):
    """(n, 20) uint32 words of a linked difficulty-0 chain (every hash meets
    the all-ones target), built on the host with hashlib."""
    from p1_tpu_torch.chain import headers_to_words
    from p1_tpu_torch.core import BlockHeader, genesis_header

    rng = random.Random(n)
    headers = [genesis_header(0)]
    for _ in range(n - 1):
        parent = headers[-1]
        headers.append(BlockHeader(1, parent.block_hash(), rng.randbytes(32),
                                   parent.timestamp + 1, 0, rng.getrandbits(32)))  # fmt: skip
    return headers_to_words(headers)


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
    flat = cuda_verify.first_invalid(torch.from_numpy(words.view(np.int32)).cuda(), target, difficulty)
    want = cuda_verify.plain_first_invalid(
        torch.from_numpy(words3.astype(np.int64)).cuda(), target, difficulty
    )
    if padded != want or flat != min(want, len(words)):
        raise AssertionError(f"verify_chain padded {padded}, unpadded {flat}; plain {want}")
    return want


def phase_replay(cuda_verify, sass, sms: int, peak: Rate, white_paper: Rate) -> tuple[dict, int]:
    """Phase 6: the verify kernel against its plain version, the ``replay``
    command at BASELINE config 3, corruptions, timings.  Returns the
    kernel's entry of the ``kernels`` line and the search kernel's launches
    in the replay run."""
    import numpy as np
    import torch

    from p1_tpu_torch import cli
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

    # Kernel vs plain version on seeded fixtures.
    rng = np.random.default_rng(6)
    fixtures = []  # (name, words, segment, difficulty, expected or None)
    d0 = d0_chain_words(3000)
    fixtures.append(("d0 clean", d0, 1024, 0, 3000))
    for name, (i, word, xor) in {
        "d0 nonce flip": (int(rng.integers(1, 2999)), 19, 1),  # breaks the next link
        "d0 difficulty word": (int(rng.integers(1, 3000)), 18, 1),
        "d0 prev-hash word": (int(rng.integers(1, 3000)), 1 + int(rng.integers(0, 8)), 1 << 31),
        "d0 genesis prev-hash": (0, 3, 5),
        "d0 last nonce": (2999, 19, 1),  # no next header: still valid
    }.items():
        w = d0.copy()
        w[i, word] ^= xor
        expect = {"d0 nonce flip": i + 1, "d0 last nonce": 3000}.get(name, i)
        fixtures.append((name, w, 1024, 0, expect))
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
    regs, local_bytes = vk.attributes()
    v_total, v_alu = sass.sass_counts(vk.built().path, "verify_chain_kernel")
    emit({"phase": "verify_vs_plain", "cases": len(fixtures), "max_abs_err": 0,
          "first_invalid": results, "registers": regs, "local_bytes": local_bytes,
          "ptxas": ptxas_lines(vk.built().ptxas_log, "verify_chain_kernel"),
          "sass_instructions": v_total, "sass_alu_instructions": v_alu})  # fmt: skip

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
          "launches": {"sha256d_search": search_launches, "verify_chain": verify_launches}})  # fmt: skip

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

    # Timings: the kernel at 10,000 and 2**20 headers (a tiled chain: every
    # header is hashed whatever the result).
    timing = {}
    for label, n in (("10k", REPLAY_N), ("2p20", 1 << 20)):
        w = torch.from_numpy(np.resize(words, (n, 20)).view(np.int32)).cuda()
        cell = torch.full((1,), n, dtype=torch.int32, device="cuda")
        ms = cuda_ms(lambda: vk(w, target, REPLAY_DIFFICULTY, cell), reps=50)
        bytes_ms = 1e3 * 80 * n / HBM_BYTES_PER_S
        ops_ms = peak.bound_ms(n * v_alu, n * v_total, sms)
        timing[label] = {"n": n, "ms": ms, "headers_per_s": n / ms * 1e3,
                         "bound_ms": max(ops_ms, bytes_ms), "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
                         "ops_bound_ms_white_paper": white_paper.bound_ms(n * v_alu, n * v_total, sms)}  # fmt: skip
    tiled = parse_headers(np.resize(words, (1 << 20, 20)).astype(">u4").tobytes())
    e2e_2p20 = [replay_device(tiled) for _ in range(3)]
    emit({"phase": "replay_timing", "kernel": timing, "plain_ms_10k": plain_ms,
          "replay_device_2p20_s": [r.elapsed_s for r in e2e_2p20],
          "replay_device_2p20_headers_per_s": [r.headers_per_sec for r in e2e_2p20]})  # fmt: skip
    t10k = timing["10k"]
    return {
        "name": "verify_chain", "route": "cuda",
        "source": "p1_tpu_torch/hashx/csrc/verify_chain.cu",
        "replaces": "p1_tpu/hashx/jax_sha256.py:230", "replaces_kind": "XLA program, not Pallas",
        "launches": verify_launches, "max_abs_err": 0,
        "ms": t10k["ms"], "plain_ms": plain_ms, "bound_ms": t10k["bound_ms"],
        "bound_by": "operations" if t10k["ops_bound_ms"] >= t10k["bytes_bound_ms"] else "bytes",
        "library_ms": None,
        "bound_ms_white_paper": max(t10k["ops_bound_ms_white_paper"], t10k["bytes_bound_ms"]),
        "ms_2p20": timing["2p20"]["ms"], "bound_ms_2p20": timing["2p20"]["bound_ms"],
    }, search_launches  # fmt: skip


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from p1_tpu_torch.benchmarks import vpu_roofline as vr
    from p1_tpu_torch.cli import mine_chain, mine_report
    from p1_tpu_torch.core import genesis_header, meets_target
    from p1_tpu_torch.core.hashutil import sha256d
    from p1_tpu_torch.hashx import cuda_verify, get_backend, kernel_build, sass
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
    ]}), flush=True)  # fmt: skip
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
