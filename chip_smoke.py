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
   the operations bound from the SASS, and the batch × threads × sub sweep.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2.
"""

from __future__ import annotations

import json
import random
import re
import shutil
import subprocess
import sys
import time

DIFFICULTY = 20
BLOCKS = 10
NO_HIT = 64  # difficulty at which a step's whole batch is hashed
PLAIN_CHUNK = 1 << 22  # lanes per plain-version call (int64 lanes: ~GBs live)
#: Hopper: 4 sub-partitions per SM, each issuing one warp instruction per
#: clock (128 thread-instructions) of which 16 lanes are integer ALU (64 per
#: SM per clock: IADD3, LOP3, SHF, ISETP, ...) — NVIDIA H100 white paper.
DISPATCH_PER_SM_CLK = 128
ALU_PER_SM_CLK = 64
#: SASS opcodes that do not occupy the integer ALU pipe.
_NOT_ALU = re.compile(
    r"^(NOP|IMAD|IMUL|FFMA|FADD|FMUL|BRA|EXIT|BSSY|BSYNC|RET|CALL|WARPSYNC|BAR|"
    r"S2R|S2UR|CS2R|LD|ST|ATOM|RED|U[A-Z0-9]+)"
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip


def sass_counts(lib_path, kernel: str) -> tuple[int, int]:
    """(all instructions, integer-ALU instructions) of ``kernel``'s SASS,
    NOPs excluded.  The body is fully unrolled for one nonce, so the static
    count is one nonce's work plus a few tens of setup instructions."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
        check=True, timeout=120,
    ).stdout  # fmt: skip
    lib_path.with_suffix(".sass").write_text(sass)
    total = alu = 0
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            op = m.group(1)
            if op.startswith("NOP"):
                continue
            total += 1
            alu += not _NOT_ALU.match(op)
    if not total:
        raise RuntimeError(f"no SASS found for {kernel} in {lib_path}")
    return total, alu


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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs (events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from p1_tpu_torch.cli import mine_chain, mine_report
    from p1_tpu_torch.core import genesis_header, meets_target
    from p1_tpu_torch.core.hashutil import sha256d
    from p1_tpu_torch.hashx import get_backend
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
    built = kernel.built()
    regs, local_bytes = kernel.attributes()
    sass_total, sass_alu = sass_counts(built.path, "sha256d_search_kernel")
    spill_lines = [ln.strip() for ln in built.ptxas_log.splitlines() if "spill" in ln or "registers" in ln]
    emit({
        "phase": "build", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": round(built.build_s, 3), "library": built.path.name,
        "registers": regs, "local_bytes": local_bytes, "ptxas": spill_lines,
        "sass_instructions": sass_total, "sass_alu_instructions": sass_alu,
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
    clk_hz = max_sm_mhz * 1e6
    bound_ms = 1e3 * batch * max(
        sass_alu / (ALU_PER_SM_CLK * sms * clk_hz),
        sass_total / (DISPATCH_PER_SM_CLK * sms * clk_hz),
    )
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
        "plain_2p24_ms": plain_2p24_ms, "bound_ms": bound_ms,
        "bound_ghps": batch / bound_ms / 1e6, "sweep": sweep, "e2e_sweep": e2e,
    })  # fmt: skip

    emit({"kernels": [{
        "name": "sha256d_search", "route": "cuda",
        "source": "p1_tpu_torch/hashx/csrc/sha256d_search.cu",
        "replaces": "p1_tpu/hashx/pallas_backend.py:67",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations", "library_ms": None,
    }]})  # fmt: skip
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
