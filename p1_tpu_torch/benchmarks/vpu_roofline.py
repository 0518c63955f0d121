"""Integer-ALU roofline of the card: the port of ``benchmarks/vpu_roofline.py``.

    python -m p1_tpu_torch.benchmarks.vpu_roofline --count   # op count only
    python -m p1_tpu_torch.benchmarks.vpu_roofline           # on the card

Two measurements, as in the reference:

1. ``--count``: the static op count of one SHA-256d candidate as the
   reference's kernel traces it (``count_ops``, a copy: no hardware).
2. default: ``chains`` independent uint32 x/y op chains per lane in four op
   mixes, from pure adds to SHA-round-like bodies, XOR-folded per lane; the
   min over each grid step's 2,048 lanes is XORed into one int32.  The
   kernel is ``csrc/int_roofline.cu``; its plain PyTorch version is
   ``bench_step``.  ``run_bench`` times each mix × chains ∈ {4, 8} with
   CUDA events and states the rate in the reference's op units
   (``OPS_PER_ITER``) and in integer-ALU SASS instructions, counted from
   the built kernel's loop body, per clock per SM at the SM clock that the
   kernel itself samples (``clock64`` against ``%globaltimer``).  That rate
   is what the bound of the SHA-256d search kernel assumes from the Hopper
   white paper (``hashx/sass.py``: 64 per clock per SM).

The chains stay unfoldable (mutually recursive), per-lane (seeded from the
lane index) and per-block (seeded from the grid index), as the reference
requires.  The reference's dispatch-subtraction caveat belongs to its TPU
relay; here each launch is timed on the card by events.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import pathlib
import statistics

import torch

from p1_tpu_torch.hashx import kernel_build, sass

MASK32 = 0xFFFFFFFF

# ---------------------------------------------------------------- op count


def count_ops() -> dict:
    """Static per-candidate op counts of the traced kernel math."""

    class T:  # tagged operand: C compile-time const, S scalar, V vector
        def __init__(self, kind):
            self.kind = kind

    count = {"V": 0, "S": 0, "naive": 0}

    def op(*args):
        count["naive"] += 1
        kinds = {a.kind for a in args}
        if kinds == {"C"}:
            return T("C")  # folds at compile time
        if "V" in kinds:
            count["V"] += 1
            return T("V")
        count["S"] += 1  # scalar-core op, off the VPU
        return T("S")

    def rotr(x):  # two shifts + or, as _rotr writes it
        return op(op(x), op(x))

    def xor3(a, b, c):
        return op(op(a, b), c)

    def compress(state, w):
        s, w = list(state), list(w)
        for _ in range(64):
            a, b, c, d, e, f, g, h = s
            s1 = xor3(rotr(e), rotr(e), rotr(e))
            ch = op(op(e, f), op(op(e), g))  # (e&f) ^ (~e & g)
            t1 = op(op(op(op(h, s1), ch), T("C")), w[0])  # + k + w0
            s0 = xor3(rotr(a), rotr(a), rotr(a))
            maj = xor3(op(a, b), op(a, c), op(b, c))
            sig0 = xor3(rotr(w[1]), rotr(w[1]), op(w[1]))
            sig1 = xor3(rotr(w[14]), rotr(w[14]), op(w[14]))
            w_next = op(op(op(w[0], sig0), w[9]), sig1)
            s = [op(op(t1, s0), maj), a, b, c, op(d, t1), e, f, g]
            w = w[1:] + [w_next]
        return [op(x, y) for x, y in zip(state, s)]

    # Pass 1 chunk 2: midstate/tail are runtime scalars, nonce is the one
    # vector input, padding/length are constants.
    state1 = compress([T("S")] * 8, [T("S")] * 3 + [T("V")] + [T("C")] * 12)
    # Pass 2: the digest words are vectors, padding constants, IV constant.
    digest = compress([T("C")] * 8, state1 + [T("C")] * 8)
    # Target check (below_target): per word cmp, and, or, cmp, and.
    for d in digest:
        op(d, T("S")), op(T("V")), op(T("V")), op(d, T("S")), op(T("V"))
    for _ in range(6):  # flat-nonce computation + where/min plumbing
        op(T("V"))
    return count


# ------------------------------------------------------------- microbench

SUB = 16  # tile rows, same as the search kernel
LANES = SUB * 128  # lanes per grid step
INNER = 16  # iterations per unrolled loop body
OPS_PER_ITER = {"add": 2, "rot": 8, "sha": 11, "round": 30}
MIXES = tuple(OPS_PER_ITER)
#: Chain counts the kernel is instantiated for (``bench_step`` takes any).
KERNEL_CHAINS = (1, 4, 8)
#: The grid ``run_bench`` times at: 528 = 4 × 132 SMs, whole waves on an
#: H100 (the reference's 512 leaves a ragged last wave).
GRID = 528
REF_OPS = 2.0e12  # reference op units per timed launch (its sizing)
BENCH_CHAINS = (4, 8)  # the reference's
REPS = 3  # timed launches per row; the best counts, as in the reference


def seeds_for(chains: int, rep: int = 0) -> list[int]:
    """The reference's seeds: ``arange(1, chains+1) * 0x01000193 + rep``."""
    return [(j * 0x01000193 + rep) & MASK32 for j in range(1, chains + 1)]


def iters_for(mix: str, chains: int) -> int:
    """The reference's sizing at ``GRID``: ~``REF_OPS`` op units per launch,
    a multiple of 16 iterations, at least 256."""
    ops = OPS_PER_ITER[mix]
    return max(256, int(REF_OPS / (GRID * chains * LANES * ops)) // INNER * INNER)


def _rot(v, n: int):
    return ((v >> n) | (v << (32 - n))) & MASK32


def _one(x, y, mix: str):
    if mix == "add":  # 2 ops/iter
        x = (x + y) & MASK32
        y = y ^ x
    elif mix == "rot":  # 8 ops/iter
        x = _rot(x, 7) ^ _rot(y, 18)
        y = (y + x) & MASK32
    elif mix == "sha":  # σ0-like, 11 ops/iter
        s = _rot(x, 7) ^ _rot(x, 18) ^ (x >> 3)
        x = s ^ y
        y = (y + x) & MASK32
    else:  # "round": SHA-round-like body, 30 ops/iter
        s1 = _rot(x, 6) ^ _rot(x, 11) ^ _rot(x, 25)
        ch = (x & y) ^ ((x ^ MASK32) & ((y + 1) & MASK32))
        t1 = (y + s1 + ch + 0x428A2F98) & MASK32
        s0 = _rot(t1, 2) ^ _rot(t1, 13) ^ _rot(t1, 22)
        x = (t1 + s0) & MASK32
        y = y ^ x
    return x, y


def _check(seeds, grid: int, iters: int, chains: int, mix: str) -> None:
    if mix not in OPS_PER_ITER:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    if len(seeds) != chains or chains < 1:
        raise ValueError(f"expected {chains} seeds (chains >= 1), got {len(seeds)}")
    if not 1 <= grid < 1 << 31 or iters < 0:
        raise ValueError(f"grid={grid} must be in 1..2**31-1 and iters={iters} >= 0")


def bench_step(
    seeds, grid: int, iters: int, chains: int, mix: str, device="cuda"
) -> torch.Tensor:
    """The plain version of the kernel: (1,) int32, what ``_bench_kernel``
    leaves in its output cell.

    Words ride in int64 lanes masked to 32 bits (PyTorch's ``uint32`` has
    no ``>>``, ``+``, ``~`` or ``min``); the chains are a leading dimension,
    so one op covers every chain of every lane of every grid step."""
    _check(seeds, grid, iters, chains, mix)
    lane = torch.arange(LANES, dtype=torch.int64, device=device)
    gi = torch.arange(grid, dtype=torch.int64, device=device)[:, None]
    s = torch.tensor([int(v) & MASK32 for v in seeds], dtype=torch.int64, device=device)
    s = s[:, None, None]
    x = (s + lane + ((gi * 0x85EBCA6B) & MASK32)) & MASK32
    y = ((s ^ 0x9E3779B9) + (((lane ^ gi) * 2654435761) & MASK32)) & MASK32
    for _ in range(iters // INNER * INNER):
        x, y = _one(x, y, mix)
    acc = functools.reduce(torch.bitwise_xor, [*x, *y])  # (grid, LANES)
    signed = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)  # astype(int32)
    out = functools.reduce(lambda a, b: a ^ b, signed.min(dim=1).values.tolist())
    return torch.tensor([out], dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class KernelInfo:
    """What the build says of one (mix, chains) instance of the kernel."""

    registers: int
    local_bytes: int  # local memory (spills) per thread
    threads: int  # per block
    blocks_per_sm: int  # resident at once (occupancy)


class RooflineKernel:
    """Wrapper of ``csrc/int_roofline.cu``: builds the library on first use
    and counts launches (``launches``, one per kernel launch)."""

    SOURCE = "int_roofline.cu"
    CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

    def __init__(self) -> None:
        self.launches = 0
        self._built: kernel_build.BuiltKernel | None = None
        self._sass: str | None = None

    def built(self) -> kernel_build.BuiltKernel:
        if self._built is None:
            built = kernel_build.build(self.SOURCE, self.CSRC)
            built.lib.p1_int_roofline.argtypes = [
                ctypes.c_int,  # mix (index into MIXES)
                ctypes.c_int,  # chains
                ctypes.POINTER(ctypes.c_uint32),  # seeds (chains,)
                ctypes.c_int,  # grid
                ctypes.c_int,  # outer loop count = iters // 16
                ctypes.c_void_p,  # out (device int32 cell)
                ctypes.c_void_p,  # probe (device u64 (grid, 2)) or NULL
                ctypes.c_void_p,  # stream
            ]
            built.lib.p1_int_roofline.restype = ctypes.c_int
            built.lib.p1_int_roofline_attrs.argtypes = [ctypes.c_int, ctypes.c_int] + [
                ctypes.POINTER(ctypes.c_int)
            ] * 4
            built.lib.p1_int_roofline_attrs.restype = ctypes.c_int
            self._built = built
        return self._built

    def info(self, mix: str, chains: int) -> KernelInfo:
        vals = [ctypes.c_int() for _ in range(4)]
        err = self.built().lib.p1_int_roofline_attrs(
            MIXES.index(mix), chains, *[ctypes.byref(v) for v in vals]
        )
        if err:
            raise RuntimeError(f"int_roofline attributes failed: CUDA error {err}")
        return KernelInfo(*(v.value for v in vals))

    def loop_insns(self, mix: str, chains: int) -> list[sass.Insn]:
        """The SASS of the instance's main loop: ``INNER`` iterations of
        every chain of every lane a thread carries, plus the loop's own
        counter, compare and branch."""
        if self._sass is None:
            self._sass = sass.disassemble(self.built().path)
        name = f"int_roofline_kernelILi{MIXES.index(mix)}ELi{chains}EE"
        return sass.loop_body(sass.function_insns(self._sass, name))

    def __call__(
        self,
        seeds,
        grid: int,
        iters: int,
        chains: int,
        mix: str,
        out: torch.Tensor,
        probe: torch.Tensor | None = None,
    ) -> None:
        """Launch on the current stream of ``out``'s device; ``out`` is a
        (1,) int32 CUDA cell that already holds 0.  ``probe``, a (grid, 2)
        int64 CUDA tensor, receives each block's SM cycles and nanoseconds."""
        _check(seeds, grid, iters, chains, mix)
        if chains not in KERNEL_CHAINS:
            raise ValueError(f"the kernel takes chains in {KERNEL_CHAINS}, got {chains}")
        if not (out.is_cuda and out.dtype == torch.int32 and out.numel() == 1):
            raise ValueError("out must be a one-element int32 CUDA tensor")
        if iters // INNER >= 1 << 31:
            raise ValueError(f"iters={iters} out of range")
        if probe is not None and not (
            probe.device == out.device and probe.dtype == torch.int64
            and probe.shape == (grid, 2) and probe.is_contiguous()
        ):  # fmt: skip
            raise ValueError(f"probe must be a contiguous (grid, 2) int64 tensor on {out.device}")
        fn = self.built().lib.p1_int_roofline
        with torch.cuda.device(out.device):
            err = fn(
                MIXES.index(mix),
                chains,
                (ctypes.c_uint32 * chains)(*[int(v) & MASK32 for v in seeds]),
                grid,
                iters // INNER,
                out.data_ptr(),
                None if probe is None else probe.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
        if err:
            raise RuntimeError(f"int_roofline launch failed: CUDA error {err}")
        self.launches += 1


#: The one wrapper of the roofline kernel in this process.
int_roofline = RooflineKernel()


def roofline_step(
    seeds, grid: int, iters: int, chains: int, mix: str, device="cuda", probe=None
) -> torch.Tensor:
    """One launch of the microbenchmark on ``device``: (1,) int32.  A CUDA
    device launches the kernel or raises; the CPU runs ``bench_step``."""
    device = torch.device(device)
    if device.type == "cpu":
        return bench_step(seeds, grid, iters, chains, mix, device)
    if device.type != "cuda":
        raise ValueError(f"no roofline kernel for device {device}")
    out = torch.zeros((1,), dtype=torch.int32, device=device)
    int_roofline(seeds, grid, iters, chains, mix, out, probe)
    return out


@dataclasses.dataclass(frozen=True)
class LoopCounts:
    """SASS of one instance's loop body, per chain-lane iteration."""

    insns: int  # all instructions in the loop body
    alu: int  # integer-ALU instructions in the loop body
    per_iter: int  # chain-lane iterations one pass of the body does

    @property
    def alu_per_iter(self) -> float:
        return self.alu / self.per_iter

    @property
    def insns_per_iter(self) -> float:
        return self.insns / self.per_iter


def loop_counts(mix: str, chains: int) -> LoopCounts:
    body = int_roofline.loop_insns(mix, chains)
    total, alu = sass.counts(body)
    lanes_per_thread = LANES // int_roofline.info(mix, chains).threads
    return LoopCounts(total, alu, INNER * lanes_per_thread * chains)


def run_bench() -> list[dict]:
    """Time every mix × ``BENCH_CHAINS`` on the card and print the table;
    one row each.  A row's ``out`` is the cell of its last timed launch,
    whose seeds are ``seeds_for(chains, REPS)``.  Needs a card: it measures
    the card and nothing else."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline measures a CUDA device and none is available")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("device:", torch.cuda.get_device_name(0), f"({sms} SMs)", flush=True)
    grid = GRID
    rows = []
    for mix in MIXES:
        for chains in BENCH_CHAINS:
            iters = iters_for(mix, chains)
            roofline_step(seeds_for(chains), grid, iters, chains, mix)  # warm
            probe = torch.zeros((grid, 2), dtype=torch.int64, device="cuda")
            times, mhz = [], []
            for k in range(REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = roofline_step(seeds_for(chains, k + 1), grid, iters, chains, mix, probe=probe)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                cycles, ns = probe[:, 0].double(), probe[:, 1].double()
                mhz.append(float((cycles / ns).median()) * 1e3)
            ms = min(times)
            sm_mhz = statistics.median(mhz)
            lc = loop_counts(mix, chains)
            info = int_roofline.info(mix, chains)
            passes = iters // INNER * info.threads * grid  # loop-body passes
            cycles_sm = ms * 1e-3 * sm_mhz * 1e6 * sms
            rows.append({
                "mix": mix, "chains": chains, "grid": grid, "iters": iters,
                "out": int(out[0]), "ms": ms, "ref_ops_per_s": grid * iters * chains * LANES * OPS_PER_ITER[mix] / (ms * 1e-3),
                "sass_per_iter": lc.insns_per_iter, "alu_per_iter": lc.alu_per_iter,
                "alu_inst_per_s": passes * lc.alu / (ms * 1e-3),
                "sm_mhz": sm_mhz, "block_ms": float(probe[:, 1].double().median()) * 1e-6,
                "alu_per_clk_sm": passes * lc.alu / cycles_sm,
                "issue_per_clk_sm": passes * lc.insns / cycles_sm,
                "registers": info.registers, "local_bytes": info.local_bytes,
                "threads": info.threads, "blocks_per_sm": info.blocks_per_sm,
            })  # fmt: skip
    print(f"{'mix':>6} {'chains':>6} {'ms':>8} {'Top/s':>7} {'ALU/iter':>8} "
          f"{'ALU Ginst/s':>11} {'SM MHz':>7} {'ALU/clk/SM':>10} {'inst/clk/SM':>11} {'regs':>4}")  # fmt: skip
    for r in rows:
        print(f"{r['mix']:>6} {r['chains']:>6} {r['ms']:8.3f} {r['ref_ops_per_s'] / 1e12:7.2f} "
              f"{r['alu_per_iter']:8.3f} {r['alu_inst_per_s'] / 1e9:11.1f} {r['sm_mhz']:7.1f} "
              f"{r['alu_per_clk_sm']:10.2f} {r['issue_per_clk_sm']:11.2f} {r['registers']:>4}")  # fmt: skip
    print(f"white paper: {sass.ALU_PER_SM_CLK} integer-ALU lanes per clock per SM")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m p1_tpu_torch.benchmarks.vpu_roofline")
    ap.add_argument("--count", action="store_true", help="op count only")
    args = ap.parse_args(argv)
    c = count_ops()
    print(
        f"per-candidate SHA-256d ops as traced: naive {c['naive']} "
        f"(every shift/or/xor/add/and/not = 1); fold model: "
        f"{c['V']} vector ops on the VPU + {c['S']} scalar-core ops"
    )
    if not args.count:
        run_bench()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
