"""Device time of the ``verify_chain`` kernel on one card, optionally beside
another checkout of the port.

    python -m p1_tpu_torch.benchmarks.verify_time [--against CHECKOUT]

A revision is timed through the wrapper that every revision of the port
keeps, ``cuda_verify.verify_chain(words, target, difficulty, cell)``, on a
linked difficulty-0 chain tiled to 10,000 headers (the ``replay`` launch)
and to 2**20 (``d0_chain_words``; the kernel hashes every header whatever
the result).  ``ms`` is one launch's device time from a CUDA graph of 50
launches (``graph_ms``); ``ms_enqueue`` is one call's share of 50 calls
from a host loop between events, which, where the kernel is shorter than
a call's host work, is the host's enqueue rate.

With ``--against``, the checkout at CHECKOUT (a directory that holds
``p1_tpu_torch``, e.g. ``git archive <commit> | tar -x -C build/parent``)
is timed too.  Each revision runs in a process of its own, with its own
package on the path and its own kernel build, in turns: the other, this,
this, the other.  Prints one JSON line per process, then the card's name
and power limit.  Needs a card.  ``chip_smoke.py`` times the kernel with
``time_launch`` on the chain its ``replay`` run mined.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import random
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve()
SIZES = (10_000, 1 << 20)
REPS = 50


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


def graph_ms(fn, reps: int = REPS) -> float:
    """Device milliseconds of one ``fn()`` launch: ``reps`` launches
    captured in one CUDA graph, replayed 5 times between events (median).
    The launches go on the capture stream, the current stream inside
    ``torch.cuda.graph``; no host work sits between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: loads the library, fills the caches
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[2]


def enqueue_ms(fn, reps: int = REPS) -> float:
    """Milliseconds per ``fn()`` call of ``reps`` calls from a host loop
    between events, after one untimed call."""
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


def time_launch(fn) -> dict:
    """``ms`` (device) and ``ms_enqueue`` (host loop) of the launch ``fn``."""
    return {"ms": graph_ms(fn), "ms_enqueue": enqueue_ms(fn)}


def _worker() -> dict:
    """Times the ``cuda_verify`` of the package on the path at ``SIZES``."""
    import numpy as np
    import torch

    from p1_tpu_torch.core import target_from_difficulty, target_to_words
    from p1_tpu_torch.hashx import cuda_verify

    if not torch.cuda.is_available():
        raise RuntimeError("verify_time measures the card and there is none")
    vk = cuda_verify.verify_chain
    target = target_to_words(target_from_difficulty(0))
    chain = d0_chain_words(10_000)
    rows = {}
    for n in SIZES:
        words = torch.from_numpy(np.resize(chain, (n, 20)).view(np.int32)).cuda()
        cell = torch.full((1,), n, dtype=torch.int32, device="cuda")
        rows[n] = time_launch(lambda w=words, c=cell: vk(w, target, 0, c))
    return {"package": str(pathlib.Path(cuda_verify.__file__).resolve().parents[2]), "rows": rows}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path, help="another checkout of the port")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker()), flush=True)
        return 0
    here = HERE.parents[2]
    order = [here]
    if args.against is not None:
        other = args.against.resolve()
        if not (other / "p1_tpu_torch" / "hashx" / "cuda_verify.py").is_file():
            raise SystemExit(f"{other} holds no p1_tpu_torch/hashx/cuda_verify.py")
        order = [other, here, here, other]
    for root in order:
        subprocess.run(
            [sys.executable, str(HERE), "--worker"],
            cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, check=True, timeout=900,
        )  # fmt: skip
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()  # fmt: skip
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
