"""Signature-verification microbench of the port: its rungs, one harness.

    python -m p1_tpu_torch.benchmarks.sig_verify [--batch-sizes 64 256 1024 4096]
        [--device-batch 1024] [--device cpu]

The port of ``benchmarks/sig_verify.py``.  ``bench_micro`` times the rungs
the port has (``core/keys.py``): serial verifies (pure-Python),
``keys.verify_batch`` on the default ``device`` rung, and the verify-once
cache.  ``bench_device`` then times ``verify_batch_device`` on one card
at ``--device-batch`` signatures (default 1024 = ``keys.BATCH_CHUNK``)
and at every ``--batch-sizes`` entry, as µs per signature end to end and
its split into host prep (parse, decompress, SHA-512, coefficients,
dedup, limb encoding), copy in, the kernels (CUDA events), read back and
host close.  Both need a card and raise without one; ``--device cpu``
runs ``bench_micro`` with the device rung on the plain PyTorch version
and has no device rows.  (``--device`` alone, or ``--device cuda``, is
the default.)  The store revalidation of the JAX package's bench
(``bench_revalidate``) needs the chain store and comes with the ``node``
slice.  Prints one JSON line, then (on the card) the card's name and
power limit.

The triples are the JAX package's: eight keypairs ``sigbench-0..7``
signing ``b"sig-verify-bench-%d"``, signed in worker processes
(``sign_many``) because pure-Python signing is a ladder per signature.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import multiprocessing
import os
import subprocess
import time

#: The bench's eight signing seeds (``Keypair.from_seed_text``'s seeds).
SEEDS = tuple(hashlib.sha256(f"sigbench-{i}".encode()).digest() for i in range(8))


def _sign_all(items) -> list[bytes]:
    from p1_tpu_torch.core import _ed25519

    return [_ed25519.sign(seed, msg) for seed, msg in items]


def sign_many(items) -> list[bytes]:
    """The RFC 8032 signatures of ``(seed, message)`` pairs, in order,
    signed by one process per core (none for a few dozen pairs); the
    processes end with the call."""
    items = list(items)
    workers = min(os.cpu_count() or 1, max(1, len(items) // 64))
    if workers <= 1:
        return _sign_all(items)
    step = -(-len(items) // workers)
    chunks = [items[i : i + step] for i in range(0, len(items), step)]
    ctx = multiprocessing.get_context("spawn")  # the parent may hold a CUDA context
    with concurrent.futures.ProcessPoolExecutor(len(chunks), mp_context=ctx) as ex:
        return [sig for part in ex.map(_sign_all, chunks) for sig in part]


def make_triples(n: int) -> list[tuple[bytes, bytes, bytes]]:
    """``n`` (pubkey, sig, message) triples from the bench's eight keys."""
    from p1_tpu_torch.core import _ed25519

    pubs = [_ed25519.public_key(seed) for seed in SEEDS]
    msgs = [b"sig-verify-bench-%d" % i for i in range(n)]
    sigs = sign_many((SEEDS[i % 8], msgs[i]) for i in range(n))
    return [(pubs[i % 8], sigs[i], msgs[i]) for i in range(n)]


#: Encodings of small-order points: order 2 (y = p - 1), order 4 (y = 0),
#: order 8 (one of the four).
T2_ENC = ((1 << 255) - 20).to_bytes(32, "little")
T4_ENC = bytes(32)
T8_ENC = bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05")


def torsion_triple(*, cancel: bool) -> tuple[bytes, bytes, bytes]:
    """A (pubkey, sig, message) triple carrying small-order torsion (the
    fixtures of the JAX package's tests/test_ed25519_device.py:49).
    cancel=True: order-2 torsion in both A and R with an odd challenge,
    so the serial equation ACCEPTS and the subgroup gate rejects;
    cancel=False: order-4 torsion in R only, rejected by both."""
    from p1_tpu_torch.core import _ed25519 as e

    a, prefix = e._secret_expand(bytes(32))
    torsion = e._pt_decompress(T2_ENC if cancel else T4_ENC)
    a_pt = e._pt_mul(a, e._B)
    pub = e._pt_compress(e._pt_add(a_pt, torsion) if cancel else a_pt)
    for i in range(200):
        msg = b"dev-torsion-%d" % i
        r = int.from_bytes(e._sha512(prefix + msg), "little") % e._Q
        r_enc = e._pt_compress(e._pt_add(e._pt_mul(r, e._B), torsion))
        k = int.from_bytes(e._sha512(r_enc + pub + msg), "little") % e._Q
        if cancel and k % 2 == 0:
            continue
        return pub, r_enc + ((r + k * a) % e._Q).to_bytes(32, "little"), msg
    raise AssertionError("no usable k")


def _rate(fn, payload_sigs: int, repeats: int = 3) -> float:
    """Best-of-N signatures/second for ``fn()`` covering ``payload_sigs``."""
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = max(best, payload_sigs / (time.perf_counter() - t0))
    return best


def bench_micro(batch_sizes=(64, 256, 1024, 4096), serial_n: int = 64) -> dict:
    """Serial, batched (active rung) and cached µs per signature."""
    from p1_tpu_torch.core import _ed25519, keys
    from p1_tpu_torch.core.genesis import genesis_hash
    from p1_tpu_torch.core.sigcache import SignatureCache
    from p1_tpu_torch.core.tx import Transaction

    active = keys.backend()
    out: dict = {"backend": active}
    triples = make_triples(max((serial_n, *batch_sizes)))
    serial = triples[:serial_n]
    out["serial_us"] = 1e6 / _rate(lambda: all(keys.verify(*t) for t in serial), serial_n)
    for n in batch_sizes:
        tr = triples[:n]
        _ed25519._pubkey_point.cache_clear()
        out[f"batch{n}_us"] = 1e6 / _rate(lambda: keys.verify_batch(tr), n)
    out["batch_speedup"] = out["serial_us"] / out[f"batch{max(batch_sizes)}_us"]

    # Cached path: the verify-once memo a block connect hits for
    # mempool-resident transfers (txid-keyed, core/sigcache.py).
    cache = SignatureCache()
    tag = genesis_hash(8)
    unsigned = [Transaction(keys.account_id(triples[0][0]), "r", 1, 0, i, chain=tag) for i in range(256)]
    sigs = sign_many((SEEDS[0], tx.signing_bytes()) for tx in unsigned)
    txs = [
        Transaction(tx.sender, tx.recipient, tx.amount, tx.fee, tx.seq, triples[0][0], sig, tag)
        for tx, sig in zip(unsigned, sigs)
    ]
    for tx in txs:
        tx.verify_signature(cache=cache)  # populate
    out["cached_us"] = 1e6 / _rate(lambda: all(tx.verify_signature(cache=cache) for tx in txs), len(txs))
    return out


def device_split(triples, repeats: int = 3) -> dict:
    """``verify_batch_device`` on the card: µs per signature end to end
    (best of ``repeats`` calls) and, from the best of ``repeats`` runs of
    the same stages with a synchronise between them, its split."""
    import torch

    from p1_tpu_torch.hashx import cuda_ed25519
    from p1_tpu_torch.hashx import ed25519_msm as m

    dev = m.resolve_device("cuda")
    n = len(triples)
    verdict = m.verify_batch_device(triples)  # warm: loads the library
    end_to_end = 1e6 / _rate(lambda: m.verify_batch_device(triples), n, repeats)
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        prep = m.prepare(triples)
        t1 = time.perf_counter()
        points, scalars = m.to_device(prep, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = cuda_ed25519.gate_msm(points, scalars)
        end.record()
        end.synchronize()
        t3 = time.perf_counter()
        result = out.result.cpu().numpy()
        t4 = time.perf_counter()
        ok = m.close(result, prep.s_total)
        t5 = time.perf_counter()
        if ok != verdict:
            raise AssertionError(f"staged verdict {ok} != verify_batch_device's {verdict}")
        row = {
            "host_prep_us": (t1 - t0) * 1e6 / n,
            "copy_in_us": (t2 - t1) * 1e6 / n,
            "kernel_us": start.elapsed_time(end) * 1e3 / n,
            "kernel_host_us": (t3 - t2) * 1e6 / n,
            "read_back_us": (t4 - t3) * 1e6 / n,
            "close_us": (t5 - t4) * 1e6 / n,
            "staged_us": (t5 - t0) * 1e6 / n,
        }
        if best is None or row["staged_us"] < best["staged_us"]:
            best = row
    return {"n": n, "points": int(points.shape[0]), "verdict": verdict,
            "us_per_sig": end_to_end, "sigs_per_s": 1e6 / end_to_end, **best}  # fmt: skip


def bench_device(batch: int = 1024, batch_sizes=(64, 256, 1024, 4096), repeats: int = 3) -> dict:
    """``device_split`` at ``batch`` and at every size of ``batch_sizes``
    on one card; the device rows' key is ``device_rows``."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_device measures the card and there is none")
    triples = make_triples(max(batch, *batch_sizes))
    rows = [device_split(triples[:n], repeats) for n in sorted({batch, *batch_sizes})]
    if not all(r["verdict"] for r in rows):
        raise AssertionError(f"a valid batch failed on the card: {rows}")
    main = next(r for r in rows if r["n"] == batch)
    return {"device_batch": batch, "device_name": torch.cuda.get_device_name(0),
            "device_us_per_sig": main["us_per_sig"], "device_rows": rows}  # fmt: skip


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-sizes", type=int, nargs="*", default=[64, 256, 1024, 4096])
    ap.add_argument("--device", nargs="?", const="cuda", default="cuda", choices=["cuda", "cpu"],
                    help="where the device rung runs: the card (default) or the plain version on the CPU")  # fmt: skip
    ap.add_argument("--device-batch", type=int, default=1024, help="device window size")
    args = ap.parse_args(argv)
    from p1_tpu_torch.core import keys

    keys.set_sig_backend("device", device=args.device)
    result = bench_micro(tuple(args.batch_sizes))
    if args.device == "cuda":
        result.update(bench_device(args.device_batch, tuple(args.batch_sizes)))
    result["cpu_count"] = os.cpu_count()
    print(json.dumps(result), flush=True)
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()  # fmt: skip
        print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
