"""Signature-verification microbench of the port: its rungs, one harness.

    python -m p1_tpu_torch.benchmarks.sig_verify [--batch-sizes 64 256 1024 4096]
        [--device-batch 1024] [--device cpu] [--store-blocks N] [--against CHECKOUT]
    python -m p1_tpu_torch.benchmarks.sig_verify --fallback [--device-batch 1024]

The port of ``benchmarks/sig_verify.py``.  ``bench_micro`` times the rungs
the port has (``core/keys.py``): serial verifies (the native rung where it
builds, else pure Python), ``keys.verify_batch`` on the default ``device``
rung, and the verify-once cache.  ``bench_native`` puts the two host rungs
beside the card on one set of triples: a serial native verify, a
``--device-batch`` native batch (``_ed25519_native``), a serial
pure-Python verify, and ``verify_batch_device`` on the same batch, each in
µs per signature.  ``bench_device`` then times ``verify_batch_device`` on
one card at ``--device-batch`` signatures (default 1024 =
``keys.BATCH_CHUNK``) and at every ``--batch-sizes`` entry, as µs per
signature end to end and its split into host prep (parse, SHA-512,
coefficients, dedup, the encoding and scalar words), copy in, the kernels
(decompression, gate and MSM; CUDA events), read back and host close.
Both need a card and raise without one; ``--device cpu`` runs
``bench_micro`` and ``bench_native`` with the device rung on the plain
PyTorch version and has no device rows.  (``--device`` alone, or
``--device cuda``, is the default.)  ``--store-blocks N`` adds
``bench_revalidate``: an N-block store of two signed transfers a block
(``host_ingest.build_blocks``), loaded untrusted serially (the serial
rung, one verify per transfer), on the active batch rung, with the cache
warm, and trusted.  Prints one JSON line, then (on the card) the card's
name and power limit.

``--fallback`` times only the pure-Python rung (``bench_fallback``): ms
per signature serially and in one ``--device-batch`` batch, the figures
``core/keys.py``'s forced-fallback warning names
(``_ed25519.RECORDED_SERIAL_MS`` / ``RECORDED_BATCH_MS``), and
``bench``'s 400-block revalidation with batches forced onto it
(``perf_record.RECORDED_REVALIDATE_FALLBACK_BPS``); it needs no card.

With ``--against``, the checkout at CHECKOUT (a directory that holds
``p1_tpu_torch``, e.g. ``git archive <commit> | tar -x -C build/parent``)
is timed beside this one on the same triples: each revision, in a
process of its own with its own package on the path and its own kernel
build, runs its own ``device_split`` at every ``--batch-sizes`` entry and
times its own kernels at ``--device-batch`` from a CUDA graph
(``verify_time.graph_ms``), in turns: the other, this, this, the other.
Prints one JSON line per process, then the card's name and power limit.

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
import pathlib
import pickle
import random
import statistics
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve()

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
    out: dict = {"backend": active, "serial_backend": keys._serial_backend()}
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


def bench_native(batch: int = 1024, serial_n: int = 64, device: str = "cuda", repeats: int = 3) -> dict:
    """µs per signature of the host rungs and the card on one set of
    triples: ``serial_n`` serial native verifies, one native batch of
    ``batch``, ``serial_n // 4`` serial pure-Python verifies, and
    ``verify_batch_device`` on the same batch (``device``: the card, or
    the plain version on the CPU).  Raises if the native engine does not
    load or any verdict is not True."""
    from p1_tpu_torch.core import _ed25519, _ed25519_native
    from p1_tpu_torch.hashx import ed25519_msm

    if not _ed25519_native.available():
        raise RuntimeError("bench_native: the native Ed25519 engine did not build or load")
    triples = make_triples(max(batch, serial_n))
    serial, window = triples[:serial_n], triples[:batch]
    py_serial = serial[: max(1, serial_n // 4)]
    verdicts = [
        all(_ed25519_native.verify(*t) for t in serial),
        _ed25519_native.verify_batch(window),
        all(_ed25519.verify(*t) for t in py_serial),
        ed25519_msm.verify_batch_device(window, device=device),  # warm: loads the library
    ]
    if not all(verdicts):
        raise AssertionError(f"a valid set failed: {verdicts}")

    def us(fn, n: int) -> float:
        return 1e6 / _rate(fn, n, repeats)

    return {
        "native_impl": _ed25519_native.impl(),
        "native_serial_us": us(lambda: all(_ed25519_native.verify(*t) for t in serial), serial_n),
        f"native_batch{batch}_us": us(lambda: _ed25519_native.verify_batch(window), batch),
        "pure_python_serial_us": us(lambda: all(_ed25519.verify(*t) for t in py_serial), len(py_serial)),
        f"device_batch{batch}_us": us(lambda: ed25519_msm.verify_batch_device(window, device=device), batch),
        "device": device,
    }


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
        encodings, scalars = m.to_device(prep, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = cuda_ed25519.decode_gate_msm(encodings, scalars)
        end.record()
        end.synchronize()
        t3 = time.perf_counter()
        result = out.result.cpu().numpy()
        t4 = time.perf_counter()
        ok = m.close(result)
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
    return {"n": n, "points": int(encodings.shape[0]), "verdict": verdict,
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


def bench_revalidate(n_blocks: int, repeats: int = 3) -> dict:
    """Store revalidation three ways (median of ``repeats`` each), and the
    trusted resume: ``revalidate_serial_s`` disables the fast lane (no
    pre-verification window, every transfer verified alone on the
    serial rung), ``revalidate_batch_s`` runs it on the active batch
    rung (the card's under ``device``), ``revalidate_cached_s`` with every
    signature already in the cache."""
    from p1_tpu_torch.benchmarks.host_ingest import build_blocks
    from p1_tpu_torch.chain import store as store_mod
    from p1_tpu_torch.chain.store import ChainStore, save_chain
    from p1_tpu_torch.core import keys
    from p1_tpu_torch.core.sigcache import SignatureCache

    chain, _raws = build_blocks(n_blocks, 2, difficulty=1)
    out: dict = {"store_blocks": n_blocks, "store_signatures": 2 * (n_blocks - 1)}
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "bench.chain"
        save_chain(chain, path)

        def run(serial: bool, warm_cache=None) -> float:
            store = ChainStore(path)
            times = []
            for _ in range(repeats):
                cache = warm_cache if warm_cache is not None else SignatureCache()
                old_min, old_stream = keys.BATCH_MIN, store_mod._preverify_stream
                if serial:
                    # The fast lane off: per-tx backend calls.
                    keys.BATCH_MIN = 1 << 30
                    store_mod._preverify_stream = lambda blocks, tag, cache: blocks
                try:
                    t0 = time.perf_counter()
                    store.load_chain(1, trusted=False, sig_cache=cache)
                    times.append(time.perf_counter() - t0)
                finally:
                    keys.BATCH_MIN, store_mod._preverify_stream = old_min, old_stream
            store.close()
            return statistics.median(times)

        t_serial = run(serial=True)
        t_batch = run(serial=False)
        warm = SignatureCache()
        run(serial=False, warm_cache=warm)  # populate
        t_cached = run(serial=False, warm_cache=warm)
        trusted_store = ChainStore(path)
        t0 = time.perf_counter()
        trusted_store.load_chain(1, trusted=True)
        t_trusted = time.perf_counter() - t0
        trusted_store.close()
    out["revalidate_serial_s"] = t_serial
    out["revalidate_batch_s"] = t_batch
    out["revalidate_cached_s"] = t_cached
    out["trusted_resume_s"] = t_trusted
    out["revalidate_speedup"] = t_serial / t_batch
    out["revalidate_bps"] = n_blocks / t_batch
    out["revalidate_us_per_sig"] = 1e6 * t_batch / out["store_signatures"]
    return out


def bench_fallback(batch: int = 1024, serial_n: int = 16, store_blocks: int = 400) -> dict:
    """The pure-Python rung on this host: ms per signature of serial
    verifies and of one ``_ed25519.verify_batch`` of ``batch`` (the
    figures ``core/keys.py``'s forced-fallback warning names), and
    ``bench_revalidate(store_blocks)``'s blocks/s with batches forced onto
    it (``set_sig_backend("fallback")``; restored after)."""
    from p1_tpu_torch.core import _ed25519, keys

    triples = make_triples(batch)
    serial = triples[:serial_n]
    serial_ms = 1e3 / _rate(lambda: all(_ed25519.verify(*t) for t in serial), len(serial))
    if not _ed25519.verify_batch(triples):
        raise AssertionError("a valid batch failed on the pure-Python rung")
    batch_ms = 1e3 / _rate(lambda: _ed25519.verify_batch(triples), batch)
    saved = (keys._sig_backend, keys._sig_device)
    keys.set_sig_backend("fallback")
    try:
        reval = bench_revalidate(store_blocks)
    finally:
        keys.set_sig_backend(saved[0], device=saved[1] if saved[0] in (None, "device") else None)
    return {"fallback_batch": batch, "fallback_serial_ms": serial_ms, f"fallback_batch{batch}_ms": batch_ms,
            "revalidate_fallback_bps": reval["revalidate_bps"], "revalidate_fallback_blocks": store_blocks}  # fmt: skip


def kernel_launch(triples):
    """One launch of the kernels of the package on the path, on the batch
    ``prepare`` makes of ``triples`` (seeded coefficients), with its
    outputs allocated once: for ``verify_time.graph_ms``.  Takes both
    layouts of the wrapper: encodings in (decompression on the card), or
    decompressed points in and per-point products out (the layout before
    it)."""
    import torch

    from p1_tpu_torch.hashx import cuda_ed25519 as ce
    from p1_tpu_torch.hashx import ed25519_msm as m

    prep = m.prepare(triples, random.Random(len(triples)))
    inputs, scalars = m.to_device(prep, torch.device("cuda"))
    if hasattr(ce, "outputs_for"):
        out, partials = ce.outputs_for(inputs)
        return lambda: ce.ed25519_msm(inputs, scalars, out.decoded, out.flags, partials, out.result)
    # PR 4's layout: kept only to time that tree against this one (PERF.md's
    # PR 4 and PR 5 rows); it can go with the next change of the layout.
    products = torch.empty_like(inputs)
    flags = torch.empty(inputs.shape[0], dtype=torch.int32, device=inputs.device)
    result = torch.empty(ce.RESULT_LEN, dtype=torch.int32, device=inputs.device)
    return lambda: ce.ed25519_msm(inputs, scalars, products, flags, result)


def _worker(triples_path: str, batch: int, batch_sizes) -> dict:
    """``device_split`` and the kernels' graph time of the package on the
    path, on the pickled triples."""
    import torch

    from p1_tpu_torch.benchmarks import sig_verify as own
    from p1_tpu_torch.benchmarks.verify_time import graph_ms

    if not torch.cuda.is_available():
        raise RuntimeError("sig_verify measures the card and there is none")
    triples = pickle.loads(pathlib.Path(triples_path).read_bytes())
    rows = [own.device_split(triples[:n]) for n in sorted({batch, *batch_sizes})]
    if not all(r["verdict"] for r in rows):
        raise AssertionError(f"a valid batch failed on the card: {rows}")
    return {"package": str(pathlib.Path(own.__file__).resolve().parents[2]), "device_batch": batch,
            "kernel_ms": graph_ms(kernel_launch(triples[:batch])), "device_rows": rows}  # fmt: skip


def against(other: pathlib.Path, batch: int, batch_sizes) -> None:
    """This checkout and ``other`` in turns (other, this, this, other), each
    in its own process, on one set of triples."""
    other = other.resolve()
    if not (other / "p1_tpu_torch" / "hashx" / "cuda_ed25519.py").is_file():
        raise SystemExit(f"{other} holds no p1_tpu_torch/hashx/cuda_ed25519.py")
    here = HERE.parents[2]
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "triples.pickle"
        path.write_bytes(pickle.dumps(make_triples(max(batch, *batch_sizes))))
        for root in (other, here, here, other):
            cmd = [sys.executable, str(HERE), "--worker", str(path), "--device-batch", str(batch),
                   "--batch-sizes", *map(str, batch_sizes)]  # fmt: skip
            subprocess.run(cmd, cwd=root, env={**os.environ, "PYTHONPATH": str(root)}, check=True, timeout=900)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-sizes", type=int, nargs="*", default=[64, 256, 1024, 4096])
    ap.add_argument("--device", nargs="?", const="cuda", default="cuda", choices=["cuda", "cpu"],
                    help="where the device rung runs: the card (default) or the plain version on the CPU")  # fmt: skip
    ap.add_argument("--device-batch", type=int, default=1024, help="device window size")
    ap.add_argument("--store-blocks", type=int, default=0,
                    help="also build an N-block store (2 signed transfers a block) and time its "
                    "revalidation serial vs batch vs cached, and its trusted resume")  # fmt: skip
    ap.add_argument("--against", type=pathlib.Path, help="another checkout of the port, timed in turns")
    ap.add_argument("--fallback", action="store_true",
                    help="only the pure-Python rung: serial and batched ms per signature, and "
                    "bench's revalidation (400 blocks) with batches forced onto it")  # fmt: skip
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.worker, args.device_batch, tuple(args.batch_sizes))), flush=True)
        return 0
    if args.against is not None:
        against(args.against, args.device_batch, tuple(args.batch_sizes))
        print(_card(), flush=True)
        return 0
    from p1_tpu_torch.core import keys

    if args.fallback:
        print(json.dumps({**bench_fallback(args.device_batch), "cpu_count": os.cpu_count()}), flush=True)
        return 0
    keys.set_sig_backend("device", device=args.device)
    result = bench_micro(tuple(args.batch_sizes))
    result.update(bench_native(args.device_batch, device=args.device))
    if args.store_blocks:
        result.update(bench_revalidate(args.store_blocks))
    if args.device == "cuda":
        result.update(bench_device(args.device_batch, tuple(args.batch_sizes)))
    result["cpu_count"] = os.cpu_count()
    print(json.dumps(result), flush=True)
    if args.device == "cuda":
        print(_card(), flush=True)
    return 0


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()  # fmt: skip


if __name__ == "__main__":
    raise SystemExit(main())
