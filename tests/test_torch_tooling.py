"""The port's store commands (``python -m p1_tpu_torch``) against the JAX package's.

Mirrors the offline-tooling cases of tests/test_cli.py and tests/test_chain.py
(``TestLedger.test_cli_balances_from_store``, ``TestCompact``): ``balances``,
``compact``, ``fsck``, ``snapshot``, ``keygen`` and ``sweep --backend cpu``
run through ``p1_tpu.cli.main`` and ``p1_tpu_torch.cli.main`` on copies of
the same store, each from a directory of its own so that the paths in the
reports read the same.  Both must give the same exit code and the same
JSON, and the files they write (compacted and salvaged stores, snapshots,
key files) must be byte-identical.  The port's store commands run with
``--device cpu``: the device signature rung on its plain PyTorch version.
Without a card and without ``--device cpu`` an untrusted load raises.

test_cli.py's ``node``, ``net``, ``tx``, ``status``, ``metrics``,
``account``, ``fees``, ``proof``, ``headers``, ``watch`` and ``maintain``
cases are in tests/test_torch_cli.py, test_chain.py's ``TestCompact``
in tests/test_torch_chain.py.  ``TestServe`` is test_cli.py's: a
read-only replica process over a port store, answering the port's client.
"""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from txutil import account, stx

from p1_tpu import cli as ref_cli
from p1_tpu.chain import ChainStore as RefStore
from p1_tpu.chain import SegmentedStore as RefSegmentedStore
from p1_tpu.chain import save_chain as ref_save_chain
from p1_tpu.chain.chain import Chain as RefChain
from p1_tpu.core import Block as RefBlock
from p1_tpu.core import BlockHeader as RefHeader
from p1_tpu.core import Transaction as RefTx
from p1_tpu.core import merkle_root as ref_merkle_root
from p1_tpu.hashx import get_backend as ref_get_backend
from p1_tpu.miner import Miner as RefMiner
from p1_tpu_torch import cli
from p1_tpu_torch.core import keys, sigcache

REPO = pathlib.Path(__file__).resolve().parent.parent
DIFF = 8
_MINER = RefMiner(backend=ref_get_backend("cpu"))


@pytest.fixture(autouse=True)
def _ladder_reset(monkeypatch):
    # Every command verifies its store's signatures afresh, as a new
    # process would: no proofs cached by an earlier case.
    monkeypatch.setattr(sigcache, "DEFAULT", sigcache.SignatureCache())
    yield
    keys.set_sig_backend(None)


def _mine(parent, txs, ts=1, version=1):
    header = RefHeader(version, parent.block_hash(), ref_merkle_root([t.txid() for t in txs]),
                       parent.header.timestamp + ts, DIFF, 0)  # fmt: skip
    return RefBlock(_MINER.search_nonce(header), tuple(txs))


@pytest.fixture(scope="module")
def chain_blocks():
    """12 main-chain blocks (alice mines, then pays bob three transfers a
    block) and a two-block side branch off height 9, all through the JAX
    package's chain."""
    chain = RefChain(DIFF)
    seq, side = 0, []
    for h in range(1, 13):
        txs = [RefTx.coinbase(account("alice"), h)]
        if h >= 3:
            txs += [stx("alice", account("bob"), 2, 1, seq + i, difficulty=DIFF) for i in range(3)]
            seq += 3
        blk = _mine(chain.tip, txs)
        assert chain.add_block(blk).status.value == "accepted"
        if h == 9:
            fork = _mine(blk, [RefTx.coinbase("loser", 10)], ts=2, version=2)
            side = [fork, _mine(fork, [RefTx.coinbase("loser", 11)], version=2)]
    for blk in side:
        assert chain.add_block(blk).status.value == "accepted"
    return chain, side


def _write(kind, path, chain_blocks):
    chain, side = chain_blocks
    if kind == "missing":
        return
    if kind == "segmented":
        store = RefSegmentedStore(path, segment_bytes=2000)
        for h, blk in enumerate(list(chain.main_chain())[1:], start=1):
            store.append(blk, height=h)
        store.close()
        return
    ref_save_chain(chain, path)
    if kind in ("forked", "corrupt"):
        store = RefStore(path)
        for blk in side:
            store.append(blk)
        store.close()
    if kind == "corrupt":
        data = bytearray(path.read_bytes())
        data[len(data) // 2] ^= 0x40
        path.write_bytes(bytes(data))


def _run(main, argv, capsys):
    capsys.readouterr()
    try:
        rc = main(argv)
    except SystemExit as exc:
        rc = exc.code
    out = capsys.readouterr().out
    return rc, [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _files(d):
    return {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


#: (case id, store kind, argv shared by both packages, whether the port
#: command takes --device); "{s}" is the store, "{f}" a second file.
CASES = [
    ("balances", "linear", ["balances", "--store", "{s}"], True),
    ("balances_account", "linear", ["balances", "--store", "{s}", "--account", account("bob")], True),
    ("balances_forked", "forked", ["balances", "--store", "{s}"], True),
    ("balances_wrong_difficulty", "linear", ["balances", "--store", "{s}", "--difficulty", "9"], True),
    ("balances_missing", "missing", ["balances", "--store", "{s}"], True),
    ("compact_out", "forked", ["compact", "--store", "{s}", "--out", "{f}"], True),
    ("compact_in_place", "forked", ["compact", "--store", "{s}"], True),
    ("compact_segmented", "segmented", ["compact", "--store", "{s}"], True),
    ("compact_missing", "missing", ["compact", "--store", "{s}"], True),
    ("fsck_clean", "linear", ["fsck", "--store", "{s}"], True),
    ("fsck_json", "forked", ["fsck", "--store", "{s}", "--json"], True),
    ("fsck_corrupt", "corrupt", ["fsck", "--store", "{s}", "--out", "{f}"], True),
    ("fsck_segmented", "segmented", ["fsck", "--store", "{s}", "--json"], True),
    ("fsck_missing", "missing", ["fsck", "--store", "{s}"], True),
    ("snapshot_create", "linear", ["snapshot", "create", "--store", "{s}", "--file", "{f}", "--interval", "4"], True),
    ("snapshot_create_default", "linear", ["snapshot", "create", "--store", "{s}", "--file", "{f}"], True),
    ("snapshot_create_no_file", "linear", ["snapshot", "create", "--store", "{s}"], True),
    ("keygen", "missing", ["keygen", "--out", "{f}", "--seed-text", "tooling"], False),
]


@pytest.mark.parametrize("name,kind,argv,takes_device", CASES, ids=[c[0] for c in CASES])
def test_same_exit_code_json_and_files(tmp_path, monkeypatch, capsys, chain_blocks, name, kind, argv, takes_device):
    results = {}
    for pkg, main in (("ref", ref_cli.main), ("port", cli.main)):
        d = tmp_path / pkg
        d.mkdir()
        _write(kind, d / "chain.dat", chain_blocks)
        monkeypatch.chdir(d)
        args = [a.format(s="chain.dat", f="out.dat") for a in argv]
        if pkg == "port" and takes_device:
            args += ["--device", "cpu"]
        rc, lines = _run(main, args, capsys)
        results[pkg] = rc, lines, _files(d)
    assert results["port"][:2] == results["ref"][:2]
    assert results["port"][2] == results["ref"][2]
    want_rc = {"missing": 2, "corrupt": 1}.get(kind, 0)
    # A 12-block chain has no checkpoint at the default interval (64).
    if name in ("balances_wrong_difficulty", "snapshot_create_no_file", "snapshot_create_default"):
        want_rc = 2
    if name == "keygen":
        want_rc = 0
    assert results["port"][0] == want_rc


@pytest.mark.parametrize("action", ["verify", "info"])
def test_snapshot_verify_and_info(tmp_path, monkeypatch, capsys, chain_blocks, action):
    monkeypatch.chdir(tmp_path)
    _write("linear", tmp_path / "chain.dat", chain_blocks)
    assert _run(ref_cli.main, ["snapshot", "create", "--store", "chain.dat", "--file", "s.p1s", "--interval", "4"], capsys)[0] == 0
    want = _run(ref_cli.main, ["snapshot", action, "--file", "s.p1s"], capsys)
    got = _run(cli.main, ["snapshot", action, "--file", "s.p1s", "--device", "cpu"], capsys)
    assert got == want and got[0] == 0
    with open("s.p1s", "ab") as fh:
        fh.write(b"rotten tail")
    assert _run(cli.main, ["snapshot", action, "--file", "s.p1s"], capsys) == _run(
        ref_cli.main, ["snapshot", action, "--file", "s.p1s"], capsys
    )


def test_keygen_refuses_to_overwrite(tmp_path, capsys):
    path = str(tmp_path / "k.json")
    assert _run(cli.main, ["keygen", "--out", path, "--seed-text", "a"], capsys)[0] == 0
    before = open(path, "rb").read()
    assert _run(cli.main, ["keygen", "--out", path, "--seed-text", "b"], capsys)[0] == 2
    assert open(path, "rb").read() == before
    rc, lines = _run(cli.main, ["keygen", "--out", path, "--seed-text", "b", "--force"], capsys)
    assert rc == 0 and lines[0]["account"] == keys.Keypair.from_seed_text("b").account


def test_sweep_cpu_backend_matches(capsys):
    argv = ["sweep", "--backend", "cpu", "--difficulties", "2,4", "--blocks", "2"]
    rc_ref, want = _run(ref_cli.main, argv, capsys)
    rc, got = _run(cli.main, [*argv, "--device", "cpu"], capsys)
    assert rc == rc_ref == 0
    timing = ("time_to_block_s", "hashes_per_sec", "total_s")
    strip = lambda rows: [{k: v for k, v in r.items() if k not in timing} for r in rows]  # noqa: E731
    assert strip(got) == strip(want)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]


def test_bad_sweep_spec_exits(capsys):
    with pytest.raises(SystemExit, match="bad difficulty spec"):
        cli.main(["sweep", "--backend", "cpu", "--device", "cpu", "--difficulties", "x"])


def test_store_command_without_a_card_raises(tmp_path, monkeypatch, chain_blocks):
    # The default --device is the card: an untrusted load's signature
    # window raises there, it is never verified on the host instead.
    _write("linear", tmp_path / "chain.dat", chain_blocks)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["balances", "--store", str(tmp_path / "chain.dat")])


def test_copy_of_store_loads_the_same_through_both_clis(tmp_path, capsys, chain_blocks):
    _write("forked", tmp_path / "a.dat", chain_blocks)
    shutil.copy(tmp_path / "a.dat", tmp_path / "b.dat")
    want = _run(ref_cli.main, ["balances", "--store", str(tmp_path / "a.dat")], capsys)
    got = _run(cli.main, ["balances", "--store", str(tmp_path / "b.dat"), "--device", "cpu"], capsys)
    assert got == want
    assert got[1][0]["height"] == 12 and got[1][0]["conserved"] is True


class TestServe:
    """`p1 serve`: a read-only replica worker process over a
    chain store — help smoke plus one subprocess e2e proving the JSON
    ready line, real query service, and the --deadline exit."""

    def test_help_smoke(self):
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch", "serve", "--help"],
            capture_output=True,
            text=True,
            timeout=110,
            cwd=REPO,
        )
        assert proc.returncode == 0
        assert "--store" in proc.stdout and "--workers" in proc.stdout

    def test_worker_count_validation(self, tmp_path):
        proc = subprocess.run(
            [
                sys.executable,
                "-m",
                "p1_tpu_torch",
                "serve",
                "--store",
                str(tmp_path / "x.dat"),
                "--port",
                "0",
                "--workers",
                "2",
            ],
            capture_output=True,
            text=True,
            timeout=110,
            cwd=REPO,
        )
        assert proc.returncode == 2
        assert "explicit --port" in proc.stderr

    def test_serve_e2e_queries_then_deadline_exit(self, tmp_path):
        import asyncio

        from p1_tpu_torch.chain import ChainStore
        from p1_tpu_torch.node.client import get_headers, get_status
        from p1_tpu_torch.node.testing import make_blocks

        store = tmp_path / "chain.dat"
        blocks = make_blocks(5, difficulty=12)
        s = ChainStore(store)
        try:
            for block in blocks[1:]:
                s.append(block)
        finally:
            s.close()
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "p1_tpu_torch",
                "serve",
                "--store",
                str(store),
                "--difficulty",
                "12",
                "--port",
                "0",
                "--deadline",
                "30",
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            cwd=REPO,
        )
        try:
            ready = json.loads(proc.stdout.readline())
            assert ready["config"] == "serve" and ready["height"] == 5

            async def _query():
                headers = await get_headers(
                    "127.0.0.1", ready["port"], 12
                )
                status = await get_status(
                    "127.0.0.1", ready["port"], 12
                )
                return headers, status

            headers, status = asyncio.run(_query())
            assert len(headers) == 6  # genesis + 5
            assert [h.block_hash() for h in headers] == [
                b.block_hash() for b in blocks
            ]
            assert status["role"] == "replica" and status["height"] == 5
        finally:
            proc.terminate()
            proc.wait(timeout=30)
