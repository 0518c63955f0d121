"""The port's node, net and client commands (``python -m p1_tpu_torch``).

Mirrors the node cases of tests/test_cli.py (``TestCli``'s ``net``,
``keygen``/``tx``/``proof``/``headers``/``account`` drive and bad
retarget pair, ``TestAutoFeeCap``, ``TestStatus``, ``TestMetricsCLI``,
``TestByzantineSoak``, ``TestRetargetWalletE2E``, ``TestWatchCLI``,
``TestMaintain``): the reference's cases, run against the port's CLI with
``--backend cpu --device cpu`` on every node and net (hashlib mining, the
signature rung's plain version).  Their net base ports are the
reference's plus 2,000, so both files can run at once.  ``TestDevice``
holds the port's own contract: without a card and without ``--device
cpu`` a node or net exits non-zero, and ``--verify-workers`` is reported.
``TestNetRelayBench`` runs ``benchmarks/net_relay.py`` at a small size.
``TestNativeTier`` runs the native host tier's commands: ``replay
--method native|all``, ``mine --backend native|numpy`` and a node with
``--sig-backend native`` admitting a wallet's transfer on that rung.
``TestSharded`` runs BASELINE config 5's commands: ``mine --backend
sharded`` and its batch guard, and ``pod``'s parser and its exits
(tests/test_torch_pod.py drives whole pods).

Waiting for the simulation, serving and fault planes (ROADMAP Queue A
item 7c): ``TestWatchCLI.test_watch_deadline_is_a_clean_exit`` (it runs
``serve``), and the ``serve``, ``sim``, ``chaos`` and ``lint`` cases.
The offline store commands are in tests/test_torch_tooling.py.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(*argv, timeout=110):
    proc = subprocess.run(
        [sys.executable, "-m", "p1_tpu_torch", *argv],
        capture_output=True,
        text=True,
        timeout=timeout,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


class TestCli:


    def test_net_config4_smoke(self):
        out = _run(
            "net",
            "--backend", "cpu", "--device", "cpu",
            "--nodes",
            "2",
            "--difficulty",
            "12",
            "--duration",
            "2",
            "--chunk",
            "16384",
            "--base-port",
            "31444",
        )
        assert out["converged"], out
        assert out["height"] >= 1

    def test_net_discover_bootstrap(self):
        """Config 4 with the topology assembled by peer discovery: every
        node knows only the seed, and the net must still converge."""
        out = _run(
            "net", "--backend", "cpu", "--device", "cpu",
            "--nodes", "3", "--difficulty", "12", "--duration", "4",
            "--chunk", "16384", "--base-port", "32444", "--discover",
            timeout=200,
        )
        assert out["converged"], out
        assert out["height"] >= 1

    def test_keygen_tx_mine_audit_e2e(self, tmp_path):
        """The full currency drive, CLI only: keygen two identities, mine
        to alice's account, alice pays bob with a SIGNED tx, audit the
        persisted chain — bob got paid, nothing is negative (the 'live
        drive' criterion).

        Shutdown is TEST-DRIVEN (`--deadline stdin`): the node stays up
        until this test has finished every client round, then reads its
        stop time from stdin — so the node outlives its clients by
        construction.  The previous fixed `--duration 35` raced the
        clients' own 45 s budget and lost deterministically on a loaded
        1-vCPU host, where ~8 serial interpreter startups alone exceed
        35 s (the anchored-proof step dialed a dead port)."""
        import time

        alice_key = str(tmp_path / "alice.key")
        bob_key = str(tmp_path / "bob.key")
        alice = _run("keygen", "--out", alice_key, "--seed-text", "cli-alice")[
            "account"
        ]
        bob = _run("keygen", "--out", bob_key, "--seed-text", "cli-bob")["account"]

        store = str(tmp_path / "chain.dat")
        # Log to a FILE: the node logs 2 lines per block at ms block
        # times — a stderr PIPE nobody drains fills at 64 KB and
        # deadlocks the node's synchronous logging (and with it the
        # whole event loop).  stdout carries only the ready line and the
        # final status JSON, so reading it directly is safe.
        node_log = open(tmp_path / "node.log", "w")
        node = subprocess.Popen(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--difficulty", "12", "--backend", "cpu", "--device", "cpu", "--chunk", "16384",
                "--port", "0", "--miner-id", alice, "--store", store,
                "--deadline", "stdin",
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=node_log,
            text=True,
            cwd=REPO,
        )
        try:
            port = None
            for line in node.stdout:
                line = line.strip()
                if line.startswith("{"):
                    port = str(json.loads(line)["ready"])
                    break
            assert port, "node never printed its ready line"
            # Submit once alice has earned a balance (admission checks
            # affordability, so a too-early tx is refused silently —
            # retry until the audit can succeed).  The budget below is
            # pure client-side patience: the node no longer has a clock
            # to race.
            deadline = time.monotonic() + 120
            sent = False
            while not sent and time.monotonic() < deadline:
                proc = subprocess.run(
                    [
                        sys.executable, "-m", "p1_tpu_torch", "tx",
                        "--difficulty", "12", "--port", port,
                        "--key", alice_key, "--recipient", bob,
                        "--amount", "7", "--fee", "1",
                    ],
                    capture_output=True, text=True, timeout=30, cwd=REPO,
                )
                if proc.returncode == 0:
                    out = json.loads(proc.stdout)
                    sent = out["peer_height"] >= 1  # alice funded from h1 on
                time.sleep(0.3)
            assert sent, "node never became reachable with a funded miner"
            assert out["seq"] == 0  # auto-seq: fresh account starts at 0
            # SPV round: once that spend confirms, `p1 proof` must fetch an
            # inclusion proof AND verify it client-side (exit 3 = not yet
            # mined; block times are ms, so this resolves in a beat).
            txid = out["txid"]
            proved = None
            while proved is None and time.monotonic() < deadline:
                proc = subprocess.run(
                    [
                        sys.executable, "-m", "p1_tpu_torch", "proof",
                        "--difficulty", "12", "--port", port, "--txid", txid,
                    ],
                    capture_output=True, text=True, timeout=30, cwd=REPO,
                )
                if proc.returncode == 0:
                    proved = json.loads(proc.stdout)
                else:
                    assert proc.returncode == 3, proc.stderr[-1000:]
                    time.sleep(0.3)  # not mined yet — keep polling
            assert proved is not None, "spend never confirmed with a proof"
            assert proved["verified"] and proved["amount"] == 7
            # Light-client round: sync + locally verify the header chain,
            # then re-fetch the proof anchored against it — height and
            # confirmations now come from OUR verified chain, not the
            # peer's claim.
            hdrs = str(tmp_path / "headers.bin")
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "headers",
                    "--difficulty", "12", "--port", port, "--out", hdrs,
                ],
                capture_output=True, text=True, timeout=30, cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-1000:]
            assert json.loads(proc.stdout)["valid"]
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "proof",
                    "--difficulty", "12", "--port", port, "--txid", txid,
                    "--headers", hdrs,
                ],
                capture_output=True, text=True, timeout=30, cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-1000:]
            anchored = json.loads(proc.stdout)
            assert anchored["anchored"] and anchored["verified"]
            # Second spend, no --seq either: GETACCOUNT must hand back the
            # next usable nonce (1), whether the first tx is still pending
            # or already mined.
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "tx",
                    "--difficulty", "12", "--port", port,
                    "--key", alice_key, "--recipient", bob,
                    "--amount", "5", "--fee", "auto",
                ],
                capture_output=True, text=True, timeout=30, cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-1000:]
            second = json.loads(proc.stdout)
            assert second["seq"] == 1
            # --fee auto priced at the confirmed median (the first spend
            # paid 1, so the sampled median is 1).
            assert second["fee"] == 1
            # Live account query while the node still runs.
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "account",
                    "--difficulty", "12", "--port", port, "--account", bob,
                ],
                capture_output=True, text=True, timeout=30, cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-1000:]
            assert json.loads(proc.stdout)["account"] == bob
        finally:
            # Clients done (or the test failed): NOW the node may stop.
            # "Stop at `now`" starts the quiesce-and-exit path
            # immediately; the generous wait covers quiesce + final
            # store sync on a loaded box.
            try:
                node.stdin.write(f"{time.time()!r}\n")
                node.stdin.flush()
                node.wait(timeout=120)
            except Exception:
                node.kill()
                node.wait(timeout=30)
            node_log.close()
        out = _run(
            "balances", "--store", store, "--difficulty", "12",
            "--account", bob,
        )
        assert out["balance"] == 7 + 5, out
        full = _run("balances", "--store", store, "--difficulty", "12")
        assert full["conserved"]  # offline audit: view==ledger, exact sum
        assert all(v >= 0 for v in full["balances"].values())
        assert full["balances"][alice] >= 50 - 14

    def test_net_with_tx_economy(self):
        """Config 4 carrying a live signed-transfer economy: the net must
        still converge AND every node's ledger must conserve exactly
        (reward x height) — signatures, nonces, overdraw rejection and
        reorg undo all exercised under real concurrent forks."""
        out = _run(
            "net", "--backend", "cpu", "--device", "cpu",
            "--nodes", "2", "--difficulty", "12", "--duration", "5",
            "--chunk", "16384", "--base-port", "31944", "--tx-rate", "3",
            timeout=200,
        )
        assert out["converged"], out
        assert out["economy"]["ledger_conserved"], out["economy"]
        # The audit is vacuous unless transfers actually flowed.
        assert out["economy"]["txs_submitted"] > 0, out["economy"]


    def test_node_bad_retarget_pair_fails_cleanly(self):
        proc = subprocess.run(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--retarget-window", "144", "--port", "0",
            ],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )
        assert proc.returncode != 0
        assert "set together" in proc.stderr
        assert "Traceback" not in proc.stderr


class TestAutoFeeCap:
    """`p1 tx --fee auto` once signed whatever fee the peer quoted.
    The wallet now refuses quotes above --max-fee before signing."""

    def test_hostile_quote_refused(self, tmp_path, monkeypatch):
        from p1_tpu_torch import cli
        import p1_tpu_torch.node.client as client_mod
        from p1_tpu_torch.node.protocol import FeeStats

        key = str(tmp_path / "k.json")
        assert cli.main(["keygen", "--out", key]) == 0

        called = {}

        async def hostile_fees(*a, **k):
            return FeeStats(32, 5, 10**9, 10**9, 10**9, 10)

        async def never_send(*a, **k):  # pragma: no cover - must not run
            called["sent"] = True
            raise AssertionError("wallet signed a capped fee")

        monkeypatch.setattr(client_mod, "get_fees", hostile_fees)
        monkeypatch.setattr(client_mod, "send_tx", never_send)
        rc = cli.main(
            [
                "tx", "--difficulty", "12", "--key", key,
                "--recipient", "p1deadbeefdeadbeef",
                "--amount", "1", "--fee", "auto",
            ]
        )
        assert rc == 2
        assert "sent" not in called

    def test_quote_within_cap_accepted(self, tmp_path, monkeypatch, capsys):
        import json as _json

        from p1_tpu_torch import cli
        import p1_tpu_torch.node.client as client_mod
        from p1_tpu_torch.node.protocol import AccountState, FeeStats

        key = str(tmp_path / "k.json")
        assert cli.main(["keygen", "--out", key]) == 0
        capsys.readouterr()

        async def fair_fees(*a, **k):
            return FeeStats(32, 5, 2, 3, 4, 10)

        async def fake_account(host, port, account, *a, **k):
            return AccountState(account, 100, 0, 0, 10)

        async def fake_send(*a, **k):
            return 10

        monkeypatch.setattr(client_mod, "get_fees", fair_fees)
        monkeypatch.setattr(client_mod, "get_account", fake_account)
        monkeypatch.setattr(client_mod, "send_tx", fake_send)
        rc = cli.main(
            [
                "tx", "--difficulty", "12", "--key", key,
                "--recipient", "p1deadbeefdeadbeef",
                "--amount", "1", "--fee", "auto",
            ]
        )
        assert rc == 0
        assert _json.loads(capsys.readouterr().out)["fee"] == 3


class TestStatus:
    """`p1 status` renders a running node's full status JSON over the
    wire (GETSTATUS/STATUS v9), the overload block included."""

    def test_status_renders_overload_block(self, tmp_path):
        import time

        node_log = open(tmp_path / "node.log", "w")
        node = subprocess.Popen(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--difficulty", "12", "--backend", "cpu", "--device", "cpu", "--chunk", "16384",
                "--port", "0", "--no-mine", "--deadline", "stdin",
                "--body-cache", "64", "--mem-watermark-mb", "64",
                "--store", str(tmp_path / "chain.dat"),
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=node_log,
            text=True,
            cwd=REPO,
        )
        try:
            port = None
            for line in node.stdout:
                line = line.strip()
                if line.startswith("{"):
                    port = str(json.loads(line)["ready"])
                    break
            assert port, "node never printed its ready line"
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "status",
                    "--difficulty", "12", "--port", port,
                ],
                capture_output=True, text=True, timeout=30, cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-2000:]
            # Pretty-printed (indent=2) — parse the whole document, not
            # a line.
            out = json.loads(proc.stdout)
            overload = out["overload"]
            assert overload["state"] == "normal"
            assert overload["watermark_bytes"] == 64 << 20
            assert overload["body_cache_blocks"] == 64
            assert overload["mining_paused"] is False
            for key in (
                "tracked_bytes",
                "admission_dropped",
                "shed_drops",
                "resident_body_bytes",
                "bodies_evicted",
                "body_refetches",
            ):
                assert key in overload, key
            assert out["height"] == 0 and "storage" in out and "sync" in out
        finally:
            if node.poll() is None:
                node.stdin.write(f"{time.time()!r}\n")
                node.stdin.flush()
                node.stdin.close()
                try:
                    node.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    node.kill()
            node_log.close()


class TestMetricsCLI:
    """`p1 metrics` (GETMETRICS/METRICS v12) and `p1 status --watch N`
    against one running node: the human table, the raw JSON snapshot,
    the Prometheus exposition, and the watch loop's clean-Ctrl-C exit."""

    def test_metrics_renders_and_watch_exits_cleanly(self, tmp_path):
        import signal
        import time

        node_log = open(tmp_path / "node.log", "w")
        node = subprocess.Popen(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--difficulty", "12", "--backend", "cpu", "--device", "cpu", "--chunk", "16384",
                "--port", "0", "--no-mine", "--deadline", "stdin",
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=node_log,
            text=True,
            cwd=REPO,
        )
        try:
            port = None
            for line in node.stdout:
                line = line.strip()
                if line.startswith("{"):
                    port = str(json.loads(line)["ready"])
                    break
            assert port, "node never printed its ready line"

            def metrics(*flags):
                proc = subprocess.run(
                    [
                        sys.executable, "-m", "p1_tpu_torch", "metrics",
                        "--difficulty", "12", "--port", port, *flags,
                    ],
                    capture_output=True, text=True, timeout=30,
                    cwd=REPO,
                )
                assert proc.returncode == 0, proc.stderr[-2000:]
                return proc.stdout

            table = metrics()
            assert "role: node" in table and "blocks_accepted" in table
            snap = json.loads(metrics("--json"))
            assert snap["role"] == "node"
            assert "blocks_accepted" in snap["counters"]
            prom = metrics("--prom")
            assert "# TYPE p1_blocks_accepted counter" in prom
            assert "p1_blocks_accepted 0" in prom

            # --watch: two polls land, SIGINT exits 0 (the clean-Ctrl-C
            # contract — a dashboard must not die with a traceback).
            watch = subprocess.Popen(
                [
                    sys.executable, "-m", "p1_tpu_torch", "status",
                    "--difficulty", "12", "--port", port,
                    "--watch", "0.3",
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                cwd=REPO,
            )
            try:
                seen = 0
                deadline = time.monotonic() + 30
                while seen < 2 and time.monotonic() < deadline:
                    line = watch.stdout.readline()
                    if line.strip() == "{":
                        seen += 1
                assert seen >= 2, "watch never re-polled"
            finally:
                watch.send_signal(signal.SIGINT)
            rc = watch.wait(timeout=30)
            assert rc == 0, (rc, watch.stderr.read()[-2000:])
        finally:
            if node.poll() is None:
                node.stdin.write(f"{time.time()!r}\n")
                node.stdin.flush()
                node.stdin.close()
                try:
                    node.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    node.kill()
            node_log.close()


class TestByzantineSoak:
    """`p1 net --byzantine N`: honest nodes keep
    converging and conserving while live attackers throw the whole
    hostile repertoire at them, and the summary asserts containment —
    bans fired, memory bounded — rather than leaving it to the logs."""

    def test_net_with_byzantine_attacker_contained(self):
        out = _run(
            "net",
            "--backend", "cpu", "--device", "cpu",
            "--nodes", "3",
            "--difficulty", "12",
            "--duration", "8",
            "--tx-rate", "2",
            "--byzantine", "1",
            "--chunk", "16384",
            "--base-port", "31844",
        )
        assert out["converged"], out
        byz = out["byzantine"]
        assert byz["contained"], byz
        assert byz["attacks_sent"] > 0
        assert byz["bans_fired"] and byz["refused_connects"] > 0
        assert byz["memory_bounded"]
        # The hostile stream must not have corrupted the economy.
        assert out["economy"]["ledger_conserved"]
        # Several distinct attack categories actually ran.
        assert len(byz["attacks"]) >= 4, byz["attacks"]


class TestRetargetWalletE2E:
    """The manual retargeting drive as a suite test: a live retargeting
    node (schedule actually climbing), funded wallet spend with
    --fee auto, SPV proof verified at the claimed-difficulty bar with
    the unanchored-figures warning on stderr, then headers-first
    anchoring through the host-verified chain."""

    def test_wallet_round_on_retargeting_chain(self, tmp_path):
        import time

        RT = ["--retarget-window", "50", "--target-spacing", "5"]
        key = str(tmp_path / "alice.json")
        out = _run("keygen", "--out", key)
        alice = out["account"]
        node = subprocess.Popen(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--difficulty", "12", "--port", "0", "--backend", "cpu", "--device", "cpu",
                *RT, "--miner-id", alice, "--deadline", "stdin",
            ],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, cwd=REPO,
        )
        try:
            port = None
            for line in node.stdout:
                line = line.strip()
                if line.startswith("{"):
                    port = str(json.loads(line)["ready"])
                    break
            assert port
            time.sleep(2)  # a few blocks of funding
            tx = None
            for _ in range(10):  # tolerate miner-load handshake stalls
                proc = subprocess.run(
                    [
                        sys.executable, "-m", "p1_tpu_torch", "tx",
                        "--difficulty", "12", *RT, "--port", port,
                        "--key", key, "--recipient", "p1deadbeefdeadbeef",
                        "--amount", "3", "--fee", "auto",
                    ],
                    capture_output=True, text=True, timeout=60,
                    cwd=REPO,
                )
                if proc.returncode == 0:
                    tx = json.loads(proc.stdout)
                    break
                time.sleep(1)
            assert tx is not None, proc.stderr[-500:]
            txid = tx["txid"]
            proved = None
            for _ in range(60):
                proc = subprocess.run(
                    [
                        sys.executable, "-m", "p1_tpu_torch", "proof",
                        "--difficulty", "12", *RT, "--port", port,
                        "--txid", txid,
                    ],
                    capture_output=True, text=True, timeout=60,
                    cwd=REPO,
                )
                if proc.returncode == 0:
                    proved = json.loads(proc.stdout)
                    # Unanchored retarget proofs must shout about it.
                    assert "without --headers" in proc.stderr
                    break
                assert proc.returncode == 3, proc.stderr[-500:]
                time.sleep(0.5)
            assert proved is not None and proved["verified"]
            # Headers-first anchoring (host-verified schedule).
            hdrs = str(tmp_path / "h.bin")
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "headers",
                    "--difficulty", "12", *RT, "--port", port,
                    "--out", hdrs,
                ],
                capture_output=True, text=True, timeout=60, cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-500:]
            synced = json.loads(proc.stdout)
            assert synced["valid"]
            # The schedule actually moved: sub-second real blocks at
            # spacing 5 force the difficulty up past the base.
            assert synced["tip_difficulty"] > 12
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "proof",
                    "--difficulty", "12", *RT, "--port", port,
                    "--txid", txid, "--headers", hdrs,
                ],
                capture_output=True, text=True, timeout=60, cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-500:]
            anchored = json.loads(proc.stdout)
            assert anchored["anchored"] and anchored["verified"]
        finally:
            try:
                node.stdin.write(str(time.time()) + "\n")
                node.stdin.flush()
                node.wait(timeout=60)
            except Exception:
                node.kill()


class TestWatchCLI:
    """`p1 watch` — one JSON line per verified push event, deadline and
    max-events as clean exits (0), dead peers as exit 1."""

    def test_help_smoke(self):
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch", "watch", "--help"],
            capture_output=True,
            text=True,
            timeout=110,
            cwd=REPO,
        )
        assert proc.returncode == 0
        assert "--fallback" in proc.stdout and "--deadline" in proc.stdout

    def test_watch_e2e_mining_node_events_then_exit(self, tmp_path):
        """Submit-free SLO shape over two real processes: a mining node
        pushes events, `p1 watch <miner account>` verifies and prints
        them, then exits 0 at --max-events.  Every line is a matched
        event (each block pays the miner) with contiguous heights."""
        node_log = open(tmp_path / "node.log", "w")
        node = subprocess.Popen(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--difficulty", "12", "--backend", "cpu", "--device", "cpu",
                "--chunk", "16384", "--port", "0",
                "--miner-id", "watch-cli-acct", "--deadline", "stdin",
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=node_log,
            text=True,
            cwd=REPO,
        )
        try:
            port = None
            for line in node.stdout:
                line = line.strip()
                if line.startswith("{"):
                    port = str(json.loads(line)["ready"])
                    break
            assert port, "node never printed its ready line"
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "watch",
                    "watch-cli-acct", "--difficulty", "12",
                    "--port", port, "--deadline", "90",
                    "--max-events", "3",
                ],
                capture_output=True,
                text=True,
                timeout=110,
                cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-2000:]
            lines = [
                json.loads(l) for l in proc.stdout.strip().splitlines()
            ]
            assert len(lines) == 3
            heights = [l["height"] for l in lines]
            assert heights == list(range(heights[0], heights[0] + 3))
            for l in lines:
                assert l["matched"] and l["txids"]
                assert len(l["block"]) == 64  # hex block hash
                assert len(l["filter_header"]) == 64
                assert l["peer"].endswith(f":{port}")
        finally:
            try:
                node.communicate(input="0\n", timeout=30)
            except subprocess.TimeoutExpired:
                node.kill()
            node_log.close()


    def test_watch_dead_peer_exits_1(self):
        proc = subprocess.run(
            [
                sys.executable, "-m", "p1_tpu_torch", "watch", "nobody",
                "--difficulty", "12", "--port", "1",
                "--max-session-failures", "1",
            ],
            capture_output=True,
            text=True,
            timeout=110,
            cwd=REPO,
        )
        assert proc.returncode == 1
        assert "watch failed" in proc.stderr


class TestMaintain:
    """`p1 maintain` (GETMAINTAIN/MAINTAIN v13): the exit-code
    contract — 0 when the node answered ``{"ok": true}``, 1 when it
    refused or the wire failed, 2 on local usage errors — plus one
    subprocess e2e driving a live node through status/rebase/compact
    while it keeps mining."""

    def test_help_smoke(self):
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch", "maintain", "--help"],
            capture_output=True,
            text=True,
            timeout=110,
            cwd=REPO,
        )
        assert proc.returncode == 0
        assert "rebase" in proc.stdout and "--keep" in proc.stdout

    def test_negative_keep_is_usage_error_exit_2(self):
        proc = subprocess.run(
            [
                sys.executable, "-m", "p1_tpu_torch", "maintain", "rebase",
                "--difficulty", "12", "--keep", "-1",
            ],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )
        assert proc.returncode == 2
        assert "--keep must be >= 0" in proc.stderr

    def test_keep_with_status_is_usage_error_exit_2(self):
        proc = subprocess.run(
            [
                sys.executable, "-m", "p1_tpu_torch", "maintain", "status",
                "--difficulty", "12", "--keep", "4",
            ],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )
        assert proc.returncode == 2
        assert "--keep does not apply" in proc.stderr

    def test_connection_failure_exit_1(self):
        # A port nothing listens on: the wire error must land as exit 1
        # with the detail on stderr, not a traceback.
        import socket

        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        proc = subprocess.run(
            [
                sys.executable, "-m", "p1_tpu_torch", "maintain", "status",
                "--difficulty", "12", "--port", str(port),
            ],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )
        assert proc.returncode == 1
        assert "maintain command failed" in proc.stderr

    def test_maintain_e2e_live_rebase_while_mining(self, tmp_path):
        """One mining node, driven across the whole contract: status
        (0), a live rebase that lands (0), a too-deep rebase refused as
        an ANSWER (1, detail on stderr), and an online compact (0) —
        the node never restarts and keeps extending its chain
        throughout."""
        import asyncio
        import time

        from p1_tpu_torch.node.client import get_status

        node_log = open(tmp_path / "node.log", "w")
        node = subprocess.Popen(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--difficulty", "12", "--backend", "cpu", "--device", "cpu", "--chunk", "16384",
                "--port", "0", "--deadline", "stdin",
                "--miner-id", "alice",
                "--store", str(tmp_path / "chain.dat"),
                "--store-segment-mb", "0.0004",
                "--snapshot-interval", "4",
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=node_log,
            text=True,
            cwd=REPO,
        )
        try:
            port = None
            for line in node.stdout:
                line = line.strip()
                if line.startswith("{"):
                    port = str(json.loads(line)["ready"])
                    break
            assert port, "node never printed its ready line"

            def maintain(*argv):
                return subprocess.run(
                    [
                        sys.executable, "-m", "p1_tpu_torch", "maintain", *argv,
                        "--difficulty", "12", "--port", port,
                    ],
                    capture_output=True, text=True, timeout=60,
                    cwd=REPO,
                )

            # Let the miner build past two checkpoint boundaries.
            deadline = time.monotonic() + 90
            height = 0
            while height < 9 and time.monotonic() < deadline:
                status = asyncio.run(get_status("127.0.0.1", int(port), 12))
                height = status["height"]
                time.sleep(0.2)
            assert height >= 9, f"miner stalled at height {height}"

            proc = maintain("status")
            assert proc.returncode == 0, proc.stderr[-2000:]
            report = json.loads(proc.stdout)
            assert report["ok"] is True and report["base_height"] == 0
            assert report["versionbits"]["window"] == 8

            proc = maintain("rebase", "--keep", "4")
            assert proc.returncode == 0, proc.stderr[-2000:]
            reply = json.loads(proc.stdout)
            assert reply["ok"] is True and reply["new_base"] >= 4
            assert reply["dropped_blocks"] == reply["new_base"]

            # Refusal contract: a rebase the chain cannot satisfy comes
            # back as an answer (exit 1 + stderr detail), the node keeps
            # serving.
            proc = maintain("rebase", "--keep", "100000")
            assert proc.returncode == 1
            assert "maintain refused" in proc.stderr
            assert json.loads(proc.stdout)["ok"] is False

            proc = maintain("compact")
            assert proc.returncode == 0, proc.stderr[-2000:]
            assert json.loads(proc.stdout)["ok"] is True

            proc = maintain("status")
            report = json.loads(proc.stdout)
            assert report["base_height"] >= 4
            assert report["rebases"] == 1 and report["online_compactions"] == 1

            # The node is still alive and still mining on its rebased
            # chain.
            status = asyncio.run(get_status("127.0.0.1", int(port), 12))
            assert status["height"] >= height
            assert status["maintenance"]["base_height"] >= 4
        finally:
            if node.poll() is None:
                node.stdin.write(f"{time.time()!r}\n")
                node.stdin.flush()
                node.stdin.close()
                try:
                    node.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    node.kill()
            node_log.close()


class TestDevice:
    """The port's device contract on the command line: a node or net on
    the card unless asked for the CPU, and the verify-workers knob."""

    @pytest.mark.parametrize(
        "argv",
        [
            ["node", "--difficulty", "12", "--port", "0", "--duration", "1"],
            ["node", "--backend", "cpu", "--difficulty", "12", "--port", "0", "--duration", "1"],
            ["net", "--nodes", "2", "--difficulty", "12", "--duration", "1", "--base-port", "33444"],
        ],
        ids=["cuda-backend", "cpu-backend", "net"],
    )
    def test_without_a_card_and_without_device_cpu_exits_nonzero(self, argv):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: this checks the refusal without one")
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch", *argv],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )
        assert proc.returncode != 0
        assert "cuda" in proc.stderr

    def test_device_rejects_other_choices(self):
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch", "node", "--device", "tpu"],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )
        assert proc.returncode == 2 and "invalid choice" in proc.stderr

    def test_verify_workers_is_reported(self):
        import time

        node = subprocess.Popen(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--difficulty", "12", "--backend", "cpu", "--device", "cpu",
                "--port", "0", "--no-mine", "--verify-workers", "3",
                "--deadline", "stdin",
            ],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, cwd=REPO,
        )
        try:
            ready = json.loads(node.stdout.readline())
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "status",
                    "--difficulty", "12", "--port", str(ready["ready"]),
                ],
                capture_output=True, text=True, timeout=30, cwd=REPO,
            )
            assert proc.returncode == 0, proc.stderr[-2000:]
            assert json.loads(proc.stdout)["validation"]["workers"] == 3
            out, _ = node.communicate(input=f"{time.time()!r}\n", timeout=60)
        finally:
            if node.poll() is None:
                node.kill()
        final = json.loads(out.strip().splitlines()[-1])
        assert final["validation"]["workers"] == 3
        assert final["validation"]["backend"] == "device"


class TestNetRelayBench:
    """``benchmarks/net_relay.py``: chip_smoke.py's phase 12 net per
    checkout, summarised (on the host, at a small size)."""

    def test_one_net_on_the_host(self):
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch.benchmarks.net_relay", "--runs", "1", "--device", "cpu", "--",
             "--nodes", "2", "--difficulty", "12", "--duration", "3", "--tx-rate", "1", "--backend", "cpu"],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )  # fmt: skip
        assert proc.returncode == 0, proc.stderr[-2000:]
        net, summary = (json.loads(line) for line in proc.stdout.strip().splitlines())
        assert net["ok"] and net["phase"] == "net" and net["heights"][0] == net["height"]
        assert summary["checkout"] == str(REPO) and (summary["nets"], summary["converged"]) == (1, 1)
        assert summary["blocks_dropped"] == [net["admission_dropped_total"]["blocks"]]

    def test_against_a_directory_without_the_port_exits(self, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch.benchmarks.net_relay", "--device", "cpu", "--against", str(tmp_path)],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )  # fmt: skip
        assert proc.returncode != 0 and "holds no chip_smoke.py" in proc.stderr


class TestNativeTier:
    """The native host tier on the command line: ``replay --method
    native|all``, ``mine --backend native|numpy``, ``--sig-backend
    native``, all with ``--device cpu``."""

    @pytest.mark.parametrize(
        "method,methods", [("native", ["native"]), ("all", ["host", "native", "device", "device"])]
    )
    def test_replay_native_and_all(self, method, methods):
        out = _run("replay", "--n", "16", "--difficulty", "8", "--device", "cpu", "--method", method)
        assert out["valid"] and out["first_invalid"] is None and out["n_headers"] == 16
        assert [r["method"] for r in out["results"]] == methods

    @pytest.mark.parametrize("backend", ["native", "numpy"])
    def test_mine_on_a_host_backend(self, backend):
        out = _run("mine", "--backend", backend, "--device", "cpu", "--difficulty", "8", "--blocks", "2")
        assert (out["config"], out["backend"], out["blocks"]) == ("mine", backend, 2)

    def test_sig_backend_native_admits_on_the_native_rung(self, tmp_path):
        import time

        alice_key = str(tmp_path / "alice.key")
        alice = _run("keygen", "--out", alice_key, "--seed-text", "cli-native-alice")["account"]
        node_log = open(tmp_path / "node.log", "w")
        node = subprocess.Popen(
            [
                sys.executable, "-m", "p1_tpu_torch", "node", "--sig-backend", "native",
                "--difficulty", "12", "--backend", "cpu", "--device", "cpu", "--chunk", "16384",
                "--port", "0", "--miner-id", alice, "--deadline", "stdin",
            ],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=node_log, text=True, cwd=REPO,
        )  # fmt: skip
        try:
            port = str(json.loads(node.stdout.readline())["ready"])
            deadline = time.monotonic() + 90
            sent = False
            while not sent and time.monotonic() < deadline:
                proc = subprocess.run(
                    [sys.executable, "-m", "p1_tpu_torch", "tx", "--difficulty", "12", "--port", port,
                     "--key", alice_key, "--recipient", "bob", "--amount", "1", "--fee", "1"],
                    capture_output=True, text=True, timeout=30, cwd=REPO,
                )  # fmt: skip
                sent = proc.returncode == 0 and json.loads(proc.stdout)["peer_height"] >= 1
                time.sleep(0.2)
            assert sent, "node never became reachable with a funded miner"
            out, _ = node.communicate(input=f"{time.time()!r}\n", timeout=60)
        finally:
            if node.poll() is None:
                node.kill()
            node_log.close()
        validation = json.loads(out.strip().splitlines()[-1])["validation"]
        assert validation["backend"] == "native"
        assert validation["backends"]["native"] >= 1 and validation["backends"]["pure-python"] == 0


class TestSharded:
    """``mine --backend sharded`` and ``pod``, on the CPU."""

    @pytest.mark.parametrize("batch", ["1024", "8192"])
    def test_mine_sharded_seals_the_reference_chain(self, batch):
        import p1_tpu.core as ref_core
        from p1_tpu.miner import Miner as RefMiner

        argv = ["mine", "--backend", "sharded", "--device", "cpu", "--batch", batch,
                "--difficulty", "10", "--blocks", "2"]  # fmt: skip
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch", *argv],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )  # fmt: skip
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert (out["config"], out["backend"], out["blocks"]) == ("mine", "sharded", 2)
        # The nonces behind the report (its log): the JAX package's miner
        # seals them.
        nonces = [int(line.split("nonce=")[1].split()[0]) for line in proc.stderr.splitlines() if "nonce=" in line]
        tip = ref_core.make_genesis(10).header
        miner = RefMiner(backend="cpu", chunk=1 << 12)
        want = []
        for _ in range(2):
            tip = miner.search_nonce(ref_core.BlockHeader(1, tip.block_hash(), bytes(32), tip.timestamp + 1, 10, 0))
            want.append(tip.nonce)
        assert nonces == want

    def test_mine_sharded_refuses_a_batch_not_a_power_of_two(self):
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch", "mine", "--backend", "sharded", "--device", "cpu",
             "--batch", "1000", "--blocks", "1"],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )  # fmt: skip
        assert proc.returncode != 0 and "power of two" in proc.stderr

    def test_mine_sharded_without_a_card_exits_nonzero(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present: this checks the refusal without one")
        proc = subprocess.run(
            [sys.executable, "-m", "p1_tpu_torch", "mine", "--backend", "sharded", "--blocks", "1"],
            capture_output=True, text=True, timeout=110, cwd=REPO,
        )  # fmt: skip
        assert proc.returncode != 0 and "CUDA device" in proc.stderr

    def test_pod_parser(self):
        from p1_tpu_torch.cli import build_parser

        args = build_parser().parse_args(
            ["pod", "--coordinator", "127.0.0.1:1", "--num-hosts", "2", "--host-id", "1", "--device", "cpu"]
        )
        assert (args.cmd, args.num_hosts, args.host_id, args.device) == ("pod", 2, 1, "cpu")
        assert (args.backend, args.no_mine, args.deadline, args.status_interval) == ("sharded", False, None, 10.0)
        assert (args.port, args.peers, args.duration) == (0, [], None)
        for bad in (["pod", "--num-hosts", "2", "--host-id", "0"],  # no coordinator
                    ["pod", "--coordinator", "h:1", "--num-hosts", "2", "--host-id", "0", "--platform", "cpu"],
                    ["pod", "--coordinator", "h:1", "--num-hosts", "2", "--host-id", "0", "--device", "tpu"]):  # fmt: skip
            proc = subprocess.run(
                [sys.executable, "-m", "p1_tpu_torch", *bad], capture_output=True, text=True, timeout=110, cwd=REPO
            )
            assert proc.returncode == 2, bad

    def test_pod_mismatch_exits_2(self):
        import socket

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            coord = sock.getsockname()[1]
        base = [sys.executable, "-m", "p1_tpu_torch", "pod", "--coordinator", f"127.0.0.1:{coord}",
                "--num-hosts", "2", "--device", "cpu", "--difficulty", "12", "--duration", "4"]  # fmt: skip
        procs = [
            subprocess.Popen([*base, "--host-id", "0", "--batch", "256"], stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True, cwd=REPO),
            subprocess.Popen([*base, "--host-id", "1", "--batch", "512"], stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True, cwd=REPO),
        ]  # fmt: skip
        try:
            errs = [p.communicate(timeout=90)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert [p.returncode for p in procs] == [2, 2]
        assert all("pod config mismatch" in e for e in errs)
