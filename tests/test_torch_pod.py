"""The port's pod: ``python -m p1_tpu_torch pod`` processes on gloo and the CPU.

Mirrors tests/test_pod.py's four cases with real subprocesses: the
processes join one ``torch.distributed`` gloo group, mirror the sharded
search in lockstep (one slot each, the plain version), and the leader
gossips the mined blocks to a plain listener node.  The reference file
skips on a host whose jax lacks CPU collectives, so these are held to the
reference's contract (exit 2 on a config mismatch, 3 on mesh loss, the
follower's JSON line, ``P1_POD_GRACE_S``), and the sealed nonces to the
JAX package's ``cpu`` backend: each is the earliest hit of its header.
Every subprocess wait has its own timeout.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

from p1_tpu.hashx import get_backend as ref_get_backend
from p1_tpu_torch.chain import ChainStore
from p1_tpu_torch.parallel.watchdog import POD_LOST_EXIT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIFFICULTY = 12
#: Short enough for the kill cases, long enough for a loaded host's
#: gaps between lockstep points (no kernel build on the CPU).
GRACE_S = "12"


@pytest.fixture(autouse=True, scope="module")
def _native_built():
    """The leader loads the native signature rung before the pod forms;
    build it here once, so no pod's start waits on the compiler."""
    from p1_tpu_torch.hashx import native_build

    native_build.build_lib()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pod_cmd(coord: int, hosts: int, duration: float, chunk: int = 1 << 12) -> list[str]:
    return [
        sys.executable, "-m", "p1_tpu_torch", "pod",
        "--coordinator", f"127.0.0.1:{coord}", "--num-hosts", str(hosts),
        "--device", "cpu", "--difficulty", str(DIFFICULTY),
        "--chunk", str(chunk), "--batch", "256", "--duration", str(duration),
    ]  # fmt: skip


def _env(**extra) -> dict:
    return {**os.environ, **extra}


def _store_blocks(store) -> list:
    try:
        return ChainStore(store).load_blocks()
    except (FileNotFoundError, ValueError):
        return []


def _wait_blocks(store, target: int, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(_store_blocks(store)) >= target:
            return True
        time.sleep(0.5)
    return False


def _assert_earliest(blocks) -> None:
    """Every stored block's nonce (the store holds no genesis) is the
    earliest hit of its header in the JAX package's host scan."""
    cpu = ref_get_backend("cpu")
    assert blocks
    for block in blocks:
        h = block.header
        assert cpu.search(h.mining_prefix(), 0, h.nonce + 1, h.difficulty).nonce == h.nonce


def _kill(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_config_mismatch_fails_loudly():
    # chunk differs between processes: the construction-time handshake
    # turns the would-be silent collective desync into exit 2 on EVERY rank.
    coord = _free_port()
    leader = subprocess.Popen(
        [*_pod_cmd(coord, 2, 4, chunk=4096), "--host-id", "0", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
    )  # fmt: skip
    follower = subprocess.Popen(
        [*_pod_cmd(coord, 2, 4, chunk=8192), "--host-id", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
    )  # fmt: skip
    try:
        _, ferr = follower.communicate(timeout=90)
        _, lerr = leader.communicate(timeout=30)
    finally:
        _kill((leader, follower))
    assert follower.returncode == 2 and leader.returncode == 2
    assert "mismatch" in ferr and "mismatch" in lerr, (ferr + lerr)[-2000:]


def test_two_process_pod_mines_and_gossips(tmp_path):
    coord, listen_port = _free_port(), _free_port()
    store = tmp_path / "pod.dat"
    # A plain non-mining node: the gossip network the pod presents to,
    # shut down by the test once the pod is down.
    listener = subprocess.Popen(
        [sys.executable, "-m", "p1_tpu_torch", "node", "--port", str(listen_port),
         "--difficulty", str(DIFFICULTY), "--backend", "cpu", "--device", "cpu",
         "--no-mine", "--deadline", "stdin"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO,
    )  # fmt: skip
    leader_log = open(tmp_path / "leader.log", "w")
    leader = subprocess.Popen(
        [*_pod_cmd(coord, 2, 4), "--host-id", "0", "--port", "0",
         "--peers", f"127.0.0.1:{listen_port}", "--miner-id", "pod", "--store", str(store)],
        stdout=subprocess.PIPE, stderr=leader_log, text=True, cwd=REPO,
    )  # fmt: skip
    follower = subprocess.Popen(
        [*_pod_cmd(coord, 2, 4), "--host-id", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO,
    )  # fmt: skip
    try:
        assert "ready" in json.loads(listener.stdout.readline())
        leader_out, _ = leader.communicate(timeout=120)
        follower_out, _ = follower.communicate(timeout=60)
        listener.stdin.write(f"{time.time()!r}\n")
        listener.stdin.flush()
        listener_out, _ = listener.communicate(timeout=60)
    finally:
        _kill((leader, follower, listener))
        leader_log.close()
    log = (tmp_path / "leader.log").read_text()
    assert leader.returncode == 0, log[-2000:]
    assert follower.returncode == 0 and listener.returncode == 0

    leader_status = json.loads(leader_out.strip().splitlines()[-1])
    follower_status = json.loads(follower_out.strip().splitlines()[-1])
    listener_status = json.loads(listener_out.strip().splitlines()[-1])
    # The pod mined in lockstep: every leader search was mirrored.
    assert leader_status["height"] > 0
    assert set(follower_status) == {"config", "role", "searches"}
    assert (follower_status["config"], follower_status["role"]) == ("pod", "follower")
    searches = [int(line.rsplit(" ", 1)[1]) for line in log.splitlines() if "pod searches:" in line]
    assert searches == [follower_status["searches"]] and searches[0] >= leader_status["height"]
    # ... and the network saw ONE miner: the listener followed the chain.
    assert listener_status["height"] == leader_status["height"]
    assert listener_status["tip"] == leader_status["tip"]
    assert listener_status["blocks_mined"] == 0
    blocks = _store_blocks(store)
    assert len(blocks) == leader_status["height"]
    _assert_earliest(blocks)


def test_leader_survives_follower_sigkill(tmp_path):
    """SIGKILL a follower mid-run: the leader must NOT go dark.  Its
    watchdog re-execs it into single-process sharded mining against the
    same store, so the chain keeps growing within the grace window."""
    coord = _free_port()
    store = tmp_path / "pod-chain.dat"
    env = _env(P1_POD_GRACE_S=GRACE_S)
    log = open(tmp_path / "leader.log", "w")
    # The duration outlasts the phases below; teardown kills the processes.
    leader = subprocess.Popen(
        [*_pod_cmd(coord, 2, 300), "--host-id", "0", "--port", "0", "--miner-id", "pod", "--store", str(store)],
        env=env, stdout=log, stderr=log, cwd=REPO,
    )  # fmt: skip
    follower = subprocess.Popen(
        [*_pod_cmd(coord, 2, 300), "--host-id", "1"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO,
    )  # fmt: skip
    try:
        assert _wait_blocks(store, 3, 90), "pod never started mining"
        pre_kill = len(_store_blocks(store))
        follower.send_signal(signal.SIGKILL)
        follower.wait(timeout=10)
        # Within grace + a node's start the leader fails over and keeps
        # extending the SAME store: same pid, new process image.
        grown = _wait_blocks(store, pre_kill + 3, 60)
        text = (tmp_path / "leader.log").read_text()
        assert grown, f"chain stuck after follower kill (pre-kill {pre_kill}): {text[-2000:]}"
        assert "failing over to solo mining" in text and "--backend sharded" in text
        assert leader.poll() is None
    finally:
        _kill((leader, follower))
        log.close()
    _assert_earliest(_store_blocks(store))


def test_many_process_pod_with_follower_loss_and_restart(tmp_path):
    """(a) a leader + 2 follower pod mines in lockstep; (b) SIGKILL of one
    follower: the leader fails over to single-process mining on the SAME
    store and the surviving follower exits 3, the supervisor signal; (c)
    the supervisor recipe: relaunch the WHOLE pod on the same store and
    the chain keeps growing from where it stopped."""
    store = tmp_path / "pod3-chain.dat"
    env = _env(P1_POD_GRACE_S=GRACE_S)
    logs = []

    def launch(coord: int):
        log = open(tmp_path / "leader.log", "a")
        logs.append(log)
        leader = subprocess.Popen(
            [*_pod_cmd(coord, 3, 600), "--host-id", "0", "--port", "0", "--miner-id", "pod3", "--store", str(store)],
            env=env, stdout=log, stderr=log, cwd=REPO,
        )  # fmt: skip
        followers = [
            subprocess.Popen(
                [*_pod_cmd(coord, 3, 600), "--host-id", str(i)],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO,
            )  # fmt: skip
            for i in (1, 2)
        ]
        return leader, followers

    def tail() -> str:
        return (tmp_path / "leader.log").read_text()[-2000:]

    leader, followers = launch(_free_port())
    procs = [leader, *followers]
    try:
        assert _wait_blocks(store, 3, 120), "3-process pod never started mining"
        pre_kill = len(_store_blocks(store))
        followers[0].send_signal(signal.SIGKILL)
        followers[0].wait(timeout=10)
        assert _wait_blocks(store, pre_kill + 3, 90), "chain stuck after follower kill: " + tail()
        assert followers[1].wait(timeout=60) == POD_LOST_EXIT == 3
        _kill(procs)
        pre_restart = len(_store_blocks(store))
        leader, followers = launch(_free_port())
        procs = [leader, *followers]
        assert _wait_blocks(store, pre_restart + 3, 120), "restarted pod never extended the chain: " + tail()
    finally:
        _kill(procs)
        for log in logs:
            log.close()
    _assert_earliest(_store_blocks(store))
