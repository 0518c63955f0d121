"""The port's entry points (``p1_tpu_torch/graft_entry.py``).

Mirrors tests/test_graft_entry.py: ``dryrun_multichip(8, device="cpu")``
in a fresh subprocess (an 8-slot mesh on the CPU, one full sharded search
held to the host ``cpu`` backend, the reference's ok line), and
``entry()``'s search step in-process, held to the JAX package's
``entry()``.  Both entry points run on the card unless asked for the CPU,
so without one their defaults raise.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_subprocess():
    proc = subprocess.run(
        [sys.executable, "-c", "from p1_tpu_torch import graft_entry; graft_entry.dryrun_multichip(8, device='cpu')"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )  # fmt: skip
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr}"
    assert "dryrun_multichip ok: 8-device mesh (platform=cpu)" in proc.stdout
    # The JAX package's dry run finds this nonce too (MULTICHIP_r05.json):
    # the same genesis, difficulty and range.
    assert "found nonce 639 == host cpu backend" in proc.stdout


def test_module_runs_as_a_script():
    proc = subprocess.run(
        [sys.executable, "-m", "p1_tpu_torch.graft_entry", "--devices", "4", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "dryrun_multichip ok: 4-device mesh (platform=cpu)" in proc.stdout


def test_dryrun_on_the_card_without_one_raises(monkeypatch):
    import pytest
    import torch

    from p1_tpu_torch import graft_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        graft_entry.dryrun_multichip(4, device="cuda")
    # The card is the default.
    with pytest.raises(RuntimeError, match="CUDA device"):
        graft_entry.dryrun_multichip(4)


def test_module_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is present: this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, "-m", "p1_tpu_torch.graft_entry", "--devices", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )  # fmt: skip
    assert proc.returncode != 0 and "CUDA device" in proc.stderr
    assert "dryrun_multichip ok" not in proc.stdout


def test_entry_compiles_in_process():
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    try:
        import __graft_entry__
        from p1_tpu_torch import graft_entry

        fn, args = graft_entry.entry(device="cpu")
        out = fn(*args)
        assert out.shape == (1,) and int(out[0]) >= 0
        ref_fn, ref_args = __graft_entry__.entry()
        assert int(out[0]) == int(jnp.asarray(ref_fn(*ref_args)))
    finally:
        sys.path.remove(REPO)
