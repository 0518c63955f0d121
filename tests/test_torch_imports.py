"""The port imports neither ``jax`` nor anything of ``p1_tpu``.

``p1_tpu_torch`` keeps its own copies of the reference's JAX-free modules;
only the tests import both packages.  Mind the prefix: ``p1_tpu_torch``
itself starts with ``p1_tpu``.
"""

import ast
import os
import pathlib
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parent.parent / "p1_tpu_torch"


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "p1_tpu")


def _modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


#: Modules of the port's slices so far; each must be among those checked.
PORT_MODULES = (
    "p1_tpu_torch.hashx.cuda_backend",
    "p1_tpu_torch.hashx.cuda_verify",
    "p1_tpu_torch.hashx.sass",
    "p1_tpu_torch.benchmarks.vpu_roofline",
    "p1_tpu_torch.chain.replay",
    "p1_tpu_torch.core.retarget",
    "p1_tpu_torch.core._ed25519",
    "p1_tpu_torch.core.keys",
    "p1_tpu_torch.core.sigcache",
    "p1_tpu_torch.core.tx",
    "p1_tpu_torch.core.block",
    "p1_tpu_torch.chain.validate",
    "p1_tpu_torch.hashx.ed25519_msm",
    "p1_tpu_torch.hashx.cuda_ed25519",
    "p1_tpu_torch.benchmarks.sig_verify",
    "p1_tpu_torch.chain.ledger",
    "p1_tpu_torch.chain.filters",
    "p1_tpu_torch.chain.proof",
    "p1_tpu_torch.chain.snapshot",
    "p1_tpu_torch.chain.statedelta",
    "p1_tpu_torch.chain.chain",
    "p1_tpu_torch.chain.store",
    "p1_tpu_torch.chain.segstore",
    "p1_tpu_torch.chain.headerplane",
    "p1_tpu_torch.chain.tooling",
    "p1_tpu_torch.chain.testing",
    "p1_tpu_torch.node.testing",
    "p1_tpu_torch.benchmarks.host_ingest",
    "p1_tpu_torch.benchmarks.net_relay",
    "p1_tpu_torch.cli",
    "p1_tpu_torch.chain.versionbits",
    "p1_tpu_torch.config",
    "p1_tpu_torch.mempool",
    "p1_tpu_torch.mempool.mempool",
    "p1_tpu_torch.node",
    "p1_tpu_torch.node.transport",
    "p1_tpu_torch.node.supervision",
    "p1_tpu_torch.node.governor",
    "p1_tpu_torch.node.pipeline",
    "p1_tpu_torch.node.reconcile",
    "p1_tpu_torch.node.protocol",
    "p1_tpu_torch.node.telemetry",
    "p1_tpu_torch.node.subscriptions",
    "p1_tpu_torch.node.node",
    "p1_tpu_torch.node.client",
    "p1_tpu_torch.node.runner",
    "p1_tpu_torch.node.byzantine",
    "p1_tpu_torch.node.netharness",
    "p1_tpu_torch.hashx.native_build",
    "p1_tpu_torch.hashx.native_backend",
    "p1_tpu_torch.hashx.numpy_backend",
    "p1_tpu_torch.core._ed25519_native",
    "p1_tpu_torch.hashx.sharded",
    "p1_tpu_torch.parallel",
    "p1_tpu_torch.parallel.pod",
    "p1_tpu_torch.parallel.watchdog",
    "p1_tpu_torch.graft_entry",
    "p1_tpu_torch.node.netsim",
    "p1_tpu_torch.node.farfield",
    "p1_tpu_torch.node.scenarios",
    "p1_tpu_torch.node.chaos",
    "p1_tpu_torch.node.queryplane",
    "p1_tpu_torch.node.provision",
    "p1_tpu_torch.analysis",
    "p1_tpu_torch.analysis.findings",
    "p1_tpu_torch.analysis.base",
    "p1_tpu_torch.analysis.callgraph",
    "p1_tpu_torch.analysis.engine",
    "p1_tpu_torch.analysis.allowlist",
    "p1_tpu_torch.analysis.rules",
    "p1_tpu_torch.analysis.rules.awaitstate",
    "p1_tpu_torch.analysis.rules.blocking",
    "p1_tpu_torch.analysis.rules.escstate",
    "p1_tpu_torch.analysis.rules.losttask",
    "p1_tpu_torch.analysis.rules.rng",
    "p1_tpu_torch.analysis.rules.setiter",
    "p1_tpu_torch.analysis.rules.transblock",
    "p1_tpu_torch.analysis.rules.wallclock",
    "p1_tpu_torch.analysis.rules.wirecontract",
    "p1_tpu_torch.bench",
    "p1_tpu_torch.hashx.perf_record",
    "p1_tpu_torch.hashx.torch_backend",
    "p1_tpu_torch.benchmarks.rss",
    "p1_tpu_torch.benchmarks.telemetry_overhead",
    "p1_tpu_torch.benchmarks.query_plane",
    "p1_tpu_torch.benchmarks.wallet_plane",
    "p1_tpu_torch.benchmarks.netsim_scale",
    "p1_tpu_torch.benchmarks.chaos_rate",
    "p1_tpu_torch.benchmarks.snapshot_boot",
    "p1_tpu_torch.benchmarks.archive_scale",
    "p1_tpu_torch.benchmarks.maintenance_cadence",
    "p1_tpu_torch.benchmarks.ledger_scale",
    "p1_tpu_torch.benchmarks.memory_bound",
)


def test_every_module_imports_without_jax_or_p1_tpu():
    mods = _modules()
    assert set(PORT_MODULES) <= set(mods)
    # Importing a kernel's module builds nothing and touches no GPU-only
    # package (nor the optional ``cryptography`` wheel: the port imports
    # torch, numpy and the standard library): the kernels are built and
    # loaded at their first launch.
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'p1_tpu'))\n"
        "bad += sorted(m for m in sys.modules if m.split('.')[0] in ('triton', 'cryptography'))\n"
        "from p1_tpu_torch.hashx import cuda_backend, cuda_ed25519, cuda_verify\n"
        "from p1_tpu_torch.benchmarks import vpu_roofline\n"
        "wrappers = (cuda_backend.sha256d_search, cuda_verify.verify_chain, vpu_roofline.int_roofline,\n"
        "            cuda_ed25519.ed25519_msm)\n"
        "bad += [type(w).__name__ for w in wrappers if w._built is not None or w.launches]\n"
        "from p1_tpu_torch.core import _ed25519_native\n"
        "from p1_tpu_torch.hashx import native_backend\n"
        "if native_backend._LIB is not None or _ed25519_native._LIB is not None or _ed25519_native._LOAD_FAILED:\n"
        "    bad.append('native library loaded at import')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=PKG.parent,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, "PYTHONPATH": str(PKG.parent)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_planes_load_no_torch():
    """The simulation, serving and fault planes import torch only where
    they run device work: a ``serve`` process, which forks its workers,
    and a far-field shard, a spawned interpreter, load none of it, so
    neither initialises CUDA nor pays torch's import."""
    code = (
        "import sys\n"
        "import p1_tpu_torch.cli, p1_tpu_torch.node.queryplane, p1_tpu_torch.node.provision\n"
        "import p1_tpu_torch.node.farfield, p1_tpu_torch.node.netsim\n"
        "import p1_tpu_torch.node.scenarios, p1_tpu_torch.node.chaos\n"
        "sys.exit(1 if 'torch' in sys.modules else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=PKG.parent,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, "PYTHONPATH": str(PKG.parent)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_host_harness_children_load_no_torch():
    """The processes whose peak resident set is the figure measured —
    ``archive_scale --phase boot`` and ``memory_bound --measure`` — start
    from modules whose import loads no torch, nor do ``bench``'s plane
    modules or ``perf_record`` (``bench`` itself imports torch only when
    it measures)."""
    code = (
        "import sys\n"
        "import p1_tpu_torch.benchmarks.archive_scale, p1_tpu_torch.benchmarks.memory_bound\n"
        "import p1_tpu_torch.benchmarks.rss, p1_tpu_torch.hashx.perf_record, p1_tpu_torch.bench\n"
        "import p1_tpu_torch.benchmarks.maintenance_cadence, p1_tpu_torch.benchmarks.ledger_scale\n"
        "import p1_tpu_torch.benchmarks.query_plane, p1_tpu_torch.benchmarks.wallet_plane\n"
        "import p1_tpu_torch.benchmarks.netsim_scale, p1_tpu_torch.benchmarks.chaos_rate\n"
        "import p1_tpu_torch.benchmarks.snapshot_boot, p1_tpu_torch.benchmarks.telemetry_overhead\n"
        "import p1_tpu_torch.chain.headerplane, p1_tpu_torch.chain.store\n"
        "sys.exit(1 if 'torch' in sys.modules else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=PKG.parent,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, "PYTHONPATH": str(PKG.parent)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lint_loads_no_torch():
    """``lint`` is host code that reads the port's sources with ``ast``:
    a whole run through the command's entry point imports no torch, so it
    initialises no CUDA and runs the same with or without a card."""
    code = (
        "import sys\n"
        "from p1_tpu_torch import cli\n"
        "rc = cli.main(['lint'])\n"
        "sys.exit(rc or (3 if 'torch' in sys.modules else 0))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=PKG.parent,
        capture_output=True,
        text=True,
        timeout=120,
        env={**os.environ, "PYTHONPATH": str(PKG.parent)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violation(s)" in proc.stdout


def test_no_import_statement_names_jax_or_p1_tpu():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


def test_forbidden_prefix_rule():
    assert _forbidden("p1_tpu") and _forbidden("p1_tpu.hashx") and _forbidden("jax.numpy")
    assert not _forbidden("p1_tpu_torch") and not _forbidden("p1_tpu_torch.hashx")
