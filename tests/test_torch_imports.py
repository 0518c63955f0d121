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


def test_every_module_imports_without_jax_or_p1_tpu():
    mods = _modules()
    assert "p1_tpu_torch.hashx.cuda_backend" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'p1_tpu'))\n"
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
