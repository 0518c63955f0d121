"""The port's native hash backend against the JAX package's, on the CPU.

Mirrors tests/test_native_backend.py on ``p1_tpu_torch.hashx.native_backend``
in both compressions (SHA-NI where the CPU has it, and the portable scalar
one through ``force_scalar``): digests against hashlib, first hits against
``p1_tpu.hashx.native_backend`` and the port's ``cpu`` backend.  Then where
the port builds its library: from ``p1_tpu_torch/native/*.cpp`` into
``build/p1_tpu_torch/``, never from or into the JAX package's cache
(``P1_NATIVE_CACHE`` does not move it), and the sources' code is the JAX
package's.  Inputs come from a numpy seed; comparisons are exact.
"""

import hashlib
import pathlib

import numpy as np
import pytest

from p1_tpu.hashx import get_backend as ref_get_backend
from p1_tpu_torch.core import BlockHeader
from p1_tpu_torch.hashx import get_backend, kernel_build, native_build

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def native():
    try:
        be = get_backend("native")
    except native_build.NativeBuildError as e:
        pytest.skip(f"native toolchain unavailable: {e}")
    yield be
    be.force_scalar(False)


@pytest.fixture(scope="module")
def ref_native():
    be = ref_get_backend("native")
    yield be
    be.force_scalar(False)


def _prefix(seed: int, difficulty: int = 12) -> bytes:
    rng = np.random.default_rng(seed)
    return BlockHeader(1, rng.bytes(32), rng.bytes(32), 1735689700, difficulty, 0).mining_prefix()


@pytest.mark.parametrize("scalar", [False, True])
class TestNative:
    def test_sha256d_matches_hashlib(self, native, ref_native, scalar):
        native.force_scalar(scalar)
        rng = np.random.default_rng(42)
        # Lengths straddling every padding boundary.
        for n in (0, 1, 31, 32, 55, 56, 57, 63, 64, 65, 80, 119, 120, 1000):
            data = rng.bytes(n)
            want = hashlib.sha256(hashlib.sha256(data).digest()).digest()
            assert native.sha256d(data) == ref_native.sha256d(data) == want, f"len={n} scalar={scalar}"

    @pytest.mark.parametrize("seed", [0, 3, 7])
    def test_search_parity_with_reference_and_cpu(self, native, ref_native, scalar, seed):
        native.force_scalar(scalar)
        ref_native.force_scalar(scalar)
        prefix = _prefix(seed)
        got = native.search(prefix, 0, 1 << 14, 10)
        want = ref_native.search(prefix, 0, 1 << 14, 10)
        assert (got.nonce, got.hashes_done) == (want.nonce, want.hashes_done)
        assert got == get_backend("cpu").search(prefix, 0, 1 << 14, 10), f"seed={seed} scalar={scalar}"

    def test_nonce_start_and_no_hit(self, native, scalar):
        native.force_scalar(scalar)
        prefix = _prefix(1)
        assert native.search(prefix, 500, 64, 0).nonce == 500
        res = native.search(prefix, 0, 64, 255)
        assert res.nonce is None and res.hashes_done == 64

    def test_top_of_nonce_space(self, native, scalar):
        native.force_scalar(scalar)
        prefix = _prefix(2, difficulty=4)
        start = (1 << 32) - 256
        assert native.search(prefix, start, 256, 4) == get_backend("cpu").search(prefix, start, 256, 4)


def test_force_scalar_reports_the_compression(native):
    native.force_scalar(False)
    shani = native.has_shani  # the CPU's: SHA-NI where it has the extension
    native.force_scalar(True)
    assert native.has_shani is False
    native.force_scalar(False)
    assert native.has_shani is shani


def test_host_only(native):
    from p1_tpu_torch.hashx.native_backend import NativeBackend

    with pytest.raises(ValueError, match="host only"):
        NativeBackend(device="cuda")
    with pytest.raises(ValueError):
        native.search(b"x" * 75, 0, 10, 8)


class TestBuild:
    """Where the port's library comes from and where it goes."""

    def test_built_from_the_ports_sources_into_its_build_dir(self, native):
        assert native_build.SOURCES == (
            REPO / "p1_tpu_torch" / "native" / "sha256d.cpp",
            REPO / "p1_tpu_torch" / "native" / "ed25519.cpp",
        )
        path = native_build.build_lib()
        assert path.parent == kernel_build.BUILD_DIR == REPO / "build" / "p1_tpu_torch"
        assert path == native_build.library_path() and path.exists()
        from p1_tpu_torch.hashx import native_backend

        assert pathlib.Path(native_backend._lib()._name) == path

    def test_jax_packages_cache_does_not_move_it(self, native, tmp_path, monkeypatch):
        monkeypatch.setenv("P1_NATIVE_CACHE", str(tmp_path))
        assert native_build.build_lib().parent == kernel_build.BUILD_DIR
        assert list(tmp_path.iterdir()) == []

    def test_source_edit_changes_the_library_name(self, monkeypatch, tmp_path):
        copies = []
        for src in native_build.SOURCES:
            copy = tmp_path / src.name
            copy.write_bytes(src.read_bytes() + b"\n// edited\n")
            copies.append(copy)
        before = native_build.library_path()
        monkeypatch.setattr(native_build, "SOURCES", tuple(copies))
        assert native_build.library_path() != before
        assert native_build.library_path().parent == kernel_build.BUILD_DIR

    @pytest.mark.parametrize("name", ["sha256d.cpp", "ed25519.cpp"])
    def test_code_is_the_jax_packages(self, name):
        # The copy's comments name the port's files; its code is the
        # reference's, line for line.
        def code(path):
            return [line for line in path.read_text().splitlines() if not line.lstrip().startswith("//")]

        assert code(REPO / "p1_tpu_torch" / "native" / name) == code(REPO / "p1_tpu" / "native" / name)

    def test_concurrent_builders_make_one_library(self, monkeypatch, tmp_path):
        # Threads that reach an unbuilt library together run one g++ (the
        # per-path lock) and all get its path.
        import threading

        monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
        runs = []
        real_run = native_build.subprocess.run

        def counting_run(cmd, **kw):
            runs.append(cmd)
            return real_run(cmd, **kw)

        monkeypatch.setattr(native_build.subprocess, "run", counting_run)
        paths = []
        threads = [threading.Thread(target=lambda: paths.append(native_build.build_lib())) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(runs) == 1 and len(set(paths)) == 1 and paths[0].parent == tmp_path
        assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]  # no temporary left

    def test_missing_compiler_raises_build_error(self, monkeypatch, tmp_path):
        monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        with pytest.raises(native_build.NativeBuildError, match="cannot run"):
            native_build.build_lib()
