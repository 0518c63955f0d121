"""The port's integer-ALU roofline vs the JAX package's Pallas kernel.

Mirrors ``benchmarks/vpu_roofline.py``: the reference's ``_bench_kernel``
runs as a Pallas ``pallas_call`` in interpret mode on the CPU, built here
with ``_make_bench``'s specs (SMEM seeds, SMEM output cell) plus
``interpret=True``; the port's ``bench_step`` (the kernel's plain PyTorch
version) runs on the same seeds.  The result is one int32: the tolerance
is exact.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from p1_tpu_torch.benchmarks import vpu_roofline as port

jax = pytest.importorskip("jax")
jnp = jax.numpy
pl = pytest.importorskip("jax.experimental.pallas")

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from benchmarks import vpu_roofline as ref  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.cache
def _interpreted(grid: int, iters: int, chains: int, mix: str):
    kern = functools.partial(ref._bench_kernel, iters=iters, chains=chains, mix=mix)
    call = pl.pallas_call(
        kern,
        grid=(grid,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((1,), lambda i: (0,), memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1,), jnp.int32),
        interpret=True,
    )
    return jax.jit(call)


def _seeds(chains: int, rep: int = 0) -> np.ndarray:
    """The reference's seeds, made with numpy for both packages."""
    return np.arange(1, chains + 1, dtype=np.uint32) * np.uint32(0x01000193) + np.uint32(rep)


def _both(grid, iters, chains, mix, rep=0) -> tuple[int, int]:
    seeds = _seeds(chains, rep)
    want = int(_interpreted(grid, iters, chains, mix)(jnp.asarray(seeds))[0])
    got = port.bench_step(seeds.tolist(), grid, iters, chains, mix, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (1,)
    return int(got[0]), want


@pytest.mark.parametrize("mix", port.MIXES)
@pytest.mark.parametrize("chains", [1, 2, 4])
@pytest.mark.parametrize("grid", [1, 3])
def test_bench_step_matches_interpreted_pallas(mix, chains, grid):
    got, want = _both(grid, 32, chains, mix)
    assert got == want


@pytest.mark.parametrize("mix", port.MIXES)
def test_iters_not_a_multiple_of_16(mix):
    # The reference runs iters // 16 × 16 iterations: 40 -> 32.
    got, want = _both(2, 40, 2, mix, rep=5)
    assert got == want
    assert got == int(port.bench_step(_seeds(2, 5).tolist(), 2, 32, 2, mix, "cpu")[0])


@pytest.mark.parametrize(
    "mix,value", [("add", 1451958), ("rot", 442074), ("sha", 1284299), ("round", 11496734)]
)
def test_known_values(mix, value):
    # Grid 2, iters 32, chains 2, seeds arange(1, 3) × 0x01000193: the
    # interpreted reference's own numbers.
    got, want = _both(2, 32, 2, mix)
    assert got == want == value


def test_zero_iterations_is_the_seed_fold():
    got, want = _both(3, 8, 4, "round")
    assert got == want


def test_count_ops_matches_reference():
    assert port.count_ops() == ref.count_ops()


def test_constants_match_reference():
    assert port.OPS_PER_ITER == ref.OPS_PER_ITER
    assert port.SUB == ref.SUB and port.LANES == ref.SUB * 128
    assert port.GRID % 132 == 0  # whole waves on an H100's 132 SMs


def test_sizing_follows_reference():
    for mix in port.MIXES:
        for chains in (4, 8):
            iters = port.iters_for(mix, chains)
            assert iters % 16 == 0 and iters >= 256
            ops = port.GRID * iters * chains * port.LANES * port.OPS_PER_ITER[mix]
            assert 0.99 * port.REF_OPS < ops <= port.REF_OPS


def test_roofline_step_on_cpu_is_the_plain_version():
    seeds = port.seeds_for(2)
    got = port.roofline_step(seeds, 2, 32, 2, "sha", device="cpu")
    assert int(got[0]) == 1284299
    assert port.int_roofline.launches == 0  # the CPU launches no kernel


@pytest.mark.parametrize(
    "seeds,grid,iters,chains,mix",
    [
        (port.seeds_for(2), 1, 16, 2, "mul"),
        (port.seeds_for(3), 1, 16, 2, "add"),  # three seeds for two chains
        (port.seeds_for(2), 0, 16, 2, "add"),
        (port.seeds_for(2), 1, -16, 2, "add"),
    ],
)
def test_bad_arguments_raise(seeds, grid, iters, chains, mix):
    with pytest.raises(ValueError):
        port.bench_step(seeds, grid, iters, chains, mix, device="cpu")


def test_kernel_wrapper_refuses_what_it_cannot_launch():
    out = torch.zeros((1,), dtype=torch.int32)
    for chains in (2, 3):  # no instance: nothing launches them on the card
        with pytest.raises(ValueError, match="chains in"):
            port.int_roofline(port.seeds_for(chains), 1, 16, chains, "add", out)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port.int_roofline(port.seeds_for(4), 1, 16, 4, "add", out)
    assert port.int_roofline.launches == 0


def test_run_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run_bench measures it (chip_smoke.py phase 5)")
    with pytest.raises(RuntimeError, match="CUDA device"):
        port.run_bench()


def _run_module(*args):
    return subprocess.run(
        [sys.executable, "-m", "p1_tpu_torch.benchmarks.vpu_roofline", *args],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_entry_point_count_only():
    proc = _run_module("--count")
    assert proc.returncode == 0, proc.stderr
    c = ref.count_ops()
    assert f"naive {c['naive']}" in proc.stdout and f"{c['V']} vector ops" in proc.stdout


def test_entry_point_without_card_fails():
    proc = _run_module()
    assert proc.returncode != 0
    assert "CUDA device" in proc.stderr
