"""The port's kernel build and SASS counting, on the CPU.

``kernel_build`` names each library by a hash of its source, the shared
headers of its ``csrc`` and the flags, and fails loudly without ``nvcc``;
``sass`` reads ``cuobjdump -sass`` text.  Neither needs a card: the build
is exercised up to the compiler, the parser on a synthetic listing in
``cuobjdump``'s format.
"""

import pathlib

import pytest

from p1_tpu_torch.benchmarks import vpu_roofline
from p1_tpu_torch.hashx import kernel_build, sass

LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119int_roofline_kernelILi1ELi4EEEvNS_5SeedsEiPiPy
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
                                                                             /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                        /* 0x0000000000007919 */
        /*0020*/              @!P0 BRA 0x80 ;                                /* 0x0000000000008947 */
        /*0030*/                   SHF.R.W.U32.HI R2, R3, 0x7, R3 ;          /* 0x0000000703027819 */
        /*0040*/                   LOP3.LUT R2, R2, R4, R5, 0x96, !PT ;      /* 0x0000000402027212 */
        /*0050*/                   IMAD.IADD R6, R6, 0x1, R2 ;               /* 0x0000000106067824 */
        /*0060*/                   VIADD R7, R7, 0x1 ;                       /* 0x0000000107077836 */
        /*0070*/               @P0 BRA 0x30 ;                                /* 0xfffffffc00000947 */
        /*0080*/                   EXIT ;                                    /* 0x000000000000794d */
        /*0090*/                   BRA 0x90;                                 /* 0xfffffffc00fc7947 */
        /*00a0*/                   NOP;                                      /* 0x0000000000007918 */
\t\t..........
\t\tFunction : _ZN12_GLOBAL__N_119int_roofline_kernelILi1ELi8EEEvNS_5SeedsEiPiPy
        /*0000*/                   IADD3 R1, R2, R3, RZ ;                    /* 0x0000000302017210 */
        /*0010*/                   EXIT ;                                    /* 0x000000000000794d */
"""


def test_function_insns_and_counts():
    insns = sass.function_insns(LISTING, "int_roofline_kernelILi1ELi4EE")
    assert [i.opcode.split(".")[0] for i in insns] == [
        "LDC", "S2R", "BRA", "SHF", "LOP3", "IMAD", "VIADD", "BRA", "EXIT", "BRA",
    ]  # fmt: skip
    assert sass.counts(insns) == (10, 2)  # NOP dropped; SHF and LOP3 are ALU
    assert sass.counts(sass.function_insns(LISTING, "ILi1ELi8EE")) == (2, 1)


def test_function_insns_needs_one_match():
    with pytest.raises(RuntimeError, match="2 SASS functions"):
        sass.function_insns(LISTING, "int_roofline_kernel")
    with pytest.raises(RuntimeError, match="0 SASS functions"):
        sass.function_insns(LISTING, "verify_chain_kernel")


def test_loop_body_is_the_one_backward_branch():
    # The forward @!P0 BRA and the closing self-branch are no loops.
    body = sass.loop_body(sass.function_insns(LISTING, "ILi1ELi4EE"))
    assert [i.address for i in body] == [0x30, 0x40, 0x50, 0x60, 0x70]
    assert sass.opcode_histogram(body) == {"SHF": 1, "LOP3": 1, "IMAD": 1, "VIADD": 1, "BRA": 1}
    with pytest.raises(RuntimeError, match="one backward branch"):
        sass.loop_body(sass.function_insns(LISTING, "ILi1ELi8EE"))


@pytest.mark.parametrize(
    "opcode,alu",
    [
        ("SHF.R.W.U32.HI", True), ("LOP3.LUT", True), ("IADD3", True), ("ISETP.GE.AND", True),
        ("IMAD.IADD", False), ("VIADD", False), ("UIADD3", False), ("LDG.E", False),
        ("BRA", False), ("ATOMG.E.MIN", False),
    ],
)  # fmt: skip
def test_alu_pipe_classification(opcode, alu):
    assert sass.is_alu(opcode) is alu


def _csrc(tmp_path, source="k.cu", body="// kernel\n", header="// shared\n"):
    csrc = tmp_path / "csrc"
    csrc.mkdir(exist_ok=True)
    (csrc / source).write_text(body)
    (csrc / "shared.cuh").write_text(header)
    return csrc


def test_library_path_hashes_source_headers_and_flags(tmp_path):
    csrc = _csrc(tmp_path)
    first = kernel_build.library_path("k.cu", csrc)
    assert first.parent == kernel_build.BUILD_DIR and first.name.startswith("k_")
    assert kernel_build.library_path("k.cu", csrc) == first  # unchanged: same library
    (csrc / "shared.cuh").write_text("// shared, edited\n")
    second = kernel_build.library_path("k.cu", csrc)
    assert second != first  # an edited header rebuilds
    (csrc / "k.cu").write_text("// kernel, edited\n")
    assert kernel_build.library_path("k.cu", csrc) not in (first, second)


def test_kernel_sources_are_where_the_wrappers_look():
    from p1_tpu_torch.hashx import cuda_backend, cuda_ed25519, cuda_verify

    paths = set()
    for source, csrc in (
        (cuda_backend.SearchKernel.SOURCE, kernel_build.CSRC),
        (cuda_verify.VerifyKernel.SOURCE, kernel_build.CSRC),
        (vpu_roofline.RooflineKernel.SOURCE, vpu_roofline.RooflineKernel.CSRC),
        (cuda_ed25519.Ed25519Kernel.SOURCE, kernel_build.CSRC),
    ):
        assert (csrc / source).is_file()
        path = kernel_build.library_path(source, csrc)
        assert path.suffix == ".so" and path.name.startswith(pathlib.Path(source).stem + "_")
        assert kernel_build.library_path(source, csrc) == path  # a stable hash
        paths.add(path)
    assert len(paths) == 4


def test_ed25519_library_hash_follows_its_source(tmp_path):
    from p1_tpu_torch.hashx import cuda_ed25519

    source = cuda_ed25519.Ed25519Kernel.SOURCE
    csrc = _csrc(tmp_path, source=source, body=(kernel_build.CSRC / source).read_text())
    assert kernel_build.library_path(source, csrc) != kernel_build.library_path(source)  # other headers
    first = kernel_build.library_path(source, csrc)
    (csrc / source).write_text((csrc / source).read_text() + "// edited\n")
    assert kernel_build.library_path(source, csrc) != first


@pytest.mark.parametrize(
    "points,blocks", [(1, 1), (16, 1), (17, 2), (1032, 65), (4104, 257), ((1 << 30) - 1, 1 << 26)]
)
def test_ed25519_geometry_covers_every_point_and_role_once(points, blocks):
    from p1_tpu_torch.hashx import cuda_ed25519

    got = cuda_ed25519.blocks_for(points)
    assert got == blocks
    threads = cuda_ed25519.THREADS
    assert got * threads >= 2 * points > (got - 1) * threads


@pytest.mark.parametrize("points", [0, -1, 1 << 30])
def test_ed25519_geometry_refuses(points):
    from p1_tpu_torch.hashx import cuda_ed25519

    with pytest.raises(ValueError, match="0 < N < 2\\*\\*30"):
        cuda_ed25519.blocks_for(points)


def test_ed25519_constants_in_the_source_match_the_radix():
    # The kernel hard-codes 2d mod p in the radix and q's words; they must
    # be the plain version's.
    import re

    from p1_tpu_torch.hashx import cuda_ed25519, ed25519_msm

    text = (kernel_build.CSRC / cuda_ed25519.Ed25519Kernel.SOURCE).read_text()
    d2 = re.search(r"kD2\[kLimbs\] = \{([^}]*)\}", text).group(1)
    assert [int(v) for v in d2.split(",")] == ed25519_msm.fe_from_int(2 * ed25519_msm._py._D).tolist()
    q = re.search(r"kQWords\[8\] = \{([^}]*)\}", text).group(1)
    assert [int(v.strip().rstrip("u"), 0) for v in q.split(",")] == list(ed25519_msm.Q_WORDS)
    assert f"kGateThreads = {cuda_ed25519.THREADS};" in text


def test_ed25519_wrapper_refuses_cpu_tensors_without_building():
    import torch

    from p1_tpu_torch.hashx import cuda_ed25519

    kernel = cuda_ed25519.Ed25519Kernel()
    pts = torch.zeros((3, 4, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 CUDA tensor"):
        kernel(pts, torch.zeros((3, 8), dtype=torch.int32), pts.clone(),
               torch.zeros(3, dtype=torch.int32), torch.zeros(41, dtype=torch.int32))  # fmt: skip
    assert kernel._built is None and kernel.launches == 0


NESTED = """
\t\tFunction : _ZN4gate_smul_kernelEv
        /*0000*/                   IMAD R1, R2, R3, R4 ;
        /*0010*/                   IADD3 R1, R2, R3, RZ ;
        /*0020*/                   IMAD.WIDE R4, R2, R3, R4 ;
        /*0030*/               @P0 BRA 0x10 ;
        /*0040*/                   LOP3.LUT R2, R2, R4, R5, 0x96, !PT ;
        /*0050*/                   IMAD.WIDE R4, R2, R3, R4 ;
        /*0060*/                   SHF.R.S64 R2, R3, 0x7, R3 ;
        /*0070*/               @P1 BRA 0x50 ;
        /*0080*/               @P2 BRA 0x40 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
"""


def test_nested_counts_multiply_nested_trips():
    insns = sass.function_insns(NESTED, "gate_smul_kernel")
    assert sass.loop_ranges(insns) == [(0x10, 0x30), (0x40, 0x80), (0x50, 0x70)]
    # Outside loops: IMAD, EXIT, BRA (3); loop 1 x14: IADD3, IMAD.WIDE, BRA;
    # loop 2 x64: LOP3, BRA; its inner loop x64x4: IMAD.WIDE, SHF, BRA.
    total, alu, fma = sass.nested_counts(insns, [14, 64, 4])
    assert total == 3 + 14 * 3 + 64 * 2 + 256 * 3
    assert alu == 14 * 1 + 64 * 1 + 256 * 1
    assert fma == 1 + 14 * 1 + 256 * 1
    with pytest.raises(RuntimeError, match="expected 2 loops"):
        sass.nested_counts(insns, [14, 64])


@pytest.mark.parametrize("opcode,fma", [("IMAD.WIDE", True), ("IMAD.WIDE.U32", True), ("VIADD", True),
                                        ("IADD3", False), ("SHF.R.S64", False), ("LDL", False)])  # fmt: skip
def test_fma_pipe_classification(opcode, fma):
    assert sass.is_fma(opcode) is fma


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernel_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernel_build.os.path, "exists", lambda path: False)
    csrc = _csrc(tmp_path)
    with pytest.raises(kernel_build.KernelBuildError, match="nvcc not found"):
        kernel_build.build("k.cu", csrc)
    with pytest.raises(kernel_build.KernelBuildError, match="nvcc not found"):
        kernel_build.build_all([("k.cu", csrc)])
