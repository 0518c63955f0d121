"""The port's kernel build and SASS counting, on the CPU.

``kernel_build`` names each library by a hash of its source, the shared
headers of its ``csrc`` and the flags, and fails loudly without ``nvcc``;
``sass`` reads ``cuobjdump -sass`` text.  Neither needs a card: the build
is exercised up to the compiler, the parser on a synthetic listing in
``cuobjdump``'s format.
"""

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
    from p1_tpu_torch.hashx import cuda_backend, cuda_verify

    for source, csrc in (
        (cuda_backend.SearchKernel.SOURCE, kernel_build.CSRC),
        (cuda_verify.VerifyKernel.SOURCE, kernel_build.CSRC),
        (vpu_roofline.RooflineKernel.SOURCE, vpu_roofline.RooflineKernel.CSRC),
    ):
        assert (csrc / source).is_file()
        assert kernel_build.library_path(source, csrc).suffix == ".so"


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernel_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernel_build.os.path, "exists", lambda path: False)
    csrc = _csrc(tmp_path)
    with pytest.raises(kernel_build.KernelBuildError, match="nvcc not found"):
        kernel_build.build("k.cu", csrc)
    with pytest.raises(kernel_build.KernelBuildError, match="nvcc not found"):
        kernel_build.build_all([("k.cu", csrc)])
