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
    "points,blocks",
    [(1, 1), (8, 1), (9, 2), (1032, 129), (1033, 130), (4105, 514), ((1 << 30) - 1, 1 << 27)],
)
def test_ed25519_geometry_covers_every_point_once(points, blocks):
    from p1_tpu_torch.hashx import cuda_ed25519

    got = cuda_ed25519.blocks_for(points)
    assert got == blocks
    per_block = cuda_ed25519.POINTS_PER_BLOCK
    assert got * per_block >= points > (got - 1) * per_block


def test_ed25519_geometry_fills_the_card_at_a_chunk():
    # A 1,024-signature chunk of eight keys (1,033 points with the base
    # point) gives about one block per SM of the H100's 132, each of more
    # than one warp.
    from p1_tpu_torch.hashx import cuda_ed25519

    assert 120 <= cuda_ed25519.blocks_for(1024 + 8 + 1) <= 132
    assert cuda_ed25519.THREADS > 32 and cuda_ed25519.THREADS % 32 == 0


@pytest.mark.parametrize("points", [0, -1, 1 << 30])
def test_ed25519_geometry_refuses(points):
    from p1_tpu_torch.hashx import cuda_ed25519

    with pytest.raises(ValueError, match="0 < N < 2\\*\\*30"):
        cuda_ed25519.blocks_for(points)


def _constant(text, name):
    import re

    body = re.search(name + r"\[[^]]*\] = \{([^}]*)\}", text).group(1)
    return [int(v.strip().rstrip("u"), 0) for v in body.split(",")]


@pytest.mark.parametrize("name,value", [("kD", "d"), ("kD2", "2d"), ("kSqrtM1", "sqrt(-1)")])
def test_ed25519_constants_in_the_source_match_the_radix(name, value):
    # The kernel hard-codes d, 2d and sqrt(-1) mod p in the radix; they
    # must be the plain version's.
    from p1_tpu_torch.hashx import cuda_ed25519, ed25519_msm

    py = ed25519_msm._py
    want = {"d": py._D, "2d": 2 * py._D, "sqrt(-1)": py._SQRT_M1}[value]
    text = (kernel_build.CSRC / cuda_ed25519.Ed25519Kernel.SOURCE).read_text()
    assert _constant(text, name) == ed25519_msm.fe_from_int(want).tolist()


def test_ed25519_q_and_geometry_in_the_source_match_the_wrapper():
    import re

    from p1_tpu_torch.hashx import cuda_ed25519, ed25519_msm

    text = (kernel_build.CSRC / cuda_ed25519.Ed25519Kernel.SOURCE).read_text()
    assert _constant(text, "kQWords") == list(ed25519_msm.Q_WORDS)
    assert f"kPointsPerBlock = {cuda_ed25519.POINTS_PER_BLOCK};" in text
    msm_warps = int(re.search(r"kMsmWarps = (\d+);", text).group(1))
    assert "kThreads = 32 * (1 + kMsmWarps);" in text and 32 * (1 + msm_warps) == cuda_ed25519.THREADS
    assert f"kFlagsOk = {ed25519_msm.FLAGS_OK};" in text


def test_ed25519_wrapper_refuses_cpu_tensors_without_building():
    import torch

    from p1_tpu_torch.hashx import cuda_ed25519

    kernel = cuda_ed25519.Ed25519Kernel()
    words = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 CUDA tensor"):
        kernel(words, words.clone(), torch.zeros((3, 4, 10), dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
               torch.zeros((1, 4, 10), dtype=torch.int32), torch.zeros(41, dtype=torch.int32))  # fmt: skip
    assert kernel._built is None and kernel.launches == 0


@pytest.mark.parametrize("scalar", ["q", "q_words"])
def test_ed25519_gate_work_follows_the_digits_of_q(scalar):
    # The gate adds one table row per non-zero digit of q and doubles four
    # times per window below its top non-zero digit (the doublings before
    # it would act on the identity); chip_smoke.py counts the same digits as
    # the kernel's kQWords and the plain version's Q_WORDS.
    import torch

    import chip_smoke
    from p1_tpu_torch.hashx import ed25519_msm

    if scalar == "q":
        digits = [(ed25519_msm._py._Q >> (4 * w)) & 15 for w in range(64)]
    else:
        digits = ed25519_msm.digits_of_words(torch.tensor([ed25519_msm.Q_WORDS]))[0].tolist()[::-1]
    assert tuple(digits) == chip_smoke.ED_Q_DIGITS
    assert (chip_smoke.ED_GATE_ADDS, chip_smoke.ED_GATE_DOUBLES) == (33, 252)
    assert sum(d == 0 for d in digits) == 31 and digits[63] == 1


def test_ed25519_pinned_work_is_the_reference_operation_count():
    # chip_smoke.py's bound for the 1,024-signature chunk (1,033 points):
    # the derivation written beside its constants.
    import chip_smoke

    per_point = chip_smoke.ed25519_work(1, chip_smoke.ED_OP_ALU_FMA)
    batch = chip_smoke.ed25519_work(0, chip_smoke.ED_OP_ALU_FMA)
    assert batch == (270_945, 195_480)
    assert (per_point[0] - batch[0], per_point[1] - batch[1]) == (442_545, 337_890)
    assert chip_smoke.ed25519_work(1033, chip_smoke.ED_OP_ALU_FMA) == (457_419_930, 349_235_850)
    assert chip_smoke.ED_OPS_PER_POINT == {"add": 14 + 33 + 64, "double": 252, "square": 251 + 3, "product": 11 + 9}
    assert chip_smoke.ED_OPS_PER_BATCH == {"add": 63 - 64, "double": 252, "square": 0, "product": 0}


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
