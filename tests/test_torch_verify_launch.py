"""The launch geometry of ``verify_chain.cu`` and the SASS count of its
rolled loops.

``cuda_verify.blocks_for`` sizes the kernel's grid in Python, so its
arithmetic is tested here; the kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the plain version.
"""

import numpy as np
import pytest

from p1_tpu_torch.hashx import cuda_verify

H100_SMS = 132
SIZES = [1, 31, 32, 33, 63, 64, 65, 127, 128, 3000, 10_000, 1 << 20]


@pytest.mark.parametrize("n", SIZES)
def test_every_header_falls_in_exactly_one_lane(n):
    blocks = cuda_verify.blocks_for(n)
    # Header i is thread i % THREADS of block i // THREADS.
    lanes = np.arange(blocks * cuda_verify.THREADS)
    np.testing.assert_array_equal(lanes[lanes < n], np.arange(n))
    assert (blocks - 1) * cuda_verify.THREADS < n  # no idle block


def test_the_replay_launch_reaches_every_sm():
    # 10,000 headers are 313 warps: in blocks of two warps every SM of an
    # H100 gets one; in blocks of four, 53 SMs would get none.
    assert cuda_verify.THREADS == 64
    assert cuda_verify.blocks_for(10_000) == 157 >= H100_SMS


@pytest.mark.parametrize("n", [0, -1, 1 << 31, 1 << 40])
def test_blocks_for_refuses_what_the_int32_cell_cannot_hold(n):
    with pytest.raises(ValueError, match="2\\*\\*31"):
        cuda_verify.blocks_for(n)


_LOOPED = """
\t\tFunction : _ZN12_GLOBAL__N_119verify_chain_kernelEPK5uint4iNS_10VerifyArgsEPi
        /*0000*/                   S2R R0, SR_TID.X ;                        /* 0x0000000000007919 */
        /*0010*/                   SHF.R.W.U32.HI R2, R3, 0x7, R3 ;          /* 0x0000000703027819 */
        /*0020*/                   LOP3.LUT R2, R2, R4, R5, 0x96, !PT ;      /* 0x0000000402027212 */
        /*0030*/                   IADD3 R6, R6, R2, RZ ;                    /* 0x0000000206067210 */
        /*0040*/               @P0 BRA 0x10 ;                                /* 0xfffffffc00000947 */
        /*0050*/                   LOP3.LUT R2, R2, R4, R5, 0x96, !PT ;      /* 0x0000000402027212 */
        /*0060*/                   IMAD.IADD R6, R6, 0x1, R2 ;               /* 0x0000000106067824 */
        /*0070*/               @P1 BRA 0x50 ;                                /* 0xfffffffc00000947 */
        /*0080*/                   EXIT ;                                    /* 0x000000000000794d */
        /*0090*/                   BRA 0x90;                                 /* 0xfffffffc00fc7947 */
"""


def test_per_item_counts_runs_every_loop_its_trips():
    # The SASS bound of a rolled kernel counts what a thread executes: two
    # loops (4 and 3 instructions, 3 and 1 ALU), three trips each.
    from p1_tpu_torch.hashx import sass

    insns = sass.function_insns(_LOOPED, "verify_chain_kernel")
    assert sass.counts(insns) == (10, 4)
    assert [len(b) for b in sass.loop_bodies(insns)] == [4, 3]
    assert sass.per_item_counts(insns, 3) == (10 + 2 * 7, 4 + 2 * 4)
    assert sass.per_item_counts(insns, 1) == sass.counts(insns)
