"""The SASS reader on a listing written by hand.

``sdfkit_tpu_torch/render/cuda/sass.py`` reads ``cuobjdump -sass`` of a built
kernel library, which exists only where there is an ``nvcc``. The parser is
plain text work: here it gets a listing in cuobjdump's layout with two
kernels, nested loops, predicated instructions and a slow-path subroutine
behind the exit.
"""

from sdfkit_tpu_torch.render.cuda import sass

LISTING = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _Z19raymarch_fwd_kernelILb1EEvPKfS1_10RenderArgsPfS3_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
                                                                                /* 0x000e220000000800 */
        /*0010*/                   S2R R0, SR_CTAID.X ;                         /* 0x0000000000007919 */
        /*0020*/               @P0 EXIT ;                                       /* 0x000000000000094d */
        /*0030*/                   MUFU.RCP R4, R3 ;                            /* 0x0000000300047308 */
        /*0040*/                   LDG.E.CONSTANT R5, desc[UR4][R2.64] ;        /* 0x0000000402057981 */
        /*0050*/                   MUFU.RSQ R6, R5 ;                            /* 0x0000000500067308 */
        /*0060*/                   FCHK P0, R2, R3 ;                            /* 0x0000000302007302 */
        /*0070*/                   MUFU.RSQ R7, R5 ;                            /* 0x0000000500077308 */
        /*0080*/              @!P1 BRA 0x40 ;                                   /* 0xfffffff800e49947 */
        /*0090*/                   FADD R2, R2, R3 ;                            /* 0x0000000302027221 */
        /*00a0*/               @P2 BRA 0x30 ;                                   /* 0xfffffff800e02947 */
        /*00b0*/                   BRA 0xd0 ;                                   /* 0x0000000000047947 */
        /*00c0*/                   MUFU.RSQ R7, R5 ;                            /* 0x0000000500077308 */
        /*00d0*/                   EXIT ;                                       /* 0x000000000000794d */
        /*00e0*/                   MUFU.RCP R4, R3 ;                            /* 0x0000000300047308 */
        /*00f0*/                   RET.REL.NODEC R2 0x0 ;                       /* 0xfffffff002007950 */
		..........

		Function : _Z19raymarch_fwd_kernelILb0EEvPKfS1_10RenderArgsPfS3_
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                       /* 0x00000a00ff017b82 */
        /*0010*/                   EXIT ;                                       /* 0x000000000000794d */
        /*0020*/                   BRA 0x20;                                    /* 0xfffffffffffc7947 */
"""


def test_loops_are_found_by_their_backward_branches():
    parsed = sass.parse_sass(LISTING)
    assert set(parsed) == {"rgb", "depth"}
    rgb = parsed["rgb"]
    assert rgb["instructions"] == 16
    outer, inner = rgb["loops"]
    assert (outer["start"], outer["end"], inner["start"], inner["end"]) == (0x30, 0xa0, 0x40, 0x80)
    assert inner == {"start": 0x40, "end": 0x80, "instructions": 5, "own": 5, "rsq": 2, "rcp": 0,
                     "fchk": 1, "loads": 1, "stores": 0, "votes": 0}
    # The outer loop owns its reciprocal, the add and its branch, not the inner loop's body.
    assert (outer["instructions"], outer["own"], outer["rsq"], outer["rcp"]) == (8, 3, 0, 1)
    assert outer["loads"] == 0
    assert sass.per_evaluation(inner, 2) == 5.0 and sass.per_evaluation(outer, 2) is None
    # A branch to itself (the trap behind a kernel) is not a loop.
    assert parsed["depth"] == {"instructions": 3, "loops": []}


def test_kernels_are_keyed_as_the_build_report_keys_them():
    assert sass.kernel_key("_Z19raymarch_bwd_kernelILb1EEv10RenderArgsPKfS2_Pf") == "rgb"
    assert sass.kernel_key("_Z19raymarch_bwd_kernelILb0EEv10RenderArgsPKfS2_Pf") == "depth"
    assert sass.kernel_key("_Z22reduce_partials_kernelPKfiiPf") == "reduce"
    # The ray-batch forward's second template argument, WANT_HIT.
    assert sass.kernel_key("_Z24raymarch_rays_fwd_kernelILb1ELb1EEvPKfS1_S1_S1_S1_S1_10RenderArgsPfPh") \
        == "rgb_hit"
    assert sass.kernel_key("_Z24raymarch_rays_fwd_kernelILb1ELb0EEvPKfS1_S1_S1_S1_S1_10RenderArgsPfPh") \
        == "rgb"
    assert sass.kernel_key("_Z24raymarch_rays_fwd_kernelILb0ELb0EEvPKfS1_S1_S1_S1_S1_10RenderArgsPfPh") \
        == "depth"


MARCH = """
		Function : _Z19raymarch_fwd_kernelILb1EEv10RenderArgsPfS0_
        /*0000*/                   S2R R0, SR_TID.X ;                           /* 0x0000000000007919 */
        /*0010*/                   VOTE.ANY R8, PT, PT ;                        /* 0x0000000000087806 */
        /*0020*/                   STG.E desc[UR4][R2.64], R5 ;                 /* 0x0000000502007986 */
        /*0030*/                   MUFU.RSQ R6, R5 ;                            /* 0x0000000500067308 */
        /*0040*/                   ISETP.NE.AND P0, PT, R6, R5, PT ;            /* 0x000000050600720c */
        /*0050*/                   VOTE.ALL P1, P0, R8 ;                        /* 0x0000000000087806 */
        /*0060*/              @!P1 BRA 0x20 ;                                   /* 0xfffffff800e49947 */
        /*0070*/                   STG.E desc[UR4][R2.64], R6 ;                 /* 0x0000000602007986 */
        /*0080*/               @P2 BRA 0x70 ;                                   /* 0xfffffff800e02947 */
        /*0090*/                   EXIT ;                                       /* 0x000000000000794d */
"""


def test_a_march_loop_counts_its_vote_and_its_stores():
    """The forwards' march loop holds the vote of a warp at its fixed point
    (and, with store, a store a step); the loop after it writes the rows a
    settled warp did not step through."""
    march, rows = sass.parse_sass(MARCH)["rgb"]["loops"]
    assert (march["own"], march["rsq"], march["votes"], march["stores"]) == (5, 1, 1, 1)
    assert (rows["own"], rows["rsq"], rows["votes"], rows["stores"]) == (2, 0, 0, 1)
