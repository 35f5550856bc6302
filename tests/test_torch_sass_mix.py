"""CPU tests of ``vct_torch/tools/sass_mix.py``'s reading of a
``cuobjdump -sass`` listing (the tool itself needs nvcc and runs on the
card's machine)."""

from vct_torch.tools import sass_mix

# Two kernels as cuobjdump prints them: one with an outer loop around an
# inner loop that holds the MUFU, one with no loop.
_LISTING = """
	code for sm_90a
		Function : _Z4loopv
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
        /*0010*/                   IADD3 R2, R1, 0x1, RZ ;                    /* 0x0000000101027810 */
        /*0020*/                   FFMA R3, R2, R2, R1 ;                      /* 0x0000000202037223 */
        /*0030*/                   MUFU.RCP R4, R3 ;                          /* 0x0000000300047308 */
        /*0040*/              @!P0 BRA 0x20 ;                                 /* 0xfffffffc00008947 */
        /*0050*/                   LDS R5, [R1] ;                             /* 0x0000000001057984 */
        /*0060*/               @P1 BRA 0x10 ;                                 /* 0xfffffffc00008947 */
        /*0070*/                   EXIT ;                                     /* 0x000000000000794d */
		Function : _Z4flatv
        /*0000*/                   FADD R1, R2, R3 ;                          /* 0x0000000302017221 */
        /*0010*/                   EXIT ;                                     /* 0x000000000000794d */
"""


def test_mix_reads_each_kernel_with_its_branch_targets():
    got = sass_mix.mix(_LISTING)
    assert list(got) == ["_Z4loopv", "_Z4flatv"]
    assert [op for _, op, _ in got["_Z4loopv"]] == ["LDC", "IADD3", "FFMA", "MUFU", "BRA", "LDS",
                                                    "BRA", "EXIT"]
    assert [t for _, _, t in got["_Z4loopv"] if t is not None] == [0x20, 0x10]


def test_hot_loop_is_the_smallest_loop_with_the_most_mufu():
    got = sass_mix.mix(_LISTING)
    assert sass_mix.hot_loop(got["_Z4loopv"]) == {"FFMA": 1, "MUFU": 1, "BRA": 1}
    assert sass_mix.hot_loop(got["_Z4flatv"]) == {}
    kinds = sass_mix.by_kind(sass_mix.hot_loop(got["_Z4loopv"]))
    assert kinds == {"f32": 1, "slow (conversions, MUFU)": 1, "control": 1}
