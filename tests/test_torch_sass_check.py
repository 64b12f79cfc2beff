"""impx_torch/tools/sass_check.py on hand-written SASS, on the CPU: the two
wgmma register faults it reports, and the code it must leave alone. Its run
on the built kernels needs the CUDA toolkit."""
import pytest

from impx_torch.tools import sass_check as sc

QK = "HGMMA.64x64x8.F32.TF32 R24, R88, gdesc[UR12], RZ, !UPT"


def _sass(*lines):
    return "\n".join(f"        /*{16 * i:04x}*/                   {line} ;    /* 0x0000 */"
                     for i, line in enumerate(lines))


CASES = {
    # Q's fragments (R88..R91) loaded before the loop, read by the loop's HGMMA
    "clean loop": (["LDS.128 R88, [R2]", "WARPGROUP.ARRIVE", QK, "WARPGROUP.DEPBAR.LE gsb0, 0x0",
                    "FADD R4, R24, R25", "@!P0 BRA 0x10"], 0),
    "loop overwrites a fragment loaded before it": (
        ["LDS.128 R88, [R2]", "WARPGROUP.ARRIVE", QK, "WARPGROUP.DEPBAR.LE gsb0, 0x0",
         "LDS.64 R90, [UR6+0x31000]", "@!P0 BRA 0x10"], 2),
    "fragment written in the loop before the HGMMA": (
        ["MOV R1, R2", "LOP3.LUT R88, R28, 0xffffe000, RZ, 0xc0, !PT", "WARPGROUP.ARRIVE", QK,
         "WARPGROUP.DEPBAR.LE gsb0, 0x0", "@!P0 BRA 0x10"], 0),
    "accumulator written before the wait": (
        ["WARPGROUP.ARRIVE", QK, "FMUL R30, R4, R5", "WARPGROUP.DEPBAR.LE gsb0, 0x0", "FADD R30, R24, R25"], 1),
    "A operand written before the wait": (
        ["WARPGROUP.ARRIVE", QK, "IMAD.WIDE R90, R4, R5, RZ", "WARPGROUP.DEPBAR.LE gsb0, 0x0"], 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_faults_of_hand_written_sass(case):
    lines, want = CASES[case]
    found = sc.faults(sc.instructions(_sass(*lines)))
    assert len(found) == want, found


def test_written_registers_and_hgmma_operands():
    assert sc.written("@P0 MUFU.EX2 R108, R24") == [108]
    assert sc.written("LDS.128 R4, [R2]") == [4, 5, 6, 7]
    assert sc.written("CS2R R108, SRZ") == [108, 109]
    assert sc.written("STS.128 [R2], R4") == [] and sc.written("UIADD3 UR6, UR7, 0x10, URZ") == []
    acc, a = sc.hgmma("HGMMA.64x32x8.F32.TF32 R40, R120, gdesc[UR8], R40, gsb0")
    assert acc == list(range(40, 56)) and a == [120, 121, 122, 123]
    assert sc.hgmma("HGMMA.64x32x8.F32.TF32 R40, gdesc[UR4], R40") == (list(range(40, 56)), [])
