"""The unpack kernel's ablation's reading of a SASS listing
(cuda_selection_criteria_tpu_torch/experiments/unpack_split.py), on the
CPU: each instruction's opcode, the kernel of each variant found by its
mangled name at k = 5 and 6, and each loop's instructions and integer
instructions a register, for the word path's straight-line loop (32
registers a pass) and for the replaced design's loop with its runtime-k
plane loop nested in it (8 registers a pass, static counts). The script
itself runs only on the card."""

import pytest

from cuda_selection_criteria_tpu_torch.experiments import hist_split
from cuda_selection_criteria_tpu_torch.experiments import unpack_split
from test_torch_hist_split import _listing


@pytest.mark.parametrize("text,op", [
    ("@!P1 LDG.E.EF.128 R4, desc[UR6][R20.64]", "LDG"),
    ("LOP3.LUT R5, R4, 0x1010101, R5, 0xf8, !PT", "LOP3"),
    ("PRMT R9, R8, 0x4441, RZ", "PRMT"),
    ("@P0 BRA 0x900", "BRA"),
    ("LDS.U8 R10, [R9+UR4]", "LDS"),
    ("EXIT", "EXIT")])
def test_opcode_drops_predicate_and_modifiers(text, op):
    assert unpack_split.opcode(text) == op


def _word_loop(k, n_perm=24):
    """A grid-stride loop of k plane loads, 8k - 8 shifts and 8k masks, 32
    index extracts and shared loads, n_perm __byte_perm merges and two
    16-byte stores, closed by a backward branch; set-up before it that
    holds a global load (the table) and its own short loop."""
    code = [(0x0, "LDG.E.U8 R2, desc[UR4][R2.64]"), (0x10, "STS.U8 [R3], R2"),
            (0x20, "@P0 BRA 0x0"), (0x30, "BAR.SYNC.DEFER_BLOCKING 0x0")]
    a, ops = 0x40, []
    ops += [f"LDG.E.EF R{10 + j}, desc[UR6][R4.64+{4 * j:#x}]"
            for j in range(k)]
    ops += ["SHF.R.U32.HI R20, RZ, 0x1, R10"] * (8 * k - 8)
    ops += ["LOP3.LUT R21, R20, 0x1010101, R21, 0xf8, !PT"] * (8 * k)
    ops += ["PRMT R22, R21, 0x4441, RZ", "LDS.U8 R23, [R22]"] * 32
    ops += ["PRMT R24, R23, 0x40, R25"] * n_perm
    ops += ["STG.E.EF.128 desc[UR6][R6.64], R24",
            "STG.E.EF.128 desc[UR6][R6.64+0x10], R28",
            "IADD3 R4, P1, R4, UR8, RZ",
            "ISETP.GE.U32.AND P0, PT, R6, UR9, PT"]
    loop = a
    for t in ops:
        code.append((a, t))
        a += 0x10
    code.append((a, f"@!P0 BRA 0x{loop:x}"))
    code.append((a + 0x10, "EXIT"))
    return code, len(ops) + 1


@pytest.mark.parametrize("k", [5, 6])
def test_word_loop_counts_a_register(k):
    """The word path's loop: every instruction of the innermost loop that
    holds a shared load, over the 32 registers a pass; the integer ones
    (shifts, masks, extracts, merges, the walk's add and compare) apart."""
    code, n = _word_loop(k)
    got = unpack_split.loop_record(code, 32, "LDS")
    n_int = (8 * k - 8) + 8 * k + 32 + 24 + 2
    assert got == dict(loop=n, int=n_int, lds=32, ldg=k, stg=2, inner=None,
                       per_register=n / 32, int_per_register=n_int / 32)


def _replaced_loop(inner_len):
    """An outer loop with a runtime-k plane loop nested in it (a byte
    load, a multiply, masks and shifts; inner_len instructions with its
    branch), eight shared loads and an 8-byte store."""
    code = [(0x0, "S2R R0, SR_TID.X")]
    a = 0x10
    outer = a
    code.append((a, "IMAD.WIDE R4, R2, 0x1, R6"))
    a += 0x10
    inner = a
    body = ["LDG.E.U8.CONSTANT R8, desc[UR4][R4.64]",
            "IMAD R9, R8, 0x204081, RZ"]
    body += ["LOP3.LUT R9, R9, 0x1010101, RZ, 0xc0, !PT"] * (inner_len - 3)
    for t in body:
        code.append((a, t))
        a += 0x10
    code.append((a, f"@P1 BRA 0x{inner:x}"))
    a += 0x10
    for _ in range(8):
        code.append((a, "LDS.U8 R12, [R11]"))
        a += 0x10
    code.append((a, "STG.E.64 desc[UR4][R14.64], R12"))
    a += 0x10
    code.append((a, f"@P2 BRA 0x{outer:x}"))
    code.append((a + 0x10, "EXIT"))
    return code


@pytest.mark.parametrize("inner_len", [6, 9])
def test_replaced_loop_counts_as_laid_out(inner_len):
    """The replaced design's loop: the outer loop (the one that holds the
    lookups), its nested plane loop counted once (static counts), over 8
    registers a pass."""
    code = _replaced_loop(inner_len)
    got = unpack_split.loop_record(code, 8, "LDS")
    outer = 1 + inner_len + 8 + 1 + 1
    n_int = 1 + (inner_len - 2)  # the walk's IMAD, the multiply and masks
    assert got == dict(loop=outer, int=n_int, lds=8, ldg=1, stg=1,
                       inner=[inner_len], per_register=outer / 8,
                       int_per_register=n_int / 8)
    # the innermost loop that holds a global load is the plane loop
    assert hist_split.loop_range(code) == (0x20, 0x20 + 0x10 * (
        inner_len - 1))


def test_listing_counts_finds_each_instantiation():
    """Each variant's kernel by the substrings of its mangled name: the
    word kernel at 256 threads apart from its 128- and 512-thread copies,
    k = 5 apart from k = 6, a variant without its kernel None."""
    funcs = {}
    for k in (5, 6):
        for t in (128, 256, 512):
            code, _ = _word_loop(k, n_perm=t // 16)
            funcs["_ZN44_GLOBAL__N__d1e2f3_19unpack_words_kernelILi"
                  f"{k}ELi{t}EEEvPKjxiPKhP5uint4"] = code
        funcs["_ZN44_GLOBAL__N__d1e2f3_19unpack_bytes_kernelILi"
              f"{k}EEEvPKhxxS2_Py"] = _replaced_loop(4 + k)
    funcs["_ZN2us18replaced_unpack_kernelEPKhxxiS1_Py"] = _replaced_loop(6)
    got = unpack_split.listing_counts(_listing(funcs))
    for k in (5, 6):
        for v, t in (("kernel", 256), ("t128", 128), ("t512", 512)):
            code, n = _word_loop(k, n_perm=t // 16)
            assert got[k][v]["loop"] == n
            assert got[k][v]["ldg"] == k
        assert got[k]["byte"]["inner"] == [4 + k]
        assert got[k]["replaced"]["inner"] == [6]
        assert got[k]["memory"] is None and got[k]["arith"] is None
