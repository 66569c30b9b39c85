"""The row-histogram ablation's reading of a SASS listing
(cuda_selection_criteria_tpu_torch/experiments/hist_split.py), on the
CPU: the functions of a cuobjdump -sass listing, the backward branches
that make its loops, and the row loop's instructions a byte, for a
straight-line loop (the loop's length over the bytes a pass counts) and
for the mask walk's nested per-byte loop (the inner loop's length).
The script itself runs only on the card."""

import pytest

from cuda_selection_criteria_tpu_torch.experiments import hist_split


def _line(addr, text):
    """One instruction as cuobjdump -sass prints it, with its encoding."""
    return (f"        /*{addr:04x}*/                   {text} ;"
            "                  /* 0x000fe20000000f00 */")


def _listing(functions):
    out = []
    for name, code in functions.items():
        out.append(f"\t\tFunction : {name}")
        out.append('\t.headerflags\t@"EF_CUDA_SM90"')
        out += [_line(a, t) for a, t in code]
    return "\n".join(out)


def _straight(n_red, pad=3):
    """A row loop of one 16-byte load, n_red shared reductions and pad
    other instructions, closed by a backward branch; code before and after
    it."""
    code = [(0x0, "LDC R1, c[0x0][0x28]"), (0x10, "@P0 BRA 0x900")]
    a = 0x20
    loop = a
    code.append((a, "@!P1 LDG.E.EF.128 R4, desc[UR6][R20.64]"))
    for k in range(n_red):
        a += 0x10
        code.append((a, f"PRMT R{8 + k % 4}, R4, 0x4440, RZ"))
        a += 0x10
        code.append((a, f"ATOMS.POPC.INC.32 RZ, [R{8 + k % 4}+URZ]"))
    for _ in range(pad):
        a += 0x10
        code.append((a, "IADD3 R2, R2, 0x1, RZ"))
    a += 0x10
    code.append((a, f"@P1 BRA 0x{loop:x}"))
    code.append((a + 0x10, "EXIT"))
    return code


def _walk(inner_len):
    """An outer loop with a load around an inner loop of inner_len
    instructions (its branch included) that holds no load."""
    code = [(0x0, "LDC R1, c[0x0][0x28]")]
    a = 0x10
    outer = a
    code.append((a, "LDG.E.128 R4, desc[UR6][R2.64]"))
    a += 0x10
    inner = a
    for k in range(inner_len - 1):
        code.append((a, "LDS R8, [R9]" if k == 1 else "FLO.U32 R6, R5"))
        a += 0x10
    code.append((a, f"@P2 BRA 0x{inner:x}"))
    a += 0x10
    code.append((a, f"@P3 BRA `(0x{outer:x})"))
    code.append((a + 0x10, "EXIT"))
    return code


def test_functions_split_a_listing():
    """Every function's instructions, by address, under its own name; the
    encoding words between them are not instructions."""
    code = _straight(4)
    got = hist_split._functions(_listing({"hs_a": code, "hs_b": code[:3]}))
    assert list(got) == ["hs_a", "hs_b"]
    assert got["hs_a"] == code and got["hs_b"] == code[:3]


@pytest.mark.parametrize("n_red,pad", [(64, 3), (64, 60), (16, 0)])
def test_straight_loop_counts_a_byte(n_red, pad):
    """A straight-line row loop: its length over LOOP_BYTES bytes a pass,
    its shared-memory instructions counted, no inner loop; the forward
    branch before it and the code after it are not part of it."""
    got = hist_split.loop_counts(_straight(n_red, pad))
    n = 1 + 2 * n_red + pad + 1
    assert got == dict(loop=n, shared=n_red, inner=None,
                       per_byte=n / hist_split.LOOP_BYTES)


@pytest.mark.parametrize("inner_len", [7, 35])
def test_walk_loop_counts_its_inner_loop(inner_len):
    """A loop nested in the row loop (the mask walk's per-byte loop)
    gives the instructions a byte; a loop without a load is never taken
    for the row loop."""
    got = hist_split.loop_counts(_walk(inner_len))
    assert got["inner"] == [inner_len] and got["per_byte"] == inner_len
    assert got["loop"] == inner_len + 2 and got["shared"] == 1


def test_no_row_loop():
    """Code without a backward branch around a load has no row loop."""
    assert hist_split.loop_counts(_straight(4)[:3]) is None
    assert hist_split.loop_counts([(0x0, "FLO.U32 R6, R5"),
                                   (0x10, "@P0 BRA 0x0")]) is None
