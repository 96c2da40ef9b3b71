"""Writes the PTX of the BP kernel's item loop (`csrc/bp.cu` includes it
as ``bp_items.cuh``).

A warp owns two neighbouring sources, a lane R neighbouring samples of
each: acc[0][c], acc[1][c].  An item is one staged row for that pair: the
lane loads a window x[0 .. R + |delta|) of the row once, delta being the
difference of the two sources' moveouts on the row, and does
``acc[0][c] += wa * x[c + max(-delta, 0)]`` and ``acc[1][c] += wb *
x[c + max(delta, 0)]``.  Register arrays take no run-time index, so every
delta in (-D, D) has its own block of loads and `fma`, and an item's code
selects its block; two more blocks serve a row that only one source of
the pair uses (or on which the two lie D or more apart).

nvcc lowers a C++ `switch` of that size to a tree of compares; PTX has the
indexed branch (`brx.idx`) that C++ lacks, so the loop over a warp's items
is written here in PTX, one `asm` statement.  It is threaded code: every
block ends with the indexed branch to the next item's block, so that the
branch's table lookup is scheduled under this block's work, and the item
after the next is loaded meanwhile.  The text depends on R and D, which is
why it is generated: `header(r, d)` returns the header's text, which
defines the macro ``BP_ITEMS(acc, addr, rows)``.

Codes: ``delta + D - 1`` for a pair, ``2 D - 1`` and ``2 D`` for the
first and the second source alone, ``2 D + 1`` ends the loop.
"""

from __future__ import annotations


def header(r: int, d: int) -> str:
    """The text of bp_items.cuh for BP_R = r, BP_D = d."""
    op_addr, op_rows = 2 * r, 2 * r + 1
    n_codes = 2 * d + 1

    def block(label, a_shift, b_shift):
        """One item's block; a shift of None: that source takes no part."""
        n_x = r + max(a_shift or 0, b_shift or 0)
        out = [f"{label}:",
               # the item after the next; past the end mark this reads up
               # to two elements on, inside the slot: not used
               f"ld.shared.v4.b32 {{c2, o2, wa2, wb2}}, [%{op_addr}+32];",
               f"shl.b32 o0, o0, 2;", f"add.s32 o0, o0, %{op_rows};"]
        out += [f"ld.shared.f32 x{j}, [o0+{4 * j}];" for j in range(n_x)]
        for c in range(r):
            if a_shift is not None:
                out.append(f"fma.rn.f32 %{c}, wa, x{c + a_shift}, %{c};")
            if b_shift is not None:
                out.append(f"fma.rn.f32 %{r + c}, wb, x{c + b_shift}, "
                           f"%{r + c};")
        # the next item becomes the current one; on to its block
        out += ["mov.b32 code, c1;", "mov.b32 o0, o1;", "mov.b32 wa, wa1;",
                "mov.b32 wb, wb1;", "mov.b32 c1, c2;", "mov.b32 o1, o2;",
                "mov.b32 wa1, wa2;", "mov.b32 wb1, wb2;",
                f"add.s32 %{op_addr}, %{op_addr}, 16;",
                "brx.idx.uni code, tbl;"]
        return out

    lines = [
        "{",
        ".reg .b32 code, o0, c1, o1, wa1, wb1, c2, o2, wa2, wb2;",
        ".reg .f32 wa, wb;",
        f".reg .f32 x<{r + d - 1}>;",
        "tbl: .branchtargets "
        + ", ".join(f"I{i}" for i in range(n_codes)) + ", DONE;",
        f"ld.shared.v4.b32 {{code, o0, wa1, wb1}}, [%{op_addr}];",
        "mov.b32 wa, wa1;",
        "mov.b32 wb, wb1;",
        f"ld.shared.v4.b32 {{c1, o1, wa1, wb1}}, [%{op_addr}+16];",
        "brx.idx.uni code, tbl;",
    ]
    for delta in range(-d + 1, d):
        lines += block(f"I{delta + d - 1}", max(-delta, 0), max(delta, 0))
    lines += block(f"I{2 * d - 1}", 0, None)
    lines += block(f"I{2 * d}", None, 0)
    lines += ["DONE:", "}"]
    out = [
        "// Generated by seismic_bpmf_tpu_torch/_bp_items.py for "
        f"BP_R = {r}, BP_D = {d}: do not edit.",
        "#pragma once",
        f"#if BP_R != {r} || BP_D != {d}",
        '#error "bp_items.cuh was generated for other sizes"',
        "#endif",
        "// The items from the shared-memory byte address `addr` on, up to",
        "// the end mark, at which `addr` is left; `rows`: the byte address",
        "// of this lane's first sample in the slot's rows.",
        "#define BP_ITEMS(acc, addr, rows) asm volatile( \\",
    ]
    out += [f'    "{ln}\\n" \\' for ln in lines]
    accs = ", ".join(f'"+f"(acc[{k}][{c}])' for k in range(2)
                     for c in range(r))
    out += [f'    : {accs}, "+r"(addr) \\', '    : "r"(rows))', ""]
    return "\n".join(out)
