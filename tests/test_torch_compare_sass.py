"""compare_sass.py's reading of ``cuobjdump -sass`` listings (no toolkit
needed: the listings are written out here)."""

import importlib.util
import os

import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                     "compare_sass.py")
_spec = importlib.util.spec_from_file_location("compare_sass", _PATH)
compare_sass = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(compare_sass)


def listing(*kernels):
    """A cuobjdump -sass listing of (name, instruction lines) kernels."""
    out = ["", "\tcode for sm_90a"]
    for name, lines in kernels:
        out += [f"\t\tFunction : {name}",
                '\t.headerflags\t@"EF_CUDA_SM90"']
        for i, ln in enumerate(lines):
            out += [f"        /*{16 * i:04x}*/  {ln} ;  /* 0x00{i:014x} */",
                    f"                            /* 0x000fe2{i:010x} */"]
        out.append("\t\t..........")
    return "\n".join(out)


def body(name, last="EXIT"):
    return [
        "LDC R1, c[0x0][0x28]",
        "@P0 BRA `(.L_x_7)",
        f"CALL.REL.NOINC `(${name}$__internal_0_$__cuda_sm20_div_s64)",
        ".L_x_7: IMAD R2, R3, 0x3, RZ",
        "BRA `(.L_x_9)",
        last,
    ]


@pytest.mark.parametrize("changed, twin", [(False, True), (True, False)])
def test_compare_sass_matches_renamed_instances(changed, twin):
    """A kernel whose name (and so its internal subroutines' names) and
    label numbers changed is the same kernel; one changed instruction is
    not."""
    old_name = "_Z16band_conv_kernelILi27ELb1ELi32ELb1EEvPKi"
    new_name = "_Z16band_conv_kernelILi27ELi3ELi64ELb1ELi32ELb1EEvPKi"
    old = compare_sass.parse_sass(listing((old_name, body(old_name))))
    new_body = [ln.replace("L_x_7", "L_x_41").replace("L_x_9", "L_x_40")
                for ln in body(new_name, "RET" if changed else "EXIT")]
    new = compare_sass.parse_sass(listing(
        (new_name, new_body), ("_Z5otherv", ["EXIT"])))
    assert len(old[old_name]) == 12  # instructions and their control words
    twins = compare_sass.compare(old, new)
    assert twins == {old_name: [new_name] if twin else []}
