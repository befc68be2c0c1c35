"""Whether two versions of a CUDA source compile to the same machine code.

    python3 compare_sass.py OLD.cu NEW.cu

Compiles both sources for ``sm_90a`` with the flags the port builds its
kernels with (``-O3 -std=c++17``), dumps each kernel's SASS with
``cuobjdump -sass`` and looks, for every kernel of OLD, for a kernel of NEW
whose instructions are the same. Names do not take part: a kernel's own
name in its body (its internal subroutines) and its local labels are
normalised, so an instance whose template arguments were renamed or grown
still finds its twin. Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit),
not a card. Prints one line per OLD kernel, then one line ``SASS {json}``
with the counts and the kernels of OLD that have no twin.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from treemorph_tpu_torch.ops.cuda import _nvcc

_LABEL = re.compile(r"\.L_x_\d+")


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(_nvcc()), name)


def _compile(sources: list[str], outdir: str) -> list[str]:
    """One cubin per source, the nvcc runs started together."""
    outs = [os.path.join(outdir, f"{i}.cubin") for i in range(len(sources))]
    procs = [subprocess.Popen([
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-cubin", "-o", out, src]) for src, out in zip(sources, outs)]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("nvcc failed")
    return outs


def parse_sass(text: str) -> dict[str, tuple[str, ...]]:
    """{kernel name: its normalised instruction lines} of a
    ``cuobjdump -sass`` listing."""
    kernels: dict[str, list[str]] = {}
    body = None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            body = kernels.setdefault(name, [])
        elif body is not None and "/*" in line:
            body.append(line.strip())
    out = {}
    for name, lines in kernels.items():
        labels: dict[str, str] = {}

        def local(m):
            return labels.setdefault(m.group(0), f".L{len(labels)}")

        out[name] = tuple(_LABEL.sub(local, ln.replace(name, "@SELF"))
                          for ln in lines)
    return out


def _demangle(names: list[str]) -> dict[str, str]:
    filt = _tool("cu++filt")
    if not os.path.exists(filt) and not shutil.which("c++filt"):
        return {n: n for n in names}
    run = subprocess.run([filt if os.path.exists(filt) else "c++filt"],
                         input="\n".join(names), capture_output=True,
                         text=True, check=True)
    return dict(zip(names, run.stdout.splitlines()))


def compare(old: dict, new: dict) -> dict:
    """For each kernel of ``old``, the kernels of ``new`` with the same
    instructions."""
    by_body: dict[tuple, list[str]] = {}
    for name, body in new.items():
        by_body.setdefault(body, []).append(name)
    return {name: by_body.get(body, []) for name, body in old.items()}


def main(old_src: str, new_src: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        sass = [parse_sass(subprocess.run(
            [_tool("cuobjdump"), "-sass", cubin], capture_output=True,
            text=True, check=True).stdout)
            for cubin in _compile([old_src, new_src], tmp)]
    twins = compare(*sass)
    names = _demangle(sorted({*sass[0], *sass[1]}))
    for name, found in sorted(twins.items()):
        print(f"{names[name]} -> "
              f"{', '.join(names[n] for n in found) or 'NO IDENTICAL KERNEL'}")
    result = {"old": old_src, "new": new_src, "old_kernels": len(sass[0]),
              "new_kernels": len(sass[1]),
              "with_identical_twin": sum(bool(f) for f in twins.values()),
              "without_twin": [names[n] for n, f in twins.items() if not f]}
    print("SASS " + json.dumps(result))
    return result


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
