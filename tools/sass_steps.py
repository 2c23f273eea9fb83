"""Issued instructions per (pair, gene) step in the colDeltaCor kernels'
inner loops, read from their SASS on a machine with the CUDA toolkit.

Builds the kernels (velocyto_tpu_torch.kernels.build), disassembles each
library with cuobjdump, and for every sqrt and log10 instantiation finds
the innermost loop that holds the step (the smallest loop, by a backward
branch, with a MUFU.SQRT or MUFU.LG2 in it). Each step has exactly one of
those ops, so the loop's instruction count over its MUFU count is the
instructions issued per step; the loop's opcode mix is printed beside it.

    python3 tools/sass_steps.py

Run from the repo root.
"""
import collections
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs                                    # noqa: E402
from velocyto_tpu_torch import kernels                     # noqa: E402


def functions(sass):
    """{kernel name: [(address, instruction), ...]} of a SASS listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = cs._short_name(m.group(1))
            out[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(instruction):
    words = instruction.split()
    return words[1] if words[0].startswith("@") else words[0]


def step_loop(instructions):
    """The opcodes of the smallest loop holding a MUFU.SQRT or MUFU.LG2."""
    best = None
    for address, ins in instructions:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= address:
            continue
        body = [opcode(i) for a, i in instructions
                if int(m.group(1), 16) <= a <= address]
        if any(op in ("MUFU.SQRT", "MUFU.LG2") for op in body) and \
                (best is None or len(body) < len(best)):
            best = body
    return best


def main():
    libs = kernels.build()
    for stem in ("coldeltacor_dense", "coldeltacor_partial"):
        sass = cs._sass(libs[stem])
        if sass is None:
            sys.exit("no cuobjdump in the CUDA toolkit")
        for name, instructions in sorted(functions(sass).items()):
            body = step_loop(instructions)
            if body is None:
                continue                 # the linear transform: no MUFU
            ops = collections.Counter(body)
            steps = ops["MUFU.SQRT"] + ops["MUFU.LG2"]
            print(f"# {name}: inner loop {len(body)} instructions, {steps} "
                  f"steps, {len(body) / steps!r} per step; "
                  f"{dict(ops.most_common(12))}", flush=True)


if __name__ == "__main__":
    main()
