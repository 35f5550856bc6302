"""Count the instructions nvcc compiles a kernel source into, by kind.

    python3 -m vct_torch.tools.sass_mix [SOURCE.cu ...] [--kernel NAME_FRAGMENT]

Compiles each source (default ``vct_torch/csrc/ssim.cu``) to a cubin with
the flags of ``vct_torch/ops/_build.py``, disassembles it with
``cuobjdump -sass`` and prints, as one JSON line for each kernel whose
mangled name holds the fragment, the static count of its instructions by
opcode and by the pipe they issue to (full-rate f32, integer, the 16-a-clock
conversions and special functions, f64, shared and global memory, control),
for the whole kernel and for its hot loop: the smallest loop (a backward
branch) that holds most of its MUFU instructions (K4's divisions). Static
counts: a loop body counts once, with the branches it may skip, so divide
by what one pass of the body computes. Needs nvcc and cuobjdump (the CUDA
toolkit).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from vct_torch.ops import _build

# Opcode (before the first '.') -> kind; the rest are "other".
_KINDS = {
    "f32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FCHK"),
    "int": ("IADD3", "IMAD", "LOP3", "SHF", "ISETP", "IABS", "LEA", "SEL", "PRMT", "IMNMX",
            "SGXT", "BMSK", "POPC", "FLO", "IMUL", "VIADD", "VIMNMX", "IDP"),
    "slow (conversions, MUFU)": ("I2F", "F2I", "F2F", "I2FP", "F2IP", "MUFU", "FRND"),
    "f64": ("DADD", "DMUL", "DFMA", "DSETP"),
    "shared memory": ("LDS", "STS", "LDSM", "LDGSTS"),
    "global memory": ("LDG", "STG", "LD", "ST", "ATOMG", "RED", "ATOM"),
    "shuffle / barrier": ("SHFL", "BAR", "MEMBAR", "DEPBAR", "WARPSYNC"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "CALL", "RET", "BREAK", "NOP", "YIELD"),
    "move": ("MOV", "S2R", "S2UR", "CS2R", "R2UR", "ULDC", "UMOV", "UIADD3", "ULOP3",
             "USHF", "UIMAD", "ULEA", "USEL", "UISETP", "UPRMT"),
}
_KIND_OF = {op: kind for kind, ops in _KINDS.items() for op in ops}
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]*)?"
                   r"(?:\s+(0x[0-9a-f]+))?")


def _nvcc_tool(name: str) -> str:
    nvcc = Path(_build._nvcc())
    return str(nvcc.with_name(name))


def sass(source: Path) -> str:
    """``cuobjdump -sass`` of ``source`` compiled with the library's flags."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        flags = [f for f in _build._FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([_build._nvcc(), *flags, "-cubin", str(source), "-o", cubin], check=True,
                       capture_output=True, text=True)
        return subprocess.run([_nvcc_tool("cuobjdump"), "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout


def mix(text: str) -> dict:
    """{kernel: [(address, opcode, branch target or None), ...]} from a
    ``cuobjdump -sass`` listing."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.match(line)
        if m and name:
            target = int(m.group(4), 16) if m.group(2) == "BRA" and m.group(4) else None
            out[name].append((int(m.group(1), 16), m.group(2), target))
    return out


def hot_loop(insns) -> collections.Counter:
    """Opcodes of the smallest loop holding the most MUFU instructions."""
    best = None
    for addr, op, target in insns:
        if target is None or target > addr:
            continue
        body = [o for a, o, _ in insns if target <= a <= addr]
        key = (-body.count("MUFU"), len(body))
        if best is None or key < best[0]:
            best = (key, body)
    return collections.Counter(best[1] if best else [])


def by_kind(ops: collections.Counter) -> dict:
    kinds = collections.Counter()
    for op, n in ops.items():
        kinds[_KIND_OF.get(op, "other")] += n
    return dict(kinds)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="*", default=[str(_build._CSRC / "ssim.cu")])
    parser.add_argument("--kernel", default="ssim_pair_kernel")
    args = parser.parse_args(argv)
    for source in args.sources:
        for name, insns in mix(sass(Path(source))).items():
            if args.kernel not in name:
                continue
            ops, loop = collections.Counter(o for _, o, _ in insns), hot_loop(insns)
            print(json.dumps({"source": source, "kernel": name, "total": sum(ops.values()),
                              "by_kind": by_kind(ops), "hot_loop_total": sum(loop.values()),
                              "hot_loop_by_kind": by_kind(loop),
                              "hot_loop_by_opcode": dict(loop.most_common())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
