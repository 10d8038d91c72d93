#!/usr/bin/env python3
"""Compile the PyTorch/CUDA port's kernels of one or two source trees and
compare their machine code kernel by kernel.

    python3 scripts/sass_torch_kernels.py DIR_A [DIR_B]
    python3 scripts/sass_torch_kernels.py --opcodes DIR NAME

Each DIR is the root of a checkout (or any directory that holds a
``qkd_ldpc_v_tpu_torch/csrc``). Every ``csrc/*.cu`` there is compiled by
``nvcc`` into a cubin, one compiler process per source, all started
together, with the flags of ``qkd_ldpc_v_tpu_torch/kernels.py`` and
``-Xptxas -v``; ``cuobjdump -sass`` then lists each kernel's instructions.
One line per kernel: its source, name and template flags, its instruction
count, global loads and shared stores, and its registers and spill stores.
With two DIRs, each kernel of B is matched to A's kernel of the same name
and flags, or, where B has one more template flag and it is false, to A's
kernel without it (a mode compiled apart); the line shows both, whether the
instruction streams are identical (branch targets and labels aside), and
the opcodes whose counts differ most. With ``--opcodes``, each kernel of
DIR whose name contains NAME is listed with its opcode counts and its
instructions, from which operations per call are counted by hand (e.g.
``spa_steps`` for the SPA pair's tanhf, atanhf and division).

It needs the CUDA toolkit (nvcc, cuobjdump) and no card.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from qkd_ldpc_v_tpu_torch.kernels import NVCC_FLAGS, _nvcc  # noqa: E402

# Branch targets, which move with any change before them.
_TARGET = re.compile(
    r"\b(BRA|BSSY|BREAK|CALL\S*|JMP\S*|WARPSYNC)\b(.*?)0x[0-9a-f]+")


def _label(mangled: str) -> tuple:
    """(source, kernel name, template flags) of a mangled kernel name."""
    source = re.search(r"__N__[0-9a-f]+_\d+_(\w+?)_cu_", mangled)
    name = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?)I", mangled)
    flags = re.findall(r"L[bi](\d+)E", mangled)
    return (source.group(1) if source else "?",
            name.group(1) if name else mangled, tuple(flags))


def _opcode(ins: str) -> str:
    words = ins.split()
    return words[1] if words[0].startswith("@") else words[0]


def compile_tree(tree: Path, out: Path) -> dict:
    """{label: {"sass": [instructions], "regs": int, "spill": int}} of every
    kernel in ``tree``'s sources."""
    csrc = tree / "qkd_ldpc_v_tpu_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    if not sources:
        raise SystemExit(f"{csrc}: no .cu sources")
    flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]

    def build(src: Path) -> tuple:
        cubin = out / f"{src.stem}.cubin"
        proc = subprocess.run(
            [_nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", str(cubin),
             str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr}")
        sass = subprocess.run(
            [str(Path(_nvcc()).with_name("cuobjdump")), "-sass", str(cubin)],
            capture_output=True, text=True, check=True).stdout
        return proc.stdout + proc.stderr, sass

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(build, sources))
    kernels = {}
    for log, sass in built:
        usage = {}
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" not in line:
                continue
            mangled = line.split("'")[1]
            near = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", near)
            spill = re.search(r"(\d+) bytes spill stores", near)
            usage[mangled] = (int(regs.group(1)) if regs else -1,
                              int(spill.group(1)) if spill else 0)
        name = None
        for line in sass.splitlines():
            m = re.match(r"\s+Function : (\S+)", line)
            if m:
                name = m.group(1)
                regs, spill = usage.get(name, (-1, -1))
                kernels[_label(name)] = {"sass": [], "regs": regs,
                                         "spill": spill}
                continue
            m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m and name:
                ins = re.sub(r"\.L_x_\d+", ".L", m.group(1))
                kernels[_label(name)]["sass"].append(
                    _TARGET.sub(r"\1\2ADDR", ins))
    return kernels


def _summary(k: dict) -> str:
    ops = collections.Counter(_opcode(i) for i in k["sass"])
    loads = sum(n for op, n in ops.items() if op.startswith("LDG"))
    stores = sum(n for op, n in ops.items() if op.startswith("STS"))
    return (f"{len(k['sass'])} instr (LDG {loads}, STS {stores}), "
            f"{k['regs']} regs, {k['spill']} B spill")


def _name(label: tuple) -> str:
    return f"{label[0]}:{label[1]}<{','.join(label[2])}>"


def opcodes(tree: Path, name: str) -> int:
    """List each kernel of ``tree`` whose name contains ``name``: its
    summary, its opcode counts and its instructions."""
    with tempfile.TemporaryDirectory() as tmp:
        kernels = compile_tree(tree, Path(tmp))
    found = 0
    for label, k in sorted(kernels.items()):
        if name not in label[1]:
            continue
        found += 1
        ops = collections.Counter(_opcode(i) for i in k["sass"])
        print(f"{_name(label)}: {_summary(k)}")
        print("  " + " ".join(f"{op} {n}" for op, n in ops.most_common()))
        for ins in k["sass"]:
            print(f"    {ins}")
    return 0 if found else 1


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--opcodes":
        return opcodes(Path(sys.argv[2]), sys.argv[3])
    dirs = [Path(d) for d in sys.argv[1:]]
    if not 1 <= len(dirs) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = []
    for d in dirs:
        with tempfile.TemporaryDirectory() as tmp:
            trees.append(compile_tree(d, Path(tmp)))
    if len(trees) == 1:
        for label, k in sorted(trees[0].items()):
            print(f"{_name(label)}: {_summary(k)}")
        return 0
    a, b = trees
    for label, kb in sorted(b.items()):
        match = label if label in a else (
            (label[0], label[1], label[2][:-1])
            if label[2] and label[2][-1] == "0" else None)
        ka = a.get(match)
        if ka is None:
            print(f"{_name(label)}: B only: {_summary(kb)}")
            continue
        same = ka["sass"] == kb["sass"]
        line = (f"{_name(label)}: A {_summary(ka)} | B {_summary(kb)} | "
                f"identical {'yes' if same else 'no'}")
        if not same:
            ha = collections.Counter(_opcode(i) for i in ka["sass"])
            hb = collections.Counter(_opcode(i) for i in kb["sass"])
            moved = sorted(set(ha) | set(hb),
                           key=lambda op: -abs(ha[op] - hb[op]))[:6]
            line += " | " + " ".join(f"{op} {ha[op]}->{hb[op]}"
                                     for op in moved if ha[op] != hb[op])
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
