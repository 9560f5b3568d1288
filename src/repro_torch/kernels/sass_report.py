"""What the compiler made of a kernel source: registers, spills and the
instructions each exact product costs in its product loop.

    python -m repro_torch.kernels.sass_report [SOURCE.cu ...]

(default: the three tiled kernels, ``csrc/fdp_gemm.cu``,
``csrc/fdp_ragged_gemm.cu`` and ``csrc/fdp_ragged_dw.cu``) compiles each
source to a cubin for ``sm_90a`` with the kernels' flags and ``-Xptxas
-v``, all sources at once, then reads ``cuobjdump -sass``. For every
kernel instantiation it prints one JSON line: the registers and spill
bytes that ptxas reports, and for its
product loop (the loop, a backward branch, whose own body forms the most
significand products, each an ``IMAD.WIDE.U32`` with no addend; not a
tile-load loop) the instructions in that body, the products it forms,
their ratio, and the body's opcode counts. The count is
static: a branch inside the loop (a posit decode, say) counts whether or
not it runs. Only kernels are listed; a device function that is not
inlined (the sorted-segment kernel's one-row loop) is read inside the
kernel that calls it. Needs the CUDA toolkit
(``nvcc`` and ``cuobjdump``), so it runs where the kernels build.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from repro_torch.kernels import fdp_gemm as K

_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


def _compile(source: Path, out_dir: str) -> tuple:
    cubin = os.path.join(out_dir, source.stem + ".cubin")
    flags = [f for f in K._NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([K._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", cubin,
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return cubin, proc.stderr


def ptxas_usage(log: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}."""
    usage, name = {}, None
    for line in log.splitlines():
        if m := _PTXAS_FN.search(line):
            name = m.group(1)
            usage[name] = {}
        elif name and (m := _PTXAS_SPILL.search(line)):
            usage[name]["spill_stores"], usage[name]["spill_loads"] = map(int, m.groups())
        elif name and (m := _PTXAS_REGS.search(line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


def sass_functions(sass: str) -> dict:
    """{mangled name: [(address, opcode, branch target or None, operands)]},
    labels resolved to addresses."""
    funcs, name, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
            labels[name] = {}
            continue
        if name is None:
            continue
        if m := _LABEL.match(line):
            pending.append(m.group(1))
            continue
        if m := _INSN.search(line):
            addr = int(m.group(1), 16)
            for label in pending:
                labels[name][label] = addr
            pending = []
            funcs[name].append((addr, m.group(3), m.group(4)))
    return {n: [(a, op, _resolve(rest, labels[n]), rest) for a, op, rest in body]
            for n, body in funcs.items()}


def _resolve(operands: str, labels: dict):
    m = _TARGET.search(operands)
    if not m:
        return None
    return labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)


def product_loop(body: list) -> dict | None:
    """The loop whose own body (its nested loops left out) forms the most
    significand products (IMAD.WIDE.U32 with RZ as the addend; address
    arithmetic adds a base) and stores fewer values to shared memory than
    it forms products (so not a tile-load loop): its own instruction count,
    products and opcode counts. A one-row block's chunk loop counts its
    products of the B elements it keeps in flight and their reloads; the
    loops nested in it (its A row's loads, and the k of a chunk past those
    in flight) are left out."""
    loops = [(target, addr) for addr, op, target, _ in body
             if op.startswith("BRA") and target is not None and target <= addr]
    best = None
    for lo, hi in loops:
        nested = [(l2, h2) for l2, h2 in loops if (l2, h2) != (lo, hi) and lo <= l2 and h2 <= hi]
        own = [(op, rest) for addr, op, _, rest in body
               if lo <= addr <= hi and not any(l2 <= addr <= h2 for l2, h2 in nested)]
        products = sum(op.startswith("IMAD.WIDE.U32") and rest.strip().endswith("RZ")
                       for op, rest in own)
        if products == 0 or sum(op.startswith("STS") for op, _ in own) >= products:
            continue
        if best is None or products > best["products"]:
            ops = [op for op, _ in own]
            best = {"instructions": len(ops), "products": products,
                    "per_product": len(ops) / products,
                    "opcodes": dict(collections.Counter(o.split(".")[0] for o in ops)
                                    .most_common())}
    return best


def template_args(name: str) -> list:
    """The integer and bool template arguments of a mangled kernel name
    (``...kernelILi6ELb0ELb1EE...`` -> [6, 0, 1])."""
    if "kernelI" not in name:
        return []
    return [int(x) for x in re.findall(r"L[ib](\d+)E", name.split("kernelI", 1)[1])]


def report(source: Path) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        cubin, log = _compile(source, tmp)
        cuobjdump = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                              check=True).stdout
    usage = ptxas_usage(log)
    rows = []
    for name, body in sass_functions(sass).items():
        if not template_args(name):
            continue
        rows.append({"source": source.name, "kernel": name,
                     "template": template_args(name), **usage.get(name, {}),
                     "product_loop": product_loop(body)})
    return rows


def main(argv: list) -> None:
    sources = [Path(p) for p in argv] or [K._CSRC / name for name in (
        "fdp_gemm.cu", "fdp_ragged_gemm.cu", "fdp_ragged_dw.cu")]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for rows in pool.map(report, sources):
            for row in rows:
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
