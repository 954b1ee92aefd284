#!/usr/bin/env python3
"""The instruction mix of K5's loops in the built object, from the SASS.

    python3 scripts/sass_k5_torch.py [--root DIR] [--kernel PATTERN]

Runs ``cuobjdump -sass`` (from the CUDA toolkit) on the cached object of
``rs_bann_tpu_torch/csrc/traj_packed.cu`` under DIR (default: this
checkout; build it first, for example with ``scripts/bench_k5_torch.py``),
finds every loop of each ``traj_packed_kernel`` instantiation whose
mangled name matches PATTERN (a regular expression; default: every one)
as a backward branch and the instructions between its target and the
branch, and prints for each loop with at least 16 FFMAs its instruction
count, FFMAs, shared-memory loads (LDS), integer-to-float conversions (I2F),
local-memory (spill) loads and stores (LDL, STL) and the other instructions,
so that instructions per marker of the forward
loop can be read off (the forward does PH parts x N columns of FFMAs per
marker). The last line is a JSON object of the same numbers.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


def cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).exists():
        raise SystemExit("sass_k5_torch: cuobjdump not found")
    return found


def functions(sass: str):
    """{mangled name: [(address, opcode, text)]} of every function."""
    out, name, label_at = {}, None, {}
    pending = []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            pending = []
            continue
        if name is None:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if ins:
            addr = int(ins.group(1), 16)
            text = ins.group(2).strip()
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            for lb in pending:
                label_at[(name, lb)] = addr
            pending = []
            out[name].append((addr, op, text))
    return out, label_at


def loops(name, ins, label_at):
    """(start, end) address ranges of the backward branches of a function."""
    found = []
    for addr, op, text in ins:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"`\((\.L_x_\d+)\)", text)
        if m:
            target = label_at.get((name, m.group(1)))
        else:
            h = re.search(r"0x([0-9a-f]+)", text)
            target = int(h.group(1), 16) if h else None
        if target is not None and target <= addr:
            found.append((target, addr))
    return found


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--kernel", default="traj_packed_kernel")
    opts = ap.parse_args()
    objs = sorted((Path(opts.root) / "build" / "rs_bann_tpu_torch" / "obj").glob("traj_packed_*.o"),
                  key=lambda p: p.stat().st_mtime)
    if not objs:
        raise SystemExit(f"sass_k5_torch: no traj_packed object under {opts.root}/build")
    obj = objs[-1]
    sass = subprocess.run([cuobjdump(), "-sass", str(obj)], capture_output=True, text=True,
                          check=True).stdout
    funcs, label_at = functions(sass)
    res = {"object": obj.name, "kernels": {}}
    print(f"{obj}: {len(funcs)} functions")
    for name, ins in funcs.items():
        if "traj_packed_kernel" not in name or not re.search(opts.kernel, name):
            continue
        t = re.search(r"traj_packed_kernelILi(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?E", name)
        tag = f"KM={t.group(1)} CC={t.group(2) or 1} depth={t.group(3) or 0}" if t else name
        rows = []
        for start, end in loops(name, ins, label_at):
            body = [op for addr, op, _ in ins if start <= addr <= end]
            ffma = sum(op.startswith("FFMA") for op in body)
            if ffma < 16:
                continue
            lds = sum(op.startswith("LDS") for op in body)
            i2f = sum(op.startswith("I2F") for op in body)
            local = sum(op.startswith(("LDL", "STL")) for op in body)
            rows.append({"start": hex(start), "instructions": len(body), "ffma": ffma, "lds": lds,
                         "i2f": i2f, "local": local, "other": len(body) - ffma - lds - i2f - local})
        print(f"{tag} ({len(ins)} instructions)")
        for r in rows:
            print(f"  loop at {r['start']}: {r['instructions']} instructions, {r['ffma']} FFMA "
                  f"({100 * r['ffma'] / r['instructions']:.1f}%), {r['lds']} LDS, {r['i2f']} I2F, "
                  f"{r['local']} LDL/STL, {r['other']} other")
        res["kernels"][tag] = rows
    print(json.dumps(res))


if __name__ == "__main__":
    sys.exit(main())
