#!/usr/bin/env python3
"""Registers, spills and the hot loop's instruction count of the port's kernels.

Run on a machine with the CUDA toolkit, from the repository root:

    python3 scripts/sass_loops.py [LIBRARY.so] [NAME[:KEY] ...]
    python3 scripts/sass_loops.py --same LIB_A.so LIB_B.so [NAME ...]

Without a library it builds (or finds) the port's kernel library
(``art_tpu_torch/ops/_build.py``).  NAME is a substring of a kernel's mangled
name, KEY the opcode that keys its paths (LDS by default); the default is
K2's kernels (its three forms), K9's (both forms), K10's, K7's (depth 7, 2
and any), K11's, K1's, K12's (both entries), K5's, K6's rotated forms (merge and plain),
K3's two modes (baked and plane-fed), K14's, K16's, K17's (also K15's
spheres; its instance for more than 64 cells, ``ILb1E``, too) and K15's
boxes (folded and rotated).

For each kernel it prints ``cuobjdump -res-usage``'s registers, stack and
local (spill) bytes, and reads ``cuobjdump -sass``: it cuts the function
into basic blocks, finds its natural loops (a branch to a block that
dominates it closes one), takes as the hot loop the innermost loop with the
most key instructions (shared-memory loads, LDS, unless the name's key says
otherwise), and counts the instructions (NOPs left out) on every acyclic
path from the loop's head to its back edge, keyed by the path's number of
key instructions.  A kernel with no loop has its paths counted from its
entry to an exit instead.  K2's loop is a group of eight rows for two rays
(16 pairs): its path with the fewest LDS (eight rows and the flags) is a
static group, the next key a moving group, and each key's shortest path
takes no root.  K9's loop is two cells (nvcc unrolls it by two), three LDS
a cell in the hoisted form and one in the per-cell form.  K10's loop is
its cell walk in a column, one LDG (the cell's height and material) a cell.  K7's kernels are
keyed by shuffles (SHFL): the depth-7 kernel unrolls its shared octaves, so
its loop is the per-lane octave (no shuffle); the any-depth kernel's loop is
the shared octave, 27 shuffles in one cell (3 for the cell's lattice point,
24 for the eight gradients) and more for each further cell.  K11's loop is
its primitive loop (LDS of the staged tables).  K1's and K12's loop is the
look-back's window read (keyed by its global loads, LDG); K12's flush-only
entry's (``flush_dead``) flush_warp's summing rounds, as K3's; K5's and K6's
their primitive loops.  K3's only loop is flush_warp's summing rounds
(keyed by SHFL: four shuffles a round).  K14's loop is a group of eight
feature rows for two rays (16 pairs, four LDS.128 a row): its shortest path
takes no root.  K16's loop is spread_hit's row loop: four staged rows
(two LDS.128 each) against one lane's ray held in registers.  K17's loops
are its group scans (sphere_group.cuh scan_group, one ray): a static group
of eight rows (eight LDS.128 and a byte of flags: nine LDS) and a moving
one (seventeen).  K15's boxes' loop is its row scan, unrolled by four:
two LDS.128 a staged row in the folded form (``box_cluster_kernelILb0E``),
three in the rotated one (``ILb1E``); its shortest path takes no row.  An
earlier K15 read its rows from global memory: key it by LDG
(``box_cluster_kernelILb1E:LDG``).  ``inner`` lists
every innermost loop with its paths.  ``code_bytes`` is a function's SASS
size (16 bytes an instruction).  K13 lives in per-scene libraries
(``STATIC``; ``python3 scripts/sass_loops.py --static SCENE [expanded]``
builds one): its loops are its group scans of two rays, a moving section's
and a static one's; a K13 built as straight-line code has no loop, and its
``code_bytes`` and instruction count over its spheres are the measure.
``--same`` says whether each NAME's SASS is the same in two libraries (by
default K1's, K11's and K9's two forms: the kernels that share a source with
K12 or K10).
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

# (kernel name substring, the opcode that keys its paths)
DEFAULT = (("sphere_hit_kernelILi2ELi2E", "LDS"), ("sphere_hit_kernelILi1ELi2E", "LDS"),
           ("sphere_hit_kernelILi1ELi1E", "LDS"), ("box_grid_cells_kernelILb1E", "LDS"),
           ("box_grid_cells_kernelILb0E", "LDS"), ("box_grid_kernel", "LDG"),
           ("turb_kernelILi7E", "SHFL"), ("turb_kernelILi2E", "SHFL"),
           ("turb_kernelILi0E", "SHFL"), ("sp_step_kernel", "LDS"), ("refill_kernel", "LDG"),
           ("refill_flush_kernel", "LDG"), ("flush_dead", "SHFL"), ("quad_hit_kernel", "LDS"),
           ("box_hit_kernelILb1ELb1E", "LDS"), ("box_hit_kernelILb1ELb0E", "LDS"),
           ("shade_flush_kernelILb1E", "SHFL"), ("shade_flush_kernelILb0E", "SHFL"),
           ("sphere_mxu_kernel", "LDS"), ("sphere_skip_kernel", "LDS"),
           ("sphere_cellbin_kernelILb0E", "LDS"), ("sphere_cellbin_kernelILb1E", "LDS"),
           ("box_cluster_kernelILb0E", "LDS"),
           ("box_cluster_kernelILb1E", "LDS"))
# the kernels that share csrc/refill.cuh with K12 but not its flush (K1, K11)
# and K9's, which shares csrc/box_grid.cu with K10: --same compares them
SAME = ("refill_kernel", "sp_step_kernel", "box_grid_cells_kernelILb1E",
        "box_grid_cells_kernelILb0E")
# K13's kernel, in a per-scene library (ops/_build.py static_libraries)
STATIC = (("sphere_static_kernel", "LDS"),)
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(found).exists():
        raise RuntimeError("cuobjdump not found: needs the CUDA toolkit")
    return found


def resource_usage(lib: str) -> dict:
    """{mangled name: {REG, STACK, SHARED, LOCAL}} from cuobjdump -res-usage."""
    out = subprocess.run([_cuobjdump(), "-res-usage", lib], capture_output=True, text=True,
                         check=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)",
                                                              line)}
            name = None
    return usage


def sass_functions(lib: str) -> dict:
    """{mangled name: [(address, instruction text)]} from cuobjdump -sass."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _parse(text: str):
    """(predicated, opcode, arguments) of one instruction."""
    parts = text.split(None, 1)
    pred = parts[0].startswith("@")
    if pred:
        parts = parts[1].split(None, 1)
    return pred, parts[0], parts[1] if len(parts) > 1 else ""


def _blocks(insns):
    """Basic blocks: {start address: (instructions, successor starts)}."""
    addrs = [a for a, _ in insns]
    nxt = {a: b for a, b in zip(addrs, addrs[1:])}
    leaders = {addrs[0]}
    for a, text in insns:
        pred, op, args = _parse(text)
        base = op.split(".")[0]
        if base in ("BRA", "EXIT", "RET", "BRX", "JMP", "JMX"):
            if a in nxt:
                leaders.add(nxt[a])
            if base == "BRA":
                leaders.add(int(re.findall(r"0x([0-9a-f]+)", args)[-1], 16))
    blocks, cur = {}, None
    for a, text in insns:
        if a in leaders:
            cur = a
            blocks[cur] = [[], []]
        blocks[cur][0].append((a, text))
    for start, (body, succ) in blocks.items():
        a, text = body[-1]
        pred, op, args = _parse(text)
        base = op.split(".")[0]
        # a branch whose condition is a (uniform) predicate argument
        cond = pred or bool(re.match(r"!?U?P\d", args)) or op.startswith("BRA.DIV")
        if base == "BRA":
            succ.append(int(re.findall(r"0x([0-9a-f]+)", args)[-1], 16))
            if cond and a in nxt:
                succ.append(nxt[a])
        elif base in ("EXIT", "RET", "BRX", "JMP", "JMX"):
            if pred and a in nxt:
                succ.append(nxt[a])
        elif a in nxt:
            succ.append(nxt[a])
    return blocks


def _dominators(blocks):
    """{block: set of the blocks that dominate it} from the first block."""
    order = sorted(blocks)
    preds = {b: [] for b in blocks}
    for b, (_, succ) in blocks.items():
        for s in succ:
            if s in preds:
                preds[s].append(b)
    dom = {b: set(order) for b in order}
    dom[order[0]] = {order[0]}
    changed = True
    while changed:
        changed = False
        for b in order[1:]:
            ps = [dom[p] for p in preds[b]]
            new = ({b} | set.intersection(*ps)) if ps else {b}
            if new != dom[b]:
                dom[b], changed = new, True
    return dom, preds


def _loops(blocks):
    """Natural loops: [(head, set of block starts, back-edge sources)], a
    back edge being a branch to a block that dominates its source (an
    out-of-line slow path that jumps back into the loop closes none)."""
    dom, preds = _dominators(blocks)
    loops = {}
    for b, (body, succ) in blocks.items():
        for h in succ:
            if h in blocks and h in dom[b]:
                nodes, work = {h, b}, [b] if b != h else []
                while work:
                    for p in preds[work.pop()]:
                        if p not in nodes:
                            nodes.add(p)
                            work.append(p)
                head, ends = loops.setdefault(h, (set(), set()))
                head |= nodes
                ends.add(b)
    return [(h, nodes, ends) for h, (nodes, ends) in loops.items()]


def _count(body, key="LDS"):
    insns = [t for _, t in body if _parse(t)[1] != "NOP"]
    return len(insns), sum(_parse(t)[1].startswith(key) for t in insns)


def _paths(blocks, start, stop, inside, key):
    """{key instructions on the path: (fewest, most) instructions} over
    every acyclic path from ``start`` to a block in ``stop`` through the
    blocks ``inside`` (never back to ``start``)."""
    memo: dict = {}

    def walk(b):
        if b in memo:
            return memo[b]
        n, k = _count(blocks[b][0], key)
        out: dict = {}
        if b in stop:
            out[k] = (n, n)
        for s in blocks[b][1]:
            if s in inside and s != start:
                for kk, (lo, hi) in walk(s).items():
                    old = out.get(kk + k, (lo + n, hi + n))
                    out[kk + k] = (min(old[0], lo + n), max(old[1], hi + n))
        memo[b] = out
        return out

    return {str(k): {"fewest": lo, "most": hi} for k, (lo, hi) in sorted(walk(start).items())}


def _opcodes(bodies) -> dict:
    ops: dict = {}
    for body in bodies:
        for _, t in body:
            op = _parse(t)[1]
            ops[op] = ops.get(op, 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def hot_loop(insns, key="LDS") -> dict:
    """The innermost loop with the most key instructions and its paths
    (module note); for a function with no loop, its paths from the entry to
    an exit."""
    blocks = _blocks(insns)
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 4 * len(blocks) + 1000))  # _paths' walk
    # the branch-to-self that ends a function's code is no loop
    loops = [lp for lp in _loops(blocks)
             if any(_parse(t)[1] not in ("BRA", "NOP") for b in lp[1] for _, t in blocks[b][0])]
    inner = [lp for lp in loops if not any(h != lp[0] and h in lp[1] for h, _, _ in loops)]
    if not inner:
        exits = {b for b, (_, succ) in blocks.items() if not succ}
        return dict(head=None, blocks=len(blocks), instructions=sum(
            _count(body)[0] for body, _ in blocks.values()),
            paths=_paths(blocks, min(blocks), exits, set(blocks), key),
            opcodes=_opcodes(body for body, _ in blocks.values()))
    def summary(head, nodes, ends):
        return dict(head=hex(head), blocks=len(nodes), instructions=sum(
            _count(blocks[b][0])[0] for b in nodes),
            paths=_paths(blocks, head, ends, nodes, key),
            opcodes=_opcodes(blocks[b][0] for b in sorted(nodes)))

    hot = max(inner, key=lambda lp: (sum(_count(blocks[b][0], key)[1] for b in lp[1]),
                                     sum(_count(blocks[b][0])[0] for b in lp[1])))
    out = summary(*hot)
    # every innermost loop with a key instruction, by address: a kernel of
    # several scans (K13's sections, K17's moving and static groups)
    out["inner"] = [{k: v for k, v in summary(*lp).items() if k != "opcodes"}
                    for lp in sorted(inner) if sum(_count(blocks[b][0], key)[1] for b in lp[1])]
    return out


def report(lib: str, names=DEFAULT) -> dict:
    """{name: {mangled, REG, STACK, SHARED, LOCAL, loop}} for each NAME, or
    (NAME, key opcode)."""
    usage, funcs = resource_usage(lib), sass_functions(lib)
    out = {}
    for name, key in (n if isinstance(n, tuple) else (n.split(":") + ["LDS"])[:2]
                      for n in names):
        hits = [f for f in funcs if name in f]
        if not hits:
            out[name] = {"error": "no such kernel in the library"}
            continue
        f = hits[0]
        out[name] = dict(mangled=f, key=key, **usage.get(f, {}),
                         code_bytes=16 * len(funcs[f]), loop=hot_loop(funcs[f], key))
    return out


def same_sass(lib_a: str, lib_b: str, names) -> dict:
    """{name: {equal, instructions a, instructions b}}: whether each NAME's
    SASS (the instructions at their function-relative addresses) is the same
    in two libraries, e.g. a parent checkout's and this one's."""
    fa, fb = sass_functions(lib_a), sass_functions(lib_b)
    out = {}
    for name in names:
        a = [fa[f] for f in fa if name in f][:1]
        b = [fb[f] for f in fb if name in f][:1]
        if not a or not b:
            out[name] = {"error": "no such kernel in a library"}
            continue
        out[name] = dict(equal=a[0] == b[0], instructions=[len(a[0]), len(b[0])])
    return out


def static_library(scene: str, expand: bool):
    """K13's library for ``scene`` (16x16) in one form, built if need be."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from art_tpu_torch.models import build_scene
    from art_tpu_torch.ops import _build

    t = build_scene(scene, 16, 16).tables
    return _build.static_libraries([(t.sph_static_cells, t.sph_tail_r, t.sph_tail_mat,
                                     expand)])[0]


def main(argv) -> int:
    if argv and argv[0] == "--same":
        print(json.dumps(same_sass(argv[1], argv[2], tuple(argv[3:]) or SAME), indent=1))
        return 0
    if argv and argv[0] == "--static":
        lib = static_library(argv[1], len(argv) > 2 and argv[2] == "expanded")
        print(json.dumps(report(lib._name, STATIC), indent=1))
        return 0
    if argv and argv[0].endswith(".so"):
        lib, names = argv[0], tuple(argv[1:]) or DEFAULT
    else:
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        from art_tpu_torch.ops import _build

        lib, names = _build.library()._name, tuple(argv) or DEFAULT
    print(json.dumps(report(lib, names), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
