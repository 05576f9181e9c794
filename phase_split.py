"""Per-phase time split of the fused conformer halves (bf16) on one card.

    python3 phase_split.py [TREE ...]

For each TREE (default: this one; e.g. the parent, unpacked with `git
archive <commit> cassnat_asr_public_tpu_torch chip_smoke.py` into a
git-ignored directory), copies its csrc/ into build/phase_split/<i>/ and
instruments the copy of conformer_layer.cu: thread 0 of every block writes
%globaltimer at kernel entry, when its block arrives at each grid barrier,
when the barrier releases it, and after a final __syncthreads at exit
(every __global__ kernel that calls grid_sync). The copy is built with the
tree's own _build.py into that directory, and half_a and half_b run at the
LibriSpeech path shape (B=32, T'=184, D=512, H=8, F=1024, K=31, R=20, bf16,
the inputs of this tree's chip_smoke.conformer_path_inputs, built with the
tree's package). Per phase, over LAUNCHES launches: the mean span between barrier releases, the
blocks' mean and max time working, and their mean wait at the barrier
that ends it. Prints the card's name and power limit and one JSON line per
tree and half. The kernels in the repo are not touched.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

from ab_phase2 import INPUTS

HERE = os.path.dirname(os.path.abspath(__file__))
SLOTS = 40          # marks per block: entry, (arrive, release) x 19, exit
LAUNCHES = 10       # timed launches a half, after 3 warm-up launches
MAX_BLOCKS = 1024

PHASES = {
    "half_a": ["LN (ffn1)", "W1A + swish", "W2A + residual",
               "LN (attention)", "WQKV + u/v split", "attention",
               "WO + residual"],
    "half_b": ["LN (conv)", "PW1", "GLU + depthwise + mean partials",
               "GroupNorm variance partials", "GroupNorm apply + swish",
               "PW2 + residual", "LN (ffn2)", "W1B + swish",
               "W2B + residual"],
}

MARKS = r"""
__device__ unsigned long long g_phase_marks[%(blocks)d * %(slots)d];
__device__ __forceinline__ void phase_mark(int slot) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    g_phase_marks[blockIdx.x * %(slots)d + slot] = t;
  }
}
""" % {"blocks": MAX_BLOCKS, "slots": SLOTS}

READER = r"""
extern "C" int cassnat_phase_marks(unsigned long long* out, int n,
                                   int reset) {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_phase_marks);
  if (e != cudaSuccess) return (int)e;
  if (reset) return (int)cudaMemset(p, 0, sizeof(unsigned long long) * n);
  return (int)cudaMemcpy(out, p, sizeof(unsigned long long) * n,
                         cudaMemcpyDeviceToHost);
}
"""


def _body_end(src, open_brace):
    """Index of the brace closing the one at `open_brace`."""
    depth = 0
    for i in range(open_brace, len(src)):
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
            if depth == 0:
                return i
    raise ValueError("unbalanced braces")


def instrument(src):
    """conformer_layer.cu with phase marks; raises if an anchor is gone."""
    m = re.search(r"^[^\n]*void grid_sync\([^)]*\)\s*\{", src, re.M)
    if m is None:
        raise ValueError("grid_sync not found")
    end = _body_end(src, m.end() - 1)
    body = src[m.end():end]
    anchor = "target += gridDim.x;"
    if anchor not in body:
        raise ValueError(f"'{anchor}' not found in grid_sync")
    body = body.replace(
        anchor, anchor + "\n  phase_mark(2 * (target / gridDim.x) - 1);", 1)
    body += "  phase_mark(2 * (target / gridDim.x));\n"
    src = src[:m.start()] + MARKS + src[m.start():m.end()] + body + src[end:]
    out, pos, n_kernels = [], 0, 0
    for k in re.finditer(r"__global__[^;{]*?\([^)]*\)\s*\{", src):
        if k.start() < pos:
            continue
        kend = _body_end(src, k.end() - 1)
        kbody = src[k.end():kend]
        if "grid_sync(" not in kbody:
            continue
        out.append(src[pos:k.end()])
        out.append("\n  phase_mark(0);" + kbody
                   + f"  __syncthreads();\n  phase_mark({SLOTS - 1});\n")
        pos = kend
        n_kernels += 1
    if n_kernels == 0:
        raise ValueError("no kernel calls grid_sync")
    out.append(src[pos:])
    return "".join(out) + READER


# runs inside the tree under test, with the instrumented csrc
RUN = INPUTS + r"""
import ctypes, json, sys, numpy as np, torch
sys.path.insert(0, '.')
from cassnat_asr_public_tpu_torch.kernels import _build
_build.CSRC, _build.BUILD_ROOT = sys.argv[1], sys.argv[2]
from cassnat_asr_public_tpu_torch.kernels import conformer_layer as cl
torch.set_grad_enabled(False)
iters, slots = int(sys.argv[3]), int(sys.argv[4])
inp = inputs_module(sys.argv[5]).conformer_path_inputs(
    torch.device('cuda'), torch.bfloat16)
pk, x, maskf, pos = inp['pk'], inp['x'], inp['maskf'], inp['pos']
lib = _build.lib()
fn = lib.cassnat_phase_marks
fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
runs = {'half_a': lambda: cl.half_a(pk, x, maskf, pos),
        'half_b': lambda: cl.half_b(pk, x)}
for kind, run in runs.items():
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        buf = np.zeros(1024 * slots, dtype=np.uint64)
        _build.check(fn(None, buf.size, 1), 'reset')
        run()
        torch.cuda.synchronize()
        _build.check(fn(buf.ctypes.data, buf.size, 0), 'read')
        marks = buf.reshape(1024, slots)
        out.append(marks[marks[:, 0] != 0].astype(np.int64).tolist())
    print('SPLIT ' + json.dumps({'kind': kind, 'marks': out}), flush=True)
"""


def split(kind, runs):
    """Per-phase means (ms) over the runs from the blocks' marks."""
    names = PHASES[kind]
    agg = None
    for marks in runs:
        rows = [[v for v in row] for row in marks]
        n_bar = len(names) - 1
        phases = []
        for i in range(n_bar + 1):
            start = [row[2 * i] if i else row[0] for row in rows]
            if i < n_bar:
                arrive = [row[2 * i + 1] for row in rows]
                release = [row[2 * i + 2] for row in rows]
            else:
                arrive = release = [row[SLOTS - 1] for row in rows]
            work = [a - s for a, s in zip(arrive, start)]
            wait = [r - a for r, a in zip(release, arrive)]
            span = [r - s for r, s in zip(release, start)]
            phases.append([sum(span) / len(span), sum(work) / len(work),
                           max(work), sum(wait) / len(wait)])
        total = max(row[SLOTS - 1] for row in rows) - min(row[0]
                                                          for row in rows)
        cur = [phases, total, len(rows)]
        if agg is None:
            agg = cur
        else:
            agg[0] = [[x + y for x, y in zip(p, q)]
                      for p, q in zip(agg[0], phases)]
            agg[1] += total
    n = len(runs)
    to_ms = lambda ns: round(ns / n * 1e-6, 5)
    return {"kind": kind, "blocks": agg[2], "total_ms": to_ms(agg[1]),
            "barrier_wait_ms": to_ms(sum(p[3] for p in agg[0])),
            "phases": [{"phase": name, "span_ms": to_ms(p[0]),
                        "work_mean_ms": to_ms(p[1]),
                        "work_max_ms": to_ms(p[2]),
                        "wait_mean_ms": to_ms(p[3])}
                       for name, p in zip(names, agg[0])]}


def run_tree(tree, i):
    work = os.path.join(HERE, "build", "phase_split", str(i))
    csrc = os.path.join(work, "csrc")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "cassnat_asr_public_tpu_torch",
                                 "csrc"), csrc)
    path = os.path.join(csrc, "conformer_layer.cu")
    with open(path) as fh:
        src = instrument(fh.read())
    with open(path, "w") as fh:
        fh.write(src)
    proc = subprocess.run(
        [sys.executable, "-c", RUN, csrc, os.path.join(work, "lib"),
         str(LAUNCHES), str(SLOTS), os.path.join(HERE, "chip_smoke.py")],
        cwd=tree, capture_output=True, text=True, timeout=900)
    res = []
    for line in proc.stdout.splitlines():
        if line.startswith("SPLIT "):
            r = json.loads(line[len("SPLIT "):])
            res.append(split(r["kind"], r["marks"]))
    if proc.returncode != 0 or len(res) != 2:
        raise RuntimeError(f"phase split in {tree} failed:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", default=[HERE])
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for i, tree in enumerate(a.trees):
        for r in run_tree(os.path.abspath(tree), i):
            print(json.dumps({"tree": tree, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
