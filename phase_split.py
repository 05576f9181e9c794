"""Per-phase time split of the fused conformer kernels (bf16), or with
--ctc of the CTC Viterbi and beta/posterior kernels (f32), on one card.

    python3 phase_split.py [--ctc] [TREE ...]

For each TREE (default: this one; e.g. the parent, unpacked with `git
archive <commit> cassnat_asr_public_tpu_torch chip_smoke.py` into a
git-ignored directory), copies its csrc/ into build/phase_split/<i>/ and
instruments the copy of conformer_layer.cu: thread 0 of every block writes
%globaltimer at kernel entry, when its block arrives at each grid barrier,
when the barrier releases it, and after a final __syncthreads at exit
(every __global__ kernel). The copy is built with the tree's own _build.py
into that directory, and half_a, half_b and the q-blocked pair (half_a_kv,
then half_a_qblock with tq=64 on the plain version's stage-1 outputs) run
at the LibriSpeech path shape (B=32, T'=184, D=512, H=8, F=1024, K=31,
R=20, bf16, the inputs of this tree's chip_smoke.conformer_path_inputs,
built with the tree's package). Per phase, over LAUNCHES launches: the mean
span between barrier releases, the blocks' mean and max time working, and
their mean wait at the barrier that ends it. A kernel with no grid barrier
(a tree whose half_a_qblock is an ordinary launch) is one phase, "whole
kernel", entry to exit. Prints the card's name and power limit and one
JSON line per tree and kernel. The kernels in the repo are not touched.

With --ctc only the CTC sources are copied and built: thread 0 of every
block writes %globaltimer at entry, at each `CTC_MARK(slot)` of the
kernel (after a block barrier: the Viterbi kernel after its setup, its
forward DP and its backtrace; the beta kernel after its token chains and
its DP) and after a final __syncthreads at exit, in `viterbi_kernel` and
`ctc_beta_grad_kernel`, and at the end of each gather block (slot 6); a
tree whose kernels have no marks (the parent of the rebuilt DPs) is timed
whole. They run LAUNCHES times on this tree's
`chip_smoke.train_ctc_batch(11)` (B=16, T'=200, S=199, V=4999). Per
phase: the blocks' mean and max time (the longest row sets the kernel's
time), and the kernel's span from the first entry to the last exit.
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
    "half_a_kv": ["LN (ffn1)", "W1A + swish", "W2A + residual",
                  "LN (attention) + x1, ln out", "K|V product"],
    "half_a_qblock": ["Q product + u/v", "attention", "WO + residual"],
}

MARKS = r"""
__device__ unsigned long long g_phase_marks[%(blocks)d * %(slots)d];
__device__ __forceinline__ void phase_mark(int slot) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    g_phase_marks[(blockIdx.x + blockIdx.y * gridDim.x) * %(slots)d + slot] =
        t;
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
        out.append(src[pos:k.end()])
        out.append("\n  phase_mark(0);" + kbody
                   + f"  __syncthreads();\n  phase_mark({SLOTS - 1});\n")
        pos = kend
        n_kernels += 1
    if n_kernels == 0:
        raise ValueError("no kernel found")
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
kv = cl.half_a_kv_plain(pk, x)
runs = {'half_a': lambda: cl.half_a(pk, x, maskf, pos),
        'half_b': lambda: cl.half_b(pk, x),
        'half_a_kv': lambda: cl.half_a_kv(pk, x),
        'half_a_qblock': lambda: cl.half_a_qblock(pk, *kv, maskf, pos, 64)}
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
    n_bar = sum(1 for v in runs[0][0][1:SLOTS - 1] if v) // 2
    names = PHASES[kind] if n_bar else ["whole kernel"]
    if len(names) != n_bar + 1:
        raise ValueError(f"{kind}: {n_bar} grid barriers, phases {names}")
    agg = None
    for marks in runs:
        rows = [[v for v in row] for row in marks]
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
    if proc.returncode != 0 or len(res) != len(PHASES):
        raise RuntimeError(f"phase split in {tree} failed:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return res


CTC_SLOTS = 8       # marks per block: entry, CTC_MARK 1..6, exit
CTC_KERNELS = {     # kind: (source, kernel, phase names between the marks)
    "viterbi": ("ctc_viterbi.cu", "viterbi_kernel",
                ["setup + first frames staged", "forward DP", "backtrace",
                 "offsets out + states + shift"]),
    "beta_grad": ("ctc_loss.cu", "ctc_beta_grad_kernel",
                  ["setup + token chains", "beta DP + posteriors", "exit"]),
}

CTC_MARKS = r"""
#include <cuda_runtime.h>
static __device__ unsigned long long g_ctc_marks[%(blocks)d * %(slots)d];
__device__ __forceinline__ void ctc_phase_mark(int slot) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    g_ctc_marks[blockIdx.x * %(slots)d + slot] = t;
  }
}
#define CTC_MARK(slot) ctc_phase_mark(slot)
"""

CTC_READER = r"""
extern "C" int cassnat_ctc_marks_%(kind)s(unsigned long long* out, int n,
                                          int reset) {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_ctc_marks);
  if (e != cudaSuccess) return (int)e;
  if (reset) return (int)cudaMemset(p, 0, sizeof(unsigned long long) * n);
  return (int)cudaMemcpy(out, p, sizeof(unsigned long long) * n,
                         cudaMemcpyDeviceToHost);
}
"""


def instrument_ctc(src, kind):
    """A CTC source with marks at entry, at its CTC_MARK points and at the
    exit of the kind's kernel; raises if the kernel is gone."""
    kernel = CTC_KERNELS[kind][1]
    m = re.search(r"__global__[^;{]*?\b" + kernel + r"\s*\([^)]*\)\s*\{",
                  src)
    if m is None:
        raise ValueError(f"{kernel} not found")
    end = _body_end(src, m.end() - 1)
    src = (src[:m.end()] + "\n  ctc_phase_mark(0);" + src[m.end():end]
           + f"  __syncthreads();\n  ctc_phase_mark({CTC_SLOTS - 1});\n"
           + src[end:])
    marks = CTC_MARKS % {"blocks": MAX_BLOCKS, "slots": CTC_SLOTS}
    return marks + src + CTC_READER % {"kind": kind}


# runs inside the tree under test, with the instrumented CTC sources only
RUN_CTC = INPUTS + r"""
import ctypes, json, sys, numpy as np, torch
sys.path.insert(0, '.')
from cassnat_asr_public_tpu_torch.kernels import _build
_build.CSRC, _build.BUILD_ROOT = sys.argv[1], sys.argv[2]
_build.SIGNATURES = {k: v for k, v in _build.SIGNATURES.items()
                     if k.startswith('cassnat_ctc')}
from cassnat_asr_public_tpu_torch.kernels import ctc_loss as kl
from cassnat_asr_public_tpu_torch.kernels import ctc_viterbi as kv
torch.set_grad_enabled(False)
iters, slots = int(sys.argv[3]), int(sys.argv[4])
dev = torch.device('cuda')
logits, labels, lens, ulen = (
    t if t.is_floating_point() else t.int()
    for t in inputs_module(sys.argv[5]).train_ctc_batch(11, dev))
lp = torch.log_softmax(logits, -1)
score, trellis = kl.ctc_alpha(lp, labels, lens, ulen)
lib = _build.lib()
runs = {'viterbi': lambda: kv.ctc_viterbi(lp, labels, lens, ulen),
        'beta_grad': lambda: kl.ctc_beta_grad(lp, labels, lens, ulen,
                                              trellis, score)}
for kind, run in runs.items():
    fn = getattr(lib, 'cassnat_ctc_marks_' + kind)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
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


def split_ctc(kind, runs):
    """Per-phase mean and max over the DP blocks (ms, means over the runs);
    for a kernel with gather blocks (their end marked at slot CTC_SLOTS-2,
    no exit mark), the span from the kernel's first entry to the last
    gather block's end."""
    names = CTC_KERNELS[kind][2]
    end, gather_end = CTC_SLOTS - 1, CTC_SLOTS - 2
    dp0 = [row for row in runs[0] if row[end]]
    slots = [i for i, v in enumerate(dp0[0]) if v]
    if len(slots) == 2:
        names = ["whole kernel"]
    elif len(slots) != len(names) + 1:
        raise ValueError(f"{kind}: marks at slots {slots}, phases {names}")
    mean = [0.0] * len(names)
    worst = [0.0] * len(names)
    total = gather = 0.0
    for rows in runs:
        dp = [row for row in rows if row[end]]
        for i in range(len(names)):
            d = [row[slots[i + 1]] - row[slots[i]] for row in dp]
            mean[i] += sum(d) / len(d)
            worst[i] += max(d)
        start = min(row[0] for row in rows)
        total += max(row[end] for row in dp) - start
        ends = [row[gather_end] for row in rows if not row[end]]
        gather += max(ends) - start if ends else 0
    n = len(runs)
    to_ms = lambda ns: round(ns / n * 1e-6, 5)
    return {"kind": kind, "dp_blocks": len(dp0),
            "gather_blocks": len(runs[0]) - len(dp0),
            "total_ms": to_ms(total), "gather_ms": to_ms(gather),
            "phases": [{"phase": name, "mean_ms": to_ms(a),
                        "max_ms": to_ms(b)}
                       for name, a, b in zip(names, mean, worst)]}


def run_tree_ctc(tree, i):
    work = os.path.join(HERE, "build", "phase_split_ctc", str(i))
    csrc = os.path.join(work, "csrc")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(csrc)
    src_dir = os.path.join(tree, "cassnat_asr_public_tpu_torch", "csrc")
    for f in os.listdir(src_dir):
        if f.startswith("ctc") and f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(src_dir, f), csrc)
    for kind, (fname, _, _) in CTC_KERNELS.items():
        path = os.path.join(csrc, fname)
        with open(path) as fh:
            src = instrument_ctc(fh.read(), kind)
        with open(path, "w") as fh:
            fh.write(src)
    proc = subprocess.run(
        [sys.executable, "-c", RUN_CTC, csrc, os.path.join(work, "lib"),
         str(LAUNCHES), str(CTC_SLOTS), os.path.join(HERE, "chip_smoke.py")],
        cwd=tree, capture_output=True, text=True, timeout=900)
    res = []
    for line in proc.stdout.splitlines():
        if line.startswith("SPLIT "):
            r = json.loads(line[len("SPLIT "):])
            res.append(split_ctc(r["kind"], r["marks"]))
    if proc.returncode != 0 or len(res) != len(CTC_KERNELS):
        raise RuntimeError(f"ctc phase split in {tree} failed:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctc", action="store_true",
                    help="split the CTC Viterbi and beta kernels")
    ap.add_argument("trees", nargs="*", default=[HERE])
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for i, tree in enumerate(a.trees):
        runner = run_tree_ctc if a.ctc else run_tree
        for r in runner(os.path.abspath(tree), i):
            print(json.dumps({"tree": tree, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
