"""A/B of chip_smoke.py's phase 2 (kernels against their plain versions at
the LibriSpeech path shapes) between another tree and this one, on one card.

    python3 ab_phase2.py [--ctc] OTHER_TREE

OTHER_TREE is a checkout (e.g. `git archive <commit>
cassnat_asr_public_tpu_torch chip_smoke.py` unpacked into a directory)
whose chip_smoke.py has `phase_kernels` and `queued_ms`. The runs go
other, this, this, other, each a fresh process in that tree's directory:
it builds that tree's kernels, runs its phase 2, and then times the bf16
frontend and the bf16 conformer kernels (half_a, half_b, and the
q-blocked pair half_a_kv and half_a_qblock, tq=64, the latter on the plain
version's stage-1 outputs) at the path shape on the same inputs (this
tree's `chip_smoke.conformer_path_inputs`, built with that tree's
package), queued behind a spin kernel (`chip_smoke.queued_ms`). Then the
four CTC kernels (Viterbi, alpha, beta/posterior, gradient scatter) are
timed queued at the full-width training shape (this tree's
`chip_smoke.train_ctc_batch(11)`: B=16, T'=200, S=199, V=4999). With
--ctc only the CTC kernels run. Prints the card's name and power limit and
one JSON line per run.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# Loads this tree's chip_smoke.py under another name, in the tree under
# test: its conformer_path_inputs builds the same inputs with that tree's
# package in both trees.
INPUTS = r"""
def inputs_module(path):
    import importlib.util
    spec = importlib.util.spec_from_file_location('path_inputs', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
"""

# runs inside the tree under test
RUN_PHASE2 = INPUTS + r"""
import json, math, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from cassnat_asr_public_tpu_torch.kernels import _build
from cassnat_asr_public_tpu_torch.kernels import ctc_loss as kl
from cassnat_asr_public_tpu_torch.kernels import ctc_viterbi as kv
from cassnat_asr_public_tpu_torch.kernels import fused_frontend as ff
torch.set_grad_enabled(False)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device('cuda')
_build.build()
_build.lib()
logits, labels, lens, ulen = (
    t if t.is_floating_point() else t.int()
    for t in inputs_module(sys.argv[1]).train_ctc_batch(11, dev))
lp = torch.log_softmax(logits, -1)
score, trellis = kl.ctc_alpha(lp, labels, lens, ulen)
post, chains = kl.ctc_beta_grad(lp, labels, lens, ulen, trellis, score)
cot = 1.0 / ulen.float() / lp.shape[0]
ctc_runs = {
    'ctc_viterbi': lambda: kv.ctc_viterbi(lp, labels, lens, ulen),
    'ctc_alpha': lambda: kl.ctc_alpha(lp, labels, lens, ulen),
    'ctc_beta_grad': lambda: kl.ctc_beta_grad(lp, labels, lens, ulen,
                                              trellis, score),
    'ctc_grad_scatter': lambda: kl.ctc_grad_scatter(post, labels, cot,
                                                    lp.shape[2], chains)}
ctc = {f'{k}_queued_ms': cs.queued_ms(fn, 50) for k, fn in ctc_runs.items()}
if sys.argv[2] == 'ctc':
    print('AB_RESULT ' + json.dumps(ctc), flush=True)
    sys.exit(0)
res = cs.phase_kernels(dev)
c, f, b, t = 512, 240, cs.PATH_B, cs.PATH_T
g = torch.Generator().manual_seed(1)
args = [torch.randn(b, t, f, generator=g).to(dev, torch.bfloat16),
        (torch.randn(c, 1, 3, 3, generator=g) / 3).to(dev),
        (torch.randn(c, generator=g) * 0.1).to(dev),
        (torch.randn(c, c, 3, 3, generator=g) / (3 * math.sqrt(c))).to(
            dev, torch.bfloat16),
        (torch.randn(c, generator=g) * 0.1).to(dev)]
queued = cs.queued_ms(lambda: ff.fused_conv_frontend(*args), 10)
from cassnat_asr_public_tpu_torch.kernels import conformer_layer as cl
inp = inputs_module(sys.argv[1]).conformer_path_inputs(dev, torch.bfloat16)
pk, xl, maskf, pos = inp['pk'], inp['x'], inp['maskf'], inp['pos']
kv = cl.half_a_kv_plain(pk, xl)
runs = {'half_a': lambda: cl.half_a(pk, xl, maskf, pos),
        'half_b': lambda: cl.half_b(pk, xl),
        'half_a_kv': lambda: cl.half_a_kv(pk, xl),
        'half_a_qblock': lambda: cl.half_a_qblock(pk, *kv, maskf, pos, 64)}
half_q = {f'conformer_{k}_bf16_queued_ms': cs.queued_ms(fn, 20)
          for k, fn in runs.items()}
fr = res['fused_conv_frontend']
out = {'frontend_bf16_ms': fr[torch.bfloat16]['ms'],
       'frontend_bf16_library_ms': fr[torch.bfloat16]['library_ms'],
       'frontend_bf16_queued_ms': queued,
       'frontend_f32_ms': fr[torch.float32]['ms'],
       'flash_bf16_ms': res['flash_attention'][torch.bfloat16]['ms'],
       **{f'{k}_bf16_ms': v[torch.bfloat16]['ms'] for k, v in res.items()
          if k.startswith('conformer_')}, **half_q, **ctc}
print('AB_RESULT ' + json.dumps(out), flush=True)
"""


def run(tree: str, mode: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN_PHASE2,
                           os.path.join(HERE, "chip_smoke.py"), mode],
                          cwd=tree, capture_output=True, text=True,
                          timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("AB_RESULT "):
            return json.loads(line[len("AB_RESULT "):])
    raise RuntimeError(f"phase 2 in {tree} failed:\n{proc.stdout[-3000:]}"
                       f"\n{proc.stderr[-3000:]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctc", action="store_true",
                    help="time the CTC kernels only")
    ap.add_argument("other")
    a = ap.parse_args()
    trees = {"other": os.path.abspath(a.other), "this": HERE}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for i, which in enumerate(("other", "this", "this", "other")):
        r = run(trees[which], "ctc" if a.ctc else "all")
        print(json.dumps({"run": i, "tree": which, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
