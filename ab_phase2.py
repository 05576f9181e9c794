"""A/B of chip_smoke.py's phase 2 (kernels against their plain versions at
the LibriSpeech path shapes) between another tree and this one, on one card.

    python3 ab_phase2.py OTHER_TREE

OTHER_TREE is a checkout (e.g. `git archive <commit>
cassnat_asr_public_tpu_torch chip_smoke.py` unpacked into a directory)
whose chip_smoke.py has `phase_kernels` and `queued_ms`. The runs go
other, this, this, other, each a fresh process in that tree's directory:
it builds that tree's kernels, runs its phase 2, and then times the bf16
frontend and the bf16 conformer halves (half_a, half_b) at the path shape
on the same inputs (this tree's `chip_smoke.conformer_path_inputs`, built
with that tree's package), queued behind a spin kernel
(`chip_smoke.queued_ms`). Prints the card's name and power limit and one
JSON line per run.
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
from cassnat_asr_public_tpu_torch.kernels import fused_frontend as ff
torch.set_grad_enabled(False)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device('cuda')
_build.build()
_build.lib()
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
half_q = {'conformer_half_a_bf16_queued_ms':
          cs.queued_ms(lambda: cl.half_a(pk, xl, maskf, pos), 20),
          'conformer_half_b_bf16_queued_ms':
          cs.queued_ms(lambda: cl.half_b(pk, xl), 20)}
fr = res['fused_conv_frontend']
out = {'frontend_bf16_ms': fr[torch.bfloat16]['ms'],
       'frontend_bf16_library_ms': fr[torch.bfloat16]['library_ms'],
       'frontend_bf16_queued_ms': queued,
       'frontend_f32_ms': fr[torch.float32]['ms'],
       'flash_bf16_ms': res['flash_attention'][torch.bfloat16]['ms'],
       **{f'{k}_bf16_ms': v[torch.bfloat16]['ms'] for k, v in res.items()
          if k.startswith('conformer_')}, **half_q}
print('AB_RESULT ' + json.dumps(out), flush=True)
"""


def run(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN_PHASE2,
                           os.path.join(HERE, "chip_smoke.py")], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("AB_RESULT "):
            return json.loads(line[len("AB_RESULT "):])
    raise RuntimeError(f"phase 2 in {tree} failed:\n{proc.stdout[-3000:]}"
                       f"\n{proc.stderr[-3000:]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    a = ap.parse_args()
    trees = {"other": os.path.abspath(a.other), "this": HERE}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for i, which in enumerate(("other", "this", "this", "other")):
        r = run(trees[which])
        print(json.dumps({"run": i, "tree": which, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
