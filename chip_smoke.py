#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cassnat_asr_public_tpu_torch) on one
NVIDIA H100:

  python3 chip_smoke.py

Phases, each announced on a flushed progress line:
  1. build  - nvcc-builds the port's CUDA kernels from csrc/ (one nvcc per
              source, in parallel) and prints the build seconds.
  2. kernels - each kernel against its plain PyTorch version at the
              LibriSpeech decode shapes, in f32 (TF32 off) and bf16, with the
              stated tolerances; times of kernel, plain version and one
              PyTorch library call (a yardstick the port never calls).
              Flash attention runs bf16 on tensor cores and f32 on CUDA
              cores; its times are also taken queued behind a spin kernel
              (`queued_*`), and its bf16 kernel is checked and timed again
              at the synth shape (D=36 heads sliced from the projection).
              The four fused conformer-layer kernels run at
              the encoder's shapes
              (B=32, T'=184, q blocks of 64 ending in a partial block), with
              the unfused ConEncoderLayer's time as their yardstick (no
              single library call computes the layer), their times also
              queued behind a spin kernel with the TFLOP/s that gives, their
              device scratch and each bf16 kernel's launch plan, then on a
              small batch with a length-0 row.
  2b. training kernels - the CTC Viterbi kernel and the three CTC-loss
              kernels (alpha, beta/posterior, gradient scatter) at the
              full-width training shapes (B=16, 400-800 input frames,
              V=4999, label lengths up to 150 with repeats) against their
              plain versions: Viterbi offsets, states, alignment and alpha
              bit for bit; CTC score and gradient within 2e-5 abs + 2e-5
              rel, two backward passes bit-identical; loss and logit
              gradient against torch.nn.functional.ctc_loss; times of
              kernel, plain version and library call, the bytes bound and
              T' (the DPs' dependent steps). The latency floor of each DP:
              T' x the time of one dependent step of its arithmetic on one
              warp (`ctc_loss.dp_step_latency`: a shuffle, two max and an
              add for Viterbi; a shuffle, logaddexp3 and an add for alpha
              and beta), printed beside the bytes bound.
  3. path   - the main decode path: greedy CASS-NAT decode of one B=32, T=736,
              F=240 batch at the full width of the LibriSpeech config
              (egs/librispeech/conf/cassnat_train.yaml), seeded random
              weights carried through `from_jax_params`, in bf16, with
              use_megakernel False, True and "qblocked"; for each, launch
              counts read around one decode, ms per batch and tokens/s, one
              decode under torch.profiler (device time, busy share, top
              kernels); the fused bf16 decodes against the unfused one
              (token slots, alignments that differ and how many of those
              have a CTC near-tie; informative); then the same batch in f32
              in each mode with the kernels against their plain versions.
  4. synth  - the committed synth CASS-NAT checkpoint decodes the 150
              utterances of egs/synth/data/fbank/test through the decode CLI's
              functions in f32, kernels vs plain versions, with
              use_megakernel False, True and "qblocked" and CTC-only with
              use_megakernel: tokens must be identical; then in bf16 (f32
              parameters, bf16 products, as the LibriSpeech decode runs) in
              the three use_megakernel modes, kernels vs plain versions
              (tokens must be identical) and token agreement against the f32
              runs; CER against the reference transcripts for each.
  5. train  - the main training path: the LibriSpeech config at full width
              with seeded fresh parameters, bf16 products, dropout 0.1,
              MulNoam over the encoder and decoder groups, accum_grad 2,
              grad_clip 5: 3 optimizer updates (6 micro-batches of B=16,
              400-800 frames) through the port's train step, each under
              torch.profiler (loss terms, grad norm per group, wall and
              device ms, launches, peak memory); the launch counts of the
              CTC kernels read around them; every loss and gradient must be
              finite. Then one f32 micro-batch with dropout off, the CTC and
              Viterbi kernels forced on and then off: loss within 1e-5
              relative, every gradient within 1e-4 of its leaf's max |g|,
              trigger masks equal.
  6. oracle - oracle_att of the synth checkpoint on its 150 test utterances
              with the Viterbi kernel on and off: identical tokens; CER
              beside the greedy decode's.

Flash attention and the fused frontend are switched on for phases 3 and 4
and off for 5 (they have no backward); the CTC loss and Viterbi kernels are
forced on for phase 5's main path and on, then off, where a phase compares
the two routes.

It prints the card's name and power limit, a {"kernels": [...]} JSON line,
and as its last line {"ok": true, "device": {...}}. Any failed check raises,
exits non-zero and prints no result. Without a CUDA card it exits with 2.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from cassnat_asr_public_tpu_torch.bin import decode_asr
from cassnat_asr_public_tpu_torch.data.features import load_features
from cassnat_asr_public_tpu_torch.kernels import _build
from cassnat_asr_public_tpu_torch.kernels import conformer_layer as cl
from cassnat_asr_public_tpu_torch.kernels import ctc_loss as kl
from cassnat_asr_public_tpu_torch.kernels import ctc_viterbi as kv
from cassnat_asr_public_tpu_torch.kernels import flash_attention as fa
from cassnat_asr_public_tpu_torch.kernels import fused_frontend as ff
from cassnat_asr_public_tpu_torch.models.cassnat import make_model
from cassnat_asr_public_tpu_torch.nn import modules as M
from cassnat_asr_public_tpu_torch.nn.blocks import ConEncoderLayer
from cassnat_asr_public_tpu_torch.nn.modules import \
    sinusoidal_position_encoding
from cassnat_asr_public_tpu_torch.ops import ctc as C
from cassnat_asr_public_tpu_torch.ops.ctc import align_to_trigger_mask
from cassnat_asr_public_tpu_torch.tasks.cassnat_task import (CassNATTrainer,
                                                             init_params)
from cassnat_asr_public_tpu_torch.utils.config import Config, load_config
from cassnat_asr_public_tpu_torch.utils.decoding import (decode_umax,
                                                         nat_greedy_decode)
from cassnat_asr_public_tpu_torch.weights import (from_jax_params,
                                                  to_jax_params)

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# The CASS-NAT conformer of egs/librispeech/conf/cassnat_train.yaml, the
# model keys only (no YAML reader in the port).
LIBRISPEECH = {
    "input_size": 240, "N_enc": 12, "N_extra": 1, "N_self_dec": 5,
    "N_mix_dec": 2, "d_model": 512, "d_ff": 2048, "n_head": 8,
    "share_ff": False, "d_encff": 1024, "d_decff": 1024,
    "pos_type": "relative", "enc_max_relative_len": 20,
    "enc_kernel_size": 31, "use_conv_enc": True, "use_conv_dec": True,
    "dec_max_relative_len": 8, "dec_kernel_size": 3, "use_trigger": True,
    "src_trigger": True, "use_unimask": False, "left_trigger": 0,
    "right_trigger": 0, "vocab_size": 4999, "left_ctx": 0, "right_ctx": 2,
    "skip_frame": 1, "padding_idx": 0,
}
PATH_B, PATH_T = 32, 736
# flash launches per decode: ConAcExtra's source attention + one per ConMAD
# layer; the frontend runs once
FLASH_PER_DECODE = 1 + LIBRISPEECH["N_mix_dec"]
FRONTEND_PER_DECODE = 1

# tolerances: kernel vs plain version on the same inputs
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),   # f32, order of sums
       torch.bfloat16: dict(atol=1e-2, rtol=1.6e-2)}  # ~2 bf16 ulps
BF16_SCALE = 2e-2      # conformer layer, bf16: share of max |output|
PATH_F32_ATOL = 1e-3   # CTC log-probs and logits after the 21-layer path
MARGIN = 1e-3          # argmax decisions closer than this may flip
BF16_MARGIN = 1e-2     # the same at bf16 rounding (one ulp near 3 is 1.6e-2)
CTC_TOL = 2e-5         # CTC score and gradient: f32, log-sum-exp order

# the full-width training batch: B utterances of TRAIN_FRAMES input frames
TRAIN_B, TRAIN_FRAMES, VOCAB = 16, (400, 800), LIBRISPEECH["vocab_size"]


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else f"nvidia-smi failed: {res.stderr.strip()}"


def cuda_ms(fn, iters, warmup=2):
    """Mean device ms per call over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_kernels():
    """Route the modules' kernel calls to the kernels' plain versions (same
    semantics, e.g. zero rows for fully-masked attention) on the card."""
    saved = (M.flash_attention, M.fused_conv_frontend, cl.half_a, cl.half_b,
             cl.half_a_kv, cl.half_a_qblock)
    M.flash_attention = fa.flash_attention_plain
    M.fused_conv_frontend = ff.fused_conv_frontend_plain
    cl.half_a, cl.half_b = cl.half_a_plain, cl.half_b_plain
    cl.half_a_kv, cl.half_a_qblock = cl.half_a_kv_plain, cl.half_a_qblock_plain
    try:
        yield
    finally:
        (M.flash_attention, M.fused_conv_frontend, cl.half_a, cl.half_b,
         cl.half_a_kv, cl.half_a_qblock) = saved


def reset_launches():
    fa.launches = 0
    ff.launches = 0
    cl.launches = dict.fromkeys(cl.launches, 0)
    kv.launches = 0
    kl.launches = dict.fromkeys(kl.launches, 0)


def read_launches():
    return {"flash_attention": fa.launches,
            "fused_conv_frontend": ff.launches,
            **{f"conformer_{k}": v for k, v in cl.launches.items()},
            "ctc_viterbi": kv.launches,
            **{f"ctc_{k}": v for k, v in kl.launches.items()}}


def check_close(name, got, want, dtype, scale_rule=False):
    """allclose with TOL[dtype]; with `scale_rule` (the conformer layer) the
    bf16 tolerance is instead BF16_SCALE of the output's largest magnitude:
    both sides round to bf16 at the same places, but a sum landing on the
    other side of a rounding boundary moves an intermediate by one bf16 ulp
    and that carries through the layer."""
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype]
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} {dtype}: non-finite output")
    if scale_rule and dtype == torch.bfloat16:
        lim = BF16_SCALE * want.float().abs().max().item()
        ok = err <= lim
        log(f"  {name} {str(dtype)[6:]}: max_abs_err={err:.3e} "
            f"(tolerance {BF16_SCALE} x max|plain| = {lim:.3e})")
    else:
        ok = torch.allclose(got.float(), want.float(), **tol)
        log(f"  {name} {str(dtype)[6:]}: max_abs_err={err:.3e} "
            f"(tolerance atol={tol['atol']} rtol={tol['rtol']})")
    if not ok:
        raise AssertionError(f"{name} {dtype}: kernel disagrees with its "
                             f"plain version, max abs err {err}")
    return err


def random_trigger_mask(gen, dev, b, umax, t4, t4_min):
    """Trigger masks as the path builds them: random best-path alignments
    (about 1 token in 4 frames) over ragged frame counts."""
    lens = torch.randint(t4_min, t4 + 1, (b,), generator=gen)
    lens[0] = t4
    frame = torch.arange(t4)[None, :] < lens[:, None]
    emit = (torch.rand(b, t4, generator=gen) < 0.25) & frame
    shift = torch.zeros(b, t4, dtype=torch.int32)
    shift[:, 1:] = emit[:, :-1].int() * 7
    ylen = torch.clamp((shift != 0).sum(1), max=umax - 1)
    tm = align_to_trigger_mask(shift, umax, frame, lens, ylen) \
        & frame[:, None, :]
    return tm.to(dev)


def measure_flash(q, k, v, mask):
    """The flash kernel against its plain version (TOL of q's dtype, fully
    masked rows exactly 0); times of kernel, plain version and SDPA by CUDA
    events around unqueued calls (`ms`, `plain_ms`, `library_ms`, which
    count the host's work per call) and queued behind a spin kernel
    (`queued_*`, device time alone); the bound: bytes of q, k, v, out and
    mask, or QK^T and PV over the attended pairs, whichever takes
    longer."""
    b, h, tq, d = q.shape
    tk, dtype = k.shape[2], q.dtype
    got = fa.flash_attention(q, k, v, mask)
    want = fa.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = check_close("flash_attention", got, want, dtype)
    dead = ~mask.any(-1)
    if not dead.any():
        raise AssertionError("no fully-masked query rows to check")
    if got[dead[:, None].expand(b, h, tq)].abs().max() != 0:
        raise AssertionError("flash_attention: fully-masked rows not 0")
    am = mask[:, None]
    calls = {"": lambda: fa.flash_attention(q, k, v, mask),
             "plain_": lambda: fa.flash_attention_plain(q, k, v, mask),
             "library_": lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=am)}
    times = {}
    for key, fn in calls.items():
        times[f"{key}ms"] = cuda_ms(fn, 50)
        times[f"queued_{key}ms"] = queued_ms(fn, 50)
    esz = q.element_size()
    nbytes = 2 * esz * b * h * tq * d + 2 * esz * b * h * tk * d \
        + b * tq * tk
    ops = 4 * h * d * int(mask.sum().item())  # over the attended pairs
    bound = max(nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]) * 1e3
    return dict(max_abs_err=err, **times, bound_ms=bound,
                bound_by="bytes" if nbytes / PEAK_BYTES
                >= ops / PEAK_OPS[dtype] else "operations")


def flash_times(r):
    """One log line's worth of `measure_flash`'s times."""
    return (f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, sdpa "
            f"{r['library_ms']:.4f} ms per unqueued call; queued: kernel "
            f"{r['queued_ms']:.4f} ms, plain {r['queued_plain_ms']:.4f} ms, "
            f"sdpa {r['queued_library_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms")


def phase_kernels(dev):
    log("phase 2: kernels vs plain versions at the LibriSpeech path shapes")
    gen = torch.Generator().manual_seed(0)
    results = {}
    b, h, tq, tk, d = PATH_B, LIBRISPEECH["n_head"], 160, PATH_T // 4, \
        LIBRISPEECH["d_model"] // LIBRISPEECH["n_head"]
    # frame counts spread like the path batch's (400..736 input frames)
    mask = random_trigger_mask(gen, dev, b, tq, tk, tk * 400 // 736)
    qkv = [torch.randn(b, h, n, d, generator=gen).to(dev)
           for n in (tq, tk, tk)]
    fb = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dtype) for x in qkv)
        fb[dtype] = measure_flash(q, k, v, mask)
        log(f"  flash_attention {str(dtype)[6:]} B={b} H={h} Tq={tq} "
            f"Tk={tk} D={d}: {flash_times(fb[dtype])}")
    # the synth checkpoint's shape: 4 heads of D = 36 sliced from (B, T,
    # 144) projections as MultiHeadedAttention does (heads 72 bytes apart,
    # so 8-byte copies), 16 utterances of up to 36 tokens and 99 frames;
    # its own generator leaves the later checks' inputs as they were
    sgen = torch.Generator().manual_seed(36)
    sb, sh, sq, sk, sd = 16, 4, 36, 99, 36
    smask = random_trigger_mask(sgen, dev, sb, sq, sk, 24)
    q, k, v = (torch.randn(sb, n, sh * sd, generator=sgen)
               .to(dev, torch.bfloat16).view(sb, n, sh, sd).transpose(1, 2)
               for n in (sq, sk, sk))
    syn = measure_flash(q, k, v, smask)
    log(f"  flash_attention bfloat16 synth shape B={sb} H={sh} Tq={sq} "
        f"Tk={sk} D={sd} (heads sliced from the projection): "
        f"{flash_times(syn)}")
    fb[torch.bfloat16].update(synth_d36_ms=syn["ms"],
                              synth_d36_queued_ms=syn["queued_ms"])
    results["flash_attention"] = fb

    c, f = LIBRISPEECH["d_model"], LIBRISPEECH["input_size"]
    x = torch.randn(b, PATH_T, f, generator=gen)
    w1 = torch.randn(c, 1, 3, 3, generator=gen) / 3.0
    w2 = torch.randn(c, c, 3, 3, generator=gen) / (3.0 * math.sqrt(c))
    b1 = torch.randn(c, generator=gen) * 0.1
    b2 = torch.randn(c, generator=gen) * 0.1
    t2, f2 = (PATH_T + 1) // 2, (f + 1) // 2
    t4, f4 = (t2 + 1) // 2, (f2 + 1) // 2
    fr = {}
    for dtype in (torch.float32, torch.bfloat16):
        # x and w2 in the compute type, conv1 and the biases in f32, as the
        # model passes them
        args = [x.to(dev, dtype), w1.to(dev), b1.to(dev), w2.to(dev, dtype),
                b2.to(dev)]
        got = ff.fused_conv_frontend(*args)
        want = ff.fused_conv_frontend_plain(*args)
        torch.cuda.synchronize()
        err = check_close("fused_conv_frontend", got, want, dtype)
        del got, want
        xs, cw1, cb1, cw2, cb2 = args

        lw1, lb1, lb2 = (a.to(dtype) for a in (cw1, cb1, cb2))

        def library():
            hh = F.relu(F.conv2d(xs[:, None], lw1, lb1, 2, 1))
            return F.relu(F.conv2d(hh, cw2, lb2, 2, 1))

        if dtype == torch.bfloat16:
            log(f"  fused_conv_frontend bfloat16 plan: "
                f"{json.dumps(ff.plan(b, PATH_T, f, c))}")
        ms = cuda_ms(lambda: ff.fused_conv_frontend(*args), 5)
        plain_ms = cuda_ms(lambda: ff.fused_conv_frontend_plain(*args), 3,
                           warmup=1)
        lib_ms = cuda_ms(library, 5)
        # device time alone, back to back behind the spin kernel
        queued = queued_ms(lambda: ff.fused_conv_frontend(*args), 5)
        queued_lib = queued_ms(library, 5)
        esz = xs.element_size()
        nbytes = esz * (b * PATH_T * f + b * t4 * f4 * c + 9 * c * c) \
            + 4 * (9 * c + 2 * c)
        ops = 2 * 9 * c * (b * t2 * f2 + b * t4 * f4 * c)
        bound = max(nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]) * 1e3
        fr[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound,
                         bound_by="bytes" if nbytes / PEAK_BYTES
                         >= ops / PEAK_OPS[dtype] else "operations",
                         queued_ms=queued, queued_library_ms=queued_lib,
                         tflops=ops / queued * 1e-9)
        log(f"  fused_conv_frontend {str(dtype)[6:]} B={b} T={PATH_T} F={f} "
            f"C={c}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"conv2d x2 {lib_ms:.3f} ms per unqueued call; queued: kernel "
            f"{queued:.3f} ms ({ops / queued * 1e-9:.1f} TFLOP/s), conv2d x2 "
            f"{queued_lib:.3f} ms; bound {bound:.3f} ms")
    results["fused_conv_frontend"] = fr
    results.update(conformer_kernels(dev))
    return results


def seeded_layer(dev, dtype, d, h, f, k, seed):
    """A ConEncoderLayer with seeded random f32 parameters computing in
    `dtype`."""
    rng = np.random.default_rng(seed)
    layer = ConEncoderLayer(d, h, f, k, device=dev, compute_dtype=dtype)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            base = 1.0 if name.endswith("norm.weight") else 0.0
            scale = 0.05 if p.dim() == 1 or "pos_bias" in name else \
                1.0 / math.sqrt(int(np.prod(p.shape[1:])))
            p.copy_(torch.from_numpy(
                base + scale * rng.standard_normal(p.shape)).float())
    return layer.eval()


def conformer_bound(kind, b, t, d, h, f, k, p, sum_len, esz):
    """(bytes, operations) the kernel must move and do: each input read
    once, each output written once; attention over the valid keys of every
    query row (sum_len = the batch's valid frames)."""
    m = b * t
    attn = 4 * d * t * sum_len + 2 * m * p * d   # QK, PV; the compact table
    ffn = 4 * m * d * f
    vec = 4 * (10 * d + f + 6 * d)                 # f32 norms and biases
    if kind == "half_a":
        return (esz * (2 * m * d + 2 * d * f + 4 * d * d + p * d)
                + 4 * b * t + vec,
                ffn + 2 * m * d * 3 * d + attn + 2 * m * d * d)
    if kind == "half_b":
        return (esz * (2 * m * d + 2 * d * f + 3 * d * d) + 4 * k * d + vec,
                ffn + 2 * m * d * 2 * d + 2 * m * d * k + 2 * m * d * d)
    if kind == "half_a_kv":
        return (esz * (5 * m * d + 2 * d * f + 2 * d * d) + vec,
                ffn + 2 * m * d * 2 * d)
    return (esz * (5 * m * d + 2 * d * d + p * d) + 4 * b * t + vec,
            2 * m * d * d + attn + 2 * m * d * d)


def conformer_path_inputs(dev, dtype):
    """The fused layer's inputs at the LibriSpeech encoder shapes of the
    path batch (B=32, T'=184 with its spread of lengths), the same on every
    call: the seeded layer, its pack, x (B, T', D) and the mask in `dtype`,
    the valid lengths, the (2R+1, D) position table and its projection."""
    c = LIBRISPEECH
    b, t, d = PATH_B, PATH_T // 4, c["d_model"]
    r = c["enc_max_relative_len"]
    rng = np.random.default_rng(3)
    frames = rng.integers(PATH_T * 400 // 736, PATH_T + 1, b)
    frames[0] = PATH_T
    lens = torch.from_numpy(((frames + 1) // 2 + 1) // 2)
    maskf = (torch.arange(t)[None, :] < lens[:, None]).float().to(dev)
    layer = seeded_layer(dev, dtype, d, c["n_head"], c["d_encff"],
                         c["enc_kernel_size"], seed=7)
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)).to(dev, dtype)
    table = torch.from_numpy(sinusoidal_position_encoding(
        2 * r + 1, d)).to(dev, dtype)
    pk = layer.packed(dtype)
    return dict(layer=layer, pk=pk, x=x, maskf=maskf, lens=lens,
                table=table, pos=pk.position(table))


def conformer_kernels(dev):
    """The four fused-layer kernels against their plain versions at the
    LibriSpeech encoder shapes (B=32, T'=184 with the path batch's spread of
    lengths; q blocks of 64 end in a partial block of 56), times and bounds,
    the unfused ConEncoderLayer as the yardstick (no single library call
    computes a conformer layer); then a small case with a length-0 row."""
    c = LIBRISPEECH
    b, t, d, h = PATH_B, PATH_T // 4, c["d_model"], c["n_head"]
    f, k, r = c["d_encff"], c["enc_kernel_size"], c["enc_max_relative_len"]
    rng = np.random.default_rng(4)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        inp = conformer_path_inputs(dev, dtype)
        layer, pk, x, maskf, lens, pos_table, pos = (inp[n] for n in (
            "layer", "pk", "x", "maskf", "lens", "table", "pos"))
        kv = cl.half_a_kv_plain(pk, x)
        cases = {
            "half_a": (lambda: cl.half_a(pk, x, maskf, pos),
                       lambda: cl.half_a_plain(pk, x, maskf, pos)),
            "half_b": (lambda: cl.half_b(pk, x),
                       lambda: cl.half_b_plain(pk, x)),
            "half_a_kv": (lambda: cl.half_a_kv(pk, x),
                          lambda: cl.half_a_kv_plain(pk, x)),
            "half_a_qblock": (
                lambda: cl.half_a_qblock(pk, *kv, maskf, pos, 64),
                lambda: cl.half_a_qblock_plain(pk, *kv, maskf, pos, 64)),
        }
        scratch_args = {"half_a": (pos,), "half_b": (), "half_a_kv": (),
                        "half_a_qblock": (pos, 64)}
        unfused_ms = cuda_ms(lambda: layer(x, maskf[:, None, :] > 0.5,
                                           pos_table), 10)
        if dtype == torch.bfloat16:
            for kind, extra in (("half_a", (pos,)), ("half_b", ()),
                                ("half_a_kv", ()), ("half_a_qblock", (pos,))):
                log(f"  conformer_{kind} bfloat16 plan: "
                    f"{json.dumps(cl.plan(kind, pk, x, *extra))}")
        fused_ms = {}
        for kind, (kern, plain) in cases.items():
            got, want = kern(), plain()
            if isinstance(got, tuple):   # half_a_kv: x1, ln, k, v
                got, want = torch.stack(got), torch.stack(want)
            torch.cuda.synchronize()
            err = check_close(f"conformer_{kind}", got, want, dtype,
                              scale_rule=True)
            del got, want
            ms = cuda_ms(kern, 10)
            # device time alone, back to back behind the spin kernel
            queued = queued_ms(kern, 10)
            plain_ms = cuda_ms(plain, 3, warmup=1)
            nbytes, ops = conformer_bound(kind, b, t, d, h, f, k, 2 * r + 1,
                                          int(lens.sum()), x.element_size())
            bound = max(nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype]) * 1e3
            fused_ms[kind] = ms
            scratch = cl.scratch_bytes(kind, pk, x, *scratch_args[kind])
            out.setdefault(f"conformer_{kind}", {})[dtype] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                unfused_ms=unfused_ms, bound_ms=bound, scratch_bytes=scratch,
                bound_by="bytes" if nbytes / PEAK_BYTES
                >= ops / PEAK_OPS[dtype] else "operations",
                queued_ms=queued, tflops=ops / queued * 1e-9)
            log(f"  conformer_{kind} {str(dtype)[6:]} B={b} T'={t} D={d} "
                f"H={h} F={f} K={k}: kernel {ms:.4f} ms unqueued, "
                f"{queued:.4f} ms queued ({ops / queued * 1e-9:.1f} "
                f"TFLOP/s), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
                f"({ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); device "
                f"scratch {scratch / 1e6:.1f} MB")
        qblocked_ms = fused_ms["half_a_kv"] + fused_ms["half_a_qblock"] \
            + fused_ms["half_b"]
        log(f"  conformer layer {str(dtype)[6:]}: fused "
            f"{fused_ms['half_a'] + fused_ms['half_b']:.4f} ms, q-blocked "
            f"{qblocked_ms:.4f} ms, unfused ConEncoderLayer.forward "
            f"{unfused_ms:.4f} ms")
        del layer, pk, kv, inp
        torch.cuda.empty_cache()

        # a length-0 row: finite, equal to the plain version
        small = seeded_layer(dev, dtype, d, h, f, k, seed=8)
        x0 = torch.from_numpy(rng.standard_normal((3, 40, d)).astype(
            np.float32)).to(dev, dtype)
        m0 = (torch.arange(40)[None, :] < torch.tensor([40, 0, 27])[:, None]
              ).float().to(dev)
        pk = small.packed(dtype)
        pos = pk.position(pos_table)
        kv0 = cl.half_a_kv_plain(pk, x0)
        for kind, got, want in (
                ("half_a", cl.half_a(pk, x0, m0, pos),
                 cl.half_a_plain(pk, x0, m0, pos)),
                ("half_a_qblock", cl.half_a_qblock(pk, *kv0, m0, pos, 16),
                 cl.half_a_qblock_plain(pk, *kv0, m0, pos, 16))):
            torch.cuda.synchronize()
            check_close(f"conformer_{kind} length-0 row", got, want, dtype,
                        scale_rule=True)
    return out


def train_ctc_batch(seed, dev):
    """CTC-head log-probs, labels and lengths at the full-width training
    shapes: B=16 utterances of 400-800 input frames (T' = frames / 4 after
    the frontend), V=4999, label lengths min(uniform 20-150, (T'_b-1)/2)
    with repeated tokens in every row. Logits are blank-heavy, as a trained
    head's are."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(TRAIN_FRAMES[0], TRAIN_FRAMES[1] + 1, TRAIN_B)
    frames[0] = TRAIN_FRAMES[1]
    t4 = (frames + 1) // 2
    t4 = (t4 + 1) // 2
    ulen = np.minimum(rng.integers(20, 151, TRAIN_B), (t4 - 1) // 2)
    umax = int(ulen.max())
    labels = rng.integers(4, VOCAB, (TRAIN_B, umax))
    for b in range(TRAIN_B):
        rep = rng.integers(1, ulen[b], 3)       # repeats: y[i] = y[i-1]
        labels[b, rep] = labels[b, rep - 1]
        labels[b, ulen[b]:] = 0
    logits = rng.standard_normal((TRAIN_B, int(t4.max()), VOCAB)).astype(
        np.float32)
    logits[..., 0] += 4.0
    return (torch.from_numpy(logits).to(dev),
            torch.from_numpy(labels).to(dev),
            torch.from_numpy(t4).to(dev), torch.from_numpy(ulen).to(dev))


def queued_ms(fn, iters=20):
    """Mean device ms per call of `fn` with the launches queued behind a
    spin kernel, so the device runs them back to back: the time of a
    ~0.1 ms kernel without the host's per-call work between launches
    (which CUDA events around unqueued calls also count)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)      # ~0.1 s at the card's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ctc_bounds(lens, ulen, t_max, s_max, vocab):
    """(bytes, operations) each CTC kernel must move and do on this batch:
    the log-probs its DP gathers (valid frames x valid states), each output
    written once; ~3 operations per state and frame for a max-plus step, ~12
    (3 exp, 1 log, adds) for a log-sum-exp step."""
    lens = lens.long().cpu()
    plen = 2 * ulen.long().cpu() + 1
    cells = int((lens * plen).sum())
    bsz = lens.numel()
    small = 4 * bsz * (2 + ulen.max().item())          # lengths, labels
    trellis_rows = 4 * int(lens.sum()) * s_max
    return {
        "ctc_viterbi": (4 * cells + small + 4 * bsz * t_max * s_max
                        + 4 * bsz * s_max + 8 * bsz * t_max, 3 * cells),
        "ctc_alpha": (4 * cells + small + trellis_rows + 4 * bsz,
                      12 * cells),
        "ctc_beta_grad": (8 * cells + small + 2 * trellis_rows
                          + 8 * bsz * s_max, 16 * cells),
        "ctc_grad_scatter": (trellis_rows + 4 * bsz * t_max * vocab
                             + 4 * bsz, cells),
    }


def phase_train_kernels(dev):
    """The Viterbi and CTC-loss kernels against their plain versions at the
    full-width training shapes; F.ctc_loss as the library yardstick."""
    log("phase 2b: training kernels vs plain versions (B=16, 400-800 input "
        "frames, V=4999)")
    logits, labels, lens, ulen = (t if t.is_floating_point() else t.int()
                                  for t in train_ctc_batch(11, dev))
    lp = torch.log_softmax(logits, -1)
    bsz, t_max, vocab = lp.shape
    s_max = 2 * labels.shape[1] + 1
    log(f"  T'={t_max} (the DPs' dependent steps; per row "
        f"{lens.min().item()}-{lens.max().item()}), U<={labels.shape[1]}, "
        f"S={s_max}")
    out = {}

    # Viterbi: every output equal to the plain version, bit for bit
    got = kv.ctc_viterbi(lp, labels, lens, ulen)
    want = kv.ctc_viterbi_plain(lp, labels, lens, ulen)
    torch.cuda.synchronize()
    for name, g, w in zip(("aligned_seq_shift", "states", "offsets",
                           "alpha"), got, want):
        if not torch.equal(g, w.to(g.dtype)):
            raise AssertionError(f"ctc_viterbi: {name} differs from the "
                                 f"plain version")
    log("  ctc_viterbi: shift, states, offsets and alpha bit-equal to the "
        "plain version")
    vit = lambda: kv.ctc_viterbi(lp, labels, lens, ulen)
    out["ctc_viterbi"] = dict(
        max_abs_err=0.0, ms=queued_ms(vit), call_ms=cuda_ms(vit, 20),
        plain_ms=cuda_ms(lambda: kv.ctc_viterbi_plain(lp, labels, lens,
                                                      ulen), 2, warmup=1),
        library_ms=None)

    # CTC score and gradient: kernels vs plain versions vs F.ctc_loss
    score, trellis = kl.ctc_alpha(lp, labels, lens, ulen)
    score_p, trellis_p = kl.ctc_alpha_plain(lp, labels, lens, ulen)
    cot = 1.0 / ulen.float() / bsz     # the 'mean' reduction's cotangent
    post, chains = kl.ctc_beta_grad(lp, labels, lens, ulen, trellis, score)
    post_p = kl.ctc_beta_grad_plain(lp, labels, lens, ulen, trellis_p,
                                    score_p)
    grad = kl.ctc_grad_scatter(post, labels, cot, vocab, chains)
    grad_p = kl.ctc_grad_scatter_plain(post_p, labels, cot, vocab)
    grad2 = kl.ctc_grad_scatter(
        kl.ctc_beta_grad(lp, labels, lens, ulen, trellis, score)[0], labels,
        cot, vocab, chains)
    torch.cuda.synchronize()
    if not torch.equal(grad, grad2):
        raise AssertionError("ctc backward: two passes differ")
    valid = torch.arange(t_max, device=dev)[None, :] < lens[:, None]
    post_err = (post - post_p)[valid].abs().max().item()
    for name, g, w in (("score", score, score_p), ("gradient", grad, grad_p)):
        err = (g - w).abs().max().item()
        if not torch.allclose(g, w, atol=CTC_TOL, rtol=CTC_TOL):
            raise AssertionError(f"ctc {name}: kernel vs plain max abs err "
                                 f"{err}")
        log(f"  ctc {name}: kernel vs plain max_abs_err={err:.3e} "
            f"(tolerance {CTC_TOL} abs + {CTC_TOL} rel)")
    log(f"  ctc posteriors: kernel vs plain max_abs_err={post_err:.3e}; two "
        f"backward passes bit-identical")

    # against torch.nn.functional.ctc_loss, forward and backward from the
    # logits (its gradient assumes normalized log-probs: compare through
    # the log-softmax)
    @torch.enable_grad()
    def ours():
        x = logits.detach().requires_grad_()
        loss = (-kl.ctc_forward_score_kernel(torch.log_softmax(x, -1),
                                             labels, lens, ulen)
                / ulen).mean()
        return loss, torch.autograd.grad(loss, x)[0]

    @torch.enable_grad()
    def library():
        x = logits.detach().requires_grad_()
        loss = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1), labels,
                          lens, ulen, reduction="mean", zero_infinity=True)
        return loss, torch.autograd.grad(loss, x)[0]

    (l_k, g_k), (l_l, g_l) = ours(), library()
    torch.cuda.synchronize()
    lib_err = max((l_k - l_l).abs().item(), (g_k - g_l).abs().max().item())
    if not (torch.allclose(l_k, l_l, atol=CTC_TOL, rtol=CTC_TOL)
            and torch.allclose(g_k, g_l, atol=CTC_TOL, rtol=CTC_TOL)):
        raise AssertionError(f"ctc vs F.ctc_loss: max abs err {lib_err}")
    log(f"  ctc loss and logit gradient vs F.ctc_loss: max_abs_err="
        f"{lib_err:.3e}")

    lpt = lp.transpose(0, 1)
    nll, log_alpha = torch.ops.aten._ctc_loss(lpt, labels, lens, ulen, 0,
                                              False)
    ones = torch.ones_like(nll)
    path = torch.zeros(bsz, s_max, dtype=torch.long, device=dev)
    path[:, 1::2] = labels
    idx = path[:, None, :].expand(bsz, t_max, s_max)
    for name, kern, plain, lib in (
            ("ctc_alpha",
             lambda: kl.ctc_alpha(lp, labels, lens, ulen),
             lambda: kl.ctc_alpha_plain(lp, labels, lens, ulen),
             lambda: torch.ops.aten._ctc_loss(lpt, labels, lens, ulen, 0,
                                              False)),
            ("ctc_beta_grad",
             lambda: kl.ctc_beta_grad(lp, labels, lens, ulen, trellis,
                                      score),
             lambda: kl.ctc_beta_grad_plain(lp, labels, lens, ulen,
                                            trellis_p, score_p),
             lambda: torch.ops.aten._ctc_loss_backward(
                 ones, lpt, labels, lens, ulen, nll, log_alpha, 0, False)),
            ("ctc_grad_scatter",
             lambda: kl.ctc_grad_scatter(post, labels, cot, vocab, chains),
             lambda: kl.ctc_grad_scatter_plain(post_p, labels, cot, vocab),
             lambda: torch.zeros(bsz, t_max, vocab, device=dev).scatter_add_(
                 2, idx, post))):
        out[name] = dict(
            max_abs_err={"ctc_alpha": (score - score_p).abs().max().item(),
                         "ctc_beta_grad": post_err,
                         "ctc_grad_scatter": (grad - grad_p).abs().max()
                         .item()}[name],
            ms=queued_ms(kern), call_ms=cuda_ms(kern, 20), plain_ms=cuda_ms(plain, 2, warmup=1),
            library_ms=cuda_ms(lib, 20))
    steps = {kind: kl.dp_step_latency(kind, dev, 64 * t_max)
             for kind in ("viterbi", "beta")}
    for kind, (ns, cycles) in steps.items():
        log(f"  one {kind} step on one warp: {ns:.2f} ns, {cycles:.1f} "
            f"cycles (mean of {64 * t_max} chained steps)")
    bounds = ctc_bounds(lens, ulen, t_max, s_max, vocab)
    for name, row in out.items():
        nbytes, ops = bounds[name]
        bound = max(nbytes / PEAK_BYTES, ops / PEAK_OPS[torch.float32]) * 1e3
        row.update(bound_ms=bound, dependent_steps=t_max,
                   bound_by="bytes" if nbytes / PEAK_BYTES
                   >= ops / PEAK_OPS[torch.float32] else "operations")
        kind = DP_STEP.get(name)
        floor = "" if kind is None else \
            f", latency floor {t_max * steps[kind][0] * 1e-6:.4f} ms"
        if kind is not None:
            row.update(floor_ms=t_max * steps[kind][0] * 1e-6,
                       step_ns=steps[kind][0], step_cycles=steps[kind][1])
        lib = "none" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f} ms"
        log(f"  {name} f32: kernel {row['ms']:.4f} ms (queued; "
            f"{row['call_ms']:.4f} ms per unqueued call), plain "
            f"{row['plain_ms']:.3f} ms, library {lib}, bound {bound:.4f} ms "
            f"({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop; {t_max} dependent "
            f"steps){floor}")
    return out


# the DP step whose latency x T' is each CTC kernel's floor (the alpha DP's
# step is the beta DP's arithmetic)
DP_STEP = {"ctc_viterbi": "viterbi", "ctc_alpha": "beta",
           "ctc_beta_grad": "beta"}


def random_params(model, seed):
    """Seeded numpy weights in the flax layout (the form a checkpoint
    holds), for a model's state_dict shapes (vocab ids: 0 blank, 1 sos,
    2 eos, 3 unk, as data/vocab.py reserves them)."""
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith(".table"):
            arr = sinusoidal_position_encoding(*shape)
        elif len(shape) == 1 and k.endswith(".weight"):   # norm scales
            arr = 1.0 + 0.05 * rng.standard_normal(shape)
        elif len(shape) == 1 or "pos_bias" in k:
            arr = 0.02 * rng.standard_normal(shape)
        else:
            arr = rng.standard_normal(shape) / math.sqrt(
                int(np.prod(shape[1:])))
        state[k] = arr.astype(np.float32)
    # blank-heavy CTC posteriors, as a trained model gives: about one
    # token every few frames instead of one per frame
    state["ctc_generator.proj.bias"][0] += 3.5
    return to_jax_params(state)


def profile_decode(fn, ms_batch, label, top=8):
    """One decode under torch.profiler: its device kernel time against the
    unprofiled wall time per decode (`ms_batch`; the profiled wall time
    includes the profiler's start-up), i.e. the device's busy share, and
    the kernels that take the most. Returns (device ms, launches), or
    (None, None) when no device event was recorded."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        log("  profile: no device events recorded (device time not measured)")
        return None, None
    n_launch = sum(e.count for e in kernels)
    log(f"  profile of one {label} decode: device kernels {busy_ms:.2f} ms "
        f"of {ms_batch:.2f} ms wall ({busy_ms / ms_batch:.1%} busy), "
        f"{n_launch} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x  "
            f"{e.key[:80]}")
    return busy_ms, n_launch


def build_path_model(tree, dev, compute_dtype):
    model = make_model(LIBRISPEECH["input_size"], LIBRISPEECH, device=dev,
                       compute_dtype=compute_dtype)
    model.load_state_dict(from_jax_params(tree), strict=True)
    return model.eval()


def expected_launches(mk):
    """Kernel launches of one decode with use_megakernel = mk."""
    n = LIBRISPEECH["N_enc"]
    want = {"flash_attention": FLASH_PER_DECODE,
            "fused_conv_frontend": FRONTEND_PER_DECODE,
            **{f"conformer_{k}": 0 for k in cl.launches},
            "ctc_viterbi": 0, **{f"ctc_{k}": 0 for k in kl.launches}}
    if mk is True:
        want.update(conformer_half_a=n, conformer_half_b=n)
    elif mk == "qblocked":
        want.update(conformer_half_a_kv=n, conformer_half_a_qblock=n,
                    conformer_half_b=n)
    return want


def check_path_f32(model, feats_d, mask_d, umax, mk):
    """The f32 decode (TF32 off) with the kernels against the same decode
    with their plain versions: CTC log-probs and logits within
    PATH_F32_ATOL, identical alignments for every utterance with no CTC
    near-tie, identical decided tokens."""
    got = nat_greedy_decode(model, feats_d, mask_d, umax,
                            return_details=True, use_megakernel=mk)
    with plain_kernels():
        want = nat_greedy_decode(model, feats_d, mask_d, umax,
                                 return_details=True, use_megakernel=mk)
    ctc_err = (got["ctc_out"] - want["ctc_out"]).abs().max().item()
    top2 = want["ctc_out"].topk(2, dim=-1).values
    enc_mask = mask_d[:, ::2][:, ::2]
    near_tie = ((top2[..., 0] - top2[..., 1] <= MARGIN) & enc_mask).any(1)
    flips = (got["ctc_out"].argmax(-1) != want["ctc_out"].argmax(-1)) \
        & enc_mask
    if (flips & ~near_tie[:, None]).any():
        raise AssertionError(f"use_megakernel={mk}: CTC argmax differs at a "
                             f"decided frame")
    same_align = (got["aligned_seq_shift"] == want["aligned_seq_shift"]
                  ).all(1) & (got["ylen0"] == want["ylen0"])
    if (~same_align & ~near_tie).any():
        raise AssertionError(f"use_megakernel={mk}: an alignment with no "
                             f"CTC near-tie differs")
    lg, lw = got["att_logits"], want["att_logits"]
    logit_err = (lg - lw)[same_align].abs().max().item()
    top2 = lw.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1] > MARGIN) & same_align[:, None]
    tok_diff = (lg.argmax(-1) != lw.argmax(-1))
    log(f"  f32 use_megakernel={mk}: ctc log-prob max_abs_err={ctc_err:.3e}, "
        f"logit max_abs_err={logit_err:.3e} (tolerance {PATH_F32_ATOL}); "
        f"alignments differing {int((~same_align).sum())} of {PATH_B} "
        f"(utterances with a CTC near-tie: {int(near_tie.sum())}); token "
        f"slots within the {MARGIN} margin: {int((~decided).sum())} of "
        f"{decided.numel()}")
    if ctc_err > PATH_F32_ATOL or logit_err > PATH_F32_ATOL:
        raise AssertionError(f"use_megakernel={mk}: kernels vs plain "
                             f"versions exceed the tolerance")
    if (tok_diff & decided).any():
        raise AssertionError(f"use_megakernel={mk}: a decided token differs")
    return dict(ctc_err=ctc_err, logit_err=logit_err,
                align_diff=int((~same_align).sum()))


MEGAKERNEL_MODES = (False, True, "qblocked")


def phase_path(dev):
    log("phase 3: main path, LibriSpeech-width greedy decode "
        f"(B={PATH_B}, T={PATH_T}, F={LIBRISPEECH['input_size']}), "
        f"use_megakernel False, True and 'qblocked'; flash attention and "
        f"the fused frontend on")
    M.enable_flash_attention(True)
    M.enable_fused_frontend(True)
    shapes = make_model(LIBRISPEECH["input_size"], LIBRISPEECH,
                        device="meta")
    tree = random_params(shapes, seed=0)
    rng = np.random.default_rng(1)
    lens = rng.integers(PATH_T * 400 // 736, PATH_T + 1, PATH_B)
    lens[0] = PATH_T
    feats = rng.standard_normal(
        (PATH_B, PATH_T, LIBRISPEECH["input_size"])).astype(np.float32)
    mask = np.arange(PATH_T)[None, :] < lens[:, None]
    feats[~mask] = 0.0
    feats_d = torch.from_numpy(feats).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    umax = decode_umax(PATH_T)

    model = build_path_model(tree, dev, torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    launches, stats, tokens = {}, {}, {}
    for mk in MEGAKERNEL_MODES:
        decode = lambda: nat_greedy_decode(model, feats_d, mask_d, umax,
                                           return_details=True,
                                           use_megakernel=mk)
        decode()   # warm-up (packs the fused layers' weights once)
        torch.cuda.synchronize()
        # the main path: one decode, counts read just before and just after
        reset_launches()
        out = decode()
        torch.cuda.synchronize()
        got = read_launches()
        log(f"  use_megakernel={mk}: launches in one decode: {got}")
        if got != expected_launches(mk):
            raise AssertionError(f"use_megakernel={mk}: kernel launches "
                                 f"{got}, expected {expected_launches(mk)}")
        for name, n in got.items():
            if n:
                launches[name] = n
        toks, lengths = out["tokens"], out["lengths"]
        if toks.shape != (PATH_B, umax) or (lengths <= 0).any():
            raise AssertionError(f"bad decode output {tuple(toks.shape)}, "
                                 f"lengths {lengths.tolist()}")
        tokens[mk] = out
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            out = decode()
        torch.cuda.synchronize()
        ms_batch = (time.perf_counter() - t0) * 1e3 / iters
        n_tok = int(torch.clamp(out["lengths"], max=umax).sum().item())
        dev_ms, n_launch = profile_decode(decode, ms_batch,
                                          f"bf16 use_megakernel={mk}")
        log(f"  bf16 use_megakernel={mk}: {ms_batch:.2f} ms per batch of "
            f"{PATH_B}, {n_tok} tokens -> {n_tok / ms_batch * 1e3:.0f} "
            f"tokens/s, {PATH_B / ms_batch * 1e3:.1f} utterances/s "
            f"({n_params / 1e6:.1f}M params, umax={umax}, "
            f"mean tokens {n_tok / PATH_B:.1f})")
        stats[str(mk)] = dict(ms_batch=ms_batch, device_ms=dev_ms,
                              device_launches=n_launch, tokens=n_tok,
                              tokens_per_s=n_tok / ms_batch * 1e3)
    # random weights leave many near-tie logits, so bf16 rounding at other
    # places than the unfused layer's flips some slots: informative only.
    # An alignment that differs from the unfused decode's moves every slot
    # after it; count those utterances and how many of them have a CTC
    # top-2 margin within BF16_MARGIN on a valid frame of either decode.
    n_slots = tokens[False]["tokens"].numel()
    enc_mask = mask_d[:, ::2][:, ::2]
    ref = tokens[False]

    def near_tie(out):
        top2 = out["ctc_out"].topk(2, dim=-1).values
        return ((top2[..., 0] - top2[..., 1] <= BF16_MARGIN)
                & enc_mask).any(1)

    for mk in MEGAKERNEL_MODES[1:]:
        got = tokens[mk]
        same = int((got["tokens"] == ref["tokens"]).sum())
        differ = ~((got["aligned_seq_shift"] == ref["aligned_seq_shift"])
                   .all(1) & (got["ylen0"] == ref["ylen0"]))
        tied = near_tie(got) | near_tie(ref)
        same_rows = int((got["tokens"] == ref["tokens"])[~differ].sum())
        log(f"  bf16 use_megakernel={mk} vs unfused: token slots equal "
            f"{same} of {n_slots}; alignments differing "
            f"{int(differ.sum())} of {PATH_B}, of which "
            f"{int((differ & tied).sum())} have a CTC top-2 margin <= "
            f"{BF16_MARGIN} (utterances with one: {int(tied.sum())}); token "
            f"slots equal where the alignment is equal: {same_rows} of "
            f"{int((~differ).sum()) * umax}")
    del model, tokens
    torch.cuda.empty_cache()

    log("  f32 path (TF32 off): kernels vs their plain versions")
    model = build_path_model(tree, dev, torch.float32)
    for mk in MEGAKERNEL_MODES:
        stats[str(mk)]["f32"] = check_path_f32(model, feats_d, mask_d, umax,
                                               mk)
    del model
    torch.cuda.empty_cache()
    return launches, stats


def _cer(results, vocab_path, ref_path):
    vocab = [line.split()[0] for line in open(vocab_path)]
    refs = {line.split()[0]: line.split()[1:] for line in open(ref_path)}
    errs = total = 0
    for utt, ref in refs.items():
        hyp = [vocab[t - 4] for t in results[utt] if t >= 4]
        d = list(range(len(hyp) + 1))
        for i, r in enumerate(ref, 1):
            prev, d[0] = d[0], i
            for j, hch in enumerate(hyp, 1):
                prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1,
                                       prev + (r != hch))
        errs += d[-1]
        total += len(ref)
    return errs / total


def phase_synth(dev):
    log("phase 4: committed synth checkpoint, 150 test utterances; flash "
        "attention and the fused frontend on")
    M.enable_flash_attention(True)
    M.enable_fused_frontend(True)
    synth = os.path.join(REPO, "egs", "synth")
    ckpt = os.path.join(synth, "exp", "cassnat", "best_model.ckpt")
    cfg = load_config(os.path.join(synth, "exp", "cassnat", "config.yaml"))
    model = decode_asr.load_model(ckpt, cfg, dev, torch.float32)
    items = load_features(
        os.path.join(synth, "data", "fbank", "test", "feats.scp"),
        os.path.join(synth, "data", "fbank", "cmvn.ark"))
    if len(items) != 150:
        raise AssertionError(f"expected 150 utterances, got {len(items)}")
    cer = lambda res: _cer(
        res, os.path.join(synth, "data", "dict", "vocab_char.txt"),
        os.path.join(synth, "data", "test", "token_char.scp"))
    run = lambda m, mk, kind="att": decode_asr.decode_items(
        m, items, 16, dev, use_megakernel=mk, decode_type=kind)
    tag_of = {False: "mk0", True: "mk1", "qblocked": "mkq"}

    def kernels_vs_plain(model, mk, kind, dtype):
        """Tokens with the kernels, checked equal to the plain versions'."""
        tag = f"{dtype} {kind} use_megakernel={mk}"
        t0 = time.perf_counter()
        with_kernels = run(model, mk, kind)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with plain_kernels():
            plain = run(model, mk, kind)
        diff = [u for u in with_kernels if with_kernels[u] != plain[u]]
        rate = cer(with_kernels)
        log(f"  {tag}: 150 utts in {secs:.2f} s (first call included); "
            f"kernel vs plain token mismatches: {len(diff)}; CER {rate:.4%}")
        if diff:
            raise AssertionError(f"{tag}: kernel tokens differ from plain "
                                 f"tokens on {diff[:5]}")
        if not rate < 0.05:
            raise AssertionError(f"{tag}: synth CER {rate} is not that of a "
                                 f"trained model")
        return with_kernels, rate

    out = {}
    f32 = {}
    for mk, kind in ((False, "att"), (True, "att"), ("qblocked", "att"),
                     (True, "ctc_only")):
        f32[(mk, kind)], rate = kernels_vs_plain(model, mk, kind, "f32")
        out[f"cer_f32_{kind}_{tag_of[mk]}"] = rate
    same_fused = sum(f32[(True, "att")][u] == f32[(False, "att")][u]
                     for u, _ in items)
    log(f"  f32 use_megakernel=True vs unfused: {same_fused} of 150 "
        f"utterances identical; CER {out['cer_f32_att_mk1']:.4%} vs "
        f"{out['cer_f32_att_mk0']:.4%}")
    del model
    model = decode_asr.load_model(ckpt, cfg, dev, torch.bfloat16)
    for mk in MEGAKERNEL_MODES:
        bf16, rate = kernels_vs_plain(model, mk, "att", "bf16")
        ref = f32[(mk, "att")]
        same = sum(bf16[u] == ref[u] for u in ref)
        n_tok = sum(len(v) for v in ref.values())
        tok_same = sum(a == b for u in ref for a, b in zip(bf16[u], ref[u]))
        log(f"  bf16 use_megakernel={mk}: {same} of 150 utterances and "
            f"{tok_same} of {n_tok} f32 token slots identical to the f32 "
            f"run; CER {rate:.4%} (f32 "
            f"{out[f'cer_f32_att_{tag_of[mk]}']:.4%})")
        out.update({f"cer_bf16_{tag_of[mk]}": rate,
                    f"bf16_same_utts_{tag_of[mk]}": same,
                    f"bf16_same_tokens_{tag_of[mk]}": tok_same,
                    "f32_tokens": n_tok})
    out["f32_megakernel_same_utts_as_unfused"] = same_fused
    return out


# the training keys of egs/librispeech/conf/cassnat_train.yaml
LIBRISPEECH_TRAIN = dict(
    LIBRISPEECH, dropout=0.1, use_best_path=False, sample_topk=0,
    ctc_alpha=1, att_alpha=1, interctc_alpha=0, interce_alpha=0,
    label_smooth=0.1, optim_type="noam", warmup_type="noam_warmup",
    noam_factor=[0.0005, 0.001], warmup_steps=[15000, 15000],
    freeze_steps=[0, 0], total_steps=250000, accum_grad=2, grad_clip=5,
    weight_decay=0, eps=1e-9, label_bucket=8, frame_bucket=64, seed=0)
TRAIN_UPDATES = 3
# kernels on vs off, f32: the CTC head's gradient within CTC_TOL; every
# parameter's within GRAD_REL of its leaf's max |g|: a fresh initialisation's
# parameter gradients are sums of random-signed terms over ~1e6 positions,
# whose cancellation grows the f32 difference at the CTC head (posterior vs
# autodiff through the scan, ~1e-7) to ~2e-4 on the position projections
GRAD_REL = 1e-3


def train_batch(seed):
    """One collated training batch at full width (the loader's layout):
    B=16 utterances of 400-800 frames of 240-dim features padded to a
    multiple of 64, labels [sos] tokens [eos] padded to a multiple of 8,
    label lengths min(uniform 20-150, (T'_b-1)/2) with repeated tokens."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(TRAIN_FRAMES[0], TRAIN_FRAMES[1] + 1, TRAIN_B)
    t4 = ((frames + 1) // 2 + 1) // 2
    ulen = np.minimum(rng.integers(20, 151, TRAIN_B), (t4 - 1) // 2)
    tpad = -(-frames.max() // 64) * 64
    lpad = -(-(ulen.max() + 2) // 8) * 8
    feats = np.zeros((TRAIN_B, tpad, LIBRISPEECH["input_size"]), np.float32)
    labels = np.zeros((TRAIN_B, lpad), np.int32)
    for b in range(TRAIN_B):
        feats[b, :frames[b]] = rng.standard_normal(
            (frames[b], LIBRISPEECH["input_size"]))
        toks = rng.integers(4, VOCAB, ulen[b])
        rep = rng.integers(1, ulen[b], 3)
        toks[rep] = toks[rep - 1]
        labels[b, :ulen[b] + 2] = [1, *toks, 2]
    return {"feats": feats, "labels": labels,
            "src_mask": np.arange(tpad)[None, :] < frames[:, None],
            "label_sizes": ulen.astype(np.int32)}


def train_f32_check(dev, batch):
    """One f32 micro-batch with dropout off through the training forward
    and backward, CTC and Viterbi kernels forced on, then forced off (the
    scan with autograd, the plain Viterbi loop): loss within 1e-5 relative,
    the gradient at the CTC head's log-probs within CTC_TOL, every
    parameter gradient within GRAD_REL of its leaf's largest |g|, trigger
    masks equal."""
    cfg = Config().update(dict(LIBRISPEECH_TRAIN, dropout=0.0))
    model = make_model(cfg.input_size, cfg, device=dev,
                       compute_dtype=torch.float32)
    init_params(model, 0)
    t = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    labels = t["labels"].long()
    runs = {}
    for on in (True, False):
        C.enable_ctc_loss_kernel(on)
        C.enable_viterbi_kernel(on)
        model.zero_grad()
        out = model(t["feats"], t["src_mask"], labels[:, 1:],
                    t["label_sizes"].long())
        out["ctc_out"].retain_grad()
        out["loss"].backward()
        torch.cuda.synchronize()
        runs[on] = (out["loss"].item(), out["trigger_mask"],
                    {n: p.grad.clone() for n, p in model.named_parameters()},
                    out["ctc_out"].grad)
    C.enable_ctc_loss_kernel(None)
    C.enable_viterbi_kernel(None)
    (l_k, tm_k, g_k, h_k), (l_p, tm_p, g_p, h_p) = runs[True], runs[False]
    loss_rel = abs(l_k - l_p) / abs(l_p)
    head_err = (h_k - h_p).abs().max().item()
    head_ok = torch.allclose(h_k, h_p, atol=CTC_TOL, rtol=CTC_TOL)
    # a key bias shifts every score of a row alike, which softmax ignores:
    # its gradient is zero but for rounding, held to 1e-6 of the largest
    top = max(g.abs().max().item() for g in g_p.values())
    keyb = [n for n in g_p if n.endswith(".k.bias")]
    key_max = max(max(g_k[n].abs().max().item(), g_p[n].abs().max().item())
                  for n in keyb) / top
    worst = max(((g_k[n] - g_p[n]).abs().max().item()
                 / max(g_p[n].abs().max().item(), 1e-30), n)
                for n in g_p if n not in keyb)
    log(f"  f32, dropout off, kernels on vs off: loss {l_k:.7f} vs "
        f"{l_p:.7f} (rel {loss_rel:.2e}, tolerance 1e-5); gradient at the "
        f"CTC log-probs max_abs_err={head_err:.2e} (tolerance {CTC_TOL} abs "
        f"+ {CTC_TOL} rel); worst gradient "
        f"leaf {worst[1]} at {worst[0]:.2e} of its max |g| (tolerance "
        f"{GRAD_REL}); key biases (zero in exact arithmetic) at most "
        f"{key_max:.2e} of the largest |g| (tolerance 1e-6); trigger masks "
        f"equal: {torch.equal(tm_k, tm_p)}")
    if loss_rel > 1e-5 or worst[0] > GRAD_REL or key_max > 1e-6 \
            or not head_ok or not torch.equal(tm_k, tm_p):
        raise AssertionError("training step: kernels on and off disagree")
    del model
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, grad_rel=worst[0], head_err=head_err)


def phase_train(dev):
    """The main training path: the LibriSpeech config at full width,
    seeded fresh init, bf16 products, dropout 0.1, MulNoam over two groups,
    accum_grad 2, grad_clip 5; TRAIN_UPDATES optimizer updates (2 micro-
    batches each) through the port's train step, each micro-batch under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    log(f"phase 5: main training path, LibriSpeech config at full width, "
        f"{TRAIN_UPDATES} optimizer updates of accum_grad 2 micro-batches "
        f"(B={TRAIN_B}, {TRAIN_FRAMES[0]}-{TRAIN_FRAMES[1]} frames), bf16 "
        f"products, dropout 0.1, MulNoam (encoder, decoder)")
    cfg = Config().update(LIBRISPEECH_TRAIN)
    C.enable_ctc_loss_kernel(True)
    C.enable_viterbi_kernel(True)
    trainer = CassNATTrainer(cfg, dev, torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    batches = [train_batch(100 + i) for i in range(2 * TRAIN_UPDATES + 1)]
    steps = []
    with torch.enable_grad():
        trainer.train_step(batches[-1])          # warm-up micro-batch
        trainer.optimizer.zero_grad()
        trainer.optimizer.mini_step = 0
        torch.cuda.synchronize()
        reset_launches()
        for i, batch in enumerate(batches[:-1]):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out, stats = trainer.train_step(batch)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            kern = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
            n_launch = sum(e.count for e in kern)
            terms = {k: out[k].item() for k in ("loss", "ctc_loss",
                                                "att_loss")}
            if stats is None:
                finite = all(torch.isfinite(a).all().item()
                             for acc in trainer.optimizer.acc for a in acc)
                norms = None
            else:
                norms = stats["grad_norm"]
                finite = all(math.isfinite(v) for v in norms.values())
            finite &= all(math.isfinite(v) for v in terms.values())
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            row = dict(terms, grad_norm=norms, wall_ms=wall,
                       device_ms=dev_ms if kern else None,
                       device_launches=n_launch, max_memory_gib=mem,
                       lr=None if stats is None else stats["lr"])
            steps.append(row)
            log(f"  micro-batch {i + 1}: loss {terms['loss']:.4f} (ctc "
                f"{terms['ctc_loss']:.4f}, att {terms['att_loss']:.4f}); "
                f"grad norm {norms}; wall {wall:.1f} ms (profiled), device "
                f"{dev_ms:.1f} ms in {n_launch} kernel launches; peak memory "
                f"{mem:.2f} GiB; T={batch['feats'].shape[1]}, "
                f"L={batch['labels'].shape[1]}")
            if not finite:
                raise AssertionError(f"micro-batch {i + 1}: a loss or a "
                                     f"gradient is not finite")
            if i < 2:
                # where the device time goes: a micro-batch without and one
                # with an optimizer update
                for e in sorted(kern,
                                key=lambda e: -e.self_device_time_total)[:10]:
                    log(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                        f"{e.count:5d}x  {e.key[:80]}")
        torch.cuda.synchronize()
        launches = read_launches()
        log(f"  kernel launches in the {len(steps)} micro-batches: "
            f"{launches}")
        n = len(steps)
        want = {"ctc_viterbi": n, "ctc_alpha": n, "ctc_beta_grad": n,
                "ctc_grad_scatter": n}
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"training: kernel launches {launches}, "
                                 f"expected {want}")
        # unprofiled wall time of two more micro-batches (one update)
        t0 = time.perf_counter()
        for batch in batches[:2]:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_unprofiled = (time.perf_counter() - t0) * 1e3 / 2
        log(f"  unprofiled: {wall_unprofiled:.1f} ms per micro-batch; "
            f"{n_params / 1e6:.1f}M parameters")
        C.enable_ctc_loss_kernel(None)
        C.enable_viterbi_kernel(None)
        del trainer
        torch.cuda.empty_cache()
        check = train_f32_check(dev, batches[0])
    return launches, dict(steps=steps, wall_unprofiled_ms=wall_unprofiled,
                          params=n_params, **check)


def phase_oracle(dev, greedy_cer):
    """oracle_att on the 150 synth test utterances from the committed
    checkpoint, f32: tokens with the Viterbi kernel equal the plain path's;
    CER beside the greedy decode's."""
    log("phase 6: committed synth checkpoint, oracle_att on 150 test "
        "utterances (Viterbi kernel on and off)")
    synth = os.path.join(REPO, "egs", "synth")
    cfg = load_config(os.path.join(synth, "exp", "cassnat", "config.yaml"))
    model = decode_asr.load_model(
        os.path.join(synth, "exp", "cassnat", "best_model.ckpt"), cfg, dev,
        torch.float32)
    items = load_features(
        os.path.join(synth, "data", "fbank", "test", "feats.scp"),
        os.path.join(synth, "data", "fbank", "cmvn.ark"))
    ref_path = os.path.join(synth, "data", "test", "token_char.scp")
    vocab = decode_asr.Vocab(os.path.join(synth, cfg.vocab_file))
    text = decode_asr.read_text_labels(ref_path, vocab)
    out = {}
    for on in (True, False):
        C.enable_viterbi_kernel(on)
        before = kv.launches
        out[on] = decode_asr.decode_items(model, items, 16, dev,
                                          decode_type="oracle_att", text=text,
                                          label_bucket=cfg.label_bucket)
        torch.cuda.synchronize()
        if on and kv.launches == before:
            raise AssertionError("oracle_att: the Viterbi kernel did not run")
    C.enable_viterbi_kernel(None)
    diff = [u for u in out[True] if out[True][u] != out[False][u]]
    cer = _cer(out[True], os.path.join(synth, cfg.vocab_file), ref_path)
    log(f"  oracle_att: kernel vs plain token mismatches {len(diff)} of "
        f"{len(items)}; CER {cer:.4%} (greedy best path, f32, "
        f"{greedy_cer:.4%})")
    if diff:
        raise AssertionError(f"oracle_att: kernel tokens differ on "
                             f"{diff[:5]}")
    if not cer < 0.05:
        raise AssertionError(f"oracle_att: synth CER {cer} is not that of a "
                             f"trained model")
    return dict(oracle_cer=cer, greedy_cer=greedy_cer)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    smi = nvidia_smi()
    log(f"card: {smi}")

    log("phase 1: build")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.lib()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    kern = phase_kernels(dev)
    train_kern = phase_train_kernels(dev)
    launches, path = phase_path(dev)
    synth = phase_synth(dev)
    M.enable_flash_attention(False)
    M.enable_fused_frontend(False)
    train_launches, train = phase_train(dev)
    oracle = phase_oracle(dev, synth["cer_f32_att_mk0"])

    sources = {
        "flash_attention": (
            "cassnat_asr_public_tpu_torch/csrc/flash_attention_tc.cu",
            "cassnat_asr_public_tpu/kernels/flash_attention.py:103"),
        "fused_conv_frontend": (
            "cassnat_asr_public_tpu_torch/csrc/fused_frontend.cu",
            "cassnat_asr_public_tpu/kernels/fused_frontend.py:120"),
        **{f"conformer_{kind}": (
            "cassnat_asr_public_tpu_torch/csrc/conformer_layer.cu",
            f"cassnat_asr_public_tpu/kernels/conformer_layer.py:{line}")
           for kind, line in (("half_a", 78), ("half_b", 163),
                              ("half_a_kv", 322), ("half_a_qblock", 348))},
    }
    rows = []
    for name, (src, replaces) in sources.items():
        r16, r32 = kern[name][torch.bfloat16], kern[name][torch.float32]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "dtype": "bfloat16", **r16,
                     **{f"f32_{k}": r32[k] for k in (
                         "max_abs_err", "ms", "plain_ms", "library_ms",
                         "bound_ms", "unfused_ms") if k in r32}})
    # bf16 runs on tensor cores (flash_attention_tc.cu), f32 on CUDA cores
    rows[0]["f32_source"] = \
        "cassnat_asr_public_tpu_torch/csrc/flash_attention.cu"
    for name, line in (("ctc_viterbi", "ctc_viterbi.py:70"),
                       ("ctc_alpha", "ctc_loss.py:47"),
                       ("ctc_beta_grad", "ctc_loss.py:77"),
                       ("ctc_grad_scatter", "ctc_loss.py:243")):
        src = "ctc_viterbi" if name == "ctc_viterbi" else "ctc_loss"
        rows.append({"name": name, "route": "cuda",
                     "source": f"cassnat_asr_public_tpu_torch/csrc/{src}.cu",
                     "replaces": f"cassnat_asr_public_tpu/kernels/{line}",
                     "launches": train_launches[name], "dtype": "float32",
                     **train_kern[name]})
    log(f"path: {json.dumps(path)}")
    log(f"synth: {json.dumps(synth)}")
    log(f"train: {json.dumps(train)}")
    log(f"oracle: {json.dumps(oracle)}")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
