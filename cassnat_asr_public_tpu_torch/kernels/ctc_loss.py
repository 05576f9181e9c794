"""CTC loss forward and backward: CUDA kernels + plain versions.

Replaces cassnat_asr_public_tpu/kernels/ctc_loss.py:209
`ctc_forward_score_pallas` (custom VJP :208-251): `_alpha_kernel` :47 (the
log-sum-exp alpha trellis and the score), `_beta_grad_kernel` :77 (the beta
DP emitting d logZ / d lp_path = exp(min(alpha + beta - lp - logZ, 1)), zero
outside valid frames and states and for impossible rows) and the one-hot
scatter of that gradient to the vocabulary, times the per-row cotangent
(:243-245).

  log_probs (B, T, V) f32 (only the last axis need be contiguous); labels
  (B, U) ids in [0, V); input_lengths, label_lengths (B,). The score (B,) is
  log P(labels | log_probs); its gradient reaches log_probs through
  `CTCForwardScore`, a torch.autograd.Function whose forward saves the
  alpha trellis and whose backward runs the beta/gradient kernels.

On the H100 (csrc/ctc_loss.cu): the alpha and beta DPs are one block per
batch row walking the T frames; both are T dependent steps, bound by the
latency of one step. The alpha DP keeps its state in shared memory, one
block barrier per frame, and gathers each state's log-prob one frame
ahead. The beta DP has ctc_viterbi's layout (csrc/ctc_dp.cuh): gather
blocks (in one cooperative launch with the DP blocks) copy the path
log-probs into a scratch, frames in the DP's (descending) order, and the
DP block's warps hold the states (1 a lane up to 512) in registers,
exchange neighbours by shuffles and through shared memory across warps
(one named barrier a frame), and load the gathered rows and the alpha
rows 4 frames ahead of the step; it builds the token chains from the
path's tokens in shared memory before the DP. `dp_step_latency` runs the
one-warp probes of one Viterbi and one beta step (off the main path).
The scatter is one block per (b, t) that writes the whole vocabulary row:
it moves the (B, T, V) f32 gradient, the bytes of the backward. The
scatter sums each token's states in a fixed order and writes each column
from one thread, so the gradient is deterministic (no atomics).

`ctc_alpha`, `ctc_beta_grad` and `ctc_grad_scatter` launch the kernels for
CUDA tensors and compute their plain versions only for CPU tensors;
`launches` counts kernel launches by name.
"""

import torch

from cassnat_asr_public_tpu_torch.kernels import _build, ctc_dp
from cassnat_asr_public_tpu_torch.ops.ctc import (LOG_ZERO, _final_pair,
                                                  _interleave_blanks,
                                                  _path_setup)

MAX_STATES = 4096   # 4 states per thread, 1024 threads
launches = {"alpha": 0, "beta_grad": 0, "grad_scatter": 0}


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                        + torch.exp(c - m))
    return torch.where(m <= LOG_ZERO / 2, LOG_ZERO, out)


def _shift(x, k, fill):
    """x moved k states right (k > 0) or left (k < 0), `fill` entering."""
    pad = torch.full_like(x[:, :abs(k)], fill)
    if k > 0:
        return torch.cat([pad, x[:, :-k]], 1)
    return torch.cat([x[:, -k:], pad], 1)


# ------------------------------------------------------------ plain versions

def ctc_alpha_plain(log_probs, labels, input_lengths, label_lengths,
                    blank=0):
    """The alpha kernel in plain PyTorch: (score (B,), trellis (B, T, S);
    rows past each input length are frozen copies)."""
    path, lp_path, same, outside, path_lens, alpha = _path_setup(
        log_probs, labels, label_lengths, blank)
    bs, tmax, smax = lp_path.shape
    lens = input_lengths.long().to(alpha.device)
    trellis = torch.empty((bs, tmax, smax), device=alpha.device)
    for t in range(tmax):
        s1 = _shift(alpha, 1, LOG_ZERO)
        s2 = torch.where(same, LOG_ZERO, _shift(alpha, 2, LOG_ZERO))
        new = _logaddexp3(alpha, s1, s2) + lp_path[:, t]
        new = torch.where(outside, LOG_ZERO, new)
        alpha = torch.where((t < lens)[:, None], new, alpha)
        trellis[:, t] = alpha
    last, prev = _final_pair(alpha, path_lens)
    prev = torch.where(path_lens >= 2, prev, LOG_ZERO)
    return torch.logaddexp(last, prev), trellis


def ctc_beta_grad_plain(log_probs, labels, input_lengths, label_lengths,
                        trellis, score, blank=0):
    """The beta/posterior kernel in plain PyTorch: d score / d lp_path
    (B, T, S)."""
    path, lp_path, same, outside, path_lens, _ = _path_setup(
        log_probs, labels, label_lengths, blank)
    bs, tmax, smax = lp_path.shape
    dev = lp_path.device
    lens = input_lengths.long().to(dev)
    cols = torch.arange(smax, device=dev)[None, :]
    # s -> s+2 is allowed where path[s+2] != path[s]
    block2 = (cols >= smax - 2) | _shift(same, -2, True)
    terminal = (cols == path_lens[:, None] - 1) \
        | ((cols == path_lens[:, None] - 2) & (path_lens[:, None] >= 2))
    bad_z = (score <= LOG_ZERO / 2)[:, None]
    beta = torch.full((bs, smax), LOG_ZERO, device=dev)
    post = torch.zeros((bs, tmax, smax), device=dev)
    for t in range(tmax - 1, -1, -1):
        lp_t = lp_path[:, t]
        l1 = _shift(beta, -1, LOG_ZERO)
        l2 = torch.where(block2, LOG_ZERO, _shift(beta, -2, LOG_ZERO))
        new = torch.where(outside, LOG_ZERO, lp_t + _logaddexp3(beta, l1, l2))
        init = torch.where(terminal & ~outside, lp_t, LOG_ZERO)
        beta = torch.where((t == lens - 1)[:, None], init,
                           torch.where((t < lens)[:, None], new, beta))
        gamma = trellis[:, t] + beta - lp_t - score[:, None]
        p = torch.exp(torch.clamp(gamma, max=1.0))
        keep = (t < lens)[:, None] & ~outside & ~bad_z
        post[:, t] = torch.where(keep, p, 0.0)
    return post


def ctc_grad_scatter_plain(post, labels, cot, vocab, blank=0):
    """The scatter kernel in plain PyTorch: the (B, T, S) posteriors summed
    onto their tokens' columns (a one-hot product, as the JAX package does),
    times the per-row cotangent: (B, T, V)."""
    path = _interleave_blanks(labels.long(), blank)
    onehot = torch.nn.functional.one_hot(path, vocab).to(post.dtype)
    return torch.bmm(post, onehot) * cot[:, None, None]


# ------------------------------------------------------------- the kernels

def _check(log_probs, labels, input_lengths, label_lengths, name):
    if log_probs.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {log_probs.device}")
    if log_probs.dtype != torch.float32 or log_probs.dim() != 3:
        raise TypeError(f"{name}: log_probs must be (B, T, V) f32, got "
                        f"{tuple(log_probs.shape)} {log_probs.dtype}")
    bs = log_probs.shape[0]
    if labels.dim() != 2 or labels.shape[0] != bs \
            or input_lengths.shape != (bs,) \
            or label_lengths.shape != (bs,):
        raise ValueError(f"{name}: labels {tuple(labels.shape)}, lengths "
                         f"{tuple(input_lengths.shape)} / "
                         f"{tuple(label_lengths.shape)} do not fit B={bs}")
    if 2 * labels.shape[1] + 1 > MAX_STATES:
        raise ValueError(f"{name}: S = 2U+1 > {MAX_STATES}")
    dev = log_probs.device
    lp = log_probs if log_probs.stride(2) == 1 else log_probs.contiguous()
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()
    return lp, i32(labels), i32(input_lengths), i32(label_lengths)


def ctc_alpha(log_probs, labels, input_lengths, label_lengths, blank=0):
    """(score (B,), trellis (B, T, S)): kernel for CUDA tensors, plain
    version for CPU tensors. The kernel writes trellis rows t < len_b only
    (the backward reads no others)."""
    if log_probs.device.type == "cpu":
        return ctc_alpha_plain(log_probs, labels, input_lengths,
                               label_lengths, blank)
    lp, lab, in_lens, lab_lens = _check(log_probs, labels, input_lengths,
                                        label_lengths, "ctc_alpha")
    bs, tmax, vocab = lp.shape
    umax = lab.shape[1]
    trellis = torch.empty((bs, tmax, 2 * umax + 1), device=lp.device)
    score = torch.empty((bs,), device=lp.device)
    if bs == 0 or tmax == 0:
        return score.fill_(LOG_ZERO), trellis
    err = _build.lib().cassnat_ctc_alpha(
        lp.data_ptr(), lp.stride(0), lp.stride(1), lab.data_ptr(),
        in_lens.data_ptr(), lab_lens.data_ptr(), bs, tmax, umax, vocab, blank,
        trellis.data_ptr(), score.data_ptr(), _build.stream_ptr(lp.device))
    _build.check(err, "ctc_alpha")
    launches["alpha"] += 1
    return score, trellis


def ctc_beta_grad(log_probs, labels, input_lengths, label_lengths, trellis,
                  score, blank=0):
    """Posteriors d score / d lp_path (B, T, S) and the token chains the
    scatter walks (next state with the same token, first state of each
    token), or None for the chains on the CPU: kernel for CUDA tensors,
    plain version for CPU tensors. Rows t >= len_b are left unwritten by the
    kernel; the scatter reads none of them."""
    if log_probs.device.type == "cpu":
        return ctc_beta_grad_plain(log_probs, labels, input_lengths,
                                   label_lengths, trellis, score,
                                   blank), None
    lp, lab, in_lens, lab_lens = _check(log_probs, labels, input_lengths,
                                        label_lengths, "ctc_beta_grad")
    bs, tmax, vocab = lp.shape
    umax = lab.shape[1]
    smax = 2 * umax + 1
    if trellis.shape != (bs, tmax, smax) or score.shape != (bs,) \
            or not trellis.is_contiguous():
        raise ValueError("ctc_beta_grad: trellis/score do not fit the inputs")
    post = torch.empty_like(trellis)
    nxt = torch.empty((bs, smax), dtype=torch.int32, device=lp.device)
    head = torch.empty((bs, smax), dtype=torch.int32, device=lp.device)
    if bs and tmax:
        lp_path, flags = ctc_dp.scratch(bs, tmax, smax, lp.device)
        err = _build.lib().cassnat_ctc_beta_grad(
            lp.data_ptr(), lp.stride(0), lp.stride(1), lab.data_ptr(),
            in_lens.data_ptr(), lab_lens.data_ptr(), trellis.data_ptr(),
            score.float().contiguous().data_ptr(), bs, tmax, umax, vocab,
            blank, lp_path.data_ptr(), flags.data_ptr(),
            post.data_ptr(), nxt.data_ptr(), head.data_ptr(),
            _build.stream_ptr(lp.device))
        _build.check(err, "ctc_beta_grad")
        launches["beta_grad"] += 1
    return post, (lab, in_lens, nxt, head)


def ctc_grad_scatter(post, labels, cot, vocab, chains=None, blank=0):
    """d loss / d log_probs (B, T, V) from the posteriors and the per-row
    cotangent: kernel for CUDA tensors (with `chains` from ctc_beta_grad),
    plain version for CPU tensors."""
    if post.device.type == "cpu":
        return ctc_grad_scatter_plain(post, labels, cot, vocab, blank)
    if post.device.type != "cuda" or chains is None:
        raise ValueError("ctc_grad_scatter: needs CUDA posteriors and the "
                         "token chains from ctc_beta_grad")
    lab, in_lens, nxt, head = chains
    bs, tmax, smax = post.shape
    cot = cot.to(device=post.device, dtype=torch.float32).contiguous()
    grad = torch.empty((bs, tmax, vocab), device=post.device)
    if bs and tmax:
        err = _build.lib().cassnat_ctc_grad_scatter(
            post.data_ptr(), lab.data_ptr(), in_lens.data_ptr(),
            nxt.data_ptr(), head.data_ptr(), cot.data_ptr(), bs, tmax,
            lab.shape[1], vocab, blank, grad.data_ptr(),
            _build.stream_ptr(post.device))
        _build.check(err, "ctc_grad_scatter")
        launches["grad_scatter"] += 1
    return grad


def dp_step_latency(kind, dev, steps):
    """(ns, clock cycles) of one dependent step of a CTC DP on one warp:
    kind "viterbi" (a shuffle, two max and an add) or "beta" (a shuffle,
    logaddexp3 and an add), from `steps` chained steps timed inside the
    probe kernel. T' of them are the DP's latency floor."""
    if kind not in ("viterbi", "beta"):
        raise ValueError(f"dp_step_latency: unknown kind {kind!r}")
    g = torch.Generator().manual_seed(0)
    inp = torch.cat([-torch.rand(32, generator=g),
                     -2.0 - torch.rand(32, generator=g),
                     -1.0 - torch.rand(32, generator=g)]).to(dev)
    out = torch.empty(32, device=dev)
    elapsed = torch.zeros(2, dtype=torch.int64, device=dev)
    fn = getattr(_build.lib(), f"cassnat_ctc_{kind}_step_probe")
    _build.check(fn(inp.data_ptr(), steps, out.data_ptr(),
                    elapsed.data_ptr(), _build.stream_ptr(dev)),
                 f"{kind}_step_probe")
    ns, cycles = elapsed.tolist()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{kind}_step_probe: non-finite chain")
    return ns / steps, cycles / steps


class CTCForwardScore(torch.autograd.Function):
    """log P(labels | log_probs) per row with the alpha kernel forward and
    the beta/gradient kernels backward."""

    @staticmethod
    def forward(ctx, log_probs, labels, input_lengths, label_lengths, blank):
        score, trellis = ctc_alpha(log_probs, labels, input_lengths,
                                   label_lengths, blank)
        ctx.blank = blank
        ctx.save_for_backward(log_probs, labels, input_lengths,
                              label_lengths, trellis, score)
        return score

    @staticmethod
    def backward(ctx, g):
        log_probs, labels, input_lengths, label_lengths, trellis, score = \
            ctx.saved_tensors
        post, chains = ctc_beta_grad(log_probs, labels, input_lengths,
                                     label_lengths, trellis, score,
                                     ctx.blank)
        grad = ctc_grad_scatter(post, labels, g, log_probs.shape[2], chains,
                                ctx.blank)
        return grad.to(log_probs.dtype), None, None, None, None


def ctc_forward_score_kernel(log_probs, labels, input_lengths,
                             label_lengths, blank=0):
    """The kernel route of ops.ctc.ctc_forward_score (differentiable)."""
    return CTCForwardScore.apply(log_probs, labels, input_lengths,
                                 label_lengths, blank)
