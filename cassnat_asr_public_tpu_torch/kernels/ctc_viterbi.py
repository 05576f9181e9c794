"""CTC Viterbi forced alignment: CUDA kernel + plain version.

Replaces cassnat_asr_public_tpu/kernels/ctc_viterbi.py:70
`ctc_viterbi_align_pallas` (Pallas `_viterbi_kernel` :34 and the backtrace
after it, :119-147). Same function: the max-product CTC DP over the
blank-interleaved path (S = 2U+1 states), first-max back-pointer offsets
(strict > in the order stay, s-1, s-2), frames past each input length frozen
with offset 0, the final state S_b-1 if its alpha beats S_b-2's, the reverse
backtrace clipped to [0, S-1], and `_collapse_and_shift`.

  log_probs (B, T, V) f32 (the CTC head's log-softmax; only the last axis
  need be contiguous); labels (B, U) ids in [0, V) without sos/eos;
  input_lengths, label_lengths (B,). Returns (aligned_seq_shift (B, T)
  int32, states (B, T) int32, offsets (B, T, S) int32, final alpha (B, S)
  f32).

On the H100 (csrc/ctc_viterbi.cu, csrc/ctc_dp.cuh): gather blocks and one
DP block per batch row, in one cooperative launch (or the gather blocks in
a launch of their own first, where none fits beside the rows). The gather
blocks copy lp[b, t, path[s]] into a (B, T, SP) scratch chunk by chunk of
8 frames and flag each chunk. The DP block's warps hold the fewest
contiguous states a lane that fit S in 16 warps (1 up to 512 states) in
registers, exchange neighbours by warp shuffles and the warps' edge states
through shared memory (one named barrier of the DP warps a frame), and
load the gathered rows 16 frames ahead of the step. The offsets are kept
as bytes in shared memory, where the backtrace reads them, and go to the
output in 16-byte stores after it; a row whose T x S bytes do not fit
takes the stated other branch: the DP stores them to the output and the
backtrace reads them back from device memory. The DP is T dependent
steps, so the kernel is bound by the latency of one step, not by bytes or
operations. Max and add are exact: every output equals the plain version
bit for bit.

`ctc_viterbi` launches the kernel for CUDA tensors and computes
`ctc_viterbi_plain` only for CPU tensors; `launches` counts kernel launches.
"""

import torch

from cassnat_asr_public_tpu_torch.kernels import _build, ctc_dp
from cassnat_asr_public_tpu_torch.ops.ctc import (LOG_ZERO,
                                                  _collapse_and_shift,
                                                  _final_pair, _path_setup)

MAX_STATES = 4096   # 16 warps of 32 lanes, 8 states a lane
launches = 0


def ctc_viterbi_plain(log_probs, labels, input_lengths, label_lengths,
                      blank=0):
    """The kernel's arithmetic in plain PyTorch (a loop over frames)."""
    path, lp_path, same, outside, path_lens, alpha = _path_setup(
        log_probs, labels, label_lengths, blank)
    bs, tmax, smax = lp_path.shape
    lens = input_lengths.long().to(alpha.device)
    offsets = torch.zeros((bs, tmax, smax), dtype=torch.int32,
                          device=alpha.device)
    neg = torch.full((bs, 2), LOG_ZERO, device=alpha.device)
    for t in range(tmax):
        s1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        s2 = torch.cat([neg[:, :min(2, smax)], alpha[:, :-2]], 1)
        s2 = torch.where(same, LOG_ZERO, s2)
        m01 = torch.maximum(alpha, s1)
        best = torch.maximum(m01, s2)
        off = torch.where(s2 > m01, 2, (s1 > alpha).int())
        new = torch.where(outside, LOG_ZERO, best) + lp_path[:, t]
        active = (t < lens)[:, None]
        offsets[:, t] = torch.where(active, off, 0)
        alpha = torch.where(active, new, alpha)
    last, prev = _final_pair(alpha, path_lens)
    s_final = torch.where(last > prev, path_lens - 1,
                          (path_lens - 2).clamp(min=0))
    states = torch.empty((bs, tmax), dtype=torch.long, device=alpha.device)
    carry = s_final
    for t in range(tmax - 1, -1, -1):
        cur = torch.where(t == lens - 1, s_final, carry)
        states[:, t] = cur
        back = offsets[:, t].gather(1, cur[:, None])[:, 0]
        carry = (cur - back).clamp(0, smax - 1)
    aligned = path.gather(1, states)
    valid = torch.arange(tmax, device=alpha.device)[None, :] < lens[:, None]
    aligned = torch.where(valid, aligned, blank)
    return (_collapse_and_shift(aligned, blank).to(torch.int32),
            states.to(torch.int32), offsets, alpha)


def _as_int32(t, dev):
    return t.to(device=dev, dtype=torch.int32).contiguous()


def ctc_viterbi(log_probs, labels, input_lengths, label_lengths, blank=0):
    """Viterbi alignment: kernel for CUDA tensors, plain version for CPU
    tensors."""
    if log_probs.device.type == "cpu":
        return ctc_viterbi_plain(log_probs, labels, input_lengths,
                                 label_lengths, blank)
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc_viterbi: unsupported device {log_probs.device}")
    global launches
    if log_probs.dtype != torch.float32 or log_probs.dim() != 3:
        raise TypeError(f"ctc_viterbi: log_probs must be (B, T, V) f32, got "
                        f"{tuple(log_probs.shape)} {log_probs.dtype}")
    bs, tmax, vocab = log_probs.shape
    if labels.dim() != 2 or labels.shape[0] != bs \
            or input_lengths.shape != (bs,) \
            or label_lengths.shape != (bs,):
        raise ValueError(f"ctc_viterbi: labels {tuple(labels.shape)}, lengths "
                         f"{tuple(input_lengths.shape)} / "
                         f"{tuple(label_lengths.shape)} do not fit B={bs}")
    umax = labels.shape[1]
    smax = 2 * umax + 1
    if smax > MAX_STATES:
        raise ValueError(f"ctc_viterbi: S = 2U+1 = {smax} > {MAX_STATES}")
    dev = log_probs.device
    lp = log_probs if log_probs.stride(2) == 1 else log_probs.contiguous()
    lab = _as_int32(labels, dev)
    in_lens, lab_lens = _as_int32(input_lengths, dev), \
        _as_int32(label_lengths, dev)
    offsets = torch.empty((bs, tmax, smax), dtype=torch.int32, device=dev)
    alpha = torch.empty((bs, smax), dtype=torch.float32, device=dev)
    states = torch.empty((bs, tmax), dtype=torch.int32, device=dev)
    shift = torch.empty((bs, tmax), dtype=torch.int32, device=dev)
    if bs == 0 or tmax == 0:
        return shift, states, offsets, alpha
    lp_path, flags = ctc_dp.scratch(bs, tmax, smax, dev)
    err = _build.lib().cassnat_ctc_viterbi(
        lp.data_ptr(), lp.stride(0), lp.stride(1), lab.data_ptr(),
        in_lens.data_ptr(), lab_lens.data_ptr(), bs, tmax, umax, vocab, blank,
        lp_path.data_ptr(), flags.data_ptr(),
        offsets.data_ptr(), alpha.data_ptr(), states.data_ptr(),
        shift.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "ctc_viterbi")
    launches += 1
    return shift, states, offsets, alpha
