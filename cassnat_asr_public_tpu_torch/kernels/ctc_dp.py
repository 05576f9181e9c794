"""Scratch of the rebuilt CTC dynamic programs (csrc/ctc_dp.cuh), shared
by the Viterbi and the beta/posterior wrappers.

The kernels choose their layout from S alone (the fewest states a lane that
fit S in 16 warps) and own its sizes: `scratch` asks the library for them.
"""

import ctypes

import torch

from cassnat_asr_public_tpu_torch.kernels import _build


def scratch(bs, tmax, smax, dev):
    """(lp_path, flags) of one launch at B, T and S: the gather blocks'
    copy of the path log-probs, (B, T * SP) f32 with SP the padded states
    of the layout, and their chunk flags, (B, chunks + 1) int32 zeros."""
    sizes = (ctypes.c_int64 * 2)()
    _build.check(_build.lib().cassnat_ctc_dp_scratch(tmax, smax, sizes),
                 f"ctc_dp_scratch (T={tmax}, S={smax})")
    return (torch.empty((bs, sizes[0]), device=dev),
            torch.zeros((bs, sizes[1]), dtype=torch.int32, device=dev))
