"""Fused two-layer strided-conv frontend: CUDA kernel + plain version.

Replaces cassnat_asr_public_tpu/kernels/fused_frontend.py:120
`fused_conv_frontend` (Pallas `_frontend_kernel`). Same function:
relu(conv2(relu(conv1(x)))) with 3x3 kernels, stride 2, padding 1;
conv1 is 1 -> C channels, conv2 is C -> C; the conv1 output never reaches
device memory.

  x (B, T, F) f32 or bf16 (bf16 needs C % 8 == 0); w1 (C, 1, 3, 3) and
  w2 (C, C, 3, 3) in PyTorch's OIHW layout; b1, b2 (C,). conv1 and both
  biases are computed in f32 whatever their type (the model keeps them in
  f32), w2 is cast to x.dtype. Returns (B, T4, F4, C), the JAX package's
  layout, with T4 = ceil(ceil(T/2)/2) and F4 likewise, in x.dtype.

On the H100 (csrc/fused_frontend.cu): conv2 is the work, 2*9*C^2 FLOPs per
output position (1.67 TFLOP at B=32, T=736, F=240, C=512), so the bound
is arithmetic (1.7 ms at the bf16 tensor-core peak). Both routes are
implicit GEMMs with f32 accumulation that keep conv1's output in shared
memory (zero outside the valid range, conv2's padding). bf16 inputs run
a persistent, warp-specialised kernel: w2 packed (9, Cout, Cin) by
`pack_w2` arrives by TMA, conv1 runs once per tile position on the
tensor cores (w1 split exactly into bf16 hi + lo, f32 sums) in slices of
32 channels, and conv2 runs on wgmma m64n256k16 over tiles of 128 output
positions x 256 channels (the .cu chooses the tile; `plan` reports it).
f32 inputs run conv1 and conv2 on the CUDA cores (no TF32 rounding).

`fused_conv_frontend` launches the kernel for CUDA tensors and computes
`fused_conv_frontend_plain` only for CPU tensors; `launches` counts kernel
launches.
"""

import torch
import torch.nn.functional as F

from cassnat_asr_public_tpu_torch.kernels import _build

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _out_len(n: int) -> int:
    return (n + 1) // 2


def fused_conv_frontend_plain(x, w1, b1, w2, b2):
    """The kernel's arithmetic in plain PyTorch: conv1 as 9 scaled taps,
    ReLU, rounding to x.dtype, conv2 as 9 accumulated (C x C) GEMM taps,
    all accumulated in f32."""
    bsz, t, f = x.shape
    c = w2.shape[0]
    t2, f2 = _out_len(t), _out_len(f)
    t4, f4 = _out_len(t2), _out_len(f2)
    xp = F.pad(x.float(), (1, 1, 1, 1))
    h1 = torch.zeros((bsz, t2, f2, c), dtype=torch.float32, device=x.device)
    w1f = w1.float().reshape(c, 3, 3)
    for dt in range(3):
        for df in range(3):
            tap = xp[:, dt:dt + 2 * t2 - 1:2, df:df + 2 * f2 - 1:2]
            h1 = h1 + tap[..., None] * w1f[:, dt, df]
    h1 = torch.relu(h1 + b1.float()).to(x.dtype).float()
    hp = F.pad(h1, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((bsz, t4, f4, c), dtype=torch.float32, device=x.device)
    w2f = w2.float()
    for dt in range(3):
        for df in range(3):
            tap = hp[:, dt:dt + 2 * t4 - 1:2, df:df + 2 * f4 - 1:2]
            acc = acc + torch.matmul(tap, w2f[:, :, dt, df].t())
    return torch.relu(acc + b2.float()).to(x.dtype)


def pack_w2(w2, dtype):
    """OIHW w2 -> the kernel's layout in `dtype`: (9, Cout, Cin), tap
    3 dt + df, for bf16 (K-major, what the wgmma B descriptor reads);
    (9, Cin, Cout) for f32."""
    c = w2.shape[0]
    if dtype == torch.bfloat16:
        return w2.permute(2, 3, 0, 1).reshape(9, c, c).to(dtype).contiguous()
    return w2.permute(2, 3, 1, 0).reshape(9, c, c).to(dtype).contiguous()


def plan(b: int, t: int, f: int, c: int) -> dict:
    """The bf16 route's launch plan on the current card, for logs: the
    tile (TT rows x FW columns of output positions, at most tile_m with
    the padding column, x tile_n channels), conv2's input slice, grid,
    shared memory and w2 ring depth."""
    import ctypes
    keys = ("tt", "fw", "tile_m", "tile_n", "slice", "grid", "threads",
            "smem_bytes", "w2_stages", "h1_stage_bytes", "tiles",
            "window_positions")
    vals = (ctypes.c_int * len(keys))()
    _build.check(_build.lib().cassnat_fused_frontend_plan(b, t, f, c, vals),
                 "fused_frontend_plan")
    return dict(zip(keys, vals))


def fused_conv_frontend(x, w1, b1, w2, b2):
    """relu(conv2(relu(conv1(x)))) for the 3x3/s2/p1 frontend, fused."""
    if x.device.type == "cpu":
        return fused_conv_frontend_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_frontend: unsupported device {x.device}")
    global launches
    bsz, t, f = x.shape
    c = w2.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv_frontend: x must be f32 or bf16, "
                        f"got {x.dtype}")
    if x.dtype == torch.bfloat16 and c % 8:
        raise ValueError(f"fused_conv_frontend: bf16 needs C % 8 == 0, "
                         f"got C={c}")
    if w1.shape != (c, 1, 3, 3) or w2.shape != (c, c, 3, 3) \
            or b1.shape != (c,) or b2.shape != (c,):
        raise ValueError("fused_conv_frontend: expected OIHW 3x3 weights "
                         f"w1 (C,1,3,3), w2 (C,C,3,3); got {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}")
    if any(p.device != x.device for p in (w1, b1, w2, b2)):
        raise ValueError("fused_conv_frontend: tensors on different devices")
    x = x.contiguous()
    # kernel layouts: w1 (9, C) f32 tap-major; w2 by pack_w2
    w1k = w1.reshape(c, 9).t().float().contiguous()
    w2k = pack_w2(w2, x.dtype)
    b1k, b2k = b1.float().contiguous(), b2.float().contiguous()
    t4, f4 = _out_len(_out_len(t)), _out_len(_out_len(f))
    out = torch.empty((bsz, t4, f4, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _build.lib().cassnat_fused_conv_frontend(
        x.data_ptr(), w1k.data_ptr(), b1k.data_ptr(), w2k.data_ptr(),
        b2k.data_ptr(), out.data_ptr(), bsz, t, f, c, _DTYPES[x.dtype],
        _build.stream_ptr(x.device))
    _build.check(err, "fused_conv_frontend")
    launches += 1
    return out
