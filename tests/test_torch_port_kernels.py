"""PyTorch port: the two kernels' plain versions against the JAX kernels.

The JAX side runs the Pallas kernels in interpret mode in a clean
subprocess (tests/torch_port_jax_side.py, as tests/test_flash_attention.py
does). The CUDA kernels themselves run only on the card: the tests marked
`cuda` hold them against their plain versions there and skip elsewhere.

Tolerance: atol 1e-4 in f32 on the CPU. Both sides sum in f32 in
different orders (blockwise online softmax vs one softmax; 9 GEMM taps vs
XLA's convolution), which moves values by ~1e-6; 1e-4 leaves room without
hiding a wrong mask, scale or tap.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_jax_side import run_jax_side

from cassnat_asr_public_tpu_torch.kernels import flash_attention as fa
from cassnat_asr_public_tpu_torch.kernels import fused_frontend as ff

ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return run_jax_side("kernels", tmp_path_factory.mktemp("jax_kernels"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flash_inputs(store, case):
    t = lambda n: torch.from_numpy(store[f"{case}/in/{n}"])
    bias = t("bias") if f"{case}/in/bias" in store else None
    return t("q"), t("k"), t("v"), t("mask"), bias


@pytest.mark.parametrize("case", ["flash_masked", "flash_ragged",
                                  "flash_bias", "flash_bf16"])
def test_flash_attention_plain_matches_jax_kernel(jax_out, case):
    """f32 cases at ATOL; flash_bf16 runs both sides on the same bf16
    inputs: each sums in f32 and rounds the output to bf16, so they may
    differ by a rounding step, held to 2 bf16 ulps of the output's scale."""
    q, k, v, mask, bias = _flash_inputs(jax_out, case)
    want = jax_out[f"{case}/out/kernel"]
    atol = ATOL
    if case == "flash_bf16":
        q, k, v = (x.bfloat16() for x in (q, k, v))
        atol = 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    got = fa.flash_attention_plain(q, k, v, mask, bias)
    assert got.dtype == q.dtype
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if bias is None:
        np.testing.assert_allclose(got, jax_out[f"{case}/out/reference"],
                                   atol=atol, rtol=0)
    # query row 5 has every key masked: the kernel's semantics give zeros
    assert np.abs(got[:, :, 5]).max() == 0.0
    assert np.abs(jax_out[f"{case}/out/kernel"][:, :, 5]).max() == 0.0


def test_flash_attention_wrapper_takes_plain_on_cpu(jax_out):
    q, k, v, mask, _ = _flash_inputs(jax_out, "flash_masked")
    before = fa.launches
    got = fa.flash_attention(q, k, v, mask)
    assert fa.launches == before
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, mask))


def _frontend_inputs(store, f_dim):
    """JAX HWIO weights -> the port's OIHW."""
    g = lambda n: torch.from_numpy(store[f"frontend_f{f_dim}/in/{n}"])
    return (g("x"), g("w1").permute(3, 2, 0, 1), g("b1"),
            g("w2").permute(3, 2, 0, 1), g("b2"))


@pytest.mark.parametrize("f_dim", [80, 240])
def test_fused_frontend_plain_matches_jax_kernel(jax_out, f_dim):
    got = ff.fused_conv_frontend_plain(*_frontend_inputs(jax_out, f_dim))
    want = jax_out[f"frontend_f{f_dim}/out/kernel"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t,f", [(37, 80), (40, 18), (9, 6)])
def test_fused_frontend_plain_matches_conv2d(t, f):
    """Odd lengths and widths against two F.conv2d calls (f32, CPU)."""
    rng = np.random.default_rng(t)
    c = 12
    x = torch.from_numpy(rng.standard_normal((2, t, f)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((c, 1, 3, 3))
                          .astype(np.float32) * 0.3)
    w2 = torch.from_numpy(rng.standard_normal((c, c, 3, 3))
                          .astype(np.float32) * 0.1)
    b1, b2 = torch.randn(c) * 0.1, torch.randn(c) * 0.1
    want = F.relu(F.conv2d(F.relu(F.conv2d(x[:, None], w1, b1, 2, 1)),
                           w2, b2, 2, 1)).permute(0, 2, 3, 1)
    before = ff.launches
    got = ff.fused_conv_frontend(x, w1, b1, w2, b2)
    assert ff.launches == before
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def _trigger_mask(g, b, tq, tk):
    """Trigger-style masks: query u of utterance i sees a window of frames
    around its trigger; queries past the utterance's token count (and
    query 5) see nothing, keys past its frame count are masked."""
    frames = torch.randint(tk // 2, tk + 1, (b,), generator=g)
    frames[0] = tk
    tokens = torch.clamp(frames // 4, max=tq - 1)
    q = torch.arange(tq)[None, :, None]
    kk = torch.arange(tk)[None, None, :]
    trig = q * frames[:, None, None] // torch.clamp(tokens, min=1)[
        :, None, None]
    mask = (kk >= trig - 6) & (kk < trig + 6) \
        & (kk < frames[:, None, None]) & (q < tokens[:, None, None])
    mask[:, 5] = False
    return mask


# (b, h, tq, tk, d, mask kind, bias, layout); layout "proj" slices q, k, v
# from a (B, T, H*D) projection as MultiHeadedAttention does, so the bf16
# heads start 72 bytes apart; D = 34 and 35 make 4- and 2-byte aligned bf16
# rows. Mask rows of Tk = 80, 184 and 44 bytes take 16-, 8- and 4-byte
# copies, odd Tk and the stride-0 key mask byte loads.
FLASH_CASES = {
    "path": (32, 8, 160, 184, 64, "trigger", False, "bhtd"),
    "ragged": (3, 2, 77, 101, 64, "random", False, "bhtd"),
    "d16": (2, 3, 40, 80, 16, "random", False, "bhtd"),
    "d36": (2, 4, 70, 99, 36, "random", False, "bhtd"),
    "d128": (2, 2, 65, 130, 128, "random", False, "bhtd"),
    "first_key_tile_masked": (2, 2, 100, 150, 64, "first_tile", False,
                              "bhtd"),
    "key_mask": (3, 2, 70, 90, 64, "keys", False, "bhtd"),
    "bias": (2, 3, 45, 77, 64, "random", True, "bhtd"),
    "proj_d36": (3, 4, 37, 99, 36, "trigger", False, "proj"),
    "d34": (2, 2, 30, 44, 34, "random", False, "bhtd"),
    "d35": (2, 2, 30, 41, 35, "random", True, "bhtd"),
    # the f32 test's earlier inputs: D = 64 with and without the bias
    "random": (3, 4, 70, 90, 64, "random", False, "bhtd"),
    "random_bias": (3, 4, 70, 90, 64, "random", True, "bhtd"),
}
# f32 runs on CUDA cores, bf16 on tensor cores (P rounded to bf16 for the
# PV product: ~2^-9 relative on each weight)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_kernel_matches_plain_on_card(cuda, dtype, case):
    """The kernel of q's dtype against the plain version within FLASH_TOL
    absolute; fully-masked rows exactly 0; one launch per call."""
    b, h, tq, tk, d, kind, with_bias, layout = FLASH_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(tq * tk + d)
    if layout == "proj":
        def heads(n):
            x = torch.randn(b, n, h * d, generator=g).to(cuda, dtype)
            return x.view(b, n, h, d).transpose(1, 2)
        q, k, v = heads(tq), heads(tk), heads(tk)
        if dtype == torch.bfloat16:
            assert q.data_ptr() % 16 == 0 and q[:, 1].data_ptr() % 16 == 8
    else:
        q, k, v = (torch.randn(b, h, n, d, generator=g).to(cuda, dtype)
                   for n in (tq, tk, tk))
    if kind == "trigger":
        mask = _trigger_mask(g, b, tq, tk)
    elif kind == "keys":
        lens = torch.randint(1, tk + 1, (b,), generator=g)
        lens[0] = 0  # every row of utterance 0 fully masked
        mask = (torch.arange(tk)[None, None, :] < lens[:, None, None]) \
            .to(cuda).expand(b, tq, tk)
        assert mask.stride(1) == 0
    else:
        mask = torch.rand(b, tq, tk, generator=g) > 0.3
        mask[:, 5] = False
        if kind == "first_tile":
            mask[:, :64, :64] = False
    mask = mask.to(cuda)
    bias = torch.randn(b, h, tq, tk, generator=g).to(cuda) \
        if with_bias else None
    before = fa.launches
    got = fa.flash_attention(q, k, v, mask, bias)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, mask, bias)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err < FLASH_TOL[dtype], err
    dead = ~mask.any(-1)
    assert dead.any()
    assert got.float()[dead[:, None].expand(b, h, tq)].abs().max() == 0.0


def _tiled_emulation(x, w1, b1, w2, b2, tt, fw, tile_m=128):
    """The bf16 kernel's indexing in plain PyTorch (f32 sums), for tiles of
    TT rows x FW columns of output positions: M row m of a tile (tile_m
    rows) is output (m // HWp, m % HWp), HWp = FW + 1, conv1's window
    positions go into the four (row parity, column parity) planes at the
    kernel's offsets, every tap of M row m reads plane (dt % 2, df % 2) at
    position m + (dt // 2) HWp + df // 2, and w2 is read through
    `ff.pack_w2`'s (9, Cout, Cin) layout. h1 is rounded to x.dtype as the
    kernel rounds it; only rows with m % HWp < FW inside (T4, F4) are
    written."""
    bsz, t, f = x.shape
    c = w2.shape[0]
    hwp = fw + 1
    assert tt * hwp <= tile_m
    h1 = F.relu(F.conv2d(x.float()[:, None], w1.float(), b1.float(), 2, 1))
    h1 = h1.to(x.dtype).float().permute(0, 2, 3, 1)  # (B, T2, F2, C)
    t2_n, f2_n = h1.shape[1:3]
    t4_n, f4_n = (t2_n + 1) // 2, (f2_n + 1) // 2
    w2p = ff.pack_w2(w2, torch.bfloat16).float()  # (9, Cout, Cin)
    n_pos = (2 * tt + 1) * 2 * hwp
    pitch = max((tt + 1) * hwp, tile_m + hwp + 1)
    m = torch.arange(tile_m)
    out = torch.zeros(bsz, t4_n, f4_n, c)
    for b in range(bsz):
        for t4_0 in range(0, t4_n, tt):
            for f4_0 in range(0, f4_n, fw):
                planes = torch.zeros(4, pitch, c)
                for i in range(n_pos):
                    rp, half = divmod(i, hwp)
                    r, par = divmod(rp, 2)
                    col = 2 * half + par
                    t2, f2 = 2 * t4_0 - 1 + r, 2 * f4_0 - 1 + col
                    if col <= 2 * fw and 0 <= t2 < t2_n and 0 <= f2 < f2_n:
                        planes[(r % 2) * 2 + par,
                               (r // 2) * hwp + half] = h1[b, t2, f2]
                acc = torch.zeros(tile_m, c)
                for tap in range(9):
                    dt, df = divmod(tap, 3)
                    rows = m + (dt // 2) * hwp + df // 2
                    acc += planes[(dt % 2) * 2 + df % 2][rows] @ w2p[tap].t()
                res = torch.relu(acc + b2.float()).to(x.dtype).float()
                for mm in range(tt * hwp):
                    ti, fi = divmod(mm, hwp)
                    if fi < fw and t4_0 + ti < t4_n and f4_0 + fi < f4_n:
                        out[b, t4_0 + ti, f4_0 + fi] = res[mm]
    return out.to(x.dtype)


# (c, t, tt, fw): F = 80 gives F4 = 20. (6, 20) is the kernel's own tile
# there (one column tile, TT = 128 // 21); (4, 7) splits both T4 and F4
# into ragged tiles (3 x 3 at T = 37).
@pytest.mark.parametrize("c,t,tt,fw", [(16, 37, 4, 7), (144, 21, 6, 20)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 1.6e-2)],
                         ids=["f32", "bf16"])
def test_fused_frontend_tiling_matches_plain(c, t, tt, fw, dtype, atol):
    """The bf16 kernel's w2 packing, tap order and shifted-row reads,
    emulated on the CPU, equal the plain version at F = 80 (the synth
    checkpoint's width) and odd T. w2 is bf16-exact so that the f32 case
    checks the indexing alone (atol 1e-4: order of f32 sums); in bf16 the
    two round h1 and the output at the same places, and a sum on the
    other side of a rounding boundary moves an output by one bf16 ulp
    (2^-7 at magnitudes below 4)."""
    rng = np.random.default_rng(c + t)
    x = torch.from_numpy(rng.standard_normal((2, t, 80)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((c, 1, 3, 3))
                          .astype(np.float32) * 0.3)
    w2 = torch.from_numpy(rng.standard_normal((c, c, 3, 3)).astype(
        np.float32) / (3 * c ** 0.5)).to(torch.bfloat16).float()
    b1 = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)
    b2 = torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1)
    x, w2d = x.to(dtype), w2.to(dtype)
    want = ff.fused_conv_frontend_plain(x, w1, b1, w2d, b2)
    got = _tiled_emulation(x, w1, b1, w2d, b2, tt, fw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=0)


# (b, t, f, c): x and w2 in the dtype, conv1 and the biases in f32, as the
# model passes them. C = 20 runs only in f32 (bf16 needs C % 8 == 0);
# F = 1028 makes F4 = 257 columns, tiled five times. bf16 adds the path
# geometry at B = 2, T4 = 25 and 3 (not multiples of the 2-row time tile),
# C = 136 (a partial K slice and N tile) and the synth checkpoint's C = 144,
# F = 80 (already in the common shapes).
FRONTEND_SHAPES = [(2, 101, 80, 144), (2, 64, 240, 512), (1, 9, 6, 24),
                   (1, 13, 1028, 16)]
FRONTEND_CASES = (
    [(torch.float32, s) for s in FRONTEND_SHAPES + [(1, 9, 6, 20)]]
    + [(torch.bfloat16, s) for s in FRONTEND_SHAPES
       + [(2, 736, 240, 512), (2, 99, 240, 512), (2, 37, 80, 136),
          (1, 9, 240, 512)]])
FRONTEND_TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,shape", FRONTEND_CASES,
    ids=[f"{str(d)[6:]}-{'x'.join(map(str, s))}" for d, s in FRONTEND_CASES])
def test_fused_frontend_kernel_matches_plain_on_card(cuda, dtype, shape):
    """The kernel against its plain version on the same inputs, max abs
    error under 1e-4 in f32 (order of sums) and 6e-2 in bf16 (h1 and the
    output rounded to bf16 at the same places; a sum on the other side of
    a rounding boundary moves an h1 value by one ulp)."""
    b, t, f, c = shape
    g = torch.Generator(device="cpu").manual_seed(t * 1000 + c)
    x = torch.randn(b, t, f, generator=g).to(cuda, dtype)
    w1 = (torch.randn(c, 1, 3, 3, generator=g) * 0.3).to(cuda)
    w2 = (torch.randn(c, c, 3, 3, generator=g) / (3 * c ** 0.5)).to(
        cuda, dtype)
    b1 = (torch.randn(c, generator=g) * 0.1).to(cuda)
    b2 = (torch.randn(c, generator=g) * 0.1).to(cuda)
    before = ff.launches
    got = ff.fused_conv_frontend(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert ff.launches == before + 1
    want = ff.fused_conv_frontend_plain(x, w1, b1, w2, b2)
    assert got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err < FRONTEND_TOL[dtype], (shape, err)


@pytest.mark.cuda
def test_fused_frontend_bf16_rejects_c_not_multiple_of_8(cuda):
    x = torch.zeros(1, 9, 8, device=cuda, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(20, 1, 3, 3), torch.zeros(20, 20, 3, 3)
    b = torch.zeros(20)
    before = ff.launches
    with pytest.raises(ValueError, match="C % 8"):
        ff.fused_conv_frontend(x, w1.to(cuda), b.to(cuda),
                               w2.to(cuda, torch.bfloat16), b.to(cuda))
    assert ff.launches == before


def _random_layer(dev, d, h, f, k, seed):
    """A ConEncoderLayer with seeded random parameters."""
    from cassnat_asr_public_tpu_torch.nn.blocks import ConEncoderLayer
    rng = np.random.default_rng(seed)
    layer = ConEncoderLayer(d, h, f, k, device="cpu")
    with torch.no_grad():
        for name, p in layer.named_parameters():
            base = 1.0 if name.endswith("norm.weight") else 0.0
            scale = 0.05 if p.dim() == 1 or "pos_bias" in name else \
                1.0 / np.sqrt(np.prod(p.shape[1:]))
            p.copy_(torch.from_numpy(
                base + scale * rng.standard_normal(p.shape)).float())
    return layer.to(dev).eval()


# (b, t, d, h, f, k, r, lengths): row 1 has length 0 (fully-masked
# attention rows) unless the lengths say otherwise; tq = 16 and 64 divide
# none of the T. M = B T is ragged against the 128-row product tiles in
# every case (B = 2, T = 184 is the path's T' at B = 2). At T = 600 (a
# ~24 s utterance) the bf16 attention item no longer holds a head's whole
# K/V row in shared memory and takes it in chunks; at B = 20 the
# depthwise tiles of a block (13 of 64 x 64) no longer stay in shared
# memory and GroupNorm reads them back from scratch.
CONFORMER_CASES = {
    "cpu_widths": (3, 40, 64, 4, 128, 7, 8, None),
    "synth_widths_d36": (3, 53, 144, 4, 288, 15, 16, None),
    "librispeech_widths": (2, 70, 512, 8, 1024, 31, 20, None),
    "path_widths_t184": (2, 184, 512, 8, 1024, 31, 20, None),
    "all_rows_length_0": (2, 24, 64, 4, 128, 7, 8, (0, 0)),
    "long_t600_kv_chunks": (2, 600, 512, 8, 1024, 31, 20, None),
    "b20_t600_groupnorm_uncached": (20, 600, 512, 8, 1024, 31, 20, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONFORMER_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conformer_layer_kernels_match_plain_on_card(cuda, dtype, case):
    """Each of the four kernels against its plain version on the same
    inputs, max abs error within 1e-4 x max(1, scale) in f32 (order of
    sums) and 2e-2 x scale in bf16 (both round at the same places; a sum
    on the other side of a rounding boundary moves an intermediate by one
    bf16 ulp, which carries through the layer); one launch per call."""
    from cassnat_asr_public_tpu_torch.kernels import conformer_layer as cl
    from cassnat_asr_public_tpu_torch.nn.modules import \
        sinusoidal_position_encoding
    b, t, d, h, f, k, r, lengths = CONFORMER_CASES[case]
    layer = _random_layer(cuda, d, h, f, k, seed=t)
    g = torch.Generator(device="cpu").manual_seed(t)
    x = torch.randn(b, t, d, generator=g).to(cuda, dtype)
    lens = torch.tensor(lengths if lengths is not None
                        else [t, 0] + [t - 13] * (b - 2))
    maskf = (torch.arange(t)[None, :] < lens[:, None]).float().to(cuda)
    rr = min(r, t - 1)
    table = torch.from_numpy(sinusoidal_position_encoding(2 * r + 1, d)[
        r - rr:r + rr + 1]).to(cuda, dtype)
    pk = layer.packed(dtype)
    pos = pk.position(table)

    def close(name, got, want):
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), name
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 \
            else 2e-2 * scale
        assert err <= tol, (name, err, scale)

    before = dict(cl.launches)
    close("half_a", cl.half_a(pk, x, maskf, pos),
          cl.half_a_plain(pk, x, maskf, pos))
    close("half_b", cl.half_b(pk, x), cl.half_b_plain(pk, x))
    got = cl.half_a_kv(pk, x)
    want = cl.half_a_kv_plain(pk, x)
    for name, gg, ww in zip(("x1", "ln", "k", "v"), got, want):
        close(f"half_a_kv {name}", gg, ww)
    for tq in (16, 64):
        close(f"half_a_qblock tq={tq}",
              cl.half_a_qblock(pk, *want, maskf, pos, tq),
              cl.half_a_qblock_plain(pk, *want, maskf, pos, tq))
    assert {n: cl.launches[n] - before[n] for n in before} == {
        "half_a": 1, "half_b": 1, "half_a_kv": 1, "half_a_qblock": 2}


def _tc_product(a, w_nk, bn):
    """The bf16 route's product tiling: 128 x bn output tiles, 64-deep
    slices zero filled past M, N and K (TMA's out-of-bounds fill), f32
    sums; w_nk is the (N, K) K-major weight of `cl.pack_kmajor`."""
    m, depth = a.shape
    n = w_nk.shape[0]
    out = torch.full((m, n), float("nan"))
    for m0 in range(0, m, 128):
        for n0 in range(0, n, bn):
            acc = torch.zeros(128, bn)
            for k0 in range(0, depth, 64):
                at, wt = torch.zeros(128, 64), torch.zeros(bn, 64)
                blk = a[m0:m0 + 128, k0:k0 + 64]
                at[:blk.shape[0], :blk.shape[1]] = blk
                blk = w_nk[n0:n0 + bn, k0:k0 + 64]
                wt[:blk.shape[0], :blk.shape[1]] = blk
                acc += at @ wt.t()
            rows, cols = min(128, m - m0), min(bn, n - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out


def _tc_attention(pk, qu, qv, k, v, maskf, pos, cd):
    """The bf16 route's attention items: (batch, head, 192 queries), 16
    query rows a warp, keys in 64-key steps; small = (q+v) pos^T, scores
    + small[clamp(key - q, -r, r) + r], masked -> -1e9, keys past T left
    out; pass 1 the row max and sum of exp (online over the steps), pass 2
    the weights exp(s - max) / max(sum, 1e-30) rounded to cd, times V."""
    b, t, d = qu.shape
    h = pk.n_head
    dk = d // h
    r = (pos.shape[0] - 1) // 2
    inv = 1.0 / np.sqrt(dk)
    ctx = torch.zeros(b, t, d)
    for bi in range(b):
        for hi in range(h):
            cols = slice(hi * dk, hi * dk + dk)
            kh, vh = k[bi, :, cols], v[bi, :, cols]
            for q0 in range(0, t, 16):      # one warp's rows of an item
                qi = torch.arange(q0, min(q0 + 16, t))
                small = qv[bi, qi][:, cols] @ pos[:, cols].t()
                m_run = torch.full((len(qi),), -float("inf"))
                l_run = torch.zeros(len(qi))
                steps = []
                for k0 in range(0, t, 64):
                    key = torch.arange(k0, min(k0 + 64, t))
                    s = qu[bi, qi][:, cols] @ kh[key].t() * inv
                    off = (key[None, :] - qi[:, None]).clamp(-r, r) + r
                    s = s + torch.gather(small, 1, off) * inv
                    ok = (maskf[bi, key] > 0.5)[None, :].expand_as(s)
                    s = torch.where(ok, s, -1e9)
                    m_new = torch.maximum(m_run, s.amax(1))
                    corr = torch.where(m_run == m_new, 1.0,
                                       torch.exp(m_run - m_new))
                    l_run = l_run * corr + torch.where(
                        ok, torch.exp(s - m_new[:, None]), 0.0).sum(1)
                    m_run = m_new
                    steps.append((key, s, ok))
                den = l_run.clamp_min(1e-30)
                o = torch.zeros(len(qi), dk)
                for key, s, ok in steps:
                    w = torch.where(ok, torch.exp(s - m_run[:, None]), 0.0)
                    o += (w / den[:, None]).to(cd).float() @ vh[key]
                ctx[bi, qi, cols] = o
    return ctx


def _tc_half_a(pk, w, x, maskf, pos, bn):
    from cassnat_asr_public_tpu_torch.kernels import conformer_layer as cl
    cd, d = pk.compute_dtype, pk.d
    b, t, _ = x.shape
    m = b * t
    rd = lambda z: z.to(cd).float()
    x32 = x.float().reshape(m, d)
    hh = rd(cl.layernorm(x32, pk.norms[0], pk.norms[1]))
    y = _tc_product(hh, w["w1a"], bn) + pk.b1a
    mm = rd(y * torch.sigmoid(y))
    x1 = x32 + 0.5 * (_tc_product(mm, w["w2a"], bn) + pk.b2a)
    ln = rd(cl.layernorm(x1, pk.norms[2], pk.norms[3]))
    y = _tc_product(ln, w["wqkv"], bn) + pk.bqkv
    # the epilogue's split of column pairs (col, col + 1): segment col // D
    qu, qv, k, v = (torch.full((m, d), float("nan")) for _ in range(4))
    for col in range(0, 3 * d, 2):
        seg, c = divmod(col, d)
        pair = y[:, col:col + 2]
        if seg == 0:
            qu[:, c:c + 2] = rd(pair + pk.ubias[0, c:c + 2])
            qv[:, c:c + 2] = rd(pair + pk.ubias[1, c:c + 2])
        else:
            (k if seg == 1 else v)[:, c:c + 2] = rd(pair)
    heads = lambda z: z.reshape(b, t, d)
    ctx = rd(_tc_attention(pk, heads(qu), heads(qv), heads(k), heads(v),
                           maskf, pos.float(), cd).reshape(m, d))
    out = x1 + (_tc_product(ctx, w["wo"], bn) + pk.bo)
    return out.reshape(b, t, d).to(cd)


def _tc_half_b(pk, w, x, bn):
    from cassnat_asr_public_tpu_torch.kernels import conformer_layer as cl
    cd, d, kk = pk.compute_dtype, pk.d, pk.kernel_size
    b, t, _ = x.shape
    m = b * t
    rd = lambda z: z.to(cd).float()
    x32 = x.float().reshape(m, d)
    hh = rd(cl.layernorm(x32, pk.norms[4], pk.norms[5]))
    pw = (_tc_product(hh, w["pw1"], bn) + pk.pw1b).reshape(b, t, 2 * d)
    g = pw[..., :d] * torch.sigmoid(pw[..., d:])
    gpad = F.pad(g, (0, 0, (kk - 1) // 2, kk // 2))
    acc = sum(gpad[:, j:j + t] * pk.dw[j] for j in range(kk)) + pk.dwb
    mean = acc.mean((1, 2), keepdim=True)
    var = ((acc - mean) ** 2).mean((1, 2), keepdim=True)
    gn = (acc - mean) * torch.rsqrt(var + 1e-5) * pk.norms[8] + pk.norms[9]
    gs = rd(gn * torch.sigmoid(gn)).reshape(m, d)
    x2 = x32 + (_tc_product(gs, w["pw2"], bn) + pk.pw2b)
    h2 = rd(cl.layernorm(x2, pk.norms[6], pk.norms[7]))
    y = _tc_product(h2, w["w1b"], bn) + pk.b1b
    m2 = rd(y * torch.sigmoid(y))
    out = x2 + 0.5 * (_tc_product(m2, w["w2b"], bn) + pk.b2b)
    return out.reshape(b, t, d).to(cd)


# the two tile widths the .cu chooses between (choose_bn). D = 72 gives a
# partial 64-deep K slice (64 + 8) and partial column tiles at both;
# B T = 140 rows, a full and a partial 128-row tile; dk = 18.
@pytest.mark.parametrize("bn", [128, 192])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_conformer_tc_tiling_matches_plain(bn, dtype, atol):
    """The bf16 halves' index math, emulated on the CPU, equals
    half_a_plain / half_b_plain: the per-product tiling with partial tiles
    and zero-filled slices, `pack_kmajor`'s (N, K) weights, the epilogue's
    q|k|v and u/v split by column pairs, and the attention items' 16-row
    query tiles, 64-key steps and Toeplitz offsets, with a length-0 row.
    f32 at atol 1e-4 (order of sums); bf16 at 2e-2 of the output's scale
    (the same rounding points; a sum on the other side of a rounding
    boundary moves an intermediate by one bf16 ulp)."""
    from cassnat_asr_public_tpu_torch.kernels import conformer_layer as cl
    from cassnat_asr_public_tpu_torch.nn.modules import \
        sinusoidal_position_encoding
    b, t, d, h, f, k, r = 2, 70, 72, 4, 136, 7, 8
    layer = _random_layer("cpu", d, h, f, k, seed=5)
    pk = layer.packed(dtype)
    w = {n: z.float() for n, z in
         cl.pack_kmajor(layer.fused_operands(), dtype).items()}
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
        np.float32)).to(dtype)
    maskf = (torch.arange(t)[None, :] < torch.tensor([t, 0])[:, None]
             ).float()
    pos = pk.position(torch.from_numpy(
        sinusoidal_position_encoding(2 * r + 1, d)).to(dtype))
    for got, want in ((_tc_half_a(pk, w, x, maskf, pos, bn),
                       cl.half_a_plain(pk, x, maskf, pos)),
                      (_tc_half_b(pk, w, x, bn), cl.half_b_plain(pk, x))):
        assert got.dtype == want.dtype and got.shape == want.shape
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol * (1.0 if dtype == torch.float32 else scale), err
