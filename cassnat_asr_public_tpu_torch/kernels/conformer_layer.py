"""Fused conformer encoder layer: CUDA kernels + plain versions.

Replaces cassnat_asr_public_tpu/kernels/conformer_layer.py:
`conformer_layer_fused` :225 (Pallas `_layer_half_a_kernel` :78 and
`_layer_half_b_kernel` :163) and `conformer_layer_fused_qblocked` :411
(`_half_a_kv_kernel` :322, `_half_a_qblock_kernel` :348, then half B).
Inference only. The walk over the encoder's layers (the JAX package's
`fused_encode_ctc` :515) is `CassNAT.encode_ctc(fused=...)` in
models/cassnat.py; this module takes tensors only.

  half A  x + 1/2 FFN(swish), then + relative-position MHA with the u/v
          biases, the clamped Toeplitz bias from the compact (2r+1) table,
          the key mask (fully-masked rows get zero weights) and the output
          projection;
  half B  + conv module (LN, pointwise 1, GLU, SAME depthwise in f32,
          GroupNorm(1) over the whole (T, D) row, padding included, swish,
          pointwise 2), then + 1/2 FFN.

The numerics are the TPU kernels', not ConEncoderLayer's: products take
operands rounded to the compute type (x.dtype) and accumulate in f32;
q+u, q+v, the attention weights and each half's output are rounded to the
compute type, and so are the q-blocked stage-1 outputs x1, ln, k, v.
Norms, biases and the depthwise weights stay f32.

`conformer_layer_fused` / `conformer_layer_fused_qblocked` launch the
kernels of csrc/conformer_layer.cu for CUDA tensors and compute the plain
versions only for CPU tensors; `launches` counts kernel launches by name.
A layer hands its tensors to `pack_layer` by name (nn/blocks.py
`ConEncoderLayer.fused_operands`); they are packed (transposed, cast,
stacked) once per compute type and re-packed whenever one of them is
replaced or changed in place.

On the H100, one layer at B=32, T'=184, D=512 is ~49 GFLOP of products,
bound by arithmetic (~0.05 ms in bf16): the kernels' design, and how the
row-wide attention, depthwise halo and GroupNorm statistics cross the time
tiles, is in the header of csrc/conformer_layer.cu. bf16 half A and half B
run their products on wgmma with both operands by TMA; they read the
products' weights packed (N, K), K-major as the wgmma B descriptor reads
them (`LayerPack.kmajor`, by `pack_kmajor`), and the .cu chooses each
product's tile width (`plan` reports it). The f32 kernels and the bf16
q-blocked pair read (K, N).
"""

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from cassnat_asr_public_tpu_torch.kernels import _build

MASK_MIN = -1e9
SMEM_LIMIT = 232448        # bytes of shared memory one block may use
MAX_DK = 128
MAX_KERNEL = 65
PTR_NAMES = ("x", "maskf", "norms", "w1a", "b1a", "w2a", "b2a", "wqkv",
             "bqkv", "wo", "bo", "pos", "ubias", "w1b", "b1b", "w2b", "b2b",
             "pw1", "pw1b", "dw", "dwb", "pw2", "pw2b", "x1", "ln", "k", "v",
             "out", "scratch")
_KINDS = {"half_a": 0, "half_b": 1, "half_a_kv": 2, "half_a_qblock": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = dict.fromkeys(_KINDS, 0)
# bf16 half A / half B products in phase order, by weight slot
PRODUCTS = {"half_a": ("w1a", "w2a", "wqkv", "wo"),
            "half_b": ("pw1", "pw2", "w1b", "w2b")}


def layernorm(x32, scale, bias):
    """scale * (x - mean) / (sqrt(var_bessel + 1e-12) + 1e-6) + bias, in
    f32 (JAX :50)."""
    d = x32.shape[-1]
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True) * (d / max(d - 1, 1))
    std = torch.sqrt(var + 1e-12)
    return scale.float() * (x32 - mean) / (std + 1e-6) + bias.float()


def _mm(a32, w, b, cd):
    """Product with operands rounded to `cd` and f32 accumulation, + an f32
    bias (JAX `_mm` :66)."""
    out = torch.matmul(a32.to(cd).float(), w.float())
    return out if b is None else out + b


def _swish(x):
    return x * torch.sigmoid(x)


# ------------------------------------------------------------------ packing

class LayerPack:
    """A conformer layer's operands as the kernels take them: products'
    weights (in, out) in the compute type, norms (10, D), biases, u/v and the
    depthwise weights (K, D) in f32.

    `ops` maps the names of `ConEncoderLayer.fused_operands` to tensors in
    PyTorch's layouts: Linear weights (out, in), Conv1d weights (out, in/g,
    K); "norms" lists the scales and biases of the ff1, attention, conv and
    ff2 sublayer norms, then the conv module's GroupNorm."""

    def __init__(self, ops, n_head, cd):
        f32 = lambda t: t.detach().float().contiguous()
        w = lambda t: t.detach().t().to(cd).contiguous()
        pw = lambda t: t.detach()[:, :, 0].t().to(cd).contiguous()
        self.compute_dtype = cd
        self.n_head = n_head
        self.d = ops["wq"].shape[0]
        self.f = ops["ff1_w1"].shape[0]
        self.kernel_size = ops["dw"].shape[-1]
        self.device = ops["wq"].device
        self.norms = torch.stack([f32(t) for t in ops["norms"]])
        self.w1a, self.b1a = w(ops["ff1_w1"]), f32(ops["ff1_b1"])
        self.w2a, self.b2a = w(ops["ff1_w2"]), f32(ops["ff1_b2"])
        self.wqkv = torch.cat([w(ops["wq"]), w(ops["wk"]), w(ops["wv"])],
                              1).contiguous()
        self.bqkv = torch.cat([f32(ops["bq"]), f32(ops["bk"]),
                               f32(ops["bv"])])
        self.wo, self.bo = w(ops["wo"]), f32(ops["bo"])
        # the position projection is a plain product outside the kernels
        self.wpos = w(ops["wpos"]).float()
        self.ubias = torch.stack([f32(ops["pos_bias_u"]).reshape(-1),
                                  f32(ops["pos_bias_v"]).reshape(-1)])
        self.w1b, self.b1b = w(ops["ff2_w1"]), f32(ops["ff2_b1"])
        self.w2b, self.b2b = w(ops["ff2_w2"]), f32(ops["ff2_b2"])
        self.pw1, self.pw1b = pw(ops["pw1"]), f32(ops["pw1_b"])
        self.dw = f32(ops["dw"][:, 0, :].t())
        self.dwb = f32(ops["dw_b"])
        self.pw2, self.pw2b = pw(ops["pw2"]), f32(ops["pw2_b"])
        # the bf16 halves' products read their weights (N, K)
        self.kmajor = pack_kmajor(ops, cd) if cd == torch.bfloat16 else {}

    def position(self, pos_table):
        """p = pos_table @ W_pos in f32 from operands rounded to the compute
        type, rounded to it (JAX :249)."""
        cd = self.compute_dtype
        return torch.matmul(pos_table.to(cd).float(), self.wpos).to(cd)


def pack_kmajor(ops, cd):
    """The products' weights (N, K) in `cd`, K-major: the layout the wgmma
    B descriptor of the bf16 half A / half B kernels reads (PyTorch's own
    Linear and pointwise-Conv1d layout), by pointer slot."""
    nk = lambda t: t.detach().to(cd).contiguous()
    pw = lambda t: t.detach()[:, :, 0].to(cd).contiguous()
    return {"w1a": nk(ops["ff1_w1"]), "w2a": nk(ops["ff1_w2"]),
            "wqkv": nk(torch.cat([ops["wq"], ops["wk"], ops["wv"]], 0)),
            "wo": nk(ops["wo"]), "w1b": nk(ops["ff2_w1"]),
            "w2b": nk(ops["ff2_w2"]), "pw1": pw(ops["pw1"]),
            "pw2": pw(ops["pw2"])}


def _flat_tensors(ops):
    for v in ops.values():
        yield from (v if isinstance(v, (list, tuple)) else (v,))


@torch.no_grad()
def pack_layer(ops, n_head, cd, cache) -> LayerPack:
    """The operands `ops` packed for compute type `cd`, kept in `cache` (a
    dict the layer owns): built once and rebuilt when any tensor is
    replaced, moved or changed in place (every in-place write bumps a
    tensor's version counter)."""
    key = (cd, n_head) + tuple((id(t), t.data_ptr(), t._version)
                               for t in _flat_tensors(ops))
    hit = cache.get(cd)
    if hit is None or hit[0] != key:
        hit = (key, LayerPack(ops, n_head, cd))
        cache[cd] = hit
    return hit[1]


# ------------------------------------------------------------ plain versions

def _attend(pk, q, k, v, maskf, pos):
    """Relative-position attention of the TPU kernels on (B, T, D) f32 q and
    compute-type k, v; returns the f32 context (B, T, D)."""
    cd = pk.compute_dtype
    b, t, d = q.shape
    h = pk.n_head
    dk = d // h
    heads = lambda z: z.to(cd).float().reshape(b, t, h, dk)
    qu, qv = heads(q + pk.ubias[0]), heads(q + pk.ubias[1])
    kh, vh = heads(k), heads(v)
    ph = pos.to(cd).float().view(-1, h, dk)
    r = (pos.shape[0] - 1) // 2
    inv = 1.0 / math.sqrt(dk)
    scores = torch.einsum("bqhd,bkhd->bhqk", qu, kh) * inv
    small = torch.einsum("bqhd,phd->bhqp", qv, ph) * inv
    ar = torch.arange(t, device=q.device)
    off = (ar[None, :] - ar[:, None]).clamp(-r, r) + r
    scores = scores + torch.gather(small, 3, off.expand(b, h, t, t))
    kmask = (maskf > 0.5)[:, None, None, :]
    scores = torch.where(kmask, scores, MASK_MIN)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    e = torch.where(kmask, e, 0.0)
    w = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(cd).float(), vh)
    return ctx.reshape(b, t, d)


def _ffn(pk, x32, norm0, w1, b1, w2, b2):
    cd = pk.compute_dtype
    hln = layernorm(x32, pk.norms[norm0], pk.norms[norm0 + 1])
    return x32 + 0.5 * _mm(_swish(_mm(hln, w1, b1, cd)), w2, b2, cd)


def half_a_plain(pk, x, maskf, pos):
    """Half A in plain PyTorch: x (B, T, D) in the compute type, maskf
    (B, T) f32, pos = pk.position(pos_table)."""
    cd, d = pk.compute_dtype, pk.d
    x32 = _ffn(pk, x.float(), 0, pk.w1a, pk.b1a, pk.w2a, pk.b2a)
    hln = layernorm(x32, pk.norms[2], pk.norms[3])
    q, k, v = _mm(hln, pk.wqkv, pk.bqkv, cd).split(d, -1)
    ctx = _attend(pk, q, k, v, maskf, pos)
    return (x32 + _mm(ctx, pk.wo, pk.bo, cd)).to(cd)


def half_b_plain(pk, x):
    """Half B in plain PyTorch: x (B, T, D) in the compute type."""
    cd, d, kk = pk.compute_dtype, pk.d, pk.kernel_size
    x32 = x.float()
    t = x32.shape[1]
    hln = layernorm(x32, pk.norms[4], pk.norms[5])
    pw = _mm(hln, pk.pw1, pk.pw1b, cd)
    g = pw[..., :d] * torch.sigmoid(pw[..., d:])
    gpad = F.pad(g, (0, 0, (kk - 1) // 2, kk // 2))
    acc = torch.zeros_like(g)
    for j in range(kk):
        acc = acc + gpad[:, j:j + t] * pk.dw[j]
    acc = acc + pk.dwb
    gmean = acc.mean((1, 2), keepdim=True)
    gvar = ((acc - gmean) ** 2).mean((1, 2), keepdim=True)
    gn = (acc - gmean) * torch.rsqrt(gvar + 1e-5)
    gn = _swish(gn * pk.norms[8] + pk.norms[9])
    x32 = x32 + _mm(gn, pk.pw2, pk.pw2b, cd)
    return _ffn(pk, x32, 6, pk.w1b, pk.b1b, pk.w2b, pk.b2b).to(cd)


def half_a_kv_plain(pk, x):
    """Q-blocked stage 1: (x1, ln, k, v), each (B, T, D) in the compute
    type."""
    cd, d = pk.compute_dtype, pk.d
    x32 = _ffn(pk, x.float(), 0, pk.w1a, pk.b1a, pk.w2a, pk.b2a)
    ln = layernorm(x32, pk.norms[2], pk.norms[3])
    k = _mm(ln, pk.wqkv[:, d:2 * d], pk.bqkv[d:2 * d], cd)
    v = _mm(ln, pk.wqkv[:, 2 * d:], pk.bqkv[2 * d:], cd)
    return x32.to(cd), ln.to(cd), k.to(cd), v.to(cd)


def half_a_qblock_plain(pk, x1, ln, k, v, maskf, pos, tq=64):
    """Q-blocked stage 2 (each query row attends the whole key row, so the
    q blocks of `tq` rows do not change the result)."""
    cd, d = pk.compute_dtype, pk.d
    q = _mm(ln.float(), pk.wqkv[:, :d], pk.bqkv[:d], cd)
    ctx = _attend(pk, q, k, v, maskf, pos)
    return (x1.float() + _mm(ctx, pk.wo, pk.bo, cd)).to(cd)


# ------------------------------------------------------------- the kernels

@functools.lru_cache(maxsize=None)
def _checked_lib():
    lib = _build.lib()
    names = tuple(lib.cassnat_conformer_ptr_names().decode().split(","))
    if names != PTR_NAMES:
        raise RuntimeError(f"conformer_layer.cu pointer slots {names} do not "
                           f"match the wrapper's {PTR_NAMES}")
    return lib


def _check(pk, x, *others):
    if x.device.type != "cuda":
        raise ValueError(f"conformer layer: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conformer layer: x must be f32 or bf16, got "
                        f"{x.dtype}")
    if x.dtype != pk.compute_dtype or x.dim() != 3 or x.shape[2] != pk.d:
        raise ValueError(f"conformer layer: x {tuple(x.shape)} {x.dtype} "
                         f"does not fit the packed layer (D={pk.d}, "
                         f"{pk.compute_dtype})")
    if pk.device != x.device:
        raise ValueError(f"conformer layer: weights on {pk.device}, x on "
                         f"{x.device}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"conformer layer: empty batch {tuple(x.shape)}")
    dk = pk.d // pk.n_head
    if pk.d % pk.n_head or pk.d % 8 or pk.f % 8 or dk > MAX_DK \
            or pk.kernel_size > MAX_KERNEL:
        raise ValueError(f"conformer layer: unsupported widths D={pk.d}, "
                         f"H={pk.n_head}, F={pk.f}, K={pk.kernel_size} (D, F "
                         f"multiples of 8, D/H <= {MAX_DK}, K <= "
                         f"{MAX_KERNEL})")
    for t in others:
        if t.device != x.device:
            raise ValueError("conformer layer: tensors on different devices")


def _dims(pk, x, pos, tq):
    b, t, d = x.shape
    return (ctypes.c_int * 8)(b, t, d, pk.f, pk.n_head, pk.kernel_size,
                              1 if pos is None else pos.shape[0], tq)


def scratch_bytes(kind, pk, x, pos=None, tq=1):
    """Bytes of device scratch the kernel `kind` takes for these inputs."""
    return _checked_lib().cassnat_conformer_scratch_bytes(
        _KINDS[kind], _dims(pk, x, pos, tq), _DTYPES[x.dtype])


def plan(kind, pk, x, pos=None):
    """The bf16 launch plan of "half_a" or "half_b" for these inputs on the
    current card, for logs: grid, threads, shared memory, ring stages, and
    per product (phase order) N, K and its tile (rows x width, count)."""
    vals = (ctypes.c_int * 24)()
    _build.check(_checked_lib().cassnat_conformer_plan(
        _KINDS[kind], _dims(pk, x, pos, 1), vals), f"{kind} plan")
    out = dict(zip(("grid", "threads", "smem_bytes", "stages"), vals[:4]))
    out["products"] = [
        dict(weight=name, n=vals[4 + 5 * i], k=vals[5 + 5 * i],
             tile=f"{vals[6 + 5 * i]}x{vals[7 + 5 * i]}",
             tiles=vals[8 + 5 * i])
        for i, name in enumerate(PRODUCTS[kind])]
    return out


def _launch(kind, pk, x, out, pos=None, tq=1, **tensors):
    lib = _checked_lib()
    t = x.shape[1]
    dims = _dims(pk, x, pos, tq)
    dt = _DTYPES[x.dtype]
    smem = lib.cassnat_conformer_smem_bytes(_KINDS[kind], dims, dt)
    nbytes = lib.cassnat_conformer_scratch_bytes(_KINDS[kind], dims, dt)
    if smem == 0 or nbytes == 0:
        raise ValueError(f"{kind}: dims {list(dims)} refused")
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kind}: T={t} needs {smem} bytes of shared memory "
                         f"per block, more than {SMEM_LIMIT}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    ops = dict(vars(pk), x=x, pos=pos, out=out, scratch=scratch, **tensors)
    ptrs = (ctypes.c_uint64 * len(PTR_NAMES))(*(
        ops[n].data_ptr() if isinstance(ops.get(n), torch.Tensor) else 0
        for n in PTR_NAMES))
    with torch.cuda.device(x.device):
        err = getattr(lib, f"cassnat_conformer_{kind}")(
            ptrs, dims, dt, _build.stream_ptr(x.device))
    _build.check(err, kind)
    launches[kind] += 1
    return out


def _mask_pos(pk, x, maskf, pos):
    b, t, _ = x.shape
    if maskf.shape != (b, t) or pos.dim() != 2 or pos.shape[1] != pk.d \
            or pos.shape[0] % 2 == 0 or pos.dtype != x.dtype:
        raise ValueError(f"conformer layer: maskf {tuple(maskf.shape)} / pos "
                         f"{tuple(pos.shape)} {pos.dtype} do not fit x "
                         f"{tuple(x.shape)}")
    return maskf.float().contiguous(), pos.contiguous()


def half_a(pk, x, maskf, pos):
    """Half A: kernel for CUDA tensors, plain version for CPU tensors."""
    if x.device.type == "cpu":
        return half_a_plain(pk, x, maskf, pos)
    _check(pk, x, maskf, pos)
    maskf, pos = _mask_pos(pk, x, maskf, pos)
    x = x.contiguous()
    return _launch("half_a", pk, x, torch.empty_like(x), pos, maskf=maskf,
                   **pk.kmajor)


def half_b(pk, x):
    """Half B: kernel for CUDA tensors, plain version for CPU tensors."""
    if x.device.type == "cpu":
        return half_b_plain(pk, x)
    _check(pk, x)
    x = x.contiguous()
    return _launch("half_b", pk, x, torch.empty_like(x), **pk.kmajor)


def half_a_kv(pk, x):
    """Q-blocked stage 1: kernel for CUDA tensors, plain version for CPU
    tensors; returns (x1, ln, k, v)."""
    if x.device.type == "cpu":
        return half_a_kv_plain(pk, x)
    _check(pk, x)
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in range(4)]
    _launch("half_a_kv", pk, x, None, **dict(zip(("x1", "ln", "k", "v"),
                                                 outs)))
    return tuple(outs)


def half_a_qblock(pk, x1, ln, k, v, maskf, pos, tq=64):
    """Q-blocked stage 2 over q blocks of `tq` rows: kernel for CUDA
    tensors, plain version for CPU tensors."""
    if tq < 1:
        raise ValueError(f"half_a_qblock: tq must be >= 1, got {tq}")
    if x1.device.type == "cpu":
        return half_a_qblock_plain(pk, x1, ln, k, v, maskf, pos, tq)
    _check(pk, x1, ln, k, v, maskf, pos)
    for t in (ln, k, v):
        if t.shape != x1.shape or t.dtype != x1.dtype:
            raise ValueError("half_a_qblock: x1, ln, k, v must share shape "
                             "and type")
    maskf, pos = _mask_pos(pk, x1, maskf, pos)
    x1, ln, k, v = (t.contiguous() for t in (x1, ln, k, v))
    return _launch("half_a_qblock", pk, x1, torch.empty_like(x1), pos, tq,
                   maskf=maskf, x1=x1, ln=ln, k=k, v=v)


# ------------------------------------------------------------------ layers

def _check_table(pk, pos_table):
    if pos_table.dim() != 2 or pos_table.shape[1] != pk.d \
            or pos_table.shape[0] % 2 == 0:
        raise ValueError(f"conformer layer: pos_table {tuple(pos_table.shape)}"
                         f" is not a (2r+1, {pk.d}) table")


def conformer_layer_fused(pk, x, maskf, pos_table):
    """One conformer encoder layer, packed as `pk`, as the two fused halves.
    x (B, T, D) in the compute type, maskf (B, T) float 1/0, pos_table the
    (2r+1, D) clamped relative table (r = min(R, T-1))."""
    _check_table(pk, pos_table)
    return half_b(pk, half_a(pk, x, maskf, pk.position(pos_table)))


def conformer_layer_fused_qblocked(pk, x, maskf, pos_table, tq=64):
    """The same layer with half A in two stages: ffn + K/V for the whole
    row, then q blocks of `tq` rows against the row's K/V; then half B."""
    _check_table(pk, pos_table)
    x1, ln, k, v = half_a_kv(pk, x)
    return half_b(pk, half_a_qblock(pk, x1, ln, k, v, maskf,
                                    pk.position(pos_table), tq))
