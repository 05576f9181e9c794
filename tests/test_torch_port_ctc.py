"""PyTorch port: the CTC dynamic programs and the oracle_att decode against
the JAX package.

The JAX side (tests/torch_port_jax_side.py "ctc", one clean subprocess)
runs `ctc_viterbi_align` and `ctc_forward_score` as scans and through the
Pallas kernels in interpret mode (`ctc_viterbi_align_pallas`,
`ctc_forward_score_pallas` with its custom VJP), as
tests/test_ctc_*_kernel.py run them, on the tests/test_ctc.py batches, the
kernel tests' sweeps and a seeded sweep with repeated labels, U=1,
T'=2U+1, a length-0 row and impossible rows; and `label_smoothing_loss`.

On the CPU the port's kernel wrappers compute their plain versions: the
Viterbi kernel's (a max-plus loop) and the CTC kernels' (the alpha trellis,
the beta/posterior pass and the one-hot scatter, behind the
autograd.Function the card uses); the plain CTC route is the scan with
autograd.

The oracle_att decode (tests/torch_port_jax_side.py "oracle": the
committed synth checkpoint in f32, `nat_decode_jit(align="oracle")` on the
first 8 test utterances with their token_char.scp labels) must give the
same tokens through `nat_oracle_decode` and the decode CLI; the
150-utterance version is marked slow.

Tolerances: alignments, states and offsets exactly (max and add are
exact); CTC scores and gradients within 2e-5 abs + 2e-5 rel (f32 log-sum-
exp in another order, and the posterior formula against autodiff through
the scan); label smoothing within 1e-6 (f32 sums of 171 terms).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port_jax_side import REPO, run_jax_side

from cassnat_asr_public_tpu_torch.bin import decode_asr
from cassnat_asr_public_tpu_torch.kernels import ctc_loss as kl
from cassnat_asr_public_tpu_torch.kernels import ctc_viterbi as kv
from cassnat_asr_public_tpu_torch.ops import ctc as C
from cassnat_asr_public_tpu_torch.utils.config import load_config
from cassnat_asr_public_tpu_torch.utils.decoding import nat_oracle_decode
from cassnat_asr_public_tpu_torch.utils.losses import label_smoothing_loss

TOL = 2e-5
CASES = ["test_ctc_random", "test_ctc_bruteforce", "sweep_base",
         "sweep_ragged", "sweep_s_gt_128", "sweep_single_label",
         "sweep_wide_vocab", "repeats", "test_ctc_clean", "edges",
         "impossible"]


@pytest.fixture(scope="module")
def jax_ctc(tmp_path_factory):
    return run_jax_side("ctc", tmp_path_factory.mktemp("jax_ctc"))


@pytest.fixture
def switches():
    """Restore the CTC kernel switches to auto afterwards."""
    yield
    C.enable_ctc_loss_kernel(None)
    C.enable_viterbi_kernel(None)


def _inputs(store, case):
    return [torch.from_numpy(store[f"{case}/in/{k}"])
            for k in ("lp", "labels", "in_lens", "lab_lens")]


@pytest.mark.parametrize("case", CASES)
def test_viterbi_matches_jax_scan_and_pallas(jax_ctc, case):
    lp, labels, in_lens, lab_lens = _inputs(jax_ctc, case)
    out = f"{case}/out/viterbi"
    before = kv.launches
    for fn in (kv.ctc_viterbi_plain, kv.ctc_viterbi):
        shift, states, offsets, alpha = fn(lp, labels, in_lens, lab_lens)
        np.testing.assert_array_equal(shift.numpy(),
                                      jax_ctc[f"{out}_scan_shift"])
        np.testing.assert_array_equal(shift.numpy(),
                                      jax_ctc[f"{out}_pallas_shift"])
        # the Pallas kernel writes offset 0 past each length, as the port
        # does: the states agree everywhere; the scan's only on valid frames
        np.testing.assert_array_equal(states.numpy(),
                                      jax_ctc[f"{out}_pallas_states"])
        want = jax_ctc[f"{out}_scan_states"]
        for b, t in enumerate(in_lens.tolist()):
            np.testing.assert_array_equal(states[b, :t].numpy(),
                                          want[b, :t])
        assert shift.dtype == states.dtype == torch.int32
        assert (offsets[torch.arange(lp.shape[1])[None, :]
                        >= in_lens[:, None]] == 0).all()
    assert kv.launches == before


@pytest.mark.parametrize("on", [None, True, False])
def test_viterbi_switch_routes(jax_ctc, switches, on):
    C.enable_viterbi_kernel(on)
    lp, labels, in_lens, lab_lens = _inputs(jax_ctc, "repeats")
    shift, states = C.ctc_viterbi_align(lp, labels, in_lens, lab_lens)
    np.testing.assert_array_equal(shift.numpy(),
                                  jax_ctc["repeats/out/viterbi_pallas_shift"])
    with pytest.raises(NotImplementedError, match="sample_topk"):
        C.ctc_viterbi_align(lp, labels, in_lens, lab_lens, sample_topk=2)


def _score_and_grad(fn, lp, labels, in_lens, lab_lens):
    x = lp.clone().requires_grad_()
    score = fn(x, labels, in_lens, lab_lens)
    loss = (score / lab_lens.clamp(min=1)).mean()
    return score.detach(), torch.autograd.grad(loss, x)[0]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("route", ["scan", "kernel"])
@pytest.mark.parametrize("case", CASES)
def test_ctc_score_and_grad_match_jax(jax_ctc, case, route):
    """Both JAX paths (scan autodiff, Pallas custom VJP in interpret mode)
    against the port's scan (autograd) and its kernel route (the
    autograd.Function over the kernels' plain versions on the CPU)."""
    fn = C.ctc_forward_score_scan if route == "scan" \
        else kl.ctc_forward_score_kernel
    before = dict(kl.launches)
    score, grad = _score_and_grad(fn, *_inputs(jax_ctc, case))
    # an impossible row (fewer frames than labels plus repeats) scores near
    # LOG_ZERO; the kernels give it a zero gradient, autodiff through the
    # scan an arbitrary one (zero_infinity drops it from the loss), so the
    # scans' gradients are compared on possible rows only
    possible = jax_ctc[f"{case}/out/score_scan"] > C.LOG_ZERO / 2
    for tag in ("scan", "pallas"):
        _close(score, jax_ctc[f"{case}/out/score_{tag}"])
        _close(grad[possible], jax_ctc[f"{case}/out/grad_{tag}"][possible])
    assert torch.isfinite(grad).all()
    assert kl.launches == before
    if route == "kernel":
        _close(grad, jax_ctc[f"{case}/out/grad_pallas"])
        assert (grad[~possible] == 0).all()
    if case == "impossible":
        assert 0 < possible.sum() < len(possible)


@pytest.mark.parametrize("route", ["scan", "kernel"])
@pytest.mark.parametrize("case", ["test_ctc_random", "repeats", "edges",
                                  "sweep_s_gt_128"])
def test_ctc_loss_matches_torch_ctc_loss(jax_ctc, switches, case, route):
    """The port's ctc_loss ('mean', zero_infinity) and its gradient to the
    logits against torch.nn.functional.ctc_loss (whose gradient assumes
    normalized log-probs, so both are taken through a log-softmax)."""
    C.enable_ctc_loss_kernel(route == "kernel")
    lp, labels, in_lens, lab_lens = _inputs(jax_ctc, case)
    logits = lp.clone()

    def run(loss_fn):
        x = logits.clone().requires_grad_()
        loss = loss_fn(torch.log_softmax(x, -1))
        return loss.detach(), torch.autograd.grad(loss, x)[0]

    got = run(lambda y: C.ctc_loss(y, labels, in_lens, lab_lens))
    want = run(lambda y: F.ctc_loss(y.transpose(0, 1), labels.long(),
                                    in_lens.long(), lab_lens.long(),
                                    reduction="mean", zero_infinity=True))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_ctc_kernel_route_is_deterministic(jax_ctc):
    args = _inputs(jax_ctc, "sweep_wide_vocab")
    g1 = _score_and_grad(kl.ctc_forward_score_kernel, *args)[1]
    g2 = _score_and_grad(kl.ctc_forward_score_kernel, *args)[1]
    assert torch.equal(g1, g2)


def test_ctc_loss_zero_infinity_and_reductions(jax_ctc):
    lp, labels, in_lens, lab_lens = _inputs(jax_ctc, "impossible")
    nll = C.ctc_loss(lp, labels, in_lens, lab_lens, reduction="none")
    score = jax_ctc["impossible/out/score_scan"]
    want = np.where(-score >= 5e9, 0.0, -score)
    np.testing.assert_allclose(nll.numpy(), want, atol=TOL, rtol=TOL)
    assert (nll == 0).tolist() == (score <= C.LOG_ZERO / 2).tolist()
    assert (nll > 0).any() and (nll == 0).any()
    torch.testing.assert_close(
        C.ctc_loss(lp, labels, in_lens, lab_lens),
        (nll / lab_lens.clamp(min=1)).mean())


@pytest.mark.parametrize("case", ["ls", "ls_extra", "ls_zero"])
def test_label_smoothing_matches_jax(jax_ctc, case):
    t = lambda k: torch.from_numpy(jax_ctc[f"{case}/in/{k}"])
    extra = t("extra") if f"{case}/in/extra" in jax_ctc else None
    got = label_smoothing_loss(t("lp"), t("tgt"), 19, 0,
                               0.0 if case == "ls_zero" else 0.1, extra)
    np.testing.assert_allclose(got.item(), jax_ctc[f"{case}/out/loss"],
                               atol=1e-6, rtol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _card_case(seed, bs, tmax, umax, vocab):
    """Seeded log-probs with repeated labels, ragged lengths, an impossible
    row and a row of length 0 (numpy only: the card has no JAX)."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((bs, tmax, vocab)).astype(np.float32)), -1)
    lab_lens = rng.integers(1, umax + 1, bs)
    in_lens = rng.integers(2 * umax + 1, tmax + 1, bs)
    labels = rng.integers(1, vocab, (bs, umax))
    labels[:, 1::3] = labels[:, 0::3][:, :labels[:, 1::3].shape[1]]
    lab_lens[0], in_lens[0] = umax, umax - 1        # impossible
    in_lens[1] = 0
    labels = labels * (np.arange(umax)[None] < lab_lens[:, None])
    return [lp, torch.from_numpy(labels), torch.from_numpy(in_lens),
            torch.from_numpy(lab_lens)]


# (3, 2000, 400, 4999): the T' x S offset bytes exceed shared memory, so
# the Viterbi kernel backtraces from device memory, and S = 801 takes 2
# states a lane; (2, 1300, 600, 1000) and (2, 2400, 1100, 2000): S = 1201
# and 2201 take 4 and 8; (4, 77, 30, 300): T' = 77 is no multiple of the
# 16 frames loaded ahead or the gather's 8-frame chunks; (4300, 24, 5, 12):
# more rows than the card holds blocks (32 an SM), so no gather block fits
# beside them and the gather blocks take a launch of their own
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 30, 6, 9), (3, 150, 70, 12),
                                   (4, 200, 99, 4999), (3, 17, 1, 4),
                                   (3, 2000, 400, 4999), (4, 77, 30, 300),
                                   (2, 1300, 600, 1000),
                                   (2, 2400, 1100, 2000),
                                   (4300, 24, 5, 12)])
def test_ctc_kernels_match_plain_on_card(cuda, shape):
    """On the card: the Viterbi kernel bit-equal to its plain version, the
    CTC score and gradient within TOL of the kernel route's plain versions
    and, up to T' = 200, of the scan's (over 2000 frames the scan's
    autodiff and the posterior formula part by 2.6e-5 in f32), two
    backward passes identical."""
    args = [a.to(cuda) for a in _card_case(0, *shape)]
    before = kv.launches
    got = kv.ctc_viterbi(*args)
    want = kv.ctc_viterbi_plain(*args)
    torch.cuda.synchronize()
    assert kv.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))
    s1, g1 = _score_and_grad(kl.ctc_forward_score_kernel, *args)
    _, g3 = _score_and_grad(kl.ctc_forward_score_kernel, *args)
    lp, labels, in_lens, lab_lens = args
    sp, trellis_p = kl.ctc_alpha_plain(*args)
    gp = kl.ctc_grad_scatter_plain(
        kl.ctc_beta_grad_plain(*args, trellis_p, sp), labels,
        1.0 / lab_lens.clamp(min=1).float() / shape[0], shape[3])
    torch.cuda.synchronize()
    possible = sp > C.LOG_ZERO / 2
    torch.testing.assert_close(s1, sp, atol=TOL, rtol=TOL)
    torch.testing.assert_close(g1, gp, atol=TOL, rtol=TOL)
    if shape[1] <= 200:
        s2, g2 = _score_and_grad(C.ctc_forward_score_scan, *args)
        torch.testing.assert_close(s1, s2, atol=TOL, rtol=TOL)
        torch.testing.assert_close(g1[possible], g2[possible], atol=TOL,
                                   rtol=TOL)
    assert (g1[~possible] == 0).all()
    assert torch.equal(g1, g3)


# ------------------------------------------- the CUDA DPs' layout, emulated

EDGE_SLOTS = 2      # csrc/ctc_dp.cuh `Edges`: a pair a warp, two steps
DP_CHUNK = 8        # csrc/ctc_dp.cuh CHUNK: steps a gather block hands over


def _layout(smax, k):
    """(warps, padded states) of a row: 32 lanes a warp, k states a lane,
    state s = (32 w + lane) k + j."""
    warps = -(-smax // (32 * k))
    return warps, 32 * warps * k


def _path_tokens(labels_b, sp, blank=0):
    """The path's token per padded state (0 past S, as the kernels set)."""
    smax = 2 * labels_b.shape[0] + 1
    path = torch.zeros(sp, dtype=torch.long)
    path[:smax] = blank
    path[1:smax:2] = labels_b.long()
    return path


def _neighbours(v, k, warps, e0, e1, up):
    """The shuffles of one step: each state's two neighbours below (up) or
    above (not up), the lanes at the warp's edge taking e0 / e1 (per warp:
    the states one and two past the edge, from the edge ring)."""
    x = v.reshape(warps, 32, k)
    if up:
        p1 = torch.roll(x[:, :, k - 1], 1, 1)
        p2 = torch.roll(x[:, :, k - 2], 1, 1) if k >= 2 \
            else torch.roll(x[:, :, 0], 2, 1)
        p1[:, 0], p2[:, 0] = e0, e1
        if k == 1:
            p2[:, 1] = e0
        n1 = torch.cat([p1[..., None], x[..., :-1]], -1)
        n2 = torch.cat([p2[..., None], p1[..., None], x[..., :-2]], -1)[
            ..., :k]
    else:
        p1 = torch.roll(x[:, :, 0], -1, 1)
        p2 = torch.roll(x[:, :, 1], -1, 1) if k >= 2 \
            else torch.roll(x[:, :, 0], -2, 1)
        p1[:, 31], p2[:, 31] = e0, e1
        if k == 1:
            p2[:, 30] = e0
        n1 = torch.cat([x[..., 1:], p1[..., None]], -1)
        n2 = torch.cat([x[..., 2:], p1[..., None], p2[..., None]], -1)[
            ..., -k:]
    return n1.reshape(-1), n2.reshape(-1)


class _EdgeRing:
    """The warps' edge states after each step in EDGE_SLOTS slots (the
    kernel's warps meet at a barrier after every step)."""

    def __init__(self, warps):
        self.ring = torch.full((EDGE_SLOTS, warps, 2), C.LOG_ZERO)

    def read(self, i, up):
        """Per warp, the source warp's two edge states after step i-1."""
        e = torch.full((self.ring.shape[1], 2), C.LOG_ZERO)
        if i > 0:
            prev = self.ring[(i - 1) % EDGE_SLOTS]
            if up:
                e[1:] = prev[:-1]
            else:
                e[:-1] = prev[1:]
        return e[:, 0], e[:, 1]

    def write(self, i, v, k, up):
        x = v.reshape(self.ring.shape[1], 32 * k)
        slot = self.ring[i % EDGE_SLOTS]
        if up:      # states last, last-1 of each warp
            slot[:, 0], slot[:, 1] = x[:, -1], x[:, -2]
        else:       # states first, first+1
            slot[:, 0], slot[:, 1] = x[:, 0], x[:, 1]


def _gather(lp_b, path, tn, sp, backward):
    """The gather blocks for one row: lp_path rows (T, sp) written chunk by
    chunk of DP_CHUNK steps in the DP's frame order (step i is frame i,
    or tn-1-i backwards); returns the rows and each chunk's flag."""
    smax = int((path >= 0).sum())
    rows = torch.full((lp_b.shape[0], sp), float("nan"))
    chunks = -(-tn // DP_CHUNK)
    for c in range(chunks):
        for i in range(c * DP_CHUNK, min(tn, (c + 1) * DP_CHUNK)):
            t = tn - 1 - i if backward else i
            rows[t, :smax] = lp_b[t, path[:smax]]
    return rows, [True] * chunks + [False]


class _Gate:
    """ChunkGate: wait(i) returns once the chunks of steps up to i are
    flagged; `ready` is the first step not covered. The kernel's gate also
    moves past later chunks its flag word shows flagged; the emulation
    takes the least move, the case of a gather that only just keeps
    ahead, where every load must still fall behind the gate."""

    def __init__(self, flags):
        self.flags, self.ready = flags, 0

    def wait(self, i):
        while i >= self.ready:
            assert self.flags[self.ready // DP_CHUNK]
            self.ready += DP_CHUNK


class _Ring:
    """A lane's registers of loads in flight, `depth` frames: the frame of
    step j in slot j % depth, loaded `depth` steps ahead of the step that
    reads it (into the slot that step has just read; past the last step,
    the last frame again), each block of `depth` steps behind one gate
    wait that covers the frames the block loads."""

    def __init__(self, depth, sp, gather, steps, flags=None):
        self.depth, self.gather, self.steps = depth, gather, steps
        self.gate = _Gate(flags) if flags is not None else None
        self.slots = torch.full((depth, sp), float("nan"))
        if steps > 0:
            self.wait(depth - 1)
            for j in range(depth):
                self.load(j)

    def wait(self, i):
        if self.gate is not None:
            self.gate.wait(min(i, self.steps - 1))

    def load(self, j):
        frame = min(j, self.steps - 1)
        assert self.gate is None or frame < self.gate.ready
        self.slots[j % self.depth] = self.gather(frame)

    def step(self, i):
        if i % self.depth == 0:
            self.wait(i + 2 * self.depth - 1)
        got = self.slots[i % self.depth].clone()
        self.load(i + self.depth)
        return got


def _bulk_offsets(offs8, n, lim, mis):
    """The Viterbi kernel's write of its byte offsets (flat t * S + s) to
    the int32 output: (4 - mis) % 4 ints, then 4-int stores at indices
    that are 4-aligned in both buffers, then the tail; 0 from lim on."""
    out = torch.full((n,), -1, dtype=torch.int32)
    h = min((4 - mis) % 4, n)
    body = h + (n - h) // 4 * 4
    for q in range(h):
        out[q] = int(offs8[q]) if q < lim else 0
    for q in range(h, body, 4):
        assert (mis + q) % 4 == 0
        for j in range(q, q + 4):
            out[j] = int(offs8[j]) if j < lim else 0
    for q in range(body, n):
        out[q] = int(offs8[q]) if q < lim else 0
    assert (out >= 0).all()
    return out


def _emulate_viterbi(lp, labels, in_lens, lab_lens, k, rf, blank=0):
    """csrc/ctc_viterbi.cu on the CPU: the gather in chunks, the
    lane-to-state map, the shuffles and the edge ring, the loads ahead in
    frame order, the offsets as bytes (flat t * S + s) with the backtrace
    from them and their 16-byte write to the output, the
    collapse-and-shift."""
    bs, tmax, _ = lp.shape
    smax = 2 * labels.shape[1] + 1
    warps, sp = _layout(smax, k)
    s = torch.arange(sp)
    offsets = torch.zeros(bs, tmax, smax, dtype=torch.int32)
    alpha_out = torch.empty(bs, smax)
    states = torch.empty(bs, tmax, dtype=torch.int32)
    shift = torch.empty(bs, tmax, dtype=torch.int32)
    for b in range(bs):
        path = _path_tokens(labels[b], sp, blank)
        ln, plen = int(in_lens[b]), 2 * int(lab_lens[b]) + 1
        tn = min(max(ln, 0), tmax)
        skip2 = (s < 2) | ((s < smax)
                           & (path == torch.roll(path, 2)))
        rows, flags = _gather(lp[b], torch.where(s < smax, path, -1), tn,
                              sp, False)
        ring = _Ring(rf, sp, lambda t: torch.where(s < smax, rows[t], 0.0),
                     tn, flags)
        edges = _EdgeRing(warps)
        offs8 = torch.full((tmax * smax,), 255, dtype=torch.uint8)
        a = torch.where(s == 0, 0.0, C.LOG_ZERO)
        for i in range(tn):
            lk = ring.step(i)
            a1, a2 = _neighbours(a, k, warps, *edges.read(i, True), up=True)
            a1 = torch.where(s == 0, C.LOG_ZERO, a1)
            a2 = torch.where(skip2, C.LOG_ZERO, a2)
            m01 = torch.maximum(a, a1)
            off = torch.where(a2 > m01, 2, (a1 > a).int())
            best = torch.where(s >= plen, C.LOG_ZERO,
                               torch.maximum(m01, a2))
            a = best + lk
            offs8[i * smax:(i + 1) * smax] = off[:smax].to(torch.uint8)
            edges.write(i, a, k, True)
        alpha_out[b] = a[:smax]
        p1, p2 = plen - 1, max(plen - 2, 0)
        s_final = p1 if a[min(p1, smax - 1)] > a[min(p2, smax - 1)] else p2
        carry = s_final
        for t in range(tmax - 1, -1, -1):
            cur = s_final if t == ln - 1 else carry
            states[b, t] = cur
            c = min(max(cur, 0), smax - 1)
            off = int(offs8[t * smax + c]) if t < tn else 0
            carry = min(max(cur - off, 0), smax - 1)
        offsets[b] = _bulk_offsets(offs8, tmax * smax, tn * smax,
                                   b * tmax * smax % 4).view(tmax, smax)
        tok = lambda u: int(path[int(states[b, u])]) if u < ln else blank
        for t in range(tmax):
            out = blank
            if t >= 1:
                before = tok(t - 2) if t >= 2 else blank
                out = blank if tok(t - 1) == before else tok(t - 1)
            shift[b, t] = out
    return shift, states, offsets, alpha_out


def _emulate_chains(path, smax, blank=0):
    """ctc_beta_grad_kernel's token chains: each state scans the later
    states (a blank state at most two, a label state the later label
    states); a head is a state no state chains to."""
    nxt = torch.full((smax,), -1, dtype=torch.int32)
    for s in range(smax):
        tok = int(path[s])
        if tok == blank:
            if s + 1 < smax and int(path[s + 1]) == blank:
                nxt[s] = s + 1
            elif s + 2 < smax:
                nxt[s] = s + 2
        else:
            for r in range(s + 2, smax, 2):
                if int(path[r]) == tok:
                    nxt[s] = r
                    break
    head = torch.ones(smax, dtype=torch.int32)
    head[nxt[nxt >= 0].long()] = 0
    return nxt, head


def _emulate_beta_grad(lp, labels, in_lens, lab_lens, trellis, score, k,
                       rf, blank=0):
    """ctc_beta_grad_kernel on the CPU: the gather in chunks of reversed
    frames, the lane-to-state map, the shuffles and the edge ring
    downwards, the gathered log-probs and alpha rows loaded ahead in reversed
    frame order, the token chains. Rows t >= len stay 0."""
    bs, tmax, _ = lp.shape
    smax = 2 * labels.shape[1] + 1
    warps, sp = _layout(smax, k)
    s = torch.arange(sp)
    post = torch.zeros(bs, tmax, smax)
    nxt = torch.empty(bs, smax, dtype=torch.int32)
    head = torch.empty(bs, smax, dtype=torch.int32)
    for b in range(bs):
        path = _path_tokens(labels[b], sp, blank)
        ln, plen = int(in_lens[b]), 2 * int(lab_lens[b]) + 1
        tn = min(max(ln, 0), tmax)
        logz = score[b]
        skip2 = (s + 2 >= smax) | (torch.roll(path, -2) == path)
        nxt[b], head[b] = _emulate_chains(path, smax, blank)
        pad = lambda row: torch.cat([row, torch.zeros(sp - smax)])
        rows, flags = _gather(lp[b], torch.where(s < smax, path, -1), tn,
                              sp, True)
        ring_lp = _Ring(rf, sp, lambda j: torch.where(
            s < smax, rows[tn - 1 - j], 0.0), tn, flags)
        ring_a = _Ring(rf, sp, lambda j: pad(trellis[b, tn - 1 - j]), tn)
        edges = _EdgeRing(warps)
        beta = torch.full((sp,), C.LOG_ZERO)
        terminal = (s == plen - 1) | ((s == plen - 2) & (plen >= 2))
        outside = s >= plen
        for i in range(tn):
            t = tn - 1 - i
            lk, ak = ring_lp.step(i), ring_a.step(i)
            if t == ln - 1:
                beta = torch.where(terminal & ~outside, lk, C.LOG_ZERO)
            else:
                l1, l2 = _neighbours(beta, k, warps, *edges.read(i, False),
                                     up=False)
                l1 = torch.where(s + 1 >= smax, C.LOG_ZERO, l1)
                l2 = torch.where(skip2, C.LOG_ZERO, l2)
                beta = torch.where(outside, C.LOG_ZERO,
                                   lk + kl._logaddexp3(beta, l1, l2))
            p = torch.exp(torch.clamp(ak + beta - lk - logz, max=1.0))
            keep = ~outside & (logz > C.LOG_ZERO / 2)
            post[b, t] = torch.where(keep, p, 0.0)[:smax]
            edges.write(i, beta, k, False)
    return post, nxt, head


def _viterbi_ahead(k):
    """csrc/ctc_viterbi.cu AHEAD: frames each lane loads ahead."""
    return 4 if k >= 4 else 16 // k


BETA_AHEAD = 4      # csrc/ctc_loss.cu ctc_beta_grad_kernel AHEAD


# S = 69 spans 3, 2, 1 and 1 warps at 1, 2, 4 and 8 states a lane (the
# emulation runs each layout, though the kernels take 1 at this S); T' = 71
# is no multiple of the frames loaded ahead (16, 8, 4 and 4 for Viterbi, 4
# for beta) or of the gather's 8-frame chunks, and T' S = 4899 puts the
# four rows' offsets at all four alignments; rows 0 and 1 of _card_case are
# impossible and of length 0
LAYOUT_CASE = (3, 4, 71, 34, 13)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_ctc_viterbi_layout_matches_plain(k):
    """The rebuilt Viterbi kernel's layout, emulated on the CPU step by step
    with its own load depth, equals ctc_viterbi_plain: every output
    exactly, the offsets through the byte copy and its 16-byte write at
    each row's alignment."""
    lp, labels, in_lens, lab_lens = _card_case(*LAYOUT_CASE)
    got = _emulate_viterbi(lp, labels, in_lens, lab_lens, k,
                           _viterbi_ahead(k))
    want = kv.ctc_viterbi_plain(lp, labels, in_lens, lab_lens)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_ctc_beta_layout_matches_plain(k):
    """The rebuilt beta/posterior kernel's layout, emulated on the CPU step
    by step with its own load depth, equals ctc_beta_grad_plain
    (posteriors within 1e-6 on valid frames) and its token chains equal a
    brute-force scan."""
    lp, labels, in_lens, lab_lens = _card_case(*LAYOUT_CASE)
    score, trellis = kl.ctc_alpha_plain(lp, labels, in_lens, lab_lens)
    post, nxt, head = _emulate_beta_grad(lp, labels, in_lens, lab_lens,
                                         trellis, score, k, BETA_AHEAD)
    want = kl.ctc_beta_grad_plain(lp, labels, in_lens, lab_lens, trellis,
                                  score)
    valid = torch.arange(LAYOUT_CASE[2])[None, :] < in_lens[:, None]
    torch.testing.assert_close(post[valid], want[valid], atol=1e-6,
                               rtol=1e-6)
    assert (post[~valid] == 0).all() and (post[valid] > 0).any()
    path = C._interleave_blanks(labels.long(), 0)
    for b in range(path.shape[0]):
        for s in range(path.shape[1]):
            same = (path[b] == path[b, s]).nonzero()[:, 0]
            later = same[same > s]
            assert nxt[b, s] == (later[0] if len(later) else -1)
            assert head[b, s] == int(same[0] == s)


SYNTH = os.path.join(REPO, "egs", "synth")
CKPT = os.path.join(SYNTH, "exp", "cassnat", "best_model.ckpt")


@pytest.fixture(scope="module")
def jax_oracle(tmp_path_factory):
    return run_jax_side("oracle", tmp_path_factory.mktemp("jax_oracle"))


def _check_oracle(store):
    cfg = load_config(os.path.join(SYNTH, "exp", "cassnat", "config.yaml"))
    model = decode_asr.load_model(CKPT, cfg, "cpu", torch.float32)
    batches = sorted({k.split("/")[0] for k in store if k.startswith("b")},
                     key=lambda s: int(s[1:]))
    for b in batches:
        t = lambda k: torch.from_numpy(store[f"{b}/in/{k}"])
        out = nat_oracle_decode(model, t("feats"), t("mask"),
                                t("labels").long(), t("sizes").long())
        np.testing.assert_array_equal(out["tokens"].numpy(),
                                      store[f"{b}/oracle/tokens"])
        np.testing.assert_array_equal(out["lengths"].numpy(),
                                      store[f"{b}/oracle/lengths"])
        # the oracle alignment yields one token per reference label
        np.testing.assert_array_equal(out["lengths"].numpy(),
                                      store[f"{b}/in/sizes"])


def test_oracle_decode_matches_jax(jax_oracle):
    _check_oracle(jax_oracle)


@pytest.mark.slow
def test_oracle_decode_matches_jax_all_150(tmp_path):
    store = run_jax_side("oracle_full", tmp_path)
    assert len(store["utts"]) == 150
    _check_oracle(store)


def test_decode_cli_oracle_att(tmp_path, jax_oracle):
    scp = tmp_path / "feats.scp"
    src = os.path.join(SYNTH, "data", "fbank", "test", "feats.scp")
    with open(src) as f:
        scp.write_text("".join(f.readlines()[:8]))
    os.symlink(os.path.join(os.path.dirname(src), "feats.ark"),
               tmp_path / "feats.ark")
    out = tmp_path / "hyp.ids"
    decode_asr.main(["--checkpoint", CKPT, "--feats_scp", str(scp),
                     "--cmvn", os.path.join(SYNTH, "data", "fbank",
                                            "cmvn.ark"),
                     "--device", "cpu", "--batch_size", "8",
                     "--compute_dtype", "float32",
                     "--decode_type", "oracle_att", "--text",
                     os.path.join(SYNTH, "data", "test", "token_char.scp"),
                     "--out", str(out)])
    C.enable_viterbi_kernel(None)
    toks = jax_oracle["b0/oracle/tokens"]
    lens = jax_oracle["b0/oracle/lengths"]
    got = [line.split() for line in out.read_text().splitlines()]
    assert [g[0] for g in got] == list(jax_oracle["utts"])
    for i, g in enumerate(got):
        assert [int(t) for t in g[1:]] == toks[i, :lens[i]].tolist()
