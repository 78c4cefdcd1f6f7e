"""The port's flash attention (K1 forward, K2 dq, K3 dk/dv) against the
reference's Pallas kernels, run in interpret mode on the CPU as
``tests/test_flash_attention.py`` runs them, on the same numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions; the
``cuda``-marked tests hold the hand-written kernels against those plain
versions on the card and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash)
from serverless_learn_tpu_torch.ops.attention import dot_product_attention
from serverless_learn_tpu_torch.ops.flash_attention import (
    NEG, flash_attention, flash_dkv, flash_dkv_reference, flash_dq,
    flash_dq_reference, flash_fwd, flash_fwd_reference, kernel_tolerance)

B, T, H, K, D = 1, 256, 4, 2, 32
VLEN = 200  # "len" mode: the last 56 positions are padding
# Both sides compute in f32 from the same inputs; the Pallas kernel (one
# 256 block here) and ATen's einsums add in another order: f32 round-off,
# grown by the sums over 256 keys and, for dk/dv, over 256 queries.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed=0, b=B, t=T, s=None, h=H, k=K, d=D):
    rng = np.random.default_rng(seed)
    s = s or t
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kk = rng.standard_normal((b, s, k, d)).astype(np.float32)
    v = rng.standard_normal((b, s, k, d)).astype(np.float32)
    g = rng.standard_normal((b, t, h, d)).astype(np.float32)
    mask = (rng.random((b, s)) > 0.3).astype(np.int32)
    mask[:, :3] = 0  # with causal, queries 0-2 see no valid key
    return q, kk, v, g, mask


def _mask_kwargs(mode, mask):
    """(jax kwargs, torch kwargs, rows the output is defined on)."""
    if mode == "len":
        lens = np.array([VLEN], np.int32)
        return ({"kv_lengths": jnp.asarray(lens)},
                {"kv_lengths": torch.from_numpy(lens)}, slice(0, VLEN))
    if mode == "rows":
        return ({"mask": jnp.asarray(mask)}, {"mask": torch.from_numpy(mask)},
                slice(None))
    return {}, {}, slice(None)


@pytest.mark.parametrize("mode", ["none", "len", "rows"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_pallas(causal, mode):
    q, k, v, _, mask = _inputs(0)
    jkw, tkw, rows = _mask_kwargs(mode, mask)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, **jkw))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, **tkw).numpy()
    # "len": padding queries are the caller's to ignore (the loss masks
    # them); the port zeroes them, the reference's one block computes them.
    np.testing.assert_allclose(got[:, rows], want[:, rows], **FWD_TOL)
    if mode == "len":
        assert not got[:, VLEN:].any()


@pytest.mark.parametrize("mode", ["none", "len", "rows"])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_pallas(causal, mode):
    q, k, v, g, mask = _inputs(1)
    jkw, tkw, rows = _mask_kwargs(mode, mask)
    if mode == "len":
        g[:, VLEN:] = 0.0  # as a loss over the valid positions gives

    def loss(q, k, v):
        return (jax_flash(q, k, v, causal=causal, **jkw) * g).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, **tkw)
    (out * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


def test_lse_of_masked_rows_and_dense_agreement():
    """lse is the row's log-sum-exp (checked against torch.logsumexp), a row
    with no valid key has out 0 and lse at the mask floor, and the dense
    path of dot_product_attention agrees with flash on valid rows."""
    q, k, v, _, mask = _inputs(2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    out, lse = flash_fwd_reference(tq, tk, tv, causal=True, mode="rows",
                                   arg=tm)
    assert not out[:, :3].any() and bool((lse[:, :, :3] <= -1e29).all())
    s = torch.einsum("bthd,bshd->bhts", tq,
                     tk.repeat_interleave(H // K, 2)) * D ** -0.5
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool)) & (tm[:, None, None]
                                                              != 0)
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), -1)
    np.testing.assert_allclose(lse[:, :, 3:].numpy(), want[:, :, 3:].numpy(),
                               **FWD_TOL)
    dense = dot_product_attention(tq, tk, tv, causal=True, mask=tm,
                                  impl="xla")
    np.testing.assert_allclose(out[:, 3:].numpy(), dense[:, 3:].numpy(),
                               **FWD_TOL)


def test_general_masks_and_ring_are_refused():
    q, k, v, _, _ = (torch.from_numpy(a) for a in _inputs(3))
    with pytest.raises(ValueError, match="key mask"):
        flash_attention(q, k, v, mask=torch.ones(B, 1, T, T, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dot_product_attention(q, k, v, impl="ring")


@pytest.mark.parametrize("T_,lengths,impl", [
    (4096, None, "flash"), (4095, None, "xla"), (512, [512], "flash"),
    (511, [511], "xla")])
def test_auto_policy_thresholds(monkeypatch, T_, lengths, impl):
    """impl="auto" keeps the reference's thresholds: flash at T >= 4096, or
    at T >= 512 with kv_lengths."""
    import serverless_learn_tpu_torch.ops.attention as attn

    seen = []
    monkeypatch.setattr(attn, "flash_attention",
                        lambda *a, **kw: seen.append("flash"))
    monkeypatch.setattr(attn, "xla_attention",
                        lambda *a, **kw: seen.append("xla"))
    q = torch.zeros(1, T_, 1, 32)
    kv = None if lengths is None else torch.tensor(lengths)
    attn.dot_product_attention(q, q, q, causal=True, kv_lengths=kv)
    assert seen == [impl]


def _k1_arithmetic_bf16(q, k, v, tile=64):
    """K1's forward as the kernel computes it, in torch: 64-key tiles, a
    running max and sum, p rounded to bf16 against the running max before
    ``p @ v``, f32 accumulators rescaled as the max grows; causal."""
    Bq, Tq, Hq, Dq = q.shape
    kf = k.float().repeat_interleave(Hq // k.shape[2], dim=2)
    vf = v.float().repeat_interleave(Hq // k.shape[2], dim=2)
    t = torch.arange(Tq)
    m = torch.full((Bq, Hq, Tq, 1), NEG)
    l = torch.zeros(Bq, Hq, Tq, 1)
    acc = torch.zeros(Bq, Hq, Tq, Dq)
    for j in range(0, Tq, tile):
        s = torch.einsum("bthd,bshd->bhts", q.float(),
                         kf[:, j:j + tile]) * Dq ** -0.5
        s = s.masked_fill(t[None, :, None] < t[None, None, j:j + tile], NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(s <= NEG * 0.5, 0.0, torch.exp(s - m_new))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhts,bshd->bhtd", p.to(torch.bfloat16).float(), vf[:, j:j + tile])
        m = m_new
    return (acc / l).permute(0, 2, 1, 3).to(torch.bfloat16)


def test_kernel_tolerance_passes_k1_rounding_and_fails_wrong_tiles():
    """The bf16 limit the card tests and chip_smoke.py hold K1-K3 to: K1's
    own arithmetic (p rounded against the running max) stays within half
    of it over 4096 causal keys, while a kernel that gets the later rows'
    p @ v wrong by one typical value of the row, or reads one k tile's v
    as zero, fails it in every row of the later half."""
    b, t, h, k, d = 1, 4096, 2, 1, 64
    q, kk, v, _, _ = _inputs(7, b=b, t=t, h=h, k=k, d=d)
    q, kk, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kk, v))
    ref, lse = flash_fwd_reference(q, kk, v, causal=True)
    limit = kernel_tolerance(ref)
    err = (_k1_arithmetic_bf16(q, kk, v).float() - ref.float()).abs()
    assert (err / limit).max().item() <= 0.5
    late = slice(t // 2, None)
    typical = ref[:, late].float().abs().median(dim=-1, keepdim=True).values
    off_by_typical = ref[:, late].float() + typical
    assert bool((off_by_typical - ref[:, late].float()).abs().gt(
        limit[:, late]).any(dim=-1).all())  # every late row fails
    v0 = v.clone()
    v0[:, :64] = 0
    wrong_tile = flash_fwd_reference(q, kk, v0, causal=True)[0]
    assert bool(((wrong_tile.float() - ref.float()).abs() > limit)[
        :, late].any(dim=-1).all())  # every late row fails


LOG2E = 1.4426950408889634


def _k2_k3_arithmetic_bf16(q, k, v, dout, lse, delta, *, chunk=64,
                           drop_head=None, unmasked_diagonal=False,
                           early_skip=False):
    """K2 and K3 as the tensor-core kernels compute them, in torch, causal,
    with each warp's share of a 64-row tile: a K2 warp takes 16 query rows
    against a 64-key tile, a K3 warp 16 keys against ``chunk`` queries of
    a 64-query tile (64 at D = 32 and 64, 32 at D = 128). A warp skips a
    block wholly above the diagonal and applies the mask only to a block
    the diagonal crosses, by the kernels' own tests; p = exp2(s * (scale
    log2 e) - lse log2 e), p and ds rounded to bf16 before the products,
    every sum f32, dk/dv summed over the GQA group. ``drop_head`` leaves
    that q head out of the group sum, ``unmasked_diagonal`` skips the
    mask on the diagonal blocks, and ``early_skip`` has K3 skip a chunk
    whose first query precedes the warp's first key (a wrong boundary):
    the faults the limit must catch."""
    Bq, Tq, Hq, Dq = q.shape
    Kq = k.shape[2]
    grp = Hq // Kq
    scale2 = torch.tensor(Dq ** -0.5, dtype=torch.float32) * LOG2E
    qf, gf = q.float().transpose(1, 2), dout.float().transpose(1, 2)
    kf = k.float().repeat_interleave(grp, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(grp, dim=2).transpose(1, 2)
    lse2 = (lse * LOG2E)[..., None]
    pos = torch.arange(Tq)

    def p_ds(r0, nr, c0, nc, masked):
        """bf16 p and ds of queries [r0, r0 + nr) against keys
        [c0, c0 + nc), the mask applied only where ``masked``."""
        s = qf[:, :, r0:r0 + nr] @ kf[:, :, c0:c0 + nc].transpose(-1, -2)
        p = torch.exp2(s * scale2 - lse2[:, :, r0:r0 + nr])
        if masked and not unmasked_diagonal:
            p = p.masked_fill(pos[None, c0:c0 + nc]
                              > pos[r0:r0 + nr, None], 0.0)
        dp = gf[:, :, r0:r0 + nr] @ vf[:, :, c0:c0 + nc].transpose(-1, -2)
        ds = p * (dp - delta[:, :, r0:r0 + nr, None]) * Dq ** -0.5
        return _round_bf16(p), _round_bf16(ds)

    dq = torch.zeros(Bq, Hq, Tq, Dq)
    for qw in range(0, Tq, 16):  # K2: a warp's 16 rows
        for k0 in range(0, Tq, 64):
            if k0 > qw + 15:
                continue
            _, ds = p_ds(qw, 16, k0, 64, k0 + 63 > qw)
            dq[:, :, qw:qw + 16] += ds @ kf[:, :, k0:k0 + 64]
    dk = torch.zeros(Bq, Hq, Tq, Dq)
    dv = torch.zeros(Bq, Hq, Tq, Dq)
    for kw in range(0, Tq, 16):  # K3: a warp's 16 keys
        for qa in range(kw // 64 * 64, Tq, chunk):
            if kw > (qa if early_skip else qa + chunk - 1):
                continue
            p, ds = p_ds(qa, chunk, kw, 16, kw + 15 > qa)
            dk[:, :, kw:kw + 16] += ds.transpose(-1, -2) @ qf[:, :, qa:qa + chunk]
            dv[:, :, kw:kw + 16] += p.transpose(-1, -2) @ gf[:, :, qa:qa + chunk]
    if drop_head is not None:
        dk[:, drop_head] = 0
        dv[:, drop_head] = 0
    dk = dk.transpose(1, 2).reshape(Bq, Tq, Kq, grp, Dq).sum(3)
    dv = dv.transpose(1, 2).reshape(Bq, Tq, Kq, grp, Dq).sum(3)
    return (dq.transpose(1, 2).to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def _over_limit(got, ref):
    """The worst |got - ref| / kernel_tolerance(ref)."""
    err = (got.float() - ref.float()).abs()
    return (err / kernel_tolerance(ref)).max().item()


def _k2_k3_twin_against_plain(d, chunk):
    """The twin at llama-like scales, T = S = 512, 4 q heads on 2 K/V
    heads, head dim ``d``: the worst error / limit of its dq, dk, dv, and
    of those of each fault, against the plain versions."""
    b, t, h, k = 1, 512, 4, 2
    q, kk, v, g, _ = _inputs(8, b=b, t=t, h=h, k=k, d=d)
    q, kk, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in (q, kk, v, g))
    out, lse = flash_fwd_reference(q, kk, v, causal=True)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    kw = dict(causal=True)
    want = (flash_dq_reference(q, kk, v, g, lse, delta, **kw),
            *flash_dkv_reference(q, kk, v, g, lse, delta, **kw))
    ratios = {}
    for fault, fkw in [("none", {}), ("drop_head", dict(drop_head=1)),
                       ("unmasked_diagonal", dict(unmasked_diagonal=True)),
                       ("early_skip", dict(early_skip=True))]:
        got = _k2_k3_arithmetic_bf16(q, kk, v, g, lse, delta, chunk=chunk,
                                     **fkw)
        ratios[fault] = {name: _over_limit(x, ref) for name, x, ref
                         in zip(("dq", "dk", "dv"), got, want)}
    return ratios


def _assert_twin_within_limit_and_faults_fail(ratios):
    assert max(ratios["none"].values()) <= 1.0, ratios["none"]
    assert ratios["drop_head"]["dk"] > 1.0
    assert ratios["drop_head"]["dv"] > 1.0
    assert ratios["unmasked_diagonal"]["dq"] > 1.0
    assert ratios["unmasked_diagonal"]["dk"] > 1.0
    assert ratios["early_skip"]["dk"] > 1.0
    assert ratios["early_skip"]["dv"] > 1.0


def test_kernel_tolerance_passes_k2_k3_tiles_and_fails_their_faults():
    """The bf16 limit holds the tensor-core K2/K3 arithmetic at D = 64
    (exp2 with the scale folded in, bf16 p and ds, each warp's 16-row
    share of a 64 x 64 tile, the mask on the diagonal blocks only, the
    GQA group summed) to the plain versions; dk/dv that miss one q head
    of a group, diagonal blocks without their mask, and a K3 that skips a
    block the diagonal crosses each fail it."""
    _assert_twin_within_limit_and_faults_fail(_k2_k3_twin_against_plain(64, 64))


def test_kernel_tolerance_passes_k3_query_chunks_at_d128():
    """The same at D = 128, where a K3 warp takes the 64-query tile 32
    queries at a time, each chunk with its own causal skip and mask test."""
    _assert_twin_within_limit_and_faults_fail(_k2_k3_twin_against_plain(128, 32))


def _k1_tensor_core_arithmetic_bf16(q, k, v, *, drop_rescale=False,
                                    skip_off_by_tile=False):
    """K1 as the tensor-core kernel computes it, in torch, causal: each
    warp's 16 query rows against 64-key tiles; a warp skips a tile wholly
    above the diagonal and masks only a tile the diagonal crosses, by the
    kernel's own tests; the running max m in log2 units, p = exp2(s scale
    log2 e - m) selected to 0 where masked, packed to bf16 against the
    running max before p @ v; the running sum and out rescaled per row by
    exp2(m_old - m_new); every sum f32. ``drop_rescale`` leaves out's
    rescale out, ``skip_off_by_tile`` moves the skip boundary one tile
    down (the diagonal tile is skipped): the faults the limit must catch."""
    Bq, Tq, Hq, Dq = q.shape
    grp = Hq // k.shape[2]
    scale2 = torch.tensor(Dq ** -0.5, dtype=torch.float32) * LOG2E
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(grp, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(grp, dim=2).transpose(1, 2)
    pos = torch.arange(Tq)
    out = torch.zeros(Bq, Hq, Tq, Dq)
    for qw in range(0, Tq, 16):  # a warp's 16 rows
        rows = slice(qw, qw + 16)
        m2 = torch.full((Bq, Hq, 16, 1), NEG)
        l = torch.zeros(Bq, Hq, 16, 1)
        acc = torch.zeros(Bq, Hq, 16, Dq)
        for k0 in range(0, Tq, 64):
            if k0 > qw + 15 - (64 if skip_off_by_tile else 0):
                continue  # all masked
            s = qf[:, :, rows] @ kf[:, :, k0:k0 + 64].transpose(-1, -2)
            ok = torch.ones(16, 64, dtype=torch.bool)
            if k0 + 63 > qw:  # the diagonal crosses the tile
                ok = pos[None, k0:k0 + 64] <= pos[rows, None]
                s = s.masked_fill(~ok, NEG)
            m_new = torch.maximum(m2, s.amax(-1, keepdim=True) * scale2)
            alpha = torch.exp2(m2 - m_new)
            p = torch.where(ok, torch.exp2(s * scale2 - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = (acc if drop_rescale else acc * alpha) + (
                _round_bf16(p) @ vf[:, :, k0:k0 + 64])
            m2 = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128])
def test_kernel_tolerance_passes_k1_tensor_core_tiles_and_fails_faults(d):
    """The bf16 limit holds the tensor-core K1 arithmetic (16-row warps,
    64-key tiles, exp2 with the scale folded in, p packed to bf16 against
    the running max, the per-row rescale, the causal skip) within half of
    itself against both the plain version and the reference's Pallas
    kernel (interpret mode, bf16 in); an out without its rescale and a skip
    boundary one tile off each fail it."""
    b, t, h, k = 1, 512, 4, 2
    q, kk, v, _, _ = _inputs(9, b=b, t=t, h=h, k=k, d=d)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kk, v))
    plain, _ = flash_fwd_reference(tq, tk, tv, causal=True)
    pallas = torch.from_numpy(np.asarray(jax_flash(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kk, v)), causal=True,
        interpret=True), np.float32)).to(torch.bfloat16)
    twin = _k1_tensor_core_arithmetic_bf16(tq, tk, tv)
    assert _over_limit(twin, plain) <= 0.5
    assert _over_limit(twin, pallas) <= 0.5
    for fault in ("drop_rescale", "skip_off_by_tile"):
        bad = _k1_tensor_core_arithmetic_bf16(tq, tk, tv, **{fault: True})
        assert _over_limit(bad, plain) > 1.0, fault


# ------------------------------------------------------------ on the card --


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda")


CARD_CASES = [
    # b, t, s, h, k, d, causal, mode, dtype
    (2, 256, 256, 8, 2, 64, True, "none", torch.bfloat16),
    (1, 1000, 1000, 4, 1, 64, True, "none", torch.bfloat16),
    (1, 300, 200, 4, 2, 32, False, "none", torch.float32),
    (2, 192, 192, 4, 4, 128, True, "none", torch.bfloat16),
    (2, 256, 256, 4, 2, 64, True, "len", torch.bfloat16),
    (2, 256, 256, 4, 2, 64, False, "rows", torch.float32),
    (1, 1000, 1000, 8, 2, 128, True, "none", torch.bfloat16),
    (2, 256, 256, 8, 2, 128, True, "len", torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_kernels_match_plain_on_card(card, case):
    b, t, s, h, k, d, causal, mode, dtype = case
    q, kk, v, g, mask = _inputs(4, b, t, s, h, k, d)
    q, kk, v, g = (torch.from_numpy(a).to(card, dtype) for a in (q, kk, v, g))
    arg = None
    if mode == "len":
        arg = torch.tensor([s - 37, 0][:b], dtype=torch.int32, device=card)
    elif mode == "rows":
        arg = torch.from_numpy(mask).to(card)
    kw = dict(causal=causal, mode=mode, arg=arg)
    n = (flash_fwd.launches, flash_dq.launches, flash_dkv.launches)
    out, lse = flash_fwd(q, kk, v, **kw)
    out2, lse2 = flash_fwd(q, kk, v, **kw)  # K1 repeats bit for bit
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = flash_dq(q, kk, v, g, lse, delta, **kw)
    dk, dv = flash_dkv(q, kk, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_dq.launches, flash_dkv.launches) == (
        n[0] + 2, n[1] + 1, n[2] + 1)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    want_out, want_lse = flash_fwd_reference(q, kk, v, **kw)
    want = (flash_dq_reference(q, kk, v, g, want_lse, delta, **kw),
            *flash_dkv_reference(q, kk, v, g, want_lse, delta, **kw))
    for name, got, ref in [("out", out, want_out), ("lse", lse, want_lse),
                           ("dq", dq, want[0]), ("dk", dk, want[1]),
                           ("dv", dv, want[2])]:
        if name == "lse":
            ok = (got - ref).abs() <= 1e-4 * (1 + ref.abs())
        else:  # the limit follows the plain output's own dtype
            ok = (got.float() - ref.float()).abs() <= kernel_tolerance(ref)
        got, ref = got.float(), ref.float()
        assert bool(torch.isfinite(got).all()), name
        assert bool(ok.all()), (name, (got - ref).abs().max().item())
