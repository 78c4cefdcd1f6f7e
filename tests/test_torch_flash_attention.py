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


def _box(x, b, r0, next_row=False):
    """Rows [r0, r0 + 64) of batch row ``b`` of x [B, N, heads, D] as a TMA
    box loads them through the kernels' 4-D map: rows past N are zero.
    ``next_row`` reads them as a map over B·N would, from the rows that
    follow in memory, the next batch row's first (zeros past the tensor)."""
    n = x.shape[1]
    src = (x.reshape(-1, *x.shape[2:])[b * n + r0:b * n + r0 + 64] if next_row
           else x[b, r0:r0 + 64])
    pad = 64 - src.shape[0]
    return torch.cat([src, src.new_zeros(pad, *src.shape[1:])]) if pad else src


def _stat_box(stat, b, h, r0):
    """64 values of lse or delta [B, H, T] from row r0 of (b, h) through the
    kernels' 1-D map: past T the next head's, zeros past the tensor."""
    flat = stat.reshape(-1)
    at = (b * stat.shape[1] + h) * stat.shape[2] + r0
    src = flat[at:at + 64]
    return torch.cat([src, src.new_zeros(64 - src.shape[0])])


def _dot16(a, b):
    """a [m, D] b [n, D]^T as wgmma sums it: k-slices of 16, in order."""
    out = torch.zeros(a.shape[0], b.shape[0])
    for kk in range(0, a.shape[1], 16):
        out = out + a[:, kk:kk + 16] @ b[:, kk:kk + 16].T
    return out


def _acc16(a, b):
    """a [m, K] @ b [K, n] in k-slices of 16, in order."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for kk in range(0, a.shape[1], 16):
        out = out + a[:, kk:kk + 16] @ b[kk:kk + 16]
    return out


def _k2_k3_wgmma_twin(q, k, v, dout, lse, delta, *, drop_head=None,
                      unmasked_diagonal=False, skip_off_by_tile=False,
                      next_row=False):
    """K2 and K3 as the wgmma kernels compute them, in torch, causal:
    (dq, dk, dv) in bf16.

    * K3: a block owns 128 keys of a K/V head, 64 per consumer; the stages
      bring (Q, dO, lse, delta) of the query tiles (128 queries at D <= 64,
      64 at D = 128) from the diagonal on, for each q head of the group in
      turn. S^T = K Q^T and dP^T = V dO^T (k-slices of 16 over D); p =
      exp2(s scale log2 e - lse log2 e); p and dS^T = p (dP^T - delta)
      scale rounded to bf16; dV += P^T dO and dK += dS^T Q in k-slices of
      16 over the queries, summed in registers over the group and the
      tiles.
    * K2: a block owns 128 queries, 64 per consumer, against the 128-key
      stages from key 0 to the diagonal: S = Q K^T, dP = dO V^T, dq +=
      dS K.
    * Skips and masks by the kernels' own tests: a consumer skips a tile
      wholly above the diagonal and masks only a diagonal or ragged tile,
      where a query past T (K3) or a key past S (K2) also gets dS = 0.

    The faults the limit must catch: ``drop_head`` leaves that q head out
    of K3's group sum, ``unmasked_diagonal`` skips the masks,
    ``skip_off_by_tile`` moves both skip tests one stage down (the diagonal
    stage is skipped), and ``next_row`` loads every box through a map over
    B·T (see ``_box``)."""
    Bq, Tq, Hq, Dq = q.shape
    Sk, Kq = k.shape[1], k.shape[2]
    grp = Hq // Kq
    scale = Dq ** -0.5
    scale2 = float(torch.tensor(scale, dtype=torch.float32) * LOG2E)
    floor = float(torch.tensor(NEG * 0.5, dtype=torch.float32) / scale)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, dout))
    pos = torch.arange(64)

    bk = 128  # keys of a K2 stage
    kpos = torch.arange(bk)
    dq = torch.zeros(Bq, Tq, Hq, Dq)
    for b in range(Bq):
        for h in range(Hq):
            for q0 in range(0, Tq, 128):
                n_tiles = min(-(-Sk // bk), (q0 + 127) // bk + 1)
                for qw0 in (q0, q0 + 64):
                    if qw0 >= Tq:
                        continue
                    Qt = _box(qf, b, qw0, next_row)[:, h]
                    Gt = _box(gf, b, qw0, next_row)[:, h]
                    L = _stat_box(lse, b, h, qw0)[:, None]
                    Dl = _stat_box(delta, b, h, qw0)[:, None]
                    acc = torch.zeros(64, Dq)
                    for k0 in range(0, bk * n_tiles, bk):
                        if k0 > qw0 + 63 - (bk if skip_off_by_tile else 0):
                            continue  # all masked
                        Kt = torch.cat([_box(kf, b, r, next_row)
                                        for r in range(k0, k0 + bk, 64)])
                        Vt = torch.cat([_box(vf, b, r, next_row)
                                        for r in range(k0, k0 + bk, 64)])
                        Kt, Vt = Kt[:, h // grp], Vt[:, h // grp]
                        p = torch.exp2(_dot16(Qt, Kt) * scale2 - L * LOG2E)
                        dp = _dot16(Gt, Vt)
                        ds = p * (dp - Dl) * scale
                        if (qw0 + 64 > Tq or k0 + bk > Sk or k0 + bk - 1 > qw0) \
                                and not unmasked_diagonal:
                            qq, kk = qw0 + pos[:, None], k0 + kpos[None, :]
                            p = torch.where((qq < Tq) & (kk < Sk) & (kk <= qq),
                                            p, 0.0)
                            ds = torch.where(kk < Sk, p * (dp - Dl) * scale,
                                             0.0)
                        acc = acc + _acc16(_round_bf16(ds), Kt)
                    n = min(64, Tq - qw0)
                    dq[b, qw0:qw0 + n, h] = acc[:n]
    qs = 128 if Dq <= 64 else 64  # queries of a K3 stage
    qpos = torch.arange(qs)
    dk = torch.zeros(Bq, Sk, Kq, Dq)
    dv = torch.zeros(Bq, Sk, Kq, Dq)
    for b in range(Bq):
        for kh in range(Kq):
            for k0 in range(0, Sk, 128):
                for kw0 in (k0, k0 + 64):
                    if kw0 >= Sk:
                        continue
                    Kt = _box(kf, b, kw0, next_row)[:, kh]
                    Vt = _box(vf, b, kw0, next_row)[:, kh]
                    adk, adv = torch.zeros(64, Dq), torch.zeros(64, Dq)
                    for h in range(kh * grp, (kh + 1) * grp):
                        for q0 in range(k0, Tq, qs):  # from the diagonal
                            if kw0 > q0 + qs - 1 - (qs if skip_off_by_tile
                                                    else 0):
                                continue  # all masked
                            Qt = torch.cat([_box(qf, b, r, next_row)
                                            for r in range(q0, q0 + qs, 64)])
                            Gt = torch.cat([_box(gf, b, r, next_row)
                                            for r in range(q0, q0 + qs, 64)])
                            Qt, Gt = Qt[:, h], Gt[:, h]
                            L = torch.cat([_stat_box(lse, b, h, r) for r in
                                           range(q0, q0 + qs, 64)])[None, :]
                            Dl = torch.cat([_stat_box(delta, b, h, r) for r in
                                            range(q0, q0 + qs, 64)])[None, :]
                            sT = _dot16(Kt, Qt)  # [keys, queries]
                            p = torch.exp2(sT * scale2 - L * LOG2E)
                            dpT = _dot16(Vt, Gt)
                            ds = p * (dpT - Dl) * scale
                            if (q0 + qs > Tq or kw0 + 64 > Sk or kw0 + 63 > q0) \
                                    and not unmasked_diagonal:
                                kk, qq = kw0 + pos[:, None], q0 + qpos[None, :]
                                ok = ((kk < Sk) & (qq < Tq) & (kk <= qq)
                                      & ~(sT <= floor))
                                p = torch.where(ok, p, 0.0)
                                ds = torch.where(qq < Tq,
                                                 p * (dpT - Dl) * scale, 0.0)
                            if h == drop_head:
                                continue
                            adv = adv + _acc16(_round_bf16(p), Gt)
                            adk = adk + _acc16(_round_bf16(ds), Qt)
                    n = min(64, Sk - kw0)
                    dk[b, kw0:kw0 + n, kh] = adk[:n]
                    dv[b, kw0:kw0 + n, kh] = adv[:n]
    return dq.to(torch.bfloat16), dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def _over_limit(got, ref):
    """The worst |got - ref| / kernel_tolerance(ref)."""
    err = (got.float() - ref.float()).abs()
    return (err / kernel_tolerance(ref)).max().item()


def _bf16_inputs(seed, **shape):
    q, kk, v, g, _ = _inputs(seed, **shape)
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, kk, v, g))


def _plain_grads(q, kk, v, g):
    """The plain versions' (dq, dk, dv), causal, and the lse and delta the
    kernels read."""
    out, lse = flash_fwd_reference(q, kk, v, causal=True)
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    kw = dict(causal=True)
    return ((flash_dq_reference(q, kk, v, g, lse, delta, **kw),
             *flash_dkv_reference(q, kk, v, g, lse, delta, **kw)), lse, delta)


def _ratios(got, want):
    return {name: _over_limit(x, ref)
            for name, x, ref in zip(("dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("d", [32, 64, 128])
def test_kernel_tolerance_passes_k2_k3_wgmma_tiles_and_fails_their_faults(d):
    """The bf16 limit the card tests and chip_smoke.py hold K2 and K3 to
    holds their wgmma tiles (the twin above: 128-row blocks of two 64-row
    consumers, 64-row stages in the producer's order, k-slices of 16, exp2
    with the scale folded in, bf16 p and ds, the masks on the diagonal
    tiles only, the GQA group summed) against the plain versions and the
    reference's Pallas kernels (interpret mode, bf16 in), T = S = 256, 4 q
    heads on 2 K/V heads; dk/dv that miss one q head of a group, diagonal
    tiles without their mask, and skip tests one tile off each fail it."""
    q, kk, v, g = _bf16_inputs(8, b=1, t=256, h=4, k=2, d=d)
    want, lse, delta = _plain_grads(q, kk, v, g)

    def loss(q, k, v):
        out = jax_flash(q, k, v, causal=True, interpret=True)
        return (out.astype(jnp.float32) * jnp.asarray(g.float().numpy())).sum()

    pallas = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
              for x in jax.grad(loss, argnums=(0, 1, 2))(
                  *(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                    for x in (q, kk, v)))]
    twin = _k2_k3_wgmma_twin(q, kk, v, g, lse, delta)
    assert max(_ratios(twin, want).values()) <= 1.0, _ratios(twin, want)
    assert max(_ratios(twin, pallas).values()) <= 1.0, _ratios(twin, pallas)
    bad = {fault: _ratios(_k2_k3_wgmma_twin(q, kk, v, g, lse, delta, **kw),
                          want)
           for fault, kw in [("drop_head", dict(drop_head=1)),
                             ("unmasked_diagonal", dict(unmasked_diagonal=True)),
                             ("skip_off_by_tile", dict(skip_off_by_tile=True))]}
    assert bad["drop_head"]["dk"] > 1.0 and bad["drop_head"]["dv"] > 1.0
    assert bad["unmasked_diagonal"]["dq"] > 1.0
    assert bad["unmasked_diagonal"]["dk"] > 1.0
    assert all(r > 1.0 for r in bad["skip_off_by_tile"].values()), bad


def test_kernel_tolerance_passes_ragged_k2_k3_tiles_and_fails_a_tail_from_the_next_row():
    """Ragged T = S = 200 in two batch rows, D = 64: the twin's last boxes
    (rows 192-255, past T zero through the 4-D map) stay within the limit.
    Loaded through a map over B·T, the same boxes read batch row 1's first
    rows into batch row 0's tail: with an inf there (batch row 1's first q,
    k, v and dO rows), 0 x inf puts NaN into batch row 0's dq, dk and dv,
    which the limit fails; through the 4-D map batch row 0 stays within
    it."""
    q, kk, v, g = _bf16_inputs(10, b=2, t=200, h=4, k=2, d=64)
    want, lse, delta = _plain_grads(q, kk, v, g)
    twin = _k2_k3_wgmma_twin(q, kk, v, g, lse, delta)
    assert max(_ratios(twin, want).values()) <= 1.0, _ratios(twin, want)
    for x in (q, kk, v, g):
        x[1, :2] = float("inf")
    want0, _, _ = _plain_grads(q[:1], kk[:1], v[:1], g[:1])
    _, lse, delta = _plain_grads(q, kk, v, g)
    row0 = [x[:1] for x in _k2_k3_wgmma_twin(q, kk, v, g, lse, delta)]
    assert max(_ratios(row0, want0).values()) <= 1.0, _ratios(row0, want0)
    trap = [x[:1] for x in _k2_k3_wgmma_twin(q, kk, v, g, lse, delta,
                                             next_row=True)]
    assert not any(r <= 1.0 for r in _ratios(trap, want0).values())


def _k1_tensor_core_arithmetic_bf16(q, k, v, *, drop_rescale=False,
                                    skip_off_by_tile=False):
    """K1 as the wgmma kernel computes it, in torch, causal: each
    consumer's 64 query rows against 128-key stages; a consumer skips a
    stage wholly above the diagonal and masks only a stage the diagonal
    crosses, by the kernel's own tests; the running max m in log2 units,
    p = exp2(s scale log2 e - m) selected to 0 where masked, packed to
    bf16 against the running max before p @ v; the running sum and out
    rescaled per row by exp2(m_old - m_new); every sum f32.
    ``drop_rescale`` leaves out's rescale out, ``skip_off_by_tile`` moves
    the skip boundary one stage down (the diagonal stage is skipped): the
    faults the limit must catch."""
    Bq, Tq, Hq, Dq = q.shape
    rows_c, keys = 64, 128
    grp = Hq // k.shape[2]
    scale2 = torch.tensor(Dq ** -0.5, dtype=torch.float32) * LOG2E
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(grp, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(grp, dim=2).transpose(1, 2)
    pos = torch.arange(Tq)
    out = torch.zeros(Bq, Hq, Tq, Dq)
    for qw in range(0, Tq, rows_c):  # a consumer's 64 rows
        rows = slice(qw, qw + rows_c)
        m2 = torch.full((Bq, Hq, rows_c, 1), NEG)
        l = torch.zeros(Bq, Hq, rows_c, 1)
        acc = torch.zeros(Bq, Hq, rows_c, Dq)
        for k0 in range(0, Tq, keys):
            if k0 > qw + rows_c - 1 - (keys if skip_off_by_tile else 0):
                continue  # all masked
            s = qf[:, :, rows] @ kf[:, :, k0:k0 + keys].transpose(-1, -2)
            ok = torch.ones(rows_c, keys, dtype=torch.bool)
            if k0 + keys - 1 > qw:  # the diagonal crosses the stage
                ok = pos[None, k0:k0 + keys] <= pos[rows, None]
                s = s.masked_fill(~ok, NEG)
            m_new = torch.maximum(m2, s.amax(-1, keepdim=True) * scale2)
            alpha = torch.exp2(m2 - m_new)
            p = torch.where(ok, torch.exp2(s * scale2 - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = (acc if drop_rescale else acc * alpha) + (
                _round_bf16(p) @ vf[:, :, k0:k0 + keys])
            m2 = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128])
def test_kernel_tolerance_passes_k1_tensor_core_tiles_and_fails_faults(d):
    """The bf16 limit holds the wgmma K1 arithmetic (64-row consumers,
    128-key stages, exp2 with the scale folded in, p packed to bf16 against
    the running max, the per-row rescale, the causal skip) within half of
    itself against both the plain version and the reference's Pallas
    kernel (interpret mode, bf16 in); an out without its rescale and a skip
    boundary one stage off each fail it."""
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
    # the edges of K2's and K3's 128-row blocks and 64-row boxes, with a T
    # that is not a multiple of 4 (the lse/delta boxes' rounded start)
    *[(2, t, t, 4, 2, d, True, "none", torch.bfloat16)
      for t in (127, 128, 129, 255) for d in (32, 64, 128)],
    (2, 129, 129, 4, 2, 64, True, "len", torch.bfloat16),
    (2, 255, 255, 8, 2, 128, False, "rows", torch.bfloat16),
    # K1's 128-key stages and 64-row consumers: T != S (causal aligned at
    # the top left; a single query row), ragged at the block edges, every
    # head dim in every mask mode, GQA and H == K
    *[(2, t, s, 4, 2, d, c, "none", torch.bfloat16)
      for t, s, c in ((1, 200, False), (63, 200, True), (300, 520, True),
                      (520, 300, True))
      for d in (32, 64, 128)],
    *[(2, t, t, 8, 2, d, c, mode, torch.bfloat16)
      for t in (383, 384, 385) for d in (32, 128)
      for c, mode in ((True, "len"), (False, "rows"))],
    (2, 300, 520, 8, 2, 64, False, "rows", torch.bfloat16),
    (2, 520, 300, 8, 8, 64, True, "len", torch.bfloat16),
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
    out2, lse2 = flash_fwd(q, kk, v, **kw)  # K1-K3 repeat bit for bit
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = flash_dq(q, kk, v, g, lse, delta, **kw)
    dk, dv = flash_dkv(q, kk, v, g, lse, delta, **kw)
    dq2 = flash_dq(q, kk, v, g, lse, delta, **kw)
    dk2, dv2 = flash_dkv(q, kk, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_dq.launches, flash_dkv.launches) == (
        n[0] + 2, n[1] + 2, n[2] + 2)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2)
    assert torch.equal(dv, dv2)
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


@pytest.mark.cuda
def test_nonfinite_inputs_on_card(card):
    """Phase 14a's flash cases: a NaN or +inf in q, k, v or dO reaches
    through K1-K3 exactly the outputs it reaches in the plain versions,
    in bf16 and f32."""
    import math

    import chip_smoke as cs
    from serverless_learn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=card).manual_seed(14)
    B, T, H, KH, D = (cs.NF_FLASH[x] for x in ("B", "T", "H", "KH", "D"))
    for dt in (torch.bfloat16, torch.float32):
        mk = lambda *shape: torch.randn(  # noqa: E731
            *shape, device=card, generator=g).to(dt)
        inputs = {"q": mk(B, T, H, D), "k": mk(B, T, KH, D),
                  "v": mk(B, T, KH, D), "dout": mk(B, T, H, D)}

        def fwd_delta(x):
            out, lse = fa.flash_fwd_reference(x["q"], x["k"], x["v"],
                                              causal=True)
            delta = (x["dout"].float() * out.float()).sum(-1).permute(
                0, 2, 1).contiguous()
            return out, lse, delta

        def plain(x):
            out, lse, delta = fwd_delta(x)
            args = (x["q"], x["k"], x["v"], x["dout"], lse, delta)
            dk, dv = fa.flash_dkv_reference(*args, causal=True)
            return {"out": out, "lse": lse, "dk": dk, "dv": dv,
                    "dq": fa.flash_dq_reference(*args, causal=True)}

        def kern(x):
            _, lse, delta = fwd_delta(x)
            out, klse = fa.flash_fwd(x["q"], x["k"], x["v"], causal=True)
            args = (x["q"], x["k"], x["v"], x["dout"], lse, delta)
            dk, dv = fa.flash_dkv(*args, causal=True)
            return {"out": out, "lse": klse, "dk": dk, "dv": dv,
                    "dq": fa.flash_dq(*args, causal=True)}

        for name, key, idx, value in cs.NF_FLASH_CASES:
            _, faults = cs.nonfinite_case(torch, kern, plain, inputs, key,
                                          idx, value)
            assert not faults, (dt, name, faults)
