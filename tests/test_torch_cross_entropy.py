"""The port's fused cross-entropy (K4 forward, K5 backward) against the
reference's ``fused_cross_entropy_with_integer_labels``, on the same numpy
inputs. At V = 768 (three of the reference's 256-wide vocab tiles) the
reference runs its Pallas kernels in interpret mode, as
``tests/test_fused_ce.py`` runs them on the CPU; at V = 1000 (no multiple
of 256) it takes optax, and the port, which has no such condition, must
still agree. Rows number 77 or 2 x 39 (no multiple of the reference's
128-row tile), and the causal form reads the strided ``logits[:, :-1]``.

On the CPU the port's wrappers run their plain PyTorch versions; the
``cuda``-marked test holds the hand-written kernels against those plain
versions on the card and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.ops.pallas.cross_entropy import (
    fused_cross_entropy_with_integer_labels as jax_fused_ce)
from serverless_learn_tpu_torch.ops import cross_entropy as ce

# Both sides upcast to f32 and sum the same exps in another order: the loss
# to 1e-6 relative. dx in bf16 is one rounding of nearly the same f32 value
# on each side: at most one bf16 ulp, 2^-7 of the value. dx in f32 differs
# by the two libraries' exp: 1e-5 relative. XLA's CPU backend flushes an
# exp below the smallest normal float (2^-126) to zero, so dx = p * g may
# differ by 2^-126 * |g| (|g| < 2 here) beside a -80 logit: atol 2^-125.
LOSS_TOL = dict(rtol=1e-6, atol=0)
DX_TOL = {"float32": dict(rtol=1e-5, atol=2 ** -125),
          "bfloat16": dict(rtol=2 ** -7, atol=2 ** -125)}


def _inputs(seed, lead, V):
    """Logits ~ 4 N(0, 1) with a row of equal logits and rows with a +80
    and a -80 outlier; labels at column 0, V - 1 and inside the last
    partial 256-wide tile; a non-uniform loss cotangent."""
    rng = np.random.default_rng(seed)
    x = (4 * rng.standard_normal(lead + (V,))).astype(np.float32)
    rows = x.reshape(-1, V)
    rows[0] = 1.5
    rows[1, 3] = 80.0
    rows[2, 5] = -80.0
    labels = rng.integers(0, V, lead).astype(np.int32)
    flat = labels.reshape(-1)
    flat[:4] = [0, V - 1, V - 3, 3]
    w = (1.0 + rng.random(lead)).astype(np.float32)
    return x, labels, w


def _jax(x, labels, w, dtype):
    xj = jnp.asarray(x).astype(dtype)
    lab = jnp.asarray(labels)
    loss = jax_fused_ce(xj, lab)
    dx = jax.grad(lambda a: (jax_fused_ce(a, lab) * w).sum())(xj)
    return np.asarray(loss), np.asarray(dx.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [768, 1000])
def test_rows_match_reference(V, dtype):
    x, labels, w = _inputs(0, (77,), V)
    want_loss, want_dx = _jax(x, labels, w, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss = ce.fused_cross_entropy_with_integer_labels(
        xt, torch.from_numpy(labels))
    (loss * torch.from_numpy(w)).sum().backward()
    assert loss.dtype == torch.float32 and xt.grad.dtype == xt.dtype
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, **LOSS_TOL)
    np.testing.assert_allclose(xt.grad.float().numpy(), want_dx,
                               **DX_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("V", [768, 1000])
def test_causal_view_matches_reference(V, dtype):
    """``next_token_cross_entropy`` on [B, T, V] against the reference on
    the strided ``logits[:, :-1]``; dx lands in one [B, T, V] buffer whose
    last position is zero, and the generic function on the view agrees."""
    B, T = 2, 40
    x, tokens, w = _inputs(1, (B, T), V)
    want_loss, want_dx = _jax(x[:, :-1], tokens[:, 1:], w[:, 1:], dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    loss = ce.next_token_cross_entropy(xt, torch.from_numpy(tokens))
    (loss * torch.from_numpy(w[:, 1:])).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, **LOSS_TOL)
    assert xt.grad.shape == (B, T, V)
    assert not xt.grad[:, -1].any()
    np.testing.assert_allclose(xt.grad[:, :-1].float().numpy(), want_dx,
                               **DX_TOL[dtype])
    view = xt.detach()[:, :-1].requires_grad_()
    assert not view.is_contiguous()
    generic = ce.fused_cross_entropy_with_integer_labels(
        view, torch.from_numpy(tokens[:, 1:]))
    (generic * torch.from_numpy(w[:, 1:])).sum().backward()
    torch.testing.assert_close(generic.detach(), loss.detach(), rtol=0,
                               atol=0)
    torch.testing.assert_close(view.grad, xt.grad[:, :-1], rtol=0, atol=0)


def test_labels_outside_the_vocab_pick_nothing():
    """As in the reference's kernel: the loss is the lse and dx has no
    onehot (V = 768 runs the reference's Pallas kernel)."""
    x, labels, w = _inputs(2, (16,), 768)
    labels[:2] = [-1, 768]
    want_loss, want_dx = _jax(x, labels, w, "float32")
    xt = torch.from_numpy(x).requires_grad_()
    loss = ce.fused_cross_entropy_with_integer_labels(
        xt, torch.from_numpy(labels))
    (loss * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, **LOSS_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **DX_TOL["float32"])
    _, lse = ce.cross_entropy_fwd_reference(xt.detach(),
                                            torch.from_numpy(labels))
    np.testing.assert_array_equal(loss.detach().numpy()[:2], lse.numpy()[:2])


def _ratio(err, limit):
    return (err / limit).max().item()


def _check_case(seed=3, N=77, V=1000):
    g = torch.Generator().manual_seed(seed)
    x = (4 * torch.randn(N, V, generator=g)).bfloat16()
    labels = torch.randint(0, V, (N,), generator=g)
    labels[:3] = torch.tensor([0, V - 1, V - 40])
    gg = torch.rand(N, generator=g) / N
    loss, lse = ce.cross_entropy_fwd_reference(x, labels)
    return x, labels, gg, loss, lse, ce.cross_entropy_bwd_reference(
        x, labels, lse, gg)


def test_check_passes_another_summation_order():
    """An honest second computation (f64 sums, exps of x - max in f64)
    passes the limits the card's check uses."""
    x, labels, gg, loss, lse, dx = _check_case()
    xd = x.double()
    m = xd.amax(-1, keepdim=True)
    lse64 = (m + torch.log(torch.exp(xd - m).sum(-1, keepdim=True)))[:, 0]
    loss64 = lse64 - xd.gather(-1, labels[:, None])[:, 0]
    p = torch.exp(xd - lse64[:, None])
    p[torch.arange(len(labels)), labels] -= 1
    dx64 = (p * gg.double()[:, None]).bfloat16()
    lim = ce.fwd_tolerance(lse)
    assert _ratio((loss64 - loss).abs(), lim) <= 1
    assert _ratio((lse64 - lse).abs(), lim) <= 1
    assert _ratio((dx64.float() - dx.float()).abs(),
                  ce.bwd_tolerance(dx)) <= 1


@pytest.mark.parametrize("fault", ["k5_zero_off_label",
                                   "k4_drop_last_256_columns"])
def test_check_fails_planted_faults(fault):
    """The limits have teeth: a K5 that writes zero everywhere but the
    label, and a K4 that skips the last 256 vocab columns, both fail."""
    x, labels, gg, loss, lse, dx = _check_case()
    if fault == "k5_zero_off_label":
        bad = torch.zeros_like(dx)
        rows = torch.arange(len(labels))
        bad[rows, labels] = dx[rows, labels]
        assert _ratio((bad.float() - dx.float()).abs(),
                      ce.bwd_tolerance(dx)) > 1
    else:
        _, bad_lse = ce.cross_entropy_fwd_reference(x[:, :-256], labels)
        bad_loss = bad_lse - (lse - loss)  # the label's logit still read
        lim = ce.fwd_tolerance(lse)
        assert _ratio((bad_lse - lse).abs(), lim) > 1
        assert _ratio((bad_loss - loss).abs(), lim) > 1


def test_cpu_runs_the_plain_versions():
    x, labels, gg, loss, lse, dx = _check_case()
    before = (ce.cross_entropy_fwd.launches, ce.cross_entropy_bwd.launches)
    got_loss, got_lse = ce.cross_entropy_fwd(x, labels)
    out = torch.empty_like(dx)
    got_dx = ce.cross_entropy_bwd(x, labels, lse, gg, out=out)
    assert got_dx is out
    assert (ce.cross_entropy_fwd.launches,
            ce.cross_entropy_bwd.launches) == before
    for got, want in ((got_loss, loss), (got_lse, lse), (got_dx, dx)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    return torch.device("cuda")


CARD_CASES = [
    # name, lead shape, V, dtype
    ("ragged_v", (77,), 1000, torch.bfloat16),
    ("odd_v_unaligned_rows", (50,), 1001, torch.bfloat16),
    ("f32", (64,), 5000, torch.float32),
    ("causal_view", (2, 129), 4096, torch.bfloat16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: c[0])
def test_kernels_match_plain_on_card(card, case):
    name, lead, V, dtype = case
    x, labels, w = _inputs(5, lead, V)
    x = torch.from_numpy(x).to(card, dtype)
    labels = torch.from_numpy(labels).to(card)
    g = torch.from_numpy(w).to(card)
    if name == "causal_view":
        x, labels, g = x[:, :-1], labels[:, 1:], g[:, 1:].contiguous()
        g = g[:1, :1].expand_as(g)  # stride 0, as .mean()'s backward gives
    n = (ce.cross_entropy_fwd.launches, ce.cross_entropy_bwd.launches)
    loss, lse = ce.cross_entropy_fwd(x, labels)
    dx = ce.cross_entropy_bwd(x, labels, lse, g)
    torch.cuda.synchronize()
    assert (ce.cross_entropy_fwd.launches,
            ce.cross_entropy_bwd.launches) == (n[0] + 1, n[1] + 1)
    want_loss, want_lse = ce.cross_entropy_fwd_reference(x, labels)
    want_dx = ce.cross_entropy_bwd_reference(x, labels, want_lse, g)
    lim = ce.fwd_tolerance(want_lse)
    assert bool(((loss - want_loss).abs() <= lim).all())
    assert bool(((lse - want_lse).abs() <= lim).all())
    assert dx.dtype == dtype and dx.shape == x.shape
    assert bool(((dx.float() - want_dx.float()).abs()
                 <= ce.bwd_tolerance(want_dx)).all())
