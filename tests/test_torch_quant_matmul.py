"""The PyTorch port's weight-only int8 matmul against the reference's Pallas
kernel (run in interpret mode on the CPU), on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.ops.pallas.quant_matmul import (
    quant_matmul as jax_quant_matmul)
from serverless_learn_tpu_torch.ops import build
from serverless_learn_tpu_torch.ops.quant_matmul import (
    STEP_ROWS, TILINGS, WORKSPACE_FLOATS, plan, quant_matmul,
    quant_matmul_reference)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(R, I, O, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, I)).astype(np.float32)
    wq = rng.integers(-127, 128, (I, O)).astype(np.int8)
    scale = ((rng.random(O) + 0.5) * 0.05 / 127).astype(np.float32)
    return x, wq, scale


def _tolerance(dtype):
    # Both sides sum exact bf16 x int8 products in f32, in different orders:
    # f32 round-off of a 256-term sum for f32 output; for bf16 output those
    # sums may round to neighbouring bf16 values, one ulp = 2^-8 relative.
    return dict(rtol=2e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R", [1, 3, 40])
def test_plain_matches_pallas_kernel(monkeypatch, R, dtype):
    monkeypatch.setenv("SLT_QUANT_PALLAS", "1")  # the kernel, not XLA's form
    I, O = 256, 384
    x, wq, scale = _inputs(R, I, O, seed=R)
    want = jax_quant_matmul(jnp.asarray(x, dtype), jnp.asarray(wq),
                            jnp.asarray(scale))
    assert want.dtype == jnp.dtype(dtype)
    got = quant_matmul(torch.from_numpy(x).to(_TORCH[dtype]),
                       torch.from_numpy(wq), torch.from_numpy(scale))
    assert got.dtype == _TORCH[dtype] and got.shape == (R, O)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_tolerance(dtype))


def test_f32_activations_are_rounded_to_bf16():
    """The kernel's contract rounds f32 x to bf16 before the product: an f32
    x that is not a bf16 value gives the result of its bf16 rounding."""
    x = torch.tensor([[1.0 + 2 ** -12]], dtype=torch.float32)
    wq = torch.ones((1, 1), dtype=torch.int8)
    scale = torch.ones(1)
    assert quant_matmul(x, wq, scale).item() == 1.0


def test_leading_dims_and_out_dtype():
    """Leading dims are kept; the output has x's dtype, and another
    ``out_dtype`` is refused (the kernel has no mixed-type variants)."""
    x, wq, scale = _inputs(6, 128, 256)
    x = torch.from_numpy(x).to(torch.bfloat16)
    wq, scale = torch.from_numpy(wq), torch.from_numpy(scale)
    y = quant_matmul(x.reshape(2, 3, 128), wq, scale, out_dtype=torch.bfloat16)
    assert y.shape == (2, 3, 256) and y.dtype == torch.bfloat16
    assert torch.equal(y.reshape(6, 256), quant_matmul(x, wq, scale))
    with pytest.raises(TypeError, match="dtype"):
        quant_matmul(x, wq, scale, out_dtype=torch.float32)


def _int8_to_bf16_like_kernel(wq, offset_undone=True):
    """The kernel's int8 -> bf16 rule on each byte s: the bf16 halves
    0x4300 | (s & 0x7f) = 128 + (s & 0x7f) and 0x4300 | (s & 0x80) = 128 or
    256, subtracted in bf16. ``offset_undone=False`` is the fault that
    leaves the biased s + 128."""
    u = wq.to(torch.int16) & 0xFF
    v = (0x4300 | (u & 0x7F)).view(torch.bfloat16)
    o = (0x4300 | (u & 0x80)).view(torch.bfloat16)
    out = v - o
    return out if offset_undone else out + 128


def test_int8_to_bf16_rule_is_exact_on_every_byte():
    every = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    got = _int8_to_bf16_like_kernel(every)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, every.to(torch.bfloat16))


def _split_k_twin(x, wq, scale, *, drop_split=None, offset_undone=True):
    """The kernel's split-K product in torch: ``plan``'s splits of I, each
    split's partial bf16(x) @ bf16(wq) summed in f32, the partials added in
    split order, then the scale and the cast (the decode and prefill
    kernels' f32 workspace and quant_reduce). ``drop_split`` leaves that
    split's partial out."""
    R, I = x.shape
    pl = plan(R, I, wq.shape[1])
    xb = x.to(torch.bfloat16).float()
    total = torch.zeros(R, wq.shape[1])
    for sp in range(pl.splits):
        a, b = sp * pl.k_split, min(I, (sp + 1) * pl.k_split)
        if sp != drop_split:
            w = _int8_to_bf16_like_kernel(wq[a:b], offset_undone).float()
            total = total + xb[:, a:b] @ w
    return (total * scale).to(x.dtype)


# (R, I, O): decode and prefill plans whose splits leave I ragged
SPLIT_CASES = [(8, 100, 77), (3, 4096, 384), (17, 4096, 384),
               (8, 14336, 256), (40, 14336, 64)]


@pytest.mark.parametrize("shape", SPLIT_CASES)
def test_split_k_partition_covers_i_and_matches_plain(shape):
    """``plan``'s splits cover I exactly (ragged I: 100, 4096, 14336), each
    a whole number of its path's stages; the ordered sum of the split
    partials stays within phase 3's limit of the plain version, while a
    dropped split and an int8 + 128 left in the weights both fail it."""
    R, I, O = shape
    pl = plan(R, I, O)
    assert pl.k_split % STEP_ROWS == 0 and pl.splits > 1
    bounds = [(sp * pl.k_split, min(I, (sp + 1) * pl.k_split))
              for sp in range(pl.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == I
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    x, wq, scale = (torch.from_numpy(a) for a in _inputs(R, I, O, seed=I))
    x = x.to(torch.bfloat16)
    ref = quant_matmul_reference(x, wq, scale).float()
    limit = 2 ** -7 * ref.abs() + 1e-3 * ref.abs().max()

    def fails(got):
        return bool(((got.float() - ref).abs() > limit).any())

    assert not fails(_split_k_twin(x, wq, scale))
    assert fails(_split_k_twin(x, wq, scale, drop_split=1))
    assert fails(_split_k_twin(x, wq, scale, offset_undone=False))


@pytest.mark.parametrize("R, tiling", [(1, "decode_n8"), (8, "decode_n8"),
                                       (9, "decode_n16"), (16, "decode_n16"),
                                       (17, "prefill"), (512, "prefill")])
def test_plan_picks_the_tiling_by_rows(R, tiling):
    pl = plan(R, 4096, 1024)
    assert pl.tiling == tiling and tiling in TILINGS
    assert pl.path == ("prefill" if tiling == "prefill" else "decode")


# Row counts on both sides of each tiling's edge and of the prefill row
# tile, and every llama_8b projection shape with ragged neighbours.
@pytest.mark.parametrize("R", [1, 7, 8, 9, 15, 16, 17, 127, 128, 129, 512,
                               4096])
def test_every_split_fits_the_one_workspace(R):
    """The wrapper keeps one workspace of WORKSPACE_FLOATS a stream, so
    every plan that splits must fit its [splits, R, O] partials there."""
    dims = (64, 100, 1024, 1030, 4096, 4136, 14336, 128256)
    for I in dims:
        for O in dims:
            pl = plan(R, I, O)
            assert pl.splits == 1 or pl.splits * R * O <= WORKSPACE_FLOATS, (
                R, I, O, pl)


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit to a header of csrc/ rebuilds every source that may include
    it, and an edit to one source rebuilds that source alone."""
    (tmp_path / "a.cu").write_text("a")
    (tmp_path / "b.cu").write_text("b")
    (tmp_path / "shared.cuh").write_text("1")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._target(n) for n in "ab"}
    (tmp_path / "shared.cuh").write_text("2")
    after = {n: build._target(n) for n in "ab"}
    assert all(before[n] != after[n] for n in "ab")
    (tmp_path / "a.cu").write_text("a2")
    assert build._target("a") != after["a"]
    assert build._target("b") == after["b"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4096, 1024), (2, 256, 384),
                                   (3, 512, 1024), (4, 256, 384),
                                   (8, 256, 384), (37, 300, 77),
                                   (9, 4096, 1024), (16, 4136, 1024),
                                   (17, 4136, 1024), (200, 512, 384)])
def test_kernel_matches_plain_on_card(card, shape):
    """Decode (up to 16 rows) and prefill tiles, split and unsplit, ragged
    I (4136 is no multiple of a split) and ragged I and O; two launches of
    one case repeat bit for bit."""
    R, I, O = shape
    x, wq, scale = _inputs(R, I, O)
    xc = torch.from_numpy(x).to(card, torch.bfloat16)
    wc, sc = torch.from_numpy(wq).to(card), torch.from_numpy(scale).to(card)
    before = quant_matmul.launches
    got = quant_matmul(xc, wc, sc)
    again = quant_matmul(xc, wc, sc)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 2
    assert torch.equal(got, again)
    want = quant_matmul_reference(xc, wc, sc).float()
    # Summed in another order than cuBLAS's f32 product: a bf16 output may
    # round to a neighbouring value (one ulp <= 2^-7 relative), and the f32
    # order moves a sum by up to ~1e-3 of the largest output.
    err = (got.float() - want).abs()
    assert bool((err <= 2 ** -7 * want.abs()
                 + 1e-3 * want.abs().max()).all()), err.max().item()


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph_matches_eager(card):
    """Split calls share their stream's workspace: a decode and a prefill
    call that both split, captured into a CUDA graph (on another stream,
    so with another workspace) and replayed, give the eager results bit
    for bit."""
    args = []
    for R, I, O in [(8, 4096, 1024), (512, 4096, 1024)]:
        assert plan(R, I, O).splits > 1
        x, wq, scale = _inputs(R, I, O, seed=R)
        args.append((torch.from_numpy(x).to(card, torch.bfloat16),
                     torch.from_numpy(wq).to(card),
                     torch.from_numpy(scale).to(card)))
    want = [quant_matmul(*a) for a in args]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [quant_matmul(*a) for a in args]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_kernel_from_two_threads_on_one_stream(card):
    """Split calls from two threads share the default stream's workspace:
    each call's split kernel and reduce stay together, so every result
    equals the one-thread result bit for bit."""
    import threading

    x, wq, scale = _inputs(8, 4096, 1024)
    args = (torch.from_numpy(x).to(card, torch.bfloat16),
            torch.from_numpy(wq).to(card), torch.from_numpy(scale).to(card))
    want = quant_matmul(*args)
    outs = [[], []]

    def work(i):
        for _ in range(50):
            outs[i].append(quant_matmul(*args))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs[0] + outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 4096, 1024), (1, 4096, 4096,
                                                          4096)])
def test_input_gradient_on_card_matches_plain(card, shape):
    """QLoRA's gradient through the int8 base on the card: the Function's
    forward launches K6 once and its dx (the converted weight's product)
    holds to the plain version's autograd gradient. The Function rounds
    each term's scale and g = dy * scale to bf16, two independent errors
    within +-2^-8 of the term: over the contraction they add in quadrature
    to sigma = 0.82 * 2^-8 * sqrt(sum t^2), t = dy scale wq, and 6 * 2^-8
    is 7.3 sigma; each side rounds its output to bf16 (2^-8 of |dx| each).
    A dx 5 % off fails the same limit."""
    from serverless_learn_tpu_torch.ops.quant_matmul import QuantMatmul

    B, R, I, O = shape
    x, wq, scale = _inputs(B * R, I, O)
    dy = np.random.default_rng(1).standard_normal((B, R, O))
    wc, sc = torch.from_numpy(wq).to(card), torch.from_numpy(scale).to(card)
    g = torch.from_numpy(dy).to(card, torch.bfloat16)
    xt = torch.from_numpy(x.reshape(B, R, I)).to(card, torch.bfloat16)
    xt.requires_grad_()
    before = quant_matmul.launches
    QuantMatmul.apply(xt, wc, sc).backward(g)
    assert quant_matmul.launches == before + 1
    xr = xt.detach().clone().requires_grad_()
    quant_matmul_reference(xr, wc, sc).backward(g)
    want, got = xr.grad.float(), xt.grad.float()
    limit = (6 * 2 ** -8 * ((g.float() * sc).square()
                            @ wc.float().square().t()).sqrt()
             + 2 ** -7 * want.abs())
    err = (got - want).abs()
    assert bool((err <= limit).all()), (err / limit).max().item()
    assert not bool(((1.05 * got - want).abs() <= limit).all())
