"""The PyTorch port's weight-only int8 matmul against the reference's Pallas
kernel (run in interpret mode on the CPU), on the same numpy inputs."""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.ops.pallas.quant_matmul import (
    quant_matmul as jax_quant_matmul)
from serverless_learn_tpu_torch.ops import build
from serverless_learn_tpu_torch.ops.quant_matmul import (
    GEOMETRY, PREFILL_TILE_COLS, PREFILL_TILE_ROWS, STEP_ROWS, TILINGS,
    WORKSPACE_FLOATS, plan, quant_matmul, quant_matmul_reference)

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


@pytest.mark.parametrize("R, I, O, tiling", [
    (1, 4096, 1024, "decode_n8"), (8, 4096, 1024, "decode_n8"),
    (9, 4096, 1024, "decode_n16"), (16, 4096, 1024, "decode_n16"),
    (17, 4096, 1024, "prefill"), (512, 4096, 1024, "prefill"),
    # by alignment: TMA wants 16-byte rows, I % 8 == 0 (bf16 x) and O % 16
    # == 0 (int8 wq); the rest take the mma.sync tiling
    (4096, 4136, 1024, "prefill"), (17, 100, 77, "prefill_mma"),
    (512, 4100, 1024, "prefill_mma"), (512, 4096, 1032, "prefill_mma"),
    (16, 100, 77, "decode_n16")])
def test_plan_picks_the_tiling_by_rows(R, I, O, tiling):
    pl = plan(R, I, O)
    assert pl.tiling == tiling and tiling in TILINGS
    assert pl.path == ("decode" if tiling.startswith("decode")
                       else "prefill")


# The projections of llama_8b and Mixtral-8x7B (attention, experts,
# lm_heads), and ragged neighbours.
MODEL_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                (4096, 128256), (4096, 32000)]


# Row counts on both sides of each tiling's edge and of the prefill row
# tile, and every llama_8b projection shape with ragged neighbours.
@pytest.mark.parametrize("R", [1, 7, 8, 9, 15, 16, 17, 127, 128, 129, 512,
                               4096])
def test_every_split_fits_the_one_workspace(R):
    """The wrapper keeps one workspace of WORKSPACE_FLOATS a stream, so
    every plan that splits must fit its [splits, R, O] partials there."""
    dims = (64, 100, 1024, 1030, 4096, 4136, 14336, 32000, 128256)
    for I in dims:
        for O in dims:
            pl = plan(R, I, O)
            assert pl.splits == 1 or pl.splits * R * O <= WORKSPACE_FLOATS, (
                R, I, O, pl)


def test_every_model_shape_fits_at_every_prefill_row_count():
    """Every llama_8b and Mixtral projection at every row count from 17 to
    4,096 takes the wgmma tiling, splits into whole stages that cover I,
    keeps its blocks within one wave where it splits, and fits the
    workspace."""
    for I, O in MODEL_SHAPES:
        for R in range(17, 4097):
            pl = plan(R, I, O)
            assert pl.tiling == "prefill", (R, I, O, pl)
            assert pl.k_split % STEP_ROWS == 0
            assert (pl.splits - 1) * pl.k_split < I <= pl.splits * pl.k_split
            tiles = -(-R // PREFILL_TILE_ROWS) * -(-O // PREFILL_TILE_COLS)
            assert pl.splits == 1 or pl.splits * tiles <= 132, (R, I, O, pl)
            assert pl.splits == 1 or pl.splits * R * O <= WORKSPACE_FLOATS


def test_plan_geometry_is_the_kernels():
    """plan()'s copy of the tile geometry equals the constants of
    csrc/quant_matmul.cu, in slt_quant_matmul_geometry's order (the card
    checks the built library's report against the same tuple)."""
    src = (build.CSRC / "quant_matmul.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    order = re.findall(r"out\[(\d)\] = (k\w+);", src)
    assert [int(i) for i, _ in order] == list(range(len(GEOMETRY)))
    assert tuple(int(const[name]) for _, name in order) == GEOMETRY


def _tile_of(tile, n_rt, n_ct, group_rows=8):
    """The prefill kernel's raster (pf::tile_of): groups of 8 row tiles,
    column tile by column tile."""
    per_group = group_rows * n_ct
    first = tile // per_group * group_rows
    rows = min(group_rows, n_rt - first)
    rt = first + tile % per_group % rows
    return rt, tile % per_group // rows


@pytest.mark.parametrize("n_rt, n_ct", [(1, 1), (1, 501), (4, 4), (8, 16),
                                        (9, 3), (32, 56), (17, 125)])
def test_prefill_raster_covers_every_tile_once(n_rt, n_ct):
    """The block index -> output tile map is a bijection, and the blocks
    on the card at once (132) span at most 8 row tiles."""
    tiles = [_tile_of(t, n_rt, n_ct) for t in range(n_rt * n_ct)]
    assert sorted(tiles) == [(r, c) for r in range(n_rt) for c in range(n_ct)]
    for w in range(0, len(tiles), 132):
        wave = tiles[w:w + 132]
        assert len({r // 8 for r, _ in wave}) <= 2
        assert max(r for r, _ in wave) - min(r for r, _ in wave) < 16


def _swizzled_box(w8):
    """A 64 x 128 int8 weight box as TMA's 128-byte swizzle lays it in
    shared memory: row k's 16-byte chunk j at chunk j XOR k % 8."""
    k = torch.arange(64)[:, None]
    c = torch.arange(128)[None, :]
    at = k * 128 + 16 * ((c // 16) ^ (k % 8)) + c % 16
    out = torch.zeros(64 * 128, dtype=torch.uint8)
    out[at.reshape(-1)] = w8.reshape(-1).view(torch.uint8)
    return out


def _a_operand(box, kk, j, *, swizzle=True, swap_halves=False):
    """The consumer's A operand of k-slice kk and m-tile j as load_a reads
    and converts it: row 16 w + g + 8 h, k kl holds the byte at weight
    row 16 kk + kl, column 32 w + 4 g + 2 j + h of the box (the word of
    column 32 w + 4 g read at its swizzled chunk), int8 -> bf16 by the
    kernel's rule. Returns (A [64, 16] f32, each row's box column).
    ``swizzle=False`` (the chunk read unswizzled) and ``swap_halves`` (rows
    g and g + 8 exchanged) are the faults the limit must catch."""
    w = torch.arange(4)[:, None, None, None]
    g = torch.arange(8)[None, :, None, None]
    h = torch.arange(2)[None, None, :, None]
    kl = torch.arange(16)[None, None, None, :]
    krow = 16 * kk + kl
    word = 32 * w + 4 * g
    chunk = (word // 16) ^ (krow % 8) if swizzle else word // 16
    byte = 2 * j + ((1 - h) if swap_halves else h)
    at = krow * 128 + 16 * chunk + word % 16 + byte
    vals = box[at.expand(4, 8, 2, 16).reshape(-1)].view(torch.int8)
    a = _int8_to_bf16_like_kernel(vals).float().reshape(4, 8, 2, 16)
    a = a.permute(0, 2, 1, 3).reshape(64, 16)  # row 16 w + 8 h + g
    cols = (32 * w + 4 * g + 2 * j + h).expand(4, 8, 2, 1).permute(
        0, 2, 1, 3).reshape(64)
    return a, cols


def _prefill_twin(x, wq, scale, **fault):
    """K6's prefill tiling in torch: plan()'s splits; each block's 128 x
    256 tile (rows past R and columns past O zero, as TMA fills them) as two
    consumers' transposed products out^T = wq^T x^T over 64-row stages, the
    weights through the swizzled box, load_a's reads and the int8 -> bf16
    rule into two m-tiles of 64 rows, each row one weight column; f32 sums,
    partials added in split order, then the scale and the cast."""
    R, I = x.shape
    O = wq.shape[1]
    pl = plan(R, I, O)
    assert pl.tiling == "prefill"
    Rp, Ip, Op = -(-R // 128) * 128, -(-I // 64) * 64, -(-O // 256) * 256
    xb = torch.zeros(Rp, Ip)
    xb[:R, :I] = x.to(torch.bfloat16).float()
    wp = torch.zeros(Ip, Op, dtype=torch.int8)
    wp[:I, :O] = wq
    total = torch.zeros(Rp, Op)
    for sp in range(pl.splits):
        part = torch.zeros(Rp, Op)
        for k0 in range(sp * pl.k_split, min(I, (sp + 1) * pl.k_split), 64):
            for c0 in range(0, Op, 128):  # a consumer's 128 columns
                box = _swizzled_box(wp[k0:k0 + 64, c0:c0 + 128])
                for kk in range(4):
                    xs = xb[:, k0 + 16 * kk:k0 + 16 * kk + 16]
                    for j in range(2):
                        a, cols = _a_operand(box, kk, j, **fault)
                        part[:, c0 + cols] += (a @ xs.t()).t()
        total = total + part
    return (total[:R, :O] * scale).to(x.dtype)


@pytest.mark.parametrize("shape", [(40, 512, 384), (130, 136, 272)])
def test_prefill_twin_matches_plain_and_fails_an_unswizzled_tile(shape):
    """The wgmma prefill's arithmetic and layouts (the int8 box read back
    from its 128-byte swizzle, each weight column a row of the transposed
    product, 128 x 256 tiles, ragged R, I and O, the split sum) stay within
    phase 3's limit of the plain version; reading the box unswizzled and
    exchanging a thread's two rows each fail it."""
    R, I, O = shape
    x, wq, scale = (torch.from_numpy(a) for a in _inputs(R, I, O, seed=R))
    x = x.to(torch.bfloat16)
    ref = quant_matmul_reference(x, wq, scale).float()
    limit = 2 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    got = _prefill_twin(x, wq, scale).float()
    assert bool(((got - ref).abs() <= limit).all())
    for fault in ("swizzle", "swap_halves"):
        bad = _prefill_twin(x, wq, scale, **{fault: fault == "swap_halves"})
        assert bool(((bad.float() - ref).abs() > limit).any()), fault


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


# Every llama_8b and Mixtral projection at prefill and training rows (the
# wgmma tiling), and shapes TMA cannot describe (prefill_mma), f32 x and
# out among them.
PREFILL_CASES = [(R, I, O, torch.bfloat16) for R in (17, 64, 129, 512, 4096)
                 for I, O in MODEL_SHAPES + [(4136, 1024), (100, 77),
                                             (4100, 1032)]] + [
    (40, 512, 384, torch.float32), (300, 4096, 1024, torch.float32),
    (129, 100, 77, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREFILL_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_prefill_matches_plain_on_card(card, case):
    """Both prefill tilings against the plain version, launched by the
    tiling plan() names, twice and bit for bit."""
    R, I, O, dt = case
    g = torch.Generator(device=card).manual_seed(R + I + O)
    x = torch.randn(R, I, generator=g, device=card).to(dt)
    wq = torch.randint(-127, 128, (I, O), generator=g, device=card,
                       dtype=torch.int8)
    scale = (torch.rand(O, generator=g, device=card) + 0.5) * 4e-4
    tiling = plan(R, I, O).tiling
    before = quant_matmul.tilings[tiling]
    got = quant_matmul(x, wq, scale)
    again = quant_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert quant_matmul.tilings[tiling] == before + 2
    assert got.dtype == dt and torch.equal(got, again)
    want = quant_matmul_reference(x, wq, scale).float()
    err = (got.float() - want).abs()
    assert bool(torch.isfinite(got.float()).all())
    assert bool((err <= 2 ** -7 * want.abs()
                 + 1e-3 * want.abs().max()).all()), err.max().item()


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph_matches_eager(card):
    """Split calls share their stream's workspace: decode and prefill calls
    that split, and a prefill call that does not, captured into a CUDA
    graph (on another stream, so with another workspace) and replayed,
    give the eager results bit for bit."""
    args = []
    for R, I, O in [(8, 4096, 1024), (512, 4096, 1024), (64, 14336, 4096),
                    (4096, 4096, 4096)]:
        assert plan(R, I, O).splits > 1 or R == 4096
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
@pytest.mark.parametrize("R", [8, 512])
def test_kernel_from_two_threads_on_one_stream(card, R):
    """Split calls from two threads share the default stream's workspace
    (decode and prefill): each call's split kernel and reduce stay
    together, so every result equals the one-thread result bit for bit."""
    import threading

    assert plan(R, 4096, 1024).splits > 1
    x, wq, scale = _inputs(R, 4096, 1024)
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
    assert [len(o) for o in outs] == [50, 50]  # no call raised
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


@pytest.mark.cuda
def test_nonfinite_inputs_on_card(card):
    """Phase 14a's K6 cases: a NaN in x through the decode and prefill
    tilings, in bf16 and f32, reaches exactly the outputs it reaches in
    the plain version."""
    import chip_smoke as cs

    g = torch.Generator(device=card).manual_seed(14)
    wq = torch.randint(-127, 128, (cs.NF_QM["I"], cs.NF_QM["O"]),
                       device=card, generator=g).to(torch.int8)
    scale = torch.rand(cs.NF_QM["O"], device=card, generator=g) * 0.02
    for dt in (torch.bfloat16, torch.float32):
        for R in cs.NF_QM_ROWS:
            x = {"x": torch.randn(R, cs.NF_QM["I"], device=card,
                                  generator=g).to(dt)}
            _, faults = cs.nonfinite_case(
                torch, lambda v: {"y": quant_matmul(v["x"], wq, scale)},
                lambda v: {"y": quant_matmul_reference(v["x"], wq, scale)},
                x, "x", (3, 100), math.nan)
            assert not faults, (dt, R, faults)
