"""The stats kernels of the numerics layer (``ops/tensor_stats.py``,
``csrc/tensor_stats.cu``): their plain versions' rows on the CPU, and on
the card (``-m cuda``) each kernel against its plain version on tensors
holding NaN and +-inf. This file imports no JAX, so it runs on the card's
machine too."""

import math

import pytest
import torch

from serverless_learn_tpu_torch.ops import tensor_stats as ts


def test_stats_plain_version_rows():
    """The stats wrappers' plain versions: a tensor's statistics in its
    first row, the chunk sums placed by the index within the subtree (a
    tensor starting mid-chunk), and the reduction of consecutive rows."""
    x = torch.tensor([1.0, -2.0, float("nan"), 4.0, float("inf"), 3.0])
    rows = torch.empty(ts.grid_for(6), ts.KCOLS, dtype=torch.float64)
    ts.tensor_stats(x, rows, base=5, chunk=4, chunks=3, scale=2.0)
    row = rows[0].tolist()
    assert row[ts.SUMSQ] == 4 * (1 + 4 + 16 + 9)
    assert math.isnan(row[ts.SUMSQ_ALL])
    assert row[ts.ABSMAX] == 8.0 and row[ts.NAN] == 1 and row[ts.INF] == 1
    assert row[ts.SUM] == 12.0
    # indices 5..10: chunk 1 holds 5-7 (2, -4, nan), chunk 2 holds 8-10
    assert row[ts.CHUNK0:ts.CHUNK0 + 3] == [0.0, -2.0, 14.0]
    out = torch.empty(1, ts.KCOLS, dtype=torch.float64)
    ts.stats_reduce(torch.cat([rows, rows]), torch.tensor([0, 2]), out)
    assert out[0, ts.SUMSQ] == 2 * row[ts.SUMSQ]
    assert out[0, ts.ABSMAX] == row[ts.ABSMAX]
    assert ts.tensor_stats.launches == ts.tensor_stats_many.launches == 0
    assert ts.stats_reduce.launches == 0


@pytest.mark.cuda
def test_stats_kernel_on_the_card():
    """The stats kernels against their plain versions on the card, f32 and
    bf16 with NaN and +-inf, a tensor crossing chunk boundaries: counts and
    maxima equal, sums within ``kernel_tolerance``; the same bits twice,
    and from the many-tensor launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(3_000_001, device="cuda", generator=g).to(dtype)
        x[17] = float("nan")
        x[2_999_999] = float("inf")
        x[1_500_000] = -float("inf")
        rows = torch.empty(ts.grid_for(x.numel()), ts.KCOLS,
                           dtype=torch.float64, device="cuda")
        plan = dict(base=123, chunk=1_000_000, chunks=4, scale=-0.5)
        got = ts.tensor_stats(x, rows, **plan).clone()
        again = ts.tensor_stats(x, rows, **plan)
        # the same bits (a NaN sum of squares compares unequal as a value)
        bits = lambda t: t.view(torch.int64)  # noqa: E731
        assert torch.equal(bits(got), bits(again))
        ref = ts.tensor_stats_reference(x.cpu(), rows.cpu().clone(), **plan)
        bounds = torch.tensor([0, rows.shape[0]], device="cuda")
        out = ts.stats_reduce(got, bounds, torch.empty(
            1, ts.KCOLS, dtype=torch.float64, device="cuda")).cpu()[0]
        want = ref[0]
        lim = ts.kernel_tolerance(want, x.numel())
        # the many-tensor launch: x as the second of two tensors
        head = torch.randn(5000, device="cuda", generator=g).to(dtype)
        g0 = ts.grid_for(5000)
        buf = torch.empty(g0 + rows.shape[0], ts.KCOLS, dtype=torch.float64,
                          device="cuda")
        ts.tensor_stats_many([head, x], buf, [0, g0], [0, plan["base"]],
                             [plan["chunk"]] * 2, chunks=plan["chunks"],
                             scale=plan["scale"])
        assert torch.equal(bits(buf[g0:]), bits(got))
        assert torch.isnan(out[ts.SUMSQ_ALL]) and torch.isnan(
            want[ts.SUMSQ_ALL])
        for c in range(ts.KCOLS):
            if c != ts.SUMSQ_ALL:
                assert abs(out[c] - want[c]) <= lim[c], c
