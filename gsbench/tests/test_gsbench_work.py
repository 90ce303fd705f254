"""The frozen work counts against hand counts at tiny shapes."""

import math

import pytest
import torch

from gsbench import work as W
from gsbench.reference import render as R
from gsbench.reference import train as RT


def _settings(quad="vpu", tile=16):
    return R.RenderSettings(tile=tile, max_pairs=10_000, max_pairs_sorted=None,
                            tile_cull=False, sort_mode="2key",
                            payload_dtype="f32", grad_reduce_dtype="f32",
                            blend_quad=quad)


def test_per_gaussian_loss_and_adam_constants_are_the_references_counts():
    torch.manual_seed(0)
    n = 4000
    raw = [torch.rand(n, 3) * 2 - 1, torch.rand(n, 3) * -3 - 2,
           torch.randn(n, 4), torch.randn(n), torch.randn(n, 1, 3),
           torch.randn(n, 15, 3) * 0.05]
    raw = [r.requires_grad_(True) for r in raw]
    cam = R.look_at((3.5, -3, 2.2), (0, 0, 0), (0, 0, 1), 65, 64, 48, "cpu")
    rs = _settings()

    def forward(*raw):
        m, s, q, o, sh = R.activate(*raw)
        c = R.sh_colors(m, sh, cam.position, 3)
        p = R.project(m, s, q, cam, 64, 48, rs)
        return c, p, o

    (c, p, o), ops = W.count_ops(forward, *raw)
    assert round(ops / n) == W.OPS_PER_GAUSSIAN["forward"]
    out = c.sum() + p.means2d.sum() + p.conic.sum() + o.sum()
    _, ops = W.count_ops(lambda: out.backward())
    assert round(ops / n) == W.OPS_PER_GAUSSIAN["backward"]

    img = torch.rand(3, 48, 64, requires_grad=True)
    loss, ops = W.count_ops(lambda: RT.loss_fn(img, torch.rand(3, 48, 64),
                                               0.2))
    assert round(ops / (48 * 64)) == W.OPS_PER_LOSS_PIXEL["forward"]
    _, ops = W.count_ops(lambda: loss.backward())
    assert round(ops / (48 * 64)) == W.OPS_PER_LOSS_PIXEL["backward"]

    p, g = [torch.rand(1000)], [torch.rand(1000)]
    opt = RT.Adam(p, 1e-15)
    _, ops = W.count_ops(lambda: opt.step(p, g, [0.1]))
    assert ops == 1000 * W.OPS_PER_ADAM_ELEMENT


def _pairs_by_hand(entries, tile, rs):
    """(evaluated, applied) by a scalar loop over each pixel of one tile
    and its entries front to back: a pixel evaluates entries up to and
    including the one at which it stops."""
    evaluated = applied = 0
    for py in range(tile):
        for px in range(tile):
            t = 1.0
            for (mx, my, ca, cb, cc, op) in entries:
                evaluated += 1
                dx, dy = mx - px, my - py
                power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                if power > 0:
                    continue
                alpha = min(rs.alpha_max, op * math.exp(power))
                if alpha < rs.alpha_min:
                    continue
                if t * (1 - alpha) < rs.transmittance_eps:
                    break
                t *= 1 - alpha
                applied += 1
    return evaluated, applied


@pytest.mark.parametrize("n_entries", [1, 6, 40])
def test_pair_counts_against_a_scalar_loop(n_entries):
    g = torch.Generator().manual_seed(n_entries)
    rs = _settings()
    tile = rs.tile
    ent = []
    for _ in range(n_entries):
        u = torch.rand(4, generator=g).tolist()
        ent.append((u[0] * tile, u[1] * tile, 0.05 + u[2] * 0.3, 0.0,
                    0.05 + u[2] * 0.3, 0.5 + 0.49 * u[3]))
    payload = torch.zeros((9, n_entries + R.CHUNK))
    for i, e in enumerate(ent):
        payload[:6, i] = torch.tensor(e)
    binned = R.Binned(torch.arange(n_entries, dtype=torch.int32),
                      torch.tensor([0], dtype=torch.int32),
                      torch.tensor([n_entries], dtype=torch.int32),
                      n_entries, False, n_entries)
    got = R.pair_counts(payload, binned, 1, tile, tile, rs)
    assert got == _pairs_by_hand(ent, tile, rs)


def test_kernel_work_by_hand():
    assert W.k1_work(10, 100, 40, cull=True) == (10 * 52 + 100 * 12, 40 * 40)
    assert W.k1_work(10, 100, 40, cull=False) == (10 * 28 + 100 * 12, 0)
    assert W.k2_work(10, 2, 256, 100, 50, "vpu") == (
        10 * 36 + 2 * 8 + 2 * 256 * 16, 100 * 17 + 50 * 16)
    assert W.k3_work(10, 2, 256, 100, 50, "mxu") == (
        10 * 72 + 2 * 256 * 32 + 2 * 8, 100 * 14 + 50 * 62)
    assert W.k4_work(10, 4) == (10 * 40 + 4 * 36, 90)
    assert W.bound_s(3.35e12, 0) == 1.0 and W.bound_s(0, 67e12) == 1.0
    frame = W.frame_ops(2, 100, 50, 40, "mxu", True)
    assert frame == 2 * W.OPS_PER_GAUSSIAN["forward"] + 40 * 40 + 1400 + 800
    step = W.step_ops(2, 118, 12, 100, 50, 40, 10, "mxu", True)
    assert step == frame + 12 * (732 + 774) + 1400 + 50 * 62 + 90 \
        + 2 * W.OPS_PER_GAUSSIAN["backward"] + 118 * 11
