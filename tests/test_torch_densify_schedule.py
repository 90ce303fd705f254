"""PyTorch port: density control on the normal path against the plain
reference of ``gsbench/reference/densify.py`` (graphdeco's round at a
static capacity), and the schedule that decides when it acts
(``models/densify.py``: ``DensifySchedule``, ``density_control``).

No JAX here: the port against the benchmark's plain torch reference, on the
CPU at a test's size.
"""

import dataclasses
import math

import pytest
import torch

from gsbench.reference import densify as RD
from gsbench.reference import render as R
from gsbench.reference import train as RT
from luisacomputegaussiansplatting_tpu_torch.apps import train_cli
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models import densify as pd
from luisacomputegaussiansplatting_tpu_torch.models import trainer as pt
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import (
    GaussianParams, pad_params_to)
from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera

torch.set_num_threads(2)

C = 4096
EXTENT = 5.0


def _state(n_active, seed, capacity=C):
    """Seeded raw parameters at ``capacity`` (the first ``n_active`` rows
    active, the rest parked), statistics, Adam's moments after one update
    and the split noise: a mix of small and large gaussians, some nearly
    transparent, some wide on screen or in the world."""
    g = torch.Generator().manual_seed(seed)
    n = n_active
    u = torch.rand((n, 8), generator=g)
    ls = torch.log(0.002 + 0.06 * u[:, 0:3] ** 3)  # 0.002 .. 0.062
    ls[u[:, 3] < 0.02] = math.log(0.7)  # world-size prunes (> 0.5)
    op = torch.where(u[:, 4] < 0.05, 0.002, 0.2 + 0.7 * u[:, 5])
    raw = GaussianParams(
        means=torch.randn((n, 3), generator=g),
        log_scales=ls,
        quats=torch.randn((n, 4), generator=g),
        opacity_logits=torch.log(op) - torch.log1p(-op),
        sh_dc=torch.randn((n, 1, 3), generator=g),
        sh_rest=0.05 * torch.randn((n, 15, 3), generator=g))
    params = pad_params_to(raw, capacity)
    leaves = GaussianParams(*(p.clone().requires_grad_(True) for p in params))
    opt = pt.make_optimizer(leaves)
    for p in leaves:
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    dstate = pd.init_densify_state(n, capacity, device="cpu")
    count = torch.randint(0, 6, (capacity,), generator=g).float()
    count[n:] = 0
    grad_sum = count * 4e-4 * torch.rand(capacity, generator=g)
    radii = torch.randint(0, 30, (capacity,), generator=g, dtype=torch.int32)
    radii[count == 0] = 0
    dstate = dstate._replace(grad_sum=grad_sum, count=count, max_radii=radii)
    noise = torch.randn((capacity, 2, 3), generator=g)
    return leaves, opt, dstate, noise


def _moments(opt, params):
    st = [opt.state[p] for p in params]
    return ([s["exp_avg"].clone() for s in st],
            [s["exp_avg_sq"].clone() for s in st])


def _reference_round(params, opt, dstate, noise, cfg, size_prune):
    m, v = _moments(opt, params)
    s = RD.Settings(**{k: getattr(cfg, k) for k in RD.Settings._fields})
    return RD.densify_round(
        [p.detach().clone() for p in params], m, v, dstate.grad_sum,
        dstate.count, dstate.max_radii, dstate.active, noise, EXTENT, s,
        size_prune)


def _assert_round_equal(params, opt, new_d, info, ref):
    got = {"cloned": int(info.n_cloned), "split": int(info.n_split),
           "pruned": int(info.n_pruned), "active": int(new_d.num_active)}
    assert got == ref.counts
    assert bool(info.overflow) == ref.overflow
    assert torch.equal(new_d.active, ref.active)
    for p, r in zip(params, ref.params):
        torch.testing.assert_close(p.detach(), r, rtol=2e-6, atol=2e-6)
    m, v = _moments(opt, params)
    for a, b in zip(m + v, list(ref.exp_avg) + list(ref.exp_avg_sq)):
        assert torch.equal(a, b)


CASES = {
    # clone, split and the opacity prune, no size prunes
    "clone_split_opacity": dict(n_active=1800, size=False, screen=0),
    # the screen-radius and world-size prunes on top
    "size_prunes": dict(n_active=1800, size=True, screen=20),
    # the world-size prune alone, as graphdeco's code runs it (its screen
    # test reads radii that it has just reset)
    "world_prune_alone": dict(n_active=1800, size=True, screen=0),
    # a capacity with little room: the split gate and dropped children
    "capacity_full": dict(n_active=3900, size=False, screen=0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_round_matches_the_plain_reference(case):
    kw = CASES[case]
    params, opt, dstate, noise = _state(kw["n_active"], seed=11)
    cfg = pd.DensifyConfig(max_screen_radius=kw["screen"],
                           size_prune=kw["size"])
    ref = _reference_round(params, opt, dstate, noise, cfg, kw["size"])
    _, opt, new_d, info = pd.densify_round(params, opt, dstate, noise,
                                           EXTENT, cfg)
    _assert_round_equal(params, opt, new_d, info, ref)
    assert ref.counts["cloned"] > 0 and ref.counts["split"] > 0
    assert ref.counts["pruned"] > 0
    with torch.no_grad():
        act = dstate.active
        op = torch.sigmoid(params.opacity_logits)
    if kw["size"]:
        # prunes by size that the opacity alone would not make, and by
        # screen radius where the test is set
        unpruned = _reference_round(params, opt, dstate, noise, cfg, False)
        assert ref.counts["pruned"] > unpruned.counts["pruned"]
        other = _reference_round(
            params, opt, dstate, noise, dataclasses.replace(
                cfg, max_screen_radius=20 - kw["screen"]), True)
        assert (ref.counts["pruned"] > other.counts["pruned"]) \
            == bool(kw["screen"])
    if case == "capacity_full":
        assert ref.overflow and bool(info.overflow)
        assert int((act & (op >= 0.005)).sum()) + ref.counts["cloned"] \
            + 2 * ref.counts["split"] > C


def test_round_without_moments_matches():
    """A parameter Adam has not stepped yet has no moments: the round
    leaves it so, as the reference does with None."""
    params, _opt, dstate, noise = _state(1800, seed=12)
    cfg = pd.DensifyConfig()
    ref = RD.densify_round(
        [p.detach().clone() for p in params], [None] * 6, [None] * 6,
        dstate.grad_sum, dstate.count, dstate.max_radii, dstate.active,
        noise, EXTENT, RD.Settings(max_screen_radius=0), False)
    _, _, new_d, info = pd.densify_round(params, None, dstate, noise, EXTENT,
                                         cfg)
    assert torch.equal(new_d.active, ref.active)
    for p, r in zip(params, ref.params):
        torch.testing.assert_close(p.detach(), r, rtol=2e-6, atol=2e-6)


def _decisions(schedule, iters):
    return [(i, schedule.wants_round(i), schedule.wants_size_prune(i),
             schedule.wants_reset(i)) for i in range(1, iters + 1)]


def test_graphdeco_schedule():
    """graphdeco's defaults: rounds for 500 < i < 15,000 at multiples of
    100, size prunes after 3,000, resets at multiples of 3,000 while
    densifying."""
    d = _decisions(pd.DensifySchedule(), 30_000)
    rounds = [i for i, r, _, _ in d if r]
    assert rounds == list(range(600, 15_000, 100))
    assert [i for i, _, _, z in d if z] == [3000, 6000, 9000, 12000]
    assert all(s == (i > 3000) for i, _, s, _ in d)
    # and as the benchmark's reference states them
    dz = {"start": 500, "stop": 15_000, "interval": 100,
          "size_prune_after": 3000}
    assert all(RD.schedule(i, dz) == (r, s) for i, r, s, _ in d
               if r or i % 100 == 0)


@pytest.mark.parametrize("argv", [
    [],
    ["--iters", "700", "--densify-from", "0", "--densify-interval", "7",
     "--opacity-reset-interval", "300", "--densify-until", "600"],
    ["--iters", "1000", "--densify-interval", "50",
     "--opacity-reset-interval", "200"],
])
def test_cli_schedule_keeps_the_cli_decisions(argv):
    """The CLI's schedule against its former inline block, at every
    iteration of a run (0-based ``it``, the round and the reset after step
    it + 1)."""
    args = train_cli.build_parser().parse_args(["--synthetic-gt", "10"]
                                               + argv)
    schedule = train_cli.density_schedule(args)
    until = args.densify_until or args.iters // 2
    for it in range(args.iters):
        old_round = (args.densify_from <= it < until
                     and (it + 1) % args.densify_interval == 0)
        old_reset = bool(args.opacity_reset_interval
                         and (it + 1) % args.opacity_reset_interval == 0
                         and it < until)
        assert schedule.wants_round(it + 1) == old_round, it
        assert schedule.wants_reset(it + 1) == old_reset, it
        assert not schedule.wants_size_prune(it + 1)


def test_density_control_does_what_the_schedule_asks():
    """A round only when due, its size prunes only after
    ``size_prune_after``, a reset of the opacity when due."""
    sched = pd.DensifySchedule(start=2, stop=20, interval=4,
                               reset_interval=6, size_prune_after=9)
    cfg = pd.DensifyConfig(max_screen_radius=20)
    seen = []

    def round_fn(params, opt, state, gen, extent, dcfg):
        assert dataclasses.replace(dcfg, size_prune=None) == cfg
        seen.append(dcfg.size_prune)
        return params, opt, state, "info"

    params, opt, dstate, _ = _state(100, seed=3, capacity=200)
    for i in range(1, 25):
        with torch.no_grad():
            params.opacity_logits.zero_()
        before = params.opacity_logits.detach().clone()
        _, _, info = pd.density_control(i, sched, params, opt, dstate,
                                        None, EXTENT, cfg, round_fn)
        assert (info is not None) == (i in (4, 8, 12, 16))
        reset = not torch.equal(before, params.opacity_logits.detach())
        assert reset == (i in (6, 12, 18)), i
    assert seen == [False, False, True, True]


# --------------------------------------------------------------------------
# a short densifying run through the schedule against the reference's step
# plus round
# --------------------------------------------------------------------------

W, H = 64, 48
N_ACTIVE, CAP = 300, 700
CAM = look_at_camera((3.2, -2.8, 2.1), (0, 0, 0), (0, 0, 1), fov=70.0,
                     width=W, height=H)
CAMS = [CAM, look_at_camera((-2.6, -3.0, 1.7), (0, 0, 0), (0, 0, 1),
                            fov=70.0, width=W, height=H)]


def _run_params():
    g = torch.Generator().manual_seed(21)
    n = N_ACTIVE
    u = torch.rand((n, 4), generator=g)
    ls = torch.log(0.02 + 0.1 * u[:, 0:3])
    op = 0.1 + 0.8 * u[:, 3]
    raw = GaussianParams(
        means=torch.randn((n, 3), generator=g),
        log_scales=ls, quats=torch.randn((n, 4), generator=g),
        opacity_logits=torch.log(op) - torch.log1p(-op),
        sh_dc=torch.randn((n, 1, 3), generator=g),
        sh_rest=0.05 * torch.randn((n, 15, 3), generator=g))
    return pad_params_to(raw, CAP)


def _ref_view(cam):
    return R.View(*cam.to_view("cpu"))


def test_a_densifying_run_matches_the_reference():
    """Four steps with a round after steps 2 and 4 (size prunes in the
    second), the port through ``make_densify_train_step`` and
    ``density_control``; the reference: its render, loss and Adam on the
    active rows, its statistics, its round on its own state with the
    port's split noise."""
    targets = torch.rand((2, 3, H, W), generator=torch.Generator()
                         .manual_seed(5))
    rc = {"max_pairs": 40_000, "pack_mode": "none"}
    rcfg = RenderConfig(**rc)
    rs = R.RenderSettings.from_config(rc)
    tc = pt.TrainConfig()
    sched = pd.DensifySchedule(start=0, stop=100, interval=2,
                               reset_interval=0, size_prune_after=3)
    dcfg = pd.DensifyConfig(grad_threshold=2e-3, max_screen_radius=6,
                            max_world_scale_frac=0.1)
    start = _run_params()

    state, opt = pt.init_train_state(start, tc)
    dstate = pd.init_densify_state(N_ACTIVE, CAP, device="cpu")
    step = pt.make_densify_train_step(opt, W, H, cfg=rcfg, tc=tc)
    gen = torch.Generator().manual_seed(8)
    noises = []
    infos = []
    for k in range(4):
        state, dstate, _loss, _aux = step(state, dstate,
                                           CAMS[k % 2].to_view("cpu"),
                                           targets[k % 2])
        noises.append(gen.get_state())
        opt, dstate, info = pd.density_control(k + 1, sched, state.params,
                                               opt, dstate, gen, EXTENT,
                                               dcfg)
        infos.append(info)

    # the reference
    params = [p.clone() for p in start]
    c = params[0].shape[0]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    active = torch.arange(c) < N_ACTIVE
    stats = [torch.zeros(c), torch.zeros(c), torch.zeros(c, dtype=torch.int32)]
    t = 0
    counts = []
    for k in range(4):
        idx = torch.nonzero(active).reshape(-1)
        leaves = [p[idx].clone().requires_grad_(True) for p in params]
        frame = R.render(leaves, _ref_view(CAMS[k % 2]), W, H,
                         (0.0, 0.0, 0.0), rs, 3)
        frame.means2d.retain_grad()
        loss = RT.loss_fn(frame.image, targets[k % 2], tc.ssim_weight)
        loss.backward()
        opt_r = RT.Adam([], tc.adam_eps)
        opt_r.m = [x[idx] for x in m]
        opt_r.v = [x[idx] for x in v]
        opt_r.t = t
        sub = [p[idx] for p in params]
        lrs = RT.group_lrs(dataclasses.asdict(tc), t)
        opt_r.step(sub, [lf.grad for lf in leaves],
                   [lrs[name] for name in RT.GROUPS])
        t = opt_r.t
        for full, part in zip(params + m + v, sub + opt_r.m + opt_r.v):
            full[idx] = part
        g_sum, cnt, rad = RT.densify_update(
            [s[idx] for s in stats], frame.means2d.grad, frame.radius, W, H)
        for s, part in zip(stats, (g_sum, cnt, rad)):
            s[idx] = part
        if (k + 1) % 2 == 0:
            gen_r = torch.Generator()
            gen_r.set_state(noises[k])
            noise = torch.randn((c, 2, 3), generator=gen_r)
            s = RD.Settings(**{f: getattr(dcfg, f)
                               for f in RD.Settings._fields})
            out = RD.densify_round(params, m, v, *stats, active, noise,
                                   EXTENT, s, k + 1 > 3)
            params, m, v = list(out.params), list(out.exp_avg), \
                list(out.exp_avg_sq)
            active = out.active
            stats = [torch.zeros(c), torch.zeros(c),
                     torch.zeros(c, dtype=torch.int32)]
            counts.append(out.counts)

    got = [{"cloned": int(i.n_cloned), "split": int(i.n_split),
            "pruned": int(i.n_pruned)} for i in infos if i is not None]
    assert got == [{k: c[k] for k in ("cloned", "split", "pruned")}
                   for c in counts]
    assert all(c["cloned"] > 0 and c["split"] > 0 for c in counts)
    assert counts[1]["pruned"] > 0
    assert torch.equal(dstate.active, active)
    for p, r in zip(state.params, params):
        torch.testing.assert_close(p.detach(), r, rtol=1e-4, atol=1e-5)
