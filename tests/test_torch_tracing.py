"""PyTorch port: the program's own layer ranges and binning counters
(``utils/profiling.py``: ``span``, ``mark``, ``close``, ``count``).

They act only while a ``torch.profiler`` records: a step and a frame give
bit-identical results with a profiler and without; without one, no marker
node, range or count is made. In a profiled step every aten op lies under
exactly one layer range, forward or ``<layer>.backward`` (names below), the
backward's ranges run in reverse layer order, and the markers add no op but
their views (on the card: no launch). The counters keep one value per
binning call, equal to that call's entry count and slot total.

All on the CPU at a test's scene size.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models import densify as pd
from luisacomputegaussiansplatting_tpu_torch.models import trainer as pt
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianParams
from luisacomputegaussiansplatting_tpu_torch.ops.binning import bin_gaussians, bin_gaussians_nopack
from luisacomputegaussiansplatting_tpu_torch.ops.expand import saturated_ends
from luisacomputegaussiansplatting_tpu_torch.ops.projection import project_gaussians, tile_grid
from luisacomputegaussiansplatting_tpu_torch.ops.render import render_view
from luisacomputegaussiansplatting_tpu_torch.utils import profiling
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView, look_at_camera

torch.set_num_threads(2)

W, H, N = 64, 48, 150
CONFIGS = {
    "strict": dict(max_pairs=30_000),
    "production": dict(max_pairs=30_000, tile=32, pack_mode="none",
                       tile_cull=True, sort_mode="fused",
                       payload_dtype="bf16", grad_reduce_dtype="bf16",
                       grad_reduce_method="rowgather", blend_quad="mxu"),
}
CAMS = [look_at_camera(eye, (0, 0, 0), (0, 0, 1), fov=70.0, width=W,
                       height=H)
        for eye in ((3.2, -2.8, 2.1), (-2.6, -3.0, 1.7))]
VIEWS = [c.to_view("cpu") for c in CAMS]
STAGES = ("sh", "project", "expand", "sort", "pack", "gather", "blend",
          "compose")
#: the layer ranges: each aten op of a step lies under exactly one of these
#: or of their ``.backward`` twins
LAYERS = ({f"render_view.{s}" for s in STAGES}
          | {f"train_step.{s}" for s in ("activate", "loss", "backward",
                                         "optimizer", "stats",
                                         "accumulate")})
#: the backward's ranges of one view, in the order they run
VIEW_BACKWARD = ["train_step.loss"] + [f"render_view.{s}" for s in (
    "compose", "blend", "gather", "pack", "project", "sh")]
#: the exceptions, each with the range it lies under: the markers' own
#: views (under ``_Marker``, which launches nothing); under ``train_step``
#: alone, the probes' allocation, the batched step's per-view slices and
#: the returned loss's detach; under ``train_step.backward`` alone, the
#: engine's seed gradient (ones_like)
IN_STEP = {"aten::zeros", "aten::empty", "aten::zero_", "aten::unbind",
           "aten::select", "aten::as_strided", "aten::detach",
           "aten::alias"}
SEED = {"aten::ones_like", "aten::empty_like", "aten::empty_strided",
        "aten::fill_"}
VIEWS_OPS = {"aten::view_as", "aten::view"}


def start_params(seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(N, 3)),
              np.log(rng.uniform(0.02, 0.12, (N, 3))),
              rng.normal(size=(N, 4)), rng.normal(size=N),
              rng.normal(size=(N, 1, 3)),
              0.05 * rng.normal(size=(N, 15, 3))]
    return GaussianParams(*(torch.tensor(a, dtype=torch.float32)
                            for a in arrays))


def targets(n):
    return torch.rand((n, 3, H, W), generator=torch.Generator().manual_seed(5))


def make_step(kind, cfg):
    """(one call of the ``kind`` step from fresh state, its leaves)."""
    state, opt = pt.init_train_state(start_params())
    dstate = pd.init_densify_state(N, N, device="cpu")
    cfg = RenderConfig(**CONFIGS[cfg])
    tgt = targets(2)
    first = tgt[0]
    if kind == "plain":
        step = pt.make_train_step(opt, W, H, cfg=cfg)
        call = lambda: step(state, VIEWS[0], first)  # noqa: E731
    elif kind == "densify":
        step = pt.make_densify_train_step(opt, W, H, cfg=cfg)
        call = lambda: step(state, dstate, VIEWS[0], first)  # noqa: E731
    else:
        step = pt.make_batched_train_step(opt, W, H, cfg=cfg)
        views = CameraView(*(torch.stack(x) for x in zip(*VIEWS)))
        call = lambda: step(state, dstate, views, tgt)  # noqa: E731
    return call, state.params


def frame(cfg):
    """A differentiable ``render_view``: (image, aux, the six gradients of
    sum(image * w))."""
    leaves = [t.requires_grad_(True)
              for t in start_params().activate()]
    bg = torch.tensor([0.1, 0.2, 0.3], requires_grad=True)
    img, aux = render_view(*leaves, VIEWS[0], W, H, bg,
                           RenderConfig(**CONFIGS[cfg]))
    w = torch.rand(img.shape, generator=torch.Generator().manual_seed(9))
    grads = torch.autograd.grad((img * w).sum(), [*leaves, bg])
    return img.detach(), aux, grads


def profiled(fn, **kw):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU], **kw) as prof:
        out = fn()
    return out, prof


def step_results(kind, cfg, profile: bool):
    call, leaves = make_step(kind, cfg)
    out = profiled(call)[0] if profile else call()
    grads = [p.grad.clone() for p in leaves]
    return out, grads, [p.detach().clone() for p in leaves]


def flat(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in flat(item)]
    return []


@pytest.mark.parametrize("cfg", ["strict", "production"])
@pytest.mark.parametrize("case", ["densify_step", "render_view"])
def test_a_profiler_leaves_results_bit_identical(case, cfg):
    """Loss, statistics and overflow, the six gradients and Adam's update
    (a step), or image, aux and the six gradients (a frame)."""
    if case == "render_view":
        plain = flat(frame(cfg))
        traced = flat(profiled(lambda: frame(cfg))[0])
    else:
        plain = flat(step_results("densify", cfg, False))
        traced = flat(step_results("densify", cfg, True))
    assert len(plain) == len(traced) > 10
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["plain", "densify", "batched", "frame"])
def test_no_profiler_builds_no_marker_range_or_count(kind, monkeypatch):
    made = collections.Counter()
    apply = profiling._Marker.apply
    monkeypatch.setattr(profiling._Marker, "apply", lambda *a: (
        made.update(["marker"]), apply(*a))[1])
    record = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: (
        made.update(["range"]), record(*a))[1])
    before = {k: len(v) for k, v in profiling._COUNTS.items()}
    if kind == "frame":
        frame("production")
    else:
        make_step(kind, "production")[0]()
    assert made == {}
    assert {k: len(v) for k, v in profiling._COUNTS.items()} == before
    # the same call under a profiler does build them
    if kind == "frame":
        profiled(lambda: frame("production"))
    else:
        profiled(make_step(kind, "production")[0])
    assert made["marker"] > 0 and made["range"] > 0


def _program_ranges(e):
    names = []
    e = e.cpu_parent
    while e is not None:
        names.append(e.name)
        e = e.cpu_parent
    return names


def _layers_of(ancestors):
    hits = [r for r in ancestors
            if r in LAYERS or (r.endswith(".backward")
                               and r[:-len(".backward")] in LAYERS)]
    if any(r.endswith(".backward") and r != "train_step.backward"
           for r in hits):
        # on the CPU the engine runs on the thread that called backward(),
        # inside its forward range
        hits.remove("train_step.backward")
    return hits


def _op_counts(prof):
    """aten ops by name, the markers' views left out; the engine's
    accumulation of two gradients counts as ``aten::add`` whether in place
    or not (where a marker passes one on, the engine may not own it and
    adds out of place: one launch either way, the same sum)."""
    c = collections.Counter(
        "aten::add" if e.name == "aten::add_" else e.name
        for e in prof.events() if e.name.startswith("aten::"))
    for name in VIEWS_OPS:
        c.pop(name, None)
    return c


@pytest.mark.parametrize("cfg", ["strict", "production"])
@pytest.mark.parametrize("kind", ["densify", "plain", "batched"])
def test_each_op_lies_under_one_layer_range(kind, cfg, monkeypatch):
    _, prof = profiled(make_step(kind, cfg)[0])
    events = prof.events()
    stray = collections.Counter()
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        ancestors = _program_ranges(e)
        hits = _layers_of(ancestors)
        if len(hits) == 1:
            continue
        if "_Marker" in ancestors and e.name in VIEWS_OPS:
            continue
        nearest = next((r for r in ancestors
                        if r.startswith(("train_step", "render_view"))),
                       None)
        if not hits and ((nearest == "train_step" and e.name in IN_STEP) or (
                nearest == "train_step.backward" and e.name in SEED)):
            continue
        stray[(e.name, tuple(hits), nearest)] += 1
    assert not stray, stray

    # the backward's ranges, in the order they opened: each view's in
    # reverse layer order (in the batched step, then the view's marker on
    # the activated scene), the last view first, activation last
    order = [e.name[:-len(".backward")] for e in
             sorted(events, key=lambda e: e.time_range.start)
             if e.name.endswith(".backward") and e.name != "train_step.backward"]
    runs = [name for i, name in enumerate(order)
            if i == 0 or order[i - 1] != name]
    n_views = 2 if kind == "batched" else 1
    per_view = VIEW_BACKWARD + (["train_step.accumulate"]
                                if kind == "batched" else [])
    assert runs == per_view * n_views + ["train_step.activate"], runs
    # the engine's sums of the views' gradients of the five activated
    # tensors: B - 1 each, every one under the accumulation's range
    sums = [e for e in events if e.name in ("aten::add", "aten::add_")
            and "train_step.accumulate.backward" in _program_ranges(e)]
    assert len(sums) == (5 * (n_views - 1) if kind == "batched" else 0)

    # the markers add their views and nothing else
    monkeypatch.setattr(profiling, "_boundary", lambda layer, x: x)
    _, bare = profiled(make_step(kind, cfg)[0])
    assert _op_counts(prof) == _op_counts(bare)


@pytest.mark.parametrize("pack", ["chunk", "none"])
def test_binning_counts_one_value_per_call_under_a_profiler(pack):
    binner = {"chunk": bin_gaussians, "none": bin_gaussians_nopack}[pack]
    cfg = RenderConfig(**CONFIGS["strict"])
    gx, gy = tile_grid(W, H, cfg.tile_wh)
    with torch.no_grad():
        scene = start_params().activate()
        projs = [project_gaussians(scene.means, scene.scales, scene.quats,
                                   v, cfg, width=W, height=H) for v in VIEWS]
    names = ("binning.kept_entries", "binning.aabb_slots")

    def bin_all():
        return [binner(p, gx, gy, cfg.max_pairs, None, cfg.tile_wh)
                for p in projs]

    seen = [len(profiling.counts(n)) for n in names]
    bin_all()
    assert [len(profiling.counts(n)) for n in names] == seen
    binned, _ = profiled(bin_all)
    kept, slots = (profiling.counts(n)[-len(projs):] for n in names)
    assert [len(profiling.counts(n)) for n in names] == [
        s + len(projs) for s in seen]
    assert kept == [int(b.num_rendered) for b in binned]
    assert slots == [int(saturated_ends(p.tiles_touched)[1]) for p in projs]
    assert all(0 < k <= s for k, s in zip(kept, slots))


# --------------------------------------------------------------------------
# density control: the round's ranges and the densify counters
# --------------------------------------------------------------------------

CAP = 400
ROUND_RANGES = ("train_step.densify", "train_step.densify.plan",
                "train_step.densify.write", "train_step.densify.adam")
DENSIFY_COUNTS = ("densify.cloned", "densify.split", "densify.pruned",
                  "densify.active")
STEP_COUNTS = ("densify.active_rows", "densify.capacity")


def control_state():
    """(params, Adam, DensifyState) at capacity ``CAP`` with N active rows
    after one densifying step, statistics large enough to clone and split."""
    from luisacomputegaussiansplatting_tpu_torch.models.gaussians import pad_params_to

    state, opt = pt.init_train_state(pad_params_to(start_params(), CAP))
    dstate = pd.init_densify_state(N, CAP, device="cpu")
    step = pt.make_densify_train_step(opt, W, H,
                                      cfg=RenderConfig(**CONFIGS["strict"]))
    state, dstate, _, _ = step(state, dstate, VIEWS[0], targets(1)[0])
    return state.params, opt, dstate


def run_control(iters, params, opt, dstate):
    sched = pd.DensifySchedule(start=0, stop=100, interval=2,
                               reset_interval=0, size_prune_after=0)
    gen = torch.Generator().manual_seed(4)
    cfg = pd.DensifyConfig(max_screen_radius=20)
    rounds = []
    for i in iters:
        opt, dstate, info = pd.density_control(i, sched, params, opt, dstate,
                                               gen, 3.0, cfg)
        if info is not None:
            rounds.append((info, dstate.active))  # summed by the caller
    return rounds, dstate


def test_a_round_opens_its_ranges_and_counts_once_under_a_profiler():
    params, opt, dstate = control_state()
    before = {n: len(profiling.counts(n))
              for n in DENSIFY_COUNTS + STEP_COUNTS}
    actives = [int(dstate.num_active)]
    (rounds, _), prof = profiled(lambda: run_control(
        range(1, 5), params, opt, dstate))
    names = collections.Counter(e.name for e in prof.events())
    assert all(names[r] == 2 for r in ROUND_RANGES), names
    # every op of a round lies under the round's range
    for e in prof.events():
        if e.name.startswith("aten::") and any(
                r.startswith("train_step.densify.")
                for r in _program_ranges(e)):
            assert "train_step.densify" in _program_ranges(e)
    got = {n: profiling.counts(n)[before[n]:]
           for n in DENSIFY_COUNTS + STEP_COUNTS}
    assert got["densify.cloned"] == [int(i.n_cloned) for i, _ in rounds]
    assert got["densify.split"] == [int(i.n_split) for i, _ in rounds]
    assert got["densify.pruned"] == [int(i.n_pruned) for i, _ in rounds]
    assert got["densify.active"] == [int(a.sum()) for _, a in rounds]
    assert sum(got["densify.cloned"]) > 0 and sum(got["densify.split"]) > 0
    # one value a step: the rows active during it, and the capacity
    assert got["densify.capacity"] == [CAP] * 4
    actives += [int(a.sum()) for _, a in rounds]
    assert got["densify.active_rows"] == [actives[0], actives[0],
                                          actives[1], actives[1]]


class _Ops(TorchDispatchMode):
    """Counts every aten op dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def test_density_control_without_a_profiler_adds_no_op_range_or_count(
        monkeypatch):
    """Without a profiler, density control runs the ops of the bare round
    and nothing else: no range, no count, no op of a counter."""
    Ops = _Ops

    made = collections.Counter()
    record = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: (
        made.update(["range"]), record(*a))[1])
    counted = {k: len(v) for k, v in profiling._COUNTS.items()}

    params, opt, dstate = control_state()
    with Ops() as mode:
        rounds, _ = run_control([2], params, opt, dstate)
    assert len(rounds) == 1
    params, opt, dstate = control_state()
    with Ops() as bare:
        pd.densify_step(params, opt, dstate, torch.Generator().manual_seed(4),
                        3.0, pd.DensifyConfig(max_screen_radius=20))
    assert mode.ops == bare.ops
    assert made == {}
    assert {k: len(v) for k, v in profiling._COUNTS.items()} == counted


def test_density_control_under_a_profiler_runs_the_same_ops():
    """The counters keep tensors the round has already made and sum them
    only when read: traced rounds dispatch the aten ops of untraced ones,
    no more."""
    params, opt, dstate = control_state()
    with _Ops() as plain:
        run_control(range(1, 5), params, opt, dstate)
    params, opt, dstate = control_state()
    with _Ops() as traced:
        profiled(lambda: run_control(range(1, 5), params, opt, dstate))
    # the ranges themselves are ops of the profiler's, which launch nothing
    aten = {k: v for k, v in traced.ops.items()
            if not k.startswith("profiler.")}
    assert aten == plain.ops
