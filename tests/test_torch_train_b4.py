"""PyTorch port: the batched multi-view step
(``models/trainer.py::make_batched_train_step``) at four views a step with
gsplat's batch-4 rates, eps and betas (``gsbench/configs/
mip360-bicycle-6M-b4.json``), against the plain reference of
``gsbench/reference/train_batched.py``, for two steps on the CPU at a
small seeded scene with the configuration's render block (tile 32, cull,
bf16 payload and gradient rows, mxu).

Tolerances, each from the reason beside it:
  * the loss within 1e-6 relative: the same pixels summed in another order
    (measured <= 6e-8);
  * each group's gradient (Adam's first moment over 1 - beta1) within
    4e-3 of its largest element, elementwise, and its norm within 1e-5:
    a bf16-rounded gradient row that rounds the other way moves an element
    by up to a bf16 ulp of its row, 2^-8 (``gsbench/tests/
    test_gsbench_reference.py``'s tolerance; measured <= 8e-6, norms <=
    1.2e-7);
  * ``grad_sum`` within 4e-3 of its largest element, the same rows'
    rounding through projection's backward (measured <= 2.5e-6);
    ``count`` and ``max_radii`` exact (the same integer radii);
  * the parameters after two updates: each group's change norm within
    1e-4, and at most 0.1% of its elements more than 1e-2 of its largest
    change away: with eps 5e-16 Adam turns a rounding-level gradient into
    a step of up to the learning rate, in either direction (measured: norms
    <= 1.8e-7, no element beyond 1e-3).

No JAX here.
"""

import functools

import torch

from gsbench import harness, inputs
from gsbench.loops import train as T
from gsbench.reference import train as RT
from gsbench.reference import train_batched as RB
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models import densify, trainer
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianParams
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView

torch.set_num_threads(2)

CPU = torch.device("cpu")
SMALL = {"config": {"scene": {"n_gaussians": 2000},
                    "dataset": {"width": 80, "height": 56, "images": 12},
                    "render": {"max_pairs": 60000,
                               "max_pairs_sorted": None}}}
#: the views of the two steps, four each
USED = [3, 7, 1, 9, 0, 5, 2, 8]
B = 4


def _inputs(cell_name):
    cell = harness.make_cell(cell_name, 11, CPU, SMALL)
    cfg = cell.config
    ds = cfg["dataset"]
    raw = inputs.draw_params(cfg["scene"], cell.seed, CPU)
    views = inputs.train_views(ds, CPU)
    targets = inputs.draw_targets(len(views), ds["width"], ds["height"],
                                  cell.seed, CPU)
    return cell, raw, views, targets


def _reference(cell_name, n_steps, batch, fault=None):
    cell, raw, views, targets = _inputs(cell_name)
    ds = cell.config["dataset"]
    used = USED[:n_steps * batch]
    return RB.train_batched_steps(
        raw, [views[v] for v in used], [targets[v] for v in used],
        ds["width"], ds["height"], tuple(ds["background"]), T.settings(cell),
        cell.config["train"], n_steps, batch, fault=fault)


@functools.lru_cache(maxsize=None)
def program():
    """Two batched steps of the port: (the first step's gradients, the
    statistics after it, the losses, the parameters after both, the
    optimizer)."""
    cell, raw, views, targets = _inputs("bicycle-train-b4")
    cfg = cell.config
    ds = cfg["dataset"]
    tc = trainer.TrainConfig(**cfg["train"])
    state, opt = trainer.init_train_state(GaussianParams(*raw), tc)
    n = raw[0].shape[0]
    dstate = densify.init_densify_state(n, n, device=CPU)
    step = trainer.make_batched_train_step(
        opt, ds["width"], ds["height"], cfg=RenderConfig(**cfg["render"]),
        tc=tc)
    losses = []
    for k in range(2):
        vs = USED[k * B:(k + 1) * B]
        cams = CameraView(*(torch.stack(x) for x in
                            zip(*(views[v] for v in vs))))
        state, dstate, loss, overflow = step(state, dstate, cams, targets[vs])
        assert not bool(overflow)
        losses.append(float(loss))
        if k == 0:
            stats = tuple(x.clone() for x in dstate[:3])
            grads = [opt.state[p]["exp_avg"] / (1.0 - g["betas"][0])
                     for p, g in zip(state.params, opt.param_groups)]
    return grads, stats, losses, [p.detach() for p in state.params], opt


@functools.lru_cache(maxsize=None)
def reference():
    return _reference("bicycle-train-b4", 2, B)


def test_the_step_takes_gsplats_batch_rule():
    *_, opt = program()
    assert [g["betas"] for g in opt.param_groups] == [(0.6, 0.996)] * 6
    assert [g["eps"] for g in opt.param_groups] == [5e-16] * 6
    lrs = {g["name"]: g["lr"] for g in opt.param_groups}
    assert lrs["log_scales"] == 0.01 and lrs["sh_rest"] == 2.5e-4


def test_loss_and_gradients_match_the_reference():
    grads, _, losses, _, _ = program()
    ref = reference()
    for got, want in zip(losses, ref["losses"]):
        assert abs(got - want) <= 1e-6 * want
    for name, a, b in zip(RT.GROUPS, grads, ref["grads"]):
        scale = float(b.abs().max())
        assert scale > 0, name
        assert float((a - b).abs().max()) <= 4e-3 * scale, name
        assert abs(float(a.norm() / b.norm()) - 1.0) <= 1e-5, name


def test_statistics_match_the_reference():
    _, (grad_sum, count, max_radii), _, _, _ = program()
    want_sum, want_count, want_radii = reference()["stats"]
    assert float(want_sum.max()) > 0
    assert float((grad_sum - want_sum).abs().max()) <= \
        4e-3 * float(want_sum.abs().max())
    # some gaussians are seen by more than one view of the batch
    assert float(want_count.max()) > 1
    assert torch.equal(count, want_count)
    assert torch.equal(max_radii, want_radii)


def test_parameters_after_two_updates_match_the_reference():
    _, _, _, params, _ = program()
    ref = reference()
    _, raw, _, _ = _inputs("bicycle-train-b4")
    for name, a, b, r in zip(RT.GROUPS, params, ref["params"], raw):
        largest = float((b - r).abs().max())
        assert largest > 0, name
        assert abs(float((a - r).norm() / (b - r).norm()) - 1.0) <= 1e-4
        off = int(((a - b).abs() > 1e-2 * largest).sum())
        assert off <= 1e-3 * a.numel(), (name, off)


def test_one_view_a_step_is_the_single_view_reference():
    """At B = 1 (the single-view configuration's rates and betas) the
    batched reference is ``reference/train.py::train_steps``, bit for
    bit."""
    one = _reference("bicycle-train", 2, 1)
    cell, raw, views, targets = _inputs("bicycle-train")
    ds = cell.config["dataset"]
    single = RT.train_steps(raw, [views[v] for v in USED[:2]],
                            [targets[v] for v in USED[:2]], ds["width"],
                            ds["height"], tuple(ds["background"]),
                            T.settings(cell), cell.config["train"], 2)
    for key in ("losses", "grad_norms", "change_norms", "overflow"):
        assert one[key] == single[key], key
    for a, b in zip(one["stats"], single["stats"]):
        assert torch.equal(a, b)


def test_a_shared_probe_understates_grad_sum_and_fails():
    """One probe for the four views: every ``grad_sum`` entry at most the
    per-view probes', the sum's norm well under, and the cell's check
    fails it."""
    want = reference()["stats"]
    shared = _reference("bicycle-train-b4", 1, B, fault="shared_probe")
    assert bool((shared["stats"][0] <= want[0]).all())
    assert float(shared["stats"][0].norm()) < 0.9 * float(want[0].norm())
    assert torch.equal(shared["stats"][1], want[1])
    limit = harness.make_cell("bicycle-train-b4", 0, CPU).spec[
        "limits"]["stats_gap"]
    gaps = [T.gap(p, r) for p, r in zip(RT.stats_norms(shared["stats"]),
                                         RT.stats_norms(want))]
    assert max(gaps) > limit
