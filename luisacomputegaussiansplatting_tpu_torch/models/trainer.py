"""Single-view training step (port of ``models/trainer.py``).

The graphdeco recipe: Adam with a learning rate per parameter group, the
photometric (1 - w) L1 + w D-SSIM loss, activations applied inside the step
(the raw parameters are what Adam updates). The optimizer is
``ops/adam.py::Adam``, a ``torch.optim.Adam`` whose update of CUDA
parameters is one kernel launch (K7), with one parameter group per
``GaussianParams`` field; the means group's learning rate follows optax's
``exponential_decay`` and is set from :func:`means_lr` before every
update, at the count of updates made so far, which is when optax evaluates
it.

Parameters are updated in place: the ``GaussianParams`` of a ``TrainState``
are leaf tensors that Adam steps, and a step returns the same tensors. The
Adam moments live in the optimizer (the JAX package's ``opt_state``), which
:func:`init_train_state` returns beside the state and the ``make_*_step``
functions take, as the JAX package passes ``opt``.

:func:`make_densify_train_step` and :func:`make_batched_train_step` also
accumulate the densification statistics (``models/densify.py``) through a
zero means2d probe, and cull the inactive rows through the active mask.

While a profiler records, a step is the range ``train_step`` with the
layers ``train_step.activate``, ``.loss``, ``.backward``, ``.optimizer``
and ``.stats`` (each view's ``render_view`` among them), and the backward
of activation and loss runs under ``train_step.activate.backward`` and
``train_step.loss.backward`` (``utils/profiling.py``). The batched step
also counts ``train_step.views`` (its B, once a step) and runs the
engine's sums of the views' gradients of the activated scene under
``train_step.accumulate.backward``; activation's backward range holds the
stack of the per-view probes' gradients.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..ops.adam import Adam
from ..ops.render import render_view
from ..utils.camera import CameraView
from ..utils.profiling import count, mark, span
from .densify import DensifyState, accumulate_stats, ndc_grad_norm
from .gaussians import GaussianParams
from .losses import d_ssim_l1_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Learning rates per parameter group and Adam's eps and betas
    (graphdeco defaults).

    The means learning rate decays exponentially from lr_means to
    lr_means_final over lr_means_decay_steps (graphdeco's
    get_expon_lr_func), both endpoints multiplied by spatial_lr_scale (the
    scene extent). lr_means_decay_steps=0 keeps it constant.
    """

    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_means_decay_steps: int = 30_000
    spatial_lr_scale: float = 1.0
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_sh_dc: float = 2.5e-3
    lr_sh_rest: float = 2.5e-3 / 20.0
    ssim_weight: float = 0.2
    adam_eps: float = 1e-15
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999


def means_lr(tc: TrainConfig, count: int) -> float:
    """The means learning rate after ``count`` updates: optax's
    ``exponential_decay(init=lr_means*s, transition_steps, decay_rate=
    final/init, end_value=lr_means_final*s)``, s = spatial_lr_scale."""
    init = tc.lr_means * tc.spatial_lr_scale
    if tc.lr_means_decay_steps <= 0 or count <= 0:
        return init
    rate = tc.lr_means_final / tc.lr_means
    value = init * rate ** (count / tc.lr_means_decay_steps)
    end = tc.lr_means_final * tc.spatial_lr_scale
    # end_value bounds the decay from below (above, for a rate > 1)
    return max(value, end) if rate < 1.0 else min(value, end)


def _group_lrs(tc: TrainConfig) -> dict:
    return {
        "means": means_lr(tc, 0),
        "log_scales": tc.lr_scales,
        "quats": tc.lr_quats,
        "opacity_logits": tc.lr_opacity,
        "sh_dc": tc.lr_sh_dc,
        "sh_rest": tc.lr_sh_rest,
    }


def make_optimizer(params: GaussianParams,
                   tc: TrainConfig = TrainConfig()) -> Adam:
    """Adam (``ops/adam.py``) over the six groups of ``params`` (leaf
    tensors that require grad), one learning rate each, eps
    ``tc.adam_eps`` and betas (``tc.adam_beta1``, ``tc.adam_beta2``)."""
    lrs = _group_lrs(tc)
    return Adam(
        [{"params": [getattr(params, name)], "lr": lrs[name], "name": name}
         for name in GaussianParams._fields],
        betas=(tc.adam_beta1, tc.adam_beta2), eps=tc.adam_eps,
    )


def optimizer_step(opt: torch.optim.Adam, tc: TrainConfig, count: int):
    """One Adam update from the gradients in ``.grad``, after ``count``
    earlier updates (which sets the means learning rate)."""
    for group in opt.param_groups:
        if group["name"] == "means":
            group["lr"] = means_lr(tc, count)
    opt.step()


class TrainState(NamedTuple):
    params: GaussianParams  # leaf tensors, updated in place
    step: int  # updates made so far


def init_train_state(params: GaussianParams, tc: TrainConfig = TrainConfig()):
    """Copy ``params`` into fresh leaf tensors; returns (state, the Adam
    optimizer over them)."""
    leaves = GaussianParams(
        *(p.detach().clone().requires_grad_(True) for p in params))
    return TrainState(params=leaves, step=0), make_optimizer(leaves, tc)


def _activate(params: GaussianParams):
    """The activated scene of the leaf ``params``, in its layer range (its
    backward range runs on through the gradients' accumulation into the
    leaves, to the end of the backward)."""
    with span("train_step.activate"):
        return mark("train_step.activate", params.activate())


def _loss(img, target, ssim_weight: float):
    """The photometric loss of one view, in its layer range."""
    with span("train_step.loss"):
        return mark("train_step.loss",
                    d_ssim_l1_loss(img, target, ssim_weight))


def _step_range(step):
    """``step`` with each call in the range ``train_step``."""

    def traced(*args):
        with span("train_step"):
            return step(*args)

    return functools.wraps(step)(traced)


def _backward_and_update(opt, loss, tc: TrainConfig, count: int):
    """Clear the gradients, backward from ``loss``, one Adam update."""
    opt.zero_grad(set_to_none=True)
    with span("train_step.backward"):
        loss.backward()
    with span("train_step.optimizer"):
        optimizer_step(opt, tc, count)


def photometric_loss(params: GaussianParams, cam_view: CameraView, target,
                     width: int, height: int, bg_color, cfg: RenderConfig,
                     sh_degree: int, ssim_weight: float):
    """(loss, (image, RenderAux)) of the activated ``params`` against the
    (3, H, W) ``target``."""
    scene = _activate(params)
    img, aux = render_view(
        scene.means, scene.scales, scene.quats, scene.opacities, scene.sh,
        cam_view, width, height, bg_color, cfg, sh_degree,
    )
    return _loss(img, target, ssim_weight), (img, aux)


def make_train_step(opt: torch.optim.Adam, width: int, height: int,
                    cfg: RenderConfig = RenderConfig(), sh_degree: int = 3,
                    tc: TrainConfig = TrainConfig(),
                    bg_color=(0.0, 0.0, 0.0)):
    """Single-view step: (state, cam_view, target) -> (state, loss, aux);
    ``loss`` is a detached 0-d tensor. ``opt`` is the optimizer that
    :func:`init_train_state` made over ``state.params``."""

    def step(state: TrainState, cam_view: CameraView, target):
        loss, (_img, aux) = photometric_loss(
            state.params, cam_view, target, width, height, bg_color, cfg,
            sh_degree, tc.ssim_weight,
        )
        _backward_and_update(opt, loss, tc, state.step)
        return (TrainState(state.params, state.step + 1),
                loss.detach(), aux)

    return _step_range(step)


def make_densify_train_step(opt: torch.optim.Adam, width: int, height: int,
                            cfg: RenderConfig = RenderConfig(),
                            sh_degree: int = 3,
                            tc: TrainConfig = TrainConfig(),
                            bg_color=(0.0, 0.0, 0.0)):
    """Single-view step that also accumulates the densification statistics:
    (state, dstate, cam_view, target) -> (state, dstate, loss, aux).

    The screen-space positional gradient comes from a zero (C, 2) means2d
    probe added in projection: its gradient is dL/d(means2d) in pixels.
    Rows that ``dstate.active`` marks inactive are culled."""

    def step(state: TrainState, dstate: DensifyState, cam_view: CameraView,
             target):
        params = state.params
        probe = torch.zeros((params.means.shape[0], 2), dtype=torch.float32,
                            device=params.means.device, requires_grad=True)
        scene = _activate(params)
        img, aux = render_view(
            scene.means, scene.scales, scene.quats, scene.opacities, scene.sh,
            cam_view, width, height, bg_color, cfg, sh_degree,
            active_mask=dstate.active, means2d_probe=probe,
        )
        loss = _loss(img, target, tc.ssim_weight)
        _backward_and_update(opt, loss, tc, state.step)
        with span("train_step.stats"):
            dstate = accumulate_stats(dstate, probe.grad, aux.radii, width,
                                      height)
        return TrainState(params, state.step + 1), dstate, loss.detach(), aux

    return _step_range(step)


def make_batched_train_step(opt: torch.optim.Adam, width: int, height: int,
                            cfg: RenderConfig = RenderConfig(),
                            sh_degree: int = 3,
                            tc: TrainConfig = TrainConfig(),
                            bg_color=(0.0, 0.0, 0.0)):
    """Densifying step over a batch of B views:
    (state, dstate, views, targets) -> (state, dstate, loss, overflow).

    ``views`` is a CameraView whose tensors are stacked over the views
    (view (B, 4, 4), position (B, 3), tan_fovx and tan_fovy (B,)),
    ``targets`` (B, 3, H, W). The views render one after another (the JAX
    package vmaps them); the loss is the mean of the per-view losses, with
    one backward. Statistics: the per-view probe-gradient norms are summed,
    the visibility count adds one per view that sees a gaussian, the max
    radii take the batch max; ``overflow`` is any view's.

    Each view reads the activated scene through its own marker while a
    profiler records, so that the engine's sums of the views' gradients
    (B - 1 sums of 59 floats a gaussian) run under
    ``train_step.accumulate.backward`` rather than under no range; the
    step counts ``train_step.views``."""

    def step(state: TrainState, dstate: DensifyState, views: CameraView,
             targets):
        params = state.params
        n_views = targets.shape[0]
        # a probe per view: graphdeco accumulates ||dL_v/d means2d|| per
        # view; one shared probe would give the norm of the batch-summed
        # gradient, understated ~B-fold (and cancelling across views)
        probe = torch.zeros((n_views, params.means.shape[0], 2),
                            dtype=torch.float32, device=params.means.device,
                            requires_grad=True)
        # unbind, not probe[v]: its backward is one stack, not a
        # zero-filled (B, C, 2) buffer per view
        probes = probe.unbind(0)
        count("train_step.views", n_views)
        scene = _activate(params)
        losses, radii, overflow = [], [], []
        for v in range(n_views):
            view_scene = mark("train_step.accumulate", scene)
            img, aux = render_view(
                view_scene.means, view_scene.scales, view_scene.quats,
                view_scene.opacities, view_scene.sh,
                CameraView(*(x[v] for x in views)), width, height,
                bg_color, cfg, sh_degree, active_mask=dstate.active,
                means2d_probe=probes[v],
            )
            losses.append(_loss(img, targets[v], tc.ssim_weight))
            radii.append(aux.radii)
            overflow.append(aux.overflow)
        with span("train_step.loss"):
            loss = mark("train_step.loss", torch.mean(torch.stack(losses)))
        _backward_and_update(opt, loss, tc, state.step)

        with span("train_step.stats"):
            radii = torch.stack(radii)  # (B, C)
            visible = radii > 0
            # probe.grad[v] is dL_v/d probe / B (the loss is the batch
            # mean): undo the 1/B so each view's norm is a single-view
            # step's
            g = ndc_grad_norm(probe.grad * float(n_views), width, height)
            dstate = DensifyState(
                grad_sum=dstate.grad_sum + torch.sum(
                    torch.where(visible, g, 0.0), dim=0),
                count=dstate.count + torch.sum(visible, dim=0).to(
                    torch.float32),
                max_radii=torch.maximum(dstate.max_radii,
                                        torch.amax(radii, dim=0)),
                active=dstate.active,
            )
            any_overflow = torch.any(torch.stack(overflow))
        return (TrainState(params, state.step + 1), dstate, loss.detach(),
                any_overflow)

    return _step_range(step)
