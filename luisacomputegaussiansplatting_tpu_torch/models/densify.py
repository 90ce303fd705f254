"""Adaptive density control at a static capacity (port of
``models/densify.py``): clone, split and prune, the graphdeco 3DGS recipe.

  * accumulate the screen-space positional gradient norm and the visibility
    count of every gaussian between rounds;
  * each round: CLONE small high-gradient gaussians (a copy, both keep
    moving), SPLIT large high-gradient ones into children drawn from the
    parent (scales / ``split_shrink``, the parent retired), PRUNE gaussians
    below ``min_opacity`` or, when enabled, too large;
  * now and then clamp every opacity down (``reset_opacity``).

The parameters live at a fixed capacity C with an ``active`` mask: a round
rewrites rows and never reshapes. Inactive rows are culled in projection
through the mask (``ops/projection.py``), so they cost no entries, and are
parked transparent (logit -15) and tiny (log-scale -18). Children go to the
free slots in ascending order (one stable argsort); the Adam moments of
every row that does not survive are zeroed (children always land in such
rows), graphdeco's optimizer surgery.

The parameters of a ``TrainState`` are leaf tensors that the trainer's Adam
(``ops/adam.py``, a ``torch.optim.Adam`` with torch's state) steps, so a
round writes into those same tensors under ``torch.no_grad()`` and returns
them: a new tensor would leave the optimizer stepping the old one. Their
stale ``.grad`` is cleared. Adam's ``step`` is left alone, as optax leaves
its ``count``.

The round is :func:`densify_round`, which takes the split noise as a
tensor; :func:`densify_step` draws that noise from a ``torch.Generator``
and calls it. :func:`densify_plan` is the round's decision (the masks and
where each child goes), which the round computes first.

When the rounds, the size prunes and the opacity resets come is a
:class:`DensifySchedule`; :func:`density_control` does what it asks after
a given iteration. The train CLI and the benchmark call it after every
step.

While a profiler records, a round called through :func:`density_control`
is the range ``train_step.densify`` with ``train_step.densify.plan`` (the
decision), ``.write`` (the rows' gathers and scatters) and ``.adam`` (the
moment surgery), and counts ``densify.cloned``, ``densify.split``,
``densify.pruned`` and ``densify.active`` (after the round) once a round;
:func:`density_control` counts ``densify.active_rows`` and
``densify.capacity`` once a call (``utils/profiling.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.profiling import count, span
from ..utils.transform import rotation_from_quaternion
from .gaussians import GaussianParams

#: the values parked (retired or never born) rows hold
PARKED_OPACITY_LOGIT = -15.0
PARKED_LOG_SCALE = -18.0


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """graphdeco-default thresholds (their train.py / gaussian_model.py)."""

    #: screen-space grad-norm threshold in graphdeco's NDC-scaled units
    #: (their 2e-4): the trainers accumulate the probe gradients through
    #: ndc_grad_norm (pixel gradient x W/2, H/2), so this is graphdeco's
    #: value at every resolution.
    grad_threshold: float = 2e-4
    #: fraction of the scene extent below which a gaussian is "small"
    #: (cloned) rather than "large" (split).
    percent_dense: float = 0.01
    #: children per split and the scale shrink factor; None derives the
    #: shrink as graphdeco does (0.8 x children), a float overrides it.
    split_children: int = 2
    split_scale_shrink: float | None = None
    #: prune gaussians whose opacity falls below this.
    min_opacity: float = 0.005
    #: in a round that prunes by size, prune gaussians whose max screen
    #: radius exceeded this many pixels (0: no screen test).
    max_screen_radius: int = 0
    #: in a round that prunes by size, prune gaussians larger than this
    #: fraction of the scene extent (0: no world test).
    max_world_scale_frac: float = 0.1
    #: whether the round prunes by size (graphdeco: after the first opacity
    #: reset), which :func:`density_control` sets round by round from its
    #: :class:`DensifySchedule`; None: where ``max_screen_radius`` is set,
    #: as the JAX package decides it.
    size_prune: bool | None = None
    #: opacity ceiling applied by reset_opacity.
    reset_opacity_to: float = 0.01

    @property
    def split_shrink(self) -> float:
        if self.split_scale_shrink is not None:
            return self.split_scale_shrink
        return 0.8 * self.split_children


class DensifyInfo(NamedTuple):
    """One round's counters, 0-d tensors on the parameters' device."""

    overflow: torch.Tensor  # () bool: children dropped (capacity full)
    n_cloned: torch.Tensor  # () int32
    n_split: torch.Tensor  # () int32
    n_pruned: torch.Tensor  # () int32: opacity/size prunes, not split parents


class DensifyState(NamedTuple):
    grad_sum: torch.Tensor  # (C,) f32: sum of NDC-scaled ||dL/d means2d||
    count: torch.Tensor  # (C,) f32: views the gaussian was visible in
    max_radii: torch.Tensor  # (C,) i32: max screen radius since the round
    active: torch.Tensor  # (C,) bool

    @property
    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active.to(torch.int32))


class DensifyPlan(NamedTuple):
    """What a round decides, before it writes anything."""

    clone: torch.Tensor  # (C,) bool
    split: torch.Tensor  # (C,) bool: after the capacity gate
    prune: torch.Tensor  # (C,) bool
    survivors: torch.Tensor  # (C,) bool: active, not pruned, not split
    overflow: torch.Tensor  # () bool
    parent: torch.Tensor  # (K,) int64: the row each placed child copies
    child: torch.Tensor  # (K,) int64: its index among the parent's children
    dest: torch.Tensor  # (K,) int64: its slot, distinct and not a survivor


def init_densify_state(n_active: int, capacity: int,
                       device="cuda") -> DensifyState:
    """Zero statistics, the first ``n_active`` rows active, on ``device``
    (by default the card; without a GPU, pass ``device="cpu"``)."""
    if n_active > capacity:
        raise ValueError(f"{n_active} gaussians > capacity {capacity}")
    dev = resolve_device(device)
    return DensifyState(
        grad_sum=torch.zeros(capacity, dtype=torch.float32, device=dev),
        count=torch.zeros(capacity, dtype=torch.float32, device=dev),
        max_radii=torch.zeros(capacity, dtype=torch.int32, device=dev),
        active=torch.arange(capacity, device=dev) < n_active,
    )


def densify_state_from_numpy(grad_sum, count, max_radii, active,
                             device) -> DensifyState:
    """A ``DensifyState`` as numpy arrays (the JAX package's fields, in
    order) -> tensors on ``device``."""
    dev = resolve_device(device)

    def tensor(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(dev)

    return DensifyState(
        grad_sum=tensor(grad_sum, np.float32),
        count=tensor(count, np.float32),
        max_radii=tensor(max_radii, np.int32),
        active=tensor(active, np.bool_),
    )


def ndc_grad_norm(probe_grad, width=None, height=None):
    """||dL/d means2d|| in graphdeco's NDC-scaled units.

    The probe gradient (``ops/projection.py`` means2d_probe) is in pixel
    units; graphdeco's threshold applies to gradients with respect to
    half-screen NDC coordinates (their rasterizer backward multiplies the
    pixel-space gradient by W/2, H/2), so scaling here makes
    ``grad_threshold=2e-4`` theirs at every resolution. width/height None
    keeps pixel units.
    """
    g = probe_grad
    if width is not None:
        g = g * torch.tensor([width * 0.5, (height or width) * 0.5],
                             dtype=g.dtype, device=g.device)
    return torch.sqrt(torch.sum(g * g, dim=-1))


def accumulate_stats(state: DensifyState, probe_grad, radii, width=None,
                     height=None) -> DensifyState:
    """Fold one view's statistics in.

    Args:
      probe_grad: (C, 2) gradient of the loss with respect to the
        pixel-space means2d probe.
      radii: (C,) int32 screen radii from RenderAux (0 = not visible).
      width/height: the render's resolution; when given the norm is in
        NDC-scaled units (see ndc_grad_norm).
    """
    visible = radii > 0
    g = ndc_grad_norm(probe_grad, width, height)
    return DensifyState(
        grad_sum=state.grad_sum + torch.where(visible, g, 0.0),
        count=state.count + visible.to(torch.float32),
        max_radii=torch.maximum(state.max_radii, radii),
        active=state.active,
    )


def densify_plan(params: GaussianParams, state: DensifyState,
                 scene_extent: float,
                 cfg: DensifyConfig = DensifyConfig()) -> DensifyPlan:
    """The masks of one round and the slot of every child it places (the
    JAX package's ``densify_step`` up to its scatter)."""
    with torch.no_grad():
        active = state.active
        avg_grad = state.grad_sum / torch.clamp(state.count, min=1.0)
        scale_max = torch.exp(params.log_scales).amax(dim=1)
        opacity = torch.sigmoid(params.opacity_logits)

        high_grad = active & (avg_grad > cfg.grad_threshold) & (state.count > 0)
        small = scale_max <= cfg.percent_dense * scene_extent
        prune = active & (opacity < cfg.min_opacity)
        size_prune = (cfg.max_screen_radius > 0 if cfg.size_prune is None
                      else cfg.size_prune)
        if size_prune and cfg.max_screen_radius > 0:
            prune |= active & (state.max_radii > cfg.max_screen_radius)
        if size_prune and cfg.max_world_scale_frac > 0:
            prune |= active & (
                scale_max > cfg.max_world_scale_frac * scene_extent)
        clone = high_grad & small & ~prune
        want_split = high_grad & ~small & ~prune

        # the split-placement gate: a split retires its parent, so a parent
        # whose children cannot all be placed must not split (at full
        # capacity the highest-gradient content would be deleted). The
        # bound counts free slots without any split retirement (those only
        # add slots); a demoted parent stays alive, unchanged, for the next
        # round.
        n_free0 = torch.sum(~(active & ~prune))
        kids0 = clone.to(torch.int64) + want_split.to(torch.int64) * cfg.split_children
        split = want_split & (torch.cumsum(kids0, 0) <= n_free0)
        survivors = active & ~prune & ~split

        # free slots ascending; the k-th child takes free_ids[k]
        free_ids = torch.argsort(survivors.to(torch.int32), stable=True)
        n_free = torch.sum(~survivors)
        kids = clone.to(torch.int64) + split.to(torch.int64) * cfg.split_children
        kid_end = torch.cumsum(kids, 0)
        kid_start = kid_end - kids
        # clones beyond capacity are dropped (the parent survives); demoted
        # splits count as overflow too, so callers grow the capacity
        overflow = (kid_end[-1] > n_free) | torch.any(want_split & ~split)

        parent, child, dest = [], [], []
        for ci in range(cfg.split_children):
            has_kid = (clone | split) if ci == 0 else split
            rank = kid_start + ci
            rows = torch.nonzero(has_kid & (rank < n_free)).reshape(-1)
            parent.append(rows)
            child.append(torch.full_like(rows, ci))
            dest.append(free_ids[rank[rows]])
        return DensifyPlan(
            clone=clone, split=split, prune=prune, survivors=survivors,
            overflow=overflow, parent=torch.cat(parent),
            child=torch.cat(child), dest=torch.cat(dest),
        )


def densify_round(params: GaussianParams, opt, state: DensifyState, noise,
                  scene_extent: float, cfg: DensifyConfig = DensifyConfig()):
    """One densify-and-prune round with the split noise given.

    Args:
      params: GaussianParams at capacity C; rewritten in place.
      opt: the trainer's Adam over ``params`` (the Adam moments of
        every rewritten row are zeroed), or None.
      noise: (C, split_children, 3) float32 standard normal samples; the
        split children of row i sit at N(mean_i, Sigma_i) through
        noise[i, child].
      scene_extent: world-space scene radius (graphdeco: camera extent).

    Returns:
      (params, opt, DensifyState, DensifyInfo): the same parameter tensors;
      statistics reset; ``info.overflow`` True where children were dropped
      because the capacity ran out.
    """
    with span("train_step.densify.plan"):
        plan = densify_plan(params, state, scene_extent, cfg)
    with torch.no_grad(), span("train_step.densify.write"):
        # every child's row from the parameters before any write (a split
        # parent's own slot may receive another parent's child)
        p, ci = plan.parent, plan.child
        rows = {f: getattr(params, f)[p] for f in GaussianParams._fields}
        s = torch.nonzero(plan.split[p]).reshape(-1)  # the split children
        sp = p[s]
        q = params.quats[sp]
        qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=1, keepdim=True),
                             min=1e-12)
        rot = rotation_from_quaternion(qn)  # (S, 3, 3)
        v = noise[sp, ci[s]] * torch.exp(params.log_scales[sp])  # (S, 3)
        offset = (rot[:, :, 0] * v[:, None, 0] + rot[:, :, 1] * v[:, None, 1]
                  + rot[:, :, 2] * v[:, None, 2])
        rows["means"][s] = params.means[sp] + offset
        shrink = torch.log(torch.tensor(cfg.split_shrink, dtype=torch.float32,
                                        device=q.device))
        rows["log_scales"][s] = params.log_scales[sp] - shrink
        for f, r in rows.items():
            getattr(params, f)[plan.dest] = r
        new_active = plan.survivors.clone()
        new_active[plan.dest] = True
        # park the inactive rows: transparent and tiny (belt over the mask)
        parked = ~new_active
        params.opacity_logits.masked_fill_(parked, PARKED_OPACITY_LOGIT)
        params.log_scales.masked_fill_(parked[:, None], PARKED_LOG_SCALE)
        for t in params:
            t.grad = None

    # children always land in non-survivor rows, so zeroing every
    # non-survivor row resets exactly the rewritten ones
    if opt is not None:
        with span("train_step.densify.adam"):
            _zero_adam_moments_where(opt, ~plan.survivors)

    with torch.no_grad():
        c = params.means.shape[0]
        dev = params.means.device
        fresh = DensifyState(
            grad_sum=torch.zeros(c, dtype=torch.float32, device=dev),
            count=torch.zeros(c, dtype=torch.float32, device=dev),
            max_radii=torch.zeros(c, dtype=torch.int32, device=dev),
            active=new_active,
        )
        info = DensifyInfo(
            overflow=plan.overflow,
            n_cloned=torch.sum(plan.clone.to(torch.int32)),
            n_split=torch.sum(plan.split.to(torch.int32)),
            n_pruned=torch.sum(plan.prune.to(torch.int32)),
        )
    count("densify.cloned", info.n_cloned)
    count("densify.split", info.n_split)
    count("densify.pruned", info.n_pruned)
    count("densify.active", new_active)
    return params, opt, fresh, info


def densify_step(params: GaussianParams, opt, state: DensifyState,
                 generator: torch.Generator, scene_extent: float,
                 cfg: DensifyConfig = DensifyConfig()):
    """:func:`densify_round` with its split noise drawn from ``generator``
    (a generator on the parameters' device)."""
    c = params.means.shape[0]
    noise = torch.randn((c, cfg.split_children, 3), generator=generator,
                        dtype=torch.float32, device=params.means.device)
    return densify_round(params, opt, state, noise, scene_extent, cfg)


def reset_opacity(params: GaussianParams, state: DensifyState,
                  cfg: DensifyConfig = DensifyConfig(), opt=None):
    """Clamp every active opacity to at most ``reset_opacity_to`` (graphdeco
    reset_opacity: min(opacity, 0.01) in activation space), in place.

    With ``opt`` the opacity group's Adam moments are zeroed too (graphdeco
    replace_tensor_to_optimizer): moments of the gradients before the reset
    would push the opacities straight back up. Returns ``params``, or
    ``(params, opt)`` when ``opt`` is given.
    """
    logits = params.opacity_logits
    with torch.no_grad():
        to = torch.tensor(cfg.reset_opacity_to, dtype=torch.float32,
                          device=logits.device)
        target = torch.log(to) - torch.log1p(-to)
        logits.copy_(torch.where(state.active, torch.minimum(logits, target),
                                 logits))
    if opt is None:
        return params
    _zero_adam_moments_where(opt, None, group="opacity_logits")
    return params, opt


def _zero_adam_moments_where(opt, row_mask, group=None):
    """Zero the rows of ``exp_avg`` and ``exp_avg_sq`` where ``row_mask``
    is True (every row when it is None), in every parameter group or only
    the group named ``group``. A parameter that Adam has not stepped yet
    has no moments and is skipped; ``step`` is left alone."""
    with torch.no_grad():
        for g in opt.param_groups:
            if group is not None and g.get("name") != group:
                continue
            for p in g["params"]:
                st = opt.state.get(p, {})
                for key in ("exp_avg", "exp_avg_sq"):
                    if key not in st:
                        continue
                    m = st[key]
                    if row_mask is None:
                        m.zero_()
                    else:
                        m.masked_fill_(row_mask.reshape(
                            (-1,) + (1,) * (m.dim() - 1)), 0.0)


@dataclasses.dataclass(frozen=True)
class DensifySchedule:
    """When density control acts, by the global iteration ``i``: the
    number of steps done, graphdeco's 1-based ``iteration``, after whose
    step it is asked. The defaults are graphdeco's (``OptimizationParams``
    and ``train.py``'s densification block):

      * a round when ``start < i < stop`` and ``i % interval == 0``;
      * the round prunes by size (the tests that ``DensifyConfig``'s
        ``max_screen_radius`` and ``max_world_scale_frac`` set) only when
        ``i > size_prune_after`` (graphdeco: after the first opacity
        reset); None never;
      * an opacity reset when ``i < stop`` and ``i % reset_interval ==
        0``; 0 never.
    """

    start: int = 500
    stop: int = 15_000
    interval: int = 100
    reset_interval: int = 3_000
    size_prune_after: int | None = 3_000

    def wants_round(self, i: int) -> bool:
        return (self.interval > 0 and self.start < i < self.stop
                and i % self.interval == 0)

    def wants_size_prune(self, i: int) -> bool:
        return self.size_prune_after is not None and i > self.size_prune_after

    def wants_reset(self, i: int) -> bool:
        return (self.reset_interval > 0 and i < self.stop
                and i % self.reset_interval == 0)


def density_control(i: int, schedule: DensifySchedule,
                    params: GaussianParams, opt, state: DensifyState,
                    generator: torch.Generator, scene_extent: float,
                    cfg: DensifyConfig = DensifyConfig(), round_fn=None):
    """The density control ``schedule`` asks for after iteration ``i``: a
    round (``round_fn``, by default :func:`densify_step`, called as it is,
    with ``cfg.size_prune`` the schedule's), then an opacity reset. Reads
    nothing on the host.

    Returns (opt, DensifyState, the round's DensifyInfo or None).
    """
    count("densify.active_rows", state.active)
    count("densify.capacity", state.active.shape[0])
    info = None
    if schedule.wants_round(i):
        rcfg = dataclasses.replace(
            cfg, size_prune=schedule.wants_size_prune(i))
        with span("train_step.densify"):
            _, opt, state, info = (round_fn or densify_step)(
                params, opt, state, generator, scene_extent, rcfg)
    if schedule.wants_reset(i):
        _, opt = reset_opacity(params, state, cfg, opt=opt)
    return opt, state, info
