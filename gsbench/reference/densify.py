"""The plain reference of one round of graphdeco's adaptive density control
(Kerbl et al., SIGGRAPH 2023, section 5.2; graphdeco-inria/gaussian-splatting,
``scene/gaussian_model.py``: ``densify_and_prune``, ``densify_and_clone``,
``densify_and_split``, ``prune_points``, ``densification_postfix``), at a
static capacity. Plain float32 PyTorch; imports nothing of the program.

A round, from the statistics gathered since the last one (the NDC-scaled
screen-space gradient norm summed over the views that saw a gaussian, the
count of those views, the largest screen radius):

  * the average gradient, sum over count (0 where no view saw it), and the
    high-gradient test against the threshold;
  * clone a high-gradient gaussian whose largest scale is at most
    ``percent_dense`` x the scene extent (one copy), split a larger one
    into ``split_children`` children at N(mean, Sigma) from the given
    standard normal noise, scales divided by 0.8 x ``split_children``,
    the parent retired;
  * prune a gaussian below ``min_opacity`` and, where the round prunes by
    size, one whose screen radius exceeded ``max_screen_radius`` (where
    that is not 0) or whose largest scale exceeds ``max_world_scale_frac``
    x the extent (where that is not 0);
  * new rows start with zero Adam moments.

Departures from graphdeco, who grows and shrinks its tensors where this
keeps a capacity C of rows with an active mask:

  * children go to the free rows (not active, or retired by this round) in
    ascending order, in the order of their parents' rows, a split parent's
    children one after the other; graphdeco appends the clones, then the
    split children;
  * a retired or never-born row is parked: opacity logit -15, log-scale
    -18, its other values left as they were; graphdeco deletes it;
  * the Adam moments of every row that does not survive the round (the
    children's rows and the retired ones) are zeroed; graphdeco appends
    zero moments for its new rows and drops the moments of the removed;
  * the prunes are decided on the state before the round, and a pruned
    gaussian is neither cloned nor split; graphdeco clones and splits
    first and then prunes, its new rows too, with the screen radii that
    its ``densification_postfix`` has just reset to zero, so that its
    screen test never prunes: a configuration that runs graphdeco's code
    sets ``max_screen_radius`` to 0;
  * a split whose children would not all find a free row (counted before
    any parent retires) does not split, and children past the last free
    row are dropped: the round reports an overflow. Graphdeco has no
    capacity;
  * the gradient test is strict (> threshold; graphdeco >=).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PARKED_OPACITY_LOGIT = -15.0
PARKED_LOG_SCALE = -18.0


class Settings(NamedTuple):
    grad_threshold: float = 2e-4
    percent_dense: float = 0.01
    split_children: int = 2
    min_opacity: float = 0.005
    max_screen_radius: int = 20
    max_world_scale_frac: float = 0.1

    @classmethod
    def from_config(cls, d: dict) -> "Settings":
        return cls(**{k: d[k] for k in cls._fields})


class Result(NamedTuple):
    params: tuple  # the six fields after the round
    exp_avg: tuple  # Adam's first moments after the round
    exp_avg_sq: tuple  # Adam's second moments after the round
    active: torch.Tensor  # (C,) bool
    counts: dict  # cloned, split, pruned, active
    overflow: bool


def schedule(i: int, d: dict):
    """(a round is due, it prunes by size) after iteration ``i``, as
    graphdeco's ``train.py`` decides them: a round when ``start`` < i <
    ``stop`` and i is a multiple of ``interval``, by size when i >
    ``size_prune_after``."""
    due = d["start"] < i < d["stop"] and i % d["interval"] == 0
    return due, i > d["size_prune_after"]


def rotation(q):
    """(S, 4) quaternions (x, y, z, w), normalised here -> (S, 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    x, y, z, w = q.unbind(1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], 1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], 1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], 1),
    ], 1)


def densify_round(params, exp_avg, exp_avg_sq, grad_sum, count, max_radii,
                  active, noise, extent: float, s: Settings,
                  size_prune: bool, fault: str | None = None) -> Result:
    """One round on copies of ``params`` (six raw fields at capacity C) and
    of the Adam moments (six each, or None where Adam has none yet).
    ``noise``: (C, split_children, 3) standard normals; the k-th child of
    a split row i sits at mean_i + R_i (scale_i * noise[i, k]).

    ``fault`` plants one for the check's own test: "no_surgery", the
    moments are left as they were; "no_shrink", split children keep their
    parent's scales; "skipped", no round at all.
    """
    params = [p.clone() for p in params]
    m = [None if t is None else t.clone() for t in exp_avg]
    v = [None if t is None else t.clone() for t in exp_avg_sq]
    c = active.shape[0]
    if fault == "skipped":
        n = int(active.sum())
        return Result(tuple(params), tuple(m), tuple(v), active.clone(),
                      {"cloned": 0, "split": 0, "pruned": 0, "active": n},
                      False)
    means, log_scales, quats, logits = params[:4]

    grads = grad_sum / count
    grads = torch.where(torch.isnan(grads), torch.zeros_like(grads), grads)
    high = active & (grads > s.grad_threshold)
    scale_max = torch.exp(log_scales).max(dim=1).values
    small = scale_max <= s.percent_dense * extent
    prune = active & (torch.sigmoid(logits) < s.min_opacity)
    if size_prune and s.max_screen_radius > 0:
        prune = prune | (active & (max_radii > s.max_screen_radius))
    if size_prune and s.max_world_scale_frac > 0:
        prune = prune | (active & (
            scale_max > s.max_world_scale_frac * extent))
    clone = high & small & ~prune
    want_split = high & ~small & ~prune

    # the capacity: a parent splits only while its children, counted with
    # every earlier row's in row order, fit in the rows free before the
    # round retires any parent
    n_free_before = int((~(active & ~prune)).sum())
    wanted = clone.long() + want_split.long() * s.split_children
    split = want_split & (torch.cumsum(wanted, 0) <= n_free_before)
    survivors = active & ~prune & ~split

    # the children, in the order of their parents' rows, each to the next
    # free row
    kids = clone.long() + split.long() * s.split_children
    parent = torch.repeat_interleave(torch.arange(c, device=kids.device), kids)
    first = torch.repeat_interleave(torch.cumsum(kids, 0) - kids, kids)
    child = torch.arange(parent.shape[0], device=kids.device) - first
    free = torch.nonzero(~survivors).reshape(-1)
    overflow = parent.shape[0] > free.shape[0] or bool(
        (want_split & ~split).any())
    parent, child = parent[:free.shape[0]], child[:free.shape[0]]
    dest = free[:parent.shape[0]]

    rows = [p[parent].clone() for p in params]
    is_split = split[parent]
    sp, sc = parent[is_split], child[is_split]
    scales = torch.exp(log_scales[sp])
    sample = scales * noise[sp, sc]
    offset = torch.bmm(rotation(quats[sp]), sample[:, :, None])[:, :, 0]
    rows[0][is_split] = means[sp] + offset
    if fault != "no_shrink":
        rows[1][is_split] = torch.log(scales / (0.8 * s.split_children))
    for p, r in zip(params, rows):
        p[dest] = r

    new_active = survivors.clone()
    new_active[dest] = True
    params[3][~new_active] = PARKED_OPACITY_LOGIT
    params[1][~new_active] = PARKED_LOG_SCALE
    if fault != "no_surgery":
        for t in m + v:
            if t is not None:
                t[~survivors] = 0.0
    counts = {"cloned": int(clone.sum()), "split": int(split.sum()),
              "pruned": int(prune.sum()), "active": int(new_active.sum())}
    return Result(tuple(params), tuple(m), tuple(v), new_active, counts,
                  overflow)
