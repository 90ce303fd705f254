"""The plain reference of a batched multi-view training step, as gsplat
trains at ``--batch_size`` B (nerfstudio-project/gsplat,
``examples/simple_trainer.py``): B views a step, the loss the mean of the
B per-view losses, one Adam update a step with the configuration's rates,
betas and eps (gsplat's ``create_splats_with_optimizers`` scales graphdeco's
for B: learning rates x sqrt(B), eps / sqrt(B), betas 1 - B (1 - beta);
the configuration states them already scaled).

The render, the loss, ``Adam`` and ``densify_update`` are
``reference.train``'s. The gradient of the mean is computed one view at a
time, each view's loss weighted 1/B and its backward accumulated into the
leaves, so that at 6M gaussians the reference holds one view's graph at a
time. The densification statistics are folded in per view: the NDC-scaled
norm of dL_v/d means2d (the view's own loss, not the batch's) for every
gaussian that view sees, one count per such view, and the largest radius
over the batch.

Departures from gsplat, each the port's and the JAX package's:
  * the statistics are graphdeco's (the norm of the screen-space gradient
    of each view, summed and counted per view), not gsplat's ``absgrad``
    or its ``packed`` mode; gsplat's ``DefaultStrategy`` multiplies the
    batched screen-space gradient by the number of cameras before the norm,
    which the per-view loss here does as well;
  * the means' learning rate follows graphdeco's exponential decay
    (``reference.train.group_lrs``) at the count of steps, as gsplat's
    per-step ``ExponentialLR`` does, over ``lr_means_decay_steps`` steps;
  * the render is ``reference.render``'s (the configuration's tile, cull,
    bf16 payload and reduction), not gsplat's rasterizer;
  * no appearance embedding, no bilateral grid, no random background.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import torch

from . import render as R
from . import train as RT

#: the faults ``train_batched_steps`` can plant, each in the program's
#: place, for the check's own readings: the two of ``reference.train``
#: and two of a batch
FAULTS = ("half_batch", "unchanged", "one_view", "shared_probe")


def train_batched_steps(raw, views, targets, width, height, bg, rs,
                        tc: dict, n_steps: int, batch: int,
                        sh_degree: int = 3, precision: str = "f32",
                        fault: str | None = None):
    """Run ``n_steps`` steps of ``batch`` views each from the raw parameters
    ``raw`` (a tuple in ``reference.train.GROUPS`` order, left unchanged);
    step k takes ``views[k * batch:(k + 1) * batch]`` and the targets
    beside them.

    Returns what ``reference.train.train_steps`` returns, and equals it at
    ``batch`` 1: {"losses": the step losses, "grad_norms": per-group norms
    of the first step's gradient, "change_norms": per-group norms of the
    parameters' change after the last step, "stats": (grad_sum, count,
    max_radii) after the first step, "overflow": the views whose capacities
    overflowed}, and "grads", the first step's gradient of each group, and
    "params", the parameters after the last step.

    ``fault`` (one of ``FAULTS``): "half_batch", each view's loss reads the
    top half of the image rows only; "unchanged", no update reaches the
    parameters; "one_view", the step's loss and gradient are view 0's
    alone (the statistics read what that loss gives the other views: 0);
    "shared_probe", one probe for all views: the statistics read the norm
    of the batch loss's gradient with respect to a means2d the views share
    (the mean of the views' gradients, cancelling where they disagree),
    folded in once for every view that sees a gaussian, which understates
    every ``grad_sum`` entry.
    """
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if len(views) < n_steps * batch:
        raise ValueError(f"{n_steps} steps of {batch} views need "
                         f"{n_steps * batch} views, got {len(views)}")
    params = [p.detach().clone() for p in raw]
    opt = RT.Adam(params, tc["adam_eps"], tc.get("adam_beta1", 0.9),
                  tc.get("adam_beta2", 0.999))
    n = params[0].shape[0]
    dev = params[0].device
    stats = (torch.zeros(n, device=dev), torch.zeros(n, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev))
    weights = [1.0 / batch] * batch
    if fault == "one_view":
        weights = [1.0] + [0.0] * (batch - 1)
    losses, grad_norms, overflow = [], None, 0
    for k in range(n_steps):
        leaves = [p.clone().requires_grad_(True) for p in params]
        step_loss, probes = 0.0, []
        for v in range(batch):
            i = k * batch + v
            frame = R.render(leaves, views[i], width, height, bg, rs,
                             sh_degree, precision)
            frame.means2d.retain_grad()
            img, tgt = frame.image, targets[i]
            if fault == "half_batch":
                img, tgt = img[:, : height // 2], tgt[:, : height // 2]
            loss = RT.loss_fn(img, tgt, tc["ssim_weight"])
            step_loss += weights[v] * float(loss.detach())
            d_means2d = torch.zeros_like(frame.means2d)
            if weights[v] != 0.0:
                (loss * weights[v]).backward()
                d_means2d = frame.means2d.grad.detach()
            if k == 0:
                probes.append((d_means2d, frame.radius))
            overflow += frame.binned.overflow
            del frame, img, tgt, loss
        grads = [lf.grad if lf.grad is not None else torch.zeros_like(lf)
                 for lf in leaves]
        if precision == "bf16":
            grads = [R.bf16(g) for g in grads]
        if k == 0:
            grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
            first_grads = grads
        if fault == "unchanged":
            if k == 0:
                grad_norms = [0.0] * len(grads)
        else:
            lrs = RT.group_lrs(tc, k)
            opt.step(params, grads, [lrs[name] for name in RT.GROUPS])
        if k == 0:
            if fault == "shared_probe":
                shared = sum(d for d, _ in probes)
            for d_means2d, radius in probes:
                # dL/d means2d_v of the weighted loss, times B: the view's
                # own loss's gradient
                d = shared if fault == "shared_probe" else d_means2d * batch
                stats = RT.densify_update(stats, d, radius, width, height)
        losses.append(step_loss)
        del leaves, probes
    change = [float(torch.linalg.vector_norm(p - r)) for p, r in
              zip(params, raw)]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "stats": stats, "overflow": overflow,
            "grads": first_grads, "params": params}
