"""The plain reference of a densifying training step: the render of
``reference.render``, the graphdeco photometric loss (1 - w) L1 + w
(1 - SSIM) with an 11x11, sigma 1.5 gaussian window, its gradient by
autograd, Adam (beta 0.9 / 0.999, one learning rate per parameter group,
the means' rate decaying exponentially) and the densification statistics
(the NDC-scaled screen-space gradient norm summed over the views that see a
gaussian, the view count, the largest radius). Plain PyTorch; imports
nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import render as R

GROUPS = ("means", "log_scales", "quats", "opacity_logits", "sh_dc",
          "sh_rest")


def ssim_window(size: int = 11, sigma: float = 1.5, device="cpu"):
    x = torch.arange(size, dtype=torch.float64) - (size - 1) / 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).to(torch.float32).to(device)


def blur(img, window):
    """Separable zero-padded gaussian blur of (C, H, W)."""
    c, size = img.shape[0], window.shape[0]
    kh = window.reshape(1, 1, size, 1).expand(c, 1, size, 1)
    kw = window.reshape(1, 1, 1, size).expand(c, 1, 1, size)
    x = F.conv2d(img[None], kh, padding=(size // 2, 0), groups=c)
    return F.conv2d(x, kw, padding=(0, size // 2), groups=c)[0]


def loss_fn(pred, target, ssim_weight: float, c1=0.01 ** 2, c2=0.03 ** 2):
    """(1 - w) mean |pred - target| + w (1 - mean SSIM)."""
    c = pred.shape[0]
    win = ssim_window(device=pred.device)
    mu0, mu1, b00, b11, b01 = blur(
        torch.cat([pred, target, pred * pred, target * target,
                   pred * target]), win).split(c)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    num = (2 * mu01 + c1) * (2 * (b01 - mu01) + c2)
    den = (mu00 + mu11 + c1) * ((b00 - mu00) + (b11 - mu11) + c2)
    ssim = torch.mean(num / den)
    l1 = torch.mean(torch.abs(pred - target))
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim)


def group_lrs(tc: dict, count: int) -> dict:
    """The learning rate of each group after ``count`` updates (the means'
    decays from lr_means to lr_means_final over lr_means_decay_steps, both
    times spatial_lr_scale, bounded by the final value)."""
    s = tc["spatial_lr_scale"]
    init, final = tc["lr_means"] * s, tc["lr_means_final"] * s
    means = init
    if tc["lr_means_decay_steps"] > 0 and count > 0:
        rate = tc["lr_means_final"] / tc["lr_means"]
        means = init * rate ** (count / tc["lr_means_decay_steps"])
        means = max(means, final) if rate < 1.0 else min(means, final)
    return {"means": means, "log_scales": tc["lr_scales"],
            "quats": tc["lr_quats"], "opacity_logits": tc["lr_opacity"],
            "sh_dc": tc["lr_sh_dc"], "sh_rest": tc["lr_sh_rest"]}


class Adam:
    """Adam with bias correction: p -= lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params, eps: float, b1=0.9, b2=0.999):
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.eps, self.b1, self.b2, self.t = eps, b1, b2, 0

    def step(self, params, grads, lrs):
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for p, g, m, v, lr in zip(params, grads, self.m, self.v, lrs):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def densify_update(stats, d_means2d, radius, width, height):
    """Fold one view into (grad_sum, count, max_radii)."""
    grad_sum, count, max_radii = stats
    visible = radius > 0
    g = d_means2d * torch.tensor([width * 0.5, height * 0.5],
                                 device=d_means2d.device)
    g = torch.sqrt(torch.sum(g * g, dim=-1))
    return (grad_sum + torch.where(visible, g, 0.0),
            count + visible.to(torch.float32),
            torch.maximum(max_radii, radius))


def train_steps(raw, views, targets, width, height, bg, rs, tc: dict,
                n_steps: int, sh_degree: int = 3, precision: str = "f32",
                fault: str | None = None):
    """Run ``n_steps`` steps from the raw parameters ``raw`` (a tuple in
    ``GROUPS`` order, left unchanged) over ``views[i]`` / ``targets[i]``.

    Returns {"losses": [...], "grad_norms": per-group norms of the first
    step's gradient, "change_norms": per-group norms of the parameters'
    change after the last step, "stats": the statistics' (grad_sum, count,
    max_radii) after the first step, "overflow": the steps whose
    capacities overflowed}.
    ``fault`` plants one for the check's own test: "half_batch", the loss
    reads the top half of the image rows only; "unchanged", no update
    reaches the parameters.
    """
    params = [p.detach().clone() for p in raw]
    opt = Adam(params, tc["adam_eps"])
    n = params[0].shape[0]
    dev = params[0].device
    stats = (torch.zeros(n, device=dev), torch.zeros(n, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev))
    losses, grad_norms, overflow = [], None, 0
    for k in range(n_steps):
        leaves = [p.clone().requires_grad_(True) for p in params]
        frame = R.render(leaves, views[k], width, height, bg, rs, sh_degree,
                         precision)
        frame.means2d.retain_grad()
        img, tgt = frame.image, targets[k]
        if fault == "half_batch":
            img, tgt = img[:, : height // 2], tgt[:, : height // 2]
        loss = loss_fn(img, tgt, tc["ssim_weight"])
        loss.backward()
        grads = [lf.grad for lf in leaves]
        if precision == "bf16":
            grads = [R.bf16(g) for g in grads]
        if k == 0:
            grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
        if fault == "unchanged":
            grads = [torch.zeros_like(g) for g in grads]
            if k == 0:
                grad_norms = [0.0] * len(grads)
        else:
            lrs = group_lrs(tc, k)
            opt.step(params, grads, [lrs[name] for name in GROUPS])
        if k == 0:
            stats = densify_update(stats, frame.means2d.grad.detach(),
                                   frame.radius, width, height)
        losses.append(float(loss.detach()))
        overflow += frame.binned.overflow
        del frame, leaves, grads, loss, img, tgt
    change = [float(torch.linalg.vector_norm(p - r)) for p, r in
              zip(params, raw)]
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "stats": stats, "overflow": overflow}


def stats_norms(stats):
    """(||grad_sum||, sum of counts, sum of max radii) as floats."""
    grad_sum, count, max_radii = stats
    return (float(torch.linalg.vector_norm(grad_sum)),
            float(count.sum()), float(max_radii.to(torch.float64).sum()))

