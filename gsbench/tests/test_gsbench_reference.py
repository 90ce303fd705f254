"""The plain reference against the program's CPU path (its plain versions
of the kernels) at a tiny size, at each configuration's settings."""

import pytest
import torch

from conftest import TINY
from gsbench import harness, inputs
from gsbench.reference import render as R
from gsbench.reference import train as RT
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models import trainer
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianParams
from luisacomputegaussiansplatting_tpu_torch.models.losses import d_ssim_l1_loss
from luisacomputegaussiansplatting_tpu_torch.ops.render import render_view
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["bicycle-train", "lego-train"])
def test_render_loss_and_gradients_match_the_program(cell):
    c = harness.make_cell(cell, 2**33 + 1, CPU, TINY)
    cfg = c.config
    ds = cfg["dataset"]
    w, h = ds["width"], ds["height"]
    raw = inputs.draw_params(cfg["scene"], c.seed, CPU)
    view = inputs.train_views(ds, CPU)[3]
    target = inputs.draw_targets(1, w, h, c.seed, CPU)[0]
    rs = R.RenderSettings.from_config(cfg["render"])
    bg = tuple(ds["background"])

    leaves = [p.clone().requires_grad_(True) for p in raw]
    ref = R.render(leaves, view, w, h, bg, rs)
    ref_loss = RT.loss_fn(ref.image, target, 0.2)
    ref_loss.backward()

    params = GaussianParams(*(p.clone().requires_grad_(True) for p in raw))
    scene = params.activate()
    img, aux = render_view(*scene, CameraView(*view), w, h, bg,
                           RenderConfig(**cfg["render"]))
    loss = d_ssim_l1_loss(img, target, 0.2)
    loss.backward()

    assert int(aux.num_rendered) == ref.binned.num_rendered > 0
    assert torch.equal(aux.radii, ref.radius)
    assert float((img - ref.image).detach().abs().max()) <= 1e-5
    assert abs(loss.item() - ref_loss.item()) <= 1e-6 * ref_loss.item()
    # bf16-rounded gradient rows (bicycle) flip a rounding here and there:
    # an element moves by up to a bf16 ulp of its row, the norms agree
    elem_tol = 4e-3 if cfg["render"]["grad_reduce_dtype"] == "bf16" else 1e-4
    for a, b in zip(params, leaves):
        scale = float(b.grad.abs().max()) + 1e-30
        assert float((a.grad - b.grad).abs().max()) / scale <= elem_tol
        assert abs(float(a.grad.norm() / b.grad.norm()) - 1.0) <= 1e-5


def test_adam_matches_torch_optim():
    torch.manual_seed(0)
    p0 = [torch.randn(50, 3), torch.randn(50)]
    tc = harness.make_cell("lego-train", 0, CPU).config["train"]
    ours = [p.clone() for p in p0]
    opt = RT.Adam(ours, tc["adam_eps"])
    leaves = trainer.GaussianParams(
        p0[0], p0[0].clone(), torch.randn(50, 4), p0[1], torch.randn(50, 1, 3),
        torch.randn(50, 15, 3))
    state, topt = trainer.init_train_state(leaves, trainer.TrainConfig(**tc))
    for k in range(3):
        grads = [torch.randn(50, 3), torch.randn(50)]
        lrs = RT.group_lrs(tc, k)
        opt.step(ours, grads, [lrs["means"], lrs["opacity_logits"]])
        for leaf in state.params:
            leaf.grad = torch.zeros_like(leaf)
        state.params.means.grad = grads[0]
        state.params.opacity_logits.grad = grads[1]
        trainer.optimizer_step(topt, trainer.TrainConfig(**tc), k)
    assert torch.allclose(ours[0], state.params.means, rtol=0, atol=1e-6)
    assert torch.allclose(ours[1], state.params.opacity_logits, rtol=0,
                          atol=1e-6)
