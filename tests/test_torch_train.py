"""PyTorch port: losses, the optimizer and the single-view training step
against the JAX package's ``models``.

Losses and the SSIM map: <= 1e-5 of JAX on the same numpy images. The
means learning rate: <= 1e-7 relative of optax's schedule. Adam: the same
numpy gradients into both optimizers for 3 steps, parameters <= 1e-6 apart
(whole training steps are not compared: Adam's 1/sqrt(v) turns
rounding-level gradient differences into steps of size lr). The tiny-scene
fit of ``tests/test_train.py``: loss halves in 30 steps, PSNR +3 dB.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene as jrandom_scene
from luisacomputegaussiansplatting_tpu.models import gaussians as jg
from luisacomputegaussiansplatting_tpu.models import losses as jl
from luisacomputegaussiansplatting_tpu.models import trainer as jt
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu_torch.models import gaussians as pg
from luisacomputegaussiansplatting_tpu_torch.models import losses as pl
from luisacomputegaussiansplatting_tpu_torch.models import trainer as pt
from luisacomputegaussiansplatting_tpu_torch.ops.render import render
from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x))


def images(seed, shape=(3, 40, 56)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape).astype(np.float32),
            rng.uniform(size=shape).astype(np.float32))


@pytest.mark.parametrize("name", ["l1_loss", "ssim", "d_ssim_l1_loss", "psnr"])
def test_losses_match_jax(name):
    a, b = images(1)
    want = float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(pl, name)(t(a), t(b)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def test_ssim_map_matches_jax():
    a, b = images(2)
    want = np.asarray(jl.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    got = pl.ssim_map(t(a), t(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert float(pl.ssim(t(a), t(a))) > 0.9999


@pytest.mark.parametrize("tc", [pt.TrainConfig(),
                                pt.TrainConfig(spatial_lr_scale=3.5),
                                pt.TrainConfig(lr_means_decay_steps=0)],
                         ids=["default", "scaled", "constant"])
def test_means_lr_matches_optax(tc):
    """The schedule the JAX make_optimizer builds (models/trainer.py:60-68),
    evaluated by optax at the count of updates made so far."""
    sls = tc.spatial_lr_scale
    if tc.lr_means_decay_steps > 0:
        sched = optax.exponential_decay(
            init_value=tc.lr_means * sls,
            transition_steps=tc.lr_means_decay_steps,
            decay_rate=tc.lr_means_final / tc.lr_means,
            end_value=tc.lr_means_final * sls)
    else:
        sched = optax.constant_schedule(tc.lr_means * sls)
    for count in (0, 1, 15_000, 30_000, 40_000):
        want = float(sched(jnp.asarray(count, jnp.int32)))
        got = pt.means_lr(tc, count)
        assert abs(got - want) <= 1e-7 * want, (count, got, want)


def random_params(seed, n=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((n, 3), (n, 3), (n, 4), (n,), (n, 1, 3), (n, 15, 3))]


def test_adam_matches_optax_on_the_same_gradients():
    tc = pt.TrainConfig(lr_means=1e-2, lr_means_decay_steps=5)
    arrays = random_params(0)
    jparams = jg.GaussianParams(*map(jnp.asarray, arrays))
    # the JAX package's TrainConfig has no betas (its Adam keeps optax's
    # 0.9 / 0.999, the port's defaults): pass the fields it has
    jfields = {f.name for f in dataclasses.fields(jt.TrainConfig)}
    jopt = jt.make_optimizer(jt.TrainConfig(
        **{k: v for k, v in vars(tc).items() if k in jfields}))
    jstate = jopt.init(jparams)
    state, opt = pt.init_train_state(pg.params_from_numpy(*arrays, "cpu"), tc)
    for step in range(3):
        grads = random_params(100 + step)
        upd, jstate = jopt.update(jg.GaussianParams(*map(jnp.asarray, grads)),
                                  jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, g in zip(state.params, grads):
            p.grad = t(g)
        pt.optimizer_step(opt, tc, step)
    for name, a, b in zip(pg.GaussianParams._fields, state.params, jparams):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, err_msg=name)


def test_params_conversions_match_jax():
    jscene = jrandom_scene(50, seed=3)
    scene = random_scene(50, seed=3, device="cpu")
    jp, pp = jscene.to_params(), scene.to_params()
    for name, a, b in zip(pg.GaussianParams._fields, pp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    jpad, ppad = jg.pad_params_to(jp, 64), pg.pad_params_to(pp, 64)
    for name, a, b in zip(pg.GaussianParams._fields, ppad, jpad):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    back = pg.params_from_numpy(*map(np.asarray, jpad), "cpu")
    for a, b in zip(back, ppad):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="capacity"):
        pg.pad_params_to(pp, 10)
    # activation round trip
    act = pp.activate()
    np.testing.assert_allclose(act.opacities.numpy(), scene.opacities.numpy(),
                               atol=1e-6)


def test_fit_tiny_scene():
    """A perturbed scene refits its own render: loss down, PSNR up."""
    cam = look_at_camera((2.5, -2.2, 1.8), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=48, height=32)
    cfg = RenderConfig(max_pairs=8192)
    scene = random_scene(32, seed=5, device="cpu")
    with torch.no_grad():
        target = render(*scene.render_args(), cam, cfg=cfg)
    start = scene.to_params()
    rng = np.random.default_rng(7)
    start = start._replace(
        means=start.means + t(rng.normal(0, 0.05, start.means.shape)
                              .astype(np.float32)),
        opacity_logits=start.opacity_logits - 1.0,
    )
    tc = pt.TrainConfig(lr_means=2e-3, lr_opacity=0.1)
    state, opt = pt.init_train_state(start, tc)
    step = pt.make_train_step(opt, cam.width, cam.height, cfg=cfg, tc=tc)
    view = cam.to_view("cpu")
    losses = []
    for _ in range(30):
        state, loss, aux = step(state, view, target)
        losses.append(float(loss))
    assert state.step == 30 and not bool(aux.overflow)
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], losses[:3] + losses[-3:]
    with torch.no_grad():
        final = render(*state.params.activate().render_args(), cam, cfg=cfg)
        first = render(*start.activate().render_args(), cam, cfg=cfg)
    assert float(pl.psnr(final, target)) > float(pl.psnr(first, target)) + 3
