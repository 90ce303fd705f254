"""PyTorch port: the densifying single-view step and the batched multi-view
step (``models/trainer.py``) against the JAX package's.

One step of each from the same parameters, views and targets in both
packages: the loss within 1e-5 relative; the six groups' gradients, read
as Adam's first moments after the first step (0.1 x the gradient in both
optimizers), and the accumulated ``grad_sum`` within 2e-4 of their max
|value| (``tests/test_torch_grads.py``'s tolerance); ``count`` and
``max_radii`` exact. Adam-stepped parameters are not compared (see
``tests/test_torch_train.py``). The 3-view fit of ``tests/test_train.py``
with targets from the JAX ``synthetic_multiview``: the loss falls below
0.8x its start. The overflow surfaces through both steps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu.config import RenderConfig as JConfig
from luisacomputegaussiansplatting_tpu.io.dataset import synthetic_multiview
from luisacomputegaussiansplatting_tpu.io.synthetic import create_cube_scene as jcube
from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene as jrandom_scene
from luisacomputegaussiansplatting_tpu.models import densify as jd
from luisacomputegaussiansplatting_tpu.models import gaussians as jg
from luisacomputegaussiansplatting_tpu.models import trainer as jt
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models import densify as pd
from luisacomputegaussiansplatting_tpu_torch.models import gaussians as pg
from luisacomputegaussiansplatting_tpu_torch.models import trainer as pt
from luisacomputegaussiansplatting_tpu_torch.utils.camera import Camera, CameraView, look_at_camera

torch.set_num_threads(2)

FIELDS = pg.GaussianParams._fields
W, H = 48, 32
N, CAP = 40, 48
KW = dict(max_pairs=10_000)
EYES = [((2.5, -2.2, 1.8), (0, 0, 0), (0, 0, 1)),
        ((-2.0, -2.6, 1.5), (0, 0, 0), (0, 0, 1))]


def port_views(cams):
    """A CameraView stacked over the cameras."""
    views = [c.to_view("cpu") for c in cams]
    return CameraView(*(torch.stack(x) for x in zip(*views)))


def jax_views(cams):
    return jax.tree.map(lambda *x: jnp.stack(x), *[c.to_view() for c in cams])


def start_arrays():
    """Raw parameters of a 40-gaussian scene at capacity 48, as numpy."""
    p = jg.pad_params_to(jrandom_scene(N, seed=13).to_params(), CAP)
    return [np.array(x) for x in p]


def targets(n_views, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n_views, 3, H, W)).astype(np.float32)


def jax_mu(opt_state):
    """{field: Adam first moment} of a multi_transform state."""
    import optax

    out = {}

    def walk(s):
        if isinstance(s, optax.ScaleByAdamState):
            for f in FIELDS:
                mu = getattr(s.mu, f)
                if hasattr(mu, "dtype"):
                    out[f] = np.asarray(mu)
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
        elif isinstance(s, dict):
            for v in s.values():
                walk(v)

    walk(opt_state)
    return out


def assert_scaled_close(name, got, want, atol):
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=atol,
                               err_msg=name)


@functools.lru_cache(maxsize=None)
def one_step(kind):
    """One step of ``kind`` ("densify": one view, "batched": two) from the
    same parameters, views and targets in both packages: (JAX (state,
    dstate, loss, overflow), the port's (state, optimizer, dstate, loss,
    overflow))."""
    arrays = start_arrays()
    n_views = 1 if kind == "densify" else 2
    tg = targets(n_views)
    jcams = [jlook(*e, fov=70.0, width=W, height=H) for e in EYES[:n_views]]
    cams = [look_at_camera(*e, fov=70.0, width=W, height=H)
            for e in EYES[:n_views]]
    jstate, jopt = jt.init_train_state(jg.GaussianParams(*map(jnp.asarray,
                                                              arrays)))
    state, opt = pt.init_train_state(pg.params_from_numpy(*arrays, "cpu"))
    jdstate = jd.init_densify_state(N, CAP)
    dstate = pd.init_densify_state(N, CAP, device="cpu")
    if kind == "densify":
        jstep = jt.make_densify_train_step(jopt, W, H, cfg=JConfig(**KW))
        jnew, jds, jloss, jaux = jstep(jstate, jdstate, jcams[0].to_view(),
                                       jnp.asarray(tg[0]))
        step = pt.make_densify_train_step(opt, W, H, cfg=RenderConfig(**KW))
        state, ds, loss, aux = step(state, dstate, cams[0].to_view("cpu"),
                                    torch.from_numpy(tg[0]))
        np.testing.assert_array_equal(aux.radii.numpy(),
                                      np.asarray(jaux.radii))
        jover, over = jaux.overflow, aux.overflow
    else:
        jstep = jt.make_batched_train_step(jopt, W, H, cfg=JConfig(**KW))
        jnew, jds, jloss, jover = jstep(jstate, jdstate, jax_views(jcams),
                                        jnp.asarray(tg))
        step = pt.make_batched_train_step(opt, W, H, cfg=RenderConfig(**KW))
        state, ds, loss, over = step(state, dstate, port_views(cams),
                                     torch.from_numpy(tg))
    return (jnew, jds, jloss, jover), (state, opt, ds, loss, over)


@pytest.mark.parametrize("kind", ["densify", "batched"])
def test_step_matches_jax(kind):
    """The loss and the accumulated statistics of one step."""
    (_, jds, jloss, jover), (state, _, ds, loss, over) = one_step(kind)
    assert not bool(over) and not bool(jover)
    assert state.step == 1
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert_scaled_close("grad_sum", ds.grad_sum.numpy(),
                        np.asarray(jds.grad_sum), 2e-4)
    assert np.abs(ds.grad_sum.numpy()).max() > 0
    np.testing.assert_array_equal(ds.count.numpy(), np.asarray(jds.count))
    np.testing.assert_array_equal(ds.max_radii.numpy(),
                                  np.asarray(jds.max_radii))
    np.testing.assert_array_equal(ds.active.numpy(), np.asarray(jds.active))
    assert ds.count.numpy()[N:].max() == 0  # inactive rows are culled
    assert ds.count.numpy().max() == (1 if kind == "densify" else 2)


@pytest.mark.parametrize("kind", ["densify", "batched"])
def test_step_gradients_match_jax(kind):
    """The six groups' gradients of one step: JAX's Adam first moment
    after it (0.1 x the gradient) against the port's ``exp_avg``."""
    (jnew, _, _, _), (state, opt, _, _, _) = one_step(kind)
    mu = jax_mu(jnew.opt_state)
    for f, p in zip(FIELDS, state.params):
        got = opt.state[p]["exp_avg"].numpy()
        assert np.abs(got).max() > 0, f
        assert_scaled_close(f, got, mu[f], 2e-4)
        assert not got[N:].any(), f  # inactive rows take no gradient


def test_batched_train_step_fits():
    """3 views of a 27-gaussian cube (targets from the JAX package's
    ``synthetic_multiview``), the cube perturbed at capacity 64: the loss
    over the 3 views falls; the statistics count every view."""
    w = h = 48
    gt = jcube(nx=3, scale=0.12, opacity=0.9)
    data = synthetic_multiview(gt, n_views=3, width=w, height=h,
                               cfg=JConfig(max_pairs=20_000))
    cams = [Camera(**dataclasses.asdict(c)) for c in data.cameras]
    views = port_views(cams)
    tg = torch.from_numpy(np.stack([np.asarray(t) for t in data.targets]))

    n0, cap = 27, 64
    arrays = [np.array(x) for x in jg.pad_params_to(gt.to_params(), cap)]
    rng = np.random.default_rng(0)
    arrays[0] = arrays[0] + rng.normal(0, 0.05, arrays[0].shape).astype(
        np.float32)
    state, opt = pt.init_train_state(pg.params_from_numpy(*arrays, "cpu"))
    dstate = pd.init_densify_state(n0, cap, device="cpu")
    step = pt.make_batched_train_step(opt, w, h,
                                      cfg=RenderConfig(max_pairs=20_000))
    losses = []
    for _ in range(25):
        state, dstate, loss, overflow = step(state, dstate, views, tg)
        losses.append(float(loss))
        assert not bool(overflow)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses[::8]
    assert int((dstate.count > 0).sum()) > 0
    assert float(dstate.count.max()) >= 3.0  # visible in all 3 views
    assert float(dstate.count[n0:].max()) == 0.0


def test_overflowing_step_is_detected():
    """A step whose expansion exceeds max_pairs surfaces the overflow, in
    the densifying and the batched step."""
    w = h = 48
    cfg = RenderConfig(max_pairs=16)  # 27 gaussians emit >= 27 entries
    gt = jcube(nx=3, scale=0.12, opacity=0.9)
    arrays = [np.array(x) for x in gt.to_params()]
    n = arrays[0].shape[0]
    cam = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0,
                         width=w, height=h)
    target = torch.zeros((3, h, w))
    state, opt = pt.init_train_state(pg.params_from_numpy(*arrays, "cpu"))
    dstate = pd.init_densify_state(n, n, device="cpu")
    step1 = pt.make_densify_train_step(opt, w, h, cfg=cfg)
    _, _, _, aux = step1(state, dstate, cam.to_view("cpu"), target)
    assert bool(aux.overflow)
    stepb = pt.make_batched_train_step(opt, w, h, cfg=cfg)
    _, _, _, overflow = stepb(state, dstate, port_views([cam]), target[None])
    assert bool(overflow)
