"""PyTorch port: two steps of the (data, gs) mesh training step
(``parallel/train_sharded.py``) on four gloo ranks on the CPU (a 2x2 mesh,
an uneven band split), with and without densify, against the JAX package's
``make_sharded_train_step`` on a 2x2 mesh of ``conftest.py``'s virtual
devices and against the single-device port.

* The losses match JAX's within rtol 2e-5. The parameters match JAX's
  within 1e-6 plus 1e-2 of the group's learning rate (Adam's update is
  m/sqrt(v) x lr: where a parameter's two gradients nearly cancel, a
  rounding-level gradient difference moves it by a fraction of lr,
  ``tests/test_torch_train.py``; measured up to 7e-3 lr), and the
  single-device batched step's within 1e-6; the Adam first moments (the
  gradients) are the single-device step's within 2e-4 of their max
  (``tests/test_torch_train_batched.py``).
* The densify statistics are the single-device batched step's (count and
  max radii exact, grad_sum within 2e-4 of its max). JAX's sharded step
  transposes its loss psum into a psum, which leaves its gradients
  n_gs = 2 times, and its grad_sum n_data x n_gs = 4 times, those of the
  mean loss; the port's grad_sum times 4 matches JAX's within 2e-4, and
  JAX's Adam moments are the port's times n_gs.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from luisacomputegaussiansplatting_tpu.config import RenderConfig as JConfig
from luisacomputegaussiansplatting_tpu.models import densify as jd
from luisacomputegaussiansplatting_tpu.models import trainer as jt
from luisacomputegaussiansplatting_tpu.parallel.mesh import make_mesh as jmesh
from luisacomputegaussiansplatting_tpu.parallel.render_sharded import (
    ShardedRenderConfig as JShardedRenderConfig,
)
from luisacomputegaussiansplatting_tpu.parallel.train_sharded import (
    make_sharded_train_step as jmake_step,
)
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models import trainer as pt
from luisacomputegaussiansplatting_tpu_torch.models.densify import init_densify_state

torch.set_num_threads(2)

MESH = (2, 2)
N_WORLD = 4
CFG = dict(max_pairs=20_000)
SCFG = dict(max_pairs_local=8192, exchange_capacity=2048)
EYES = [(3.0, -2.5, 2.0), (-2.5, 3.0, 1.5)]
#: learning rates of the six groups (models/trainer.TrainConfig defaults)
LRS = [1.6e-4, 5e-3, 1e-3, 5e-2, 2.5e-3, 2.5e-3 / 20.0]


def train_case(height, steps, densify=False, tseed=5):
    return dict(mesh=MESH, n=96, seed=21, perturb_seed=3, width=64,
                height=height, eyes=EYES, target_seed=tseed, cfg=CFG,
                scfg=SCFG, steps=steps, densify=densify,
                active_every=2 if densify else 1)



CASES = {
    "plain": train_case(48, 2),
    "densify": train_case(48, 2, densify=True),
}

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.Ranks(W.train_cases, N_WORLD, tmp_path_factory.mktemp("train"),
                   cases=list(CASES.values()))


def port(ranks, name):
    return ranks.results()[0][list(CASES).index(name)]


def jax_state(case):
    """JAX's starting parameters of a case: the port's, as JAX arrays."""
    return jt.GaussianParams(*(jnp.asarray(x.numpy())
                               for x in W._start_params(case)))


def jax_views(height):
    cams = [jlook(e, (0, 0, 0), (0, 0, 1), fov=70.0, width=64, height=height)
            for e in EYES]
    return cams, jax.tree.map(lambda *x: jnp.stack(x),
                              *[c.to_view() for c in cams])


def jax_sharded_run(case):
    """JAX's sharded step on a 2x2 mesh: (losses, params, Adam mu,
    DensifyState or None)."""
    mesh = jmesh(MESH, ("data", "gs"), devices=jax.devices()[:N_WORLD])
    h = case["height"]
    step, _opt, pad = jmake_step(mesh, 64, h, cfg=JConfig(**CFG),
                                 scfg=JShardedRenderConfig(**SCFG),
                                 densify=case["densify"])
    state, _ = jt.init_train_state(jax_state(case))
    _cams, views = jax_views(h)
    tg = pad(jnp.asarray(W.train_targets(case)))
    dstate = None
    if case["densify"]:
        dstate = jd.init_densify_state(96, 96)._replace(
            active=jnp.arange(96) % case["active_every"] == 0)
    losses = []
    for _ in range(case["steps"]):
        if case["densify"]:
            state, dstate, loss, _ov = step(state, dstate, views, tg)
        else:
            state, loss, _ov = step(state, views, tg)
        losses.append(float(loss))
    return (losses, [np.asarray(x) for x in state.params],
            jax_mu(state.opt_state), dstate)


def jax_mu(opt_state):
    """The Adam first moments of the six groups of a multi_transform
    state, in GaussianParams order."""
    import optax

    out = {}

    def walk(s):
        if isinstance(s, optax.ScaleByAdamState):
            for f in s.mu._fields:
                if hasattr(getattr(s.mu, f), "dtype"):
                    out[f] = np.asarray(getattr(s.mu, f))
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
        elif isinstance(s, dict):
            for v in s.values():
                walk(v)

    walk(opt_state)
    return [out[f] for f in jt.GaussianParams._fields]


def port_batched(case):
    """The single-device port's batched step over the same two views:
    (parameters, Adam first moments, DensifyState)."""
    params = W._start_params(case)
    state, opt = pt.init_train_state(params)
    step = pt.make_batched_train_step(opt, 64, case["height"],
                                      cfg=RenderConfig(**CFG))
    views = W._stack_views([W.camera(e, 64, case["height"]) for e in EYES])
    d = init_densify_state(96, 96, device="cpu")
    d = d._replace(active=torch.arange(96) % case["active_every"] == 0)
    for _ in range(case["steps"]):
        state, d, _loss, _ov = step(state, d, views,
                                    torch.from_numpy(W.train_targets(case)))
    return ([x.detach().numpy() for x in state.params],
            [opt.state[x]["exp_avg"].numpy() for x in state.params], d)


def scaled_close(got, want, atol):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.parametrize("name", ["plain", "densify"])
def test_two_steps_match_jax_and_single_device(ranks, name):
    case = CASES[name]
    got = port(ranks, name)
    losses, params, mu, dstate = jax_sharded_run(case)
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    assert not any(got["overflows"])
    start = [x.numpy() for x in W._start_params(case)]
    for f, (a, b, a0, lr) in enumerate(zip(got["params"], params, start, LRS)):
        np.testing.assert_allclose(a, b, atol=1e-6 + 1e-2 * lr, err_msg=f)
        if f in (0, 3):  # means and opacities moved
            assert np.abs(a - a0).max() > lr
    ref_params, ref_mu, ref_d = port_batched(case)
    for f, (a, b) in enumerate(zip(got["exp_avg"], ref_mu)):
        assert np.abs(b).max() > 0, f
        scaled_close(a, b, 2e-4)
        # JAX's moments: n_gs times the mean-loss gradient's
        np.testing.assert_allclose(mu[f] / MESH[1] / np.abs(b).max(),
                                   b / np.abs(b).max(), atol=2e-4)
    for a, b in zip(got["params"], ref_params):
        np.testing.assert_allclose(a, b, atol=1e-6)
    if not case["densify"]:
        return
    grad_sum, count, max_radii, active = got["dstate"]
    np.testing.assert_array_equal(count, ref_d.count.numpy())
    np.testing.assert_array_equal(max_radii, ref_d.max_radii.numpy())
    np.testing.assert_array_equal(active, ref_d.active.numpy())
    scaled_close(grad_sum, ref_d.grad_sum.numpy(), 2e-4)
    assert grad_sum[active == 0].max() == 0 and grad_sum.max() > 0
    np.testing.assert_array_equal(count, np.asarray(dstate.count))
    np.testing.assert_array_equal(max_radii, np.asarray(dstate.max_radii))
    scaled_close(grad_sum * N_WORLD, np.asarray(dstate.grad_sum), 2e-4)


