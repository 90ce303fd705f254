"""PyTorch port: adaptive density control (``models/densify.py``) against the
JAX package's, on the same numpy inputs and the same split noise.

Each round runs in both packages: the JAX ``densify_step`` (jitted) with a
PRNG key, the port's ``densify_round`` with the noise that key draws
(``jax.random.normal(key, (C, children, 3))``). The counters, the new
active mask and the rows each round rewrites are exact; every parameter
within 1e-6 (relative and absolute); Adam moments within 1e-6 after both
optimizers took the same gradients. The port rewrites the tensors Adam
holds, in place. The densify-train fit of ``tests/test_densify.py`` runs
in the port alone: the loss ends below 0.7x its start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from luisacomputegaussiansplatting_tpu.models import densify as jd
from luisacomputegaussiansplatting_tpu.models import gaussians as jg
from luisacomputegaussiansplatting_tpu.models import trainer as jt
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import create_cube_scene
from luisacomputegaussiansplatting_tpu_torch.models import densify as pd
from luisacomputegaussiansplatting_tpu_torch.models import gaussians as pg
from luisacomputegaussiansplatting_tpu_torch.models import trainer as pt
from luisacomputegaussiansplatting_tpu_torch.ops.render import render
from luisacomputegaussiansplatting_tpu_torch.utils.camera import look_at_camera

torch.set_num_threads(2)

FIELDS = pg.GaussianParams._fields
jdensify = jax.jit(jd.densify_step, static_argnames=("scene_extent", "cfg"))
jaccumulate = jax.jit(jd.accumulate_stats)
JOPT = jt.make_optimizer(jt.TrainConfig())


@jax.jit
def jadam(grads, opt_state, params):
    upd, opt_state = JOPT.update(grads, opt_state, params)
    return optax.apply_updates(params, upd), opt_state


def make_arrays(n, cap, scale=0.01, opacity_logit=2.0, seed=0):
    """``tests/test_densify.py``'s make_params as numpy arrays, padded to
    ``cap`` as ``pad_params_to`` pads (parked rows, identity rotation)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(cap, 3)), np.full((cap, 3), np.log(scale)),
              np.zeros((cap, 4)), np.full(cap, opacity_logit),
              rng.normal(size=(cap, 1, 3)), np.zeros((cap, 15, 3))]
    arrays = [a.astype(np.float32) for a in arrays]
    arrays[2][:, 3] = 1.0
    for a, fill in zip(arrays, (0.0, -18.0, None, -15.0, 0.0, 0.0)):
        if fill is not None:
            a[n:] = fill
    return arrays


def stats(n, cap, grads, radii):
    """JAX ``accumulate_stats`` of (cap, 2) probe grads and radii (pixel
    units), and the port's on the same arrays; both as numpy."""
    jstate = jaccumulate(jd.init_densify_state(n, cap), jnp.asarray(grads),
                         jnp.asarray(radii))
    pstate = pd.accumulate_stats(pd.init_densify_state(n, cap, device="cpu"),
                                 torch.from_numpy(grads),
                                 torch.from_numpy(radii))
    for f, a, b in zip(jd.DensifyState._fields, pstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   err_msg=f)
    return [np.asarray(x) for x in jstate]


def jax_moments(opt_state):
    """{field: (mu, nu)} of every ScaleByAdamState in a multi_transform
    state (the masked groups hold one real field each)."""
    out = {}

    def walk(s):
        if isinstance(s, optax.ScaleByAdamState):
            for f in FIELDS:
                mu = getattr(s.mu, f)
                if hasattr(mu, "dtype"):
                    out[f] = (np.asarray(mu), np.asarray(getattr(s.nu, f)))
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)
        elif isinstance(s, dict):
            for v in s.values():
                walk(v)

    walk(opt_state)
    assert sorted(out) == sorted(FIELDS)
    return out


def port_moments(opt):
    out = {}
    for g in opt.param_groups:
        st = opt.state[g["params"][0]]
        out[g["name"]] = (st["exp_avg"].numpy(), st["exp_avg_sq"].numpy())
    return out


def setups(arrays, adam_steps=0, seed=100):
    """JAX (params, opt_state) and the port's (state, opt) from the same
    arrays, after ``adam_steps`` Adam steps on the same random gradients."""
    tc = pt.TrainConfig()
    jparams = jg.GaussianParams(*map(jnp.asarray, arrays))
    jopt_state = jax.jit(JOPT.init)(jparams)
    state, opt = pt.init_train_state(pg.params_from_numpy(*arrays, "cpu"), tc)
    rng = np.random.default_rng(seed)
    for step in range(adam_steps):
        grads = [rng.normal(size=a.shape).astype(np.float32) for a in arrays]
        jparams, jopt_state = jadam(
            jg.GaussianParams(*map(jnp.asarray, grads)), jopt_state, jparams)
        for p, g in zip(state.params, grads):
            p.grad = torch.from_numpy(g)
        pt.optimizer_step(opt, tc, step)
    return (jparams, jopt_state), (state, opt)


def changed_rows(before, after):
    """Rows of a params list whose value changed in any field."""
    rows = np.zeros(before[0].shape[0], bool)
    for b, a in zip(before, after):
        rows |= (b != a).reshape(b.shape[0], -1).any(axis=1)
    return rows


def run_round(arrays, n, dstate_np, cfg, seed, adam_steps=0,
              scene_extent=1.0):
    """One round in both packages; checks everything they share and
    returns (JAX (params, opt_state, state, info) as numpy, the port's)."""
    (jparams, jopt_state), (state, opt) = setups(arrays, adam_steps)
    cap = arrays[0].shape[0]
    key = jax.random.PRNGKey(seed)
    jdstate = jd.DensifyState(*map(jnp.asarray, dstate_np))
    jout = jdensify(jparams, jopt_state, jdstate, key,
                    scene_extent=scene_extent, cfg=jd.DensifyConfig(**cfg))
    noise = np.array(jax.random.normal(
        key, (cap, jd.DensifyConfig(**cfg).split_children, 3), jnp.float32))

    before = [p.detach().numpy().copy() for p in state.params]
    jbefore = [np.asarray(p) for p in jparams]
    for p in state.params:  # a stale gradient the round must clear
        p.grad = torch.ones_like(p)
    out = pd.densify_round(
        state.params, opt, pd.densify_state_from_numpy(*dstate_np, "cpu"),
        torch.from_numpy(noise), scene_extent, pd.DensifyConfig(**cfg))
    params, opt2, pstate, info = out

    # in place: the same tensors, still the ones Adam steps, no stale grad
    assert opt2 is opt
    for i, (f, p) in enumerate(zip(FIELDS, params)):
        assert p is state.params[i], f
        assert opt.param_groups[i]["params"][0] is p, f
        assert p.grad is None and p.is_leaf and p.requires_grad, f

    jp, jo, js, ji = jout
    for name, a, b in zip(pd.DensifyInfo._fields, info, ji):
        assert a.dim() == 0 and a.item() == np.asarray(b).item(), name
    np.testing.assert_array_equal(pstate.active.numpy(), np.asarray(js.active))
    for f in ("grad_sum", "count", "max_radii"):
        assert not getattr(pstate, f).any(), f
    after = [p.detach().numpy() for p in params]
    jafter = [np.asarray(x) for x in jp]
    for f, a, b in zip(FIELDS, after, jafter):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(changed_rows(before, after),
                                  changed_rows(jbefore, jafter))
    if adam_steps:
        jm, pm = jax_moments(jo), port_moments(opt)
        for f in FIELDS:
            for a, b in zip(pm[f], jm[f]):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                           err_msg=f)
    return (jafter, jo, js, ji), (after, opt, pstate, info)


def test_clone_small_high_grad():
    n, cap = 4, 16
    arrays = make_arrays(n, cap, scale=0.001)  # small => clone
    grads = np.zeros((cap, 2), np.float32)
    grads[1, 0] = 1.0
    radii = np.zeros(cap, np.int32)
    radii[:n] = 3
    d = stats(n, cap, grads, radii)
    _, (after, _, state, info) = run_round(arrays, n, d,
                                           dict(grad_threshold=0.5), 0)
    assert (int(info.n_cloned), int(info.n_split), int(info.n_pruned)) == (1, 0, 0)
    assert not bool(info.overflow) and int(state.num_active) == n + 1
    dest = int(np.argmax(state.active.numpy()[n:])) + n
    for f, a in zip(FIELDS, after):
        if f not in ("opacity_logits", "log_scales"):
            np.testing.assert_array_equal(a[dest], a[1], err_msg=f)


def test_split_large_high_grad_retires_parent():
    n, cap = 4, 16
    arrays = make_arrays(n, cap, scale=0.5)  # large => split
    grads = np.zeros((cap, 2), np.float32)
    grads[2, 1] = 1.0
    radii = np.zeros(cap, np.int32)
    radii[:n] = 3
    d = stats(n, cap, grads, radii)
    cfg = dict(grad_threshold=0.5, split_children=2)
    _, (after, _, state, info) = run_round(arrays, n, d, cfg, 1)
    assert (int(info.n_cloned), int(info.n_split)) == (0, 1)
    assert int(state.num_active) == n + 1  # the parent's slot is recycled
    shrink = pd.DensifyConfig(**cfg).split_shrink
    scales = np.exp(after[1])
    for r in np.nonzero(state.active.numpy())[0]:
        if r >= n or r == 2:
            assert scales[r].max() <= 0.5 / shrink + 1e-5


def test_prune_transparent():
    n, cap = 6, 8
    arrays = make_arrays(n, cap)
    arrays[3][3] = -10.0  # opacity ~0
    d = stats(n, cap, np.zeros((cap, 2), np.float32), np.zeros(cap, np.int32))
    _, (after, _, state, info) = run_round(arrays, n, d,
                                           dict(grad_threshold=1e9), 2)
    assert int(info.n_pruned) == 1 and int(state.num_active) == n - 1
    assert not bool(state.active[3])
    assert after[3][3] == -15.0 and (after[1][3] == -18.0).all()


def test_capacity_overflow_flag():
    n, cap = 4, 5  # room for one child
    arrays = make_arrays(n, cap, scale=0.001)
    grads = np.zeros((cap, 2), np.float32)
    grads[:n, 0] = 1.0  # all want to clone
    radii = np.zeros(cap, np.int32)
    radii[:n] = 3
    d = stats(n, cap, grads, radii)
    _, (_, _, state, info) = run_round(arrays, n, d, dict(grad_threshold=0.5),
                                       3)
    assert bool(info.overflow) and int(state.num_active) == cap


@pytest.mark.parametrize("case", ["mixed", "split_gate"])
def test_round_matches_jax(case):
    """Clones, splits of three children and prunes in one round at a
    random state (``mixed``), and the split-placement gate: at a capacity
    too small for every split the later parents are demoted, stay alive
    and count as overflow (``split_gate``)."""
    rng = np.random.default_rng(11)
    n, cap = (40, 96) if case == "mixed" else (12, 15)
    arrays = make_arrays(n, cap, scale=0.05, seed=4)
    arrays[1][:n] += rng.uniform(-1.5, 0.5, (n, 3)).astype(np.float32)
    arrays[2][:n] = rng.normal(size=(n, 4)).astype(np.float32)
    arrays[3][:n] = rng.uniform(-7.0, 3.0, n).astype(np.float32)
    grads = np.zeros((cap, 2), np.float32)
    grads[:n] = rng.normal(0, 0.5, (n, 2))
    radii = np.zeros(cap, np.int32)
    radii[:n] = rng.integers(0, 6, n)
    d = stats(n, cap, grads, radii)
    cfg = dict(grad_threshold=0.3, split_children=3, max_screen_radius=4)
    _, (_, _, state, info) = run_round(arrays, n, d, cfg, 5, adam_steps=1,
                                       scene_extent=3.0)
    assert int(info.n_split) > 0
    if case == "mixed":
        assert int(info.n_cloned) > 0 and int(info.n_pruned) > 0
        assert not bool(info.overflow)
    else:
        assert bool(info.overflow)


def test_adam_moments_zeroed_for_new_rows():
    """Both optimizers take the same gradients for 2 steps; the round
    zeroes the moments of the new rows in both and keeps the survivors'."""
    n, cap = 3, 8
    arrays = make_arrays(n, cap, scale=0.001)
    grads = np.zeros((cap, 2), np.float32)
    grads[0, 0] = 1.0
    radii = np.zeros(cap, np.int32)
    radii[:n] = 3
    d = stats(n, cap, grads, radii)
    _, (_, opt, state, _) = run_round(arrays, n, d, dict(grad_threshold=0.5),
                                      4, adam_steps=2)
    child = int(np.argmax(state.active.numpy()[n:])) + n
    for f, (mu, nu) in port_moments(opt).items():
        for m in (mu, nu):
            assert np.abs(m[child]).max() == 0.0, f
            assert np.abs(m[1]).max() > 0.0, f


def test_round_before_the_first_adam_step():
    """A round before Adam's first step finds no moments and passes."""
    n, cap = 4, 16
    arrays = make_arrays(n, cap, scale=0.001)
    grads = np.ones((cap, 2), np.float32)
    radii = np.full(cap, 3, np.int32)
    d = stats(n, cap, grads, radii)
    _, (_, opt, state, info) = run_round(arrays, n, d,
                                         dict(grad_threshold=0.5), 6)
    assert not opt.state and int(info.n_cloned) == n
    assert int(state.num_active) == 2 * n


def test_densify_step_draws_from_the_generator():
    n, cap = 6, 24
    arrays = make_arrays(n, cap, scale=0.5)
    radii = np.full(cap, 3, np.int32)
    d = stats(n, cap, np.ones((cap, 2), np.float32), radii)
    cfg = pd.DensifyConfig(grad_threshold=0.5)
    outs = []
    for use_step in (True, False):
        state, opt = pt.init_train_state(pg.params_from_numpy(*arrays, "cpu"))
        gen = torch.Generator().manual_seed(3)
        dstate = pd.densify_state_from_numpy(*d, "cpu")
        if use_step:
            out = pd.densify_step(state.params, opt, dstate, gen, 1.0, cfg)
        else:
            noise = torch.randn((cap, 2, 3), generator=gen)
            out = pd.densify_round(state.params, opt, dstate, noise, 1.0, cfg)
        outs.append(out)
    assert int(outs[0][3].n_split) == n
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)


def test_reset_opacity_clamps_active_only():
    n, cap = 3, 6
    arrays = make_arrays(n, cap, opacity_logit=3.0)
    arrays[3][1] = -6.0  # already below the ceiling: kept
    cfg = dict(reset_opacity_to=0.01)
    want = jd.reset_opacity(jg.GaussianParams(*map(jnp.asarray, arrays)),
                            jd.init_densify_state(n, cap),
                            jd.DensifyConfig(**cfg))
    state, _ = pt.init_train_state(pg.params_from_numpy(*arrays, "cpu"))
    logits = state.params.opacity_logits
    out = pd.reset_opacity(state.params, pd.init_densify_state(n, cap, "cpu"),
                           pd.DensifyConfig(**cfg))
    assert out is state.params and out.opacity_logits is logits
    got = logits.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want.opacity_logits),
                               rtol=1e-6)
    assert (1 / (1 + np.exp(-got[:n])) <= 0.0101).all()
    assert got[1] == -6.0
    np.testing.assert_array_equal(got[n:], arrays[3][n:])


def test_reset_opacity_zeros_opacity_adam_moments():
    """With the optimizer, the opacity group's moments are zeroed in both
    packages and every other group keeps its own."""
    n, cap = 3, 6
    arrays = make_arrays(n, cap, opacity_logit=3.0)
    (jparams, jopt_state), (state, opt) = setups(arrays, adam_steps=2)
    jnew, jopt_new = jd.reset_opacity(jparams, jd.init_densify_state(n, cap),
                                      jd.DensifyConfig(), opt_state=jopt_state)
    params, opt2 = pd.reset_opacity(state.params,
                                    pd.init_densify_state(n, cap, "cpu"),
                                    pd.DensifyConfig(), opt)
    assert params is state.params and opt2 is opt
    np.testing.assert_allclose(params.opacity_logits.detach().numpy(),
                               np.asarray(jnew.opacity_logits), rtol=1e-6)
    jm, pm = jax_moments(jopt_new), port_moments(opt)
    for f in FIELDS:
        for a, b in zip(pm[f], jm[f]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=f)
            assert (np.abs(a).max() == 0.0) == (f == "opacity_logits"), f
    step = opt.state[params.opacity_logits]["step"]
    assert float(step) == 2.0  # Adam's count is left alone


def test_train_step_with_densify_fits():
    """Train against a 27-gaussian cube from 8 gaussians at capacity 64,
    densify midway; the loss falls below 0.7x its start."""
    w = h = 64
    cfg = RenderConfig(max_pairs=20_000)
    cam = look_at_camera((3, -2.5, 2), (0, 0, 0), (0, 0, 1), fov=70,
                         width=w, height=h)
    target_scene = create_cube_scene(nx=3, scale=0.12, opacity=0.9,
                                      device="cpu")
    with torch.no_grad():
        target = render(*target_scene.render_args(), cam, cfg=cfg)

    n0, cap = 8, 64
    arrays = make_arrays(n0, cap, scale=0.15, opacity_logit=0.0, seed=3)
    state, opt = pt.init_train_state(pg.params_from_numpy(*arrays, "cpu"))
    dstate = pd.init_densify_state(n0, cap, device="cpu")
    step = pt.make_densify_train_step(opt, w, h, cfg=cfg)
    view = cam.to_view("cpu")
    gen = torch.Generator().manual_seed(0)
    losses = []
    for it in range(60):
        state, dstate, loss, aux = step(state, dstate, view, target)
        losses.append(float(loss))
        assert not bool(aux.overflow)
        assert not aux.radii[~dstate.active].any()  # inactive rows culled
        if it == 30:
            _, _, dstate, info = pd.densify_step(
                state.params, opt, dstate, gen, scene_extent=1.5,
                cfg=pd.DensifyConfig(grad_threshold=1e-4))
            assert int(dstate.num_active) > n0
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_ndc_grad_norm_scaling():
    """The pixel-space probe gradient scaled by W/2, H/2 (graphdeco's NDC
    units), and accumulate_stats at a resolution, against JAX."""
    g = np.asarray([[3e-6, 4e-6], [1e-5, 0.0]], np.float32)
    for res in ((), (800, 600), (640,)):
        want = np.asarray(jd.ndc_grad_norm(jnp.asarray(g), *res))
        got = pd.ndc_grad_norm(torch.from_numpy(g), *res).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        pd.ndc_grad_norm(torch.from_numpy(g), 800, 600).numpy(),
        [np.hypot(3e-6 * 400, 4e-6 * 300), 1e-5 * 400], rtol=1e-6)
    radii = np.asarray([5, 0], np.int32)  # the second gaussian invisible
    want = jd.accumulate_stats(jd.init_densify_state(2, 2), jnp.asarray(g),
                               jnp.asarray(radii), 800, 600)
    got = pd.accumulate_stats(pd.init_densify_state(2, 2, "cpu"),
                              torch.from_numpy(g), torch.from_numpy(radii),
                              800, 600)
    for f, a, b in zip(pd.DensifyState._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   err_msg=f)
    assert got.grad_sum[1] == 0.0


def test_init_densify_state_matches_jax():
    want = jd.init_densify_state(5, 9)
    got = pd.init_densify_state(5, 9, device="cpu")
    back = pd.densify_state_from_numpy(*map(np.asarray, want), "cpu")
    for f, a, b, c in zip(pd.DensifyState._fields, got, want, back):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
        assert a.dtype == c.dtype and torch.equal(a, c), f
    assert int(got.num_active) == 5
    with pytest.raises(ValueError, match="capacity"):
        pd.init_densify_state(10, 9, device="cpu")
