"""K7, the Adam kernel (``csrc/adam.cu``), and the optimizer class that
launches it (``ops/adam.py::Adam``), against ``torch.optim.Adam``.

The unmarked cases run on the CPU: CPU parameters take torch's own update
and build nothing, and the kernel wrapper's checks raise before any build.
Cases marked ``card`` need a CUDA device and skip without one. This file
imports no JAX; on the card run it alone, without the JAX-loading
``conftest.py``:

    python -m pytest tests/test_torch_adam.py -q --noconftest

Tolerances on the card, against torch's foreach update: the moments within
MOMENT_ULPS float32 ulps of torch's, relative (the kernel rounds each op as
torch's foreach kernels do, in their order); the parameters within
PARAM_TOL x their group's largest update.
"""

import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene
from luisacomputegaussiansplatting_tpu_torch.models import checkpoint
from luisacomputegaussiansplatting_tpu_torch.models import densify
from luisacomputegaussiansplatting_tpu_torch.models import trainer
from luisacomputegaussiansplatting_tpu_torch.models.gaussians import (
    GaussianParams, pad_params_to)
from luisacomputegaussiansplatting_tpu_torch.ops import adam
from luisacomputegaussiansplatting_tpu_torch.utils import profiling

MOMENT_ULPS = 4
PARAM_TOL = 1e-6
#: the means learning rate decays over a few steps, so it changes every step
TC = trainer.TrainConfig(lr_means_decay_steps=4, spatial_lr_scale=2.5)
#: gsplat's batch rule at 4 views a step (``simple_trainer.py``
#: ``create_splats_with_optimizers``): betas 1 - 4 (1 - beta), eps / 2
TC_B4 = trainer.TrainConfig(lr_means_decay_steps=4, spatial_lr_scale=2.5,
                            adam_eps=5e-16, adam_beta1=0.6, adam_beta2=0.996)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def shapes(n):
    """The six groups of a scene of ``n`` gaussians at SH degree 3."""
    return [(n, 3), (n, 3), (n, 4), (n,), (n, 1, 3), (n, 15, 3)]


def draw(shape_list, seed, device, tiny_share=0.1):
    """Tensors of normal values; ``tiny_share`` of the entries rounding
    level (1e-12) or zero, where eps 1e-15 turns a gradient into a full
    step."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shape_list:
        a = rng.normal(0.0, 1.0, s)
        u = rng.uniform(size=s)
        a = np.where(u < tiny_share / 2, a * 1e-12, a)
        a = np.where(u > 1.0 - tiny_share / 2, 0.0, a)
        out.append(torch.tensor(a, dtype=torch.float32, device=device))
    return out


def torch_twin(params, tc=TC, betas=(0.9, 0.999), **kw):
    """``torch.optim.Adam`` as ``trainer.make_optimizer`` configured it
    before K7 (the betas then fixed at 0.9 / 0.999): the same groups,
    learning rates, betas and eps."""
    lrs = trainer._group_lrs(tc)
    return torch.optim.Adam(
        [{"params": [getattr(params, name)], "lr": lrs[name], "name": name}
         for name in GaussianParams._fields],
        betas=betas, eps=tc.adam_eps, **kw)


def leaves(values):
    return GaussianParams(*(v.detach().clone().requires_grad_(True)
                            for v in values))


def run_steps(opt, params, grads_per_step, first=0, tc=TC):
    """``optimizer_step`` once for each list of gradients (None leaves a
    parameter without one)."""
    for k, grads in enumerate(grads_per_step):
        for p, g in zip(params, grads):
            p.grad = None if g is None else g.clone()
        trainer.optimizer_step(opt, tc, first + k)


def assert_states_equal(opt_a, params_a, opt_b, params_b):
    for a, b in zip(params_a, params_b):
        assert torch.equal(a, b)
        sa, sb = opt_a.state.get(a, {}), opt_b.state.get(b, {})
        assert sa.keys() == sb.keys()
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("missing", [None, "quats"])
def test_cpu_update_equals_torch_adam(missing):
    """Three steps over the six groups, a means learning rate that changes
    every step (and one group without a gradient): bit for bit as
    ``torch.optim.Adam``, with no K7 build or launch."""
    before = (adam.KERNEL._lib, adam.KERNEL.launches)
    start = draw(shapes(40), 1, "cpu")
    state, opt = trainer.init_train_state(GaussianParams(*start), TC)
    assert type(opt) is adam.Adam
    twin_params = leaves(start)
    twin = torch_twin(twin_params)
    names = GaussianParams._fields
    steps = [[None if n == missing else g
              for n, g in zip(names, draw(shapes(40), 10 + k, "cpu"))]
             for k in range(3)]
    lrs = []
    for k in range(3):
        run_steps(opt, state.params, steps[k:k + 1], first=k)
        run_steps(twin, twin_params, steps[k:k + 1], first=k)
        lrs.append(opt.param_groups[0]["lr"])
    assert len(set(lrs)) == 3
    assert_states_equal(opt, state.params, twin, twin_params)
    if missing is not None:
        p = getattr(state.params, missing)
        assert p not in opt.state and torch.equal(p, start[names.index(missing)])
    assert (adam.KERNEL._lib, adam.KERNEL.launches) == before


@pytest.mark.parametrize("tc", [TC, TC_B4], ids=["default", "gsplat_b4"])
def test_betas_reach_every_group_and_update_as_torch(tc):
    """``make_optimizer`` puts ``adam_beta1`` / ``adam_beta2`` and
    ``adam_eps`` into every group; three CPU updates equal
    ``torch.optim.Adam``'s at those betas bit for bit (at the defaults,
    the optimizer the betas were fixed in before)."""
    start = draw(shapes(30), 12, "cpu")
    state, opt = trainer.init_train_state(GaussianParams(*start), tc)
    betas = (tc.adam_beta1, tc.adam_beta2)
    assert [g["betas"] for g in opt.param_groups] == [betas] * 6
    assert [g["eps"] for g in opt.param_groups] == [tc.adam_eps] * 6
    twin_params = leaves(start)
    twin = torch_twin(twin_params, tc, betas)
    steps = [draw(shapes(30), 40 + k, "cpu") for k in range(3)]
    run_steps(opt, state.params, steps, tc=tc)
    run_steps(twin, twin_params, steps, tc=tc)
    assert_states_equal(opt, state.params, twin, twin_params)


def test_state_layout_matches_torch():
    """``param_groups`` and ``state`` hold torch's keys and types: ``step`` a
    0-d float32 CPU tensor, moments shaped like their parameters, made at a
    parameter's first update."""
    start = draw(shapes(8), 2, "cpu")
    state, opt = trainer.init_train_state(GaussianParams(*start), TC)
    twin_params = leaves(start)
    twin = torch_twin(twin_params)
    assert not opt.state
    for ga, gb in zip(opt.param_groups, twin.param_groups):
        assert ga.keys() == gb.keys()
        assert (ga["lr"], ga["betas"], ga["eps"], ga["name"]) == (
            gb["lr"], gb["betas"], gb["eps"], gb["name"])
    grads = draw(shapes(8), 3, "cpu")
    run_steps(opt, state.params, [grads])
    run_steps(twin, twin_params, [grads])
    for p, q in zip(state.params, twin_params):
        st, tt = opt.state[p], twin.state[q]
        assert set(st) == set(tt) == {"step", "exp_avg", "exp_avg_sq"}
        assert st["step"].device.type == "cpu" and st["step"].dim() == 0
        assert st["step"].dtype == tt["step"].dtype == torch.float32
        assert float(st["step"]) == 1.0
        for key in ("exp_avg", "exp_avg_sq"):
            assert st[key].shape == p.shape and st[key].dtype == p.dtype
    assert opt.state_dict()["state"].keys() == twin.state_dict()["state"].keys()


@pytest.mark.parametrize("torch_adam_hooked", [False, True])
def test_step_runs_in_the_optimizer_range(monkeypatch, torch_adam_hooked):
    """Under ``torch.profiler`` each ``step()`` runs in a range
    ``Optimizer.step#Adam.step`` (the prefix ``adam_ms.*`` reads), whether
    or not torch has already wrapped ``torch.optim.Adam.step`` in its own
    (then the CPU update's ranges nest, one inside the other)."""
    step = torch.optim.Adam.step
    if getattr(step, "hooked", False) and not torch_adam_hooked:
        monkeypatch.setattr(torch.optim.Adam, "step", step.__wrapped__)
    start = draw(shapes(8), 4, "cpu")
    if torch_adam_hooked:
        torch_twin(leaves(start))  # its construction wraps Adam.step
        assert getattr(torch.optim.Adam.step, "hooked", False)
    else:
        assert not getattr(torch.optim.Adam.step, "hooked", False)
    state, opt = trainer.init_train_state(GaussianParams(*start), TC)
    with torch.profiler.profile() as prof:
        run_steps(opt, state.params, [draw(shapes(8), 5 + k, "cpu")
                                      for k in range(2)])
    names = [e.name for e in prof.events()
             if e.name.startswith("Optimizer.step#")]
    assert len(names) >= 2 and set(names) == {"Optimizer.step#Adam.step"}


def test_cpu_float64_takes_torch_update():
    """The path follows the device alone: float64 CPU parameters take
    torch's own update, bit for bit, with no K7 build or launch."""
    before = (adam.KERNEL._lib, adam.KERNEL.launches)
    start = [torch.randn(5, 3, dtype=torch.float64) for _ in range(2)]
    params = [s.clone().requires_grad_(True) for s in start]
    twin_params = [s.clone().requires_grad_(True) for s in start]
    opt = adam.Adam(params, lr=1e-2, eps=1e-15)
    twin = torch.optim.Adam(twin_params, lr=1e-2, eps=1e-15)
    for k in range(2):
        for p, q in zip(params, twin_params):
            p.grad = torch.randn_like(p)
            q.grad = p.grad.clone()
        opt.step()
        twin.step()
    assert_states_equal(opt, params, twin, twin_params)
    assert opt.state[params[0]]["step"].dtype == twin.state[
        twin_params[0]]["step"].dtype
    assert (adam.KERNEL._lib, adam.KERNEL.launches) == before


def density_setup(dev, seed=7):
    """A 48-gaussian scene in 64 rows, its Adam stepped once (the state, the
    optimizer, the parameters before the step, its gradients), statistics
    that clone and split some rows."""
    scene = random_scene(48, seed=seed, device=dev)
    params = pad_params_to(scene.to_params(), 64)
    state, opt = trainer.init_train_state(params, TC)
    start = [p.detach().clone() for p in state.params]
    grads = draw([tuple(p.shape) for p in state.params], seed + 1, dev)
    run_steps(opt, state.params, [grads])
    dstate = densify.init_densify_state(48, 64, device=dev)
    rng = np.random.default_rng(seed)
    dstate = dstate._replace(
        grad_sum=torch.tensor(rng.uniform(0.0, 1e-3, 64), dtype=torch.float32,
                              device=dev) * dstate.active,
        count=dstate.active.to(torch.float32))
    return state, opt, start, grads, dstate


def test_density_control_surgery_on_it():
    """``density_control``'s round zeroes the moments of the rows that do
    not survive, in the class's state exactly as in torch's, and the next
    update matches torch's bit for bit."""
    state, opt, start, grads, dstate = density_setup("cpu")
    twin_params = leaves(start)
    twin = torch_twin(twin_params)
    run_steps(twin, twin_params, [grads])
    assert_states_equal(opt, state.params, twin, twin_params)
    out = []
    for o, p in ((opt, state.params), (twin, twin_params)):
        gen = torch.Generator().manual_seed(3)
        _, ds, info = densify.density_control(
            600, densify.DensifySchedule(), p, o, dstate, gen, 3.0)
        out.append((ds, info))
    (ds, info), _ = out
    assert int(info.n_cloned) + int(info.n_split) > 0
    assert_states_equal(opt, state.params, twin, twin_params)
    gone = ~(dstate.active & ds.active)
    assert gone.any()
    for p in state.params:
        for key in ("exp_avg", "exp_avg_sq"):
            assert not opt.state[p][key][gone].any()
    nxt = draw([tuple(p.shape) for p in state.params], 30, "cpu")
    run_steps(opt, state.params, [nxt], first=1)
    run_steps(twin, twin_params, [nxt], first=1)
    assert_states_equal(opt, state.params, twin, twin_params)


def test_checkpoint_round_trip(tmp_path):
    """``models/checkpoint.py`` saves the class's state and loads it into a
    fresh one; the next update then equals the one without the trip."""
    start = draw(shapes(10), 8, "cpu")
    state, opt = trainer.init_train_state(GaussianParams(*start), TC)
    run_steps(opt, state.params, [draw(shapes(10), 9 + k, "cpu")
                                  for k in range(2)])
    path = str(tmp_path / "ck.npz")
    checkpoint.save_npz(path, (state.params, opt, 2))
    fresh, fopt = trainer.init_train_state(GaussianParams(*start), TC)
    _, fopt2, step = checkpoint.load_npz(path, (fresh.params, fopt, 0))
    assert fopt2 is fopt and step == 2
    assert_states_equal(fopt, fresh.params, opt, state.params)
    grads = draw(shapes(10), 20, "cpu")
    for o, p in ((opt, state.params), (fopt, fresh.params)):
        run_steps(o, p, [grads], first=2)
    assert_states_equal(fopt, fresh.params, opt, state.params)


OPTIONS = [{"amsgrad": True}, {"weight_decay": 1e-4}, {"maximize": True},
           {"foreach": True}, {"capturable": True}, {"differentiable": True},
           {"fused": True}, {"decoupled_weight_decay": True}]


@pytest.mark.parametrize("option", OPTIONS, ids=lambda o: next(iter(o)))
def test_unsupported_options_raise(option):
    """torch.optim.Adam's other options raise at construction: as keyword
    arguments (the constructor takes lr, betas and eps alone) and as a
    parameter group's keys."""
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(TypeError):
        adam.Adam([p], **option)
    with pytest.raises(ValueError, match=next(iter(option))):
        adam.Adam([{"params": [p], **option}])


def test_tensor_hyperparameters_raise():
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match="tensor"):
        adam.Adam([p], lr=torch.tensor(1e-3))
    with pytest.raises(ValueError, match="tensor"):
        adam.Adam([{"params": [p], "betas": (torch.tensor(0.9), 0.999)}])


def test_wrapper_checks_raise_before_any_build(monkeypatch):
    """Non-float32, unaligned, CPU or meta tensors, shapes that differ,
    non-contiguous tensors, malformed lists and more tensors than one
    launch takes raise in the wrapper before the library is built."""

    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(adam.KERNEL, "lib", no_build)
    launches = adam.KERNEL.launches
    p, g, m, v = draw([(6, 3)] * 4, 11, "cpu")
    h = (-1e-3, 0.1, 0.1, 0.999, 1e-3, 1e-15)
    meta = [t.to("meta") for t in (p, g, m, v)]
    off = torch.empty(19)[1:].view(6, 3)  # 4 bytes past an aligned start
    assert off.data_ptr() % 16 == 4
    call = adam.adam_kernel
    cases = [
        (lambda: call([p.double()], [g], [m], [v], [h]), "float32"),
        (lambda: call([p], [g], [m.half()], [v], [h]), "float32"),
        (lambda: call([p], [g], [m], [off], [h]), "aligned"),
        (lambda: call([p], [g], [m], [v], [h]), "CUDA"),
        (lambda: call(*([t] for t in meta), [h]), "CUDA"),
        (lambda: call([p], [g[:5]], [m], [v], [h]), "shape"),
        (lambda: call([p], [g], [m], [v.t()], [h]), "shape"),
        (lambda: call([p.t()], [g.t()], [m.t()], [v.t()], [h]), "CUDA"),
        (lambda: call([p], [g], [m], [v], [h[:5]]), "six"),
        (lambda: call([p, p], [g], [m], [v], [h]), "one gradient"),
        (lambda: call(*([t] * 17 for t in (p, g, m, v)), [h] * 17),
         "at most 16"),
    ]
    for fn, match in cases:
        with pytest.raises(ValueError, match=match):
            fn()
    assert adam.KERNEL.launches == launches


# ---------------------------------------------------------------------------
# The card: K7 against torch.optim.Adam's foreach update
# ---------------------------------------------------------------------------


def assert_close_to_torch(got_opt, got_params, want_opt, want_params,
                          start):
    """Moments within MOMENT_ULPS ulps relative, parameters within
    PARAM_TOL x their group's largest update, ``step`` equal."""
    ulp = torch.finfo(torch.float32).eps
    for p, q, s in zip(got_params, want_params, start):
        got, want = got_opt.state.get(p), want_opt.state.get(q)
        assert (got is None) == (want is None)
        if got is None:
            assert torch.equal(p, s)
            continue
        assert torch.equal(got["step"], want["step"])
        assert got["step"].device.type == "cpu"
        for key in ("exp_avg", "exp_avg_sq"):
            err = (got[key] - want[key]).abs()
            assert bool((err <= MOMENT_ULPS * ulp * want[key].abs()).all()), (
                key, float(err.max()))
        scale = float((q - s).detach().abs().max())
        err = float((p - q).detach().abs().max())
        assert err <= PARAM_TOL * scale, (err, scale)


def card_run(dev, sizes, n_steps, missing=(), seed=0, tc=TC):
    """(K7's params and optimizer, torch's foreach twin's, the start) after
    ``n_steps`` updates of the six groups shaped by ``sizes`` (a gaussian
    count, or one list of shapes); ``missing`` groups have no gradient."""
    shp = shapes(sizes) if isinstance(sizes, int) else sizes
    start = draw(shp, seed, dev)
    state, opt = trainer.init_train_state(GaussianParams(*start), tc)
    twin_params = leaves(start)
    twin = torch_twin(twin_params, tc, (tc.adam_beta1, tc.adam_beta2),
                      foreach=True)
    names = GaussianParams._fields
    for k in range(n_steps):
        grads = [None if n in missing else g for n, g in
                 zip(names, draw(shp, seed + 1 + k, dev))]
        run_steps(opt, state.params, [grads], first=k, tc=tc)
        run_steps(twin, twin_params, [grads], first=k, tc=tc)
    torch.cuda.synchronize()
    return state.params, opt, twin_params, twin, start


@pytest.mark.card
def test_kernel_matches_torch_scaled_scene(card):
    """Six groups shaped as the bicycle cells' (6M x 59 floats), at 100K
    gaussians, three updates with a changing means learning rate: one K7
    launch a step, within tolerance of torch's foreach update."""
    adam.KERNEL.reset_launches()
    got, opt, want, twin, start = card_run(card, 100_000, 3)
    assert adam.KERNEL.launches == 3
    assert_close_to_torch(opt, got, twin, want, start)


@pytest.mark.card
def test_kernel_matches_torch_at_batch_betas(card):
    """gsplat's batch-4 betas (0.6, 0.996) and eps 5e-16 reach K7: three
    updates within tolerance of torch's foreach update at the same."""
    got, opt, want, twin, start = card_run(card, 20_000, 3, seed=5,
                                           tc=TC_B4)
    assert [g["betas"] for g in opt.param_groups] == [(0.6, 0.996)] * 6
    assert_close_to_torch(opt, got, twin, want, start)


@pytest.mark.card
def test_parameter_without_grad(card):
    """A parameter whose ``.grad`` is None is skipped as torch skips it:
    no state, unchanged, and the others updated."""
    got, opt, want, twin, start = card_run(card, 5_000, 2,
                                           missing=("quats", "sh_dc"))
    assert_close_to_torch(opt, got, twin, want, start)
    assert got.quats not in opt.state and got.means in opt.state


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 2, 3, 5, 4097, 1_000_003])
def test_odd_sizes_take_the_tail(card, n):
    """Element counts that are not a multiple of 4 end in a partial float4
    unit: every float of it is updated."""
    got, opt, want, twin, start = card_run(
        card, [(n,), (n, 3), (n, 1), (n, 5), (n, 1, 3), (n, 7)], 2, seed=n)
    assert_close_to_torch(opt, got, twin, want, start)


@pytest.mark.card
def test_unaligned_tensors_raise(card):
    """A tensor that starts 4 bytes past a 16-byte boundary is refused
    before the launch: K7 walks every array in float4 units."""
    p, g, m, v = (torch.zeros(101, device=card) for _ in range(4))
    off = torch.zeros(102, device=card)[1:]
    assert off.data_ptr() % 16 == 4
    h = (-1e-3, 0.1, 0.1, 0.999, 1e-3, 1e-15)
    launches = adam.KERNEL.launches
    for quad in ((off, g, m, v), (p, off, m, v), (p, g, off, v),
                 (p, g, m, off)):
        with pytest.raises(ValueError, match="aligned"):
            adam.adam_kernel(*([t] for t in quad), [h])
    assert adam.KERNEL.launches == launches


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
def test_cuda_parameters_of_other_dtypes_raise(card, dtype):
    """CUDA parameters that are not float32 raise in the step: they are
    not handed to torch's update."""
    p = torch.zeros(8, device=card, dtype=dtype, requires_grad=True)
    p.grad = torch.ones_like(p)
    opt = adam.Adam([p], lr=1e-3)
    launches = adam.KERNEL.launches
    with pytest.raises(ValueError, match="float32"):
        opt.step()
    assert adam.KERNEL.launches == launches
    assert not p.detach().any()


@pytest.mark.card
def test_mixed_devices_raise(card):
    """A CUDA and a CPU parameter in one optimizer raise in the step."""
    a = torch.zeros(8, device=card, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    a.grad, b.grad = torch.ones_like(a), torch.ones_like(b)
    opt = adam.Adam([{"params": [a]}, {"params": [b]}], lr=1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        opt.step()
    assert not a.detach().any() and not b.detach().any()


@pytest.mark.card
def test_sixteen_tensors_take_one_launch(card):
    """The most tensors one launch takes, of sizes 37-52, each its own
    group: one launch a step, each tensor within tolerance of torch's."""
    start = [torch.randn(37 + i, device=card) for i in range(adam.MAX_TENSORS)]
    params = [s.clone().requires_grad_(True) for s in start]
    twin_params = [s.clone().requires_grad_(True) for s in start]
    opt = adam.Adam([{"params": [p], "lr": 1e-3 * (i + 1)}
                     for i, p in enumerate(params)], eps=1e-15)
    twin = torch.optim.Adam([{"params": [p], "lr": 1e-3 * (i + 1)}
                             for i, p in enumerate(twin_params)], eps=1e-15,
                            foreach=True)
    adam.KERNEL.reset_launches()
    for _ in range(2):
        for p, q in zip(params, twin_params):
            p.grad = torch.randn_like(p)
            q.grad = p.grad.clone()
        opt.step()
        twin.step()
    torch.cuda.synchronize()
    assert adam.KERNEL.launches == 2
    for p, q, s in zip(params, twin_params, start):
        scale = float((q - s).detach().abs().max())
        assert float((p - q).detach().abs().max()) <= PARAM_TOL * scale


@pytest.mark.card
def test_counter_and_range_on_the_card(card):
    """Under the profiler a step's kernel runs in ``Optimizer.step#`` and
    counts every element it updated in ``adam.kernel_elements``."""
    start = draw(shapes(1000), 13, card)
    state, opt = trainer.init_train_state(GaussianParams(*start), TC)
    profiling.counts("adam.kernel_elements")
    before = len(profiling.counts("adam.kernel_elements"))
    with torch.profiler.profile() as prof:
        run_steps(opt, state.params, [draw(shapes(1000), 14, card)])
    torch.cuda.synchronize()
    got = profiling.counts("adam.kernel_elements")[before:]
    assert got == [59 * 1000]
    assert any(e.name.startswith("Optimizer.step#") for e in prof.events())


@pytest.mark.card
def test_density_and_checkpoint_on_the_card(card, tmp_path):
    """The round's moment surgery and a checkpoint round trip on K7's
    state; the next K7 update then equals the one without the trip."""
    state, opt, _start, _grads, dstate = density_setup(card)
    gen = torch.Generator(device=card).manual_seed(3)
    before = {p: {k: opt.state[p][k].clone() for k in ("exp_avg",
                                                       "exp_avg_sq")}
              for p in state.params}
    _, ds, info = densify.density_control(
        600, densify.DensifySchedule(), state.params, opt, dstate, gen, 3.0)
    # rows active before and after are survivors (moments kept) or a split
    # parent's row that took a child (zeroed); every other row is zeroed
    kept = dstate.active & ds.active
    assert int(info.n_cloned) + int(info.n_split) > 0
    for p in state.params:
        for key, old in before[p].items():
            new = opt.state[p][key].reshape(64, -1)
            same = (new == old.reshape(64, -1)).all(1)
            zero = (new == 0).all(1)
            assert bool(zero[~kept].all())
            assert bool((same | zero)[kept].all())
            assert not bool(zero[kept].all())
    path = str(tmp_path / "ck.npz")
    checkpoint.save_npz(path, (state.params, opt, 1))
    fresh, fopt = trainer.init_train_state(
        GaussianParams(*(torch.zeros_like(p) for p in state.params)), TC)
    checkpoint.load_npz(path, (fresh.params, fopt, 0))
    assert fopt.state[fresh.params[0]]["step"].device.type == "cpu"
    grads = draw([tuple(p.shape) for p in state.params], 40, card)
    for o, p in ((opt, state.params), (fopt, fresh.params)):
        run_steps(o, p, [grads], first=1)
    torch.cuda.synchronize()
    assert_states_equal(fopt, fresh.params, opt, state.params)
