"""PyTorch port: ``utils/packing.py`` and ``io/synthetic.random_scene_device``.

``stack_cols``/``unstack_cols`` and their VJPs equal the JAX package's
(``jax.vjp``) and plain ``torch.stack``/``a[:, i]`` autograd exactly, with
columns that get no gradient. The differentiable path (the strict and the
production configuration, and two views of the batched training step) has
no ``SelectBackward0`` on a tensor of N rows in its backward graph and no
``aten::select_backward`` of N rows in a CPU profile of its backward. A
``render_aux`` frame through ``GaussianParams.activate`` gives the image
and the gradients of the select-based formulation the port had before
(frozen below) as equal values (``torch.equal`` after adding 0.0: the old
backward added every column into a +0.0-filled buffer, so a lone -0.0
cotangent came out +0.0), as does the photometric loss against its
slice-based formulation; the batched step's gradients stay within 1e-6
of its max |value| per group. ``random_scene_device``: shapes, dtypes,
ranges, unit quaternions, seeding, and moments within sampling error of
the JAX package's ``random_scene_device`` at N = 200K.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu.io.synthetic import random_scene_device as jrandom_scene_device
from luisacomputegaussiansplatting_tpu.utils import packing as jpk
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.io.synthetic import random_scene, random_scene_device
from luisacomputegaussiansplatting_tpu_torch.models import gaussians as pg
from luisacomputegaussiansplatting_tpu_torch.models import losses
from luisacomputegaussiansplatting_tpu_torch.models import trainer as pt
from luisacomputegaussiansplatting_tpu_torch.models.densify import init_densify_state
from luisacomputegaussiansplatting_tpu_torch.ops.render import render_aux
from luisacomputegaussiansplatting_tpu_torch.utils import packing as pk
from luisacomputegaussiansplatting_tpu_torch.utils.camera import CameraView, look_at_camera
from luisacomputegaussiansplatting_tpu_torch.utils.sh import num_sh_coeffs, sh_basis_comps

# the modules (``ops`` exports a function named ``render``)
projection, render, sh_eval = (
    importlib.import_module(f"luisacomputegaussiansplatting_tpu_torch.ops.{m}")
    for m in ("projection", "render", "sh_eval"))

torch.set_num_threads(2)

W, H = 48, 32
# no capacity of the frames below has 53 rows
N = 53
EYES = [((2.5, -2.2, 1.8), (0, 0, 0), (0, 0, 1)),
        ((-2.0, -2.6, 1.5), (0, 0, 0), (0, 0, 1))]
CAMS = [look_at_camera(*e, fov=70.0, width=W, height=H) for e in EYES]
CONFIGS = {
    "strict": dict(max_pairs=10_000),
    # bench.py:57-73's production settings, capacities sized for this scene
    "production": dict(max_pairs=1_500, tile=32, pack_mode="none",
                       tile_cull=True, max_pairs_sorted=1_300,
                       grad_reduce_dtype="bf16", payload_dtype="bf16",
                       sort_mode="fused", blend_quad="mxu"),
}
WIMG = torch.from_numpy(
    np.random.default_rng(0).normal(size=(3, H, W)).astype(np.float32))


def cols_and_cotangents(k, seed, n=37):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, k)).astype(np.float32)
    d = [rng.normal(size=n).astype(np.float32) for _ in range(k)]
    return a, d


@pytest.mark.parametrize("k", [1, 3, 48])
def test_unstack_cols_matches_jax(k):
    a, d = cols_and_cotangents(k, k)
    jcols, vjp = jax.vjp(jpk.unstack_cols, jnp.asarray(a))
    (jda,) = vjp(tuple(jnp.asarray(x) for x in d))
    at = torch.from_numpy(a).requires_grad_()
    cols = pk.unstack_cols(at)
    assert len(cols) == k
    torch.autograd.backward(cols, [torch.from_numpy(x) for x in d])
    for c, jc in zip(cols, jcols):
        np.testing.assert_array_equal(c.detach().numpy(), np.asarray(jc))
    np.testing.assert_array_equal(at.grad.numpy(), np.asarray(jda))


@pytest.mark.parametrize("k", [1, 3, 48])
def test_stack_cols_matches_jax(k):
    a, _ = cols_and_cotangents(k, k + 100)
    cols = [np.ascontiguousarray(a[:, i]) for i in range(k)]
    d = np.random.default_rng(k).normal(size=a.shape).astype(np.float32)
    jout, vjp = jax.vjp(jpk.stack_cols, *map(jnp.asarray, cols))
    jd = vjp(jnp.asarray(d))
    leaves = [torch.from_numpy(c).requires_grad_() for c in cols]
    out = pk.stack_cols(*leaves)
    out.backward(torch.from_numpy(d))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    for leaf, g in zip(leaves, jd):
        np.testing.assert_array_equal(leaf.grad.numpy(), np.asarray(g))


@pytest.mark.parametrize("used", [(0,), (1, 3), (4, 0, 2), (0, 1, 2, 3, 4)])
def test_unstack_cols_matches_selects(used):
    """Columns left out of the loss get no cotangent (None) and count as
    zeros, as the plain selects' zero-filled buffers do."""
    a, d = cols_and_cotangents(5, len(used))
    grads = []
    for split in (pk.unstack_cols, lambda t: [t[:, i] for i in range(5)]):
        at = torch.from_numpy(a).requires_grad_()
        cols = split(at)
        loss = sum((cols[i] * torch.from_numpy(d[i])).sum() for i in used)
        loss.backward()
        grads.append(at.grad)
    assert torch.equal(grads[0], grads[1])


def test_stack_cols_matches_torch_stack():
    a, _ = cols_and_cotangents(4, 7)
    d = torch.from_numpy(np.random.default_rng(8).normal(
        size=a.shape).astype(np.float32))
    outs, grads = [], []
    for stack in (pk.stack_cols, lambda *c: torch.stack(c, dim=1)):
        leaves = [torch.from_numpy(np.ascontiguousarray(a[:, i]))
                  .requires_grad_() for i in range(4)]
        out = stack(*leaves)
        (out * d).sum().backward()
        outs.append(out.detach())
        grads.append([x.grad for x in leaves])
    assert torch.equal(outs[0], outs[1])
    for g0, g1 in zip(*grads):
        assert torch.equal(g0, g1)


# ---- the port's formulation before utils/packing.py, frozen ---------------

def select_eval_sh_color(sh_coeffs, dirs, degree):
    k = num_sh_coeffs(degree)
    basis = sh_basis_comps(dirs[:, 0], dirs[:, 1], dirs[:, 2], degree)
    chans = []
    for c in range(3):
        acc = 0.5
        for i in range(k):
            acc = acc + basis[i] * sh_coeffs[:, i, c]
        chans.append(torch.clamp(acc, 0.0, 1.0))
    return torch.stack(chans, dim=1)


def cat_payload_table(proj, colors, opacities):
    return torch.cat(
        [proj.means2d, proj.conic, opacities.reshape(-1, 1), colors], dim=1
    ).to(torch.float32)


@pytest.fixture
def select_formulation(monkeypatch):
    """Puts the select-based formulation back in place: column selects
    ``a[:, i]`` and ``torch.stack`` wherever the port now unstacks and
    stacks, the frozen SH colour and the ``torch.cat`` payload table."""
    def unstack(a):
        return tuple(a[:, i] for i in range(a.shape[1]))

    def stack(*cols):
        return torch.stack(cols, dim=1)

    monkeypatch.setattr(sh_eval, "eval_sh_color", select_eval_sh_color)
    monkeypatch.setattr(render, "payload_table", cat_payload_table)
    for mod in (sh_eval, projection, render, pg):
        monkeypatch.setattr(mod, "unstack_cols", unstack)
        monkeypatch.setattr(mod, "stack_cols", stack)


def start_params(sh_degree=3, seed=13):
    return random_scene(N, seed=seed, sh_degree=sh_degree,
                        device="cpu").to_params()


def leaves_of(params):
    return pg.GaussianParams(
        *(p.detach().clone().requires_grad_(True) for p in params))


def frame(params, cfg, sh_degree):
    """A render_aux frame through activate(): (loss, image, the activated
    five groups, the raw params, bg)."""
    raw = leaves_of(params)
    scene = raw.activate()
    for t in scene:
        if t.requires_grad and not t.is_leaf:
            t.retain_grad()
    bg = torch.tensor([0.25, 0.5, 0.75], requires_grad=True)
    img, _ = render_aux(*scene.render_args(), CAMS[0], bg_color=bg,
                        cfg=cfg, sh_degree=sh_degree)
    return (img * WIMG).sum(), img, scene, raw, bg


def select_nodes(root, n):
    """Sizes of the inputs of every SelectBackward0 node reachable from
    ``root`` that have ``n`` in their shape, and the number of nodes."""
    seen, todo, bad = set(), [root], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "SelectBackward0":
            sizes = tuple(int(s) for s in fn._saved_self_sym_sizes)
            if n in sizes:
                bad.append(sizes)
        todo.extend(f for f, _ in fn.next_functions)
    return bad, len(seen)


def profiled(fn):
    """(aten::select_backward input shapes with N rows, op names) of a
    CPU profile of ``fn()``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        fn()
    events = prof.events()
    bad = [e.input_shapes for e in events
           if e.name == "aten::select_backward" and e.input_shapes
           and e.input_shapes[0][:1] == [N]]
    return bad, {e.name for e in events}


@pytest.mark.parametrize("case", ["strict", "production", "batched"])
def test_backward_has_no_select_of_n_rows(case, monkeypatch):
    if case == "batched":
        cfg = RenderConfig(**CONFIGS["production"])
        params = leaves_of(start_params())
        opt = pt.make_optimizer(params)
        step = pt.make_batched_train_step(opt, W, H, cfg=cfg)
        dstate = init_densify_state(N, N, device="cpu")
        views = CameraView(*(torch.stack(x) for x in
                             zip(*(c.to_view("cpu") for c in CAMS))))
        targets = torch.rand((2, 3, H, W),
                             generator=torch.Generator().manual_seed(3))
        graphs = []
        backward = torch.Tensor.backward

        def spy(loss, *a, **k):
            graphs.append(select_nodes(loss.grad_fn, N))
            return backward(loss, *a, **k)

        monkeypatch.setattr(torch.Tensor, "backward", spy)
        bad_prof, names = profiled(lambda: step(pt.TrainState(params, 0),
                                                dstate, views, targets))
        assert len(graphs) == 1
        (bad_graph, n_nodes), = graphs
    else:
        loss, *_ = frame(start_params(), RenderConfig(**CONFIGS[case]), 3)
        bad_graph, n_nodes = select_nodes(loss.grad_fn, N)
        bad_prof, names = profiled(loss.backward)
    assert n_nodes > 100
    assert bad_graph == []
    assert bad_prof == []
    # nor any other select: the transmittance leaves the tiles by a squeeze
    assert "aten::select_backward" not in names
    # the backward ran, and through the one stack of the unstacked columns
    assert {"aten::stack", "aten::unbind"} <= names


@pytest.mark.parametrize("case,sh_degree", [
    ("strict", 3), ("production", 3), ("strict", 1)])
def test_frame_equals_select_formulation(case, sh_degree, request):
    cfg = RenderConfig(**CONFIGS[case])
    params = start_params(sh_degree=3)

    def run():
        loss, img, scene, raw, bg = frame(params, cfg, sh_degree)
        loss.backward()
        grads = [t.grad for t in scene.render_args()] + [
            p.grad for p in raw] + [bg.grad]
        return img.detach(), grads

    img, grads = run()
    request.getfixturevalue("select_formulation")
    img_ref, grads_ref = run()
    assert torch.equal(img, img_ref)
    names = [*"msqos", *pg.GaussianParams._fields, "bg"]
    for name, g, r in zip(names, grads, grads_ref):
        assert g is not None and torch.isfinite(g).all(), name
        assert torch.equal(g + 0.0, r + 0.0), name


def test_batched_step_close_to_select_formulation(request):
    """Two views of the batched step: the six groups' gradients and the
    accumulated statistics within 1e-6 of each group's max |value| of the
    select-based formulation (the engine may add the views in another
    order)."""
    cfg = RenderConfig(**CONFIGS["production"])
    views = CameraView(*(torch.stack(x) for x in
                         zip(*(c.to_view("cpu") for c in CAMS))))
    targets = torch.rand((2, 3, H, W),
                         generator=torch.Generator().manual_seed(3))

    def run():
        params = leaves_of(pg.pad_params_to(start_params(), N + 4))
        opt = pt.make_optimizer(params)
        step = pt.make_batched_train_step(opt, W, H, cfg=cfg)
        dstate = init_densify_state(N, N + 4, device="cpu")
        _, dstate, loss, _ = step(pt.TrainState(params, 0), dstate, views,
                                  targets)
        return loss, [p.grad for p in params] + [dstate.grad_sum]

    loss, grads = run()
    request.getfixturevalue("select_formulation")
    loss_ref, grads_ref = run()
    assert torch.equal(loss, loss_ref)
    for g, r in zip(grads, grads_ref):
        scale = float(r.abs().max())
        assert scale > 0
        assert float((g - r).abs().max()) <= 1e-6 * scale


def select_ssim_map(img0, img1, c1=0.01**2, c2=0.03**2):
    """The SSIM map as the port had it: a select after the blur and a
    slice per moment (a zero-filled buffer each in the backward)."""
    c = img0.shape[0]
    stacked = torch.cat([img0, img1, img0 * img0, img1 * img1, img0 * img1],
                        dim=0)
    window = torch.from_numpy(losses._ssim_window())
    size = window.shape[0]
    kh = window.reshape(1, 1, size, 1).expand(5 * c, 1, size, 1)
    kw = window.reshape(1, 1, 1, size).expand(5 * c, 1, 1, size)
    b = torch.nn.functional.conv2d(stacked[None], kh,
                                   padding=(size // 2, 0), groups=5 * c)
    b = torch.nn.functional.conv2d(b, kw, padding=(0, size // 2),
                                   groups=5 * c)[0]
    mu0, mu1 = b[:c], b[c:2 * c]
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = b[2 * c:3 * c] - mu00
    s11 = b[3 * c:4 * c] - mu11
    s01 = b[4 * c:] - mu01
    return ((2 * mu01 + c1) * (2 * s01 + c2)
            / ((mu00 + mu11 + c1) * (s00 + s11 + c2)))


def test_loss_equals_select_formulation(monkeypatch):
    """The photometric loss splits the blurred moments and squeezes the
    blur's batch axis: the loss and its gradient equal the slice-based
    formulation's values."""
    rng = np.random.default_rng(2)
    pred = rng.uniform(size=(3, H, W)).astype(np.float32)
    target = torch.from_numpy(rng.uniform(size=(3, H, W)).astype(np.float32))
    out = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(losses, "ssim_map", select_ssim_map)
        p = torch.from_numpy(pred).requires_grad_()
        loss = losses.d_ssim_l1_loss(p, target)
        loss.backward()
        out.append((loss.detach(), p.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1] + 0.0, out[1][1] + 0.0)


# ---- random_scene_device ---------------------------------------------------

def test_random_scene_device_shapes_ranges_seed():
    s = random_scene_device(1000, seed=4, device="cpu")
    assert [tuple(a.shape) for a in s] == [(1000, 3), (1000, 3), (1000, 4),
                                           (1000,), (1000, 16, 3)]
    assert all(a.dtype == torch.float32 and a.device.type == "cpu"
               for a in s)
    assert bool(((s.means >= -3.0) & (s.means <= 3.0)).all())
    assert bool(((s.scales >= 0.01 * (1 - 1e-6))
                 & (s.scales <= 0.15 * (1 + 1e-6))).all())
    assert bool(((s.opacities >= 0.2) & (s.opacities <= 0.95)).all())
    assert float((torch.linalg.norm(s.quats, dim=1) - 1).abs().max()) < 1e-6
    colour = s.sh[:, 0] * 0.28209479177387814 + 0.5
    assert bool(((colour > 0.05 - 1e-6) & (colour < 0.95 + 1e-6)).all())
    again = random_scene_device(1000, seed=4, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(s, again))
    other = random_scene_device(1000, seed=5, device="cpu")
    assert not torch.equal(s.means, other.means)
    dc = random_scene_device(10, sh_degree=0, extent=1.0, device="cpu")
    assert tuple(dc.sh.shape) == (10, 1, 3)
    assert float(dc.means.abs().max()) <= 1.0


def test_random_scene_device_moments_match_jax():
    n = 200_000
    port = [a.numpy().astype(np.float64) for a in
            random_scene_device(n, seed=0, device="cpu")]
    ref = [np.asarray(a, np.float64) for a in jrandom_scene_device(n, seed=0)]
    for name, p, j in zip(["means", "scales", "quats", "opacities", "sh"],
                          port, ref):
        assert p.shape == j.shape, name
        assert not np.array_equal(p, j), name
        # per column (per coefficient and channel for sh): mean and mean
        # square, each within 6 standard errors of the two estimates
        p, j = p.reshape(n, -1), j.reshape(n, -1)
        for stat in (lambda x: x, lambda x: x * x):
            sp, sj = stat(p), stat(j)
            se = np.sqrt(sp.var(0) / n + sj.var(0) / n)
            diff = np.abs(sp.mean(0) - sj.mean(0))
            assert (diff <= 6 * se + 1e-12).all(), (name, diff.max())
