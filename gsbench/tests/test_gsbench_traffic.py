"""The inputs drawn from a seed repeat for that seed and differ across
seeds; seeds past 32 bits are taken."""

import itertools

import torch

from gsbench import harness, inputs

SEEDS = (5, 2**31 + 12345)
SCENE = {"n_gaussians": 500, "sh_degree": 3, "extent": 3.0,
         "scale_min": 0.004, "scale_max": 0.02, "opacity_min": 0.2,
         "opacity_max": 0.95, "sh_rest_std": 0.05}
CPU = torch.device("cpu")


def test_scene_and_targets_repeat_for_a_seed_and_differ_across():
    a = inputs.draw_params(SCENE, SEEDS[1], CPU)
    b = inputs.draw_params(SCENE, SEEDS[1], CPU)
    c = inputs.draw_params(SCENE, SEEDS[0], CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    t1 = inputs.draw_targets(3, 40, 30, SEEDS[1], CPU)
    assert torch.equal(t1, inputs.draw_targets(3, 40, 30, SEEDS[1], CPU))
    assert not torch.equal(t1, inputs.draw_targets(3, 40, 30, SEEDS[0], CPU))
    assert 0.0 <= float(t1.min()) and float(t1.max()) <= 1.0


def test_scene_distributions():
    means, log_s, quats, logits, dc, rest = inputs.draw_params(
        {**SCENE, "n_gaussians": 20000}, 3, CPU)
    assert float(means.abs().max()) <= 3.0
    s = torch.exp(log_s)
    assert 0.004 <= float(s.min()) and float(s.max()) <= 0.02 * (1 + 1e-6)
    assert torch.allclose(quats.norm(dim=1), torch.ones(20000), atol=1e-5)
    op = torch.sigmoid(logits)
    assert 0.2 - 1e-6 <= float(op.min()) and float(op.max()) <= 0.95 + 1e-6
    assert dc.shape == (20000, 1, 3) and rest.shape == (20000, 15, 3)


def test_view_order_repeats_for_a_seed_and_covers_every_view():
    take = lambda s: list(itertools.islice(inputs.view_stream(10, s), 25))
    a = take(SEEDS[1])
    assert a == take(SEEDS[1]) and a != take(SEEDS[0])
    assert sorted(a[:10]) == list(range(10)) == sorted(a[10:20])


def test_render_paths_visit_the_same_poses_from_a_seeded_start():
    for cell in ("bicycle-render-1080p", "lego-render-800"):
        c = harness.make_cell(cell, 0, CPU)
        p1 = inputs.RenderPath(c.config["dataset"], c.traffic, SEEDS[1], CPU)
        p2 = inputs.RenderPath(c.config["dataset"], c.traffic, SEEDS[1], CPU)
        p3 = inputs.RenderPath(c.config["dataset"], c.traffic, SEEDS[0], CPU)
        assert p1.start == p2.start and p1.start != p3.start
        assert sorted(p1.index(k) for k in range(360)) == list(range(360))
        for a in (0, 90, 359):
            assert torch.equal(p1.views[a].view, p3.views[a].view)


def test_training_views():
    c = harness.make_cell("bicycle-train", 0, CPU)
    assert len(inputs.train_views(c.config["dataset"], CPU)) == 169
    c = harness.make_cell("lego-train", 0, CPU)
    views = inputs.train_views(c.config["dataset"], CPU)
    assert len(views) == 100
    for v in views:
        # every camera sits on the hemisphere of the dataset's radius
        assert abs(float(v.position.norm()) - 4.0311289) < 1e-4
        assert float(v.position[2]) > 0
