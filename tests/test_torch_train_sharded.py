"""PyTorch port: the (data, gs) mesh training step's loss and the sharded
densify round (``parallel/train_sharded.py``) on four gloo ranks on the CPU
(a 2x2 mesh); the two-step comparison with the JAX package's sharded step
is ``tests/test_torch_train_sharded_steps.py``.

* The sharded loss equals the single-device ``d_ssim_l1_loss`` within rtol
  2e-5 (``tests/test_sharding.py``), on an even band split and an uneven
  one, where the 5-row SSIM halo crosses band seams and the last band lies
  partly past the image; the JAX package's single-device loss agrees within
  the same rtol.
* The sharded densify round equals the single-device round on the same
  state and noise: parameters, both Adam moments, the DensifyState and the
  counters exactly.
* ``tests/test_sharding.py``'s scatter-free train step: every rank's
  backward of one densifying step (the means2d probe, the exchange and the
  halo-swapped D-SSIM loss) runs no ``index_add``, ``scatter_add``,
  ``scatter_reduce`` or accumulating ``index_put_``. JAX checks its
  compiled HLO; the port, the ops that its ``torch.profiler`` trace records
  under the autograd engine.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from luisacomputegaussiansplatting_tpu.config import RenderConfig as JConfig
from luisacomputegaussiansplatting_tpu.models import trainer as jt
from luisacomputegaussiansplatting_tpu.models.losses import d_ssim_l1_loss as jloss
from luisacomputegaussiansplatting_tpu.ops.render import render as jrender
from luisacomputegaussiansplatting_tpu.utils.camera import look_at_camera as jlook
from luisacomputegaussiansplatting_tpu_torch.config import RenderConfig
from luisacomputegaussiansplatting_tpu_torch.models.losses import d_ssim_l1_loss
from luisacomputegaussiansplatting_tpu_torch.ops.render import render

torch.set_num_threads(2)

MESH = (2, 2)
N_WORLD = 4
CFG = dict(max_pairs=20_000)
SCFG = dict(max_pairs_local=8192, exchange_capacity=2048)
EYES = [(3.0, -2.5, 2.0), (-2.5, 3.0, 1.5)]


def train_case(height, steps, densify=False, tseed=5, profile=False):
    return dict(mesh=MESH, n=96, seed=21, perturb_seed=3, width=64,
                height=height, eyes=EYES, target_seed=tseed, cfg=CFG,
                scfg=SCFG, steps=steps, densify=densify,
                active_every=2 if densify else 1, profile=profile)


CASES = {
    "even": train_case(64, 1),
    "uneven": train_case(48, 1, tseed=6),
    "scatter": train_case(48, 1, densify=True, tseed=11, profile=True),
}

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.Ranks(W.train_cases, N_WORLD, tmp_path_factory.mktemp("train"),
                   cases=list(CASES.values()))


@pytest.fixture(scope="module")
def densify_ranks(tmp_path_factory):
    return W.Ranks(W.densify_case, N_WORLD, tmp_path_factory.mktemp("dens"),
                   n=40, cap=64, seed=2, noise_seed=11, extent=2.0,
                   threshold=0.5)


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


@pytest.mark.parametrize("name", ["even", "uneven"])
def test_sharded_loss_equals_single_device(ranks, name):
    """The first step's loss is the mean single-device d_ssim_l1_loss of the
    two views at the starting parameters (the halo makes SSIM exact across
    band seams); JAX's single-device loss agrees."""
    case = CASES[name]
    h = case["height"]
    scene = W._start_params(case).activate()
    cfg = RenderConfig(**CFG)
    tg = W.train_targets(case)
    ref = np.mean([float(d_ssim_l1_loss(
        render(*scene.render_args(), W.camera(e, 64, h), cfg=cfg),
        torch.from_numpy(tg[i]))) for i, e in enumerate(EYES)])
    got = port(ranks, name)["losses"][0]
    np.testing.assert_allclose(got, ref, rtol=2e-5)
    jscene = jax_state(case).activate()
    cams, _ = jax_views(h)
    jref = np.mean([float(jloss(jrender(*jscene.render_args(), c,
                                        cfg=JConfig(**CFG)),
                                jnp.asarray(tg[i]), 0.2))
                    for i, c in enumerate(cams)])
    np.testing.assert_allclose(got, jref, rtol=2e-5)


def test_sharded_densify_round_equals_single_device(densify_ranks):
    """Every rank's gathered result of the sharded round equals the
    single-device round: parameters, Adam moments, DensifyState, counters;
    the round cloned or split something and the noise reached the split."""
    for got, want in densify_ranks.results():
        assert got["info"] == want["info"]
        assert want["info"][1] + want["info"][2] > 0
        for key in ("params", "moments", "dstate"):
            for a, b in zip(got[key], want[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)


#: the autograd Functions of the step's backward that the profile must see:
#: the halo swap, the exchange, the blend and the payload reduction
STEP_FUNCTIONS = {"_BandHalosBackward", "_ExchangeRowsBackward",
                  "_RasterizeTilesBackward", "_PackGatherBackward"}


def test_sharded_train_step_has_no_scatter(ranks):
    """No rank's backward of the densifying step on the 2x2 mesh runs a
    scatter-add, and the profile saw that backward whole."""
    for rank, r in enumerate(ranks.results()):
        res = r[list(CASES).index("scatter")]
        assert res["scatter_ops"] == [], (rank, res["scatter_ops"])
        assert STEP_FUNCTIONS <= set(res["functions"]), (rank,
                                                         res["functions"])
        assert not res["overflows"][0]
