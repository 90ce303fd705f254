"""PyTorch port: the train CLI against the JAX CLI on one argv.

Both CLIs fit 12 steps to the same synthetic-gt views (the port's targets
within BLEND_TOL of JAX's), from the same numpy init and view order, with
the active SH degree raised every 4 steps and no densify round. Every
step's loss, recorded by wrapping each package's step factory, agrees
within 1e-4 relative; so does every logged loss line.

The export is compared after step 2: each package's own ``save_ply`` of its
active gaussians then, every PLY field within 1e-4 of the field's max
|value|. Later the fields part, though the losses do not: the random init
is isotropic, and a gaussian whose scale gradients share a sign stays
exactly isotropic after Adam's first step, so its rotation gradient is
rounding noise whose sign Adam (eps 1e-15) turns into a full learning-rate
step: after step 3 a few rows' quaternions differ by up to 0.4 of the
field's max, and the SH band that opens at step 8 moves the same way.
The final PLYs hold the same gaussians. (Own file: the JAX run compiles a
step per SH degree and takes most of this file's time.)
"""

import re

import numpy as np
import torch

from luisacomputegaussiansplatting_tpu.apps import train_cli as jcli
from luisacomputegaussiansplatting_tpu.models import trainer as jtrainer
from luisacomputegaussiansplatting_tpu_torch.apps import train_cli as pcli
from luisacomputegaussiansplatting_tpu_torch.io.ply import _read_vertex_table

torch.set_num_threads(2)

ARGV = ["--synthetic-gt", "300", "--views", "2", "--res", "48x32",
        "--iters", "12", "--sh-upgrade-every", "4", "--densify-interval",
        "1000", "--capacity", "4000", "--max-pairs", "20000",
        "--log-every", "4"]
LOSS_RTOL = 1e-4
PLY_TOL = 1e-4
EXPORT_STEP = 2


def recording(make, losses, export):
    """A step factory whose steps append their loss to ``losses`` and call
    ``export(state, dstate)`` after step EXPORT_STEP."""

    def make_recording(*args, **kw):
        step = make(*args, **kw)

        def recorded(*a):
            out = step(*a)
            losses.append(float(out[2]))
            if len(losses) == EXPORT_STEP:
                export(out[0], out[1])
            return out

        return recorded

    return make_recording


def jax_export(path):
    from luisacomputegaussiansplatting_tpu.io.ply import save_ply
    from luisacomputegaussiansplatting_tpu.models.gaussians import GaussianScene

    def export(state, dstate):
        active = np.asarray(dstate.active)
        save_ply(GaussianScene(*(np.asarray(x)[active]
                                 for x in state.params.activate())), path)

    return export


def port_export(path):
    from luisacomputegaussiansplatting_tpu_torch.io.ply import save_ply
    from luisacomputegaussiansplatting_tpu_torch.models.gaussians import GaussianScene

    def export(state, dstate):
        with torch.no_grad():
            save_ply(GaussianScene(*(x[dstate.active]
                                     for x in state.params.activate())), path)

    return export


def logged(out):
    return [float(x) for x in re.findall(r"\] loss (\S+) ", out)]


def test_train_cli_losses_and_export_match_jax(tmp_path, capsys,
                                               monkeypatch):
    jl, pl = [], []
    jply, pply = tmp_path / "jax.ply", tmp_path / "port.ply"
    monkeypatch.setattr(jtrainer, "make_densify_train_step",
                        recording(jtrainer.make_densify_train_step, jl,
                                  jax_export(jply)))
    assert jcli.main(ARGV + ["--out", str(tmp_path / "jax")]) == 0
    jout = capsys.readouterr().out
    monkeypatch.setattr(pcli, "make_densify_train_step",
                        recording(pcli.make_densify_train_step, pl,
                                  port_export(pply)))
    assert pcli.main(ARGV + ["--device", "cpu",
                             "--out", str(tmp_path / "port")]) == 0
    pout = capsys.readouterr().out

    assert len(pl) == len(jl) == 12
    drift = np.abs(np.array(pl) - np.array(jl)) / np.abs(np.array(jl))
    assert drift.max() <= LOSS_RTOL, drift
    assert len(logged(pout)) == len(logged(jout)) == 3
    np.testing.assert_allclose(logged(pout), logged(jout), rtol=LOSS_RTOL,
                               atol=1e-5)  # printed with 5 decimals

    jcols, jn = _read_vertex_table(str(jply))
    pcols, pn = _read_vertex_table(str(pply))
    assert pn == jn == 2000 and list(pcols) == list(jcols)
    for name, want in jcols.items():
        scale = max(float(np.abs(want).max()), 1e-30)
        assert np.abs(pcols[name] - want).max() <= PLY_TOL * scale, name
    final = "syntheticgt300_trained.ply"
    jfinal, jn = _read_vertex_table(str(tmp_path / "jax" / final))
    pfinal, pn = _read_vertex_table(str(tmp_path / "port" / final))
    assert pn == jn == 2000 and list(pfinal) == list(jfinal)
    assert all(np.isfinite(c).all() for c in pfinal.values())
