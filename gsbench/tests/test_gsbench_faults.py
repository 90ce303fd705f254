"""The check fails what it must: the control (the reference in bfloat16 in
the program's place) and, with the program broken underneath a whole run,
each fault the cell can have (a step that leaves the state unchanged, half
of the image left out of the loss, an answer altered where it is
produced)."""

import pytest
import torch

from conftest import CELLS, TINY
from gsbench import harness
from luisacomputegaussiansplatting_tpu_torch.apps.viewer import ViewerServer
from luisacomputegaussiansplatting_tpu_torch.models import trainer

CPU = torch.device("cpu")


def _failing(cell, numbers):
    limits = cell.spec["limits"]
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    cell = harness.make_cell(name, 2**32 + 5, CPU, TINY)
    loop = harness.load_module("loops", cell.traffic["loop"])
    state = loop.setup(cell)
    if cell.traffic["loop"] == "render":
        loop.window(state, 0.3)
    records = loop.release(state)
    ref = loop.reference(cell, records)
    assert not _failing(cell, loop.compare(records, ref))
    control = loop.reference(cell, records, "bf16")
    assert _failing(cell, loop.compare(control, ref))


def _run(name):
    cell = harness.make_cell(name, 2**32 + 6, CPU, TINY)
    return harness.run_cell(cell, 0.3, False, 0.0)


@pytest.mark.parametrize("name", ["bicycle-train", "lego-train"])
def test_a_step_that_leaves_the_state_unchanged_fails(name, monkeypatch):
    monkeypatch.setattr(trainer, "optimizer_step", lambda *a, **k: None)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] > \
        out["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("name", ["bicycle-train", "lego-train"])
def test_half_the_image_left_out_of_the_loss_fails(name, monkeypatch):
    loss = trainer.d_ssim_l1_loss

    def half(pred, target, w=0.2):
        rows = pred.shape[1] // 2
        return loss(pred[:, :rows], target[:, :rows], w)

    monkeypatch.setattr(trainer, "d_ssim_l1_loss", half)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", ["bicycle-render-1080p", "lego-render-800"])
def test_an_altered_image_fails(name, monkeypatch):
    deliver = ViewerServer.frame_to_hwc

    def altered(img):
        hwc = deliver(img)
        hwc[hwc.shape[0] // 2, hwc.shape[1] // 2, 1] ^= 0x40
        return hwc

    monkeypatch.setattr(ViewerServer, "frame_to_hwc", staticmethod(altered))
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["image_level_gap"]["value"] >= 64
