"""The work of a batched training step (``loops/train_b4.py``), in
``gsbench/work.py``'s yardstick: each view renders, takes its loss and
its backward as a single-view step does; the activation of the scene, its
backward and Adam run once a step.

A step's record is {"n": gaussians, "params": parameter elements, "views":
one ``loops/train.py::count_frame`` dict a view}.
"""

from __future__ import annotations

from gsbench import work as W

#: per gaussian, the activation alone (``reference/render.py::activate``:
#: the quaternion's norm and scaling, exp, sigmoid), forward and backward,
#: counted by ``work.count_ops`` as ``OPS_PER_GAUSSIAN`` is, of which it is
#: a part
OPS_PER_ACTIVATION = {"forward": 16, "backward": 34}


def view_ops(v: dict) -> float:
    """FP32 operations of one view of a batched step: a single-view step's
    without Adam and without the activation and its backward."""
    return (W.step_ops(v["n"], 0, v["pixels"], v["evaluated"], v["applied"],
                       v["aabb"], v["entries"], v["quad"], v["cull"])
            - v["n"] * (OPS_PER_ACTIVATION["forward"]
                        + OPS_PER_ACTIVATION["backward"]))


def step_ops(step: dict) -> float:
    """FP32 operations of a batched step: every view's, then the
    activation, its backward and Adam over every parameter element once."""
    return (sum(view_ops(v) for v in step["views"])
            + step["n"] * (OPS_PER_ACTIVATION["forward"]
                           + OPS_PER_ACTIVATION["backward"])
            + step["params"] * W.OPS_PER_ADAM_ELEMENT)
