"""PyTorch port: checkpoints (``models/checkpoint.py``) against the JAX
package's npz format.

An npz of ``(GaussianParams, DensifyState, step)`` written by the port is
read by the JAX ``load_npz`` and the reverse, bit for bit. The port's
``CheckpointManager`` keeps ``max_to_keep`` files, skips and removes stale
``ckpt_*.tmp.npz`` writes (as the JAX manager without orbax does,
``tests/test_datasets.py``), and restores the Adam moments it saved.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu.models import checkpoint as jc
from luisacomputegaussiansplatting_tpu.models import densify as jd
from luisacomputegaussiansplatting_tpu.models import gaussians as jg
from luisacomputegaussiansplatting_tpu_torch.models import checkpoint as pc
from luisacomputegaussiansplatting_tpu_torch.models import densify as pd
from luisacomputegaussiansplatting_tpu_torch.models import gaussians as pg
from luisacomputegaussiansplatting_tpu_torch.models import trainer as pt


def arrays(seed, n=12):
    """numpy GaussianParams and DensifyState fields."""
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32)
              for s in ((n, 3), (n, 3), (n, 4), (n,), (n, 1, 3), (n, 15, 3))]
    dstate = [rng.uniform(size=n).astype(np.float32),
              rng.integers(0, 5, n).astype(np.float32),
              rng.integers(0, 9, n).astype(np.int32),
              rng.uniform(size=n) < 0.6]
    return params, dstate


def port_tree(seed, step=7):
    params, dstate = arrays(seed)
    return (pg.params_from_numpy(*params, "cpu"),
            pd.densify_state_from_numpy(*dstate, "cpu"), step)


def jax_tree(seed, step=7):
    params, dstate = arrays(seed)
    return (jg.GaussianParams(*map(jnp.asarray, params)),
            jd.DensifyState(*map(jnp.asarray, dstate)), step)


def leaves(tree):
    params, dstate, step = tree
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in (*params, *dstate)] + [step]


def assert_bit_equal(got, want):
    for a, b in zip(leaves(got), leaves(want), strict=True):
        if isinstance(b, int):
            assert int(a) == b and type(a) is int
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_port_npz_reads_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    pc.save_npz(path, port_tree(1))
    got = jc.load_npz(path, jax_tree(2, step=0))
    got = (got[0], got[1], int(got[2]))
    assert_bit_equal(got, jax_tree(1))


def test_jax_npz_reads_in_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    jc.save_npz(path, jax_tree(3))
    like = port_tree(4, step=0)
    got = pc.load_npz(path, like)
    assert_bit_equal(got, port_tree(3))
    # restored in place: the like's tensors, now holding the file's values
    for a, b in zip((*got[0], *got[1]), (*like[0], *like[1])):
        assert a is b


def test_leaf_order_matches_jax(tmp_path):
    """Dicts by sorted key, None without a leaf, lists and nested tuples
    in order: the same npz keys in both packages."""
    tree = {"b": [np.arange(3.0), None, 4], "a": (np.ones(2, np.int32),),
            "c": {"z": np.float32(2.5), "y": np.zeros((2, 2))}}
    pc.save_npz(str(tmp_path / "p.npz"), tree)
    jc.save_npz(str(tmp_path / "j.npz"), tree)
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert p.files == j.files
        for k in p.files:
            assert p[k].dtype == j[k].dtype
            np.testing.assert_array_equal(p[k], j[k])
    back = pc.load_npz(str(tmp_path / "j.npz"), tree)
    assert list(back) == list(tree) and back["b"][1] is None
    assert back["b"][2] == 4 and back["c"]["z"] == np.float32(2.5)
    with pytest.raises(ValueError, match="leaves"):
        pc.load_npz(str(tmp_path / "j.npz"), {"a": np.zeros(2)})


def test_optimizer_moments_roundtrip(tmp_path):
    """The optimizer's moments and step come back into a fresh optimizer,
    and the next Adam step then equals the one without the round trip."""
    params, _ = arrays(5)
    state, opt = pt.init_train_state(pg.params_from_numpy(*params, "cpu"))
    for step in range(2):
        for p in state.params:
            p.grad = torch.full_like(p, 0.1 * (step + 1))
        pt.optimizer_step(opt, pt.TrainConfig(), step)
    path = str(tmp_path / "opt.npz")
    pc.save_npz(path, (state.params, opt, 2))
    fresh, fopt = pt.init_train_state(pg.params_from_numpy(*arrays(6)[0],
                                                           "cpu"))
    assert not fopt.state
    _, fopt2, step = pc.load_npz(path, (fresh.params, fopt, 0))
    assert fopt2 is fopt and step == 2
    for a, b in zip(fresh.params, state.params):
        assert torch.equal(a, b)
    for a, b in ((state.params, opt), (fresh.params, fopt)):
        for p in a:
            p.grad = torch.full_like(p, -0.2)
        pt.optimizer_step(b, pt.TrainConfig(), 2)
    for a, b in zip(fresh.params, state.params):
        assert torch.equal(a, b)
    for p, q in zip(fresh.params, state.params):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(fopt.state[p][key], opt.state[q][key]), key


def test_checkpoint_manager_rolls(tmp_path):
    mgr = pc.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    step, like = mgr.restore_latest(port_tree(0, step=0))
    assert step is None
    for s in (10, 20, 30):
        mgr.save(s, port_tree(s, step=s))
    assert sorted(os.listdir(mgr.directory)) == ["ckpt_00000020.npz",
                                                 "ckpt_00000030.npz"]
    step, got = mgr.restore_latest(port_tree(0, step=0))
    assert step == 30
    assert_bit_equal(got, port_tree(30, step=30))
    assert_bit_equal(mgr.restore(20, port_tree(0, step=0)),
                     port_tree(20, step=20))
    # the JAX manager without orbax reads the same directory
    jmgr = jc.CheckpointManager(mgr.directory, max_to_keep=2,
                                use_orbax=False)
    assert jmgr.latest_step() == 30


def test_checkpoint_stale_tmp_files_ignored(tmp_path):
    """A crash between np.savez and os.replace leaves ckpt_*.tmp.npz: the
    port's manager, like the JAX one without orbax, skips and removes it."""
    for name, make in (("port", pc.CheckpointManager),
                       ("jax", lambda d, max_to_keep: jc.CheckpointManager(
                           d, max_to_keep=max_to_keep, use_orbax=False))):
        mgr = make(str(tmp_path / name), max_to_keep=2)
        mgr.save(10, {"a": np.arange(3.0)})
        stale = os.path.join(mgr.directory, "ckpt_00000020.npz.tmp.npz")
        with open(stale, "wb") as f:
            f.write(b"partial")
        assert mgr.latest_step() == 10, name
        step, restored = mgr.restore_latest({"a": np.zeros(3)})
        assert step == 10, name
        np.testing.assert_array_equal(np.asarray(restored["a"]),
                                      np.arange(3.0))
        assert not os.path.exists(stale), name
