"""PyTorch port: RenderConfig parity with the JAX package, enum checks, and
the port's independence from jax."""

import dataclasses
import os
import re
import subprocess
import sys

import pytest
import torch

from luisacomputegaussiansplatting_tpu import config as jcfg
from luisacomputegaussiansplatting_tpu_torch import config as pcfg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "luisacomputegaussiansplatting_tpu_torch")


def test_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.RenderConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pcfg.RenderConfig)]
    assert pf == jf
    assert (pcfg.TILE, pcfg.CHUNK) == (jcfg.TILE, jcfg.CHUNK)


@pytest.mark.parametrize("kw", [
    {}, {"tile": 32}, {"tile": 32, "tile_h": 16}, {"max_pairs": 1234},
])
def test_derived_properties_match_jax(kw):
    j, p = jcfg.RenderConfig(**kw), pcfg.RenderConfig(**kw)
    assert p.tile_wh == j.tile_wh
    assert p.pairs_capacity(77) == j.pairs_capacity(77)


@pytest.mark.parametrize("field", [
    "rect_mode", "pack_mode", "rasterizer", "expansion", "grad_reduce_dtype",
    "grad_reduce_method", "sort_mode", "payload_dtype", "blend_quad",
])
def test_bad_enum_value_raises(field):
    with pytest.raises(ValueError, match=field):
        pcfg.RenderConfig(**{field: "bogus"})
    # every value the JAX package accepts is accepted here
    default = getattr(jcfg.RenderConfig(), field)
    assert getattr(pcfg.RenderConfig(**{field: default}), field) == default


def test_import_leaves_jax_out():
    code = (
        "import sys, luisacomputegaussiansplatting_tpu_torch, "
        "luisacomputegaussiansplatting_tpu_torch.apps.render_cli, "
        "luisacomputegaussiansplatting_tpu_torch.apps.train_cli, "
        "luisacomputegaussiansplatting_tpu_torch.apps.viewer, "
        "luisacomputegaussiansplatting_tpu_torch.io.dataset, "
        "luisacomputegaussiansplatting_tpu_torch.io.native, "
        "luisacomputegaussiansplatting_tpu_torch.parallel, "
        "luisacomputegaussiansplatting_tpu_torch.parallel.mesh, "
        "luisacomputegaussiansplatting_tpu_torch.parallel.exchange_vjp, "
        "luisacomputegaussiansplatting_tpu_torch.parallel.render_sharded, "
        "luisacomputegaussiansplatting_tpu_torch.parallel.train_sharded, "
        "luisacomputegaussiansplatting_tpu_torch.scripts.real_scene_proof, "
        "luisacomputegaussiansplatting_tpu_torch.utils.packing; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('luisacomputegaussiansplatting_tpu.') "
        "or m == 'luisacomputegaussiansplatting_tpu']; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)


def test_no_port_source_imports_jax():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax\b|luisacomputegaussiansplatting_tpu\b(?!_torch))",
        re.M)
    sources = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
               if f.endswith(".py")]
    sources.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(sources) > 15
    for path in sources:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_native_build_writes_nothing_under_native(tmp_path, monkeypatch):
    """``io/native.py`` compiles ``native/*.cpp`` into its build directory
    and leaves ``native/`` as it found it."""
    from luisacomputegaussiansplatting_tpu_torch.io import native

    def listing():
        d = native.NATIVE_DIR
        return sorted((f, os.stat(os.path.join(d, f)).st_mtime_ns)
                      for f in os.listdir(d))

    before = listing()
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    assert native.build_native()
    built = sorted(os.listdir(tmp_path / "native"))
    assert [f.rsplit("-", 1)[0] for f in built] == ["ply_loader", "png_writer"]
    assert all(f.endswith(".so") for f in built)
    assert listing() == before
