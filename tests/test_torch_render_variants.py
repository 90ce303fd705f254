"""PyTorch port: the forward render against JAX ``render_aux`` under the
RenderConfig knobs that change which entries exist or how they are packed
(image and T atol 1e-4; radii, num_rendered, overflow exact)."""

import pytest
import torch

from test_torch_render import both, compare

torch.set_num_threads(2)


VARIANTS = [
    dict(tile_cull=True),
    dict(tile=32, pack_mode="none"),
    dict(tile=32, tile_h=16, tight_radius=True),
    dict(sort_mode="fused", payload_dtype="bf16"),
    dict(rect_mode="lcgs", use_focal=False),
    dict(max_pairs_sorted=2_000, tile_cull=True, pack_mode="none"),
    dict(rasterizer="jnp", expansion="xla"),
]


@pytest.mark.parametrize("kw", VARIANTS, ids=[str(v) for v in VARIANTS])
def test_config_variants_match_jax(kw):
    js, ps = both("random_scene", 300, seed=11, scale_range=(0.02, 0.12))
    compare(js, ps, 96, 64, dict(max_pairs=60_000, **kw), bg=(0.2, 0.3, 0.4),
            ewa_mode="lcgs" if kw.get("rect_mode") == "lcgs" else "inria")
