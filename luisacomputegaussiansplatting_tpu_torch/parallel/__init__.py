"""Sharding over ``torch.distributed`` (port of ``parallel/``): the
gaussian-by-tile sharded render and the (data, gs) mesh training step."""

from .mesh import initialize_multihost, make_mesh
from .render_sharded import ShardedRenderConfig, gather_image, render_sharded
from .train_sharded import make_sharded_train_step

__all__ = [
    "initialize_multihost",
    "make_mesh",
    "render_sharded",
    "gather_image",
    "ShardedRenderConfig",
    "make_sharded_train_step",
]
