"""Render configuration and pipeline constants (PyTorch port).

Field for field the same dataclass as ``luisacomputegaussiansplatting_tpu``'s
``RenderConfig``: the same names, the same defaults, the same meaning, so a
configuration written for one package renders the same frame in the other.
The enum fields are checked when the object is built.

Fields that pick a TPU-only mechanism are kept for parity and read as:

- ``rasterizer="pallas"`` and ``expansion="auto"``/``"pallas"``: the
  hand-written CUDA kernel for tensors on the GPU (the plain PyTorch
  version for tensors on the CPU). ``rasterizer="jnp"`` and
  ``expansion="xla"`` select the plain version on every device; they are
  debug knobs and never a default.
- ``interpret``: ignored (there is no interpret mode for a CUDA kernel).
- ``grad_reduce_dtype``: the backward's per-gaussian reduction of the
  payload gradients (``ops/segsum.py``) adds f32 rows, or rows rounded to
  bf16 with "bf16"; the sums are f32 either way.
- ``grad_reduce_method``: accepted and checked; "ride" and "rowgather" only
  choose how ``lax.sort`` moves operands on a TPU, so both run one path.
"""

from __future__ import annotations

import dataclasses

#: tile edge in pixels (reference lcgs/include/lcgs/module.h:17, 16x16 blocks)
TILE = 16

#: entries per packing chunk: every tile's range in the "chunk" pack mode
#: starts at a multiple of CHUNK and is padded to one (entry streams stay
#: comparable slot for slot with the JAX package)
CHUNK = 128

#: blend_quad="mxu": an entry is kept while power <= POWER_GUARD, i.e.
#: power' <= ln(opacity) + POWER_GUARD for the ln-opacity-folded power'
#: (JAX package ops/rasterize_pallas.py:162-167); the guard keeps splat
#: centres, where power == 0, on the include side of the polynomial's
#: rounding
POWER_GUARD = 1e-3

_ENUMS = {
    "rect_mode": ("inria", "lcgs"),
    "pack_mode": ("chunk", "none"),
    "rasterizer": ("pallas", "jnp"),
    "expansion": ("auto", "pallas", "xla"),
    "grad_reduce_dtype": ("f32", "bf16"),
    "grad_reduce_method": ("ride", "rowgather"),
    "sort_mode": ("2key", "fused"),
    "payload_dtype": ("f32", "bf16"),
    "blend_quad": ("vpu", "mxu"),
}


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of the splatting pipeline.

    See the JAX package's ``config.py`` for the reference citation of every
    constant; the values here are identical.
    """

    near: float = 0.2
    lowpass: float = 0.3
    radius_sigma: float = 3.0
    alpha_max: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_eps: float = 1e-4
    frustum_clamp: float = 1.3
    w_eps: float = 1e-6
    det_eps: float = 1e-6
    znear: float = 0.1
    zfar: float = 100.0
    #: focal-scaled EWA Jacobian (True) or the unit-focal, rescale-later
    #: variant with the reference's H*W/4 cov.z factor (False)
    use_focal: bool = True
    #: tile width in pixels (16 = the reference's binning)
    tile: int = 16
    #: tile height (None = square)
    tile_h: int | None = None
    #: "inria" clamps the exclusive tile-rect max to the grid, "lcgs" to
    #: grid - 1 (reference lcgs/src/module.cpp:33-35)
    rect_mode: str = "inria"
    #: expansion slots before per-tile CHUNK padding
    max_pairs: int = 2_000_000
    #: optional smaller capacity for the sorted stream; cutting a valid
    #: entry raises the overflow flag
    max_pairs_sorted: int | None = None
    #: exact ellipse-tile cull inside the expansion
    tile_cull: bool = False
    #: "chunk" pads every tile's range to CHUNK; "none" keeps raw ranges
    pack_mode: str = "chunk"
    rasterizer: str = "pallas"
    expansion: str = "auto"
    grad_reduce_dtype: str = "f32"
    grad_reduce_method: str = "ride"
    #: shrink radii to the exact alpha_min reach
    tight_radius: bool = False
    #: "2key" = stable (tile, depth) order; "fused" = one quantised key
    sort_mode: str = "2key"
    #: "bf16" rounds opacity and rgb to bf16 in the payload
    payload_dtype: str = "f32"
    #: "vpu" = the conic quadratic per (entry, pixel), kept while power <= 0;
    #: "mxu" = power' = power + ln(opacity) as a tile-local pixel polynomial
    #: with per-entry coefficients, alpha = exp(power'), kept while
    #: power' <= ln(opacity) + POWER_GUARD (results differ from "vpu" by
    #: rounding and the guard band)
    blend_quad: str = "vpu"
    #: ignored; kept so the field lists of both packages agree
    interpret: bool | None = None

    def __post_init__(self):
        for name, allowed in _ENUMS.items():
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(
                    f"unknown {name}: {value!r} (expected one of {allowed})"
                )

    @property
    def tile_wh(self) -> tuple:
        """(tile width, tile height) in pixels."""
        return self.tile, self.tile_h if self.tile_h else self.tile

    def pairs_capacity(self, num_tiles: int) -> int:
        """Entry capacity of the "chunk" pack mode: every tile's range
        padded to a multiple of CHUNK."""
        return self.max_pairs + num_tiles * CHUNK
