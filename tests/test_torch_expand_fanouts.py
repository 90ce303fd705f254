"""PyTorch port: the expansion on adversarial fan-outs, and its prefix
sums, against the JAX package, slot for slot.

The scenes are ``chip_smoke.adversarial_fanouts`` (the builder the card's
run holds the CUDA expansion to) on a 20x15-tile grid, as projected
gaussians given directly: gaussians with no tile at both ends and in runs,
one gaussian over every tile, ``max_pairs`` inside a rect row, an AABB total
past 2^31 - 1, and no tile at all. The JAX side runs ``expand_entries_auto``
as its own tests do on the CPU (the Pallas kernel in interpret mode).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from luisacomputegaussiansplatting_tpu.ops import binning as jb
from luisacomputegaussiansplatting_tpu_torch.ops import binning as pb
from luisacomputegaussiansplatting_tpu_torch.ops import expand as pe
from luisacomputegaussiansplatting_tpu_torch.ops.projection import ProjectedGaussians

torch.set_num_threads(2)


def assert_same(p, j, what=""):
    np.testing.assert_array_equal(p.numpy(), np.asarray(j), err_msg=what)


@functools.lru_cache(maxsize=None)
def adversarial_cases():
    """``chip_smoke.adversarial_fanouts`` on a 20x15-tile grid (the same
    builder the card's run uses at 120x68)."""
    from chip_smoke import adversarial_fanouts

    return list(adversarial_fanouts(20, 15, n=300))


ADVERSARIAL_GRID = (20, 15)


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("cull", [False, True])
def test_expansion_adversarial_fanouts_match_jax(case, cull):
    """Empty gaussians at both ends and in runs, one gaussian over every
    tile, max_pairs inside a rect row, a saturated total, no tile at all:
    the plain expansion and the kernel wrapper (its plain version on the
    CPU) against the JAX expansion, slot for slot."""
    tag, fields, max_pairs = adversarial_cases()[case]
    gx, gy = ADVERSARIAL_GRID
    jproj = jb.ProjectedGaussians(*(jnp.asarray(f) for f in fields[:8]))
    pproj = ProjectedGaussians(*(torch.from_numpy(f) for f in fields[:8]))
    jop = jnp.asarray(fields[8]) if cull else None
    pop = torch.from_numpy(fields[8]) if cull else None
    j = jax.jit(lambda pr, o: jb.expand_entries_auto(
        pr, gx, gx * gy, max_pairs, o, 16, 1.0 / 255.0, "auto"))(jproj, jop)
    for p in (pb.expand_entries(pproj, gx, gx * gy, max_pairs, pop, 16),
              pe.expand_entries_kernel(pproj, gx, gx * gy, max_pairs, pop,
                                       16)):
        for name, a, b in zip(("tile", "depth", "gid", "total"), p, j):
            assert_same(a, b, f"{tag}: {name}")
    total = int(fields[6].astype(np.int64).sum())
    assert int(j[3]) == min(total, 2**31 - 1), tag


INT32_MAX = 2**31 - 1


@pytest.mark.parametrize("counts,total", [
    ([], 0),
    ([3, 0, 5, 0], 8),
    ([2**30, 2**30 - 200], 2**31 - 200),  # the f32 sum stays under 2^31 - 1
    ([2**30, 2**30 - 40], INT32_MAX),  # the f32 sum rounds to 2^31: pinned
    ([2**30] * 3, INT32_MAX),  # past int32: pinned
])
def test_prefix_sums_saturate_like_jax(counts, total):
    """The expansion's prefix sums (``prefix_sums``, which the CUDA kernel
    saturates as ``saturated_ends`` does): the int64 cumsum, the float32
    sum, and the saturated total, pinned where the JAX package's guard
    pins it."""
    c = torch.tensor(counts, dtype=torch.int32)
    _, ends, total_f = pe.prefix_sums(c)
    np.testing.assert_array_equal(ends.numpy(),
                                  np.cumsum(np.array(counts, np.int64)))
    assert float(total_f) == float(np.float32(sum(counts)))
    jc = jnp.asarray(np.array(counts, np.int32))
    j_total = jb._saturate_total(
        jnp.cumsum(jc)[-1] if counts else jnp.int32(0), jc)
    assert int(pe.saturated_ends(c)[1]) == int(j_total) == total


@pytest.mark.parametrize("max_pairs", [-1, INT32_MAX - 31, INT32_MAX])
def test_kernel_launch_rejects_max_pairs_past_int32_slots(max_pairs):
    """The kernel's slots are int32 and a warp steps 32 at a time, so its
    launch takes ``max_pairs`` only up to 2^31 - 33, and says so before it
    looks at the tensors."""
    tag, fields, _ = adversarial_cases()[0]
    proj = ProjectedGaussians(*(torch.from_numpy(f) for f in fields[:8]))
    _, ends, total_f = pe.prefix_sums(proj.tiles_touched)
    gx, gy = ADVERSARIAL_GRID
    with pytest.raises(ValueError, match="max_pairs"):
        pe._launch_expand(ends, total_f, proj, gx, gx * gy, max_pairs, None,
                          16, 1.0 / 255.0)
