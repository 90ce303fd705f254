"""What the benchmark makes from ``--seed`` and hands to both sides: the
scene's raw parameters, the training targets, the cameras of the dataset
and of a render path. Everything is drawn on the device by a seeded
``torch.Generator`` in a few large calls; the same seed gives the same
tensors.

The scene's distributions are ``random_scene_device``'s (uniform means in
[-extent, extent]^3, log-uniform scales, normal quaternions normalised,
uniform opacities, a uniform base colour as the SH DC term, normal higher
SH terms), frozen here as raw (pre-activation) parameters.
"""

from __future__ import annotations

import hashlib
import math
import random

import torch

from .reference.render import SH_C0, View, look_at

def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed of its own for each thing drawn from ``seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw_params(sc: dict, seed: int, device):
    """Raw parameters, in the order of the trainable groups: (N, 3) means,
    (N, 3) log-scales, (N, 4) unit quaternions (x, y, z, w), (N,) opacity
    logits, (N, 1, 3) SH DC, (N, K - 1, 3) higher SH."""
    n = sc["n_gaussians"]
    k = (sc["sh_degree"] + 1) ** 2
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "scene"))
    u = torch.rand((n, 10), generator=gen, device=device)
    z = torch.randn((n, 4 + (k - 1) * 3), generator=gen, device=device)
    ext = sc["extent"]
    lo, hi = math.log(sc["scale_min"]), math.log(sc["scale_max"])
    means = u[:, 0:3] * (2 * ext) - ext
    log_scales = u[:, 3:6] * (hi - lo) + lo
    quats = z[:, 0:4] / torch.linalg.norm(z[:, 0:4], dim=1, keepdim=True)
    op = u[:, 6] * (sc["opacity_max"] - sc["opacity_min"]) + sc["opacity_min"]
    logits = torch.log(op) - torch.log1p(-op)
    sh_dc = ((u[:, 7:10] * 0.9 + 0.05 - 0.5) / SH_C0)[:, None, :]
    sh_rest = (z[:, 4:] * sc["sh_rest_std"]).reshape(n, k - 1, 3)
    return tuple(t.contiguous() for t in
                 (means, log_scales, quats, logits, sh_dc, sh_rest))


def draw_targets(n_views: int, width: int, height: int, seed: int, device,
                 chunk: int = 16):
    """(V, 3, H, W) float32 training targets in [0, 1]: smooth colour
    fields, uniform noise at 1/16 of the resolution upsampled bilinearly."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "targets"))
    out = torch.empty((n_views, 3, height, width), device=device)
    coarse = torch.rand((n_views, 3, height // 16 + 2, width // 16 + 2),
                        generator=gen, device=device)
    for i in range(0, n_views, chunk):
        out[i:i + chunk] = torch.nn.functional.interpolate(
            coarse[i:i + chunk], size=(height, width), mode="bilinear",
            align_corners=False)
    return out


def _orbit_position(ds: dict, azimuth_deg: float):
    a = math.radians(azimuth_deg)
    return (ds["radius"] * math.cos(a), ds["radius"] * math.sin(a),
            ds["height_z"])


def _sphere_position(radius: float, azimuth_deg: float, elevation_deg: float):
    a, e = math.radians(azimuth_deg), math.radians(elevation_deg)
    return (radius * math.cos(e) * math.cos(a),
            radius * math.cos(e) * math.sin(a), radius * math.sin(e))


def _camera(ds: dict, position, width, height, device) -> View:
    return look_at(position, ds["target"], ds["up"], ds["fov_y_deg"], width,
                   height, device)


def train_views(ds: dict, device):
    """The dataset's training cameras at its resolution.

    "orbit": ``images`` cameras evenly round the orbit from
    ``azimuth0_deg``, every ``holdout_every``-th held out (3DGS's split).
    "hemisphere": ``images`` cameras on the upper hemisphere of
    ``radius`` by the Fibonacci lattice, elevations in
    [``elevation_min_deg``, ``elevation_max_deg``].
    """
    w, h = ds["width"], ds["height"]
    if ds["kind"] == "orbit":
        n = ds["images"]
        keep = [i for i in range(n) if i % ds["holdout_every"]]
        return [_camera(ds, _orbit_position(ds, ds["azimuth0_deg"]
                                            + 360.0 * i / n), w, h, device)
                for i in keep]
    if ds["kind"] == "hemisphere":
        n = ds["images"]
        lo = math.sin(math.radians(ds["elevation_min_deg"]))
        hi = math.sin(math.radians(ds["elevation_max_deg"]))
        golden = math.pi * (3.0 - math.sqrt(5.0))
        out = []
        for i in range(n):
            s = lo + (hi - lo) * (i + 0.5) / n
            out.append(_camera(ds, _sphere_position(
                ds["radius"], math.degrees(golden * i) % 360.0,
                math.degrees(math.asin(s))), w, h, device))
        return out
    raise ValueError(f"unknown dataset kind {ds['kind']!r}")


def view_stream(n_views: int, seed: int):
    """View indices without end: seeded shuffles of all views, one after
    another (a fresh shuffle when the last is used up, as graphdeco's
    trainer refills its stack)."""
    rng = random.Random(sub_seed(seed, "order"))
    while True:
        perm = list(range(n_views))
        rng.shuffle(perm)
        yield from perm


class RenderPath:
    """A render path of 360 poses, one degree of azimuth apart, walked from
    a seeded start: every seed visits the same poses in another order.

    "orbit": the dataset's orbit. "hemisphere": the dataset's hemisphere
    radius, the elevation swinging between ``elevation_min_deg`` and
    ``elevation_max_deg`` ``elevation_cycles`` times a turn.
    """

    POSES = 360

    def __init__(self, ds: dict, tr: dict, seed: int, device):
        self.ds, self.tr = ds, tr
        self.start = random.Random(sub_seed(seed, "path")).randrange(self.POSES)
        self.width, self.height = tr["width"], tr["height"]
        self.views = [_camera(ds, self.position(a), self.width, self.height,
                              device) for a in range(self.POSES)]

    def index(self, k: int) -> int:
        """The pose of frame k."""
        return (self.start + k) % self.POSES

    def position(self, a: int):
        if self.tr["path"] == "orbit":
            return _orbit_position(self.ds, self.ds["azimuth0_deg"] + a)
        if self.tr["path"] == "hemisphere":
            lo, hi = self.tr["elevation_min_deg"], self.tr["elevation_max_deg"]
            s = math.sin(2 * math.pi * a * self.tr["elevation_cycles"]
                         / self.POSES)
            return _sphere_position(self.ds["radius"], float(a),
                                    lo + (hi - lo) * 0.5 * (1.0 + s))
        raise ValueError(f"unknown path {self.tr['path']!r}")
