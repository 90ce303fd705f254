"""frame_p95_ms.render_host: the 95th percentile of every frame's latency
in the untraced window of a host-bound rendering cell, taken as
``render_frame_p95_ms`` is and read per layer, since there the host's speed
spreads it too widely for a bound."""


def read(ctx):
    return ctx.window.get("render_frame_p95_ms")
