"""frame_ms.render_host: milliseconds per delivered frame in a host-bound
rendering cell, taken as ``render_frame_ms`` is (the whole untraced window
over the frames delivered in it) and read per layer, since there the host's
speed spreads it too widely for a bound."""


def read(ctx):
    return ctx.window.get("render_frame_ms")
