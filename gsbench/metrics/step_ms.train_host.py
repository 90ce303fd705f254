"""step_ms.train_host: milliseconds per training step in a host-bound
training cell, taken as ``train_step_ms`` is (the whole untraced window over
the steps completed in it) and read per layer, since there the host's speed
spreads it too widely for a bound."""


def read(ctx):
    return ctx.window.get("train_step_ms")
