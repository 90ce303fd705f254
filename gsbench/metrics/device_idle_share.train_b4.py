"""device_idle_share.train_b4: the share (%) of the traced window of batched
training steps in which no kernel, copy or fill runs on the card (one
minus the union of device activity over the window)."""

LOOP = "train_b4"


def read(ctx):
    if ctx.loop != LOOP or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
