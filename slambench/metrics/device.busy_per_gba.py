"""device.busy_per_gba (device): the seconds in which an operation ran on
the device per global BA in the traced window: `gba_s` without the host's
share, steadier than it where the host paces the issue."""


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("n_traced", 0)
    if tr is None or n <= 0 or tr.busy_s <= 0:
        return None
    return tr.busy_s / n
