"""gs.idle_share: the share of the traced stretch's wall time in which no
operation ran on the device (1 - busy / wall, one stream); nothing where no
operation ran on the device."""


def read(ctx):
    if ctx.get("kind") != "gs" or ctx["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["traced_wall_s"])
