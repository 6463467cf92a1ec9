"""``device_idle`` (layer: device): 1 - device busy / wall over the traced
window, in %, as ``chip_smoke.profile_run`` computes it.  Moves
``epoch_ms``."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
