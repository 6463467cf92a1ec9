"""``dense_device_ms`` (layer: operators and dense ops): device ms per
step, in the traced window, of every device operation that is not one of
the program's own kernels (GEMMs, softmax, norms, gathers, elementwise,
the optimizer, copies).  Moves ``epoch_ms``."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return t.device_seconds(run.port_kernels, inside=False) * 1e3 / t.steps
