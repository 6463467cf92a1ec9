"""``sparse_device_ms`` (layer: kernels): device ms per step, in the
traced window, of the program's own kernels (the ``__global__``
functions of ``src/repro_torch/kernels/csrc``).  Moves ``epoch_ms``."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    ms = t.device_seconds(run.port_kernels, inside=True) * 1e3 / t.steps
    return ms if ms > 0 else None
