"""``sparse_roofline`` (layer: kernels): the least time of the step's
sparse products (``perfbench.counts``: each the larger of its bytes over
3.35 TB/s and its operations over the peak) over ``sparse_device_ms``,
in %.  Moves ``epoch_ms``."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    ms = t.device_seconds(run.port_kernels, inside=True) * 1e3 / t.steps
    if ms <= 0:
        return None
    return 100.0 * run.counts["sparse_least_ms"] / ms
