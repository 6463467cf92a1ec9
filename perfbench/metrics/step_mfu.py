"""``step_mfu`` (layer: train step): the step's model operations (dense
products forward and backward, two per multiply-add of every sparse
product on the true nonzeros) over ``epoch_ms``, as a share of the peak
of the cell's arithmetic.  Moves ``epoch_ms``."""


def read(run):
    rate = run.counts["flops"] / (run.epoch_ms * 1e-3)
    return 100.0 * rate / run.counts["peak_flops_per_s"]
