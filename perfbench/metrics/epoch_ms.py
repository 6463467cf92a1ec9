"""``epoch_ms``: the timed window's wall time on the host's clock, from
its start to the synchronise after its last step, over the steps it
completed.  Full-graph training: one step is one epoch."""


def read(run):
    return run.epoch_ms
