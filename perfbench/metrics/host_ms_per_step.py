"""``host_ms_per_step`` (layer: host and dispatch): the host's time to
issue one step that finds the device idle (a synchronise before each
probed step), averaged: the Python loop of the model, autodiff, the
dispatch and the kernels' wrappers.  Moves ``epoch_ms`` where the host
paces the device."""

import statistics


def read(run):
    if not run.host_step_ms:
        return None
    return statistics.fmean(run.host_step_ms)
