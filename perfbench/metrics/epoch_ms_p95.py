"""``epoch_ms_p95`` (layer: train step): the 95th percentile of the
device's time between the CUDA events recorded between consecutive
steps, over every step of the timed window.  It catches the stalls a
mean hides; it moves with the host's speed from machine to machine more
than ``epoch_ms`` does, so it is read in the traced run, with no bound.
Moves ``epoch_ms``."""

import statistics


def read(run):
    gaps = run.step_gaps_ms
    if len(gaps) < 2:
        return None
    return statistics.quantiles(gaps, n=100, method="inclusive")[94]
