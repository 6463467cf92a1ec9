"""``setup_s``: from the process's start to the first timed step: imports,
the kernels' build or load, the graph's generation or cache load,
``from_coo``, ``ad_plan``, the inputs, the checked and warm-up steps."""


def read(run):
    return run.setup_s
