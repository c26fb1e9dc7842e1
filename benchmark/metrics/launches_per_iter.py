"""Device kernel launches an iteration in the profiled block (the loop's
launches: the sweep and the training step are bound by them)."""


def read(run):
    if run.summary is None:
        return None
    return run.summary["kernel_launches"] / run.iterations_traced
