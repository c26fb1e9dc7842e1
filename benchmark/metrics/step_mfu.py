"""The whole step's share of the H100's peak: the least time of one
iteration's operations at their classes' peaks (counted on the CPU,
``benchmark/work/counts/<config>/<traffic>.json``) over the traced run's
own iteration time in its window, which is not profiled."""


def read(run):
    if run.work is None or run.summary is None:
        return None
    return 100 * run.work["operations_ms"] / run.iteration_ms
