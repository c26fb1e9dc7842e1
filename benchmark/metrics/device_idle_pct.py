"""The device's idle share of the profiled block: the span from its first
host event to its last device event less the union of its kernels, copies
and sets (:mod:`benchmark.harness.trace`)."""


def read(run):
    if run.summary is None:
        return None
    return 100 * run.summary["idle_share"]
