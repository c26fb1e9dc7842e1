"""ms an iteration in which the device ran something, in the profiled block:
the device's side of the iteration, steadier than the host's clock."""


def read(run):
    if run.summary is None:
        return None
    return run.summary["per_iteration"]["device_busy_ms"]
