"""ms a call of the local energy (`loss.batched_local_energy`: the jet through the hand-written kernels), by CUDA events over calls in a row on the cell's walkers after the window."""


def read(run):
    if run.parts is None:
        return None
    return run.parts.get("local_energy_ms")
