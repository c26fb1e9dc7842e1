"""ms a call of the sweep (`program.mcmc_step`, 10 moves over the bf16 tower), by CUDA events over calls in a row on the cell's walkers after the window."""


def read(run):
    if run.parts is None:
        return None
    return run.parts.get("sweep_ms")
