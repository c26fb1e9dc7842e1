"""ms a call of the KFAC update (`kfac.kfac_update`, on copies of the parameters), by CUDA events over calls in a row on the cell's walkers after the window."""


def read(run):
    if run.parts is None:
        return None
    return run.parts.get("kfac_update_ms")
