"""ms a call of the float32 forward with its two backward passes (`loss.gradient_and_capture`), by CUDA events over calls in a row on the cell's walkers after the window."""


def read(run):
    if run.parts is None:
        return None
    return run.parts.get("grad_ms")
