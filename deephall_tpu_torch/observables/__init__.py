"""Evaluation of stored runs (port of ``deephall_tpu/observables``): ``runner.load_run`` only."""
