"""netobs bridge of the PyTorch port (port of ``deephall_tpu/netobs_bridge``).

A ``NetworkAdaptor`` restoring runs from ``config.yml`` and a checkpoint, the
``HallSystem`` system type, and estimators for the density, the pair
correlation, the 1-RDM and the Laughlin overlap, registered under the
``netobs.cli.expansions`` entry point as ``deephall_torch`` (``pyproject.toml``).

netobs's adaptor contract is JAX's: it ``jit``s and ``vmap``s the adaptor's
methods and hands them PRNG keys.  This adaptor keeps the method names and the
value contract with torch tensors in and out, on the adaptor's device:
``params`` is the restored module's ``state_dict()`` and a key is a
``torch.Generator``.  Nothing is registered as a pytree.

The external ``netobs`` package is not vendored; importing this package
without it raises.  The same observables are available without netobs
through ``deephall_tpu_torch.observables``.
"""

try:
    import netobs  # noqa: F401
except ImportError as e:  # pragma: no cover - depends on an optional package
    raise ImportError(
        "deephall_tpu_torch.netobs_bridge requires the external 'netobs' package. "
        "Install netobs, or use the built-in runner: "
        "python -m deephall_tpu_torch.observables.runner CKPT --estimator <name>"
    ) from e
