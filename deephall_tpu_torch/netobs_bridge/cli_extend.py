"""The netobs CLI plugin map of the port (``deephall_tpu/netobs_bridge/cli_extend.py``)."""

expansions = {
    "estimator": {"deephall_torch@": "deephall_tpu_torch.netobs_bridge.observables."},
    "adaptor": {"deephall_torch": "deephall_tpu_torch.netobs_bridge.adaptor"},
}
