"""The fractional quantum Hall system type for netobs (``deephall_tpu/netobs_bridge/hall_system.py``)."""

from netobs.systems.elec_gas import ElectronGas


class HallSystem(ElectronGas):
    flux: int
