"""The jet LayerNorms' share of their byte bound: the least time of an
iteration's calls (two a layer of the local energy, each with its residual,
:func:`benchmark.work.kernels.layernorm_least`) over the device time of the
``jet_layernorm*`` kernels an iteration in the profiled block."""

from benchmark.work import kernels


def read(run):
    if run.summary is None:
        return None
    ms = sum(v for k, v in run.summary["ms_by_name"].items() if "jet_layernorm" in k) / run.iterations_traced
    if ms <= 0:
        return None
    cfg = run.cfg
    net = cfg.network.psiformer
    c, e = kernels.jet_channels(sum(cfg.system.nspins), bool(cfg.system.compute_l2 or cfg.system.l2_penalty))
    least = kernels.layernorm_least(cfg.batch_size, sum(cfg.system.nspins), net.num_heads * net.heads_dim,
                                    c, e, residual=True)
    return 100 * 2 * net.num_layers * least.seconds * 1e3 / ms
