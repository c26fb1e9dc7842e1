"""The orbital jet's share of its bound, in %: the least time of its
necessary work in one local energy (:func:`benchmark.work.orbitals.orbital_jet_least`,
from the configuration's sizes) over ``orbital_jet_span_ms``, the span
``orbitals`` an iteration; ``None`` on a program without the span.  The span
runs several library kernels, so the share is the layer's, not a kernel's
roofline."""

from benchmark.harness import spans
from benchmark.work import kernels, orbitals


def read(run):
    ms = spans.read_span(run, "orbitals")
    if not ms:
        return None
    cfg = run.cfg
    net = cfg.network.psiformer
    nelec = sum(cfg.system.nspins)
    c, e = kernels.jet_channels(nelec, bool(cfg.system.compute_l2 or cfg.system.l2_penalty))
    least = orbitals.orbital_jet_least(cfg.batch_size, nelec, cfg.system.flux,
                                       net.num_heads * net.heads_dim, net.determinants, c, e)
    return 100 * least.seconds * 1e3 / ms
