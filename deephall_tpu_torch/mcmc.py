"""Metropolis-Hastings sampling of |psi|^2 on the sphere (port of ``deephall_tpu/mcmc.py``).

All-electron moves from a tangent-plane Gaussian proposal rotated to each
electron, accepted on ``2 Re log psi`` ratios.  The draws come from an explicit
``torch.Generator``; :func:`sph_sampling` and :func:`mh_update` also take the
draws as arguments, so a test can feed both packages the same numbers.

Over several ranks (:mod:`deephall_tpu_torch.parallel`) ``data`` is this
rank's shard: every rank draws the numbers of the whole batch from the same
generator state and keeps its own rows, and the acceptance is the mean over
every walker, so the chain does not depend on the number of ranks.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import torch

from deephall_tpu_torch import parallel, tracing


def sph_sampling(
    x1: torch.Tensor, stddev, normal: torch.Tensor, uniform: torch.Tensor
) -> torch.Tensor:
    """Propose new positions: polar offset ``arctan(normal * stddev)``, azimuth
    ``2 pi uniform``, rotated from the north pole onto each electron.

    Args:
        x1: current configurations ``[..., N, 2]``.
        stddev: proposal width.
        normal, uniform: draws of shape ``[..., N]``.
    """
    theta, phi = x1[..., 0], x1[..., 1]
    theta_prime = torch.arctan(normal * stddev)
    phi_prime = uniform * 2 * math.pi

    sin_tp = torch.sin(theta_prime)
    xp = sin_tp * torch.cos(phi_prime)
    yp = sin_tp * torch.sin(phi_prime)
    zp = torch.cos(theta_prime)

    # R_z(phi) @ R_y(theta) @ [xp, yp, zp], componentwise.
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    sin_p, cos_p = torch.sin(phi), torch.cos(phi)
    x_rot = cos_t * xp + sin_t * zp
    x2 = cos_p * x_rot - sin_p * yp
    y2 = sin_p * x_rot + cos_p * yp
    z2 = -sin_t * xp + cos_t * zp

    new_theta = torch.arccos(torch.clamp(z2, -1, 1))
    # sign(0) = 0, as in the JAX package.
    new_phi = torch.sign(y2) * torch.arccos(torch.clamp(x2 / torch.sin(new_theta), -1, 1))
    return torch.stack([new_theta, new_phi], dim=-1)


def mh_update(
    f: Callable[[torch.Tensor], torch.Tensor],
    x1: torch.Tensor,
    lp_1: torch.Tensor,
    stddev,
    normal: torch.Tensor,
    uniform: torch.Tensor,
    uniform_accept: torch.Tensor,
):
    """One all-electron move of the whole batch.

    Returns ``(x_new, lp_new, accept_rate)``; ``accept_rate`` is a 0-d tensor,
    the mean over these walkers.
    """
    x2 = sph_sampling(x1, stddev, normal, uniform)
    lp_2 = 2.0 * f(x2).real
    cond = (lp_2 - lp_1) > torch.log(uniform_accept)
    x_new = torch.where(cond[..., None, None], x2, x1)
    lp_new = torch.where(cond, lp_2, lp_1)
    return x_new, lp_new, cond.float().mean()


def make_sweep(batch_network: Callable[[torch.Tensor], torch.Tensor], steps: int = 10):
    """``sweep(data, width, generator) -> (data, accept)``: ``steps`` MH moves
    of this rank's shard, ``accept`` the mean acceptance over the moves and
    the shard's walkers (a 0-d tensor).  No collective: device work only."""

    def sweep(data: torch.Tensor, width, generator: torch.Generator):
        lp = 2.0 * batch_network(data).real
        accepts = torch.zeros((), device=data.device)
        shape = data.shape[:-1]
        for _ in range(steps):
            draws = dict(generator=generator, device=data.device)
            normal = parallel.draw_rows(torch.randn, shape, **draws)
            uniform = parallel.draw_rows(torch.rand, shape, **draws)
            uniform_accept = parallel.draw_rows(torch.rand, lp.shape, **draws)
            data, lp, rate = mh_update(
                batch_network, data, lp, width, normal, uniform, uniform_accept
            )
            accepts = accepts + rate
        return data, accepts / steps

    return sweep


class GraphedSweep:
    """A sweep of :func:`make_sweep`, replayed as one CUDA graph a walker shape.

    The key is the walkers' shape, dtype and device; it holds the graph of
    one generator, the newest.  A run draws from one generator: a call with
    another generator at a key's shape drops the key's graph, with its
    memory, and starts over.  A key's first call with a generator runs the
    sweep eagerly: the warm-up a capture needs (it makes ``utils.constant``'s
    tensors, the library handles and their workspaces).  The second call
    captures one whole sweep and replays it.  Every later call copies the
    walkers and the width into the graph's inputs, replays, and returns fresh
    tensors, so no replay overwrites a tensor an earlier call returned.

    The generator is registered with its graph
    (``CUDAGraph.register_generator_state``): a replay draws the Philox
    numbers the eager sweep would draw from the generator's state, and
    advances the state as far, so replayed and eager calls make one chain.

    The graph reads the network's parameters where they lie.  It relies on
    every change to them being made in place (KFAC's and Adam's ``p.sub_``,
    ``weights.load_flax``'s ``copy_``) and on no parameter being moved to new
    memory after the capture.  Walkers on the CPU run the sweep itself.  Each
    call counts in the open block record (:func:`tracing.count`) as
    ``sweep.replayed``, ``sweep.captured`` or ``sweep.eager``.

    Memory: a graph keeps its own pool for as long as it lives, shared with
    no eager work: one sweep's intermediates.  Every capture on a device runs
    on one side stream, whose cuBLAS workspace (32 MiB on Hopper) cuBLAS
    keeps for the life of the process.  ``torch.cuda.max_memory_allocated``
    counts that workspace, and not the pool once the capture is done;
    ``torch.cuda.memory_reserved`` counts both.
    """

    def __init__(self, sweep: Callable):
        self.sweep = sweep
        # (shape, dtype, device) -> (generator, None before the capture, or
        # (graph, (data, width) in, (data, accept) out))
        self.graphs: dict = {}

    def __call__(self, data: torch.Tensor, width, generator: torch.Generator):
        key = (tuple(data.shape), data.dtype, data.device)
        entry = self.graphs.get(key)
        if data.device.type != "cuda" or entry is None or entry[0] is not generator:
            if data.device.type == "cuda":
                self.graphs[key] = (generator, None)
            tracing.count("sweep.eager")
            return self.sweep(data, width, generator)
        if entry[1] is None:
            tracing.count("sweep.captured")
            entry = self.graphs[key] = (generator, self._capture(data, generator))
        else:
            tracing.count("sweep.replayed")
        graph, (data_in, width_in), (data_out, accept) = entry[1]
        data_in.copy_(data)
        width_in.fill_(width)  # a float or a 0-d tensor, copied on the device
        graph.replay()
        return data_out.clone(), accept.clone()

    def _capture(self, data: torch.Tensor, generator: torch.Generator):
        inputs = (torch.empty_like(data), torch.empty((), device=data.device))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        # capture_begin and capture_end, not torch.cuda.graph, which empties the
        # allocator's cache first: the eager layers then grow their segments
        # anew around the graph's pool, and on an H100 the benchmark's cells
        # held 0.75-2.0 GB more reserved memory.
        stream = _CAPTURE_STREAMS.get(data.device)
        if stream is None:
            stream = _CAPTURE_STREAMS[data.device] = torch.cuda.Stream(data.device)
        stream.wait_stream(torch.cuda.current_stream(data.device))
        with torch.no_grad(), torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                outputs = self.sweep(*inputs, generator)
            finally:
                graph.capture_end()
        return graph, inputs, outputs


_CAPTURE_STREAMS: dict = {}  # device -> the side stream of every capture there


def make_mcmc_step(
    batch_network: Callable[[torch.Tensor], torch.Tensor], steps: int = 10, graphed: bool = False
):
    """``mcmc_step(data, width, generator) -> (data, pmove)``: ``steps`` MH moves.

    ``pmove`` is the mean acceptance over the moves and over every rank's
    walkers (a 0-d tensor on the device, one collective a sweep, run eagerly).
    ``data`` is this rank's shard; the draws are those of the global batch.
    ``graphed`` replays the shard's sweep as CUDA graphs (:class:`GraphedSweep`),
    for a network whose parameters change only in place.
    """
    sweep = make_sweep(batch_network, steps)
    if graphed:
        sweep = GraphedSweep(sweep)

    def mcmc_step(data: torch.Tensor, width, generator: torch.Generator):
        data, accept = sweep(data, width, generator)
        return data, parallel.all_reduce_mean(accept)

    return mcmc_step


def adapt_width(
    t: torch.Tensor, width: torch.Tensor, pmoves: torch.Tensor, pmove: torch.Tensor,
    adapt_frequency: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Adaptive proposal width on the device: ``(width, pmoves)`` after iteration ``t``.

    ``pmove`` goes into slot ``t % adapt_frequency`` of the acceptance ring
    ``pmoves``; every ``adapt_frequency`` iterations (``t > 0``) the float32
    width grows by 1.1 when the ring's mean is above 0.55 and shrinks by 1.1
    when it is below 0.5, as the body of ``deephall_tpu/train.py:
    make_iteration_block`` does.  Only tensor operations: nothing is read back.
    """
    idx = t % adapt_frequency
    slots = torch.arange(adapt_frequency, device=pmoves.device)
    pmoves = torch.where(slots == idx, pmove.to(pmoves.dtype), pmoves)
    do_update = (t > 0) & (idx == 0)
    mean = pmoves.mean()
    width = torch.where(do_update & (mean > 0.55), width * 1.1, width)
    width = torch.where(do_update & (mean < 0.5), width / 1.1, width)
    return width, pmoves
