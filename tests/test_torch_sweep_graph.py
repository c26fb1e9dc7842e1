"""The sweep replayed as CUDA graphs (``mcmc.GraphedSweep``, which
``train.make_program`` builds through ``make_mcmc_step(..., graphed=True)``).

On the CPU: the graphed step is the eager step bit for bit and counts every
call as eager; ``tracing.count`` keeps its counts in the open block record
and drops those made outside a block; the observables runner and the netobs
adaptor build the eager step.

On a card (marked ``cuda``, skipped elsewhere): graphed calls against eager
calls from one generator state, on a tiny network and on the stored N=6 and
N=10 runs at batch 3360; in-place parameter changes seen by the next replay;
one graph a batch shape, of the newest generator; returned tensors untouched
by later replays; one chain whatever the block length; and the memory of a
graphed block against an eager one, allocated and reserved, each in a
process of its own.  Run them on the card with

    python -m pytest tests/test_torch_sweep_graph.py -m cuda
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import types
import weakref
from pathlib import Path
from typing import Any, Generic, TypedDict, TypeVar

import pytest
import torch

from deephall_tpu_torch import config, mcmc, tracing, train
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.observables import runner
from deephall_tpu_torch.types import CheckpointState
from deephall_tpu_torch.weights import init_params

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

# D = 32: the jet LayerNorm kernel takes D % 32 == 0.
RAW = {
    "batch_size": 64,
    "system": {"nspins": [3, 0], "flux": 2},
    "network": {"psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 16}},
    "mcmc": {"steps": 4, "adapt_frequency": 4},
    "optim": {"optimizer": "none"},
}
STEPS = 4


def tiny(device, seed: int = 0, batch: int = 64):
    """``(cfg, model, walkers)``: the tiny Psiformer and fresh walkers on ``device``."""
    cfg = config.Config.from_dict(RAW)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(seed))
    model.to(device).requires_grad_(False)
    walkers = train.init_guess(torch.Generator().manual_seed(seed + 1), batch, 3, "cpu")
    return cfg, model, walkers.to(device)


def generator(device, seed: int = 5) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def chain(step, data, width, gen, calls: int) -> list:
    out = []
    with torch.no_grad():
        for _ in range(calls):
            data, pmove = step(data, width, gen)
            out.append((data, pmove))
    return out


# -- the CPU ------------------------------------------------------------------


def test_on_the_cpu_the_graphed_step_is_the_eager_step():
    _, model, walkers = tiny("cpu")
    network = lambda x: model(x, torch.bfloat16)  # noqa: E731
    eager = mcmc.make_mcmc_step(network, steps=STEPS)
    graphed = mcmc.make_mcmc_step(network, steps=STEPS, graphed=True)
    gen_eager, gen_graphed = generator("cpu"), generator("cpu")
    want = chain(eager, walkers, torch.tensor(0.2), gen_eager, 3)
    with tracing.block(3, torch.device("cpu")):
        got = chain(graphed, walkers, torch.tensor(0.2), gen_graphed, 3)
    for (x, p), (y, q) in zip(want, got):
        assert torch.equal(x, y) and torch.equal(p, q)
    assert torch.equal(gen_eager.get_state(), gen_graphed.get_state())
    assert tracing.blocks()[-1].counts == {"sweep.eager": 3}


def test_counts_live_in_the_open_block_record():
    tracing.count("sweep.replayed")  # outside a block: dropped
    with tracing.block(2, torch.device("cpu")):
        tracing.count("sweep.replayed")
        tracing.count("sweep.eager")
        tracing.count("sweep.replayed")
    tracing.count("sweep.eager")
    with tracing.block(1, torch.device("cpu")):
        pass
    first, second = tracing.blocks()[-2:]
    assert first.counts == {"sweep.replayed": 2, "sweep.eager": 1}
    assert second.counts == {}
    assert tracing.Block(0, 1, False, {}, None).counts == {}  # the default


def test_make_program_graphs_its_sweep(monkeypatch):
    made = []
    real = mcmc.GraphedSweep
    monkeypatch.setattr(mcmc, "GraphedSweep", lambda sweep: made.append(sweep) or real(sweep))
    cfg, model, walkers = tiny("cpu")
    program = train.make_program(cfg, model, generator("cpu"))
    assert len(made) == 1
    data, _ = program.mcmc_step(walkers, torch.tensor(0.1), generator("cpu"))
    assert data.shape == walkers.shape


class NoGraphs:
    def __init__(self, sweep):
        raise AssertionError("this caller must run the eager sweep")


def test_the_runner_builds_the_eager_step(monkeypatch):
    monkeypatch.setattr(mcmc, "GraphedSweep", NoGraphs)
    cfg, model, walkers = tiny("cpu")
    out = runner.evaluate_observable(cfg, model, {}, walkers, 0.1, "density", steps=2,
                                     mcmc_steps=2, device="cpu")
    assert out


def netobs_stub() -> dict:
    """The netobs modules the port's adaptor imports: its base class and types."""
    state = TypeVar("state")

    class NetworkAdaptor(Generic[state]):
        def __init__(self, config: Any, args: list[str]):
            self.config, self.args = config, args

    class ElectronGas(TypedDict):
        spins: list[int]
        ndim: int

    names = ("netobs", "netobs.adaptors", "netobs.systems", "netobs.systems.elec_gas")
    mods = {name: types.ModuleType(name) for name in names}
    mods["netobs.adaptors"].NetworkAdaptor = NetworkAdaptor
    mods["netobs.adaptors"].WalkingStep = Any
    mods["netobs.systems.elec_gas"].ElectronGas = ElectronGas
    return mods


@pytest.fixture
def adaptor_module(monkeypatch):
    bridge = "deephall_tpu_torch.netobs_bridge"
    saved = {name: module for name, module in sys.modules.items() if name.startswith(bridge)}
    for name in saved:
        monkeypatch.delitem(sys.modules, name)
    for name, module in netobs_stub().items():
        monkeypatch.setitem(sys.modules, name, module)
    try:
        yield importlib.import_module(f"{bridge}.adaptor")
    finally:
        for name in [n for n in sys.modules if n.startswith(bridge) and n not in saved]:
            del sys.modules[name]


def test_the_netobs_adaptor_builds_the_eager_step(monkeypatch, adaptor_module):
    monkeypatch.setattr(mcmc, "GraphedSweep", NoGraphs)
    _, model, walkers = tiny("cpu")
    params = dict(model.named_parameters())

    def batch_log_psi(params, x, system):
        return torch.func.functional_call(model, params, (x,))

    walk = adaptor_module.DeepHallAdaptor.make_walking_step(None, batch_log_psi, 2, None)
    aux = {"mcmc_width": torch.tensor(0.3)}
    moved, new_aux = walk(generator("cpu"), params, walkers, aux)
    assert moved.shape == walkers.shape and new_aux is aux
    assert (moved != walkers).any()


# -- the card -----------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def sweeps(model, steps=STEPS):
    """The tiny model's sweep in bf16: eager, and graphed as one object."""
    network = lambda x: model(x, torch.bfloat16)  # noqa: E731
    return mcmc.make_sweep(network, steps), mcmc.GraphedSweep(mcmc.make_sweep(network, steps))


def assert_same(got, want):
    for (x, p), (y, q) in zip(got, want):
        assert (x - y).abs().max().item() <= 1e-6
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_graphed_calls_are_the_eager_chain(device):
    _, model, walkers = tiny(device)
    eager, graphed = sweeps(model)
    width = torch.tensor(0.2, device=device)
    gen_eager, gen_graphed = generator(device), generator(device)
    want = chain(eager, walkers, width, gen_eager, 10)
    with tracing.block(10, device):
        got = chain(graphed, walkers, width, gen_graphed, 10)
    assert_same(got, want)
    assert torch.equal(gen_eager.get_state(), gen_graphed.get_state())
    assert tracing.blocks()[-1].counts == {"sweep.eager": 1, "sweep.captured": 1, "sweep.replayed": 8}
    # A float width and a fresh generator state through the same graph.
    gen_eager.manual_seed(9)
    gen_graphed.manual_seed(9)
    assert_same(chain(graphed, walkers, 0.3, gen_graphed, 2), chain(eager, walkers, 0.3, gen_eager, 2))


@pytest.mark.cuda
def test_a_replay_reads_parameters_changed_in_place(device):
    _, model, walkers = tiny(device)
    eager, graphed = sweeps(model)
    gen = generator(device)
    chain(graphed, walkers, 0.2, gen, 3)  # eager, capture, replay
    start = gen.get_state()
    before = chain(graphed, walkers, 0.2, gen, 1)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    gen.set_state(start)
    after = chain(graphed, walkers, 0.2, gen, 1)
    gen_eager = generator(device)
    gen_eager.set_state(start)
    assert_same(after, chain(eager, walkers, 0.2, gen_eager, 1))
    assert not torch.equal(before[0][0], after[0][0])


@pytest.mark.cuda
def test_one_graph_a_generator_and_a_batch_shape(device):
    # Each generator and each batch shape gets a graph of its own; a new
    # generator at a shape drops that shape's graph, and going back starts over.
    _, model, walkers = tiny(device)
    eager, graphed = sweeps(model)
    cases = [(walkers, 5), (walkers, 6), (walkers[:32].clone(), 5), (walkers, 5)]
    made = []
    for x, seed in cases:
        gen = generator(device, seed)
        want = chain(eager, x, 0.2, generator(device, seed), 3)
        with tracing.block(3, device):
            assert_same(chain(graphed, x, 0.2, gen, 3), want)
        assert tracing.blocks()[-1].counts == {"sweep.eager": 1, "sweep.captured": 1,
                                               "sweep.replayed": 1}
        made.append(weakref.ref(graphed.graphs[tuple(x.shape), x.dtype, x.device][1][0]))
    assert len(graphed.graphs) == 2
    assert len({id(ref()) for ref in made if ref() is not None}) == 2
    assert made[0]() is None and made[1]() is None  # dropped with their generators


@pytest.mark.cuda
def test_a_returned_tensor_outlives_later_replays(device):
    _, model, walkers = tiny(device)
    _, graphed = sweeps(model)
    gen = generator(device)
    (first, p_first), = chain(graphed, walkers, 0.2, gen, 3)[-1:]
    kept, p_kept = first.clone(), p_first.clone()
    chain(graphed, first, 0.2, gen, 3)
    assert torch.equal(first, kept) and torch.equal(p_first, p_kept)


def blocks_of(length: int, device, calls: int):
    """The walkers and the generator's state after ``calls`` blocks of ``length``
    iterations of a fresh program's inference block."""
    cfg, model, walkers = tiny(device)
    gen = generator(device)
    program = train.make_program(cfg, model, gen)
    state = CheckpointState(None, walkers, None, torch.tensor(0.2, device=device))
    pmoves = torch.zeros(cfg.mcmc.adapt_frequency, device=device)
    t = torch.tensor(0, dtype=torch.int32, device=device)
    for _ in range(calls):
        state, pmoves, t, _, _ = program.block(state, pmoves, t, length)
    return state.data, gen.get_state()


@pytest.mark.cuda
def test_a_block_of_ten_and_ten_blocks_of_one_are_one_chain(device):
    x10, g10 = blocks_of(10, device, 1)
    x1, g1 = blocks_of(1, device, 10)
    assert (x10 - x1).abs().max().item() <= 1e-6
    assert torch.equal(g10, g1)


def production(run: str, device):
    """``(cfg, model, walkers, width)`` of a stored run (``artifacts/<run>``): its own
    ``config.yml`` for inference, its network and its walkers on ``device``."""
    import yaml

    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.weights import load_flax

    directory = ROOT / "artifacts" / run
    tree = config.merge_dicts(config.to_dict(config.Config()),
                              yaml.safe_load((directory / "config.yml").read_text()))
    tree = config.merge_dicts(tree, {"optim": {"optimizer": "none"}})
    cfg = config.Config.from_dict(config.resolve_interpolations(tree))
    model = make_network(cfg.system, cfg.network)
    _, stored, _ = LogManager.restore_checkpoint(next(directory.glob("ckpt_*.npz")))
    load_flax(model, stored.params)
    model.to(device).requires_grad_(False)
    walkers = torch.as_tensor(stored.data[:cfg.batch_size], dtype=torch.float32).to(device)
    return cfg, model, walkers, torch.tensor(float(stored.mcmc_width), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["prod_r4", "prod_n10_r5"])
def test_the_stored_runs_replay_the_eager_chain(device, run):
    # The benchmark's N=6 and N=10 networks at batch 3360, ten moves a sweep in
    # bf16: ten graphed sweeps against ten eager ones from one generator state.
    cfg, model, walkers, width = production(run, device)
    assert walkers.shape[0] == 3360
    network = lambda x: model(x, train.sweep_dtype())  # noqa: E731
    eager = mcmc.make_sweep(network, cfg.mcmc.steps)
    graphed = mcmc.GraphedSweep(mcmc.make_sweep(network, cfg.mcmc.steps))
    gen_eager, gen_graphed = generator(device, 2**31 + 17), generator(device, 2**31 + 17)
    want = chain(eager, walkers, width, gen_eager, 10)
    with tracing.block(10, device):
        got = chain(graphed, walkers, width, gen_graphed, 10)
    assert tracing.blocks()[-1].counts == {"sweep.eager": 1, "sweep.captured": 1, "sweep.replayed": 8}
    assert_same(got, want)
    assert torch.equal(gen_eager.get_state(), gen_graphed.get_state())
    assert (got[-1][0] != walkers).any()


def block_memory(graphed: bool) -> dict:
    """Bytes of a block of 10 inference iterations of ``prod_r4`` at batch 3360
    after a block of 1 (the eager first sweep, the library handles), in this
    process: the peak allocated over the block less what was allocated before
    it, the peak reserved over it, the graphs' pools, and the cuBLAS
    workspace that one product on a new stream allocates."""
    device = torch.device("cuda")
    cfg, model, walkers, width = production("prod_r4", device)
    gen = generator(device)
    program = train.make_program(cfg, model, gen)
    mcmc_step = program.mcmc_step
    if not graphed:
        mcmc_step = mcmc.make_mcmc_step(lambda x: model(x, train.sweep_dtype()), steps=cfg.mcmc.steps)
    block = train.make_iteration_block(cfg, lambda x, w: mcmc_step(x, w, gen), program.training_step)
    state = CheckpointState(None, walkers, None, width)
    pmoves = torch.zeros(cfg.mcmc.adapt_frequency, device=device)
    t = torch.tensor(0, dtype=torch.int32, device=device)
    block(state, pmoves, t, 1)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    block(state, pmoves, t, 10)
    torch.cuda.synchronize(device)
    out = {"allocated": torch.cuda.max_memory_allocated(device) - base,
           "reserved": torch.cuda.max_memory_reserved(device),
           "graph_pools": sum(segment["total_size"] for segment in torch.cuda.memory_snapshot()
                              if tuple(segment["segment_pool_id"]) != (0, 0))}
    before = torch.cuda.memory_allocated(device)
    with torch.cuda.stream(torch.cuda.Stream(device)):
        a = torch.ones(64, 64, device=device, dtype=torch.bfloat16)
        (a @ a).sum().item()
        del a
    out["workspace"] = torch.cuda.memory_allocated(device) - before
    return out


@pytest.mark.cuda
def test_a_graphed_block_costs_a_workspace_and_a_pool_more_than_an_eager_one(device):
    # What the graph costs in device memory, each mode in a fresh process (a
    # process's first capture).  Allocated: the capture stream's cuBLAS
    # workspace more at most.  Reserved: the graph's pool more at most, which
    # holds that workspace and one sweep's intermediates.  Each with 1% of the
    # eager block's room for the allocator's rounding.
    def run(mode):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT),
                                                                        os.environ.get("PYTHONPATH")])))
        done = subprocess.run([sys.executable, __file__, mode], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        assert done.returncode == 0, done.stderr[-4000:]
        return json.loads(done.stdout.strip().splitlines()[-1])

    eager, graphed = run("eager"), run("graphed")
    print(json.dumps({"eager": eager, "graphed": graphed}))
    assert eager["graph_pools"] == 0 and graphed["graph_pools"] > graphed["workspace"] >= 2**20
    assert graphed["allocated"] - eager["allocated"] <= graphed["workspace"] + 0.01 * eager["allocated"]
    assert graphed["reserved"] - eager["reserved"] <= graphed["graph_pools"] + 0.01 * eager["reserved"]


if __name__ == "__main__":  # one mode of the memory test, in a process of its own
    print(json.dumps(block_memory(sys.argv[1] == "graphed")))
