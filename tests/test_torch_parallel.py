"""The port's walker data parallelism (``deephall_tpu_torch/parallel``) on the CPU.

Two gloo processes on ``127.0.0.1``, launched with the variables torchrun
sets, as ``tests/test_distributed.py:_spawn`` launches the JAX package's
processes (the full-precision sweep pinned, a time limit on every child).
The rendezvous port lies in this xdist worker's block below the ephemeral
range (``parallel.rendezvous_port``).  Each child's stdout and stderr are
kept in files under the test's ``tmp_path``, with its own clock at its start,
its phases and its exit, and a failure shows both ranks' output:

* the rendezvous and the collectives, and the failures that must raise;
* the whole-batch statistics, clipped differences and cotangent weights of
  two ranks against ``deephall_tpu/loss.py`` on the concatenated inputs, and
  the gradient and KFAC moments of a small Psiformer against the JAX package
  (float32; the tolerances are stated at each comparison);
* a sweep that does not depend on the number of ranks;
* training end to end: 2 ranks for 6 KFAC iterations and a resume to 12, one
  process straight through 6 with the same energies, checkpoints that resume
  across rank counts both ways, files written by rank 0 alone, and a save that
  one rank's clock or signal asks for taken by both;
* the observables runner on 2 ranks against one process.
"""

from __future__ import annotations

import csv
import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import loss as jax_loss
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu.optimizers import kfac as jax_kfac
from deephall_tpu.types import CheckpointState as JaxCheckpointState
from deephall_tpu_torch import config, loss, mcmc, optimizers, parallel
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.optimizers import kfac
from deephall_tpu_torch.weights import flatten, init_params, params_to_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
               "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID", "OMPI_COMM_WORLD_RANK",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK")
TIMEOUT = 120  # seconds for any child process
RAW = {
    "system": {"nspins": [2, 1], "flux": 4, "lz_penalty": 1.0, "lz_center": 1.0,
               "l2_penalty": 0.02, "l2_center": 2.0, "overlap_penalty": 1.3},
    "network": {"psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 4}},
}
BATCH, NELEC, PARAM_SEED = 16, 3, 5
TINY = [
    "seed=7", "batch_size=64", "system.nspins=[3,0]", "system.flux=2",
    "system.interaction_strength=0", "network.psiformer.num_layers=1",
    "network.psiformer.num_heads=1", "network.psiformer.heads_dim=4", "mcmc.burn_in=5",
    "mcmc.steps=2", "optim.block_size=3", "log.initial_energy=false", "optim.optimizer=kfac",
]


def free_port() -> int:
    """A rendezvous port in this xdist worker's block below the ephemeral range
    (``parallel.rendezvous_port``): no other worker's sockets, and no socket
    that the kernel hands out, can take it before rank 0's store binds it."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    return parallel.rendezvous_port(block=int(worker.removeprefix("gw")))


def child_env(rank: int | None, size: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update(DEEPHALL_MCMC_DTYPE="f32", OMP_NUM_THREADS="1")
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def run_children(children: list[tuple[list[str], dict]], logs: Path
                 ) -> list[tuple[int, str, str]]:
    """Run ``python argv`` with ``env`` for each child, its stdout and stderr in
    files of a new directory under ``logs``, waiting up to ``TIMEOUT`` for each
    in turn; returns each child's ``(returncode, stdout, stderr)``.  A timeout
    kills every child and raises with every child's output attached."""
    logs = Path(tempfile.mkdtemp(prefix="children-", dir=logs))
    procs, paths = [], []
    for r, (argv, env) in enumerate(children):
        paths.append((logs / f"rank{r}.stdout", logs / f"rank{r}.stderr"))
        with paths[-1][0].open("w") as out, paths[-1][1].open("w") as err:
            procs.append(subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env, text=True,
                                          stdout=out, stderr=err))
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired as e:
        for p in procs:
            p.kill()
            p.wait()
        e.add_note(report(outputs(procs, paths)))
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outputs(procs, paths)


def outputs(procs, paths) -> list[tuple[int, str, str]]:
    return [(p.returncode, out.read_text(), err.read_text()) for p, (out, err) in zip(procs, paths)]


def report(outs) -> str:
    """Every child's exit code, stdout and stderr, for a failure's message."""
    return "\n".join(f"--- rank {r}: rc={rc}\nstdout={out}\nstderr={err}"
                     for r, (rc, out, err) in enumerate(outs))


def spawn(argv: list[str], ranks: int, logs: Path, check: bool = True
          ) -> list[tuple[int, str, str]]:
    """Run ``python argv`` as ``ranks`` gloo ranks (one process without a launch
    when ``ranks`` is 1), their output kept under ``logs``; returns each rank's
    ``(returncode, stdout, stderr)``."""
    port = free_port()
    outs = run_children([(argv, child_env(r if ranks > 1 else None, ranks, port))
                         for r in range(ranks)], logs)
    if check:
        for rc, _, _ in outs:
            assert rc == 0, f"child failed rc={rc}\n{report(outs)}"
    return outs


# Each child script's own clock on stderr: its start, the phases that call
# stamp(), and its exit (registered first, so it runs after the group is left).
STAMP = """import atexit, time
def stamp(what):
    print(f"[{time.time():.3f}] {what}", file=sys.stderr, flush=True)
stamp("start")
atexit.register(stamp, "exit")
"""


def script(tmp_path: Path, name: str, body: str) -> str:
    path = tmp_path / name
    path.write_text(f"import sys\nsys.path.insert(0, {str(REPO)!r})\n" + STAMP
                    + textwrap.dedent(body))
    return str(path)


# --------------------------------------------------------------------------- #
# The rendezvous and the collectives
# --------------------------------------------------------------------------- #

COLLECTIVES = """
import json, time, torch
from deephall_tpu_torch import parallel, train
from deephall_tpu_torch.config import Config

parallel.initialize_distributed("cpu", timeout=60)
r = parallel.rank()
x = torch.full((2, 3), float(r + 1))
z, c = parallel.all_reduce_sum(torch.tensor([1.0 + 2.0j * r]), torch.tensor([float(r), 1.0]))
gen = torch.Generator().manual_seed(3)
out = dict(
    rank=r, size=parallel.world_size(),
    sum=parallel.all_reduce_sum(x).tolist(),
    packed=[[z.real.item(), z.imag.item()], c.tolist()],
    max=parallel.all_reduce_max(torch.tensor([float(r), -float(r)])).tolist(),
    mean=parallel.all_reduce_mean(torch.tensor(float(r))).item(),
    gather=parallel.all_gather_rows(torch.arange(3.0)[:, None] + 10 * r).tolist(),
    gather_complex=[[v.real, v.imag] for v in
                    parallel.all_gather_rows(torch.tensor([r + 1j])).tolist()],
    shard=parallel.shard_rows(torch.arange(8)).tolist(),
    draw=parallel.draw_rows(torch.rand, (2, 3), generator=gen).tolist(),
)
y = torch.full((3,), float(r + 5))
parallel.broadcast_(y)
out["broadcast"] = y.tolist()
# A run without log.save_path is named by rank 0's clock on every rank.
time.sleep(1.5 * r)
out["own_clock"] = time.time()
out["run_start"] = train.run_start(Config(), "cpu").timestamp()
parallel.shutdown_distributed()
print(json.dumps(out))
"""


def test_collectives_on_two_ranks(tmp_path):
    # Each rank contributes its index; every collective gives the global value
    # in global (rank) order, and a draw of the whole batch splits by rows.
    # The run's name comes from rank 0's clock, 1.5 s behind rank 1's.
    outs = [json.loads(out)
            for _, out, _ in spawn([script(tmp_path, "c.py", COLLECTIVES)], 2, tmp_path)]
    want_draw = torch.rand((4, 3), generator=torch.Generator().manual_seed(3))
    for r, got in enumerate(outs):
        assert (got["rank"], got["size"]) == (r, 2)
        assert got["sum"] == [[3.0] * 3] * 2
        assert got["packed"] == [[2.0, 2.0], [1.0, 2.0]]
        assert got["max"] == [1.0, 0.0]
        assert got["mean"] == 0.5
        assert got["gather"] == [[0.0], [1.0], [2.0], [10.0], [11.0], [12.0]]
        assert got["gather_complex"] == [[0.0, 1.0], [1.0, 1.0]]
        assert got["shard"] == list(range(4 * r, 4 * r + 4))
        assert got["draw"] == want_draw[2 * r:2 * r + 2].tolist()
        assert got["broadcast"] == [5.0] * 3
        assert got["run_start"] == outs[0]["run_start"]
        assert abs(got["run_start"] - outs[0]["own_clock"]) < 0.5
    assert outs[1]["own_clock"] - outs[0]["run_start"] > 1.0


@pytest.fixture
def no_launch(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_single_process_is_a_noop(no_launch):
    # No launch variables: no process group, and every collective returns its
    # input itself without a call.
    assert parallel.launch_env() is None
    assert parallel.initialize_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    assert (parallel.rank(), parallel.world_size(), parallel.in_group()) == (0, 1, False)
    x, y = torch.ones(4, 2), torch.zeros(3)
    assert parallel.all_reduce_sum(x) is x
    assert parallel.all_reduce_max(x) is x
    assert parallel.all_reduce_mean(x) is x
    assert parallel.all_reduce_sum(x, y) == (x, y)
    assert parallel.all_gather_rows(x) is x
    assert parallel.shard_rows(x) is x
    parallel.broadcast_(y)
    assert not y.any()
    parallel.shutdown_distributed()


@pytest.mark.parametrize("launcher, env, want", [
    ("torchrun", {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}, (1, 2, 1)),
    ("torchrun_one", {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}, (0, 1, 0)),
    ("slurm", {"SLURM_PROCID": "3", "SLURM_NTASKS": "4", "SLURM_LOCALID": "1"}, (3, 4, 1)),
    ("slurm_one_task", {"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}, None),
    ("openmpi", {"OMPI_COMM_WORLD_RANK": "2", "OMPI_COMM_WORLD_SIZE": "3",
                 "OMPI_COMM_WORLD_LOCAL_RANK": "0"}, (2, 3, 0)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_launch_environments(no_launch, launcher, env, want):
    del launcher
    for k, v in env.items():
        no_launch.setenv(k, v)
    assert parallel.launch_env() == want


def test_launches_that_cannot_start_raise(no_launch):
    # A launch of two without an address, or asking for a card that is not
    # there, raises before any rendezvous; nothing is joined.
    no_launch.setenv("RANK", "0")
    no_launch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        parallel.initialize_distributed("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            parallel.initialize_distributed("cuda")
    with pytest.raises(ValueError, match="backend"):
        no_launch.setenv("MASTER_ADDR", "127.0.0.1")
        no_launch.setenv("MASTER_PORT", "1")
        parallel.initialize_distributed("cpu", backend="mpi")
    assert not dist.is_initialized()


def test_rendezvous_ports_lie_below_the_ephemeral_range():
    # Each call takes the next free port of its block, below the range from
    # which bind(0) and connect draw, and skips a port that is taken.
    low = int(parallel.mesh.EPHEMERAL_RANGE.read_text().split()[0])
    size = parallel.mesh.PORT_BLOCK
    ports = [parallel.rendezvous_port(block=7) for _ in range(2)]
    with socket.socket() as taken:
        nxt = low - 8 * size + (ports[1] + 1 - (low - 8 * size)) % size
        taken.bind(("127.0.0.1", nxt))
        ports.append(parallel.rendezvous_port(block=7))
    assert all(low - 8 * size <= p < low - 7 * size for p in ports), ports
    assert len(set(ports)) == 3 and nxt not in ports, (ports, nxt)


LONELY = """
from deephall_tpu_torch import parallel
parallel.initialize_distributed("cpu", timeout=3)
print("JOINED")
"""


def test_failed_rendezvous_raises(tmp_path):
    # Rank 0 and rank 1 of a launch of two, each alone at its own port: both
    # raise within the timeout, and neither carries on.
    path = script(tmp_path, "lonely.py", LONELY)
    outs = run_children([([path], child_env(rank, 2, free_port())) for rank in (0, 1)], tmp_path)
    for rc, out, err in outs:
        assert rc != 0 and "JOINED" not in out, report(outs)
        assert "could not rendezvous" in err, report(outs)


REJOIN = """
import torch
import torch.distributed as dist
from deephall_tpu_torch import parallel, train

stamp("imported")
parallel.initialize_distributed("cpu", timeout=60)
stamp("joined")
group = dist.group.WORLD
# An entry point keeps the group, and the next call in this process takes it.
for i in range(2):
    train.cli([*{tiny!r}, "optim.iterations=1", f"log.save_path={save}/run{{i}}", "--device", "cpu"])
    stamp(f"cli {{i}} done")
    assert dist.is_initialized() and dist.group.WORLD is group
    assert parallel.all_reduce_sum(torch.ones(1)).item() == 2
print("KEPT")
"""


def test_group_is_joined_once_and_kept(tmp_path):
    # The CLIs keep the process group for the process's life, which leaves it
    # at exit: leaving and joining again at the same address raced (one rank
    # reached the old rendezvous store and failed, the other hung).
    body = REJOIN.format(tiny=TINY, save=tmp_path)
    outs = spawn([script(tmp_path, "rejoin.py", body)], 2, tmp_path)
    assert [out.split()[-1] for _, out, _ in outs] == ["KEPT"] * 2, report(outs)


# --------------------------------------------------------------------------- #
# The whole batch: statistics, weights, gradient, KFAC moments, one sweep
# --------------------------------------------------------------------------- #


def inputs(path: Path) -> dict:
    """Numpy-seeded float32 inputs of the whole batch: walkers, local energies
    with NaN walkers (one in each rank's half), observables with a NaN, and one
    fixed state's log ratios with a NaN and an outlier."""
    rng = np.random.default_rng(21)
    theta = np.arccos(rng.uniform(-1, 1, (BATCH, NELEC)))
    phi = rng.uniform(-np.pi, np.pi, (BATCH, NELEC))
    el = 3.1 + 0.1 * rng.standard_normal(BATCH) + 0.01j * rng.standard_normal(BATCH)
    el[[2, 11]] = np.nan
    el[5] += 30.0  # an outlier for the clipping
    obs = {
        "angular_momentum_z": 1.0 + 0.1 * rng.standard_normal(BATCH),
        "angular_momentum_z_square": 1.0 + np.abs(rng.standard_normal(BATCH)),
        "angular_momentum_square": 2.0 + np.abs(rng.standard_normal(BATCH)),
        "potential": 1.6 + 0.1 * rng.standard_normal(BATCH),
        "kinetic": 1.5 + 0.1 * rng.standard_normal(BATCH) + 0j,
    }
    obs["angular_momentum_square"][9] = np.nan
    ratios = rng.standard_normal((1, BATCH)) + 1j * rng.uniform(-np.pi, np.pi, (1, BATCH))
    ratios[0, 4] = np.nan
    ratios[0, 13] += 20.0  # the largest real part lies in rank 1's half
    arrays = dict(data=np.stack([theta, phi], -1), el=el, ratios=ratios,
                  **{f"obs_{k}": v for k, v in obs.items()})
    arrays = {k: v.astype(np.complex64 if np.iscomplexobj(v) else np.float32)
              for k, v in arrays.items()}
    np.savez(path, **arrays)
    return arrays


def observables(arrays: dict) -> dict:
    return {k[4:]: v for k, v in arrays.items() if k.startswith("obs_")}


def port_model():
    cfg = config.Config.from_dict(RAW)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(PARAM_SEED))
    return cfg, model


WHOLE_BATCH = """
import numpy as np, torch
from deephall_tpu_torch import config, loss, mcmc, parallel
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.optimizers import kfac
from deephall_tpu_torch.weights import init_params

parallel.initialize_distributed("cpu", timeout=60)
raw = {raw!r}
cfg = config.Config.from_dict(raw)
model = make_network(cfg.system, cfg.network)
init_params(model, torch.Generator().manual_seed({seed}))
with np.load({inputs!r}) as f:
    arrays = {{k: parallel.shard_rows(torch.from_numpy(f[k])) for k in f.files if k != "ratios"}}
    ratios = torch.from_numpy(f["ratios"])
ratios = ratios[:, parallel.rank() * 8:(parallel.rank() + 1) * 8]
obs = {{k[4:]: v for k, v in arrays.items() if k.startswith("obs_")}}
stats, diff = loss.stats_and_clipped_diff(cfg.system, arrays["el"], obs, ratios)
out = {{f"stats_{{k}}": v for k, v in stats.items()}}
out.update(diff=diff, w=loss.vjp_weights(diff))
# The gradient without penalties or fixed states, and the curvature capture.
plain = config.Config.from_dict({{**raw, "system": {{"nspins": [2, 1], "flux": 4}}}})
_, grads, inputs, dy = loss.gradient_and_capture(model, plain.system, arrays["data"],
                                                 arrays["el"], obs)
specs = kfac.discover(model, 3)
kron, diag = kfac.factor_update(specs, inputs, dy)
out.update({{f"grad_{{k}}": v for k, v in grads.items()}})
out.update({{f"in_{{k}}": v for k, v in inputs.items()}})
out.update({{f"dy_{{k}}": v for k, v in dy.items()}})
for blocks in (kron, diag):
    out.update({{f"moment_{{p}}/{{leaf}}": v for p, b in blocks.items() for leaf, v in b.items()}})
# One sweep of 3 moves from the same walkers and generator seed.
with torch.no_grad():
    walkers, pmove = mcmc.make_mcmc_step(model, steps=3)(
        arrays["data"], 0.3, torch.Generator().manual_seed(9))
out.update(sweep=walkers, pmove=pmove)
np.savez({out!r}.format(parallel.rank()), **{{k: v.detach().numpy() for k, v in out.items()}})
parallel.shutdown_distributed()
"""


@pytest.fixture(scope="module")
def whole_batch(tmp_path_factory):
    """Two ranks' results on their halves of the numpy-seeded batch."""
    tmp = tmp_path_factory.mktemp("whole_batch")
    arrays = inputs(tmp / "inputs.npz")
    body = WHOLE_BATCH.format(raw=RAW, seed=PARAM_SEED, inputs=str(tmp / "inputs.npz"),
                              out=str(tmp / "rank{}.npz"))
    spawn([script(tmp, "whole_batch.py", body)], 2, tmp)
    ranks = []
    for r in range(2):
        with np.load(tmp / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return arrays, ranks


def test_statistics_and_differences_match_jax(whole_batch):
    # deephall_tpu/loss.py:stats_and_clipped_diff on the whole batch (NaN
    # walkers, the Lz, Lz^2 and L^2 penalties, the overlap against a fixed
    # state): each statistic to 1e-5 relative (float32 sums over two ranks in
    # another order), the differences and the weights to 1e-5 of their largest.
    arrays, ranks = whole_batch
    jsystem = jax_config.Config.from_dict(RAW).system
    want_stats, want_diff = jax_loss.stats_and_clipped_diff(
        jsystem, jnp.asarray(arrays["el"]),
        {k: jnp.asarray(v) for k, v in observables(arrays).items()}, jnp.asarray(arrays["ratios"]))
    want_w = np.asarray(jax_loss.vjp_weights(want_diff))
    want_diff = np.asarray(want_diff)
    assert sorted(k[6:] for k in ranks[0] if k.startswith("stats_")) == sorted(want_stats)
    for key, want in want_stats.items():
        for got in ranks:
            np.testing.assert_allclose(got[f"stats_{key}"], np.asarray(want), rtol=1e-5, err_msg=key)
    for name, want in (("diff", want_diff), ("w", want_w)):
        got = np.concatenate([r[name] for r in ranks])
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.nanmax(np.abs(want)),
                                   err_msg=name)


def test_gradient_matches_jax_and_is_the_same_on_both_ranks(whole_batch):
    # The ranks' partial gradients summed by one collective: equal on both
    # ranks bit for bit; against the JAX package's pullback over the whole
    # batch with the same weights, every entry within 1e-5 of the gradient's
    # largest (float32: the Jastrow cusp's gradient is a sum that cancels to
    # 1e-3 of its terms, and each package alone lies 2e-5 to 8e-5 of its own
    # value from float64 there); against the port's one-process gradient,
    # 1e-5 of each leaf's largest (a leaf's scale at least 1e-3 of the whole).
    arrays, ranks = whole_batch
    raw = {**RAW, "system": {"nspins": [2, 1], "flux": 4}}
    jcfg = jax_config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    cfg, model = port_model()
    params = params_to_flax(model)
    _, diff = jax_loss.stats_and_clipped_diff(
        jcfg.system, jnp.asarray(arrays["el"]),
        {k: jnp.asarray(v) for k, v in observables(arrays).items()})
    w = jax_loss.vjp_weights(diff)

    @jax.jit
    def gradient(params, data, w):
        _, pullback = jax.vjp(lambda p: (lambda o: (o.real, o.imag))(jmodel.apply(p, data)), params)
        return jax.tree.map(jnp.nan_to_num, pullback((w.real, w.imag))[0])

    want = flatten(jax.tree.map(np.asarray, gradient(params, jnp.asarray(arrays["data"]), w)))
    _, one, _, _ = loss.gradient_and_capture(
        model, config.Config.from_dict(raw).system, torch.from_numpy(arrays["data"]),
        torch.from_numpy(arrays["el"]),
        {k: torch.from_numpy(v) for k, v in observables(arrays).items()})
    got = {k[5:]: v for k, v in ranks[0].items() if k.startswith("grad_")}
    assert sorted(got) == sorted(want) == sorted(one)
    largest = max(np.abs(v).max() for v in want.values())
    for name, g in got.items():
        assert np.array_equal(g, ranks[1][f"grad_{name}"]), name
        assert np.abs(g - want[name]).max() < 1e-5 * largest, name
        single = one[name].numpy()
        scale = max(np.abs(single).max(), 1e-3 * largest)
        assert np.abs(g - single).max() < 1e-5 * scale, name


def test_kfac_moments_match_jax(whole_batch):
    # The moments averaged over the ranks against the JAX package's KFAC step
    # (deephall_tpu/optimizers/kfac.py:_factor_update) from zero curvature on
    # the concatenated captured rows: 1e-5 of each block's largest entry; both
    # ranks hold the same moments bit for bit.
    arrays, ranks = whole_batch
    jcfg = jax_config.Config.from_dict({**RAW, "system": {"nspins": [2, 1], "flux": 4}})
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    cfg, model = port_model()
    params = params_to_flax(model)
    specs = kfac.discover(model, NELEC)

    def tree(prefix):
        out = {}
        for spec in specs:
            node = out
            for part in spec.path.split("/"):
                node = node.setdefault(part, {})
            node["x"] = jnp.concatenate([r[f"{prefix}_{spec.path}"] for r in ranks])
        return out

    sown, dy = tree("in"), tree("dy")
    zeros = jax.tree.map(jnp.zeros_like, params)
    _, step = jax_kfac.make_kfac_training_step(
        jcfg.optim.kfac, None, jmodel, jnp.zeros((NELEC, 2)),
        capture_fn=lambda p, d: ({}, zeros, sown, dy))
    state0 = optimizers.make_optimizer_step(cfg, model)[0](model, None)
    jstate0 = jax_kfac.KfacState(
        {k: {f: v.numpy() for f, v in b.items()} for k, b in state0.kron.items()},
        {k: {f: v.numpy() for f, v in b.items()} for k, b in state0.diag.items()},
        state0.weight.numpy(), state0.step.numpy())
    out, _ = jax.jit(step)(JaxCheckpointState(params, jnp.asarray(arrays["data"]), jstate0,
                                     jnp.float32(0.1)), None)
    weight = float(out.opt_state.weight)
    n = 0
    for blocks in (out.opt_state.kron, out.opt_state.diag):
        for path, block in blocks.items():
            for leaf, value in block.items():
                want = np.asarray(value) / weight
                got = ranks[0][f"moment_{path}/{leaf}"]
                assert np.array_equal(got, ranks[1][f"moment_{path}/{leaf}"]), (path, leaf)
                assert np.abs(got - want).max() < 1e-5 * np.abs(want).max(), (path, leaf)
                n += 1
    assert n == 2 * len(specs)


def test_sweep_does_not_depend_on_the_rank_count(whole_batch):
    # One sweep of 3 moves from the same walkers and seed: the two ranks' rows
    # are the one-process walkers exactly, and the acceptance is the same.
    arrays, ranks = whole_batch
    _, model = port_model()
    with torch.no_grad():
        walkers, pmove = mcmc.make_mcmc_step(model, steps=3)(
            torch.from_numpy(arrays["data"]), 0.3, torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(np.concatenate([r["sweep"] for r in ranks]), walkers.numpy())
    assert not np.array_equal(walkers.numpy(), arrays["data"])
    for r in ranks:
        assert float(r["pmove"]) == pytest.approx(float(pmove), abs=1e-7)


# --------------------------------------------------------------------------- #
# Training and the runner end to end
# --------------------------------------------------------------------------- #


def energies(save: Path) -> list[float]:
    with (save / "train_stats.csv").open() as f:
        return [float(row["energy"]) for row in csv.DictReader(f)]


def train_run(save: Path, ranks: int, iterations: int, *extra: str):
    return spawn(["-m", "deephall_tpu_torch.train", *TINY, f"optim.iterations={iterations}",
                  f"log.save_path={save}", *extra, "--device", "cpu"], ranks, save.parent)


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("training")
    runs = {}
    runs["two"] = train_run(tmp / "two", 2, 6)
    runs["two_files"] = sorted(p.name for p in (tmp / "two").iterdir())
    runs["two_resumed"] = train_run(tmp / "two", 2, 12)
    runs["one"] = train_run(tmp / "one", 1, 6)
    # Each 6-iteration checkpoint resumes on the other rank count for 2 iterations.
    runs["two_to_one"] = train_run(tmp / "two_to_one", 1, 8,
                                   f"log.restore_path={tmp / 'two' / 'ckpt_000005.npz'}")
    runs["one_to_two"] = train_run(tmp / "one_to_two", 2, 8,
                                   f"log.restore_path={tmp / 'one' / 'ckpt_000005.npz'}")
    return tmp, runs


def test_two_ranks_train_checkpoint_and_resume(training):
    tmp, runs = training
    # Rank 0 alone wrote: one run's files, and only rank 0 logged a save.
    assert runs["two_files"] == ["ckpt_000005.npz", "config.yml", "train_stats.csv"]
    saves = ["Saving checkpoint" in err for _, _, err in runs["two"]]
    assert saves == [True, False]
    with np.load(tmp / "two" / "ckpt_000005.npz", allow_pickle=True) as f:
        assert f["data"].shape == (64, 3, 2)  # the gathered global batch
    assert all("Restored checkpoint" in err for _, _, err in runs["two_resumed"])
    assert (tmp / "two" / "ckpt_000011.npz").exists()
    assert len(energies(tmp / "two")) == 12


def test_two_ranks_match_one_process(training):
    # The same seed straight through 6 iterations on one process: the energies
    # of the CSV (4 decimals) agree to rtol 1e-5, as tests/test_distributed.py.
    tmp, _ = training
    np.testing.assert_allclose(energies(tmp / "one"), energies(tmp / "two")[:6],
                               rtol=1e-5, atol=1e-5)


def test_checkpoints_resume_across_rank_counts(training):
    # The 2-rank checkpoint on one process and the 1-process checkpoint on two
    # ranks continue the chain of the 2-rank resume: iterations 6 and 7 agree.
    tmp, runs = training
    want = energies(tmp / "two")[6:8]
    for name in ("two_to_one", "one_to_two"):
        assert all("Restored checkpoint" in err for _, _, err in runs[name])
        np.testing.assert_allclose(energies(tmp / name), want, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    with np.load(tmp / "one_to_two" / "ckpt_000007.npz", allow_pickle=True) as f:
        assert f["data"].shape == (64, 3, 2) and int(f["step"]) == 7


ONE_RANK_ASKS = """
import time
from deephall_tpu_torch import parallel, train


class Clock:
    # A clock that moves on by 10^6 s at every reading.
    def __init__(self):
        self.now = time.time()

    def __getattr__(self, name):
        return getattr(time, name)

    def time(self):
        self.now += 1e6
        return self.now


if parallel.launch_env()[0] == 1:
    if {what!r} == "clock":
        train.time = Clock()
    else:
        train.GracefulKiller.kill_now = True
train.cli({argv!r})
"""


@pytest.mark.parametrize("what", ["clock", "signal"])
def test_one_rank_asking_for_a_save_saves_on_all(tmp_path, what):
    # Only rank 1's clock says a save is due (every block of 3 iterations, at
    # save_step_interval=3), or only rank 1 got SIGTERM: the save gathers the
    # walkers, a collective, so both ranks must take rank 1's decision from the
    # block's read, or one of them would wait in the gather for ever.
    save = tmp_path / what
    argv = [*TINY, "optim.iterations=9", "log.save_step_interval=3", f"log.save_path={save}",
            "--device", "cpu"]
    outs = spawn([script(tmp_path, "asks.py", ONE_RANK_ASKS.format(what=what, argv=argv))], 2,
                 tmp_path, check=what == "clock")
    if what == "clock":
        want = ["ckpt_000002.npz", "ckpt_000005.npz", "ckpt_000008.npz"]
    else:  # both save after the first block, then stop
        assert all(rc != 0 and "ABORT" in err for rc, _, err in outs), outs
        want = ["ckpt_000002.npz"]
    assert sorted(p.name for p in save.glob("ckpt_*.npz")) == want
    assert len(energies(save)) == (9 if what == "clock" else 3)


RUNNER = """
from deephall_tpu_torch.observables import runner
for estimator in ("density", "ed_overlap"):
    runner.cli([{ckpt!r}, "--estimator", estimator, "--steps", "4", "--seed", "1",
                "--out", {out!r}.format(estimator), "--device", "cpu"])
"""


def test_runner_on_two_ranks_matches_one_process(training, tmp_path):
    # The density histogram and the ED overlap of a 2-rank walk equal the
    # one-process walk's (rtol 1e-6), and rank 0 alone saves.
    tmp, _ = training
    ckpt = str(tmp / "one" / "ckpt_000005.npz")
    results = {}
    for ranks in (1, 2):
        out = str(tmp_path / f"{{}}_{ranks}.npz")
        outs = spawn([script(tmp_path, f"runner{ranks}.py", RUNNER.format(ckpt=ckpt, out=out))],
                     ranks, tmp_path)
        assert sum(err.count("Saved") for _, _, err in outs) == 2
        for estimator in ("density", "ed_overlap"):
            with np.load(out.format(estimator)) as f:
                results[estimator, ranks] = {k: f[k] for k in f.files}
    np.testing.assert_allclose(results["density", 2]["map"], results["density", 1]["map"],
                               rtol=1e-6)
    assert results["density", 1]["map"].sum() == 4 * 64 * 3
    np.testing.assert_allclose(results["ed_overlap", 2]["overlap"],
                               results["ed_overlap", 1]["overlap"], rtol=1e-6)
    assert 0 < float(results["ed_overlap", 1]["overlap"]) <= 1 + 1e-6
