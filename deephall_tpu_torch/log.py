"""Run management: checkpoints, CSV stats, config audit (port of ``deephall_tpu/log.py``).

The files are those of the JAX package, byte for byte in layout:

* ``ckpt_{step:06d}.npz`` (compressed) with ``step``, ``params`` (the pickled
  flax parameter tree of NumPy arrays), ``data`` ``[batch, nelec, 2]``,
  ``opt_state`` (pickled), ``mcmc_width`` and the width-adaptation extras
  ``pmoves`` and ``t``;
* ``train_stats.csv`` with a header on creation and a mirrored line on stderr;
* a ``config.yml`` sidecar stamped with the git commit.

``params`` is unpickled by :class:`_NumpyUnpickler`, which refuses every
class outside NumPy and the builtins.  ``opt_state`` goes both ways:

* the port writes it as builtins and NumPy arrays only, a dict tagged
  ``{"optimizer": "kfac" | "adam", ...}`` with the state's fields, so the JAX
  package unpickles it and its ``validate_opt_state`` drops it with a warning;
* :class:`_OptStateUnpickler` reads the port's dict, and maps the JAX
  package's ``deephall_tpu.optimizers.kfac.KfacState`` and optax's Adam state
  classes (by class name) onto :class:`~deephall_tpu_torch.types.KfacState` and
  :class:`~deephall_tpu_torch.types.AdamState`, importing neither; any other
  class is refused, and a refused or unreadable state is restored as ``None``
  with a warning, so the optimizer is reinitialised.

Paths (``log.save_path``, ``log.restore_path``, a checkpoint given to
:meth:`LogManager.restore_checkpoint`) are local paths or ``scheme://`` fsspec
URLs, through :class:`AnyPath`; ``fsspec`` is imported only for a URL.

Over several ranks only rank 0 writes (``write_artifacts``): the run
directory, ``config.yml``, the CSV and the checkpoints.  Every rank calls
:meth:`LogManager.save_checkpoint`, which gathers the walkers of all ranks,
and every rank reads a restored checkpoint whole and keeps its own rows, so a
checkpoint resumes on any number of ranks.
"""

from __future__ import annotations

import datetime
import difflib
import io
import logging
import pickle
import subprocess
import sys
import zipfile
from collections.abc import Generator
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from deephall_tpu_torch import parallel
from deephall_tpu_torch.config import Config, to_yaml
from deephall_tpu_torch.types import AdamState, CheckpointState, KfacState

logger = logging.getLogger("deephall")


class AnyPath:
    """A local path or an fsspec URL (``memory://``, ``gs://``, ...), with the
    few operations the run directory needs (port of ``deephall_tpu/log.py:AnyPath``)."""

    def __init__(self, path: str | Path | AnyPath):
        self._raw = str(path)
        self._is_url = "://" in self._raw

    def __str__(self) -> str:
        return self._raw

    def __truediv__(self, other: str) -> AnyPath:
        sep = "" if self._raw.endswith("/") else "/"
        return AnyPath(f"{self._raw}{sep}{other}")

    def _fs(self):
        import fsspec

        return fsspec.core.url_to_fs(self._raw)

    @property
    def parent(self) -> AnyPath:
        if self._is_url:
            return AnyPath(self._raw.rstrip("/").rsplit("/", 1)[0])
        return AnyPath(Path(self._raw).parent)

    def exists(self) -> bool:
        if self._is_url:
            fs, p = self._fs()
            return fs.exists(p)
        return Path(self._raw).exists()

    def is_file(self) -> bool:
        if self._is_url:
            fs, p = self._fs()
            return fs.isfile(p)
        return Path(self._raw).is_file()

    def mkdir(self, parents: bool = True, exist_ok: bool = True) -> None:
        if self._is_url:
            fs, p = self._fs()
            fs.makedirs(p, exist_ok=exist_ok)
        else:
            Path(self._raw).mkdir(parents=parents, exist_ok=exist_ok)

    def glob(self, pattern: str) -> list[AnyPath]:
        if self._is_url:
            fs, p = self._fs()
            proto = self._raw.split("://", 1)[0]
            return [AnyPath(f"{proto}://{m}") for m in fs.glob(f"{p}/{pattern}")]
        return [AnyPath(p) for p in Path(self._raw).glob(pattern)]

    def open(self, mode: str = "r", **kwargs):
        if self._is_url:
            import fsspec

            return fsspec.open(self._raw, mode, **kwargs).open()
        return open(self._raw, mode, **kwargs)

    def unlink(self, missing_ok: bool = True) -> None:
        if self._is_url:
            fs, p = self._fs()
            if fs.exists(p):
                fs.rm(p)
        else:
            Path(self._raw).unlink(missing_ok=missing_ok)


def init_logging() -> None:
    """Set up the ``deephall`` stderr logger."""
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    handler.setLevel(logging.INFO)
    logger.addHandler(handler)
    logger.propagate = False


def _object_array(value) -> np.ndarray:
    arr = np.empty((), dtype=object)
    arr[()] = value
    return arr


class _NumpyUnpickler(pickle.Unpickler):
    """Unpickles NumPy arrays and builtin containers, and nothing else."""

    _ALLOWED_PREFIXES = ("numpy.", "builtins.", "collections.")

    def find_class(self, module: str, name: str):
        full = f"{module}.{name}"
        if module == "numpy" or full.startswith(self._ALLOWED_PREFIXES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to unpickle {full}")


class _OptaxCounter(tuple):
    """optax's schedule counter beside its Adam state (``ScaleByScheduleState``)."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _OptStateUnpickler(_NumpyUnpickler):
    """Also maps the JAX package's and optax's optimizer states onto the port's."""

    _OPTAX = {"ScaleByAdamState": AdamState, "ScaleByScheduleState": _OptaxCounter,
              "EmptyState": _OptaxCounter}

    def find_class(self, module: str, name: str):
        if (module, name) == ("deephall_tpu.optimizers.kfac", "KfacState"):
            return KfacState
        if module.split(".")[0] == "optax" and name in self._OPTAX:
            return self._OPTAX[name]
        return super().find_class(module, name)


def _read_object(zf: zipfile.ZipFile, key: str, unpickler=_NumpyUnpickler):
    """The object stored under ``key`` of an ``.npz``, unpickled restrictively."""
    with zf.open(f"{key}.npy") as fp:
        version = np.lib.format.read_magic(fp)
        if version == (1, 0):
            np.lib.format.read_array_header_1_0(fp)
        else:
            np.lib.format.read_array_header_2_0(fp)
        arr = unpickler(io.BytesIO(fp.read())).load()
    return arr.tolist() if isinstance(arr, np.ndarray) else arr


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def encode_opt_state(opt_state):
    """The optimizer state as builtins and NumPy arrays (``None`` stays ``None``)."""
    if opt_state is None:
        return None
    kind = {KfacState: "kfac", AdamState: "adam"}[type(opt_state)]
    return {"optimizer": kind, **_to_numpy(opt_state._asdict())}


def decode_opt_state(obj):
    """The port's state of what :class:`_OptStateUnpickler` returned.

    The port's tagged dict and a JAX ``KfacState`` become the port's classes,
    optax's ``(ScaleByAdamState, ScaleByScheduleState)`` its ``AdamState``;
    anything else is returned as it is, for ``validate_opt_state`` to drop.
    """
    if isinstance(obj, dict) and obj.get("optimizer") in ("kfac", "adam"):
        cls = KfacState if obj["optimizer"] == "kfac" else AdamState
        return cls(**{f: obj[f] for f in cls._fields})
    if isinstance(obj, (tuple, list)) and obj and isinstance(obj[0], AdamState):
        return obj[0]
    return obj


class StatsWriter:
    """CSV stats file with header-on-create, stderr mirroring and force-flush."""

    def __init__(self, stats_path: str | Path | AnyPath):
        self.stats_path = AnyPath(stats_path)
        self.stats_file = None
        self.hidden_fields: set[str] = set()

    def __enter__(self):
        exists = self.stats_path.exists()
        self.should_write_head = not exists or self._size() == 0
        self.stats_file = self.stats_path.open("a" if exists else "w", buffering=1)
        return self

    def _size(self) -> int:
        try:
            with self.stats_path.open("rb") as f:
                f.seek(0, 2)
                return f.tell()
        except OSError:
            return 0

    def hide(self, *args):
        """Hide these fields on stderr while still writing them to the CSV."""
        self.hidden_fields.update(args)

    def log(self, **kwargs):
        """Write the key-value pairs to the CSV and a human-readable stderr line."""
        if self.should_write_head:
            self.stats_file.write(",".join(kwargs.keys()) + "\n")
            self.should_write_head = False
        self.stats_file.write(",".join(kwargs.values()) + "\n")
        logger.info(
            ", ".join(f"{k}={v}" for k, v in kwargs.items() if k not in self.hidden_fields)
        )

    def force_flush(self):
        """Close and reopen the file (a reliable flush on remote filesystems)."""
        self.stats_file.close()
        self.stats_file = self.stats_path.open("a", buffering=1)

    def __exit__(self, exc_type, exc_value, traceback):
        self.stats_file.close()
        if self.should_write_head:
            self.stats_path.unlink(missing_ok=True)


class _NullWriter:
    """The stats sink of the ranks other than 0: accepts and drops."""

    def hide(self, *args) -> None:
        del args

    def log(self, **kwargs) -> None:
        del kwargs

    def force_flush(self) -> None:
        pass


class LogManager:
    """Save-dir lifecycle: auto-naming, config audit, checkpoint save/restore.

    With ``write_artifacts=False`` (every rank but 0) restoring works as usual
    but nothing is written: no run directory, no ``config.yml``, no checkpoint,
    and ``create_writer`` yields a sink that drops the rows.  ``now`` names a
    run without ``log.save_path`` (every rank must pass rank 0's time).
    """

    def __init__(self, cfg: Config, write_artifacts: bool = True,
                 now: datetime.datetime | None = None):
        self.write_artifacts = write_artifacts
        if cfg.log.save_path is None:
            timestamp = (now or datetime.datetime.now()).strftime("%Y%m%d_%H:%M:%S")
            self.save_path = AnyPath(
                f"DeepHall_n{sum(cfg.system.nspins)}l{cfg.system.flux}_{timestamp}"
            )
        else:
            self.save_path = AnyPath(cfg.log.save_path)
        if cfg.log.restore_path is None:
            self.restore_path = self.save_path
        else:
            self.restore_path = AnyPath(cfg.log.restore_path)
            if not self.restore_path.exists():
                logger.warning("Restore path %s does not exist!", self.restore_path)
        if self.write_artifacts:
            self.save_path.mkdir(parents=True, exist_ok=True)
        self.check_config(cfg)

    def check_config(self, cfg: Config) -> None:
        """Save the current config, diffing against the restored run's config."""
        if not self.write_artifacts:
            return
        restore_config_path = self.restore_path / "config.yml"
        current = [f"git_commit: {get_git_commit()}\n"]
        current.extend(to_yaml(cfg).splitlines(keepends=True))
        original = []
        if restore_config_path.exists():
            with restore_config_path.open() as f:
                original = f.readlines()
        sys.stderr.writelines(difflib.ndiff(original, current))
        with (self.save_path / "config.yml").open("w") as f:
            f.writelines(current)

    def save_checkpoint(self, step: int, state: CheckpointState, adapt: dict | None = None):
        """Save ``ckpt_{step:06d}.npz`` in the JAX package's format.

        ``state.params`` is the flax tree (``weights.params_to_flax``),
        ``state.data`` a NumPy array or this rank's tensor of walkers;
        ``adapt`` holds ``pmoves`` and ``t``.  Every rank calls it: a tensor is
        gathered from all ranks (a collective), then rank 0 writes the whole
        batch.
        """
        data = state.data
        if hasattr(data, "detach"):
            data = parallel.all_gather_rows(data.detach())
        if not self.write_artifacts:
            return
        ckpt_path = self.save_path / f"ckpt_{step:06d}.npz"
        logger.info("Saving checkpoint %s", ckpt_path)
        extras = {k: np.asarray(v) for k, v in (adapt or {}).items()}
        if hasattr(data, "detach"):
            data = data.cpu().numpy()
        with ckpt_path.open("wb") as f:
            np.savez_compressed(
                f,
                step=step,
                params=_object_array(state.params),
                data=np.asarray(data),
                opt_state=_object_array(encode_opt_state(state.opt_state)),
                mcmc_width=np.asarray(state.mcmc_width, dtype=np.float32).reshape(()),
                **extras,
            )

    def try_restore_checkpoint(self) -> tuple[int, CheckpointState, dict] | None:
        """Restore the newest readable checkpoint under ``restore_path``, if any."""
        if not self.restore_path.exists():
            return None
        if self.restore_path.is_file():
            return self.restore_checkpoint(self.restore_path)
        for ckpt_path in sorted(self.restore_path.glob("ckpt_*.npz"), key=str, reverse=True):
            try:
                return self.restore_checkpoint(ckpt_path)
            except (OSError, ValueError, KeyError, pickle.UnpicklingError, zipfile.BadZipFile) as e:
                logger.warning("Error restoring checkpoint %s: %s", ckpt_path, e)
        return None

    @staticmethod
    def restore_checkpoint(ckpt: str | Path | AnyPath) -> tuple[int, CheckpointState, dict]:
        """Restore one checkpoint file: ``(next_step, state, adapt)``.

        ``state.opt_state`` is the port's optimizer state with NumPy leaves, or
        ``None`` when it cannot be read (see the module docstring).  ``adapt``
        holds ``pmoves`` and ``t`` when present.
        """
        ckpt_path = AnyPath(ckpt)
        with ckpt_path.open("rb") as f:
            blob = f.read()
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            params = _read_object(zf, "params")
            try:
                opt_state = decode_opt_state(_read_object(zf, "opt_state", _OptStateUnpickler))
            except (pickle.UnpicklingError, AttributeError, EOFError, KeyError, TypeError, ValueError) as e:
                logger.warning("Could not unpickle opt_state (%s); reinitialising optimizer", e)
                opt_state = None
        adapt: dict = {}
        with np.load(io.BytesIO(blob), allow_pickle=False) as f:
            step = int(f["step"]) + 1
            data = np.asarray(f["data"])
            mcmc_width = np.asarray(f["mcmc_width"]).reshape(()).item()
            for key in ("pmoves", "t"):
                if key in f.files:
                    adapt[key] = np.asarray(f[key])
        if data.ndim == 4:  # older layouts with a leading device axis
            data = data.reshape(-1, *data.shape[-2:])
        logger.info("Restored checkpoint %s", ckpt_path)
        return step, CheckpointState(params, data, opt_state, np.float32(mcmc_width)), adapt

    @contextmanager
    def create_writer(self) -> Generator[StatsWriter | _NullWriter, None, None]:
        """A StatsWriter for ``train_stats.csv`` under the save dir (a sink
        that drops the rows where this process writes no artifacts)."""
        if not self.write_artifacts:
            yield _NullWriter()
            return
        with StatsWriter(self.save_path / "train_stats.csv") as writer:
            yield writer


def get_git_commit() -> str:
    """Current short git revision, if available."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=Path(__file__).parent,
            text=True,
            stderr=subprocess.DEVNULL,
        ).strip()
    except (subprocess.CalledProcessError, FileNotFoundError):
        return "''"
