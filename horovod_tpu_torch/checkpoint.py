"""Verified asynchronous checkpoints of the port — its copy of
``horovod_tpu/checkpoint.py`` over ``torch.save`` and ``zlib``.

``CheckpointManager.save(step, tree)`` copies every tensor of the tree to
the host on the caller's thread, so the copy is complete before ``save``
returns and the next step cannot tear it; a background thread then
``torch.save``s it into ``<dir>/<step>.tmp``, commits the directory with
``os.replace`` to ``<dir>/<step>``, and writes the integrity sidecar
``hvd_integrity.json`` in it (tmp file plus ``os.replace``): the JAX
package's schema ``{"algo", "step", "files": {name: {"size", "crc"}}}``
with its ``"crc32"`` algorithm (``zlib.crc32``, eight hex digits).

``restore()`` verifies the newest step against its sidecar and, on a
corrupt one (a torn write, a flipped bit, a truncated file, a damaged
sidecar), walks back to the newest step that verifies, raising
:class:`CheckpointCorruptError` when none is left. Each verification
bumps ``hvd_tpu_checkpoint_verify_total{result=}`` (ok / corrupt /
missing) and a corruption ``RecoveryStats.checkpoint_corruptions``.

In a multi-rank world the state is replicated: rank 0 writes, and every
rank may restore once rank 0's ``wait()`` has returned.

Sharded state (ZeRO, ``zero.py``) goes through :func:`save_sharded`: the
JAX function is single-controller (it fetches every device's piece);
here each rank writes its own pieces — :class:`Shard` (a box of a
global tensor) and :class:`Partial` (an addend of a sum over the ranks,
such as an error-feedback residual) — through its own
``CheckpointManager`` under ``<dir>/rank<r>``, so the crc32 sidecar and
the walk-back apply unchanged, and the boxes travel in the payload.
:func:`restore_sharded` cuts each target piece out of the recorded
boxes, so a checkpoint of one shard grid restores into another. Under a
hybrid ParallelSpec each rank's file also records its replica group (its
coordinates other than dp: ``"pp1"``), and a value is restored from one
group only: this rank's own when it wrote the value, else the first
group (in rank order) that did. With trees keyed by global names (a
pipeline stage's ``ZeroOptimizer.sharded_tree(names)``) a respec that
sheds dp replicas, grows them back or folds pipeline stages finds each
leaf in the rank files that wrote it: ``ZeroOptimizer.restore_template``
cuts this rank's pieces where only the dp grid changed, and takes whole
leaves to reshard where the pipeline layout changed.
``save_state``/``restore_state`` persist an elastic state.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import pickle
import queue as queue_mod
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from .common import basics
from .common import faults as faults_lib
from .common import metrics as metrics_lib
from .common import overlap as overlap_lib
from .common import tree as tree_lib
from .common.exceptions import CheckpointCorruptError

logger = logging.getLogger("horovod_tpu_torch")

SIDECAR_NAME = "hvd_integrity.json"
PAYLOAD_NAME = "tree.pt"
_CRC_ALGO = "crc32"

_M_VERIFY = metrics_lib.counter(
    "hvd_tpu_checkpoint_verify_total",
    "checkpoint integrity verifications by result (ok / corrupt / "
    "missing sidecar)",
    labels=("result",))
for _r in ("ok", "corrupt", "missing"):
    _M_VERIFY.labels(result=_r)
del _r


def _crc_file(path: str) -> str:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def _to_host(tree):
    """Every tensor of ``tree`` copied to host memory (detached)."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return x

    return tree_lib.map_tree(one, tree)


class CheckpointManager:
    """A versioned, asynchronous, garbage-collected checkpoint directory
    whose steps are verified on restore::

        mgr = hvd.CheckpointManager("/ckpts", max_to_keep=3)
        mgr.save(step, {"model": model.state_dict(),
                        "optimizer": opt.state_dict()})
        tree = mgr.restore()            # the newest verified step

    ``save_interval_steps`` skips a ``save`` whose step is less than that
    many past the last saved one (``force=True`` saves anyway);
    ``max_to_keep`` removes the oldest committed steps beyond it;
    ``verify`` (None: ``init(checkpoint_verify=)`` /
    ``HVD_TPU_CHECKPOINT_VERIFY``, default on) writes and checks the CRC
    sidecars. ``writer`` (None: this process is rank 0 or alone) says
    whether this process writes."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 1,
                 verify: Optional[bool] = None,
                 writer: Optional[bool] = None):
        if verify is None:
            if basics.is_initialized():
                verify = basics.context().config.checkpoint_verify
            else:
                from .common.config import _truthy, runtime_env

                verify = _truthy(runtime_env("CHECKPOINT_VERIFY") or "1")
        self.verify = bool(verify)
        self.max_to_keep = int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)
        self.directory = os.path.abspath(directory)
        #: The step the most recent restore() loaded (after any walk-back).
        self.last_restored_step: Optional[int] = None
        #: Seconds the background thread spent writing each saved step,
        #: and each step's payload bytes.
        self.write_seconds: Dict[int, float] = {}
        self.payload_bytes: Dict[int, int] = {}
        self._last_saved: Optional[int] = None
        if writer is None:
            writer = basics.rank() == 0 if basics.is_initialized() else True
        self._writer = bool(writer)
        self._error: Optional[BaseException] = None
        self._jobs: "queue_mod.Queue" = queue_mod.Queue()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(self.directory, exist_ok=True)

    # -- write side ---------------------------------------------------------

    def save(self, step: int, tree: Any, force: bool = False) -> bool:
        """Save ``tree`` at ``step``: the host copy now, the files in the
        background. Returns False when the save interval skipped it."""
        step = int(step)
        self._raise_pending()
        if not force and self._last_saved is not None and \
                step - self._last_saved < self.save_interval_steps:
            return False
        if step in self.all_steps():
            raise ValueError(f"checkpoint step {step} already exists under "
                             f"{self.directory}")
        host = _to_host(tree)
        self._last_saved = step
        if not self._writer:
            return True
        if self._thread is None:
            self._thread = threading.Thread(target=self._drain, daemon=True,
                                            name="hvd-checkpoint-writer")
            self._thread.start()
        self._jobs.put((step, host))
        return True

    def _drain(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                self._write(*job)
            except Exception as e:  # raised on the next call
                self._error = e
            finally:
                self._jobs.task_done()

    def _write(self, step: int, host: Any) -> None:
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, PAYLOAD_NAME)
        with open(path, "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        if self.verify:
            self._write_sidecar(step)
        if faults_lib.active():
            spec = faults_lib.maybe_checkpoint_corrupt()
            if spec is not None:
                self._corrupt_step(step, spec.mode or "bitflip")
        self.write_seconds[step] = time.perf_counter() - t0
        self.payload_bytes[step] = os.path.getsize(
            os.path.join(final, PAYLOAD_NAME))
        self._collect()

    def _collect(self) -> None:
        """Remove the oldest committed steps beyond ``max_to_keep``."""
        steps = self.all_steps()
        for step in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def wait(self) -> None:
        """Block until every save so far is on disk (and verified
        sidecars written); raises what a background write raised."""
        if self._thread is not None:
            self._jobs.join()
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- integrity sidecars -------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _sidecar_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), SIDECAR_NAME)

    def _manifest(self, step: int) -> Dict[str, Dict[str, Any]]:
        root = self._step_dir(step)
        files: Dict[str, Dict[str, Any]] = {}
        for dirpath, _dirs, names in os.walk(root):
            for name in sorted(names):
                if name == SIDECAR_NAME or name.endswith(".tmp"):
                    continue
                path = os.path.join(dirpath, name)
                files[os.path.relpath(path, root)] = {
                    "size": os.path.getsize(path), "crc": _crc_file(path)}
        return files

    def _write_sidecar(self, step: int) -> None:
        sidecar = self._sidecar_path(step)
        payload = {"algo": _CRC_ALGO, "step": int(step),
                   "files": self._manifest(step)}
        tmp = sidecar + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, sidecar)

    def verify_step(self, step: int) -> str:
        """Verify one step against its sidecar: ``"ok"`` | ``"corrupt"``
        (size or CRC mismatch, a missing payload file, an unreadable
        sidecar) | ``"missing"`` (no sidecar). Counted in
        ``hvd_tpu_checkpoint_verify_total{result=}``."""
        result = self._verify_quiet(step)
        _M_VERIFY.labels(result=result).inc()
        if result == "corrupt":
            faults_lib.stats.bump("checkpoint_corruptions")
        return result

    def _verify_quiet(self, step: int) -> str:
        try:
            with open(self._sidecar_path(step)) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return "missing"
        except (OSError, ValueError):
            return "corrupt"
        if payload.get("algo") != _CRC_ALGO:
            # Another writer's algorithm cannot be checked here.
            return "missing"
        root = self._step_dir(step)
        for rel, meta in payload.get("files", {}).items():
            path = os.path.join(root, rel)
            try:
                if os.path.getsize(path) != meta["size"] or \
                        _crc_file(path) != meta["crc"]:
                    return "corrupt"
            except OSError:
                return "corrupt"
        return "ok"

    def _corrupt_step(self, step: int, mode: str = "bitflip") -> None:
        """Damage a committed step (for tests and drills): ``bitflip``
        flips the middle byte of the largest payload file, ``truncate``
        halves it, ``sidecar`` corrupts the manifest itself."""
        root = self._step_dir(step)
        if mode == "sidecar":
            with open(self._sidecar_path(step), "w") as f:
                f.write("{corrupt")
            return
        best, best_size = None, -1
        for dirpath, _dirs, names in os.walk(root):
            for name in names:
                if name == SIDECAR_NAME:
                    continue
                p = os.path.join(dirpath, name)
                s = os.path.getsize(p)
                if s > best_size:
                    best, best_size = p, s
        if best is None:
            return
        logger.warning("corrupting checkpoint step %d (%s, %s)", step, mode,
                       os.path.relpath(best, root))
        with open(best, "r+b") as f:
            if mode == "truncate":
                f.truncate(max(best_size // 2, 0))
            else:
                f.seek(best_size // 2)
                b = f.read(1)
                f.seek(best_size // 2)
                f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))

    # -- read side ----------------------------------------------------------

    def all_steps(self) -> List[int]:
        """The committed steps, oldest first."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, target: Any = None,
                verify: bool = True) -> Any:
        """Load ``step`` (default: the newest verified step, walking back
        past corrupt ones). A pinned ``step`` that fails verification
        raises :class:`CheckpointCorruptError` (no silent substitute);
        a step without a sidecar loads with a warning. ``target`` (a tree
        of the same structure) gives each tensor its dtype and device;
        without it the tensors come back on the host as saved.
        ``verify=False`` (or a manager built with ``verify=False``) loads
        without checking."""
        self.wait()
        check = self.verify and verify
        if step is None:
            step = self._latest_verified_step(check)
        elif check and self.verify_step(step) == "corrupt":
            raise CheckpointCorruptError(
                f"checkpoint step {step} under {self.directory} failed "
                f"integrity verification ({_CRC_ALGO}+size sidecar "
                "mismatch); refusing to load a corrupt checkpoint that "
                "was pinned explicitly")
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        self.last_restored_step = step
        with open(os.path.join(self._step_dir(step), PAYLOAD_NAME),
                  "rb") as f:
            tree = torch.load(f, map_location="cpu", weights_only=False)
        if target is None:
            return tree
        return _like(tree, target)

    def latest_verified_step(self) -> Optional[int]:
        """The step a default ``restore()`` would load."""
        self.wait()
        return self._latest_verified_step(self.verify)

    def _latest_verified_step(self, check: bool) -> Optional[int]:
        """The newest step that passes verification: the walk-back
        (corrupt steps are skipped with a warning, never deleted)."""
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None
        if not check:
            return steps[0]
        corrupt = []
        for step in steps:
            result = self.verify_step(step)
            if result == "corrupt":
                corrupt.append(step)
                logger.warning(
                    "checkpoint step %d failed integrity verification "
                    "(%s+size sidecar mismatch); walking back to the "
                    "previous verified step", step, _CRC_ALGO)
                continue
            if result == "missing":
                logger.warning("checkpoint step %d has no integrity "
                               "sidecar; restoring unverified", step)
            if corrupt:
                logger.warning("checkpoint: restored step %d after "
                               "skipping corrupt step(s) %s", step, corrupt)
            return step
        raise CheckpointCorruptError(
            f"every checkpoint under {self.directory} failed integrity "
            f"verification (corrupt steps: {corrupt}); no last-good step "
            "to fall back to")

    def close(self) -> None:
        """Finish the pending writes and stop the writer thread."""
        if self._thread is not None:
            self._jobs.join()
            self._jobs.put(None)
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _like(tree, target):
    """``tree`` with each tensor given the dtype and device of the tensor
    at the same place in ``target``."""
    if isinstance(target, torch.Tensor):
        return torch.as_tensor(tree).to(device=target.device,
                                        dtype=target.dtype)
    if isinstance(target, dict):
        return type(tree)((k, _like(v, target[k]) if k in target else v)
                          for k, v in tree.items())
    if isinstance(target, (list, tuple)) and isinstance(tree, (list, tuple)):
        parts = [_like(a, b) for a, b in zip(tree, target)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return tree


class ObjectStore:
    """A pickle store for small host objects (RNG state, epoch counters,
    data-loader cursors) beside the tensor checkpoints."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pkl")

    def put(self, name: str, obj: Any) -> None:
        tmp = self._path(name) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, self._path(name))

    def get(self, name: str, default: Any = None) -> Any:
        try:
            with open(self._path(name), "rb") as f:
                return pickle.load(f)
        except FileNotFoundError:
            return default

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))


# -- sharded state: each rank writes its own pieces --------------------------

Box = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass
class Shard:
    """This rank's piece of a global tensor of ``shape``: ``data`` holds
    the elements of ``box`` (``(start, stop)`` a dim)."""

    data: torch.Tensor
    box: Box
    shape: Tuple[int, ...]


@dataclasses.dataclass
class Partial:
    """This rank's addend of a tensor whose value is the SUM over the
    ranks of its group (an error-feedback residual): restored as the sum
    where the template's ``primary`` is true (None: on rank 0) and zeros
    elsewhere."""

    data: torch.Tensor
    primary: Optional[bool] = None


def _pieces_to_host(tree):
    """``tree`` with every tensor, Shard and Partial copied to host
    memory."""
    if isinstance(tree, Shard):
        return Shard(tree.data.detach().to("cpu", copy=True),
                     tuple(tuple(int(v) for v in b) for b in tree.box),
                     tuple(int(d) for d in tree.shape))
    if isinstance(tree, Partial):
        return Partial(tree.data.detach().to("cpu", copy=True),
                       tree.primary)
    if isinstance(tree, dict):
        return type(tree)((k, _pieces_to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_pieces_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _world() -> Tuple[int, int]:
    if basics.is_initialized():
        return basics.rank(), basics.size()
    return 0, 1


def _group(rank: Optional[int] = None) -> str:
    """A rank's replica group (default this rank's): its coordinates
    other than dp under the world's ParallelSpec (``"pp1"``,
    ``"pp0/tp1"``), ``""`` without one."""
    spec = basics.context().parallel_spec if basics.is_initialized() \
        else None
    if spec is None:
        return ""
    rank = basics.rank() if rank is None else rank
    return "/".join(f"{r}{i}" for r, i in spec.coords(rank).items()
                    if r != "dp")


def layout_changed(groups: List[str]) -> bool:
    """Whether the replica groups of a checkpoint's writing ranks
    (:func:`restore_sharded` hands them to a callable template) differ
    from this world's: a respec that folded or unfolded pp (or tp, sp)
    rather than one that changed only the dp grid."""
    _, size = _world()
    return set(groups) != {_group(r) for r in range(size)}


def save_sharded(tree: Any, directory: str, step: int,
                 max_to_keep: int = 5) -> None:
    """Persist this rank's pieces of a sharded state (ZeRO,
    ``ZeroOptimizer.sharded_tree()``) without gathering: every rank
    calls it with its own tree, whose leaves are :class:`Shard`,
    :class:`Partial`, or replicated values (any rank's copy; restore
    takes rank 0's). Rank ``r`` writes ``<dir>/rank<r>/<step>`` through a
    ``CheckpointManager`` (CRC sidecar, ``max_to_keep``), replacing a
    stale copy of the same step; returns once every rank's files are
    committed."""
    rank, size = _world()
    mgr = CheckpointManager(os.path.join(directory, f"rank{rank}"),
                            max_to_keep=max_to_keep, writer=True)
    try:
        stale = mgr._step_dir(step)
        if os.path.isdir(stale):
            shutil.rmtree(stale, ignore_errors=True)
        mgr.save(step, {"world": size, "rank": rank, "group": _group(),
                        "tree": _pieces_to_host(tree)}, force=True)
        mgr.wait()
    finally:
        mgr.close()
    if size > 1:
        import torch.distributed as dist

        from .common import autoscale as autoscale_lib

        overlap_lib.drain_before_collective()
        with autoscale_lib.comm_clock.waiting():
            dist.barrier()


def _load_sharded(directory: str):
    """The newest step at which every writing rank's files verify (the
    walk-back over the set), as ``(step, [payload of rank r])``."""
    m0 = CheckpointManager(os.path.join(directory, "rank0"), writer=False)
    steps = sorted(m0.all_steps(), reverse=True)
    if not steps:
        raise FileNotFoundError(f"no sharded checkpoints under {directory}")
    corrupt = []
    for step in steps:
        if m0.verify and m0.verify_step(step) == "corrupt":
            corrupt.append(step)
            continue
        first = m0.restore(step, verify=False)
        mgrs = [CheckpointManager(os.path.join(directory, f"rank{r}"),
                                  writer=False)
                for r in range(1, int(first["world"]))]
        if any(step not in m.all_steps() or (
                m.verify and m.verify_step(step) == "corrupt")
                for m in mgrs):
            corrupt.append(step)
            continue
        if corrupt:
            logger.warning("sharded checkpoint: restored step %d after "
                           "skipping step(s) %s", step, corrupt)
        return step, [first] + [m.restore(step, verify=False) for m in mgrs]
    raise CheckpointCorruptError(
        f"no sharded checkpoint step under {directory} verifies on every "
        f"rank (skipped: {corrupt})")


def _assemble(target: Shard, sources: List[Shard]) -> torch.Tensor:
    """The elements of ``target.box`` cut out of the recorded pieces
    (duplicates dedupe by box); every cell must be covered."""
    if tuple(target.shape) != tuple(sources[0].shape):
        raise ValueError(
            f"checkpoint global shape {tuple(sources[0].shape)} vs template "
            f"{tuple(target.shape)}: reshard-on-restore remaps shard "
            "grids, not shapes; a changed shape goes through the gathered "
            "full state (ZeroOptimizer.gather_state)")
    by_box = {}
    for src in sources:
        by_box.setdefault(tuple(tuple(b) for b in src.box), src.data)
    tbox = tuple(tuple(b) for b in target.box)
    if tbox in by_box:
        return by_box[tbox]
    val = torch.zeros([hi - lo for lo, hi in tbox],
                      dtype=sources[0].data.dtype)
    covered = 0
    for sbox, data in by_box.items():
        ov = [(max(tl, sl), min(th, sh)) for (tl, th), (sl, sh)
              in zip(tbox, sbox)]
        if any(hi <= lo for lo, hi in ov):
            continue
        src = tuple(slice(lo - sl, hi - sl) for (lo, hi), (sl, _)
                    in zip(ov, sbox))
        dst = tuple(slice(lo - tl, hi - tl) for (lo, hi), (tl, _)
                    in zip(ov, tbox))
        val[dst] = data[src]
        covered += math.prod(hi - lo for lo, hi in ov)
    if covered != val.numel():
        raise ValueError(f"target piece {tbox} covered {covered}/"
                         f"{val.numel()} cells by the checkpoint's pieces")
    return val


def _rebuild(template, sources: List[Tuple[str, Any]], rank: int,
             group: str):
    """The restored value of ``template`` from the writing ranks' values
    at the same place (``(group, value)`` in rank order; a dict key is
    looked up in the ranks that hold it). A piece or value is taken from
    one group: ``group`` (this rank's) when it wrote one, else the first
    group that did."""
    if isinstance(template, dict):
        out = []
        for k, v in template.items():
            held = [(g, s[k]) for g, s in sources
                    if isinstance(s, dict) and k in s]
            if not held:
                raise KeyError(f"the sharded checkpoint holds no value for "
                               f"{k!r} on any rank")
            out.append((k, _rebuild(v, held, rank, group)))
        return type(template)(out)
    if isinstance(template, (list, tuple)):
        return type(template)(
            _rebuild(v, [(g, s[i]) for g, s in sources], rank, group)
            for i, v in enumerate(template))
    pick = group if any(g == group for g, _ in sources) else sources[0][0]
    values = [v for g, v in sources if g == pick]
    if isinstance(template, Shard):
        val = _assemble(template, values)
        return val.to(device=template.data.device,
                      dtype=template.data.dtype)
    if isinstance(template, Partial):
        # Summed in rank order in the addends' dtype, as
        # ZeroOptimizer.gather_state sums them.
        total = values[0].data.clone()
        for v in values[1:]:
            total += v.data
        primary = rank == 0 if template.primary is None \
            else template.primary
        val = total if primary else torch.zeros_like(total)
        return val.to(device=template.data.device,
                      dtype=template.data.dtype)
    return _like(values[0], template) \
        if isinstance(template, torch.Tensor) else values[0]


def restore_sharded(template: Any, directory: str):
    """Inverse of :func:`save_sharded`: ``template`` is this rank's tree
    of the resumed world (e.g. a fresh optimizer's ``sharded_tree()``, or
    a callable that takes the writing ranks' replica groups, in rank
    order, and returns the tree: ``ZeroOptimizer.restore_template``),
    whose :class:`Shard` leaves give the boxes wanted here — the same
    grid or another one (a resized world), cut out of the recorded
    pieces. Returns ``(tree, step)`` with tensors in place of the pieces
    (each on its template's device and dtype) for the newest step that
    verifies on every writing rank."""
    rank, _ = _world()
    step, payloads = _load_sharded(directory)
    if callable(template):
        template = template([p.get("group", "") for p in payloads])
    return _rebuild(template, [(p.get("group", ""), p["tree"])
                               for p in payloads], rank, _group()), step


# -- an elastic state's persistence ------------------------------------------

# The step a state_objects record belongs to (beside the state's own
# attributes, one of which may well be called "step").
_SAVED_STEP = "saved_step"


def _holds_tensor(v) -> bool:
    return any(isinstance(x, torch.Tensor) for x in tree_lib.leaves(v))


def _state_dir(directory: str, rank: int, size: int) -> str:
    """A world of one writes ``directory`` itself (the JAX layout); in a
    multi-rank world rank r writes ``<dir>/rank<r>``: each rank persists
    its own state (an int8_ef residual, ZeRO shards)."""
    return directory if size == 1 else os.path.join(directory,
                                                    f"rank{rank}")


def save_state(state, directory: str, step: int,
               max_to_keep: int = 5) -> None:
    """Persist an elastic state's last COMMITTED snapshot (``TorchState``
    or ``ObjectState``: ``state.committed_items()``) at ``step``, so a
    job resumes across full restarts: tensor-bearing values (state
    dicts) through a :class:`CheckpointManager` (CRC sidecar, walk-back,
    ``max_to_keep``), the other values through an :class:`ObjectStore`
    as ``state_objects_<step>`` (pruned with the manager's steps). Every
    rank of a multi-rank world calls it and writes its own directory
    (see :func:`_state_dir`); no collective runs, so a preemption
    callback on one rank may call it alone. A stale copy of the same
    step is replaced."""
    rank, size = _world()
    root = _state_dir(directory, rank, size)
    arrays, objects = {}, {}
    for k, v in state.committed_items():
        (arrays if _holds_tensor(v) else objects)[k] = v
    mgr = CheckpointManager(root, max_to_keep=max_to_keep, writer=True)
    try:
        stale = mgr._step_dir(int(step))
        if os.path.isdir(stale):
            shutil.rmtree(stale, ignore_errors=True)
        mgr.save(step, {"world": size, "rank": rank, "arrays": arrays},
                 force=True)
        mgr.wait()
        kept_steps = mgr.all_steps()
    finally:
        mgr.close()
    store = ObjectStore(root)
    record = {_SAVED_STEP: int(step), "objects": objects}
    store.put(f"state_objects_{step}", record)
    store.put("state_objects", record)
    live = {int(s) for s in kept_steps}
    for name in os.listdir(store.directory):
        m = re.fullmatch(r"state_objects_(\d+)\.pkl", name)
        if m and int(m.group(1)) not in live:
            try:
                os.remove(os.path.join(store.directory, name))
            except OSError:
                pass


def _latest_state_step(directory: str, rank: int, size: int
                       ) -> Optional[int]:
    """The newest step whose files verify on every rank of a world of
    ``size`` (the walk-back over the set). Each rank verifies its own
    directory; in a multi-rank world the ranks agree through
    ``allgather_object``, so every rank calls this together."""
    mgr = CheckpointManager(_state_dir(directory, rank, size), writer=False)
    steps = set(mgr.all_steps())
    if size > 1:
        from .functions import allgather_object

        steps = set.intersection(*(set(s) for s in allgather_object(
            sorted(steps), name="restore_state.steps")))
    skipped = []
    for step in sorted(steps, reverse=True):
        ok = not mgr.verify or mgr.verify_step(step) != "corrupt"
        if size > 1:
            from .functions import allgather_object

            ok = all(allgather_object(ok, name="restore_state.ok"))
        if ok:
            if skipped:
                logger.warning("state checkpoint: restored step %d after "
                               "skipping step(s) %s", step, skipped)
            return step
        skipped.append(step)
    if skipped:
        raise CheckpointCorruptError(
            f"no state checkpoint step under {directory} verifies on "
            f"every rank (skipped: {skipped})")
    return None


def restore_state(state, directory: str) -> int:
    """Inverse of :func:`save_state` (every rank of a multi-rank world
    calls it together): load the newest step that verifies (on every
    rank: the walk-back) into ``state``
    (a ``TorchState`` loads each state dict into its model, optimizer or
    sampler; other values become attributes), with the host objects of
    the SAME step, make it the committed snapshot and return the step.
    Raises ``FileNotFoundError`` when nothing was saved."""
    rank, size = _world()
    root = _state_dir(directory, rank, size)
    step = _latest_state_step(directory, rank, size)
    if step is None:
        raise FileNotFoundError(f"no state checkpoints under {directory}")
    mgr = CheckpointManager(root, writer=False)
    try:
        restored = mgr.restore(step, verify=False)
    finally:
        mgr.close()
    load = getattr(state, "load_committed", None)
    for k, v in restored["arrays"].items():
        if load is not None:
            load(k, v)
        else:
            setattr(state, k, v)
    store = ObjectStore(root)
    record = store.get(f"state_objects_{step}")
    if record is None:
        record = store.get("state_objects", {"objects": {}})
    for k, v in record["objects"].items():
        setattr(state, k, v)
    state.save()        # the committed snapshot = what was restored
    return int(step)
