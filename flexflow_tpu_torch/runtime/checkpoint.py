"""Training-state checkpoints: parameters, optimizer state and step, with a
background writer for the fit loop (port of flexflow_tpu/runtime/
checkpoint.py, on its npz layout).

The layout is the JAX package's, byte for byte, so a checkpoint written by
either package restores in the other:

    <dir>/step_<N>/arr_<i>.npy   one raw .npy per leaf, in sorted key order
    <dir>/step_<N>/keys.json     the integrity manifest (runtime/integrity.py)
    <dir>/step_<N>/meta.json     {"step", "backend": "npz", "extra"}

A state tree is flattened to '/'-joined key paths: `params/n3`,
`opt_state/m/n3`, `opt_state/v/n3`, `opt_state/step` (a 0-d int32), the
parameter keys `n{idx}` being the weight nodes' indices, which both
packages' builders assign alike. The JAX package's other backend, orbax,
is a JAX library: the port refuses it (`checkpoint_backend="orbax"` raises
ValueError, and a step orbax wrote raises CheckpointError naming it).

Three layers:

1. `CheckpointManager`: a step-indexed directory with retention and atomic
   commits: each writer fills a `step_N.tmp.<pid>_<seq>` directory of its
   own and renames it into place through `with_retry` (runtime/retry.py),
   the fault schedule's `ckpt_write` site injecting one transient there.
   Restores verify every leaf, quarantine a corrupt latest step as
   `step_N.corrupt` and fall back to the newest step that verifies
   (`last_restore_report` says what happened).
2. `AsyncCheckpointWriter`: `submit` copies the state on the device on the
   training stream (so the next window may overwrite it in place),
   records an event, and starts the copy to pinned host buffers on a side
   stream that waits on it; the serialization and the commit run on a
   writer thread. The device and host buffers are allocated at the first
   submit and reused: a submit first waits until the writer has committed
   the snapshot before it (one snapshot in flight), which is the training
   thread's only stall. A failed write surfaces at the next boundary as a
   BackgroundFault (with a FaultChannel) naming `checkpoint_writer`. The
   writer thread issues no collective and launches no kernel.
3. `TrainingCheckpointer`: the fit loop's session: the interval policy (a
   crossing, as a window advances several steps at once), full-resume
   snapshots (the state, the dataloader's epoch and cursor, and the
   torch.Generator's state under `extra["torch_rng"]`), and `resume_state`
   for `fit(resume=True)`. The JAX package keeps its jax.random key under
   `extra["rng"]`; neither stream can continue the other, so each
   package's resume refuses the other's fit-loop snapshot, while params,
   optimizer state and step cross both ways.

Restores return numpy trees; FFModel copies them into its tensors in
place, so the CUDA graphs captured over those tensors stay valid.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import re
import shutil
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.runtime.integrity import (
    IntegrityViolation,
    leaf_digest,
    manifest_of,
    verify_and_load_leaves,
    warn_legacy_once,
)
from flexflow_tpu_torch.runtime.retry import with_retry

ORBAX_REFUSED = (
    "checkpoint_backend='orbax': orbax.checkpoint is a JAX library with no torch "
    "counterpart; the port writes and reads the npz layout only")
# threads that write one step's leaves (np.save and zlib.crc32 release the
# interpreter lock)
IO_WORKERS = 4


class CheckpointError(RuntimeError):
    """A structured checkpoint failure: the directory, the step asked for,
    and the steps available, so recovery can decide without parsing text."""

    def __init__(
        self,
        message: str,
        *,
        directory: Optional[str] = None,
        step: Optional[int] = None,
        available_steps: Optional[List[int]] = None,
    ) -> None:
        parts = [message]
        if directory is not None:
            parts.append(f"directory={directory!r}")
        if step is not None:
            parts.append(f"step={step}")
        if available_steps is not None:
            parts.append(f"available_steps={available_steps}")
        super().__init__("; ".join(parts))
        self.directory = directory
        self.step = step
        self.available_steps = available_steps


class CheckpointCorruptError(CheckpointError):
    """A step failed integrity verification (a truncated leaf, a checksum,
    dtype or shape mismatch, an unreadable manifest). `leaf` names the
    first bad leaf where one was found, `reason` the diagnosis. A restore
    of the latest step quarantines it and falls back; an explicitly
    requested step raises this."""

    def __init__(
        self,
        message: str,
        *,
        reason: str = "",
        leaf: Optional[str] = None,
        directory: Optional[str] = None,
        step: Optional[int] = None,
        available_steps: Optional[List[int]] = None,
    ) -> None:
        super().__init__(message, directory=directory, step=step, available_steps=available_steps)
        self.reason = reason or message
        self.leaf = leaf


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"checkpoint keys may not contain '/': {k}")
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    if list(flat.keys()) == [""]:
        return flat[""]
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _tree_paths(tree: Any, prefix: str = "") -> Iterator[str]:
    """Leaf key paths of a nested dict tree: the structure `restore`
    checks against a template."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _tree_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1]


_NUMPY_DTYPES = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16", torch.int8: "int8",
    torch.uint8: "uint8", torch.bool: "bool",
}


def numpy_dtype(leaf) -> np.dtype:
    """The numpy dtype a tensor or array leaf is stored as; a dtype numpy
    has no type for (bfloat16) raises."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NUMPY_DTYPES:
            raise TypeError(f"a checkpoint leaf of {leaf.dtype} has no numpy dtype: keep the "
                            "state in float32")
        return np.dtype(_NUMPY_DTYPES[leaf.dtype])
    return np.asarray(leaf).dtype


def host_array(leaf) -> np.ndarray:
    """A leaf's values on the host: a tensor's (copied off its device; a
    CPU tensor's own memory), an array as it is."""
    if isinstance(leaf, torch.Tensor):
        numpy_dtype(leaf)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


_TMP_SEQ = itertools.count()

# tmp dirs with a write in flight in this process: another writer's _gc must
# not reap them mid-serialization. Writers of other processes are covered
# by the pid in the tmp suffix: _gc reaps a suffixed tmp only once its pid
# is dead.
_LIVE_TMPS: set = set()
_LIVE_TMPS_LOCK = threading.Lock()

_TMP_SUFFIX_RE = re.compile(r"step_\d+\.tmp\.(\d+)_\d+$")


def _tmp_owner_alive(name: str) -> bool:
    """True when a suffixed tmp dir's owning process still exists (its
    write may be in flight). A bare legacy `step_N.tmp` has no owner and is
    always reapable; so is one of this process not registered live."""
    m = _TMP_SUFFIX_RE.search(name)
    if m is None:
        return False
    pid = int(m.group(1))
    if pid == os.getpid():
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _commit_rename(src: str, dst: str) -> None:
    """The atomic commit: clear a committed dst (a losing concurrent writer
    replaces it rather than failing on ENOTEMPTY), then rename. Runs inside
    the retry, so a racing writer's fresh dst is cleared again."""
    shutil.rmtree(dst, ignore_errors=True)
    os.replace(src, dst)


def _maybe_faulted_commit(step: int):
    """_commit_rename, wrapped with the fault schedule's `ckpt_write` site
    where it fires for this step: the first attempt raises a transient
    InjectedFault (an OSError the retry absorbs), the next goes through."""
    from flexflow_tpu_torch.runtime.fault import InjectedFault, active_schedule

    sched = active_schedule()
    if sched is None or not sched.fire_once("ckpt_write", step):
        return _commit_rename
    state = {"armed": True}

    def commit(src, dst):
        if state.pop("armed", False):
            raise InjectedFault("ckpt_write", step)
        return _commit_rename(src, dst)

    return commit


class CheckpointManager:
    """A step-indexed checkpoint directory with retention (see the module
    docstring for the layout). A crash mid-save leaves a `.tmp` directory
    that never counts as a checkpoint (`all_steps` needs the committed name
    and meta.json) and is removed by a later save."""

    def __init__(self, directory: str, max_to_keep: int = 3, backend: Optional[str] = None) -> None:
        if backend == "orbax":
            raise ValueError(ORBAX_REFUSED)
        if backend not in (None, "", "npz"):
            raise ValueError(f"unknown checkpoint backend {backend!r} (the port writes 'npz')")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.backend = "npz"
        # the most recent restore's integrity and fallback record
        self.last_restore_report: Optional[Dict[str, Any]] = None
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _gc(self) -> None:
        # leftovers of a crash mid-save first: a step_<N>.tmp[.*] nobody
        # writes any more; then the quarantined steps, bounded by the same
        # retention; then the oldest committed steps
        corrupt = []
        with _LIVE_TMPS_LOCK:
            live = set(_LIVE_TMPS)
        for name in os.listdir(self.directory):
            if re.fullmatch(r"step_\d+\.tmp(\..+)?", name):
                path = os.path.join(self.directory, name)
                if path in live or _tmp_owner_alive(name):
                    continue
                shutil.rmtree(path, ignore_errors=True)
            m = re.fullmatch(r"step_(\d+)\.corrupt", name)
            if m:
                corrupt.append(int(m.group(1)))
        corrupt.sort()
        while len(corrupt) > self.max_to_keep:
            shutil.rmtree(os.path.join(self.directory, f"step_{corrupt.pop(0)}.corrupt"),
                          ignore_errors=True)
        steps = self.all_steps()
        while len(steps) > self.max_to_keep:
            shutil.rmtree(self._step_dir(steps.pop(0)), ignore_errors=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """The synchronous save: every leaf copied to the host, then
        serialized and committed."""
        state = {"params": params}
        if opt_state is not None:
            state["opt_state"] = opt_state
        flat = {k: host_array(v) for k, v in _flatten(state).items()}
        return self.write_host_state(step, flat, extra)

    def write_host_state(self, step: int, flat: Dict[str, np.ndarray],
                         extra: Optional[Dict[str, Any]], timings: Optional[dict] = None) -> str:
        """Serialize flat host arrays as step `step` and commit it. timings:
        a dict that receives the serialize and commit seconds."""
        need = sum(a.nbytes for a in flat.values())
        free = shutil.disk_usage(self.directory).free
        if free < need:
            raise CheckpointError(f"step {step} needs {need} bytes, the filesystem has {free} "
                                  "free", directory=self.directory, step=step)
        d = self._step_dir(step)
        # a tmp of its own per writer: two writers of one step never
        # interleave files in one tmp; each commits a whole tree, the last
        # rename wins
        tmp = f"{d}.tmp.{os.getpid()}_{next(_TMP_SEQ)}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with _LIVE_TMPS_LOCK:
            _LIVE_TMPS.add(tmp)
        try:
            t0 = time.perf_counter()
            order = sorted(flat)

            def write_leaf(item):
                i, key = item
                np.save(os.path.join(tmp, f"arr_{i}.npy"), flat[key])
                return leaf_digest(flat[key])

            with ThreadPoolExecutor(max_workers=IO_WORKERS) as pool:
                digests = dict(zip(order, pool.map(write_leaf, enumerate(order))))
            with open(os.path.join(tmp, "keys.json"), "w") as f:
                json.dump(manifest_of(order, digests), f)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "backend": self.backend, "extra": extra or {}}, f)
            t1 = time.perf_counter()
            with_retry(_maybe_faulted_commit(step), tmp, d, description="checkpoint commit")
            self._gc()
            if timings is not None:
                timings.update(serialize_s=t1 - t0, commit_s=time.perf_counter() - t1,
                               bytes=need)
            return d
        finally:
            with _LIVE_TMPS_LOCK:
                _LIVE_TMPS.discard(tmp)

    # -- restore -------------------------------------------------------------

    def _read_meta(self, d: str) -> dict:
        def read():
            with open(os.path.join(d, "meta.json")) as f:
                return json.load(f)

        return with_retry(read, description="checkpoint meta read")

    def restore(self, step: Optional[int] = None, template: Any = None,
                verify_integrity: bool = True) -> Tuple[int, Any, Any, Dict[str, Any]]:
        """(step, params, opt_state, extra), the trees as numpy arrays.
        `template` (a {"params": ..., "opt_state": ...} tree of tensors or
        arrays) checks the restored tree's key paths (missing or extra
        paths raise CheckpointError naming them) and casts each leaf to
        the template leaf's dtype.

        Every leaf is verified against the manifest (verify_integrity). A
        corrupt step raises CheckpointCorruptError when it was asked for;
        as the latest step (step=None) it is quarantined as
        `step_N.corrupt` and the walk falls back to the newest step that
        verifies, recorded in `last_restore_report` ({"restored_step",
        "requested_step", "quarantined": [{"step", "reason", "leaf"}],
        "integrity", "legacy", "verified"})."""
        self.last_restore_report = None
        available = self.all_steps()
        if not available:
            raise CheckpointError("no checkpoints found", directory=self.directory,
                                  available_steps=available)
        requested = step
        quarantined: List[Dict[str, Any]] = []
        while True:
            s = requested if requested is not None else available[-1]
            if s not in available:
                raise CheckpointError("checkpoint step not found", directory=self.directory,
                                      step=s, available_steps=available)
            try:
                state, meta, integrity_mode = self._load_step(s, verify_integrity)
                break
            except CheckpointCorruptError as e:
                if requested is not None or not verify_integrity:
                    raise
                quarantined.append({"step": s, "reason": e.reason, "leaf": e.leaf})
                self._quarantine(s, e)
                available = self.all_steps()
                if s in available:
                    # neither moved nor removed (a read-only mount): the walk
                    # cannot make progress
                    raise CheckpointError(
                        f"corrupt checkpoint could not be quarantined (directory not "
                        f"writable?): {e.reason}", directory=self.directory, step=s,
                        available_steps=available) from e
                if not available:
                    raise CheckpointError(
                        "no checkpoint survived integrity verification (quarantined steps: "
                        f"{[q['step'] for q in quarantined]})", directory=self.directory,
                        step=requested, available_steps=available) from e
        if not isinstance(state, dict) or "params" not in state:
            raise CheckpointError(
                "checkpoint archive lacks a 'params' tree (found keys: "
                f"{sorted(state) if isinstance(state, dict) else type(state).__name__})",
                directory=self.directory, step=s, available_steps=available)
        if template is not None:
            state = self._apply_template(template, state, s, available)
        self.last_restore_report = {
            "restored_step": s,
            "requested_step": requested,
            "quarantined": quarantined,
            # "verified" (checksums checked), "legacy" (a layout without a
            # manifest), "unverified" (verify_integrity=False)
            "integrity": integrity_mode,
            "legacy": integrity_mode == "legacy",
            "verified": integrity_mode == "verified",
        }
        return s, state.get("params"), state.get("opt_state"), meta.get("extra", {})

    def _load_step(self, step: int, verify_integrity: bool = True) -> Tuple[Any, dict, str]:
        """One step directory -> (state tree, meta, integrity mode), every
        truncation or corruption normalized to CheckpointCorruptError."""
        d = self._step_dir(step)
        available = self.all_steps()

        def corrupt(reason: str, leaf: Optional[str] = None, cause=None):
            err = CheckpointCorruptError(
                f"checkpoint failed integrity verification: {reason}", reason=reason, leaf=leaf,
                directory=self.directory, step=step, available_steps=available)
            err.__cause__ = cause
            return err

        try:
            meta = self._read_meta(d)
        except (OSError, ValueError) as e:
            raise corrupt(f"unreadable meta.json: {e}", cause=e)
        if meta.get("backend") == "orbax":
            raise CheckpointError(
                "this step was written by orbax (the JAX package's default backend where "
                "orbax is installed); the port reads the npz layout only: save it with "
                "checkpoint_backend='npz'", directory=self.directory, step=step,
                available_steps=available)
        if os.path.exists(os.path.join(d, "state.npz")):
            # the legacy single-archive layout: no manifest
            try:
                with np.load(os.path.join(d, "state.npz")) as z:
                    state = _unflatten({k: z[k] for k in z.files})
            except Exception as e:
                raise corrupt(f"unreadable state.npz: {e}", cause=e)
            if verify_integrity:
                warn_legacy_once(self.directory, "state.npz archive")
            return state, meta, "legacy"
        try:
            flat, verified = verify_and_load_leaves(d, verify=verify_integrity)
        except IntegrityViolation as e:
            raise corrupt(e.reason, leaf=e.leaf, cause=e)
        if verified:
            mode = "verified"
        elif verify_integrity:
            mode = "legacy"
        else:
            mode = "unverified"
        return _unflatten(flat), meta, mode

    def _quarantine(self, step: int, err: CheckpointCorruptError) -> None:
        """Move a corrupt step aside as step_N.corrupt: it stops counting,
        the evidence stays (bounded by the retention)."""
        d = self._step_dir(step)
        dst = d + ".corrupt"
        shutil.rmtree(dst, ignore_errors=True)
        try:
            os.rename(d, dst)
        except OSError:
            shutil.rmtree(d, ignore_errors=True)
        print(f"[flexflow_tpu_torch] checkpoint step {step} quarantined as "
              f"{os.path.basename(dst)}: {err.reason}", file=sys.stderr)

    def _apply_template(self, template: Any, state: Any, step: int, available: List[int]) -> Any:
        """Per top-level key: the archive must hold the template's tree with
        the same leaf paths; each leaf is cast to the template leaf's
        dtype. Keys the template does not name pass through."""
        out = dict(state)
        for key, tmpl in template.items():
            if key not in state:
                raise CheckpointError(f"archive is missing the {key!r} tree the template expects",
                                      directory=self.directory, step=step,
                                      available_steps=available)
            tpaths, spaths = set(_tree_paths(tmpl)), set(_tree_paths(state[key]))
            if tpaths != spaths:
                raise CheckpointError(
                    f"restored {key!r} tree does not match the template: missing paths "
                    f"{sorted(tpaths - spaths)[:8]}, unexpected paths "
                    f"{sorted(spaths - tpaths)[:8]}", directory=self.directory, step=step,
                    available_steps=available)
            flat_t = _flatten(tmpl)
            out[key] = _unflatten({p: np.asarray(v).astype(numpy_dtype(flat_t[p]), copy=False)
                                   for p, v in _flatten(state[key]).items()})
        return out


_SHUTDOWN = object()


class AsyncCheckpointWriter:
    """The background writer (see the module docstring). `stats` holds one
    record per committed snapshot: its step, bytes, the training thread's
    stall in submit (`submit_ms`), the device-to-host copy's device time
    (`d2h_ms`, None for a state already on the host), and the writer's
    serialize and commit seconds. `copy_bytes` is what the device copy
    holds on the card."""

    SITE = "checkpoint_writer"

    def __init__(self, manager: CheckpointManager, fault_channel=None) -> None:
        self.manager = manager
        self.fault_channel = fault_channel
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._exc: Optional[BaseException] = None
        self._device: Dict[str, torch.Tensor] = {}
        self._pinned: Dict[str, torch.Tensor] = {}
        self._stream = None
        self.copy_bytes = 0
        self.stats: List[Dict[str, Any]] = []
        self._thread = threading.Thread(target=self._run, name="ff-checkpoint-writer",
                                        daemon=True)
        self._thread.start()

    def _post_failure(self, exc: BaseException) -> None:
        if self.fault_channel is not None:
            self.fault_channel.post(self.SITE, exc)
        else:
            self._exc = exc

    def _raise_pending(self) -> None:
        if self.fault_channel is not None:
            self.fault_channel.raise_pending(site=self.SITE)
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def check(self) -> None:
        """Raise a writer-side failure now (TrainingCheckpointer.due calls
        it at every boundary)."""
        self._raise_pending()

    def submit(self, step: int, state: Any, extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot `state` (a tree of tensors or host arrays) as step
        `step`: on a card, the device copy on the current stream and the
        host copy on a side stream; on the CPU, a copy of each tensor.
        Host arrays (a plan's gathered state) are the caller's to give up."""
        t0 = time.perf_counter()
        self._raise_pending()
        self._queue.join()  # the snapshot before is committed: its buffers are free
        self._raise_pending()
        host, done, timing = self._snapshot(_flatten(state))
        self._queue.put((step, host, done, timing, extra, (time.perf_counter() - t0) * 1e3))

    def _snapshot(self, flat: Dict[str, Any]):
        host: Dict[str, np.ndarray] = {}
        on_card = {k: v for k, v in flat.items()
                   if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
        for k, v in flat.items():
            if k in on_card:
                continue
            if isinstance(v, torch.Tensor):
                numpy_dtype(v)
                host[k] = v.detach().clone().numpy()
            else:
                host[k] = np.asarray(v)
        if not on_card:
            return host, None, None
        device = next(iter(on_card.values())).device
        layout = {k: (tuple(v.shape), v.dtype) for k, v in on_card.items()}
        if {k: (tuple(b.shape), b.dtype) for k, b in self._device.items()} != layout:
            for v in on_card.values():
                numpy_dtype(v)
            self._device = {k: torch.empty_like(v, memory_format=torch.contiguous_format)
                            for k, v in on_card.items()}
            self._pinned = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                            for k, v in on_card.items()}
            self.copy_bytes = sum(b.numel() * b.element_size() for b in self._device.values())
            self._stream = torch.cuda.Stream(device)
        with torch.cuda.device(device), torch.no_grad():
            for k, v in on_card.items():
                self._device[k].copy_(v)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(device))
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            self._stream.wait_event(copied)
            with torch.cuda.stream(self._stream):
                start.record(self._stream)
                for k, b in self._device.items():
                    self._pinned[k].copy_(b, non_blocking=True)
                done.record(self._stream)
        for k, p in self._pinned.items():
            host[k] = p.numpy()
        return host, done, start

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is _SHUTDOWN:
                    return
                step, host, done, start, extra, submit_ms = item
                try:
                    d2h_ms = None
                    if done is not None:
                        done.synchronize()
                        d2h_ms = start.elapsed_time(done)
                    timings: Dict[str, Any] = {}
                    self.manager.write_host_state(step, host, extra, timings)
                    self.stats.append(dict(step=step, submit_ms=submit_ms, d2h_ms=d2h_ms,
                                           **timings))
                except BaseException as e:  # surfaces at the next check, submit or wait
                    self._post_failure(e)
            finally:
                self._queue.task_done()

    def wait(self) -> None:
        """Block until every submitted snapshot is committed."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, retire the thread and free the buffers."""
        if self._thread.is_alive():
            self._queue.join()
            self._queue.put(_SHUTDOWN)
            self._thread.join(timeout=30.0)
        self._device, self._pinned, self._stream = {}, {}, None
        self._raise_pending()


@dataclass
class ResumeState:
    """What `fit(resume=True)` needs for a bitwise restart: progress, the
    state (numpy trees), the generator's state, and the dataloader's
    position (epoch and batch within it)."""

    step: int
    params: Any
    opt_state: Any
    rng: torch.Tensor  # the torch.Generator state (uint8)
    rng_device: str
    epoch: int
    batch_in_epoch: int
    epoch_offset: int
    # the restore's integrity record (CheckpointManager.last_restore_report)
    restore_report: Optional[Dict[str, Any]] = None


class TrainingCheckpointer:
    """The fit loop's checkpoint session (`checkpoint_dir` +
    `checkpoint_every_n_steps`): the interval policy, full-resume
    snapshots, async by default (`sync` for the blocking path). Over
    several ranks only the rank with `writes` writes; the others keep the
    interval and read on resume."""

    def __init__(
        self,
        directory: str,
        every_n_steps: int = 0,
        max_to_keep: int = 3,
        sync: bool = False,
        backend: Optional[str] = None,
        fault_channel=None,
        writes: bool = True,
    ) -> None:
        self.manager = CheckpointManager(directory, max_to_keep=max_to_keep, backend=backend)
        self.every = int(every_n_steps)
        self.sync = bool(sync)
        self.writes = writes
        self.sync_stats: List[Dict[str, Any]] = []
        self._writer = (AsyncCheckpointWriter(self.manager, fault_channel=fault_channel)
                        if writes and not sync else None)

    @property
    def stats(self) -> List[Dict[str, Any]]:
        """Each committed snapshot's record (AsyncCheckpointWriter.stats; on
        the sync path its step, bytes and serialize and commit seconds)."""
        return self._writer.stats if self._writer is not None else self.sync_stats

    @property
    def writer(self) -> Optional[AsyncCheckpointWriter]:
        return self._writer

    def due(self, prev_step: int, step: int) -> bool:
        """True when [prev_step, step] crossed an interval boundary. Also
        where a failed async commit surfaces, one boundary later."""
        if self._writer is not None:
            self._writer.check()
        if self.every <= 0:
            return False
        return prev_step // self.every < step // self.every

    def snapshot(self, step: int, state: Any, rng: torch.Generator, epoch: int,
                 batch_in_epoch: int, epoch_offset: int = 0) -> None:
        """A snapshot at a step or window boundary: the state, the
        generator's state after the step (where the next step draws from;
        a CUDA generator's is its seed and Philox offset, kept on the host,
        so reading it waits for nothing) and the dataloader's cursor."""
        if not self.writes:
            return
        extra = {
            "epoch": int(epoch),
            "batch_in_epoch": int(batch_in_epoch),
            "epoch_offset": int(epoch_offset),
            "torch_rng": rng.get_state().tolist(),
            "torch_rng_device": rng.device.type,
        }
        if self._writer is not None:
            self._writer.submit(step, state, extra)
        else:
            timings: Dict[str, Any] = {}
            flat = {k: host_array(v) for k, v in _flatten(state).items()}
            self.manager.write_host_state(step, flat, extra, timings)
            self.sync_stats.append(dict(step=step, **timings))

    def resume_state(self, template: Any = None, step: Optional[int] = None
                     ) -> Optional[ResumeState]:
        """The latest full-resume snapshot (or `step`), or None when the
        directory holds none (a cold start). A checkpoint without the
        resume extras raises CheckpointError: save_checkpoint wrote it, or
        the JAX package's fit loop, whose jax.random key no torch.Generator
        can continue."""
        if step is None and self.manager.latest_step() is None:
            return None
        step, params, opt_state, extra = self.manager.restore(step, template=template)
        where = dict(directory=self.manager.directory, step=step,
                     available_steps=self.manager.all_steps())
        if "torch_rng" not in extra:
            if "rng" in extra:
                raise CheckpointError(
                    "checkpoint is a JAX fit-loop snapshot: its RNG stream is a jax.random key "
                    "(uint32[2]), which no torch.Generator can continue, so fit(resume=True) "
                    "cannot go on from it bitwise; load_checkpoint restores its params, "
                    "optimizer state and step", **where)
            raise CheckpointError("checkpoint has no resume metadata (rng/dataloader cursor) "
                                  "— it was not written by a fit-loop snapshot", **where)
        return ResumeState(
            step=step, params=params, opt_state=opt_state,
            rng=torch.tensor(extra["torch_rng"], dtype=torch.uint8),
            rng_device=str(extra.get("torch_rng_device", "cpu")),
            epoch=int(extra.get("epoch", 0)),
            batch_in_epoch=int(extra.get("batch_in_epoch", 0)),
            epoch_offset=int(extra.get("epoch_offset", 0)),
            restore_report=self.manager.last_restore_report,
        )

    def finalize(self) -> None:
        """Drain and retire the writer (at fit's exit, normal or not): every
        submitted snapshot is durable before control leaves fit."""
        if self._writer is not None:
            self._writer.close()


__all__ = [
    "AsyncCheckpointWriter",
    "CheckpointCorruptError",
    "CheckpointError",
    "CheckpointManager",
    "ORBAX_REFUSED",
    "ResumeState",
    "TrainingCheckpointer",
    "host_array",
    "numpy_dtype",
]
