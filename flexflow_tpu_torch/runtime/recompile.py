"""Recompiles and degraded-grid recovery: the elastic runtime's re-entry
paths (the port's copy of flexflow_tpu/runtime/recompile.py).

Reference: lib/runtime/src/recompile.h:26-41 (RecompileState{trigger_func,
alter_func, recompilations}) and recompile_on_condition (model.h:107).
`FFModel.recompile()` runs compile() again, the Unity search included where
configured, and carries the parameters (and the optimizer state whose
shapes survive) over; the transition is verified first (TRN001-TRN004,
analysis/transition_analysis.py). The canonical use is growing the batch as
training stabilizes.

`recover_from_grid_change` is the device-failure counterpart: the grid is
capped (`config.max_devices`), the plan searched again for the smaller
machine, and the state carried onto it, or restored from a checkpoint
directory. Ranks are processes here, so a smaller grid is a smaller process
group: every rank leaves the old group, the first `new_num_devices` ranks
open the new one (on `init_method`) and compile the new plan there, and
the others drop out: their model is marked inactive, so its fit trains
nothing and returns at once, and no collective waits on them.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch
import torch.distributed as dist


def carry(model, old_state) -> None:
    """Install `old_state` (the model's `_checkpoint_state()` taken before
    its recompile: the global values of the parameters and optimizer state)
    into the freshly compiled model, in place, through the model's restore
    path (a plan's rank cuts its pieces). A leaf whose key or shape did not
    survive keeps its fresh value: the state is carried leaf by leaf."""
    from flexflow_tpu_torch.runtime.checkpoint import _flatten

    if model._searched() or model._pipelined():
        model._assign_state(old_state["params"], old_state.get("opt_state"))
        return
    dst = _flatten(model._state_template())
    src = _flatten({k: v for k, v in old_state.items() if v is not None})
    with torch.no_grad():
        for key, t in dst.items():
            v = src.get(key)
            if v is None:
                continue
            v = torch.as_tensor(v)
            if tuple(v.shape) == tuple(t.shape) and v.dtype == t.dtype:
                t.copy_(v)


def snapshot_state(model) -> dict:
    """The model's state as `carry` takes it: global values, copied off the
    live tensors (the recompile replaces them)."""
    from flexflow_tpu_torch.analysis.step_program import copy_state

    return copy_state(model._checkpoint_state())


class RecompileState:
    """trigger_func(ff) -> bool decides; alter_func(ff) mutates (config,
    graph, ...); the runtime then recompiles. `recompilations` counts fires
    (reference recompile.h:35)."""

    def __init__(self, trigger_func: Callable[[object], bool],
                 alter_func: Callable[[object], None], ff=None) -> None:
        self.trigger_func = trigger_func
        self.alter_func = alter_func
        self.ff = ff
        self.recompilations = 0

    def trigger(self) -> bool:
        return bool(self.trigger_func(self.ff))

    def alter(self) -> None:
        self.alter_func(self.ff)


def recompile_on_condition(ff, r: RecompileState) -> bool:
    """Check the trigger and, when it fires, alter + recompile (reference
    model.h:107). Returns True when a recompile happened, so the caller
    rebuilds what derives from the old step (the batch iterator)."""
    if r.ff is None:
        r.ff = ff
    if not r.trigger():
        return False
    r.alter()
    ff.recompile()
    r.recompilations += 1
    return True


def active_num_devices(ff) -> int:
    """The devices the model's compiled instance spans: its ranks."""
    if getattr(ff, "inactive", False):
        return 0
    inst = getattr(ff, "instance", None)
    mm = getattr(inst, "machine_mesh", None)
    if mm is not None:
        return mm.world_size
    if dist.is_available() and dist.is_initialized() and ff._grouped():
        return dist.get_world_size()
    return 1


def recover_from_grid_change(ff, new_num_devices: int, checkpoint_dir: Optional[str] = None,
                             reason: str = "device_failure",
                             init_method: Optional[str] = None) -> dict:
    """Re-entry after a device failure or a resize: plan again for the
    smaller grid, carry the state onto it, and return the recovery record
    (also in `ff.search_provenance["recovery"]` and, with
    `config.metrics_dir`, in the metrics stream). Every rank calls it.

    - `new_num_devices` caps the grid (`config.max_devices`); over ranks
      the new group is opened on `init_method` (a `file://` or `tcp://`
      rendezvous the old group's ranks all reach) by the first
      `new_num_devices` ranks, and the others are left out (module note).
    - The state carries over through `carry`, gathered before the old
      group closes; with `checkpoint_dir` the latest checkpoint is
      restored instead, onto the new plan. Either way the old plan is
      taken before the group closes, so the transition is verified
      (FFModel.recompile) before any state carries over.
    """
    grouped = dist.is_available() and dist.is_initialized() and ff._grouped()
    avail = dist.get_world_size() if grouped else (
        torch.cuda.device_count() if ff.device.type == "cuda" else 1)
    if not 1 <= new_num_devices <= avail:
        raise ValueError(f"new_num_devices must be in [1, {avail}], got {new_num_devices}")
    from flexflow_tpu_torch.runtime.strategy import machine_grid_doc

    t0 = time.perf_counter()
    old_ndev = active_num_devices(ff)
    nodes = max(ff.config.num_nodes, 1)
    ff.config.max_devices = new_num_devices
    if grouped and new_num_devices < avail:
        if init_method is None:
            raise ValueError("a smaller group over ranks needs init_method= (the rendezvous "
                             "of the new process group)")
        old_state = snapshot_state(ff)  # a collective of the old group
        old_plan = ff._transition_plan()
        rank, backend = dist.get_rank(), dist.get_backend()
        dist.barrier()
        dist.destroy_process_group()
        if rank >= new_num_devices:
            ff.inactive = True
            ff.instance = None
            ff.params = ff.opt_state = None
            recovery = {"reason": reason, "old_grid": machine_grid_doc(nodes, old_ndev),
                        "new_grid": machine_grid_doc(nodes, new_num_devices),
                        "active": False, "re_searched": False, "restored_step": None,
                        "recovery_seconds": round(time.perf_counter() - t0, 3)}
            ff.search_provenance = {"recovery": recovery}
            return recovery
        from flexflow_tpu_torch.parallel import data_parallel

        # the old group's timeout (parallel.init_file_group's), else torch's
        timeout = data_parallel._GROUP_TIMEOUT
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=new_num_devices,
                                **({} if timeout is None else {"timeout": timeout}))
        ff.recompile(carry_state=old_state, old_plan=old_plan)
    else:
        ff.recompile()
    restored_step = ff.load_checkpoint(checkpoint_dir) if checkpoint_dir else None
    new_ndev = active_num_devices(ff)
    prov = ff.search_provenance
    recovery = {
        "reason": reason,
        "old_grid": machine_grid_doc(nodes, old_ndev),
        "new_grid": machine_grid_doc(nodes, new_ndev),
        "active": True,
        # did the re-entry search again (or fall back to the data-parallel
        # or single-device backends)?
        "re_searched": bool(isinstance(prov, dict) and prov.get("search_algorithm")),
        "restored_step": restored_step,
        "recovery_seconds": round(time.perf_counter() - t0, 3),
    }
    if ff.search_provenance is None:
        ff.search_provenance = {}
    ff.search_provenance["recovery"] = recovery
    if getattr(ff.config, "metrics_dir", "") and ff._writes_stream():
        from flexflow_tpu_torch.observability.metrics import append_run_event

        append_run_event(ff.config.metrics_dir, "recovery", **recovery)
    return recovery
