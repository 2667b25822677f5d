"""Carry the JAX package's training and serving state into the port.

Parameters cross as numpy arrays keyed `n{idx}` (the weight node's index,
which both packages' builders assign in the same order), or, for serving,
`w{i}` (the weight's ordinal in topological order, the JAX package's
`init_serving_params` keys), so a run of the port can start from exactly
the state of a run of the JAX package. The graph is the port's own; keys
and shapes are checked against it.

A PCG trained over a mesh of ranks holds each weight as pieces:
`pcg_params_from_numpy` cuts the rank's pieces out of the global arrays,
and `pcg_params_to_numpy` gathers them back (a collective: every rank
calls it), and the same for the optimizer state. A pipelined plan holds
its stage: the JAX PipelinedTrainingInstance's stacked [S, ...] state
(keyed by the template stage's weights) goes in through
`PipelinedTrainingInstance.load_stacked_state` and comes back through
`stacked_state` (a collective). A sub-mesh trainer holds its islands'
dicts, {"pre", "branch<i>", "post"}: `submesh_params_from_numpy` keeps
the islands of this rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from flexflow_tpu_torch.local_execution.training_backing import (
    param_key,
    weight_nodes,
    weight_shape,
)
from flexflow_tpu_torch.utils.graph import Node
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.serving.program import as_pcg, weight_ordinals


def params_from_numpy(
    cg: ComputationGraph, params: Dict[str, np.ndarray], device
) -> Dict[str, torch.Tensor]:
    """Copies of `params` on `device`, one per weight node of `cg`; raises
    on a missing or extra key or a shape that differs from the graph's."""
    return _checked_copies({param_key(n): weight_shape(cg, n) for n in weight_nodes(cg)},
                           params, device)


def serving_params_from_numpy(
    pcg, params: Dict[str, np.ndarray], device
) -> Dict[str, torch.Tensor]:
    """Copies of serving `params` (keyed by weight ordinal `w{i}`) on
    `device`, checked against the weights of the port's (P)CG `pcg` as
    params_from_numpy checks."""
    pcg = as_pcg(pcg)
    return _checked_copies({key: weight_shape(pcg, n) for n, key in weight_ordinals(pcg).items()},
                           params, device)


def _checked_copies(expected, params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    missing, extra = set(expected) - set(params), set(params) - set(expected)
    if missing or extra:
        raise ValueError(
            f"parameter keys differ from the graph's: missing {sorted(missing)}, "
            f"extra {sorted(extra)}"
        )
    out = {}
    for k, shape in expected.items():
        arr = np.asarray(params[k])
        if tuple(arr.shape) != tuple(shape.dims):
            raise ValueError(f"parameter {k}: shape {arr.shape}, graph has {shape.dims}")
        out[k] = torch.tensor(arr, dtype=shape.dtype.to_torch(), device=device)
    return out


def opt_state_from_numpy(cg: ComputationGraph, opt_state: Dict, device) -> Dict:
    """The optimizer state {m, v, step} (the slots the optimizer has) with
    each slot checked and copied as params_from_numpy does; the step count
    becomes the 0-d int32 tensor the port's optimizer advances."""
    out = {"step": torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32,
                                device=device)}
    for slot in ("m", "v"):
        if slot in opt_state:
            out[slot] = params_from_numpy(cg, opt_state[slot], device)
    return out


def ffmodel_state_from_numpy(model, params: Dict[str, np.ndarray], opt_state: Optional[Dict] = None) -> None:
    """Carry a compiled JAX FFModel's state (numpy, keyed `n{idx}`: of the
    CG, or of the searched PCG after a searched compile) into the compiled
    port FFModel `model`, in place of what its compile drew; its
    stepped backing, if any, follows, and the graphs captured on the tensors
    it replaces are dropped."""
    if model.params is None:
        raise RuntimeError("compile the port's FFModel before carrying state into it")
    if model._pipelined():
        # a pipelined plan: the JAX instance's stacked state, this stage's slice
        model.instance.load_stacked_state(model.params, model.opt_state, params, opt_state)
    elif model._submesh():
        model.params = submesh_params_from_numpy(model.instance, params, model.device)
        if opt_state is not None:
            model.opt_state = {island: _opt_slots_from_numpy(model.params[island],
                                                             opt_state[island], model.device)
                               for island in model.params}
    elif model._searched():
        # a searched plan: JAX keys of the same winner's PCG, cut into pieces
        inst = model.instance
        args = (inst.pcg, inst.shardings, inst.machine_mesh)
        model.params = pcg_params_from_numpy(*args, params, inst.device)
        if opt_state is not None:
            model.opt_state = pcg_opt_state_from_numpy(*args, opt_state, inst.device)
    else:
        model.params = params_from_numpy(model.cg, params, model.device)
        if opt_state is not None:
            model.opt_state = opt_state_from_numpy(model.cg, opt_state, model.device)
    if model._backing is not None:
        model._backing.params = dict(model.params)
    model.invalidate_graphs()


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in params.items()}


def _weight_sharding(pcg, shardings, key: str):
    (out,) = pcg.outputs_of(Node(int(key[1:])))
    return shardings[out]


def pcg_params_from_numpy(pcg, shardings, mesh, params: Dict[str, np.ndarray],
                          device="cpu") -> Dict[str, torch.Tensor]:
    """This rank's pieces of the global `params` of the PCG's weights,
    sharded as `shardings` (parallel/sharding.py's pcg_shardings on
    `mesh`) says, on `device`; keys and global shapes are checked as
    params_from_numpy checks them."""
    from flexflow_tpu_torch.parallel.sharding import local_block

    full = params_from_numpy(pcg, params, "cpu")
    return {k: local_block(v, _weight_sharding(pcg, shardings, k), mesh, k).contiguous()
            .to(device) for k, v in full.items()}


def pcg_params_to_numpy(pcg, shardings, mesh, params: Dict[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """The global values of this rank's pieces `params`, gathered over the
    mesh; every rank calls it, in the same order."""
    from flexflow_tpu_torch.parallel.sharding import gather_block

    return params_to_numpy({k: gather_block(v.detach(), _weight_sharding(pcg, shardings, k), mesh)
                            for k, v in params.items()})


def pcg_opt_state_from_numpy(pcg, shardings, mesh, opt_state: Dict, device="cpu") -> Dict:
    """The optimizer state {m, v, step} of global arrays as this rank's
    pieces, as pcg_params_from_numpy cuts the parameters."""
    out = {"step": torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32,
                                device=device)}
    for slot in ("m", "v"):
        if slot in opt_state:
            out[slot] = pcg_params_from_numpy(pcg, shardings, mesh, opt_state[slot], device)
    return out


def pcg_opt_state_to_numpy(pcg, shardings, mesh, opt_state: Dict) -> Dict:
    """The global optimizer state of this rank's pieces (a collective)."""
    out = {"step": np.asarray(int(opt_state["step"]), dtype=np.int32)}
    for slot in ("m", "v"):
        if slot in opt_state:
            out[slot] = pcg_params_to_numpy(pcg, shardings, mesh, opt_state[slot])
    return out


def submesh_params_from_numpy(instance, params: Dict[str, Dict[str, np.ndarray]], device
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The islands of this rank (SubmeshBranchInstance.islands) from the
    JAX SubmeshBranchInstance's {island: {key: array}} parameters, each
    checked against the graph's weights of its island."""
    out = {}
    for island in instance.islands():
        want = {param_key(n): weight_shape(instance.cg, n) for n in weight_nodes(instance.cg)
                if instance._island_of[n] == island}
        out[island] = _checked_copies(want, params[island], device)
    return out


def submesh_params_to_numpy(instance, params: Dict[str, Dict[str, torch.Tensor]]
                            ) -> Dict[str, Dict[str, np.ndarray]]:
    """The islands' parameters as numpy, in the JAX package's dicts: every
    island from the first rank that holds it (a collective: every rank
    calls it)."""
    import torch.distributed as dist

    held = {island: params_to_numpy(p) for island, p in params.items()}
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, held)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for part in parts:
        for island, p in part.items():
            out.setdefault(island, p)
    return out


def _opt_slots_from_numpy(params: Dict[str, torch.Tensor], opt_state: Dict, device) -> Dict:
    """An optimizer state {m, v, step} for `params` from numpy slots."""
    out = {"step": torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32,
                                device=device)}
    for slot in ("m", "v"):
        if slot in opt_state:
            out[slot] = {k: torch.tensor(np.asarray(opt_state[slot][k]), dtype=p.dtype,
                                         device=device) for k, p in params.items()}
    return out
