"""The recorded step program: one step run under a recorder (the port's
counterpart of flexflow_tpu/analysis/lowering.py).

The JAX package lowers a step without running it and reads the compiled
program's text. The port has no program text to read: its step is the
Python that runs. So the communication census (analysis/comm_analysis.py),
the execution contract (analysis/exec_contract.py) and the measured memory
cross-check read one recorded step instead: the compiled instance's own
step (`train_step`'s body), run once on zero-filled example arguments and on a copy of
the parameters and optimizer state, so the live state stays bitwise as it
was. The record holds:

- the ordered aten ops, through a `TorchDispatchMode`, each with its
  operands' dtypes and shapes and its scalar arguments;
- each hand-written kernel launch, from its wrapper's launch count (a
  ctypes launch is no aten op); the counts are put back afterwards, so a
  wrapper's count goes on counting the steps that train;
- each collective of the port's transport (parallel/census.py): kind,
  group size, bytes and the PCG node that issued it;
- device-to-host transfers (a `.item()`, `float(t)`, `.cpu()` or
  `.tolist()` of a device tensor inside the step), except the host staging
  of a gloo collective, which is the backend's transport;
- the ops PyTorch documents as nondeterministic on CUDA;
- for each state tensor, whether the step handed back the tensor it was
  given, in the same storage (`data_ptr`): the update was in place;
- on a card, the peak bytes the step allocated.

`canonical_text()` is what the exec contract's fingerprint hashes: no
address, device index or rank appears in it. Over several ranks every
rank records its own step (each runs its own program), and the
fingerprint hashes all ranks' texts in rank order.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# aten ops whose CUDA kernels PyTorch documents as nondeterministic (the
# torch.use_deterministic_algorithms list: atomic accumulation, or no
# deterministic kernel at all). A scatter-add with one index per row along
# its dim writes each destination once, which is the unique-indices case
# the JAX package's rule exempts too.
_NONDETERMINISTIC = frozenset({
    "index_add", "index_add_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_copy", "index_copy_", "put_", "put", "histc", "bincount",
    "kthvalue", "median", "nanmedian", "avg_pool3d_backward", "adaptive_avg_pool2d_backward",
    "_adaptive_avg_pool2d_backward", "adaptive_avg_pool3d_backward",
    "_adaptive_avg_pool3d_backward", "adaptive_max_pool2d_backward",
    "adaptive_max_pool3d_backward", "max_pool3d_with_indices_backward",
    "fractional_max_pool2d_backward", "fractional_max_pool3d_backward",
    "upsample_linear1d_backward", "upsample_bilinear2d_backward",
    "upsample_bicubic2d_backward", "upsample_trilinear3d_backward",
    "reflection_pad1d_backward", "reflection_pad2d_backward", "reflection_pad3d_backward",
    "replication_pad1d_backward", "replication_pad2d_backward", "replication_pad3d_backward",
    "nll_loss2d_forward", "_ctc_loss_backward", "_embedding_bag_dense_backward",
    "_embedding_bag_per_sample_weights_backward", "grid_sampler_2d_backward",
    "grid_sampler_3d_backward", "cumsum_backward",
})
# index_put with accumulate=True
_ACCUMULATE_PUT = frozenset({"index_put", "index_put_", "_index_put_impl_", "_index_put_impl"})
_HOST_READ = frozenset({"_local_scalar_dense"})
_COPIES = frozenset({"_to_copy", "copy_", "to", "_copy_from", "_copy_from_and_resize"})


def find_logit_tensor(pcg):
    """The model output: the last unconsumed non-weight output in
    topological order (the unique-sink rule FFModel falls back to)."""
    from flexflow_tpu_torch.op_attrs.ops import WeightAttrs

    sink = None
    for n in pcg.topological_ordering():
        if isinstance(pcg.op_attrs(n), WeightAttrs):
            continue
        for o in pcg.outputs_of(n):
            if not pcg.uses_of(o):
                sink = o
    if sink is None:
        raise ValueError("PCG has no unconsumed output to treat as logits")
    return sink


# -- state trees -------------------------------------------------------------


def flatten_state(tree, path: str = "") -> List[Tuple[str, object]]:
    """(path, leaf) of a nest of dicts, lists and tuples, in key order, with
    the JAX package's keystr paths (`['n3']`, `[0]`)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            out += flatten_state(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_state(v, f"{path}[{i}]")
        return out
    return [(path, tree)]


def copy_state(tree):
    """A copy of a state tree: each tensor cloned, everything else as it is."""
    if isinstance(tree, dict):
        return {k: copy_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(copy_state(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def _storage_ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


@dataclass
class StateLeaf:
    """One state tensor of the step: given in, handed back."""

    arg: str  # "params", "opt_state", "cache"
    path: str
    bytes: int
    donated: bool  # the step hands the leaf back (it owns its update)
    expected_inplace: bool  # the memory model prices it as updated in place
    kept: bool = True  # the leaf reached the step
    aliased: bool = False  # handed back in the storage it came in

    @property
    def leaf(self) -> str:
        return f"{self.arg}{self.path}"


# -- the recorder ------------------------------------------------------------


def _render(x) -> str:
    """An argument as the canonical text shows it: tensors by dtype and
    shape, scalars by value, devices by type (no index), anything else by
    its type's name (no address)."""
    if isinstance(x, torch.Tensor):
        return f"{str(x.dtype).replace('torch.', '')}{list(x.shape)}"
    if isinstance(x, (bool, int, str)) or x is None:
        return repr(x)
    if isinstance(x, float):
        return float.hex(x)
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_render(v) for v in x) + ")"
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    if isinstance(x, torch.device):
        return x.type
    if isinstance(x, (torch.memory_format, torch.layout)):
        return str(x).replace("torch.", "")
    return type(x).__name__


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


class _Recorder(TorchDispatchMode):
    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the recorded step is never compiled: no dynamo-disabled wrapper
        # (whose first call imports torch._dynamo, seconds a process)
        return False

    def __init__(self, wrappers) -> None:
        super().__init__()
        self.wrappers = list(wrappers)
        self.seen = [fn.launches for fn in self.wrappers]
        self.lines: List[str] = []
        self.kernels: Counter = Counter()
        self.host_transfers: List[Dict[str, object]] = []
        self.nondeterministic: List[Dict[str, object]] = []
        self.num_ops = 0

    def flush_launches(self) -> None:
        for i, fn in enumerate(self.wrappers):
            d = fn.launches - self.seen[i]
            if d:
                self.seen[i] = fn.launches
                self.kernels[fn.__name__] += d
                self.lines.append(f"kernel {fn.__name__} x{d}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from flexflow_tpu_torch.parallel import census

        kwargs = kwargs or {}
        self.flush_launches()
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.num_ops += 1
        self.lines.append(f"{func.__name__} {_render(list(args))} {_render(sorted(kwargs.items()))}"
                          f" -> {_render(out if isinstance(out, (list, tuple)) else [out])}")
        ins = _tensors(args) + _tensors(kwargs)
        if not census.transporting():
            if name in _HOST_READ and ins and ins[0].device.type != "meta":
                self.host_transfers.append({"kind": "host-transfer", "target": f"aten.{name}",
                                            "bytes": int(ins[0].element_size()),
                                            "name": f"op{self.num_ops}"})
            elif name in _COPIES:
                dst = args[0] if name in ("copy_", "_copy_from") else out
                src = args[1] if name in ("copy_", "_copy_from") else (ins[0] if ins else None)
                if (isinstance(dst, torch.Tensor) and isinstance(src, torch.Tensor)
                        and src.device.type == "cuda" and dst.device.type == "cpu"):
                    self.host_transfers.append({
                        "kind": "host-transfer", "target": f"aten.{name}(cuda->cpu)",
                        "bytes": int(src.numel() * src.element_size()),
                        "name": f"op{self.num_ops}"})
        floating = bool(ins) and ins[0].is_floating_point()
        if floating and name in _NONDETERMINISTIC:
            if name.startswith("scatter_add") and len(args) > 2 and isinstance(args[2], torch.Tensor) \
                    and args[2].dim() > 0 and args[2].shape[int(args[1])] == 1:
                pass  # one index per row along dim: every destination written once
            else:
                self.nondeterministic.append({
                    "kind": "nondeterministic-op", "name": f"op{self.num_ops}",
                    "detail": f"aten.{name} on {_render(ins[0])}"})
        if floating and name in _ACCUMULATE_PUT:
            acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
            if acc:
                self.nondeterministic.append({
                    "kind": "nondeterministic-op", "name": f"op{self.num_ops}",
                    "detail": f"aten.{name}(accumulate=True) on {_render(ins[0])}"})
        return out


@dataclass
class StepProgram:
    """One recorded step: what the comm, exec and memory checks read."""

    lines: List[str]
    kernels: Dict[str, int]
    collectives: List[Dict[str, object]]
    host_transfers: List[Dict[str, object]]
    nondeterministic: List[Dict[str, object]]
    state: List[StateLeaf]
    arg_signature: List[str]
    constants: Dict[str, object]
    step_bytes: Optional[int] = None  # bytes the step allocated at its peak (a card)
    rank_texts: Optional[List[str]] = None  # every rank's canonical text hash, rank order

    def canonical_text(self) -> str:
        head = json.dumps(self.constants, sort_keys=True, default=str)
        body = ["constants " + head, "args " + " ".join(self.arg_signature)]
        body += self.lines
        body += [f"collective {c['kind']} {c['bytes']} group={c['group_size']} node={c['node']}"
                 + ("" if "parts" not in c else
                    " parts=" + ",".join(f"{n}:{b}" for n, b in c["parts"]))
                 for c in self.collectives]
        return "\n".join(body) + "\n"

    def program_key(self) -> str:
        return hashlib.sha256("|".join(self.arg_signature).encode()).hexdigest()[:16]

    def program_fingerprint(self) -> str:
        mine = hashlib.sha256(self.canonical_text().encode()).hexdigest()
        if not self.rank_texts:
            return mine
        return hashlib.sha256("|".join(self.rank_texts).encode()).hexdigest()

    def kernel_route(self) -> Dict[str, int]:
        return dict(sorted(self.kernels.items()))


def _wrappers():
    from flexflow_tpu_torch.kernels import ring_flash  # noqa: F401  (registers its wrappers)
    from flexflow_tpu_torch.kernels.flash_attention import KERNEL_WRAPPERS

    return KERNEL_WRAPPERS


def _device_of(tree) -> torch.device:
    for _, v in flatten_state(tree):
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _rank_hashes(text: str) -> Optional[List[str]]:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None
    mine = hashlib.sha256(text.encode()).hexdigest()
    out: List[object] = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return [str(h) for h in out]


def record_program(
    run: Callable[[Dict[str, object]], Dict[str, object]],
    state: Dict[str, object],
    expected_inplace: Sequence[str],
    arg_signature: Sequence[str],
    constants: Dict[str, object],
    restore: Callable[[], Callable[[], None]] = lambda: (lambda: None),
) -> StepProgram:
    """Run `run` once on a copy of `state` under the recorder. `run` takes
    the copies ({arg: tree}) and returns the trees the program hands back.
    `restore()` is called before the run and returns a function that puts
    back whatever the run changes besides the state (counters, logs)."""
    from flexflow_tpu_torch.parallel import census

    device = _device_of(state)
    wrappers = _wrappers()
    launches = [fn.launches for fn in wrappers]
    put_back = restore()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    copies = {arg: copy_state(tree) for arg, tree in state.items()}
    given = {arg: {p: (v, _storage_ptr(v)) for p, v in flatten_state(tree)
                   if isinstance(v, torch.Tensor)} for arg, tree in copies.items()}
    rec = _Recorder(wrappers)
    try:
        with census.recording() as log, torch.random.fork_rng(
                devices=[device] if cuda else []), rec:
            back = run(copies)
            rec.flush_launches()
        if cuda:
            torch.cuda.synchronize(device)
            step_bytes = int(torch.cuda.max_memory_allocated(device) - base)
        else:
            step_bytes = None
    finally:
        for fn, n in zip(wrappers, launches):
            fn.launches = n
        put_back()
    leaves: List[StateLeaf] = []
    for arg, tree in copies.items():
        handed = {p: v for p, v in flatten_state(back.get(arg, {}))
                  if isinstance(v, torch.Tensor)}
        for p, (t, ptr) in given[arg].items():
            out = handed.get(p)
            leaves.append(StateLeaf(
                arg=arg, path=p, bytes=int(t.numel() * t.element_size()),
                donated=out is not None, expected_inplace=arg in expected_inplace,
                aliased=out is not None and _storage_ptr(out) == ptr))
    prog = StepProgram(
        lines=rec.lines, kernels=dict(rec.kernels), collectives=list(log),
        host_transfers=rec.host_transfers, nondeterministic=rec.nondeterministic,
        state=leaves, arg_signature=list(arg_signature), constants=dict(constants),
        step_bytes=step_bytes)
    prog.rank_texts = _rank_hashes(prog.canonical_text())
    return prog


# -- the training step ---------------------------------------------------------


def _example_label(logit_dims, loss_attrs, label_dtype, device) -> torch.Tensor:
    from flexflow_tpu_torch.op_attrs.ops.loss_functions import (
        SparseCategoricalCrossEntropyLossAttrs,
    )

    sparse = isinstance(loss_attrs, SparseCategoricalCrossEntropyLossAttrs)
    dims = tuple(logit_dims[:-1] if sparse else logit_dims)
    if label_dtype is None:
        label_dtype = np.int32 if sparse else np.float32
    return torch.from_numpy(np.zeros(dims, dtype=label_dtype)).to(device)


def step_example_args(instance, loss_attrs, label_dtype=None, batch_size=None):
    """Zero-filled (batch, label) at the instance's global input and logit
    shapes, on its device: the arguments the recorded step runs on.
    `batch_size`: the batch the step runs at where it is not the graph's
    (a model's graph keeps its build-time batch across a batch-growth
    recompile)."""
    from flexflow_tpu_torch.op_attrs.ops import InputAttrs
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape
    from flexflow_tpu_torch.local_execution.training_backing import param_key

    device = instance.device
    batch: Dict[str, torch.Tensor] = {}
    pcg = getattr(instance, "pcg", None)
    graph = pcg if pcg is not None else instance.cg
    for n in graph.topological_ordering():
        la = graph.layer_attrs(n)
        if not isinstance(la.attrs, InputAttrs):
            continue
        (out,) = graph.outputs_of(n)
        shape = graph.tensor_shape(out)
        ts = get_reduced_shape(shape) if pcg is not None else shape
        dims = tuple(ts.dims)
        if batch_size:
            dims = (int(batch_size),) + dims[1:]
        batch[la.name or param_key(n)] = torch.zeros(dims, dtype=ts.dtype.to_torch(),
                                                     device=device)
    logit = getattr(instance, "loss_logit_tensor", None) or instance.logit_tensor
    lshape = graph.tensor_shape(logit)
    ldims = tuple((get_reduced_shape(lshape) if pcg is not None else lshape).dims)
    if batch_size:
        ldims = (int(batch_size),) + ldims[1:]
    return batch, _example_label(ldims, loss_attrs, label_dtype, device)


def _instance_restore(instance):
    """Put back what a step changes on the instance besides its state."""
    def snapshot():
        saved = {k: getattr(instance, k) for k in ("last_step_stats",) if hasattr(instance, k)}
        counters = []
        for owner in (instance, getattr(instance, "machine_mesh", None)):
            for name in ("counts", "collectives"):
                c = getattr(owner, name, None) if owner is not None else None
                if isinstance(c, Counter):
                    counters.append((c, Counter(c)))
        logs = [(lg, len(lg)) for lg in (getattr(instance, "bucket_log", None),)
                if isinstance(lg, list)]

        def put_back():
            for k, v in saved.items():
                setattr(instance, k, v)
            for c, was in counters:
                c.clear()
                c.update(was)
            for lg, n in logs:
                del lg[n:]

        return put_back

    return snapshot


def step_constants(instance, loss_attrs, optimizer_attrs=None, steps_per_dispatch: int = 1,
                   label_dtype=None) -> Dict[str, object]:
    """What the fingerprint hashes besides the ops: the loss, the optimizer
    and its constants, the compute dtype, the label dtype and the window."""
    opt = optimizer_attrs if optimizer_attrs is not None else instance.optimizer_attrs
    return {
        "backend": type(instance).__name__,
        "loss": repr(loss_attrs),
        "optimizer": repr(opt),
        "compute_dtype": str(getattr(instance, "compute_dtype", None)),
        "label_dtype": None if label_dtype is None else np.dtype(label_dtype).name,
        "steps_per_dispatch": max(int(steps_per_dispatch), 1),
    }


def record_step(instance, params, opt_state, loss_attrs, label_dtype=None,
                steps_per_dispatch: int = 1, batch_size=None) -> StepProgram:
    """One recorded train step of a compiled instance (module note), at
    `batch_size` where the step runs at another batch than its graph's."""
    batch, label = step_example_args(instance, loss_attrs, label_dtype=label_dtype,
                                     batch_size=batch_size)
    sig = [f"{k}:{_render(v)}" for k, v in sorted(batch.items())] + [f"label:{_render(label)}"]
    sig += [f"{arg}{p}:{_render(v)}" for arg, tree in (("params", params), ("opt_state", opt_state))
            for p, v in flatten_state(tree) if isinstance(v, torch.Tensor)]
    sig.append(f"steps_per_dispatch:{max(int(steps_per_dispatch), 1)}")
    # the ranks the program spans: another grid is another program, as the
    # argument shapes are (a degraded grid is `program_changed`, not DET002)
    sig.append(f"ranks:{_world()}")

    def run(state):
        # the step's body (train_step less its trace spans and bookkeeping)
        rng = torch.Generator(device=instance.device).manual_seed(0)
        p, o = instance._step(state["params"], state["opt_state"], batch, label, rng)[:2]
        return {"params": p, "opt_state": o}

    return record_program(
        run, {"params": params, "opt_state": opt_state}, ("params", "opt_state"), sig,
        step_constants(instance, loss_attrs, steps_per_dispatch=steps_per_dispatch,
                       label_dtype=label_dtype),
        restore=_instance_restore(instance))


def build_step_instance(pcg, mapping: Optional[dict] = None, machine_spec=None, loss_attrs=None,
                        optimizer_attrs=None, seed: int = 0, device=None):
    """A standalone instance of a plan (no FFModel): the flat executor over
    the plan's mesh (or the 1F1B executor for a stage-partitioned plan that
    runs there), a sparse cross-entropy loss and SGD by default, with
    initialized state. The plan spans one rank per device: the process
    group must hold `machine_spec.num_devices` ranks."""
    import torch.distributed as dist

    from flexflow_tpu_torch.op_attrs.ops.loss_functions import (
        SparseCategoricalCrossEntropyLossAttrs,
    )
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.pcg.optimizer import SGDOptimizerAttrs
    from flexflow_tpu_torch.pcg.pipeline import analyze_pipeline

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if machine_spec is None:
        machine_spec = MachineSpecification(1, 1, max(world, 1), 25.0, 400.0)
    if world != machine_spec.num_devices:
        raise ValueError(
            f"the plan spans {machine_spec.num_devices} devices, one rank each, but the "
            f"process group has {world} ranks: run it under `torchrun --nproc_per_node "
            f"{machine_spec.num_devices}` (or parallel.init_file_group on each rank)")
    la = loss_attrs or SparseCategoricalCrossEntropyLossAttrs()
    oa = optimizer_attrs or SGDOptimizerAttrs(lr=0.01)
    region = analyze_pipeline(pcg)
    if region is not None and region.ok:
        from flexflow_tpu_torch.parallel.pipeline import (
            PipelinedTrainingInstance,
            PipelineUnsupported,
        )

        with contextlib.suppress(PipelineUnsupported):
            inst = PipelinedTrainingInstance(pcg, find_logit_tensor(pcg), la, oa, device=device)
            params, opt_state = inst.initialize(seed=seed)
            return inst, params, opt_state
    inst = DistributedTrainingInstance(pcg, find_logit_tensor(pcg), la, oa,
                                       MachineMesh.from_spec(machine_spec), mapping=mapping,
                                       device=device)
    params, opt_state = inst.initialize(seed=seed)
    return inst, params, opt_state


def record_plan(pcg, mapping: Optional[dict] = None, machine_spec=None, loss_attrs=None,
                optimizer_attrs=None, device=None) -> StepProgram:
    """ffcheck's standalone path: (PCG, mapping) -> one recorded step."""
    from flexflow_tpu_torch.op_attrs.ops.loss_functions import (
        SparseCategoricalCrossEntropyLossAttrs,
    )

    la = loss_attrs or SparseCategoricalCrossEntropyLossAttrs()
    inst, params, opt_state = build_step_instance(
        pcg, mapping, machine_spec=machine_spec, loss_attrs=la,
        optimizer_attrs=optimizer_attrs, device=device)
    return record_step(inst, params, opt_state, la)
