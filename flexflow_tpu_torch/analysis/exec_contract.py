"""The execution contract of a step program: determinism census and
in-place audit (the port's copy of flexflow_tpu/analysis/exec_contract.py,
with its rule ids and record shapes, read off a recorded step
(analysis/step_program.py) instead of a compiled XLA module).

Bitwise resume, chaos-soak recovery and the fused windows' parity rest on
two properties of the step program:

1. it is deterministic: same inputs, same bits, every process, every run;
2. its state is updated in place: the memory model (MEM001-005) prices
   parameters and optimizer slots once, so a step that hands back a new
   tensor for a state leaf keeps the old one live beside it.

Rule ids (catalogued in pcg_verify.PCG_RULE_CATALOG):

DET001 nondeterministic-op  the recorded step runs an op PyTorch documents
       as nondeterministic on CUDA (`index_add_`, `scatter_add_` with
       colliding indices, `index_put_(accumulate=True)` and the like:
       atomic accumulation in schedule order). A hand-written kernel that
       accumulated with `atomicAdd` would count the same way; none does
       (error)
DET002 fingerprint-drift  the step program's fingerprint recorded at
       compile (`search_provenance["exec"]`, persisted beside the
       checkpoints as `exec_contract.json`) no longer matches the program
       about to run, under the same `program_key` (error)
DON001 dropped-donation  a state leaf the step hands back is not the
       tensor it was given (a new storage): the update was not in place,
       so the old buffer stays live beside its update (error)
DON002 undonated-state  a state leaf the memory model prices as updated
       in place is not handed back by the step at all (error)

The fingerprint hashes the step's canonical text (its ops with dtypes and
shapes, its kernel launches, its collectives), the loss, the optimizer and
its constants, the dtypes and `steps_per_dispatch`. `program_key` hashes
the argument shapes and dtypes only: a batch-growth recompile changes it,
which is a legitimately different program (`program_changed`), not DET002.
The record names `torch_version` where the JAX package's names
`jax_version`; a record written by the JAX package (the checkpoint layouts
are one, so either package resumes the other's directory) is no contract
of this program's: it gives `match: None`, never DET002.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.analysis.diagnostics import (
    Diagnostic,
    error,
    human_bytes as _human_bytes,
)

EXEC_RULE_IDS = ("DET001", "DET002", "DON001", "DON002")

# DON002 floor: state leaves below this are never flagged (a step counter
# cannot move a memory verdict; a weight matrix can)
DEFAULT_STATE_BYTES_FLOOR = 1024

CONTRACT_SCHEMA = 1
CONTRACT_FILENAME = "exec_contract.json"


def fingerprint_text(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _torch_version() -> str:
    import torch

    return torch.__version__


@dataclass
class DeterminismFinding:
    """One nondeterministic op of the recorded step."""

    kind: str
    name: str
    detail: str

    def to_json(self) -> dict:
        return {"kind": self.kind, "name": self.name, "detail": self.detail}


@dataclass
class DonationRecord:
    """One state leaf of the step program."""

    arg: str
    path: str
    flat_index: int
    bytes: int
    donated: bool  # the step hands the leaf back
    expected_inplace: bool  # the memory model prices it as updated in place
    kept: bool = True
    aliased: bool = False  # handed back in the storage it came in

    @property
    def leaf(self) -> str:
        return f"{self.arg}{self.path}"

    def to_json(self) -> dict:
        return {
            "leaf": self.leaf,
            "bytes": int(self.bytes),
            "donated": self.donated,
            "expected_inplace": self.expected_inplace,
            "kept": self.kept,
            "aliased": self.aliased,
        }


@dataclass
class ExecContractAnalysis:
    """One step program's execution contract."""

    hlo_fingerprint: Optional[str]  # no compiled module in the port: None
    program_fingerprint: Optional[str]
    program_key: str
    determinism: List[DeterminismFinding]
    donation: List[DonationRecord]
    num_partitions: int = 1
    state_bytes_floor: int = DEFAULT_STATE_BYTES_FLOOR
    extra: Dict[str, object] = field(default_factory=dict)

    @property
    def donated(self) -> List[DonationRecord]:
        return [r for r in self.donation if r.donated]

    @property
    def donated_bytes(self) -> int:
        return sum(r.bytes for r in self.donated)

    @property
    def aliased_bytes(self) -> int:
        return sum(r.bytes for r in self.donated if r.aliased)

    @property
    def donation_coverage(self) -> Optional[float]:
        """In-place fraction of the handed-back state bytes."""
        if not self.donated:
            return None
        total = self.donated_bytes
        return 1.0 if total == 0 else self.aliased_bytes / total

    @property
    def dropped_donations(self) -> List[DonationRecord]:
        return [r for r in self.donated if not r.aliased]

    @property
    def undonated_state(self) -> List[DonationRecord]:
        return [r for r in self.donation
                if r.expected_inplace and not r.donated and r.bytes >= self.state_bytes_floor]


def analyze_step_program(program,
                         state_bytes_floor: int = DEFAULT_STATE_BYTES_FLOOR
                         ) -> ExecContractAnalysis:
    """The execution-contract pass over one recorded step
    (step_program.StepProgram)."""
    records = [
        DonationRecord(arg=s.arg, path=s.path, flat_index=i, bytes=s.bytes, donated=s.donated,
                       expected_inplace=s.expected_inplace, kept=s.kept, aliased=s.aliased)
        for i, s in enumerate(program.state)
    ]
    determinism = [DeterminismFinding(f["kind"], f["name"], f["detail"])
                   for f in program.nondeterministic]
    extra: Dict[str, object] = {"kernel_launches": program.kernel_route()}
    if program.step_bytes is not None:
        extra["step_bytes"] = int(program.step_bytes)
    return ExecContractAnalysis(
        hlo_fingerprint=None,
        program_fingerprint=program.program_fingerprint(),
        program_key=program.program_key(),
        determinism=determinism,
        donation=records,
        num_partitions=len(program.rank_texts or [None]),
        state_bytes_floor=int(state_bytes_floor),
        extra=extra,
    )


def exec_diagnostics(analysis: ExecContractAnalysis) -> List[Diagnostic]:
    """DET001 + DON001/DON002 over a finished analysis (DET002 is the
    cross-compile check, `compare_contract_records`)."""
    diags: List[Diagnostic] = []
    for f in analysis.determinism:
        diags.append(error(
            "DET001",
            f"nondeterministic op in the step program: {f.detail}",
            tensor=f.name,
            hint="a step with run-to-run noise cannot deliver bitwise resume or chaos-soak "
            "recovery: gather instead of scattering, or sort the indices and reduce "
            "segments (torch.use_deterministic_algorithms names the alternative)"))
    for r in analysis.dropped_donations:
        diags.append(error(
            "DON001",
            f"state leaf {r.leaf} ({_human_bytes(r.bytes)}) was handed back in a new "
            "storage: the update was not in place, so the old buffer stays live beside its "
            "update, doubling this leaf's residency against the memory model",
            tensor=r.leaf,
            hint="update the leaf in place (`.copy_`, `.add_`, an `out=` kernel) and hand "
            "back the tensor the step was given"))
    for r in analysis.undonated_state:
        diags.append(error(
            "DON002",
            f"state leaf {r.leaf} ({_human_bytes(r.bytes)}) is priced as updated in place "
            "by the memory model but the step does not hand it back: the caller keeps the "
            "old tensor beside whatever replaces it",
            tensor=r.leaf,
            hint="return the updated state tree from the step"))
    return diags


# -- contract records (DET002: compile/resume/recompile re-verification) ----


def contract_record(analysis: ExecContractAnalysis) -> dict:
    """The persistable fingerprint record (`exec_contract.json`, the
    `search_provenance["exec"]` subset)."""
    return {
        "schema": CONTRACT_SCHEMA,
        "program_fingerprint": analysis.program_fingerprint,
        "hlo_fingerprint": analysis.hlo_fingerprint,
        "program_key": analysis.program_key,
        "torch_version": _torch_version(),
    }


def compare_contract_records(stored: Optional[dict], current: Optional[dict]
                             ) -> Tuple[dict, Optional[Diagnostic]]:
    """DET002: does the program about to run match the recorded one?
    Returns (check record, diagnostic or None). A changed `program_key` is
    a legitimately different program (`program_changed`); a record of the
    JAX package's runtime is no contract of this program (`match: None`)."""
    if not stored or not current:
        return {"match": None, "reason": "no recorded contract"}, None
    if "torch_version" not in stored:
        return {"match": None,
                "reason": "the recorded contract is another runtime's ("
                + ("jax " + str(stored["jax_version"]) if "jax_version" in stored
                   else "no torch_version") + ")"}, None
    if stored.get("program_key") != current.get("program_key"):
        return {
            "match": None,
            "program_changed": True,
            "stored_program_key": stored.get("program_key"),
            "program_key": current.get("program_key"),
        }, None
    for fp_field in ("hlo_fingerprint", "program_fingerprint"):
        a, b = stored.get(fp_field), current.get(fp_field)
        if a and b:
            match = a == b
            check = {"match": match, "fingerprint_field": fp_field, "stored": a, "current": b}
            if stored.get("torch_version") != current.get("torch_version"):
                check["torch_version_changed"] = (
                    f"{stored.get('torch_version')} -> {current.get('torch_version')}")
            if match:
                return check, None
            return check, error(
                "DET002",
                "step-program fingerprint drift: the program no longer matches the recorded "
                f"contract ({fp_field} {a[:12]} -> {b[:12]}) — bitwise resume is not "
                "guaranteed for this run",
                hint="the model/optimizer/loss definition, compile flags, or torch version "
                "changed since the contract was recorded; re-anchor deliberately (delete "
                f"{CONTRACT_FILENAME}) if the change is intended")
    return {"match": None, "reason": "no comparable fingerprint"}, None


def write_contract_record(directory: str, record: dict) -> str:
    path = os.path.join(directory, CONTRACT_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def read_contract_record(directory: str) -> Optional[dict]:
    path = os.path.join(directory, CONTRACT_FILENAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


# -- drivers ----------------------------------------------------------------


def verify_exec(pcg, mapping: Optional[dict] = None, machine_spec=None, lowered=None,
                state_bytes_floor: int = DEFAULT_STATE_BYTES_FLOOR
                ) -> Tuple[ExecContractAnalysis, List[Diagnostic]]:
    """One-call driver (ffcheck --exec): record the plan's step (unless a
    recorded one is given) and run the determinism and in-place audit."""
    if lowered is None:
        from flexflow_tpu_torch.analysis.step_program import record_plan

        lowered = record_plan(pcg, mapping, machine_spec=machine_spec)
    analysis = analyze_step_program(lowered, state_bytes_floor=state_bytes_floor)
    return analysis, exec_diagnostics(analysis)


def step_program_fingerprint(instance, loss_attrs, params, opt_state, label_dtype=None,
                             steps_per_dispatch: int = 1, batch_size=None) -> dict:
    """The contract record of any training backend (what the data-parallel
    and single-device backends persist beside their checkpoints): one
    recorded step of the instance, on a copy of its state."""
    from flexflow_tpu_torch.analysis.step_program import record_step

    prog = record_step(instance, params, opt_state, loss_attrs, label_dtype=label_dtype,
                       steps_per_dispatch=steps_per_dispatch, batch_size=batch_size)
    return contract_record(analyze_step_program(prog))


# -- rendering (ffcheck --exec) ---------------------------------------------


def format_exec_table(analysis: ExecContractAnalysis) -> str:
    """Human-readable contract report (`ffcheck --exec`)."""
    lines = [
        f"program fingerprint: {analysis.program_fingerprint} "
        f"(program key {analysis.program_key}, {analysis.num_partitions} rank(s))",
        "leaf                                 bytes      returned  in place",
    ]
    for r in analysis.donation:
        lines.append(f"{r.leaf:<36} {_human_bytes(r.bytes):>9}  "
                     f"{'yes' if r.donated else 'NO':>8}  {'yes' if r.aliased else 'NO':>8}")
    cov = analysis.donation_coverage
    lines.append("in-place coverage: " + (f"{100.0 * cov:.1f}% of the state bytes"
                                          if cov is not None else "n/a (no state)"))
    if analysis.determinism:
        lines.append("nondeterministic ops:")
        for f in analysis.determinism:
            lines.append(f"  {f.kind:<20} {f.name}: {f.detail}")
    else:
        lines.append("nondeterministic ops: none")
    return "\n".join(lines)


def exec_summary_json(analysis: ExecContractAnalysis) -> dict:
    """The `ffcheck --exec --json` summary object: the JAX package's schema
    v1 fields."""
    cov = analysis.donation_coverage
    by_kind: Dict[str, int] = {}
    for f in analysis.determinism:
        by_kind[f.kind] = by_kind.get(f.kind, 0) + 1
    return {
        "exec": 1,
        "hlo_fingerprint": analysis.hlo_fingerprint,
        "program_fingerprint": analysis.program_fingerprint,
        "program_key": analysis.program_key,
        "num_partitions": int(analysis.num_partitions),
        "donated_leaves": len(analysis.donated),
        "donated_bytes": int(analysis.donated_bytes),
        "aliased_leaves": sum(1 for r in analysis.donated if r.aliased),
        "aliased_bytes": int(analysis.aliased_bytes),
        "donation_coverage": None if cov is None else round(cov, 4),
        "dropped_donations": [r.to_json() for r in analysis.dropped_donations],
        "undonated_state_leaves": [r.to_json() for r in analysis.undonated_state],
        "determinism_findings": [f.to_json() for f in analysis.determinism],
        "determinism_by_kind": by_kind,
        "state_bytes_floor": int(analysis.state_bytes_floor),
    }
