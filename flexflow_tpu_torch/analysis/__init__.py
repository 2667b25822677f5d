"""Static analyses, with the JAX package's rule ids and record shapes:

- `pcg_verify`: the PCG verifier (PCG001-PCG011, MV001-MV004);
- `rule_audit`: the substitution soundness audit (RULE001-RULE003);
- `memory_accounting`, `memory_analysis`: the per-device memory model and
  its verifier (MEM001-MEM005), and the measured cross-check;
- `step_program`: one recorded step of a compiled instance, which the
  communication and execution-contract passes read;
- `comm_analysis`: the collective census against the priced movement
  edges (COMM001-COMM004);
- `exec_contract`: determinism and in-place state (DET001, DET002, DON001,
  DON002);
- `transition_analysis`: an old plan -> new plan swap (TRN001-TRN004);
- `source_lints`: AST lints over the port's sources (LINT001-LINT010).

`python3 -m flexflow_tpu_torch.ffcheck` drives them."""
