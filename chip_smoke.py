#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one card.

    python3 chip_smoke.py [--phases a,b,...]

Without arguments every phase runs; `--phases` runs only the named ones
(besides device and build), for intermediate runs: a phase that reads
another's result (search and roofline read train's step, search_warm
search's store, search_mcmc search_warm's process, plan_serve serve's
measurements, plan_audit search's run, frontends search's store) says
which to add. Every phase prints its wall seconds on a line of its own,
and before the kernel table one {"phase_wall_s": ...} line collects them.

Phases, each printing one JSON line:

1. device         the card's name and power limit (nvidia-smi) and the
                  versions;
2. build          nvcc builds every kernel from the checkout's sources; build
                  time and each kernel's registers, shared memory and spills
                  (the Hopper forwards and backwards must not spill; the
                  d=256 forward and backward pair's again on their own) and
                  ptxas's warnings;
3. kernels        each kernel against its plain PyTorch version on the same
                  bf16 inputs, and timed beside its plain version, its bound
                  and one PyTorch call that computes the same function (never
                  used by the port): the d=128 kernels at the flagship's
                  attention (b=64, h=8, s=512) and at the seq-2048 flagship's
                  (b=16, h=8, s=2048), the d=64 kernels at the 16-head
                  config's (b=64, h=16, s=512) on the interleaved-QKV and on
                  separate operands, the d=128 pair causal at seq 2048 and
                  the d=64 interleaved pair causal at seq 512, the d=256
                  kernels at BERT-base's attention (b=64, h=12, s=512), plus
                  small causal cases, the tiling edges (s=192 and 320) and
                  the delta kernels' tails (delta_tails); then every head
                  dim the padded widths added (kernels_head_dims) and every
                  head dim past 256 on the wide kernels (kernels_wide_dims:
                  d = 264-2048 against the plain versions, carried uneven
                  ring steps, timed at bench.py --heads 2's, BERT-base at
                  num_heads=8's and --heads 1's attention, per-head and
                  ring shapes beside SDPA);
4. parity         small flagships (heads of 128, 64, 32 and, on the wide
                  kernels, 384) trained two steps on the card (bf16,
                  through the kernels) and on the CPU (f32, plain versions)
                  from the same parameters: the losses must agree;
5. train          the full-width flagship (12 layers, hidden 1024, 8 heads of
                  128, seq 512, vocab 32000, batch 64), bf16 compute,
                  Adam(1e-4): one warm-up step, then five timed steps with
                  every launch count set to 0 just before and read just after;
6. train_heads16  the same for the 16-head config (16 heads of 64), whose
                  attention runs the d=64 kernels on the fused projection;
                  train_heads32 and train_heads2 for bench.py --heads 32
                  (rows 1-3 at d=32) and --heads 2 (heads of 512: rows 1-3
                  on the wide kernels, each 12 times a step);
7. search         the Unity search (flexflow_tpu_torch.compiler) plans the
                  full flagship for one node of 8 H100s (NVLink and
                  InfiniBand at datasheet rates): the card's calibrated bf16
                  matmul FLOP/s and memory GB/s, then graph_optimize over the
                  159 rules at degrees 2, 4, 8 with budget 4, each leaf timed
                  on this card with CUDA events through kernels.ops.forward
                  and autograd in bf16 (attention leaves through rows 1-3's
                  d=128 flash kernels): search seconds by phase, explored,
                  the winner, the serial plan and every seed, the leaves
                  measured and priced inf, the launches (each leaf's CUDA-
                  graph replays counted); the winner finite and no worse
                  than the serial plan and every seed, the dp8 seed and
                  every attention leaf at a flash shape finite, rows 1-3
                  launched and no ring kernel, the phase under 3 minutes,
                  and rows 1-3 against their plain versions at every flash
                  shape the search measured; then the unrewritten
                  flagship's 1-device estimate, measured and analytic (at
                  the calibrated rates), beside train's median step; every
                  leaf it times goes to a cost store (compiler/cost_store.py)
                  in a temporary directory;
7a. search_warm   a fresh process plans the flagship for the same 8 H100s
                  from that store: no leaf timed, no flash kernel launched,
                  search's winner and estimate exactly, and its phase_ms;
                  then (in that process) the store's entries stamped with
                  another device kind: the search reads none of them and
                  times every leaf it looks up;
7b. search_mcmc   MCMC (search_algorithm="mcmc", 40 evaluations: the
                  Unity search's budget) for the flagship on 8 H100s from
                  the warm store, in the same process: winner, estimate,
                  evaluations, seconds, the leaves it timed; the winner
                  beats the serial plan and is within 10% of the Unity
                  winner's estimate;
7c. search_nodes  the flagship's widths at 2 layers planned for 2 nodes x 8
                  H100s under machine_model_version=1 (NVSwitch within a
                  node, InfiniBand NIC ports across) with multislice's
                  two-level DP, analytic at the H100 peaks, beside the flat
                  DP: both estimates, the outer level's choices, the flat
                  winner re-priced two-level, the winner's movement edges
                  split into nvlink and ib (export_movement_predictions),
                  seconds by search phase;

then the user API, FFModel (flexflow_tpu_torch.core):

8. parity_fit     tests/test_ffmodel_api.py's MLP (32 -> 16 relu -> 4, batch
                  8) fit 30 shuffled epochs on a seeded 64-sample set and
                  evaluated, on the card and on the CPU (f32, TF32 off): the
                  same PerfMetrics counts and final parameters within 1e-5;
9. stepped        the small flagship (bf16) through forward / zero_gradients
                  / backward / update: its weight gradients against the
                  whole step's, a second backward accumulating to twice the
                  first, and each flash kernel launched once per layer per
                  forward or backward;
10. fit           the flagship built by build_flagship_cg, compiled through
                  FFModel (bf16, Adam(1e-4)) and fit on 5 seeded batches of
                  host data after a one-batch warm-up fit: step ms, the
                  batch's host gather and copy ms, peak memory, PerfMetrics,
                  launches, the profiled fit's kernel ms and idle share; the
                  final parameters bitwise equal to the same batches driven
                  through train_step directly;
11. parity_fit_window  tests/test_fused_dispatch.py's Dropout MLP fit on
                  the card at steps_per_dispatch 4 and 3 (the tail window)
                  against the per-step loop, two epochs, then
                  set_learning_rate and one more: every step's loss and the
                  parameters bitwise equal, the CUDA graphs captured and
                  dropped as the window lengths and the learning rate say;
12. fit_window    the flagship through FFModel at steps_per_dispatch=8: a
                  one-window warm-up fit, where the graph is captured; the
                  state put back in place; a timed fit of two windows of
                  seeded host batches (step ms, the pipeline's fill, capture
                  ms, peak memory allocated and reserved); a profiled fit
                  whose trace must count 96 launches a window of each of
                  rows 1-3's four kernels and no other flash or ring kernel
                  (a replayed graph runs no wrapper, so the wrappers' counts
                  stay 0); the parameters and step losses bitwise equal to
                  the 16 batches through train_step (or within the window
                  bounds, saying so), the optimizer's step count 16;

then the example zoo:

13. parity_zoo    a 2-layer BERT with heads of 256 trained two SGD steps on
                  the card (bf16, the d=256 kernels) and on the CPU (f32)
                  from the same parameters: the losses within 1e-2, and
                  each attention layer's update (q, k, v, o weight pieces,
                  q and v input bias) within 0.2, a bound that two broken
                  d=256 paths run on the CPU (dS dropped; scores at twice
                  the scale) must each exceed; a small
                  CNN of the zoo's ops (conv2d with groups and bias, max and
                  avg pool with padding, batch_norm, flat, concat, dense)
                  fit one batch through FFModel on the card and on the CPU
                  (f32, TF32 off): loss and parameters within 1e-4;
14. fit_bert      BERT-base at examples/bert.py's defaults (12 layers,
                  hidden 768, 12 heads of 256, seq 512, vocab 30522, batch
                  64, dropout 0.1) through FFModel in bf16 with SGD(0.01):
                  a warm-up batch, then a fit of 5 seeded host batches with
                  the launch counts set to 0 just before: step ms, tokens/s,
                  MFU (op_forward_flops x 3), peak memory allocated and
                  reserved, each d=256 wrapper 12 times a step and no other
                  flash or ring kernel, a profiled fit's kernel ms and idle
                  share, a finite loss;
15. examples      the port examples at tests/test_examples.py's sizes on
                  the card (split_test with and without --branch-stacking,
                  split_test_2 among them), each printing finite step
                  losses;

then, in a one-rank NCCL process group opened over a file:// store:

16. parity_dp     the two small flagships trained two steps by the
                  data-parallel trainer on the card (bf16, per-head kernels)
                  and by the single-device trainer on the CPU (f32);
17. train_dp      the flagship through the data-parallel trainer, whose
                  attention runs the per-head [b, h, s, d] kernels;
18. train_dp_seq2048  the same for the seq-2048 flagship (batch 16, seq 2048),
                  whose attention runs the same kernels at s > block;
    (fit_bert_dp BERT-base and train_heads2_dp bench.py --heads 2's
    flagship through the same trainer: rows 9-12 at d=256, rows 9-11 on
    the wide kernels, the first two losses within 1e-2 of train_heads2's)
19. ring_replay   the ring schedule of 4 ranks replayed on the card through
                  the ring-flash step kernels at the long-context shape (b=4,
                  h=8, s=8192, d=128, causal; and b=1 non-causal; d=96; and
                  h=2 at d=384 on the wide step kernels), held against the
                  full-sequence per-head kernels;
20. parity_sp     two small causal parallel transformers (seq 1024, heads of
                  128 and of 64) trained two steps by the sequence-parallel
                  trainer on the card (bf16, ring kernels) and on the CPU
                  (f32, plain versions, over a one-rank gloo group);
21. train_sp      SP_LONGCTX (the flagship's widths, causal, batch 4, seq
                  8192) through the sequence-parallel trainer at world size
                  1, whose attention runs the ring-flash step kernels;
22. train_dp_window  the flagship through DataParallelTrainingInstance.
                  multi_train_step at K=8 (bf16, Adam(1e-4)): the first
                  window captures one CUDA graph, every gradient bucket's
                  NCCL all-reduce issued through the NCCL group during
                  the capture (at world size 1 NCCL runs no kernel for an
                  in-place all-reduce, so what the graph holds of them
                  shows only on several cards), two
                  windows bitwise equal to 16 train_step calls (or within
                  the window bounds, saying so), a profiled window whose
                  trace counts rows 9-11's four kernels 96 times and no
                  other flash or ring kernel: step ms, idle share, MFU, the
                  buckets and those issued before the backward's end;

then several ranks, each a process of its own started after the build,
sharing the card over an explicit gloo group (NCCL refuses two ranks on one
card; gloo stages each collective through host memory, so their step times
are no NVLink or NCCL figure):

23. parity_tp     the small flagship (4 heads of 64) under the tp2 seed on 2
                  ranks and the dp2 x tp2 seed on 4: two Adam steps on the
                  card (bf16, rows 9-11 at the local head count) against the
                  same ranks on the CPU (f32, plain versions): the losses,
                  each rank's launches, and every step's collectives equal
                  to what the plan implies;
24. train_tp      the flagship at full width and depth (batch 16) under the
                  tp2 seed on 2 ranks: a warm-up and 3 timed Adam steps in
                  bf16, 12 launches a step per rank of each of rows 9-11
                  and no other flash kernel, 48 all-reduces and 1
                  all-gather a step as the plan implies, the losses and the
                  gathered parameters against the single-device
                  train_step from the same values on the card;
25. fit_searched  FFModel.compile(search_budget=2) on 2 ranks at the
                  flagship's widths at 10 layers (batch 16): rank 0 searches
                  on the H100 constants, every rank trains the winner it
                  prints (a parallel plan), rank 0 exports the strategy,
                  and a second compile that imports it trains to
                  bitwise-equal losses and parameters;
26. parity_ranks_window  FFModel.fit at steps_per_dispatch=4 over 5 batches
                  (a window of 4 and a tail of 1) on 2 ranks, data parallel
                  (the small flagship, its gradients in 10 buckets) and the
                  imported fit_searched plan: bitwise equal to the K=1 fit
                  on every rank, each window reported `captured: false`
                  (gloo's host-staged collectives fit no CUDA graph);
27. calibrate_ranks  compiler.calibration over 2 and over 4 ranks: one
                  equal calibration on every rank (all-reduce constants,
                  overlap, shard speedup), the ranks an emulated mesh;
                  then at 2 ranks fit_searched's job with
                  cost_model="calibrated": the winner it prints, its
                  estimate and the serial plan's (no winner required);
28. parity_overlap  the collective matmuls on 2 and on 4 ranks (bf16): a
                  Linear fed by a Combine (ag_matmul) and a row Linear
                  feeding a Reduction (matmul_rs) with the overlap lowering
                  against the serial one on the same parameters: forwards
                  within the JAX spec's bf16 tolerance, k-1 ring steps a
                  forward and a step (the ring staged through pinned host
                  memory), a finite train step issuing what its plan
                  implies;
29. torchrun      `torchrun --standalone --nproc_per_node 2` runs a 2-rank
                  searched fit of the small flagship whose ranks open their
                  group through runtime.distributed.initialize(backend=
                  "gloo"); rank 0 alone searches, and the losses and
                  parameters are bitwise the same job's over a file://
                  store;
29a. fit_overlap  one job of 2 ranks: a searched compile with overlap=True
                  (analytic, the H100 constants) of a weight-heavy MLP
                  (OVERLAP_MLP, whose winner is tensor parallel with a
                  matmul_rs site) prices the fused edge and trains through
                  the collective matmul, its losses within 1e-4 of the same
                  plan without overlap (the first batch's logits within
                  1e-2, each parameter's change within 3e-3), k-1 ring
                  steps a step, its audit's
                  fused edges timed as fused; then a searched compile of
                  the small flagship with perform_fusion and a legacy TASO
                  rule file the phase writes trains, rows 9-11 once per
                  layer per step on each rank;

Each multi-rank training phase prints its MFU (the model's own step flops,
kernels.ops.graph_step_flops, over step seconds x ranks x 989 TFLOP/s) and
each step's gradient buckets with those issued before the backward's end,
at least one wherever a step has two or more;

then serving, whose attention is dense f32 as in the JAX package (every
flash and ring launch count must stay at 0):

30. parity_serve  two small serving LMs (ServingLMConfig(), and 2 layers of
                  embed 256 in 2 heads of 128) from the same numpy
                  parameters on the card and on the CPU (f32 both): prefill
                  logits and caches, the tokens of 8 seeded requests through
                  ServingEngine in continuous and static mode, one fused
                  decode window bitwise equal to one-step windows, and two
                  captured windows bitwise equal to the eager body;
31. serve         the serving LM at the flagship's widths (SERVE_LM) serving
                  SERVE_TRAFFIC (64 slots of 1024 positions, 128 requests,
                  continuous batching, windows of 8) after one warm-up
                  request: requests/s, output tokens/s, ms/token p50/p99,
                  prefill ms, decode ms a step beside its bound (the decode
                  windows are CUDA graphs, one per step count and cache),
                  the host and device split of a captured and of an eager
                  decode window, peak memory allocated and reserved; a
                  captured window bitwise equal to the eager body, the
                  cache's bytes equal per_device_cache_bytes, every request
                  gets its budget of tokens, and 4 requests match a
                  teacher-forced prefill;

then a searched plan served across ranks, and the plan ops the executor
lowers on whole values:

32. plan_serve    the serving search (serving/plan.py) plans serve's LM,
                  cut to 10 of its 12 layers (PLAN_SERVE_LM), at
                  its 64 slots of 1024 for a node of 8 H100s (prompts at
                  serve's median prefill width, generations at the
                  traffic's mean budget), analytically at the H100
                  constants and with each leaf's forward timed on the card
                  (f32), unbudgeted and under a budget below the serial
                  plan's cache: winners, ms/token, decode and prefill
                  estimates, the serial ones, leaves and seconds; the
                  budgeted winners pass verify_memory at that budget with
                  a smaller per-device cache than the serial plan's; the
                  1-device estimates (10 layers) over serve's measured
                  decode step and prefill (12 layers; printed, no bound);
33. serve_ranks   serve's widths at 2 layers on 2 and 4 gloo ranks sharing
                  the card (f32, TF32 off) under a 4-device budgeted search
                  winner, tp2 and dp2 x tp2: on every rank greedy tokens
                  and the engine's trace equal the single-device program's,
                  prefill logits within SERVE_PARITY_BOUND, the cache's
                  allocation exactly per_device_cache_bytes, the window
                  not captured (gloo) and no flash launch; ms/token and
                  tokens/s (host-staged collectives, no NVLink figure);
34. parity_plan_ops  the flagship's widths at 2 layers (f32, TF32 off):
                  Dropout(0.1) under dp2 x tp2 on 4 ranks (every step's
                  masks bitwise the single device's, and what drawing
                  them whole costs a rank), logits that reach the loss cut
                  over their classes, and a ReLU on partial sums (a
                  whole-tensor node), on 2 ranks: losses, first-step
                  gradients and parameters within 1e-4 of one card's;

then checkpoints, bitwise resume and the fit loop's fault sites:

35. fit_resume    the flagship's widths at 6 layers (RESUME_LAYERS) through
                  FFModel at steps_per_dispatch=8 (bf16,
                  Adam(1e-4)), two shuffled epochs of 16 seeded batches, from
                  compile's state each time: the fit without checkpoints, run
                  A with async snapshots every 8 steps (snapshot bytes, the
                  submit stall, the writer's D2H, serialize and commit times
                  and GB/s, the overhead, the peak memory the device copy
                  adds), run B killed by FF_TPU_FAULT_STEP inside window 3
                  under the profiler (rows 1-3's launches; the window's
                  snapshot durable when the fault propagates), resumed by the
                  model whose graph was captured before and by a new FFModel:
                  every step's loss, the parameters and both Adam moments
                  bitwise run A's; one sync save_checkpoint and one
                  load_checkpoint, timed;
36. chaos         runtime.chaos.soak_sites on the card: the Dropout MLP of
                  parity_fit_window in windows of 4 over ckpt_write, h2d, hang
                  and kill, and per step over ckpt_write, hang and kill, each
                  recovering to a bitwise final state (watchdog floor 1000 ms);
37. resume_ranks  the small flagship under the forced tp2 plan on 2 gloo ranks
                  sharing the card, killed and resumed bitwise on every rank,
                  rank 0 alone writing, rows 9-11 once per layer per step per
                  rank, the final 2-rank checkpoint restored into one device
                  with every parameter equal;

then pipelines and sub-mesh branches, one rank job per rank count carrying
both phases (gloo ranks sharing the card; no kernel of the table runs):

38. train_pp      the MLP trunk (examples/mlp.py's 64 x 1024, 4 x dense +
                  ReLU, cut at its last hidden layer) through
                  FFModel(pipeline=True) forced to pp2m4 on 2 ranks and
                  pp2m4 x dp2 on 4, bf16, Adam(1e-3): the 1F1B executor
                  and its provenance, a warm-up and 5 steps finite and
                  within 1e-2 of the same steps on the CPU in f32, the
                  1F1B steps bitwise the sequential schedule's and a K=4
                  window bitwise its steps, no flash launch; both
                  schedules' step ms, the measured bubble beside b(S, M),
                  each rank's max_memory_allocated beside the stash model's
                  peak; and on the host the budgeted search with pipeline
                  seeds for 8 H100s on the trunk and on bench.py
                  --pipeline's proxy, which must pick a pipelined plan;
39. fit_submesh   the two towers of tests/test_submesh.py through
                  FFModel(submesh_branches=True) on the same jobs (f32,
                  TF32 off): two SGD steps' losses and the parameters
                  within 1e-4 of one card's from the same values, each
                  branch's parameters only on its group, eval runs.

then (after the observability phases) Ulysses attention and mixture of
experts:

40. parity_moe    (a) fit_moe's Experts layer alone (8192 tokens of 1024, 8
                  experts of hidden 1024, top-2, capacity factor 2, aux
                  weight 0.04) in f32, TF32 off: kernels/moe.py's index
                  path against the dense plain version (the JAX package's
                  one-hot einsums) on the same inputs: the routing decisions
                  and the drops identical, the output, the aux loss and
                  every gradient within 1e-5, both timed forward and
                  backward; (b) a small MoE encoder (2 layers, hidden 256, 2
                  heads of 128, seq 512, 4 experts top-2) through FFModel,
                  two SGD steps on the card (bf16, rows 1-3) and on the CPU
                  (f32) from the same parameters: the losses within 1e-2,
                  and the share of routing decisions that differ (printed);
41. fit_moe       examples/moe.py's encoder at the flagship's widths (12
                  layers, hidden 1024, 8 heads of 128, seq 512, 8 experts
                  top-2, 32000 classes, batch 16) through FFModel in bf16
                  with the example's SGD: a warm-up batch and a fit of 5:
                  step ms, tokens/s, MFU, peak memory, rows 1-3 12 times a
                  step and no other flash or ring kernel; one profiled
                  step: the MoE layers' kernel ms by gate, dispatch, expert
                  products and combine, forward and backward;

then one rank job per rank count (gloo ranks sharing the card) carrying:

42. parity_ulysses  parity_sp's two small causal models (seq 1024, heads of
                  128 and of 64) with their attention relabelled
                  UlyssesAttention, at sp = 2 on 2 ranks: two Adam steps on
                  the card (bf16) and on the CPU (f32) on the same ranks:
                  losses within 1e-2, 4 all-to-alls a layer forward and 4
                  backward as the plan implies, no ring step or ring
                  kernel, rows 9-11 once a layer a step, s = 1024 on row
                  11's route;
43. train_ulysses SP_LONGCTX (12 layers, hidden 1024, 8 heads of 128, causal,
                  seq 8192, batch 4) under the Ulysses plan at sp = 2 on 2
                  ranks: a warm-up and 3 timed Adam steps in bf16, each
                  rank's 4 heads over all 8192 positions through rows 9, 10
                  and 12 (12 launches a step each, none of rows 13-15), 96
                  all-to-alls a step; step ms, MFU; the first loss within
                  1e-2 of the single-device step of the same plan at sp = 1
                  from the same parameters on the card;
44. moe_ranks     f32, TF32 off, aux weight 0.5: (a) a searched compile
                  (analytic, the H100 constants) of test_searched_moe's
                  model at widths where its winner shards the experts, on 2
                  ranks; (b) tests/test_moe.py's dp2 x ep2 PCG on 4 ranks;
                  (c) a data-parallel fit of parity_moe's encoder on 2
                  ranks: each run's losses and parameters within 1e-3 of
                  one card's from the same values, its aux losses present,
                  its collectives printed (and, for (b), every step's equal
                  to what the plan implies).

then (after program-level verification, the recompiles and the serving
contract) the model frontends:

45. frontends     (needs search: the CLIs read its cost store) (a) the
                  flagship written as an .ffir file (models.build_flagship_ir)
                  and imported through PyTorchModel.from_file(...).apply_ir,
                  compiled as fit does (bf16, Adam(1e-4)): a warm-up fit and
                  3 timed steps, rows 1-3 12 times a step each and no other
                  wrapper, step ms, tokens/s, MFU and peak memory beside
                  fit's, and the parameters bitwise those of
                  build_flagship_cg's model fitted from the same values on
                  the same batches; (b) tests/test_torch_frontend.py's MLP,
                  ConvNet and ResidualNet on the card, imported by fx with
                  their weights transferred: forwards within 1e-4 of the
                  modules' own (f32, TF32 off), and an nn.MultiheadAttention
                  block's trace raising getitem; (c) a Keras Sequential
                  784-512-512-10 MLP and the functional two-branch
                  Concatenate model, one epoch each, and (d)
                  tests/fixtures/tiny_mlp.onnx through the wire-format
                  reader, two steps: f32 losses within 1e-4 of the CPU
                  port's from the same parameters; (e) tools.cost_db verify
                  and stats on search's store (its device kind this card's),
                  tools.ffreport --json on fit_health's metrics dir (or,
                  without fit_health, a short fit of (c)'s MLP here) with
                  that run's step count.

then the Unity-vs-DP A/B harness:

46. ab            the port's tools/bench_ab.py on 2 gloo ranks sharing the
                  card, each subject's searched plan (rank 0 searches,
                  analytic, budget 12) and data-parallel plan from the same
                  initial values, each one untimed step and 3 samples of 1
                  and 3 steps: transformer at the flagship's widths (2
                  layers, batch 16) and mlp at 4096 wide (2 layers, batch
                  64): both plans' parallel degrees, step ms, the speedup,
                  the search's estimate and seconds; every first loss within
                  1e-5 of the DP plan's (1e-2, train_tp's bound, for a
                  plan that sums tensor-parallel partials in bf16), every
                  step time finite, rows 9-11
                  once per layer per step on every rank in both transformer
                  plans (a ring winner's rows 13-15 instead, named) and no
                  launch in the MLP's; then tools/merge_ab.py's note over
                  the two lines.

The kernels phase also holds the per-head kernels at the attention shapes of
train_dp, of train_dp_seq2048 and of the 16-head config, on contiguous
operands and (train_dp's and the 16-head config's) on the projection
einsum's strided view, and the ring-flash
step kernels at train_sp's shape, at the replay's (one with the first
64-row warpgroup of each block blind), at d=64, and with s_blk != t_blk,
each carried step adding into random accumulators. Then the kernel table
as one {"kernels": [...]} line (the redesigned kernels, forwards,
backwards and deltas, with their design and ptxas figures; each kernel's
launches are its wrapper's counts in the train phases and fit (summed
over the ranks in the multi-rank phases), the
search's wrapper counts with each leaf's graph replays added, and the
profiler's count in fit_window, in train_dp_window's profiled window and
in fit_resume's run B), and last the
line {"ok": true,
"device": {...}}. Any failed check raises and the script exits non-zero.
Without a CUDA device, or away from a checkout of the repository, it exits
non-zero before printing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, HBM
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

REL_BOUND = 2e-2  # o, dq, dk, dv: the JAX package's own bf16 backward bound
LSE_BOUND = 1e-3  # max abs, f32 from the same bf16 inputs
DELTA_BOUND = 1e-4  # norm-relative, exact bf16 products summed in f32
PARITY_BOUND = 1e-2  # relative loss difference, bf16 card vs f32 CPU
FIT_PARITY_BOUND = 1e-5  # relative parameter difference, f32 card vs f32 CPU (parity_fit)
STEPS = 5  # timed steps of each train phase

SOURCE = "flexflow_tpu_torch/csrc/flash_attention.cu"
TPU_KERNELS = "flexflow_tpu/kernels/flash_attention.py"
RING_SOURCE = "flexflow_tpu_torch/csrc/ring_flash.cu"
RING_TPU_KERNELS = "flexflow_tpu/kernels/ring_flash.py"
# the wrappers whose kernels were redesigned for Hopper, with the kernels
# that carry each: the delta wrappers run delta_body of
# csrc/flash_attention.cu (16-byte loads, several rows a thread in flight,
# coalesced [b, h, s] stores), every other attention wrapper a Hopper
# mainloop (wgmma products, TMA tile loads, scores and accumulators in
# registers), the forward's of csrc/flash_fwd_sm90.cuh or the backward
# pair's of csrc/flash_bwd_sm90.cuh
DELTA_DESIGN = "16-byte loads, rows in flight, coalesced stores"
# rows 1-3 at head dim 256 (BERT's heads), which flash_fwd, flash_delta and
# flash_bwd launch at d=256: the forward mainloop of csrc/flash_fwd_sm90.cuh
# at 64-key tiles, the head-split dK/dV and dQ mainloops of
# csrc/flash_bwd_sm90.cuh, and delta_body for the delta
D256_KERNELS = ("ff_flash_fwd_d256_kernel", "ff_flash_delta_d256_kernel",
                "ff_flash_bwd_dkv_d256_kernel", "ff_flash_bwd_dq_d256_kernel")
D256_DESIGN = ("wgmma+tma: forward at 64-key tiles; backward pair of 64-row blocks, the head "
               "dim split between warpgroups, score tiles shared through shared memory")
# the kernels of the padded widths past the flagship's (every head dim
# d % 8 == 0 up to 256 runs at the width 64, 128, 192 or 256 it rounds up
# to): the seq-major p64, p192 and d256, the per-head p192 and d256, and the
# ring's p192 and d256, by the wrapper that launches each
WIDTH_KERNELS = {
    "flash_fwd": ("ff_flash_fwd_p64_kernel", "ff_flash_fwd_p192_kernel",
                  "ff_flash_fwd_d256_kernel"),
    "flash_delta": ("ff_flash_delta_p64_kernel", "ff_flash_delta_p192_kernel",
                    "ff_flash_delta_d256_kernel"),
    "flash_bwd": ("ff_flash_bwd_dkv_p64_kernel", "ff_flash_bwd_dq_p64_kernel",
                  "ff_flash_bwd_dkv_p192_kernel", "ff_flash_bwd_dq_p192_kernel",
                  "ff_flash_bwd_dkv_d256_kernel", "ff_flash_bwd_dq_d256_kernel"),
    "flash_fwd_bhsd": ("ff_flash_fwd_bhsd_p192_kernel", "ff_flash_fwd_bhsd_d256_kernel"),
    "flash_delta_bhsd": ("ff_flash_delta_bhsd_p192_kernel", "ff_flash_delta_bhsd_d256_kernel"),
    "flash_bwd_bhsd": ("ff_flash_bwd_dkv_bhsd_p192_kernel", "ff_flash_bwd_dq_bhsd_p192_kernel",
                       "ff_flash_bwd_dkv_bhsd_d256_kernel", "ff_flash_bwd_dq_bhsd_d256_kernel"),
    "ring_fwd_step": ("ff_ring_fwd_step_p192_kernel", "ff_ring_fwd_step_d256_kernel"),
    "ring_dq_step": ("ff_ring_dq_step_p192_kernel", "ff_ring_dq_step_d256_kernel"),
    "ring_dkv_step": ("ff_ring_dkv_step_p192_kernel", "ff_ring_dkv_step_d256_kernel"),
}
DELTA_WRAPPERS = ("flash_delta", "flash_delta_d64", "flash_delta_bhsd")
# the wide kernels of head dims past 256 (csrc/flash_wide.cu), by the
# wrapper that launches each: rows 1-3 (seq-major), 9-12 (per-head) and
# 13-15 (the ring steps), whose narrow wrappers hand them every d > 256
WIDE_SOURCE = "flexflow_tpu_torch/csrc/flash_wide.cu"
WIDE_KERNELS = {
    "flash_fwd_wide": ("ff_flash_fwd_wide_kernel",),
    "flash_delta_wide": ("ff_flash_delta_wide_kernel",),
    "flash_bwd_wide": ("ff_flash_bwd_dkv_wide_kernel", "ff_flash_bwd_dq_wide_kernel"),
    "flash_fwd_bhsd_wide": ("ff_flash_fwd_bhsd_wide_kernel",),
    "flash_delta_bhsd_wide": ("ff_flash_delta_bhsd_wide_kernel",),
    "flash_bwd_bhsd_wide": ("ff_flash_bwd_dkv_bhsd_wide_kernel",
                            "ff_flash_bwd_dq_bhsd_wide_kernel"),
    "ring_fwd_step_wide": ("ff_ring_fwd_step_wide_kernel",),
    "ring_dq_step_wide": ("ff_ring_dq_step_wide_kernel",),
    "ring_dkv_step_wide": ("ff_ring_dkv_step_wide_kernel",),
}
WIDE_DESIGN = ("wgmma+tma: a block owns a chunk of 256 output columns and streams the head dim "
               "in 64-column panels (the scores over all of d, once per chunk)")
WIDE_DELTA_DESIGN = DELTA_DESIGN + ", 32 lanes a row and a 16-byte load a lane per 256 columns"
REDESIGNED = {
    "flash_delta": ("ff_flash_delta_kernel",),
    "flash_delta_d64": ("ff_flash_delta_d64_kernel",),
    "flash_delta_bhsd": ("ff_flash_delta_bhsd_kernel", "ff_flash_delta_bhsd_d64_kernel"),
    "flash_fwd": ("ff_flash_fwd_kernel",),
    "flash_fwd_d64": ("ff_flash_fwd_d64_kernel",),
    "flash_fwd_bhsd": ("ff_flash_fwd_bhsd_kernel", "ff_flash_fwd_bhsd_d64_kernel"),
    "ring_fwd_step": ("ff_ring_fwd_step_kernel", "ff_ring_fwd_step_d64_kernel"),
    "flash_bwd": ("ff_flash_bwd_dkv_kernel", "ff_flash_bwd_dq_kernel"),
    "flash_bwd_d64": ("ff_flash_bwd_dkv_d64_kernel", "ff_flash_bwd_dq_d64_kernel"),
    "flash_bwd_bhsd": ("ff_flash_bwd_dkv_bhsd_kernel", "ff_flash_bwd_dq_bhsd_kernel",
                       "ff_flash_bwd_dkv_bhsd_d64_kernel", "ff_flash_bwd_dq_bhsd_d64_kernel"),
    "ring_dq_step": ("ff_ring_dq_step_kernel", "ff_ring_dq_step_d64_kernel"),
    "ring_dkv_step": ("ff_ring_dkv_step_kernel", "ff_ring_dkv_step_d64_kernel"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require_card_and_repo():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, REPO)
    try:
        import flexflow_tpu_torch  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: run from a checkout of the repository ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
    })
    return smi


def phase_build() -> dict:
    from flexflow_tpu_torch.kernels import build
    from flexflow_tpu_torch.kernels import flash_attention as fa

    start = time.perf_counter()
    infos = build.build()
    seconds = time.perf_counter() - start
    ptxas = {}
    for info in infos.values():
        ptxas.update(build.parse_ptxas(info.ptxas_log))
    warnings = [line.strip() for info in infos.values() for line in info.ptxas_log.splitlines()
                if "warning" in line.lower()]
    # every kernel of the three libraries, those of every padded width and
    # the wide ones included
    for name in (*(n for names in REDESIGNED.values() for n in names),
                 *(n for names in WIDTH_KERNELS.values() for n in names),
                 *(n for names in WIDE_KERNELS.values() for n in names)):
        if ptxas[name].get("spill_store_bytes", 0) or ptxas[name].get("spill_load_bytes", 0):
            raise AssertionError(f"{name} spills: {ptxas[name]}")
    lib = fa.library()
    # ff_flash_smem_bytes gives the forward's, dK/dV's and dQ's at d=128
    # (0-2) and d=64 (3-5); the ring kernels run the same mainloops
    smem = {}
    for i, (flash, ring) in enumerate((("fwd", "fwd_step"), ("bwd_dkv", "dkv_step"),
                                       ("bwd_dq", "dq_step"))):
        for suffix, which in (("", i), ("_d64", i + 3)):
            smem[f"ff_flash_{flash}{suffix}_kernel"] = smem[f"ff_ring_{ring}{suffix}_kernel"] = \
                lib.ff_flash_smem_bytes(which)
    # 6-8: the d=256 forward, dK/dV and dQ kernels; 9-11 those of width 192
    for which, name in enumerate(("fwd", "bwd_dkv", "bwd_dq"), start=6):
        smem[f"ff_flash_{name}_d256_kernel"] = lib.ff_flash_smem_bytes(which)
        smem[f"ff_flash_{name}_p192_kernel"] = lib.ff_flash_smem_bytes(which + 3)
    # the wide kernels: 0 the forward (flash and ring), 1 dK/dV, 2 dQ
    wide_lib = fa.wide_library()
    for names in WIDE_KERNELS.values():
        for name in names:
            if "delta" not in name:
                kind = 1 if "dkv" in name else 2 if "dq" in name else 0
                smem[name] = wide_lib.ff_wide_smem_bytes(kind)
    if max(smem.values()) > 232448:
        raise AssertionError(f"a kernel asks for more shared memory than a block has: {smem}")
    # rows 1 and 3 at d=256 (the forward mainloop and the head-split backward
    # pair): ptxas's registers and spills beside each kernel's shared memory
    d256 = {name: dict(ptxas[name], dynamic_smem_bytes=smem[name])
            for name in D256_KERNELS if "delta" not in name}
    emit({
        "phase": "build", "seconds": seconds,
        "sources": {
            src: {"nvcc_seconds": info.seconds, "kernels": build.parse_ptxas(info.ptxas_log)}
            for src, info in infos.items()
        },
        "dynamic_smem_bytes": smem,
        "d256_kernels": {"design": D256_DESIGN, **d256},
        "padded_width_kernels": {wrapper: {name: ptxas[name] for name in names}
                                 for wrapper, names in WIDTH_KERNELS.items()},
        # the head dims past 256: ptxas's registers and spills beside each
        # kernel's shared memory
        "wide_kernels": {"design": WIDE_DESIGN, **{
            wrapper: {name: dict(ptxas[name], dynamic_smem_bytes=smem.get(name, 0))
                      for name in names}
            for wrapper, names in WIDE_KERNELS.items()}},
        "ptxas_warnings": warnings,
    })
    return ptxas


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _errors(got, want) -> dict:
    g, w = got.double(), want.double()
    return {
        "rel_err": float((g - w).norm() / w.norm()),
        "max_abs_err": float((g - w).abs().max()),
    }


def _check(name: str, errs: dict, key: str, bound: float) -> dict:
    errs = dict(errs, bound_key=key, bound=bound)
    if not errs[key] < bound:
        raise AssertionError(f"{name}: {key} {errs[key]} exceeds {bound}")
    return errs


class Flash:
    """One kernel family at one layout: `x` is the tuple of operands, three
    [b, s, h*d] tensors (any head dim; at d=64 with an even head count the
    pair's lane groups) or one interleaved [b, s, 3*h*64] projection (d=64,
    qkv); `grads` turns what bwd returns into (dq, dk, dv) either way."""

    def __init__(self, h: int, d: int, interleaved: bool = False):
        from flexflow_tpu_torch.kernels import flash_attention as fa

        self.fa, self.h, self.d, self.interleaved = fa, h, d, interleaved
        # the contiguous [b, s, h*d] wrappers (forward, delta, backward), or
        # None for the d=64 head pair's lane groups
        self.dense = None if fa._pairs_heads(d, h) else (fa.flash_fwd, fa.flash_delta,
                                                         fa.flash_bwd)

    def operands(self, b, s, gen):
        import torch

        shape = (b, s, 3 * self.h * self.d) if self.interleaved else (b, s, self.h * self.d)
        n = 1 if self.interleaved else 3
        return tuple(torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(n))

    def _views(self, x):
        fa = self.fa
        return fa.qkv_views(x[0]) if self.interleaved else [fa.lane_groups(t) for t in x]

    def fwd(self, x, causal=False):
        if self.dense:
            return self.dense[0](*x, self.h, causal)
        return self.fa.flash_fwd_d64(*self._views(x), self.h, causal)

    def delta(self, do, o):
        fn = self.dense[1] if self.dense else self.fa.flash_delta_d64
        return fn(do, o, self.h)

    def bwd(self, x, do, lse, delta, causal=False):
        import torch

        if self.dense:
            return self.dense[2](*x, do, lse, delta, self.h, causal)
        out = [torch.empty_like(t) for t in x]
        self.fa.flash_bwd_d64(*self._views(x), do, lse, delta, *self._views(out), self.h, causal)
        return out

    def grads(self, out):
        """(dq, dk, dv) of what bwd or bwd_plain returned."""
        return self.fa.split_qkv(out[0]) if self.interleaved else out

    def fwd_plain(self, x, causal=False):
        if self.interleaved:
            return self.fa.flash_fwd_qkv_plain(x[0], self.h, causal)
        return self.fa.flash_fwd_plain(*x, self.h, causal)

    def delta_plain(self, do, o):
        return self.fa.flash_delta_plain(do, o, self.h)

    def bwd_plain(self, x, do, lse, delta, causal=False):
        if self.interleaved:
            return (self.fa.flash_bwd_qkv_plain(x[0], do, lse, delta, self.h, causal),)
        return self.fa.flash_bwd_plain(*x, do, lse, delta, self.h, causal)

    def grad_out(self, b, s, gen):
        import torch

        return torch.randn(b, s, self.h * self.d, generator=gen, device="cuda").to(torch.bfloat16)

    def heads(self, x, do):
        """q, k, v and dO as [b, h, s, d] views, for the library calls."""
        b, s = do.shape[:2]
        q, k, v = self.fa.split_qkv(x[0]) if self.interleaved else x
        return [t.view(b, s, self.h, self.d).transpose(1, 2) for t in (q, k, v, do)]

    EINSUM_DELTA = 'torch.einsum("bshd,bshd->bhs", dO, O)'

    def einsum_delta(self, do, o):
        import torch

        b, s = do.shape[:2]
        return torch.einsum("bshd,bshd->bhs", do.view(b, s, self.h, self.d),
                            o.view(b, s, self.h, self.d))


class FlashBHSD:
    """The per-head kernels on [b, h, s, d] operands: contiguous, or, with
    `strided`, [b, s, h, d] buffers viewed as [b, h, s, d], the layout the
    per-head projection einsum returns on the data-parallel path."""

    interleaved = False

    def __init__(self, h: int, d: int, strided: bool = False):
        from flexflow_tpu_torch.kernels import flash_attention as fa

        self.fa, self.h, self.d, self.strided = fa, h, d, strided

    def _tensor(self, b, s, gen):
        import torch

        if self.strided:
            x = torch.randn(b, s, self.h, self.d, generator=gen, device="cuda")
            return x.to(torch.bfloat16).transpose(1, 2)
        return torch.randn(b, self.h, s, self.d, generator=gen, device="cuda").to(torch.bfloat16)

    def operands(self, b, s, gen):
        return tuple(self._tensor(b, s, gen) for _ in range(3))

    def grad_out(self, b, s, gen):
        return self._tensor(b, s, gen)

    def fwd(self, x, causal=False):
        return self.fa.flash_fwd_bhsd(*x, causal)

    def delta(self, do, o):
        return self.fa.flash_delta_bhsd(do, o)

    def bwd(self, x, do, lse, delta, causal=False):
        return self.fa.flash_bwd_bhsd(*x, do, lse, delta, causal)

    def grads(self, out):
        return out

    def fwd_plain(self, x, causal=False):
        return self.fa.flash_fwd_bhsd_plain(*x, causal)

    def delta_plain(self, do, o):
        return self.fa.flash_delta_bhsd_plain(do, o)

    def bwd_plain(self, x, do, lse, delta, causal=False):
        return self.fa.flash_bwd_bhsd_plain(*x, do, lse, delta, causal)

    def heads(self, x, do):
        return [*x, do]

    EINSUM_DELTA = 'torch.einsum("bhsd,bhsd->bhs", dO, O)'

    def einsum_delta(self, do, o):
        import torch

        return torch.einsum("bhsd,bhsd->bhs", do, o)


def _compare(flash: Flash, b: int, s: int, causal: bool, seed: int):
    """Each kernel against its plain version on the same bf16 inputs."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = flash.operands(b, s, gen)
    do = flash.grad_out(b, s, gen)
    o, lse = flash.fwd(x, causal)
    o_p, lse_p = flash.fwd_plain(x, causal)
    delta = flash.delta(do, o)
    delta_p = flash.delta_plain(do, o)
    grads = flash.grads(flash.bwd(x, do, lse, delta, causal))
    grads_p = flash.grads(flash.bwd_plain(x, do, lse, delta, causal))
    torch.cuda.synchronize()
    checks = {
        "o": _check("o", _errors(o, o_p), "rel_err", REL_BOUND),
        "lse": _check("lse", _errors(lse, lse_p), "max_abs_err", LSE_BOUND),
        "delta": _check("delta", _errors(delta, delta_p), "rel_err", DELTA_BOUND),
    }
    for name, g, gp in zip(("dq", "dk", "dv"), grads, grads_p):
        checks[name] = _check(name, _errors(g, gp), "rel_err", REL_BOUND)
    for t in (o, lse, delta, *grads):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("kernel output is not finite")
    # no atomics anywhere: a second launch gives the same bits
    again = (*flash.fwd(x, causal), flash.delta(do, o),
             *flash.grads(flash.bwd(x, do, lse, delta, causal)))
    if not all(torch.equal(a, b) for a, b in zip(again, (o, lse, delta, *grads))):
        raise AssertionError("kernels do not repeat bitwise")
    checks["repeat_bitwise"] = True
    return (x, do, o, lse, delta), checks


ATEN_BWD = "aten::_scaled_dot_product_flash_attention_backward"
CUDNN_BWD = "aten::_scaled_dot_product_cudnn_attention_backward"


def _library_bwd_ms(q, k, v, do, causal: bool, iters: int) -> dict:
    """The flash backward from a saved logsumexp as one PyTorch call on
    [b, h, s, d] views, by both backends that have one: aten's
    flash-attention backward, and cuDNN's, which is the one that
    F.scaled_dot_product_attention's autograd launches on an H100. Each runs
    after its own forward and computes dq, dk and dv together, its own delta
    included. Returns {call: ms}."""
    import torch

    aten = torch.ops.aten

    def flash():
        out, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = \
            aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal)
        return time_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, seed, offset), iters)

    def cudnn():
        out, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = \
            aten._scaled_dot_product_cudnn_attention(q, k, v, None, True, 0.0, causal, False)
        return time_ms(lambda: aten._scaled_dot_product_cudnn_attention_backward(
            do, q, k, v, out, lse, seed, offset, None, cum_q, cum_k, max_q, max_k, 0.0, causal),
            iters)

    # a backend that does not take this head dim is left out (None)
    times = {}
    for call, fn in ((ATEN_BWD, flash), (CUDNN_BWD, cudnn)):
        try:
            times[call] = fn()
        except RuntimeError:
            times[call] = None
    return times


def _fastest(times: dict):
    """(ms, call) of the fastest of {call: ms}, leaving out calls that did
    not run (None); (None, None) if none ran."""
    ran = {c: t for c, t in times.items() if t is not None}
    if not ran:
        return None, None
    call = min(ran, key=ran.get)
    return ran[call], call


def _bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _grad_err(checks) -> float:
    return max(checks[g]["max_abs_err"] for g in ("dq", "dk", "dv"))


def _sdpa_backend(q, k, v, causal: bool) -> str:
    """The backend F.scaled_dot_product_attention picks for these operands
    (flash and cuDNN refuse head dims past 256)."""
    import torch

    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(q, k, v, None, 0.0, causal)).name
    except (AttributeError, ImportError, RuntimeError, TypeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


def _measure(flash, b: int, s: int, seed: int = 0, iters: int = 20, plain_iters: int = 3,
             causal: bool = False, library_bwd: bool = True):
    """Compare, then time each kernel of `flash` beside its plain version,
    its bound and the library yardstick at (b, h, s, d). The bound of a
    causal run counts the unmasked pairs only. `library_bwd`: also time
    aten's flash and cuDNN's backward (which refuse head dims past 256);
    ms["sdpa_backend"] names the backend SDPA picks."""
    import torch.nn.functional as F

    h, d = flash.h, flash.d
    (x, do, o, lse, delta), checks = _compare(flash, b, s, causal=causal, seed=seed)
    ms = {
        "fwd": time_ms(lambda: flash.fwd(x, causal), iters),
        "delta": time_ms(lambda: flash.delta(do, o), iters),
        "bwd": time_ms(lambda: flash.bwd(x, do, lse, delta, causal), iters),
        "fwd_plain": time_ms(lambda: flash.fwd_plain(x, causal), plain_iters, 1),
        "delta_plain": time_ms(lambda: flash.delta_plain(do, o), plain_iters, 1),
        "bwd_plain": time_ms(lambda: flash.bwd_plain(x, do, lse, delta, causal), plain_iters, 1),
    }
    # the library yardsticks: one PyTorch call each on [b, h, s, d] views of
    # the same tensors, timed here and never used by the port
    q, k, v, do4 = flash.heads(x, do)
    ms["sdpa_fwd"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal),
                             iters)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal).backward(do4)

    ms["sdpa_fwd_bwd"] = time_ms(sdpa_fwd_bwd, iters)
    ms["sdpa_backend"] = _sdpa_backend(q, k, v, causal)
    times = (_library_bwd_ms(q, k, v, do4, causal, iters) if library_bwd else
             {ATEN_BWD: None, CUDNN_BWD: None})
    ms["aten_bwd"], ms["cudnn_bwd"] = times[ATEN_BWD], times[CUDNN_BWD]
    ms["einsum_delta"] = time_ms(lambda: flash.einsum_delta(do, o), iters)

    elems = b * s * h * d  # one [b, s, h*d] operand
    rows = b * h * s  # one lse/delta vector
    pairs = _unmasked_pairs(s, s, 0, 0, causal)
    bounds = {
        "fwd": _bound_ms(4 * elems * 2 + rows * 4, 4 * b * h * pairs * d, PEAK_BF16),
        "delta": _bound_ms(2 * elems * 2 + rows * 4, 2 * elems, PEAK_F32),
        "bwd": _bound_ms(7 * elems * 2 + 2 * rows * 4, 10 * b * h * pairs * d, PEAK_BF16),
    }
    return ms, bounds, checks


_OUTPUTS = {"fwd": ("o", "lse"), "delta": ("delta",), "bwd": ("dq", "dk", "dv")}


def _numbers(ms, bounds, checks, which, library_ms) -> dict:
    """One kernel's time, plain time, bound, library time and error."""
    first = _OUTPUTS[which][0]
    err = _grad_err(checks) if which == "bwd" else checks[first]["max_abs_err"]
    return dict(ms=ms[which], plain_ms=ms[f"{which}_plain"], bound_ms=bounds[which][0],
                bound_by=bounds[which][1], library_ms=library_ms, max_abs_err=err)


def _entry(name, replaces, ms, bounds, checks, which, library_ms, library_call, **extra):
    return dict(name=name, route="cuda", source=SOURCE, replaces=f"{TPU_KERNELS}:{replaces}",
                **_numbers(ms, bounds, checks, which, library_ms), library_call=library_call,
                checks={k: checks[k] for k in _OUTPUTS[which]}, **extra)


def _side(ms, bounds, checks, which, library_ms, shape, **extra):
    """The numbers of one kernel at a second shape or layout."""
    return dict(shape=shape, **_numbers(ms, bounds, checks, which, library_ms), **extra)


def _bwd_library(ms) -> dict:
    """The backward pair's library numbers: the faster of the aten flash and
    the cuDNN backward as its library call, both and SDPA forward+backward
    beside it."""
    library_ms, call = _fastest({ATEN_BWD: ms["aten_bwd"], CUDNN_BWD: ms["cudnn_bwd"]})
    return dict(library_ms=library_ms, library_call=call, aten_flash_bwd_ms=ms["aten_bwd"],
                cudnn_bwd_ms=ms["cudnn_bwd"], sdpa_fwd_bwd_ms=ms["sdpa_fwd_bwd"])


def _bwd_entry(name, replaces, ms, bounds, checks, **extra):
    lib = _bwd_library(ms)
    return _entry(name, replaces, ms, bounds, checks, "bwd", lib.pop("library_ms"),
                  lib.pop("library_call"), **lib,
                  port_fwd_delta_bwd_ms=ms["fwd"] + ms["delta"] + ms["bwd"], **extra)


def _bwd_side(ms, bounds, checks, shape, **extra):
    """The backward pair's numbers at a second shape or layout."""
    lib = _bwd_library(ms)
    return _side(ms, bounds, checks, "bwd", lib.pop("library_ms"), shape, **lib, **extra)


BERT_ATTENTION = {"b": 64, "h": 12, "s": 512, "d": 256}


def phase_kernels():
    """Compare and time the kernels at the main paths' attention shapes."""
    sdpa_f = "F.scaled_dot_product_attention forward"
    einsum = Flash.EINSUM_DELTA
    causal = {
        "d128": _compare(Flash(2, 128), 2, 256, causal=True, seed=1)[1],
        "d64_separate": _compare(Flash(4, 64), 2, 256, causal=True, seed=2)[1],
        "d64_qkv": _compare(Flash(4, 64, interleaved=True), 2, 256, causal=True, seed=3)[1],
        "d256": _compare(Flash(2, 256), 2, 256, causal=True, seed=16)[1],
    }

    # d=128: the flagship (b=64, h=8, s=512), and the seq-2048 flagship of
    # bench.py:3431-3435 (b=16, h=8, s=2048), whose backward the JAX package
    # computes with _bwd_onepass_kernel (rows 4-5 of the kernel table)
    # the tiling edges: s % 128 == 64 leaves the last 128-row block's
    # second warpgroup without rows, in the forward and in both backward
    # kernels; at s = 320 after two full blocks. Three heads of 64 leave
    # the delta's last pass over a tile half past its rows.
    edges = {f"s{s}_{name}_{'causal' if c else 'full'}":
             _compare(flash, 2, s, causal=c, seed=40 + 10 * (s == 320) + i)[1]
             for s in (192, 320)
             for i, (name, flash) in enumerate((
                 ("d128", Flash(2, 128)), ("d64_qkv", Flash(4, 64, interleaved=True)),
                 ("bhsd_d128_strided", FlashBHSD(2, 128, strided=True)),
                 ("bhsd_d64_h3_strided", FlashBHSD(3, 64, strided=True)),
                 ("d256", Flash(2, 256))))
             for c in (False, True)}

    ms, bounds, checks = _measure(Flash(8, 128), 64, 512)
    ms2k, bounds2k, checks2k = _measure(Flash(8, 128), 16, 2048, seed=4, iters=10)
    s2k = dict(b=16, h=8, s=2048, d=128)
    # causal at seq 2048: the JAX package's _bwd_bshf (row 5) and a causal
    # forward at a real shape
    msc, boundsc, checksc = _measure(Flash(8, 128), 16, 2048, seed=14, iters=10, causal=True)
    s2kc = dict(s2k, causal=True, bound="unmasked pairs only")
    kernels = [
        _entry("flash_fwd", 674, ms, bounds, checks, "fwd", ms["sdpa_fwd"], sdpa_f,
               seq2048=_side(ms2k, bounds2k, checks2k, "fwd", ms2k["sdpa_fwd"], s2k),
               seq2048_causal=_side(msc, boundsc, checksc, "fwd", msc["sdpa_fwd"], s2kc)),
        _entry("flash_delta", 1203, ms, bounds, checks, "delta", ms["einsum_delta"], einsum),
        _bwd_entry("flash_bwd", 976, ms, bounds, checks,
               seq2048=_bwd_side(ms2k, bounds2k, checks2k, s2k,
                                 replaces=[f"{TPU_KERNELS}:1286", f"{TPU_KERNELS}:324",
                                           f"{TPU_KERNELS}:375"]),
               seq2048_causal=_bwd_side(msc, boundsc, checksc, s2kc, sdpa_fwd_ms=msc["sdpa_fwd"],
                                        replaces=[f"{TPU_KERNELS}:1395", f"{TPU_KERNELS}:324",
                                                  f"{TPU_KERNELS}:375"])),
    ]

    # d=64: the 16-head config (b=64, h=16, s=512) on the interleaved-QKV
    # projection (its main path), causal too, and on separate operands
    ms, bounds, checks = _measure(Flash(16, 64, interleaved=True), 64, 512, seed=5)
    ms_sep, bounds_sep, checks_sep = _measure(Flash(16, 64), 64, 512, seed=6)
    ms_qc, bounds_qc, checks_qc = _measure(Flash(16, 64, interleaved=True), 64, 512, seed=15,
                                           causal=True)
    sep = dict(b=64, h=16, s=512, d=64, layout="separate q, k, v")
    qkv_causal = dict(b=64, h=16, s=512, d=64, layout="interleaved qkv", causal=True,
                      bound="unmasked pairs only")
    kernels += [
        _entry("flash_fwd_d64", 1032, ms, bounds, checks, "fwd", ms["sdpa_fwd"], sdpa_f,
               layout="interleaved qkv",
               separate=_side(ms_sep, bounds_sep, checks_sep, "fwd", ms_sep["sdpa_fwd"], sep)),
        _entry("flash_delta_d64", 1134, ms, bounds, checks, "delta", ms["einsum_delta"], einsum),
        _bwd_entry("flash_bwd_d64", 1189, ms, bounds, checks, layout="interleaved qkv",
               separate=_bwd_side(ms_sep, bounds_sep, checks_sep, sep,
                                  replaces=f"{TPU_KERNELS}:1179"),
               causal=_bwd_side(ms_qc, bounds_qc, checks_qc, qkv_causal)),
    ]
    # d=256: BERT-base's attention (b=64, h=12, s=512; hidden 768 over 12
    # heads with kdim = 3072 / 12), non-causal as BERT runs it, and causal
    ms, bounds, checks = _measure(Flash(12, 256), 64, 512, seed=7, iters=10)
    msc, boundsc, checksc = _measure(Flash(12, 256), 64, 512, seed=17, iters=10, causal=True)
    bert_causal = dict(b=64, h=12, s=512, d=256, causal=True, bound="unmasked pairs only")
    d256 = dict(head_dim=256, padded_width=256, shape=BERT_ATTENTION)
    kernels += [
        _entry("flash_fwd@d256", 674, ms, bounds, checks, "fwd", ms["sdpa_fwd"], sdpa_f,
               wrapper="flash_fwd", **d256,
               causal=_side(msc, boundsc, checksc, "fwd", msc["sdpa_fwd"], bert_causal)),
        _entry("flash_delta@d256", 1203, ms, bounds, checks, "delta", ms["einsum_delta"], einsum,
               wrapper="flash_delta", **d256),
        _bwd_entry("flash_bwd@d256", 976, ms, bounds, checks, wrapper="flash_bwd", **d256,
                   causal=_bwd_side(msc, boundsc, checksc, bert_causal)),
    ]
    kernels += _per_head_kernels(causal)
    kernels += _ring_kernels()
    kernels += _head_dim_kernels()
    kernels += _wide_dim_kernels()
    emit({"phase": "kernels",
          "shapes": {"d128": {"b": 64, "h": 8, "s": 512}, "d128_seq2048": s2k,
                     "d64": {"b": 64, "h": 16, "s": 512}, "d256": BERT_ATTENTION,
                     "dtype": "bf16"},
          "projection_view": _projection_view(),
          "repeat_bitwise": True, "causal_checks": {"shape": {"b": 2, "s": 256}, **causal},
          "tiling_edges": {"shape": {"b": 2, "s": 192}, **edges},
          "delta_tails": _delta_tails()})
    return kernels


def _delta_tails() -> dict:
    """Every delta kernel against its plain version, at DELTA_BOUND and
    bitwise on repeat, at shapes that reach delta_body's tails: a last
    head tile of fewer heads (h > 16, no multiple of 16), a pass past the
    tile's rows (d=64 with an odd head count in a tile), and b*h*s no
    multiple of a block's rows (s = 192 and 320, b*h odd); the bshf
    layout (dO and O are contiguous [b, s, h*d] on the interleaved d=64
    path too), contiguous per-head operands, the einsum's view, and dO on
    the view with O contiguous (as the ring's backward may hand them). A
    misaligned operand must raise."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa

    cases = {
        "d64_h18_s192": (Flash(18, 64), Flash(18, 64), 192),
        "d128_h20_s192": (Flash(20, 128), Flash(20, 128), 192),
        "d128_h3_s320": (Flash(3, 128), Flash(3, 128), 320),
        "bhsd_d64_h3_s192": (FlashBHSD(3, 64), FlashBHSD(3, 64), 192),
        "bhsd_d64_h3_s192_strided": (FlashBHSD(3, 64, True), FlashBHSD(3, 64, True), 192),
        "bhsd_d64_h19_s320_strided": (FlashBHSD(19, 64, True), FlashBHSD(19, 64, True), 320),
        "bhsd_d128_h20_s192_strided": (FlashBHSD(20, 128, True), FlashBHSD(20, 128, True), 192),
        "bhsd_d128_h3_s320": (FlashBHSD(3, 128), FlashBHSD(3, 128), 320),
        "bhsd_d64_h5_s192_do_strided": (FlashBHSD(5, 64, True), FlashBHSD(5, 64), 192),
    }
    out = {"shape": {"b": 1}}
    for i, (name, (flash, o_layout, s)) in enumerate(cases.items()):
        gen = torch.Generator(device="cuda").manual_seed(60 + i)
        do, o = flash.grad_out(1, s, gen), o_layout.grad_out(1, s, gen)
        delta = flash.delta(do, o)
        checks = _check(name, _errors(delta, flash.delta_plain(do, o)), "rel_err", DELTA_BOUND)
        if not bool(torch.isfinite(delta).all()):
            raise AssertionError(f"{name}: delta is not finite")
        if not torch.equal(flash.delta(do, o), delta):
            raise AssertionError(f"{name}: delta does not repeat bitwise")
        out[name] = dict(checks, repeat_bitwise=True)
    buf = torch.zeros(2 * 64 * 128 + 1, dtype=torch.bfloat16, device="cuda")
    misaligned = buf[1:].view(1, 64, 256)  # contiguous, 2 bytes past a 16-byte boundary
    try:
        fa.flash_delta_d64(misaligned, misaligned, 4)
    except ValueError as e:
        out["misaligned_raises"] = str(e)
    else:
        raise AssertionError("flash_delta_d64 took an operand that is not 16-byte aligned")
    return out


def _projection_view() -> dict:
    """The strides of the per-head projection einsum's output on the card at
    the flagship's shape, and whether the per-head kernels read it in
    place (else FlashAttentionBHSD copies it to contiguous)."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa

    x = torch.zeros(64, 512, 1024, dtype=torch.bfloat16, device="cuda")
    w = torch.zeros(1024, 128, 8, dtype=torch.bfloat16, device="cuda")
    view = torch.einsum("bsq,qkh->bhsk", x, w)
    return {"shape": list(view.shape), "strides": list(view.stride()),
            "read_in_place": fa.bhsd_readable(view)}


def _per_head_kernels(causal: dict):
    """The per-head [b, h, s, d] kernels (rows 9-12 of the kernel table) at
    the attention shapes of train_dp (64x8x512x128), of train_dp_seq2048
    (16x8x2048x128) and of the 16-head config (64x16x512x64), on contiguous
    operands, and at train_dp's and the 16-head config's on the projection
    einsum's strided view, the layout the data-parallel path hands them;
    plus causal cases."""
    sdpa_f = "F.scaled_dot_product_attention forward"
    einsum = FlashBHSD.EINSUM_DELTA
    causal["bhsd_d128"] = _compare(FlashBHSD(2, 128), 2, 256, causal=True, seed=7)[1]
    causal["bhsd_d64"] = _compare(FlashBHSD(4, 64), 2, 256, causal=True, seed=8)[1]
    causal["bhsd_d128_strided"] = _compare(FlashBHSD(2, 128, strided=True), 2, 256, causal=True,
                                           seed=9)[1]
    runs = {
        "main": (_measure(FlashBHSD(8, 128), 64, 512, seed=10), dict(b=64, h=8, s=512, d=128)),
        "strided": (_measure(FlashBHSD(8, 128, strided=True), 64, 512, seed=11),
                    dict(b=64, h=8, s=512, d=128, layout="einsum view of [b, s, h, d]")),
        "seq2048": (_measure(FlashBHSD(8, 128), 16, 2048, seed=12, iters=10),
                    dict(b=16, h=8, s=2048, d=128)),
        "d64": (_measure(FlashBHSD(16, 64), 64, 512, seed=13), dict(b=64, h=16, s=512, d=64)),
        "d64_strided": (_measure(FlashBHSD(16, 64, strided=True), 64, 512, seed=16),
                        dict(b=64, h=16, s=512, d=64, layout="einsum view of [b, s, h, d]")),
    }
    ms, bounds, checks = runs["main"][0]

    def sides(which, library):
        out = {}
        for key in ("strided", "seq2048", "d64", "d64_strided"):
            (ms_k, bounds_k, checks_k), shape = runs[key]
            out[key] = (_bwd_side(ms_k, bounds_k, checks_k, shape) if which == "bwd" else
                        _side(ms_k, bounds_k, checks_k, which, ms_k[library], shape))
        return out

    fwd_sides, bwd_sides = sides("fwd", "sdpa_fwd"), sides("bwd", None)
    fwd_sides["seq2048"]["replaces"] = f"{TPU_KERNELS}:164"  # _fwd_kernel, the loop
    bwd_sides["seq2048"]["replaces"] = [f"{TPU_KERNELS}:492", f"{TPU_KERNELS}:324",
                                        f"{TPU_KERNELS}:375"]  # _bwd, tiled
    return [
        _entry("flash_fwd_bhsd", 258, ms, bounds, checks, "fwd", ms["sdpa_fwd"], sdpa_f,
               layout="contiguous [b, h, s, d]", **fwd_sides),
        _entry("flash_delta_bhsd", 433, ms, bounds, checks, "delta", ms["einsum_delta"], einsum,
               layout="contiguous [b, h, s, d]", **sides("delta", "einsum_delta")),
        _bwd_entry("flash_bwd_bhsd", 454, ms, bounds, checks, layout="contiguous [b, h, s, d]",
                   **bwd_sides),
    ]


RING_WRAPPERS = ("ring_fwd_step", "ring_dq_step", "ring_dkv_step")


def _unmasked_pairs(s: int, t: int, q_off: int, k_off: int, causal: bool) -> int:
    """(query, key) pairs of one step that the causal mask leaves."""
    if not causal:
        return s * t
    return sum(min(t, max(0, q_off + i - k_off + 1)) for i in range(s))


def _ring_bound(kind: str, b, h, s, t, d, pairs):
    """The least time of one ring step on these inputs: each input read and
    each output written once (the f32 state or accumulators in and out), and
    the products it must do on the unmasked pairs (fwd: QK^T and PV; dq:
    QK^T, dO V^T and dS K; dkv: those two and P^T dO, dS^T Q). A step with
    no unmasked pair needs nothing."""
    if pairs == 0:
        return 0.0, "bytes"
    qs, kv, rows = b * h * s * d, b * h * t * d, b * h * s
    nbytes = {"fwd": 2 * qs + 4 * kv + 8 * (qs + 2 * rows),
              "dq": 4 * qs + 4 * kv + 8 * rows + 8 * qs,
              "dkv": 4 * qs + 4 * kv + 8 * rows + 16 * kv}[kind]
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * b * h * pairs * d
    return _bound_ms(nbytes, flops, PEAK_BF16)


class RingCase:
    """One ring step at one shape: q [b, h, s, d] at global offset q_off
    against a key/value block [b, h, t, d] at k_off, carrying `carry`
    (acc, m, l) and seeded random f32 dq, dk, dv accumulators (the sums of
    earlier steps), or the empty state and zero accumulators. `strided`
    lays the operands out as the projection einsum returns them
    ([b, s, h, d] memory)."""

    def __init__(self, b, h, s, t, d, q_off, k_off, causal, seed, carry=None, strided=False):
        import torch
        from flexflow_tpu_torch.kernels import ring_flash as rf

        self.rf, self.causal = rf, causal
        self.shape = dict(b=b, h=h, s_blk=s, t_blk=t, d=d, q_off=q_off, k_off=k_off,
                          causal=causal, carry="carried" if carry else "empty")
        if strided:
            self.shape["layout"] = "einsum view of [b, s, h, d]"
        self.dims, self.offs = (b, h, s, t, d), (q_off, k_off)
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def operand(rows):
            if strided:
                x = torch.randn(b, rows, h, d, generator=gen, device="cuda")
                return x.to(torch.bfloat16).transpose(1, 2)
            return torch.randn(b, h, rows, d, generator=gen, device="cuda").to(torch.bfloat16)

        self.q, self.k, self.v, self.do = operand(s), operand(t), operand(t), operand(s)
        if carry is None:
            carry = (torch.zeros(b, h, s, d, device="cuda"),
                     torch.full((b, h, s), rf.NEG_INF, device="cuda"),
                     torch.zeros(b, h, s, device="cuda"))
            self.acc0 = tuple(torch.zeros(b, h, rows, d, device="cuda") for rows in (s, t, t))
        else:
            self.acc0 = tuple(torch.randn(b, h, rows, d, generator=gen, device="cuda")
                              for rows in (s, t, t))
        self.carry = carry

    def fwd(self, plain=False, state=None):
        state = tuple(x.clone() for x in self.carry) if state is None else state
        fn = self.rf.ring_fwd_step_plain if plain else self.rf.ring_fwd_step
        fn(self.q, self.k, self.v, *state, *self.offs, self.causal)
        return state

    def grads(self, lse, delta, plain=False):
        """dq, dk and dv: this step added into copies of the accumulators."""
        out = tuple(x.clone() for x in self.acc0)
        dq_fn = self.rf.ring_dq_step_plain if plain else self.rf.ring_dq_step
        dkv_fn = self.rf.ring_dkv_step_plain if plain else self.rf.ring_dkv_step
        args = (self.q, self.k, self.v, self.do, lse, delta)
        dq_fn(*args, out[0], *self.offs, self.causal)
        dkv_fn(*args, out[1], out[2], *self.offs, self.causal)
        return out

    def check(self, measure: bool, iters: int = 10):
        """Kernels against plain versions, on the totals and on what the
        step added to the accumulators (and, for a step whose keys are all
        masked, against the state and accumulators it was given; rows that
        see no key, or keys that no query reaches, against theirs), a
        repeat that must give the same bits; with `measure`, times, plain
        times and bounds."""
        import torch

        state, state_p = self.fwd(), self.fwd(plain=True)
        acc, m, l = state
        o, lse = acc / l[..., None], m + torch.log(l)
        o_p = state_p[0] / state_p[2][..., None]
        lse_p = state_p[1] + torch.log(state_p[2])
        delta = (self.do.float() * o.to(torch.bfloat16).float()).sum(-1)
        grads, grads_p = self.grads(lse, delta), self.grads(lse, delta, plain=True)
        torch.cuda.synchronize()
        checks = {"o": _check("o", _errors(o, o_p), "rel_err", REL_BOUND),
                  "lse": _check("lse", _errors(lse, lse_p), "max_abs_err", LSE_BOUND)}
        for t in (*state, *grads):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError("ring kernel output is not finite")
        blind, unreached = self.blind_rows(), self.unreached_keys()
        if blind and self.pairs():  # rows that see no key keep their state and dq bitwise
            if not all(torch.equal(a[:, :, :blind], c[:, :, :blind])
                       for a, c in zip((*state, grads[0]), (*self.carry, self.acc0[0]))):
                raise AssertionError("rows that see no key changed their carried state or dq")
            checks["blind_rows_bitwise_unchanged"] = blind
        if unreached and self.pairs():  # keys no query reaches keep their dk, dv bitwise
            t = self.dims[3]
            if not all(torch.equal(g[:, :, t - unreached:], g0[:, :, t - unreached:])
                       for g, g0 in zip(grads[1:], self.acc0[1:])):
                raise AssertionError("keys that no query reaches changed their dk or dv")
            checks["unreached_keys_bitwise_unchanged"] = unreached
        if self.pairs() == 0:  # every key masked: nothing may change
            if not all(torch.equal(a, c) for a, c in zip(state, self.carry)):
                raise AssertionError("a fully masked ring step changed the carried state")
            if not all(torch.equal(g, g0) for out in (grads, grads_p)
                       for g, g0 in zip(out, self.acc0)):
                raise AssertionError("a fully masked ring step changed the accumulators")
            checks.update(state_bitwise_unchanged=True, accumulators_bitwise_unchanged=True)
        else:
            for name, g, gp, g0 in zip(("dq", "dk", "dv"), grads, grads_p, self.acc0):
                checks[name] = _check(name, _errors(g, gp), "rel_err", REL_BOUND)
                checks[name]["added"] = _check(f"{name} added", _errors(g - g0, gp - g0),
                                               "rel_err", REL_BOUND)
        again = (*self.fwd(), *self.grads(lse, delta))
        if not all(torch.equal(a, c) for a, c in zip(again, (*state, *grads))):
            raise AssertionError("ring kernels do not repeat bitwise")
        checks["repeat_bitwise"] = True
        self.checks, self.lse, self.delta = checks, lse, delta
        if not measure:
            return checks
        scratch = self.fwd()
        grads_out = self.grads(lse, delta)
        rf, args = self.rf, (self.q, self.k, self.v, self.do, lse, delta)
        self.ms = {
            "fwd": time_ms(lambda: rf.ring_fwd_step(self.q, self.k, self.v, *scratch, *self.offs,
                                                    self.causal), iters),
            "dq": time_ms(lambda: rf.ring_dq_step(*args, grads_out[0], *self.offs, self.causal),
                          iters),
            "dkv": time_ms(lambda: rf.ring_dkv_step(*args, *grads_out[1:], *self.offs,
                                                    self.causal), iters),
            "fwd_plain": time_ms(lambda: self.fwd(plain=True), 2, 1),
            "dq_plain": time_ms(lambda: rf.ring_dq_step_plain(*args, grads_out[0], *self.offs,
                                                              self.causal), 2, 1),
            "dkv_plain": time_ms(lambda: rf.ring_dkv_step_plain(*args, *grads_out[1:], *self.offs,
                                                                self.causal), 2, 1),
        }
        return checks

    def pairs(self) -> int:
        b, h, s, t, d = self.dims
        return _unmasked_pairs(s, t, *self.offs, self.causal)

    def blind_rows(self) -> int:
        """Leading query rows that the causal mask lets see no key here."""
        q_off, k_off = self.offs
        return min(self.dims[2], max(0, k_off - q_off)) if self.causal else 0

    def unreached_keys(self) -> int:
        """Trailing key rows that the causal mask lets no query reach here."""
        (q_off, k_off), s, t = self.offs, self.dims[2], self.dims[3]
        return min(t, max(0, k_off + t - q_off - s)) if self.causal else 0

    def numbers(self, kind: str, library_ms=None) -> dict:
        b, h, s, t, d = self.dims
        bound = _ring_bound(kind, b, h, s, t, d, self.pairs())
        names = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}[kind]
        checks = {n: self.checks[n] for n in names if n in self.checks}
        err = max((c["max_abs_err"] for c in checks.values()), default=0.0)
        return dict(ms=self.ms[kind], plain_ms=self.ms[f"{kind}_plain"], bound_ms=bound[0],
                    bound_by=bound[1], library_ms=library_ms, max_abs_err=err, checks=checks)


def _ring_kernels():
    """The ring-flash step kernels (rows 13-15 of the kernel table) at
    train_sp's attention shape (b=4, h=8, s_blk = t_blk = 8192, d=128,
    causal, offsets 0, empty carry, on the projection einsum's layout), at
    the replay's shapes (s_blk = t_blk = 2048 with (q_off, k_off) = (2048,
    0) carrying the diagonal step's state, (2048, 2048) empty, (0, 2048)
    fully masked, carrying, and (0, 64) carrying, whose query rows 0-63 see
    no key and whose last 64 key rows no query reaches), at d=64: b=2, h=4,
    256, causal, and parity_sp's shape (b=2, h=4, 1024) on the projection
    einsum's layout; and at both head dims a carried, partly masked step
    with s_blk = 320 != t_blk = 192, each 64 mod 128, so that the dK/dV
    grid runs over T and the last block of each side is half full. Every
    case that carries state adds into seeded random dq, dk, dv.
    With an empty carry at t = s, the forward step plus finalisation is
    causal attention, so F.scaled_dot_product_attention(is_causal=True) on
    the same tensors is its yardstick, and the dq and dk/dv pair is the
    causal flash backward from the saved logsumexp, which aten's flash and
    cuDNN backwards each compute in one call (dq, dk and dv together, its own
    delta included): the faster is the yardstick. No single PyTorch call
    computes a step with a carry or at other offsets."""
    import torch.nn.functional as F

    main = RingCase(4, 8, 8192, 8192, 128, 0, 0, True, seed=20, strided=True)
    main.check(measure=True, iters=5)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(main.q, main.k, main.v,
                                                             is_causal=True), 5)
    library_bwd = _library_bwd_ms(main.q, main.k, main.v, main.do, True, 5)
    bwd_ms, bwd_call = _fastest(library_bwd)
    diag = RingCase(4, 8, 2048, 2048, 128, 2048, 2048, True, seed=21)
    diag.check(measure=True)
    below = RingCase(4, 8, 2048, 2048, 128, 2048, 0, True, seed=22, carry=diag.fwd())
    below.check(measure=True)
    zero = RingCase(4, 8, 2048, 2048, 128, 0, 2048, True, seed=23,
                    carry=RingCase(4, 8, 2048, 2048, 128, 0, 0, True, seed=24).fwd())
    zero.check(measure=True)
    # the first 64-row warpgroup of the first block sees no key, the second does
    split = RingCase(4, 8, 2048, 2048, 128, 0, 64, True, seed=27, carry=diag.fwd())
    split.check(measure=True)
    d64 = RingCase(2, 4, 256, 256, 64, 0, 0, True, seed=25)
    d64.check(measure=True)
    d64_sp = RingCase(2, 4, 1024, 1024, 64, 0, 0, True, seed=26, strided=True)
    d64_sp.check(measure=True)
    uneven = {}
    for d in (128, 64):
        carry = RingCase(2, 4, 320, 192, d, 192, 0, True, seed=28 + d).fwd()
        uneven[d] = RingCase(2, 4, 320, 192, d, 192, 64, True, seed=29 + d, carry=carry)
        uneven[d].check(measure=True)
    library = {
        "fwd": (sdpa_ms, "F.scaled_dot_product_attention(is_causal=True), with the "
                         "finalisation acc / l"),
        "dq": (bwd_ms, f"{bwd_call}(is_causal=True): dq, dk and dv in one call, "
                       "against the dq + dk/dv pair"),
    }
    library["dkv"] = library["dq"]
    pair_ms = main.ms["dq"] + main.ms["dkv"]
    entries = []
    for kind, line, name in (("fwd", 58, "ring_fwd_step"), ("dq", 121, "ring_dq_step"),
                             ("dkv", 177, "ring_dkv_step")):
        lib_ms, lib_call = library[kind]
        extra = {} if kind == "fwd" else {"pair_ms": pair_ms,
                                          "aten_flash_bwd_ms": library_bwd[ATEN_BWD],
                                          "cudnn_bwd_ms": library_bwd[CUDNN_BWD]}
        sides = {}
        for key, case in (("replay_diagonal", diag), ("replay_below", below),
                          ("replay_masked", zero), ("split_warpgroups", split), ("d64", d64),
                          ("d64_parity_sp", d64_sp), ("uneven_d128", uneven[128]),
                          ("uneven_d64", uneven[64])):
            sides[key] = dict(shape=case.shape, **case.numbers(kind))
        entries.append(dict(
            name=name, route="cuda", source=RING_SOURCE,
            replaces=f"{RING_TPU_KERNELS}:{line}", shape=main.shape,
            **main.numbers(kind, lib_ms), library_call=lib_call, **extra, **sides))
    return entries


# The head dims the padded widths added (every d % 8 == 0 up to 256 rides the
# kernels of width 64, 128, 192 or 256 that it rounds up to), each held
# against its plain version on the card beside the widths' own 64, 128, 256.
NEW_HEAD_DIMS = (8, 32, 40, 96, 160, 192)
HEAD_DIM_TIMED = {  # the seq-major shapes timed at the new head dims: d -> (b, h, s)
    32: (64, 32, 512),  # the flagship at bench.py --heads 32 (train_heads32)
    96: (64, 8, 512),
    192: (64, 4, 512),
}
BERT_BHSD = dict(b=64, h=12, s=512, d=256)  # fit_bert_dp's per-head attention
RING_D96 = dict(b=4, h=8, s=8192, d=96)  # a ring step at train_sp's shape, heads of 96


def _head_dim_kernels() -> list:
    """Rows 1-3 (seq-major), 9-12 (per-head) and 13-15 (the ring steps) at
    the head dims the padded widths added. Each against its plain version,
    full and causal, repeating bitwise, at b=2, h=2, s=256 for d in
    NEW_HEAD_DIMS, and per-head (on the einsum's view) and ring steps at
    d=256; a carried, partly masked ring step with s_blk = 320 != t_blk =
    192 at d = 32, 96, 192 and 256; the s = 192 and 320 tiling edges at
    d = 32 and 96; the delta's tails (a last head tile of fewer heads, rows
    past a pass) at d = 40, 96 and 160, whose rows take 5, 12 and 20 of
    their 8, 16 and 32 lanes. Then timed beside their bounds and library
    calls: the seq-major kernels at HEAD_DIM_TIMED's shapes, the per-head
    ones at BERT_BHSD on the einsum's view (fit_bert_dp's layout), and the
    ring steps at RING_D96 causal (on the einsum's view, empty carry). The
    per-head ones also at s = 2048 (16×12×2048×256), past the JAX
    package's 1024-row block, where it runs its _fwd loop and tiled _bwd
    (rows 9 and 12)."""
    import torch
    import torch.nn.functional as F
    from flexflow_tpu_torch.kernels import flash_attention as fa

    checks = {}
    for i, d in enumerate(NEW_HEAD_DIMS):
        for c in (False, True):
            tag, seed = f"d{d}_{'causal' if c else 'full'}", 100 + 10 * i + 2 * c
            checks[tag] = _compare(Flash(2, d), 2, 256, causal=c, seed=seed)[1]
            checks[f"bhsd_{tag}"] = _compare(FlashBHSD(2, d), 2, 256, causal=c, seed=seed + 1)[1]
            checks[f"ring_{tag}"] = RingCase(2, 2, 256, 256, d, 0, 0, c,
                                             seed=seed + 5).check(measure=False)
    for c in (False, True):
        tag = f"d256_{'causal' if c else 'full'}"
        checks[f"bhsd_{tag}_strided"] = _compare(FlashBHSD(2, 256, strided=True), 2, 256,
                                                 causal=c, seed=170 + c)[1]
        checks[f"ring_{tag}"] = RingCase(2, 2, 256, 256, 256, 0, 0, c,
                                         seed=172 + c).check(measure=False)
    for d in (32, 96, 192, 256):
        carry = RingCase(2, 4, 320, 192, d, 192, 0, True, seed=180 + d).fwd()
        checks[f"ring_uneven_d{d}"] = RingCase(2, 4, 320, 192, d, 192, 64, True, seed=181 + d,
                                               carry=carry).check(measure=False)
    edges = {f"s{s}_{name}_{'causal' if c else 'full'}":
             _compare(flash, 2, s, causal=c, seed=200 + s + d + c)[1]
             for s in (192, 320) for d in (32, 96)
             for name, flash in ((f"d{d}", Flash(2, d)),
                                 (f"bhsd_d{d}_h3_strided", FlashBHSD(3, d, strided=True)))
             for c in (False, True)}
    tails = {}
    for i, (name, flash, s) in enumerate((("d40_h18_s192", Flash(18, 40), 192),
                                          ("d96_h3_s320", Flash(3, 96), 320),
                                          ("bhsd_d160_h19_s320_strided",
                                           FlashBHSD(19, 160, strided=True), 320),
                                          ("bhsd_d96_h20_s192", FlashBHSD(20, 96), 192))):
        gen = torch.Generator(device="cuda").manual_seed(230 + i)
        do, o = flash.grad_out(1, s, gen), flash.grad_out(1, s, gen)
        delta = flash.delta(do, o)
        tails[name] = _check(name, _errors(delta, flash.delta_plain(do, o)), "rel_err",
                             DELTA_BOUND)
        if not torch.equal(flash.delta(do, o), delta):
            raise AssertionError(f"{name}: delta does not repeat bitwise")

    sdpa_f = "F.scaled_dot_product_attention forward"
    entries = []
    for d, (b, h, s) in HEAD_DIM_TIMED.items():
        ms, bounds, ck = _measure(Flash(h, d), b, s, seed=190 + d, iters=10)
        extra = dict(head_dim=d, padded_width=fa.padded_dim(d), shape=dict(b=b, h=h, s=s, d=d))
        entries += [
            _entry(f"flash_fwd@d{d}", 674, ms, bounds, ck, "fwd", ms["sdpa_fwd"], sdpa_f,
                   wrapper="flash_fwd", **extra),
            _entry(f"flash_delta@d{d}", 1203, ms, bounds, ck, "delta", ms["einsum_delta"],
                   Flash.EINSUM_DELTA, wrapper="flash_delta", **extra),
            _bwd_entry(f"flash_bwd@d{d}", 976, ms, bounds, ck, wrapper="flash_bwd", **extra),
        ]
    bb, view = BERT_BHSD, "einsum view of [b, s, h, d]"
    ms, bounds, ck = _measure(FlashBHSD(bb["h"], bb["d"], strided=True), bb["b"], bb["s"],
                              seed=195, iters=10)
    # and past the JAX package's 1024-row block (its _fwd loop and tiled _bwd,
    # rows 9 and 12): the same kernels at s = 2048
    ms2, bounds2, ck2 = _measure(FlashBHSD(bb["h"], bb["d"], strided=True), 16, 2048,
                                 seed=197, iters=5)
    s2k = dict(b=16, h=bb["h"], s=2048, d=256, layout=view)
    extra = dict(head_dim=256, padded_width=256, shape=dict(bb, layout=view))
    entries += [
        _entry("flash_fwd_bhsd@d256", 258, ms, bounds, ck, "fwd", ms["sdpa_fwd"], sdpa_f,
               wrapper="flash_fwd_bhsd", **extra,
               seq2048=_side(ms2, bounds2, ck2, "fwd", ms2["sdpa_fwd"], s2k,
                             replaces=f"{TPU_KERNELS}:164")),
        _entry("flash_delta_bhsd@d256", 433, ms, bounds, ck, "delta", ms["einsum_delta"],
               FlashBHSD.EINSUM_DELTA, wrapper="flash_delta_bhsd", **extra,
               seq2048=_side(ms2, bounds2, ck2, "delta", ms2["einsum_delta"], s2k)),
        _bwd_entry("flash_bwd_bhsd@d256", 454, ms, bounds, ck, wrapper="flash_bwd_bhsd", **extra,
                   seq2048=_bwd_side(ms2, bounds2, ck2, s2k,
                                     replaces=[f"{TPU_KERNELS}:492", f"{TPU_KERNELS}:324",
                                               f"{TPU_KERNELS}:375"])),
    ]
    r = RING_D96
    main = RingCase(r["b"], r["h"], r["s"], r["s"], r["d"], 0, 0, True, seed=196, strided=True)
    main.check(measure=True, iters=5)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(main.q, main.k, main.v,
                                                             is_causal=True), 5)
    library_bwd = _library_bwd_ms(main.q, main.k, main.v, main.do, True, 5)
    bwd_ms, bwd_call = _fastest(library_bwd)
    library = {"fwd": (sdpa_ms, "F.scaled_dot_product_attention(is_causal=True), with the "
                                "finalisation acc / l"),
               "dq": (bwd_ms, f"{bwd_call}(is_causal=True): dq, dk and dv in one call, "
                              "against the dq + dk/dv pair")}
    library["dkv"] = library["dq"]
    for kind, line, name in (("fwd", 58, "ring_fwd_step"), ("dq", 121, "ring_dq_step"),
                             ("dkv", 177, "ring_dkv_step")):
        lib_ms, lib_call = library[kind]
        extra = {} if kind == "fwd" else {"pair_ms": main.ms["dq"] + main.ms["dkv"],
                                          "aten_flash_bwd_ms": library_bwd[ATEN_BWD],
                                          "cudnn_bwd_ms": library_bwd[CUDNN_BWD]}
        entries.append(dict(
            name=f"{name}@d96", wrapper=name, route="cuda", source=RING_SOURCE,
            replaces=f"{RING_TPU_KERNELS}:{line}", head_dim=96, padded_width=128,
            shape=main.shape, **main.numbers(kind, lib_ms), library_call=lib_call, **extra))
    emit({"phase": "kernels_head_dims", "head_dims": list(NEW_HEAD_DIMS),
          "checks": {"shape": {"b": 2, "h": 2, "s": 256}, **checks},
          "tiling_edges": edges, "delta_tails": {"shape": {"b": 1}, **tails},
          "repeat_bitwise": True})
    return entries


# Head dims past 256, the wide kernels' (every d % 8 == 0 there): a panel
# across d (264, 520), whole chunks (512, 768, 1024, 2048) and a last chunk
# of one, two or three panels (264 and 520, 320, 384).
WIDE_HEAD_DIMS = (264, 320, 384, 512, 520, 768, 1024, 2048)
WIDE_TIMED = {  # the seq-major shapes timed past 256: name -> (b, h, s, d)
    "heads2": (64, 2, 512, 512),  # bench.py --heads 2 (train_heads2)
    "bert_heads8": (64, 8, 512, 384),  # BERT-base at num_heads=8: kdim = 3072 / 8
    "heads1": (64, 1, 512, 1024),  # bench.py --heads 1
}
WIDE_BHSD = dict(b=64, h=2, s=512, d=512)  # train_heads2_dp's per-head attention
WIDE_RING = dict(b=4, h=2, s=8192, d=512)  # a ring step at train_sp's shape, heads of 512


def _wide_entry(name, replaces, ms, bounds, checks, which, flash, **extra):
    """A wide kernel's entry: its library call is SDPA's forward (fwd), its
    forward+backward (bwd; aten's flash and cuDNN backwards refuse d > 256),
    or the einsum (delta), with the backend SDPA picks named."""
    backend = ms["sdpa_backend"]
    library = {"fwd": (ms["sdpa_fwd"], f"F.scaled_dot_product_attention forward ({backend})"),
               "delta": (ms["einsum_delta"], flash.EINSUM_DELTA),
               "bwd": (ms["sdpa_fwd_bwd"], "F.scaled_dot_product_attention forward+backward "
                                          f"({backend}), against the port's fwd+delta+bwd")}
    lib_ms, call = library[which]
    if which == "bwd":
        extra.update(port_fwd_delta_bwd_ms=ms["fwd"] + ms["delta"] + ms["bwd"],
                     sdpa_fwd_ms=ms["sdpa_fwd"])
    return dict(name=name, route="cuda", source=WIDE_SOURCE,
                replaces=replaces if isinstance(replaces, list) else f"{TPU_KERNELS}:{replaces}",
                **_numbers(ms, bounds, checks, which, lib_ms), library_call=call,
                sdpa_backend=backend, checks={k: checks[k] for k in _OUTPUTS[which]}, **extra)


def _wide_side(ms, bounds, checks, which, shape, **extra):
    lib = {"fwd": "sdpa_fwd", "delta": "einsum_delta", "bwd": "sdpa_fwd_bwd"}[which]
    if which == "bwd":
        extra.update(port_fwd_delta_bwd_ms=ms["fwd"] + ms["delta"] + ms["bwd"])
    return _side(ms, bounds, checks, which, ms[lib], shape, sdpa_backend=ms["sdpa_backend"],
                 **extra)


def _wide_dim_kernels() -> list:
    """Rows 1-3 (seq-major), 9-12 (per-head, contiguous and on the einsum's
    view) and 13-15 (the ring steps) at head dims past 256, on the wide
    kernels. Each against its plain version, full and causal, repeating
    bitwise, at b=2, h=2, s=256 for d in WIDE_HEAD_DIMS; a carried, partly
    masked ring step with s_blk = 320 != t_blk = 192 at d = 264, 384 and
    520, and at d=384 a step whose first 64 rows see no key and a fully
    masked one (the rows' carried (m, l) copied across, bitwise); the
    s = 192 and 320 edges at d = 264 and 384; the delta's tails at d = 264
    and 520. Then timed beside their bounds and
    SDPA (the backend it picks named): the seq-major kernels at WIDE_TIMED's
    shapes, the per-head ones at WIDE_BHSD on the einsum's view and at
    16x2x2048x512 (past the JAX package's 1024-row block: its _fwd loop and
    tiled _bwd), the ring steps at WIDE_RING causal on the einsum's view."""
    import torch
    import torch.nn.functional as F

    checks = {}
    for i, d in enumerate(WIDE_HEAD_DIMS):
        for c in (False, True):
            tag, seed = f"d{d}_{'causal' if c else 'full'}", 300 + 10 * i + 2 * c
            checks[tag] = _compare(Flash(2, d), 2, 256, causal=c, seed=seed)[1]
            checks[f"bhsd_{tag}"] = _compare(FlashBHSD(2, d), 2, 256, causal=c, seed=seed + 1)[1]
            checks[f"bhsd_{tag}_strided"] = _compare(FlashBHSD(2, d, strided=True), 2, 256,
                                                     causal=c, seed=seed + 3)[1]
            checks[f"ring_{tag}"] = RingCase(2, 2, 256, 256, d, 0, 0, c,
                                             seed=seed + 5).check(measure=False)
    for d in (264, 384, 520):
        carry = RingCase(2, 4, 320, 192, d, 192, 0, True, seed=400 + d).fwd()
        checks[f"ring_uneven_d{d}"] = RingCase(2, 4, 320, 192, d, 192, 64, True, seed=401 + d,
                                               carry=carry).check(measure=False)
    # the tiling edges: s % 128 == 64 leaves the forward's last block a
    # warpgroup without rows, at s = 192 and after two full blocks at 320
    edges = {f"s{s}_{name}_{'causal' if c else 'full'}":
             _compare(flash, 2, s, causal=c, seed=420 + s + d + c)[1]
             for s in (192, 320) for d in (264, 384)
             for name, flash in ((f"d{d}", Flash(2, d)),
                                 (f"bhsd_d{d}_h3_strided", FlashBHSD(3, d, strided=True)))
             for c in (False, True)}
    carry = RingCase(2, 4, 320, 192, 384, 192, 0, True, seed=410).fwd()
    for name, k_off in (("ring_blind_rows_d384", 64), ("ring_masked_d384", 320)):
        checks[name] = RingCase(2, 4, 320, 192, 384, 0, k_off, True, seed=411 + k_off,
                                carry=carry).check(measure=False)
    tails = {}
    for i, (name, flash, s) in enumerate((("d264_h18_s192", Flash(18, 264), 192),
                                          ("bhsd_d520_h19_s320_strided",
                                           FlashBHSD(19, 520, strided=True), 320))):
        gen = torch.Generator(device="cuda").manual_seed(430 + i)
        do, o = flash.grad_out(1, s, gen), flash.grad_out(1, s, gen)
        delta = flash.delta(do, o)
        tails[name] = _check(name, _errors(delta, flash.delta_plain(do, o)), "rel_err",
                             DELTA_BOUND)
        if not torch.equal(flash.delta(do, o), delta):
            raise AssertionError(f"{name}: delta does not repeat bitwise")

    runs = {key: (_measure(Flash(h, d), b, s, seed=440 + i, iters=10, library_bwd=False),
                  dict(b=b, h=h, s=s, d=d))
            for i, (key, (b, h, s, d)) in enumerate(WIDE_TIMED.items())}
    (ms, bounds, ck), shape = runs["heads2"]

    def sides(which):
        return {key: _wide_side(*runs[key][0], which, runs[key][1])
                for key in ("bert_heads8", "heads1")}

    entries = [
        _wide_entry("flash_fwd_wide", 674, ms, bounds, ck, "fwd", Flash, shape=shape,
                    **sides("fwd")),
        _wide_entry("flash_delta_wide", 1203, ms, bounds, ck, "delta", Flash, shape=shape,
                    **sides("delta")),
        _wide_entry("flash_bwd_wide", 976, ms, bounds, ck, "bwd", Flash, shape=shape,
                    **sides("bwd")),
    ]
    wb, view = WIDE_BHSD, "einsum view of [b, s, h, d]"
    ms, bounds, ck = _measure(FlashBHSD(wb["h"], wb["d"], strided=True), wb["b"], wb["s"],
                              seed=450, iters=10, library_bwd=False)
    ms2, bounds2, ck2 = _measure(FlashBHSD(wb["h"], wb["d"], strided=True), 16, 2048,
                                 seed=451, iters=5, library_bwd=False)
    shape, s2k = dict(wb, layout=view), dict(b=16, h=wb["h"], s=2048, d=wb["d"], layout=view)
    entries += [
        _wide_entry("flash_fwd_bhsd_wide", 258, ms, bounds, ck, "fwd", FlashBHSD, shape=shape,
                    seq2048=_wide_side(ms2, bounds2, ck2, "fwd", s2k,
                                       replaces=f"{TPU_KERNELS}:164")),
        _wide_entry("flash_delta_bhsd_wide", 433, ms, bounds, ck, "delta", FlashBHSD,
                    shape=shape, seq2048=_wide_side(ms2, bounds2, ck2, "delta", s2k)),
        _wide_entry("flash_bwd_bhsd_wide", 454, ms, bounds, ck, "bwd", FlashBHSD, shape=shape,
                    seq2048=_wide_side(ms2, bounds2, ck2, "bwd", s2k,
                                       replaces=[f"{TPU_KERNELS}:1286", f"{TPU_KERNELS}:324",
                                                 f"{TPU_KERNELS}:375"])),
    ]
    r = WIDE_RING
    main = RingCase(r["b"], r["h"], r["s"], r["s"], r["d"], 0, 0, True, seed=460, strided=True)
    main.check(measure=True, iters=5)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(main.q, main.k, main.v,
                                                             is_causal=True), 5)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (main.q, main.k, main.v))
    sdpa_bwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True).backward(main.do), 5)
    backend = _sdpa_backend(main.q, main.k, main.v, True)
    library = {"fwd": (sdpa_ms, f"F.scaled_dot_product_attention(is_causal=True) ({backend}), "
                                "with the finalisation acc / l"),
               "dq": (sdpa_bwd_ms, f"F.scaled_dot_product_attention(is_causal=True) forward+"
                                   f"backward ({backend}), against the dq + dk/dv pair")}
    library["dkv"] = library["dq"]
    for kind, line, name in (("fwd", 58, "ring_fwd_step_wide"), ("dq", 121, "ring_dq_step_wide"),
                             ("dkv", 177, "ring_dkv_step_wide")):
        lib_ms, lib_call = library[kind]
        extra = {} if kind == "fwd" else {"pair_ms": main.ms["dq"] + main.ms["dkv"]}
        entries.append(dict(
            name=name, route="cuda", source=WIDE_SOURCE, replaces=f"{RING_TPU_KERNELS}:{line}",
            shape=main.shape, **main.numbers(kind, lib_ms), library_call=lib_call,
            sdpa_backend=backend, **extra))
    emit({"phase": "kernels_wide_dims", "head_dims": list(WIDE_HEAD_DIMS),
          "checks": {"shape": {"b": 2, "h": 2, "s": 256}, **checks}, "tiling_edges": edges,
          "delta_tails": {"shape": {"b": 1}, **tails}, "repeat_bitwise": True})
    return entries


def phase_ring_replay():
    """The ring schedule of 4 ranks on one card (16 forward steps,
    finalisation, delta, then 16 dq and 16 dk/dv steps, each at its global
    offsets) against the full-sequence per-head kernels on the same inputs:
    b=4, h=8, s=8192, d=128 causal, b=1 non-causal, b=4 causal at d=96
    (rows 13-15 at width 128 with the columns past 96 padding), and b=4,
    h=2 causal at d=384 (the wide step kernels, whose forward ping-pongs
    the carried (m, l)). Returns the d=96 and d=384 replays' ring launches:
    one replay each with the counts set to 0 just before it."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import ring_flash as rf

    counted = {}
    for b, h, causal, d in ((4, 8, True, 128), (1, 8, False, 128), (4, 8, True, 96),
                            (4, 2, True, 384)):
        gen = torch.Generator(device="cuda").manual_seed(30 + b + d)
        q, k, v, do = (torch.randn(b, h, 8192, d, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        fa.reset_launch_counts()
        got = rf.replay_ring(q, k, v, do, 4, causal)
        launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS if fn.launches}
        if d == 96:
            want = {"ring_fwd_step": 16, "ring_dq_step": 16, "ring_dkv_step": 16,
                    "flash_delta_bhsd": 4}
            counted.update({f"{n}@d96": c for n, c in launches.items()})
        elif d == 384:
            want = {"ring_fwd_step_wide": 16, "ring_dq_step_wide": 16, "ring_dkv_step_wide": 16,
                    "flash_delta_bhsd_wide": 4}
            counted.update(launches)
        if d in (96, 384) and launches != want:
            raise AssertionError(f"ring_replay d={d}: launches {launches}, expected {want}")
        o, lse = fa.flash_fwd_bhsd(q, k, v, causal)
        delta = fa.flash_delta_bhsd(do, o)
        want = (o, *fa.flash_bwd_bhsd(q, k, v, do, lse, delta, causal))
        torch.cuda.synchronize()
        checks = {name: _check(f"ring_replay {name}", _errors(g, w), "rel_err", REL_BOUND)
                  for name, g, w in zip(("o", "dq", "dk", "dv"), got, want)}

        def full():
            o, lse = fa.flash_fwd_bhsd(q, k, v, causal)
            fa.flash_bwd_bhsd(q, k, v, do, lse, fa.flash_delta_bhsd(do, o), causal)

        emit({"phase": "ring_replay", "shape": dict(b=b, h=h, s=8192, d=d, causal=causal),
              "ranks": 4, "shard": 2048, "checks": checks,
              "launches": launches if d in (96, 384) else None,
              "replay_ms": time_ms(lambda: rf.replay_ring(q, k, v, do, 4, causal), 3, 1),
              "full_sequence_kernels_ms": time_ms(full, 3, 1)})
    return {k: v for k, v in counted.items() if k.startswith("ring_")}


def _sp_model(heads: int, **kw):
    from flexflow_tpu_torch.models import ParallelTransformerConfig

    return ParallelTransformerConfig(**dict(dict(
        batch_size=2, sequence_length=1024, num_features=256, num_heads=heads, num_layers=2,
        vocab_size=512, data_parallel_degree=1, tensor_parallel_degree=1, causal=True), **kw))


def phase_parity_sp():
    """Two small causal parallel transformers trained two steps by the
    sequence-parallel trainer on the card (NCCL, bf16, ring kernels) and on
    the CPU (f32, plain versions, over a one-rank gloo group)."""
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import build_parallel_transformer
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    for heads in (2, 4):
        cfg = _sp_model(heads)
        pcg, logits = build_parallel_transformer(cfg)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(cfg.batch_size, cfg.sequence_length, cfg.num_features, generator=gen)
        y = torch.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.sequence_length), generator=gen)
        args = (pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                AdamOptimizerAttrs(alpha=1e-3))
        gloo = dist.new_group([0], backend="gloo")
        cpu = DistributedTrainingInstance(*args, MachineMesh(1, 1, base_group=gloo), device="cpu")
        losses = {"cpu": _train(cpu, *cpu.initialize(seed=0), x, y, 2)[2]}
        card = DistributedTrainingInstance(*args, MachineMesh(1, 1), compute_dtype=torch.bfloat16)
        fa.reset_launch_counts()
        losses["cuda_sp"] = _train(card, *card.initialize(seed=0), x.cuda(), y.cuda(), 2)[2]
        launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
        want = {n: 2 * cfg.num_layers if n in SP_WRAPPERS else 0 for n in launches}
        if launches != want:
            raise AssertionError(f"parity_sp heads={heads}: launches {launches}, expected {want}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda_sp"], losses["cpu"])]
        if not max(rel) < PARITY_BOUND:
            raise AssertionError(f"parity_sp heads={heads}: card losses {losses['cuda_sp']} vs "
                                 f"CPU {losses['cpu']}")
        emit({"phase": "parity_sp", "head_dim": 256 // heads, "config": dataclasses.asdict(cfg),
              "world_size": 1, "backends": {"cuda_sp": "nccl", "cpu": "gloo"}, "losses": losses,
              "rel_err": rel, "bound": PARITY_BOUND, "launches": launches})


def _train(inst, params, opt_state, x, y, steps, input_name="x"):
    import torch

    losses, step_ms = [], []
    for _ in range(steps):
        start = time.perf_counter()
        params, opt_state, loss, _ = inst.train_step(params, opt_state, {input_name: x}, y)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    return params, opt_state, losses, step_ms


PARITY_WIDE = dict(embed=768, heads=2)  # heads of 384, on the wide kernels
WIDE_FLASH_WRAPPERS = ("flash_fwd_wide", "flash_delta_wide", "flash_bwd_wide")  # rows 1-3 past 256
WIDE_BHSD_WRAPPERS = ("flash_fwd_bhsd_wide", "flash_delta_bhsd_wide", "flash_bwd_bhsd_wide")


def phase_parity():
    """Small flagships on the card (bf16, kernels) and on the CPU (f32,
    plain versions) from the same parameters and batch: heads of 128, of 64
    (the 16-head config's attention), of 32 (bench.py --heads 32's) and of
    384 (embed 768 over 2 heads), whose card run must go through the wide
    kernels, each once a layer a pass."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import build_flagship_cg
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    for name, heads in (("d128", 2), ("d64", 4), ("d32", 8), ("d384", None)):
        cfg = dict(batch=2, seq=128, embed=256, heads=heads, layers=2, vocab=512)
        if heads is None:
            cfg.update(PARITY_WIDE)
        graph, logits = build_flagship_cg(**cfg)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(cfg["batch"], cfg["seq"], cfg["embed"], generator=gen)
        y = torch.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]), generator=gen)
        losses = {}
        for device, dtype in (("cpu", None), ("cuda", torch.bfloat16)):
            inst = ModelTrainingInstance(
                graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                AdamOptimizerAttrs(alpha=1e-3), compute_dtype=dtype, device=device,
            )
            params, opt_state = inst.initialize(seed=0)
            fa.reset_launch_counts()
            losses[device] = _train(inst, params, opt_state, x.to(device), y.to(device), 2)[2]
        launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS if fn.launches}
        if heads is None and launches != {n: 2 * cfg["layers"] for n in WIDE_FLASH_WRAPPERS}:
            raise AssertionError(f"parity {name}: launches {launches}, expected each of "
                                 f"{WIDE_FLASH_WRAPPERS} {2 * cfg['layers']} times")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
        if not max(rel) < PARITY_BOUND:
            raise AssertionError(f"{name}: card losses {losses['cuda']} vs CPU {losses['cpu']}")
        emit({"phase": "parity", "head_dim": cfg["embed"] // cfg["heads"], "config": cfg,
              "losses": losses, "rel_err": rel, "bound": PARITY_BOUND, "launches": launches})


@contextlib.contextmanager
def dp_group():
    """A one-rank NCCL process group over a file:// store in a temporary
    directory, destroyed on the way out."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel import init_file_group

    with tempfile.TemporaryDirectory() as tmp:
        init_file_group(os.path.join(tmp, "store"), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


BHSD_WRAPPERS = ("flash_fwd_bhsd", "flash_delta_bhsd", "flash_bwd_bhsd")
SP_WRAPPERS = (*RING_WRAPPERS, "flash_delta_bhsd")  # what train_sp's attention launches


def phase_parity_dp():
    """The small flagships of phase_parity trained by the data-parallel
    trainer at world size 1 on the card (NCCL, bf16, per-head kernels) and
    by the single-device trainer on the CPU (f32, plain versions)."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import build_flagship_cg
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DataParallelTrainingInstance
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    for name, heads in (("d128", 2), ("d64", 4)):
        cfg = dict(batch=2, seq=128, embed=256, heads=heads, layers=2, vocab=512)
        graph, logits = build_flagship_cg(**cfg)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(cfg["batch"], cfg["seq"], cfg["embed"], generator=gen)
        y = torch.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]), generator=gen)
        args = (graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                AdamOptimizerAttrs(alpha=1e-3))
        cpu = ModelTrainingInstance(*args, device="cpu")
        losses = {"cpu": _train(cpu, *cpu.initialize(seed=0), x, y, 2)[2]}
        card = DataParallelTrainingInstance(*args, compute_dtype=torch.bfloat16)
        fa.reset_launch_counts()
        losses["cuda_dp"] = _train(card, *card.initialize(seed=0), x.cuda(), y.cuda(), 2)[2]
        launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
        want = {n: 2 * cfg["layers"] if n in BHSD_WRAPPERS else 0 for n in launches}
        if launches != want:
            raise AssertionError(f"parity_dp {name}: launches {launches}, expected {want}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda_dp"], losses["cpu"])]
        if not max(rel) < PARITY_BOUND:
            raise AssertionError(f"parity_dp {name}: card losses {losses['cuda_dp']} vs CPU "
                                 f"{losses['cpu']}")
        emit({"phase": "parity_dp", "head_dim": 256 // heads, "config": cfg, "world_size": 1,
              "backend": "nccl", "losses": losses, "rel_err": rel, "bound": PARITY_BOUND,
              "launches": launches})


def phase_train(smi: str, cfg: dict, phase: str, on_path, steps: int = STEPS, dp: bool = False):
    """Train the flagship config `cfg` at full width, with the single-device
    trainer or (dp) the data-parallel one."""
    import torch
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import build_flagship_cg, model_step_flops
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DataParallelTrainingInstance
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    graph, logits = build_flagship_cg(**cfg)
    trainer = DataParallelTrainingInstance if dp else ModelTrainingInstance
    inst = trainer(
        graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
        AdamOptimizerAttrs(alpha=1e-4), compute_dtype=torch.bfloat16,
    )
    return _train_phase(smi, phase, inst, cfg, (cfg["batch"], cfg["seq"], cfg["embed"]),
                        cfg["vocab"], cfg["layers"], model_step_flops(**cfg), on_path, steps, dp)


def phase_train_sp(smi: str, steps: int = STEPS):
    """Train SP_LONGCTX at full width and depth through the
    sequence-parallel trainer at world size 1."""
    import torch
    from flexflow_tpu_torch.models import SP_LONGCTX, build_parallel_transformer
    from flexflow_tpu_torch.models.parallel_transformer import model_step_flops
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    cfg = SP_LONGCTX
    pcg, logits = build_parallel_transformer(cfg)
    inst = DistributedTrainingInstance(
        pcg, logits, SparseCategoricalCrossEntropyLossAttrs(), AdamOptimizerAttrs(alpha=1e-4),
        MachineMesh(1, 1), compute_dtype=torch.bfloat16,
    )
    shape = (cfg.batch_size, cfg.sequence_length, cfg.num_features)
    return _train_phase(smi, "train_sp", inst, dataclasses.asdict(cfg), shape, cfg.vocab_size,
                        cfg.num_layers, model_step_flops(cfg), SP_WRAPPERS, steps, True,
                        flops_note="causal attention counted as half of the s^2 term")


def _dense_attentions() -> int:
    """Runs of the port's plain attention since the last reset: the
    materialized softmax (kernels/ops.py _dense_context) and the dense ring
    (kernels/ring_attention.py ring_attention_block)."""
    from flexflow_tpu_torch.kernels import ops, ring_attention

    return ops._dense_context.calls + ring_attention.ring_attention_block.calls


def _reset_dense_attentions() -> None:
    from flexflow_tpu_torch.kernels import ops, ring_attention

    ops._dense_context.calls = ring_attention.ring_attention_block.calls = 0


def _train_phase(smi, phase, inst, config, x_shape, vocab, layers, flops, on_path, steps,
                 distributed, **extra):
    """One warm-up step, then `steps` timed ones with every launch count
    set to 0 just before and read just after; the wrappers named in
    `on_path` must each launch once per layer per step, every other one
    never, no attention may run dense, and a distributed trainer must issue
    the all-reduces of its plan (the data-parallel one: one a gradient
    bucket of its plan, which the parameters' sizes and the bucket cap
    give, and one of the loss)."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa

    start = time.perf_counter()
    params, opt_state = inst.initialize(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(*x_shape, generator=gen, device="cuda")
    y = torch.randint(0, vocab, x_shape[:2], generator=gen, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    params, opt_state, warm_losses, warm_ms = _train(inst, params, opt_state, x, y, 1)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    _reset_dense_attentions()
    all_reduces = inst.all_reduces if distributed else 0
    params, opt_state, losses, step_ms = _train(inst, params, opt_state, x, y, steps)
    launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    want = {name: layers * steps if name in on_path else 0 for name in launches}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")
    if _dense_attentions():
        raise AssertionError(f"{phase}: {_dense_attentions()} attentions ran dense")
    if distributed:
        # what the plan implies: the data-parallel trainer's gradient
        # buckets and the loss's bucket; the PCG trainer's collectives (none
        # on a mesh of one rank)
        per_step = inst.step_collectives()["all_reduce"]
        all_reduces = inst.all_reduces - all_reduces
        if all_reduces != per_step * steps:
            raise AssertionError(f"{phase}: {all_reduces} all-reduces in {steps} steps, "
                                 f"expected {per_step} a step")
        extra.update(world_size=1, backend="nccl", all_reduces_per_step=all_reduces / steps,
                     all_reduce_bytes=4 * (1 + sum(p.numel() for p in params.values()))
                     if per_step else 0,
                     gradient_buckets=len(getattr(inst, "buckets", ())),
                     **(_require_early_buckets(phase, inst.bucket_log[-steps:])
                        if getattr(inst, "buckets", None) else {}))

    median_ms = statistics.median(step_ms)
    MEDIAN_STEP_MS[phase] = median_ms
    TRAIN_LOSSES[phase] = [warm_losses[0], *losses]
    emit({
        "phase": phase, "config": config, "card": smi, "compute_dtype": "bf16",
        "optimizer": "adam(alpha=1e-4)", "params": sum(p.numel() for p in params.values()),
        "setup_s": setup_s, "warmup_step_ms": warm_ms[0], "warmup_loss": warm_losses[0],
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": x_shape[0] * x_shape[1] / (median_ms / 1e3),
        "step_flops": flops, "mfu": flops / (median_ms / 1e3) / PEAK_BF16,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step_each": layers, "dense_attentions": 0, **extra,
    })
    del params, opt_state
    torch.cuda.empty_cache()
    return {name: n for name, n in launches.items() if name in on_path}


FLASH_WRAPPERS = ("flash_fwd", "flash_delta", "flash_bwd")  # the bshf path's (not d=64 or 256)
MEDIAN_STEP_MS = {}  # train phase -> its median step ms, read by the search phase
TRAIN_LOSSES = {}  # train phase -> its warm-up loss and timed losses
HEADS2_DP_BOUND = 1e-2  # relative, the first two losses, per-head kernels vs seq-major ones


def phase_train_heads2_dp(smi: str, cfg: dict, steps: int = STEPS):
    """bench.py --heads 2's flagship (cfg) through the data-parallel trainer at
    world size 1: rows 9-11's wide per-head kernels on the einsum's view,
    each once a layer a step, none dense; the first two losses (the warm-up
    step's and the first timed one) within HEADS2_DP_BOUND of train_heads2's,
    which ran the seq-major wide kernels from the same parameters and batch."""
    if "train_heads2" not in TRAIN_LOSSES:
        raise AssertionError("train_heads2_dp reads train_heads2's losses: add train_heads2 to "
                             "--phases")
    launched = phase_train(smi, cfg, "train_heads2_dp", WIDE_BHSD_WRAPPERS, steps, dp=True)
    want, got = TRAIN_LOSSES["train_heads2"][:2], TRAIN_LOSSES["train_heads2_dp"][:2]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if not max(rel) < HEADS2_DP_BOUND:
        raise AssertionError(f"train_heads2_dp: losses {got} against train_heads2's {want}")
    emit({"phase": "train_heads2_dp_losses", "losses": got, "train_heads2_losses": want,
          "rel_err": rel, "bound": HEADS2_DP_BOUND})
    return launched

# The Unity search's planning problem: the flagship on one node of 8 H100s
# (the links are calibration.py's datasheet figures), rules at the node's
# degrees, bench.py's cost-database session settings.
SEARCH_NODE_GPUS = 8
SEARCH_DEGREES = [2, 4, 8]
SEARCH_BUDGET = 4
SEARCH_LIMIT_S = 180.0
# search_mcmc: MCMC at FFConfig's rule for search_algorithm="mcmc", ten
# evaluations a unit of search_budget, at the Unity search's own budget (40
# evaluations); its winner must beat the serial plan and cost at most
# MCMC_UNITY_MARGIN x the Unity winner's estimate (the serial plan is ~3.2x)
SEARCH_MCMC_EVALUATIONS = 10 * SEARCH_BUDGET
MCMC_UNITY_MARGIN = 1.10


def _launch_counting_estimator(settings, cost_store=None):
    """A LocalCostEstimator on the card that counts each flash wrapper's
    device launches. profile_fn calls a leaf's step warmup_iters times
    eagerly and once under CUDA-graph capture, each through the wrappers
    (the capture launches nothing), then replays the graph measure_iters
    times, which no wrapper sees: per leaf, a wrapper launches its kernel
    (its calls per step) x (warmup_iters + measure_iters) times."""
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator

    class Counting(LocalCostEstimator):
        def __init__(self):
            super().__init__(settings, device="cuda", cost_store=cost_store)
            self.device_launches = {fn.__name__: 0 for fn in fa.KERNEL_WRAPPERS}

        def estimate_operator_cost(self, *args, **kwargs):
            before = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
            cost = super().estimate_operator_cost(*args, **kwargs)
            for fn in fa.KERNEL_WRAPPERS:
                calls = fn.launches - before[fn.__name__]
                per_step, rest = divmod(calls, settings.warmup_iters + 1)
                if rest:
                    raise AssertionError(f"search: {fn.__name__} called {calls} times in "
                                         "one leaf's profile, no whole number of steps")
                self.device_launches[fn.__name__] += per_step * (
                    settings.warmup_iters + settings.measure_iters)
            return cost

    return Counting()


def _search_8_h100(pcg, local, algorithm: str = "unity"):
    """(the result, seconds, the machine spec) of one search of `pcg` for
    one node of SEARCH_NODE_GPUS cards, each leaf priced by `local`: the
    Unity search at SEARCH_BUDGET, or MCMC at SEARCH_MCMC_EVALUATIONS."""
    from flexflow_tpu_torch.compiler import (
        GPUCostEstimator,
        MCMCConfig,
        MachineMappingContext,
        OptimizerConfig,
        graph_optimize,
        make_default_allowed_machine_views,
        mcmc_optimize,
    )
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules

    spec = MachineSpecification(1, 1, SEARCH_NODE_GPUS, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)
    ctx = MachineMappingContext(GPUCostEstimator(spec, local_cost_estimator=local),
                                make_default_allowed_machine_views())
    rules = generate_parallelization_rules(SEARCH_DEGREES)
    start = time.perf_counter()
    if algorithm == "mcmc":
        result = mcmc_optimize(pcg, ctx, spec, rules,
                               MCMCConfig(budget=SEARCH_MCMC_EVALUATIONS))
    else:
        result = graph_optimize(pcg, ctx, spec, rules,
                                OptimizerConfig(alpha=1.2, budget=SEARCH_BUDGET))
    return result, time.perf_counter() - start, spec, len(rules)


def run_search(cfg: dict, settings=(2, 5), cost_store=None):
    """graph_optimize over the flagship config `cfg` for one node of
    SEARCH_NODE_GPUS cards, each leaf measured on the card (and written to
    `cost_store`); then the unrewritten flagship priced for one device with
    the same leaves, and by the analytic roofline at the card's calibrated
    rates."""
    from flexflow_tpu_torch.compiler import (
        AnalyticGPUCostEstimator,
        GPUCostEstimator,
        MachineMappingCache,
        MachineMappingContext,
        evaluate_pcg,
        make_default_allowed_machine_views,
    )
    from flexflow_tpu_torch.compiler.calibration import (
        H100_NVLINK_GBPS,
        NDR_INFINIBAND_GBPS,
        calibrate,
    )
    from flexflow_tpu_torch.kernels.profiling import ProfilingSettings
    from flexflow_tpu_torch.models import build_flagship_pcg
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification

    pcg = build_flagship_pcg(**cfg)
    start = time.perf_counter()
    cal = calibrate(device="cuda")
    calibrate_s = time.perf_counter() - start
    local = _launch_counting_estimator(ProfilingSettings(*settings), cost_store)
    result, search_s, spec, rules = _search_8_h100(pcg, local)
    one = MachineSpecification(1, 1, 1, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)
    views = make_default_allowed_machine_views()
    serial = evaluate_pcg(pcg, MachineMappingContext(
        GPUCostEstimator(one, local_cost_estimator=local), views), one, MachineMappingCache())
    analytic = evaluate_pcg(pcg, MachineMappingContext(
        AnalyticGPUCostEstimator(one, cal.peak_flops, cal.hbm_gbps), views), one,
        MachineMappingCache())
    return dict(result=result, local=local, cal=cal, spec=spec, rules=rules,
                calibrate_s=calibrate_s, search_s=search_s, one_device=serial,
                one_device_analytic=analytic)


def _flash_leaf_shape(key):
    """(b, s, h, d, causal) of an attention leaf that runs the d=128 bshf
    flash kernels on the card, else None."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.op_attrs.ops import MultiHeadAttentionAttrs, RingAttentionAttrs

    attrs, inputs, _ = key
    if not isinstance(attrs, MultiHeadAttentionAttrs) or not inputs[0] == inputs[1] == inputs[2]:
        return None
    b, s, _ = inputs[0].dims
    h, d = attrs.num_heads, attrs.q_proj_size
    if d != attrs.v_proj_size or d != 128 or not fa.flash_attention_bshf_supported(
            (b, s, h * d), h, torch.bfloat16, "cuda"):
        return None
    return b, s, h, d, isinstance(attrs, RingAttentionAttrs) and attrs.causal


def _leaf_row(key, cost):
    attrs, inputs, weights = key
    return {"op": type(attrs).__name__, "inputs": [list(s.dims) for s in inputs],
            "weights": [list(s.dims) for s in weights or ()], "ms": cost.elapsed_ms}


def phase_search(smi: str, train_step_ms: float) -> dict:
    """The Unity search over the full flagship planned for one node of 8
    H100s, each leaf timed on this card (attention leaves through the flash
    kernels): the winner finite and no worse than the serial plan and every
    seed, the dp8 seed finite, every attention leaf at a flash shape finite,
    rows 1-3's d=128 wrappers launched and no ring wrapper, and those kernels
    against their plain versions at every flash shape the search measured;
    then the unrewritten flagship's 1-device estimate beside train's
    measured step. `launches` are device launches (the leaves' graph
    replays counted), `wrapper_calls` the wrappers' own counts."""
    import torch
    from flexflow_tpu_torch.compiler import parallel_degree_summary
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import FLAGSHIP
    from flexflow_tpu_torch.op_attrs.ops import MultiHeadAttentionAttrs

    from flexflow_tpu_torch.compiler import CostStore, device_kind_signature

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    # the leaves go to a cost store, which search_warm plans from
    store_dir = tempfile.mkdtemp(prefix="search_store_")
    store = CostStore(store_dir, device_kind=device_kind_signature("cuda"))
    run = run_search(FLAGSHIP, cost_store=store)
    store.save()
    SEARCH_RUN.update(run, store_dir=store_dir, store_entries=len(store))
    calls = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    r, local = run["result"], run["local"]
    launches = local.device_launches
    seeds = r.seed_runtimes
    attn = [(k, c) for k, c in local._cache.items()
            if isinstance(k[0], MultiHeadAttentionAttrs)]
    flash_attn = [(k, c) for k, c in attn if _flash_leaf_shape(k)]
    # rows 1-3 at each shape the search ran them, against the plain versions
    leaf_kernels = {
        "b{}_s{}_h{}_d{}{}".format(*shape[:4], "_causal" if shape[4] else ""):
            _compare(Flash(shape[2], shape[3]), shape[0], shape[1], causal=shape[4],
                     seed=60 + i)[1]
        for i, shape in enumerate(sorted({_flash_leaf_shape(k) for k, _ in flash_attn}))}
    checks = {
        "winner_finite": math.isfinite(r.runtime),
        "winner_le_serial": r.runtime <= r.serial_runtime,
        "winner_le_seeds": bool(seeds) and r.runtime <= min(seeds.values()),
        "explored": r.explored > 0,
        "dp8_seed_finite": math.isfinite(seeds.get("dp8xtp1xsp1", math.inf)),
        "flash_attention_leaves_finite": bool(flash_attn) and all(
            math.isfinite(c.elapsed_ms) for _, c in flash_attn),
        "rows_1_3_launched": all(calls[n] > 0 and launches[n] > 0 for n in FLASH_WRAPPERS),
        "no_ring_launch": all(calls.get(n, 0) == 0 for n in RING_WRAPPERS),
        "under_limit": run["calibrate_s"] + run["search_s"] < SEARCH_LIMIT_S,
    }
    one_ms = run["one_device"].runtime
    leaves = sorted(local._cache.items(), key=lambda kc: -kc[1].elapsed_ms)
    emit({
        "phase": "search", "card": smi, "config": FLAGSHIP,
        "calibration": run["cal"].as_dict(),
        "machine": {"num_nodes": 1, "gpus_per_node": SEARCH_NODE_GPUS,
                    "intra_node_gbps": run["spec"].intra_node_bandwidth,
                    "inter_node_gbps": run["spec"].inter_node_bandwidth,
                    "link_source": "datasheet (NVLink 4, NDR InfiniBand), not measured"},
        "rules": run["rules"], "budget": SEARCH_BUDGET, "calibrate_s": run["calibrate_s"],
        "search_s": run["search_s"], "phase_ms": r.telemetry["phase_ms"],
        "evaluations": r.telemetry["evaluations"], "explored": r.explored,
        "runtime_ms": r.runtime, "serial_runtime_ms": r.serial_runtime,
        "seed_runtimes_ms": seeds, "parallel_degree_summary": parallel_degree_summary(r.pcg),
        "leaves_measured": len(local._cache) - len(local.inf_leaves),
        "inf_leaves": [_leaf_row(k, local._cache[k]) for k in local.inf_leaves],
        "attention_leaves": [_leaf_row(k, c) for k, c in attn],
        "slowest_leaves": [_leaf_row(k, c) for k, c in leaves[:8]],
        "launches": {n: v for n, v in launches.items() if v},
        "wrapper_calls": {n: v for n, v in calls.items() if v},
        "leaf_kernel_checks": leaf_kernels, "peak_memory_bytes": peak,
        "cost_store": store.provenance(),
        "one_device_estimate_ms": one_ms,
        "one_device_analytic_estimate_ms": run["one_device_analytic"].runtime,
        "train_median_step_ms": train_step_ms,
        "estimate_over_measured": one_ms / train_step_ms, "checks": checks,
    })
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"search: failed checks {failed}")
    torch.cuda.empty_cache()
    return {name: launches[name] for name in FLASH_WRAPPERS}
# search_warm, search_mcmc: a fresh process plans the flagship from search's
# cost store (argv: the store's directory); prints its runs as its last line
SEARCH_WARM_WORKER = r"""
import json, sys
import chip_smoke as c
print(json.dumps(c.search_store_runs(sys.argv[1])))
"""
FOREIGN_KIND = "cuda:a card of another kind"


def _store_run(store, algorithm: str = "unity") -> dict:
    """One search of the flagship for 8 H100s priced from `store`: what it
    timed (leaves, device launches of rows 1-3, the wrappers' calls), the
    store's hits and misses, the winner, its estimate and the seconds."""
    from flexflow_tpu_torch.compiler import parallel_degree_summary
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels.profiling import ProfilingSettings
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_pcg

    fa.reset_launch_counts()
    local = _launch_counting_estimator(ProfilingSettings(2, 5), store)
    result, secs, _, _ = _search_8_h100(build_flagship_pcg(**FLAGSHIP), local, algorithm)
    return dict(leaves_timed=local.profile_calls, inf_leaves=len(local.inf_leaves),
                op_hits=store.op_hits,
                op_misses=store.op_misses, device_launches=dict(local.device_launches),
                wrapper_calls={fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS},
                runtime_ms=result.runtime, serial_ms=result.serial_runtime,
                winner=parallel_degree_summary(result.pcg),
                evaluations=result.telemetry["evaluations"], explored=result.explored,
                phase_ms=result.telemetry["phase_ms"], seconds=secs)


def search_store_runs(store_dir: str) -> dict:
    """search_warm's and search_mcmc's runs, in this (fresh) process: the
    Unity search from search's store, MCMC from it, then the store's
    entries stamped with another device kind (a copy beside it) and the
    Unity search again."""
    from flexflow_tpu_torch.compiler import CostStore, device_kind_signature

    card = device_kind_signature("cuda")
    out = {"device_kind": card}
    out["warm"] = _store_run(CostStore(store_dir, device_kind=card))
    out["mcmc"] = _store_run(CostStore(store_dir, device_kind=card), "mcmc")
    foreign_dir = store_dir.rstrip("/") + "_foreign"
    shutil.rmtree(foreign_dir, ignore_errors=True)
    os.makedirs(foreign_dir)
    with open(os.path.join(store_dir, CostStore.FILENAME)) as f:
        doc = json.load(f)
    doc["entries"] = {k.replace(card, FOREIGN_KIND):
                      dict(e, device_kind=FOREIGN_KIND) if e.get("device_kind") == card else e
                      for k, e in doc["entries"].items()}
    with open(os.path.join(foreign_dir, CostStore.FILENAME), "w") as f:
        json.dump(doc, f)
    foreign = CostStore(foreign_dir, device_kind=card)
    out["foreign_census"] = foreign.stats()["by_device_kind"]
    out["foreign"] = _store_run(foreign)
    return out


def phase_search_warm(smi: str) -> dict:
    """A fresh process plans the flagship for 8 H100s from the cost store
    search wrote: it times no leaf, launches no flash kernel, and returns
    search's winner at search's estimate exactly. Then (in that process)
    MCMC from the same store (search_mcmc prints it), and the store's
    entries stamped with another device kind: that run must time every leaf
    again and read none. Returns the device launches of the runs (the
    foreign run's re-timed leaves, MCMC's leaves the warm store lacked)."""
    start = time.perf_counter()
    run = SEARCH_RUN
    if "store_dir" not in run:
        raise AssertionError("search_warm plans from search's cost store: add search to --phases")
    child = subprocess.run([sys.executable, "-c", SEARCH_WARM_WORKER, run["store_dir"]], cwd=REPO,
                           capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    if child.returncode != 0:
        raise AssertionError(f"search_warm: the fresh process failed: {child.stderr[-3000:]}")
    res = json.loads(child.stdout.strip().splitlines()[-1])
    SEARCH_WARM.update(res)
    cold, warm, foreign = run["result"], res["warm"], res["foreign"]
    from flexflow_tpu_torch.compiler import parallel_degree_summary

    checks = {
        "no_leaf_timed": warm["leaves_timed"] == 0 and warm["op_misses"] == 0,
        "no_flash_launch": not any(warm["device_launches"].values())
        and not any(warm["wrapper_calls"].values()),
        "same_estimate": warm["runtime_ms"] == cold.runtime,
        "same_winner": warm["winner"] == parallel_degree_summary(cold.pcg),
        "foreign_never_served": foreign["op_hits"] == 0,
        # every leaf it looked up missed and was timed (its own timings may
        # lead it to other candidates than the warm run's)
        "foreign_times_every_leaf": foreign["leaves_timed"] + foreign["inf_leaves"]
        == foreign["op_misses"] > 0,
        "foreign_store_holds_no_card_entry": res["device_kind"] not in res["foreign_census"],
    }
    emit({"phase": "search_warm", "card": smi, "store_entries": run["store_entries"],
          "cold": {"runtime_ms": cold.runtime, "leaves_timed": run["local"].profile_calls,
                   "phase_ms": cold.telemetry["phase_ms"], "search_s": run["search_s"]},
          "warm": warm, "foreign": foreign, "foreign_census": res["foreign_census"],
          "checks": checks, "seconds": time.perf_counter() - start})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"search_warm: failed checks {failed}")
    print(f"search_warm: {warm['leaves_timed']} leaves timed, {warm['phase_ms']} ms by phase "
          f"(cold {cold.telemetry['phase_ms']}), foreign kind re-timed "
          f"{foreign['leaves_timed']}", flush=True)
    return {n: warm["device_launches"].get(n, 0) + foreign["device_launches"].get(n, 0)
            for n in FLASH_WRAPPERS}


SEARCH_WARM = {}  # search_warm's fresh process's runs, read by search_mcmc


def phase_search_mcmc(smi: str) -> dict:
    """MCMC (search_algorithm="mcmc", SEARCH_MCMC_EVALUATIONS) for the
    flagship on 8 H100s from search's warm store, run in search_warm's fresh
    process: its winner, estimate, evaluations and seconds beside the Unity
    search's, and the leaves it timed (those of candidates the Unity search
    never priced). The walk's winner must beat the serial plan and cost at
    most MCMC_UNITY_MARGIN x the Unity winner's estimate."""
    if "mcmc" not in SEARCH_WARM:
        raise AssertionError("search_mcmc runs in search_warm's process: add search_warm")
    mcmc, warm = SEARCH_WARM["mcmc"], SEARCH_WARM["warm"]
    checks = {
        "finite": math.isfinite(mcmc["runtime_ms"]) and mcmc["evaluations"] > 1,
        "beats_serial": mcmc["runtime_ms"] < mcmc["serial_ms"],
        "near_unity": mcmc["runtime_ms"] <= MCMC_UNITY_MARGIN * warm["runtime_ms"],
    }
    emit({"phase": "search_mcmc", "card": smi, "budget_evaluations": SEARCH_MCMC_EVALUATIONS,
          "margin_over_unity": MCMC_UNITY_MARGIN, "mcmc": mcmc,
          "unity": {k: warm[k] for k in ("runtime_ms", "winner", "evaluations", "seconds")},
          "checks": checks, "seconds": mcmc["seconds"]})
    print(f"search_mcmc: {mcmc['winner']} at {mcmc['runtime_ms']} ms (serial "
          f"{mcmc['serial_ms']}) after {mcmc['evaluations']} evaluations in "
          f"{mcmc['seconds']:.1f} s (unity {warm['winner']} at {warm['runtime_ms']} ms)",
          flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"search_mcmc: failed checks {failed}: {mcmc}")
    return {n: mcmc["device_launches"].get(n, 0) for n in FLASH_WRAPPERS}


# search_nodes: 2 nodes of 8 H100s; the flagship's widths at a depth the
# pure-Python DP plans within the phase's time. Its DP time grows about
# tenfold a layer on two nodes, as the JAX package's pure-Python DP's does
# (2.8 and 22.5 s of DP at 2 and 3 layers on one CPU core, the JAX package's
# 4.3 and 44.2; tests/torch_port_probes.py depth); only the JAX package's
# native DP plans deeper cuts within the phase's time
SEARCH_NODES = dict(nodes=2, gpus_per_node=8, layers=2, budget=2)


def phase_search_nodes(smi: str) -> None:
    """The flagship (at SEARCH_NODES' depth) planned for 2 nodes x 8 H100s
    under machine_model_version=1 (EnhancedGPUMachineModel: NVSwitch within
    a node, InfiniBand ports across) with FFConfig.multislice's search, the
    two-level DP over nodes, analytic at the H100's peaks; beside it the
    flat DP under the same model, and the flat winner re-priced by the
    two-level context. Prints the estimates, the outer level's choices, the
    winner's movement edges by link class (export_movement_predictions) and
    seconds by search phase."""
    from flexflow_tpu_torch.compiler import (
        AnalyticGPUCostEstimator,
        MachineMappingContext,
        OptimizerConfig,
        graph_optimize,
        make_default_allowed_machine_views,
        parallel_degree_summary,
        price_mapped_plan,
    )
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.compiler.machine_mapping.movement_export import (
        export_movement_predictions,
        link_class_census,
    )
    from flexflow_tpu_torch.compiler.machine_model import (
        MachineModelCommModel,
        machine_model_from_config,
    )
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_pcg
    from flexflow_tpu_torch.observability.roofline import H100_HBM_GBPS, H100_PEAK_FLOPS
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules

    start = time.perf_counter()
    n = SEARCH_NODES
    cfg = dict(FLAGSHIP, layers=n["layers"])
    spec = MachineSpecification(n["nodes"], 1, n["gpus_per_node"], NDR_INFINIBAND_GBPS,
                                H100_NVLINK_GBPS)
    model = machine_model_from_config(spec, 1)
    gpus = n["nodes"] * n["gpus_per_node"]
    rules = generate_parallelization_rules([d for d in range(2, gpus + 1) if gpus % d == 0])

    def context(two_level: bool):
        est = AnalyticGPUCostEstimator(spec, H100_PEAK_FLOPS, H100_HBM_GBPS,
                                       comm_model=MachineModelCommModel(spec, model))
        return MachineMappingContext(est, make_default_allowed_machine_views(),
                                     overlap_fraction=0.5, slice_aware=two_level,
                                     slice_hierarchy=two_level)

    runs = {}
    for name, two_level in (("two_level", True), ("flat", False)):
        ctx = context(two_level)
        t0 = time.perf_counter()
        r = graph_optimize(build_flagship_pcg(**cfg), ctx, spec, rules,
                           OptimizerConfig(alpha=1.2, budget=n["budget"]))
        runs[name] = (r, ctx, time.perf_counter() - t0)
    hier, hctx, _ = runs["two_level"]
    flat = runs["flat"][0]
    census = link_class_census(export_movement_predictions(hier.pcg, hier.machine_mapping,
                                                           hctx.cost_estimator))
    repriced = price_mapped_plan(flat.pcg, flat.machine_mapping, hctx, spec)
    if not (math.isfinite(hier.runtime) and math.isfinite(flat.runtime)
            and hier.hierarchical and hier.hierarchical["winner"]):
        raise AssertionError(f"search_nodes: {hier.runtime} / {flat.runtime} / "
                             f"{hier.hierarchical}")
    out = {name: {"estimated_ms": r.runtime, "winner": parallel_degree_summary(r.pcg),
                  "evaluations": r.telemetry["evaluations"], "phase_ms": r.telemetry["phase_ms"],
                  "seconds": secs} for name, (r, _, secs) in runs.items()}
    emit({"phase": "search_nodes", "card": smi, "config": cfg, "machine": {
              "nodes": n["nodes"], "gpus_per_node": n["gpus_per_node"],
              "model": "EnhancedGPUMachineModel (machine_model_version=1)",
              "nvlink_gbps": model.nvlink_gbps, "ib_gbps": model.ib_gbps,
              "nic_ports_per_node": model.nic_ports, "rates": "datasheet, not measured"},
          "budget": n["budget"], "searches": out, "outer_level": hier.hierarchical,
          "flat_winner_repriced_two_level_ms": repriced, "link_census": census,
          "seconds": time.perf_counter() - start})
    print(f"search_nodes: two-level {out['two_level']['winner']} at "
          f"{hier.runtime:.4f} ms (outer {hier.hierarchical['winner']}), flat "
          f"{out['flat']['winner']} at {flat.runtime:.4f} ms (two-level price {repriced}); "
          f"edges by link {census}", flush=True)


FIT_METRICS = ["accuracy", "sparse_categorical_crossentropy"]


def _spec_mlp(device: str):
    """tests/test_ffmodel_api.py's MLP through FFModel on `device`."""
    from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer

    m = FFModel(FFConfig(batch_size=8, print_freq=0, seed=0), device=device)
    x = m.create_tensor([8, 32], name="x")
    m.dense(m.dense(x, 16, activation=Activation.RELU, name="fc1"), 4, name="out")
    m.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", metrics=FIT_METRICS)
    return m


def phase_parity_fit():
    """The spec MLP fit 30 shuffled epochs and evaluated through FFModel on
    the card and on the CPU, f32 both (TF32 off): equal PerfMetrics counts,
    final parameters within FIT_PARITY_BOUND."""
    import numpy as np
    from flexflow_tpu_torch.interop import params_to_numpy

    rs = np.random.RandomState(0)
    xs, ys = rs.randn(64, 32).astype(np.float32), rs.randint(0, 4, 64)
    runs = {}
    for device in ("cpu", "cuda"):
        start = time.perf_counter()
        m = _spec_mlp(device)
        fit = m.fit(xs, ys, epochs=30, shuffle=True, verbose=False)
        ev = m.eval(xs, ys)
        runs[device] = dict(fit=dataclasses.asdict(fit), eval=dataclasses.asdict(ev),
                            eval_accuracy=ev.accuracy, params=params_to_numpy(m.params),
                            seconds=time.perf_counter() - start)
    cpu, card = runs["cpu"], runs["cuda"]
    counts = lambda perf: (perf["train_all"], perf["train_correct"])  # noqa: E731
    if counts(card["fit"]) != counts(cpu["fit"]) or counts(card["eval"]) != counts(cpu["eval"]):
        raise AssertionError(f"parity_fit: card {card['fit']} {card['eval']} vs CPU "
                             f"{cpu['fit']} {cpu['eval']}")
    rel = {k: float(np.linalg.norm(card["params"][k] - v) / np.linalg.norm(v))
           for k, v in cpu["params"].items()}
    if not max(rel.values()) < FIT_PARITY_BOUND:
        raise AssertionError(f"parity_fit: parameters differ by {rel}")
    if not card["eval_accuracy"] > 0.5:
        raise AssertionError(f"parity_fit: eval accuracy {card['eval_accuracy']}")
    emit({"phase": "parity_fit", "model": "mlp 32-16-4, batch 8", "epochs": 30,
          "optimizer": "sgd(lr=0.1)", **{d: {k: v for k, v in r.items() if k != "params"}
                                          for d, r in runs.items()},
          "param_rel_err": rel, "bound": FIT_PARITY_BOUND})


def phase_stepped():
    """The small flagship (bf16, heads of 128) through FFModel's stepped
    API on the card: weight gradients against the whole step's, gradient
    accumulation, and one launch of each flash kernel per layer per
    forward or backward."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import build_flagship_cg

    cfg = dict(batch=2, seq=128, embed=256, heads=2, layers=2, vocab=512)
    m = FFModel.from_computation_graph(*build_flagship_cg(**cfg),
                                       config=FFConfig(batch_size=2, seed=0, print_freq=0))
    m.compile(AdamOptimizer(alpha=1e-3), "sparse_categorical_crossentropy",
              compute_dtype=torch.bfloat16)
    rs = np.random.RandomState(1)
    x = rs.randn(cfg["batch"], cfg["seq"], cfg["embed"]).astype(np.float32)
    y = rs.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"])).astype(np.int32)
    _, want = m.instance.loss_and_grads(m.params, {"x": x}, y)
    layers = cfg["layers"]

    def expect(fwd, bwd, when):
        got = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
        exp = {n: 0 for n in got}
        exp.update(flash_fwd=fwd * layers, flash_delta=bwd * layers, flash_bwd=bwd * layers)
        if got != exp:
            raise AssertionError(f"stepped, {when}: launches {got}, expected {exp}")
        return got

    fa.reset_launch_counts()
    m.forward({"x": x})
    expect(1, 0, "after a forward")
    m.zero_gradients()
    m.backward(y)
    expect(1, 1, "after a backward")
    first = {k: g.clone() for k, g in m._backing.param_grads.items()}
    rel = {k: float((first[k] - g).norm() / g.norm()) for k, g in want.items()}
    if first.keys() != want.keys() or not max(rel.values()) < PARITY_BOUND:
        raise AssertionError(f"stepped: gradients against the whole step's: {rel}")
    m.forward({"x": x})
    m.backward(y)
    launches = expect(2, 2, "after two forwards and backwards")
    acc = {k: float((g - 2 * first[k]).norm() / (2 * first[k]).norm())
           for k, g in m._backing.param_grads.items()}
    if not max(acc.values()) < 1e-2:
        raise AssertionError(f"stepped: accumulated gradients against twice the first: {acc}")
    before = {k: p.clone() for k, p in m.params.items()}
    m.update()
    if not all(torch.isfinite(p).all() and not torch.equal(p, before[k])
               for k, p in m.params.items()):
        raise AssertionError("stepped: update left a parameter unchanged or non-finite")
    emit({"phase": "stepped", "config": cfg, "compute_dtype": "bf16",
          "grad_rel_err_max": max(rel.values()), "bound": PARITY_BOUND,
          "accumulated_rel_err_max": max(acc.values()), "accumulated_bound": 1e-2,
          "launches": launches})


def _host_batch_ms(x, batch: int, reps: int = 3) -> dict:
    """One batch drawn as fit draws it, timed alone: the host gather of its
    rows and the pageable copy to the card (median of reps)."""
    import torch
    from flexflow_tpu_torch.core import SingleDataLoader

    dl = SingleDataLoader(None, x, batch, device="cuda")
    gather, copy = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        host = dl.next_batch_host()
        t1 = time.perf_counter()
        torch.as_tensor(host, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        gather.append((t1 - t0) * 1e3)
        copy.append((t2 - t1) * 1e3)
    return {"gather_ms": statistics.median(gather), "copy_ms": statistics.median(copy),
            "batch_bytes": host.nbytes}


def phase_fit(smi: str, steps: int = STEPS):
    """The flagship through FFModel: from_computation_graph, compile (bf16,
    Adam(1e-4)), one warm-up fit on the first batch, then one timed fit
    over the next `steps` batches with every launch count set to 0 just
    before and read just after. Then the same batches from the parameters
    right after compile, driven through train_step directly, must end
    bitwise equal."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels.optimizer import make_optimizer_state
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_cg, model_step_flops

    cfg, b = FLAGSHIP, FLAGSHIP["batch"]
    start = time.perf_counter()
    m = FFModel.from_computation_graph(*build_flagship_cg(**cfg),
                                       config=FFConfig(batch_size=b, seed=0, print_freq=0))
    m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy", metrics=FIT_METRICS,
              compute_dtype=torch.bfloat16)
    init = {k: p.cpu() for k, p in m.params.items()}  # on the host: off fit's peak memory
    rng = np.random.default_rng(0)
    x = rng.standard_normal(((steps + 1) * b, cfg["seq"], cfg["embed"]), dtype=np.float32)
    y = rng.integers(0, cfg["vocab"], ((steps + 1) * b, cfg["seq"]), dtype=np.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    t0 = time.perf_counter()
    warm = m.fit(x[:b], y[:b], epochs=1, shuffle=False, verbose=False)
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    perf = m.fit(x[b:], y[b:], epochs=1, shuffle=False, verbose=False)
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    want = {n: cfg["layers"] * steps if n in FLASH_WRAPPERS else 0 for n in launches}
    if launches != want:
        raise AssertionError(f"fit: launches {launches}, expected {want}")
    tokens = b * cfg["seq"]
    if perf.train_all != steps * tokens or not math.isfinite(perf.sparse_cce_loss):
        raise AssertionError(f"fit: {perf}")
    host = _host_batch_ms(x, b)

    params = {k: p.to(m.device) for k, p in init.items()}
    opt_state = make_optimizer_state(m.instance.optimizer_attrs, params)
    for i in range(steps + 1):
        rows = slice(i * b, (i + 1) * b)
        params, opt_state, _, _ = m.instance.train_step(params, opt_state, {"x": x[rows]}, y[rows])
    differ = [k for k, p in params.items() if not torch.equal(p, m.params[k])]
    if differ:
        raise AssertionError(f"fit: parameters differ from train_step driven directly: {differ}")
    del params, opt_state
    trace = _profiled_fit(m, x[b:], y[b:])
    step_ms = elapsed * 1e3 / steps
    flops = model_step_flops(**cfg)
    emit({
        "phase": "fit", "config": cfg, "card": smi, "compute_dtype": "bf16",
        "optimizer": "adam(alpha=1e-4)", "metrics": FIT_METRICS, "setup_s": setup_s,
        "warmup_fit_ms": warm_ms, "warmup_perf": dataclasses.asdict(warm),
        "steps": steps, "fit_elapsed_s": elapsed, "step_ms": step_ms,
        "step_ms_is": "the timed fit call's elapsed / steps, ending in one synchronize",
        "tokens_per_s": tokens / (step_ms / 1e3), "step_flops": flops,
        "mfu": flops / (step_ms / 1e3) / PEAK_BF16, "host_batch": host,
        "profiled_fit": {"host_ms_per_step": trace["host_ms"] / steps,
                         "kernel_ms_per_step": trace["kernel_ms"] / steps,
                         "idle_share": 1.0 - trace["kernel_ms"] / trace["host_ms"],
                         "top_kernels": trace["top_kernels"]},
        "peak_memory_bytes": peak, "perf": dataclasses.asdict(perf),
        "accuracy": perf.accuracy, "mean_sparse_cce": perf.sparse_cce_loss / perf.train_all,
        "launches": launches, "launches_per_step_each": cfg["layers"],
        "bitwise_equal_to_train_step": True,
    })
    FIT_RUN.update(step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
                   mfu=flops / (step_ms / 1e3) / PEAK_BF16, peak_memory_bytes=peak)
    del m, init
    torch.cuda.empty_cache()
    return {name: n for name, n in launches.items() if name in FLASH_WRAPPERS}


FIT_WINDOW_K, FIT_WINDOW_WINDOWS = 8, 2  # fit_window's steps_per_dispatch and timed windows
FIT_WINDOW_KERNELS = {  # what rows 1-3 launch, by the wrapper whose launches each counts
    "ff_flash_fwd_kernel": "flash_fwd", "ff_flash_delta_kernel": "flash_delta",
    "ff_flash_bwd_dkv_kernel": "flash_bwd", "ff_flash_bwd_dq_kernel": "flash_bwd",
}
WINDOW_LOSS_BOUND = 1e-3  # relative, each step's loss, where a window is not bitwise
WINDOW_PARAM_BOUND = 1e-2  # relative, each parameter, likewise


def _record_window_losses(m, arrivals=None) -> list:
    """The losses of every step m's fused windows run, as the windows
    return them (on the card until read); `arrivals` gets the host clock
    at each window's dispatch. The wrapper sits on the instance, which it
    refers to: `del m.instance.multi_train_step` when done, so that no
    reference cycle holds the instance's graphs."""
    losses, multi = [], m.instance.multi_train_step

    def multi_train_step(*args):
        if arrivals is not None:
            arrivals.append(time.perf_counter())
        out = multi(*args)
        losses.append(out[3])
        return out

    m.instance.multi_train_step = multi_train_step
    return losses


def _window_parity(phase: str, got_params, want_params, got_losses, want_losses) -> dict:
    """Bitwise equality of a fused run with its eager reference, or, where
    a captured op took another path than the eager one, every step's loss
    within WINDOW_LOSS_BOUND and every parameter within WINDOW_PARAM_BOUND
    (relative); raises if neither holds."""
    import torch

    differ = [k for k, p in want_params.items() if not torch.equal(got_params[k], p)]
    losses_equal = torch.equal(got_losses, want_losses)
    if not differ and losses_equal:
        return {"bitwise": True}
    loss_rel = float(((got_losses - want_losses).abs() / want_losses.abs()).max())
    param_rel = max(float((got_params[k] - want_params[k]).norm() / want_params[k].norm())
                    for k in want_params)
    out = {"bitwise": False, "params_not_bitwise": differ, "losses_bitwise": losses_equal,
           "max_loss_rel": loss_rel, "loss_bound": WINDOW_LOSS_BOUND,
           "max_param_rel": param_rel, "param_bound": WINDOW_PARAM_BOUND}
    if not (loss_rel < WINDOW_LOSS_BOUND and param_rel < WINDOW_PARAM_BOUND):
        raise AssertionError(f"{phase}: the fused run differs from the eager steps: {out}")
    return out


def _fused_mlp(k: int, device: str = "cuda", **config):
    """tests/test_fused_dispatch.py's model (32 -> 32 relu -> Dropout 0.1
    -> 10, batch 16, Adam(1e-2)) through FFModel on the card, fused at K;
    `config`: further FFConfig fields."""
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel

    m = FFModel(FFConfig(batch_size=16, seed=0, steps_per_dispatch=k, print_freq=0, **config),
                device=device)
    x = m.create_tensor([16, 32], name="x")
    h = m.dropout(m.relu(m.dense(x, 32, use_bias=False, name="fc1")), 0.1)
    m.dense(h, 10, use_bias=False, name="head")
    m.compile(AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy", metrics=["accuracy"])
    return m


def phase_parity_fit_window():
    """The Dropout model fit on the card, f32, two epochs of 8 shuffled
    batches, then set_learning_rate and one more fit: at K=4 (two windows
    an epoch) and K=3 (3 + 3 + 2, the tail) bitwise equal to the per-step
    loop (K=1, eager), step losses and parameters, with the graphs
    captured and dropped as the window lengths and the learning rate
    say. Replayed windows that repeated a Dropout mask (an unregistered
    generator) or kept the old learning rate (a graph not dropped) would
    differ."""
    import numpy as np
    import torch

    start = time.perf_counter()
    rs = np.random.RandomState(0)
    data = [(rs.randn(128, 32).astype(np.float32), rs.randint(0, 10, 128)) for _ in range(2)]
    runs = {}
    for k in (1, 4, 3):
        m = _fused_mlp(k)
        steps = []
        if k == 1:
            step = m.instance.train_step

            def train_step(*args, _step=step):
                out = _step(*args)
                steps.append(out[2].reshape(1))
                return out

            m.instance.train_step = train_step
        else:
            steps = _record_window_losses(m)
        m.fit(*data[0], epochs=2, shuffle=True, verbose=False)
        first = {key: p.clone() for key, p in m.params.items()}
        captures = m.instance.graphs.captures
        m.set_learning_rate(3e-3)
        dropped = len(m.instance.graphs) == 0
        m.fit(*data[1], epochs=1, shuffle=True, verbose=False, epoch_offset=1)
        runs[k] = dict(first=first, final=m.params, losses=torch.cat(steps),
                       step=int(m.opt_state["step"]), captures=(captures, m.instance.graphs.captures),
                       dropped=dropped)
        del m.instance.__dict__["train_step" if k == 1 else "multi_train_step"]
        m.invalidate_graphs()
    ref = runs[1]
    out = {}
    for k, want_captures in ((4, (1, 2)), (3, (2, 4))):
        r = runs[k]
        if not (r["step"] == ref["step"] == 24) or r["captures"] != want_captures or \
                not r["dropped"]:
            raise AssertionError(f"parity_fit_window K={k}: step {r['step']}, captures "
                                 f"{r['captures']} (expected {want_captures}), dropped "
                                 f"{r['dropped']}")
        out[k] = {
            "before_set_learning_rate": _window_parity(
                f"parity_fit_window K={k}", r["first"], ref["first"], r["losses"][:16],
                ref["losses"][:16]),
            "after": _window_parity(f"parity_fit_window K={k}", r["final"], ref["final"],
                                    r["losses"], ref["losses"]),
            "captures": r["captures"], "opt_step": r["step"],
        }
    emit({"phase": "parity_fit_window", "model": "32-32 relu dropout(0.1)-10, batch 16",
          "optimizer": "adam(alpha=1e-2), then set_learning_rate(3e-3)",
          "epochs": "2, then 1 after set_learning_rate", "reference": "K=1, eager",
          "windows": {str(k): v for k, v in out.items()}, "seconds": time.perf_counter() - start})


def _profiled_fit(m, x, y) -> dict:
    """One fit under torch.profiler: host ms to its synchronized end, the
    card's kernel ms, and each flash and ring kernel's launches and ms."""
    import torch
    from torch.autograd import DeviceType
    from flexflow_tpu_torch.profile_step import device_trace

    torch.cuda.synchronize()
    with device_trace() as prof:  # closing at the fit's end could drop its last records
        start = time.perf_counter()
        m.fit(x, y, epochs=1, shuffle=False, verbose=False)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash = [e for e in kernels if e.key.startswith(("ff_flash_", "ff_ring_"))]
    return {"host_ms": host_ms, "kernel_ms": kernel_ms,
            "flash": {e.key: e.count for e in flash},
            "flash_ms": {e.key: e.self_device_time_total / 1e3 for e in flash},
            "top_kernels": [{"name": e.key[:120], "ms": e.self_device_time_total / 1e3,
                             "calls": e.count}
                            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]],
            "by_kernel": {e.key[:120]: (e.count, e.self_device_time_total / 1e3) for e in kernels}}


def phase_fit_window(smi: str, k: int = FIT_WINDOW_K, windows: int = FIT_WINDOW_WINDOWS):
    """The flagship through FFModel with steps_per_dispatch=k (bf16,
    Adam(1e-4)): a one-window warm-up fit, where the k-step graph is
    captured; the state put back to compile's in place; one timed fit of
    `windows` windows of seeded host batches, unshuffled; one profiled fit
    of the same, whose trace counts each kernel's launches (a replay runs
    no Python, so the wrappers' counts stay at 0); then the same batches
    from compile's parameters through train_step, eagerly, which the timed
    fit must equal bitwise (or within the window bounds, saying so)."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels.optimizer import make_optimizer_state
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_cg, model_step_flops

    cfg, b = FLAGSHIP, FLAGSHIP["batch"]
    steps = k * windows
    start = time.perf_counter()
    m = FFModel.from_computation_graph(
        *build_flagship_cg(**cfg),
        config=FFConfig(batch_size=b, seed=0, print_freq=0, steps_per_dispatch=k))
    m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy", metrics=FIT_METRICS,
              compute_dtype=torch.bfloat16)
    init = {key: p.cpu() for key, p in m.params.items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((steps * b, cfg["seq"], cfg["embed"]), dtype=np.float32)
    y = rng.integers(0, cfg["vocab"], (steps * b, cfg["seq"]), dtype=np.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    graphs = m.instance.graphs
    t0 = time.perf_counter()
    m.fit(x[:k * b], y[:k * b], epochs=1, shuffle=False, verbose=False)
    warm_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():  # compile's state again, written in place: the graph stays valid
        for key, p in m.params.items():
            p.copy_(init[key])
        for slot in ("m", "v"):
            for t in m.opt_state[slot].values():
                t.zero_()
        m.opt_state["step"].zero_()
    arrivals = []
    losses = _record_window_losses(m, arrivals)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    perf = m.fit(x, y, epochs=1, shuffle=False, verbose=False)
    elapsed = time.perf_counter() - t0
    dispatch_ms = [(t - t0) * 1e3 for t in arrivals]
    counters = _flash_launches()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    opt_step = int(m.opt_state["step"])
    if graphs.captures != 1 or any(counters.values()) or opt_step != steps:
        raise AssertionError(f"fit_window: {graphs.captures} captures, wrapper counts {counters}, "
                             f"optimizer step {opt_step} (expected 1, all 0, {steps})")
    tokens = b * cfg["seq"]
    if perf.train_all != steps * tokens or not math.isfinite(perf.sparse_cce_loss):
        raise AssertionError(f"fit_window: {perf}")
    fitted = {key: p.clone() for key, p in m.params.items()}
    fitted_losses = torch.cat(losses)

    trace = _profiled_fit(m, x, y)
    want = {name: cfg["layers"] * steps for name in FIT_WINDOW_KERNELS}
    if trace["flash"] != want:
        raise AssertionError(f"fit_window: the trace of {windows} windows counts {trace['flash']} "
                             f"flash and ring launches, expected {want}")
    capture_ms = graphs.capture_ms[0]
    del m.instance.multi_train_step
    m.invalidate_graphs()
    torch.cuda.empty_cache()

    params = {key: p.to(m.device) for key, p in init.items()}
    opt_state = make_optimizer_state(m.instance.optimizer_attrs, params)
    ref_losses = []
    for i in range(steps):
        rows = slice(i * b, (i + 1) * b)
        params, opt_state, loss, _ = m.instance.train_step(params, opt_state, {"x": x[rows]}, y[rows])
        ref_losses.append(loss.reshape(1))
    parity = _window_parity("fit_window", fitted, params, fitted_losses, torch.cat(ref_losses))
    step_ms = elapsed * 1e3 / steps
    flops = model_step_flops(**cfg)
    per_window = {name: n // windows for name, n in trace["flash"].items()}
    emit({
        "phase": "fit_window", "config": cfg, "card": smi, "compute_dtype": "bf16",
        "optimizer": "adam(alpha=1e-4)", "metrics": FIT_METRICS, "steps_per_dispatch": k,
        "windows": windows, "steps": steps, "setup_s": setup_s, "warmup_fit_ms": warm_ms,
        "capture_ms": capture_ms, "fit_elapsed_s": elapsed, "step_ms": step_ms,
        "window_dispatch_ms": dispatch_ms,
        "window_dispatch_ms_is": "host ms from the timed fit's start to each window's dispatch "
                                 "(the first: the pipeline's fill, the first window's gather "
                                 "and copy)",
        "step_ms_is": "the timed fit's elapsed / steps, ending in one synchronize",
        "tokens_per_s": tokens / (step_ms / 1e3), "step_flops": flops,
        "mfu": flops / (step_ms / 1e3) / PEAK_BF16,
        "profiled_fit": {"host_ms_per_window": trace["host_ms"] / windows,
                         "kernel_ms_per_window": trace["kernel_ms"] / windows,
                         "idle_share": 1.0 - trace["kernel_ms"] / trace["host_ms"],
                         "top_kernels": trace["top_kernels"]},
        "launches_per_window": per_window, "launches_per_step_each": cfg["layers"],
        "wrapper_counts_in_timed_fit": counters,
        "peak_memory_allocated_bytes": peak, "peak_memory_reserved_bytes": reserved,
        "perf": dataclasses.asdict(perf), "mean_sparse_cce": perf.sparse_cce_loss / perf.train_all,
        "opt_step": opt_step, "equal_to_train_step": parity,
        "last_losses": fitted_losses[-2:].tolist(),
    })
    del m, params, opt_state, fitted, init
    torch.cuda.empty_cache()
    return {wrapper: trace["flash"][name] for name, wrapper in FIT_WINDOW_KERNELS.items()}


# the serving LM at the flagship's widths (bench.py:37), and its traffic on one card
SERVE_LM = dict(vocab_size=32000, embed_dim=1024, num_heads=8, num_layers=12, ffn_dim=4096)
SERVE_TRAFFIC = dict(slots=64, max_seq_len=1024, requests=128, prompt_len=(64, 512),
                     max_new_tokens=(32, 128), window_steps=8, mode="continuous", seed=0)
SERVE_PARITY_BOUND = 1e-4  # relative, f32 card vs f32 CPU (prefill logits, caches)
NEAR_TIE = 1e-4  # a teacher-forced logit this close below the max counts as a near-tie


def _flash_launches() -> dict:
    from flexflow_tpu_torch.kernels import flash_attention as fa

    return {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}


def _no_flash_launches(phase: str) -> None:
    """Serving attention is dense, as in the JAX package: no flash or ring
    kernel may have launched since the counts were last set to 0."""
    moved = {name: n for name, n in _flash_launches().items() if n}
    if moved:
        raise AssertionError(f"{phase}: flash kernels launched while serving: {moved}")


def _seeded_params(pcg, seed: int) -> dict:
    """Serving parameters drawn with numpy from `seed`, keyed by ordinal:
    glorot-uniform matrices, vectors at their initializer's constant (1 for
    LayerNorm's gamma, else 0) plus N(0, 0.1) noise."""
    import numpy as np
    from flexflow_tpu_torch.local_execution.training_backing import weight_shape
    from flexflow_tpu_torch.pcg.initializer import ConstantInitializerAttrs
    from flexflow_tpu_torch.serving.program import weight_ordinals

    rng = np.random.default_rng(seed)
    out = {}
    for n, key in weight_ordinals(pcg).items():
        dims = weight_shape(pcg, n).dims
        if len(dims) == 2:
            limit = math.sqrt(6.0 / (dims[0] + dims[1]))
            out[key] = rng.uniform(-limit, limit, dims).astype(np.float32)
        else:
            (o,) = pcg.outputs_of(n)
            init = pcg.tensor_attrs(o).initializer
            base = init.value if isinstance(init, ConstantInitializerAttrs) else 0.0
            out[key] = (base + 0.1 * rng.standard_normal(dims)).astype(np.float32)
    return out


def _serve_requests(n, vocab, prompt_len, max_new_tokens, seed):
    """`n` requests with seeded prompt tokens, prompt lengths and budgets,
    each drawn uniformly from its inclusive range."""
    import numpy as np
    from flexflow_tpu_torch.serving import ServeRequest

    rng = np.random.default_rng(seed)
    return [
        ServeRequest(rid=f"r{i}",
                     prompt=rng.integers(0, vocab, int(rng.integers(prompt_len[0], prompt_len[1] + 1)))
                     .astype(np.int32),
                     max_new_tokens=int(rng.integers(max_new_tokens[0], max_new_tokens[1] + 1)))
        for i in range(n)
    ]


def _serve_trace(program, mode: str, requests, window_steps: int) -> dict:
    from flexflow_tpu_torch.serving import ServingEngine

    eng = ServingEngine(program, mode=mode, window_steps=window_steps)
    try:
        for r in requests:
            eng.submit(r)
        return {r.rid: list(r.tokens) for r in eng.run()}
    finally:
        eng.close()


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def phase_parity_serve():
    """Small serving LMs (ServingLMConfig(), and 2 layers of embed 256 in 2
    heads of 128) from the same numpy parameters on the card (f32) and on
    the CPU (f32, the port's own code): prefill logits and caches within
    SERVE_PARITY_BOUND, the same tokens per request through the engine in
    continuous and static mode, and one fused window of W steps bitwise
    equal to W one-step windows on the card."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.interop import serving_params_from_numpy
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.serving import (
        ServingLMConfig,
        ServingMemorySpec,
        ServingProgram,
        build_serving_lm,
    )
    from flexflow_tpu_torch.serving.program import as_pcg

    start = time.perf_counter()
    fa.reset_launch_counts()
    slots, cap, window = 4, 24, 4
    mem = ServingMemorySpec(max_concurrent_seqs=slots, max_seq_len=cap)
    for name, cfg in (("tiny", ServingLMConfig()),
                      ("d128", ServingLMConfig(vocab_size=512, embed_dim=256, num_heads=2,
                                               num_layers=2, ffn_dim=1024))):
        cg, _ = build_serving_lm(cfg, slots, 1)
        np_params = _seeded_params(as_pcg(cg), seed=1)
        progs = {dev: ServingProgram(cg, mem, params=serving_params_from_numpy(cg, np_params, dev),
                                     device=dev) for dev in ("cpu", "cuda")}
        rng = np.random.default_rng(2)
        prompts = rng.integers(0, cfg.vocab_size, (slots, 12)).astype(np.int32)
        lengths = rng.integers(4, 13, slots).astype(np.int32)
        fresh = np.ones(slots, bool)
        out = {dev: p.prefill(p.init_cache(), prompts, lengths, fresh) for dev, p in progs.items()}
        (c_cache, c_tok, c_last), (g_cache, g_tok, g_last) = out["cpu"], out["cuda"]
        logits_rel = _rel(g_last.cpu(), c_last)
        cache_rel = max(
            _rel(g_cache[layer][part][i, :, :lengths[i]].cpu(), c_cache[layer][part][i, :, :lengths[i]])
            for layer in c_cache for part in ("k", "v") for i in range(slots)
        )
        if not (logits_rel < SERVE_PARITY_BOUND and cache_rel < SERVE_PARITY_BOUND):
            raise AssertionError(f"parity_serve {name}: prefill logits rel {logits_rel}, "
                                 f"cache rel {cache_rel} (bound {SERVE_PARITY_BOUND})")
        if not torch.equal(g_tok.cpu(), c_tok):
            raise AssertionError(f"parity_serve {name}: first tokens {g_tok} vs CPU {c_tok}")

        # one fused window == `window` one-step windows, bitwise, on the card
        card = progs["cuda"]
        runs = []
        for steps in (window, 1):
            cache, tok, _ = card.prefill(card.init_cache(), prompts, lengths, fresh)
            lens, toks = lengths, []
            for _ in range(window // steps):
                cache, tok, lens, t = card.decode_window(cache, tok, lens, fresh, steps)
                toks.append(t)
            runs.append((torch.cat(toks, dim=1), lens, cache))
        (f_toks, f_lens, f_cache), (s_toks, s_lens, s_cache) = runs
        fused_bitwise = (torch.equal(f_toks, s_toks) and torch.equal(f_lens, s_lens) and all(
            torch.equal(f_cache[layer][part], s_cache[layer][part])
            for layer in f_cache for part in ("k", "v")))
        if not fused_bitwise:
            raise AssertionError(f"parity_serve {name}: a fused window of {window} steps differs "
                                 f"from {window} one-step windows")
        cache, tok, _ = card.prefill(card.init_cache(), prompts, lengths, fresh)
        graph_bitwise = _graph_window_bitwise(
            card, cache, tok, torch.as_tensor(lengths, device="cuda"),
            torch.as_tensor(fresh, device="cuda"), window, windows=2)
        if not graph_bitwise:
            raise AssertionError(f"parity_serve {name}: the captured decode window differs from "
                                 "the eager body")

        traces = {}
        for mode in ("continuous", "static"):
            requests = _serve_requests(8, cfg.vocab_size, (4, 12), (6, 10), seed=3)
            got = {dev: _serve_trace(p, mode, requests, window) for dev, p in progs.items()}
            if got["cuda"] != got["cpu"] or len(got["cpu"]) != 8:
                raise AssertionError(f"parity_serve {name} {mode}: card tokens {got['cuda']} "
                                     f"vs CPU {got['cpu']}")
            traces[mode] = sum(len(t) for t in got["cpu"].values())
        emit({"phase": "parity_serve", "model": name, "config": dataclasses.asdict(cfg),
              "slots": slots, "max_seq_len": cap, "window_steps": window,
              "prefill_logits_rel_err": logits_rel, "cache_rel_err": cache_rel,
              "bound": SERVE_PARITY_BOUND, "fused_window_bitwise": fused_bitwise,
              "graph_window_bitwise_to_eager": graph_bitwise,
              "tokens_equal": True, "tokens_per_mode": traces})
    _no_flash_launches("parity_serve")
    emit({"phase": "parity_serve", "seconds": time.perf_counter() - start,
          "launches": _flash_launches()})


def _graph_window_bitwise(program, cache, token, lengths, active, steps: int,
                          windows: int) -> bool:
    """`windows` decode windows of `steps` from one state, through the
    captured graph (decode_window) on `cache` and through the eager body
    (decode_window_eager) on a copy of it: the same tokens, lengths and
    cache, bit for bit."""
    import torch

    copy = {layer: {part: t.clone() for part, t in kv.items()} for layer, kv in cache.items()}
    runs = []
    for decode, kv in ((program.decode_window, cache), (program.decode_window_eager, copy)):
        tok, lens, toks = token, lengths, []
        for _ in range(windows):
            kv, tok, lens, t = decode(kv, tok, lens, active, steps)
            toks.append(t)
        runs.append((torch.cat(toks, dim=1), tok, lens))
    same = all(torch.equal(a, b) for a, b in zip(*runs)) and all(
        torch.equal(cache[layer][part], copy[layer][part])
        for layer in cache for part in ("k", "v"))
    del copy
    torch.cuda.empty_cache()
    return same


def _timed(fn, log: list, peaks: list):
    """`fn` (whose first argument is the cache) with each call's host time,
    to its synchronized end, appended to `log` as (ms, the other args), and
    the peak memory allocated and reserved since the last call's end to
    `peaks`."""
    import torch

    def wrapped(cache, *args):
        start = time.perf_counter()
        out = fn(cache, *args)
        torch.cuda.synchronize()
        log.append(((time.perf_counter() - start) * 1e3, args))
        peaks.append((torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()))
        torch.cuda.reset_peak_memory_stats()
        return out

    return wrapped


def _teacher_forced(program, records, requests, cfg) -> dict:
    """Prefill each request's prompt and generated tokens (but the last) in
    one causal pass on the card: every generated token must be the argmax
    of the logits before it, or within NEAR_TIE of their max."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.serving import ServingMemorySpec, ServingProgram, build_serving_lm

    n, cap = len(records), program.serving.max_seq_len
    cg, _ = build_serving_lm(cfg, n, 1)
    tf = ServingProgram(cg, ServingMemorySpec(n, cap), params=program.params)
    prompts = [requests[r.rid].prompt for r in records]
    seqs = [np.concatenate([p, np.asarray(r.tokens[:-1], np.int32)]) for p, r in zip(prompts, records)]
    width = max(len(s) for s in seqs)
    tokens = np.zeros((n, width), np.int32)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = s
    lengths = torch.tensor([len(s) for s in seqs], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, _ = tf._forward(tf.params, torch.as_tensor(tokens, device="cuda"), tf.init_cache(),
                                lengths, torch.ones(n, dtype=torch.bool, device="cuda"), "prefill")
    argmax_hits = near_ties = 0
    worst_gap = 0.0
    for i, (p, r) in enumerate(zip(prompts, records)):
        rows = logits[i, len(p) - 1:len(p) - 1 + len(r.tokens)]
        picked = rows[torch.arange(len(r.tokens), device="cuda"),
                      torch.as_tensor(r.tokens, device="cuda").long()]
        gap = (rows.max(dim=-1).values - picked).cpu()
        hits = int((rows.argmax(dim=-1).cpu() == torch.as_tensor(r.tokens)).sum())
        argmax_hits += hits
        near_ties += len(r.tokens) - hits
        worst_gap = max(worst_gap, float(gap.max()))
    if not worst_gap <= NEAR_TIE:
        raise AssertionError(f"serve: a generated token sits {worst_gap} below the teacher-forced "
                             f"max logit (near-tie bound {NEAR_TIE})")
    return {"requests": n, "tokens": argmax_hits + near_ties, "argmax": argmax_hits,
            "near_ties": near_ties, "max_gap_below_max_logit": worst_gap, "bound": NEAR_TIE}


def _decode_split(program, cache, steps: int, decode) -> dict:
    """A decode window of `steps` at every slot active through `decode`
    (the captured window, or the eager body), timed on the host (to its
    return, and to its synchronized end), then the same window traced for
    its device (kernel) time: the device's idle share is what the host
    costs it."""
    import torch
    from torch.autograd import DeviceType
    from flexflow_tpu_torch.profile_step import device_trace

    slots = program.serving.max_concurrent_seqs
    token = torch.zeros(slots, dtype=torch.int32, device="cuda")
    lengths = torch.full((slots,), program.serving.max_seq_len // 2, dtype=torch.int32,
                         device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    decode(cache, token, lengths, active, steps)
    torch.cuda.synchronize()
    start = time.perf_counter()
    decode(cache, token, lengths, active, steps)
    enqueued_ms = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - start) * 1e3
    with device_trace() as prof:
        start = time.perf_counter()
        decode(cache, token, lengths, active, steps)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"steps": steps, "host_ms_per_step": host_ms / steps,
            "enqueue_ms_per_step": enqueued_ms / steps,
            "traced_host_ms_per_step": traced_ms / steps,
            "kernel_ms_per_step": kernel_ms / steps,
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "idle_share": 1.0 - kernel_ms / host_ms if kernel_ms else None,
            "top_kernels": [{"name": e.key[:120], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                             "calls_per_step": e.count / steps} for e in top]}


def phase_serve(smi: str) -> None:
    """The serving LM at the flagship's widths on one card: SERVE_TRAFFIC's
    requests through the continuous-batching engine after one warm-up
    request, the cache's bytes held against per_device_cache_bytes, 4
    requests held against a teacher-forced prefill, and no flash kernel
    launched."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.serving import (
        ServeRequest,
        ServingEngine,
        ServingLMConfig,
        ServingMemorySpec,
        ServingProgram,
        build_serving_lm,
        per_device_cache_bytes,
    )

    start = time.perf_counter()
    fa.reset_launch_counts()
    t = SERVE_TRAFFIC
    cfg = ServingLMConfig(**SERVE_LM)
    mem = ServingMemorySpec(max_concurrent_seqs=t["slots"], max_seq_len=t["max_seq_len"])
    cg, _ = build_serving_lm(cfg, t["slots"], 1)
    program = ServingProgram(cg, mem, params_seed=t["seed"])
    param_bytes = sum(p.numel() * p.element_size() for p in program.params.values())
    cache_bytes = per_device_cache_bytes(program.pcg, program.layers, mem)
    setup_s = time.perf_counter() - start

    warm = ServingEngine(program, mode=t["mode"], window_steps=t["window_steps"])
    warm.submit(ServeRequest("warmup", np.arange(t["prompt_len"][0], dtype=np.int32),
                             t["window_steps"] * 2))
    warm.run()
    warm.close()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    before = torch.cuda.memory_allocated()
    eng = ServingEngine(program, mode=t["mode"], window_steps=t["window_steps"])
    allocated = torch.cuda.memory_allocated() - before
    if allocated != cache_bytes:
        raise AssertionError(f"serve: the cache allocated {allocated} B, per_device_cache_bytes "
                             f"says {cache_bytes}")
    prefills, windows, prefill_peaks, window_peaks = [], [], [], []
    program.prefill = _timed(program.prefill, prefills, prefill_peaks)
    program.decode_window = _timed(program.decode_window, windows, window_peaks)
    requests = _serve_requests(t["requests"], cfg.vocab_size, t["prompt_len"],
                               t["max_new_tokens"], t["seed"])
    torch.cuda.reset_peak_memory_stats()
    run_start = time.perf_counter()
    for r in requests:
        eng.submit(r)
    records = eng.run()
    run_s = time.perf_counter() - run_start
    summary = eng.summary()
    peaks = prefill_peaks + window_peaks + [
        (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())]
    peak, reserved = max(a for a, _ in peaks), max(r for _, r in peaks)
    del program.prefill, program.decode_window
    eng.close()

    by_rid = {r.rid: r for r in requests}
    if sorted(r.rid for r in records) != sorted(by_rid):
        raise AssertionError(f"serve: {len(records)} of {len(requests)} requests completed")
    for r in records:
        if len(r.tokens) != by_rid[r.rid].max_new_tokens or not all(
                0 <= tok < cfg.vocab_size for tok in r.tokens):
            raise AssertionError(f"serve: request {r.rid} generated {len(r.tokens)} tokens "
                                 f"(budget {by_rid[r.rid].max_new_tokens}) or one out of range")
    teacher = _teacher_forced(program, sorted(records, key=lambda r: int(r.rid[1:]))[:4],
                              by_rid, cfg)
    cache = eng.replicas[0].cache
    captured = {"captures": program.graphs.captures, "graphs": len(program.graphs),
                "capture_ms": program.graphs.capture_ms}
    if not program.graphs.captures or len(program.graphs) > 2 * t["window_steps"]:
        raise AssertionError(f"serve: decode graphs {captured}; at most {t['window_steps']} step "
                             "counts for each of the two engines' caches")
    slots = t["slots"]
    graph_bitwise = _graph_window_bitwise(
        program, cache, torch.arange(slots, dtype=torch.int32, device="cuda"),
        torch.full((slots,), t["max_seq_len"] // 4, dtype=torch.int32, device="cuda"),
        torch.ones(slots, dtype=torch.bool, device="cuda"), t["window_steps"], windows=1)
    if not graph_bitwise:
        raise AssertionError("serve: the captured decode window differs from the eager body")
    # the eager window first: its timing is the host's, and no trace of
    # the captured one runs before it
    eager_split = _decode_split(program, cache, t["window_steps"], program.decode_window_eager)
    split = _decode_split(program, cache, t["window_steps"], program.decode_window)
    _no_flash_launches("serve")

    tokens = summary["tokens_generated"]
    decode_ms = [ms / args[3] for ms, args in windows]
    bound_ms = (param_bytes + cache_bytes) / PEAK_BYTES * 1e3
    SERVE_MEASURED.update(
        median_decode_ms_per_step=statistics.median(decode_ms),
        median_prefill_ms=statistics.median(ms for ms, _ in prefills),
        median_prefill_width=int(statistics.median_low(
            int(np.asarray(args[0]).shape[1]) for _, args in prefills)))
    emit({
        "phase": "serve", "card": smi, "config": SERVE_LM, "traffic": t, "dtype": "f32",
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "params": sum(p.numel() for p in program.params.values()), "param_bytes": param_bytes,
        "cache_bytes": cache_bytes, "cache_bytes_allocated": allocated,
        "requests_completed": len(records), "tokens_generated": tokens,
        "run_s": run_s, "requests_per_s": len(records) / run_s, "output_tokens_per_s": tokens / run_s,
        "summary": summary, "p50_ms_per_token": summary["p50_ms_per_token"],
        "p99_ms_per_token": summary["p99_ms_per_token"],
        "prefills": len(prefills), "median_prefill_ms": statistics.median(ms for ms, _ in prefills),
        "prefill_ms": [ms for ms, _ in prefills],
        "prefill_widths": [int(np.asarray(args[0]).shape[1]) for _, args in prefills],
        "windows": len(windows), "decode_steps": sum(args[3] for _, args in windows),
        "median_decode_ms_per_step": statistics.median(decode_ms),
        "decode_step_bound_ms": bound_ms, "decode_bound_by": "bytes",
        "decode_split": split, "eager_decode_split": eager_split,
        "decode_graphs": captured, "graph_window_bitwise_to_eager": graph_bitwise,
        "teacher_forced": teacher, "peak_memory_bytes": peak,
        "peak_memory_bytes_in_prefill": max(a for a, _ in prefill_peaks),
        "peak_memory_bytes_in_decode_windows": max(a for a, _ in window_peaks),
        "peak_memory_reserved_bytes": reserved,
        "launches": _flash_launches(), "setup_s": setup_s,
        "seconds": time.perf_counter() - start,
    })
    program.graphs.invalidate()
    del program, eng, cache
    torch.cuda.empty_cache()


ZOO_CNN_BOUND = 1e-4  # relative, loss and parameters, f32 card (TF32 off) vs f32 CPU
# relative, each attention piece's two-step update, bf16 card vs f32 CPU; every
# control (a broken d=256 forward or backward, run on the CPU) must exceed it
ZOO_BERT_UPDATE_BOUND = 0.2


def _attention_updates(graph, init, params):
    """Each attention layer's update (parameters after the steps minus
    before), cut into the q, k, v and o pieces of its weight and the q and v
    slices of its input bias, as f32 CPU tensors. The k bias is left out: a
    constant added to every key shifts a softmax row uniformly, so its
    gradient is zero but for roundoff."""
    from flexflow_tpu_torch.kernels.ops import unpack_mha_weights
    from flexflow_tpu_torch.op_attrs.ops import MultiHeadAttentionAttrs

    pieces = {}
    for layer, n in enumerate(n for n in graph.topological_ordering()
                              if isinstance(graph.op_attrs(n), MultiHeadAttentionAttrs)):
        attrs = graph.op_attrs(n)
        w, b = (f"n{t.node.idx}" for t in graph.inputs_of(n)[3:5])
        dw, db = (params[k].detach().float().cpu() - init[k].float() for k in (w, b))
        e, kd = attrs.embed_dim, attrs.q_proj_size
        for name, piece in zip("qkvo", unpack_mha_weights(attrs, e, e, e, dw)):
            pieces[f"layer{layer}.w{name}"] = piece
        pieces[f"layer{layer}.bq"], pieces[f"layer{layer}.bv"] = db[:kd], db[2 * kd:]
    return pieces


def _zoo_cnn(device: str):
    """A small CNN of the example zoo's ops through FFModel: conv2d with
    groups and bias, max and avg pool with padding (one above kernel/2),
    batch_norm, flat, concat and dense."""
    from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer

    m = FFModel(FFConfig(batch_size=8, print_freq=0, seed=0), device=device)
    x = m.create_tensor([8, 4, 16, 16], name="image")
    a = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation=Activation.RELU, groups=2)
    a = m.pool2d(a, 3, 3, 2, 2, 1, 1)
    b = m.batch_norm(m.conv2d(x, 8, 5, 5, 2, 2, 2, 2, use_bias=False))
    b = m.pool2d(b, 2, 2, 1, 1, 2, 2, pool_type="avg")
    b = m.pool2d(b, 4, 4, 2, 2, 0, 0)
    t = m.concat([m.flat(a), m.flat(b)], axis=1)
    m.dense(m.dense(t, 32, activation=Activation.RELU), 5)
    m.compile(SGDOptimizer(lr=0.05, momentum=0.9), "sparse_categorical_crossentropy",
              metrics=FIT_METRICS)
    return m


def phase_parity_zoo():
    """The example zoo on the card against the CPU. A 2-layer BERT with
    heads of 256 trained two SGD steps on the card (bf16, the d=256 kernels,
    each launched once a layer a step) and on the CPU (f32, plain versions)
    from the same parameters: losses within PARITY_BOUND, and each piece of
    every attention layer's update within ZOO_BERT_UPDATE_BOUND, a bound two
    broken d=256 paths (on the CPU) must each exceed. The small CNN fit
    one batch through FFModel on the card and on the CPU (f32 both, TF32
    off) from the same state: loss and parameters within ZOO_CNN_BOUND."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy, params_to_numpy
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import BertConfig, build_bert
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.pcg import SGDOptimizerAttrs

    # heads of 256: kdim = dim_feedforward / num_heads. initializer_range
    # 0.1 (BERT's is 0.02) gives scores of O(1), so attention is far from
    # uniform and what the kernels return shows in the updates.
    cfg = BertConfig(vocab_size=512, hidden_size=256, num_encoder_layers=2, num_heads=1,
                     dim_feedforward=256, hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0, sequence_length=128, batch_size=4,
                     initializer_range=0.1)
    graph, out = build_bert(cfg)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(cfg.batch_size, cfg.sequence_length, cfg.hidden_size, generator=gen)
    y = torch.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.sequence_length), generator=gen)
    init = None

    def run(device, dtype):
        nonlocal init
        inst = ModelTrainingInstance(graph, out, SparseCategoricalCrossEntropyLossAttrs(),
                                     SGDOptimizerAttrs(lr=0.01), compute_dtype=dtype,
                                     device=device)
        params, opt_state = inst.initialize(seed=0)
        if init is None:
            init = {k: p.detach().clone() for k, p in params.items()}
        params = {k: p.to(device, copy=True) for k, p in init.items()}  # SGD steps in place
        params, _, step_losses, _ = _train(inst, params, opt_state, x.to(device),
                                           y.to(device), 2, input_name="input")
        return step_losses, _attention_updates(graph, init, params)

    def rel_errs(pieces, want):
        return {k: float(torch.linalg.norm(v - want[k]) / torch.linalg.norm(want[k]))
                for k, v in pieces.items()}

    losses, updates = run("cpu", None)
    fa.reset_launch_counts()
    card_losses, card_updates = run("cuda", torch.bfloat16)
    launches = {n: getattr(fa, n).launches for n in FLASH_WRAPPERS}
    if launches != {n: 2 * cfg.num_encoder_layers for n in FLASH_WRAPPERS}:
        raise AssertionError(f"parity_zoo bert: d=256 launches {launches}")
    rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, losses)]
    update_rel = rel_errs(card_updates, updates)
    if not max(rel) < PARITY_BOUND or not max(update_rel.values()) < ZOO_BERT_UPDATE_BOUND:
        raise AssertionError(f"parity_zoo bert: card {card_losses} vs CPU {losses}, "
                             f"updates {update_rel}")

    # controls, on the CPU in f32: a d=256 path that drops dS (dq = dk = 0)
    # and one whose forward scores at twice the scale must each fail the bound
    fwd, bwd = fa.flash_fwd, fa.flash_bwd

    def bwd_without_ds(q, k, v, do, lse, dl, h, causal):
        dq, dk, dv = bwd(q, k, v, do, lse, dl, h, causal)
        return torch.zeros_like(dq), torch.zeros_like(dk), dv

    controls = {}
    for name, broken in (("dS dropped", (fwd, bwd_without_ds)),
                         ("scores at twice the scale",
                          (lambda q, k, v, h, causal: fwd(2 * q, k, v, h, causal), bwd))):
        fa.flash_fwd, fa.flash_bwd = broken
        try:
            controls[name] = max(rel_errs(run("cpu", None)[1], updates).values())
        finally:
            fa.flash_fwd, fa.flash_bwd = fwd, bwd
    if not min(controls.values()) > ZOO_BERT_UPDATE_BOUND:
        raise AssertionError(f"parity_zoo bert: a broken d=256 path passes the bound: "
                             f"{controls}")

    rs = np.random.RandomState(5)
    xs, ys = rs.randn(8, 4, 16, 16).astype(np.float32), rs.randint(0, 5, 8)
    cpu, card = _zoo_cnn("cpu"), _zoo_cnn("cuda")
    ffmodel_state_from_numpy(card, params_to_numpy(cpu.params))  # momentum starts at 0 on both
    perf = {d: m.fit(xs, ys, epochs=1, shuffle=False, verbose=False)
            for d, m in (("cpu", cpu), ("cuda", card))}
    loss_rel = abs(perf["cuda"].sparse_cce_loss - perf["cpu"].sparse_cce_loss) / \
        abs(perf["cpu"].sparse_cce_loss)
    got, want = params_to_numpy(card.params), params_to_numpy(cpu.params)
    param_rel = {k: float(np.linalg.norm(got[k] - v) / max(np.linalg.norm(v), 1e-30))
                 for k, v in want.items()}
    counts = {d: (p.train_all, p.train_correct) for d, p in perf.items()}
    if counts["cuda"] != counts["cpu"] or not loss_rel < ZOO_CNN_BOUND or \
            not max(param_rel.values()) < ZOO_CNN_BOUND:
        raise AssertionError(f"parity_zoo cnn: counts {counts}, loss {loss_rel}, params "
                             f"{param_rel}")
    emit({"phase": "parity_zoo",
          "bert": {"config": dataclasses.asdict(cfg) | {"hidden_act": cfg.hidden_act.name},
                   "head_dim": cfg.dim_feedforward // cfg.num_heads,
                   "losses": {"cpu": losses, "cuda": card_losses}, "rel_err": rel,
                   "bound": PARITY_BOUND, "update_rel_err": update_rel,
                   "update_bound": ZOO_BERT_UPDATE_BOUND,
                   "controls_max_update_rel_err": controls, "launches": launches},
          "cnn": {"ops": "conv2d (groups, bias), max/avg pool with padding, batch_norm, flat, "
                         "concat, dense", "counts": counts, "loss_rel_err": loss_rel,
                  "param_rel_err": param_rel, "bound": ZOO_CNN_BOUND, "tf32": False}})


def _graph_forward_flops(cg) -> int:
    """op_forward_flops summed over every op of a computation graph."""
    from flexflow_tpu_torch.kernels.ops import op_forward_flops
    from flexflow_tpu_torch.op_attrs.ops import InputAttrs, WeightAttrs

    total = 0
    for n in cg.topological_ordering():
        attrs = cg.op_attrs(n)
        if isinstance(attrs, (InputAttrs, WeightAttrs)):
            continue
        total += op_forward_flops(attrs, [cg.tensor_shape(t) for t in cg.inputs_of(n)],
                                  [cg.tensor_shape(t) for t in cg.outputs_of(n)])
    return total


def phase_fit_bert(smi: str, steps: int = STEPS):
    """BERT-base at examples/bert.py's defaults (models.build_bert(BertConfig()):
    12 layers, hidden 768, 12 heads of 256, FFN 3072, seq 512, vocab 30522,
    batch 64, dropout 0.1) compiled through FFModel in bf16 with SGD(0.01),
    one warm-up batch, then one timed fit of `steps` seeded host batches with
    every launch count set to 0 just before and read just after: each d=256
    wrapper 12 times a step and no other flash or ring kernel."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import BertConfig, build_bert

    bcfg = BertConfig()
    b, seq = bcfg.batch_size, bcfg.sequence_length
    start = time.perf_counter()
    graph, out = build_bert(bcfg)
    m = FFModel.from_computation_graph(graph, out, FFConfig(batch_size=b, seed=0, print_freq=0))
    m.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", metrics=["accuracy"],
              compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(((steps + 1) * b, seq, bcfg.hidden_size), dtype=np.float32)
    y = rng.integers(0, bcfg.vocab_size, ((steps + 1) * b, seq), dtype=np.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    t0 = time.perf_counter()
    m.fit(x[:b], y[:b], epochs=1, shuffle=False, verbose=False)
    warm_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    _reset_dense_attentions()
    t0 = time.perf_counter()
    perf = m.fit(x[b:], y[b:], epochs=1, shuffle=False, verbose=False)
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    peak = {"allocated": torch.cuda.max_memory_allocated(),
            "reserved": torch.cuda.max_memory_reserved()}
    layers = bcfg.num_encoder_layers
    want = {n: layers * steps if n in FLASH_WRAPPERS else 0 for n in launches}
    if launches != want or _dense_attentions():
        raise AssertionError(f"fit_bert: launches {launches}, expected {want}; "
                             f"{_dense_attentions()} dense attentions")
    tokens = b * seq
    # the training loss (Dropout on) at the fitted parameters, read once
    with torch.no_grad():
        loss = float(m.instance.loss_fn(m.params, {"input": x[:b]}, y[:b],
                                        torch.Generator(device="cuda").manual_seed(0))[0])
    if perf.train_all != steps * tokens or not math.isfinite(loss):
        raise AssertionError(f"fit_bert: loss {loss}, {perf}")
    trace = _profiled_fit(m, x[b:], y[b:])
    expected = {k: layers * steps for k in D256_KERNELS}
    if trace["flash"] != expected:
        raise AssertionError(f"fit_bert: profiled launches {trace['flash']}, expected {expected}")
    step_ms = elapsed * 1e3 / steps
    flops = 3 * _graph_forward_flops(graph)
    FIT_BERT_RUN.update(step_ms=step_ms, mfu=flops / (step_ms / 1e3) / PEAK_BF16)
    emit({
        "phase": "fit_bert", "card": smi,
        "config": dataclasses.asdict(bcfg) | {"hidden_act": bcfg.hidden_act.name},
        "head_dim": bcfg.dim_feedforward // bcfg.num_heads, "compute_dtype": "bf16",
        "optimizer": "sgd(lr=0.01)", "setup_s": setup_s, "warmup_fit_ms": warm_ms,
        "steps": steps, "fit_elapsed_s": elapsed, "step_ms": step_ms,
        "step_ms_is": "the timed fit call's elapsed / steps, ending in one synchronize",
        "tokens_per_s": tokens / (step_ms / 1e3),
        "step_flops": flops, "step_flops_are": "3 x op_forward_flops summed over the graph",
        "mfu": flops / (step_ms / 1e3) / PEAK_BF16, "peak_memory_bytes": peak,
        "loss_after_fit": loss, "accuracy": perf.accuracy, "perf": dataclasses.asdict(perf),
        "profiled_fit": {"host_ms_per_step": trace["host_ms"] / steps,
                         "kernel_ms_per_step": trace["kernel_ms"] / steps,
                         "idle_share": 1.0 - trace["kernel_ms"] / trace["host_ms"],
                         "flash_launches": trace["flash"],
                         "d256_kernel_ms_per_step": {k: v / steps
                                                     for k, v in trace["flash_ms"].items()},
                         "top_kernels": trace["top_kernels"]},
        "launches": launches, "launches_per_step_each": layers, "dense_attentions": 0,
    })
    del m
    torch.cuda.empty_cache()
    return {f"{n}@d256": launches[n] for n in FLASH_WRAPPERS}


FIT_BERT_RUN = {}  # fit_bert's step ms and MFU, printed beside fit_bert_dp's
BERT_DP_PARITY_STEPS = 2  # the first losses held against the single-device trainer's


def phase_fit_bert_dp(smi: str, steps: int = STEPS, cfg=None, device: str = "cuda"):
    """BERT-base (models.build_bert(BertConfig()): 12 heads of 256) trained
    by DataParallelTrainingInstance over the one-rank NCCL group, as
    train_dp trains the flagship: attention under flash_mesh on the
    per-head kernels at d=256 (rows 9-12). fit_bert's seeded host batches
    and SGD(0.01), bf16. First the same two batches through the
    single-device trainer (what FFModel compiles on one card, fit_bert's
    backend) and through the data-parallel one from the same parameters and
    Dropout generator: the losses within PARITY_BOUND, and each attention
    piece's two-step update (the seq-major d=256 kernels against the
    per-head ones, both bf16) within ZOO_BERT_UPDATE_BOUND, since at BERT's
    initial near-uniform output the loss alone barely moves. Then one warm-up
    step and `steps` timed ones with every launch count and the dense count
    set to 0 just before and read just after: each per-head wrapper 12
    times a step, no other flash or ring kernel, no dense attention; step
    ms and MFU beside fit_bert's of this run, and a profiled step."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import BertConfig, build_bert
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DataParallelTrainingInstance
    from flexflow_tpu_torch.pcg import SGDOptimizerAttrs

    bcfg = cfg or BertConfig()  # cfg, device: a CPU rehearsal at a small config
    b, seq, layers = bcfg.batch_size, bcfg.sequence_length, bcfg.num_encoder_layers
    graph, out = build_bert(bcfg)
    rng = np.random.default_rng(0)  # fit_bert's batches
    x = rng.standard_normal(((steps + 1) * b, seq, bcfg.hidden_size), dtype=np.float32)
    y = rng.integers(0, bcfg.vocab_size, ((steps + 1) * b, seq), dtype=np.int32)
    xs = [torch.from_numpy(x[i * b:(i + 1) * b]).to(device) for i in range(steps + 1)]
    ys = [torch.from_numpy(y[i * b:(i + 1) * b]).long().to(device) for i in range(steps + 1)]
    args = (graph, out, SparseCategoricalCrossEntropyLossAttrs(), SGDOptimizerAttrs(lr=0.01))

    def run(trainer, batches, timed=False):
        inst = trainer(*args, compute_dtype=torch.bfloat16, device=device)
        params, opt_state = inst.initialize(seed=0)
        init = {k: p.detach().to("cpu", torch.float32, copy=True)  # SGD steps in place
                for k, p in params.items()}
        gen = torch.Generator(device=device).manual_seed(0)
        losses, step_ms, updates = [], [], None
        for i in batches:
            if timed and i == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fa.reset_launch_counts()
                _reset_dense_attentions()
            start = time.perf_counter()
            params, opt_state, loss, _ = inst.train_step(params, opt_state, {"input": xs[i]},
                                                         ys[i], gen)
            losses.append(float(loss))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - start) * 1e3)
            if i == BERT_DP_PARITY_STEPS - 1:
                updates = _attention_updates(graph, init, params)
        return inst, params, opt_state, gen, losses, step_ms, updates

    _, _, _, _, single, _, single_updates = run(ModelTrainingInstance,
                                                range(BERT_DP_PARITY_STEPS))
    torch.cuda.empty_cache()
    inst, params, opt_state, gen, losses, step_ms, updates = run(
        DataParallelTrainingInstance, range(steps + 1), timed=True)
    launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    want = {n: layers * steps if n in BHSD_WRAPPERS else 0 for n in launches}
    if (device != "cpu" and launches != want) or _dense_attentions():
        raise AssertionError(f"fit_bert_dp: launches {launches}, expected {want}; "
                             f"{_dense_attentions()} dense attentions")
    rel = [abs(a - w) / abs(w) for a, w in zip(losses, single)]
    update_rel = {k: float(torch.linalg.norm(v - single_updates[k])
                           / torch.linalg.norm(single_updates[k])) for k, v in updates.items()}
    if (not all(math.isfinite(v) for v in losses) or not max(rel) < PARITY_BOUND
            or not max(update_rel.values()) < ZOO_BERT_UPDATE_BOUND):
        raise AssertionError(f"fit_bert_dp: losses {losses} against the single-device "
                             f"trainer's {single}; attention updates {update_rel}")
    trace = _profiled(lambda: inst.train_step(params, opt_state, {"input": xs[1]}, ys[1], gen))
    median_ms = statistics.median(step_ms[1:])
    flops = 3 * _graph_forward_flops(graph)
    emit({
        "phase": "fit_bert_dp", "card": smi, "head_dim": bcfg.dim_feedforward // bcfg.num_heads,
        "trainer": "DataParallelTrainingInstance", "world_size": 1, "backend": "nccl",
        "compute_dtype": "bf16", "optimizer": "sgd(lr=0.01)", "batch": b, "seq": seq,
        "losses": losses, "single_device_losses": single, "loss_rel_err": rel,
        "bound": PARITY_BOUND, "attention_update_rel_err": update_rel,
        "attention_update_bound": ZOO_BERT_UPDATE_BOUND, "warmup_step_ms": step_ms[0], "step_ms": step_ms[1:],
        "median_step_ms": median_ms, "tokens_per_s": b * seq / (median_ms / 1e3),
        "step_flops": flops, "mfu": flops / (median_ms / 1e3) / PEAK_BF16,
        "fit_bert": dict(FIT_BERT_RUN), "peak_memory_bytes": peak,
        "profiled_step": {"host_ms": trace["host_ms"], "kernel_ms": trace["kernel_ms"],
                          "idle_share": 1.0 - trace["kernel_ms"] / trace["host_ms"],
                          "flash_launches": trace["flash"], "nccl": trace["nccl"]},
        "launches": launches, "launches_per_step_each": layers, "dense_attentions": 0,
    })
    del inst, params, opt_state
    torch.cuda.empty_cache()
    return {f"{n}@d256": launches[n] for n in BHSD_WRAPPERS}


DP_WINDOW_K = 8
DP_WINDOW_WINDOWS = 2
DP_WINDOW_KERNELS = {  # what rows 9-11 launch, by the wrapper whose launches each counts
    "ff_flash_fwd_bhsd_kernel": "flash_fwd_bhsd", "ff_flash_delta_bhsd_kernel": "flash_delta_bhsd",
    "ff_flash_bwd_dkv_bhsd_kernel": "flash_bwd_bhsd",
    "ff_flash_bwd_dq_bhsd_kernel": "flash_bwd_bhsd",
}


def _profiled(fn) -> dict:
    """fn() under torch.profiler: host ms to its synchronized end, the card's
    kernel ms, each flash and ring kernel's launches, the NCCL kernels'."""
    import torch
    from torch.autograd import DeviceType
    from flexflow_tpu_torch.profile_step import device_trace

    torch.cuda.synchronize()
    with device_trace() as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"host_ms": host_ms,
            "kernel_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "flash": {e.key: e.count for e in kernels
                      if e.key.startswith(("ff_flash_", "ff_ring_"))},
            "nccl": {e.key[:80]: e.count for e in kernels if "nccl" in e.key.lower()}}


def phase_train_dp_window(smi: str, k: int = DP_WINDOW_K, windows: int = DP_WINDOW_WINDOWS):
    """The flagship through DataParallelTrainingInstance.multi_train_step on
    the one-rank NCCL group at K = k (bf16, Adam(1e-4)): the first window
    captures one CUDA graph, which each window replays; the capturing call
    issues every bucket's all-reduce through the NCCL group, in the warm-up
    and in the capture (at world size 1 NCCL runs no kernel for an in-place
    all-reduce, so what the graph holds of them shows only on several
    cards); `windows` windows from
    compile's parameters, bitwise equal to k * windows train_step calls (or
    within the window bounds, saying so); a third, profiled window whose
    trace counts rows 9-11's four kernels 96 times (12 layers x 8 steps)
    and no other flash or ring kernel: step ms, idle share, buckets."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels.optimizer import make_optimizer_state
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_cg
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DataParallelTrainingInstance
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    cfg, b = FLAGSHIP, FLAGSHIP["batch"]
    inst = DataParallelTrainingInstance(
        *build_flagship_cg(**cfg), SparseCategoricalCrossEntropyLossAttrs(),
        AdamOptimizerAttrs(alpha=1e-4), compute_dtype=torch.bfloat16)
    params, opt = inst.initialize(seed=0)
    init = {key: p.clone() for key, p in params.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = torch.randn(windows + 1, k, b, cfg["seq"], cfg["embed"], generator=gen, device="cuda")
    ys = torch.randint(0, cfg["vocab"], (windows + 1, k, b, cfg["seq"]), generator=gen,
                       device="cuda")
    rng = torch.Generator(device="cuda").manual_seed(0)
    before, losses = inst.all_reduces, []
    torch.cuda.synchronize()
    start = time.perf_counter()
    params, opt, rng, window_losses, _ = inst.multi_train_step(params, opt, {"x": xs[0]}, ys[0],
                                                               rng)
    losses.append(window_losses)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - start) * 1e3
    per_step = inst.step_collectives()["all_reduce"]
    captured_all_reduces = inst.all_reduces - before
    if captured_all_reduces != 2 * k * per_step or not inst.last_window["captured"]:
        raise AssertionError(f"train_dp_window: the capturing call issued {captured_all_reduces} "
                             f"all-reduces through NCCL (expected warm-up and capture, "
                             f"{2 * k * per_step}); window {inst.last_window}")
    buckets = _require_early_buckets("train_dp_window", inst.bucket_log)
    fa.reset_launch_counts()
    window_ms = []
    for w in range(1, windows):
        torch.cuda.synchronize()
        start = time.perf_counter()
        params, opt, rng, window_losses, _ = inst.multi_train_step(params, opt, {"x": xs[w]},
                                                                   ys[w], rng)
        losses.append(window_losses)
        torch.cuda.synchronize()
        window_ms.append((time.perf_counter() - start) * 1e3)
    counters = _flash_launches()
    if inst.graphs.captures != 1 or any(counters.values()) or inst.all_reduces != \
            before + captured_all_reduces:
        raise AssertionError(f"train_dp_window: {inst.graphs.captures} captures, wrapper counts "
                             f"{counters}, all-reduces issued by replays "
                             f"{inst.all_reduces - before - captured_all_reduces}")
    fitted, fitted_losses = {key: p.clone() for key, p in params.items()}, torch.cat(losses)
    trace = _profiled(lambda: inst.multi_train_step(params, opt, {"x": xs[windows]},
                                                    ys[windows], rng))
    want = {name: cfg["layers"] * k for name in DP_WINDOW_KERNELS}
    if trace["flash"] != want:
        raise AssertionError(f"train_dp_window: the trace of a window counts {trace['flash']}, "
                             f"expected {want}")
    capture_ms = inst.graphs.capture_ms[0]
    inst.graphs.invalidate()
    del params, opt
    torch.cuda.empty_cache()
    ref = {key: p.clone() for key, p in init.items()}
    ref_opt = make_optimizer_state(inst.optimizer_attrs, ref)
    ref_rng = torch.Generator(device="cuda").manual_seed(0)
    ref_losses = []
    for w in range(windows):
        for i in range(k):
            ref, ref_opt, loss, _ = inst.train_step(ref, ref_opt, {"x": xs[w, i]}, ys[w, i],
                                                    ref_rng)
            ref_losses.append(loss.reshape(1))
    parity = _window_parity("train_dp_window", fitted, ref, fitted_losses, torch.cat(ref_losses))
    step_ms = statistics.median(window_ms) / k
    flops = inst.step_flops()
    emit({"phase": "train_dp_window", "config": cfg, "card": smi, "world_size": 1,
          "backend": "nccl", "compute_dtype": "bf16", "optimizer": "adam(alpha=1e-4)",
          "steps_per_dispatch": k, "windows": windows, "captures": inst.graphs.captures,
          "capture_ms": capture_ms, "first_window_ms": first_ms, "window_ms": window_ms,
          "step_ms": step_ms, "tokens_per_s": b * cfg["seq"] / (step_ms / 1e3),
          "step_flops": flops, "mfu": _mfu(flops, step_ms, 1),
          "gradient_buckets": len(inst.buckets), "all_reduces_per_step": per_step,
          "nccl_all_reduces_issued_capturing": captured_all_reduces,
          "profiled_window": {"host_ms": trace["host_ms"], "kernel_ms": trace["kernel_ms"],
                              "idle_share": 1.0 - trace["kernel_ms"] / trace["host_ms"],
                              "nccl_kernels": trace["nccl"]},
          "launches_per_window": trace["flash"], "equal_to_train_step": parity,
          "last_losses": fitted_losses[-2:].tolist(), **buckets})
    del inst, fitted, ref, ref_opt, xs, ys
    torch.cuda.empty_cache()
    # the profiled window's launches (the timed replays run no wrapper and
    # are not traced)
    return {wrapper: trace["flash"][name] for name, wrapper in DP_WINDOW_KERNELS.items()
            if wrapper != "flash_bwd_bhsd" or name.endswith("dq_bhsd_kernel")}


# -- several ranks sharing the card ------------------------------------------

SHARED = "ranks sharing one H100 over gloo (host-staged collectives)"
FLAGSHIP_WIDTHS = dict(seq=512, embed=1024, heads=8, layers=12, vocab=32000)
TP_PARITY = dict(batch=8, seq=128, embed=256, heads=4, layers=2, vocab=512)
TP_PARITY_PLANS = {"tp2": (2, (1, 2)), "dp2xtp2": (4, (2, 2))}  # name: (ranks, (dp, tp))
TP_TRAIN = dict(FLAGSHIP_WIDTHS, batch=16)  # batch 16: gloo stages every collective on the host
TP_STEPS = 3  # timed Adam steps of train_tp, after one warm-up step
# train_tp's gathered parameters against the single-device train_step from
# the same values (both bf16): the difference over how far the parameters
# moved, each tensor; the two sum the tensor-parallel partials in another
# order and run other attention kernels (rows 9-11 against rows 1-3), and
# Adam's first steps move a near-zero gradient's element by about alpha
# whichever way its sign falls. On an H100 the worst tensor measured 0.078
# (a LayerNorm bias) and the median 0.027 (PERF.md section 6)
TP_PARAM_BOUND = 0.2
# the flagship's widths at batch 16 and 10 layers, cut from the flagship's 12
# to keep the whole script near its time: the search for 2 cards picks dp2
# over the serial plan by a clear margin there (13.348 against 14.544 ms at
# 12 layers, 10.201 against 10.272 at 8: a 0.7% margin a small change to
# the cost model would flip; at 6 layers it keeps the serial plan)
FIT_SEARCHED = dict(FLAGSHIP_WIDTHS, layers=10, batch=16)
FIT_SEARCHED_STEPS = 3
RANK_TIMEOUT_S = 300

# One rank of a multi-rank phase; argv: rank, world, job (JSON). The ranks
# share the job's device over an explicit gloo group; each writes its result
# to <out>.rank<r>.json.
RANK_WORKER = r'''
import json, math, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from flexflow_tpu_torch.compiler.unity_algorithm import data_parallel_seed, tensor_parallel_seed
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.models import build_flagship_cg, build_flagship_pcg
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs, WeightAttrs
from flexflow_tpu_torch.parallel import (DistributedTrainingInstance, MachineMesh, executor,
                                         gather_block, init_file_group)
from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

rank, world, job = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
device = init_file_group(job["store"], rank, world, device=job["device"], backend="gloo")
dtype = torch.bfloat16 if device.type == "cuda" else None
cfg = job["cfg"]
heads = []
flash = executor.sharded_flash_attention
executor.sharded_flash_attention = lambda q, k, v: heads.append(q.shape[1]) or flash(q, k, v)
out = {"rank": rank}


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launches():
    return {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}


def batch(samples):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(samples, cfg["seq"], cfg["embed"], generator=gen)
    return x, torch.randint(0, cfg["vocab"], (samples, cfg["seq"]), generator=gen)


def plan_pcg(dp, tp):
    pcg = build_flagship_pcg(**cfg)
    if tp > 1:
        pcg = tensor_parallel_seed(pcg, tp)
    if dp > 1:
        pcg = data_parallel_seed(pcg, dp)
    return pcg


def by_name(pcg, inst, params):
    """Copies of the global values of the pieces, by weight name (a
    collective)."""
    return {pcg.layer_attrs(n).name: gather_block(params[f"n{n.idx}"].detach(),
                                                  inst.weight_sharding(f"n{n.idx}"),
                                                  inst.machine_mesh).float().cpu().clone()
            for n in pcg.topological_ordering() if isinstance(pcg.op_attrs(n), WeightAttrs)}


def train(pcg, on, compute, warmup, steps, keep=False):
    mesh = MachineMesh.for_devices(world)
    inst = DistributedTrainingInstance(
        pcg, pcg.outputs_of(pcg.topological_ordering()[-1])[0],
        SparseCategoricalCrossEntropyLossAttrs(), AdamOptimizerAttrs(alpha=job["alpha"]), mesh,
        compute_dtype=compute, device=on)
    params, opt = inst.initialize(seed=0)
    init = by_name(pcg, inst, params) if keep else None
    x, y = (t.to(on) for t in batch(cfg["batch"]))
    for _ in range(warmup):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
    sync()
    fa.reset_launch_counts()
    heads.clear()
    losses, step_ms, per_step = [], [], []
    for _ in range(steps):
        before = dict(inst.collectives)
        start = time.perf_counter()
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
        losses.append(float(loss))
        sync()
        step_ms.append((time.perf_counter() - start) * 1e3)
        per_step.append({k: v - before.get(k, 0) for k, v in inst.collectives.items()})
    res = dict(losses=losses, step_ms=step_ms, launches=launches(), local_heads=sorted(set(heads)),
               flash_calls=len(heads), collectives_per_step=per_step,
               implied=dict(inst.step_collectives()), buckets=bucket_stats(inst),
               step_flops=inst.step_flops())
    return res, (init, by_name(pcg, inst, params)) if keep else None


def bucket_stats(inst):
    """The gradient buckets a step issued, and of them those issued before
    the backward produced its last gradient, per step so far."""
    return [list(b) for b in inst.bucket_log]


def windowed_fit(cfg, k, steps, **kw):
    """FFModel over the ranks at steps_per_dispatch=k, fit on `steps`
    seeded batches, unshuffled: every step's loss, the parameters (the
    rank's pieces), each window's stats, the buckets, the launches."""
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(steps * cfg["batch"], cfg["seq"], cfg["embed"], generator=gen)
    y = torch.randint(0, cfg["vocab"], (steps * cfg["batch"], cfg["seq"]), generator=gen)
    m = FFModel.from_computation_graph(
        *build_flagship_cg(**cfg), device=device,
        config=FFConfig(batch_size=cfg["batch"], seed=0, print_freq=0, steps_per_dispatch=k,
                        **kw))
    m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy",
              metrics=["accuracy"], compute_dtype=dtype)
    inst = m.instance
    losses, windows = [], []
    step, multi = inst.train_step, inst.multi_train_step

    def stepped(*a, **kw):
        res = step(*a, **kw)
        losses.append(res[2].float().reshape(1))
        return res

    def windowed(*a, **kw):
        res = multi(*a, **kw)
        windows.append(dict(inst.last_window))
        return res

    inst.train_step, inst.multi_train_step = stepped, windowed
    fa.reset_launch_counts()
    sync()
    start = time.perf_counter()
    m.fit(x.numpy(), y.numpy().astype(np.int32), epochs=1, shuffle=False, verbose=False)
    sync()
    fit_ms = (time.perf_counter() - start) * 1e3
    del inst.train_step, inst.multi_train_step
    return dict(model=m, losses=torch.cat(losses).cpu(), windows=windows, fit_ms=fit_ms,
                step_ms=fit_ms / steps, launches=launches(), buckets=bucket_stats(inst),
                buckets_in_plan=len(inst.buckets) if hasattr(inst, "buckets") else sum(
                    1 for axes, _ in inst.plan.buckets if inst.machine_mesh.size(axes) > 1),
                kind=type(inst).__name__, step_flops=inst.step_flops())


def fit_windows():
    """parity_ranks_window: K = job["k"] against K = 1, data parallel (the
    small flagship, the bucket cap at job["dp_cap"] so that its gradients
    make several buckets) and the imported fit_searched plan."""
    from flexflow_tpu_torch.parallel import collectives as C

    res = {}
    for case, cfg, kw in (("dp", job["dp_cfg"], dict(only_data_parallel=True)),
                          ("imported", job["plan_cfg"],
                           dict(search_budget=2, import_strategy_file=job["strategy"]))):
        cap = C.BUCKET_CAP_BYTES
        if case == "dp":
            C.BUCKET_CAP_BYTES = job["dp_cap"]
        runs = {k: windowed_fit(cfg, k, job["steps"], **kw) for k in (1, job["k"])}
        C.BUCKET_CAP_BYTES = cap
        one, fused = runs[1], runs[job["k"]]
        bitwise = bool(torch.equal(one["losses"], fused["losses"]) and all(
            torch.equal(p, fused["model"].params[key]) for key, p in one["model"].params.items()))
        res[case] = dict(
            bitwise=bitwise, losses=one["losses"].tolist(), kind=fused["kind"],
            windows=fused["windows"], per_step_windows=one["windows"],
            step_ms={k: r["step_ms"] for k, r in runs.items()},
            launches={k: r["launches"] for k, r in runs.items()},
            buckets=fused["buckets"], buckets_in_plan=fused["buckets_in_plan"],
            step_flops=fused["step_flops"])
        del runs, one, fused
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def calibrate_and_fit(fit_it=True):
    """calibrate_ranks: the calibration over every rank, whether the ranks
    share a device, then (fit_it) a compile with cost_model="calibrated"
    at the flagship's widths and its fit of two steps."""
    from flexflow_tpu_torch.compiler.calibration import get_calibration
    from flexflow_tpu_torch.runtime.distributed import ranks_share_a_device

    start = time.perf_counter()
    cal = get_calibration(device, world)
    res = dict(calibration=cal.as_dict(), seconds=time.perf_counter() - start,
               raw=dict(allreduce={k: [c.lat_ms, c.gbps] for k, c in cal.allreduce.items()},
                        overlap=cal.overlap, shard_speedup=cal.shard_speedup),
               emulated_mesh=ranks_share_a_device(device))
    if fit_it:
        run = windowed_fit(job["plan_cfg"], 1, 2, search_budget=2, cost_model="calibrated")
        prov = run["model"].search_provenance
        res.update(provenance={k: prov[k] for k in ("parallel_degrees", "estimated_ms",
                                                     "serial_ms", "seed_runtimes",
                                                     "emulated_mesh", "search_seconds")},
                   losses=run["losses"].tolist(), launches=run["launches"],
                   step_ms=run["step_ms"], buckets=run["buckets"], kind=run["kind"],
                   step_flops=run["step_flops"])
        del run
    return res


def overlap_sites():
    """parity_overlap: a Linear fed by a Combine (ag_matmul) and a row
    Linear feeding a Reduction (matmul_rs), degree = the ranks, through
    DistributedTrainingInstance with and without the overlap lowering on
    the same parameters (bf16): the forwards, each one's ring steps, a
    train step's loss and collectives."""
    from flexflow_tpu_torch.op_attrs.datatype import DataType
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
        ParallelTensorDims, ParallelTensorShape, ShardParallelDim)
    from flexflow_tpu_torch.pcg import SGDOptimizerAttrs
    from flexflow_tpu_torch.pcg.parallel_computation_graph_builder import (
        ParallelComputationGraphBuilder)

    rows, depth, width = job["overlap_shape"]
    res = {}
    for kind in ("ag_matmul", "matmul_rs"):
        b = ParallelComputationGraphBuilder()
        degrees = (world, 1) if kind == "ag_matmul" else (1, world)
        x = b.create_input_tensor(ParallelTensorShape(ParallelTensorDims(
            (ShardParallelDim(rows, degrees[0]), ShardParallelDim(depth, degrees[1])), 1, 1),
            DataType.FLOAT), name="x")
        if kind == "ag_matmul":
            logits = b.dense(b.parallel_combine(x, 0, world), width, use_bias=False, name="head")
        else:
            logits = b.parallel_reduce(b.dense(x, width, use_bias=False, name="fc"), world)
        gen = torch.Generator().manual_seed(2)
        xv = torch.randn(rows, depth, generator=gen)
        yv = torch.randint(0, width, (rows,), generator=gen)
        mesh = MachineMesh.for_devices(world)
        got = {}
        for overlap in (False, True):
            inst = DistributedTrainingInstance(
                b.graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                SGDOptimizerAttrs(lr=0.1), mesh, compute_dtype=torch.bfloat16, device=device,
                overlap=overlap)
            params, opt = inst.initialize(seed=0)
            before = mesh.counts["ring_step"]
            fwd = inst.forward({k: p.bfloat16() for k, p in params.items()},
                               {"x": xv.bfloat16()})
            ring = mesh.counts["ring_step"] - before
            counts = dict(mesh.counts)
            params, opt, loss, _ = inst.train_step(params, opt, {"x": xv}, yv)
            step = {c: v - counts.get(c, 0) for c, v in mesh.counts.items()
                    if v - counts.get(c, 0)}
            got[overlap] = dict(fwd=fwd.float().cpu(), ring=ring, loss=float(loss), step=step,
                                implied=dict(inst.step_collectives()),
                                fused=sorted(inst.fused_sites.values()))
        serial, fused = got[False], got[True]
        diff = (fused["fwd"] - serial["fwd"]).abs()
        res[kind] = dict(
            max_abs_err=float(diff.max()),
            max_rel_err=float((diff / serial["fwd"].abs().clamp_min(1e-30)).max()),
            within=bool(torch.allclose(fused["fwd"], serial["fwd"], rtol=job["bf16_tol"][kind][0],
                                       atol=job["bf16_tol"][kind][1])),
            ring_steps=fused["ring"], serial_ring_steps=serial["ring"],
            fused=fused["fused"], losses=[serial["loss"], fused["loss"]],
            step=fused["step"], implied=fused["implied"], serial_step=serial["step"])
    return res


def overlap_and_rules():
    """fit_overlap: searched compiles (analytic, on the H100 constants) of
    the wide MLP with overlap off and on, the same plan, trained the same
    steps from the same initial values (bf16): the losses, how far the
    fused run's parameters are from the serial run's, the fused sites, the
    ring steps a step, the search's overlap pricing and the audit's fused
    edges; then the small flagship with the fusion rules and the legacy
    rule file, trained: its losses and rows 9-11's launches."""
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.interop import pcg_params_to_numpy

    w, steps = job["mlp"], job["steps"]
    gen = torch.Generator().manual_seed(2)
    xs = torch.randn(steps * w["batch"], w["d"], generator=gen).numpy()
    ys = torch.randint(0, w["d"], (steps * w["batch"],), generator=gen).numpy().astype(np.int32)
    res, finals, initial, logits = {}, {}, {}, {}

    def recorded(m, losses):
        step = m.instance.train_step

        def rec(*a, **k):
            r = step(*a, **k)
            losses.append(float(r[2]))
            return r

        m.instance.train_step = rec

    for overlap in (False, True):
        m = FFModel(FFConfig(batch_size=w["batch"], seed=0, print_freq=0, search_budget=2,
                             cost_model="analytic", overlap=overlap, plan_audit=overlap),
                    device=device)
        x = m.create_tensor([w["batch"], w["d"]], name="x")
        m.dense(m.relu(m.dense(x, w["h"], use_bias=False, name="fc1")), w["d"],
                use_bias=False, name="out")
        start = time.perf_counter()
        m.compile(SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", compute_dtype=dtype)
        compile_s = time.perf_counter() - start
        inst, losses = m.instance, []
        initial[overlap] = pcg_params_to_numpy(inst.pcg, inst.shardings, inst.machine_mesh,
                                               m.params)
        first = torch.from_numpy(xs[:w["batch"]]).to(dtype or torch.float32)
        logits[overlap] = inst.forward({k: p.to(first.dtype) for k, p in m.params.items()},
                                       {"x": first}).float().cpu()
        recorded(m, losses)
        ring0 = inst.machine_mesh.counts["ring_step"]
        sync()
        start = time.perf_counter()
        m.fit(xs, ys, epochs=1, shuffle=False, verbose=False)
        sync()
        fit_ms = (time.perf_counter() - start) * 1e3
        finals[overlap] = pcg_params_to_numpy(inst.pcg, inst.shardings, inst.machine_mesh,
                                              m.params)
        res["fused" if overlap else "serial"] = dict(
            compile_s=compile_s, step_ms=fit_ms / steps, losses=losses,
            fused=sorted(inst.fused_sites.values()),
            ring_steps_per_step=(inst.machine_mesh.counts["ring_step"] - ring0) / steps,
            provenance=m.search_provenance)
    res["param_rel_diff"] = {
        k: float(np.linalg.norm(finals[True][k] - v) / max(np.linalg.norm(v), 1e-30))
        for k, v in finals[False].items()}
    # each parameter's change over the fit, fused against serial (from the
    # same initial values), relative to the serial run's change
    res["update_rel_diff"] = {
        k: float(np.linalg.norm((finals[True][k] - initial[True][k]) - (v - initial[False][k]))
                 / max(np.linalg.norm(v - initial[False][k]), 1e-30))
        for k, v in finals[False].items()}
    res["initial_equal"] = all(np.array_equal(initial[True][k], v)
                               for k, v in initial[False].items())
    res["logits_rel_diff"] = float((logits[True] - logits[False]).norm()
                                   / logits[False].norm().clamp_min(1e-30))
    rx, ry = batch(job["rules_steps"] * cfg["batch"])
    m = FFModel.from_computation_graph(
        *build_flagship_cg(**cfg), device=device,
        config=FFConfig(batch_size=cfg["batch"], seed=0, print_freq=0, search_budget=2,
                        cost_model="analytic", perform_fusion=True,
                        substitution_json_path=job["rules_file"]))
    m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy",
              compute_dtype=dtype)
    losses = []
    recorded(m, losses)
    fa.reset_launch_counts()
    m.fit(rx.numpy(), ry.numpy().astype(np.int32), epochs=1, shuffle=False, verbose=False)
    sync()
    res["rules"] = dict(losses=losses, launches=launches(), provenance=m.search_provenance)
    return res


def resume_ranks():
    """resume_ranks: FFModel over the ranks under the forced plan
    job["seed"] at steps_per_dispatch job["k"], checkpointing every
    job["every"] steps: an uninterrupted fit, a fit killed by
    FF_TPU_FAULT_STEP, a new FFModel resuming it; every step's loss, the
    final state (gathered, a collective) bitwise against the uninterrupted
    one, this rank's writer and snapshots, the launches of the killed and
    resumed fits; the resumed model saves the final checkpoint (rank 0
    writes) and rank 0 its final state for the single-device restore."""
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.runtime.chaos import final_state, states_bitwise
    from flexflow_tpu_torch.runtime.fault import SimulatedFault

    gen = torch.Generator().manual_seed(1)
    n = job["batches"] * cfg["batch"]
    x = torch.randn(n, cfg["seq"], cfg["embed"], generator=gen).numpy()
    y = torch.randint(0, cfg["vocab"], (n, cfg["seq"]), generator=gen).numpy().astype(np.int32)

    def fit(cdir, **kw):
        m = FFModel.from_computation_graph(
            *build_flagship_cg(**cfg), device=device,
            config=FFConfig(batch_size=cfg["batch"], seed=0, print_freq=0,
                            steps_per_dispatch=job["k"], search_budget=2,
                            force_strategy_seed=job["seed"], checkpoint_dir=cdir,
                            checkpoint_every_n_steps=job["every"]))
        m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy",
                  metrics=["accuracy"], compute_dtype=dtype)
        losses, step = [], m.instance.train_step

        def recorded(*a, **k):  # gloo: the windows run their steps eagerly
            res = step(*a, **k)
            losses.append(float(res[2]))
            return res

        m.instance.train_step = recorded
        try:
            m.fit(x, y, epochs=job["epochs"], shuffle=True, verbose=False, **kw)
            outcome = "completed"
        except SimulatedFault:
            outcome = "SimulatedFault"
        del m.instance.train_step
        return m, losses, outcome

    start = time.perf_counter()
    ref, ref_losses, _ = fit(os.path.join(job["work"], "ref"))
    ref_state = final_state(ref)
    del ref
    fa.reset_launch_counts()
    cdir = os.path.join(job["work"], "killed")
    os.environ["FF_TPU_FAULT_STEP"] = str(job["fault_step"])
    killed, first, outcome = fit(cdir)
    del os.environ["FF_TPU_FAULT_STEP"]
    ck = killed.checkpointer
    writes = dict(writer=ck.writer is not None, snapshots=[r["step"] for r in ck.stats])
    del killed
    resumed, second, _ = fit(cdir, resume=True)
    sync()
    counts = launches()
    state = final_state(resumed)
    params_ok, opt_ok = states_bitwise(state, ref_state)
    resumed.save_checkpoint(os.path.join(job["work"], "final"))
    if rank == 0:
        np.savez(os.path.join(job["work"], "final_params.npz"), **state[0])
    return dict(outcome=outcome, writes=writes, bitwise=[params_ok, opt_ok],
                losses=dict(ref=ref_losses, killed=first, resumed=second),
                steps=resumed._step_count, kind=type(resumed.instance).__name__,
                plan=resumed.search_provenance.get("parallel_degrees"),
                card=dict(launches=counts), seconds=time.perf_counter() - start)


if job["mode"] == "parity":
    pcg = plan_pcg(*job["plan"])
    out["cpu"] = train(pcg, "cpu", None, 0, 2)[0]
    out["card"] = train(pcg, device, dtype, 0, 2)[0]
elif job["mode"] == "train":
    pcg = plan_pcg(*job["plan"])
    out["card"], (init, final) = train(pcg, device, dtype, 1, job["steps"], keep=True)
    if rank == 0:
        # the single-device step from the same values, on the same card
        from flexflow_tpu_torch.interop import params_from_numpy
        from flexflow_tpu_torch.local_execution import ModelTrainingInstance
        from flexflow_tpu_torch.local_execution.training_backing import weight_nodes
        graph, logits = build_flagship_cg(**cfg)
        names = {f"n{n.idx}": graph.layer_attrs(n).name for n in weight_nodes(graph)}
        single = ModelTrainingInstance(graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                       AdamOptimizerAttrs(alpha=job["alpha"]),
                                       compute_dtype=dtype, device=device)
        params = params_from_numpy(graph, {k: init[v].numpy() for k, v in names.items()}, device)
        opt = single.initialize(seed=0)[1]
        x, y = (t.to(device) for t in batch(cfg["batch"]))
        losses, step_ms = [], []
        for _ in range(1 + job["steps"]):
            start = time.perf_counter()
            params, opt, loss, _ = single.train_step(params, opt, {"x": x}, y)
            losses.append(float(loss))
            sync()
            step_ms.append((time.perf_counter() - start) * 1e3)
        out["single_losses"], out["single_step_ms"] = losses[1:], step_ms[1:]
        out["param_rel"] = {
            v: float((final[v] - params[k].float().cpu()).norm()
                     / max(float((params[k].float().cpu() - init[v]).norm()), 1e-30))
            for k, v in names.items()}
elif job["mode"] == "fit":
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel

    x, y = batch(job["steps"] * cfg["batch"])

    def fit(**kw):
        m = FFModel.from_computation_graph(
            *build_flagship_cg(**cfg), device=device,
            config=FFConfig(batch_size=cfg["batch"], seed=0, print_freq=0,
                            search_budget=job["budget"], **kw))
        start = time.perf_counter()
        m.compile(AdamOptimizer(alpha=job["alpha"]), "sparse_categorical_crossentropy",
                  metrics=["accuracy"], compute_dtype=dtype)
        compile_s = time.perf_counter() - start
        losses, step = [], m.instance.train_step

        def recorded(*a, **k):
            res = step(*a, **k)
            losses.append(float(res[2]))
            return res

        m.instance.train_step = recorded
        inst = m.instance
        before = dict(inst.collectives)
        fa.reset_launch_counts()
        heads.clear()
        sync()
        start = time.perf_counter()
        perf = m.fit(x.numpy(), y.numpy().astype(np.int32), epochs=1, shuffle=False,
                     verbose=False)
        sync()
        fit_ms = (time.perf_counter() - start) * 1e3
        steps = len(losses)
        return dict(compile_s=compile_s, fit_ms=fit_ms, step_ms=fit_ms / steps, losses=losses,
                    train_all=perf.train_all, provenance=m.search_provenance,
                    launches=launches(), local_heads=sorted(set(heads)),
                    collectives_per_step={k: (v - before.get(k, 0)) / steps
                                          for k, v in inst.collectives.items()},
                    implied=dict(inst.step_collectives()), buckets=bucket_stats(inst),
                    step_flops=inst.step_flops(),
                    digest=float(sum(p.double().sum() for p in m.params.values())))

    def drift_runs():
        """The drift monitor over this job's ranks: the small flagship
        under the forced tp2 plan (analytic pricing), per step, with
        metrics_dir and drift_monitor, once with the `slow` site firing at
        every step after drift_late and once without; rank 0 writes the
        stream and runs the monitor."""
        from flexflow_tpu_torch.observability.metrics import read_events
        from flexflow_tpu_torch.runtime import fault

        class LateSchedule(fault.FaultSchedule):
            """`slow` at every step after drift_late, none before."""

            def should_fire(self, site, step):
                return step > job["drift_late"] and super().should_fire(site, step)

        dcfg, steps = job["drift_cfg"], job["drift_steps"]
        gen = torch.Generator().manual_seed(1)
        dx = torch.randn(steps * dcfg["batch"], dcfg["seq"], dcfg["embed"], generator=gen)
        dy = torch.randint(0, dcfg["vocab"], (steps * dcfg["batch"], dcfg["seq"]), generator=gen)
        os.environ[fault.SLOW_MS_ENV] = str(job["drift_slow_ms"])
        res = {}
        for name, slow in (("slow", True), ("steady", False)):
            mdir = os.path.join(os.path.dirname(job["out"]), f"drift_{name}")
            m = FFModel.from_computation_graph(
                *build_flagship_cg(**dcfg), device=device,
                config=FFConfig(batch_size=dcfg["batch"], seed=0, print_freq=0,
                                search_budget=2, force_strategy_seed="dp1xtp2xsp1",
                                cost_model="analytic", metrics_dir=mdir, drift_monitor=True,
                                **job["drift"]))
            m.compile(AdamOptimizer(alpha=job["alpha"]), "sparse_categorical_crossentropy",
                      compute_dtype=dtype)
            if slow:
                fault.install_schedule(LateSchedule(seed=0, sites=frozenset({"slow"}), rate=1.0))
            try:
                m.fit(dx.numpy(), dy.numpy().astype(np.int32), epochs=1, shuffle=False,
                      verbose=False)
            finally:
                fault.install_schedule(None)
            res[name] = dict(steps=m._step_count,
                             estimated_ms=m.search_provenance["estimated_ms"])
            if rank == 0:
                events = read_events(mdir)
                res[name].update(
                    drift_events=[e for e in events if e.get("event") == "drift"],
                    step_ms=[e["wallclock_ms"] for e in events if "event" not in e],
                    report=m.search_provenance.get("drift"))
        return res

    out["searched"] = fit(export_strategy_file=job["strategy"], plan_audit=True)
    out["imported"] = fit(import_strategy_file=job["strategy"])
    if "drift" in job:
        out["drift"] = drift_runs()
elif job["mode"] == "windows":
    out["windows"] = fit_windows()
    out["calibrate"] = calibrate_and_fit()
    out["overlap"] = overlap_sites()
elif job["mode"] == "calibrate_overlap":
    out["calibrate"] = calibrate_and_fit(fit_it=False)
    out["overlap"] = overlap_sites()
elif job["mode"] == "resume":
    out["resume"] = resume_ranks()
elif job["mode"] == "overlap":
    out.update(overlap_and_rules())
with open(f"{job['out']}.rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def run_ranks(world: int, job: dict, tmp: str, worker: str = RANK_WORKER,
              timeout: float = RANK_TIMEOUT_S):
    """Run `worker` (RANK_WORKER unless given) on `world` processes and
    return each rank's result; a failing rank, or one still running after
    `timeout` seconds, fails the phase, and every process is stopped on the
    way out."""
    job = dict(job, store=os.path.join(tmp, f"store_{job['name']}"),
               out=os.path.join(tmp, job["name"]))
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r), str(world),
                               json.dumps(job)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        errors = []
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}: {err[-3000:]}")
        if errors:
            raise AssertionError(f"{job['name']}: " + "\n".join(errors))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(world):
        with open(f"{job['out']}.rank{r}.json") as f:
            results.append(json.load(f))
    return results


def _check_rank_launches(phase: str, ranks, layers: int, steps: int, key: str = "card"):
    """Rows 9-11 (the per-head wrappers) launch once per layer per step on
    every rank, and no other flash or ring kernel; returns the launches
    summed over the ranks."""
    total = {}
    for r in ranks:
        got = r[key]["launches"]
        want = {name: layers * steps if name in BHSD_WRAPPERS else 0 for name in got}
        if got != want:
            raise AssertionError(f"{phase} rank {r['rank']}: launches {got}, expected {want}")
        for name, n in got.items():
            total[name] = total.get(name, 0) + n
    return total


def _check_collectives(phase: str, ranks, key: str = "card"):
    """Every step of every rank issues the collectives the plan implies."""
    for r in ranks:
        steps = r[key]["collectives_per_step"]
        steps = steps if isinstance(steps, list) else [steps]
        for s in steps:
            if {k: v for k, v in s.items() if v} != r[key]["implied"]:
                raise AssertionError(f"{phase} rank {r['rank']}: collectives {s}, the plan "
                                     f"implies {r[key]['implied']}")


def phase_parity_tp(smi: str, tmp: str, device: str = "cuda:0") -> dict:
    """The small flagship (4 heads of 64) under the tp2 seed on 2 ranks and
    the dp2 x tp2 seed on 4, all sharing the card over gloo (bf16, the
    per-head kernels at the local head count), against the same plan on the
    same ranks on the CPU (f32, plain versions): two Adam steps' losses."""
    launches = {}
    for name, (world, plan) in TP_PARITY_PLANS.items():
        ranks = run_ranks(world, dict(name=f"parity_{name}", mode="parity", plan=plan,
                                      cfg=TP_PARITY, device=device, alpha=1e-3), tmp)
        counts = _check_rank_launches(f"parity_tp {name}", ranks, TP_PARITY["layers"], 2)
        for name_, n in counts.items():
            launches[name_] = launches.get(name_, 0) + n
        _check_collectives(f"parity_tp {name}", ranks)
        local = TP_PARITY["heads"] // plan[1]
        for r in ranks:
            if r["card"]["local_heads"] != [local]:
                raise AssertionError(f"parity_tp {name} rank {r['rank']}: attention ran at "
                                     f"{r['card']['local_heads']} heads, not {local}")
            if r["card"]["losses"] != ranks[0]["card"]["losses"]:
                raise AssertionError(f"parity_tp {name}: ranks report different losses")
        cpu, card = ranks[0]["cpu"]["losses"], ranks[0]["card"]["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
        if not max(rel) < PARITY_BOUND:
            raise AssertionError(f"parity_tp {name}: card losses {card} vs CPU {cpu}")
        first = ranks[0]["card"]
        emit({"phase": "parity_tp", "plan": name, "ranks": world, "sharing": f"{world} {SHARED}",
              "card": smi, "config": TP_PARITY, "losses": {"cuda": card, "cpu": cpu},
              "rel_err": rel, "bound": PARITY_BOUND, "local_heads": local,
              "launches_per_rank": first["launches"],
              "collectives_per_step": first["implied"],
              "card_step_ms": first["step_ms"],
              "mfu": [_mfu(first["step_flops"], ms, world) for ms in first["step_ms"]],
              **_require_early_buckets(f"parity_tp {name}", first["buckets"])})
    return launches


def phase_train_tp(smi: str, tmp: str, device: str = "cuda:0") -> dict:
    """The flagship at full width and depth (batch 16) under the tp2 seed on
    2 ranks sharing the card: one warm-up and TP_STEPS timed Adam steps in
    bf16; the gathered parameters against the single-device train_step from
    the same values on the card."""
    from flexflow_tpu_torch.models import model_step_flops

    ranks = run_ranks(2, dict(name="train_tp", mode="train", plan=(1, 2), cfg=TP_TRAIN,
                              device=device, alpha=1e-4, steps=TP_STEPS), tmp)
    launches = _check_rank_launches("train_tp", ranks, TP_TRAIN["layers"], TP_STEPS)
    _check_collectives("train_tp", ranks)
    card = ranks[0]["card"]
    if not all(math.isfinite(v) for v in card["losses"]):
        raise AssertionError(f"train_tp: non-finite losses {card['losses']}")
    if card["local_heads"] != [TP_TRAIN["heads"] // 2]:
        raise AssertionError(f"train_tp: attention ran at {card['local_heads']} heads")
    single = ranks[0]["single_losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"], single)]
    worst = max(ranks[0]["param_rel"].items(), key=lambda kv: kv[1])
    if not max(rel) < PARITY_BOUND or not worst[1] < TP_PARAM_BOUND:
        raise AssertionError(f"train_tp: losses {card['losses']} vs single-device {single}, "
                             f"worst parameter {worst} (bound {TP_PARAM_BOUND})")
    median_ms = statistics.median(card["step_ms"])
    emit({"phase": "train_tp", "plan": "tp2", "ranks": 2, "sharing": f"2 {SHARED}", "card": smi,
          "config": TP_TRAIN, "compute_dtype": "bf16", "optimizer": "adam(alpha=1e-4)",
          "losses": card["losses"], "single_device_losses": single, "loss_rel_err": rel,
          "single_device_step_ms": ranks[0]["single_step_ms"],
          "param_rel_to_moved": ranks[0]["param_rel"], "param_bound": TP_PARAM_BOUND,
          "step_ms": card["step_ms"], "median_step_ms": median_ms,
          "tokens_per_s": TP_TRAIN["batch"] * TP_TRAIN["seq"] / (median_ms / 1e3),
          "step_flops": model_step_flops(**TP_TRAIN),
          "collectives_per_step": card["implied"], "launches_per_rank": card["launches"],
          "local_heads": card["local_heads"], "mfu": _mfu(card["step_flops"], median_ms, 2),
          **_require_early_buckets("train_tp", card["buckets"]),
          "note": "step times measure host-staged gloo collectives of two processes on one "
                  "card, not NVLink or NCCL"})
    return launches


def phase_fit_searched(smi: str, tmp: str, device: str = "cuda:0") -> dict:
    """FFModel.compile(search_budget=2) on 2 ranks sharing the card at the
    flagship's widths at 10 layers (batch 16): rank 0 searches on the H100
    constants, every rank trains the winner, which must be a parallel plan;
    rank 0 exports the strategy and a second compile that imports it
    trains to bitwise-equal losses."""
    ranks = run_ranks(2, dict(name="fit_searched", mode="fit", cfg=FIT_SEARCHED, device=device,
                              alpha=1e-4, steps=FIT_SEARCHED_STEPS, budget=2,
                              strategy=os.path.join(tmp, "fit_searched_strategy.json"),
                              drift=DRIFT, drift_cfg=DRIFT_CFG, drift_steps=DRIFT_STEPS,
                              drift_late=DRIFT_LATE, drift_slow_ms=DRIFT_SLOW_MS), tmp)
    launches = _check_rank_launches("fit_searched", ranks, FIT_SEARCHED["layers"],
                                    FIT_SEARCHED_STEPS, key="searched")
    _check_collectives("fit_searched", ranks, key="searched")
    first = ranks[0]["searched"]
    for r in ranks:
        a, b = r["searched"], r["imported"]
        if not (a["losses"] == b["losses"] and a["digest"] == b["digest"]):
            raise AssertionError(f"fit_searched rank {r['rank']}: the imported plan trained to "
                                 f"{b['losses']}, the searched one to {a['losses']}")
        if a["provenance"]["parallel_degrees"] != first["provenance"]["parallel_degrees"]:
            raise AssertionError("fit_searched: the ranks trained different plans")
        if not all(math.isfinite(v) for v in a["losses"]) or a["train_all"] != \
                FIT_SEARCHED_STEPS * FIT_SEARCHED["batch"] * FIT_SEARCHED["seq"]:
            raise AssertionError(f"fit_searched rank {r['rank']}: {a['losses']}, "
                                 f"train_all {a['train_all']}")
    prov = first["provenance"]
    if not prov["parallel_degrees"] or not prov["estimated_ms"] < prov["serial_ms"]:
        raise AssertionError(f"fit_searched: the winner {prov['parallel_degrees']} is no "
                             f"parallel plan ({prov['estimated_ms']} ms, serial "
                             f"{prov['serial_ms']} ms)")
    print(f"fit_searched winner: {prov['parallel_degrees']} at {prov['estimated_ms']} ms "
          f"estimated (serial {prov['serial_ms']} ms)", flush=True)
    audits = [r["searched"]["provenance"].get("plan_audit") or {} for r in ranks]
    if audits[0] != audits[1] or "summary" not in audits[0] or not audits[0][
            "movement_measured"] or audits[0]["summary"]["num_ops_measured"] != audits[0][
            "num_ops"]:
        raise AssertionError(f"fit_searched: plan_audit {audits[0].get('error', audits[0])}")
    _check_drift(smi, ranks)
    emit({"phase": "fit_searched", "ranks": 2, "sharing": f"2 {SHARED}", "card": smi,
          "config": FIT_SEARCHED, "winner": prov["parallel_degrees"],
          "estimated_ms": prov["estimated_ms"], "serial_ms": prov["serial_ms"],
          "seed_runtimes": prov["seed_runtimes"], "search_seconds": prov["search_seconds"],
          "compile_s": first["compile_s"], "losses": first["losses"],
          "imported_losses": ranks[0]["imported"]["losses"], "bitwise_equal": True,
          "step_ms": first["step_ms"], "local_heads": first["local_heads"],
          "mfu": _mfu(first["step_flops"], first["step_ms"], 2),
          **_require_early_buckets("fit_searched", first["buckets"]),
          "collectives_per_step": first["implied"], "launches_per_rank": first["launches"],
          "plan_audit": {key: audits[0][key] for key in ("num_ops", "num_movement_edges",
                                                         "movement_measured", "summary")}})
    return launches


# fit_overlap: a weight-heavy MLP for which the search on the H100's
# constants picks tensor parallelism with a fused site (the small flagship's
# winner at 2 ranks is the serial plan, which has none), 3 SGD steps; then
# the small flagship with the fusion and legacy rules, 2 Adam steps
OVERLAP_MLP = dict(batch=64, d=2048, h=8192)
OVERLAP_STEPS = 3
OVERLAP_RULES_STEPS = 2
# Fused run against serial run, from the same initial values. Each bound sits
# between the sound readings (losses 2e-6 apart on the card; bitwise equal on
# the CPU, f32) and those of a planted fault, the reduce-scatter ring adding a
# rotated chunk (on the CPU: losses 8.8e-3 apart, logits 0.82, updates 1.2e-2;
# tests/torch_port_probes.py overlap-fault). On fresh weights the loss is
# ~ln(2048) plus a small term and 3 SGD steps move a weight by <1% of its
# norm, so the first-batch logits and the parameters' changes carry the check.
OVERLAP_LOSS_BOUND = 1e-4  # relative, each step's loss
OVERLAP_LOGITS_BOUND = 1e-2  # norm-relative, the first batch's logits before the fit
OVERLAP_UPDATE_BOUND = 3e-3  # norm-relative, each parameter's change over the fit
# a legacy TASO rule (tests/test_legacy_rules.py's): an elementwise add
# partitioned along dim 1
OVERLAP_LEGACY_RULE = {"rule": [{
    "name": "example_subst",
    "srcOp": [{"type": "OP_EW_ADD", "para": [],
               "input": [{"opId": -1, "tsId": 0}, {"opId": -2, "tsId": 0}]}],
    "dstOp": [
        {"type": "OP_PARTITION", "input": [{"opId": -1, "tsId": 0}],
         "para": [{"key": "PM_PARALLEL_DIM", "value": 1},
                  {"key": "PM_PARALLEL_DEGREE", "value": 2}]},
        {"type": "OP_PARTITION", "input": [{"opId": -2, "tsId": 0}],
         "para": [{"key": "PM_PARALLEL_DIM", "value": 1},
                  {"key": "PM_PARALLEL_DEGREE", "value": 2}]},
        {"type": "OP_EW_ADD", "para": [],
         "input": [{"opId": 0, "tsId": 0}, {"opId": 1, "tsId": 0}]},
        {"type": "OP_COMBINE", "input": [{"opId": 2, "tsId": 0}],
         "para": [{"key": "PM_PARALLEL_DIM", "value": 1},
                  {"key": "PM_PARALLEL_DEGREE", "value": 2}]}],
    "mappedOutput": [{"dstOpId": 3, "dstTsId": 0, "srcOpId": 0, "srcTsId": 0}]}]}


def phase_fit_overlap(smi: str, tmp: str, device: str = "cuda:0", cfg: dict = TP_PARITY,
                      mlp: dict = OVERLAP_MLP) -> dict:
    """One job of 2 gloo ranks sharing the card: a searched compile with
    overlap=True (analytic, the H100 constants) prices the fused edges
    (FFConfig.overlap's search), trains through the collective matmuls to
    the losses of the same plan without overlap within OVERLAP_LOSS_BOUND
    (its first batch's logits within OVERLAP_LOGITS_BOUND and each
    parameter's change within OVERLAP_UPDATE_BOUND), ringing k-1 steps a
    step, and its audit times the fused edges as fused;
    then a searched compile with perform_fusion and a legacy rule file the
    phase writes trains the small flagship (finite losses, rows 9-11 once
    per layer per step on each rank). Returns the launches summed over
    the ranks."""
    start = time.perf_counter()
    rules_file = os.path.join(tmp, "fit_overlap_rules.json")
    with open(rules_file, "w") as f:
        json.dump(OVERLAP_LEGACY_RULE, f)
    ranks = run_ranks(2, dict(name="fit_overlap", mode="overlap", cfg=cfg, device=device,
                              mlp=mlp, steps=OVERLAP_STEPS, rules_steps=OVERLAP_RULES_STEPS,
                              rules_file=rules_file), tmp)
    for r in ranks:
        serial, fused = r["serial"], r["fused"]
        if serial["fused"] or not fused["fused"]:
            raise AssertionError(f"fit_overlap rank {r['rank']}: fused sites {serial['fused']} "
                                 f"without overlap, {fused['fused']} with it")
        if serial["provenance"]["parallel_degrees"] != fused["provenance"]["parallel_degrees"]:
            raise AssertionError("fit_overlap: overlap changed the plan")
        ov = fused["provenance"]["overlap"]
        if not (ov["priced"] and ov["eligible"] >= len(fused["fused"])):
            raise AssertionError(f"fit_overlap: the search priced no fused edge: {ov}")
        for a, b in zip(serial["losses"], fused["losses"]):
            if not (math.isfinite(b) and abs(a - b) <= OVERLAP_LOSS_BOUND * abs(a)):
                raise AssertionError(f"fit_overlap rank {r['rank']}: losses {fused['losses']} "
                                     f"fused, {serial['losses']} serial")
        if not r["initial_equal"]:
            raise AssertionError(f"fit_overlap rank {r['rank']}: the runs started apart")
        if not r["logits_rel_diff"] <= OVERLAP_LOGITS_BOUND:
            raise AssertionError(f"fit_overlap rank {r['rank']}: first-batch logits "
                                 f"{r['logits_rel_diff']} apart")
        worst = max(r["update_rel_diff"].values())
        if not worst <= OVERLAP_UPDATE_BOUND:
            raise AssertionError(f"fit_overlap rank {r['rank']}: parameter changes {worst} "
                                 "apart")
        if fused["ring_steps_per_step"] < 1:
            raise AssertionError(f"fit_overlap: {fused['ring_steps_per_step']} ring steps a step")
        rules = r["rules"]
        if not (rules["losses"] and all(math.isfinite(v) for v in rules["losses"])):
            raise AssertionError(f"fit_overlap rank {r['rank']}: rules losses {rules['losses']}")
    audits = [r["fused"]["provenance"].get("plan_audit") or {} for r in ranks]
    if audits[0] != audits[1] or "summary" not in audits[0]:
        raise AssertionError(f"fit_overlap: plan_audit {audits[0].get('error', audits[0])}")
    fused_edges = [e for e in audits[0]["movement_edges"] if "fused_kind" in e]
    if not fused_edges or not all(e["fused"] for e in fused_edges):
        raise AssertionError(f"fit_overlap: the audit's fused edges {fused_edges}")
    launches = _check_rank_launches("fit_overlap", ranks, cfg["layers"], OVERLAP_RULES_STEPS,
                                    key="rules")
    first = ranks[0]
    emit({"phase": "fit_overlap", "ranks": 2, "sharing": f"2 {SHARED}", "card": smi,
          "mlp": mlp, "steps": OVERLAP_STEPS, "cost_model": "analytic (H100 constants)",
          "winner": first["fused"]["provenance"]["parallel_degrees"],
          "estimated_ms": first["fused"]["provenance"]["estimated_ms"],
          "overlap_pricing": {k: v for k, v in first["fused"]["provenance"]["overlap"].items()
                              if k != "edges"},
          "overlap_edges": first["fused"]["provenance"]["overlap"]["edges"],
          "fused_sites": first["fused"]["fused"],
          "ring_steps_per_step": first["fused"]["ring_steps_per_step"],
          "losses": {"serial": first["serial"]["losses"], "fused": first["fused"]["losses"]},
          "bounds": {"loss": OVERLAP_LOSS_BOUND, "logits": OVERLAP_LOGITS_BOUND,
                     "update": OVERLAP_UPDATE_BOUND},
          "logits_rel_diff": first["logits_rel_diff"],
          "update_rel_diff": first["update_rel_diff"], "param_rel_diff": first["param_rel_diff"],
          "step_ms": {"serial": first["serial"]["step_ms"], "fused": first["fused"]["step_ms"]},
          "audit_fused_edges": fused_edges,
          "rules": {"config": cfg, "losses": first["rules"]["losses"],
                    "winner": first["rules"]["provenance"]["parallel_degrees"],
                    "estimated_ms": first["rules"]["provenance"]["estimated_ms"],
                    "launches_per_rank": first["rules"]["launches"]},
          "seconds": time.perf_counter() - start})
    print(f"fit_overlap: {first['fused']['fused']} at "
          f"{first['fused']['provenance']['parallel_degrees']}, losses fused "
          f"{first['fused']['losses']} serial {first['serial']['losses']}, logits "
          f"{first['logits_rel_diff']:.3g} and changes "
          f"{max(first['update_rel_diff'].values()):.3g} apart, audit "
          f"{[(e['fused_kind'], e['measured_ms']) for e in fused_edges]}", flush=True)
    return launches


# drift: the small flagship under the forced tp2 plan in fit_searched's job,
# per step, windows of 4, the `slow` site at every step of the last two
DRIFT_CFG = dict(TP_PARITY)
DRIFT = dict(drift_window_steps=4, drift_run_length=2, drift_band=0.5)
DRIFT_STEPS = 20  # windows: 1 warm-up, 2 baseline, 2 slowed
DRIFT_LATE = 12  # the last step before the slow site fires
DRIFT_SLOW_MS = 600.0


def _check_drift(smi: str, ranks) -> None:
    """The drift runs of fit_searched's job: one `drift` event of cause
    slowdown with the slow site, none without."""
    r0 = ranks[0]["drift"]
    slow, steady = r0["slow"], r0["steady"]
    checks = {
        "one_slowdown_event": len(slow["drift_events"]) == 1
        and slow["drift_events"][0]["cause"] == "slowdown",
        "none_without_slow": steady["drift_events"] == [],
        "all_steps": all(r["drift"][n]["steps"] == DRIFT_STEPS for r in ranks
                         for n in ("slow", "steady")),
    }
    if not all(checks.values()):
        raise AssertionError(f"drift: {checks}, slow {slow}, steady {steady}")
    emit({"phase": "drift", "ranks": 2, "sharing": f"2 {SHARED}", "card": smi,
          "config": DRIFT_CFG, "plan": "forced dp1xtp2xsp1, analytic pricing",
          "monitor": DRIFT, "steps": DRIFT_STEPS,
          "slow_site": {"steps": [DRIFT_LATE + 1, DRIFT_STEPS], "slow_ms": DRIFT_SLOW_MS},
          "estimated_ms": slow["estimated_ms"], "event": slow["drift_events"][0],
          "slow_step_ms": slow["step_ms"], "steady_step_ms": steady["step_ms"],
          "checks": checks})


# parity_ranks_window: K against K = 1 over 2 ranks, a window of 4 and a tail of 1
WINDOW_RANKS_K = 4
WINDOW_RANKS_STEPS = 5
# the data-parallel case's bucket cap: the small flagship's 6.8 MB of f32
# gradients in 10 buckets (at the default 25 MiB they are one)
DP_WINDOW_CAP = 1 << 20
# parity_overlap's Linears: rows, contraction, outputs; bf16 forward
# tolerances (rtol, atol) of the JAX spec, tests/test_collective_matmul.py
OVERLAP_SHAPE = (1024, 2048, 1024)
OVERLAP_BF16_TOL = {"ag_matmul": (2e-2, 1e-2), "matmul_rs": (1.5e-1, 1e-1)}
TORCHRUN_STEPS = 3


def _mfu(step_flops: float, step_ms: float, ranks: int) -> float:
    """The multi-device MFU: the model's own work (kernels.ops.
    graph_step_flops) over step seconds x ranks x the H100's bf16 peak."""
    return step_flops / (step_ms / 1e3 * ranks * PEAK_BF16)


def _require_early_buckets(phase: str, log) -> dict:
    """Each step's (collective buckets issued, of them before the backward's
    last gradient): where a step has two or more, at least one must have
    gone out early (the all-reduces overlap the backward)."""
    for issued, early in log:
        if issued >= 2 and early < 1:
            raise AssertionError(f"{phase}: a step issued {issued} gradient buckets, none "
                                 "before the backward's end")
    return {"buckets_per_step": [b for b, _ in log],
            "issued_before_backward_end": [e for _, e in log]}


def _bhsd_counts(phase: str, launches: dict, want_each: int) -> dict:
    """Rows 9-11 launched want_each times each, no other flash or ring kernel."""
    want = {name: want_each if name in BHSD_WRAPPERS else 0 for name in launches}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")
    return {name: n for name, n in launches.items() if name in BHSD_WRAPPERS}


def phase_ranks(smi: str, tmp: str, world: int, device: str = "cuda:0") -> dict:
    """On `world` ranks sharing the card over gloo, one launch: at 2 ranks
    parity_ranks_window, calibrate_ranks (with the calibrated fit_searched)
    and parity_overlap; at 4 calibrate_ranks and parity_overlap. Emits each
    phase's line; returns the launches of rows 9-11 by phase."""
    ranks = run_ranks(world, dict(
        name=f"ranks{world}", mode="windows" if world == 2 else "calibrate_overlap",
        cfg=TP_PARITY, dp_cfg=TP_PARITY, plan_cfg=FIT_SEARCHED, device=device, alpha=1e-4,
        k=WINDOW_RANKS_K, steps=WINDOW_RANKS_STEPS, dp_cap=DP_WINDOW_CAP,
        strategy=os.path.join(tmp, "fit_searched_strategy.json"), overlap_shape=OVERLAP_SHAPE,
        bf16_tol=OVERLAP_BF16_TOL), tmp)
    note = f"{world} {SHARED}: no NVLink or NCCL figure"
    out = {}
    if world == 2:
        out["parity_ranks_window"] = _emit_ranks_window(smi, ranks, note)
        out["calibrate_ranks"] = _emit_calibrate(smi, ranks, world, note)
    else:
        _emit_calibrate(smi, ranks, world, note)
    _emit_overlap(smi, ranks, world, note)
    return out


def _emit_ranks_window(smi, ranks, note) -> dict:
    """parity_ranks_window: each case's K-step fit bitwise its per-step fit
    on every rank, its windows uncaptured (gloo), every step's buckets."""
    steps, k = WINDOW_RANKS_STEPS, WINDOW_RANKS_K
    launches, cases = {}, {}
    for case, cfg in (("dp", TP_PARITY), ("imported", FIT_SEARCHED)):
        for r in ranks:
            got = r["windows"][case]
            phase = f"parity_ranks_window {case} rank {r['rank']}"
            if not got["bitwise"]:
                raise AssertionError(f"{phase}: the K={k} fit is not bitwise its K=1 fit")
            lengths = [w["steps"] for w in got["windows"]]
            if lengths != [k, steps - k] or any(w["captured"] for w in got["windows"]) or \
                    got["per_step_windows"]:
                raise AssertionError(f"{phase}: windows {got['windows']}")
            for run in got["launches"].values():
                for name, n in _bhsd_counts(phase, run, cfg["layers"] * steps).items():
                    launches[name] = launches.get(name, 0) + n
            buckets = _require_early_buckets(phase, got["buckets"])
        first = ranks[0]["windows"][case]
        cases[case] = dict(
            trainer=first["kind"], config=cfg, losses=first["losses"], bitwise_equal_to_k1=True,
            windows=first["windows"], step_ms=first["step_ms"],
            mfu={kk: _mfu(first["step_flops"], ms, 2) for kk, ms in first["step_ms"].items()},
            buckets_in_plan=first["buckets_in_plan"], **buckets)
    emit({"phase": "parity_ranks_window", "ranks": 2, "sharing": note, "card": smi,
          "steps_per_dispatch": k, "steps": steps, "dp_bucket_cap_bytes": DP_WINDOW_CAP,
          "cases": cases, "captured": False,
          "captured_why": "gloo stages every collective through host memory: no CUDA graph "
                          "holds the window, which runs its K steps in one call"})
    return launches


def _emit_calibrate(smi, ranks, world, note) -> dict:
    """calibrate_ranks: one equal calibration on every rank, its constants
    finite and positive, the ranks an emulated mesh; at 2 ranks the
    calibrated search's winner and its fit."""
    cals = [r["calibrate"] for r in ranks]
    first = cals[0]
    if any(c["calibration"] != first["calibration"] or c["raw"] != first["raw"] for c in cals):
        raise AssertionError("calibrate_ranks: the ranks hold different calibrations")
    raw = first["raw"]
    counts = sorted(int(k) for k in raw["allreduce"])
    want = sorted({2, world})
    if counts != want or not all(v[0] >= 0 and v[1] > 0 and math.isfinite(v[1])
                                 for v in raw["allreduce"].values()):
        raise AssertionError(f"calibrate_ranks: all-reduce constants {raw['allreduce']}")
    if not (0.0 <= raw["overlap"] <= 1.0 and 1.0 <= raw["shard_speedup"] <= world):
        raise AssertionError(f"calibrate_ranks: overlap {raw['overlap']}, shard speedup "
                             f"{raw['shard_speedup']}")
    if not all(c["emulated_mesh"] for c in cals):
        raise AssertionError("calibrate_ranks: ranks sharing the card are not an emulated mesh")
    line = {"phase": "calibrate_ranks", "ranks": world, "sharing": note, "card": smi,
            "calibration": first["calibration"], "calibrate_s": first["seconds"],
            "emulated_mesh": True}
    launches = {}
    if "provenance" in first:
        prov = first["provenance"]
        for c in cals:
            if c["provenance"]["parallel_degrees"] != prov["parallel_degrees"] or \
                    not all(math.isfinite(v) for v in c["losses"]):
                raise AssertionError(f"calibrate_ranks: rank plans or losses differ: {c}")
            phase = "calibrate_ranks fit"
            for name, n in _bhsd_counts(phase, c["launches"], FIT_SEARCHED["layers"] * 2).items():
                launches[name] = launches.get(name, 0) + n
            buckets = _require_early_buckets(phase, c["buckets"])
        print(f"calibrate_ranks winner: {prov['parallel_degrees'] or 'serial'} at "
              f"{prov['estimated_ms']} ms estimated (serial {prov['serial_ms']} ms)", flush=True)
        line.update(config=FIT_SEARCHED, cost_model="calibrated",
                    winner=prov["parallel_degrees"] or "serial", estimated_ms=prov["estimated_ms"],
                    serial_ms=prov["serial_ms"], seed_runtimes=prov["seed_runtimes"],
                    search_seconds=prov["search_seconds"], trainer=first["kind"],
                    losses=first["losses"], step_ms=first["step_ms"],
                    mfu=_mfu(first["step_flops"], first["step_ms"], world), **buckets)
    emit(line)
    return launches


def _emit_overlap(smi, ranks, world, note) -> None:
    """parity_overlap: each fused site's forward within the JAX spec's bf16
    tolerance of the serial lowering's, k - 1 ring steps a forward and a
    step (none serially), a finite train step issuing what its plan
    implies."""
    sites = {}
    for r in ranks:
        for kind, got in r["overlap"].items():
            phase = f"parity_overlap {kind} rank {r['rank']} of {world}"
            if not got["within"] or got["fused"] != [kind]:
                raise AssertionError(f"{phase}: fused {got['fused']}, forward off the serial "
                                     f"lowering's by {got['max_abs_err']} (tolerance "
                                     f"{OVERLAP_BF16_TOL[kind]})")
            if got["ring_steps"] != world - 1 or got["serial_ring_steps"] != 0 or \
                    got["step"].get("ring_step") != world - 1 or got["step"] != got["implied"]:
                raise AssertionError(f"{phase}: ring steps {got['ring_steps']} a forward, step "
                                     f"{got['step']}, implied {got['implied']}")
            if not all(math.isfinite(v) for v in got["losses"]):
                raise AssertionError(f"{phase}: losses {got['losses']}")
            sites.setdefault(kind, got)
    emit({"phase": "parity_overlap", "ranks": world, "sharing": note, "card": smi,
          "shape": dict(zip(("rows", "contraction", "outputs"), OVERLAP_SHAPE)),
          "compute_dtype": "bf16", "tolerance": OVERLAP_BF16_TOL,
          "ring": "gloo on a card: each chunk staged through pinned host memory",
          "sites": {k: {key: v[key] for key in ("max_abs_err", "max_rel_err", "ring_steps",
                                                  "losses", "step")}
                    for k, v in sites.items()}})


# One rank of the torchrun phase's job (written to a file: torchrun runs a
# script); argv: output prefix, "torchrun" or "file" (then rank and store),
# the config (JSON). Each rank writes <prefix>.rank<r>.json.
TORCHRUN_JOB = r'''
import hashlib, json, sys
import numpy as np
import torch
import torch.distributed as dist
from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.models import build_flagship_cg
from flexflow_tpu_torch.runtime import distributed as D

out, mode, cfg = sys.argv[1], sys.argv[2], json.loads(sys.argv[-1])
if mode == "torchrun":
    D.initialize(backend="gloo")
else:
    from flexflow_tpu_torch.parallel import init_file_group
    init_file_group(sys.argv[4], int(sys.argv[3]), 2, device=cfg["device"], backend="gloo")
device = torch.device(cfg["device"])
m = FFModel.from_computation_graph(
    *build_flagship_cg(**cfg["model"]), device=device,
    config=FFConfig(batch_size=cfg["model"]["batch"], seed=0, print_freq=0, search_budget=2))
m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy",
          compute_dtype=torch.bfloat16 if device.type == "cuda" else None)
losses, step = [], m.instance.train_step
m.instance.train_step = lambda *a, **k: losses.append(float((r := step(*a, **k))[2])) or r
gen = torch.Generator().manual_seed(1)
n = cfg["steps"] * cfg["model"]["batch"]
x = torch.randn(n, cfg["model"]["seq"], cfg["model"]["embed"], generator=gen)
y = torch.randint(0, cfg["model"]["vocab"], (n, cfg["model"]["seq"]), generator=gen)
fa.reset_launch_counts()
m.fit(x.numpy(), y.numpy().astype(np.int32), epochs=1, shuffle=False, verbose=False)
digest = {k: hashlib.sha256(p.detach().float().cpu().numpy().tobytes()).hexdigest()
          for k, p in m.params.items()}
res = dict(rank=dist.get_rank(), world=dist.get_world_size(), searches=D.search_calls,
           degrees=m.search_provenance["parallel_degrees"], losses=losses, digest=digest,
           launches={fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS},
           buckets=[list(b) for b in getattr(m.instance, "bucket_log", [])])
dist.destroy_process_group()
with open(out + f".rank{res['rank']}.json", "w") as f:
    json.dump(res, f)
'''


def phase_torchrun(smi: str, tmp: str, device: str = "cuda:0") -> dict:
    """`torchrun --standalone --nproc_per_node 2` launches a 2-rank searched
    fit (the small flagship, search_budget=2, bf16, on the card over gloo)
    that opens its group through runtime.distributed.initialize(backend=
    "gloo") from torchrun's env://; rank 0 alone searches, and the losses
    and parameters are bitwise the same job's over a file:// store."""
    script = os.path.join(tmp, "torchrun_job.py")
    with open(script, "w") as f:
        f.write(TORCHRUN_JOB)
    cfg = json.dumps({"model": TP_PARITY, "steps": TORCHRUN_STEPS, "device": device})
    env = dict(os.environ, PYTHONPATH=REPO, FLEXFLOW_TPU_AUTO_DISTRIBUTED="1",
               OMP_NUM_THREADS="4")
    start = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", script, os.path.join(tmp, "torchrun"),
                          "torchrun", cfg], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT_S)
    torchrun_s = time.perf_counter() - start
    if run.returncode != 0:
        raise AssertionError(f"torchrun: exited {run.returncode}: {run.stderr[-3000:]}")
    env.pop("FLEXFLOW_TPU_AUTO_DISTRIBUTED")
    procs = [subprocess.Popen([sys.executable, script, os.path.join(tmp, "file"), "file", str(r),
                               os.path.join(tmp, "store_torchrun_file"), cfg], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"torchrun: the file:// job's rank {r} exited "
                                     f"{p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {mode: [json.load(open(os.path.join(tmp, f"{mode}.rank{r}.json"))) for r in range(2)]
           for mode in ("torchrun", "file")}
    if [r["searches"] for r in got["torchrun"]] != [1, 0]:
        raise AssertionError("torchrun: searches by rank "
                             f"{[r['searches'] for r in got['torchrun']]}")
    launches = {}
    for a, b in zip(got["torchrun"], got["file"]):
        if a["losses"] != b["losses"] or a["digest"] != b["digest"] or a["world"] != 2:
            raise AssertionError(f"torchrun: rank {a['rank']} trained to {a['losses']}, the "
                                 f"file:// job's to {b['losses']} (parameters equal: "
                                 f"{a['digest'] == b['digest']})")
        if len(a["losses"]) != TORCHRUN_STEPS or not all(math.isfinite(v) for v in a["losses"]):
            raise AssertionError(f"torchrun: losses {a['losses']}")
        phase = f"torchrun rank {a['rank']}"
        for name, n in _bhsd_counts(phase, a["launches"],
                                    TP_PARITY["layers"] * TORCHRUN_STEPS).items():
            launches[name] = launches.get(name, 0) + n
    first = got["torchrun"][0]
    emit({"phase": "torchrun", "ranks": 2, "sharing": f"2 {SHARED}", "card": smi,
          "config": TP_PARITY, "steps": TORCHRUN_STEPS, "launcher": "torchrun --standalone "
          "--nproc_per_node 2, runtime.distributed.initialize(backend='gloo') from env://",
          "searches_by_rank": [r["searches"] for r in got["torchrun"]],
          "winner": first["degrees"] or "serial", "losses": first["losses"],
          "bitwise_equal_to_file_store_job": True, "torchrun_s": torchrun_s,
          "buckets": first["buckets"]})
    return launches


def phase_examples():
    """Every port example run in-process on the card through its main() at
    tests/test_examples.py's sizes with --print-freq 1: each ends without
    error and prints its step losses, all finite."""
    import importlib
    import io
    import re

    from flexflow_tpu_torch.examples import SMOKE_ARGV

    results = {}
    for name, argv in SMOKE_ARGV:
        module = importlib.import_module(f"flexflow_tpu_torch.examples.{name}")
        buf = io.StringIO()
        start = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            module.main([*argv, "-p", "1", "--device", "cuda"])
        printed = buf.getvalue()
        losses = [float(v) for v in re.findall(r"loss (\S+)", printed)]
        if not losses or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"examples: {name} printed no finite loss:\n{printed}")
        results[" ".join([name, *argv])] = {
            "losses": losses, "seconds": time.perf_counter() - start,
            "last_line": printed.strip().splitlines()[-1]}
    emit({"phase": "examples", "device": "cuda", "examples": results})


# -- serving a searched plan across ranks (plan_serve, serve_ranks) and the
# -- plan ops the executor lowers on whole values (parity_plan_ops)

SERVE_MEASURED = {}  # serve's measured decode step and prefill, read by plan_serve
PLAN_SERVE_BUDGET = 2
# plan_serve plans SERVE_LM cut to 10 of its 12 layers: its searches build a
# problem tree of every candidate, and at 12 layers took 117-134 s, the
# largest share of the script's time limit. 10 is the least depth at which a
# budget lies below the serial decode plan's peak and cache and still admits
# a seed of the prefill (whose trailing Combine gathers the whole logits,
# whatever the depth)
PLAN_SERVE_LM = dict(SERVE_LM, num_layers=10)
PLAN_SERVE_GEN = sum(SERVE_TRAFFIC["max_new_tokens"]) // 2  # the traffic's mean budget
SERVE_RANKS_LM = dict(SERVE_LM, num_layers=2)
SERVE_RANKS_TRAFFIC = dict(slots=SERVE_TRAFFIC["slots"], max_seq_len=SERVE_TRAFFIC["max_seq_len"],
                           requests=24, prompt_len=(32, 96), max_new_tokens=(16, 32),
                           window_steps=8, seed=3)
SERVE_RANKS_STEPS = 6  # greedy decode steps compared after the prefill
SERVE_RANKS_PLANS = {"searched4": 4, "tp2": 2, "dp2xtp2": 4}
PLAN_OPS = dict(batch=8, seq=128, embed=1024, heads=8, layers=2, vocab=32000)
PLAN_OPS_STEPS = 3
PLAN_OPS_BOUND = 1e-4  # relative: losses, first-step gradients, parameters (f32, TF32 off)
PLAN_OPS_RANKS = {"dropout": 4, "class_sharded": 2, "whole": 2}  # kinds of a world: one launch

# One rank of serve_ranks or parity_plan_ops; argv: rank, world, job (JSON).
# The ranks share the job's device over an explicit gloo group; each writes
# its result to <out>.rank<r>.json.
PLAN_RANK_WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke as c
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.parallel import MachineMesh, init_file_group

rank, world, job = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
device = init_file_group(job["store"], rank, world, device=job["device"], backend="gloo")
out = {"rank": rank}
if job["mode"] == "serve_ranks":
    for plan in job["plans"]:
        fa.reset_launch_counts()
        out[plan] = c.serve_rank(plan, job, device, rank)
        out[plan]["launches"] = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
elif job["mode"] == "plan_ops":
    for kind in job["kinds"]:
        out[kind] = c.plan_ops_rank(kind, device, world, f"{job['out']}.{kind}.npz", job["cfg"])
with open(f"{job['out']}.rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _serve_ranks_requests(t, vocab):
    return _serve_requests(t["requests"], vocab, t["prompt_len"], t["max_new_tokens"], t["seed"])


def _traced_engine(programs, requests, window_steps, device) -> dict:
    """Serve `requests` through a continuous-batching engine: each
    prefill's (window, replica, admitted rids), every request's tokens, the
    run's seconds and ms/token."""
    from flexflow_tpu_torch.serving import ServingEngine

    eng = ServingEngine(programs, mode="continuous", window_steps=window_steps)
    trace = []
    prefill = eng._prefill
    eng._prefill = lambda rep, adm: trace.append(
        [eng.windows, rep.idx, [rep.slots[i].request.rid for i in adm]]) or prefill(rep, adm)
    try:
        for r in requests:
            eng.submit(r)
        _sync(device)
        start = time.perf_counter()
        records = eng.run()
        _sync(device)
        run_s = time.perf_counter() - start
        summary = eng.summary()
    finally:
        eng.close()
    tokens = sum(len(r.tokens) for r in records)
    return dict(trace=trace, tokens={r.rid: list(r.tokens) for r in records}, run_s=run_s,
                output_tokens_per_s=tokens / run_s, p50_ms_per_token=summary["p50_ms_per_token"])


def _prefill_and_decode(program, prompts, lengths, steps):
    """(last-position logits [slots, vocab] on the CPU, `steps` greedy
    tokens [slots, steps]) of one prefill of the whole slot batch."""
    import numpy as np

    cache = program.init_cache()
    fresh = np.ones(len(lengths), bool)
    cache, tok, last = program.prefill(cache, prompts, lengths, fresh)
    _, _, _, toks = program.decode_window(cache, tok.cpu().numpy(), lengths, fresh, steps)
    return last.float().cpu(), toks.cpu().numpy()


def _serve_ranks_inputs(t, vocab):
    import numpy as np

    rng = np.random.default_rng(t["seed"] + 1)
    prompts = rng.integers(0, vocab, (t["slots"], t["prompt_len"][1])).astype(np.int32)
    lengths = rng.integers(t["prompt_len"][0], t["prompt_len"][1] + 1, t["slots"]).astype(np.int32)
    return prompts, lengths


def serve_rank(plan: str, job: dict, device, rank: int) -> dict:
    """One rank of serve_ranks: the plan's ServingProgram over the group's
    mesh from the global numpy parameters, its cache's allocated bytes, one
    prefill and SERVE_RANKS_STEPS greedy steps, then the traffic through the
    engine."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.parallel import MachineMesh
    from flexflow_tpu_torch.runtime.strategy import load_strategy
    from flexflow_tpu_torch.serving import ServingMemorySpec, ServingProgram, per_device_cache_bytes

    t = job["traffic"]
    mem = ServingMemorySpec(t["slots"], t["max_seq_len"])
    pcg, mapping, _ = load_strategy(job["strategies"][plan])
    params = {k: torch.from_numpy(v) for k, v in np.load(job["params"]).items()}
    program = ServingProgram(pcg, mem, mapping=mapping, machine_mesh=MachineMesh.for_devices(),
                             params=params, device=device)
    del params
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device) if cuda else 0
    cache = program.init_cache()
    allocated = (torch.cuda.memory_allocated(device) - before if cuda else
                 sum(v.numel() * v.element_size() for kv in cache.values() for v in kv.values()))
    del cache
    prompts, lengths = _serve_ranks_inputs(t, job["vocab"])
    last, toks = _prefill_and_decode(program, prompts, lengths, job["steps"])
    captured = program.last_window["captured"]
    if rank == 0:
        np.save(f"{job['out']}.{plan}.last.npy", last.numpy())
    served = _traced_engine(program, _serve_ranks_requests(t, job["vocab"]), t["window_steps"],
                            device)
    return dict(cache_allocated=allocated,
                cache_priced=per_device_cache_bytes(program.pcg, program.layers, mem),
                cache_specs={k: [list(a) if a else None for a in v]
                             for k, v in program.cache_shardings.items()},
                whole_nodes=len(program.plan.whole_nodes),
                class_cut=bool(program.plan.shardings[program.logit_tensor].dims[-1]),
                greedy=toks.tolist(), captured=captured, engine=served)


def _named_params(graph, seed: int) -> dict:
    """Parameters drawn with numpy from `seed`, keyed by weight layer name
    (which a plan keeps): matrices N(0, 1/fan_in), vectors at their
    initializer's constant plus N(0, 0.1) noise."""
    import numpy as np
    from flexflow_tpu_torch.local_execution.training_backing import weight_nodes, weight_shape
    from flexflow_tpu_torch.pcg.initializer import ConstantInitializerAttrs

    rng = np.random.default_rng(seed)
    nodes = {graph.layer_attrs(n).name: n for n in weight_nodes(graph)}
    out = {}
    for name in sorted(nodes):
        dims = weight_shape(graph, nodes[name]).dims
        if len(dims) >= 2:
            out[name] = (rng.standard_normal(dims) / math.sqrt(dims[0])).astype(np.float32)
        else:
            (o,) = graph.outputs_of(nodes[name])
            init = graph.tensor_attrs(o).initializer
            base = init.value if isinstance(init, ConstantInitializerAttrs) else 0.0
            out[name] = (base + 0.1 * rng.standard_normal(dims)).astype(np.float32)
    return out


def _by_key(graph, named: dict) -> dict:
    """`named` keyed by the graph's weight keys (param_key)."""
    from flexflow_tpu_torch.local_execution.training_backing import param_key, weight_nodes

    return {param_key(n): named[graph.layer_attrs(n).name] for n in weight_nodes(graph)}


def _plan_ops_graph(kind: str, parallel: bool, p: dict):
    """(graph, logits) of parity_plan_ops' model `kind` at PLAN_OPS: the
    flagship's layers, every layer named. dropout: a CG with Dropout(0.1)
    after each attention and FFN, under the dp2 x tp2 seeds when `parallel`;
    class_sharded: its head fed by a Replicate(2) when `parallel`, so the
    logits reach the loss cut over their classes; whole: a Linear with a
    ReLU before the head, fed by a Repartition(2) of the hidden dim when
    `parallel`, so the activation acts on partial sums (then a
    Reduction(2)). Without `parallel`, the same model on one device. `p`:
    the widths (PLAN_OPS on the card)."""
    from flexflow_tpu_torch.op_attrs.activation import Activation
    from flexflow_tpu_torch.op_attrs.datatype import DataType
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import lift_to_parallel
    from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
    from flexflow_tpu_torch.pcg import ComputationGraphBuilder
    from flexflow_tpu_torch.pcg.parallel_computation_graph_builder import (
        ParallelComputationGraphBuilder,
    )

    if kind == "dropout":
        b = ComputationGraphBuilder()
        h = b.create_input([p["batch"], p["seq"], p["embed"]], name="x")
    else:
        b = ParallelComputationGraphBuilder()
        h = b.create_input_tensor(lift_to_parallel(TensorShape(
            (p["batch"], p["seq"], p["embed"]), DataType.FLOAT)), name="x")
    for i in range(p["layers"]):
        a = b.multihead_attention(h, h, h, p["embed"], p["heads"], name=f"attn{i}")
        if kind == "dropout":
            a = b.dropout(a, 0.1, name=f"drop_a{i}")
        h = b.layer_norm(b.add(h, a, name=f"res_a{i}"), axes=[-1], name=f"ln1_{i}")
        f = b.dense(h, 4 * p["embed"], use_bias=False, name=f"ff1_{i}")
        f = b.dense(b.gelu(f, name=f"gelu{i}"), p["embed"], use_bias=False, name=f"ff2_{i}")
        if kind == "dropout":
            f = b.dropout(f, 0.1, name=f"drop_f{i}")
        h = b.layer_norm(b.add(h, f, name=f"res_f{i}"), axes=[-1], name=f"ln2_{i}")
    if kind == "whole":
        x = b.parallel_partition(h, 2, 2) if parallel else h
        h = b.dense(x, p["embed"], activation=Activation.RELU, name="pre_head")
        if parallel:
            h = b.parallel_reduce(h, 2)
    if kind == "class_sharded" and parallel:
        h = b.parallel_replicate(h, 2)
    logits = b.dense(h, p["vocab"], use_bias=False, name="head")
    graph = b.graph
    if kind == "dropout" and parallel:
        from flexflow_tpu_torch.compiler.unity_algorithm import (
            data_parallel_seed,
            tensor_parallel_seed,
        )
        from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph

        graph = data_parallel_seed(tensor_parallel_seed(pcg_from_computation_graph(graph), 2), 2)
        logits = graph.outputs_of(graph.topological_ordering()[-1])[0]
    return graph, logits


def _plan_ops_data(p: dict):
    import torch

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(p["batch"], p["seq"], p["embed"], generator=gen)
    return x, torch.randint(0, p["vocab"], (p["batch"], p["seq"]), generator=gen)


def _plan_ops_train(inst, params, x, y, device, masks_of=None) -> dict:
    """The first step's gradients (global values, keyed by weight name),
    then PLAN_OPS_STEPS Adam steps drawing Dropout from a generator seeded
    7: losses, the final parameters by name, and each step's masks as
    `masks_of(step masks)` keeps them."""
    import torch
    from flexflow_tpu_torch.local_execution.training_backing import dropout_masks

    graph = inst.pcg if hasattr(inst, "pcg") else inst.cg
    opt = inst.initialize(seed=0)[1]
    rng = torch.Generator(device=device).manual_seed(7)
    _, grads = inst.loss_and_grads(params, {"x": x}, y, rng=torch.Generator(
        device=device).manual_seed(11))
    out = {"losses": [], "masks": {}, "grads": grads}
    for step in range(PLAN_OPS_STEPS):
        if masks_of is not None:
            state = rng.get_state()
            for n, m in dropout_masks(graph, rng, device).items():
                out["masks"][f"{step}:{graph.layer_attrs(n).name}"] = masks_of(n, m)
            rng.set_state(state)
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y, rng)
        out["losses"].append(float(loss))
    out["params"] = params
    return out


def plan_ops_rank(kind: str, device, world: int, out: str, cfg: dict) -> dict:
    """One rank of parity_plan_ops: the plan of `kind` through
    DistributedTrainingInstance (f32) from the named parameters: its
    losses, the digests of every step's global Dropout masks as this rank
    draws them, its whole-tensor nodes and class axes; rank 0 also saves
    the first step's gradients and the final parameters, gathered to
    global values and keyed by weight name, to `out`.npz."""
    import numpy as np
    from flexflow_tpu_torch.interop import pcg_params_from_numpy
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh, gather_block
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
    from flexflow_tpu_torch.utils.graph import Node

    graph, logits = _plan_ops_graph(kind, True, cfg)
    mesh = MachineMesh.for_devices(world)
    inst = DistributedTrainingInstance(graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                       AdamOptimizerAttrs(alpha=1e-4), mesh, device=device)
    params = pcg_params_from_numpy(graph, inst.shardings, mesh,
                                   _by_key(graph, _named_params(graph, 0)), device)
    x, y = _plan_ops_data(cfg)
    res = _plan_ops_train(inst, params, x, y, device, _mask_digest)
    name = {k: graph.layer_attrs(Node(int(k[1:]))).name for k in res["params"]}
    saved = {}
    for tag in ("grads", "params"):
        for k, v in res[tag].items():
            saved[f"{tag}:{name[k]}"] = gather_block(v, inst.weight_sharding(k), mesh).float().cpu()
    if mesh.rank == 0:
        np.savez(out, **{k: v.numpy() for k, v in saved.items()})
    return dict(losses=res["losses"], masks=res["masks"], whole=sorted(inst.plan.whole_nodes.values()),
                class_axes=list(inst.class_axes), collectives=dict(mesh.counts))


def _mask_digest(node, mask) -> str:
    import hashlib

    return hashlib.sha256(mask.cpu().numpy().tobytes()).hexdigest()


def _mask_draw_cost(cfg: dict, device) -> dict:
    """What each rank pays to draw a step's whole Dropout masks (the plan's
    global shapes) before keeping its piece: ms of one dropout_masks call
    (median of 5, the device synchronized around each) and the bytes it
    writes (an f32 uniform and a bool mask per element)."""
    import torch
    from flexflow_tpu_torch.local_execution.training_backing import dropout_masks

    graph, _ = _plan_ops_graph("dropout", False, cfg)
    rng = torch.Generator(device=device).manual_seed(0)
    times = []
    for _ in range(6):
        _sync(device)
        start = time.perf_counter()
        masks = dropout_masks(graph, rng, device)
        _sync(device)
        times.append((time.perf_counter() - start) * 1e3)
    numel = sum(m.numel() for m in masks.values())
    return dict(masks=len(masks), elements=numel, bytes_written=5 * numel,
                ms=statistics.median(times[1:]))


def _plan_ops_single(kind: str, device, cfg: dict) -> dict:
    """parity_plan_ops' reference: the model of `kind` on one device (the
    card, f32) from the same named parameters and data."""
    from flexflow_tpu_torch.interop import params_from_numpy
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    graph, logits = _plan_ops_graph(kind, False, cfg)
    inst = ModelTrainingInstance(graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                 AdamOptimizerAttrs(alpha=1e-4), device=device)
    params = params_from_numpy(graph, _by_key(graph, _named_params(graph, 0)), device)
    x, y = (t.to(device) for t in _plan_ops_data(cfg))
    res = _plan_ops_train(inst, params, x, y, device, _mask_digest)
    from flexflow_tpu_torch.utils.graph import Node

    name = {k: graph.layer_attrs(Node(int(k[1:]))).name for k in res["params"]}
    res["grads"] = {name[k]: v.float().cpu() for k, v in res["grads"].items()}
    res["params"] = {name[k]: v.float().cpu() for k, v in res["params"].items()}
    return res

def _serving_search(cfg, spec, workload, hbm_gb, cost_model, local=None, budget=PLAN_SERVE_BUDGET,
                    device="cuda"):
    from flexflow_tpu_torch.serving import ServingLMConfig, build_serving_lm
    from flexflow_tpu_torch.serving.plan import optimize_serving_plan

    lm = ServingLMConfig(**cfg)
    start = time.perf_counter()
    plan = optimize_serving_plan(lambda b, s: build_serving_lm(lm, b, s), spec, workload,
                                 hbm_gb=hbm_gb, budget=budget, cost_model=cost_model,
                                 max_seq_len=SERVE_TRAFFIC["max_seq_len"], device=device,
                                 local_cost_estimator=local)
    return plan, time.perf_counter() - start


def _tight_serving_gb(cfg, spec, workload):
    """(a memory budget in GiB, the serial decode plan's cache in bytes): a
    budget the serial decode plan exceeds but some strategy seed of each
    phase fits, 1.02 x the larger of the two phases' smallest seed peak
    (a prefill's trailing Combine gathers its whole logits on every
    device, so the prefill bounds how tight a budget can be)."""
    from flexflow_tpu_torch.analysis.memory_analysis import analyze_memory
    from flexflow_tpu_torch.compiler.unity_algorithm import enumerate_seeds
    from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph
    from flexflow_tpu_torch.serving import ServingLMConfig, build_serving_lm
    from flexflow_tpu_torch.serving.kv_cache import attention_layers, per_device_cache_bytes

    cache_spec = workload.cache_spec(SERVE_TRAFFIC["max_seq_len"])

    def peak(pcg):
        return max(analyze_memory(pcg, spec, None, serving=cache_spec).peak_by_device().values())

    lm = ServingLMConfig(**cfg)
    serial = pcg_from_computation_graph(build_serving_lm(lm, workload.max_concurrent, 1)[0])
    least = []
    for seq in (1, workload.prompt_len):
        pcg = pcg_from_computation_graph(build_serving_lm(lm, workload.max_concurrent, seq)[0])
        least.append(min(peak(p) for _, p in enumerate_seeds(pcg, spec.num_devices)))
    budget = 1.02 * max(least)
    if not budget < peak(serial):
        raise AssertionError(f"no budget both binds the serial plan ({peak(serial)} B) and admits "
                             f"a seed of each phase ({least} B)")
    return budget / 2**30, per_device_cache_bytes(serial, attention_layers(serial), cache_spec)


def _plan_serve_rows(cfg: dict, prompt: int, tight: float, serial_cache: int, model: str,
                     device, local=None, budgets=("unbudgeted", "budgeted")) -> dict:
    """plan_serve's searches on one cost model (optimize_serving_plan, one
    after another, through one leaf timer `local` where one is given),
    unbudgeted and at `tight` GiB: each one's row of numbers with its
    decode and prefill searches' phase ms; the budgeted winner checked
    against verify_memory at that budget and its cache against the serial
    plan's."""
    from flexflow_tpu_torch.analysis.diagnostics import has_errors
    from flexflow_tpu_torch.analysis.memory_analysis import verify_memory
    from flexflow_tpu_torch.compiler import parallel_degree_summary
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.serving.kv_cache import attention_layers, per_device_cache_bytes
    from flexflow_tpu_torch.serving.plan import ServingWorkload

    t = SERVE_TRAFFIC
    spec = MachineSpecification(1, 1, SEARCH_NODE_GPUS, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)
    workload = ServingWorkload(prompt_len=prompt, gen_len=PLAN_SERVE_GEN, max_concurrent=t["slots"])
    cache_spec = workload.cache_spec(t["max_seq_len"])
    rows = {}
    for budget, hbm in (("unbudgeted", 0.0), ("budgeted", tight)):
        if budget not in budgets:
            continue
        label = f"{model}_{budget}"
        plan, secs = _serving_search(cfg, spec, workload, hbm, model, local, device=device)
        cache = per_device_cache_bytes(plan.decode.pcg, attention_layers(plan.decode.pcg),
                                       cache_spec)
        row = dict(seconds=secs, ms_per_token=plan.ms_per_token, decode_ms=plan.decode_ms,
                   prefill_ms=plan.prefill_ms, serial_decode_ms=plan.decode.serial_runtime,
                   serial_prefill_ms=plan.prefill.serial_runtime,
                   decode_winner=parallel_degree_summary(plan.decode.pcg),
                   prefill_winner=parallel_degree_summary(plan.prefill.pcg),
                   explored=[plan.decode.explored, plan.prefill.explored],
                   phase_ms={p: plan.provenance[p]["phase_ms"] for p in ("decode", "prefill")},
                   per_device_cache_bytes=cache)
        if local is not None:
            row["leaves_timed_so_far"] = local.profile_calls
        if hbm:
            for phase in (plan.decode, plan.prefill):
                _, diags = verify_memory(phase.pcg, spec, phase.machine_mapping,
                                         hbm_bytes=tight * 2**30, serving=cache_spec)
                if has_errors(diags):
                    raise AssertionError(f"plan_serve {label}: the winner fails verify_memory "
                                         f"at {tight} GiB: {[d.message for d in diags]}")
            if not cache < serial_cache:
                raise AssertionError(f"plan_serve {label}: per-device cache {cache} B is not "
                                     f"below the serial plan's {serial_cache} B")
            row.update(hbm_gb=tight, verified=True, serial_cache_bytes=serial_cache)
        if not (math.isfinite(plan.ms_per_token) and plan.ms_per_token > 0):
            raise AssertionError(f"plan_serve {label}: ms/token {plan.ms_per_token}")
        rows[label] = row
    return rows


# plan_serve's analytic searches (host work only), one budget in each of two
# processes beside the measured ones (argv: one JSON list of
# _plan_serve_rows' arguments); prints their rows as its last line
PLAN_SERVE_WORKER = r"""
import json, sys
import chip_smoke as c
print(json.dumps(c._plan_serve_rows(*json.loads(sys.argv[1]))))
"""


def phase_plan_serve(smi: str, device: str = "cuda", cfg: dict = SERVE_LM) -> None:
    """The serving search (serving/plan.py) plans `cfg` (the script passes
    PLAN_SERVE_LM, SERVE_LM at 10 of its layers) at SERVE_TRAFFIC's
    slots and max_seq_len for a node of 8 H100s (prompts at serve's median
    prefill width, generations at the traffic's mean budget): with each
    leaf's forward timed on the card (f32, CUDA events around graph
    replays), unbudgeted and then under a budget below the serial plan's
    cache (_tight_serving_gb), the two through optimize_serving_plan in this
    process and one leaf timer; and analytically at the H100 constants, the
    two budgets at once in two processes of their own meanwhile (host work,
    no device). Each search prints its decode and prefill phases' ms. The
    budgeted winners pass verify_memory at that budget with a smaller
    per-device cache than the serial plan's; the 1-device estimates are
    printed beside serve's measured decode step and prefill (of all of
    SERVE_LM's layers), with their ratios (no bound)."""
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels.profiling import ProfilingSettings
    from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.serving.plan import ServingWorkload

    start = time.perf_counter()
    fa.reset_launch_counts()
    t = SERVE_TRAFFIC
    spec = MachineSpecification(1, 1, SEARCH_NODE_GPUS, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)
    if "median_prefill_width" not in SERVE_MEASURED:
        raise AssertionError("plan_serve reads serve's measurements: add serve to --phases")
    prompt = SERVE_MEASURED["median_prefill_width"]
    workload = ServingWorkload(prompt_len=prompt, gen_len=PLAN_SERVE_GEN, max_concurrent=t["slots"])
    cache_spec = workload.cache_spec(t["max_seq_len"])
    tight, serial_cache = _tight_serving_gb(cfg, spec, workload)
    if not tight * 2**30 < serial_cache:
        raise AssertionError(f"plan_serve: the budget {tight} GiB does not bind the serial "
                             f"plan's cache ({serial_cache} B)")
    children = [subprocess.Popen(
        [sys.executable, "-c", PLAN_SERVE_WORKER,
         json.dumps([cfg, prompt, tight, serial_cache, "analytic", device, None, [budget]])],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for budget in ("unbudgeted", "budgeted")]
    try:
        local = LocalCostEstimator(ProfilingSettings(2, 5), forward_only=True,
                                   serving=cache_spec, optimizer_state_slots=0, device=device)
        rows = _plan_serve_rows(cfg, prompt, tight, serial_cache, "measured", device, local)
        for child in children:
            out, err = child.communicate(timeout=RANK_TIMEOUT_S)
            if child.returncode != 0:
                raise AssertionError(f"plan_serve: the analytic searches failed: {err[-3000:]}")
            rows.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    _no_flash_launches("plan_serve")
    measured, analytic = rows["measured_unbudgeted"], rows["analytic_unbudgeted"]
    ratios = {
        "decode_estimate_over_measured":
            measured["serial_decode_ms"] / SERVE_MEASURED["median_decode_ms_per_step"],
        "prefill_estimate_over_measured":
            measured["serial_prefill_ms"] / SERVE_MEASURED["median_prefill_ms"],
        "analytic_decode_estimate_over_measured":
            analytic["serial_decode_ms"] / SERVE_MEASURED["median_decode_ms_per_step"],
        "analytic_prefill_estimate_over_measured":
            analytic["serial_prefill_ms"] / SERVE_MEASURED["median_prefill_ms"],
    }
    for label, row in rows.items():
        print(f"plan_serve {label}: decode {row['decode_winner']} prefill "
              f"{row['prefill_winner']} at {row['ms_per_token']:.4f} ms/token "
              f"({row['seconds']:.1f} s; ms by search phase {row['phase_ms']})", flush=True)
    emit({"phase": "plan_serve", "card": smi, "config": cfg, "node_gpus": SEARCH_NODE_GPUS,
          "workload": dataclasses.asdict(workload), "max_seq_len": t["max_seq_len"],
          "budget": PLAN_SERVE_BUDGET, "hbm_gb_budgeted": tight, "searches": rows,
          "leaves_measured": local.profile_calls,
          "leaves_inf": len(local.inf_leaves),
          "serve_measured": SERVE_MEASURED, "one_device_ratios": ratios,
          "ratios_are": f"estimates at {cfg['num_layers']} layers over serve's measured step at "
                        f"{SERVE_LM['num_layers']}",
          "launches": _flash_launches(), "seconds": time.perf_counter() - start})


def _serve_ranks_reference(tmp: str, device, lm_cfg: dict, t: dict) -> dict:
    """serve_ranks' single-device reference on the card (f32, TF32 off):
    the numpy parameters every rank cuts, one prefill and the greedy steps,
    and the engine's trace; and the plans' strategy files (the 4-device
    budgeted search's winner, the forced tp2 and dp2 x tp2)."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.compiler.unity_algorithm import data_parallel_seed, tensor_parallel_seed
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph
    from flexflow_tpu_torch.runtime.strategy import save_strategy
    from flexflow_tpu_torch.serving import (
        ServingLMConfig,
        ServingMemorySpec,
        ServingProgram,
        build_serving_lm,
    )
    from flexflow_tpu_torch.serving.plan import ServingWorkload

    lm = ServingLMConfig(**lm_cfg)
    cg, _ = build_serving_lm(lm, t["slots"], 1)
    params = _seeded_params(cg, t["seed"])
    path = os.path.join(tmp, "serve_ranks_params.npz")
    np.savez(path, **params)
    program = ServingProgram(cg, ServingMemorySpec(t["slots"], t["max_seq_len"]),
                             params={k: torch.from_numpy(v) for k, v in params.items()},
                             device=device)
    prompts, lengths = _serve_ranks_inputs(t, lm.vocab_size)
    last, toks = _prefill_and_decode(program, prompts, lengths, SERVE_RANKS_STEPS)
    served = _traced_engine(program, _serve_ranks_requests(t, lm.vocab_size), t["window_steps"],
                            device)
    del program
    spec = MachineSpecification(1, 1, 4, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)
    workload = ServingWorkload(prompt_len=t["prompt_len"][1],
                               gen_len=sum(t["max_new_tokens"]) // 2, max_concurrent=t["slots"])
    tight, _ = _tight_serving_gb(lm_cfg, spec, workload)
    plan, secs = _serving_search(lm_cfg, spec, workload, tight, "analytic", device=device)
    strategies = {"searched4": os.path.join(tmp, "serve_searched4.json")}
    save_strategy(strategies["searched4"], plan.decode.pcg, plan.decode.machine_mapping,
                  plan.decode.runtime)
    decode_pcg = pcg_from_computation_graph(cg)
    for name, (dp, tp) in {"tp2": (1, 2), "dp2xtp2": (2, 2)}.items():
        pcg = tensor_parallel_seed(decode_pcg, tp)
        strategies[name] = os.path.join(tmp, f"serve_{name}.json")
        save_strategy(strategies[name], data_parallel_seed(pcg, dp) if dp > 1 else pcg, None)
    from flexflow_tpu_torch.compiler import parallel_degree_summary

    return dict(params=path, last=last, greedy=toks.tolist(), served=served,
                strategies=strategies, searched=dict(
                    winner=parallel_degree_summary(plan.decode.pcg), hbm_gb=tight,
                    ms_per_token=plan.ms_per_token, seconds=secs))


def phase_serve_ranks(smi: str, tmp: str, device: str = "cuda:0", lm_cfg: dict = SERVE_RANKS_LM,
                      t: dict = SERVE_RANKS_TRAFFIC) -> None:
    """SERVE_RANKS_LM (SERVE_LM's widths at 2 layers) served over 2 and 4
    gloo ranks sharing the card (f32, TF32 off) under the budgeted winner of
    a 4-device serving search, the forced tp2 plan (heads cut) and the
    forced dp2 x tp2 plan (slots and heads cut): every rank's greedy tokens
    equal the single-device program's, its prefill logits within
    SERVE_PARITY_BOUND, its cache allocation exactly per_device_cache_bytes,
    its engine trace the single-device engine's; the windows run eagerly
    (gloo) and no flash kernel launches."""
    import numpy as np
    import torch

    start = time.perf_counter()
    ref = _serve_ranks_reference(tmp, device, lm_cfg, t)
    for world in sorted(set(SERVE_RANKS_PLANS.values())):
        plans = [p for p, w in SERVE_RANKS_PLANS.items() if w == world]
        job = dict(name=f"serve_ranks{world}", mode="serve_ranks", plans=plans, device=device,
                   traffic=t, vocab=lm_cfg["vocab_size"], steps=SERVE_RANKS_STEPS,
                   params=ref["params"], strategies=ref["strategies"])
        ranks = run_ranks(world, job, tmp, worker=PLAN_RANK_WORKER)
        for plan in plans:
            last = torch.from_numpy(np.load(os.path.join(tmp, f"serve_ranks{world}.{plan}.last.npy")))
            rel = _rel(last, ref["last"])
            for r in ranks:
                got = r[plan]
                checks = {
                    "greedy_tokens": got["greedy"] == ref["greedy"],
                    "cache_bytes": got["cache_allocated"] == got["cache_priced"],
                    "engine_trace": got["engine"]["trace"] == ref["served"]["trace"],
                    "engine_tokens": got["engine"]["tokens"] == ref["served"]["tokens"],
                    "not_captured": got["captured"] is False,
                    "no_flash": not any(got["launches"].values()),
                }
                failed = [k for k, ok in checks.items() if not ok]
                if failed or not rel < SERVE_PARITY_BOUND:
                    raise AssertionError(f"serve_ranks {plan} rank {r['rank']}: failed {failed}, "
                                         f"prefill logits rel {rel}")
            first = ranks[0][plan]
            emit({"phase": "serve_ranks", "plan": plan, "ranks": world,
                  "sharing": f"{world} {SHARED}", "card": smi, "config": lm_cfg,
                  "traffic": t, "dtype": "f32", "tf32": False,
                  "searched": ref["searched"] if plan == "searched4" else None,
                  "prefill_logits_rel_err": rel, "bound": SERVE_PARITY_BOUND,
                  "tokens_equal_single_device": True, "trace_equal_single_device": True,
                  "cache_specs": first["cache_specs"],
                  "cache_bytes_per_rank": first["cache_allocated"],
                  "logits_cut_over_classes": first["class_cut"],
                  "whole_tensor_nodes": first["whole_nodes"], "captured": first["captured"],
                  "run_s": first["engine"]["run_s"],
                  "output_tokens_per_s": first["engine"]["output_tokens_per_s"],
                  "p50_ms_per_token": first["engine"]["p50_ms_per_token"],
                  "single_device_output_tokens_per_s": ref["served"]["output_tokens_per_s"],
                  "single_device_p50_ms_per_token": ref["served"]["p50_ms_per_token"],
                  "note": "gloo ranks share one card: ms/token and tokens/s measure host-staged "
                          "collectives of processes on one H100, not NVLink or NCCL"})
    emit({"phase": "serve_ranks_done", "seconds": time.perf_counter() - start})


def _check_plan_ops(smi, kind, world, cfg, single, ranks, got, device) -> None:
    """parity_plan_ops' checks of one plan against the single device, and
    its line."""
    import numpy as np

    def worst(tag):
        return max(float(np.linalg.norm(got[f"{tag}:{k}"] - v.numpy())
                         / max(np.linalg.norm(v.numpy()), 1e-30))
                   for k, v in single[tag].items())

    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], single["losses"]))
    grad_rel, param_rel = worst("grads"), worst("params")
    masks_equal = all(r["masks"] == single["masks"] for r in ranks)
    ok = {
        "losses": loss_rel < PLAN_OPS_BOUND, "grads": grad_rel < PLAN_OPS_BOUND,
        "params": param_rel < PLAN_OPS_BOUND,
        "ranks_agree": all(r["losses"] == ranks[0]["losses"] for r in ranks),
        "masks": masks_equal and (len(single["masks"]) > 0) == (kind == "dropout"),
        "class_sharded": bool(ranks[0]["class_axes"]) == (kind == "class_sharded"),
        "whole": (len(ranks[0]["whole"]) > 0) == (kind == "whole"),
    }
    failed = [k for k, v in ok.items() if not v]
    if failed:
        raise AssertionError(f"parity_plan_ops {kind}: failed {failed}: losses "
                             f"{ranks[0]['losses']} vs {single['losses']}, grads {grad_rel}, "
                             f"params {param_rel}")
    extra = {}
    if kind == "dropout":
        extra["mask_draw"] = _mask_draw_cost(cfg, device)
    emit({"phase": "parity_plan_ops", "plan": kind, "ranks": world, **extra,
          "sharing": f"{world} {SHARED}", "card": smi, "config": cfg, "dtype": "f32",
          "tf32": False, "losses": ranks[0]["losses"], "single_device_losses": single["losses"],
          "loss_rel_err": loss_rel, "grad_rel_err": grad_rel, "param_rel_err": param_rel,
          "bound": PLAN_OPS_BOUND, "masks_bitwise_equal": masks_equal,
          "masks": len(single["masks"]), "whole_tensor_nodes": len(ranks[0]["whole"]),
          "whole": ranks[0]["whole"], "class_axes": ranks[0]["class_axes"]})


def phase_parity_plan_ops(smi: str, tmp: str, device: str = "cuda:0", cfg: dict = PLAN_OPS
                          ) -> None:
    """The plan ops the executor lowered last, at the flagship's widths at 2
    layers (f32, TF32 off), each against the same model on one card: a
    dp2 x tp2 plan with Dropout(0.1) on 4 ranks (every step's masks
    bitwise the single device's, losses and parameters within
    PLAN_OPS_BOUND), logits that reach the loss cut over their classes on
    2 ranks, and a Linear whose ReLU acts on partial sums (a whole-tensor
    node) on 2 ranks (losses, first-step gradients and parameters within
    PLAN_OPS_BOUND)."""
    import numpy as np
    import torch

    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for world in sorted(set(PLAN_OPS_RANKS.values()), reverse=True):
        kinds = [k for k, w in PLAN_OPS_RANKS.items() if w == world]
        singles = {kind: _plan_ops_single(kind, device, cfg) for kind in kinds}
        job = dict(name=f"plan_ops{world}", mode="plan_ops", kinds=kinds, device=device, cfg=cfg)
        ranks = run_ranks(world, job, tmp, worker=PLAN_RANK_WORKER)
        for kind in kinds:
            _check_plan_ops(smi, kind, world, cfg, singles[kind],
                            [dict(r[kind], rank=r["rank"]) for r in ranks],
                            np.load(os.path.join(tmp, f"plan_ops{world}.{kind}.npz")), device)
    emit({"phase": "parity_plan_ops_done", "seconds": time.perf_counter() - start})


# fit_resume: the flagship at fit_window's K, checkpointing every window
RESUME_K = 8
RESUME_BATCHES = 16  # distinct batches an epoch; two epochs make run A's 4 windows
RESUME_EPOCHS = 2
RESUME_EVERY = 8
RESUME_FAULT_STEP = 20  # crossed inside window 3 (steps 17-24)
RESUME_KEEP = 2  # checkpoint_max_to_keep: two snapshots on disk
# the flagship's widths at 6 of its 12 layers: cut to keep the whole script
# near its time once the Ulysses and MoE phases joined it (every check
# holds at any depth; a snapshot is ~1.3 GB where 12 layers made ~2.2)
RESUME_LAYERS = 6
# run B's steps before the kill: the window that crosses the fault step
RESUME_FAULT_STEP_WINDOW = -(-RESUME_FAULT_STEP // RESUME_K) * RESUME_K


def _state_clone(m) -> dict:
    """Device copies of the parameters and both Adam moments, by flat key."""
    return {**{f"params/{k}": p.detach().clone() for k, p in m.params.items()},
            **{f"opt_state/{slot}/{k}": t.detach().clone()
               for slot in ("m", "v") for k, t in m.opt_state[slot].items()}}


def _state_bitwise(m, want: dict) -> list:
    """The flat keys of m's state that differ from `want` (empty: bitwise)."""
    import torch

    got = _state_clone(m)
    return sorted(k for k, v in want.items() if not torch.equal(got[k], v))


def _reset_state(m, init: dict) -> None:
    """Compile's state again, written in place (the captured graph stays
    valid), step count and all."""
    import torch

    with torch.no_grad():
        for key, p in m.params.items():
            p.copy_(init[key])
        for slot in ("m", "v"):
            for t in m.opt_state[slot].values():
                t.zero_()
        m.opt_state["step"].zero_()
    m._step_count = 0


def _writer_numbers(stats: list) -> dict:
    """The async writer's records: the training thread's stall per submit,
    the device-to-host copy, the serialization and the commit, and the
    writer's rates."""
    out = {"snapshots": [r["step"] for r in stats],
           "submit_stall_ms": [r["submit_ms"] for r in stats],
           "d2h_ms": [r["d2h_ms"] for r in stats],
           "serialize_s": [r["serialize_s"] for r in stats],
           "commit_s": [r["commit_s"] for r in stats]}
    # d2h_ms is None for a state that was on the host already
    out["d2h_gb_per_s"] = [r["bytes"] / (r["d2h_ms"] / 1e3) / 1e9 if r["d2h_ms"] else None
                           for r in stats]
    out["writer_gb_per_s"] = [
        r["bytes"] / ((r["d2h_ms"] or 0.0) / 1e3 + r["serialize_s"] + r["commit_s"]) / 1e9
        for r in stats]
    return out


def phase_fit_resume(smi: str, cfg=None, device: str = "cuda", k: int = RESUME_K,
                     batches: int = RESUME_BATCHES, every: int = RESUME_EVERY,
                     fault_step: int = RESUME_FAULT_STEP) -> dict:
    """The flagship's widths at RESUME_LAYERS layers (unless `cfg` is given)
    through FFModel at steps_per_dispatch=k (bf16,
    Adam(1e-4)), two shuffled epochs of `batches` seeded host batches: a
    warm-up window that captures the graph, then from compile's state each
    time (written back in place):

    - the fit without checkpointing (the overhead's baseline);
    - run A: the fit with async snapshots every `every` steps (the
      writer's numbers, the stall, the device copy's memory);
    - run B: the same with FF_TPU_FAULT_STEP crossed inside window 3,
      under the profiler (rows 1-3's launches): the fault propagates after
      the window's snapshot is durable;
    - the model whose graph was captured before resumes run B (a restore
      written in place, replayed by the old graph), and a new FFModel
      resumes it too (a graph of its own): every step's loss, the
      parameters and both Adam moments bitwise run A's;
    - one sync save_checkpoint and one load_checkpoint, timed.

    Returns rows 1-3's launches in run B (the profiler's count: a replayed
    graph runs no wrapper)."""
    import shutil

    import numpy as np
    import torch
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_cg
    from flexflow_tpu_torch.profile_step import device_trace
    from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager
    from flexflow_tpu_torch.runtime.fault import SimulatedFault
    from torch.autograd import DeviceType

    cfg = cfg or dict(FLAGSHIP, layers=RESUME_LAYERS)
    b, steps = cfg["batch"], batches * RESUME_EPOCHS
    start = time.perf_counter()

    def model():
        m = FFModel.from_computation_graph(
            *build_flagship_cg(**cfg), device=device,
            config=FFConfig(batch_size=b, seed=0, print_freq=0, steps_per_dispatch=k,
                            checkpoint_max_to_keep=RESUME_KEEP))
        m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy",
                  metrics=FIT_METRICS, compute_dtype=torch.bfloat16)
        return m

    m = model()
    init = {key: p.detach().clone() for key, p in m.params.items()}
    snapshot_bytes = sum(t.numel() * t.element_size() for t in _state_clone(m).values()) + 4
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batches * b, cfg["seq"], cfg["embed"]), dtype=np.float32)
    y = rng.integers(0, cfg["vocab"], (batches * b, cfg["seq"]), dtype=np.int32)
    tmp = tempfile.mkdtemp(prefix="fit_resume_")
    free = shutil.disk_usage(tmp).free
    need = (2 * (RESUME_KEEP + 1) + 1) * snapshot_bytes  # runs A and B, and one save
    if free < need:
        raise AssertionError(f"fit_resume: {tmp} has {free} bytes free, the phase writes up to "
                             f"{need}")
    try:
        m.fit(x[:k * b], y[:k * b], epochs=1, shuffle=False, verbose=False)  # the capture
        torch.cuda.synchronize()

        def run(**kw):
            _reset_state(m, init)
            losses = _record_window_losses(m)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m.fit(x, y, epochs=RESUME_EPOCHS, shuffle=True, verbose=False, **kw)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            del m.instance.multi_train_step
            return torch.cat(losses), elapsed * 1e3 / steps, torch.cuda.max_memory_allocated()

        _, plain_ms, plain_peak = run()
        dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        ref_losses, ckpt_ms, ckpt_peak = run(checkpoint_dir=dir_a, checkpoint_every_n_steps=every)
        writer = m.checkpointer.writer
        numbers = _writer_numbers(m.checkpointer.stats)
        if numbers["snapshots"] != list(range(every, steps + 1, every)):
            raise AssertionError(f"fit_resume: run A's snapshots {numbers['snapshots']}")
        want = _state_clone(m)
        shutil.rmtree(dir_a)

        # run B, killed, under the profiler
        _reset_state(m, init)
        b_losses = _record_window_losses(m)
        fa.reset_launch_counts()
        os.environ["FF_TPU_FAULT_STEP"] = str(fault_step)
        try:
            with device_trace() as prof:
                try:
                    m.fit(x, y, epochs=RESUME_EPOCHS, shuffle=True, verbose=False,
                          checkpoint_dir=dir_b, checkpoint_every_n_steps=every)
                    raise AssertionError("fit_resume: run B was not killed")
                except SimulatedFault as e:
                    killed_at = e.step
                    durable = CheckpointManager(dir_b).all_steps()
        finally:
            del os.environ["FF_TPU_FAULT_STEP"]
        del m.instance.multi_train_step
        killed_window = -(-fault_step // k) * k
        if killed_at != killed_window or durable[-1] != killed_window:
            raise AssertionError(f"fit_resume: killed after step {killed_at}, snapshots "
                                 f"{durable} when the fault propagated (expected "
                                 f"{killed_window} both)")
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        flash = {e.key: e.count for e in kernels if e.key.startswith(("ff_flash_", "ff_ring_"))}
        want_launches = {name: cfg["layers"] * killed_window for name in FIT_WINDOW_KERNELS}
        if flash != want_launches or any(_flash_launches().values()):
            raise AssertionError(f"fit_resume: run B's trace counts {flash} (expected "
                                 f"{want_launches}), wrapper counts {_flash_launches()}")
        b_losses = torch.cat(b_losses)

        def resumed(model_, what):
            losses = _record_window_losses(model_)
            t0 = time.perf_counter()
            model_.fit(x, y, epochs=RESUME_EPOCHS, shuffle=True, verbose=False,
                       checkpoint_dir=dir_b, checkpoint_every_n_steps=every, resume=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            del model_.instance.multi_train_step
            got = torch.cat(losses)
            differ = _state_bitwise(model_, want)
            if not (torch.equal(got, ref_losses[killed_window:]) and not differ
                    and model_._step_count == steps):
                raise AssertionError(f"fit_resume: {what} is not run A's: losses {got.tolist()} "
                                     f"vs {ref_losses[killed_window:].tolist()}, state keys "
                                     f"differing {differ[:8]}")
            return seconds

        if not torch.equal(b_losses, ref_losses[:killed_window]):
            raise AssertionError("fit_resume: run B's losses before the kill are not run A's")
        captures = m.instance.graphs.captures
        _reset_state(m, init)  # the restore must overwrite all of it
        old_graph_s = resumed(m, "the resume replayed by the graph captured before it")
        if m.instance.graphs.captures != captures:
            raise AssertionError("fit_resume: the resume recaptured the window")
        # the same directory again: fit(resume=True) wrote the last window's
        # snapshot, so drop it to resume from the killed window again
        shutil.rmtree(os.path.join(dir_b, f"step_{steps}"), ignore_errors=True)

        t0 = time.perf_counter()
        saved = m.save_checkpoint(os.path.join(tmp, "sync"), max_to_keep=1)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        m.load_checkpoint(os.path.join(tmp, "sync"))
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        if _state_bitwise(m, want):
            raise AssertionError("fit_resume: save_checkpoint then load_checkpoint changed the "
                                 "state")
        shutil.rmtree(saved)
        del m, writer
        torch.cuda.empty_cache()
        fresh = model()
        new_model_s = resumed(fresh, "the new FFModel's resume")
        del fresh
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({
        "phase": "fit_resume", "config": cfg, "card": smi, "compute_dtype": "bf16",
        "optimizer": "adam(alpha=1e-4)", "steps_per_dispatch": k, "steps": steps,
        "epochs": RESUME_EPOCHS, "checkpoint_every_n_steps": every, "async": True,
        "snapshot_bytes": snapshot_bytes, "filesystem_free_bytes": free,
        "checkpoint_dir_is": "a temporary directory (TMPDIR), page cache warm",
        "step_ms_without_checkpoints": plain_ms, "step_ms_with_async_checkpoints": ckpt_ms,
        "async_checkpoint_overhead_pct": (ckpt_ms - plain_ms) / plain_ms * 100.0,
        "step_ms_is": "each fit's elapsed / steps, ending in one synchronize",
        "writer": numbers, "device_copy_bytes": snapshot_bytes - 4,
        "peak_memory_added_bytes": ckpt_peak - plain_peak,
        "sync_save_checkpoint_ms": save_ms, "load_checkpoint_ms": load_ms,
        "killed_after_step": killed_at, "fault_step": fault_step,
        "snapshots_durable_at_the_fault": durable,
        "resume_seconds": {"graph_captured_before": old_graph_s, "new_ffmodel": new_model_s},
        "bitwise_equal_to_run_a": {"losses": True, "params": True, "adam_moments": True},
        "run_b_launches": flash, "seconds": time.perf_counter() - start,
    })
    return {wrapper: flash[name] for name, wrapper in FIT_WINDOW_KERNELS.items()}


CHAOS_BATCH, CHAOS_STEPS_PER_EPOCH, CHAOS_EVERY = 16, 8, 4
CHAOS_WATCHDOG = 50.0  # a budget of max(1000 ms, 50 x the window estimate), the serving tests'


def phase_chaos(smi: str, device: str = "cuda") -> None:
    """runtime.chaos.soak_sites on the card: the Dropout MLP of
    parity_fit_window (f32) fit two epochs of 8 shuffled batches with
    snapshots every 4 steps, a metrics stream and the `raise` health
    policy, in windows of 4 (captured graphs, the windowed input pipeline)
    over ckpt_write, h2d, nonfinite, hang and kill, and per step over all
    but h2d (which lives in the windowed pipeline's producer): every
    schedule fires and recovers to final parameters and Adam moments
    bitwise the fault-free run's."""
    import numpy as np
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.runtime.chaos import SOAK_SITES, soak_sites

    start = time.perf_counter()
    rs = np.random.RandomState(0)
    n = CHAOS_BATCH * CHAOS_STEPS_PER_EPOCH
    x, y = rs.randn(n, 32).astype(np.float32), rs.randint(0, 10, n)

    def builder(k):
        def build(metrics_dir, checkpoint_dir, watchdog=False):
            m = FFModel(FFConfig(batch_size=CHAOS_BATCH, seed=0, steps_per_dispatch=k,
                                 print_freq=0, metrics_dir=metrics_dir, health_policy="raise",
                                 checkpoint_dir=checkpoint_dir,
                                 checkpoint_every_n_steps=CHAOS_EVERY,
                                 watchdog_factor=CHAOS_WATCHDOG if watchdog else 0.0),
                        device=device)
            h = m.dense(m.create_tensor([CHAOS_BATCH, 32], name="x"), 32, use_bias=False,
                        name="fc1")
            m.dense(m.dropout(m.relu(h), 0.1), 10, use_bias=False, name="head")
            m.compile(AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy",
                      metrics=["accuracy"])
            return m

        return build

    out = {}
    for k, sites in ((4, SOAK_SITES), (1, tuple(s for s in SOAK_SITES if s != "h2d"))):
        t0 = time.perf_counter()
        result = soak_sites(builder(k), x, y, total_steps=2 * CHAOS_STEPS_PER_EPOCH,
                            checkpoint_every=CHAOS_EVERY, sites=sites)
        bad = [r for r in result["schedules"] if not (r["fired"] and r["recovered_bitwise"])]
        if bad or result["n_schedules"] != len(sites):
            raise AssertionError(f"chaos K={k}: {bad or result}")
        out[f"k{k}"] = {"sites": {r["sites"][0]: {key: r[key] for key in (
            "spec", "fired", "outcome", "resumed", "recovered_bitwise")}
            for r in result["schedules"]}, "seconds": time.perf_counter() - t0}
    emit({"phase": "chaos", "card": smi, "model": "32-32 relu dropout(0.1)-10, batch 16, f32",
          "optimizer": "adam(alpha=1e-2)", "steps": 2 * CHAOS_STEPS_PER_EPOCH,
          "checkpoint_every_n_steps": CHAOS_EVERY, "watchdog_factor": CHAOS_WATCHDOG,
          "watchdog_min_budget_ms": 1000.0, "soaks": out,
          "seconds": time.perf_counter() - start})


# resume_ranks: the small flagship under the forced tp2 plan on 2 ranks
RESUME_RANKS = dict(TP_PARITY)
RESUME_RANKS_K, RESUME_RANKS_EVERY, RESUME_RANKS_FAULT = 2, 2, 5
RESUME_RANKS_BATCHES, RESUME_RANKS_EPOCHS = 4, 2


def phase_resume_ranks(smi: str, tmp: str, device: str = "cuda:0", cfg: dict = RESUME_RANKS):
    """FFModel on 2 ranks sharing the card over gloo under the forced tp2
    plan (dp1xtp2xsp1) of the small flagship (bf16, windows of 2 run
    eagerly under gloo, snapshots every 2 steps): a fit killed by
    FF_TPU_FAULT_STEP and resumed by a new FFModel is bitwise the
    uninterrupted fit on every rank (each step's loss, the gathered
    parameters and Adam moments); rank 0 alone writes; rows 9-11 launch
    once per layer per step on each rank; the final 2-rank checkpoint
    restores into a single-device FFModel on the card with every parameter
    equal. Returns rows 9-11's launches summed over the ranks."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import build_flagship_cg

    start = time.perf_counter()
    work = os.path.join(tmp, "resume_ranks")
    steps = RESUME_RANKS_BATCHES * RESUME_RANKS_EPOCHS
    ranks = run_ranks(2, dict(name="resume_ranks", mode="resume", cfg=cfg, device=device,
                              alpha=1e-4, k=RESUME_RANKS_K, every=RESUME_RANKS_EVERY,
                              fault_step=RESUME_RANKS_FAULT, batches=RESUME_RANKS_BATCHES,
                              epochs=RESUME_RANKS_EPOCHS, seed="dp1xtp2xsp1", work=work), tmp)
    killed_window = -(-RESUME_RANKS_FAULT // RESUME_RANKS_K) * RESUME_RANKS_K
    for r in ranks:
        res = r["resume"]
        losses = res["losses"]
        if not (res["outcome"] == "SimulatedFault" and res["bitwise"] == [True, True]
                and res["steps"] == steps and res["kind"] == "DistributedTrainingInstance"
                and losses["killed"] == losses["ref"][:killed_window]
                and losses["resumed"] == losses["ref"][killed_window:]):
            raise AssertionError(f"resume_ranks rank {r['rank']}: {res}")
        writes = res["writes"]
        want = (dict(writer=True, snapshots=list(range(RESUME_RANKS_EVERY, killed_window + 1,
                                                       RESUME_RANKS_EVERY)))
                if r["rank"] == 0 else dict(writer=False, snapshots=[]))
        if writes != want:
            raise AssertionError(f"resume_ranks rank {r['rank']}: writes {writes}, "
                                 f"expected {want}")
        r["card"] = res["card"]
    # the killed and the resumed fit: every step once
    counts = _check_rank_launches("resume_ranks", ranks, cfg["layers"], steps)
    m = FFModel.from_computation_graph(
        *build_flagship_cg(**cfg), device=device.split(":")[0],
        config=FFConfig(batch_size=cfg["batch"], seed=0, print_freq=0, max_devices=1))
    m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy")
    if m.load_checkpoint(os.path.join(work, "final")) != steps:
        raise AssertionError("resume_ranks: the final checkpoint's step")
    want = np.load(os.path.join(work, "final_params.npz"))
    differ = [k for k in want.files
              if not np.array_equal(m.params[k].detach().cpu().numpy(), want[k])]
    if differ or set(want.files) != set(m.params):
        raise AssertionError(f"resume_ranks: the single-device restore differs at {differ}")
    del m
    torch.cuda.empty_cache()
    first = ranks[0]["resume"]
    emit({"phase": "resume_ranks", "ranks": 2, "sharing": f"2 {SHARED}", "card": smi,
          "config": cfg, "plan": first["plan"], "forced_seed": "dp1xtp2xsp1",
          "compute_dtype": "bf16", "steps_per_dispatch": RESUME_RANKS_K,
          "checkpoint_every_n_steps": RESUME_RANKS_EVERY, "fault_step": RESUME_RANKS_FAULT,
          "steps": steps, "losses": first["losses"]["ref"], "bitwise_equal": True,
          "writes_by_rank": [r["resume"]["writes"] for r in ranks],
          "single_device_restore": "every parameter equal",
          "launches_per_rank": first["card"]["launches"],
          "rank_seconds": [r["resume"]["seconds"] for r in ranks],
          "seconds": time.perf_counter() - start})
    return counts


# --- pipeline parallelism and sub-mesh branches (A10): one rank job per
# rank count carries both phases

PP_TRUNK = dict(batch=64, dim=1024, layers=4)  # examples/mlp.py's trunk at its defaults
PP_SEEDS = {2: "pp2m4", 4: "pp2m4xdp2"}
PP_STEPS = 5  # timed steps after one warm-up
PP_CHECK_STEPS = 2  # steps of the 1F1B-against-sequential check
PP_WINDOW_K = 4
PP_PARITY_BOUND = PARITY_BOUND  # relative, each step's loss, bf16 card vs f32 CPU
# the worst tensor's norm-relative difference after the warm-up and PP_STEPS
# steps, the card's stages (bf16) against the flat executor on one CPU
# device (f32), for the parameters and each Adam slot. On an H100 the sound
# run read at most 0.230 / 0.258 / 0.164 (a zero-initialized bias, which
# Adam moves by about alpha whichever way a near-zero gradient's sign falls)
# and a backward reading the other stash slot at least 1.181 / 1.218 / 1.033
# (`tests/torch_port_probes.py pp-fault`, 2 and 4 ranks; PERF.md section 6)
PP_STATE_BOUND = dict(params=0.5, m=0.5, v=0.5)
SUBMESH_STEPS = 2
SUBMESH_BOUND = 1e-4  # relative: losses and parameters, f32 (TF32 off), ranks vs one card
SUBMESH_BATCH = 16
# the JAX package's `bench.py --pipeline` proxy: a uniform 8-layer dense chain
# of width 256 at batch 64, whose flat plans all peak above the pipelined ones
PP_PROXY = dict(layers=8, dim=256, batch=64)
PP_RESULTS = {}  # world -> the pipeline job's ranks, read by fit_submesh

PP_RANK_WORKER = r'''
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, world, job = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
from flexflow_tpu_torch import core, pcg
from flexflow_tpu_torch.analysis.memory_analysis import analyze_memory
from flexflow_tpu_torch.interop import submesh_params_to_numpy
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.local_execution import ModelTrainingInstance
from flexflow_tpu_torch.local_execution.training_backing import param_key
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs, WeightAttrs
from flexflow_tpu_torch.parallel import init_file_group
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
from flexflow_tpu_torch.pcg.optimizer import SGDOptimizerAttrs

device = init_file_group(job["store"], rank, world, device=job["device"], backend="gloo",
                         timeout_s=job["timeout_s"])
card = device.type == "cuda"
out = {"rank": rank}


def sync():
    if card:
        torch.cuda.synchronize(device)


def launches():
    return {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}


# -- train_pp: the MLP trunk through FFModel on a forced pipelined plan -----
t = job["trunk"]


def trunk(on, dtype):
    m = core.FFModel(core.FFConfig(batch_size=t["batch"], seed=0, print_freq=0, search_budget=1,
                                   pipeline=True, force_strategy_seed=job["seed"]), device=on)
    h = m.create_tensor([t["batch"], t["dim"]], name="x")
    for i in range(t["layers"]):
        h = m.relu(m.dense(h, t["dim"], name=f"fc{i}"))
    m.compile(core.AdamOptimizer(alpha=1e-3), "sparse_categorical_crossentropy",
              logit_tensor=h, compute_dtype=dtype)
    return m, h


def by_name(inst, stacked):
    """Stacked [S, ...] state keyed by each stage's weight's layer name."""
    return {inst.pcg.layer_attrs(n).name: np.asarray(stacked[k][s])
            for s, nodes in enumerate(inst.structure.weight_nodes)
            for k, n in zip(inst.template_keys, nodes)}


gen = torch.Generator().manual_seed(3)
batches = [(torch.randn(t["batch"], t["dim"], generator=gen),
            torch.randint(0, t["dim"], (t["batch"],), generator=gen))
           for _ in range(1 + job["steps"])]


def steps(m, run):
    rng = torch.Generator(device=m.device).manual_seed(0)
    losses, ms = [], []
    for x, y in run:
        x, y = x.to(m.device), y.to(m.device)
        sync()
        t0 = time.perf_counter()
        m.params, m.opt_state, loss, _ = m.instance.train_step(m.params, m.opt_state, {"x": x},
                                                               y, rng)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    return losses, ms


def same(a, b):
    return all(np.array_equal(a["params"][k], b["params"][k])
               and all(np.array_equal(a["opt_state"][s][k], b["opt_state"][s][k])
                       for s in ("m", "v"))
               for k in a["params"]) and int(a["opt_state"]["step"]) == int(b["opt_state"]["step"])


start = time.perf_counter()
m, _ = trunk(job["device"], torch.bfloat16 if card else None)
inst = m.instance
res = dict(kind=type(inst).__name__, pipeline=(m.search_provenance or {}).get("pipeline"),
           stage=getattr(inst, "stage", None))
if card:
    # what the stage's state holds before a step (parameters and optimizer
    # state), beside the peak the steps reach
    sync()
    res["memory_allocated_before_steps"] = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
fa.reset_launch_counts()
warm, _ = steps(m, batches[:1])
pipe_losses, pipe_ms = steps(m, batches[1:])
res["launches"] = launches()
res["max_memory_allocated"] = torch.cuda.max_memory_allocated(device) if card else None
spec = MachineSpecification(1, 1, world, 25.0, 400.0)
res["stash_model_peak"] = analyze_memory(inst.pcg, spec, None, optimizer_state_slots=2
                                         ).per_device[rank].peak_bytes
res["losses"] = warm + pipe_losses
res["step_ms"] = pipe_ms
# the stages' parameters and Adam state after those steps, by layer name
after = inst.stacked_state(m.params, m.opt_state)
after = {"params": by_name(inst, after["params"]),
         **{s: by_name(inst, after["opt_state"][s]) for s in ("m", "v")}}
# the sequential schedule's steps, on the same batches
inst.schedule_name = "sequential"
seq_losses, seq_ms = steps(m, batches[1:])
inst.schedule_name = "1f1b"
res["sequential_step_ms"] = seq_ms
res["sequential_finite"] = bool(np.isfinite(seq_losses).all())
# bitwise: 1F1B against the sequential schedule, and a window against its steps
init = inst.stacked_state(m.params, m.opt_state)


def reset():
    inst.load_stacked_state(m.params, m.opt_state, init["params"], init["opt_state"])


reset()
one, _ = steps(m, batches[1:1 + job["check_steps"]])
s_one = inst.stacked_state(m.params, m.opt_state)
reset()
inst.schedule_name = "sequential"
seq, _ = steps(m, batches[1:1 + job["check_steps"]])
schedule = inst.schedule_name
inst.schedule_name = "1f1b"
s_seq = inst.stacked_state(m.params, m.opt_state)
res["bitwise_sequential"] = [one == seq, same(s_one, s_seq), schedule]
k = job["window_k"]
reset()
per_step, _ = steps(m, batches[1:1 + k])
s_steps = inst.stacked_state(m.params, m.opt_state)
reset()
rng = torch.Generator(device=m.device).manual_seed(0)
xs = torch.stack([x for x, _ in batches[1:1 + k]]).to(m.device)
ys = torch.stack([y for _, y in batches[1:1 + k]]).to(m.device)
m.params, m.opt_state, rng, lvec, _ = inst.multi_train_step(m.params, m.opt_state, {"x": xs},
                                                            ys, rng)
res["bitwise_window"] = [per_step == lvec.tolist(),
                         same(s_steps, inst.stacked_state(m.params, m.opt_state)),
                         inst.last_window]
res["p2p_transfers"] = inst.p2p.count
del m, inst
if card:
    torch.cuda.empty_cache()
# the same steps on the CPU in f32
cpu, logit = trunk("cpu", None)
init = by_name(cpu.instance, cpu.instance.stacked_state(cpu.params)["params"])
cpu_losses, _ = steps(cpu, batches)
res["cpu_losses"] = cpu_losses
if rank == 0:
    # the flat executor on one CPU device from the same initial weights and
    # batches, f32: a reference that shares no code with the 1F1B lowering
    flat = ModelTrainingInstance(cpu.cg, logit.handle, cpu.loss_attrs, cpu.optimizer_attrs,
                                 device="cpu")
    p, o = flat.initialize(seed=0)
    name_of = {param_key(n): cpu.cg.layer_attrs(n).name
               for n in cpu.cg.topological_ordering()
               if isinstance(cpu.cg.op_attrs(n), WeightAttrs)}
    with torch.no_grad():
        for k, v in p.items():
            v.copy_(torch.as_tensor(init[name_of[k]]))
    flat_losses = []
    for x, y in batches:
        p, o, loss, _ = flat.train_step(p, o, {"x": x}, y)
        flat_losses.append(float(loss))
    ref = {"params": p, "m": o["m"], "v": o["v"]}

    def gap(slot):
        """The worst tensor's norm-relative difference, card against the
        flat reference."""
        return max(float(np.linalg.norm(after[slot][name_of[k]].astype(np.float64)
                                        - t.double().numpy())
                         / max(float(t.double().norm()), 1e-30))
                   for k, t in ref[slot].items())

    res["flat_losses"] = flat_losses
    res["state_rel"] = {slot: gap(slot) for slot in ref}
    res["state_compared"] = sorted(name_of.values()) == sorted(after["params"])
del cpu
res["seconds"] = time.perf_counter() - start
out["train_pp"] = res

# -- fit_submesh: the two-tower graph on groups of ranks, f32, TF32 off ----
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
start = time.perf_counter()
B = job["submesh_batch"]
m = core.FFModel(core.FFConfig(batch_size=B, seed=0, print_freq=0, submesh_branches=True),
                 device=job["device"])
x = m.create_tensor([B, 64], name="x")
t0 = m.dense(x, 64, use_bias=False, name="fc0")
a1, a2 = m.split(t0, [32, 32], axis=1)
h1 = m.dense(m.relu(m.dense(a1, 128, use_bias=False, name="a_w1")), 64, use_bias=False,
             name="a_w2")
h2 = m.dense(a2, 64, use_bias=False, name="b_w1")
logits = m.dense(m.add(h1, h2, name="merge"), 8, use_bias=False, name="head")
m.compile(core.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", logit_tensor=logits)
inst = m.instance
gen = torch.Generator().manual_seed(4)
xv, yv = torch.randn(B, 64, generator=gen), torch.randint(0, 8, (B,), generator=gen)
fa.reset_launch_counts()
losses = []
for _ in range(job["submesh_steps"]):
    m.params, m.opt_state, loss, _ = inst.train_step(m.params, m.opt_state,
                                                     {"x": xv.to(m.device)}, yv.to(m.device))
    losses.append(float(loss))
sync()
sub = dict(kind=type(inst).__name__, losses=losses, islands=sorted(m.params),
           groups=inst.branch_ranks, devices=sorted({str(p.device) for i in m.params.values()
                                                      for p in i.values()}),
           prov=m.search_provenance, launches=launches(), p2p_transfers=inst.p2p.count)
final = submesh_params_to_numpy(inst, m.params)
sub["eval_all"] = int(m.eval(x=xv.numpy(), y=yv.numpy()).train_all)
if rank == 0:
    # one card's steps from the same initial values (the graph's initializers)
    one = ModelTrainingInstance(m.cg, logits.handle, SparseCategoricalCrossEntropyLossAttrs(),
                                SGDOptimizerAttrs(lr=0.05), device=job["device"])
    p, o = one.initialize(seed=0)
    ref = []
    for _ in range(job["submesh_steps"]):
        p, o, loss, _ = one.train_step(p, o, {"x": xv.to(device)}, yv.to(device))
        ref.append(float(loss))
    flat = {k: v for island in final.values() for k, v in island.items()}
    sub["one_card_losses"] = ref
    sub["param_rel"] = max(float(np.linalg.norm(flat[k] - p[k].detach().cpu().numpy())
                                 / max(np.linalg.norm(p[k].detach().cpu().numpy()), 1e-30))
                           for k in p)
    sub["params_compared"] = sorted(p) == sorted(flat)
sub["seconds"] = time.perf_counter() - start
out["fit_submesh"] = sub
with open(f"{job['out']}.rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def _pp_host_search(trunk: dict = PP_TRUNK, proxy: dict = PP_PROXY) -> dict:
    """The budgeted search with pipeline seeds for 8 H100s (analytic at the
    H100 peaks, host only): every flat and pipeline seed of the trunk and
    of bench.py --pipeline's proxy priced with its per-device peak (the
    stash model, analysis/memory_analysis.py), then, where the best
    pipelined peak is below the best flat one, a search under the budget
    between them, which must pick a pipelined plan."""
    from flexflow_tpu_torch import compiler as T
    from flexflow_tpu_torch.analysis.memory_analysis import analyze_memory
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.compiler.unity_algorithm import enumerate_pipeline_seeds, enumerate_seeds
    from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph
    from flexflow_tpu_torch.pcg.pipeline import analyze_pipeline
    from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules

    spec = MachineSpecification(1, 1, SEARCH_NODE_GPUS, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)

    def ctx(budget=0.0):
        est = T.AnalyticGPUCostEstimator(spec, PEAK_BF16, PEAK_BYTES / 1e9)
        return T.MachineMappingContext(est, T.make_default_allowed_machine_views(),
                                       overlap_fraction=0.5, memory_budget_bytes=budget,
                                       optimizer_state_slots=2, steps_per_dispatch=1)

    def graph(c):
        b = ComputationGraphBuilder()
        h = b.create_input([c["batch"], c["dim"]], name="x")
        for i in range(c["layers"]):
            h = b.relu(b.dense(h, c["dim"], name=f"fc{i}"))
        return pcg_from_computation_graph(b.graph)

    out = {}
    for name, c in (("trunk", trunk), ("proxy", proxy)):
        pcg, t0 = graph(c), time.perf_counter()
        seeds = {}
        for label, seed in (list(enumerate_seeds(pcg, spec.num_devices))
                            + list(enumerate_pipeline_seeds(pcg, spec.num_devices))):
            r = T.evaluate_pcg(seed, ctx(), spec, T.MachineMappingCache())
            if r is not None:
                seeds[label] = dict(ms=r.runtime, peak_bytes=analyze_memory(
                    seed, spec, r.machine_mapping).max_peak_bytes())
        pipe = min((v["peak_bytes"], k) for k, v in seeds.items() if k.startswith("pp"))
        flat = min((v["peak_bytes"], k) for k, v in seeds.items() if not k.startswith("pp"))
        row = dict(config=c, seeds=seeds, best_pipelined_peak=pipe, best_flat_peak=flat)
        if pipe[0] < flat[0]:
            budget = (pipe[0] + flat[0]) / 2
            res = T.graph_optimize(pcg, ctx(budget), spec,
                                   generate_parallelization_rules([2, 4, 8], enable_pipeline=True),
                                   T.OptimizerConfig(budget=1, pipeline_seeds=True))
            region = analyze_pipeline(res.pcg)
            if region is None or not region.ok or res.serial_runtime is not None:
                raise AssertionError(f"train_pp: the {name}'s budgeted search picked no "
                                     f"pipelined plan under {budget} bytes")
            row.update(budget_bytes=budget, winner=f"pp{region.num_stages}m"
                       f"{region.num_microbatches}", winner_estimated_ms=res.runtime,
                       winner_degrees=T.parallel_degree_summary(res.pcg))
        else:
            row["note"] = ("the best flat plan peaks below every pipelined one: no budget "
                           "between them admits a pipelined plan alone")
        row["seconds"] = time.perf_counter() - t0
        out[name] = row
    if "winner" not in out["proxy"]:
        raise AssertionError("train_pp: bench.py --pipeline's proxy selected no pipelined plan")
    return out


def pp_job(world: int, seed: str, device: str, trunk: dict = PP_TRUNK) -> dict:
    """The rank job of train_pp and fit_submesh for `world` ranks."""
    return dict(name=f"pp{world}", device=device, seed=seed, trunk=trunk, steps=PP_STEPS,
                check_steps=PP_CHECK_STEPS, window_k=PP_WINDOW_K,
                timeout_s=RANK_TIMEOUT_S / 2, submesh_batch=SUBMESH_BATCH,
                submesh_steps=SUBMESH_STEPS)


def phase_train_pp(smi: str, tmp: str, device: str = "cuda:0", trunk: dict = PP_TRUNK,
                   proxy: dict = PP_PROXY) -> None:
    """The MLP trunk (examples/mlp.py's 4 x dense(1024) + ReLU at batch 64,
    ending at its last hidden layer: the 1F1B executor takes no head of
    another width) through FFModel(pipeline=True) forced to pp2m4 on 2
    ranks and pp2m4 x dp2 on 4, sharing the card over gloo, bf16,
    Adam(1e-3): the compile picks the 1F1B executor with the JAX package's
    provenance, a warm-up and PP_STEPS steps finite and within
    PP_PARITY_BOUND of the same steps on the CPU in f32, the stages'
    parameters and Adam state after them within PP_STATE_BOUND of the flat
    executor's on one CPU device, the 1F1B steps bitwise the sequential
    schedule's and a K=4 window bitwise its 4 steps; printed: both
    schedules' step ms, the measured bubble beside b(S, M) (None, flagged,
    where the two step times fit no tick model), each rank's max_memory_allocated beside the stash model's
    peak, and the host-only budgeted search. One rank job per rank count
    also carries fit_submesh's work."""
    from flexflow_tpu_torch.parallel.pipeline import measured_bubble_fraction
    from flexflow_tpu_torch.pcg.pipeline import pipeline_bubble_fraction

    start = time.perf_counter()
    search = _pp_host_search(trunk, proxy)
    rows = []
    for world, seed in PP_SEEDS.items():
        ranks = run_ranks(world, pp_job(world, seed, device, trunk), tmp, worker=PP_RANK_WORKER)
        PP_RESULTS[world] = ranks
        S, M = 2, 4
        for r in ranks:
            pp = r["train_pp"]
            want = {"num_stages": S, "num_microbatches": M,
                    "mesh": {"stage": S, "data": world // S}, "executor": "1f1b"}
            if pp["kind"] != "PipelinedTrainingInstance" or pp["pipeline"] != want:
                raise AssertionError(f"train_pp rank {r['rank']}: compiled {pp['kind']} "
                                     f"{pp['pipeline']}, expected the 1F1B executor {want}")
            if not all(math.isfinite(v) for v in pp["losses"]):
                raise AssertionError(f"train_pp rank {r['rank']}: losses {pp['losses']}")
            rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(pp["losses"],
                                                                  pp["cpu_losses"])]
            if max(rel) > PP_PARITY_BOUND:
                raise AssertionError(f"train_pp rank {r['rank']}: card {pp['losses']} against "
                                     f"CPU {pp['cpu_losses']}")
            if r["rank"] == 0:
                over = {k: v for k, v in pp["state_rel"].items() if not v <= PP_STATE_BOUND[k]}
                if over or not pp["state_compared"]:
                    raise AssertionError(f"train_pp: the stages' state against the flat "
                                         f"executor {pp['state_rel']}, bounds {PP_STATE_BOUND}")
            if pp["bitwise_sequential"] != [True, True, "sequential"]:
                raise AssertionError(f"train_pp rank {r['rank']}: 1F1B against the sequential "
                                     f"schedule {pp['bitwise_sequential']}")
            if pp["bitwise_window"][:2] != [True, True]:
                raise AssertionError(f"train_pp rank {r['rank']}: the K={PP_WINDOW_K} window "
                                     f"{pp['bitwise_window']}")
            if any(pp["launches"].values()):
                raise AssertionError(f"train_pp rank {r['rank']}: flash launches "
                                     f"{pp['launches']} on a path with no attention")
        pipe_ms = statistics.median(max(r["train_pp"]["step_ms"][i] for r in ranks)
                                    for i in range(PP_STEPS))
        seq_ms = statistics.median(max(r["train_pp"]["sequential_step_ms"][i] for r in ranks)
                                   for i in range(PP_STEPS))
        first = ranks[0]["train_pp"]
        # None where the step times fit no tick model (a clamp engaged)
        bubble = measured_bubble_fraction(S, M, pipe_ms, seq_ms)
        rows.append(dict(
            ranks=world, seed=seed, mesh=first["pipeline"]["mesh"], losses=first["losses"],
            cpu_losses=first["cpu_losses"], step_ms_1f1b=pipe_ms, step_ms_sequential=seq_ms,
            step_ms_1f1b_by_step=[max(r["train_pp"]["step_ms"][i] for r in ranks)
                                  for i in range(PP_STEPS)],
            bubble_predicted=pipeline_bubble_fraction(S, M),
            bubble_measured=bubble, bubble_clamped=bubble is None,
            state_rel_flat=first["state_rel"], flat_losses=first["flat_losses"],
            max_memory_allocated=[r["train_pp"]["max_memory_allocated"] for r in ranks],
            memory_allocated_before_steps=[r["train_pp"].get("memory_allocated_before_steps")
                                           for r in ranks],
            stash_model_peak=[r["train_pp"]["stash_model_peak"] for r in ranks],
            stage_of_rank=[r["train_pp"]["stage"] for r in ranks],
            p2p_transfers=[r["train_pp"]["p2p_transfers"] for r in ranks],
            window=first["bitwise_window"][2], rank_seconds=[r["train_pp"]["seconds"]
                                                               for r in ranks]))
    emit({"phase": "train_pp", "card": smi, "sharing": SHARED, "trunk": trunk,
          "compute_dtype": "bf16", "optimizer": "Adam(1e-3)", "runs": rows,
          "bitwise_equal_sequential": True, "window_bitwise_equal": True,
          "parity_bound": PP_PARITY_BOUND, "state_bound": PP_STATE_BOUND,
          "search_8_h100": search,
          "seconds": time.perf_counter() - start})


def phase_fit_submesh(smi: str) -> None:
    """The two-tower graph of tests/test_submesh.py through
    FFModel(submesh_branches=True) on 2 and 4 ranks sharing the card (f32,
    TF32 off), from train_pp's rank jobs: SUBMESH_STEPS SGD steps' losses
    and every parameter within SUBMESH_BOUND of one card's steps from the
    same values, each branch's parameters only on its group, the
    resource-split pricing recorded, eval runs, no flash launch."""
    if not PP_RESULTS:
        raise AssertionError("fit_submesh reads train_pp's rank jobs: add train_pp to --phases")
    rows = []
    for world, ranks in PP_RESULTS.items():
        ref = ranks[0]["fit_submesh"]
        half = world // 2
        for r in ranks:
            sub = r["fit_submesh"]
            mine = 0 if r["rank"] < half else 1
            if (sub["kind"] != "SubmeshBranchInstance"
                    or sub["islands"] != sorted(["pre", "post", f"branch{mine}"])
                    or sub["groups"] != [list(range(half)), list(range(half, world))]
                    or not sub["prov"].get("resource_splits_priced")
                    or sub["eval_all"] != SUBMESH_BATCH or any(sub["launches"].values())):
                raise AssertionError(f"fit_submesh {world} ranks, rank {r['rank']}: {sub}")
            rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(sub["losses"],
                                                                  ref["one_card_losses"])]
            if max(rel) > SUBMESH_BOUND:
                raise AssertionError(f"fit_submesh {world} ranks, rank {r['rank']}: losses "
                                     f"{sub['losses']} against one card's "
                                     f"{ref['one_card_losses']}")
        if not ref["params_compared"] or ref["param_rel"] > SUBMESH_BOUND:
            raise AssertionError(f"fit_submesh {world} ranks: parameters {ref['param_rel']} "
                                 f"from one card's")
        rows.append(dict(ranks=world, losses=ref["losses"], one_card_losses=ref["one_card_losses"],
                         param_max_rel=ref["param_rel"], groups=ref["groups"],
                         islands_by_rank=[r["fit_submesh"]["islands"] for r in ranks],
                         resource_splits=ref["prov"], p2p_transfers=[
                             r["fit_submesh"]["p2p_transfers"] for r in ranks],
                         rank_seconds=[r["fit_submesh"]["seconds"] for r in ranks]))
    emit({"phase": "fit_submesh", "card": smi, "sharing": SHARED, "dtype": "f32, TF32 off",
          "bound": SUBMESH_BOUND, "runs": rows})


# --- observability (A9): the step-health stream, its policies, spans, the
# roofline, the plan audit; the drift monitor rides the fit_searched job

def _flagship_window_model(cfg: dict, k: int, device: str = "cuda", **config):
    """The flagship through FFModel at steps_per_dispatch=k, bf16,
    Adam(1e-4), fit_window's model."""
    import torch
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import build_flagship_cg

    m = FFModel.from_computation_graph(
        *build_flagship_cg(**cfg), device=device,
        config=FFConfig(batch_size=cfg["batch"], seed=0, print_freq=0, steps_per_dispatch=k,
                        **config))
    m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy", metrics=FIT_METRICS,
              compute_dtype=torch.bfloat16 if device == "cuda" else None)
    return m


def _span_tree(trace_dir: str) -> dict:
    """The span names of a fit's flexflow_trace.json, their counts, the
    parent of each dispatch/device_sync (by nesting on one thread) and the
    step spans' fused_steps."""
    with open(os.path.join(trace_dir, "flexflow_trace.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    counts = {}
    for e in spans:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    nested = 0
    for e in spans:
        if e["name"] in ("dispatch", "device_sync"):
            nested += any(p["name"] == "step" and p["tid"] == e["tid"] and p["ts"] <= e["ts"]
                          and e["ts"] + e["dur"] <= p["ts"] + p["dur"] for p in spans)
    return {"counts": counts, "phases_in_step": nested,
            "fused_steps": sorted({e["args"].get("fused_steps") for e in spans
                                   if e["name"] == "step"}, key=str)}


def phase_fit_health(smi: str, k: int = FIT_WINDOW_K, windows: int = FIT_WINDOW_WINDOWS,
                     cfg=None, device: str = "cuda"):
    """fit_window's flagship at steps_per_dispatch=k with the run-health
    stream (metrics_dir) and the skip_step guard on, against the same
    model without them: each captures its window in a warm-up fit, then
    the two fit the same `windows` windows from compile's state in turns
    (plain, telemetry, plain, telemetry). Checks: the telemetry fit's
    losses and parameters bitwise the plain fit's (no step trips, so the
    guard commits every update); k * windows step events with
    STEP_EVENT_FIELDS whose losses are the windows' loss vectors; one
    stats readback a window; a profiled telemetry fit launching rows 1-3
    12 times a step each and no other flash kernel; a fit with
    profile_trace_dir writing flexflow_trace.json (step > dispatch /
    device_sync, host_to_device, fused_steps=k) and torch_trace.json.
    Numbers: step ms of each fit, the telemetry's overhead, and the memory
    its capture added."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.observability import metrics as M
    from flexflow_tpu_torch.models import FLAGSHIP

    cfg = cfg or FLAGSHIP
    b, steps = cfg["batch"], k * windows
    start = time.perf_counter()
    work = tempfile.mkdtemp()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((steps * b, cfg["seq"], cfg["embed"]), dtype=np.float32)
    y = rng.integers(0, cfg["vocab"], (steps * b, cfg["seq"]), dtype=np.int32)
    models, captured, init = {}, {}, None
    for name, extra in (("plain", {}), ("telemetry", dict(metrics_dir=os.path.join(
            work, "warmup"), health_policy="skip_step"))):
        m = models[name] = _flagship_window_model(cfg, k, device, **extra)
        if init is None:
            init = {key: p.detach().clone() for key, p in m.params.items()}
        elif any(not torch.equal(m.params[key], v) for key, v in init.items()):
            raise AssertionError("fit_health: the two compiles drew different parameters")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_reserved()
        m.fit(x[:k * b], y[:k * b], epochs=1, shuffle=False, verbose=False)
        torch.cuda.synchronize()
        captured[name] = {"reserved_bytes": torch.cuda.memory_reserved() - before,
                          "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    readbacks = []
    host = M.stats_to_host

    def counted(stats):
        readbacks.append(1)
        return host(stats)

    runs = {name: [] for name in models}
    for turn in range(2):
        for name, m in models.items():
            _reset_state(m, init)
            if name == "telemetry":
                m.config.metrics_dir = os.path.join(work, f"turn{turn}")
            losses = _record_window_losses(m)
            readbacks.clear()
            M.stats_to_host = counted
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m.fit(x, y, epochs=1, shuffle=False, verbose=False)
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
            finally:
                M.stats_to_host = host
                del m.instance.multi_train_step
            runs[name].append(dict(step_ms=elapsed * 1e3 / steps, readbacks=len(readbacks),
                                   losses=torch.cat(losses),
                                   params={key: p.clone() for key, p in m.params.items()}
                                   if turn == 0 else None))
    plain, tele = runs["plain"][0], runs["telemetry"][0]
    differ = [key for key, p in plain["params"].items() if not torch.equal(p, tele["params"][key])]
    if differ or not torch.equal(plain["losses"], tele["losses"]):
        raise AssertionError(f"fit_health: the telemetry fit is not the plain fit bitwise: "
                             f"parameters {differ[:4]}, losses {plain['losses'].tolist()} vs "
                             f"{tele['losses'].tolist()}")
    events = M.read_events(os.path.join(work, "turn0"))
    want_losses = [float(v) for v in tele["losses"].float().cpu()]
    bad = [e for e in events if tuple(e) != M.STEP_EVENT_FIELDS or e["skipped"] or e["nonfinite"]
           or not math.isfinite(e["grad_norm"])]
    if len(events) != steps or bad or [e["loss"] for e in events] != want_losses:
        raise AssertionError(f"fit_health: {len(events)} events (expected {steps}), bad {bad[:2]}, "
                             f"losses {[e['loss'] for e in events]} vs {want_losses}")
    FIT_HEALTH_RUN.update(metrics_dir=os.path.join(work, "turn0"), steps=steps)
    if any(r["readbacks"] != windows for r in runs["telemetry"]) or any(
            r["readbacks"] for r in runs["plain"]):
        raise AssertionError(f"fit_health: stats readbacks "
                             f"{[r['readbacks'] for r in runs['telemetry']]}, expected {windows} "
                             "a telemetry fit and none a plain one")
    tm = models["telemetry"]
    _reset_state(models["plain"], init)
    plain_trace = _profiled_fit(models["plain"], x, y)
    _reset_state(tm, init)
    tm.config.metrics_dir = os.path.join(work, "profiled")
    trace = _profiled_fit(tm, x, y)
    want = {name: cfg["layers"] * steps for name in FIT_WINDOW_KERNELS}
    if trace["flash"] != want:
        raise AssertionError(f"fit_health: the trace counts {trace['flash']} flash and ring "
                             f"launches, expected {want}")
    _reset_state(tm, init)
    tm.config.metrics_dir = os.path.join(work, "traced")
    tm.config.profile_trace_dir = os.path.join(work, "trace")
    tm.fit(x, y, epochs=1, shuffle=False, verbose=False)
    tm.config.profile_trace_dir = ""
    tree = _span_tree(os.path.join(work, "trace"))
    c = tree["counts"]
    if not (c.get("step") == c.get("dispatch") == c.get("device_sync") == c.get(
            "host_to_device") == windows and tree["phases_in_step"] == 2 * windows
            and tree["fused_steps"] == [k]
            and os.path.exists(os.path.join(work, "trace", "torch_trace.json"))):
        raise AssertionError(f"fit_health: span tree {tree}")
    plain_ms = [r["step_ms"] for r in runs["plain"]]
    tele_ms = [r["step_ms"] for r in runs["telemetry"]]
    overhead = float(np.median(tele_ms) - np.median(plain_ms))
    params_bytes = sum(p.numel() * p.element_size() for p in tm.params.values())
    emit({"phase": "fit_health", "card": smi, "config": cfg, "compute_dtype": "bf16",
          "steps_per_dispatch": k, "windows": windows, "health_policy": "skip_step",
          "bitwise_equal_to_plain": True, "events": len(events),
          "stats_readbacks_per_fit": [r["readbacks"] for r in runs["telemetry"]],
          "plain_step_ms": plain_ms, "telemetry_step_ms": tele_ms,
          "turns": "plain, telemetry, plain, telemetry; each fit from compile's state",
          "overhead_ms_per_step": overhead,
          "overhead_share": overhead / float(np.median(plain_ms)),
          "capture_memory": captured,
          "memory_added_bytes": {key: captured["telemetry"][key] - captured["plain"][key]
                                 for key in captured["plain"]},
          "profiled_fit": {name: {"host_ms_per_window": t["host_ms"] / windows,
                                  "kernel_ms_per_window": t["kernel_ms"] / windows,
                                  "idle_share": 1.0 - t["kernel_ms"] / t["host_ms"],
                                  "top_kernels": t["top_kernels"]}
                           for name, t in (("plain", plain_trace), ("telemetry", trace))},
          "kernels_added_per_window": sorted(
              ({"name": key, "calls": (n - plain_trace["by_kernel"].get(key, (0, 0.0))[0])
                / windows, "ms": (ms - plain_trace["by_kernel"].get(key, (0, 0.0))[1]) / windows}
               for key, (n, ms) in trace["by_kernel"].items()), key=lambda d: -d["ms"])[:12],
          "param_bytes": params_bytes,
          "launches_per_window": {n: v // windows for n, v in trace["flash"].items()},
          "launches_per_step_each": cfg["layers"], "span_tree": tree,
          "event_sample": events[-1], "seconds": time.perf_counter() - start})
    for m in models.values():
        m.invalidate_graphs()
    del models, tm, init, runs
    torch.cuda.empty_cache()
    return {wrapper: trace["flash"][name] for name, wrapper in FIT_WINDOW_KERNELS.items()}


def _poison_seed(site: str, step: int, steps: int, rate: float) -> int:
    """A seed whose schedule fires `site` at `step` alone within 1..steps."""
    from flexflow_tpu_torch.runtime.fault import FaultSchedule

    return next(s for s in range(100_000)
                if FaultSchedule(seed=s, sites=frozenset({site}), rate=rate).fire_steps(
                    site, 1, steps) == [step])


def phase_health_poison(smi: str, device: str = "cuda") -> None:
    """parity_fit_window's Dropout MLP (f32) for one epoch of 8 batches with
    the `nonfinite` fault site at step 5 (the batch poisoned on the host
    before its copy: the input pipeline's producer at K=4, the per-step
    loop at K=1): skip_step at K=4 bitwise the K=1 run (events, parameters,
    Adam's step count 7), naming fc1; raise stopping at step 5 with
    NonFiniteError naming fc1, the parameters the pre-trip ones (K=4
    bitwise K=1); warn applying the poisoned update and saying so."""
    import contextlib
    import io

    import numpy as np
    import torch
    from flexflow_tpu_torch.observability.health import NonFiniteError
    from flexflow_tpu_torch.observability.metrics import read_events
    from flexflow_tpu_torch.runtime.fault import FaultSchedule, install_schedule

    start = time.perf_counter()
    seed = _poison_seed("nonfinite", 5, 8, 0.2)
    rs = np.random.RandomState(0)
    x, y = rs.randn(128, 32).astype(np.float32), rs.randint(0, 10, 128)
    work = tempfile.mkdtemp()

    def run(k, policy):
        mdir = os.path.join(work, f"{policy}_k{k}")
        m = _fused_mlp(k, device=device, metrics_dir=mdir, health_policy=policy)
        install_schedule(FaultSchedule(seed=seed, sites=frozenset({"nonfinite"}), rate=0.2))
        out, err = io.StringIO(), None
        try:
            with contextlib.redirect_stdout(out):
                m.fit(x, y, epochs=1, shuffle=False, verbose=False)
        except NonFiniteError as e:
            err = e
        finally:
            install_schedule(None)
        events = [(e["step"], e["loss"], e["grad_norm"], e["skipped"], e["nonfinite"])
                  for e in read_events(mdir)]
        return dict(m=m, err=err, out=out.getvalue(), events=events,
                    finite=all(bool(torch.isfinite(p).all()) for p in m.params.values()))

    r = {(p, k): run(k, p) for p in ("skip_step", "raise") for k in (1, 4)}
    r[("warn", 4)] = run(4, "warn")
    s1, s4 = r[("skip_step", 1)], r[("skip_step", 4)]
    checks = {
        "skip_step_k4_bitwise_k1": all(torch.equal(s1["m"].params[key], s4["m"].params[key])
                                       for key in s1["m"].params) and s1["events"] == s4["events"],
        "skip_step_flags": [e[0] for e in s4["events"] if e[3] and e[4]] == [5],
        "skip_step_adam_step": int(s4["m"].opt_state["step"]) == int(
            s1["m"].opt_state["step"]) == 7,
        "skip_step_blames_fc1": s4["m"].health_monitor.summary()["first_bad_op"] == "fc1",
        "skip_step_finite": s4["finite"],
    }
    for k in (1, 4):
        e = r[("raise", k)]
        checks[f"raise_k{k}"] = (e["err"] is not None and e["err"].report is not None
                                 and e["err"].report.op_name == "fc1"
                                 and e["m"]._step_count == 5 and e["finite"])
    checks["raise_k4_pre_trip_bitwise_k1"] = all(
        torch.equal(r[("raise", 1)]["m"].params[key], r[("raise", 4)]["m"].params[key])
        for key in r[("raise", 1)]["m"].params)
    w = r[("warn", 4)]
    checks["warn_applies_and_says_so"] = (not w["finite"] and "WARN" in w["out"]
                                          and w["m"].health_monitor.skipped_steps == 0
                                          and w["m"].health_monitor.nonfinite_steps >= 1)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"health_poison: failed checks {failed}")
    emit({"phase": "health_poison", "card": smi, "model": "32-32 relu dropout(0.1)-10, "
          "batch 16, f32", "site": "nonfinite at step 5", "seed": seed, "checks": checks,
          "raise": str(r[("raise", 4)]["err"])[:200],
          "skip_step_events": s4["events"], "seconds": time.perf_counter() - start})


def phase_roofline(smi: str, cfg=None, step_ms=None, device: str = "cuda") -> None:
    """The flagship's train step attributed op by op: each compute op's
    forward and backward timed on the card by the stepped backing
    (measure_per_op_ms, bf16; its second run is kept), scaled to train's
    median step (attribute_costs), and classified against the H100's
    datasheet peaks (roofline_report): the time by bound and the
    whole-step MFU of the analytic counts beside train's MFU."""
    import torch
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_cg, model_step_flops
    from flexflow_tpu_torch.observability import (
        analytic_op_costs,
        attribute_costs,
        measure_per_op_ms,
        roofline_report,
    )
    from flexflow_tpu_torch.observability.roofline import machine_constants

    cfg = cfg or FLAGSHIP
    step_ms = step_ms if step_ms is not None else MEDIAN_STEP_MS["train"]
    start = time.perf_counter()
    cg, logit = build_flagship_cg(**cfg)
    cg = getattr(cg, "graph", cg)
    x = torch.randn(cfg["batch"], cfg["seq"], cfg["embed"], device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    dtype = torch.bfloat16 if device == "cuda" else None
    for _ in range(2):  # the first run loads the kernels
        per_op = measure_per_op_ms(cg, {"x": x}, logit, compute_dtype=dtype, device=device)
    att = attribute_costs(cg, step_ms, per_op_ms=per_op)
    consts = machine_constants()
    block = roofline_report(att, consts["peak_flops"], consts["hbm_gbps"], top_n=8)
    train_mfu = model_step_flops(**cfg) / (step_ms / 1e3) / PEAK_BF16
    n_ops = len(analytic_op_costs(cg))
    if len(per_op) != n_ops or not all(math.isfinite(v) and v > 0 for v in per_op.values()) \
            or not math.isfinite(block["mfu"]):
        raise AssertionError(f"roofline: {len(per_op)} ops timed of {n_ops}, mfu {block['mfu']}")
    print(f"roofline: {block['bound_ms']} ms by bound, MFU {block['mfu']} "
          f"(train's {train_mfu:.4f})", flush=True)
    emit({"phase": "roofline", "card": smi, "config": cfg, "compute_dtype": "bf16",
          "constants": consts, "train_step_ms": step_ms, "train_mfu": train_mfu,
          "per_op_ms_sum": att.raw_total_ms, "ops_timed": len(per_op), "roofline": block,
          "seconds": time.perf_counter() - start})


SEARCH_RUN = {}  # phase_search's run (the winner, its leaves), read by plan_audit


def phase_plan_audit(smi: str, device: str = "cuda") -> None:
    """audit_plan on phase_search's 8-H100 winner and on the unrewritten
    flagship's 1-device plan (the plan whose estimate is search's
    one_device_estimate_ms), each priced with the analytic roofline at the
    card's calibrated rates and with the timed leaves: every op measured
    on the card, movement None on a mesh of one. Prints each audit's
    geomean ratio per op class and its worst five ops: where the 1-device
    estimates part from train's measured step."""
    from flexflow_tpu_torch.compiler import AnalyticGPUCostEstimator, GPUCostEstimator
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_pcg
    from flexflow_tpu_torch.observability.plan_audit import audit_by_class, audit_plan
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification

    start = time.perf_counter()
    run = SEARCH_RUN
    cal, local = run["cal"], run["local"]
    one = MachineSpecification(1, 1, 1, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)
    plans = {"winner_8_h100": (run["result"].pcg, run["result"].machine_mapping, run["spec"]),
             "one_device": (build_flagship_pcg(**FLAGSHIP), run["one_device"].machine_mapping,
                            one)}
    out = {}
    for label, (pcg, mapping, spec) in plans.items():
        for est_name, est in (("analytic", AnalyticGPUCostEstimator(spec, cal.peak_flops,
                                                                   cal.hbm_gbps)),
                              ("timed", GPUCostEstimator(spec, local_cost_estimator=local))):
            audit = audit_plan(pcg, mapping, est, device=device)
            s = audit["summary"]
            if (s["num_ops_measured"] != audit["num_ops"] or audit["movement_measured"]
                    or any(e["measured_ms"] is not None for e in audit["movement_edges"])):
                raise AssertionError(f"plan_audit {label}/{est_name}: {s}")
            by_class = audit_by_class(audit)
            predicted = sum(o["predicted_ms"] or 0.0 for o in audit["ops"])
            measured = sum(o["measured_ms"] or 0.0 for o in audit["ops"])
            out[f"{label}/{est_name}"] = {
                "op_geomean_ratio": s["op_geomean_ratio"], "by_class": by_class,
                "worst_ops": s["worst_ops"], "ops": audit["num_ops"],
                "movement_edges": audit["num_movement_edges"],
                "predicted_ops_ms": predicted, "measured_ops_ms": measured}
            print(f"plan_audit {label}/{est_name}: geomean {s['op_geomean_ratio']}, by class "
                  f"{ {c: v['geomean_ratio'] for c, v in by_class.items()} }, worst "
                  f"{s['worst_ops']}", flush=True)
    emit({"phase": "plan_audit", "card": smi, "config": FLAGSHIP,
          "calibration": cal.as_dict(), "audits": out,
          "ratio_is": "measured / predicted, each op's piece fwd+bwd timed on the card",
          "seconds": time.perf_counter() - start})


# --- A11: Ulysses attention and mixture of experts -----------------------------------

# parity_ulysses: parity_sp's small causal models (seq 1024, hidden 256, 2
# layers, heads of 128 and of 64) at sp = 2; the JAX package's per-head
# block: its backward runs _bwd_rows_fused (row 11) for s up to it, _bwd
# (row 12) above (flexflow_tpu/kernels/flash_attention.py's default blocks);
# the port's flash_bwd_bhsd kernels serve both rows
ULYSSES_SP = 2
BHSD_BLOCK = 1024
ULYSSES_STEPS = 3  # timed Adam steps of train_ulysses, after one warm-up step
# parity_moe (a): fit_moe's Experts layer alone (16 x 512 tokens of 1024)
MOE_LAYER = dict(tokens=16 * 512, d=1024, experts=8, select=2, hidden=1024, alpha=2.0, lam=0.04)
MOE_LAYER_BOUND = 1e-5  # relative: output, aux and gradients, index path vs dense plain (f32)
# parity_moe (b) and moe_ranks (c): a small MoE encoder through FFModel
# (examples/moe.py's create_moe_encoder)
MOE_SMALL = dict(batch=4, seq=512, data_dim=256, hidden=256, heads=2, layers=2, experts=4,
                 select=2, alpha=2.0, lam=0.04, classes=512)
# fit_moe: examples/moe.py --encoder at the flagship's widths, the
# flagship's vocabulary as its classes
FIT_MOE = dict(batch=16, seq=512, data_dim=1024, hidden=1024, heads=8, layers=12, experts=8,
               select=2, alpha=2.0, lam=0.04, classes=32000)
# moe_ranks: the load-balance weight at 0.5, where an aux loss counted
# twice or only a block's is far outside the bound; f32 (TF32 off), so the
# ranks' losses and parameters are held to 1e-3 of one card's
MOE_RANKS_LAMBDA = 0.5
MOE_RANKS_BOUND = 1e-3
MOE_RANKS_STEPS = 2
# (a) tests/test_moe.py::test_searched_moe_finds_expert_parallelism's model
# (moe(8 experts, top-2, alpha 4) then a bias-free head of 8): at its widths
# (64 x 128, hidden 256) the analytic search on the H100 constants keeps the
# serial plan; at these the winner shards the experts
MOE_SEARCHED = dict(batch=256, d=1024, hidden=4096, experts=8, select=2, alpha=4.0, classes=8)
# (b) tests/test_moe.py::test_expert_parallel_training_on_mesh's dp2 x ep2
# PCG, at capacity factor 1.0 (tokens dropped)
MOE_EP = dict(batch=8, d=16, experts=4, select=2, hidden=32, classes=8, alpha=1.0)
A11_RESULTS = {}  # world -> the A11 rank job's ranks, read by the phases after the first

A11_RANK_WORKER = r"""
import json, os, sys
import torch
import torch.distributed as dist
import chip_smoke as c
from flexflow_tpu_torch.parallel import init_file_group

rank, world, job = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
device = init_file_group(job["store"], rank, world, device=job["device"], backend="gloo",
                         timeout_s=job["timeout_s"])
out = dict(c.a11_rank(job, device, rank, world), rank=rank)
with open(f"{job['out']}.rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def _ulysses_pcg(cfg):
    """build_parallel_transformer(cfg) with its RingAttention nodes
    relabelled UlyssesAttention: the op the search's a2a rule and seeds put
    in, on a causal model (the rule itself matches non-causal MHA)."""
    from flexflow_tpu_torch.models import build_parallel_transformer
    from flexflow_tpu_torch.op_attrs.ops import RingAttentionAttrs, UlyssesAttentionAttrs
    from flexflow_tpu_torch.pcg.parallel_computation_graph import ParallelLayerAttrs

    pcg, logits = build_parallel_transformer(cfg)
    for n in pcg.topological_ordering():
        la = pcg.layer_attrs(n)
        if type(la.attrs) is RingAttentionAttrs:
            fields = {f.name: getattr(la.attrs, f.name) for f in dataclasses.fields(la.attrs)}
            pcg.set_node_label(n, ParallelLayerAttrs(UlyssesAttentionAttrs(**fields), la.name))
    return pcg, logits


def _ulysses_batch(cfg):
    import torch

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(cfg.batch_size, cfg.sequence_length, cfg.num_features, generator=gen)
    return x, torch.randint(0, cfg.vocab_size, (cfg.batch_size, cfg.sequence_length),
                            generator=gen)


def _ulysses_run(cfg, device, world: int, compute, steps: int, warmup: int = 0,
                 alpha: float = 1e-3) -> dict:
    """The Ulysses plan of cfg on `world` sequence ranks (a one-rank mesh
    over `group` where world is 1): warmup steps, then `steps` timed ones
    with every launch count set to 0 just before; the losses, step ms,
    launches, each step's collectives and what the plan implies, and the
    sequence lengths the attention attended."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import ulysses_attention as ua
    from flexflow_tpu_torch.models.parallel_transformer import model_step_flops
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    pcg, logits = _ulysses_pcg(cfg)
    mesh = MachineMesh(1, world) if world > 1 else MachineMesh(1, 1)
    inst = DistributedTrainingInstance(pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                       AdamOptimizerAttrs(alpha=alpha), mesh,
                                       compute_dtype=compute, device=device)
    params, opt = inst.initialize(seed=0)
    x, y = (t.to(device) for t in _ulysses_batch(cfg))
    seqs, attend = [], ua.attend_full_sequence
    ua.attend_full_sequence = lambda q, k, v, causal: seqs.append(q.shape[2]) or attend(
        q, k, v, causal)
    try:
        warm = []
        for _ in range(warmup):
            params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
            warm.append(float(loss))
        _sync(device)
        fa.reset_launch_counts()
        ring = mesh.counts["ring_step"]
        losses, step_ms, per_step = [], [], []
        for _ in range(steps):
            before = dict(mesh.counts)
            start = time.perf_counter()
            params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
            losses.append(float(loss))
            _sync(device)
            step_ms.append((time.perf_counter() - start) * 1e3)
            per_step.append({k: v - before.get(k, 0) for k, v in mesh.counts.items()
                             if v - before.get(k, 0)})
    finally:
        ua.attend_full_sequence = attend
    if not all(math.isfinite(v) for v in warm + losses):
        raise AssertionError(f"ulysses: non-finite losses {warm + losses}")
    return dict(warmup_losses=warm, losses=losses, step_ms=step_ms, per_step=per_step,
                implied={k: int(v) for k, v in inst.step_collectives().items()},
                launches={fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS},
                ring_steps=mesh.counts["ring_step"] - ring, seqs=sorted(set(seqs)),
                a2a_nodes=sum(1 for p in inst.plan.nodes.values() if p.a2a_axes),
                ring_nodes=sum(1 for p in inst.plan.nodes.values() if p.ring_axes),
                step_flops=model_step_flops(cfg))


def _moe_model(pkg_core, cfg: dict, kind: str, device, **config):
    """The MoE models of parity_moe, fit_moe and moe_ranks through FFModel,
    every weight named: "encoder", a dense input layer, examples/moe.py's
    create_moe_encoder and a dense head; "searched", MOE_SEARCHED's moe
    then a bias-free head."""
    from flexflow_tpu_torch.examples.moe import create_moe_encoder

    m = pkg_core.FFModel(pkg_core.FFConfig(batch_size=cfg["batch"], seed=0, print_freq=0,
                                           **config), device=device)
    if kind == "searched":
        x = m.create_tensor([cfg["batch"], cfg["d"]], name="x")
        t = m.moe(x, cfg["experts"], cfg["select"], cfg["hidden"], cfg["alpha"],
                  cfg["lam"], name="moe")
        m.dense(t, cfg["classes"], use_bias=False, name="out")
    else:
        x = m.create_tensor([cfg["batch"], cfg["seq"], cfg["data_dim"]], name="x")
        t = m.dense(x, cfg["hidden"], name="inp")
        t = create_moe_encoder(m, t, cfg["layers"], cfg["hidden"], cfg["heads"],
                               cfg["experts"], cfg["select"], cfg["alpha"], cfg["lam"])
        m.dense(t, cfg["classes"], name="out")
    return m


def _named_weights(m) -> dict:
    """Every weight of an FFModel by its name (unnamed layers' weights by
    the order the graph gives them), as numpy: the global values (a
    collective in a searched plan)."""
    out = {}
    for i, n in enumerate(n for n in m.cg.topological_ordering()
                          if type(m.cg.op_attrs(n)).__name__ == "WeightAttrs"):
        name = m.cg.layer_attrs(n).name or f"w{i}"
        out[name] = m._read_tensor(m.cg.outputs_of(n)[0])
    return out


def _set_named_weights(m, values: dict) -> None:
    for i, n in enumerate(n for n in m.cg.topological_ordering()
                          if type(m.cg.op_attrs(n)).__name__ == "WeightAttrs"):
        m._write_tensor(m.cg.outputs_of(n)[0], values[m.cg.layer_attrs(n).name or f"w{i}"])


def _moe_fit(m, x, y, batch: int) -> dict:
    """m.fit on (x, y) unshuffled, one step a batch: every step's loss
    (the training loss, aux terms included), the metric sums, the final
    weights by name."""
    losses, step = [], m.instance.train_step

    def train_step(*args, **kw):
        out = step(*args, **kw)
        losses.append(float(out[2]))
        return out

    m.instance.train_step = train_step
    try:
        perf = m.fit(x, y, epochs=1, shuffle=False, verbose=False)
    finally:
        del m.instance.train_step
    return dict(losses=losses, perf=dataclasses.asdict(perf), weights=_named_weights(m))


def _moe_ranks_data(tmp: str, searched: dict = MOE_SEARCHED, small: dict = MOE_SMALL) -> dict:
    """moe_ranks's seeded parameters and batches, written for the ranks:
    the searched model's (a), the dp2 x ep2 PCG's (b) and the small
    encoder's (c), each by weight name."""
    import numpy as np
    from flexflow_tpu_torch import core

    rs = np.random.default_rng(7)
    files = {}
    for kind, cfg in (("searched", dict(searched, lam=MOE_RANKS_LAMBDA)),
                      ("encoder", dict(small, lam=MOE_RANKS_LAMBDA))):
        m = _moe_model(core, cfg, kind, "cpu")
        m.compile(core.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")
        weights = _named_weights(m)
        n = MOE_RANKS_STEPS * cfg["batch"]
        shape = (n, cfg["d"]) if kind == "searched" else (n, cfg["seq"], cfg["data_dim"])
        x = rs.standard_normal(shape, dtype=np.float32)
        y = rs.integers(0, cfg["classes"], shape[:-1], dtype=np.int32)
        files[kind] = os.path.join(tmp, f"moe_{kind}.npz")
        np.savez(files[kind], x=x, y=y, **weights)
    ep = MOE_EP
    weights = {"experts.weight0": rs.standard_normal((ep["d"], ep["experts"])) * 0.5,
               "experts.weight1": rs.standard_normal((ep["experts"], ep["d"], ep["hidden"])) * 0.2,
               "experts.weight2": rs.standard_normal((ep["experts"], ep["hidden"])) * 0.1,
               "experts.weight3": rs.standard_normal((ep["experts"], ep["hidden"], ep["d"])) * 0.2,
               "experts.weight4": rs.standard_normal((ep["experts"], ep["d"])) * 0.1,
               "head.weight0": rs.standard_normal((ep["d"], ep["classes"])) * 0.3,
               "head.weight1": np.zeros(ep["classes"])}
    files["ep"] = os.path.join(tmp, "moe_ep.npz")
    np.savez(files["ep"], x=rs.standard_normal((ep["batch"], ep["d"]), dtype=np.float32),
             y=rs.integers(0, ep["classes"], ep["batch"], dtype=np.int32),
             **{k: v.astype(np.float32) for k, v in weights.items()})
    return files


def _moe_ep_graph(parallel: bool):
    """MOE_EP's model: the dp2 x ep2 PCG (Replicate, Experts, Reduction, a
    dense head) or, for one device, its computation graph; (graph, logits,
    aux)."""
    from flexflow_tpu_torch.op_attrs.datatype import DataType
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import lift_to_parallel_with_degrees
    from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
    from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder
    from flexflow_tpu_torch.pcg.parallel_computation_graph_builder import (
        ParallelComputationGraphBuilder,
    )

    ep = MOE_EP
    args = (ep["experts"], ep["select"], ep["hidden"])
    kw = dict(capacity_factor=ep["alpha"], lambda_bal=MOE_RANKS_LAMBDA, name="experts")
    if parallel:
        b = ParallelComputationGraphBuilder()
        x = b.create_input_tensor(lift_to_parallel_with_degrees(
            TensorShape((ep["batch"], ep["d"]), DataType.FLOAT), 1, 1, (2, 1)), name="x")
        h, aux = b.experts(b.parallel_replicate(x, 2), *args, **kw)
        h = b.parallel_reduce(h, 2)
    else:
        b = ComputationGraphBuilder()
        x = b.create_input([ep["batch"], ep["d"]], name="x")
        h, aux = b.experts(x, *args, **kw)
    return b.graph, b.dense(h, ep["classes"], name="head"), aux


def _moe_ep_train(graph, logits, aux, values: dict, x, y, device, mesh=None) -> dict:
    """MOE_EP's model from the named values: MOE_RANKS_STEPS SGD steps' losses
    and the final values by name, through the PCG trainer over `mesh` or
    the single-device one; with each step's collectives over the mesh."""
    import torch
    from flexflow_tpu_torch.interop import pcg_params_from_numpy, pcg_params_to_numpy
    from flexflow_tpu_torch.kernels import make_optimizer_state
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.local_execution.training_backing import param_key
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance
    from flexflow_tpu_torch.pcg import SGDOptimizerAttrs

    names = {param_key(n): graph.layer_attrs(n).name for n in graph.topological_ordering()
             if type(graph.op_attrs(n)).__name__ == "WeightAttrs"}
    by_key = {k: values[name] for k, name in names.items()}
    args = (graph, logits, SparseCategoricalCrossEntropyLossAttrs(), SGDOptimizerAttrs(lr=0.05))
    if mesh is not None:
        inst = DistributedTrainingInstance(*args, mesh, device=device, aux_loss_tensors=[aux])
        params = pcg_params_from_numpy(graph, inst.shardings, mesh, by_key, device)
    else:
        inst = ModelTrainingInstance(*args, device=device, aux_loss_tensors=[aux])
        params = {k: torch.tensor(v, device=device) for k, v in by_key.items()}
    opt = make_optimizer_state(inst.optimizer_attrs, params)
    losses, per_step = [], []
    for _ in range(MOE_RANKS_STEPS):
        before = dict(mesh.counts) if mesh is not None else {}
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
        losses.append(float(loss))
        if mesh is not None:
            per_step.append({k: v - before.get(k, 0) for k, v in mesh.counts.items()
                             if v - before.get(k, 0)})
    final = (pcg_params_to_numpy(graph, inst.shardings, mesh, params) if mesh is not None
             else {k: v.detach().cpu().numpy() for k, v in params.items()})
    out = dict(losses=losses, weights={names[k]: v for k, v in final.items()})
    if mesh is not None:
        out.update(per_step=per_step,
                   implied={k: int(v) for k, v in inst.step_collectives().items()})
    return out


def a11_rank(job: dict, device, rank: int, world: int) -> dict:
    """One rank of the A11 job: on 2 ranks parity_ulysses (card and CPU),
    train_ulysses, and moe_ranks (a) and (c); on 4, moe_ranks (b). Each
    part's wall seconds beside it."""
    import numpy as np
    import torch
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.models import SP_LONGCTX
    from flexflow_tpu_torch.op_attrs.ops import ExpertsAttrs, RepartitionAttrs
    from flexflow_tpu_torch.parallel import MachineMesh

    out, card = {}, torch.device(device).type == "cuda"
    if world == 4:
        start = time.perf_counter()
        data = np.load(job["moe"]["ep"])
        graph, logits, aux = _moe_ep_graph(True)
        x = torch.tensor(data["x"], device=device)
        y = torch.tensor(data["y"], device=device)
        run = _moe_ep_train(graph, logits, aux, dict(data), x, y, device,
                            MachineMesh.for_devices(4))
        np.savez(f"{job['out']}.moe_ep.rank{rank}.npz", **run.pop("weights"))
        out["moe_ep"] = dict(run, wall_s=time.perf_counter() - start)
        return out
    parity = {}
    for heads in job["ulysses_heads"]:
        cfg = _sp_model(heads, sequence_parallel_degree=world, **job.get("ulysses_small", {}))
        start = time.perf_counter()
        parity[heads] = {
            "card": _ulysses_run(cfg, device, world, torch.bfloat16 if card else None, 2),
            "cpu": _ulysses_run(cfg, "cpu", world, None, 2),
            "wall_s": time.perf_counter() - start}
    out["parity_ulysses"] = parity
    start = time.perf_counter()
    cfg = dataclasses.replace(SP_LONGCTX, sequence_parallel_degree=world,
                              **job.get("ulysses_train", {}))
    out["train_ulysses"] = dict(_ulysses_run(cfg, device, world, torch.bfloat16 if card else None,
                                             job["ulysses_steps"], warmup=1, alpha=1e-4),
                                wall_s=time.perf_counter() - start)
    torch.cuda.empty_cache() if card else None
    for kind, cfg, config in (
            ("searched", dict(job.get("moe_searched", MOE_SEARCHED), lam=MOE_RANKS_LAMBDA),
             dict(max_devices=world, search_budget=4, cost_model="analytic")),
            ("encoder", dict(job.get("moe_small", MOE_SMALL), lam=MOE_RANKS_LAMBDA),
             dict(max_devices=world, only_data_parallel=True))):
        start = time.perf_counter()
        data = np.load(job["moe"][kind])
        m = _moe_model(core, cfg, kind, device, **config)
        m.compile(core.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                  metrics=["accuracy", "sparse_categorical_crossentropy"])
        _set_named_weights(m, dict(data))
        inst = m.instance
        counts = inst.machine_mesh.counts if hasattr(inst, "machine_mesh") else inst.collectives
        before = dict(counts)
        run = _moe_fit(m, data["x"], data["y"], cfg["batch"])
        ep = []
        pcg = getattr(inst, "pcg", None)
        if pcg is not None:
            for n in pcg.topological_ordering():
                if isinstance(pcg.op_attrs(n), ExpertsAttrs):
                    ep += [pcg.op_attrs(v.node).repartition_degree for v in pcg.inputs_of(n)
                           if isinstance(pcg.op_attrs(v.node), RepartitionAttrs)
                           and pcg.op_attrs(v.node).repartition_dim == 0]
        np.savez(f"{job['out']}.moe_{kind}.rank{rank}.npz", **run["weights"])
        out[f"moe_{kind}"] = dict(
            losses=run["losses"], perf=run["perf"],
            kind=type(inst).__name__, aux=len(inst.aux_loss_tensors), expert_degrees=ep,
            provenance=m.search_provenance,
            collectives={k: v - before.get(k, 0) for k, v in counts.items()
                         if v - before.get(k, 0)},
            implied={k: int(v) for k, v in inst.step_collectives().items()},
            wall_s=time.perf_counter() - start)
        del m, inst
    return out


def _a11_job(world: int, tmp: str, device: str = "cuda:0", **job) -> list:
    """The A11 rank job on `world` ranks, run once (its ranks cached for the
    phases that read it)."""
    if world not in A11_RESULTS:
        files = A11_RESULTS.get("moe_files") or _moe_ranks_data(
            tmp, job.get("moe_searched", MOE_SEARCHED), job.get("moe_small", MOE_SMALL))
        A11_RESULTS["moe_files"] = files
        job = dict(dict(name=f"a11_{world}", device=device, timeout_s=RANK_TIMEOUT_S / 2,
                        ulysses_heads=[2, 4], ulysses_steps=ULYSSES_STEPS, moe=files), **job)
        A11_RESULTS[world] = run_ranks(world, job, tmp, worker=A11_RANK_WORKER,
                                       timeout=2 * RANK_TIMEOUT_S)
    return A11_RESULTS[world]


def _a11_launches(phase: str, got: dict, on_path: dict) -> None:
    want = {n: on_path.get(n, 0) for n in got}
    if got != want:
        raise AssertionError(f"{phase}: launches {got}, expected {want}")


def _check_ulysses_plan(phase: str, run: dict, layers: int, sp: int) -> None:
    """The Ulysses route (fault C7): every attention node all-to-alls,
    none rings; 4 all-to-alls a node forward and 4 backward each step, as
    the plan implies; no ring step; the full sequence attended."""
    if run["a2a_nodes"] != layers or run["ring_nodes"] or run["ring_steps"]:
        raise AssertionError(f"{phase}: {run['a2a_nodes']} all-to-all and {run['ring_nodes']} "
                             f"ring nodes, {run['ring_steps']} ring steps")
    if run["implied"].get("all_to_all") != 8 * layers:
        raise AssertionError(f"{phase}: the plan implies {run['implied']}")
    for step in run["per_step"]:
        if step != run["implied"]:
            raise AssertionError(f"{phase}: a step issued {step}, the plan implies "
                                 f"{run['implied']}")


def phase_parity_ulysses(smi: str, tmp: str, device: str = "cuda:0", **job) -> dict:
    """parity_sp's two small causal models under the Ulysses plan at sp = 2
    on 2 ranks sharing the card: two Adam steps on the card (bf16, the
    per-head kernels) and on the CPU (f32, plain versions) on the same
    ranks; the losses within PARITY_BOUND, the all-to-alls, no ring."""
    ranks = _a11_job(2, tmp, device, **job)
    launches = {}
    for heads in ranks[0]["parity_ulysses"]:
        runs = [r["parity_ulysses"][heads] for r in ranks]
        card, cpu = runs[0]["card"], runs[0]["cpu"]
        model = _sp_model(int(heads), **job.get("ulysses_small", {}))
        layers, seq = model.num_layers, card["seqs"]
        route = "row 11 (s <= block)" if seq[-1] <= BHSD_BLOCK else "row 12 (s > block)"
        if seq != [model.sequence_length] or route != "row 11 (s <= block)":
            raise AssertionError(f"parity_ulysses heads={heads}: attended {seq}, {route}")
        for r, run in zip(ranks, runs):
            _check_ulysses_plan(f"parity_ulysses heads={heads} rank {r['rank']}", run["card"],
                                layers, ULYSSES_SP)
            _a11_launches(f"parity_ulysses heads={heads} rank {r['rank']}",
                          run["card"]["launches"],
                          {n: 2 * layers for n in BHSD_WRAPPERS})
            for name, n in run["card"]["launches"].items():
                launches[name] = launches.get(name, 0) + n
        rel = [abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"])]
        if not max(rel) < PARITY_BOUND:
            raise AssertionError(f"parity_ulysses heads={heads}: card {card['losses']} vs "
                                 f"CPU {cpu['losses']}")
        emit({"phase": "parity_ulysses", "head_dim": 256 // int(heads), "ranks": 2,
              "sharing": f"2 {SHARED}", "card": smi, "sp": ULYSSES_SP,
              "losses": {"cuda": card["losses"], "cpu": cpu["losses"]}, "rel_err": rel,
              "bound": PARITY_BOUND, "attended_seq": seq, "bwd_route": route,
              "block": BHSD_BLOCK, "collectives_per_step": card["implied"],
              "launches_per_rank": card["launches"], "ring_steps": card["ring_steps"],
              "wall_s": runs[0]["wall_s"]})
    return launches


def phase_train_ulysses(smi: str, tmp: str, device: str = "cuda:0", single=None, **job) -> dict:
    """SP_LONGCTX under the Ulysses plan at sp = 2 on 2 ranks sharing the
    card: a warm-up and ULYSSES_STEPS timed Adam steps in bf16, each rank's
    4 heads over all 8192 positions through rows 9, 10 and 12; the first
    step's loss against the single-device step of the same plan at sp = 1
    (the per-head kernels on the whole sequence, all heads) from the same
    parameters on the card."""
    import torch
    from flexflow_tpu_torch.models import SP_LONGCTX

    ranks = _a11_job(2, tmp, device, **job)
    cfg = dataclasses.replace(SP_LONGCTX, **job.get("ulysses_train", {}))
    layers = cfg.num_layers
    launches = {}
    for r in ranks:
        run = r["train_ulysses"]
        _check_ulysses_plan(f"train_ulysses rank {r['rank']}", run, layers, ULYSSES_SP)
        _a11_launches(f"train_ulysses rank {r['rank']}", run["launches"],
                      {n: layers * ULYSSES_STEPS for n in BHSD_WRAPPERS})
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
        if run["losses"] != ranks[0]["train_ulysses"]["losses"]:
            raise AssertionError("train_ulysses: the ranks report different losses")
    run = ranks[0]["train_ulysses"]
    if run["seqs"] != [cfg.sequence_length]:
        raise AssertionError(f"train_ulysses: attended {run['seqs']}")
    start = time.perf_counter()
    if single is None:
        with dp_group():
            single = _ulysses_run(cfg, device, 1, torch.bfloat16, 1, alpha=1e-4)
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    single_s = time.perf_counter() - start
    rel = abs(run["warmup_losses"][0] - single["losses"][0]) / abs(single["losses"][0])
    if not rel < PARITY_BOUND:
        raise AssertionError(f"train_ulysses: first loss {run['warmup_losses'][0]} vs the "
                             f"single device's {single['losses'][0]}")
    median_ms = statistics.median(run["step_ms"])
    emit({"phase": "train_ulysses", "plan": "ulysses sp2", "ranks": 2, "sharing": f"2 {SHARED}",
          "card": smi, "config": dataclasses.asdict(cfg), "compute_dtype": "bf16",
          "optimizer": "adam(alpha=1e-4)", "heads_per_rank_attended": cfg.num_heads // 2,
          "attended_seq": run["seqs"], "bwd_route": "row 12 (s > block)",
          "warmup_losses": run["warmup_losses"], "losses": run["losses"],
          "first_loss_single_device": single["losses"][0], "first_loss_rel_err": rel,
          "bound": PARITY_BOUND, "step_ms": run["step_ms"], "median_step_ms": median_ms,
          "tokens_per_s": cfg.batch_size * cfg.sequence_length / (median_ms / 1e3),
          "single_device_step_ms": single["step_ms"],
          "step_flops": run["step_flops"], "mfu": _mfu(run["step_flops"], median_ms, 2),
          "collectives_per_step": run["implied"], "launches_per_rank": run["launches"],
          "ring_steps": run["ring_steps"], "rank_wall_s": run["wall_s"],
          "single_device_s": single_s,
          "note": "step times measure host-staged gloo all-to-alls and all-reduces of two "
                  "processes on one card, not NVLink or NCCL"})
    return launches


def _moe_layer_inputs(cfg: dict, device):
    import torch
    from flexflow_tpu_torch.op_attrs.ops import ExpertsAttrs

    gen = torch.Generator().manual_seed(3)
    d, e, h = cfg["d"], cfg["experts"], cfg["hidden"]
    attrs = ExpertsAttrs(e, cfg["select"], h, capacity_factor=cfg["alpha"],
                         lambda_bal=cfg["lam"])
    shapes = [(d, e), (e, d, h), (e, h), (e, h, d), (e, d)]
    scales = [0.5 / math.sqrt(d) * 8, 1 / math.sqrt(d), 0.1, 1 / math.sqrt(h), 0.1]
    ws = [(torch.randn(*s, generator=gen) * c).to(device) for s, c in zip(shapes, scales)]
    x = torch.randn(cfg["tokens"], d, generator=gen).to(device)
    cot = torch.randn(cfg["tokens"], d, generator=gen).to(device)
    return attrs, x, ws, cot


def _moe_layer(fn, attrs, x, ws, cot, **kw):
    """fn's outputs and the gradients of sum(out * cot) + aux with respect
    to x and every weight."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in [x] + ws]
    outs = fn(attrs, leaves[0], leaves[1:], **kw)
    loss = (outs[0] * cot).sum() + outs[1].sum()
    return outs, torch.autograd.grad(loss, leaves)


def phase_parity_moe(smi: str, device: str = "cuda", layer: dict = MOE_LAYER,
                     small: dict = MOE_SMALL) -> None:
    """(a) fit_moe's Experts layer alone on the card, f32: the index path
    against the dense plain version (the JAX package's one-hot einsums) on
    the same inputs: the routing decisions and the drops identical, the
    output, the aux loss and every gradient within MOE_LAYER_BOUND, both
    timed. (b) a small MoE encoder through FFModel, two SGD steps on the
    card (bf16, rows 1-3) and on the CPU (f32) from the same parameters:
    the losses within PARITY_BOUND, and the share of routing decisions that
    differ (bf16 can flip a near tie)."""
    import numpy as np
    import torch
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import moe

    attrs, x, ws, cot = _moe_layer_inputs(layer, device)
    decisions = {}
    idx, gidx = _moe_layer(moe.experts_forward, attrs, x, ws, cot, decisions=decisions)
    dense, gdense = _moe_layer(moe.experts_forward_dense, attrs, x, ws, cot)
    cap = decisions["capacity"]
    a, pos = decisions["topi"].reshape(-1), decisions["pos"]
    mask = moe.dispatch_mask(a, attrs.num_experts, cap)
    kept = pos < cap
    n_kept = int(kept.sum())
    same = (int(mask.sum()) == n_kept and bool(mask[torch.nonzero(kept)[:, 0], a[kept],
                                                     pos[kept]].all()))
    del mask
    def rel(got, want):
        return float((got - want).detach().double().norm() / want.detach().double().norm())

    errs = {"out": rel(idx[0], dense[0]), "aux": rel(idx[1], dense[1]),
            **{f"grad_{n}": rel(g, h) for n, g, h in zip(
                ("x", "gate", "w1", "b1", "w2", "b2"), gidx, gdense)}}
    if not same or max(errs.values()) >= MOE_LAYER_BOUND:
        raise AssertionError(f"parity_moe (a): decisions equal {same}, errors {errs}")

    def step(fn):
        outs, _ = _moe_layer(fn, attrs, x, ws, cot)
        return outs

    times = {"index_ms": time_ms(lambda: step(moe.experts_forward), 5),
             "dense_ms": time_ms(lambda: step(moe.experts_forward_dense), 3)}
    del idx, gidx, dense, gdense
    torch.cuda.empty_cache() if device != "cpu" else None
    emit({"phase": "parity_moe", "part": "experts_layer", "card": smi, "config": layer,
          "dtype": "f32, TF32 off", "capacity": cap, "decisions": int(a.numel()),
          "kept": n_kept, "dropped": int(a.numel()) - n_kept, "decisions_equal": same,
          "rel_err": errs, "bound": MOE_LAYER_BOUND, "forward_backward_ms": times})

    # (b) the small encoder, card (bf16) against CPU (f32)
    cpu = _moe_model(core, small, "encoder", "cpu")
    cpu.compile(core.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy")
    init = {k: v.detach().numpy().copy() for k, v in cpu.params.items()}
    rs = np.random.default_rng(5)
    n = 2 * small["batch"]
    xs = rs.standard_normal((n, small["seq"], small["data_dim"]), dtype=np.float32)
    ys = rs.integers(0, small["classes"], (n, small["seq"]), dtype=np.int32)
    routed, real = {}, moe.experts_forward

    def recording(where):
        def experts_forward(*args, **kw):
            d = {}
            out = real(*args, decisions=d, **kw)
            routed.setdefault(where, []).append(d["topi"].cpu())
            return out
        return experts_forward

    losses = {}
    for where, dev, dtype in (("cpu", "cpu", None), ("cuda", device, torch.bfloat16)):
        m = cpu if where == "cpu" else _moe_model(core, small, "encoder", dev)
        if where != "cpu":
            m.compile(core.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
                      compute_dtype=dtype)
            ffmodel_state_from_numpy(m, init)
        fa.reset_launch_counts()
        moe.experts_forward = recording(where)
        try:
            run = _moe_fit(m, xs, ys, small["batch"])
        finally:
            moe.experts_forward = real
        losses[where] = run["losses"]
        launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    if device != "cpu":
        _a11_launches("parity_moe (b)", launches,
                      {name: 2 * small["layers"] for name in FLASH_WRAPPERS})
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    differ = sum(int((a != b).sum()) for a, b in zip(routed["cuda"], routed["cpu"]))
    total = sum(t.numel() for t in routed["cpu"])
    if not max(rel) < PARITY_BOUND:
        raise AssertionError(f"parity_moe (b): card losses {losses['cuda']} vs CPU "
                             f"{losses['cpu']}")
    emit({"phase": "parity_moe", "part": "encoder", "card": smi, "config": small,
          "losses": losses, "rel_err": rel, "bound": PARITY_BOUND,
          "routing_decisions": total, "decisions_differing": differ,
          "decisions_differing_share": differ / total, "launches": launches})


MOE_PROFILE_RANGES = {"route": "gate", "positions": "gate", "_dispatch": "dispatch",
                      "_expert_mlp": "expert_products", "_combine": "combine"}


def _moe_step_profile(m, x, y) -> dict:
    """One fit step under the profiler, each MoE helper of kernels/moe.py in
    a range: the device ms of the kernels each launches, forward and (by
    the autograd nodes of the ops it ran: the same sequence numbers)
    backward, beside the step's kernel ms and host ms."""
    import torch
    from torch.autograd import DeviceType
    from flexflow_tpu_torch.kernels import moe
    from flexflow_tpu_torch.profile_step import device_trace

    real = {name: getattr(moe, name) for name in MOE_PROFILE_RANGES}

    def ranged(name, fn):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(f"moe.{name}"):
                return fn(*a, **kw)
        return wrapped

    for name, fn in real.items():
        setattr(moe, name, ranged(name, fn))
    try:
        torch.cuda.synchronize()
        with device_trace() as prof:
            start = time.perf_counter()
            m.fit(x, y, epochs=1, shuffle=False, verbose=False)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - start) * 1e3
    finally:
        for name, fn in real.items():
            setattr(moe, name, fn)
    events = prof.events()

    def part_of(e):
        p = e
        while p is not None:
            if p.name.startswith("moe."):
                return MOE_PROFILE_RANGES[p.name[4:]]
            p = p.cpu_parent
        return None

    seq_part = {}
    for e in events:
        if e.device_type == DeviceType.CPU and getattr(e, "sequence_nr", -1) >= 0:
            part = part_of(e)
            if part is not None:
                seq_part.setdefault(e.sequence_nr, part)
    parts = {f"{p}_{d}": 0.0 for p in set(MOE_PROFILE_RANGES.values())
             for d in ("forward", "backward")}
    by_kernel, kernel_ms = {}, 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        kernel_ms += ms
        part, direction = part_of(e), "forward"
        if part is None:
            p = e
            while p is not None and part is None:
                if "Backward" in p.name and getattr(p, "sequence_nr", -1) in seq_part:
                    part, direction = seq_part[p.sequence_nr], "backward"
                p = p.cpu_parent
        if part is not None:
            parts[f"{part}_{direction}"] += ms
            for k in e.kernels:
                key = (f"{part}_{direction}", k.name[:80])
                by_kernel[key] = by_kernel.get(key, 0.0) + k.duration / 1e3
    top = {}
    for (part, name), ms in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        if len(top.setdefault(part, [])) < 3:
            top[part].append({"kernel": name, "ms": ms})
    moe_ms = sum(parts.values())
    # the kernels each operator launched, once each (key_averages' CUDA
    # rows would add the ranges' own device annotations to them)
    return {"host_ms": host_ms, "kernel_ms": kernel_ms, "moe_ms": parts,
            "moe_top_kernels": top, "moe_total_ms": moe_ms,
            "moe_share_of_kernel_ms": moe_ms / kernel_ms,
            "moe_share_of_step_ms": moe_ms / host_ms}


def phase_fit_moe(smi: str, steps: int = STEPS, cfg: dict = FIT_MOE, device: str = "cuda"):
    """examples/moe.py --encoder at the flagship's widths (FIT_MOE) through
    FFModel in bf16 with the example's SGD: a warm-up batch, a timed fit of
    `steps` seeded host batches with the launch counts set to 0 just
    before (rows 1-3 once per layer a step, no other flash or ring
    kernel), then one profiled step: the MoE layers' share by gate,
    dispatch, expert products and combine."""
    import numpy as np
    import torch
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.kernels import flash_attention as fa

    start = time.perf_counter()
    m = _moe_model(core, cfg, "encoder", device)
    m.compile(core.SGDOptimizer(lr=m.config.learning_rate), "sparse_categorical_crossentropy",
              metrics=["accuracy"], compute_dtype=torch.bfloat16)
    b = cfg["batch"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(((steps + 2) * b, cfg["seq"], cfg["data_dim"]), dtype=np.float32)
    y = rng.integers(0, cfg["classes"], ((steps + 2) * b, cfg["seq"]), dtype=np.int32)
    _sync(device)
    setup_s = time.perf_counter() - start
    t0 = time.perf_counter()
    m.fit(x[:b], y[:b], epochs=1, shuffle=False, verbose=False)
    warm_ms = (time.perf_counter() - t0) * 1e3
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    perf = m.fit(x[b:(steps + 1) * b], y[b:(steps + 1) * b], epochs=1, shuffle=False,
                 verbose=False)
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    peak = ({"allocated": torch.cuda.max_memory_allocated(),
             "reserved": torch.cuda.max_memory_reserved()} if device != "cpu" else {})
    if device != "cpu":
        _a11_launches("fit_moe", launches, {n: cfg["layers"] * steps for n in FLASH_WRAPPERS})
    if perf.train_all != steps * b * cfg["seq"]:
        raise AssertionError(f"fit_moe: {perf}")
    profile = (_moe_step_profile(m, x[(steps + 1) * b:], y[(steps + 1) * b:])
               if device != "cpu" else {})
    step_ms = elapsed * 1e3 / steps
    flops = 3 * _graph_forward_flops(m.cg)
    emit({"phase": "fit_moe", "card": smi, "config": cfg, "compute_dtype": "bf16",
          "optimizer": f"sgd(lr={m.config.learning_rate})", "setup_s": setup_s,
          "warmup_fit_ms": warm_ms, "steps": steps, "step_ms": step_ms,
          "step_ms_is": "the timed fit call's elapsed / steps, ending in one synchronize",
          "tokens_per_s": b * cfg["seq"] / (step_ms / 1e3), "step_flops": flops,
          "step_flops_are": "3 x op_forward_flops over the graph (Experts by kernels/ops.py's "
                            "count: gate, the JAX package's dense dispatch and combine, the "
                            "expert MLPs at capacity)",
          "mfu": flops / (step_ms / 1e3) / PEAK_BF16, "peak_memory_bytes": peak,
          "accuracy": perf.accuracy, "perf": dataclasses.asdict(perf),
          "profiled_step": profile, "launches": launches,
          "launches_per_step_each": cfg["layers"]})
    del m
    if device != "cpu":
        torch.cuda.empty_cache()
    return {n: launches[n] for n in FLASH_WRAPPERS}


def _moe_single(tmp_files: dict, device, searched: dict = MOE_SEARCHED,
                small: dict = MOE_SMALL) -> dict:
    """moe_ranks's single-device references on the card, f32: the searched
    model's fit (a), the dp2 x ep2 model's steps (b), the encoder's fit (c)."""
    import numpy as np
    import torch
    from flexflow_tpu_torch import core

    out = {}
    for kind, cfg in (("searched", dict(searched, lam=MOE_RANKS_LAMBDA)),
                      ("encoder", dict(small, lam=MOE_RANKS_LAMBDA))):
        data = np.load(tmp_files[kind])
        m = _moe_model(core, cfg, kind, device)
        m.compile(core.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                  metrics=["accuracy", "sparse_categorical_crossentropy"])
        _set_named_weights(m, dict(data))
        out[kind] = _moe_fit(m, data["x"], data["y"], cfg["batch"])
        del m
    data = np.load(tmp_files["ep"])
    graph, logits, aux = _moe_ep_graph(False)
    x, y = torch.tensor(data["x"], device=device), torch.tensor(data["y"], device=device)
    out["ep"] = _moe_ep_train(graph, logits, aux, dict(data), x, y, device)
    return out


def _worst_rel(got: dict, want: dict) -> float:
    import numpy as np

    return max(float(np.linalg.norm(np.asarray(got[k]) - np.asarray(v))
                     / max(np.linalg.norm(np.asarray(v)), 1e-30)) for k, v in want.items())


def phase_moe_ranks(smi: str, tmp: str, device: str = "cuda:0", **job) -> None:
    """(a) the searched compile of MOE_SEARCHED on 2 ranks (analytic, the
    H100 constants): the winner shards the experts, carries the aux loss,
    and trains within MOE_RANKS_BOUND of one card's fit from the same
    values; (b) the dp2 x ep2 PCG on 4 ranks, MOE_RANKS_STEPS steps,
    against the single-device steps; (c) a data-parallel FFModel fit of the
    small encoder on 2 ranks against one card's (the global batch's
    routing). f32, TF32 off, the load-balance weight MOE_RANKS_LAMBDA; each
    run's collectives."""
    ranks2 = _a11_job(2, tmp, device, **job)
    ranks4 = _a11_job(4, tmp, device, **job)
    job = {"moe_encoder": job.get("moe_small", MOE_SMALL), **job}
    single = _moe_single(A11_RESULTS["moe_files"], device, job.get("moe_searched", MOE_SEARCHED),
                         job.get("moe_small", MOE_SMALL))
    import numpy as np

    for kind, ranks in (("searched", ranks2), ("encoder", ranks2), ("ep", ranks4)):
        want = single[kind]
        for r in ranks:
            got = r[f"moe_{kind}"]
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
            weights = np.load(os.path.join(tmp, f"a11_{len(ranks)}.moe_{kind}.rank{r['rank']}"
                                                 ".npz"))
            param_rel = _worst_rel(weights, want["weights"])
            if not (loss_rel < MOE_RANKS_BOUND and param_rel < MOE_RANKS_BOUND):
                raise AssertionError(f"moe_ranks {kind} rank {r['rank']}: losses {got['losses']}"
                                     f" vs one card's {want['losses']}, worst parameter "
                                     f"{param_rel}")
            if kind == "ep":
                for step in got["per_step"]:
                    if step != got["implied"]:
                        raise AssertionError(f"moe_ranks ep rank {r['rank']}: {step}, the "
                                             f"plan implies {got['implied']}")
            elif got["aux"] != (1 if kind == "searched" else job["moe_encoder"]["layers"]):
                raise AssertionError(f"moe_ranks {kind}: {got['aux']} aux losses, one a layer "
                                     "expected")
        got = ranks[0][f"moe_{kind}"]
        record = {"phase": "moe_ranks", "run": kind, "ranks": len(ranks),
                  "sharing": f"{len(ranks)} {SHARED}", "card": smi, "dtype": "f32, TF32 off",
                  "lambda_bal": MOE_RANKS_LAMBDA, "losses": got["losses"],
                  "single_device_losses": want["losses"], "loss_rel_err": loss_rel,
                  "worst_param_rel_err": param_rel, "bound": MOE_RANKS_BOUND,
                  "wall_s": got["wall_s"]}
        if kind == "ep":
            record.update(config=MOE_EP, plan="dp2 x ep2", collectives_per_step=got["implied"])
        else:
            steps = MOE_RANKS_STEPS
            record.update(config=dict(job.get(f"moe_{kind}", MOE_SEARCHED if kind == "searched"
                                              else MOE_SMALL), lam=MOE_RANKS_LAMBDA),
                          instance=got["kind"], aux_losses=got["aux"],
                          collectives_per_step={k: v / steps for k, v in
                                                got["collectives"].items()},
                          implied_per_step=got["implied"])
            if kind == "searched":
                prov = got["provenance"]
                if got["kind"] != "DistributedTrainingInstance" or not got[
                        "expert_degrees"] or max(got["expert_degrees"]) < 2:
                    raise AssertionError(f"moe_ranks searched: {got['kind']}, expert degrees "
                                         f"{got['expert_degrees']}, {prov}")
                record.update(winner=prov["parallel_degrees"], expert_degrees=got[
                    "expert_degrees"], estimated_ms=prov["estimated_ms"],
                    serial_ms=prov["serial_ms"], cost_model="analytic, H100 constants")
            elif got["kind"] != "DataParallelTrainingInstance":
                raise AssertionError(f"moe_ranks encoder: {got['kind']}")
        emit(record)


# program-level verification on the card (A13, A8 part 2, A12 item 5): the
# searched flagship's winner verified on 2 ranks sharing the card, a
# recorded step's kernel census and fingerprint on one, a batch-growth
# recompile mid-fit and a resume against the re-anchored contract, the
# tp2 small flagship's collective census, and the serving contract
VERIFY = dict(FLAGSHIP_WIDTHS, batch=16)  # the full flagship, 12 layers, on 2 ranks
VERIFY_HBM_GB = 80.0
VERIFY_BATCH = 32  # the one-card recorded step, and the recompile's first batch
RECOMPILE_BATCH = 64
RECOMPILE_STEPS = (2, 2)  # steps at batch 32 (the trigger fires after the 2nd), then at 64
SERVE_CONTRACT = dict(slots=8, max_seq_len=256, window_steps=4)
A13_RESULTS = {}  # the verify rank job's ranks, read by comm_ranks

VERIFY_RANK_WORKER = r'''
import json, os, sys, time
import torch
import torch.distributed as dist
from flexflow_tpu_torch.analysis.comm_analysis import census_by_kind, verify_comm
from flexflow_tpu_torch.analysis.step_program import record_plan
from flexflow_tpu_torch.compiler.unity_algorithm import tensor_parallel_seed
from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.models import build_flagship_cg, build_flagship_pcg
from flexflow_tpu_torch.parallel import init_file_group
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification

rank, world, job = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
device = init_file_group(job["store"], rank, world, device=job["device"], backend="gloo",
                         timeout_s=job["timeout_s"])
cuda = device.type == "cuda"
out = {"rank": rank}
cfg = job["cfg"]
m = FFModel.from_computation_graph(
    *build_flagship_cg(**cfg), device=device,
    config=FFConfig(batch_size=cfg["batch"], seed=0, print_freq=0, search_budget=job["budget"],
                    hbm_gb=job["hbm_gb"]))
if cuda:
    torch.cuda.reset_peak_memory_stats(device)
start = time.perf_counter()
m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy", metrics=["accuracy"],
          compute_dtype=torch.bfloat16 if cuda else None)
out["compile_s"] = time.perf_counter() - start
prov = m.search_provenance
comm = dict(prov["comm"])
comm.pop("edges", None)
out["provenance"] = {k: prov.get(k) for k in ("parallel_degrees", "estimated_ms", "serial_ms",
                                              "verify", "memory", "exec")}
out["provenance"]["comm"] = comm
out["instance"] = type(m.instance).__name__
out["launches_after_compile"] = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
del m
if cuda:
    torch.cuda.empty_cache()
# comm_ranks: the small flagship under the tp2 seed, one recorded step
small = job["small"]
pcg = tensor_parallel_seed(build_flagship_pcg(**small), world)
spec = MachineSpecification(1, 1, world, 25.0, 400.0)
prog = record_plan(pcg, None, machine_spec=spec, device=device)
analysis, diags = verify_comm(pcg, None, machine_spec=spec, lowered=prog)
out["comm_ranks"] = dict(diags=[d.to_json() for d in diags], census=census_by_kind(
    analysis.collectives), host_transfers=prog.host_transfers, bytes_geomean=analysis.bytes_geomean,
    unmatched=len(analysis.unmatched), edges=len(analysis.edges), kernels=prog.kernel_route())
with open(f"{job['out']}.rank{rank}.json", "w") as f:
    json.dump(out, f, default=str)
dist.destroy_process_group()
'''

FINGERPRINT_JOB = r'''
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as c
m = c._verify_model(json.loads(sys.argv[1]), sys.argv[2])
print(json.dumps(m._exec_contract_record()))
'''


def _verify_model(cfg: dict, device: str = "cuda", **config):
    """The flagship (`cfg`: its widths and batch) on one card through
    FFModel (bf16, Adam), compiled."""
    import torch
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.models import build_flagship_cg

    m = FFModel.from_computation_graph(*build_flagship_cg(**cfg), device=device,
                                       config=FFConfig(batch_size=cfg["batch"], seed=0,
                                                       print_freq=0, **config))
    m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy", metrics=FIT_METRICS,
              compute_dtype=torch.bfloat16 if device != "cpu" else None)
    return m


def phase_verify(smi: str, tmp: str, device: str = "cuda:0", cfg: dict = VERIFY,
                 small: dict = TP_PARITY, one_card: dict = None) -> dict:
    """The searched compile of the full flagship on 2 ranks sharing the card
    at hbm_gb=80: its winner verifies clean (PCG, MV and MEM rules), its
    recorded step (one per rank, on copies of the state) gives the
    predicted per-device peak against the step's max_memory_allocated, an
    execution contract with no DET or DON finding, and a collective census
    with no COMM001, COMM002 or COMM004. Then on one card: the flagship's
    recorded step holds rows 1-3's kernels 12 times each and no
    nondeterministic op, and a second compile in a fresh process gives a
    bitwise-equal fingerprint. The job also runs comm_ranks's plan."""
    import torch
    from flexflow_tpu_torch.analysis.exec_contract import (
        analyze_step_program,
        contract_record,
        exec_diagnostics,
    )
    from flexflow_tpu_torch.analysis.step_program import record_step, step_example_args

    ranks = run_ranks(2, dict(name="verify", cfg=cfg, small=small, device=device, budget=2,
                              hbm_gb=VERIFY_HBM_GB, timeout_s=RANK_TIMEOUT_S), tmp,
                      worker=VERIFY_RANK_WORKER)
    A13_RESULTS["ranks"] = ranks
    rows = []
    for r in ranks:
        p = r["provenance"]
        if not p["verify"]["clean"]:
            raise AssertionError(f"verify rank {r['rank']}: winner verify {p['verify']}")
        ex = p["exec"]
        if "error" in ex or not ex["verify"]["clean"] or ex["determinism_findings"] or \
                ex["donation_coverage"] != 1.0:
            raise AssertionError(f"verify rank {r['rank']}: exec contract {ex}")
        comm = p["comm"]
        if "error" in comm or not comm["verify"]["clean"]:
            raise AssertionError(f"verify rank {r['rank']}: comm {comm}")
        mem = p["memory"]
        if device.startswith("cuda") and not mem.get("measured_per_device_bytes"):
            raise AssertionError(f"verify rank {r['rank']}: no measured peak {mem}")
        if any(r["launches_after_compile"].values()):
            raise AssertionError(f"verify rank {r['rank']}: the recorded step left launch "
                                 f"counts {r['launches_after_compile']}")
        rows.append(dict(rank=r["rank"], compile_s=r["compile_s"], instance=r["instance"],
                         winner=p["parallel_degrees"], estimated_ms=p["estimated_ms"],
                         verify=p["verify"], predicted_peak=mem["predicted_peak_bytes_per_device"],
                         full_mesh_peak=mem["predicted_peak_bytes_full_mesh"],
                         capacity_bytes=mem["capacity_bytes"],
                         measured_step_bytes=mem.get("measured_per_device_bytes"),
                         predicted_over_measured=mem.get("predicted_over_measured_geomean"),
                         full_mesh_over_measured=mem.get("full_mesh_over_measured_geomean"),
                         exec={k: ex[k] for k in ("program_fingerprint", "program_key",
                                                  "donated_leaves", "donation_coverage",
                                                  "kernel_launches", "recorded_ops")},
                         comm={k: comm[k] for k in ("census", "num_collectives", "buckets",
                                                    "bucket_members", "bytes_geomean",
                                                    "unmatched_collectives",
                                                    "host_transfers")}))
    if ranks[0]["provenance"]["exec"]["program_fingerprint"] != \
            ranks[1]["provenance"]["exec"]["program_fingerprint"]:
        raise AssertionError("verify: the ranks recorded different contracts")
    print(f"verify winner {rows[0]['winner']}: predicted/measured peak "
          f"{rows[0]['predicted_over_measured']} (full mesh {rows[0]['full_mesh_over_measured']})",
          flush=True)

    from flexflow_tpu_torch.models import FLAGSHIP

    one_card = one_card or dict(FLAGSHIP, batch=VERIFY_BATCH)
    on = "cuda" if device.startswith("cuda") else device
    m = _verify_model(one_card, on)
    prog = record_step(m.instance, m.params, m.opt_state, m.loss_attrs,
                       label_dtype=m._label_dtype)
    analysis = analyze_step_program(prog)
    diags = exec_diagnostics(analysis)
    want = {name: one_card["layers"] for name in FLASH_WRAPPERS} if on == "cuda" else {}
    if prog.kernel_route() != want or diags:
        raise AssertionError(f"verify: the one-card step's kernels {prog.kernel_route()} "
                             f"(expected {want}), diagnostics {[d.to_json() for d in diags]}")
    here = contract_record(analysis)
    step_bytes, recorded_ops = prog.step_bytes, len(prog.lines)
    del prog
    # the recording's cost: a second recorded step against the plain step
    # on the same arguments (host clock, each ending in a synchronize)
    x, label = step_example_args(m.instance, m.loss_attrs, label_dtype=m._label_dtype)

    def plain():
        gen = torch.Generator(device=m.device).manual_seed(0)
        m.instance._step(m.params, m.opt_state, x, label, gen)
        _sync(m.device)

    plain()
    t0 = time.perf_counter()
    plain()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    record_step(m.instance, m.params, m.opt_state, m.loss_attrs, label_dtype=m._label_dtype)
    _sync(m.device)
    recorded_ms = (time.perf_counter() - t0) * 1e3
    del m, x, label
    if on == "cuda":
        torch.cuda.empty_cache()
    fresh = subprocess.run([sys.executable, "-c", FINGERPRINT_JOB, json.dumps(one_card), on],
                           cwd=REPO,
                           capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    if fresh.returncode != 0:
        raise AssertionError(f"verify: the fresh process failed: {fresh.stderr[-3000:]}")
    there = json.loads(fresh.stdout.strip().splitlines()[-1])
    if there["program_fingerprint"] != here["program_fingerprint"]:
        raise AssertionError(f"verify: fingerprints differ across processes: {here} {there}")
    emit({"phase": "verify", "card": smi, "ranks": 2, "sharing": f"2 {SHARED}", "config": cfg,
          "hbm_gb": VERIFY_HBM_GB, "per_rank": rows,
          "one_card": {"config": one_card, "kernels": want, "det001": 0,
                       "recorded_ops": recorded_ops, "state_leaves": len(analysis.donation),
                       "step_bytes": step_bytes, "fingerprint": here["program_fingerprint"],
                       "fresh_process_bitwise_equal": True, "plain_step_ms": plain_ms,
                       "recorded_step_ms": recorded_ms,
                       "recording_overhead_ms": recorded_ms - plain_ms}})
    return {}


def phase_comm_ranks(smi: str) -> None:
    """The tp2 small flagship on verify's 2 ranks: its recorded step's
    collective census matched to the plan's movement edges with no
    COMM001, COMM002 or COMM004 (gloo's host staging is the transport)."""
    if "ranks" not in A13_RESULTS:
        raise AssertionError("comm_ranks reads verify's rank job: add verify to --phases")
    for r in A13_RESULTS["ranks"]:
        c = r["comm_ranks"]
        if c["diags"] or c["host_transfers"] or c["unmatched"]:
            raise AssertionError(f"comm_ranks rank {r['rank']}: {c}")
    emit({"phase": "comm_ranks", "card": smi, "ranks": 2, "sharing": f"2 {SHARED}",
          "config": TP_PARITY, "plan": "tp2", "rank0": A13_RESULTS["ranks"][0]["comm_ranks"]})


def phase_recompile(smi: str, tmp: str, device: str = "cuda", batches=(VERIFY_BATCH,
                    RECOMPILE_BATCH), steps=RECOMPILE_STEPS, flagship: dict = None) -> dict:
    """fit at batch 32 with checkpoints, a RecompileState growing it to 64
    after the 2nd step: the transition verified before the state carries
    over (TRN003 for the batch change, no TRN001, TRN002 or TRN004), the
    parameters and optimizer state carried bitwise, the contract's program
    changed (`program_changed`) and fit's contract beside the checkpoints
    re-anchored to the grown program, losses finite, rows 1-3 launched 12
    times a step on both sides. Then a new model at 64 resumes from the
    last checkpoint against that contract: `match: true`."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.analysis.exec_contract import (compare_contract_records,
                                                           read_contract_record)
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import FLAGSHIP
    from flexflow_tpu_torch.runtime.recompile import RecompileState

    FLAGSHIP = flagship or FLAGSHIP
    cuda = device != "cpu"
    b0, b1 = batches
    cdir = os.path.join(tmp, "recompile_ckpt")
    m = _verify_model(dict(FLAGSHIP, batch=b0), device, checkpoint_dir=cdir,
                      checkpoint_every_n_steps=sum(steps))
    n0 = b0 * steps[0] * 2  # the first epoch ends at the trigger, halfway
    n = max(n0, b1 * steps[1])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, FLAGSHIP["seq"], FLAGSHIP["embed"]), dtype=np.float32)
    y = rng.integers(0, FLAGSHIP["vocab"], (n, FLAGSHIP["seq"]), dtype=np.int32)
    losses, seen = [], {}
    counted = lambda: {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}  # noqa: E731

    def record_losses():
        step = m.instance.train_step

        def recorded(*a, **k):
            res = step(*a, **k)
            losses.append(float(res[2]))
            return res

        m.instance.train_step = recorded

    real_recompile = m.recompile

    def recompile(**kw):
        seen["before"] = counted()
        seen["contract"] = m._exec_contract_record()
        seen["state"] = {k: v.clone() for k, v in m.params.items()}
        seen["opt"] = {k: v.clone() for k, v in m.opt_state["m"].items()}
        real_recompile(**kw)
        seen["carried"] = (all(torch.equal(seen["state"][k], m.params[k]) for k in seen["state"])
                           and all(torch.equal(seen["opt"][k], m.opt_state["m"][k])
                                   for k in seen["opt"]))
        seen["transition"] = m.search_provenance["transition"]
        seen["after_contract"] = m._exec_contract_record()
        del seen["state"], seen["opt"]
        record_losses()

    m.recompile = recompile
    state = RecompileState(lambda ff: ff._step_count >= steps[0] and ff.config.batch_size == b0,
                           lambda ff: setattr(ff.config, "batch_size", b1))
    record_losses()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    m.fit(x, y, epochs=2, shuffle=False, verbose=False, recompile_state=state)
    fit_s = time.perf_counter() - t0
    total = counted()
    check, _ = compare_contract_records(seen["contract"], seen["after_contract"])
    anchored = read_contract_record(cdir)  # fit re-anchors it at the recompile
    trn = seen["transition"]
    want_side = {name: FLAGSHIP["layers"] * steps[0] if name in FLASH_WRAPPERS else 0
                 for name in total} if cuda else {name: 0 for name in total}
    after = {k: total[k] - seen["before"][k] for k in total}
    checks = {
        "one_recompile": state.recompilations == 1 and m.config.batch_size == b1,
        "steps": m._step_count == sum(steps) and len(losses) == sum(steps),
        "finite": all(math.isfinite(v) for v in losses),
        "transition_fatal_free": not set(trn["rules_tripped"]) & {"TRN001", "TRN002", "TRN004"},
        "trn003_for_the_batch": trn["rules_tripped"] == ["TRN003"],
        "program_changed": bool(check.get("program_changed")),
        "contract_re_anchored": anchored == seen["after_contract"],
        "carried_bitwise": seen["carried"],
        "launches_before": seen["before"] == want_side,
        "launches_after": after == {k: v * steps[1] // steps[0] for k, v in want_side.items()},
    }
    step_count = m._step_count
    del m
    if cuda:
        torch.cuda.empty_cache()
    m2 = _verify_model(dict(FLAGSHIP, batch=b1), device, checkpoint_dir=cdir,
                       checkpoint_every_n_steps=0)
    fa.reset_launch_counts()
    m2.fit(x[:b1 * steps[1]], y[:b1 * steps[1]], epochs=3, shuffle=False, verbose=False,
           resume=True)
    resumed = m2.exec_resume_check or {}
    checks["resume_match"] = resumed.get("match") is True
    checks["resumed_steps"] = m2._step_count == step_count + steps[1]
    if not all(checks.values()):
        raise AssertionError(f"recompile: {checks}, transition {trn}, contract check {check}, "
                             f"resume {resumed}, losses {losses}, launches before "
                             f"{seen['before']} after {after}")
    emit({"phase": "recompile", "card": smi, "config": dict(FLAGSHIP, batch=[b0, b1]),
          "steps": steps, "losses": losses, "fit_s": fit_s, "transition": {
              k: trn[k] for k in ("verdict", "rules_tripped", "leaves", "moved_leaves",
                                  "bulk_peak_bytes", "streamed_peak_bytes")},
          "contract_check": check, "resume_check": resumed, "launches_before": seen["before"],
          "launches_after": after, "checks": checks})
    del m2
    if cuda:
        torch.cuda.empty_cache()
    return total


def phase_serve_contract(smi: str, device: str = "cuda", lm: dict = SERVE_LM,
                         t: dict = SERVE_CONTRACT) -> None:
    """ServingProgram.exec_contract at the flagship's serving widths: a
    prefill and a decode window recorded with the KV cache as the in-place
    state: no DON finding (the cache written in place), no DET001, no
    flash launch (serving attention is dense)."""
    from flexflow_tpu_torch.analysis.memory_accounting import ServingMemorySpec
    from flexflow_tpu_torch.serving import ServingLMConfig, ServingProgram, build_serving_lm

    mem = ServingMemorySpec(max_concurrent_seqs=t["slots"], max_seq_len=t["max_seq_len"])
    cg, _ = build_serving_lm(ServingLMConfig(**lm), t["slots"], 1)
    program = ServingProgram(cg, mem, params_seed=0, device=device)
    before = _flash_launches()
    out = program.exec_contract(window_steps=t["window_steps"])
    if _flash_launches() != before:
        raise AssertionError("serve_contract: a flash kernel launched")
    rows = {}
    for call, (a, diags) in out.items():
        if diags or not a.donation or not all(r.aliased for r in a.donation):
            raise AssertionError(f"serve_contract {call}: {[d.to_json() for d in diags]}")
        rows[call] = {"program_key": a.program_key, "fingerprint": a.program_fingerprint,
                      "cache_leaves": len(a.donation), "cache_bytes": a.donated_bytes,
                      "in_place_coverage": a.donation_coverage, "step_bytes":
                      a.extra.get("step_bytes")}
    emit({"phase": "serve_contract", "card": smi, "config": lm, "traffic": t, **rows})


FRONTENDS_STEPS = 3  # timed Adam steps of the .ffir flagship, after one warm-up step
FRONTENDS_BOUND = 1e-4  # f32, TF32 off: fx forwards against torch's, Keras/ONNX losses vs the CPU's
FRONTENDS_KERAS = dict(batch=64, samples=512)  # the 784-512-512-10 MLP's one epoch
FIT_RUN = {}  # fit's step ms, tokens/s, MFU and peak memory, printed beside frontends'
FIT_HEALTH_RUN = {}  # fit_health's first telemetry metrics dir and its steps, read by frontends


def _fx_modules():
    """tests/test_torch_frontend.py's MLP, ConvNet and ResidualNet (copies:
    that file imports the JAX package), their input dims, and a post-LN
    block around nn.MultiheadAttention, which fx cannot map."""
    import torch
    import torch.nn as nn

    class MLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(16, 32)
            self.act = nn.ReLU()
            self.fc2 = nn.Linear(32, 8)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

    class ConvNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(3, 8, 3, stride=1, padding=1)
            self.pool = nn.MaxPool2d(2, 2)
            self.flatten = nn.Flatten()
            self.head = nn.Linear(8 * 8 * 8, 4)

        def forward(self, x):
            return self.head(self.flatten(self.pool(torch.relu(self.conv(x)))))

    class ResidualNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(16, 16)
            self.ln = nn.LayerNorm(16)

        def forward(self, x):
            return self.ln(x + self.fc(x))

    class AttentionBlock(nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = nn.MultiheadAttention(64, 4, batch_first=True)
            self.ln = nn.LayerNorm(64)

        def forward(self, x):
            out, _ = self.attn(x, x, x)
            return self.ln(x + out)

    return ({"mlp": (MLP, [4, 16]), "convnet": (ConvNet, [2, 3, 16, 16]),
             "residual": (ResidualNet, [4, 16])}, AttentionBlock)


def _call_tool(main, argv) -> tuple:
    """(exit code, stdout, stderr) of a tool's main(argv), in this process."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _card_and_cpu(build, device: str):
    """A model `build(device)` on the card and on the CPU, compiled, the
    CPU's parameters carried from the card's."""
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy, params_to_numpy

    card, cpu = build(device), build("cpu")
    ffmodel_state_from_numpy(cpu, params_to_numpy(card.params))
    return card, cpu


def _rel_close(phase: str, what: str, got: float, want: float) -> float:
    rel = abs(got - want) / max(abs(want), 1e-30)
    if not (math.isfinite(got) and rel <= FRONTENDS_BOUND):
        raise AssertionError(f"{phase}: {what} {got} vs the CPU's {want} (relative {rel})")
    return rel


def _frontends_ffir(cfg: dict, steps: int, device: str, work: str) -> tuple:
    """(a) the flagship written as an .ffir file, imported through
    PyTorchModel.from_file(...).apply_ir, compiled as fit does and fit; the
    launches; the same fit of build_flagship_cg's model from the same
    parameters, bitwise."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
    from flexflow_tpu_torch.frontends.torch_model import PyTorchModel
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import build_flagship_cg, build_flagship_ir, model_step_flops

    b, layers = cfg["batch"], cfg["layers"]
    path = os.path.join(work, "flagship.ffir")
    with open(path, "w") as f:
        for line in build_flagship_ir(**cfg):
            f.write(line.dumps() + "\n")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(((steps + 1) * b, cfg["seq"], cfg["embed"]), dtype=np.float32)
    y = rng.integers(0, cfg["vocab"], ((steps + 1) * b, cfg["seq"]), dtype=np.int32)

    def compiled(m, logits=None):
        m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy",
                  metrics=FIT_METRICS, logit_tensor=logits, compute_dtype=torch.bfloat16)
        return m

    config = dict(batch_size=b, seed=0, print_freq=0)
    held = torch.cuda.memory_allocated()  # what earlier phases still hold: in the peak below
    start = time.perf_counter()
    m = FFModel(FFConfig(**config), device=device)
    inp = m.create_tensor([b, cfg["seq"], cfg["embed"]], name="x")
    (logits,) = PyTorchModel.from_file(path).apply_ir(m, [inp])
    compiled(m, logits)
    init = {k: p.detach().to("cpu", copy=True) for k, p in m.params.items()}
    import_s = time.perf_counter() - start
    m.fit(x[:b], y[:b], epochs=1, shuffle=False, verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    perf = m.fit(x[b:], y[b:], epochs=1, shuffle=False, verbose=False)
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    peak = torch.cuda.max_memory_allocated()
    want = {n: layers * steps if n in FLASH_WRAPPERS else 0 for n in launches}
    if device != "cpu" and launches != want:
        raise AssertionError(f"frontends: the .ffir flagship launched {launches}, expected {want}")
    tokens = b * cfg["seq"]
    if perf.train_all != steps * tokens or not math.isfinite(perf.sparse_cce_loss):
        raise AssertionError(f"frontends: the .ffir flagship's fit: {perf}")
    final = {k: p.detach().to("cpu", copy=True) for k, p in m.params.items()}
    del m, logits, inp
    torch.cuda.empty_cache()

    r = compiled(FFModel.from_computation_graph(*build_flagship_cg(**cfg),
                                                config=FFConfig(**config), device=device))
    if r.params.keys() != init.keys():
        raise AssertionError("frontends: the .ffir graph's parameters are not build_flagship_cg's")
    with torch.no_grad():
        for k, p in r.params.items():
            p.copy_(init[k])
    r.fit(x[:b], y[:b], epochs=1, shuffle=False, verbose=False)
    r.fit(x[b:], y[b:], epochs=1, shuffle=False, verbose=False)
    differ = [k for k, p in r.params.items() if not torch.equal(p.detach().cpu(), final[k])]
    if differ:
        raise AssertionError(f"frontends: the .ffir flagship's parameters differ from "
                             f"build_flagship_cg's fitted from the same values: {differ[:6]}")
    del r
    torch.cuda.empty_cache()
    step_ms = elapsed * 1e3 / steps
    flops = model_step_flops(**cfg)
    out = {"config": cfg, "ffir_lines": len(build_flagship_ir(**cfg)),
           "import_and_compile_s": import_s, "steps": steps, "step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3), "mfu": flops / (step_ms / 1e3) / PEAK_BF16,
           "peak_memory_bytes": peak, "memory_held_before_bytes": held,
           "mean_sparse_cce": perf.sparse_cce_loss / perf.train_all,
           "launches": launches, "launches_per_step_each": layers,
           "bitwise_equal_to_build_flagship_cg": True, "fit": FIT_RUN or None}
    return out, {n: c for n, c in launches.items() if n in FLASH_WRAPPERS}


def _frontends_fx(device: str) -> dict:
    """(b) the fx route: each module on the card, imported, its weights
    transferred; the imported forward against the module's own; the
    attention block's trace raising getitem."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.frontends.torch_model import PyTorchModel, trace_to_ir

    modules, attention_block = _fx_modules()
    rows = {}
    for name, (cls, dims) in modules.items():
        torch.manual_seed(0)
        module = cls().to(device).eval()
        m = FFModel(FFConfig(batch_size=dims[0], print_freq=0, seed=0), device=device)
        pt = PyTorchModel(module)
        (out,) = pt.torch_to_ff(m, [m.create_tensor(dims, name="in0")])
        m.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy", logit_tensor=out)
        copied = pt.transfer_weights(m)
        feed = np.random.RandomState(0).randn(*dims).astype(np.float32)
        with torch.no_grad():
            want = module(torch.from_numpy(feed).to(device)).cpu().numpy()
            got = m.instance.forward(m.params, {"in0": feed}).cpu().numpy()
        err = float(np.max(np.abs(got - want)))
        if copied == 0 or not np.allclose(got, want, rtol=FRONTENDS_BOUND, atol=FRONTENDS_BOUND):
            raise AssertionError(f"frontends fx {name}: {copied} tensors transferred, forward "
                                 f"max abs err {err}")
        rows[name] = {"transferred": copied, "max_abs_err": err,
                      "ir_lines": len(trace_to_ir(module))}
    try:
        trace_to_ir(attention_block().to(device))
    except ValueError as e:
        if "unsupported torch function: getitem" not in str(e):
            raise
        rows["multihead_attention"] = {"raises": str(e)}
    else:
        raise AssertionError("frontends fx: tracing nn.MultiheadAttention did not raise getitem")
    return rows


def _frontends_keras(device: str, keras: dict, metrics_dir=None) -> dict:
    """(c) a Sequential 784-512-512-10 MLP and the functional two-branch
    Concatenate model, one epoch each on the card and on the CPU from the
    same parameters (f32). With `metrics_dir`, only the MLP's card fit,
    writing its run-health stream there; returns its step count."""
    import numpy as np
    from flexflow_tpu_torch.core import FFConfig
    from flexflow_tpu_torch.frontends import keras_model as k

    def mlp(dev, **config):
        model = k.Sequential([k.Dense(512, activation="relu", input_shape=(784,)),
                              k.Dense(512, activation="relu"), k.Dense(10)],
                             ffconfig=FFConfig(batch_size=keras["batch"], seed=0, print_freq=0,
                                               **config), device=dev)
        model.compile(optimizer=k.SGD(0.05), loss="sparse_categorical_crossentropy",
                      metrics=FIT_METRICS, batch_size=keras["batch"])
        model._materialize()
        return model

    def two_branch(dev):
        inp = k.Input((16,))
        merged = k.Concatenate(axis=1)([k.Dense(8, activation="relu")(inp),
                                        k.Dense(8, activation="tanh")(inp)])
        model = k.Model(inputs=inp, outputs=k.Dense(4)(merged),
                        ffconfig=FFConfig(batch_size=8, seed=0, print_freq=0), device=dev)
        model.compile(optimizer=k.SGD(0.05), loss="sparse_categorical_crossentropy",
                      metrics=FIT_METRICS, batch_size=8)
        model._materialize()
        return model

    rs = np.random.RandomState(0)
    data = {"mlp": (rs.randn(keras["samples"], 784).astype(np.float32),
                    rs.randint(0, 10, keras["samples"])),
            "two_branch": (rs.randn(16, 16).astype(np.float32), rs.randint(0, 4, 16))}
    if metrics_dir is not None:
        perf = mlp(device, metrics_dir=metrics_dir).fit(*data["mlp"], epochs=1, shuffle=False,
                                                         verbose=False)
        return perf.train_all // keras["batch"]
    rows = {}
    for name, build in (("mlp", mlp), ("two_branch", two_branch)):
        card, cpu = _card_and_cpu(lambda dev: build(dev).ffmodel, device)
        got, want = (m.fit(*data[name], epochs=1, shuffle=False, verbose=False)
                     for m in (card, cpu))
        rows[name] = {"loss": got.sparse_cce_loss, "cpu_loss": want.sparse_cce_loss,
                      "relative": _rel_close(f"frontends keras {name}", "loss",
                                             got.sparse_cce_loss, want.sparse_cce_loss),
                      "samples": got.train_all, "accuracy": got.accuracy}
    return rows


def _frontends_onnx(device: str) -> dict:
    """(d) tests/fixtures/tiny_mlp.onnx through the wire-format reader, two
    SGD steps on the card and on the CPU from the same parameters."""
    import numpy as np
    from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.frontends.onnx_model import ONNXModel

    path = os.path.join(REPO, "tests", "fixtures", "tiny_mlp.onnx")
    onnx = ONNXModel(path)
    if onnx.onnx is not None or onnx.model.graph.name != "tiny_mlp":
        raise AssertionError("frontends onnx: the fixture did not go through the wire-format "
                             "reader")

    def build(dev):
        m = FFModel(FFConfig(batch_size=4, seed=0, print_freq=0), device=dev)
        (logits,) = onnx.apply(m, [m.create_tensor([4, 8], name="x")])
        m.compile(SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", metrics=FIT_METRICS,
                  logit_tensor=logits)
        return m

    card, cpu = _card_and_cpu(build, device)
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(8, 8).astype(np.float32), rs.randint(0, 3, (8,)).astype(np.int32)
    losses = []
    for step in range(2):
        rows = slice(4 * step, 4 * step + 4)
        got, want = (m.fit(xs[rows], ys[rows], epochs=1, shuffle=False, verbose=False)
                     for m in (card, cpu))
        losses.append({"loss": got.sparse_cce_loss, "cpu_loss": want.sparse_cce_loss,
                       "relative": _rel_close("frontends onnx", f"step {step} loss",
                                              got.sparse_cce_loss, want.sparse_cce_loss)})
    return {"ops": len(onnx.model.graph.node), "steps": losses}


def _frontends_clis(device: str, work: str, keras: dict) -> dict:
    """(e) cost_db verify and stats on search's store; ffreport --json on a
    metrics dir the port wrote on this card (fit_health's, else a short fit
    of the Keras MLP here)."""
    from flexflow_tpu_torch.compiler.cost_store import device_kind_signature
    from flexflow_tpu_torch.tools import cost_db, ffreport

    store = SEARCH_RUN.get("store_dir")
    if not store:
        raise AssertionError("frontends reads search's cost store: add search to --phases")
    rc, out, err = _call_tool(cost_db.main, ["verify", store])
    if rc != 0:
        raise AssertionError(f"frontends: cost_db verify exited {rc}: {err[-2000:]}")
    rc, stats, err = _call_tool(cost_db.main, ["stats", store, "--json"])
    stats = json.loads(stats)
    kind = device_kind_signature(device)
    if rc != 0 or kind not in stats["by_device_kind"]:
        raise AssertionError(f"frontends: cost_db stats exited {rc}, device kinds "
                             f"{stats['by_device_kind']}, expected {kind}")
    if FIT_HEALTH_RUN and os.path.isdir(FIT_HEALTH_RUN["metrics_dir"]):
        metrics, steps = FIT_HEALTH_RUN["metrics_dir"], FIT_HEALTH_RUN["steps"]
        source = "fit_health"
    else:
        metrics = os.path.join(work, "metrics")
        steps, source = _frontends_keras(device, keras, metrics_dir=metrics), "keras mlp"
    rc, report, err = _call_tool(ffreport.main, ["--json", metrics])
    sections = {s["section"]: s for s in map(json.loads, report.splitlines())}
    if rc != 0 or sections["health"]["steps"] != steps:
        raise AssertionError(f"frontends: ffreport exited {rc}, health {sections.get('health')}, "
                             f"expected {steps} steps: {err[-2000:]}")
    return {"cost_db": {"verify": out.strip(), "entries": stats["entries"],
                        "by_device_kind": stats["by_device_kind"]},
            "ffreport": {"metrics_dir_of": source, "health": sections["health"],
                         "sections": sorted(sections)}}


def phase_frontends(smi: str, steps: int = FRONTENDS_STEPS, cfg=None, device: str = "cuda",
                    keras: dict = FRONTENDS_KERAS):
    """The model frontends on the card (needs search, whose cost store the
    CLIs read; reads fit_health's metrics dir where it ran): (a) the
    flagship as an .ffir file through PyTorchModel.from_file(...).apply_ir,
    compiled as fit does (bf16, Adam(1e-4)), a warm-up fit and `steps` timed
    steps: rows 1-3 12 times a step each and no other wrapper, and bitwise
    the build_flagship_cg model fitted from the same parameters on the same
    batches; (b) the fx route on modules on the card, forwards within 1e-4
    of torch's, the getitem limit; (c) Keras and (d) ONNX, losses within
    1e-4 of the CPU port's (f32); (e) the cost_db and ffreport tools on this
    card's own store and metrics dir."""
    from flexflow_tpu_torch.models import FLAGSHIP

    cfg = cfg or FLAGSHIP
    work = tempfile.mkdtemp(prefix="frontends_")
    try:
        start = time.perf_counter()
        ffir, launches = _frontends_ffir(cfg, steps, device, work)
        parts = {"ffir_flagship": ffir, "fx": _frontends_fx(device),
                 "keras": _frontends_keras(device, keras), "onnx": _frontends_onnx(device),
                 "clis": _frontends_clis(device, work, keras)}
        emit({"phase": "frontends", "card": smi, **parts,
              "wall_s": time.perf_counter() - start})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# ab: the port's Unity-vs-DP A/B harness (tools/bench_ab.py) on 2 gloo
# ranks sharing the card. The transformer at the flagship's widths (embed
# 1024, 8 heads of 128, seq 512, vocab 32000) at 2 layers and batch 16; the
# MLP at 4096 wide, 2 layers, batch 64 (MLP_Unify's 8192 would all-reduce
# ~805 MB of weights a step through host memory, ~1.4 s a step over gloo).
# Each plan one untimed step and 3 two-point samples of 1 and 3 steps, the
# search at bench_ab's default budget on the analytic estimator.
AB_SUBJECTS = {
    "mlp": ["--embed", "4096", "--layers", "2", "--batch", "64"],
    "transformer": ["--batch", "16", "--layers", "2"],
}
AB_LAYERS = 2
AB_ITERS = (1, 3)
AB_SAMPLES = 3
AB_STEPS = 1 + AB_SAMPLES * sum(AB_ITERS)  # train steps each plan runs
# each plan's first loss against the DP plan's, from the same values (bf16):
# the ranks tests' tolerance where both run the same per-row products; a
# plan that sums tensor-parallel partials (a Reduction) rounds its bf16
# products in another order, and is held to train_tp's bound for that
AB_LOSS_RTOL = 1e-5
AB_PARTIALS_RTOL = PARITY_BOUND

# One rank of the ab phase; argv: rank, world, job (JSON). The rank opens a
# gloo group on the job's device and runs bench_ab's subjects as the tool's
# own ranks do, each plan's time_steps between a reset and a read of the
# kernel wrappers' launch counts.
AB_RANK_WORKER = r'''
import json, os, sys, time
import torch
import torch.distributed as dist
from flexflow_tpu_torch.compiler.unity_algorithm import data_parallel_seed, parallel_degree_summary
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.op_attrs.ops import (MultiHeadAttentionAttrs, RingAttentionAttrs,
                                             UlyssesAttentionAttrs)
from flexflow_tpu_torch.parallel import init_file_group
from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph
from flexflow_tpu_torch.tools import bench_ab

rank, world, job = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
device = init_file_group(job["store"], rank, world, device=job["device"], backend="gloo")
timed = bench_ab.time_steps


def route(pcg):
    """The attention route of a plan: ring, ulysses, the per-head flash
    kernels, or None without attention."""
    kinds = {type(pcg.op_attrs(n)) for n in pcg.topological_ordering()}
    if UlyssesAttentionAttrs in kinds:
        return "ulysses"
    if RingAttentionAttrs in kinds:
        return "ring"
    return "per-head flash" if MultiHeadAttentionAttrs in kinds else None


def counted(m, xv, yv, batch, record=None, **kw):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fa.reset_launch_counts()
    t = timed(m, xv, yv, batch, record=record, **kw)
    record["launches"] = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    pcg = getattr(m.instance, "pcg", None)
    if pcg is None:  # the data-parallel trainer: the dp seed of the graph
        pcg = data_parallel_seed(pcg_from_computation_graph(m.cg), world)
    record["parallel_degrees"] = parallel_degree_summary(pcg)
    record["route"] = route(pcg)
    return t


bench_ab.time_steps = counted
out = {"rank": rank, "subjects": {}}
for subject, argv in job["subjects"].items():
    args = bench_ab.parse_args(["--model", subject, "--device", job["device"], *argv])
    plans = {}
    start = time.perf_counter()
    line = bench_ab.run_subject(subject, args, world, device.type == "cpu",
                                iters=tuple(job["iters"]), samples=job["samples"], records=plans)
    out["subjects"][subject] = dict(line=line, plans=plans, wall_s=time.perf_counter() - start)
with open(f"{job['out']}.rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def _check_ab_launches(subject: str, label: str, ranks, layers: int) -> dict:
    """A plan's launches on every rank over its AB_STEPS steps: the MLP
    none; the transformer's per-head flash or Ulysses route rows 9-11 once
    per layer per step and no other wrapper, a ring route rows 13-15 a
    whole number of times per layer per step each, all three alike, with
    row 10's delta once. Returns the launches summed over the ranks."""
    plans = [dict(rank=r["rank"], plan=r["subjects"][subject]["plans"][label]) for r in ranks]
    phase = f"ab {subject} {label}"
    for p in plans:
        if p["plan"]["steps"] != AB_STEPS:
            raise AssertionError(f"{phase} rank {p['rank']}: {p['plan']['steps']} steps timed")
    if subject == "mlp":
        return _check_rank_launches(phase, plans, 0, AB_STEPS, key="plan")
    if plans[0]["plan"]["route"] != "ring":
        return _check_rank_launches(phase, plans, layers, AB_STEPS, key="plan")
    total = {}
    for p in plans:
        got = p["plan"]["launches"]
        ring = {got[n] for n in RING_WRAPPERS}
        per = layers * AB_STEPS
        if (len(ring) != 1 or not min(ring) or min(ring) % per
                or got["flash_delta_bhsd"] != per
                or any(n for k, n in got.items() if k not in (*RING_WRAPPERS, "flash_delta_bhsd"))):
            raise AssertionError(f"{phase} rank {p['rank']}: ring route launches {got}")
        for name, n in got.items():
            total[name] = total.get(name, 0) + n
    return total


def phase_ab(smi: str, tmp: str, device: str = "cuda:0", subjects: dict = AB_SUBJECTS,
             layers: int = AB_LAYERS) -> dict:
    """The port's A/B harness (python3 -m flexflow_tpu_torch.tools.bench_ab)
    on 2 gloo ranks sharing the card: for each of AB_SUBJECTS the searched
    plan (rank 0 searches, analytic, budget 12) and the data-parallel plan
    from the same initial values, each timed by bench_ab's time_steps at
    AB_ITERS x AB_SAMPLES: both plans' parallel degrees, step ms, the
    speedup, the search's estimate and seconds; each plan's first loss
    within AB_LOSS_RTOL of the DP plan's (AB_PARTIALS_RTOL where it sums
    tensor-parallel partials), every step time finite, the
    launches of each plan (the transformer's rows 9-11 once per layer per
    step on every rank, or its ring's); then merge_ab's note over the lines.
    The step times rank plans only: the ranks share one card and their
    collectives go through host memory."""
    from flexflow_tpu_torch.tools import merge_ab

    start = time.perf_counter()
    ranks = run_ranks(2, dict(name="ab", device=device, subjects=subjects, iters=list(AB_ITERS),
                              samples=AB_SAMPLES), tmp, worker=AB_RANK_WORKER)
    launches, report = {}, {}
    for subject in subjects:
        line = ranks[0]["subjects"][subject]["line"]
        plans = {r["rank"]: r["subjects"][subject]["plans"] for r in ranks}
        if any(plans[0][k]["first_loss"] != plans[1][k]["first_loss"] for k in plans[0]):
            raise AssertionError(f"ab {subject}: the ranks report different first losses")
        for key in ("unity_step_ms", "dp_step_ms"):
            if not (math.isfinite(line[key]) and line[key] > 0):
                raise AssertionError(f"ab {subject}: {key} {line[key]}")
        want = plans[0]["dp"]["first_loss"]
        rel, bounds = {}, {}
        for label, p in plans[0].items():
            rel[label] = abs(p["first_loss"] - want) / abs(want)
            bounds[label] = (AB_PARTIALS_RTOL if "reduction" in p["parallel_degrees"]
                             else AB_LOSS_RTOL)
            if not (math.isfinite(p["first_loss"]) and rel[label] <= bounds[label]):
                raise AssertionError(f"ab {subject} {label}: first loss {p['first_loss']} against "
                                     f"the DP plan's {want} (relative {rel[label]}, bound "
                                     f"{bounds[label]})")
        for label in plans[0]:
            for name, n in _check_ab_launches(subject, label, ranks, layers).items():
                launches[name] = launches.get(name, 0) + n
        unity, dp = plans[0]["unity"], plans[0]["dp"]
        report[subject] = {
            "shapes": line["shapes"], "searched_plan": unity["parallel_degrees"],
            "searched_route": unity["route"], "dp_plan": dp["parallel_degrees"],
            "trainers": {"unity": unity["instance"], "dp": dp["instance"]},
            "unity_step_ms": line["unity_step_ms"], "dp_step_ms": line["dp_step_ms"],
            "unity_vs_dp_speedup": line["value"],
            "search_estimated_ms": line["search_estimated_ms"],
            "search_serial_ms": line["search_serial_ms"],
            "search_seconds": line["search_seconds"], "search_explored": line["search_explored"],
            "search_seed_runtimes": line["search_seed_runtimes"],
            "first_losses": {k: p["first_loss"] for k, p in plans[0].items()},
            "first_loss_rel": rel, "first_loss_bound": bounds, "launches_per_rank": {k: p["launches"] for k, p in
                                                         plans[0].items()},
            "wall_s": ranks[0]["subjects"][subject]["wall_s"]}
        print(f"ab {subject}: searched {unity['parallel_degrees']} ({unity['route']}) "
              f"{line['unity_step_ms']} ms, dp {dp['parallel_degrees']} {line['dp_step_ms']} ms: "
              f"{line['value']}x; estimate {line['search_estimated_ms']} ms, search "
              f"{line['search_seconds']:.2f} s", flush=True)
    note = merge_ab.derive_note([ranks[0]["subjects"][s]["line"] for s in subjects])
    print(f"ab note: {note}", flush=True)
    emit({"phase": "ab", "ranks": 2, "sharing": f"2 {SHARED}", "card": smi,
          "iters": list(AB_ITERS), "samples": AB_SAMPLES, "steps_per_plan": AB_STEPS,
          "subjects": report, "note": note,
          "wall_s": time.perf_counter() - start})
    return launches


_WIDTH_SUFFIXES = {64: ("_p64_kernel", "_d64_kernel"), 192: ("_p192_kernel",),
                   256: ("_d256_kernel",)}


def _width_ptxas(ptxas: dict, wrapper: str, width: int) -> dict:
    """ptxas's report of the kernels through which `wrapper` runs the head
    dims of padded width `width`."""
    names = {*REDESIGNED.get(wrapper, ()), *WIDTH_KERNELS.get(wrapper, ())}
    others = tuple(x for sfx in _WIDTH_SUFFIXES.values() for x in sfx)
    return {n: ptxas[n] for n in sorted(names)
            if (not n.endswith(others) if width == 128 else n.endswith(_WIDTH_SUFFIXES[width]))}


def _phases(smi: str, kernels: list, launches: dict, ptxas: dict):
    """The phases in order, as groups: (a context manager factory or None,
    [(name, fn)]), where fn takes the context's value (a temporary
    directory, for the rank phases) when the group has one."""
    from flexflow_tpu_torch.models import FLAGSHIP, LONGCTX, REF_HEADS16

    def kernels_phase():
        kernels.extend(phase_kernels())
        for entry in kernels:
            if entry["name"] in REDESIGNED:
                entry["design"] = (DELTA_DESIGN if entry["name"] in DELTA_WRAPPERS
                                   else "wgmma+tma")
                entry["ptxas"] = {k: ptxas[k] for k in REDESIGNED[entry["name"]]}
            if "wrapper" in entry:  # a head dim the padded widths added
                wrapper, width = entry["wrapper"], entry["padded_width"]
                entry["design"] = (DELTA_DESIGN if wrapper in DELTA_WRAPPERS else
                                   D256_DESIGN if width > 128 else "wgmma+tma")
                entry["ptxas"] = _width_ptxas(ptxas, wrapper, width)
            if entry["name"] in WIDE_KERNELS:  # a head dim past 256
                entry["design"] = (WIDE_DELTA_DESIGN if "delta" in entry["name"]
                                   else WIDE_DESIGN)
                entry["ptxas"] = {k: ptxas[k] for k in WIDE_KERNELS[entry["name"]]}

    def train_step_ms(phase):
        if "train" not in MEDIAN_STEP_MS:
            raise AssertionError(f"{phase} reads train's median step: add train to --phases")
        return MEDIAN_STEP_MS["train"]

    def rec(name, fn, steps):
        return lambda *a: launches.__setitem__(name, (fn(*a), steps))

    def ranks_2(tmp):
        ranks2 = phase_ranks(smi, tmp, 2)
        launches["parity_ranks_window"] = (ranks2["parity_ranks_window"],
                                           2 * 2 * 2 * WINDOW_RANKS_STEPS)
        launches["calibrate_ranks"] = (ranks2["calibrate_ranks"], 2 * 2)

    return [
        (None, [
            ("kernels", kernels_phase),
            ("parity", phase_parity),
            ("train", rec("train", lambda: phase_train(smi, FLAGSHIP, "train", FLASH_WRAPPERS),
                          STEPS)),
            ("train_heads16", rec("train_heads16", lambda: phase_train(
                smi, REF_HEADS16, "train_heads16",
                ("flash_fwd_d64", "flash_delta_d64", "flash_bwd_d64")), STEPS)),
            # bench.py --heads 32: rows 1-3 at d=32, counted apart from d=128's
            ("train_heads32", rec("train_heads32", lambda: {
                f"{n}@d32": c for n, c in phase_train(
                    smi, dict(FLAGSHIP, heads=32), "train_heads32", FLASH_WRAPPERS).items()},
                STEPS)),
            # bench.py --heads 2: rows 1-3 at d=512, on the wide kernels
            ("train_heads2", rec("train_heads2", lambda: phase_train(
                smi, dict(FLAGSHIP, heads=2), "train_heads2", WIDE_FLASH_WRAPPERS), STEPS)),
            ("search", rec("search", lambda: phase_search(smi, train_step_ms("search")), 1)),
            # a fresh process plans from search's store; MCMC and the
            # foreign-kind run ride it
            ("search_warm", rec("search_warm", lambda: phase_search_warm(smi), 1)),
            ("search_mcmc", rec("search_mcmc", lambda: phase_search_mcmc(smi), 1)),
            ("search_nodes", lambda: phase_search_nodes(smi)),
            ("parity_fit", phase_parity_fit),
            ("stepped", phase_stepped),
            ("fit", rec("fit", lambda: phase_fit(smi), STEPS)),
            ("parity_fit_window", phase_parity_fit_window),
            # the windowed fit's count is the profiler's: a replayed graph
            # runs no wrapper
            ("fit_window", rec("fit_window", lambda: phase_fit_window(smi),
                               FIT_WINDOW_K * FIT_WINDOW_WINDOWS)),
            ("parity_zoo", phase_parity_zoo),
            ("fit_bert", rec("fit_bert", lambda: phase_fit_bert(smi), STEPS)),
            ("examples", phase_examples),
        ]),
        (dp_group, [
            ("parity_dp", lambda _: phase_parity_dp()),
            ("train_dp", rec("train_dp", lambda _: phase_train(
                smi, FLAGSHIP, "train_dp", BHSD_WRAPPERS, dp=True), STEPS)),
            ("train_dp_seq2048", rec("train_dp_seq2048", lambda _: phase_train(
                smi, LONGCTX, "train_dp_seq2048", BHSD_WRAPPERS, dp=True), STEPS)),
            # rows 9-12 at d=256, counted apart from d=128's
            ("fit_bert_dp", rec("fit_bert_dp", lambda _: phase_fit_bert_dp(smi), STEPS)),
            # rows 9-11 at d=512, on the wide kernels
            ("train_heads2_dp", rec("train_heads2_dp", lambda _: phase_train_heads2_dp(
                smi, dict(FLAGSHIP, heads=2)), STEPS)),
            # its d=96 replay's counts: one replay a step
            ("ring_replay", rec("ring_replay", lambda _: phase_ring_replay(), 1)),
            ("parity_sp", lambda _: phase_parity_sp()),
            ("train_sp", rec("train_sp", lambda _: phase_train_sp(smi), STEPS)),
            # the window's count is the profiler's
            ("train_dp_window", rec("train_dp_window", lambda _: phase_train_dp_window(smi),
                                    DP_WINDOW_K)),
        ]),
        # several ranks on the card, each a process of its own: after the
        # build, so no rank compiles a kernel; their counts are per rank and
        # step
        (tempfile.TemporaryDirectory, [
            ("parity_tp", rec("parity_tp", lambda tmp: phase_parity_tp(smi, tmp),
                              sum(2 * world for world, _ in TP_PARITY_PLANS.values()))),
            ("train_tp", rec("train_tp", lambda tmp: phase_train_tp(smi, tmp), 2 * TP_STEPS)),
            ("fit_searched", rec("fit_searched", lambda tmp: phase_fit_searched(smi, tmp),
                                 2 * FIT_SEARCHED_STEPS)),
            # parity_ranks_window imports fit_searched's strategy
            ("ranks_2", ranks_2),
            ("ranks_4", lambda tmp: phase_ranks(smi, tmp, 4)),
            ("torchrun", rec("torchrun", lambda tmp: phase_torchrun(smi, tmp),
                             2 * TORCHRUN_STEPS)),
            ("fit_overlap", rec("fit_overlap", lambda tmp: phase_fit_overlap(smi, tmp),
                                2 * OVERLAP_RULES_STEPS)),
        ]),
        (None, [
            ("parity_serve", phase_parity_serve),
            ("serve", lambda: phase_serve(smi)),
            # serving a searched plan (no kernel of the table runs: serving
            # attention is dense, each phase checks no flash launch)
            ("plan_serve", lambda: phase_plan_serve(smi, cfg=PLAN_SERVE_LM)),
        ]),
        (tempfile.TemporaryDirectory, [
            ("serve_ranks", lambda tmp: phase_serve_ranks(smi, tmp)),
            ("parity_plan_ops", lambda tmp: phase_parity_plan_ops(smi, tmp)),
        ]),
        # checkpoints, bitwise resume and the fault sites
        (None, [
            ("fit_resume", rec("fit_resume", lambda: phase_fit_resume(smi),
                               RESUME_FAULT_STEP_WINDOW)),
            ("chaos", lambda: phase_chaos(smi)),
        ]),
        (tempfile.TemporaryDirectory, [
            ("resume_ranks", rec("resume_ranks", lambda tmp: phase_resume_ranks(smi, tmp),
                                 2 * RESUME_RANKS_BATCHES * RESUME_RANKS_EPOCHS)),
            # pipeline parallelism and sub-mesh branches: one rank job per
            # rank count carries both (no kernel of the table runs there)
            ("train_pp", lambda tmp: phase_train_pp(smi, tmp)),
            ("fit_submesh", lambda _: phase_fit_submesh(smi)),
        ]),
        # observability: the step-health stream in the captured windows, the
        # policies, the roofline and the plan audit (the drift monitor and a
        # searched compile's audit ride fit_searched's job)
        (None, [
            ("fit_health", rec("fit_health", lambda: phase_fit_health(smi),
                               FIT_WINDOW_K * FIT_WINDOW_WINDOWS)),
            ("health_poison", lambda: phase_health_poison(smi)),
            ("roofline", lambda: phase_roofline(smi, step_ms=train_step_ms("roofline"))),
            ("plan_audit", lambda: phase_plan_audit(smi)),
        ]),
        # Ulysses attention and mixture of experts (A11): the experts layer
        # and the MoE encoder on one card, then one rank job per rank count
        # carrying parity_ulysses, train_ulysses and moe_ranks
        (None, [
            ("parity_moe", lambda: phase_parity_moe(smi)),
            ("fit_moe", rec("fit_moe", lambda: phase_fit_moe(smi), STEPS)),
        ]),
        (tempfile.TemporaryDirectory, [
            # the launches of 2 ranks x 2 models x 2 steps
            ("parity_ulysses", rec("parity_ulysses", lambda tmp: phase_parity_ulysses(smi, tmp),
                                   8)),
            ("train_ulysses", rec("train_ulysses", lambda tmp: phase_train_ulysses(smi, tmp),
                                  2 * ULYSSES_STEPS)),
            ("moe_ranks", lambda tmp: phase_moe_ranks(smi, tmp)),
        ]),
        # program-level verification (A13), recompiles (A8 part 2) and the
        # serving contract (A12 item 5): the searched winner verified on 2
        # ranks (whose job carries comm_ranks's plan), then on one card
        (tempfile.TemporaryDirectory, [
            ("verify", lambda tmp: phase_verify(smi, tmp)),
            ("comm_ranks", lambda _: phase_comm_ranks(smi)),
            ("recompile", rec("recompile", lambda tmp: phase_recompile(smi, tmp),
                              sum(RECOMPILE_STEPS))),
            ("serve_contract", lambda _: phase_serve_contract(smi)),
        ]),
        # the model frontends (A14 part 1): the flagship imported from an
        # .ffir file, fx, Keras, ONNX, and the CLIs on search's store
        (None, [
            ("frontends", rec("frontends", lambda: phase_frontends(smi), FRONTENDS_STEPS)),
        ]),
        # the Unity-vs-DP A/B harness (A14 part 2): the launches of 2 ranks x
        # the transformer's 2 plans x AB_STEPS steps
        (tempfile.TemporaryDirectory, [
            ("ab", rec("ab", lambda tmp: phase_ab(smi, tmp), 2 * 2 * AB_STEPS)),
        ]),
    ]


def _parse_phases(argv, names) -> set:
    import argparse

    p = argparse.ArgumentParser(description="Drive the port on one card.")
    p.add_argument("--phases", default="",
                   help="comma-separated phases to run (besides device and build), for "
                        f"intermediate runs; all of them by default: {', '.join(names)}")
    args = p.parse_args(argv)
    if not args.phases:
        return set(names)
    picked = {n.strip() for n in args.phases.split(",") if n.strip()}
    unknown = picked - set(names)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}; known: {names}")
    return picked


def main(argv=None) -> None:
    require_card_and_repo()
    import torch

    smi = phase_device()
    ptxas = phase_build()
    kernels, launches, wall = [], {}, {}
    groups = _phases(smi, kernels, launches, ptxas)
    picked = _parse_phases(argv, [name for _, steps in groups for name, _ in steps])
    start = time.perf_counter()
    try:
        for context, steps in groups:
            steps = [(name, fn) for name, fn in steps if name in picked]
            if not steps:
                continue
            with (context() if context is not None else contextlib.nullcontext()) as value:
                for name, fn in steps:
                    t0 = time.perf_counter()
                    fn(value) if context is not None else fn()
                    wall[name] = time.perf_counter() - t0
                    print(f"phase {name}: {wall[name]:.1f} s wall", flush=True)
    finally:
        for d in (SEARCH_RUN.get("store_dir"),):
            if d:
                shutil.rmtree(d, ignore_errors=True)
                shutil.rmtree(d.rstrip("/") + "_foreign", ignore_errors=True)
    emit({"phase_wall_s": wall, "phases_run": len(wall),
          "total_s": time.perf_counter() - start})
    if kernels:
        for entry in kernels:
            by_phase = {p: (n[entry["name"]], steps) for p, (n, steps) in launches.items()
                        if entry["name"] in n}
            entry["launches"] = sum(n for n, _ in by_phase.values())
            entry["launches_per_step"] = {p: n // steps for p, (n, steps) in by_phase.items()}
        emit({"kernels": kernels, "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main(sys.argv[1:])
