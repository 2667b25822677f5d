"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu.

It imports torch, numpy and the standard library, never jax or anything of
flexflow_tpu: where it needs a module of the JAX package that holds no JAX
(graph, op attrs, builder, initializer and optimizer attrs, FFConfig, the serving
memory accounting, the run-event stream, the fault schedule and the
window watchdog) it keeps its own trimmed copy with the same names and
layout. Its kernels are CUDA C++
for Hopper under csrc/, built with nvcc at first use on a machine with a
card.

The port covers the flagship transformer's training step on one device
(models.build_flagship_cg, local_execution.ModelTrainingInstance), data
parallel over a torch.distributed process group
(parallel.DataParallelTrainingInstance), with the flash-attention kernels
of kernels/flash_attention.py, and sequence (and data) parallel training
of the parallel transformer PCG (models.build_parallel_transformer,
parallel.DistributedTrainingInstance) through the ring-flash step kernels
of kernels/ring_flash.py; and single-device serving (serving.ServingProgram,
serving.ServingEngine: a KV cache, prefill, decode windows, continuous
batching under watchdog supervision); and the user API on one device
(core.FFModel: build, compile, fit, eval and the stepped
forward/backward/update, with FFConfig, the optimizers, initializers and
data loaders), with its observability (observability/: the step-health
stream and its policies, spans, cost attribution and the roofline, the
plan audit, the drift monitor), and the Unity search (compiler/,
substitutions/: the machine-mapping DP, the cost estimators and their
persistent cost and movement stores, MCMC, the machine models and the
two-level DP over nodes, the overlap pricing, the parallelization, fusion
and legacy rules, branch stacking). Entry points run on CUDA unless the
caller passes device="cpu".
"""
