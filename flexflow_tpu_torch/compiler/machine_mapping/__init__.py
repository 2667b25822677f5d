"""Machine-mapping DP (reference: lib/compiler/src/compiler/machine_mapping/)."""
