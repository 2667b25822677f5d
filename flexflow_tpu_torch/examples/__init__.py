"""The example zoo on the port: copies of the repository's examples/ apps
that import flexflow_tpu_torch (mlp, transformer, bert, split_test,
split_test_2, candle_uno, dlrm, xdl, alexnet, resnet, resnext50,
inception, moe), with the
same arguments, defaults, seeded synthetic data and printed lines, plus
`--device` (default cuda; `--device cpu` runs on the host). Each runs as

    python -m flexflow_tpu_torch.examples.<name> [args]

and exposes `main(argv=None)`.
"""

from __future__ import annotations

import argparse

from flexflow_tpu_torch.local_execution.config import FFConfig

# each example's argv at the repository's example smoke-test sizes
# (tests/test_examples.py), where every app runs in seconds
SMOKE_ARGV = (
    ("mlp", ("-b", "8", "--steps", "2")),
    ("split_test", ("-b", "8")),
    ("split_test", ("-b", "8", "--branch-stacking")),
    ("split_test_2", ("-b", "4", "--steps", "1")),
    ("xdl", ("-b", "8", "--steps", "2")),
    ("bert", ("-b", "4", "--seq", "32", "--hidden", "64", "--heads", "2", "--layers", "1",
              "--vocab", "128", "--steps", "1")),
    ("transformer", ("-b", "2", "--layers", "1", "--hidden", "64", "--heads", "2", "--seq", "32",
                     "--steps", "1")),
    ("candle_uno", ("-b", "4", "--steps", "1", "--dense-size", "32")),
    ("dlrm", ("-b", "8", "--steps", "1", "--num-sparse", "2", "--embedding-entries", "64",
              "--embedding-dim", "8", "--dense-dim", "4", "--bottom-mlp", "16-8",
              "--top-mlp", "24-8-1")),
    ("alexnet", ("-b", "2", "--image-size", "96", "--steps", "1", "--classes", "4")),
    ("resnet", ("-b", "2", "--image-size", "64", "--steps", "1", "--classes", "4")),
    ("resnext50", ("-b", "2", "--image-size", "64", "--groups", "8", "--classes", "8",
                   "--steps", "1")),
    ("inception", ("-b", "1", "--steps", "1", "--classes", "4")),
    ("moe", ("-b", "8", "--steps", "2")),
)


def example_parser() -> argparse.ArgumentParser:
    """FFConfig's flags plus --device, which every example takes."""
    p = argparse.ArgumentParser()
    FFConfig.add_args(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model runs: cuda (the default) or cpu")
    return p
