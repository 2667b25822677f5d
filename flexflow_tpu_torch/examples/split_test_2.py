"""split_test_2: a strided conv chain and a search (port of
examples/split_test_2.py; reference examples/cpp/split_test_2/split_test_2.cc):
three 3x3 stride-2 convs to 8 channels over a [B, 4, 32, 32] input, a
flat/relu head, and the graph optimizer at budget 10 before training (here
FFConfig.search_budget, the compile-time Unity path, which a compile over
several ranks runs).

Run: python -m flexflow_tpu_torch.examples.split_test_2 -b 4
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser


def main(argv=None):
    p = example_parser()
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)
    if cfg.search_budget == 0:
        cfg.search_budget = 10  # split_test_2.cc: graph_optimize(10, ...)

    m = FFModel(cfg, device=args.device)
    x = m.create_tensor([cfg.batch_size, 4, 32, 32], name="x")
    t = x
    for i in range(3):  # channels[] = {4, 8, 16}; the reference always convs to 8
        t = m.conv2d(t, 8, 3, 3, 2, 2, 0, 0)
        print(f"Iteration {i}: {t.dims}")
    t = m.flat(t)
    t = m.relu(t)
    logits = t
    m.compile(SGDOptimizer(lr=cfg.learning_rate), "sparse_categorical_crossentropy",
              metrics=["accuracy"], logit_tensor=logits)

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    xs = rs.randn(n, 4, 32, 32).astype(np.float32)
    ys = rs.randint(0, logits.dims[-1], n)
    perf = m.fit(x=xs, y=ys, epochs=cfg.epochs)
    print(f"train accuracy = {perf.accuracy:.4f}")


if __name__ == "__main__":
    main()
