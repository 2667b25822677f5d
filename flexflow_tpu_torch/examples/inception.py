"""Inception-V3 training example over the model zoo (port of
examples/inception.py; reference examples/cpp/InceptionV3): the network of
models.inception_v3 without its auxiliary head, on seeded 299x299 images.

Run: python -m flexflow_tpu_torch.examples.inception -b 1 --steps 1 --classes 4
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser
from flexflow_tpu_torch.models.inception_v3 import InceptionV3Config, build_inception_v3


def main(argv=None):
    p = example_parser()
    p.add_argument("--classes", type=int, default=1000)
    p.add_argument("--steps", type=int, default=1)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    icfg = InceptionV3Config(num_classes=args.classes, batch_size=cfg.batch_size,
                             aux_logits=False)
    graph, logits, _aux = build_inception_v3(icfg)
    # the logits are the adopted graph's last output, which compile takes
    m = FFModel.from_computation_graph(graph, logits, cfg, device=args.device)
    m.compile(SGDOptimizer(lr=cfg.learning_rate), "sparse_categorical_crossentropy",
              metrics=["accuracy"])

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    xs = rs.randn(n, 3, 299, 299).astype(np.float32)
    ys = rs.randint(0, args.classes, n)
    perf = m.fit(x=xs, y=ys, epochs=cfg.epochs)
    print(f"train accuracy = {perf.accuracy:.4f}")


if __name__ == "__main__":
    main()
