"""AlexNet training example (port of examples/alexnet.py; reference
examples/cpp/AlexNet/alexnet.cc:94-116): 5 conv, 3 max pools, 3 dense,
softmax; SGD with momentum on seeded synthetic images.

Run: python -m flexflow_tpu_torch.examples.alexnet -b 64 --steps 16
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser


def build_alexnet(m: FFModel, batch: int, image_size: int, classes: int):
    """alexnet.cc:94-116: 5 conv + 3 pool + 3 dense."""
    x = m.create_tensor([batch, 3, image_size, image_size], name="image")
    t = m.conv2d(x, 64, 11, 11, 4, 4, 2, 2, activation=Activation.RELU)
    t = m.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = m.conv2d(t, 192, 5, 5, 1, 1, 2, 2, activation=Activation.RELU)
    t = m.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = m.conv2d(t, 384, 3, 3, 1, 1, 1, 1, activation=Activation.RELU)
    t = m.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=Activation.RELU)
    t = m.conv2d(t, 256, 3, 3, 1, 1, 1, 1, activation=Activation.RELU)
    t = m.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = m.flat(t)
    t = m.dense(t, 4096, activation=Activation.RELU)
    t = m.dense(t, 4096, activation=Activation.RELU)
    t = m.dense(t, classes)
    return x, m.softmax(t)


def main(argv=None):
    p = example_parser()
    p.add_argument("--steps", type=int, default=16, help="batches per epoch")
    p.add_argument("--image-size", type=int, default=229)
    p.add_argument("--classes", type=int, default=10)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    m = FFModel(cfg, device=args.device)
    x, logits = build_alexnet(m, cfg.batch_size, args.image_size, args.classes)
    m.compile(SGDOptimizer(lr=cfg.learning_rate, momentum=0.9),
              "sparse_categorical_crossentropy", metrics=["accuracy"], logit_tensor=logits)

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    images = rs.randn(n, 3, args.image_size, args.image_size).astype(np.float32)
    labels = rs.randint(0, args.classes, n)
    perf = m.fit(x=images, y=labels, epochs=cfg.epochs)
    print(f"train accuracy = {perf.accuracy:.4f}")


if __name__ == "__main__":
    main()
