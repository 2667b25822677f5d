"""Transformer training example (port of examples/transformer.py; reference
examples/cpp/Transformer/transformer.cc): a stack of attention encoders,
each MHA then dense(hidden, relu) and dense(hidden), a per-position head,
Adam, seeded synthetic data.

Run: python -m flexflow_tpu_torch.examples.transformer -b 8 --layers 2
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import Activation, AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch.examples import example_parser


def create_attention_encoder(m: FFModel, input, hidden_size: int, num_heads: int, kdim: int,
                             vdim: int):
    """transformer.cc:22-35: MHA then dense(hidden, relu) + dense(hidden)."""
    t = m.multihead_attention(input, input, input, hidden_size, num_heads, kdim, vdim)
    t = m.dense(t, hidden_size, activation=Activation.RELU)
    return m.dense(t, hidden_size)


def main(argv=None):
    p = example_parser()
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--steps", type=int, default=8)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    m = FFModel(cfg, device=args.device)
    x = m.create_tensor([cfg.batch_size, args.seq, args.hidden], name="tokens")
    t = x
    for _ in range(args.layers):
        t = create_attention_encoder(m, t, args.hidden, args.heads, args.hidden // args.heads,
                                     args.hidden // args.heads)
    # per-position classification head; labels are per-position ids
    logits = m.dense(t, args.hidden)
    m.compile(AdamOptimizer(alpha=cfg.learning_rate), "sparse_categorical_crossentropy",
              metrics=["accuracy"], logit_tensor=logits)

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    xs = rs.randn(n, args.seq, args.hidden).astype(np.float32)
    ys = rs.randint(0, args.hidden, (n, args.seq))
    perf = m.fit(x=xs, y=ys, epochs=cfg.epochs)
    print(f"train accuracy = {perf.accuracy:.4f}")


if __name__ == "__main__":
    main()
