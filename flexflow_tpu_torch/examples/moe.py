"""Mixture-of-experts training example (port of examples/moe.py; reference
examples/cpp/mixture_of_experts/moe.cc): ff.moe(input, num_exp,
num_select, hidden_size, alpha, lambda) then dense(classes), SGD and
sparse categorical cross-entropy with accuracy; or, with --encoder, the
full MoE encoder (create_moe_encoder: each layer an attention block and an
MoE block, each with a residual and a layer norm). The load-balance loss
joins the training loss.

Run (smoke): python -m flexflow_tpu_torch.examples.moe -b 16 --steps 4 --device cpu
Encoder:     python -m flexflow_tpu_torch.examples.moe --encoder --layers 2 \\
             --hidden 64 --heads 4 --device cpu
"""

from __future__ import annotations

import numpy as np

from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.examples import example_parser


def create_moe_encoder(m: FFModel, x, layers, hidden, heads, num_exp, num_select, alpha, lam):
    """moe.cc create_moe_encoder: ln(add(mha(x), x)) then ln(add(moe(x), x))
    per layer."""
    for _ in range(layers):
        x = m.layer_norm(m.add(m.multihead_attention(x, x, x, hidden, heads), x), axes=[-1])
        x = m.layer_norm(m.add(m.moe(x, num_exp, num_select, hidden, alpha, lam), x), axes=[-1])
    return x


def main(argv=None):
    p = example_parser()
    p.add_argument("--data-dim", type=int, default=64)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--num-exp", type=int, default=8)
    p.add_argument("--num-select", type=int, default=2)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--alpha", type=float, default=2.0,
                   help="expert capacity factor (reference MoeConfig.alpha)")
    p.add_argument("--lambda-bal", type=float, default=0.04,
                   help="load-balance loss weight (reference lambda)")
    p.add_argument("--encoder", action="store_true",
                   help="use the full MoE transformer encoder")
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--seq", type=int, default=16)
    p.add_argument("--steps", type=int, default=8)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)

    m = FFModel(cfg, device=args.device)
    if args.encoder:
        x = m.create_tensor([cfg.batch_size, args.seq, args.data_dim], name="x")
        t = m.dense(x, args.hidden)
        t = create_moe_encoder(m, t, args.layers, args.hidden, args.heads, args.num_exp,
                               args.num_select, args.alpha, args.lambda_bal)
    else:
        x = m.create_tensor([cfg.batch_size, args.data_dim], name="x")
        t = m.moe(x, args.num_exp, args.num_select, args.hidden, args.alpha, args.lambda_bal)
    logits = m.dense(t, args.classes)
    m.compile(SGDOptimizer(lr=cfg.learning_rate), "sparse_categorical_crossentropy",
              metrics=["accuracy"], logit_tensor=logits)

    n = args.steps * cfg.batch_size
    rs = np.random.RandomState(cfg.seed)
    if args.encoder:
        xs = rs.randn(n, args.seq, args.data_dim).astype(np.float32)
        ys = rs.randint(0, args.classes, (n, args.seq))
    else:
        xs = rs.randn(n, args.data_dim).astype(np.float32)
        ys = rs.randint(0, args.classes, n)
    perf = m.fit(x=xs, y=ys, epochs=cfg.epochs)
    print(f"train accuracy = {perf.accuracy:.4f}")


if __name__ == "__main__":
    main()
