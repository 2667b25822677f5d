"""The flagship transformer: a copy of `build_flagship_cg`,
`build_flagship_pcg` and `_model_step_flops` from the repository's bench.py
(12 layers, hidden 1024,
8 heads of 128, seq 512, vocab 32000, batch 64), the same graph as the
torch frontend's IR lines (`build_flagship_ir`), and its other configs,
REF_HEADS16 and LONGCTX.

The attention has no bias (the builder's default is bias=False); the FFN is
bias-free with GELU, and every block ends in a post-LayerNorm.
"""

from __future__ import annotations

from flexflow_tpu_torch.pcg import ComputationGraphBuilder, pcg_from_computation_graph

FLAGSHIP = dict(batch=64, seq=512, embed=1024, heads=8, layers=12, vocab=32000)

# The reference-default config that bench.py:3437-3447 measures beside the
# flagship (ref_heads16_mfu): the same model with the reference
# TransformerConfig's 16 heads of 64. Its attention rides the d=64 kernels
# on the interleaved fused-QKV projection.
REF_HEADS16 = dict(FLAGSHIP, heads=16)

# The seq-2048 flagship that bench.py:3429-3435 measures beside the flagship
# (its longctx subject): the same model and token count per step at
# batch * seq / 2048 = 16 sequences of 2048. On the per-head path its
# attention runs the tiled backward (s > block) of the JAX package.
LONGCTX = dict(FLAGSHIP, batch=16, seq=2048)


def build_flagship_cg(
    batch=64, seq=512, embed=1024, heads=8, layers=12, vocab=32000
):
    b = ComputationGraphBuilder()
    x = b.create_input([batch, seq, embed], name="x")
    h = x
    for i in range(layers):
        attn = b.multihead_attention(h, h, h, embed, heads, name=f"attn{i}")
        h = b.add(h, attn)
        h = b.layer_norm(h, axes=[-1], name=f"ln1_{i}")
        ff = b.dense(h, 4 * embed, use_bias=False, name=f"ff1_{i}")
        ff = b.gelu(ff)
        ff = b.dense(ff, embed, use_bias=False, name=f"ff2_{i}")
        h = b.add(h, ff)
        h = b.layer_norm(h, axes=[-1], name=f"ln2_{i}")
    logits = b.dense(h, vocab, use_bias=False, name="head")
    return b.graph, logits


def build_flagship_ir(
    batch=64, seq=512, embed=1024, heads=8, layers=12, vocab=32000
):
    """The flagship as the torch frontend's IR lines (an .ffir file's, which
    either package reads): one line per op of build_flagship_cg, in its
    order and under its layer names; the residual adds and the GELU, which
    build_flagship_cg leaves unnamed, are add{i}_0, add{i}_1 and gelu{i}.
    `PyTorchModel(ir_lines=...).apply_ir(ffmodel, [x])` builds the same
    graph up to those names. The lines carry no shapes: batch and seq are
    the input tensor's, given at apply time."""
    from flexflow_tpu_torch.frontends.torch_model import IRLine

    ln = {"axes": [-1], "elementwise_affine": True, "eps": 1e-5}
    lines = [IRLine("x", "input", [], {})]
    h = "x"
    for i in range(layers):
        lines += [
            IRLine(f"attn{i}", "multihead_attention", [h, h, h],
                   {"embed_dim": embed, "num_heads": heads}),
            IRLine(f"add{i}_0", "add", [h, f"attn{i}"], {}),
            IRLine(f"ln1_{i}", "layer_norm", [f"add{i}_0"], dict(ln)),
            IRLine(f"ff1_{i}", "linear", [f"ln1_{i}"], {"out_dim": 4 * embed, "use_bias": False}),
            IRLine(f"gelu{i}", "gelu", [f"ff1_{i}"], {}),
            IRLine(f"ff2_{i}", "linear", [f"gelu{i}"], {"out_dim": embed, "use_bias": False}),
            IRLine(f"add{i}_1", "add", [f"ln1_{i}", f"ff2_{i}"], {}),
            IRLine(f"ln2_{i}", "layer_norm", [f"add{i}_1"], dict(ln)),
        ]
        h = f"ln2_{i}"
    lines.append(IRLine("head", "linear", [h], {"out_dim": vocab, "use_bias": False}))
    lines.append(IRLine("output", "output", ["head"], {}))
    return lines


def build_flagship_pcg(
    batch=64, seq=512, embed=1024, heads=8, layers=12, vocab=32000
):
    """The flagship lifted to a trivially parallel PCG: the search's input."""
    graph, _ = build_flagship_cg(batch, seq, embed, heads, layers, vocab)
    return pcg_from_computation_graph(graph)


def model_step_flops(batch, seq, embed, heads, layers, vocab) -> int:
    """Matmul FLOPs of one training step (forward + backward = 3x forward)."""
    d_ff = 4 * embed
    per_layer = (
        2 * batch * seq * embed * embed * 4
        + 2 * batch * heads * seq * seq * (embed // heads) * 2
        + 2 * batch * seq * embed * d_ff * 2
    )
    return 3 * (layers * per_layer + 2 * batch * seq * embed * vocab)
