"""The yardstick's arithmetic for a training cell: the model's FLOPs a
step, and the work of the sparse-expert products K3 and K3w run.

Everything here is counted from the configuration and the traffic, never
from the program: the experts' rows are the real routed rows (tokens x
experts a token), not the row tiles a kernel pads them to, so the same work
is counted whatever kernel or padding runs it.  Imports the standard
library alone.
"""
from __future__ import annotations

#: bytes of an element: the products' bf16 operands, K3w's fp32 result
BF16_BYTES, FP32_BYTES = 2, 4


def active_matmul_params(arch):
    """Weights a token meets in matrix products: each layer's attention
    projections, router and its ``num_experts_per_tok`` experts' three
    products, and the output head (the tied embedding); the embedding's
    lookup is no product."""
    d, dh = arch["hidden_size"], arch["head_dim"]
    hq, hkv = arch["num_attention_heads"], arch["num_key_value_heads"]
    attn = d * hq * dh * 2 + d * hkv * dh * 2
    router = d * arch["num_local_experts"]
    experts = arch["num_experts_per_tok"] * 3 * d * arch["intermediate_size"]
    layer = attn + router + experts
    return arch["num_hidden_layers"] * layer + d * arch["vocab_size"]


def model_flops_per_step(arch, sequences, seq_len):
    """Model FLOPs of one training step (forward and backward, no
    recomputation): 6 x active matrix-product weights x tokens, plus the
    causal attention's score and value products, 2 x 2 x S^2 / 2 x heads x
    head_dim a layer and sequence forward, three times that with the
    backward."""
    tokens = sequences * seq_len
    dense = 6 * active_matmul_params(arch) * tokens
    heads = arch["num_attention_heads"] * arch["head_dim"]
    attention = (3 * 2 * seq_len * seq_len * heads
                 * arch["num_hidden_layers"] * sequences)
    return float(dense + attention)


def expert_shapes(arch):
    """(K, N) of the three expert products of a layer: gate, up, down."""
    d, f = arch["hidden_size"], arch["intermediate_size"]
    return [(d, f), (d, f), (f, d)]


def k3_call(rows, k, n, experts):
    """(effectual FLOPs, bytes) of one K3 call over ``rows`` real rows:
    2 per multiply-add; the rows in, the experts' (K, N) weights and the
    rows out once, in bf16."""
    flops = 2.0 * rows * k * n
    nbytes = BF16_BYTES * (rows * k + experts * k * n + rows * n)
    return flops, float(nbytes)


def k3w_call(rows, k, n, experts):
    """(effectual FLOPs, bytes) of one K3w call: the rows' inputs and
    output gradients in bf16 once, the experts' (K, N) gradient out in
    fp32 once."""
    flops = 2.0 * rows * k * n
    nbytes = BF16_BYTES * (rows * k + rows * n) + FP32_BYTES * experts * k * n
    return flops, float(nbytes)


def moe_calls_per_step(arch, sequences, seq_len, remat=True):
    """Every K3 and K3w call of a training step, as lists of (effectual
    FLOPs, bytes): per layer the forward's three products, again when the
    backward recomputes the layer (``remat``), and the backward's three
    input gradients (K3 on the transposed weights) and three weight
    gradients (K3w)."""
    rows = sequences * seq_len * arch["num_experts_per_tok"]
    e = arch["num_local_experts"]
    passes = 2 if remat else 1
    k3, k3w = [], []
    for _ in range(arch["num_hidden_layers"]):
        for k, n in expert_shapes(arch):
            k3 += [k3_call(rows, k, n, e)] * passes
            k3.append(k3_call(rows, n, k, e))
            k3w.append(k3w_call(rows, k, n, e))
    return k3, k3w


def moe_bound_s_per_step(arch, sequences, seq_len, peaks, remat=True):
    """Least time the chip could take on a step's K3 and K3w calls: each
    call's larger of its FLOPs over the dense bf16 peak and its bytes over
    the HBM peak, summed."""
    k3, k3w = moe_calls_per_step(arch, sequences, seq_len, remat)
    return sum(max(f / peaks["bf16_flop_per_s"],
                   b / peaks["hbm_bytes_per_s"]) for f, b in k3 + k3w)
