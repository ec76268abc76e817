"""Operations and bytes of the work, counted from shapes at the program's
entry points, whatever kernel does the work; and the published peaks they
are divided by.

Peaks: one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense
bf16 without sparsity), as ``chip_smoke.py`` holds them.  The run prints
the card's power limit beside every share.

Matrix products: ``2 * N_mm`` operations a position forward, where
``N_mm`` counts the weights of every product a position goes through (the
projections, the adapters and the output head).  A LoRA training step is
``4 * N_base + 6 * N_lora`` a position: the forward and the input
gradient of every product, and the weight gradient of the adapters only,
as the base is frozen (no recomputation counted).  Attention is counted
over the valid causal (query, key) pairs: ``4 * D`` operations a pair,
head and layer forward (Q.K and P.V), ``8 * D`` backward (dV, dP, dQ,
dK), and its bytes are each input read once and each output written once.
"""

from __future__ import annotations

from bench_port.spec import Spec

PEAK_FLOPS = 989e12  # dense bf16, H100 SXM at 700 W
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
BF16 = 2


def base_matmul_params(s: Spec, head: bool = True) -> int:
    """Weights of the base products a position goes through."""
    n = s.layers * sum(d_in * d_out for d_in, d_out in s.proj_dims().values())
    return n + (s.vocab * s.hidden if head else 0)


def lora_params(s: Spec) -> int:
    dims = s.proj_dims()
    return s.layers * sum(s.lora_rank * (dims[n][0] + dims[n][1]) for n in s.targets())


def train_step_flops(s: Spec, positions: int, pairs: int) -> float:
    """A LoRA train step over ``positions`` fed positions with ``pairs``
    valid causal pairs per head and layer (summed over the batch), in every
    layer."""
    linear = (4 * base_matmul_params(s) + 6 * lora_params(s)) * positions
    attention = attention_flops(s, pairs) + attention_bwd_flops(s, pairs)
    return float(linear + s.layers * attention)


def attention_flops(s: Spec, pairs: int) -> float:
    """Forward: Q.K and P.V, ``4 * D`` a pair and head."""
    return float(4 * s.head_dim * s.heads * pairs)


def attention_bwd_flops(s: Spec, pairs: int) -> float:
    """Backward: dV, dP, dQ and dK, ``8 * D`` a pair and head."""
    return 2 * attention_flops(s, pairs)


def attention_bytes(s: Spec, batch: int, seq: int) -> float:
    """Forward: q, k, v and the int32 mask read, out written."""
    q = batch * seq * s.heads * s.head_dim * BF16
    kv = batch * seq * s.kv_heads * s.head_dim * BF16
    return float(2 * q + 2 * kv + batch * seq * 4)


def attention_bwd_bytes(s: Spec, batch: int, seq: int) -> float:
    """Backward: q, k, v, out, dout and the mask read, dq, dk, dv written."""
    q = batch * seq * s.heads * s.head_dim * BF16
    kv = batch * seq * s.kv_heads * s.head_dim * BF16
    return float(4 * q + 4 * kv + batch * seq * 4)


def prefill_flops(s: Spec, positions: int, rows: int, pairs: int) -> float:
    """A prefill over ``positions`` fed positions with ``pairs`` valid
    causal pairs per head and layer, in every layer; the head runs on each
    row's last position only."""
    return float(2 * base_matmul_params(s, head=False) * positions
                 + 2 * s.vocab * s.hidden * rows + s.layers * attention_flops(s, pairs))


def decode_step_flops(s: Spec, rows: int, keys: int) -> float:
    """One decode step of ``rows`` rows attending ``keys`` valid cache
    slots in all (summed over the rows, this token's own included), in
    every layer."""
    return float(2 * base_matmul_params(s) * rows + 4 * s.head_dim * s.heads * keys * s.layers)


def decode_attention_bytes(s: Spec, rows: int, keys: int) -> float:
    """Every valid K and V row read once (the fresh row included), q read,
    out written, the fresh K and V rows written into the cache."""
    row = s.kv_heads * s.head_dim * BF16
    q = rows * s.heads * s.head_dim * BF16
    return float(2 * keys * row + 2 * q + 2 * rows * row)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the peak bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
