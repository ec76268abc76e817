"""Tensor ops and the hand-written Hopper kernels with their plain versions."""

import importlib

# kernel -> (module, wrapper, the wrapper's count): every wrapper adds one
# to its count where it launches its kernel (a CPU tensor's plain version
# counts nothing); one wrapper launches both instantiations of the decode
# kernel and counts each, and one both int8 products
_COUNTERS = {
    "prefill_attention": ("attention_resident", "resident_attention", "launches"),
    "prefill_attention_bwd": ("attention_resident", "resident_attention_bwd", "launches"),
    "flash_attention": ("flash_attention", "flash_attention_fwd", "launches"),
    "flash_attention_bwd": ("flash_attention", "flash_attention_bwd", "launches"),
    "decode_attention": ("attention_decode", "decode_attention_fused", "launches"),
    "rmsnorm": ("rmsnorm", "rmsnorm", "launches"),
    "rmsnorm_bwd": ("rmsnorm", "rmsnorm_bwd", "launches"),
    "bpe_match": ("bpe_match", "longest_match", "launches"),
    "bpe_chain": ("bpe_match", "greedy_chain", "launches"),
    "decode_attention_int8": ("attention_decode", "decode_attention_fused", "int8_launches"),
    "int8_linear": ("int8_linear", "int8_linear", "launches"),
    "int8_linear_tc": ("int8_linear", "int8_linear", "tc_launches"),
    "kv_quant": ("kv_quant", "append_kv", "launches"),
}


def counted_wrappers():
    """(kernel, its wrapper, the wrapper's count attribute) of each kernel."""
    for name, (module, fn, attr) in _COUNTERS.items():
        yield name, getattr(importlib.import_module(f"{__name__}.{module}"), fn), attr


def launch_counts() -> dict:
    """Each kernel's launches in this process, by kernel name."""
    return {name: getattr(fn, attr) for name, fn, attr in counted_wrappers()}
