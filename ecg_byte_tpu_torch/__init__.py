"""ECG-Byte on PyTorch and CUDA: the serving and LoRA training paths of
``ecg_byte_tpu`` ported to an NVIDIA H100.

Module paths and function names mirror the JAX package, so every function
here has a counterpart of the same name under ``ecg_byte_tpu``.  The JAX
package stays the reference that the tests hold this one against.  This
package imports ``torch`` and nothing of ``jax`` or ``ecg_byte_tpu``: what
it needs of the JAX package's JAX-free modules (the BPE tokenizer and its
C++ core, the metrics, the file utilities, the synthetic-data generator) it
keeps as its own copies.

The kernels the TPU ran in Pallas are written by hand for Hopper:

- prefill and training attention, forward and backward, CUDA C++
  (``csrc/attention_prefill.cu``, ``csrc/attention_prefill_bwd.cu``,
  ``ops/attention_resident.py``);
- decode attention over a bf16 KV cache, CUDA C++
  (``csrc/attention_decode.cu``, ``ops/attention_decode.py``);
- RMSNorm, forward and backward, Triton (``ops/rmsnorm.py``).

Each keeps a plain PyTorch version beside it.  A wrapper takes the plain
version only for a tensor that lies on the CPU; for a CUDA tensor it
launches its kernel or raises.
"""

__version__ = "0.2.0"
