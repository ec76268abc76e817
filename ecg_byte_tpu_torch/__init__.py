"""ECG-Byte on PyTorch and CUDA: the serving path of ``ecg_byte_tpu`` ported
to an NVIDIA H100.

Module paths and function names mirror the JAX package, so every function
here has a counterpart of the same name under ``ecg_byte_tpu``.  The JAX
package stays the reference that the tests hold this one against.  This
package imports ``torch`` and never ``jax``; of ``ecg_byte_tpu`` it imports
only the JAX-free modules (``tokenizer``, ``utils.metrics``,
``utils.file_utils``).

The kernels the TPU ran in Pallas are written by hand for Hopper:

- prefill attention, CUDA C++ (``csrc/attention_prefill.cu``,
  ``ops/attention_resident.py``);
- decode attention over a bf16 KV cache, CUDA C++
  (``csrc/attention_decode.cu``, ``ops/attention_decode.py``);
- the RMSNorm forward, Triton (``ops/rmsnorm.py``).

Each keeps a plain PyTorch version beside it.  A wrapper takes the plain
version only for a tensor that lies on the CPU; for a CUDA tensor it
launches its kernel or raises.
"""

__version__ = "0.1.0"
