"""ECG-Byte on PyTorch and CUDA: the serving and LoRA training paths of
``ecg_byte_tpu``, with the device BPE encoder of the training token cache,
the tokenizer CLI and the preprocessing from raw WFDB records (the DSP
chain and the morphology clustering on the device), ported to an NVIDIA
H100.

Module paths and function names mirror the JAX package, so every function
here has a counterpart of the same name under ``ecg_byte_tpu``.  The JAX
package stays the reference that the tests hold this one against.  This
package imports ``torch`` and nothing of ``jax`` or ``ecg_byte_tpu``: what
it needs of the JAX package's JAX-free modules (the BPE tokenizer and its
C++ core, the metrics, the file utilities, the synthetic-data generator,
the WFDB reader) it keeps as its own copies, and it needs no scikit-learn,
pandas, pywt or wfdb (``utils/sk.py``).

The kernels the TPU ran in Pallas are written by hand for Hopper:

- prefill and training attention, forward and backward, CUDA C++
  (``csrc/attention_prefill.cu``, ``csrc/attention_prefill_bwd.cu``,
  ``ops/attention_resident.py``);
- decode attention over a bf16 or int8 KV cache, which also writes this
  token's K/V row into the cache, CUDA C++ (``csrc/attention_decode.cu``,
  ``ops/attention_decode.py``);
- RMSNorm, forward and backward, CUDA C++ (``csrc/rmsnorm.cu``,
  ``ops/rmsnorm.py``);
- the BPE encoder's longest match and greedy chain, CUDA C++
  (``csrc/bpe_match.cu``, ``csrc/bpe_chain.cu``, ``ops/bpe_match.py``).

Each keeps a plain PyTorch version beside it.  A wrapper takes the plain
version only for a tensor that lies on the CPU; for a CUDA tensor it
launches its kernel or raises.
"""

__version__ = "0.3.0"
