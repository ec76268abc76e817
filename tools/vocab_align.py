"""The train step (B4 x 1024, LoRA, random Llama-3.2-1B) at three vocabulary
sizes, in turns: the preset's 128,256, the 128,915 that ``--hf_weights``
on the size-exact Llama-3.2-1B directory gives with a 400-merge ECG
tokenizer (odd), and 128,960 (128,915 rounded up to a multiple of 64).
Needs the card: ``python3 tools/vocab_align.py`` from the repo root."""
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs
import torch

name, smi = cs.device_phase()
cs.build_phase()
from ecg_byte_tpu_torch.cli.common import build_model
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step

dev = torch.device("cuda")
with tempfile.TemporaryDirectory() as root:
    vocab, merges = cs.make_data(root)
    _, config, tok = build_model(cs.MODEL, vocab, dev)
    batch = cs._training_items(root, vocab, merges, tok, 4)
res = {}
for V in (128256, 128915, 128960, 128960, 128915, 128256):
    c = config.replace(vocab_size=V)
    params = T.init_params(c, torch.Generator(device=dev).manual_seed(0), dev)
    opt = make_optimizer(c.hidden_size, 500)
    state = create_train_state(c, opt, torch.Generator(device=dev).manual_seed(0), peft=True,
                               params=params)
    del params
    state, ms, peak = cs.time_train_step(make_train_step(c, opt, remat="none"), state, batch,
                                         torch.Generator().manual_seed(0), f"vocab {V}")
    res.setdefault(V, []).append(ms)
    del state
    torch.cuda.empty_cache()
print({V: [round(x, 2) for x in v] for V, v in res.items()})
print(smi)
