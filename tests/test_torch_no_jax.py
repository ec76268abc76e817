"""The port stands alone: in a process where importing ``jax``, anything of
``ecg_byte_tpu``, ``safetensors``, ``tokenizers``, ``transformers``,
``regex``, ``ml_dtypes``, ``sklearn``, ``pandas``, ``pywt``, ``wfdb``,
``PIL`` or ``optax`` fails, every module of ``ecg_byte_tpu_torch`` and
``chip_smoke`` imports,
``chip_smoke``'s data helper builds the synthetic dataset and tokenizer on
the CPU, a tiny-llama decodes and takes a LoRA train step, the HF path
runs (the tiny size-exact Llama-3.2-1B directory is written, loaded with
its tokenizer and the ECG tokens registered, and a random BERT written by
``chip_smoke`` scores BERTScore), and the preprocessing runs: raw PTB-XL
records through ``cli.preprocess_ecg`` and the segments through
``cli.sample_ecg``; and the two-stage CLIs: ``cli.pretrain --model
resnet --tiny``, ``cli.finetune`` on its checkpoint and ``--inference``,
and the CLIP and ViT image pipelines; and this PR's modules:
``translate_reports`` with a random Marian directory written by
``chip_smoke``, ``cli.interp_analysis``, ``cli.token_distribution`` and
``cli.track_bpe_encoding``; and the ``--tp`` / ``--fsdp`` grid
(``parallel/mesh.py``, ``parallel/sharding.py``): two gloo ranks, each
blocking the same packages before it imports the port, take LoRA and full
fine-tune steps at T = 2 and at F = 2, save the whole checkpoint and
decode at T = 2; and the norm-folded tree (``fold_norm_scales``) decodes
the same tokens under ``utils/profiling.trace``, which writes its file, and
``log_live_bytes`` counts the CPU's tensors.  No source line imports JAX or the
JAX package, nor scikit-learn, pandas, pywt, wfdb, Pillow or optax."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a rank of the grid check: it blocks the packages before it imports the
# port, takes steps at T = 2 and F = 2, saves and decodes
_RANK = r"""
import sys, tempfile
BLOCKED = BLOCKED_
assert not [m for m in BLOCKED if m in sys.modules]
for mod in BLOCKED:
    sys.modules[mod] = None
import torch
from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models.lora import leaves
from ecg_byte_tpu_torch.parallel import distributed, mesh, sharding
from ecg_byte_tpu_torch.train import checkpoint
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step, shard_train_state
torch.set_num_threads(1)
config = tiny_test_config("llama", vocab_size=301)
opt = make_optimizer(config.hidden_size, 2)
ids = torch.randint(0, 301, (2, 16), generator=torch.Generator().manual_seed(0))
batch = {"input_ids": ids, "attn_mask": torch.ones(2, 16, dtype=torch.int32), "labels": ids}
for tp, fsdp in ((2, 1), (1, 2)):
    mesh.init(tp, fsdp)
    for peft in (True, False):
        state = create_train_state(config, opt, torch.Generator().manual_seed(0), peft=peft)
        state = shard_train_state(state, opt)
        rows = distributed.Rows.stride(2, mesh.data_world(), mesh.data_rank())
        local = {k: v[list(rows.index)] for k, v in batch.items()}
        state, loss = make_train_step(config, opt)(state, local, None, rows, 30)
        assert torch.isfinite(loss)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_checkpoint(d, "best_model", state)
    if tp == 2:
        out = greedy_generate(state.trainable, config, ids, max_new_tokens=3)
        assert out.shape == (2, 3)
    mesh.reset()
assert all(sys.modules[m] is None for m in BLOCKED)
"""

_SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["ecg_byte_tpu"] = None  # and so does any `import ecg_byte_tpu...`
BLOCKED = ("jax", "ecg_byte_tpu", "safetensors", "tokenizers", "transformers", "regex",
           "ml_dtypes", "sklearn", "pandas", "pywt", "wfdb", "PIL", "optax")
for mod in BLOCKED:
    sys.modules[mod] = None
import torch
import ecg_byte_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ecg_byte_tpu_torch.__path__, "ecg_byte_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from ecg_byte_tpu_torch.cli.common import build_model
from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import create_train_state, make_train_step
cpu = torch.device("cpu")
with tempfile.TemporaryDirectory() as root:
    vocab, merges = chip_smoke.make_data(root, n_train=4, n_val=1, n_test=1, seg_len=60,
                                         num_merges=30)
    assert os.path.exists(os.path.join(root, "data", "tokenizer_30.pkl"))
    from ecg_byte_tpu_torch.cli import make_flagship_fixture
    from ecg_byte_tpu_torch.utils import metrics
    fixture = os.path.join(root, "fixture")
    make_flagship_fixture.main(["--out", fixture, "--tiny"])
    params, config, tok = build_model(None, vocab, cpu, hf_weights=fixture)
    assert config.vocab_size == len(tok) == 1280 + len(vocab) + 3
    text = "Could you please help me explain my ECG? Ünïcödé ١٢٣"
    assert tok.decode(tok.encode(text, add_special_tokens=False)) == text
    out = greedy_generate(params, config, torch.tensor([tok.encode("The heart")]),
                          max_new_tokens=3)
    assert out.shape == (1, 3)
    bert = os.path.join(root, "bert")
    chip_smoke.write_random_bert(bert, [text, "The heart rate is slow."], hidden=32, layers=2,
                                 heads=4, intermediate=64)
    os.environ["ECG_BYTE_BERTSCORE_MODEL"] = bert
    scores, mode = metrics.bertscore_with_mode(["The heart rate is slow."],
                                               ["The heart rate is fast."], device=cpu)
    assert mode == "local-bert" and 0.0 < scores["hf-f1"][0] <= 1.0, (mode, scores)
    from ecg_byte_tpu_torch.cli import preprocess_ecg, sample_ecg
    ptb = os.path.join(root, "ptb")
    chip_smoke.write_raw_ptb(ptb, n=10)
    preprocess_ecg.main(["--data", "ptb", "--ptb_folder", ptb, "--data_root", root,
                         "--seg_len", "1250", "--device", "cpu"])
    segments = os.path.join(root, "ptb_1250", "ecg", "train")
    assert len(os.listdir(segments)) == 2 * 5  # folds 1-7: records 0-6, 0 and 5 unlabelled
    listed = sample_ecg.main(["--ecg_dir", segments, "--max_clusters", "3", "--data_root", root,
                              "--device", "cpu"])
    assert open(listed).read().count(".npy") == 10
    from ecg_byte_tpu_torch.cli import finetune, pretrain
    from ecg_byte_tpu_torch.data import two_stage
    import numpy as np
    sig = np.random.default_rng(0).normal(size=(12, 500)).astype(np.float32)
    assert two_stage.clip_process_image(sig).shape == two_stage.vit_process_image(sig).shape
    cwd = os.getcwd()
    os.chdir(root)
    try:
        summary = pretrain.main(["--device", "cpu", "--model", "resnet", "--dataset", "ptb_500",
                                 "--tiny", "--dev", "--epochs", "1", "--batch_size", "4"])
        stage1 = os.path.basename(summary["directory"])
        args = ["--device", "cpu", "--model", "resnet_model", "--dataset", "ptb_500", "--tiny",
                "--dev", "--batch_size", "2", "--pad_to_max", "60", "--first_check", stage1]
        stage2 = os.path.basename(finetune.main(args)["training"]["directory"])
        served = finetune.main(args + ["--inference", "--checkpoint", stage2])
        assert served["records"][0]["tokens"].shape == (1, 128)
    finally:
        os.chdir(cwd)
    from ecg_byte_tpu_torch.cli import interp_analysis, token_distribution, track_bpe_encoding
    from ecg_byte_tpu_torch.data.preprocess import translate_reports
    mdir = os.path.join(root, "marian")
    reports = chip_smoke.german_reports(4)
    chip_smoke.write_random_marian(mdir, reports, dict(
        vocab_size=300, d_model=16, encoder_layers=1, decoder_layers=1, num_heads=2, ffn_dim=32,
        pad_token_id=299, decoder_start_token_id=299))
    out = translate_reports(np.asarray(reports + [""], dtype=object), model_dir=mdir, device="cpu")
    assert out[-1] == "" and all(isinstance(t, str) for t in out)
    os.chdir(root)
    try:
        res = interp_analysis.main(["--device", "cpu", "--model", "tiny-llama",
                                    "--tokenizer_check", "tokenizer_30", "--percentiles",
                                    "data/ptb_500_dataset_stats.npy", "--seg_len", "60",
                                    "--pad_to_max", "300"])
        assert res["summary"]["records"] == 1
        counts, lengths = token_distribution.main([
            "--tokenizer", "data/tokenizer_30.pkl", "--ecg_glob", "data/ptb_500/ecg/train/*.npy",
            "--percentiles", "data/ptb_500_dataset_stats.npy"])
        ids, segmap = track_bpe_encoding.main([
            "--tokenizer", "data/tokenizer_30.pkl", "--ecg_file",
            os.path.join("data/ptb_500/ecg/test", sorted(os.listdir("data/ptb_500/ecg/test"))[0]),
            "--percentiles", "data/ptb_500_dataset_stats.npy", "--leads", "0"])
        assert len(lengths) == 4 and segmap[-1][1] == 12 * 60
    finally:
        os.chdir(cwd)
params, config, tok = build_model("tiny-llama", vocab, cpu)
out = greedy_generate(params, config, torch.tensor([[tok.bos_token_id, 65, 66, 67]]), max_new_tokens=4)
assert out.shape == (1, 4)
opt = make_optimizer(config.hidden_size, 2)
state = create_train_state(config, opt, torch.Generator().manual_seed(0), peft=True, params=params)
ids = torch.randint(0, config.vocab_size, (2, 16))
batch = {"input_ids": ids, "attn_mask": torch.ones(2, 16, dtype=torch.int32), "labels": ids}
state, loss = make_train_step(config, opt)(state, batch, torch.Generator().manual_seed(1))
assert state.step == 1 and torch.isfinite(loss)
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.utils import profiling
fp, fc = T.fold_norm_scales(params, config)
with tempfile.TemporaryDirectory() as d:
    with profiling.trace(d) as path:
        folded = greedy_generate(fp, fc, torch.tensor([[tok.bos_token_id, 65, 66, 67]]),
                                 max_new_tokens=4)
    assert os.path.getsize(path) > 0 and torch.equal(folded, out)
assert profiling.log_live_bytes("the folded tree", cpu) > 0
from ecg_byte_tpu_torch.parallel.spawn import spawn
done = spawn(exec, (RANK_CODE.replace("BLOCKED_", repr(BLOCKED)), {}), world=2, timeout_s=120)
assert done == [None, None]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert loaded == sorted(BLOCKED), loaded
assert all(sys.modules[m] is None for m in BLOCKED)
print("modules", len(names))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.pop("ECG_BYTE_TEXT_TOKENIZER", None)
    script = _SCRIPT.replace("RANK_CODE", repr(_RANK))
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 30


def test_no_jax_import_statements():
    """No source line of the port or chip_smoke imports JAX or the JAX
    package (``ecg_byte_tpu_torch`` itself does not match)."""
    pattern = re.compile(r"^\s*(import jax|from jax|(import|from) ecg_byte_tpu(\.|\s))", re.M)
    assert not pattern.search("import ecg_byte_tpu_torch.ops\nfrom ecg_byte_tpu_torch import x\n")
    assert pattern.search("from ecg_byte_tpu.tokenizer import x\n")
    assert pattern.search("  import ecg_byte_tpu\n")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ecg_byte_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders


def test_no_hf_package_import_statements():
    """No source line of the port or chip_smoke imports ``safetensors``,
    ``tokenizers``, ``regex`` or ``ml_dtypes``; ``transformers`` only in the
    opt-in cross-check of ``data/text_tokenizer.load_text_tokenizer``."""
    pattern = re.compile(
        r"^\s*(import|from) (safetensors|tokenizers|transformers|regex|ml_dtypes)(\.|\s)", re.M)
    assert pattern.search("    from transformers import AutoTokenizer\n")
    assert not pattern.search("from ecg_byte_tpu_torch.tokenizer import x\nimport re\n")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ecg_byte_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    found = {os.path.relpath(f, REPO): pattern.findall(open(f).read()) for f in files}
    found = {f: [m[1] for m in ms] for f, ms in found.items() if ms}
    assert found == {"ecg_byte_tpu_torch/data/text_tokenizer.py": ["transformers"]}


def test_no_sklearn_pandas_pywt_wfdb_import_statements():
    """No source line of the port or chip_smoke imports scikit-learn, pandas,
    pywt, wfdb, Pillow or optax (the card's machine has none of the first
    five; optax is JAX's)."""
    pattern = re.compile(r"^\s*(import|from) (sklearn|pandas|pywt|wfdb|PIL|optax)(\.|\s)", re.M)
    assert pattern.search("    from PIL import Image\n") and pattern.search("import optax\n")
    assert pattern.search("    from sklearn.cluster import KMeans\n")
    assert not pattern.search("from ecg_byte_tpu_torch.data import wfdb_io\nimport pandas_x\n")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "ecg_byte_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert not [f for f in files if pattern.search(open(f).read())]
