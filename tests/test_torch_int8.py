"""int8 serving in the port (``--int8_decode``) against the JAX package, on
the CPU, and serving with LoRA attached (``--no_merge_lora``).

Inputs are made with numpy from a seed and handed to both packages; the
port's wrappers take their plain versions on CPU tensors (the CUDA kernels
run only on the card, where ``chip_smoke.py`` holds them to these plain
versions).  Tolerances, each with its reason:

- the quantizers (weights and KV rows): int8 values and the bits of the
  bf16 scales equal exactly (the same f32 steps, IEEE division and
  round-half-to-even in both);
- int8 decode attention: 2e-5, the tolerance of
  ``tests/test_attention_decode.py`` (f32, sums in another order);
- int8 forward logits: 1e-4 of max|logits| in f32; 2e-2 of max|logits| in
  bf16, where both packages round the same products to bf16 but sum them
  in other orders, so a 1-ulp difference of an activation reaches the
  logits;
- greedy token streams: identical.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.infer import greedy_generate as jax_greedy_generate
from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import lora as jax_lora
from ecg_byte_tpu.models import quantized as jax_quantized
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu.ops import attention as jax_attention
from ecg_byte_tpu.ops import attention_decode as jax_decode
from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import lora_from_jax, params_from_jax
from ecg_byte_tpu_torch.models.quantized import dequantize_weight, quantize_lm_int8
from ecg_byte_tpu_torch.ops import attention_decode, int8_linear, kv_quant

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (arch, config overrides): gpt2 with an untied head, as tests/test_quantized.py:71
ARCHS = {"llama": {}, "gpt2-untied": {"tie_word_embeddings": False}, "gemma": {}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models here gain nothing from intra-op threads, and the
    test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(name, seed=0, **kw):
    """JAX params (perturbed norms and biases, as tests/test_torch_transformer.py)
    and the same weights in the port's layout."""
    arch = name.split("-")[0]
    kw = {**ARCHS[name], **kw}
    jc = jax_config.tiny_test_config(arch, **kw)
    tree = _np_tree(JT.init_params(jc, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if "norm" in key or "bias" in key:
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    pc = tiny_test_config(arch, **kw)
    return jax.tree.map(jnp.asarray, tree), jc, params_from_jax(tree, pc, CPU), pc


def _qmodels(name, seed=0, **kw):
    """The int8 serving copies: JAX's quantize_lm_int8 and the port's tree
    carried across from it."""
    jparams, jc, params, pc = _models(name, seed, **kw)
    jq = jax_quantized.quantize_lm_int8(jparams, jc)
    return jq, jc, params_from_jax(_np_tree(jq), pc, CPU), pc


def _prompt(b=2, s=16, vocab=512, left_pad=3, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :left_pad] = 0
    ids[1, :left_pad] = 0
    return ids, mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_trees_equal(a, b, where="params"):
    """Same names, shapes, dtypes and bits."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (where, sorted(a), sorted(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert torch.equal(_bits(a), _bits(b)), where


# ------------------------------------------------------------ quantizers


@pytest.mark.parametrize("name", list(ARCHS))
def test_quantize_lm_int8_matches_jax(name):
    """bf16 weights: every int8 value and the bits of every bf16 scale equal
    JAX's; the embedding stays as it was, the untied head is gone."""
    jparams, jc, params, pc = _models(name, dtype="bfloat16")
    jq = _np_tree(jax_quantized.quantize_lm_int8(jparams, jc))
    q = quantize_lm_int8(params, pc)
    assert "lm_head" not in q and q["lm_head_q"].shape == (pc.vocab_size, pc.hidden_size)
    assert torch.equal(_bits(q["embed"]), _bits(params["embed"]))
    want_head = np.asarray(jq["lm_head_q"]).T
    np.testing.assert_array_equal(q["lm_head_q"].numpy(), want_head)
    np.testing.assert_array_equal(_bits(q["lm_head_scale"]).numpy(),
                                  np.asarray(jq["lm_head_scale"]).reshape(-1).view(np.int16))
    for i, layer in enumerate(q["layers"]):
        for proj, entry in jq["layers"].items():
            if not isinstance(entry, dict):
                continue
            got = layer[proj]
            assert "weight" not in got
            np.testing.assert_array_equal(got["weight_q"].numpy(),
                                          np.asarray(entry["kernel_q"])[i].T, err_msg=proj)
            np.testing.assert_array_equal(
                _bits(got["weight_scale"]).numpy(),
                np.asarray(entry["kernel_scale"])[i].reshape(-1).view(np.int16), err_msg=proj)
            if "bias" in entry:
                assert torch.equal(_bits(got["bias"]), _bits(params["layers"][i][proj]["bias"]))
    # the dequantized weight is JAX's dequantize_kernel, transposed
    w = dequantize_weight(q["layers"][0]["q_proj"]["weight_q"],
                          q["layers"][0]["q_proj"]["weight_scale"])
    jw = jax_quantized.dequantize_kernel(jnp.asarray(jq["layers"]["q_proj"]["kernel_q"][0]),
                                         jnp.asarray(jq["layers"]["q_proj"]["kernel_scale"][0]))
    np.testing.assert_array_equal(_bits(w).numpy().T, np.asarray(jw).view(np.int16))


@pytest.mark.parametrize("name", list(ARCHS))
def test_params_from_jax_int8_tree_equals_port_quantizer(name):
    """A JAX int8 serving tree carried across equals the port's own
    quantizer applied to the carried bf16 weights, tensor for tensor."""
    jq, _, carried, pc = _qmodels(name, dtype="bfloat16")
    _, _, params, _ = _models(name, dtype="bfloat16")
    _assert_trees_equal(carried, quantize_lm_int8(params, pc))


def test_quant_kv_rows_matches_jax():
    """bf16 rows, a zero row and rows whose quotients sit on .5 rounding
    ties: int8 rows and bf16 scale bits equal JAX's ``_quant_kv_rows``; the
    plain append writes them at the given slots."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 3, 16)) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0
    # amax 127 gives scale 1: the quotients are the values, .5 ties included
    x[1, 2, 1] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 0, 4.5, -4.5, 5.5, 6.5, -6.5, 7.5, 1]
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    jq, js = JT._quant_kv_rows(jnp.asarray(xb))
    tb = _t(xb.astype(np.float32)).to(torch.bfloat16)
    q, s = kv_quant.quant_kv_rows(tb)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s).numpy(), np.asarray(js).view(np.int16))
    assert q[1, 2, 1, :4].tolist() == [127, 0, 2, 2] and (q[0, 0, 0] == 0).all()
    assert s[0, 0, 0].item() == 1.0

    cache = torch.zeros(2, 9, 3, 16, dtype=torch.int8)
    scales = torch.ones(2, 9, 3, dtype=torch.bfloat16)
    vcache, vscales = cache.clone(), scales.clone()
    kv_quant.append_kv(tb, tb.flip(1), cache, vcache, scales, vscales, 3)
    assert torch.equal(cache[:, 3:8], q) and torch.equal(scales[:, 3:8], s)
    assert (cache[:, :3] == 0).all() and (cache[:, 8:] == 0).all() and (scales[:, 8] == 1).all()
    assert torch.equal(vcache[:, 3:8], kv_quant.quant_kv_rows(tb.flip(1))[0])
    assert kv_quant.append_kv.launches == 0


# -------------------------------------------------------- decode attention


def _int8_case(b=2, s=256, h=8, kh=2, d=64, seed=0):
    """The int8 cases of tests/test_attention_decode.py (scales made
    bf16-exact, as the cache stores them)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.integers(-127, 128, (b, s, kh, d)).astype(np.int8)
    v = rng.integers(-127, 128, (b, s, kh, d)).astype(np.int8)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    ks = bf(rng.uniform(0.01, 0.05, (b, s, kh)))
    vs = bf(rng.uniform(0.01, 0.05, (b, s, kh)))
    mask = np.ones((b, s), np.int32)
    mask[:, -s // 4:] = 0  # unfilled tail
    mask[0, :3] = 0  # left padding
    return q, k, v, mask, ks, vs


@pytest.mark.parametrize("case", [dict(), dict(h=5, kh=5, seed=7)], ids=["gqa", "mha-odd-heads"])
def test_int8_decode_attention_plain_matches_jax(case):
    """f32 queries: within 2e-5 of JAX ``decode_attention(k_scale, v_scale)``
    and of the Pallas kernel in interpret mode; bf16 scales give the same
    result as their f32 values."""
    q, k, v, mask, ks, vs = _int8_case(**case)
    jargs = [jnp.asarray(a) for a in (q, k, v, mask, ks, vs)]
    xla = np.asarray(jax_attention.decode_attention(*jargs[:4], k_scale=jargs[4],
                                                    v_scale=jargs[5]))
    fused = np.asarray(jax_decode.decode_attention_fused(*jargs, interpret=True))
    targs = [_t(a) for a in (q, k, v, mask, ks, vs)]
    got = attention_decode.decode_attention_fused(*targs).numpy()
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, fused, atol=2e-5, rtol=2e-5)
    bf = attention_decode.decode_attention_fused(
        *targs[:4], targs[4].to(torch.bfloat16), targs[5].to(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(bf, got)
    assert attention_decode.decode_attention_fused.int8_launches == 0


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("name", list(ARCHS))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_int8_forward_matches_jax(name, dtype, tol):
    """The int8 serving tree's logits within ``tol`` of max|logits| of JAX
    ``T.forward(quantize_lm_int8(params))`` (tolerances in the module
    docstring)."""
    jq, jc, q, pc = _qmodels(name, seed=4, dtype=dtype)
    ids, mask = _prompt(seed=5)
    want = np.asarray(JT.forward(jq, jc, jnp.asarray(ids), jnp.asarray(mask)), np.float32)
    got = T.forward(q, pc, _t(ids).long(), _t(mask)).numpy()
    assert got.dtype == np.float32
    valid = mask.astype(bool)
    scale = np.abs(want[valid]).max()
    np.testing.assert_allclose(got[valid] / scale, want[valid] / scale, atol=tol, rtol=0)
    assert int8_linear.int8_linear.launches == 0


def test_int8_cache_prefill_logits_equal_bf16_cache():
    """Prefill attends the fresh K/V, so its logits are the same with the
    int8 cache as with the model-dtype cache (tests/test_transformer.py:381),
    and the int8 cache holds the quantized rows of the other."""
    _, _, q, pc = _qmodels("llama", seed=6)
    ids, mask = _prompt(seed=7)
    b, s = ids.shape
    full = T.init_kv_cache(pc, b, s + 4, CPU)
    small = T.init_kv_cache(pc, b, s + 4, CPU, dtype=torch.int8)
    assert small["k"].dtype == torch.int8 and small["k_scale"].shape == small["k"].shape[:-1]
    assert (small["k_scale"] == 1).all() and small["k_scale"].dtype == torch.bfloat16
    want, full, _ = T.prefill(q, pc, _t(ids).long(), _t(mask), full)
    got, small, _ = T.prefill(q, pc, _t(ids).long(), _t(mask), small)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    for name in ("k", "v"):
        rows, sc = kv_quant.quant_kv_rows(full[name][:, :, :s])
        assert torch.equal(small[name][:, :, :s], rows)
        assert torch.equal(small[f"{name}_scale"][:, :, :s], sc)
        assert (small[f"{name}_scale"][:, :, s:] == 1).all()


@pytest.mark.parametrize("name", list(ARCHS))
def test_greedy_generate_int8_kv_streams_identical(name):
    """Quantized tiny models with the int8 KV cache: the token streams of
    JAX ``greedy_generate(int8_kv=True)``, eos and pad rules included."""
    jq, jc, q, pc = _qmodels(name, seed=8)
    ids, mask = _prompt(seed=9, left_pad=5)
    pad_id, n_new = 7, 12
    kw = dict(max_new_tokens=n_new, pad_token_id=pad_id, int8_kv=True)
    free = np.asarray(jax_greedy_generate(jq, jc, jnp.asarray(ids), jnp.asarray(mask),
                                          eos_token_id=-1, **kw))
    eos_id = int(free[0, 4])  # row 0 emits it mid-stream
    want = np.asarray(jax_greedy_generate(jq, jc, jnp.asarray(ids), jnp.asarray(mask),
                                          eos_token_id=eos_id, **kw))
    got = greedy_generate(q, pc, _t(ids).long(), _t(mask), eos_token_id=eos_id, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_generate_lora_attached_streams_identical():
    """Serving with the adapters attached (``--no_merge_lora``): the token
    streams of JAX ``greedy_generate(lora=...)`` on tiny llama, B != 0."""
    jparams, jc, params, pc = _models("llama", seed=10, lora_dropout=0.0)
    jl = _np_tree(jax_lora.init_lora(jc, jax.random.PRNGKey(11)))
    rng = np.random.default_rng(12)
    for ab in jl["layers"].values():
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    lora = lora_from_jax(jl, pc, CPU)
    ids, mask = _prompt(seed=13)
    kw = dict(max_new_tokens=12, eos_token_id=-1, pad_token_id=0)
    want = np.asarray(jax_greedy_generate(jparams, jc, jnp.asarray(ids), jnp.asarray(mask),
                                          lora=jax.tree.map(jnp.asarray, jl), **kw))
    got = greedy_generate(params, pc, _t(ids).long(), _t(mask), lora=lora, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    base = greedy_generate(params, pc, _t(ids).long(), _t(mask), **kw).numpy()
    assert not np.array_equal(got, base), "the adapters changed no token"


def test_int8_wrappers_reject_other_devices():
    """Only a CPU tensor takes a plain version; a tensor elsewhere reaches
    the kernel's checks, which raise before any launch."""
    meta = dict(device="meta")
    x = torch.empty(1, 64, dtype=torch.bfloat16, **meta)
    qw = torch.empty(32, 64, dtype=torch.int8, **meta)
    sc = torch.empty(32, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        int8_linear.int8_linear(x, qw, sc)
    kv = torch.empty(1, 1, 2, 64, dtype=torch.bfloat16, **meta)
    cache = torch.empty(1, 8, 2, 64, dtype=torch.int8, **meta)
    scales = torch.empty(1, 8, 2, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        kv_quant.append_kv(kv, kv, cache, cache, scales, scales, 0)
    q = torch.empty(1, 1, 8, 64, dtype=torch.bfloat16, **meta)
    mask = torch.ones(1, 8, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        attention_decode.decode_attention_fused(q, cache, cache, mask, scales, scales)
    with pytest.raises(ValueError, match="needs k_scale"):
        attention_decode.decode_attention_fused(q, cache, cache, mask)
    assert int8_linear.int8_linear.launches == kv_quant.append_kv.launches == 0


# ------------------------------------------------------------ the CLI


def _run(args, cwd, module="ecg_byte_tpu_torch.cli.main"):
    # one thread: the tiny models gain nothing from more, and the test
    # workers already share the cores
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def lora_workdir(tmp_path_factory):
    """A tiny synthetic dataset, its 60-merge tokenizer and a LoRA
    checkpoint (random B) of tiny-llama under runs/0/lora."""
    from ecg_byte_tpu_torch.cli.common import build_model
    from ecg_byte_tpu_torch.ops.quantize import normalize_quantize, quantized_to_string
    from ecg_byte_tpu_torch.tokenizer import BpeTokenizer
    from ecg_byte_tpu_torch.train.checkpoint import save_checkpoint
    from ecg_byte_tpu_torch.train.scheduler import make_optimizer
    from ecg_byte_tpu_torch.train.step import create_train_state

    root = tmp_path_factory.mktemp("torch_int8_cli")
    r = _run(["--n_train", "4", "--n_val", "1", "--n_test", "2", "--seg_len", "60"], root,
             module="ecg_byte_tpu_torch.cli.make_synthetic")
    assert r.returncode == 0, r.stderr
    stats = np.load(root / "data/ptb_500_dataset_stats.npy", allow_pickle=True).item()
    with open(root / "data/sampled_ecg_files_4.txt") as f:
        sigs = np.stack([np.load(root / p) for p in f.read().split()])
    _, qs = normalize_quantize(torch.from_numpy(sigs), stats["percentile_1"],
                               stats["percentile_99"])
    bpe = BpeTokenizer.train(quantized_to_string(qs), 60)
    bpe.save(str(root / "data/tokenizer_60.pkl"))
    params, config, _ = build_model("tiny-llama", bpe.vocab, CPU)
    state = create_train_state(config, make_optimizer(config.hidden_size, 500),
                               torch.Generator().manual_seed(0), peft=True, params=params)
    gen = torch.Generator().manual_seed(1)
    for t in lora_lib.leaves(state.trainable):
        t.data = 0.05 * torch.randn(t.shape, generator=gen)
    save_checkpoint(str(root / "runs/0/lora"), "best_model", state)
    return root


CLI_ARGS = ["--inference", "--dev", "--peft", "--device", "cpu", "--model", "tiny-llama",
            "--dataset", "ptb_500", "--tokenizer_check", "tokenizer_60", "--num_merges", "60",
            "--percentiles", "data/ptb_500_dataset_stats.npy", "--checkpoint", "lora"]


@pytest.mark.parametrize("flag", ["--int8_decode", "--no_merge_lora"])
def test_cli_serves_on_cpu(lora_workdir, flag):
    """``cli.main --inference --peft`` with ``--int8_decode`` (LoRA merged,
    then quantized) or ``--no_merge_lora`` (adapters attached) serves the
    test split end to end: 5 seeds of 2 records, 128 new tokens each."""
    r = _run(CLI_ARGS + [flag], lora_workdir)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "Inference Complete" in r.stdout
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("Serving on cpu")][-1]
    summary = json.loads(line.split(": ", 1)[1])
    assert summary["records"] == 10 and summary["prompt_lens"][0] % 128 == 0
    res = json.load(open(lora_workdir / "runs/0/lora/seed_0_results_ptb_500.json"))
    assert len(res["qa_results"]["gen_answers"]) == 2
