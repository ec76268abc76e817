"""The port's two-stage data against Pillow and the JAX package's datasets.

- ``data/image.resize_bicubic`` against ``PIL.Image.resize(BICUBIC)``:
  equal byte for byte on the uint8 image, before any normalisation, at
  the pipelines' real shapes (CLIP's 12 x 500 -> 9,333 x 224 and 12 x 2,500
  -> 46,667 x 224 before the crop, ViT's straight 224 x 224) and at odd
  sizes up and down in each direction; the crop window alone equal to
  the same columns of the whole resize.
- ``ECGCLIPPretrain`` and ``ECGCLIPFinetune`` items against the JAX
  datasets' items on the same files, for every model kind, training and
  inference, with ``np.random`` seeded alike before each item (the ViT
  mask draws from it): every array equal exactly.
"""

import json

import numpy as np
import pytest
from PIL import Image

from ecg_byte_tpu.data import text_tokenizer as jax_text
from ecg_byte_tpu.data import two_stage as JD
from ecg_byte_tpu_torch.data import text_tokenizer, two_stage
from ecg_byte_tpu_torch.data.image import resize_bicubic


def _pil(img, width, height):
    rgb = Image.fromarray(np.stack([img] * 3, axis=-1))
    out = np.asarray(rgb.resize((width, height), Image.BICUBIC))
    assert (out == out[..., :1]).all()  # the three channels stay equal
    return out[..., 0]


@pytest.mark.parametrize("src,dst", [
    ((12, 500), (224, 224)),    # ViT: rows up, columns down
    ((12, 2500), (224, 224)),
    ((12, 500), (224, 9333)),   # CLIP's shortest-edge resize
    ((7, 13), (5, 31)), ((31, 17), (64, 3)), ((224, 224), (100, 224)),
    ((3, 1), (1, 9)), ((50, 50), (50, 50)),
])
def test_resize_equals_pillow(src, dst):
    img = np.random.default_rng(sum(src + dst)).integers(0, 256, src).astype(np.uint8)
    got = resize_bicubic(img, dst[1], dst[0])
    assert got.dtype == np.uint8 and np.array_equal(got, _pil(img, dst[1], dst[0]))


@pytest.mark.parametrize("length", [500, 2500])
def test_clip_crop_window_equals_pillow(length):
    """The CLIP path computes only the crop's columns of the 9,333- or
    46,667-wide resize; they equal Pillow's whole resize, cropped."""
    img = np.random.default_rng(length).integers(0, 256, (12, length)).astype(np.uint8)
    width = int(round(length * 224 / 12))
    left = (width - 224) // 2
    got = resize_bicubic(img, width, 224, out_cols=slice(left, left + 224))
    assert np.array_equal(got, _pil(img, width, 224)[:, left:left + 224])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("two_stage_items")
    rng = np.random.default_rng(0)
    sigs, texts = [], []
    for i, length in enumerate((500, 2500)):
        sig = (np.cumsum(rng.normal(size=(12, length)), -1) * 0.05).astype(np.float32)
        np.save(root / f"ecg_{i}.npy", sig)
        with open(root / f"text_{i}.json", "w") as f:
            json.dump("Normal sinus rhythm.", f)
        sigs.append(str(root / f"ecg_{i}.npy"))
        texts.append(str(root / f"text_{i}.json"))
    return sigs, texts


def _assert_items_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, str):
            assert g == w, k
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


def _tokenizers():
    tok, jtok = text_tokenizer.ByteTextTokenizer(), jax_text.ByteTextTokenizer()
    for t, register in ((tok, text_tokenizer.register_ecg_tokens),
                        (jtok, jax_text.register_ecg_tokens)):
        register(t, {})
        t.add_tokens(["<signal>"], special_tokens=True)
    return tok, jtok


@pytest.mark.parametrize("model", ["clip", "vit", "clip_vit", "resnet"])
def test_pretrain_items_match_jax(files, model):
    tok, jtok = _tokenizers()
    kw = dict(dataset="ptb_500", model=model, num_patches=196, image_size=224)
    ds = two_stage.ECGCLIPPretrain(*files, tokenizer=tok, args=two_stage.TwoStageConfig(**kw))
    jds = JD.ECGCLIPPretrain(*files, tokenizer=jtok, args=JD.TwoStageConfig(**kw))
    for i in range(len(ds)):
        np.random.seed(i)
        got = ds[i]
        np.random.seed(i)
        _assert_items_equal(got, jds[i])


@pytest.mark.parametrize("inference", [False, True], ids=["train", "inference"])
@pytest.mark.parametrize("model", ["clip_model", "vit_model", "clip_vit_model", "resnet_model"])
def test_finetune_items_match_jax(files, model, inference):
    tok, jtok = _tokenizers()
    kw = dict(dataset="ptb_500", model=model, num_patches=196, image_size=224, pad_to_max=60,
              inference=inference)
    ds = two_stage.ECGCLIPFinetune(*files, tokenizer=tok, args=two_stage.TwoStageConfig(**kw))
    jds = JD.ECGCLIPFinetune(*files, tokenizer=jtok, args=JD.TwoStageConfig(**kw))
    for i in range(len(ds)):
        np.random.seed(10 + i)
        got = ds[i]
        np.random.seed(10 + i)
        _assert_items_equal(got, jds[i])


def test_unreadable_record_is_skipped(files, tmp_path):
    (tmp_path / "bad.json").write_text("{not json")
    args = two_stage.TwoStageConfig(model="resnet_model")
    ds = two_stage.ECGCLIPFinetune([files[0][0], str(tmp_path / "missing.npy")],
                                   [str(tmp_path / "bad.json")] * 2,
                                   tokenizer=_tokenizers()[0], args=args)
    assert ds[0] is None and ds[1] is None
