"""Dataset ingestion: MIMIC / ECG-QA / PTB-XL preprocessing, batched on a
device (``ecg_byte_tpu/data/preprocess.py``).

Records are read by the port's WFDB reader, stacked, and pushed through
one batched program on the device (``ops/dsp.preprocess_records``: filter
chain -> wavelet denoise -> cubic resample as two products), so
throughput scales with the batch and not with host cores.

The artifact layout, split naming, stats keys, skip semantics and the
PTB-XL label aggregation and selection rules are the JAX package's, so the
datasets and the tokenizer corpus see the same trees.  The CSV files are
read with the stdlib ``csv`` module (no pandas), the labels binarized by
``utils/sk.MultiLabelBinarizer`` (no scikit-learn).
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import json
import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ecg_byte_tpu_torch.data import wfdb_io
from ecg_byte_tpu_torch.device import resolve_device

_MIMIC_LIKE = ("mimic", "ecg_qa_mimic")  # need lead reorder (preprocess_utils.py:140-142)


@dataclasses.dataclass
class PreprocessArgs:
    """Knobs of the reference preprocess argparse namespace, and the
    device (default the CUDA card; the CPU only when named)."""

    data: str = "mimic"
    seg_len: int = 2500
    data_root: str = "./data"
    batch_size: int = 64
    device: Optional[str] = None


# ---------------------------------------------------------------------------
# Record loading


def _record_path(instance: Dict, args: PreprocessArgs) -> str:
    """Resolve the WFDB record path (preprocess_utils.py:115-124),
    anchored at ``args.data_root`` instead of a hard-coded ``./data``."""
    if args.data == "mimic":
        return os.path.join(args.data_root, "mimic", instance["ecg"])
    if args.data == "ecg_qa_ptb":
        rel = instance["ecg_path"][0].lstrip("./").lstrip("../")
        return os.path.join(args.data_root, rel)
    if args.data == "ecg_qa_mimic":
        p = instance["ecg_path"][0]
        rel = p[p.find("/data") + len("/data"):].lstrip("/")
        return os.path.join(args.data_root, rel)
    raise ValueError(f"unknown data kind {args.data!r}")


def _conversation(instance: Dict, args: PreprocessArgs):
    if args.data == "mimic":
        return instance["conversations"]
    return [instance["question_type"], instance["question"], instance["answer"]]


def load_instance_signal(instance: Dict, args: PreprocessArgs):
    """Read and validate one record -> ((5000, 12) float array,
    conversation), or (None, None) on any failure, as ``process_instance``
    skips (preprocess_utils.py:125-165): fs must be 500, 12 leads, 5000
    samples, no NaN/inf."""
    try:
        path = _record_path(instance, args)
        signals, fields = wfdb_io.rdsamp(path)
        assert fields["fs"] == 500
        assert signals.shape[1] == 12
        assert signals.shape[0] == 5000
        if np.any(np.isnan(signals)) or np.any(np.isinf(signals)):
            print(f"Warning: NaN values detected in {path}. Skipping this instance.")
            return None, None
        return signals, _conversation(instance, args)
    except Exception as e:  # the reference skips a record on any failure
        print(f"Error processing instance: {e}. Skipping this instance.")
        return None, None


# ---------------------------------------------------------------------------
# Device-batched pipeline


def preprocess_signal_batch(signals: np.ndarray, args: PreprocessArgs,
                            fs: float = 500.0) -> np.ndarray:
    """(B, time, 12) raw -> (B, n_seg, 12, seg_len) preprocessed segments,
    computed on ``args.device``: reorder (MIMIC family) -> notch + band +
    baseline filtfilt -> wavelet denoise -> cubic resample to 250 Hz ->
    fixed windows (ops/dsp.py)."""
    from ecg_byte_tpu_torch.ops import dsp

    device = resolve_device(args.device)
    x = torch.from_numpy(np.asarray(signals, np.float32)).to(device).transpose(1, 2)
    y = dsp.preprocess_records(x, fs=fs, target_fs=250.0, do_reorder=args.data in _MIMIC_LIKE)
    return dsp.segment_ecg(y, args.seg_len).cpu().numpy()


def iter_preprocessed(instances: Sequence[Dict], args: PreprocessArgs,
                      stats: Optional[Dict[str, int]] = None
                      ) -> Iterator[Tuple[int, np.ndarray, object]]:
    """Yield (original_index, (n_seg, 12, seg_len) segments, conversation)
    per valid instance.  A mutable ``stats`` dict observes the skip count:
    ``stats["skipped"]`` is updated as the iteration goes."""
    batch_idx: List[int] = []
    batch_sig: List[np.ndarray] = []
    batch_conv: List[object] = []
    if stats is None:
        stats = {}
    stats["skipped"] = 0

    def flush():
        if not batch_idx:
            return
        segs = preprocess_signal_batch(np.stack(batch_sig), args)
        for i, conv, seg in zip(batch_idx, batch_conv, segs):
            if np.any(np.isnan(seg)) or np.any(np.isinf(seg)):
                seg = np.nan_to_num(seg, nan=0.0, posinf=0.0, neginf=0.0)
            yield i, seg, conv
        batch_idx.clear()
        batch_sig.clear()
        batch_conv.clear()

    for i, instance in enumerate(instances):
        sig, conv = load_instance_signal(instance, args)
        if sig is None:
            stats["skipped"] += 1
            continue
        batch_idx.append(i)
        batch_sig.append(sig)
        batch_conv.append(conv)
        if len(batch_idx) >= args.batch_size:
            yield from flush()
    yield from flush()


def compute_global_stats(instances: Sequence[Dict], args: PreprocessArgs,
                         sample_size: int = 100000) -> Dict[str, float]:
    """Global min/max and sampled 1st/99th percentiles over the
    preprocessed segments (preprocess_utils.py:168-213)."""
    global_min, global_max = np.inf, -np.inf
    samples: List[np.ndarray] = []
    collected = 0
    n_valid = 0
    rng = np.random.default_rng(0)

    skip_stats: Dict[str, int] = {}
    for _idx, segs, _conv in iter_preprocessed(instances, args, stats=skip_stats):
        n_valid += 1
        for seg in segs:
            global_min = min(global_min, float(np.min(seg)))
            global_max = max(global_max, float(np.max(seg)))
            if collected < sample_size:
                take = min(sample_size - collected, seg.size)
                pick = rng.choice(seg.size, take, replace=False)
                samples.append(np.asarray(seg).reshape(-1)[pick])
                collected += take
    skipped = skip_stats.get("skipped", 0)
    flat = np.concatenate(samples) if samples else np.zeros(1)
    stats = {
        "global_min": float(global_min) if n_valid else 0.0,
        "global_max": float(global_max) if n_valid else 0.0,
        "percentile_1": float(np.percentile(flat, 1)),
        "percentile_99": float(np.percentile(flat, 99)),
        "skipped_instances": skipped,
    }
    print(f"Total instances skipped due to NaN values: {skipped}")
    return stats


def _save_segment(root: str, split_name: str, name: str, seg: np.ndarray, text) -> None:
    np.save(os.path.join(root, "ecg", split_name, f"ecg_{name}.npy"), seg)
    with open(os.path.join(root, "text", split_name, f"text_{name}.json"), "w") as f:
        json.dump(text, f)


def process_and_save_split(instances: Sequence[Dict], split_name: str,
                           args: PreprocessArgs) -> None:
    """Write ``ecg_{i}_{j}.npy`` (12, seg_len) and ``text_{i}_{j}.json``
    per segment into the reference tree (preprocess_utils.py:215-253)."""
    root = os.path.join(args.data_root, f"{args.data}_{args.seg_len}")
    os.makedirs(os.path.join(root, "ecg", split_name), exist_ok=True)
    os.makedirs(os.path.join(root, "text", split_name), exist_ok=True)

    skip_stats: Dict[str, int] = {}
    for idx, segs, conv in iter_preprocessed(instances, args, stats=skip_stats):
        for j in range(segs.shape[0]):
            _save_segment(root, split_name, f"{idx}_{j}", segs[j], conv)
    print(f"Total instances skipped in {split_name} split: {skip_stats.get('skipped', 0)}")


# ---------------------------------------------------------------------------
# ECG-QA templates


def setup_ecg_qa(glob_paths: Sequence[str]) -> List[Dict]:
    """Keep single-verify/choose/query items (preprocess_utils.py:796-803)."""
    data: List[Dict] = []
    for fname in sorted(glob_paths):
        with open(fname) as f:
            loaded = json.load(f)
        data.extend(item for item in loaded
                    if item["question_type"] in ("single-verify", "single-choose", "single-query"))
    return data


# ---------------------------------------------------------------------------
# PTB-XL tables and label tasks (preprocess_utils.py:519-662)

_PTB_TASKS = ("all", "diagnostic", "subdiagnostic", "superdiagnostic", "form", "rhythm")

# the strings pandas.read_csv reads as NaN by default (and the empty cell)
_NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_NAN = float("nan")


def _cell(value: str):
    """A CSV cell as pandas reads it: NaN for an NA string, else the text."""
    return _NAN if value in _NA_STRINGS else value


def _is_one(value) -> bool:
    """``value == 1.0`` as pandas compares a numeric column's cell."""
    try:
        return float(value) == 1.0
    except (TypeError, ValueError):
        return False


def read_csv_rows(path: str) -> Tuple[List[str], List[Dict[str, object]]]:
    """A CSV file's header and rows, each row a {column: cell} dict with
    NaN for an empty or NA cell (``pandas.read_csv``'s reading of them)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [{col: _cell(v) for col, v in zip(header, line)} for line in reader]
    return header, rows


class ScpTable:
    """``scp_statements.csv`` indexed by its first column (the SCP code),
    as ``pandas.read_csv(path, index_col=0)`` reads it for the label
    tasks."""

    def __init__(self, rows: Dict[str, Dict[str, object]]):
        self.rows = rows

    @classmethod
    def read(cls, path: str) -> "ScpTable":
        header, rows = read_csv_rows(path)
        return cls({row[header[0]]: row for row in rows})

    def codes_where_one(self, column: str) -> Dict[str, Dict[str, object]]:
        """The rows whose ``column`` equals 1.0, by code."""
        return {code: row for code, row in self.rows.items() if _is_one(row.get(column))}


def compute_label_aggregations(scp_codes, table: ScpTable, task: str) -> List[List[str]]:
    """Aggregate each record's SCP-code dict into task labels.

    ``scp_codes``: a sequence of {code: likelihood} dicts (one per record);
    ``table``: ``scp_statements.csv`` (:class:`ScpTable`).  Returns one
    sorted label list per record.
    """
    if task not in _PTB_TASKS:
        raise ValueError(f"unknown PTB-XL task {task!r}; options: {_PTB_TASKS}")

    if task == "all":
        return [sorted(set(d.keys())) for d in scp_codes]

    if task in ("diagnostic", "subdiagnostic", "superdiagnostic"):
        diag = table.codes_where_one("diagnostic")
        col = {"diagnostic": None, "subdiagnostic": "diagnostic_subclass",
               "superdiagnostic": "diagnostic_class"}[task]

        def agg(d):
            out = set()
            for key in d:
                if key in diag:
                    if col is None:
                        out.add(key)
                    else:
                        c = diag[key].get(col, _NAN)
                        if str(c) != "nan":
                            out.add(c)
            return sorted(out)

        return [agg(d) for d in scp_codes]

    flagged = table.codes_where_one(task)
    return [sorted({key for key in d if key in flagged and str(key) != "nan"})
            for d in scp_codes]


def select_labeled(agg: List[List[str]], task: str, min_samples: int = 0,
                   output_folder: Optional[str] = None):
    """Rare-label filter, row selection and multi-hot binarization
    (preprocess_utils.py:595-662).

    Labels with corpus count <= ``min_samples`` are dropped (every task but
    'diagnostic', which the reference never filters), then rows left with
    no labels are excluded.  Returns ``(keep_mask, kept_label_lists,
    y_multihot, mlb)`` and pickles the fitted
    ``utils.sk.MultiLabelBinarizer`` as ``mlb.pkl`` when ``output_folder``
    is given (:659-660).
    """
    from ecg_byte_tpu_torch.utils.sk import MultiLabelBinarizer

    rows = [list(r) for r in agg]
    if task != "diagnostic":
        counts: Dict[str, int] = {}
        for r in rows:
            for label in r:
                counts[label] = counts.get(label, 0) + 1
        keep_labels = {label for label, c in counts.items() if c > min_samples}
        rows = [sorted(set(r) & keep_labels) for r in rows]

    keep = np.array([len(r) > 0 for r in rows])
    kept = [r for r in rows if r]
    mlb = MultiLabelBinarizer()
    if kept:
        y = mlb.fit_transform(kept)
    else:
        mlb.fit([[]])
        y = np.zeros((0, 0), dtype=np.int64)
    if output_folder is not None:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder, "mlb.pkl"), "wb") as f:
            pickle.dump(mlb, f)
    return keep, kept, y, mlb


TRANSLATION_ENV = "ECG_BYTE_TRANSLATION_MODEL"


def translate_reports(texts, model_dir: Optional[str] = None, device: Optional[str] = None,
                      stats: Optional[dict] = None):
    """German -> English report translation (preprocess_utils.py:664-713).

    With a local opus-mt-de-en checkpoint (``model_dir`` or
    ``$ECG_BYTE_TRANSLATION_MODEL``: ``config.json``, ``*.safetensors``,
    ``source.spm``, ``vocab.json``) the Marian model (``models/marian.py``)
    translates on ``device`` (default the CUDA card; the CPU only when
    named), in batches of 32, greedily up to 128 tokens, each batch's
    source padded to a multiple of 64 positions, as the JAX package does;
    an empty report stays empty.  Without one the reports pass through
    unchanged, with a warning.  ``stats`` (a dict) receives the batches
    and decode steps run.
    """
    texts = np.asarray(texts, dtype=object)
    model_dir = model_dir or os.environ.get(TRANSLATION_ENV)
    if not model_dir or not os.path.isdir(model_dir):
        print("translate_reports: no local opus-mt-de-en checkpoint; "
              f"keeping original report text (set ${TRANSLATION_ENV})")
        return texts
    from ecg_byte_tpu_torch.models.marian import greedy_generate, load_hf_marian
    from ecg_byte_tpu_torch.tokenizer.sp_model import MarianSpTokenizer

    dev = resolve_device(device)
    tokenizer = MarianSpTokenizer(model_dir)
    params, config = load_hf_marian(model_dir, dev)
    valid_mask = np.array([bool(t and str(t).strip()) for t in texts], dtype=bool)
    valid = [str(t) for t in texts[valid_mask]]
    translations: List[str] = []
    steps = batches = 0
    for i in range(0, len(valid), 32):
        enc = tokenizer(valid[i: i + 32], truncation=True, max_length=512)
        ids, mask = enc["input_ids"], enc["attention_mask"]
        # the JAX package buckets the source width to bound its compiles;
        # the same widths here give the same function
        width = max(64, -(-ids.shape[1] // 64) * 64)
        pad = width - ids.shape[1]
        if pad:
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=tokenizer.pad_token_id)
            mask = np.pad(mask, ((0, 0), (0, pad)))
        run = {}
        out = greedy_generate(params, config, torch.from_numpy(ids), torch.from_numpy(mask),
                              max_length=128, stats=run)
        steps += run["steps"]
        batches += 1
        translations.extend(tokenizer.batch_decode(out.cpu().numpy(), skip_special_tokens=True))
    if stats is not None:
        stats.update(batches=batches, decode_steps=steps, sentences=len(valid))
    result = np.empty_like(texts)
    result[valid_mask] = translations
    result[~valid_mask] = ""
    return result


def _read_ptb_database(path: str):
    """``ptbxl_database.csv`` in file order: (scp_codes dicts, hr file
    names, strat folds, reports; an empty report reads as NaN)."""
    _, rows = read_csv_rows(path)
    scp_codes = [ast.literal_eval(r["scp_codes"]) for r in rows]
    folds = np.array([int(float(r["strat_fold"])) for r in rows])
    reports = np.empty(len(rows), dtype=object)
    reports[:] = [r["report"] for r in rows]
    return scp_codes, [r["filename_hr"] for r in rows], folds, reports


def preprocess_ptb(ptb_folder: str, args: PreprocessArgs, task: str = "superdiagnostic",
                   translation_model: Optional[str] = None) -> None:
    """The PTB-XL pipeline (preprocess_utils.py:736-792): 500 Hz records,
    filter/denoise/resample batched on ``args.device``, label aggregation
    and selection, strat_fold 1-7/8/9-10 splits, report translation,
    segmentation, the reference layout (``ecg_{i}_{i}`` naming quirk,
    :776)."""
    from ecg_byte_tpu_torch.ops import dsp

    scp_codes, filenames, strat_folds, all_reports = _read_ptb_database(
        os.path.join(ptb_folder, "ptbxl_database.csv"))
    table = ScpTable.read(os.path.join(ptb_folder, "scp_statements.csv"))

    # the reference caches the filtered records time-major (N, 2500, 12) as
    # raw500.npy (preprocess_utils.py:509-516, a pickle); the same format,
    # so the caches interoperate
    cache = os.path.join(ptb_folder, "raw500.npy")
    if os.path.exists(cache):
        filtered = np.load(cache, allow_pickle=True)
    else:
        raw = np.stack([wfdb_io.rdsamp(os.path.join(ptb_folder, f))[0].astype(np.float32)
                        for f in filenames])  # (N, 5000, 12)
        device = resolve_device(args.device)
        chunks = []
        for start in range(0, len(raw), args.batch_size):
            x = torch.from_numpy(raw[start: start + args.batch_size]).to(device).transpose(1, 2)
            chunks.append(dsp.preprocess_records(x, fs=500.0, target_fs=250.0)
                          .transpose(1, 2).cpu().numpy())
        filtered = np.concatenate(chunks)  # (N, 2500, 12)
        with open(cache, "wb") as f:
            pickle.dump(filtered, f, protocol=4)

    # (N, time, 12) -> (N, n_seg, 12, seg_len)
    data = dsp.segment_ecg(torch.from_numpy(np.ascontiguousarray(filtered)).transpose(1, 2),
                           args.seg_len).numpy()

    agg = compute_label_aggregations(scp_codes, table, task)
    out_root = os.path.join(args.data_root, f"{args.data}_{args.seg_len}")
    keep, _kept, _y, _mlb = select_labeled(agg, task, min_samples=0, output_folder=out_root)
    data = data[keep]
    folds = strat_folds[keep]
    reports = all_reports[keep]

    for split_name, mask in (("train", folds < 8), ("val", folds == 8), ("test", folds > 8)):
        split_reports = translate_reports(reports[mask], translation_model, args.device)
        os.makedirs(os.path.join(out_root, "ecg", split_name), exist_ok=True)
        os.makedirs(os.path.join(out_root, "text", split_name), exist_ok=True)
        count = 0
        for segs, report in zip(data[mask], split_reports):
            for seg in segs:
                _save_segment(out_root, split_name, f"{count}_{count}", seg, str(report))
                count += 1
        print(f"{split_name}: {count} segments saved")

