"""Small IO / list helpers (counterpart of sasvqa_tpu/utils/basic.py;
reference: src/utils/basic_utils.py:8-180)."""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Iterable, List


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(data: Any, path: str, save_pretty: bool = False,
              sort_keys: bool = False) -> None:
    with open(path, "w") as f:
        if save_pretty:
            f.write(json.dumps(data, indent=4, sort_keys=sort_keys))
        else:
            json.dump(data, f)


def load_jsonl(path: str) -> List[Any]:
    with open(path) as f:
        return [json.loads(line.strip("\n")) for line in f if line.strip()]


def save_jsonl(data: Iterable[Any], path: str) -> None:
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(e) for e in data))


def flat_list_of_lists(lst: List[List[Any]]) -> List[Any]:
    """[[1,2],[3]] -> [1,2,3]"""
    return [item for sublist in lst for item in sublist]


def get_rounded_percentage(float_number: float, n_floats: int = 2) -> float:
    """Round to a percentage (reference: src/utils/basic_utils.py:179-180)."""
    return round(float_number * 100, n_floats)


def zip_source_tree(src_dir: str, out_zip: str,
                    exts: Iterable[str] = (".py", ".json", ".sh", ".md")) -> None:
    """Snapshot the codebase into a zip for run-metadata capture
    (reference: src/utils/load_save.py:24-34)."""
    exts = tuple(exts)
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(src_dir):
            dirs[:] = [d for d in dirs
                       if d not in (".git", "__pycache__", ".pytest_cache")]
            for fname in files:
                if fname.endswith(exts):
                    full = os.path.join(root, fname)
                    zf.write(full, os.path.relpath(full, src_dir))


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
