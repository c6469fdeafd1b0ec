"""Dataset splits: random file-level (Setting 1) and cross-subject LOSO
(Setting 2).

A copy of ``wiflow_tpu/data/splits.py`` (pure Python and numpy).  The
file-level split reproduces the reference's exact semantics
(ref dataset.py:256-294): ``random.seed(seed)`` +
``random.shuffle`` of *file* indices (Python stdlib RNG, not numpy — the
sequence differs!), 70/15/15 ratio cuts with ``floor``, then expansion to
per-file window ranges.  Given the same file count and seed 42 this yields
the identical train/val/test partition as the reference.

LOSO (leave-one-subject-out) exists only as README results upstream, with
no code; it is built from the per-subject file-id
convention used by the PAM label directories (``wisppn_labels{1..5}``).
Both give the JAX package's partition, index for index.
"""

from __future__ import annotations

import random
import re
from typing import List, Sequence, Tuple

import numpy as np


def file_level_split(
    num_files: int,
    train_ratio: float = 0.7,
    val_ratio: float = 0.15,
    seed: int = 42,
) -> Tuple[List[int], List[int], List[int]]:
    """Shuffled file-index partition, reference-exact (dataset.py:256-276)."""
    rng = random.Random()
    rng.seed(seed)
    file_indices = list(range(num_files))
    rng.shuffle(file_indices)
    train_split = int(np.floor(train_ratio * num_files))
    val_split = int(np.floor(val_ratio * num_files))
    train = file_indices[:train_split]
    val = file_indices[train_split:train_split + val_split]
    test = file_indices[train_split + val_split:]
    return train, val, test


def expand_to_samples(window_ranges: np.ndarray,
                      file_indices: Sequence[int]) -> np.ndarray:
    """File indices -> concatenated window indices (dataset.py:279-290)."""
    parts = [np.arange(window_ranges[f, 0], window_ranges[f, 1])
             for f in file_indices]
    if not parts:
        return np.zeros((0,), np.int64)
    return np.concatenate(parts)


# token-anchored: "subject3", "user_2", "s05" as a path token — but not a
# bare digit run inside an unrelated word ("files3"); --subject_map in
# cli/run.py gives an explicit mapping instead
_SUBJECT_RE = re.compile(
    r"(?:^|[_\-/])(?:subject|person|user|s)[_\-]?(\d+)", re.IGNORECASE)


def infer_subject(file_id: str) -> int:
    """Best-effort subject id from a file id like 'subject3_walk_01'."""
    m = _SUBJECT_RE.search(file_id)
    if not m:
        raise ValueError(f"cannot infer subject from file id {file_id!r}; "
                         f"pass an explicit file->subject mapping")
    return int(m.group(1))


def loso_split(
    file_subjects: Sequence[int],
    test_subject: int,
    val_ratio: float = 0.15,
    seed: int = 42,
) -> Tuple[List[int], List[int], List[int]]:
    """Leave-one-subject-out: test = all files of ``test_subject``;
    remaining files are shuffled and split into train/val."""
    test = [i for i, s in enumerate(file_subjects) if s == test_subject]
    rest = [i for i, s in enumerate(file_subjects) if s != test_subject]
    if not test:
        raise ValueError(f"no files for subject {test_subject}")
    rng = random.Random()
    rng.seed(seed)
    rng.shuffle(rest)
    n_val = max(1, int(np.floor(val_ratio * len(rest))))
    return rest[n_val:], rest[:n_val], test
