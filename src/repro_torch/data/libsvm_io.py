"""LibSVM text format IO — the paper's interchange format (a copy of
``repro/data/libsvm_io.py``: numpy only, the same bytes).

The paper measures data-loading time of the 200 GB LibSVM file as the
baseline every preprocessing cost is compared against (Table 2).  We
implement a streaming reader/writer with sharding so the Table-2
benchmark can be reproduced at any scale.
"""
from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def write_libsvm(
    path: str,
    rows: Iterable[np.ndarray],
    labels: Iterable[int],
    values: Optional[Iterable[np.ndarray]] = None,
) -> int:
    """Writes `label idx:val ...` lines (binary → val 1). Returns #rows."""
    n = 0
    with open(path, "w") as f:
        if values is None:
            for idx, y in zip(rows, labels):
                f.write(str(int(y)))
                f.write(" ")
                f.write(" ".join(f"{int(i)}:1" for i in idx))
                f.write("\n")
                n += 1
        else:
            for idx, y, val in zip(rows, labels, values):
                f.write(str(int(y)))
                f.write(" ")
                f.write(" ".join(
                    f"{int(i)}:{float(v):g}" for i, v in zip(idx, val)))
                f.write("\n")
                n += 1
    return n


def read_libsvm(
    path: str, with_values: bool = False
) -> Iterator[Tuple[np.ndarray, int, Optional[np.ndarray]]]:
    """Streams (indices int64, label, values|None) per line."""
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            y = int(float(parts[0]))
            idx = np.empty(len(parts) - 1, dtype=np.int64)
            val = np.empty(len(parts) - 1, dtype=np.float32) \
                if with_values else None
            for i, tok in enumerate(parts[1:]):
                a, _, b = tok.partition(":")
                idx[i] = int(a)
                if with_values:
                    val[i] = float(b)
            yield idx, y, val


def shard_paths(root: str, n_shards: int) -> List[str]:
    return [os.path.join(root, f"shard_{i:05d}.libsvm")
            for i in range(n_shards)]


def write_shards(
    root: str,
    rows: Sequence[np.ndarray],
    labels: Sequence[int],
    n_shards: int,
) -> List[str]:
    """Round-robin shards rows into n_shards LibSVM files."""
    os.makedirs(root, exist_ok=True)
    paths = shard_paths(root, n_shards)
    for s, p in enumerate(paths):
        sel = range(s, len(rows), n_shards)
        write_libsvm(p, [rows[i] for i in sel],
                     [labels[i] for i in sel])
    return paths


def read_shards(paths: Sequence[str]) -> Tuple[List[np.ndarray], np.ndarray]:
    rows: List[np.ndarray] = []
    labels: List[int] = []
    for p in paths:
        for idx, y, _ in read_libsvm(p):
            rows.append(idx)
            labels.append(y)
    return rows, np.asarray(labels, dtype=np.int32)
