"""Binary file format: directory/zip traversal + subsampling reader.

Rebuild of the reference's ``"binary"`` Hadoop data source
(ref: core/src/main/scala/com/microsoft/ml/spark/io/binary/BinaryFileFormat.scala
(251 LoC) — recursive directory listing, zip-archive traversal where each
entry becomes a row named ``archive.zip/entry``, and Bernoulli subsampling
with a seeded RNG; BinaryRecordReader:~35).

Rows: ``path`` (str), ``length`` (int64), ``modification_time`` (float64,
epoch seconds), ``bytes`` (object: bytes).
"""
from __future__ import annotations

import fnmatch
import os
import zipfile
from typing import Iterator, List, Optional, Tuple

import numpy as np

from synapseml_tpu_torch.data.table import Table


def _iter_files(root: str, recursive: bool, pattern: Optional[str]
                ) -> Iterator[str]:
    if os.path.isfile(root):
        yield root
        return
    if recursive:
        for dirpath, _, files in os.walk(root):
            for f in sorted(files):
                if pattern is None or fnmatch.fnmatch(f, pattern):
                    yield os.path.join(dirpath, f)
    else:
        for f in sorted(os.listdir(root)):
            p = os.path.join(root, f)
            if os.path.isfile(p) and (pattern is None
                                      or fnmatch.fnmatch(f, pattern)):
                yield p


def _records(path: str, inspect_zip: bool
             ) -> Iterator[Tuple[str, int, float, bytes]]:
    mtime = os.path.getmtime(path)
    if inspect_zip and zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            for info in zf.infolist():
                if info.is_dir():
                    continue
                data = zf.read(info.filename)
                # "archive.zip/entry" naming, as the reference's zip
                # traversal exposes entries (BinaryFileFormat.scala)
                yield (f"{path}/{info.filename}", len(data), mtime, data)
    else:
        with open(path, "rb") as fh:
            data = fh.read()
        yield (path, len(data), mtime, data)


def read_binary_files(path: str, recursive: bool = True,
                      pattern: Optional[str] = None,
                      sample_ratio: float = 1.0, seed: int = 0,
                      inspect_zip: bool = True) -> Table:
    """Read files (and zip entries) under ``path`` into a Table, keeping
    each record with probability ``sample_ratio`` (seeded Bernoulli, the
    reference's subsampling knob)."""
    rng = np.random.default_rng(seed)
    paths: List[str] = []
    lengths: List[int] = []
    mtimes: List[float] = []
    blobs: List[bytes] = []
    for f in _iter_files(path, recursive, pattern):
        for rec_path, length, mtime, data in _records(f, inspect_zip):
            if sample_ratio < 1.0 and rng.random() >= sample_ratio:
                continue
            paths.append(rec_path)
            lengths.append(length)
            mtimes.append(mtime)
            blobs.append(data)
    byte_col = np.empty(len(blobs), dtype=object)
    byte_col[:] = blobs
    return Table({
        "path": np.array(paths, dtype=object),
        "length": np.array(lengths, dtype=np.int64),
        "modification_time": np.array(mtimes, dtype=np.float64),
        "bytes": byte_col,
    })
