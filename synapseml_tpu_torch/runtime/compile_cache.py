"""The executable store and the warmup report: cold-start bookkeeping.

The counterpart of the reference package's ``runtime/compile_cache.py``.
The reference persists serialized XLA executables so a restarted replica
deserializes each warmed bucket instead of compiling it. The port's warm
program for a bucket is a **CUDA graph** captured by
:meth:`BatchedExecutor.warmup` (on the CPU, the eager function bound to
the bucket's signature), and a CUDA graph cannot be written to disk. So
an entry of :class:`ExecutableStore` holds the **signature's record**, not
a program:

- the staged input signature (shapes and dtype names, bucket-padded);
- the output leaves' shapes and dtypes;
- the sha256 (:func:`output_digest`) of the outputs of one run of the
  warm program on zero-filled inputs.

A restarted executor that finds the entry still captures the graph, then
runs it once on zeros: if the digest matches, the entry is ``loaded`` —
the same program as the one persisted; if not, the mismatch is counted in
``compile_cache_store_skew_total``, the entry is rewritten and the status
is ``compiled``. ``loaded`` therefore does not mean "no capture cost": its
capture and check are timed into ``executor_compile_seconds{phase=
"deserialize"}``, and no time saving is claimed for it. A run on zeros
cannot see weights that only multiply the input (a bias-free linear map):
the caller's ``cache_key``, a content hash of the model bytes, carries
those.

An entry lives at ``<dir>/executables/<key>.xc``. Its header has magic
bytes of its own, so an entry the JAX package wrote is a foreign file (a
deserialize failure, the plain miss), never a skew. Any miss, skew or
corrupt entry degrades to a fresh capture: a broken store can slow a
warmup down, never break it.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from synapseml_tpu_torch.runtime import telemetry as _tm

_ENV_KNOB = "SYNAPSEML_COMPILE_CACHE"
_FORMAT_VERSION = 1
_MAGIC = b"SMTTXC1\n"  # the JAX package's entries start b"SMTXC1\n"

# store traffic counters: hits split memo vs disk; misses, skews and
# unreadable entries are distinct — a volume full of entries another
# runtime wrote looks like "misses" without the skew/failure split
_M_HIT = _tm.counter("compile_cache_store_hits_total")
_M_MISS = _tm.counter("compile_cache_store_misses_total")
_M_SKEW = _tm.counter("compile_cache_store_skew_total")
_M_DESER_FAIL = _tm.counter("compile_cache_deserialize_failures_total")
_M_SAVE = _tm.counter("compile_cache_saves_total")
_M_SAVE_FAIL = _tm.counter("compile_cache_save_failures_total")
# what a "loaded" warmup disposition paid: the capture of the graph and
# its digest check (runtime/executor.py observes it; the executor
# registers the warmup/dispatch phases)
_M_DESER_S = _tm.histogram("executor_compile_seconds",
                           phase="deserialize")

# every live store, so JitCache.clear() (runtime/executor.py) can drop
# memoized records without each test knowing which stores exist
_OPEN_STORES: "weakref.WeakSet[ExecutableStore]" = weakref.WeakSet()


def default_cache_dir() -> Optional[str]:
    """The framework knob: ``SYNAPSEML_COMPILE_CACHE`` names the cache
    directory; unset/empty means the store stays off unless a caller
    passes an explicit ``compile_cache_dir=``."""
    path = os.environ.get(_ENV_KNOB, "").strip()
    return path or None


def enable_persistent_cache(path: Optional[str] = None) -> Optional[str]:
    """Create the cache directory and return it (None when no path is
    configured). Idempotent.

    The reference wires JAX's own persistent compilation cache here. An
    eager PyTorch forward compiles nothing, so there is no such cache to
    wire: the directory is kept for :class:`ExecutableStore`, which lives
    under it."""
    path = path or default_cache_dir()
    if path:
        os.makedirs(path, exist_ok=True)
    return path


def env_fingerprint(device: Union[str, torch.device, None] = None) -> str:
    """Version skew guard baked into every executable key and entry
    header: torch's version, CUDA's, cuDNN's and the device name (on the
    CPU, torch's version and ``cpu``). A cache dir surviving a torch or
    driver-stack upgrade, or moved to another card, must miss. ``device``
    defaults to the current CUDA device where there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"torch={torch.__version__}|device=cpu"
    return "|".join((
        f"torch={torch.__version__}",
        f"cuda={torch.version.cuda}",
        f"cudnn={torch.backends.cudnn.version()}",
        f"device={torch.cuda.get_device_name(dev)}",
    ))


def executable_key(cache_key: str, *, bucket: int, sig: Any, layout: str,
                   mesh_shape: Tuple[int, ...], device_kind: str,
                   fingerprint: Optional[str] = None) -> str:
    """Content-addressed key for one warmed signature.

    ``cache_key`` is the caller's content hash — for ONNXModel the sha256
    of the raw model bytes plus the compute-dtype/normalization config,
    i.e. *graph and weights*; ``sig`` is the staged input signature
    (shapes+dtypes, bucket-padded); ``layout``/``mesh_shape``/
    ``device_kind`` pin the device topology; the env fingerprint pins the
    torch/CUDA/cuDNN versions and the device. Change any ingredient and
    the key misses — a fresh capture, never a stale hit."""
    blob = json.dumps({
        "v": _FORMAT_VERSION,
        "cache_key": cache_key,
        "bucket": bucket,
        "sig": repr(sig),
        "layout": layout,
        "mesh_shape": list(mesh_shape),
        "device_kind": device_kind,
        "env": fingerprint if fingerprint is not None else env_fingerprint(),
    }, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def content_hash(*parts: Any) -> str:
    """Stable sha256 over heterogeneous key parts (bytes hashed raw, the
    rest by repr) — the helper model wrappers use to build ``cache_key``
    from payload bytes + config."""
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, (bytes, bytearray)):
            h.update(b"b:")
            h.update(p)
        else:
            h.update(repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()


def dtype_name(dt: Any) -> str:
    """A dtype (torch, numpy or a name) by the name the reference's
    signatures spell it (``jnp.dtype(...).name``: "float32", "bfloat16",
    "uint8")."""
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return dt if isinstance(dt, str) else np.dtype(dt).name


def _leaf_spec(leaf) -> Tuple[List[int], str]:
    """An output leaf's shape and dtype name."""
    if not isinstance(leaf, torch.Tensor):
        leaf = np.asarray(leaf)
    return list(leaf.shape), dtype_name(leaf.dtype)


def output_digest(leaves: Sequence[Any]) -> str:
    """sha256 over output leaves: each leaf's shape, dtype name and raw
    bytes, in order. Copies card tensors to the host (waits for them)."""
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(json.dumps(_leaf_spec(leaf)).encode())
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().contiguous().cpu()
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()


def signature_record(sig: Sequence[Tuple[Tuple[int, ...], str]],
                     leaves: Sequence[Any], digest: str) -> Dict[str, Any]:
    """The record an entry holds (JSON-ready): the staged input
    signature, the output leaves' shapes and dtypes, and the digest of
    the outputs of one run on zero-filled inputs."""
    return {"sig": [[list(s), d] for s, d in sig],
            "outputs": [list(_leaf_spec(leaf)) for leaf in leaves],
            "digest": digest}


class ExecutableStore:
    """Directory of signature records, one file per key.

    ``save``/``load`` never raise for cache problems: a failed save is
    dropped (the warm program already exists — nothing is lost), a failed
    load (missing file, truncation, foreign bytes, version skew) returns
    None so the caller captures fresh. ``load`` memoizes per key;
    :meth:`invalidate` drops the memo (JitCache.clear() calls it through
    :func:`invalidate_open_stores` so cleared tests re-read disk).
    ``device`` is the device the store's entries are for: its fingerprint
    is what a header must carry."""

    def __init__(self, directory: str,
                 device: Union[str, torch.device, None] = None):
        self.directory = str(directory)
        self.device = device
        self._memo: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self.closed = False
        _OPEN_STORES.add(self)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.xc")

    def fingerprint(self) -> str:
        return env_fingerprint(self.device)

    def save(self, key: str, record: Dict[str, Any]) -> bool:
        if self.closed:
            return False
        try:
            meta = json.dumps({"v": _FORMAT_VERSION,
                               "env": self.fingerprint()}).encode()
            blob = b"".join((_MAGIC, len(meta).to_bytes(4, "big"), meta,
                             json.dumps(record, sort_keys=True).encode()))
            os.makedirs(self.directory, exist_ok=True)
            # atomic publish: a concurrent reader (another replica on the
            # same cache volume) sees either the full entry or nothing —
            # never a truncated file
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as fh:
                    fh.write(blob)
                os.replace(tmp, self._path(key))
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            _M_SAVE.inc()
            return True
        except Exception:  # noqa: BLE001 - cache write is best-effort
            _M_SAVE_FAIL.inc()
            return False

    def load(self, key: str) -> Optional[Dict[str, Any]]:
        if self.closed:
            return None
        with self._lock:
            if key in self._memo:
                _M_HIT.inc()
                return self._memo[key]
        try:
            with open(self._path(key), "rb") as fh:
                raw = fh.read()
        except OSError:  # no such entry: the plain miss
            _M_MISS.inc()
            return None
        try:
            if not raw.startswith(_MAGIC):
                _M_DESER_FAIL.inc()  # truncated/foreign bytes
                return None
            off = len(_MAGIC)
            mlen = int.from_bytes(raw[off:off + 4], "big")
            off += 4
            meta = json.loads(raw[off:off + mlen].decode())
            off += mlen
            if (meta.get("v") != _FORMAT_VERSION
                    or meta.get("env") != self.fingerprint()):
                # another format or runtime wrote it: unusable, capture
                # fresh
                _M_SKEW.inc()
                return None
            record = json.loads(raw[off:].decode())
            if not {"sig", "outputs", "digest"} <= set(record):
                raise ValueError("incomplete record")
        except Exception:  # noqa: BLE001 - any corruption = miss
            _M_DESER_FAIL.inc()
            return None
        with self._lock:
            self._memo[key] = record
        _M_HIT.inc()
        return record

    def matches(self, key: str, record: Dict[str, Any],
                fresh: Dict[str, Any]) -> bool:
        """Whether a loaded ``record`` describes the program just warmed
        (``fresh``, its :func:`signature_record`). A mismatch is a skew:
        counted, and the memo dropped so the caller's rewrite wins."""
        if record == fresh:
            return True
        _M_SKEW.inc()
        with self._lock:
            self._memo.pop(key, None)
        return False

    def invalidate(self):
        """Drop memoized records so the next load re-reads disk."""
        with self._lock:
            self._memo.clear()

    def close(self):
        """Invalidate and refuse further traffic (JitCache.clear() path:
        a cleared cache must not resurrect stale records)."""
        self.invalidate()
        self.closed = True


def invalidate_open_stores(close: bool = False) -> int:
    """Invalidate (or close) every live :class:`ExecutableStore`.

    ``JitCache.clear()`` calls this so tests that clear caches cannot read
    back memoized, possibly stale records afterward. Returns the number of
    stores touched."""
    stores = list(_OPEN_STORES)
    for st in stores:
        if close:
            st.close()
        else:
            st.invalidate()
    return len(stores)


class WarmupReport:
    """Outcome of one :meth:`BatchedExecutor.warmup` sweep.

    ``entries`` lists one dict per (bucket, layout) signature with its
    disposition: ``"warm"`` (already warmed by an earlier sweep),
    ``"loaded"`` (a store entry whose digest the fresh warm program
    reproduced), ``"compiled"`` (warmed fresh, persisted when a store is
    configured), or ``"error"`` (that signature serves eagerly; the error
    rides in ``errors``). Each warmed entry carries ``seconds``, the time
    its capture and digest check took. Warmup itself never raises for
    cache or capture problems — a failed signature just runs eagerly, the
    executor's behaviour without warmup."""

    def __init__(self):
        self.entries: List[Dict[str, Any]] = []
        self.errors: List[str] = []

    @property
    def compiled(self) -> int:
        return sum(1 for e in self.entries if e["status"] == "compiled")

    @property
    def loaded(self) -> int:
        return sum(1 for e in self.entries if e["status"] == "loaded")

    def __repr__(self):
        return (f"WarmupReport(signatures={len(self.entries)}, "
                f"compiled={self.compiled}, loaded={self.loaded}, "
                f"errors={len(self.errors)})")
