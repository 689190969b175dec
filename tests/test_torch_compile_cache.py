"""The port's warmup, executable store and recompile sentinel against the
JAX package's, on the CPU.

Each case of ``tests/test_compile_cache.py`` that needs neither several
devices nor ``io/serving.py`` runs here on both executors — the JAX
``BatchedExecutor`` and the port's ``BatchedExecutor(device="cpu")``,
whose warm program on the CPU is the eager ``fn`` bound to the bucket's
signature — with the same seeded numpy inputs: the bucket lists and
statuses, the compiled and loaded counts and ``_aot_hits`` agree, and the
outputs agree bitwise for ``x * 2 + 1`` and within rtol=1e-6 for
``tanh(x @ w)`` (with atol=1e-6: XLA's tanh and product round apart from
torch's by up to ~2e-7 near zero, 1.6e-7 seen at |y| = 0.1). The restart case holds the port to the store's contract
(see its docstring). Added: the store's header and magic bytes, a JAX
entry read as a foreign file, a digest skew, ``env_fingerprint``, each
sentinel reason that can fire (``donation_mask`` stays 0), and
``ONNXModel.warmup`` against the JAX ``ONNXModel.warmup`` on ``zoo.mlp``.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.runtime import compile_cache as jax_cc
from synapseml_tpu.runtime import executor as jax_executor
from synapseml_tpu.runtime import telemetry as jax_tm
from synapseml_tpu_torch.runtime import compile_cache as cc
from synapseml_tpu_torch.runtime import telemetry as port_tm
from synapseml_tpu_torch.runtime.executor import (GLOBAL_JIT_CACHE,
                                                  RECOMPILE_REASONS,
                                                  BatchedExecutor)

TANH_RTOL = TANH_ATOL = 1e-6
ROW = ((6,), np.float32)


@pytest.fixture(autouse=True)
def _restore_global_cache_config():
    """The JAX executor wires process-global jax config at tmp paths
    pytest deletes afterward — restore it (as tests/test_compile_cache.py
    does). Both registries start from zero."""
    prev = jax.config.jax_compilation_cache_dir
    prev_wired = jax_cc._PERSISTENT_WIRED
    jax_tm.reset()
    port_tm.reset()
    yield
    jax.config.update("jax_compilation_cache_dir", prev)
    jax_cc._PERSISTENT_WIRED = prev_wired


def _w():
    return np.random.default_rng(0).standard_normal((6, 4)).astype(
        np.float32)


def _jax_fn(p, x):
    return (jnp.tanh(x @ p), x * 2.0 + 1.0)


def _port_fn(p, x):
    return (torch.tanh(x @ p), x * 2.0 + 1.0)


def _x(n=20, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 6)).astype(np.float32)


class Pair:
    """The JAX executor and the port's (``device="cpu"``) over the same
    function, weights and arguments; ``cache_dir`` is given to each under
    its own subdirectory (the two stores never share a file)."""

    def __init__(self, w=None, cache_dir=None, **kw):
        w = _w() if w is None else w
        jkw, pkw = dict(kw), dict(kw)
        if cache_dir is not None:
            jkw["cache_dir"] = os.path.join(str(cache_dir), "jax")
            pkw["cache_dir"] = os.path.join(str(cache_dir), "port")
        self.ref = jax_executor.BatchedExecutor(_jax_fn, bound_args=(w,),
                                                **jkw)
        self.port = BatchedExecutor(_port_fn, device="cpu", bound_args=(w,),
                                    **pkw)

    def warmup(self, *a, **k):
        return self.port.warmup(*a, **k), self.ref.warmup(*a, **k)

    def __call__(self, x):
        got, want = self.port(x), self.ref(x)
        _agree(got, want)
        return got

    def close(self):
        self.ref.close(wait=False)
        self.port.close(wait=False)


def _agree(got, want):
    """tanh(x @ w) within rtol=atol=1e-6, x * 2 + 1 bitwise, dtypes
    equal."""
    assert len(got) == len(want) == 2
    g0, w0 = np.asarray(got[0]), np.asarray(want[0])
    assert g0.dtype == w0.dtype and g0.shape == w0.shape
    np.testing.assert_allclose(g0, w0, rtol=TANH_RTOL, atol=TANH_ATOL)
    g1, w1 = np.asarray(got[1]), np.asarray(want[1])
    assert g1.dtype == w1.dtype and g1.tobytes() == w1.tobytes()


def _same_report(got, want):
    """Bucket lists, statuses and the compiled/loaded counts agree."""
    assert [e["bucket"] for e in got.entries] == \
        [e["bucket"] for e in want.entries]
    assert [e["status"] for e in got.entries] == \
        [e["status"] for e in want.entries]
    assert (got.compiled, got.loaded) == (want.compiled, want.loaded)
    assert bool(got.errors) == bool(want.errors)


def _same(a, b):
    for x, y in zip(a, b):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def _value(tm, name, **labels) -> float:
    return sum(m.value for lab, m in tm.series(name)
               if all(lab.get(k) == v for k, v in labels.items()))


# -- warmup mechanics ----------------------------------------------------

def test_warmup_precompiles_full_ladder_and_dispatch_uses_aot():
    pair = Pair(max_bucket=32)
    plain = Pair(max_bucket=32)
    try:
        got, want = pair.warmup([ROW])
        assert [e["bucket"] for e in got.entries] == [8, 16, 32]
        assert got.compiled == 3 and got.loaded == 0 and not got.errors
        _same_report(got, want)
        assert [e["sig"] for e in got.entries] == \
            [e["sig"] for e in want.entries]
        for n in (1, 9, 20, 32):
            out = pair(_x(n, seed=n))
            _same(out, plain.port(_x(n, seed=n)))
        assert pair.port._aot_hits == pair.ref._aot_hits == 4
        got2, want2 = pair.warmup([ROW])
        assert all(e["status"] == "warm" for e in got2.entries)
        _same_report(got2, want2)
    finally:
        pair.close()
        plain.close()


def test_warmup_from_example_arrays_matches_staged_signature():
    """An example array with a batch dim and a dtype staging coerces
    (f64 -> f32) gives the signature the pipeline dispatches."""
    pair = Pair(max_bucket=16)
    try:
        got, want = pair.warmup([np.zeros((5, 6), np.float64)])
        assert got.compiled == len(got.entries) > 0
        _same_report(got, want)
        assert got.entries[0]["sig"] == (((8, 6), "float32"),)
        pair(np.zeros((5, 6), np.float64))
        assert pair.port._aot_hits == pair.ref._aot_hits == 1
    finally:
        pair.close()


def test_warmup_unbounded_executor_requires_buckets():
    pair = Pair()
    try:
        with pytest.raises(ValueError) as got:
            pair.port.warmup([ROW])
        with pytest.raises(ValueError) as want:
            pair.ref.warmup([ROW])
        assert str(got.value) == str(want.value)
        got, want = pair.warmup([ROW], buckets=[8])
        assert got.compiled == 1
        _same_report(got, want)
    finally:
        pair.close()


@pytest.mark.parametrize("kw, ladder", [
    (dict(max_bucket=100), [8, 16, 32, 64, 100]),
    (dict(min_bucket=4, max_bucket=16), [4, 8, 16]),
    (dict(static_batch=24), [24]),
])
def test_bucket_ladder_matches_the_reference(kw, ladder):
    pair = Pair(**kw)
    try:
        assert pair.port._bucket_ladder() == pair.ref._bucket_ladder() \
            == ladder
    finally:
        pair.close()


def test_warmup_error_degrades_to_lazy_jit():
    """A signature whose warm program fails to build is reported, not
    raised — and the executor still serves it eagerly. The JAX side
    breaks its ``_jit_for``, the port its ``_capture``."""
    jax_ex = jax_executor.BatchedExecutor(lambda x: (x * 2.0,), max_bucket=8)
    port_ex = BatchedExecutor(lambda x: (x * 2.0,), device="cpu",
                              max_bucket=8)

    def broken(*a, **k):
        raise RuntimeError("synthetic AOT failure")

    try:
        orig = jax_ex._jit_for
        jax_ex._jit_for = broken
        port_ex._capture = broken
        want = jax_ex.warmup([((3,), np.float32)])
        got = port_ex.warmup([((3,), np.float32)])
        jax_ex._jit_for = orig
        del port_ex._capture
        assert got.entries[0]["status"] == "error" and got.errors
        _same_report(got, want)
        x = np.ones((4, 3), np.float32)
        (out,) = port_ex(x)
        np.testing.assert_array_equal(out, np.full((4, 3), 2.0, np.float32))
        _same((out,), jax_ex(x))
        # served eagerly: a post-warmup first run of a failed signature
        # surfaces as shape_drift in both packages
        for tm in (jax_tm, port_tm):
            assert _value(tm, "executor_recompiles_total",
                          reason="shape_drift") == 1
    finally:
        jax_ex.close(wait=False)
        port_ex.close(wait=False)


# -- persistence (the restarted-replica path) ---------------------------

def test_persist_roundtrip_new_executor_loads_and_matches(tmp_path):
    """The port's restart against the store's contract: a second executor
    on the same directory finds every entry, re-captures, reproduces each
    digest (``loaded``), and serves from the warm table. The JAX package
    is not the oracle for the loaded executor here: on this host its
    deserialized XLA:CPU executables do not run (a machine-feature
    mismatch), so its dispatch retires them and ``_aot_hits`` stays 0.
    The outputs are still held to the JAX executor's."""
    kw = dict(max_bucket=32, cache_key="model-v1", cache_dir=tmp_path)
    pa = Pair(**kw)
    try:
        got, want = pa.warmup([ROW])
        assert got.compiled == 3
        assert all(e.get("persisted") for e in got.entries)
        _same_report(got, want)
        want_a = pa(_x())
    finally:
        pa.close()
    exb = BatchedExecutor(_port_fn, device="cpu", bound_args=(_w(),),
                          max_bucket=32, cache_key="model-v1",
                          cache_dir=os.path.join(str(tmp_path), "port"))
    try:
        rep_b = exb.warmup([ROW])
        assert rep_b.loaded == 3 and rep_b.compiled == 0
        assert all("persisted" not in e for e in rep_b.entries)
        _same(exb(_x()), want_a)
        assert exb._aot_hits == 1
        assert _value(port_tm, "compile_cache_store_hits_total") == 3
    finally:
        exb.close(wait=False)
    h = port_tm.histogram("executor_compile_seconds", phase="deserialize")
    assert h.count == 3


def test_invalidation_changed_model_bytes(tmp_path):
    """A different cache_key (= changed graph/weights content hash) must
    MISS and warm fresh — with outputs matching ITS OWN model."""
    pa = Pair(max_bucket=8, cache_key="model-v1", cache_dir=tmp_path)
    w2 = _w() * 3.0
    pb = Pair(w=w2, max_bucket=8, cache_key="model-v2", cache_dir=tmp_path)
    plain = Pair(w=w2, max_bucket=8)
    try:
        got, want = pa.warmup([ROW])
        assert got.compiled == 1
        _same_report(got, want)
        got, want = pb.warmup([ROW])
        assert got.loaded == 0 and got.compiled == 1
        _same_report(got, want)
        _same(pb(_x()), plain.port(_x()))
    finally:
        for p in (pa, pb, plain):
            p.close()


def test_invalidation_changed_jax_version_string(tmp_path, monkeypatch):
    """An entry written under another fingerprint (for the port: torch,
    CUDA, cuDNN, the device) must miss: keyed apart, and rejected at load
    time by its header."""
    kw = dict(max_bucket=8, cache_key="m", cache_dir=tmp_path)
    pa = Pair(**kw)
    try:
        got, want = pa.warmup([ROW])
        assert got.compiled == 1
        _same_report(got, want)
    finally:
        pa.close()
    real_jax, real_port = jax_cc.env_fingerprint(), cc.env_fingerprint()
    monkeypatch.setattr(jax_cc, "env_fingerprint",
                        lambda: real_jax + "|jax=99.99.99")
    monkeypatch.setattr(cc, "env_fingerprint",
                        lambda *a, **k: real_port + "|torch=99.99.99")
    pb = Pair(**kw)
    plain = Pair(max_bucket=8)
    try:
        got, want = pb.warmup([ROW])
        assert got.loaded == 0 and got.compiled == 1
        _same_report(got, want)
        # header check: the entry exA wrote, read under the skewed
        # fingerprint with its own key
        skey = cc.executable_key("m", bucket=8, sig=got.entries[0]["sig"],
                                 layout="single", mesh_shape=(1,),
                                 device_kind="cpu", fingerprint=real_port)
        store = cc.ExecutableStore(
            os.path.join(str(tmp_path), "port", "executables"), "cpu")
        skew = _value(port_tm, "compile_cache_store_skew_total")
        assert store.load(skey) is None
        assert _value(port_tm, "compile_cache_store_skew_total") == skew + 1
        monkeypatch.setattr(cc, "env_fingerprint", lambda *a, **k: real_port)
        assert store.load(skey) is not None
        _same(pb(_x()), plain.port(_x()))
    finally:
        pb.close()
        plain.close()


def test_corrupt_cache_entry_falls_back_to_fresh_compile(tmp_path):
    kw = dict(max_bucket=8, cache_key="m", cache_dir=tmp_path)
    pa = Pair(**kw)
    try:
        assert pa.warmup([ROW])[0].compiled == 1
    finally:
        pa.close()
    plain = Pair(max_bucket=8)
    try:
        for pkg in ("port", "jax"):
            exdir = os.path.join(str(tmp_path), pkg, "executables")
            entries = [f for f in os.listdir(exdir) if f.endswith(".xc")]
            assert len(entries) == 1
            path = os.path.join(exdir, entries[0])
            with open(path, "rb") as fh:
                raw = fh.read()
            # deliberate truncation mid-payload
            with open(path, "wb") as fh:
                fh.write(raw[:len(raw) // 2])
        pb = Pair(**kw)
        got, want = pb.warmup([ROW])
        assert got.loaded == 0 and got.compiled == 1 and not got.errors
        _same_report(got, want)
        _same(pb(_x()), plain.port(_x()))
        pb.close()
        # garbage that isn't even our container format: also just a miss
        for pkg in ("port", "jax"):
            exdir = os.path.join(str(tmp_path), pkg, "executables")
            with open(os.path.join(exdir, os.listdir(exdir)[0]), "wb") as fh:
                fh.write(b"\x00not an executable\xff" * 10)
        pc = Pair(**kw)
        got, want = pc.warmup([ROW])
        assert got.compiled == 1
        _same_report(got, want)
        pc.close()
    finally:
        plain.close()


def test_jitcache_clear_invalidates_store_memos(tmp_path):
    """After GLOBAL_JIT_CACHE.clear(), a store must re-read DISK: an
    entry deleted after the clear is observed."""
    from synapseml_tpu.runtime.executor import \
        GLOBAL_JIT_CACHE as JAX_JIT_CACHE

    pa = Pair(max_bucket=8, cache_key="m", cache_dir=tmp_path)
    try:
        pa.warmup([ROW])
        for store, clear, pkg in ((pa.port._store, GLOBAL_JIT_CACHE.clear,
                                   "port"),
                                  (pa.ref._store, JAX_JIT_CACHE.clear,
                                   "jax")):
            exdir = os.path.join(str(tmp_path), pkg, "executables")
            key = os.listdir(exdir)[0][:-len(".xc")]
            assert store.load(key) is not None
            assert store._memo  # memoized
            clear()
            assert not store._memo
            os.unlink(os.path.join(exdir, key + ".xc"))
            assert store.load(key) is None  # deleted entry observed
    finally:
        pa.close()


def test_env_knob_default_cache_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("SYNAPSEML_COMPILE_CACHE", raising=False)
    assert cc.default_cache_dir() is None and \
        jax_cc.default_cache_dir() is None
    monkeypatch.setenv("SYNAPSEML_COMPILE_CACHE", str(tmp_path))
    assert cc.default_cache_dir() == jax_cc.default_cache_dir() == \
        str(tmp_path)
    ex = BatchedExecutor(_port_fn, device="cpu", bound_args=(_w(),),
                         max_bucket=8, cache_key="m")
    try:
        rep = ex.warmup([ROW])
        assert all(e.get("persisted") for e in rep.entries)
        assert os.listdir(os.path.join(str(tmp_path), "executables"))
    finally:
        ex.close(wait=False)


def test_enable_persistent_cache_creates_and_returns_the_directory(
        monkeypatch, tmp_path):
    """Both packages return the configured directory (None when there is
    none); the port's also creates it, for the store under it."""
    monkeypatch.delenv("SYNAPSEML_COMPILE_CACHE", raising=False)
    assert cc.enable_persistent_cache() is None
    path = str(tmp_path / "cache")
    assert cc.enable_persistent_cache(path) == path
    assert os.path.isdir(path)
    assert cc.enable_persistent_cache(path) == path


def test_default_device_and_local_device_count_on_the_cpu():
    """Without CUDA the port counts no local card and its default device
    raises, as every entry point does."""
    from synapseml_tpu_torch.runtime.executor import (default_device,
                                                      local_device_count)

    if torch.cuda.is_available():
        assert local_device_count() == torch.cuda.device_count()
        assert default_device().type == "cuda"
    else:
        assert local_device_count() == 0
        with pytest.raises(RuntimeError):
            default_device()


# -- the port's store: header, foreign files, digest skew ---------------

def test_store_header_magic_and_record(tmp_path):
    """An entry is the port's magic, a 4-byte meta length, the meta JSON
    (format version, env fingerprint) and the signature's record: the
    staged signature, the output leaves' shapes and dtypes, and the
    sha256 of one run on zero-filled inputs."""
    ex = BatchedExecutor(_port_fn, device="cpu", bound_args=(_w(),),
                         max_bucket=8, cache_key="m", cache_dir=str(tmp_path))
    try:
        ex.warmup([ROW])
    finally:
        ex.close(wait=False)
    exdir = os.path.join(str(tmp_path), "executables")
    (name,) = os.listdir(exdir)
    with open(os.path.join(exdir, name), "rb") as fh:
        raw = fh.read()
    assert raw.startswith(b"SMTTXC1\n") and not raw.startswith(jax_cc._MAGIC)
    off = len(cc._MAGIC)
    mlen = int.from_bytes(raw[off:off + 4], "big")
    meta = json.loads(raw[off + 4:off + 4 + mlen])
    assert meta == {"v": 1, "env": cc.env_fingerprint("cpu")}
    record = json.loads(raw[off + 4 + mlen:])
    w = torch.from_numpy(_w())
    zeros = torch.zeros(8, 6)
    leaves = _port_fn(w, zeros)
    assert record == {"sig": [[[8, 6], "float32"]],
                      "outputs": [[[8, 4], "float32"], [[8, 6], "float32"]],
                      "digest": cc.output_digest(leaves)}


def test_jax_entry_is_a_foreign_file_not_a_skew(tmp_path):
    """An entry the JAX package wrote, under the port's key, fails the
    port's magic: a deserialize failure (the plain miss), never a skew;
    the warmup captures fresh and rewrites it."""
    pa = Pair(max_bucket=8, cache_key="m", cache_dir=tmp_path)
    try:
        pa.warmup([ROW])
    finally:
        pa.close()
    jdir = os.path.join(str(tmp_path), "jax", "executables")
    pdir = os.path.join(str(tmp_path), "port", "executables")
    (pname,) = os.listdir(pdir)
    shutil.copy(os.path.join(jdir, os.listdir(jdir)[0]),
                os.path.join(pdir, pname))
    port_tm.reset()
    ex = BatchedExecutor(_port_fn, device="cpu", bound_args=(_w(),),
                         max_bucket=8, cache_key="m",
                         cache_dir=os.path.join(str(tmp_path), "port"))
    try:
        rep = ex.warmup([ROW])
        assert rep.compiled == 1 and rep.loaded == 0 and not rep.errors
        assert rep.entries[0]["persisted"]
    finally:
        ex.close(wait=False)
    assert _value(port_tm, "compile_cache_deserialize_failures_total") == 1
    assert _value(port_tm, "compile_cache_store_skew_total") == 0
    with open(os.path.join(pdir, pname), "rb") as fh:
        assert fh.read().startswith(cc._MAGIC)


def test_digest_skew_is_counted_and_rewritten(tmp_path):
    """An entry whose digest the fresh warm program does not reproduce
    (here: other weights under the same cache_key; the function adds a
    weight row, so a run on zeros sees the weights) is a skew: counted,
    status ``compiled``, the entry rewritten — a third executor of the
    new weights then loads it."""
    def make(w):
        return BatchedExecutor(lambda p, x: (torch.tanh(x @ p) + p[0],),
                               device="cpu", bound_args=(w,),
                               max_bucket=8, cache_key="m",
                               cache_dir=str(tmp_path))

    exs = [make(_w()), make(_w() * 3.0), make(_w() * 3.0)]
    try:
        assert exs[0].warmup([ROW]).compiled == 1
        rep = exs[1].warmup([ROW])
        assert rep.compiled == 1 and rep.loaded == 0
        assert rep.entries[0]["persisted"]
        assert _value(port_tm, "compile_cache_store_skew_total") == 1
        assert exs[2].warmup([ROW]).loaded == 1
        assert _value(port_tm, "compile_cache_store_skew_total") == 1
    finally:
        for ex in exs:
            ex.close(wait=False)


def test_env_fingerprint_names_torch_and_the_device():
    assert cc.env_fingerprint("cpu") == \
        f"torch={torch.__version__}|device=cpu"
    key = dict(bucket=8, sig=(((8, 6), "float32"),), layout="single",
               mesh_shape=(1,), device_kind="cpu")
    assert cc.executable_key("m", **key, fingerprint="a") != \
        cc.executable_key("m", **key, fingerprint="b")
    assert cc.executable_key("m", **key, fingerprint="a") != \
        cc.executable_key("n", **key, fingerprint="a")
    assert cc.content_hash(b"x", 1, ("y",)) == \
        jax_cc.content_hash(b"x", 1, ("y",))


# -- the recompile sentinel ----------------------------------------------

def test_sentinel_shape_drift_counts_an_unwarmed_bucket():
    """After warmup of bucket 8 alone, a 9-row call (bucket 16) is one
    shape_drift in both packages, counted once however often it runs."""
    pair = Pair(max_bucket=16)
    try:
        pair.warmup([ROW], buckets=[8])
        for _ in range(2):
            pair(_x(9))
        for tm in (jax_tm, port_tm):
            assert _value(tm, "executor_recompiles_total",
                          reason="shape_drift") == 1
            assert _value(tm, "executor_aot_misses_total") == 2
        assert pair.port._aot_hits == pair.ref._aot_hits == 0
    finally:
        pair.close()


def test_sentinel_arity_counts_an_unwarmed_argument_count():
    def port_fn(*xs):
        return (sum(x * 1.0 for x in xs),)

    def jax_fn(*xs):
        return (sum(x * 1.0 for x in xs),)

    jax_ex = jax_executor.BatchedExecutor(jax_fn, max_bucket=8)
    port_ex = BatchedExecutor(port_fn, device="cpu", max_bucket=8)
    try:
        port_ex.warmup([ROW])
        jax_ex.warmup([ROW])
        x = _x(4)
        _same(port_ex(x, x), jax_ex(x, x))
        for tm in (jax_tm, port_tm):
            assert _value(tm, "executor_recompiles_total",
                          reason="arity") == 1
            assert _value(tm, "executor_recompiles_total",
                          reason="shape_drift") == 0
    finally:
        jax_ex.close(wait=False)
        port_ex.close(wait=False)


def test_sentinel_cache_skew_retires_a_warm_program_that_raises():
    """A warm program whose run raises is retired, the batch runs
    eagerly (same rows), and the sentinel names it cache_skew; the next
    call takes the eager path without a second count."""
    pair = Pair(max_bucket=8)
    try:
        pair.warmup([ROW])
        sig = (((8, 6), "float32"),)
        assert (sig, "single", 0) in pair.port._aot

        def boom(*a, **k):
            raise RuntimeError("replay failed")

        pair.port._replay = boom
        want = pair.ref(_x(5))
        got = pair.port(_x(5))
        _agree(got, want)
        del pair.port._replay
        pair.port(_x(5))
        assert (sig, "single", 0) not in pair.port._aot
        assert _value(port_tm, "executor_aot_retired_total") == 1
        assert _value(port_tm, "executor_recompiles_total",
                      reason="cache_skew") == 1
        for r in RECOMPILE_REASONS:
            if r != "cache_skew":
                assert _value(port_tm, "executor_recompiles_total",
                              reason=r) == 0
    finally:
        pair.close()


def test_sentinel_is_silent_before_warmup_and_donation_mask_stays_zero():
    pair = Pair(max_bucket=16)
    try:
        pair(_x(3))
        pair(_x(12))
        assert _value(port_tm, "executor_recompiles_total") == 0
        assert _value(jax_tm, "executor_recompiles_total") == 0
        assert port_tm.histogram("executor_compile_seconds",
                                 phase="dispatch").count == 2
        labels = {lab["reason"] for lab, _ in
                  port_tm.series("executor_recompiles_total")}
        assert labels == set(RECOMPILE_REASONS)
        assert _value(port_tm, "executor_recompiles_total",
                      reason="donation_mask") == 0
    finally:
        pair.close()


# -- model-layer wiring -------------------------------------------------

def _models(blob, tmp, **params):
    from synapseml_tpu.onnx import ONNXModel as JaxONNXModel
    from synapseml_tpu_torch.onnx import ONNXModel

    jm = JaxONNXModel(model_bytes=blob)
    pm = ONNXModel(model_bytes=blob)
    if tmp is not None:
        jm.set(compile_cache_dir=os.path.join(str(tmp), "jax"))
        pm.set(compile_cache_dir=os.path.join(str(tmp), "port"))
    jm.set(**params)
    pm.set(**params)
    return pm, jm


def test_onnxmodel_warmup_persist_and_restart(tmp_path):
    from synapseml_tpu.data.table import Table as JaxTable
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import zoo

    blob = zoo.mlp([16, 32], num_classes=4, seed=0)
    feats = np.random.default_rng(0).standard_normal(
        (20, 16)).astype(np.float32)
    pa, ja = _models(blob, tmp_path, mini_batch_size=32)
    got = pa.warmup(device="cpu")
    want = ja.warmup()
    assert got.compiled == len(got.entries) == 3
    _same_report(got, want)
    assert [e["sig"] for e in got.entries] == \
        [e["sig"] for e in want.entries]
    col = pa.graph.output_names[0]
    out_a = np.asarray(pa.transform(Table({"input": feats}), "cpu")[col])
    np.testing.assert_allclose(
        out_a, np.asarray(ja.transform(JaxTable({"input": feats}))[col]),
        rtol=1e-5, atol=1e-5)

    pb, _ = _models(blob, tmp_path, mini_batch_size=32)
    rep_b = pb.warmup(device="cpu")
    assert rep_b.loaded == 3 and rep_b.compiled == 0
    out_b = np.asarray(pb.transform(Table({"input": feats}), "cpu")[col])
    np.testing.assert_array_equal(out_a, out_b)
    assert pb._executor("cpu")._aot_hits == 1
    # changed model bytes -> different content hash -> cold again
    pc, jc = _models(zoo.mlp([16, 32], num_classes=4, seed=7), tmp_path,
                     mini_batch_size=32)
    got, want = pc.warmup(device="cpu"), jc.warmup()
    assert got.loaded == 0 and got.compiled == 3
    _same_report(got, want)
    for m in (pa, pb, pc):
        for ex in m._executor_cache.values():
            ex.close(wait=False)


def test_onnxmodel_warmup_example_feeds_override_dtype():
    """The uint8-pixel wire (input_norm) serves a different staged dtype
    than the graph declares — example_feeds pins the real signature."""
    from synapseml_tpu.data.table import Table as JaxTable
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import zoo

    pm, jm = _models(zoo.mlp([16, 32], num_classes=4, seed=0), None,
                     mini_batch_size=8,
                     input_norm={"input": {"mean": 127.5,
                                           "scale": 1 / 58.0}})
    feeds = {"input": np.zeros((1, 16), np.uint8)}
    got = pm.warmup(example_feeds=feeds, device="cpu")
    want = jm.warmup(example_feeds=feeds)
    assert got.compiled == 1 and not got.errors
    _same_report(got, want)
    assert got.entries[0]["sig"] == want.entries[0]["sig"] == \
        (((8, 16), "uint8"),)
    px = np.random.default_rng(3).integers(0, 256, (5, 16), dtype=np.uint8)
    out = pm.transform(Table({"input": px}), "cpu")
    ref = jm.transform(JaxTable({"input": px}))
    col = pm.graph.output_names[0]
    np.testing.assert_allclose(np.asarray(out[col]), np.asarray(ref[col]),
                               rtol=1e-5, atol=1e-5)
    assert pm._executor("cpu")._aot_hits == jm._executor()._aot_hits == 1
    for ex in pm._executor_cache.values():
        ex.close(wait=False)


def test_onnxmodel_warmup_refuses_dynamic_dims_as_the_reference():
    from synapseml_tpu_torch.onnx.builder import GraphBuilder

    g = GraphBuilder(name="dyn", opset=17)
    x = g.add_input("x", np.float32, ["N", "F"])
    g.add_output(g.add_node("Relu", [x]), np.float32, ["N", "F"])
    pm, jm = _models(g.to_bytes(), None, mini_batch_size=8)
    with pytest.raises(ValueError) as got:
        pm.warmup(device="cpu")
    with pytest.raises(ValueError) as want:
        jm.warmup()
    assert str(got.value) == str(want.value)
    rep = pm.warmup(example_feeds={"x": np.zeros((1, 5), np.float32)},
                    device="cpu")
    assert rep.compiled == 1 and rep.entries[0]["sig"] == \
        (((8, 5), "float32"),)
