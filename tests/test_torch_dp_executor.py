"""The port's data-parallel executor (``devices=``) against the JAX
package's, on the CPU.

Each case of ``tests/test_executor_multidevice.py`` that covers the shard
and round-robin layouts runs here on both executors: the JAX
``BatchedExecutor`` over the 8 virtual CPU devices of ``tests/conftest.py``
(``devices=n`` takes the first n) and the port's over ``["cpu"] * n``, a
repeated device list whose entries are slots (the port's departure: the
reference's mesh cannot repeat a device, and its dispatch fails on one),
with the same seeded numpy inputs. ``x * 2 + 1`` is held bitwise and
``tanh(x @ w)`` within rtol = atol = 1e-6 (as
``tests/test_torch_compile_cache.py`` states: XLA's tanh and product round
apart from torch's by up to ~2e-7 near zero). Also ported:
``test_telemetry.py``'s per-device dispatch counters, and the store's
topology contract of ``test_compile_cache.py``
(``test_invalidation_changed_device_count_and_mesh``,
``test_multidevice_warmup_restart_bit_identical``).

Two of the reference's tests fail on this host
(``test_sharded_bit_identical_to_single_device``: its sharded program
rounds ``tanh`` apart from its single-device one by an ulp;
``test_invalidation_changed_device_count_and_mesh``), so the port's
versions assert the contract — a sharded bucket equal to the one-slot
executor within the tolerances above, a 4-slot and an 8-slot store under
one ``cache_key`` missing each other — not the JAX outcome. Donation has
no PyTorch counterpart, so the reference's two donation tests have none.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.runtime import executor as jax_executor
from synapseml_tpu_torch.runtime import telemetry as port_tm
from synapseml_tpu_torch.runtime.executor import (BatchedExecutor,
                                                  resolve_devices)

TANH_RTOL = TANH_ATOL = 1e-6
ONNX_TOL = 1e-5   # tests/test_torch_onnx_model.py's float32 bound
FEAT_TOL = 1e-4   # tests/test_torch_image.py's ImageFeaturizer bound
ROW = ((6,), np.float32)
HARD = 60.0


def _w():
    return np.random.default_rng(0).standard_normal((6, 4)).astype(
        np.float32)


def _jax_fn(p, x):
    return jnp.tanh(x @ p), x * 2.0 + 1.0


def _port_fn(p, x):
    return torch.tanh(x @ p), x * 2.0 + 1.0


def _x(n, seed=None):
    return np.random.default_rng(n if seed is None else seed) \
        .standard_normal((n, 6)).astype(np.float32)


def _agree(got, want):
    """(tanh(x @ w), x * 2 + 1) pairs: the affine leaf bitwise, tanh
    within the stated bound."""
    assert len(got) == len(want) == 2
    (g_tanh, g_lin), (w_tanh, w_lin) = got, want
    np.testing.assert_array_equal(np.asarray(g_lin), np.asarray(w_lin))
    np.testing.assert_allclose(np.asarray(g_tanh), np.asarray(w_tanh),
                               rtol=TANH_RTOL, atol=TANH_ATOL)


def _jax(ndev=None, **kw):
    devs = None if ndev is None else jax.local_devices()[:ndev]
    return jax_executor.BatchedExecutor(_jax_fn, bound_args=(_w(),),
                                        devices=devs, **kw)


def _port(ndev=None, **kw):
    spec = {"device": "cpu"} if ndev is None else {"devices": ["cpu"] * ndev}
    return BatchedExecutor(_port_fn, bound_args=(_w(),), **spec, **kw)


def _close(*executors):
    for ex in executors:
        ex.close(wait=False)


def test_resolve_devices_specs(monkeypatch):
    jr = jax_executor.resolve_devices
    assert jr(None) is None and resolve_devices(None) is None
    assert resolve_devices(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    assert resolve_devices((torch.device("cpu"),)) == (torch.device("cpu"),)
    for bad in ("everything", 0, [], True, False,
                len(jax.local_devices()) + 1):
        with pytest.raises(ValueError):
            jr(bad)
        with pytest.raises(ValueError):
            resolve_devices(bad)
    # without CUDA: "all" and CUDA entries raise as every entry point
    # does, an int finds no CUDA device — never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_devices("all")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_devices(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="devices=1 but 0 CUDA devices"):
        resolve_devices(1)
    with pytest.raises(ValueError, match="devices=2 but 0 CUDA devices"):
        BatchedExecutor(_port_fn, devices=2)


def test_repeated_slots_are_the_ports_departure():
    """A JAX mesh cannot run one device twice; the port's slots can, each
    with its own counter and warm programs, sharing the device's one
    replica of the bound args."""
    d = jax.local_devices()[0]
    ref = jax_executor.BatchedExecutor(lambda x: (x * 2.0,), devices=[d, d])
    with pytest.raises(ValueError):
        ref(np.ones((8, 3), np.float32))
    ex = _port(2, max_bucket=8)
    try:
        a, b = ex._slots
        assert a is not b and a.index == 0 and b.index == 1
        assert ex._bound_for_device(a.device) is \
            ex._bound_for_device(b.device)
        ex.warmup([ROW])
        sig = (((8, 6), "float32"),)
        warm = [ex._aot[(sig, "shard", i)] for i in (0, 1)]
        assert [w.slot for w in warm] == [a, b]
        assert ex._m_disp_rr[0] is not ex._m_disp_rr[1]
        _agree(ex(_x(5)), _port_fn(torch.from_numpy(_w()),
                                   torch.from_numpy(_x(5))))
    finally:
        _close(ex, ref)


def test_sharded_bit_identical_to_single_device():
    """Buckets the slot count divides shard: the port's outputs agree with
    its one-slot executor and with the JAX executor over 8 devices within
    the stated bounds — ragged tails (37 -> 32 + an 8-bucket tail, 100 ->
    3 x 32 + 8) and the n=1 and n=0 batches included."""
    single, multi = _port(max_bucket=32), _port(8, max_bucket=32)
    ref = _jax(8, max_bucket=32)
    try:
        assert multi.n_devices == 8 and multi._layout(8) == "shard"
        for n in (0, 1, 3, 8, 32, 37, 100):
            got = multi(_x(n))
            _agree(got, single(_x(n)))
            _agree(got, ref(_x(n)))
    finally:
        _close(single, multi, ref)


def test_stream_order_preserved_multidevice():
    sizes = [3, 17, 1, 32, 9, 4, 27, 2]
    items = [np.full((s, 6), float(i), np.float32)
             for i, s in enumerate(sizes)]
    port, ref = _port(8, max_bucket=32), _jax(8, max_bucket=32)
    try:
        got = list(port.stream((a,) for a in items))
        want = list(ref.stream((a,) for a in items))
        assert len(got) == len(want) == len(items)
        for x, g, w in zip(items, got, want):
            _agree(g, w)
            np.testing.assert_array_equal(g[1], x * 2.0 + 1.0)
    finally:
        _close(port, ref)


def test_single_entry_devices_degenerates_to_pinned_device():
    """devices=[d] takes the plain one-device path pinned to d."""
    ex = BatchedExecutor(_port_fn, devices=["cpu"], bound_args=(_w(),))
    ref = _port()
    jref = jax_executor.BatchedExecutor(
        _jax_fn, devices=jax.local_devices()[:1], bound_args=(_w(),))
    try:
        assert ex.devices is None and ex.n_devices == 1
        assert ex._device == torch.device("cpu") and ex.pipeline_depth == 2
        assert ex._layout(8) == "single" and ex._mesh_shape() == (1,)
        assert jref.devices is None and jref.n_devices == 1
        x = _x(5, seed=1)
        got = ex(x)
        for g, r in zip(got, ref(x)):
            np.testing.assert_array_equal(g, r)
        _agree(got, jref(x))
    finally:
        _close(ex, ref, jref)


def test_device_and_devices_are_mutually_exclusive():
    with pytest.raises(ValueError, match="either device= or devices="):
        BatchedExecutor(_port_fn, device="cpu", devices=["cpu", "cpu"],
                        bound_args=(_w(),))
    with pytest.raises(ValueError):
        jax_executor.BatchedExecutor(_jax_fn,
                                     device=jax.local_devices()[0],
                                     devices="all", bound_args=(_w(),))


@pytest.mark.parametrize("ndev", [3, 5, 7])
def test_round_robin_fallback_odd_topologies(ndev):
    """Slot counts that do not divide the pow2 buckets run every bucket
    whole on the next slot, bitwise the one-slot executor (the same
    program on the same rows) and within the bounds of the JAX one."""
    port, ref, single = (_port(ndev, max_bucket=32),
                         _jax(ndev, max_bucket=32), _port(max_bucket=32))
    try:
        assert port._layout(8) == ref._layout(8) == "rr"
        assert port._layout(32) == ref._layout(32) == "rr"
        assert port.pipeline_depth == ref.pipeline_depth == ndev + 1
        for n in (1, 3, 37, 100):
            got = port(_x(n))
            for g, s in zip(got, single(_x(n))):
                np.testing.assert_array_equal(g, s)
            _agree(got, ref(_x(n)))
        # successive buckets actually rotated over the slots
        assert port._rr_next == ref._rr_next > ndev
    finally:
        _close(port, ref, single)


def test_shard_vs_rr_layout_selection():
    for ndev in (8, 4, 5, 2, 3):
        port, ref = _port(ndev), _jax(ndev)
        try:
            for bucket in (8, 16, 64, 128):
                assert port._layout(bucket) == ref._layout(bucket), \
                    (ndev, bucket)
            assert port._mesh_shape() == ref._mesh_shape() == (ndev,)
        finally:
            _close(port, ref)
    assert _port(8)._layout(64) == "shard" and _port(5)._layout(8) == "rr"


def test_concurrent_submit_multidevice():
    """The slot fan-out sits UNDER the shared submit/drain pipeline:
    concurrent callers each get exactly their own answer."""
    port, ref = _port(8, max_bucket=16), _jax(8, max_bucket=16)
    results = {}
    lock = threading.Lock()

    def worker(t):
        mine = []
        for k in range(4):
            x = _x(3 + (t + k) % 9, seed=100 * t + k)
            mine.append((x, port.submit(x).result(timeout=HARD),
                         ref.submit(x).result(timeout=HARD)))
        with lock:
            results[t] = mine

    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HARD)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 6
        for mine in results.values():
            for x, got, want in mine:
                np.testing.assert_array_equal(got[1], x * 2.0 + 1.0)
                _agree(got, want)
    finally:
        _close(port, ref)


def _dispatch_series(tm):
    return {k: v for k, v in tm.snapshot()["counters"].items()
            if k.startswith("synapseml_executor_dispatch_total")}


def _deltas(tm, before):
    after = _dispatch_series(tm)
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(after) | set(before)}


def test_per_device_dispatch_counters_sum_to_total_batches():
    """rr (3 slots, bucket 8): each batch lands whole on one slot, and the
    per-slot series ("cpu#<slot>": slots on one device stay apart) sum to
    the batches; a sharded batch counts once under the mesh label."""
    fn = lambda x: (x * 2.0,)  # noqa: E731
    before = _dispatch_series(port_tm)
    ex_rr = BatchedExecutor(fn, devices=["cpu"] * 3, min_bucket=8,
                            max_bucket=8)
    ref_rr = jax_executor.BatchedExecutor(
        lambda x: (x * 2.0,), devices=3, min_bucket=8, max_bucket=8)
    try:
        for i in range(9):
            x = np.full((5, 4), float(i), np.float32)
            (out,), (want,) = ex_rr(x), ref_rr(x)
            np.testing.assert_array_equal(out, np.full((5, 4), 2.0 * i))
            np.testing.assert_array_equal(out, np.asarray(want))
    finally:
        _close(ex_rr, ref_rr)
    deltas = _deltas(port_tm, before)
    rr_keys = [k for k in deltas if deltas[k]]
    assert sorted(rr_keys) == [
        f'synapseml_executor_dispatch_total{{device="cpu#{i}"}}'
        for i in range(3)]
    assert sorted(deltas[k] for k in rr_keys) == [3, 3, 3]

    before = _dispatch_series(port_tm)
    ex_dp = BatchedExecutor(fn, devices=["cpu"] * 8, min_bucket=8,
                            max_bucket=8)
    try:
        for i in range(4):
            ex_dp(np.full((8, 4), float(i), np.float32))
    finally:
        _close(ex_dp)
    deltas = _deltas(port_tm, before)
    assert sum(deltas.values()) == 4
    assert deltas['synapseml_executor_dispatch_total{device="dp8"}'] == 4


@pytest.mark.parametrize("ndev, layouts", [
    (2, ["shard"] * 3), (3, [f"rr{i}" for i in range(3)] * 3)])
def test_warmup_covers_every_slot_and_serves_without_recompiles(
        ndev, layouts):
    """The warmup report has the reference's entries a bucket (one
    ``shard``, or one ``rr{i}`` a slot); the table holds one warm program
    a slot and bucket; traffic afterwards replays them, one AOT hit a
    dispatched bucket, and never runs a cold signature."""
    port, ref = _port(ndev, max_bucket=32), _jax(ndev, max_bucket=32)
    try:
        rep, jrep = port.warmup([ROW]), ref.warmup([ROW])
        assert [e["layout"] for e in rep.entries] == \
            [e["layout"] for e in jrep.entries] == layouts
        assert [e["bucket"] for e in rep.entries] == \
            [e["bucket"] for e in jrep.entries]
        assert [e["status"] for e in rep.entries] == ["compiled"] * len(
            layouts) and not rep.errors
        assert len(port._aot) == ndev * 3
        recompiles = port_tm.counter("executor_recompiles_total",
                                     reason="shape_drift").value
        hits = port._aot_hits
        for n in (1, 9, 32, 37):
            _agree(port(_x(n)), ref(_x(n)))
        assert port._aot_hits - hits == 1 + 1 + 1 + 2
        assert port_tm.counter("executor_recompiles_total",
                               reason="shape_drift").value == recompiles
        assert port.warmup([ROW]).entries[0]["status"] == "warm"
    finally:
        _close(port, ref)


def test_sharded_device_outputs_are_joined_in_row_order():
    """A ``device_outputs`` leaf of a sharded bucket comes back as one
    tensor of the bucket's rows in order (the decode scheduler's present
    buffers), with no copy between devices."""
    moved = port_tm.counter("executor_cross_device_copies_total")
    before = moved.value
    ex = BatchedExecutor(lambda x: (x.sum(1, keepdim=True), x * 3.0),
                         devices=["cpu"] * 2, static_batch=8,
                         device_outputs=[1])
    try:
        x = np.arange(15, dtype=np.float32).reshape(5, 3)
        total, tripled = ex(x)
        assert isinstance(total, np.ndarray)
        assert isinstance(tripled, torch.Tensor)
        np.testing.assert_array_equal(total, x.sum(1, keepdims=True))
        np.testing.assert_array_equal(tripled.numpy(), x * 3.0)
        with pytest.raises(ValueError, match="batch axis"):
            BatchedExecutor(lambda x: (x[:1],), devices=["cpu"] * 2,
                            static_batch=8)(x)
    finally:
        _close(ex)
    assert moved.value == before


def test_invalidation_changed_device_count_and_mesh(tmp_path):
    """The same cache_key on another topology (4 slots against 8, and
    slots against one device) misses: the slot count is part of the
    store key. Outputs stay within the bounds of the JAX one-device
    executor."""
    kw = dict(max_bucket=32, cache_key="m", cache_dir=str(tmp_path))
    ref = _jax(max_bucket=32)
    ex8, ex4, ex1 = _port(8, **kw), _port(4, **kw), _port(**kw)
    try:
        rep8 = ex8.warmup([ROW])
        assert rep8.compiled == len(rep8.entries) > 0
        assert ex8.warmup([ROW]).entries[0]["status"] == "warm"
        rep4 = ex4.warmup([ROW])
        assert rep4.loaded == 0 and rep4.compiled == len(rep4.entries)
        rep1 = ex1.warmup([ROW])
        assert rep1.loaded == 0 and rep1.compiled == len(rep1.entries)
        for ex in (ex8, ex4, ex1):
            _agree(ex(_x(37)), ref(_x(37)))
    finally:
        _close(ex8, ex4, ex1, ref)


def test_multidevice_warmup_restart_bit_identical(tmp_path):
    """The sharded layout round-trips through the store: a restarted
    8-slot executor reports every entry loaded and reproduces the
    one-slot outputs (bitwise the affine leaf, tanh within its bound)."""
    kw = dict(max_bucket=32, cache_key="mesh-model",
              cache_dir=str(tmp_path))
    exA, exB, single = _port(8, **kw), _port(8, **kw), _port(max_bucket=32)
    ref = _jax(max_bucket=32)
    try:
        repA = exA.warmup([ROW])
        assert repA.compiled == len(repA.entries)
        repB = exB.warmup([ROW])
        assert repB.loaded == len(repB.entries) and repB.compiled == 0
        for n in (1, 8, 37):
            got = exB(_x(n, seed=n))
            _agree(got, single(_x(n, seed=n)))
            _agree(got, ref(_x(n, seed=n)))
    finally:
        _close(exA, exB, single, ref)


def test_onnxmodel_devices_param_bit_identical():
    from synapseml_tpu.data.table import Table as JaxTable
    from synapseml_tpu.onnx import ONNXModel as JaxONNXModel
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, zoo

    blob = zoo.mlp([16, 32], num_classes=4, seed=0)
    feats = np.random.default_rng(0).standard_normal(
        (37, 16)).astype(np.float32)
    base = ONNXModel(model_bytes=blob).transform(Table({"input": feats}),
                                                 "cpu")
    ref = JaxONNXModel(model_bytes=blob)
    ref.set(devices="all")
    want = ref.transform(JaxTable({"input": feats}))
    for ndev in (8, 3):
        multi_model = ONNXModel(model_bytes=blob)
        multi_model.set(devices=["cpu"] * ndev)
        assert multi_model._executor("cpu").n_devices == ndev
        multi = multi_model.transform(Table({"input": feats}), "cpu")
        for col in base.columns:
            np.testing.assert_array_equal(np.asarray(base[col]),
                                          np.asarray(multi[col]))
            np.testing.assert_allclose(np.asarray(multi[col]),
                                       np.asarray(want[col]),
                                       rtol=ONNX_TOL, atol=ONNX_TOL)
        multi_model._executor("cpu").close()


@pytest.mark.parametrize("ndev", [2, 3, 8])
def test_image_featurizer_devices_param_bit_identical(ndev):
    """Bitwise the one-slot featurizer where a slot's rows run the same
    convolutions (2 slots of 4 images, or whole buckets round robin);
    a slot of one image (8 slots) takes another CPU convolution, so the
    features are held within the featurizer's bound there, and to the JAX
    featurizer over 8 devices everywhere."""
    from synapseml_tpu.data.table import Table as JaxTable
    from synapseml_tpu.image.featurizer import ImageFeaturizer as JaxFeat
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.image.featurizer import ImageFeaturizer
    from synapseml_tpu_torch.onnx import zoo

    rng = np.random.default_rng(0)
    imgs = np.empty(5, dtype=object)
    imgs[:] = [rng.integers(0, 255, (32, 32, 3)).astype(np.float32)
               for _ in range(5)]
    kw = dict(model_bytes=zoo.tiny_resnet(image_size=32),
              cut_output_layers=1, image_size=32,
              input_col="image", output_col="feats")
    base = np.stack(list(ImageFeaturizer(**kw).transform(
        Table({"image": imgs}), "cpu")["feats"]))
    multi = ImageFeaturizer(devices=["cpu"] * ndev, **kw)
    got = np.stack(list(multi.transform(Table({"image": imgs}),
                                        "cpu")["feats"]))
    assert multi._pieces("cpu").n_devices == ndev
    want = np.stack(list(JaxFeat(devices="all", **kw).transform(
        JaxTable({"image": imgs}))["feats"]))
    if ndev < 8:
        np.testing.assert_array_equal(got, base)
    np.testing.assert_allclose(got, base, rtol=FEAT_TOL, atol=FEAT_TOL)
    np.testing.assert_allclose(got, want, rtol=FEAT_TOL, atol=FEAT_TOL)
