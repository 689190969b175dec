"""The port's ONNX indexing and loss ops against the JAX package's
importer, on the CPU: ``Size``, ``EyeLike``, ``CastLike``,
``GatherElements``, ``GatherND``, ``ScatterND``, ``ScatterElements``,
``Scatter``, ``OneHot``, ``Hardmax``, ``TopK``, ``ReverseSequence``,
``NonZero``, ``Unique``, ``Compress``, ``NegativeLogLikelihoodLoss`` and
``SoftmaxCrossEntropyLoss``.

The one-node cases are ``tests/fixtures/index_op_cases.py``'s (the card
runs the same ones in ``chip_smoke.py`` and ``test_torch_cuda.py``): the
same graph bytes and seeded inputs through both importers, the port bound
on the CPU. Each edge the reference settles without refusing an index is
a case: a negative index wraps; ``GatherElements`` fills past the end
(NaN, the lowest signed value of the narrowed integer, the highest
unsigned one, True), ``GatherND`` clamps, the scatters drop the update;
``ScatterElements`` sets under ``min``/``max``; ``OneHot`` gives a row all
off for a negative index; ``TopK`` keeps the lower index first among ties
and orders floats by IEEE total order; the losses are NaN at
``ignore_index=-100``; ``NonZero``, ``Unique`` and ``Compress`` refuse a
device tensor.

Tolerance: outputs of gathers, scatters without a float sum, ``OneHot``,
``Hardmax`` and ``TopK`` equal the reference's (NaN where NaN is); the
losses within rtol=atol=1e-5; a float32 scatter-add over duplicate
indices within ``2 m eps32 (|data| + sum|updates|)`` (m updates, any
order of the sum); output dtypes equal (a 64-bit integer may stay 64-bit
where the reference narrows it); host outputs where the reference's are.

Last, the masked-LM head of ``tests/fixtures/mlm_head.py`` over the
bidirectional encoder at 2 layers and width 64: the port's encoder plus
head against the JAX package's, float outputs within rtol=atol=1e-5,
integer outputs equal.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import GraphBuilder as JaxBuilder
from synapseml_tpu.onnx import import_model as jax_import
from synapseml_tpu.onnx import zoo as jax_zoo
from synapseml_tpu_torch.onnx import GraphBuilder, import_model, importer, zoo
from torch_onnx_parity import assert_parity, run_both

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import index_op_cases as cases  # noqa: E402
import mlm_head  # noqa: E402

NAMES = ("Size", "EyeLike", "CastLike", "GatherElements", "GatherND",
         "ScatterND", "ScatterElements", "Scatter", "OneHot", "Hardmax",
         "TopK", "ReverseSequence", "NonZero", "Unique", "Compress",
         "NegativeLogLikelihoodLoss", "SoftmaxCrossEntropyLoss")


def _host(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _tol(case) -> dict:
    if case["exact"]:
        return {"rtol": 0.0, "atol": 0.0}
    if case["tol"] == "loss":
        return {"rtol": cases.LOSS_TOL, "atol": cases.LOSS_TOL}
    return {"rtol": 0.0, "atol": cases.tolerance(case)}


def _run_both(case):
    return run_both(cases.graph(case), cases.feeds(case), host=case["host"],
                    cast=case["cast"])


def test_every_name_is_registered_and_covered():
    assert set(NAMES) <= set(importer._REGISTRY)
    assert {c["op"] for c in cases.CASES} == set(NAMES)
    names = [c["name"] for c in cases.CASES]
    assert len(names) == len(set(names))
    assert set(cases.EDGE_CASES.values()) <= set(names)


@pytest.mark.parametrize("case", [c for c in cases.CASES if not c["raises"]],
                         ids=lambda c: c["name"])
def test_op_matches_the_reference(case):
    port, ref = _run_both(case)
    assert_parity(port, ref, **_tol(case))
    for p, r in zip(port, ref):
        assert _host(p) == _host(r)


@pytest.mark.parametrize("case", [c for c in cases.CASES if c["raises"]],
                         ids=lambda c: c["name"])
def test_host_only_op_refuses_a_device_tensor_as_the_reference_does(case):
    with pytest.raises(NotImplementedError) as port_err:
        _run_both(case)
    with pytest.raises(NotImplementedError) as ref_err:
        jax_import(cases.graph(case)).bind()(
            *[jnp.asarray(a) for a in cases.feeds(case)])
    assert str(port_err.value) == str(ref_err.value)


# -- the reference's own results where the spec says otherwise (ROADMAP
# Queue 3): each held here on its own case -----------------------------

def _port(case):
    return [v for v, _ in cases.run(case, "cpu")]


def test_gather_elements_fills_and_gather_nd_clamps_past_the_end():
    nan_rows = _port(cases.by_name("gather_elements_past_end_fills_nan"))[0]
    assert np.isnan(nan_rows[0, 2:4]).all() and nan_rows[0, 1] == 3
    ints = _port(cases.by_name("gather_elements_past_end_fills_int64"))[0]
    assert ints.dtype == np.int64 and ints[0, 2] == -2 ** 31
    assert _port(cases.by_name(
        "gather_elements_past_end_fills_uint8"))[0][0, 2] == 255
    clamped = _port(cases.by_name("gather_nd_past_end_clamps"))[0]
    np.testing.assert_array_equal(clamped, [9.0, 11.0, 0.0, 8.0])


def test_scatters_drop_past_the_end_and_scatter_elements_sets_min_max():
    case = cases.by_name("scatter_nd_past_end_dropped")
    data, _, upd = [a for _, a, _ in case["inputs"]]
    want = data.copy()
    want[0], want[2] = upd[1], upd[3]          # -5 wraps to 0; 5, -6, 9 drop
    np.testing.assert_array_equal(_port(case)[0], want)
    for name in ("scatter_elements_min_sets", "scatter_elements_max_sets"):
        case = cases.by_name(name)
        data, idx, upd = [a for _, a, _ in case["inputs"]]
        want = data.copy()
        want[idx[0], np.arange(3)] = upd[0]    # set, not min/max
        np.testing.assert_array_equal(_port(case)[0], want)


def test_one_hot_gives_a_negative_index_a_row_all_off():
    got = _port(cases.by_name("one_hot_negative_and_past_end"))[0]
    np.testing.assert_array_equal(got.sum(-1), [0, 1, 1, 0, 1, 0])


def test_topk_keeps_lower_index_first_and_ranks_nan_by_total_order():
    values, ids = _port(cases.by_name("topk_edges_largest"))
    #   x = [1, nan, 3, 3, -inf, -nan, 0, -0, inf, 3, -1, -0]
    np.testing.assert_array_equal(ids[0], [1, 8, 2, 3, 9, 0, 6, 7, 11, 10,
                                           4, 5])
    _, small = _port(cases.by_name("topk_edges_smallest"))
    np.testing.assert_array_equal(small[0], [5, 4, 10, 7, 11, 6, 0, 2, 3, 9,
                                             8, 1])
    assert np.signbit(values[0, -1]) and np.isnan(values[0, -1])


def test_losses_are_nan_at_ignore_index_minus_100():
    rows = _port(cases.by_name("nll_ignore_minus100_none"))[0]
    assert np.isnan(rows[2]) and np.isfinite(np.delete(rows, 2)).all()
    loss, _ = _port(cases.by_name("sce_ignore_minus100_mean"))
    assert np.isnan(loss)


# -- the masked-LM pass at a small width --------------------------------

def test_masked_lm_head_matches_the_reference_at_small_width():
    cfg = mlm_head.SMALL_ENCODER
    blob = zoo.transformer_encoder(**cfg)
    assert blob == jax_zoo.transformer_encoder(**cfg)
    enc, jenc = import_model(blob), jax_import(blob)
    tok_emb = enc.params["tok_emb"]
    head_blob = mlm_head.head_graph(GraphBuilder, tok_emb, cfg["seq_len"],
                                    mlm_head.SMALL_MASKED)
    assert head_blob == mlm_head.head_graph(
        JaxBuilder, tok_emb, cfg["seq_len"], mlm_head.SMALL_MASKED)
    b = mlm_head.batch(4, cfg["seq_len"], cfg["vocab"], mlm_head.SMALL_MASKED)

    hidden = enc.bind(device="cpu")(torch.from_numpy(b["tokens"]))[0]
    port = import_model(head_blob).bind(device="cpu")(
        hidden, *[torch.from_numpy(a) for a in mlm_head.head_inputs(b)])
    jhidden = jenc.bind()(jnp.asarray(b["tokens"]))[0]
    ref = jax_import(head_blob).bind()(
        jhidden, *[jnp.asarray(a) for a in mlm_head.head_inputs(b)])
    assert_parity(port, ref, rtol=1e-5, atol=1e-5)
    filled = port[4].numpy()
    rows = np.arange(4)[:, None]
    np.testing.assert_array_equal(filled[rows, b["positions"]],
                                  port[1][..., 0].numpy())
    keep = np.ones(filled.shape, bool)
    keep[rows, b["positions"]] = False
    np.testing.assert_array_equal(filled[keep], b["tokens"][keep])
