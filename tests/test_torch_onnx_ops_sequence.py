"""The port's ONNX optional, sequence and string ops against the JAX
package's importer, on the CPU: ``Optional``, ``OptionalHasElement``,
``OptionalGetElement``, ``SequenceEmpty``, ``SequenceConstruct``,
``SequenceLength``, ``SequenceAt``, ``SequenceInsert``, ``SequenceErase``,
``ConcatFromSequence``, ``SplitToSequence``, ``SequenceMap``,
``StringConcat``, ``StringSplit``, ``StringNormalizer``, ``RegexFullMatch``
and ``TfIdfVectorizer``.

The cases are ``tests/fixtures/sequence_string_op_cases.py``'s (the card
runs the same ones in ``chip_smoke.py`` and ``test_torch_cuda.py``): the
same graph bytes and seeded inputs through both importers, the port bound
on the CPU, the reference through its eager bound forward. Tolerance:
strings, bools, integers and counts equal; float32 bitwise, or within
rtol = atol = 1e-5 where a case sums products; host outputs numpy exactly
where the reference's are, sequences lists of the same length; every
refusal of the reference raises the same exception type in the port.

Then the places where the port copies the reference and not the ONNX
spec (ROADMAP Queue 3), each held on its own; the bodies lowered at
import; the string ``LabelEncoder``'s map built once; and the 20
Newsgroups-width text classifier (``tests/fixtures/newsgroups_classifier.py``)
at a small width end to end against JAX and at full width against the
JAX fixture.
"""
import collections
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import GraphBuilder as JaxBuilder
from synapseml_tpu.onnx import import_model as jax_import
from synapseml_tpu_torch.onnx import GraphBuilder, import_model, importer

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import newsgroups_classifier as news  # noqa: E402
import sequence_string_op_cases as cases  # noqa: E402

NAMES = ("Optional", "OptionalHasElement", "OptionalGetElement",
         "SequenceEmpty", "SequenceConstruct", "SequenceLength",
         "SequenceAt", "SequenceInsert", "SequenceErase",
         "ConcatFromSequence", "SplitToSequence", "SequenceMap",
         "StringConcat", "StringSplit", "StringNormalizer", "RegexFullMatch",
         "TfIdfVectorizer")


def _port(case):
    return cases.run(case, import_model, GraphBuilder, "cpu")


def _reference(case):
    """The JAX importer's outputs of the case, as :func:`cases.run` gives
    the port's."""
    fn = jax_import(cases.graph(case, JaxBuilder)).bind()
    return cases.leaves(fn(*[a if a.dtype == object else jnp.asarray(a)
                             for a in cases.feeds(case)]))


def _ops_of(case):
    ops = set()
    todo = list(case["nodes"])
    while todo:
        op, _, _, attrs = todo.pop()
        ops.add(op)
        if "body" in attrs:
            todo += attrs["body"]["nodes"]
    return ops


def test_every_name_is_registered_and_covered():
    assert set(NAMES) <= set(importer._REGISTRY)
    assert {c["op"] for c in cases.CASES} == set(NAMES)
    reached = set().union(*map(_ops_of, cases.CASES))
    assert set(NAMES) <= reached
    names = [c["name"] for c in cases.CASES]
    assert len(names) == len(set(names)) and len(names) >= 80


def test_both_graph_builders_give_the_same_bytes():
    for case in cases.CASES:
        assert cases.graph(case, GraphBuilder) == \
            cases.graph(case, JaxBuilder), case["name"]


@pytest.mark.parametrize("case", [c for c in cases.CASES if not c["raises"]],
                         ids=lambda c: c["name"])
def test_op_matches_the_reference(case):
    got = cases.agree(case, _port(case), _reference(case))
    assert got["ok"], (got, _port(case), _reference(case))


@pytest.mark.parametrize("case", [c for c in cases.CASES if c["raises"]],
                         ids=lambda c: c["name"])
def test_refusal_is_the_references(case):
    with pytest.raises(case["raises"]) as port_err:
        _port(case)
    with pytest.raises(Exception) as ref_err:
        _reference(case)
    assert type(port_err.value) is type(ref_err.value)


# -- sequences are lists, whatever torch returns --------------------------

@pytest.mark.parametrize("parts", [2, 3])
def test_split_to_sequence_into_parts_is_one_output(parts):
    """``torch.tensor_split`` returns a tuple, which ``_run_nodes`` would
    read as several outputs: the op returns a list, so a split into 2 or
    3 parts comes out as one sequence output."""
    case = cases.by_name(("split_to_sequence_into_two_is_one_output",
                          "split_to_sequence_into_three_is_one_output")[
                              parts - 2])
    out = import_model(cases.graph(case, GraphBuilder)).bind(device="cpu")(
        torch.from_numpy(cases.feeds(case)[0]))
    assert len(out) == 1 and isinstance(out[0], list)
    assert len(out[0]) == parts
    np.testing.assert_array_equal(torch.cat(out[0]).numpy(),
                                  cases.feeds(case)[0])


def test_sequence_map_with_several_outputs_gives_one_list_each():
    case = cases.by_name("sequence_map_two_outputs")
    fn = import_model(cases.graph(case, GraphBuilder)).bind(device="cpu")
    neg, top = fn(torch.from_numpy(cases.feeds(case)[0]))
    assert isinstance(neg, list) and len(neg) == 2
    assert top.shape == (2,)


# -- the reference's departures from the spec (ROADMAP Queue 3) ------------

def test_positions_must_be_host_values():
    """A position or split given as a device tensor raises ``ValueError``
    (the spec allows any tensor): the sequence's length and each position
    shape the program, in the reference's static form."""
    for name in ("sequence_at_device_position_raises",
                 "sequence_insert_device_position_raises",
                 "split_to_sequence_device_split_raises"):
        with pytest.raises(ValueError, match="statically known"):
            _port(cases.by_name(name))


def test_sequence_empty_ignores_dtype():
    case = cases.by_name("sequence_empty_dtype_ignored")
    (_, y, host), = _port(case)
    assert y.dtype == np.float32 and not host


def test_optional_ignores_its_type_attribute():
    """``Optional`` reads no ``type``: an empty optional is None whatever
    type the node names (its one input is the whole of it)."""
    ctx = importer.OpContext({"type": "tensor(float)"}, 21, "o", "Optional",
                             1)
    assert importer._REGISTRY["Optional"](ctx) is None
    x = torch.ones(2)
    assert importer._REGISTRY["Optional"](ctx, x) is x


def test_string_normalizer_ignores_locale():
    (_, y, _), = _port(cases.by_name("string_normalizer_locale_ignored"))
    assert y.tolist() == ["istanbul", "iğdır", "strasse"]


def test_regex_full_match_takes_python_syntax():
    """A lookahead is Python ``re`` syntax that RE2 refuses."""
    (_, y, _), = _port(cases.by_name("regex_full_match_python_lookahead"))
    assert y.tolist() == [True, False, True]


def test_tfidf_refuses_a_string_pool():
    with pytest.raises(NotImplementedError, match="pool_int64s"):
        _port(cases.by_name("tfidf_pool_strings_raises"))


def test_tfidf_skip_grams_take_equal_strides():
    """onnxruntime's reading of ``max_skip_count``: an n-gram's items at
    one stride ``s + 1``, not every combination of gaps. Row [5, 0, 6, 0,
    0, 7] holds (5, 6, 7) at gaps 2 and 3, which no stride reads, and
    (5, 6, 0) at stride 2, which is counted."""
    g = GraphBuilder(opset=21)
    g.add_input("x", np.int64, [6])
    g.add_node("TfIdfVectorizer", ["x"], outputs=["y"], mode="TF",
               min_gram_length=3, max_gram_length=3, max_skip_count=3,
               ngram_counts=[0, 0, 0], ngram_indexes=[0, 1],
               pool_int64s=[5, 6, 7, 5, 6, 0])
    g.add_output("y", np.float32, None)
    x = np.asarray([5, 0, 6, 0, 0, 7], np.int64)
    got = import_model(g.to_bytes()).bind(device="cpu")(
        torch.from_numpy(x))[0].numpy()
    np.testing.assert_array_equal(got, [0.0, 1.0])


def test_tfidf_pieces_give_the_same_bits(monkeypatch):
    """The port cuts each ``[rows, windows, grams]`` comparison into
    pieces of ``_TFIDF_PIECE`` elements; counts are integers held in
    float32, so any piece size gives the same bits."""
    case = cases.by_name("tfidf_large_chunked_tfidf")
    whole = _port(case)
    monkeypatch.setattr(importer, "_TFIDF_PIECE", 4_099)
    pieces = _port(case)
    assert cases.agree(case, pieces, whole)["ok"]


def test_tfidf_bound_forward_copies_only_the_token_ids(monkeypatch):
    """The grams, their columns and the weights go to the device on the
    node's first run: a later run makes one tensor from host memory, the
    token ids."""
    case = cases.by_name("tfidf_large_chunked_idf")
    fn = import_model(cases.graph(case, GraphBuilder)).bind(device="cpu")
    ids = cases.feeds(case)[0]
    first = fn(ids)[0]
    made = []
    real = importer._tensor

    def counting(x, dev=None):
        if not isinstance(x, torch.Tensor):
            made.append(np.shape(x))
        return real(x, dev)

    monkeypatch.setattr(importer, "_tensor", counting)
    assert torch.equal(fn(ids)[0], first)
    assert made == [ids.shape]


# -- import and bind of SequenceMap bodies ---------------------------------

def _map_graph(builder, body_op):
    body = builder(name="body", opset=21, name_prefix="b_")
    body.add_input("e", None)
    body.add_node(body_op, ["e"], outputs=["b_out"])
    body.add_output("b_out", np.float32, None)
    g = builder(opset=21)
    g.add_input("x", np.float32, [4, 3])
    g.add_node("SplitToSequence", ["x"], outputs=["s"])
    g.add_node("SequenceMap", ["s"], outputs=["m"], body=body.build().graph)
    g.add_output("m", np.float32, None)
    return g.to_bytes()


def test_an_unsupported_op_in_a_sequence_map_body_fails_at_import():
    for imp, builder in ((import_model, GraphBuilder),
                         (jax_import, JaxBuilder)):
        with pytest.raises(NotImplementedError, match="NoSuchOp"):
            imp(_map_graph(builder, "NoSuchOp"))


def test_bind_binds_the_sequence_map_body():
    """``bind`` gives the body its own bound copy (``_Subgraph.bound``),
    whose float initializers are on the bind's device."""
    case = cases.by_name("sequence_map_body_initializer_matmul_relu")
    graph = import_model(cases.graph(case, GraphBuilder))
    node = next(n for n in graph._nodes if n[1].op_type == "SequenceMap")
    bound = importer._bound_node(node, torch.device("cpu"))
    body = bound[1].attrs["__lowered_body__"]
    assert body is not node[1].attrs["__lowered_body__"]
    assert isinstance(body.inits["b_w"], torch.Tensor)
    assert isinstance(node[1].attrs["__lowered_body__"].inits["b_w"],
                      np.ndarray)


def test_a_value_the_body_captures_lives_until_the_map():
    case = cases.by_name("sequence_map_body_captures_an_outer_name")
    graph = import_model(cases.graph(case, GraphBuilder))
    drops = importer._last_uses(graph._nodes, graph.output_names)
    at = [i for i, n in enumerate(graph._nodes)
          if n[1].op_type == "SequenceMap"][0]
    assert "scale" in drops[at]
    assert cases.agree(case, _port(case), _reference(case))["ok"]


def test_a_string_op_refuses_a_device_tensor():
    for name in ("string_split_device_tensor_raises",
                 "string_concat_device_tensor_raises",
                 "string_normalizer_device_tensor_raises",
                 "regex_full_match_device_tensor_raises"):
        with pytest.raises(NotImplementedError, match="host"):
            _port(cases.by_name(name))


# -- the string LabelEncoder's map -----------------------------------------

def test_string_label_encoder_builds_its_map_once():
    g = GraphBuilder(opset=21)
    g.add_input("w", None)
    g.add_node("LabelEncoder", ["w"], outputs=["y"], domain="ai.onnx.ml",
               keys_strings=["a", "bb", "c"], values_int64s=[4, 5, 6],
               default_int64=-1)
    g.add_output("y", np.int64, None)
    graph = import_model(g.to_bytes())
    fn = graph.bind(device="cpu")
    words = np.asarray(["bb", "zz", "a", "c"], object)
    first = fn(words)[0]
    np.testing.assert_array_equal(fn(words)[0], first)
    impl, ctx, _, _ = graph._nodes[0]
    impl(ctx, words)
    lut = ctx.attrs["__string_map__"]
    np.testing.assert_array_equal(impl(ctx, words), first)
    assert ctx.attrs["__string_map__"] is lut
    np.testing.assert_array_equal(first, [5, -1, 4, 6])
    jg = jax_import(g.to_bytes())
    np.testing.assert_array_equal(jg.apply(jg.params, words)[0], first)


# -- the 20 Newsgroups-width classifier ------------------------------------

def _small_model():
    return news.classifier_graph(GraphBuilder, news.SMALL)


def test_both_builders_give_the_same_classifier_bytes():
    assert _small_model() == news.classifier_graph(JaxBuilder, news.SMALL)


def test_documents_tokenize_as_count_vectorizer():
    """On these whitespace-separated documents the graph's tokenizer is
    ``CountVectorizer``'s defaults: lowercase, ``(?u)\\b\\w\\w+\\b``,
    unigram counts over the vocabulary."""
    cfg = news.SMALL
    vocab = news.vocabulary(cfg["vocab"])
    index = {w: i for i, w in enumerate(vocab)}
    docs = news.documents(cfg, 16)
    fn = import_model(_small_model()).truncated(2).bind(device="cpu")
    counts = news.counts_of(fn, docs)
    want = np.zeros_like(counts)
    for d, doc in enumerate(docs):
        for tok, k in collections.Counter(
                re.findall(r"(?u)\b\w\w+\b", doc.lower())).items():
            if tok in index:
                want[d, index[tok]] = k
    np.testing.assert_array_equal(counts, want)
    assert want.sum() > 0


def test_small_classifier_matches_the_reference():
    blob = _small_model()
    docs = news.documents(news.SMALL, 16)
    jg = jax_import(blob)
    ref = [np.asarray(v) for v in jg.apply(jg.params, docs)]
    got = [t.numpy() for t in import_model(blob).bind(device="cpu")(docs)]
    labels, scores = got
    np.testing.assert_array_equal(labels, ref[0])
    np.testing.assert_allclose(scores, ref[1], rtol=1e-5, atol=1e-5)
    jt = jg.truncated(2)
    ref_counts = news.counts_of(lambda d: jt.apply(jt.params, d), docs)
    counts = news.counts_of(
        import_model(blob).truncated(2).bind(device="cpu"), docs)
    np.testing.assert_array_equal(counts.view(np.uint32),
                                  ref_counts.view(np.uint32))


def test_full_width_classifier_matches_the_jax_fixture():
    """130,107 words, 20 classes, the fixture's 32 documents: counts
    bitwise, labels equal but at counted near-ties, scores within 1e-4 of
    the largest |score| (the gates of ``chip_smoke.py`` phase 37)."""
    fixture = np.load(news.OUT)
    docs = news.documents(news.FULL, news.FIXTURE_DOCS)
    assert news.digest(docs) == str(fixture["docs_sha256"])
    graph = import_model(news.classifier_graph(GraphBuilder, news.FULL))
    labels, scores = (t.numpy() for t in graph.bind(device="cpu")(docs))
    held = news.held(labels, scores, fixture)
    assert held["ok"], held
    counts = news.counts_of(graph.truncated(2).bind(device="cpu"), docs)
    assert news.same_counts(counts, fixture), "counts differ from JAX's"
