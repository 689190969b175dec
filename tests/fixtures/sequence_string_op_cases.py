"""Small graphs of the ONNX optional, sequence and string ops
(``Optional``, ``OptionalHasElement``, ``OptionalGetElement``, the
``Sequence*`` ops, ``SplitToSequence``, ``ConcatFromSequence``,
``SequenceMap``, ``StringConcat``, ``StringSplit``, ``StringNormalizer``,
``RegexFullMatch`` and ``TfIdfVectorizer``), with their seeded inputs.

``tests/test_torch_onnx_ops_sequence.py`` runs each case through the JAX
package's importer and the port's on the CPU; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` run the port on the card against the port on
the CPU (:func:`run`, :func:`agree`). Sequences have no graph input of
their own, so a case is a small graph: the op under test with the nodes
that make its sequence or read it back. The cases hold the reference's
own tests of these ops (``tests/test_onnx.py``), the positions at each
edge (``SequenceInsert`` at -1 and at the length, every out-of-range
position raising), ``StringSplit``'s two modes with ``maxsplit`` and a
2-D input, ``StringNormalizer``'s ``[2, C]`` refusal and its all-filtered
row, and ``TfIdfVectorizer`` on the spec's examples, with weights,
duplicate output columns and a pool large enough to take the reference's
chunked ``lax.scan`` branch (rows x windows x grams above 2^24).

A case is a dict: ``op`` (the op under test), ``inputs``
(``[(name, array, where)]``, ``where`` one of ``"feed"`` (a graph input:
a device tensor, or a host numpy array where it holds strings),
``"init"`` (an initializer: integers and strings only, which both
packages keep on the host) or ``"const"`` (a Constant node: a host value
in both packages)), ``nodes`` (``[(op_type, inputs, outputs, attrs)]``,
a ``body`` attribute given as a :func:`_body` dict), ``outputs``,
``opset``, ``kind`` (``"exact"``: every output bitwise; ``"sum"``: float
outputs that sum products, within :data:`SUM_TOL`), ``exact`` and
``raises`` (the exception both packages raise, or None), as the other
case modules name them for ``chip_smoke.py``'s ``cases_on_card``.

This module imports neither package at import time: :func:`graph` takes
either package's ``GraphBuilder``, :func:`run` the port's
``import_model``.
"""
import numpy as np

F32, I32, I64 = np.float32, np.int32, np.int64
SUM_TOL = 1e-5        # float32 sums of products: rtol = atol
OPSET = 21
STR = object


def _x(seed, *shape, dtype=F32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _ids(seed, hi, *shape, dtype=I64):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(dtype)


def _s(*strings, shape=None):
    a = np.array(list(strings), dtype=object)
    return a if shape is None else a.reshape(shape)


def _i(v):
    return np.asarray(v, I64)


def _body(inputs, nodes, outputs, inits=()):
    """A ``SequenceMap`` body: its input names, nodes, outputs and
    initializers ``[(name, array)]``."""
    return dict(inputs=list(inputs), nodes=list(nodes),
                outputs=list(outputs), inits=list(inits))


def _case(name, op, inputs, nodes, outputs, kind="exact", raises=None,
          opset=OPSET):
    return dict(name=name, op=op, inputs=list(inputs), nodes=list(nodes),
                outputs=list(outputs), kind=kind, exact=kind == "exact",
                raises=raises, opset=opset)


def _one(name, op, inputs, n_out=1, kind="exact", raises=None,
         opset=OPSET, **attrs):
    """A one-node case over all of ``inputs``."""
    outs = [f"y{i}" for i in range(n_out)]
    return _case(name, op, inputs,
                 [(op, [n for n, _, _ in inputs], outs, attrs)], outs,
                 kind, raises, opset)


A, B, C = _x(1, 2, 3), _x(2, 2, 3), _x(3, 2, 3)
X64 = _x(4, 6, 4)
X7 = _x(5, 7, 3)
DOCS = _s("The quick brown Fox", "jumps over  the lazy dog!",
          "a b cc ddd", "", "   ", "Hello, World: hello again",
          "x-ray TEAM team Team")

OPTIONAL_CASES = [
    _case("optional_reference", "Optional", [("x", _x(6, 3), "feed")], [
        ("Optional", ["x"], ["o"], {}),
        ("OptionalHasElement", ["o"], ["has"], {}),
        ("OptionalGetElement", ["o"], ["val"], {}),
        ("Optional", [], ["empty"], {}),
        ("OptionalHasElement", ["empty"], ["has_not"], {})],
        ["has", "val", "has_not"]),
    _case("optional_get_element_of_empty_raises", "OptionalGetElement",
          [("x", _x(7, 3), "feed")], [
              ("Optional", [], ["e"], {}),
              ("OptionalGetElement", ["e"], ["y"], {})], ["y"],
          raises=ValueError),
    _case("optional_of_host_value", "OptionalGetElement",
          [("c", _i([3, 1, 2]), "const")], [
              ("Optional", ["c"], ["o"], {}),
              ("OptionalGetElement", ["o"], ["y"], {})], ["y"]),
    _case("optional_of_sequence", "OptionalHasElement",
          [("a", A, "feed"), ("b", B, "feed")], [
              ("SequenceConstruct", ["a", "b"], ["s"], {}),
              ("Optional", ["s"], ["o"], {}),
              ("OptionalHasElement", ["o"], ["has"], {}),
              ("OptionalGetElement", ["o"], ["seq"], {})], ["has", "seq"]),
    _case("optional_has_element_of_absent_input", "OptionalHasElement",
          [("x", _x(8, 2), "feed")], [
              ("OptionalHasElement", [""], ["has"], {}),
              ("Identity", ["x"], ["y"], {})], ["has", "y"]),
]

SEQUENCE_CASES = [
    _case("sequence_construct_at", "SequenceAt",
          [("a", A, "feed"), ("b", B, "feed"), ("p1", _i(1), "init"),
           ("m2", _i(-2), "init")], [
              ("SequenceConstruct", ["a", "b"], ["s"], {}),
              ("SequenceAt", ["s", "p1"], ["y0"], {}),
              ("SequenceAt", ["s", "m2"], ["y1"], {})], ["y0", "y1"]),
    _case("sequence_construct_is_a_list_output", "SequenceConstruct",
          [("a", A, "feed"), ("c", _x(10, 4), "const")], [
              ("SequenceConstruct", ["a", "c"], ["s"], {})], ["s"]),
    _case("sequence_empty_insert_length", "SequenceEmpty",
          [("a", A, "feed"), ("b", B, "feed"), ("p0", _i(0), "init")], [
              ("SequenceEmpty", [], ["e"], {}),
              ("SequenceInsert", ["e", "a"], ["s1"], {}),
              ("SequenceInsert", ["s1", "b", "p0"], ["s2"], {}),
              ("SequenceLength", ["s2"], ["n"], {})], ["s2", "n"]),
    _case("sequence_empty_dtype_ignored", "SequenceEmpty",
          [("a", A, "feed")], [
              ("SequenceEmpty", [], ["e"], {"dtype": 7}),
              ("SequenceInsert", ["e", "a"], ["s"], {}),
              ("ConcatFromSequence", ["s"], ["y"], {"axis": 0})], ["y"]),
    _case("sequence_length_of_empty", "SequenceLength", [], [
        ("SequenceEmpty", [], ["e"], {}),
        ("SequenceLength", ["e"], ["n"], {})], ["n"]),
    _case("sequence_insert_at_minus_one_goes_before_the_last",
          "SequenceInsert",
          [("a", A, "feed"), ("b", B, "feed"), ("c", C, "feed"),
           ("m1", _i(-1), "init")], [
              ("SequenceConstruct", ["a", "b"], ["s"], {}),
              ("SequenceInsert", ["s", "c", "m1"], ["t"], {})], ["t"]),
    _case("sequence_insert_at_len_appends", "SequenceInsert",
          [("a", A, "feed"), ("b", B, "feed"), ("c", C, "feed"),
           ("p2", _i(2), "init")], [
              ("SequenceConstruct", ["a", "b"], ["s"], {}),
              ("SequenceInsert", ["s", "c", "p2"], ["t"], {})], ["t"]),
    _case("sequence_insert_at_minus_len", "SequenceInsert",
          [("a", A, "feed"), ("b", B, "feed"), ("c", C, "feed"),
           ("m2", _i(-2), "init")], [
              ("SequenceConstruct", ["a", "b"], ["s"], {}),
              ("SequenceInsert", ["s", "c", "m2"], ["t"], {})], ["t"]),
    _case("sequence_insert_past_len_raises", "SequenceInsert",
          [("a", A, "feed"), ("b", B, "feed"), ("p3", _i(3), "init")], [
              ("SequenceConstruct", ["a", "b"], ["s"], {}),
              ("SequenceInsert", ["s", "a", "p3"], ["t"], {})], ["t"],
          raises=ValueError),
    _case("sequence_insert_before_minus_len_raises", "SequenceInsert",
          [("a", A, "feed"), ("b", B, "feed"), ("m3", _i(-3), "init")], [
              ("SequenceConstruct", ["a", "b"], ["s"], {}),
              ("SequenceInsert", ["s", "a", "m3"], ["t"], {})], ["t"],
          raises=ValueError),
    _case("sequence_insert_device_position_raises", "SequenceInsert",
          [("a", A, "feed"), ("p", _i(0), "feed")], [
              ("SequenceConstruct", ["a"], ["s"], {}),
              ("SequenceInsert", ["s", "a", "p"], ["t"], {})], ["t"],
          raises=ValueError),
    _case("sequence_erase_default_is_the_last", "SequenceErase",
          [("a", A, "feed"), ("b", B, "feed"), ("c", C, "feed")], [
              ("SequenceConstruct", ["a", "b", "c"], ["s"], {}),
              ("SequenceErase", ["s"], ["t"], {})], ["t"]),
    _case("sequence_erase_middle_and_negative", "SequenceErase",
          [("a", A, "feed"), ("b", B, "feed"), ("c", C, "feed"),
           ("p1", _i(1), "init"), ("m1", _i(-1), "init")], [
              ("SequenceConstruct", ["a", "b", "c"], ["s"], {}),
              ("SequenceErase", ["s", "p1"], ["t"], {}),
              ("SequenceErase", ["s", "m1"], ["u"], {})], ["t", "u"]),
    _case("sequence_erase_out_of_range_raises", "SequenceErase",
          [("a", A, "feed"), ("p3", _i(3), "init")], [
              ("SequenceConstruct", ["a", "a"], ["s"], {}),
              ("SequenceErase", ["s", "p3"], ["t"], {})], ["t"],
          raises=ValueError),
    _case("sequence_at_past_the_end_raises", "SequenceAt",
          [("a", A, "feed"), ("p3", _i(3), "init")], [
              ("SequenceConstruct", ["a"], ["s"], {}),
              ("SequenceAt", ["s", "p3"], ["y"], {})], ["y"],
          raises=ValueError),
    _case("sequence_at_before_minus_len_raises", "SequenceAt",
          [("a", A, "feed"), ("m2", _i(-2), "init")], [
              ("SequenceConstruct", ["a"], ["s"], {}),
              ("SequenceAt", ["s", "m2"], ["y"], {})], ["y"],
          raises=ValueError),
    _case("sequence_at_device_position_raises", "SequenceAt",
          [("a", A, "feed"), ("p", _i(0), "feed")], [
              ("SequenceConstruct", ["a"], ["s"], {}),
              ("SequenceAt", ["s", "p"], ["y"], {})], ["y"],
          raises=ValueError),
    _case("sequence_construct_insert_erase_at_reference", "SequenceErase",
          [("a", A, "feed"), ("b", _i([[1, 2], [3, 4]]), "init"),
           ("c", _i([[5, 6], [7, 8]]), "init"), ("p0", _i(0), "init"),
           ("p1", _i(1), "init"), ("m1", _i(-1), "init")], [
              ("SequenceConstruct", ["b", "c"], ["s"], {}),
              ("SequenceInsert", ["s", "a", "p0"], ["t"], {}),
              ("SequenceErase", ["t", "p1"], ["u"], {}),
              ("SequenceAt", ["u", "m1"], ["y"], {}),
              ("SequenceAt", ["u", "p0"], ["z"], {})], ["y", "z"]),
    _case("concat_from_sequence_all_host_stays_numpy", "ConcatFromSequence",
          [("x", _x(11, 2, 2), "feed"), ("h1", _i([2]), "init"),
           ("h2", _i([3]), "init")], [
              ("SequenceConstruct", ["h1", "h2"], ["s"], {}),
              ("ConcatFromSequence", ["s"], ["shp"], {"axis": 0}),
              ("ConstantOfShape", ["shp"], ["z"], {}),
              ("Reshape", ["z", "shp"], ["y"], {})], ["shp", "y"]),
    _case("concat_from_sequence_mixed_promotes", "ConcatFromSequence",
          [("a", A, "feed"), ("h", _x(12, 1, 3, dtype=np.float64),
                               "const")], [
              ("SequenceConstruct", ["a", "h"], ["s"], {}),
              ("ConcatFromSequence", ["s"], ["y"], {"axis": 0})], ["y"]),
    _case("concat_from_sequence_int_promotes", "ConcatFromSequence",
          [("a", _ids(13, 50, 3, 2, dtype=I32), "feed"),
           ("h", _i([[7, 8]]), "const")], [
              ("SequenceConstruct", ["a", "h"], ["s"], {}),
              ("ConcatFromSequence", ["s"], ["y"], {"axis": 0})], ["y"]),
    _case("concat_from_sequence_new_axis", "ConcatFromSequence",
          [("a", A, "feed"), ("b", B, "feed"), ("c", C, "feed")], [
              ("SequenceConstruct", ["a", "b", "c"], ["s"], {}),
              ("ConcatFromSequence", ["s"], ["y0"], {"axis": 1,
                                                     "new_axis": 1}),
              ("ConcatFromSequence", ["s"], ["y1"], {"axis": -1,
                                                     "new_axis": 1}),
              ("ConcatFromSequence", ["s"], ["y2"], {"axis": -1})],
          ["y0", "y1", "y2"]),
    _case("concat_from_sequence_without_axis_raises", "ConcatFromSequence",
          [("a", A, "feed")], [
              ("SequenceConstruct", ["a", "a"], ["s"], {}),
              ("ConcatFromSequence", ["s"], ["y"], {})], ["y"],
          raises=ValueError),
]

SPLIT_CASES = [
    _case("split_to_sequence_sizes_round_trip_reference", "SplitToSequence",
          [("x", X64, "feed"), ("sp", _i([2, 3, 1]), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {"axis": 0}),
              ("ConcatFromSequence", ["s"], ["y"], {"axis": 0}),
              ("SequenceLength", ["s"], ["n"], {})], ["y", "n", "s"]),
    _case("split_to_sequence_scalar_stacked_reference", "SplitToSequence",
          [("x", X64, "feed"), ("sp", _i(2), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {"axis": 0}),
              ("ConcatFromSequence", ["s"], ["y"], {"axis": 0,
                                                    "new_axis": 1})],
          ["y"]),
    _case("split_to_sequence_scalar_with_remainder", "SplitToSequence",
          [("x", X7, "feed"), ("sp", _i(2), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {"axis": 0}),
              ("SequenceLength", ["s"], ["n"], {})], ["s", "n"]),
    _case("split_to_sequence_into_two_is_one_output", "SplitToSequence",
          [("x", X64, "feed"), ("sp", _i([3, 3]), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {"axis": 0})], ["s"]),
    _case("split_to_sequence_into_three_is_one_output", "SplitToSequence",
          [("x", X64, "feed"), ("sp", _i([2, 2, 2]), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {"axis": 0})], ["s"]),
    _case("split_to_sequence_keepdims_0_at_reference", "SplitToSequence",
          [("x", X64, "feed"), ("i0", _i(0), "init")], [
              ("SplitToSequence", ["x"], ["s"], {"axis": 0, "keepdims": 0}),
              ("SequenceAt", ["s", "i0"], ["y"], {})], ["y"]),
    _case("split_to_sequence_negative_axis_unbind_reference",
          "SplitToSequence", [("x", X64, "feed"), ("i1", _i(1), "init")], [
              ("SplitToSequence", ["x"], ["s"], {"axis": -1,
                                                 "keepdims": 0}),
              ("SequenceAt", ["s", "i1"], ["y"], {})], ["y", "s"]),
    _case("split_to_sequence_keepdims_1", "SplitToSequence",
          [("x", X7, "feed")], [
              ("SplitToSequence", ["x"], ["s"], {"axis": 1})], ["s"]),
    _case("split_to_sequence_host_input_stays_host", "SplitToSequence",
          [("h", _x(14, 5, 2), "const"), ("sp", _i(2), "init")], [
              ("SplitToSequence", ["h", "sp"], ["s"], {}),
              ("SplitToSequence", ["h"], ["t"], {"keepdims": 0})],
          ["s", "t"]),
    _case("split_to_sequence_one_size_is_whole", "SplitToSequence",
          [("x", X64, "feed"), ("sp", _i([6]), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {})], ["s"]),
    _case("split_to_sequence_short_sizes_run_to_the_end", "SplitToSequence",
          [("x", X64, "feed"), ("sp", _i([2, 2]), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {})], ["s"]),
    _case("split_to_sequence_strings", "SplitToSequence",
          [("docs", DOCS[:3], "feed")], [
              ("SplitToSequence", ["docs"], ["s"], {"keepdims": 0})],
          ["s"]),
    _case("split_to_sequence_device_split_raises", "SplitToSequence",
          [("x", X64, "feed"), ("sp", _i([3, 3]), "feed")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {})], ["s"],
          raises=ValueError),
]

_ADD_BODY = _body(["e", "t"], [("Add", ["e", "t"], ["b_out"], {})],
                  ["b_out"])

SEQUENCE_MAP_CASES = [
    _case("sequence_map_reference", "SequenceMap",
          [("x1", np.asarray([1., 2.], F32), "const"),
           ("x2", np.asarray([10., 20., 30.], F32), "const"),
           ("extra", np.asarray([100.], F32), "const")], [
              ("SequenceConstruct", ["x1", "x2"], ["s"], {}),
              ("SequenceMap", ["s", "extra"], ["m"], {"body": _ADD_BODY}),
              ("ConcatFromSequence", ["m"], ["y"], {"axis": 0})], ["y"],
          opset=17),
    _case("sequence_map_tensor_extra_broadcasts", "SequenceMap",
          [("x", X64, "feed"), ("t", _x(15, 4), "feed"),
           ("sp", _i([1, 2, 3]), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {}),
              ("SequenceMap", ["s", "t"], ["m"], {"body": _ADD_BODY})],
          ["m"]),
    _case("sequence_map_sequence_extra_zips", "SequenceMap",
          [("a", A, "feed"), ("b", B, "feed"), ("c", C, "feed")], [
              ("SequenceConstruct", ["a", "b"], ["s"], {}),
              ("SequenceConstruct", ["c", "a"], ["u"], {}),
              ("SequenceMap", ["s", "u"], ["m"], {"body": _body(
                  ["e", "f"], [("Mul", ["e", "f"], ["b_p"], {})],
                  ["b_p"])})], ["m"]),
    _case("sequence_map_two_outputs", "SequenceMap",
          [("x", X64, "feed"), ("sp", _i(3), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {}),
              ("SequenceMap", ["s"], ["m0", "m1"], {"body": _body(
                  ["e"], [("Neg", ["e"], ["b_n"], {}),
                          ("ReduceMax", ["e"], ["b_r"], {"keepdims": 0})],
                  ["b_n", "b_r"])}),
              ("ConcatFromSequence", ["m1"], ["y"], {"axis": 0,
                                                     "new_axis": 1})],
          ["m0", "y"]),
    _case("sequence_map_body_initializer_matmul_relu", "SequenceMap",
          [("x", _x(16, 8, 12), "feed"), ("sp", _i([4, 4, 4]), "init")], [
              ("SplitToSequence", ["x", "sp"], ["s"], {"axis": 1}),
              ("SequenceMap", ["s"], ["m"], {"body": _body(
                  ["e"], [("MatMul", ["e", "b_w"], ["b_h"], {}),
                          ("Relu", ["b_h"], ["b_y"], {})], ["b_y"],
                  inits=[("b_w", _x(17, 4, 8))])}),
              ("ConcatFromSequence", ["m"], ["y"], {"axis": 1})], ["y"],
          kind="sum"),
    _case("sequence_map_body_captures_an_outer_name", "SequenceMap",
          [("a", A, "feed"), ("b", B, "feed"), ("scale", _x(18, 3),
                                                "feed")], [
              ("SequenceConstruct", ["a", "b"], ["s"], {}),
              ("SequenceMap", ["s"], ["m"], {"body": _body(
                  ["e"], [("Mul", ["e", "scale"], ["b_m"], {})],
                  ["b_m"])})], ["m"]),
    _case("sequence_map_over_empty", "SequenceMap", [], [
        ("SequenceEmpty", [], ["e"], {}),
        ("SequenceMap", ["e"], ["m"], {"body": _body(
            ["e0"], [("Identity", ["e0"], ["b_i"], {})], ["b_i"])}),
        ("SequenceLength", ["m"], ["n"], {})], ["n"]),
    _case("sequence_map_string_tokens", "SequenceMap",
          [("docs", DOCS, "feed")], [
              ("SplitToSequence", ["docs"], ["s"], {"keepdims": 0}),
              ("SequenceMap", ["s"], ["m", "k"], {"body": _body(
                  ["d"], [
                      ("StringSplit", ["d"], ["b_tok", "b_n"], {}),
                      ("RegexFullMatch", ["b_tok"], ["b_ok"],
                       {"pattern": r"\w\w+"}),
                      ("Compress", ["b_tok", "b_ok"], ["b_kept"],
                       {"axis": 0}),
                      ("StringNormalizer", ["b_kept"], ["b_low"],
                       {"case_change_action": "LOWER"})],
                  ["b_low", "b_n"])})], ["m", "k"]),
]

STRING_CASES = [
    _case("string_ops_reference", "StringConcat",
          [("a", _s("foo", "bar baz qux", ""), "init"),
           ("b", _s("_x", "_y", "_z"), "init")], [
              ("StringConcat", ["a", "b"], ["c"], {}),
              ("StringSplit", ["a"], ["s", "n"], {}),
              ("StringNormalizer", ["a"], ["norm"], {
                  "case_change_action": "UPPER", "stopwords": ["foo"],
                  "is_case_sensitive": 1}),
              ("RegexFullMatch", ["a"], ["rx"], {"pattern": r"\w+"})],
          ["c", "s", "n", "norm", "rx"], opset=20),
    _one("string_split_delimiter_maxsplit_reference", "StringSplit",
         [("a", _s("a,b,c,d", "x,,y"), "init")], n_out=2, opset=20,
         delimiter=",", maxsplit=2),
    _one("string_split_delimiter_keeps_empty_tokens", "StringSplit",
         [("a", _s(",a,,b,", "", "no delimiter"), "feed")], n_out=2,
         delimiter=","),
    _one("string_split_multichar_delimiter", "StringSplit",
         [("a", _s("a--b---c", "--"), "feed")], n_out=2, delimiter="--"),
    _one("string_split_whitespace_maxsplit", "StringSplit",
         [("a", _s("  one two   three ", "solo", "a\tb\nc"), "feed")],
         n_out=2, maxsplit=1),
    _one("string_split_2d", "StringSplit",
         [("a", _s("a b", "c", "", "d e f", shape=(2, 2)), "feed")],
         n_out=2),
    _one("string_split_all_empty_is_width_0", "StringSplit",
         [("a", _s("", "  "), "feed")], n_out=2),
    _one("string_split_device_tensor_raises", "StringSplit",
         [("a", _x(19, 3), "feed")], n_out=2, raises=NotImplementedError),
    _one("string_concat_broadcasts", "StringConcat",
         [("a", _s("p", "q", shape=(2, 1)), "feed"),
          ("b", _s("1", "2", "3"), "const")]),
    _one("string_concat_device_tensor_raises", "StringConcat",
         [("a", _s("p", "q"), "feed"), ("b", _x(20, 2), "feed")],
         raises=NotImplementedError),
    _one("string_normalizer_all_filtered_reference", "StringNormalizer",
         [("a", _s("Stop", "STOP", shape=(1, 2)), "init")],
         stopwords=["stop"], is_case_sensitive=0,
         case_change_action="LOWER", opset=20),
    _one("string_normalizer_all_filtered_1d", "StringNormalizer",
         [("a", _s("the", "a", "The"), "feed")], stopwords=["the", "a"],
         case_change_action="UPPER"),
    _one("string_normalizer_case_sensitive_keeps_other_cases",
         "StringNormalizer", [("a", _s("The", "the", "THE", "cat"),
                               "feed")],
         stopwords=["the"], is_case_sensitive=1),
    _one("string_normalizer_case_insensitive_lower", "StringNormalizer",
         [("a", _s("The", "Cat", "SAT", "on", "THE", "Mat"), "feed")],
         stopwords=["the", "ON"], case_change_action="LOWER"),
    _one("string_normalizer_no_stopwords_none", "StringNormalizer",
         [("a", _s("MiXeD", "Case", shape=(1, 2)), "feed")]),
    _one("string_normalizer_locale_ignored", "StringNormalizer",
         [("a", _s("ISTANBUL", "Iğdır", "STRASSE"), "feed")],
         case_change_action="LOWER", locale="tr_TR"),
    _one("string_normalizer_2_rows_raises", "StringNormalizer",
         [("a", _s("a", "b", "c", "d", shape=(2, 2)), "feed")],
         raises=ValueError),
    _one("string_normalizer_device_tensor_raises", "StringNormalizer",
         [("a", _x(21, 4), "feed")], raises=NotImplementedError),
    _one("regex_full_match_not_search", "RegexFullMatch",
         [("a", _s("abc", "abc!", "", "x1_y", "héllo", "--"), "feed")],
         pattern=r"\w\w+"),
    _one("regex_full_match_2d", "RegexFullMatch",
         [("a", _s("2024-01-02", "2024-1-2", "24-01-02", "2024-01-0x",
                   shape=(2, 2)), "feed")],
         pattern=r"\d{4}-\d{2}-\d{2}"),
    _one("regex_full_match_python_lookahead", "RegexFullMatch",
         [("a", _s("abx", "ab", "xx"), "feed")], pattern=r"\w+(?=x)x"),
    _one("regex_full_match_without_pattern_raises", "RegexFullMatch",
         [("a", _s("a"), "feed")], raises=ValueError),
    _one("regex_full_match_device_tensor_raises", "RegexFullMatch",
         [("a", _x(22, 3), "feed")], pattern=".*",
         raises=NotImplementedError),
]

# the ONNX spec's TfIdfVectorizer examples share this pool: unigrams 2, 3,
# 5, 4 (columns 0-3) and bigrams (5, 6), (7, 8), (6, 7) (columns 4-6)
_SPEC_POOL = dict(ngram_counts=[0, 4], ngram_indexes=list(range(7)),
                  pool_int64s=[2, 3, 5, 4, 5, 6, 7, 8, 6, 7])
_SPEC_ROWS = np.asarray([[1, 1, 3, 3, 3, 7], [8, 6, 7, 5, 6, 8]], I32)
_LARGE_POOL = 12_000      # 4 rows x 509 bigram windows x 12,000 > 2^24


def _large_tfidf(mode):
    rng = np.random.default_rng(23)
    uni = rng.permutation(_LARGE_POOL).astype(I64)
    bi = rng.integers(0, 40, (500, 2)).astype(I64).reshape(-1)
    cols = np.concatenate([np.arange(_LARGE_POOL),
                           rng.integers(0, _LARGE_POOL, 500)])
    weights = rng.uniform(0.5, 3.0, cols.size).astype(F32)
    return _one(f"tfidf_large_chunked_{mode.lower()}", "TfIdfVectorizer",
                [("x", _ids(24, 40, 4, 512), "feed")], mode=mode,
                min_gram_length=1, max_gram_length=2, max_skip_count=2,
                ngram_counts=[0, _LARGE_POOL],
                ngram_indexes=cols.tolist(),
                pool_int64s=np.concatenate([uni, bi]).tolist(),
                weights=weights.tolist())


TFIDF_CASES = [
    _one("tfidf_spec_batch_onlybigrams_skip0", "TfIdfVectorizer",
         [("x", _SPEC_ROWS, "feed")], opset=9, mode="TF",
         min_gram_length=2, max_gram_length=2, max_skip_count=0,
         **_SPEC_POOL),
    _one("tfidf_spec_batch_onlybigrams_skip5", "TfIdfVectorizer",
         [("x", _SPEC_ROWS, "feed")], opset=9, mode="TF",
         min_gram_length=2, max_gram_length=2, max_skip_count=5,
         **_SPEC_POOL),
    _one("tfidf_spec_batch_uniandbigrams_skip5", "TfIdfVectorizer",
         [("x", _SPEC_ROWS, "feed")], opset=9, mode="TF",
         min_gram_length=1, max_gram_length=2, max_skip_count=5,
         **_SPEC_POOL),
    _one("tfidf_spec_only_bigrams_skip0_1d", "TfIdfVectorizer",
         [("x", _SPEC_ROWS.reshape(-1), "feed")], opset=9, mode="TF",
         min_gram_length=2, max_gram_length=2, max_skip_count=0,
         **_SPEC_POOL),
    _one("tfidf_spec_onlybigrams_levelempty", "TfIdfVectorizer",
         [("x", _SPEC_ROWS.reshape(-1), "feed")], opset=9, mode="TF",
         min_gram_length=2, max_gram_length=2, max_skip_count=0,
         ngram_counts=[0, 0], ngram_indexes=[0, 1, 2],
         pool_int64s=[5, 6, 7, 8, 6, 7]),
    _one("tfidf_spec_uniandbigrams_skip5_1d", "TfIdfVectorizer",
         [("x", _SPEC_ROWS.reshape(-1), "feed")], opset=9, mode="TF",
         min_gram_length=1, max_gram_length=2, max_skip_count=5,
         **_SPEC_POOL),
    _one("tfidf_idf_weights", "TfIdfVectorizer",
         [("x", _SPEC_ROWS.astype(I64), "feed")], mode="IDF",
         min_gram_length=1, max_gram_length=2, max_skip_count=1,
         weights=[0.5, 1.5, 2.0, 3.0, 0.25, 4.0, 1.25], **_SPEC_POOL),
    _one("tfidf_tfidf_weights", "TfIdfVectorizer",
         [("x", _SPEC_ROWS.astype(I64), "feed")], mode="TFIDF",
         min_gram_length=1, max_gram_length=2, max_skip_count=1,
         weights=[0.5, 1.5, 2.0, 3.0, 0.25, 4.0, 1.25], **_SPEC_POOL),
    _one("tfidf_idf_without_weights_is_ones", "TfIdfVectorizer",
         [("x", _SPEC_ROWS.astype(I64), "feed")], mode="IDF",
         min_gram_length=1, max_gram_length=1, **_SPEC_POOL),
    _one("tfidf_duplicate_ngram_indexes_add", "TfIdfVectorizer",
         [("x", _ids(25, 6, 3, 20), "feed")], mode="TFIDF",
         min_gram_length=1, max_gram_length=2, max_skip_count=1,
         ngram_counts=[0, 4], ngram_indexes=[0, 1, 1, 2, 0, 2, 3],
         pool_int64s=[0, 1, 2, 3, 0, 1, 2, 2, 4, 5],
         weights=[1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]),
    _one("tfidf_trigrams_with_skips", "TfIdfVectorizer",
         [("x", _ids(26, 4, 2, 30), "feed")], mode="TF",
         min_gram_length=1, max_gram_length=3, max_skip_count=3,
         ngram_counts=[0, 2, 6], ngram_indexes=list(range(5)),
         pool_int64s=[0, 1, 0, 1, 2, 3, 1, 2, 3]),
    _one("tfidf_span_longer_than_the_row", "TfIdfVectorizer",
         [("x", _ids(27, 4, 2, 3), "feed")], mode="TF",
         min_gram_length=2, max_gram_length=2, max_skip_count=5,
         ngram_counts=[0, 2], ngram_indexes=[0, 1, 2],
         pool_int64s=[0, 1, 0, 1]),
    _one("tfidf_host_input_counts_on_the_device", "TfIdfVectorizer",
         [("x", _ids(28, 8, 2, 10), "const")], mode="TF",
         ngram_counts=[0], ngram_indexes=list(range(8)),
         pool_int64s=list(range(8))),
    _one("tfidf_unknown_ids_count_nothing", "TfIdfVectorizer",
         [("x", np.asarray([-1, 3, -1, 99, 3], I64), "feed")], mode="TF",
         ngram_counts=[0], ngram_indexes=[1, 0], pool_int64s=[3, -7]),
    _large_tfidf("IDF"),
    _large_tfidf("TFIDF"),
    _one("tfidf_pool_strings_raises", "TfIdfVectorizer",
         [("x", _ids(29, 3, 2, 4), "feed")], mode="TF",
         ngram_counts=[0], ngram_indexes=[0, 1], pool_strings=["a", "b"],
         raises=NotImplementedError),
    _one("tfidf_unknown_mode_raises", "TfIdfVectorizer",
         [("x", _ids(30, 3, 2, 4), "feed")], mode="BM25",
         ngram_counts=[0], ngram_indexes=[0, 1], pool_int64s=[0, 1],
         raises=ValueError),
]

CASES = (OPTIONAL_CASES + SEQUENCE_CASES + SPLIT_CASES + SEQUENCE_MAP_CASES
         + STRING_CASES + TFIDF_CASES)


def by_name(name: str) -> dict:
    return next(c for c in CASES if c["name"] == name)


def _add_nodes(g, nodes, graph_cls, opset):
    for op, ins, outs, attrs in nodes:
        attrs = dict(attrs)
        if "body" in attrs:
            attrs["body"] = _build_body(attrs["body"], graph_cls, opset)
        g.add_node(op, list(ins), outputs=list(outs), **attrs)


def _build_body(body, graph_cls, opset):
    sub = graph_cls(name="body", opset=opset, name_prefix="b_")
    for name in body["inputs"]:
        sub.add_input(name, None)
    for name, a in body["inits"]:
        sub.add_initializer(name, a)
    _add_nodes(sub, body["nodes"], graph_cls, opset)
    for name in body["outputs"]:
        sub.add_output(name, np.float32, None)
    return sub.build().graph


def graph(case: dict, graph_cls) -> bytes:
    """The case's graph, built with ``graph_cls`` (either package's
    ``GraphBuilder``)."""
    g = graph_cls(opset=case["opset"])
    for name, a, where in case["inputs"]:
        if where == "feed":
            g.add_input(name, None if a.dtype == STR else a.dtype,
                        None if a.dtype == STR else list(a.shape))
        elif where == "init":
            g.add_initializer(name, a)
        else:
            g.add_node("Constant", [], outputs=[name], value=np.asarray(a))
    _add_nodes(g, case["nodes"], graph_cls, case["opset"])
    for o in case["outputs"]:
        g.add_output(o, np.float32, None)
    return g.to_bytes()


def feeds(case: dict) -> list:
    """The graph inputs' numpy values, in order."""
    return [a for _, a, where in case["inputs"] if where == "feed"]


def leaves(values) -> list:
    """Outputs as ``[(key, array or None, host)]``: a sequence output
    gives a ``"<i>:list[n]"`` entry, then one entry an element; a tensor
    comes back as numpy with ``host`` False."""
    out = []

    def leaf(key, v):
        if v is None:
            out.append((key, None, None))
        elif hasattr(v, "detach"):                  # a torch tensor
            out.append((key, v.detach().cpu().numpy(), False))
        elif isinstance(v, (np.ndarray, np.generic)):
            out.append((key, np.asarray(v), True))
        else:                                       # a jax array
            out.append((key, np.asarray(v), False))

    for i, v in enumerate(values):
        if isinstance(v, list):
            out.append((f"{i}:list[{len(v)}]", None, None))
            for j, e in enumerate(v):
                leaf(f"{i}.{j}", e)
        else:
            leaf(str(i), v)
    return out


def run(case: dict, import_model, graph_cls, device: str) -> list:
    """The port's outputs of the case on ``device`` (``import_model`` and
    ``graph_cls`` the port's) as :func:`leaves`; numeric feeds go in as
    tensors on ``device``, string ones as numpy."""
    import torch

    fn = import_model(graph(case, graph_cls)).bind(device=device)
    args = [a if a.dtype == STR else
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in feeds(case)]
    return leaves(fn(*args))


def agree(case: dict, got: list, want: list) -> dict:
    """``got`` against ``want`` (:func:`leaves` of two runs; ``want``'s
    dtypes may be the reference's 32-bit ones where ``got``'s are 64-bit
    device values): the same outputs, sequence lengths, host-ness, shapes
    and dtypes; strings, bools and integers equal; floats bitwise where
    the case is ``"exact"``, else within :data:`SUM_TOL`. Returns
    ``{"ok", "max_abs_err", "leaves"}``."""
    ok, err = len(got) == len(want), 0.0
    narrowed = {"float64": "float32", "int64": "int32"}
    for (gk, g, gh), (wk, w, wh) in zip(got, want):
        ok &= gk == wk and gh == wh and (g is None) == (w is None)
        if not ok or g is None:
            continue
        ok &= g.shape == w.shape and (
            g.dtype == w.dtype or (not wh and narrowed.get(g.dtype.name)
                                   == w.dtype.name))
        if not ok:
            break
        if g.dtype == STR:
            ok &= g.tolist() == w.tolist()
            continue
        g = g.astype(w.dtype)
        if g.dtype.kind != "f":
            ok &= bool(np.array_equal(g, w))
            continue
        if g.size:
            err = max(err, float(np.abs(g.astype(np.float64)
                                        - w.astype(np.float64)).max()))
        if case["exact"]:
            bits = f"u{g.itemsize}"
            ok &= bool(np.array_equal(g.view(bits), w.view(bits)))
        else:
            ok &= bool(np.allclose(g, w, rtol=SUM_TOL, atol=SUM_TOL))
    return {"ok": bool(ok), "max_abs_err": err, "leaves": len(got)}
