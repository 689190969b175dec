"""One-node graphs of the ONNX signal ops (``DFT``, ``STFT``,
``HannWindow``, ``HammingWindow``, ``BlackmanWindow``,
``MelWeightMatrix``), with their seeded inputs, and the log-mel chain
that ``AudioFeaturizer`` builds from them.

``tests/test_torch_onnx_ops_signal.py`` runs each case through the JAX
package's importer and the port's on the CPU; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` run the port on the card against the port on
the CPU (:func:`run`, :func:`agree`). The cases hold every attribute and
input of the ops and every refusal of the reference: ``DFT``'s axis from
the opset-17 attribute (default 1) and the opset-20 input (default -2),
``dft_length`` shorter and longer than the axis, inverse, onesided, a
complex input, half, 64-bit and integer inputs; ``STFT`` on ``[B, L, 1]``
and ``[B, L]`` signals, a window from an initializer, a graph input and a
``HannWindow`` node, no window, a signal shorter than one frame, both
``onesided`` values; the windows periodic and symmetric, of size 1, in
each ``output_datatype``; ``MelWeightMatrix`` at the featurizer's and
Whisper's geometries.

A case is a dict: ``op``, ``inputs`` (``[(name, array, where)]``,
``where`` one of ``"feed"`` (a graph input, a tensor), ``"feed_bf16"`` (a
graph input cast to bfloat16 on the way in: the array holds its float32
values, so neither numpy nor the card's machine needs ``ml_dtypes``),
``"init"`` (an initializer) or ``"const"`` (a Constant node)), ``nodes``
(``[(op_type, inputs, outputs, attrs)]``), ``outputs``, ``opset``,
``kind`` (``"exact"``: every output bitwise; ``"spectrum"``: float outputs
within :data:`SPEC_TOL` of each output's largest |value|, or one step of
a half-precision output's type (:data:`HALF_TOL`); ``"log_mel"``: within
:data:`LOG_MEL_TOL`, absolute and relative), ``exact`` and ``raises``
(the exception both packages raise, or None), as the other case modules
name them for ``chip_smoke.py``'s ``cases_on_card``.

This module imports neither package at import time: :func:`graph` takes
either package's ``GraphBuilder``, :func:`run` the port's
``import_model``.
"""
import numpy as np

F16, F32, F64, I32, I64 = (np.float16, np.float32, np.float64, np.int32,
                           np.int64)
SPEC_TOL = 1e-5       # float32 spectra: of each output's largest |value|
HALF_TOL = {"float16": 2.0 ** -10, "bfloat16": 2.0 ** -7}  # one step of the type, of the largest |value|
LOG_MEL_TOL = 1e-3    # log-mel: rtol = atol (tests/test_cognitive.py's gate)
OPSET = 17


def _x(seed, *shape, dtype=F32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _i(v, dtype=I64):
    return np.asarray(v, dtype)


def _f(v):
    return np.asarray(v, F32)


def _case(name, op, inputs, nodes, outputs, kind="exact", raises=None,
          opset=OPSET):
    return dict(name=name, op=op, inputs=list(inputs), nodes=list(nodes),
                outputs=list(outputs), kind=kind, exact=kind == "exact",
                raises=raises, opset=opset)


def _one(name, op, inputs, kind="exact", raises=None, opset=OPSET,
         **attrs):
    """A one-node case over all of ``inputs`` (an empty name skips a
    slot)."""
    return _case(name, op, [i for i in inputs if i[0]],
                 [(op, [n for n, _, _ in inputs], ["y"], attrs)], ["y"],
                 kind, raises, opset)


def _dft(name, x, kind="spectrum", raises=None, opset=OPSET, n=None,
         axis=None, where="feed", **attrs):
    ins = [("x", x, where)]
    if n is not None or axis is not None:
        ins.append(("n", _i(n), "init") if n is not None else ("", None, ""))
    if axis is not None:
        ins.append(("axis", _i(axis), "init"))
    return _one(name, "DFT", ins, kind, raises, opset, **attrs)


def _stft(name, signal, step, window=None, flen=None, kind="spectrum",
          raises=None, where="feed", win_where="init", **attrs):
    ins = [("signal", signal, where), ("step", _i(step), "init")]
    ins.append(("win", window, win_where) if window is not None
               else ("", None, ""))
    if flen is not None:
        ins.append(("flen", _i(flen), "init"))
    return _one(name, "STFT", ins, kind, raises, **attrs)


def _mel(name, n_mel, n_dft, sr, lo, hi, **attrs):
    return _one(name, "MelWeightMatrix", [
        ("n_mel", _i(n_mel), "init"), ("n_dft", _i(n_dft), "init"),
        ("sr", _i(sr), "init"), ("lo", _f(lo), "init"),
        ("hi", _f(hi), "init")], **attrs)


REAL = _x(1, 3, 16, 1)
COMPLEX = _x(2, 2, 9, 2)
RANK4 = _x(3, 2, 3, 10, 1)
COMPLEX4 = _x(4, 2, 6, 5, 2)

DFT_CASES = [
    _dft("dft_opset17_default_axis_1", REAL),
    _one("dft_opset17_axis_attribute_2", "DFT", [("x", RANK4, "feed")],
         "spectrum", axis=2),
    _one("dft_opset17_axis_attribute_negative", "DFT",
         [("x", RANK4, "feed")], "spectrum", axis=-3),
    _dft("dft_opset20_default_axis_minus_2", _x(5, 2, 12, 1), opset=20),
    _dft("dft_opset20_axis_input_1", COMPLEX4, opset=20, axis=1),
    _dft("dft_opset20_axis_input_negative", COMPLEX4, opset=20, axis=-3),
    _one("dft_opset20_reads_an_axis_attribute", "DFT",
         [("x", COMPLEX4, "feed")], "spectrum", opset=20, axis=1),
    _dft("dft_length_shorter_truncates", _x(6, 2, 12, 1), n=8),
    _dft("dft_length_longer_pads", _x(7, 2, 12, 1), n=20),
    _dft("dft_length_longer_complex_opset20", COMPLEX, opset=20, n=13,
         axis=1),
    _dft("dft_complex_input", COMPLEX),
    _dft("dft_inverse_complex", COMPLEX, inverse=1),
    _dft("dft_inverse_real_with_length", _x(8, 2, 7, 1), n=10, inverse=1),
    _dft("dft_onesided_real_even", REAL, onesided=1),
    _dft("dft_onesided_real_odd_length", _x(9, 2, 11, 1), onesided=1),
    _dft("dft_onesided_with_length", _x(10, 2, 11, 1), n=16, onesided=1),
    _dft("dft_whisper_frame_400", _x(11, 4, 400, 1), onesided=1),
    _dft("dft_float16_real_keeps_float16", _x(12, 2, 16, 1, dtype=F16)),
    _dft("dft_float16_onesided_keeps_float16", _x(13, 2, 20, 1, dtype=F16),
         onesided=1),
    _dft("dft_bfloat16_real_keeps_bfloat16", _x(14, 2, 16, 1),
         where="feed_bf16"),
    _dft("dft_float64_real", _x(15, 2, 12, 1, dtype=F64)),
    _dft("dft_float64_complex_inverse", _x(16, 2, 9, 2, dtype=F64),
         inverse=1),
    _dft("dft_int32_real_gives_float32",
         np.random.default_rng(17).integers(-50, 50, (2, 8, 1)).astype(I32)),
    _dft("dft_host_input", _x(18, 2, 8, 1), where="const"),
    _one("dft_trailing_axis_raises", "DFT", [("x", REAL, "feed")],
         raises=ValueError, axis=-1),
    _dft("dft_trailing_axis_input_raises", COMPLEX, opset=20, axis=2,
         raises=ValueError),
    _dft("dft_last_dim_3_raises", _x(19, 2, 8, 3), raises=ValueError),
    _dft("dft_inverse_onesided_raises", REAL, inverse=1, onesided=1,
         raises=NotImplementedError),
    _dft("dft_onesided_complex_raises", COMPLEX, onesided=1,
         raises=ValueError),
    _dft("dft_float16_complex_raises", _x(20, 2, 8, 2, dtype=F16),
         raises=TypeError),
    _dft("dft_bfloat16_complex_raises", _x(21, 2, 8, 2), where="feed_bf16",
         raises=TypeError),
    _dft("dft_int32_complex_raises",
         np.random.default_rng(22).integers(-5, 5, (2, 8, 2)).astype(I32),
         raises=TypeError),
]

HANN16 = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(16) / 15)).astype(F32)
SIGNAL = _x(30, 2, 64, 1)
SIGNAL2 = _x(31, 3, 50)

STFT_CASES = [
    _stft("stft_rank3_window_and_frame_length", SIGNAL, 8, HANN16, 16),
    _stft("stft_rank2_window_only", SIGNAL2, 5,
          np.hamming(12).astype(F32)),
    _stft("stft_frame_length_only_is_all_ones", SIGNAL2, 7, flen=10),
    _stft("stft_two_sided", SIGNAL, 8, HANN16, 16, onesided=0),
    _stft("stft_window_as_graph_input", SIGNAL, 6, HANN16,
          win_where="feed"),
    _stft("stft_window_from_a_constant", SIGNAL, 6, HANN16,
          win_where="const"),
    _case("stft_window_from_hann_window", "STFT",
          [("signal", SIGNAL, "feed"), ("step", _i(4), "init"),
           ("size", _i(16), "init")],
          [("HannWindow", ["size"], ["win"], {"periodic": 0}),
           ("STFT", ["signal", "step", "win"], ["y"], {})], ["y"],
          kind="spectrum"),
    _stft("stft_step_larger_than_frame", SIGNAL2, 17, flen=8),
    _stft("stft_one_frame", _x(32, 2, 20), 5, flen=20),
    _stft("stft_shorter_than_a_frame_is_empty", _x(33, 2, 10), 2, flen=16),
    _stft("stft_shorter_than_a_frame_two_sided", _x(34, 2, 5, 1), 3,
          HANN16, onesided=0),
    _stft("stft_float16_two_sided", _x(35, 2, 48, 1, dtype=F16), 8,
          HANN16.astype(F16), onesided=0),
    _stft("stft_float64_signal", _x(36, 2, 64, 1, dtype=F64), 8, HANN16),
    _stft("stft_int32_signal_truncates_the_window",
          np.random.default_rng(37).integers(-99, 99, (2, 40)).astype(I32),
          4, (HANN16 * 3).astype(F32)),
    _stft("stft_whisper_geometry", _x(38, 2, 4000), 160,
          np.hanning(400).astype(F32)),
    _stft("stft_complex_signal_raises", _x(39, 2, 32, 2), 4, HANN16,
          raises=NotImplementedError),
    _stft("stft_window_length_mismatch_raises", SIGNAL, 4, HANN16, 12,
          raises=ValueError),
    _stft("stft_no_window_no_frame_length_raises", SIGNAL, 4,
          raises=ValueError),
    _stft("stft_float16_onesided_raises", _x(40, 2, 48, dtype=F16), 8,
          HANN16.astype(F16), raises=ValueError),
    _stft("stft_bfloat16_onesided_raises", _x(41, 2, 48), 8, HANN16,
          where="feed_bf16", raises=ValueError),
]

WINDOW_CASES = [
    _one(f"{op.lower()}_{mode}_{n}", op, [("size", _i(n), "init")],
         periodic=int(mode == "periodic"))
    for op in ("HannWindow", "HammingWindow", "BlackmanWindow")
    for mode in ("periodic", "symmetric") for n in (1, 10, 16)
] + [
    _one("hann_window_default_is_periodic", "HannWindow",
         [("size", _i(8), "init")]),
    _one("hamming_window_size_from_a_constant", "HammingWindow",
         [("size", _i(9), "const")]),
    _one("blackman_window_size_0", "BlackmanWindow",
         [("size", _i(0), "init")]),
    _one("hann_window_whisper_400_periodic", "HannWindow",
         [("size", _i(400), "init")]),
] + [
    _one(f"{op.lower()}_output_datatype_{dt}", op, [("size", _i(12), "init")],
         periodic=0, output_datatype=dt)
    for op in ("HannWindow", "HammingWindow", "BlackmanWindow")
    for dt in (10, 11, 16, 6)
]

MEL_CASES = [
    _mel("mel_featurizer_defaults", 64, 400, 16000, 125.0, 7600.0),
    _mel("mel_whisper_80", 80, 400, 16000, 0.0, 8000.0),
    _mel("mel_small", 8, 64, 8000, 100.0, 3000.0),
    _mel("mel_odd_dft_length", 10, 255, 22050, 50.0, 10000.0),
    _mel("mel_more_bins_than_spectrum", 40, 32, 16000, 0.0, 8000.0),
    _mel("mel_output_float16", 16, 128, 16000, 20.0, 7000.0,
         output_datatype=10),
    _mel("mel_output_float64", 16, 128, 16000, 20.0, 7000.0,
         output_datatype=11),
    _mel("mel_output_bfloat16", 16, 128, 16000, 20.0, 7000.0,
         output_datatype=16),
    _mel("mel_output_int64", 16, 128, 16000, 20.0, 7000.0,
         output_datatype=7),
    _one("mel_float_sample_rate_from_constants", "MelWeightMatrix", [
        ("n_mel", _i(12), "const"), ("n_dft", _i(256), "const"),
        ("sr", _f(11025.0), "const"), ("lo", _f(0.0), "const"),
        ("hi", _f(5512.5), "const")]),
]


def log_mel_nodes() -> list:
    """``AudioFeaturizer``'s graph as nodes: ``STFT`` → ``ReduceSumSquare``
    → ``MatMul`` by ``MelWeightMatrix`` → ``Add`` 1e-6 → ``Log``."""
    return [
        ("STFT", ["signal", "step", "win"], ["spec"], {"onesided": 1}),
        ("ReduceSumSquare", ["spec", "axes"], ["power"], {"keepdims": 0}),
        ("MelWeightMatrix", ["n_mel", "n_dft", "sr", "lo", "hi"], ["mel"],
         {}),
        ("MatMul", ["power", "mel"], ["melspec"], {}),
        ("Add", ["melspec", "eps"], ["shifted"], {}),
        ("Log", ["shifted"], ["y"], {})]


def _log_mel_case(name, signal, n_mel, flen, step, sr, lo, hi):
    return _case(name, "MelWeightMatrix", [
        ("signal", signal, "feed"), ("step", _i(step), "init"),
        ("win", np.hanning(flen).astype(F32), "init"),
        ("axes", _i([-1]), "init"), ("n_mel", _i(n_mel), "init"),
        ("n_dft", _i(flen), "init"), ("sr", _i(sr), "init"),
        ("lo", _f(lo), "init"), ("hi", _f(hi), "init"),
        ("eps", _f(1e-6), "init")],
        log_mel_nodes(), ["y"], kind="log_mel")


def _tones(seed, n, length, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / sr
    f = rng.uniform(200, 3000, (n, 1))
    return (0.3 * np.sin(2 * np.pi * f * t)
            + 0.01 * rng.standard_normal((n, length))).astype(F32)


CHAIN_CASES = [
    _log_mel_case("log_mel_featurizer_defaults", _tones(50, 3, 4000), 64,
                  400, 160, 16000, 125.0, 7600.0),
    _log_mel_case("log_mel_whisper_geometry", _tones(51, 2, 8000), 80, 400,
                  160, 16000, 125.0, 7600.0),
]

CASES = DFT_CASES + STFT_CASES + WINDOW_CASES + MEL_CASES + CHAIN_CASES


def by_name(name: str) -> dict:
    return next(c for c in CASES if c["name"] == name)


def graph(case: dict, graph_cls) -> bytes:
    """The case's graph, built with ``graph_cls`` (either package's
    ``GraphBuilder``)."""
    g = graph_cls(opset=case["opset"])
    for name, a, where in case["inputs"]:
        if where == "feed":
            g.add_input(name, a.dtype, list(a.shape))
        elif where == "feed_bf16":
            g.add_input(name, None)
        elif where == "init":
            g.add_initializer(name, a)
        else:
            g.add_node("Constant", [], outputs=[name], value=np.asarray(a))
    for op, ins, outs, attrs in case["nodes"]:
        g.add_node(op, list(ins), outputs=list(outs), **attrs)
    for o in case["outputs"]:
        g.add_output(o, np.float32, None)
    return g.to_bytes()


def feeds(case: dict) -> list:
    """The graph inputs as ``(array, bf16)`` pairs, in order: ``bf16``
    says the array's float32 values go in as bfloat16."""
    return [(a, where == "feed_bf16") for _, a, where in case["inputs"]
            if where.startswith("feed")]


def leaves(values) -> list:
    """Outputs as ``[(array, host, dtype name)]``: a tensor comes back as
    numpy with ``host`` False, a bfloat16 value widened to float32
    (exactly) under the name ``"bfloat16"``."""
    out = []
    for v in values:
        if hasattr(v, "detach"):                    # a torch tensor
            t = v.detach().cpu()
            name = str(t.dtype).replace("torch.", "")
            out.append(((t.float() if name == "bfloat16" else t).numpy(),
                        False, name))
            continue
        host = isinstance(v, (np.ndarray, np.generic))
        a = np.asarray(v)
        name = a.dtype.name
        out.append((a.astype(F32) if name == "bfloat16" else a, host, name))
    return out


def run(case: dict, import_model, graph_cls, device: str) -> list:
    """The port's outputs of the case on ``device`` (``import_model`` and
    ``graph_cls`` the port's) as :func:`leaves`; every feed goes in as a
    tensor on ``device``."""
    import torch

    fn = import_model(graph(case, graph_cls)).bind(device=device)
    args = []
    for a, bf16 in feeds(case):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        args.append(t.to(torch.bfloat16) if bf16 else t)
    return leaves(fn(*args))


def agree(case: dict, got: list, want: list) -> dict:
    """``got`` against ``want`` (:func:`leaves` of two runs; ``want``'s
    dtypes may be the reference's 32-bit ones where ``got``'s are 64-bit
    device values): the same outputs, host-ness, shapes and dtypes; every
    value bitwise where the case is ``"exact"``, within :data:`SPEC_TOL`
    (or :data:`HALF_TOL`) of each output's largest |value| where it is
    ``"spectrum"``, within :data:`LOG_MEL_TOL` where ``"log_mel"``.
    Returns ``{"ok", "max_abs_err", "max_rel_err"}``, the second the
    largest error over an output's largest |value|."""
    ok, err, rel = len(got) == len(want), 0.0, 0.0
    narrowed = {"float64": "float32", "int64": "int32"}
    for (g, gh, gn), (w, wh, wn) in zip(got, want):
        ok &= gh == wh and g.shape == w.shape and (
            gn == wn or (not wh and narrowed.get(gn) == wn))
        if not ok:
            break
        g = g.astype(w.dtype)
        if case["exact"] or g.dtype.kind != "f":
            bits = f"u{g.itemsize}" if g.dtype.kind == "f" else g.dtype
            ok &= bool(np.array_equal(g.view(bits), w.view(bits)))
            continue
        if not g.size:
            continue
        gap = np.abs(g.astype(F64) - w.astype(F64))
        scale = float(np.abs(w.astype(F64)).max())
        err = max(err, float(gap.max()))
        rel = max(rel, float(gap.max()) / max(scale, 1e-30))
        if case["kind"] == "log_mel":
            ok &= bool(np.allclose(g, w, rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL))
        else:
            ok &= float(gap.max()) <= HALF_TOL.get(wn, SPEC_TOL) * scale
    return {"ok": bool(ok), "max_abs_err": err, "max_rel_err": rel}
