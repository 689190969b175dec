"""The port's ONNX signal ops against the JAX package's importer, on the
CPU: ``DFT``, ``STFT``, ``HannWindow``, ``HammingWindow``,
``BlackmanWindow`` and ``MelWeightMatrix``.

The cases are ``tests/fixtures/signal_op_cases.py``'s (the card runs the
same ones in ``chip_smoke.py`` and ``test_torch_cuda.py``): the same
graph bytes and seeded inputs through both importers, the port bound on
the CPU, the reference through its eager bound forward. Tolerance: the
windows and ``MelWeightMatrix`` bitwise, with the reference's host-ness
(the windows host numpy, the filterbank a device value); ``DFT`` and
``STFT`` float32 spectra within 1e-5 of each output's largest |value|, a
float16 or bfloat16 one within one step of its type; the log-mel chain
within rtol = atol = 1e-3; every refusal of the reference raises the
same exception type in the port.

Then the places where the port copies the reference and not the ONNX
spec, or departs from the reference (ROADMAP Queue 3), each held on its
own, and the constants built once a node.
"""
import os
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
import signal_op_cases as cases  # noqa: E402

NAMES = ("DFT", "STFT", "HannWindow", "HammingWindow", "BlackmanWindow",
         "MelWeightMatrix")


def _port(case):
    return cases.run(case, import_model, GraphBuilder, "cpu")


def _reference(case):
    """The JAX importer's outputs of the case, as :func:`cases.run` gives
    the port's."""
    fn = jax_import(cases.graph(case, JaxBuilder)).bind()
    return cases.leaves(fn(*[jnp.asarray(a, jnp.bfloat16) if bf16
                             else jnp.asarray(a)
                             for a, bf16 in cases.feeds(case)]))


def test_every_name_is_registered_and_covered():
    assert set(NAMES) <= set(importer._REGISTRY)
    assert {c["op"] for c in cases.CASES} == set(NAMES)
    reached = {op for c in cases.CASES for op, *_ in c["nodes"]}
    assert set(NAMES) <= reached
    names = [c["name"] for c in cases.CASES]
    assert len(names) == len(set(names)) and len(names) >= 90
    refused = {c["op"] for c in cases.CASES if c["raises"]}
    assert refused == {"DFT", "STFT"}


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


def test_float32_spectra_gap_is_well_inside_the_bound():
    """The measured gap of every float32 ``DFT``/``STFT`` output: the
    largest error over the output's largest |value|, across the cases,
    stays under a tenth of the 1e-5 bound (it is a few float32 roundings
    of two FFT libraries)."""
    worst = max(cases.agree(c, _port(c), _reference(c))["max_rel_err"]
                for c in cases.CASES if c["kind"] == "spectrum"
                and not c["raises"] and not any(
                    where == "feed_bf16" or np.asarray(a).dtype == np.float16
                    for _, a, where in c["inputs"]))
    assert 0.0 < worst < 1e-6, worst


# -- the reference's departures from the spec, copied ---------------------

def test_opset20_dft_reads_an_axis_attribute():
    """Opset 20 moved ``axis`` to an input; the reference still reads an
    ``axis`` attribute there before falling back to -2, and so does the
    port: the attribute's axis 1, not the default -2."""
    case = cases.by_name("dft_opset20_reads_an_axis_attribute")
    (got, _, _), = _port(case)
    (want, _, _), = _reference(case)
    x = case["inputs"][0][1]
    assert got.shape == want.shape == (2, 6, 5, 2)
    spec = np.fft.fft(x[..., 0] + 1j * x[..., 1], axis=1)
    np.testing.assert_allclose(got[..., 0], spec.real, atol=1e-5)


@pytest.mark.parametrize("name", ["stft_shorter_than_a_frame_is_empty",
                                  "stft_shorter_than_a_frame_two_sided"])
def test_signal_shorter_than_a_frame_gives_an_empty_frame_axis(name):
    """``1 + (L - frame_length) // step`` is 0 or less: the reference's
    ``jnp.arange`` gives no frame, where ``Tensor.unfold`` would raise."""
    case = cases.by_name(name)
    (got, host, dt), = _port(case)
    (want, _, _), = _reference(case)
    assert got.shape == want.shape and got.shape[1] == 0
    assert not host and dt == "float32"


@pytest.mark.parametrize("name,dtype", [
    ("dft_float16_real_keeps_float16", "float16"),
    ("dft_float16_onesided_keeps_float16", "float16"),
    ("dft_bfloat16_real_keeps_bfloat16", "bfloat16")])
def test_half_precision_transforms_in_complex64(name, dtype):
    """torch's FFT has no float16 on the CPU and, on the card, float16
    only at power-of-two lengths (20 is not); the port widens to
    complex64 as ``jnp.fft`` does and casts the spectrum back."""
    case = cases.by_name(name)
    (got, _, got_dt), = _port(case)
    (want, _, want_dt), = _reference(case)
    assert got_dt == want_dt == dtype
    a = case["inputs"][0][1].astype(np.float64)
    spec = (np.fft.rfft(a[..., 0], axis=1) if "onesided" in name
            else np.fft.fft(a[..., 0], axis=1))
    scale = np.abs(spec).max()
    assert np.abs(got[..., 0] - spec.real).max() <= \
        cases.HALF_TOL[dtype] * scale


# -- the port's deliberate departures --------------------------------------

@pytest.mark.parametrize("name", ["dft_float64_real",
                                  "dft_float64_complex_inverse",
                                  "stft_float64_signal",
                                  "mel_output_float64"])
def test_64_bit_outputs_keep_the_spec_type_with_the_references_values(name):
    """With JAX's 64-bit mode off the reference narrows a float64 signal
    and ``output_datatype`` 11 to float32; the port keeps float64 and
    holds the reference's float32 values (computed in float32, widened)."""
    case = cases.by_name(name)
    (got, _, got_dt), = _port(case)
    (want, _, want_dt), = _reference(case)
    assert got_dt == "float64" and want_dt == "float32"
    np.testing.assert_array_equal(got.astype(np.float32).astype(np.float64),
                                  got)
    if case["exact"]:
        np.testing.assert_array_equal(got.astype(np.float32), want)
    else:
        gap = np.abs(got - want).max()
        assert gap <= cases.SPEC_TOL * np.abs(want).max()


# -- where the values live and how often they are made --------------------

@pytest.mark.parametrize("op,a0", [("HannWindow", 0.5),
                                   ("HammingWindow", 25.0 / 46.0)])
def test_windows_are_host_constants(op, a0):
    """The windows stay host numpy, as the reference's; Hamming takes the
    spec's 25/46, not numpy's 0.54."""
    case = cases.by_name(f"{op.lower()}_symmetric_16")
    fn = import_model(cases.graph(case, GraphBuilder)).bind(device="cpu")
    (w,) = fn()
    assert isinstance(w, np.ndarray) and w.dtype == np.float32
    ref = a0 - (1 - a0) * np.cos(2 * np.pi * np.arange(16) / 15)
    np.testing.assert_allclose(w, ref, atol=1e-7)


def test_mel_weight_matrix_is_built_once_a_node_and_device():
    """The filterbank is a device value made on the host: built and copied
    once a node and device (``importer._table``), so a second run and a
    CUDA-graph capture copy nothing."""
    case = cases.by_name("mel_whisper_80")
    graph = import_model(cases.graph(case, GraphBuilder))
    fn = graph.bind(device="cpu")
    (a,), (b,) = fn(), fn()
    assert isinstance(a, torch.Tensor) and a.shape == (201, 80)
    assert a.data_ptr() == b.data_ptr()
    ctx = graph._nodes[0][1]
    assert len(ctx.attrs["__tables__"]) == 1


def test_a_host_window_is_copied_once_a_node():
    """A window from a ``HannWindow`` node is a host value each run; STFT
    copies it to the device once and reuses the copy."""
    case = cases.by_name("stft_window_from_hann_window")
    graph = import_model(cases.graph(case, GraphBuilder))
    fn = graph.bind(device="cpu")
    x = torch.from_numpy(cases.feeds(case)[0][0])
    first, second = fn(x)[0], fn(x)[0]
    np.testing.assert_array_equal(first.numpy(), second.numpy())
    stft = next(c for _, c, _, _ in graph._nodes if c.op_type == "STFT")
    assert len(stft.attrs["__tables__"]) == 1


def test_stft_equals_torch_stft_without_centering():
    """The framing is ``torch.stft(center=False)``'s: the port's STFT of
    the Whisper-geometry case against torch's own."""
    case = cases.by_name("stft_whisper_geometry")
    (got, _, _), = _port(case)
    x = torch.from_numpy(case["inputs"][0][1])
    win = torch.from_numpy(case["inputs"][2][1])
    want = torch.view_as_real(torch.stft(
        x, n_fft=400, hop_length=160, window=win, center=False,
        onesided=True, return_complex=True)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 23, 201, 2)
    assert np.abs(got - want).max() <= cases.SPEC_TOL * np.abs(want).max()
