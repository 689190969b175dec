"""The speech front end on the port: WAV parsing, the energy endpointer
and log-mel features on the card.

The counterpart of the local half of the reference package's
``cognitive/speech.py`` (itself the rebuild of ref: cognitive/src/main/
scala/com/microsoft/ml/spark/cognitive/AudioStreams.scala:17-94 and the
front half of SpeechToTextSDK.scala:431-509): the WAV is parsed with the
reference's format asserts (:class:`WavStream`), an energy endpointer
segments the PCM into utterances (:func:`segment_utterances`), and
:class:`AudioFeaturizer` computes log-mel features as an ONNX graph of the
importer's own ``STFT``, ``ReduceSumSquare``, ``MelWeightMatrix``,
``MatMul``, ``Add`` and ``Log`` ops, run by the
:class:`~synapseml_tpu_torch.runtime.executor.BatchedExecutor`: framing as
a strided view, one batched cuFFT real transform, the mel projection as
one cuBLAS matmul. :func:`wav_to_utterance_rows` chains the three and
:func:`utterance_feature_batch` pads the rows for a sequence model (the
recurrent ``CNTKModel``, for one). ``AudioFeaturizer.transform`` and
:func:`wav_to_utterance_rows` run on the card unless ``device="cpu"`` is
asked for, and raise without CUDA.

Not here: ``SpeechToTextSDK``, the service client that sends each
utterance to the recognition endpoint, needs the port of
``cognitive/base.py`` and of ``io/http.py``'s retrying client (ROADMAP
Queue 1 item 6f); importing it raises ``ImportError`` naming that item.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from synapseml_tpu_torch import device as device_policy
from synapseml_tpu_torch.core.param import Param
from synapseml_tpu_torch.core.pipeline import Transformer
from synapseml_tpu_torch.data.table import Table

NOT_PORTED = ("SpeechToTextSDK",)
_NOT_PORTED_MSG = (
    "{name} (the speech service client) is not ported yet: it needs "
    "cognitive/base.py and io/http.py's client, ROADMAP Queue 1 item 6f; "
    "the local front end (WavStream, segment_utterances, AudioFeaturizer, "
    "wav_to_utterance_rows) is")


def __getattr__(name: str):
    if name in NOT_PORTED:
        raise ImportError(_NOT_PORTED_MSG.format(name=name))
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class WavStream:
    """Parsed PCM WAV (ref AudioStreams.scala:38-83: RIFF/WAVE/fmt/data
    walk with PCM, mono, 16 kHz, 16-bit asserts; extended fmt chunks are
    skipped)."""

    def __init__(self, wav_bytes: bytes, require_canonical: bool = True):
        b = memoryview(bytes(wav_bytes))
        if len(b) < 12 or bytes(b[0:4]) != b"RIFF" or bytes(b[8:12]) != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        pos = 12
        fmt = None
        data = None
        while pos + 8 <= len(b):
            tag = bytes(b[pos:pos + 4])
            size = struct.unpack_from("<I", b, pos + 4)[0]
            body = b[pos + 8: pos + 8 + size]
            if tag == b"fmt ":
                fmt = body
            elif tag == b"data":
                data = body
            pos += 8 + size + (size & 1)  # chunks are word-aligned
        if fmt is None or data is None:
            raise ValueError("WAV is missing fmt/data chunks")
        (self.format_tag, self.channels, self.sample_rate, _, _,
         self.bits_per_sample) = struct.unpack_from("<HHIIHH", fmt, 0)
        if self.format_tag != 1:
            raise ValueError("PCM required (formatTag == 1)")
        if require_canonical:
            # the reference's stream asserts (AudioStreams.scala:64-66)
            if self.channels != 1:
                raise ValueError("file needs to be single channel")
            if self.sample_rate != 16000:
                raise ValueError("file needs to have 16000 samples per second")
            if self.bits_per_sample != 16:
                raise ValueError("file needs to have 16 bits per sample")
        self.pcm = np.frombuffer(data, dtype="<i2")
        if self.channels > 1:
            self.pcm = self.pcm.reshape(-1, self.channels)[:, 0]

    def chunks(self, chunk_ms: int = 100):
        """Pull-stream view: successive PCM chunks, the SDK read() loop."""
        step = max(1, self.sample_rate * chunk_ms // 1000)
        for i in range(0, len(self.pcm), step):
            yield self.pcm[i:i + step]


def pcm_to_wav(pcm: np.ndarray, sample_rate: int = 16000) -> bytes:
    """Canonical 16-bit mono WAV bytes for one utterance's request."""
    pcm = np.asarray(pcm, dtype="<i2")
    raw = pcm.tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(raw), b"WAVE", b"fmt ",
        16, 1, 1, sample_rate, sample_rate * 2, 2, 16, b"data", len(raw))
    return hdr + raw


def segment_utterances(pcm: np.ndarray, sample_rate: int,
                       frame_ms: int = 30, silence_ms: int = 300,
                       min_utterance_ms: int = 120,
                       energy_threshold: float = 0.01,
                       padding_ms: int = 60) -> List[Tuple[int, int]]:
    """Energy endpointer: (start_sample, end_sample) per utterance.

    Stands in for the service-side segmentation behind the SDK's
    ``recognized`` events: a frame is speech when its RMS exceeds
    ``energy_threshold`` (relative to int16 full scale); utterances end
    after ``silence_ms`` of non-speech and carry ``padding_ms`` context.
    """
    if len(pcm) == 0:
        return []
    x = pcm.astype(np.float32) / 32768.0
    frame = max(1, sample_rate * frame_ms // 1000)
    n_frames = (len(x) + frame - 1) // frame
    pad = n_frames * frame - len(x)
    rms = np.sqrt(np.mean(
        np.pad(x, (0, pad)).reshape(n_frames, frame) ** 2, axis=1))
    speech = rms > energy_threshold
    gap_frames = max(1, silence_ms // frame_ms)
    segs: List[Tuple[int, int]] = []
    start = None
    silence_run = 0
    for i, s in enumerate(speech):
        if s:
            if start is None:
                start = i
            silence_run = 0
        elif start is not None:
            silence_run += 1
            if silence_run >= gap_frames:
                segs.append((start, i - silence_run + 1))
                start, silence_run = None, 0
    if start is not None:
        segs.append((start, n_frames))
    pad_f = padding_ms // frame_ms
    out = []
    for s, e in segs:
        if (e - s) * frame_ms < min_utterance_ms:
            continue
        out.append((max(0, (s - pad_f)) * frame,
                    min(len(pcm), (e + pad_f) * frame)))
    return out


class AudioFeaturizer(Transformer):
    """Log-mel spectrogram features computed on the card.

    The transformer composes an ONNX graph from the importer's own STFT /
    MelWeightMatrix / ReduceSumSquare / MatMul / Log ops and runs it
    through the BatchedExecutor: framing, one batched real FFT and the mel
    projection as one matmul. The window is ``np.hanning``'s symmetric
    one, the filterbank the HTK mel scale, and the log takes
    ``log_offset`` inside, as in the reference.

    Input column: 1-D float waveforms (object column of arrays, or a 2-D
    equal-length column) or raw WAV bytes (parsed via WavStream's format
    asserts). Clips in a batch pad to the longest, whose frame count is
    bucketed to a power of two (one program a bucket, warmed by
    :meth:`warmup`); emitted frame counts follow each clip's true length.
    ``transform(table, device="cuda")`` runs on the card and raises
    without CUDA; ``device="cpu"`` runs the same path on the CPU.
    """

    input_col = Param("waveform / wav-bytes column", default="audio")
    output_col = Param("log-mel output column", default="features")
    sample_rate = Param("sample rate when input is raw waveform",
                        default=16000)
    frame_length = Param("window size in samples", default=400)
    frame_step = Param("hop in samples", default=160)
    num_mel_bins = Param("mel filter count", default=64)
    lower_hz = Param("mel filterbank lower edge", default=125.0)
    upper_hz = Param("mel filterbank upper edge", default=7600.0)
    log_offset = Param("epsilon inside the log", default=1e-6)

    def _graph_bytes(self, sr: int) -> bytes:
        from synapseml_tpu_torch.onnx.builder import GraphBuilder

        flen, step = int(self.frame_length), int(self.frame_step)
        g = GraphBuilder(name="log_mel", opset=17)
        sig = g.add_input("signal", np.float32, ["N", "L"])
        win = g.add_initializer(
            "win", np.hanning(flen).astype(np.float32))
        stft = g.add_node(
            "STFT", [sig, g.add_initializer(
                "step", np.asarray(step, np.int64)), win], onesided=1)
        power = g.add_node(
            "ReduceSumSquare",
            [stft, g.add_initializer("axes", np.asarray([-1], np.int64))],
            keepdims=0)
        mel = g.add_node("MelWeightMatrix", [
            g.add_initializer("nmel", np.asarray(
                int(self.num_mel_bins), np.int64)),
            g.add_initializer("ndft", np.asarray(flen, np.int64)),
            g.add_initializer("sr", np.asarray(sr, np.int64)),
            g.add_initializer("lo", np.asarray(
                float(self.lower_hz), np.float32)),
            g.add_initializer("hi", np.asarray(
                float(self.upper_hz), np.float32))])
        melspec = g.add_node("MatMul", [power, mel])
        logmel = g.add_node("Log", [g.add_node("Add", [
            melspec, g.add_initializer("eps", np.asarray(
                float(self.log_offset), np.float32))])])
        g.add_output(logmel, np.float32, None)
        return g.to_bytes()

    def _waveform(self, v) -> Tuple[np.ndarray, int]:
        if isinstance(v, (bytes, bytearray)):
            ws = WavStream(bytes(v))
            return ws.pcm.astype(np.float32) / 32768.0, ws.sample_rate
        return np.asarray(v, np.float32), int(self.sample_rate)

    def _pieces(self, sr: int, device):
        """The imported graph and its executor for rate ``sr`` on
        ``device``: one configuration kept at a time, as in the
        reference."""
        from synapseml_tpu_torch.onnx.importer import import_model
        from synapseml_tpu_torch.runtime.executor import BatchedExecutor

        dev = device_policy.resolve(device)
        cache = self.__dict__.setdefault("_audio_cache", {})
        key = (sr, int(self.frame_length), int(self.frame_step),
               int(self.num_mel_bins), float(self.lower_hz),
               float(self.upper_hz), float(self.log_offset), dev)
        if key not in cache:
            graph = import_model(self._graph_bytes(sr))
            cache.clear()  # one device-resident config at a time
            cache[key] = (graph, BatchedExecutor(
                graph.apply, device=dev, bound_args=(graph.params,)))
        return cache[key]

    def padded_length(self, max_len: int) -> int:
        """The samples a batch whose longest clip has ``max_len`` is
        padded to: its frame count rounded up to a power of two, so every
        length meets one of a few programs (the executor buckets only the
        batch axis); trailing padding is harmless because each row is
        trimmed to its true frame count."""
        flen, step = int(self.frame_length), int(self.frame_step)
        max_len = max(flen, int(max_len))
        frames = 1 + (max_len - flen) // step \
            + (1 if (max_len - flen) % step else 0)
        frames_b = 1 << max(frames - 1, 0).bit_length() if frames > 1 \
            else 1
        return flen + (frames_b - 1) * step

    def warmup(self, clip_samples: Sequence[int], buckets: Sequence[int],
               device=device_policy.DEFAULT_DEVICE):
        """Capture the featurization of each batch size in ``buckets``
        (rows, the executor's power-of-two buckets) at the frame bucket of
        each longest-clip length in ``clip_samples``, at the featurizer's
        ``sample_rate``, as CUDA graphs (on
        the CPU, warm the eager function): see
        :meth:`synapseml_tpu_torch.runtime.executor.BatchedExecutor.warmup`.
        Each capture follows one eager run of its shape, so cuFFT's plan
        and work area are made outside the capture. Returns one
        :class:`~synapseml_tpu_torch.runtime.compile_cache.WarmupReport`
        over every signature."""
        from synapseml_tpu_torch.runtime.compile_cache import WarmupReport

        _, executor = self._pieces(int(self.sample_rate), device)
        report = WarmupReport()
        for n in sorted({self.padded_length(n) for n in clip_samples}):
            part = executor.warmup([((n,), np.float32)], buckets=buckets)
            report.entries += part.entries
            report.errors += part.errors
        return report

    def _transform(self, table: Table, device) -> Table:
        device_policy.resolve(device)
        vals = table[self.input_col]
        waves, srs = zip(*[self._waveform(v) for v in vals]) \
            if table.num_rows else ((), ())
        if len(set(srs)) > 1:
            raise ValueError(
                f"AudioFeaturizer: mixed sample rates {sorted(set(srs))} "
                "in one batch")
        sr = srs[0] if srs else int(self.sample_rate)
        flen, step = int(self.frame_length), int(self.frame_step)
        _, executor = self._pieces(sr, device)
        max_len = max(len(w) for w in waves) if waves else flen
        batch = np.zeros((table.num_rows, self.padded_length(max_len)),
                         np.float32)
        for i, w in enumerate(waves):
            batch[i, :len(w)] = w
        (feats,) = executor(batch)
        out = np.empty(table.num_rows, dtype=object)
        for i, w in enumerate(waves):
            n_frames = 1 + (len(w) - flen) // step if len(w) >= flen else 0
            out[i] = np.asarray(feats[i][:n_frames], np.float32)
        return table.with_column(self.output_col, out)


def wav_to_utterance_rows(wav_bytes: bytes,
                          featurizer: Optional[AudioFeaturizer] = None,
                          device=device_policy.DEFAULT_DEVICE,
                          **endpointer_kw) -> Table:
    """One call from WAV bytes to per-utterance feature rows — the front
    half of the reference's speech scenario (SpeechToTextSDK.scala:431 +
    AudioStreams.scala:94: stream -> segment -> per-utterance requests),
    with featurization as local compute on ``device`` (the card by
    default; raises without CUDA) instead of a service call.

    Parses the WAV (canonical-format asserts), segments utterances with
    the energy endpointer, and runs the log-mel :class:`AudioFeaturizer`
    over ONE batch of all utterances. Returns a Table with per-utterance
    rows: ``utterance`` (index), ``t_start`` / ``t_end`` (seconds),
    ``audio`` (float waveform) and the featurizer's output column (log-mel
    ``[frames, num_mel_bins]``).
    """
    device_policy.resolve(device)
    ws = WavStream(bytes(wav_bytes))
    segs = segment_utterances(ws.pcm, ws.sample_rate, **endpointer_kw)
    feat = featurizer or AudioFeaturizer()
    audio = np.empty(len(segs), dtype=object)
    for i, (s, e) in enumerate(segs):
        audio[i] = ws.pcm[s:e].astype(np.float32) / 32768.0
    table = Table({
        "utterance": np.arange(len(segs), dtype=np.int64),
        "t_start": np.asarray([s / ws.sample_rate for s, _ in segs],
                              np.float64),
        "t_end": np.asarray([e / ws.sample_rate for _, e in segs],
                            np.float64),
        str(feat.input_col): audio,
    })
    if not segs:
        return table.with_column(str(feat.output_col),
                                 np.empty(0, dtype=object))
    if int(feat.sample_rate) != ws.sample_rate:
        # copy() scopes the rate override to this call — mutating a
        # shared featurizer would silently re-rate the caller's other
        # pipelines. Matching-rate calls (the streaming common case)
        # keep the caller's instance and its warm executor.
        feat = feat.copy(sample_rate=ws.sample_rate)
    return feat.transform(table, device)


def utterance_feature_batch(rows: Table, feature_col: str = "features"):
    """Pad per-utterance ``[frames, D]`` features into one ``[U, T, D]``
    batch for a sequence model (one device placement, static shapes);
    returns ``(batch, frame_counts)`` — trim each row's output back to
    its true frame count with ``frame_counts``."""
    feats = [np.asarray(f, np.float32) for f in rows[feature_col]]
    n_frames = np.asarray([len(f) for f in feats], np.int64)
    if not len(feats):
        return np.zeros((0, 0, 0), np.float32), n_frames
    batch = np.zeros((len(feats), int(n_frames.max()), feats[0].shape[1]),
                     np.float32)
    for i, f in enumerate(feats):
        batch[i, :len(f)] = f
    return batch, n_frames
