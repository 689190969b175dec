"""The port's speech front end (``synapseml_tpu_torch.cognitive``) against
the JAX package's, on the CPU: ``WavStream``, ``pcm_to_wav``,
``segment_utterances``, ``AudioFeaturizer``, ``wav_to_utterance_rows``
and ``utterance_feature_batch``, then the chain into the recurrent
``CNTKModel``.

Tolerance: the WAV parsing, the WAV bytes, the endpointer's segments and
the padded batches equal; the log-mel features within rtol = atol = 1e-3,
the reference's own gate (``tests/test_cognitive.py:696``), which the
committed WAV meets with a largest gap of 9.0e-4, 6% of that bound (near
the log floor, where float32 power sums of two FFT libraries part); the chain's mean
states within 1e-4 (at hidden 300, where they are determined:
``speech_clips.held_means``). At Whisper's geometry the port is held to
the JAX fixture ``speech_io.npz`` (``tests/fixtures/make_speech_fixture.py``).
"""
import os
import sys

import numpy as np
import pytest
import torch

from synapseml_tpu.cognitive import speech as jsp
from synapseml_tpu.data.table import Table as JaxTable
from synapseml_tpu.dl.cntk import CNTKModel as JaxCNTKModel
from synapseml_tpu.dl.cntk_format import build_optimized_rnn_model
from synapseml_tpu_torch import cognitive
from synapseml_tpu_torch.cognitive import speech as sp
from synapseml_tpu_torch.data.table import Table
from synapseml_tpu_torch.dl.cntk import CNTKModel

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
sys.path.insert(0, FIXTURES)
import speech_clips as sc  # noqa: E402

WAV = os.path.join(FIXTURES, "utterances.wav")
LOG_MEL_TOL = 1e-3
STATE_TOL = 1e-4


def _wav_bytes():
    with open(WAV, "rb") as fh:
        return fh.read()


def _multi_utterance_wav(module, n_utt=3, sr=16000, utt_ms=400, gap_ms=500):
    """``tests/test_cognitive.py``'s input: tone / silence / tone ..."""
    t = np.arange(sr * utt_ms // 1000)
    tone = (0.3 * np.sin(2 * np.pi * 440 * t / sr) * 32767).astype(np.int16)
    gap = np.zeros(sr * gap_ms // 1000, np.int16)
    parts = [gap]
    for _ in range(n_utt):
        parts += [tone, gap]
    return module.pcm_to_wav(np.concatenate(parts), sr)


def _ragged():
    """``tests/test_cognitive.py``'s ragged clips: a 440 Hz tone and a
    noisy 1,200 Hz one of different lengths."""
    sr = 16000
    rng = np.random.default_rng(0)
    t1 = np.sin(2 * np.pi * 440 * np.arange(8000) / sr).astype(np.float32)
    t2 = (0.5 * np.sin(2 * np.pi * 1200 * np.arange(5000) / sr)
          + 0.01 * rng.normal(size=5000)).astype(np.float32)
    return t1, t2


def _gap(a, b):
    """The largest gap and its share of the allclose bound."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bound = LOG_MEL_TOL + LOG_MEL_TOL * np.abs(b)
    return float(np.abs(a - b).max()), float((np.abs(a - b) / bound).max())


# -- WavStream, pcm_to_wav, segment_utterances: copies ----------------------

@pytest.mark.parametrize("n_utt", [1, 3])
def test_wav_stream_parses_as_the_reference(n_utt):
    wav = _multi_utterance_wav(sp, n_utt)
    assert wav == _multi_utterance_wav(jsp, n_utt)
    mine, theirs = sp.WavStream(wav), jsp.WavStream(wav)
    for key in ("format_tag", "channels", "sample_rate", "bits_per_sample"):
        assert getattr(mine, key) == getattr(theirs, key)
    np.testing.assert_array_equal(mine.pcm, theirs.pcm)
    assert [c.tolist() for c in mine.chunks(100)] == \
        [c.tolist() for c in theirs.chunks(100)]
    assert sum(len(c) for c in mine.chunks(100)) == len(mine.pcm)


@pytest.mark.parametrize("blob,match", [
    (lambda m: m.pcm_to_wav(np.zeros(100, np.int16), 8000), "16000"),
    (lambda m: b"nonsense", "RIFF"),
    (lambda m: b"RIFF\x04\x00\x00\x00WAVE", "missing"),
    (lambda m: m.pcm_to_wav(np.zeros(10, np.int16))[:36], "missing")])
def test_wav_stream_refuses_as_the_reference(blob, match):
    with pytest.raises(ValueError, match=match) as mine:
        sp.WavStream(blob(sp))
    with pytest.raises(ValueError) as theirs:
        jsp.WavStream(blob(jsp))
    assert str(mine.value) == str(theirs.value)


def test_committed_wav_and_its_pcm_bytes_are_the_references():
    ws = sp.WavStream(_wav_bytes())
    assert (ws.sample_rate, ws.channels, ws.bits_per_sample) == \
        (16000, 1, 16)
    assert sp.pcm_to_wav(ws.pcm) == jsp.pcm_to_wav(ws.pcm) == _wav_bytes()
    rng = np.random.default_rng(3)
    pcm = rng.integers(-32768, 32767, 999).astype(np.int16)
    assert sp.pcm_to_wav(pcm, 22050) == jsp.pcm_to_wav(pcm, 22050)


@pytest.mark.parametrize("source", ["committed", "multi", "zeros", "cut",
                                    "short_silence"])
def test_segment_utterances_are_the_references(source):
    pcm = {"committed": lambda: sp.WavStream(_wav_bytes()).pcm,
           "multi": lambda: sp.WavStream(_multi_utterance_wav(sp)).pcm,
           "zeros": lambda: np.zeros(16000, np.int16),
           "cut": lambda: sc.long_pcm(sc.CUT_S),
           "short_silence": lambda: np.zeros(0, np.int16)}[source]()
    for kw in ({}, {"silence_ms": 120, "padding_ms": 0},
               {"energy_threshold": 0.2, "min_utterance_ms": 30}):
        assert sp.segment_utterances(pcm, 16000, **kw) == \
            jsp.segment_utterances(pcm, 16000, **kw)


# -- AudioFeaturizer -------------------------------------------------------

def test_log_mel_of_the_committed_wav_matches_jax():
    mine = sp.wav_to_utterance_rows(_wav_bytes(), device="cpu")
    theirs = jsp.wav_to_utterance_rows(_wav_bytes())
    assert mine.num_rows == theirs.num_rows == 3
    for key in ("utterance", "t_start", "t_end"):
        np.testing.assert_array_equal(mine[key], theirs[key])
    worst = 0.0
    for a, b in zip(mine["features"], theirs["features"]):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL)
        worst = max(worst, _gap(a, b)[1])
    assert worst < 0.25, worst          # measured: 6.3% of the bound


def test_log_mel_of_ragged_clips_and_wav_bytes_matches_jax():
    t1, t2 = _ragged()
    kw = dict(frame_length=400, frame_step=160, num_mel_bins=24,
              sample_rate=16000)
    audio = np.array([t1, t2], dtype=object)
    mine = sp.AudioFeaturizer(**kw).transform(Table({"audio": audio}),
                                              device="cpu")["features"]
    theirs = jsp.AudioFeaturizer(**kw).transform(
        JaxTable({"audio": audio}))["features"]
    assert [f.shape for f in mine] == [f.shape for f in theirs] == \
        [(48, 24), (29, 24)]
    for a, b in zip(mine, theirs):
        np.testing.assert_allclose(a, b, rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL)
    wav = np.array([sp.pcm_to_wav((t1 * 32767).astype(np.int16))],
                   dtype=object)
    a = sp.AudioFeaturizer(**kw).transform(Table({"audio": wav}),
                                           device="cpu")["features"][0]
    b = jsp.AudioFeaturizer(**kw).transform(
        JaxTable({"audio": wav}))["features"][0]
    np.testing.assert_allclose(a, b, rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL)


def test_clips_shorter_than_a_frame_give_no_frames():
    audio = np.array([np.ones(100, np.float32), np.ones(600, np.float32)],
                     dtype=object)
    mine = sp.AudioFeaturizer().transform(Table({"audio": audio}),
                                          device="cpu")["features"]
    theirs = jsp.AudioFeaturizer().transform(
        JaxTable({"audio": audio}))["features"]
    assert [f.shape for f in mine] == [f.shape for f in theirs] == \
        [(0, 64), (2, 64)]


def test_mixed_sample_rates_are_refused_as_the_reference():
    wavs = np.array([sp.pcm_to_wav(np.zeros(800, np.int16)),
                     np.zeros(800, np.float32)], dtype=object)
    feat = sp.AudioFeaturizer(sample_rate=8000)
    with pytest.raises(ValueError, match="mixed sample rates") as mine:
        feat.transform(Table({"audio": wavs}), device="cpu")
    with pytest.raises(ValueError) as theirs:
        jsp.AudioFeaturizer(sample_rate=8000).transform(
            JaxTable({"audio": wavs}))
    assert str(mine.value) == str(theirs.value)


def test_frame_counts_bucket_to_a_power_of_two():
    feat = sp.AudioFeaturizer(**sc.WHISPER_FEATURIZER)
    assert feat.padded_length(sc.N_SAMPLES) == 400 + 4095 * 160
    assert feat.padded_length(400) == 400
    assert feat.padded_length(401) == 560
    assert feat.padded_length(10) == 400


def test_one_configuration_is_kept_at_a_time():
    feat = sp.AudioFeaturizer()
    audio = np.array([np.ones(1000, np.float32)], dtype=object)
    feat.transform(Table({"audio": audio}), device="cpu")
    first = feat.__dict__["_audio_cache"]
    (key,) = first
    feat.set(num_mel_bins=32)
    feat.transform(Table({"audio": audio}), device="cpu")
    (other,) = feat.__dict__["_audio_cache"]
    assert other != key and other[3] == 32


def test_transform_runs_on_the_card_by_default():
    """No device argument means the card: where CUDA is absent, the
    featurizer and the WAV path raise instead of running on the CPU."""
    audio = np.array([np.ones(1000, np.float32)], dtype=object)
    if torch.cuda.is_available():
        feat = sp.AudioFeaturizer()
        feat.transform(Table({"audio": audio}))
        (_, executor), = feat.__dict__["_audio_cache"].values()
        assert executor.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.AudioFeaturizer().transform(Table({"audio": audio}))
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.wav_to_utterance_rows(_wav_bytes())
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.wav_to_utterance_rows(sp.pcm_to_wav(np.zeros(1600, np.int16)))


def test_warm_featurizer_serves_its_eager_bits():
    """``warmup`` warms each (frame bucket, batch bucket) signature; on
    the CPU a warm entry is the eager function, so the features equal the
    eager featurizer's bit for bit."""
    t1, t2 = _ragged()
    audio = np.array([t1, t2], dtype=object)
    warm = sp.AudioFeaturizer(num_mel_bins=24)
    report = warm.warmup([len(t1), 3000], buckets=[8], device="cpu")
    assert [e["status"] for e in report.entries] == ["compiled"] * 2
    assert [e["sig"][0][0] for e in report.entries] == [(8, 5360), (8, 10480)]
    a = warm.transform(Table({"audio": audio}), device="cpu")["features"]
    b = sp.AudioFeaturizer(num_mel_bins=24).transform(
        Table({"audio": audio}), device="cpu")["features"]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.view(np.uint32), y.view(np.uint32))
    (_, executor), = warm.__dict__["_audio_cache"].values()
    assert executor._aot_hits == 1


# -- wav_to_utterance_rows, utterance_feature_batch -------------------------

def test_a_featurizer_at_another_rate_is_copied_not_changed():
    feat = sp.AudioFeaturizer(sample_rate=8000, num_mel_bins=16,
                              output_col="mel")
    rows = sp.wav_to_utterance_rows(_wav_bytes(), feat, device="cpu")
    assert feat.sample_rate == 8000 and "_audio_cache" not in feat.__dict__
    theirs = jsp.wav_to_utterance_rows(
        _wav_bytes(), jsp.AudioFeaturizer(sample_rate=8000,
                                          num_mel_bins=16,
                                          output_col="mel"))
    for a, b in zip(rows["mel"], theirs["mel"]):
        np.testing.assert_allclose(a, b, rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL)


def test_silence_gives_no_rows_with_the_feature_column():
    silence = sp.pcm_to_wav(np.zeros(16000, "<i2"))
    mine = sp.wav_to_utterance_rows(silence, device="cpu")
    theirs = jsp.wav_to_utterance_rows(silence)
    assert mine.num_rows == theirs.num_rows == 0
    assert mine.columns == theirs.columns
    batch, n = sp.utterance_feature_batch(mine)
    assert batch.shape == (0, 0, 0) and n.shape == (0,)


def test_utterance_feature_batch_pads_as_the_reference():
    rng = np.random.default_rng(5)
    feats = np.empty(3, dtype=object)
    for i, n in enumerate((4, 9, 1)):
        feats[i] = rng.standard_normal((n, 6)).astype(np.float32)
    mine = sp.utterance_feature_batch(Table({"features": feats}))
    theirs = jsp.utterance_feature_batch(JaxTable({"features": feats}))
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)


def test_chain_into_a_small_bilstm_matches_jax():
    """``tests/test_audio_pipeline.py``'s chain (64 mel bins, hidden 8) in
    both packages: mean states within 1e-4."""
    blob = build_optimized_rnn_model(64, 8, bidirectional=True, cell="lstm",
                                     seed=11)
    mine, _, n_mine = sc.chain_states(
        CNTKModel(model_bytes=blob),
        sp.wav_to_utterance_rows(_wav_bytes(), device="cpu"),
        sp.utterance_feature_batch, Table, device="cpu")
    theirs, _, n_theirs = sc.chain_states(
        JaxCNTKModel(model_bytes=blob),
        jsp.wav_to_utterance_rows(_wav_bytes()),
        jsp.utterance_feature_batch, JaxTable)
    np.testing.assert_array_equal(n_mine, n_theirs)
    assert mine.shape == (3, 16)
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=STATE_TOL)
    assert np.abs(mine[0] - mine[1]).max() > 1e-3


# -- Whisper's geometry against the JAX fixture ----------------------------

def test_clips_and_recording_are_the_fixtures():
    fx = np.load(sc.OUT)
    assert [sc.digest(sc.clip_pcm(i)) for i in sc.FIXTURE_CLIPS] == \
        list(fx["clip_sha256"])
    wav = sc.long_wav(sp.pcm_to_wav, sc.CUT_S)
    assert sc.digest(np.frombuffer(wav, np.uint8)) == str(fx["wav_sha256"])
    assert np.array_equal(sc.long_pcm(2 * sc.CUT_S)[:len(sc.long_pcm(
        sc.CUT_S))], sc.long_pcm(sc.CUT_S))


def test_whisper_geometry_log_mel_matches_the_fixture():
    fx = np.load(sc.OUT)
    audio = np.empty(len(sc.FIXTURE_CLIPS), dtype=object)
    for j, i in enumerate(sc.FIXTURE_CLIPS):
        audio[j] = sc.clip(i)
    feats = sp.AudioFeaturizer(**sc.WHISPER_FEATURIZER).transform(
        Table({"audio": audio}), device="cpu")["features"]
    assert [len(f) for f in feats] == list(fx["clip_n_frames"]) == \
        [2998, 2998]
    got = np.stack([f[::sc.FRAME_STRIDE] for f in feats])
    assert got.shape == fx["clip_frames"].shape == (2, 94, 80)
    np.testing.assert_allclose(got, fx["clip_frames"], rtol=LOG_MEL_TOL,
                               atol=LOG_MEL_TOL)
    sums = np.stack([f.astype(np.float64).sum(0) for f in feats])
    np.testing.assert_allclose(sums, fx["clip_sums"], rtol=LOG_MEL_TOL,
                               atol=LOG_MEL_TOL * 2998)


def test_whisper_width_chain_cut_matches_the_fixture():
    """The first 20 s of the recording through the whole chain at the
    published widths (80 mel bins, BiLSTM hidden 300)."""
    fx = np.load(sc.OUT)
    rows = sp.wav_to_utterance_rows(
        sc.long_wav(sp.pcm_to_wav, sc.CUT_S),
        sp.AudioFeaturizer(num_mel_bins=sc.N_MELS), device="cpu")
    np.testing.assert_array_equal(rows["t_start"], fx["t_start"])
    np.testing.assert_array_equal(rows["t_end"], fx["t_end"])
    np.testing.assert_allclose(
        np.stack([np.asarray(f, np.float64).sum(0)
                  for f in rows["features"]]), fx["feature_sums"],
        rtol=LOG_MEL_TOL, atol=LOG_MEL_TOL * fx["n_frames"].max())
    means, states, n_frames = sc.chain_states(
        CNTKModel(model_bytes=build_optimized_rnn_model(**sc.RNN)), rows,
        sp.utterance_feature_batch, Table, device="cpu")
    np.testing.assert_array_equal(n_frames, fx["n_frames"])
    assert states.shape == (len(n_frames), n_frames.max(), 600)
    held = sc.held_means(means, fx["chain_means"], n_frames, STATE_TOL)
    assert held["ok"] and held["backward_rows"] == 1, held


def test_backward_states_of_a_padded_utterance_follow_the_padding():
    """Why the chain is held as it is: the backward direction of a padded
    utterance first runs through the batch's zero padding, where the
    random hidden-300 LSTM is chaotic, so a last-bit difference there
    grows to O(1) before the utterance's own frames. The same padded batch
    twice, the second with one value of the last padding frame of each
    padded row set from 0 to 1e-9: the forward half of every row and the
    backward half of the full-length row stay within 1e-4 (they never
    read that frame), the backward half of every padded row moves by more
    than 0.1."""
    rows = sp.wav_to_utterance_rows(
        sc.long_wav(sp.pcm_to_wav, sc.CUT_S),
        sp.AudioFeaturizer(num_mel_bins=sc.N_MELS), device="cpu")
    model = CNTKModel(model_bytes=build_optimized_rnn_model(**sc.RNN))
    batch, n_frames = sp.utterance_feature_batch(rows)
    full = n_frames == n_frames.max()
    nudged = batch.copy()
    nudged[~full, -1, 0] = 1e-9
    assert full.sum() == 1 and (~full).sum() == 3
    means = []
    for b in (batch, nudged):
        m, _, _ = sc.chain_states(
            model, rows, lambda _rows, b=b: (b, n_frames), Table,
            device="cpu")
        means.append(m)
    gap = np.abs(means[1] - means[0])
    assert gap[:, :300].max() <= STATE_TOL
    assert gap[full, 300:].max() <= STATE_TOL
    assert (gap[~full, 300:].max(axis=1) > 0.1).all()


# -- what the package holds -------------------------------------------------

def test_the_package_holds_the_front_end_and_names_item_6f_for_the_rest():
    assert sorted(cognitive.__all__) == sorted([
        "AudioFeaturizer", "WavStream", "pcm_to_wav", "segment_utterances",
        "utterance_feature_batch", "wav_to_utterance_rows"])
    with pytest.raises(ImportError, match="item 6f"):
        from synapseml_tpu_torch.cognitive import SpeechToTextSDK  # noqa: F401
    with pytest.raises(ImportError, match="item 6f"):
        from synapseml_tpu_torch.cognitive.speech import (  # noqa: F401
            SpeechToTextSDK)
    assert not hasattr(cognitive, "no_such_name")
    assert hasattr(jsp, "SpeechToTextSDK")


def test_the_front_end_imports_no_http_client():
    """The package holds no service client: nothing of ``io`` (the
    reference's module imports ``io.http``'s client at its top)."""
    import ast

    for mod in (cognitive, sp):
        with open(mod.__file__) as fh:
            tree = ast.parse(fh.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names
                    if n.startswith(("synapseml_tpu_torch.io", "jax"))
                    or n.split(".")[0] == "synapseml_tpu"], names
