"""Seeded audio for the speech front end at Whisper's geometry.

Whisper's front end (openai/whisper ``whisper/audio.py``) reads 16 kHz
audio in 30-s chunks (``SAMPLE_RATE``, ``CHUNK_LENGTH``) and frames it
with ``N_FFT = 400`` and ``HOP_LENGTH = 160`` into ``N_MELS = 80`` bins.
This module makes the audio that ``chip_smoke.py`` featurizes at that
geometry, and that ``tests/test_torch_speech.py`` and
``make_speech_fixture.py`` read:

- :func:`clip` (and :func:`clips`): 30-s clips, each bursts of
  band-limited noise (0.3–3 s, bands within 80–7,600 Hz, peaks 0.05–0.6
  of full scale) with silences (0.2–1.5 s) under a faint noise floor,
  from ``default_rng([seed, i])``, so one clip is made without the rest;
- :func:`long_pcm` (and :func:`long_wav`): a recording of utterances of
  0.5–8 s (band-limited noise under a syllable-rate envelope) with gaps
  of 0.4–1.5 s, made piece by piece from one generator, so the first
  ``s`` seconds of a longer recording are the recording of ``s`` seconds.

Both are 16-bit PCM before anything else (a float clip is its PCM over
32,768), so a last-bit difference of numpy's FFT on another machine does
not reach them: :func:`digest` of the PCM bytes names them. The module
imports neither package.
"""
import hashlib
import os

import numpy as np

SAMPLE_RATE = 16000     # whisper/audio.py
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH = 30       # seconds a clip
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE
N_CLIPS = 32
SEED = 0
LONG_S = 600            # the recording the chain runs on
CUT_S = 20              # its cut that the JAX fixture holds
FIXTURE_CLIPS = (0, 1)  # the clips the JAX fixture holds
FRAME_STRIDE = 32       # the fixture keeps every 32nd frame of a clip
# the chain's recurrent model: build_optimized_rnn_model's arguments (the
# CNTK 202 tutorial's LSTM width)
RNN = dict(input_dim=N_MELS, hidden=300, bidirectional=True, cell="lstm",
           seed=11)
# AudioFeaturizer at Whisper's geometry (its own mel edges, log offset and
# window stay)
WHISPER_FEATURIZER = dict(frame_length=N_FFT, frame_step=HOP_LENGTH,
                          num_mel_bins=N_MELS)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "speech_io.npz")


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _band_noise(rng, n: int, lo: float, hi: float) -> np.ndarray:
    """``n`` samples of white noise kept to ``[lo, hi]`` Hz, peak 1."""
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE)
    spec[(f < lo) | (f > hi)] = 0.0
    y = np.fft.irfft(spec, n)
    return y / max(float(np.abs(y).max()), 1e-12)


def _fade(x: np.ndarray, n: int = 160) -> np.ndarray:
    n = min(n, len(x) // 2)
    if n:
        ramp = np.linspace(0.0, 1.0, n)
        x[:n] *= ramp
        x[-n:] *= ramp[::-1]
    return x


def _pcm(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")


def clip_pcm(i: int, seed: int = SEED,
             seconds: int = CHUNK_LENGTH) -> np.ndarray:
    """Clip ``i`` as 16-bit PCM."""
    rng = np.random.default_rng([seed, i])
    n = seconds * SAMPLE_RATE
    x = 3e-4 * rng.standard_normal(n)
    pos = int(rng.uniform(0.0, 1.0) * SAMPLE_RATE)
    while pos < n:
        length = int(rng.uniform(0.3, 3.0) * SAMPLE_RATE)
        lo = rng.uniform(80.0, 2000.0)
        hi = rng.uniform(lo + 500.0, 7600.0)
        burst = _fade(_band_noise(rng, length, lo, hi)
                      * rng.uniform(0.05, 0.6))
        end = min(n, pos + length)
        x[pos:end] += burst[:end - pos]
        pos = end + int(rng.uniform(0.2, 1.5) * SAMPLE_RATE)
    return _pcm(x)


def clip(i: int, seed: int = SEED) -> np.ndarray:
    """Clip ``i`` as float32 samples, its PCM over 32,768."""
    return clip_pcm(i, seed).astype(np.float32) / 32768.0


def clips(n: int = N_CLIPS, seed: int = SEED) -> np.ndarray:
    """``[n, 480000]`` float32: clips 0 to n - 1."""
    return np.stack([clip(i, seed) for i in range(n)])


def long_pcm(seconds: int = LONG_S, seed: int = SEED) -> np.ndarray:
    """A recording of ``seconds`` as 16-bit PCM: a gap, then utterances
    and gaps in turn, each piece drawn after the last."""
    rng = np.random.default_rng([seed, 10 ** 6])
    n = seconds * SAMPLE_RATE
    pieces, total, speech = [], 0, False
    while total < n:
        if speech:
            length = int(rng.uniform(0.5, 8.0) * SAMPLE_RATE)
            lo = rng.uniform(100.0, 800.0)
            hi = rng.uniform(2500.0, 7000.0)
            t = np.arange(length) / SAMPLE_RATE
            envelope = 0.75 + 0.25 * np.sin(
                2 * np.pi * rng.uniform(3.0, 6.0) * t
                + rng.uniform(0, 2 * np.pi))
            piece = _fade(_band_noise(rng, length, lo, hi) * envelope
                          * rng.uniform(0.2, 0.6))
        else:
            length = int(rng.uniform(0.4, 1.5) * SAMPLE_RATE)
            piece = 3e-4 * rng.standard_normal(length)
        pieces.append(piece)
        total += length
        speech = not speech
    return _pcm(np.concatenate(pieces)[:n])


def long_wav(pcm_to_wav, seconds: int = LONG_S, seed: int = SEED) -> bytes:
    """:func:`long_pcm` as WAV bytes, written by ``pcm_to_wav`` (either
    package's)."""
    return pcm_to_wav(long_pcm(seconds, seed), SAMPLE_RATE)


def chain_states(model, rows, feature_batch, table_cls, **transform_kw):
    """One mean state row an utterance: ``rows``' features padded into one
    batch (``feature_batch``, either package's
    ``utterance_feature_batch``), run through ``model`` (either package's
    ``CNTKModel``, its first input fed from ``"mel"``, its first output
    fetched) and each utterance's states averaged over its true frames.
    Returns ``(means [U, 2 * hidden], states, n_frames)``."""
    md = model.model_metadata()
    model.set(feed_dict={list(md["inputs"])[0]: "mel"},
              fetch_dict={"state": md["outputs"][0]})
    batch, n_frames = feature_batch(rows)
    states = np.asarray(model.transform(table_cls({"mel": batch}),
                                        **transform_kw)["state"])
    means = np.stack([states[i, :n_frames[i]].mean(axis=0)
                      for i in range(len(n_frames))])
    return means, states, n_frames


def held_means(got, want, n_frames, tol: float) -> dict:
    """Mean state rows (:func:`chain_states`) held where they are
    determined: the forward half of every utterance, and the backward half
    of the utterances as long as the batch. A shorter utterance's backward
    direction first runs through the batch's zero padding, where a random
    recurrent net can be chaotic, so two correct runs part there; its
    backward half is reported, not held. Returns ``{"ok",
    "forward_max_abs_err", "backward_max_abs_err", "backward_rows",
    "padded_backward_max_abs_err"}``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    h = got.shape[1] // 2
    full = np.asarray(n_frames) == np.max(n_frames)
    gap = np.abs(got - want)
    fwd = float(gap[:, :h].max())
    bwd = float(gap[full, h:].max())
    return {"ok": bool(fwd <= tol and bwd <= tol and got.shape == want.shape
                       and np.isfinite(got).all()),
            "forward_max_abs_err": fwd, "backward_max_abs_err": bwd,
            "backward_rows": int(full.sum()),
            "padded_backward_max_abs_err": float(
                gap[~full, h:].max()) if (~full).any() else 0.0}
