"""Write ``speech_io.npz``: the JAX package's speech front end at
Whisper's geometry (``speech_clips.py``), on the CPU.

    python tests/fixtures/make_speech_fixture.py

It holds two things, each with the digest of the audio it came from:

- clips 0 and 1 (30 s each) through ``AudioFeaturizer(frame_length=400,
  frame_step=160, num_mel_bins=80)``: every 32nd log-mel frame of each
  (``clip_frames``, ``[2, 94, 80]``), each clip's per-bin sum over all its
  frames in float64 (``clip_sums``) and the frame count;
- the first 20 s of the 10-minute recording through
  ``wav_to_utterance_rows`` (80 mel bins), ``utterance_feature_batch`` and
  a ``CNTKModel`` of ``build_optimized_rnn_model(80, 300,
  bidirectional=True, cell="lstm", seed=11)``: the utterances' bounds and
  frame counts, each one's per-bin feature sum, and its mean state row
  (``chain_means``, ``[U, 600]``).

``chip_smoke.py`` phase 38 and ``tests/test_torch_speech.py`` hold the
port to it.
"""
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    sys.path[:0] = [HERE, os.path.dirname(os.path.dirname(HERE))]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import speech_clips as sc
    from synapseml_tpu.cognitive import (AudioFeaturizer, pcm_to_wav,
                                         utterance_feature_batch,
                                         wav_to_utterance_rows)
    from synapseml_tpu.data.table import Table
    from synapseml_tpu.dl.cntk import CNTKModel
    from synapseml_tpu.dl.cntk_format import build_optimized_rnn_model

    start = time.perf_counter()
    pcm = [sc.clip_pcm(i) for i in sc.FIXTURE_CLIPS]
    audio = np.empty(len(pcm), dtype=object)
    for j, p in enumerate(pcm):
        audio[j] = p.astype(np.float32) / 32768.0
    feat = AudioFeaturizer(**sc.WHISPER_FEATURIZER)
    feats = [np.asarray(f) for f in feat.transform(
        Table({"audio": audio}))["features"]]
    wav = sc.long_wav(pcm_to_wav, sc.CUT_S)
    rows = wav_to_utterance_rows(
        wav, AudioFeaturizer(num_mel_bins=sc.N_MELS))
    model = CNTKModel(model_bytes=build_optimized_rnn_model(**sc.RNN))
    means, _, n_frames = sc.chain_states(model, rows,
                                         utterance_feature_batch, Table)
    np.savez_compressed(
        sc.OUT, clip_sha256=np.asarray([sc.digest(p) for p in pcm]),
        clip_frames=np.stack([f[::sc.FRAME_STRIDE] for f in feats]),
        clip_sums=np.stack([f.astype(np.float64).sum(0) for f in feats]),
        clip_n_frames=np.asarray([len(f) for f in feats], np.int64),
        wav_sha256=sc.digest(np.frombuffer(wav, np.uint8)),
        t_start=np.asarray(rows["t_start"]), t_end=np.asarray(rows["t_end"]),
        n_frames=n_frames,
        feature_sums=np.stack([np.asarray(f, np.float64).sum(0)
                               for f in rows["features"]]),
        chain_means=means.astype(np.float32), jax_version=jax.__version__)
    print(f"wrote {sc.OUT}: {len(feats)} clips of {len(feats[0])} frames, "
          f"{rows.num_rows} utterances in {sc.CUT_S} s, "
          f"{os.path.getsize(sc.OUT)} bytes, "
          f"{time.perf_counter() - start:.1f} s")


if __name__ == "__main__":
    main()
