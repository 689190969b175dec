"""Cognitive services on the port: the local speech front end only.

The counterpart of the reference package's ``cognitive/``, of which the
port holds the part that calls no service: :mod:`.speech`'s WAV parsing,
energy endpointer and log-mel featurization on the card. The service
clients (``SpeechToTextSDK``, the text, vision, form, face and search
services) and their base (``cognitive/base.py``, ``io/http.py``'s
retrying client) are ROADMAP Queue 1 item 6f; importing
``SpeechToTextSDK`` raises ``ImportError`` naming that item.
"""
from synapseml_tpu_torch.cognitive import speech as _speech
from synapseml_tpu_torch.cognitive.speech import (
    AudioFeaturizer,
    WavStream,
    pcm_to_wav,
    segment_utterances,
    utterance_feature_batch,
    wav_to_utterance_rows,
)

__all__ = ["AudioFeaturizer", "WavStream", "pcm_to_wav",
           "segment_utterances", "utterance_feature_batch",
           "wav_to_utterance_rows"]


def __getattr__(name: str):
    if name in _speech.NOT_PORTED:
        return _speech.__getattr__(name)    # raises ImportError: item 6f
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
