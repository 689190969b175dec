"""Write ``newsgroups_classifier_io.npz``: the JAX package's run of the
20 Newsgroups-width classifier (``newsgroups_classifier.py``, 130,107
words, 20 classes, seed 0) on its first 32 documents, eagerly
(``import_model(...).apply``), on the CPU.

    python tests/fixtures/make_newsgroups_fixture.py

The npz holds the labels, the scores, the ``[32, 130107]`` counts stored
sparse (rows, columns, float32 values) and the documents' sha256.
``chip_smoke.py`` phase 37 and ``tests/test_torch_onnx_ops_sequence.py``
hold the port to it.
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
    import newsgroups_classifier as news
    from synapseml_tpu.onnx import GraphBuilder, import_model

    start = time.perf_counter()
    graph = import_model(news.classifier_graph(GraphBuilder, news.FULL))
    docs = news.documents(news.FULL, news.FIXTURE_DOCS)
    labels, scores = (np.asarray(v) for v in graph.apply(graph.params,
                                                         docs))
    head = graph.truncated(2)
    counts = news.counts_of(lambda d: head.apply(head.params, d), docs)
    np.savez_compressed(news.OUT, labels=labels.astype(np.int64),
                        scores=scores.astype(np.float32),
                        docs_sha256=news.digest(docs),
                        jax_version=jax.__version__, **news.sparse(counts))
    print(f"wrote {news.OUT}: {len(docs)} documents, "
          f"{int(counts.sum())} counted tokens, "
          f"{time.perf_counter() - start:.1f} s")


if __name__ == "__main__":
    main()
