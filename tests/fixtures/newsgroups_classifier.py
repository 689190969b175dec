"""A 20 Newsgroups-width text classifier as one ONNX graph, built from a
seed, and the documents it scores.

The dimensions are those of scikit-learn's ``fetch_20newsgroups_vectorized``,
whose documentation gives 20 classes and a dimensionality of 130,107: the
vocabulary of ``CountVectorizer`` with its defaults (lowercase, token
pattern ``(?u)\\b\\w\\w+\\b``, unigram counts), then L2 normalisation. The
graph, at opset 21:

    docs [N] string
     -> SplitToSequence(axis=0, keepdims=0)
     -> SequenceMap(body: StringSplit (whitespace)
                         -> RegexFullMatch("\\w\\w+") -> Compress(axis=0)
                         -> StringNormalizer(case_change_action="LOWER")
                         -> LabelEncoder(the vocabulary -> its ids, -1 else)
                         -> TfIdfVectorizer(mode="TF", unigrams over the ids))
     -> ConcatFromSequence(axis=0, new_axis=1)     [N, vocabulary] counts
     -> Normalizer(norm="L2")
     -> LinearClassifier(classes, float32 coefficients, post_transform NONE)
     -> labels [N] int64, scores [N, classes] float32

``StringNormalizer`` takes one ``[C]`` row, so each document is mapped on
its own (``SequenceMap``). Node names carry their part for the timing.

The vocabulary, the coefficients and the documents are this module's own
choice, not published figures: 130,107 distinct lowercase ASCII words of
2-12 letters; document lengths log-normal with a median of 200 tokens,
clipped to [8, 4,000]; tokens Zipf-drawn words (some capitalised), with
about 3% out-of-vocabulary words (13-15 letters), 5% one-letter tokens and
5% punctuation tokens, which the regex drops. On such whitespace-separated
documents the graph's tokenizer is ``CountVectorizer``'s. Every draw is a
uniform double of ``numpy.random.default_rng`` (each document its own
generator, so the first documents of a larger batch are the fixture's);
:func:`digest` names a batch, and the fixture stores the digest of its own.

This module imports neither package: :func:`classifier_graph` takes either
package's ``GraphBuilder``.
"""
import hashlib
import os

import numpy as np

OPSET = 21
SEED = 0
FULL = dict(vocab=130_107, classes=20)
SMALL = dict(vocab=5_000, classes=4)
MEDIAN_TOKENS, MIN_TOKENS, MAX_TOKENS, LENGTH_SIGMA = 200, 8, 4_000, 0.8
OOV, ONE_LETTER, PUNCTUATION, CAPITALISED = 0.03, 0.05, 0.05, 0.10
PUNCTUATION_TOKENS = (",", ".", "!", "?", ";", ":", "-", "--", "(", ")",
                      "\"", "'", "...", "&")
FIXTURE_DOCS = 32             # the JAX fixture's documents, at full width
NEAR_TIE = 1e-4               # a top-2 score gap under this share of the largest |score|
SCORE_TOL = 1e-4              # scores against JAX, of the largest |score|
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "newsgroups_classifier_io.npz")
PARTS = {"split_docs": "sequence", "map_docs": "sequence",
         "stack_counts": "sequence", "b_split": "strings",
         "b_regex": "strings", "b_compress": "strings",
         "b_lower": "strings", "b_vocab": "label_encoder",
         "b_count": "tfidf", "l2": "normalizer", "classify": "gemm"}


def vocabulary(n: int, seed: int = SEED) -> list:
    """``n`` distinct lowercase ASCII words of 2-12 letters, in draw
    order."""
    rng = np.random.default_rng([seed, 1])
    found = {}
    while len(found) < n:
        letters = (rng.random((200_000, 12)) * 26).astype(np.uint8) + 97
        lens = 2 + (rng.random(200_000) * 11).astype(np.int64)
        letters[np.arange(12)[None, :] >= lens[:, None]] = 0
        for w in letters.view("S12").ravel():
            found.setdefault(w, None)
            if len(found) == n:
                break
    return [w.decode() for w in found]


def _zipf_cdf(n: int) -> np.ndarray:
    w = 1.0 / (np.arange(n, dtype=np.float64) + 2.7)
    c = np.cumsum(w)
    return c / c[-1]


def _document(rng, vocab: list, cdf: np.ndarray) -> str:
    u1, u2 = rng.random(2)
    z = np.sqrt(-2.0 * np.log(1.0 - u1)) * np.cos(2.0 * np.pi * u2)
    n = int(np.clip(np.floor(MEDIAN_TOKENS * np.exp(LENGTH_SIGMA * z)),
                    MIN_TOKENS, MAX_TOKENS))
    kind, pick, case, extra = rng.random((4, n))
    ranks = np.minimum(np.searchsorted(cdf, pick, side="right"),
                       len(vocab) - 1)
    toks = []
    for i in range(n):
        k = kind[i]
        if k < OOV:
            length = 13 + int(extra[i] * 3)
            toks.append("".join(chr(97 + int(v * 26)) for v in
                                rng.random(length)))
        elif k < OOV + ONE_LETTER:
            toks.append(chr(97 + int(extra[i] * 26)))
        elif k < OOV + ONE_LETTER + PUNCTUATION:
            toks.append(PUNCTUATION_TOKENS[int(extra[i]
                                               * len(PUNCTUATION_TOKENS))])
        else:
            w = vocab[ranks[i]]
            if case[i] < CAPITALISED / 5:
                w = w.upper()
            elif case[i] < CAPITALISED:
                w = w.capitalize()
            toks.append(w)
    lines = [" ".join(toks[i:i + 40]) for i in range(0, n, 40)]
    return "\n".join(lines)


def documents(cfg: dict, n: int, seed: int = SEED,
              vocab: list = None) -> np.ndarray:
    """``[n]`` documents (a numpy ``object`` array), document ``d`` from
    its own generator."""
    vocab = vocabulary(cfg["vocab"], seed) if vocab is None else vocab
    cdf = _zipf_cdf(len(vocab))
    return np.asarray([_document(np.random.default_rng([seed, 2, d]), vocab,
                                 cdf) for d in range(n)], dtype=object)


def digest(docs) -> str:
    return hashlib.sha256("\x00".join(docs).encode()).hexdigest()


def coefficients(cfg: dict, seed: int = SEED):
    """The classifier's ``[classes, vocab]`` float32 coefficients and its
    intercepts."""
    rng = np.random.default_rng([seed, 3])
    coef = rng.standard_normal((cfg["classes"], cfg["vocab"]))
    inter = rng.standard_normal(cfg["classes"]) * 0.1
    return coef.astype(np.float32), inter.astype(np.float32)


def classifier_graph(graph_cls, cfg: dict = FULL, seed: int = SEED,
                     vocab: list = None) -> bytes:
    """The classifier's ONNX bytes, built with ``graph_cls`` (either
    package's ``GraphBuilder``)."""
    vocab = vocabulary(cfg["vocab"], seed) if vocab is None else vocab
    v = len(vocab)
    body = graph_cls(name="tokenize_and_count", opset=OPSET,
                     name_prefix="b_")
    body.add_input("doc", None)
    body.add_node("StringSplit", ["doc"], outputs=["b_tokens", "b_n"],
                  name="b_split")
    body.add_node("RegexFullMatch", ["b_tokens"], outputs=["b_ok"],
                  name="b_regex", pattern=r"\w\w+")
    body.add_node("Compress", ["b_tokens", "b_ok"], outputs=["b_kept"],
                  name="b_compress", axis=0)
    body.add_node("StringNormalizer", ["b_kept"], outputs=["b_lower"],
                  name="b_lower", case_change_action="LOWER")
    body.add_node("LabelEncoder", ["b_lower"], outputs=["b_ids"],
                  name="b_vocab", domain="ai.onnx.ml", keys_strings=vocab,
                  values_int64s=list(range(v)), default_int64=-1)
    body.add_node("TfIdfVectorizer", ["b_ids"], outputs=["b_tf"],
                  name="b_count", mode="TF", min_gram_length=1,
                  max_gram_length=1, max_skip_count=0, ngram_counts=[0],
                  ngram_indexes=list(range(v)), pool_int64s=list(range(v)))
    body.add_output("b_tf", np.float32, None)

    coef, inter = coefficients(cfg, seed)
    g = graph_cls(opset=OPSET)
    g.add_input("docs", None)
    g.add_node("SplitToSequence", ["docs"], outputs=["doc_seq"],
               name="split_docs", axis=0, keepdims=0)
    g.add_node("SequenceMap", ["doc_seq"], outputs=["tf_seq"],
               name="map_docs", body=body.build().graph)
    g.add_node("ConcatFromSequence", ["tf_seq"], outputs=["counts"],
               name="stack_counts", axis=0, new_axis=1)
    g.add_node("Normalizer", ["counts"], outputs=["normed"], name="l2",
               domain="ai.onnx.ml", norm="L2")
    g.add_node("LinearClassifier", ["normed"], outputs=["labels", "scores"],
               name="classify", domain="ai.onnx.ml",
               coefficients=coef.reshape(-1).tolist(),
               intercepts=inter.tolist(),
               classlabels_ints=list(range(cfg["classes"])),
               post_transform="NONE")
    g.add_output("labels", np.int64, None)
    g.add_output("scores", np.float32, None)
    return g.to_bytes()


def as_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def counts_of(run, docs) -> np.ndarray:
    """The ``[N, vocab]`` counts: the first output of ``run`` (the graph
    without its last two nodes, ``ImportedGraph.truncated(2)``, bound or
    applied) on ``docs``."""
    return as_numpy(run(docs)[0])


def sparse(counts: np.ndarray) -> dict:
    rows, cols = np.nonzero(counts)
    return {"count_rows": rows.astype(np.int32),
            "count_cols": cols.astype(np.int32),
            "count_values": counts[rows, cols].astype(np.float32)}


def same_counts(counts: np.ndarray, fixture) -> bool:
    """``counts`` bitwise the fixture's (stored sparse), first rows."""
    got = sparse(counts[:len(fixture["labels"])])
    return all(np.array_equal(got[k].view(np.uint32) if k == "count_values"
                              else got[k],
                              np.asarray(fixture[k]).view(np.uint32)
                              if k == "count_values" else fixture[k])
               for k in got)


def near_ties(scores: np.ndarray) -> np.ndarray:
    """Rows whose top-2 score gap is under :data:`NEAR_TIE` of the largest
    |score|."""
    top2 = -np.sort(-scores.astype(np.float64), axis=1)[:, :2]
    return (top2[:, 0] - top2[:, 1]) < NEAR_TIE * np.abs(scores).max()


def held(labels: np.ndarray, scores: np.ndarray, want) -> dict:
    """Labels and scores against ``want`` (the fixture's, or another run's
    ``{"labels", "scores"}``) on its rows: scores within
    :data:`SCORE_TOL` of the largest |score|, labels equal but at the
    counted near-ties of ``want``'s scores."""
    n = len(want["labels"])
    ws, wl = np.asarray(want["scores"]), np.asarray(want["labels"])
    span = float(np.abs(ws).max())
    err = float(np.abs(scores[:n].astype(np.float64) - ws).max())
    ties = near_ties(ws)
    differ = labels[:n] != wl
    return {"ok": bool(err <= SCORE_TOL * span and labels[:n].shape
                       == wl.shape and np.all(ties[differ])),
            "max_abs_err": err, "bound": SCORE_TOL * span,
            "labels_differ": int(differ.sum()),
            "near_ties": int(ties.sum()), "rows": n}
