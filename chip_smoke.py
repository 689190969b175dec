#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repo root:  python3 chip_smoke.py

Phases, each printed as one JSON line; any failed check exits non-zero
before the last line:

1. device  — requires CUDA, prints the card's name and power limit;
2. build   — builds every kernel in synapseml_tpu_torch/csrc with nvcc
   (one nvcc per source, all started together) and prints ptxas' lines;
3. kernel_vs_plain — each kernel against its plain PyTorch version at the
   shapes the main paths give it: the forest traversal (K2) on the card,
   bitwise, with the isolation forest's trees staged in several tiles;
   the histogram (K1) bitwise against its plain version run on the CPU
   from the same inputs (on the card ``index_add_`` adds with atomics, in
   no fixed order), on a bin index built in the call and on one given,
   with 90% of the rows in one bin and with one NaN grad; the card's bin
   index equal to the CPU's; five K1 launches bitwise identical;
4. main_path — LightGBMClassificationModel.load_native_model on the
   100-tree, 31-leaf Adult fixture and ``transform`` of 65,536 and
   1,048,576 rows on the card, with the kernels' launch counts read around
   the run, and the fixture's recorded JAX outputs matched;
5. iforest — IsolationForest(100 trees, 256 samples) fitted on the host
   from seeded 65,536 x 14 rows, scored on the card through the strict
   traversal, matched against the plain version on the CPU;
6. train   — the training path: LightGBMClassifier(100 iterations, 31
   leaves).fit on the 32,561 x 14 Adult rows on the card, with the
   kernels' launch counts and the bin index's builds (one a fit) read
   around the fit and ``transform``; the result held to the JAX-trained
   fixture (training logloss within 1e-4, margins on the fixture's rows
   within 1e-3); then a 3-class fit, an L2 regressor fit and an
   early-stopped fit, each on the card and on the CPU with the same port
   code;
7. train_sampled_adult — the same Adult fit with bagging_fraction=0.8,
   bagging_freq=1, feature_fraction=0.8 on the card, the kernels' counts
   and the per-tree masked indexes read around it, held tree by tree to
   the JAX-trained sampled fixture at the tolerances of phase 6;
8. train_modes_card_vs_cpu — goss (binary, L2 regression, 3 classes), rf,
   dart (uniform, weighted, xgboost_dart_mode, 3 classes) and pos/neg
   bagging, 10 iterations each, fitted on the card and on the CPU by the
   same port code: bitwise, GOSS binary and 3-class within the margin
   tolerance (a GOSS near-tie may flip a split);
9. train_categorical_adult — LightGBMClassifier(100 iterations, 31
   leaves, 8 categorical columns) on the categorical Adult rows (32,561 x
   14, UCI Adult's layout and category counts, 2% NaN occupation) on the
   card, held to the JAX-trained fixture at phase 6's tolerances; its
   first 15 iterations fitted on the card and on the CPU, bitwise;
10. train_ranker — LightGBMRanker(100 iterations, 31 leaves) on rows
   at MSLR-WEB10K's width (300 queries, 36,666 x 136, labels 0-4) on the
   card, held to the JAX-trained fixture (mean margin gap on its query
   rows within 1e-3, training NDCG@30 within 1e-3);
11. train_ranker_card_vs_cpu — rankers fitted on the card and on the CPU
   by the same port code (blocked and dense lambdarank, rank_xendcg,
   weights, GOSS, bagging with feature_fraction, early stopping on a
   grouped validation set), each bitwise or within 1e-4;
12. times   — kernel, plain-version and library-call times (CUDA events
   around calls queued behind a device-side spin, median of repeats after
   a warm-up; the inputs stay in L2), K1's host time a call, the
   kernels' bounds, the bin index's build time, the transform's rows/s,
   the fit's wall seconds and rows*iterations/s (the median over the
   first fit and ``TIMED_REPEATS`` timed ones), a breakdown of one fit
   and the card's kernel time during one fit (torch.profiler); then the
   sampled fit's seconds, rows*iterations/s and kernel time, and the host
   time a tree's key stream and masks take; then the ranker fit's and the
   categorical fit's seconds and rows*iterations/s, the ranker fit's
   breakdown with the LambdaRank gradient as its own part and its device
   busy share, and the gradient's device ms at the fit's shape.

13. train_dp_adult — the Adult fit of phase 6 through
   ``boosting.train(mesh=)`` on two gloo ranks that share the card, each
   growing on its 16,281 rows (one launch of ``tests/torch_dp_worker.py``
   ranks, with a timeout): held to the JAX package's 2-device fixture at
   phase 6's tolerances, the two ranks' boosters bitwise equal, each
   rank's K1 launches and its validation tracker's K2 launches counted;
   the fit's seconds and rows*iterations/s beside the single-device fit's,
   and its reductions, their bytes and their synchronised seconds;
14. train_dp_card_vs_cpu — gbdt, bagging with feature_fraction, goss, rf,
   dart, 3 classes, lambdarank, L1, voting (top_k=2) and
   ``train_row_sharded`` (each rank its own rows) on two card ranks and on
   two CPU ranks of the same launch: bitwise;
15. train_nccl_one_rank — a one-rank NCCL group on the card trains
   bitwise what a one-rank gloo group does;
16. partitions_rendezvous_adult — the data plane: two worker processes
   sharing the card each stream their half of the Adult rows (3 and 4
   record batches, dicts and Tables) into
   ``data.partitions.fit_partitions(rendezvous=..., backend gloo)``,
   joining through a ``DriverRendezvous`` run here on loopback; routed to
   ``train_row_sharded``: both ranks' boosters bitwise equal and bitwise
   phase 13's, each rank's K1 and K2 launches counted, the rendezvous and
   fit seconds and the reductions reported;
17. partitions_gather_ranker — a lambdarank fit on the gather route
   (``row_sharded=False``), each rank numbering its queries from 0: two
   card ranks bitwise two CPU ranks of the same launch;
18. rendezvous_nccl_one_rank — a world of one joined through the
   rendezvous with ``backend="nccl"``: its row-sharded fit bitwise phase
   15's NCCL fit of the same rows;
19. launch_smoke — ``python -m synapseml_tpu_torch.parallel.launch`` on
   the card, single process: exits 0 and prints its accuracy;
20. onnx_resnet50_224 — the imported-ONNX forward of ``entry()``:
   ``zoo.resnet50`` (seed 0, 224x224, 1,000 classes) parsed and lowered
   by ``synapseml_tpu_torch.onnx.import_model`` (timed), ``entry()``'s 8
   images through the float32 bind (within rtol=atol=1e-3 of the JAX
   package's logits, ``tests/fixtures/resnet50_224_logits.npz``) and the
   bf16 bind (within 5% of their largest magnitude); a warm forward's
   copies and syncs (none but a numpy input's copy); images/s at batch
   128 (30 forwards after a warm one, CUDA events) in both dtypes and the
   share of the card's peak at 8.18 GFLOP an image; the card's busy share
   in one batch-8 and one batch-128 forward (``torch.profiler``) with its
   top operations; the batch-8 forward's host issue time against its wall
   and device time. No kernel of the port is on this path: K1 and K2
   launch 0 times;
21. onnx_fixtures — the five torch-exported graphs
   (``tests/fixtures/torch_*.onnx``) on the card against the torch
   outputs recorded at export: rtol=atol=1e-5, and for ``torch_quant_cnn``
   2 output quantization steps with more than 95% within one;
22. onnx_bert_base_causal — ``zoo.transformer_encoder(30522, 768, 12,
   3072, 12, seq_len=128, causal=True, seed=0)`` (BERT-base width, the
   ``Trilu`` causal mask) imported and bound in float32 and bf16, its
   2 fixture sequences held to the JAX package's outputs
   (``tests/fixtures/transformer_graphs.npz``: float32 within
   rtol=atol=1e-3, bf16 within 5% of the largest |value|); a warm
   forward's copies and syncs (none); sequences/s at batch 128 (20
   forwards after a warm one, CUDA events) in both dtypes and the share
   of the card's peak at the operations counted by ``encoder_ops``
   (22.35 GFLOP a sequence); batch 1's host issue against its wall and
   device time; the card's busy share (``torch.profiler``);
23. onnx_decoder_gqa — the default ``zoo.tiny_decoder``'s 8-token prefill
   and 8 decode steps through its shared KV buffers and the example-width
   BiLSTM tagger, each against the JAX fixture (rtol=atol=1e-4); then
   ``zoo.tiny_decoder`` at BERT-base width (vocab 30,522, d_model 768, 12
   heads, 4 KV heads, 12 layers, max_seq 1,024; 94 M params) in float32
   and bf16: a 128-token prefill at batch 8 into zeroed ``[8, 4, 1024,
   64]`` buffers, then 32 teacher-forced decode steps of one token
   (``seqlens_k`` = valid keys - 1), every step's logits against one full
   forward of the same 160 tokens (float32 within rtol=atol=1e-4, bf16
   within 5% of the largest |logit|); the prefill's and a step's wall,
   host-issue and card (profiler) time, prefill tokens/s, and a warm
   step's copies and syncs (none). K1 and K2 launch 0 times in phases
   20-23;
24. onnx_model_resnet50 — ``ONNXModel(mini_batch_size=128).transform``
   of ResNet-50 224 (seed 0) on the batched executor (pinned staging,
   the executor's own stream, one drain thread): a 1,000-image table (7
   full buckets, a 104-row tail; rows 0-7 are ``entry()``'s images) in
   float32 (rows 0-7 within rtol=atol=1e-3 of the JAX fixture), bf16
   (within 5% of the fixture's largest |logit|) and bf16 fed uint8 pixels
   normalised on the card (within 5% of bf16 on host-normalised pixels);
   every bucket bitwise the port's ``bind()`` forward of the same padded
   batch; ``transform_stream`` over 8 tables of 128 rows bitwise
   ``transform``'s rows; softmax and argmax against the logits; the
   BERT-base causal encoder on an int64 token column (coerced to int32 on
   the host) within rtol=atol=1e-3 of its ``bind()`` forward. Images/s
   through ``transform`` (host clock, median of 3 after a warm call)
   beside ``bind()``'s over the same buckets, ``transform_stream``'s, the
   8-row wall, the executor's stage/dispatch/compute/drain seconds, the
   card's busy share in one bf16 ``transform`` and its host-to-card
   copies overlapped with kernels (``torch.profiler``). K1 and K2 launch
   0 times;
25. onnx_model_warmup_resnet50 — the same graph, weights and tables as
   phase 24 through ``ONNXModel(mini_batch_size=128,
   compile_cache_dir=<tmp>).warmup()`` in float32, bf16 and bf16 over
   uint8 pixels (``example_feeds`` pins the uint8 wire): 5 buckets (8-128)
   each captured as a CUDA graph (status ``compiled``, no error, no
   host-to-card copy during a capture), the capture seconds a bucket and
   the memory reserved before and after; then ``transform`` of the
   1,000-image tables served by replays: every bucket bitwise phase 24's
   eager bucket of the same rows (or, where not, held to it at float32
   rtol=atol=1e-3 or bf16 5% of that bucket's largest |logit|; float32
   rows 0-7 also to the JAX fixture), AOT hits equal to the buckets
   dispatched, no AOT miss, retire or recompile; ten tables of mixed
   buckets streamed, each bitwise as alone; images/s beside phase 24's, the dispatch stage's p50, the
   card's busy share in one bf16 ``transform`` and its dispatch thread's
   host time by operation (``torch.profiler``); the 8-row wall warm
   against eager, the replayed bucket-8 graph's host issue against its
   card time; a restart (a second model on the same directory reports
   ``loaded == 5`` and scores bitwise the first); one submit of an
   unwarmed row shape counted as exactly one ``shape_drift``; the
   BERT-base causal encoder (bf16) through ``ONNXModel(mini_batch_size=8)``
   warmed, bitwise its eager executor, its 1-row and 8-row walls warm
   against eager, its replayed graph's host issue against its card time.
   K1 and K2 launch 0 times.

26. image_stages_featurizer_resnet50 — ``ImageTransformer`` (resize to
   240, center-crop 224, flip, blur 3x3, gaussian 5, threshold, BT.601
   gray) over 64 256x256 images, each stage prefix held to the JAX
   fixture (``tests/fixtures/image_explainer_fixtures.npz``) and to the
   port's CPU run at atol 1e-3, ``to_uint8`` equal but at half ties;
   ``ImageFeaturizer`` over ResNet-50 224 (``cut_output_layers=1``,
   ``mini_batch_size=64``) in float32 and bf16 on 512 images of 256x256
   (resized on the card by ``_prepare``): rows 0-7 against the JAX
   fixture (float32 rtol=atol=1e-3, bf16 5% of the largest |value|), PPM
   bytes bitwise the arrays, images/s eager and warm with ``_prepare``'s
   host seconds beside the executor's stages (and ``_prepare``'s
   milliseconds an image by part), the memory ``warmup()``
   reserves, every bucket (8-64) warm bitwise eager; the texture dataset
   (200 images a class at 224) featurised and a ``LightGBMClassifier(20
   iterations, 7 leaves)`` head fitted on 300 (K1) and scored on 100 (K2):
   held-out accuracy at least 0.85. The featurization launches K1 and K2
   0 times;
27. explainers — ``TabularSHAP``/``TabularLIME`` (100 samples) over the
   Adult fixture model on 256 rows, one ``transform`` of 25,600
   perturbed rows through K2: held to the JAX fixture within S · cond(A)
   · eps32 · max|coef| a row, SHAP's efficiency within 1e-4; rows
   explained/s; ``ImageLIME``/``ImageSHAP`` (196 superpixels, 512
   samples) over ``ImageFeaturizer(cut_output_layers=0)`` on ResNet-50:
   superpixels equal but at the fixture's ties, scores within 1e-3 of the
   JAX scores, coefficients within the same bound once the exact image of
   the score difference is taken off; images/s split into superpixels,
   masking, sampling, scoring and the fit; one lasso fit (100 sweeps of
   196 coordinates) timed and held to the CPU's.
28. cntk_model — ``CNTKModel`` on the committed recurrent fixture
   (``tests/fixtures/cntk_rnn.model``, two ``Scan``s) within
   rtol=atol=2e-5 of its expected outputs and of the CPU; small
   control-flow graphs through ``ONNXModel``: an ``If`` on a device
   condition and a host-trip ``Loop`` with a scan output warmed and
   bitwise eager, a device-condition ``Loop`` whose bucket warmup reports
   ``error`` with the reason, served eagerly and right, while the later
   buckets capture and replay bitwise; the CNTK 202 ATIS BiLSTM slot
   tagger at its published width (943 words, Embedding 150, BiLSTM 2 x
   150, Dense 129; random weights; the port's builder writes the
   fixture's bytes) over 1,024 sequences of 64 tokens through
   ``CNTKModel(mini_batch_size=128)`` in float32 and bf16: rows 0-7
   against the JAX fixture (``tests/fixtures/cntk_tagger_io.npz``) and
   the CPU, a bound forward's copies and syncs (none), its launches and
   card time, ``warmup()`` (5 buckets captured, no host-to-card copy),
   every warm bucket bitwise eager, sequences/s and tokens/s eager and
   warm, the executor's stages, the busy share of a warm ``transform``.
   K1 and K2 launch 0 times.
29. serving — the container entry ``python -m
   synapseml_tpu_torch.io.serving --port 0 --model <zoo.resnet50 seed 0,
   224, 1,000 classes> --warmup auto`` as a child process: every bucket
   ``compiled`` at warmup (a ``warmup skipped`` line fails), the announce
   line within 300 s; 256 one-image JSON requests from 16 keep-alive
   clients (rows 0-7 ``entry()``'s images, within rtol=atol=1e-3 of the
   JAX fixture), every reply 200 with ``X-Output-Digest`` the sha256 of
   its body; ``/metrics`` after the load: 0 recompiles, AOT hits; 32
   requests from one client; SIGTERM: exit 0 with ``admitted == replied``
   (288). In process: a ``ContinuousServer`` scoring the Adult fixture
   model on the card answers 1,024 one-row requests from 16 clients with
   margins bitwise the fixture's ``raw`` (K2 launched, K1 not); an echo
   server answers 1,000 requests from one client. Requests/s and p50/p99
   of each leg, the child's ``serving_score_seconds``,
   ``serving_queue_wait_seconds`` and executor stage p50s, the scorer's
   seconds a batch in JSON decode, feature arrays, ``transform`` and
   reply JSON (``request_parse_seconds``, ``model_pipeline_seconds``),
   and each part's wall time.

30. converted_lgbm — step 0 first (``resnet50_bucket_gap``):
   ``entry()``'s 8 images through ``bind()`` at batch 8 and padded to 16
   and through ``ONNXModel(mini_batch_size=16)`` eager and warm, each
   route against the others and the JAX fixture, with a TF32 forward and
   the kernels run at each batch beside them. Then a LightGBM model
   exported with ``convert_lightgbm`` and scored through the
   ``ai.onnx.ml`` ops: the Adult fixture model's 1,024 rows within 1e-5
   of the JAX package's ONNX path (``lgbm_adult_100x31_onnx.npz``) and of
   ``Booster.predict`` (K2), labels equal; 65,536 rows eager and warm
   (every bucket compiled without a host copy, replays bitwise eager, 0
   recompiles), rows/s, warmup, the bound tables' bytes, one bucket's
   launches; ``examples/lightgbm_overview.py`` steps 1-7 and
   ``examples/interpretability.py``'s KernelSHAP step with the port's
   modules (80-iteration fit, AUC above 0.85, native round trip, ONNX
   parity, over the wire, f0's attribution over 3x f2's); the serving
   entry over the converted file: 1,024 one-row requests from 16
   clients, every label ``Booster.predict > 0.5``. K1 and K2 launch 0
   times inside the converted ``transform``.
31. sequence_tagger — the MoE sequence tagger (``dl/tagger.py``):
   ``examples/bilstm_entity_extraction.py``'s training flow at its own
   width on the world-of-one mesh (200 AdamW steps at 16 x 16, lr 3e-3;
   the last loss below 0.6 of the first, held-out token accuracy above
   0.8); ``TaggerConfig()`` (427,840 parameters) in float32 and bf16,
   dense and ring: a 32 x 512 forward held to the port's CPU run and the
   fixture's 2 x 512 tokens to the JAX package's
   (``tests/fixtures/tagger_io.npz``), three AdamW steps held to both,
   run twice (bitwise or not); forward tokens/s, train-step ms and
   tokens/s, a step's launches, busy share and peak memory. K1 and K2
   launch 0 times.
32. decode_serving — ``runtime/decode.py``'s ``DecodeScheduler``: the
   default ``zoo.tiny_decoder`` scheduler's continuous, static and
   evicting streams equal to the JAX fixture
   (``tests/fixtures/decode_streams.npz``); the decoder at BERT-base
   width (phase 23's) through ``DecodeScheduler(max_batch=8,
   prefill_chunk=64, page_size=64, max_seq=1024)``: 10 signatures
   captured as CUDA graphs (all ``compiled``) and the memory warmup
   reserves; 32 sequences of ``bench.py``'s heavy-tailed shape (prompts
   16-384 tokens, outputs 8-32 or, every fourth, 192-256), each token the
   argmax of one full float32 ``bind()`` forward over its sequence so far
   or a counted near-tie (top-2 gap below 1e-4 of the largest |logit|),
   a repeat run equal; static batching and a 16-page eviction run
   (evictions and recomputes counted) equal but at near-ties;
   tokens/s continuous and static, TTFT and inter-token p50/p95, 0
   recompiles; a warm decode step and a warm prefill at T=1,024 bitwise
   their eager steps, with wall, dispatch, card time, launches and busy
   share beside the eager step's; the merge and the prefill logits' copy;
   the entry ``--decode`` over the wide decoder as a child process: 16
   prompts non-streamed and streamed from 8 clients, digests, an
   out-of-range token 400, SIGTERM exit 0 with admitted = replied;
   requests/s and p50/p99. K1 and K2 launch 0 times.
33. onnx_index_ops — the ONNX indexing and loss ops: every one-node case
   of ``tests/fixtures/index_op_cases.py`` (out-of-range, negative, tie,
   NaN and ``ignore_index=-100`` edges) on the card equal to the port's
   CPU run, no device assert, ``NonZero``/``Unique``/``Compress`` refusing
   a device tensor; the masked-LM head of ``tests/fixtures/mlm_head.py``
   (``GatherND`` batch_dims=1, the tied 30,522-word projection, ``TopK``
   5, ``SoftmaxCrossEntropyLoss``, ``GatherElements``, ``CastLike``,
   ``ScatterND``) over ``zoo.transformer_encoder(30522, 768, 12, 3072,
   12, seq_len=128, causal=False, seed=0)`` in float32: 8 sequences
   against the JAX fixture (``mlm_head_io.npz``; floats within 1e-3 of the
   largest |logit|, ids equal but at counted near-ties); 128 sequences
   through two executors warmed to one CUDA graph each (``compiled``),
   the warm head bitwise eager with no copy or sync, within 1e-5 of the
   largest |logit| of the port's CPU head; wall, card ms, launches and
   busy share eager and warm, the warmups' reserved memory, the head split
   into projection, ``TopK`` (beside ``torch.topk``) and the rest,
   sequences/s. K1 and K2 launch 0 times.
34. onnx_vision_ops — the ONNX dense-image ops: every one-node case of
   ``tests/fixtures/vision_op_cases.py`` (ConvTranspose, Resize, Upsample,
   Pad, the pools, MaxPool's Indices with MaxUnpool, the five
   normalizations, Col2Im, CenterCropPad) on the card equal to the port's
   CPU run (bitwise but for sums, within their bound), no device assert;
   Stable Diffusion v1's VAE decoder (``tests/fixtures/vae_decoder.py``,
   49.5 M float32 parameters) at its published width: the fixture's
   latents within 1e-3 of the largest |value| of the JAX images
   (``vae_decoder_io.npz``); 1 and 4 latents of 64 x 64 (512 x 512
   images) through one executor warmed to one CUDA graph a bucket, each
   warm run bitwise eager, no copy or sync in a bound forward, one latent
   within 1e-3 of the port's CPU run; images/s eager and warm, card ms by
   part (convolutions, GroupNormalization, Resize, attention, the rest),
   launches, busy share, warmup's memory. K1 and K2 launch 0 times.
35. onnx_detection_ops — the ONNX sampling and detection ops: every
   one-node case of ``tests/fixtures/detection_op_cases.py`` but
   ImageDecoder's (NonMaxSuppression, RoiAlign, MaxRoiPool, DeformConv,
   GridSample, AffineGrid) on the card equal to the port's CPU run (NMS
   rows and MaxRoiPool bitwise, sums within 2e-5 of the largest |value|),
   no device assert; torchvision Faster R-CNN R50-FPN's second stage
   (``tests/fixtures/detection_head.py``) at its published width: the
   first NMS stage's rows equal the JAX fixture's
   (``detection_head_io.npz``), the pooled features within 1e-5 of the
   port's CPU run, the 100 detections the fixture's but at counted
   near-ties (boxes within 1e-3 of the largest |coordinate|), no copy or
   sync in a bound forward; wall, card span and host issue ms by part
   (the two NMS stages, RoiAlign, the Gemms, the rest), launches, busy
   share, peak memory; DeformConv at DCNv2's res5 width and MaxRoiPool at
   Fast R-CNN's ``roi_pool5`` alone. K1 and K2 launch 0 times.
36. onnx_random_ops — the ONNX random ops: every one-node case of
   ``tests/fixtures/random_op_cases.py`` (RandomNormal, RandomNormalLike,
   RandomUniform, RandomUniformLike, Bernoulli, Multinomial with a
   GPT-2-vocabulary head in float32 and float16, Dropout) on the card
   against the port's CPU run (uniform, Bernoulli and Dropout bitwise,
   normal draws within 1e-6, Multinomial ids equal but at counted
   near-ties); Stable Diffusion v1's VAE encoder
   (``tests/fixtures/vae_encoder.py``, 34.2 M float32 parameters) sampling
   its latent through ``RandomNormalLike`` at its published width: the
   fixture's 256 x 256 images against the JAX run
   (``vae_encoder_io.npz``: mean, logvar and latent within 1e-4 of their
   largest |value|, the draw within 1e-6); 1 and 4 images of 512 x 512
   through ``bind()`` and one executor warmed to one CUDA graph a bucket,
   each warm run bitwise eager, two calls alike, 3 images padded into
   bucket 4 bitwise the first 3 of a full one, no copy or sync in a bound
   forward, one image within 1e-4 of the port's CPU run; images/s eager
   and warm, card ms by part (convolutions, GroupNormalization, attention,
   the random draw, the rest), launches (the draw's alone too), busy
   share, warmup's memory. K1 and K2 launch 0 times.
37. onnx_sequence_string_ops — the ONNX optional, sequence and string
   ops: every case of ``tests/fixtures/sequence_string_op_cases.py`` on
   the card against the port's CPU run (strings and host values equal,
   floats bitwise but sums of products within 1e-5, counts bitwise,
   refusals raised); a device-only ``SplitToSequence`` -> ``SequenceMap``
   (MatMul by a body initializer, Relu) -> ``ConcatFromSequence`` graph
   through an ``ONNXModel`` warmed at buckets 8 and 32, replays bitwise
   eager, no copy or sync in a bound forward; the 20 Newsgroups-width
   text classifier (``tests/fixtures/newsgroups_classifier.py``: 130,107
   words, 20 classes) on 256 documents, the first 32 against the JAX run
   (``newsgroups_classifier_io.npz``: counts bitwise, labels equal but at
   counted near-ties, scores within 1e-4 of the largest |score|) and
   against the port's CPU run; documents/s, host ms by part (string ops,
   LabelEncoder, the sequence plumbing), card ms by part
   (TfIdfVectorizer, ConcatFromSequence, Normalizer, the Gemm), launches,
   busy share, peak memory, copies to the card a document. K1 and K2
   launch 0 times.
38. signal_speech — the ONNX signal ops and the speech front end: every
   case of ``tests/fixtures/signal_op_cases.py`` (DFT, STFT, HannWindow,
   HammingWindow, BlackmanWindow, MelWeightMatrix, the log-mel chain) on
   the card against the port's CPU run (windows and filterbanks bitwise,
   spectra within 1e-5 of each output's largest |value|, log-mel within
   1e-3, refusals raised); ``AudioFeaturizer`` at Whisper's front-end
   geometry (``whisper/audio.py``: 16 kHz, N_FFT 400, HOP_LENGTH 160,
   N_MELS 80) on 32 seeded 30-s clips (``tests/fixtures/speech_clips.py``),
   clips 0-1 against the JAX run (``speech_io.npz``) and all 32 against
   the port's CPU run within rtol = atol = 1e-3, warmed to a CUDA graph
   whose replay is bitwise eager; a 10-minute seeded recording through
   ``wav_to_utterance_rows``, ``utterance_feature_batch`` and the
   hidden-300 BiLSTM ``CNTKModel``, held to the CPU and (its first 20 s)
   to the JAX run where the states are determined; audio seconds a second
   (eager and warm in turn, with the executor's stages and a profiled
   call of each), utterances a second, host and card ms by part (framing,
   FFT, power, mel MatMul, log, LSTM), launches, busy share, peak memory,
   copies to the card a clip. K1 and K2 launch 0 times.
39. distributed_serving — ``DistributedServer`` (Serving v1's layout: one
   front end, requests fanned out over channels, a circuit breaker a
   channel) on the card, every channel a scorer thread sharing it: (a) the
   Adult fixture model through K2 on 4 channels, 1,024 one-row requests
   from 16 clients, every reply 200 with its digest and its margin
   bitwise the fixture's ``raw``, K2 launched once a scored batch and K1
   not, every channel scoring; (d) ``drain()`` on that server with 64
   requests held in flight: all 200, a late one 503 with
   ``Retry-After``, none left parked after ``stop()``; (b) a fresh
   4-channel server with ``compute.channel1`` failing 3 fires: every
   reply still 200 and bitwise, at least one trip and one failover,
   channel 1 OPEN, then re-admitted CLOSED by the half-open probe within
   5 s of the last fire, the trip's flight-recorder dump written; (c)
   ResNet-50 224 (``_model_pipeline``, warmed) on 2 channels, 64
   one-image requests from 8 clients over ``entry()``'s 8 images: 200s
   with digests, equal images equal bytes, logits within rtol = atol =
   1e-3 of the JAX fixture, 0 recompiles, one executor. Requests/s,
   p50/p99, batches and rows a channel, each leg's wall.

40. dp_layouts — ``devices=`` data parallelism over slots sharing the
   card (``dp_layouts_phase``): ResNet-50 224 through a warm
   ``ONNXModel(mini_batch_size=128)`` on 512 images under ``devices=None``,
   ``1``, ``"all"`` (the pinned path), ``["cuda:0"] * 2`` (sharded) and
   ``["cuda:0"] * 3`` (round robin): round-robin logits bitwise one slot's,
   sharded ones within 1e-3 of the JAX fixture (rows 0-7) and 1e-2 of one
   slot's (all rows), warm graphs = slots x
   buckets, dispatch counters summing to the batches, 0 recompiles;
   ``ImageFeaturizer`` over two slots against one; ``DecodeScheduler``
   over two slots at phase 32's geometry, ids equal to one slot's but at
   near-ties, 0 KV copies; the serving entry with ``--devices 1`` (digests
   equal) and ``--devices 9`` (exit 2). Images/s, warmup seconds and
   memory a slot, busy share; not scaling figures. K1 and K2 launch 0
   times.

41. quantized — the int8 QOperator ops and the measured lanes
   (``quantized_phase``), from cold verdict tables: (a) the statically
   quantized ResNet-50 224 (``tests/fixtures/qresnet50.py``) through a
   warm ``ONNXModel(mini_batch_size=128)`` on 512 images under the
   measured int8 verdicts, its uint8 logits bitwise the port's CPU run
   (8 images), the JAX fixture (2 images; the jitted reference within one
   step, the count printed) and the same model warmed under
   ``SYNAPSEML_ONNX_INT8=0``; the stem's accumulator's sha256 the
   fixture's; every int8 class verified exact, none poisoned or memoized
   as a crash, the int8 route counter above 0, 0 recompiles; images/s
   under the verdicts and under the kill switch in turn, probe seconds,
   memory reserved, busy share; (b) BERT-base's FFN block dynamically
   quantized (``tests/fixtures/bert_ffn_int8.py``), 1,024 tokens, two
   host inputs, warm: every integer stage bitwise the CPU's on the same
   inputs, the output within 1e-2 of the CPU's largest |value|, the
   ``coalesced`` and ``per_arg`` H2D stagings bitwise, the verdicts
   printed; (c) float ResNet-50 224 at 128 under ``compute_dtype="auto"``
   within its resolved dtype's gate of the JAX fixture, and
   ``preferred_wire("data")``; (d) every case of
   ``tests/fixtures/quant_op_cases.py`` on the card, bitwise the CPU. K1
   and K2 launch 0 times.

42. sequence_parallel — sequence parallelism over ranks
   (``sequence_parallel_phase``): four gloo ranks sharing the card in one
   launch. (a) Ring (causal and not) and Ulysses attention over
   ``{"sp": 4}`` and the serving ring over ``{"dp": 2, "tp": 2}``, at B =
   2, S = 8,192, H = 4, D = 16 in float32 and bf16: gathered outputs and
   gradients of ``(out ** 2).sum()`` against dense attention on the card
   (float32 rtol = atol = 2e-4, bf16 5% of the largest |value|); each
   rank's peak allocation beside dense's, forward and backward ms, the
   rotations' and all-to-alls' calls, bytes and seconds. (b) The tagger at
   ``TaggerConfig()`` width, float32 and bf16, ring and Ulysses, over
   ``{"sp": 4}`` and ``{"dp": 2, "sp": 2}``: three AdamW steps of phase
   31's 32 x 512 batch against the port's one-rank run on the card
   (float32 losses rtol 1e-5, leaf sums within 0.01·lr a parameter; bf16
   5%), parameters bitwise equal on every rank; step ms, global tokens/s,
   the gradient exchange's seconds and bytes, peak allocation a rank.
   (c) Float32 against the JAX fixture of the same meshes
   (``tagger_sp_io.npz``). Not a scaling figure. K1 and K2 launch 0 times.

Between phases 3 and 4: prng_card_vs_cpu (the threefry key stream on the
card equal to the CPU's, bitwise) and masked_index (K1 on a
feature_fraction index equal to K1 on a fresh index of the moved bins and
to the plain version, bitwise).

Then the kernel summary line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "lgbm_adult_100x31.txt")
FIXTURE_IO = os.path.join(HERE, "tests", "fixtures",
                          "lgbm_adult_100x31_io.npz")
SAMPLED = os.path.join(HERE, "tests", "fixtures",
                       "lgbm_adult_100x31_bag08_ff08.txt")
SAMPLED_IO = os.path.join(HERE, "tests", "fixtures",
                          "lgbm_adult_100x31_bag08_ff08_io.npz")
SAMPLED_PARAMS = dict(bagging_fraction=0.8, bagging_freq=1,
                      feature_fraction=0.8, seed=0)
FIXTURES = os.path.join(HERE, "tests", "fixtures")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
N_MAIN, N_LARGE = 65_536, 1_048_576
PROB_ATOL = 1e-7              # only if numpy's exp differs from the fixture's
LOGLOSS_TOL = 1e-4            # training logloss, port fit vs JAX fixture
MARGIN_TOL_FIXTURE = 1e-3     # mean |margin| gap on the fixture's rows
MARGIN_TOL_CPU = 1e-4         # card fit vs CPU fit of the same port code
NDCG_TOL = 1e-3               # training NDCG@30, port ranker vs JAX fixture
CAT_CPU_ITERATIONS = 15       # the categorical fit held card against CPU
TIMED_REPEATS = 1             # timed fits of each kind after its first


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def query_rows(n: int, d: int = 14, seed: int = 1) -> np.ndarray:
    """Seeded rows; every 10th row has NaN in one random column."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, d)).astype(np.float32)
    nan_rows = np.arange(0, n, 10)
    q[nan_rows, rng.integers(0, d, nan_rows.size)] = np.nan
    return q


def random_forest(rng, t: int, m: int, f: int):
    """A valid ensemble of complete binary trees with m nodes each."""
    idx = np.arange(m)
    internal = 2 * idx + 2 < m
    feat = np.where(internal[None, :], rng.integers(0, f, (t, m)), -1)
    thr = np.where(internal[None, :], rng.normal(size=(t, m)), 0.0)
    left = np.broadcast_to(np.where(internal, 2 * idx + 1, 0), (t, m))
    right = np.broadcast_to(np.where(internal, 2 * idx + 2, 0), (t, m))
    value = np.where(internal[None, :], 0.0, rng.normal(size=(t, m)))
    return (feat.astype(np.int32), thr.astype(np.float32),
            left.astype(np.int32), right.astype(np.int32),
            value.astype(np.float32))


def on_card(arrays, dtypes=(np.int32, np.float32, np.int32, np.int32,
                            np.float32)):
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dt)).cuda()
                 for a, dt in zip(arrays, dtypes))


def adult_rows(n: int = 32561, d: int = 14, seed: int = 0):
    """The seeded Adult-census rows of ``bench.py`` ``bench_gbdt_train``
    (as ``tests/fixtures/make_lgbm_adult_fixture.py`` makes them)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    logits = x @ rng.normal(size=(d,)) + 0.5 * np.sin(3 * x[:, 0]) * x[:, 1]
    y = (logits + rng.normal(scale=0.5, size=n) > 0).astype(np.int32)
    return x, y


def synth_rows(n: int, d: int, seed: int, classes: int = 0):
    """Seeded rows with a nonlinear target: regression, or ``classes``
    classes cut from it at its quantiles."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    t = (x[:, 0] + np.sin(2 * x[:, 1]) + 0.5 * x[:, 2] * x[:, 3]
         + rng.normal(scale=0.3, size=n))
    if classes:
        cuts = np.quantile(t, np.linspace(0, 1, classes + 1)[1:-1])
        return x, np.searchsorted(cuts, t).astype(np.float64)
    return x, t


def logloss(raw: np.ndarray, y: np.ndarray) -> float:
    p = 1.0 / (1.0 + np.exp(-raw.astype(np.float64)))
    p = np.clip(p, 1e-15, 1 - 1e-15)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


def same_trees(a, b) -> list:
    """Per tree: are structure and thresholds identical?"""
    names = ("trees_feature", "trees_threshold", "trees_left", "trees_right")
    if a.trees_feature.shape != b.trees_feature.shape:
        return [False] * max(a.num_trees, b.num_trees)
    return [all(np.array_equal(getattr(a, f)[i], getattr(b, f)[i])
                for f in names) for i in range(a.num_trees)]


def first_difference(a, b, same: list) -> dict:
    """Where the first differing tree departs, and the two split gains
    chosen there (a near-tie shows as a tiny relative gap)."""
    if all(same):
        return {}
    if a.trees_feature.shape != b.trees_feature.shape:
        return {"shapes": [list(a.trees_feature.shape),
                           list(b.trees_feature.shape)]}
    t = same.index(False)
    diff = ((a.trees_feature[t] != b.trees_feature[t])
            | (a.trees_threshold[t] != b.trees_threshold[t]))
    node = int(np.nonzero(diff)[0][0])
    ga, gb = float(a.trees_gain[t, node]), float(b.trees_gain[t, node])
    return {"tree": t, "node": node,
            "feature": [int(a.trees_feature[t, node]),
                        int(b.trees_feature[t, node])],
            "gain": [ga, gb],
            "gain_gap_rel": abs(ga - gb) / max(abs(ga), abs(gb), 1e-30)}


def fit_breakdown(fit) -> dict:
    """Host-clock seconds of one fit by part, each part's calls wrapped
    with a synchronise before and after: the per-fit bin index, K1
    launches, the rest of the per-leaf histogram (the [N, 3] data), the
    split search, the row partition, the host syncs (device-to-host copies
    of each split's numbers), a sampled fit's row sampling (bagging or
    GOSS) and feature sampling (the permutation and the masked index), a
    ranker's LambdaRank gradient, and everything else; plus the number of
    host syncs."""
    from synapseml_tpu_torch.gbdt import boosting, grower, kernels, objectives

    parts = {"bin_index": 0.0, "k1": 0.0, "histogram_data": 0.0,
             "split_search": 0.0, "partition": 0.0, "host_syncs": 0.0,
             "row_sampling": 0.0, "feature_sampling": 0.0,
             "lambdarank_grad": 0.0}
    count = {"host_syncs": 0}
    originals = {}

    def wrap(module, name, part, counted=False):
        fn = getattr(module, name)
        originals[(module, name)] = fn

        def timed(*args, **kw):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[part] += time.perf_counter() - start
            if counted:
                count[part] += 1
            return out
        for counter in ("launches", "builds"):   # the wrapped one counts here
            if hasattr(fn, counter):
                setattr(timed, counter, getattr(fn, counter))
        setattr(module, name, timed)

    wrap(kernels, "bin_index", "bin_index")
    wrap(kernels, "histogram", "k1")
    wrap(grower, "histogram", "histogram_data")
    wrap(grower, "best_split", "split_search")
    wrap(grower, "_partition", "partition")
    wrap(grower, "_to_host", "host_syncs", counted=True)
    wrap(boosting, "_sample_rows", "row_sampling")
    wrap(boosting, "_feature_keep", "feature_sampling")
    wrap(kernels, "mask_features", "feature_sampling")
    wrap(objectives, "lambdarank_grad_blocked", "lambdarank_grad")
    wrap(objectives, "lambdarank_grad", "lambdarank_grad")
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        total = time.perf_counter() - start
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    parts["histogram_data"] -= parts["k1"]   # grower.histogram wraps K1
    parts["other"] = total - sum(parts.values())
    return {"total_s": total, "parts_s": parts,
            "host_syncs": count["host_syncs"]}


SPIN_CYCLES = 50_000_000      # ~28 ms of device spin ahead of a timing


def cuda_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over ``reps`` of the mean ms of ``inner`` back-to-back calls,
    timed with CUDA events after one warm-up call. Each run is queued
    behind a device-side spin, so the calls reach the card back to back
    and the time is the device's, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def host_ms(fn, calls: int = 100) -> float:
    """Host wall ms a call of ``fn`` takes to return (argument checks,
    allocation, launch) while the card is busy, so the host never waits."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - start
    torch.cuda.synchronize()
    return host / calls * 1e3


def card_event_times(prof) -> list:
    """``[(name, seconds)]`` of the card's events in a stopped
    ``torch.profiler`` profile, read from its raw kineto events: building
    ``prof.events()``'s tree of ``FunctionEvent`` objects costs tens of
    seconds of host time for a whole fit's events, the raw walk a small
    fraction of it. A profiler without them fails here, loudly."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() * 1e-9)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def device_busy(fn) -> dict:
    """Wall seconds of ``fn()`` under ``torch.profiler`` (CUDA activity
    only) and the seconds the card spent in kernels meanwhile, with the
    kernels that took most of it. A failure of ``fn`` propagates; one of
    the profiler is reported in the result, as it is not part of the
    checks."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:
        prof, error = None, f"{type(exc).__name__}: {exc}"
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if prof is None:
        return {"wall_s": wall, "error": error}
    try:
        prof.stop()
        by_name = {}
        for name, sec in card_event_times(prof):
            s, c = by_name.get(name, (0.0, 0))
            by_name[name] = (s + sec, c + 1)
    except Exception as exc:
        return {"wall_s": wall, "error": f"{type(exc).__name__}: {exc}"}
    busy = sum(s for s, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_s": wall, "kernel_s": busy,
            "busy_share": busy / wall if wall else None,
            "kernels": sum(c for _, c in by_name.values()),
            "top": [{"name": n[:90], "s": s, "count": c}
                    for n, (s, c) in top]}


def node_depths(feat, left, right) -> np.ndarray:
    """[T, M] depth of every node reachable from the root (0 elsewhere)."""
    t, m = feat.shape
    depth = np.zeros((t, m), np.int64)
    for ti in range(t):
        stack = [0]
        while stack:
            nid = stack.pop()
            if feat[ti, nid] >= 0:
                for c in (left[ti, nid], right[ti, nid]):
                    depth[ti, c] = depth[ti, nid] + 1
                    stack.append(c)
    return depth


def transform_breakdown(model, table, planes) -> dict:
    """Host-clock seconds of each step of one classification transform,
    run step by step with a synchronise after each device step."""
    from synapseml_tpu_torch.gbdt.boosting import objective_transform
    from synapseml_tpu_torch.gbdt.kernels import forest_traverse

    marks = [("start", time.perf_counter())]

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    feats = model._features(table)
    mark("features_f64")
    x = np.asarray(feats, np.float32)
    mark("to_f32")
    xd = torch.from_numpy(x).cuda()
    mark("h2d")
    out = forest_traverse(xd, *planes, k=1)
    mark("kernel")
    raw = out.cpu().numpy()[:, 0] + model.booster.init_score
    mark("d2h")
    probs = objective_transform(model.booster.params, raw)
    _ = (np.column_stack([1 - probs, probs]), np.column_stack([-raw, raw]))
    mark("objective_and_columns")
    return {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}


DP_FIXTURE = os.path.join(FIXTURES, "lgbm_adult_100x31_dp2.txt")
DP_FIXTURE_IO = os.path.join(FIXTURES, "lgbm_adult_100x31_dp2_io.npz")
DP_TIMEOUT_S = 600            # the one launch of the two data-parallel ranks


def equal_boosters(a, b) -> bool:
    return all(getattr(a, f).tobytes() == getattr(b, f).tobytes()
               for f in ("trees_feature", "trees_threshold", "trees_left",
                         "trees_right", "trees_value", "tree_weights")
               ) and a.init_score == b.init_score


def dp_cases(x_adult, y_adult, dp_params) -> list:
    """The data-parallel cases, run in one launch of two gloo ranks that
    share the card (``tests/torch_dp_worker.py``): the Adult fit through
    ``boosting.train(mesh=)`` once, checked and timed (its collectives
    synchronised and timed; its seconds include the first fit's costs),
    each mode on the card and on the CPU, and a one-rank NCCL group
    against a one-rank gloo group."""
    adult = dict(p=dp_params, x=x_adult, y=y_adult.astype(np.float64),
                 valid_sets=[(x_adult[:4096], y_adult[:4096])])
    cases = [{"name": "adult", "kind": "train", "devices": ["cuda"],
              "kw": dict(adult, time_collectives=True)}]
    xb, yb = synth_rows(20_000, 10, seed=6, classes=2)
    x3, y3 = synth_rows(20_000, 10, seed=3, classes=3)
    xr, yr = synth_rows(20_000, 10, seed=4)
    sys.path.insert(0, FIXTURES)
    import make_lgbm_rank_fixture as rank_fx
    xq, yq, gq = rank_fx.rank_rows(60, 20, seed=3)
    base = dict(num_iterations=8, num_leaves=31)
    modes = {
        "gbdt": (dict(objective="binary"), xb, yb, {}),
        "bagging_feature_fraction": (dict(
            objective="binary", bagging_fraction=0.8, bagging_freq=1,
            feature_fraction=0.8), xb, yb, {}),
        "goss": (dict(objective="binary", boosting_type="goss"), xb, yb, {}),
        "rf": (dict(objective="binary", boosting_type="rf",
                    bagging_fraction=0.7, bagging_freq=1), xb, yb, {}),
        "dart": (dict(objective="binary", boosting_type="dart",
                      drop_rate=0.2, skip_drop=0.3), xb, yb, {}),
        "multiclass_3": (dict(objective="multiclass", num_class=3), x3, y3,
                         {}),
        "lambdarank": (dict(objective="lambdarank"), xq, yq,
                       dict(group=gq)),
        "regression_l1": (dict(objective="regression_l1"), xr, yr, {}),
        "voting_top_k_2": (dict(objective="binary",
                                tree_learner="voting_parallel",
                                voting_top_k=2), xb, yb, {}),
    }
    for name, (pkw, x, y, extra) in modes.items():
        cases.append({"name": name, "kind": "train",
                      "devices": ["cuda", "cpu"],
                      "kw": dict(p={**base, **pkw}, x=x, y=y, **extra)})
    half = len(yb) // 2
    cases.append({"name": "row_sharded", "kind": "row_sharded",
                  "devices": ["cuda", "cpu"],
                  "kw": dict(p={**base, "objective": "binary"},
                             x_parts=[xb[:half], xb[half:]],
                             y_parts=[yb[:half], yb[half:]])})
    cases.append({"name": "one_rank", "kind": "one_rank",
                  "devices": ["cuda"],
                  "kw": dict(p={**base, "objective": "binary"}, x=xb, y=yb,
                             backends=["nccl", "gloo"])})
    return cases


def dp_query(name: str, cases: list) -> np.ndarray:
    """Rows to score a card-against-CPU case's boosters on."""
    kw = next(c["kw"] for c in cases if c["name"] == name)
    return (kw["x"] if "x" in kw else kw["x_parts"][0])[:2000]


def dp_phases(x_adult, y_adult, fit_s, fit_median, smi) -> list:
    """Phases 13-15: one launch of two gloo ranks that share the card
    (``tests/torch_dp_worker.py``, with a timeout; a rank that fails fails
    the launch) runs every case of :func:`dp_cases`; then the checks.
    Returns each rank's K1 and K2 launches of the Adult fit."""
    from synapseml_tpu_torch.gbdt.boosting import Booster
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_dp_worker import run_ranks

    with open(DP_FIXTURE) as fh:
        dp_fixture = Booster.load_string(fh.read())
    dp_io = np.load(DP_FIXTURE_IO)
    dp_params = json.loads(str(dp_io["params"]))
    dp_params["categorical_features"] = tuple(
        dp_params["categorical_features"])
    cases = dp_cases(x_adult, y_adult, dp_params)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        try:
            ranks = run_ranks(work, 2, cases, timeout=DP_TIMEOUT_S,
                              threads=4)
        except RuntimeError as exc:
            raise SystemExit(
                f"chip_smoke: FAILED: data-parallel ranks: {exc}")
    dp_launch_s = time.perf_counter() - start
    for name in [c["name"] for c in cases]:
        for r, res in enumerate(ranks):
            check("error" not in res[name],
                  f"{name} failed on rank {r}: {res[name].get('error')}")

    # 13. the Adult fit at dp=2, held to the JAX 2-device fixture
    fits = [res["adult"]["cuda"] for res in ranks]
    dp_b = fits[0]["booster"]
    dp_ranks_equal = equal_boosters(dp_b, fits[1]["booster"])
    dp_splits = int((dp_b.trees_feature >= 0).sum())
    dp_rt = Booster.load_string(dp_b.save_string())
    same_dp = same_trees(dp_rt, dp_fixture)
    ll_dp = logloss(dp_b.predict_raw(x_adult, device="cuda"), y_adult)
    ll_dp_fixture = float(dp_io["train_logloss"])
    dp_gap = np.abs(dp_b.predict_raw(dp_io["x"], device="cuda") - dp_io["raw"])
    wall = [f["seconds"] for f in fits]
    timed = fits[0]
    dp_counts = [{"histogram": f["k1_launches"],
                  "forest_traverse": f["k2_launches"]} for f in fits]
    emit({"phase": "train_dp_adult",
          "config": "boosting.train(BoostParams of LightGBMClassifier("
                    "num_iterations=100, num_leaves=31, learning_rate=0.1), "
                    "mesh=2-rank gloo group), two ranks sharing one card; "
                    "valid set: the first 4,096 rows",
          "rows": list(x_adult.shape), "rows_per_rank": -(-len(y_adult) // 2),
          "fixture_jax_version": str(dp_io["jax_version"]),
          "launches_per_rank": dp_counts, "splits": dp_splits,
          "trees": len(same_dp),
          "identical_trees_vs_jax_fixture": sum(same_dp),
          "first_difference": first_difference(dp_rt, dp_fixture, same_dp),
          "ranks_bitwise_equal": dp_ranks_equal,
          "train_logloss": ll_dp, "train_logloss_jax_fixture": ll_dp_fixture,
          "margin_gap_mean": float(dp_gap.mean()),
          "margin_gap_max": float(dp_gap.max()),
          "fit_s": wall,
          "fit_rows_iterations_per_s": len(y_adult) * 100 / max(wall),
          "single_device_fit_s": fit_s,
          "single_device_rows_iterations_per_s":
              len(y_adult) * 100 / fit_median,
          "reductions_per_fit": timed["collective_calls"],
          "reduction_bytes_per_fit_per_rank": timed["collective_bytes"],
          "collective_s": timed["collective_s"],
          "collective_share": timed["collective_s"] / timed["seconds"],
          "launch_s": dp_launch_s, "nvidia_smi": smi})
    check(dp_ranks_equal, "the two ranks' Adult boosters differ")
    for c in dp_counts:
        check(c["histogram"] == 100 + dp_splits,
              f"{c['histogram']} K1 launches on a rank for {dp_splits} "
              "splits")
        check(c["forest_traverse"] >= 100,
              f"the dp fit's tracker launched K2 {c['forest_traverse']} "
              "times")
    check(abs(ll_dp - ll_dp_fixture) <= LOGLOSS_TOL,
          f"dp training logloss {ll_dp} vs the JAX fixture's {ll_dp_fixture}")
    check(float(dp_gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"dp mean margin gap {dp_gap.mean()} to the JAX fixture")
    check(not all(same_dp) or float(dp_gap.max()) <= MARGIN_TOL_FIXTURE,
          f"dp max margin gap {dp_gap.max()} with all trees identical")

    # 14. every mode, two card ranks against two CPU ranks: bitwise
    dp_modes = []
    for case in cases[1:-1]:
        name = case["name"]
        card_b = ranks[0][name]["cuda"]["booster"]
        cpu_b = ranks[0][name]["cpu"]["booster"]
        query = dp_query(name, cases)
        gap = float(np.abs(card_b.predict_raw(query, device="cuda")
                           - cpu_b.predict_raw(query, device="cpu")).max())
        same_dev = same_trees(card_b, cpu_b)
        dp_modes.append({
            "fit": name, "kind": case["kind"],
            "trees": len(same_dev), "identical_trees": sum(same_dev),
            "bitwise": equal_boosters(card_b, cpu_b) and gap == 0.0,
            "ranks_bitwise_equal": all(equal_boosters(
                ranks[1][name][d]["booster"], ranks[0][name][d]["booster"])
                for d in ("cuda", "cpu")),
            "first_difference": first_difference(card_b, cpu_b, same_dev),
            "margin_max_gap": gap,
            "k1_launches_card": ranks[0][name]["cuda"]["k1_launches"],
            "fit_s": {d: ranks[0][name][d]["seconds"]
                      for d in ("cuda", "cpu")}})
    emit({"phase": "train_dp_card_vs_cpu", "tolerance": "bitwise",
          "fits": dp_modes})
    for m in dp_modes:
        check(m["bitwise"] and m["ranks_bitwise_equal"],
              f"dp {m['fit']}: two card ranks differ from two CPU ranks or "
              "from each other")
        check(m["k1_launches_card"] > 0, f"dp {m['fit']} did not launch K1")

    # 15. a one-rank NCCL group on the card against a one-rank gloo group
    one = ranks[0]["one_rank"]
    nccl_ok = equal_boosters(one["nccl"]["booster"], one["gloo"]["booster"])
    emit({"phase": "train_nccl_one_rank",
          "fit": "binary, 8 iterations of 31 leaves, 20,000 x 10",
          "bitwise_vs_gloo": nccl_ok,
          "reductions": one["nccl"]["collective_calls"],
          "fit_s": {b: one[b]["seconds"] for b in ("nccl", "gloo")},
          "k1_launches": one["nccl"]["k1_launches"]})
    check(nccl_ok, "the one-rank NCCL fit differs from the one-rank gloo fit")
    check(one["nccl"]["collective_calls"] > 0
          and one["nccl"]["k1_launches"] > 0, "the NCCL fit did not reduce")

    return {"counts": dp_counts, "params": dp_params, "adult": dp_b,
            "adult_same_fixture":
            sum(same_dp), "fixture": dp_fixture,
            "nccl_one_rank": one["nccl"]["booster"], "one_rank_case":
            next(c for c in cases if c["name"] == "one_rank")["kw"]}


PART_TIMEOUT_S = 600          # each launch of the partition-stream ranks
LAUNCH_TIMEOUT_S = 300        # the launcher's smoke fit


def adult_batches(x_adult, y_adult, cols):
    """Rank 0's rows 0-16,280 as 3 record batches, rank 1's rows
    16,281-32,560 as 4, dicts and Tables in turn."""
    from synapseml_tpu_torch.data.table import Table
    n = len(y_adult)
    half = -(-n // 2)
    spans = [[0, 5_000, 11_000, half], [half, 20_000, 24_000, 28_500, n]]
    parts = []
    for bounds in spans:
        batches = []
        for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            d = {c: x_adult[lo:hi, j] for j, c in enumerate(cols)}
            d["label"] = y_adult[lo:hi].astype(np.float64)
            batches.append(Table(d) if i % 2 else d)
        parts.append(batches)
    return parts


def partition_phases(x_adult, y_adult, dp_params, dp, smi) -> list:
    """Phases 16-19: ``data.partitions.fit_partitions`` through the
    driver rendezvous (a ``DriverRendezvous`` in this process on loopback,
    each rank joining through ``fit_partitions(rendezvous=...)``): two
    gloo ranks sharing the card (the Adult fit, then a ranker on the
    gather route, on the card and on the CPU), one NCCL rank; then the
    launcher's smoke fit. Each launch has a timeout that kills its
    workers. Returns each rank's K1 and K2 launches of the Adult fit."""
    from synapseml_tpu_torch.gbdt.boosting import Booster
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_dp_worker import run_ranks
    import make_lgbm_rank_fixture as rank_fx

    cols = [f"f{j}" for j in range(x_adult.shape[1])]
    xq, yq, gq = rank_fx.rank_rows(60, 20, seed=3)
    qcols = [f"q{j}" for j in range(xq.shape[1])]
    first = gq < 30
    rank_parts = [[{**{c: xq[m, j] for j, c in enumerate(qcols)},
                    "label": yq[m], "qid": q}]   # each rank numbers 0..29
                  for m, q in ((first, gq[first]), (~first, gq[~first] - 30))]
    cases = [
        {"name": "adult", "kind": "partitions", "devices": ["cuda"],
         "kw": dict(p=dp_params, batches_parts=adult_batches(
             x_adult, y_adult, cols), feature_cols=cols,
             valid_sets=[(x_adult[:4096], y_adult[:4096])],
             rendezvous=True)},
        {"name": "gather_ranker", "kind": "partitions",
         "devices": ["cuda", "cpu"],
         "kw": dict(p=dict(objective="lambdarank", num_iterations=15,
                           num_leaves=31), batches_parts=rank_parts,
                    feature_cols=qcols, group_col="qid", row_sharded=False)}]
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        try:
            ranks = run_ranks(work, 2, cases, timeout=PART_TIMEOUT_S,
                              threads=4, init="rendezvous", backend="gloo")
        except RuntimeError as exc:
            raise SystemExit(
                f"chip_smoke: FAILED: partition-stream ranks: {exc}")
    launch_s = time.perf_counter() - start
    for name in [c["name"] for c in cases]:
        for r, res in enumerate(ranks):
            check("error" not in res[name],
                  f"{name} failed on rank {r}: {res[name].get('error')}")

    # 16. the Adult fit streamed from two ranks' record batches
    fits = [res["adult"]["cuda"] for res in ranks]
    b = fits[0]["booster"]
    splits = int((b.trees_feature >= 0).sum())
    # through the text format, as phase 13 holds its booster to the fixture
    same = same_trees(Booster.load_string(b.save_string()), dp["fixture"])
    counts = [{"histogram": f["k1_launches"],
               "forest_traverse": f["k2_launches"]} for f in fits]
    stats = [f["stats_out"] for f in fits]
    ranks_equal = equal_boosters(b, fits[1]["booster"])
    equal_dp = equal_boosters(b, dp["adult"])
    emit({"phase": "partitions_rendezvous_adult",
          "config": "fit_partitions(BoostParams of train_dp_adult, 3 and 4 "
                    "record batches (dicts, Tables) a rank, rendezvous="
                    "DriverRendezvous on loopback, backend gloo, "
                    "device cuda): two ranks sharing one card, routed to "
                    "train_row_sharded",
          "rows_per_rank": [s["n_local"] for s in stats],
          "path": [s["path"] for s in stats],
          "backend": [f["backend"] for f in fits],
          "sample_rows_gathered": [s["sample_rows_gathered"] for s in stats],
          "launches_per_rank": counts, "splits": splits,
          "ranks_bitwise_equal": ranks_equal,
          "bitwise_train_dp_adult": equal_dp,
          "identical_trees_vs_jax_fixture": sum(same),
          "rendezvous_s": [s["rendezvous_s"] for s in stats],
          "aggregate_s": [s["aggregate_s"] for s in stats],
          "fit_s": [f["seconds"] for f in fits],
          "reductions_per_fit": [f["collective_calls"] for f in fits],
          "reduction_bytes_per_fit_per_rank":
              [f["collective_bytes"] for f in fits],
          "launch_s": launch_s, "nvidia_smi": smi})
    check(ranks_equal, "the two ranks' partition-stream boosters differ")
    check(equal_dp, "the partition-stream Adult booster is not bitwise the "
          "train_dp_adult booster")
    check(sum(same) == dp["adult_same_fixture"],
          f"{sum(same)} trees of the dp fixture, train_dp_adult has "
          f"{dp['adult_same_fixture']}")
    for s, f in zip(stats, fits):
        check(s["path"] == "row_sharded" and f["backend"] == "gloo",
              f"partition fit routed to {s['path']} over {f['backend']}")
        check(s["sample_rows_gathered"] == len(y_adult),
              f"{s['sample_rows_gathered']} bin-sample rows gathered")
    for c, c_dp in zip(counts, dp["counts"]):
        check(c == c_dp and c["histogram"] == 100 + splits
              and c["forest_traverse"] == 100,
              f"partition fit launches {c} a rank (train_dp_adult {c_dp}, "
              f"{splits} splits)")

    # 17. a ranker on the gather route: two card ranks against two CPU ranks
    g = ranks[0]["gather_ranker"]
    card_b, cpu_b = g["cuda"]["booster"], g["cpu"]["booster"]
    q_rows = xq[:2000]
    gap = float(np.abs(card_b.predict_raw(q_rows, device="cuda")
                       - cpu_b.predict_raw(q_rows, device="cpu")).max())
    g_bitwise = equal_boosters(card_b, cpu_b) and gap == 0.0
    g_ranks = all(equal_boosters(ranks[1]["gather_ranker"][d]["booster"],
                                 g[d]["booster"]) for d in ("cuda", "cpu"))
    emit({"phase": "partitions_gather_ranker",
          "fit": "lambdarank, 15 iterations of 31 leaves, 60 queries "
                 f"({len(yq)} x {xq.shape[1]}), 30 a rank numbered 0..29 "
                 "on each, row_sharded=False",
          "path": g["cuda"]["stats_out"]["path"], "tolerance": "bitwise",
          "bitwise_vs_cpu_ranks": g_bitwise, "ranks_bitwise_equal": g_ranks,
          "margin_max_gap": gap, "trees": card_b.num_trees,
          "k1_launches_card": g["cuda"]["k1_launches"],
          "fit_s": {d: g[d]["seconds"] for d in ("cuda", "cpu")}})
    check(g["cuda"]["stats_out"]["path"] == "gather",
          f"ranker routed to {g['cuda']['stats_out']['path']}")
    check(g_bitwise and g_ranks, "the gather-route ranker: card ranks differ "
          "from CPU ranks or from each other")
    check(g["cuda"]["k1_launches"] > 0, "the gather-route ranker did not "
          "launch K1")

    # 18. one NCCL rank with an explicit coordinator, against phase 15's
    # one-rank NCCL group fit of the same rows
    one = dp["one_rank_case"]
    half = len(one["y"]) // 2
    one_parts = [[{**{f"f{j}": one["x"][lo:hi, j]
                      for j in range(one["x"].shape[1])},
                   "label": one["y"][lo:hi]}
                  for lo, hi in ((0, half), (half, len(one["y"])))]]
    nccl_case = {"name": "nccl", "kind": "partitions", "devices": ["cuda"],
                 "kw": dict(p=one["p"], batches_parts=one_parts,
                            feature_cols=[f"f{j}" for j in range(
                                one["x"].shape[1])],
                            row_sharded=True, rendezvous=True)}
    with tempfile.TemporaryDirectory() as work:
        try:
            res = run_ranks(work, 1, [nccl_case], timeout=PART_TIMEOUT_S,
                            threads=4, init="rendezvous", backend="nccl",
                            local_device=0)[0]["nccl"]
        except RuntimeError as exc:
            raise SystemExit(f"chip_smoke: FAILED: one NCCL rank: {exc}")
    check("error" not in res, f"one NCCL rank failed: {res.get('error')}")
    fit = res["cuda"]
    nccl_equal = equal_boosters(fit["booster"], dp["nccl_one_rank"])
    emit({"phase": "rendezvous_nccl_one_rank",
          "fit": "fit_partitions(row_sharded=True) of train_nccl_one_rank's "
                 "rows in 2 batches, a world of one, backend nccl, "
                 "local_device 0",
          "backend": fit["backend"], "path": fit["stats_out"]["path"],
          "bitwise_vs_train_nccl_one_rank": nccl_equal,
          "reductions": fit["collective_calls"],
          "rendezvous_s": fit["stats_out"]["rendezvous_s"],
          "fit_s": fit["seconds"], "k1_launches": fit["k1_launches"]})
    check(fit["backend"] == "nccl" and fit["stats_out"]["path"]
          == "row_sharded", "the one-rank fit did not run row-sharded over "
          "NCCL")
    check(nccl_equal, "the one-rank NCCL partition fit differs from "
          "train_nccl_one_rank's")
    check(fit["collective_calls"] > 0 and fit["k1_launches"] > 0,
          "the one-rank NCCL partition fit did not reduce or launch K1")

    # 19. the launcher's built-in smoke fit on the card, single process
    env = dict(os.environ, PYTHONPATH=HERE)
    for var in ("SYNAPSEML_COORDINATOR", "SYNAPSEML_NUM_PROCESSES",
                "SYNAPSEML_PROCESS_ID"):
        env.pop(var, None)
    start = time.perf_counter()
    try:
        run = subprocess.run(
            [sys.executable, "-m", "synapseml_tpu_torch.parallel.launch"],
            env=env, cwd=HERE, capture_output=True, text=True,
            timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise SystemExit("chip_smoke: FAILED: the launcher did not finish "
                         f"within {LAUNCH_TIMEOUT_S} s") from None
    acc = [ln.split("acc=")[-1] for ln in run.stdout.splitlines()
           if "smoke-fit acc=" in ln]
    emit({"phase": "launch_smoke",
          "command": "python -m synapseml_tpu_torch.parallel.launch",
          "returncode": run.returncode, "smoke_fit_acc": acc,
          "seconds": time.perf_counter() - start,
          "stdout": run.stdout.strip().splitlines()[-2:]})
    check(run.returncode == 0 and acc and "device=cuda" in run.stdout,
          f"the launcher exited {run.returncode}: {run.stderr[-2000:]}")
    return counts


RESNET_FIXTURE = os.path.join(FIXTURES, "resnet50_224_logits.npz")
ONNX_FIXTURES = ("torch_cnn", "torch_gru", "torch_transformer",
                 "torch_quant_cnn", "torch_kv_decoder")
# ResNet-50 at 224x224: 4.09 G multiply-adds an image (torchvision's
# ResNet50_Weights.IMAGENET1K_V1 card, "GFLOPS 4.09"), 2 operations each
RESNET50_OPS = 2 * 4.09e9
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
LOGITS_TOL = 1e-3             # float32 logits against the JAX fixture
BF16_SPAN_SHARE = 0.05        # bf16 logits: 5% of the float32 largest |logit|
THROUGHPUT_BATCH, THROUGHPUT_FORWARDS = 128, 30


class TransferCount:
    """A dispatch mode that counts the copies between the host and the card
    that the calls under it dispatch (``.to``, ``copy_``: host to card and
    back) and the scalar reads of a card tensor (``.item()``)."""

    # under inference_mode ``.to`` reaches the mode undecomposed
    COPIES = ("to", "_to_copy", "copy_", "_copy_from",
              "_copy_from_and_resize")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self.counts = {"h2d": 0, "d2h": 0}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.overloadpacket.__name__
                if name in TransferCount.COPIES:
                    src = args[1] if name.startswith("copy_") else args[0]
                    dst = out if isinstance(out, torch.Tensor) else args[0]
                    route = (src.device.type, dst.device.type)
                    if route == ("cpu", "cuda"):
                        counts["h2d"] += 1
                    elif route == ("cuda", "cpu"):
                        counts["d2h"] += 1
                elif name == "_local_scalar_dense" and \
                        args[0].device.type == "cuda":
                    counts["d2h"] += 1
                return out

        self.mode = Mode()


def copies_and_syncs(fn, *args) -> dict:
    """One warm call of ``fn``: its host<->card copies as the calls it
    dispatches show them (:class:`TransferCount`), its synchronizing calls
    (warnings of CUDA's sync debug mode, on for the call alone), and what
    the profiler recorded of it on the card (its memcpy records and its
    operations: in a long-lived process the profiler does not always get
    every record, so the checks read the dispatched copies)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    transfers = TransferCount()
    with transfers.mode:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"h2d_copies": transfers.counts["h2d"],
            "d2h_copies": transfers.counts["d2h"],
            "syncs": sum("called a synchronizing CUDA operation"
                         in str(w.message) for w in caught),
            "profiler_memcpy": [n for n in names if "Memcpy" in n],
            "profiler_device_ops": len(names)}


def onnx_phases(smi, reset_counts, read_counts) -> None:
    """Phases 20-21: the imported-ONNX forward. ``zoo.resnet50`` (seed 0,
    224x224, 1,000 classes) parsed and lowered by the port, run on
    ``entry()``'s 8 images through the float32 and the bf16 bind and held
    to the JAX package's logits (``tests/fixtures/resnet50_224_logits.npz``);
    images/s at batch 128 (30 forwards after a warm one, CUDA events) and
    the share of the card's peak; the card's busy share in one batch-8 and
    one batch-128 forward; the copies and syncs of a warm forward. Then
    the five torch-exported graphs against their recorded outputs."""
    import make_resnet50_fixture as resnet_fx
    from synapseml_tpu_torch.onnx import import_model, zoo

    reset_counts()
    start = time.perf_counter()
    blob = zoo.resnet50(num_classes=1000)
    zoo_s = time.perf_counter() - start
    start = time.perf_counter()
    graph = import_model(blob)
    import_s = time.perf_counter() - start
    binds = {}
    for name, cast in (("float32", None), ("bf16", torch.bfloat16)):
        start = time.perf_counter()
        binds[name] = graph.bind(cast_dtype=cast)
        torch.cuda.synchronize()
        binds[name + "_s"] = time.perf_counter() - start
    f32, bf16 = binds["float32"], binds["bf16"]

    fx = np.load(RESNET_FIXTURE)
    want = fx["logits_f32"]
    images = resnet_fx.images()
    x32 = torch.from_numpy(images).cuda()
    x16 = x32.to(torch.bfloat16)
    out32, out16 = f32(x32)[0], bf16(x16)[0]
    from_host = f32(images)[0]
    torch.cuda.synchronize()
    got32 = out32.cpu().numpy()
    got16 = out16.float().cpu().numpy()
    span = float(np.abs(want).max())
    f32_err = float(np.abs(got32 - want).max())
    bf16_err = float(np.abs(got16 - want).max())
    f32_ok = bool(np.allclose(got32, want, rtol=LOGITS_TOL, atol=LOGITS_TOL))
    bf16_ok = bf16_err <= BF16_SPAN_SHARE * span
    host_gap = float((from_host - out32).abs().max())
    warm = {"bf16_device_input": copies_and_syncs(bf16, x16),
            "float32_device_input": copies_and_syncs(f32, x32),
            "float32_numpy_input": copies_and_syncs(f32, images)}

    rng = np.random.default_rng(1)
    x128 = torch.from_numpy(rng.standard_normal(
        (THROUGHPUT_BATCH, 3, 224, 224)).astype(np.float32)).cuda()
    throughput = {}
    for name, fn, x in (("float32", f32, x128),
                        ("bf16", bf16, x128.to(torch.bfloat16))):
        ms = event_ms(lambda: fn(x), THROUGHPUT_FORWARDS)
        rate = THROUGHPUT_BATCH / ms * 1e3
        peak = BF16_OPS_PER_S if name == "bf16" else FP32_OPS_PER_S
        throughput[name] = {
            "images_per_s": rate, "ms_per_forward": ms,
            "peak_share": rate * RESNET50_OPS / peak,
            "peak_ops_per_s": peak}
    x128_16 = x128.to(torch.bfloat16)
    busy = {"bf16_batch8": device_busy(lambda: bf16(x16)),
            "bf16_batch128": device_busy(lambda: bf16(x128_16)),
            "float32_batch8": device_busy(lambda: f32(x32))}

    # a forward is ~250 launches: a few forwards behind the spin stay
    # within the launch queue, so the host never waits for the card
    batch8 = {}
    for name, fn, x in (("bf16", bf16, x16), ("float32", f32, x32)):
        issue = host_ms(lambda: fn(x), calls=2)
        wall = synced_wall_ms(lambda: fn(x))
        device = cuda_ms(lambda: fn(x), reps=5, inner=3)
        batch8[name] = {"host_issue_ms": issue, "wall_ms": wall,
                        "device_ms": device, "host_share": issue / wall}
    counts = read_counts()
    emit({"phase": "onnx_resnet50_224", "model": "zoo.resnet50 seed 0, "
          "224x224, 1000 classes", "nodes": len(graph._nodes),
          "params": len(graph.params), "param_bytes": graph.param_bytes(),
          "zoo_s": zoo_s, "import_s": import_s,
          "bind_float32_s": binds["float32_s"], "bind_bf16_s": binds["bf16_s"],
          "logits_shape": list(got32.shape),
          "float32_max_abs_err": f32_err, "float32_tolerance":
          f"rtol=atol={LOGITS_TOL}", "float32_ok": f32_ok,
          "bf16_max_abs_err": bf16_err, "bf16_limit": BF16_SPAN_SHARE * span,
          "bf16_gap_to_jax_bf16": float(np.abs(
              got16 - fx["logits_bf16"]).max()), "bf16_ok": bool(bf16_ok),
          "numpy_input_vs_device_input_max_abs": host_gap,
          "warm_forward": warm, "throughput_batch128": throughput,
          "resnet50_ops_per_image": RESNET50_OPS,
          "device_busy": busy, "batch8": batch8,
          "kernel_launches": counts, "nvidia_smi": smi})
    check(got32.shape == (8, 1000) and np.isfinite(got32).all()
          and np.isfinite(got16).all(), "ResNet-50 logits not finite [8, 1000]")
    check(out32.dtype == torch.float32 and out16.dtype == torch.bfloat16,
          f"ResNet-50 logits dtypes {out32.dtype}, {out16.dtype}")
    check(f32_ok, f"float32 ResNet-50 logits off the JAX fixture by {f32_err}")
    check(bf16_ok, f"bf16 ResNet-50 logits off the JAX fixture by {bf16_err}"
          f" (limit {BF16_SPAN_SHARE * span})")
    check(host_gap <= LOGITS_TOL * span,
          f"numpy input and device input differ by {host_gap}")
    for name, w in warm.items():
        check(w["syncs"] == 0 and w["d2h_copies"] == 0,
              f"a warm ResNet-50 forward ({name}) synchronised: {w}")
        check(w["h2d_copies"] == (1 if "numpy" in name else 0),
              f"a warm ResNet-50 forward ({name}) copied to the card: {w}")
    check(not any(counts.values()), f"ONNX path launched {counts}")

    results = []
    for name in ONNX_FIXTURES:
        io = np.load(os.path.join(FIXTURES, f"{name}_io.npz"))
        keys, wants = ((["input_ids", "past_key", "past_value"],
                        ["logits", "present_key", "present_value"])
                       if name == "torch_kv_decoder" else
                       (["input"], ["expected"]))
        fn = import_model(os.path.join(FIXTURES, f"{name}.onnx")).bind()
        outs = fn(*[torch.from_numpy(io[k]).cuda() for k in keys])
        errs, ok = [], True
        for out, w in zip(outs, wants):
            got = out.cpu().numpy()
            err = np.abs(got - io[w])
            errs.append(float(err.max()))
            ok &= got.shape == io[w].shape and out.device.type == "cuda"
            if name == "torch_quant_cnn":
                step = float(io["out_scale"])
                ok &= bool(err.max() <= 2 * step + 1e-7
                           and (err <= step + 1e-7).mean() > 0.95)
            else:
                ok &= bool(np.allclose(got, io[w], atol=1e-5, rtol=1e-5))
        results.append({"graph": name, "max_abs_err": errs, "ok": ok,
                        "tolerance": "2 output steps, >95% within one"
                        if name == "torch_quant_cnn" else "rtol=atol=1e-5"})
    emit({"phase": "onnx_fixtures", "graphs": results, "nvidia_smi": smi})
    for r in results:
        check(r["ok"], f"{r['graph']} off its recorded outputs: {r}")


TRANSFORMER_FIXTURE = os.path.join(FIXTURES, "transformer_graphs.npz")
ENCODER_TOL = 1e-3            # BERT-base float32 output against the JAX fixture
SMALL_GRAPH_TOL = 1e-4        # the card against JAX's CPU run, small graphs
INCREMENTAL_TOL = 1e-4        # decode steps against one full forward (float32)
ENCODER_BATCH, ENCODER_FORWARDS = 128, 20
# the decoder at BERT-base width, the graph the decode scheduler serves
DECODER_WIDE = dict(vocab=30522, d_model=768, n_heads=12, kv_heads=4,
                    n_layers=12, max_seq=1024, seed=0)
DECODE_BATCH, DECODE_PREFILL, DECODE_STEPS = 8, 128, 32


def synced_wall_ms(fn, calls: int = 20) -> float:
    """Median host wall ms of ``fn()`` from a synchronised card to the
    card synchronised after it."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - begin) * 1e3)
    return statistics.median(times)


def issue_ms(fn, reps: int = 5) -> float:
    """Median host ms one call of ``fn`` takes to return while the card is
    busy with a device-side spin: the issue time alone, the launch queue
    (~1,000 entries) not yet full for a call of up to ~1,000 launches."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        begin = time.perf_counter()
        fn()
        times.append((time.perf_counter() - begin) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def event_ms(fn, calls: int) -> float:
    """Mean ms a call of ``fn`` over ``calls`` back-to-back calls after a
    warm one, between two CUDA events (the host's issue overlaps the
    card's work)."""
    fn()
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / calls


def encoder_ops(cfg: dict) -> float:
    """Operations of one sequence through ``zoo.transformer_encoder``: two
    a multiply-add of the Q, K, V, output and FFN products (4 d^2 + 2 d f a
    token a layer) and of the attention's two products (2 S^2 d a layer);
    the elementwise work is not counted."""
    s, d, f = cfg["seq_len"], cfg["d_model"], cfg["ffn_dim"]
    return cfg["n_layers"] * 2 * (s * (4 * d * d + 2 * d * f) + 2 * s * s * d)


def transformer_phases(smi, reset_counts, read_counts) -> None:
    """Phases 22-23: the transformer and recurrent graphs; returns the
    kernels' launch counts of each phase (none expected). The BERT-base
    causal encoder (float32 and bf16 binds against the JAX fixture,
    sequences/s at batch 128, batch-1 issue against wall, busy share,
    a warm forward's copies and syncs); then the default ``tiny_decoder``
    against the JAX fixture, the decoder at BERT-base width (a 128-token
    prefill at batch 8 into zeroed [8, 4, 1024, 64] buffers, 32 decode
    steps through the returned buffers, each step's logits against one
    full forward of the same tokens; prefill tokens/s, ms a step, a warm
    step's copies and syncs) and the example-width BiLSTM tagger against
    the JAX fixture."""
    import make_transformer_fixtures as tfx
    from synapseml_tpu_torch.onnx import import_model, zoo

    fixture = np.load(TRANSFORMER_FIXTURE)
    reset_counts()
    # -- 22. the BERT-base causal encoder --------------------------------
    start = time.perf_counter()
    blob = zoo.transformer_encoder(**tfx.ENCODER)
    zoo_s = time.perf_counter() - start
    start = time.perf_counter()
    graph = import_model(blob)
    import_s = time.perf_counter() - start
    del blob
    binds = {}
    for name, cast in (("float32", None), ("bf16", torch.bfloat16)):
        start = time.perf_counter()
        binds[name] = graph.bind(cast_dtype=cast)
        torch.cuda.synchronize()
        binds[name + "_s"] = time.perf_counter() - start
    f32, bf16 = binds["float32"], binds["bf16"]
    ids = torch.from_numpy(tfx.encoder_tokens()).cuda()
    want = fixture["enc_f32"]
    got32 = f32(ids)[0].cpu().numpy()
    got16 = bf16(ids)[0].float().cpu().numpy()
    span = float(np.abs(want).max())
    f32_err = float(np.abs(got32 - want).max())
    bf16_err = float(np.abs(got16 - want).max())
    f32_ok = bool(np.allclose(got32, want, rtol=ENCODER_TOL,
                              atol=ENCODER_TOL))
    bf16_ok = bf16_err <= BF16_SPAN_SHARE * span
    warm = {"float32": copies_and_syncs(f32, ids),
            "bf16": copies_and_syncs(bf16, ids)}

    ops = encoder_ops(tfx.ENCODER)
    big = torch.from_numpy(np.random.default_rng(3).integers(
        0, tfx.ENCODER["vocab"], (ENCODER_BATCH, tfx.ENCODER["seq_len"]))
    ).cuda()
    throughput = {}
    for name, fn in (("float32", f32), ("bf16", bf16)):
        ms = event_ms(lambda: fn(big), ENCODER_FORWARDS)
        rate = ENCODER_BATCH / ms * 1e3
        peak = BF16_OPS_PER_S if name == "bf16" else FP32_OPS_PER_S
        throughput[name] = {"sequences_per_s": rate, "ms_per_forward": ms,
                            "peak_share": rate * ops / peak,
                            "peak_ops_per_s": peak}
    one = ids[:1]
    batch1 = {}
    for name, fn in (("bf16", bf16), ("float32", f32)):
        issue = issue_ms(lambda: fn(one))
        wall = synced_wall_ms(lambda: fn(one))
        batch1[name] = {"host_issue_ms": issue, "wall_ms": wall,
                        "device_ms": cuda_ms(lambda: fn(one), reps=5,
                                             inner=3),
                        "host_share": issue / wall}
    busy = {"bf16_batch1": device_busy(lambda: bf16(one)),
            "bf16_batch128": device_busy(lambda: bf16(big)),
            "float32_batch128": device_busy(lambda: f32(big))}
    counts = read_counts()
    emit({"phase": "onnx_bert_base_causal", "model": "zoo.transformer_"
          "encoder(30522, 768, 12, 3072, 12, seq_len=128, causal=True, "
          "seed=0)", "nodes": len(graph._nodes),
          "params": int(sum(v.size for v in graph.params.values())),
          "param_bytes": graph.param_bytes(), "zoo_s": zoo_s,
          "import_s": import_s, "bind_float32_s": binds["float32_s"],
          "bind_bf16_s": binds["bf16_s"], "output_shape": list(got32.shape),
          "float32_max_abs_err": f32_err,
          "float32_tolerance": f"rtol=atol={ENCODER_TOL}",
          "float32_ok": f32_ok, "bf16_max_abs_err": bf16_err,
          "bf16_limit": BF16_SPAN_SHARE * span,
          "bf16_gap_to_jax_bf16": float(np.abs(
              got16 - fixture["enc_bf16"]).max()), "bf16_ok": bool(bf16_ok),
          "warm_forward": warm, "ops_per_sequence": ops,
          "throughput_batch128": throughput, "batch1": batch1,
          "device_busy": busy, "kernel_launches": counts,
          "nvidia_smi": smi})
    check(got32.shape == (2, 128, 768) and np.isfinite(got32).all()
          and np.isfinite(got16).all(), "encoder output not finite")
    check(f32_ok, f"float32 encoder off the JAX fixture by {f32_err}")
    check(bf16_ok, f"bf16 encoder off the JAX fixture by {bf16_err} "
          f"(limit {BF16_SPAN_SHARE * span})")
    for name, w in warm.items():
        check(w["syncs"] == 0 and w["d2h_copies"] == 0
              and w["h2d_copies"] == 0,
              f"a warm encoder forward ({name}) synchronised or copied: {w}")
    check(not any(counts.values()), f"encoder path launched {counts}")
    encoder_counts = counts
    del graph, f32, bf16, binds
    torch.cuda.empty_cache()

    # -- 23. the GQA decoder and the BiLSTM tagger -----------------------
    reset_counts()
    tiny = import_model(zoo.tiny_decoder()).bind()

    def zeros(batch, t, kv, head, layers, dtype=torch.float32):
        return [torch.zeros((batch, kv, t, head), dtype=dtype,
                            device="cuda") for _ in range(2 * layers)]

    tiny_logits = tfx.decode_stream(
        tiny, tfx.decoder_tokens(), zeros(tfx.DECODER_BATCH,
                                          tfx.DECODER_BUFFER, 2, 8, 2),
        2, lambda a: torch.from_numpy(a).cuda(),
        lambda t: t.cpu().numpy())
    tiny_err = float(np.abs(tiny_logits - fixture["dec_logits"]).max())
    tiny_ok = bool(np.allclose(tiny_logits, fixture["dec_logits"],
                               rtol=SMALL_GRAPH_TOL, atol=SMALL_GRAPH_TOL))
    tagger = import_model(zoo.bilstm_tagger(**tfx.TAGGER)).bind()
    tags = tagger(torch.from_numpy(tfx.tagger_tokens()).cuda())[0]
    tags = tags.cpu().numpy()
    tagger_err = float(np.abs(tags - fixture["lstm_out"]).max())
    tagger_ok = bool(np.allclose(tags, fixture["lstm_out"],
                                 rtol=SMALL_GRAPH_TOL, atol=SMALL_GRAPH_TOL))

    layers, kv = DECODER_WIDE["n_layers"], DECODER_WIDE["kv_heads"]
    head = DECODER_WIDE["d_model"] // DECODER_WIDE["n_heads"]
    t_buf = DECODER_WIDE["max_seq"]
    start = time.perf_counter()
    blob = zoo.tiny_decoder(**DECODER_WIDE)
    wide_zoo_s = time.perf_counter() - start
    start = time.perf_counter()
    wide = import_model(blob)
    wide_import_s = time.perf_counter() - start
    wide_bytes = len(blob)
    del blob
    n_tok = DECODE_PREFILL + DECODE_STEPS
    stream = torch.from_numpy(np.random.default_rng(4).integers(
        0, DECODER_WIDE["vocab"], (DECODE_BATCH, n_tok))).cuda()

    def lens(n):
        return torch.full((DECODE_BATCH,), n - 1, dtype=torch.int32,
                          device="cuda")

    decode = {}
    incremental = {}
    for name, cast in (("float32", None), ("bf16", torch.bfloat16)):
        fn = wide.bind(cast_dtype=cast)
        dt = cast or torch.float32
        empty = zeros(DECODE_BATCH, t_buf, kv, head, layers, dt)
        prompt = stream[:, :DECODE_PREFILL]
        pre_lens = lens(DECODE_PREFILL)
        outs = fn(prompt, pre_lens, *empty)
        logits = [outs[0].float()]
        buffers = list(outs[1:])
        for i in range(DECODE_PREFILL, n_tok):
            outs = fn(stream[:, i:i + 1], lens(i + 1), *buffers)
            logits.append(outs[0].float())
            buffers = list(outs[1:])
        steps = torch.cat(logits, dim=1)
        full = fn(stream, lens(n_tok), *empty)[0].float()
        err = float((steps - full).abs().max())
        tol = (INCREMENTAL_TOL if cast is None
               else BF16_SPAN_SHARE * float(full.abs().max()))
        incremental[name] = {
            "max_abs_err": err, "tolerance": tol,
            "max_abs_logit": float(full.abs().max()),
            "greedy_equal_share": float(
                (steps.argmax(-1) == full.argmax(-1)).float().mean()),
            "ok": bool(torch.isfinite(steps).all()) and err <= tol}
        del logits, steps, full
        # timings: a prefill chunk into the zeroed buffers and one decode
        # step at the stream's last position; both return new buffers, so
        # repeated calls do the same work. A call issues ~1,000 launches:
        # host-bound, so its card time is the profiler's kernel time
        last = stream[:, n_tok - 1:n_tok]
        step_lens = lens(n_tok)

        def prefill():
            return fn(prompt, pre_lens, *empty)

        def step():
            return fn(last, step_lens, *buffers)

        prefill_wall_ms = synced_wall_ms(prefill, calls=5)
        step_wall_ms = synced_wall_ms(step)
        decode[name] = {
            "prefill_wall_ms": prefill_wall_ms,
            "prefill_tokens_per_s": DECODE_BATCH * DECODE_PREFILL
            / prefill_wall_ms * 1e3,
            "prefill_host_issue_ms": issue_ms(prefill),
            "prefill_device_busy": device_busy(prefill),
            "step_wall_ms": step_wall_ms,
            "step_host_issue_ms": issue_ms(step),
            "decode_tokens_per_s": DECODE_BATCH / step_wall_ms * 1e3,
            "warm_step": copies_and_syncs(fn, last, step_lens, *buffers),
            "step_device_busy": device_busy(step)}
        del fn, empty, buffers
        torch.cuda.empty_cache()
    counts = read_counts()
    emit({"phase": "onnx_decoder_gqa", "tiny_decoder_max_abs_err": tiny_err,
          "tiny_decoder_ok": tiny_ok, "bilstm_max_abs_err": tagger_err,
          "bilstm_ok": tagger_ok,
          "small_graph_tolerance": f"rtol=atol={SMALL_GRAPH_TOL}",
          "wide_model": "zoo.tiny_decoder(" + ", ".join(
              f"{k}={v}" for k, v in DECODER_WIDE.items()) + ")",
          "wide_params": int(sum(v.size for v in wide.params.values())),
          "wide_graph_bytes": wide_bytes, "wide_zoo_s": wide_zoo_s,
          "wide_import_s": wide_import_s, "batch": DECODE_BATCH,
          "prefill_tokens": DECODE_PREFILL, "decode_steps": DECODE_STEPS,
          "buffer": [DECODE_BATCH, kv, t_buf, head],
          "incremental_vs_full": incremental, "timings": decode,
          "kernel_launches": counts, "nvidia_smi": smi})
    check(tiny_ok, f"tiny_decoder off the JAX fixture by {tiny_err}")
    check(tagger_ok, f"BiLSTM tagger off the JAX fixture by {tagger_err}")
    for name, r in incremental.items():
        check(r["ok"], f"{name} decode steps differ from a full forward: {r}")
    for name, d in decode.items():
        w = d["warm_step"]
        check(w["syncs"] == 0 and w["d2h_copies"] == 0
              and w["h2d_copies"] == 0,
              f"a warm {name} decode step synchronised or copied: {w}")
    check(not any(counts.values()), f"decoder path launched {counts}")
    return {"encoder": encoder_counts, "decoder": counts}


MODEL_ROWS, MODEL_BATCH, STREAM_TABLES = 1000, 128, 8
# ImageNet's per-channel mean and 1/std in pixel units: the uint8 wire's
# on-card normalisation
IMAGENET_NORM = {"mean": np.array([123.675, 116.28, 103.53]).reshape(3, 1, 1),
                 "scale": 1.0 / np.array([58.395, 57.12, 57.375]).reshape(
                     3, 1, 1)}


def wall_median(fn, calls: int = 3):
    """Median host seconds of ``fn()`` (whose result ends on the host)
    after one warm call, and the last call's result."""
    fn()
    times = []
    for _ in range(calls):
        start = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - start)
    return statistics.median(times), out


def executor_stages(tm) -> dict:
    """The executor's stage histograms since the last ``tm.reset()``: the
    batches, seconds summed and median of each stage."""
    out = {}
    for stage in ("stage", "dispatch", "compute", "drain"):
        h = tm.histogram(f"executor_{stage}_seconds")
        out[stage] = {"batches": h.count, "sum_s": h.sum,
                      "p50_s": h.percentile(0.5)}
    return out


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def copy_overlap(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CUDA activity, the
    tracer started on a warm-up first): its wall, the span from its first
    card record to its last, the card's busy share (the union of its
    kernels' intervals over the wall), and the host-to-card copies' time
    against the part of it that ran while a kernel ran. A profiler failure
    is reported, not checked."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)  # the tracer's start-up
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        kernels, h2d = [], []
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            span = (e.time_range.start, e.time_range.end)
            if "Memcpy HtoD" in e.name:
                h2d.append(span)
            elif "Memcpy" not in e.name and "Memset" not in e.name:
                kernels.append(span)
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    busy = _union(kernels)
    overlapped = sum(max(0, min(b, kb) - max(a, ka))
                     for a, b in h2d for ka, kb in busy)
    h2d_us = sum(b - a for a, b in h2d)
    spans = kernels + h2d
    return {"wall_s": wall, "kernels": len(kernels),
            "device_span_s": (max(b for _, b in spans)
                              - min(a for a, _ in spans)) * 1e-6
            if spans else None,
            "kernel_union_s": sum(b - a for a, b in busy) * 1e-6,
            "busy_share": sum(b - a for a, b in busy) * 1e-6 / wall,
            "h2d_copies": len(h2d), "h2d_s": h2d_us * 1e-6,
            "h2d_overlapped_s": overlapped * 1e-6,
            "h2d_overlapped_share": overlapped / h2d_us if h2d_us else None}


def onnx_model_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 24: ``ONNXModel.transform`` over ResNet-50 224 (seed 0) on
    the batched executor, ``mini_batch_size=128``: a 1,000-image table
    (7 full buckets and a 104-row tail; rows 0-7 are ``entry()``'s images)
    in float32, in bf16, and in bf16 fed uint8 pixels normalised on the
    card; each bucket bitwise the port's ``bind()`` forward of the same
    padded batch, rows 0-7 against the JAX fixture, the uint8 wire against
    bf16 on host-normalised pixels, ``transform_stream`` over 8 tables of
    128 rows against ``transform``, softmax and argmax against the logits,
    and the BERT-base causal encoder on an int64 token column against its
    ``bind()`` forward. Images/s through ``transform`` beside ``bind()``'s
    over the same rows, the executor's stage seconds, the card's busy
    share and the host-to-card copies overlapped with kernels. Returns the
    kernels' launch counts (none expected) and what phase 25 compares
    with: the graph's bytes, the tables, the logits, the rates, the stage
    seconds and the 8-row walls."""
    import make_resnet50_fixture as resnet_fx
    import make_transformer_fixtures as tfx
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, zoo
    from synapseml_tpu_torch.runtime import telemetry as tm

    reset_counts()
    phase_start = time.perf_counter()
    blob = zoo.resnet50(num_classes=1000)
    x = np.empty((MODEL_ROWS, 3, 224, 224), np.float32)
    x[:8] = resnet_fx.images()
    x[8:] = np.random.default_rng(1).standard_normal(
        (MODEL_ROWS - 8, 3, 224, 224), dtype=np.float32)
    pixels = np.random.default_rng(2).integers(
        0, 256, (MODEL_ROWS, 3, 224, 224), dtype=np.uint8)
    models = {
        "float32": ONNXModel(model_bytes=blob, mini_batch_size=MODEL_BATCH),
        "bf16": ONNXModel(model_bytes=blob, mini_batch_size=MODEL_BATCH,
                          compute_dtype="bfloat16"),
        "bf16_uint8": ONNXModel(model_bytes=blob,
                                mini_batch_size=MODEL_BATCH,
                                compute_dtype="bfloat16",
                                input_norm={"data": IMAGENET_NORM})}
    graph = models["float32"].graph
    out_name = graph.output_names[0]
    tables = {"float32": Table({"data": x}), "bf16": Table({"data": x}),
              "bf16_uint8": Table({"data": pixels})}
    rates, outs, stages, first_s = {}, {}, {}, {}
    for name, model in models.items():
        start = time.perf_counter()
        model.transform(tables[name])
        first_s[name] = time.perf_counter() - start
        tm.reset()
        s, t = wall_median(lambda: model.transform(tables[name]))
        stages[name] = executor_stages(tm)
        rates[name] = {"images_per_s": MODEL_ROWS / s, "wall_s": s}
        outs[name] = np.asarray(t[out_name])

    # bind() over the same rows, in the same buckets: the forward alone
    # on card-resident batches, and a serial host round trip a bucket
    binds = {"float32": graph.bind(),
             "bf16": graph.bind(cast_dtype=torch.bfloat16)}
    starts = range(0, MODEL_ROWS, MODEL_BATCH)
    padded = []
    for s0 in starts:
        b = x[s0:s0 + MODEL_BATCH]
        padded.append((np.concatenate([b, np.zeros(
            (MODEL_BATCH - len(b),) + b.shape[1:], np.float32)]), len(b)))
    bucket_bitwise, bind_rates = {}, {}
    for name, fn in binds.items():
        cast = torch.bfloat16 if name == "bf16" else torch.float32
        on_card = [torch.from_numpy(p).cuda().to(cast) for p, _ in padded]
        same = []
        for (p, n), xd, s0 in zip(padded, on_card, starts):
            got = fn(xd)[0][:n].float().cpu().numpy()
            same.append(bool(np.array_equal(
                got, outs[name][s0:s0 + n])))
        bucket_bitwise[name] = same

        def forward_only(fn=fn, on_card=on_card):
            for xd in on_card:
                fn(xd)
            torch.cuda.synchronize()

        def round_trip(fn=fn, cast=cast):
            return [fn(torch.from_numpy(p).cuda().to(cast))[0].cpu()
                    for p, _ in padded]
        s_fwd, _ = wall_median(forward_only)
        s_rt, _ = wall_median(round_trip)
        bind_rates[name] = {"card_input_images_per_s": MODEL_ROWS / s_fwd,
                            "host_round_trip_images_per_s":
                            MODEL_ROWS / s_rt}
        del on_card

    fx = np.load(RESNET_FIXTURE)
    f32_err = float(np.abs(outs["float32"][:8] - fx["logits_f32"]).max())
    f32_ok = bool(np.allclose(outs["float32"][:8], fx["logits_f32"],
                              rtol=LOGITS_TOL, atol=LOGITS_TOL))
    bf16_span = float(np.abs(fx["logits_bf16"]).max())
    bf16_err = float(np.abs(outs["bf16"][:8] - fx["logits_bf16"]).max())
    host_norm = ((pixels.astype(np.float32)
                  - IMAGENET_NORM["mean"].astype(np.float32))
                 * IMAGENET_NORM["scale"].astype(np.float32))
    want_u8 = np.asarray(models["bf16"].transform(
        Table({"data": host_norm}))[out_name])
    del host_norm
    u8_span = float(np.abs(want_u8).max())
    u8_err = float(np.abs(outs["bf16_uint8"] - want_u8).max())

    # 7 tables of transform's full buckets, then its first bucket again
    stream_tables = [
        Table({"data": x[i * MODEL_BATCH:(i + 1) * MODEL_BATCH]})
        for i in range(STREAM_TABLES - 1)] + [Table({"data": x[:MODEL_BATCH]})]
    stream_s, streamed = wall_median(
        lambda: list(models["bf16"].transform_stream(stream_tables)))
    stream_same = [bool(np.array_equal(
        np.asarray(t[out_name]),
        outs["bf16"][(i % (STREAM_TABLES - 1)) * MODEL_BATCH:
                     (i % (STREAM_TABLES - 1)) * MODEL_BATCH
                     + MODEL_BATCH])) for i, t in enumerate(streamed)]
    small = Table({"data": x[:8]})
    small_wall = {name: wall_median(lambda m=models[name]: m.transform(
        small), calls=5)[0] for name in ("float32", "bf16")}
    # buckets mixed in flight: the graphs share one pool, so a replay of
    # one bucket may overwrite another's static outputs; each streamed
    # table must score as it does alone
    mixed_rows = [8, 128, 16, 64, 8, 32, 128, 16, 8, 64]
    mixed_tables = [Table({"data": tables["bf16"]["data"][:r]})
                    for r in mixed_rows]
    mixed_alone = [np.asarray(models["bf16"].transform(t)[out_name])
                   for t in mixed_tables]
    mixed_streamed = [np.asarray(t[out_name]) for t in
                      models["bf16"].transform_stream(mixed_tables)]
    mixed_same = [bool(np.array_equal(a, b))
                  for a, b in zip(mixed_alone, mixed_streamed)]
    overlap = copy_overlap(lambda: models["bf16"].transform(tables["bf16"]))

    post = models["float32"].copy(softmax_output_col="prob",
                                  argmax_output_col="label")
    t = post.transform(Table({"data": x[:MODEL_BATCH]}))
    logits = np.asarray(t[out_name], np.float64)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    post_ok = bool(
        np.array_equal(np.asarray(t[out_name]), outs["float32"][:MODEL_BATCH])
        and np.allclose(t["prob"], e / e.sum(-1, keepdims=True), rtol=1e-6,
                        atol=1e-9)
        and np.array_equal(t["label"], logits.argmax(-1))
        and t["label"].dtype == np.int64)

    enc = ONNXModel(model_bytes=zoo.transformer_encoder(**tfx.ENCODER),
                    mini_batch_size=MODEL_BATCH)
    enc_in, enc_out = enc.graph.input_names[0], enc.graph.output_names[0]
    ids = np.random.default_rng(3).integers(
        0, tfx.ENCODER["vocab"], (MODEL_BATCH, tfx.ENCODER["seq_len"]))
    ex = enc._executor("cuda")
    seen = []
    inner = ex._fn
    ex._fn = lambda *a: (seen.append(a[-1].dtype), inner(*a))[1]
    enc_got = np.asarray(enc.transform(Table({enc_in: ids}))[enc_out])
    ex._fn = inner
    enc_want = enc.graph.bind()(torch.from_numpy(ids).cuda())[0].cpu().numpy()
    enc_err = float(np.abs(enc_got - enc_want).max())
    enc_ok = bool(np.allclose(enc_got, enc_want, rtol=ENCODER_TOL,
                              atol=ENCODER_TOL)) and seen == [torch.int32]
    counts = read_counts()
    for m in (*models.values(), post, enc):
        for executor in m._executor_cache.values():
            executor.close()
    emit({"phase": "onnx_model_resnet50",
          "model": "zoo.resnet50 seed 0, 224x224, 1000 classes; "
          "ONNXModel(mini_batch_size=128).transform",
          "rows": MODEL_ROWS, "first_call_s": first_s,
          "transform": rates, "bind": bind_rates,
          "transform_stream": {"tables": STREAM_TABLES,
                               "rows_per_table": MODEL_BATCH,
                               "images_per_s": STREAM_TABLES * MODEL_BATCH
                               / stream_s, "wall_s": stream_s,
                               "same_rows_as_transform": stream_same},
          "wall_8_rows_s": small_wall, "executor_stages": stages,
          "bf16_transform_timeline": overlap,
          "bucket_bitwise_vs_bind": bucket_bitwise,
          "float32_rows0_7_max_abs_err": f32_err, "float32_ok": f32_ok,
          "bf16_rows0_7_max_abs_err": bf16_err,
          "bf16_limit": BF16_SPAN_SHARE * bf16_span,
          "uint8_wire_max_abs_err": u8_err,
          "uint8_wire_limit": BF16_SPAN_SHARE * u8_span,
          "softmax_argmax_ok": post_ok,
          "encoder": {"model": "zoo.transformer_encoder BERT-base causal",
                      "ids": list(ids.shape), "fn_input_dtype":
                      [str(d) for d in seen], "max_abs_err_vs_bind":
                      enc_err, "tolerance": f"rtol=atol={ENCODER_TOL}",
                      "ok": enc_ok},
          "kernel_launches": counts,
          "phase_s": time.perf_counter() - phase_start, "nvidia_smi": smi})
    for name, o in outs.items():
        check(o.shape == (MODEL_ROWS, 1000) and np.isfinite(o).all(),
              f"ONNXModel {name} logits not finite [{MODEL_ROWS}, 1000]")
    check(f32_ok, f"ONNXModel float32 rows 0-7 off the JAX fixture by "
          f"{f32_err}")
    check(bf16_err <= BF16_SPAN_SHARE * bf16_span,
          f"ONNXModel bf16 rows 0-7 off the JAX fixture by {bf16_err}")
    for name, same in bucket_bitwise.items():
        check(all(same), f"ONNXModel {name} buckets differ from bind(): "
              f"{same}")
    check(u8_err <= BF16_SPAN_SHARE * u8_span,
          f"uint8 wire off host-normalised bf16 by {u8_err}")
    check(all(stream_same), f"transform_stream rows differ: {stream_same}")
    check(post_ok, "softmax/argmax columns disagree with the logits")
    check(enc_ok, f"encoder through ONNXModel off bind() by {enc_err}, "
          f"fn saw {seen}")
    check(not any(counts.values()), f"ONNXModel path launched {counts}")
    return {"counts": counts, "blob": blob, "tables": tables, "outs": outs,
            "rates": rates, "stages": stages, "wall_8_rows_s": small_wall}


WARM_BUCKETS = [8, 16, 32, 64, 128]


def recompiles(tm) -> dict:
    return {labels["reason"]: m.value
            for labels, m in tm.series("executor_recompiles_total")}


def aot_counts(tm) -> dict:
    return {k: tm.counter(f"executor_aot_{k}_total").value
            for k in ("hits", "misses", "retired")}


def warm_model(model, transfers, **kw) -> dict:
    """``model.warmup(**kw)`` with its captures under ``transfers`` (the
    copies they dispatch between host and card), the memory reserved
    around it and each bucket's status and capture seconds."""
    ex = model._executor("cuda")
    capture = ex._capture

    def counted(*args):
        with transfers.mode:
            return capture(*args)

    ex._capture = counted
    torch.cuda.synchronize()
    # each capture's torch.cuda.graph context empties the allocator's
    # cache: empty it first, so the difference is what warmup keeps
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    start = time.perf_counter()
    rep = model.warmup(**kw)
    wall = time.perf_counter() - start
    after = torch.cuda.memory_reserved()
    ex._capture = capture
    return {"wall_s": wall, "buckets": [e["bucket"] for e in rep.entries],
            "status": [e["status"] for e in rep.entries],
            "capture_s": [e.get("seconds") for e in rep.entries],
            "errors": rep.errors, "loaded": rep.loaded,
            "compiled": rep.compiled, "reserved_before_bytes": before,
            "reserved_after_bytes": after}


def dispatch_profile(fn, annotation="synapseml/executor/dispatch") -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA
    activity, every thread: the pipeline's threads started before the
    profiler): the host time of the thread that ran ``annotation``'s
    ranges, by operation (self time, top 8), beside the ranges' total. A
    profiler failure is reported, not checked."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CPU]
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    ranges = [e for e in events if e.name == annotation]
    threads = {e.thread for e in ranges}
    spans = [(e.time_range.start, e.time_range.end) for e in ranges]
    by_name = {}
    for e in events:
        if e.thread in threads and e.name != annotation and any(
                a <= e.time_range.start < b for a, b in spans):
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.self_cpu_time_total * 1e-3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"ranges": len(ranges),
            "ranges_ms": sum(b - a for a, b in spans) * 1e-3,
            "top_self_ms": [{"name": n[:80], "ms": t, "count": c}
                            for n, (t, c) in top]}


def onnx_model_warmup_phase(smi, reset_counts, read_counts, eager) -> dict:
    """Phase 25: phase 24's ResNet-50 through ``ONNXModel.warmup()`` —
    every bucket a CUDA graph — and ``transform`` served by replays,
    against phase 24's eager figures (``eager``, its return) from this
    run; a restart on the same store, the sentinel, and the BERT-base
    encoder warmed at bucket 8. Returns the kernels' launch counts."""
    import make_transformer_fixtures as tfx
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, zoo
    from synapseml_tpu_torch.runtime import telemetry as tm

    reset_counts()
    phase_start = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    tables, eager_outs = eager["tables"], eager["outs"]
    params = {"float32": {}, "bf16": {"compute_dtype": "bfloat16"},
              "bf16_uint8": {"compute_dtype": "bfloat16",
                             "input_norm": {"data": IMAGENET_NORM}}}
    feeds = {"bf16_uint8": {"example_feeds": {
        "data": np.zeros((1, 3, 224, 224), np.uint8)}}}
    models = {name: ONNXModel(model_bytes=eager["blob"],
                              mini_batch_size=MODEL_BATCH,
                              compile_cache_dir=store, **kw)
              for name, kw in params.items()}
    out_name = models["float32"].graph.output_names[0]
    transfers = TransferCount()
    warm = {name: warm_model(m, transfers, **feeds.get(name, {}))
            for name, m in models.items()}

    rates, outs, stages, aot, drift = {}, {}, {}, {}, {}
    for name, model in models.items():
        tm.reset()
        s, t = wall_median(lambda: model.transform(tables[name]))
        stages[name] = executor_stages(tm)
        aot[name] = {**aot_counts(tm), "buckets_dispatched": sum(
            m.value for _, m in tm.series("executor_bucket_total"))}
        drift[name] = recompiles(tm)
        rates[name] = {"images_per_s": MODEL_ROWS / s, "wall_s": s,
                       "eager_images_per_s":
                       eager["rates"][name]["images_per_s"]}
        outs[name] = np.asarray(t[out_name])
    # every bucket against phase 24's eager bucket of the same rows: a
    # bucket that is not bitwise is held to float32 rtol=atol=1e-3, or in
    # bf16 to 5% of that bucket's own largest |logit|; float32 rows 0-7
    # are held to the JAX fixture as well
    fx = np.load(RESNET_FIXTURE)
    same = {}
    for name, o in outs.items():
        bitwise, diffs, gates = [], [], []
        for a in range(0, MODEL_ROWS, MODEL_BATCH):
            got = o[a:a + MODEL_BATCH]
            want = eager_outs[name][a:a + MODEL_BATCH]
            bitwise.append(bool(np.array_equal(got, want)))
            diffs.append(float(np.abs(got - want).max()))
            gates.append(bool(np.allclose(
                got, want, rtol=LOGITS_TOL, atol=LOGITS_TOL))
                if name == "float32" else diffs[-1] <= BF16_SPAN_SHARE
                * float(np.abs(want).max()))
        same[name] = {"bitwise": bitwise, "max_abs_diff": diffs,
                      "within_gate": gates}
        if name == "float32":
            same[name]["rows_0_7_vs_jax_fixture"] = bool(np.allclose(
                o[:8], fx["logits_f32"], rtol=LOGITS_TOL, atol=LOGITS_TOL))
    # buckets mixed in flight: the graphs share one pool, so a replay of
    # one bucket may overwrite another's static outputs; each streamed
    # table must score as it does alone
    mixed_rows = [8, 128, 16, 64, 8, 32, 128, 16, 8, 64]
    mixed_tables = [Table({"data": tables["bf16"]["data"][:r]})
                    for r in mixed_rows]
    mixed_alone = [np.asarray(models["bf16"].transform(t)[out_name])
                   for t in mixed_tables]
    mixed_streamed = [np.asarray(t[out_name]) for t in
                      models["bf16"].transform_stream(mixed_tables)]
    mixed_same = [bool(np.array_equal(a, b))
                  for a, b in zip(mixed_alone, mixed_streamed)]
    overlap = copy_overlap(lambda: models["bf16"].transform(tables["bf16"]))
    profiled = dispatch_profile(
        lambda: models["bf16"].transform(tables["bf16"]))
    small = Table({"data": tables["float32"]["data"][:8]})
    small_wall = {name: {"warm_s": wall_median(
        lambda m=models[name]: m.transform(small), calls=5)[0],
        "eager_s": eager["wall_8_rows_s"][name]}
        for name in ("float32", "bf16")}
    ex = models["bf16"]._executor("cuda")
    sig8 = (((8, 3, 224, 224), "bfloat16"),)
    graph8 = ex._aot[(sig8, "single", 0)].graph
    torch.cuda.synchronize()
    replay8 = {"host_issue_ms": host_ms(graph8.replay, calls=50),
               "card_ms": cuda_ms(graph8.replay, reps=5, inner=10)}

    # restart: a second model on the same store
    again = ONNXModel(model_bytes=eager["blob"], mini_batch_size=MODEL_BATCH,
                      compile_cache_dir=store, compute_dtype="bfloat16")
    restart = warm_model(again, transfers)
    restart_out = np.asarray(again.transform(tables["bf16"])[out_name])
    restart_same = bool(np.array_equal(restart_out, outs["bf16"]))

    # the sentinel: one submit of an unwarmed row shape
    before = recompiles(tm)
    ex.submit(np.zeros((8, 3, 160, 160), np.float32)).result(timeout=120)
    after = recompiles(tm)
    drift_delta = {r: after[r] - before.get(r, 0) for r in after}

    # the BERT-base causal encoder warmed at bucket 8 against its eager
    # executor
    enc_blob = zoo.transformer_encoder(**tfx.ENCODER)
    enc = {name: ONNXModel(model_bytes=enc_blob, mini_batch_size=8,
                           compute_dtype="bfloat16")
           for name in ("warm", "eager")}
    enc_warm = warm_model(enc["warm"], transfers)
    enc_in = enc["warm"].graph.input_names[0]
    enc_out = enc["warm"].graph.output_names[0]
    ids = np.random.default_rng(4).integers(
        0, tfx.ENCODER["vocab"], (8, tfx.ENCODER["seq_len"]))
    enc_walls, enc_res = {}, {}
    for rows in (1, 8):
        tab = Table({enc_in: ids[:rows]})
        for name, m in enc.items():
            s, t = wall_median(lambda m=m: m.transform(tab), calls=5)
            enc_walls[f"{name}_{rows}_row_s"] = s
            enc_res[(name, rows)] = np.asarray(t[enc_out])
    enc_bitwise = all(np.array_equal(enc_res[("warm", r)],
                                     enc_res[("eager", r)]) for r in (1, 8))
    enc_ex = enc["warm"]._executor("cuda")
    enc_hits = enc_ex._aot_hits
    (enc_graph,) = [w.graph for w in enc_ex._aot.values()]
    torch.cuda.synchronize()
    enc_replay8 = {"host_issue_ms": host_ms(enc_graph.replay, calls=50),
                   "card_ms": cuda_ms(enc_graph.replay, reps=5, inner=10)}

    counts = read_counts()
    for m in (*models.values(), again, *enc.values()):
        for executor in m._executor_cache.values():
            executor.close()
    emit({"phase": "onnx_model_warmup_resnet50",
          "model": "zoo.resnet50 seed 0, 224x224, 1000 classes; "
          "ONNXModel(mini_batch_size=128, compile_cache_dir).warmup()",
          "rows": MODEL_ROWS, "warmup": warm,
          "capture_transfers": transfers.counts,
          "transform": rates, "aot": aot, "recompiles": drift,
          "vs_eager": same, "mixed_buckets_streamed": {
              "rows": mixed_rows, "bitwise_vs_alone": mixed_same},
          "executor_stages": stages,
          "eager_executor_stages": eager["stages"],
          "bf16_transform_timeline": overlap,
          "bf16_dispatch_profile": profiled, "wall_8_rows": small_wall,
          "replayed_bucket8_bf16": replay8,
          "restart": {**restart, "bitwise_vs_first": restart_same},
          "sentinel_unwarmed_row_shape": drift_delta,
          "encoder": {"model": "zoo.transformer_encoder BERT-base causal, "
                      "bf16, ONNXModel(mini_batch_size=8)",
                      "warmup": enc_warm, "walls": enc_walls,
                      "bitwise_warm_vs_eager": enc_bitwise,
                      "aot_hits": enc_hits,
                      "replayed_bucket8": enc_replay8},
          "kernel_launches": counts,
          "phase_s": time.perf_counter() - phase_start, "nvidia_smi": smi})
    shutil.rmtree(store, ignore_errors=True)
    for name, w in {**warm, "encoder": enc_warm}.items():
        want = [8] if name == "encoder" else WARM_BUCKETS
        check(w["buckets"] == want and w["errors"] == []
              and w["status"] == ["compiled"] * len(want),
              f"warmup of {name}: {w['status']} {w['errors']}")
    check(transfers.counts == {"h2d": 0, "d2h": 0},
          f"captures copied between host and card: {transfers.counts}")
    for name in models:
        a = aot[name]
        check(a["hits"] == a["buckets_dispatched"] > 0 and a["misses"] == 0
              and a["retired"] == 0, f"{name} not served by replays: {a}")
        check(not any(drift[name].values()),
              f"{name} recompiled: {drift[name]}")
        check(outs[name].shape == (MODEL_ROWS, 1000)
              and np.isfinite(outs[name]).all(),
              f"warm {name} logits not finite [{MODEL_ROWS}, 1000]")
        check(all(b or g for b, g in zip(same[name]["bitwise"],
                                         same[name]["within_gate"]))
              and same[name].get("rows_0_7_vs_jax_fixture", True),
              f"warm {name} off the eager path: {same[name]}")
    check(len(mixed_same) == len(mixed_rows) and all(mixed_same),
          f"streamed mixed buckets differ from their tables alone: "
          f"{mixed_same}")
    check(restart["loaded"] == len(WARM_BUCKETS) and restart["errors"] == []
          and restart_same, f"restart: {restart['status']}, bitwise "
          f"{restart_same}")
    check(drift_delta.get("shape_drift") == 1
          and sum(drift_delta.values()) == 1,
          f"an unwarmed row shape counted {drift_delta}")
    check(enc_bitwise and enc_hits > 0,
          f"warm encoder: bitwise {enc_bitwise}, hits {enc_hits}")
    check(not any(counts.values()), f"warm ONNXModel path launched {counts}")
    return counts


# -- 26-27. the image stages, ImageFeaturizer and the local explainers ----
IMAGE_FIXTURE = os.path.join(FIXTURES, "image_explainer_fixtures.npz")
STAGE_ATOL = 1e-3             # image stages, 0-255 scale, vs JAX and the CPU
HALF_TIE = 1e-3               # to_uint8: JAX floats this near k + 0.5 differ
FEATURE_TOL = 1e-3            # float32 features against the JAX fixture
FEATURIZER_ROWS, FEATURIZER_BATCH = 512, 64
PIPELINE_IMAGES = 64
TRANSFER_BAR = 0.85           # examples/image_transfer_learning.py's gate
EFFICIENCY_TOL = 1e-4         # KernelSHAP: sum(phi_1..D) = f(x) - f(null)
FITTED_REL = 1e-4             # surrogate fitted values, of the largest score
LASSO_ALPHA = 0.01
EPS32 = float(np.finfo(np.float32).eps)
ADULT_FEATURES = [f"f{j}" for j in range(14)]


def ppm_bytes(img: np.ndarray) -> bytes:
    return b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]) + img.tobytes()


class HostTimer:
    """Host seconds spent inside wrapped callables, summed by name."""

    def __init__(self):
        self.s: dict = {}

    def wrap(self, name, fn):
        def timed(*args, **kw):
            start = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.s[name] = self.s.get(name, 0.0) + (
                    time.perf_counter() - start)
        return timed

    def patch(self, stack, obj, attr, name=None):
        from unittest import mock
        stack.enter_context(mock.patch.object(
            obj, attr, self.wrap(name or attr, getattr(obj, attr))))


def captured(stack, local) -> list:
    """Record the arguments the explainers hand their surrogate solvers
    (card tensors, kept without a copy), in call order."""
    from unittest import mock
    calls: list = []
    for name in ("weighted_least_squares", "weighted_lasso",
                 "shap_weighted_fit"):
        fn = getattr(local, name)

        def record(*args, _fn=fn, _name=name):
            calls.append((_name, args))
            return _fn(*args)
        stack.enter_context(mock.patch.object(local, name, record))
    return calls


def f64(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().to(torch.float64)


def solve_cond(states, weights, kind: str) -> np.ndarray:
    """cond(A) a row of the system each surrogate solves (float64):
    LIME's weighted-centered normal matrix (+1e-6 I), the lasso's
    standardized Gram, SHAP's reduced matrix (+1e-8 I)."""
    x, w = f64(states).numpy(), f64(weights).numpy()
    if kind == "shap":
        x = x[..., :-1] - x[..., -1:]
        a = np.swapaxes(x, -1, -2) @ (x * w[..., None]) \
            + 1e-8 * np.eye(x.shape[-1])
        return np.linalg.cond(a)
    w = w / (w.sum(-1, keepdims=True) + 1e-12)
    xc = x - (x * w[..., None]).sum(-2, keepdims=True)
    if kind == "lasso":
        xc = xc / (np.sqrt((xc * xc * w[..., None]).sum(-2, keepdims=True))
                   + 1e-12)
        return np.linalg.cond(np.swapaxes(xc, -1, -2) @ (xc * w[..., None]))
    return np.linalg.cond(np.swapaxes(xc, -1, -2) @ (xc * w[..., None])
                          + 1e-6 * np.eye(x.shape[-1]))


def held_under_cond(got, want, cond, samples, shift=None) -> dict:
    """Row r of ``got - want - shift`` within S · cond(A_r) · eps32 ·
    max|want_r|: the worst-case float32 error of summing S samples into
    the normal equations, amplified by the system's condition number.
    ``shift`` is the exact (float64) change the surrogate's linear map
    gives the difference of the scores the two fits saw."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    resid = got - want - (0.0 if shift is None else np.asarray(shift))
    err = np.abs(resid).reshape(len(got), -1).max(1)
    tol = samples * np.asarray(cond) * EPS32 \
        * np.abs(want).reshape(len(want), -1).max(1)
    return {"cond_max": float(np.max(cond)),
            "max_abs_diff": float(np.abs(got - want).max()),
            "max_abs_err": float(err.max()),
            "tolerance_min": float(tol.min()),
            "within": bool((err <= tol).all())}


def fitted_gap(got, want, shift, states, weights, kind: str,
               target) -> dict:
    """How far the surrogate's fitted values move between the two fits,
    once ``shift`` (the exact image of the score difference) is taken off:
    ``phi_0 + z · phi`` for SHAP, ``(x - weighted mean) · coef`` for LIME
    (the scores' weighted mean cancels). Measured in the norm the fit
    minimises, the weighted RMS over the samples: there the fitted values
    are well determined where the coefficients are not (KernelSHAP's
    reduced system has cond ~1e6 at 196 features; a sample of tiny weight
    may move far). Held within 1e-4 of the weighted RMS of ``target``, the
    scores about the fit's reference (f(null) for SHAP, their weighted
    mean for LIME)."""
    x = f64(states).numpy()
    w = f64(weights).numpy()
    w = w / (w.sum(-1, keepdims=True) + 1e-12)
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64) - shift
    if kind == "shap":
        gap = d[:, :1] + (x @ d[:, 1:, None])[..., 0]
    else:
        xc = x - (x * w[..., None]).sum(-2, keepdims=True)
        gap = (xc @ d[..., None])[..., 0]
    gap_w = np.sqrt((w * gap ** 2).sum(-1))
    scale_w = np.sqrt((w * np.asarray(target, np.float64) ** 2).sum(-1))
    return {"weighted_rms_gap": gap_w.tolist(),
            "weighted_rms_target": scale_w.tolist(),
            "max_abs_gap_unweighted": float(np.abs(gap).max()),
            "within": bool((gap_w <= FITTED_REL * scale_w).all())}


def prepare_split(images, size: int) -> dict:
    """Where ``ImageFeaturizer._prepare``'s time goes, milliseconds an
    image (host clock, each part synchronised): the float32 conversion
    on the host, the two resize weight matrices built on the card, the
    copy in, the two products and the copy back."""
    from synapseml_tpu_torch import device as device_policy
    from synapseml_tpu_torch.image import ops

    parts = dict.fromkeys(("to_float32", "weights", "copy_in", "products",
                           "copy_out"), 0.0)
    dev = device_policy.resolve("cuda")
    for img in images:
        t0 = time.perf_counter()
        arr = np.asarray(img, np.float32)
        t1 = time.perf_counter()
        ops.resize_weights(arr.shape[0], size, dev)
        ops.resize_weights(arr.shape[1], size, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        x = torch.from_numpy(arr).to(dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        y = ops.resize(x, height=size, width=size)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        y.cpu().numpy()
        t5 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                 t5 - t4)):
            parts[k] += dt * 1e3 / len(images)
    return parts


def image_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 26: the image stages and ``ImageFeaturizer`` on the card.

    ``ImageTransformer`` over 64 256x256 uint8 images (8 stored in the
    fixture, 56 seeded): resize to 240, center-crop 224, flip, blur 3x3,
    gaussian 5, threshold (trunc at 200), BT.601 gray, one prefix at a
    time, each held to the JAX fixture (every 8th row and column of the
    stored 8) and to the port's CPU run of all 64 at atol 1e-3; the
    whole pipeline with ``to_uint8`` equal to the fixture except within
    1e-3 of a half. ``ImageFeaturizer`` over ResNet-50 224 (seed 0,
    ``cut_output_layers=1``, ``mini_batch_size=64``) in float32 and bf16
    on 512 images of 256x256 (``_prepare`` resizes each on the card):
    rows 0-7 against the JAX fixture (float32 rtol=atol=1e-3, bf16 5% of
    the float32 largest |value|), the same 8 as PPM bytes bitwise the
    arrays; images/s eager and warm, ``_prepare``'s host seconds beside
    the executor's stage, dispatch and drain seconds, the memory warmup
    reserves; after ``warmup()`` every bucket (8, 16, 32, 64) bitwise its
    eager run; ``_prepare``'s milliseconds an image by part
    (:func:`prepare_split`). Then transfer learning: the texture dataset of
    ``examples/image_transfer_learning.py`` at 224, 200 images a class,
    featurised, the port's ``LightGBMClassifier(20 iterations, 7 leaves,
    min_data_in_leaf=5)`` fitted on 300 and scored on 100: held-out
    accuracy beside the JAX package's and the example's 0.85 bar, K1 and
    K2 launches. Returns the launch counts of the featurization (none
    expected), the head's fit and its scoring."""
    import make_image_explainer_fixtures as imfx
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier
    from synapseml_tpu_torch.image import ImageFeaturizer, ImageTransformer
    from synapseml_tpu_torch.onnx import zoo
    from synapseml_tpu_torch.runtime import telemetry as tm

    phase_start = time.perf_counter()
    fx = np.load(IMAGE_FIXTURE)
    pipeline = tuple(json.loads(str(fx["pipeline"])))
    stored = fx["images"]
    extra = np.random.default_rng(1).integers(
        0, 256, (FEATURIZER_ROWS - len(stored), 256, 256, 3), dtype=np.uint8)
    pipe = Table({"image": imfx.obj_col(list(stored) + list(
        extra[:PIPELINE_IMAGES - len(stored)]))})

    # -- ImageTransformer: each stage prefix on the card, JAX and the CPU
    stages = []
    for k in range(len(pipeline)):
        t = ImageTransformer(input_col="image", output_col="out",
                             stages=pipeline[:k + 1])
        card = np.stack(list(t.transform(pipe, "cuda")["out"]))
        cpu = np.stack(list(t.transform(pipe, "cpu")["out"]))
        stages.append({
            "action": pipeline[k]["action"], "shape": list(card.shape[1:]),
            "max_abs_err_vs_jax": float(np.abs(
                card[:8, ::8, ::8] - fx[f"stage_{k}"]).max()),
            "max_abs_err_vs_cpu": float(np.abs(card - cpu).max())})
    u8 = ImageTransformer(input_col="image", output_col="out",
                          stages=pipeline, to_uint8=True)
    pipe_s, u8_out = wall_median(
        lambda: np.stack(list(u8.transform(pipe, "cuda")["out"])))
    jax_float = fx[f"stage_{len(pipeline) - 1}"]
    ties = np.abs(jax_float - np.floor(jax_float) - 0.5) < HALF_TIE
    u8_got = u8_out[:8, ::8, ::8].astype(np.int64)
    u8_want = fx["pipeline_uint8"].astype(np.int64)
    u8_ok = bool(np.array_equal(u8_got[~ties], u8_want[~ties])
                 and (np.abs(u8_got - u8_want)[ties] <= 1).all())

    # -- ImageFeaturizer over ResNet-50 224, cut 1, float32 and bf16 -----
    blob = zoo.resnet50(num_classes=1000, image_size=224, seed=0)
    col = imfx.obj_col(list(stored) + list(extra))
    table = Table({"image": col})
    small = {n: Table({"image": col[:n]})
             for n in (8, 16, 24)}          # buckets 8, 16 and 32
    span = float(np.abs(fx["features_f32"]).max())
    reset_counts()
    feats, featurizer = {}, {}
    for dtype, key in (("float32", "features_f32"),
                       ("bfloat16", "features_bf16")):
        feat = ImageFeaturizer(model_bytes=blob, cut_output_layers=1,
                               input_col="image", output_col="features",
                               compute_dtype=dtype,
                               mini_batch_size=FEATURIZER_BATCH)
        timer = HostTimer()
        feat._prepare = timer.wrap("prepare", feat._prepare)

        def run(t, feat=feat):
            return np.asarray(feat.transform(t, "cuda")["features"])
        run(small[8])                       # lazy init, cuDNN plans
        runs = {}
        for mode in ("eager", "warm"):
            if mode == "warm":
                torch.cuda.synchronize()
                reserved = torch.cuda.memory_reserved()
                start = time.perf_counter()
                report = feat.warmup(device="cuda")
                warmup_s = time.perf_counter() - start
                reserved_after = torch.cuda.memory_reserved()
            tm.reset()
            timer.s.clear()
            start = time.perf_counter()
            out = run(table)
            seconds = time.perf_counter() - start
            runs[mode] = {"out": out, "seconds": seconds,
                          "images_per_s": FEATURIZER_ROWS / seconds,
                          "prepare_host_s": timer.s.get("prepare", 0.0),
                          "executor": executor_stages(tm),
                          "aot": aot_counts(tm),
                          "small": {n: run(t) for n, t in small.items()}}
        eager, warm = runs["eager"], runs["warm"]
        binary = run(Table({"image": imfx.obj_col([ppm_bytes(im)
                                              for im in stored])}))
        err = float(np.abs(eager["out"][:8] - fx[key]).max())
        feats[dtype] = eager["out"]
        featurizer[dtype] = {
            "shape": list(eager["out"].shape),
            "finite": bool(np.isfinite(eager["out"]).all()),
            "rows_0_7_max_abs_err_vs_jax": err,
            "rows_0_7_vs_jax": bool(
                np.allclose(eager["out"][:8], fx[key], rtol=FEATURE_TOL,
                            atol=FEATURE_TOL) if dtype == "float32"
                else err <= BF16_SPAN_SHARE * span),
            "ppm_bytes_bitwise_arrays": bool(np.array_equal(
                binary, warm["small"][8])),
            "warm_bitwise_eager": {
                "512": bool(np.array_equal(warm["out"], eager["out"])),
                **{str(n): bool(np.array_equal(warm["small"][n],
                                               eager["small"][n]))
                   for n in small}},
            "warmup": {"buckets": [e["bucket"] for e in report.entries],
                       "status": [e.get("status") for e in report.entries],
                       "errors": report.errors, "seconds": warmup_s,
                       "reserved_gb_before": reserved / 1e9,
                       "reserved_gb_after": reserved_after / 1e9},
            **{mode: {k: v for k, v in r.items()
                      if k not in ("out", "small")}
               for mode, r in runs.items()}}
        del feat, runs, eager, warm
        torch.cuda.empty_cache()
    featurize_counts = read_counts()
    split = prepare_split(list(stored) + list(extra[:56]), 224)

    # -- transfer learning: texture features -> LightGBM head (K1, K2) --
    tex, labels = imfx.texture_dataset(imfx.TRANSFER["n_per_class"],
                                       imfx.TRANSFER["size"])
    feat = ImageFeaturizer(model_bytes=blob, cut_output_layers=1,
                           input_col="image", output_col="features",
                           mini_batch_size=FEATURIZER_BATCH)
    reset_counts()
    start = time.perf_counter()
    tex_feats = np.asarray(feat.transform(Table({"image": tex}),
                                          "cuda")["features"])
    tex_s = time.perf_counter() - start
    featurize_counts = {k: featurize_counts[k] + v
                        for k, v in read_counts().items()}
    n_train, n_test = imfx.TRANSFER["n_train"], imfx.TRANSFER["n_test"]
    reset_counts()
    start = time.perf_counter()
    head = LightGBMClassifier(**imfx.HEAD).fit(Table({
        "features": tex_feats[:n_train],
        "label": labels[:n_train].astype(np.float64)}), device="cuda")
    fit_s = time.perf_counter() - start
    fit_counts = read_counts()
    reset_counts()
    pred = np.asarray(head.transform(Table({
        "features": tex_feats[n_train:n_train + n_test]}),
        "cuda")["prediction"])
    score_counts = read_counts()
    accuracy = float((pred == labels[n_train:n_train + n_test]).mean())
    del feat
    torch.cuda.empty_cache()

    emit({"phase": "image_stages_featurizer_resnet50",
          "pipeline": [s["action"] for s in pipeline],
          "stages": stages, "to_uint8_vs_jax": u8_ok,
          "to_uint8_half_ties_excluded": int(ties.sum()),
          "pipeline_images": PIPELINE_IMAGES,
          "pipeline_uint8_images_per_s": PIPELINE_IMAGES / pipe_s,
          "featurizer": featurizer,
          "prepare_ms_per_image": split,
          "featurize_launches": featurize_counts,
          "transfer": {"images": len(tex), "featurize_s": tex_s,
                       "head": imfx.HEAD, "fit_s": fit_s,
                       "train": n_train, "test": n_test,
                       "accuracy": accuracy,
                       "accuracy_jax": float(fx["transfer_accuracy"]),
                       "bar": TRANSFER_BAR, "fit_launches": fit_counts,
                       "score_launches": score_counts},
          "phase_s": time.perf_counter() - phase_start, "nvidia_smi": smi})
    for s in stages:
        check(s["max_abs_err_vs_jax"] <= STAGE_ATOL
              and s["max_abs_err_vs_cpu"] <= STAGE_ATOL,
              f"image stage {s['action']} off: {s}")
    check(u8_ok, "to_uint8 pipeline differs from the JAX fixture")
    for dtype, f in featurizer.items():
        check(f["shape"] == [FEATURIZER_ROWS, 2048] and f["finite"]
              and f["rows_0_7_vs_jax"],
              f"{dtype} features off the JAX fixture: "
              f"{f['rows_0_7_max_abs_err_vs_jax']}")
        check(f["ppm_bytes_bitwise_arrays"],
              f"{dtype} PPM bytes featurize other than their arrays")
        w = f["warmup"]
        check(w["buckets"] == [8, 16, 32, 64] and not w["errors"]
              and w["status"] == ["compiled"] * 4,
              f"{dtype} featurizer warmup: {w}")
        check(all(f["warm_bitwise_eager"].values()),
              f"{dtype} warm buckets off eager: {f['warm_bitwise_eager']}")
        check(f["warm"]["aot"]["hits"] > 0 and f["warm"]["aot"]["misses"]
              == 0, f"{dtype} warm featurizer not replayed: "
              f"{f['warm']['aot']}")
    check(featurize_counts["forest_traverse"] == 0
          and featurize_counts["histogram"] == 0,
          f"the ONNX featurization launched {featurize_counts}")
    check(accuracy >= TRANSFER_BAR,
          f"transfer accuracy {accuracy} under {TRANSFER_BAR}")
    check(fit_counts["histogram"] > 0 and score_counts["forest_traverse"] > 0,
          f"the transfer head ran without its kernels: fit {fit_counts}, "
          f"score {score_counts}")
    return {"featurize": featurize_counts, "head_fit": fit_counts,
            "head_score": score_counts}


def explainer_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 27: the local explainers on the card.

    ``TabularSHAP`` and ``TabularLIME`` (100 samples, seed 0, class 1)
    over the 100-tree Adult fixture model on 256 Adult rows (25,600
    perturbed rows scored in one ``transform``, through K2): held to the
    JAX fixture within S · cond(A) · eps32 · max|coef| a row (A the system
    the row's surrogate solves, its condition number computed here), SHAP's
    efficiency within 1e-4 a row; K2's launches and rows explained/s.
    ``ImageLIME`` and ``ImageSHAP`` (``cell_size=16``, 196 superpixels,
    512 samples) over ``ImageFeaturizer(cut_output_layers=0)`` on ResNet-50
    224 (float32) on the center crops of the fixture's images 0 and 1:
    superpixels equal to the fixture's but at the pixels the JAX centers
    place within 1e-5 of a tie; the scores the surrogates fit within the
    featurizer's float32 gate of the JAX scores; coefficients within
    S · cond(A) · eps32 · max|coef| of the JAX fixture once the exact
    (float64) image of the score difference under the surrogate's linear
    map is taken off; explained images/s split into superpixels, host
    masking, sampling, scoring and the surrogate fit. Then one
    ``ImageLIME(regularization=0.01)`` fit alone: the lasso's 100 sweeps
    of 196 coordinate updates timed on the card and held to the CPU's.
    Returns the kernels' launch counts of each explainer."""
    import make_image_explainer_fixtures as imfx
    from contextlib import ExitStack
    import synapseml_tpu_torch.explainers.local as local
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.explainers import (ImageLIME, ImageSHAP,
                                                TabularLIME, TabularSHAP,
                                                samplers, superpixel)
    from synapseml_tpu_torch.explainers.surrogate import (
        shap_weighted_fit, weighted_lasso, weighted_least_squares)
    from synapseml_tpu_torch.gbdt.estimators import \
        LightGBMClassificationModel
    from synapseml_tpu_torch.image import ImageFeaturizer
    from synapseml_tpu_torch.onnx import zoo

    phase_start = time.perf_counter()
    fx = np.load(IMAGE_FIXTURE)
    model = LightGBMClassificationModel.load_native_model(
        FIXTURE, feature_cols=ADULT_FEATURES)
    rows = np.load(FIXTURE_IO)["x"][:imfx.TABULAR_ROWS]
    table = Table(imfx.adult_columns(rows))
    f_x = np.asarray(model.transform(table, "cuda")["probability"])[:, 1]
    # the coalition TabularSHAP presents as x: x * 1 + background * 0,
    # NaN wherever a column's mean is (the reference's background stats
    # take no NaN out, so 0 * NaN replaces the row's value there)
    on = samplers.apply_mask_background(
        rows, np.ones((len(rows), 1, rows.shape[1]), np.float32),
        rows.mean(axis=0))[:, 0]
    f_on = np.asarray(model.transform(Table(imfx.adult_columns(on)),
                                      "cuda")["probability"])[:, 1]

    def run(ex, tbl, timer=None):
        """One explained table with the solver inputs recorded, or (with
        ``timer``) timed by part: sampling, superpixels, host masking,
        scoring and the surrogate fit."""
        with ExitStack() as stack:
            calls = captured(stack, local)
            if timer is not None:
                for name in ("kernel_shap_samples", "lime_state_samples",
                             "tabular_value_samples"):
                    timer.patch(stack, samplers, name, "sampling")
                timer.patch(stack, local, "superpixels")
                timer.patch(stack, superpixel.SuperpixelData,
                            "masked_image", "masking")
                timer.patch(stack, ex.model, "transform", "scoring")
                for name in ("_fit_surrogate", "_fit_surrogate_shap"):
                    if hasattr(ex, name):
                        timer.patch(stack, ex, name, "fit")
            start = time.perf_counter()
            out = ex.transform(tbl, "cuda")
            seconds = time.perf_counter() - start
        return out, calls, seconds

    tabular, counts = {}, {}
    for cls, key in ((TabularSHAP, "tabular_shap"),
                     (TabularLIME, "tabular_lime")):
        ex = cls(model=model, input_cols=ADULT_FEATURES,
                 target_col="probability", target_classes=(1,),
                 num_samples=imfx.TABULAR_SAMPLES, seed=0)
        run(ex, table.slice(0, 8))
        reset_counts()
        out, calls, _ = run(ex, table)
        counts[cls.__name__] = read_counts()
        timer = HostTimer()
        _, _, seconds = run(ex, table, timer)
        got = np.asarray(out["output"])[:, 0]
        (kind, args), = calls
        kind = "shap" if kind == "shap_weighted_fit" else "ls"
        cond = solve_cond(args[0], args[2], kind)
        res = {"shape": list(np.asarray(out["output"]).shape),
               "vs_jax": held_under_cond(got, fx[key][:, 0], cond,
                                         imfx.TABULAR_SAMPLES),
               "rows_explained_per_s": imfx.TABULAR_ROWS / seconds,
               "seconds": seconds, "host_split_s": timer.s,
               "launches": counts[cls.__name__]}
        if kind == "shap":
            res["efficiency_max_err"] = float(np.abs(
                got[:, 1:].sum(1) - (f_on - got[:, 0])).max())
            res["nan_background_columns"] = int(np.isnan(
                rows.mean(axis=0)).sum())
            res["all_on_vs_row_max_abs"] = float(np.abs(f_on - f_x).max())
        tabular[cls.__name__] = res

    # -- ImageLIME / ImageSHAP over ResNet-50 224 logits ----------------
    blob = zoo.resnet50(num_classes=1000, image_size=224, seed=0)
    logits = ImageFeaturizer(model_bytes=blob, cut_output_layers=0,
                             input_col="image", output_col="logits",
                             mini_batch_size=FEATURIZER_BATCH)
    crops = Table({"image": imfx.obj_col([imfx.center_crop(im)
                                     for im in fx["images"][:2]])})
    images, lasso_in = {}, None
    for cls, key in ((ImageLIME, "image_lime"), (ImageSHAP, "image_shap")):
        ex = cls(model=logits, input_col="image", target_col="logits",
                 target_classes=(0,), num_samples=imfx.IMAGE_SAMPLES, seed=0,
                 cell_size=imfx.CELL)
        reset_counts()
        out, calls, _ = run(ex, crops)
        counts[cls.__name__] = read_counts()
        timer = HostTimer()
        _, _, seconds = run(ex, crops, timer)
        sp = np.stack(list(out["superpixels"]))
        ties = fx["superpixel_ties"]
        got = np.asarray(out["output"])[:, 0]
        want = fx[key][:, 0]
        (name, args), = calls
        y = f64(args[1])
        y_jax = torch.from_numpy(fx[key + "_y"].astype(np.float64))
        st, w = f64(args[0]), f64(args[2])
        if name == "shap_weighted_fit":
            fnull = f64(args[3])
            d_fnull = fnull - float(fx["image_shap_fnull"][0])
            shift = shap_weighted_fit(st, y - y_jax, w, d_fnull,
                                      (y - y_jax)[:, 0]).numpy()
            kind = "shap"
            target = (y_jax - float(fx["image_shap_fnull"][0])).numpy()
        else:
            shift = weighted_least_squares(st, y - y_jax, w)[0].numpy()
            kind = "ls"
            wn = (w / w.sum(-1, keepdim=True)).numpy()
            target = y_jax.numpy() - (wn * y_jax.numpy()).sum(
                -1, keepdims=True)
            lasso_in = args[:3]
        cond = solve_cond(st, w, kind)
        res = {"superpixels": [int(s.max()) + 1 for s in sp],
               "superpixels_vs_jax": bool(np.array_equal(sp[~ties],
                                                         fx["superpixels"]
                                                         [~ties])),
               "superpixel_ties_excluded": int(ties.sum()),
               "scores_max_abs_err_vs_jax": float((y - y_jax).abs().max()),
               "scores_vs_jax": bool(np.allclose(
                   y.numpy(), y_jax.numpy(), rtol=FEATURE_TOL,
                   atol=FEATURE_TOL)),
               "vs_jax": held_under_cond(got, want, cond,
                                         imfx.IMAGE_SAMPLES, shift),
               "fitted_vs_jax": fitted_gap(
                   got, want, shift, st, w, kind, target),
               "images_explained_per_s": len(sp) / seconds,
               "seconds": seconds, "host_split_s": timer.s,
               "launches": counts[cls.__name__]}
        if name == "shap_weighted_fit":
            res["efficiency_max_err"] = float(np.abs(
                got[:, 1:].sum(1) - (y[:, 0] - fnull).numpy()).max())
        images[cls.__name__] = res
    del logits
    torch.cuda.empty_cache()

    # -- one lasso fit alone: 100 sweeps x 196 coordinates --------------
    st, y, w = lasso_in
    weighted_lasso(st[:, :, :8], y, w, LASSO_ALPHA, iters=2)
    torch.cuda.synchronize()
    start = time.perf_counter()
    card_coef, _ = weighted_lasso(st, y, w, LASSO_ALPHA)
    torch.cuda.synchronize()
    lasso_s = time.perf_counter() - start
    cpu_coef, _ = weighted_lasso(st.cpu(), y.cpu(), w.cpu(), LASSO_ALPHA)
    lasso = {"rows": int(st.shape[0]), "samples": int(st.shape[1]),
             "coordinates": int(st.shape[2]), "sweeps": 100,
             "alpha": LASSO_ALPHA, "seconds": lasso_s,
             "us_per_coordinate_update": lasso_s / (100 * st.shape[2]) * 1e6,
             "nonzero": int((card_coef != 0).sum()),
             "card_vs_cpu": held_under_cond(
                 card_coef.cpu().numpy(), cpu_coef.numpy(),
                 solve_cond(st, w, "lasso"), int(st.shape[1]))}

    emit({"phase": "explainers", "tabular": tabular, "images": images,
          "lasso_fit": lasso,
          "phase_s": time.perf_counter() - phase_start, "nvidia_smi": smi})
    for name, r in tabular.items():
        check(r["vs_jax"]["within"], f"{name} off the JAX fixture: "
              f"{r['vs_jax']}")
        check(r["launches"]["forest_traverse"] >= 1,
              f"{name} scored without K2: {r['launches']}")
    check(tabular["TabularSHAP"]["efficiency_max_err"] <= EFFICIENCY_TOL,
          f"TabularSHAP efficiency off by "
          f"{tabular['TabularSHAP']['efficiency_max_err']}")
    for name, r in images.items():
        check(r["superpixels_vs_jax"], f"{name} superpixels off the fixture")
        check(r["scores_vs_jax"], f"{name} scores off the JAX scores: "
              f"{r['scores_max_abs_err_vs_jax']}")
        check(r["vs_jax"]["within"] and r["fitted_vs_jax"]["within"],
              f"{name} off the JAX fixture: {r['vs_jax']} "
              f"{r['fitted_vs_jax']}")
        check(not any(r["launches"].values()),
              f"{name} over the featurizer launched {r['launches']}")
    check(images["ImageSHAP"]["efficiency_max_err"] <= EFFICIENCY_TOL,
          f"ImageSHAP efficiency off by "
          f"{images['ImageSHAP']['efficiency_max_err']}")
    check(lasso["card_vs_cpu"]["within"],
          f"the lasso on the card is off the CPU's: {lasso['card_vs_cpu']}")
    return counts


CNTK_FIXTURE = os.path.join(FIXTURES, "cntk_rnn.model")
CNTK_FIXTURE_TOL = 2e-5       # the committed recurrent fixture (its test's bound)
TAGGER_ROWS, TAGGER_BATCH = 1024, 128
TAGGER_CPU_TOL = 1e-4         # float32 card rows against the port's CPU run
CONTROL_FLOW_ROWS = 20


def served(model, table, out=None):
    """``model.transform`` on the card: every output column, host arrays."""
    got = model.transform(table, "cuda")
    return {c: np.asarray(got[c]) for c in (
        [out] if out else model.graph.output_names)}


def control_flow_checks() -> dict:
    """Phase 28's small graphs (``tests/fixtures/control_flow_graphs.py``)
    through ``ONNXModel(mini_batch_size=16 or 32)`` on the card: an ``If``
    on a device condition (rows 16-19 negative, so their bucket takes the
    other branch) and a host-trip ``Loop`` with a scan output, each warmed
    (every bucket captured) and bitwise eager, within 1e-6 of its numpy
    forward; the device-condition ``Loop`` below 16 rows: its bucket 8
    reported ``error`` with the reason, served eagerly and right, buckets
    16 and 32 captured after it and replayed bitwise eager."""
    import control_flow_graphs as cfg
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel

    x = cfg.rows(CONTROL_FLOW_ROWS, seed=3)
    x[16:] *= -1.0
    out = {}
    for name in ("if_on_device", "loop_on_host"):
        blob = getattr(cfg, name)()
        eager = ONNXModel(model_bytes=blob, mini_batch_size=16)
        warm = ONNXModel(model_bytes=blob, mini_batch_size=16)
        rep = warm.warmup(device="cuda")
        a, b = served(eager, Table({"x": x})), served(warm, Table({"x": x}))
        # the If selects by each bucket's sum: rows 0-15, then 16-19
        want = ((np.concatenate([cfg.if_on_device_reference(x[:16]),
                                 cfg.if_on_device_reference(x[16:])]),)
                if name == "if_on_device" else cfg.loop_on_host_reference(x))
        out[name] = {
            "status": [e["status"] for e in rep.entries],
            "errors": rep.errors,
            "aot_hits": warm._executor("cuda")._aot_hits,
            "warm_bitwise_eager": all(np.array_equal(a[c], b[c]) for c in a),
            "max_abs_err_vs_numpy": max(float(np.abs(a[c] - w).max())
                                        for c, w in zip(a, want))}
    blob = cfg.loop_on_device_below(16)
    m = ONNXModel(model_bytes=blob, mini_batch_size=32)
    rep = m.warmup(device="cuda")
    x8 = cfg.rows(8, seed=1)
    y8 = served(m, Table({"x": x8}))["y"]
    x48 = cfg.rows(48, seed=2)               # buckets 32 and 16: replays
    eager = ONNXModel(model_bytes=blob, mini_batch_size=32)
    out["loop_on_device_below_16"] = {
        "buckets": [e["bucket"] for e in rep.entries],
        "status": [e["status"] for e in rep.entries],
        "errors": rep.errors,
        "eager_bucket_8_right": bool(np.array_equal(
            y8, cfg.loop_on_device_reference(x8))),
        "later_buckets_bitwise_eager": bool(np.array_equal(
            served(m, Table({"x": x48}))["y"],
            served(eager, Table({"x": x48}))["y"])),
        "aot_hits": m._executor("cuda")._aot_hits}
    return out


def cntk_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 28: control flow and ``CNTKModel`` on the card.

    The committed recurrent fixture (``tests/fixtures/cntk_rnn.model``,
    two Scans) through ``CNTKModel(model_path=...).transform`` within
    rtol=atol=2e-5 of its expected outputs and of the port's CPU run;
    :func:`control_flow_checks`; then the CNTK 202 ATIS slot tagger at its
    published width (``tests/fixtures/make_cntk_tagger_fixture.py``: 943
    words, Embedding 150, BiLSTM 2 x 150, Dense 129; random weights),
    written by the port's ``CntkModelBuilder`` (sha256 equal to the
    fixture's), over 1,024 sequences of 64 tokens (rows 0-7 the fixture's)
    through ``CNTKModel(mini_batch_size=128).transform`` in float32 and
    bf16: rows 0-7 against the JAX fixture (float32 rtol=atol=1e-3, bf16
    5% of the largest |value|) and against the port's CPU run (float32
    rtol=atol=1e-4, bf16 5%); a bound forward's copies and syncs (none)
    and its launches and card time (``torch.profiler``); ``warmup()`` (5
    buckets, each captured with no host-to-card copy) with its seconds
    and the memory it reserves; every warm bucket bitwise its eager one;
    sequences/s and tokens/s eager and warm (host clock, median of 3
    after a warm call) with the executor's stage p50s; the card's busy
    share in one warm ``transform``. Returns the phase's K1/K2 launches
    (none expected)."""
    import make_cntk_tagger_fixture as tagger
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.dl import cntk_format
    from synapseml_tpu_torch.dl.cntk import CNTKModel
    from synapseml_tpu_torch.runtime import telemetry as tm

    phase_start = time.perf_counter()
    reset_counts()
    # -- the committed recurrent fixture ---------------------------------
    io = np.load(CNTK_FIXTURE.replace(".model", "_io.npz"))
    fixture = CNTKModel(model_path=CNTK_FIXTURE)
    fixture.set(feed_dict={fixture.graph.input_names[0]: "x"})
    out = fixture.graph.output_names[0]
    fx_card = served(fixture, Table({"x": io["input"]}), out)[out]
    fx_cpu = np.asarray(fixture.transform(Table({"x": io["input"]}),
                                          "cpu")[out])
    fixture_res = {
        "shape": list(fx_card.shape),
        "max_abs_err_vs_expected": float(np.abs(
            fx_card - io["expected"]).max()),
        "max_abs_err_vs_cpu": float(np.abs(fx_card - fx_cpu).max()),
        "within_tol": bool(
            np.allclose(fx_card, io["expected"], rtol=CNTK_FIXTURE_TOL,
                        atol=CNTK_FIXTURE_TOL)
            and np.allclose(fx_card, fx_cpu, rtol=CNTK_FIXTURE_TOL,
                            atol=CNTK_FIXTURE_TOL))}
    flows = control_flow_checks()

    # -- the CNTK 202 slot tagger at its published width -----------------
    fx = np.load(tagger.OUT)
    blob = tagger.build(cntk_format)
    sha_ok = hashlib.sha256(blob).hexdigest() == str(fx["sha256"])
    ids = np.concatenate([fx["tokens"], tagger.tokens(
        TAGGER_ROWS - len(fx["tokens"]), seed=tagger.SEED + 1)])
    onehot = tagger.one_hot(ids)
    table = Table({"query": onehot})
    span = float(np.abs(fx["expected"]).max())
    sizes = (8, 16, 24, 64, 128)        # one table a bucket: 8-128
    results = {}
    for dtype in ("float32", "bfloat16"):
        def model(dtype=dtype):
            m = CNTKModel(model_bytes=blob, mini_batch_size=TAGGER_BATCH,
                          compute_dtype=dtype)
            m.set(feed_dict={m.graph.input_names[0]: "query"})
            return m

        m = model()
        out = m.graph.output_names[0]
        cpu8 = np.asarray(m.transform(Table({"query": onehot[:8]}),
                                      "cpu")[out])
        runs = {}
        for mode in ("eager", "warm"):
            if mode == "warm":
                transfers = TransferCount()
                warmup = warm_model(m, transfers, example_feeds={
                    m.graph.input_names[0]: onehot[:1]}, device="cuda")
                warmup["h2d_copies_in_captures"] = transfers.counts["h2d"]
            tm.reset()
            seconds, got = wall_median(
                lambda m=m: served(m, table, out)[out])
            runs[mode] = {"out": got, "seconds": seconds,
                          "sequences_per_s": TAGGER_ROWS / seconds,
                          "tokens_per_s": TAGGER_ROWS * tagger.SEQ_LEN
                          / seconds,
                          "executor": executor_stages(tm),
                          "aot": aot_counts(tm),
                          "small": {n: served(m, Table(
                              {"query": onehot[:n]}), out)[out]
                              for n in sizes}}
        eager, warm = runs["eager"], runs["warm"]
        err = float(np.abs(eager["out"][:8] - fx["expected"]).max())
        cpu_err = float(np.abs(eager["out"][:8] - cpu8).max())
        g = m.graph
        fwd = g.bind(cast_dtype=None if dtype == "float32"
                     else torch.bfloat16, device="cuda")
        xd = torch.from_numpy(onehot[:TAGGER_BATCH]).cuda().to(
            torch.float32 if dtype == "float32" else torch.bfloat16)
        results[dtype] = {
            "shape": list(eager["out"].shape),
            "out_dtype": str(eager["out"].dtype),
            "finite": bool(np.isfinite(eager["out"]).all()),
            "rows_0_7_max_abs_err_vs_jax": err,
            "rows_0_7_vs_jax": bool(
                np.allclose(eager["out"][:8], fx["expected"],
                            rtol=LOGITS_TOL, atol=LOGITS_TOL)
                if dtype == "float32" else err <= BF16_SPAN_SHARE * span),
            "rows_0_7_max_abs_err_vs_cpu": cpu_err,
            "rows_0_7_vs_cpu": bool(
                np.allclose(eager["out"][:8], cpu8, rtol=TAGGER_CPU_TOL,
                            atol=TAGGER_CPU_TOL)
                if dtype == "float32" else cpu_err <= BF16_SPAN_SHARE * span),
            "bound_forward_copies_and_syncs": copies_and_syncs(fwd, xd),
            "bound_forward_128": device_busy(lambda: fwd(xd)),
            "warmup": warmup,
            "warm_bitwise_eager": {
                str(TAGGER_ROWS): bool(np.array_equal(warm["out"],
                                                      eager["out"])),
                **{str(n): bool(np.array_equal(warm["small"][n],
                                               eager["small"][n]))
                   for n in sizes}},
            "warm_transform_timeline": copy_overlap(
                lambda m=m: served(m, table, out)),
            **{mode: {k: v for k, v in r.items()
                      if k not in ("out", "small")}
               for mode, r in runs.items()}}
        del m, runs, eager, warm, fwd, xd
        torch.cuda.empty_cache()
    counts = read_counts()
    emit({"phase": "cntk_model", "fixture": fixture_res,
          "control_flow": flows,
          "tagger": {"source": "CNTK 202 ATIS slot tagger, bidirectional: "
                     "vocab 943, Embedding 150, BiLSTM 2x150, Dense 129, "
                     "initial_state 0.1; random weights",
                     "rows": TAGGER_ROWS, "seq_len": tagger.SEQ_LEN,
                     "mini_batch_size": TAGGER_BATCH,
                     "model_bytes": len(blob), "sha256_equal_fixture": sha_ok,
                     **results},
          "launches": counts,
          "phase_s": time.perf_counter() - phase_start, "nvidia_smi": smi})
    check(fixture_res["within_tol"],
          f"cntk_rnn fixture off on the card: {fixture_res}")
    for name in ("if_on_device", "loop_on_host"):
        f = flows[name]
        check(f["status"] == ["compiled", "compiled"] and not f["errors"]
              and f["aot_hits"] == 2 and f["warm_bitwise_eager"]
              and f["max_abs_err_vs_numpy"] <= 1e-6,
              f"control flow {name} on the card: {f}")
    f = flows["loop_on_device_below_16"]
    check(f["status"] == ["error", "compiled", "compiled"]
          and len(f["errors"]) == 1 and f["errors"][0].startswith("bucket=8")
          and "cannot be captured" in f["errors"][0]
          and f["eager_bucket_8_right"] and f["later_buckets_bitwise_eager"]
          and f["aot_hits"] == 2,
          f"device-condition Loop on the card: {f}")
    check(sha_ok, "the port's builder wrote other tagger bytes than the "
          "fixture's")
    for dtype, r in results.items():
        check(r["shape"] == [TAGGER_ROWS, tagger.SEQ_LEN, tagger.LABELS]
              and r["finite"] and r["rows_0_7_vs_jax"] and r["rows_0_7_vs_cpu"],
              f"{dtype} tagger off: JAX {r['rows_0_7_max_abs_err_vs_jax']}, "
              f"CPU {r['rows_0_7_max_abs_err_vs_cpu']}")
        cs = r["bound_forward_copies_and_syncs"]
        check(cs["h2d_copies"] == 0 and cs["syncs"] == 0,
              f"{dtype} tagger forward copies or syncs: {cs}")
        w = r["warmup"]
        check(w["buckets"] == [8, 16, 32, 64, 128] and not w["errors"]
              and w["status"] == ["compiled"] * 5
              and w["h2d_copies_in_captures"] == 0,
              f"{dtype} tagger warmup: {w}")
        check(all(r["warm_bitwise_eager"].values()),
              f"{dtype} warm tagger buckets off eager: "
              f"{r['warm_bitwise_eager']}")
        check(r["warm"]["aot"]["hits"] > 0
              and r["warm"]["aot"]["misses"] == 0,
              f"{dtype} warm tagger not replayed: {r['warm']['aot']}")
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the CNTK path launched {counts}")
    return counts


SERVE_IMAGES = 256            # ResNet-50 requests under load, one image each
SERVE_CLIENTS = 16            # client threads, one keep-alive connection each
SERVE_DISTINCT = 32           # distinct image bodies (rows 0-7: entry()'s)
SERVE_IMAGE = 224             # entry()'s image size
LATENCY_REQUESTS = 32         # one client, one request at a time
ADULT_REQUESTS = 1024         # one-row Adult requests (the fixture's rows)
ECHO_REQUESTS = 1000
ANNOUNCE_TIMEOUT_S = 300      # the entry's warmup and its announce line
EXIT_TIMEOUT_S = 120          # SIGTERM to exit


def prom_samples(text: str) -> list:
    """``[(name, {label: value}, number)]`` of a Prometheus exposition."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        name, _, labels = series.partition("{")
        out.append((name, dict(re.findall(r'(\w+)="([^"]*)"', labels)),
                    float(value)))
    return out


def prom_total(samples, name, **labels) -> float:
    return sum(v for n, lb, v in samples if n == name
               and all(lb.get(k) == w for k, w in labels.items()))


def prom_histogram(samples, name, **labels) -> dict:
    """Count, sum, mean and p50 of one histogram series of an exposition
    (the p50 interpolated inside its bucket, as ``Histogram.percentile``)."""
    buckets = sorted(
        (float(lb["le"]), v) for n, lb, v in samples
        if n == name + "_bucket"
        and all(lb.get(k) == w for k, w in labels.items()))
    count = prom_total(samples, name + "_count", **labels)
    total = prom_total(samples, name + "_sum", **labels)
    p50, prev_le, prev_cum = None, 0.0, 0.0
    for le, cum in buckets:
        if count and p50 is None and cum >= 0.5 * count:
            hi = le if le != float("inf") else prev_le
            frac = (0.5 * count - prev_cum) / max(cum - prev_cum, 1.0)
            p50 = prev_le + (hi - prev_le) * min(max(frac, 0.0), 1.0)
        prev_le, prev_cum = (le if le != float("inf") else prev_le), cum
    return {"count": int(count), "sum": total,
            "mean": total / count if count else None, "p50": p50}


def latency_ms(lat_s) -> dict:
    ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "n": int(ms.size)}


def serve_bodies(port: int, bodies: list, clients: int) -> list:
    """POST ``bodies`` from ``clients`` threads, each on one keep-alive
    ``http.client`` connection; ``[(status, body, digest, seconds)]`` in
    the bodies' order."""
    import http.client
    import threading

    out = [None] * len(bodies)
    errors = []

    def client(k):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            for i in range(k, len(bodies), clients):
                start = time.perf_counter()
                conn.request("POST", "/", bodies[i],
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                out[i] = (resp.status, data,
                          resp.getheader("X-Output-Digest"),
                          time.perf_counter() - start)
            conn.close()
        except Exception as e:  # noqa: BLE001 - reported by the check below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not errors and not any(t.is_alive() for t in threads),
          f"serving clients failed: {errors[:3]}")
    return out


def replies_ok(replies) -> bool:
    return all(r is not None and r[0] == 200
               and r[2] == hashlib.sha256(r[1]).hexdigest() for r in replies)


def launch_entry(path: str, name: str, tmp: str,
                 mode=("--warmup", "auto"), env=None) -> dict:
    """``python -m synapseml_tpu_torch.io.serving --port 0 --model <path>
    --warmup auto`` (or ``mode`` in place of ``--warmup auto``, with
    ``env`` added to the environment) as a child process on the card: its
    warmup line must show every bucket (or decode signature) ``compiled``
    and no error (``warmup skipped`` fails), then its announce line within
    ``ANNOUNCE_TIMEOUT_S``. Returns the child, the thread reading its
    output, the lines read, its port, its warmup report and the seconds to
    the announce; on a failed check the child is killed first."""
    import threading

    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "synapseml_tpu_torch.io.serving",
         "--port", "0", "--host", "127.0.0.1", "--model", path,
         *mode, "--name", name,
         "--dump-dir", os.path.join(tmp, f"flight_{name}")],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE, **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, announced = [], threading.Event()

    def pump():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("serving ["):
                announced.set()
        announced.set()  # the child exited: stop waiting

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    entry = {"proc": proc, "reader": reader, "lines": lines}
    try:
        announced.wait(ANNOUNCE_TIMEOUT_S)
        announce = [ln for ln in lines if ln.startswith("serving [")]
        check(bool(announce) and proc.poll() is None,
              f"the serving entry never announced: {lines[-20:]}")
        entry["announce_s"] = time.perf_counter() - start
        check(not any("warmup skipped" in ln for ln in lines),
              f"the entry skipped warmup: {lines}")
        warm = [re.search(r"signatures=(\d+), compiled=(\d+), loaded=(\d+),"
                          r" errors=(\d+)", ln) for ln in lines
                if ln.startswith("warmup done")]
        check(len(warm) == 1 and warm[0] is not None,
              f"no warmup report: {lines}")
        sigs, compiled, _loaded, werrs = (int(g) for g in warm[0].groups())
        check(sigs > 0 and compiled == sigs and werrs == 0,
              f"warmup compiled {compiled} of {sigs} buckets, "
              f"{werrs} errors")
    except BaseException:
        kill_entry(entry)
        raise
    entry["warmup"] = warm[0].group(0)
    entry["port"] = int(re.search(r":(\d+)/", announce[0]).group(1))
    return entry


def stop_entry(entry: dict, requests: int) -> dict:
    """SIGTERM to the child of :func:`launch_entry`: it must exit 0
    within ``EXIT_TIMEOUT_S``, print no traceback, and account every
    request (``admitted == replied == requests``)."""
    import signal

    proc, lines = entry["proc"], entry["lines"]
    start = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=EXIT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    entry["reader"].join(timeout=30)
    stop_s = time.perf_counter() - start
    acct = [re.search(r"admitted=(\d+) replied=(\d+)", ln)
            for ln in lines if ln.startswith("exit accounting")]
    check(rc == 0, f"the entry exited {rc} after SIGTERM: {lines[-20:]}")
    check(not any("Traceback" in ln for ln in lines),
          f"the entry printed a traceback: {lines[-30:]}")
    check(len(acct) == 1 and acct[0].group(1) == acct[0].group(2)
          == str(requests),
          f"exit accounting: {[ln for ln in lines if 'exit' in ln]}")
    return {"exit_code": rc, "exit_accounting": acct[0].group(0),
            "sigterm_to_exit_s": stop_s}


def kill_entry(entry: dict) -> None:
    proc = entry["proc"]
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)


def entry_metrics(port: int) -> list:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        return prom_samples(r.read().decode())


def serving_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 29: the serving entry on the card.

    ``python -m synapseml_tpu_torch.io.serving --port 0 --model <resnet50
    224, seed 0> --warmup auto`` as a child process: its warmup line must
    show every bucket ``compiled`` and no error (``warmup skipped`` fails
    the phase), then its announce line within ``ANNOUNCE_TIMEOUT_S``. 256
    one-image ``{"features": ...}`` requests from 16 keep-alive clients
    (32 distinct images, rows 0-7 ``entry()``'s): every reply 200 with
    ``X-Output-Digest`` the sha256 of its body, ``entry()``'s logits
    within rtol=atol=1e-3 of the JAX fixture; ``/metrics`` after the load
    shows 0 recompiles and AOT hits; 32 requests from one client for
    latency; SIGTERM: exit 0, ``admitted == replied`` (288). In process:
    a ``ContinuousServer`` scoring the Adult fixture model on the card
    (K2) answers 1,024 one-row requests from 16 clients with margins
    bitwise the fixture's ``raw`` (K2 launched, K1 not); an echo server
    answers 1,000 requests from one client. Prints requests/s and
    p50/p99 of each leg, the child's ``serving_score_seconds``,
    ``serving_queue_wait_seconds`` and executor stage p50s, the scorer's
    seconds a batch in JSON decode, feature arrays, ``transform`` and
    reply JSON, and each part's wall time. Returns the Adult leg's
    launch counts (``counts``) and requests/s."""
    sys.path.insert(0, FIXTURES)
    import make_resnet50_fixture as resnet_fx
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.gbdt.estimators import (
        LightGBMClassificationModel)
    from synapseml_tpu_torch.io import serving
    from synapseml_tpu_torch.onnx import zoo

    walls = {}
    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    path = os.path.join(tmp, "resnet50_224.onnx")
    with open(path, "wb") as fh:
        fh.write(zoo.resnet50(num_classes=1000, image_size=SERVE_IMAGE,
                              seed=0))
    images = np.concatenate([
        resnet_fx.images(),
        np.random.default_rng(1).standard_normal(
            (SERVE_DISTINCT - 8, 3, SERVE_IMAGE, SERVE_IMAGE)
        ).astype(np.float32)])
    distinct = [json.dumps({"features": im.tolist()}).encode()
                for im in images]
    walls["model_and_bodies_s"] = time.perf_counter() - start

    # -- the entry, a child process ---------------------------------------
    entry = None
    try:
        entry = launch_entry(path, "resnet50", tmp)
        walls["entry_start_to_announce_s"] = entry["announce_s"]
        port = entry["port"]

        start = time.perf_counter()
        load = serve_bodies(port, [distinct[i % SERVE_DISTINCT]
                                   for i in range(SERVE_IMAGES)],
                            SERVE_CLIENTS)
        load_s = time.perf_counter() - start
        walls["resnet50_load_s"] = load_s
        check(replies_ok(load), "a ResNet-50 reply was not 200 with its "
                                "body's digest")
        fx = np.load(RESNET_FIXTURE)
        got = np.asarray([json.loads(load[i][1])["output"]
                          for i in range(8)], np.float32)
        f32_err = float(np.abs(got - fx["logits_f32"]).max())
        check(bool(np.allclose(got, fx["logits_f32"], rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)),
              f"served logits {f32_err} from the JAX fixture")
        same = all(load[i][1] == load[i % SERVE_DISTINCT][1]
                   for i in range(SERVE_IMAGES))

        metrics = entry_metrics(port)
        recompiles = prom_total(metrics, "synapseml_executor_recompiles_total")
        aot_hits = prom_total(metrics, "synapseml_executor_aot_hits_total")
        check(recompiles == 0 and aot_hits > 0,
              f"after the load: {recompiles} recompiles, {aot_hits} AOT hits")

        start = time.perf_counter()
        single = serve_bodies(port, distinct[:LATENCY_REQUESTS], 1)
        walls["resnet50_latency_s"] = time.perf_counter() - start
        check(replies_ok(single), "a latency-leg reply was not 200")

        hist = {
            "serving_score_seconds": prom_histogram(
                metrics, "synapseml_serving_score_seconds",
                server="resnet50"),
            "serving_queue_wait_seconds": prom_histogram(
                metrics, "synapseml_serving_queue_wait_seconds",
                server="resnet50"),
            "serving_request_seconds": prom_histogram(
                metrics, "synapseml_serving_request_seconds",
                server="resnet50"),
            "serving_batch_size": prom_histogram(
                metrics, "synapseml_serving_batch_size", server="resnet50"),
            **{f"executor_{s}_seconds": prom_histogram(
                metrics, f"synapseml_executor_{s}_seconds")
               for s in ("stage", "dispatch", "compute", "drain")}}
        scorer = {"json_decode": prom_histogram(
            metrics, "synapseml_request_parse_seconds"), **{
            part: prom_histogram(metrics, "synapseml_model_pipeline_seconds",
                                 part=part)
            for part in ("features", "transform", "replies")}}
        score_sum = hist["serving_score_seconds"]["sum"]
        wire = sum(scorer[p]["sum"] for p in
                   ("json_decode", "features", "replies"))
        exit_ = stop_entry(entry, SERVE_IMAGES + LATENCY_REQUESTS)
        walls["sigterm_to_exit_s"] = exit_["sigterm_to_exit_s"]
    finally:
        if entry is not None:
            kill_entry(entry)
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "serving_resnet50_entry", "model": "zoo.resnet50 seed 0, "
          "224x224, 1,000 classes, float32", "warmup": entry["warmup"],
          "requests": SERVE_IMAGES, "clients": SERVE_CLIENTS,
          "distinct_images": SERVE_DISTINCT,
          "request_bytes": int(np.mean([len(b) for b in distinct])),
          "all_200_with_digest": True, "equal_images_equal_bytes": same,
          "logits_max_abs_err_vs_jax": f32_err, "logits_tol": LOGITS_TOL,
          "recompiles_after_load": recompiles, "aot_hits": aot_hits,
          "load_requests_per_s": SERVE_IMAGES / load_s,
          "load_latency": latency_ms([r[3] for r in load]),
          "single_client_latency": latency_ms([r[3] for r in single]),
          "single_client_requests_per_s":
              LATENCY_REQUESTS / walls["resnet50_latency_s"],
          "metrics_after_load": hist,
          "scorer_seconds_by_part": scorer,
          "scorer_json_share_of_score": wire / score_sum if score_sum else None,
          "exit_accounting": exit_["exit_accounting"],
          "exit_code": exit_["exit_code"],
          "walls_s": dict(walls), "nvidia_smi": smi})

    # -- K2 served in process: the Adult model on the card ----------------
    start = time.perf_counter()
    model = LightGBMClassificationModel.load_native_model(FIXTURE)
    io = np.load(FIXTURE_IO)
    batches = []  # (rows, transform seconds) of each scored batch

    def adult_pipeline(table):
        feats = np.asarray([v["features"] for v in table["value"]],
                           np.float32)
        t_batch = time.perf_counter()
        raw = model.transform(Table({"features": feats}),
                              device="cuda")["rawPrediction"]
        batches.append((len(feats), time.perf_counter() - t_batch))
        replies = np.empty(table.num_rows, dtype=object)
        for i in range(table.num_rows):
            replies[i] = serving.make_reply(
                {"rawPrediction": raw[i].tolist()})
        return table.with_column("reply", replies)

    bodies = [json.dumps({"features": row.tolist()}).encode()
              for row in io["x"][:ADULT_REQUESTS]]
    cs = serving.ContinuousServer("adult_k2", adult_pipeline).start()
    try:
        reset_counts()
        t_load = time.perf_counter()
        adult = serve_bodies(cs.server.port, bodies, SERVE_CLIENTS)
        adult_s = time.perf_counter() - t_load
        counts = read_counts()
    finally:
        cs.stop()
    walls["adult_s"] = time.perf_counter() - start
    check(replies_ok(adult), "an Adult reply was not 200 with its digest")
    margins = np.asarray([json.loads(r[1])["rawPrediction"][1]
                          for r in adult], np.float32)
    bitwise = bool(np.array_equal(margins, io["raw"][:ADULT_REQUESTS]))
    check(bitwise, "served Adult margins differ from the fixture's raw "
                   f"({int((margins != io['raw'][:ADULT_REQUESTS]).sum())} "
                   "rows)")
    check(counts["forest_traverse"] > 0 and counts["histogram"] == 0,
          f"the served Adult path launched {counts}")

    # -- echo: the front end alone ------------------------------------------
    start = time.perf_counter()
    echo = serving.ContinuousServer("echo", serving._echo_pipeline).start()
    try:
        echoed = serve_bodies(echo.server.port,
                              [json.dumps({"i": i}).encode()
                               for i in range(ECHO_REQUESTS)], 1)
    finally:
        echo.stop()
    walls["echo_s"] = time.perf_counter() - start
    check(replies_ok(echoed) and all(
        json.loads(r[1]) == {"i": i} for i, r in enumerate(echoed)),
        "an echo reply was wrong")
    emit({"phase": "serving_adult_k2_and_echo", "adult_requests":
          ADULT_REQUESTS, "clients": SERVE_CLIENTS,
          "adult_margins_bitwise_fixture": bitwise, "launches": counts,
          "adult_requests_per_s": ADULT_REQUESTS / adult_s,
          "adult_latency": latency_ms([r[3] for r in adult]),
          "adult_batches": len(batches),
          "adult_rows_per_batch": float(np.mean([b[0] for b in batches])),
          "adult_first_transform_ms": batches[0][1] * 1e3,
          "adult_transform_ms_per_batch": latency_ms(
              [b[1] for b in batches[1:]]),
          "adult_transform_share_of_leg":
              sum(b[1] for b in batches) / adult_s,
          "echo_requests": ECHO_REQUESTS,
          "echo_requests_per_s": ECHO_REQUESTS / walls["echo_s"],
          "echo_latency": latency_ms([r[3] for r in echoed]),
          "walls_s": walls, "nvidia_smi": smi})
    return {"counts": counts, "adult_requests_per_s": ADULT_REQUESTS / adult_s}


def close_models(*models) -> None:
    """Close the executors of ``models`` (their threads, pinned buffers and
    warm graphs)."""
    for m in models:
        for executor in m._executor_cache.values():
            executor.close()


BUCKET_GAP_ROUTES = ("bind8", "bind16", "eager8", "eager16", "warm8",
                     "warm16")


def conv_kernels(fn, x) -> set:
    """The names of the card's kernels in one call of ``fn(x)``
    (``torch.profiler``, CUDA activity), elementwise ones left out. A
    profiler failure propagates: the caller reports it."""
    from torch.profiler import ProfilerActivity, profile

    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "elementwise" not in e.name and "Memcpy" not in e.name
            and "Memset" not in e.name}


def resnet_bucket_phase(smi) -> dict:
    """Phase 30, step 0: why served ResNet-50 rows sit 1.16e-3 from the JAX
    fixture when ``bind()`` at batch 8 gave 7.9e-4. ``entry()``'s 8 images
    through ``bind()`` at batch 8 and padded with zero images to 16, and
    through ``ONNXModel(mini_batch_size=16)`` in buckets 8 and 16, eager
    and warm: each route's largest difference from every other and from
    ``resnet50_224_logits.npz``, and its worst use of the float32 gate
    (max of |a - b| - rtol·|b|, at most atol to pass). Replays must be
    bitwise their eager buckets and every route inside the gate. Beside
    them: the same batch-8 forward with TF32 allowed (what a leak past
    ``_ieee_float32`` would look like), and the matmul and convolution
    kernels the card ran at batch 8 and at 16."""
    sys.path.insert(0, FIXTURES)
    import make_resnet50_fixture as resnet_fx
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import ONNXModel, importer, zoo

    start = time.perf_counter()
    blob = zoo.resnet50(num_classes=1000, image_size=SERVE_IMAGE, seed=0)
    imgs = resnet_fx.images()
    want = np.load(RESNET_FIXTURE)["logits_f32"]
    fn = importer.import_model(blob).bind()
    x8 = torch.from_numpy(imgs).cuda()
    x16 = torch.cat([x8, torch.zeros_like(x8)])
    routes = {"bind8": fn(x8)[0].cpu().numpy(),
              "bind16": fn(x16)[0][:8].cpu().numpy()}
    padded = np.concatenate([imgs, np.zeros_like(imgs)])
    eager = ONNXModel(model_bytes=blob, mini_batch_size=16)
    warm = ONNXModel(model_bytes=blob, mini_batch_size=16)
    rep = warm.warmup()
    check(rep.errors == [] and rep.compiled == 2,
          f"ResNet-50 buckets 8 and 16: {rep.entries}")
    name, out = eager.graph.input_names[0], eager.graph.output_names[0]
    for label, m in (("eager", eager), ("warm", warm)):
        routes[f"{label}8"] = m.transform(Table({name: imgs}))[out]
        routes[f"{label}16"] = m.transform(Table({name: padded}))[out][:8]

    saved = importer._ieee_float32
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    importer._ieee_float32 = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = fn(x8)[0].cpu().numpy()
    finally:
        importer._ieee_float32 = saved
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    try:
        k8, k16 = conv_kernels(fn, x8), conv_kernels(fn, x16)
        kernels = {"batch8_only": sorted(n[:100] for n in k8 - k16),
                   "batch16_only": sorted(n[:100] for n in k16 - k8),
                   "both": len(k8 & k16)}
    except Exception as exc:  # noqa: BLE001 - evidence, not a check
        kernels = {"error": f"{type(exc).__name__}: {exc}"}

    def gate_use(a, b):
        return float((np.abs(a - b) - LOGITS_TOL * np.abs(b)).max())

    gaps = {a: {b: float(np.abs(routes[a] - routes[b]).max())
                for b in BUCKET_GAP_ROUTES if b != a}
            for a in BUCKET_GAP_ROUTES}
    vs_jax = {a: float(np.abs(r - want).max()) for a, r in routes.items()}
    result = {
        "phase": "resnet50_bucket_gap", "images": 8,
        "max_abs_vs_jax": vs_jax,
        "gate_use_vs_jax": {a: gate_use(r, want) for a, r in routes.items()},
        "max_abs_between_routes": gaps,
        "warm8_bitwise_eager8": bool(np.array_equal(routes["warm8"],
                                                    routes["eager8"])),
        "warm16_bitwise_eager16": bool(np.array_equal(routes["warm16"],
                                                      routes["eager16"])),
        "bind8_bitwise_eager8": bool(np.array_equal(routes["bind8"],
                                                    routes["eager8"])),
        "bind16_bitwise_eager16": bool(np.array_equal(routes["bind16"],
                                                      routes["eager16"])),
        "tf32_max_abs_vs_jax": float(np.abs(tf32 - want).max()),
        "tf32_max_abs_vs_bind8": float(np.abs(tf32 - routes["bind8"]).max()),
        "kernels_by_batch": kernels,
        "logits_max_abs": float(np.abs(want).max()),
        "wall_s": time.perf_counter() - start, "nvidia_smi": smi}
    emit(result)
    check(result["warm8_bitwise_eager8"] and result["warm16_bitwise_eager16"],
          "a ResNet-50 replay differs from its eager bucket")
    check(all(np.allclose(r, want, rtol=LOGITS_TOL, atol=LOGITS_TOL)
              for r in routes.values()),
          f"a ResNet-50 route is outside the float32 gate: {vs_jax}")
    close_models(eager, warm)
    del fn, eager, warm
    torch.cuda.empty_cache()
    return result


ONNX_LGBM_FIXTURE = os.path.join(FIXTURES, "lgbm_adult_100x31_onnx.npz")
CONVERTED_TOL = 1e-5          # the reference's own bound (test_onnx_ml.py)
CONVERTED_BATCH = 128
OVERVIEW_ROWS, OVERVIEW_CUT = 4000, 3000
OVERVIEW_ITERATIONS = 80
AUC_BAR = 0.85                # examples/lightgbm_overview.py's gate
ATTRIBUTION_RATIO = 3.0       # examples/interpretability.py's gate
CONVERTED_REQUESTS = 1024
ROUND_TRIP_TOL = 1e-6         # the examples' round trips


def adult_census_shaped(n: int = OVERVIEW_ROWS, seed: int = 0):
    """``examples/lightgbm_overview.py``'s synthetic Adult Census (14
    features, income > 50k), the same draws."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 14)).astype(np.float32)
    x[:, 0] = rng.integers(17, 80, n)                  # age
    x[:, 4] = np.abs(rng.normal(40, 12, n))            # hours/week
    logits = (0.04 * (x[:, 0] - 38) + 0.05 * (x[:, 4] - 40)
              + x[:, 1] - 0.5 * x[:, 2] + 0.3 * x[:, 3] * x[:, 5])
    y = (logits + rng.logistic(scale=0.7, size=n) > 0).astype(np.float64)
    return x, y


def rank_auc(y: np.ndarray, p: np.ndarray) -> float:
    """ROC AUC by the rank formula (ties take their average rank)."""
    _, inv, counts = np.unique(p, return_inverse=True, return_counts=True)
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    pos = y == 1
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0))


def converted_lgbm_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 30: a LightGBM model exported with ``convert_lightgbm`` and
    scored through the ``ai.onnx.ml`` ops (``TreeEnsembleClassifier``: two
    float32 GEMMs, no kernel of the port), on the card.

    a. The Adult fixture model (100 trees, 31 leaves, 14 features) loaded
       with ``Booster.load_string``, converted, and scored by
       ``ONNXModel(mini_batch_size=128)`` in float32: the 1,024 fixture
       rows within 1e-5 of the JAX package's ONNX path
       (``lgbm_adult_100x31_onnx.npz``) and of ``Booster.predict`` (K2),
       labels equal to both; 65,536 rows (the scoring cell) eager and warm
       (every bucket ``compiled`` with no host-to-card copy, replays
       bitwise eager, 0 recompiles), rows/s, warmup's seconds and memory,
       the bound tables' bytes, one bucket's launches, copies and card
       time; K1 and K2 launch 0 times inside ``transform``.
    b. ``examples/lightgbm_overview.py`` steps 1-7 and
       ``examples/interpretability.py``'s KernelSHAP step with the port's
       modules: an 80-iteration fit (K1), holdout AUC above 0.85 (numpy's
       rank formula), the native text round trip, ONNX rescoring within
       1e-5 of ``Booster.predict``, 8 requests over the wire through
       ``ContinuousServer`` (K2), and f0's mean |phi| over 3x f2's.
    c. The serving entry with ``--model`` the converted Adult file: 1,024
       one-row requests from 16 clients, every reply 200 with its digest
       and its label ``Booster.predict > 0.5``; requests/s, p50, p99;
       SIGTERM exit 0 with every request accounted.

    Returns the launch counts of each part."""
    import threading
    import urllib.request

    from synapseml_tpu_torch.core.pipeline import Transformer
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.explainers.local import TabularSHAP
    from synapseml_tpu_torch.gbdt.boosting import Booster
    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier
    from synapseml_tpu_torch.io import serving
    from synapseml_tpu_torch.onnx import (ONNXModel, convert_lightgbm,
                                          import_model, ml_ops)
    from synapseml_tpu_torch.runtime import telemetry as tm

    walls, counts = {}, {}
    phase_start = start = time.perf_counter()
    with open(FIXTURE) as fh:
        booster = Booster.load_string(fh.read())
    blob = convert_lightgbm(booster)
    walls["load_and_convert_s"] = time.perf_counter() - start

    # -- a. the Adult fixture model, converted ------------------------------
    x = np.load(FIXTURE_IO)["x"]
    fx = np.load(ONNX_LGBM_FIXTURE)
    kw = dict(feed_dict={"input": "features"},
              mini_batch_size=CONVERTED_BATCH)
    eager = ONNXModel(model_bytes=blob, **kw)
    reset_counts()
    out = eager.transform(Table({"features": x}), device="cuda")
    counts["fixture_transform"] = read_counts()
    probs, label = out["probabilities"], out["label"]
    reset_counts()
    k2 = booster.predict(x, device="cuda")
    counts["fixture_booster_predict"] = read_counts()
    jax_err = float(np.abs(probs - fx["probabilities"]).max())
    k2_err = float(np.abs(probs[:, 1] - k2).max())
    check(label.dtype == np.int64 and probs.dtype == np.float32
          and probs.shape == (len(x), 2), f"outputs {label.dtype}, "
          f"{probs.dtype} {probs.shape}")
    check(jax_err <= CONVERTED_TOL and np.array_equal(label, fx["label"]),
          f"converted Adult rows {jax_err} from the JAX fixture, "
          f"{int((label != fx['label']).sum())} labels differ")
    check(k2_err <= CONVERTED_TOL
          and np.array_equal(label, (k2 > 0.5).astype(np.int64)),
          f"converted Adult rows {k2_err} from Booster.predict")

    # the scoring cell's 65,536 rows, eager and warm
    xq = query_rows(N_MAIN)
    table = Table({"features": xq})
    eager_s, eager_q = wall_median(
        lambda: eager.transform(table, device="cuda"))
    reset_counts()
    eager.transform(table, device="cuda")
    counts["transform_eager"] = read_counts()
    warm = ONNXModel(model_bytes=blob, **kw)
    transfers = TransferCount()
    tm.reset()
    warm_rep = warm_model(warm, transfers)
    check(not warm_rep["errors"] and all(
        s == "compiled" for s in warm_rep["status"]),
        f"converted-model warmup: {warm_rep}")
    check(transfers.counts["h2d"] == 0,
          f"the captures copied {transfers.counts} between host and card")
    warm_s, warm_q = wall_median(lambda: warm.transform(table, device="cuda"))
    reset_counts()
    busy = device_busy(lambda: warm.transform(table, device="cuda"))
    counts["transform_warm"] = read_counts()
    rec = recompiles(tm)
    aot = aot_counts(tm)
    same = all(np.array_equal(warm_q[c], eager_q[c])
               for c in ("label", "probabilities"))
    check(same, "a warm converted bucket differs from its eager bucket")
    check(sum(rec.values()) == 0 and aot["misses"] == 0,
          f"after warmup: recompiles {rec}, AOT {aot}")
    for part in ("fixture_transform", "transform_eager", "transform_warm"):
        check(counts[part]["forest_traverse"] == 0
              and counts[part]["histogram"] == 0,
              f"the converted {part} launched {counts[part]}")
    check(counts["fixture_booster_predict"]["forest_traverse"] == 1,
          f"Booster.predict launched {counts['fixture_booster_predict']}")

    g = import_model(blob)
    fn = g.bind()
    ctx = g._nodes[0][1]
    tables = ml_ops.tree_tables(ctx)
    xb = torch.from_numpy(xq[:CONVERTED_BATCH]).cuda()
    bucket = copies_and_syncs(fn, xb)
    check(bucket["h2d_copies"] == 0 and bucket["syncs"] == 0,
          f"a bound bucket copied or synchronised: {bucket}")
    bucket_ms = cuda_ms(lambda: fn(xb))
    emit({"phase": "converted_lgbm_adult", "model": "lgbm_adult_100x31.txt "
          "(100 trees, 31 leaves, 14 features), float32",
          "onnx_bytes": len(blob), "batch": CONVERTED_BATCH,
          "fixture_rows": len(x), "max_abs_err_vs_jax_onnx": jax_err,
          "max_abs_err_vs_booster_predict_k2": k2_err,
          "tolerance": CONVERTED_TOL, "labels_equal": True,
          "closest_probability_to_half": float(np.abs(k2 - 0.5).min()),
          "rows": N_MAIN, "eager_rows_per_s": N_MAIN / eager_s,
          "warm_rows_per_s": N_MAIN / warm_s,
          "warm_over_eager": eager_s / warm_s,
          "warmup": warm_rep, "capture_h2d_copies": transfers.counts["h2d"],
          "warm_bitwise_eager": same, "recompiles": rec, "aot": aot,
          "warm_transform_busy": busy,
          "tables": {"trees": tables.n_trees, "nodes": tables.m,
                     "leaves": int(tables.path.shape[-1]),
                     "path_bytes": int(tables.path.nbytes),
                     "bound_bytes": tables.nbytes()},
          "bucket128": {**bucket, "card_ms": bucket_ms},
          "launches": counts, "walls_s": dict(walls), "nvidia_smi": smi})
    close_models(eager, warm)
    del eager, warm, fn, g, eager_q, warm_q

    # -- b. the two examples' flows ------------------------------------------
    start = time.perf_counter()
    xo, yo = adult_census_shaped()
    cut = OVERVIEW_CUT
    reset_counts()
    fit_start = time.perf_counter()
    model = LightGBMClassifier(
        num_iterations=OVERVIEW_ITERATIONS, num_leaves=31,
        learning_rate=0.1).fit(Table({"features": xo[:cut],
                                      "label": yo[:cut]}), device="cuda")
    fit_s = time.perf_counter() - fit_start
    counts["overview_fit"] = read_counts()
    held = model.booster.predict(xo[cut:], device="cuda")
    auc = rank_auc(yo[cut:], held)
    check(auc > AUC_BAR, f"holdout AUC {auc}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_converted_")
    native = os.path.join(tmp, "model.txt")
    with open(native, "w") as fh:
        fh.write(model.booster.save_string())
    with open(native) as fh:
        reloaded = Booster.load_string(fh.read())
    native_err = float(np.abs(reloaded.predict(xo[cut:], device="cuda")
                              - held).max())
    check(native_err <= ROUND_TRIP_TOL, f"native round trip {native_err}")
    scorer = ONNXModel(model_bytes=convert_lightgbm(model),
                       feed_dict={"input": "features"})
    reset_counts()
    onnx_probs = scorer.transform(Table({"features": xo[cut:]}),
                                  device="cuda")["probabilities"]
    counts["overview_onnx_transform"] = read_counts()
    onnx_err = float(np.abs(onnx_probs[:, 1] - held).max())
    check(onnx_err <= CONVERTED_TOL, f"ONNX rescoring {onnx_err}")

    def pipeline(t):
        feats = np.stack([np.asarray(v["features"], np.float32)
                          for v in t["value"]])
        p = model.booster.predict(feats, device="cuda")
        replies = np.empty(t.num_rows, dtype=object)
        for i in range(t.num_rows):
            replies[i] = serving.make_reply({"p": float(p[i])})
        return t.with_column("reply", replies)

    cs = serving.ContinuousServer("e2e_lgbm", pipeline, max_batch=32).start()
    got = {}
    try:
        reset_counts()

        def client(i):
            req = urllib.request.Request(
                cs.url, json.dumps({"features": xo[cut + i].tolist()}
                                   ).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                got[i] = json.loads(resp.read())["p"]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        counts["overview_serving"] = read_counts()
    finally:
        cs.stop()
    direct = model.booster.predict(xo[cut:cut + 8], device="cuda")
    wire_err = float(max(abs(got[i] - direct[i]) for i in range(8))) \
        if len(got) == 8 else None
    check(wire_err is not None and wire_err < ROUND_TRIP_TOL,
          f"over the wire: {len(got)} replies, error {wire_err}")

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(600, 3)).astype(np.float32)
    ys = (2.0 * xs[:, 0] - 1.0 * xs[:, 1] > 0).astype(np.float64)
    smodel = LightGBMClassifier(num_iterations=30, num_leaves=15).fit(
        Table({"features": xs, "label": ys}), device="cuda")
    sscorer = ONNXModel(model_bytes=convert_lightgbm(smodel),
                        feed_dict={"input": "features"})

    class OnnxScorer(Transformer):
        def _transform(self, t, device):
            feats = np.column_stack([t["f0"], t["f1"], t["f2"]]).astype(
                np.float32)
            return t.with_column("probability", sscorer.transform(
                Table({"features": feats}), device=device)["probabilities"])

    shap = TabularSHAP(model=OnnxScorer(), input_cols=["f0", "f1", "f2"],
                       target_col="probability", target_classes=(1,),
                       num_samples=64, seed=0)
    reset_counts()
    phis = np.asarray(shap.transform(
        Table({"f0": xs[:16, 0], "f1": xs[:16, 1], "f2": xs[:16, 2]}),
        "cuda")["output"])[:, 0, :]
    counts["interpretability_shap"] = read_counts()
    mean_abs = np.abs(phis[:, 1:]).mean(axis=0)
    check(mean_abs[0] > ATTRIBUTION_RATIO * mean_abs[2],
          f"mean |phi| {mean_abs.tolist()}")
    check(counts["overview_fit"]["histogram"] > 0
          and counts["overview_onnx_transform"]["forest_traverse"] == 0
          and counts["overview_onnx_transform"]["histogram"] == 0
          and counts["interpretability_shap"]["forest_traverse"] == 0
          and counts["overview_serving"]["forest_traverse"] > 0,
          f"the examples' launches: {counts}")
    close_models(scorer, sscorer)
    walls["examples_s"] = time.perf_counter() - start
    emit({"phase": "converted_lgbm_examples",
          "overview": {"rows": OVERVIEW_ROWS, "train_rows": cut,
                       "iterations": OVERVIEW_ITERATIONS, "fit_s": fit_s,
                       "holdout_auc": auc, "auc_bar": AUC_BAR,
                       "native_round_trip_max_abs": native_err,
                       "onnx_rescoring_max_abs": onnx_err,
                       "wire_max_abs": wire_err},
          "interpretability": {"mean_abs_phi": mean_abs.tolist(),
                               "f0_over_f2": float(mean_abs[0]
                                                   / mean_abs[2])},
          "launches": {k: counts[k] for k in (
              "overview_fit", "overview_onnx_transform", "overview_serving",
              "interpretability_shap")},
          "walls_s": dict(walls), "nvidia_smi": smi})

    # -- c. the serving entry over the converted Adult file -----------------
    start = time.perf_counter()
    path = os.path.join(tmp, "adult.onnx")
    with open(path, "wb") as fh:
        fh.write(blob)
    bodies = [json.dumps({"features": row.tolist()}).encode()
              for row in x[:CONVERTED_REQUESTS]]
    entry = None
    try:
        entry = launch_entry(path, "adult_onnx", tmp)
        t_load = time.perf_counter()
        load = serve_bodies(entry["port"], bodies, SERVE_CLIENTS)
        load_s = time.perf_counter() - t_load
        check(replies_ok(load), "a converted-Adult reply was not 200 with "
                                "its body's digest")
        served = np.asarray([json.loads(r[1])["output"] for r in load])
        want = (k2[:CONVERTED_REQUESTS] > 0.5).astype(np.int64)
        check(np.array_equal(served, want),
              f"{int((served != want).sum())} served labels differ from "
              "Booster.predict > 0.5")
        metrics = entry_metrics(entry["port"])
        recompiles_served = prom_total(
            metrics, "synapseml_executor_recompiles_total")
        check(recompiles_served == 0,
              f"{recompiles_served} recompiles while serving")
        batch_sizes = prom_histogram(metrics, "synapseml_serving_batch_size",
                                     server="adult_onnx")
        transform_part = prom_histogram(
            metrics, "synapseml_model_pipeline_seconds", part="transform")
        exit_ = stop_entry(entry, CONVERTED_REQUESTS)
    finally:
        if entry is not None:
            kill_entry(entry)
        shutil.rmtree(tmp, ignore_errors=True)
    walls["entry_s"] = time.perf_counter() - start
    walls["phase_s"] = time.perf_counter() - phase_start
    emit({"phase": "converted_lgbm_serving", "model": "adult.onnx "
          "(convert_lightgbm of lgbm_adult_100x31.txt)",
          "warmup": entry["warmup"], "announce_s": entry["announce_s"],
          "requests": CONVERTED_REQUESTS, "clients": SERVE_CLIENTS,
          "all_200_with_digest": True, "labels_equal_booster": True,
          "requests_per_s": CONVERTED_REQUESTS / load_s,
          "latency": latency_ms([r[3] for r in load]),
          "serving_batch_size": batch_sizes,
          "model_pipeline_transform_seconds": transform_part,
          "recompiles": recompiles_served, **exit_,
          "walls_s": walls, "nvidia_smi": smi})
    return counts


TAGGER_FIXTURE = os.path.join(FIXTURES, "tagger_io.npz")
TAGGER_EXAMPLE = dict(vocab_size=64, num_tags=4, d_model=32, head_dim=8,
                      ffn_dim=64, max_seq_len=16)
EXAMPLE_STEPS = 200           # examples/bilstm_entity_extraction.py
SEQ_BATCH, SEQ_LEN = 32, 512  # the default width's forward and steps
SEQ_F32_CPU_TOL = 1e-4        # float32 logits vs the port's CPU run, of
                              # the largest |logit|
SEQ_F32_JAX_TOL = 1e-3        # float32 logits vs the JAX fixture (§2's gate)
SEQ_BF16_RMS = 0.05           # bf16: RMS of the gap over RMS of the logits
SEQ_GRAD_TOL = 1e-4           # float32 gradients, of each leaf's largest
SEQ_UPDATE_L2 = 1e-2          # float32 updates after 3 steps: L2 of the gap
                              # over L2 of the update, the whole model (the
                              # port's CPU run and JAX's: 4.5% at 32 x 512)
SEQ_UPDATE_LR = 1e-3          # float32 update sums vs JAX, in lr a parameter
SEQ_BF16_TRAIN = 0.05         # bf16 losses (of the first) and gradient norms


def entity_batches(rng, vocab, n_tags, b, s):
    """Tokens 0..9 are 'entity' words tagged 1, the rest tagged 0;
    tag 2 marks the token after an entity (a BIO-ish structure).
    (``examples/bilstm_entity_extraction.py``'s, copied: the examples
    import JAX.)"""
    tokens = rng.integers(10, vocab, (b, s)).astype(np.int32)
    ent = rng.random((b, s)) < 0.2
    tokens[ent] = rng.integers(0, 10, ent.sum())
    labels = np.zeros((b, s), np.int32)
    labels[ent] = 1
    after = np.roll(ent, 1, axis=1)
    after[:, 0] = False
    labels[after & ~ent] = 2
    return tokens, labels


@contextlib.contextmanager
def routes_of(moe_module):
    """The experts each token went to, a ``[B, S, E]`` boolean array a
    layer, read around ``moe_module.topk_gating``."""
    seen = []
    inner = moe_module.topk_gating

    def record(gate_logits, top_k):
        gates = inner(gate_logits, top_k)
        seen.append((gates > 0).cpu().numpy())
        return gates

    moe_module.topk_gating = record
    try:
        yield seen
    finally:
        moe_module.topk_gating = inner


def logit_gaps(got, want, got_routes, want_routes) -> dict:
    """How far ``got`` logits lie from ``want``: the largest gap, the
    per-token largest gap's p99 and maximum over the largest |logit|, the
    RMS gap over the RMS logit, the share of equal tags, and the tokens
    routed to other experts in some layer."""
    gap = np.abs(got - want)
    tok = gap.max(-1)
    top = float(np.abs(want).max())
    apart = ~np.all([(g == w).all(-1) for g, w in zip(got_routes,
                                                      want_routes)], axis=0)
    rms = np.sqrt((gap ** 2).mean() / (want ** 2).mean())
    return {"max_abs": float(gap.max()),
            "max_of_largest": float(tok.max()) / top,
            "p99_of_largest": float(np.percentile(tok, 99)) / top,
            "rms_of_rms": float(rms),
            "tags_equal": float((got.argmax(-1) == want.argmax(-1)).mean()),
            "tokens_routed_apart": int(apart.sum()), "tokens": int(apart.size)}


def tagger_steps(tagger, cfg, dev, batch) -> dict:
    """Three AdamW steps of ``make_train_step(cfg)`` from
    ``init_params(cfg, 0)`` on ``dev``: the losses, the first step's
    gradients and their L2 norm a leaf, the parameters after."""
    step, init_state, place = tagger.make_train_step(cfg, device=dev)
    params, opt = init_state(0)
    before = {n: p.detach().cpu().numpy().copy()
              for n, p in params.named_parameters()}
    placed = [place(a) for a in batch]
    losses, grads = [], None
    for _ in range(3):
        params, opt, loss = step(params, opt, *placed)
        losses.append(float(loss))
        if grads is None:
            grads = {n: p.grad.detach().cpu().numpy().copy()
                     for n, p in params.named_parameters()}
    after = {n: p.detach().cpu().numpy()
             for n, p in params.named_parameters()}
    return {"losses": losses, "grads": grads, "after": after,
            "update": {n: a.astype(np.float64) - before[n]
                       for n, a in after.items()},
            "grad_norm": {n: float(np.linalg.norm(g.astype(np.float64)))
                          for n, g in grads.items()}}


def held_steps(card, other, dname, lr) -> dict:
    """Card steps against another run of the same port code (CPU): float32
    losses within rtol 1e-4, each gradient within SEQ_GRAD_TOL of its leaf's
    largest, the whole model's update within SEQ_UPDATE_L2 (L2 of the gap
    over L2 of the update); bf16 losses within 5% of the first and gradient
    norms within 5%. The largest gap of one parameter, in lr, is reported:
    Adam moves a parameter whose gradient is within rounding of 0 by up
    to lr a step in either direction."""
    loss_gap = max(abs(a - b) for a, b in zip(card["losses"], other["losses"]))
    grad_gap = max(float(np.abs(card["grads"][n] - g).max() / np.abs(g).max())
                   for n, g in other["grads"].items())
    norm_gap = max(abs(card["grad_norm"][n] - v) / v
                   for n, v in other["grad_norm"].items())
    param_gap = max(float(np.abs(card["after"][n] - a).max()) / lr
                    for n, a in other["after"].items())
    update_gap = np.sqrt(
        sum(((card["update"][n] - u) ** 2).sum()
            for n, u in other["update"].items())
        / sum((u ** 2).sum() for u in other["update"].values()))
    if dname == "float32":
        ok = (loss_gap <= 1e-4 * max(map(abs, other["losses"]))
              and grad_gap <= SEQ_GRAD_TOL and update_gap <= SEQ_UPDATE_L2)
    else:
        ok = (loss_gap <= SEQ_BF16_TRAIN * abs(other["losses"][0])
              and norm_gap <= SEQ_BF16_TRAIN)
    return {"losses": card["losses"], "other_losses": other["losses"],
            "loss_gap": loss_gap, "grad_gap_of_leaf_max": grad_gap,
            "grad_norm_rel_gap": norm_gap, "param_gap_in_lr": param_gap,
            "update_l2_gap": float(update_gap), "within_tol": bool(ok)}


def tagger_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 31: the MoE sequence tagger (``dl/tagger.py``) on the card.

    a. ``examples/bilstm_entity_extraction.py``'s training flow with the
       port's modules: ``TaggerConfig.for_mesh`` on the world-of-one mesh
       at the example's width, 200 AdamW steps at batch 16 x 16 (lr 3e-3,
       ``default_rng(0)``), the example's checks (last loss below 0.6 of
       the first, held-out token accuracy above 0.8).
    b. The default width (``TaggerConfig()``, 427,840 parameters) in
       float32 and bf16, dense and ring: a forward of 32 x 512 tokens held
       to the port's CPU run of the same inputs, and one of the fixture's
       2 x 512 tokens held to the JAX package's (``tagger_io.npz``);
       float32 within 1e-4 of the largest |logit| of the CPU's and
       rtol=atol=1e-3 of JAX's with every token routed alike, bf16 within
       an RMS gap of 5% of the RMS logit
       (at this width the reference's own bf16 dense and ring paths differ
       by up to 11.5% of the largest |logit| at one token, RMS 3.2%).
    c. Three train steps of the fixture's 2 x 128 batch, held to the CPU
       (:func:`held_steps`: float32 gradients within 1e-4 of each leaf's
       largest, the model's update within an L2 gap of 1%) and to the
       JAX fixture (float32: losses rtol
       1e-4, gradient norms rtol 1e-4, each leaf's update sums within
       1e-3·lr a parameter; bf16: losses and gradient norms within 5%),
       run twice on the card (bitwise or not); three steps of 32 x 512 held
       to the CPU the same way.
    d. Tokens/s of the 32 x 512 forward, train-step ms and tokens/s
       (median of 3 after a warm call), a step's launches and busy share
       (``torch.profiler``), its peak allocation above what was allocated
       before it. K1 and K2 launch 0 times."""
    import make_tagger_fixture as tfx
    from synapseml_tpu_torch.dl import tagger
    from synapseml_tpu_torch.parallel import moe
    from synapseml_tpu_torch.parallel.mesh import (build_mesh,
                                                   single_device_mesh)

    phase_start = time.perf_counter()
    fx = np.load(TAGGER_FIXTURE)
    lr = float(fx["lr"])
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    reset_counts()

    # -- a. the example's flow ------------------------------------------
    mesh = build_mesh()
    cfg = tagger.TaggerConfig.for_mesh(mesh, **TAGGER_EXAMPLE)
    step, init_state, place = tagger.make_train_step(cfg, mesh,
                                                     learning_rate=3e-3)
    params, opt = init_state()
    rng = np.random.default_rng(0)
    losses = []
    start = time.perf_counter()
    for _ in range(EXAMPLE_STEPS):
        tokens, labels = entity_batches(rng, cfg.vocab_size, cfg.num_tags,
                                        16, 16)
        params, opt, loss = step(params, opt, place(tokens), place(labels),
                                 place(np.ones((16, 16), np.bool_)))
        losses.append(float(loss))
    example_s = time.perf_counter() - start
    tokens, labels = entity_batches(rng, cfg.vocab_size, cfg.num_tags, 16, 16)
    with torch.no_grad():
        logits, _ = tagger.make_apply(cfg, mesh)(params, place(tokens))
    accuracy = float((logits.argmax(-1).cpu().numpy() == labels).mean())
    example = {"config": {k: v for k, v in vars(cfg).items() if k != "dtype"},
               "steps": EXAMPLE_STEPS, "first_loss": losses[0],
               "last_loss": losses[-1],
               "s_per_step": example_s / EXAMPLE_STEPS,
               "held_out_accuracy": accuracy}
    emit({"phase": "sequence_tagger", "part": "example_flow", **example,
          "device": smi})
    check(losses[-1] < 0.6 * losses[0],
          f"the tagger did not learn: loss {losses[0]} -> {losses[-1]}")
    check(accuracy > 0.8, f"held-out token accuracy {accuracy} <= 0.8")

    # -- b. the default width's forward ---------------------------------
    p0 = tagger.init_params(tagger.TaggerConfig(), 0)
    rng = np.random.default_rng(31)
    big = rng.integers(0, 4096, (SEQ_BATCH, SEQ_LEN)).astype(np.int32)
    big_labels = rng.integers(0, 16, (SEQ_BATCH, SEQ_LEN)).astype(np.int32)
    big_mask = rng.random((SEQ_BATCH, SEQ_LEN)) < 0.9
    forward, failed = {}, []
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        cfg = tagger.TaggerConfig(dtype=dtype)
        card_params = tagger.params_from_numpy(p0)
        cpu_params = tagger.params_from_numpy(p0, "cpu")
        for path, m in (("dense", None), ("ring", single_device_mesh())):
            card_apply = tagger.make_apply(cfg, m)
            cpu_apply = tagger.make_apply(cfg, m, device="cpu")
            res = {}
            for name, toks in (("cpu", big), ("jax", fx["tokens"])):
                toks_card = torch.as_tensor(toks, device="cuda")
                with torch.no_grad(), routes_of(moe) as card_routes:
                    got, aux = card_apply(card_params, toks_card)
                    got, aux = got.cpu().numpy(), float(aux)
                if name == "cpu":
                    with torch.no_grad(), routes_of(moe) as want_routes:
                        want, want_aux = cpu_apply(cpu_params, toks)
                        want, want_aux = want.numpy(), float(want_aux)
                    tol = SEQ_F32_CPU_TOL
                else:
                    want = fx[f"logits_{dname}_{path}"]
                    want_aux = float(fx[f"aux_{dname}_{path}"])
                    want_routes = list(fx[f"routes_{dname}_{path}"])
                    tol = SEQ_F32_JAX_TOL
                gaps = logit_gaps(got, want, card_routes, want_routes)
                gaps["aux"], gaps["other_aux"] = aux, want_aux
                if dname == "float32" and name == "cpu":
                    close = gaps["max_of_largest"] <= tol
                else:
                    close = np.allclose(got, want, rtol=tol, atol=tol)
                if dname == "float32":
                    ok = (close and gaps["tokens_routed_apart"] == 0
                          and abs(aux - want_aux) <= 1e-4 * abs(want_aux))
                else:
                    ok = (gaps["rms_of_rms"] <= SEQ_BF16_RMS
                          and abs(aux - want_aux) <= 0.05 * abs(want_aux))
                gaps["within_tol"] = bool(ok)
                if not ok:
                    failed.append(f"{dname} {path} vs {name}")
                res[f"vs_{name}"] = gaps
            toks_card = torch.as_tensor(big, device="cuda")

            def fwd():
                with torch.no_grad():
                    out = card_apply(card_params, toks_card)
                torch.cuda.synchronize()
                return out

            fwd_s, _ = wall_median(fwd)
            res["tokens_per_s"] = SEQ_BATCH * SEQ_LEN / fwd_s
            res["ms"] = fwd_s * 1e3
            forward[f"{dname}_{path}"] = res
    emit({"phase": "sequence_tagger", "part": "default_width_forward",
          "batch": [SEQ_BATCH, SEQ_LEN], "fixture_batch": list(
              fx["tokens"].shape), "tf32": tf32, "forward": forward,
          "device": smi})
    check(not failed, f"tagger forwards outside their tolerance: {failed}")

    # -- c. three train steps, against the CPU and the JAX fixture -------
    names = [str(n) for n in fx["leaf_names"]]
    small = (fx["train_tokens"], fx["train_labels"], fx["train_mask"])
    train, failed = {}, []
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        cfg = tagger.TaggerConfig(dtype=dtype)
        card = tagger_steps(tagger, cfg, "cuda", small)
        again = tagger_steps(tagger, cfg, "cuda", small)
        cpu = tagger_steps(tagger, cfg, "cpu", small)
        res = {"vs_cpu": held_steps(card, cpu, dname, lr)}
        res["repeat_bitwise"] = {
            "losses": card["losses"] == again["losses"],
            "grads": all(np.array_equal(card["grads"][n], again["grads"][n])
                         for n in names),
            "params": all(np.array_equal(card["after"][n], again["after"][n])
                          for n in names)}
        jl = [float(v) for v in fx[f"losses_{dname}"]]
        jn = dict(zip(names, map(float, fx[f"grad_norm_{dname}"])))
        loss_gap = max(abs(a - b) for a, b in zip(card["losses"], jl))
        norm_gap = max(abs(card["grad_norm"][n] - v) / v
                       for n, v in jn.items())
        upd = {}
        for key in ("update_sum", "update_abs_sum"):
            for i, n in enumerate(names):
                d = (card["after"][n] - tfx.leaf(p0, n)).astype(np.float64)
                mine = float(np.abs(d).sum() if key == "update_abs_sum"
                             else d.sum())
                recorded = float(fx[f"{key}_{dname}"][i])
                upd[f"{key}.{n}"] = abs(mine - recorded) / (d.size * lr)
        vs_jax = {"losses": jl, "loss_gap": loss_gap,
                  "grad_norm_rel_gap": norm_gap,
                  "update_gap_in_lr_a_param": max(upd.values())}
        if dname == "float32":
            ok = (loss_gap <= 1e-4 * max(map(abs, jl)) and norm_gap <= 1e-4
                  and max(upd.values()) <= SEQ_UPDATE_LR)
        else:
            ok = (loss_gap <= SEQ_BF16_TRAIN * abs(jl[0])
                  and norm_gap <= SEQ_BF16_TRAIN)
        vs_jax["within_tol"] = bool(ok)
        res["vs_jax"] = vs_jax
        big_batch = (big, big_labels, big_mask)
        big_card = tagger_steps(tagger, cfg, "cuda", big_batch)
        big_again = tagger_steps(tagger, cfg, "cuda", big_batch)
        big_cpu = tagger_steps(tagger, cfg, "cpu", big_batch)
        res["batch_32x512_vs_cpu"] = held_steps(big_card, big_cpu, dname, lr)
        res["batch_32x512_repeat_bitwise"] = all(
            np.array_equal(big_card["after"][n], big_again["after"][n])
            for n in names) and big_card["losses"] == big_again["losses"]
        for key in ("vs_cpu", "vs_jax", "batch_32x512_vs_cpu"):
            if not res[key]["within_tol"]:
                failed.append(f"{dname} steps {key}")
        train[dname] = res
    emit({"phase": "sequence_tagger", "part": "train_steps",
          "batch": list(small[0].shape), "lr": lr, "train": train,
          "device": smi})
    check(not failed, f"tagger train steps outside their tolerance: {failed}")

    # -- d. times: forward above; train steps at 32 x 512 ----------------
    times = {}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        cfg = tagger.TaggerConfig(dtype=dtype)
        step, init_state, place = tagger.make_train_step(cfg)
        params, opt = init_state(0)
        batch = [place(a) for a in (big, big_labels, big_mask)]

        def one_step():
            step(params, opt, *batch)
            torch.cuda.synchronize()

        step_s, _ = wall_median(one_step)
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        one_step()
        peak = torch.cuda.max_memory_allocated() - resident
        busy = device_busy(one_step)
        times[dname] = {"step_ms": step_s * 1e3,
                        "tokens_per_s": SEQ_BATCH * SEQ_LEN / step_s,
                        "launches_a_step": busy.get("kernels"),
                        "busy": busy, "step_peak_bytes": peak}
    counts = read_counts()
    emit({"phase": "sequence_tagger", "part": "times", "device": smi,
          "batch": [SEQ_BATCH, SEQ_LEN],
          "forward_tokens_per_s": {k: v["tokens_per_s"]
                                   for k, v in forward.items()},
          "train": times, "launches": counts,
          "seconds": time.perf_counter() - phase_start})
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the tagger path launched K1/K2: {counts}")
    return counts


DECODE_GEOMETRY = dict(max_batch=8, prefill_chunk=64, page_size=64,
                       max_seq=1024)
DECODE_SEQS = 32              # bench.py's heavy-tailed workload, wide width
NEAR_TIE = 1e-4               # top-2 gap below this share of the max |logit|
EVICT_SEQS, EVICT_PAGES = 16, 16  # the eviction run and its KV budget
SERVE_PROMPTS, SERVE_NEW, DECODE_CLIENTS = 16, 16, 8


def decode_work(n: int, vocab: int, seed: int = 0, new=None) -> list:
    """``bench.py``'s decode workload (``bench_decode_serving``) at the
    wide width: prompts of 16-384 tokens, so long prompts prefill in
    several chunks with a left-overlapped last one; every fourth sequence
    generates 192-256 tokens, the rest 8-32 (``new`` overrides)."""
    rng = np.random.default_rng(seed)
    work = []
    for i in range(n):
        plen = int(rng.integers(16, 385))
        nout = (int(rng.integers(192, 257)) if i % 4 == 0
                else int(rng.integers(8, 33)))
        work.append(([int(x) for x in rng.integers(1, vocab, plen)],
                     nout if new is None else new))
    return work


def decode_steps(tm, server: str) -> dict:
    """``{phase: [steps, seconds]}`` of the scheduler's
    ``decode_step_seconds`` histograms (submit to merged buffers)."""
    return {labels["phase"]: [m.count, m.sum]
            for labels, m in tm.series("decode_step_seconds")
            if labels.get("server") == server}


def run_decode(sched, work) -> dict:
    """Submit every sequence of ``work`` while holding the scheduler's
    lock (so the first admission sees them all and the schedule is the
    same from run to run), consume each stream on its own thread with
    timestamps; the streams, finish reasons, tokens/s, time to first
    token and inter-token latency, and the run's prefill and decode
    steps (count, mean ms, rows a decode step)."""
    import threading

    from synapseml_tpu_torch.runtime import telemetry as tm

    before = decode_steps(tm, sched.name)
    lock = threading.Lock()
    ttft, itl = [], []
    results = [None] * len(work)

    def consume(k, handle, t_sub):
        last, toks = None, []
        try:
            for tok in handle:
                now = time.perf_counter()
                with lock:
                    if last is None:
                        ttft.append(now - t_sub)
                    else:
                        itl.append(now - last)
                last = now
                toks.append(tok)
            results[k] = (toks, handle.finish_reason)
        except Exception as e:  # noqa: BLE001 - reported by the check below
            results[k] = (toks, f"error: {e!r}")

    threads = []
    start = time.perf_counter()
    with sched._cv:
        for k, (prompt, nout) in enumerate(work):
            handle = sched.submit(prompt, nout)
            th = threading.Thread(target=consume,
                                  args=(k, handle, time.perf_counter()),
                                  daemon=True)
            th.start()
            threads.append(th)
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - start
    check(all(r is not None for r in results)
          and not any(th.is_alive() for th in threads),
          "a decode stream did not finish")
    streams = [r[0] for r in results]
    reasons = [r[1] for r in results]
    check(reasons == ["completed"] * len(work)
          and [len(t) for t in streams] == [n for _, n in work],
          f"decode streams did not complete: {sorted(set(reasons))}")
    tokens = sum(len(t) for t in streams)
    steps = {}
    for phase, (n, sec) in decode_steps(tm, sched.name).items():
        n0, s0 = before.get(phase, [0, 0.0])
        steps[phase] = {"steps": n - n0,
                        "mean_ms": (sec - s0) / max(n - n0, 1) * 1e3,
                        "share_of_wall": (sec - s0) / wall}
    if "decode" in steps:
        # a sequence's first token comes from its last prefill chunk
        steps["decode"]["rows_a_step"] = (tokens - len(work)) / max(
            steps["decode"]["steps"], 1)
    return {"streams": streams, "wall_s": wall, "tokens": tokens,
            "tokens_per_s": tokens / wall, "steps": steps,
            "ttft_ms": {q: float(np.percentile(ttft, p) * 1e3)
                        for q, p in (("p50", 50), ("p95", 95))},
            "itl_ms": {q: float(np.percentile(itl, p) * 1e3)
                       for q, p in (("p50", 50), ("p95", 95))}}


def greedy_check(fn, work, streams, n_kv, kv, head, t_buf) -> dict:
    """Each generated token against the argmax of one full float32
    forward of ``fn`` (the port's ``bind()``) over that sequence's
    tokens so far: one forward a sequence gives every position's
    logits, right-padded in groups of 8 with ``seqlens_k`` = the group's
    length - 1. A token that differs where the forward's top-2 gap is
    below ``NEAR_TIE`` of its largest |logit| is a near-tie, counted;
    any other difference is a mismatch. ``n_kv`` zeroed ``[rows, kv,
    t_buf, head]`` buffers feed the forward. Returns the counts and, a
    sequence, which generated positions are near-ties."""
    ties = [None] * len(work)
    near = checked = 0
    bad = []
    order = sorted(range(len(work)),
                   key=lambda k: len(work[k][0]) + len(streams[k]))
    for g0 in range(0, len(order), 8):
        group = order[g0:g0 + 8]
        seqs = [work[k][0] + streams[k] for k in group]
        n = max(len(q) for q in seqs)
        ids = np.zeros((len(group), n), np.int64)
        for r, q in enumerate(seqs):
            ids[r, :len(q)] = q
        with torch.inference_mode():
            empty = [torch.zeros((len(group), kv, t_buf, head),
                                 device="cuda") for _ in range(n_kv)]
            logits = fn(torch.from_numpy(ids).cuda(),
                        torch.full((len(group),), n - 1, dtype=torch.int32,
                                   device="cuda"), *empty)[0]
            arg = logits.argmax(-1).cpu().numpy()
            top = logits.topk(2, dim=-1).values
            tie = ((top[..., 0] - top[..., 1])
                   < NEAR_TIE * logits.abs().amax(-1)).cpu().numpy()
            del logits, top, empty
        for r, k in enumerate(group):
            p0 = len(work[k][0]) - 1
            ties[k] = [bool(tie[r, p0 + j]) for j in range(len(streams[k]))]
            for j, tok in enumerate(streams[k]):
                checked += 1
                if tok != arg[r, p0 + j]:
                    if tie[r, p0 + j]:
                        near += 1
                    else:
                        bad.append([k, j, tok, int(arg[r, p0 + j])])
    torch.cuda.empty_cache()
    return {"tokens_checked": checked,
            "near_tie_positions": sum(map(sum, ties)),
            "near_ties_flipped": near, "mismatches": len(bad),
            "first_mismatches": bad[:8], "ties": ties}


def diverge_at_ties(got, want, ties) -> dict:
    """Streams of one workload from two runs: equal, or each first
    differing at a position the full forward marks a near-tie (the runs
    share every token before it, so they share that forward)."""
    equal = at_tie = 0
    off = []
    for k, (a, b) in enumerate(zip(got, want)):
        d = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
        if d is None:
            equal += 1
        elif d < len(ties[k]) and ties[k][d]:
            at_tie += 1
        else:
            off.append([k, d])
    return {"equal": equal, "first_difference_at_near_tie": at_tie,
            "differ_elsewhere": off}


def generate_bodies(port: int, bodies: list, clients: int) -> list:
    """POST ``bodies`` to ``/generate`` from ``clients`` threads, each on
    one keep-alive connection; ``[(status, body, digest, seconds)]`` in
    the bodies' order (a streamed reply's body is its NDJSON lines)."""
    import http.client
    import threading

    out = [None] * len(bodies)
    errors = []

    def client(c):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            for i in range(c, len(bodies), clients):
                start = time.perf_counter()
                conn.request("POST", "/generate", bodies[i],
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                out[i] = (resp.status, data,
                          resp.getheader("X-Output-Digest"),
                          time.perf_counter() - start)
            conn.close()
        except Exception as e:  # noqa: BLE001 - reported by the check below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not errors and not any(t.is_alive() for t in threads),
          f"/generate clients failed: {errors[:3]}")
    return out


def decode_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 32: decode serving on the card.

    1. The default ``zoo.tiny_decoder`` scheduler (``max_batch=4,
       prefill_chunk=8, page_size=8, max_seq=64``) runs
       ``tests/fixtures/decode_streams.py``'s sequences: continuous,
       static and evicting streams equal to the JAX fixture
       (``decode_streams.npz``).
    2. ``zoo.tiny_decoder`` at BERT-base width through
       ``DecodeScheduler(max_batch=8, prefill_chunk=64, page_size=64,
       max_seq=1024)``: ``warmup()`` captures 10 signatures (prefill S=64
       and decode S=1 at T = 64 ... 1,024), each ``compiled``, with the
       memory it reserves; 32 sequences of ``decode_work`` (seed 0), every
       generated token the argmax of one full float32 ``bind()`` forward
       over its sequence so far or a counted near-tie; a repeat run equal
       stream for stream.
    3. The first 16 sequences with the cache cut to 16 pages: evictions
       and recomputes counted, the streams equal to the continuous run's
       but at near-ties; the static-batching run likewise.
    4. Tokens/s continuous and static, TTFT and inter-token p50/p95, 0
       recompiles after warmup; one warm decode step (T=1,024) and one
       warm prefill: wall, the executor's dispatch, card time, launches
       and busy share (``torch.profiler``), each bitwise its eager step,
       beside the eager step's wall, issue and card time; the merge and
       the prefill logits' copy to the host.
    5. The entry ``--decode --model <the wide decoder>`` as a child
       process (geometry through ``SYNAPSEML_DECODE_*``): 16 prompts
       non-streamed and streamed from 8 clients, digests checked, the
       streamed final digest equal to the non-streamed reply's; an
       out-of-range token 400 and a request after it 200; SIGTERM, exit
       0, admitted = replied; requests/s and p50/p99.
    K1 and K2 launch 0 times."""
    sys.path.insert(0, FIXTURES)
    import decode_streams as decode_fx
    from synapseml_tpu_torch.onnx import import_model, zoo
    from synapseml_tpu_torch.runtime import telemetry as tm
    from synapseml_tpu_torch.runtime.decode import DecodeScheduler
    from synapseml_tpu_torch.runtime.kvcache import PagedKVCache

    phase_start = time.perf_counter()
    reset_counts()
    # -- 1. the default width against the JAX fixture ---------------------
    fixture = np.load(os.path.join(FIXTURES, "decode_streams.npz"))
    small = decode_fx.record(
        decode_fx.maker(DecodeScheduler, PagedKVCache,
                        import_model(zoo.tiny_decoder())), tm, tag="_card")
    small_equal = {k: bool(np.array_equal(small[k], fixture[k]))
                   for k in small}
    emit({"phase": "decode_serving", "part": "default_width_vs_jax",
          "equal": small_equal, "evictions": int(small["evictions"]),
          "recomputes": int(small["recomputes"])})
    check(all(small_equal.values()),
          f"default-width streams differ from the JAX fixture: "
          f"{small_equal}")

    # -- 2. the wide decoder ---------------------------------------------
    start = time.perf_counter()
    blob = zoo.tiny_decoder(**DECODER_WIDE)
    graph = import_model(blob)
    vocab = DECODER_WIDE["vocab"]
    build_s = time.perf_counter() - start
    torch.cuda.synchronize()
    sched = DecodeScheduler(graph, name="decode_wide", **DECODE_GEOMETRY)
    n_kv, kv, head = len(sched._kv_names), sched.kv_heads, sched.head_dim
    t_top = DECODE_GEOMETRY["max_seq"]
    torch.cuda.synchronize()
    reserved0 = torch.cuda.memory_reserved()
    start = time.perf_counter()
    rep = sched.warmup()
    warmup_s = time.perf_counter() - start
    reserved = torch.cuda.memory_reserved() - reserved0
    statuses = [(sig["phase"], sig["T"], sig["entries"])
                for sig in rep["signatures"]]
    check(len(statuses) == 10
          and all(e == ["compiled"] for _, _, e in statuses),
          f"decode warmup did not capture every signature: {statuses}")
    recompiles_before = sum(recompiles(tm).values())
    sched.start()
    work = decode_work(DECODE_SEQS, vocab)
    cont = run_decode(sched, work)
    again = run_decode(sched, work)
    greedy = greedy_check(sched._fn, work, cont["streams"], n_kv, kv, head,
                          t_top)
    ties = greedy.pop("ties")
    repeat_equal = again["streams"] == cont["streams"]

    # -- 3. static batching and eviction on the same warmed scheduler -----
    sched.static_batching = True
    static = run_decode(sched, work)
    sched.static_batching = False
    static_vs = diverge_at_ties(static["streams"], cont["streams"], ties)
    full_kv = sched.kv
    bpt = full_kv.bytes_per_token
    sched.kv = PagedKVCache(sched.page, bpt, name="decode_wide_evict",
                            capacity_bytes=EVICT_PAGES * sched.page * bpt)
    evict_work = work[:EVICT_SEQS]
    evict = run_decode(sched, evict_work)
    evictions = sum(m.value for labels, m in tm.series("kv_evictions_total")
                    if labels.get("cache") == "decode_wide_evict")
    recomputes_ = tm.counter("kv_recomputes_total",
                             cache="decode_wide_evict").value
    sched.kv.close()
    sched.kv = full_kv
    evict_vs = diverge_at_ties(evict["streams"],
                               cont["streams"][:EVICT_SEQS], ties)
    evict_greedy = greedy_check(sched._fn, evict_work, evict["streams"],
                                n_kv, kv, head, t_top)
    evict_greedy.pop("ties")
    recompiles_after = sum(recompiles(tm).values())

    # -- 4. one warm step against its eager step ---------------------------
    rng = np.random.default_rng(5)
    steps = {}
    for name, s_len, lens in (("decode", 1, t_top - 24),
                              ("prefill", sched.S_pre, t_top - 1)):
        ids = rng.integers(1, vocab, (sched.B, s_len)).astype(np.int64)
        seqlens = np.full((sched.B,), lens, np.int32)
        bufs = [torch.randn((sched.B, kv, t_top, head), device="cuda")
                for _ in range(n_kv)]
        ids_t = torch.from_numpy(ids.astype(np.int32)).cuda()
        lens_t = torch.from_numpy(seqlens).cuda()

        def warm():
            return sched._ex.submit(ids, seqlens, *bufs).result()

        def eager():
            return sched._fn(ids_t, lens_t, *bufs)

        got, want = warm(), eager()
        bitwise = bool(np.array_equal(got[0], want[0].cpu().numpy())
                       and all(torch.equal(a, b)
                               for a, b in zip(got[1:], want[1:])))
        disp = tm.histogram("executor_dispatch_seconds")
        n0, s0 = disp.count, disp.sum
        warm_wall = synced_wall_ms(warm)
        dispatch_ms = (disp.sum - s0) / max(disp.count - n0, 1) * 1e3
        steps[name] = {
            "S": s_len, "T": t_top, "bitwise_eager": bitwise,
            "warm_wall_ms": warm_wall, "warm_dispatch_ms": dispatch_ms,
            "warm_busy": device_busy(warm),
            "eager_wall_ms": synced_wall_ms(eager),
            "eager_issue_ms": issue_ms(eager),
            "eager_busy": device_busy(eager)}
        del bufs, got, want
    mask = np.arange(sched.B) % 2 == 0
    bufs = sched._zeros(t_top)
    merge_ms = synced_wall_ms(lambda: sched._merge(mask, bufs, bufs))
    del bufs
    logits = torch.zeros((sched.B, sched.S_pre, vocab), device="cuda")
    host = torch.empty(logits.shape, pin_memory=True)
    copy_ms = event_ms(lambda: host.copy_(logits, non_blocking=True), 10)
    del logits, host

    # the served prompts in process, for the served replies below
    serve_work = decode_work(SERVE_PROMPTS, vocab, seed=1, new=SERVE_NEW)
    in_process = run_decode(sched, serve_work)["streams"]
    counts = read_counts()
    sched.close()
    del sched, graph
    torch.cuda.empty_cache()
    wide = {"steps": steps, "merge_ms_t1024": merge_ms,
            "prefill_logits_copy_ms": copy_ms,
            "prefill_logits_bytes": DECODE_GEOMETRY["max_batch"]
            * DECODE_GEOMETRY["prefill_chunk"] * vocab * 4}
    for run in (cont, again, static, evict):
        run.pop("streams")
    emit({"phase": "decode_serving", "part": "wide", "device": smi,
          "model": "zoo.tiny_decoder(" + ", ".join(
              f"{k}={v}" for k, v in DECODER_WIDE.items()) + ")",
          "geometry": DECODE_GEOMETRY, "build_s": build_s,
          "warmup_s": warmup_s, "warmup_reserved_bytes": reserved,
          "signatures": statuses, "continuous": cont, "repeat": again,
          "repeat_equal": repeat_equal, "static": static,
          "static_vs_continuous": static_vs,
          "continuous_over_static": cont["tokens_per_s"]
          / static["tokens_per_s"],
          "greedy_vs_full_forward": greedy,
          "near_tie_share": NEAR_TIE,
          "evict": evict, "evict_pages": EVICT_PAGES,
          "evictions": evictions, "recomputes": recomputes_,
          "evict_vs_continuous": evict_vs,
          "evict_greedy_vs_full_forward": evict_greedy,
          "recompiles_after_warmup": recompiles_after - recompiles_before,
          **wide, "launches": counts})
    check(greedy["mismatches"] == 0,
          f"decode tokens off the full forward's argmax: {greedy}")
    check(repeat_equal, "a repeat decode run gave other streams")
    check(not static_vs["differ_elsewhere"],
          f"static streams differ from continuous: {static_vs}")
    check(evictions > 0 and recomputes_ > 0,
          f"the eviction run did not evict: {evictions}, {recomputes_}")
    check(not evict_vs["differ_elsewhere"]
          and evict_greedy["mismatches"] == 0,
          f"evicted streams differ: {evict_vs}, {evict_greedy}")
    check(recompiles_after == recompiles_before,
          "the decode loop ran a cold signature after warmup")
    for name, st in steps.items():
        check(st["bitwise_eager"], f"a warm {name} step is not bitwise "
                                   "its eager step")
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the decode path launched K1/K2: {counts}")

    # -- 5. the entry: --decode over the wide decoder ----------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_decode_")
    path = os.path.join(tmp, "decoder_wide.onnx")
    with open(path, "wb") as fh:
        fh.write(blob)
    del blob
    env = {"SYNAPSEML_DECODE_MAX_BATCH": str(DECODE_GEOMETRY["max_batch"]),
           "SYNAPSEML_DECODE_PREFILL_CHUNK":
               str(DECODE_GEOMETRY["prefill_chunk"]),
           "SYNAPSEML_KV_PAGE": str(DECODE_GEOMETRY["page_size"]),
           "SYNAPSEML_DECODE_MAX_SEQ": str(DECODE_GEOMETRY["max_seq"])}
    entry = None
    try:
        entry = launch_entry(path, "decode", tmp, mode=("--decode",),
                             env=env)
        bodies = []
        for prompt, nout in serve_work:
            for stream in (False, True):
                bodies.append(json.dumps(
                    {"tokens": prompt, "max_new_tokens": nout,
                     "stream": stream}).encode())
        start = time.perf_counter()
        replies = generate_bodies(entry["port"], bodies, DECODE_CLIENTS)
        load_s = time.perf_counter() - start
        bad = generate_bodies(entry["port"], [json.dumps(
            {"tokens": [1, vocab], "max_new_tokens": 4}).encode()], 1)[0]
        after = generate_bodies(entry["port"], [bodies[0]], 1)[0]
        served = {"after_bad": after[0] == 200
                  and after[2] == hashlib.sha256(after[1]).hexdigest()}
        plain = replies[0::2]
        streamed = replies[1::2]
        served["plain_ok"] = replies_ok(plain)
        digests_equal = tokens_equal = 0
        served_tokens = []
        for p, q in zip(plain, streamed):
            lines = q[1].decode().strip().split("\n")
            final = json.loads(lines[-1])
            toks = [json.loads(ln)["t"] for ln in lines[:-1]]
            ref = json.loads(p[1])
            served_tokens.append(ref["tokens"])
            digests_equal += int(q[0] == 200 and final.get("digest") == p[2])
            tokens_equal += int(toks == ref["tokens"])
        served["streamed_digest_equal"] = digests_equal
        served["streamed_tokens_equal"] = tokens_equal
        served["bad_token_status"] = bad[0]
        served["equal_in_process"] = sum(
            int(a == b) for a, b in zip(served_tokens, in_process))
        metrics = entry_metrics(entry["port"])
        served["recompiles"] = prom_total(metrics,
                                          "synapseml_executor_recompiles_total")
        served["warmup"] = entry["warmup"]
        served["start_to_announce_s"] = entry["announce_s"]
        stop = stop_entry(entry, len(bodies) + 2)
        entry = None
    finally:
        if entry is not None:
            kill_entry(entry)
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "decode_serving", "part": "entry", "device": smi,
          "requests": len(bodies), "clients": DECODE_CLIENTS,
          "requests_per_s": len(bodies) / load_s,
          "latency": latency_ms([r[3] for r in replies]),
          "plain_latency": latency_ms([r[3] for r in plain]),
          "streamed_latency": latency_ms([r[3] for r in streamed]),
          **served, **stop,
          "seconds": time.perf_counter() - phase_start})
    check(served["plain_ok"], "a /generate reply was not 200 with its "
                              "body's digest")
    check(served["streamed_digest_equal"] == SERVE_PROMPTS
          and served["streamed_tokens_equal"] == SERVE_PROMPTS,
          f"streamed replies differ from the plain ones: {served}")
    check(served["bad_token_status"] == 400 and served["after_bad"],
          f"an out-of-range token was not a 400 the entry survived: "
          f"{served}")
    check(served["recompiles"] == 0, "the entry recompiled after warmup")
    return counts


MLM_BATCH = 128               # the masked-LM head's warm signature
MLM_CPU_TOL = 1e-5            # card head vs the CPU head, of the largest |logit|
MLM_SEED = 1                  # the 128 sequences (the fixture's are seed 0)


def cases_on_card(cases, run) -> dict:
    """Every one-node case of the module ``cases`` (``index_op_cases``,
    ``vision_op_cases``, ``detection_op_cases`` or ``random_op_cases`` of
    ``tests/fixtures``; its ``CARD_CASES`` where it names them) on the
    card against the port's CPU run of the same seeded inputs,
    ``run(case, device)`` giving the outputs: bitwise where the case is
    exact, else within its bound (``cases.agree``); a case that names an
    exception in ``raises`` must raise it on the card. Any other exception
    propagates."""
    results = []
    for case in getattr(cases, "CARD_CASES", cases.CASES):
        if case["raises"]:
            try:
                run(case, "cuda")
                results.append({"name": case["name"], "ok": False,
                                "raised": None})
            except case["raises"]:
                results.append({"name": case["name"], "ok": True,
                                "raised": case["raises"].__name__})
            continue
        got = run(case, "cuda")
        results.append({"name": case["name"], "exact": case["exact"],
                        **cases.agree(case, got, run(case, "cpu"))})
    torch.cuda.synchronize()      # a device-side assert would surface here
    bounded = [r for r in results if "exact" in r and not r["exact"]]
    summary = {"cases": len(results),
               "failed": [r for r in results if not r["ok"]],
               "exact": sum(1 for r in results if r.get("exact")),
               "max_abs_err_within_bound": max(
                   (r["max_abs_err"] for r in bounded), default=0.0)}
    # what a case module's agree counts beyond ok and max_abs_err
    for key, fold in (("bitwise_share", min), ("differing", sum),
                      ("near_ties", sum), ("max_rel_err", max)):
        if any(key in r for r in bounded):
            summary[f"{key}_{fold.__name__}"] = fold(
                r[key] for r in bounded if key in r)
    return summary


def mlm_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 33: the ONNX indexing and loss ops on the card.

    1. Every one-node case of ``tests/fixtures/index_op_cases.py``
       (negative, past-the-end, tie, NaN and ``ignore_index=-100`` edges
       included) on the card equal to the port's CPU run, before any wide
       work: no device assert, the host-only ops refusing a device tensor.
    2. The masked-LM head (``tests/fixtures/mlm_head.py``) over
       ``zoo.transformer_encoder(30522, 768, 12, 3072, 12, seq_len=128,
       causal=False, seed=0)`` in float32: the fixture's 8 sequences
       against the JAX package's outputs (``mlm_head_io.npz``): floats
       within 1e-3 of the largest |logit|, ids and filled tokens equal but
       at counted near-ties.
    3. 128 sequences through two ``BatchedExecutor``s (``static_batch=128``,
       the hidden states kept on the card), each warmed to one CUDA graph
       (``compiled``): the warm head bitwise its eager run, a bound head's
       copies and syncs (none), the card's head within 1e-5 of the largest
       |logit| of the port's CPU head on the same hidden states (ids equal
       but at near-ties).
    4. Wall, card time, launches and busy share of the encoder and the
       head, eager and warm, and the memory each warmup reserves; the
       head's card time split into the projection, the port's ``TopK``
       (beside ``torch.topk`` on the same logits) and the rest; sequences/s
       of encoder plus head, warm.
    K1 and K2 launch 0 times."""
    sys.path.insert(0, FIXTURES)
    import mlm_head
    from synapseml_tpu_torch.onnx import GraphBuilder, import_model, zoo
    from synapseml_tpu_torch.onnx.importer import OpContext, _REGISTRY
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    phase_start = time.perf_counter()
    reset_counts()
    # -- 1. every one-node case, before the wide path ---------------------
    start = time.perf_counter()
    import index_op_cases

    one_node = cases_on_card(index_op_cases, index_op_cases.run)
    one_node["seconds"] = time.perf_counter() - start
    emit({"phase": "onnx_index_ops", "part": "one_node_cases", **one_node})
    check(not one_node["failed"],
          f"one-node cases differ on the card: {one_node['failed']}")

    # -- 2. the wide head against the JAX fixture -------------------------
    cfg = mlm_head.ENCODER
    seq, masked = cfg["seq_len"], mlm_head.MASKED
    start = time.perf_counter()
    enc_graph = import_model(zoo.transformer_encoder(**cfg))
    tok_emb = enc_graph.params["tok_emb"]
    head_graph = import_model(mlm_head.head_graph(GraphBuilder, tok_emb, seq,
                                                  masked))
    enc, head = enc_graph.bind(), head_graph.bind()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start

    def on_card(b):
        return [torch.from_numpy(a).cuda()
                for a in mlm_head.head_inputs(b)]

    fixture = dict(np.load(mlm_head.OUT))
    b8 = mlm_head.batch(mlm_head.N, seq, cfg["vocab"], masked)
    out8 = head(enc(torch.from_numpy(b8["tokens"]).cuda())[0], *on_card(b8))
    vs_jax = mlm_head.held(
        {k: v.cpu().numpy() for k, v in zip(mlm_head.OUTPUTS, out8)},
        fixture, ENCODER_TOL * float(fixture["span"]))
    emit({"phase": "onnx_index_ops", "part": "wide_head_vs_jax",
          "sequences": mlm_head.N, "masked": masked, **vs_jax})
    check(vs_jax["ok"], f"the wide head is off the JAX fixture: {vs_jax}")

    # -- 3. 128 sequences, eager and warm ---------------------------------
    b = mlm_head.batch(MLM_BATCH, seq, cfg["vocab"], masked, seed=MLM_SEED)
    tokens = torch.from_numpy(b["tokens"]).cuda()
    rest = on_card(b)
    hidden = enc(tokens)[0]
    eager = [t.cpu().numpy() for t in head(hidden, *rest)]
    warm_io = copies_and_syncs(head, hidden, *rest)

    def warmed(fn, like, **kw):
        ex = BatchedExecutor(fn, device="cuda", static_batch=MLM_BATCH, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved()
        begin = time.perf_counter()
        rep = ex.warmup(like)
        torch.cuda.synchronize()
        return ex, {"seconds": time.perf_counter() - begin,
                    "reserved_bytes": torch.cuda.memory_reserved() - before,
                    "entries": [e.get("status") for e in rep.entries],
                    "errors": list(rep.errors)}

    enc_ex, enc_warmup = warmed(enc, [tokens], device_outputs=[0])
    head_ex, head_warmup = warmed(head, [hidden, *rest])

    def enc_warm():
        return enc_ex.submit(tokens).result()

    def head_warm():
        return head_ex.submit(hidden, *rest).result()

    def both_warm():
        return head_ex.submit(enc_ex.submit(tokens).result()[0],
                              *rest).result()

    warm = list(head_warm())
    bitwise = all(np.array_equal(w.view(np.uint8), e.view(np.uint8))
                  for w, e in zip(warm, eager))
    hidden_warm_equal = bool(torch.equal(enc_warm()[0], hidden))

    start = time.perf_counter()
    cpu_head = head_graph.bind(device="cpu")
    cpu = [t.numpy() for t in cpu_head(hidden.cpu(),
                                       *[t.cpu() for t in rest])]
    cpu_s = time.perf_counter() - start
    picked = hidden[torch.arange(MLM_BATCH, device=hidden.device)[:, None],
                    rest[0]]
    emb_t = torch.from_numpy(np.ascontiguousarray(tok_emb.T)).cuda()
    bias = torch.from_numpy(mlm_head.mlm_bias(cfg["vocab"])).cuda()

    def project():
        return torch.matmul(picked, emb_t) + bias

    with torch.inference_mode():
        logits = project()
        top6 = torch.topk(logits, mlm_head.TOPK + 1, dim=-1)[0].cpu().numpy()
    want_cpu = dict(zip(mlm_head.OUTPUTS, cpu))
    want_cpu.update(positions=b["positions"],
                    gaps=top6[..., :-1] - top6[..., 1:])
    span = float(logits.abs().max())
    vs_cpu = mlm_head.held(dict(zip(mlm_head.OUTPUTS, eager)), want_cpu,
                           MLM_CPU_TOL * span)

    # -- 4. times ----------------------------------------------------------
    topk_ctx = OpContext({"axis": -1}, 17, "topk", "TopK", 2)
    k = np.array([mlm_head.TOPK], np.int64)
    with torch.inference_mode():
        port_topk = _REGISTRY["TopK"](topk_ctx, logits, k)
        lib_topk = torch.topk(logits, mlm_head.TOPK, dim=-1)
        topk_values_equal = bool(torch.equal(port_topk[0], lib_topk[0]))
        proj_ms = cuda_ms(project, reps=5, inner=5)
        topk_ms = cuda_ms(lambda: _REGISTRY["TopK"](topk_ctx, logits, k),
                          reps=5, inner=5)
        torch_topk_ms = cuda_ms(lambda: torch.topk(logits, mlm_head.TOPK,
                                                   dim=-1), reps=5, inner=5)
    del port_topk, lib_topk, logits
    times = {}
    for name, fn, card_ms in (
            ("encoder_eager", lambda: enc(tokens), True),
            ("encoder_warm", enc_warm, False),
            ("head_eager", lambda: head(hidden, *rest), True),
            ("head_warm", head_warm, False),
            ("encoder_and_head_warm", both_warm, False)):
        busy = device_busy(fn)
        times[name] = {"wall_ms": synced_wall_ms(fn, calls=5),
                       "card_ms": (cuda_ms(fn, reps=3, inner=3) if card_ms
                                   else busy.get("kernel_s", 0) * 1e3),
                       "launches": busy.get("kernels"),
                       "busy_share": busy.get("busy_share"),
                       "top": busy.get("top", [])[:4]}
    head_ms = times["head_eager"]["card_ms"]
    split = {"projection_ms": proj_ms, "topk_ms": topk_ms,
             "rest_ms": head_ms - proj_ms - topk_ms,
             "projection_tflop_per_s": 2 * MLM_BATCH * masked
             * cfg["d_model"] * cfg["vocab"] / proj_ms * 1e-9,
             "torch_topk_ms": torch_topk_ms,
             "topk_over_torch_topk": topk_ms / torch_topk_ms,
             "topk_values_equal_torch_topk": topk_values_equal}
    counts = read_counts()
    enc_ex.close()
    head_ex.close()
    del enc_ex, head_ex, enc, head, hidden, picked, emb_t, bias
    torch.cuda.empty_cache()
    emit({"phase": "onnx_index_ops", "part": "wide_head", "device": smi,
          "model": "zoo.transformer_encoder(" + ", ".join(
              f"{k}={v}" for k, v in cfg.items()) + ") + mlm_head",
          "batch": MLM_BATCH, "masked": masked, "build_s": build_s,
          "encoder_warmup": enc_warmup, "head_warmup": head_warmup,
          "warm_bitwise_eager": bitwise,
          "warm_hidden_bitwise_eager": hidden_warm_equal,
          "bound_head_copies_and_syncs": warm_io,
          "vs_cpu": vs_cpu, "cpu_head_s": cpu_s, "largest_logit": span,
          "times": times, "head_split": split,
          "sequences_per_s_warm": MLM_BATCH
          / times["encoder_and_head_warm"]["wall_ms"] * 1e3,
          "launches": counts,
          "seconds": time.perf_counter() - phase_start})
    for name, w in (("encoder", enc_warmup), ("head", head_warmup)):
        check(w["entries"] == ["compiled"] and not w["errors"],
              f"the {name} did not warm to one compiled signature: {w}")
    check(bitwise and hidden_warm_equal,
          "the warm masked-LM path is not bitwise its eager run")
    check(warm_io["syncs"] == 0 and warm_io["d2h_copies"] == 0
          and warm_io["h2d_copies"] == 0,
          f"the bound head synchronised or copied: {warm_io}")
    check(vs_cpu["ok"], f"the card's head is off its CPU run: {vs_cpu}")
    check(all(np.isfinite(a).all() for a in eager),
          "the head's outputs are not finite")
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the masked-LM path launched K1/K2: {counts}")
    return counts


VAE_TOL = 1e-3                # float32 decoder: of the largest |value|
VAE_BATCHES = (1, 4)          # latents a warm signature, 512 x 512 images
VAE_SEED = 2                  # the 512 x 512 latents (the fixture's: 1)
VAE_PARTS = ("convolutions", "group_norm", "resize", "attention", "rest")


def vae_part(ctx) -> str:
    """The part of the decoder a node belongs to (``VAE_PARTS``)."""
    if ctx.op_type == "Conv":
        return "convolutions"
    if ctx.op_type == "GroupNormalization":
        return "group_norm"
    if ctx.op_type == "Resize":
        return "resize"
    return "attention" if ctx.name.startswith("mid.attn.") else "rest"


def card_ms_by_part(graph, x, part_of, reps: int = 3, parts=VAE_PARTS,
                    host: bool = False) -> dict:
    """Card ms of one bound forward of ``graph`` on ``x`` (a tensor, or a
    tuple of the inputs) by part: a CUDA event before and after each node,
    the forward queued behind a device-side spin so the card runs the
    nodes back to back (where the host issues a part slower than the card
    runs it, its span is the host's issue time); the mean over ``reps``
    forwards after a warm one. ``host``: also the host ms each part takes
    to issue, under ``"host_ms"``."""
    import copy

    events = []
    issue = {p: 0.0 for p in parts}

    def timed(impl, part):
        def run(ctx, *args):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start = time.perf_counter()
            begin.record()
            out = impl(ctx, *args)
            end.record()
            issue[part] += time.perf_counter() - start
            events.append((part, begin, end))
            return out
        return run

    args = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    clocked = copy.copy(graph)
    clocked._nodes = [(timed(impl, part_of(ctx)), ctx, ins, outs)
                      for impl, ctx, ins, outs in graph._nodes]
    fn = clocked.bind()
    fn(*args)
    torch.cuda.synchronize()
    events.clear()
    issue.update({p: 0.0 for p in parts})
    torch.cuda._sleep(SPIN_CYCLES)
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    out = {p: 0.0 for p in parts}
    for part, begin, end in events:
        out[part] += begin.elapsed_time(end) / reps
    if host:
        out["host_ms"] = {p: v * 1e3 / reps for p, v in issue.items()}
    return out


def vae_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 34: the ONNX dense-image ops on the card.

    1. Every one-node case of ``tests/fixtures/vision_op_cases.py``
       (ConvTranspose, Resize, Upsample, Pad, the pools, MaxPool's Indices
       with MaxUnpool, the five normalizations, Col2Im, CenterCropPad) on
       the card equal to the port's CPU run, before any wide work: no
       device assert.
    2. Stable Diffusion v1's VAE decoder (``tests/fixtures/vae_decoder.py``,
       49.5 M float32 parameters from seed 0) at its published width: the
       fixture's 32 x 32 latents against the JAX package's images
       (``vae_decoder_io.npz``), within 1e-3 of the largest |value|.
    3. 1 and 4 latents of 64 x 64 (512 x 512 images) through one
       ``BatchedExecutor`` warmed to one CUDA graph a bucket
       (``compiled``): each warm run bitwise its eager run, a bound
       forward's copies and syncs (none), one latent on the card within
       1e-3 of the largest |value| of the port's CPU run.
    4. Images/s eager and warm; card ms (CUDA events) of a 4-latent
       forward and by part (convolutions, GroupNormalization, Resize,
       attention, the rest); launches and busy share; the memory warmup
       reserves. K1 and K2 launch 0 times."""
    sys.path.insert(0, FIXTURES)
    import vae_decoder
    import vision_op_cases
    from synapseml_tpu_torch.onnx import GraphBuilder, import_model
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    phase_start = time.perf_counter()
    reset_counts()
    # -- 1. every one-node case, before the wide path ---------------------
    start = time.perf_counter()
    one_node = cases_on_card(vision_op_cases, lambda case, dev: (
        vision_op_cases.run(case, import_model, GraphBuilder, dev)))
    one_node["seconds"] = time.perf_counter() - start
    emit({"phase": "onnx_vision_ops", "part": "one_node_cases", **one_node})
    check(not one_node["failed"],
          f"one-node cases differ on the card: {one_node['failed']}")

    # -- 2. the full-width decoder against the JAX fixture ----------------
    start = time.perf_counter()
    graph = import_model(vae_decoder.decoder_graph(GraphBuilder))
    fn = graph.bind()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    fixture = np.load(vae_decoder.OUT)
    got = np.concatenate([
        fn(torch.from_numpy(fixture["latents"][i:i + 1]).cuda())[0]
        .cpu().numpy() for i in range(len(fixture["latents"]))])
    span = float(fixture["span"])
    vs_jax = {"latents": list(fixture["latents"].shape),
              "max_abs_err": float(np.abs(got - fixture["image"]).max()),
              "bound": VAE_TOL * span, "largest_value": span,
              "jax_version": str(fixture["jax_version"])}
    emit({"phase": "onnx_vision_ops", "part": "vae_vs_jax", **vs_jax})
    check(got.shape == fixture["image"].shape
          and vs_jax["max_abs_err"] <= vs_jax["bound"],
          f"the decoder is off the JAX fixture: {vs_jax}")

    # -- 3. 512 x 512: eager, warm, the CPU -------------------------------
    size = vae_decoder.PUBLISHED_SIZE
    lat = vae_decoder.latents(max(VAE_BATCHES), size, seed=VAE_SEED)
    xs = {b: torch.from_numpy(lat[:b]).cuda() for b in VAE_BATCHES}
    eager = {b: fn(x)[0].cpu().numpy() for b, x in xs.items()}
    warm_io = copies_and_syncs(fn, xs[1])
    ex = BatchedExecutor(fn, device="cuda", min_bucket=min(VAE_BATCHES),
                         max_bucket=max(VAE_BATCHES))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    begin = time.perf_counter()
    rep = ex.warmup([xs[1]], buckets=list(VAE_BATCHES))
    torch.cuda.synchronize()
    warmup = {"seconds": time.perf_counter() - begin,
              "reserved_bytes": torch.cuda.memory_reserved() - before,
              "entries": [e.get("status") for e in rep.entries],
              "errors": list(rep.errors)}

    def warm_run(b):
        return ex.submit(xs[b]).result()[0]

    bitwise = {b: bool(np.array_equal(warm_run(b).view(np.uint8),
                                      eager[b].view(np.uint8)))
               for b in VAE_BATCHES}
    start = time.perf_counter()
    cpu = graph.bind(device="cpu")(torch.from_numpy(lat[:1]))[0].numpy()
    cpu_s = time.perf_counter() - start
    cpu_span = float(np.abs(cpu).max())
    vs_cpu = {"max_abs_err": float(np.abs(eager[1] - cpu).max()),
              "bound": VAE_TOL * cpu_span, "largest_value": cpu_span,
              "cpu_s": cpu_s}

    # -- 4. times ----------------------------------------------------------
    times = {}
    for b in VAE_BATCHES:
        eager_ms = synced_wall_ms(lambda: fn(xs[b]), calls=3)
        warm_ms = synced_wall_ms(lambda: warm_run(b), calls=3)
        times[b] = {"eager_wall_ms": eager_ms, "warm_wall_ms": warm_ms,
                    "images_per_s_eager": b / eager_ms * 1e3,
                    "images_per_s_warm": b / warm_ms * 1e3}
    big = max(VAE_BATCHES)
    with torch.inference_mode():
        card_ms = cuda_ms(lambda: fn(xs[big]), reps=3, inner=2)
        by_part = card_ms_by_part(graph, xs[big], vae_part)
    work = vae_decoder.flops(vae_decoder.FULL, big, size)
    busy_eager = device_busy(lambda: fn(xs[big]))
    busy_warm = device_busy(lambda: warm_run(big))
    counts = read_counts()
    ex.close()
    del ex, fn, graph, xs
    torch.cuda.empty_cache()
    emit({"phase": "onnx_vision_ops", "part": "vae_decoder_512",
          "device": smi, "model": "Stable Diffusion v1 VAE decoder "
          "(AutoencoderKL, runwayml/stable-diffusion-v1-5 vae/config.json),"
          f" {vae_decoder.parameters()} float32 parameters, seed "
          f"{vae_decoder.WEIGHT_SEED}", "latent": [4, size, size],
          "image": [3, 8 * size, 8 * size], "build_s": build_s,
          "warmup": warmup, "warm_bitwise_eager": bitwise,
          "bound_forward_copies_and_syncs": warm_io, "vs_cpu": vs_cpu,
          "times": times, "card_ms": {"batch": big, "forward": card_ms,
                                      "by_part": by_part,
                                      "parts_sum": sum(by_part.values())},
          "tflop": {k: v * 1e-12 for k, v in work.items()},
          "tflop_per_s": work["total"] / card_ms * 1e-9,
          "conv_tflop_per_s": work["conv"] / by_part["convolutions"] * 1e-9,
          "launches": {"eager": busy_eager.get("kernels"),
                       "warm": busy_warm.get("kernels")},
          "busy_share": {"eager": busy_eager.get("busy_share"),
                         "warm": busy_warm.get("busy_share")},
          "top_kernels_eager": busy_eager.get("top", [])[:5],
          "kernel_counts": counts,
          "seconds": time.perf_counter() - phase_start})
    check(warmup["entries"] == ["compiled"] * len(VAE_BATCHES)
          and not warmup["errors"],
          f"the decoder did not warm to one graph a bucket: {warmup}")
    check(all(bitwise.values()),
          f"a warm decoder run is not bitwise its eager run: {bitwise}")
    check(warm_io["syncs"] == 0 and warm_io["d2h_copies"] == 0
          and warm_io["h2d_copies"] == 0,
          f"the bound decoder synchronised or copied: {warm_io}")
    check(vs_cpu["max_abs_err"] <= vs_cpu["bound"],
          f"the card's decoder is off its CPU run: {vs_cpu}")
    check(all(np.isfinite(a).all() and a.shape == (len(a), 3, 8 * size,
                                                   8 * size)
              for a in eager.values()),
          "the decoder's images are not finite 512 x 512 images")
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the decoder path launched K1/K2: {counts}")
    return counts


DETECTION_POOLED_TOL = 1e-5   # RoiAlign output, card vs CPU, of the largest |value|
DETECTION_BOX_TOL = 1e-3      # matched detections' boxes vs JAX, of the largest |coordinate|
DETECTION_PARTS = ("nms_stage1", "nms_stage2", "roi_align", "gemm", "rest")
DCN_RES5 = dict(channels=512, hw=(25, 34), kernel=3)   # DCNv2 ResNet-50 res5
ROI_POOL5 = dict(channels=512, hw=(38, 63), rois=300, pooled=7,
                 spatial_scale=0.0625)                # Fast R-CNN VGG16


def detection_part(ctx) -> str:
    """The part of the detection head a node belongs to
    (``DETECTION_PARTS``)."""
    if ctx.name == "rpn_nms":
        return "nms_stage1"
    if ctx.name == "box_nms":
        return "nms_stage2"
    if ctx.op_type == "RoiAlign":
        return "roi_align"
    return "gemm" if ctx.op_type == "Gemm" else "rest"


def one_node_timing(graph_cls, import_model, op, feeds, inits, order,
                    **attrs):
    """A one-node graph of ``op`` (its inputs named in ``order``: graph
    inputs ``feeds``, initializers ``inits``) bound on the card: its
    CUDA-event ms, its synced wall ms and the peak memory one call
    allocates beyond its inputs."""
    g = graph_cls(opset=19)
    for name, a in feeds.items():
        g.add_input(name, a.dtype, list(a.shape))
    for name, a in inits.items():
        g.add_initializer(name, a)
    g.add_node(op, list(order), outputs=["y"], **attrs)
    g.add_output("y", np.float32, None)
    fn = import_model(g.to_bytes()).bind()
    xs = [torch.from_numpy(a).cuda() for a in feeds.values()]
    with torch.inference_mode():
        fn(*xs)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*xs)[0]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resident
        ms = cuda_ms(lambda: fn(*xs), reps=3, inner=3)
        wall = synced_wall_ms(lambda: fn(*xs), calls=3)
    return {"card_ms": ms, "wall_ms": wall, "peak_bytes": peak,
            "out_shape": list(out.shape),
            "finite": bool(torch.isfinite(out).all())}


def detection_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 35: the ONNX sampling and detection ops on the card.

    1. Every one-node case of ``tests/fixtures/detection_op_cases.py`` but
       ``ImageDecoder``'s (host only): NMS, RoiAlign, MaxRoiPool,
       DeformConv, GridSample, AffineGrid, with the tie, NaN, 1e10,
       near-threshold and out-of-range edges, on the card equal to the
       port's CPU run (NMS rows and MaxRoiPool bitwise, the sums within
       2e-5 of the largest |value|), before any wide work: no device
       assert.
    2. torchvision Faster R-CNN R50-FPN's second stage
       (``tests/fixtures/detection_head.py``) at its published width
       through ``bind()``: 1,000 proposals, NMS 0.7, RoiAlign 7 x 7 over
       P4 ``[1, 256, 50, 68]``, the two-layer MLP, the 91-class predictor,
       the box decode, per-class NMS 0.5 over 90 classes, the 100 best.
       The first stage's rows equal the JAX fixture's
       (``detection_head_io.npz``); the pooled features within 1e-5 of the
       largest |value| of the port's CPU run; the 100 detections the
       fixture's (label, slot) pairs but at counted near-ties, matched
       boxes within 1e-3 of the largest |coordinate|.
    3. A bound forward's copies and syncs (none).
    4. The eager forward's wall (median of 3), its card span and host
       issue ms by part (NMS stage 1, NMS stage 2, RoiAlign, the four
       ``Gemm``s, the rest), launches, busy share and peak allocation;
       DeformConv at DCNv2's ResNet-50 res5 width (512 -> 512, 3 x 3, with
       mask, 25 x 34) and MaxRoiPool at Fast R-CNN VGG16's ``roi_pool5``
       (300 rois, 7 x 7, ``spatial_scale`` 1/16 over ``[1, 512, 38, 63]``)
       alone, with the peak memory of each. K1 and K2 launch 0 times."""
    sys.path.insert(0, FIXTURES)
    import detection_head as head
    import detection_op_cases
    from synapseml_tpu_torch.onnx import GraphBuilder, import_model

    phase_start = time.perf_counter()
    reset_counts()
    # -- 1. every one-node case, before the wide path ---------------------
    start = time.perf_counter()
    one_node = cases_on_card(detection_op_cases, lambda case, dev: (
        detection_op_cases.run(case, import_model, GraphBuilder, dev)))
    one_node["seconds"] = time.perf_counter() - start
    emit({"phase": "onnx_detection_ops", "part": "one_node_cases",
          **one_node})
    check(not one_node["failed"],
          f"one-node cases differ on the card: {one_node['failed']}")

    # -- 2. the full-width head against the JAX fixture and the CPU ------
    start = time.perf_counter()
    cfg = head.FULL
    graph = import_model(head.head_graph(GraphBuilder, cfg))
    fn = graph.bind()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    feeds = head.inputs(cfg)
    xs = tuple(torch.from_numpy(feeds[k]).cuda() for k in head.INPUTS)
    got = {k: v.cpu().numpy() for k, v in zip(head.OUTPUTS, fn(*xs))}
    torch.cuda.synchronize()      # a device-side assert would surface here
    fixture = dict(np.load(head.OUT))
    start = time.perf_counter()
    cpu = {k: v.numpy() for k, v in zip(head.OUTPUTS, graph.bind(
        device="cpu")(*[torch.from_numpy(feeds[k]) for k in head.INPUTS]))}
    cpu_s = time.perf_counter() - start
    rows1_equal = bool(np.array_equal(got["rows1"], fixture["rows1"]))
    span = float(np.abs(cpu["pooled"]).max())
    pooled_err = float(np.abs(got["pooled"] - cpu["pooled"]).max())
    vs_jax = head.held(got, fixture, DETECTION_BOX_TOL)
    vs_cpu = head.held(got, cpu, DETECTION_BOX_TOL)
    kept = int((got["rows1"][:, 0] >= 0).sum())
    emit({"phase": "onnx_detection_ops", "part": "head_vs_jax",
          "rows1_equal_jax": rows1_equal,
          "rows2_equal_jax": bool(np.array_equal(got["rows2"],
                                                 fixture["rows2"])),
          "kept_proposals": kept, "kept_share": kept / cfg["proposals"],
          "pairs_over_threshold_jax": int(fixture["pairs_over_threshold"]),
          "detections_used": int((got["det_rows"][:, 0] >= 0).sum()),
          "vs_jax": vs_jax, "vs_cpu": vs_cpu,
          "pooled_max_abs_err_vs_cpu": pooled_err,
          "pooled_bound": DETECTION_POOLED_TOL * span,
          "pooled_span_cpu": span,
          "pooled_span_jax": float(fixture["pooled_span"]),
          "cpu_s": cpu_s, "jax_version": str(fixture["jax_version"])})
    check(rows1_equal, "the first NMS stage's rows differ from the JAX "
          "fixture's")
    check(pooled_err <= DETECTION_POOLED_TOL * span,
          f"the card's pooled features are off its CPU run: {pooled_err}")
    check(vs_jax["ok"], f"the detections are off the JAX fixture: {vs_jax}")
    check(all(np.isfinite(got[k]).all() for k in ("pooled", "det_boxes")),
          "the head's pooled features or boxes are not finite")

    # -- 3. a bound forward reads nothing back ----------------------------
    with torch.inference_mode():
        io = copies_and_syncs(fn, *xs)
    check(io["syncs"] == 0 and io["d2h_copies"] == 0
          and io["h2d_copies"] == 0,
          f"the bound detection head synchronised or copied: {io}")

    # -- 4. times ----------------------------------------------------------
    with torch.inference_mode():
        wall = synced_wall_ms(lambda: fn(*xs), calls=3)
        by_part = card_ms_by_part(graph, xs, detection_part, reps=3,
                                  parts=DETECTION_PARTS, host=True)
        busy = device_busy(lambda: fn(*xs))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(*xs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resident
    rng = np.random.default_rng(3)
    c, (h, w), k = (DCN_RES5["channels"], DCN_RES5["hw"], DCN_RES5["kernel"])
    f32 = np.float32
    dcn = one_node_timing(
        GraphBuilder, import_model, "DeformConv",
        {"x": rng.standard_normal((1, c, h, w), dtype=f32),
         "offset": rng.standard_normal((1, 2 * k * k, h, w), dtype=f32),
         "mask": rng.uniform(0, 1, (1, k * k, h, w)).astype(f32)},
        {"w": (rng.standard_normal((c, c, k, k), dtype=f32)
               / f32(np.sqrt(c * k * k))), "b": np.zeros(c, f32)},
        ("x", "w", "offset", "b", "mask"), pads=[1, 1, 1, 1])
    dcn["tflop_per_s"] = 2 * c * c * k * k * h * w / dcn["card_ms"] * 1e-9
    pc, (ph_, pw_), n_rois = (ROI_POOL5["channels"], ROI_POOL5["hw"],
                              ROI_POOL5["rois"])
    image = np.array([pw_, ph_]) / ROI_POOL5["spatial_scale"]
    wh = rng.uniform(32, 400, (n_rois, 2))
    xy = rng.uniform(0, 1, (n_rois, 2)) * (image - wh)
    rois = np.concatenate([np.zeros((n_rois, 1)), xy, xy + wh], 1).astype(f32)
    pool = one_node_timing(
        GraphBuilder, import_model, "MaxRoiPool",
        {"x": rng.standard_normal((1, pc, ph_, pw_), dtype=f32),
         "rois": rois}, {}, ("x", "rois"),
        pooled_shape=[ROI_POOL5["pooled"]] * 2,
        spatial_scale=ROI_POOL5["spatial_scale"])
    pool["reference_plan_bytes"] = (n_rois * pc * ROI_POOL5["pooled"]
                                    * ph_ * pw_ * 4)
    counts = read_counts()
    del fn, graph, xs
    torch.cuda.empty_cache()
    emit({"phase": "onnx_detection_ops", "part": "faster_rcnn_head",
          "device": smi, "model": "torchvision fasterrcnn_resnet50_fpn "
          "second stage (detection_head.FULL), weights seed "
          f"{head.WEIGHT_SEED}, inputs seed {head.INPUT_SEED}",
          "build_s": build_s, "bound_forward_copies_and_syncs": io,
          "wall_ms": wall, "card_span_ms_by_part": {
              p: by_part[p] for p in DETECTION_PARTS},
          "host_ms_by_part": by_part["host_ms"],
          "gemm_gflop": head.flops(cfg) * 1e-9,
          "launches": busy.get("kernels"), "busy_share":
          busy.get("busy_share"), "kernel_ms": busy.get("kernel_s", 0) * 1e3,
          "top_kernels": busy.get("top", [])[:5], "peak_bytes": peak,
          "deform_conv_res5": dcn, "max_roi_pool5": pool,
          "kernel_counts": counts,
          "seconds": time.perf_counter() - phase_start})
    check(dcn["finite"] and dcn["out_shape"] == [1, c, h, w],
          f"DeformConv at res5 width gave {dcn}")
    check(pool["finite"] and pool["out_shape"] == [n_rois, pc, 7, 7],
          f"MaxRoiPool at roi_pool5 width gave {pool}")
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the detection path launched K1/K2: {counts}")
    return counts


VAE_ENCODER_TOL = 1e-4        # float32 VAE encoder outputs: of each one's largest |value|
ENCODER_BATCHES = (1, 4)      # images a warm signature, 512 x 512
ENCODER_SEED = 2              # the 512 x 512 images (the fixture's: 1)
ENCODER_PARTS = ("convolutions", "group_norm", "attention", "random_draw",
                 "rest")


def encoder_part(ctx) -> str:
    """The part of the encoder a node belongs to (``ENCODER_PARTS``)."""
    if ctx.op_type == "Conv":
        return "convolutions"
    if ctx.op_type == "GroupNormalization":
        return "group_norm"
    if ctx.op_type == "RandomNormalLike":
        return "random_draw"
    return "attention" if ctx.name.startswith("mid.attn.") else "rest"


def random_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 36: the ONNX random ops on the card.

    1. Every one-node case of ``tests/fixtures/random_op_cases.py``
       (RandomNormal, RandomNormalLike, RandomUniform, RandomUniformLike,
       Bernoulli, Multinomial with a GPT-2-vocabulary head over
       ``[8, 50257]`` float32 and float16 logits, Dropout) on the card
       against the port's CPU run, before any wide work: uniform,
       Bernoulli and Dropout bitwise, normal draws within 1e-6,
       Multinomial ids equal but at counted near-ties.
    2. Stable Diffusion v1's VAE encoder (``tests/fixtures/vae_encoder.py``,
       34.2 M float32 parameters from seed 0), sampling its latent with
       ``RandomNormalLike``, at its published width: the fixture's two
       256 x 256 images against the JAX package's run
       (``vae_encoder_io.npz``): ``mean``, ``logvar`` and the latent
       within 1e-4 of each one's largest |value|, the draw within 1e-6.
    3. 1 and 4 images of 512 x 512 through ``bind()`` and one
       ``BatchedExecutor`` warmed to one CUDA graph a bucket: each warm
       run bitwise its eager run, two calls the same latents, a bound
       forward's copies and syncs (none), 3 images padded into bucket 4
       bitwise the first 3 of a full bucket, one image within 1e-4 of the
       port's CPU run.
    4. Images/s eager and warm; card ms (CUDA events) of a 4-image forward
       and by part (convolutions, GroupNormalization, attention, the
       random draw, the rest); launches, those of the draw alone, busy
       share; the memory warmup reserves. K1 and K2 launch 0 times."""
    sys.path.insert(0, FIXTURES)
    import random_op_cases
    import vae_encoder
    from synapseml_tpu_torch.onnx import GraphBuilder, import_model
    from synapseml_tpu_torch.runtime.executor import BatchedExecutor

    phase_start = time.perf_counter()
    reset_counts()
    # -- 1. every one-node case, before the wide path ---------------------
    start = time.perf_counter()
    one_node = cases_on_card(random_op_cases, lambda case, dev: (
        random_op_cases.run(case, import_model, GraphBuilder, dev)))
    one_node["seconds"] = time.perf_counter() - start
    emit({"phase": "onnx_random_ops", "part": "one_node_cases", **one_node})
    check(not one_node["failed"],
          f"one-node cases differ on the card: {one_node['failed']}")

    # -- 2. the full-width encoder against the JAX fixture ----------------
    start = time.perf_counter()
    graph = import_model(vae_encoder.encoder_graph(GraphBuilder))
    fn = graph.bind()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    fixture = np.load(vae_encoder.OUT)
    n, side = vae_encoder.FIXTURE_IMAGES, vae_encoder.FIXTURE_SIZE
    got = dict(zip(vae_encoder.OUTPUTS, (t.cpu().numpy() for t in fn(
        torch.from_numpy(vae_encoder.images(n, side)).cuda()))))
    vs_jax = {k: {"max_abs_err": float(np.abs(got[k] - fixture[k]).max()),
                  "bound": (VAE_ENCODER_TOL * float(fixture[f"span_{k}"])
                            if k != "eps" else None)}
              for k in vae_encoder.OUTPUTS}
    eps_ok = bool(np.allclose(got["eps"], fixture["eps"], rtol=1e-6,
                              atol=1e-6))
    emit({"phase": "onnx_random_ops", "part": "encoder_vs_jax",
          "images": [n, 3, side, side], "vs_jax": vs_jax,
          "eps_within_1e-6": eps_ok, "eps_bitwise_share": float(np.mean(
              got["eps"].view(np.uint32) == fixture["eps"].view(np.uint32))),
          "jax_version": str(fixture["jax_version"])})
    check(all(got[k].shape == fixture[k].shape for k in vae_encoder.OUTPUTS)
          and all(v["max_abs_err"] <= v["bound"] for k, v in vs_jax.items()
                  if k != "eps") and eps_ok,
          f"the encoder is off the JAX fixture: {vs_jax}, eps {eps_ok}")

    # -- 3. 512 x 512: eager, warm, padded, the CPU -----------------------
    size = vae_encoder.PUBLISHED_SIZE
    imgs = vae_encoder.images(max(ENCODER_BATCHES), size, seed=ENCODER_SEED)
    xs = {b: torch.from_numpy(imgs[:b]).cuda() for b in ENCODER_BATCHES}
    x3 = xs[4][:3].clone()

    def numpy_of(outs):
        return [t.cpu().numpy() for t in outs]

    def same_bits(got, want):
        return all(np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                                  np.ascontiguousarray(b).view(np.uint8))
                   for a, b in zip(got, want))

    eager = {b: numpy_of(fn(x)) for b, x in xs.items()}
    repeat = same_bits(numpy_of(fn(xs[4])), eager[4])
    with torch.inference_mode():
        io = copies_and_syncs(fn, xs[1])
    ex = BatchedExecutor(fn, device="cuda", min_bucket=min(ENCODER_BATCHES),
                         max_bucket=max(ENCODER_BATCHES))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    begin = time.perf_counter()
    rep = ex.warmup([xs[1]], buckets=list(ENCODER_BATCHES))
    torch.cuda.synchronize()
    warmup = {"seconds": time.perf_counter() - begin,
              "reserved_bytes": torch.cuda.memory_reserved() - before,
              "entries": [e.get("status") for e in rep.entries],
              "errors": list(rep.errors)}

    def warm_run(x):
        return list(ex.submit(x).result())

    warm = {b: warm_run(x) for b, x in xs.items()}
    bitwise = {b: same_bits(warm[b], eager[b]) for b in ENCODER_BATCHES}
    prefix = same_bits(warm_run(x3), [f[:3] for f in warm[4]])
    start = time.perf_counter()
    cpu = graph.bind(device="cpu")(torch.from_numpy(imgs[:1]))[0].numpy()
    cpu_s = time.perf_counter() - start
    cpu_span = float(np.abs(cpu).max())
    vs_cpu = {"max_abs_err": float(np.abs(eager[1][0] - cpu).max()),
              "bound": VAE_ENCODER_TOL * cpu_span, "largest_value": cpu_span,
              "cpu_s": cpu_s}

    # -- 4. times ----------------------------------------------------------
    times = {}
    for b in ENCODER_BATCHES:
        eager_ms = synced_wall_ms(lambda: fn(xs[b]), calls=3)
        warm_ms = synced_wall_ms(lambda: warm_run(xs[b]), calls=3)
        times[b] = {"eager_wall_ms": eager_ms, "warm_wall_ms": warm_ms,
                    "images_per_s_eager": b / eager_ms * 1e3,
                    "images_per_s_warm": b / warm_ms * 1e3}
    big = max(ENCODER_BATCHES)
    latent_shape = (big, 4, size // 8, size // 8)
    g = GraphBuilder(opset=vae_encoder.OPSET)
    g.add_input("mean", np.float32, list(latent_shape))
    g.add_node("RandomNormalLike", ["mean"], outputs=["eps"],
               name="sample.eps")
    g.add_output("eps", np.float32, None)
    draw_fn = import_model(g.to_bytes()).bind()
    mean = torch.zeros(latent_shape, device="cuda")
    with torch.inference_mode():
        card_ms = cuda_ms(lambda: fn(xs[big]), reps=3, inner=2)
        by_part = card_ms_by_part(graph, xs[big], encoder_part,
                                  parts=ENCODER_PARTS)
        draw_ms = cuda_ms(lambda: draw_fn(mean), reps=3, inner=5)
        busy_draw = device_busy(lambda: draw_fn(mean))
    work = vae_encoder.flops(vae_encoder.FULL, big, size)
    busy_eager = device_busy(lambda: fn(xs[big]))
    busy_warm = device_busy(lambda: warm_run(xs[big]))
    counts = read_counts()
    ex.close()
    del ex, fn, graph, xs, x3, draw_fn
    torch.cuda.empty_cache()
    emit({"phase": "onnx_random_ops", "part": "vae_encoder_512",
          "device": smi, "model": "Stable Diffusion v1 VAE encoder with "
          "its sampled latent (AutoencoderKL, runwayml/stable-diffusion-v1-5"
          f" vae/config.json), {vae_encoder.parameters()} float32 "
          f"parameters, seed {vae_encoder.WEIGHT_SEED}",
          "image": [3, size, size], "latent": [4, size // 8, size // 8],
          "build_s": build_s, "warmup": warmup,
          "warm_bitwise_eager": bitwise, "two_calls_bitwise": repeat,
          "padded_3_of_4_bitwise_full_bucket": prefix,
          "bound_forward_copies_and_syncs": io, "vs_cpu": vs_cpu,
          "times": times, "card_ms": {"batch": big, "forward": card_ms,
                                      "by_part": by_part,
                                      "parts_sum": sum(by_part.values())},
          "draw_alone": {"shape": list(latent_shape), "card_ms": draw_ms,
                         "launches": busy_draw.get("kernels")},
          "tflop": {k: v * 1e-12 for k, v in work.items()},
          "tflop_per_s": work["total"] / card_ms * 1e-9,
          "conv_tflop_per_s": work["conv"] / by_part["convolutions"] * 1e-9,
          "launches": {"eager": busy_eager.get("kernels"),
                       "warm": busy_warm.get("kernels")},
          "busy_share": {"eager": busy_eager.get("busy_share"),
                         "warm": busy_warm.get("busy_share")},
          "top_kernels_eager": busy_eager.get("top", [])[:5],
          "kernel_counts": counts,
          "seconds": time.perf_counter() - phase_start})
    check(warmup["entries"] == ["compiled"] * len(ENCODER_BATCHES)
          and not warmup["errors"],
          f"the encoder did not warm to one graph a bucket: {warmup}")
    check(all(bitwise.values()),
          f"a warm encoder run is not bitwise its eager run: {bitwise}")
    check(repeat, "two bound calls drew different latents")
    check(prefix, "3 images padded into bucket 4 are not the first 3 of a "
          "full bucket")
    check(io["syncs"] == 0 and io["d2h_copies"] == 0
          and io["h2d_copies"] == 0,
          f"the bound encoder synchronised or copied: {io}")
    check(vs_cpu["max_abs_err"] <= vs_cpu["bound"],
          f"the card's encoder is off its CPU run: {vs_cpu}")
    check(all(np.isfinite(a).all() and a.shape == (b, 4, size // 8,
                                                   size // 8)
              for b, outs in eager.items() for a in outs),
          "the encoder's outputs are not finite 64 x 64 latents")
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the random path launched K1/K2: {counts}")
    return counts


NEWS_DOCS = 256               # documents a forward of the text classifier
SEQ_MAP_BUCKETS = [8, 32]     # the device-only sequence graph's warm buckets
SEQ_MAP_CASE = "sequence_map_body_initializer_matmul_relu"
HOST_PARTS = ("strings", "label_encoder", "sequence")


def timed_parts(graph, part_of) -> tuple:
    """A copy of ``graph`` whose nodes, and those of its ``SequenceMap``
    body, add the host seconds each call takes to ``host[part]``
    (``part_of(ctx)``); a ``SequenceMap``'s own share is its time less its
    body's. Returns ``(copy, host)``."""
    import copy
    import functools

    from synapseml_tpu_torch.onnx import importer

    host = {}

    def timed(impl, part):
        @functools.wraps(impl)
        def run(ctx, *args, **kw):
            start = time.perf_counter()
            out = impl(ctx, *args, **kw)
            host[part] = host.get(part, 0.0) + time.perf_counter() - start
            return out
        return run

    def nodes(lowered):
        out = []
        for impl, ctx, ins, outs in lowered:
            body = ctx.attrs.get("__lowered_body__")
            if body is not None:
                body = copy.copy(body)
                body.lowered = nodes(body.lowered)
                ctx = importer.OpContext(
                    {**ctx.attrs, "__lowered_body__": body}, ctx.opset,
                    ctx.name, ctx.op_type, ctx.n_outputs)
                impl = timed(impl, "__map__")
            else:
                impl = timed(impl, part_of(ctx))
            out.append((impl, ctx, ins, outs))
        return out

    clocked = copy.copy(graph)
    clocked._nodes = nodes(graph._nodes)
    return clocked, host


def news_part(ctx) -> str:
    """The part of the classifier a node belongs to (its name's entry in
    ``newsgroups_classifier.PARTS``)."""
    import newsgroups_classifier as news

    return news.PARTS[ctx.name]


def sequence_string_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 37: the ONNX optional, sequence and string ops on the card.

    1. Every case of ``tests/fixtures/sequence_string_op_cases.py``
       (Optional, OptionalHasElement, OptionalGetElement, the Sequence
       ops, SplitToSequence, ConcatFromSequence, SequenceMap, StringConcat,
       StringSplit, StringNormalizer, RegexFullMatch, TfIdfVectorizer) on
       the card against the port's CPU run: strings and host values equal,
       floats bitwise but sums of products within 1e-5, counts bitwise,
       every refusal raised.
    2. A device-only sequence graph (``SplitToSequence(split=[4, 4, 4])``,
       ``SequenceMap`` over ``MatMul`` by a ``[4, 8]`` body initializer and
       ``Relu``, ``ConcatFromSequence``) through an ``ONNXModel`` warmed at
       buckets 8 and 32: every bucket captured, replays bitwise the eager
       model, a bound forward with no copy and no sync.
    3. The 20 Newsgroups-width classifier
       (``tests/fixtures/newsgroups_classifier.py``: 130,107 words, 20
       classes, seed 0) on 256 documents through ``bind()``: the first 32
       against the JAX fixture (``newsgroups_classifier_io.npz``: counts
       bitwise, labels equal but at counted near-ties, scores within 1e-4
       of the largest |score|) and against the port's CPU run.
    4. Documents/s (eager, median of 3 forwards), host ms by part (string
       ops, LabelEncoder, the sequence plumbing), card ms by part
       (TfIdfVectorizer's compare and add, Normalizer, the classifier's
       Gemm), launches, busy share, peak memory, copies to the card a
       document. K1 and K2 launch 0 times."""
    sys.path.insert(0, FIXTURES)
    import copy

    import newsgroups_classifier as news
    import sequence_string_op_cases as seq_cases
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import GraphBuilder, ONNXModel, importer
    from synapseml_tpu_torch.onnx import import_model

    phase_start = time.perf_counter()
    reset_counts()
    # -- 1. every case, before the wide path ------------------------------
    start = time.perf_counter()
    one_node = cases_on_card(seq_cases, lambda case, dev: seq_cases.run(
        case, import_model, GraphBuilder, dev))
    one_node["seconds"] = time.perf_counter() - start
    emit({"phase": "onnx_sequence_string_ops", "part": "one_node_cases",
          **one_node})
    check(not one_node["failed"],
          f"sequence/string cases differ on the card: {one_node['failed']}")

    # -- 2. a device-only sequence graph, warmed -------------------------
    start = time.perf_counter()
    blob = seq_cases.graph(seq_cases.by_name(SEQ_MAP_CASE), GraphBuilder)
    rows = np.random.default_rng(37).standard_normal(
        (max(SEQ_MAP_BUCKETS) + min(SEQ_MAP_BUCKETS), 12)).astype(np.float32)
    eager = ONNXModel(model_bytes=blob, mini_batch_size=max(SEQ_MAP_BUCKETS))
    warm = ONNXModel(model_bytes=blob, mini_batch_size=max(SEQ_MAP_BUCKETS))
    rep = warm.warmup(buckets=SEQ_MAP_BUCKETS, device="cuda")
    replays = {}
    for n in (min(SEQ_MAP_BUCKETS), max(SEQ_MAP_BUCKETS), len(rows)):
        a = served(eager, Table({"x": rows[:n]}))["y"]
        b = served(warm, Table({"x": rows[:n]}))["y"]
        replays[n] = bool(np.array_equal(a.view(np.uint32),
                                         b.view(np.uint32)))
    seq_fn = import_model(blob).bind()
    xd = torch.from_numpy(rows[:max(SEQ_MAP_BUCKETS)]).cuda()
    with torch.inference_mode():
        seq_io = copies_and_syncs(seq_fn, xd)
    w = seq_cases.by_name(SEQ_MAP_CASE)["nodes"][1][3]["body"]["inits"][0][1]
    want = np.concatenate([np.maximum(rows[:, 4 * i:4 * i + 4] @ w, 0)
                           for i in range(3)], axis=1)
    got = served(warm, Table({"x": rows}))["y"]
    seq_map = {"status": [e["status"] for e in rep.entries],
               "buckets": [e["bucket"] for e in rep.entries],
               "errors": rep.errors, "replays_bitwise_eager": replays,
               "bound_forward_copies_and_syncs": seq_io,
               "max_abs_err_vs_numpy": float(np.abs(got - want).max()),
               "seconds": time.perf_counter() - start}
    close_models(eager, warm)
    del eager, warm, seq_fn, xd
    emit({"phase": "onnx_sequence_string_ops", "part": "warm_sequence_map",
          **seq_map})
    check(seq_map["status"] == ["compiled"] * len(SEQ_MAP_BUCKETS)
          and not seq_map["errors"],
          f"the sequence graph did not capture a graph a bucket: {seq_map}")
    check(all(replays.values()),
          f"a warm sequence-graph replay is not its eager run: {replays}")
    check(seq_io["syncs"] == 0 and seq_io["h2d_copies"] == 0
          and seq_io["d2h_copies"] == 0,
          f"the bound sequence graph copied or synchronised: {seq_io}")
    check(seq_map["max_abs_err_vs_numpy"] <= 1e-4,
          f"the sequence graph is off its numpy forward: {seq_map}")

    # -- 3. the full-width classifier: the JAX fixture, the CPU -----------
    start = time.perf_counter()
    vocab = news.vocabulary(news.FULL["vocab"])
    graph = import_model(news.classifier_graph(GraphBuilder, news.FULL,
                                               vocab=vocab))
    fn = graph.bind()
    head = graph.truncated(2).bind()
    docs = news.documents(news.FULL, NEWS_DOCS, vocab=vocab)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - start
    fixture = np.load(news.OUT)
    n_fx = len(fixture["labels"])
    same_docs = news.digest(docs[:n_fx]) == str(fixture["docs_sha256"])
    labels, scores = (t.cpu().numpy() for t in fn(docs))
    counts = news.counts_of(head, docs)
    vs_jax = news.held(labels, scores, fixture)
    counts_vs_jax = news.same_counts(counts, fixture)
    start = time.perf_counter()
    cpu_graph = import_model(news.classifier_graph(GraphBuilder, news.FULL,
                                                   vocab=vocab))
    cpu_labels, cpu_scores = (t.numpy() for t in cpu_graph.bind(
        device="cpu")(docs[:n_fx]))
    cpu_counts = news.counts_of(cpu_graph.truncated(2).bind(device="cpu"),
                                docs[:n_fx])
    cpu_s = time.perf_counter() - start
    vs_cpu = news.held(labels, scores, {"labels": cpu_labels,
                                        "scores": cpu_scores})
    counts_vs_cpu = bool(np.array_equal(counts[:n_fx].view(np.uint32),
                                        cpu_counts.view(np.uint32)))
    del cpu_graph, cpu_counts
    emit({"phase": "onnx_sequence_string_ops", "part": "classifier_vs_jax",
          "documents": NEWS_DOCS, "fixture_documents": n_fx,
          "same_documents_as_fixture": same_docs, "vs_jax": vs_jax,
          "counts_bitwise_jax": counts_vs_jax, "vs_cpu": vs_cpu,
          "counts_bitwise_cpu": counts_vs_cpu, "cpu_s": cpu_s,
          "counted_tokens": float(counts.sum()),
          "jax_version": str(fixture["jax_version"])})
    check(same_docs, "the documents are not the fixture's (their digest)")
    check(vs_jax["ok"] and counts_vs_jax,
          f"the classifier is off the JAX fixture: {vs_jax}, counts "
          f"bitwise {counts_vs_jax}")
    check(vs_cpu["ok"] and counts_vs_cpu,
          f"the classifier is off its CPU run: {vs_cpu}, counts bitwise "
          f"{counts_vs_cpu}")
    check(labels.shape == (NEWS_DOCS,) and scores.shape == (
        NEWS_DOCS, news.FULL["classes"]) and np.isfinite(scores).all()
          and counts.shape == (NEWS_DOCS, news.FULL["vocab"]),
          "the classifier's outputs are not finite and of their shapes")
    del counts

    # -- 4. times ----------------------------------------------------------
    with torch.inference_mode():
        wall_ms = synced_wall_ms(lambda: fn(docs), calls=3)
        clocked, host = timed_parts(graph, news_part)
        cfn = clocked.bind()
        cfn(docs)
        torch.cuda.synchronize()
        host.clear()
        cfn(docs)
        torch.cuda.synchronize()
        del cfn, clocked
        host_ms = {p: host.get(p, 0.0) * 1e3
                   for p in HOST_PARTS + ("tfidf", "normalizer", "gemm")}
        host_ms["sequence"] += (host.get("__map__", 0.0) * 1e3 - sum(
            host.get(p, 0.0) * 1e3 for p in ("strings", "label_encoder",
                                             "tfidf")))
        # the card's parts, each timed alone on this forward's values: the
        # body up to its LabelEncoder gives each document's ids
        body = next(c for _, c, _, _ in graph._nodes
                    if c.op_type == "SequenceMap").attrs["__lowered_body__"]
        ops = [c.op_type for _, c, _, _ in body.lowered]
        tfidf = body.lowered[ops.index("TfIdfVectorizer")]
        prefix = copy.copy(body)
        prefix.lowered = body.lowered[:ops.index("TfIdfVectorizer")]
        prefix.output_names = [prefix.lowered[-1][3][0]]
        prefix.drops = importer._last_uses(prefix.lowered,
                                           prefix.output_names)
        ids = [prefix.run({}, {body.input_names[0]: np.asarray(
            d, dtype=object)})[0] for d in docs]
        ids_card = [torch.from_numpy(i).cuda() for i in ids]
        tokens = int(sum(i.size for i in ids))
        dev = ids_card[0].device

        def count_all():
            with importer._running_on(dev):
                return [tfidf[0](tfidf[1], i) for i in ids_card]

        def node_fn(op_type):
            impl, ctx, _, _ = importer._bound_node(next(
                n for n in graph._nodes if n[1].op_type == op_type), dev)
            return lambda x: impl(ctx, x)

        rows_tf = count_all()
        stacked = torch.stack(rows_tf)
        normalize, classify = (node_fn("Normalizer"),
                               node_fn("LinearClassifier"))
        normed = normalize(stacked)
        with importer._ieee_float32():
            tfidf_busy = device_busy(count_all)
            card_ms = {
                "tfidf": tfidf_busy.get("kernel_s", float("nan")) * 1e3,
                "concat_from_sequence": cuda_ms(
                    lambda: torch.stack(rows_tf), reps=3, inner=5),
                "normalizer": cuda_ms(lambda: normalize(stacked), reps=3,
                                      inner=5),
                "gemm": cuda_ms(lambda: classify(normed), reps=3, inner=5)}
        busy = device_busy(lambda: fn(docs))
        few = docs[:8]
        io = copies_and_syncs(fn, few)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(docs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resident
    counts = read_counts()
    v, k = news.FULL["vocab"], news.FULL["classes"]
    del fn, head, graph, stacked, normed, ids_card, rows_tf
    torch.cuda.empty_cache()
    emit({"phase": "onnx_sequence_string_ops", "part": "newsgroups_256",
          "device": smi, "model": "20 Newsgroups-width text classifier "
          "(fetch_20newsgroups_vectorized: 130,107 CountVectorizer words, "
          "20 classes), L2-normalised counts, LinearClassifier; vocabulary,"
          f" weights and documents seed {news.SEED}",
          "documents": NEWS_DOCS, "tokens": tokens, "build_s": build_s,
          "wall_ms": wall_ms, "documents_per_s": NEWS_DOCS / wall_ms * 1e3,
          "host_ms_by_part": host_ms, "card_ms_by_part": card_ms,
          "tfidf_compares": tokens * v, "gemm_gflop": 2 * NEWS_DOCS * v * k
          * 1e-9, "launches": busy.get("kernels"),
          "busy_share": busy.get("busy_share"),
          "kernel_ms": busy.get("kernel_s", 0) * 1e3,
          "top_kernels": busy.get("top", [])[:5],
          "tfidf_launches": tfidf_busy.get("kernels"),
          "peak_bytes": peak, "copies_and_syncs_8_documents": io,
          "h2d_copies_per_document": io["h2d_copies"] / len(few),
          "kernel_counts": counts,
          "seconds": time.perf_counter() - phase_start})
    check(io["h2d_copies"] == len(few) and io["d2h_copies"] == 0,
          f"a bound forward copied more than each document's ids: {io}")
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the sequence/string path launched K1/K2: {counts}")
    return counts


SPEECH_CLIPS = 32             # Whisper-geometry clips a batch, 30 s each
SPEECH_TOL = 1e-3             # log-mel: rtol = atol, vs JAX and the CPU (tests/test_cognitive.py's gate)
CHAIN_TOL = 1e-4              # the chain's mean states where determined, vs JAX (20-s cut)
CHAIN_CPU_TOL = 1e-3          # the same over 10 minutes, card vs CPU: up to 811 LSTM steps
SPEECH_PARTS = {"STFT": "stft", "ReduceSumSquare": "power",
                "MelWeightMatrix": "mel_matrix", "MatMul": "mel_matmul",
                "Add": "log", "Log": "log"}


def close_featurizers(*featurizers) -> None:
    """Close the executors of ``AudioFeaturizer`` s (their threads, pinned
    buffers and warm graphs)."""
    for f in featurizers:
        for _, executor in f.__dict__.get("_audio_cache", {}).values():
            executor.close()


def log_mel_gap(got, want) -> dict:
    """Per-clip log-mel features against another run's: same frame
    counts, within :data:`SPEECH_TOL` (rtol = atol); the largest gap and
    its share of that bound."""
    ok, gap, share = len(got) == len(want), 0.0, 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        ok &= a.shape == b.shape and bool(np.isfinite(a).all())
        if not ok or not a.size:
            continue
        d = np.abs(a - b)
        gap = max(gap, float(d.max()))
        share = max(share, float((d / (SPEECH_TOL + SPEECH_TOL
                                       * np.abs(b))).max()))
    return {"ok": bool(ok and share <= 1.0), "max_abs_err": gap,
            "share_of_bound": share}


def eager_against_warm(featurizers: dict, executors: dict, table, batch,
                       rounds: int = 5) -> dict:
    """Where a warm featurization's wall goes against an eager one's, for
    each named featurizer and its executor: ``rounds`` rounds, the order
    alternating, of one ``transform`` of ``table`` (with the executor's
    stage seconds: ``stage`` coerces into pinned memory, ``dispatch``
    issues the copy in, the forward or replay and the copy out, ``drain``
    waits and hands back) and one call of the executor alone on the
    padded ``batch``, each from a synchronised card to a synchronised
    card; medians and every wall. Then one profiled call of each executor
    (CPU and CUDA activity) while the caller still holds the last call's
    output (the features a ``transform`` returns are views of it): its
    dispatch ms, its copies on the card by kind (count, ms) and the host
    operations with the most self time."""
    from torch.profiler import ProfilerActivity, profile

    from synapseml_tpu_torch.runtime import telemetry as tm

    def synced_ms(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    walls = {k: {"transform_ms": [], "executor_ms": [], "stages_ms": []}
             for k in featurizers}
    for r in range(rounds):
        for name in (list(featurizers) if r % 2 == 0
                     else list(featurizers)[::-1]):
            tm.reset()
            walls[name]["transform_ms"].append(
                synced_ms(lambda: featurizers[name].transform(table)))
            walls[name]["stages_ms"].append(
                {s: v["sum_s"] * 1e3
                 for s, v in executor_stages(tm).items()})
            walls[name]["executor_ms"].append(
                synced_ms(lambda: executors[name](batch)))
    out = {}
    cuda = torch.autograd.DeviceType.CUDA
    for name, w in walls.items():
        held = executors[name](batch)
        tm.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            executors[name](batch)
            torch.cuda.synchronize()
        held_dispatch_ms = executor_stages(tm)["dispatch"]["sum_s"] * 1e3
        del held
        copies = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.name().startswith("Mem"):
                n, ms = copies.get(e.name(), (0, 0.0))
                copies[e.name()] = (n + 1, ms + e.duration_ns() * 1e-6)
        host = sorted(prof.key_averages(),
                      key=lambda a: -a.self_cpu_time_total)
        out[name] = {
            "transform_ms_p50": statistics.median(w["transform_ms"]),
            "executor_ms_p50": statistics.median(w["executor_ms"]),
            "stages_ms_p50": {s: statistics.median(x[s] for x in
                                                   w["stages_ms"])
                              for s in w["stages_ms"][0]},
            **w,
            "output_held_dispatch_ms": held_dispatch_ms,
            "profiled_copies": {k: {"count": n, "ms": ms}
                                for k, (n, ms) in copies.items()},
            "profiled_host_top": [
                {"name": a.key[:60], "count": a.count,
                 "self_ms": a.self_cpu_time_total * 1e-3}
                for a in host[:10]]}
    return out


def speech_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 38: the ONNX signal ops and the speech front end on the card.

    1. Every case of ``tests/fixtures/signal_op_cases.py`` (DFT, STFT, the
       three windows, MelWeightMatrix, the log-mel chain) on the card
       against the port's CPU run: windows and filterbanks bitwise with
       the same host-ness, spectra within 1e-5 of each output's largest
       |value| (one step of a half-precision type), log-mel within 1e-3,
       every refusal raised.
    2. Whisper's front-end geometry (openai/whisper ``audio.py``: 16 kHz,
       N_FFT 400, HOP_LENGTH 160, N_MELS 80, 30-s chunks) through
       ``AudioFeaturizer`` on 32 seeded 30-s clips
       (``tests/fixtures/speech_clips.py``, seed 0): 2,998 frames a clip,
       bucketed to 4,096, a ``[32, 4096, 400]`` framed tensor. Clips 0-1
       against the JAX fixture (``speech_io.npz``), all 32 against the
       port's CPU run, within rtol = atol = 1e-3; the featurizer warmed at
       its bucket, its replay bitwise the eager features.
    3. The chain: a 10-minute seeded recording (utterances of 0.5-8 s,
       gaps of 0.4-1.5 s) through ``wav_to_utterance_rows`` (80 mel
       bins), ``utterance_feature_batch`` and a ``CNTKModel`` of
       ``build_optimized_rnn_model(80, 300, bidirectional=True,
       cell="lstm", seed=11)``: one mean state row an utterance, held
       where the states are determined (``speech_clips.held_means``) to
       the port's CPU run within 1e-3 (ONNX float32's gate: an utterance
       runs up to 811 recurrent steps) and, its first 20 s, to the JAX
       fixture within 1e-4.
    4. Audio seconds a second of wall (eager and warm in turn, their
       executor stages and copies: :func:`eager_against_warm`),
       utterances a second for the chain, host and card ms by part
       (framing, FFT, power, mel MatMul, log, LSTM), launches, busy share,
       peak memory, copies to the card a clip. K1 and K2 launch 0
       times."""
    sys.path.insert(0, FIXTURES)
    import signal_op_cases as sig_cases
    import speech_clips as sc
    from synapseml_tpu_torch.cognitive import (AudioFeaturizer, pcm_to_wav,
                                               segment_utterances,
                                               utterance_feature_batch,
                                               wav_to_utterance_rows)
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.dl.cntk import CNTKModel
    from synapseml_tpu_torch.dl.cntk_format import build_optimized_rnn_model
    from synapseml_tpu_torch.onnx import GraphBuilder, import_model
    from synapseml_tpu_torch.runtime.executor import round_up_pow2

    phase_start = time.perf_counter()
    reset_counts()
    # -- 1. every case, before the wide path ------------------------------
    start = time.perf_counter()
    one_node = cases_on_card(sig_cases, lambda case, dev: sig_cases.run(
        case, import_model, GraphBuilder, dev))
    one_node["seconds"] = time.perf_counter() - start
    emit({"phase": "signal_speech", "part": "one_node_cases", **one_node})
    check(not one_node["failed"],
          f"signal cases differ on the card: {one_node['failed']}")

    # -- 2. 32 clips at Whisper's geometry: JAX, the CPU, warm ------------
    start = time.perf_counter()
    pcm = [sc.clip_pcm(i) for i in range(SPEECH_CLIPS)]
    audio = np.empty(SPEECH_CLIPS, dtype=object)
    for i, p in enumerate(pcm):
        audio[i] = p.astype(np.float32) / 32768.0
    table = Table({"audio": audio})
    make_s = time.perf_counter() - start
    fx = np.load(sc.OUT)
    same_clips = [sc.digest(pcm[i]) for i in sc.FIXTURE_CLIPS] == \
        list(fx["clip_sha256"])
    feat = AudioFeaturizer(**sc.WHISPER_FEATURIZER)
    start = time.perf_counter()
    eager = feat.transform(table)["features"]
    cold_s = time.perf_counter() - start
    frames = sorted({len(f) for f in eager})
    graph, executor = feat._pieces(sc.SAMPLE_RATE, "cuda")
    padded = feat.padded_length(sc.N_SAMPLES)
    fixture_frames = np.stack([eager[i][::sc.FRAME_STRIDE]
                               for i in sc.FIXTURE_CLIPS])
    vs_jax = log_mel_gap(list(fixture_frames), list(fx["clip_frames"]))
    sums = np.stack([eager[i].astype(np.float64).sum(0)
                     for i in sc.FIXTURE_CLIPS])
    sums_gap = float(np.abs(sums - fx["clip_sums"]).max())
    sums_ok = bool(np.allclose(sums, fx["clip_sums"], rtol=SPEECH_TOL,
                               atol=SPEECH_TOL * max(frames)))
    start = time.perf_counter()
    cpu = AudioFeaturizer(**sc.WHISPER_FEATURIZER).transform(
        table, device="cpu")["features"]
    cpu_s = time.perf_counter() - start
    vs_cpu = log_mel_gap(eager, cpu)
    del cpu
    warm = AudioFeaturizer(**sc.WHISPER_FEATURIZER)
    start = time.perf_counter()
    rep = warm.warmup([sc.N_SAMPLES], buckets=[round_up_pow2(SPEECH_CLIPS)])
    warmup_s = time.perf_counter() - start
    warm_feats = warm.transform(table)["features"]
    _, warm_ex = warm._pieces(sc.SAMPLE_RATE, "cuda")
    replay_bitwise = all(np.array_equal(a.view(np.uint32),
                                        b.view(np.uint32))
                         for a, b in zip(warm_feats, eager))
    emit({"phase": "signal_speech", "part": "whisper_geometry_32_clips",
          "device": smi, "geometry": "openai/whisper audio.py: "
          "SAMPLE_RATE=16000, N_FFT=400, HOP_LENGTH=160, N_MELS=80, "
          "CHUNK_LENGTH=30; AudioFeaturizer's own HTK mel scale "
          "(125-7,600 Hz), symmetric Hann window and log(x + 1e-6)",
          "clips": SPEECH_CLIPS, "samples_a_clip": sc.N_SAMPLES,
          "frames_a_clip": frames, "padded_samples": padded,
          "framed_shape": [SPEECH_CLIPS, (padded - 400) // 160 + 1, 400],
          "make_clips_s": make_s, "cold_s": cold_s,
          "same_clips_as_fixture": same_clips, "vs_jax_fixture": vs_jax,
          "sums_vs_jax_max_abs_err": sums_gap, "sums_ok": sums_ok,
          "vs_cpu": vs_cpu, "cpu_s": cpu_s, "warmup_s": warmup_s,
          "warm_status": [e["status"] for e in rep.entries],
          "warm_errors": rep.errors, "warm_hits": warm_ex._aot_hits,
          "replay_bitwise_eager": replay_bitwise,
          "jax_version": str(fx["jax_version"])})
    check(same_clips, "the clips are not the fixture's (their digest)")
    check(frames == [2998], f"a 30-s clip gave {frames} frames, not 2,998")
    check(vs_jax["ok"] and sums_ok,
          f"Whisper-geometry log-mel is off the JAX fixture: {vs_jax}, "
          f"sums {sums_gap}")
    check(vs_cpu["ok"], f"the card's log-mel is off its CPU run: {vs_cpu}")
    check([e["status"] for e in rep.entries] == ["compiled"]
          and not rep.errors and warm_ex._aot_hits == 1,
          f"the featurizer did not run from its warm graph: {rep.errors}")
    check(replay_bitwise, "the warm featurizer's replay is not bitwise "
          "its eager features")

    # -- 3. where the time goes: rates, parts, launches, memory, copies ---
    dev = executor.device
    audio_s = SPEECH_CLIPS * sc.CHUNK_LENGTH
    batch = np.zeros((SPEECH_CLIPS, padded), np.float32)
    for i, a in enumerate(audio):
        batch[i, :len(a)] = a
    walls = eager_against_warm({"eager": feat, "warm": warm},
                               {"eager": executor, "warm": warm_ex}, table,
                               batch)
    eager_ms = walls["eager"]["transform_ms_p50"]
    warm_ms = walls["warm"]["transform_ms_p50"]
    n_frames_b = (padded - sc.N_FFT) // sc.HOP_LENGTH + 1
    spec_shape = [SPEECH_CLIPS, n_frames_b, sc.N_FFT // 2 + 1, 2]
    out_bytes = SPEECH_CLIPS * n_frames_b * sc.N_MELS * 4
    with torch.inference_mode():
        xd = torch.from_numpy(batch).to(dev)
        card_ms = card_ms_by_part(
            graph, xd, lambda ctx: SPEECH_PARTS[ctx.op_type],
            parts=set(SPEECH_PARTS.values()), host=True)
        host_ms = card_ms.pop("host_ms")
        win = torch.from_numpy(np.hanning(sc.N_FFT).astype(np.float32)).to(
            dev)
        framed = xd.unfold(-1, sc.N_FFT, sc.HOP_LENGTH) * win
        card_ms["framing"] = cuda_ms(
            lambda: xd.unfold(-1, sc.N_FFT, sc.HOP_LENGTH) * win, reps=3,
            inner=3)
        card_ms["fft"] = cuda_ms(lambda: torch.fft.rfft(framed), reps=3,
                                 inner=3)
        del framed
        fn = graph.bind()
        io_host = copies_and_syncs(fn, batch)
        io_card = copies_and_syncs(fn, xd)
        del fn
    busy = device_busy(lambda: feat.transform(table))
    warm_busy = device_busy(lambda: warm.transform(table))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    feat.transform(table)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    del xd
    emit({"phase": "signal_speech", "part": "whisper_geometry_timing",
          "device": smi, "audio_s": audio_s, "eager_wall_ms": eager_ms,
          "warm_wall_ms": warm_ms,
          "audio_s_per_s_eager": audio_s / eager_ms * 1e3,
          "audio_s_per_s_warm": audio_s / warm_ms * 1e3,
          "eager_against_warm": walls,
          "spectrum_shape": spec_shape, "card_ms_by_part": card_ms,
          "host_ms_by_part": host_ms,
          "hbm_floor_ms": (batch.nbytes + out_bytes) / HBM_BYTES_PER_S
          * 1e3,
          "launches": busy.get("kernels"), "busy_share":
          busy.get("busy_share"), "kernel_ms": busy.get("kernel_s", 0)
          * 1e3, "top_kernels": busy.get("top", [])[:6],
          "warm_launches": warm_busy.get("kernels"),
          "warm_busy_share": warm_busy.get("busy_share"),
          "warm_kernel_ms": warm_busy.get("kernel_s", 0) * 1e3,
          "peak_bytes": peak,
          "bound_forward_host_batch": io_host,
          "bound_forward_card_batch": io_card,
          "h2d_copies_per_clip": io_host["h2d_copies"] / SPEECH_CLIPS,
          "h2d_bytes_per_clip": padded * 4})
    check(io_card["h2d_copies"] == 0 and io_card["d2h_copies"] == 0
          and io_card["syncs"] == 0,
          f"a bound featurization of a card batch copied or synchronised: "
          f"{io_card}")
    check(io_host["h2d_copies"] == 1,
          f"a host batch took more than its own copy in: {io_host}")
    del batch, eager, warm_feats
    close_featurizers(feat, warm)
    del feat, warm, graph, executor, warm_ex
    torch.cuda.empty_cache()

    # -- 4. the chain: 10 minutes of audio to one state row an utterance --
    start = time.perf_counter()
    long_pcm = sc.long_pcm()
    wav = pcm_to_wav(long_pcm)
    cut = sc.long_wav(pcm_to_wav, sc.CUT_S)
    make_s = time.perf_counter() - start
    segments = segment_utterances(long_pcm, sc.SAMPLE_RATE)
    blob = build_optimized_rnn_model(**sc.RNN)
    front = AudioFeaturizer(num_mel_bins=sc.N_MELS)
    model = CNTKModel(model_bytes=blob)

    def chain(w, featurizer, cntk, device="cuda"):
        rows = wav_to_utterance_rows(w, featurizer, device=device)
        return (rows, *sc.chain_states(cntk, rows, utterance_feature_batch,
                                       Table, device=device))

    start = time.perf_counter()
    rows, means, states, n_frames = chain(wav, front, model)
    chain_cold_s = time.perf_counter() - start
    chain_ms = synced_wall_ms(lambda: chain(wav, front, model), calls=3)
    batch, _ = utterance_feature_batch(rows)
    front_busy = device_busy(lambda: wav_to_utterance_rows(
        wav, front, device="cuda"))
    lstm_busy = device_busy(lambda: model.transform(
        Table({"mel": batch}), device="cuda"))
    start = time.perf_counter()
    cpu_rows, cpu_means, _, cpu_n = chain(
        wav, AudioFeaturizer(num_mel_bins=sc.N_MELS),
        CNTKModel(model_bytes=blob), device="cpu")
    chain_cpu_s = time.perf_counter() - start
    rows_vs_cpu = log_mel_gap(list(rows["features"]),
                              list(cpu_rows["features"]))
    held_cpu = sc.held_means(means, cpu_means, n_frames, CHAIN_CPU_TOL)
    cut_rows, cut_means, _, cut_n = chain(cut, front, model)
    held_jax = sc.held_means(cut_means, fx["chain_means"], cut_n, CHAIN_TOL)
    same_cut = (sc.digest(np.frombuffer(cut, np.uint8))
                == str(fx["wav_sha256"])
                and np.array_equal(cut_n, fx["n_frames"])
                and np.array_equal(cut_rows["t_start"], fx["t_start"])
                and np.array_equal(cut_rows["t_end"], fx["t_end"]))
    counts = read_counts()
    n_utt = rows.num_rows
    emit({"phase": "signal_speech", "part": "speech_chain_10_min",
          "device": smi, "model": "wav_to_utterance_rows (80 mel bins) -> "
          "utterance_feature_batch -> CNTKModel(build_optimized_rnn_model("
          "80, 300, bidirectional=True, cell='lstm', seed=11)); recording "
          f"seed {sc.SEED}", "audio_s": sc.LONG_S, "utterances": n_utt,
          "segments_numpy": len(segments), "batch_shape": list(batch.shape),
          "states_shape": list(states.shape), "make_audio_s": make_s,
          "cold_s": chain_cold_s, "wall_ms": chain_ms,
          "utterances_per_s": n_utt / chain_ms * 1e3,
          "audio_s_per_s": sc.LONG_S / chain_ms * 1e3,
          "front_kernel_ms": front_busy.get("kernel_s", 0) * 1e3,
          "front_wall_ms": front_busy.get("wall_s", 0) * 1e3,
          "front_launches": front_busy.get("kernels"),
          "lstm_kernel_ms": lstm_busy.get("kernel_s", 0) * 1e3,
          "lstm_wall_ms": lstm_busy.get("wall_s", 0) * 1e3,
          "lstm_launches": lstm_busy.get("kernels"),
          "lstm_busy_share": lstm_busy.get("busy_share"),
          "lstm_top_kernels": lstm_busy.get("top", [])[:4],
          "cpu_s": chain_cpu_s, "features_vs_cpu": rows_vs_cpu,
          "states_vs_cpu": held_cpu, "cut_s": sc.CUT_S,
          "cut_utterances": cut_rows.num_rows,
          "cut_same_as_fixture": bool(same_cut), "cut_vs_jax": held_jax,
          "kernel_counts": counts,
          "seconds": time.perf_counter() - phase_start})
    check(n_utt == len(segments) and n_utt > 50,
          f"{n_utt} utterance rows for {len(segments)} segments")
    check(states.shape == (n_utt, int(n_frames.max()), 600)
          and bool(np.isfinite(states).all())
          and np.array_equal(n_frames, cpu_n),
          f"the chain's states are not finite rows of their shape: "
          f"{states.shape}")
    check(rows_vs_cpu["ok"], f"the chain's features are off the CPU: "
          f"{rows_vs_cpu}")
    check(held_cpu["ok"], f"the chain's states are off the CPU: {held_cpu}")
    check(same_cut and held_jax["ok"],
          f"the chain's 20-s cut is off the JAX fixture: {held_jax}, same "
          f"input {same_cut}")
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the signal/speech path launched K1/K2: {counts}")
    close_featurizers(front)
    close_models(model)
    del front, model, states, batch
    torch.cuda.empty_cache()
    return counts


DIST_CHANNELS = 4             # legs (a), (b): scorer threads sharing the card
DIST_ADULT_REQUESTS = 1024    # leg (a): one-row Adult requests, 16 clients
DIST_DRAIN_REQUESTS = 64      # leg (d): held in flight when drain() starts
DIST_CHAOS_REQUESTS = 512     # leg (b), with compute.channel1 armed
DIST_CHAOS_FIRES = 3          # compute.channel1's injected failures
DIST_PROBE_S = 0.25           # leg (b)'s half-open probe interval
READMIT_LIMIT_S = 5.0         # the last fire to channel 1 CLOSED again
DIST_RESNET_CHANNELS = 2
DIST_RESNET_REQUESTS = 64     # leg (c): entry()'s 8 images, cycled
DIST_RESNET_CLIENTS = 8
DIST_WAIT_S = 60.0            # hard wall of every wait in phase 39


def channel_of_thread():
    """The channel of the calling ``DistributedServer`` scorer thread
    (``chan-scorer-<server>-<channel>``); None on any other thread (the
    half-open probe's canary)."""
    import threading

    m = re.match(r"chan-scorer-.*-(\d+)$", threading.current_thread().name)
    return int(m.group(1)) if m else None


def wait_until(cond, what: str) -> None:
    """Poll ``cond`` every 10 ms; a failed check after ``DIST_WAIT_S``."""
    start = time.perf_counter()
    while not cond():
        check(time.perf_counter() - start < DIST_WAIT_S,
              f"{what}: not within {DIST_WAIT_S} s")
        time.sleep(0.01)


def adult_channel_pipeline(ds, model, scored, gate=None):
    """The Adult fixture model scored on ``ds.device_for_channel`` of the
    calling channel (the card; the probe's canary scores on ``cuda``):
    ``{"rawPrediction": [...]}`` a row, and ``(channel, rows, transform
    seconds)`` appended to ``scored`` for every batch that reached K2.
    ``gate``, when given, holds each batch until it is set."""
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.io import serving

    def pipeline(table):
        if gate is not None:
            gate.wait(DIST_WAIT_S)
        ch = channel_of_thread()
        dev = str(ds.device_for_channel(ch)) if ch is not None else "cuda"
        feats = np.asarray([v["features"] for v in table["value"]],
                           np.float32)
        t_batch = time.perf_counter()
        raw = model.transform(Table({"features": feats}),
                              device=dev)["rawPrediction"]
        scored.append((ch, len(feats), time.perf_counter() - t_batch))
        replies = np.empty(table.num_rows, dtype=object)
        for i in range(table.num_rows):
            replies[i] = serving.make_reply(
                {"rawPrediction": raw[i].tolist()})
        return table.with_column("reply", replies)
    return pipeline


def margins_bitwise(replies, raw) -> bool:
    margins = np.asarray([json.loads(r[1])["rawPrediction"][1]
                          for r in replies], np.float32)
    return bool(np.array_equal(margins, raw[:len(replies)]))


def by_channel(scored, n: int) -> dict:
    return {"batches": [sum(1 for c, _, _ in scored if c == ch)
                        for ch in range(n)],
            "rows": [sum(r for c, r, _ in scored if c == ch)
                     for ch in range(n)]}


def transform_times(scored, wall_s: float) -> dict:
    """The first batch's ``transform`` ms, the later ones' p50/p99, and
    the thread-seconds in ``transform`` a second of the leg's wall."""
    secs = [s for _, _, s in scored]
    return {"first_ms": secs[0] * 1e3 if secs else None,
            "later": latency_ms(secs[1:]) if len(secs) > 1 else None,
            "thread_s_per_wall_s": sum(secs) / wall_s}


def one_request(port: int, body: bytes) -> tuple:
    """One POST on its own connection: ``(status, body, digest,
    Retry-After)``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=DIST_WAIT_S)
    try:
        conn.request("POST", "/", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return (resp.status, data, resp.getheader("X-Output-Digest"),
                resp.getheader("Retry-After"))
    finally:
        conn.close()


def distributed_serving_phase(smi, reset_counts, read_counts,
                              continuous_adult_rps=None) -> dict:
    """Phase 39: ``DistributedServer`` on the card, its channels scorer
    threads sharing it.

    (a) ``DistributedServer("adult_channels", n_channels=4)`` serving the
    Adult fixture model through K2 (each channel on its
    ``device_for_channel``): 1,024 one-row requests from 16 clients, every
    reply 200 with its digest, the margins bitwise the fixture's ``raw``,
    K2 launched once a scored batch, K1 not, every channel scoring. (d)
    ``drain()`` on the same server while 64 requests are held in flight
    (the pipeline waits on a gate): every accepted one 200 and bitwise, a
    request after the drain gate 503 with ``Retry-After``, nothing parked
    after ``stop()``. (b) a fresh 4-channel server (``breaker_threshold=
    1``, ``probe_interval=0.25``) with ``compute.channel1`` failing its
    first 3 fires: 512 requests from 16 clients all 200 and bitwise, at
    least one trip and one failover, channel 1 OPEN, then CLOSED again by
    the half-open probe within 5 s of the last fire, the trip's
    flight-recorder dump written. (c) ResNet-50 224 through
    ``_model_pipeline``, warmed, shared by 2 channels: 64 one-image
    requests from 8 clients over ``entry()``'s 8 images, 200s with
    digests, equal images equal bytes, the logits within rtol = atol =
    1e-3 of the JAX fixture, no recompile during the load, one executor.
    Prints requests/s, p50/p99, the batches and rows of each channel, the
    devices, phase 29's ``ContinuousServer`` rate beside leg (a)'s (as
    context) and each leg's wall. Returns leg (a)'s launch counts."""
    import threading

    sys.path.insert(0, FIXTURES)
    import make_resnet50_fixture as resnet_fx
    from synapseml_tpu_torch.gbdt.estimators import (
        LightGBMClassificationModel)
    from synapseml_tpu_torch.io import serving
    from synapseml_tpu_torch.onnx import zoo
    from synapseml_tpu_torch.runtime import blackbox as bb
    from synapseml_tpu_torch.runtime import faults as flt

    walls = {}
    phase_start = time.perf_counter()
    model = LightGBMClassificationModel.load_native_model(FIXTURE)
    io = np.load(FIXTURE_IO)
    bodies = [json.dumps({"features": row.tolist()}).encode()
              for row in io["x"][:DIST_ADULT_REQUESTS]]

    # -- (a) the Adult model through K2 on 4 channels ----------------------
    start = time.perf_counter()
    scored, gate = [], threading.Event()
    gate.set()
    ds = serving.DistributedServer("adult_channels",
                                   n_channels=DIST_CHANNELS)
    try:
        ds.serve(adult_channel_pipeline(ds, model, scored, gate))
        port = ds.server.port
        devices = [str(ds.device_for_channel(c))
                   for c in range(DIST_CHANNELS)]
        reset_counts()
        t_load = time.perf_counter()
        adult = serve_bodies(port, bodies, SERVE_CLIENTS)
        adult_s = time.perf_counter() - t_load
        counts = read_counts()
        batches_a = list(scored)
        walls["a_adult_s"] = time.perf_counter() - start
        check(replies_ok(adult), "a channel-served Adult reply was not 200 "
                                 "with its digest")
        bitwise = margins_bitwise(adult, io["raw"])
        check(bitwise, "channel-served Adult margins differ from the "
                       "fixture's raw")
        check(counts["forest_traverse"] == len(batches_a)
              and counts["histogram"] == 0,
              f"leg (a) launched {counts} for {len(batches_a)} batches")
        per_channel = by_channel(batches_a, DIST_CHANNELS)
        check(all(b > 0 for b in per_channel["batches"]),
              f"a channel scored no batch: {per_channel}")
        check(sum(per_channel["rows"]) == DIST_ADULT_REQUESTS,
              f"rows scored {per_channel}")

        # -- (d) drain with requests held in flight -----------------------
        start = time.perf_counter()
        gate.clear()
        scored.clear()
        reset_counts()
        held = [None] * DIST_DRAIN_REQUESTS
        errors = []

        def client(i):
            try:
                held[i] = one_request(port, bodies[i])
            except Exception as e:  # noqa: BLE001 - reported by a check
                errors.append(repr(e))

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(DIST_DRAIN_REQUESTS)]
        for t in clients:
            t.start()

        def routed() -> int:
            with ds.server._lock:
                return len(ds.server.routing)

        wait_until(lambda: routed() == DIST_DRAIN_REQUESTS,
                   "the drain leg's requests admitted")
        drained = {}
        drainer = threading.Thread(target=lambda: drained.setdefault(
            "ok", ds.drain(timeout_ms=DIST_WAIT_S * 1e3)))
        drainer.start()
        wait_until(lambda: ds.server.draining, "the drain gate")
        in_flight = routed()
        late = one_request(port, bodies[0])
        gate.set()
        drainer.join(DIST_WAIT_S)
        for t in clients:
            t.join(DIST_WAIT_S)
        counts_d = read_counts()
        walls["d_drain_s"] = time.perf_counter() - start
        check(not errors and not drainer.is_alive()
              and not any(t.is_alive() for t in clients),
              f"drain leg clients: {errors[:3]}")
        check(drained.get("ok") is True, "drain() did not converge")
        check(replies_ok(held) and margins_bitwise(held, io["raw"]),
              "an accepted request was not answered 200 bitwise in drain")
        check(late[0] == 503 and late[3] is not None,
              f"a request after the drain gate got {late[0]}, "
              f"Retry-After {late[3]}")
        check(counts_d["forest_traverse"] == len(scored)
              and counts_d["histogram"] == 0,
              f"drain leg launched {counts_d} for {len(scored)} batches")
    finally:
        gate.set()
        ds.stop()
    parked = (len(ds.server.routing) + sum(ds.channels.depths())
              + ds.server.requests.qsize())
    check(parked == 0, f"{parked} requests left parked after stop()")
    emit({"phase": "distributed_serving_adult_k2",
          "server": "DistributedServer('adult_channels', n_channels=4)",
          "requests": DIST_ADULT_REQUESTS, "clients": SERVE_CLIENTS,
          "devices_by_channel": devices,
          "all_200_with_digest": True, "margins_bitwise_fixture": bitwise,
          "launches": counts, "batches_scored": len(batches_a),
          "by_channel": per_channel,
          "transform": transform_times(batches_a, adult_s),
          "requests_per_s": DIST_ADULT_REQUESTS / adult_s,
          "latency": latency_ms([r[3] for r in adult]),
          "continuous_server_requests_per_s_phase_29": continuous_adult_rps,
          "drain": {"held_in_flight": in_flight, "drained": True,
                    "accepted_all_200_bitwise": True,
                    "late_status": late[0], "late_retry_after": late[3],
                    "launches": counts_d, "batches": len(scored),
                    "parked_after_stop": parked},
          "walls_s": dict(walls), "nvidia_smi": smi})

    # -- (b) chaos: compute.channel1 fails, the breaker and its probe ------
    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    scored_b = []
    prev_dump_dir = bb.dump_dir()
    bb.set_dump_dir(os.path.join(tmp, "flight"))
    ds = serving.DistributedServer(
        "adult_chaos", n_channels=DIST_CHANNELS, breaker_threshold=1,
        probe_interval=DIST_PROBE_S)
    try:
        ds.serve(adult_channel_pipeline(ds, model, scored_b))
        port = ds.server.port
        marks, watching = {}, threading.Event()

        def watch():
            """Timestamps, 2 ms apart: channel 1 first not CLOSED, its
            last fire spent, and CLOSED again after it."""
            while not watching.is_set():
                now = time.perf_counter()
                closed = ds.channel_state(1) == serving.BREAKER_CLOSED
                if not closed:
                    marks.setdefault("opened", now)
                if "spent" not in marks and flt.active()[
                        "compute.channel1"]["remaining"] == 0:
                    marks["spent"] = now
                elif "spent" in marks and closed:
                    marks["closed"] = now
                    return
                time.sleep(0.002)

        reset_counts()
        flt.activate("compute.channel1", times=DIST_CHAOS_FIRES)
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t_load = time.perf_counter()
        chaos = serve_bodies(port, bodies[:DIST_CHAOS_REQUESTS],
                             SERVE_CLIENTS)
        chaos_s = time.perf_counter() - t_load
        watcher.join(DIST_WAIT_S)
        watching.set()
        check("closed" in marks, f"channel 1 never re-admitted: {marks}")
        readmit_s = marks["closed"] - marks["spent"]
        check(readmit_s <= READMIT_LIMIT_S,
              f"channel 1 re-admitted {readmit_s} s after its last fire")
        counts_b = read_counts()
        metrics = entry_metrics(port)
        walls["b_chaos_s"] = time.perf_counter() - start
    finally:
        flt.deactivate("compute.channel1")
        ds.stop()
        dump = bb.last_dump_path()
        bb.set_dump_dir(prev_dump_dir)
    srv = {"server": "adult_chaos"}
    chaos_counters = {
        name: prom_total(metrics, f"synapseml_serving_{name}", **srv)
        for name in ("failover_total", "channel_trips_total",
                     "redispersed_total")}
    probes = {o: prom_total(metrics, "synapseml_serving_channel_probe_total",
                            outcome=o, **srv) for o in ("ok", "fail")}
    transitions = {st: prom_total(
        metrics, "synapseml_serving_breaker_transitions_total", channel="1",
        state=st, **srv) for st in ("open", "half_open", "closed")}
    check(replies_ok(chaos), "a chaos-leg reply was not 200 with its digest")
    chaos_bitwise = margins_bitwise(chaos, io["raw"])
    check(chaos_bitwise, "chaos-leg margins differ from the fixture's raw")
    check(chaos_counters["channel_trips_total"] >= 1
          and chaos_counters["failover_total"] >= 1,
          f"chaos leg: {chaos_counters}")
    check(transitions["open"] >= 1 and "opened" in marks,
          f"channel 1 never OPEN: {transitions}")
    check(dump is not None and dump.startswith(tmp),
          f"the trip wrote no flight-recorder dump ({dump})")
    check(counts_b["forest_traverse"] == len(scored_b)
          and counts_b["histogram"] == 0,
          f"chaos leg launched {counts_b} for {len(scored_b)} batches")
    emit({"phase": "distributed_serving_chaos",
          "server": "DistributedServer('adult_chaos', n_channels=4, "
                    "breaker_threshold=1, probe_interval=0.25)",
          "fault": f"compute.channel1 x {DIST_CHAOS_FIRES}",
          "requests": DIST_CHAOS_REQUESTS, "clients": SERVE_CLIENTS,
          "all_200_with_digest": True,
          "margins_bitwise_fixture": chaos_bitwise,
          **chaos_counters, "probe_outcomes": probes,
          "channel1_transitions": transitions,
          "readmit_s_after_last_fire": readmit_s,
          "readmit_limit_s": READMIT_LIMIT_S,
          "flight_dump": dump, "launches": counts_b,
          "batches_scored": len(scored_b),
          "canary_batches": sum(1 for c, _, _ in scored_b if c is None),
          "by_channel": by_channel(scored_b, DIST_CHANNELS),
          "transform": transform_times(scored_b, chaos_s),
          "requests_per_s": DIST_CHAOS_REQUESTS / chaos_s,
          "latency": latency_ms([r[3] for r in chaos]),
          "walls_s": dict(walls), "nvidia_smi": smi})

    # -- (c) ResNet-50 224 on 2 channels sharing one warm model -------------
    start = time.perf_counter()
    path = os.path.join(tmp, "resnet50_224.onnx")
    with open(path, "wb") as fh:
        fh.write(zoo.resnet50(num_classes=1000, image_size=SERVE_IMAGE,
                              seed=0))
    distinct = [json.dumps({"features": im.tolist()}).encode()
                for im in resnet_fx.images()]
    pipeline, rmodel = serving._model_pipeline(path)
    ds = None
    try:
        t_warm = time.perf_counter()
        report = rmodel.warmup()
        walls["c_warmup_s"] = time.perf_counter() - t_warm
        ds = serving.DistributedServer("resnet50_channels",
                                       n_channels=DIST_RESNET_CHANNELS)
        ds.serve(pipeline)
        port = ds.server.port
        recompiles_before = prom_total(
            entry_metrics(port), "synapseml_executor_recompiles_total")
        reset_counts()
        t_load = time.perf_counter()
        load = serve_bodies(port, [distinct[i % len(distinct)]
                                   for i in range(DIST_RESNET_REQUESTS)],
                            DIST_RESNET_CLIENTS)
        resnet_s = time.perf_counter() - t_load
        counts_c = read_counts()
        recompiles = prom_total(entry_metrics(port),
                                "synapseml_executor_recompiles_total"
                                ) - recompiles_before
        executors = len(rmodel._executor_cache)
    finally:
        if ds is not None:
            ds.stop()
        close_models(rmodel)
        shutil.rmtree(tmp, ignore_errors=True)
    walls["c_resnet50_s"] = time.perf_counter() - start
    check(not report.errors and report.compiled == len(report.entries) > 0,
          f"ResNet-50 warmup: {report}")
    check(replies_ok(load), "a channel-served ResNet-50 reply was not 200 "
                            "with its digest")
    same = all(load[i][1] == load[i % len(distinct)][1]
               for i in range(DIST_RESNET_REQUESTS))
    check(same, "equal images got different reply bytes")
    fx = np.load(RESNET_FIXTURE)
    got = np.asarray([json.loads(load[i][1])["output"]
                      for i in range(len(distinct))], np.float32)
    f32_err = float(np.abs(got - fx["logits_f32"]).max())
    check(bool(np.allclose(got, fx["logits_f32"], rtol=LOGITS_TOL,
                           atol=LOGITS_TOL)),
          f"channel-served logits {f32_err} from the JAX fixture")
    check(recompiles == 0, f"{recompiles} recompiles during the load")
    check(executors == 1, f"{executors} executors for one shared model")
    check(counts_c["forest_traverse"] == 0 and counts_c["histogram"] == 0,
          f"the ResNet-50 leg launched {counts_c}")
    walls["phase_s"] = time.perf_counter() - phase_start
    emit({"phase": "distributed_serving_resnet50",
          "server": "DistributedServer('resnet50_channels', n_channels=2)",
          "model": "zoo.resnet50 seed 0, 224x224, 1,000 classes, float32, "
                   "one warm ONNXModel shared by the channels",
          "warmup": str(report), "requests": DIST_RESNET_REQUESTS,
          "clients": DIST_RESNET_CLIENTS, "distinct_images": len(distinct),
          "all_200_with_digest": True, "equal_images_equal_bytes": same,
          "logits_max_abs_err_vs_jax": f32_err, "logits_tol": LOGITS_TOL,
          "recompiles_during_load": recompiles, "executors": executors,
          "launches": counts_c,
          "requests_per_s": DIST_RESNET_REQUESTS / resnet_s,
          "latency": latency_ms([r[3] for r in load]),
          "walls_s": dict(walls), "nvidia_smi": smi})
    return counts


# -- 40. devices= data parallelism: slots sharing the one card ---------------
DP_IMAGES = 512               # ResNet-50 images a layout (4 buckets of 128)
DP_LAYOUTS = (("none", None), ("int_1", 1), ("all", "all"),
              ("shard_2", ["cuda:0"] * 2), ("rr_3", ["cuda:0"] * 3))
DP_FEATURE_IMAGES = 128       # ImageFeaturizer images over two slots
DP_FEATURE_TOL = 1e-3         # features against the one-slot featurizer
DP_SHARD_GAP_TOL = 1e-2       # sharded logits against one slot, all rows
DP_DECODE_SEQS, DP_DECODE_NEW = 8, 32
DP_EXIT_TIMEOUT_S = 120       # the --devices 9 child's exit


def dispatch_series(tm) -> dict:
    """``{device label: count}`` of ``executor_dispatch_total``."""
    return {labels["device"]: m.value
            for labels, m in tm.series("executor_dispatch_total")}


def dp_layouts_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 40: ``devices=`` data parallelism, its slots sharing the one
    card (each slot its own streams, warm graphs, static buffers and graph
    pool). No figure here is a scaling figure: every slot runs on the same
    H100, and each is printed beside the one-slot figure.

    1. ResNet-50 224 (``zoo.resnet50`` seed 0, float32) through a warm
       ``ONNXModel(mini_batch_size=128)`` on 512 images (rows 0-7
       ``entry()``'s) under ``devices=None``, ``1`` and ``"all"`` (each
       the pinned path, one slot), ``["cuda:0"] * 2`` (sharded: two 64-row
       graphs a bucket of 128) and ``["cuda:0"] * 3`` (round robin, as 128
       % 3 != 0): every target ``compiled``, warm graphs = slots x 5
       buckets; the round-robin and one-slot logits bitwise the
       ``devices=None`` model's; the sharded logits' rows 0-7 within
       rtol=atol=1e-3 of the JAX fixture, and all 512 rows within 1e-2
       of one slot's (not bitwise: cuBLAS and cuDNN pick kernels by the
       batch), the gap printed; the dispatch
       counters' deltas sum to the batches, AOT hits equal them, 0
       recompiles after warmup, 0 copies between devices. Images/s (median
       of 3 after a warm call), warmup seconds and memory reserved a slot,
       the card's busy share (union of kernel intervals) in one transform.
    2. ``ImageFeaturizer(cut_output_layers=1, devices=["cuda:0"] * 2)``
       over the same network on 128 images of 224 x 224: features bitwise
       or within 1e-3 of the one-slot featurizer's, the gap printed.
    3. ``DecodeScheduler(devices=["cuda:0"] * 2)`` over phase 23's wide
       decoder at phase 32's geometry (``max_batch=8``: sharded, 4 rows a
       slot), warmed (10 signatures, 20 graphs): 8 sequences of
       ``decode_work`` with 32 new tokens, the ids equal to the one-slot
       scheduler's but at counted near-ties (``greedy_check``), 0
       recompiles, 0 KV copies between devices.
    4. The serving entry with ``--devices 1 --warmup auto``: 8 one-image
       requests from one client, each reply's digest the ``devices=None``
       model's for the same image; ``--devices 9`` exits 2 with the
       reference's message shape.
    K1 and K2 launch 0 times. Returns the launch counts."""
    import make_resnet50_fixture as resnet_fx
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.image.featurizer import ImageFeaturizer
    from synapseml_tpu_torch.io import serving
    from synapseml_tpu_torch.onnx import ONNXModel, import_model, zoo
    from synapseml_tpu_torch.runtime import telemetry as tm
    from synapseml_tpu_torch.runtime.decode import DecodeScheduler

    reset_counts()
    phase_start = time.perf_counter()
    walls = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    blob = zoo.resnet50(num_classes=1000)
    path = os.path.join(tmp, "resnet50_224.onnx")
    with open(path, "wb") as fh:
        fh.write(blob)
    # the refused spec's child boots while the layouts run
    bad = subprocess.Popen(
        [sys.executable, "-m", "synapseml_tpu_torch.io.serving", "--port",
         "0", "--model", path, "--devices", "9"], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    moved = tm.counter("executor_cross_device_copies_total")
    moved0 = moved.value
    x = np.empty((DP_IMAGES, 3, 224, 224), np.float32)
    x[:8] = resnet_fx.images()
    x[8:] = np.random.default_rng(3).standard_normal(
        (DP_IMAGES - 8, 3, 224, 224), dtype=np.float32)
    table = Table({"data": x})
    batches = DP_IMAGES // MODEL_BATCH
    layouts, logits = {}, {}
    one_slot = None
    try:
        # -- 1. ResNet-50 under each layout ---------------------------------
        for name, spec in DP_LAYOUTS:
            start = time.perf_counter()
            model = ONNXModel(model_bytes=blob, mini_batch_size=MODEL_BATCH,
                              devices=spec)
            ex = model._executor("cuda")
            out_name = model.graph.output_names[0]
            slots = ex.n_devices
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            rep = model.warmup()
            warm_s = time.perf_counter() - t0
            reserved = torch.cuda.memory_reserved() - reserved0
            rec0 = sum(recompiles(tm).values())
            disp0 = dispatch_series(tm)
            hits0 = ex._aot_hits
            wall, out = wall_median(lambda: model.transform(table))
            busy = copy_overlap(lambda: model.transform(table))
            disp = {k: v - disp0.get(k, 0.0)
                    for k, v in dispatch_series(tm).items()
                    if v - disp0.get(k, 0.0)}
            rec = sum(recompiles(tm).values()) - rec0
            logits[name] = np.asarray(out[out_name])
            layouts[name] = {
                "devices": spec, "slots": slots,
                "pinned_one_device": ex.devices is None,
                "layout_by_bucket": {b: ex._layout(b) for b in WARM_BUCKETS},
                "warmup": str(rep), "warmup_s": warm_s,
                "warm_graphs": len(ex._aot),
                "reserved_by_warmup_bytes": reserved,
                "reserved_a_slot_bytes": reserved / slots,
                "images_per_s": DP_IMAGES / wall, "wall_s": wall,
                "dispatch_deltas": disp,
                "aot_hits": ex._aot_hits - hits0,
                "recompiles_after_warmup": rec, "timeline": busy,
                "seconds": time.perf_counter() - start}
            check(not rep.errors and rep.compiled == len(rep.entries),
                  f"{name}: warmup {rep} {rep.errors[:2]}")
            check(len(ex._aot) == slots * len(WARM_BUCKETS),
                  f"{name}: {len(ex._aot)} warm graphs for {slots} slots")
            want_slots = (torch.cuda.device_count() if spec == "all"
                          else 1 if spec in (None, 1) else len(spec))
            check(slots == want_slots and (slots > 1) == (
                ex.devices is not None), f"{name}: {slots} slots")
            calls = 5  # wall_median's warm call and 3, copy_overlap's 1
            check(sum(disp.values()) == calls * batches
                  and ex._aot_hits - hits0 == calls * batches,
                  f"{name}: dispatches {disp}, hits "
                  f"{ex._aot_hits - hits0} for {calls * batches} batches")
            check(rec == 0, f"{name}: {rec} recompiles after warmup")
            if name == "none":
                one_slot = model
            else:
                close_models(model)
        walls["resnet50_s"] = time.perf_counter() - phase_start
        base = logits["none"]
        gaps = {name: float(np.abs(v - base).max())
                for name, v in logits.items()}
        bitwise = {name: bool(np.array_equal(v, base))
                   for name, v in logits.items()}
        fx = np.load(RESNET_FIXTURE)
        fixture_err = {name: float(np.abs(v[:8] - fx["logits_f32"]).max())
                       for name, v in logits.items()}
        check(all(bitwise[n] for n in ("int_1", "all", "rr_3")),
              f"one-slot and round-robin logits not bitwise: {bitwise}")
        check(bool(np.allclose(logits["shard_2"][:8], fx["logits_f32"],
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)),
              f"sharded logits {fixture_err['shard_2']} from the fixture")
        check(np.isfinite(logits["shard_2"]).all()
              and logits["shard_2"].shape == (DP_IMAGES, 1000),
              "sharded logits not finite or misshapen")
        # every row, so a fault of slot 1's half (rows 64-127 of each
        # bucket) fails too; one slot's |logit| is printed for scale
        check(gaps["shard_2"] <= DP_SHARD_GAP_TOL,
              f"sharded logits {gaps['shard_2']} from one slot's")
        rate0 = layouts["none"]["images_per_s"]
        emit({"phase": "dp_layouts", "part": "resnet50_onnx_model",
              "model": "zoo.resnet50 seed 0, 224x224, 1,000 classes, "
                       "float32, ONNXModel(mini_batch_size=128) warmed",
              "images": DP_IMAGES, "layouts": layouts,
              "logits_bitwise_one_slot": bitwise,
              "logits_max_abs_gap_one_slot": gaps,
              "shard_gap_tol": DP_SHARD_GAP_TOL,
              "one_slot_max_abs_logit": float(np.abs(base).max()),
              "rows0_7_max_abs_err_vs_jax": fixture_err,
              "logits_tol": LOGITS_TOL,
              "images_per_s_over_one_slot": {
                  n: v["images_per_s"] / rate0 for n, v in layouts.items()},
              "note": "slots share one H100: not a scaling figure",
              "nvidia_smi": smi})

        # -- 2. ImageFeaturizer over two slots -----------------------------
        start = time.perf_counter()
        rng = np.random.default_rng(4)
        imgs = np.empty(DP_FEATURE_IMAGES, dtype=object)
        imgs[:] = [rng.integers(0, 256, (224, 224, 3)).astype(np.float32)
                   for _ in range(DP_FEATURE_IMAGES)]
        kw = dict(model_bytes=blob, cut_output_layers=1, image_size=224,
                  input_col="image", output_col="feats")
        feats = {}
        for name, spec in (("one_slot", None), ("two_slots",
                                                ["cuda:0"] * 2)):
            feat = ImageFeaturizer(devices=spec, **kw)
            feat.transform(Table({"image": imgs[:8]}))
            t0 = time.perf_counter()
            feats[name] = np.stack(list(feat.transform(
                Table({"image": imgs}))["feats"]))
            feats[name + "_images_per_s"] = DP_FEATURE_IMAGES / (
                time.perf_counter() - t0)
            feats[name + "_slots"] = feat._pieces("cuda").n_devices
            feat._pieces("cuda").close()
        a, b = feats.pop("one_slot"), feats.pop("two_slots")
        feat_gap = float(np.abs(a - b).max())
        feat_ok = bool(np.array_equal(a, b) or np.allclose(
            b, a, rtol=DP_FEATURE_TOL, atol=DP_FEATURE_TOL))
        check(feat_ok and feats["two_slots_slots"] == 2
              and b.shape == a.shape and np.isfinite(b).all(),
              f"two-slot features {feat_gap} from one slot's")
        walls["featurizer_s"] = time.perf_counter() - start
        emit({"phase": "dp_layouts", "part": "image_featurizer",
              "featurizer": "ImageFeaturizer(cut_output_layers=1, "
                            "devices=['cuda:0'] * 2), mini_batch_size 64",
              "images": DP_FEATURE_IMAGES, "shape": list(b.shape),
              "bitwise_one_slot": bool(np.array_equal(a, b)),
              "max_abs_gap_one_slot": feat_gap,
              "largest_abs_feature": float(np.abs(a).max()),
              "tolerance": DP_FEATURE_TOL, **feats, "nvidia_smi": smi})

        # -- 3. DecodeScheduler over two slots ------------------------------
        start = time.perf_counter()
        graph = import_model(zoo.tiny_decoder(**DECODER_WIDE))
        work = decode_work(DP_DECODE_SEQS, DECODER_WIDE["vocab"], seed=6,
                           new=DP_DECODE_NEW)
        one = DecodeScheduler(graph, name="dp_decode_one",
                              **DECODE_GEOMETRY)
        try:
            one.start()
            one_run = run_decode(one, work)
        finally:
            one.close()
        two = DecodeScheduler(graph, name="dp_decode_two",
                              devices=["cuda:0"] * 2, **DECODE_GEOMETRY)
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            rep = two.warmup()
            decode_warm_s = time.perf_counter() - t0
            decode_reserved = torch.cuda.memory_reserved() - reserved0
            statuses = [e for sig in rep["signatures"]
                        for e in sig["entries"]]
            rec0 = sum(recompiles(tm).values())
            moved1 = moved.value
            two.start()
            two_run = run_decode(two, work)
            decode_rec = sum(recompiles(tm).values()) - rec0
            kv_moves = moved.value - moved1
            layout, graphs = two._ex._layout(two.B), len(two._ex._aot)
            greedy = greedy_check(two._fn, work, two_run["streams"],
                                  len(two._kv_names), two.kv_heads,
                                  two.head_dim, DECODE_GEOMETRY["max_seq"])
        finally:
            two.close()
        ties = greedy.pop("ties")
        vs_one = diverge_at_ties(two_run["streams"], one_run["streams"],
                                 ties)
        check(layout == "shard" and graphs == 20
              and statuses == ["compiled"] * 10,
              f"two-slot decode warmup: {layout}, {graphs} graphs, "
              f"{statuses}")
        check(not vs_one["differ_elsewhere"] and greedy["mismatches"] == 0,
              f"two-slot ids against one slot's: {vs_one}, "
              f"{greedy['first_mismatches']}")
        check(decode_rec == 0 and kv_moves == 0,
              f"two-slot decode: {decode_rec} recompiles, {kv_moves} "
              "copies between devices")
        walls["decode_s"] = time.perf_counter() - start
        for run in (one_run, two_run):
            run.pop("streams")
        emit({"phase": "dp_layouts", "part": "decode_two_slots",
              "decoder": "zoo.tiny_decoder at BERT-base width (phase 23)",
              "geometry": DECODE_GEOMETRY, "devices": ["cuda:0"] * 2,
              "layout": layout, "warm_graphs": graphs,
              "warmup_s": decode_warm_s,
              "reserved_by_warmup_bytes": decode_reserved,
              "sequences": DP_DECODE_SEQS, "new_tokens": DP_DECODE_NEW,
              "vs_one_slot": vs_one, "greedy": greedy,
              "recompiles_after_warmup": decode_rec,
              "kv_copies_between_devices": kv_moves,
              "one_slot_eager": one_run, "two_slots_warm": two_run,
              "note": "slots share one H100: not a scaling figure",
              "nvidia_smi": smi})

        # -- 4. the serving entry with --devices ----------------------------
        start = time.perf_counter()
        out_name = one_slot.graph.output_names[0]
        bodies, digests = [], []
        for im in resnet_fx.images():
            bodies.append(json.dumps({"features": im.tolist()}).encode())
            row = np.asarray(one_slot.transform(
                Table({"data": im[None]}))[out_name])[0]
            digests.append(hashlib.sha256(serving.make_reply(
                {"output": row.tolist()}).entity).hexdigest())
        entry = launch_entry(path, "dp_devices_1", tmp,
                             mode=("--warmup", "auto", "--devices", "1"))
        try:
            announce = [ln for ln in entry["lines"]
                        if ln.startswith("serving [")]
            replies = serve_bodies(entry["port"], bodies, 1)
        except BaseException:
            kill_entry(entry)
            raise
        stopped = stop_entry(entry, len(bodies))
        try:
            bad_out, _ = bad.communicate(timeout=DP_EXIT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            bad.kill()
            bad_out, _ = bad.communicate()
        check(replies_ok(replies)
              and [r[2] for r in replies] == digests,
              "--devices 1 replies differ from the one-slot model's")
        check(bool(announce) and "devices=1" in announce[0],
              f"--devices 1 not announced: {announce}")
        check(bad.returncode == 2
              and "error: --devices '9': devices=9 but" in bad_out,
              f"--devices 9 exited {bad.returncode}: {bad_out[-400:]}")
        walls["serving_s"] = time.perf_counter() - start
        emit({"phase": "dp_layouts", "part": "serving_devices",
              "entry": "python -m synapseml_tpu_torch.io.serving --model "
                       "<resnet50 224> --warmup auto --devices 1",
              "announce": announce[0], "warmup": entry["warmup"],
              "announce_s": entry["announce_s"],
              "requests": len(bodies), "digests_equal_one_slot": True,
              **stopped, "devices_9_exit_code": bad.returncode,
              "devices_9_said": bad_out.strip()[-200:],
              "nvidia_smi": smi})
    finally:
        if bad.poll() is None:
            bad.kill()
            bad.communicate()
        if one_slot is not None:
            close_models(one_slot)
        shutil.rmtree(tmp, ignore_errors=True)
    counts = read_counts()
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"the data-parallel path launched {counts}")
    check(moved.value == moved0,
          f"{moved.value - moved0} copies between devices on one card")
    walls["phase_s"] = time.perf_counter() - phase_start
    emit({"phase": "dp_layouts", "part": "summary", "launches": counts,
          "walls_s": walls, "nvidia_smi": smi})
    return counts


QUANT_IMAGES = 512            # QOperator ResNet-50 images (4 buckets of 128)
QUANT_CPU_IMAGES = 8          # the port's CPU run the card is held to, bitwise
QUANT_FFN_CPU_TOL = 1e-2      # the FFN block's output vs the CPU's, of its largest |value|
QUANT_LANES = ("onnx_int8_conv", "onnx_int8_matmul")


def probe_seconds(tm, lanes) -> dict:
    """``{lane: (probes, seconds)}`` of ``autotune_probe_seconds``."""
    return {ln: (tm.histogram("autotune_probe_seconds", lane=ln).count,
                 tm.histogram("autotune_probe_seconds", lane=ln).sum)
            for ln in lanes}


def quant_probes(quant_route, autotune) -> dict:
    """The int8 lanes' probes: every record (parts, exact, seconds,
    verdict), and whether each lane's served decisions are its probes'
    verdicts (a poisoned class serves "dequant" after an "int8" verdict)
    and every probe left a record (a crashed probe leaves none)."""
    recs = list(quant_route.PROBES)
    verdicts = {(r["kind"], "|".join(str(p) for p in r["parts"])):
                r["verdict"] for r in recs}
    poisoned, unprobed = [], []
    for kind, lane in (("conv", quant_route._CONV_LANE),
                       ("matmul", quant_route._MM_LANE)):
        for key, choice in lane.decisions.items():
            parts = key.split(f"|{kind}|", 1)[1]
            want = verdicts.get((kind, parts))
            if want is None:
                unprobed.append(parts[:120])
            elif want != choice:
                poisoned.append(parts[:120])
    probes = sum(autotune.lane(n).probes for n in QUANT_LANES)
    return {"probes": probes, "records": len(recs),
            "all_exact": all(r["exact"] for r in recs),
            "int8_verdicts": sum(r["verdict"] == "int8" for r in recs),
            "dequant_verdicts": sum(r["verdict"] == "dequant" for r in recs),
            "poisoned": poisoned, "without_probe": unprobed,
            "classes": [{"kind": r["kind"], "parts": "|".join(
                str(p) for p in r["parts"][:-1]), "verdict": r["verdict"],
                "exact": r["exact"], "int8_ms": None if r["int8_s"] is None
                else r["int8_s"] * 1e3, "dequant_ms": None
                if r["dequant_s"] is None else r["dequant_s"] * 1e3}
                for r in recs]}


def quantized_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 41: the int8 QOperator ops and the measured lanes on the
    card, from cold verdict tables (``SYNAPSEML_TPU_CACHE_DIR`` a fresh
    directory, every lane's memo cleared).

    (a) The statically quantized ResNet-50 224
    (``tests/fixtures/qresnet50.py``: ``zoo.resnet50`` seed 0, BatchNorm
    folded, MinMax-calibrated, the zoo int8 model's QOperator layout) at
    the fixture's stored calibration: its bytes are the JAX fixture's graph
    (sha256); the fixture's 2 images through ``bind()`` on the card give
    the fixture's stem accumulator (sha256) and uint8 logits; a warm
    ``ONNXModel(mini_batch_size=128)`` on 512 images (rows 0-7
    ``entry()``'s) under the measured verdicts: uint8 logits bitwise the
    port's CPU run on rows 0-7, the JAX eager fixture on rows 0-1 (its
    jitted forward within one step, the differing count printed), and the
    same model warmed under ``SYNAPSEML_ONNX_INT8=0`` on every row; every
    probed int8 class verified exact, none poisoned, none memoized as a
    crash, the int8 route counter above 0, each model's warmup all
    ``compiled``, 0 recompiles. Images/s of the two models in turn (A B A
    B after a warm call each), probe seconds, memory reserved by each
    warmup, the busy share of one transform.
    (b) BERT-base's FFN block dynamically quantized
    (``tests/fixtures/bert_ffn_int8.py``), 1,024 tokens, two host inputs,
    through a warm ``ONNXModel(mini_batch_size=1024)`` (warmup probes
    ``executor_h2d``): its outputs under the ``per_arg`` and ``coalesced``
    stagings bitwise each other; on ``bind()`` with the stages exposed,
    the first ``DynamicQuantizeLinear``'s (y, scale, zp) and the first
    accumulator bitwise the CPU's, the second's and the second accumulator
    bitwise the CPU's ops on the card's GELU output; the block's output
    within 1e-2 of the CPU's largest |value| (GELU's erf and
    LayerNorm's reductions round differently on the card; the gap and
    bitwise-ness printed). Tokens/s, the H2D and matmul verdicts.
    (c) Float ResNet-50 224 (seed 0) at batch 128 under
    ``compute_dtype="auto"``: the lane's verdict, rows 0-7 within its
    dtype's gate of the JAX fixture (float32 rtol = atol = 1e-3, bf16 5%
    of the largest |logit|); ``preferred_wire("data")`` under the
    phases' ImageNet ``input_norm``.
    (d) Every case of ``tests/fixtures/quant_op_cases.py`` on the card,
    bitwise the CPU.
    K1 and K2 launch 0 times. Returns the launch counts."""
    import bert_ffn_int8 as ffn
    import make_resnet50_fixture as resnet_fx
    import qresnet50 as qr
    import quant_op_cases
    from synapseml_tpu_torch.data.table import Table
    from synapseml_tpu_torch.onnx import (GraphBuilder, ONNXModel,
                                          import_model, importer,
                                          quant_route, zoo)
    from synapseml_tpu_torch.onnx import model as model_mod
    from synapseml_tpu_torch.runtime import autotune
    from synapseml_tpu_torch.runtime import executor as ex_mod
    from synapseml_tpu_torch.runtime import telemetry as tm

    reset_counts()
    phase_start = time.perf_counter()
    walls = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_quant_")
    env_keys = ("SYNAPSEML_TPU_CACHE_DIR", "SYNAPSEML_ONNX_INT8",
                "SYNAPSEML_AUTOTUNE")
    saved = {k: os.environ.get(k) for k in env_keys}
    os.environ["SYNAPSEML_TPU_CACHE_DIR"] = tmp
    os.environ.pop("SYNAPSEML_ONNX_INT8", None)
    os.environ.pop("SYNAPSEML_AUTOTUNE", None)
    autotune.clear()
    quant_route.clear_cache()
    int8_served = tm.counter("onnx_int8_route_total", backend="int8")
    int8_0 = int8_served.value
    probes0 = probe_seconds(tm, QUANT_LANES)
    models = []
    try:
        # -- (a) the QOperator ResNet-50 ----------------------------------
        start = time.perf_counter()
        calibrated = qr.stored_ranges()
        blob = qr.graph(GraphBuilder, qr.FULL, calibrated=calibrated)
        blob_acc = qr.graph(GraphBuilder, qr.FULL, accumulator=True,
                            calibrated=calibrated)
        fx = np.load(qr.OUT)
        check(hashlib.sha256(blob_acc).hexdigest() == str(fx["graph_sha256"]),
              "the rebuilt quantized ResNet-50 is not the fixture's graph")
        x = np.empty((QUANT_IMAGES, 3, 224, 224), np.float32)
        x[:8] = resnet_fx.images()
        x[8:] = np.random.default_rng(3).standard_normal(
            (QUANT_IMAGES - 8, 3, 224, 224), dtype=np.float32)
        table = Table({"data": x})
        cpu_q = import_model(blob).bind(device="cpu")(
            torch.from_numpy(x[:QUANT_CPU_IMAGES]))[1].numpy()
        walls["cpu_8_images_s"] = time.perf_counter() - start
        fwd = import_model(blob_acc).bind(device="cuda")
        _, bind_q, stem_acc = (o.cpu().numpy() for o in fwd(
            torch.from_numpy(x[:2]).cuda()))
        del fwd
        stem_ok = (hashlib.sha256(stem_acc.tobytes()).hexdigest()
                   == str(fx["stem_acc_sha256"]))
        check(stem_ok and np.array_equal(
            stem_acc.astype(np.int64).sum(axis=(2, 3)),
            fx["stem_acc_channel_sums"]),
            "the stem's int32 accumulator is not the JAX fixture's")
        check(np.array_equal(bind_q, fx["logits_q"]),
              "bind() uint8 logits are not the JAX fixture's")

        def warm(int8_off):
            if int8_off:
                os.environ["SYNAPSEML_ONNX_INT8"] = "0"
            try:
                m = ONNXModel(model_bytes=blob, mini_batch_size=MODEL_BATCH)
                models.append(m)
                m._executor("cuda")
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                r0 = torch.cuda.memory_reserved()
                t0 = time.perf_counter()
                rep = m.warmup()
                return m, rep, {"warmup_s": time.perf_counter() - t0,
                                "reserved_by_warmup_bytes":
                                torch.cuda.memory_reserved() - r0}
            finally:
                os.environ.pop("SYNAPSEML_ONNX_INT8", None)

        routed, rep_r, info_r = warm(False)
        widened, rep_w, info_w = warm(True)
        lanes_a = quant_probes(quant_route, autotune)
        for name, rep in (("routed", rep_r), ("int8_off", rep_w)):
            check(not rep.errors and rep.compiled == len(rep.entries) == 5,
                  f"quantized ResNet-50 {name} warmup {rep} {rep.errors[:2]}")
        rec0 = sum(recompiles(tm).values())

        def scored(m, int8_off):
            if int8_off:
                os.environ["SYNAPSEML_ONNX_INT8"] = "0"
            try:
                t0 = time.perf_counter()
                out = m.transform(table)
                return time.perf_counter() - t0, out
            finally:
                os.environ.pop("SYNAPSEML_ONNX_INT8", None)

        scored(routed, False)
        scored(widened, True)
        turns = []
        for m, off in ((routed, False), (widened, True), (routed, False),
                       (widened, True)):
            wall, out = scored(m, off)
            turns.append({"int8_off": off, "wall_s": wall,
                          "images_per_s": QUANT_IMAGES / wall})
            if off:
                q_widened = np.asarray(out["logits_q"])
            else:
                q_routed = np.asarray(out["logits_q"])
        busy = copy_overlap(lambda: routed.transform(table))
        rec = sum(recompiles(tm).values()) - rec0
        jit_gap = np.abs(q_routed[:2].astype(int) - fx["logits_q_jit"])
        int8_n = int8_served.value - int8_0
        check(np.array_equal(q_routed[:QUANT_CPU_IMAGES], cpu_q),
              "quantized logits rows 0-7 not bitwise the port's CPU run")
        check(np.array_equal(q_routed[:2], fx["logits_q"]),
              "quantized logits rows 0-1 not bitwise the JAX fixture")
        check(int(jit_gap.max()) <= 1,
              f"quantized logits {int(jit_gap.max())} steps from JAX's jit")
        check(np.array_equal(q_routed, q_widened),
              "int8 verdicts and SYNAPSEML_ONNX_INT8=0 differ")
        check(lanes_a["all_exact"] and not lanes_a["poisoned"]
              and not lanes_a["without_probe"]
              and lanes_a["records"] == lanes_a["probes"] > 0,
              f"int8 classes: {lanes_a['probes']} probes, "
              f"{lanes_a['records']} records, poisoned "
              f"{lanes_a['poisoned'][:3]}, unprobed "
              f"{lanes_a['without_probe'][:3]}")
        check(int8_n > 0, "the int8 lane served nothing")
        check(rec == 0, f"{rec} recompiles after warmup")
        counts_a = read_counts()
        check(counts_a["forest_traverse"] == 0
              and counts_a["histogram"] == 0, f"kernels ran: {counts_a}")
        walls["resnet50_s"] = time.perf_counter() - start
        emit({"phase": "quantized", "part": "qoperator_resnet50",
              "model": "zoo.resnet50 seed 0, 224, BatchNorm folded, "
                       "QOperator (QLinearConv x53, QLinearAdd x16, "
                       "QLinearGlobalAveragePool, QGemm), MinMax over 4 "
                       "seeded images, ONNXModel(mini_batch_size=128) warm",
              "images": QUANT_IMAGES, "turns": turns,
              "routed": {**info_r, "warmup": str(rep_r)},
              "int8_off": {**info_w, "warmup": str(rep_w)},
              "logits_q_bitwise_cpu_rows": QUANT_CPU_IMAGES,
              "logits_q_bitwise_jax_eager_rows": 2,
              "logits_q_differing_from_jax_jit": int((jit_gap != 0).sum()),
              "stem_acc_sha256_is_fixtures": bool(stem_ok),
              "int8_route_served": int8_n,
              "recompiles_after_warmup": rec, "timeline": busy,
              "probes": {k: v for k, v in lanes_a.items()
                         if k != "classes"},
              "nvidia_smi": smi})
        emit({"phase": "quantized", "part": "int8_classes",
              "classes": lanes_a["classes"], "nvidia_smi": smi})
        close_models(*models)
        models.clear()

        # -- (b) BERT-base's FFN block, dynamically quantized -------------
        start = time.perf_counter()
        cfg = ffn.FULL
        h, r = ffn.inputs(cfg)
        fmodel = ONNXModel(model_bytes=ffn.graph(GraphBuilder, cfg),
                           mini_batch_size=cfg["tokens"])
        models.append(fmodel)
        fex = fmodel._executor("cuda")
        rep_f = fmodel.warmup(buckets=[cfg["tokens"]])
        check(not rep_f.errors and rep_f.compiled == 1,
              f"FFN warmup {rep_f} {rep_f.errors[:2]}")
        sig = tuple(((cfg["tokens"], cfg["hidden"]), "float32")
                    for _ in range(2))
        h2d = ex_mod._h2d_lane().cached(sig, torch.device("cuda", 0))
        ftable = Table({"hidden": h, "residual": r})
        outs = {}
        for choice in ("per_arg", "coalesced", "per_arg"):
            fex._h2d_choice = {sig: choice}
            t0 = time.perf_counter()
            outs[choice] = np.asarray(fmodel.transform(ftable)["out"])
            outs[choice + "_s"] = time.perf_counter() - t0
        fex._h2d_choice = {}
        check(np.array_equal(outs["per_arg"], outs["coalesced"]),
              "FFN outputs differ between the coalesced and per_arg stagings")
        sblob = ffn.graph(GraphBuilder, cfg, stages=True)
        names = ("out",) + ffn.STAGES
        card = dict(zip(names, (o.cpu().numpy() for o in import_model(
            sblob).bind(device="cuda")(torch.from_numpy(h).cuda(),
                                       torch.from_numpy(r).cuda()))))
        sgraph = import_model(sblob)
        cpu = dict(zip(names, (o.numpy() for o in sgraph.bind(device="cpu")(
            torch.from_numpy(h), torch.from_numpy(r)))))
        w2q = torch.from_numpy(sgraph.static_params["w2_q"])
        y2, s2, z2 = importer._dynamic_quantize_linear(
            None, torch.from_numpy(card["g"]))
        acc2 = importer._matmul_wide_core(y2, w2q, z2, np.int8(0))
        first_ok = all(np.array_equal(card[k], cpu[k])
                       for k in ("hq", "hs", "hz", "acc1"))
        second_ok = (np.array_equal(card["gq"], y2.numpy())
                     and np.array_equal(card["gs"], s2.numpy())
                     and np.array_equal(card["gz"], z2.numpy())
                     and np.array_equal(card["acc2"], acc2.numpy()))
        gap = float(np.abs(card["out"] - cpu["out"]).max())
        span = float(np.abs(cpu["out"]).max())
        check(first_ok, "FFN: the first DynamicQuantizeLinear or "
              "accumulator differs from the CPU's")
        check(second_ok, "FFN: the second DynamicQuantizeLinear or "
              "accumulator differs from the CPU's on the card's GELU")
        check(gap <= QUANT_FFN_CPU_TOL * span,
              f"FFN output {gap} from the CPU's (largest |value| {span})")
        check(np.array_equal(outs["per_arg"], card["out"]),
              "FFN through ONNXModel differs from its bind() forward")
        mm = quant_probes(quant_route, autotune)
        check(mm["all_exact"] and not mm["poisoned"]
              and mm["records"] == mm["probes"],
              f"int8 matmul classes: {mm}")
        counts_b = read_counts()
        walls["ffn_s"] = time.perf_counter() - start
        emit({"phase": "quantized", "part": "bert_ffn_dynamic_int8",
              "model": "BERT-base FFN 768 -> 3,072 -> 768, erf GELU, bias, "
                       "residual, LayerNorm; quantize_dynamic layout; "
                       "ONNXModel(mini_batch_size=1024) warm",
              "tokens": cfg["tokens"], "h2d_verdict": h2d,
              "tokens_per_s": {k: cfg["tokens"] / outs[k + "_s"]
                               for k in ("per_arg", "coalesced")},
              "staging_bitwise": True,
              "first_stages_bitwise_cpu": first_ok,
              "second_stages_bitwise_cpu_on_card_gelu": second_ok,
              "gelu_bitwise_cpu": bool(np.array_equal(card["g"], cpu["g"])),
              "out_bitwise_cpu": bool(np.array_equal(card["out"],
                                                     cpu["out"])),
              "out_max_abs_gap_cpu": gap, "out_largest_abs": span,
              "out_tol_share": QUANT_FFN_CPU_TOL,
              "matmul_classes": [c for c in mm["classes"]
                                 if c["kind"] == "matmul"],
              "nvidia_smi": smi})
        close_models(*models)
        models.clear()

        # -- (c) float ResNet-50 under compute_dtype="auto" ---------------
        start = time.perf_counter()
        fblob = zoo.resnet50(num_classes=1000)
        auto = ONNXModel(model_bytes=fblob, compute_dtype="auto",
                         mini_batch_size=MODEL_BATCH)
        models.append(auto)
        t0 = time.perf_counter()
        cd = model_mod.routed_compute_dtype(auto.graph, fblob, MODEL_BATCH,
                                            "cuda")
        dtype_probe_s = time.perf_counter() - t0
        name = auto.graph.output_names[0]
        logits = np.asarray(auto.transform(
            Table({"data": x[:MODEL_BATCH]}))[name])
        want = np.load(RESNET_FIXTURE)["logits_f32"]
        err = float(np.abs(logits[:8] - want).max())
        limit = (BF16_SPAN_SHARE * float(np.abs(want).max())
                 if cd == "bfloat16" else LOGITS_TOL)
        ok = (err <= limit if cd == "bfloat16" else bool(np.allclose(
            logits[:8], want, rtol=LOGITS_TOL, atol=LOGITS_TOL)))
        check(ok and np.isfinite(logits).all(),
              f"auto ({cd}) logits {err} from the JAX fixture")
        check(next(iter(auto._executor_cache))[2] == cd,
              "the resolved dtype does not key the executor cache")
        auto.set(input_norm={"data": IMAGENET_NORM})
        t0 = time.perf_counter()
        wire = auto.preferred_wire("data")
        wire_probe_s = time.perf_counter() - t0
        walls["auto_s"] = time.perf_counter() - start
        emit({"phase": "quantized", "part": "compute_dtype_auto_wire",
              "model": "zoo.resnet50 seed 0, 224, float graph",
              "batch": MODEL_BATCH, "compute_dtype_verdict": cd,
              "dtype_probe_s": dtype_probe_s, "rows0_7_max_abs_err_vs_jax":
              err, "gate": "bf16 5% of largest |logit|" if cd == "bfloat16"
              else "float32 rtol = atol = 1e-3", "limit": limit,
              "preferred_wire": wire, "wire_probe_s": wire_probe_s,
              "nvidia_smi": smi})
        close_models(*models)
        models.clear()

        # -- (d) the 12 ops' one-node cases -------------------------------
        start = time.perf_counter()
        summary = cases_on_card(quant_op_cases, lambda case, dev:
                                quant_op_cases.run(case, import_model,
                                                   GraphBuilder, dev))
        check(not summary["failed"] and summary["exact"] ==
              summary["cases"] == len(quant_op_cases.CASES),
              f"quant cases on the card: {summary['failed'][:3]}")
        walls["cases_s"] = time.perf_counter() - start
    finally:
        close_models(*models)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    counts = read_counts()
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0,
          f"kernels ran on the quantized paths: {counts}")
    probes1 = probe_seconds(tm, QUANT_LANES)
    emit({"phase": "quantized", "part": "summary", "cases": summary,
          "probe_seconds": {ln: {"probes": probes1[ln][0] - probes0[ln][0],
                                 "s": probes1[ln][1] - probes0[ln][1]}
                            for ln in QUANT_LANES},
          "snapshot_lanes": {n: {"probes": v["probes"],
                                 "decisions": len(v["decisions"])}
                             for n, v in autotune.snapshot()["lanes"].items()},
          "launches": counts, "walls": walls,
          "phase_s": time.perf_counter() - phase_start, "nvidia_smi": smi})
    return counts


SP_FIXTURE = os.path.join(FIXTURES, "tagger_sp_io.npz")
SP_RANKS = 4                  # gloo ranks sharing the card, one launch
SP_TIMEOUT_S = 300            # that launch's hard wall
SP_ATTN_SHAPE = (2, 8192, 4, 16)   # B, S, H, D: the tagger's heads
SP_ATTN_LEGS = (("ring", {"sp": 4}, False), ("ring", {"sp": 4}, True),
                ("ulysses", {"sp": 4}, False),
                ("serving_ring", {"dp": 2, "tp": 2}, True))
SP_ATTN_F32_TOL = 2e-4        # rtol = atol vs dense (tests/test_parallel.py)
SP_BF16_GATE = 0.05           # bf16: of the largest |value| (losses: of the
                              # first; leaves: of each leaf's |sum|)
SP_MESHES = {"sp4": {"sp": 4}, "dp2_sp2": {"dp": 2, "sp": 2}}
SP_LOSS_RTOL = 1e-5           # float32 losses vs the one-rank run
SP_LEAF_LR = 1e-2             # float32 leaf sums, in lr a parameter
SP_JAX_LOSS_RTOL = 1e-3       # float32 losses after an update vs the JAX
                              # fixture: the port's one-rank CPU run is
                              # 3.8e-4 from JAX's one-device run at step 3
                              # of that batch (tests/fixtures/
                              # witness_tagger_drift.py)


@contextlib.contextmanager
def ieee_float32():
    """Float32 matmuls without TF32 (an earlier phase may turn it on)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def leaf_gaps(got_sum, got_abs, want_sum, want_abs, sizes, lr) -> dict:
    """Each leaf's sum and |sum| gap: in lr a parameter, and relative."""
    return {"sum_in_lr_a_param": max(abs(got_sum[n] - want_sum[n])
                                     / (sizes[n] * lr) for n in sizes),
            "abs_sum_in_lr_a_param": max(abs(got_abs[n] - want_abs[n])
                                         / (sizes[n] * lr) for n in sizes),
            "abs_sum_rel": max(abs(got_abs[n] - want_abs[n]) / want_abs[n]
                               for n in sizes)}


def sequence_parallel_phase(smi, reset_counts, read_counts) -> dict:
    """Phase 42: sequence parallelism over ranks (``parallel/mesh.py``,
    ``parallel/ring_attention.py``, the tagger's dp × sp path), four gloo
    ranks sharing the card in one launch (``tests/torch_dp_worker.py``
    running ``tests/torch_sp_cases.py``; the ranks share one card, so no
    figure here is a scaling figure).

    a. Attention at the tagger's head geometry, B = 2, S = 8,192, H = 4,
       D = 16, float32 and bf16: the ring (causal and not) and Ulysses
       over ``{"sp": 4}``, the serving ring over ``{"dp": 2, "tp": 2}``
       (causal). Each rank's output block and the gradients of
       ``(out ** 2).sum()`` are gathered and held to the port's dense
       attention on the card (float32 within rtol = atol = 2e-4, bf16
       within 5% of the largest |value|); each rank's peak allocation
       beside dense attention's, forward and backward ms, the rotations'
       and all-to-alls' calls, bytes and seconds.
    b. The tagger at ``TaggerConfig()`` width (427,840 parameters), float32
       and bf16, ring and Ulysses, over ``{"sp": 4}`` and ``{"dp": 2,
       "sp": 2}``: three AdamW steps of phase 31's 32 × 512 batch held to
       the port's one-rank run on the card (float32 losses within rtol
       1e-5 and each leaf's sum and |sum| within 0.01·lr a parameter;
       bf16 losses within 5% of the first and each leaf's |sum| within
       5%), every rank's parameters bitwise equal; step ms, global
       tokens/s, the gradient exchange's seconds and bytes, each rank's
       peak allocation.
    c. Float32, both meshes and both paths, against the JAX fixture of
       the same meshes (``tagger_sp_io.npz``, 4 × 512): the forward's
       gathered logits within rtol = atol = 1e-3 and the aux shares'
       sum within rtol 1e-4, the first loss within rtol 1e-5, the later
       ones within 1e-3, each leaf's update sum within 0.01·lr a
       parameter; ranks bitwise equal.
    K1 and K2 launch 0 times, here and in every rank."""
    import make_tagger_fixture as tfx
    from synapseml_tpu_torch.dl import tagger
    from synapseml_tpu_torch.parallel import ring_attention as ra
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_dp_worker import run_ranks
    from torch_sp_cases import gather as gather_blocks

    phase_start = time.perf_counter()
    reset_counts()
    fx = np.load(SP_FIXTURE)
    lr, seed = float(fx["lr"]), int(fx["seed"])
    rng = np.random.default_rng(42)
    q, k, v = (rng.standard_normal(SP_ATTN_SHAPE).astype(np.float32)
               for _ in range(3))
    rng = np.random.default_rng(31)   # phase 31's global batch
    big = rng.integers(0, 4096, (SEQ_BATCH, SEQ_LEN)).astype(np.int32)
    big_labels = rng.integers(0, 16, (SEQ_BATCH, SEQ_LEN)).astype(np.int32)
    big_mask = rng.random((SEQ_BATCH, SEQ_LEN)) < 0.9
    small = (fx["tokens"], fx["labels"], fx["mask"])
    dtypes = ("float32", "bfloat16")

    def case(name, fn, args):
        return {"name": name, "kind": "call",
                "fn": f"torch_sp_cases:{fn}", "args": [args] * SP_RANKS}

    cases = [case(f"attn_{kind}_{causal}_{d}", "attention",
                  [kind, shape, causal, q, k, v, d, "cuda", True])
             for kind, shape, causal in SP_ATTN_LEGS for d in dtypes]
    for m, shape in SP_MESHES.items():
        for att in ("ring", "ulysses"):
            cases += [case(f"tagger_{m}_{att}_{d}", "tagger",
                           [{}, shape, att, d, big, big_labels, big_mask, 3,
                            lr, seed, "cuda", None, False, 3])
                      for d in dtypes]
            cases.append(case(f"fixture_{m}_{att}", "tagger",
                              [{}, shape, att, "float32", *small, 3, lr,
                               seed, "cuda", fx["tokens"], False, 0]))
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        try:
            ranks = run_ranks(work, SP_RANKS, cases, timeout=SP_TIMEOUT_S,
                              threads=2)
        except RuntimeError as exc:
            raise SystemExit(
                f"chip_smoke: FAILED: sequence-parallel ranks: {exc}")
    launch_s = time.perf_counter() - start
    for c in cases:
        for r, res in enumerate(ranks):
            check("error" not in res[c["name"]],
                  f"{c['name']} failed on rank {r}: "
                  f"{res[c['name']].get('error')}")
    rank_launches = [res[c["name"]]["launches"] for res in ranks
                     for c in cases]

    # -- a. attention against dense on the card ------------------------
    attn, failed = [], []
    for kind, shape, causal in SP_ATTN_LEGS:
        seq = "tp" if kind == "serving_ring" else "sp"
        for d in dtypes:
            name = f"attn_{kind}_{causal}_{d}"
            per_rank = [res[name] for res in ranks]
            dt = getattr(torch, d)
            blocks = [torch.tensor(a, device="cuda").to(dt).requires_grad_()
                      for a in (q, k, v)]
            with ieee_float32():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                want = ra.dense_attention(*blocks, causal=causal)
                (want.float() ** 2).sum().backward()
                torch.cuda.synchronize()
                dense_peak = torch.cuda.max_memory_allocated()

                def dense_fwd():
                    with torch.no_grad():
                        ra.dense_attention(*blocks, causal=causal)
                    torch.cuda.synchronize()

                def dense_fwd_bwd():
                    for b in blocks:
                        b.grad = None
                    (ra.dense_attention(*blocks, causal=causal).float()
                     ** 2).sum().backward()
                    torch.cuda.synchronize()

                fwd_s, _ = wall_median(dense_fwd)
                both_s, _ = wall_median(dense_fwd_bwd)
            wants = [want] + [b.grad for b in blocks]
            gaps, ok = [], True
            for i, w in enumerate(wants):
                w = w.detach().float().cpu().numpy()
                got = gather_blocks(per_rank, "out" if i == 0 else "grads",
                                    ("dp", seq), SP_ATTN_SHAPE,
                                    None if i == 0 else i - 1)
                gap = float(np.abs(got - w).max())
                top = float(np.abs(w).max())
                gaps.append({"max_abs": gap, "of_largest": gap / top})
                ok &= (np.allclose(got, w, rtol=SP_ATTN_F32_TOL,
                                   atol=SP_ATTN_F32_TOL) if d == "float32"
                       else gap <= SP_BF16_GATE * top)
            del want, wants, blocks
            torch.cuda.empty_cache()
            timed = per_rank[0]["collectives_timed"]
            leg = {"leg": name, "kind": kind, "mesh": shape,
                   "causal": causal, "dtype": d,
                   "gaps_out_dq_dk_dv": gaps, "within_tol": bool(ok),
                   "rank_peak_bytes": [r["peak_bytes"] for r in per_rank],
                   "rank_resident_bytes": [r["resident_bytes"]
                                           for r in per_rank],
                   "dense_peak_bytes": dense_peak,
                   "dense_resident_bytes": resident,
                   "forward_ms": max(r["forward_ms"] for r in per_rank),
                   "backward_ms": max(r["backward_ms"] for r in per_rank),
                   "dense_forward_ms": fwd_s * 1e3,
                   "dense_backward_ms": (both_s - fwd_s) * 1e3,
                   "collectives_fwd_bwd": timed,
                   "staged_bytes": per_rank[0]["staged_bytes"]}
            attn.append(leg)
            if not ok:
                failed.append(name)
            if kind == "ulysses":
                ok_calls = timed.get("all_to_all", {}).get("calls") == 4
            else:
                ok_calls = timed.get("rotate", {}).get("calls") == 2 * (
                    shape.get(seq, 1) - 1)
            if not ok_calls:
                failed.append(f"{name} exchanges {timed}")
    emit({"phase": "sequence_parallel", "part": "attention",
          "shape": list(SP_ATTN_SHAPE), "ranks": SP_RANKS,
          "legs": attn, "launch_s": launch_s, "nvidia_smi": smi})
    check(not failed, f"sequence-parallel attention outside its gate: "
          f"{failed}")

    # -- b. the tagger over dp x sp ranks against one rank ---------------
    p0 = tagger.init_params(tagger.TaggerConfig(), seed)
    names = [str(n) for n in fx["leaf_names"]]
    sizes = {n: int(tfx.leaf(p0, n).size) for n in names}
    one, train, failed = {}, [], []
    for att in ("ring", "ulysses"):
        for d in dtypes:
            cfg = tagger.TaggerConfig(dtype=getattr(torch, d), attention=att)
            step, init_state, place = tagger.make_train_step(cfg, None, lr)
            params, opt = init_state(seed)
            batch = [place(a) for a in (big, big_labels, big_mask)]
            with ieee_float32():
                losses = [float(step(params, opt, *batch)[2])
                          for _ in range(3)]
                named = dict(params.named_parameters())
                one[(att, d)] = {
                    "losses": losses,
                    "sum": {n: float(named[n].detach().double().sum())
                            for n in names},
                    "abs": {n: float(named[n].detach().double().abs().sum())
                            for n in names}}

                def one_step():
                    step(params, opt, *batch)
                    torch.cuda.synchronize()

                one[(att, d)]["step_ms"] = wall_median(one_step)[0] * 1e3
    for m, shape in SP_MESHES.items():
        for att in ("ring", "ulysses"):
            for d in dtypes:
                name = f"tagger_{m}_{att}_{d}"
                per_rank = [res[name] for res in ranks]
                r0, base = per_rank[0], one[(att, d)]
                loss_gap = max(abs(a - b) for a, b in zip(r0["losses"],
                                                          base["losses"]))
                gaps = leaf_gaps(r0["leaf_sum"], r0["leaf_abs_sum"],
                                 base["sum"], base["abs"], sizes, lr)
                bitwise = len({r["digest"] for r in per_rank}) == 1
                if d == "float32":
                    ok = (np.allclose(r0["losses"], base["losses"],
                                      rtol=SP_LOSS_RTOL, atol=0)
                          and gaps["sum_in_lr_a_param"] <= SP_LEAF_LR
                          and gaps["abs_sum_in_lr_a_param"] <= SP_LEAF_LR)
                else:
                    ok = (loss_gap <= SP_BF16_GATE * abs(base["losses"][0])
                          and gaps["abs_sum_rel"] <= SP_BF16_GATE)
                ok = bool(ok and bitwise)
                timed = r0["collectives_timed"]
                step_ms = max(r["step_ms"] for r in per_rank)
                train.append({
                    "run": name, "mesh": shape, "attention": att,
                    "dtype": d, "losses": r0["losses"],
                    "one_rank_losses": base["losses"], "loss_gap": loss_gap,
                    "leaf_gaps": gaps, "ranks_bitwise_equal": bitwise,
                    "within_tol": ok, "step_ms": step_ms,
                    "one_rank_step_ms": base["step_ms"],
                    "global_tokens_per_s": SEQ_BATCH * SEQ_LEN
                    / (step_ms / 1e3),
                    "collectives_a_step": timed,
                    "staged_bytes_a_step": r0["staged_bytes"],
                    "rank_step_peak_bytes": [r["step_peak_bytes"]
                                             for r in per_rank]})
                if not ok:
                    failed.append(name)
    emit({"phase": "sequence_parallel", "part": "tagger",
          "batch": [SEQ_BATCH, SEQ_LEN], "lr": lr, "runs": train,
          "note": "ranks share one card: not a scaling figure",
          "nvidia_smi": smi})
    check(not failed, f"sequence-parallel tagger outside its gate: {failed}")

    # -- c. float32 against the JAX fixture of the same meshes -----------
    vs_jax, failed = [], []
    for m, shape in SP_MESHES.items():
        for att in ("ring", "ulysses"):
            key = f"{m}_{att}"
            per_rank = [res[f"fixture_{key}"] for res in ranks]
            r0 = per_rank[0]
            want = fx[f"logits_{key}"]
            got = gather_blocks(per_rank, "logits", ("dp", "sp"), want.shape)
            aux = 0.0
            for r in per_rank:
                aux += r["aux"]
            jl = [float(x) for x in fx[f"losses_{key}"]]
            upd = max(abs(r0["leaf_sum"][n] - float(
                tfx.leaf(p0, n).astype(np.float64).sum())
                - float(fx[f"update_sum_{key}"][i])) / (sizes[n] * lr)
                for i, n in enumerate(names))
            bitwise = len({r["digest"] for r in per_rank}) == 1
            ok = (np.allclose(got, want, rtol=SEQ_F32_JAX_TOL,
                              atol=SEQ_F32_JAX_TOL)
                  and abs(aux - float(fx[f"aux_{key}"]))
                  <= 1e-4 * abs(float(fx[f"aux_{key}"]))
                  and abs(r0["losses"][0] - jl[0]) <= SP_LOSS_RTOL * abs(jl[0])
                  and np.allclose(r0["losses"], jl, rtol=SP_JAX_LOSS_RTOL,
                                  atol=0)
                  and upd <= SP_LEAF_LR and bitwise)
            vs_jax.append({"run": key, "mesh": shape, "attention": att,
                           "logit_max_abs_gap": float(np.abs(got - want)
                                                      .max()),
                           "aux": aux, "jax_aux": float(fx[f"aux_{key}"]),
                           "losses": r0["losses"], "jax_losses": jl,
                           "update_sum_gap_in_lr_a_param": upd,
                           "ranks_bitwise_equal": bitwise,
                           "within_tol": bool(ok)})
            if not ok:
                failed.append(key)
    counts = read_counts()
    emit({"phase": "sequence_parallel", "part": "tagger_vs_jax",
          "batch": list(small[0].shape),
          "fixture_jax_version": str(fx["jax_version"]), "runs": vs_jax,
          "launches": counts, "rank_launches_max": {
              k: max(r[k] for r in rank_launches)
              for k in ("histogram", "forest_traverse")},
          "seconds": time.perf_counter() - phase_start, "nvidia_smi": smi})
    check(not failed, f"sequence-parallel tagger vs the JAX fixture: "
          f"{failed}")
    check(counts["forest_traverse"] == 0 and counts["histogram"] == 0
          and all(r["histogram"] == 0 and r["forest_traverse"] == 0
                  for r in rank_launches),
          f"the sequence-parallel path launched K1/K2: {counts}")
    return counts


def main() -> int:
    # -- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    sys.path.insert(0, HERE)
    from synapseml_tpu_torch import _build
    from synapseml_tpu_torch.data.table import Table
    sys.path.insert(0, FIXTURES)
    import make_lgbm_adult_cat_fixture as cat_fx
    import make_lgbm_rank_fixture as rank_fx
    from synapseml_tpu_torch.gbdt import boosting, grower, objectives, prng
    from synapseml_tpu_torch.gbdt.binning import BinMapper
    from synapseml_tpu_torch.gbdt.boosting import Booster
    from synapseml_tpu_torch.gbdt.estimators import (
        LightGBMClassificationModel, LightGBMClassifier, LightGBMRanker,
        LightGBMRegressor)
    from synapseml_tpu_torch.gbdt.kernels import (
        bin_index, forest_traverse, forest_traverse_reference, histogram,
        histogram_reference, mask_features)
    from synapseml_tpu_torch.isolationforest import IsolationForest

    def reset_counts():
        forest_traverse.launches = 0
        histogram.launches = 0
        bin_index.builds = 0
        mask_features.builds = 0

    def read_counts() -> dict:
        return {"forest_traverse": forest_traverse.launches,
                "histogram": histogram.launches,
                "bin_index_builds": bin_index.builds,
                "mask_features_builds": mask_features.builds}

    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- 2. build -------------------------------------------------------
    build_s = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_log.items()}
    emit({"phase": "build", "seconds": build_s, "sources": _build.sources(),
          "ptxas": ptxas})

    # -- 3. kernel against plain on the card ----------------------------
    with open(FIXTURE) as fh:
        booster = Booster.load_string(fh.read())
    rng = np.random.default_rng(0)
    x_main = query_rows(N_MAIN)
    xd_main = torch.from_numpy(x_main).cuda()
    fx_planes = on_card((booster.trees_feature, booster.trees_threshold,
                         booster.trees_left, booster.trees_right,
                         booster.trees_value * booster.tree_weights[:, None]))
    if_x = rng.normal(size=(N_MAIN, 14)).astype(np.float32)
    if_x[:64] += 5.0
    if_model = IsolationForest(num_estimators=100, max_samples=256,
                               random_seed=1).fit(
        Table({"features": if_x}), device="cuda")
    if_planes = on_card(if_model.trees)
    if_depth = int(if_model.max_depth) + 1
    mc_planes = on_card(random_forest(rng, 30, 63, 10))
    mc_x = torch.from_numpy(query_rows(20_000, 10, seed=3)).cuda()
    bins = torch.from_numpy(
        rng.integers(0, 256, (N_MAIN, 14)).astype(np.uint8)).cuda()
    b_feat, _, b_left, b_right, b_value = random_forest(rng, 1, 61, 14)
    b_thr = rng.integers(0, 255, (1, 61)).astype(np.float32)
    bin_planes = on_card((b_feat, b_thr, b_left, b_right, b_value))
    cases = [
        ("fixture_k1", xd_main, fx_planes, dict(k=1)),
        ("multiclass_k3", mc_x, mc_planes, dict(k=3)),
        ("single_tree_binned", bins.float(), bin_planes, dict(k=1)),
        ("iforest_strict", torch.from_numpy(if_x).cuda(), if_planes,
         dict(k=1, depth=if_depth, strict=True)),
    ]
    results = []
    for name, x, planes, kw in cases:
        if name == "single_tree_binned":
            got = grower.predict_tree_binned(
                tuple(p[0] for p in planes), bins)[:, None]
        else:
            got = forest_traverse(x, *planes, **kw)
        want = forest_traverse_reference(x, *planes, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        results.append({"case": name, "shape": list(x.shape),
                        "trees": list(planes[0].shape), **{
                            k: v for k, v in kw.items() if k != "strict"},
                        "strict": bool(kw.get("strict", False)),
                        "bitwise": bool(torch.equal(got, want)),
                        "max_abs_err": err})
    emit({"phase": "kernel_vs_plain", "kernel": "forest_traverse",
          "tolerance": "bitwise (torch.equal)", "cases": results})
    check(all(r["bitwise"] for r in results),
          "forest_traverse differs from its plain version")
    max_err = max(r["max_abs_err"] for r in results)

    # K1 at the training path's shapes: Adult bins from the port's
    # BinMapper, (grad, hess) of the binary logloss at the init score
    x_adult, y_adult = adult_rows()
    mapper = BinMapper(max_bin=255).fit(x_adult.astype(np.float64))
    adult_bins = mapper.transform(x_adult.astype(np.float64))
    n_bins = mapper.total_bins
    p0 = float(y_adult.mean())
    g0 = (p0 - y_adult).astype(np.float32)
    h0 = np.full(len(y_adult), p0 * (1 - p0), np.float32)

    def hist_data(mask):
        w = mask.astype(np.float32)
        return np.stack([g0 * w, h0 * w, w], 1)

    skewed_bins = adult_bins.copy()       # 90% of the rows in one bin
    skewed_bins[rng.random(skewed_bins.shape) < 0.9] = 200
    nan_data = np.zeros((len(y_adult), 3), np.float32)
    nan_data[17_000, 0] = np.nan          # all zero but one NaN grad
    k1_cases = [
        ("adult_full_mask", adult_bins,
         hist_data(np.ones(len(y_adult), bool)), n_bins),
        ("adult_leaf_30pct", adult_bins,
         hist_data(rng.random(len(y_adult)) < 0.3), n_bins),
        ("adult_zero_mask", adult_bins,
         hist_data(np.zeros(len(y_adult), bool)), n_bins),
        ("adult_skewed_90pct", skewed_bins,
         hist_data(rng.random(len(y_adult)) < 0.7), n_bins),
        ("adult_one_nan_grad", adult_bins, nan_data, n_bins),
        ("uint16_b1024", rng.integers(0, 1024, (10_007, 5)).astype(np.uint16),
         rng.normal(size=(10_007, 3)).astype(np.float32), 1024),
        ("f1_n1", np.array([[3]], np.uint8),
         np.array([[1.5, 2.0, 1.0]], np.float32), 8),
        ("n0", np.zeros((0, 4), np.uint8), np.zeros((0, 3), np.float32), 16),
    ]
    k1_results = []
    for name, b, d, nb in k1_cases:
        want = histogram_reference(torch.from_numpy(b), torch.from_numpy(d),
                                   nb)
        bd, dd = torch.from_numpy(b).cuda(), torch.from_numpy(d).cuda()
        index = bin_index(bd, nb)
        cpu_index = bin_index(torch.from_numpy(b), nb)
        index_ok = bool(torch.equal(index.order.cpu(), cpu_index.order)
                        and torch.equal(index.start.cpu(), cpu_index.start))
        for route, got in (("index_built_in_call", histogram(bd, dd, nb)),
                           ("index_given", histogram(bd, dd, nb,
                                                     index=index))):
            torch.cuda.synchronize()
            got = got.cpu()
            nan_same = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
            bits_same = bool(torch.equal(
                got.nan_to_num(7.0).view(torch.int32),
                want.nan_to_num(7.0).view(torch.int32)))
            diff = (got - want).abs().nan_to_num(0.0)
            k1_results.append({
                "case": name, "route": route, "shape": list(b.shape),
                "dtype": str(b.dtype), "n_bins": nb,
                "bitwise": nan_same and bits_same,
                "nan_entries": int(torch.isnan(want).sum()),
                "index_equals_cpu_index": index_ok,
                "max_abs_err": float(diff.max()) if diff.numel() else 0.0})
    zero = [r for r in k1_results if r["case"] == "adult_zero_mask"]
    adult_bd = torch.from_numpy(adult_bins).cuda()
    adult_dd = torch.from_numpy(k1_cases[0][2]).cuda()
    adult_index = bin_index(adult_bd, n_bins)
    repeats = [histogram(adult_bd, adult_dd, n_bins, index=adult_index)
               for _ in range(5)]
    deterministic = all(torch.equal(repeats[0], r) for r in repeats[1:])
    emit({"phase": "kernel_vs_plain", "kernel": "histogram",
          "tolerance": "bitwise (int32 views equal; NaN where the plain "
                       "version has NaN) against the plain version run on "
                       "the CPU from the same inputs",
          "cases": k1_results, "five_launches_bitwise_identical":
          deterministic})
    check(all(r["bitwise"] for r in k1_results),
          "histogram differs from its plain version")
    check(all(r["index_equals_cpu_index"] for r in k1_results),
          "the bin index built on the card differs from the CPU's")
    check(all(r["max_abs_err"] == 0.0 for r in zero),
          "an all-zero mask does not give exact zeros")
    check(all(r["nan_entries"] == 14 for r in k1_results
              if r["case"] == "adult_one_nan_grad"),
          "the one NaN grad does not reach every feature's histogram")
    check(deterministic, "five histogram launches are not bitwise equal")
    k1_max_err = max(r["max_abs_err"] for r in k1_results)

    # the threefry key stream: the card's draws are the CPU's, bitwise (the
    # CPU's are jax.random's: tests/test_torch_prng.py)
    prng_results = []
    for seed in (0, 42):
        keys = {dev: prng.prng_key(seed, dev) for dev in ("cuda", "cpu")}
        chain_same = True
        for _ in range(100):        # a 100-tree fit's rng chain
            for dev, key in keys.items():
                keys[dev] = prng.split(key)[0]
            chain_same &= torch.equal(keys["cuda"].cpu(), keys["cpu"])
        folded = {dev: prng.fold_in(prng.split(key)[1], 2 ** 31 - 1)
                  for dev, key in keys.items()}
        for n in (14, 32_561, N_LARGE):
            draws = {dev: (prng.uniform(key, n), prng.permutation(key, n))
                     for dev, key in folded.items()}
            (gu, gp), (cu, cp) = draws["cuda"], draws["cpu"]
            prng_results.append({
                "seed": seed, "n": n, "key_chain_equal": bool(chain_same),
                "uniform_bitwise": bool(torch.equal(
                    gu.cpu().view(torch.int32), cu.view(torch.int32))),
                "permutation_equal": bool(torch.equal(gp.cpu(), cp)),
                "on_card": gu.is_cuda and gp.is_cuda})
    emit({"phase": "prng_card_vs_cpu", "tolerance": "bitwise",
          "cases": prng_results})
    check(all(r["key_chain_equal"] and r["uniform_bitwise"]
              and r["permutation_equal"] and r["on_card"]
              for r in prng_results),
          "the key stream on the card differs from the CPU's")

    # K1 on feature_fraction's per-tree index (feature 0, whose histogram
    # gives the leaf totals, moved to the last bin)
    keep = torch.ones(adult_bins.shape[1], dtype=torch.bool)
    keep[[0, 5, 9]] = False
    bag = hist_data(rng.random(len(y_adult)) < 0.8)
    card_bins = torch.from_numpy(adult_bins).cuda()
    moved, masked = mask_features(bin_index(card_bins, n_bins), card_bins,
                                  keep.cuda())
    cpu_moved, cpu_masked = mask_features(
        bin_index(torch.from_numpy(adult_bins), n_bins),
        torch.from_numpy(adult_bins), keep)
    fresh = bin_index(moved, n_bins)
    bag_d = torch.from_numpy(bag).cuda()
    on_masked = histogram(moved, bag_d, n_bins, index=masked).cpu()
    on_fresh = histogram(moved, bag_d, n_bins, index=fresh).cpu()
    plain_moved = histogram_reference(cpu_moved, torch.from_numpy(bag),
                                      n_bins)
    masked_result = {
        "shape": list(adult_bins.shape), "moved_features": [0, 5, 9],
        "index_equals_fresh_index": bool(
            torch.equal(masked.order, fresh.order)
            and torch.equal(masked.start, fresh.start)),
        "index_equals_cpu": bool(
            torch.equal(masked.order.cpu(), cpu_masked.order)
            and torch.equal(masked.start.cpu(), cpu_masked.start)
            and torch.equal(moved.cpu(), cpu_moved)),
        "k1_masked_vs_k1_fresh_bitwise": bool(torch.equal(
            on_masked.view(torch.int32), on_fresh.view(torch.int32))),
        "k1_masked_vs_plain_bitwise": bool(torch.equal(
            on_masked.view(torch.int32), plain_moved.view(torch.int32)))}
    emit({"phase": "masked_index", "tolerance": "bitwise", **masked_result})
    check(all(v for k, v in masked_result.items() if k not in (
        "shape", "moved_features")), "K1 on the feature_fraction index")

    # -- 4. main path ---------------------------------------------------
    model = LightGBMClassificationModel.load_native_model(FIXTURE)
    io = np.load(FIXTURE_IO)
    x_large = query_rows(N_LARGE, seed=2)
    reset_counts()
    out_main = model.transform(Table({"features": x_main}), device="cuda")
    start = time.perf_counter()
    out_large = model.transform(Table({"features": x_large}), device="cuda")
    large_s = time.perf_counter() - start
    out_io = model.transform(Table({"features": io["x"]}), device="cuda")
    counts = read_counts()
    launches = counts["forest_traverse"]
    check(launches >= 3, f"main path launched the kernel {launches} times")
    for out, n in ((out_main, N_MAIN), (out_large, N_LARGE)):
        raw, prob = out["rawPrediction"], out["probability"]
        check(raw.shape == (n, 2) and prob.shape == (n, 2),
              f"output shapes {raw.shape} {prob.shape}")
        check(bool(np.isfinite(raw).all() and np.isfinite(prob).all()),
              "non-finite scores")
        check(bool(np.allclose(prob.sum(1), 1.0, atol=1e-6)),
              "probabilities do not sum to 1")
    raw_ok = bool(np.array_equal(out_io["rawPrediction"][:, 1], io["raw"]))
    prob_err = float(np.abs(out_io["probability"][:, 1] - io["prob"]).max())
    prob_bitwise = bool(np.array_equal(out_io["probability"][:, 1],
                                       io["prob"]))
    emit({"phase": "main_path", "rows": [N_MAIN, N_LARGE, len(io["x"])],
          "launches": counts, "raw_bitwise_vs_jax_fixture": raw_ok,
          "prob_bitwise_vs_jax_fixture": prob_bitwise,
          "prob_max_abs_err": prob_err, "prob_atol": PROB_ATOL,
          "large_transform_s": large_s})
    check(raw_ok, "raw margins differ from the JAX package's recorded ones")
    check(prob_err <= PROB_ATOL, f"probabilities off by {prob_err}")

    # -- 5. isolation forest -------------------------------------------
    reset_counts()
    scores = if_model.transform(Table({"features": if_x}),
                                device="cuda")["outlierScore"]
    if_launches = read_counts()["forest_traverse"]
    plain = if_model.transform(Table({"features": if_x}),
                               device="cpu")["outlierScore"]
    if_ok = bool(np.array_equal(scores, plain))
    emit({"phase": "iforest", "rows": N_MAIN, "trees": 100,
          "launches": if_launches, "bitwise_vs_plain_cpu": if_ok,
          "mean_score_outliers": float(scores[:64].mean()),
          "mean_score_inliers": float(scores[64:].mean())})
    check(if_launches >= 1, "isolation forest scoring did not launch K2")
    check(if_ok, "isolation-forest scores differ from the plain version")
    check(bool(scores[:64].mean() > scores[64:].mean()),
          "outliers do not score higher than inliers")

    # -- 6. train -------------------------------------------------------
    adult = Table({"features": x_adult, "label": y_adult})

    def adult_fit():
        return LightGBMClassifier(num_iterations=100, num_leaves=31,
                                  learning_rate=0.1).fit(adult, device="cuda")

    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    fitted = adult_fit()
    torch.cuda.synchronize()
    fit_first_s = time.perf_counter() - start
    out_fit = fitted.transform(Table({"features": io["x"]}), device="cuda")
    train_counts = read_counts()
    splits = int((fitted.booster.trees_feature >= 0).sum())
    # the fixture was written in LightGBM's text format and read back, so
    # the fitted booster takes the same round trip before the comparison
    port_rt = Booster.load_string(fitted.booster.save_string())
    same = same_trees(port_rt, booster)
    ll_port = logloss(fitted.booster.predict_raw(x_adult, device="cuda"),
                      y_adult)
    ll_fixture = logloss(booster.predict_raw(x_adult, device="cuda"), y_adult)
    raw_fit = out_fit["rawPrediction"]
    gap = np.abs(raw_fit[:, 1] - io["raw"])
    emit({"phase": "train", "config": "LightGBMClassifier(num_iterations="
                                      "100, num_leaves=31, learning_rate=0.1)",
          "rows": list(x_adult.shape), "device_bins": n_bins,
          "launches": train_counts, "splits": splits, "trees": len(same),
          "identical_trees_vs_jax_fixture": sum(same),
          "first_difference": first_difference(port_rt, booster, same),
          "train_logloss": ll_port, "train_logloss_jax_fixture": ll_fixture,
          "margin_gap_mean": float(gap.mean()),
          "margin_gap_max": float(gap.max()),
          "fit_first_s": fit_first_s})
    check(train_counts["histogram"] == 100 + splits,
          f"{train_counts['histogram']} K1 launches for {splits} splits")
    check(train_counts["histogram"] >= 3000,
          f"the fit launched K1 {train_counts['histogram']} times")
    check(train_counts["bin_index_builds"] == 1,
          f"the fit built {train_counts['bin_index_builds']} bin indexes")
    check(train_counts["forest_traverse"] >= 1,
          "transform of the fitted model did not launch K2")
    check(raw_fit.shape == (len(io["x"]), 2)
          and bool(np.isfinite(raw_fit).all()), "fitted model's margins")
    check(abs(ll_port - ll_fixture) <= LOGLOSS_TOL,
          f"training logloss {ll_port} vs the JAX fixture's {ll_fixture}")
    check(float(gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"mean margin gap {gap.mean()} to the JAX fixture")
    check(not all(same) or float(gap.max()) <= MARGIN_TOL_FIXTURE,
          f"max margin gap {gap.max()} with all trees identical")

    # -- 7. the sampled Adult fit (bagging and feature_fraction) ----------
    with open(SAMPLED) as fh:
        sampled_fixture = Booster.load_string(fh.read())
    sampled_io = np.load(SAMPLED_IO)

    def sampled_fit():
        return LightGBMClassifier(num_iterations=100, num_leaves=31,
                                  learning_rate=0.1, **SAMPLED_PARAMS).fit(
            adult, device="cuda")

    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    sampled = sampled_fit()
    torch.cuda.synchronize()
    sampled_first_s = time.perf_counter() - start
    out_sampled = sampled.transform(Table({"features": sampled_io["x"]}),
                                    device="cuda")
    sampled_counts = read_counts()
    sampled_splits = int((sampled.booster.trees_feature >= 0).sum())
    sampled_rt = Booster.load_string(sampled.booster.save_string())
    same_sampled = same_trees(sampled_rt, sampled_fixture)
    ll_sampled = logloss(sampled.booster.predict_raw(x_adult, device="cuda"),
                         y_adult)
    ll_sampled_fixture = logloss(
        sampled_fixture.predict_raw(x_adult, device="cuda"), y_adult)
    raw_sampled = out_sampled["rawPrediction"]
    sampled_gap = np.abs(raw_sampled[:, 1] - sampled_io["raw"])
    emit({"phase": "train_sampled_adult",
          "config": "LightGBMClassifier(num_iterations=100, num_leaves=31, "
                    "learning_rate=0.1, bagging_fraction=0.8, "
                    "bagging_freq=1, feature_fraction=0.8, seed=0)",
          "fixture_jax_version": str(sampled_io["jax_version"]),
          "rows": list(x_adult.shape), "launches": sampled_counts,
          "splits": sampled_splits, "trees": len(same_sampled),
          "identical_trees_vs_jax_fixture": sum(same_sampled),
          "first_difference": first_difference(sampled_rt, sampled_fixture,
                                               same_sampled),
          "train_logloss": ll_sampled,
          "train_logloss_jax_fixture": ll_sampled_fixture,
          "margin_gap_mean": float(sampled_gap.mean()),
          "margin_gap_max": float(sampled_gap.max()),
          "fit_first_s": sampled_first_s})
    check(sampled_counts["histogram"] == 100 + sampled_splits,
          f"{sampled_counts['histogram']} K1 launches for {sampled_splits} "
          "splits")
    check(sampled_counts["bin_index_builds"] == 1
          and sampled_counts["mask_features_builds"] == 100,
          f"the sampled fit's indexes: {sampled_counts}")
    check(sampled_counts["forest_traverse"] >= 1,
          "transform of the sampled model did not launch K2")
    check(raw_sampled.shape == (len(sampled_io["x"]), 2)
          and bool(np.isfinite(raw_sampled).all()), "sampled margins")
    check(abs(ll_sampled - ll_sampled_fixture) <= LOGLOSS_TOL,
          f"sampled training logloss {ll_sampled} vs the JAX fixture's "
          f"{ll_sampled_fixture}")
    check(float(sampled_gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"sampled mean margin gap {sampled_gap.mean()}")
    check(not all(same_sampled)
          or float(sampled_gap.max()) <= MARGIN_TOL_FIXTURE,
          f"sampled max margin gap {sampled_gap.max()} with all trees "
          "identical")

    def card_and_cpu(name, make, table, query, bitwise=False):
        """Fit with the same port code on the card and on the CPU; with
        ``bitwise``, every tree and margin must be identical."""
        boosters = {dev: make().fit(table, device=dev).booster
                    for dev in ("cuda", "cpu")}
        raw = {dev: b.predict_raw(query, device=dev)
               for dev, b in boosters.items()}
        same_dev = same_trees(boosters["cuda"], boosters["cpu"])
        gap = float(np.abs(raw["cuda"] - raw["cpu"]).max())
        result = {
            "fit": name, "rows": list(table["features"].shape),
            "trees": len(same_dev), "identical_trees": sum(same_dev),
            "bitwise": bool(all(same_dev) and gap == 0.0 and np.array_equal(
                boosters["cuda"].trees_value, boosters["cpu"].trees_value)),
            "first_difference": first_difference(
                boosters["cuda"], boosters["cpu"], same_dev),
            "margin_max_gap": gap,
            "tree_weights_equal": bool(np.array_equal(
                boosters["cuda"].tree_weights, boosters["cpu"].tree_weights)),
            "best_iteration": {d: b.best_iteration
                               for d, b in boosters.items()},
            "eval_history_equal": (boosters["cuda"].eval_history
                                   == boosters["cpu"].eval_history),
            "eval_history_max_gap": max(
                [abs(a - b) for k, h in boosters["cuda"].eval_history.items()
                 for a, b in zip(h, boosters["cpu"].eval_history[k])],
                default=0.0),
            "bitwise_required": bitwise}
        check(result["margin_max_gap"] <= MARGIN_TOL_CPU,
              f"{name}: card and CPU margins differ by "
              f"{result['margin_max_gap']}")
        check(not bitwise or (all(same_dev) and result["tree_weights_equal"]
                              and result["margin_max_gap"] == 0.0),
              f"{name}: card and CPU fits are not bitwise equal")
        return result

    x3, y3 = synth_rows(20_000, 10, seed=3, classes=3)
    xr, yr = synth_rows(20_000, 10, seed=4)
    xe, ye = synth_rows(20_000, 10, seed=5, classes=2)
    valid = np.zeros(len(ye), bool)
    valid[15_000:] = True
    versus_cpu = [
        card_and_cpu("multiclass_3", lambda: LightGBMClassifier(
            num_iterations=10, num_leaves=31),
            Table({"features": x3, "label": y3}), x3[:2000]),
        card_and_cpu("regression_l2", lambda: LightGBMRegressor(
            num_iterations=15, num_leaves=31),
            Table({"features": xr, "label": yr}), xr[:2000]),
        card_and_cpu("binary_early_stopping", lambda: LightGBMClassifier(
            num_iterations=200, num_leaves=31, learning_rate=0.3,
            early_stopping_round=10, validation_indicator_col="valid"),
            Table({"features": xe, "label": ye, "valid": valid}),
            xe[15_000:]),
    ]
    emit({"phase": "train_card_vs_cpu", "margin_tol": MARGIN_TOL_CPU,
          "fits": versus_cpu})
    best = versus_cpu[2]["best_iteration"]
    check(best["cuda"] == best["cpu"] and 0 <= best["cuda"] < 199,
          f"early stopping: best_iteration {best}")

    # -- 8. every boosting mode, card against CPU --------------------------
    xb, yb = synth_rows(20_000, 10, seed=6, classes=2)
    binary_t = Table({"features": xb, "label": yb})
    regression_t = Table({"features": xr, "label": yr})
    three_t = Table({"features": x3, "label": y3})

    def clf(**kw):
        return lambda: LightGBMClassifier(num_leaves=31, num_iterations=10,
                                          **kw)

    dart = dict(boosting_type="dart", drop_rate=0.2, skip_drop=0.3)
    modes = [
        # GOSS binary / 3-class: a near-tie of gradient groups or gains can
        # flip a split, so these are held within the margin tolerance
        ("goss_binary", clf(boosting_type="goss"), binary_t, xb[:2000],
         False),
        ("goss_l2", lambda: LightGBMRegressor(
            num_iterations=10, num_leaves=31, boosting_type="goss"),
         regression_t, xr[:2000], True),
        ("goss_multiclass_3", clf(boosting_type="goss"), three_t, x3[:2000],
         False),
        ("rf_bagging_feature_fraction", clf(
            boosting_type="rf", bagging_fraction=0.7, bagging_freq=1,
            feature_fraction=0.8), binary_t, xb[:2000], True),
        ("pos_neg_bagging_seed", clf(
            pos_bagging_fraction=0.7, neg_bagging_fraction=0.5,
            bagging_freq=1, bagging_seed=7), binary_t, xb[:2000], True),
        ("dart_uniform", clf(uniform_drop=True, **dart), binary_t,
         xb[:2000], True),
        ("dart_weighted", clf(**dart), binary_t, xb[:2000], True),
        ("dart_xgboost_mode", clf(xgboost_dart_mode=True, **dart), binary_t,
         xb[:2000], True),
        ("dart_multiclass_3", clf(**dart), three_t, x3[:2000], True),
    ]
    mode_results = [card_and_cpu(*m) for m in modes]
    emit({"phase": "train_modes_card_vs_cpu", "margin_tol": MARGIN_TOL_CPU,
          "fits": mode_results})

    # -- 9. categorical Adult fit ------------------------------------------
    x_cat, y_cat = cat_fx.adult_cat_rows()
    cat_table = Table({"features": x_cat, "label": y_cat})
    with open(cat_fx.MODEL) as fh:
        cat_fixture = Booster.load_string(fh.read())
    cat_io = np.load(cat_fx.IO)

    def cat_fit(device="cuda", iterations=100):
        return LightGBMClassifier(**{**cat_fx.PARAMS,
                                     "num_iterations": iterations}).fit(
            cat_table, device=device)

    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    cat_model = cat_fit()
    torch.cuda.synchronize()
    cat_first_s = time.perf_counter() - start
    out_cat = cat_model.transform(Table({"features": cat_io["x"]}),
                                  device="cuda")
    cat_counts = read_counts()
    cat_splits = int((cat_model.booster.trees_feature >= 0).sum())
    cat_rt = Booster.load_string(cat_model.booster.save_string())
    same_cat = same_trees(cat_rt, cat_fixture)
    ll_cat = logloss(cat_model.booster.predict_raw(x_cat, device="cuda"),
                     y_cat)
    ll_cat_fixture = logloss(cat_fixture.predict_raw(x_cat, device="cuda"),
                             y_cat)
    raw_cat = out_cat["rawPrediction"]
    cat_gap = np.abs(raw_cat[:, 1] - cat_io["raw"])
    # card against CPU at 15 of the 100 iterations (the CPU fit's time)
    cat_card = cat_fit("cuda", CAT_CPU_ITERATIONS).booster
    cat_cpu = cat_fit("cpu", CAT_CPU_ITERATIONS).booster
    same_cat_cpu = same_trees(cat_card, cat_cpu)
    cat_bitwise_cpu = bool(
        all(same_cat_cpu)
        and np.array_equal(cat_card.trees_value, cat_cpu.trees_value)
        and np.array_equal(cat_card.predict_raw(cat_io["x"], device="cuda"),
                           cat_cpu.predict_raw(cat_io["x"], device="cpu")))
    emit({"phase": "train_categorical_adult",
          "config": "LightGBMClassifier(num_iterations=100, num_leaves=31, "
                    "learning_rate=0.1, categorical_slot_indexes="
                    f"{cat_fx.CATEGORICAL})",
          "fixture_jax_version": str(cat_io["jax_version"]),
          "rows": list(x_cat.shape), "launches": cat_counts, "splits": cat_splits,
          "trees": len(same_cat),
          "identical_trees_vs_jax_fixture": sum(same_cat),
          "first_difference": first_difference(cat_rt, cat_fixture,
                                               same_cat),
          "splits_on_categorical_columns": int(np.isin(
              cat_model.booster.trees_feature, cat_fx.CATEGORICAL).sum()),
          "train_logloss": ll_cat, "train_logloss_jax_fixture": ll_cat_fixture,
          "margin_gap_mean": float(cat_gap.mean()),
          "margin_gap_max": float(cat_gap.max()),
          "cpu_fit_iterations": CAT_CPU_ITERATIONS,
          "identical_trees_vs_cpu_fit": sum(same_cat_cpu),
          "bitwise_vs_cpu_fit": cat_bitwise_cpu, "fit_first_s": cat_first_s})
    check(cat_counts["histogram"] == 100 + cat_splits,
          f"{cat_counts['histogram']} K1 launches for {cat_splits} splits")
    check(cat_counts["bin_index_builds"] == 1,
          f"the categorical fit built {cat_counts['bin_index_builds']} "
          "bin indexes")
    check(cat_counts["forest_traverse"] >= 1,
          "transform of the categorical model did not launch K2")
    check(raw_cat.shape == (len(cat_io["x"]), 2)
          and bool(np.isfinite(raw_cat).all()), "categorical margins")
    check(abs(ll_cat - ll_cat_fixture) <= LOGLOSS_TOL,
          f"categorical training logloss {ll_cat} vs the JAX fixture's "
          f"{ll_cat_fixture}")
    check(float(cat_gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"categorical mean margin gap {cat_gap.mean()}")
    check(not all(same_cat) or float(cat_gap.max()) <= MARGIN_TOL_FIXTURE,
          f"categorical max margin gap {cat_gap.max()} with all trees "
          "identical")
    check(cat_bitwise_cpu, "the categorical card fit is not bitwise the "
          "CPU fit")

    # -- 10. the ranker ------------------------------------------------------
    x_rank, y_rank, g_rank = rank_fx.rank_rows(seed=rank_fx.SEED)
    rank_table = Table({"features": x_rank, "label": y_rank,
                        "query": g_rank})
    with open(rank_fx.MODEL) as fh:
        rank_fixture = Booster.load_string(fh.read())
    rank_io = np.load(rank_fx.IO)
    q_rank, _, _ = rank_fx.rank_rows(rank_fx.QUERY_QUERIES,
                                     seed=rank_fx.QUERY_SEED)

    def rank_fit():
        return LightGBMRanker(**rank_fx.PARAMS).fit(rank_table,
                                                    device="cuda")

    reset_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    ranker = rank_fit()
    torch.cuda.synchronize()
    rank_first_s = time.perf_counter() - start
    out_rank = ranker.transform(Table({"features": q_rank}),
                                device="cuda")["prediction"]
    rank_counts = read_counts()
    rank_splits = int((ranker.booster.trees_feature >= 0).sum())
    rank_rt = Booster.load_string(ranker.booster.save_string())
    same_rank = same_trees(rank_rt, rank_fixture)
    rank_gap = np.abs(out_rank - rank_io["raw"])
    ndcg = boosting._ndcg_score(
        ranker.booster.predict_raw(x_rank, device="cuda"), y_rank, g_rank,
        rank_fx.MAX_POSITION)
    ndcg_fixture = float(rank_io["train_ndcg30"])
    qidx, qmask, _ = objectives.build_query_blocks(g_rank)
    emit({"phase": "train_ranker",
          "config": "LightGBMRanker(num_iterations=100, num_leaves=31, "
                    "learning_rate=0.1, max_position=30)",
          "fixture_jax_version": str(rank_io["jax_version"]),
          "rows": list(x_rank.shape), "queries": int(qidx.shape[0]),
          "max_query": int(qidx.shape[1]), "query_rows": len(q_rank),
          "launches": rank_counts, "splits": rank_splits,
          "trees": len(same_rank),
          "identical_trees_vs_jax_fixture": sum(same_rank),
          "first_difference": first_difference(rank_rt, rank_fixture,
                                               same_rank),
          "train_ndcg30": ndcg, "train_ndcg30_jax_fixture": ndcg_fixture,
          "ndcg_tol": NDCG_TOL,
          "margin_gap_mean": float(rank_gap.mean()),
          "margin_gap_max": float(rank_gap.max()),
          "fit_first_s": rank_first_s})
    check(rank_counts["histogram"] == 100 + rank_splits,
          f"{rank_counts['histogram']} K1 launches for {rank_splits} splits")
    check(rank_counts["bin_index_builds"] == 1,
          f"the ranker fit built {rank_counts['bin_index_builds']} bin "
          "indexes")
    check(rank_counts["forest_traverse"] >= 1,
          "transform of the ranker did not launch K2")
    check(out_rank.shape == (len(q_rank),)
          and bool(np.isfinite(out_rank).all()), "ranker margins")
    check(float(rank_gap.mean()) <= MARGIN_TOL_FIXTURE,
          f"ranker mean margin gap {rank_gap.mean()} to the JAX fixture")
    check(abs(ndcg - ndcg_fixture) <= NDCG_TOL,
          f"ranker training NDCG@30 {ndcg} vs the JAX fixture's "
          f"{ndcg_fixture}")
    check(not all(same_rank) or float(rank_gap.max()) <= MARGIN_TOL_FIXTURE,
          f"ranker max margin gap {rank_gap.max()} with all trees identical")

    # -- 11. rankers, card against CPU ----------------------------------------
    def fit_xendcg(table, device):
        """rank_xendcg through ``boosting.train``: ``LightGBMRanker``, as
        the reference's, always trains lambdarank."""
        return types.SimpleNamespace(booster=boosting.train(
            boosting.BoostParams(objective="rank_xendcg", num_iterations=8,
                                 num_leaves=31),
            table["features"], table["label"], None, table["query"],
            device=device))

    xr1, yr1, gr1 = rank_fx.rank_rows(165, 20, seed=3)
    rank_small = Table({"features": xr1, "label": yr1, "query": gr1})
    weighted_small = rank_small.with_column(
        "w", np.random.default_rng(4).random(len(yr1)) + 0.5)
    # early stopping: fewer rows, a learning rate of 0.6 and a patience of 5
    # (18 trees, best iteration 12) keep its CPU fit short
    xr2, yr2, gr2 = rank_fx.rank_rows(70, 20, seed=6)
    valid_small = Table({"features": xr2, "label": yr2, "query": gr2,
                         "valid": gr2 % 5 == 0})
    # one query of 5,000 documents among 500 of two: the dense form
    rng_d = np.random.default_rng(5)
    g_dense = np.concatenate([np.zeros(5000, np.int64),
                              1 + np.arange(1000) // 2])
    x_dense = rng_d.normal(size=(6000, 20)).astype(np.float32)
    y_dense = np.clip(np.floor(x_dense[:, 0] + rng_d.normal(size=6000) + 2),
                      0, 4)
    q_d, gmax_d = objectives.build_query_blocks(g_dense)[0].shape
    check(q_d * gmax_d * gmax_d > len(g_dense) ** 2,
          "the skewed ranker rows do not take the dense form")
    dense_table = Table({"features": x_dense, "label": y_dense,
                         "query": g_dense})

    def rank_est(**kw):
        return lambda: LightGBMRanker(num_leaves=31, **kw)

    rank_modes = [
        ("lambdarank_blocked", rank_est(num_iterations=8), rank_small,
         xr1[:2000]),
        ("lambdarank_dense_skewed", rank_est(num_iterations=10), dense_table,
         x_dense[:2000]),
        ("rank_xendcg", lambda: types.SimpleNamespace(fit=fit_xendcg),
         rank_small, xr1[:2000]),
        ("weighted", rank_est(num_iterations=8, weight_col="w"),
         weighted_small, xr1[:2000]),
        ("goss", rank_est(num_iterations=8, boosting_type="goss"),
         rank_small, xr1[:2000]),
        ("bagging_feature_fraction", rank_est(
            num_iterations=8, bagging_fraction=0.8, bagging_freq=1,
            feature_fraction=0.8), rank_small, xr1[:2000]),
        ("early_stopping_grouped_valid", rank_est(
            num_iterations=200, learning_rate=0.6, early_stopping_round=5,
            validation_indicator_col="valid"), valid_small,
         xr2[gr2 % 5 == 0]),
    ]
    rank_results = [card_and_cpu(*m) for m in rank_modes]
    emit({"phase": "train_ranker_card_vs_cpu", "margin_tol": MARGIN_TOL_CPU,
          "fits": rank_results})
    stopped = rank_results[-1]
    check(stopped["best_iteration"]["cuda"] == stopped["best_iteration"]["cpu"]
          and 0 <= stopped["best_iteration"]["cuda"] < 199,
          f"ranker early stopping: best_iteration {stopped['best_iteration']}")
    check(stopped["eval_history_max_gap"] <= 1e-6 and len(
        rank_results) == len(rank_modes),
          "the early-stopped ranker's NDCG history differs card to CPU by "
          f"{stopped['eval_history_max_gap']}")

    # -- 9. times -------------------------------------------------------
    ms = cuda_ms(lambda: forest_traverse(xd_main, *fx_planes, k=1))
    xd_large = torch.from_numpy(x_large).cuda()
    ms_large = cuda_ms(lambda: forest_traverse(xd_large, *fx_planes, k=1))
    plain_ms = cuda_ms(
        lambda: forest_traverse_reference(xd_main, *fx_planes, k=1),
        reps=3, inner=1)
    iforest_ms = cuda_ms(lambda: forest_traverse(
        cases[3][1], *if_planes, k=1, depth=if_depth, strict=True))
    transform_s = []
    table_large = Table({"features": x_large})
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.transform(table_large, device="cuda")
        transform_s.append(time.perf_counter() - start)
    breakdown = transform_breakdown(model, table_large, fx_planes)
    t_trees, m_nodes = booster.trees_feature.shape
    n_bytes = (x_main.nbytes + N_MAIN * 1 * 4
               + t_trees * m_nodes * (3 * 4 + 2 * 4))
    # operations this data needs: one compare per internal node on each
    # row's path, plus one add per (row, tree)
    leaves = booster.predict_leaf(x_main, device="cuda")
    depth = node_depths(booster.trees_feature, booster.trees_left,
                        booster.trees_right)
    n_ops = int(depth[np.arange(t_trees)[None, :], leaves].sum()
                + N_MAIN * t_trees)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    emit({"phase": "times", "shape": {"n": N_MAIN, "f": 14, "t": t_trees,
                                      "m": m_nodes, "k": 1},
          "kernel_ms": ms, "kernel_ms_1m_rows": ms_large,
          "plain_ms": plain_ms, "iforest_kernel_ms": iforest_ms,
          "bound_ms": bound_ms, "bound_bytes": n_bytes, "bound_ops": n_ops,
          "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_by": bound_by,
          "transform_1m_s": transform_s,
          "transform_rows_per_s": N_LARGE / statistics.median(transform_s),
          "transform_1m_breakdown_s": breakdown, "nvidia_smi": smi})

    # K1 at the main shape (the Adult root histogram, on the fit's index)
    # and at 1M rows, spread evenly over the bins and with 90% in one bin
    k1_ms = cuda_ms(lambda: histogram(adult_bd, adult_dd, n_bins,
                                      index=adult_index))
    k1_ms_building_index = cuda_ms(
        lambda: histogram(adult_bd, adult_dd, n_bins))
    k1_host_ms = host_ms(lambda: histogram(adult_bd, adult_dd, n_bins,
                                           index=adult_index))
    index_ms = cuda_ms(lambda: bin_index(adult_bd, n_bins))
    skewed_bd = torch.from_numpy(skewed_bins).cuda()
    skewed_index = bin_index(skewed_bd, n_bins)
    k1_ms_skewed = cuda_ms(lambda: histogram(skewed_bd, adult_dd, n_bins,
                                             index=skewed_index))
    big_np = rng.integers(0, 256, (N_LARGE, 14)).astype(np.uint8)
    big_bins = torch.from_numpy(big_np).cuda()
    big_np[rng.random(big_np.shape) < 0.9] = 200
    big_skewed = torch.from_numpy(big_np).cuda()
    big_data = torch.from_numpy(rng.normal(
        size=(N_LARGE, 3)).astype(np.float32)).cuda()
    big_index = bin_index(big_bins, 256)
    big_skewed_index = bin_index(big_skewed, 256)
    k1_ms_1m = cuda_ms(lambda: histogram(big_bins, big_data, 256,
                                         index=big_index), reps=3, inner=5)
    k1_ms_1m_skewed = cuda_ms(lambda: histogram(
        big_skewed, big_data, 256, index=big_skewed_index), reps=3, inner=5)
    index_ms_1m = cuda_ms(lambda: bin_index(big_bins, 256), reps=3, inner=5)
    k1_plain_ms = cuda_ms(
        lambda: histogram_reference(adult_bd, adult_dd, n_bins))
    n_adult, f_adult = adult_bins.shape

    def library_ms(bins, data, b):
        """One index_add_ (atomic) over the same flat ids and rows."""
        f = bins.shape[1]
        ids = (bins.long() + torch.arange(f, device="cuda")[None, :]
               * b).reshape(-1)
        flat = data[:, None, :].expand(-1, f, 3).reshape(-1, 3).contiguous()
        acc = torch.zeros((f * b, 3), device="cuda")
        return cuda_ms(lambda: acc.index_add_(0, ids, flat))

    k1_library_ms = library_ms(adult_bd, adult_dd, n_bins)
    k1_library_ms_1m = library_ms(big_bins, big_data, 256)
    k1_library_ms_1m_skewed = library_ms(big_skewed, big_data, 256)

    def k1_bound(n, f, bin_bytes, b):
        n_bytes = n * f * bin_bytes + n * 3 * 4 + f * b * 3 * 4
        n_ops = n * f * 3          # one add per (row, feature, column)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP32_OPS_PER_S * 1e3
        return {"bytes": n_bytes, "ops": n_ops,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    k1_main = k1_bound(n_adult, f_adult, adult_bins.itemsize, n_bins)
    k1_large = k1_bound(N_LARGE, 14, 1, 256)
    fit_s = [fit_first_s]
    for _ in range(TIMED_REPEATS):
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        adult_fit()
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - start)
        check(bin_index.builds == 1,
              f"a timed fit built {bin_index.builds} bin indexes")
    fit_median = statistics.median(fit_s)
    emit({"phase": "times_train", "k1_shape": {
              "n": n_adult, "f": f_adult, "b": n_bins, "bins": "uint8"},
          "k1_ms": k1_ms, "k1_ms_building_index": k1_ms_building_index,
          "k1_host_ms_per_call": k1_host_ms,
          "k1_ms_skewed_90pct": k1_ms_skewed,
          "k1_ms_1m_rows": k1_ms_1m, "k1_ms_1m_rows_skewed_90pct":
          k1_ms_1m_skewed, "bin_index_ms": index_ms,
          "bin_index_ms_1m_rows": index_ms_1m,
          "k1_plain_ms": k1_plain_ms, "k1_library_ms": k1_library_ms,
          "k1_library_ms_1m_rows": k1_library_ms_1m,
          "k1_library_ms_1m_rows_skewed_90pct": k1_library_ms_1m_skewed,
          "k1_bound": k1_main, "k1_bound_1m_rows": k1_large,
          "fit_s": fit_s,
          "fit_rows_iterations_per_s": n_adult * 100 / fit_median,
          "k1_launches_per_fit": train_counts["histogram"],
          "bin_index_builds_per_fit": train_counts["bin_index_builds"],
          "fit_breakdown": fit_breakdown(adult_fit),
          "fit_device_busy": device_busy(adult_fit), "nvidia_smi": smi})

    # the sampled fit, and the key stream and masks of one of its trees
    # (two splits of the key, the bagging draw, the feature permutation and
    # the masked index) on the card, host wall with a synchronise at the end
    sampled_s = [sampled_first_s]
    for _ in range(TIMED_REPEATS):
        reset_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        sampled_fit()
        torch.cuda.synchronize()
        sampled_s.append(time.perf_counter() - start)
    sp = boosting.BoostParams(**SAMPLED_PARAMS)
    g_card, h_card = torch.from_numpy(g0).cuda(), torch.from_numpy(h0).cuda()
    y_card = torch.from_numpy(y_adult.astype(np.float32)).cuda()
    card_index = bin_index(card_bins, n_bins)
    stream = {"rng": prng.prng_key(0, "cuda")}

    def tree_sampling():
        stream["rng"], key = prng.split(stream["rng"])
        row_key, feature_key = prng.split(key)
        boosting._sample_rows(sp, g_card, h_card, y_card, row_key)
        mask_features(card_index, card_bins, boosting._feature_keep(
            sp, card_bins.shape[1], feature_key))

    def wall_ms(fn, calls: int = 100) -> float:
        fn()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - start) / calls * 1e3

    sampled_median = statistics.median(sampled_s)
    emit({"phase": "times_sampled", "config": SAMPLED_PARAMS,
          "fit_s": sampled_s,
          "fit_rows_iterations_per_s": n_adult * 100 / sampled_median,
          "plain_fit_s": fit_s,
          "sampled_over_plain_median": sampled_median / fit_median,
          "sampling_ms_per_tree": wall_ms(tree_sampling),
          "key_split_ms": wall_ms(lambda: prng.split(stream["rng"])),
          "fit_breakdown": fit_breakdown(sampled_fit),
          "fit_device_busy": device_busy(sampled_fit), "nvidia_smi": smi})

    # the ranker and the categorical fit: seconds, rows*iterations/s, the
    # ranker's breakdown and busy share, and the gradient at its shape
    rank_s = [rank_first_s]
    cat_s = [cat_first_s]
    for _ in range(TIMED_REPEATS):
        for fit, times_s in ((rank_fit, rank_s), (cat_fit, cat_s)):
            reset_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            fit()
            torch.cuda.synchronize()
            times_s.append(time.perf_counter() - start)
            check(bin_index.builds == 1,
                  f"a timed fit built {bin_index.builds} bin indexes")
    qidx_d, qmask_d, qinv_d = (torch.from_numpy(a).cuda() for a in
                               objectives.build_query_blocks(g_rank))
    margins_d = torch.from_numpy(ranker.booster.predict_raw(
        x_rank, device="cuda").astype(np.float32)).cuda()
    labels_d = torch.from_numpy(y_rank.astype(np.float32)).cuda()
    grad_ms = cuda_ms(lambda: objectives.lambdarank_grad_blocked(
        margins_d, labels_d, qidx_d, qmask_d, qinv_d), reps=3, inner=5)
    zero_ms = cuda_ms(lambda: objectives.lambdarank_grad_blocked(
        torch.zeros_like(margins_d), labels_d, qidx_d, qmask_d, qinv_d),
        reps=3, inner=5)
    rank_median = statistics.median(rank_s)
    cat_median = statistics.median(cat_s)
    n_rank = len(y_rank)
    emit({"phase": "times_ranker",
          "rows": list(x_rank.shape), "queries": int(qidx.shape[0]),
          "pairs_per_gradient": int(qidx.shape[0] * qidx.shape[1] ** 2),
          "fit_s": rank_s,
          "fit_rows_iterations_per_s": n_rank * 100 / rank_median,
          "k1_launches_per_fit": rank_counts["histogram"],
          "lambdarank_grad_ms": grad_ms,
          "lambdarank_grad_ms_at_init_margins": zero_ms,
          "fit_breakdown": fit_breakdown(rank_fit),
          "fit_device_busy": device_busy(rank_fit),
          "categorical_fit_s": cat_s,
          "categorical_fit_rows_iterations_per_s":
              len(y_cat) * 100 / cat_median,
          "categorical_over_plain_median": cat_median / fit_median,
          "nvidia_smi": smi})

    # -- 13-15. data-parallel training: two ranks sharing the card --------
    dp = dp_phases(x_adult, y_adult, fit_s, fit_median, smi)
    dp_counts = dp["counts"]

    # -- 16-19. the data plane: partition streams, rendezvous, launcher ---
    part_counts = partition_phases(x_adult, y_adult, dp["params"], dp, smi)

    # -- 20-21. the imported-ONNX forward: ResNet-50, the torch graphs ----
    onnx_phases(smi, reset_counts, read_counts)

    # -- 22-23. transformer and recurrent graphs: encoder, decoder, BiLSTM -
    transformer_counts = transformer_phases(smi, reset_counts, read_counts)

    # -- 24. ONNXModel over ResNet-50 on the batched executor ------------
    eager_model = onnx_model_phase(smi, reset_counts, read_counts)
    model_counts = eager_model["counts"]

    # -- 25. ONNXModel warmed: CUDA graphs per bucket, the store, sentinel -
    warm_counts = onnx_model_warmup_phase(smi, reset_counts, read_counts,
                                          eager_model)
    del eager_model

    # -- 26. image stages, ImageFeaturizer, the transfer head -------------
    image_counts = image_phase(smi, reset_counts, read_counts)

    # -- 27. local explainers over K2 and over ResNet-50 ------------------
    explainer_counts = explainer_phase(smi, reset_counts, read_counts)

    # -- 28. control flow and CNTKModel: Scan, the CNTK 202 tagger -------
    cntk_counts = cntk_phase(smi, reset_counts, read_counts)

    # -- 29. the serving entry: ResNet-50 from warm graphs, K2 served -----
    served = serving_phase(smi, reset_counts, read_counts)
    serving_counts = served["counts"]

    # -- 30. converted LightGBM: the ai.onnx.ml ops, the examples, served -
    resnet_bucket_phase(smi)
    converted = converted_lgbm_phase(smi, reset_counts, read_counts)

    # -- 31. the MoE sequence tagger: the example's flow, default width ---
    tagger_counts = tagger_phase(smi, reset_counts, read_counts)

    # -- 32. decode serving: the wide GQA decoder from warm CUDA graphs ---
    decode_counts = decode_phase(smi, reset_counts, read_counts)

    # -- 33. the ONNX indexing and loss ops: the masked-LM head -----------
    mlm_counts = mlm_phase(smi, reset_counts, read_counts)

    # -- 34. the ONNX dense-image ops: Stable Diffusion's VAE decoder -----
    vae_counts = vae_phase(smi, reset_counts, read_counts)

    # -- 35. the ONNX detection ops: Faster R-CNN's second stage ---------
    detection_counts = detection_phase(smi, reset_counts, read_counts)

    # -- 36. the ONNX random ops: Stable Diffusion's VAE encoder ---------
    random_counts = random_phase(smi, reset_counts, read_counts)

    # -- 37. the ONNX sequence and string ops: a 20 Newsgroups classifier -
    sequence_counts = sequence_string_phase(smi, reset_counts, read_counts)

    # -- 38. the ONNX signal ops: Whisper's log-mel, the speech chain -----
    speech_counts = speech_phase(smi, reset_counts, read_counts)

    # -- 39. DistributedServer: channels sharing the card, breakers ------
    dist_counts = distributed_serving_phase(
        smi, reset_counts, read_counts,
        continuous_adult_rps=served["adult_requests_per_s"])

    # -- 40. devices= data parallelism: slots sharing the card -------------
    dp_layout_counts = dp_layouts_phase(smi, reset_counts, read_counts)

    # -- 41. the int8 QOperator ops and the measured lanes ----------------
    quant_counts = quantized_phase(smi, reset_counts, read_counts)

    # -- 42. sequence parallelism: ranks sharing the card ----------------
    sp_counts = sequence_parallel_phase(smi, reset_counts, read_counts)

    emit({"kernels": [{
        "name": "forest_traverse", "route": "cuda",
        "source": "synapseml_tpu_torch/csrc/forest_traverse.cu",
        "replaces": "synapseml_tpu/gbdt/pallas_kernels.py:179",
        "launches": launches, "launches_ranker_fit":
        rank_counts["forest_traverse"], "launches_categorical_fit":
        cat_counts["forest_traverse"], "launches_dp_fit_per_rank":
        [c["forest_traverse"] for c in dp_counts],
        "launches_partitions_fit_per_rank":
        [c["forest_traverse"] for c in part_counts],
        "launches_onnx_transformer_paths": {
            k: c["forest_traverse"] for k, c in transformer_counts.items()},
        "launches_onnx_model_path": model_counts["forest_traverse"],
        "launches_onnx_warmup_path": warm_counts["forest_traverse"],
        "launches_image_featurizer":
        image_counts["featurize"]["forest_traverse"],
        "launches_image_head": image_counts["head_score"]["forest_traverse"],
        "launches_explainer_path": {
            k: c["forest_traverse"] for k, c in explainer_counts.items()},
        "launches_cntk_path": cntk_counts["forest_traverse"],
        "launches_serving_path": serving_counts["forest_traverse"],
        "launches_converted_path": {
            k: c["forest_traverse"] for k, c in converted.items()},
        "launches_tagger_path": tagger_counts["forest_traverse"],
        "launches_decode_path": decode_counts["forest_traverse"],
        "launches_mlm_path": mlm_counts["forest_traverse"],
        "launches_vae_path": vae_counts["forest_traverse"],
        "launches_detection_path": detection_counts["forest_traverse"],
        "launches_random_path": random_counts["forest_traverse"],
        "launches_sequence_string_path": sequence_counts["forest_traverse"],
        "launches_signal_speech_path": speech_counts["forest_traverse"],
        "launches_distributed_serving_path": dist_counts["forest_traverse"],
        "launches_dp_layouts_path": dp_layout_counts["forest_traverse"],
        "launches_quantized_path": quant_counts["forest_traverse"],
        "launches_sequence_parallel_path": sp_counts["forest_traverse"],
        "max_abs_err": max_err, "bitwise": True,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}, {
        "name": "histogram", "route": "cuda",
        "source": "synapseml_tpu_torch/csrc/histogram.cu",
        "replaces": "synapseml_tpu/gbdt/pallas_kernels.py:79",
        "launches": train_counts["histogram"],
        "launches_sampled_fit": sampled_counts["histogram"],
        "launches_ranker_fit": rank_counts["histogram"],
        "launches_categorical_fit": cat_counts["histogram"],
        "launches_dp_fit_per_rank": [c["histogram"] for c in dp_counts],
        "launches_partitions_fit_per_rank":
        [c["histogram"] for c in part_counts],
        "launches_onnx_transformer_paths": {
            k: c["histogram"] for k, c in transformer_counts.items()},
        "launches_onnx_model_path": model_counts["histogram"],
        "launches_onnx_warmup_path": warm_counts["histogram"],
        "launches_image_featurizer": image_counts["featurize"]["histogram"],
        "launches_image_head_fit": image_counts["head_fit"]["histogram"],
        "launches_explainer_path": {
            k: c["histogram"] for k, c in explainer_counts.items()},
        "launches_cntk_path": cntk_counts["histogram"],
        "launches_serving_path": serving_counts["histogram"],
        "launches_converted_path": {
            k: c["histogram"] for k, c in converted.items()},
        "launches_tagger_path": tagger_counts["histogram"],
        "launches_decode_path": decode_counts["histogram"],
        "launches_mlm_path": mlm_counts["histogram"],
        "launches_vae_path": vae_counts["histogram"],
        "launches_detection_path": detection_counts["histogram"],
        "launches_random_path": random_counts["histogram"],
        "launches_sequence_string_path": sequence_counts["histogram"],
        "launches_signal_speech_path": speech_counts["histogram"],
        "launches_distributed_serving_path": dist_counts["histogram"],
        "launches_dp_layouts_path": dp_layout_counts["histogram"],
        "launches_quantized_path": quant_counts["histogram"],
        "launches_sequence_parallel_path": sp_counts["histogram"],
        "max_abs_err": k1_max_err,
        "bitwise": True, "ms": k1_ms, "plain_ms": k1_plain_ms,
        "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
        "library_ms": k1_library_ms}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
