#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card, check it and time it.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --selection [--root DIR] [--only NAME ...]
                                   # the top-k selection alone (see
                                   # `selection_main`)

Phases (any failure raises and exits non-zero):
  1. the card, as nvidia-smi names it, with its power limit;
  2. build every CUDA kernel of the port from `recbox_tpu_torch/csrc/`
     (one nvcc per source, all started together) into `build/kernels/`,
     and beside them the host library of `native/*.cpp` (g++) into
     `build/native/`;
     each kernel's registers and spills as ptxas gives them (B4's
     wgmma and segment routes at D = 64 and 128, whose packed
     instantiations are B3's stage (a), B5's selection, B3's selection
     with its epilogue, the selection's global-memory mode in both
     libraries, B2's ce_fwd / ce_bwd at depth 64 and 128, B1 and B6 must
     spill nothing);
  3. every kernel against its plain PyTorch version on the card: the MIPS
     top-k (B3) on N(0, 1) data at a small shape, the serving path's shape
     and the 1M x 128 shape (f32 and the small shape on B4's tile route),
     and, on integer data bit for bit with one launch of each stage a call,
     at the sweep of 1, 8, 20, 64, 256, 600 and 910 queries over 1M x 64
     (and 20, 600 over 1M x 128; JAX's plans of 9 to 256 segments, on the
     segment route) and 911, 1024 (on the wgmma route); B3 on integer
     data bit for bit, bf16 and int8, on the wgmma route: at 1M x 64 and
     1M x 128, at
     each plan of the route over 50,000 x 300, and over a corpus of repeated
     blocks whose tied winners must come out position ascending; the packed
     AdaGrad update (B1) at the Criteo training shape, ids uniform per field
     as `bench.py` draws them and Zipf-skewed, and at each layout of
     `B1_LAYOUTS` (every instantiation of the kernel), where the updates
     themselves are held to the plain version's;
  3b. kernel B2 (flash-CE) against its plain versions: bench.py's 1M-item
     SASRec shape (B=1024, V=1M, D=64), a ragged one (1000, 100,003, 100),
     B = 200, 500, 1500 and 8192 at V = 100,003 (clusters of one and two
     blocks, a ragged pass, eight passes), D = 128 at B = 1024, weights with
     zeros, all-160 and all--40 logits, the multinomial variant (B=256,
     V=100,000, 20 positives); each kernel call twice, bit for bit;
  3c. the candidate kernels and the sequence pool against their plain
     versions: B4 (`mips_segment_candidates`, packed bf16, packed int8,
     unpacked bf16) at the profiling shape of `tools/prof_mips_batched.py`
     (N=1M, D=128, Q=8192, the 1024-query plan, on the wgmma route) and at
     D = 64,
     integer-valued inputs bit for bit and N(0, 1) ones up to packed
     near-ties; every instantiation (f32 too) on integer data at 3000 rows
     x 20 queries (packed f32 on the tile route split into runs merged by
     atomic max, packed bf16 and int8 on the segment route over the corpus
     padded to whole segments), 100,000 x 1024 and 100,000 x 300 (27
     segments, the last rows through the segment route's shifted view),
     and bf16 packed and unpacked and
     int8 at each plan of the wgmma route (query tiles of 8192, 4096, 2048
     and 1024: 1, 2, 4 and 8 segments a sub-chunk) over 50,000 rows x 300
     queries at D = 128 and 64, bit for bit; B5 (the radix selection) at
     the merge-only (7812, 1024) shape, k=500 and 100, the full path's
     (7936, 8192) with ties, the merge-only shape row-major (ids and
     positions), a windowed (40,000, 64) with ties and k = C at 16384, bit
     for bit; B6 (`seq_embedding_pool`) at V=1M, B=8192, L=50, D=128
     (mean, sum) and 64 over Zipf ids with ~20% pads and rows of pads, over
     uniform ids (D=128 and 64), and with ids out of range (NaN rows on
     both), each call repeated bit for bit;
  4. the serving path: a YoutubeDNN at the repository's width
     (`configs/models/youtubednn.yaml`: dim 64, MLP 256-128-64, 1M users,
     1M items, 50-long histories) with random weights from a seed, behind a
     `RetrievalService(method="auto")` over the whole 1M-item corpus,
     queried for 8192 users at k=500 from a bf16 and from an int8 corpus,
     with the kernel launch counts reset just before and read just after
     (each query one launch of B3's stage (a) on the wgmma route and one of
     its selection); recall against an exact bf16 top-k oracle; successive
     results in memory of their own; seen-item exclusion;
  4a. small requests: 64 requests of 32 users a corpus through
     `RetrievalService.query`, counts reset just before and read just after
     (one selection and one segment-route stage (a) a request), wall ms a
     request, one request under torch.profiler (device ms, idle share),
     recall@500 against the exact top-k (>= 0.95 bf16, >= 0.90 int8);
  4b. the candidate paths, with B4 (by variant and by route), B5 and B6's
     counts reset just before and read just after: `pallas_mips_topk` at
     B4's shape packed (default merge), unpacked through B5
     (`merge='bitonic'`, ids equal to the exact merge's) and over int8 rows,
     recall against an exact f32 top-k over 512 queries, every call on
     B4's wgmma route; `seq_embedding_pool` at B6's shapes; then each
     `pallas_mips_topk` call timed (ms per 8192 queries, median of 3)
     beside its candidate generation alone; then the rest of
     `BruteForceMIPS` behind `RetrievalService` on phase 4's corpus
     ('refined', int8 'approx', int8 'refined'), recall against an exact
     f32 oracle, refined scores against the f32 dot products, queries/s;
  5. the training path: `PackedEmbeddingTrainer(DeepFM)` at `bench.py`'s
     Criteo width (26 categorical fields of 100,000 ids, 13 numeric, dim
     64, MLP 1024-512-256, feature-major, bf16 compute, batch 32768) on a
     label drawn from a fixed random logistic model over four fields, with
     B1's launch count reset just before and read just after; falling
     loss, examples/s, one step under torch.profiler, held-out AUC/logloss;
  5b. the sequential training path: `Trainer(SASRec,
     train_method='fused_ce_loss')` at `bench.py`'s 1M-item shape (V=1M,
     L=50, d=64, 2 layers, 2 heads, dropout 0.1, bf16, batch 1024, Adam
     1e-3 with clip 10), 3 + 12 steps on one batch with B2's counts reset
     just before and read just after (one forward and one backward a
     step), falling loss, examples/s, one step under torch.profiler; the
     CPU Markov learning test trained on the card (hit@1 > 0.8); the 60k
     regime through `full_scores` against `fused_ce_loss`;
  5c. training to a result, DeepFM: phase 5's trainer through `fit` for 2
     epochs of 24 batches (phase 5's logistic label), 8 steps a
     `train_steps_fused` call (one CUDA graph of the step, replayed a
     step), `CTREvaluator` (AUC, logloss) on 4 held-out batches, B1's
     count reset just before and read just after (one launch a step); a
     plateau forced at the second evaluation, after which the lr and the
     embedding lr are a tenth and the step, captured again, moves the pack
     and the weights as an eager step at the new lr does; `save`, `load`
     into a fresh trainer, `predict` bit for bit; checkpoint bytes and
     seconds, capture and `_capture_best` seconds; held-out AUC above 0.5
     at the best evaluation; ms a step of eager `train_step` against replayed
     steps on the same batches, 6 blocks of 8 steps a side in turns; one
     fused step under torch.profiler;
  5d. training to a result, SASRec at V = 1M: phase 5b's trainer through
     `fit` for 2 epochs of 16 batches (drawn as `bench.py:434-438` draws
     one), 8 steps a fused call, `evaluate_retrieval` each epoch over 4096
     held-out users (full sort over the 1M items, chunks clamped to 268
     users), B2's counts reset just before and read just after (one
     forward and one backward a step); two replays draw different dropout
     masks; a replayed step and an eager one with the same dropout draws
     give the same loss and move the 1M x 64 table and an encoder weight
     alike; eager against fused ms a step (as in 5c); one fused step
     profiled;
  5e. the quality exits on the card: `recbox_tpu_torch.tools.quality_exit`
     (the JAX package's DeepFM synthctr and SASRec synthseq parity runs,
     and DCNv2 / xDeepFM in DeepFM's place) at seeds 2024, 1, 2
     (`CARD_EXIT_SEEDS`), valid and test metrics a seed and the medians of
     the test metrics; then SASRec at seed 2024 through B2's loss and
     8-step graphs, one B2 forward and backward a step, its test metrics
     within 0.02 of the median of the three;
  5f. matching from training to serving: LightGCN at `bench.py`'s width
     (30,000 users, 41,000 items, 1M interactions with 64 planted blocks,
     90% of a user's items from its block, the blocks scattered over the
     ids; 10% of each user's items held out; d = 64, 3 hops), trained by
     `fit` for 2 epochs of `MatchingLoader` batches (2048 rows, one
     uniform negative drawn anew each epoch) under BPR and Adam 1e-3, 8
     steps a `train_steps_fused` call (one CUDA graph of the step);
     `RetrievalEvaluator` (Recall@20, NDCG@20, full sort) over 4096
     held-out users each epoch, the last above 10x chance (20 / 41,000),
     then once with protocol 'uni100'; eager against replayed ms a step
     (6 blocks of 8 steps a side, in turns) and one replayed step profiled
     (the hops' gathers and `index_add_` beside Adam); then
     `RetrievalService.from_trainer` over the trained towers, queried for
     8192 users at k = 20 from a bf16 and an int8 corpus, B3's and B4's
     counts reset just before and read just after each query (one stage
     (a) launch on the `wgmma` route and one selection a query), recall
     against an exact bf16 top-k over 512 users (>= 0.95 / 0.90),
     queries/s, and B3 timed and checked against its plain version at this
     shape;
  5g. matching on the card: `SparseEmbeddingTrainer(MF)` through 16 eager
     steps against two 8-step `train_steps_fused` calls (a CUDA graph) from
     the same weights, then served by `RetrievalService.from_trainer`; the
     matching exits, `tools/quality_exit.py`'s MF-BPR and LightGCN on synth
     at seeds 2024, 1, 2, 3, 4 and MF-BPR on ml1m_scale at seed 2024 (1
     epoch, `ML1M_EXIT_EPOCHS`), valid and test metrics a seed and the
     medians;
  5h. the CTR zoo through B1 at the Criteo width (phase 5's 26 + 13
     fields, batch 32768, the logistic label of phase 5):
     `run_ranking_experiment` over DCNv2 at `configs/models/dcnv2.yaml`'s
     widths (dim 16, f32, 3 cross layers, MLP 400-400, 'parallel') with
     `trainer: packed`, 1 epoch of 24 batches at 8 steps a fused call,
     `CTREvaluator` on 4 held-out batches (AUC above 0.5), B1's count
     reset just before and read just after (one launch a step); the same
     `PackedEmbeddingTrainer(DCNv2)` eager against replayed (6 blocks of 8
     steps a side, in turns), a replayed step equal to an eager one (the
     pack and a cross weight), one replayed step profiled (GEMMs, the
     gather, B1, copies, elementwise; idle share); B1 at DCNv2's one-slot
     layout checked and timed against its plain version, its bound and
     `index_add_`; xDeepFM at `configs/models/xdeepfm.yaml`'s widths for
     16 steps (falling loss, one B1 launch a step, ms a replayed step),
     and B1 at its 16 + 1 layout checked and timed as the one-slot one;
  5i. the cascade on the card: `run_cascade_experiment("ml1m_scale",
     matcher="MF", ranker="DCN", reranker="PRM")` over ml1m_scale (6040 x
     3706, 834,915 interactions) at `tools/cascade_ml1m_scale.py`'s knobs,
     seed 2024: every metric and the seconds of each stage;
  5j. the sequential stage from the user's first call: (1) BERT4Rec at
     `configs/models/bert4rec.yaml`'s widths (d 64, 2 layers, 2 heads, L
     50, dropout 0.2), bf16, over 1M items, through
     `recbox_tpu_torch.run.main` on a pre-encoded config dir written here
     (`FeatureMap.save`, npz splits of Zipf draws with a planted next
     item, 2 epochs of 32 batches of 1024, 8 steps a graph replay, 2048
     valid and test rows), B2's counts reset just before and read just
     after: the route `_use_fused_ce` took, one forward and one backward
     launch a step, a falling loss, test Recall@10 above chance, the
     seconds of fit and evaluation, eager against replayed ms a step,
     and the replayed step with the history gathered by `F.embedding`
     (the port's) against indexing;
     (2) `fused_cloze_loss`'s B2 call at B·P = 10,240 over V = 1M with a
     tenth of the weights 0: B2's sweeps against their plain versions at
     that shape, and the whole call against the call on the plain sweeps
     (loss, gradients of the states and of the (V + 1)-row table, the
     [MASK] row's exactly 0, two calls bit for bit), timed beside its
     bound and weighted F.cross_entropy over the logits; (3) the other 19
     sequential models through `run_sequential_experiment` at their
     `configs/models/*.yaml` widths over V = 20,000 (1 epoch of 16
     batches of 256, ``fused_ce: True``): falling loss, the route (CORE
     and RepeatNet keep `full_scores`), B2's launches, B2 against its
     plain version on each kernel-route model's operands (D = 64, 65 /
     66 padded to 80, 128), ms a step; (4) `run_experiment(
     "SASRec", "ml1m_scale", epochs=1)` over 5i's files: seconds of data,
     fit and test, and the metrics;
  5k. sequence CTR at Taobao UserBehavior's vocabularies (987,994 users,
     4,162,024 items + PAD, 9,439 categories, 50-long shared-table
     histories): DIN at din.yaml's widths through `run_ranking_experiment(
     trainer: packed)`, 2 epochs of 24 batches of 4096, 8 steps a fused
     call: one B1 launch a step, a falling loss, held-out AUC > 0.6;
     eager against replayed ms a step, a replayed step equal to an eager
     one (the pack and the Dice statistics), one replayed step profiled;
     B1 against its plain version on one step's own 4096 x 53 ids and
     gradients over the 5.16M-row pack, PAD runs included, and timed;
     BST, DIEN (with its auxiliary loss on a neg_hist column) and DSIN:
     8 eager steps on one batch, a falling loss, ms a step;
  5l. the multitask models at the Criteo width (26 x 100,000 ids, 13
     numeric, dim 16; click and a conversion only where click is 1): MMOE
     through `run_ranking_experiment(trainer: packed)`, 2 epochs of 16
     batches of 32768, B1 once a step, both tasks' AUC > 0.5;
     SharedBottom, PLE, ESMM, AITM: 8 eager steps on one batch each,
     ESMM's pCTCVR <= pCTR;
  5m. the 19 models of ctr_extended.py, DAGFM and KD_DAGFM (distilled from
     a DCNv2 teacher) at their yaml widths over 5l's schema under the
     packed trainer, 8 eager steps on one batch of 4096 each; S3Rec at
     s3rec.yaml's widths over a synthetic Amazon Beauty (22,363 users,
     12,101 items, 1,221 attributes): 1 pretraining epoch (the joint
     loss on a fixed probe falls), the graft, a fine-tune through
     `run_sequential_experiment` with test Recall@10 above chance;
     GRU4RecF with a feat_seq column: 8 eager steps, a falling loss;
  5n. the matching stage's remainder: ComiRec-SA and MIND at their yaml
     widths (d 64, L 50, 4 interests) over the 1M-item catalog through
     `run_matching_experiment` (1 epoch of 16 batches of 2048, 10
     negatives; histories of Zipf(1.2) ranks inside 2-4 planted clusters
     a user, each cluster's ids scattered over the catalog), validation
     Recall@20 over 4096 users above chance; `RetrievalService.
     from_trainer` serving 8192 users at k = 500 through B3's
     multi-interest route (32,768 query rows), ComiRec from bf16 and int8
     corpora and MIND from bf16, B3's counts reset just before and read
     just after each query (one launch of each stage), recall against an
     exact max-over-interests top-k (>= 0.95 / 0.90), queries/s, the
     device's idle share; B3 alone at 32,768 x 1M x 64, k = 500 against
     its plain version and timed; then 8 eager steps on one batch each
     (a falling loss, never above 3x the first) of SimpleX, YoutubeSBC
     (1M items), MultiVAE, MacridVAE, CDAE, RaCT (actor, then critic) at
     ML-20M's 20,108 items, SGL, NCL, DGCF, SpectralCF, GCMC, LINE on
     5f's data, Item2Vec; RecVAE through `RecVAETrainer` for one epoch;
  5o. the knowledge stage: `run_experiment("CKE")` over staged atomic
     files (ml1m_scale's interactions, a synthetic KG of genre, director,
     actor and year triples), KGAT at kgat.yaml's widths through
     `run_kg_experiment` on the collaborative KG, both Recall@20 above
     chance; CFKG, KTUP, MKR, KGCN, KGNNLS, RippleNet, KGIN, MCCLK and
     KSR: 8 eager steps each, KGNNLS / KGIN / MCCLK on BPR plus their own
     term (KGNNLS's losses differ from KGCN's), then 8 eager steps of the
     ``kg_loss`` of CFKG, KTUP, MKR and RippleNet;
  5p. the packed trainer's other layouts and the registry's rest: phase
     5's DeepFM (bench.py's 26 x 100,000 ids, 13 numeric, dim 64, batch
     32,768, bf16) with `block_rows=True`, confirmed in block mode: 16
     steps in two 8-step fused calls (one B1 launch a step, a falling
     loss), B1 on one step's own block gradients against its plain
     version and timed, a replayed step equal to an eager one, one block
     step against the per-feature path's on the same batch (an f32 pair
     of trainers from an accumulator of 0.1, the loss within 1e-5, the
     packs within 1e-3 of the update), eager and replayed ms a step and
     one replayed step under torch.profiler by group; DeepFM at
     deepfm.yaml's widths through `run_ranking_experiment(trainer: packed,
     embedding_optimizer: adam)` (1 epoch of 16 batches; held-out AUC above
     0.5, a falling loss, the [values | m | v] pack 3 x 17 -> 128 wide, no
     B1 launch); DCNv2 at dcnv2.yaml's widths with embedding_dim 128 (the
     split-accumulator layout): 16 eager steps, a falling loss, ``accs``
     equal to the squared-gradient row means accumulated over the steps'
     ids, no B1 launch, ms a step; EGR and EGREvaluator through
     `run_rerank_experiment` over 16,384 training and 4,096 validation
     lists of 30 slots x 65 features (clicks from a planted linear
     scorer; NDCG@10 above the random order's), a PPO loop (8 updates of
     rollouts from a frozen old policy, `ppo_loss` under Adam; the mean
     list reward rises) and EGR's generator loop (REINFORCE on the trained
     evaluator's `list_value`, 8 updates), ms a rollout and an update;
     `get_model` for all 125 names; LambdaMART (10 trees, depth 4) on
     200 lists, its NDCG@10 against the ranker-score column's order;
  5q. the data and features pipeline at phase 5's width: 1,048,576 raw
     rows in the Criteo Display Advertising Challenge's layout (a label,
     13 counts log-normal with 20% missing, 26 fields of 8-hex-digit
     tokens drawn Zipf(1.1) over 400,000 a field, some empty; clicks from
     a planted logistic model over the raw tokens of four fields) and
     65,536 held out, through `FeatureEncoder` (its FeatureMap equal to
     phase 5's schema; every categorical column encoded by the native
     library) and `save_shards` (250,000 rows a shard); one epoch of the
     native `ShardLoader` equal to one of the numpy one bit for bit; phase
     5's trainer through `fit` over the native loader (32 steps, one B1
     launch each, counted from 0 just before; a falling loss; held-out
     AUC above 0.55 through an encoder reloaded from `save` / `load`); ms
     a streamed step beside 5c's in-memory steps, and 8 of them under
     torch.profiler (the device's idle share); B1 on one captured step of
     the path against its plain version and timed; seconds and rows/s of
     each stage;
  5r. the mesh (`recbox_tpu_torch/parallel/`): (a) a one-rank NCCL
     world in this process: 5c's trainer under `make_mesh()` against it
     without a mesh, 8 eager steps each from one state (the first loss and
     the first step's dense parameters bit for bit, the packs within B1's
     duplicate order; B1 once a step; 0 collective bytes; ms a step of
     each); (b) a two-rank gloo world on this card (two processes on
     cuda:0, collectives staged through the host): 5c's packed DeepFM
     and the generic `Trainer` over it at a global batch of 8,192, 3
     steps each against the unsharded run (loss within 1e-5; the packed
     tables, AdaGrad from 0.1, within rtol 1e-4 / atol 1e-6 on every
     entry; the generic tables, Adam, at most 2e-5 of their entries
     outside it, and a planted fault, rank 1 skipping its owned update on
     the last step, caught by that limit), the recorded bytes of a fourth
     against `predict_step_comm_bytes` (within 1%), B1 on each rank's
     owned rows;
     the sharded search over 2 x 500,000 integer-valued rows (Q = 8192,
     k = 500) merged by B5 against the unsharded exact top-k (ids equal
     but for ties, scores within 1e-6); (c) `LAT_ROW`: index_select +
     index_add_ of 851,968 ids in a 2.6M-row pack, per id;
  5t. a model's own tables row-sharded (`parallel.mesh.shard_rows`): (a)
     a one-rank NCCL world: SASRec at 1M x 50 x 64, B = 1024, bf16,
     through `full_scores`, its table marked sharded on `make_mesh()`
     against the unmeshed trainer, 6 steps each in turns (the first loss
     and every parameter after the first step bit for bit, no collective,
     ms a step of each); (b) two gloo ranks on this card, a ('data')
     mesh of 2: SASRec in f32 without dropout at a global batch of 256,
     each rank holding 500,000 rows and their Adam moments (its bytes
     against the unsharded run's), 3 steps against the unsharded run
     (losses within 1e-5, the table at 5r(b)'s Adam rule), the recorded
     bytes of a fourth against the model of `t_sasrec_comm_model` (within
     1%, no term in V), the full sort of 4,096 users over the 1M items
     through the evaluator's towers against the unsharded evaluation of
     the same weights (ids equal but for ties); MIND over the 1M items
     trained the same way and served through `RetrievalService.
     from_trainer` on a ('model') mesh of 2, B5 merging the shards' top
     100 (once a rank), against the unsharded service;
  5u. the graph and knowledge models' own tables row-sharded, in 5t(b)'s
     two gloo ranks: (a) LightGCN at 5f's width (30,000 x 41,000, 3 hops,
     d = 64, batch 2048, f32), its tables gathered whole once a forward,
     each rank holding 35,500 rows and their Adam moments, 3 steps
     against the unsharded run (5t's rules), the recorded bytes of a
     fourth (2·(U + I)·D·4 plus two scalars, within 1%, the same over the
     edge list doubled), the full sort of 4,096 users against the
     unsharded evaluation, served through `from_trainer` on a ('model')
     mesh of 2 (B5 once a rank) against the unsharded service; (b) KGAT
     through `run_kg_experiment` over 5o's staged files, one epoch of 8
     CF batches and 8 KG steps, against the unsharded run; (c) KSR's
     history on its sharded item table, one forward against the
     unsharded model;
  5s. the public surface: (a) the 14 examples of
     `recbox_tpu_torch/examples/` (the JAX package's `examples/` scripts
     written against the port's public names), each `main()` on the card
     with its script's assert, its wall seconds and the launches of every
     port kernel around it; (b) `PackedEmbeddingTrainer(direct_init=True)`
     over DeepFM at `tools/prof_bigvocab_packed.py:24-25`'s shape (26 x
     1M x 64, 13 numeric, batch 8192, AdaGrad), the model built under
     `abstract_tables()`: a 26M x 128 f32 pack and no table parameter,
     the peak allocated under the pack's bytes plus 2 GiB, 8 eager and 8
     replayed steps (finite, falling losses; B1 once a step), a replayed
     step equal to an eager one, B1 against its plain version on a step's
     own operands at this pack, and timed; (c) `segmented_mips_topk` at
     `bench.py:244-262`'s shape (1M x 128, Q = 8192, k = 500): two B5
     launches a query chunk (the first over 8 x 125,000-item segments on
     the selection's streaming path), the result against the function on B5's
     plain version (ids equal but for ties, scores within rtol 1e-6),
     recall against the exact top-k >= 0.99, timed beside cuBLAS +
     `torch.topk` and its bound;
  5v. selection past one 16384-key window (B5's and B3's stage (b)
     streaming path and global-memory mode) and the contrastive terms over
     the global batch: (a) `BruteForceMIPS` 'auto' over 16,777,216 x 64
     N(0, 1) items, bf16 and int8, 1024 users at k = 10,000 (B3: 131,072
     winners a query) and at k = 500, the counts reset just before and
     read just after each served call (one stage (a) and one selection,
     in the global-memory mode / on the streaming path), held to B3's
     plain version as phase 3 holds it, timed with each stage alone beside
     its bound, `torch.topk` over the winners, its plain version and
     cuBLAS + `torch.topk`; (b) B5 alone at (Q, C) = (1024, 131,072) over
     bf16-rounded scores (ties) at k = 10,000 and 65,536, bit for bit
     against its plain version, timed beside `torch.topk` and the byte
     bound; and both paths, row-major and candidate-major, bit for bit on
     rows ascending, all equal, with -inf tails and with NaN entries;
     (c) in 5r(b)'s ranks, the sharded
     search over 2 x 1M integer rows x 64 at k = 10,000 (B5 merges 20,000
     candidates a query, once a rank) against the unsharded exact search;
     (d) in 5t(b)'s ranks, the gradient of the step's objective and one
     Adam step each of YoutubeSBC at 5n's width (in-batch negatives over
     the global batch), SGL and NCL at 5f's LightGCN width (their InfoNCE
     sums, SGL on fixed edge masks) and MCCLK at 5u(b)'s (in-batch
     InfoNCE), against the unsharded ones on the global batch: the losses
     within 1e-5 and each gradient entry within rtol 1e-4, or 1e-4 of the
     largest (Adam's first step, lr · sign(g), would not see a term's
     weight);
  6. times with CUDA events (median after a warm-up; B5, B6 and their
     yardsticks over runs of 20 calls queued behind a spin kernel, so the
     host's launch work is not timed): each kernel, its
     plain version, one PyTorch yardstick (torch.matmul + torch.topk for
     B3, the `index_add_` scatter B1 absorbs (B1 over uniform and Zipf
     ids), a bf16 matmul into 2 GB of logits + F.cross_entropy for B2,
     cuBLAS scores + segment amax for B4, torch.topk for B5,
     F.embedding_bag for B6, over Zipf ids that stay in L2 and uniform
     ones that reach HBM; the port calls none of them), the
     bound (B2's counting its exps), B3's two stages alone and its stage (a) on
     the tile route (at the serving shape and at each point of the sweep
     but 1024 queries, the sweep over runs of 10 or 3 calls behind a spin
     kernel), B4 at D = 128 and 64 with its tile route on the same
     inputs beside its wgmma route, and the service's queries/s; one
     8192-user query of each service under torch.profiler (taken after
     phase 4, before the script's other profiler sessions; a breakdown
     that sees no device work fails), for device time by kernel, the
     results' copy to the host and the device's idle share.

Earlier lines of stdout carry the measurements as JSON; the line before
the last is the kernels' summary, the last one
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the H100's dense peaks (NVIDIA data sheet, SXM part) and HBM rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_S = 3.35e12

N_ITEMS, N_USERS, DIM, MAX_LEN, K = 1_000_000, 1_000_000, 64, 50, 500
N_QUERIES = 8192
SEED = 0

# bench.py's Criteo training shape (`bench.py:160-162`)
NUM_CAT, NUM_NUM, VOCAB, BATCH, HIDDEN = 26, 13, 100_000, 32768, \
    (1024, 512, 256)
WARMUP_STEPS, TIMED_STEPS = 3, 12
# where the segment-plan, B1 and training phases put their tensors (a CPU
# rehearsal of the script's control flow may point it elsewhere)
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_usage(log: str) -> dict:
    """Registers and spills of each entry function in an ``nvcc -Xptxas
    -v`` log: {mangled name: {"registers", "spill_stores", "spill_loads",
    "stack"}} (bytes for the last three)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[name].update(stack=nums[0], spill_stores=nums[1],
                             spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
    return out


def usage_of(logs: dict, lib: str, fragment: str) -> list:
    """`ptxas_usage` of library ``lib``'s entry functions whose (mangled)
    name holds ``fragment``, as a list of {"function", ...} entries."""
    usage = ptxas_usage(logs.get(lib, ""))
    return [{"function": name, **u} for name, u in sorted(usage.items())
            if fragment in name]


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call.
    With ``inner`` > 1, around a run of that many calls queued behind a
    ~10 ms spin kernel, divided by ``inner``: a call of tens of microseconds
    then times the device's work alone, not the host's launch work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if inner > 1:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def make_inputs(variant, n, d, nq, gen):
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    q = torch.randn(nq, d, device="cuda", generator=gen)
    c = torch.randn(n, d, device="cuda", generator=gen)
    if variant == "int8":
        c8, scale = quantize_int8(c)
        return q, c8, scale
    return q, c.to(torch.bfloat16 if variant == "bf16" else torch.float32), None


def run_plain(q, c, k, valid, scale):
    """The plain version on the inputs the kernel sees after the wrapper's
    query cast / quantization, with the wrapper's (JAX's) segment plan."""
    from recbox_tpu_torch.ops.mips_fused_topk import (
        mips_fused_topk_plain, segment_plan,
    )
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    sub, _ = segment_plan(c.dtype, c.shape[0], c.shape[1], q.shape[0], k)
    assert k <= -(-c.shape[0] // sub) * (sub // 128)
    if c.dtype == torch.int8:
        q8, qs = quantize_int8(q)
        return mips_fused_topk_plain(q8, c, k, valid, scale, qs, sub)
    return mips_fused_topk_plain(q.to(c.dtype), c, k, valid, sub_rows=sub)


def b3_counts():
    """B3's launches so far: its selection (one a call, counted by B3's
    wrapper) and its stage (a), B4's packed kernel, by route (counted by
    B4's)."""
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops import mips_topk
    return {"select": sum(fused.launches.values()),
            **mips_topk.route_launches}


def b3_route_taken(before):
    """The route of B3's stage (a) in the one call since the counts were
    ``before``; asserts that call made one launch of each stage."""
    now = b3_counts()
    diff = {key: now[key] - before[key] for key in now}
    routes = [key for key in diff if key != "select" and diff[key]]
    assert diff["select"] == 1 and len(routes) == 1 \
        and diff[routes[0]] == 1, diff
    return routes[0]


def check_kernel(variant, n, d, nq, k, gen):
    """Kernel against plain on one shape: int8 (exact s32 sums) must be
    identical; bf16/f32 per-row id sets must agree on >= 99.9% of rows and
    scores to rtol 2e-5 (another summation order can flip packed
    near-ties, whose scores differ by at most the 2^-16 packing step)."""
    from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk
    q, c, scale = make_inputs(variant, n, d, nq, gen)
    before = b3_counts()
    s, i = mips_fused_topk(q, c, k, row_scale=scale)
    route = b3_route_taken(before)
    s2, i2 = run_plain(q, c, k, n, scale)
    torch.cuda.synchronize()
    assert s.shape == (nq, k) and i.shape == (nq, k)
    assert bool(torch.isfinite(s).all()) and bool(((i >= 0) & (i < n)).all())
    same_rows = (torch.sort(i, 1).values == torch.sort(i2, 1).values
                 ).all(1).float().mean().item()
    err = (s - s2).abs().max().item()
    if variant == "int8":
        assert torch.equal(i, i2) and torch.equal(s, s2), (variant, n, d)
        tolerance = "identical ids and scores"
    else:
        assert same_rows >= 0.999, (variant, n, d, same_rows)
        torch.testing.assert_close(s, s2, rtol=2e-5, atol=1e-6)
        tolerance = "id sets on >= 99.9% of rows, scores rtol 2e-5 atol 1e-6"
    return {"variant": variant, "n": n, "d": d, "q": nq, "k": k,
            "route": route, "rows_same_ids": same_rows, "max_abs_err": err,
            "tolerance": tolerance}


def check_pad_convention(variant, gen):
    """valid_items < N with all-negative scores: pad rows never win, the
    kernel equals the plain version, exhausted slots are (-inf, -1)."""
    from recbox_tpu_torch.ops.mips_fused_topk import mips_fused_topk
    q, c, scale = make_inputs(variant, 50_000, 64, 64, gen)
    q = q.abs()
    c = -c.abs()
    for valid, k in [(45_000, 10), (3, 20)]:
        s, i = mips_fused_topk(q, c, k, valid_items=valid, row_scale=scale)
        s2, i2 = run_plain(q, c, k, valid, scale)
        live = min(valid, k)
        assert bool((i[:, :live] >= 0).all() & (i[:, :live] < valid).all())
        assert bool((i[:, live:] == -1).all())
        assert bool(torch.isneginf(s[:, live:]).all())
        assert bool((s[:, :live] < 0).all())
        assert torch.equal(torch.sort(i, 1).values, torch.sort(i2, 1).values)


def youtubednn_service_inputs():
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    fm = FeatureMap("youtubednn_1m", (
        FeatureSpec("user_id", "categorical", source="user",
                    vocab_size=N_USERS, embedding_dim=DIM),
        FeatureSpec("hist", "sequence", source="user",
                    vocab_size=N_ITEMS + 1, embedding_dim=DIM,
                    max_len=MAX_LEN, share_embedding="item_id",
                    padding_idx=N_ITEMS),
        FeatureSpec("item_id", "categorical", source="item",
                    vocab_size=N_ITEMS, embedding_dim=DIM)),
        query_index="user_id", corpus_index="item_id", num_items=N_ITEMS)
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, MAX_LEN + 1, N_QUERIES)
    hist = rng.integers(0, N_ITEMS, (N_QUERIES, MAX_LEN)).astype(np.int64)
    hist[np.arange(MAX_LEN)[None, :] >= lengths[:, None]] = N_ITEMS
    users = {"user_id": rng.integers(0, N_USERS, N_QUERIES).astype(np.int64),
             "hist": hist}
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int64)}
    return fm, users, corpus


def recall_vs_bf16_oracle(svc, users, ids, n=512, k=K):
    """Mean |ids ∩ exact| / k over the first n users; the oracle is an
    exact torch.topk over bf16 towers scored in f32."""
    with torch.no_grad():
        u = svc._encode(svc.model.encode_user,
                        {key: v[:n] for key, v in users.items()})
        items = svc.item_embs.to(torch.bfloat16).float()
        exact = torch.topk(u.to(torch.bfloat16).float() @ items.T, k,
                           dim=1).indices.cpu().numpy()
    return recall_at(ids[:n], exact)


def bound_ms(variant, n, d, nq, k):
    size = {"bf16": 2, "f32": 4, "int8": 1}[variant]
    moved = (n * d + nq * d) * size + nq * k * 8
    if variant == "int8":
        moved += n * 4
    ops = 2.0 * nq * n * d
    by_ops = ops / PEAK_OPS[variant] * 1e3
    by_bytes = moved / HBM_BYTES_S * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes \
        else "bytes"


def library_topk(q, c, scale, k, chunk=512):
    """One PyTorch formulation of the same top-k: cuBLAS scores (bf16
    matmul, or torch._int_mm for int8) and torch.topk, in query chunks.
    torch._int_mm takes more than 16 rows: a chunk of 16 queries or fewer
    is padded with zero queries to 32, whose rows are dropped before the
    top-k (their product is timed with it)."""
    out = []
    if c.dtype == torch.int8:
        from recbox_tpu_torch.ops.mips_topk import quantize_int8
        q8, qs = quantize_int8(q)
        # cuBLASLt's int8 product wants the corpus rows a multiple of 64:
        # zero rows past N, their scores dropped before the top-k
        n = c.shape[0]
        c8 = torch.nn.functional.pad(c, (0, 0, 0, -n % 64))
        for s in range(0, q.shape[0], chunk):
            qc = q8[s:s + chunk]
            m = qc.shape[0]
            if m <= 16:
                qc = torch.nn.functional.pad(qc, (0, 0, 0, 32 - m))
            sc = torch._int_mm(qc, c8.T)[:m, :n].float() * scale
            out.append(torch.topk(sc * qs[s:s + chunk, None], k, dim=1))
    else:
        qc = q.to(c.dtype)
        for s in range(0, q.shape[0], chunk):
            out.append(torch.topk(qc[s:s + chunk] @ c.T, k, dim=1))
    return out


def b3_stages(q, c, scale, k):
    """B3's two launches as separate calls on the inputs its wrapper would
    hand them: stage (a) (B4's packed kernel, on the route the wrapper
    takes) into candidate-major winners, and stage (b) (the selection with
    B3's epilogue) from them; and stage (a) forced onto B4's tile route,
    B3's first design of it, for a comparison in the same run."""
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops.mips_topk import (
        _candidates_cuda, quantize_int8,
    )
    (n, d), nq = c.shape, q.shape[0]
    sub = fused.segment_plan(c.dtype, n, d, nq, k)[0]
    q_scale = None
    if c.dtype == torch.int8:
        q, q_scale = quantize_int8(q)
    else:
        q = q.to(c.dtype)
    n_cand = -(-n // sub) * (sub // 128)
    win = torch.empty((n_cand, nq), device=c.device)
    out_s = torch.empty((nq, k), device=c.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=c.device)

    def stage_a():
        _candidates_cuda(q, c, n, True, scale, sub, win, None)

    def stage_b():
        fused.select_winners(win, q_scale, out_s, out_i, k, sub)

    stage_b.winners = win   # stage (a)'s output once stage_a has run
    return stage_a, stage_b, lambda: b4_tile_route(q, c, scale, True, sub)


def time_kernel(variant, n, d, nq, k, gen, reps=5, inputs=None,
                stages=None, inner=1):
    """B3 (both launches, through its wrapper), its plain version, the
    library formulation and the bound, medians of ``reps`` calls (B3 and
    the library over runs of ``inner`` calls behind a spin kernel); with
    ``stages`` (default: bf16 and int8 at the serving query count) also
    each stage alone (the selection over runs of 20 calls behind a spin
    kernel) and stage (a) on the tile route. ``inputs`` (q, c, scale) are
    `make_inputs`'s, drawn here by default."""
    from recbox_tpu_torch.ops.mips_fused_topk import (
        mips_fused_topk, segment_plan,
    )
    from recbox_tpu_torch.ops.mips_topk import candidate_route
    q, c, scale = inputs or make_inputs(variant, n, d, nq, gen)
    ms = cuda_ms(lambda: mips_fused_topk(q, c, k, row_scale=scale), reps,
                 inner)
    plain_ms = cuda_ms(lambda: run_plain(q, c, k, n, scale), reps)
    library_ms = cuda_ms(lambda: library_topk(q, c, scale, k), reps, inner)
    b_ms, b_by = bound_ms(variant, n, d, nq, k)
    out = {"variant": variant, "n": n, "d": d, "q": nq, "k": k, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
           "bound_by": b_by, "route": candidate_route(
               c.dtype, d, segment_plan(c.dtype, n, d, nq, k)[0])}
    if stages if stages is not None else (variant != "f32"
                                          and nq == N_QUERIES):
        stage_a, stage_b, tile_a = b3_stages(q, c, scale, k)
        out.update(stage_a_ms=cuda_ms(stage_a, inner=inner),
                   stage_b_ms=cuda_ms(stage_b, reps=11, inner=20),
                   tile_route_stage_a_ms=cuda_ms(tile_a, reps=3,
                                                 inner=inner))
    return out


# phase 4a: requests of SMALL_USERS users, SMALL_REQUESTS of them a variant
SMALL_USERS, SMALL_REQUESTS = 32, 64


def serve_small_batches(svcs, users):
    """Each service answers `SMALL_REQUESTS` requests of `SMALL_USERS`
    users (consecutive slices of phase 4's users) through
    `RetrievalService.query`: wall ms a request (to the results on the
    host), one request under the profiler (device ms; the idle share
    against the unprofiled median wall, the profiler's own beside it), B3's
    launches by stage and route with the counts set to 0 just before and
    read just after (one selection and one segment-route stage (a) a
    request), and recall@500 of the first 512 users against the exact
    top-k, held to the serving limits."""
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops import mips_topk
    reqs = [{key: v[r * SMALL_USERS:(r + 1) * SMALL_USERS]
             for key, v in users.items()} for r in range(SMALL_REQUESTS)]
    out = {}
    for name, s in svcs:
        s.query(reqs[0], k=K)                    # warm
        torch.cuda.synchronize()
        fused.reset_launches()
        mips_topk.reset_launches()
        walls, got = [], []
        for req in reqs:
            t0 = time.perf_counter()
            scores, ids = s.query(req, k=K)
            walls.append((time.perf_counter() - t0) * 1e3)
            got.append(ids)
            assert scores.shape == ids.shape == (SMALL_USERS, K)
            assert np.isfinite(scores).all() and (ids >= 0).all() \
                and (ids < N_ITEMS).all()
            assert (np.diff(scores, axis=1) <= 0).all()
        counts = b3_counts()
        assert counts == {"select": SMALL_REQUESTS, "wgmma": 0,
                          "segment": SMALL_REQUESTS, "tile": 0}, counts
        ids = np.concatenate(got)
        recall = recall_vs_bf16_oracle(
            s, {key: v[:len(ids)] for key, v in users.items()}, ids)
        assert recall >= (0.95 if name == "bf16" else 0.90), (name, recall)
        prof = breakdown(s, reqs[1])
        wall = statistics.median(walls)
        device = prof["device_ms"]
        out[name] = {"users_a_request": SMALL_USERS,
                     "requests": SMALL_REQUESTS, "k": K,
                     "wall_ms_a_request": wall,
                     "wall_ms_range": [min(walls), max(walls)],
                     "device_ms_a_request": device,
                     # against the unprofiled request's wall time
                     "idle_share": None if device is None
                     else 1 - device / wall,
                     "launches": counts, "recall_vs_exact_512": recall,
                     "profiled_request": prof}
    return out


# profiler sessions a breakdown may take before it fails for seeing no
# device work
BREAKDOWN_SESSIONS = 3


def _profiled_query(svc, users):
    """(wall ms, [(kernel, device ms, count)]) of one query under
    torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.query(users, k=K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return wall_ms, rows


def breakdown(svc, users):
    """Where one steady service query's time goes: device time by kernel
    (torch.profiler, CUPTI), the copy of the results to the host among
    them, and the device's idle share of the call's wall time. A profiler
    session now and then sees no device work at all, at any point of the
    script (once right after a session that saw 19 ms): the first session
    that sees device work is kept (``sessions`` counts them), and after
    BREAKDOWN_SESSIONS that see none the breakdown fails."""
    svc.query(users, k=K)
    torch.cuda.synchronize()
    for session in range(1, BREAKDOWN_SESSIONS + 1):
        wall_ms, rows = _profiled_query(svc, users)
        device_ms = sum(r[1] for r in rows)
        if device_ms > 0:
            break
    assert device_ms > 0, "the profiler saw no device work"
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms,
            "copy_ms": sum(ms for name, ms, _ in rows if "DtoH" in name),
            "sessions": session,
            "by_kernel": [{"name": name[:90], "ms": ms, "count": n}
                          for name, ms, n in rows[:8]]}


# B3 below 911 queries, where JAX's plan for the query tile has 9 to 256
# segments a sub-chunk and stage (a) takes the segment route: the sweep over
# 1M x 64 (and the D = 128 points), bf16 and int8; 911 and 1024 queries plan
# 8 segments and keep the wgmma route
SEG_SWEEP = (1, 8, 20, 64, 256, 600, 910)
SEG_SWEEP_D128 = (20, 600)
SEG_WGMMA = (911, 1024)


def segment_sweep_points():
    """(variant, d, nq, route) of the sweep: bf16 and int8 at D = 64 over
    `SEG_SWEEP` and `SEG_WGMMA`, and at D = 128 over `SEG_SWEEP_D128`."""
    return [(v, d, nq, "segment" if nq <= 910 else "wgmma")
            for v in ("bf16", "int8") for d in (DIM, 128)
            for nq in ((SEG_SWEEP + SEG_WGMMA) if d == DIM
                       else SEG_SWEEP_D128)]


def check_segment_plan(gen):
    """B3 at every point of the sweep (`segment_sweep_points`) over 1M
    items on integer-valued towers (every order of summation exact): ids
    and scores equal to the plain version's bit for bit, ties included,
    one launch of each stage a call, on the route the point names."""
    from recbox_tpu_torch.ops.mips_fused_topk import (
        mips_fused_topk, segment_plan,
    )
    out, corpora = [], {}
    for variant, d, nq, want in segment_sweep_points():
        if (variant, d) not in corpora:
            corpora.clear()
            corpora[variant, d] = b3_integer_inputs(
                gen, variant, N_ITEMS, d, max(SEG_SWEEP + SEG_WGMMA))
        q, c, scale = corpora[variant, d]
        q = q[:nq]
        sub, n_cand = segment_plan(c.dtype, N_ITEMS, d, nq, K)
        before = b3_counts()
        s, i = mips_fused_topk(q, c, K, row_scale=scale)
        route = b3_route_taken(before)
        s2, i2 = run_plain(q, c, K, N_ITEMS, scale)
        torch.cuda.synchronize()
        assert route == want, (variant, d, nq, route)
        assert torch.equal(i, i2) and torch.equal(s, s2), (variant, d, nq)
        assert bool(((i >= 0) & (i < N_ITEMS)).all())
        out.append({"variant": variant, "d": d, "q": nq, "sub_rows": sub,
                    "segments": sub // 128, "candidates": n_cand,
                    "route": route, "launches_a_call": 1,
                    "bits_equal": True, "max_abs_err": 0.0})
        del s, i, s2, i2
    return out


def time_segment_sweep(gen):
    """`time_kernel` at every point of the sweep but 1024 queries (N(0, 1)
    towers, one draw a (variant, depth) sliced to each query count): B3,
    its stages, stage (a) on the tile route, plain, library, bound; the
    device's time over runs of 10 calls behind a spin kernel up to 64
    queries (calls of ~0.1 ms), of 3 above."""
    out, drawn = [], {}
    for variant, d, nq, _ in segment_sweep_points():
        if nq == 1024:
            continue
        if (variant, d) not in drawn:
            drawn.clear()
            drawn[variant, d] = make_inputs(variant, N_ITEMS, d,
                                            max(SEG_SWEEP + SEG_WGMMA), gen)
        q, c, scale = drawn[variant, d]
        out.append(time_kernel(variant, N_ITEMS, d, nq, K, gen,
                               inputs=(q[:nq], c, scale), stages=True,
                               inner=10 if nq <= 64 else 3))
    return out


# B3 on integer-valued towers: the serving shape at D = 64 and 128; each
# plan of the wgmma route (`B4_PLAN_TILES`) over 50,000 rows x 300 queries;
# a corpus of one 1024-row block repeated 128 times, at 1024 queries
B3_TIES = (131_072, 1024)


def b3_integer_inputs(gen, variant, n, d, nq, period=None):
    """Integer-valued queries (f32, as the service hands them over) and a
    bf16 or int8 (`quantize_int8`) corpus; with ``period`` the corpus
    repeats its first ``period`` rows."""
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    q = torch.randint(-4, 5, (nq, d), generator=gen, device=DEVICE).float()
    c = torch.randint(-4, 5, (period or n, d), generator=gen,
                      device=DEVICE).float()
    if period:
        c = c.repeat(n // period, 1)
    if variant == "int8":
        c8, scale = quantize_int8(c)
        return q, c8, scale
    return q, c.to(torch.bfloat16), None


def check_b3_integer(gen):
    """B3 against its plain version on integer-valued data, bit for bit in
    ids and scores, bf16 and int8, each call on the wgmma route with one
    launch of each stage: the serving shape (1M x 64 and 1M x 128, Q=8192,
    k=500); each plan of the route (query tiles of 8192, 4096, 2048, 1024:
    1, 2, 4, 8 segments a sub-chunk) over 50,000 x 300 with the last 37
    rows past valid_items, k=100; and `B3_TIES`, where every packed winner
    recurs in all 128 sub-chunks, so the top 500 are runs of equal packed
    winners that must come out candidate position ascending."""
    from recbox_tpu_torch.ops.mips_fused_topk import (
        _mips_fused_topk_cuda, mips_fused_topk_plain, segment_plan,
    )
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    cases = [("serving", N_ITEMS, d, N_QUERIES, K, None) for d in (DIM, 128)]
    cases += [("plan", B4_PLAN_SHAPE[0], DIM, B4_PLAN_SHAPE[1], 100, tile)
              for tile in B4_PLAN_TILES]
    cases += [("ties", B3_TIES[0], DIM, B3_TIES[1], K, None)]
    out = []
    for kind, n, d, nq, k, tile in cases:
        for variant in ("bf16", "int8"):
            q, c, scale = b3_integer_inputs(gen, variant, n, d, nq,
                                            1024 if kind == "ties" else None)
            valid = n - 37 if kind == "plan" else n
            sub = segment_plan(c.dtype, n, d, tile or nq, k,
                               query_tile=tile or 1024)[0]
            if variant == "int8":
                q, q_scale = quantize_int8(q)
            else:
                q, q_scale = q.to(c.dtype), None
            before = b3_counts()
            s, i = _mips_fused_topk_cuda(q, c, k, valid, scale, q_scale, sub)
            route = b3_route_taken(before)
            s2, i2 = mips_fused_topk_plain(q, c, k, valid, scale, q_scale,
                                           sub)
            torch.cuda.synchronize()
            assert route == "wgmma", (kind, variant, d, route)
            assert torch.equal(s, s2) and torch.equal(i, i2), \
                (kind, variant, d, tile)
            res = {"case": kind, "variant": variant, "n": n, "d": d, "q": nq,
                   "k": k, "sub_rows": sub, "route": route,
                   "bits_equal": True, "max_abs_err": 0.0}
            if kind == "ties":
                # equal packed winners (score and in-segment index) ascend
                # by candidate position
                n_seg = sub // 128
                idx = (i % sub) // n_seg
                cand = (i // sub) * n_seg + i % n_seg
                tied = (s[:, 1:] == s[:, :-1]) & (idx[:, 1:] == idx[:, :-1])
                assert int(tied.sum()) > 0
                assert bool((cand[:, 1:][tied] > cand[:, :-1][tied]).all())
                res["tied_neighbours"] = int(tied.sum())
            out.append(res)
            del q, c, scale, s, i, s2, i2
    return out


# DeepFM's slots at the Criteo width (64 embedding + 1 linear), B1's lr
# and eps; DCNv2's one slot of 16 (`configs/models/dcnv2.yaml`) and
# xDeepFM's 16 + 1 (`configs/models/xdeepfm.yaml`)
B1_DIMS, B1_LR, B1_EPS = (DIM, 1), 0.05, 1e-8
B1_ZOO_DIMS = (16,)
B1_XDEEPFM_DIMS = (16, 1)


def b1_slots(dims):
    """(accumulator columns, used columns) of a pack row laid out as the
    trainer lays it out: [values of each slot | one g2 a slot | 0 pad]."""
    w = sum(dims)
    return tuple(w + i for i in range(len(dims))), w + len(dims)


def b1_inputs(gen, ids_kind, dims=B1_DIMS, grad_dtype=torch.bfloat16):
    """A (2.6M, 128) pack laid out as the trainer lays out the Criteo
    fields' rows (DeepFM's [64 embedding | 1 linear | 2 accumulators | 0
    pad] by default, DCNv2's [16 | 1 accumulator | 0 pad] with dims (16,)),
    851,968 ids (one per field and example), the gathered rows G and the
    row gradients (bf16 from DeepFM's bf16 model, f32 from DCNv2's)."""
    rows = NUM_CAT * VOCAB
    acc, used = b1_slots(dims)
    w = sum(dims)
    pack = torch.zeros(rows, 128, device=DEVICE)
    pack[:, :w] = 1e-2 * torch.randn(rows, w, generator=gen, device=DEVICE)
    pack[:, w:used] = torch.rand(rows, len(dims), generator=gen,
                                 device=DEVICE)
    rng = np.random.default_rng(SEED)
    if ids_kind == "uniform":          # bench.py: uniform per field
        local = rng.integers(0, VOCAB, (NUM_CAT, BATCH))
    else:                              # Zipf-skewed: heavy duplicates
        local = (rng.zipf(1.2, (NUM_CAT, BATCH)) - 1) % VOCAB
    ids = torch.from_numpy(
        (local + VOCAB * np.arange(NUM_CAT)[:, None]).reshape(-1).astype(
            np.int32)).to(DEVICE)
    G = pack.index_select(0, ids)
    n = ids.shape[0]
    grads = [(1e-3 * torch.randn(n, d, generator=gen, device=DEVICE)).to(
        grad_dtype) for d in dims]
    return pack, ids, G, grads


def b1_call(fn, pack, ids, G, grads, dims=B1_DIMS):
    acc, used = b1_slots(dims)
    return fn(pack, ids, G, grads, B1_LR, dims=dims, acc_cols=acc,
              used=used, eps=B1_EPS)


def b1_agreement(pack, plain, pre, ids, upd):
    """Asserts the kernel's pack against the plain version's after one
    update. Rows hit once: rtol 1e-5, atol 1e-7 (only the mean's sum order
    differs). A row hit c > 1 times sums its c updates in a run-dependent
    order (atomics, and the kernel's sums of a block's rows of one id; the
    plain version's `index_add_` sums with atomics too), so there each
    entry may differ by the rounding of that order, bounded by c * 2^-23 *
    (|pre| + sum of the |updates|) on top."""
    count = torch.bincount(ids.long(), minlength=pack.shape[0])
    touched = count > 0
    once, dup = count == 1, count > 1
    err = (pack - plain).abs()
    assert torch.equal(pack[~touched], plain[~touched])
    torch.testing.assert_close(pack[once], plain[once], rtol=1e-5, atol=1e-7)
    mag = pre.abs().index_add_(0, ids, upd.abs())[dup]
    bound = (count[dup, None].float() * 2.0 ** -23 * mag
             + 1e-5 * plain[dup].abs() + 1e-7)
    assert bool((err[dup] <= bound).all()), float((err[dup] - bound).max())
    return {"n": int(ids.shape[0]), "unique": int(touched.sum()),
            "dup_rows": int(dup.sum()), "max_count": int(count.max()),
            "max_abs_err": float(err.max()),
            "max_abs_err_once": float(err[once].max()) if bool(once.any())
            else 0.0,
            "tolerance": "rows hit once rtol 1e-5 atol 1e-7; a row hit c "
                         "times within c*2^-23*(|pre|+sum|upd|) + 1e-5*|x| "
                         "+ 1e-7"}


def check_b1(gen, ids_kind, dims=B1_DIMS, grad_dtype=torch.bfloat16):
    """B1 against its plain version after one update of the full pack at
    the layout of ``dims`` (`b1_agreement`'s tolerances)."""
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_,
    )
    pack, ids, G, grads = b1_inputs(gen, ids_kind, dims, grad_dtype)
    pre, plain = pack.clone(), pack.clone()
    b1_call(packed_adagrad_update_, pack, ids, G, grads, dims)
    b1_call(packed_adagrad_update_plain_, plain, ids, G, grads, dims)
    torch.cuda.synchronize()
    acc, used = b1_slots(dims)
    upd = fused_adagrad_delta_plain(G, grads, B1_LR, dims=dims,
                                    acc_cols=acc, used=used,
                                    store_w=128, eps=B1_EPS)
    return {"ids": ids_kind, "dims": list(dims), "grads": str(grad_dtype),
            **b1_agreement(pack, plain, pre, ids, upd)}


def b1_update_agreement(pack, plain, pre, ids, upd):
    """Asserts the update the kernel added, pack - pre, against the plain
    version's, plain - pre, entry by entry, relative to the updates
    themselves: within 1e-5 of the sum of the |updates| of the entry's
    row, plus the rounding of the two sums into pre (c + 1 roundings of
    2^-23 (|pre| + sum |upd|) each for a row hit c times, whatever their
    order)."""
    count = torch.bincount(ids.long(), minlength=pack.shape[0])
    touched = count > 0
    mag = torch.zeros_like(pack).index_add_(0, ids, upd.abs())[touched]
    got, want = (pack - pre)[touched], (plain - pre)[touched]
    err = (got - want).abs()
    bound = (1e-5 * mag + (count[touched, None].float() + 1) * 2.0 ** -23
             * (pre[touched].abs() + mag))
    assert bool((err <= bound).all()), float((err - bound).max())
    rel = err / mag.clamp_min(1e-30)
    return {"max_abs_err_update": float(err.max()),
            "max_rel_err_update": float(rel[mag > 0].max()),
            "update_tolerance": "|(pack-pre) - (plain-pre)| <= 1e-5*sum|upd| "
                                "+ (c+1)*2^-23*(|pre|+sum|upd|)"}


# (pack width, slot dims, accumulator columns in G, grad dtype, base offset
# in floats): the Criteo layout, the zoo's (DCNv2's one slot of 16, and
# xDeepFM's 16 + 1, f32 gradients), and with them every instantiation of B1
# (bf16 / f32 gradients x reductions of 4 / 2 / 1 floats), slots whose
# values straddle its chunks, rows wider than its 16 lanes' chunks, a pack
# base aligned to 8 or 4 bytes only
B1_LAYOUTS = ((128, (64, 1), (65, 66), torch.bfloat16, 0),
              (130, (64, 1), (65, 66), torch.float32, 0),
              (130, (64, 1), (65, 66), torch.bfloat16, 0),
              (67, (64, 1), (65, 66), torch.bfloat16, 0),
              (67, (64, 1), (65, 66), torch.float32, 0),
              (16, (3, 5, 1), (15, 9, 13), torch.bfloat16, 0),
              (132, (128, 1), (129, 130), torch.float32, 0),
              (1028, (1000, 8, 3), (1026, 1020, 7), torch.bfloat16, 0),
              (128, (64, 1), (65, 66), torch.bfloat16, 1),
              (128, (64, 1), (65, 66), torch.float32, 2),
              (128, (16,), (16,), torch.float32, 0),
              (128, (16, 1), (17, 18), torch.float32, 0))


def check_b1_layouts(gen, rows=5000, n=20_000):
    """B1 against its plain version at each layout of `B1_LAYOUTS`, over
    uniform and Zipf ids: the packs (`b1_agreement`'s tolerances) and the
    updates themselves (`b1_update_agreement`). Every used column is drawn
    near 0 (1e-6 rand), so the updates stand out of the pack and the g^2
    the kernel adds (~1e-6 for 1e-3 gradients) weighs as much as the
    accumulator in each delta."""
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_, reduction_width,
    )
    rng = np.random.default_rng(SEED)
    out = []
    for width, dims, accs, dtype, offset in B1_LAYOUTS:
        for ids_kind in ("uniform", "zipf"):
            used = sum(dims) + len(dims)
            flat = torch.zeros(rows * width + offset, device=DEVICE)
            pack = flat[offset:].view(rows, width)
            pack[:, :used] = 1e-6 * torch.rand(rows, used, generator=gen,
                                               device=DEVICE)
            local = rng.integers(0, rows, n) if ids_kind == "uniform" \
                else (rng.zipf(1.2, n) - 1) % rows
            ids = torch.from_numpy(local.astype(np.int32)).to(DEVICE)
            G = pack.index_select(0, ids)
            grads = [(1e-3 * torch.randn(n, d, generator=gen,
                                         device=DEVICE)).to(dtype)
                     for d in dims]
            kw = dict(dims=dims, acc_cols=accs, used=used, eps=B1_EPS)
            pre, plain = pack.clone(), pack.clone()
            packed_adagrad_update_(pack, ids, G, grads, B1_LR, **kw)
            packed_adagrad_update_plain_(plain, ids, G, grads, B1_LR, **kw)
            torch.cuda.synchronize()
            upd = fused_adagrad_delta_plain(G, grads, B1_LR, store_w=width,
                                            **kw)
            out.append({"width": width, "dims": list(dims),
                        "grads": str(dtype), "base_offset": offset,
                        "ids": ids_kind,
                        "vec": reduction_width(width, pack.data_ptr()),
                        **b1_agreement(pack, plain, pre, ids, upd),
                        **b1_update_agreement(pack, plain, pre, ids, upd)})
    assert {(o["grads"], o["vec"]) for o in out} == {
        (str(t), v) for t in (torch.float32, torch.bfloat16)
        for v in (4, 2, 1)}, out
    return out


def b1_bound_ms(ids, grads, dims=B1_DIMS):
    """Each input read once, each output written once: ids, the slots'
    accumulators in G, the gradients, and a read-modify-write of the used
    columns of every touched pack row; against ~6 f32 operations an
    element at 67 TFLOP/s."""
    n = ids.shape[0]
    unique = int(torch.unique(ids).numel())
    _, used = b1_slots(dims)
    moved = n * (ids.element_size() + 4 * len(dims)) \
        + sum(g.numel() * g.element_size() for g in grads) \
        + unique * used * 4 * 2
    by_bytes = moved / HBM_BYTES_S * 1e3
    by_ops = 6.0 * n * sum(dims) / PEAK_OPS["f32"] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
        else "operations", moved


def time_b1(gen, ids_kind, dims=B1_DIMS, grad_dtype=torch.bfloat16):
    """B1, its plain version, the `index_add_` scatter it absorbs and its
    bound at the layout of ``dims``, over ids drawn as `check_b1` draws
    them (uniform per field as `bench.py` draws them, or Zipf-skewed)."""
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_,
    )
    pack, ids, G, grads = b1_inputs(gen, ids_kind, dims, grad_dtype)
    acc, used = b1_slots(dims)
    upd = fused_adagrad_delta_plain(G, grads, B1_LR, dims=dims,
                                    acc_cols=acc, used=used,
                                    store_w=128, eps=B1_EPS)
    return {"ids": ids_kind, "dims": list(dims), "grads": str(grad_dtype),
            **b1_times(lambda: b1_call(packed_adagrad_update_, pack, ids, G,
                                       grads, dims),
                       lambda: b1_call(packed_adagrad_update_plain_, pack,
                                       ids, G, grads, dims),
                       pack, ids, upd, grads, dims)}


def b1_times(kernel, plain, pack, ids, upd, grads, dims):
    """ms of one B1 update (``kernel()``), of its plain version
    (``plain()``) and of the `index_add_` scatter B1 absorbs, given the
    finished operand ``upd``, beside the bound (`b1_bound_ms`)."""
    ms = cuda_ms(kernel, reps=20)
    plain_ms = cuda_ms(plain, reps=20)
    library_ms = cuda_ms(lambda: pack.index_add_(0, ids, upd), reps=20)
    b_ms, b_by, moved = b1_bound_ms(ids, grads, dims)
    return {"n": int(ids.shape[0]), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": moved}


# bench.py's SASRec regimes (`bench.py:354-356`, `:425`): V items, L, d, B
SAS_V, SAS_L, SAS_D, SAS_B = 1_000_000, 50, 64, 1024
SAS_V_SMALL = 60_000
# one exp per logit at the special-function units' ~3.9e12/s (H100 SXM,
# FlashAttention-3 paper)
EXP_RATE = 3.9e12
# rows of one materialised F.cross_entropy call in `time_b2` (5120 x 1M
# bf16 logits: 10 GB, with their gradient 20 GB)
LIB_ROWS = 5120


def b2_inputs(gen, b, v, d, u_std=1.0, t_std=0.125):
    """user (b, d) and table (v, d) f32 on the card; logits of std
    ~u_std * t_std * sqrt(d) (about 1 at the 1M shape)."""
    user = u_std * torch.randn(b, d, generator=gen, device=DEVICE)
    table = t_std * torch.randn(v, d, generator=gen, device=DEVICE)
    return user, table


def b2_sweeps_vs_plain(user, table, lse_shift=None):
    """B2's two wrappers (forward, backward) on the card against their
    plain versions on the same bf16 operands. lse: rtol 1e-5 (ex2.approx
    and another summation order); du, dt: 0.5% of max |plain| (p rounds to
    bf16, and the kernel's exp2 of x log2(e) may round a p to the
    neighbouring bf16 value); rows whose lse_eff is +inf (weight 0) exactly
    0 in du; a second call of each on the same inputs gives the same bits.
    With the kernel's plan (clusters of blocks, passes over B)."""
    from recbox_tpu_torch.ops.fused_ce import (
        _device_plan, ce_operands, fused_ce_bwd, fused_ce_bwd_plain,
        fused_ce_lse, fused_ce_lse_plain,
    )
    u, t = ce_operands(user, table)
    d = user.shape[1]
    lse = fused_ce_lse(u, t)
    lse_p = fused_ce_lse_plain(u, t)
    lse_eff = lse_p if lse_shift is None else lse_p + lse_shift
    scale = torch.tensor(1.0 / user.shape[0], device=DEVICE)
    du, dt = fused_ce_bwd(u, t, lse_eff, scale, d)
    du_p, dt_p = fused_ce_bwd_plain(u, t, lse_eff, scale, d)
    lse2 = fused_ce_lse(u, t)
    du2, dt2 = fused_ce_bwd(u, t, lse_eff, scale, d)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(lse, lse2) and torch.equal(du, du2) \
        and torch.equal(dt, dt2), "B2: two calls differ"
    errs = {"plan": list(_device_plan(u.shape[0], t.shape[0], u.shape[1],
                                      u.device)) if u.is_cuda else None,
            "repeats_bit_identical": True,
            "lse": float((lse - lse_p).abs().max())}
    for name, got, want in (("du", du, du_p), ("dt", dt, dt_p)):
        err = float((got - want).abs().max())
        top = float(want.abs().max())
        assert bool(torch.isfinite(got).all()), name
        assert err <= 5e-3 * top, (name, err, top)
        errs[name] = err
        errs[name + "_rel_to_max"] = err / top if top else 0.0
    if lse_shift is not None:
        dead = torch.isinf(lse_shift)
        assert float(du[dead].abs().max()) == 0.0
        errs["zero_rows_exact"] = int(dead.sum())
    return errs


# B2's cluster plans at V = 100,003, D = 64 (B = 200 and 500: clusters of
# one and two blocks; 1500: a second, ragged pass; 8192: eight passes), and
# D = 128 at the 1M shape (clusters of four 128-row blocks, two passes)
B2_PLAN_CASES = ((200, 100_003, 64), (500, 100_003, 64),
                 (1500, 100_003, 64), (8192, 100_003, 64),
                 (SAS_B, SAS_V, 128))


def check_b2(gen):
    """B2 against its plain version on the card: bench.py's 1M shape, a
    ragged shape (B, V, D all unaligned), `B2_PLAN_CASES`, weights with
    zeros, the all-160 and all--40 logit cases, and the multinomial
    variant; every call of the kernel twice, bit for bit."""
    from recbox_tpu_torch.ops.fused_ce import (
        fused_multinomial_ce, fused_softmax_ce,
    )
    out = []
    for b, v, d in ((SAS_B, SAS_V, SAS_D), (1000, 100_003, 100),
                    *B2_PLAN_CASES):
        user, table = b2_inputs(gen, b, v, d, t_std=1.0 / math.sqrt(d))
        out.append({"case": "shape", "b": b, "v": v, "d": d,
                    **b2_sweeps_vs_plain(user, table)})
    # weights with zeros: lse_eff = lse - log w, +inf where w = 0
    user, table = b2_inputs(gen, SAS_B, SAS_V, SAS_D)
    w = torch.rand(SAS_B, generator=gen, device=DEVICE)
    w[::7] = 0.0
    out.append({"case": "weights_with_zeros", "b": SAS_B, "v": SAS_V,
                "d": SAS_D, **b2_sweeps_vs_plain(user, table, -torch.log(w))})
    u = user.clone().requires_grad_(True)
    labels = torch.randint(0, SAS_V, (SAS_B,), generator=gen, device=DEVICE)
    fused_softmax_ce(u, table, labels, w).backward()
    assert float(u.grad[w == 0].abs().max()) == 0.0
    # extreme logits through the whole function: CE = log V exactly
    for case, value, v in (("all_160", 10.0, 256), ("all_minus_40", 2.0, 300),
                           ("all_minus_40_large_v", 2.0, 100_003)):
        tv = 1.0 if value == 10.0 else -1.25
        user = torch.full((8, 16), value, device=DEVICE, requires_grad=True)
        table = torch.full((v, 16), tv, device=DEVICE, requires_grad=True)
        loss = fused_softmax_ce(user, table,
                                torch.arange(8, device=DEVICE))
        loss.backward()
        torch.cuda.synchronize()
        loss = float(loss.detach())
        assert abs(loss - math.log(v)) <= 1e-5 * math.log(v), \
            (case, loss)
        assert bool(torch.isfinite(user.grad).all()
                    & torch.isfinite(table.grad).all()), case
        out.append({"case": case, "v": v, "loss": loss,
                    "log_v": math.log(v)})
    # multinomial: 20 positives a row, an empty row, lse_eff = lse - log n
    b, v, h = 256, 100_000, 20
    user, table = b2_inputs(gen, b, v, SAS_D)
    pos = torch.randint(0, v, (b, h), generator=gen, device=DEVICE)
    mask = (torch.rand(b, h, generator=gen, device=DEVICE) > 0.3).float()
    mask[3] = 0.0
    errs = b2_sweeps_vs_plain(user, table, -torch.log(mask.sum(1)))
    u = user.clone().requires_grad_(True)
    loss = fused_multinomial_ce(u, table, pos, mask)
    loss.backward()
    loss = float(loss.detach())
    assert math.isfinite(loss) and float(u.grad[3].abs().max()) == 0
    out.append({"case": "multinomial", "b": b, "v": v, "h": h, "d": SAS_D,
                "loss": loss, **errs})
    return out


def b2_bounds(b, v, d):
    """(fwd, bwd): the least time in ms, "bytes" or "operations", which
    of the three limits sets it ("bytes", "tensor_cores" or "exps"), the
    bytes and the tensor-core operations: the largest of the bytes (each
    input read once, each output written once: bf16 operands; fwd writes
    lse, bwd f32 du and dt) at the HBM rate, 2BVD operations forward and 3
    products backward at the bf16 peak, and one exp per logit (BV, each
    direction) at `EXP_RATE`; and the exp floor alone."""
    fwd_bytes = (b + v) * d * 2 + b * 4
    bwd_bytes = (b + v) * d * 2 + b * 4 + (b + v) * d * 4
    fwd_ops, bwd_ops = 2.0 * b * v * d, 3 * 2.0 * b * v * d
    exp_ms = b * v / EXP_RATE * 1e3
    out = {}
    for name, nbytes, ops in (("fwd", fwd_bytes, fwd_ops),
                              ("bwd", bwd_bytes, bwd_ops)):
        limits = {"bytes": nbytes / HBM_BYTES_S * 1e3,
                  "tensor_cores": ops / PEAK_OPS["bf16"] * 1e3,
                  "exps": exp_ms}
        what = max(limits, key=limits.get)
        out[name] = (limits[what], "bytes" if what == "bytes"
                     else "operations", what, nbytes, ops)
    return out, exp_ms


B2_DESIGN = {
    "fwd": "clusters over B (up to 4 blocks of 256 rows at D <= 64), a "
           "persistent walk over V with one TMA multicast of each 64-row "
           "table tile into the cluster, four consumer warpgroups on wgmma "
           "(S = U T^T) folding an online max / sum of exp2 in registers; "
           "lse_combine over the clusters",
    "bwd": "one sweep on the forward's skeleton (two consumer warpgroups), "
           "each exp formed once: p in registers feeds du += p T (wgmma, A "
           "from registers, the tile MN-major) and, through shared memory, "
           "dT = p^T U (MN-major A and B); du resident in registers over the "
           "walk, summed over clusters by du_reduce; dT reduced and scattered "
           "over the cluster: each block's share of a tile's partials sent by "
           "bulk copy into that block's slots (distributed shared memory), "
           "summed there in rank order one step later and written once"}


def time_b2(user, table, labels, w=None, reps=10):
    """B2 alone at the shape of ``user`` (B, D) over ``table`` (V, D), with
    per-row weights ``w`` or none: each wrapper (kernel), its plain
    version, and the materialised PyTorch formulation (a bf16 torch.matmul
    into the logits, then F.cross_entropy, weighted with ``w``; chunks of
    at most LIB_ROWS rows, so the logits stay within 10 GB; the port never
    calls it), forward and forward + backward, CUDA events, median of
    ``reps``; the bounds at this shape."""
    import torch.nn.functional as F
    from recbox_tpu_torch.ops.fused_ce import (
        ce_operands, fused_ce_bwd, fused_ce_bwd_plain, fused_ce_lse,
        fused_ce_lse_plain,
    )
    (b, d), v = user.shape, table.shape[0]
    u, t = ce_operands(user, table)
    lse = fused_ce_lse(u, t)
    if w is None:
        scale = torch.tensor(1.0 / b, device=DEVICE)
    else:
        scale = 1.0 / w.sum()
        lse = lse - torch.log(w)
    res = {
        "fwd_ms": cuda_ms(lambda: fused_ce_lse(u, t), reps),
        "bwd_ms": cuda_ms(lambda: fused_ce_bwd(u, t, lse, scale, d), reps),
        "fwd_plain_ms": cuda_ms(lambda: fused_ce_lse_plain(u, t), reps),
        "bwd_plain_ms": cuda_ms(
            lambda: fused_ce_bwd_plain(u, t, lse, scale, d), reps)}
    ul = u.detach().clone().requires_grad_(True)
    tl = t.detach().clone().requires_grad_(True)
    chunks = range(0, b, LIB_ROWS)

    def library(backward):
        for s in chunks:
            logits, lbl = ul[s:s + LIB_ROWS] @ tl.T, labels[s:s + LIB_ROWS]
            if w is None:
                loss = F.cross_entropy(logits, lbl) * (len(lbl) / b)
            else:
                loss = torch.sum(w[s:s + LIB_ROWS] * F.cross_entropy(
                    logits, lbl, reduction="none")) / w.sum()
            if backward:
                loss.backward()

    with torch.no_grad():
        res["fwd_library_ms"] = cuda_ms(lambda: library(False), reps)
    res["fwd_bwd_library_ms"] = cuda_ms(lambda: library(True), reps)
    res["library_calls"] = len(chunks)
    del ul, tl
    torch.cuda.empty_cache()
    bounds, exp_ms = b2_bounds(b, v, d)
    for name in ("fwd", "bwd"):
        b_ms, b_by, what, nbytes, ops = bounds[name]
        res.update({f"{name}_bound_ms": b_ms, f"{name}_bound_by": b_by,
                    f"{name}_bound_what": what, f"{name}_bytes": nbytes,
                    f"{name}_ops": ops})
    res["exp_floor_ms"] = exp_ms
    return res


# the candidate generator's profiling shape (`tools/prof_mips_batched.py:
# 45-47`, query tile `:47`), the merge-only shape of
# `tools/prof_retrieval_topk.py:161-175`, and the sequence pool's
# (`embedding_gather.py:16-22`)
B4_N, B4_D, B4_Q, B4_TILE = 1_000_000, 128, 8192, 1024
B5_MERGE = (7812, 1024)
B5_FULL = 7936        # the candidates of the B4 path at that shape
B6_V, B6_B, B6_L = 1_000_000, 8192, 50
B4_VARIANTS = (("packed", torch.bfloat16, True), ("packed_int8", torch.int8,
                                                   True),
               ("unpacked", torch.bfloat16, False))
# the f32 instantiations, checked at the small shapes only
B4_F32_VARIANTS = (("packed", torch.float32, True),
                   ("unpacked", torch.float32, False))
# a corpus and a few queries whose grid is too small for the card (the
# packed f32 variant splits each sub-chunk into runs merged by atomic max;
# bf16 and int8 take the segment route over the corpus padded to a whole
# number of segments), a mid-size one with no split runs, and 300 queries
# over it (27 segments a sub-chunk, a ragged last sub-chunk whose last 19
# rows the segment route reads through its shifted view); the last 37 rows
# past valid_items
B4_SMALL = ((3000, 20), (100_000, 1024), (100_000, 300))
# the plans the wgmma route takes at D=128 (bf16, int8): query tiles of
# 8192, 4096, 2048 and 1024 queries give n_seg = 1, 2, 4 and 8; 300
# queries (a ragged second tile of 256) over a corpus whose last sub-chunk
# is ragged, rows past valid_items
B4_PLAN_TILES = (8192, 4096, 2048, 1024)
B4_PLAN_SHAPE = (50_000, 300)


def b4_inputs(gen, dtype, integer, n=None, nq=None, d=B4_D):
    """Queries (Q, D) and corpus (N, D) on the card as the candidate kernel
    takes them (bf16 or f32; or int8 rows of `quantize_int8` with their
    scales), from small integers or N(0, 1); B4's shape by default."""
    from recbox_tpu_torch.ops.mips_topk import quantize_int8
    n, nq = n or B4_N, nq or B4_Q
    if integer:
        q = torch.randint(-4, 5, (nq, d), generator=gen,
                          device=DEVICE).float()
        c = torch.randint(-4, 5, (n, d), generator=gen,
                          device=DEVICE).float()
    else:
        q = torch.randn(nq, d, generator=gen, device=DEVICE)
        c = torch.randn(n, d, generator=gen, device=DEVICE)
    if dtype == torch.int8:
        c8, scale = quantize_int8(c)
        return quantize_int8(q)[0], c8, scale
    return q.to(dtype), c.to(dtype), None


def b4_candidates(q, c, scale, packed, valid=None, tile=None):
    """The kernel at the plan of a tile of ``tile`` (default min(1024, Q))
    queries, as `pallas_mips_topk` launches it, and that plan's sub_rows."""
    from recbox_tpu_torch.ops.mips_topk import _candidates, candidate_plan
    n = c.shape[0]
    tile = tile or min(B4_TILE, q.shape[0])
    sub, n_cand = candidate_plan(c.dtype, n, c.shape[1], tile)
    return _candidates(q, c, n if valid is None else valid, packed, scale,
                       sub, n_cand), sub


def b4_pair(q, c, scale, packed, valid=None, tile=None):
    """The kernel (`b4_candidates`) and its plain version on the same inputs
    over the rows that hold corpus rows (the rest the wrapper fills alike);
    the route the launch took and its split runs (the tile route's)."""
    from recbox_tpu_torch.ops.mips_topk import (
        candidate_route, mips_segment_candidates_plain, route_launches,
        split_runs,
    )
    n, nq = c.shape[0], q.shape[0]
    valid = n if valid is None else valid
    before = dict(route_launches)
    got, sub = b4_candidates(q, c, scale, packed, valid, tile)
    route = candidate_route(c.dtype, c.shape[1], sub, packed)
    assert route_launches[route] == before[route] + 1, (route, before)
    want = mips_segment_candidates_plain(q, c, valid, packed, scale, sub)
    n_live = (want if packed else want[0]).shape[0]
    got = got[:n_live] if packed else (got[0][:n_live], got[1][:n_live])
    splits = split_runs(nq, n, sub, packed, c.device) if route == "tile" \
        else 1
    return got, want, {"route": route, "sub_rows": sub, "splits": splits}


def b4_bits_equal(got, want, packed):
    if packed:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) \
        and torch.equal(got[1], want[1])


def check_b4_small(gen):
    """Every instantiation of B4 (f32 too) at the `B4_SMALL` shapes, and
    bf16 packed and unpacked and int8 at each plan of the wgmma route
    (`B4_PLAN_TILES`) at D = 128 and 64, on integer-valued inputs, against
    the plain version bit for bit; at the first small shape (20 queries:
    16,384-row sub-chunks, 128 segments, over 3000 rows, padded to a whole
    number of segments) packed f32 must run split on the tile route, packed
    bf16 and int8 on the segment route, unpacked bf16 unsplit on the tile
    route; each plan tile must take the wgmma route."""
    out = []
    cases = [(n, nq, None, B4_D, v) for n, nq in B4_SMALL
             for v in B4_VARIANTS + B4_F32_VARIANTS]
    cases += [(*B4_PLAN_SHAPE, tile, d, v) for d in (B4_D, DIM)
              for tile in B4_PLAN_TILES for v in B4_VARIANTS]
    for n, nq, tile, d, (name, dtype, packed) in cases:
        q, c, scale = b4_inputs(gen, dtype, True, n, nq, d)
        got, want, how = b4_pair(q, c, scale, packed, n - 37, tile)
        torch.cuda.synchronize()
        assert b4_bits_equal(got, want, packed), (n, nq, tile, name, dtype)
        if n == B4_SMALL[0][0]:
            want = ("segment", 1) if packed and dtype != torch.float32 \
                else ("tile", 1 if not packed else how["splits"])
            assert (how["route"], how["splits"]) == want, (n, dtype, how)
            assert how["route"] != "tile" or not packed \
                or how["splits"] > 1, (n, how)
        if tile is not None:
            assert how["route"] == "wgmma", (tile, how)
        out.append({"variant": name, "dtype": str(dtype), "n": n, "d": d,
                    "q": nq, "plan_tile": tile, "valid_items": n - 37,
                    **how, "bits_equal": True, "max_abs_err": 0.0})
    return out


def check_b4(gen):
    """B4's three variants against the plain version at the profiling
    shape, and at D = 64 (B3's serving depth, also on the wgmma route).
    Integer-valued inputs (and int8, always exact) must agree bit
    for bit. N(0, 1) bf16 sums in another order: the share of candidates
    whose winning row differs (a near-tie) must be <= 1e-3, and where the
    row agrees the score within 3e-5 relative (packed: one 2^-16 packing
    step and the rounding) or 1e-5 (unpacked)."""
    from recbox_tpu_torch.ops.mips_topk import PACK_MASK
    out = []
    cases = [(v, d, i) for d in (B4_D, DIM) for v in B4_VARIANTS
             for i in (True, False)]
    for (name, dtype, packed), d, integer in cases:
        q, c, scale = b4_inputs(gen, dtype, integer, d=d)
        got, want, how = b4_pair(q, c, scale, packed)
        torch.cuda.synchronize()
        assert how["route"] == "wgmma", (name, d, how)
        if packed:
            gb, wb = got.view(torch.int32), want.view(torch.int32)
            g_row, w_row = gb & PACK_MASK, wb & PACK_MASK
            g_s = (gb & ~PACK_MASK).view(torch.float32)
            w_s = (wb & ~PACK_MASK).view(torch.float32)
            bits_equal = torch.equal(gb, wb)
        else:
            (g_s, g_row), (w_s, w_row) = got, want
            bits_equal = torch.equal(g_s.view(torch.int32),
                                     w_s.view(torch.int32)) \
                and torch.equal(g_row, w_row)
        same = g_row == w_row
        mismatch = 1.0 - same.float().mean().item()
        err = (g_s - w_s)[same].abs()
        max_err = err.max().item()
        if integer or dtype == torch.int8:
            assert bits_equal, (name, integer)
            tolerance = "bit for bit"
        else:
            rtol = 3e-5 if packed else 1e-5
            assert mismatch <= 1e-3, (name, mismatch)
            assert bool((err <= rtol * w_s[same].abs() + 1e-6).all()), \
                (name, max_err)
            tolerance = (f"winner differs on <= 1e-3 of candidates; "
                         f"scores rtol {rtol} atol 1e-6 elsewhere")
        out.append({"variant": name, "d": d, "inputs": "integer"
                    if integer else "normal", "route": how["route"],
                    "candidates": list(w_s.shape),
                    "bits_equal": bits_equal,
                    "winner_mismatch_share": mismatch,
                    "max_abs_err": max_err, "tolerance": tolerance})
        del q, c, scale, got, want
    return out


def b5_inputs(gen, c, q, ties=False):
    """Candidate-major (C, Q) scores and distinct int32 ids on the card;
    ``ties`` rounds the scores to bf16 so many are equal."""
    s = torch.randn(c, q, generator=gen, device=DEVICE)
    if ties:
        s = s.to(torch.bfloat16).float()
    ids = torch.randperm(c * q, generator=gen, device=DEVICE).view(c, q)
    return s, ids.to(torch.int32)


# B5's further checks: a shape past the kernel's 16384-key window (the
# streaming path, 4 queries a block of the candidate-major source), and
# k = C at one window's width
B5_WINDOWED = (40_000, 64)
B5_FULL_K = (16384, 8)


def check_b5(gen):
    """B5 against its plain version, bit for bit: the merge-only shape at
    k=500 and 100, and the B4 path's (7936, 8192) at k=500 with bf16-rounded
    scores (ties that the total order breaks the same way on both), all
    candidate-major; the merge-only shape row-major through
    `pallas_bitonic_topk` (ids and the default positions); the windowed
    shape at k=500 with ties; k = C. Each at the plan's queries a block."""
    from recbox_tpu_torch.ops.bitonic_topk import (
        bitonic_topk_plain, pallas_bitonic_topk, pallas_bitonic_topk_cmajor,
        select_plan,
    )
    out = []
    cases = ((B5_MERGE, K, False, "cmajor"), (B5_MERGE, 100, False, "cmajor"),
             ((B5_FULL, B4_Q), K, True, "cmajor"),
             (B5_MERGE, K, False, "rows"), (B5_MERGE, K, False, "positions"),
             (B5_WINDOWED, K, True, "cmajor"),
             (B5_FULL_K, B5_FULL_K[0], True, "cmajor"))
    for (c, q), k, ties, layout in cases:
        s, ids = b5_inputs(gen, c, q, ties)
        if layout == "cmajor":
            ts, ti = pallas_bitonic_topk_cmajor(s, ids, k)
            ts, ti = ts.T, ti.T
            ps, pi = bitonic_topk_plain(s.T, ids.T, k)
        else:
            rows = s.T.contiguous()
            row_ids = None if layout == "positions" else ids.T.contiguous()
            ts, ti = pallas_bitonic_topk(rows, row_ids, k)
            ps, pi = bitonic_topk_plain(rows, row_ids, k)
        torch.cuda.synchronize()
        assert ts.shape == (q, k) and ti.shape == (q, k)
        assert torch.equal(ts, ps) and torch.equal(ti, pi), (c, q, k, layout)
        assert bool((ts[:, 1:] <= ts[:, :-1]).all())
        qb, window, kpt, _ = select_plan(c, k, cmajor=layout == "cmajor")
        out.append({"c": c, "q": q, "k": k, "ties": ties, "layout": layout,
                    "queries_a_block": qb, "keys_a_thread": kpt,
                    "path": "window" if window == c else "stream",
                    "window_or_buffer": window, "equal_to_plain": True,
                    "max_abs_err": 0.0})
    return out


def b6_inputs(d, seed=SEED, ids_kind="zipf"):
    """A (V, d) f32 table and (B, L) ids on the card: Zipf(1.2) ids over
    V - 1 rows (~51k distinct, which the 50 MB L2 holds at D=128) or
    uniform ones (~280k distinct, 143 MB at D=128: they reach HBM), ~20% of
    positions and every 97th row all pad_id = V - 1."""
    rng = np.random.default_rng(seed)
    if ids_kind == "zipf":
        ids = (rng.zipf(1.2, (B6_B, B6_L)) - 1) % (B6_V - 1)
    else:
        ids = rng.integers(0, B6_V - 1, (B6_B, B6_L))
    ids[rng.random((B6_B, B6_L)) < 0.2] = B6_V - 1
    ids[::97] = B6_V - 1
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    table = torch.randn(B6_V, d, generator=gen, device=DEVICE)
    return table, torch.from_numpy(ids).to(DEVICE), B6_V - 1


def check_b6():
    """B6 against its plain version at D=128 (mean and sum; Zipf and
    uniform ids) and D=64: each entry within 1e-6 of the pooled |rows|
    (another summation order), rows of pads exactly 0, a second call equal
    bit for bit. Last, ids out of range: -1 reads row V - 1, V and -V - 1
    make their rows NaN, on both."""
    from recbox_tpu_torch.ops.embedding_gather import (
        seq_embedding_pool, seq_embedding_pool_plain,
    )
    out = []
    for d, mode, kind in ((128, "mean", "zipf"), (128, "sum", "zipf"),
                          (DIM, "mean", "zipf"), (128, "mean", "uniform"),
                          (DIM, "mean", "uniform"), (DIM, "mean", "bad")):
        table, ids, pad = b6_inputs(d, ids_kind="uniform" if kind ==
                                    "uniform" else "zipf")
        if kind == "bad":
            ids[5, 3], ids[7, 0], ids[11, 2] = -1, B6_V, -B6_V - 1
        got = seq_embedding_pool(table, ids, pad, mode)
        again = seq_embedding_pool(table, ids, pad, mode)
        want = seq_embedding_pool_plain(table, ids, pad, mode)
        mag = seq_embedding_pool_plain(table.abs(), ids, pad, mode)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), (d, mode, kind)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        assert int(nan.any(1).sum()) == (2 if kind == "bad" else 0)
        err = (got - want).abs()[~nan]
        assert got.dtype == torch.float32 and got.shape == (B6_B, d)
        assert bool((err <= 1e-6 * mag[~nan] + 1e-30).all()), (d, mode)
        assert float(got[::97].abs().max()) == 0.0
        out.append({"d": d, "mode": mode, "ids": kind,
                    "max_abs_err": float(err.max()),
                    "pad_share": float((ids == pad).float().mean()),
                    "repeat_bit_identical": True,
                    "tolerance": "1e-6 of the pooled |rows|; NaN rows alike"})
    return out


def recall_at(ids, exact):
    ids, exact = np.asarray(ids), np.asarray(exact)
    return float(np.mean([len(set(ids[r].tolist()) & set(exact[r].tolist()))
                          / exact.shape[1] for r in range(exact.shape[0])]))


def candidate_paths(gen):
    """Phase 4b, the candidate paths: `pallas_mips_topk` at the profiling
    shape packed (default merge), unpacked with the bitonic merge and with
    the exact merge, and over int8 rows; `seq_embedding_pool` at B6's
    shapes. Counts of B4 (by variant and by route), B5 and B6 reset just
    before, read just after: every call takes B4's wgmma route. Then each
    `pallas_mips_topk` call is timed (ms per 8192
    queries, median of 3, CUDA events) beside its candidate generation
    alone, the difference being its merge."""
    from recbox_tpu_torch.ops import bitonic_topk, embedding_gather, mips_topk
    from recbox_tpu_torch.ops.mips_topk import pallas_mips_topk, quantize_int8
    q = torch.randn(B4_Q, B4_D, generator=gen, device=DEVICE)
    c = torch.randn(B4_N, B4_D, generator=gen, device=DEVICE)
    qb, cb = q.to(torch.bfloat16), c.to(torch.bfloat16)
    c8, scale = quantize_int8(c)
    pools = [b6_inputs(d) for d in (128, DIM)]
    calls = {
        "packed": lambda: pallas_mips_topk(qb, cb, K, query_tile=B4_TILE),
        "bitonic": lambda: pallas_mips_topk(qb, cb, K, packed=False,
                                            merge="bitonic",
                                            query_tile=B4_TILE),
        "exact": lambda: pallas_mips_topk(qb, cb, K, packed=False,
                                          exact_merge=True,
                                          query_tile=B4_TILE),
        "int8": lambda: pallas_mips_topk(q, c8, K, row_scale=scale,
                                         query_tile=B4_TILE)}
    for mod in (mips_topk, bitonic_topk, embedding_gather):
        mod.reset_launches()
    res = {name: call() for name, call in calls.items()}
    pooled = [embedding_gather.seq_embedding_pool(t, i, p, "mean")
              for t, i, p in pools]
    torch.cuda.synchronize()
    counts = {**mips_topk.launches, **bitonic_topk.launches,
              **embedding_gather.launches}
    routes = dict(mips_topk.route_launches)
    assert counts == {"packed": 1, "packed_int8": 1, "unpacked": 2,
                      "bitonic_topk": 1, "seq_embedding_pool": 2}, counts
    # the 1024-query plan of every call on the new route
    assert routes == {"wgmma": 4, "segment": 0, "tile": 0}, routes
    for name, (s, i) in res.items():
        assert s.shape == (B4_Q, K) and i.shape == (B4_Q, K), name
        assert bool(torch.isfinite(s).all()), name
        assert bool(((i >= 0) & (i < B4_N)).all()), name
        assert bool((s[:, 1:] <= s[:, :-1]).all()), name
    assert torch.equal(res["bitonic"][1], res["exact"][1])
    assert torch.equal(res["bitonic"][0], res["exact"][0])
    exact = torch.topk(q[:512] @ c.T, K, dim=1).indices.cpu()
    recall = {name: recall_at(i[:512].cpu(), exact)
              for name, (s, i) in res.items()}
    assert min(recall["packed"], recall["bitonic"]) >= 0.95, recall
    assert recall["int8"] >= 0.90, recall
    for out, (t, _, _) in zip(pooled, pools):
        assert out.shape == (B6_B, t.shape[1])
        assert bool(torch.isfinite(out).all())
    del res, pooled
    c8q = quantize_int8(q)[0]
    gens = {"packed": lambda: b4_candidates(qb, cb, None, True),
            "bitonic": lambda: b4_candidates(qb, cb, None, False),
            "int8": lambda: b4_candidates(c8q, c8, scale, True)}
    gens["exact"] = gens["bitonic"]
    per = B4_Q / 8192
    times = {}
    for name, call in calls.items():
        path_ms = cuda_ms(call, reps=3) / per
        cand_ms = cuda_ms(gens[name], reps=3) / per
        times[name] = {"path_ms": path_ms, "candidates_ms": cand_ms,
                       "merge_ms": path_ms - cand_ms,
                       "merge_share": (path_ms - cand_ms) / path_ms}
    return counts, {"routes": routes, "k": K, "queries": 512,
                    "recall": recall, "bitonic_equals_exact_merge": True,
                    "predicted": 1 - K * 128 / (2 * B4_N),
                    "ms_per_8192_queries": times}


def service_paths(model, item_embs, users):
    """Phase 4b, the rest of `BruteForceMIPS` behind `RetrievalService` on
    phase 4's corpus: 'refined' (bf16 over-retrieval, exact f32 rescore),
    int8 'approx' and int8 'refined', against an exact f32 oracle over 512
    users; refined scores equal the f32 dot products of their ids."""
    from recbox_tpu_torch.retrieval import RetrievalService
    svcs = {"refined": RetrievalService(model, item_embs=item_embs,
                                        method="refined"),
            "int8_approx": RetrievalService(model, item_embs=item_embs,
                                            method="approx", quantize="int8"),
            "int8_refined": RetrievalService(model, item_embs=item_embs,
                                             method="refined",
                                             quantize="int8")}
    sub = {k: v[:512] for k, v in users.items()}
    with torch.no_grad():
        u = svcs["refined"]._encode(model.encode_user, sub)
        exact = torch.topk(u @ item_embs.T, K, dim=1).indices.cpu()
    out = {}
    for name, svc in svcs.items():
        s, i = svc.query(users, k=K)
        assert s.shape == (N_QUERIES, K) and np.isfinite(s).all()
        assert (i >= 0).all() and (i < N_ITEMS).all()
        rec = recall_at(i[:512], exact)
        out[name] = {"recall": rec}
        if name.endswith("refined"):
            assert rec >= 0.99, (name, rec)
            with torch.no_grad():
                true = torch.einsum(
                    "qd,qkd->qk", u.double(),
                    item_embs.double()[torch.from_numpy(i[:512]).long()
                                       .to(item_embs.device)]).cpu().numpy()
            np.testing.assert_allclose(s[:512], true, rtol=1e-5, atol=1e-6)
        else:
            assert rec >= 0.90, (name, rec)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            svc.query(users, k=K)
            walls.append(time.perf_counter() - t0)
        out[name]["qps"] = N_QUERIES / statistics.median(walls)
    return out


def b4_library(q, c_pad, scale_pad, sub, packed):
    """One PyTorch formulation of B4's function: per 1024-query chunk, the
    cuBLAS product (bf16 torch.matmul, or torch._int_mm and the row scale),
    then the strided segment amax (and argmax unpacked) over a corpus
    padded to whole sub-chunks; no packing."""
    n_seg = sub // 128
    out = []
    for s0 in range(0, q.shape[0], B4_TILE):
        qc = q[s0:s0 + B4_TILE]
        if c_pad.dtype == torch.int8:
            s = torch._int_mm(qc, c_pad.T).float() * scale_pad
        else:
            s = qc @ c_pad.T
        seg = s.view(qc.shape[0], -1, 128, n_seg)
        out.append(torch.amax(seg, dim=2) if packed else seg.max(dim=2))
    return out


def b4_bound(dtype, packed, d=B4_D):
    """Corpus, queries (and int8 row scales) read once, the candidates
    written once, against 2QND operations at the type's peak."""
    from recbox_tpu_torch.ops.mips_topk import candidate_plan
    size = torch.empty((), dtype=dtype).element_size()
    _, n_cand = candidate_plan(dtype, B4_N, d, B4_TILE)
    moved = (B4_N + B4_Q) * d * size + n_cand * B4_Q * 4 * (
        1 if packed else 2) + (B4_N * 4 if dtype == torch.int8 else 0)
    by_ops = 2.0 * B4_Q * B4_N * d / PEAK_OPS[
        "int8" if dtype == torch.int8 else "bf16"] * 1e3
    by_bytes = moved / HBM_BYTES_S * 1e3
    return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes \
        else "bytes"


def b4_tile_route(q, c, scale, packed, sub):
    """B4's tile route (its first design) forced through the library's C
    entry on inputs the wrapper sends to the wgmma route, for a same-run
    comparison; the port's wrapper never does this."""
    from recbox_tpu_torch.ops import mips_topk as m
    nq, (n, d) = q.shape[0], c.shape
    rows = -(-n // sub) * (sub // 128)
    out_s = torch.empty((rows, nq), device=c.device)
    out_i = None if packed else torch.empty((rows, nq), dtype=torch.int32,
                                            device=c.device)
    splits = m.split_runs(nq, n, sub, packed, c.device)
    if splits > 1:
        out_s.fill_(float("-inf"))
    rc = m._kernel_lib().recbox_mips_segment_candidates(
        m._DTYPES[c.dtype], int(packed), q.data_ptr(), c.data_ptr(),
        None if scale is None else scale.data_ptr(), out_s.data_ptr(),
        None if out_i is None else out_i.data_ptr(), nq, n, d, n, sub,
        splits, torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out_s, out_i


def time_b4(gen):
    """Each B4 variant at the profiling shape and at D = 64: kernel (on the
    route the wrapper picks), plain version, the library formulation, the
    bound, and the tile route on the same inputs. Keyed (variant, D)."""
    import torch.nn.functional as F
    from recbox_tpu_torch.ops.mips_topk import (
        candidate_plan, candidate_route, mips_segment_candidates_plain,
    )
    out = {}
    for (name, dtype, packed), d in ((v, d) for d in (B4_D, DIM)
                                     for v in B4_VARIANTS):
        q, c, scale = b4_inputs(gen, dtype, False, d=d)
        sub, _ = candidate_plan(dtype, B4_N, d, B4_TILE)
        route = candidate_route(dtype, d, sub, packed)
        pad = (-B4_N) % sub
        c_pad = F.pad(c, (0, 0, 0, pad))
        scale_pad = None if scale is None else F.pad(scale, (0, pad))
        ms = cuda_ms(lambda: b4_candidates(q, c, scale, packed))
        tile_ms = cuda_ms(lambda: b4_tile_route(q, c, scale, packed, sub)) \
            if route == "wgmma" else ms
        plain_ms = cuda_ms(lambda: mips_segment_candidates_plain(
            q, c, B4_N, packed, scale, sub), reps=3)
        library_ms = cuda_ms(lambda: b4_library(q, c_pad, scale_pad, sub,
                                                packed), reps=3)
        b_ms, b_by = b4_bound(dtype, packed, d)
        out[name, d] = {"variant": name, "route": route, "n": B4_N, "d": d,
                     "q": B4_Q, "query_tile": B4_TILE, "ms": ms,
                     "tile_route_ms": tile_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        del q, c, scale, c_pad, scale_pad
    return out


def time_b5(gen):
    """B5 on the B4 path's (7936, 8192) candidates at k=500 and the
    merge-only shape at k=500 / 100: kernel, plain version and torch.topk
    on the (Q, C) view, the kernel and torch.topk over runs of 20 calls
    behind a spin kernel; the byte bound; the compare-exchanges of the
    survivors' sort."""
    from recbox_tpu_torch.ops.bitonic_topk import (
        bitonic_topk_plain, pallas_bitonic_topk_cmajor, select_plan,
    )
    out = []
    for (c, q), k in (((B5_FULL, B4_Q), K), (B5_MERGE, K), (B5_MERGE, 100)):
        s, ids = b5_inputs(gen, c, q)
        qb, _, kpt, p = select_plan(c, k)
        width = max(p, 512)   # the kernel's register sort takes 512 keys
        stages = int(math.log2(width)) * (int(math.log2(width)) + 1) // 2
        # every score read once; ids only of the k winners; k pairs written
        moved = c * q * 4 + k * q * 4 + k * q * 8
        out.append({
            "c": c, "q": q, "k": k, "queries_a_block": qb,
            "keys_a_thread": kpt,
            "ms": cuda_ms(lambda: pallas_bitonic_topk_cmajor(s, ids, k),
                          reps=11, inner=20),
            "plain_ms": cuda_ms(lambda: bitonic_topk_plain(s.T, ids.T, k)),
            "library_ms": cuda_ms(lambda: torch.topk(s.T, k, dim=1),
                                  reps=11, inner=20),
            "bound_ms": moved / HBM_BYTES_S * 1e3, "bound_by": "bytes",
            "bytes": moved,
            "sort_compare_exchanges": stages * (width // 2) * q})
    return out


def b6_bound(table, ids, pad):
    """Each distinct non-pad row read once, the ids read once, the output
    written once; one add an element is far below the f32 peak."""
    rows = torch.unique(ids[ids != pad]).numel()
    d = table.shape[1]
    moved = rows * d * 4 + ids.numel() * 4 + ids.shape[0] * d * 4
    return moved / HBM_BYTES_S * 1e3, moved, rows


def time_b6():
    """B6 at D=128 and 64 over Zipf ids (their rows stay in the 50 MB L2
    across the timed run) and uniform ones (they reach HBM): kernel (with
    the wrapper's cast of the int64 ids, and on int32 ids), plain version,
    F.embedding_bag, the bound."""
    import torch.nn.functional as F
    from recbox_tpu_torch.ops.embedding_gather import (
        seq_embedding_pool, seq_embedding_pool_plain,
    )
    out = []
    for kind, d in (("zipf", 128), ("zipf", DIM), ("uniform", 128),
                    ("uniform", DIM)):
        table, ids, pad = b6_inputs(d, ids_kind=kind)
        ids32 = ids.to(torch.int32)
        b_ms, moved, rows = b6_bound(table, ids, pad)
        out.append({
            "d": d, "v": B6_V, "b": B6_B, "l": B6_L, "mode": "mean",
            "ids": kind, "distinct_rows_mb": rows * d * 4 / 1e6,
            "ms": cuda_ms(lambda: seq_embedding_pool(table, ids, pad),
                          reps=11, inner=20),
            # the kernel alone: the wrapper casts int64 ids to int32 first
            "ms_int32_ids": cuda_ms(lambda: seq_embedding_pool(
                table, ids32, pad), reps=11, inner=20),
            "plain_ms": cuda_ms(lambda: seq_embedding_pool_plain(
                table, ids, pad)),
            "library_ms": cuda_ms(lambda: F.embedding_bag(
                ids, table, mode="mean", padding_idx=pad), reps=11, inner=20),
            "bound_ms": b_ms, "bound_by": "bytes", "bytes": moved,
            "distinct_rows": rows,
            "bound_ms_every_position": (
                int((ids != pad).sum()) * d * 4 + ids.numel() * 4
                + B6_B * d * 4) / HBM_BYTES_S * 1e3})
    return out


def sasrec_setup(vocab, train_method, seed=SEED, mesh=None,
                 compute_dtype="bfloat16", dropout=0.1, rows=None):
    """bench.py's SASRec regime (`bench.py:426-441`): 2 layers, 2 heads,
    L = 50, d = 64, dropout 0.1, bf16 compute, Adam 1e-3 with clip 10;
    the batch drawn as `bench.py:434-438` draws it (``rows`` of them,
    SAS_B by default). ``mesh``, ``compute_dtype`` and ``dropout`` are 5t's
    (the trainer on a mesh; f32 and no dropout for its two-rank
    comparison)."""
    rows = SAS_B if rows is None else rows
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.sequential import SASRec
    from recbox_tpu_torch.ops.losses import full_softmax_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    fm = FeatureMap("sasbench", (FeatureSpec(
        "item_id", "categorical", vocab_size=vocab,
        embedding_dim=SAS_D),), corpus_index="item_id", num_items=vocab)
    model = SASRec(fm, embedding_dim=SAS_D, max_seq_len=SAS_L, n_layers=2,
                   n_heads=2, dropout=dropout, compute_dtype=compute_dtype,
                   generator=torch.Generator(device=DEVICE).manual_seed(seed),
                   device=DEVICE)
    loss = (lambda o, b: o) if train_method == "fused_ce_loss" else \
        (lambda o, b: full_softmax_loss(o, b["item_id"]))
    trainer = Trainer(model, loss, TrainerConfig(learning_rate=1e-3,
                                                 grad_clip_norm=10.0,
                                                 seed=seed),
                      device=DEVICE, train_method=train_method, mesh=mesh)
    rng = np.random.default_rng(seed)
    batch = {
        "item_seq": rng.integers(1, vocab, (rows, SAS_L)).astype(np.int32),
        "seq_len": np.full(rows, SAS_L, np.int32),
        "item_id": rng.integers(1, vocab, rows).astype(np.int32),
    }
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    return trainer, batch


def timed_repeat_steps(trainer, batch):
    """WARMUP_STEPS steps, then TIMED_STEPS one by one through
    `train_steps_repeat`, CUDA events around each; (losses, step ms)."""
    losses = [trainer.train_steps_repeat(batch, WARMUP_STEPS)]
    events = []
    for _ in range(TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_steps_repeat(batch, 1))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return ([float(x) for x in torch.cat(losses)],
            [s.elapsed_time(e) for s, e in events])


def train_sasrec_1m():
    """The sequential training path at bench.py's 1M-item shape through
    kernel B2: its counts reset just before the 15 steps, read just after."""
    from recbox_tpu_torch.ops import fused_ce
    trainer, batch = sasrec_setup(SAS_V, "fused_ce_loss")
    t0 = time.perf_counter()
    trainer.init(batch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fused_ce.reset_launches()
    losses, step_ms = timed_repeat_steps(trainer, batch)
    launches = dict(fused_ce.launches)
    n = WARMUP_STEPS + TIMED_STEPS
    assert launches == {"fused_ce_fwd": n, "fused_ce_bwd": n}, launches
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    med = statistics.median(step_ms)
    return trainer, batch, {
        "vocab": SAS_V, "batch": SAS_B, "seq_len": SAS_L, "dim": SAS_D,
        "init_s": init_s, "losses": losses, "launches": launches,
        "step_ms": step_ms, "median_step_ms": med,
        "min_step_ms": min(step_ms), "max_step_ms": max(step_ms),
        "examples_per_s": SAS_B / med * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


def sasrec_markov_on_card():
    """The CPU learning test's model and data (`tests/test_torch_sequential
    .py`), trained on the card through kernel B2: hit@1 > 0.8."""
    from recbox_tpu_torch.data import ArrayLoader
    from recbox_tpu_torch.data.sequential import leave_one_out_split
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.sequential import SASRec
    from recbox_tpu_torch.ops import fused_ce
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    rng = np.random.default_rng(3)
    n_items, seqs = 40, {}
    for u in range(200):
        start = rng.integers(1, n_items + 1)
        seqs[u] = np.array([(start + k - 1) % n_items + 1
                            for k in range(12)])
    train, valid, _ = leave_one_out_split(seqs, max_len=8)
    fm = FeatureMap("seq", (FeatureSpec(
        "item_id", "categorical", source="item", vocab_size=n_items + 1,
        embedding_dim=32),), query_index="user_id", corpus_index="item_id",
        num_items=n_items + 1)
    model = SASRec(fm, embedding_dim=32, max_seq_len=8, n_layers=1,
                   n_heads=2, dropout=0.0, compute_dtype="bfloat16",
                   generator=torch.Generator(device=DEVICE).manual_seed(0),
                   device=DEVICE)
    trainer = Trainer(model, lambda out, b: out,
                      TrainerConfig(learning_rate=5e-3), device=DEVICE,
                      train_method="fused_ce_loss")
    before = fused_ce.launches["fused_ce_bwd"]
    loader = ArrayLoader(train, batch_size=256, drop_last=True, seed=0)
    for _ in range(6):
        for batch in loader:
            batch.pop("__mask__", None)
            trainer.train_step(batch)
    model.eval()
    with torch.no_grad():
        scores = model.full_scores(
            {k: torch.from_numpy(valid[k]).to(DEVICE)
             for k in ("item_seq", "seq_len")})
    hit = float(np.mean(scores.argmax(-1).cpu().numpy() == valid["item_id"]))
    steps = fused_ce.launches["fused_ce_bwd"] - before
    assert steps == 6 * len(loader), steps
    assert hit > 0.8, hit
    return {"hit_at_1": hit, "b2_backward_launches": steps}


def sasrec_60k_comparison():
    """`_bench_sasrec`'s 60k-item regime (`bench.py:339-404`): the same
    model and batch trained through `full_scores` (bf16 logits in memory,
    cuBLAS, full_softmax_loss) and through `fused_ce_loss` (B2), in turns
    (full, fused, fused, full), 12 timed steps each."""
    out = {"full_scores": [], "fused_ce_loss": []}
    for method in ("full_scores", "fused_ce_loss", "fused_ce_loss",
                   "full_scores"):
        trainer, batch = sasrec_setup(SAS_V_SMALL, method)
        trainer.init(batch)
        losses, step_ms = timed_repeat_steps(trainer, batch)
        assert all(np.isfinite(losses)), (method, losses)
        out[method].append(statistics.median(step_ms))
        del trainer, batch
    return {"vocab": SAS_V_SMALL,
            **{f"{m}_median_step_ms": v for m, v in out.items()},
            **{f"{m}_examples_per_s": SAS_B / statistics.mean(v) * 1e3
               for m, v in out.items()}}


def sasrec_breakdown(trainer, batch, steps=None):
    """Device time by kernel group of one steady SASRec 1M step
    (torch.profiler): B2 forward and backward, GEMMs, the rest; the device
    spans of the trainer's phases (Adam over the 1M x 64 table among them);
    the device's idle share of the step's wall time."""
    return train_breakdown(trainer, batch, (
        ("b2_forward", ("ce_fwd", "lse_combine")),
        ("b2_backward", ("ce_bwd", "du_reduce")),
        ("gemm", ("gemm", "nvjet", "sm90", "cutlass", "xmma", "splitk")),
        ("copies_casts", ("copy", "cast", "fill")),
        ("embedding_gather_scatter", ("index", "embedding", "gather",
                                      "scatter")),
    ), steps=steps or (lambda: trainer.train_steps_repeat(batch, 1)))


def criteo_trainer(seed, compute_dtype="bfloat16", trainer_cls=None,
                   **trainer_kw):
    """PackedEmbeddingTrainer over bench.py's DeepFM, as `bench.py:595-626`
    builds it: BCE, Adam 1e-3 with clip 10, AdaGrad on the packs;
    ``trainer_kw`` to the trainer (5p's ``block_rows``, 5r's ``mesh``);
    ``trainer_cls`` another trainer over the same model (5r's `Trainer`)."""
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.ranking import DeepFM
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import (
        PackedEmbeddingTrainer, TrainerConfig,
    )
    feats = tuple(
        FeatureSpec(f"c{i}", "categorical", vocab_size=VOCAB,
                    embedding_dim=DIM) for i in range(NUM_CAT)) + tuple(
        FeatureSpec(f"n{i}", "numeric", embedding_dim=DIM)
        for i in range(NUM_NUM))
    fm = FeatureMap("criteo_bench", feats, labels=("click",))
    model = DeepFM(fm, embedding_dim=DIM, hidden_units=HIDDEN,
                   compute_dtype=compute_dtype, feature_major_compute=True,
                   generator=torch.Generator(device=DEVICE).manual_seed(seed),
                   device=DEVICE)
    cfg = TrainerConfig(learning_rate=1e-3, grad_clip_norm=10.0, epochs=1,
                        seed=seed)
    return (trainer_cls or PackedEmbeddingTrainer)(
        model, lambda o, b: binary_crossentropy(o, b["click"]), cfg,
        device=DEVICE, **trainer_kw)


class CriteoBatches:
    """Batches on the card: ids uniform per field (as `bench.py` draws
    them), numeric N(0, 1), and a click drawn from a fixed logistic model
    whose logit is the sum of per-id weights N(0, 1) of fields c0..c3."""

    def __init__(self, seed):
        self.gen = torch.Generator(device=DEVICE).manual_seed(seed)
        self.weights = torch.randn(4, VOCAB, generator=self.gen,
                                   device=DEVICE)

    def __call__(self):
        g = self.gen
        batch = {f"c{i}": torch.randint(0, VOCAB, (BATCH,), generator=g,
                                        device=DEVICE, dtype=torch.int32)
                 for i in range(NUM_CAT)}
        batch.update({f"n{i}": torch.randn(BATCH, generator=g, device=DEVICE)
                      for i in range(NUM_NUM)})
        logit = sum(self.weights[f, batch[f"c{f}"].long()] for f in range(4))
        batch["click"] = (torch.rand(BATCH, generator=g, device=DEVICE)
                          < torch.sigmoid(logit)).float()
        return batch


CRITEO_GROUPS = (
    ("b1_packed_adagrad_update", ("packed_adagrad_update",)),
    ("gemm", ("gemm", "nvjet", "sm90", "cutlass", "xmma", "splitk")),
    ("gather_index_select", ("gather", "indexselect", "index_select")),
)


def train_breakdown(trainer, batch, groups=CRITEO_GROUPS, steps=None,
                    warmup=True):
    """Device time by kernel of one steady train step (torch.profiler),
    summed into ``groups`` ((name, substrings of a lower-case kernel name),
    first match wins, the rest "other"); the device timeline's span of each
    of the trainer's phases (gather, forward, backward, Adam, row update);
    and the device's idle share of the step's wall time. ``steps`` runs
    once unprofiled first unless ``warmup`` is False (a warm trainer)."""
    from torch.profiler import ProfilerActivity, profile
    step = steps or (lambda: trainer.train_step(batch))
    if warmup:
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    phase_names = ("trainer::", "packed::")
    events = prof.key_averages()
    # the trainer's record_function ranges also show as device rows: the
    # span of the device timeline from their first kernel to their last,
    # gaps included; they are reported apart and kept out of the sums
    phases = {e.key: e.device_time_total / 1e3 for e in events
              if e.key.startswith(phase_names)}
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(phase_names)]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    sums = {name: 0.0 for name, _ in groups}
    sums["other"] = 0.0
    for name, ms, _ in rows:
        low = name.lower().replace("_", "")
        hit = next((g for g, keys in groups
                    if any(k.replace("_", "") in low for k in keys)),
                   "other")
        sums[hit] += ms
    if device_ms == 0:
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                "groups": None, "phase_span_ms": None, "by_kernel": []}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms, "groups": sums,
            "phase_span_ms": phases,
            "by_kernel": [{"name": name[:90], "ms": ms, "count": n}
                          for name, ms, n in rows[:14]]}


def train_criteo():
    """The training path at full width: the counts of B1 reset just before
    the steps and read just after."""
    from recbox_tpu_torch.evaluation import auc_score, log_loss
    from recbox_tpu_torch.ops import packed_delta

    trainer = criteo_trainer(SEED)
    data = CriteoBatches(SEED + 1)
    batches = [data() for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    held_out = data()
    t0 = time.perf_counter()
    trainer.init(batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    (pname, pack), = trainer.packs.items()
    assert tuple(pack.shape) == (NUM_CAT * VOCAB, 128), pack.shape
    packed_delta.reset_launches()
    losses, step_ms = [], []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(batch))
        end.record()
        if i >= WARMUP_STEPS:
            step_ms.append((start, end))
    torch.cuda.synchronize()
    launches = packed_delta.launches["packed_adagrad_update"]
    losses = [float(x) for x in losses]
    step_ms = [s.elapsed_time(e) for s, e in step_ms]
    assert launches == len(batches), (launches, len(batches))
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    labels = held_out.pop("click").cpu().numpy()
    logits = trainer.predict([held_out])
    assert logits.shape == (BATCH,) and np.isfinite(logits).all()
    p = 1 / (1 + np.exp(-logits.astype(np.float64)))
    return trainer, batches[-1], {
        "pack": pname, "pack_shape": list(pack.shape),
        "rows_per_step": NUM_CAT * BATCH, "init_s": init_s,
        "losses": losses, "launches": launches,
        "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
        "examples_per_s": BATCH / statistics.median(step_ms) * 1e3,
        "held_out_auc": auc_score(labels, p),
        "held_out_logloss": log_loss(labels, p),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}


# -- 5c-5e: training to a result ---------------------------------------------

FIT_TRAIN_BATCHES, FIT_HELD_OUT_BATCHES, FIT_K, FIT_BLOCKS = 24, 4, 8, 6
SAS_FIT_BATCHES, SAS_EVAL_USERS = 16, 4096
EXIT_SEEDS = (2024, 1, 2, 3, 4)
# 5e's seeds: the first three, a depth cut that keeps the script inside its
# time (the exits' 5-seed readings are in PERF.md §7)
CARD_EXIT_SEEDS = EXIT_SEEDS[:3]


def clone_state(obj):
    """A deep copy of a trainer's `state_dict` (its tensors are the live
    ones)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: clone_state(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [clone_state(v) for v in obj]
    return obj


def stacked(batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def fused_vs_eager(trainer, batches, launches):
    """Ms a step of the same batches through eager `train_step` and through
    `train_steps_fused`: FIT_BLOCKS blocks of FIT_K steps a side, in turns
    (eager then fused, fused then eager, ...), the chunks of ``batches``
    taken in a round, each block by the host clock to a synchronize. The
    kernel's launches counted over the fused calls (one a step)."""
    fused_counts = {k: 0 for k in launches}

    def eager(chunk, _):
        for b in chunk:
            trainer.train_step(b)

    def fused(_, stack):
        before = dict(launches)
        trainer.train_steps_fused(stack)
        for k in fused_counts:
            fused_counts[k] += launches[k] - before[k]

    chunks = [batches[i:i + FIT_K]
              for i in range(0, len(batches) - FIT_K + 1, FIT_K)]
    stacks = [stacked(c) for c in chunks]
    blocks = {"eager": [], "fused": []}
    torch.cuda.synchronize()
    for i in range(FIT_BLOCKS):
        arg = (chunks[i % len(chunks)], stacks[i % len(chunks)])
        order = (("eager", eager), ("fused", fused))
        for name, call in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            call(*arg)
            torch.cuda.synchronize()
            blocks[name].append((time.perf_counter() - t0) * 1e3 / FIT_K)
    n_fused = FIT_K * FIT_BLOCKS
    bsz = len(next(iter(batches[0].values())))
    med = {name: statistics.median(v) for name, v in blocks.items()}
    out = {"blocks_a_side": FIT_BLOCKS, "block_steps": FIT_K,
           "fused_steps": n_fused, "fused_launches": fused_counts,
           "per_step_launches": {k: v / n_fused
                                 for k, v in fused_counts.items()},
           "eager_over_fused": med["eager"] / med["fused"],
           "eager_over_fused_range": [min(blocks["eager"])
                                      / max(blocks["fused"]),
                                      max(blocks["eager"])
                                      / min(blocks["fused"])]}
    for name, v in blocks.items():
        out.update({f"{name}_block_ms_per_step": v,
                    f"{name}_median_ms": med[name],
                    f"{name}_min_ms": min(v), f"{name}_max_ms": max(v),
                    f"{name}_examples_per_s": bsz / med[name] * 1e3})
    return out


def graph_step_matches_eager(trainer, batch, tensors):
    """One replayed step and one eager step from the same state on the same
    batch, with the same dropout draws (the trainer's generator set back
    between them): the losses agree within 1e-5 of the loss, and each of
    ``tensors()`` (name -> live tensor) moves by the same update (within
    1e-3 of the update's largest entry: B1's atomics add duplicates in no
    fixed order). An lr baked into the graph at another value would move
    them by another factor; a replay that skipped a kernel, another loss."""
    # detached copies: a copy that kept a parameter's autograd node alive
    # would tie the capture to the stream that made it
    snap = clone_state(trainer.state_dict())
    gen = trainer.dropout_generator
    draws = gen.get_state() if gen is not None else None
    before = {k: v.detach().clone() for k, v in tensors().items()}
    loss_graph = float(trainer.train_steps_fused(stacked([batch]))[0])
    graph = {k: v.detach().clone() for k, v in tensors().items()}
    trainer.load_state_dict(snap)
    if gen is not None:
        gen.set_state(draws)
    loss_eager = float(trainer.train_step(batch))
    assert abs(loss_graph - loss_eager) <= 1e-5 * abs(loss_eager), \
        (loss_graph, loss_eager)
    out = {"loss": {"graph": loss_graph, "eager": loss_eager}}
    for k, v in tensors().items():
        upd = (v - before[k]).abs().max().item()
        err = (graph[k] - v).abs().max().item()
        assert upd > 0 and err <= 1e-3 * upd, (k, err, upd)
        out[k] = {"max_update": upd, "max_abs_diff": err}
    trainer.load_state_dict(snap)
    return out


def fit_criteo():
    """Phase 5c: `fit` of phase 5's trainer over 24 batches for 2 epochs,
    FIT_K steps a `train_steps_fused` call, `CTREvaluator` on 4 held-out
    batches; a plateau forced at the second evaluation (the monitored
    value is 1 at the first and 0 at the second), then the replayed step
    held to an eager one at the decayed lr; save / load into a fresh
    trainer, `predict` bit for bit; eager against fused examples/s."""
    import tempfile
    from recbox_tpu_torch.evaluation import CTREvaluator
    from recbox_tpu_torch.ops import packed_delta

    from recbox_tpu_torch.training import Monitor

    trainer = criteo_trainer(SEED)
    cfg = trainer.config
    cfg.epochs, cfg.fused_steps, cfg.lr_decay_factor = 2, FIT_K, 0.1
    trainer.monitor = Monitor("forced", "max", patience=2)
    data = CriteoBatches(SEED + 2)
    batches = [data() for _ in range(FIT_TRAIN_BATCHES)]
    held = [data() for _ in range(FIT_HELD_OUT_BATCHES)]
    held_np = {k: torch.cat([b[k] for b in held]).cpu().numpy()
               for k in held[0]}
    ctr = CTREvaluator(held_np, label="click", metrics=["AUC", "logloss"],
                       batch_size=BATCH)
    evals = []

    def eval_fn(tr):
        t0 = time.perf_counter()
        metrics = ctr(tr)
        evals.append({"epoch": tr.epoch, "lr": tr.learning_rate,
                      "emb_lr": tr._emb_lr, "eval_s":
                      time.perf_counter() - t0, **metrics})
        return {**metrics, "forced": 1.0 if len(evals) == 1 else 0.0}

    trainer.eval_fn = eval_fn
    trainer.init(batches[0])
    lr0, emb0 = trainer.learning_rate, trainer._resolve_emb_lr()
    packed_delta.reset_launches()
    t0 = time.perf_counter()
    trainer.fit(list(batches))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = packed_delta.launches["packed_adagrad_update"]
    steps = cfg.epochs * FIT_TRAIN_BATCHES
    assert trainer.step == steps and launches == steps, (trainer.step,
                                                         launches)
    assert len(evals) == 2 and trainer.monitor.best_epoch == 0, evals
    # the label is a logistic rule of the ids of c0..c3, learnt by the best
    # (first) epoch, whose weights the plateau reloads
    assert evals[0]["AUC"] > 0.5, evals
    lr1, emb1 = trainer.learning_rate, trainer._emb_lr
    assert math.isclose(lr1, lr0 * 0.1, rel_tol=1e-6) \
        and math.isclose(emb1, emb0 * 0.1, rel_tol=1e-6), (lr1, emb1)
    capture_s = trainer._graph.capture_seconds
    # the next fused step captures again, at the decayed embedding lr
    (pname,) = trainer.packs
    match = graph_step_matches_eager(
        trainer, batches[0],
        lambda: {"pack": trainer.packs[pname],
                 "dnn_w1": trainer.params["dnn_w1"]})
    assert trainer._graph.token == emb1, (trainer._graph.token, emb1)
    t0 = time.perf_counter()
    trainer._capture_best()
    torch.cuda.synchronize()
    best_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        trainer.save(path)
        save_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(path)
        fresh = criteo_trainer(SEED + 7)
        fresh.init(batches[0])
        t0 = time.perf_counter()
        fresh.load(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    probe = {k: v for k, v in held[0].items() if k != "click"}
    same = np.array_equal(trainer.predict([dict(probe)]),
                          fresh.predict([dict(probe)]))
    assert same and fresh.step == trainer.step \
        and fresh._emb_lr == trainer._emb_lr
    del fresh
    speed = fused_vs_eager(trainer, batches, packed_delta.launches)
    assert speed["fused_launches"]["packed_adagrad_update"] \
        == speed["fused_steps"], speed
    return trainer, batches[0], {
        "fit_s": fit_s, "steps": steps, "fused_steps": cfg.fused_steps,
        "b1_launches": launches, "evals": evals,
        "lr": [lr0, lr1], "emb_lr": [emb0, emb1],
        "replay_vs_eager_after_plateau": match,
        "capture_s": capture_s, "recapture_s": trainer._graph.capture_seconds,
        "capture_best_s": best_s, "checkpoint_bytes": ckpt_bytes,
        "save_s": save_s, "load_s": load_s, "predict_bit_equal": same,
        **speed}


def sasrec_batches(n, seed):
    """``n`` batches drawn as `bench.py:434-438` draws one, on the card."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"item_seq": rng.integers(1, SAS_V, (SAS_B, SAS_L)),
             "seq_len": np.full(SAS_B, SAS_L),
             "item_id": rng.integers(1, SAS_V, SAS_B)}
        out.append({k: torch.from_numpy(v.astype(np.int32)).to(DEVICE)
                    for k, v in b.items()})
    return out


def fit_sasrec_1m():
    """Phase 5d: `fit` of phase 5b's trainer over 16 batches for 2 epochs,
    FIT_K steps a fused call, evaluated each epoch by `evaluate_retrieval`
    (4096 held-out users, full sort over the 1M items through the chunk
    clamp); two replays draw different dropout masks; a replayed step
    equals an eager one with the same draws (loss, the 1M x 64 table, an
    encoder weight); B2 launches once each way a step; eager against
    fused examples/s."""
    from recbox_tpu_torch.evaluation import evaluate_retrieval
    from recbox_tpu_torch.nn.core import Dropout
    from recbox_tpu_torch.ops import fused_ce
    from recbox_tpu_torch.training import Monitor

    trainer, _ = sasrec_setup(SAS_V, "fused_ce_loss")
    cfg = trainer.config
    cfg.epochs, cfg.fused_steps = 2, FIT_K
    trainer.monitor = Monitor("NDCG(k=10)", "max", patience=2)
    batches = sasrec_batches(SAS_FIT_BATCHES, SEED + 3)
    held = sasrec_batches(SAS_EVAL_USERS // SAS_B, SEED + 4)
    held = {k: torch.cat([b[k] for b in held]) for k in held[0]}
    targets = held["item_id"].cpu().numpy()
    evals = []

    def eval_fn(tr):
        t0 = time.perf_counter()
        users = tr.apply({"item_seq": held["item_seq"],
                          "seq_len": held["seq_len"]}, method="user_tower")
        metrics = evaluate_retrieval(
            users, tr.model.emb_item.detach(), {},
            {u: [int(t)] for u, t in enumerate(targets)},
            range(SAS_EVAL_USERS), ["Recall(k=10)", "NDCG(k=10)"],
            chunk_size=4096, exclude_items=(0,), device=DEVICE)
        torch.cuda.synchronize()
        evals.append({"epoch": tr.epoch, "eval_s":
                      time.perf_counter() - t0, **metrics})
        return metrics

    trainer.eval_fn = eval_fn
    drop = next(m for m in trainer.model.modules() if isinstance(m, Dropout))
    seen = []

    def keep_output(module, inputs, output):
        if module.training:
            seen[:] = [output.detach()]

    hook = drop.register_forward_hook(keep_output)
    trainer.init(batches[0])
    fused_ce.reset_launches()
    t0 = time.perf_counter()
    trainer.fit(list(batches))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(fused_ce.launches)
    steps = cfg.epochs * SAS_FIT_BATCHES
    assert launches == {"fused_ce_fwd": steps, "fused_ce_bwd": steps}, \
        launches
    assert len(evals) == 2 and all(np.isfinite(e["NDCG(k=10)"])
                                   for e in evals), evals
    # the hooked output is the captured step's, rewritten by each replay
    masks = []
    for b in batches[:2]:
        trainer.train_steps_fused(stacked([b]))
        torch.cuda.synchronize()
        masks.append(seen[0] != 0)
    hook.remove()
    drop_rate = [1 - float(m.float().mean()) for m in masks]
    differ = float((masks[0] != masks[1]).float().mean())
    assert all(0.08 < r < 0.12 for r in drop_rate) and differ > 0.1, \
        (drop_rate, differ)
    # after the masks: the check's eager step replaces the hooked tensor
    params = trainer.params
    match = graph_step_matches_eager(
        trainer, batches[0],
        lambda: {k: params[k] for k in ("emb_item",
                                        "sasrec.encoder.q0.weight")})
    speed = fused_vs_eager(trainer, batches, fused_ce.launches)
    n = speed["fused_steps"]
    assert speed["fused_launches"] == {"fused_ce_fwd": n,
                                       "fused_ce_bwd": n}, speed
    return trainer, batches[0], {
        "fit_s": fit_s, "steps": steps, "b2_launches": launches,
        "evals": evals, "eval_users": SAS_EVAL_USERS,
        "replay_vs_eager": match,
        "eval_chunk": (1 << 28) // SAS_V,
        "dropout_drop_rate": drop_rate, "dropout_masks_differ": differ,
        "capture_s": trainer._graph.capture_seconds, **speed}


def quality_exits_on_card():
    """Phase 5e: `tools/quality_exit.py`'s DeepFM synthctr and SASRec
    synthseq runs, and the DCNv2 ('stacked') / xDeepFM (CIN relu) synthctr
    runs, on the card, seeds CARD_EXIT_SEEDS; valid and test metrics a
    seed and the medians of the test metrics. Then SASRec's first seed
    again through the 1M-item trainer's path (`fused`: kernel B2's loss,
    8-step `train_steps_fused` graphs), one B2 forward and backward a step,
    its test metrics within 0.02 (the exit's SASRec limit) of the median
    of the `full_scores` runs."""
    import tempfile
    from recbox_tpu_torch.ops import fused_ce
    from recbox_tpu_torch.tools import quality_exit as qe
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("deepfm", "sasrec", "dcnv2", "xdeepfm"):
            gen, run = qe.RUNS[name]
            data_dir = gen(tmp)
            runs = []
            for seed in CARD_EXIT_SEEDS:
                t0 = time.perf_counter()
                res = run(data_dir, seed, DEVICE)
                res["seconds"] = time.perf_counter() - t0
                assert all(np.isfinite(v) for v in res["test"].values()), res
                runs.append({"seed": seed, **res})
            out[name] = {"runs": runs, "median_test": {
                k: statistics.median(r["test"][k] for r in runs)
                for k in runs[0]["test"]}}
        fused_ce.reset_launches()
        t0 = time.perf_counter()
        res = qe.run_sasrec(qe.gen_seq(tmp), EXIT_SEEDS[0], DEVICE,
                            fused=True)
        res["seconds"] = time.perf_counter() - t0
    res["b2_launches"] = dict(fused_ce.launches)
    assert res["b2_launches"] == {"fused_ce_fwd": res["steps"],
                                  "fused_ce_bwd": res["steps"]}, res
    median = out["sasrec"]["median_test"]
    assert all(abs(res["test"][k] - median[k]) < 0.02 for k in median), \
        (res, median)
    out["sasrec_fused"] = {"seed": EXIT_SEEDS[0], **res}
    return out


# -- 5f-5g: matching, from training to serving ----------------------------------

# bench.py's LightGCN regime (`bench.py:471-538`): 30,000 users x 41,000
# items, 1M interactions, d = 64, 3 hops, BPR over one negative, batch 2048
LG_USERS, LG_ITEMS, LG_INTER, LG_DIM, LG_HOPS, LG_BATCH = \
    30_000, 41_000, 1_000_000, 64, 3, 2048
LG_BLOCKS, LG_OWN, LG_HELD = 64, 0.9, 0.1
LG_EPOCHS, LG_EVAL_USERS, LG_K, LG_TIMED_BATCHES = 2, 4096, 20, 16
# held-out Recall@20 after training, as a multiple of chance (20 / 41,000)
LG_CHANCE_FACTOR = 10.0
LG_GROUPS = (
    ("index_add", ("indexfunc", "index_add", "indexadd")),
    ("gather_index_select", ("indexselect", "index_select", "gather")),
    ("adam_foreach", ("multitensor", "multi_tensor", "foreach")),
    ("gemm", ("gemm", "nvjet", "sm90", "cutlass", "xmma", "splitk")),
)


def lightgcn_data(seed=SEED):
    """LG_INTER distinct (user, item) pairs with a planted structure: users
    and items in LG_BLOCKS blocks (the items' blocks a random permutation
    of the ids, so a block's items lie scattered over the corpus as a
    catalog's ids would), a pair's item from its user's block with
    probability LG_OWN, else uniform.
    LG_HELD of each user's pairs (rounded down) are held out. Returns
    (train users, train items, held-out user -> items, train user ->
    items)."""
    rng = np.random.default_rng(seed)
    ub = rng.integers(0, LG_BLOCKS, LG_USERS)
    # block b's items: members[b, :] (ids in a random order)
    members = rng.permutation(LG_ITEMS)[:LG_ITEMS // LG_BLOCKS * LG_BLOCKS] \
        .reshape(LG_ITEMS // LG_BLOCKS, LG_BLOCKS).T
    extra = 1.05
    while True:     # draw until LG_INTER distinct pairs, keep the first
        n = int(LG_INTER * extra)
        u = rng.integers(0, LG_USERS, n)
        own = members[ub[u], rng.integers(0, LG_ITEMS // LG_BLOCKS, n)]
        items = np.where(rng.random(n) < LG_OWN, own,
                         rng.integers(0, LG_ITEMS, n))
        _, first = np.unique(u * LG_ITEMS + items, return_index=True)
        if len(first) >= LG_INTER:
            break
        extra += 0.25
    keep = np.sort(first)[:LG_INTER]
    u, items = u[keep], items[keep]
    # rank of each pair inside its user, in a random order
    order = np.lexsort((rng.random(LG_INTER), u))
    us = u[order]
    starts = np.flatnonzero(np.r_[True, us[1:] != us[:-1]])
    counts = np.diff(np.r_[starts, LG_INTER])
    rank = np.arange(LG_INTER) - np.repeat(starts, counts)
    held = np.zeros(LG_INTER, bool)
    held[order] = rank < np.floor(LG_HELD * np.repeat(counts, counts))

    def u2i(sel):
        out = {}
        for a, b in zip(u[sel].tolist(), items[sel].tolist()):
            out.setdefault(a, []).append(b)
        return out

    return (u[~held].astype(np.int32), items[~held].astype(np.int32),
            u2i(held), u2i(~held))


def lightgcn_trainer(train_users, train_items, seed=SEED, mesh=None):
    """Trainer(LightGCN) at bench.py's width over the train edges, on
    ``mesh`` when one is given."""
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.matching import LightGCN, build_norm_edges
    from recbox_tpu_torch.ops.losses import get_matching_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    fm = FeatureMap("lgcn", (
        FeatureSpec("user_id", "categorical", "user", vocab_size=LG_USERS,
                    embedding_dim=LG_DIM),
        FeatureSpec("item_id", "categorical", "item", vocab_size=LG_ITEMS,
                    embedding_dim=LG_DIM)),
        query_index="user_id", corpus_index="item_id", num_items=LG_ITEMS)
    eu, ei, c = build_norm_edges(train_users, train_items, LG_USERS,
                                 LG_ITEMS)
    model = LightGCN(fm, embedding_dim=LG_DIM, num_users=LG_USERS,
                     num_items=LG_ITEMS, n_layers=LG_HOPS, edge_users=eu,
                     edge_items=ei, edge_coefs=c,
                     generator=torch.Generator(device=DEVICE).manual_seed(
                         seed), device=DEVICE)
    bpr = get_matching_loss("PairwiseLogisticLoss")
    cfg = TrainerConfig(learning_rate=1e-3, epochs=LG_EPOCHS,
                        fused_steps=FIT_K, patience=LG_EPOCHS + 1,
                        monitor="Recall(k=20)", lr_decay_factor=1.0,
                        reload_best_on_plateau=False, seed=seed)
    return fm, Trainer(model, lambda o, b: bpr(o), cfg, mesh=mesh,
                       device=DEVICE), len(eu)


def fit_lightgcn():
    """Phase 5f: LightGCN from training to serving at bench.py's width:
    `MatchingLoader` (one uniform negative, drawn anew each epoch), `fit`
    for LG_EPOCHS epochs in FIT_K-step `train_steps_fused` calls, a full
    sort `RetrievalEvaluator` over LG_EVAL_USERS held-out users each epoch,
    then once with protocol 'uni100'; eager against replayed ms a step; one
    replayed step profiled; then `RetrievalService.from_trainer` over the
    trained towers, bf16 and int8, queried for N_QUERIES users at k = 20,
    B3's and B4's counts reset just before and read just after each
    query."""
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.evaluation import RetrievalEvaluator
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops import mips_topk
    from recbox_tpu_torch.retrieval import RetrievalService
    from recbox_tpu_torch.training.graph import kernel_counters

    t0 = time.perf_counter()
    tr_u, tr_i, held, train_u2i = lightgcn_data()
    fm, trainer, n_edges = lightgcn_trainer(tr_u, tr_i)
    data_s = time.perf_counter() - t0
    corpus = {"item_id": np.arange(LG_ITEMS, dtype=np.int32)}
    loader = MatchingLoader(fm, {"user_id": tr_u, "item_id": tr_i}, corpus,
                            batch_size=LG_BATCH, num_negs=1,
                            exclude_seen=False, seed=SEED)
    eval_users = np.array(sorted(held)[:LG_EVAL_USERS], np.int32)
    metrics = ["Recall(k=20)", "NDCG(k=20)"]
    full = RetrievalEvaluator({"user_id": eval_users}, corpus, eval_users,
                              train_u2i, held, metrics=metrics)
    evals = []

    def eval_fn(tr):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = full(tr)
        torch.cuda.synchronize()
        evals.append({"epoch": tr.epoch, "step": tr.step,
                      "eval_s": time.perf_counter() - t, **out})
        return out

    trainer.eval_fn = eval_fn
    epoch_s = []

    class Timed:
        """The loader, the seconds of each epoch (its sampling pass, the
        steps and the evaluation) recorded."""

        def __iter__(self):
            t = time.perf_counter()
            yield from loader
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t)

        def __getattr__(self, name):
            return getattr(loader, name)

    # the loader's sampling pass and batch assembly alone, one epoch
    t = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    host_epoch_s = time.perf_counter() - t
    # the training step and the evaluators launch none of the port's
    # kernels: LightGCN's hops are index_select / index_add_
    kernel_counts = [dict(c) for c in kernel_counters()]
    t = time.perf_counter()
    trainer.fit(Timed())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    assert [dict(c) for c in kernel_counters()] == kernel_counts
    steps, fit_steps = LG_EPOCHS * n_batches, trainer.step
    chance = LG_K / LG_ITEMS
    recall = [e["Recall(k=20)"] for e in evals]
    t = time.perf_counter()
    uni = RetrievalEvaluator({"user_id": eval_users}, corpus, eval_users,
                             train_u2i, held, metrics=metrics,
                             protocol="uni100")(trainer)
    torch.cuda.synchronize()
    uni_s = time.perf_counter() - t

    # eager against replayed steps, then one replayed step profiled
    batches = []
    for b in loader:
        batches.append({k: torch.from_numpy(v).to(DEVICE)
                        for k, v in b.items()})
        if len(batches) == LG_TIMED_BATCHES:
            break
    speed = fused_vs_eager(trainer, batches, {})
    profiled = train_breakdown(
        trainer, batches[0], LG_GROUPS,
        steps=lambda: trainer.train_steps_fused(stacked([batches[0]])))

    # one forward propagation (3 hops, both sides): what every encode
    # batch of the evaluators and of the service pays again
    with torch.no_grad():
        trainer.model.eval()
        propagate_ms = cuda_ms(trainer.model.propagated) \
            if DEVICE == "cuda" else None
    # serving from the trained towers through B3
    rng = np.random.default_rng(SEED + 5)
    users = {"user_id": rng.integers(0, LG_USERS, N_QUERIES)
             .astype(np.int32)}
    t = time.perf_counter()
    svc = RetrievalService.from_trainer(trainer, corpus)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t
    svc8 = RetrievalService(trainer.model, item_embs=svc.item_embs,
                            method="auto", quantize="int8",
                            device=svc.device)
    serve = {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        s.query(users, k=LG_K)                   # warm
        counts = []
        for _ in range(3):
            fused.reset_launches()
            mips_topk.reset_launches()
            scores, ids = s.query(users, k=LG_K)
            counts.append({"select": sum(fused.launches.values()),
                           **mips_topk.route_launches})
        assert scores.shape == ids.shape == (N_QUERIES, LG_K)
        assert np.isfinite(scores).all() and (ids >= 0).all() \
            and (ids < LG_ITEMS).all()
        assert (np.diff(scores, axis=1) <= 0).all()
        walls = []
        for _ in range(5):
            t = time.perf_counter()
            s.query(users, k=LG_K)
            walls.append(time.perf_counter() - t)
        serve[name] = {"launches_a_query": counts,
                       "recall_vs_exact": recall_vs_bf16_oracle(
                           s, users, ids, k=LG_K),
                       "queries_per_s": N_QUERIES / statistics.median(walls),
                       "query_wall_ms": [w * 1e3 for w in walls]}
    res = {
        "users": LG_USERS, "items": LG_ITEMS, "interactions": LG_INTER,
        "train_edges": n_edges, "held_out": sum(map(len, held.values())),
        "dim": LG_DIM, "hops": LG_HOPS, "batch": LG_BATCH,
        "batches_an_epoch": n_batches, "steps": steps,
        "data_and_model_s": data_s, "loader_epoch_host_s": host_epoch_s,
        "fit_s": fit_s, "epoch_s": epoch_s, "evals": evals,
        "chance_recall": chance,
        "recall_over_chance": [r / chance for r in recall],
        "uni100": uni, "uni100_eval_s": uni_s,
        "capture_s": trainer._graph.capture_seconds,
        "step_speed": speed, "replayed_step_profile": profiled,
        "propagate_ms": propagate_ms, "corpus_encode_s": encode_s,
        "serve": serve}
    # the measurements first, then B3 alone at this shape, then the checks
    emit({"phase": "fit_lightgcn_measured", **res})
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    res["b3_check"] = {v: check_kernel(v, LG_ITEMS, LG_DIM, N_QUERIES, LG_K,
                                       gen) for v in ("bf16", "int8")}
    res["b3_at_this_shape"] = {v: time_kernel(v, LG_ITEMS, LG_DIM,
                                              N_QUERIES, LG_K, gen)
                               for v in ("bf16", "int8")}
    assert fit_steps == steps and len(evals) == LG_EPOCHS, \
        (fit_steps, steps, evals)
    assert all(np.isfinite(list(e.values())).all() for e in evals)
    assert recall[-1] > LG_CHANCE_FACTOR * chance, (recall, chance)
    assert uni["Recall(k=20)"] > recall[-1], (uni, recall)
    for name, v in serve.items():
        assert all(c["select"] == 1 and c["wgmma"] == 1 and c["tile"] == 0
                   for c in v["launches_a_query"]), (name, v)
    assert serve["bf16"]["recall_vs_exact"] >= 0.95 \
        and serve["int8"]["recall_vs_exact"] >= 0.90, serve
    return res


def sparse_mf_graph_check():
    """`SparseEmbeddingTrainer(MF)` on the card over the synth exit's data
    (MatchingLoader batches of 256, one negative): 16 eager `train_step`s
    against two 8-step `train_steps_fused` calls (the first warms up and
    captures the step, the second only replays it) from the same initial
    weights on the same batches; the losses within 1e-5 of the loss, the
    tables and accumulators within 1e-3 of their largest total update
    (`index_add_` adds repeated ids with atomics, in no fixed order).
    Then `RetrievalService.from_trainer` serves the live tables."""
    import tempfile
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.models.matching import MF
    from recbox_tpu_torch.ops.losses import get_matching_loss
    from recbox_tpu_torch.retrieval import RetrievalService
    from recbox_tpu_torch.tools import quality_exit as qe
    from recbox_tpu_torch.training import (
        SparseEmbeddingTrainer, TrainerConfig,
    )
    with tempfile.TemporaryDirectory() as tmp:
        (_, fm, arrays, corpus, *_rest) = qe.matching_setup(
            qe.gen_synth(tmp), EXIT_SEEDS[0])
    loader = MatchingLoader(fm, arrays, corpus, batch_size=256, num_negs=1,
                            seed=SEED)
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}
               for b in list(loader)[:2 * FIT_K]]
    assert len(batches) == 2 * FIT_K
    bpr = get_matching_loss("PairwiseLogisticLoss")
    trainers = []
    for _ in range(2):
        model = MF(fm, embedding_dim=32, device=DEVICE,
                   generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        trainers.append(SparseEmbeddingTrainer(
            model, lambda o, b: bpr(o),
            TrainerConfig(learning_rate=5e-2, embedding_regularizer=1e-4),
            device=DEVICE))
    eager, fused = trainers
    eager.init(batches[0])
    fused.init(batches[0])
    start = {k: t.detach().clone() for k, t in eager.tables.items()}
    le = torch.stack([eager.train_step(b) for b in batches])
    lf = torch.cat([fused.train_steps_fused(stacked(batches[i:i + FIT_K]))
                    for i in (0, FIT_K)])
    torch.cuda.synchronize()
    loss_err = float((le - lf).abs().max() / le.abs().max())
    assert loss_err <= 1e-5, (le, lf)
    out = {"steps": len(batches), "loss_rel_err": loss_err,
           "capture_s": fused._graph.capture_seconds}
    for k in eager.tables:
        live, other = eager.tables[k].detach(), fused.tables[k].detach()
        upd = float((live - start[k]).abs().max())
        err = float((live - other).abs().max())
        acc_err = float((eager.accumulators[k] - fused.accumulators[k])
                        .abs().max() / eager.accumulators[k].abs().max())
        assert upd > 0 and err <= 1e-3 * upd and acc_err <= 1e-3, \
            (k, err, upd, acc_err)
        out[k] = {"max_update": upd, "max_abs_diff": err,
                  "acc_rel_diff": acc_err}
    svc = RetrievalService.from_trainer(fused, corpus)
    assert svc.model.item_embedding.tables["item_id"] is \
        fused.tables["item_embedding/emb_item_id"]
    s, i = svc.query({"user_id": np.arange(64, dtype=np.int32)}, k=20)
    assert np.isfinite(s).all() and i.shape == (64, 20)
    return out


# epochs of 5g's MF-BPR run on ml1m_scale (~5.8 s each on the card; the
# exit's 30-epoch reading there is in PERF.md §7), a depth cut that keeps
# the script inside its time (1, for phase 5t's time)
ML1M_EXIT_EPOCHS = 1


def matching_exits_on_card():
    """Phase 5g: the sparse trainer's graph check, then
    `tools/quality_exit.py`'s MF-BPR and LightGCN runs on synth at seeds
    EXIT_SEEDS (30 epochs) and MF-BPR on ml1m_scale at the first seed for
    ML1M_EXIT_EPOCHS, on the card: valid and test metrics a seed, and the
    medians."""
    import tempfile
    from recbox_tpu_torch.tools import quality_exit as qe
    out = {"sparse_trainer_graph": sparse_mf_graph_check()}
    with tempfile.TemporaryDirectory() as tmp:
        runs = [("bpr", qe.gen_synth, EXIT_SEEDS, 30),
                ("lightgcn", qe.gen_synth, EXIT_SEEDS, 30),
                ("bpr_ml1m_scale", qe.gen_ml1m_scale, EXIT_SEEDS[:1],
                 ML1M_EXIT_EPOCHS)]
        for name, gen, seeds, epochs in runs:
            data_dir = gen(tmp)
            run = qe.run_lightgcn if name == "lightgcn" else qe.run_bpr
            res = []
            for seed in seeds:
                t0 = time.perf_counter()
                r = run(data_dir, seed, DEVICE, epochs=epochs)
                r["seconds"] = time.perf_counter() - t0
                assert all(np.isfinite(v) for v in r["test"].values()), r
                res.append({"seed": seed, **r})
            out[name] = {"epochs": epochs, "runs": res, "median_test": {
                k: statistics.median(r["test"][k] for r in res)
                for k in res[0]["test"]}}
    return out


# -- 5h-5i: the cascade's ranking and reranking stages -------------------------

# the CTR zoo at the Criteo width: `configs/models/dcnv2.yaml` and
# `configs/models/xdeepfm.yaml` (dim 16, f32), over phase 5's 26 + 13 fields
ZOO_DIM = 16
ZOO_MODELS = {"DCNv2": dict(num_cross_layers=3, hidden_units=(400, 400),
                            dropout=0.0, model_structure="parallel",
                            use_low_rank_mixture=False),
              "xDeepFM": dict(cin_layer_sizes=(16, 16),
                              hidden_units=(400, 400), dropout=0.0)}
ZOO_XDEEPFM_STEPS = 16
ZOO_GROUPS = (
    ("b1_packed_adagrad_update", ("packed_adagrad_update",)),
    ("gemm", ("gemm", "nvjet", "sm90", "cutlass", "xmma", "splitk")),
    ("gather_index_select", ("gather", "indexselect", "index_select")),
    ("copies", ("copy", "catarray", "memcpy", "memset")),
    ("elementwise", ("elementwise", "reduce")),
)


def zoo_feature_map(labels=("click",), dim=ZOO_DIM):
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    feats = tuple(
        FeatureSpec(f"c{i}", "categorical", vocab_size=VOCAB,
                    embedding_dim=dim) for i in range(NUM_CAT)) + tuple(
        FeatureSpec(f"n{i}", "numeric", embedding_dim=dim)
        for i in range(NUM_NUM))
    return FeatureMap("criteo_zoo", feats, labels=labels)


def zoo_trainer(name, seed):
    """PackedEmbeddingTrainer over ``name`` at its config's widths: BCE,
    Adam 1e-3 with clip 10, AdaGrad on the packs, 8 steps a fused call."""
    from recbox_tpu_torch.models import ranking
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import (
        PackedEmbeddingTrainer, TrainerConfig,
    )
    model = getattr(ranking, name)(
        zoo_feature_map(), embedding_dim=ZOO_DIM, **ZOO_MODELS[name],
        generator=torch.Generator(device=DEVICE).manual_seed(seed),
        device=DEVICE)
    cfg = TrainerConfig(learning_rate=1e-3, grad_clip_norm=10.0, epochs=1,
                        seed=seed, fused_steps=FIT_K)
    return PackedEmbeddingTrainer(
        model, lambda o, b: binary_crossentropy(o, b["click"]), cfg,
        device=DEVICE)


def zoo_criteo():
    """Phase 5h: the CTR zoo through B1 at the Criteo width.

    `run_ranking_experiment(model: DCNv2, trainer: packed)` over phase 5's
    arrays (24 batches of 32768, 1 epoch, 8 steps a fused call, the
    logistic label of `CriteoBatches`), `CTREvaluator` on 4 held-out
    batches (AUC above 0.5), B1's count reset just before and read just
    after (one launch a step). Then the same trainer alone: eager against
    replayed ms a step (`fused_vs_eager`), a replayed step equal to an
    eager one (the pack and a cross weight), one replayed step under
    torch.profiler (device time by group, idle share). Then B1 at DCNv2's
    one-slot layout against its plain version, its bound and
    `index_add_`; then xDeepFM at its config's widths: 16 steps in two
    fused calls, falling loss, one B1 launch a step, ms a replayed step,
    and B1 at xDeepFM's 16 + 1 layout (f32 gradients) checked against its
    plain version at the full shape and timed."""
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.quick_start import run_ranking_experiment

    data = CriteoBatches(SEED + 3)
    batches = [data() for _ in range(FIT_TRAIN_BATCHES)]
    held = [data() for _ in range(FIT_HELD_OUT_BATCHES)]

    def arrays(bs):
        return {k: torch.cat([b[k] for b in bs]).cpu().numpy()
                for k in bs[0]}

    config = {"model": "DCNv2", "embedding_dim": ZOO_DIM,
              **ZOO_MODELS["DCNv2"], "trainer": "packed",
              "batch_size": BATCH, "epochs": 1, "fused_steps": FIT_K,
              "learning_rate": 1e-3, "grad_clip_norm": 10.0, "seed": SEED,
              "monitor": "AUC", "metrics": ["AUC", "logloss"]}
    packed_delta.reset_launches()
    t0 = time.perf_counter()
    result = run_ranking_experiment(config, zoo_feature_map(),
                                    arrays(batches), arrays(held),
                                    device=DEVICE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = packed_delta.launches["packed_adagrad_update"]
    assert launches == FIT_TRAIN_BATCHES, launches
    assert result["AUC"] > 0.5 and np.isfinite(result["logloss"]), result
    out = {"run_ranking_experiment": {
        "model": "DCNv2", "steps": FIT_TRAIN_BATCHES, "fit_s": fit_s,
        "b1_launches": launches, **result}}

    trainer = zoo_trainer("DCNv2", SEED)
    trainer.init(batches[0])
    (pname, pack), = trainer.packs.items()
    slots = trainer._slots[pname]
    assert tuple(pack.shape) == (NUM_CAT * VOCAB, 128) \
        and [s.dim for s in slots] == list(B1_ZOO_DIMS), (pname, slots)
    speed = fused_vs_eager(trainer, batches, packed_delta.launches)
    assert speed["fused_launches"]["packed_adagrad_update"] \
        == speed["fused_steps"], speed
    match = graph_step_matches_eager(
        trainer, batches[0],
        lambda: {"pack": trainer.packs[pname],
                 "cross_dense0": trainer.params["CrossNetV2_0.dense0.weight"]})
    profile = train_breakdown(
        trainer, batches[0], groups=ZOO_GROUPS,
        steps=lambda: trainer.train_steps_fused(stacked([batches[0]])))
    out["dcnv2"] = {"pack": pname, "pack_shape": list(pack.shape),
                    "slots": [s.dim for s in slots],
                    "replay_vs_eager": match, "replayed_step_profile":
                    profile, **speed}
    del trainer
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    out["b1_one_slot_check"] = check_b1(gen, "uniform", B1_ZOO_DIMS,
                                        torch.float32)
    out["b1_one_slot_time"] = time_b1(gen, "uniform", B1_ZOO_DIMS,
                                      torch.float32)

    trainer = zoo_trainer("xDeepFM", SEED)
    trainer.init(batches[0])
    (xname, xpack), = trainer.packs.items()
    xslots = trainer._slots[xname]
    # the layout `check_b1` holds below: [16 values | 1 | 2 accumulators]
    assert tuple(xpack.shape) == (NUM_CAT * VOCAB, 128) \
        and [s.dim for s in xslots] == list(B1_XDEEPFM_DIMS) \
        and tuple(s.acc_col for s in xslots) \
        == b1_slots(B1_XDEEPFM_DIMS)[0], (xname, xpack.shape)
    packed_delta.reset_launches()
    losses = torch.cat([
        trainer.train_steps_fused(stacked(batches[i:i + FIT_K]))
        for i in range(0, ZOO_XDEEPFM_STEPS, FIT_K)]).float().cpu().numpy()
    xl = packed_delta.launches["packed_adagrad_update"]
    assert xl == ZOO_XDEEPFM_STEPS and np.isfinite(losses).all(), (xl, losses)
    assert losses[-4:].mean() < losses[:4].mean(), losses
    walls = []
    for i in range(3):
        chunk = stacked(batches[FIT_K * i:FIT_K * (i + 1)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_steps_fused(chunk)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / FIT_K)
    out["xdeepfm"] = {"pack": xname, "steps": ZOO_XDEEPFM_STEPS,
                      "b1_launches": xl, "losses": losses.tolist(),
                      "replayed_ms_per_step": walls,
                      "median_replayed_ms": statistics.median(walls)}
    del trainer, xpack
    out["b1_xdeepfm_check"] = check_b1(gen, "uniform", B1_XDEEPFM_DIMS,
                                       torch.float32)
    out["b1_xdeepfm_time"] = time_b1(gen, "uniform", B1_XDEEPFM_DIMS,
                                     torch.float32)
    return out


# the JAX package's `run_cascade_experiment` at the same knobs and seed,
# on a CPU (PERF.md §7), and the exit's limits for each metric
JAX_CASCADE = {"stage1_test_Recall(k=20)": 0.4922590445209023,
               "stage1_test_NDCG(k=20)": 0.4966593053956695,
               "candidate_recall": 0.8897261534734825,
               "stage2_AUC": 0.884200632340689,
               "stage3_NDCG@10": 0.6312478709377872,
               "stage3_MAP@10": 0.7100689910652758}
CASCADE_LIMITS = {"stage1_test_Recall(k=20)": 0.01,
                  "stage1_test_NDCG(k=20)": 0.01, "candidate_recall": 0.01,
                  "stage2_AUC": 0.01, "stage3_NDCG@10": 0.02,
                  "stage3_MAP@10": 0.02}


def cascade_on_card(data_dir):
    """Phase 5i: `run_cascade_experiment("ml1m_scale", matcher="MF",
    ranker="DCN", reranker="PRM")` over `quality_exit.gen_ml1m_scale`'s
    files in ``data_dir`` (6040 x 3706, 834,915 interactions) at
    `tools/cascade_ml1m_scale.py`'s knobs (`quality_exit.CASCADE_KNOBS`),
    seed 2024: every metric, the seconds of each stage, and the checks
    that each stage learns what it owns (stage 1 above chance, the ranker's
    AUC above 0.5, the reranker's lists no worse than the ranker's); the
    differences from JAX's run (`JAX_CASCADE`) are reported beside the
    exit's limits, not asserted: a miss is a finding for PERF.md §7."""
    from recbox_tpu_torch.tools import quality_exit as qe
    t0 = time.perf_counter()
    res = qe.run_cascade(data_dir, EXIT_SEEDS[0], DEVICE)
    wall_s = time.perf_counter() - t0
    r = res["test"]
    assert all(np.isfinite(v) for v in r.values()), r
    vs_jax = {k: r[k] - v for k, v in JAX_CASCADE.items()}
    # chance Recall@20 over 3706 items is ~0.005
    assert r["stage1_test_Recall(k=20)"] > 0.1, r
    assert r["candidate_recall"] > r["stage1_test_Recall(k=20)"], r
    assert r["stage2_AUC"] > 0.5, r
    assert r["stage3_NDCG@10"] >= r["list_ranker_NDCG@10"] - 0.02, r
    return {"seed": EXIT_SEEDS[0], "knobs": {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in qe.CASCADE_KNOBS.items()},
        "wall_s": wall_s, "stage_s": res["timings"],
        "metrics": r, "minus_jax": vs_jax, "within_exit_limits": {
            k: abs(d) <= CASCADE_LIMITS[k] for k, d in vs_jax.items()}}


# -- phase 5j: the sequential stage from the user's first call -------------------
# BERT4Rec at `configs/models/bert4rec.yaml`'s widths over 1M items through
# `python -m recbox_tpu_torch.run`'s `main` (2 epochs of 32 batches of 1024,
# 2048 valid and test rows); the cloze call at B = 1024, P = 10; the other
# 19 sequential models at V = 20,000 (1 epoch of 16 batches of 256)
SEQ_V, SEQ_L, SEQ_B, SEQ_STEPS, SEQ_EPOCHS = 1_000_000, 50, 1024, 32, 2
SEQ_EVAL_ROWS, SEQ_P, SEQ_FOLLOW = 2048, 10, 0.7
SEQ_ZOO_V, SEQ_ZOO_B, SEQ_ZOO_STEPS, SEQ_ZOO_EVAL = 20_000, 256, 16, 512
SEQ_ZOO = ("GRU4Rec", "NARM", "STAMP", "Caser", "NextItNet", "FPMC",
           "TransRec", "HGN", "SHAN", "FOSSIL", "HRM", "NPE", "CORE",
           "LightSANs", "FDSA", "RepeatNet", "SINE", "SRGNN", "GCSAN")
# the models whose own scoring keeps them off the kernel (`_use_fused_ce`)
SEQ_PLAIN_ROUTE = ("CORE", "RepeatNet")
# keys added to the BERT4Rec expid (a CPU rehearsal at a small V lowers
# `fused_ce_threshold` here, so the gate opens by its threshold there too)
SEQ_EXTRA = {}


def model_yaml(name):
    import yaml
    with open(os.path.join(REPO, "configs", "models",
                           f"{name.lower()}.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg.pop("stage", None)
    cfg["model"] = name
    return cfg


def seq_synth(v, n_rows, seed, full=False):
    """Next-item rows over ids 1..v-1: a Zipf(1.2) draw of ranks scattered
    over the ids by a fixed permutation, then each step the planted
    successor x % (v - 1) + 1 with probability SEQ_FOLLOW, else a fresh
    draw; the last item is the target, the 5-50 before it the left-padded
    history (all 50 with ``full``)."""
    rng = np.random.default_rng(seed)
    ids = np.random.default_rng(12345).permutation(v - 1) + 1

    def draw(shape):
        return ids[(rng.zipf(1.2, shape) - 1) % (v - 1)]

    x = np.empty((n_rows, SEQ_L + 1), np.int64)
    x[:, 0] = draw(n_rows)
    follow = rng.random((n_rows, SEQ_L)) < SEQ_FOLLOW
    fresh = draw((n_rows, SEQ_L))
    for t in range(1, SEQ_L + 1):
        x[:, t] = np.where(follow[:, t - 1], x[:, t - 1] % (v - 1) + 1,
                           fresh[:, t - 1])
    lens = np.full(n_rows, SEQ_L) if full else rng.integers(5, SEQ_L + 1,
                                                            n_rows)
    hist = x[:, :-1].copy()
    hist[np.arange(SEQ_L)[None, :] < (SEQ_L - lens)[:, None]] = 0
    return {"user_id": (np.arange(n_rows) % 4096).astype(np.int32),
            "item_seq": hist.astype(np.int32),
            "seq_len": lens.astype(np.int32),
            "item_id": x[:, -1].astype(np.int32)}


def seq_feature_map(v):
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    return FeatureMap("synthseq", (FeatureSpec(
        "item_id", "categorical", source="item", vocab_size=v,
        embedding_dim=64),), query_index="user_id", corpus_index="item_id",
        num_items=v)


def recording_trainer(base=None):
    """``base`` (by default `Trainer`) keeping each step's loss, the seconds
    of `fit` and of each evaluation, and the moment it was made: put in a
    pipeline's place, it reads the run without changing it."""
    if base is None:
        from recbox_tpu_torch.training import Trainer as base

    class Recording(base):
        made = []

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            Recording.made.append(self)
            self.made_at = time.perf_counter()
            self.step_losses, self.eval_s, self.fit_s = [], [], None

        def train_step(self, batch):
            loss = super().train_step(batch)
            self.step_losses.append(loss.detach().clone().reshape(1))
            return loss

        def train_steps_fused(self, batches):
            out = super().train_steps_fused(batches)
            self.step_losses.append(out.detach().clone())
            return out

        def fit(self, *args, **kw):
            t0 = time.perf_counter()
            out = super().fit(*args, **kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.fit_end = time.perf_counter()
            self.fit_s = self.fit_end - t0
            return out

        def _evaluate_and_checkpoint(self):
            t0 = time.perf_counter()
            out = super()._evaluate_and_checkpoint()
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.eval_s.append(time.perf_counter() - t0)
            return out

    return Recording


def run_recorded(call):
    """``call()`` with `quick_start.Trainer` recording; (its result, the
    trainer it made)."""
    from recbox_tpu_torch import quick_start as qs
    recording = recording_trainer()
    orig = qs.Trainer
    qs.Trainer = recording
    try:
        out = call()
    finally:
        qs.Trainer = orig
    return out, recording.made[-1]


def step_losses(trainer):
    return torch.cat(trainer.step_losses).float().cpu().numpy()


def write_bert4rec_expdir(root):
    """A pre-encoded config dir for `run.py`: `FeatureMap.save`'s
    feature_map.json, train / valid / test npz, a model_config.yaml expid
    at bert4rec.yaml's widths and a dataset_config.yaml naming the data."""
    import yaml
    data = os.path.join(root, "data")
    seq_feature_map(SEQ_V).save(os.path.join(data, "feature_map.json"))
    splits = {"train": seq_synth(SEQ_V, SEQ_STEPS * SEQ_B, SEED + 31),
              "valid": seq_synth(SEQ_V, SEQ_EVAL_ROWS, SEED + 32),
              "test": seq_synth(SEQ_V, SEQ_EVAL_ROWS, SEED + 33)}
    for name, arrays in splits.items():
        np.savez(os.path.join(data, f"{name}.npz"), **arrays)
    with open(os.path.join(REPO, "configs", "models", "bert4rec.yaml")) as fh:
        widths = yaml.safe_load(fh)
    widths.pop("stage")
    expid = {**widths, "model": "BERT4Rec", "dataset_id": "synthseq",
             "compute_dtype": "bfloat16", "batch_size": SEQ_B,
             "epochs": SEQ_EPOCHS, "eval_batch_size": SEQ_B,
             "learning_rate": 1e-3, "monitor": "NDCG(k=10)",
             "topk": [10, 20], "fused_steps": FIT_K, "seed": 2024,
             **SEQ_EXTRA}
    cfg = os.path.join(root, "config")
    os.makedirs(cfg)
    with open(os.path.join(cfg, "model_config.yaml"), "w") as fh:
        yaml.safe_dump({"bert4rec_1m": expid}, fh)
    with open(os.path.join(cfg, "dataset_config.yaml"), "w") as fh:
        yaml.safe_dump({"synthseq": {"data_dir": data}}, fh)
    return cfg, splits


def bert4rec_from_cli(root):
    """5j (1): `recbox_tpu_torch.run.main` on the BERT4Rec expid, B2's
    counts reset just before and read just after: the route
    `_use_fused_ce` took (the threshold's: bf16, 1M items), one forward
    and one backward launch a step, a finite falling loss, test Recall@10
    above chance (10 / V); then eager against replayed ms a step on the
    run's own batches, and one replayed step profiled."""
    from recbox_tpu_torch import run as prun
    from recbox_tpu_torch.ops import fused_ce
    t0 = time.perf_counter()
    cfg, splits = write_bert4rec_expdir(root)
    data_s = time.perf_counter() - t0
    fused_ce.reset_launches()
    t0 = time.perf_counter()
    result, trainer = run_recorded(lambda: prun.main(
        [f"--config={cfg}", "--expid=bert4rec_1m", f"--device={DEVICE}"]))
    t_end = time.perf_counter()
    launches = dict(fused_ce.launches)
    steps = SEQ_EPOCHS * SEQ_STEPS
    assert trainer.train_method == "fused_ce_loss", trainer.train_method
    assert launches == {"fused_ce_fwd": steps, "fused_ce_bwd": steps}, \
        launches
    losses = step_losses(trainer)
    assert len(losses) == steps and np.isfinite(losses).all(), losses
    assert losses[-8:].mean() < losses[:8].mean(), losses
    chance = 10 / SEQ_V
    assert result["test_Recall(k=10)"] > chance, result
    train = splits["train"]
    batches = [{k: torch.from_numpy(v[i * SEQ_B:(i + 1) * SEQ_B]).to(DEVICE)
                for k, v in train.items()} for i in range(2 * FIT_K)]
    speed = fused_vs_eager(trainer, batches, fused_ce.launches)
    n = speed["fused_steps"]
    assert speed["fused_launches"] == {"fused_ce_fwd": n,
                                       "fused_ce_bwd": n}, speed
    profile = sasrec_breakdown(trainer, batches[0], steps=lambda:
                               trainer.train_steps_fused(stacked(
                                   [batches[0]])))
    capture_s = trainer._graph.capture_seconds \
        if trainer._graph is not None else None
    gather_ab = bert4rec_gather_ab(trainer, batches)
    return trainer, splits["test"], {
        "replayed_step_profile": profile, "gather_ab": gather_ab,
        "vocab": SEQ_V, "batch": SEQ_B, "seq_len": SEQ_L,
        "steps": steps, "route": trainer.train_method,
        "b2_launches": launches,
        "b2_launches_a_step": {k: v / steps for k, v in launches.items()},
        "data_s": data_s, "wall_s": t_end - t0, "fit_s": trainer.fit_s,
        "fit_ms_a_step": (trainer.fit_s - sum(trainer.eval_s)) / steps
        * 1e3, "eval_s": trainer.eval_s, "test_s": t_end - trainer.fit_end,
        "loss_first": losses[:8].tolist(), "loss_last": losses[-8:].tolist(),
        "chance_recall_10": chance, "result": result,
        "graph_capture_s": capture_s, **speed}


def bert4rec_gather_ab(trainer, batches, rounds=3):
    """BERT4Rec's replayed step two ways on the run's Zipf batches: the
    history gathered by `F.embedding(item_seq, table)`, as `models.py`
    `_masked_history` does (a dense backward that sums repeated
    ids in parallel segments), and by indexing, `table[item_seq]` (its
    backward an accumulating `index_put_`, which adds a repeated id's rows
    one after another). Each way its own graph of FIT_K steps, captured
    once; ms a step of the two replayed in turns over ``rounds`` rounds
    (CUDA events, median of 3 a round), and each way's profiled replayed
    step. The gather is swapped where BERT4Rec reads it, `extended`'s
    binding of `_masked_history`."""
    from recbox_tpu_torch.models.sequential import extended
    embedding = extended._masked_history

    def indexing(table, item_seq, shard=None):
        item_seq = item_seq.to(torch.int64)
        mask = item_seq != 0
        emb = table[item_seq]
        return emb * mask[..., None].to(emb.dtype), mask

    stack = stacked(batches[:FIT_K])
    graphs, out = {}, {}
    try:
        for name, fn in (("embedding", embedding), ("indexing", indexing)):
            extended._masked_history = fn
            trainer._graph = None
            trainer.train_steps_fused(stack)
            graphs[name] = trainer._graph
            prof = sasrec_breakdown(trainer, batches[0], steps=lambda:
                                    trainer.train_steps_fused(stacked(
                                        [batches[0]])))
            out[name] = {"profile_groups": prof["groups"],
                         "profile_device_ms": prof["device_ms"],
                         "profile_wall_ms": prof["wall_ms"],
                         "by_kernel": prof["by_kernel"][:6], "ms": []}
        for i in range(rounds):
            order = ("embedding", "indexing")
            for name in (order if i % 2 == 0 else order[::-1]):
                trainer._graph = graphs[name]
                out[name]["ms"].append(cuda_ms(
                    lambda: trainer.train_steps_fused(stack), 3) / FIT_K)
    finally:
        extended._masked_history = embedding
        trainer._graph = None
    for name in graphs:
        out[name]["median_ms_a_step"] = statistics.median(out[name]["ms"])
    return out


class plain_sweeps:
    """Within the block, B2's wrappers run their plain versions on the
    card's tensors too (the autograd function around them unchanged): the
    plain version of the whole call, for comparison and timing."""

    def __enter__(self):
        from recbox_tpu_torch.ops import fused_ce
        self.saved = fused_ce.fused_ce_lse, fused_ce.fused_ce_bwd
        fused_ce.fused_ce_lse = fused_ce.fused_ce_lse_plain
        fused_ce.fused_ce_bwd = fused_ce.fused_ce_bwd_plain
        return self

    def __exit__(self, *exc):
        from recbox_tpu_torch.ops import fused_ce
        fused_ce.fused_ce_lse, fused_ce.fused_ce_bwd = self.saved


def cloze_inputs(model, seed=SEED + 41):
    """The cloze caller's operands at B = 1024, P = 10 over 50-long
    histories: [MASK] at 10 distinct positions a row, the encoder's states
    there (B·P, D) as a leaf, the (V + 1)-row table as a leaf, labels, and
    weights of which a tenth are 0."""
    rng = np.random.default_rng(seed)
    rows = seq_synth(SEQ_V, SEQ_B, seed, full=True)
    seq = torch.from_numpy(rows["item_seq"]).long().to(DEVICE)
    pos = np.sort(rng.permuted(np.tile(np.arange(SEQ_L), (SEQ_B, 1)),
                               axis=1)[:, :SEQ_P], axis=1)
    pos = torch.from_numpy(pos).to(DEVICE)
    labels = torch.gather(seq, 1, pos)
    masked = seq.scatter(1, pos, model.mask_token)
    w = torch.ones(SEQ_B * SEQ_P, device=DEVICE)
    w[torch.from_numpy(rng.permutation(SEQ_B * SEQ_P)[:SEQ_B * SEQ_P // 10]
                       ).to(DEVICE)] = 0.0
    model.eval()
    with torch.no_grad():
        h = model._gathered(masked, torch.from_numpy(rows["seq_len"]).to(
            DEVICE), pos).reshape(-1, model.embedding_dim).float()
    return (h.detach().clone().requires_grad_(True),
            model.emb_item.detach().clone().requires_grad_(True),
            labels.reshape(-1), w)


def cloze_on_card(model):
    """5j (2): `fused_cloze_loss`'s B2 call at the cloze shape (B·P =
    10,240 rows over V = 1M, weights with zeros). B2's sweeps against their
    plain versions at this shape (`b2_sweeps_vs_plain`: lse row by row,
    du, dt, zero-weight rows exact, two calls bit for bit). The whole call
    through autograd against the same call on the plain sweeps: the loss
    within 1e-4 relative, the gradients of the encoder's states and of the
    (V + 1)-row table leaf within 0.5% of their largest entry (`ROADMAP.md`
    Queue C #7), the [MASK] row's gradient and zero-weight rows exactly 0,
    two calls bit for bit. Then `time_b2` at this shape."""
    from recbox_tpu_torch.ops.fused_ce import fused_softmax_ce
    x, table, labels, w = cloze_inputs(model)
    sweeps = b2_sweeps_vs_plain(x.detach(), table.detach()[:SEQ_V],
                                -torch.log(w))

    def call():
        x.grad = table.grad = None
        loss = fused_softmax_ce(x, table[:SEQ_V], labels, w)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach().clone(), x.grad.clone(), table.grad.clone()

    first, second = call(), call()
    with plain_sweeps():
        plain = call()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    assert same, "B2 at the cloze shape: two calls differ"
    loss, gx, gt = first
    loss_p, gx_p, gt_p = plain
    out = {"rows": SEQ_B * SEQ_P, "b": SEQ_B, "p": SEQ_P, "v": SEQ_V,
           "d": x.shape[1], "zero_weights": int((w == 0).sum()),
           "loss": float(loss), "loss_plain": float(loss_p),
           "repeats_bit_identical": same, "sweeps": sweeps}
    assert abs(float(loss) - float(loss_p)) <= 1e-4 * abs(float(loss_p)), out
    for name, got, want in (("d_states", gx, gx_p), ("d_table", gt, gt_p)):
        err, top = float((got - want).abs().max()), float(want.abs().max())
        assert bool(torch.isfinite(got).all()) and err <= 5e-3 * top, \
            (name, err, top)
        out[name] = {"max_abs_err": err, "rel_to_max": err / top}
    assert float(gt[SEQ_V].abs().max()) == 0.0, "the [MASK] row moved"
    assert float(gx[w == 0].abs().max()) == 0.0, "a zero-weight row moved"
    out["mask_row_grad_zero"] = out["zero_weight_rows_zero"] = True
    del first, second, plain, gx, gt, gx_p, gt_p
    return {**out, **time_b2(x.detach(), table.detach()[:SEQ_V], labels, w,
                             reps=5)}


def seq_zoo_on_card():
    """5j (3): the other 19 sequential models through
    `run_sequential_experiment` at their `configs/models/*.yaml` widths
    over V = 20,000 (1 epoch of 16 batches of 256, ``fused_ce: True``,
    512 valid and test rows): a finite falling loss, the route
    `_use_fused_ce` took (CORE and RepeatNet keep `full_scores`), B2's
    launches (one each way a step on the kernel route, none on the
    other), B2 against its plain version on each kernel-route model's own
    operands on the first batch (`b2_sweeps_vs_plain`) and ms a step (8
    eager steps after the run)."""
    from recbox_tpu_torch import quick_start as qs
    from recbox_tpu_torch.ops import fused_ce
    train = seq_synth(SEQ_ZOO_V, SEQ_ZOO_STEPS * SEQ_ZOO_B, SEED + 51)
    valid = seq_synth(SEQ_ZOO_V, SEQ_ZOO_EVAL, SEED + 52)
    test = seq_synth(SEQ_ZOO_V, SEQ_ZOO_EVAL, SEED + 53)
    fm = seq_feature_map(SEQ_ZOO_V)
    batch = {k: torch.from_numpy(v[:SEQ_ZOO_B]).to(DEVICE)
             for k, v in train.items()}
    out = {}
    for name in SEQ_ZOO:
        cfg = model_yaml(name)
        if "num_users" in cfg:
            cfg["num_users"] = 4096
        cfg.update(model=name, batch_size=SEQ_ZOO_B, epochs=1,
                   fused_ce=True, learning_rate=5e-3, eval_batch_size=512,
                   monitor="NDCG(k=10)", seed=2024)
        fused_ce.reset_launches()
        t0 = time.perf_counter()
        res, tr = run_recorded(lambda: qs.run_sequential_experiment(
            cfg, fm, train, valid, test_arrays=test, device=DEVICE))
        wall_s = time.perf_counter() - t0
        launches = dict(fused_ce.launches)
        losses = step_losses(tr)
        want = "full_scores" if name in SEQ_PLAIN_ROUTE else "fused_ce_loss"
        n = SEQ_ZOO_STEPS if want == "fused_ce_loss" else 0
        assert tr.train_method == want, (name, tr.train_method)
        assert launches == {"fused_ce_fwd": n, "fused_ce_bwd": n}, \
            (name, launches)
        assert len(losses) == SEQ_ZOO_STEPS and np.isfinite(losses).all(), \
            (name, losses)
        assert losses[-4:].mean() < losses[:4].mean(), (name, losses)
        assert all(np.isfinite(v) for v in res.values()), (name, res)
        check = {}
        if want == "fused_ce_loss":
            # B2 at the operands this model hands it (D = 64; 65 / 66,
            # padded to 80; 128), after the launches were read
            model = tr.model
            with torch.no_grad():
                user = model.user_tower(batch) / model.temperature
                table = model._table().detach()
            check = {"b2_check": {"d": user.shape[1],
                                  **b2_sweeps_vs_plain(user, table)}}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(8):
            tr.train_step(batch)
        torch.cuda.synchronize()
        out[name] = {**check, "route": tr.train_method,
                     "b2_launches": launches,
                     "loss_first4": losses[:4].tolist(),
                     "loss_last4": losses[-4:].tolist(),
                     "ms_a_step": (time.perf_counter() - t1) / 8 * 1e3,
                     "wall_s": wall_s, "test_NDCG(k=10)":
                     res["test_NDCG(k=10)"]}
        del tr
    return out


def run_experiment_on_card(data_root):
    """5j (4): `run_experiment("SASRec", "ml1m_scale", epochs=1,
    device="cuda")` over phase 5i's staged atomic files: the seconds of
    the data preparation, `fit` and the test evaluation, and the metrics."""
    from recbox_tpu_torch.quick_start import run_experiment
    t0 = time.perf_counter()
    res, tr = run_recorded(lambda: run_experiment(
        "SASRec", "ml1m_scale", data_dir=data_root, epochs=1,
        monitor="NDCG(k=10)", device=DEVICE))
    t_end = time.perf_counter()
    assert all(np.isfinite(v) for v in res.values()), res
    # chance Recall@10 over 3706 items is ~0.0027
    return {"data_s": tr.made_at - t0, "fit_s": tr.fit_s,
            "eval_s": tr.eval_s, "test_s": t_end - tr.fit_end,
            "wall_s": t_end - t0, "steps": len(step_losses(tr)),
            "metrics": res}


# -- 5k-5m: the rest of the ranking, multitask and sequential stages -----------

# Taobao UserBehavior's published vocabularies (Tianchi dataset 649; the TDM
# paper, KDD 2018): users, items (the table's last row is PAD), categories;
# 50-long behaviour histories over the item table, pre-padded
TB_USERS, TB_ITEMS, TB_CATES, TB_L = 987_994, 4_162_024, 9_439, 50
TB_BATCH, TB_TRAIN_BATCHES, TB_HELD_OUT_BATCHES = 4096, 24, 4
# From a zero accumulator (the trainer's default in both packages) AdaGrad
# moves a row by lr * sign(g) at its first update, the embedding lr being
# max(lr, 5e-2). 5k's trainer starts the accumulators at 0.1 (TensorFlow's
# and optax's initial value), an argument of the trainer that
# `run_ranking_experiment` leaves at 0.0: at 0 each of the top item's
# ~21,000 duplicates a step moves its row by ~lr and DIN diverges.
PACKED_ADAGRAD_INIT = 0.1
# 5l's and 5m's eager checks train the tables at 1e-2: at 5e-2 the first
# step moves every row of the normal(1e-4) tables by 5e-2 and KD_DAGFM's
# loss jumps 24x, HFM's 4x, before they fall.
EAGER_EMBEDDING_LR = 1e-2
# eager steps of a model on one batch (the loss must fall as it fits it,
# and no step's loss may exceed EAGER_LOSS_BOUND times the first)
ZOO_EAGER_STEPS = 8
EAGER_LOSS_BOUND = 3.0
SEQ_CTR_OTHERS = ("BST", "DIEN", "DSIN")
MT_TRAIN_BATCHES, MT_HELD_OUT_BATCHES = 16, 4
MT_OTHERS = ("SharedBottom", "PLE", "ESMM", "AITM")
CTRX_BATCH = 4096
CTRX_MODELS = ("FFM", "FwFM", "FmFM", "FEFM", "DeepFEFM", "ONN", "CCPM",
               "FGCNN", "FLEN", "IFM", "DIFM", "EDCN", "MLR", "FiGNN",
               "EulerNet", "DeepIM", "HFM", "DCNMix", "FNN", "DAGFM",
               "KD_DAGFM")
# Amazon Beauty at the S3Rec paper's scale (its Table 1): users, items,
# attributes; `configs/models/s3rec.yaml`'s widths
BEAUTY_USERS, BEAUTY_ITEMS, BEAUTY_ATTRS = 22_363, 12_101, 1_221
# one pretraining epoch, a depth cut from two (~7 s) to keep the script
# inside its time; the probe loss falls within the first
S3_PRETRAIN_EPOCHS, S3_PRETRAIN_BATCH = 1, 256
S3_FINE_EPOCHS, S3_FINE_BATCH = 2, 2048


def run_packed_recorded(call, **trainer_kw):
    """``call()`` with `PackedEmbeddingTrainer` recording (the pipelines
    import it from `training.packed` when they run) and made with
    ``trainer_kw`` over the pipeline's keywords; (its result, the trainer
    it made)."""
    from recbox_tpu_torch.training import packed
    orig = packed.PackedEmbeddingTrainer
    rec = recording_trainer(orig)

    class Made(rec):
        def __init__(self, *args, **kw):
            super().__init__(*args, **{**kw, **trainer_kw})

    packed.PackedEmbeddingTrainer = Made
    try:
        out = call()
    finally:
        packed.PackedEmbeddingTrainer = orig
    return out, rec.made[-1]


def taobao_feature_map(neg=False):
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    seq = dict(vocab_size=TB_ITEMS + 1, embedding_dim=16, max_len=TB_L,
               padding_idx=TB_ITEMS, share_embedding="item_id")
    specs = (FeatureSpec("user_id", "categorical", vocab_size=TB_USERS,
                         embedding_dim=16),
             FeatureSpec("item_id", "categorical", vocab_size=TB_ITEMS + 1,
                         embedding_dim=16),
             FeatureSpec("cate_id", "categorical", vocab_size=TB_CATES,
                         embedding_dim=16),
             FeatureSpec("hist", "sequence", **seq))
    if neg:
        specs += (FeatureSpec("neg_hist", "sequence", **seq),)
    return FeatureMap("taobao", specs, labels=("click",))


def taobao_arrays(n, seed, neg=False):
    """Synthetic Taobao rows: items by Zipf(1.2) popularity (ranks
    scattered over the ids by a fixed permutation), history lengths
    uniform on [5, 50] pre-padded with PAD, half the targets drawn from the
    history, an item's category fixed (id mod the categories), click =
    target in the history (`tests/test_sequence_ctr.py:14`'s plant);
    ``neg`` adds a Zipf ``neg_hist`` column, PAD where the history is."""
    rng = np.random.default_rng(seed)
    perm = np.random.default_rng(4321).permutation(TB_ITEMS)

    def item(shape):
        return perm[(rng.zipf(1.2, shape) - 1) % TB_ITEMS]

    hist = item((n, TB_L))
    lens = rng.integers(5, TB_L + 1, n)
    pad = np.arange(TB_L)[None, :] < (TB_L - lens)[:, None]
    hist[pad] = TB_ITEMS
    pick = hist[np.arange(n), TB_L - 1 - rng.integers(0, lens)]
    target = np.where(rng.random(n) < 0.5, pick, item(n))
    out = {"user_id": rng.integers(0, TB_USERS, n).astype(np.int32),
           "item_id": target.astype(np.int32),
           "cate_id": (target % TB_CATES).astype(np.int32),
           "hist": hist.astype(np.int32),
           "click": (hist == target[:, None]).any(1).astype(np.float32)}
    if neg:
        out["neg_hist"] = np.where(pad, TB_ITEMS, item((n, TB_L))).astype(
            np.int32)
    return out


def device_batches(arrays, size):
    n = len(next(iter(arrays.values()))) // size
    return [{k: torch.from_numpy(v[i * size:(i + 1) * size]).to(DEVICE)
             for k, v in arrays.items()} for i in range(n)]


def capture_b1_call(trainer, batch, keep_pack=True):
    """One eager step of ``trainer`` with B1's call recorded: (the pack
    before the update, or None without ``keep_pack``, ids, G, slot
    gradients, lr, the layout keywords). The step's own update goes
    through as usual."""
    from recbox_tpu_torch.training import packed
    orig = packed.packed_adagrad_update_
    seen = {}

    def record(pack, ids, G, grads, lr, **kw):
        seen.update(pre=pack.detach().clone() if keep_pack else None,
                    ids=ids.detach().clone(),
                    G=G.detach().clone(),
                    grads=[g.detach().clone() for g in grads], lr=lr, kw=kw)
        return orig(pack, ids, G, grads, lr, **kw)

    packed.packed_adagrad_update_ = record
    try:
        trainer.train_step(batch)
    finally:
        packed.packed_adagrad_update_ = orig
    torch.cuda.synchronize()
    return seen


def b1_on_captured(rec, pad_row):
    """B1 against its plain version on a step's own operands
    (`b1_agreement` and `b1_update_agreement`, check_b1's tolerances), then
    its ms, the plain version's, the `index_add_` scatter's and the bound
    (`b1_bound_ms`) at them; with the ids of the PAD row (pack row
    ``pad_row``) and of the hottest other row."""
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_,
    )
    pre, ids, G, grads, lr, kw = (rec[k] for k in ("pre", "ids", "G",
                                                    "grads", "lr", "kw"))
    counts = torch.bincount(ids.long(), minlength=pre.shape[0])
    pad_count = int(counts[pad_row])
    counts[pad_row] = 0
    pack, plain = pre.clone(), pre.clone()
    packed_adagrad_update_(pack, ids, G, grads, lr, **kw)
    packed_adagrad_update_plain_(plain, ids, G, grads, lr, **kw)
    torch.cuda.synchronize()
    upd = fused_adagrad_delta_plain(G, grads, lr, store_w=pre.shape[1], **kw)
    check = {**b1_agreement(pack, plain, pre, ids, upd),
             **b1_update_agreement(pack, plain, pre, ids, upd)}
    del plain
    times = b1_times(
        lambda: packed_adagrad_update_(pack, ids, G, grads, lr, **kw),
        lambda: packed_adagrad_update_plain_(pack, ids, G, grads, lr, **kw),
        pack, ids, upd, grads, kw["dims"])
    return {"check": check,
            "time": {"pack": list(pre.shape), "dims": list(kw["dims"]),
                     "grads": str(grads[0].dtype), **times,
                     "pad_row_count": pad_count,
                     "hottest_row_count": int(counts.max())}}


def eager_repeat(trainer, batch, steps=ZOO_EAGER_STEPS):
    """``steps`` eager steps on one batch (finite, the last loss below the
    first: the model fits the batch; none above `EAGER_LOSS_BOUND` times
    the first: a step that blows the loss up fails), then ms a step over 4
    more."""
    losses = trainer.train_steps_repeat(batch, steps).float().cpu().numpy()
    assert np.isfinite(losses).all() and losses[-1] < losses[0] \
        and losses.max() <= EAGER_LOSS_BOUND * losses[0], losses
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_steps_repeat(batch, 4)
    torch.cuda.synchronize()
    return {"losses": losses.tolist(),
            "ms_a_step": (time.perf_counter() - t0) / 4 * 1e3}


def din_taobao():
    """Phase 5k: DIN at `configs/models/din.yaml`'s widths through
    `run_ranking_experiment(trainer: packed)` over the Taobao schema (2
    epochs of 24 batches of 4096, 8 steps a `train_steps_fused` call, 4
    held-out batches; the pipeline's trainer made with its AdaGrad
    accumulators at `PACKED_ADAGRAD_INIT`, where the pipeline leaves them at
    0.0, as JAX's does): B1's count reset just before and read just after
    (one launch a step), a falling loss, held-out AUC above 0.6. Then the
    same trainer: eager against replayed ms a step (6 blocks of 8 a side), a
    replayed step equal to an eager one (the pack and the Dice running
    means: the statistics move in a replay as in an eager step), one
    replayed step under torch.profiler, and B1 against its plain version on
    one step's own ids and gradients (4096 x 53 rows over the 5.16M-row
    pack, PAD runs included), timed, with the step's ids of the PAD row and
    of the hottest item. Then BST, DIEN (its loss plus the auxiliary loss of
    `auxiliary_logits` on a ``neg_hist`` column) and DSIN at their yaml
    widths under the dense trainer: 8 eager steps on one batch each, a
    falling, bounded loss (`eager_repeat`), ms a step."""
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.quick_start import (
        build_model, run_ranking_experiment,
    )
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    t0 = time.perf_counter()
    train = taobao_arrays(TB_TRAIN_BATCHES * TB_BATCH, SEED + 61)
    held = taobao_arrays(TB_HELD_OUT_BATCHES * TB_BATCH, SEED + 62)
    data_s = time.perf_counter() - t0
    fm = taobao_feature_map()
    cfg = {**model_yaml("DIN"), "trainer": "packed", "batch_size": TB_BATCH,
           "epochs": 2, "fused_steps": FIT_K, "learning_rate": 1e-3,
           "grad_clip_norm": 10.0, "seed": SEED, "monitor": "AUC",
           "metrics": ["AUC", "logloss"]}
    packed_delta.reset_launches()
    t0 = time.perf_counter()
    res, tr = run_packed_recorded(lambda: run_ranking_experiment(
        cfg, fm, train, held, device=DEVICE),
        adagrad_init=PACKED_ADAGRAD_INIT)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = packed_delta.launches["packed_adagrad_update"]
    losses = step_losses(tr)
    assert launches == 2 * TB_TRAIN_BATCHES == len(losses), \
        (launches, len(losses))
    assert np.isfinite(losses).all() \
        and losses[-8:].mean() < losses[:8].mean(), losses
    assert res["AUC"] > 0.6 and np.isfinite(res["logloss"]), res
    (pname, pack), = tr.packs.items()
    slots = tr._slots[pname]
    assert pack.shape[0] == TB_USERS + TB_ITEMS + 1 + TB_CATES \
        and [s.dim for s in slots] == [16], (pname, pack.shape)
    out = {"data_s": data_s, "run_ranking_experiment": {
        "model": "DIN", "steps": len(losses), "fit_s": fit_s,
        "b1_launches": launches, "loss_first8": losses[:8].tolist(),
        "loss_last8": losses[-8:].tolist(), **res},
        "pack": pname, "pack_shape": list(pack.shape),
        "click_rate": float(train["click"].mean()),
        "pad_share": float((train["hist"] == TB_ITEMS).mean())}
    batches = device_batches(train, TB_BATCH)
    speed = fused_vs_eager(tr, batches, packed_delta.launches)
    assert speed["fused_launches"]["packed_adagrad_update"] \
        == speed["fused_steps"], speed
    dice = tr.model.attention.MLP_0.dice
    out["replay_vs_eager"] = graph_step_matches_eager(
        tr, batches[0], lambda: {"pack": tr.packs[pname],
                                 "dice0_mean": dice[0].BatchNorm_0.mean,
                                 "dice1_var": dice[1].BatchNorm_0.var})
    out["replayed_step_profile"] = train_breakdown(
        tr, batches[0], groups=ZOO_GROUPS,
        steps=lambda: tr.train_steps_fused(stacked([batches[0]])))
    out.update(speed)
    item_rows, = (b for b in tr._bundles[pname] if "hist" in b.features)
    b1 = b1_on_captured(capture_b1_call(tr, batches[1]),
                        pad_row=item_rows.row_offset + TB_ITEMS)
    assert b1["time"]["n"] == TB_BATCH * (TB_L + 3), b1["time"]
    out["b1_din"] = b1
    del tr, pack, batches
    torch.cuda.empty_cache()

    def dien_loss(model):
        def loss(o, b):
            aux = model.auxiliary_logits(b)
            valid = (b["hist"][:, 1:] != TB_ITEMS).float()
            per = (torch.nn.functional.softplus(-aux[..., 0])
                   + torch.nn.functional.softplus(aux[..., 1]))
            return binary_crossentropy(o, b["click"]) \
                + torch.sum(per * valid) / valid.sum()
        return loss

    others = {}
    for name in SEQ_CTR_OTHERS:
        neg = name == "DIEN"
        ofm = taobao_feature_map(neg)
        batch = device_batches(taobao_arrays(TB_BATCH, SEED + 63, neg),
                               TB_BATCH)[0]
        model, _ = build_model({**model_yaml(name), "seed": SEED}, ofm,
                               DEVICE)
        loss = dien_loss(model) if neg else \
            (lambda o, b: binary_crossentropy(o, b["click"]))
        trainer = Trainer(model, loss, TrainerConfig(
            learning_rate=1e-3, grad_clip_norm=10.0, seed=SEED),
            device=DEVICE)
        others[name] = eager_repeat(trainer, batch)
        del trainer, model
    out["eager"] = others
    return out


def criteo_mt_arrays(n_train, n_held, seed):
    """`CriteoBatches`' fields and click, and a conversion only where click
    is 1, drawn from a second logistic model over fields c4..c7 (the
    CTCVR structure ESMM assumes): (train, held-out) arrays of ``n_train``
    and ``n_held`` batches under the same two models."""
    data = CriteoBatches(seed)
    conv_w = torch.randn(4, VOCAB, generator=data.gen, device=DEVICE)
    out = []
    for _ in range(n_train + n_held):
        b = data()
        logit = sum(conv_w[f, b[f"c{f + 4}"].long()] for f in range(4)) - 1
        b["conv"] = b["click"] * (torch.rand(BATCH, generator=data.gen,
                                             device=DEVICE)
                                  < torch.sigmoid(logit)).float()
        out.append(b)
    return tuple({k: torch.cat([b[k] for b in part]).cpu().numpy()
                  for k in part[0]}
                 for part in (out[:n_train], out[n_train:]))


def multitask_criteo():
    """Phase 5l: MMOE at `configs/models/mmoe.yaml`'s widths through
    `run_ranking_experiment(trainer: packed)` over the Criteo schema (26 x
    100,000 ids, 13 numeric, dim 16; 2 epochs of 16 batches of 32768, 8
    steps a fused call, 4 held-out batches): B1 once a step, the
    `MultiTaskEvaluator` AUC of both tasks above 0.5. Then SharedBottom,
    PLE, ESMM and AITM at their yaml widths under `PackedEmbeddingTrainer`
    (tables at `EAGER_EMBEDDING_LR`): 8 eager steps on one batch each
    (a falling, bounded loss: `eager_repeat`), ms a step; ESMM's
    probabilities on a held-out batch hold pCTCVR <= pCTR."""
    from recbox_tpu_torch.models.multitask import multitask_loss
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.quick_start import (
        build_model, run_ranking_experiment,
    )
    from recbox_tpu_torch.training import (
        PackedEmbeddingTrainer, TrainerConfig,
    )
    labels = ("click", "conv")
    t0 = time.perf_counter()
    train, held = criteo_mt_arrays(MT_TRAIN_BATCHES, MT_HELD_OUT_BATCHES,
                                   SEED + 71)
    data_s = time.perf_counter() - t0
    fm = zoo_feature_map(labels)
    cfg = {**model_yaml("MMOE"), "trainer": "packed", "batch_size": BATCH,
           "epochs": 2, "fused_steps": FIT_K, "learning_rate": 1e-3,
           "grad_clip_norm": 10.0, "seed": SEED, "monitor": "AUC",
           "metrics": ["AUC", "logloss"]}
    packed_delta.reset_launches()
    t0 = time.perf_counter()
    res, tr = run_packed_recorded(lambda: run_ranking_experiment(
        cfg, fm, train, held, device=DEVICE))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = packed_delta.launches["packed_adagrad_update"]
    losses = step_losses(tr)
    assert launches == 2 * MT_TRAIN_BATCHES == len(losses), launches
    assert res["click_AUC"] > 0.5 and res["conv_AUC"] > 0.5, res
    assert np.isfinite(losses).all(), losses
    out = {"data_s": data_s, "conv_rate": float(train["conv"].mean()),
           "click_rate": float(train["click"].mean()),
           "run_ranking_experiment": {
               "model": "MMOE", "steps": len(losses), "fit_s": fit_s,
               "b1_launches": launches, "loss_first8": losses[:8].tolist(),
               "loss_last8": losses[-8:].tolist(), **res}}
    del tr
    batch = {k: torch.from_numpy(v[:BATCH]).to(DEVICE)
             for k, v in train.items()}
    test = {k: torch.from_numpy(v[:BATCH]).to(DEVICE)
            for k, v in held.items()}
    others = {}
    packed_delta.reset_launches()
    for name in MT_OTHERS:
        model, _ = build_model({**model_yaml(name), "seed": SEED}, fm,
                               DEVICE)
        from_logits = getattr(model, "output_type", "logits") == "logits"

        def loss(o, b, _fl=from_logits):
            return multitask_loss(o, torch.stack([b[k] for k in labels], 1),
                                  from_logits=_fl)

        trainer = PackedEmbeddingTrainer(model, loss, TrainerConfig(
            learning_rate=1e-3, grad_clip_norm=10.0, seed=SEED),
            device=DEVICE, embedding_lr=EAGER_EMBEDDING_LR)
        others[name] = eager_repeat(trainer, batch)
        if name == "ESMM":
            probs = trainer.apply(test)
            assert bool((probs[:, 1] <= probs[:, 0]).all()) \
                and bool((probs >= 0).all() & (probs <= 1).all())
            others[name]["pctcvr_le_pctr"] = True
        del trainer, model
    out["eager"] = others
    out["eager_b1_launches"] = packed_delta.launches["packed_adagrad_update"]
    return out


def ctr_zoo_rest():
    """Phase 5m (1): the 19 models of `ctr_extended.py`, DAGFM and KD_DAGFM
    (distilled from a DCNv2 teacher at `configs/models/dcnv2.yaml`'s
    widths through `distillation_loss`) at their yaml widths over the
    Criteo schema under `PackedEmbeddingTrainer` (tables at
    `EAGER_EMBEDDING_LR`; FFM and ONN carry their field-aware tables, 2.6M
    x 39 x 16 floats, in the pack): 8 eager steps on one batch of 4096 each
    (finite, falling, bounded losses: `eager_repeat`), ms a step, B1
    launches."""
    from recbox_tpu_torch.models.ranking import distillation_loss
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.quick_start import build_model
    from recbox_tpu_torch.training import (
        PackedEmbeddingTrainer, TrainerConfig,
    )
    data = CriteoBatches(SEED + 81)
    batch = {k: v[:CTRX_BATCH] for k, v in data().items()}
    fm = zoo_feature_map()
    teacher, _ = build_model({**model_yaml("DCNv2"), "seed": SEED + 1}, fm,
                             DEVICE)
    teacher.eval()
    out = {}
    packed_delta.reset_launches()
    for name in CTRX_MODELS:
        model, _ = build_model({**model_yaml(name), "seed": SEED}, fm,
                               DEVICE)
        if name == "KD_DAGFM":
            with torch.no_grad():
                t_logits = teacher(batch)

            def loss(o, b, _t=t_logits):
                return distillation_loss(o, _t, b["click"])
        else:
            def loss(o, b):
                return binary_crossentropy(o, b["click"])
        before = packed_delta.launches["packed_adagrad_update"]
        trainer = PackedEmbeddingTrainer(model, loss, TrainerConfig(
            learning_rate=1e-3, grad_clip_norm=10.0, seed=SEED),
            device=DEVICE, embedding_lr=EAGER_EMBEDDING_LR)
        res = eager_repeat(trainer, batch)
        res["b1_launches"] = packed_delta.launches[
            "packed_adagrad_update"] - before
        res["packs"] = {k: list(v.shape) for k, v in trainer.packs.items()}
        assert res["b1_launches"] == ZOO_EAGER_STEPS + 4, (name, res)
        out[name] = res
        del trainer, model
        torch.cuda.empty_cache()
    return out


def beauty_data(seed=SEED + 91):
    """Synthetic Amazon Beauty: each user's history 5 + Poisson(4) items
    long (<= 50; ~9 on average, the 5-core's mean), each next item the
    current one's planted successor with probability 0.6, else a Zipf(1.2)
    draw; each item 1-3 attributes. Returns the right-padded histories,
    their lengths, the (V + 1, A) multi-hot attribute table and each
    item's first attribute (GRU4RecF's feature id)."""
    rng = np.random.default_rng(seed)
    v, n = BEAUTY_ITEMS, BEAUTY_USERS
    ids = np.random.default_rng(99).permutation(v) + 1
    lens = np.minimum(5 + rng.poisson(4, n), SEQ_L)
    x = np.zeros((n, SEQ_L), np.int64)
    x[:, 0] = ids[(rng.zipf(1.2, n) - 1) % v]
    follow = rng.random((n, SEQ_L)) < 0.6
    fresh = ids[(rng.zipf(1.2, (n, SEQ_L)) - 1) % v]
    for t in range(1, SEQ_L):
        x[:, t] = np.where(follow[:, t], x[:, t - 1] % v + 1, fresh[:, t])
    x[np.arange(SEQ_L)[None, :] >= lens[:, None]] = 0
    n_att = rng.integers(1, 4, v + 2)
    att = np.zeros((v + 2, BEAUTY_ATTRS), np.float32)
    first = np.zeros(v + 2, np.int64)
    for i in range(1, v + 1):
        a = rng.choice(BEAUTY_ATTRS, n_att[i], replace=False)
        att[i, a] = 1.0
        first[i] = a[0] + 1
    return x.astype(np.int32), lens.astype(np.int32), att, first


def leave_one_out(x, lens):
    """recbole's leave-one-out over right-padded histories: every prefix
    of the first n - 2 items a training row, the last two the valid and
    the test targets; left-padded ``item_seq`` (B, 50) rows."""
    from recbox_tpu_torch.training.pretrain import _left_pad
    rows = {"train": [], "valid": [], "test": []}
    for u in range(len(x)):
        s, n = x[u, :lens[u]], int(lens[u])
        for t in range(1, n - 2):
            rows["train"].append((s[:t], s[t]))
        rows["valid"].append((s[:n - 2], s[n - 2]))
        rows["test"].append((s[:n - 1], s[n - 1]))
    out = {}
    for split, rr in rows.items():
        m = len(rr)
        seq = np.zeros((m, SEQ_L), np.int32)
        sl = np.array([len(h) for h, _ in rr], np.int32)
        for i, (h, _) in enumerate(rr):
            seq[i, :len(h)] = h
        out[split] = {"item_seq": _left_pad(seq, sl).astype(np.int32),
                      "seq_len": sl,
                      "item_id": np.array([t for _, t in rr], np.int32)}
    return out


def s3rec_beauty():
    """Phase 5m (2): S3Rec at `configs/models/s3rec.yaml`'s widths (dim 64,
    2 layers, 2 heads, L = 50, dropout 0.2; the 1,221 attributes for AAP /
    MAP) at the Amazon Beauty scale of the S3Rec paper (22,363 users,
    12,101 items), synthetic from the seed: `S3RecPretrainer` for
    S3_PRETRAIN_EPOCHS epochs of batch 256 (AAP + MIP + MAP + SP), the joint loss on a fixed probe
    batch falling; `transfer_pretrained` onto the model that
    `run_sequential_experiment` builds (its `build_model`, wrapped), then
    its fine-tune `fit` (2 epochs of 2048, full-softmax CE: 12,102 items
    are below `_use_fused_ce`'s threshold) with test Recall@10 above
    chance (10 / 12,101). Then GRU4RecF at its yaml widths with a
    ``feat_seq`` column (each item's first attribute): 8 eager steps on
    one batch, a falling loss, ms a step."""
    from recbox_tpu_torch import quick_start as qs
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.sequential import S3Rec
    from recbox_tpu_torch.ops.losses import full_softmax_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    from recbox_tpu_torch.training.pretrain import (
        S3RecPretrainer, reconstruct_pretrain_batch, transfer_pretrained,
    )
    t0 = time.perf_counter()
    x, lens, att, first = beauty_data()
    splits = leave_one_out(x, lens)
    data_s = time.perf_counter() - t0
    fm = FeatureMap("beauty", (FeatureSpec(
        "item_id", "categorical", source="item",
        vocab_size=BEAUTY_ITEMS + 1, embedding_dim=64),),
        query_index="user_id", corpus_index="item_id",
        num_items=BEAUTY_ITEMS + 1)
    cfg = {**model_yaml("S3Rec"), "n_attributes": BEAUTY_ATTRS,
           "seed": SEED}
    model, _ = qs.build_model(cfg, fm, DEVICE)
    assert isinstance(model, S3Rec)
    # the pretrain phase sees each user's history up to the valid target
    pre_len = lens - 2
    pre_seq = np.where(np.arange(SEQ_L)[None, :] < pre_len[:, None], x, 0)
    probe = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in reconstruct_pretrain_batch(
                 pre_seq[:512], pre_len[:512], BEAUTY_ITEMS + 1,
                 BEAUTY_ITEMS + 1, np.random.default_rng(SEED + 92), 0.2,
                 att).items()}

    def probe_loss():
        model.eval()
        with torch.no_grad():
            return float(model.pretrain_losses(probe))

    loss0 = probe_loss()
    pre = S3RecPretrainer(model, learning_rate=1e-3, mask_ratio=0.2,
                          attribute_table=att, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = pre.pretrain(pre_seq, pre_len, epochs=S3_PRETRAIN_EPOCHS,
                          batch_size=S3_PRETRAIN_BATCH)
    torch.cuda.synchronize()
    pretrain_s = time.perf_counter() - t0
    loss1 = probe_loss()
    assert np.isfinite(pre.epoch_losses).all() and loss1 < loss0, \
        (loss0, loss1, pre.epoch_losses)
    steps = S3_PRETRAIN_EPOCHS * (BEAUTY_USERS // S3_PRETRAIN_BATCH)
    out = {"data_s": data_s, "train_rows": len(splits["train"]["item_id"]),
           "pretrain": {"epochs": S3_PRETRAIN_EPOCHS, "steps": steps,
                        "epoch_losses": pre.epoch_losses,
                        "probe_loss_before": loss0,
                        "probe_loss_after": loss1, "wall_s": pretrain_s,
                        "ms_a_step": pretrain_s / steps * 1e3}}
    del pre, model
    build = qs.build_model

    def build_pretrained(*args, **kw):
        built, stage = build(*args, **kw)
        built.load_state_dict(transfer_pretrained(built.state_dict(),
                                                  params))
        return built, stage

    fine_cfg = {**cfg, "batch_size": S3_FINE_BATCH,
                "epochs": S3_FINE_EPOCHS, "learning_rate": 1e-3,
                "eval_batch_size": 4096, "monitor": "NDCG(k=10)"}
    qs.build_model = build_pretrained
    t0 = time.perf_counter()
    try:
        res, tr = run_recorded(lambda: qs.run_sequential_experiment(
            fine_cfg, fm, splits["train"], splits["valid"],
            test_arrays=splits["test"], device=DEVICE))
    finally:
        qs.build_model = build
    fine_s = time.perf_counter() - t0
    chance = 10 / BEAUTY_ITEMS
    assert tr.train_method == "full_scores", tr.train_method
    assert res["test_Recall(k=10)"] > chance, (res, chance)
    out["fine_tune"] = {"wall_s": fine_s, "steps": len(step_losses(tr)),
                        "route": tr.train_method, "chance_recall10": chance,
                        **res}
    del tr

    gfm = FeatureMap("beauty", fm.features, query_index="user_id",
                     corpus_index="item_id", num_items=BEAUTY_ITEMS + 1)
    gcfg = {**model_yaml("GRU4RecF"), "feature_vocab": BEAUTY_ATTRS + 1,
            "seed": SEED}
    gmodel, _ = qs.build_model(gcfg, gfm, DEVICE)
    rows = {k: v[:S3_FINE_BATCH] for k, v in splits["train"].items()}
    rows["feat_seq"] = first[rows["item_seq"]].astype(np.int32)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in rows.items()}
    gt = Trainer(gmodel, lambda o, b: full_softmax_loss(o, b["item_id"]),
                 TrainerConfig(learning_rate=1e-3, seed=SEED),
                 device=DEVICE, train_method="full_scores")
    out["gru4recf"] = eager_repeat(gt, batch)
    return out


# -- 5n: the matching stage's remainder ----------------------------------------

# ComiRec-SA / MIND at their yaml widths (`configs/models/comirec.yaml`,
# `mind.yaml`: d 64, L 50, K 4) over the serving catalog of 1M items
# (`bench.py:246`): 16 batches of 2048 through `run_matching_experiment`,
# 10 sampled negatives; histories of Zipf(1.2) ranks inside 2-4 planted
# clusters a user, each cluster's items scattered over the ids
MI_USERS, MI_BATCH, MI_STEPS, MI_NEGS = 32_768, 2048, 16, 10
MI_CLUSTERS, MI_EVAL_USERS, MI_EVAL_BATCH = 1000, 4096, 256
MI_MIN_LEN, MI_MAX_LEN = 5, 50
# Adam at 1e-2: from emb_init's 1e-4 rows a capsule's squash leaves ~1e-8
# vectors, whose gradients sit near Adam's eps at 1e-3
MI_LR = 1e-2
# queries a served variant: one (a query's host merge takes ~2 s)
MI_QUERIES = 1
# the autoencoders over ML-20M's catalog (the MultiVAE paper, Liang et al.,
# WWW 2018, Table 1: 20,108 items after its filter), 8192 users, batch 500
AE_ITEMS, AE_USERS, AE_BATCH = 20_108, 8192, 500
# the SSL terms' weights: NCL's published ssl_reg (recbole `ncl.yaml`), for
# both (the InfoNCE terms are sums over the batch)
SGL_SSL_WEIGHT, NCL_SSL_WEIGHT = 1e-7, 1e-7
I2V_USERS, I2V_BATCH, I2V_NEGS = 5000, 4096, 5


def mi_data(seed=SEED + 101):
    """MI_USERS rows (one a user): a history of MI_MIN_LEN..MI_MAX_LEN
    items and a target, a held-out item for validation; each item drawn
    from one of the user's 2-4 clusters (uniformly), its rank in the
    cluster Zipf(1.2). Cluster c's items are members[c], a random
    permutation of the ids 1..N-1 (0 is the PAD row): ids scattered as a
    catalog's are, since B3 keeps one winner a 128-row segment."""
    rng = np.random.default_rng(seed)
    size = (N_ITEMS - 1) // MI_CLUSTERS
    members = rng.permutation(np.arange(1, N_ITEMS))[:MI_CLUSTERS * size] \
        .reshape(MI_CLUSTERS, size)
    n_c = rng.integers(2, 5, MI_USERS)
    clusters = rng.integers(0, MI_CLUSTERS, (MI_USERS, 4))

    def draw(shape):
        pick = (rng.random(shape) * n_c.reshape((-1,) + (1,) * (
            len(shape) - 1))).astype(np.int64)
        c = np.take_along_axis(clusters, pick.reshape(MI_USERS, -1),
                               axis=1).reshape(shape)
        rank = (rng.zipf(1.2, shape) - 1) % size
        return members[c, rank].astype(np.int32)

    lens = rng.integers(MI_MIN_LEN, MI_MAX_LEN + 1, MI_USERS)
    seq = draw((MI_USERS, MI_MAX_LEN))
    seq[np.arange(MI_MAX_LEN)[None, :] >= lens[:, None]] = 0
    target, held = draw((MI_USERS,)), draw((MI_USERS,))
    users = np.arange(MI_USERS, dtype=np.int32)
    train = {"user_id": users, "item_id": target, "item_seq": seq,
             "seq_len": lens.astype(np.int32)}
    # the evaluation masks what a user consumed: history and target
    eval_users = users[:MI_EVAL_USERS]
    train_u2i = {int(u): seq[u][:lens[u]].tolist() + [int(target[u])]
                 for u in eval_users}
    valid_u2i = {int(u): [int(held[u])] for u in eval_users}
    return train, train_u2i, valid_u2i


def mi_feature_map():
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    return FeatureMap("mi_1m", (
        FeatureSpec("user_id", "categorical", "user", vocab_size=MI_USERS,
                    embedding_dim=DIM),
        FeatureSpec("item_id", "categorical", "item", vocab_size=N_ITEMS,
                    embedding_dim=DIM)),
        query_index="user_id", corpus_index="item_id", num_items=N_ITEMS)


def mi_recall_vs_exact(svc, users, ids, n=512, chunk=64):
    """Mean |ids ∩ exact| / k over the first n users; the oracle scores
    each item by its best interest, bf16 towers in f32, exact top-k."""
    out = []
    with torch.no_grad():
        u = svc._encode(svc.model.encode_user,
                        {key: v[:n] for key, v in users.items()})
        items = svc.item_embs.to(torch.bfloat16).float()
        for s in range(0, n, chunk):
            sc = torch.einsum("ukd,id->uki",
                              u[s:s + chunk].to(torch.bfloat16).float(),
                              items).amax(dim=1)
            out.append(torch.topk(sc, K, dim=1).indices.cpu().numpy())
    return recall_at(ids[:n], np.concatenate(out))


def mi_serve(trainer, users, variants):
    """`RetrievalService.from_trainer` over the trained model, queried for
    N_QUERIES users at k = K from each corpus of ``variants``: B3's
    counts reset just before each query and read just after, queries/s,
    recall against the exact max-over-interests top-k, the device's idle
    share (`breakdown`)."""
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops import mips_topk
    from recbox_tpu_torch.retrieval import RetrievalService
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    t = time.perf_counter()
    svc = RetrievalService.from_trainer(trainer, corpus)
    torch.cuda.synchronize()
    out = {"corpus_encode_s": time.perf_counter() - t}
    for name in variants:
        s = svc if name == "bf16" else RetrievalService(
            trainer.model, item_embs=svc.item_embs, method="auto",
            quantize="int8", device=svc.device)
        counts, walls = [], []
        for _ in range(MI_QUERIES):
            fused.reset_launches()
            mips_topk.reset_launches()
            t = time.perf_counter()
            scores, ids = s.query(users, k=K)
            walls.append(time.perf_counter() - t)
            counts.append({"select": sum(fused.launches.values()),
                           **mips_topk.route_launches})
        assert scores.shape == ids.shape == (N_QUERIES, K)
        assert np.isfinite(scores).all() and (ids >= 0).all() \
            and (ids < N_ITEMS).all()
        assert (np.diff(scores, axis=1) <= 0).all()
        assert all(len(set(r)) == K for r in ids[:256].tolist())
        out[name] = {"launches_a_query": counts,
                     "queries_per_s": N_QUERIES / statistics.median(walls),
                     "query_wall_ms": [w * 1e3 for w in walls],
                     "recall_vs_exact": mi_recall_vs_exact(s, users, ids),
                     "breakdown": breakdown(s, users)
                     if DEVICE == "cuda" else None}
    return out


def multi_interest_1m():
    """Phase 5n (1): ComiRec-SA and MIND at their yaml widths over 1M items
    through `run_matching_experiment` (1 epoch of MI_STEPS batches of
    MI_BATCH, MI_NEGS sampled negatives, Recall@20 / NDCG@20 over
    MI_EVAL_USERS users at ``eval_batch_size`` 256: the evaluator scores a
    (chunk, 4, 1M) f32 block), then served by `RetrievalService.
    from_trainer` through B3's multi-interest route (8192 users x 4
    interests = 32,768 query rows, k = 500): ComiRec from a bf16 and an
    int8 corpus, MIND from bf16; then B3 alone at that shape against its
    plain version, and timed."""
    from recbox_tpu_torch import quick_start as qs
    t0 = time.perf_counter()
    train, train_u2i, valid_u2i = mi_data()
    fm = mi_feature_map()
    corpus = {"item_id": np.arange(N_ITEMS, dtype=np.int32)}
    eval_users = np.arange(MI_EVAL_USERS, dtype=np.int32)
    eval_arrays = {k: train[k][:MI_EVAL_USERS]
                   for k in ("user_id", "item_seq", "seq_len")}
    rows = MI_STEPS * MI_BATCH
    train_rows = {k: v[:rows] for k, v in train.items()}
    users = {k: train[k][:N_QUERIES]
             for k in ("user_id", "item_seq", "seq_len")}
    out = {"data_s": time.perf_counter() - t0, "items": N_ITEMS,
           "train_rows": rows, "chance_recall20": 20 / N_ITEMS,
           "history_len_mean": float(train["seq_len"].mean())}
    for name, variants in (("ComiRec", ("bf16", "int8")),
                           ("MIND", ("bf16",))):
        cfg = {**model_yaml(name), "epochs": 1, "batch_size": MI_BATCH,
               "num_negs": MI_NEGS, "eval_batch_size": MI_EVAL_BATCH,
               "learning_rate": MI_LR, "metrics": ["Recall(k=20)",
                                                   "NDCG(k=20)"],
               "monitor": "Recall(k=20)", "exclude_items": [0],
               "seed": SEED}
        t0 = time.perf_counter()
        res, trainer = run_recorded(lambda: qs.run_matching_experiment(
            cfg, fm, train_rows, corpus, eval_arrays, eval_users, train_u2i,
            valid_u2i, device=DEVICE))
        wall = time.perf_counter() - t0
        losses = step_losses(trainer)
        with torch.no_grad():
            trainer.model.eval()
            shape = tuple(trainer.model.encode_user(trainer._device_batch(
                {k: v[:8] for k, v in users.items()})).shape)
        entry = {"wall_s": wall, "fit_s": trainer.fit_s,
                 "eval_s": trainer.eval_s, "steps": int(trainer.step),
                 "losses": losses.tolist(), "user_tower_shape": shape,
                 **res, "serve": mi_serve(trainer, users, variants)}
        emit({"phase": "multi_interest_measured", "model": name, **entry})
        assert trainer.step == MI_STEPS and np.isfinite(losses).all() \
            and losses[-1] < losses[0], losses
        assert shape == (8, 4, DIM), shape
        assert res["Recall(k=20)"] > out["chance_recall20"], res
        for v, serve in entry["serve"].items():
            if v == "corpus_encode_s":
                continue
            assert all(c["select"] == 1 and c["wgmma"] == 1
                       and c["tile"] == 0
                       for c in serve["launches_a_query"]), (name, v, serve)
            assert serve["recall_vs_exact"] >= (0.95 if v == "bf16"
                                                else 0.90), (name, v, serve)
        out[name] = entry
        del trainer
        torch.cuda.empty_cache()
    # B3 alone at the multi-interest shape
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 102)
    nq = N_QUERIES * 4
    out["b3_check"] = {v: check_kernel(v, N_ITEMS, DIM, nq, K, gen)
                       for v in ("bf16", "int8")}
    out["b3_time"] = {v: time_kernel(v, N_ITEMS, DIM, nq, K, gen, reps=3)
                      for v in ("bf16", "int8")}
    return out


def matching_batch(loader):
    """The first batch of ``loader`` as tensors on the card."""
    return {k: torch.from_numpy(v).to(DEVICE)
            for k, v in next(iter(loader)).items()}


def ae_history(seed=SEED + 103):
    """(AE_USERS, AE_ITEMS) multi-hot rows: 20-200 Zipf(1.1) items a user
    over a random popularity order (ML-20M's users rate >= 20 items)."""
    from recbox_tpu_torch.models.matching import build_history_matrix
    rng = np.random.default_rng(seed)
    order = rng.permutation(AE_ITEMS)
    n = rng.integers(20, 201, AE_USERS)
    u = np.repeat(np.arange(AE_USERS), n)
    i = order[(rng.zipf(1.1, len(u)) - 1) % AE_ITEMS]
    return build_history_matrix(u, i, AE_USERS, AE_ITEMS)


def ract_target(logits, history, k=100):
    """Per-user NDCG@k of ``logits`` against the user's own history (what
    RaCT's critic learns to predict)."""
    top = torch.topk(logits, k, dim=1).indices
    hits = torch.gather(history, 1, top)
    disc = 1.0 / torch.log2(torch.arange(k, device=logits.device) + 2.0)
    ideal = torch.cumsum(disc, 0)[torch.clamp(history.sum(1).long(), 1, k)
                                  - 1]
    return (hits * disc).sum(1) / ideal


def autoencoders_ml20m():
    """Phase 5n (2): MultiVAE, MacridVAE, CDAE and RaCT at their yaml
    widths over ML-20M's 20,108-item catalog (8192 synthetic users): 8
    eager steps each on one batch of AE_BATCH rows (`eager_repeat`);
    RaCT's actor phase on `elbo_loss`, then its critic on the actor's
    per-user NDCG@100 (the features standardised); RecVAE through `RecVAETrainer.fit` for one epoch (3
    encoder sweeps, a prior refresh, 1 decoder sweep) over the 8192
    users."""
    from recbox_tpu_torch.models.matching import (
        CDAE, MacridVAE, MultiVAE, RaCT, RecVAE, cdae_loss, multivae_loss,
        ract_critic_features,
    )
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    from recbox_tpu_torch.training.recvae import RecVAETrainer
    t0 = time.perf_counter()
    hist = ae_history()
    out = {"data_s": time.perf_counter() - t0, "items": AE_ITEMS,
           "users": AE_USERS, "batch": AE_BATCH,
           "interactions_mean": float(hist.sum(1).mean())}
    batch = {"history": torch.from_numpy(hist[:AE_BATCH]).to(DEVICE),
             "user_id": torch.arange(AE_BATCH, device=DEVICE)}
    g = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)
    cfg = TrainerConfig(learning_rate=1e-3, seed=SEED)

    def yaml_kw(name):
        return {k: v for k, v in model_yaml(name).items() if k != "model"}

    mvae = MultiVAE(AE_ITEMS, **yaml_kw("MultiVAE"), generator=g(),
                    device=DEVICE)
    out["MultiVAE"] = eager_repeat(Trainer(
        mvae, lambda o, b: o, cfg, device=DEVICE, train_method="elbo_loss"),
        batch)
    macrid = MacridVAE(AE_ITEMS, **yaml_kw("MacridVAE"), generator=g(),
                       device=DEVICE)
    out["MacridVAE"] = eager_repeat(Trainer(
        macrid, lambda o, b: multivae_loss(o[0], b, o[1]), cfg,
        device=DEVICE, train_method="forward_with_kl"), batch)
    cdae = CDAE(AE_USERS, AE_ITEMS, **yaml_kw("CDAE"), generator=g(),
                device=DEVICE)
    out["CDAE"] = eager_repeat(Trainer(cdae, cdae_loss, cfg, device=DEVICE),
                               batch)
    ract = RaCT(AE_ITEMS, **yaml_kw("RaCT"), generator=g(), device=DEVICE)
    actor = eager_repeat(Trainer(ract.actor, lambda o, b: o, cfg,
                                 device=DEVICE, train_method="elbo_loss"),
                         batch)
    with torch.no_grad():
        ract.eval()
        logits, kl = ract.actor.forward_with_kl(batch)
        feats = ract_critic_features(logits, batch, kl)
        # standardised per column: the raw CE (~10^3) saturates the critic
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-6)
        target = ract_target(logits, batch["history"])

    class CriticPhase(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, b):
            return self.model.critic_score(b["feats"])

    critic = eager_repeat(Trainer(
        CriticPhase(ract), lambda o, b: torch.mean((o - b["target"]) ** 2),
        TrainerConfig(learning_rate=1e-2, seed=SEED), device=DEVICE),
        {"feats": feats, "target": target})
    out["RaCT"] = {"actor": actor, "critic": critic,
                   "target_ndcg100_mean": float(target.mean())}
    recvae = RecVAE(AE_ITEMS, **yaml_kw("RecVAE"), generator=g(),
                    device=DEVICE)
    rt = RecVAETrainer(recvae, seed=SEED, device=DEVICE)
    t0 = time.perf_counter()
    rt.fit(hist, epochs=1, batch_size=AE_BATCH)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    sweeps = AE_USERS // AE_BATCH
    scores = rt.scores(hist[:AE_BATCH])
    out["RecVAE"] = {"fit_s": fit_s, "steps": 4 * sweeps,
                     "ms_a_step": fit_s / (4 * sweeps) * 1e3,
                     "enc_steps": int(rt._opts[False].count),
                     "dec_steps": int(rt._opts[True].count)}
    assert out["RecVAE"]["enc_steps"] == 3 * sweeps \
        and out["RecVAE"]["dec_steps"] == sweeps, out["RecVAE"]
    assert np.isfinite(scores).all() and scores.shape == (AE_BATCH,
                                                          AE_ITEMS)
    return out


def graph_extended_gowalla():
    """Phase 5n (3): SGL, NCL, DGCF, SpectralCF, GCMC and LINE at their yaml
    widths over phase 5f's LightGCN data (30,000 x 41,000, 1M
    interactions): 8 eager steps each on one `MatchingLoader` batch of
    LG_BATCH at Adam EAGER_EMBEDDING_LR (BPR over one negative; SGL adds SGL_SSL_WEIGHT x its
    InfoNCE over two edge-dropout views, NCL NCL_SSL_WEIGHT x its
    structural and prototype terms on `kmeans_prototypes`' centers)."""
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.models.matching import build_norm_edges
    from recbox_tpu_torch.models.matching import graph_extended as ge
    from recbox_tpu_torch.ops.losses import get_matching_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    t0 = time.perf_counter()
    tr_u, tr_i, _, _ = lightgcn_data()
    eu, ei, c = build_norm_edges(tr_u, tr_i, LG_USERS, LG_ITEMS)
    fm, _, _ = lightgcn_trainer(tr_u[:1], tr_i[:1])
    loader = MatchingLoader(fm, {"user_id": tr_u, "item_id": tr_i},
                            {"item_id": np.arange(LG_ITEMS, dtype=np.int32)},
                            batch_size=LG_BATCH, num_negs=1, seed=SEED)
    batch = matching_batch(loader)
    out = {"data_s": time.perf_counter() - t0, "edges": len(eu)}
    bpr = get_matching_loss("PairwiseLogisticLoss")
    for name in ("SGL", "NCL", "DGCF", "SpectralCF", "GCMC", "LINE"):
        kw = {k: v for k, v in model_yaml(name).items()
              if k not in ("model", "edge_users", "edge_items", "edge_coefs",
                           "num_users", "num_items")}
        model = getattr(ge, name)(
            fm, num_users=LG_USERS, num_items=LG_ITEMS, edge_users=eu,
            edge_items=ei, edge_coefs=c, **kw,
            generator=torch.Generator(device=DEVICE).manual_seed(SEED),
            device=DEVICE)
        if name == "SGL":
            def loss(o, b, _m=model):
                return bpr(o) + SGL_SSL_WEIGHT * _m.ssl_loss(b)
        elif name == "NCL":
            with torch.no_grad():
                uc, ua = ge.kmeans_prototypes(
                    model.emb_user.cpu().numpy(), 64, n_iters=5, seed=SEED)
                ic, ia = ge.kmeans_prototypes(
                    model.emb_item.cpu().numpy(), 64, n_iters=5, seed=SEED)

            def loss(o, b, _m=model):
                return bpr(o) + NCL_SSL_WEIGHT * (
                    _m.structural_loss(b)
                    + _m.prototype_loss(b, uc, ic, ua, ia))
        else:
            def loss(o, b):
                return bpr(o)
        trainer = Trainer(model, loss, TrainerConfig(
            learning_rate=EAGER_EMBEDDING_LR, seed=SEED), device=DEVICE)
        out[name] = eager_repeat(trainer, batch)
        del trainer, model
        torch.cuda.empty_cache()
    return out


def simplex_sbc_item2vec():
    """Phase 5n (4): SimpleX (cosine contrastive loss over the negatives)
    and YoutubeSBC (in-batch sampled softmax with the log popularity of
    the batch's items) at their yaml widths over phase (1)'s 1M-item data,
    and Item2Vec (SGNS, I2V_NEGS uniform negatives) over skip-gram pairs
    of phase 5f's users: 8 eager steps each on one batch."""
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.models.matching import (
        Item2Vec, SimpleX, YoutubeSBC, build_skipgram_pairs,
        sampled_softmax_inbatch_loss, sgns_loss,
    )
    from recbox_tpu_torch.ops.losses import get_matching_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    train, _, _ = mi_data()
    fm = mi_feature_map()
    rows = {k: v[:MI_BATCH] for k, v in train.items()}
    loader = MatchingLoader(fm, rows, {"item_id": np.arange(
        N_ITEMS, dtype=np.int32)}, batch_size=MI_BATCH, num_negs=MI_NEGS,
        seed=SEED, exclude_ids=(0,))
    batch = matching_batch(loader)
    cfg = TrainerConfig(learning_rate=1e-3, seed=SEED)
    g = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    kw = {k: v for k, v in model_yaml("SimpleX").items() if k != "model"}
    out["SimpleX"] = eager_repeat(Trainer(
        SimpleX(fm, **kw, generator=g(), device=DEVICE),
        lambda o, b: get_matching_loss("CosineContrastiveLoss")(o), cfg,
        device=DEVICE), batch)
    counts = np.bincount(train["item_id"], minlength=N_ITEMS) + 1.0
    log_q = torch.from_numpy(np.log(counts / counts.sum()).astype(
        np.float32)).to(DEVICE)
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in model_yaml("YoutubeSBC").items() if k != "model"}
    out["YoutubeSBC"] = eager_repeat(Trainer(
        YoutubeSBC(fm, **kw, generator=g(), device=DEVICE),
        lambda o, b: sampled_softmax_inbatch_loss(
            o, log_q[b["item_id"].long()]), cfg, device=DEVICE,
        train_method="inbatch_scores"), batch)
    tr_u, tr_i, _, _ = lightgcn_data()
    keep = tr_u < I2V_USERS
    u2i = {}
    for a, b in zip(tr_u[keep].tolist(), tr_i[keep].tolist()):
        u2i.setdefault(a, []).append(b)
    t0 = time.perf_counter()
    centers, contexts = build_skipgram_pairs(u2i, window=2, seed=SEED)
    pairs_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 104)
    sel = rng.choice(len(centers), I2V_BATCH, replace=False)
    ib = {"center": centers[sel], "context": contexts[sel],
          "neg": rng.integers(0, LG_ITEMS, (I2V_BATCH, I2V_NEGS)
                              ).astype(np.int32)}
    ib = {k: torch.from_numpy(v).to(DEVICE) for k, v in ib.items()}
    i2v = Item2Vec(LG_ITEMS, **{k: v for k, v in model_yaml(
        "Item2Vec").items() if k != "model"}, generator=g(), device=DEVICE)
    out["Item2Vec"] = {"pairs": len(centers), "pairs_s": pairs_s,
                       **eager_repeat(Trainer(i2v, lambda o, b: sgns_loss(o),
                                              TrainerConfig(
                                                  learning_rate=1e-2,
                                                  seed=SEED),
                                              device=DEVICE), ib)}
    return out


# -- 5o: the knowledge stage ---------------------------------------------------

# a synthetic KG over ml1m_scale's 3706 items (ML-1M's own size), in the
# shape of KB4Rec's MovieLens-1M links (Zhao et al., Data Intelligence
# 2019): genre, director, actors and year of each film
KG_GENRES, KG_DIRECTORS, KG_ACTORS, KG_YEARS, KG_CAST = 18, 2000, 8000, 80, 3
KG_EAGER_BATCH = 2048
KG_BATCH = 512          # run_kg_experiment's kg_batch_size default
# KGCN's and KGNNLS's depth in 5o (the yamls' 1): at one hop an item's
# neighbours are its attribute entities, whose labels are 0, so the
# propagated label is 0 and KGNNLS's label-smoothness term is its clipped
# constant, with no gradient
KG_LS_HOPS = 2


def kg_own_loss(name, model, labels):
    """BPR plus the term of ``name``'s own (None where the model has none):
    KGNNLS's label smoothness over ``labels`` (a (users, entities) 0/1
    matrix of the training items; the positive column's target is 1),
    KGIN's intent independence, MCCLK's cross-view contrast."""
    from recbox_tpu_torch.ops.losses import get_matching_loss
    bpr = get_matching_loss("PairwiseLogisticLoss")

    def ls(o, b):
        ids = b["__item_ids__"]
        targets = torch.zeros(ids.shape, device=ids.device)
        targets[:, 0] = 1.0
        return bpr(o) + model.ls_loss(b, ids, labels[b["user_id"].long()],
                                      targets)
    return {"KGNNLS": ls,
            "KGIN": lambda o, b: bpr(o) + model.independence_loss(),
            "MCCLK": lambda o, b: bpr(o) + model.contrastive_loss(b),
            }.get(name)


def sized_yaml(name):
    """`model_yaml` without the graph's sizes (the yaml's 0 placeholders,
    which `run_experiment` fills from the loaded graph)."""
    return {k: v for k, v in model_yaml(name).items()
            if k not in ("num_users", "num_items", "n_entities",
                         "n_relations")}


def stage_ml1m_kg(root, src=None):
    """``root``/ml1m_kg/ml1m_kg.{inter,link,kg}: ml1m_scale's interactions
    (or those of the .inter file ``src``), each item linked to an entity
    of its own, and the item's genre, director, KG_CAST actors and year as
    triples."""
    from recbox_tpu_torch.tools import quality_exit as qe
    if src is None:
        src = os.path.join(qe.gen_ml1m_scale(root), "ml1m_scale.inter")
    d = os.path.join(root, "ml1m_kg")
    os.makedirs(d, exist_ok=True)
    items = []
    with open(src) as fh, open(os.path.join(d, "ml1m_kg.inter"), "w") as out:
        header = fh.readline()
        out.write(header)
        col = header.rstrip("\n").split("\t").index("item_id:token")
        for line in fh:
            out.write(line)
            items.append(line.rstrip("\n").split("\t")[col])
    items = sorted(set(items))
    rng = np.random.default_rng(SEED + 105)
    with open(os.path.join(d, "ml1m_kg.link"), "w") as fh:
        fh.write("item_id:token\tentity_id:token\n")
        fh.writelines(f"{i}\tm{i}\n" for i in items)
    triples = 0
    with open(os.path.join(d, "ml1m_kg.kg"), "w") as fh:
        fh.write("head_id:token\trelation_id:token\ttail_id:token\n")
        for i in items:
            rows = [("genre", f"g{rng.integers(KG_GENRES)}"),
                    ("directed_by", f"d{rng.zipf(1.5) % KG_DIRECTORS}"),
                    ("year", f"y{rng.integers(KG_YEARS)}")]
            rows += [("starring", f"a{a}") for a in rng.choice(
                KG_ACTORS, KG_CAST, replace=False)]
            fh.writelines(f"m{i}\t{r}\t{t}\n" for r, t in rows)
            triples += len(rows)
    return root, {"items": len(items), "triples": triples}


def ml1m_kg_split(root):
    """The staged ``root``/ml1m_kg loaded and split as 5o trains on it:
    the interactions (``inter``), the KG, the feature map, the train rows
    (``tr``), the corpus, the train / valid user → items maps, the valid
    users (``vu``) and KGAT's `run_kg_experiment` config at kgat.yaml's
    widths over the collaborative KG of the train rows (``kgat``), one
    epoch of batches of 2048."""
    from recbox_tpu_torch.data import load_atomic_dataset
    from recbox_tpu_torch.data.knowledge import collaborative_kg_edges
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    ds = load_atomic_dataset(os.path.join(root, "ml1m_kg"), "ml1m_kg")
    inter = ds.to_interactions(rating_field="rating",
                               time_field="timestamp")
    kg = ds.to_knowledge_graph()
    n_users, n_items = inter.num_users, inter.num_items
    train, valid, _ = inter.split_ratio((0.8, 0.1, 0.1), order="TO",
                                        group_by_user=True, seed=SEED)
    u2i = {}
    for a, b in zip(train.user_ids.tolist(), train.item_ids.tolist()):
        u2i.setdefault(a, []).append(b)
    v2i = {}
    for a, b in zip(valid.user_ids.tolist(), valid.item_ids.tolist()):
        v2i.setdefault(a, []).append(b)
    fm = FeatureMap("ml1m_kg", (
        FeatureSpec("user_id", "categorical", "user", vocab_size=n_users,
                    embedding_dim=64),
        FeatureSpec("item_id", "categorical", "item", vocab_size=n_items,
                    embedding_dim=64)),
        query_index="user_id", corpus_index="item_id", num_items=n_items)
    tr = {"user_id": train.user_ids.astype(np.int32),
          "item_id": train.item_ids.astype(np.int32)}
    h, r, t = collaborative_kg_edges(kg, tr["user_id"], tr["item_id"],
                                     n_users)
    kcfg = {**sized_yaml("KGAT"), "num_users": n_users,
            "n_entities": kg.n_entities, "n_relations": kg.n_relations,
            "ckg_heads": h, "ckg_relations": r, "ckg_tails": t,
            "epochs": 1, "batch_size": 2048, "monitor": "Recall(k=20)",
            "exclude_items": [0], "seed": SEED}
    return {"inter": inter, "kg": kg, "fm": fm, "tr": tr,
            "corpus": {"item_id": np.arange(n_items, dtype=np.int32)},
            "u2i": u2i, "v2i": v2i, "vu": np.asarray(sorted(v2i), np.int64),
            "kgat": kcfg}


def knowledge_ml1m(root):
    """Phase 5o: (1) `run_experiment("CKE", "ml1m_kg")` over the staged
    files at cke.yaml's widths (1 epoch: the CF phase, then the KG phase
    under its own Adam), Recall@20 above chance; (2) KGAT at kgat.yaml's
    widths through `run_kg_experiment` over the collaborative KG of the
    same split (`collaborative_kg_edges`), 1 epoch; (3) CFKG, KTUP, MKR,
    KGCN, KGNNLS, RippleNet, KGIN, MCCLK and KSR at their yaml widths: 8
    eager steps each on one batch of KG_EAGER_BATCH (BPR over one
    negative; KSR full-softmax CE over the items). The three models whose
    own term sets them apart train on BPR plus that term at unit weight
    (`kg_own_loss`: KGNNLS's ``ls_loss`` over the batch users' training
    items, KGIN's ``independence_loss``, MCCLK's ``contrastive_loss``;
    JAX's pipeline trains none of them and no yaml weights them), and
    KGNNLS's losses must differ from KGCN's (both at KG_LS_HOPS over the
    KG with its inverse edges, where the term has a gradient). Then each
    model with a ``kg_loss`` (CFKG, KTUP, MKR on one batch of KG_BATCH
    triples drawn as `run_kg_experiment` draws them, RippleNet on its
    ripple batch) takes 8 eager steps of it under an Adam of its own."""
    from recbox_tpu_torch import quick_start as qs
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.data.knowledge import (
        build_neighbor_table, build_ripple_sets,
    )
    from recbox_tpu_torch.data.sequential import (
        group_user_sequences, leave_one_out_split,
    )
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.ops.losses import (
        full_softmax_loss, get_matching_loss,
    )
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    t0 = time.perf_counter()
    root, staged = stage_ml1m_kg(root)
    out = {"stage_s": time.perf_counter() - t0, **staged}
    cfg = {**sized_yaml("CKE"), "epochs": 1, "batch_size": 2048,
           "monitor": "Recall(k=20)", "seed": SEED}
    t0 = time.perf_counter()
    res, trainer = run_recorded(lambda: qs.run_experiment(
        "CKE", "ml1m_kg", config=cfg, data_dir=root, device=DEVICE))
    out["CKE_run_experiment"] = {
        "wall_s": time.perf_counter() - t0, "fit_steps": int(trainer.step),
        "losses_first_last": step_losses(trainer)[[0, -1]].tolist(), **res}
    del trainer

    sp = ml1m_kg_split(root)
    inter, kg, fm, tr, corpus = (sp[k] for k in ("inter", "kg", "fm", "tr",
                                                 "corpus"))
    u2i, v2i, vu, kcfg = (sp[k] for k in ("u2i", "v2i", "vu", "kgat"))
    n_users, n_items = inter.num_users, inter.num_items
    chance = 20 / n_items
    h = kcfg["ckg_heads"]
    t0 = time.perf_counter()
    res, trainer = run_recorded(lambda: qs.run_kg_experiment(
        kcfg, fm, tr, corpus, kg, {"user_id": vu.astype(np.int32)}, vu,
        u2i, v2i, device=DEVICE))
    out["KGAT_run_kg_experiment"] = {
        "wall_s": time.perf_counter() - t0, "ckg_edges": len(h),
        "fit_steps": int(trainer.step),
        "losses_first_last": step_losses(trainer)[[0, -1]].tolist(), **res}
    del trainer
    out.update(users=n_users, entities=kg.n_entities,
               relations=kg.n_relations, kg_triples=kg.n_triples,
               chance_recall20=chance)

    loader = MatchingLoader(fm, tr, corpus, batch_size=KG_EAGER_BATCH,
                            num_negs=1, seed=SEED, exclude_ids=(0,))
    batch = matching_batch(loader)
    ents, rels = build_neighbor_table(kg, 4, seed=SEED)
    rs = build_ripple_sets(kg, {u: u2i[u] for u in sorted(u2i)}, 2, 16,
                           seed=SEED)
    row = np.full(n_users, 0, np.int64)
    row[rs["users"]] = np.arange(len(rs["users"]))
    sel = row[batch["user_id"].cpu().numpy()]
    rb = dict(batch, **{f"ripple_{k}": torch.from_numpy(rs[k][sel]).to(
        DEVICE) for k in ("heads", "relations", "tails")})
    # KGCN and KGNNLS over the KG with its inverse edges (recbole's KGCN
    # adjacency is undirected) at KG_LS_HOPS: a label reaches an item only
    # back through its attributes
    ikg = kg.with_inverse()
    iens, irels = build_neighbor_table(ikg, 4, seed=SEED)
    lsg = dict(neighbor_entities=iens, neighbor_relations=irels,
               n_relations=ikg.n_relations, n_hops=KG_LS_HOPS)
    graph = {"KGCN": lsg, "KGNNLS": lsg,
             "KGIN": dict(inter_users=tr["user_id"],
                          inter_items=tr["item_id"], kg_heads=kg.heads,
                          kg_relations=kg.relations, kg_tails=kg.tails),
             "KSR": dict(kg_neighbors=ents)}
    graph["MCCLK"] = graph["KGIN"]
    labels = torch.zeros(n_users, kg.n_entities, device=DEVICE)
    labels[torch.from_numpy(tr["user_id"]).long(),
           torch.from_numpy(tr["item_id"]).long()] = 1.0
    kg_rng = np.random.default_rng(SEED + 7)
    idx = kg_rng.integers(0, kg.n_triples, size=KG_BATCH)
    kb = {"kg_head": kg.heads[idx], "kg_relation": kg.relations[idx],
          "kg_tail": kg.tails[idx],
          "kg_neg_tail": kg_rng.integers(0, kg.n_entities, size=KG_BATCH)}
    kb = {k: torch.as_tensor(np.asarray(v)).to(DEVICE)
          for k, v in kb.items()}
    bpr = get_matching_loss("PairwiseLogisticLoss")
    sizes = dict(num_users=n_users, num_items=n_items,
                 n_entities=kg.n_entities, n_relations=kg.n_relations)
    for name in ("CFKG", "KTUP", "MKR", "KGCN", "KGNNLS", "RippleNet",
                 "KGIN", "MCCLK", "KSR"):
        mcfg = {**sized_yaml(name), **sizes, **graph.get(name, {}),
                "seed": SEED}
        if name == "KSR":
            seqs = group_user_sequences(inter.user_ids, inter.item_ids,
                                        inter.timestamps)
            sq, _, _ = leave_one_out_split(seqs, max_len=50)
            sfm = FeatureMap("ml1m_kg", (FeatureSpec(
                "item_id", "categorical", "item", vocab_size=n_items,
                embedding_dim=64),), query_index="user_id",
                corpus_index="item_id", num_items=n_items)
            model, _ = qs.build_model(mcfg, sfm, DEVICE)
            b = {k: torch.from_numpy(v[:KG_EAGER_BATCH]).to(DEVICE)
                 for k, v in sq.items()}
            trainer = Trainer(model, lambda o, b: full_softmax_loss(
                o, b["item_id"]), TrainerConfig(learning_rate=1e-3,
                                                seed=SEED),
                device=DEVICE, train_method="full_scores")
        else:
            model, _ = qs.build_model(mcfg, fm, DEVICE)
            b = rb if name == "RippleNet" else batch
            loss = kg_own_loss(name, model, labels) or (lambda o, b: bpr(o))
            trainer = Trainer(model, loss, TrainerConfig(
                learning_rate=1e-3, seed=SEED), device=DEVICE)
        out[name] = eager_repeat(trainer, b)
        if hasattr(model, "kg_loss"):
            trainer = Trainer(model, lambda o, b: o, TrainerConfig(
                learning_rate=1e-3, seed=SEED), device=DEVICE,
                train_method="kg_loss")
            out[name]["kg_loss"] = eager_repeat(
                trainer, rb if name == "RippleNet" else kb)
        del trainer, model
        torch.cuda.empty_cache()
    # KGNNLS is KGCN with label smoothness: the same seed and batch, so
    # equal losses would mean its own term never ran
    assert out["KGNNLS"]["losses"] != out["KGCN"]["losses"], \
        (out["KGNNLS"], out["KGCN"])
    for key in ("CKE_run_experiment", "KGAT_run_kg_experiment"):
        assert np.isfinite(out[key]["Recall(k=20)"]) \
            and out[key]["Recall(k=20)"] > chance, (key, out[key])
    return out


# -- 5p: the packed trainer's other layouts, the RL rerankers, the registry --

ADAM_STEPS = 16
# lazy Adam's table lr: the default (the dense lr, 1e-3) moves a row seen
# ~5 times in the epoch by ~5e-3, and the held-out AUC then sits ~0.007
# above chance (CPU rehearsal at 20,000 ids a field, 16 x 6554 rows: 0.5066;
# at 1e-2: 0.5115)
ADAM_EMBEDDING_LR = 1e-2
SPLIT_DIM, SPLIT_STEPS = 128, 16
RL_TRAIN, RL_VALID, RL_N, RL_FEATS = 16_384, 4_096, 30, 65
RL_BATCH, RL_EPOCHS, RL_LR = 256, 1, 1e-3
PPO_UPDATES, PPO_INNER, PPO_LISTS, PPO_LR = 8, 4, 2048, 5e-3
# LambdaMART's lists: 400, a depth cut from 1,000 (~15 s of host numpy) to
# keep the script inside its time
LM_LISTS, LM_TREES, LM_DEPTH = 200, 10, 4


def block_rows_criteo(per_feature=None):
    """Phase 5p (1): phase 5's DeepFM trainer with ``block_rows=True``:
    block mode confirmed; 16 steps in two fused calls of 8 (one B1 launch
    a step, counted from 0 just before, a falling loss); B1 on one eager
    step's own (F·B, d) block gradients against its plain version, and its
    time, bound and `index_add_` there; a replayed step equal to an eager
    one; one step of an f32 block trainer against an f32 per-feature one
    from the same draw on the same batch, accumulators from 0.1 (the
    losses within 1e-5, the packs' difference within 1e-3 of the largest
    update); eager against replayed
    ms a step (`fused_vs_eager`) beside ``per_feature`` (5c's), and one
    replayed step under torch.profiler by group."""
    from recbox_tpu_torch.ops import packed_delta

    data = CriteoBatches(SEED + 11)
    batches = [data() for _ in range(2 * FIT_K)]
    trainer = criteo_trainer(SEED, block_rows=True)
    trainer.init(batches[0])
    (pname, pack), = trainer.packs.items()
    assert trainer._block_mode == {pname: True}, trainer._block_mode
    packed_delta.reset_launches()
    losses = torch.cat([trainer.train_steps_fused(stacked(
        batches[i:i + FIT_K])) for i in range(0, 2 * FIT_K, FIT_K)])
    losses = losses.float().cpu().numpy()
    launches = packed_delta.launches["packed_adagrad_update"]
    assert launches == 2 * FIT_K, launches
    assert np.isfinite(losses).all() \
        and losses[-4:].mean() < losses[:4].mean(), losses
    rec = capture_b1_call(trainer, batches[0])
    assert rec["grads"][0].shape == (NUM_CAT * BATCH, DIM), \
        rec["grads"][0].shape
    b1 = b1_on_captured(rec, pad_row=0)
    del rec
    match = graph_step_matches_eager(
        trainer, batches[1],
        lambda: {"pack": trainer.packs[pname],
                 "dnn_w1": trainer.params["dnn_w1"]})
    speed = fused_vs_eager(trainer, batches, packed_delta.launches)
    assert speed["fused_launches"]["packed_adagrad_update"] \
        == speed["fused_steps"], speed
    profile = train_breakdown(
        trainer, batches[0], groups=ZOO_GROUPS,
        steps=lambda: trainer.train_steps_fused(stacked([batches[0]])))
    del trainer, pack
    torch.cuda.empty_cache()
    # the block path against the per-feature one, in f32 (bf16 sums the
    # feature runs in another order than the whole stack), the
    # accumulators from PACKED_ADAGRAD_INIT: from 0, AdaGrad's first
    # update of a row is g / rms(g), which turns the rounding of a
    # near-cancelling row gradient into differences of up to 1e-3 of the
    # largest update (on the H100: 4.2e-4 of 0.46)
    pair = {}
    for mode in (True, False):
        t = criteo_trainer(SEED + 1, block_rows=mode,
                           compute_dtype="float32",
                           adagrad_init=PACKED_ADAGRAD_INIT)
        t.init(batches[2])
        assert t._block_mode == {pname: mode}, t._block_mode
        before = t.packs[pname].clone()
        pair[mode] = (float(t.train_step(batches[2])),
                      t.packs[pname] - before)
        del t, before
    (lb, db), (lf, df) = pair[True], pair[False]
    upd = float(df.abs().max())
    err = float((db - df).abs().max())
    assert abs(lb - lf) <= 1e-5 * abs(lf) and upd > 0 \
        and err <= 1e-3 * upd, (lb, lf, err, upd)
    del pair, db, df
    torch.cuda.empty_cache()
    return {"pack": pname, "block_mode": True, "steps": 2 * FIT_K,
            "fused_calls": 2, "b1_launches": launches,
            "losses": losses.tolist(), "b1_block_grads": b1,
            "replay_vs_eager": match,
            "block_vs_per_feature_f32": {"loss": [lb, lf],
                                         "max_pack_update": upd,
                                         "max_abs_diff": err},
            "per_feature_5c": per_feature or {},
            "replayed_step_profile": profile, **speed}


def lazy_adam_criteo():
    """Phase 5p (2): DeepFM at deepfm.yaml's widths (dim 16, (400, 400,
    400), f32) through `run_ranking_experiment(trainer: packed,
    embedding_optimizer: adam)` over phase 5's schema at dim 16: 1 epoch
    of 16 batches of 32,768, eager steps, the tables at ADAM_EMBEDDING_LR;
    held-out AUC above 0.5, a falling loss, the [values | m | v] pack (3 x
    17 used of 128) and its bytes, no B1 launch (lazy Adam is plain torch,
    as JAX's jnp chain); then ms a step over 8 more eager steps."""
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.quick_start import run_ranking_experiment

    data = CriteoBatches(SEED + 12)
    batches = [data() for _ in range(ADAM_STEPS)]
    held = [data() for _ in range(FIT_HELD_OUT_BATCHES)]

    def arrays(bs):
        return {k: torch.cat([b[k] for b in bs]).cpu().numpy()
                for k in bs[0]}

    config = {"model": "DeepFM", **model_yaml("deepfm"),
              "trainer": "packed", "embedding_optimizer": "adam",
              "embedding_lr": ADAM_EMBEDDING_LR,
              "batch_size": BATCH, "epochs": 1, "learning_rate": 1e-3,
              "grad_clip_norm": 10.0, "seed": SEED, "monitor": "AUC",
              "metrics": ["AUC", "logloss"]}
    packed_delta.reset_launches()
    t0 = time.perf_counter()
    result, trainer = run_packed_recorded(lambda: run_ranking_experiment(
        config, zoo_feature_map(), arrays(batches), arrays(held),
        device=DEVICE))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = packed_delta.launches["packed_adagrad_update"]
    losses = step_losses(trainer)
    (pname, pack), = trainer.packs.items()
    w_val = trainer._value_width[pname]
    assert launches == 0 and trainer.embedding_optimizer == "adam", launches
    assert w_val == ZOO_DIM + 1 and pack.shape[1] == 128 \
        and not trainer.accs, (w_val, tuple(pack.shape))
    assert len(losses) == ADAM_STEPS and np.isfinite(losses).all() \
        and losses[-4:].mean() < losses[:4].mean(), losses
    assert result["AUC"] > 0.5, result
    # the v block moved where ids were touched
    assert float(pack[:, 2 * w_val:3 * w_val].max()) > 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[:8]:
        trainer.train_step(b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 8 * 1e3
    out = {"model": "DeepFM", "steps": ADAM_STEPS, "fit_s": fit_s,
           "b1_launches": launches, "losses": losses.tolist(),
           "pack": pname, "pack_shape": list(pack.shape),
           "used_columns": 3 * w_val, "pack_bytes": pack.numel() * 4,
           "emb_lr": trainer._emb_lr, "eager_ms_a_step": ms, **result}
    del trainer, pack
    torch.cuda.empty_cache()
    return out


def split_accumulators_criteo():
    """Phase 5p (3): DCNv2 at dcnv2.yaml's widths with embedding_dim 128
    over phase 5's schema (the cut: MLPerf's DLRM-DCNv2 vocabularies, to
    26 x 100,000): one value slot of 128 fills the pad, so the AdaGrad
    accumulators sit in the split ``accs``. 16 eager steps with each
    step's row gradients recorded, a falling loss, no B1 launch; ``accs``
    against the squared-gradient row means accumulated over the steps' ids
    (f64, rtol 1e-5); ms a step, eager and replayed."""
    from recbox_tpu_torch.models import ranking
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.ops.losses import binary_crossentropy
    from recbox_tpu_torch.training import (
        PackedEmbeddingTrainer, TrainerConfig,
    )
    from recbox_tpu_torch.training import packed

    yaml = {k: v for k, v in model_yaml("dcnv2").items()
            if k not in ("model", "embedding_dim")}
    model = ranking.DCNv2(
        zoo_feature_map(dim=SPLIT_DIM), embedding_dim=SPLIT_DIM, **yaml,
        generator=torch.Generator(device=DEVICE).manual_seed(SEED),
        device=DEVICE)
    trainer = PackedEmbeddingTrainer(
        model, lambda o, b: binary_crossentropy(o, b["click"]),
        TrainerConfig(learning_rate=1e-3, grad_clip_norm=10.0, seed=SEED,
                      epochs=1), device=DEVICE)
    data = CriteoBatches(SEED + 13)
    batches = [data() for _ in range(SPLIT_STEPS)]
    trainer.init(batches[0])
    (pname, pack), = trainer.packs.items()
    accs = trainer.accs[pname]
    assert not trainer._acc_in_row[pname] and pack.shape[1] == SPLIT_DIM \
        and tuple(accs.shape) == (NUM_CAT * VOCAB, 1), (pname, pack.shape)
    want = accs.double().clone()
    orig = PackedEmbeddingTrainer._apply_row_updates

    def record(self, row_grads, ctx, emb_lr):
        for name, (ids, segs, _, _) in ctx.items():
            slots = self._slots[name]
            (g,) = self._slot_grads(slots, segs, row_grads)
            want.index_add_(0, ids.long(), torch.mean(
                torch.square(g.double()), dim=-1, keepdim=True))
        return orig(self, row_grads, ctx, emb_lr)

    packed_delta.reset_launches()
    packed.PackedEmbeddingTrainer._apply_row_updates = record
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = torch.stack([trainer.train_step(b) for b in batches])
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / SPLIT_STEPS * 1e3
    finally:
        packed.PackedEmbeddingTrainer._apply_row_updates = orig
    losses = losses.float().cpu().numpy()
    launches = packed_delta.launches["packed_adagrad_update"]
    assert launches == 0, launches
    assert np.isfinite(losses).all() \
        and losses[-4:].mean() < losses[:4].mean(), losses
    err = (accs.double() - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30))[want > 0].max())
    assert bool((err <= 1e-5 * want.abs() + 1e-12).all()), rel
    touched = int((want > 0).sum())
    walls = []
    for i in range(2):
        chunk = stacked(batches[FIT_K * i:FIT_K * (i + 1)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_steps_fused(chunk)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / FIT_K)
    assert packed_delta.launches["packed_adagrad_update"] == 0
    out = {"model": "DCNv2", "embedding_dim": SPLIT_DIM,
           "steps": SPLIT_STEPS, "b1_launches": launches,
           "losses": losses.tolist(), "pack": pname,
           "pack_shape": list(pack.shape), "accs_shape": list(accs.shape),
           "accs_rows_touched": touched, "accs_max_rel_err": rel,
           "eager_ms_a_step": eager_ms,
           "replayed_ms_a_step": walls,
           "params": sum(p.numel() for p in trainer.params.values())}
    del trainer, pack, accs, want
    torch.cuda.empty_cache()
    return out


def rl_lists(n, seed, w, scorer_noise=1.0):
    """``n`` lists of RL_N slots x RL_FEATS features on the card: features
    N(0, 1), the last column a ranker's score (the planted linear score
    plus noise of ``scorer_noise`` times its spread, in units of the
    score's std), a click where the planted score is in the list's top
    third; every fourth list has its last 5 slots padded."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    feats = torch.randn(n, RL_N, RL_FEATS, generator=g, device=DEVICE)
    score = feats[..., :-1] @ w
    feats[..., -1] = (score + scorer_noise * float(score.std())
                      * torch.randn(n, RL_N, generator=g, device=DEVICE)) \
        / float(score.std())
    mask = torch.ones(n, RL_N, dtype=torch.bool, device=DEVICE)
    mask[::4, -5:] = False
    rank = torch.argsort(torch.argsort(
        torch.where(mask, score, torch.full_like(score, -1e9)), dim=1,
        descending=True), dim=1)
    labels = ((rank < RL_N // 3) & mask).float()
    return {"item_feats": feats, "labels": labels, "mask": mask}


def rl_rerankers():
    """Phase 5p (4): EGR and EGREvaluator at their yaml widths through
    `run_rerank_experiment` (NDCG@10 above the random order's); a PPO loop
    (PPOReranker at pporeranker.yaml's widths: 8 updates, each a rollout
    of PPO_LISTS lists from a frozen copy of the policy, `list_reward_ndcg`,
    then PPO_INNER Adam steps of `ppo_loss` over `evaluate_actions`, the
    draws from a generator seeded from the config; the mean list reward of
    the last two rollouts above the first two's); EGR's generator loop
    (REINFORCE on the trained evaluator's `list_value`, 8 updates); ms a
    rollout and an update."""
    import copy

    from recbox_tpu_torch import quick_start as qs
    from recbox_tpu_torch.evaluation.rerank import evaluate_rerank
    from recbox_tpu_torch.models.reranking import rl
    from recbox_tpu_torch.training.trainer import (
        TrainerConfig, _make_optimizer,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    w = torch.randn(RL_FEATS - 1, generator=gen, device=DEVICE)
    train = rl_lists(RL_TRAIN, SEED + 15, w)
    valid = rl_lists(RL_VALID, SEED + 16, w)
    host = {k: {n: v.cpu().numpy() for n, v in d.items()}
            for k, d in (("train", train), ("valid", valid))}
    rng = np.random.default_rng(SEED)
    random_order = evaluate_rerank(
        rng.random(host["valid"]["labels"].shape), host["valid"]["labels"],
        host["valid"]["mask"], ks=(10,))
    ranker_order = evaluate_rerank(
        host["valid"]["item_feats"][..., -1], host["valid"]["labels"],
        host["valid"]["mask"], ks=(10,))
    out = {"lists": [RL_TRAIN, RL_VALID], "slots": RL_N,
           "features": RL_FEATS, "random_order": random_order,
           "ranker_order": ranker_order}
    evaluator = None
    for name in ("EGR", "EGREvaluator"):
        cfg = {"model": name, **model_yaml(name.lower()),
               "epochs": RL_EPOCHS, "batch_size": RL_BATCH,
               "learning_rate": RL_LR, "seed": SEED, "monitor": "NDCG@10"}
        t0 = time.perf_counter()
        result, trainer = run_recorded(lambda: qs.run_rerank_experiment(
            cfg, host["train"], host["valid"], ks=(10,), device=DEVICE))
        torch.cuda.synchronize()
        losses = step_losses(trainer)
        assert np.isfinite(losses).all() \
            and losses[-8:].mean() < losses[:8].mean(), losses
        assert result["NDCG@10"] > random_order["NDCG@10"], result
        out[name] = {"run_s": time.perf_counter() - t0,
                     "steps": len(losses), "first_losses":
                     losses[:4].tolist(), "last_losses":
                     losses[-4:].tolist(), **result}
        evaluator = trainer.model.inner
    evaluator.eval()
    for p in evaluator.parameters():
        p.requires_grad_(False)

    ppo_cfg = {"model": "PPOReranker", **model_yaml("pporeranker"),
               "seed": SEED + 17}
    draws = torch.Generator(device=DEVICE).manual_seed(ppo_cfg["seed"])
    sub = {k: v[:PPO_LISTS] for k, v in train.items()}
    step_mask = torch.arange(RL_N, device=DEVICE)[None, :] \
        < sub["mask"].sum(1)[:, None]

    def timed(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def ppo_loop():
        policy = qs.build_reranker(ppo_cfg, RL_FEATS, DEVICE)
        params = list(policy.parameters())
        opt = _make_optimizer(TrainerConfig(learning_rate=PPO_LR,
                                            grad_clip_norm=0.0), params)
        rewards, rollout_ms, update_ms = [], [], []
        for _ in range(PPO_UPDATES):
            old = copy.deepcopy(policy)
            with torch.no_grad():
                (perm, logp_old, value_old), ms = timed(lambda: old.rollout(
                    sub["item_feats"], sub["mask"], draws))
                r = rl.list_reward_ndcg(perm, sub["labels"], sub["mask"])
            rollout_ms.append(ms)
            rewards.append(float(r.mean()))

            def update():
                for _ in range(PPO_INNER):
                    logp, ent, value = policy.evaluate_actions(
                        sub["item_feats"], sub["mask"], perm)
                    loss = rl.ppo_loss(logp, logp_old, r - value_old, value,
                                       r, ent_coef=0.01, entropy=ent,
                                       step_mask=step_mask)
                    opt.step(torch.autograd.grad(loss, params))
                return loss

            loss, ms = timed(update)
            assert torch.isfinite(loss), loss
            update_ms.append(ms / PPO_INNER)
        return rewards, rollout_ms, update_ms

    rewards, rollout_ms, update_ms = ppo_loop()
    assert np.mean(rewards[-2:]) > np.mean(rewards[:2]), rewards
    out["ppo"] = {"updates": PPO_UPDATES, "inner_steps": PPO_INNER,
                  "lists": PPO_LISTS, "mean_rewards": rewards,
                  "ms_a_rollout": statistics.median(rollout_ms),
                  "ms_an_update_step": statistics.median(update_ms)}

    # EGR's generator: a policy trained on the evaluator's list value
    policy = qs.build_reranker(ppo_cfg, RL_FEATS, DEVICE)
    params = list(policy.parameters())
    opt = _make_optimizer(TrainerConfig(learning_rate=PPO_LR,
                                        grad_clip_norm=0.0), params)
    values, ndcgs, gen_ms = [], [], []
    for _ in range(PPO_UPDATES):
        def step():
            perm, logp, _ = policy.rollout(sub["item_feats"], sub["mask"],
                                           draws)
            idx = perm.long()
            re_feats = torch.gather(sub["item_feats"], 1, idx[..., None]
                                    .expand(-1, -1, RL_FEATS))
            re_mask = torch.gather(sub["mask"], 1, idx)
            value = evaluator.list_value(re_feats, re_mask)
            loss = rl.reinforce_loss(logp, value, baseline=value.mean(),
                                     step_mask=step_mask)
            # the critic head takes no part in REINFORCE: zero gradients
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            opt.step([torch.zeros_like(p) if g is None else g
                      for p, g in zip(params, grads)])
            return value, rl.list_reward_ndcg(perm, sub["labels"],
                                              sub["mask"])

        (value, ndcg), ms = timed(step)
        assert torch.isfinite(value).all()
        values.append(float(value.mean()))
        ndcgs.append(float(ndcg.mean()))
        gen_ms.append(ms)
    out["egr_generator"] = {"updates": PPO_UPDATES,
                            "mean_list_value": values,
                            "mean_true_ndcg": ndcgs,
                            "ms_an_update": statistics.median(gen_ms)}
    return out, host


def host_models(host):
    """Phase 5p (5): `get_model` resolves all 125 names on the card's
    machine; LambdaMART (10 trees, depth 4) fit on the first LM_LISTS
    training lists (rows of 65 features, the list as the query) and
    scored on as many validation lists: its NDCG@10 beside the
    ranker-score column's order and a random one's (`LambdaMART.ndcg`)."""
    from recbox_tpu_torch.models.registry import MODEL_REGISTRY, get_model
    from recbox_tpu_torch.models.reranking.lambdamart import LambdaMART

    names = sorted(MODEL_REGISTRY)
    resolved = [get_model(n.upper()) for n in names]
    assert len(names) == 125 and all(c is not None for c, _ in resolved)

    def rows(lists):
        m = lists["mask"][:LM_LISTS]
        X = lists["item_feats"][:LM_LISTS][m].astype(np.float64)
        rel = lists["labels"][:LM_LISTS][m].astype(np.float64)
        qid = np.broadcast_to(np.arange(LM_LISTS)[:, None], m.shape)[m]
        return X, rel, qid

    X, rel, qid = rows(host["train"])
    Xv, relv, qidv = rows(host["valid"])
    t0 = time.perf_counter()
    lm = LambdaMART(n_trees=LM_TREES, max_depth=LM_DEPTH).fit(X, rel, qid)
    fit_s = time.perf_counter() - t0
    ndcg = lm.ndcg(Xv, relv, qidv, k=10)

    class Column:
        def __init__(self, scores):
            self.scores = scores

        def predict(self, _):
            return self.scores

    def order_ndcg(scores):
        return LambdaMART.ndcg(Column(scores), Xv, relv, qidv, k=10)

    ranker = order_ndcg(Xv[:, -1])
    rand = order_ndcg(np.random.default_rng(SEED).random(len(Xv)))
    assert np.isfinite(ndcg) and ndcg > rand, (ndcg, rand)
    return {"registry_names": len(names),
            "stages": sorted({s for _, s in resolved}),
            "lambdamart": {"trees": LM_TREES, "depth": LM_DEPTH,
                           "train_rows": int(len(X)), "fit_s": fit_s,
                           "ndcg@10": ndcg, "ranker_order_ndcg@10": ranker,
                           "random_order_ndcg@10": rand}}


# -- phase 5q: the data and features pipeline --------------------------------------

# rows in the layout of the Criteo Display Advertising Challenge's train.txt
# (a label, I1-I13 counts, C1-C26 tokens of 8 hex digits), its 45,840,617
# rows cut in depth to one epoch of 32 steps at bench.py's batch
Q_TRAIN, Q_HELD, Q_TOKENS = 1_048_576, 65_536, 400_000
Q_ROWS_PER_SHARD = 250_000
# the fields with ~10% empty tokens, the counts' missing share
Q_EMPTY_FIELDS, Q_EMPTY, Q_NAN = (2, 5, 11, 18, 24), 0.1, 0.2
# the packed AdaGrad accumulators' start. From 0 the Zipf head (~30% of a
# field's rows on its OOV row, ~10% on its top token) and every row hit
# once move by ~lr a step and the loss blows up (~1e2); from 5k's 0.1 a hot
# row's g / sqrt(0.1 + g²) is ~g / 0.3, too small to learn in 32 steps
# (CPU rehearsal at the full data, MLP (64, 32): AUC 0.522 from 0.1, 0.6103
# from 1e-3)
Q_ADAGRAD_INIT = 1e-3
# a streamed window under torch.profiler: steps 4-11 of an epoch, one
# shard boundary among them (the first falls in batch 7), as one in ~7.6
# batches of an epoch
Q_PROFILE_FROM, Q_PROFILE_STEPS = 4, 8
# the code points of the hex digits
HEX_DIGITS = np.array([ord(c) for c in "0123456789abcdef"], np.uint32)


def hex_tokens(words):
    """uint32 words as tokens of 8 hex digits (numpy 'U8', 8 code points
    a token)."""
    nib = (words[:, None] >> np.arange(28, -4, -4, dtype=np.uint32)) & 15
    return HEX_DIGITS[nib].view("U8").ravel()


def criteo_raw(seed):
    """Phase 5q's raw training and held-out rows, their columns named as
    `criteo_trainer`'s schema (c0..c25 for C1..C26, n0..n12 for I1..I13,
    click): a field's tokens drawn Zipf(1.1) over Q_TOKENS tokens of its
    own, Q_EMPTY of them empty in Q_EMPTY_FIELDS; counts log-normal and
    rounded, Q_NAN missing; click Bernoulli(sigmoid(Σ w_f[token])) over
    c0..c3, w N(0, 1) a token."""
    vocab = np.random.default_rng(seed)
    tokens = [hex_tokens(vocab.integers(0, 2 ** 32, Q_TOKENS,
                                        dtype=np.uint32))
              for _ in range(NUM_CAT)]
    w = vocab.normal(size=(4, Q_TOKENS))
    rng = np.random.default_rng(seed + 1)

    def rows(n):
        table, logit = {}, np.zeros(n)
        for f in range(NUM_CAT):
            idx = (rng.zipf(1.1, n) - 1) % Q_TOKENS
            col = tokens[f][idx]
            if f in Q_EMPTY_FIELDS:
                col[rng.random(n) < Q_EMPTY] = ""
            table[f"c{f}"] = col
            if f < 4:
                logit += w[f, idx]
        for f in range(NUM_NUM):
            v = np.round(rng.lognormal(1.0, 1.5, n))
            v[rng.random(n) < Q_NAN] = np.nan
            table[f"n{f}"] = v
        table["click"] = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(
            np.int64)
        return table

    return rows(Q_TRAIN), rows(Q_HELD)


def batches_equal(a, b):
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            for k in x) for x, y in zip(a, b))


def pipeline_criteo(in_memory=None):
    """Phase 5q: raw Criteo-layout rows → `FeatureEncoder` (c0..c25 with
    ``topk_words`` VOCAB - 1, n0..n12 through log1p and StandardScaler,
    dim 64; its FeatureMap equal to `criteo_trainer`'s) → `save_shards`
    (Q_ROWS_PER_SHARD rows a shard: every shard boundary carries rows) →
    one epoch of the native `ShardLoader` and one of the numpy one at the
    same seed, bit for bit → `criteo_trainer`'s `fit` over the native
    loader (1 epoch, eager steps, B1's count reset just before and read
    just after: one launch a step), `CTREvaluator` on the held-out rows
    through an encoder reloaded from `save` / `load`; the host's ms a
    streamed step (the intervals between steps after the first), a
    batch's host-to-device copy alone, and a window of streamed steps
    under torch.profiler (device idle share) beside ``in_memory`` (5c's
    in-memory steps); B1
    against its plain version on one captured step of this path. The
    library builds strictly and every encode and read takes the native
    route: nothing falls back. ``stage_s``: the seconds of each stage."""
    import tempfile
    from recbox_tpu_torch.data import MASK_KEY, ShardLoader, save_shards
    from recbox_tpu_torch.data import native_shards
    from recbox_tpu_torch.evaluation import CTREvaluator
    from recbox_tpu_torch.features import FeatureEncoder
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.retrieval import native
    from recbox_tpu_torch.utils.introspection import (
        get_device_memory, get_environment,
    )

    stage_s, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        stage_s[name] = now - mark[0]
        mark[0] = now

    native.load_native(strict=True)
    build = {k: native.build_info[k] for k in ("path", "built", "seconds")}
    assert os.path.dirname(build["path"]) == str(native.BUILD_DIR) \
        and native.native_available(), build
    lap("native_library")
    train_raw, held_raw = criteo_raw(SEED + 131)
    lap("raw_rows")
    cols = [{"name": f"c{i}", "type": "categorical",
             "topk_words": VOCAB - 1, "embedding_dim": DIM}
            for i in range(NUM_CAT)]
    # counts through log(1 + x) before the scaler, as DLRM's Criteo
    # preprocessing takes them (the raw tails put values ~100 standard
    # deviations out, and the FM term's products of them blow the loss up)
    cols += [{"name": f"n{i}", "type": "numeric", "embedding_dim": DIM,
              "normalizer": "StandardScaler", "preprocess": np.log1p}
             for i in range(NUM_NUM)]
    enc = FeatureEncoder(cols, label_cols=["click"],
                         dataset_id="criteo_bench")
    fm = enc.fit(train_raw)
    lap("encoder_fit")
    trainer = criteo_trainer(SEED, adagrad_init=Q_ADAGRAD_INIT)
    assert fm == trainer.model.feature_map, fm
    lap("trainer")
    encodes, streams = [], []
    orig_encode, orig_stream = (native.vocab_encode_native,
                                native_shards.NativeShardStream)

    def encode(*a, **kw):
        out = orig_encode(*a, **kw)
        encodes.append(out is not None)
        return out

    class Stream(orig_stream):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            streams.append(len(self._paths))

    native.vocab_encode_native = encode
    native_shards.NativeShardStream = Stream
    try:
        train = enc.transform(train_raw)
        assert encodes == [True] * NUM_CAT, encodes
        del train_raw
        lap("transform")
        with tempfile.TemporaryDirectory() as tmp:
            shard_dir = os.path.join(tmp, "shards")
            files = save_shards(shard_dir, train,
                                rows_per_shard=Q_ROWS_PER_SHARD)
            shard_bytes = sum(os.path.getsize(f) for f in files)
            del train
            lap("save_shards")
            enc.save(os.path.join(tmp, "encoder"))
            held = FeatureEncoder.load(os.path.join(tmp, "encoder")
                                       ).transform(held_raw)
            assert encodes == [True] * (NUM_CAT * 2), encodes
            lap("encoder_save_load_held_transform")
            # the two readers: one epoch each at one seed, bit for bit
            epochs = {}
            for backend in ("native", "numpy"):
                loader = ShardLoader(shard_dir, batch_size=BATCH, seed=SEED,
                                     reader_backend=backend)
                epochs[backend] = list(loader)
                lap(f"reader_epoch_{backend}")
            assert streams == [len(files)], streams
            assert len(epochs["native"]) == Q_TRAIN // BATCH \
                and batches_equal(epochs["native"], epochs["numpy"])
            probe = {k: v for k, v in epochs["native"][1].items()
                     if k != MASK_KEY}
            del epochs
            lap("readers_compared")
            # the streamed fit over the native reader
            loader = ShardLoader(shard_dir, batch_size=BATCH, seed=SEED + 1,
                                 drop_last=True, reader_backend="native")
            ctr = CTREvaluator(held, label="click",
                               metrics=["AUC", "logloss"], batch_size=BATCH)
            evals = []

            def eval_fn(tr):
                t0 = time.perf_counter()
                metrics = ctr(tr)
                evals.append({"eval_s": time.perf_counter() - t0, **metrics})
                return metrics

            trainer.eval_fn = eval_fn
            losses, starts, step = [], [], trainer.train_step

            def recorded(batch):
                starts.append(time.perf_counter())
                losses.append(step(batch))
                return losses[-1]

            trainer.train_step = recorded
            trainer.init(loader.peek_batch())
            torch.cuda.synchronize()
            packed_delta.reset_launches()
            t0 = time.perf_counter()
            trainer.fit(loader)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = packed_delta.launches["packed_adagrad_update"]
            del trainer.train_step
            steps = Q_TRAIN // BATCH
            assert trainer.step == steps and launches == steps, (
                trainer.step, launches)
            assert streams == [len(files)] * 2, streams
            losses = torch.stack(losses).float().cpu().numpy()
            assert np.isfinite(losses).all() \
                and losses[-4:].mean() < losses[:4].mean(), losses
            assert len(evals) == 1 and evals[0]["AUC"] > 0.55, (evals, losses)
            memory = get_device_memory()
            lap("fit")
            # the host's share: a batch's 40 host-to-device copies alone
            h2d = []
            for _ in range(5):
                t0 = time.perf_counter()
                trainer._device_batch(probe)
                torch.cuda.synchronize()
                h2d.append((time.perf_counter() - t0) * 1e3)

            batches = iter(loader)

            def streamed_steps(n):
                for _ in range(n):
                    batch = next(batches)
                    batch.pop(MASK_KEY)
                    trainer.train_step(batch)

            streamed_steps(Q_PROFILE_FROM)
            profile = train_breakdown(
                trainer, None, warmup=False,
                steps=lambda: streamed_steps(Q_PROFILE_STEPS))
            batches.close()
            lap("profiled_steps")
        # B1 on one captured step of this path
        rec = capture_b1_call(trainer, probe)
        b1 = b1_on_captured(rec, pad_row=0)
        del rec
        lap("b1_check_and_time")
    finally:
        native.vocab_encode_native = orig_encode
        native_shards.NativeShardStream = orig_stream
    intervals = np.diff(starts) * 1e3
    del trainer, probe
    torch.cuda.empty_cache()
    read = {k[len("reader_epoch_"):]: v for k, v in stage_s.items()
            if k.startswith("reader_epoch_")}
    return {"native_library": build, "rows": Q_TRAIN, "held_out": Q_HELD,
            "tokens_a_field": Q_TOKENS,
            "encoder_fit_rows_per_s": Q_TRAIN / stage_s["encoder_fit"],
            "transform_rows_per_s": Q_TRAIN / stage_s["transform"],
            "native_encodes": len(encodes),
            "save_rows_per_s": Q_TRAIN / stage_s["save_shards"],
            "shards": len(files), "shard_bytes": shard_bytes,
            "reader_rows_per_s": {k: Q_TRAIN / v for k, v in read.items()},
            "reader_ms_a_batch": {k: v / steps * 1e3
                                  for k, v in read.items()},
            "readers_bit_equal": True, "native_streams": len(streams),
            "fit_s": fit_s, "steps": steps, "b1_launches": launches,
            "losses": losses.tolist(), "evals": evals,
            "first_step_ms": intervals[0],
            "streamed_ms_a_step": float(intervals[1:].mean()),
            "streamed_examples_per_s": BATCH / intervals[1:].mean() * 1e3,
            "streamed_median_ms": float(np.median(intervals[1:])),
            "streamed_max_ms": float(intervals[1:].max()),
            "fit_ms_a_step_all": (fit_s - evals[0]["eval_s"]) / steps * 1e3,
            "h2d_ms_a_batch": statistics.median(h2d),
            "in_memory_5c": in_memory or {},
            "profiled_steps": [Q_PROFILE_FROM,
                               Q_PROFILE_FROM + Q_PROFILE_STEPS],
            "streamed_profile": {
                k: profile[k] for k in ("wall_ms", "device_ms", "idle_share",
                                        "groups", "by_kernel")},
            "b1_streamed_step": b1, "environment": get_environment(),
            "device_memory_after_fit": memory, "stage_s": stage_s,
            "wall_s": sum(stage_s.values())}


def mi_kernel_entry(mi, variant):
    """B3 on the multi-interest path of phase 5n: its launches there (one
    a counted query), and B3 alone at that shape."""
    c, t = mi["b3_check"][variant], mi["b3_time"][variant]
    return {"shape": {"n": t["n"], "d": t["d"], "q": t["q"], "k": t["k"]},
            "served": [m for m in ("ComiRec", "MIND")
                       if variant in mi[m]["serve"]],
            "launches": sum(q["select"] for m in ("ComiRec", "MIND")
                            if variant in mi[m]["serve"]
                            for q in mi[m]["serve"][variant][
                                "launches_a_query"]),
            "max_abs_err": c["max_abs_err"], "kernel_route": c["route"],
            "rows_same_ids": c["rows_same_ids"],
            **{key: t[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")}}


# -- phase 5r: the mesh ----------------------------------------------------------

# (b)'s global batch: 5c's width, its batch cut 4x for gloo's host staging
# (each step moves the batch's rows through the host several times)
R_GLOO_BATCH = 8192
# (b)'s sharded search (bench.py:244-248): 1M x 128, Q = 8192, k = 500, over
# integer-valued rows and queries in [-64, 64] (every dot product exact in
# f32, so the sharded and the unsharded scores are the same numbers)
R_ITEMS, R_D, R_Q, R_K, R_INT = N_ITEMS, 128, N_QUERIES, K, 64
# (a)'s eager steps and (c)'s probe: 26 fields x 32,768 ids of a
# 2,600,000-row pack
R_STEPS, R_LAT_REPS = 8, 20


def r_criteo_batches(n, seed, batch):
    """``n`` global batches of ``batch`` rows at 5c's width."""
    global BATCH
    kept, BATCH = BATCH, batch
    try:
        data = CriteoBatches(seed)
        return [data() for _ in range(n)]
    finally:
        BATCH = kept


def r_local(batch, mesh):
    """This rank's 'data' shard of a global batch."""
    from recbox_tpu_torch.parallel.mesh import DATA_AXIS, mesh_coords, \
        mesh_shape
    nd, d = mesh_shape(mesh)[DATA_AXIS], mesh_coords(mesh)[0]
    n = len(next(iter(batch.values()))) // nd
    return {k: v[d * n:(d + 1) * n] for k, v in batch.items()}


def lat_row_probe():
    """5r(c): `placement.LAT_ROW` on the card: `index_select` then
    `index_add_` of 26 x 32,768 uniform rows of a 2,600,000 x 128 f32 pack,
    by CUDA events over R_LAT_REPS pairs, divided by the rows."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 171)
    rows, n = NUM_CAT * VOCAB, NUM_CAT * BATCH
    pack = torch.randn(rows, 128, generator=gen, device=DEVICE)
    ids = torch.randint(0, rows, (n,), generator=gen, device=DEVICE)
    upd = torch.randn(n, 128, generator=gen, device=DEVICE) * 1e-3

    def pair():
        g = pack.index_select(0, ids)
        pack.index_add_(0, ids, upd)
        return g

    for _ in range(3):
        pair()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(R_LAT_REPS):
        pair()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / R_LAT_REPS
    return {"rows": n, "pack_rows": rows, "pack_width": 128,
            "gather_scatter_ms": ms, "lat_row_s": ms * 1e-3 / n}


def mesh_one_rank():
    """5r(a): a one-rank NCCL world in this process. 5c's trainer under
    `make_mesh()` and without a mesh, from one state, take the same
    R_STEPS eager steps. At n = 1 no collective is issued and the step is
    the unsharded one: the first loss and the dense parameters after the
    first step bit for bit; the packs after it within the order of B1's
    duplicate sums (1e-3 of the pack's largest update, as 5c's replayed
    step against its eager one); the later losses within 1e-3 (bf16
    compute on states B1's order has parted); B1 once a step; 0 collective
    bytes; eager ms a step of each, in turns."""
    import torch.distributed as dist
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.parallel import initialize_distributed, make_mesh
    from recbox_tpu_torch.parallel.mesh import record_collectives
    initialize_distributed()        # no torchrun variables: a world of one
    try:
        mesh = make_mesh()
        batches = r_criteo_batches(R_STEPS, SEED + 181, BATCH)
        plain = criteo_trainer(SEED)
        sharded = criteo_trainer(SEED, mesh=mesh)
        plain.init(batches[0])
        sharded.init(batches[0])
        pack0 = {k: v.clone() for k, v in plain.packs.items()}
        out = {"mesh": {"data": 1, "model": 1},
               "backend": dist.get_backend()}
        losses = {"plain": [], "sharded": []}
        times = {"plain": [], "sharded": []}
        pack_diff, dense_after_1 = [], {}
        packed_delta.reset_launches()
        with record_collectives() as ops:
            for i, b in enumerate(batches):
                order = (("plain", plain), ("sharded", sharded))
                for name, t in (order if i % 2 == 0 else order[::-1]):
                    before = packed_delta.launches["packed_adagrad_update"]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses[name].append(float(t.train_step(b)))
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
                    assert packed_delta.launches[
                        "packed_adagrad_update"] - before == 1
                    if i == 0:
                        dense_after_1[name] = {
                            k: v.detach().clone() for k, v in
                            t.params.items()}
                pack_diff.append(max(
                    (plain.packs[k] - sharded.packs[k]).abs().max().item()
                    for k in pack0))
                if i == 0:
                    upd_1 = max((plain.packs[k] - pack0[k]).abs().max()
                                .item() for k in pack0)
        b1 = packed_delta.launches["packed_adagrad_update"]
        assert b1 == 2 * R_STEPS, b1
        assert losses["plain"][0] == losses["sharded"][0], losses
        assert all(torch.equal(dense_after_1["plain"][k],
                               dense_after_1["sharded"][k])
                   for k in dense_after_1["plain"])
        assert pack_diff[0] <= 1e-3 * upd_1, (pack_diff, upd_1)
        np.testing.assert_allclose(losses["sharded"], losses["plain"],
                                   rtol=1e-3)
        collective_bytes = sum(op.bytes for op in ops)
        assert collective_bytes == 0 and not ops, ops
        out.update({
            "steps": R_STEPS, "batch": BATCH,
            "b1_launches": b1 // 2, "b1_launches_both_trainers": b1,
            "collectives": len(ops), "collective_bytes": collective_bytes,
            "losses": losses, "first_loss_bit_equal": True,
            "losses_bit_equal": losses["plain"] == losses["sharded"],
            "dense_after_first_step_bit_equal": True,
            "packs_max_abs_diff_by_step": pack_diff,
            "packs_max_update_first_step": upd_1,
            "packs_bit_equal_after_first_step": pack_diff[0] == 0.0,
            "eager_ms": {k: statistics.median(v[1:])
                         for k, v in times.items()},
            "eager_ms_all": times})
        del plain, sharded
        return out
    finally:
        dist.destroy_process_group()


def ids_equal_but_ties(s_ref, i_ref, s, i):
    """Per row: the same scores, and the same ids except among those whose
    score equals the row's last (a tie at the cut)."""
    if not torch.equal(s_ref, s):
        return False
    for r in range(s.shape[0]):
        cut = s_ref[r, -1]
        keep = s_ref[r] > cut
        if set(i_ref[r][keep].tolist()) != set(i[r][s[r] > cut].tolist()):
            return False
    return True


def gloo_pair(rank, world, rdv, device, out_dir, width=None):
    """5r(b), one rank of a two-rank gloo world whose tensors share one
    device (collectives staged through the host, `parallel.mesh`): the
    packed and the generic DeepFM trainers on a ('data') mesh of 2, 3 steps
    of one global batch each (the packed one through B1 on each rank's
    owned rows), a fourth under the collective recorder, and the generic
    one again with a planted fault (rank 1 skips its owned update on the
    last step), which the comparison must catch; the sharded search
    on a ('model') mesh of 2, merged by B5. Rank 0 also runs the unsharded
    trainers and the unsharded exact search from the same state and
    writes the comparison. ``width`` overrides the module's widths (the
    CPU rehearsal)."""
    import torch.distributed as dist
    global DEVICE
    DEVICE = device
    globals().update(width or {})
    torch.backends.cuda.matmul.allow_tf32 = False
    from recbox_tpu_torch.ops import bitonic_topk, packed_delta
    from recbox_tpu_torch.parallel import make_mesh
    from recbox_tpu_torch.parallel.inspect import collective_stats
    from recbox_tpu_torch.parallel.mesh import export_state
    from recbox_tpu_torch.parallel.placement import predict_step_comm_bytes
    from recbox_tpu_torch.retrieval import BruteForceMIPS
    from recbox_tpu_torch.training import Trainer
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    out = {}
    try:
        t_start = time.perf_counter()
        mesh = make_mesh(1, device=device)              # ('data') of 2
        batches = r_criteo_batches(4, SEED + 191, R_GLOO_BATCH)
        mine = [r_local(b, mesh) for b in batches]
        refs = {}
        for kind, cls, kw in (
                ("packed", None, {"adagrad_init": PACKED_ADAGRAD_INIT}),
                ("generic", Trainer, {}), ("generic_fault", Trainer, {})):
            packed_delta.reset_launches()
            t = criteo_trainer(SEED, compute_dtype="float32",
                               trainer_cls=cls, mesh=mesh, **kw)
            t.init(mine[0])
            t0 = time.perf_counter()
            losses = []
            for j, b in enumerate(mine[:3]):
                # the planted fault: rank 1 skips its owned update (its
                # row shards' Adam step) on the last step
                keep = {n: p.detach().clone() for n, p in t.params.items()
                        if t._sharded(n)} \
                    if kind == "generic_fault" and rank == 1 and j == 2 \
                    else {}
                losses.append(float(t.train_step(b)))
                with torch.no_grad():
                    for n, v in keep.items():
                        t.params[n].copy_(v)
            wall = time.perf_counter() - t0
            # the whole tables (a gather: every rank calls it), without
            # the optimizer state that `state_dict` would gather too
            whole = {k: v.detach().clone() for k, v in (
                t.tables.items() if kind == "packed" else
                export_state(t.params, t._row_shards()).items())}
            out[kind] = {"losses": losses, "wall_s_3_steps": wall}
            if kind != "generic_fault":
                ops = collective_stats(t.train_step, mine[3])
                counted = sum(op.bytes for op in ops)
                dense = sum(p.numel() for n, p in
                            t.model.named_parameters()
                            if ".tables." not in n)
                if kind == "packed":
                    tables = [(sh.rows, t._value_width[pn], True,
                               R_GLOO_BATCH * NUM_CAT)
                              for pn, sh in t._pack_shards.items()]
                else:
                    tables = [(VOCAB, DIM, True), (VOCAB, 1, True)] * NUM_CAT
                pred = predict_step_comm_bytes(tables, R_GLOO_BATCH, world,
                                               1, dense)["total"]
                out[kind].update({
                    "b1_launches": packed_delta.launches[
                        "packed_adagrad_update"],
                    "collectives": len(ops), "counted_bytes": counted,
                    "predicted_bytes": pred, "bytes_ratio": counted / pred})
            del t
            if rank == 0:
                if cls not in refs:
                    ref = criteo_trainer(SEED, compute_dtype="float32",
                                         trainer_cls=cls, **kw)
                    ref.init(batches[0])
                    refs[cls] = (
                        [float(ref.train_step(b)) for b in batches[:3]],
                        {k: v.detach() for k, v in (
                            ref.tables.items() if kind == "packed"
                            else ref.params.items())})
                    del ref
                ref_losses, ref_whole = refs[cls]
                err = max((whole[k] - ref_whole[k]).abs().max().item()
                          for k in ref_whole)
                # the worst entry's excess over atol + rtol·|ref| (<= 0:
                # every entry within the tolerance)
                excess = max(((whole[k] - ref_whole[k]).abs() - R_ATOL
                              - R_RTOL * ref_whole[k].abs()).max().item()
                             for k in ref_whole)
                out[kind].update({
                    "by_table_kind": r_table_errors(whole, ref_whole),
                    "ref_losses": ref_losses,
                    "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                            zip(losses, ref_losses)),
                    "max_abs_err": err, "tolerance_excess": excess})
            dist.barrier()
        # the sharded search over the 'model' axis
        search_mesh = make_mesh(2, device=device)       # ('model') of 2
        gen = torch.Generator(device=device).manual_seed(SEED + 193)
        items = torch.randint(-R_INT, R_INT + 1, (R_ITEMS, R_D),
                              generator=gen, device=device).float()
        queries = torch.randint(-R_INT, R_INT + 1, (R_Q, R_D),
                                generator=gen, device=device).float()
        index = BruteForceMIPS(items, mesh=search_mesh, method="auto",
                               bf16=False)
        bitonic_topk.reset_launches()
        t0 = time.perf_counter()
        s, i = index.search(queries, R_K)
        if device != "cpu":
            torch.cuda.synchronize()
        out["search"] = {"shard_rows": index.shard_size,
                         "wall_s": time.perf_counter() - t0,
                         "b5_launches": bitonic_topk.launches[
                             "bitonic_topk"]}
        if rank == 0:
            ref = BruteForceMIPS(items, method="exact", device=device)
            rs, ri = ref.search(queries, R_K)
            out["search"].update({
                "ids_equal_but_ties": ids_equal_but_ties(rs, ri, s, i),
                "max_abs_err": (rs - s).abs().max().item(),
                "exhausted_slots": int((i < 0).sum())})
            del ref
        del index, items, queries
        # 5v(c): past k = 8192, 2 x V_SHARD integer rows (dot products
        # exact in f32) at k = V_K: each shard's exact top V_K, B5's merge
        # of the 2 · V_K candidates in its global-memory mode
        t1 = time.perf_counter()
        items = torch.randint(-R_INT, R_INT + 1, (2 * V_SHARD, DIM),
                              generator=gen, device=device).float()
        queries = torch.randint(-R_INT, R_INT + 1, (V_SEARCH_Q, DIM),
                                generator=gen, device=device).float()
        index = BruteForceMIPS(items, mesh=search_mesh, method="auto",
                               bf16=False)
        bitonic_topk.reset_launches()
        t0 = time.perf_counter()
        s, i = index.search(queries, V_K)
        if device != "cpu":
            torch.cuda.synchronize()
        out["search_large_k"] = {
            "shard_rows": index.shard_size, "k": V_K,
            "queries": V_SEARCH_Q, "wall_s": time.perf_counter() - t0,
            "b5_launches": bitonic_topk.launches["bitonic_topk"],
            "b5_global_memory_launches": bitonic_topk.large_launches[
                "bitonic_topk"]}
        if rank == 0:
            ref = BruteForceMIPS(items, method="exact", device=device)
            rs, ri = ref.search(queries, V_K)
            out["search_large_k"].update({
                "ids_equal_but_ties": ids_equal_but_ties(rs, ri, s, i),
                "max_abs_err": (rs - s).abs().max().item(),
                "exhausted_slots": int((i < 0).sum())})
            del ref
        out["search_large_k"]["phase_s"] = time.perf_counter() - t1
        del index, items, queries
        out["wall_s"] = time.perf_counter() - t_start
        with open(os.path.join(out_dir, f"gloo_pair_rank{rank}.json"),
                  "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def r_table_errors(got, ref):
    """Per table kind (the 'embedding' tables, the 1-wide 'linear' ones):
    the largest difference, the entries outside rtol R_RTOL / atol R_ATOL,
    and the entries."""
    out = {}
    for k in ref:
        kind = "linear" if k.startswith("linear") else "embedding"
        d = (got[k] - ref[k].detach()).abs()
        bad = int((d > R_ATOL + R_RTOL * ref[k].detach().abs()).sum())
        o = out.setdefault(kind, {"max_abs_err": 0.0, "outside": 0,
                                  "entries": 0})
        o["max_abs_err"] = max(o["max_abs_err"], d.max().item())
        o["outside"] += bad
        o["entries"] += d.numel()
    return out


def mesh_two_ranks(device="cuda", width=None):
    """5r(b): spawn `gloo_pair` as two processes on one device; rank 0's
    comparison and each rank's launch counts."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rdv")
        t0 = time.perf_counter()
        mp.spawn(gloo_pair, args=(2, rdv, device, tmp, width), nprocs=2,
                 join=True)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"gloo_pair_rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    return {"wall_s": wall, "ranks": ranks}


# the tolerance of 5r(b)'s two-rank runs against the unsharded ones (f32
# compute, TF32 off): the loss of each step within 1e-5 relative. The
# packed pair (row-wise AdaGrad from PACKED_ADAGRAD_INIT, as 5p) holds every
# table entry within rtol 1e-4 / atol 1e-6. The generic pair's Adam divides
# each entry's gradient by its own root mean square, so an entry whose
# gradient is rounding noise (an example's p - y at the ulp of p, which a
# half-batch GEMM rounds apart from the whole batch's) moves by a share of
# the lr that the rounding decides: there at most R_ADAM_OUTSIDE of the
# entries lie outside rtol 1e-4 / atol 1e-6, a limit between the sound
# run's share and that of a planted fault ('generic_fault': rank 1 skips
# its owned update on the last step), which the phase must catch
# (PERF.md §2 gives both readings)
R_LOSS_RTOL, R_RTOL, R_ATOL, R_ADAM_OUTSIDE = 1e-5, 1e-4, 1e-6, 2e-5


def r_outside_share(k):
    by = k["by_table_kind"].values()
    return sum(o["outside"] for o in by) / sum(o["entries"] for o in by)


def check_two_ranks(res, on_card=True):
    """Rank 0's comparison holds, and catches the planted fault; the
    counted bytes equal the model within 1%; on the card each rank
    launched B1 once a step (4 steps) and B5 once (the CPU rehearsal runs
    their plain versions, which count none)."""
    r0 = res["ranks"][0]
    for kind in ("packed", "generic"):
        k = r0[kind]
        assert k["loss_max_rel_err"] <= R_LOSS_RTOL, (kind, k)
        for rk in res["ranks"]:
            assert abs(rk[kind]["bytes_ratio"] - 1) < 0.01, (kind, rk[kind])
    assert r0["packed"]["tolerance_excess"] <= 0, r0["packed"]
    assert r_outside_share(r0["generic"]) <= R_ADAM_OUTSIDE, r0["generic"]
    assert r_outside_share(r0["generic_fault"]) > R_ADAM_OUTSIDE, \
        r0["generic_fault"]
    for rk in res["ranks"]:
        assert rk["packed"]["b1_launches"] == (4 if on_card else 0), rk
        assert rk["generic"]["b1_launches"] == 0, rk["generic"]
        assert rk["search"]["b5_launches"] == (1 if on_card else 0), rk
    assert r0["search"]["ids_equal_but_ties"], r0["search"]
    assert r0["search"]["max_abs_err"] <= 1e-6, r0["search"]
    # 5v(c): the merge past k = 8192, once a rank in the global-memory mode
    big = r0["search_large_k"]
    assert big["ids_equal_but_ties"] and big["max_abs_err"] == 0.0, big
    assert big["exhausted_slots"] == 0, big
    for rk in res["ranks"]:
        n = 1 if on_card else 0
        assert (rk["search_large_k"]["b5_launches"],
                rk["search_large_k"]["b5_global_memory_launches"]) \
            == (n, n), rk["search_large_k"]
    return True


# -- phase 5t: a model's own tables row-sharded ----------------------------------
# (a) SASRec at SAS_V x SAS_L x SAS_D, SAS_B rows, through `full_scores`, on
# a one-rank NCCL mesh against the unmeshed trainer: T_STEPS steps of each,
# in turns. (b) two gloo ranks on the card, a ('data') mesh of 2, the batch
# cut to T_GLOO_BATCH rows, f32 and no dropout (the unsharded run draws
# other dropout masks); T_EVAL_USERS users' full sort over the SAS_V items
# (the table through the lookup's exchange, T_EVAL_BATCH ids a round);
# MIND over SAS_V items trained the same way and served on a ('model') mesh
# of 2 for T_MI_QUERIES users at k = T_MI_K
T_STEPS, T_GLOO_BATCH, T_EVAL_USERS, T_EVAL_K = 6, 256, 4096, 20
T_EVAL_BATCH, T_MI_NEGS, T_MI_QUERIES, T_MI_K, T_MI_INTERESTS = \
    65536, 10, 256, 100, 4


def t_held_bytes(trainer, name="emb_item"):
    """Bytes this rank holds of table ``name``: its rows and its Adam
    moments."""
    p = trainer.params[name]
    i = list(trainer.params).index(name)
    opt = sum(trainer._opt.state[slot][i].numel() * 4
              for slot in trainer._opt.slots)
    return p.numel() * p.element_size() + opt


def mesh_sasrec_one_rank():
    """5t(a): a one-rank NCCL world in this process. SASRec's table marked
    sharded on `make_mesh()` against the unmeshed trainer, from one draw,
    T_STEPS `full_scores` steps each, in turns: at n = 1 no collective is
    issued and the step is the unsharded one, the first loss and every
    parameter after the first step bit for bit (dropout draws from each
    trainer's own generator, seeded alike); ms a step of each."""
    import torch.distributed as dist
    from recbox_tpu_torch.parallel import initialize_distributed, make_mesh
    from recbox_tpu_torch.parallel.mesh import (
        SHARDED_SPEC, record_collectives,
    )
    initialize_distributed()        # no torchrun variables: a world of one
    try:
        mesh = make_mesh()
        plain, batch = sasrec_setup(SAS_V, "full_scores")
        sharded, _ = sasrec_setup(SAS_V, "full_scores", mesh=mesh)
        plain.init(batch)
        sharded.init(batch)
        assert sharded.param_specs["emb_item"] == SHARDED_SPEC
        assert tuple(sharded.params["emb_item"].shape) == (SAS_V, SAS_D)
        losses = {"plain": [], "sharded": []}
        times = {"plain": [], "sharded": []}
        after_1 = {}
        with record_collectives() as ops:
            for i in range(T_STEPS):
                order = (("plain", plain), ("sharded", sharded))
                for name, t in (order if i % 2 == 0 else order[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses[name].append(float(t.train_step(batch)))
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
                    if i == 0:
                        after_1[name] = {k: v.detach().clone()
                                         for k, v in t.params.items()}
        assert losses["plain"][0] == losses["sharded"][0], losses
        assert all(torch.equal(after_1["plain"][k], after_1["sharded"][k])
                   for k in after_1["plain"])
        assert not ops, ops
        assert all(math.isfinite(x) for v in losses.values() for x in v)
        out = {"mesh": {"data": 1, "model": 1},
               "backend": dist.get_backend(), "steps": T_STEPS,
               "vocab": SAS_V, "batch": SAS_B, "seq_len": SAS_L,
               "dim": SAS_D, "compute_dtype": "bfloat16", "dropout": 0.1,
               "collectives": len(ops), "losses": losses,
               "first_loss_bit_equal": True,
               "params_after_first_step_bit_equal": True,
               "losses_bit_equal": losses["plain"] == losses["sharded"],
               "step_ms": {k: statistics.median(v[1:])
                           for k, v in times.items()},
               "step_ms_all": times,
               "table_bytes_held": t_held_bytes(sharded)}
        del plain, sharded
        torch.cuda.empty_cache()
        return out
    finally:
        dist.destroy_process_group()


def ids_near_ties(s_ref, i_ref, s, i, tol):
    """Per row: scores within ``tol`` of the reference, and every id the
    reference ranks above its cut by more than ``tol`` present (an id may
    swap only with one whose score lies within ``tol`` of the cut)."""
    s_ref, i_ref, s, i = (torch.as_tensor(np.asarray(x)) for x in
                          (s_ref, i_ref, s, i))
    if (s_ref - s).abs().max().item() > tol:
        return False
    for r in range(s.shape[0]):
        keep = s_ref[r] > s_ref[r, -1] + tol
        if not set(i_ref[r][keep].tolist()) <= set(i[r].tolist()):
            return False
    return True


def t_batches(n, seed, rows, vocab, negs=0):
    """``n`` global batches of SASRec's (and MIND's) columns: histories
    of SAS_L items, targets and, with ``negs``, (rows, 1 + negs)
    candidates, the target first."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"item_seq": rng.integers(1, vocab, (rows, SAS_L)).astype(
                 np.int32),
             "seq_len": np.full(rows, SAS_L, np.int32),
             "item_id": rng.integers(1, vocab, rows).astype(np.int32)}
        if negs:
            cand = np.concatenate([b["item_id"][:, None], rng.integers(
                1, vocab, (rows, negs))], axis=1).astype(np.int32)
            b["__item_ids__"] = b["item::item_id"] = cand
        out.append(b)
    return out


def t_sasrec_comm_model(rows, dense, world=2, n_data=2):
    """Collective bytes of one SASRec `full_scores` step on a ('data')
    mesh, by the recorder's convention (an all-gather counts its output,
    an all-reduce its tensor): the history's lookup (ids all-gathered,
    int64; rows all-reduced over the world; their gradient all-gathered),
    the users all-gathered and their gradient all-reduced, the softmax
    (targets all-gathered, int32; each row's max, sum of exps and target
    logit all-reduced: 3 f32), the replicated parameters' 'data'
    all-reduce, the clip's and the loss's scalars. No term in V."""
    g = rows                                   # the global batch
    look = g * SAS_L * 8 + 2 * g * SAS_L * SAS_D * 4
    users = 2 * g * SAS_D * 4
    softmax = g * 4 + 3 * g * 4
    return {"lookup": look, "users": users, "softmax": softmax,
            "dense": dense * 4, "scalars": 2 * 4,
            "total": look + users + softmax + dense * 4 + 8}


def t_mind(mesh, seed=SEED):
    """MIND over SAS_V items (D = SAS_D, T_MI_INTERESTS interests, L =
    SAS_L), f32, trained on sampled candidates (softmax CE)."""
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.matching import MIND
    from recbox_tpu_torch.ops.losses import get_matching_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    fm = FeatureMap("mind5t", (FeatureSpec(
        "item_id", "categorical", source="item", vocab_size=SAS_V,
        embedding_dim=SAS_D),), corpus_index="item_id", num_items=SAS_V)
    model = MIND(fm, embedding_dim=SAS_D, interest_num=T_MI_INTERESTS,
                 max_seq_len=SAS_L,
                 generator=torch.Generator(device=DEVICE).manual_seed(seed),
                 device=DEVICE)
    match = get_matching_loss("SoftmaxCrossEntropyLoss")
    return Trainer(model, lambda o, b: match(o),
                   TrainerConfig(learning_rate=1e-3, grad_clip_norm=10.0,
                                 seed=seed), mesh=mesh, device=DEVICE)


def full_sort_ids(trainer, user_arrays, n_items, k, batch, truth=None):
    """The full sort of the users of ``user_arrays`` over ``n_items`` items
    the way the trainer's evaluator takes it (`RetrievalEvaluator.
    encode_all`: the users and the corpus through the towers in batches of
    ``batch``, under a mesh through the lookup's exchange or a propagation
    over the tables gathered whole), top ``k`` in chunks of 1024 users:
    (scores, ids, the evaluator's metrics against ``truth``, a {query:
    items} map, or None)."""
    from recbox_tpu_torch.evaluation import RetrievalEvaluator
    from recbox_tpu_torch.evaluation.retrieval import (
        evaluate_retrieval, full_sort_topk,
    )
    n = len(next(iter(user_arrays.values())))
    ev = RetrievalEvaluator(
        user_arrays, {"item_id": np.arange(n_items, dtype=np.int32)},
        np.arange(n), {}, truth or {}, batch_size=batch)
    u, items = ev.encode_all(trainer)
    # chunks of 1024 users: (1024, n_items) f32 scores at a time
    parts = [full_sort_topk(u[c:c + 1024], items, k, device=trainer.device)
             for c in range(0, len(u), 1024)]
    metrics = evaluate_retrieval(u, items, ev.train_user2items,
                                 ev.valid_user2items, ev.query_indices,
                                 ev.metrics, device=trainer.device) \
        if truth else None
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), metrics)


def t_eval_ids(trainer, users):
    """5t's full sort: SASRec's ``users`` over the SAS_V items, top
    T_EVAL_K, with the metrics of their targets."""
    return full_sort_ids(
        trainer, {"item_seq": users["item_seq"], "seq_len": users["seq_len"]},
        SAS_V, T_EVAL_K, T_EVAL_BATCH,
        {q: [int(t)] for q, t in enumerate(users["item_id"])})


def t_gloo_rank(rank, world, rdv, device, out_dir, width=None,
                graph_root=None):
    """5t(b), one rank of a two-rank gloo world on one device: SASRec
    through `full_scores` on a ('data') mesh of 2, its table's 500,000
    rows a rank, 3 steps of T_GLOO_BATCH rows and a fourth under the
    collective recorder; the full sort of T_EVAL_USERS users; MIND trained
    the same way and served through `RetrievalService.from_trainer` on a
    ('model') mesh of 2 (the merge by B5). Rank 0 also runs the unsharded
    trainers from the same draw, and the unsharded evaluation and service
    over the sharded run's weights gathered whole."""
    import torch.distributed as dist
    global DEVICE
    DEVICE = device
    globals().update(width or {})
    torch.backends.cuda.matmul.allow_tf32 = False
    from recbox_tpu_torch.ops import bitonic_topk
    from recbox_tpu_torch.parallel import make_mesh
    from recbox_tpu_torch.parallel.inspect import collective_stats
    from recbox_tpu_torch.parallel.mesh import export_state
    from recbox_tpu_torch.retrieval import RetrievalService
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    out = {}

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def whole(t):
        return {k: v.detach().clone() for k, v in
                export_state(t.params, t._row_shards()).items()}

    try:
        t_start = time.perf_counter()
        mesh = make_mesh(1, device=device)              # ('data') of 2
        batches = t_batches(4, SEED + 211, T_GLOO_BATCH, SAS_V)
        mine = [r_local(b, mesh) for b in batches]
        t, _ = sasrec_setup(SAS_V, "full_scores", mesh=mesh,
                            compute_dtype="float32", dropout=0.0, rows=8)
        t.init(mine[0])
        shard = t._row_shards()["emb_item"]
        t0 = time.perf_counter()
        losses = []
        for b in mine[:3]:
            losses.append(float(t.train_step(b)))
        sync()
        wall = time.perf_counter() - t0
        ops = collective_stats(t.train_step, mine[3])
        counted = sum(op.bytes for op in ops)
        dense = sum(p.numel() for n, p in t.params.items()
                    if not t._sharded(n))
        model = t_sasrec_comm_model(T_GLOO_BATCH, dense)
        held = t_held_bytes(t)
        out["sasrec"] = {
            "shard_rows": shard.shard_rows, "valid_rows": shard.valid,
            "losses": losses, "wall_s_3_steps": wall,
            "table_bytes_held": held, "collectives": len(ops),
            "counted_bytes": counted, "model_bytes": model,
            "bytes_ratio": counted / model["total"],
            "ops": sorted({op.line for op in ops})}
        users = t_batches(1, SEED + 213, T_EVAL_USERS, SAS_V)[0]
        t0 = time.perf_counter()
        es, ei, metrics = t_eval_ids(t, users)
        sync()
        out["sasrec"]["eval"] = {"wall_s": time.perf_counter() - t0,
                                 "metrics": metrics}
        # the four steps' weights gathered whole (every rank calls it)
        got = whole(t)
        del t
        if rank == 0:
            ref, _ = sasrec_setup(SAS_V, "full_scores",
                                  compute_dtype="float32", dropout=0.0,
                                  rows=8)
            ref.init(batches[0])
            ref_losses = [float(ref.train_step(b)) for b in batches[:3]]
            ref.train_step(batches[3])
            held_ref = t_held_bytes(ref)
            errs = r_table_errors({"emb_item": got["emb_item"]},
                                  {"emb_item": ref.params["emb_item"]})
            # the unsharded evaluation on the sharded run's weights
            with torch.no_grad():
                for k, p in ref.params.items():
                    p.copy_(got[k])
            rs, ri, rmetrics = t_eval_ids(ref, users)
            out["sasrec"].update({
                "ref_losses": ref_losses,
                "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                        zip(losses, ref_losses)),
                "table": errs["embedding"],
                "table_bytes_held_unsharded": held_ref,
                "eval_ids_equal_but_ties": ids_near_ties(
                    rs, ri, es, ei, 1e-5 * float(np.abs(rs).max())),
                "eval_ids_bit_equal": bool(np.array_equal(ri, ei)
                                           and np.array_equal(rs, es)),
                "eval_metrics_equal": rmetrics == metrics})
            del ref
        dist.barrier()
        # MIND: the same mesh, 3 steps; served on a ('model') mesh of 2
        mb = t_batches(3, SEED + 217, T_GLOO_BATCH, SAS_V, negs=T_MI_NEGS)
        mmine = [r_local(b, mesh) for b in mb]
        mt = t_mind(mesh)
        mt.init(mmine[0])
        mlosses = [float(mt.train_step(b)) for b in mmine]
        search_mesh = make_mesh(2, device=device)       # ('model') of 2
        t0 = time.perf_counter()
        svc = RetrievalService.from_trainer(
            mt, {"item_id": np.arange(SAS_V, dtype=np.int32)},
            mesh=search_mesh, method="exact", batch_size=T_EVAL_BATCH)
        sync()
        encode_s = time.perf_counter() - t0
        q = {k: users[k][:T_MI_QUERIES] for k in ("item_seq", "seq_len")}
        bitonic_topk.reset_launches()
        t0 = time.perf_counter()
        ms, mi = svc.query(q, k=T_MI_K)
        sync()
        out["mind"] = {
            "losses": mlosses, "corpus_encode_s": encode_s,
            "query_s": time.perf_counter() - t0,
            "b5_launches": bitonic_topk.launches["bitonic_topk"],
            "index_rows": int(svc.index.items.shape[0]),
            "shape": {"items": SAS_V, "queries": T_MI_QUERIES,
                      "interests": T_MI_INTERESTS, "k": T_MI_K}}
        mgot = whole(mt)
        del svc, mt
        if rank == 0:
            ref = t_mind(None)
            ref.init(mb[0])
            ref_losses = [float(ref.train_step(b)) for b in mb]
            with torch.no_grad():
                for k, p in ref.params.items():
                    p.copy_(mgot[k])
            rsvc = RetrievalService.from_trainer(
                ref, {"item_id": np.arange(SAS_V, dtype=np.int32)},
                method="exact", batch_size=T_EVAL_BATCH)
            rs, ri = rsvc.query(q, k=T_MI_K)
            out["mind"].update({
                "ref_losses": ref_losses,
                "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                        zip(mlosses, ref_losses)),
                "served_ids_equal_but_ties": ids_near_ties(
                    rs, ri, ms, mi, 1e-5 * float(np.abs(rs).max())),
                "served_max_abs_err": float(np.abs(rs - ms).max())})
            del ref, rsvc
        out["wall_s"] = time.perf_counter() - t_start
        if graph_root is not None:      # 5u, then 5v(d), in the same world
            out["graph"], sp = u_graph(rank, mesh, search_mesh, graph_root,
                                       sync, whole)
            dist.barrier()
            t0 = time.perf_counter()
            out["contrastive"] = v_contrastive(rank, mesh, sp, sync, whole)
            out["contrastive"]["wall_s"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"t_gloo_rank{rank}.json"),
                  "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def mesh_tables_two_ranks(device="cuda", width=None, graph_root=None):
    """5t(b): spawn `t_gloo_rank` as two processes on one device; each
    rank's result. With ``graph_root`` (5o's staged ml1m_kg) the same
    ranks then run 5u (`u_graph`)."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rdv")
        t0 = time.perf_counter()
        mp.spawn(t_gloo_rank, args=(2, rdv, device, tmp, width, graph_root),
                 nprocs=2, join=True)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"t_gloo_rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    return {"wall_s": wall, "ranks": ranks}


def check_mesh_tables(res, on_card=True):
    """5t(b) holds: each rank's 500,000 rows (SAS_V / 2) and the bytes
    it holds against the unsharded run's; the losses against the unsharded
    run (rtol R_LOSS_RTOL), the table at 5r(b)'s Adam rule; the counted
    bytes equal the model within 1%; the full sort's ids equal the
    unsharded evaluation's but for ties; MIND's losses and served ids
    alike; on the card B5 launched once a rank for the served query."""
    r0 = res["ranks"][0]
    s0, m0 = r0["sasrec"], r0["mind"]
    assert s0["loss_max_rel_err"] <= R_LOSS_RTOL, s0
    assert s0["table"]["outside"] <= R_ADAM_OUTSIDE \
        * s0["table"]["entries"], s0["table"]
    assert s0["eval_ids_equal_but_ties"], s0
    assert m0["loss_max_rel_err"] <= R_LOSS_RTOL, m0
    assert m0["served_ids_equal_but_ties"], m0
    for rk in res["ranks"]:
        s = rk["sasrec"]
        assert s["shard_rows"] == SAS_V // 2 == s["valid_rows"], s
        assert s["table_bytes_held"] * 2 == s0["table_bytes_held_unsharded"]
        assert abs(s["bytes_ratio"] - 1) < 0.01, s
        assert rk["mind"]["b5_launches"] == (1 if on_card else 0), rk
    return True


# -- phase 5u: the graph and knowledge models' own tables row-sharded ----------
# In 5t(b)'s spawn, on its ('data') mesh of two gloo ranks on the card, f32:
# (a) LightGCN at 5f's width (LG_USERS x LG_ITEMS over 5f's train edges,
# LG_DIM, LG_HOPS hops; batches of LG_BATCH with one uniform negative; BPR,
# Adam 1e-3): U_STEPS steps and a fourth under the collective recorder,
# the fourth again over the edge list doubled, against the unsharded
# trainer from one draw; the full sort of U_EVAL_USERS held-out users
# (`RetrievalEvaluator.encode_all`, U_EVAL_BATCH rows an encode batch);
# the model served through `from_trainer` on a ('model') mesh of 2 for
# U_SVC_USERS users at k = U_K. (b) KGAT through `run_kg_experiment` over
# 5o's staged ml1m_kg at kgat.yaml's widths: one epoch over the first
# U_KG_BATCHES batches of U_KG_BATCH train rows (the collaborative KG over
# all of them) and U_KG_STEPS KG steps, against the unsharded run. (c) KSR
# at ksr.yaml's widths over the same data: one forward of U_KSR_BATCH
# histories, each rank's rows against the unsharded model's
U_STEPS, U_EVAL_USERS, U_SVC_USERS, U_K, U_EVAL_BATCH = \
    3, 4096, 256, 20, 65536
U_KG_BATCHES, U_KG_BATCH, U_KG_STEPS, U_KSR_BATCH = 8, 2048, 8, 256
# 5u(c)'s tolerance: the user tower (the history's rows copied exactly by
# the exchange) within 1e-6; the CE over the sharded logits (each rank's
# column block in its own product) within rtol 1e-5
U_KSR_ATOL, U_KSR_CE_RTOL = 1e-6, 1e-5


def u_lightgcn_bytes(dim=None, world=2):
    """Collective bytes of one LightGCN step on a ('data') mesh of the
    world, by the recorder's convention: each table all-gathered over the
    world (the padded shards), its gradient all-reduced over 'data' (its
    rows), the loss's and the clip's f32 scalars. No term in the edges:
    2·(U + I)·D·4 + 8 where the world divides both tables."""
    dim = dim or LG_DIM
    su, si = -(-LG_USERS // world), -(-LG_ITEMS // world)
    gather = world * (su + si) * dim * 4
    reduce = (LG_USERS + LG_ITEMS) * dim * 4
    return {"gather": gather, "reduce": reduce, "scalars": 8,
            "total": gather + reduce + 8}


def u_lightgcn(rank, mesh, search_mesh, sync, whole):
    """5u(a) on one rank; rank 0 also runs the unsharded trainer, its full
    sort and its service over the sharded run's weights gathered whole."""
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.data.loader import MASK_KEY
    from recbox_tpu_torch.ops import bitonic_topk
    from recbox_tpu_torch.parallel.inspect import collective_stats
    from recbox_tpu_torch.retrieval import RetrievalService
    t0 = time.perf_counter()
    tr_u, tr_i, held, _ = lightgcn_data()
    data_s = time.perf_counter() - t0
    fm, t, _ = lightgcn_trainer(tr_u, tr_i, mesh=mesh)
    corpus = {"item_id": np.arange(LG_ITEMS, dtype=np.int32)}
    loader = MatchingLoader(fm, {"user_id": tr_u, "item_id": tr_i}, corpus,
                            batch_size=LG_BATCH, num_negs=1,
                            exclude_seen=False, seed=SEED)
    batches = []
    for b in loader:
        b.pop(MASK_KEY, None)
        batches.append(b)
        if len(batches) == U_STEPS + 1:
            break
    mine = [r_local(b, mesh) for b in batches]
    t.init(mine[0])
    shards = t._row_shards()
    sync()
    t0 = time.perf_counter()
    losses = [float(t.train_step(b)) for b in mine[:U_STEPS]]
    sync()
    wall = time.perf_counter() - t0
    ops = collective_stats(t.train_step, mine[U_STEPS])
    counted = sum(op.bytes for op in ops)
    # the same step over the edge list doubled (each edge twice)
    _, t2, _ = lightgcn_trainer(tr_u, tr_i, mesh=mesh)
    for k in ("edge_users", "edge_items", "edge_coefs"):
        setattr(t2.model, k, torch.cat([getattr(t2.model, k)] * 2))
    t2.init(mine[0])
    t2.train_step(mine[0])
    counted_2e = sum(op.bytes for op in collective_stats(
        t2.train_step, mine[U_STEPS]))
    edges = (len(t.model.edge_users), len(t2.model.edge_users))
    del t2
    users = np.array(sorted(held)[:U_EVAL_USERS], np.int32)
    sync()
    t0 = time.perf_counter()
    es, ei, _ = full_sort_ids(t, {"user_id": users}, LG_ITEMS, U_K,
                              U_EVAL_BATCH)
    sync()
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc = RetrievalService.from_trainer(t, corpus, mesh=search_mesh,
                                        method="exact",
                                        batch_size=U_EVAL_BATCH)
    sync()
    encode_s = time.perf_counter() - t0
    q = {"user_id": users[:U_SVC_USERS]}
    bitonic_topk.reset_launches()
    t0 = time.perf_counter()
    ss, si = svc.query(q, k=U_K)
    sync()
    search_shard = int(svc.index.items.shape[0])
    model_bytes = u_lightgcn_bytes()
    out = {"data_s": data_s,
           "shard_rows": {k: s.shard_rows for k, s in shards.items()},
           "valid_rows": {k: s.valid for k, s in shards.items()},
           "losses": losses, "wall_s_3_steps": wall,
           "table_bytes_held": sum(t_held_bytes(t, k) for k in shards),
           "collectives": len(ops), "counted_bytes": counted,
           "counted_bytes_2e": counted_2e, "edges": list(edges),
           "model_bytes": model_bytes,
           "bytes_ratio": counted / model_bytes["total"],
           "ops": sorted({op.line for op in ops}),
           "eval": {"users": len(users), "wall_s": eval_s},
           "service": {"corpus_encode_s": encode_s,
                       "query_s": time.perf_counter() - t0,
                       "users": U_SVC_USERS, "k": U_K,
                       "index_rows": search_shard},
           "b5_launches": bitonic_topk.launches["bitonic_topk"]}
    got = whole(t)
    del svc, t
    if rank == 0:
        _, ref, _ = lightgcn_trainer(tr_u, tr_i)
        ref.init(batches[0])
        ref_losses = [float(ref.train_step(b)) for b in batches[:U_STEPS]]
        ref.train_step(batches[U_STEPS])
        held_ref = sum(t_held_bytes(ref, k) for k in shards)
        errs = r_table_errors({k: got[k] for k in shards},
                              {k: ref.params[k] for k in shards})
        with torch.no_grad():
            for k, p in ref.params.items():
                p.copy_(got[k])
        rs, ri, _ = full_sort_ids(ref, {"user_id": users}, LG_ITEMS, U_K,
                                  U_EVAL_BATCH)
        rsvc = RetrievalService.from_trainer(ref, corpus, method="exact",
                                             batch_size=U_EVAL_BATCH)
        rss, rsi = rsvc.query(q, k=U_K)
        out.update({
            "ref_losses": ref_losses,
            "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                    zip(losses, ref_losses)),
            "table": errs["embedding"],
            "table_bytes_held_unsharded": held_ref,
            "eval_ids_equal_but_ties": ids_near_ties(
                rs, ri, es, ei, 1e-5 * float(np.abs(rs).max())),
            "eval_ids_bit_equal": bool(np.array_equal(ri, ei)
                                       and np.array_equal(rs, es)),
            "served_ids_equal_but_ties": ids_near_ties(
                rss, rsi, ss, si, 1e-5 * float(np.abs(rss).max())),
            "served_max_abs_err": float(np.abs(rss - ss).max())})
        del ref, rsvc
    return out


def u_kgat(mesh, sp, sync, whole):
    """5u(b) on one rank, then the unsharded pipeline on every rank (its
    evaluation merges the metrics of the world's processes,
    `Trainer._evaluate_and_checkpoint`, so each rank runs it). On the card
    ``index_add_`` adds with atomics in no fixed order, which parts two
    unsharded KGAT runs after 16 Adam steps by more than 5r(b)'s rule
    allows, so both runs take torch's deterministic algorithms (a fixed
    order); the two ranks' unsharded runs are compared too."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _u_kgat(mesh, sp, sync, whole)
    finally:
        torch.use_deterministic_algorithms(False)


def _u_kgat(mesh, sp, sync, whole):
    from recbox_tpu_torch import quick_start as qs
    from recbox_tpu_torch.parallel.mesh import all_gather, rank
    cfg = dict(sp["kgat"], batch_size=U_KG_BATCH,
               kg_steps_per_epoch=U_KG_STEPS)
    tr = {k: v[:U_KG_BATCHES * U_KG_BATCH] for k, v in sp["tr"].items()}
    vu = sp["vu"]

    def run(m):
        return run_recorded(lambda: qs.run_kg_experiment(
            cfg, sp["fm"], tr, sp["corpus"], sp["kg"],
            {"user_id": vu.astype(np.int32)}, vu, sp["u2i"], sp["v2i"],
            mesh=m, device=DEVICE))

    sync()
    t0 = time.perf_counter()
    res, t = run(mesh)
    sync()
    shard = t._row_shards()["emb_node"]
    out = {"wall_s": time.perf_counter() - t0, "metrics": res,
           "cf_steps": int(t.step), "kg_steps": U_KG_STEPS,
           "losses": step_losses(t).tolist(), "nodes": shard.rows,
           "shard_rows": shard.shard_rows, "valid_rows": shard.valid,
           "node_bytes_held": t_held_bytes(t, "emb_node"),
           "node_row_bytes": t.params["emb_node"].shape[1] * 4 * 3,
           "ckg_edges": len(cfg["ckg_heads"])}
    got = whole(t)
    del t
    ref_res, ref = run(None)
    ref_losses = step_losses(ref).tolist()
    node = ref.params["emb_node"].detach()
    refs = all_gather(node[None].contiguous())      # every rank's run
    out.update({
        "ref_runs_node_table": r_table_errors(
            {"emb_node": refs[1 - rank()]},
            {"emb_node": node})["embedding"],
        "ref_metrics": ref_res, "ref_losses": ref_losses,
        "loss_max_rel_err": max(abs(a - b) / abs(b) for a, b in
                                zip(out["losses"], ref_losses)),
        "node_table": r_table_errors(
            {"emb_node": got["emb_node"]},
            {"emb_node": ref.params["emb_node"]})["embedding"],
        "other_params_max_abs_err": max(
            (got[k] - p.detach()).abs().max().item()
            for k, p in ref.params.items() if k != "emb_node"),
        "metrics_max_abs_diff": max(abs(res[k] - ref_res[k])
                                    for k in ref_res),
        "node_bytes_held_unsharded": t_held_bytes(ref, "emb_node")})
    del ref
    return out


def u_ksr(mesh, sp):
    """5u(c): KSR's item and entity tables sharded over the mesh, one
    forward of this rank's rows of U_KSR_BATCH users' histories (the user
    tower,
    the full-softmax CE over the sharded logits) against the unsharded
    model built from the same seed."""
    from recbox_tpu_torch import quick_start as qs
    from recbox_tpu_torch.data.knowledge import build_neighbor_table
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.ops.losses import full_softmax_loss
    from recbox_tpu_torch.parallel.mesh import shard_params
    inter, kg = sp["inter"], sp["kg"]
    ents, _ = build_neighbor_table(kg, 4, seed=SEED)
    fm = FeatureMap("ml1m_kg", (FeatureSpec(
        "item_id", "categorical", "item", vocab_size=inter.num_items,
        embedding_dim=64),), query_index="user_id", corpus_index="item_id",
        num_items=inter.num_items)
    cfg = {**sized_yaml("KSR"), "num_users": inter.num_users,
           "num_items": inter.num_items, "n_entities": kg.n_entities,
           "n_relations": kg.n_relations, "kg_neighbors": ents,
           "seed": SEED}
    plain, _ = qs.build_model(cfg, fm, DEVICE)
    model, _ = qs.build_model(cfg, fm, DEVICE)
    shard_params(model, mesh)
    # users spread over the split's valid users (the remap numbers items
    # by first appearance, so the first users' histories hold the
    # smallest ids): the last 50 train items of each, left-padded, and
    # the first valid item as the target
    users = sp["vu"][np.linspace(0, len(sp["vu"]) - 1,
                                 U_KSR_BATCH).astype(int)]
    seq = np.zeros((U_KSR_BATCH, 50), np.int64)
    for r, u in enumerate(users.tolist()):
        h = sp["u2i"].get(u, [])[-50:]
        seq[r, 50 - len(h):] = h
    batch = r_local({
        "item_seq": torch.from_numpy(seq).to(DEVICE),
        "seq_len": torch.from_numpy((seq > 0).sum(1)).to(DEVICE),
        "item_id": torch.as_tensor([sp["v2i"][u][0] for u in users.tolist()],
                                   device=DEVICE)}, mesh)
    plain.eval()
    model.eval()
    with torch.no_grad():
        u, pu = model.user_tower(batch), plain.user_tower(batch)
        ce = float(full_softmax_loss(model.full_scores(batch),
                                     batch["item_id"]))
        pce = float(full_softmax_loss(plain.full_scores(batch),
                                      batch["item_id"]))
    seq = batch["item_seq"]
    return {"item_rows": int(model.emb_item.shape[0]),
            "entity_rows": int(model.emb_entity.shape[0]),
            "vocab": inter.num_items, "rows": int(seq.shape[0]),
            "rows_with_ids_past_half": int(
                (seq > inter.num_items // 2).any(dim=1).sum()),
            "user_max_abs_err": float((u - pu).abs().max()),
            "ce": ce, "ce_unsharded": pce,
            "ce_rel_err": abs(ce - pce) / abs(pce)}


def u_graph(rank, mesh, search_mesh, root, sync, whole):
    """5u on one rank of 5t(b)'s world: (a), (b) and (c), each timed."""
    import torch.distributed as dist
    t_start = time.perf_counter()
    out = {"lightgcn": u_lightgcn(rank, mesh, search_mesh, sync, whole)}
    out["lightgcn"]["wall_s"] = time.perf_counter() - t_start
    dist.barrier()
    t0 = time.perf_counter()
    sp = ml1m_kg_split(root)
    out["ml1m_kg_split_s"] = time.perf_counter() - t0
    out["kgat"] = u_kgat(mesh, sp, sync, whole)
    dist.barrier()
    t0 = time.perf_counter()
    out["ksr"] = u_ksr(mesh, sp)
    out["ksr"]["wall_s"] = time.perf_counter() - t0
    out["wall_s"] = time.perf_counter() - t_start
    return out, sp


def v_case(name, sp):
    """5v(d)'s ``name``: (trainer on a mesh or None, its global batch on
    the device). YoutubeSBC at its yaml's widths over 5n's 1M items and
    its batch of MI_BATCH, `sampled_softmax_inbatch_loss` with the log
    popularity of this rank's rows' items (JAX's loss function); SGL and
    NCL at their yamls' widths over 5f's graph, a batch of LG_BATCH with
    one negative, BPR plus SGL's InfoNCE sum on two fixed edge keep-masks
    or NCL's structural sum and prototype mean (its V_PROTOS prototypes
    drawn after the sharding, `NCL.prototypes`); MCCLK at its yaml's
    widths over 5u(b)'s split, a batch of KG_EAGER_BATCH, BPR plus its
    in-batch InfoNCE. Each model from one seed, f32, Adam 1e-3."""
    from recbox_tpu_torch import quick_start as qs
    from recbox_tpu_torch.data import MatchingLoader
    from recbox_tpu_torch.data.loader import MASK_KEY
    from recbox_tpu_torch.models.matching import (
        YoutubeSBC, build_norm_edges, sampled_softmax_inbatch_loss,
    )
    from recbox_tpu_torch.models.matching import graph_extended as ge
    from recbox_tpu_torch.ops.losses import get_matching_loss
    from recbox_tpu_torch.training import Trainer, TrainerConfig
    bpr = get_matching_loss("PairwiseLogisticLoss")
    cfg = TrainerConfig(learning_rate=1e-3, seed=SEED)
    g = lambda: torch.Generator(device=DEVICE).manual_seed(SEED)

    def batch_of(loader):
        b = next(iter(loader))
        b.pop(MASK_KEY, None)
        return {k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()}

    if name == "YoutubeSBC":
        train, _, _ = mi_data()
        fm = mi_feature_map()
        rows = {k: v[:MI_BATCH] for k, v in train.items()}
        batch = batch_of(MatchingLoader(fm, rows, {"item_id": np.arange(
            N_ITEMS, dtype=np.int32)}, batch_size=MI_BATCH,
            num_negs=MI_NEGS, seed=SEED, exclude_ids=(0,)))
        counts = np.bincount(train["item_id"], minlength=N_ITEMS) + 1.0
        log_q = torch.from_numpy(np.log(counts / counts.sum()).astype(
            np.float32)).to(DEVICE)
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in model_yaml("YoutubeSBC").items() if k != "model"}
        return (lambda mesh: Trainer(
            YoutubeSBC(fm, **kw, generator=g(), device=DEVICE),
            lambda o, b: sampled_softmax_inbatch_loss(
                o, log_q[b["item_id"].long()]), cfg, mesh=mesh,
            device=DEVICE, train_method="inbatch_scores")), batch
    if name in ("SGL", "NCL"):
        tr_u, tr_i, _, _ = lightgcn_data()
        eu, ei, c = build_norm_edges(tr_u, tr_i, LG_USERS, LG_ITEMS)
        fm, _, _ = lightgcn_trainer(tr_u[:1], tr_i[:1])
        batch = batch_of(MatchingLoader(
            fm, {"user_id": tr_u, "item_id": tr_i},
            {"item_id": np.arange(LG_ITEMS, dtype=np.int32)},
            batch_size=LG_BATCH, num_negs=1, exclude_seen=False,
            seed=SEED))
        kw = {k: v for k, v in model_yaml(name).items()
              if k not in ("model", "edge_users", "edge_items",
                           "edge_coefs", "num_users", "num_items")}
        rng = np.random.default_rng(SEED + 223)
        masks = [torch.from_numpy(rng.random(len(eu)) > kw.get(
            "drop_ratio", 0.0)).to(DEVICE) for _ in range(2)]

        def make(mesh):
            model = getattr(ge, name)(
                fm, num_users=LG_USERS, num_items=LG_ITEMS, edge_users=eu,
                edge_items=ei, edge_coefs=c, **kw, generator=g(),
                device=DEVICE)
            if name == "SGL":
                loss = lambda o, b: bpr(o) + model.ssl_loss(b, masks)
            else:
                loss = lambda o, b: bpr(o) + model.structural_loss(b) \
                    + model.prototype_loss(b, *model.v_protos)
            return Trainer(model, loss, cfg, mesh=mesh, device=DEVICE)
        return make, batch
    graph = dict(inter_users=sp["tr"]["user_id"],
                 inter_items=sp["tr"]["item_id"], kg_heads=sp["kg"].heads,
                 kg_relations=sp["kg"].relations, kg_tails=sp["kg"].tails)
    mcfg = {**sized_yaml("MCCLK"), "num_users": sp["inter"].num_users,
            "num_items": sp["inter"].num_items,
            "n_entities": sp["kg"].n_entities,
            "n_relations": sp["kg"].n_relations, **graph, "seed": SEED}
    batch = batch_of(MatchingLoader(sp["fm"], sp["tr"], sp["corpus"],
                                    batch_size=KG_EAGER_BATCH, num_negs=1,
                                    seed=SEED, exclude_ids=(0,)))

    def make_mcclk(mesh):
        model, _ = qs.build_model(mcfg, sp["fm"], DEVICE)
        return Trainer(model, lambda o, b: bpr(o) + model.contrastive_loss(
            b), cfg, mesh=mesh, device=DEVICE)
    return make_mcclk, batch


V_CASES = ("YoutubeSBC", "SGL", "NCL", "MCCLK")


def v_grads(t, b):
    """The gradient of the mesh step's objective on batch ``b``, as
    `Trainer._train_step` takes it before its optimizer (the replicated
    parameters' summed over 'data', the row shards' gathered whole: a
    collective), and the loss it reports."""
    from recbox_tpu_torch.parallel.mesh import export_state
    t.model.train()
    obj, rep = t._mesh_loss(t.loss_fn(t._step_forward(b), b))
    names, params = list(t.params), list(t.params.values())
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params, torch.autograd.grad(obj, params, allow_unused=True))]
    if t.mesh is not None:
        t._reduce_dense_grads(grads)
    return float(rep), {k: g.detach().clone() for k, g in export_state(
        dict(zip(names, grads)), t._row_shards()).items()}


def v_contrastive(rank, mesh, sp, sync, whole):
    """5v(d) on one rank of 5t(b)'s ('data') mesh of 2, each case from one
    draw on this rank's rows: the gradient of the step's objective
    (`v_grads`), then one step; rank 0 also takes both on the global batch
    without a mesh and compares the losses (5r(b)'s rtol) and the
    gradients (the CPU tests' rule: each entry within rtol R_RTOL, or
    R_RTOL of the largest entry; Adam's first step, lr · sign(g), would
    not see a term's weight). Under torch's deterministic algorithms, as
    5u(b): the propagations' `index_add_` then sums in a fixed order."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        for name in V_CASES:
            t0 = time.perf_counter()
            make, batch = v_case(name, sp)
            mine = r_local(batch, mesh)
            t = make(mesh)
            t.init(mine)
            if name == "NCL":           # every rank calls it (a gather)
                t.model.v_protos = t.model.prototypes(
                    V_PROTOS, n_iters=V_PROTO_ITERS, seed=SEED)
            grad_loss, grads = v_grads(t, mine)
            sync()
            t1 = time.perf_counter()
            loss = float(t.train_step(mine))
            sync()
            res = {"rows": int(len(next(iter(mine.values())))),
                   "global_rows": int(len(next(iter(batch.values())))),
                   "loss": loss, "step_s": time.perf_counter() - t1}
            del t
            if rank == 0:
                ref = make(None)
                ref.init(batch)
                if name == "NCL":
                    ref.model.v_protos = ref.model.prototypes(
                        V_PROTOS, n_iters=V_PROTO_ITERS, seed=SEED)
                ref_grad_loss, ref_grads = v_grads(ref, batch)
                ref_loss = float(ref.train_step(batch))
                top = max(g.abs().max().item() for g in ref_grads.values())
                res.update({
                    "ref_loss": ref_loss,
                    "loss_rel_err": max(
                        abs(loss - ref_loss) / abs(ref_loss),
                        abs(grad_loss - ref_grad_loss) / abs(ref_grad_loss)),
                    "grad_max_abs": top,
                    "grad_max_abs_err": max(
                        (grads[k] - g).abs().max().item()
                        for k, g in ref_grads.items()),
                    # the worst entry's excess over rtol·|ref| + rtol·top
                    "grad_tolerance_excess": max(
                        ((grads[k] - g).abs() - R_RTOL * g.abs()
                         - R_RTOL * top).max().item()
                        for k, g in ref_grads.items())})
                del ref
            res["wall_s"] = time.perf_counter() - t0
            out[name] = res
            if DEVICE != "cpu":
                torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def check_contrastive(res):
    """5v(d) holds: each case's loss (of the gradient's forward and of the
    step) within R_LOSS_RTOL of the unsharded one's, its gradient within
    the CPU tests' rule of the unsharded gradient on the global batch
    (each entry within rtol R_RTOL, or R_RTOL of the largest entry), a
    gradient that is not zero; each rank held half the global batch."""
    r0 = res["ranks"][0]["contrastive"]
    for name in V_CASES:
        c = r0[name]
        assert c["loss_rel_err"] <= R_LOSS_RTOL, (name, c)
        assert c["grad_tolerance_excess"] <= 0 < c["grad_max_abs"], (name, c)
        for rk in res["ranks"]:
            assert 2 * rk["contrastive"][name]["rows"] == c["global_rows"]
    return True


def check_mesh_graph(res, on_card=True):
    """5u holds: (a) each rank's (U / 2 + I / 2) rows and the bytes it
    holds of the tables and their Adam moments, half the unsharded run's;
    the counted bytes of a step within 1% of `u_lightgcn_bytes` and equal
    over the edge list doubled; the losses at rtol R_LOSS_RTOL and the
    tables at 5r(b)'s Adam rule against the unsharded run; the full sort's
    and the served ids equal the unsharded ones but for ties; on the card
    B5 once a rank for the served query. (b) KGAT's node table half a
    rank, its CF losses and node table by the same rules. (c) KSR's
    tables half a rank, every history holding an id past the middle of
    the vocabulary, the user tower within U_KSR_ATOL and the CE within
    rtol U_KSR_CE_RTOL of the unsharded model's."""
    ranks = [r["graph"] for r in res["ranks"]]
    l0, k0 = ranks[0]["lightgcn"], ranks[0]["kgat"]
    assert l0["loss_max_rel_err"] <= R_LOSS_RTOL, l0
    assert l0["table"]["outside"] <= R_ADAM_OUTSIDE \
        * l0["table"]["entries"], l0["table"]
    assert l0["eval_ids_equal_but_ties"], l0
    assert l0["served_ids_equal_but_ties"], l0
    assert k0["loss_max_rel_err"] <= R_LOSS_RTOL, k0
    assert k0["node_table"]["outside"] <= R_ADAM_OUTSIDE \
        * k0["node_table"]["entries"], k0["node_table"]
    for rk in ranks:
        lg, kg, ks = rk["lightgcn"], rk["kgat"], rk["ksr"]
        assert lg["valid_rows"] == {"emb_user": LG_USERS // 2,
                                    "emb_item": LG_ITEMS // 2}, lg
        assert lg["table_bytes_held"] * 2 == l0["table_bytes_held_unsharded"]
        assert abs(lg["bytes_ratio"] - 1) < 0.01, lg
        assert lg["counted_bytes_2e"] == lg["counted_bytes"], lg
        assert lg["edges"][1] == 2 * lg["edges"][0], lg
        assert lg["b5_launches"] == (1 if on_card else 0), lg
        assert kg["shard_rows"] == -(-kg["nodes"] // 2), kg
        # half the unsharded run's, and the padding row of an odd count
        assert kg["node_bytes_held"] * 2 - k0["node_bytes_held_unsharded"] \
            == (2 * kg["shard_rows"] - kg["nodes"]) * kg["node_row_bytes"]
        assert kg["cf_steps"] == U_KG_BATCHES, kg
        assert ks["item_rows"] == -(-ks["vocab"] // 2), ks
        assert ks["rows_with_ids_past_half"] > 0, ks
        assert ks["user_max_abs_err"] <= U_KSR_ATOL, ks
        assert ks["ce_rel_err"] <= U_KSR_CE_RTOL, ks
    return True


# 5s. the public surface: the 14 examples of `recbox_tpu_torch/examples/`
# on the card; DeepFM at `tools/prof_bigvocab_packed.py:24-25`'s shape
# (26 x 1M x 64, 13 numeric, B = 8192) with direct_init; the segment-merge
# top-k at `bench.py:244-262`'s shape (1M x 128, Q = 8192, k = 500)
BV_VOCAB, BV_BATCH, BV_STEPS, BV_BATCHES = 1_000_000, 8192, 8, 4
# the pack: 26M rows x 128 f32 ([64 embedding | 1 linear | 2 AdaGrad
# accumulators | 0 pad]), 13,312,000,000 bytes
BV_PACK_BYTES = NUM_CAT * BV_VOCAB * 128 * 4
# dense tables beside it would add 26M x 65 f32 (6.76 GB); the steps' own
# memory (B1's gathered rows 109 MB, bf16 activations, dense Adam, the
# graph's pool) is well under 1 GB: the peak over the phase's start stays
# under the pack plus 2 GiB, and tables would take it past 20 GB
BV_PEAK_LIMIT = BV_PACK_BYTES + 2 * 2 ** 30
SEG_N, SEG_D, SEG_CHUNK = 1_000_000, 128, 1024
# an exact per-segment selection loses a top-500 item only where one of 8
# segments holds more than seg_k = 93 of them (62.5 expected, sd ~7.5)
SEG_RECALL_LIMIT = 0.99


def kernel_counts():
    """Every port kernel's launch count: B1, B2 each way, B3 by variant,
    B4 by route, B5, B6."""
    from recbox_tpu_torch.ops import (
        bitonic_topk, embedding_gather, fused_ce, mips_fused_topk,
        mips_topk, packed_delta,
    )
    return {**packed_delta.launches, **fused_ce.launches,
            **{f"mips_fused_topk[{k}]": v
               for k, v in mips_fused_topk.launches.items()},
            **{f"mips_topk[{k}]": v
               for k, v in mips_topk.route_launches.items()},
            **bitonic_topk.launches, **embedding_gather.launches}


def _scalars(result):
    """The numbers and strings of an example's result (one level of dicts
    deep), for the phase's line."""
    out = {}
    for key, val in result.items():
        if isinstance(val, dict):
            val = {k: v for k, v in val.items()
                   if isinstance(v, (int, float, str))}
        elif not isinstance(val, (int, float, str)):
            continue
        out[key] = val
    return out


def examples_on_card():
    """5s(a): each example's ``main()`` on the card (the script's own
    assert holds inside, or it raises), its wall seconds and the launches
    of each port kernel around the call; the examples' prints go to
    stderr. big_vocab_packed launches B1 once a step, ranking_deepfm's
    packed trainer B1, large_vocab_flash_ce B2 both ways;
    serving_retrieval's index is 'exact' (no kernel), as in JAX's
    script."""
    import contextlib
    import importlib
    from recbox_tpu_torch.examples import EXAMPLES
    out = {}
    for name in EXAMPLES:
        module = importlib.import_module(f"recbox_tpu_torch.examples.{name}")
        before = kernel_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            result = module.main()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = kernel_counts()
        out[name] = {"wall_s": wall,
                     "launches": {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]},
                     "result": _scalars(result)}
        torch.cuda.empty_cache()
    launches = {name: r["launches"] for name, r in out.items()}
    assert launches["big_vocab_packed"] == {
        "packed_adagrad_update": 8}, launches["big_vocab_packed"]
    assert launches["ranking_deepfm"].get("packed_adagrad_update", 0) > 0
    flash = launches["large_vocab_flash_ce"]
    assert flash.get("fused_ce_fwd", 0) > 0 \
        and flash.get("fused_ce_bwd", 0) > 0, flash
    assert out["serving_retrieval"]["result"]["index_method"] \
        == "exact_sort" and not launches["serving_retrieval"]
    return out


def bigvocab_batches(n, seed=SEED + 181):
    """`tools/prof_bigvocab_packed.py`'s batches, drawn on the card: ids
    uniform over each field's 1M, numeric N(0, 1), clicks a fair coin."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = []
    for _ in range(n):
        b = {f"c{i}": torch.randint(0, BV_VOCAB, (BV_BATCH,), generator=gen,
                                    device=DEVICE, dtype=torch.int32)
             for i in range(NUM_CAT)}
        b.update({f"n{i}": torch.randn(BV_BATCH, generator=gen,
                                       device=DEVICE)
                  for i in range(NUM_NUM)})
        b["click"] = (torch.rand(BV_BATCH, generator=gen, device=DEVICE)
                      < 0.5).float()
        out.append(b)
    return out


def b1_big_pack(pack, rec):
    """B1 against its plain version on one step's own operands ``rec``
    (`capture_b1_call` without the pack's copy) over a pack too large to
    hold three times: the plain version updates a copy of the touched rows
    (B1's update is row-local), the kernel the pack itself; the touched
    rows are held to the plain ones (`b1_agreement`,
    `b1_update_agreement`), the untouched ones to a copy of the pack taken
    before, bit for bit, 1M rows at a time. Then B1's times at the pack
    (`b1_times`)."""
    from recbox_tpu_torch.ops.packed_delta import (
        fused_adagrad_delta_plain, packed_adagrad_update_,
        packed_adagrad_update_plain_,
    )
    ids, G, grads, lr, kw = (rec[k] for k in ("ids", "G", "grads", "lr",
                                              "kw"))
    rows, local = torch.unique(ids.long(), return_inverse=True)
    local = local.to(ids.dtype)
    snap = pack.clone()
    pre = pack.index_select(0, rows)
    plain = pre.clone()
    packed_adagrad_update_plain_(plain, local, G, grads, lr, **kw)
    packed_adagrad_update_(pack, ids, G, grads, lr, **kw)
    torch.cuda.synchronize()
    got = pack.index_select(0, rows)
    upd = fused_adagrad_delta_plain(G, grads, lr, store_w=pack.shape[1], **kw)
    check = {**b1_agreement(got, plain, pre, local, upd),
             **b1_update_agreement(got, plain, pre, local, upd)}
    touched = torch.zeros(pack.shape[0], dtype=torch.bool, device=DEVICE)
    touched[rows] = True
    for r0 in range(0, pack.shape[0], 1 << 20):
        keep = ~touched[r0:r0 + (1 << 20)]
        assert torch.equal(pack[r0:r0 + (1 << 20)][keep],
                           snap[r0:r0 + (1 << 20)][keep]), r0
    del snap, got, plain, pre
    times = b1_times(
        lambda: packed_adagrad_update_(pack, ids, G, grads, lr, **kw),
        lambda: packed_adagrad_update_plain_(pack, ids, G, grads, lr, **kw),
        pack, ids, upd, grads, kw["dims"])
    return {"check": {**check, "untouched_rows_bit_equal": True},
            "time": {"pack": list(pack.shape), "dims": list(kw["dims"]),
                     "grads": str(grads[0].dtype), **times}}


def big_vocab_criteo():
    """5s(b): `PackedEmbeddingTrainer(direct_init=True)` over DeepFM at
    `tools/prof_bigvocab_packed.py:24-25`'s shape (26 fields x 1M ids x
    64, 13 numeric, MLP 1024-512-256, bf16, batch 8192, Adam 1e-3 with clip
    10, AdaGrad on the pack), the model built under `abstract_tables()`:
    the pack is the only copy of the tables ever made (no table parameter,
    the peak allocated over the phase's start under `BV_PEAK_LIMIT`).
    BV_STEPS eager steps, then BV_STEPS replayed (`train_steps_fused`)
    over BV_BATCHES batches in turn: finite losses, falling (the last
    round of the batches below the first, the replayed steps' mean below
    the eager ones'), B1 once a step, the peak; a replayed step
    equal to an eager one (the batch's pack rows and a dense weight, as
    5c); B1 against its plain version on a step's own operands at this
    pack, and timed. The trainer is freed before the next phase."""
    from recbox_tpu_torch.features import FeatureMap, FeatureSpec
    from recbox_tpu_torch.models.ranking.ctr import DeepFM
    from recbox_tpu_torch.nn import abstract_tables
    from recbox_tpu_torch.ops import binary_crossentropy, packed_delta
    from recbox_tpu_torch.training import TrainerConfig
    from recbox_tpu_torch.training.packed import PackedEmbeddingTrainer
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    feats = tuple(
        FeatureSpec(f"c{i}", "categorical", vocab_size=BV_VOCAB,
                    embedding_dim=DIM) for i in range(NUM_CAT)) + tuple(
        FeatureSpec(f"n{i}", "numeric", embedding_dim=DIM)
        for i in range(NUM_NUM))
    fm = FeatureMap("criteo_1m", feats, labels=("click",))
    with abstract_tables():
        model = DeepFM(fm, embedding_dim=DIM, hidden_units=HIDDEN,
                       compute_dtype="bfloat16",
                       generator=torch.Generator(
                           device=DEVICE).manual_seed(SEED),
                       device=DEVICE)
    assert all(p.is_meta for n, p in model.named_parameters()
               if ".tables." in n)
    cfg = TrainerConfig(learning_rate=1e-3, grad_clip_norm=10.0, epochs=1,
                        monitor="AUC", seed=SEED)
    trainer = PackedEmbeddingTrainer(
        model, lambda o, b: binary_crossentropy(o, b["click"]), cfg,
        direct_init=True, device=DEVICE)
    batches = bigvocab_batches(BV_BATCHES)
    t0 = time.perf_counter()
    trainer.init(batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    (pname,) = trainer.packs
    pack = trainer.packs[pname]
    assert tuple(pack.shape) == (NUM_CAT * BV_VOCAB, 128) \
        and pack.numel() * pack.element_size() == BV_PACK_BYTES, pack.shape
    assert not any(".tables." in n for n, _ in model.named_parameters())
    order = [batches[i % BV_BATCHES] for i in range(BV_STEPS)]
    packed_delta.reset_launches()
    eager, eager_ms = [], []
    for b in order:
        t0 = time.perf_counter()
        eager.append(float(trainer.train_step(b)))
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    eager_launches = packed_delta.launches["packed_adagrad_update"]
    t0 = time.perf_counter()
    replayed = trainer.train_steps_fused(stacked(order)).tolist()
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    launches = packed_delta.launches["packed_adagrad_update"]
    peak = torch.cuda.max_memory_allocated() - base
    assert eager_launches == BV_STEPS and launches == 2 * BV_STEPS, \
        (eager_launches, launches)
    losses = eager + replayed
    assert all(math.isfinite(x) for x in losses), losses
    rounds = [statistics.mean(losses[i:i + BV_BATCHES])
              for i in range(0, len(losses), BV_BATCHES)]
    assert rounds[-1] < rounds[0] \
        and statistics.mean(replayed) < statistics.mean(eager), rounds
    assert peak <= BV_PEAK_LIMIT, (peak, BV_PEAK_LIMIT)
    # the replayed step against an eager one, on the rows the batch reads
    offs = {f: b.row_offset for b in trainer._bundles[pname]
            for f in b.features}
    rows = torch.unique(torch.cat([batches[0][f].long() + off
                                   for f, off in offs.items()]))
    w_name = next(n for n in trainer.params if n.endswith("weight"))
    match = graph_step_matches_eager(
        trainer, batches[0],
        lambda: {"pack_rows": trainer.packs[pname].index_select(0, rows),
                 w_name: trainer.params[w_name]})
    rec = capture_b1_call(trainer, batches[1], keep_pack=False)
    b1 = b1_big_pack(trainer.packs[pname], rec)
    out = {"pack": list(pack.shape), "pack_bytes": BV_PACK_BYTES,
           "peak_allocated_over_start": peak, "peak_limit": BV_PEAK_LIMIT,
           "allocated_at_start": base, "init_s": init_s,
           "batch": BV_BATCH, "eager_losses": eager,
           "replayed_losses": replayed, "round_mean_losses": rounds,
           "b1_launches": launches, "eager_ms": eager_ms,
           "eager_ms_after_first": statistics.mean(eager_ms[1:]),
           "replayed_ms_a_step_with_capture": fused_s * 1e3 / BV_STEPS,
           "replay_vs_eager": match, "b1": b1}
    del trainer, model, pack, rec, batches, order
    torch.cuda.empty_cache()
    return out


def segmented_on_card():
    """5s(c): `segmented_mips_topk` at `bench.py:244-262`'s shape (1M x
    128 N(0, 1) items, 8192 queries, k = 500, 8 segments, chunks of 1024
    queries): B5's launches (two a chunk), the result against the same
    function with B5's plain version in both selections (ids equal but for
    ties at the k-th score, scores within rtol 1e-6), recall against the
    exact top-k of the same bf16-rounded product over 512 queries (at
    least `SEG_RECALL_LIMIT`); its ms, the plain version's, cuBLAS +
    `torch.topk` over each chunk's scores and the bound (the corpus and
    queries read once, the results written once; 2·Q·N·D operations at
    the bf16 peak); B5's two selections of one chunk alone (`b5_case`:
    the segments' on the streaming path, bit for bit against its plain
    version, and the merge's)."""
    from recbox_tpu_torch.ops import bitonic_topk
    from recbox_tpu_torch.retrieval import index as index_mod
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 191)
    items = torch.randn(SEG_N, SEG_D, generator=gen, device=DEVICE)
    queries = torch.randn(N_QUERIES, SEG_D, generator=gen, device=DEVICE)

    def run():
        return index_mod.segmented_mips_topk(queries, items, K,
                                             query_chunk=SEG_CHUNK)

    bitonic_topk.reset_launches()
    s, i = run()
    torch.cuda.synchronize()
    launches = bitonic_topk.launches["bitonic_topk"]
    stream = bitonic_topk.stream_launches["bitonic_topk"]
    # a chunk's per-segment selection on the streaming path, its merge in
    # one window
    assert launches == 2 * (N_QUERIES // SEG_CHUNK), launches
    assert stream == N_QUERIES // SEG_CHUNK, stream
    assert tuple(i.shape) == (N_QUERIES, K) and bool(torch.isfinite(s).all())
    real = index_mod.pallas_bitonic_topk
    index_mod.pallas_bitonic_topk = \
        lambda sc, ids=None, k=100: bitonic_topk.bitonic_topk_plain(sc, ids, k)
    try:
        ps, pi = run()
        plain_ms = cuda_ms(run, reps=3)
    finally:
        index_mod.pallas_bitonic_topk = real
    torch.testing.assert_close(s, ps, rtol=1e-6, atol=0.0)
    cut = ps[:, -1:]
    assert torch.equal(torch.where(s > cut, i, -1).sort(dim=1).values,
                       torch.where(ps > cut, pi, -1).sort(dim=1).values)
    qb = queries.to(torch.bfloat16).float()
    ib = items.to(torch.bfloat16).float()
    _, exact = torch.topk(qb[:512] @ ib.T, K, dim=1)
    hits = (i[:512, :, None].long() == exact[:, None, :]).any(-1)
    recall = float(hits.float().mean())
    assert recall >= SEG_RECALL_LIMIT, recall
    ms = cuda_ms(run, reps=3)

    def library():
        for q0 in range(0, N_QUERIES, SEG_CHUNK):
            torch.topk(qb[q0:q0 + SEG_CHUNK] @ ib.T, K, dim=1)

    library_ms = cuda_ms(library, reps=3)
    moved = (SEG_N + N_QUERIES) * SEG_D * 4 + N_QUERIES * K * 8
    by_bytes = moved / HBM_BYTES_S * 1e3
    by_ops = 2.0 * N_QUERIES * SEG_N * SEG_D / PEAK_OPS["bf16"] * 1e3
    # B5's two selections of one chunk, alone, each bit for bit against
    # its plain version (the merge over the segments' own winners)
    seg_k = K // 8 + K // 16
    seg_len = SEG_N // 8
    sc = qb[:SEG_CHUNK] @ ib.T
    rows = sc.view(SEG_CHUNK * 8, seg_len)
    cs, ci = real(rows, None, seg_k)
    merged_s = cs.view(SEG_CHUNK, -1)
    merged_i = ci.view(SEG_CHUNK, -1)
    stages = {"segments": b5_case(rows, None, seg_k),
              "merge": b5_case(merged_s, merged_i, K)}
    del sc, rows, cs, ci, merged_s, merged_i, qb, ib, items, queries
    torch.cuda.empty_cache()
    return {"n": SEG_N, "d": SEG_D, "q": N_QUERIES, "k": K,
            "query_chunk": SEG_CHUNK, "n_segments": 8, "seg_k": seg_k,
            "b5_launches": launches, "b5_stream_launches": stream,
            "recall_vs_exact_512": recall,
            "recall_limit": SEG_RECALL_LIMIT,
            "max_abs_err": float((s - ps).abs().max()),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "per 1024 queries: cuBLAS f32 scores of the "
                       "bf16-rounded operands + torch.topk(k=500)",
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "b5_one_chunk": stages}


# -- phase 5v: selection past k = 8192; the contrastive terms on the mesh ----
# (a) BruteForceMIPS 'auto' over V_N x DIM items at k = V_K for V_Q users:
# the kernel gate takes B3 (V_N · 2 · 0.05 >= V_K · 128), whose 1024-query
# plan gives V_N / 128 = 131,072 winners a query, past one 16384-key
# window at k above 8192: its stage (b) in the global-memory mode. (b) B5
# alone at (V_Q, V_C) at k = V_K and V_K_WIDE. (c) 5r(b)'s sharded search
# over 2 x V_SHARD rows at k = V_K for V_SEARCH_Q queries. (d) in 5t(b)'s
# ranks: the gradient of the step's objective and one step each of
# YoutubeSBC (5n's width), SGL and NCL (5f's; NCL's V_PROTOS prototypes,
# V_PROTO_ITERS k-means rounds) and MCCLK (5u(b)'s)
V_N, V_Q, V_K, V_K_WIDE, V_C = 16_777_216, 1024, 10_000, 65_536, 131_072
# 5v(a)'s k on the selection's streaming path (131,072 winners a query)
V_K_STREAM = 500
V_SHARD, V_SEARCH_Q, V_PROTOS, V_PROTO_ITERS = 1_000_000, 64, 16, 3
# cuBLAS + torch.topk's query chunks at V_N items (bf16 scores 2.1 GB a
# chunk of 64; int8's s32 and f32 copies 4.3 GB each a chunk of 32)
V_LIB_CHUNK = {"bf16": 64, "int8": 32}


def b5_case(scores, ids, k, cmajor=False, reps=5):
    """B5 alone through its public wrapper on (Q, C) ``scores`` / ``ids``
    (with ``cmajor`` (C, Q) ones, through `pallas_bitonic_topk_cmajor`),
    held bit for bit against its plain version (NaN bits included): the
    largest finite difference, ms beside the plain version's, `torch.topk`
    on the same scores and the bound (every score read once, the winners'
    ids read, the k pairs written)."""
    from recbox_tpu_torch.ops import bitonic_topk as bt
    if cmajor:
        def run():
            return bt.pallas_bitonic_topk_cmajor(scores, ids, k)
        view, view_ids = scores.T, None if ids is None else ids.T
    else:
        def run():
            return bt.pallas_bitonic_topk(scores, ids, k)
        view, view_ids = scores, ids
    ts, ti = run()
    if cmajor:
        ts, ti = ts.T, ti.T
    ps, pi = bt.bitonic_topk_plain(view, view_ids, k)
    torch.cuda.synchronize()
    assert torch.equal(ts.contiguous().view(torch.int32),
                       ps.view(torch.int32)) \
        and torch.equal(ti.contiguous(), pi), (tuple(view.shape), k, cmajor)
    diff = (ts - ps).abs()
    diff = diff[torch.isfinite(diff)]
    q, c = view.shape
    moved = q * c * 4 + q * k * 8 + (0 if ids is None else q * k * 4)
    del ts, ti, ps, pi
    return {"q": q, "c": c, "k": k, "layout": "cmajor" if cmajor else "rows",
            "bit_equal": True,
            "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
            "ms": cuda_ms(run, reps),
            "plain_ms": cuda_ms(lambda: bt.bitonic_topk_plain(
                view, view_ids, k), reps=3),
            "library_ms": cuda_ms(lambda: torch.topk(view, k, dim=1), reps),
            "library": "torch.topk on the (Q, C) scores",
            "bound_ms": moved / HBM_BYTES_S * 1e3, "bound_by": "bytes",
            "bytes": moved}


def b3b_case(win, q_scale, sub, k, reps=5):
    """B3's stage (b) alone on stage (a)'s (n_cand, Q) packed ``win``ners,
    held bit for bit against the plain selection of the same winners,
    decoded: the path it took, ms beside `torch.topk` over the winners and
    the bound (the winners read once, the k pairs written)."""
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops.bitonic_topk import exact_topk
    from recbox_tpu_torch.ops.mips_topk import decode_winners
    n_cand, nq = win.shape
    got_s = torch.empty((nq, k), device=win.device)
    got_i = torch.empty((nq, k), dtype=torch.int32, device=win.device)

    def run():
        return fused.select_winners(win, q_scale, got_s, got_i, k, sub)

    path = run()
    vals, pos = exact_topk(win.T, k)
    want_s, want_i = decode_winners(vals, pos, sub, q_scale)
    torch.cuda.synchronize()
    assert torch.equal(got_s.view(torch.int32), want_s.view(torch.int32)) \
        and torch.equal(got_i, want_i), ("stage (b)", n_cand, nq, k)
    del vals, pos, want_s, want_i
    return {"q": nq, "c": n_cand, "k": k, "path": path, "bit_equal": True,
            "ms": cuda_ms(run, reps),
            "library_ms": cuda_ms(lambda: torch.topk(win.T, k, dim=1), reps),
            "library": "torch.topk over stage (a)'s winners",
            "bound_ms": (n_cand * nq * 4 + nq * k * 8) / HBM_BYTES_S * 1e3,
            "bound_by": "bytes"}


def large_k_search(gen):
    """5v(a): `BruteForceMIPS` 'auto' over V_N x DIM N(0, 1) items, bf16 and
    int8, V_Q users at k = V_K (stage (b) in the global-memory mode) and at
    k = V_K_STREAM (stage (b) on the streaming path). Each variant and k:
    B3's counts reset just before and read just after one served call (one
    stage (a) and one selection, on the path asserted); the result against
    B3's plain version on the inputs the kernel saw (int8 identical; bf16
    scores within rtol 2e-5, as `check_kernel`, and ids equal but for swaps
    at the cut within that tolerance), and stage (b) alone on stage (a)'s
    winners bit for bit against the plain selection of those winners; ms
    of the search, of each stage
    alone, of `torch.topk` over stage (a)'s winners, of the plain version
    and of cuBLAS + `torch.topk`, beside the bounds."""
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops.mips_fused_topk import (
        mips_fused_topk_plain, segment_plan,
    )
    from recbox_tpu_torch.ops.mips_topk import (
        candidate_route, quantize_int8,
    )
    from recbox_tpu_torch.retrieval import BruteForceMIPS
    items = torch.randn(V_N, DIM, generator=gen, device=DEVICE)
    users = torch.randn(V_Q, DIM, generator=gen, device=DEVICE)
    out = {}
    for variant in ("bf16", "int8"):
        index = BruteForceMIPS(items, method="auto", device=DEVICE,
                               quantize="int8" if variant == "int8"
                               else None)
        c = index.q_items if variant == "int8" else index._kernel_items
        scale = index.item_scale if variant == "int8" else None
        for k, path in ((V_K, "large"), (V_K_STREAM, "stream")):
            sub, n_cand = segment_plan(c.dtype, V_N, DIM, V_Q, k,
                                       index.query_chunk)
            fused.reset_launches()
            before = b3_counts()
            s, i = index.search(users, k)
            torch.cuda.synchronize()
            route = b3_route_taken(before)
            served = {"select": fused.launches[variant],
                      "select_stream": fused.stream_launches[variant],
                      "select_global_memory_mode":
                          fused.large_launches[variant], "stage_a": route}
            assert served["select"] == 1 and served[
                "select_stream" if path == "stream"
                else "select_global_memory_mode"] == 1, served
            assert served["select_stream"] + served[
                "select_global_memory_mode"] == 1, served

            def plain(k=k, sub=sub):
                if variant == "int8":
                    q8, qs = quantize_int8(users)
                    return mips_fused_topk_plain(q8, c, k, V_N, scale, qs,
                                                 sub)
                return mips_fused_topk_plain(users.to(c.dtype), c, k, V_N,
                                             sub_rows=sub)

            ps, pi = plain()
            torch.cuda.synchronize()
            assert s.shape == (V_Q, k) and bool(torch.isfinite(s).all())
            assert bool(((i >= 0) & (i < V_N)).all())
            si = torch.sort(i.long(), 1).values
            same = (si == torch.sort(pi.long(), 1).values
                    ).all(1).float().mean().item()
            err = (s - ps).abs().max().item()
            # an id may swap only with one whose packed score lies within
            # the scores' tolerance of the k-th (another order of the
            # products moves a packed score by its rounding; with 131,072
            # winners a query, the k-th has close neighbours)
            tol = 2e-5 * float(ps.abs().max()) + 1e-6
            keep = ps > ps[:, -1:] + tol
            at = torch.searchsorted(si, pi.long()).clamp(max=k - 1)
            near_ties = bool(((si.gather(1, at) == pi.long()) | ~keep).all())
            if variant == "int8":
                assert torch.equal(i, pi) and torch.equal(s, ps), \
                    (variant, k)
            else:
                if not near_ties:
                    # which item of each missed id's 128-row segment stage
                    # (a) kept: ids of one segment whose scores lie within
                    # a packed score's unit swap with the products' order
                    n_seg = sub // 128

                    def segment(x):
                        return (x // sub) * n_seg + x % sub % n_seg

                    missed = []
                    for r, j in ((si.gather(1, at) != pi.long()) & keep
                                 ).nonzero()[:4].tolist():
                        x = int(pi[r, j])
                        missed.append({
                            "row": r, "id": x, "score": float(ps[r, j]),
                            "cut": float(ps[r, -1]), "served_of_segment": [
                                (y, float(v)) for y, v in zip(
                                    i[r].tolist(), s[r].tolist())
                                if segment(y) == segment(x)]})
                    raise AssertionError((variant, k, missed))
                torch.testing.assert_close(s, ps, rtol=2e-5, atol=1e-6)
            del s, i, ps, pi
            stage_a, stage_b, _ = b3_stages(users, c, scale, k)
            stage_a()
            # the redesigned selection alone: stage (b) on these winners
            # bit for bit against the plain selection of the same winners
            b_alone = b3b_case(stage_b.winners, quantize_int8(users)[1]
                               if variant == "int8" else None, sub, k)
            assert b_alone["path"] == path, (b_alone["path"], path)
            b_ms, b_by = bound_ms(variant, V_N, DIM, V_Q, k)
            res = {
                "n": V_N, "d": DIM, "q": V_Q, "k": k, "sub_rows": sub,
                "winners_a_query": n_cand, "route": candidate_route(
                    c.dtype, DIM, sub), "served_launches": served,
                "stage_b_path": path, "stage_b_bit_equal_on_winners": True,
                "rows_same_ids": same, "ids_equal_but_near_ties": near_ties,
                "near_tie_tolerance": tol, "max_abs_err": err,
                "tolerance": "identical ids and scores" if variant == "int8"
                else "ids equal but for swaps within the tolerance of the "
                     "k-th score, scores rtol 2e-5 atol 1e-6",
                "ms": cuda_ms(lambda k=k: index.search(users, k), reps=3),
                "stage_a_ms": cuda_ms(stage_a, reps=3),
                "stage_b_ms": b_alone["ms"],
                # stage (b) reads the winners once and writes the k pairs
                "stage_b_bound_ms": b_alone["bound_ms"],
                "stage_b_library_ms": b_alone["library_ms"],
                "stage_b_library": b_alone["library"],
                "bound_ms": b_ms, "bound_by": b_by,
                "plain_ms": cuda_ms(plain, reps=1),
                "library_ms": cuda_ms(lambda k=k: library_topk(
                    users, c, scale, k, chunk=V_LIB_CHUNK[variant]), reps=1),
                "library": f"cuBLAS scores and torch.topk, "
                           f"{V_LIB_CHUNK[variant]} queries a call"}
            out[variant if path == "large" else f"{variant}_stream"] = res
            del stage_a, stage_b
        del index, c, scale
        torch.cuda.empty_cache()
    return out


# 5v(b)'s rows that stress the selection's order: (rows, candidates) past
# one window, k on the streaming path (a candidate-major source's two
# buffers) and in the global-memory mode
V_SPECIAL = (64, 40_000)
V_SPECIAL_K = (500, 2000, 12_000)


def special_rows(kind, q, c, gen):
    """(Q, C) f32 scores of one kind: 'ascending' along the row (every key
    beats those before it: the streaming path's threshold rises at each
    tile), 'equal' (one value: position alone decides), 'neg_inf_tail'
    (the last 30% -inf, as `segmented_mips_topk` pads), 'nan' (N(0, 1)
    with 5% NaN of either sign, which order above +inf and below -inf)."""
    if kind == "ascending":
        return torch.arange(c, device=DEVICE, dtype=torch.float32).repeat(
            q, 1) + torch.arange(q, device=DEVICE)[:, None]
    if kind == "equal":
        return torch.full((q, c), 1.5, device=DEVICE)
    s = torch.randn(q, c, generator=gen, device=DEVICE)
    if kind == "neg_inf_tail":
        s[:, int(0.7 * c):] = float("-inf")
        return s
    nan = torch.rand(q, c, generator=gen, device=DEVICE) < 0.05
    sign = torch.rand(q, c, generator=gen, device=DEVICE) < 0.5
    bits = torch.where(sign, torch.tensor(-0x400000, device=DEVICE,
                                          dtype=torch.int32),
                       torch.tensor(0x7FC00000, device=DEVICE,
                                    dtype=torch.int32))
    return torch.where(nan, bits.view(torch.float32), s)


def special_rows_b5(gen):
    """5v(b): B5 on V_SPECIAL rows of each `special_rows` kind, row-major
    and candidate-major, at each k of V_SPECIAL_K (the streaming path and
    the global-memory mode, counted), bit for bit against its plain
    version (NaN bits included)."""
    from recbox_tpu_torch.ops import bitonic_topk as bt
    q, c = V_SPECIAL
    out = []
    for kind in ("ascending", "equal", "neg_inf_tail", "nan"):
        rows = special_rows(kind, q, c, gen)
        for layout in ("rows", "cmajor"):
            for k in V_SPECIAL_K:
                bt.reset_launches()
                if layout == "rows":
                    ts, ti = bt.pallas_bitonic_topk(rows, None, k)
                else:
                    ts, ti = bt.pallas_bitonic_topk_cmajor(
                        rows.T.contiguous(), torch.arange(
                            c, device=DEVICE, dtype=torch.int32)[:, None]
                        .expand(c, q).contiguous(), k)
                    ts, ti = ts.T, ti.T
                counts = (bt.launches["bitonic_topk"],
                          bt.stream_launches["bitonic_topk"],
                          bt.large_launches["bitonic_topk"])
                ps, pi = bt.bitonic_topk_plain(rows, None, k)
                torch.cuda.synchronize()
                path = "stream" if 2 * k <= 16384 else "large"
                assert counts == ((1, 1, 0) if path == "stream"
                                  else (1, 0, 1)), (kind, layout, k, counts)
                assert torch.equal(ts.contiguous().view(torch.int32),
                                   ps.view(torch.int32)) \
                    and torch.equal(ti.contiguous(), pi), (kind, layout, k)
                diff = (ts - ps).abs()
                diff = diff[torch.isfinite(diff)]
                out.append({"kind": kind, "layout": layout, "q": q, "c": c,
                            "k": k, "path": path,
                            "max_abs_err": float(diff.max())
                            if diff.numel() else 0.0,
                            "plan": list(bt.select_plan(
                                c, k, cmajor=layout == "cmajor")),
                            "bit_equal": True})
        del rows
    return out


def large_k_b5(gen):
    """5v(b): B5 alone on row-major (V_Q, V_C) bf16-rounded scores (ties)
    and distinct ids at k = V_K and V_K_WIDE: the global-memory mode once a
    call (counted), then `b5_case` (bit for bit against its plain version,
    ties by position; ms beside the plain version, `torch.topk` and the
    bound)."""
    from recbox_tpu_torch.ops import bitonic_topk as bt
    out = []
    for k in (V_K, V_K_WIDE):
        s, ids = b5_inputs(gen, V_C, V_Q, ties=True)
        sr, ir = s.T.contiguous(), ids.T.contiguous()
        del s, ids
        bt.reset_launches()
        bt.pallas_bitonic_topk(sr, ir, k)
        launches = (bt.launches["bitonic_topk"],
                    bt.large_launches["bitonic_topk"])
        assert launches == (1, 1), launches
        out.append({**b5_case(sr, ir, k),
                    "plan": list(bt.select_plan(V_C, k)),
                    "launches_global_memory_mode": launches[1]})
        del sr, ir
        torch.cuda.empty_cache()
    return out


def main() -> int:
    from recbox_tpu_torch.models.matching import YoutubeDNN
    from recbox_tpu_torch.ops import _build
    from recbox_tpu_torch.ops import mips_fused_topk as fused
    from recbox_tpu_torch.ops import packed_delta
    from recbox_tpu_torch.retrieval import RetrievalService

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions are the kernels' yardstick: full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # 2. build: the CUDA kernels (one nvcc a source) and, beside them, the
    # host library of phase 5q (g++, strict: a failed build raises)
    import threading
    from recbox_tpu_torch.retrieval import native
    host_lib = {}

    def build_host_lib():
        try:
            native.load_native(strict=True)
        except BaseException as e:
            host_lib["error"] = e

    t0 = time.perf_counter()
    host_thread = threading.Thread(target=build_host_lib)
    host_thread.start()
    seconds = _build.build()
    host_thread.join()
    if "error" in host_lib:
        raise host_lib["error"]
    emit({"phase": "build", "seconds": seconds,
          "native_library": {k: native.build_info[k] for k in (
              "path", "built", "seconds")},
          "wall_s": time.perf_counter() - t0})
    for name, log in _build.build_logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        emit({"phase": "ptxas", "kernel": name, "usage": regs})
    # the redesigned kernels spill nothing: B4's wgmma and segment-major
    # routes at D = 64 and 128 (B3's stage (a) their packed
    # instantiations), B5's selection, B3's selection with its epilogue, B2
    # both ways, B1 and B6
    redesigned = {"mips_topk": usage_of(_build.build_logs, "mips_topk",
                                        "segment_candidates_wgmma"),
                  "mips_topk_segment": usage_of(_build.build_logs,
                                                "mips_topk",
                                                "segment_major_candidates"),
                  "bitonic_topk": usage_of(_build.build_logs, "bitonic_topk",
                                           "select_topk"),
                  "mips_fused_topk": usage_of(_build.build_logs,
                                              "mips_fused_topk",
                                              "select_topk"),
                  "fused_ce": usage_of(_build.build_logs, "fused_ce",
                                       "ce_fwd")
                  + usage_of(_build.build_logs, "fused_ce", "ce_bwd"),
                  "packed_delta": usage_of(_build.build_logs, "packed_delta",
                                           "packed_adagrad_update"),
                  "embedding_gather": usage_of(_build.build_logs,
                                               "embedding_gather",
                                               "seq_pool")}
    # the selection's global-memory mode (its kernels in each library) and
    # its streaming path
    for lib in ("bitonic_topk", "mips_fused_topk"):
        redesigned[f"{lib}_global_memory"] = usage_of(
            _build.build_logs, lib, "select_large")
        redesigned[f"{lib}_stream"] = usage_of(_build.build_logs, lib,
                                               "select_stream")
    for name, usage in redesigned.items():
        emit({"phase": "ptxas_redesigned", "kernel": name, "usage": usage})
        assert usage and all(u["spill_stores"] == u["spill_loads"] == 0
                             for u in usage), (name, usage)
    # B1: bf16 / f32 gradients x reductions of 4 / 2 / 1 floats
    assert len(redesigned["packed_delta"]) == 6, redesigned["packed_delta"]
    # 3 variants x 4 plans at each depth (the depth is the last template
    # argument: ...ELi64EE / ...ELi128EE)
    for depth in (64, 128):
        found = [u for u in redesigned["mips_topk"]
                 if f"ELi{depth}EE" in u["function"]]
        assert len(found) == 12, (depth, len(found))
    # the segment-major route: bf16 and s8 at depth 64 and 128
    assert len(redesigned["mips_topk_segment"]) == 4, \
        redesigned["mips_topk_segment"]
    # B2: ce_fwd and ce_bwd at depth 64 and 128
    assert len(redesigned["fused_ce"]) == 4, redesigned["fused_ce"]
    b3_ptxas = {"stage_a": [u for u in redesigned["mips_topk"]
                            if "Lb1E" in u["function"]],
                "stage_a_segment": redesigned["mips_topk_segment"],
                "stage_b": redesigned["mips_fused_topk"]}

    # 3. kernel against plain
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = {}
    for variant in ("f32", "bf16", "int8"):
        for n, d, nq, k in [(50_000, 64, 64, 10), (N_ITEMS, DIM, N_QUERIES, K),
                            (N_ITEMS, 128, N_QUERIES, K)]:
            res = check_kernel(variant, n, d, nq, k, gen)
            emit({"phase": "kernel_vs_plain", **res})
            checks[(variant, n, d)] = res
        check_pad_convention(variant, gen)
    emit({"phase": "pad_convention", "ok": True})
    for res in check_segment_plan(gen):
        emit({"phase": "segment_plan_vs_plain", **res})
    b3_integer = check_b3_integer(gen)
    for res in b3_integer:
        emit({"phase": "b3_integer_vs_plain", **res})
    b1_checks = {}
    for ids_kind in ("uniform", "zipf"):
        b1_checks[ids_kind] = check_b1(gen, ids_kind)
        emit({"phase": "b1_vs_plain", **b1_checks[ids_kind]})
    for res in check_b1_layouts(gen):
        emit({"phase": "b1_layouts_vs_plain", **res})
    emit({"phase": "b1_check_launches",
          "launches": packed_delta.launches["packed_adagrad_update"]})
    b2_checks = check_b2(gen)
    for res in b2_checks:
        emit({"phase": "b2_vs_plain", **res})
    # 3c. the candidate kernels and the sequence pool against plain
    b4_checks = check_b4(gen)
    for res in b4_checks + check_b4_small(gen):
        emit({"phase": "b4_vs_plain", **res})
    b5_checks = check_b5(gen)
    for res in b5_checks:
        emit({"phase": "b5_vs_plain", **res})
    b6_checks = check_b6()
    for res in b6_checks:
        emit({"phase": "b6_vs_plain", **res})

    # 4. the serving path
    fm, users, corpus = youtubednn_service_inputs()
    model = YoutubeDNN(fm, embedding_dim=DIM, hidden_units=(256, 128, 64),
                       generator=torch.Generator(device="cuda").manual_seed(
                           SEED), device="cuda")
    t0 = time.perf_counter()
    svc = RetrievalService(model, corpus, method="auto")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    svc8 = RetrievalService(model, item_embs=svc.item_embs, method="auto",
                            quantize="int8")
    fused.reset_launches()
    results, stages = {}, {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        before = b3_counts()
        for _ in range(3):
            scores, ids = s.query(users, k=K)
        results[name] = (scores, ids)
        stages[name] = {key: n - before[key]
                        for key, n in b3_counts().items()}
    launches = dict(fused.launches)
    emit({"phase": "serve", "launches": launches, "stage_launches": stages,
          "corpus_encode_s": encode_s})
    assert launches["bf16"] >= 3 and launches["int8"] >= 3, launches
    # each query: stage (a) on the wgmma route and the selection, once each
    for name, counts in stages.items():
        assert counts["wgmma"] >= 3 and counts["select"] >= 3 \
            and counts["tile"] == counts["segment"] == 0, (name, counts)
    recall = {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        scores, ids = results[name]
        assert scores.shape == (N_QUERIES, K) and ids.shape == (N_QUERIES, K)
        assert np.isfinite(scores).all() and (ids >= 0).all() \
            and (ids < N_ITEMS).all()
        assert (np.diff(scores, axis=1) <= 0).all()
        recall[name] = recall_vs_bf16_oracle(s, users, ids)
    # results of successive queries are arrays of their own (each copy
    # goes to a pinned buffer made for its call)
    again = svc.query(users, k=K)
    assert not any(np.shares_memory(a, b) for a in results["bf16"]
                   for b in again)
    assert np.array_equal(again[1], results["bf16"][1])
    del again
    emit({"phase": "recall", "k": K, "queries": 512, **recall,
          "predicted": 1 - K * 128 / (2 * N_ITEMS)})
    assert recall["bf16"] >= 0.95 and recall["int8"] >= 0.90, recall
    base_ids = results["bf16"][1]
    exclude = [base_ids[r, :3].tolist() for r in range(N_QUERIES)]
    ex_s, ex_ids = svc.query(users, k=K, exclude=exclude)
    assert ex_ids.shape == (N_QUERIES, K)
    assert not any(set(exclude[r]) & set(ex_ids[r].tolist())
                   for r in range(N_QUERIES))
    assert (ex_ids[:, :K - 3] == base_ids[:, 3:K]).mean() > 0.99
    emit({"phase": "exclude", "ok": True})
    del results, base_ids, ex_s, ex_ids
    # phase 6's breakdown of one 8192-user query of each service, taken
    # here, before any other profiler session of the script (late in the
    # script the profiler has seen no device work)
    profiles = {name: breakdown(s, users)
                for name, s in (("bf16", svc), ("int8", svc8))}
    # 4a. small requests: 32 users a request, stage (a) on the segment route
    small = serve_small_batches((("bf16", svc), ("int8", svc8)), users)
    for name, res in small.items():
        emit({"phase": "serve_small_batch", "card": card, "variant": name,
              **res})

    # 4b. the candidate paths and the rest of BruteForceMIPS
    cand_launches, cand = candidate_paths(gen)
    emit({"phase": "candidate_paths", "launches": cand_launches, **cand})
    emit({"phase": "index_paths", "card": card, "k": K, "users": N_QUERIES,
          "items": N_ITEMS, **service_paths(model, svc.item_embs, users)})

    # 5. the training path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, last_batch, train = train_criteo()
    emit({"phase": "train", "card": card, "wall_s": time.perf_counter() - t0,
          **train})
    eager_c = train_breakdown(trainer, last_batch)
    emit({"phase": "train_breakdown", "card": card, **eager_c})
    del trainer, last_batch

    # 5b. the sequential training path: SASRec over 1M items through B2
    t0 = time.perf_counter()
    trainer, batch, sas = train_sasrec_1m()
    emit({"phase": "train_sasrec_1m", "card": card,
          "wall_s": time.perf_counter() - t0, **sas})
    eager_d = sasrec_breakdown(trainer, batch)
    emit({"phase": "sasrec_breakdown", "card": card, **eager_d})
    del trainer, batch
    emit({"phase": "sasrec_markov", **sasrec_markov_on_card()})
    emit({"phase": "sasrec_60k", "card": card, **sasrec_60k_comparison()})

    # 5c. DeepFM fit at the Criteo width: train_steps_fused over B1
    trainer, batch, fit_c = fit_criteo()
    emit({"phase": "fit_criteo", "card": card, **fit_c})
    graph_c = train_breakdown(trainer, batch, steps=lambda:
                              trainer.train_steps_fused(stacked([batch])))
    emit({"phase": "fit_criteo_breakdown", "card": card, **graph_c})
    del trainer, batch
    # 5d. SASRec fit at V = 1M: train_steps_fused over B2
    trainer, batch, fit_d = fit_sasrec_1m()
    emit({"phase": "fit_sasrec_1m", "card": card, **fit_d})
    graph_d = sasrec_breakdown(trainer, batch, steps=lambda:
                               trainer.train_steps_fused(stacked([batch])))
    emit({"phase": "fit_sasrec_breakdown", "card": card, **graph_d})
    del trainer, batch
    # 5e. the quality exits on the card
    exits = quality_exits_on_card()
    emit({"phase": "quality_exits", "card": card, "seeds": EXIT_SEEDS,
          **exits})
    # 5f. LightGCN from training to serving at bench.py's width, through B3
    t0 = time.perf_counter()
    lgcn = fit_lightgcn()
    emit({"phase": "fit_lightgcn", "card": card,
          "wall_s": time.perf_counter() - t0, **lgcn})
    # 5g. the matching exits on the card
    t0 = time.perf_counter()
    mexits = matching_exits_on_card()
    emit({"phase": "matching_exits", "card": card, "seeds": EXIT_SEEDS,
          "wall_s": time.perf_counter() - t0, **mexits})
    # 5h. the CTR zoo through B1 at the Criteo width
    t0 = time.perf_counter()
    zoo = zoo_criteo()
    emit({"phase": "zoo_criteo", "card": card,
          "wall_s": time.perf_counter() - t0, **zoo})
    # 5i. the cascade on the card; 5j. the sequential stage from the
    # user's first call (its step 4 reads 5i's staged files)
    import tempfile
    from recbox_tpu_torch.ops import fused_ce
    from recbox_tpu_torch.tools import quality_exit as qe
    with tempfile.TemporaryDirectory() as stage_dir:
        t0 = time.perf_counter()
        ml1m_dir = qe.gen_ml1m_scale(stage_dir)
        emit({"phase": "cascade_ml1m_scale", "card": card,
              "gen_s": time.perf_counter() - t0,
              **cascade_on_card(ml1m_dir)})
        t0 = time.perf_counter()
        trainer, _, seq_cli = bert4rec_from_cli(
            os.path.join(stage_dir, "bert4rec"))
        emit({"phase": "bert4rec_1m_run_main", "card": card, **seq_cli})
        cloze = cloze_on_card(trainer.model)
        emit({"phase": "bert4rec_cloze_b2", "card": card, **cloze})
        del trainer
        torch.cuda.empty_cache()
        fused_ce.reset_launches()
        seq_zoo = seq_zoo_on_card()
        emit({"phase": "seq_zoo", "card": card, "vocab": SEQ_ZOO_V,
              "batch": SEQ_ZOO_B, "steps": SEQ_ZOO_STEPS, "models": seq_zoo})
        emit({"phase": "run_experiment_sasrec_ml1m_scale", "card": card,
              **run_experiment_on_card(os.path.dirname(
                  os.path.normpath(ml1m_dir)))})
        emit({"phase": "seq_stage", "wall_s": time.perf_counter() - t0})

    # 5k. DIN at Taobao scale through B1; BST, DIEN, DSIN
    t0 = time.perf_counter()
    din = din_taobao()
    emit({"phase": "din_taobao", "card": card,
          "wall_s": time.perf_counter() - t0, **din})
    # 5l. the multitask models at the Criteo width, MMOE through B1
    t0 = time.perf_counter()
    mtl = multitask_criteo()
    emit({"phase": "multitask_criteo", "card": card,
          "wall_s": time.perf_counter() - t0, **mtl})
    # 5m. the ranking zoo's remainder, then S3Rec and GRU4RecF
    t0 = time.perf_counter()
    ctrx = ctr_zoo_rest()
    emit({"phase": "ctr_zoo_rest", "card": card,
          "wall_s": time.perf_counter() - t0, "batch": CTRX_BATCH,
          "models": ctrx})
    t0 = time.perf_counter()
    s3 = s3rec_beauty()
    emit({"phase": "s3rec_beauty", "card": card,
          "wall_s": time.perf_counter() - t0, **s3})
    # 5n. the matching stage's remainder: ComiRec and MIND over 1M items
    # served through B3's multi-interest route, then the kernel-free zoo
    t0 = time.perf_counter()
    mi = multi_interest_1m()
    emit({"phase": "multi_interest_1m", "card": card,
          "wall_s": time.perf_counter() - t0, **mi})
    for name, call in (("autoencoders_ml20m", autoencoders_ml20m),
                       ("graph_extended_gowalla", graph_extended_gowalla),
                       ("simplex_sbc_item2vec", simplex_sbc_item2vec)):
        t0 = time.perf_counter()
        res = call()
        emit({"phase": name, "card": card,
              "wall_s": time.perf_counter() - t0, **res})
    torch.cuda.empty_cache()
    # 5o. the knowledge stage over ml1m_scale and a synthetic KG (its
    # staged files kept for 5u)
    kg_tmp = tempfile.TemporaryDirectory()
    kg_dir = kg_tmp.name
    t0 = time.perf_counter()
    kg = knowledge_ml1m(kg_dir)
    emit({"phase": "knowledge_ml1m", "card": card,
          "wall_s": time.perf_counter() - t0, **kg})
    torch.cuda.empty_cache()
    # 5p. the packed trainer's block rows, lazy Adam and split
    # accumulators at the Criteo width; the RL rerankers; the host models
    t5p = time.perf_counter()
    t0 = time.perf_counter()
    blk = block_rows_criteo(per_feature={
        key: fit_c[key] for key in ("eager_median_ms", "fused_median_ms",
                                    "eager_examples_per_s",
                                    "fused_examples_per_s")})
    emit({"phase": "block_rows_criteo", "card": card,
          "wall_s": time.perf_counter() - t0, **blk})
    layouts = {}
    for name, call in (("lazy_adam_criteo", lazy_adam_criteo),
                       ("split_accumulators_criteo",
                        split_accumulators_criteo)):
        t0 = time.perf_counter()
        layouts[name] = call()
        emit({"phase": name, "card": card,
              "wall_s": time.perf_counter() - t0, **layouts[name]})
    t0 = time.perf_counter()
    rl_out, rl_host = rl_rerankers()
    emit({"phase": "rl_rerankers", "card": card,
          "wall_s": time.perf_counter() - t0, **rl_out})
    t0 = time.perf_counter()
    hosts = host_models(rl_host)
    emit({"phase": "host_models", "wall_s": time.perf_counter() - t0,
          **hosts})
    emit({"phase": "5p", "wall_s": time.perf_counter() - t5p})
    # 5q. the data and features pipeline: raw rows through the encoder,
    # npz shards and the native reader into phase 5's trainer
    pipe = pipeline_criteo(in_memory={
        key: fit_c[key] for key in ("eager_median_ms", "fused_median_ms",
                                    "eager_examples_per_s",
                                    "fused_examples_per_s")})
    emit({"phase": "pipeline_criteo", "card": card, **pipe})
    # 5r. the mesh: a one-rank NCCL world, a two-rank gloo world on this
    # card, and the placement planner's LAT_ROW
    t5r = time.perf_counter()
    mesh_a = mesh_one_rank()
    emit({"phase": "mesh_one_rank_nccl", "card": card,
          "eager_ms_5c_in_memory": fit_c["eager_median_ms"], **mesh_a})
    mesh_b = mesh_two_ranks()
    check_two_ranks(mesh_b)
    emit({"phase": "mesh_two_ranks_gloo", "card": card,
          "batch": R_GLOO_BATCH, "staged_through_host": True,
          "tolerance": {"loss_rtol": R_LOSS_RTOL, "rtol": R_RTOL,
                        "atol": R_ATOL,
                        "adam_outside_share": R_ADAM_OUTSIDE}, **mesh_b})
    lat = lat_row_probe()
    emit({"phase": "lat_row", "card": card, **lat})
    emit({"phase": "5r", "wall_s": time.perf_counter() - t5r})
    r_b1 = mesh_a["b1_launches"] + sum(r["packed"]["b1_launches"]
                                       for r in mesh_b["ranks"])
    r_b5 = sum(r["search"]["b5_launches"] for r in mesh_b["ranks"])
    # 5t. a model's own tables row-sharded: SASRec through full_scores on a
    # one-rank NCCL mesh against the unmeshed step, then two gloo ranks on
    # this card (SASRec, its full sort, MIND served through B5); 5u. the
    # same ranks: the graph and knowledge models' tables (LightGCN at 5f's
    # width, its full sort and service through B5; KGAT over 5o's staged
    # files; KSR's history)
    t5t = time.perf_counter()
    t0 = time.perf_counter()
    tab_a = mesh_sasrec_one_rank()
    emit({"phase": "mesh_tables_one_rank_nccl", "card": card,
          "wall_s": time.perf_counter() - t0, **tab_a})
    tab_b = mesh_tables_two_ranks(graph_root=kg_dir)
    kg_tmp.cleanup()
    check_mesh_tables(tab_b)
    check_mesh_graph(tab_b)
    check_contrastive(tab_b)
    graph = [r.pop("graph") for r in tab_b["ranks"]]
    contrastive = [r.pop("contrastive") for r in tab_b["ranks"]]
    emit({"phase": "mesh_tables_two_ranks_gloo", "card": card,
          "batch": T_GLOO_BATCH, "staged_through_host": True,
          "tolerance": {"loss_rtol": R_LOSS_RTOL, "rtol": R_RTOL,
                        "atol": R_ATOL,
                        "adam_outside_share": R_ADAM_OUTSIDE}, **tab_b})
    emit({"phase": "mesh_graph_two_ranks_gloo", "card": card,
          "staged_through_host": True,
          "tolerance": {"loss_rtol": R_LOSS_RTOL, "rtol": R_RTOL,
                        "atol": R_ATOL, "adam_outside_share": R_ADAM_OUTSIDE,
                        "ksr_atol": U_KSR_ATOL,
                        "ksr_ce_rtol": U_KSR_CE_RTOL}, "ranks": graph})
    emit({"phase": "5u", "wall_s": max(g["wall_s"] for g in graph)})
    emit({"phase": "5t", "wall_s": time.perf_counter() - t5t,
          "of_it_5u": max(g["wall_s"] for g in graph)})
    t_b5 = sum(r["mind"]["b5_launches"] for r in tab_b["ranks"])
    u_b5 = sum(g["lightgcn"]["b5_launches"] for g in graph)
    # 5s. the public surface: the examples, DeepFM at 26 x 1M x 64 with
    # direct_init, the segment-merge top-k at bench.py's shape
    t5s = time.perf_counter()
    t0 = time.perf_counter()
    ex = examples_on_card()
    emit({"phase": "examples_on_card", "card": card,
          "wall_s": time.perf_counter() - t0, "examples": ex})
    ex_launches = {}
    for r in ex.values():
        for key, n in r["launches"].items():
            ex_launches[key] = ex_launches.get(key, 0) + n
    t0 = time.perf_counter()
    bv = big_vocab_criteo()
    emit({"phase": "big_vocab_criteo", "card": card,
          "wall_s": time.perf_counter() - t0, **bv})
    t0 = time.perf_counter()
    seg = segmented_on_card()
    emit({"phase": "segmented_mips_topk", "card": card,
          "wall_s": time.perf_counter() - t0, **seg})
    emit({"phase": "5s", "wall_s": time.perf_counter() - t5s})
    # 5v. selection past one window: (a) the served search at 16.8M items
    # at k = 10,000 and 500, (b) B5 alone and on rows that stress its
    # order; (c) and (d) ran in 5r(b)'s and 5t(b)'s ranks
    t5v = time.perf_counter()
    big_search = large_k_search(gen)
    for variant, res in big_search.items():
        emit({"phase": "large_k_search", "card": card, "variant": variant,
              **res})
    big_b5 = large_k_b5(gen)
    for res in big_b5:
        emit({"phase": "large_k_b5", "card": card, **res})
    special = special_rows_b5(gen)
    emit({"phase": "selection_special_rows", "card": card,
          "cases": special})
    v_c = [r["search_large_k"] for r in mesh_b["ranks"]]
    emit({"phase": "large_k_sharded_search", "card": card,
          "staged_through_host": True, "ranks": v_c})
    emit({"phase": "mesh_contrastive_two_ranks_gloo", "card": card,
          "staged_through_host": True,
          "tolerance": {"loss_rtol": R_LOSS_RTOL, "grad_rtol": R_RTOL,
                        "grad_atol_of_largest": R_RTOL},
          "ranks": contrastive})
    v_wall = time.perf_counter() - t5v + max(
        r["phase_s"] for r in v_c) + max(c["wall_s"] for c in contrastive)
    emit({"phase": "5v", "wall_s": v_wall,
          "of_it_in_5r_and_5t": v_wall - (time.perf_counter() - t5v)})

    # 6. times
    qps = {}
    for name, s in (("bf16", svc), ("int8", svc8)):
        s.query(users, k=K)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            s.query(users, k=K)
            walls.append(time.perf_counter() - t0)
        qps[name] = N_QUERIES / statistics.median(walls)
    emit({"phase": "service_qps", "k": K, "queries": N_QUERIES,
          "items": N_ITEMS, **qps})
    for name in ("bf16", "int8"):
        emit({"phase": "breakdown", "variant": name, "card": card,
              "taken_after": "phase 4, before the other profiler sessions",
              **profiles[name]})
    b1_times = {kind: time_b1(gen, kind) for kind in ("uniform", "zipf")}
    for t in b1_times.values():
        emit({"phase": "timing", "card": card,
              "kernel": "packed_adagrad_update", **t})
    b1_time = b1_times["uniform"]
    user, table = b2_inputs(gen, SAS_B, SAS_V, SAS_D)
    b2_time = time_b2(user, table, torch.randint(
        0, SAS_V, (SAS_B,), generator=gen, device=DEVICE))
    del user, table
    emit({"phase": "timing", "card": card, "kernel": "fused_ce", **b2_time})
    timings = {}
    for variant in ("bf16", "int8", "f32"):
        for d in (DIM, 128):
            t = time_kernel(variant, N_ITEMS, d, N_QUERIES, K, gen)
            emit({"phase": "timing", "card": card, **t})
            timings[(variant, d)] = t
    sweep_times = time_segment_sweep(gen)   # the JAX plans below 1024 queries
    for t in sweep_times:
        emit({"phase": "timing", "card": card, "sweep": True, **t})
    b4_times = time_b4(gen)
    for t in b4_times.values():
        emit({"phase": "timing", "card": card, "kernel": "mips_topk", **t})
    b5_times = time_b5(gen)
    for t in b5_times:
        emit({"phase": "timing", "card": card, "kernel": "bitonic_topk", **t})
    b6_times = time_b6()
    for t in b6_times:
        emit({"phase": "timing", "card": card, "kernel": "embedding_gather",
              **t})

    kernels = []
    for variant in ("bf16", "int8"):
        t, c = timings[(variant, DIM)], checks[(variant, N_ITEMS, DIM)]
        t128 = timings[(variant, 128)]
        kernels.append({
            "name": f"mips_fused_topk[{variant}]", "route": "cuda",
            "source": "recbox_tpu_torch/csrc/mips_fused_topk.cu",
            "stage_a_source": "recbox_tpu_torch/csrc/mips_topk.cu",
            "replaces": "recbox_tpu/ops/pallas/mips_fused_topk.py:100",
            "launches": launches[variant]
            + small[variant]["launches"]["select"]
            + ex_launches.get(f"mips_fused_topk[{variant}]", 0),
            "launches_by_path": {
                "serve_4": launches[variant],
                "serve_small_batch_4a": small[variant]["launches"]["select"],
                "examples_5s": ex_launches.get(
                    f"mips_fused_topk[{variant}]", 0)},
            "stage_a_launches_by_path_and_route": {
                "serve_4": {r: stages[variant][r]
                            for r in ("wgmma", "segment", "tile")},
                "serve_small_batch_4a": {
                    r: small[variant]["launches"][r]
                    for r in ("wgmma", "segment", "tile")}},
            "max_abs_err": c["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "design": "(a) B4's packed segment-candidate kernel on its wgmma "
                      "route (TMA ring, two consumer warpgroups, the "
                      "segment fold in registers) at 911 queries or more, "
                      "on its segment-major route (TMA boxes of whole "
                      "segments through a 3-D view, queries resident as "
                      "wgmma's A, the fold a max along each query row) "
                      "below, winners candidate-major; (b) B5's radix "
                      "selection with B3's decode epilogue",
            "kernel_route": c["route"], "stage_launches": stages[variant],
            "stage_a_ms": t["stage_a_ms"], "stage_b_ms": t["stage_b_ms"],
            "tile_route_stage_a_ms": t["tile_route_stage_a_ms"],
            "earlier": "tile_route_stage_a_ms, timed in this run: stage (a) "
                       "on B4's tile route (WMMA tiles through a shared "
                       "score stage), as the first design computed it",
            "d128": {key: t128[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "stage_a_ms",
                "stage_b_ms", "tile_route_stage_a_ms")},
            "ptxas": b3_ptxas,
            "segment_sweep": [
                {key: t[key] for key in (
                    "d", "q", "route", "ms", "stage_a_ms", "stage_b_ms",
                    "tile_route_stage_a_ms", "bound_ms", "bound_by",
                    "plain_ms", "library_ms")}
                for t in sweep_times if t["variant"] == variant],
            "serve_small_batch_4a": {key: small[variant][key] for key in (
                "wall_ms_a_request", "device_ms_a_request", "idle_share",
                "recall_vs_exact_512")},
            "multi_interest": mi_kernel_entry(mi, variant),
            "variants": ["bf16", "f32", "int8"], "matches_plain": True,
            "shape": {"n": N_ITEMS, "d": DIM, "q": N_QUERIES, "k": K},
            "behind_trained_lightgcn": {
                "shape": {"n": LG_ITEMS, "d": LG_DIM, "q": N_QUERIES,
                          "k": LG_K},
                "launches_a_query": lgcn["serve"][variant][
                    "launches_a_query"],
                "max_abs_err": lgcn["b3_check"][variant]["max_abs_err"],
                "kernel_route": lgcn["b3_check"][variant]["route"],
                **{key: lgcn["b3_at_this_shape"][variant][key] for key in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "stage_a_ms", "stage_b_ms")}}})
    kernels.append({
        "name": "packed_adagrad_update", "route": "cuda",
        "source": "recbox_tpu_torch/csrc/packed_delta.cu",
        "replaces": "recbox_tpu/ops/pallas/packed_delta.py:62",
        "launches": fit_c["b1_launches"]
        + zoo["run_ranking_experiment"]["b1_launches"]
        + zoo["xdeepfm"]["b1_launches"]
        + din["run_ranking_experiment"]["b1_launches"]
        + mtl["run_ranking_experiment"]["b1_launches"]
        + blk["b1_launches"] + pipe["b1_launches"] + r_b1
        + ex_launches.get("packed_adagrad_update", 0) + bv["b1_launches"],
        "launches_by_path": {
            "examples_5s": ex_launches.get("packed_adagrad_update", 0),
            "big_vocab_5s_direct_init": bv["b1_launches"],
            "mesh_5r_one_rank_nccl_and_two_rank_gloo": r_b1,
            "deepfm_block_rows_5p_fused": blk["b1_launches"],
            "deepfm_pipeline_5q_streamed_fit": pipe["b1_launches"],
            "fit_fused_graph": fit_c["b1_launches"],
            "train_step_eager": train["launches"],
            "zoo_dcnv2_run_ranking_experiment":
                zoo["run_ranking_experiment"]["b1_launches"],
            "zoo_xdeepfm_fused": zoo["xdeepfm"]["b1_launches"],
            "din_5k_run_ranking_experiment":
                din["run_ranking_experiment"]["b1_launches"],
            "mmoe_5l_run_ranking_experiment":
                mtl["run_ranking_experiment"]["b1_launches"],
            "multitask_5l_eager": mtl["eager_b1_launches"],
            "ctr_zoo_5m_eager": sum(m["b1_launches"]
                                    for m in ctrx.values())},
        "din_5k": {
            "launches": din["run_ranking_experiment"]["b1_launches"],
            "pack": din["pack_shape"], "slots": [16], "grads": "f32",
            "ids": "4096 x 53 a step: Zipf(1.2) items, 50-long histories "
                   "pre-padded on one PAD row",
            "max_abs_err": din["b1_din"]["check"]["max_abs_err"],
            "max_abs_err_update": din["b1_din"]["check"][
                "max_abs_err_update"],
            **{key: din["b1_din"]["time"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "pad_row_count", "hottest_row_count")},
            "device_ms_in_replayed_step": (din["replayed_step_profile"][
                "groups"] or {}).get("b1_packed_adagrad_update")},
        "mmoe_5l": {"launches": mtl["run_ranking_experiment"][
            "b1_launches"]},
        "block_rows_5p": {
            "launches": blk["b1_launches"], "pack": blk["b1_block_grads"][
                "time"]["pack"], "slots": blk["b1_block_grads"]["time"][
                "dims"], "grads": blk["b1_block_grads"]["time"]["grads"],
            "ids": "26 x 32,768 a step, uniform per field, the (F, B, d) "
                   "block gradients of one eager step",
            "max_abs_err": blk["b1_block_grads"]["check"]["max_abs_err"],
            "max_abs_err_update": blk["b1_block_grads"]["check"][
                "max_abs_err_update"],
            **{key: blk["b1_block_grads"]["time"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "device_ms_in_replayed_step": (blk["replayed_step_profile"][
                "groups"] or {}).get("b1_packed_adagrad_update")},
        "pipeline_5q": {
            "launches": pipe["b1_launches"],
            "ids": "26 x 32,768 a step of the encoder's ids (Zipf(1.1) "
                   "tokens, the rest of the top 99,999 to OOV row 0)",
            "max_abs_err": pipe["b1_streamed_step"]["check"]["max_abs_err"],
            "max_abs_err_update": pipe["b1_streamed_step"]["check"][
                "max_abs_err_update"],
            **{key: pipe["b1_streamed_step"]["time"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "pad_row_count", "hottest_row_count")},
            "device_ms_in_profiled_steps": (pipe["streamed_profile"][
                "groups"] or {}).get("b1_packed_adagrad_update")},
        "big_vocab_5s": {
            "launches": bv["b1_launches"], "pack": bv["pack"],
            "slots": bv["b1"]["time"]["dims"],
            "grads": bv["b1"]["time"]["grads"],
            "ids": "26 x 8,192 a step, uniform over each field's 1M",
            "max_abs_err": bv["b1"]["check"]["max_abs_err"],
            "max_abs_err_update": bv["b1"]["check"]["max_abs_err_update"],
            **{key: bv["b1"]["time"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}},
        "not_called_5p": {
            "lazy_adam": layouts["lazy_adam_criteo"]["b1_launches"],
            "split_accumulators": layouts["split_accumulators_criteo"][
                "b1_launches"]},
        "device_ms_in_profiled_step": {
            "eager": (eager_c["groups"] or {}).get(
                "b1_packed_adagrad_update"),
            "graph_replay": (graph_c["groups"] or {}).get(
                "b1_packed_adagrad_update")},
        "max_abs_err": b1_checks["uniform"]["max_abs_err"],
        "ms": b1_time["ms"], "plain_ms": b1_time["plain_ms"],
        "bound_ms": b1_time["bound_ms"], "bound_by": b1_time["bound_by"],
        "library_ms": b1_time["library_ms"],
        "library": "pack.index_add_(0, ids, operand), the scatter alone",
        "design": "operand rows staged in shared memory slot by slot, "
                  "16-byte vector reductions (REDG.F32x4), a block's rows "
                  "of one id summed before their reductions",
        "ids": "uniform per field, as bench.py draws them",
        "zipf_ids": {key: b1_times["zipf"][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms")},
        "max_abs_err_zipf": b1_checks["zipf"]["max_abs_err"],
        "one_slot_dcnv2": {
            "slots": list(B1_ZOO_DIMS), "grads": "f32",
            "max_abs_err": zoo["b1_one_slot_check"]["max_abs_err"],
            **{key: zoo["b1_one_slot_time"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "device_ms_in_replayed_step": (zoo["dcnv2"][
                "replayed_step_profile"]["groups"] or {}).get(
                "b1_packed_adagrad_update")},
        "xdeepfm_layout": {
            "slots": list(B1_XDEEPFM_DIMS), "grads": "f32",
            "max_abs_err": zoo["b1_xdeepfm_check"]["max_abs_err"],
            **{key: zoo["b1_xdeepfm_time"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}},
        "ptxas": redesigned["packed_delta"], "matches_plain": True,
        "shape": {"pack": [NUM_CAT * VOCAB, 128], "rows": NUM_CAT * BATCH,
                  "slots": list(B1_DIMS), "grads": "bf16"}})
    b2_err = b2_checks[0]
    for name, key, errs, replaces in (
            ("fused_ce_forward", "fwd", {"lse": b2_err["lse"]},
             "recbox_tpu/ops/pallas/fused_ce.py:100"),
            ("fused_ce_backward", "bwd",
             {"du": b2_err["du"], "dt": b2_err["dt"]},
             "recbox_tpu/ops/pallas/fused_ce.py:212")):
        zoo_launches = sum(m["b2_launches"][f"fused_ce_{key}"]
                           for m in seq_zoo.values())
        kernels.append({
            "name": name, "route": "cuda",
            "source": "recbox_tpu_torch/csrc/fused_ce.cu",
            "replaces": replaces,
            "launches": fit_d["b2_launches"][f"fused_ce_{key}"]
            + seq_cli["b2_launches"][f"fused_ce_{key}"]
            + ex_launches.get(f"fused_ce_{key}", 0),
            "launches_by_path": {
                "examples_5s": ex_launches.get(f"fused_ce_{key}", 0),
                "fit_fused_graph": fit_d["b2_launches"][f"fused_ce_{key}"],
                "train_steps_repeat_eager": sas["launches"][
                    f"fused_ce_{key}"],
                "bert4rec_run_main_5j": seq_cli["b2_launches"][
                    f"fused_ce_{key}"],
                "seq_zoo_5j": zoo_launches},
            "cloze": {
                "shape": {"rows": cloze["rows"], "v": cloze["v"],
                          "d": cloze["d"], "zero_weights":
                          cloze["zero_weights"]},
                # no pipeline calls `fused_cloze_loss`: BERT4Rec's run
                # trains through the next-item `fused_ce_loss` (1024 rows,
                # no weights), counted under bert4rec_run_main_5j
                "launches": 0,
                "max_abs_err": cloze["sweeps"]["lse"] if key == "fwd"
                else max(cloze["sweeps"]["du"], cloze["sweeps"]["dt"]),
                "plan": cloze["sweeps"]["plan"],
                **{k: cloze[f"{key}_{k}"] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": cloze["fwd_library_ms" if key == "fwd"
                                    else "fwd_bwd_library_ms"],
                "library": "F.cross_entropy(reduction='none') over the "
                           f"bf16 logits, weighted, {cloze['library_calls']} "
                           f"calls of {LIB_ROWS} rows"
                           + ("" if key == "fwd" else
                              ", forward + backward"),
                "repeats_bit_identical": cloze["repeats_bit_identical"]},
            "seq_zoo_shapes": {
                m: {"d": z["b2_check"]["d"], "plan": z["b2_check"]["plan"],
                    "max_abs_err": z["b2_check"]["lse"] if key == "fwd"
                    else max(z["b2_check"]["du"], z["b2_check"]["dt"])}
                for m, z in seq_zoo.items() if "b2_check" in z},
            "device_ms_in_profiled_step": {
                "eager": (eager_d["groups"] or {}).get(
                    "b2_forward" if key == "fwd" else "b2_backward"),
                "graph_replay": (graph_d["groups"] or {}).get(
                    "b2_forward" if key == "fwd" else "b2_backward")},
            "max_abs_err": max(errs.values()), "max_abs_err_by": errs,
            "ms": b2_time[f"{key}_ms"],
            "plain_ms": b2_time[f"{key}_plain_ms"],
            "bound_ms": b2_time[f"{key}_bound_ms"],
            "bound_by": b2_time[f"{key}_bound_by"],
            "bound_what": b2_time[f"{key}_bound_what"],
            "exp_floor_ms": b2_time["exp_floor_ms"],
            "library_ms": b2_time["fwd_library_ms" if key == "fwd"
                                  else "fwd_bwd_library_ms"],
            "library": "F.cross_entropy(u_bf16 @ t_bf16.T, labels)"
                       + ("" if key == "fwd" else ", forward + backward"),
            "design": B2_DESIGN[key],
            "ptxas": [u for u in redesigned["fused_ce"]
                      if f"ce_{key}" in u["function"]],
            "plans": {f"b{c['b']}_v{c['v']}_d{c['d']}": c["plan"]
                      for c in b2_checks if c.get("plan")},
            "matches_plain": True, "repeats_bit_identical": True,
            "shape": {"b": SAS_B, "v": SAS_V, "d": SAS_D}})
    for (name, _, _), line in zip(B4_VARIANTS, (332, 315, 340)):
        t, t64 = b4_times[name, B4_D], b4_times[name, DIM]
        errs = [c["max_abs_err"] for c in b4_checks if c["variant"] == name]
        kernels.append({
            "name": f"mips_segment_candidates[{name}]", "route": "cuda",
            "source": "recbox_tpu_torch/csrc/mips_topk.cu",
            "replaces": f"recbox_tpu/ops/pallas/mips_topk.py:{line}",
            "launches": cand_launches[name], "max_abs_err": max(errs),
            "launches_by_route_examples_5s": {
                r: ex_launches.get(f"mips_topk[{r}]", 0)
                for r in ("wgmma", "segment", "tile")},
            "as_b3_stage_a_by_path_and_route": None if name == "unpacked"
            else {"serve_4": {
                r: stages["bf16" if name == "packed" else "int8"][r]
                for r in ("wgmma", "segment", "tile")},
                "serve_small_batch_4a": {
                    r: small["bf16" if name == "packed" else "int8"][
                        "launches"][r] for r in ("wgmma", "segment", "tile")}},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "per 1024 queries: cuBLAS scores (bf16 matmul or "
                       "torch._int_mm) + strided segment amax/max",
            "kernel_route": t["route"], "tile_route_ms": t["tile_route_ms"],
            "d64": {key: t64[key] for key in (
                "route", "ms", "tile_route_ms", "plain_ms", "library_ms",
                "bound_ms")},
            "ptxas": redesigned["mips_topk"] if t["route"] == "wgmma"
            else None,
            "ptxas_segment_route": None if name == "unpacked"
            else redesigned["mips_topk_segment"],
            "matches_plain": True,
            "shape": {"n": B4_N, "d": B4_D, "q": B4_Q,
                      "query_tile": B4_TILE}})
    t5 = b5_times[0]
    kernels.append({
        "name": "bitonic_topk", "route": "cuda",
        "source": "recbox_tpu_torch/csrc/bitonic_topk.cu",
        "replaces": "recbox_tpu/ops/pallas/bitonic_topk.py:123",
        "launches": cand_launches["bitonic_topk"] + r_b5 + t_b5 + u_b5
        + seg["b5_launches"] + ex_launches.get("bitonic_topk", 0),
        "launches_by_path": {"candidate_paths_4b":
                             cand_launches["bitonic_topk"],
                             "sharded_search_merge_5r": r_b5,
                             "mind_from_trainer_on_mesh_5t": t_b5,
                             "lightgcn_from_trainer_on_mesh_5u": u_b5,
                             "segmented_mips_topk_5s": seg["b5_launches"],
                             "examples_5s": ex_launches.get(
                                 "bitonic_topk", 0)},
        "segmented_5s": {
            "launches": seg["b5_launches"], "max_abs_err": seg["max_abs_err"],
            "shape": {key: seg[key] for key in (
                "n", "d", "q", "k", "query_chunk", "n_segments", "seg_k")},
            "recall_vs_exact_512": seg["recall_vs_exact_512"],
            **{key: seg[key] for key in (
                "ms", "plain_ms", "library_ms", "library", "bound_ms",
                "bound_by")},
            "b5_one_chunk": seg["b5_one_chunk"]},
        "max_abs_err": max(c["max_abs_err"] for c in b5_checks),
        "ms": t5["ms"], "plain_ms": t5["plain_ms"],
        "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
        "library_ms": t5["library_ms"],
        "library": "torch.topk on the (Q, C) view",
        "design": "radix selection over keys in registers, then a sort of "
                  "the k survivors",
        "queries_a_block": t5["queries_a_block"],
        "merge_only": {f"k={t['k']}": {key: t[key] for key in (
            "ms", "library_ms", "bound_ms")} for t in b5_times[1:]},
        "ptxas": redesigned["bitonic_topk"], "matches_plain": True,
        "shape": {"c": t5["c"], "q": t5["q"], "k": t5["k"]}})
    # the selection's global-memory mode (5v): B5's sharded merge past
    # k = 8192 and B3's served search at 16.8M items
    w10, w64 = big_b5
    kernels.append({
        "name": "bitonic_topk[global_memory_mode]", "route": "cuda",
        "source": "recbox_tpu_torch/csrc/bitonic_topk.cu",
        "mode_source": "recbox_tpu_torch/csrc/select_topk.cuh",
        "replaces": "recbox_tpu/ops/pallas/bitonic_topk.py:123",
        "launches": sum(r["b5_global_memory_launches"] for r in v_c),
        "launches_by_path": {"sharded_search_merge_5v_c": sum(
            r["b5_global_memory_launches"] for r in v_c)},
        "max_abs_err": max(w10["max_abs_err"], w64["max_abs_err"]),
        "ms": w10["ms"], "plain_ms": w10["plain_ms"],
        "bound_ms": w10["bound_ms"], "bound_by": w10["bound_by"],
        "library_ms": w10["library_ms"], "library": w10["library"],
        "design": "two reads of each score (the first digit's "
                  "histogram; the keys above its threshold bin to the "
                  "survivors, the bin's to a buffer), the bin's keys "
                  "narrowed in shared memory, the k survivors sorted in "
                  "runs of 16384 (16 a thread in registers, merge-path "
                  "merges in shared memory) and merged in device memory",
        "k_65536": {key: w64[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "ptxas": usage_of(_build.build_logs, "bitonic_topk",
                          "select_large"),
        "matches_plain": True, "bit_equal": True,
        "shape": {"q": V_Q, "c": V_C, "k": V_K}})
    for variant in ("bf16", "int8"):
        v = big_search[variant]
        kernels.append({
            "name": f"mips_fused_topk[{variant},global_memory_mode]",
            "route": "cuda",
            "source": "recbox_tpu_torch/csrc/mips_fused_topk.cu",
            "stage_a_source": "recbox_tpu_torch/csrc/mips_topk.cu",
            "mode_source": "recbox_tpu_torch/csrc/select_topk.cuh",
            "replaces": "recbox_tpu/ops/pallas/mips_fused_topk.py:100",
            "launches": v["served_launches"]["select_global_memory_mode"],
            "launches_by_path": {"served_search_5v_a": v[
                "served_launches"]},
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"],
            "library": v["library"], "stage_a_ms": v["stage_a_ms"],
            "stage_b_ms": v["stage_b_ms"],
            "stage_b_bound_ms": v["stage_b_bound_ms"],
            "ptxas": usage_of(_build.build_logs, "mips_fused_topk",
                              "select_large"),
            "rows_same_ids": v["rows_same_ids"], "matches_plain": True,
            "shape": {"n": V_N, "d": DIM, "q": V_Q, "k": V_K,
                      "winners_a_query": v["winners_a_query"]}})
    # the selection's streaming path: B5 over the segments of 5s(c)'s
    # `segmented_mips_topk` and B3's stage (b) served at k = 500 (5v(a))
    segs = seg["b5_one_chunk"]["segments"]
    kernels.append({
        "name": "bitonic_topk[stream]", "route": "cuda",
        "source": "recbox_tpu_torch/csrc/bitonic_topk.cu",
        "path_source": "recbox_tpu_torch/csrc/select_topk.cuh",
        "replaces": "recbox_tpu/ops/pallas/bitonic_topk.py:123",
        "launches": seg["b5_stream_launches"],
        "launches_by_path": {"segmented_mips_topk_5s": seg[
            "b5_stream_launches"]},
        "max_abs_err": max(segs["max_abs_err"], max(
            r["max_abs_err"] for r in special)),
        "ms": segs["ms"], "plain_ms": segs["plain_ms"],
        "bound_ms": segs["bound_ms"], "bound_by": segs["bound_by"],
        "library_ms": segs["library_ms"],
        "library": "torch.topk on the (rows, C) scores",
        "design": "a streaming filter on a running threshold: scores "
                  "through registers a tile at a time, the next tile's "
                  "loads in flight; keys above the k-th kept key to a "
                  "shared buffer by warp ballots; a full buffer keeps its "
                  "k largest by radix selection in place",
        "ptxas": usage_of(_build.build_logs, "bitonic_topk",
                          "select_stream"),
        "special_rows": special, "matches_plain": segs["bit_equal"],
        "shape": {"rows": segs["q"], "c": segs["c"], "k": segs["k"]}})
    for variant in ("bf16", "int8"):
        v = big_search[f"{variant}_stream"]
        kernels.append({
            "name": f"mips_fused_topk[{variant},stream]", "route": "cuda",
            "source": "recbox_tpu_torch/csrc/mips_fused_topk.cu",
            "stage_a_source": "recbox_tpu_torch/csrc/mips_topk.cu",
            "path_source": "recbox_tpu_torch/csrc/select_topk.cuh",
            "replaces": "recbox_tpu/ops/pallas/mips_fused_topk.py:100",
            "launches": v["served_launches"]["select_stream"],
            "launches_by_path": {"served_search_5v_a": v[
                "served_launches"]},
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"],
            "library": v["library"], "stage_a_ms": v["stage_a_ms"],
            "stage_b_ms": v["stage_b_ms"],
            "stage_b_bound_ms": v["stage_b_bound_ms"],
            "stage_b_library_ms": v["stage_b_library_ms"],
            "ptxas": usage_of(_build.build_logs, "mips_fused_topk",
                              "select_stream"),
            "rows_same_ids": v["rows_same_ids"], "matches_plain": True,
            "shape": {"n": V_N, "d": DIM, "q": V_Q, "k": V_K_STREAM,
                      "winners_a_query": v["winners_a_query"]}})
    t6, t6u = b6_times[0], b6_times[2]
    kernels.append({
        "name": "seq_embedding_pool", "route": "cuda",
        "source": "recbox_tpu_torch/csrc/embedding_gather.cu",
        "replaces": "recbox_tpu/ops/pallas/embedding_gather.py:94",
        "launches": cand_launches["seq_embedding_pool"]
        + ex_launches.get("seq_embedding_pool", 0),
        "launches_by_path": {
            "candidate_paths_4b": cand_launches["seq_embedding_pool"],
            "examples_5s": ex_launches.get("seq_embedding_pool", 0)},
        "max_abs_err": max(c["max_abs_err"] for c in b6_checks),
        "ms": t6["ms"], "plain_ms": t6["plain_ms"],
        "bound_ms": t6["bound_ms"], "bound_by": t6["bound_by"],
        "library_ms": t6["library_ms"],
        "library": "F.embedding_bag(ids, table, mode='mean', padding_idx)",
        "ids": "zipf(1.2), rows L2-resident across the timed run",
        "ms_int32_ids": t6["ms_int32_ids"],
        "uniform_ids": {key: t6u[key] for key in (
            "ms", "ms_int32_ids", "plain_ms", "library_ms", "bound_ms",
            "distinct_rows_mb")},
        "ptxas": redesigned["embedding_gather"], "matches_plain": True,
        "repeats_bit_identical": True,
        "shape": {"v": B6_V, "b": B6_B, "l": B6_L, "d": t6["d"]}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_ms(fn) -> dict:
    """Device ms by kernel name of one call of ``fn`` under torch.profiler
    (after a warm call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:90]: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def selection_main(argv) -> int:
    """``python3 chip_smoke.py --selection [--root DIR] [--only NAME ...]
    [--profile]``: the top-k selection (B5 and B3's stage (b)) alone, at
    one window and past it, one JSON line a case (`b5_case` / `b3b_case`:
    bit for bit against the plain versions, ms, `torch.topk`, the bound)
    with the card's name and power limit. Cases: b5_window ((C, Q) =
    (7936, 8192) candidate-major, k = 500), b5_segments (5s(c)'s 8192
    rows x 125,000, k = 93), b5_rows ((1024, 131,072) at k = 500, 2000,
    8192), b5_cmajor (the same candidate-major at k = 500, 2000, 4096),
    b5_large (bf16-rounded, k = 10,000 and 65,536), b3b_window (stage
    (a)'s winners of 1M x 64 bf16 items for 8192 queries, k = 500),
    b3b_stream / b3b_large (of 16.8M x 64 for 1024, k = 500 / 10,000;
    printed as b3b_past_window) and segmented
    (`segmented_mips_topk` at 5s(c)'s shape). ``--root`` imports
    `recbox_tpu_torch` from another checkout (its kernels build there),
    so that two trees are timed on one card in one call; ``--profile``
    adds each case's device ms by kernel."""
    import argparse
    parser = argparse.ArgumentParser(prog="chip_smoke.py --selection")
    parser.add_argument("--root", default=None)
    parser.add_argument("--only", nargs="*", default=None)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import recbox_tpu_torch
    from recbox_tpu_torch.ops import _build
    from recbox_tpu_torch.ops import bitonic_topk as bt
    from recbox_tpu_torch.ops.mips_fused_topk import segment_plan
    from recbox_tpu_torch.retrieval import index as index_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["bitonic_topk", "mips_fused_topk", "mips_topk"])
    info = {"package": os.path.dirname(recbox_tpu_torch.__file__),
            "card": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)

    def on(name):
        return args.only is None or name in args.only

    def plan(c, k, cmajor):
        try:
            return list(bt.select_plan(c, k, cmajor=cmajor))
        except TypeError:       # a tree whose plan ignores the layout
            return list(bt.select_plan(c, k))

    def b5(name, scores, ids, k, cmajor=False, reps=5):
        res = b5_case(scores, ids, k, cmajor, reps)
        if args.profile:
            res["kernel_ms"] = kernel_ms(lambda: (
                bt.pallas_bitonic_topk_cmajor if cmajor
                else bt.pallas_bitonic_topk)(scores, ids, k))
        emit({**info, "name": name, **res,
              "plan": plan(res["c"], k, cmajor)})

    def b3b(name, n, nq, ks, reps=5):
        q, c, _ = make_inputs("bf16", n, DIM, nq, gen)
        for k in ks:
            sub = segment_plan(c.dtype, n, DIM, nq, k)[0]
            stage_a, stage_b, _ = b3_stages(q, c, None, k)
            stage_a()
            res = b3b_case(stage_b.winners, None, sub, k, reps)
            if args.profile:
                res["kernel_ms"] = kernel_ms(stage_b)
            emit({**info, "name": name, **res,
                  "plan": plan(res["c"], k, True)})
            del stage_a, stage_b
            torch.cuda.empty_cache()

    if on("b5_window"):
        s, ids = b5_inputs(gen, 7936, 8192)
        b5("b5_window", s, ids, 500, cmajor=True, reps=11)
        del s, ids
    if on("b5_segments"):
        s = torch.randn(8192, 125_000, generator=gen, device=DEVICE)
        b5("b5_segments", s, None, 93)
        del s
    if on("b5_rows") or on("b5_cmajor") or on("b5_large"):
        s = torch.randn(V_Q, V_C, generator=gen, device=DEVICE)
        if on("b5_rows"):
            for k in (500, 2000, 8192):
                b5("b5_rows", s, None, k)
        if on("b5_cmajor"):
            cm = s.T.contiguous()
            pos = torch.arange(V_C, device=DEVICE, dtype=torch.int32)[
                :, None].expand(V_C, V_Q).contiguous()
            for k in (500, 2000, 4096):
                b5("b5_cmajor", cm, pos, k, cmajor=True)
            del cm, pos
        if on("b5_large"):
            sr = s.to(torch.bfloat16).float()
            ids = torch.randperm(V_Q * V_C, generator=gen, device=DEVICE
                                 ).view(V_Q, V_C).to(torch.int32)
            for k in (V_K, V_K_WIDE):
                b5("b5_large", sr, ids, k)
            del sr, ids
        del s
    torch.cuda.empty_cache()
    if on("b3b_window"):
        b3b("b3b_window", N_ITEMS, N_QUERIES, (K,), reps=11)
    if on("b3b_stream") or on("b3b_large"):
        b3b("b3b_past_window", V_N, V_Q,
            [k for k, name in ((V_K_STREAM, "b3b_stream"),
                               (V_K, "b3b_large")) if on(name)])
    if on("segmented"):
        items = torch.randn(SEG_N, SEG_D, generator=gen, device=DEVICE)
        queries = torch.randn(N_QUERIES, SEG_D, generator=gen, device=DEVICE)
        moved = (SEG_N + N_QUERIES) * SEG_D * 4 + N_QUERIES * K * 8
        emit({**info, "name": "segmented_mips_topk", "n": SEG_N,
              "d": SEG_D, "q": N_QUERIES, "k": K,
              "ms": cuda_ms(lambda: index_mod.segmented_mips_topk(
                  queries, items, K, query_chunk=SEG_CHUNK), reps=3),
              "bound_ms": max(moved / HBM_BYTES_S, 2.0 * N_QUERIES * SEG_N
                              * SEG_D / PEAK_OPS["bf16"]) * 1e3})
    return 0


if __name__ == "__main__":
    sys.exit(selection_main(sys.argv[2:]) if sys.argv[1:2] == ["--selection"]
             else main())
