#!/usr/bin/env python3
"""Drive the PyTorch port of MCGI (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # from the repository root

Phases, each printed on its own lines; any failure exits non-zero:

1. device and build — the card's name and power limit (nvidia-smi), then the
   six kernel libraries (``beam_step``, ``l2_distance``, ``topk``,
   ``lid_kernel``, ``pq_scan``, ``decode_attention``) compiled from
   ``src/repro_torch/csrc`` with nvcc, one process each, all started
   together;
2. kernel vs plain version, at the main paths' own shapes —
   ``beam_step`` in both kinds at serving shape (Q=1024, L=128, R=64, N=1M;
   D=128 exact, M=16 x K=256 PQ) for 12 hops of one launch each:
   bit-identical to ``beam_step_ref`` on integer-valued tables and
   contexts, and on float data beam_d within 1e-5 relative with ids and
   visited words equal in every lane without a near-tie; the resident walk
   (``beam_walk``) as one launch of 12 hops and one launch to convergence
   (hop limits up to 200), each bit-identical to ``beam_step_ref`` hop by
   hop on integer data, with the lanes it leaves movable counted; its
   device time per hop beside the one-hop launch's; the out-of-core walk's
   row-fed hop (``beam_step.pq_rows``, the same shape, rows gathered from
   the adjacency) for the select (every lane inactive, both ways), 12
   hops and one hop from shuffled beams, bit-identical to
   ``beam_hop_rows_ref`` on integer LUTs (frontiers and activity
   included), within 1e-5 on float LUTs, timed; ``l2_distance`` at the k-NN shape (4096 x 65536
   x 128) float32 within rtol 1e-4 / atol 1e-3, on integer operands
   (0-255) at that shape bit-identical, on SIFT-scale near duplicates
   (1024 x 8192) within rtol 1e-4 / atol 1e-3 of float64 and no more than
   4x the plain version's error, bfloat16 at 1024 x 8192 x 128 within
   2e-2 / 2e-1; its bound is that of its three TF32 products on the tensor
   cores, printed beside the float32 SIMT bound; ``topk`` on that float32
   output at k = 17 and 10 (and on a row with planted ties, a row with
   fewer than k finite entries and 8 rows cut into segments), at k = 100
   and 101 (the 128-key warp-select), at k = 2048 (the radix select) on 8
   rows with ties, +inf and NaN, and at [adc]'s chunk shape (256 x 1M,
   k = 10 and 100), and at the MoE routers' shapes (1024 tokens x 64
   experts, k = 6; x 128, k = 8; negated softmax probabilities with a
   uniform row, a row of three levels and a row of -0.0) and at the
   training router's (train_4k's 4,096 tokens x 64 experts, k = 6, the
   same planted rows), each timed: values bitwise and ids exactly equal,
   and at the training router's shape the value gradient of ``ops.topk``
   equal to the plain version's (a gather at ``topk_ref``'s ids) bit for
   bit;
   ``lid_estimate`` at 1M x 16, 1M x 1 and 100k x 100 within rtol 1e-4
   (timed at 1M x 16); ``decode_attention`` at
   qwen2-7b's heads (28 query, 4 KV, d=128, bfloat16 cache) at the
   serving shape B=8, S=160 (8 prompts, 128 + 32 tokens), at the
   ``decode_32k`` shape with batch cut to 16 and at the ``long_500k``
   shape, and at the zoo's other GQA
   heads (32 / 4 / 128, 56 / 8 / 128, 36 / 36 / 64) at that shape,
   ragged kv_len including 0, 1 and S, within 3e-4; ``pq_scan`` at
   (256, 16, 256) LUTs x (1M, 16) codes, bit for bit on integer-valued LUTs
   and within 1e-5 on float LUTs, timed on random codes and on all-zero
   codes (the design's conflict-free floor on the card), beside its bytes
   bound and shared memory's own floor.  Each kernel's device time per launch
   (launches queued back to back behind a sleep kernel, so host work is not
   timed), the plain version's time, the library call's time where one
   PyTorch call computes the same function, and the bound;
3. the main path at the ``mcgi-sift1m`` deployment (the paper's Table 2,
   ``repro_torch/configs/mcgi_datasets.py``: N=1M, D=128, R=64,
   L_build=100, alpha in [1, 1.5], l_search=128, k=10, max_hops=192,
   lam=0.25, l_min=8, probe_hops=8, hop_factor=4; PQ m=16) on synthetic
   SIFT1M-shaped data drawn from --seed on the card: MCGI build (the LID
   k-NN through ``l2_distance`` + ``topk``, the estimate through
   ``lid_estimate``, then the alpha-mapped prune), PQ tier, ground truth,
   then serving through the engine — tiered adaptive pipelined (the ``pq``
   kind), exact adaptive (the ``exact`` kind) and one fixed-beam batch at
   beam 128; fails if any of the five MCGI kernels was never launched,
   tiered-adaptive recall@10 < 0.80, or any result id lies outside [-1, N);
   after the launch counts are read, the tiered adaptive stream is served
   again as one ``search`` per batch and with 4 budget buckets, to compare
   QPS (results must not move);
3b. the calibration path — ``SearchEngine.recalibrate(joint=True)`` of the
   exact adaptive engine to the config's recall target 0.95 and of the
   tiered engine to 0.80 (PQ m=16 caps tiered recall near 0.835), each on
   256 held-out queries, then the 10k stream served with each fitted law,
   and the config's lam-only fit (``calibrated_beam_budget``) of the exact
   index on the same sample; fails if either exact fit is not achieved,
   its served recall@10 falls below 0.92, or a ``beam_step`` kind was
   never launched;
3c. [adc] bulk ADC retrieval — ``adc_topk(k=10)`` of the 10,000 queries
   against phase 3's 1M x 16 PQ codes, in chunks of 256 queries (one
   ``pq_scan`` and one ``topk`` each); recall@10 against the exact ground
   truth, printed with no gate (exhaustive ADC without a rerank), and the
   time of one ``retrieval_cand``-shaped call (1 query x 1M candidates);
   fails unless both kernels launched once per chunk, and unless the
   first chunk's results and the 1-query call's equal ``pq_scan_ref`` +
   ``topk_ref`` on the same LUTs, values and ids; then, after the counts
   are read, ``adc_topk(k=100)`` over the first chunk, held to the plain
   versions and to the k=10 run, and timed;
3g. [door] the serving front door (``repro_torch.serving.server``) over
   phase 3's in-memory tiered index and stream: two QoS classes, the
   launcher's ``--serve`` ones (interactive: 8 lanes a dispatch, a 2 ms
   window, 100 ms deadline, phase 3b's tiered fit; batch: 32 lanes, 20 ms,
   2,000 ms, the same law at l_min = l_max), each its own engine over the
   shared backend, the LID center pinned to the stream's mean, at most 256
   open lanes.  A virtual-clock replay of 4,000 requests (half each class,
   ``VirtualDispatcher(service_time="measured")``, ``begin`` on the
   flushing thread): every ``begin`` under CUDA sync debug mode "error"
   (no host sync), and each class's capacity from its flights' host
   seconds.  Then the wall clock (``WallClock`` + ``ThreadDispatcher`` at
   2 workers, ``begin`` on its begin thread, 8 client threads): Poisson at
   150% of the replay's capacity for 2 s of arrivals (overload: must
   shed), whose ok + partial lanes a second give the wall-clock door's
   capacity; Poisson (must not shed) and bursty, 10 s each at half of
   that; interactive requests in groups of 8 at a quarter of it, first
   for 3 s under the class's 100 ms deadline (calibration: each lane's
   submit-to-probe-ready and submit-to-full times under this load), then
   for 5 s with the deadline halfway between those two medians (hedges
   must fire); and 12 held
   dispatches of 8 from one client, each continue held back by a sleep
   kernel queued on the engine's stream right after ``begin``, past a
   20 ms deadline (each partial asked during the hold must return before
   it ends, so none queued behind the continue; each class engine first
   serves one flight and its partial outside the door, not counted, so
   that no first allocation on a new stream's pool falls inside a hold,
   and the garbage collector is off).  Before the door's runs the built
   world is frozen out of the collector (``gc.freeze()``; unfrozen after
   [base]), so a full collection scans only what the runs allocate.  Each run prints per class the statuses,
   latency p50 / p99, recall@10 of ok and partial lanes, mean budget and
   hops, dispatches and ``begin``'s host ms, and per run how late the
   deadline and window timers fired, how long a submit held its client,
   each hedged flight's full result at the door after its first partial,
   and the pauses of the full garbage collections during the run.  Fails
   unless the counters add up to the requests, every future completed
   once, each engine closed once, every partial holds 10 valid distinct
   ids in ascending d2, every ok lane and every partial of every run is
   bit-identical to its class engine's direct ``search`` /
   ``partial_result`` of the same query, recall@10 of ok lanes >= 0.80 in
   the replay and the three load runs (not the short-deadline and held
   runs: their ok lanes are the flights that beat a deadline below the
   median flight, the shortest walks), and ``beam_step`` pq launched in
   the door's runs (the direct answers and the solo timings come before
   the counts are zeroed);
3d. [disk] the disk-resident slow tier at the same 1M index and stream:
   ``open_or_build_slow_tier`` writes the node-order block store (1 KiB
   records) to a temporary directory (removed when the phase ends) and
   serves the stream through ``TieredBackend(slow_tier=...)`` pipelined
   (the engine's prefetch stage) and per batch; the same store with a
   65,536-node hot tier for two pipelined passes (promotions drained
   between them; the second open must reuse the store, mtime unchanged);
   a store packed by ``block_layout(nodes_per_block=4)`` (four records a
   4 KiB page; the stream's first 5 batches, a cut for time, printed);
   and ``save_index(version=2)`` + ``load_index`` on the card
   (every array equal) served through ``load_slow_tier``.  Every run's ids
   and d2 must equal the in-memory tiered run's bit for bit; each prints
   QPS, batch p50 / p99, recall@10, hit rate, blocks read, I/O blocks per
   query, measured read us and fetch p50 / p99 (reads from the OS page
   cache, not an SSD); fails unless ``beam_step`` [pq] launched there;
3e. [ooc] the out-of-core walk at the same index and stream, over [disk]'s
   stores (the temporary directory is removed after this phase):
   ``OutOfCoreBackend`` (only the PQ codes, codebook and entry on the
   card; adjacency and vectors read from the block store, LRU 4,096 + 256
   pins) serving the stream pipelined and per batch over the node-order
   store, pipelined over the packed store (the stream's first 5 batches, a
   cut for time, printed), and one fixed-beam batch at beam 128; every
   run's ids, d2, hops and granted budgets must equal the
   in-memory tiered run's bit for bit, ``beam_step.pq_rows`` must launch
   and ``beam_step.pq`` must not, and the backend must hold no (N, R) or
   (N, D) tensor.  Each run prints QPS, batch p50 / p99, host hops a
   batch and ``pq_rows`` launches, the host ms of a host hop (waiting for
   rows, copying them, launching, reading the frontier back), hit rate,
   fetch p50 / p99, and I/O blocks and ids per query for the walk's reads
   and the rerank's apart, each beside the card's name and power limit;
   first, ``torch.profiler`` over one batch gives the row-fed kernel's
   device ms per launch (printed beside each run's host ms a host hop)
   and the device's busy share;
3f. [live] the write path at the first 100,000 of phase 3's rows (a cut
   for time from all 1M, printed): ``LiveIndex`` over the first 99,000
   (``build_online_mcgi``: the bootstrap through
   ``l2_distance`` + ``topk``, the rewire walks through ``beam_step``
   exact; a PQ tier; a block store of 4 records a page in a temporary
   directory; the budget law of phase 3), the stream's first 5 batches
   served one ``LiveIndex.search`` a batch (each stage serves these 5 of
   the 10 batches, a cut for time, printed); the last 1,000 of the
   100,000 rows inserted in 10 calls of 100, each then found at rank 0
   with d2 = 0, and the stage served against the ground truth over the
   100,000 rows; 1,000 base ids tombstoned (drawn from --seed), the stage served and the whole
   stream walked by ``DeltaTier.search_exact``; ``merge_async`` while the
   main thread serves the stream at half its closed-loop load; the stage
   at the merge boundary; ``save`` and ``load_lineage``.  Fails if a deleted
   id is returned before, during or after the merge, an inserted vector
   is not its own rank-0 result with d2 = 0 right after its insert, one
   the walk finds after the merge (at least 90% of them: no delta scan
   at a merge boundary) carries another external id, recall@10 < 0.75 at any stage (phase 3's tiered recall printed
   beside it), the merge does not publish generation 1, the lineage is
   wrong, or ``beam_step`` exact or pq, ``l2_distance`` or ``topk`` was
   never launched on the path (ground truths not counted).  Prints the
   online build's phases, inserts/s, each stage's QPS and batch p50 / p99,
   the merge's seconds and the batches served during it (at half the
   closed loop's load: each batch is followed by a pause as long as it
   took);
3h. [dist] distributed MCGI at phase 3's data: the 1M rows in 8 shards of
   125,000 on a (2, 4) ("data", "model") mesh over every visible card (in
   contiguous blocks; one card holds all 8), shard s owning rows
   [125,000 s, 125,000 (s + 1)) on its card, each shard's walks on a
   stream of its own (``build_sharded_arrays``: one ``build_with_alpha``
   a shard on its card at the config's R and L_build, static alpha 1.2,
   PQ m=16 trained once; the rewire walks through ``beam_step`` exact);
   the cards, each shard's card and the GB on each card printed; one check
   batch whose every shard's top-k must equal, bit for bit, that shard's
   walk run alone on its card's default stream; the stream served staged (the config's law, 4
   budget buckets, hierarchical merge; pipelined and per batch), by the
   monolithic adaptive step (an engine with no budget config) and by a
   fixed-beam monolithic step at l_search; ``distributed_search`` with
   both merges on batch 0; shard 3 dropped after the second result of a
   pipelined stream; one law fitted per shard to 0.95
   (``calibrate_budget_law_per_shard`` over ``shard_exact_recall_evals``,
   256 held-out queries, each shard's ground truth through
   ``l2_distance`` + ``topk``) and served; identity per-shard laws; a
   virtual-clock front door (256 single requests in dispatches of 8, one
   class, the shard dropped half way); ``begin`` of the staged and
   monolithic engines under sync debug mode "error".  Fails unless
   staged recall@10 >= 0.80, pipelined = per batch = monolithic bit for
   bit, flat = hierarchical (ids and d2), no id of the dead shard after
   the flip and every d2 finite, recall after the flip >= recall before
   - 1/8 - 0.08, the fitted laws serve recall@10 >= 0.80, identity laws
   equal the scalar law bit for bit, every door lane equals a direct
   search and none holds the dead shard's ids after the flip, no
   partials are offered, ``begin`` waits for nothing, and ``beam_step``
   pq and exact, ``l2_distance`` and ``topk`` launched on the path; with
   two cards or more, ``beam_step`` exact and pq launched once on the last
   card while the first is current must equal ``beam_step_ref`` bit for
   bit on integer data.  Prints each shard's build seconds, each run's
   QPS and batch p50 / p99 (staged and monolithic beside the serial
   one-stream walk's 30.7 / 23.8 ms a batch, not gated), mean granted
   budget and hops a query, the hierarchical merge's
   stream ms a batch (CUDA events around it, the host's launch gaps
   included) and one merge's device ms (queued behind a sleep kernel), each
   shard's fitted law and the fit's seconds;
3i. [base] the paper's two baselines on phase 3's rows: IVF-Flat over
   all 1M (``build_ivf``: nlist = N / 256 = 3,906, 6 k-means iterations,
   as ``benchmarks/recall_qps.py`` builds it), searched by the stream's
   first 1,000 queries (a cut for time: the padded layout scans nprobe x
   max_len rows a query) at nprobe 1, 2, 4, 8, 16 and 32 (the probe and
   the in-list select on ``topk``); HNSW built on the host over the first
   4,096 rows (m = 16, ef_construction = 100; the build is sequential
   Python, so 1M would take hours) and searched by all 10,000 queries
   against their ground truth over those rows at ef 16, 32, 64 and 96
   (the descent batched in torch, layer 0 one ``beam_step`` exact walk
   from each query's own entry).  Prints the build seconds, max_len and
   ``n_layers``, and per setting recall@10, QPS, mean points scanned and
   the valid share of the padded scan (IVF), mean hops and evaluations and
   the descent's host reads (HNSW).  Fails unless IVF recall never falls
   as nprobe grows and is >= 0.50 at 32, HNSW recall@10 at ef 96 is >=
   0.90, ``topk`` and ``beam_step`` exact launched on the path, one chunk
   of 256 queries at nprobe 8 gives the same ids, d2 and points scanned
   bit for bit with ``topk_ref`` as the select, and 256 queries' layer-0
   walks agree with ``beam_step_ref`` on the card (float rows hop by hop:
   d within 1e-5 relative, ids and visited words equal outside
   near-ties; an integer-valued copy of the rows: the whole walk bit for
   bit);
3j. [metric] the inner-product and cosine scans: ``brute_force_topk``
   (k = 10) of 1,000 queries over T2I's shape (ip, D = 200, N = 1M, cut
   from 1B) and GloVe-100's (cosine, D = 100, N = 1.2M), each product a
   float32 matmul and each select the ``topk`` kernel on negative
   values; prints each scan's ms.  Fails unless ``topk`` launched, 64
   queries of each agree with a float64 scan on the card (distances
   within 1e-4 of the row's scale, ids equal outside near-ties), and
   ``topk`` on negated integer products at the scan's chunk shape (ties,
   a row of -0.0, a row of both zeros) equals ``topk_ref`` bit for bit at
   k = 10, 100 and 300;
3k. [examples] ``examples/torch_quickstart.py``'s ``main`` on the card in
   this process (tiny-mixture, MCGI and Vamana), its launch counts
   printed; fails unless ``beam_step`` exact, ``l2_distance``, ``topk``
   and ``lid_estimate`` launched;
4. the LM paths, with the MCGI world freed; every model at full width and
   depth, weights drawn from --seed in bfloat16 on the card, the card's
   cache emptied between models.  qwen2-7b
   (``repro_torch/configs/qwen2_7b.py``: 28 layers, d_model 3584, 28 query
   and 4 KV heads, d_ff 18944, vocab 152064, QKV bias):
   [lm-serve] 8 prompts of 32 tokens teacher-forced through
   ``decode_step`` into a cache of 40, then greedy generation to 8 tokens
   a row (cut from 128 and 32 for time, printed);
   ``prefill(prompts)``'s last logits against the decode path's at
   position 31 within a relative L2 error of 5e-2;
   ``decode_attention``'s outputs at layer 0 of steps 0, 31 and 38 within
   3e-4 of its plain version on the same tensors; a second run
   must generate identical tokens; tokens/s, the step's p50 / p99 against
   its bound, aten calls a step;
   [lm-decode_32k] (B=16 of the cell's 128, S=32768) and [lm-long_500k]
   (B=1, S=524288): the cache filled with random bfloat16 values from the
   seed, kv_len = S - 1, 16 steps: the step's p50 / p99 ms and tokens/s
   against its bound, ``decode_attention``'s device ms per launch and its
   share of the step; fails unless ``decode_attention`` launched 28 times a
   step on each path.  Then the rest of the zoo:
   [lm-dsv2-serve] deepseek-v2-lite-16b (27 layers, MLA with a 512 + 64
   latent cache, 64 routed experts top-6 + 2 shared, the first layer
   dense; 15,706,484,224 parameters) at 8 prompts of 128 tokens, greedy
   to 32 (a cache of 160), MLA absorbed;
   at steps 0, 127 and 158 of the second run the naive form on a copy of
   the cache, within 5e-2 relative L2 of the absorbed logits with the
   absorbed step's experts replayed (the figure without the replay and
   the share of routing choices that then differ printed); ``prefill``
   at the published capacity factor (its share of dropped assignments
   printed) and at one where cap = the prompt's tokens (checked), whose
   last logits are printed against the decode path's with the share of
   (token, layer) routing choices that differ (not gated: a near-tied
   bfloat16 router flips experts); the gate is a float32 copy of the
   first 4 layers (prefill without drops vs decode within 5e-2);
   ``topk`` 26 launches a step (the router), ``decode_attention`` none;
   [lm-dsv2-decode_32k] and [lm-dsv2-long_500k] as qwen2's cells on the
   latent cache, decode_32k's batch cut from 128 to 32, the largest
   power of two whose cache fits beside the weights (printed as a cut);
   [lm-qwen3moe-serve] qwen3-moe-30b-a3b (48 layers, GQA 32 / 4 with q/k
   norm, 128 experts top-8), [lm-dscoder-serve] deepseek-coder-33b (62
   layers, GQA 56 / 8) and [lm-minicpm-serve] minicpm-2b (40 layers, MHA
   36 heads of 64, tied embeddings, the µP knobs): 8 prompts of 32 tokens,
   greedy to 8, twice with identical tokens, ``decode_attention`` launched
   ``n_layers`` times a step and its layer-0 outputs within 3e-4 of the
   plain version at two steps; the two dense ones hold prefill against
   decode within 5e-2 in bfloat16, qwen3-moe as deepseek-v2-lite does;
4b. the training paths (``repro_torch.training``, ``transformer.lm_loss``),
   each through ``make_train_step`` with float32 master weights drawn
   from --seed on the card, bfloat16 compute, each layer checkpointed
   (remat: ``forward`` checkpoints whenever autograd records), the optimizer
   config ``launch/train.py`` picks (``train_config``) and train_4k's
   sequence, S = 4096.  [lm-train] minicpm-2b at full width and depth (40
   layers, 2,725,173,504 parameters) at batch TRAIN_BATCH (cut from
   train_4k's 256: the largest power of two measured to fit; printed as a
   cut), TRAIN_STEPS steps of the WSD schedule: fails unless loss, ce and
   grad_norm are finite at every step, lr equals ``schedule_fn``'s value
   and the mean loss of the last two steps is below the first step's;
   prints step p50 / p99, tokens/s, the optimizer update's ms (CUDA
   events), peak ``max_memory_allocated``, the state's bytes and the
   model-FLOP share at 989 TFLOP/s bf16, its count written out (6 N a
   token, N the parameters a token multiplies: an MoE layer's top_k of
   its routed experts, an untied input embedding left out).  Beside the
   steps, in a process of its own with the card hidden, the dry run of
   the same step on the meta device (``python -m
   repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k --batch
   TRAIN_BATCH``): its state must hold exactly the card's state bytes
   (gate); its predicted peak and counted FLOPs are printed beside
   ``max_memory_allocated`` and the model FLOPs, with its seconds.
   [lm-train-moe] deepseek-v2-lite-16b at full width, its depth cut from
   27 to 4 (the dense first layer and 3 MoE layers; printed as a cut),
   batch 1, 8 steps of the cosine schedule (the launcher's warmup of 5):
   fails unless the metrics are finite, lr the schedule's, ``topk``
   launched twice a MoE layer a step (the forward and remat's recompute:
   6 a step) and, on a float32 copy of MoE layer 1 at 4,096 tokens, the
   router's gradient of the layer's output alone (aux_loss_weight = 0)
   through the kernel is within 1e-5 relative L2 of the one through
   ``topk_ref`` and non-zero; prints the curves of loss, ce, aux and
   grad_norm and the share of assignments the published capacity factor
   drops, then the same for two witness runs from the same weights:
   float32 compute on the same batches, and bfloat16 on uniform token
   ids (no Zipfian repeats).
   [examples-train] ``examples/torch_train_lm.py``'s ``main`` for 100
   steps: fails unless the loss improved and the step-100 checkpoint
   restores equal to the saved state bit for bit; prints tokens/s.
   [lm-train-moe-ep] the expert-parallel MoE schedule
   (``moe_apply_expert_parallel``) on ("data", "model") meshes over every
   visible card (on one card the ranks share it; under four cards, a rank
   a card).  Layer gates, a float32 copy of [lm-train-moe]'s MoE layer 1
   at 2 x 4,096 tokens on the meshes (1, 4) and (2, 2): at capacity
   factor 8.0 the output within 1e-5 relative L2 of ``moe_apply``'s one
   group, aux within 1e-5, no assignment dropped, and the gradients of x,
   the router and the three expert weights within 1e-4 relative L2 of the
   one-group path's (the router's non-zero); at the published 1.0 the
   output within 1e-5 of ``moe_apply`` over the same tokens laid out rank
   block by rank block, a group a rank (the same drop sets; the drop
   share printed).  Then 4 steps of [lm-train-moe]'s cell (the same
   weights, batches and schedule) with ``lm_loss(..., mesh)`` on the mesh
   (1, 4): metrics finite, lr the schedule's, ``topk`` launched ranks x 3
   MoE layers x 2 x 4 times; prints the step p50 and the first step's
   loss beside [lm-train-moe]'s (the drop sets differ by design: capacity
   is per rank), the bytes a step copies between cards (from the
   placement and the shapes) and each card's peak memory.  Each phase
   prints its seconds;
4c. the recsys and GNN zoo (``repro_torch.models.recsys`` / ``gnn``; no
   kernel of the port runs there, and each path prints that none
   launched).  [recsys-dlrm], [recsys-deepfm], [recsys-mind] and
   [recsys-bert4rec]: the smoke config's loss, every gradient, serve and
   retrieval on the card against the CPU from the same weights and batch
   (within 1e-4 relative L2); then the published config, weights from
   --seed: serve_p99 (512) and serve_bulk (262,144; BERT4Rec scored in
   chunks of 8,192 users; MIND and BERT4Rec score a 100-candidate slate),
   retrieval_cand over pad_to(1M, 512) candidates in one call, held to
   serve on 512 of the same candidates scored as a batch (within 1e-5
   relative L2), and 4 train steps at train_batch through
   ``make_train_step`` (AdamW lr 1e-3, no decay, as
   ``src/repro/launch/cells.py:311`` builds it; the ported pipelines'
   batches): loss, grad_norm and lr finite, lr the schedule's.  Cuts,
   printed: dlrm-mlperf's tables above 16,000,000 rows cut to it for
   serving and above 3,500,000 for training (its 96.1 GB table does not
   fit one card; training holds the table, its dense gradient, m, v and
   the update's temporaries), MIND's train batch 65,536 -> 32,768 (the
   in-batch logits), BERT4Rec's 65,536 -> 128 (the tied cloze logits).  [gnn-gat] gat-cora: the smoke config's node and
   graph losses, gradients and logits on the card against the CPU;
   full_graph_sm at Cora's published size (padded as cells.py pads it),
   30 steps at the reference's learning test's optimizer (const lr
   1e-2): fails unless the last loss is below 0.7 of the first and the
   accuracy above 0.5; ogb_products (its 61,859,140 edges halved once,
   printed: a step at the published size runs out of memory), minibatch_lg (a
   Reddit-sized synthetic graph on the host, 1,024 seeds at fanout
   (15, 10) into padded blocks; the sampler's host ms a block beside the
   step's) and molecule (128 graphs of 30 nodes), 4 steps each at the GAT
   cells' optimizer (lr 5e-3, weight decay 5e-4, cells.py:191).  Each
   prints step p50 / p99, examples (nodes, graphs) a second, peak
   ``max_memory_allocated`` and the state's bytes;
5. the kernels line (launches of each kernel on every path), then one JSON
   object per the port's contract, and the device line last.

Needs one CUDA card; there is no CPU path.

    python3 chip_smoke.py --trace-first-batch

also records the first batch of the tiered adaptive pipelined run under
``torch.profiler`` (host and device activity from the call to the first
result) and writes ``chiprun_out/first_batch_trace.txt`` (operators by
self host time and by device time, and the device's busy share of the
batch) with the Chrome trace beside it; that run's timings carry the
profiler's overhead.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12                # dense, tensor cores
TF32_TC_OPS_PER_S = 495e12                # dense, tensor cores
RECALL_FLOOR = 0.80
FLOAT_RTOL = 1e-5
KERNEL_N, KERNEL_Q = 1_000_000, 1024     # phase 2: serving shape
KNN_Q, KNN_N = 4096, 65536               # phase 2: one k-NN chunk
N_QUERIES, SERVE_BATCH = 10_000, 1000    # SIFT1M's query set, 10 batches
BUILD_BATCH = 2048                       # walk lanes per build step
M_PQ = 16                                # the config's m_pq is None (no PQ)
TIERED_TARGET = 0.80                     # PQ m=16 caps tiered recall ~0.835
SERVED_RECALL_SLACK = 0.03
CALIB_SAMPLE = 256
SLEEP_CYCLES = 100_000_000               # ~50 ms hold of the card (timing)
WALK_HOPS = 12                           # phase 2: hops of the capped walk
WALK_HOP_LIMIT = 200                     # phase 2: the walk to convergence
CSRC = "src/repro_torch/csrc/"
REPLACES = {"beam_step": "src/repro/kernels/beam_step.py:180",
            "l2_distance": "src/repro/kernels/l2_distance.py:38",
            "topk": "src/repro/kernels/topk.py:45",
            "lid_estimate": "src/repro/kernels/lid_kernel.py:36",
            "pq_scan": "src/repro/kernels/pq_scan.py:52",
            "decode_attention": "src/repro/kernels/decode_attention.py:70"}
SOURCES = {"beam_step": "beam_step.cu", "l2_distance": "l2_distance.cu",
           "topk": "topk.cu", "lid_estimate": "lid_kernel.cu",
           "pq_scan": "pq_scan.cu", "decode_attention": "decode_attention.cu"}
# The kernels of the MCGI main path (phase 3); phase 3c adds pq_scan, the
# LM paths decode_attention.
MCGI_KERNELS = ("beam_step.exact", "beam_step.pq", "l2_distance", "topk",
                "lid_estimate")
ATTN_TOL = 3e-4                          # the reference's kernel tolerance
PQ_Q, PQ_M, PQ_K = 256, 16, 256          # one adc_topk chunk at N = 1M
ADC_K = 10
ADC_K_WIDE = 100                         # recall@100's k
TOPK_K_RADIX = 2048                      # a k past the warp-select's 256
ROUTER_TOKENS = 1024                     # phase 2: the MoE routers' topk
ROUTER_TRAIN_TOKENS = 4096               # and the training router's (train_4k)
# Instructions of IEEE sqrtf + division + logf an element, counted as
# float32 operations for lid_estimate's bound.
LID_OPS_PER_ELEMENT = 40
# Phase 2's decode_attention serving shape: 8 rows, a cache of 128 prompt
# and 32 generated tokens ([lm-serve]'s shape before its cut below).
LM_BATCH, LM_PROMPT, LM_GEN = 8, 128, 32
# [lm-serve] (qwen2-7b) cut to 32 + 8 tokens a row (time: the training
# phases); [lm-dsv2-serve] keeps 128 + 32.
SERVE_PROMPT, SERVE_GEN = 32, 8
# Steps whose layer-0 decode_attention (and MLA's naive form) is held to
# the plain version: the first, the last teacher-forced and the last
# generated; [lm-serve]'s at its cut shape.
LM_CHECK_STEPS = (0, LM_PROMPT - 1, LM_PROMPT + LM_GEN - 2)
SERVE_CHECK_STEPS = (0, SERVE_PROMPT - 1, SERVE_PROMPT + SERVE_GEN - 2)
# Prefill vs decode logits in bfloat16: the CPU tests see 1.2e-2 relative
# L2 between the two frameworks over 2 layers; 28 layers get the most the
# check allows.
PREFILL_REL_L2 = 5e-2
# (cell, batch, S): decode_32k's batch is cut from 128 (224 GiB of cache).
LM_CELLS = (("decode_32k", 16, 32768), ("long_500k", 1, 524288))
LM_CELL_STEPS = 16
# The rest of the LM zoo, each at full width and depth: (arch, tag).
LM_ZOO = (("deepseek-v2-lite-16b", "dsv2"), ("qwen3-moe-30b-a3b", "qwen3moe"),
          ("deepseek-coder-33b", "dscoder"), ("minicpm-2b", "minicpm"))
# The MLA model's cells: (cell, batch, S).  decode_32k's batch is cut
# from 128 to 32, whose 32.6 GB latent cache fits beside 31.4 GB of
# weights (64 would not).
ZOO_CELLS = (("decode_32k", 32, 32768), ("long_500k", 1, 524288))
ZOO_PROMPT, ZOO_GEN = 32, 8            # the GQA three: kept short (time)
ZOO_ATTN_STEPS = (0, ZOO_PROMPT + ZOO_GEN - 2)
# MLA's naive form against the absorbed one in bfloat16, the absorbed
# step's experts replayed (a near-tied router otherwise flips experts):
# the CPU shows 1.1e-2 at 3 layers and 1.8e-2 at 27 (width 256).
MLA_FORM_REL_L2 = 5e-2
F32_LAYERS = 4                         # MoE prefill gate: a float32 copy
# [live] runs on the first 100,000 of phase 3's rows (a cut for time: its
# online build and its merge scale with the rows, and took 280 s of the
# smoke at 990,000; at 250,000 the smoke still took 940.1 s); the last
# 1,000 of them are inserted.
LIVE_ROWS = 100_000
LIVE_INSERTS, LIVE_INSERT_CALLS = 1_000, 10
LIVE_DELETES = 1_000
# [live]'s four stages each serve the stream's first 5 batches (5,000
# queries; cut from all 10 for time); the merge's traffic and
# the self-queries are not cut.
LIVE_STAGE_BATCHES = 5
LIVE_RECALL_FLOOR = 0.75
LIVE_SELF_FLOOR = 0.9     # self-queries the walk finds after the merge
LIVE_MERGE_DUTY = 0.5     # share of the merge's time spent serving
# The time limit for the whole run, and the ceiling a run is held to:
# host-paced phases move 20-40% between processes.
SMOKE_LIMIT_S, SMOKE_CEILING_S = 1200, 900
DIST_MESH, DIST_AXES = (2, 4), ("data", "model")    # [dist]: 8 shards
DIST_ALPHA = 1.2          # the reference's static alpha for shard builds
DIST_DEAD = 3             # the shard dropped mid-stream
DIST_DOOR_LANES, DIST_DOOR_GROUPS = 8, 32           # 256 single requests
# [dist]'s batch p50 (ms), staged per batch and monolithic, when its
# shards walked one after another on one stream of an H100 80GB HBM3 at
# 700 W (PERF.md section 5); printed beside this run's, not gated.
DIST_SERIAL_MS = (30.7, 23.8)


def sift1m():
    from repro_torch.configs.mcgi_datasets import DATASETS

    return DATASETS["mcgi-sift1m"]


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2

def walk_problem(kind, dev, n, q, width, r, integer: bool, seed: int,
                 max_hop_limit: int):
    """A random walk problem: dup-free adjacency, every lane entering at its
    own random node (beam slot 0, visited bit set), random budgets and hop
    limits."""
    import torch

    from repro_torch.core import build, search

    g = torch.Generator(device=dev).manual_seed(seed)
    adj = build.random_graph(n, r, g)
    if kind == "exact":
        d = sift1m().d
        if integer:
            table = torch.randint(-8, 9, (n, d), generator=g, device=dev).float()
            ctxs = torch.randint(-8, 9, (q, d), generator=g, device=dev).float()
        else:
            table = torch.randn((n, d), generator=g, device=dev)
            ctxs = torch.randn((q, d), generator=g, device=dev)
        ev = search._exact_eval(table)
    else:
        m, k = M_PQ, 256
        table = torch.randint(0, k, (n, m), generator=g, device=dev,
                              dtype=torch.uint8)
        if integer:
            ctxs = torch.randint(0, 64, (q, m, k), generator=g,
                                 device=dev).float()
        else:
            ctxs = torch.rand((q, m, k), generator=g, device=dev) * 64.0
        ev = search._pq_eval(table)
    entries = torch.randint(0, n, (q,), generator=g, device=dev,
                            dtype=torch.int32)
    beam_ids = torch.full((q, width), -1, dtype=torch.int32, device=dev)
    beam_d = torch.full((q, width), torch.inf, device=dev)
    beam_ids[:, 0] = entries
    beam_d[:, 0] = ev(ctxs, entries[:, None], None)[:, 0]
    visited = torch.zeros((q, (n + 31) // 32), dtype=torch.int32, device=dev)
    rows = torch.arange(q, device=dev)
    visited[rows, (entries >> 5).long()] = search._bits(entries)
    state = (beam_ids, beam_d, torch.zeros((q, width), dtype=torch.bool,
                                           device=dev),
             visited, torch.zeros((q,), dtype=torch.int32, device=dev),
             torch.zeros((q,), dtype=torch.int32, device=dev))
    budgets = torch.randint(width // 2, width + 1, (q,), generator=g,
                            device=dev, dtype=torch.int32)
    hop_limits = torch.randint(2, max_hop_limit + 1, (q,), generator=g,
                               device=dev, dtype=torch.int32)
    return state, ctxs, adj, table, budgets, hop_limits


def clone(state):
    return tuple(t.clone() for t in state)


def near_tie(d, rtol: float):
    """(Q,) bool: some two finite beam distances of the lane lie within
    rtol of each other."""
    import torch

    s = torch.sort(d, dim=1).values
    a, b = s[:, :-1], s[:, 1:]
    close = (b - a) <= rtol * b.abs().clamp_min(1e-30)
    return (close & torch.isfinite(b)).any(1)


def time_hop(fn, state0, hold: bool, reps: int = 20,
             rounds: int = 5) -> tuple[float, float]:
    """(device ms, host ms) of one hop from ``state0``: medians over
    ``rounds`` of the mean of ``reps`` calls back to back, each on a clone
    made beforehand.  ``hold``: a sleep kernel queued first holds the card
    until the host has enqueued every call, so the events time the device's
    work alone (raises if the host could not keep ahead).  Without it (the
    plain version, whose host waits on the card inside a call) the events
    span the calls as they ran."""
    import torch

    dev_ms, host_ms = [], []
    for _ in range(rounds):
        states = [clone(state0) for _ in range(reps)]
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(True) for _ in range(3)]
        ev[0].record()
        if hold:
            torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for st in states:
            fn(st)
        host = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if hold and host >= 0.9 * ev[0].elapsed_time(ev[1]):
            raise RuntimeError(f"{reps} calls took {host:.1f} ms of host "
                               f"time, longer than the sleep holding the "
                               f"card; the timing would include host work")
        dev_ms.append(ev[1].elapsed_time(ev[2]) / reps)
        host_ms.append(host / reps)
        del states
    return statistics.median(dev_ms), statistics.median(host_ms)


def walk_bound(kind, states, ctxs, adj, table, budgets, hop_limits):
    """Least time the card could take for the walk through ``states``
    (``states[0]`` the state at launch, ``states[h]`` after h hops; one
    hop: two states): the larger of the bytes it must move over the HBM
    rate and the operations it must do over the float32 rate.  Bytes: every
    lane's beam and counters read once, the beams of lanes that moved
    written once, each moving lane's context (exact query) read once, and
    per hop the adjacency row and visited words of each active lane and the
    rows (or codes and LUT entries) of each valid neighbour.  Operations:
    the distances of the valid neighbours and the sorted-beam merge,
    L*R + R*(R + log2 L) compares per active lane-hop.  Data-dependent:
    active lanes and valid neighbours as this run's data has them."""
    import math

    from repro_torch.kernels.ref import lane_active

    q, width = states[0][0].shape
    r = adj.shape[1]
    row = (table.shape[1] * 4 if kind == "exact"
           else table.shape[1] * (1 + 4))        # codes + LUT entries
    ctx = ctxs.shape[1] * 4 if kind == "exact" else 0
    beam = width * (4 + 4 + 1)
    lane_io = 4 * 4                              # budget, limit, hops, evals
    moved = int((states[-1][4] != states[0][4]).sum())
    nbytes = q * (beam + lane_io) + moved * (beam + 8 + ctx)
    ops = 0
    merge = width * r + r * (r + math.log2(width))
    for s0, s1 in zip(states[:-1], states[1:]):
        n_act = int(lane_active(s0[0], s0[2], s0[4], budgets,
                                hop_limits).sum())
        n_valid = int((s1[5] - s0[5]).sum())
        nbytes += n_act * (r * 4 + r * 4) + n_valid * (row + 4)
        ops += n_valid * (table.shape[1] * 3 if kind == "exact"
                          else table.shape[1]) + n_act * merge
    return bound_of(nbytes, ops)


def check_kernel(kind, dev, n, q, width, r, hops: int, seed: int):
    """Phase 2 for one kind: bit identity on integer data (one hop per
    launch, and the resident walk), tolerance on float data, timings and
    bounds.  Returns the kernel's record: its ``ms``, ``plain_ms`` and
    ``bound_ms`` are per hop of the walk, as the main path launches it."""
    import torch

    from repro_torch.kernels import ops, ref

    st0, ctxs, adj, table, budgets, hop_limits = walk_problem(
        kind, dev, n, q, width, r, True, seed, hops)
    st_k, st_p = clone(st0), st0
    for h in range(hops):
        st_k = ops.beam_step(st_k, ctxs, adj, table, budgets, hop_limits,
                             kind=kind)
        st_p = ref.beam_step_ref(st_p, ctxs, adj, table, budgets, hop_limits,
                                 kind=kind)
        sync(dev)
        for name, a, b in zip(("ids", "d", "exp", "visited", "hops", "evals"),
                              st_k, st_p):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(a.shape[0], -1).any(1).sum())
                raise AssertionError(f"beam_step[{kind}] hop {h}: {name} "
                                     f"differs from the plain version in "
                                     f"{bad} lanes (integer data)")
    if not bool((st_p[4] <= hop_limits).all()):
        raise AssertionError("a lane walked past its hop limit")
    log(f"[phase2] beam_step[{kind}] integer data: {hops} hops bit-identical "
        f"(Q={q} L={width} R={r} N={n}; lanes active at the end: "
        f"{int(ref.lane_active(st_p[0], st_p[2], st_p[4], budgets, hop_limits).sum())})")

    # Float data: one hop at a time from the same input state.
    st, ctxs_f, adj_f, table_f, b_f, hl_f = walk_problem(
        kind, dev, n, q, width, r, False, seed + 1, hops)
    max_err, tie_lanes = 0.0, 0
    for h in range(hops):
        a = ops.beam_step(clone(st), ctxs_f, adj_f, table_f, b_f, hl_f,
                          kind=kind)
        b = ref.beam_step_ref(st, ctxs_f, adj_f, table_f, b_f, hl_f,
                              kind=kind)
        same = (a[0] == b[0]).all(1) & (a[3] == b[3]).all(1)
        tie = near_tie(st[1], FLOAT_RTOL) | near_tie(b[1], FLOAT_RTOL)
        if bool((~same & ~tie).any()):
            raise AssertionError(f"beam_step[{kind}] float hop {h}: ids or "
                                 f"visited differ in a lane without a tie")
        fin = torch.isfinite(b[1]) & same[:, None]
        if not torch.equal(torch.isfinite(a[1]) & same[:, None], fin):
            raise AssertionError(f"beam_step[{kind}] float hop {h}: inf "
                                 f"pattern differs")
        err = (a[1] - b[1]).abs()[fin]
        if err.numel():
            if not bool((err <= FLOAT_RTOL * b[1].abs()[fin]).all()):
                raise AssertionError(f"beam_step[{kind}] float hop {h}: "
                                     f"beam_d beyond rtol {FLOAT_RTOL}")
            max_err = max(max_err, float(err.max()))
        tie_lanes += int((~same).sum())
        st = a
    log(f"[phase2] beam_step[{kind}] float data: beam_d within rtol "
        f"{FLOAT_RTOL} (max abs err {max_err:.3g}); {tie_lanes} lane-hops "
        f"differ, each at a near-tie")

    # The resident walk, bit for bit on integer data: one launch capped at
    # WALK_HOPS hops (hop limits that never bind), and one launch to
    # convergence (hop limits up to WALK_HOP_LIMIT, so lanes freeze both at
    # their limit and at a closed frontier).
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    far = torch.full_like(hop_limits, 1 << 20)
    deep = torch.randint(2, WALK_HOP_LIMIT + 1, (q,), generator=g,
                         device=dev, dtype=torch.int32)
    for cap, limits, what in ((WALK_HOPS, far, f"{WALK_HOPS} hops"),
                              (ops.MAX_HOPS, deep, "to convergence")):
        want, left = ref.beam_walk_ref(st0, ctxs, adj, table, budgets,
                                       limits, kind=kind, max_hops=cap)
        count = torch.zeros((1,), dtype=torch.int32, device=dev)
        got = ops.beam_walk(clone(st0), ctxs, adj, table, budgets, limits,
                            kind=kind, max_hops=cap, active_count=count)
        sync(dev)
        for name, a, b in zip(("ids", "d", "exp", "visited", "hops",
                               "evals"), got, want):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(a.shape[0], -1).any(1).sum())
                raise AssertionError(f"beam_walk[{kind}] {what}: {name} "
                                     f"differs from beam_step_ref hop by "
                                     f"hop in {bad} lanes (integer data)")
        if int(count) != int(left.sum()):
            raise AssertionError(f"beam_walk[{kind}] {what}: counted "
                                 f"{int(count)} movable lanes, not "
                                 f"{int(left.sum())}")
        log(f"[phase2] beam_walk[{kind}] one launch {what}: bit-identical "
            f"to beam_step_ref hop by hop (integer data; hops per lane "
            f"{int(want[4].min())}-{int(want[4].max())}, lanes left movable "
            f"{int(count)})")
        del want, got

    # Timing from a mid-walk state, every lane active: one hop per launch,
    # and one launch of WALK_HOPS hops (per hop).
    full = torch.full_like(budgets, width)
    mid = st0
    for _ in range(4):
        mid = ref.beam_step_ref(mid, ctxs, adj, table, full, far, kind=kind)
    chain = [mid]
    for _ in range(WALK_HOPS):
        chain.append(ref.beam_step_ref(chain[-1], ctxs, adj, table, full,
                                       far, kind=kind))
    if int((chain[-1][4] - mid[4]).min()) != WALK_HOPS:
        raise AssertionError("a lane froze inside the timed walk")

    def hop(s):
        return ops.beam_step(s, ctxs, adj, table, full, far, kind=kind)

    def walk(s):
        return ops.beam_walk(s, ctxs, adj, table, full, far, kind=kind,
                             max_hops=WALK_HOPS)

    def plain(s):
        return ref.beam_step_ref(s, ctxs, adj, table, full, far, kind=kind)

    for _ in range(3):                                   # warm-up
        hop(clone(mid))
        walk(clone(mid))
        plain(mid)
    ms, host_ms = time_hop(hop, mid, hold=True)
    walk_ms, walk_host = time_hop(walk, mid, hold=True)
    plain_ms, _ = time_hop(plain, mid, hold=False)
    bound = walk_bound(kind, chain[:2], ctxs, adj, table, full, far)
    wbound = walk_bound(kind, chain, ctxs, adj, table, full, far)
    per_hop, wbound_hop = walk_ms / WALK_HOPS, wbound[0] / WALK_HOPS
    log(f"[phase2] beam_step[{kind}] one hop, {q} lanes: kernel {ms:.4f} ms "
        f"on the device ({host_ms:.4f} ms of wrapper host time per launch), "
        f"plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    log(f"[phase2] beam_walk[{kind}] {WALK_HOPS} hops in one launch, {q} "
        f"lanes: {walk_ms:.4f} ms on the device = {per_hop:.4f} ms per hop "
        f"(one-hop launch {ms:.4f}; {walk_host:.4f} ms of host time per "
        f"launch), bound {wbound[0]:.4f} ms = {wbound_hop:.4f} per hop "
        f"({wbound[1]})")
    del st0, st_k, st_p, st, adj_f, table_f, chain
    return {"name": f"beam_step.{kind}", "route": "cuda",
            "source": CSRC + SOURCES["beam_step"],
            "replaces": REPLACES["beam_step"], "launches": None,
            "max_abs_err": max_err,
            "ms": per_hop, "plain_ms": plain_ms, "bound_ms": wbound_hop,
            "bound_by": wbound[1], "library_ms": None,
            "one_hop_launch": {"ms": ms, "host_ms": host_ms,
                               "bound_ms": bound[0]},
            "walk": {"hops": WALK_HOPS, "ms": walk_ms, "host_ms": walk_host},
            "verdict": "bit-identical on integer data (hop by hop, a "
                       f"{WALK_HOPS}-hop launch, a launch to convergence); "
                       "float within rtol 1e-5"}


def adj_rows(adj, u):
    """``adj[u]`` with all-INVALID rows where u is INVALID (what the block
    store's ``fetch_adj`` returns for a frontier)."""
    import torch

    return torch.where((u >= 0)[:, None], adj[u.clamp_min(0).long()],
                       torch.full_like(adj[:1], -1))


def hop_rows_bound(st0, st1, width_m: int, r: int):
    """Least time of one row-fed hop from ``st0`` to ``st1``: bytes over
    the HBM rate, or the merge's compares over the float32 rate.  Bytes:
    every lane's beam (ids, d, exp) and counters read, its frontier and
    activity read and written; per active lane its beam and counters
    written, its row (R ids) and R visited words read; per valid neighbour
    its code row, its M LUT entries and its visited word written.  Active
    lanes and valid neighbours as this run's data has them."""
    import math

    q, width = st0[0].shape
    beam = width * (4 + 4 + 1)
    moved = st1[4] != st0[4]
    n_act = int(moved.sum())
    n_valid = int((st1[5] - st0[5]).sum())
    nbytes = (q * (beam + 4 * 4 + 2 * (4 + 1)) + n_act * (beam + 8 + r * 8)
              + n_valid * (width_m * (1 + 4) + 4))
    ops = n_act * (width * r + r * (r + math.log2(width)))
    return bound_of(nbytes, ops)


def check_hop_rows(dev, n, q, width, r, hops: int, seed: int) -> dict:
    """Phase 2 for the out-of-core walk's row-fed hop (kind "pq"): the
    select (every lane inactive, both ways of saying it), then ``hops``
    hops with each lane's row gathered from the adjacency, bit-identical to
    ``beam_hop_rows_ref`` on integer data (states, frontiers and activity
    after every launch), one hop from shuffled (unsorted) beams, float LUTs
    within FLOAT_RTOL; timed.  Returns the kernel's record, per launch."""
    import torch

    from repro_torch.kernels import ops, ref

    names = ("ids", "d", "exp", "visited", "hops", "evals", "u", "active")

    def same(got, want, what):
        for name, a, b in zip(names, (*got[0], got[1], got[2]),
                              (*want[0], want[1], want[2])):
            if not torch.equal(a, b):
                bad = int((a != b).reshape(a.shape[0], -1).any(1).sum())
                raise AssertionError(f"beam_step[pq_rows] {what}: {name} "
                                     f"differs from beam_hop_rows_ref in "
                                     f"{bad} lanes (integer data)")

    st0, ctxs, adj, table, budgets, hop_limits = walk_problem(
        "pq", dev, n, q, width, r, True, seed, hops)
    want = ref.beam_hop_rows_ref(st0, None, None, None, None, None, budgets,
                                 hop_limits, kind="pq")
    got = ops.beam_hop_rows(clone(st0), None, None, None, None, None,
                            budgets, hop_limits, kind="pq")
    sync(dev)
    same(got, want, "select")
    none = torch.zeros_like(want[2])
    got = ops.beam_hop_rows(clone(st0), want[1], none, adj_rows(adj, want[1]),
                            ctxs, table, budgets, hop_limits, kind="pq")
    sync(dev)
    same(got, want, "a hop with every lane inactive")
    got = (clone(want[0]), want[1].clone(), want[2].clone())
    for h in range(hops):
        rows = adj_rows(adj, want[1])
        want = ref.beam_hop_rows_ref(want[0], want[1], want[2], rows, ctxs,
                                     table, budgets, hop_limits, kind="pq")
        got = ops.beam_hop_rows(got[0], got[1], got[2], rows, ctxs, table,
                                budgets, hop_limits, kind="pq")
        sync(dev)
        same(got, want, f"hop {h}")
    left = int(want[2].sum())
    # Shuffled beams: the general rank path of the merge.
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    mid = ref.beam_hop_rows_ref(st0, None, None, None, None, None,
                                budgets, torch.full_like(hop_limits, 1 << 20),
                                kind="pq")
    for _ in range(4):
        mid = ref.beam_hop_rows_ref(
            mid[0], mid[1], mid[2], adj_rows(adj, mid[1]), ctxs, table,
            budgets, torch.full_like(hop_limits, 1 << 20), kind="pq")
    perm = torch.argsort(torch.rand(mid[0][0].shape, generator=g,
                                    device=dev), dim=1)
    shuf = tuple(torch.gather(t, 1, perm) if i < 3 else t
                 for i, t in enumerate(mid[0]))
    far = torch.full_like(hop_limits, 1 << 20)
    rows = adj_rows(adj, mid[1])
    want = ref.beam_hop_rows_ref(shuf, mid[1], mid[2], rows, ctxs, table,
                                 budgets, far, kind="pq")
    got = ops.beam_hop_rows(clone(shuf), mid[1], mid[2], rows, ctxs, table,
                            budgets, far, kind="pq")
    sync(dev)
    same(got, want, "one hop from shuffled beams")
    log(f"[phase2] beam_step[pq_rows] integer data: the select (both "
        f"forms), {hops} row-fed hops and a hop from shuffled beams "
        f"bit-identical to beam_hop_rows_ref, frontiers and activity "
        f"included (Q={q} L={width} R={r} N={n}; lanes active at the end: "
        f"{left})")

    # Float LUTs, one hop at a time from the plain version's state.
    st, ctxs_f, adj_f, table_f, b_f, hl_f = walk_problem(
        "pq", dev, n, q, width, r, False, seed + 1, hops)
    cur = ref.beam_hop_rows_ref(st, None, None, None, None, None, b_f, hl_f,
                                kind="pq")
    max_err, tie_lanes = 0.0, 0
    for h in range(hops):
        rows = adj_rows(adj_f, cur[1])
        a = ops.beam_hop_rows(clone(cur[0]), cur[1], cur[2], rows, ctxs_f,
                              table_f, b_f, hl_f, kind="pq")
        b = ref.beam_hop_rows_ref(cur[0], cur[1], cur[2], rows, ctxs_f,
                                  table_f, b_f, hl_f, kind="pq")
        same_l = ((a[0][0] == b[0][0]).all(1) & (a[0][3] == b[0][3]).all(1)
                  & (a[1] == b[1]) & (a[2] == b[2]))
        tie = near_tie(cur[0][1], FLOAT_RTOL) | near_tie(b[0][1], FLOAT_RTOL)
        if bool((~same_l & ~tie).any()):
            raise AssertionError(f"beam_step[pq_rows] float hop {h}: ids, "
                                 f"visited or frontier differ in a lane "
                                 f"without a tie")
        fin = torch.isfinite(b[0][1]) & same_l[:, None]
        if not torch.equal(torch.isfinite(a[0][1]) & same_l[:, None], fin):
            raise AssertionError(f"beam_step[pq_rows] float hop {h}: inf "
                                 f"pattern differs")
        err = (a[0][1] - b[0][1]).abs()[fin]
        if err.numel():
            if not bool((err <= FLOAT_RTOL * b[0][1].abs()[fin]).all()):
                raise AssertionError(f"beam_step[pq_rows] float hop {h}: "
                                     f"beam_d beyond rtol {FLOAT_RTOL}")
            max_err = max(max_err, float(err.max()))
        tie_lanes += int((~same_l).sum())
        cur = b
    log(f"[phase2] beam_step[pq_rows] float data: beam_d within rtol "
        f"{FLOAT_RTOL} (max abs err {max_err:.3g}); {tie_lanes} lane-hops "
        f"differ, each at a near-tie")

    # Timing from a mid-walk state, every lane active.
    full = torch.full_like(budgets, width)
    mid = ref.beam_hop_rows_ref(st0, None, None, None, None, None, full, far,
                                kind="pq")
    for _ in range(4):
        mid = ref.beam_hop_rows_ref(mid[0], mid[1], mid[2],
                                    adj_rows(adj, mid[1]), ctxs, table, full,
                                    far, kind="pq")
    if not bool(mid[2].all()):
        raise AssertionError("a lane froze before the timed hop")
    rows = adj_rows(adj, mid[1])
    after = ref.beam_hop_rows_ref(mid[0], mid[1], mid[2], rows, ctxs, table,
                                  full, far, kind="pq")

    def hop(s):
        return ops.beam_hop_rows(s, mid[1], mid[2], rows, ctxs, table, full,
                                 far, kind="pq")

    def plain(s):
        return ref.beam_hop_rows_ref(s, mid[1], mid[2], rows, ctxs, table,
                                     full, far, kind="pq")

    for _ in range(3):                                   # warm-up
        hop(clone(mid[0]))
        plain(mid[0])
    ms, host_ms = time_hop(hop, mid[0], hold=True)
    plain_ms, _ = time_hop(plain, mid[0], hold=False)
    bound = hop_rows_bound(mid[0], after[0], ctxs.shape[1], r)
    log(f"[phase2] beam_step[pq_rows] one row-fed hop, {q} lanes: kernel "
        f"{ms:.4f} ms on the device ({host_ms:.4f} ms of wrapper host time "
        f"per launch), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]})")
    del st0, st, ctxs_f, adj_f, table_f, mid, after, shuf
    return {"name": "beam_step.pq_rows", "route": "cuda",
            "source": CSRC + SOURCES["beam_step"],
            "replaces": REPLACES["beam_step"], "launches": None,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "host_ms": host_ms,
            "verdict": "bit-identical on integer data (the select, "
                       f"{hops} row-fed hops, shuffled beams); float within "
                       "rtol 1e-5"}


def time_calls(fn, hold: bool, reps: int = 20,
               rounds: int = 5) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn()``: medians over ``rounds`` of
    the mean of ``reps`` calls back to back, timed as :func:`time_hop`
    does (``hold``: queued behind a sleep kernel, device work alone)."""
    return time_hop(lambda _: fn(), (), hold, reps, rounds)


def record(name, max_err, ms, plain_ms, library_ms, bound, verdict) -> dict:
    base = name.split(".")[0]
    return {"name": name, "route": "cuda", "source": CSRC + SOURCES[base],
            "replaces": REPLACES[base], "launches": None,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, "verdict": verdict}


def bound_of(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sift_near_duplicates(dev, g) -> tuple[float, float]:
    """``l2_distance`` at SIFT scale (coordinates in [0, 255], |q|^2 near
    2.8e6) on 1024 queries against a near duplicate of each (coordinates
    moved by up to 40: d2 about 2% of |q|^2) and 7168 far points: within
    rtol 1e-4 / atol 1e-3 of float64, and no more than 4x the plain float32
    version's error.  Returns both max abs errors."""
    import torch

    from repro_torch.kernels import ops, ref

    q = torch.rand((1024, 128), generator=g, device=dev) * 255
    near = q + (torch.rand(q.shape, generator=g, device=dev) - 0.5) * 80
    far = torch.rand((7168, 128), generator=g, device=dev) * 255
    x = torch.cat([near.clamp(0, 255), far])
    q64, x64 = q.double(), x.double()
    truth = ((q64 * q64).sum(1, keepdim=True) - 2 * q64 @ x64.T
             + (x64 * x64).sum(1)).clamp_min(0)
    got = ops.bulk_l2(q, x).double()
    plain = ref.l2_distance_ref(q, x).double()
    sync(dev)
    if not torch.allclose(got, truth, rtol=1e-4, atol=1e-3):
        raise AssertionError("l2_distance on SIFT-scale near duplicates "
                             "differs from float64 beyond rtol 1e-4")
    err = float((got - truth).abs().max())
    err_plain = float((plain - truth).abs().max())
    if err > 4 * err_plain:
        raise AssertionError(f"l2_distance error {err:.3g} on SIFT-scale "
                             f"near duplicates exceeds 4x the plain "
                             f"version's {err_plain:.3g}")
    return err, err_plain


def topk_timed(dist, k: int, what: str) -> dict:
    """``topk`` of ``dist`` at ``k``: held to the plain version (values
    bitwise, ids equal), then timed beside the plain version, the library
    call (``torch.topk``) and the bound; one ``[phase2] topk`` line."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import topk as topk_kernel

    nq, n = dist.shape
    gv, gi = ops.topk(dist, k)
    wv, wi = ref.topk_ref(dist, k)
    sync(dist.device)
    if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
        bad = int(((gv != wv) | (gi != wi)).any(1).sum())
        raise AssertionError(f"topk at {nq}x{n} k={k} ({what}): {bad} rows "
                             f"differ from the plain version")
    del gv, gi, wv, wi
    slots = topk_kernel.warp_slots(k)
    if slots == 0:
        how = "radix select, a block a row"
    else:
        segs = -(-n // topk_kernel.segment_length(nq, n, slots))
        how = f"warp-select, {segs} segment{'s' if segs > 1 else ''} a row"
    ms, host = time_calls(lambda: ops.topk(dist, k), hold=True)
    plain_ms, _ = time_calls(lambda: ref.topk_ref(dist, k), hold=False)
    lib_ms, _ = time_calls(lambda: torch.topk(dist, k, dim=1, largest=False),
                           hold=False)
    bound = bound_of(nq * n * 4 + nq * k * 8, nq * n)
    log(f"[phase2] topk {nq}x{n} k={k} ({what}; {how}): values bitwise and "
        f"ids equal to the plain version; kernel {ms:.4f} ms on the device "
        f"({host:.4f} ms host), plain {plain_ms:.4f} ms, library "
        f"{lib_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return {"shape": [nq, n, k], "what": what, "route": how, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound[0],
            "bound_by": bound[1]}


def topk_adc_shape(dev, g, d: int) -> list[dict]:
    """``topk`` at [adc]'s chunk shape (256 queries x 1M, rows cut into
    segments), k = 10 and 100: held to the plain version, then timed."""
    import torch

    from repro_torch.kernels import ops

    dist = ops.bulk_l2(torch.randn((PQ_Q, d), generator=g, device=dev),
                       torch.randn((KERNEL_N, d), generator=g, device=dev))
    return [topk_timed(dist, k, "[adc]'s chunk") for k in (ADC_K, ADC_K_WIDE)]


def topk_router_shapes(dev, g) -> list[dict]:
    """``topk`` at the MoE routers' shapes: 1024 tokens x 64 experts at
    k = 6 (deepseek-v2-lite) and x 128 at k = 8 (qwen3-moe), on negated
    softmax probabilities as the router passes them, with planted ties (a
    uniform row, a row of three levels, a row of zeros: -0.0 after the
    negation); held to ``topk_ref`` bit for bit, then timed."""
    import torch

    out = []
    for e, k in ((64, 6), (128, 8)):
        probs = torch.softmax(torch.randn((ROUTER_TOKENS, e), generator=g,
                                          device=dev) * 2, dim=-1)
        probs[0] = 1.0 / e
        levels = torch.randint(0, 3, (e,), generator=g, device=dev).float()
        probs[1] = (levels + 1) / (levels + 1).sum()
        probs[2] = 0.0
        out.append(topk_timed(-probs, k, f"router, {e} experts"))
    return out


def check_bulk_kernels(dev, seed: int) -> list[dict]:
    """Phase 2 for ``l2_distance``, ``topk`` and ``lid_estimate`` at the
    shapes the main path gives them: one k-NN chunk of the build (4096
    points against 65536, D=128, k=17; the ground truth's k=10) and the
    LID estimate of 1M points at k=16."""
    import torch

    from repro_torch.core import distance
    from repro_torch.kernels import ops, ref

    cfg = sift1m()
    out = []
    g = torch.Generator(device=dev).manual_seed(seed + 101)
    q = torch.randn((KNN_Q, cfg.d), generator=g, device=dev)
    x = torch.randn((KNN_N, cfg.d), generator=g, device=dev)

    # l2_distance, float32 at the k-NN shape.
    got = ops.bulk_l2(q, x)
    want = ref.l2_distance_ref(q, x)
    sync(dev)
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        raise AssertionError("l2_distance float32 differs from the plain "
                             "version beyond rtol 1e-4 / atol 1e-3")
    err = float((got - want).abs().max())
    del want
    # Integer operands in SIFT's range (0-255) at the k-NN shape: exact.
    qi = torch.randint(0, 256, q.shape, generator=g, device=dev).float()
    xi = torch.randint(0, 256, x.shape, generator=g, device=dev).float()
    xi[:KNN_Q // 2] = qi[:KNN_Q // 2]
    if not torch.equal(ops.bulk_l2(qi, xi), ref.l2_distance_ref(qi, xi)):
        raise AssertionError("l2_distance on integer operands differs from "
                             "the plain version")
    del qi, xi
    err_sift, err_sift_plain = sift_near_duplicates(dev, g)
    qb, xb = q[:1024].bfloat16(), x[:8192].bfloat16()
    got_b, want_b = ops.bulk_l2(qb, xb), ref.l2_distance_ref(qb, xb)
    sync(dev)
    if not torch.allclose(got_b, want_b, rtol=2e-2, atol=2e-1):
        raise AssertionError("l2_distance bfloat16 differs from the plain "
                             "version beyond rtol 2e-2 / atol 2e-1")
    err_b = float((got_b - want_b).abs().max())
    ms, host = time_calls(lambda: ops.bulk_l2(q, x), hold=True)
    plain_ms, _ = time_calls(lambda: ref.l2_distance_ref(q, x), hold=False)
    lib_ms, _ = time_calls(lambda: distance.squared_l2(q, x), hold=False)
    nq, n, d = KNN_Q, KNN_N, cfg.d
    nbytes = (nq + n) * d * 4 + nq * n * 4
    # The cross term as the kernel takes it: three TF32 products (3xTF32)
    # on the tensor cores; beside it, the bound of any float32 SIMT kernel.
    bound = bound_of(nbytes, 3 * 2 * nq * n * d, TF32_TC_OPS_PER_S)
    simt = bound_of(nbytes, 2 * nq * n * d + 2 * (nq + n) * d + 3 * nq * n)
    log(f"[phase2] l2_distance {nq}x{n}x{d} float32: within rtol 1e-4 (max "
        f"abs err {err:.3g}); integer operands (0-255) bit-identical; SIFT-"
        f"scale near duplicates within rtol 1e-4 of float64 (max abs err "
        f"{err_sift:.3g}, plain float32 {err_sift_plain:.3g}); bfloat16 "
        f"1024x8192x{d} within 2e-2 (max abs err {err_b:.3g}); kernel "
        f"{ms:.4f} ms on the device ({host:.4f} ms host), plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]}, 3xTF32 on the tensor cores; float32 SIMT bound "
        f"{simt[0]:.4f} ms)")
    rec = record("l2_distance", err, ms, plain_ms, lib_ms, bound,
                 "float32 within rtol 1e-4 / atol 1e-3; integer operands "
                 "bit-identical; SIFT-scale near duplicates within rtol "
                 "1e-4 of float64; bfloat16 within 2e-2 / 2e-1")
    rec["bound_fp32_simt_ms"] = simt[0]
    out.append(rec)

    # topk on that matrix, plus planted ties, a row with fewer than k
    # finite entries, and a few rows cut into segments.
    d = got
    del got, got_b, want_b
    tied = d[:8].clone()
    tied[0] = torch.randint(0, 4, (n,), generator=g, device=dev).float()
    tied[1] = torch.inf
    tied[1, torch.randperm(n, generator=g, device=dev)[:5]] = 3.0
    for k in (17, cfg.k):
        for what, m in (("k-NN chunk", d), ("ties + short row", tied[:2]),
                        ("8 rows in segments", tied)):
            gv, gi = ops.topk(m, k)
            wv, wi = ref.topk_ref(m, k)
            sync(dev)
            if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
                bad = int(((gv != wv) | (gi != wi)).any(1).sum())
                raise AssertionError(f"topk k={k} ({what}): {bad} rows "
                                     f"differ from the plain version")
        log(f"[phase2] topk k={k}: values bitwise and ids equal to the plain "
            f"version ({KNN_Q}x{KNN_N}; planted ties; a row with 5 finite "
            f"entries; 8 rows in segments)")
    t = topk_timed(d, 17, "k-NN chunk")
    rec = record("topk", 0.0, t["ms"], t["plain_ms"], t["library_ms"],
                 (t["bound_ms"], t["bound_by"]),
                 "values bitwise, ids equal (k = 10, 17, 100, 101, "
                 f"{TOPK_K_RADIX}; the routers' 1024 x 64, k = 6 and "
                 f"1024 x 128, k = 8; the training router's 4096 x 64, "
                 f"k = 6, its value gradient too)")
    # Past the 64-key list: recall@100's k (and 101, as a k-NN asks for
    # k + 1) at the k-NN shape, and the radix select past 256 on a few
    # rows: planted ties, a row of 5 finite entries padded by +inf, NaN.
    wide = [topk_timed(d, kk, "k-NN chunk") for kk in (ADC_K_WIDE,
                                                       ADC_K_WIDE + 1)]
    few = torch.cat([d[:5], tied[:2], d[5:6]])
    nan = torch.rand((n,), generator=g, device=dev) < 0.3
    nan[:TOPK_K_RADIX] = False
    few[7, nan] = torch.nan
    wide.append(topk_timed(few, TOPK_K_RADIX, "8 rows: ties, +inf, NaN"))
    del d, tied, q, x, few
    rec["adc_shape"] = topk_adc_shape(dev, g, cfg.d)
    rec["large_k"] = wide
    rec["router"] = topk_router_shapes(dev, g)
    rec["train_router"] = topk_train_router(dev, g)
    out.append(rec)

    # lid_estimate on 1M ascending k=16 rows, duplicates included.
    b, kk = sift1m().n, 16
    d2 = torch.sort(torch.rand((b, kk), generator=g, device=dev) + 0.01,
                    dim=1).values
    d2[:1000, :3] = 0.0
    got, want = ops.lid_estimate(d2), ref.lid_ref(d2)
    sync(dev)
    if not torch.allclose(got, want, rtol=1e-4, atol=0.0):
        raise AssertionError("lid_estimate differs from the plain version "
                             "beyond rtol 1e-4")
    err = float((got - want).abs().max())
    # k = 1 (every estimate the -1/4096 cap) and k = 100 (a row in chunks
    # of 32), zero distances included.
    errs = {}
    for bk, kk2 in ((b, 1), (100_000, 100)):
        d2k = torch.sort(torch.rand((bk, kk2), generator=g, device=dev)
                         + 0.01, dim=1).values
        d2k[:1000, :max(1, kk2 // 4)] = 0.0
        d2k[1000] = 0.0
        gk, wk = ops.lid_estimate(d2k), ref.lid_ref(d2k)
        sync(dev)
        if not torch.allclose(gk, wk, rtol=1e-4, atol=0.0):
            raise AssertionError(f"lid_estimate {bk}x{kk2} differs from the "
                                 f"plain version beyond rtol 1e-4")
        errs[kk2] = float((gk - wk).abs().max())
        del d2k, gk, wk
    ms, host = time_calls(lambda: ops.lid_estimate(d2), hold=True)
    plain_ms, _ = time_calls(lambda: ref.lid_ref(d2), hold=False)
    # Bytes, or about 40 float32 operations an element (the IEEE sqrtf,
    # division and logf) at the float32 peak, whichever is longer.
    bound = bound_of(b * kk * 4 + b * 4, LID_OPS_PER_ELEMENT * b * kk)
    log(f"[phase2] lid_estimate {b}x{kk}: within rtol 1e-4 (max abs err "
        f"{err:.3g}); {b}x1 and 100000x100 within rtol 1e-4 (max abs err "
        f"{errs[1]:.3g}, {errs[100]:.3g}); kernel {ms:.4f} ms on the device "
        f"({host:.4f} ms host), plain {plain_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]})")
    out.append(record("lid_estimate", max(err, *errs.values()), ms, plain_ms,
                      None, bound, "within rtol 1e-4 at k = 1, 16, 100"))
    return out


def qwen2():
    from repro_torch.configs import qwen2_7b

    return qwen2_7b.CONFIG


def attention_bound(lens, s: int, hq: int, hkv: int, d: int,
                    kv_bytes: int) -> tuple[float, str]:
    """Least time for one decode_attention launch: K and V up to each row's
    kv_len (clamped to S) read once, q (float32) read and the float32
    output written once; 4 flops per (valid position, query head, dim) at
    the bf16 tensor-core rate, where the kernel runs them."""
    valid = int(lens.clamp(0, s).sum())
    b = lens.shape[0]
    nbytes = 2 * valid * hkv * d * kv_bytes + b * hq * d * (4 + 4)
    return bound_of(nbytes, 4 * valid * hq * d, BF16_TC_OPS_PER_S)


def sdpa_time(q, k, v, lens):
    """Device time of F.scaled_dot_product_attention (GQA, boolean mask) on
    (B, H, S, d) views of the same tensors, or None where the installed
    PyTorch refuses the call."""
    import torch
    import torch.nn.functional as F

    s = k.shape[1]
    mask = (torch.arange(s, device=k.device)[None, :]
            < lens[:, None])[:, None, None, :]
    q4, k4, v4 = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              enable_gqa=True)
    try:
        call()
        sync(k.device)
    except RuntimeError as e:         # the yardstick only, never the port
        log(f"[phase2] decode_attention library call refused: {e}")
        return None
    return time_calls(call, hold=False)[0]


def attention_check(where: str, q, k, v, lens, got=None) -> float:
    """Hold decode_attention's output (launched here unless ``got`` is
    given) to its plain version on the same tensors within ATTN_TOL, and
    to zeros at kv_len = 0; returns the max abs error."""
    import torch

    from repro_torch.kernels import ops, ref

    if got is None:
        got = ops.decode_attention(q, k, v, lens)
    want = ref.decode_attention_gqa_ref(q, k, v, lens)
    sync(q.device)
    if not torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL):
        raise AssertionError(
            f"decode_attention ({where}): differs from the plain version "
            f"beyond {ATTN_TOL} (kv_len {lens.tolist()[:4]})")
    if bool((lens == 0).any()) and not bool((got[lens == 0] == 0).all()):
        raise AssertionError("decode_attention: kv_len = 0 must give zeros")
    return float((got - want).abs().max())


def check_decode_attention(dev, seed: int) -> dict:
    """decode_attention at qwen2-7b's heads against its plain version at
    the lm-serve (B=8, S=160), decode_32k (B=16) and long_500k shapes;
    timed at kv_len = S - 1, the LM cells' length.  Then at the zoo's
    other GQA heads (:func:`check_zoo_heads`)."""
    import torch

    from repro_torch.kernels import ops, ref

    cfg = qwen2()
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = torch.Generator(device=dev).manual_seed(seed + 303)
    err, timings = 0.0, {}
    # [lm-serve]'s shape is checked here too (ragged), and timed on no
    # path: its cache is small.
    for cell, b, s in (("lm-serve", LM_BATCH, LM_PROMPT + LM_GEN),
                       ) + LM_CELLS:
        q = torch.randn((b, hq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
        v = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
        ragged = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                               dtype=torch.int32)
        if b > 2:
            ragged[:3] = torch.tensor([0, 1, s], device=dev)
        checks = [ragged] if b > 1 else [ragged, torch.tensor(
            [s], device=dev, dtype=torch.int32), torch.tensor(
            [1], device=dev, dtype=torch.int32)]
        for lens in checks:
            err = max(err, attention_check(f"phase 2 {cell}", q, k, v, lens))
        if cell == "lm-serve":
            log(f"[phase2] decode_attention {cell} B={b} S={s} Hq={hq} "
                f"Hkv={hkv} d={d} bf16: within {ATTN_TOL} on ragged kv_len "
                f"{ragged.tolist()}")
            continue
        lens = torch.full((b,), s - 1, device=dev, dtype=torch.int32)
        ms, host = time_calls(lambda: ops.decode_attention(q, k, v, lens),
                              hold=True)
        plain_ms, _ = time_calls(
            lambda: ref.decode_attention_gqa_ref(q, k, v, lens), hold=False)
        lib_ms = sdpa_time(q, k, v, lens)
        bound = attention_bound(lens, s, hq, hkv, d, 2)
        timings[cell] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound[0], bound_by=bound[1])
        log(f"[phase2] decode_attention {cell} B={b} S={s} Hq={hq} Hkv={hkv} "
            f"d={d} bf16: within {ATTN_TOL} on ragged kv_len; at kv_len = "
            f"S-1 kernel {ms:.4f} ms on the device ({host:.4f} ms host), "
            f"plain {plain_ms:.4f} ms, library "
            f"{'refused' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound[0]:.4f} ms ({bound[1]})")
        del q, k, v
        torch.cuda.empty_cache()
    t = timings["decode_32k"]
    rec = record("decode_attention", err, t["ms"], t["plain_ms"],
                 t["library_ms"], (t["bound_ms"], t["bound_by"]),
                 f"bfloat16 cache within {ATTN_TOL} at lm-serve's (8, 160) "
                 f"ragged, decode_32k (B=16) and long_500k, and at the "
                 f"zoo's heads 32/4/128, 56/8/128, 36/36/64 at (8, 160) "
                 f"ragged; kv_len = 0 gives zeros")
    rec["long_500k"] = timings["long_500k"]
    rec["zoo_heads"] = check_zoo_heads(dev, g)
    rec["max_abs_err"] = max(err, *(t["max_abs_err"]
                                    for t in rec["zoo_heads"].values()))
    return rec


def check_zoo_heads(dev, g) -> dict:
    """decode_attention at the head shapes of the zoo's other GQA archs
    (qwen3-moe 32 / 4 / 128, deepseek-coder 56 / 8 / 128 (a group of 7),
    minicpm 36 / 36 / 64 (a group of 1)) at [lm-serve]'s (B=8, S=160):
    within ATTN_TOL of the plain version on ragged kv_len with 0, 1 and
    S, then timed at kv_len = S - 1 beside SDPA and the bound."""
    import torch

    from repro_torch.configs import base
    from repro_torch.kernels import ops, ref

    b, s = LM_BATCH, LM_PROMPT + LM_GEN
    out = {}
    for arch, _ in LM_ZOO:
        cfg = base.get(arch).config
        if cfg.attention != "gqa":
            continue
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        q = torch.randn((b, hq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
        v = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
        ragged = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                               dtype=torch.int32)
        ragged[:3] = torch.tensor([0, 1, s], device=dev)
        err = attention_check(f"phase 2 {arch}", q, k, v, ragged)
        lens = torch.full((b,), s - 1, device=dev, dtype=torch.int32)
        ms, host = time_calls(lambda: ops.decode_attention(q, k, v, lens),
                              hold=True)
        plain_ms, _ = time_calls(
            lambda: ref.decode_attention_gqa_ref(q, k, v, lens), hold=False)
        lib_ms = sdpa_time(q, k, v, lens)
        bound = attention_bound(lens, s, hq, hkv, d, 2)
        out[arch] = dict(heads=[hq, hkv, d], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound[0], bound_by=bound[1])
        log(f"[phase2] decode_attention {arch} B={b} S={s} Hq={hq} "
            f"Hkv={hkv} (group {hq // hkv}) d={d} bf16: within {ATTN_TOL} "
            f"on ragged kv_len {ragged.tolist()} (max abs err {err:.3g}); at "
            f"kv_len = S-1 kernel {ms:.4f} ms on the device ({host:.4f} ms "
            f"host), plain {plain_ms:.4f} ms, library "
            f"{'refused' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound[0]:.4f} ms ({bound[1]})")
    return out


def check_pq_scan(dev, seed: int) -> dict:
    """pq_scan at one adc_topk chunk of phase 3c: (256, 16, 256) LUTs x
    (1M, 16) codes; bit for bit on integer LUTs, 1e-5 on float LUTs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    n = sift1m().n
    g = torch.Generator(device=dev).manual_seed(seed + 404)
    codes = torch.randint(0, PQ_K, (n, PQ_M), generator=g, device=dev,
                          dtype=torch.uint8)
    luts_i = torch.randint(0, 64, (PQ_Q, PQ_M, PQ_K), generator=g,
                           device=dev).float()
    luts = torch.rand((PQ_Q, PQ_M, PQ_K), generator=g, device=dev) * 64.0
    got, want = ops.pq_bulk_scan(luts_i, codes), ref.pq_scan_ref(luts_i, codes)
    sync(dev)
    if not torch.equal(got, want):
        raise AssertionError("pq_scan differs from the plain version on "
                             "integer LUTs")
    got, want = ops.pq_bulk_scan(luts, codes), ref.pq_scan_ref(luts, codes)
    sync(dev)
    if not torch.allclose(got, want, rtol=FLOAT_RTOL, atol=FLOAT_RTOL):
        raise AssertionError("pq_scan differs from the plain version beyond "
                             "1e-5 on float LUTs")
    err = float((got - want).abs().max())
    del want
    # The library yardstick: one embedding_bag over codes offset by m * K
    # (index prepared outside the timing) gives the (N, Q) transpose.
    idx = codes.long() + torch.arange(PQ_M, device=dev) * PQ_K
    weight = luts.reshape(PQ_Q, PQ_M * PQ_K).T.contiguous()
    lib_out = F.embedding_bag(idx, weight, mode="sum")
    sync(dev)
    lib_err = float((lib_out.T - got).abs().max())
    del lib_out, got
    ms, host = time_calls(lambda: ops.pq_bulk_scan(luts, codes), hold=True)
    # The design's floor on the card: with all-zero codes the 8 lanes of a
    # quarter-warp read entries (0, m) of 8 different m, in 8 bank groups,
    # as they do for any codes; a slower random-code time would be bank
    # conflicts.
    zeros = torch.zeros_like(codes)
    if not torch.equal(ops.pq_bulk_scan(luts_i, zeros),
                       ref.pq_scan_ref(luts_i, zeros)):
        raise AssertionError("pq_scan differs from the plain version on "
                             "all-zero codes")
    floor_ms, _ = time_calls(lambda: ops.pq_bulk_scan(luts, zeros), hold=True)
    plain_ms, _ = time_calls(lambda: ref.pq_scan_ref(luts, codes),
                             hold=False, reps=5)
    lib_ms, _ = time_calls(lambda: F.embedding_bag(idx, weight, mode="sum"),
                           hold=False, reps=5)
    bound = bound_of(n * PQ_M + PQ_Q * PQ_M * PQ_K * 4 + PQ_Q * n * 4,
                     PQ_Q * n * PQ_M)
    # Shared memory's own floor: one 4-byte entry a lookup at 128 bytes a
    # cycle an SM, at the H100 SXM's top SM clock (1.98 GHz).
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem_ms = PQ_Q * n * PQ_M * 4 / (128 * sms * 1.98e9) * 1e3
    log(f"[phase2] pq_scan ({PQ_Q}, {PQ_M}, {PQ_K}) x ({n}, {PQ_M}): "
        f"integer LUTs bit for bit (random and all-zero codes), float LUTs "
        f"within 1e-5 (max abs err {err:.3g}); kernel {ms:.4f} ms on the "
        f"device ({host:.4f} ms host), all-zero codes (conflict-free floor) "
        f"{floor_ms:.4f} ms, bytes bound {bound[0]:.4f} ms ({bound[1]}), "
        f"shared-memory floor {smem_ms:.4f} ms at 1.98 GHz; plain "
        f"{plain_ms:.4f} ms, library (embedding_bag, max abs diff "
        f"{lib_err:.3g}) {lib_ms:.4f} ms")
    del codes, zeros, luts, luts_i, idx, weight
    rec = record("pq_scan", err, ms, plain_ms, lib_ms, bound,
                 "integer LUTs bit for bit (random and all-zero codes); "
                 "float LUTs within 1e-5")
    rec["zero_codes_ms"] = floor_ms
    rec["smem_floor_ms_at_1980mhz"] = smem_ms
    return rec


# ---------------------------------------------------------------- phase 3

def trace_report(prof, wall_ms: float, path: str) -> str:
    """Write the profile of one batch to ``path`` (+ ``.json``, a Chrome
    trace); return a one-line summary: wall ms, the device's busy ms (the
    union of its kernel and copy intervals) and the longest host
    operators."""
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and e.time_range.elapsed_us() > 0]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end, gap = 0.0, float("-inf"), (0.0, 0.0)
    for a, b in spans:
        if end > float("-inf") and a - end > gap[0]:
            gap = (a - end, end - spans[0][0])
        if b > end:
            busy += b - max(a, end)
            end = b
    avg = prof.key_averages()
    host = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:4]
    with open(path, "w") as f:
        f.write(f"wall {wall_ms:.3f} ms, device busy {busy / 1e3:.3f} ms "
                f"({len(events)} device events), longest device gap "
                f"{gap[0] / 1e3:.3f} ms at {gap[1] / 1e3:.3f} ms after the "
                f"first device event\n\n")
        f.write(avg.table(sort_by="self_cpu_time_total", row_limit=30))
        f.write("\n\nby self device time:\n")
        for e in sorted(avg, key=lambda e: e.self_device_time_total,
                        reverse=True)[:20]:
            f.write(f"{e.self_device_time_total / 1e3:9.3f} ms  "
                    f"{e.count:5d} calls  {e.key}\n")
    prof.export_chrome_trace(path[:-4] + ".json")
    return (f"wall {wall_ms:.1f} ms, device busy {busy / 1e3:.1f} ms, "
            f"longest device gap {gap[0] / 1e3:.1f} ms at "
            f"{gap[1] / 1e3:.1f} ms; "
            "host self ms: " + ", ".join(
                f"{e.key} {e.self_cpu_time_total / 1e3:.1f}" for e in host))


def serve_run(name, engine, batches, gts, n, pipelined: bool,
              trace: bool = False, keep: list | None = None):
    """Serve ``batches``; return the printed metrics.  ``trace``: profile
    the first batch (see :func:`trace_report`); ``keep`` collects the
    results."""
    import numpy as np
    import torch

    from repro_torch.core import distance
    from repro_torch.kernels import ops

    before = ops.launch_counts()
    lat, recalls, hops, budgets = [], [], [], []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    t_all = t0 = time.perf_counter()
    results = (engine.search_batches(batches) if pipelined
               else (engine.search(b) for b in batches))
    for bi, res in enumerate(results):
        lat.append((time.perf_counter() - t0) * 1e3)
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
            out = os.path.join(ROOT, "chiprun_out")
            os.makedirs(out, exist_ok=True)
            log(f"[trace] {name}, first batch: " + trace_report(
                prof, lat[0], os.path.join(out, "first_batch_trace.txt")))
            prof = None
        if res.ids.shape != (batches[bi].shape[0], engine.k):
            raise AssertionError(f"{name}: result shape {res.ids.shape}")
        if not ((res.ids >= -1) & (res.ids < n)).all():
            raise AssertionError(f"{name}: result id outside [-1, {n})")
        ok = res.ids >= 0
        if not np.isfinite(res.d2[ok]).all():
            raise AssertionError(f"{name}: non-finite distance for a valid id")
        recalls.append(float(distance.recall_at_k(torch.as_tensor(res.ids),
                                                  torch.as_tensor(gts[bi]))))
        if res.stats is not None:     # the monolithic step has no counters
            hops.append(float(np.mean(res.stats.hops)))
        if res.astats is not None:
            budgets.append(float(np.mean(res.astats.budget)))
        if keep is not None:
            keep.append(res)
        t0 = time.perf_counter()
    total = time.perf_counter() - t_all
    after = ops.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    steady = lat[1:] if pipelined and len(lat) > 1 else lat
    m = dict(recall=float(np.mean(recalls)),
             qps=sum(b.shape[0] for b in batches) / total,
             p50_ms=float(np.percentile(steady, 50)),
             p99_ms=float(np.percentile(steady, 99)),
             mean_budget=float(np.mean(budgets)) if budgets else None,
             mean_hops=float(np.mean(hops)) if hops else None,
             launches=launches)
    hops_s = "none" if not hops else f"{m['mean_hops']:.2f}"
    log(f"[serve] {name}: recall@10={m['recall']:.4f} qps={m['qps']:.1f} "
        f"batch_lat p50={m['p50_ms']:.1f}ms p99={m['p99_ms']:.1f}ms "
        f"first={lat[0]:.1f}ms "
        f"meanL={m['mean_budget']} hops/query={hops_s} "
        f"launches={ {k: v for k, v in launches.items() if v} }")
    return m


def compare_serving(eng_auto, eng_buckets, batches) -> None:
    """QPS and launches of the tiered adaptive stream four ways —
    double-buffered ``search_batches`` or one ``search`` per batch, times
    ``num_buckets="auto"`` (one continue program on the card) or a fixed
    family of 4 budget buckets — each twice, in the order ABCD DCBA.  Every
    way must return the same ids."""
    import numpy as np

    from repro_torch.kernels import ops

    ways = {"pipelined auto": (eng_auto, True),
            "per-batch auto": (eng_auto, False),
            "pipelined 4 buckets": (eng_buckets, True),
            "per-batch 4 buckets": (eng_buckets, False)}
    order = list(ways) + list(reversed(ways))
    qps = {w: [] for w in ways}
    launches = {}
    ids0 = None
    for w in order:
        eng, pipelined = ways[w]
        before = ops.launch_counts()["beam_step.pq"]
        t0 = time.perf_counter()
        res = list(eng.search_batches(batches) if pipelined
                   else (eng.search(b) for b in batches))
        qps[w].append(sum(b.shape[0] for b in batches)
                      / (time.perf_counter() - t0))
        launches[w] = ops.launch_counts()["beam_step.pq"] - before
        ids = np.concatenate([r.ids for r in res])
        if ids0 is None:
            ids0 = ids
        elif not np.array_equal(ids, ids0):
            raise AssertionError(f"[compare] {w}: ids differ from "
                                 f"{order[0]}")
    for w, v in qps.items():
        log(f"[compare] tiered adaptive {w}: qps {v[0]:.1f}, {v[1]:.1f}; "
            f"beam_step[pq] launches {launches[w]}")


def main_path(dev, n: int, n_queries: int, batch: int, build_batch: int,
              seed: int, trace: bool = False):
    """Build and serve the deployment; returns the launch counts of this
    run (counts set to 0 at its start) and what the calibration path needs.
    ``trace``: profile the first batch of the tiered pipelined run."""
    from repro_torch import serving
    from repro_torch.core import build, distance
    from repro_torch.data import REGISTRY, make_dataset
    from repro_torch.index import build_tiered_index
    from repro_torch.kernels import ops

    cfg = sift1m()
    spec = REGISTRY["sift1m"]
    if n < spec.n:
        log(f"[main] N cut: {spec.n} -> {n} (build must fit the time limit)")
    t0 = time.perf_counter()
    x, queries = make_dataset(spec, seed=seed, device=dev, n=n)
    queries = queries[:n_queries]
    sync(dev)
    log(f"[main] data: N={x.shape[0]} D={x.shape[1]} queries="
        f"{queries.shape[0]} ({time.perf_counter() - t0:.1f}s)")

    ops.reset_launch_counts()
    bcfg = build.BuildConfig(degree=cfg.degree, beam_width=cfg.l_build,
                             alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max,
                             batch=build_batch, seed=seed)
    timings: dict = {}
    t0 = time.perf_counter()
    graph = build.build_mcgi(x, bcfg, progress=lambda m: log(f"[build] {m}"),
                             device=dev, timings=timings)
    t_build = time.perf_counter() - t0
    log(f"[build] MCGI build {t_build:.1f}s (R={bcfg.degree} "
        f"L={bcfg.beam_width} T={bcfg.iters} batch={bcfg.batch}): "
        + " ".join(f"{k}={v:.1f}s" for k, v in timings.items())
        + f"; mean out-degree {float(graph.out_degrees().float().mean()):.2f}"
        f"; build launches {ops.launch_counts()}")
    log(f"[build] lid_knn {timings['lid_knn']:.3f}s (exact k-NN of 1 point "
        f"in {x.shape[0]} against all through l2_distance + topk, then "
        f"lid_estimate); LID mu={float(graph.mu)!r} "
        f"sigma={float(graph.sigma)!r}")
    t0 = time.perf_counter()
    index = build_tiered_index(x, graph, m_pq=M_PQ, device=dev)
    sync(dev)
    log(f"[build] PQ tier m={M_PQ} in "
        f"{time.perf_counter() - t0:.1f}s (fast tier "
        f"{index.fast_tier_bytes() / 1e6:.1f} MB, slow tier "
        f"{index.slow_tier_bytes() / 1e6:.1f} MB)")
    t0 = time.perf_counter()
    before = ops.launch_counts()
    _, gt_i = distance.brute_force_topk(queries, x, k=cfg.k)
    gt = gt_i.cpu().numpy()
    after = ops.launch_counts()
    log(f"[main] ground truth in {time.perf_counter() - t0:.1f}s "
        f"(l2_distance {after['l2_distance'] - before['l2_distance']}, "
        f"topk {after['topk'] - before['topk']} launches)")

    qn = queries.cpu().numpy()
    batches = [qn[s:s + batch] for s in range(0, qn.shape[0], batch)]
    gts = [gt[s:s + batch] for s in range(0, qn.shape[0], batch)]
    budget = cfg.beam_budget()
    tiered = serving.TieredBackend(index, device=dev)
    exact = serving.ExactBackend(x, graph.adj, graph.entry, device=dev)
    eng_t = serving.SearchEngine(tiered, budget, k=cfg.k)
    eng_e = serving.SearchEngine(exact, budget, k=cfg.k)
    eng_f = serving.SearchEngine(tiered, None, k=cfg.k,
                                 beam_width=cfg.l_search,
                                 max_hops=cfg.max_hops)
    for eng in (eng_t, eng_e, eng_f):              # warm-up
        eng.search(qn[:64])
    runs = {
        "tiered_adaptive_pipelined": serve_run(
            "tiered adaptive pipelined", eng_t, batches, gts, n, True,
            trace=trace),
        "exact_adaptive": serve_run("exact adaptive", eng_e, batches, gts, n,
                                    False),
        "tiered_fixed_beam128": serve_run("tiered fixed beam 128", eng_f,
                                          batches[:1], gts[:1], n, False),
    }
    counts = ops.launch_counts()
    log(f"[main] kernel launches on the main path: {counts}")
    if runs["tiered_adaptive_pipelined"]["launches"]["beam_step.pq"] == 0:
        raise AssertionError("tiered serving never launched beam_step[pq]")
    if runs["exact_adaptive"]["launches"]["beam_step.exact"] == 0:
        raise AssertionError("exact serving never launched beam_step[exact]")
    for name in MCGI_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"{name} was never launched on the main "
                                 f"path")
    rec = runs["tiered_adaptive_pipelined"]["recall"]
    if rec < RECALL_FLOOR:
        raise AssertionError(f"tiered adaptive recall@10 {rec:.4f} < "
                             f"{RECALL_FLOOR}")
    compare_serving(eng_t, serving.SearchEngine(tiered, budget, k=cfg.k,
                                                num_buckets=4), batches)
    return counts, dict(n=n, qn=qn, gt=gt, batches=batches, gts=gts,
                        tiered=tiered, exact=exact,
                        tiered_recall=rec)


# --------------------------------------------------------------- phase 3b

def calibration_path(world) -> dict:
    """Fit the budget law of each adaptive engine to its recall target with
    ``SearchEngine.recalibrate(joint=True)``, then serve the stream with
    the fitted law.  Returns the launch counts of this run."""
    from repro_torch import serving
    from repro_torch.kernels import ops

    cfg = sift1m()
    n, qn, gt = world["n"], world["qn"], world["gt"]
    ops.reset_launch_counts()
    served = {}
    for name, backend, target in (("exact", world["exact"],
                                   cfg.recall_target),
                                  ("tiered", world["tiered"],
                                   TIERED_TARGET)):
        eng = serving.SearchEngine(backend, cfg.beam_budget(), k=cfg.k)
        t0 = time.perf_counter()
        res = eng.recalibrate(qn, gt, recall_target=target, joint=True,
                              sample=CALIB_SAMPLE)
        secs = time.perf_counter() - t0
        fit = eng.budget_cfg
        log(f"[calibrate] {name}: target {target:.2f} "
            f"{'achieved' if res.achieved else 'MISSED'}: lam={res.lam:.4f} "
            f"l_min={fit.l_min} hop_factor={fit.hop_factor} "
            f"recall={res.recall:.4f} on {CALIB_SAMPLE} held-out queries, "
            f"{len(res.history)} evaluations, {secs:.2f}s; joint history "
            f"{[(lm, round(lam, 4), hf, round(r, 4), ok) for lm, lam, hf, r, ok in res.joint_history]}")
        if name == "exact" and not res.achieved:
            raise AssertionError(f"the exact fit missed its target {target}")
        world[f"{name}_law"] = fit
        eng.search(qn[:64])                                # warm-up
        served[name] = serve_run(f"{name} adaptive, fitted law", eng,
                                 world["batches"], world["gts"], n,
                                 name == "tiered")
        served[name]["target"] = target
    lam_only_fit(world)
    counts = ops.launch_counts()
    log(f"[calibrate] kernel launches on the calibration path: {counts}")
    for kind in ("exact", "pq"):
        if counts[f"beam_step.{kind}"] == 0:
            raise AssertionError(f"beam_step.{kind} was never launched on "
                                 f"the calibration path")
    floor = cfg.recall_target - SERVED_RECALL_SLACK
    if served["exact"]["recall"] < floor:
        raise AssertionError(f"exact adaptive with the fitted law served "
                             f"recall@10 {served['exact']['recall']:.4f} < "
                             f"{floor:.2f}")
    return counts


def lam_only_fit(world) -> None:
    """The dataset config's lam-only fit
    (``McgiDatasetConfig.calibrated_beam_budget``) of the exact index to
    its recall target on ``CALIB_SAMPLE`` held-out queries; fails unless
    the fitted law reaches the target on that sample."""
    from repro_torch.core import calibrate

    cfg, ex = sift1m(), world["exact"]
    ev = calibrate.exact_recall_eval(ex.x, ex.adj, ex.entry, world["qn"],
                                     world["gt"], k=cfg.k,
                                     sample=CALIB_SAMPLE,
                                     base_cfg=cfg.beam_budget())
    t0 = time.perf_counter()
    fit = cfg.calibrated_beam_budget(ev)
    secs = time.perf_counter() - t0
    rec = ev(fit)
    ok = rec >= cfg.recall_target
    log(f"[calibrate] exact, lam only (calibrated_beam_budget): target "
        f"{cfg.recall_target:.2f} {'achieved' if ok else 'MISSED'}: "
        f"lam={fit.lam:.4f} l_min={fit.l_min} hop_factor={fit.hop_factor} "
        f"recall={rec:.4f} on {CALIB_SAMPLE} held-out queries, {secs:.2f}s")
    if not ok:
        raise AssertionError(f"the exact lam-only fit missed its target "
                             f"{cfg.recall_target}")


# --------------------------------------------------------------- phase 3c

def adc_path(world) -> dict:
    """Bulk ADC retrieval over phase 3's PQ codes: ``adc_topk`` of the
    query stream in chunks, recall@10 against the exact ground truth, and
    one retrieval_cand-shaped call.  Returns the launch counts of this
    run."""
    import torch

    from repro_torch.core import distance
    from repro_torch.kernels import ops, ref
    from repro_torch.pq import adc

    tiered = world["tiered"]
    codes = tiered.index.codes
    n = codes.shape[0]
    luts = tiered.admit(world["qn"])                   # (Q, 16, 256) LUTs
    sync(luts.device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    vals, ids = adc.adc_topk(luts, codes, ADC_K)
    sync(luts.device)
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    nq = luts.shape[0]
    chunks = -(-nq // adc.query_chunk(n))
    if ids.shape != (nq, ADC_K) or not bool(((ids >= 0) & (ids < n)).all()):
        raise AssertionError(f"[adc] ids of shape {tuple(ids.shape)} or "
                             f"outside [0, {n})")
    if not (bool(torch.isfinite(vals).all())
            and bool((vals[:, 1:] >= vals[:, :-1]).all())):
        raise AssertionError("[adc] distances not finite and ascending")
    for name in ("pq_scan", "topk"):
        if counts[name] != chunks:
            raise AssertionError(f"[adc] {name} launched {counts[name]} "
                                 f"times, not once per chunk ({chunks})")
    # The path's kernels against their plain versions at its two shapes:
    # its first chunk (the path's own results, no new launch) and one
    # retrieval_cand call; values and ids must be identical.
    chunk = min(adc.query_chunk(n), nq)
    one = luts[:1].contiguous()
    for what, lq, (got_v, got_i) in (
            (f"a chunk of {chunk} queries", luts[:chunk],
             (vals[:chunk], ids[:chunk])),
            ("one query", one, adc.adc_topk(one, codes, ADC_K))):
        want_v, want_i = ref.topk_ref(ref.pq_scan_ref(lq, codes), ADC_K)
        sync(luts.device)
        if not (torch.equal(got_v, want_v) and torch.equal(got_i, want_i)):
            raise AssertionError(f"[adc] pq_scan + topk on {what} differ "
                                 f"from pq_scan_ref + topk_ref")
        del want_v, want_i
    recall = float(distance.recall_at_k(ids.cpu(),
                                        torch.as_tensor(world["gt"])))
    log(f"[adc] adc_topk k={ADC_K}: {nq} queries x {n} PQ codes "
        f"(m={codes.shape[1]}) in {chunks} chunks of "
        f"{adc.query_chunk(n)}: {secs:.3f}s ({nq / secs:.1f} QPS); values "
        f"and ids of the first chunk and of a 1-query call identical to "
        f"pq_scan_ref + topk_ref; "
        f"recall@10 {recall:.4f} against the exact ground truth "
        f"(exhaustive ADC, no rerank; tiered serving reranks); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    ms, host = time_calls(lambda: adc.adc_topk(one, codes, ADC_K), hold=True)
    log(f"[adc] retrieval_cand shape (1 query x {n} candidates, k={ADC_K}): "
        f"{ms:.4f} ms on the device per call ({host:.4f} ms host)")
    # Recall@100's k over the first chunk, after the launch counts are read.
    wv, wi = adc.adc_topk(luts[:chunk], codes, ADC_K_WIDE)
    want_v, want_i = ref.topk_ref(ref.pq_scan_ref(luts[:chunk], codes),
                                  ADC_K_WIDE)
    sync(luts.device)
    if not (torch.equal(wv, want_v) and torch.equal(wi, want_i)):
        raise AssertionError(f"[adc] adc_topk k={ADC_K_WIDE} on a chunk of "
                             f"{chunk} queries differs from pq_scan_ref + "
                             f"topk_ref")
    if not (torch.equal(wv[:, :ADC_K], vals[:chunk])
            and torch.equal(wi[:, :ADC_K], ids[:chunk])):
        raise AssertionError(f"[adc] the first {ADC_K} of k={ADC_K_WIDE} "
                             f"differ from the k={ADC_K} run")
    ms, host = time_calls(lambda: adc.adc_topk(luts[:chunk], codes,
                                               ADC_K_WIDE), hold=True)
    log(f"[adc] adc_topk k={ADC_K_WIDE} on the first chunk ({chunk} "
        f"queries): values and ids identical to pq_scan_ref + topk_ref, "
        f"its first {ADC_K} to the k={ADC_K} run's; {ms:.4f} ms on the "
        f"device per call ({host:.4f} ms host)")
    del luts, vals, ids, wv, wi, want_v, want_i
    return counts


# --------------------------------------------------------------- phase 3g

# The launcher's two QoS classes (``--serve``): lanes a dispatch (also the
# lane quantum), batch window in s, deadline in s (--deadline-ms 100,
# --batch-deadline-ms 2000).
DOOR_CLASSES = {"interactive": (8, 0.002, 0.100), "batch": (32, 0.02, 2.0)}
DOOR_REPLAY = 4000                 # requests of the virtual-clock replay
DOOR_REPLAY_QPS = 10_000           # its arrival rate: dispatches fill up
DOOR_SECONDS = 10.0                # arrivals of each wall-clock run
DOOR_OVERLOAD_SECONDS = 2.0        # arrivals of the overload run
DOOR_SHORT_SECONDS = 5.0           # length of the short-deadline run
DOOR_CALIB_SECONDS = 3.0           # its calibration segment, same load
DOOR_HELD_GROUPS = 12              # held-continue run: dispatches of 8,
DOOR_HELD_GAP = 0.3                # s apart, each continue held back by a
DOOR_HOLD_CYCLES = 300_000_000     # sleep kernel (~150-170 ms of the card)
DOOR_HELD_DEADLINE = 0.020         # past the probe, inside the hold
DOOR_MAX_QUEUE = 256
DOOR_WORKERS = 2
DOOR_CLIENTS = 8                   # threads submitting the arrivals
# The launcher's bursty arrivals: 50 ms at 8x --qps, then 200 ms at 1/8 of
# it, so their mean rate is 1.7x --qps.
BURSTY_MEAN = (0.05 * 8 + 0.2 / 8) / 0.25
STATUSES = ("ok", "partial", "timeout", "shed", "error")


class LateClock:
    """The front door's clock seam over another clock (the wall clock) that
    records how late each timer fires, fire time less due time: deadline
    timers apart from batch-window timers."""

    def __init__(self, inner):
        self.inner = inner
        self.late = {"deadline": [], "window": []}

    def now(self):
        return self.inner.now()

    def call_at(self, when, fn, *args):
        kind = ("deadline" if getattr(fn, "__name__", "") == "_on_deadline"
                else "window")

        def fire(*a):
            self.late[kind].append(self.inner.now() - when)
            fn(*a)
        return self.inner.call_at(when, fire, *args)

    def call_later(self, delay, fn, *args):
        return self.call_at(self.now() + delay, fn, *args)

    def close(self):
        self.inner.close()


class FlightLog:
    """The dispatcher seam over another dispatcher that records, for every
    dispatch, the clock time its ``begin`` handed it over (from then on a
    hedge can take its probe), the clock time its full result reached the
    door (the completion callback's entry; the production dispatcher has
    put the result on the dispatch by then) and the host seconds of its
    ``finish_from``.  ``launch`` goes to the inner dispatcher, so ``begin``
    runs where it would without the log.  ``hold(disp)``, if given, runs
    right after the dispatch's ``begin``, before its ``finish_from`` is
    handed on."""

    def __init__(self, inner, clock, hold=None):
        self.inner, self.clock, self.hold = inner, clock, hold
        self.sent = []                      # every dispatch submitted
        self.begun = {}                     # id(dispatch) -> clock time
        self.flights = []                   # (dispatch, t_full, seconds)

    def launch(self, fly):
        self.inner.launch(fly)

    def settle(self, timeout: float) -> None:
        """Wait until every submitted flight has reported: the door drains
        once its lanes complete, maybe by deadline hedges, before the last
        flights end."""
        end = time.monotonic() + timeout
        while len(self.flights) < len(self.sent):
            if time.monotonic() > end:
                raise AssertionError("[door] a flight never completed")
            time.sleep(0.001)

    def submit(self, disp, finish, on_done):
        # Its begin has returned: from now on a deadline hedge can take the
        # probe (the production dispatcher marks it ready here).
        self.begun[id(disp)] = self.clock.now()
        self.sent.append(disp)
        if self.hold is not None:
            self.hold(disp)
        secs = []

        def timed():
            t0 = time.perf_counter()
            try:
                return finish()
            finally:
                secs.append(time.perf_counter() - t0)

        def done(res):
            self.flights.append((disp, self.clock.now(), secs[0]))
            on_done(res)
        self.inner.submit(disp, timed, done)

    def close(self):
        self.inner.close()


def no_host_sync(fn):
    """``fn`` under CUDA sync debug mode "error": any call in it that waits
    for the card (a blocking copy, a stream or device synchronise, a read
    of a device value) raises.  Single-threaded callers only: the mode is
    the process's."""
    import torch

    def call(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return call


def door_engines(tiered, laws: dict, logs: dict, check_sync: bool = False,
                 holds: dict | None = None):
    """One engine per class over the shared backend.  Each records the host
    seconds of its ``begin`` and ``partial_result`` and counts its
    ``close`` calls.  ``holds`` (flight id -> CUDA event after a sleep
    kernel queued behind the flight's probe): for each partial of a held
    flight, whether the hold was still pending when the partial was asked
    and when it returned."""
    from repro_torch import serving

    engines = {}
    for c, law in laws.items():
        eng = serving.SearchEngine(tiered, law, k=10)
        rec = logs[c] = {"begin": [], "partial_result": [], "close": 0,
                         "held": []}
        for name in ("begin", "partial_result"):
            inner = getattr(eng, name)
            if check_sync and name == "begin":
                inner = no_host_sync(inner)

            def timed(*a, _inner=inner, _name=name, _rec=rec[name],
                      _held=rec["held"], **kw):
                ev = (holds.get(id(a[0])) if holds is not None
                      and _name == "partial_result" else None)
                pend = ev is not None and not ev.query()
                t0 = time.perf_counter()
                try:
                    return _inner(*a, **kw)
                finally:
                    _rec.append(time.perf_counter() - t0)
                    if ev is not None:
                        _held.append((pend, not ev.query()))
            setattr(eng, name, timed)

        def close(_close=eng.close, _rec=rec):
            _rec["close"] += 1
            _close()
        eng.close = close
        engines[c] = eng
    return engines


def door_classes(deadlines: dict | None = None) -> list:
    from repro_torch import serving

    return [serving.QoSClass(c, deadline_s=(deadlines or {}).get(c, dl),
                             batch_window_s=w, max_lanes=lanes,
                             lane_quantum=lanes)
            for c, (lanes, w, dl) in DOOR_CLASSES.items()]


def pct_ms(xs, p) -> float:
    import numpy as np

    return float(np.percentile(xs, p)) * 1e3 if len(xs) else float("nan")


def door_report(run, door, futs, logs, flights, clock, secs: float,
                offered: float, world, card: str, where: str) -> dict:
    """Read every future once and check the run's bookkeeping, print its
    lines per class, and return its metrics.  Fails unless every future
    completed exactly once, the counters add up to the requests, the door
    drained with each engine closed once, every partial holds k valid,
    distinct ids with ascending d2, and every ok lane and every partial is
    bit-identical to its class engine's direct ``search`` /
    ``partial_result`` of the same query (``world["door_direct"]``: the LID
    center is pinned, so a lane's result does not depend on its dispatch).
    ``where``: the thread that ran ``begin``."""
    import numpy as np

    gt, n = world["gt"], world["n"]
    direct = world["door_direct"]
    st = door.stats()
    results = [(row, c, f.result(timeout=0)) for row, c, f in futs]
    got = {c: {s: 0 for s in STATUSES} for c in DOOR_CLASSES}
    for _, c, r in results:
        got[c][r.status] += 1
    if (st["submitted"] != len(futs)
            or sum(st[s] for s in STATUSES) != st["submitted"]
            or got != st["per_class"]):
        raise AssertionError(f"[door] {run}: counters {st} do not add up "
                             f"to {len(futs)} requests {got}")
    if not door.drained or any(lg["close"] != 1 for lg in logs.values()):
        raise AssertionError(f"[door] {run}: drained={door.drained}, engine "
                             f"closes {[lg['close'] for lg in logs.values()]}")
    for row, c, r in results:
        if r.status not in ("ok", "partial"):
            continue
        if r.status == "partial":
            ok = ((r.ids >= 0) & (r.ids < n)).all() and np.isfinite(r.d2).all()
            if not (ok and r.ids.shape == (10,)
                    and np.unique(r.ids).size == 10
                    and (np.diff(r.d2) >= 0).all()):
                raise AssertionError(f"[door] {run}: a partial without 10 "
                                     f"valid distinct ids in ascending d2: "
                                     f"{r}")
        ids, d2 = direct[r.status][(c, row)]
        if not (np.array_equal(r.ids, ids) and np.array_equal(r.d2, d2)):
            raise AssertionError(f"[door] {run}: a served {r.status} {c} "
                                 f"lane of query {row} differs from the "
                                 f"engine's direct "
                                 f"{'search' if r.status == 'ok' else 'partial_result'}")
    m = {"secs": secs, "offered": offered, "counts": got, "recall_ok": {},
         "stats": st}
    for c in DOOR_CLASSES:
        rs = [(row, r) for row, cc, r in results if cc == c]
        lat = [r.latency for _, r in rs if r.status != "shed"]

        def recall(status):
            hit = [np.isin(r.ids, gt[row]).mean() for row, r in rs
                   if r.status == status]
            return float(np.mean(hit)) if hit else float("nan")

        ok = [r for _, r in rs if r.status == "ok"]
        m["recall_ok"][c] = recall("ok")
        dispatches = sum(1 for d, _, _ in flights if d.cls.name == c)
        lg = logs[c]
        log(f"[door] {run} {c}: "
            f"{ {s: v for s, v in got[c].items() if v} } "
            f"latency p50 {pct_ms(lat, 50):.2f} ms p99 {pct_ms(lat, 99):.2f} "
            f"ms; recall@10 ok {m['recall_ok'][c]:.4f} partial "
            f"{recall('partial'):.4f}; mean budget "
            f"{np.mean([r.budget for r in ok]) if ok else float('nan'):.2f}"
            f" hops {np.mean([r.hops for r in ok]) if ok else float('nan'):.2f}; "
            f"{dispatches} dispatches; begin ({where}) p50 "
            f"{pct_ms(lg['begin'], 50):.3f} ms p99 "
            f"{pct_ms(lg['begin'], 99):.3f} ms; partial_result "
            f"{len(lg['partial_result'])} calls, p50 "
            f"{pct_ms(lg['partial_result'], 50):.3f} ms p99 "
            f"{pct_ms(lg['partial_result'], 99):.3f} ms")
    # Each hedged dispatch: its first partial against its full result.
    margins = []
    for disp, t_full, _ in flights:
        t_part = [r.future.result(timeout=0).t_done for r in disp.requests
                  if r.future.result(timeout=0).status == "partial"]
        if t_part:
            margins.append(t_full - min(t_part))
    m["margins"] = margins
    held = [h for c in DOOR_CLASSES for h in logs[c]["held"]]
    m["held"] = held
    late = clock.late if clock is not None else {"deadline": [], "window": []}
    served = sum(v for c in got.values() for s, v in c.items()
                 if s != "shed")
    log(f"[door] {run}: {len(futs)} requests offered at {offered:.1f}/s, "
        f"served {served / secs:.1f}/s over {secs:.2f} s; dispatches "
        f"{st['dispatches']}, max open lanes {st['max_open_lanes']}/"
        f"{door.max_queue}; timers late: deadline "
        f"{len(late['deadline'])} fired, p50 "
        f"{pct_ms(late['deadline'], 50):.3f} ms p99 "
        f"{pct_ms(late['deadline'], 99):.3f} ms, window "
        f"{len(late['window'])} fired, p50 {pct_ms(late['window'], 50):.3f} "
        f"ms p99 {pct_ms(late['window'], 99):.3f} ms; hedged dispatches "
        f"{len(margins)}, the full result at the door later than the first "
        f"partial by p50 {pct_ms(margins, 50):.3f} ms, least "
        f"{min(margins) * 1e3 if margins else float('nan'):.3f} ms; every ok "
        f"lane and partial bit-identical to the direct search / "
        f"partial_result ({card})")
    if held:
        log(f"[door] {run}: {len(held)} partials of held flights, "
            f"{sum(a for a, _ in held)} asked while the sleep kernel ahead "
            f"of the flight's continue was pending, "
            f"{sum(a and b for a, b in held)} of those returned while it "
            f"was still pending")
    return m


def door_run(run, world, laws, card, arrivals, rows, cls_of, offered,
             deadlines=None, hold_cycles: int = 0,
             clients: int = DOOR_CLIENTS) -> dict:
    """Pace the requests in on the wall clock (``WallClock`` +
    ``ThreadDispatcher``, each wrapped to record timers and flights) from
    ``clients`` threads, each submitting every ``clients``-th request at
    its arrival time; close the door, and report.

    ``hold_cycles``: a sleep kernel of that many cycles is queued on the
    engine's stream right after each dispatch's ``begin``, so the flight's
    continue waits for it and its probe does not.  Such a run isolates the
    streams: each class engine first serves one flight and its partial
    outside the door (so that no first allocation on a new stream's pool
    falls inside a hold; their launches are returned as ``warm`` and not
    counted), and the garbage collector is off."""
    import threading

    import torch

    from repro_torch import serving
    from repro_torch.kernels import ops

    qn = world["qn"]
    logs = {}
    holds = {} if hold_cycles else None
    engines = door_engines(world["tiered"], laws, logs, holds=holds)
    warm = {}
    if hold_cycles:
        before = ops.launch_counts()
        for c, eng in engines.items():
            f = serving.SearchEngine.begin(eng, qn[:DOOR_CLASSES[c][0]])
            serving.SearchEngine.partial_result(eng, f)
            serving.SearchEngine.finish_from(eng, f)
        warm = {k: v - before[k] for k, v in ops.launch_counts().items()}
        gc.collect()
        gc.disable()

    def hold(disp):
        stream = engines[disp.cls.name]._stream
        with torch.cuda.stream(stream):
            torch.cuda._sleep(hold_cycles)
        ev = torch.cuda.Event()
        ev.record(stream)
        holds[id(disp.flight)] = ev

    clock = LateClock(serving.WallClock())
    flights = FlightLog(serving.ThreadDispatcher(workers=DOOR_WORKERS), clock,
                        hold=hold if hold_cycles else None)
    door = serving.FrontDoor(engines, door_classes(deadlines),
                             max_queue=DOOR_MAX_QUEUE, clock=clock,
                             dispatcher=flights)
    futs = [None] * len(arrivals)
    waits = [[] for _ in range(clients)]
    gc_pauses, gc_start = [], []

    def gc_clock(phase, info):
        # Full collections stop every thread: the door's longest stalls.
        if info["generation"] == 2:
            if phase == "start":
                gc_start.append(time.perf_counter())
            elif gc_start:
                gc_pauses.append(time.perf_counter() - gc_start.pop())

    gc.callbacks.append(gc_clock)
    t0 = time.perf_counter()

    def client(k: int) -> None:
        for i in range(k, len(arrivals), clients):
            lag = arrivals[i] - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
            c = str(cls_of[i])
            t = time.perf_counter()
            futs[i] = (int(rows[i]), c, door.submit(qn[rows[i]], cls=c))
            waits[k].append(time.perf_counter() - t)

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"[door] {run}: a client thread hung")
        door.close(wait=True, timeout=120)
        secs = time.perf_counter() - t0
        flights.settle(120)
    finally:
        if hold_cycles:
            gc.enable()
        gc.callbacks.remove(gc_clock)
        flights.close()
        clock.close()
    m = door_report(run, door, futs, logs, flights.flights, clock, secs,
                    offered, world, card, "the begin thread")
    m["warm"] = warm
    # Each dispatched lane: seconds from its submit to its dispatch's hand-
    # over (a hedge can take the probe from then on) and to its full result.
    m["lanes"] = []
    for d, t_full, _ in flights.flights:
        for r in d.requests:
            t_arr = r.future.result(timeout=0).t_arrival
            m["lanes"].append((flights.begun[id(d)] - t_arr, t_full - t_arr))
    w = [x for ws in waits for x in ws]
    log(f"[door] {run}: a submit held its client p50 {pct_ms(w, 50):.3f} "
        f"ms p99 {pct_ms(w, 99):.3f} ms ({clients} client threads; the "
        f"last arrival {arrivals[-1] if len(arrivals) else 0.0:.2f} s, the "
        f"door closed at {secs:.2f} s); full garbage collections stopped "
        f"the process {len(gc_pauses)} times, for "
        f"{[round(x * 1e3, 1) for x in gc_pauses]} ms")
    return m


def door_laws(world) -> dict:
    """The two classes' budget laws: phase 3b's tiered fit for
    "interactive", the same at ``l_min = l_max`` for "batch", both with the
    LID center pinned to the stream's mean."""
    import dataclasses

    import numpy as np

    from repro_torch import serving

    fitted = world["tiered_law"]
    probe = serving.SearchEngine(world["tiered"], fitted, k=10)
    center = float(np.mean(np.concatenate(
        [r.astats.q_lid for r in probe.search_batches(world["batches"])])))
    log(f"[door] laws: interactive lam={fitted.lam:.4f} "
        f"l_min={fitted.l_min} (phase 3b's tiered fit), batch l_min = "
        f"l_max = {fitted.l_max}; LID center pinned to the stream's mean "
        f"{center:.4f}")
    return {"interactive": dataclasses.replace(fitted, center=center),
            "batch": dataclasses.replace(fitted, l_min=fitted.l_max,
                                         center=center)}


def door_direct(world, laws) -> dict:
    """Each class engine's direct answers to every query of the stream, in
    batches of the stream's size: {"ok": search, "partial": partial_result
    of a begin}, each (class, query row) -> (ids, d2)."""
    from repro_torch import serving

    qn = world["qn"]
    direct = {"ok": {}, "partial": {}}
    for c, law in laws.items():
        eng = serving.SearchEngine(world["tiered"], law, k=10)
        eng.search(qn[:DOOR_CLASSES[c][0]])    # warm-up
        for s in range(0, qn.shape[0], SERVE_BATCH):
            b = qn[s:s + SERVE_BATCH]
            for kind, res in (("ok", eng.search(b)),
                              ("partial", eng.partial_result(eng.begin(b)))):
                for i in range(b.shape[0]):
                    direct[kind][(c, s + i)] = (res.ids[i], res.d2[i])
    return direct


def door_replay(world, laws, card, arrivals, rows, cls_of):
    """The virtual-clock replay (``VirtualDispatcher(service_time=
    "measured")``, ``begin`` under sync debug mode "error").  Returns its
    metrics and each class's capacity in lanes/s (real lanes over the host
    seconds of its dispatches' ``begin`` and ``finish_from``)."""
    from repro_torch import serving

    qn = world["qn"]
    logs = {}
    engines = door_engines(world["tiered"], laws, logs, check_sync=True)
    vclock = serving.VirtualClock()
    flights = FlightLog(serving.VirtualDispatcher(vclock,
                                                  service_time="measured"),
                        vclock)
    door = serving.FrontDoor(engines, door_classes(),
                             max_queue=DOOR_MAX_QUEUE, clock=vclock,
                             dispatcher=flights)
    futs = []
    t0 = time.perf_counter()
    for t_arr, row, c in zip(arrivals, rows, cls_of):
        vclock.run_until(float(t_arr))
        futs.append((int(row), str(c), door.submit(qn[row], cls=str(c))))
    serving.drain_virtual(door, vclock)
    m = door_report("replay", door, futs, logs, flights.flights, None,
                    time.perf_counter() - t0, DOOR_REPLAY_QPS, world, card,
                    "the flushing thread")
    if any(m["counts"][c]["ok"] == 0 for c in DOOR_CLASSES):
        raise AssertionError(f"[door] replay served no ok lane of a class: "
                             f"{m['counts']}")
    cap = {}
    for c in DOOR_CLASSES:
        fl = [(d.n_real, s) for d, _, s in flights.flights
              if d.cls.name == c]
        host = sum(s for _, s in fl) + sum(logs[c]["begin"])
        cap[c] = sum(k for k, _ in fl) / host
        log(f"[door] replay capacity {c}: {cap[c]:.1f} lanes/s ({len(fl)} "
            f"dispatches, {sum(k for k, _ in fl)} lanes, {host:.3f} host s "
            f"of begin + finish_from; p50 a dispatch: begin "
            f"{pct_ms(logs[c]['begin'], 50):.3f} ms, finish_from "
            f"{pct_ms([s for _, s in fl], 50):.3f} ms); every ok lane "
            f"bit-identical to the direct search; "
            f"{len(logs[c]['begin'])} begins without a host sync (sync "
            f"debug mode \"error\")")
    return m, cap


def door_calibrate(world, laws, card, rng, rate: float) -> float:
    """The short deadline, from the gated run's own load: interactive
    requests in groups of 8 at ``rate``, from the same client threads, for
    ``DOOR_CALIB_SECONDS`` under the class's own deadline; the deadline
    lies halfway between the medians of a lane's submit-to-probe-ready
    (its dispatch handed over after ``begin``) and submit-to-full times."""
    import statistics

    m = door_groups("short-deadline calibration", world, laws, card, rng,
                    rate, DOOR_CALIB_SECONDS, "poisson",
                    DOOR_CLASSES["interactive"][2])
    p = statistics.median(a for a, _ in m["lanes"])
    full = statistics.median(b for _, b in m["lanes"])
    deadline = p + 0.5 * (full - p)
    log(f"[door] short-deadline calibration: {len(m['lanes'])} lanes at "
        f"{rate:.1f} requests/s ({DOOR_CLIENTS} client threads, groups of "
        f"{DOOR_CLASSES['interactive'][0]}); submit to probe ready p50 "
        f"{p * 1e3:.3f} ms, to the full result p50 {full * 1e3:.3f} ms; "
        f"short deadline {deadline * 1e3:.3f} ms")
    if not p < deadline < full:
        raise AssertionError(f"[door] no deadline between probe ready "
                             f"({p * 1e3:.3f} ms) and full "
                             f"({full * 1e3:.3f} ms)")
    return deadline


def door_groups(run, world, laws, card, rng, rate: float, seconds: float,
                arrival: str, deadline: float, hold_cycles: int = 0) -> dict:
    """Interactive requests in groups of 8 (one full dispatch each, no
    window wait), ``rate`` requests/s, the interactive deadline
    ``deadline``."""
    import numpy as np

    from repro_torch.launch.serve import arrival_times

    lanes = DOOR_CLASSES["interactive"][0]
    groups = int(rate / lanes * seconds)
    return door_run(run, world, laws, card,
                    np.repeat(arrival_times(rng, groups, rate / lanes,
                                            arrival), lanes),
                    rng.integers(0, world["qn"].shape[0], size=groups * lanes),
                    ["interactive"] * (groups * lanes), rate,
                    deadlines={"interactive": deadline},
                    hold_cycles=hold_cycles)


def door_poisson(run, world, laws, card, rng, rate: float,
                 arrival: str = "poisson",
                 seconds: float = DOOR_SECONDS) -> dict:
    """``seconds`` of arrivals at a mean of ``rate`` requests/s, half in
    each class (bursty: the launcher's generator, its --qps scaled so that
    the mean is ``rate``)."""
    import numpy as np

    from repro_torch.launch.serve import arrival_times

    n = int(rate * seconds)
    qps = rate / BURSTY_MEAN if arrival == "bursty" else rate
    return door_run(run, world, laws, card, arrival_times(rng, n, qps,
                                                          arrival),
                    rng.integers(0, world["qn"].shape[0], size=n),
                    np.where(rng.random(n) < 0.5, "interactive", "batch"),
                    rate)


def door_path(world, card: str, seed: int) -> dict:
    """[door]: the front door over phase 3's in-memory tiered index, two
    QoS classes (the launcher's) each with its own engine over the shared
    backend (:func:`door_laws`).  The virtual-clock replay gives each
    class's capacity from its flights' host seconds.  Then the wall clock:
    Poisson at 150% of the replay's capacity (overload: the door must
    shed; ``DOOR_OVERLOAD_SECONDS`` of arrivals, which the door takes
    several times as long to absorb), whose served lanes a second measure
    the wall-clock door's capacity; Poisson and bursty at 50% of that (no
    shed at Poisson); a short-deadline run whose hedges fire, its
    deadline from a calibration segment at the same load
    (:func:`door_calibrate`); and held
    flights, whose continue a sleep kernel holds back past their
    deadline, so that each partial must return before the continue can.
    Returns the launch counts of the door's runs alone."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import arrival_times

    t_phase = time.perf_counter()
    laws = door_laws(world)
    rng = np.random.default_rng(seed + 20)
    rows = rng.integers(0, world["qn"].shape[0], size=DOOR_REPLAY)
    cls_of = rng.permutation(np.repeat(list(DOOR_CLASSES), DOOR_REPLAY // 2))
    arrivals = arrival_times(rng, DOOR_REPLAY, DOOR_REPLAY_QPS, "poisson")
    world["door_direct"] = door_direct(world, laws)

    ops.reset_launch_counts()
    replay, cap = door_replay(world, laws, card, arrivals, rows, cls_of)
    cap_mix = 1.0 / sum(0.5 / v for v in cap.values())
    runs = {"replay": replay}
    over = runs["poisson 150%"] = door_poisson(
        "poisson 150%", world, laws, card, rng, 1.5 * cap_mix,
        seconds=DOOR_OVERLOAD_SECONDS)
    served = sum(v for c in over["counts"].values()
                 for s, v in c.items() if s in ("ok", "partial"))
    wall = served / over["secs"]
    log(f"[door] capacity: the replay's {cap_mix:.1f} requests/s (half and "
        f"half, full dispatches, one thread); the wall-clock door served "
        f"{wall:.1f} ok + partial lanes/s under overload "
        f"({wall / cap_mix:.3f} of the replay's): the 50% runs take half of "
        f"that")
    runs["poisson 50%"] = door_poisson("poisson 50%", world, laws, card, rng,
                                       0.5 * wall)
    runs["bursty 50%"] = door_poisson("bursty 50%", world, laws, card, rng,
                                      0.5 * wall, "bursty")
    short_deadline = door_calibrate(world, laws, card, rng, 0.25 * wall)
    runs["short deadline"] = short = door_groups(
        "short deadline", world, laws, card, rng, 0.25 * wall,
        DOOR_SHORT_SECONDS, "poisson", short_deadline)
    lanes = DOOR_CLASSES["interactive"][0]
    runs["held"] = held = door_run(
        "held continue", world, laws, card,
        np.repeat(np.arange(DOOR_HELD_GROUPS) * DOOR_HELD_GAP, lanes),
        rng.integers(0, world["qn"].shape[0],
                     size=DOOR_HELD_GROUPS * lanes),
        ["interactive"] * (DOOR_HELD_GROUPS * lanes),
        lanes / DOOR_HELD_GAP, deadlines={"interactive": DOOR_HELD_DEADLINE},
        hold_cycles=DOOR_HOLD_CYCLES, clients=1)
    counts = {k: v - held["warm"].get(k, 0)
              for k, v in ops.launch_counts().items()}
    log(f"[door] kernel launches on the path (the door's runs): "
        f"{ {k: v for k, v in counts.items() if v} }; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del world["door_direct"]
    if counts["beam_step.pq"] == 0:
        raise AssertionError("[door] beam_step.pq was never launched")
    if runs["poisson 50%"]["stats"]["shed"] != 0:
        raise AssertionError("[door] the door shed requests at 50% load")
    if over["stats"]["shed"] == 0:
        raise AssertionError("[door] nothing was shed at 150% load")
    # Phase 3's gate over each run's ok lanes, both classes.  Not the
    # short-deadline or held runs': their ok lanes are the flights that
    # beat a deadline set below the median flight, the shortest walks.
    for run, r in runs.items():
        if run in ("short deadline", "held"):
            continue
        oks = [(r["recall_ok"][c], r["counts"][c]["ok"])
               for c in DOOR_CLASSES if r["counts"][c]["ok"]]
        if oks and np.average([a for a, _ in oks],
                              weights=[w for _, w in oks]) < RECALL_FLOOR:
            raise AssertionError(f"[door] {run}: recall@10 of ok lanes "
                                 f"below {RECALL_FLOOR}")
    if short["stats"]["partial"] == 0:
        raise AssertionError("[door] no hedge fired in the short-deadline "
                             "run")
    asked = [b for a, b in held["held"] if a]
    if not asked or not all(asked):
        raise AssertionError(f"[door] held continue: of {len(asked)} "
                             f"partials asked while their flight's continue "
                             f"was held back, {len(asked) - sum(asked)} "
                             f"returned only after the hold: a partial "
                             f"queued behind the engine's stream")
    return counts


# --------------------------------------------------------------- phase 3d

# The packed-store runs of [disk] and [ooc] serve the stream's first 5
# batches (a cut for time: the packed store reads about 3x the blocks a
# query, and the two runs took 87 s of the smoke at all 10).
PACKED_BATCHES = 5


def packed_cut(world) -> dict:
    """``world`` with the stream cut to its first ``PACKED_BATCHES``."""
    return dict(world, batches=world["batches"][:PACKED_BATCHES],
                gts=world["gts"][:PACKED_BATCHES])


def disk_served(name, engine, tier, world, want, pipelined: bool) -> dict:
    """Serve phase 3's stream with the slow tier on disk; every batch's ids
    and d2 must equal the in-memory tiered run's bit for bit.  Prints the
    serving metrics and the tier's measured figures."""
    import numpy as np

    tier.reset_stats()
    got: list = []
    m = serve_run(name, engine, world["batches"], world["gts"], world["n"],
                  pipelined, keep=got)
    for bi, (g, w) in enumerate(zip(got, want)):
        if not (np.array_equal(g.ids, w.ids) and np.array_equal(g.d2, w.d2)):
            raise AssertionError(f"[disk] {name}: batch {bi} differs from "
                                 f"the in-memory tiered run")
    st, lat = tier.stats(), tier.fetch_latency_us()
    nq = sum(b.shape[0] for b in world["batches"])
    m.update(st, **lat, io_blocks_per_query=st["io_blocks"] / nq,
             fetch_share=lat["fetch_p50_us"] / 1e3 / m["p50_ms"])
    log(f"[disk] {name}: ids and d2 bit-identical to the in-memory tiered "
        f"run; qps={m['qps']:.1f} batch p50={m['p50_ms']:.2f}ms "
        f"p99={m['p99_ms']:.2f}ms recall@10={m['recall']:.4f} "
        f"hit_rate={st['hit_rate']:.4f} blocks_read={st['blocks_read']} "
        f"io_blocks/query={m['io_blocks_per_query']:.2f} "
        f"measured_read_us={st['measured_read_us']:.3f} "
        f"fetch p50={lat['fetch_p50_us']:.0f}us "
        f"p99={lat['fetch_p99_us']:.0f}us ({lat['fetch_samples']} fetches; "
        f"fetch p50 / batch p50 = {m['fetch_share']:.3f}); reads come from "
        "the OS page cache (the store was just written), not SSD latencies")
    return m


def disk_path(world, tmp: str) -> tuple[dict, dict]:
    """The disk-resident slow tier at phase 3's 1M index: stores written to
    ``tmp``, the stream served pipelined and per batch, with a hot tier,
    from a packed store, and from a saved and reloaded v2 index, each
    bit-identical to the in-memory tiered run.  Returns the launch counts of
    the disk runs and the paths of the node-order and packed stores (left
    in ``tmp`` for phase 3e)."""
    import torch

    from repro_torch import serving
    from repro_torch.core import build
    from repro_torch.index import (load_index, load_slow_tier,
                                   open_or_build_slow_tier, save_index)
    from repro_torch.index.serializer import blocks_path
    from repro_torch.kernels import ops

    cfg = sift1m()
    index = world["tiered"].index
    budget = cfg.beam_budget()
    want: list = []
    mem = serve_run("in-memory tiered adaptive pipelined (the [disk] "
                    "reference)", serving.SearchEngine(world["tiered"],
                                                       budget, k=cfg.k),
                    world["batches"], world["gts"], world["n"], True,
                    keep=want)
    log(f"[disk] stores in {tmp} (removed when phase 3e ends)")
    tiers = []

    def tier_engine(tier, idx=index):
        tiers.append(tier)
        return serving.SearchEngine(
            serving.TieredBackend(idx, slow_tier=tier, device=idx.device),
            budget, k=cfg.k)

    def disk_log(msg):
        log(f"[disk] {msg}")

    try:
        ops.reset_launch_counts()
        runs = {}
        node_path = os.path.join(tmp, "sift1m.blocks")
        t0 = time.perf_counter()
        tier = open_or_build_slow_tier(node_path, index, cache_nodes=4096,
                                       pin_nodes=256, log=disk_log)
        secs = time.perf_counter() - t0
        size = os.path.getsize(node_path)
        log(f"[disk] node-order store: {size} bytes "
            f"({tier.store.block_size} B records, {tier.store.n} nodes) "
            f"written and opened in {secs:.2f}s; cache_nodes=4096 "
            f"pin_nodes=256")
        eng = tier_engine(tier)
        eng.search(world["qn"][:64])                       # warm-up
        runs["pipelined"] = disk_served("node order, pipelined", eng, tier,
                                        world, want, True)
        runs["per_batch"] = disk_served("node order, per batch", eng, tier,
                                        world, want, False)
        mtime = os.stat(node_path).st_mtime_ns
        hot = open_or_build_slow_tier(node_path, index, cache_nodes=4096,
                                      pin_nodes=256, hot_nodes=65536,
                                      log=disk_log)
        if os.stat(node_path).st_mtime_ns != mtime:
            raise AssertionError("[disk] a second open_or_build_slow_tier "
                                 "rewrote the store")
        log("[disk] second open_or_build_slow_tier on the same path reused "
            "the store (mtime unchanged)")
        eng = tier_engine(hot)
        for p in (1, 2):
            runs[f"hot_pass{p}"] = disk_served(
                f"hot tier 65536, pass {p}, pipelined", eng, hot, world,
                want, True)
            hot.drain_promotions()
            st = hot.stats()
            log(f"[disk] hot tier after pass {p}: resident "
                f"{st['hot_nodes']}/{st['hot_capacity']} hot_hits="
                f"{st['hot_hits']} promotions={st['promotions']} "
                f"demotions={st['demotions']} ticks={st['promotion_ticks']} "
                f"promotion_io_blocks={st['promotion_io_blocks']}")
        t0 = time.perf_counter()
        slot_of = build.block_layout(index.graph, nodes_per_block=4)
        t_layout = time.perf_counter() - t0
        packed_path = os.path.join(tmp, "sift1m-packed.blocks")
        t0 = time.perf_counter()
        packed = open_or_build_slow_tier(packed_path, index,
                                         cache_nodes=4096, pin_nodes=256,
                                         nodes_per_block=4, slot_of=slot_of,
                                         log=disk_log)
        log(f"[disk] block_layout (greedy_block_pack, 4 x 1 KiB records a "
            f"4 KiB page) in {t_layout:.2f}s; packed store "
            f"{os.path.getsize(packed_path)} bytes written in "
            f"{time.perf_counter() - t0:.2f}s")
        log(f"[disk] packed store cut for time: {PACKED_BATCHES} of the "
            f"stream's {len(world['batches'])} batches")
        runs["packed"] = disk_served("packed 4 a page, pipelined",
                                     tier_engine(packed), packed,
                                     packed_cut(world), want, True)
        log(f"[disk] io_blocks/query: node order "
            f"{runs['pipelined']['io_blocks_per_query']:.2f}, packed "
            f"{runs['packed']['io_blocks_per_query']:.2f}")
        npz = os.path.join(tmp, "sift1m.npz")
        t0 = time.perf_counter()
        save_index(npz, index, version=2)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_index(npz, device=index.device)
        t_load = time.perf_counter() - t0
        for name, a, b in (
                ("adj", index.graph.adj, loaded.graph.adj),
                ("entry", index.graph.entry, loaded.graph.entry),
                ("alpha", index.graph.alpha, loaded.graph.alpha),
                ("lid", index.graph.lid, loaded.graph.lid),
                ("mu", index.graph.mu, loaded.graph.mu),
                ("sigma", index.graph.sigma, loaded.graph.sigma),
                ("centroids", index.codebook.centroids,
                 loaded.codebook.centroids),
                ("codes", index.codes, loaded.codes),
                ("vectors", index.vectors, loaded.vectors)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"[disk] v2 round trip changed {name}")
        log(f"[disk] save_index(version=2): npz "
            f"{os.path.getsize(npz)} bytes + sidecar "
            f"{os.path.getsize(blocks_path(npz))} bytes in {t_save:.2f}s; "
            f"load_index on the card in {t_load:.2f}s: every array equal")
        v2_tier = load_slow_tier(npz)
        runs["v2"] = disk_served("load_slow_tier of the v2 index, pipelined",
                                 tier_engine(v2_tier, loaded), v2_tier,
                                 world, want, True)
        counts = ops.launch_counts()
    finally:
        for t in tiers:
            t.close()
    log(f"[disk] in-memory qps {mem['qps']:.1f} against disk-served "
        f"pipelined {runs['pipelined']['qps']:.1f} and per batch "
        f"{runs['per_batch']['qps']:.1f}; kernel launches on the disk "
        f"path: { {k: v for k, v in counts.items() if v} }")
    if counts["beam_step.pq"] == 0:
        raise AssertionError("[disk] beam_step.pq was never launched on the "
                             "disk path")
    return counts, {"node": node_path, "packed": packed_path}


# --------------------------------------------------------------- phase 3e

class ReadTally:
    """The block reads of a ``BlockSlowTier``, split by kind: ``fetch_adj``
    calls (the walk's adjacency rows) and ``fetch_beams`` calls (the
    rerank's vectors).  Wraps those two methods of the tier and the store
    reads under them; each store read runs under the tier's I/O lock, so the
    store counters read around it belong to that read alone, and a
    thread-local tag says which kind of fetch made it.  Per kind: calls,
    distinct valid ids, blocks read, I/O blocks and each call's wall time."""

    KINDS = (("walk", "fetch_adj"), ("rerank", "fetch_beams"))

    def __init__(self, tier):
        import threading

        self.local = threading.local()
        self.lock = threading.Lock()
        self.reset()
        for kind, name in self.KINDS:
            setattr(tier, name, self._tagged(kind, getattr(tier, name)))
        store = tier.store
        for name in ("read_many", "read_blocks"):
            setattr(store, name, self._counted(store, getattr(store, name)))

    def reset(self) -> None:
        self.by = {k: dict(calls=0, ids=0, blocks_read=0, io_blocks=0, us=[])
                   for k, _ in self.KINDS}

    def _tagged(self, kind, fn):
        import numpy as np

        def wrapped(ids):
            ids = np.asarray(ids)
            self.local.kind = kind
            t0 = time.perf_counter()
            try:
                return fn(ids)
            finally:
                us = (time.perf_counter() - t0) * 1e6
                self.local.kind = None
                with self.lock:
                    rec = self.by[kind]
                    rec["calls"] += 1
                    rec["ids"] += int(np.unique(ids[ids >= 0]).size)
                    rec["us"].append(us)
        return wrapped

    def _counted(self, store, fn):
        def wrapped(*args, **kw):
            b0, i0 = store.stats.blocks_read, store.stats.io_blocks
            out = fn(*args, **kw)
            kind = getattr(self.local, "kind", None)
            if kind is not None:
                with self.lock:
                    self.by[kind]["blocks_read"] += store.stats.blocks_read - b0
                    self.by[kind]["io_blocks"] += store.stats.io_blocks - i0
            return out
        return wrapped


def backend_device_tensors(backend) -> list:
    """The tensors on the card that an ``OutOfCoreBackend`` holds."""
    import torch

    held = [v for v in vars(backend).values() if isinstance(v, torch.Tensor)]
    return held + [backend.codebook.centroids]


def ooc_served(name, engine, tally, world, want, pipelined: bool,
               card: str, device_ms) -> dict:
    """Serve phase 3's stream out-of-core; every batch's ids, d2, hops and
    granted budgets must equal the in-memory tiered run's bit for bit.
    Prints the serving metrics, the walk's host hops and their parts beside
    ``device_ms`` (a row-fed launch's device time in the trace of one
    batch), and the tier's reads split into walk and rerank."""
    import numpy as np

    back, tier = engine.backend, engine.backend.slow_tier
    tier.reset_stats()
    tally.reset()
    back.timings = {}
    got: list = []
    m = serve_run(name, engine, world["batches"], world["gts"], world["n"],
                  pipelined, keep=got)
    t = back.timings
    back.timings = None
    for bi, (g, w) in enumerate(zip(got, want)):
        if not (np.array_equal(g.ids, w.ids) and np.array_equal(g.d2, w.d2)
                and np.array_equal(np.asarray(g.stats.hops),
                                   np.asarray(w.stats.hops))
                and (w.astats is None or np.array_equal(
                    np.asarray(g.astats.budget),
                    np.asarray(w.astats.budget)))):
            raise AssertionError(f"[ooc] {name}: batch {bi} differs from the "
                                 f"in-memory tiered run")
    st, lat = tier.stats(), tier.fetch_latency_us()
    nb = len(got)
    nq = sum(g.ids.shape[0] for g in got)
    hops = max(t.get("hops", 0), 1)
    host_ms = {k: t.get(k, 0.0) * 1e3 / hops
               for k in ("wait_s", "copy_s", "launch_s", "sync_s")}
    split = {k: dict(calls=v["calls"], ids_per_query=v["ids"] / nq,
                     blocks_read=v["blocks_read"],
                     io_blocks_per_query=v["io_blocks"] / nq,
                     fetch_p50_us=float(np.percentile(v["us"], 50))
                     if v["us"] else 0.0,
                     fetch_p99_us=float(np.percentile(v["us"], 99))
                     if v["us"] else 0.0)
             for k, v in tally.by.items()}
    m.update(st, **lat, host_hops_per_batch=t.get("hops", 0) / nb,
             walks=t.get("walks", 0), walk_s=t.get("walk_s", 0.0),
             host_ms_per_hop=sum(host_ms.values()), host_ms_parts=host_ms,
             io_blocks_per_query=st["io_blocks"] / nq, reads=split)
    w_, r_ = split["walk"], split["rerank"]
    log(f"[ooc] {name} ({card}): ids, d2, hops and budgets bit-identical to "
        f"the in-memory tiered run; qps={m['qps']:.1f} batch "
        f"p50={m['p50_ms']:.2f}ms p99={m['p99_ms']:.2f}ms "
        f"recall@10={m['recall']:.4f}; host hops a batch "
        f"{m['host_hops_per_batch']:.1f} ({m['walks']} walks, "
        f"{m['walk_s']:.3f}s in them), pq_rows launches "
        f"{m['launches']['beam_step.pq_rows']}; device {device_ms} ms a hop "
        f"launch (trace of one batch) against host "
        f"{m['host_ms_per_hop']:.4f} ms a host hop (wait for rows "
        f"{host_ms['wait_s']:.4f}, copy {host_ms['copy_s']:.4f}, launch "
        f"{host_ms['launch_s']:.4f}, read frontier {host_ms['sync_s']:.4f})")
    log(f"[ooc] {name} reads: hit_rate={st['hit_rate']:.4f} "
        f"io_blocks/query={m['io_blocks_per_query']:.2f} (walk "
        f"{w_['io_blocks_per_query']:.2f}, rerank "
        f"{r_['io_blocks_per_query']:.2f}); ids/query walk "
        f"{w_['ids_per_query']:.2f} rerank {r_['ids_per_query']:.2f}; "
        f"fetch p50={lat['fetch_p50_us']:.0f}us p99={lat['fetch_p99_us']:.0f}us "
        f"over {lat['fetch_samples']} fetches (walk calls {w_['calls']} p50 "
        f"{w_['fetch_p50_us']:.0f}us p99 {w_['fetch_p99_us']:.0f}us; rerank "
        f"calls {r_['calls']} p50 {r_['fetch_p50_us']:.0f}us p99 "
        f"{r_['fetch_p99_us']:.0f}us); reads come from the OS page cache")
    return m


def ooc_profile(engine, batch, card: str) -> dict:
    """``torch.profiler`` over one batch served alone: the row-fed kernel's
    device time per launch from the trace, beside the device's busy time
    (the union of its kernel and copy intervals) and the batch's wall
    time.  The profiler's own host overhead is in the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type.name == "CUDA"
              and e.time_range.elapsed_us() > 0]
    hop = [e.time_range.elapsed_us() for e in events
           if "beam_hop_rows_kernel" in e.name]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    out = dict(wall_ms=wall, busy_ms=busy / 1e3, launches=len(hop),
               kernel_ms=(f"{statistics.mean(hop) / 1e3:.4f}" if hop
                          else "not measured"),
               kernel_ms_p99=(sorted(hop)[int(0.99 * (len(hop) - 1))] / 1e3
                              if hop else None))
    if not hop:
        log(f"[ooc] profile of one batch ({card}): the trace holds no "
            f"row-fed kernel; device time per hop launch not measured")
        return out
    log(f"[ooc] profile of one batch served alone ({card}): "
        f"{len(hop)} row-fed hop launches, {out['kernel_ms']} ms of "
        f"device time each (mean; p99 {out['kernel_ms_p99']:.4f}), "
        f"{sum(hop) / 1e3:.2f} ms in all; device busy "
        f"{out['busy_ms']:.2f} of {wall:.2f} ms wall (idle share "
        f"{1 - out['busy_ms'] / wall:.4f}; the profiler's host overhead "
        f"included)")
    return out


def ooc_path(world, stores: dict, card: str) -> dict:
    """[ooc]: the out-of-core walk at phase 3's 1M index.  The in-memory
    tiered results first (pipelined adaptive, and one fixed-beam batch),
    then the stream through ``OutOfCoreBackend`` over [disk]'s node-order
    store pipelined and per batch, over its packed store pipelined (the
    first ``PACKED_BATCHES`` batches), and the fixed-beam batch, each
    bit-identical to the in-memory run.  Returns the
    launch counts of the out-of-core runs."""
    from repro_torch import serving
    from repro_torch.index import BlockSlowTier, BlockStore, entry_proximal_ids
    from repro_torch.kernels import ops

    cfg = sift1m()
    budget = cfg.beam_budget()
    index = world["tiered"].index
    n, r = index.graph.adj.shape
    d = index.vectors.shape[1]
    want: list = []
    serve_run("in-memory tiered adaptive pipelined (the [ooc] reference)",
              serving.SearchEngine(world["tiered"], budget, k=cfg.k),
              world["batches"], world["gts"], world["n"], True, keep=want)
    fixed_kw = dict(k=cfg.k, beam_width=cfg.l_search, max_hops=cfg.max_hops)
    want_fixed = [serving.SearchEngine(world["tiered"], None, **fixed_kw)
                  .search(world["batches"][0])]
    pins = entry_proximal_ids(index.graph.adj, index.graph.entry, limit=256)
    tiers = []

    def backend(path):
        tier = BlockSlowTier(BlockStore(path), cache_nodes=4096,
                             pinned_ids=pins)
        tiers.append(tier)
        back = serving.OutOfCoreBackend(index.codes, index.codebook,
                                        index.graph.entry, tier,
                                        device=index.device)
        for t in backend_device_tensors(back):
            if t.numel() in (n * r, n * d):
                raise AssertionError(f"[ooc] the backend holds a tensor of "
                                     f"{tuple(t.shape)}: the graph or the "
                                     f"vectors on the card")
        return back, ReadTally(tier)

    try:
        back, tally = backend(stores["node"])
        held = sum(t.numel() * t.element_size()
                   for t in backend_device_tensors(back))
        log(f"[ooc] the backend holds {held} bytes on the card ({card}; codes "
            f"{tuple(back.codes.shape)} uint8, codebook "
            f"{tuple(back.codebook.centroids.shape)}, entry) against the "
            f"in-memory index's {index.fast_tier_bytes()} fast-tier bytes; "
            f"no (N, R) or (N, D) tensor; cache_nodes=4096 pins=256 "
            f"io_groups={back.io_groups} io_depth={back.io_depth}")
        eng = serving.SearchEngine(back, budget, k=cfg.k)
        eng.search(world["qn"][:64])                        # warm-up
        dev_ms = ooc_profile(eng, world["batches"][1], card)["kernel_ms"]
        ops.reset_launch_counts()
        runs = {"pipelined": ooc_served("node order, pipelined", eng, tally,
                                        world, want, True, card, dev_ms),
                "per_batch": ooc_served("node order, per batch", eng, tally,
                                        world, want, False, card, dev_ms)}
        packed, ptally = backend(stores["packed"])
        log(f"[ooc] packed store cut for time: {PACKED_BATCHES} of the "
            f"stream's {len(world['batches'])} batches")
        runs["packed"] = ooc_served(
            "packed 4 a page, pipelined",
            serving.SearchEngine(packed, budget, k=cfg.k), ptally,
            packed_cut(world), want, True, card, dev_ms)
        one = dict(world, batches=world["batches"][:1], gts=world["gts"][:1])
        runs["fixed"] = ooc_served(
            "fixed beam 128, one batch",
            serving.SearchEngine(back, None, **fixed_kw), tally, one,
            want_fixed, False, card, dev_ms)
        counts = ops.launch_counts()
    finally:
        for t in tiers:
            t.close()
    log(f"[ooc] kernel launches on the out-of-core path: "
        f"{ {k: v for k, v in counts.items() if v} }")
    if counts["beam_step.pq_rows"] == 0:
        raise AssertionError("[ooc] beam_step.pq_rows was never launched")
    if counts["beam_step.pq"] != 0:
        raise AssertionError("[ooc] the resident walk (beam_step.pq) ran on "
                             "the out-of-core path")
    return counts


# --------------------------------------------------------------- phase 3f

def live_serve(name, live, batches, gts, gone, card: str) -> dict:
    """Serve ``batches`` through ``LiveIndex.search`` one call a batch;
    recall@10 of the external ids against ``gts`` (external ids too).  No
    result may hold an id of ``gone`` (the tombstoned ids) or fall outside
    the ids inserted so far."""
    import numpy as np

    lat, recalls = [], []
    t_all = time.perf_counter()
    for b, g in zip(batches, gts):
        t0 = time.perf_counter()
        ext, d2 = live.search(b)
        lat.append((time.perf_counter() - t0) * 1e3)
        check_live_result(name, live, ext, d2, b.shape[0], gone)
        recalls.append(float(np.mean([np.isin(e, t).mean()
                                      for e, t in zip(ext, g)])))
    secs = time.perf_counter() - t_all
    m = dict(recall=float(np.mean(recalls)),
             qps=sum(b.shape[0] for b in batches) / secs,
             p50_ms=float(np.percentile(lat, 50)),
             p99_ms=float(np.percentile(lat, 99)))
    log(f"[live] {name}: recall@10={m['recall']:.4f} qps={m['qps']:.1f} "
        f"batch p50={m['p50_ms']:.1f}ms p99={m['p99_ms']:.1f}ms "
        f"({len(batches)} batches of {batches[0].shape[0]}; {card})")
    return m


def check_live_result(name, live, ext, d2, nq: int, gone) -> None:
    import numpy as np

    if ext.shape != (nq, live.k):
        raise AssertionError(f"[live] {name}: result shape {ext.shape}")
    if not ((ext >= -1) & (ext < live._next_ext)).all():
        raise AssertionError(f"[live] {name}: an external id outside "
                             f"[-1, {live._next_ext})")
    if not np.isfinite(d2[ext >= 0]).all():
        raise AssertionError(f"[live] {name}: non-finite d2 for a valid id")
    if gone is not None and np.isin(ext, gone).any():
        raise AssertionError(f"[live] {name}: a deleted id was returned")


def live_gt(x, live_rows, queries, k: int):
    """Ground truth over the live rows of ``x`` (external id = row of x):
    ``brute_force_topk`` over those rows, positions mapped back."""
    import numpy as np
    import torch

    from repro_torch.core import distance

    rows = torch.as_tensor(live_rows, device=x.device)
    q = torch.as_tensor(queries, device=x.device)
    _, pos = distance.brute_force_topk(q, x[rows], k)
    return np.asarray(live_rows)[pos.cpu().numpy()]


def live_path(world, tmp: str, card: str, seed: int, rows: int = LIVE_ROWS,
              inserts: int = LIVE_INSERTS, deletes: int = LIVE_DELETES
              ) -> dict:
    """[live]: the write path at the first ``rows`` of phase 3's rows.
    ``LiveIndex`` over the first ``rows`` - ``inserts`` of them (online
    build, PQ tier, a packed block store in ``tmp``), the stream served;
    the last ``inserts`` rows inserted in
    ``LIVE_INSERT_CALLS`` calls and each found at rank 0 with d2 = 0; the
    stream served again; ``deletes`` base ids tombstoned and the stream
    served (engine and ``DeltaTier.search_exact``); ``merge_async`` while
    the stream is served; the stream at the merge boundary; ``save`` and
    the lineage.  Returns the launch counts of the path (the ground
    truths' launches taken out)."""
    import numpy as np
    import torch

    from repro_torch.core import build
    from repro_torch.index import load_lineage
    from repro_torch.index.delta import LiveIndex
    from repro_torch.kernels import ops

    cfg = sift1m()
    full = world["tiered"].index.vectors              # phase 3's rows
    x = full[:rows]
    n, dev = x.shape[0], x.device
    n_base = n - inserts
    batches, qn = world["batches"], world["qn"]
    rng = np.random.default_rng(seed + 19)
    calib = qn[rng.choice(qn.shape[0], min(CALIB_SAMPLE, qn.shape[0]),
                          replace=False)]
    ref = world["tiered_recall"]
    checks = {k: 0 for k in ops.launch_counts()}

    def uncounted(fn):
        before = ops.launch_counts()
        out = fn()
        for k_, v in ops.launch_counts().items():
            checks[k_] += v - before[k_]
        return out

    def split(gt):
        return [gt[s:s + b.shape[0]] for s, b in zip(
            np.cumsum([0] + [b.shape[0] for b in batches[:-1]]), batches)]

    stage = batches[:LIVE_STAGE_BATCHES]
    log(f"[live] cut for time: rows {full.shape[0] * 99 // 100:,} -> {n:,} "
        f"(the base the write path had over all {full.shape[0]:,} of phase "
        f"3's rows, against the first {n:,} of them now: a base of "
        f"{n_base:,}, {inserts:,} inserts and {deletes:,} deletes); each "
        f"stage serves {len(stage)} of the stream's {len(batches)} batches")

    ops.reset_launch_counts()
    bcfg = build.BuildConfig(degree=cfg.degree, beam_width=cfg.l_build,
                             alpha_min=cfg.alpha_min,
                             alpha_max=cfg.alpha_max, batch=BUILD_BATCH,
                             seed=seed)
    t0 = time.perf_counter()
    live = LiveIndex(x[:n_base], bcfg, budget_cfg=cfg.beam_budget(),
                     k=cfg.k, beam_width=cfg.l_search, max_hops=cfg.max_hops,
                     m_pq=M_PQ, store_dir=tmp, nodes_per_block=4,
                     merge_threshold=10 ** 12, calib=calib,
                     recall_target=TIERED_TARGET, device=dev)
    t_init = time.perf_counter() - t0
    try:
        bt, delta = live.build_timings, live._state.delta
        store = os.path.join(tmp, "live.g0.blocks")
        log(f"[live] LiveIndex over {n_base} rows in {t_init:.1f}s: online "
            f"build (R={bcfg.degree} L={bcfg.beam_width} batch={bcfg.batch}) "
            + " ".join(f"{k}={bt[k]:.1f}s" for k in
                       ("bootstrap", "rewire_walks", "prune",
                        "reverse_insert"))
            + f"; bootstrap mu={float(delta.mu)!r} "
            f"sigma={float(delta.sigma)!r}; PQ tier m={M_PQ} "
            f"{bt['pq_tier']:.1f}s; block_layout {bt['layout']:.1f}s; store "
            f"{os.path.getsize(store)} bytes (4 records a page) written in "
            f"{bt['store']:.1f}s; launches "
            f"{ {k: v for k, v in ops.launch_counts().items() if v} }")
        log(f"[live] phase 3's in-memory tiered adaptive recall@10 (the "
            f"offline build over all {full.shape[0]:,} rows): {ref:.4f}, "
            f"printed beside each [live] recall; gate {LIVE_RECALL_FLOOR}")
        gt0 = uncounted(lambda: live_gt(x, np.arange(n_base), qn, cfg.k))
        live.search(qn[:64])                                # warm-up
        runs = {"base": live_serve(f"base, {n_base:,}-row index", live,
                                   stage, split(gt0), None, card)}

        # Inserts: the last rows, in LIVE_INSERT_CALLS calls.
        per_call = inserts // LIVE_INSERT_CALLS
        call_ms, new_ids = [], []
        for c in range(LIVE_INSERT_CALLS):
            rows = x[n_base + c * per_call:n_base + (c + 1) * per_call]
            sync(dev)
            t0 = time.perf_counter()
            ids = live.insert(rows, auto_merge=False)
            sync(dev)
            call_ms.append((time.perf_counter() - t0) * 1e3)
            new_ids.append(ids)
        new_ids = np.concatenate(new_ids)
        if not np.array_equal(new_ids, np.arange(n_base, n_base + inserts)):
            raise AssertionError("[live] inserts did not get the next "
                                 "external ids in order")
        log(f"[live] inserts: {LIVE_INSERT_CALLS} calls of {per_call} "
            f"vectors: ms a call {[round(v, 1) for v in call_ms]} (p50 "
            f"{np.percentile(call_ms, 50):.1f} ms); "
            f"{inserts / (sum(call_ms) / 1e3):.1f} vectors/s ({card})")
        own = x[n_base:].cpu().numpy()

        def self_query(what: str) -> tuple[np.ndarray, np.ndarray]:
            """Each inserted vector as a query: its rank-0 external id and
            whether it came back at d2 = 0."""
            firsts, exact = [], []
            for s in range(0, own.shape[0], SERVE_BATCH):
                ext, d2 = live.search(own[s:s + SERVE_BATCH])
                check_live_result(what, live, ext, d2,
                                  min(SERVE_BATCH, own.shape[0] - s), None)
                firsts.append(ext[:, 0])
                exact.append(d2[:, 0] == 0)
            return np.concatenate(firsts), np.concatenate(exact)

        before_merge, hit = self_query("self-queries after the inserts")
        if not (np.array_equal(before_merge, new_ids) and hit.all()):
            raise AssertionError("[live] an inserted vector is not its own "
                                 "rank-0 result with d2 = 0 (bounded "
                                 "staleness)")
        log(f"[live] self-queries after the inserts: all {own.shape[0]} "
            f"inserted vectors found at rank 0 with d2 = 0")
        gt_all = uncounted(lambda: live_gt(x, np.arange(n), qn, cfg.k))
        runs["inserted"] = live_serve(
            f"after inserts (live = the first {n:,} rows)", live, stage,
            split(gt_all), None, card)

        # Deletes: base external ids from the seed.
        gone = np.sort(rng.choice(n_base, deletes, replace=False))
        t0 = time.perf_counter()
        live.delete(gone)
        log(f"[live] deleted {deletes} base ids in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        alive = np.setdiff1d(np.arange(n), gone)
        gt1 = uncounted(lambda: live_gt(x, alive, qn, cfg.k))
        runs["deleted"] = live_serve("after deletes", live, stage,
                                     split(gt1), gone, card)
        st = live._state
        recalls, t0 = [], time.perf_counter()
        for b, g in zip(batches, split(gt1)):
            ids, d2, _ = st.delta.search_exact(b, beam_width=cfg.l_search,
                                               k=cfg.k,
                                               max_hops=cfg.max_hops)
            ext = np.where(ids.cpu().numpy() >= 0,
                           st.ext_of[ids.clamp_min(0).cpu().numpy()], -1)
            check_live_result("search_exact", live, ext, d2.cpu().numpy(),
                              b.shape[0], gone)
            recalls.append(float(np.mean([np.isin(e, t).mean()
                                          for e, t in zip(ext, g)])))
        secs = time.perf_counter() - t0
        runs["search_exact"] = dict(recall=float(np.mean(recalls)),
                                    qps=qn.shape[0] / secs)
        log(f"[live] DeltaTier.search_exact over the mutated graph (beam "
            f"{cfg.l_search}, batches of {batches[0].shape[0]}): recall@10="
            f"{runs['search_exact']['recall']:.4f} "
            f"qps={runs['search_exact']['qps']:.1f}; no deleted id")

        # Merge under traffic.
        old_mu, timed = float(st.delta.mu), {}
        merge = live.merge

        def timed_merge():
            t = time.perf_counter()
            gen = merge()
            timed["secs"] = time.perf_counter() - t
            return gen

        live.merge = timed_merge
        during, served, nq = [], 0, 0
        t_all = time.perf_counter()
        thread = live.merge_async()
        while thread.is_alive():
            b = batches[served % len(batches)]
            t0 = time.perf_counter()
            ext, d2 = live.search(b)
            secs = time.perf_counter() - t0
            during.append(secs * 1e3)
            check_live_result("during the merge", live, ext, d2, b.shape[0],
                              gone)
            served, nq = served + 1, nq + b.shape[0]
            # Offer half the closed loop's load: the merge's build and the
            # serving threads share the GIL, and back to back serving slowed
            # the build 6.7x.
            time.sleep(secs * (1 / LIVE_MERGE_DUTY - 1))
        thread.join()
        t_all = time.perf_counter() - t_all
        recal = (f"fired (lam {live.engine.budget_cfg.lam:.4f})"
                 if live.lineage.get("recalibrations") else "not fired")
        live.merge = merge
        if live.generation != 1 or not os.path.exists(
                os.path.join(tmp, "live.g1.blocks")):
            raise AssertionError("[live] the merge did not publish "
                                 "generation 1 on live.g1.blocks")
        bt, lin = live.build_timings, live.lineage
        log(f"[live] merge_async: {timed['secs']:.1f}s (online build "
            + " ".join(f"{k}={bt[k]:.1f}s" for k in
                       ("bootstrap", "rewire_walks", "prune",
                        "reverse_insert"))
            + f", PQ {bt['pq_tier']:.1f}s, layout {bt['layout']:.1f}s, "
            f"store {bt['store']:.1f}s) over {lin['live']} live rows; "
            f"{served} batches served during it, each followed by a pause "
            f"of {1 / LIVE_MERGE_DUTY - 1:g}x its time: p50="
            f"{np.percentile(during, 50):.1f}ms p99="
            f"{np.percentile(during, 99):.1f}ms, {nq / t_all:.1f} qps over "
            f"the merge's wall time; no "
            f"deleted id; generation 1 on live.g1.blocks; mu {old_mu!r} -> "
            f"{lin['mu']!r} (drift threshold {live.drift_threshold}): "
            f"recalibration {recal} ({card})")
        # At the merge boundary the search is the engine's walk alone (no
        # exact delta scan), so a self-query can miss; every vector it
        # finds must carry the external id it had before the merge.
        after_merge, hit = self_query("self-queries after the merge")
        if not np.array_equal(after_merge[hit], before_merge[hit]):
            raise AssertionError("[live] external ids moved across the "
                                 "merge")
        if hit.mean() < LIVE_SELF_FLOOR:
            raise AssertionError(f"[live] the walk found {hit.mean():.4f} of "
                                 f"the inserted vectors after the merge "
                                 f"(< {LIVE_SELF_FLOOR})")
        log(f"[live] self-queries after the merge: {int(hit.sum())} of "
            f"{hit.size} inserted vectors found at rank 0 with d2 = 0 by the "
            f"walk (no delta scan at a merge boundary), each under its "
            f"external id from before the merge")
        runs["merged"] = live_serve("at the merge boundary", live, stage,
                                    split(gt1), gone, card)
        npz = os.path.join(tmp, "live.npz")
        live.save(npz)
        lin = load_lineage(npz)
        want = dict(generation=1, merges=1, inserts=inserts, deletes=deletes)
        if {k: lin.get(k) for k in want} != want:
            raise AssertionError(f"[live] lineage {lin} != {want}")
        log(f"[live] save(): lineage {lin}")
    finally:
        live.close()
    counts = {k: v - checks[k] for k, v in ops.launch_counts().items()}
    log(f"[live] kernel launches on the live path (ground truths taken "
        f"out: {({k: v for k, v in checks.items() if v})}): "
        f"{ {k: v for k, v in counts.items() if v} }")
    for name in ("beam_step.exact", "beam_step.pq", "l2_distance", "topk"):
        if counts[name] == 0:
            raise AssertionError(f"[live] {name} was never launched on the "
                                 f"live path")
    for name, m in runs.items():
        if m["recall"] < LIVE_RECALL_FLOOR:
            raise AssertionError(f"[live] {name}: recall@10 "
                                 f"{m['recall']:.4f} < {LIVE_RECALL_FLOOR}")
    return counts


# ------------------------------------------------------- phase 3h: [dist]

def same_results(name, got, want) -> None:
    import numpy as np

    for i, (g, w) in enumerate(zip(got, want)):
        if not (np.array_equal(g.ids, w.ids) and np.array_equal(g.d2, w.d2)):
            raise AssertionError(f"[dist] {name}: batch {i} differs")


def merge_timer(ss):
    """Wrap ``ss._hedged_merge`` so each call records CUDA events around it
    on the current stream and keeps its last call's arguments; returns
    (restore, pairs, last).  The time between the events is stream time:
    it holds the card's waits for the host between the merge's launches."""
    import torch

    real, pairs, last = ss._hedged_merge, [], {}

    def timed(*args, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        out = real(*args, **kw)
        b.record()
        pairs.append((a, b))
        last.update(fn=real, args=args, kw=kw)
        return out

    ss._hedged_merge = timed

    def restore():
        ss._hedged_merge = real
    return restore, pairs, last


def merge_device_ms(last) -> tuple[float, float]:
    """(device ms, host ms) of one merge on a batch's own inputs (the last
    call :func:`merge_timer` saw), timed as phase 2 times a kernel: calls
    queued behind a sleep kernel, so the events hold the device's work
    alone, without the host's gaps between the merge's launches."""
    return time_calls(lambda: last["fn"](*last["args"], **last["kw"]),
                      hold=True)


def check_last_card(seed: int) -> str:
    """With two cards or more: ``beam_step`` exact and pq launched once on
    the last card while the first is current, each bit-identical to
    ``beam_step_ref`` on integer data at phase 2's shapes."""
    import torch

    from repro_torch.kernels import ops, ref

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    cfg = sift1m()
    for i, kind in enumerate(("exact", "pq")):
        st0, ctxs, adj, table, budgets, hop_limits = walk_problem(
            kind, last, KERNEL_N, KERNEL_Q, cfg.l_search, cfg.degree, True,
            seed + i, WALK_HOPS)
        if torch.cuda.current_device() != 0:
            raise AssertionError("[dist] the first card is not current")
        got = ops.beam_step(clone(st0), ctxs, adj, table, budgets,
                            hop_limits, kind=kind)
        want = ref.beam_step_ref(st0, ctxs, adj, table, budgets, hop_limits,
                                 kind=kind)
        for name, a, b in zip(("ids", "d", "exp", "visited", "hops",
                               "evals"), got, want):
            if a.device != last or not torch.equal(a, b):
                raise AssertionError(f"[dist] beam_step[{kind}] on {last}: "
                                     f"{name} differs from the plain "
                                     f"version")
    return (f"beam_step exact and pq launched on {last} with cuda:0 current: "
            f"bit-identical to beam_step_ref (Q={KERNEL_Q} N={KERNEL_N}, "
            f"integer data)")


def shard_topk_check(mesh, back, q, budget, kw, buckets) -> None:
    """One batch through the monolithic step on the shards' streams: each
    shard's (Q, k) top-k (the merge's inputs) must equal, bit for bit,
    that shard's walk run alone on its card's default stream."""
    import torch

    from repro_torch.distributed import sharded_search as ss

    got, real = {}, ss._hedged_merge

    def keep(d2, ids, *args, **kw_):
        got["d2"], got["ids"] = d2.cpu(), ids.cpu()
        return real(d2, ids, *args, **kw_)

    ss._hedged_merge = keep
    try:
        ss.distributed_search(mesh, back.arrays, q, beam_budget=budget,
                              budget_buckets=buckets, **kw)
    finally:
        ss._hedged_merge = real
    a = back.arrays
    ctxs = ss._shard_ctxs(a["centroids"], q, True)
    for s, d in enumerate(mesh.shard_devices):
        with ss._on_device(d):
            d2, ids = ss._local_search(
                a["adj"].parts[s], a["codes"].parts[s],
                a["vectors"].parts[s], ctxs.to(d), q.to(d),
                a["entries"].parts[s][0], max_hops=kw["max_hops"],
                beam_width=kw["beam_width"], k=kw["k"],
                query_chunk=kw["query_chunk"], use_pq=True,
                beam_budget=budget,
                bucket_ceilings=ss._bucket_ceilings(budget, buckets))
        if not (torch.equal(d2.cpu(), got["d2"][s])
                and torch.equal(ids.cpu(), got["ids"][s])):
            raise AssertionError(f"[dist] shard {s} on {d}: its top-k on "
                                 f"its stream differs from its walk alone")


def dist_path(world, card: str, seed: int) -> dict:
    """[dist]: phase 3's 1M rows in 8 shards of 125,000 on a (2, 4)
    ("data", "model") mesh over every visible card, one sub-graph built
    per shard on its card (``build_sharded_arrays``: R, L_build of the
    config, static alpha 1.2, PQ m=16 trained once), each shard's rows
    held on its card and its walks on a stream of its own; one batch's
    per-shard top-k against each shard's walk alone; the stream served
    staged
    (pipelined and per batch, hierarchical merge, 4 budget buckets, the
    config's law), by the monolithic adaptive step and by a fixed-beam
    monolithic step at l_search; both merges through
    ``distributed_search``; shard 3 dropped mid-stream; one law fitted per
    shard (``calibrate_budget_law_per_shard`` over
    ``shard_exact_recall_evals``) and served; identity per-shard laws; a
    virtual-clock front door over the staged engine; ``begin`` under sync
    debug mode "error".  Returns the launch counts of the path."""
    import numpy as np
    import torch

    from repro_torch import serving
    from repro_torch.core import build, calibrate
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed import sharded_search as ss
    from repro_torch.kernels import ops
    from repro_torch.serving import server

    cfg = sift1m()
    x = world["tiered"].index.vectors                 # phase 3's rows
    n, dev = x.shape[0], x.device
    batches, gts, qn = world["batches"], world["gts"], world["qn"]
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards > 1:
        log(f"[dist] {check_last_card(seed + 41)}")
    mesh = make_mesh(DIST_MESH, DIST_AXES)
    n_shards = mesh.n_shards
    if len(mesh.devices) != min(cards, n_shards):
        raise AssertionError(f"[dist] the mesh spans {len(mesh.devices)} of "
                             f"{cards} cards")
    ops.reset_launch_counts()
    bcfg = build.BuildConfig(degree=cfg.degree, beam_width=cfg.l_build,
                             batch=BUILD_BATCH, seed=seed)
    t: dict = {}
    t0 = time.perf_counter()
    arrays, per = ss.build_sharded_arrays(x, mesh, build_cfg=bcfg, m_pq=M_PQ,
                                          alpha=DIST_ALPHA, seed=seed,
                                          timings=t)
    t_build = time.perf_counter() - t0
    if per * n_shards != n:
        raise AssertionError(f"[dist] {n} rows do not split into "
                             f"{n_shards} shards")
    shard_s = [t[f"shard_{s}"] for s in range(n_shards)]
    log(f"[dist] {n_shards} shards of {per} on a {DIST_MESH} {DIST_AXES} "
        f"mesh over {len(mesh.devices)} of {cards} cards: sub-graph builds (R={bcfg.degree} "
        f"L={bcfg.beam_width} alpha={DIST_ALPHA} batch={bcfg.batch}) "
        f"{[round(v, 1) for v in shard_s]} s, sum {sum(shard_s):.1f} s; PQ "
        f"m={M_PQ} {t['pq']:.1f} s; {t_build:.1f} s in all; on the card "
        f"{sum(int(a.numel() * a.element_size()) for a in arrays.values()) / 1e9:.2f} "
        f"GB with the vectors ({card})")
    budget = cfg.beam_budget()
    # One chunk a batch: the monolithic step takes whole chunks.
    kw = dict(beam_width=cfg.l_search, max_hops=cfg.max_hops, k=cfg.k,
              query_chunk=batches[0].shape[0])
    back = serving.DistributedBackend(mesh, arrays, beam_budget=budget,
                                      budget_buckets=cfg.budget_buckets, **kw)
    held: dict = {}
    for name in ("adj", "codes", "vectors", "entries"):
        for s, part in enumerate(back.arrays[name].parts):
            if part.device != mesh.shard_devices[s]:
                raise AssertionError(f"[dist] shard {s}'s {name} on "
                                     f"{part.device}, not its card")
            held[part.device] = (held.get(part.device, 0)
                                 + part.numel() * part.element_size())
    log(f"[dist] cards {[str(d) for d in mesh.devices]}; "
        f"{mesh.describe()}; one stream a shard "
        f"({len(set(mesh.streams))} distinct); index GB a card "
        f"{ {str(d): round(b / 1e9, 3) for d, b in held.items()} }; "
        f"allocated GB a card "
        f"{ {str(d): round(torch.cuda.memory_allocated(d) / 1e9, 3) for d in mesh.devices if d.type == 'cuda'} }")
    shard_topk_check(mesh, back, torch.as_tensor(batches[0], device=dev),
                     budget, kw, cfg.budget_buckets)
    log(f"[dist] batch 0: every shard's top-k on its own stream = its walk "
        f"alone on its card's default stream, bit for bit")
    staged = serving.SearchEngine(back, budget, k=cfg.k)
    mono = serving.SearchEngine(back, None, k=cfg.k)
    fixed = serving.SearchEngine(serving.DistributedBackend(mesh, arrays, **kw),
                                 None, k=cfg.k)
    if staged.supports_partial:
        raise AssertionError("[dist] the distributed engine offers partials")
    for eng in (staged, mono, fixed):                 # warm-up
        eng.search(batches[0])
    runs, keep = {}, {}
    restore, pairs, last = merge_timer(ss)
    try:
        for name, eng, piped in (("staged pipelined", staged, True),
                                 ("staged per batch", staged, False),
                                 ("monolithic adaptive", mono, False),
                                 ("fixed beam 128", fixed, False)):
            keep[name] = []
            runs[name] = serve_run(f"[dist] {name}", eng, batches, gts, n,
                                   piped, keep=keep[name])
            if name == "staged per batch":
                torch.cuda.synchronize()
                merge_ms = [a.elapsed_time(b) for a, b in pairs]
            pairs.clear()
    finally:
        restore()
    same_results("staged per batch vs pipelined", keep["staged per batch"],
                 keep["staged pipelined"])
    same_results("monolithic vs staged", keep["monolithic adaptive"],
                 keep["staged pipelined"])
    merge_dev, merge_host = merge_device_ms(last)
    log(f"[dist] staged pipelined = per batch = monolithic, bit for bit; "
        f"hierarchical merge {np.median(merge_ms):.4f} ms a batch of stream "
        f"time between CUDA events around it (median of {len(merge_ms)}; "
        f"the host's launch gaps included); one merge {merge_dev:.4f} ms "
        f"of device time ({merge_host:.4f} ms of host time to launch it; "
        f"behind a sleep kernel, median of 5 rounds of 20); {card}")
    rec = runs["staged pipelined"]["recall"]
    if rec < RECALL_FLOOR:
        raise AssertionError(f"[dist] staged recall@10 {rec:.4f} < "
                             f"{RECALL_FLOOR}")

    # Both merges through distributed_search on one batch.
    q0 = torch.as_tensor(batches[0], device=dev)
    merged = {m: ss.distributed_search(mesh, arrays, q0, merge=m,
                                       beam_budget=budget,
                                       budget_buckets=cfg.budget_buckets,
                                       **kw)
              for m in ("flat", "hierarchical")}
    f, h = ([a.cpu().numpy() for a in merged[m]]
            for m in ("flat", "hierarchical"))
    if not (np.array_equal(f[1] * per + f[2], h[1] * per + h[2])
            and np.array_equal(f[0], h[0])):
        raise AssertionError("[dist] flat and hierarchical merges differ")
    log("[dist] flat = hierarchical merge on batch 0 (ids and d2)")

    # Shard 3 dropped after the second result of a pipelined stream (at
    # least 8 batches, the stream's own cycled); the flights dispatched
    # before the flip (batches 0-3) keep every shard.
    rounds = range(max(8, len(batches)))
    stream = [batches[i % len(batches)] for i in rounds]
    stream_gts = [gts[i % len(batches)] for i in rounds]
    fb = serving.DistributedBackend(mesh, arrays, beam_budget=budget,
                                    budget_buckets=cfg.budget_buckets, **kw)
    eng = serving.SearchEngine(fb, budget, k=cfg.k)
    dead = np.ones(n_shards, bool)
    dead[DIST_DEAD] = False
    res = []
    for i, r in enumerate(eng.search_batches(stream)):
        res.append(r)
        if i == 1:
            fb.set_shard_ok(dead)
    after = res[4:]
    if any((r.extras["shard_ids"] == DIST_DEAD).any() for r in after):
        raise AssertionError("[dist] the dead shard answered after the flip")
    if not all(np.isfinite(r.d2).all() for r in after):
        raise AssertionError("[dist] a non-finite d2 after the flip")
    r_before = recall_of(res[:4], stream_gts[:4])
    r_after = recall_of(after, stream_gts[4:])
    if r_after < r_before - 1.0 / n_shards - 0.08:
        raise AssertionError(f"[dist] recall after the fault {r_after:.4f} "
                             f"< {r_before:.4f} - 1/{n_shards} - 0.08")
    log(f"[dist] shard {DIST_DEAD} dropped after result 1 of a pipelined "
        f"stream of {len(stream)}: batches 4-{len(stream) - 1} hold no id of "
        f"it, every d2 finite; recall@10 {r_before:.4f} -> {r_after:.4f} "
        f"(floor {r_before - 1.0 / n_shards - 0.08:.4f})")

    # One law per shard, fitted on shard-local held-out queries, served.
    t0 = time.perf_counter()
    fit = calibrate.calibrate_budget_law_per_shard(
        calibrate.shard_exact_recall_evals(
            back.arrays["vectors"], back.arrays["adj"],
            back.arrays["entries"], qn, n_shards, k=cfg.k,
            sample=CALIB_SAMPLE, mesh=mesh),
        budget, cfg.recall_target, n_shards, joint=True)
    t_fit = time.perf_counter() - t0
    for s, r in enumerate(fit.results):
        log(f"[dist] shard {s} fit: lam={fit.lam[s]:.4f} "
            f"l_min={fit.l_min[s]} hop_factor={fit.hop_factor[s]} "
            f"recall={r.recall:.4f} "
            f"{'achieved' if r.achieved else 'MISSED'} "
            f"({len(r.history)} evaluations)")
    law = fit.serving_budget(budget)
    fitted = serving.SearchEngine(serving.DistributedBackend(
        mesh, arrays, beam_budget=law, budget_buckets=cfg.budget_buckets,
        shard_laws=fit.law_arrays(), **kw), law, k=cfg.k)
    fitted.search(batches[0])
    runs["fitted"] = serve_run("[dist] per-shard fitted laws, pipelined",
                               fitted, batches, gts, n, True)
    log(f"[dist] per-shard fit to {cfg.recall_target} on {CALIB_SAMPLE} "
        f"held-out queries a shard in {t_fit:.1f} s "
        f"({'achieved' if fit.achieved else 'MISSED on some shard'}); "
        f"served with hop_factor {law.hop_factor}")
    if runs["fitted"]["recall"] < RECALL_FLOOR:
        raise AssertionError(f"[dist] fitted laws served recall@10 "
                             f"{runs['fitted']['recall']:.4f} < "
                             f"{RECALL_FLOOR}")
    ident = serving.SearchEngine(serving.DistributedBackend(
        mesh, arrays, beam_budget=budget, budget_buckets=cfg.budget_buckets,
        shard_laws=cfg.shard_budget_laws(n_shards), **kw), budget, k=cfg.k)
    same_results("identity per-shard laws vs the scalar law",
                 [ident.search(b) for b in batches], keep["staged pipelined"])
    log("[dist] identity per-shard laws = the scalar law, bit for bit")

    # A virtual-clock front door over the staged engine, one class.
    clock = server.VirtualClock()
    door = server.FrontDoor(
        {"c": staged}, [server.QoSClass("c", deadline_s=60.0,
                                        batch_window_s=0.01,
                                        max_lanes=DIST_DOOR_LANES)],
        clock=clock, dispatcher=server.VirtualDispatcher(clock))
    lanes = 0
    for g in range(DIST_DOOR_GROUPS):
        if g == DIST_DOOR_GROUPS // 2:
            back.set_shard_ok(dead)
        rows = qn[g * DIST_DOOR_LANES:(g + 1) * DIST_DOOR_LANES]
        want = staged.search(rows)
        futs = [door.submit(r) for r in rows]
        clock.advance(0.05)
        for i, fut in enumerate(futs):
            r = fut.result(timeout=0)
            if r.status != "ok" or not (np.array_equal(r.ids, want.ids[i])
                                        and np.array_equal(r.d2, want.d2[i])):
                raise AssertionError(f"[dist] door lane {lanes}: {r.status},"
                                     f" not the direct search's")
            if (g >= DIST_DOOR_GROUPS // 2
                    and (np.asarray(r.extras["shard_ids"]) == DIST_DEAD).any()):
                raise AssertionError("[dist] door: the dead shard answered")
            lanes += 1
    door.close(wait=True, timeout=60)
    back.set_shard_ok(np.ones(n_shards, bool))
    log(f"[dist] front door (virtual clock, {lanes} single requests in "
        f"dispatches of {DIST_DOOR_LANES}): every lane equal to a direct "
        f"search; shard {DIST_DEAD} dropped after {DIST_DOOR_GROUPS // 2} "
        f"dispatches, none of its ids after; supports_partial False")

    # begin waits for nothing on the card, staged and monolithic.
    for name, eng in (("staged", staged), ("monolithic", mono)):
        want = eng.search(batches[0])
        f0 = no_host_sync(eng.begin)(batches[0])
        same_results(f"{name} begin under sync debug mode",
                     [eng.finish_from(f0)], [want])
    log("[dist] begin of the staged and monolithic engines under sync "
        "debug mode \"error\": no host sync, results equal to search")
    counts = ops.launch_counts()
    log(f"[dist] kernel launches on the dist path: "
        f"{ {k: v for k, v in counts.items() if v} }")
    for name in ("beam_step.pq", "beam_step.exact", "l2_distance", "topk"):
        if counts[name] == 0:
            raise AssertionError(f"[dist] {name} was never launched on the "
                                 f"dist path")
    for name, m in runs.items():
        log(f"[dist] {name}: qps {m['qps']:.1f}, batch p50 "
            f"{m['p50_ms']:.1f} ms p99 {m['p99_ms']:.1f} ms, recall@10 "
            f"{m['recall']:.4f}, mean budget {m['mean_budget']}, hops a "
            f"query {m['mean_hops']} ({card})")
    st_, mo_ = runs["staged per batch"], runs["monolithic adaptive"]
    log(f"[dist] a stream a shard over {len(mesh.devices)} card(s): staged "
        f"per batch qps {st_['qps']:.1f}, batch p50 {st_['p50_ms']:.1f} ms "
        f"p99 {st_['p99_ms']:.1f} ms; monolithic qps {mo_['qps']:.1f}, batch "
        f"p50 {mo_['p50_ms']:.1f} ms p99 {mo_['p99_ms']:.1f} ms; the shards "
        f"one after another on one stream: p50 {DIST_SERIAL_MS[0]} / "
        f"{DIST_SERIAL_MS[1]} ms (recorded, not gated; {card})")
    log(f"[dist] phase in {time.perf_counter() - t_phase:.1f} s")
    return counts


# ------------------------------------------------------- phase 3i: [base]

IVF_LIST_SIZE = 256         # nlist = n // 256 (benchmarks/recall_qps.py:95)
IVF_ITERS = 6
IVF_QUERIES = 1000          # the stream's first 1,000 (time: padded scans)
NPROBE_SWEEP = (1, 2, 4, 8, 16, 32)      # recall_qps.py:26
IVF_RECALL_FLOOR = 0.50     # at nprobe 32
IVF_CHECK_Q, IVF_CHECK_NPROBE = 256, 8
HNSW_ROWS = 4096            # the host build is sequential Python (time)
HNSW_M, HNSW_EF_CONSTRUCTION = 16, 100   # recall_qps.py:106
EF_SWEEP = (16, 32, 64, 96)
HNSW_RECALL_FLOOR = 0.90    # at ef 96 (tests/test_build_search.py:95-102)
HNSW_CHECK_Q = 256


def timed_sync(dev, fn):
    """(result, host seconds) of ``fn()`` between two synchronises."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def ivf_sweep(index, x, q, gt, card: str) -> dict:
    """Search the IVF index at every nprobe of ``NPROBE_SWEEP``; prints and
    returns each one's recall@10."""
    import torch

    from repro_torch.core import distance, ivf

    dev = x.device
    max_len = index.lists.shape[1]
    gt_t = torch.as_tensor(gt, device=dev)
    ivf.search_ivf(index, x, q[:8], nprobe=1)                # warm-up
    recalls = {}
    for nprobe in NPROBE_SWEEP:
        (ids, _, scanned), secs = timed_sync(
            dev, lambda: ivf.search_ivf(index, x, q, nprobe=nprobe, k=10))
        rec = recalls[nprobe] = float(distance.recall_at_k(ids, gt_t))
        mean = float(scanned.float().mean())
        log(f"[base] ivf nprobe={nprobe}: recall@10 {rec:.4f}, QPS "
            f"{q.shape[0] / secs:.1f} ({secs * 1e3:.1f} ms for "
            f"{q.shape[0]} queries), mean scanned {mean:.1f}, valid share "
            f"of the padded scan {mean / (nprobe * max_len):.4f} ({card})")
    return recalls


def check_ivf_select(index, x, q) -> None:
    """One chunk at nprobe 8: the path's select (the ``topk`` kernel)
    against the same search with ``topk_ref`` as its select, on the card:
    ids, d2 and points scanned bit for bit."""
    import types

    import torch

    from repro_torch.core import ivf
    from repro_torch.kernels import ref

    got = ivf.search_ivf(index, x, q, nprobe=IVF_CHECK_NPROBE, k=10)
    kernel_ops = ivf.ops
    ivf.ops = types.SimpleNamespace(topk=ref.topk_ref)
    try:
        want = ivf.search_ivf(index, x, q, nprobe=IVF_CHECK_NPROBE, k=10)
    finally:
        ivf.ops = kernel_ops
    for name, a, b in zip(("ids", "d2", "scanned"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"[base] ivf: {name} with the topk kernel "
                                 f"differ from topk_ref's on the card")
    log(f"[base] ivf select: {q.shape[0]} queries at nprobe "
        f"{IVF_CHECK_NPROBE}, ids, d2 and scanned with the topk kernel "
        f"bit-identical to topk_ref's on the card")


def check_hnsw_walk(h, xh, q) -> None:
    """Layer 0's walk from each query's own entry (the descent's), ef 96:
    on float rows hop by hop against ``beam_step_ref`` from the same state
    (d within 1e-5 relative, ids and visited words equal outside
    near-ties); on an integer-valued copy of the rows the whole walk, one
    launch, bit for bit."""
    import torch

    from repro_torch.core import hnsw, search
    from repro_torch.kernels import ops, ref

    ef, dev = EF_SWEEP[-1], xh.device
    entries = hnsw.descend(h, xh, q)
    adj = h.layers[0]
    n, nq = xh.shape[0], q.shape[0]
    b, hl = search._lane_vectors(nq, ef, 4 * ef, None, dev)
    # Float rows, one hop at a time.
    st = search._init_state(q, entries, search._exact_eval(xh), n, ef)
    hops = tie_lanes = 0
    max_err = 0.0
    while bool(ref.lane_active(st[0], st[2], st[4], b, hl).any()):
        a = ops.beam_step(clone(st), q, adj, xh, b, hl, kind="exact")
        w = ref.beam_step_ref(st, q, adj, xh, b, hl, kind="exact")
        same = (a[0] == w[0]).all(1) & (a[3] == w[3]).all(1)
        tie = near_tie(st[1], FLOAT_RTOL) | near_tie(w[1], FLOAT_RTOL)
        if bool((~same & ~tie).any()):
            raise AssertionError(f"[base] hnsw walk hop {hops}: ids or "
                                 f"visited differ in a lane without a tie")
        fin = torch.isfinite(w[1]) & same[:, None]
        err = (a[1] - w[1]).abs()[fin]
        if err.numel():
            if not bool((err <= FLOAT_RTOL * w[1].abs()[fin]).all()):
                raise AssertionError(f"[base] hnsw walk hop {hops}: beam_d "
                                     f"beyond rtol {FLOAT_RTOL}")
            max_err = max(max_err, float(err.max()))
        tie_lanes += int((~same).sum())
        st, hops = w, hops + 1
    # Integer-valued rows, the whole walk in one launch.
    xi, qi = torch.round(xh * 2.0), torch.round(q * 2.0)
    st0 = search._init_state(qi, entries, search._exact_eval(xi), n, ef)
    got = ops.beam_walk(clone(st0), qi, adj, xi, b, hl, kind="exact",
                        max_hops=ops.MAX_HOPS)
    want, _ = ref.beam_walk_ref(st0, qi, adj, xi, b, hl, kind="exact",
                                max_hops=ops.MAX_HOPS)
    for name, a, w in zip(("ids", "d", "exp", "visited", "hops", "evals"),
                          got, want):
        if not torch.equal(a, w):
            raise AssertionError(f"[base] hnsw walk: {name} differs from "
                                 f"beam_walk_ref's on integer rows")
    log(f"[base] hnsw layer-0 walk: {nq} queries from their own entries at "
        f"ef {ef}: float rows {hops} hops against beam_step_ref, beam_d "
        f"within rtol {FLOAT_RTOL} (max abs err {max_err:.3g}), "
        f"{tie_lanes} lane-hops differ, each at a near-tie; integer rows "
        f"bit-identical to beam_walk_ref in one launch (hops "
        f"{int(want[4].sum())})")


def base_path(world, card: str, seed: int) -> dict:
    """[base]: the paper's two baselines on phase 3's rows.  IVF-Flat over
    all N (nlist = N / 256, 6 k-means iterations) searched by the stream's
    first ``IVF_QUERIES`` at every nprobe of ``NPROBE_SWEEP``; HNSW built
    on the host over the first ``HNSW_ROWS`` rows (m = 16,
    ef_construction = 100) and searched by the whole stream at every ef of
    ``EF_SWEEP``.  Fails unless IVF recall never falls as nprobe grows and
    reaches ``IVF_RECALL_FLOOR`` at 32, HNSW recall@10 at ef 96 reaches
    ``HNSW_RECALL_FLOOR``, ``topk`` and ``beam_step`` exact launched on
    the path, and the kernel-against-plain checks hold (after the counts
    are read).  Returns the launch counts of this run."""
    import torch

    from repro_torch.core import distance, hnsw, ivf
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    x = world["exact"].x
    dev, n = x.device, x.shape[0]
    q_all = torch.as_tensor(world["qn"], device=dev)
    q_ivf, gt_ivf = q_all[:IVF_QUERIES], world["gt"][:IVF_QUERIES]
    xh = x[:min(HNSW_ROWS, n)]
    if xh.shape[0] < HNSW_ROWS or n < sift1m().n:
        log(f"[base] cut: IVF over N={n}, HNSW over {xh.shape[0]} rows")
    _, gt_h = distance.brute_force_topk(q_all, xh, k=10)  # not counted

    ops.reset_launch_counts()
    nlist = max(1, n // IVF_LIST_SIZE)
    index, secs = timed_sync(dev, lambda: ivf.build_ivf(
        x, nlist=nlist, iters=IVF_ITERS, seed=seed, device=dev))
    lens = index.list_len.float()
    log(f"[base] ivf build: nlist={nlist} iters={IVF_ITERS} over N={n} in "
        f"{secs:.2f} s; list length mean {float(lens.mean()):.1f} max "
        f"{index.lists.shape[1]} (max_len; the padded scan reads nprobe x "
        f"max_len rows a query)")
    recalls = ivf_sweep(index, x, q_ivf, gt_ivf, card)

    t0 = time.perf_counter()
    h = hnsw.build_hnsw(xh, m=HNSW_M, ef_construction=HNSW_EF_CONSTRUCTION,
                        seed=seed, device=dev)
    secs = time.perf_counter() - t0
    log(f"[base] hnsw build (host, sequential): {xh.shape[0]} rows, m="
        f"{HNSW_M} ef_construction={HNSW_EF_CONSTRUCTION} in {secs:.1f} s "
        f"({secs / xh.shape[0] * 1e3:.2f} ms an insertion); n_layers "
        f"{h.n_layers}")
    gt_h_t = gt_h.to(dev)
    hnsw.search_hnsw(h, xh, q_all[:8], ef=EF_SWEEP[0])       # warm-up
    h_recall = {}
    for ef in EF_SWEEP:
        counter = {}
        (ids, _, stats), secs = timed_sync(dev, lambda: hnsw.search_hnsw(
            h, xh, q_all, ef=ef, k=10, counter=counter))
        rec = h_recall[ef] = float(distance.recall_at_k(ids, gt_h_t))
        log(f"[base] hnsw ef={ef}: recall@10 {rec:.4f}, QPS "
            f"{q_all.shape[0] / secs:.1f} ({secs * 1e3:.1f} ms for "
            f"{q_all.shape[0]} queries), mean hops "
            f"{float(stats.hops.float().mean()):.2f} evaluations "
            f"{float(stats.dist_evals.float().mean()):.2f}; the descent "
            f"read its flag on the host {counter.get('reads', 0)} times "
            f"({card})")
    counts = ops.launch_counts()
    log(f"[base] kernel launches on the path: "
        f"{ {k: v for k, v in counts.items() if v} }")
    order = [recalls[p] for p in NPROBE_SWEEP]
    if any(b < a for a, b in zip(order, order[1:])):
        raise AssertionError(f"[base] ivf recall fell as nprobe grew: "
                             f"{recalls}")
    if recalls[NPROBE_SWEEP[-1]] < IVF_RECALL_FLOOR:
        raise AssertionError(f"[base] ivf recall@10 at nprobe "
                             f"{NPROBE_SWEEP[-1]} below {IVF_RECALL_FLOOR}")
    if h_recall[EF_SWEEP[-1]] < HNSW_RECALL_FLOOR:
        raise AssertionError(f"[base] hnsw recall@10 at ef {EF_SWEEP[-1]} "
                             f"below {HNSW_RECALL_FLOOR}")
    for name in ("topk", "beam_step.exact"):
        if counts[name] == 0:
            raise AssertionError(f"[base] {name} was never launched")
    check_ivf_select(index, x, q_ivf[:IVF_CHECK_Q])
    check_hnsw_walk(h, xh, q_all[:HNSW_CHECK_Q])
    log(f"[base] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# ----------------------------------------------------- phase 3j: [metric]

METRIC_QUERIES = 1000
METRIC_CHECK_Q = 64
METRIC_RTOL = 1e-4
# (metric, dataset of the port's registry, N): T2I-1B's D = 200 (inner
# product) cut from 1B to 1M; GloVe-100's D = 100 (angular) at its 1.2M.
METRIC_CELLS = (("ip", "t2i-proxy", 1_000_000),
                ("cosine", "glove-proxy", 1_200_000))
METRIC_TOPK_K = (10, 100, 300)


def check_metric_scan(metric, q, x, d, ids) -> tuple[float, int]:
    """The first ``METRIC_CHECK_Q`` queries against a float64 scan on the
    card: distances within ``METRIC_RTOL`` of the row's largest magnitude
    among its k, ids equal except at near-ties (the two ids' float64
    distances within ``METRIC_RTOL`` of each other).  Returns (max
    relative error, ids that differ at a near-tie)."""
    import torch

    q64, x64 = q.double(), x.double()
    if metric == "cosine":
        q64 = q64 / (torch.linalg.norm(q64, dim=1, keepdim=True) + 1e-12)
        x64 = x64 / (torch.linalg.norm(x64, dim=1, keepdim=True) + 1e-12)
    dd = -(q64 @ x64.T)
    want_d, want_i = torch.topk(dd, d.shape[1], dim=1, largest=False)
    scale = want_d.abs().amax(1, keepdim=True).clamp_min(1e-30)
    err = float(((d.double() - want_d).abs() / scale).max())
    if err > METRIC_RTOL:
        raise AssertionError(f"[metric] {metric}: distances {err:.3g} from "
                             f"float64, beyond {METRIC_RTOL}")
    diff = ids.long() != want_i
    a = torch.gather(dd, 1, ids.long())
    b = torch.gather(dd, 1, want_i)
    tie = (a - b).abs() <= METRIC_RTOL * torch.maximum(a.abs(), b.abs())
    if bool((diff & ~tie).any()):
        raise AssertionError(f"[metric] {metric}: ids differ from float64's "
                             f"away from a near-tie")
    return err, int(diff.sum())


def check_topk_integer(dev, seed: int) -> None:
    """The ``topk`` kernel on negated integer inner products at the scan's
    chunk shape (1,000 x 65,536): ties everywhere, a row of -0.0 only and
    a row of +0.0 and -0.0 in turn; values bitwise and ids equal to
    ``topk_ref`` on the card at each k of ``METRIC_TOPK_K``."""
    import torch

    from repro_torch.core import distance
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(seed + 31)
    q = torch.randint(-3, 4, (METRIC_QUERIES, 200), generator=g,
                      device=dev).float()
    x = torch.randint(-3, 4, (65536, 200), generator=g, device=dev).float()
    q[0] = 0.0
    d = distance.neg_inner_product(q, x).contiguous()
    d[1, 0::2] = 0.0
    d[1, 1::2] = -0.0
    zeros = d[1] == 0
    if not (bool(torch.signbit(d[0]).all())
            and bool((zeros & torch.signbit(d[1])).any())
            and bool((zeros & ~torch.signbit(d[1])).any())):
        raise AssertionError("[metric] the integer rows lack their zeros")
    for k in METRIC_TOPK_K:
        got_v, got_i = ops.topk(d, k)
        want_v, want_i = ref.topk_ref(d, k)
        if not (torch.equal(got_i, want_i) and torch.equal(
                got_v.view(torch.int32), want_v.view(torch.int32))):
            raise AssertionError(f"[metric] topk k={k} on negated integer "
                                 f"products differs from topk_ref")
    log(f"[metric] topk on negated integer products ({METRIC_QUERIES} x "
        f"65536, ties, a row of -0.0, a row of +0.0 and -0.0): values "
        f"bitwise and ids equal to topk_ref at k = {METRIC_TOPK_K}")


def metric_path(dev, seed: int, card: str) -> dict:
    """[metric]: the inner-product and cosine scans —
    ``brute_force_topk(k=10)`` of ``METRIC_QUERIES`` queries over T2I's
    shape (ip) and GloVe's (cosine) on the card (the product a matmul,
    the select the ``topk`` kernel on negative values).  Fails unless
    ``topk`` launched, 64 queries of each agree with float64 and the
    integer check holds.  Returns the launch counts of this run."""
    from repro_torch.core import distance
    from repro_torch.data import REGISTRY, make_dataset
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    data = {}
    for metric, name, n in METRIC_CELLS:
        x, q = make_dataset(REGISTRY[name], seed=seed + 30, device=dev, n=n)
        data[metric] = (x, q[:METRIC_QUERIES])
        distance.brute_force_topk(q[:8], x, 10, metric=metric)  # warm-up
    ops.reset_launch_counts()
    results = {}
    for metric, name, n in METRIC_CELLS:
        x, q = data[metric]
        results[metric], secs = timed_sync(
            dev, lambda: distance.brute_force_topk(q, x, 10, metric=metric))
        log(f"[metric] {metric} over {name} at N={x.shape[0]} D="
            f"{x.shape[1]}: {q.shape[0]} queries, k=10 in {secs * 1e3:.1f} "
            f"ms ({card})")
    counts = ops.launch_counts()
    log(f"[metric] kernel launches on the path: "
        f"{ {k: v for k, v in counts.items() if v} }")
    if counts["topk"] == 0:
        raise AssertionError("[metric] topk was never launched")
    for metric, _, _ in METRIC_CELLS:
        x, q = data[metric]
        d, ids = results[metric]
        err, ties = check_metric_scan(metric, q[:METRIC_CHECK_Q], x,
                                      d[:METRIC_CHECK_Q],
                                      ids[:METRIC_CHECK_Q])
        log(f"[metric] {metric}: {METRIC_CHECK_Q} queries against float64 "
            f"on the card: distances within {err:.3g} of each row's scale, "
            f"{ties} ids differ, each at a near-tie")
    check_topk_integer(dev, seed)
    log(f"[metric] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


# --------------------------------------------------- phase 3k: [examples]

def examples_path() -> dict:
    """[examples]: ``examples/torch_quickstart.py``'s ``main`` on the card,
    in this process.  Fails unless its walks launched ``beam_step`` exact
    and its ground truth and LID ``l2_distance``, ``topk`` and
    ``lid_estimate``.  Returns the launch counts of this run."""
    import importlib.util

    from repro_torch.kernels import ops

    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", os.path.join(ROOT, "examples",
                                         "torch_quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = mod.main(["--device", "cuda"])
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"[examples] torch_quickstart on the card in {secs:.1f} s: "
        f"{ {k: round(v, 4) for k, v in out.items()} }; kernel launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    for name in ("beam_step.exact", "l2_distance", "topk", "lid_estimate"):
        if counts[name] == 0:
            raise AssertionError(f"[examples] {name} was never launched")
    return counts


def recall_of(results, gts) -> float:
    import numpy as np
    import torch

    from repro_torch.core import distance

    return float(np.mean([float(distance.recall_at_k(
        torch.as_tensor(r.ids), torch.as_tensor(g)))
        for r, g in zip(results, gts)]))


# ------------------------------------------------------------- phase 4: LM

def lm_params(cfg, dev, seed: int, salt: int):
    """``cfg``'s parameters at full width and depth, drawn in bfloat16 on
    the card from the seed."""
    import torch

    from repro_torch.models import transformer

    g = torch.Generator(device=dev).manual_seed(seed + salt)
    t0 = time.perf_counter()
    params = transformer.init_lm(cfg, g, device=dev)
    sync(dev)
    n = cfg.n_params()
    active = (f", {cfg.n_active_params()} active a token" if cfg.moe
              else "")
    log(f"[lm] {cfg.name} at full width and depth ({cfg.n_layers} layers): "
        f"{n} parameters{active} in {cfg.dtype} ({n * 2 / 1e9:.2f} GB) "
        f"drawn from --seed in {time.perf_counter() - t0:.1f}s")
    return params


def step_stats(ms: list) -> str:
    import numpy as np

    return (f"p50 {float(np.percentile(ms, 50)):.3f} ms, p99 "
            f"{float(np.percentile(ms, 99)):.3f} ms")


def kv_token_bytes(cfg) -> int:
    """Bytes of one token's bfloat16 cache entry in one layer: K and V, or
    MLA's latent and rope key."""
    if cfg.attention == "mla":
        return (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2
    return 2 * cfg.n_kv_heads * cfg.d_head * 2


def step_bound(cfg, params, b: int, kv_len: int) -> tuple[float, str]:
    """Least time of one decode step: every weight read once (of an untied
    embedding only the B rows looked up; every expert, as no-drop decode
    runs each) and the cache up to kv_len of every layer, at the HBM
    rate."""
    from repro_torch.models import transformer

    weights = sum(t.numel() * t.element_size()
                  for t in transformer.leaves(params))
    if not cfg.tie_embeddings:
        emb = params["embed"]
        weights -= (emb.shape[0] - b) * emb.shape[1] * emb.element_size()
    kv = b * kv_len * cfg.n_layers * kv_token_bytes(cfg)
    ms = (weights + kv) / HBM_BYTES_PER_S * 1e3
    return ms, (f"{ms:.3f} ms ({(weights + kv) / 1e9:.1f} GB of weights and "
                f"cache at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")


def aten_calls(fn) -> int:
    """Calls into PyTorch's operator library (views included) that one
    ``fn()`` makes: what the host dispatches for it, independent of the
    card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


@contextlib.contextmanager
def routes_kept(kept: list, forced=None):
    """Wrap the MoE router: each call's (T, k) expert ids appended to
    ``kept``.  With ``forced`` (an iterator of earlier ids) the router's
    top-k selection returns those ids, its values gathered from its own
    input (no ``topk`` launch): the same experts, this path's gates."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe

    real, real_topk = moe._route, ops.topk

    def route(p, cfg, x):
        out = real(p, cfg, x)
        kept.append(out[0])
        return out

    def replay(x, k):
        e = next(forced)
        return x.gather(1, e.long()), e

    moe._route = route
    if forced is not None:
        ops.topk = replay
    try:
        yield kept
    finally:
        moe._route = real
        ops.topk = real_topk


@contextlib.contextmanager
def drops_counted(tally: list):
    """Wrap the MoE dispatch: [kept, total] assignments in ``tally``."""
    from repro_torch.models import moe

    real = moe._dispatch_group

    def dispatch(x_g, eid_g, cap, n_experts):
        out = real(x_g, eid_g, cap, n_experts)
        tally[0] += int(out[2].sum())
        tally[1] += out[2].numel()
        return out
    moe._dispatch_group = dispatch
    try:
        yield tally
    finally:
        moe._dispatch_group = real


def route_diff(dec: list, pre: list, b: int, p: int, n_moe: int) -> float:
    """Share of (token, layer) routing choices of the teacher-forced decode
    steps (one (B, k) a MoE layer a step) that differ from the prefill's
    (one (B * P, k) a MoE layer) as sets of experts."""
    import torch

    d = torch.stack([e.sort(-1).values for e in dec[:p * n_moe]])
    d = d.reshape(p, n_moe, b, -1).permute(2, 0, 1, 3)         # (B, P, L, k)
    f = torch.stack([e.sort(-1).values for e in pre])           # (L, BP, k)
    f = f.reshape(n_moe, b, p, -1).permute(1, 2, 0, 3)
    return float((d != f).any(-1).float().mean())


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def no_drop_cfg(cfg, t: int):
    """``cfg`` with the smallest capacity factor at which an MoE group of
    ``t`` tokens gets cap = t, as ``no_drop`` gives: n_experts / top_k,
    moved up by float steps where its rounding would give t - 1."""
    import dataclasses
    import math

    e, k = cfg.moe.n_experts, cfg.moe.top_k
    cf = e / k
    nudged = 0
    while int(cf * t * k / e) < t:
        cf, nudged = math.nextafter(cf, math.inf), nudged + 1
    if max(int(cf * t * k / e), 1) != t:
        raise AssertionError(f"capacity factor {cf!r} gives cap "
                             f"{int(cf * t * k / e)}, not {t}")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf)), cf, nudged


def generate(cfg, params, dev, prompts, gen: int, naive_at=(),
             on_step=None, routes: list | None = None):
    """Teacher-force ``prompts`` (B, P) through ``decode_step``, then
    generate greedily to ``gen`` tokens a row.  Returns the generated
    tokens, the logits at position P - 1, each step's ms and, at the steps
    of ``naive_at`` (MLA), :func:`mla_forms`' figures.  ``on_step(t)`` is
    called before step t; ``routes`` gathers every step's expert ids."""
    import torch

    from repro_torch.models import transformer

    b, prompt = prompts.shape
    cache = transformer.init_cache(cfg, b, prompt + gen, device=dev)
    step_ms, tokens, last, forms = [], [], None, {}
    feed = prompts[:, :1]
    for t in range(prompt + gen - 1):
        if on_step is not None:
            on_step(t)
        lens = torch.full((b,), t, dtype=torch.int32, device=dev)
        pre = ({k: v.clone() for k, v in cache.items()} if t in naive_at
               else None)
        ids = []
        keep = routes is not None or pre is not None
        with routes_kept(ids) if keep else contextlib.nullcontext():
            t0 = time.perf_counter()
            logits, cache = transformer.decode_step(cfg, params, cache, feed,
                                                    lens)
            nxt = logits.argmax(-1)
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if routes is not None:
            routes += ids
        if pre is not None:
            forms[t] = mla_forms(cfg, params, pre, feed, lens, ids, logits)
        if t == prompt - 1:
            last = logits.float()
        if t >= prompt - 1:
            tokens.append(nxt)
        feed = (prompts[:, t + 1:t + 2] if t + 1 < prompt else nxt[:, None])
    return torch.stack(tokens, 1), last, step_ms, forms


def mla_forms(cfg, params, pre, feed, lens, ids, absorbed):
    """The naive MLA form of one step on copies of the cache before it:
    (relative L2 against the absorbed logits with the absorbed step's
    experts replayed, the same without the replay, the share of (token,
    MoE layer) routing choices that differ without it)."""
    from repro_torch.models import transformer

    copy = {k: v.clone() for k, v in pre.items()}
    with routes_kept([], forced=iter(ids)):
        forced, _ = transformer.decode_step(cfg, params, pre, feed, lens,
                                            mla_absorbed=False)
    free_ids = []
    with routes_kept(free_ids):
        free, _ = transformer.decode_step(cfg, params, copy, feed, lens,
                                          mla_absorbed=False)
    diff = sum(float((a.sort(-1).values != f.sort(-1).values).any(-1)
                     .float().sum()) for a, f in zip(ids, free_ids))
    share = diff / max(1, sum(a.shape[0] for a in ids))
    return rel_l2(forced, absorbed), rel_l2(free, absorbed), share


def f32_prefix(cfg, params, prompts, dev, tag: str) -> tuple[float, float]:
    """Prefill against decode in a float32 copy of the first F32_LAYERS
    layers at full width (the drawn weights cast), MoE without drops:
    the relative L2 of the last logits (gated at PREFILL_REL_L2) and the
    share of routing choices that differ.  The GQA cache stays bfloat16,
    the only cache the ``decode_attention`` kernel takes."""
    import dataclasses

    import torch

    from repro_torch.models import transformer

    b, p = prompts.shape
    cfg4 = dataclasses.replace(cfg, n_layers=F32_LAYERS, dtype=torch.float32)
    p4 = {k: v.float() for k, v in params.items() if k != "layers"}
    p4["layers"] = [transformer._cast(lp, torch.float32)
                    for lp in params["layers"][:F32_LAYERS]]
    cache = transformer.init_cache(
        cfg4, b, p, device=dev,
        dtype=torch.float32 if cfg.attention == "mla" else torch.bfloat16)
    n_moe = sum("moe" in lp for lp in p4["layers"])
    dec, pre = [], []
    with routes_kept(dec):
        for t in range(p):
            lens = torch.full((b,), t, dtype=torch.int32, device=dev)
            logits, cache = transformer.decode_step(cfg4, p4, cache,
                                                    prompts[:, t:t + 1], lens)
    cfg_nd, _, _ = no_drop_cfg(cfg4, b * p)
    with routes_kept(pre):
        full = transformer.prefill(cfg_nd, p4, prompts)
    sync(dev)
    rel = rel_l2(full, logits)
    share = route_diff(dec, pre, b, p, n_moe)
    del p4, cache
    torch.cuda.empty_cache()
    if not rel <= PREFILL_REL_L2:
        raise AssertionError(f"[{tag}] float32 {F32_LAYERS}-layer prefill vs "
                             f"decode: relative L2 {rel:.4g} > "
                             f"{PREFILL_REL_L2}")
    return rel, share


def lm_serve(cfg, params, dev, seed: int, tag: str, prompt: int, gen: int,
             attn_steps: tuple, salt: int) -> tuple[dict, float]:
    """[<tag>]: teacher-force LM_BATCH prompts of ``prompt`` tokens through
    ``decode_step``, then generate greedily to ``gen`` tokens a row; check
    the launches, GQA's decode_attention outputs at layer 0 of
    ``attn_steps`` against the plain version, MLA's naive form at
    LM_CHECK_STEPS, prefill against the decode path, and that a second run
    generates the same tokens.  An MoE model's prefill is also held in a
    float32 copy of its first layers (:func:`f32_prefix`), made last.
    Returns the first run's launch counts and decode_attention's max abs
    error."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    b = LM_BATCH
    g = torch.Generator(device=dev).manual_seed(seed + salt)
    prompts = torch.randint(0, cfg.vocab, (b, prompt), generator=g,
                            device=dev)
    steps = prompt + gen - 1
    n_moe = sum("moe" in lp for lp in params["layers"])
    gqa = cfg.attention == "gqa"
    seen, step = {}, [0]
    real = ops.decode_attention

    def spy(q, k, v, kv_len):
        """ops.decode_attention that keeps layer 0's inputs and output at
        the steps of ``attn_steps`` (it adds copies, no launch)."""
        out = real(q, k, v, kv_len)
        if step[0] in attn_steps and step[0] not in seen:
            seen[step[0]] = tuple(x.clone() for x in (q, k, v, kv_len, out))
        return out

    ops.decode_attention = spy
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks, last, step_ms, _ = generate(
            cfg, params, dev, prompts, gen,
            on_step=lambda t: step.__setitem__(0, t))
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        ops.decode_attention = real
    attn_err = 0.0
    if gqa:
        if sorted(seen) != sorted(attn_steps):
            raise AssertionError(f"[{tag}] decode_attention inputs kept at "
                                 f"steps {sorted(seen)}, not {attn_steps}")
        attn_err = max(attention_check(f"{tag} step {t}", *seen[t][:4],
                                       got=seen[t][4]) for t in attn_steps)
        del seen
    want_attn = cfg.n_layers * steps if gqa else 0
    if counts["decode_attention"] != want_attn:
        raise AssertionError(f"[{tag}] decode_attention launched "
                             f"{counts['decode_attention']} times, not "
                             f"{want_attn}")
    if counts["topk"] != n_moe * steps:
        raise AssertionError(f"[{tag}] topk launched {counts['topk']} times, "
                             f"not {n_moe} per step x {steps} steps")
    if toks.shape != (b, gen) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"[{tag}] generated tokens of shape "
                             f"{tuple(toks.shape)} or outside the vocabulary")
    if not bool(torch.isfinite(last).all()):
        raise AssertionError(f"[{tag}] non-finite logits")

    # The second run: the same tokens; MLA's naive form beside it; the
    # decode path's routing kept for the prefill's.
    dec_routes = []
    toks2, _, _, forms = generate(
        cfg, params, dev, prompts, gen,
        naive_at=LM_CHECK_STEPS if cfg.attention == "mla" else (),
        routes=dec_routes if n_moe else None)
    if not torch.equal(toks, toks2):
        raise AssertionError(f"[{tag}] a second generation gave other tokens")
    if forms:
        worst = max(f[0] for f in forms.values())
        if not worst <= MLA_FORM_REL_L2:
            raise AssertionError(f"[{tag}] naive MLA form vs absorbed with "
                                 f"the experts replayed: relative L2 "
                                 f"{worst:.4g} > {MLA_FORM_REL_L2}")

    t0 = time.perf_counter()
    if n_moe:
        tally = [0, 0]
        with drops_counted(tally):
            transformer.prefill(cfg, params, prompts)
        drop_share = 1.0 - tally[0] / tally[1]
        cfg_nd, cf, nudged = no_drop_cfg(cfg, b * prompt)
        pre_routes = []
        with routes_kept(pre_routes):
            pre = transformer.prefill(cfg_nd, params, prompts).float()
        differ = route_diff(dec_routes, pre_routes, b, prompt, n_moe)
    else:
        pre = transformer.prefill(cfg, params, prompts).float()
    sync(dev)
    pre_ms = (time.perf_counter() - t0) * 1e3
    rel = rel_l2(pre, last)
    if not n_moe and not rel <= PREFILL_REL_L2:
        raise AssertionError(f"[{tag}] prefill vs decode logits at position "
                             f"{prompt - 1}: relative L2 {rel:.4g} > "
                             f"{PREFILL_REL_L2}")
    cache = transformer.init_cache(cfg, b, prompt + gen, device=dev)
    calls = aten_calls(lambda: transformer.decode_step(
        cfg, params, cache, prompts[:, :1],
        torch.zeros((b,), dtype=torch.int32, device=dev)))
    del cache
    gen_ms = step_ms[prompt:]
    gen_rate = b * len(gen_ms) / (sum(gen_ms) / 1e3)
    _, bound = step_bound(cfg, params, b, prompt + gen)
    checks = ["the second run generated identical tokens"]
    if gqa:
        checks.append(f"decode_attention's outputs at layer 0 of steps "
                      f"{attn_steps} (kv_len {[t + 1 for t in attn_steps]}) "
                      f"within {attn_err:.3g} of the plain version (bound "
                      f"{ATTN_TOL})")
    if forms:
        checks.append("the naive MLA form at steps " + ", ".join(
            f"{t}: relative L2 {f[0]:.3g} with the absorbed step's experts "
            f"replayed ({f[1]:.3g} without; {f[2]:.3f} of routing choices "
            f"then differ)" for t, f in forms.items())
            + f" (bound {MLA_FORM_REL_L2}, replayed)")
    if n_moe:
        pre_text = (f"prefill of {b}x{prompt} at the published capacity "
                    f"factor {cfg.moe.capacity_factor} drops "
                    f"{drop_share:.4f} of routed assignments; at "
                    f"capacity factor {cf!r} (cap = {b * prompt} tokens"
                    f"{', float steps added: ' + str(nudged) if nudged else ''}"
                    f"; no drops) in {pre_ms:.1f} ms with both runs, its last "
                    f"logits within relative L2 {rel:.3g} of the decode "
                    f"path's at full depth in bfloat16 (not gated; "
                    f"{differ:.4f} of (token, layer) routing "
                    f"choices differ)")
    else:
        pre_text = (f"prefill of {b}x{prompt} in {pre_ms:.1f} ms, its last "
                    f"logits within relative L2 {rel:.3g} of the decode "
                    f"path's (bound {PREFILL_REL_L2})")
    log(f"[{tag}] {b} prompts x {prompt} tokens teacher-forced through "
        f"decode_step, then {gen} greedy tokens a row ({steps} steps into a "
        f"cache of {prompt + gen}) in {secs:.2f}s; step "
        f"{step_stats(step_ms)} (bound at the full cache {bound}); "
        f"generation {gen_rate:.1f} tokens/s ({step_stats(gen_ms)}); "
        f"{pre_text}; {'; '.join(checks)}; one step makes {calls} aten "
        f"calls (views included); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if n_moe:
        rel4, share4 = f32_prefix(cfg, params, prompts, dev, tag)
        log(f"[{tag}] float32 copy of the first {F32_LAYERS} layers at full "
            f"width: prefill (no drops) vs decode last logits relative L2 "
            f"{rel4:.3g} (bound {PREFILL_REL_L2}); {share4:.4f} of routing "
            f"choices differ")
    return counts, attn_err


def lm_cell(cfg, params, dev, seed: int, tag: str, b: int, s: int,
            full_b: int, salt: int) -> dict:
    """[<tag>]: LM_CELL_STEPS decode steps at kv_len = S - 1 against a
    cache of random bfloat16 values (the cell's batch is ``full_b``).
    Returns the launch counts of the timed steps."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    if b < full_b:
        full_kv = full_b * s * cfg.n_layers * kv_token_bytes(cfg)
        log(f"[{tag}] batch cut: {full_b} -> {b} (the cell's cache, "
            f"{full_kv / 2**30:.0f} GiB, does not fit beside "
            f"{cfg.n_params() * 2 / 2**30:.1f} GiB of weights on one card)")
    n_moe = sum("moe" in lp for lp in params["layers"])
    gqa = cfg.attention == "gqa"
    g = torch.Generator(device=dev).manual_seed(seed + salt)
    t0 = time.perf_counter()
    cache = transformer.init_cache(cfg, b, s, device=dev)
    for name in cache:
        for i in range(cfg.n_layers):
            cache[name][i].normal_(generator=g)
    sync(dev)
    fill_s = time.perf_counter() - t0
    lens = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=dev)
    for _ in range(2):                                    # warm-up
        transformer.decode_step(cfg, params, cache, tokens, lens)
    sync(dev)
    ops.reset_launch_counts()
    step_ms = []
    for _ in range(LM_CELL_STEPS):
        t0 = time.perf_counter()
        logits, cache = transformer.decode_step(cfg, params, cache, tokens,
                                                lens)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    want = cfg.n_layers * LM_CELL_STEPS if gqa else 0
    if counts["decode_attention"] != want:
        raise AssertionError(f"[{tag}] decode_attention launched "
                             f"{counts['decode_attention']} times, not "
                             f"{want}")
    if counts["topk"] != n_moe * LM_CELL_STEPS:
        raise AssertionError(f"[{tag}] topk launched {counts['topk']} "
                             f"times, not {n_moe} per step")
    if logits.shape != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"[{tag}] logits of shape "
                             f"{tuple(logits.shape)} or not finite")
    p50 = statistics.median(step_ms)
    attn = ""
    if gqa:
        # decode_attention alone on layer 0's cache at the step's shape.
        q = torch.randn((b, cfg.n_heads, cfg.d_head), generator=g,
                        device=dev).bfloat16()
        ms, _ = time_calls(lambda: ops.decode_attention(
            q, cache["k"][0], cache["v"][0], lens + 1), hold=True)
        attn_bound = attention_bound(lens + 1, s, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.d_head, 2)
        attn = (f"; decode_attention {ms:.4f} ms on the device per launch "
                f"(bound {attn_bound[0]:.4f} ms), {cfg.n_layers} launches a "
                f"step = {100 * cfg.n_layers * ms / p50:.1f}% of the p50 step")
    log(f"[{tag}] B={b} S={s} kv_len=S-1, cache filled in {fill_s:.1f}s; "
        f"{LM_CELL_STEPS} steps: {step_stats(step_ms)}, "
        f"{b / (p50 / 1e3):.1f} tokens/s at p50; step bound "
        f"{step_bound(cfg, params, b, s)[1]}{attn}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    del cache
    torch.cuda.empty_cache()
    return counts


def lm_paths(dev, seed: int) -> tuple[dict, float]:
    """Every LM path: qwen2-7b ([lm-serve] and its two cells), then the
    rest of the zoo at full width and depth (LM_ZOO).  Returns ({path:
    launch counts}, decode_attention's max abs error on the paths)."""
    import torch

    from repro_torch.configs import base

    out = {}
    log(f"[lm] cut for time (the training phases): [lm-serve] prompts "
        f"{LM_PROMPT} -> {SERVE_PROMPT} tokens, generation {LM_GEN} -> "
        f"{SERVE_GEN}")
    cfg = qwen2()
    params = lm_params(cfg, dev, seed, 505)
    out["lm-serve"], attn_err = lm_serve(
        cfg, params, dev, seed, "lm-serve", SERVE_PROMPT, SERVE_GEN,
        SERVE_CHECK_STEPS, 606)
    torch.cuda.empty_cache()
    for cell, b, s in LM_CELLS:
        full_b = base.get("qwen2-7b").cell(cell).meta["batch"]
        out[f"lm-{cell}"] = lm_cell(cfg, params, dev, seed, f"lm-{cell}", b,
                                    s, full_b, 707)
    del params
    torch.cuda.empty_cache()
    for i, (arch, tag) in enumerate(LM_ZOO):
        t_phase = time.perf_counter()
        cfg = base.get(arch).config
        salt = 811 + 10 * i
        params = lm_params(cfg, dev, seed, salt)
        if cfg.attention == "mla":
            out[f"lm-{tag}-serve"], _ = lm_serve(
                cfg, params, dev, seed, f"lm-{tag}-serve", LM_PROMPT, LM_GEN,
                LM_CHECK_STEPS, salt + 1)
            torch.cuda.empty_cache()
            for cell, b, s in ZOO_CELLS:
                full_b = base.get(arch).cell(cell).meta["batch"]
                out[f"lm-{tag}-{cell}"] = lm_cell(
                    cfg, params, dev, seed, f"lm-{tag}-{cell}", b, s, full_b,
                    salt + 2)
        else:
            out[f"lm-{tag}-serve"], err = lm_serve(
                cfg, params, dev, seed, f"lm-{tag}-serve", ZOO_PROMPT,
                ZOO_GEN, ZOO_ATTN_STEPS, salt + 1)
            attn_err = max(attn_err, err)
        del params
        torch.cuda.empty_cache()
        log(f"[lm-{tag}] phase {time.perf_counter() - t_phase:.1f} s")
    return out, attn_err


# ------------------------------------------------------- phase 4: training

TRAIN_CELL = "train_4k"                # S = 4096 (configs/base.py)
# [lm-train]'s batch, cut from train_4k's 256: the largest power of two
# that fits minicpm-2b's float32 state (43.6 GB) on one 80 GB card.
TRAIN_BATCH = 2
TRAIN_STEPS = 8
TRAIN_LR = 3e-4                        # launch/train.py's default
DRYRUN_WAIT_S = 120                    # [lm-train]'s dry run, at most
# [lm-train-moe]: deepseek-v2-lite's depth cut from 27 to its dense first
# layer and 3 MoE layers (the full depth's 251 GB of state does not fit).
# 8 steps: the launcher's warmup of 5, then 3 of the cosine decay.
TRAIN_MOE_LAYERS, TRAIN_MOE_BATCH, TRAIN_MOE_STEPS = 4, 1, 8
ROUTER_GRAD_REL_L2 = 1e-5
# [lm-train-moe-ep]: the layer gates' meshes and tokens, and the steps.
EP_AXES = ("data", "model")
EP_GATE_MESHES = ((1, 4), (2, 2))
EP_GATE_BATCH = 2                      # x train_4k's 4,096 tokens
EP_AMPLE_CF = 8.0                      # tests/_distributed_worker.py:155
EP_REL_L2, EP_AUX_TOL, EP_GRAD_REL_L2 = 1e-5, 1e-5, 1e-4
EP_TRAIN_MESH, EP_TRAIN_STEPS = (1, 4), 4
EXAMPLE_TRAIN_STEPS = 100


def topk_plain_grad(x, k: int):
    """``topk_ref``'s ids, and its values as a gather from ``x`` (the same
    values), so autograd differentiates them: the plain version of
    ``ops.topk`` with its value gradient."""
    import torch

    from repro_torch.kernels import ref

    with torch.no_grad():
        _, ids = ref.topk_ref(x, k)
    return x.gather(1, ids.long()), ids


def topk_train_router(dev, g) -> dict:
    """``topk`` at the training router's shape: train_4k's 4,096 tokens x
    64 experts (deepseek-v2-lite), k = 6, on negated softmax probabilities
    with planted ties (a uniform row, a row of three levels, a row of
    zeros): values and ids bit-identical to ``topk_ref``, and the value
    gradient (``ops.topk``'s backward) equal bit for bit to the plain
    version's (:func:`topk_plain_grad`); timed."""
    import torch

    from repro_torch.kernels import ops

    e, k = 64, 6
    probs = torch.softmax(torch.randn((ROUTER_TRAIN_TOKENS, e), generator=g,
                                      device=dev) * 2, dim=-1)
    probs[0] = 1.0 / e
    levels = torch.randint(0, 3, (e,), generator=g, device=dev).float()
    probs[1] = (levels + 1) / (levels + 1).sum()
    probs[2] = 0.0
    out = topk_timed(-probs, k, f"training router, {e} experts")
    w = torch.randn((ROUTER_TRAIN_TOKENS, k), generator=g, device=dev)
    grads = []
    for fn in (ops.topk, topk_plain_grad):
        x = (-probs).requires_grad_(True)
        vals, _ = fn(x, k)
        grads.append(torch.autograd.grad((vals * w).sum(), x)[0])
    sync(dev)
    if not torch.equal(grads[0], grads[1]):
        raise AssertionError("topk's value gradient at the training "
                             "router's shape differs from the plain "
                             "version's")
    log(f"[phase2] topk {ROUTER_TRAIN_TOKENS}x{e} k={k} (training router): "
        f"value gradient equal bit for bit to the plain version's (a "
        f"gather at topk_ref's ids; {int((grads[0] != 0).sum())} non-zero "
        f"entries)")
    out["value_grad"] = "bit-identical"
    return out


def train_loop(state, step_fn, data, steps: int, sched, tag: str):
    """``steps`` calls of ``step_fn``, each between two synchronises:
    (step ms, metrics as floats, the optimizer update's ms from CUDA
    events around ``adamw_update``).  Fails unless every metric (loss,
    the model's own, grad_norm, lr) is finite at every step and lr is
    ``sched``'s value."""
    import math

    import torch

    from repro_torch.training import optimizer as opt_mod

    events, real = [], opt_mod.adamw_update

    def timed(*args):
        ev = (torch.cuda.Event(True), torch.cuda.Event(True))
        ev[0].record()
        out = real(*args)
        ev[1].record()
        events.append(ev)
        return out

    step_ms, rows = [], []
    opt_mod.adamw_update = timed
    try:
        for i in range(steps):
            batch = next(data)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append({k: float(v) for k, v in m.items()})
    finally:
        opt_mod.adamw_update = real
    for i, r in enumerate(rows):
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"[{tag}] step {i + 1}: non-finite "
                                 f"metrics {r}")
        want = float(sched(i + 1))
        if r["lr"] != want:
            raise AssertionError(f"[{tag}] step {i + 1}: lr {r['lr']!r}, "
                                 f"the schedule gives {want!r}")
    upd_ms = [a.elapsed_time(b) for a, b in events]
    return state, step_ms, rows, upd_ms


def state_bytes(state) -> int:
    from repro_torch.training import optimizer as opt_mod

    return sum(t.numel() * t.element_size()
               for _, t in opt_mod.flatten(state))


def uniform_batches(vocab: int, batch: int, seq: int, seed: int, dev):
    """LmBatches' layout with token ids uniform over the vocabulary (no
    Zipfian repeats), drawn on the card."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    while True:
        toks = torch.randint(0, vocab, (batch, seq + 1), generator=g,
                             device=dev)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def train_setup(spec, cfg, dev, seed: int, salt: int, steps: int,
                batch: int, uniform: bool = False, mesh=None):
    """Float32 master weights drawn from the seed on the card, the
    launcher's optimizer config for the arch, its train step (``lm_loss``
    on ``mesh`` when one is given) and a data stream (LmBatches' Zipfian
    draws, or :func:`uniform_batches`): (state, step_fn, data, schedule,
    opt_cfg)."""
    import torch

    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts_mod
    from repro_torch.training.data import LmBatches

    g = torch.Generator(device=dev).manual_seed(seed + salt)
    params = transformer.init_lm(cfg, g, device=dev, dtype=torch.float32)
    opt_cfg = train_launch.train_config(spec.arch_id, TRAIN_LR, steps)
    step_fn = ts_mod.make_train_step(
        lambda p, b: transformer.lm_loss(cfg, p, b, mesh), opt_cfg)
    state = ts_mod.init_train_state(params)
    s = spec.cell(TRAIN_CELL).meta["seq"]
    if uniform:
        data = uniform_batches(cfg.vocab, batch, s, seed + salt, dev)
    else:
        data = iter(LmBatches(cfg.vocab, batch, s, seed=seed + salt,
                              device=str(dev)))
    return state, step_fn, data, opt_mod.schedule_fn(opt_cfg), opt_cfg


def train_flops(cfg, b: int, s: int) -> tuple[float, str]:
    """Model FLOPs of one train step: 6 N per token, N the parameters a
    token multiplies (``n_active_params``: an MoE layer's top_k of its
    routed experts; an untied input embedding, a lookup, left out), plus
    the blockwise attention's full S x S blocks (every key chunk is
    computed, masked or not): QK^T and PV, 2 x 2 B H S^2 d forward, three
    times that with backward, in every layer (remat's recompute not
    counted)."""
    active = cfg.n_active_params()
    emb = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    n = active - emb
    if cfg.attention == "mla":
        dqk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
        dv = cfg.mla.v_head_dim
    else:
        dqk = dv = cfg.d_head
    h = cfg.n_heads
    dense = 6 * n * b * s
    attn = 3 * 2 * b * h * s * s * (dqk + dv) * cfg.n_layers
    return dense + attn, (f"6 x ({active} active - {emb} input embedding) "
                          f"x {b * s} + 3 x 2 x {b} x {h} x {s}^2 x "
                          f"({dqk} + {dv}) x {cfg.n_layers} = "
                          f"{(dense + attn) / 1e12:.2f} TFLOP")


def train_dryrun_start(arch: str, batch: int):
    """Start the dry run of [lm-train]'s step (``arch`` at TRAIN_CELL, the
    batch cut to ``batch``: the same config, the float32 state
    ``train_setup`` makes) on the meta device, in a process of its own on
    the host's other cores while the card trains, the card hidden from it:
    (process, its record's path)."""
    out = tempfile.mkdtemp(prefix="mcgi-dryrun-")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", TRAIN_CELL, "--batch", str(batch), "--out", out]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    from repro_torch.launch import dryrun

    return proc, dryrun.record_path(pathlib.Path(out), arch, TRAIN_CELL,
                                    batch=batch)


def train_dryrun_finish(proc, path) -> tuple[dict, float]:
    """Wait for :func:`train_dryrun_start`'s process (at most
    DRYRUN_WAIT_S; killed past it): (its record, seconds waited); raises
    if it failed.  Its directory is removed either way."""
    t0 = time.perf_counter()
    try:
        try:
            text, _ = proc.communicate(timeout=DRYRUN_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"[lm-train] dry run still running after "
                                 f"{DRYRUN_WAIT_S} s of waiting")
        if proc.returncode != 0:
            raise AssertionError(f"[lm-train] dry run failed:\n"
                                 f"{text[-3000:]}")
        return json.loads(path.read_text()), time.perf_counter() - t0
    finally:
        shutil.rmtree(path.parent, ignore_errors=True)


def lm_train(dev, card: str, seed: int) -> dict:
    """[lm-train]: minicpm-2b at full width and depth (40 layers,
    2,725,173,504 parameters) trained through ``make_train_step`` at
    train_4k's sequence, the batch cut to TRAIN_BATCH: float32 master
    weights from the seed, bfloat16 compute, remat on, the WSD schedule
    as ``launch/train.py`` picks it, TRAIN_STEPS steps.  Fails unless
    loss, ce and grad_norm are finite at every step, lr equals
    ``schedule_fn``'s value and the mean loss of the last two steps is
    below the first step's, and unless the dry run of the same step on the
    meta device (``launch/dryrun.py``, in its own process beside the
    steps) holds a state of exactly the card's bytes; its predicted peak
    and FLOPs are printed beside the measured ones.  Returns the launch
    counts."""
    import torch

    from repro_torch.configs import base
    from repro_torch.kernels import ops

    from repro_torch.launch import cells

    t_phase = time.perf_counter()
    spec = base.get("minicpm-2b")
    cfg = spec.config
    cell = spec.cell(TRAIN_CELL).meta
    s = cell["seq"]
    dry_proc, dry_path = train_dryrun_start(spec.arch_id, TRAIN_BATCH)
    log(f"[lm-train] batch cut: {cell['batch']} -> {TRAIN_BATCH} (train_4k "
        f"at S={s}; the float32 weights, gradients and AdamW moments "
        f"alone take {16 * cfg.n_params() / 1e9:.1f} GB)")
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        state, step_fn, data, sched, opt_cfg = train_setup(
            spec, cfg, dev, seed, 901, TRAIN_STEPS, TRAIN_BATCH)
        held = state_bytes(state)
        ops.reset_launch_counts()
        state, step_ms, rows, upd_ms = train_loop(
            state, step_fn, data, TRAIN_STEPS, sched, "lm-train")
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    except BaseException:
        dry_proc.kill()
        dry_proc.communicate()
        raise
    if opt_cfg.schedule != cells.lm_schedule(spec.arch_id):
        raise AssertionError(f"[lm-train] schedule {opt_cfg.schedule!r}, "
                             f"the train cells' is "
                             f"{cells.lm_schedule(spec.arch_id)!r}")
    dry, waited = train_dryrun_finish(dry_proc, dry_path)
    dry_state = dry["memory"]["argument_bytes_each"][0]
    if dry_state != held:
        raise AssertionError(f"[lm-train] the dry run's state is "
                             f"{dry_state} bytes, the card's {held}")
    losses = [r["loss"] for r in rows]
    if not (losses[-1] + losses[-2]) / 2 < losses[0]:
        raise AssertionError(f"[lm-train] loss did not fall: {losses}")
    p50 = statistics.median(step_ms)
    flops, count = train_flops(cfg, TRAIN_BATCH, s)
    tokens = TRAIN_BATCH * s
    log(f"[lm-train] minicpm-2b at full width and depth, {TRAIN_STEPS} "
        f"steps of {TRAIN_BATCH}x{s} tokens ({opt_cfg.schedule}, warmup "
        f"{opt_cfg.warmup_steps}, lr {opt_cfg.lr}; float32 master weights, "
        f"{cfg.dtype} compute, remat on): losses "
        f"{[round(x, 4) for x in losses]}, ce {rows[-1]['ce']:.4f}, "
        f"grad_norm {[round(r['grad_norm'], 3) for r in rows]}, lr "
        f"{[r['lr'] for r in rows]} (each schedule_fn's); step "
        f"{step_stats(step_ms)}, {tokens / (p50 / 1e3):.1f} tokens/s at "
        f"p50; optimizer update p50 {statistics.median(upd_ms):.3f} ms "
        f"(CUDA events); peak memory {peak / 1e9:.2f} GB "
        f"(max_memory_allocated), state {held / 1e9:.2f} GB (weights and "
        f"moments; gradients {held / 3e9:.2f} GB more during a step); "
        f"model FLOPs {count}: {100 * flops / (p50 / 1e3) / BF16_TC_OPS_PER_S:.2f}"
        f"% of {BF16_TC_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 at p50; {card}")
    dpeak = dry["memory"]["peak_per_device_bytes"]
    dflops = dry["cost"]["flops_per_device"]
    log(f"[lm-train] dry run of the same step on the meta device "
        f"(launch/dryrun.py, batch {TRAIN_BATCH}): state {dry_state} bytes "
        f"= held {held} (gate); predicted peak {dpeak / 1e9:.3f} GB vs "
        f"max_memory_allocated {peak / 1e9:.3f} GB (ratio "
        f"{dpeak / peak:.4f}); counted FLOPs {dflops / 1e12:.2f} T "
        f"({', '.join(f'{k} {v / 1e12:.2f} T' for k, v in dry['cost']['flops_by_dtype'].items())}; "
        f"remat's recompute and the head included) vs model FLOPs "
        f"{flops / 1e12:.2f} T (ratio {dflops / flops:.4f}); dry run "
        f"{dry['timings_s']['build'] + dry['timings_s']['run']:.1f} s in "
        f"its own process beside the steps, {waited:.1f} s waited for it")
    del state, data
    torch.cuda.empty_cache()
    log(f"[lm-train] phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def router_grad_check(cfg, params_moe, dev, g) -> tuple[float, float]:
    """A float32 copy of one MoE layer at train_4k's 4,096 tokens: the
    router's gradient of the layer's output alone (aux_loss_weight = 0),
    with ``ops.topk`` (the kernel) and with ``topk_ref`` in its place
    (:func:`topk_plain_grad`), on the same card tensors.  Returns
    (relative L2 between the two, the kernel path's norm)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.training import optimizer as opt_mod

    p = opt_mod.tree_map(lambda t: t.detach().float().clone(), params_moe)
    x = torch.randn((1, ROUTER_TRAIN_TOKENS, cfg.d_model), generator=g,
                    device=dev)
    grads, real = [], ops.topk
    for plain in (False, True):
        router = p["router"].clone().requires_grad_(True)
        if plain:
            ops.topk = topk_plain_grad
        try:
            out, _ = moe.moe_apply(dict(p, router=router), cfg.moe, x)
        finally:
            ops.topk = real
        grads.append(torch.autograd.grad(out.square().mean(), router)[0])
    return rel_l2(grads[0], grads[1]), float(grads[0].norm())


def moe_run(spec, cfg, dev, seed: int, uniform: bool, tag: str):
    """TRAIN_MOE_STEPS steps of ``cfg`` from the cell's weights (the same
    seed and salt), on the cell's Zipfian batches or on uniform ones:
    (state, step ms, metrics rows, update ms, the launch counts of the
    steps (from 0), share of routed assignments the capacity factor drops
    on the next batch, the optimizer config)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    state, step_fn, data, sched, opt_cfg = train_setup(
        spec, cfg, dev, seed, 911, TRAIN_MOE_STEPS, TRAIN_MOE_BATCH,
        uniform=uniform)
    ops.reset_launch_counts()
    state, step_ms, rows, upd_ms = train_loop(
        state, step_fn, data, TRAIN_MOE_STEPS, sched, tag)
    counts = ops.launch_counts()
    tally = [0, 0]
    with torch.no_grad(), drops_counted(tally):
        transformer.forward(cfg, state.params, next(data)["tokens"])
    return (state, step_ms, rows, upd_ms, counts, 1 - tally[0] / tally[1],
            opt_cfg)


def moe_curve(rows: list, dropped: float) -> str:
    return (f"losses {[round(r['loss'], 4) for r in rows]}, ce "
            f"{[round(r['ce'], 4) for r in rows]}, aux "
            f"{[round(r['aux'], 4) for r in rows]}, grad_norm "
            f"{[round(r['grad_norm'], 3) for r in rows]}; then "
            f"{dropped:.4f} of routed assignments dropped")


def lm_train_moe(dev, card: str, seed: int) -> tuple[dict, dict]:
    """[lm-train-moe]: deepseek-v2-lite-16b at full width, depth cut to
    TRAIN_MOE_LAYERS (the dense first layer and 3 MoE layers), train_4k's
    sequence at batch TRAIN_MOE_BATCH, TRAIN_MOE_STEPS steps with the
    launcher's cosine schedule.  Fails unless every step's metrics are
    finite and its lr the schedule's, ``topk`` launched twice a MoE layer
    a step (the forward and remat's recompute), and the router gradient
    through the kernel in a float32 MoE layer equals the one through
    ``topk_ref`` within ROUTER_GRAD_REL_L2 and is non-zero.  Two witness
    runs from the same weights follow, their curves printed beside the
    cell's: float32 compute on the same batches (bfloat16 rounding), and
    bfloat16 on uniform token ids (the traffic's Zipfian repeats).
    Returns (the launch counts of the cell's steps, {"first_loss",
    "p50"}: its first step's loss and its step p50 ms)."""
    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    spec = base.get("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(spec.config, n_layers=TRAIN_MOE_LAYERS)
    cell = spec.cell(TRAIN_CELL).meta
    s = cell["seq"]
    n_moe = TRAIN_MOE_LAYERS - cfg.first_k_dense
    log(f"[lm-train-moe] depth cut: {spec.config.n_layers} -> "
        f"{TRAIN_MOE_LAYERS} layers ({cfg.first_k_dense} dense, {n_moe} "
        f"MoE; {cfg.n_params()} parameters, {16 * cfg.n_params() / 1e9:.1f}"
        f" GB of float32 state; the full depth's "
        f"{16 * spec.config.n_params() / 1e9:.0f} GB does not fit); batch "
        f"cut: {cell['batch']} -> {TRAIN_MOE_BATCH}")
    torch.cuda.reset_peak_memory_stats(dev)
    state, step_ms, rows, upd_ms, counts, dropped, opt_cfg = moe_run(
        spec, cfg, dev, seed, False, "lm-train-moe")
    peak = torch.cuda.max_memory_allocated(dev)
    want = 2 * n_moe * TRAIN_MOE_STEPS
    if counts["topk"] != want:
        raise AssertionError(f"[lm-train-moe] topk launched "
                             f"{counts['topk']} times, not {want} (one a "
                             f"MoE layer a forward, and its recompute)")
    g = torch.Generator(device=dev).manual_seed(seed + 912)
    rel, norm = router_grad_check(cfg, state.params["layers"][1]["moe"], dev,
                                  g)
    if not rel <= ROUTER_GRAD_REL_L2:
        raise AssertionError(f"[lm-train-moe] router gradient through the "
                             f"kernel vs topk_ref: relative L2 {rel:.3g} > "
                             f"{ROUTER_GRAD_REL_L2}")
    if not norm > 0:
        raise AssertionError("[lm-train-moe] the router gets no gradient "
                             "through the top-k values")
    del state
    torch.cuda.empty_cache()
    p50 = statistics.median(step_ms)
    flops, count = train_flops(cfg, TRAIN_MOE_BATCH, s)
    log(f"[lm-train-moe] {TRAIN_MOE_STEPS} steps of {TRAIN_MOE_BATCH}x{s} "
        f"tokens ({opt_cfg.schedule}, warmup {opt_cfg.warmup_steps}, lr "
        f"{opt_cfg.lr}; float32 master weights, {cfg.dtype} compute, remat "
        f"on; LmBatches' Zipfian ids): {moe_curve(rows, dropped)}; step "
        f"{step_stats(step_ms)}, "
        f"{TRAIN_MOE_BATCH * s / (p50 / 1e3):.1f} tokens/s at p50; optimizer "
        f"update p50 {statistics.median(upd_ms):.3f} ms; peak memory "
        f"{peak / 1e9:.2f} GB; model FLOPs {count}: "
        f"{100 * flops / (p50 / 1e3) / BF16_TC_OPS_PER_S:.2f}% of "
        f"{BF16_TC_OPS_PER_S / 1e12:.0f} TFLOP/s bf16 at p50; topk "
        f"{counts['topk']} launches = {n_moe} MoE layers x 2 (forward and "
        f"remat's recompute) x {TRAIN_MOE_STEPS} steps (the published "
        f"capacity factor {cfg.moe.capacity_factor}); float32 MoE "
        f"layer 1 at {ROUTER_TRAIN_TOKENS} tokens, aux_loss_weight = 0: the "
        f"router's gradient through the kernel within relative L2 "
        f"{rel:.3g} of topk_ref's (bound {ROUTER_GRAD_REL_L2}), norm "
        f"{norm:.4g}; {card}")
    witness = (("float32 compute, the same Zipfian batches",
                dataclasses.replace(cfg, dtype=torch.float32), False),
               (f"{cfg.dtype} compute, uniform token ids", cfg, True))
    for what, c, uniform in witness:
        state, _, w_rows, _, _, w_drop, _ = moe_run(
            spec, c, dev, seed, uniform, "lm-train-moe witness")
        del state
        torch.cuda.empty_cache()
        log(f"[lm-train-moe] witness, {what}, from the same weights: "
            f"{moe_curve(w_rows, w_drop)}")
    log(f"[lm-train-moe] phase {time.perf_counter() - t_phase:.1f} s")
    return counts, {"first_loss": rows[0]["loss"], "p50": p50}


def ep_layer_grads(p, cfg, x, w, **kw):
    """The output, aux and the gradients of ``sum(out * w) + aux`` with
    respect to x, the router and the three expert weights of
    ``moe.moe_apply(p, cfg, x, **kw)``."""
    import torch

    from repro_torch.models import moe

    names = ("router", "w_gate", "w_up", "w_down")
    leaf = {n: p[n].detach().requires_grad_(True) for n in names}
    x = x.detach().requires_grad_(True)
    out, aux = moe.moe_apply(dict(p, **leaf), cfg, x, **kw)
    grads = torch.autograd.grad((out * w).sum() + aux,
                                [x] + [leaf[n] for n in names])
    return out.detach(), aux.detach(), dict(zip(("x",) + names, grads))


def ep_layer_gates(cfg, params_moe, dev, g, devices=None) -> str:
    """[lm-train-moe-ep]'s layer gates on a float32 copy of one MoE layer
    at EP_GATE_BATCH x train_4k's tokens, each mesh of EP_GATE_MESHES
    over ``devices`` (every visible card by default): at EP_AMPLE_CF the schedule's output within
    EP_REL_L2 of ``moe_apply``'s one group, aux within EP_AUX_TOL, no
    assignment dropped, gradients within EP_GRAD_REL_L2 (the router's
    non-zero); at the published capacity factor the output within
    EP_REL_L2 of ``moe_apply`` over the rank blocks, a group a rank.
    Returns the lines' text."""
    import dataclasses

    import torch

    from repro_torch.distributed import make_mesh
    from repro_torch.models import moe
    from repro_torch.training import optimizer as opt_mod

    p = opt_mod.tree_map(lambda t: t.detach().float().clone(), params_moe)
    mc = cfg.moe
    b, s = EP_GATE_BATCH, ROUTER_TRAIN_TOKENS
    x = torch.randn((b, s, mc.d_model), generator=g, device=dev)
    w = torch.randn((b, s, mc.d_model), generator=g, device=dev)
    ample = dataclasses.replace(mc, capacity_factor=EP_AMPLE_CF)
    one = ep_layer_grads(p, ample, x, w, n_groups=1)
    lines = []
    for shape in EP_GATE_MESHES:
        mesh = make_mesh(shape, EP_AXES, devices)
        where = f"mesh {shape} ({mesh.describe()})"
        if not moe._expert_parallel_ok(ample, x, mesh):
            raise AssertionError(f"[lm-train-moe-ep] {where}: the schedule "
                                 f"does not apply to {tuple(x.shape)}")
        tally = [0, 0]
        with drops_counted(tally):
            ep = ep_layer_grads(p, ample, x, w, mesh=mesh)
        rel, aux_err = rel_l2(ep[0], one[0]), abs(float(ep[1] - one[1]))
        grad_rel = {n: rel_l2(ep[2][n], one[2][n]) for n in one[2]}
        if not (rel <= EP_REL_L2 and aux_err <= EP_AUX_TOL
                and tally[0] == tally[1]):
            raise AssertionError(
                f"[lm-train-moe-ep] {where}, capacity factor "
                f"{EP_AMPLE_CF}: output relative L2 {rel:.3g} (bound "
                f"{EP_REL_L2}), aux error {aux_err:.3g} (bound "
                f"{EP_AUX_TOL}), {tally[1] - tally[0]} assignments dropped")
        if not (max(grad_rel.values()) <= EP_GRAD_REL_L2
                and float(ep[2]["router"].norm()) > 0):
            raise AssertionError(f"[lm-train-moe-ep] {where}: gradients "
                                 f"against the one-group path {grad_rel} "
                                 f"(bound {EP_GRAD_REL_L2}), router norm "
                                 f"{float(ep[2]['router'].norm()):.4g}")
        with torch.no_grad():
            tally = [0, 0]
            with drops_counted(tally):
                got, _ = moe.moe_apply(p, mc, x, mesh=mesh)
            ranks = moe._ranks(mesh)
            bl, sl = b // shape[0], s // shape[1]

            def blocks(t):
                return torch.cat([t[i * bl:(i + 1) * bl, j * sl:(j + 1) * sl]
                                  .reshape(bl * sl, -1) for i, j, _ in ranks])
            want, _ = moe.moe_apply(p, mc, blocks(x)[None],
                                    n_groups=len(ranks))
            pub = rel_l2(blocks(got), want[0])
        if not pub <= EP_REL_L2:
            raise AssertionError(f"[lm-train-moe-ep] {where}, capacity "
                                 f"factor {mc.capacity_factor}: relative L2 "
                                 f"{pub:.3g} against moe_apply over the rank "
                                 f"blocks (bound {EP_REL_L2})")
        lines.append(
            f"{where}: capacity factor {EP_AMPLE_CF}: output within "
            f"relative L2 {rel:.3g} of moe_apply's one group, aux within "
            f"{aux_err:.3g}, nothing dropped, gradients within "
            f"{max(grad_rel.values()):.3g} ("
            + ", ".join(f"{n} {v:.3g}" for n, v in grad_rel.items())
            + f"; router norm {float(ep[2]['router'].norm()):.4g}); "
            f"capacity factor {mc.capacity_factor}: within {pub:.3g} of "
            f"moe_apply over the rank blocks ({len(ranks)} groups), "
            f"{1 - tally[0] / tally[1]:.4f} of assignments dropped")
        del ep
    return "; ".join(lines)


def ep_cross_bytes(cfg, mesh, b: int, s: int) -> int:
    """Bytes one MoE layer's forward in ``cfg.dtype`` copies between cards
    on ``mesh`` (weights and tokens on the mesh's first card): each rank
    off that card receives its token block, the router and its experts'
    slices and returns its outputs and two E-wide float32 sums, and each
    slab of the two exchanges crosses where its two ranks sit on different
    cards.  0 on one card."""
    import torch

    from repro_torch.launch.mesh import dp_axes
    from repro_torch.models import moe

    mc = cfg.moe
    el = torch.empty((), dtype=cfg.dtype).element_size()
    n_dp = moe._axis_size(mesh, dp_axes(mesh))
    n_tp = mesh.shape["model"]
    t_local = (b // n_dp) * (s // n_tp)
    e_local = mc.n_experts // n_tp
    cap = max(int(mc.capacity_factor * t_local * mc.top_k / mc.n_experts), 1)
    ranks = moe._ranks(mesh)
    dev = {(i, j): d for i, j, d in ranks}
    off = sum(d != mesh.device for _, _, d in ranks)
    per_rank = (2 * t_local * mc.d_model * el
                + mc.d_model * mc.n_experts * el
                + 3 * e_local * mc.d_model * mc.d_expert * el
                + 2 * mc.n_experts * 4)
    slab = e_local * cap * mc.d_model * el
    pairs = sum(dev[i, j] != dev[i, jp] for i, j, _ in ranks
                for jp in range(n_tp))
    return off * per_rank + 2 * pairs * slab


def lm_train_moe_ep(dev, card: str, seed: int, moe_cell: dict | None,
                    devices=None) -> tuple[dict, float]:
    """[lm-train-moe-ep]: :func:`ep_layer_gates` on [lm-train-moe]'s MoE
    layer 1, then EP_TRAIN_STEPS steps of its cell (the same weights,
    batches and schedule) with ``lm_loss(..., mesh)`` on a mesh
    EP_TRAIN_MESH over ``devices`` (every visible card by default; the
    gates' meshes too).
    Fails unless the gates pass, every step's metrics are finite and its
    lr the schedule's, and ``topk`` launched once a rank a MoE layer a
    forward (and its recompute).  ``moe_cell``: [lm-train-moe]'s first
    loss and step p50, printed beside this run's (None: not run).
    Returns (the launch counts of the steps, the first step's loss)."""
    import dataclasses

    import torch

    from repro_torch.configs import base
    from repro_torch.distributed import make_mesh
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer

    t_phase = time.perf_counter()
    spec = base.get("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(spec.config, n_layers=TRAIN_MOE_LAYERS)
    s = spec.cell(TRAIN_CELL).meta["seq"]
    n_moe = TRAIN_MOE_LAYERS - cfg.first_k_dense
    mesh = make_mesh(EP_TRAIN_MESH, EP_AXES, devices)
    cards = list(dict.fromkeys(mesh.devices))
    state, step_fn, data, sched, opt_cfg = train_setup(
        spec, cfg, dev, seed, 911, TRAIN_MOE_STEPS, TRAIN_MOE_BATCH,
        mesh=mesh)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 913)
    gates = ep_layer_gates(cfg, state.params["layers"][1]["moe"], dev, g,
                           devices)
    torch.cuda.empty_cache()
    gate_s = time.perf_counter() - t0
    log(f"[lm-train-moe-ep] layer gates, float32 MoE layer 1 of the cell's "
        f"weights at {EP_GATE_BATCH}x{ROUTER_TRAIN_TOKENS} tokens "
        f"({gate_s:.1f} s): {gates}; {card}")
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    ops.reset_launch_counts()
    state, step_ms, rows, upd_ms = train_loop(
        state, step_fn, data, EP_TRAIN_STEPS, sched, "lm-train-moe-ep")
    counts = ops.launch_counts()
    peaks = [torch.cuda.max_memory_allocated(d) for d in cards]
    tally = [0, 0]
    with torch.no_grad(), drops_counted(tally):
        transformer.forward(cfg, state.params, next(data)["tokens"], mesh)
    ranks = len(moe._ranks(mesh))
    want = ranks * n_moe * 2 * EP_TRAIN_STEPS
    if counts["topk"] != want:
        raise AssertionError(f"[lm-train-moe-ep] topk launched "
                             f"{counts['topk']} times, not {want} ({ranks} "
                             f"ranks x {n_moe} MoE layers x 2 x "
                             f"{EP_TRAIN_STEPS} steps)")
    del state, data
    torch.cuda.empty_cache()
    p50 = statistics.median(step_ms)
    layer = ep_cross_bytes(cfg, mesh, TRAIN_MOE_BATCH, s)
    first = rows[0]["loss"]
    beside = ("[lm-train-moe] not run" if moe_cell is None else
              f"[lm-train-moe]'s {moe_cell['first_loss']:.6f} from the same "
              f"weights and batch with one group (not gated: capacity is "
              f"per rank here, so the drop sets differ)")
    beside_p50 = ("" if moe_cell is None else
                  f" ([lm-train-moe]: {moe_cell['p50']:.3f} ms)")
    log(f"[lm-train-moe-ep] {EP_TRAIN_STEPS} steps of [lm-train-moe]'s cell "
        f"({TRAIN_MOE_BATCH}x{s} tokens, {cfg.dtype} compute, capacity "
        f"factor {cfg.moe.capacity_factor}, {opt_cfg.schedule} lr "
        f"{[r['lr'] for r in rows]}) with lm_loss on the mesh "
        f"{EP_TRAIN_MESH} ({mesh.describe()}): "
        f"{moe_curve(rows, 1 - tally[0] / tally[1])}; first loss {first:.6f} beside {beside}; step "
        f"{step_stats(step_ms)}{beside_p50}; update p50 "
        f"{statistics.median(upd_ms):.3f} ms; topk {counts['topk']} "
        f"launches = {ranks} ranks x {n_moe} MoE layers x 2 (forward and "
        f"recompute) x {EP_TRAIN_STEPS} steps; bytes copied between cards "
        f"a step about {3 * n_moe * layer:,} (3 x {n_moe} MoE layers x "
        f"{layer:,} a layer's forward: the forward, the recompute and "
        f"backward's gradients of the same copies; from the placement and "
        f"the shapes, not measured); peak memory "
        + ", ".join(f"{d} {pk / 1e9:.2f} GB" for d, pk in zip(cards, peaks))
        + f" (max_memory_allocated); {card}")
    log(f"[lm-train-moe-ep] phase {time.perf_counter() - t_phase:.1f} s")
    return counts, first


def examples_train(card: str) -> dict:
    """[examples-train]: ``examples/torch_train_lm.py``'s ``main`` on the
    card for EXAMPLE_TRAIN_STEPS steps (the 100M-parameter LM, batch 8 x
    128).  Fails unless the loss improved and the step-100 checkpoint
    restored equal to the saved state bit for bit.  Returns the launch
    counts."""
    import importlib.util

    from repro_torch.kernels import ops

    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", os.path.join(ROOT, "examples", "torch_train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = mod.main(["--device", "cuda", "--steps",
                    str(EXAMPLE_TRAIN_STEPS)])
    secs = time.perf_counter() - t0
    if not out["improved"]:
        raise AssertionError(f"[examples-train] the loss did not improve: "
                             f"{out}")
    if not (out["restored_equal"]
            and out["restored_step"] == EXAMPLE_TRAIN_STEPS):
        raise AssertionError(f"[examples-train] the step-"
                             f"{EXAMPLE_TRAIN_STEPS} checkpoint did not "
                             f"restore bit for bit: {out}")
    log(f"[examples-train] torch_train_lm on the card, "
        f"{EXAMPLE_TRAIN_STEPS} steps in {secs:.1f} s: loss "
        f"{out['first_loss']:.4f} -> {out['final_loss']:.4f}, "
        f"{out['tokens_per_s']:.1f} tokens/s, the step-"
        f"{out['restored_step']} checkpoint restored bit for bit; {card}")
    return ops.launch_counts()


def train_paths(dev, card: str, seed: int) -> tuple[dict, dict]:
    """[lm-train], [lm-train-moe] and [examples-train]: ({path: launch
    counts}, [lm-train-moe]'s first loss and step p50)."""
    out = {"lm-train": lm_train(dev, card, seed)}
    out["lm-train-moe"], moe_cell = lm_train_moe(dev, card, seed)
    out["examples-train"] = examples_train(card)
    return out, moe_cell


# --------------------------------------------------------------- phase 4c

RECSYS_TAGS = {"dlrm-mlperf": "dlrm", "deepfm": "deepfm", "mind": "mind",
               "bert4rec": "bert4rec"}
# The recsys and GAT cells' optimizer settings (AdamWConfig's defaults
# otherwise) come from the port's launch/cells.py: RECSYS_OPT, GAT_OPT.
# [gnn-gat]'s learning gate: the reference's own learning test's optimizer
# (tests/test_models.py:150-164), 30 steps at full_graph_sm.
GAT_LEARN_OPT = {"lr": 1e-2, "weight_decay": 0.0, "schedule": "const"}
GAT_LEARN_STEPS = 30
ZOO_CPU_RTOL = 1e-4          # card vs CPU at the smoke configs, float32
ZOO_RETR_RTOL = 1e-5         # retrieval vs serve on the same candidates
ZOO_RETR_CHECK = 512         # candidates scored both ways
ZOO_SLATE = 100              # MIND / BERT4Rec serve: cells.py:299-301
ZOO_TRAIN_STEPS = 4
ZOO_SERVE_REPS = 8           # serve_p99 calls timed; serve_bulk and
ZOO_BULK_REPS = 2            # retrieval_cand take 2 each
# Cuts, each printed.  dlrm-mlperf's fused table (187,767,808 x 128
# float32, 96.1 GB) does not fit one card: the five tables above the cap
# keep its rows (the other 21 hold 4,063,992).  Serving holds the table
# beside retrieval_cand's (1M, 26, 128) lookup (13.3 GB) and its
# concatenation; training holds the table, its dense gradient, m, v and
# AdamW's temporaries (about 7 table-sized tensors at the update's peak).
# Each training cut is the largest that ran two steps in
# ``chip_train_probe.py --zoo`` (NVIDIA H100 80GB HBM3, 700 W): a cap of
# 3,500,000 (77.4 GB peak; 4,000,000 out of memory).
DLRM_SERVE_CAP = 16_000_000
DLRM_TRAIN_CAP = 3_500_000
# train_batch (65,536) cut to the largest power of two that fits: MIND's
# in-batch (B, B) logits (65,536 out of memory), BERT4Rec's tied
# (B, 20, 1,000,960) cloze logits (256 out of memory; 128 52.4 GB).
ZOO_TRAIN_BATCH = {"mind": 32768, "bert4rec": 128}
# ogb_products' edges halved once: a step at the published 61,859,140 runs
# out of memory (its (E, 8, 8) messages and their gradients); 30,929,570
# peak at 49.7 GB.
OGB_HALVINGS = 1
BERT4REC_BULK_CHUNK = 8192   # serve_bulk scored in chunks of users


def zoo_fns(arch: str, cfg) -> dict:
    """{"init", "loss", "serve", "retrieval"} of a recsys arch, bound as
    the reference's cells bind them (cells.py:251-276): serve is the
    forward of DLRM / DeepFM and the slate scoring of MIND / BERT4Rec."""
    from repro_torch.models import recsys

    name = RECSYS_TAGS[arch]
    loss = getattr(recsys, f"{name}_loss")
    retr = getattr(recsys, f"{name}_retrieval")
    if arch == "dlrm-mlperf":
        def serve(p, b):
            return recsys.dlrm_forward(cfg, p, b["dense"], b["sparse"])
    elif arch == "deepfm":
        def serve(p, b):
            return recsys.deepfm_forward(cfg, p, b["sparse"])
    else:
        def serve(p, b):
            return retr(cfg, p, b)
    return {"init": getattr(recsys, f"{name}_init"),
            "loss": lambda p, b: loss(cfg, p, b),
            "serve": serve, "retrieval": lambda p, b: retr(cfg, p, b)}


def field_vocabs(arch: str, cfg) -> tuple:
    if arch == "dlrm-mlperf":
        return cfg.vocab_sizes
    if arch == "deepfm":
        return (cfg.vocab_per_field,) * cfg.n_fields
    return (cfg.n_items,)


def zoo_inputs(arch: str, cfg, n: int, g, dev, slate: int = 0) -> dict:
    """Serving inputs of ``n`` users drawn from ``g`` on ``dev``: ids
    uniform below each field's vocabulary (DLRM's dense features normal),
    MIND's histories of a length uniform in (L/2, L], BERT4Rec's
    sequences ending in the mask token; with ``slate``, that many
    candidates shared by the users."""
    import torch

    def ids(v, shape):
        return torch.randint(0, v, shape, generator=g, device=dev)

    if arch in ("dlrm-mlperf", "deepfm"):
        out = {"sparse": torch.stack([ids(v, (n,))
                                      for v in field_vocabs(arch, cfg)], 1)}
        if arch == "dlrm-mlperf":
            out["dense"] = torch.randn((n, cfg.n_dense), generator=g,
                                       device=dev)
        return out
    if arch == "mind":
        lens = ids(cfg.hist_len // 2, (n,)) + cfg.hist_len // 2 + 1
        out = {"hist": ids(cfg.n_items, (n, cfg.hist_len)),
               "hist_mask": torch.arange(cfg.hist_len, device=dev)[None]
               < lens[:, None]}
    else:
        seq = ids(cfg.n_items, (n, cfg.seq_len))
        seq[:, -1] = cfg.mask_token
        out = {"seq": seq, "seq_mask": torch.ones_like(seq, dtype=torch.bool)}
    if slate:
        out["candidates"] = ids(cfg.n_items, (slate,))
    return out


def zoo_train_data(arch: str, cfg, batch: int, seed: int, dev):
    """The ported pipelines (``training/data.py``): DlrmBatches for DLRM
    (and, with no dense features, for DeepFM's 39 fields),
    SeqRecBatches' ``mind_iter`` / ``bert4rec_iter``."""
    from repro_torch.training.data import DlrmBatches, SeqRecBatches

    dev = str(dev)
    if arch == "dlrm-mlperf":
        return iter(DlrmBatches(cfg.vocab_sizes, cfg.n_dense, batch,
                                seed=seed, device=dev))
    if arch == "deepfm":
        return iter(DlrmBatches(field_vocabs(arch, cfg), 0, batch,
                                seed=seed, device=dev))
    if arch == "mind":
        return SeqRecBatches(cfg.n_items, batch, cfg.hist_len, seed=seed,
                             device=dev).mind_iter()
    return SeqRecBatches(cfg.n_items, batch, cfg.seq_len, seed=seed,
                         device=dev).bert4rec_iter(cfg.mask_token)


def loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, gradients in the params' tree) by autograd."""
    import torch

    from repro_torch.training import optimizer as opt_mod

    flat = [p for _, p in opt_mod.flatten(params)]
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, batch)
        it = iter(torch.autograd.grad(loss, flat))
    finally:
        for p in flat:
            p.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            opt_mod.tree_map(lambda _: next(it), params))


def card_vs_cpu(tag: str, loss_fn, params, batch, forwards: dict,
                dev) -> dict:
    """``params`` and ``batch`` (on the CPU) through the loss, every
    gradient and each of ``forwards`` ({name: (fn, inputs)}) once on the
    CPU and once on ``dev``: {what: relative L2 error}; fails past
    ZOO_CPU_RTOL."""
    import torch

    from repro_torch.training import optimizer as opt_mod

    out = {}
    for d in ("cpu", dev):
        p = opt_mod.tree_map(lambda t, d=d: t.to(d).clone(), params)

        def on(b, d=d):
            return {k: v.to(d) for k, v in b.items()}

        loss, _, grads = loss_and_grads(loss_fn, p, on(batch))
        with torch.no_grad():
            fw = {k: fn(p, on(b)).cpu() for k, (fn, b) in forwards.items()}
        out[str(d)] = (loss.cpu(), [g.cpu() for _, g in
                                    opt_mod.flatten(grads)], fw)
    a, b = out[str(dev)], out["cpu"]
    errs = {"loss": rel_l2(a[0], b[0]),
            "gradients (max over tensors)": max(
                rel_l2(x, y) for x, y in zip(a[1], b[1]))}
    errs.update({k: rel_l2(a[2][k], b[2][k]) for k in forwards})
    bad = {k: v for k, v in errs.items() if not v <= ZOO_CPU_RTOL}
    if bad:
        raise AssertionError(f"[{tag}] card vs CPU past {ZOO_CPU_RTOL} "
                             f"relative L2: {bad}")
    log(f"[{tag}] smoke config on the card vs the CPU (the same weights "
        f"from the seed and batches): relative L2 "
        f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (bound "
        f"{ZOO_CPU_RTOL})")
    return errs


def recsys_smoke_check(arch: str, dev, seed: int) -> dict:
    """Gate 1 of a recsys arch: its smoke config's loss, gradients, serve
    and retrieval on the card against the CPU."""
    import torch

    from repro_torch.configs import base

    cfg = base.get(arch).smoke_config
    fns = zoo_fns(arch, cfg)
    params = fns["init"](torch.Generator().manual_seed(seed + 951), cfg,
                         device="cpu")
    g = torch.Generator().manual_seed(seed + 952)
    retr = zoo_inputs(arch, cfg, 1, g, "cpu")
    retr["candidates"] = torch.randint(0, field_vocabs(arch, cfg)[0],
                                       (1024,), generator=g)
    forwards = {"serve": (fns["serve"],
                          zoo_inputs(arch, cfg, 64, g, "cpu", ZOO_SLATE)),
                "retrieval": (fns["retrieval"], retr)}
    train = next(zoo_train_data(arch, cfg, 64, seed + 953, "cpu"))
    return card_vs_cpu(f"recsys-{RECSYS_TAGS[arch]}", fns["loss"], params,
                       train, forwards, dev)


def timed_ms(dev, fn, reps: int) -> tuple[list, object]:
    """``reps`` calls of ``fn`` (:func:`timed_sync`): (ms of each, the
    last result)."""
    ms, out = [], None
    for _ in range(reps):
        out, secs = timed_sync(dev, fn)
        ms.append(secs * 1e3)
    return ms, out


def dlrm_cut(cfg, cap: int):
    """dlrm-mlperf with every table above ``cap`` rows cut to ``cap``:
    (config, the cut as a sentence)."""
    import dataclasses

    cut = dataclasses.replace(cfg, vocab_sizes=tuple(
        min(v, cap) for v in cfg.vocab_sizes))
    n_cut = sum(v > cap for v in cfg.vocab_sizes)
    row = cfg.embed_dim * 4
    return cut, (f"{n_cut} tables above {cap:,} rows cut to it: "
                 f"{cfg.table.total_rows:,} rows ({cfg.table.padded_rows:,} "
                 f"padded, {cfg.table.padded_rows * row / 1e9:.1f} GB) -> "
                 f"{cut.table.total_rows:,} ({cut.table.padded_rows:,}, "
                 f"{cut.table.padded_rows * row / 1e9:.1f} GB)")


def recsys_train_setup(arch: str, dev, seed: int, size: int | None = None):
    """The train_batch cell of ``arch`` as the smoke runs it: float32
    weights from the seed on the card, the recsys cells' optimizer, the
    ported pipeline's batches.  ``size``: DLRM's table cap, or the batch
    of MIND / BERT4Rec (default: the smoke's constants).  Returns (cfg,
    state, step_fn, data, schedule, batch, the cut as a sentence)."""
    from repro_torch.launch import cells
    import torch

    from repro_torch.configs import base
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts_mod

    spec = base.get(arch)
    cfg, b = spec.config, spec.cell("train_batch").meta["batch"]
    cut = "none"
    if arch == "dlrm-mlperf":
        cfg, cut = dlrm_cut(cfg, size or DLRM_TRAIN_CAP)
    elif arch in ZOO_TRAIN_BATCH:
        nb = size or ZOO_TRAIN_BATCH[arch]
        if nb != b:
            cut = f"batch {b:,} -> {nb:,}"
        b = nb
    fns = zoo_fns(arch, cfg)
    g = torch.Generator(device=dev).manual_seed(seed + 961)
    params = fns["init"](g, cfg, device=dev)
    opt_cfg = opt_mod.AdamWConfig(**cells.RECSYS_OPT)
    step_fn = ts_mod.make_train_step(fns["loss"], opt_cfg)
    data = zoo_train_data(arch, cfg, b, seed + 962, dev)
    return (cfg, ts_mod.init_train_state(params), step_fn, data,
            opt_mod.schedule_fn(opt_cfg), b, cut)


def recsys_path(arch: str, dev, card: str, seed: int) -> dict:
    """[recsys-*] one recsys arch: its smoke config on the card against
    the CPU (gate 1), then the published config (dlrm-mlperf's table cut
    to fit, printed) at serve_p99, serve_bulk and retrieval_cand over
    pad_to(1M, 512) candidates, retrieval held to serve on 512 of the same
    candidates scored as a batch (within 1e-5 relative L2), and
    ZOO_TRAIN_STEPS train steps at train_batch (cut to fit where
    printed): loss, grad_norm and lr finite, lr the schedule's.  Returns
    the launch counts (none: no kernel of the port runs here)."""
    from repro_torch.launch import cells
    import torch

    from repro_torch.configs import base
    from repro_torch.kernels import ops

    tag = f"recsys-{RECSYS_TAGS[arch]}"
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    recsys_smoke_check(arch, dev, seed)
    spec = base.get(arch)
    cfg = spec.config
    meta = {c.name: c.meta for c in spec.shapes}
    cut = "none"
    if arch == "dlrm-mlperf":
        cfg, cut = dlrm_cut(cfg, DLRM_SERVE_CAP)
    fns = zoo_fns(arch, cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 971)
    params = fns["init"](g, cfg, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    rows = {}
    with torch.no_grad():
        for cell, reps in (("serve_p99", ZOO_SERVE_REPS),
                           ("serve_bulk", ZOO_BULK_REPS)):
            n = meta[cell]["batch"]
            x = zoo_inputs(arch, cfg, n, g, dev, ZOO_SLATE)
            if arch == "bert4rec" and n > BERT4REC_BULK_CHUNK:
                def call(x=x, n=n):
                    return torch.cat([fns["serve"](params, {
                        k: v if k == "candidates"
                        else v[i:i + BERT4REC_BULK_CHUNK]
                        for k, v in x.items()})
                        for i in range(0, n, BERT4REC_BULK_CHUNK)])
            else:
                def call(x=x):
                    return fns["serve"](params, x)
            ms, out = timed_ms(dev, call, reps)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"[{tag}] {cell}: non-finite scores")
            rows[cell] = (n, ms, tuple(out.shape))
            del x, out
        c = base.pad_to(meta["retrieval_cand"]["n_candidates"], 512)
        user = zoo_inputs(arch, cfg, 1, g, dev)
        user["candidates"] = torch.randint(
            0, field_vocabs(arch, cfg)[0], (c,), generator=g, device=dev)
        ms, scores = timed_ms(dev, lambda: fns["retrieval"](params, user),
                              ZOO_BULK_REPS)
        rows["retrieval_cand"] = (c, ms, tuple(scores.shape))
        sel = torch.randperm(c, generator=g, device=dev)[:ZOO_RETR_CHECK]
        if arch in ("dlrm-mlperf", "deepfm"):
            batch = {k: v.expand(ZOO_RETR_CHECK, -1).clone()
                     for k, v in user.items() if k != "candidates"}
            batch["sparse"][:, 0] = user["candidates"][sel]
            served, want = fns["serve"](params, batch), scores[sel]
        else:
            batch = dict(user, candidates=user["candidates"][sel])
            served, want = fns["serve"](params, batch), scores[:, sel]
        retr_err = rel_l2(served, want)
        del scores, user, batch, served, want
    if not retr_err <= ZOO_RETR_RTOL:
        raise AssertionError(f"[{tag}] retrieval vs serve on "
                             f"{ZOO_RETR_CHECK} candidates: relative L2 "
                             f"{retr_err:.3g} > {ZOO_RETR_RTOL}")
    peak = torch.cuda.max_memory_allocated(dev)
    held = state_bytes(params)
    del params
    torch.cuda.empty_cache()
    served = "; ".join(
        f"{k} {n:,} {'candidates' if k == 'retrieval_cand' else 'rows'} -> "
        f"{shape}: {step_stats(ms)}, {n / (statistics.median(ms) / 1e3):,.0f}"
        f" {'candidates' if k == 'retrieval_cand' else 'examples'}/s"
        for k, (n, ms, shape) in rows.items())
    chunk = (f" (serve_bulk scored in chunks of {BERT4REC_BULK_CHUNK:,} "
             f"users)" if arch == "bert4rec" else "")
    log(f"[{tag}] serving, cut: {cut}; weights {held / 1e9:.2f} GB from the "
        f"seed in {init_s:.1f} s; {served}{chunk}; retrieval vs serve on "
        f"{ZOO_RETR_CHECK} of the same candidates: relative L2 "
        f"{retr_err:.3g} (bound {ZOO_RETR_RTOL}); peak memory "
        f"{peak / 1e9:.2f} GB (max_memory_allocated); {card}")

    torch.cuda.reset_peak_memory_stats(dev)
    tcfg, state, step_fn, data, sched, b, tcut = recsys_train_setup(
        arch, dev, seed)
    held = state_bytes(state)
    state, step_ms, rows_t, upd_ms = train_loop(state, step_fn, data,
                                                ZOO_TRAIN_STEPS, sched, tag)
    peak = torch.cuda.max_memory_allocated(dev)
    del state, data
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    log(f"[{tag}] train_batch, cut: {tcut}; {ZOO_TRAIN_STEPS} steps of {b:,}"
        f" (AdamW lr {cells.RECSYS_OPT['lr']}, weight decay "
        f"{cells.RECSYS_OPT['weight_decay']}, cells.py:311): losses "
        f"{[round(r['loss'], 4) for r in rows_t]}, grad_norm "
        f"{[round(r['grad_norm'], 4) for r in rows_t]}, lr "
        f"{[r['lr'] for r in rows_t]} (each schedule_fn's); step "
        f"{step_stats(step_ms)}, "
        f"{b / (statistics.median(step_ms) / 1e3):,.0f} examples/s at p50; "
        f"update p50 {statistics.median(upd_ms):.3f} ms; state "
        f"{held / 1e9:.2f} GB (weights and moments); peak memory "
        f"{peak / 1e9:.2f} GB; {card}")
    log(f"[{tag}] kernel launches on the path: "
        f"{ {k: v for k, v in counts.items() if v} } (none: the recsys "
        f"models run no kernel of the port); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def node_graph(meta: dict, seed: int) -> tuple[dict, float]:
    """A node-level cell's graph at its published size, padded as
    cells.py:183-184 pads it (nodes and edges to multiples of 512; the
    padded nodes unlabelled and out of the mask, the padded edges at the
    ghost row): ``random_graph_data``'s homophilous graph as numpy arrays
    on the host.  Returns (batch, host seconds)."""
    import numpy as np

    from repro_torch.configs import base
    from repro_torch.models import gnn
    from repro_torch.training.data import random_graph_data

    t0 = time.perf_counter()
    n, e = meta["n_nodes"], meta["n_edges"]
    n_pad, e_pad = base.pad_to(n, 512), base.pad_to(e, 512)
    feats, ei, labels, mask = random_graph_data(n, e, meta["d_feat"],
                                                meta["n_classes"], seed=seed)
    batch = {
        "features": np.concatenate(
            [feats, np.zeros((n_pad - n, feats.shape[1]), np.float32)]),
        "edge_index": gnn.pad_edges(ei[0], ei[1], e_pad, n_pad),
        "labels": np.concatenate([labels, np.zeros(n_pad - n, np.int32)]),
        "mask": np.concatenate([mask, np.zeros(n_pad - n, bool)])}
    return batch, time.perf_counter() - t0


def on_device(batch: dict, dev) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def gat_train(cfg, loss_fn, dev, seed: int, opt: dict):
    """Float32 GAT weights from the seed on ``dev``, ``make_train_step``
    at ``opt``: (state, step_fn, schedule)."""
    import torch

    from repro_torch.models import gnn
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts_mod

    g = torch.Generator(device=dev).manual_seed(seed)
    params = gnn.gat_init(g, cfg, device=dev)
    opt_cfg = opt_mod.AdamWConfig(**opt)
    return (ts_mod.init_train_state(params),
            ts_mod.make_train_step(lambda p, b: loss_fn(cfg, p, b), opt_cfg),
            opt_mod.schedule_fn(opt_cfg))


def gat_steps(tag: str, cfg, loss_fn, batch, dev, seed: int, opt: dict,
              steps: int):
    """``steps`` train steps on one batch (train_loop's gates): (rows,
    step ms, update ms, peak bytes, state bytes)."""
    import itertools

    import torch

    torch.cuda.reset_peak_memory_stats(dev)
    state, step_fn, sched = gat_train(cfg, loss_fn, dev, seed, opt)
    held = state_bytes(state)
    state, ms, rows, upd = train_loop(state, step_fn,
                                      itertools.repeat(batch), steps, sched,
                                      tag)
    del state
    return rows, ms, upd, torch.cuda.max_memory_allocated(dev), held


def gat_line(rows, ms, upd, peak, held, unit: float, what: str) -> str:
    return (f"losses {[round(r['loss'], 4) for r in rows]}, acc "
            f"{[round(r['acc'], 4) for r in rows]}, grad_norm "
            f"{[round(r['grad_norm'], 4) for r in rows]}, lr "
            f"{[r['lr'] for r in rows]}; step {step_stats(ms)}, "
            f"{unit / (statistics.median(ms) / 1e3):,.0f} {what}/s at p50; "
            f"update p50 {statistics.median(upd):.3f} ms; state "
            f"{held / 1e6:.2f} MB; peak memory {peak / 1e9:.2f} GB")


def ogb_graph(seed: int, halvings: int):
    """ogb_products' graph with its edges halved ``halvings`` times, on
    the host: (batch, host seconds, edges kept)."""
    from repro_torch.configs import base

    meta = dict(base.get("gat-cora").cell("ogb_products").meta)
    meta["n_edges"] //= 2 ** halvings
    batch, host_s = node_graph(meta, seed)
    return batch, host_s, meta["n_edges"]


def minibatch_block(sampler, meta: dict, feats, labels, rng, dev):
    """One minibatch_lg block: ``batch_nodes`` seeds sampled at the
    cell's fanout, padded to its static node and edge counts (the seeds
    alone in the mask).  Returns (batch on ``dev``, host ms of the
    sampling)."""
    import numpy as np
    import torch

    from repro_torch.models import gnn

    t0 = time.perf_counter()
    seeds = rng.choice(meta["full_graph_nodes"], meta["batch_nodes"],
                       replace=False)
    nodes, es, ed = sampler.sample_block(seeds, meta["fanout"])
    host_ms = (time.perf_counter() - t0) * 1e3
    n_pad = meta["n_nodes"]
    x = np.zeros((n_pad, feats.shape[1]), np.float32)
    x[:len(nodes)] = feats[nodes]
    y = np.zeros(n_pad, np.int32)
    y[:len(nodes)] = labels[nodes]
    mask = np.zeros(n_pad, bool)
    mask[:len(seeds)] = True
    batch = {"features": x, "labels": y, "mask": mask,
             "edge_index": gnn.pad_edges(es, ed, meta["n_edges"], n_pad)}
    return ({k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            host_ms, len(nodes), len(es))


def molecule_batch(meta: dict, g, dev):
    """The molecule cell: ``batch_graphs`` graphs of ``n_nodes`` nodes and
    ``n_edges`` random intra-graph edges each, block-diagonal, padded as
    cells.py:177-178 pads (the padded nodes' graph id G, outside [0, G),
    so the pooling drops them)."""
    import torch

    from repro_torch.configs import base

    gs, n, e = meta["batch_graphs"], meta["n_nodes"], meta["n_edges"]
    n_pad, e_pad = base.pad_to(n * gs, 512), base.pad_to(e * gs, 512)
    off = torch.arange(gs, device=dev).repeat_interleave(e) * n
    src = torch.randint(0, n, (gs * e,), generator=g, device=dev) + off
    dst = torch.randint(0, n, (gs * e,), generator=g, device=dev) + off
    ei = torch.full((2, e_pad), n_pad, dtype=torch.int32, device=dev)
    ei[0, :gs * e], ei[1, :gs * e] = src, dst
    gid = torch.full((n_pad,), gs, dtype=torch.int32, device=dev)
    gid[:gs * n] = torch.arange(gs, device=dev).repeat_interleave(n)
    return {"features": torch.randn((n_pad, meta["d_feat"]), generator=g,
                                    device=dev),
            "edge_index": ei, "graph_ids": gid,
            "labels": torch.randint(0, meta["n_classes"], (gs,),
                                    generator=g, device=dev)}


def reddit_graph(meta: dict, seed: int):
    """minibatch_lg's graph on the host (``random_graph_data`` at the
    cell's full-graph size) and its ``NeighborSampler``: (features,
    labels, sampler, seconds)."""
    from repro_torch.models import gnn
    from repro_torch.training.data import random_graph_data

    t0 = time.perf_counter()
    feats, ei, labels, _ = random_graph_data(
        meta["full_graph_nodes"], meta["full_graph_edges"], meta["d_feat"],
        meta["n_classes"], seed=seed)
    sampler = gnn.NeighborSampler(ei, meta["full_graph_nodes"], seed=seed)
    return feats, labels, sampler, time.perf_counter() - t0


def gnn_host_graphs(pool, seed: int) -> dict:
    """Submit [gnn-gat]'s two large host graphs to ``pool`` (ogb_products'
    and minibatch_lg's: about a minute of numpy, most of it outside the
    GIL, which the earlier phases hide): {cell: future}."""
    from repro_torch.configs import base

    meta = base.get("gat-cora").cell("minibatch_lg").meta
    return {"ogb_products": pool.submit(ogb_graph, seed, OGB_HALVINGS),
            "minibatch_lg": pool.submit(reddit_graph, meta, seed)}


def gnn_path(dev, card: str, seed: int, graphs: dict) -> dict:
    """[gnn-gat]: gat-cora's four regimes.  Gate 1: the smoke config's
    node and graph losses and gradients on the card against the CPU.
    full_graph_sm at Cora's published size (padded as cells.py pads)
    trains GAT_LEARN_STEPS steps of the reference's learning test's
    optimizer and must end below 0.7 of its first loss with accuracy above
    0.5; ogb_products (edges halved OGB_HALVINGS times, printed),
    minibatch_lg (a Reddit-sized synthetic graph on the
    host, 1,024 seeds sampled at fanout (15, 10) into padded blocks; the
    sampler's host ms a block beside the step's) and molecule train
    ZOO_TRAIN_STEPS steps at the GAT cells' optimizer (train_loop's
    gates).  ``graphs``: :func:`gnn_host_graphs`' futures.  Returns the
    launch counts (none)."""
    from repro_torch.launch import cells
    import numpy as np
    import torch

    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.models import gnn

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    spec = base.get("gat-cora")
    meta = {c.name: c.meta for c in spec.shapes}
    # Gate 1 at the smoke config: a small Cora-like graph with padded
    # edges, and a molecule batch.
    small = dict(meta["full_graph_sm"], n_nodes=300, n_edges=2000, d_feat=16)
    g = torch.Generator().manual_seed(seed + 981)
    for name, b, m in (("gat_loss", on_device(node_graph(small, seed)[0],
                                              "cpu"), small),
                       ("gat_graph_loss", molecule_batch(
                           dict(meta["molecule"], batch_graphs=8), g, "cpu"),
                        meta["molecule"])):
        cfg = spec.smoke_config.for_regime(m["d_feat"], m["n_classes"])
        params = gnn.gat_init(torch.Generator().manual_seed(seed + 982), cfg,
                              device="cpu")
        fn = getattr(gnn, name)
        logits = (lambda p, bb, cfg=cfg: gnn.gat_forward(
            cfg, p, bb["features"], bb["edge_index"]), b)
        card_vs_cpu(f"gnn-gat {name}", lambda p, bb, fn=fn, cfg=cfg:
                    fn(cfg, p, bb), params, b, {"logits": logits}, dev)

    # full_graph_sm: the learning gate.
    m = meta["full_graph_sm"]
    cfg = spec.config.for_regime(m["d_feat"], m["n_classes"])
    batch, host_s = node_graph(m, seed)
    batch = on_device(batch, dev)
    rows, ms, upd, peak, held = gat_steps(
        "gnn-gat", cfg, gnn.gat_loss, batch, dev, seed + 983, GAT_LEARN_OPT,
        GAT_LEARN_STEPS)
    first, last, acc = rows[0]["loss"], rows[-1]["loss"], rows[-1]["acc"]
    if not (last < 0.7 * first and acc > 0.5):
        raise AssertionError(f"[gnn-gat] full_graph_sm did not learn: loss "
                             f"{first:.4f} -> {last:.4f}, accuracy {acc:.4f}")
    n_nodes, n_edges = batch["features"].shape[0], batch["edge_index"].shape[1]
    del batch
    log(f"[gnn-gat] full_graph_sm at Cora's size ({m['n_nodes']:,} nodes, "
        f"{m['n_edges']:,} edges, {m['d_feat']} features, {m['n_classes']} "
        f"classes; padded to {n_nodes:,} / {n_edges:,}; graph {host_s:.1f} s "
        f"on the host), {GAT_LEARN_STEPS} steps at {GAT_LEARN_OPT} (the "
        f"reference's learning test): loss {first:.4f} -> {last:.4f} (< 0.7 "
        f"x first), accuracy {acc:.4f} (> 0.5); "
        f"{gat_line(rows[-4:], ms, upd, peak, held, m['n_nodes'], 'nodes')};"
        f" {card}")

    # ogb_products, its edges halved OGB_HALVINGS times.
    m = meta["ogb_products"]
    cfg = spec.config.for_regime(m["d_feat"], m["n_classes"])
    batch, host_s, kept = graphs["ogb_products"].result()
    batch = on_device(batch, dev)
    rows, ms, upd, peak, held = gat_steps(
        "gnn-gat", cfg, gnn.gat_loss, batch, dev, seed + 984, cells.GAT_OPT,
        ZOO_TRAIN_STEPS)
    cut = ("none" if kept == m["n_edges"] else
           f"edges {m['n_edges']:,} -> {kept:,} (a step at the published "
           f"size runs out of memory)")
    del batch
    torch.cuda.empty_cache()
    log(f"[gnn-gat] ogb_products, cut: {cut}; {m['n_nodes']:,} nodes, "
        f"{kept:,} edges (padded to multiples of 512), {m['d_feat']} "
        f"features, {m['n_classes']} classes (graph {host_s:.1f} s on a "
        f"host thread), {ZOO_TRAIN_STEPS} steps at {cells.GAT_OPT} "
        f"(cells.py:191): "
        f"{gat_line(rows, ms, upd, peak, held, m['n_nodes'], 'nodes')}; "
        f"{card}")

    # minibatch_lg: sampled blocks of a Reddit-sized graph held on the host.
    m = meta["minibatch_lg"]
    t0 = time.perf_counter()
    feats, labels, sampler, graph_s = graphs["minibatch_lg"].result()
    waited = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 985)
    cfg = spec.config.for_regime(m["d_feat"], m["n_classes"])
    torch.cuda.reset_peak_memory_stats(dev)
    state, step_fn, sched = gat_train(cfg, gnn.gat_loss, dev, seed + 986,
                                      cells.GAT_OPT)
    held = state_bytes(state)
    host, sizes, blocks = [], [], []
    for _ in range(ZOO_TRAIN_STEPS):
        b, h_ms, nn_, ne = minibatch_block(sampler, m, feats, labels, rng,
                                           dev)
        blocks.append(b)
        host.append(h_ms)
        sizes.append((nn_, ne))
    state, ms, rows, upd = train_loop(state, step_fn, iter(blocks),
                                      ZOO_TRAIN_STEPS, sched, "gnn-gat")
    peak = torch.cuda.max_memory_allocated(dev)
    del state, blocks, feats, labels, sampler
    log(f"[gnn-gat] minibatch_lg: a Reddit-sized graph on the host "
        f"({m['full_graph_nodes']:,} nodes, {m['full_graph_edges']:,} edges,"
        f" {m['d_feat']} features; generated and indexed in {graph_s:.1f} s "
        f"on a host thread beside the earlier phases, {waited:.1f} s of it "
        f"waited for here)"
        f", {m['batch_nodes']:,} seeds a block at fanout {m['fanout']} "
        f"(nodes, edges: {sizes}; padded to {m['n_nodes']:,} / "
        f"{m['n_edges']:,}); sampler host ms a block "
        f"{[round(x, 1) for x in host]} beside the device step's "
        f"{[round(x, 1) for x in ms]} ms; "
        f"{gat_line(rows, ms, upd, peak, held, m['batch_nodes'], 'seeds')};"
        f" {card}")

    m = meta["molecule"]
    cfg = spec.config.for_regime(m["d_feat"], m["n_classes"])
    g = torch.Generator(device=dev).manual_seed(seed + 987)
    batch = molecule_batch(m, g, dev)
    rows, ms, upd, peak, held = gat_steps(
        "gnn-gat", cfg, gnn.gat_graph_loss, batch, dev, seed + 988,
        cells.GAT_OPT, ZOO_TRAIN_STEPS)
    log(f"[gnn-gat] molecule: {m['batch_graphs']} graphs of {m['n_nodes']} "
        f"nodes and {m['n_edges']} edges (padded to "
        f"{batch['features'].shape[0]:,} / "
        f"{batch['edge_index'].shape[1]:,}), {ZOO_TRAIN_STEPS} steps at "
        f"{cells.GAT_OPT}: "
        f"{gat_line(rows, ms, upd, peak, held, m['batch_graphs'], 'graphs')}"
        f"; {card}")
    del batch
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    log(f"[gnn-gat] kernel launches on the path: "
        f"{ {k: v for k, v in counts.items() if v} } (none: the GAT runs no "
        f"kernel of the port); phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def zoo_paths(dev, card: str, seed: int, graphs: dict | None = None) -> dict:
    """[recsys-*] and [gnn-gat]: {path: launch counts}.  ``graphs``:
    :func:`gnn_host_graphs`' futures, submitted here when None."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        if graphs is None:
            graphs = gnn_host_graphs(pool, seed)
        out = {f"recsys-{RECSYS_TAGS[a]}": recsys_path(a, dev, card, seed)
               for a in RECSYS_TAGS}
        out["gnn-gat"] = gnn_path(dev, card, seed, graphs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="base points of the main path (1M = SIFT1M; "
                         "a smaller N is printed as a cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-first-batch", action="store_true",
                    help="profile the first batch of the tiered adaptive "
                         "pipelined run into chiprun_out/")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
    spent: dict = {}
    last = [t_start]

    def mark(phase: str) -> None:
        """Charge the time since the last mark to ``phase``."""
        now = time.perf_counter()
        spent[phase] = spent.get(phase, 0.0) + now - last[0]
        last[0] = now

    dev = torch.device("cuda", 0)
    card = gpu_name_power()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {torch.cuda.get_device_capability(dev)}")
    t0 = time.perf_counter()
    _build.build_all(ops.LIBRARIES)
    for lib in ops.LIBRARIES:
        lib.fn()
    log(f"[build] {len(ops.LIBRARIES)} kernel libraries built and loaded in "
        f"{time.perf_counter() - t0:.1f}s")
    for lib in ops.LIBRARIES:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas {lib.name}: {line.strip()}")
    mark("build")

    cfg = sift1m()
    kernels = [check_kernel(kind, dev, KERNEL_N, KERNEL_Q, cfg.l_search,
                            cfg.degree, 12, args.seed + 7 * i)
               for i, kind in enumerate(("exact", "pq"))]
    torch.cuda.empty_cache()
    kernels.append(check_hop_rows(dev, KERNEL_N, KERNEL_Q, cfg.l_search,
                                  cfg.degree, 12, args.seed + 3))
    torch.cuda.empty_cache()
    kernels += check_bulk_kernels(dev, args.seed)
    torch.cuda.empty_cache()
    kernels.append(check_pq_scan(dev, args.seed))
    torch.cuda.empty_cache()
    kernels.append(check_decode_attention(dev, args.seed))
    torch.cuda.empty_cache()
    mark("phase2")

    paths = {}
    paths["main"], world = main_path(dev, args.n, N_QUERIES, SERVE_BATCH,
                                     BUILD_BATCH, args.seed,
                                     trace=args.trace_first_batch)
    mark("main")
    paths["calibration"] = calibration_path(world)
    mark("calibration")
    paths["adc"] = adc_path(world)
    mark("adc")
    # The world is built: move it out of the collector's sight, so that a
    # full collection under [door]'s load scans only what the runs make.
    gc.collect()
    gc.freeze()
    log(f"[door] gc.freeze(): {gc.get_freeze_count():,} objects moved to "
        f"the permanent generation before the door's runs")
    paths["door"] = door_path(world, card, args.seed)
    mark("door")
    tmp = tempfile.mkdtemp(prefix="mcgi-disk-")
    try:
        paths["disk"], stores = disk_path(world, tmp)
        mark("disk")
        paths["ooc"] = ooc_path(world, stores, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("ooc")
    tmp = tempfile.mkdtemp(prefix="mcgi-live-")
    try:
        rows = min(LIVE_ROWS, args.n)
        cut = min(LIVE_INSERTS, rows // 100)
        paths["live"] = live_path(world, tmp, card, args.seed, rows=rows,
                                  inserts=cut, deletes=cut)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    mark("live")
    paths["dist"] = dist_path(world, card, args.seed)
    mark("dist")
    paths["base"] = base_path(world, card, args.seed)
    mark("base")
    # Back in the collector's sight: cycles in the world (and the card
    # memory they hold) must be freed before the LM phases.
    gc.unfreeze()
    del world
    torch.cuda.empty_cache()
    paths["metric"] = metric_path(dev, args.seed, card)
    torch.cuda.empty_cache()
    mark("metric")
    paths["examples"] = examples_path()
    torch.cuda.empty_cache()
    mark("examples")
    lm_counts, attn_err = lm_paths(dev, args.seed)
    paths.update(lm_counts)
    mark("lm")
    with ThreadPoolExecutor(max_workers=1) as pool:
        # [gnn-gat]'s host graphs, made beside the training phases.
        graphs = gnn_host_graphs(pool, args.seed)
        counts, moe_cell = train_paths(dev, card, args.seed)
        paths.update(counts)
        mark("train")
        paths["lm-train-moe-ep"], _ = lm_train_moe_ep(dev, card, args.seed,
                                                      moe_cell)
        torch.cuda.empty_cache()
        mark("train-moe-ep")
        paths.update(zoo_paths(dev, card, args.seed, graphs))
    mark("zoo")
    for rec in kernels:
        if rec["name"] == "decode_attention":
            rec["max_abs_err"] = max(rec["max_abs_err"], attn_err)
    # Each kernel's launches are read on the path that runs it.
    home = {"pq_scan": "adc", "decode_attention": "lm-serve",
            "beam_step.pq_rows": "ooc"}
    for rec in kernels:
        rec["launches"] = paths[home.get(rec["name"], "main")][rec["name"]]
        rec["path_launches"] = {p: c[rec["name"]] for p, c in paths.items()}
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} was never launched on its "
                                 f"path")
    mark("checks")
    log("[budget] " + ", ".join(f"{k} {v:.1f}" for k, v in spent.items())
        + f" s; sum {sum(spent.values()):.1f} s of the {SMOKE_LIMIT_S:,} s "
        f"limit (ceiling {SMOKE_CEILING_S} s, a quarter of the limit kept "
        f"for host-paced phases; {card})")
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}s "
        f"(kernel build included)")
    log("kernels: " + json.dumps({r["name"]: {
        "launches": r["launches"], "path_launches": r["path_launches"],
        "phase2": r["verdict"]} for r in kernels}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
