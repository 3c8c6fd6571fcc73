"""Drive the PyTorch/CUDA port of DDSL end to end on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times SRC

Prints one JSON object per line, in phases, each with ``t_s``, the seconds
since the script started (all but the last line):

1. ``build``   — compiles ``src/repro_torch/kernels/csrc/*.cu`` (sm_90a).
2. ``kernel_check`` — each kernel against its plain PyTorch version at the
   main path's shapes and at edge cases (exact equality: the data are
   integers), with median times over CUDA events. ``member_probe`` also
   at tables on both sides of its shared-memory limit and of a fence
   stride, with n % 4 != 0 and misaligned query views, each twice
   (bitwise repeatable); its main-path shapes one call at a time and 20 in
   a row, beside ``torch.isin`` on packed keys. ``set_intersect`` on each
   of its paths (a warp a row; a block a row with ``b`` in shared memory,
   ``wide``; past the block's limit in global memory, ``past_shared``) and
   on rows in and out of the layout it searches: widths not a multiple of
   4 and misaligned views, a pad amid the values, pad = 7, INT32_MIN /
   INT32_MAX values, all-pad rows, mixed rows in one launch; each launched
   twice (bitwise equal); ``ccjoin`` and ``zcommon`` one call at a time
   and 20 in a row, beside ``torch.isin`` on row-packed keys computing the
   same function.
3. ``stage1`` / ``batch`` — the main path with the kernels, as the
   streaming service's sharded backend runs it: q1_square on the WT~ graph
   (rmat_graph(12, 10_000, seed=1)) over m = 8 partitions, stage 1 (with
   the cold fill of the unit-table carry) then three 64 + 64 edge batches,
   each a storage update and one carried maintain megastep; time, count
   (each equal to ``WT_COUNTS``), ``unit_refreshes``, overflow and peak
   device memory of each stage. ``profile``: one more batch under
   ``torch.profiler``, with the device seconds of ``member_probe`` and
   ``set_intersect`` summed over their kernels (``named_kernels``) and the
   mean fill of ``set_intersect``'s rows (``set_intersect_fill``); then
   ``ccjoin_fill``, the CC-join's shape at that fill, timed.
   ``small_batches``: three batches of 1 + 1 edges on the same pipeline,
   with the partitions each refreshed out of 8 and their seconds.
   ``storage_full``: the next 64 + 64 batch through the full-gather
   storage update and through the delta update from one state; partitions
   and ``part_dirty`` must be equal; each mode's seconds and peak.
4. ``audit`` — stage 1 listed again from scratch on the final partitions;
   its count and store must equal the maintained ones.
5. ``plain``   — the same path with ``use_kernels=False`` on the card,
   replaying the profiled batch and the first small batch; the counts and the
   MatchStore tensors must equal the kernel run's.
6. ``multi`` — q1_square and q2_triangle maintained by one megastep on
   WT~ (``run.WT_MULTI``), stage 1 and three batches with the kernels; the
   q1_square store must equal the single-pattern run's at every stage, and
   ``multi_audit`` lists each pattern from scratch on the final partitions
   (count and store equal to the maintained ones).
6b. ``mesh`` — the service on a ``torch.distributed`` mesh: a process
   group of world size 1 on NCCL started in the script (two NCCL ranks
   cannot share one card), ``ListingService(backend="sharded",
   mesh=ProcessMesh(8))`` over WT~ / q1_square (``run.WT_Q1``'s caps, the
   seeds of ``service``), stage 1 and one 64 + 64 update committed as
   two 64-op batches (``MESH_UPDATES``), against the same service on the
   backend's own ``LocalMesh`` run first: counts ``WT_COUNTS`` /
   ``SERVICE_DELETE_COUNTS`` at every watermark, overflow and host bytes 0,
   every store snapshot
   equal, each batch's NCCL calls and bytes by kind (``all_gather``,
   ``all_reduce``), the ranks' agreement checks, seconds and peak of
   both runs; the batches' launches are ``launches_by_path["mesh"]``.
   Then the collectives of ``repro_torch.dist`` (bucketed and routed
   exchange at a capacity that holds every row and one that overflows, the
   ring and the compressed butterfly) at world 1 on NCCL, equal to the same
   functions on a ``LocalMesh(1)``.
7. ``reference`` — the example graph of examples/distributed_listing.py,
   whose host-engine counts are known, checked on the card.
8. The generic-join (WCOJ) executor. ``wcoj_plan`` / ``wcoj``:
   q6_clique5 and q4_clique4 on WT~ at m = 8 (``run.WT_CLIQUE``,
   ``executor="auto"``, which picks the generic join for both, with level
   caps calibrated on the host partitions), stage 1 and three 64 + 64
   batches with the kernels, each stage's counts ``WT_K5_COUNTS`` /
   ``WT_K4_COUNTS``, overflow 0, ``unit_refreshes`` 0, seconds and peak;
   ``member_probe`` and ``set_intersect`` launches on this path.
   ``wcoj_profile``: the next batch (seed 103) under ``torch.profiler``.
   ``wcoj_audit``: both patterns listed from scratch on the final
   partitions, count and store equal to the maintained ones.
   ``wcoj_plain``: the same stages and the profiled batch with
   ``use_kernels=False``, stores equal at every stage; its last batch hands
   the widest level probe (16,384 x 512 queries against one partition's
   edge table) to ``kernel_check`` (``member_probe`` case ``wcoj_level``).
   ``multi_auto``: ``run.WT_MULTI_AUTO``, q1_square on its join tree and
   q2_triangle on the generic join in one megastep, stage 1 and three
   batches: the q1_square store equal to the single run's, the q2_triangle
   counts equal to ``WT_Q2_COUNTS`` and to the tree executor's in
   ``multi``. ``wcoj_vs_tree``: K5 and K4 on the planted near-clique graph
   (m = 1) listed from scratch under each executor, both lossless (the
   tree's match_cap grown 4x from 8,192 and its store groups 2x until
   nothing drops), counts ``PLANTED_COUNTS``, steady-state seconds (median
   of 3 after a warm-up) and their ratio, not gated. Each executor's
   first list + init is a counted run (launches set to 0 just before it
   and read just after: ``planted_k5_wcoj`` ... ``planted_k4_tree`` in
   ``launches_by_path``; ``member_probe`` must launch), and its widest
   edge-table probe goes to ``kernel_check`` (``member_probe`` cases
   ``planted_wcoj`` and ``planted_tree``, 32,768 x 72 queries against the
   24,768-row table).
   ``backend``: the streaming service's device backend,
   ``repro_torch.backend.TorchBackend``, over ``multi_auto``'s deployment
   (WT~, m = 8, WT_Q1's caps, ``executor="auto"``, the kernels on):
   q1_square and q2_triangle registered (tree and generic join), then three
   64 + 64 batches, each wrapped in the service's ``SharedDelta``; counts
   ``WT_COUNTS`` / ``WT_Q2_COUNTS``, overflow, store resizes and cap
   fallbacks 0, host bytes 0, stores and candidate counters equal to
   ``multi_auto``'s at every stage; each stage's seconds and peak; the
   batches' launches are ``launches_by_path["backend"]``.
   ``backend_materialize``: both match sets pulled (valid prefix only),
   seconds and bytes; q2_triangle's rows equal the host generic join's,
   q1_square's row count its maintained count. ``backend_restore``:
   q2_triangle removed and restored from its table, q1_square removed and
   installed with its own plan and table (its carry reused), then the
   batch with seed 103 (``WT_COUNTS[4]`` / ``WT_Q2_COUNTS[4]``).
   ``backend_resize``: on the example graph, one reported store overflow
   rebuilds the stores with doubled caps and retries the batch
   (``store_resizes`` 1, counts ``EXAMPLE_COUNTS``); a strict backend
   raises before it commits, its partitions unchanged, and replays.
   ``service``: the port's streaming front door,
   ``repro_torch.stream.ListingService(graph, backend="sharded")``, over
   the same deployment (a ``TorchBackend`` built by the service), q1_square
   and q2_triangle registered through it, a ``BatchScheduler(min_ops=64,
   max_ops=64)``, a ``CountDeltaSink``, spans on. The three 64 + 64 updates
   of ``backend`` are ingested into the journal and one ``advance()``
   commits them as six batches (64 deletions, then 64 insertions): counts
   ``WT_COUNTS`` / ``WT_Q2_COUNTS`` at watermarks 128, 256, 384 and
   ``SERVICE_DELETE_COUNTS`` at 64, 192, 320, 64 ops, overflow and host
   bytes 0 in every ``BatchMetrics``, the sink's deltas adding up to the
   final counts. Per batch: latency, ``apply_batch``, the storage update's
   and the megastep's seconds, the service's own host seconds, the
   prediction, drift and peak; the batches' launches are
   ``launches_by_path["service"]``. The ``profile`` line: the service's
   own step profiler (``repro_torch.obs.StepProfiler``, CUDA events), per
   step its warm-ups and their seconds, its steady calls, seconds and
   median, memory (argument, output and alias bytes) and cost shares; the
   steps must be the seven the deployment wraps, the megastep and storage
   update booked 6 times each, the registry counters equal to the
   records, the megastep's seconds within 5 % of its spans and its alias
   bytes at least q1_square's store; with the warm-up cost (the first
   call less the steady median). Then ``svc.audit()``: the host
   ``DDSL`` at m = 4 on the committed graph, timed. ``service_small``: the
   service on the example graph with ``audit_every=1`` and a
   ``MatchDeltaSink`` on both patterns (materialize and removed rows on the
   card): counts ``EXAMPLE_COUNTS`` at each update's watermark, each
   batch's row deltas giving its rows, a snapshot after the second update
   restored with ``backend="sharded"`` and ``backend="host"`` (each takes
   the third update to ``EXAMPLE_COUNTS``), and a manual
   ``PlanManager.reoptimize`` leaving the counts as they were; its
   ``capture`` line: the profiler's ``torch.profiler`` window armed on the
   second batch wrote exactly one Chrome trace, holding kernel events of
   ``member_probe`` and ``set_intersect``. ``rebalance``: the example
   graph's NP storage at m = 8 rebalanced (half the centers of the
   partition storing the most edges moved to the one storing the fewest,
   ``repro_torch.dist``) and re-cut at m = 4, q1_square and q2_triangle
   listed on each with the kernels: counts ``EXAMPLE_COUNTS[...][0]``,
   equal to the unrebalanced storage's and the host ``DDSL``'s under the
   rebalanced partition function; ``repartition_delta`` and the launches
   (``launches_by_path["rebalance"]``); the widest edge probe and CC-join
   of those listings, captured as they ran, against the plain versions
   (``member_probe`` and ``set_intersect`` cases ``rebalance``).
9. ``kernel_check`` (``segment_sum``) — the segment-sum kernel against its
   plain version on their float64 accumulators, each case through its
   segment plan: one gatedgcn edge slice ([2**24, 70] bf16, ids over
   2,449,029 nodes with 1 % set to n and 0.5 % to -1), the same rows with
   ids sorted over one slice's 332,108 nodes as the forward feeds them,
   and with half of them in one id (``heavy_segment``), the meshgraphnet
   and graphsage widths, EquiformerV2's molecule message block ([16,384,
   6,272] float32, ``eqv2_messages``) and softmax denominators ([16,384,
   8], ``eqv2_den``) over 3,840 sorted ids, a ones column (exact), and edge
   cases; max
   |kernel - plain| <= 1e-5 * max(1, max |plain|), with the kernel's, the
   plan build's, the plain version's and ``index_add_``'s median ms beside
   the byte bound (data and ids once, the touched float32 rows once);
   under 1 ms also over 20 calls in a row, the card's time alone.
10. ``gnn_plan`` / ``gnn_forward`` — GNN full-graph inference: gatedgcn at
   its full config (16 layers, d_hidden 70, bf16, d_in 100) on the
   ``ogb_products`` shape (2,449,029 nodes, 123,718,280 directed edges,
   ``build_graph_data`` seed 0), once with the kernels (every segment sum
   through the CUDA kernel: 16 layers x 2 sums x 8 edge slices launches)
   and once plain; outputs finite. ``gnn_plan`` also times the forward's
   first step alone: the edge list sorted by destination and its 8 plans
   built (``gnn.sort_edges``), seconds and peak. ``gnn_profile``: one more
   kernel forward under ``torch.profiler``. ``gnn_equal``: max |kernel -
   plain| <= 3e-2 * max |plain|, the share of equal outputs, and the
   largest difference between the two kernel forwards (0: no atomics).
11. ``gnn_small`` — graphsage-reddit (float32, limit 1e-4 * max |plain|)
   and meshgraphnet (bf16, 3e-2) at their full configs on
   ``full_graph_sm`` (2,708 nodes, 21,112 directed edges, d_feat 1,433),
   kernel against plain, after one warm-up forward.
12. ``eqv2_plan`` / ``eqv2_serve`` — equiformer-v2 inference at its full
   config (12 layers, d_hidden 128, l_max 6, m_max 2, 8 heads, bf16; the
   rotations, SO(2) products, attention and messages in float32, TF32 off)
   through ``gnn.forward``: four ``molecule`` requests (3,840 nodes, 16,384
   directed edges, d_feat 16, ``build_graph_data`` seeds 0-3, positions
   synthesized) and one ``full_graph_sm`` request, each once with the
   kernels and once plain after one warm-up forward of its shape. Per
   request: seconds, peak, finite output, ``segment_sum`` launches (12 x (1
   + chunks) = 24; plain 0; no other kernel), the JAX package's model FLOP
   (``launch.steps.gnn_flops``), the FLOP the forward executes over the
   seconds, and the float32 bound: the FLOP the function needs (the
   block-diagonal rotations counted by degree) / 67 TFLOP/s, with the
   executed FLOP's (dense rotations) beside it.
   ``eqv2_chunked``: molecule seed 0 at ``edge_chunk`` 4,096 (4 chunks, 60
   launches), within 3e-2 * max of the one-chunk forward. ``eqv2_profile``:
   one more kernel forward under ``torch.profiler`` (``segment_sum``'s share
   of the device time). ``eqv2_equal``: kernel against plain within 3e-2 *
   max |plain| at every request, the share of equal outputs, the profiled
   forward equal to the first bit for bit, and, reported, the output's
   change under a rotation of the positions about z by 1.1 rad and under a
   general rotation, over max |output|.
12b. ``gnn_train_plan`` / ``gnn_train_check`` / ``gnn_train`` — GNN
   training at full width through ``launch.steps.gnn_train_step`` (the
   loss of ``_gnn_cell``'s step, its gradient with each layer
   recomputed in the backward, AdamW at 1e-3): equiformer-v2 and gatedgcn
   on ``molecule`` (3,840 nodes, 16,384 edges), graphsage-reddit on
   ``minibatch_lg`` (169,984 nodes, 168,960 edges, d_feat 602) and
   meshgraphnet on ``full_graph_sm``, as ``gnn_counts`` sizes them;
   parameters from seed 4, labels the degree bucket. ``gnn_train_check``,
   from one parameter draw after a warm-up: the kernel path's loss and
   every gradient within 3e-2 * max |plain| of the plain path's (each
   gradient's limit plus 1e-6 of the largest), two kernel steps bit for
   bit equal, remat off against on within 1e-6 * max (EquiformerV2 and
   gatedgcn; peak GiB of both), the training forward against the
   inference forward within the forward's gate; segment_sum launches a
   step, no other kernel. ``gnn_train``: 10 steps on the kernel path, each
   loss and global norm (all finite, the last loss below the first), CUDA
   event seconds a step and their median, peak GiB, segment_sum launches
   (10 times a step's); for EquiformerV2 the step's executed FLOP over
   its median (``eqv2_train_flops``) beside JAX's ``_gnn_flops(train=True)``
   count, the float32 bound of the FLOP the step needs (rotations counted
   by degree; the executed count's bound beside it) and its share of the
   median, and one more step under ``torch.profiler``. Then a
   ``kernel_check`` line: ``segment_sum`` at each path's two training
   shapes, the source-id transposes of its gathers (unsorted; padded edges
   dropped) and its widest destination-id sum, timed as in 9.
12c. ``gnn_mesh`` — the sharded GNN step (``gnn_train_step`` on a train
   graph built with ``mesh=grid``: the graph split over every axis, the
   mesh gathers and segment sums, ZeRO-1 AdamW) on a ``(1, 1)``
   ``GridMesh`` at NCCL world 1: equiformer-v2 (through the channel-split
   gather and segment sum) and gatedgcn at ``_FULL`` on ``molecule``, one
   step each with the kernels after a warm-up, against the one-device
   ``gnn_train_step`` on the same parameters and graph: loss and norm
   within ``GNN_MESH_LIMIT``, every updated parameter and both moments bit
   for bit, the launches a step as the one device's, the collectives' calls and bytes
   by kind and axis; ``gnn_mesh_done`` times the phase. The four-card
   cells (ogb_products) are ``examples/torch_train_gnn_mesh.py``'s.
13. ``kernel_check`` (``flash_attention``) — the three attention kernels
   against their plain version at the serving shapes (prefill q [4, 24,
   8192, 128] over k/v [4, 8, 8208, 128] and the second 4,096-token chunk
   at offset 4,096 on the tensor-core kernel; decode at offsets 8,192 and
   8,206 and with command-r's 64 / 8 heads on the split-K decode kernel;
   a Dh 64 bf16 prefill), at MLA's (``mla_minicpm3_prefill`` q [4, 40,
   4096, 96] and ``mla_deepseek_prefill`` q [4, 16, 4096, 192] over 4,112
   keys on the tensor-core kernel, and both at decode, Lq 1, offset 4,096,
   group 1, on the decode kernel; V at its own 64 / 128 columns, as the
   model passes it, padded by the wrapper for the decode kernel only; the
   bound counted from the function's own widths, the tensor-core kernel's
   issued FLOP and the decode call's padded bytes and FLOP beside it; SDPA
   on V at its own width, and on V zero-padded, beside it; each decode
   case also timed on V as the model hands it over, a head-major view,
   against two other ways of building the padded V), at the MLA float32
   gates' (``mla_minicpm3_f32_gate`` q [2, 40, 1024, 96] over 1,032 keys
   and ``mla_deepseek_f32_gate`` q [2, 16, 512, 192] over 520 on the
   CUDA-core kernel, and both at decode, Lq 1, on V the wrapper pads),
   at granite's
   and command-r's (``granite_prefill`` q [4, 24, 8192, 64] over [4, 8,
   8208, 64] and ``command_r_prefill`` q [2, 64, 4096, 128] over [2, 8,
   4112, 128] on the tensor-core kernel, and both at decode, Lq 1, offsets
   8,192 and 4,096) and at edge cases
   (float32 and bf16; Dh 8, 20, 64, 128, 256; MHA; Lq 1; q_offset + Lq =
   Lk; non-causal; Lk not a multiple of the tile; a bf16 Dh 20 must raise),
   each with the route it took.
   Each output element is held to the plain version on the inputs in
   float32 (``ref.flash_attention_limits``): within 1e-5 * sum_j p_j |v_j| in
   float32, and within one bf16 rounding of that in bf16. With the
   kernel's, the plain version's and ``scaled_dot_product_attention``'s
   median ms beside the bound (and, under 1 ms, the kernel's and SDPA's
   time over 20 calls in a row). ``flash_kernels``: each kernel's
   registers, shared and spill bytes, and the decode grid.
14. ``lm_plan`` / ``lm_serve`` — phi4-mini-3.8b serving at full width
   (32 layers, d_model 3,072, 24/8 heads of 128, d_ff 8,192, vocab
   200,064, bf16, random weights from seed 0) through
   ``repro_torch.launch.serve.serve``: 4 prompts of 8,192 tokens, prefill
   then 15 greedy decode steps, once with the kernels (32 prefill
   launches, every one on the tensor-core kernel, and 480 of the split-K
   decode kernel) and once plain, teacher-forced on the kernel
   run's tokens (0 launches); outputs finite. ``lm_chunked``:
   ``prefill_chunked`` (chunk 4,096, 64 tensor-core launches) on the same
   prompts; its last logits and its cache within 1e-2 * max |unchunked|
   of the unchunked prefill's, and the same first token. ``lm_profile``:
   one more kernel prefill and one decode step under ``torch.profiler``.
   ``lm_equal``: the gate, the same model in float32 (2 prompts of 2,048
   tokens, 8 tokens each; prefill on the CUDA-core kernel), kernel against
   plain within 1e-3 * max |plain| of the logits at every step; and,
   reported, the bf16 run's largest logit difference and its share of
   equal greedy tokens.
14b. ``mla_serve`` (minicpm3-4b, MLA, 4 x 4,096 prompt tokens),
   ``moe_serve`` (deepseek-v2-lite-16b, MLA + MoE, 4 x 4,096;
   granite-moe-3b-a800m, GQA + MoE, 4 x 8,192) and ``lm_large``
   (command-r-35b, 2 x 4,096), 16 generated tokens each (``LM_CELLS``): each
   config at full width, random weights from seed 0 drawn on the card a
   layer at a time, through ``serve``. Per model a ``plan`` record
   (widths, parameters, active parameters, cache GiB, the prefill's
   product FLOP, predicted launches); the kernel run (prefill seconds and
   TFLOP/s, decode ms a step, tokens a second, peak and resident GiB,
   ``flash_attention`` launches one a layer, all on the tensor cores,
   ``flash_decode``
   one a layer a step, checked; with MoE the expert loop's routed rows and
   experts run a layer and its host seconds); the plain run, teacher-forced
   on the kernel run's tokens, with MoE on its routing decisions
   (``Routing``: its own choice where it differs is counted as a flip, with
   its probability gap); for MLA the absorbed decode (``decode_absorbed``,
   no decode kernel) within ``ABSORBED_LIMIT`` of the materialized decode's
   logits at every step; a profiled prefill and decode step (the attention
   kernel's share of the device time, the expert loop's host share); and
   the float32 gate (kernel against plain within 1e-3 * max |plain| at every
   step; minicpm3 2 x 1,024, deepseek 2 x 512, granite 2 x 1,024, 8 tokens;
   none for command-r, whose float32 weights would take 130 GB: its bf16
   ratio is reported).
15. ``kernel_check`` (``embedding_bag``) — the embedding-bag kernel against
   its plain version on a ``[26,000,000, 64]`` float32 table (the 26
   stacked DLRM tables): ``serve_bulk`` (6,815,744 one-row bags) and
   ``serve_p99`` (13,312) must be equal; ``multi_hot`` (batch 4,096 with
   MLPerf DLRM-DCNv2's per-field bag sizes, 214 rows a sample) within
   n_b * 2**-23 * sum |rows| of the float64 sum, kernel and plain alike;
   edge cases (bf16 within one bf16 rounding more, empty bags, bag ids
   num_bags and -1, a row index V (NaN in its bag only), N = 0 and
   num_bags = 0 without a launch, D = 13, ``mixed_windows``: bags of 0 to
   100 rows sharing and crossing 32-row windows), each launched twice
   (bitwise equal). With the kernel's, the plain version's and
   ``torch.nn.functional.embedding_bag``'s median ms (one call at a time
   and 20 in a row) beside the byte bound; ``serve_bulk_1gib`` times
   serve_bulk's lookups folded into the table's first GiB (a TLB limit
   would show as a gap), with the plain version and the library call
   beside it too.
16. ``dlrm_plan`` / ``dlrm_serve`` — dlrm-rm2 serving at its full config
   (26 tables of 1,000,000 x 64, float32, 1,664,762,177 parameters,
   random weights from seed 0; TF32 off) through
   ``repro_torch.launch.serve.serve_recsys``: 8 ``serve_p99`` requests
   of 512, 2 ``serve_bulk`` requests of 262,144 and 2 ``retrieval_cand``
   requests (1 query x 1,000,000 candidates), each shape after one
   warm-up request, once with the kernels (one ``embedding_bag`` launch a
   request: 15) and once plain (0). ``dlrm_equal``: logits of every request within 1e-5 *
   max |plain|, and the embedding outputs (one-row bags) bitwise equal.
   ``dlrm_profile``: three more ``serve_bulk`` forwards under
   ``torch.profiler``, after a warm-up forward.
17. ``dlrm_train_plan`` / ``dlrm_train`` — dlrm-rm2 training at its full
   config on ``train_batch`` (65,536 examples a batch from
   ``click_batches(seed=0)``, skewed ids; the distinct rows each batch
   touches), 10 steps of ``launch.steps.dlrm_train_step`` (``_dlrm_cell``'s
   stable BCE, AdamW at 1e-3 in place) from the parameters of seed 0: the
   losses (falling), global norms, CUDA-event seconds a step, peak GiB and
   launches a step (one ``embedding_bag`` forward, one ``segment_sum`` for
   the tables' gradient, into the touched rows), ``dlrm_train_profile`` (one
   more step under ``torch.profiler``); then the same 10 steps on
   the plain versions from the same parameters, no launch, losses and norms
   within ``DLRM_TRAIN_LIMIT`` of the kernel run's (``bitwise_equal_kernels``
   reported). Then ``embedding_bag`` at the first batch's lookups
   (``train_batch``, one-row bags, equal to plain and to
   ``F.embedding_bag``; the bound counts the distinct rows) and
   ``segment_sum`` at the tables' gradient (``dlrm_table_grad``, 1,703,936
   float32 rows summed into the touched rows, row 0 of each field heavy).
18. ``lm_train_plan`` / ``lm_train`` — for each of ``LM_TRAIN_CELLS``
   (phi4-mini-3.8b, minicpm3-4b with MLA, granite-moe-3b-a800m with MoE,
   deepseek-v2-lite-16b with MLA and MoE, its depth cut to
   ``LM_TRAIN_LAYERS``; each line tagged with its ``path``) training at
   full width at train_4k's sequence of 4,096, the batch cut to the
   largest at which ``lm_micro_batches`` gives 1 at the published depth
   (2, 1, 1, 1), remat on, from
   ``token_batches(seed=0)``: 3 steps of ``launch.steps.lm_train_step``
   (AdamW at 3e-4 in place): losses, norms, seconds a step, peak GiB (under
   79.2), TFLOP/s of ``lm_flops`` and the launches a step
   (``flash_attention`` on the tensor cores twice a layer, forward and
   recompute, each keeping its log-sum-exp; ``flash_attention_bwd`` once a
   layer, on the tensor cores, minicpm3's at (Dqk, Dv) = (96, 64),
   deepseek's at (192, 128);
   ``segment_sum`` once, the embedding's gradient); for the MoE ones also each
   layer's routed rows past their expert's window (``moe``) and whether
   every recompute routed as its forward; ``lm_train_profile``, one more
   step under ``torch.profiler``; ``lm_train_equal``, the next batch's loss
   and gradient norm (and each leaf's) from the same state with the kernels
   and with the plain versions, within ``LM_TRAIN_LIMIT``. Then
   ``segment_sum`` at phi4's embedding gradient (``lm_embed_grad``: 8,192
   bf16 rows of 3,072 summed by token into the tokens the batch holds).
18b. ``lm_mesh`` — the sharded training step (``lm_train_step(...,
   mesh=grid)``: tensor-parallel layers, the embedding and head split by
   vocabulary, ``_moe_routed`` expert parallel with its exchange, ZeRO-1
   AdamW) on a ``(1, 1)`` ``GridMesh`` at NCCL world 1, so every collective
   runs on one rank: granite-moe-3b-a800m at full width with its depth cut
   from 32 to ``LM_MESH_LAYERS`` layers (the script's time), one step with
   the kernels on 1 × 4,096 tokens, against the one-device
   ``lm_train_step`` on the same parameters and tokens: loss and gradient
   norm within ``LM_TRAIN_LIMIT``, the updated parameters and both AdamW
   moments bit for bit the one-device step's, the exchange's overflow 0, the
   launches a step as the one-device step's, the collectives' calls and
   bytes by kind and axis.
19. ``kernel_check`` (``flash_attention_bwd``) — the attention backward
   against its plain version at the training shapes (q [2, 24, 4096, 128]
   bf16 over k/v [2, 8, 4096, 128]; minicpm3's q, k [1, 40, 4096, 96], v
   [1, 40, 4096, 64]; deepseek's q, k [1, 16, 4096, 192], v [1, 16,
   4096, 128]) and at edge cases (L 1, 17, 4,095; groups 1, 3, 8; Dh 64
   and 128; (96, 64) and (192, 128) at L 4,095 (group 1), 1,000 (group 3)
   and 300 (minicpm3's 40 heads, deepseek's 16); bf16 on the tensor
   cores from the forward's log-sum-exp, float32 on the CUDA cores): every
   element of dQ, dK and dV within ``ref.flash_attention_bwd_limits`` of
   the plain version on the inputs in float32, two launches bitwise equal;
   the forward's output bitwise the same with and without its log-sum-exp,
   which is within 1e-5 of ``torch.logsumexp``; with the kernel's, the
   plain backward's, SDPA's forward + backward and SDPA's backward-alone
   median ms beside the bound (five causal products at the bf16
   tensor-core rate); a ``flash_kernels`` line with the six kernels'
   registers and spills (the tensor-core ones must not spill).

Then a ``device`` line with the card's name and power limit (the
``nvidia-smi --query-gpu=name,power.limit`` line), the ``kernels``
summary (``segment_sum``'s ``launches_by_path``: the gatedgcn forward,
the molecule and full_graph_sm kernel requests, the chunked forward,
the four GNN training paths' 10 steps, ``gnn_mesh``'s two steps,
``dlrm_train``, the three LM training paths and ``lm_mesh``, each counted
from 0; the three attention
kernels' ``launches_by_path``: the five LM kernel serves, phi4, minicpm3,
deepseek, granite and command_r, the four float32 gates' kernel serves,
``<path>_f32_gate`` (none for command_r), and ``lm_train``,
``lm_train_minicpm3-4b``, ``lm_train_granite-moe-3b-a800m``,
``lm_train_deepseek-v2-lite-16b`` and ``lm_mesh``,
their sum in ``launches``; ``embedding_bag``'s ``dlrm_serve`` and
``dlrm_train``; ``flash_attention_bwd``'s five LM training paths and
``launches_by_route``, ``tc`` or ``simt``),
and last
``{"ok": true, "device": ...}``. Any mismatch, nonzero overflow or
failed phase exits nonzero without that line.

``--kernel-times SRC`` runs none of that: it times the ``member_probe``,
``set_intersect`` and ``embedding_bag`` kernels of the package under
``SRC`` at the main paths' shapes and profiles one DDSL batch, so that two
checkouts (``src`` and, say, a ``git archive`` of another commit unpacked
under ``build/``) are compared in turns on one card in one call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Host-engine counts (repro.core.DDSL, the NumPy reference) of the two
# configurations, from the JAX package's engine on the same seeds.
WT_INITIAL_COUNT = 395_050
# The WT~ q1_square counts after stage 1, each of the N_BATCHES batches and
# the profiled batch, as the per-pattern, carry-free maintain step printed
# them on an H100 (python -m repro_torch.run --batches 4 before the
# megastep): the carried megastep must give the same.
WT_COUNTS = (WT_INITIAL_COUNT, 385_521, 373_667, 365_873, 347_791)
# Small batches after the main ones: 1 deletion + 1 insertion each.
N_SMALL, SMALL_SEED = 3, 500
EXAMPLE_COUNTS = {"q1_square": (1282, 1238, 1128, 1086), "q2_triangle": (188, 182, 172, 168)}
# WT~ counts of the generic-join configurations after stage 1, each of the
# N_BATCHES batches and the profiled batch (64 + 64 edges, seeds 100-103):
# the JAX package's host generic join (repro.core.match_engine
# list_matches_wcoj over the whole graph after each batch) and its host
# DDSL (repro.core.DDSL, m = 8, initial() then apply() per batch) both give
# these on the CPU. WT_Q2_COUNTS is q2_triangle's, which the tree executor
# (WT_MULTI) and the generic join (WT_MULTI_AUTO) must both give.
WT_K5_COUNTS = (13_098, 12_437, 11_386, 11_191, 8_918)
WT_K4_COUNTS = (15_320, 14_817, 14_074, 13_790, 12_341)
WT_Q2_COUNTS = (12_691, 12_474, 12_191, 11_983, 11_544)
# The same three batches split as the service commits them at 64 ops a batch:
# the counts after each batch's 64 deletions alone (watermarks 64, 192, 320),
# from the JAX package's host DDSL (repro.core.DDSL, m = 8, initial() then
# apply() of each batch's deletions and then of its insertions) on the CPU;
# at the insertions' watermarks it gives WT_COUNTS and WT_Q2_COUNTS.
SERVICE_DELETE_COUNTS = {"q1_square": (385_386, 373_611, 365_792),
                         "q2_triangle": (12_470, 12_187, 11_978)}
# K5 / K4 on the planted near-clique graph (benchmarks/bench_wcoj.py), from
# the host generic join; the tree executor's match_cap starts at 8,192 and
# grows 4x until its listing is lossless, as bench_wcoj.py's does.
PLANTED_COUNTS = {"q6_clique5": 14_785, "q4_clique4": 7_358}
TREE_MATCH_CAP0 = 8192

# NVIDIA H100 SXM data sheet: HBM3 rate, the float32 rate outside the
# tensor cores as the peak for 32-bit integer compares and float32 adds and
# float32 attention, and the dense bf16 tensor-core rate for bf16 attention.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
N_BATCHES = 3
DDSL_KERNELS = ("member_probe", "set_intersect")
# The GNN slice: gatedgcn on ogb_products (configs/registry.py GNN_SHAPES;
# a full-graph run doubles the undirected edges, launch/steps.py).
GNN_ARCH, GNN_SHAPE = "gatedgcn", "ogb_products"
GNN_SMALL = (("graphsage-reddit", 1e-4), ("meshgraphnet", 3e-2))
# The EquiformerV2 slice: equiformer-v2 at its full config (configs/equiformer_v2.py
# _FULL: 12 layers, d 128, l_max 6, m_max 2, 8 heads, bf16) on four molecule
# requests (128 graphs x 30 nodes, 64 x 2 directed edges each: 3,840 nodes, 16,384
# edges, as launch/steps.py _gnn_counts sizes them) and one full_graph_sm request,
# positions synthesized (build_graph_data geometric=True); EQV2_CHUNK cuts a
# molecule graph into 4 edge chunks. Nothing is cut.
EQV2_ARCH = "equiformer-v2"
EQV2_MOLECULE_SEEDS = (0, 1, 2, 3)
EQV2_CHUNK = 4096
EQV2_TOL = 3e-2
# The GNN training slice: each architecture at its _FULL width on a shape its
# users train on, sized as launch/steps.py _gnn_counts sizes it on one device
# (gnn_counts); the forward's gate against its plain version beside each.
# ogb_products trains across four cards instead (examples/torch_train_gnn_mesh.py):
# with remat gatedgcn keeps each layer's [123,718,280, 70] bf16 edge state,
# 17.3 GB, 277 GB over 16 layers, more than one card holds.
TRAIN_CELLS = (("equiformer-v2", "molecule", EQV2_TOL), ("gatedgcn", "molecule", 3e-2),
               ("graphsage-reddit", "minibatch_lg", 1e-4),
               ("meshgraphnet", "full_graph_sm", 3e-2))
TRAIN_STEPS, TRAIN_LR = 10, 1e-3
TRAIN_GRAD_TOL, REMAT_TOL = 3e-2, 1e-6
REMAT_CHECKED = ("equiformer-v2", "gatedgcn")
# The GNN step on a (1, 1) grid at NCCL world 1 (gnn_mesh): these two at
# _FULL on molecule, one step each against the one-device step. At world 1
# the arithmetic is the one device's but for one rounding: the grid rounds
# each float64 sum over all N to float32 before the model's bf16 (its
# cross-rank sums run in float32), one device to bf16 directly. The two
# differ only where a float64 sum is not exact in float32 and its float32
# value falls on a bf16 tie. These inputs come from fixed seeds, and on an
# H100 no such sum showed, so the updated parameters and both moments must
# be bit-equal to one device's (a missing or wrong ZeRO-1 update shows there: at AdamW's
# first step the update is about lr whatever the gradient). Loss and norm,
# read before the update, within GNN_MESH_LIMIT relative.
GNN_MESH_ARCHS, GNN_MESH_SHAPE, GNN_MESH_LIMIT = ("equiformer-v2", "gatedgcn"), "molecule", 1e-3
# The LM slice: phi4-mini-3.8b serving (configs/phi4_mini_3_8b.py _FULL).
# The repo's prefill_32k shape (32 x 32,768 tokens) needs a 137 GB cache:
# cut to 4 prompts of 8,192 tokens and 16 generated tokens each.
LM_ARCH = "phi4-mini-3.8b"
LM_BATCH, LM_PROMPT, LM_GEN, LM_CHUNK = 4, 8192, 16, 4096
LM_EQ_BATCH, LM_EQ_PROMPT, LM_EQ_GEN = 2, 2048, 8
# The DLRM slice: dlrm-rm2 serving (configs/dlrm_rm2.py _FULL, nothing
# cut) at the three RECSYS_SHAPES, requests per shape.
DLRM_ARCH = "dlrm-rm2"
DLRM_REQUESTS = {"serve_p99": 8, "serve_bulk": 2, "retrieval_cand": 2}
DLRM_PROFILED = 3  # serve_bulk forwards under the profiler
# Lookups per field of MLPerf Training DLRM-DCNv2 on multi-hot Criteo
# (214 a sample); the serve path keeps the repo's multi_hot = 1.
MULTI_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3,
                   1, 1)
# The training slices. dlrm-rm2 on train_batch (65,536 examples), nothing cut;
# the plain run's losses and norms are expected bit-equal (one-row bags are
# copies, the table gradient a float64 sum rounded once) and held to 1e-6
# relative: the plain segment sum adds with float64 atomics in no fixed
# order, so where a float64 sum is not exact its rounding may fall either way.
DLRM_TRAIN_STEPS, DLRM_TRAIN_LR, DLRM_TRAIN_LIMIT = 10, 1e-3, 1e-6
# phi4-mini-3.8b at train_4k's sequence of 4,096; the global batch cut from
# 256 to LM_TRAIN_BATCH, the largest at which lm_micro_batches gives one
# microbatch: the bf16 weights, their gradient and the float32 moments take
# 53.4 GB, and more microbatches add a float32 accumulator of 17.8 GB (run in
# the CPU tests only). The kernel and plain losses and
# gradient norms are held to LM_TRAIN_LIMIT relative: the two paths round each
# layer's attention output and gradients to bf16 independently (2**-8 a
# rounding), and over 32 bf16 layers those differences add to a few roundings.
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_TRAIN_LR = 2, 4096, 3, 3e-4
LM_TRAIN_LIMIT = 2e-2
# The same cell for minicpm3-4b (MLA: the backward at (Dqk, Dv) = (96, 64))
# and granite-moe-3b-a800m (GQA + 40 experts, top-8: the routed training sum
# with its expert windows), each at the largest batch with one microbatch
# (``one_micro_batch``): 1 for both (a minicpm3 example's saved residuals are
# 1.30e9 bytes against the 2e9 target, a granite one's 4.03e8 against 5e8);
# bf16 weights and gradients and float32 moments take 51 / 48 GB. Each as
# (arch, its key in the kernels line's launches_by_path).
# deepseek-v2-lite-16b (MLA at (Dqk, Dv) = (192, 128) + 64 experts, top-6, 2
# shared, a dense first layer) at batch 1 too (an example saves 2 x 27 x
# 4,096 x 2,048 bytes = 4.53e8 against 5e8); at 12 bytes a parameter its
# embedding and head take 5.03 GB, the dense layer 0.97 GB and each MoE layer
# 7.02 GB: 188 GB at its 27 layers, so its depth is cut to LM_TRAIN_LAYERS,
# the most that fit (11: 76.2 GB, 70.95 GiB, before the step's working set;
# 12 would take 77.49 GiB).
LM_TRAIN_CELLS = ((LM_ARCH, "lm_train"), ("minicpm3-4b", "lm_train_minicpm3-4b"),
                  ("granite-moe-3b-a800m", "lm_train_granite-moe-3b-a800m"),
                  ("deepseek-v2-lite-16b", "lm_train_deepseek-v2-lite-16b"))
LM_TRAIN_LAYERS = {"deepseek-v2-lite-16b": 11}
# The sharded step on a (1, 1) grid: granite at full width, 4 of its 32 layers.
LM_MESH_ARCH, LM_MESH_LAYERS = "granite-moe-3b-a800m", 4


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with ``t_s``: seconds since the script started."""
    print(json.dumps({**obj, "t_s": time.perf_counter() - _START}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 10, per: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings,
    each around ``per`` calls in a row (divided by ``per``). With ``per =
    1`` the host's work for the call shows in the time where the card
    would idle waiting for it; with more, the calls queue up and only the
    card's time shows."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |kernel - plain| over the outputs, as integers."""
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Inputs at the main path's shapes
# ---------------------------------------------------------------------------

def sorted_table(n_rows: int, n_pad: int, hi_max: int, gen) -> torch.Tensor:
    """A lex-sorted unique (hi, lo) table with a (-1, -1) tail, on the card."""
    hi = torch.randint(0, hi_max, (n_rows,), generator=gen, dtype=torch.int64, device="cuda")
    lo = hi + 1 + torch.randint(0, hi_max, (n_rows,), generator=gen, dtype=torch.int64,
                                device="cuda")
    codes = torch.unique(hi * (1 << 32) + lo)
    t = torch.stack([codes >> 32, codes & 0xFFFFFFFF], 1).to(torch.int32)
    return torch.cat([t, torch.full((n_pad, 2), -1, dtype=torch.int32, device="cuda")])


def sized_table(m: int, n_pad: int, gen) -> torch.Tensor:
    """Exactly ``m`` rows: ``m - n_pad`` unique lex-sorted (hi, lo) pairs
    with hi below 2**20, then the (-1, -1) pads."""
    t = sorted_table(2 * (m - n_pad), 0, 1 << 20, gen)
    keep = torch.randperm(t.shape[0], generator=gen, device="cuda")[:m - n_pad].sort().values
    return torch.cat([t[keep], torch.full((n_pad, 2), -1, dtype=torch.int32, device="cuda")])


def probe_queries(n: int, table: torch.Tensor, hi_max: int, gen) -> torch.Tensor:
    """Queries: half drawn from the table's rows, the rest random or pad."""
    q = torch.randint(-1, hi_max, (n, 2), generator=gen, dtype=torch.int32, device="cuda")
    take = torch.randint(0, table.shape[0], (n // 2,), generator=gen, device="cuda")
    q[: n // 2] = table[take]
    q[::7] = -1
    return q


def padded_sets(g: int, c: int, v_max: int, gen, pad: int = -1, fill=None,
                empty: float = 0.0) -> torch.Tensor:
    """Rows ascending with a pad tail (the CompTensors set layout): a row's
    length uniform in [0, c]; or a share ``empty`` of rows all pad and the
    rest uniform over an interval of lengths from 1 around ``fill / (1 -
    empty)``, for a mean length of about ``fill``."""
    vals = torch.sort(torch.randint(0, v_max, (g, c), generator=gen, dtype=torch.int32,
                                    device="cuda"), dim=1).values
    lo, hi = 0, c
    if fill is not None:
        t = round(2 * fill / (1.0 - empty)) if empty < 1.0 else 0
        lo = max(min(1, t), t - c)
        hi = min(c, t - lo)
    lens = torch.randint(lo, hi + 1, (g, 1), generator=gen, device="cuda")
    lens[torch.rand((g, 1), generator=gen, device="cuda") < empty] = 0
    vals[torch.arange(c, device="cuda")[None, :] >= lens] = pad
    return vals


def set_rows(g: int, c: int, v_max: int, gen, kinds, pad: int = -1) -> torch.Tensor:
    """``padded_sets`` rows, row ``i`` then turned into ``kinds[i %
    len(kinds)]``: ``layout`` (kept), ``unsorted`` (values in any order,
    a fifth of them pad), ``mid_pad`` (full and ascending but for one pad
    amid the values), ``after_tail`` (a value after the pad tail),
    ``extremes`` (INT32_MIN first and INT32_MAX last), ``all_pad``."""
    vals = padded_sets(g, c, v_max, gen, pad)
    kind = torch.arange(g, device="cuda") % len(kinds)
    pos = torch.arange(c, device="cuda")[None, :]
    full = torch.sort(torch.randint(0, v_max, (g, c), generator=gen, dtype=torch.int32,
                                    device="cuda"), dim=1).values
    for k, name in enumerate(kinds):
        rows = kind == k
        if name == "unsorted":
            r = torch.randint(0, v_max, (g, c), generator=gen, dtype=torch.int32, device="cuda")
            r[torch.rand((g, c), generator=gen, device="cuda") < 0.2] = pad
        elif name == "mid_pad":
            hole = torch.randint(0, max(1, c - 1), (g, 1), generator=gen, device="cuda")
            r = torch.where(pos == hole, pad, full)
        elif name == "after_tail":
            r = torch.where(pos >= c // 2, pad, full)
            r[:, -1] = 0
        elif name == "extremes":
            r = full.clone()
            r[:, 0], r[:, -1] = -2**31, 2**31 - 1
        elif name == "all_pad":
            r = torch.full_like(full, pad)
        else:
            continue
        vals[rows] = r[rows]
    return vals


def drawn_from(a: torch.Tensor, b: torch.Tensor, share: float, gen) -> torch.Tensor:
    """``a`` with about ``share`` of its values replaced by values of its
    own row of ``b`` (so that many are found)."""
    g, ca = a.shape
    idx = torch.randint(0, b.shape[1], (g, ca), generator=gen, device="cuda")
    take = torch.rand((g, ca), generator=gen, device="cuda") < share
    return torch.where(take, b.gather(1, idx), a)


def set_library(a: torch.Tensor, b: torch.Tensor, pad: int):
    """One ``torch.isin`` over row-packed int64 keys (row * 2**32 + value)
    computing the kernel's function: ``b``'s pads become a key that no
    ``a`` value can take, and ``a``'s pads are masked out."""
    g = a.shape[0]
    rows = torch.arange(g, device="cuda", dtype=torch.int64)[:, None] * (1 << 32)
    ak = (rows + a.to(torch.int64)).reshape(-1)
    bk = torch.where(b == pad, -(1 << 62), rows + b.to(torch.int64)).reshape(-1)
    live = a != pad
    return lambda: torch.isin(ak, bk).view(a.shape) & live


def probe_library(q_hi, q_lo, t_hi, t_lo):
    """One ``torch.isin`` over packed int64 keys (hi * 2**32 + lo)
    computing the probe's function: the table's (-1, -1) pads are left out
    of its keys and (-1, -1) queries masked out."""
    qk = q_hi.to(torch.int64) * (1 << 32) + q_lo.to(torch.int64)
    keep = (t_hi != -1) | (t_lo != -1)
    tk = (t_hi.to(torch.int64) * (1 << 32) + t_lo.to(torch.int64))[keep]
    live = (q_hi != -1) | (q_lo != -1)
    return lambda: torch.isin(qk, tk) & live


def kernel_phase(pipe_shapes):
    from repro_torch.kernels import ref
    from repro_torch.kernels.member_probe import member_probe_cuda, probe_stride
    from repro_torch.kernels.set_intersect import set_intersect_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    caps, ush, store = pipe_shapes
    results = {}

    # --- member_probe: every call shape of the main path ----------------
    cedge = ush["cedge_cap"]
    drop = sorted_table(cedge, 64, 4096, gen)
    dele = sorted_table(64, 0, 4096, gen)
    # (queries, table, offset of the query lanes into their buffers)
    cases = {
        # patch_partition: candidate rows × (candidate ∪ deleted) edges
        "patch_rows": (ush["cand_cap"] * caps["deg_cap"], drop, 0),
        # patch_partition: stored edge list × the same drop table
        "patch_edges": (caps["e_cap"], drop, 0),
        # filter_deleted_dev: store set values × the delete table
        "filter_sets": (store["group_cap"] * store["set_cap"], dele, 0),
        # edge cases: one-row table, all-pad table
        "tiny": (1000, sorted_table(1, 0, 4096, gen), 0),
        "all_pad": (1000, torch.full((5, 2), -1, dtype=torch.int32, device="cuda"), 0),
        # tables on both sides of the kernel's shared-memory table (8,192
        # rows) and at a fence stride's edges (ceil(m / s) = 8,192 fences
        # at s = 4, one row more takes s = 8); n % 4 != 0; query lanes that
        # are offset views (not 16-byte aligned), as engine.edge_probe's
        # reshapes can pass
        "smem_8191": (100_003, sized_table(8191, 0, gen), 0),
        "smem_8192": (100_002, sized_table(8192, 2, gen), 1),
        "smem_8193": (100_001, sized_table(8193, 0, gen), 3),
        "fences_32768": (100_000, sized_table(32_768, 0, gen), 2),
        "fences_32769": (99_999, sized_table(32_769, 1, gen), 0),
        "patch_rows_views": (ush["cand_cap"] * caps["deg_cap"] - 3, drop, 1),
    }
    mp = []
    for name, (n, tbl, offset) in cases.items():
        q = probe_queries(n, tbl, 1 << 20 if name.startswith(("smem", "fences")) else 4096, gen)
        qh, ql = (torch.full((n + offset,), -3, dtype=torch.int32, device="cuda")
                  for _ in range(2))
        qh[offset:], ql[offset:] = q[:, 0], q[:, 1]
        args = (qh[offset:], ql[offset:], tbl[:, 0].contiguous(), tbl[:, 1].contiguous())
        got = member_probe_cuda(*args)
        want = ref.member_probe_ref(*args)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        check(err == 0, f"member_probe {name}: {err} mismatches")
        check(torch.equal(got, member_probe_cuda(*args)), f"member_probe {name}: not repeatable")
        m_rows = tbl.shape[0]
        rec = {"case": name, "n": n, "m": m_rows, "stride": probe_stride(m_rows, n),
               "offset": offset, "equal": True, "max_abs_err": max_abs_err(got, want)}
        if name in ("patch_rows", "patch_edges", "filter_sets", "tiny", "all_pad"):
            # one call at a time, and the card's time alone (20 in a row)
            rec["ms"] = cuda_ms(lambda: member_probe_cuda(*args))
            rec["ms_back_to_back"] = cuda_ms(lambda: member_probe_cuda(*args), per=20)
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                9.0 * n + 8.0 * m_rows, n * math.ceil(math.log2(m_rows + 1)))
        if "ms" in rec:
            rec["plain_ms"] = cuda_ms(lambda: ref.member_probe_ref(*args), reps=3)
            lib = probe_library(*args)
            rec["library_equal"] = torch.equal(lib(), want)
            rec["library_ms"] = cuda_ms(lib, reps=3)
            if name != "filter_sets":
                rec["library_ms_back_to_back"] = cuda_ms(lib, per=20)
            del lib
        mp.append(rec)
        del q, qh, ql, args, got, want
    # empty query / empty table: answered without a launch
    e = torch.empty(0, dtype=torch.int32, device="cuda")
    one = torch.zeros(3, dtype=torch.int32, device="cuda")
    before = member_probe_cuda.launches
    check(member_probe_cuda(e, e, one, one).numel() == 0, "member_probe N=0")
    check(not member_probe_cuda(one, one, e, e).any(), "member_probe M=0")
    check(member_probe_cuda.launches == before, "member_probe launched for an empty input")
    results["member_probe"] = mp
    torch.cuda.empty_cache()

    # --- set_intersect ---------------------------------------------------
    G, S, D = caps["group_cap"], caps["set_cap"], caps["deg_cap"]
    results["set_intersect"] = [set_intersect_case(name, *args, gen=gen) for name, args in {
        # the main path's two calls: the CC-join and the common-neighbour test
        "ccjoin": (G, S, S, ("padded",)),
        "zcommon": (cedge, D, D, ("padded",)),
        # b wider than a warp's shared memory (a block a row), and past the
        # block's shared-memory limit (searched in global memory); rows in and
        # out of layout
        "wide": (3, 5000, 9000, ("unsorted", "layout", "mid_pad")),
        "past_shared": (3, 5000, 60_000, ("layout", "unsorted", "after_tail")),
        # duplicates and unsorted rows, widths 1 and 3
        "narrow": (7, 1, 3, ("narrow",)),
        # widths not a multiple of 4; views 1 and 3 values into a buffer
        "odd_widths": (1000, 511, 509, ("layout",)),
        "misaligned": (1000, 512, 512, ("layout",), -1, (1, 3)),
        # a pad amid the values or a value after the tail; pad = 7 amid the
        # values; INT32_MIN / INT32_MAX values
        "mid_pad": (2000, 300, 300, ("mid_pad", "after_tail", "layout")),
        "pad_7": (2000, 64, 64, ("layout", "mid_pad", "unsorted"), 7),
        "extremes": (2000, 64, 64, ("extremes", "layout")),
        # rows in and out of layout and all-pad rows in one launch
        "mixed": (4000, 512, 512, ("layout", "unsorted", "layout", "all_pad", "mid_pad")),
    }.items()]
    empty = torch.empty((0, 4), dtype=torch.int32, device="cuda")
    check(set_intersect_cuda(empty, empty, -1).shape == (0, 4), "set_intersect G=0")
    return results


def set_intersect_case(name, g, ca, cb, kinds, pad=-1, offsets=(0, 0), fill=None, gen=None):
    """One set_intersect case: the kernel twice (bitwise equal) against its
    plain version, on ``b`` rows of ``kinds`` and ``a`` rows in layout with
    a third of their values drawn from their ``b`` row (``padded``: both
    ``padded_sets`` drawn apart; ``fill``: the mean lengths of ``a`` and
    ``b`` and the share of all-pad ``a`` rows, where given;
    ``narrow``: values in [-1, 3)); at 2**20 values of ``a`` or more, timed
    one call at a time and 20 in a row, beside the plain version, the
    library call and the byte bound."""
    if kinds == ("narrow",):
        a, b = (torch.randint(-1, 3, (g, c), generator=gen, dtype=torch.int32, device="cuda")
                for c in (ca, cb))
    elif kinds == ("padded",):
        fa, fb, empty = fill or (None, None, 0.0)
        a = padded_sets(g, ca, 4096, gen, pad, fa, empty)
        b = padded_sets(g, cb, 4096, gen, pad, fb)
    else:
        v_max = 4096 if max(ca, cb) <= 512 else 4 * cb
        b = set_rows(g, cb, v_max, gen, kinds, pad)
        a = drawn_from(set_rows(g, ca, v_max, gen, ("layout",), pad), b, 1 / 3, gen)
    if offsets != (0, 0):   # contiguous views that are not 16-byte aligned
        views = []
        for t, off in zip((a, b), offsets):
            buf = torch.full((t.numel() + off,), pad, dtype=torch.int32, device="cuda")
            buf[off:] = t.reshape(-1)
            views.append(buf[off:].view(t.shape))
        a, b = views
    rec = set_intersect_check(name, a, b, pad, timed=g * ca >= 1 << 20,
                              offsets=list(offsets))
    del a, b
    torch.cuda.empty_cache()
    return rec


def set_intersect_check(name, a, b, pad, timed, **extra):
    """``set_intersect`` on ``a`` and ``b``: the kernel twice (bitwise
    equal) against its plain version; where ``timed``, timed one call at a
    time and 20 in a row, beside the plain version, the library call and
    the byte bound. ``extra`` joins the record."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.set_intersect import set_intersect_cuda, set_intersect_route

    (g, ca), cb = a.shape, b.shape[1]
    got = set_intersect_cuda(a, b, pad)
    again = set_intersect_cuda(a, b, pad)
    want = ref.set_intersect_ref(a, b, pad)
    torch.cuda.synchronize()
    err = int((got != want).sum())
    check(err == 0, f"set_intersect {name}: {err} mismatches")
    check(torch.equal(got, again), f"set_intersect {name}: two launches differ")
    rec = {"case": name, "g": g, "ca": ca, "cb": cb, "pad": pad, **extra,
           "route": set_intersect_route(cb, a.device), "equal": True, "repeat_equal": True,
           "max_abs_err": max_abs_err(got, want), "hits": int(want.sum()),
           "mean_nonpad_a": float((a != pad).sum()) / g,
           "mean_nonpad_b": float((b != pad).sum()) / g}
    if timed:
        rec["ms"] = cuda_ms(lambda: set_intersect_cuda(a, b, pad))
        rec["ms_back_to_back"] = cuda_ms(lambda: set_intersect_cuda(a, b, pad), per=20)
        rec["plain_ms"] = cuda_ms(lambda: ref.set_intersect_ref(a, b, pad), reps=3)
        lib = set_library(a, b, pad)
        rec["library_equal"] = torch.equal(lib(), want)
        check(rec["library_equal"], f"set_intersect {name}: the library call differs")
        rec["library_ms"] = cuda_ms(lib, reps=3)
        rec["bound_ms"], rec["bound_by"] = bound_ms(4.0 * g * (ca + cb) + g * ca, g * (ca + cb))
    return rec


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def store_snapshot(store):
    """Per shard: the valid prefix of every store tensor on the host, after
    checking that the rest is PAD (so equal snapshots mean equal tensors)."""
    snap = []
    for j in range(store.valid.shape[0]):
        valid = store.valid[j]
        n = int(valid.sum())
        check(bool(valid[:n].all()) and not bool(valid[n:].any()), "store valid is a prefix")
        check(bool((store.skeleton[j, n:] == -1).all()), "store skeleton tail is PAD")
        shard = {"n": n, "skeleton": store.skeleton[j, :n].cpu()}
        for v, a in store.sets.items():
            check(bool((a[j, n:] == -1).all()), "store set tail is PAD")
            shard[v] = a[j, :n].cpu()
        snap.append(shard)
    return snap


def snapshots_equal(a, b) -> bool:
    return all(x.keys() == y.keys() and all(
        (x[k] == y[k]) if k == "n" else torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b)) and len(a) == len(b)


def drive(config, use_kernels: bool, label: str):
    """Stage 1 + N_BATCHES batches through ``repro_torch.run.stages``;
    returns (records, store snapshots, pipeline)."""
    from repro_torch.run import Pipeline, stages

    t0 = time.perf_counter()
    pipe = Pipeline(config, "cuda", use_kernels=use_kernels)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    recs, snaps = [], []
    for d in stages(pipe, N_BATCHES):
        d["run"] = label
        if d["phase"] == "stage1":
            d["setup_seconds"] = setup_s
        emit(d)
        recs.append(d)
        snaps.append(store_snapshot(pipe.store))
    return recs, snaps, pipe


def timed_stage(fn):
    """``fn()`` timed on the host clock ending in a synchronize, with the
    peak device memory it reached: ``(result, seconds, peak_gib)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def small_batches(pipe, label: str, n: int = N_SMALL):
    """``n`` batches of 1 + 1 edges on the pipeline's current state, each
    with the partitions whose unit tables it listed again out of ``m``;
    returns their records and store snapshots."""
    from repro_torch.data.graphs import sample_update

    recs, snaps = [], []
    for i in range(n):
        upd = sample_update(pipe.graph, 1, 1, seed=SMALL_SEED + i)
        d, seconds, peak = timed_stage(lambda: {k: int(v) for k, v in pipe.apply(upd).items()})
        rec = {"phase": "small_batches", "run": label, "batch": i, **d,
               "partitions": pipe.config.m, "seconds": seconds, "peak_gib": peak}
        check(rec["overflow"] == 0, f"overflow in {rec}")
        emit(rec)
        recs.append(rec)
        snaps.append(store_snapshot(pipe.store))
    return recs, snaps


def storage_full_phase(pipe) -> None:
    """The pipeline's next 64 + 64 batch through the delta storage update
    and through the full-gather rebuild, from the same partitions (the
    pipeline itself is left as it is): equal partitions and ``part_dirty``,
    each mode's seconds, peak, resident GiB before it and
    ``set_intersect`` launches."""
    from repro_torch import sharded
    from repro_torch.kernels.set_intersect import set_intersect_cuda

    upd = pipe.next_update()
    add = torch.from_numpy(upd.add.astype("int32").reshape(-1, 2)).cuda()
    dele = torch.from_numpy(upd.delete.astype("int32").reshape(-1, 2)).cuda()
    out, rec = {}, {"phase": "storage_full", "n_add": add.shape[0], "n_del": dele.shape[0]}
    for mode in ("delta", "full"):
        step = sharded.make_storage_update_step(pipe.mesh, pipe.caps, pipe.ushapes, mode=mode)
        resident = torch.cuda.memory_allocated() / 2**30
        before = set_intersect_cuda.launches
        out[mode], seconds, peak = timed_stage(lambda: step(pipe.pt, add, dele))
        rec[mode] = {"seconds": seconds, "peak_gib": peak, "resident_gib": resident,
                     "set_intersect_launches": set_intersect_cuda.launches - before,
                     "overflow": int(out[mode][1]["overflow"]),
                     "stored_edges": int(out[mode][1]["stored_edges"]),
                     "dirty": int(out[mode][1]["part_dirty"].sum())}
    (pd, dd), (pf, df) = out["delta"], out["full"]
    rec["equal"] = all(torch.equal(getattr(pd, f), getattr(pf, f))
                       for f in ("vertices", "center", "deg", "adj", "edge_hi", "edge_lo"))
    rec["part_dirty_equal"] = torch.equal(dd["part_dirty"], df["part_dirty"])
    emit(rec)
    check(rec["equal"] and rec["part_dirty_equal"], "storage_full: full and delta partitions differ")
    check(rec["full"]["overflow"] == rec["delta"]["overflow"] == 0, "storage_full: overflow")
    check(rec["full"]["stored_edges"] == rec["delta"]["stored_edges"], "storage_full: edges")
    del out, pd, pf
    torch.cuda.empty_cache()


def multi_phase(single_snaps):
    """q1_square and q2_triangle in one megastep on WT~ (stage 1 and
    N_BATCHES batches with the kernels): the q1_square counts and store
    snapshots must equal the single-pattern run's at every stage, the
    q2_triangle counts ``WT_Q2_COUNTS``; then each pattern is listed from
    scratch on the final partitions and must equal its maintained count
    and store. Returns the q2_triangle count of each stage."""
    from repro_torch.run import WT_MULTI, Pipeline, stages

    pipe, setup_s, _ = timed_stage(lambda: Pipeline(WT_MULTI, "cuda"))
    emit({"phase": "plan", "run": "multi", "setup_seconds": setup_s, **pipe.describe()})
    q2_counts = []
    for i, d in enumerate(stages(pipe, N_BATCHES)):
        emit({**d, "stage": d["phase"], "phase": "multi"})
        check(d["overflow"] == 0, f"multi: overflow in {d}")
        q1 = d["patterns"]["q1_square"]
        check(q1["count"] == WT_COUNTS[i], f"multi: q1_square count {q1['count']} at stage {i}")
        check(snapshots_equal(store_snapshot(pipe.stores["q1_square"]), single_snaps[i]),
              f"multi: q1_square store differs from the single-pattern run at stage {i}")
        q2_counts.append(d["patterns"]["q2_triangle"]["count"])
        check(q2_counts[-1] == WT_Q2_COUNTS[i],
              f"multi: q2_triangle count {q2_counts[-1]} at stage {i} != {WT_Q2_COUNTS[i]}")
    final = {name: (pd["count"], store_snapshot(pipe.stores[name]))
             for name, pd in d["patterns"].items()}
    pipe.stores = pipe.carries = None
    torch.cuda.empty_cache()
    for name, (count, snap) in final.items():
        (astore, adiag), seconds, peak = timed_stage(lambda: pipe.list_pattern(name))
        audit = {k: int(v) for k, v in adiag.items()}
        emit({"phase": "multi_audit", "pattern": name, **audit, "maintained": count,
              "seconds": seconds, "peak_gib": peak})
        check(audit["overflow"] == 0 and audit["count"] == count,
              f"multi_audit {name}: count differs from the maintained count")
        check(snapshots_equal(store_snapshot(astore), snap),
              f"multi_audit {name}: store differs from the maintained store")
        del astore
        torch.cuda.empty_cache()
    del pipe
    torch.cuda.empty_cache()
    return q2_counts


# ---------------------------------------------------------------------------
# The service on a torch.distributed mesh
# ---------------------------------------------------------------------------

# One 64 + 64 update (two 64-op batches) a run: the phase's two runs took
# 97 s at two updates, most of it these batches (~9.8 s each). An update on
# the store the first one left (SERVICE_DELETE_COUNTS[1], WT_COUNTS[2]) is
# no longer run here; tests/test_torch_mesh_dist.py runs three updates of
# the service on a ProcessMesh (gloo, world 2), and
# examples/torch_distributed_listing.py three batches on four cards.
MESH_UPDATES = 1


def mesh_service_run(mesh, label: str):
    """``ListingService(backend="sharded")`` over WT~ / q1_square at m = 8
    (``run.WT_Q1``'s caps, 64 + 64 updates committed as batches of 64 ops,
    the seeds of ``service``), on ``mesh`` (a ``ProcessMesh``) or on the
    backend's own ``LocalMesh`` (None): stage 1, then MESH_UPDATES updates,
    one ``advance`` a 64-op batch. Returns the per-stage records and store
    snapshots (stage 1, then every batch) and the DDSL kernels' launches
    over the batches."""
    from repro_torch.core.pattern import PATTERN_LIBRARY
    from repro_torch.data.graphs import rmat_graph, sample_update
    from repro_torch.kernels import ops
    from repro_torch.run import WT_Q1 as c
    from repro_torch.stream import BatchScheduler, ListingService

    graph = rmat_graph(c.n_log2, c.n_edges, seed=c.graph_seed)
    kw = {} if mesh is None else {"mesh": mesh}

    def stage1():
        svc = ListingService(graph, backend="sharded", m=c.m, caps=config_caps(c),
                             max_add=c.n_add, max_del=c.n_del, executor=c.executor,
                             scheduler=BatchScheduler(min_ops=64, max_ops=64), **kw)
        svc.register("q1_square", PATTERN_LIBRARY["q1_square"])
        return svc

    svc, seconds, peak = timed_stage(stage1)
    store = lambda: svc.backend.entries["q1_square"].store  # noqa: E731
    recs = [{"phase": "mesh", "run": label, "stage": "stage1", "count": svc.count("q1_square"),
             "seconds": seconds, "peak_gib": peak}]
    snaps = [store_snapshot(store())]
    for b in range(MESH_UPDATES):
        svc.ingest(sample_update(svc.projected_graph(), c.n_del, c.n_add,
                                 seed=c.update_seed + b))
    ops.reset_launch_counts()
    if mesh is not None:
        mesh.reset_counts()
    for i in range(2 * MESH_UPDATES):
        (bm,), seconds, peak = timed_stage(lambda: svc.advance(64 * (i + 1)))
        rec = {"phase": "mesh", "run": label, "stage": "batch", "batch": i, "hi": bm.hi,
               "count": bm.patterns["q1_square"].count_after, "seconds": seconds,
               "latency_s": bm.latency_s, "peak_gib": peak, "overflow": bm.overflow,
               "storage_overflow": bm.storage_overflow, "host_bytes": bm.host_bytes}
        if mesh is not None:
            rec["collective_calls"] = dict(mesh.calls)
            rec["collective_bytes"] = dict(mesh.bytes)
            mesh.reset_counts()
        recs.append(rec)
        snaps.append(store_snapshot(store()))
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    if mesh is not None:
        recs[-1]["agree_checks"] = svc.backend.agree_checks
    del svc
    free_device_memory()
    return recs, snaps, launches


def mesh_collectives(mesh) -> dict:
    """The collectives of ``repro_torch.dist`` at world 1 on NCCL (one
    partition a rank) against the same functions on a ``LocalMesh(1)``, on
    the inputs of tests/spmd/run_collectives.py for one device."""
    from repro_torch.dist import (bucketed_all_to_all, butterfly_compressed_all_reduce,
                                  ring_all_reduce, routed_exchange)
    from repro_torch.mesh import LocalMesh

    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(0, 1000, (32, 2)).astype(np.int32)).cuda()
    targets = torch.zeros(32, dtype=torch.int32, device="cuda")
    valid = torch.from_numpy(rng.random(32) < 0.8).cuda()
    x = torch.from_numpy(rng.normal(size=16).astype(np.float32)).cuda()

    def run(m):
        out = {}
        for cap in (32, 3):
            rec, rv, ovf = bucketed_all_to_all([[rows]], [targets], [valid], m, cap)
            out[f"a2a_{cap}"] = (rec[0][0], rv[0], ovf)
            rec, rv, restore, ovf = routed_exchange([[rows]], [targets], [valid], m, cap)
            out[f"routed_{cap}"] = (rec[0][0], rv[0], restore([rec[0][0] * 2])[0], ovf)
        out["ring"] = (ring_all_reduce([x], m)[0],)
        out["butterfly"] = (butterfly_compressed_all_reduce([x], m)[0],)
        return out

    got, want = run(mesh), run(LocalMesh(1))
    equal = {k: all(torch.equal(a, b) for a, b in zip(got[k], want[k])) for k in want}
    overflow = {cap: int(want[f"a2a_{cap}"][2]) for cap in (32, 3)}
    restored = bool(torch.equal(got["routed_32"][2], torch.where(valid[:, None], rows * 2, 0)))
    return {"equal": equal, "overflow_by_capacity": overflow, "restored": restored}


def mesh_phase():
    """``mesh``: the service of ``mesh_service_run`` on a
    ``repro_torch.mesh.ProcessMesh`` of 8 partitions on one NCCL rank (a
    process group of world size 1 started here: two NCCL ranks cannot share
    a card), against the same run on the backend's ``LocalMesh``: counts
    ``WT_COUNTS`` / ``SERVICE_DELETE_COUNTS`` at every watermark, overflow
    and host bytes 0, every store snapshot equal, the collectives' calls and
    bytes per batch; then the collectives of ``repro_torch.dist`` at world 1
    against a ``LocalMesh(1)``. Returns the DDSL kernels' launches over the
    process mesh's batches."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.mesh import ProcessMesh

    t_phase = time.perf_counter()
    ref_recs, ref_snaps, _ = mesh_service_run(None, "local")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    t0 = time.perf_counter()
    mesh = init_process_mesh(8, "cuda", timeout_s=300)
    init_s = time.perf_counter() - t0
    try:
        check(dist.get_backend() == "nccl" and mesh.world == 1 and mesh.local == 8,
              f"mesh: backend {dist.get_backend()}, world {mesh.world}, local {mesh.local}")
        recs, snaps, launches = mesh_service_run(mesh, "process")
        coll = mesh_collectives(ProcessMesh(1, mesh.device))
    finally:
        dist.destroy_process_group()
    want = [WT_COUNTS[0]] + [v for k in range(MESH_UPDATES) for v in (
        SERVICE_DELETE_COUNTS["q1_square"][k], WT_COUNTS[k + 1])]
    for i, (rec, ref) in enumerate(zip(recs, ref_recs)):
        rec["store_equal_local"] = snapshots_equal(snaps[i], ref_snaps[i])
        emit(ref)
        emit(rec)
        check(rec["count"] == ref["count"] == want[i],
              f"mesh: counts {rec['count']} / {ref['count']} at stage {i} != {want[i]}")
        check(rec["store_equal_local"], f"mesh: the store differs from LocalMesh's at stage {i}")
        check(rec.get("overflow", 0) == rec.get("host_bytes", 0) == 0, f"mesh: {rec}")
        if i:
            check(rec["collective_calls"].get("all_gather", 0) > 0
                  and rec["collective_calls"].get("all_reduce", 0) > 0,
                  f"mesh: batch {i} made no NCCL collective: {rec['collective_calls']}")
    check(recs[-1]["agree_checks"] == 1 + 2 * MESH_UPDATES, f"mesh: {recs[-1]}")
    for k in DDSL_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the mesh path")
    emit({"phase": "mesh", "launches": launches, "backend": "nccl", "world": 1, "m": 8,
          "init_process_group_s": init_s, "collectives": coll,
          "seconds": time.perf_counter() - t_phase})
    check(all(coll["equal"].values()) and coll["restored"]
          and coll["overflow_by_capacity"][32] == 0 and coll["overflow_by_capacity"][3] > 0,
          f"mesh: collectives {coll}")
    return launches


# ---------------------------------------------------------------------------
# The generic-join (WCOJ) executor
# ---------------------------------------------------------------------------

WCOJ_COUNTS = {"q6_clique5": WT_K5_COUNTS, "q4_clique4": WT_K4_COUNTS}


def snapshots(pipe):
    return {name: store_snapshot(st) for name, st in pipe.stores.items()}


def as_ints(d):
    return {k: as_ints(v) if isinstance(v, dict) else int(v) for k, v in d.items()}


def drive_wcoj(config, use_kernels: bool, label: str):
    """Stage 1 + N_BATCHES batches of ``config`` (WT~, q6_clique5 and
    q4_clique4 by the generic join) through ``repro_torch.run.stages``:
    every stage's counts ``WCOJ_COUNTS``, overflow 0 and ``unit_refreshes``
    0. Returns (records, per-pattern store snapshots, pipeline)."""
    from repro_torch.run import Pipeline, stages

    pipe, setup_s, _ = timed_stage(lambda: Pipeline(config, "cuda", use_kernels=use_kernels))
    emit({"phase": "wcoj_plan", "run": label, "setup_seconds": setup_s, **pipe.describe()})
    for name, pp in pipe.plans.items():
        check(pp.executor == "wcoj", f"wcoj_plan: {name} is not on the generic join")
    recs, snaps = [], []
    for i, d in enumerate(stages(pipe, N_BATCHES)):
        d.update(stage=d["phase"], phase="wcoj", run=label)
        emit(d)
        check(d["overflow"] == 0, f"wcoj {label}: overflow in {d}")
        for name, want in WCOJ_COUNTS.items():
            pd = d["patterns"][name]
            check(pd["count"] == want[i], f"wcoj {label}: {name} count {pd['count']} at "
                  f"stage {i} != {want[i]}")
            check(i == 0 or pd["unit_refreshes"] == 0, f"wcoj {label}: {name} refreshed")
        recs.append(d)
        snaps.append(snapshots(pipe))
    return recs, snaps, pipe


def wcoj_profile(pipe):
    """The next batch (seed 103) under ``torch.profiler``: device time by
    kernel, ``member_probe``'s seconds and launches, the idle share; counts
    the last of ``WCOJ_COUNTS``."""
    upd = pipe.next_update()
    d, prof = profiled(lambda: as_ints(pipe.apply(upd)), DDSL_KERNELS)
    emit({"phase": "wcoj_profile", "update_seed": pipe.config.update_seed + pipe.batches - 1,
          **d, **prof})
    check(d["overflow"] == 0, f"wcoj_profile: overflow in {d}")
    for name, want in WCOJ_COUNTS.items():
        check(d["patterns"][name]["count"] == want[-1],
              f"wcoj_profile: {name} count {d['patterns'][name]['count']} != {want[-1]}")
    return d


@contextlib.contextmanager
def probe_spy(e_cap: int):
    """Wraps ``ops.member_probe`` while the block runs; the dict it yields
    gets a copy of the inputs of the widest call against a partition's edge
    table (``e_cap`` rows): the largest level of the generic join, the
    ``[level_caps[i-1] x deg_cap]`` queries, or a join tree's largest edge
    check. (The storage update's probes go against its drop table, the
    delete filter's against the delete table.) The calls go on to the
    kernel and count as the path's launches."""
    from repro_torch.kernels import ops

    inner, widest = ops.member_probe, {}

    def spy(q_hi, q_lo, t_hi, t_lo, *, use_kernels):
        if t_hi.shape[0] == e_cap and q_hi.numel() > widest.get("n", -1):
            widest.update(n=q_hi.numel(), args=tuple(t.clone() for t in (q_hi, q_lo, t_hi, t_lo)))
        return inner(q_hi, q_lo, t_hi, t_lo, use_kernels=use_kernels)

    ops.member_probe = spy
    try:
        yield widest
    finally:
        ops.member_probe = inner


@contextlib.contextmanager
def ccjoin_spy():
    """Wraps ``ops.set_intersect`` while the block runs; the dict it yields
    gets a copy of the inputs of its widest call (``a``'s values), a tree
    listing's CC-join. The calls go on to the kernel and count as the
    path's launches."""
    from repro_torch.kernels import ops

    inner, widest = ops.set_intersect, {}

    def spy(a, b, *, pad, use_kernels):
        if a.numel() > widest.get("n", -1):
            widest.update(n=a.numel(), args=(a.contiguous().clone(), b.contiguous().clone(), pad))
        return inner(a, b, pad=pad, use_kernels=use_kernels)

    ops.set_intersect = spy
    try:
        yield widest
    finally:
        ops.set_intersect = inner


def widest_probe(pipe):
    """The next batch under :func:`probe_spy`: its diag and the inputs of
    its widest level probe."""
    upd = pipe.next_update()
    with probe_spy(pipe.caps.e_cap) as widest:
        d = pipe.apply(upd)
    return d, widest["args"]


def level_probe_case(case: str, args, **launches):
    """``member_probe`` on the inputs of a call the main path made (a
    level or edge-check probe against one partition's edge table): against
    its plain version, timed one call at a time and 20 in a row, beside
    ``torch.isin`` on packed keys and the byte bound; ``launches`` are the
    kernel's launches on the paths that make such calls."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.member_probe import member_probe_cuda, probe_stride

    q_hi, q_lo, t_hi, t_lo = args
    n, m_rows = q_hi.shape[0], t_hi.shape[0]
    got = member_probe_cuda(*args)
    want = ref.member_probe_ref(*args)
    torch.cuda.synchronize()
    err = int((got != want).sum())
    check(err == 0, f"member_probe {case}: {err} mismatches")
    check(torch.equal(got, member_probe_cuda(*args)), f"member_probe {case}: not repeatable")
    lib = probe_library(*args)
    rec = {"case": case, "n": n, "m": m_rows, "stride": probe_stride(m_rows, n),
           "offset": 0, "equal": True, "max_abs_err": max_abs_err(got, want),
           "live_queries": int(((q_hi != -1) | (q_lo != -1)).sum()),
           "table_rows": int(((t_hi != -1) | (t_lo != -1)).sum()), "hits": int(want.sum()),
           "ms": cuda_ms(lambda: member_probe_cuda(*args)),
           "ms_back_to_back": cuda_ms(lambda: member_probe_cuda(*args), per=20),
           "plain_ms": cuda_ms(lambda: ref.member_probe_ref(*args), reps=3),
           "library_equal": torch.equal(lib(), want), "library_ms": cuda_ms(lib, reps=3),
           "library_ms_back_to_back": cuda_ms(lib, per=20), **launches}
    rec["bound_ms"], rec["bound_by"] = bound_ms(9.0 * n + 8.0 * m_rows,
                                                n * math.ceil(math.log2(m_rows + 1)))
    check(rec["library_equal"], f"member_probe {case}: the library call differs")
    return rec


def wcoj_phase(single_snaps, multi_q2_counts):
    """The generic-join executor on WT~ (``wcoj_plan``, ``wcoj``,
    ``wcoj_profile``, ``wcoj_audit``, ``wcoj_plain``, ``multi_auto``).
    Returns the DDSL kernels' launches on the WCOJ path and on the mixed
    path, and the ``wcoj_level`` kernel case."""
    from repro_torch.kernels import ops
    from repro_torch.run import WT_CLIQUE

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    recs_k, snaps_k, pipe = drive_wcoj(WT_CLIQUE, True, "kernels")
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    for k in DDSL_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the WCOJ path")
    final = wcoj_profile(pipe)
    final_snaps = snapshots(pipe)
    emit({"phase": "wcoj", "run": "kernels", "launches": launches,
          "seconds": time.perf_counter() - t_phase})

    # audit: list both patterns from scratch on the final partitions
    t0 = time.perf_counter()
    pipe.stores = pipe.carries = None
    torch.cuda.empty_cache()
    for name in WCOJ_COUNTS:
        (astore, adiag), seconds, peak = timed_stage(lambda: pipe.list_pattern(name))
        audit = {k: int(v) for k, v in adiag.items()}
        maintained = final["patterns"][name]["count"]
        emit({"phase": "wcoj_audit", "pattern": name, **audit, "maintained": maintained,
              "seconds": seconds, "peak_gib": peak})
        check(audit["overflow"] == 0 and audit["count"] == maintained,
              f"wcoj_audit {name}: count differs from the maintained count")
        check(snapshots_equal(store_snapshot(astore), final_snaps[name]),
              f"wcoj_audit {name}: store differs from the maintained store")
        del astore
    del pipe
    torch.cuda.empty_cache()
    emit({"phase": "wcoj_audit", "seconds": time.perf_counter() - t0})

    # the plain path on the card: the same counts and store tensors at every
    # stage; its profiled batch also hands over the widest level probe
    t0 = time.perf_counter()
    recs_p, snaps_p, pipe = drive_wcoj(WT_CLIQUE, False, "plain")
    for i, (a, b) in enumerate(zip(snaps_k, snaps_p)):
        for name in WCOJ_COUNTS:
            check(snapshots_equal(a[name], b[name]), f"wcoj_plain: {name} store differs at "
                  f"stage {i}")
    d, probe_args = widest_probe(pipe)
    for name in WCOJ_COUNTS:
        check(int(d["patterns"][name]["count"]) == final["patterns"][name]["count"],
              f"wcoj_plain: {name} profiled-batch count differs")
        check(snapshots_equal(store_snapshot(pipe.stores[name]), final_snaps[name]),
              f"wcoj_plain: {name} profiled-batch store differs")
    del pipe
    torch.cuda.empty_cache()
    emit({"phase": "wcoj_plain", "equal": True, "steps": len(recs_p) + 1,
          "seconds": time.perf_counter() - t0})
    case = level_probe_case("wcoj_level", probe_args, launches_wcoj=launches["member_probe"])
    del probe_args
    emit({"phase": "kernel_check", "member_probe": [case]})
    torch.cuda.empty_cache()
    return (launches, *multi_auto_phase(single_snaps, multi_q2_counts), case)


def multi_auto_phase(single_snaps, multi_q2_counts):
    """``WT_MULTI_AUTO``: q1_square on its join tree and q2_triangle on the
    generic join in one megastep, stage 1 and N_BATCHES batches with the
    kernels. At every stage the q1_square store must equal the
    single-pattern run's, and the q2_triangle counts ``WT_Q2_COUNTS`` and
    the tree executor's counts in the ``multi`` phase. Returns the DDSL
    kernels' launches on this path, each stage's store snapshots of both
    patterns and its record."""
    from repro_torch.kernels import ops
    from repro_torch.run import WT_MULTI_AUTO, Pipeline, stages

    t_phase = time.perf_counter()
    pipe, setup_s, _ = timed_stage(lambda: Pipeline(WT_MULTI_AUTO, "cuda"))
    emit({"phase": "plan", "run": "multi_auto", "setup_seconds": setup_s, **pipe.describe()})
    check(pipe.plans["q1_square"].executor == "tree"
          and pipe.plans["q2_triangle"].executor == "wcoj",
          "multi_auto: expected q1_square on the tree and q2_triangle on the generic join")
    ops.reset_launch_counts()
    snaps, recs = [], []
    for i, d in enumerate(stages(pipe, N_BATCHES)):
        emit({**d, "stage": d["phase"], "phase": "multi_auto"})
        snaps.append(snapshots(pipe))
        recs.append(d)
        check(d["overflow"] == 0, f"multi_auto: overflow in {d}")
        q1, q2 = d["patterns"]["q1_square"], d["patterns"]["q2_triangle"]
        check(q1["count"] == WT_COUNTS[i], f"multi_auto: q1_square count {q1['count']}")
        check(snapshots_equal(store_snapshot(pipe.stores["q1_square"]), single_snaps[i]),
              f"multi_auto: q1_square store differs from the single-pattern run at stage {i}")
        check(q2["count"] == WT_Q2_COUNTS[i] == multi_q2_counts[i],
              f"multi_auto: q2_triangle count {q2['count']} at stage {i}: tree "
              f"{multi_q2_counts[i]}, host {WT_Q2_COUNTS[i]}")
        check(i == 0 or q2["unit_refreshes"] == 0, "multi_auto: the WCOJ slot refreshed")
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    for k in DDSL_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the mixed path")
    emit({"phase": "multi_auto", "launches": launches, "q2_tree_counts": multi_q2_counts,
          "seconds": time.perf_counter() - t_phase})
    pipe.stores = pipe.carries = None
    del pipe
    torch.cuda.empty_cache()
    return launches, snaps, recs


# ---------------------------------------------------------------------------
# The streaming service's device backend (TorchBackend)
# ---------------------------------------------------------------------------

BACKEND_PATTERNS = ("q1_square", "q2_triangle")
CAP_FIELDS = ("v_cap", "deg_cap", "e_cap", "match_cap", "group_cap", "set_cap", "pair_cap")


def config_caps(config):
    from repro_torch.engine import EngineCaps

    return EngineCaps(**{f: getattr(config, f) for f in CAP_FIELDS})


def shared_delta(update, lo: int):
    """The service's per-batch delta for ``update`` as the ops [lo, hi)."""
    from repro_torch.stream import SharedDelta

    return SharedDelta(lo=lo, hi=lo + update.size, update=update,
                       add_codes=update.add_codes(), delete_codes=update.delete_codes())


def backend_record(be, reps, seconds: float, peak: float) -> dict:
    """One backend stage: counts, seconds, peak, host bytes, candidate
    counters, overflow, resizes and fallbacks; from the backend's spans
    (its tracer is on) the storage update's and the megastep's seconds, the
    rest of ``seconds`` as ``bookkeeping_s``, and each pattern's
    ``unit_refreshes``."""
    spans = be.obs.tracer.drain()
    took = {name: sum(sp.dur_s for sp in spans if sp.name == name)
            for name in ("storage_update", "maintain_mega")}
    return {"counts": {n: be.count(n) for n in be.names()}, "seconds": seconds,
            "peak_gib": peak, "last_host_bytes": be.last_host_bytes,
            "cand_vertices": be.last_cand_vertices, "cand_edges": be.last_cand_edges,
            "overflow": be.last_storage_overflow + sum(r.overflow for r in reps.values()),
            "unit_refreshes": {sp.attrs["pattern"]: sp.counters["unit_refreshes"]
                               for sp in spans if sp.name == "maintain"},
            "storage_update_s": took["storage_update"], "maintain_mega_s": took["maintain_mega"],
            "bookkeeping_s": seconds - sum(took.values()) if reps else None,
            "store_resizes": be.store_resizes, "cap_fallbacks": be.cap_fallbacks}


def check_backend(be, rec: dict, i: int, label: str) -> None:
    got = (rec["counts"]["q1_square"], rec["counts"]["q2_triangle"])
    check(got == (WT_COUNTS[i], WT_Q2_COUNTS[i]),
          f"{label}: counts {got} at stage {i} != {(WT_COUNTS[i], WT_Q2_COUNTS[i])}")
    check(rec.get("overflow", 0) == 0 and be.store_resizes == 0 and be.cap_fallbacks == 0,
          f"{label}: overflow, store resize or cap fallback in {rec}")


def doctored_maintain(be, name: str, extra: int, store_extra: int):
    """The backend's megastep, reporting ``extra`` more overflow (and
    ``store_extra`` more store overflow) for ``name``: the seam the
    service's overflow tests use."""
    orig = be.maintain_step

    def step(pt2, stores, carries, dirty, add, dele):
        stores2, patches, carries2, diag = orig(pt2, stores, carries, dirty, add, dele)
        d = dict(diag[name])
        d["overflow"] = d["overflow"] + extra
        d["store_overflow"] = d["store_overflow"] + store_extra
        return stores2, patches, carries2, {**diag, name: d}

    return step


def backend_phase(auto_snaps, auto_recs):
    """``backend``: ``TorchBackend`` over ``run.WT_MULTI_AUTO``'s deployment
    (WT~, m = 8, WT_Q1's caps, 64 + 64 batches, executor="auto", the
    kernels on): q1_square and q2_triangle registered (tree and generic
    join), then N_BATCHES batches, each wrapped in a ``SharedDelta``. Counts
    ``WT_COUNTS`` / ``WT_Q2_COUNTS``, overflow, store resizes and cap
    fallbacks 0, stores equal to ``multi_auto``'s at every stage and the
    candidate counters to its storage step's. Then ``backend_materialize``
    and ``backend_restore``. Returns the DDSL kernels' launches over the
    batches."""
    from repro_torch.backend import TorchBackend
    from repro_torch.core.pattern import PATTERN_LIBRARY
    from repro_torch.data.graphs import rmat_graph, sample_update
    from repro_torch.kernels import ops
    from repro_torch.obs import Observability
    from repro_torch.run import WT_MULTI_AUTO as c

    t_phase = time.perf_counter()
    graph = rmat_graph(c.n_log2, c.n_edges, seed=c.graph_seed)

    def stage1():
        be = TorchBackend(graph, m=c.m, caps=config_caps(c), max_add=c.n_add,
                          max_del=c.n_del, executor=c.executor)
        be.obs = Observability.full()   # spans time each step of a batch
        for name in BACKEND_PATTERNS:
            be.register(name, PATTERN_LIBRARY[name])
        return be

    be, seconds, peak = timed_stage(stage1)
    rec = backend_record(be, {}, seconds, peak)
    rec["executors"] = {n: be.plan(n).executor for n in BACKEND_PATTERNS}
    rec["store_caps"] = {n: dataclasses.asdict(be.entries[n].store_caps)
                         for n in BACKEND_PATTERNS}
    emit({"phase": "backend", "stage": "stage1", **rec})
    check(rec["executors"] == {"q1_square": "tree", "q2_triangle": "wcoj"},
          f"backend: executors {rec['executors']}")
    check_backend(be, rec, 0, "backend")

    def same_stores(i: int) -> None:
        for n in BACKEND_PATTERNS:
            check(snapshots_equal(store_snapshot(be.entries[n].store), auto_snaps[i][n]),
                  f"backend: {n} store differs from multi_auto's at stage {i}")

    same_stores(0)
    ops.reset_launch_counts()
    lo = 0
    for b in range(N_BATCHES):
        upd = sample_update(be.graph, c.n_del, c.n_add, seed=c.update_seed + b)
        delta = shared_delta(upd, lo)
        lo = delta.hi
        reps, seconds, peak = timed_stage(lambda: be.apply_batch(delta, set()))
        rec = backend_record(be, reps, seconds, peak)
        emit({"phase": "backend", "stage": "batch", "batch": b, **rec})
        check_backend(be, rec, b + 1, "backend")
        want = auto_recs[b + 1]
        check(rec["unit_refreshes"] == {n: want["patterns"][n]["unit_refreshes"]
                                        for n in BACKEND_PATTERNS},
              f"backend: unit_refreshes {rec['unit_refreshes']} differ from multi_auto's")
        check((rec["cand_vertices"], rec["cand_edges"]) == (want["cand_vertices"],
                                                            want["cand_edges"]),
              f"backend: candidate counters differ from multi_auto's at batch {b}")
        check(rec["last_host_bytes"] == 0, "backend: a count-only batch pulled match bytes")
        same_stores(b + 1)
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    for k in DDSL_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the backend path")
    emit({"phase": "backend", "launches": launches, "seconds": time.perf_counter() - t_phase})
    backend_materialize(be)
    backend_restore(be, lo)
    del be
    torch.cuda.empty_cache()
    return launches


def backend_materialize(be) -> None:
    """``backend_materialize``: both running match sets pulled to the host
    (valid prefix only); q2_triangle's rows equal the host generic join's on
    the backend's graph, q1_square's row count its maintained count."""
    from repro_torch.core.match_engine import list_matches_wcoj

    t0 = time.perf_counter()
    rec = {"phase": "backend_materialize"}
    for name in BACKEND_PATTERNS:
        b0 = be.total_host_bytes
        table, seconds, _ = timed_stage(lambda: be.materialize(name))
        rec[name] = {"seconds": seconds, "host_bytes": be.total_host_bytes - b0,
                     "groups": table.n_groups}
    meta = be.meta("q2_triangle")
    cols, rows = be.materialize("q2_triangle").decompress(meta.ord_)
    wcols, want = list_matches_wcoj(be.graph, meta.pattern, meta.ord_)
    want = want[:, [list(wcols).index(c) for c in cols]]
    same = set(map(tuple, rows.tolist())) == set(map(tuple, want.tolist()))
    meta1 = be.meta("q1_square")
    rows1 = be.materialize("q1_square").decompress(meta1.ord_)[1]
    distinct = np.unique(rows1, axis=0).shape[0]
    rec.update(q2_rows=int(rows.shape[0]), q2_host_rows=int(want.shape[0]), q2_equal=same,
               q1_rows=int(rows1.shape[0]), q1_distinct=int(distinct),
               q1_maintained=be.count("q1_square"), seconds=time.perf_counter() - t0)
    emit(rec)
    check(same and rows.shape[0] == be.count("q2_triangle"),
          "backend_materialize: q2_triangle rows differ from the host generic join's")
    check(rows1.shape[0] == distinct == be.count("q1_square"),
          "backend_materialize: q1_square rows differ from its maintained count")


def backend_restore(be, lo: int) -> None:
    """``backend_restore``: q2_triangle removed and restored from its
    materialized table; q1_square removed and installed with its own plan
    and table at the same watermark (the carry stash reused); then the batch
    with seed ``update_seed + N_BATCHES``, whose counts are ``WT_COUNTS[4]``
    and ``WT_Q2_COUNTS[4]``."""
    from repro_torch.data.graphs import sample_update
    from repro_torch.run import WT_MULTI_AUTO as c

    t0 = time.perf_counter()
    metrics = be._obs().metrics
    table2, meta2 = be.materialize("q2_triangle"), be.meta("q2_triangle")
    be.remove_pattern("q2_triangle")
    n2, s2, _ = timed_stage(lambda: be.restore_pattern("q2_triangle", meta2.pattern,
                                                       meta2.cover, table2))
    plan1, table1 = be.plan("q1_square"), be.materialize("q1_square")
    reuses0 = metrics.counter("plan_swap_carry_reuses_total").value
    be.remove_pattern("q1_square")
    n1, s1, peak = timed_stage(lambda: be.install_plan("q1_square", plan1, table1))
    reuses = metrics.counter("plan_swap_carry_reuses_total").value - reuses0
    be.obs.tracer.drain()   # the materialize spans
    emit({"phase": "backend_restore", "stage": "restore", "q2_restore_seconds": s2,
          "q1_install_seconds": s1, "peak_gib": peak, "counts": {"q1_square": n1,
                                                                   "q2_triangle": n2},
          "q2_executor": be.plan("q2_triangle").executor, "carry_reuses": reuses})
    check((n1, n2) == (WT_COUNTS[N_BATCHES], WT_Q2_COUNTS[N_BATCHES]),
          f"backend_restore: restored counts {(n1, n2)}")
    check(reuses == 1, "backend_restore: the q1_square carry was not reused")
    upd = sample_update(be.graph, c.n_del, c.n_add, seed=c.update_seed + N_BATCHES)
    delta = shared_delta(upd, lo)
    reps, seconds, peak = timed_stage(lambda: be.apply_batch(delta, set()))
    rec = backend_record(be, reps, seconds, peak)
    emit({"phase": "backend_restore", "stage": "batch", **rec,
          "phase_seconds": time.perf_counter() - t0})
    check_backend(be, rec, N_BATCHES + 1, "backend_restore")


def backend_resize_phase() -> None:
    """``backend_resize``: ``TorchBackend`` on the example graph
    (``run.EXAMPLE_Q1``), q1_square, its megastep wrapped once to report a
    store overflow: the stores are rebuilt from the partitions with doubled
    caps and the batch retried (``store_resizes`` 1), and the counts stay
    ``EXAMPLE_COUNTS``. Then a strict backend under a reported overflow
    raises before it commits (partitions unchanged) and replays the batch."""
    from repro_torch.backend import TorchBackend
    from repro_torch.core.pattern import PATTERN_LIBRARY
    from repro_torch.data.graphs import rmat_graph, sample_update
    from repro_torch.run import EXAMPLE_Q1 as c

    t0 = time.perf_counter()
    graph = rmat_graph(c.n_log2, c.n_edges, seed=c.graph_seed)
    want = EXAMPLE_COUNTS["q1_square"]

    def build(strict: bool):
        be = TorchBackend(graph, m=c.m, caps=config_caps(c), max_add=c.n_add,
                          max_del=c.n_del, strict_overflow=strict)
        check(be.register("q1_square", PATTERN_LIBRARY["q1_square"]) == want[0],
              "backend_resize: stage-1 count")
        return be

    be = build(False)
    e = be.entries["q1_square"]
    caps0 = (e.store_caps.group_cap, e.store_caps.set_cap)
    be.maintain_step = doctored_maintain(be, "q1_square", extra=3, store_extra=3)
    counts, lo = [want[0]], 0
    for b in range(N_BATCHES):
        upd = sample_update(be.graph, c.n_del, c.n_add, seed=c.update_seed + b)
        delta = shared_delta(upd, lo)
        lo = delta.hi
        reps = be.apply_batch(delta, set())
        check(reps["q1_square"].overflow == 0, "backend_resize: overflow after the resize")
        counts.append(be.count("q1_square"))
    caps1 = (e.store_caps.group_cap, e.store_caps.set_cap)
    rec = {"phase": "backend_resize", "counts": counts, "store_resizes": be.store_resizes,
           "store_caps": [caps0, caps1]}
    check(be.store_resizes == 1 and caps1 == (2 * caps0[0], 2 * caps0[1]),
          f"backend_resize: {be.store_resizes} resizes, caps {caps0} -> {caps1}")
    check(tuple(counts) == want, f"backend_resize: counts {counts} != {list(want)}")
    del be

    be = build(True)
    pt0 = {f.name: getattr(be.pt, f.name).clone() for f in dataclasses.fields(be.pt)}
    orig = be.maintain_step
    be.maintain_step = doctored_maintain(be, "q1_square", extra=3, store_extra=0)
    delta = shared_delta(sample_update(be.graph, c.n_del, c.n_add, seed=c.update_seed), 0)
    try:
        be.apply_batch(delta, set())
        raised = False
    except RuntimeError:
        raised = True
    unchanged = all(torch.equal(getattr(be.pt, k), v) for k, v in pt0.items())
    kept = be.count("q1_square")
    be.maintain_step = orig
    be.apply_batch(delta, set())
    rec.update(strict_raised=raised, strict_partitions_unchanged=unchanged,
               strict_count_kept=kept, strict_replayed=be.count("q1_square"),
               seconds=time.perf_counter() - t0)
    emit(rec)
    check(raised and unchanged and kept == want[0] and be.count("q1_square") == want[1],
          f"backend_resize: the strict backend did not abort and replay cleanly: {rec}")
    del be
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The streaming service's front door (repro_torch.stream.ListingService)
# ---------------------------------------------------------------------------

def free_device_memory() -> None:
    """Collect reference cycles, then return the cached blocks to the card:
    a backend's wrapped steps hold bound methods of it, so ``del`` alone
    leaves its stores allocated until the collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def service_trace(svc, apply_s, step_log):
    """Per committed batch: a ``CallbackSink`` recording the peak device
    memory since the last batch and the scheduler's drift, and into
    ``step_log[batch]`` each profiled step's ``(calls, last_execute_s)``;
    and a wrapper of the backend's ``apply_batch`` recording its seconds
    into ``apply_s``."""
    from repro_torch.stream import CallbackSink

    seen = {}

    def on_event(ev):
        if ev.batch_index not in seen:
            seen[ev.batch_index] = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                                    "drift": svc.scheduler.drift(),
                                    "last_drift": svc.scheduler.last_drift}
            step_log[ev.batch_index] = {n: (r.calls, r.last_execute_s)
                                        for n, r in svc.obs.jaxprof.steps.items()}
            torch.cuda.reset_peak_memory_stats()

    apply_batch = svc.backend.apply_batch

    def timed_apply(delta, want):
        t0 = time.perf_counter()
        out = apply_batch(delta, want)
        apply_s.append(time.perf_counter() - t0)
        return out

    svc.backend.apply_batch = timed_apply
    svc.subscribe(CallbackSink(on_event))
    return seen


def service_phase():
    """``service``: the port's ``ListingService(graph, backend="sharded")``
    over ``run.WT_MULTI_AUTO``'s deployment (WT~, m = 8, WT_Q1's caps, 64 +
    64 updates, executor="auto", the kernels on), q1_square and q2_triangle
    registered through the service, a ``BatchScheduler(min_ops=64,
    max_ops=64)``, a ``CountDeltaSink`` and ``Observability.full()``. The
    N_BATCHES updates of ``backend`` are ingested, then one ``advance()``
    commits them as 6 batches of 64 deletions or 64 insertions. Counts at
    watermarks 128, 256, 384 are ``WT_COUNTS`` / ``WT_Q2_COUNTS``, at 64,
    192, 320 ``SERVICE_DELETE_COUNTS``; every batch has 64 ops and no
    overflow or host bytes; the sink's deltas add up to the final counts.
    Per batch: latency, the storage update's and the megastep's seconds,
    the service's own host seconds (the batch's span less the backend's
    ``apply_batch``), the prediction, drift and peak. Then ``svc.audit()``
    (the host ``DDSL`` at m = 4 on the committed graph), timed. Returns the
    DDSL kernels' launches over the advance."""
    from repro_torch.core.pattern import PATTERN_LIBRARY
    from repro_torch.data.graphs import rmat_graph, sample_update
    from repro_torch.kernels import ops
    from repro_torch.obs import Observability
    from repro_torch.run import WT_MULTI_AUTO as c
    from repro_torch.stream import BatchScheduler, CountDeltaSink, ListingService

    free_device_memory()   # backend_phase's TorchBackend: one deployment fits the card
    allocated = torch.cuda.memory_allocated() / 2**30
    t_phase = time.perf_counter()
    graph = rmat_graph(c.n_log2, c.n_edges, seed=c.graph_seed)

    def stage1():
        svc = ListingService(graph, backend="sharded", m=c.m, caps=config_caps(c),
                             max_add=c.n_add, max_del=c.n_del, executor=c.executor,
                             scheduler=BatchScheduler(min_ops=64, max_ops=64),
                             obs=Observability.full())
        for name in BACKEND_PATTERNS:
            svc.register(name, PATTERN_LIBRARY[name])
        return svc

    svc, seconds, peak = timed_stage(stage1)
    counts = svc.counts()
    executors = {n: svc.backend.plan(n).executor for n in BACKEND_PATTERNS}
    emit({"phase": "service", "stage": "stage1", "counts": counts, "seconds": seconds,
          "peak_gib": peak, "allocated_gib_before": allocated, "executors": executors})
    check(executors == {"q1_square": "tree", "q2_triangle": "wcoj"},
          f"service: executors {executors}")
    check((counts["q1_square"], counts["q2_triangle"]) == (WT_COUNTS[0], WT_Q2_COUNTS[0]),
          f"service: stage-1 counts {counts}")
    sink = svc.subscribe(CountDeltaSink())
    apply_s, step_log = [], {}
    seen = service_trace(svc, apply_s, step_log)
    for b in range(N_BATCHES):
        svc.ingest(sample_update(svc.projected_graph(), c.n_del, c.n_add,
                                 seed=c.update_seed + b))
    svc.obs.tracer.drain()   # stage 1's spans
    ops.reset_launch_counts()
    (metrics, advance_s, _) = timed_stage(svc.advance)
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    roots = [sp for sp in svc.obs.tracer.drain() if sp.name == "batch"]
    check(len(metrics) == 2 * N_BATCHES == len(roots) == len(apply_s),
          f"service: {len(metrics)} batches, {len(roots)} batch spans")
    running = dict(counts)
    for i, (bm, root) in enumerate(zip(metrics, roots)):
        took = {name: sum(sp.dur_s for sp in root.walk() if sp.name == name)
                for name in ("shared_delta", "storage_update", "maintain_mega", "sinks")}
        now = {n: r.count_after for n, r in bm.patterns.items()}
        rec = {"phase": "service", "stage": "batch", "batch": i, "lo": bm.lo, "hi": bm.hi,
               "n_ops": bm.n_ops, "net_add": bm.net_add, "net_delete": bm.net_delete,
               "counts": now, "latency_s": bm.latency_s, "apply_batch_s": apply_s[i],
               "storage_update_s": took["storage_update"],
               "maintain_mega_s": took["maintain_mega"], "shared_delta_s": took["shared_delta"],
               "sinks_s": took["sinks"], "batch_span_s": root.dur_s,
               "service_host_s": root.dur_s - apply_s[i], "predicted_s": bm.predicted_s,
               **seen.get(i, {}), "overflow": bm.overflow,
               "storage_overflow": bm.storage_overflow, "host_bytes": bm.host_bytes,
               "cand_vertices": bm.cand_vertices, "cand_edges": bm.cand_edges,
               "invalidated_parts": bm.invalidated_parts}
        emit(rec)
        k = (i + 1) // 2
        want = ((WT_COUNTS[k], WT_Q2_COUNTS[k]) if i % 2 else
                (SERVICE_DELETE_COUNTS["q1_square"][k], SERVICE_DELETE_COUNTS["q2_triangle"][k]))
        check((now["q1_square"], now["q2_triangle"]) == want,
              f"service: counts {now} at watermark {bm.hi} != {want}")
        check(bm.n_ops == 64 and bm.hi == 64 * (i + 1), f"service: batch {i} is {bm.lo}-{bm.hi}")
        check(bm.overflow == bm.storage_overflow == bm.host_bytes == 0,
              f"service: overflow or host bytes in batch {i}: {rec}")
        check(all(r.count_before == running[n] for n, r in bm.patterns.items()),
              f"service: batch {i} did not start at the last counts")
        running = now
    final = svc.counts()
    check(all(counts[n] + sink.totals.get(n, 0) == final[n] for n in final),
          f"service: sink deltas {sink.totals} do not add up to {final} from {counts}")
    for k in DDSL_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the service path")
    emit({"phase": "service", "launches": launches, "advance_seconds": advance_s,
          "seconds": time.perf_counter() - t_phase})
    service_profile(svc, roots, step_log)
    t0 = time.perf_counter()
    audit = svc.audit()
    emit({"phase": "service", "stage": "audit", "audit": audit, "m": 4,
          "seconds": time.perf_counter() - t0})
    check(audit == {n: True for n in BACKEND_PATTERNS}, f"service: audit {audit}")
    del svc
    free_device_memory()
    return launches


def service_profile(svc, roots, step_log) -> None:
    """The ``profile`` line of ``service``: the service's own step profiler
    (``repro_torch.obs.StepProfiler``, on under ``Observability.full()``),
    per step its warm-ups (``compiles``) and steady calls with their seconds
    (CUDA events), the steady median a call (each batch's ``last_execute_s``
    where the step ran once more), memory and cost shares. The recorded
    steps must be the deployment's, the megastep and storage update booked
    once a batch, the counters equal to the records, the megastep's seconds
    within 5 % of its spans, and its alias bytes at least q1_square's
    store."""
    from repro_torch.obs.prof import tensor_bytes

    prof = svc.obs.jaxprof
    reg = svc.obs.metrics
    names = set(prof.steps)
    want = {"storage_update", "maintain_mega"} | {
        f"{kind}:{n}" for n in BACKEND_PATTERNS for kind in ("list", "init_store")} | {
        "unit_refresh:q1_square"}
    check(names == want, f"service profile: steps {sorted(names)} != {sorted(want)}")
    check(not any(n.startswith("maintain:") for n in names), "service profile: maintain:*")
    steady = {n: [] for n in names}
    for i in sorted(step_log):
        before = step_log.get(i - 1, {})
        for n, (calls, last) in step_log[i].items():
            if calls == before.get(n, (0, 0.0))[0] + 1:
                steady[n].append(last)
    steps = {}
    for n in sorted(names):
        r = prof.steps[n]
        check(reg.get("step_compiles_total").value_for(step=n) == r.compiles
              and reg.get("step_execute_calls_total").value_for(step=n) == r.calls,
              f"service profile: {n}'s counters differ from its record")
        check(r.heuristic and r.cost is None, f"service profile: {n} {r}")
        steps[n] = {"compiles": r.compiles, "compile_seconds": r.compile_seconds,
                    "calls": r.calls, "execute_seconds": r.execute_seconds,
                    "steady_median_s": statistics.median(steady[n]) if steady[n] else None,
                    "steady_s": steady[n], "memory": r.memory, "subs": r.subs}
    for n in ("maintain_mega", "storage_update"):
        r = prof.steps[n]
        check(r.compiles + r.calls == 2 * N_BATCHES == len(roots),
              f"service profile: {n} booked {r.compiles} + {r.calls} calls")
    mega = prof.steps["maintain_mega"]
    check(set(mega.subs or {}) == set(BACKEND_PATTERNS)
          and abs(sum(mega.subs.values()) - 1.0) < 1e-9,
          f"service profile: maintain_mega subs {mega.subs}")
    recorded = mega.compile_seconds + mega.execute_seconds
    spans = sum(sp.dur_s for root in roots for sp in root.walk() if sp.name == "maintain_mega")
    check(abs(recorded - spans) <= 0.05 * spans,
          f"service profile: maintain_mega recorded {recorded} s against spans {spans} s")
    store = tensor_bytes(svc.backend.entries["q1_square"].store)
    check(mega.memory["alias_size_in_bytes"] >= store,
          f"service profile: alias {mega.memory} below q1_square's store {store}")
    warm = steps["maintain_mega"]
    emit({"phase": "service", "stage": "profile", "steps": steps,
          "maintain_mega_recorded_s": recorded, "maintain_mega_spans_s": spans,
          "q1_square_store_bytes": store,
          "maintain_mega_warmup_cost_s": warm["compile_seconds"] - warm["steady_median_s"],
          "storage_update_warmup_cost_s": (steps["storage_update"]["compile_seconds"]
                                           - steps["storage_update"]["steady_median_s"])})


def service_capture(svc, trace_dir) -> None:
    """``service_small``'s ``capture`` line: the window armed on the second
    batch wrote exactly one Chrome trace, which holds kernel events of
    ``member_probe`` and ``set_intersect``."""
    prof = svc.obs.jaxprof
    snap = prof.snapshot()
    files = sorted(os.listdir(trace_dir.name))
    check(snap["captured_dirs"] == [trace_dir.name] and len(files) == 1
          and not snap["capture_failures"] and snap["capture_pending"] is None,
          f"service_small: capture {snap['captured_dirs']} {files} "
          f"{snap['capture_failures']} {snap['capture_pending']}")
    path = os.path.join(trace_dir.name, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {k: sum(k in n for n in kernels) for k in DDSL_KERNELS}
    emit({"phase": "service_small", "stage": "capture", "file": files[0],
          "bytes": os.path.getsize(path), "events": len(events), "kernel_events": len(kernels),
          "named_kernel_events": named, "batches": len(svc.metrics)})
    for k in DDSL_KERNELS:
        check(named[k] > 0, f"service_small: no {k} kernel event in the captured trace")
    trace_dir.cleanup()


def service_small_phase() -> None:
    """``service_small``: the service on the example graph (``run.EXAMPLE_Q1``'s
    graph and caps, 4 + 4 updates), q1_square and q2_triangle,
    ``audit_every=1`` and a ``MatchDeltaSink`` on both patterns (so every
    batch materializes on the card and reads the removed rows). Counts at
    each update's watermark are ``EXAMPLE_COUNTS``; each batch's removed and
    added rows, applied to the rows before it, give the rows after it. After
    the second update a snapshot restores with ``backend="sharded"`` and
    ``backend="host"``; each takes the third update to ``EXAMPLE_COUNTS``.
    Last a manual ``PlanManager.reoptimize`` (verified by an audit after any
    swap) leaves the counts as they were."""
    import tempfile

    from repro_torch.core.pattern import PATTERN_LIBRARY
    from repro_torch.data.graphs import rmat_graph, sample_update
    from repro_torch.run import EXAMPLE_Q1 as c
    from repro_torch.stream import (BatchScheduler, CallbackSink, ListingService,
                                    MatchDeltaSink, PlanManager)

    t_phase = time.perf_counter()
    graph = rmat_graph(c.n_log2, c.n_edges, seed=c.graph_seed)
    kw = dict(m=c.m, caps=config_caps(c), max_add=c.n_add, max_del=c.n_del)

    def scheduler():
        return BatchScheduler(min_ops=c.n_del, max_ops=c.n_del)

    svc = ListingService(graph, backend="sharded", scheduler=scheduler(), audit_every=1, **kw)
    for name in BACKEND_PATTERNS:
        svc.register(name, PATTERN_LIBRARY[name])
    # the service's own capture window over its second batch (no other
    # torch.profiler session runs in this phase)
    trace_dir = tempfile.TemporaryDirectory(prefix="service_capture_")
    svc.obs.jaxprof.arm_capture(trace_dir.name, start_batch=1, n_batches=1)

    def rows(name):
        return set(map(tuple, svc.backend.matches_plain(name).tolist()))

    deltas = svc.subscribe(MatchDeltaSink(BACKEND_PATTERNS))
    after = {}   # (pattern, hi) -> rows after the batch
    svc.subscribe(CallbackSink(lambda ev: after.__setitem__((ev.pattern, ev.hi),
                                                            rows(ev.pattern))))
    before = {n: rows(n) for n in BACKEND_PATTERNS}
    counts = [svc.counts()]
    updates = []
    snap_dir = tempfile.TemporaryDirectory(prefix="service_snapshot_")
    snap = snap_dir.name
    for u in range(N_BATCHES):
        updates.append(sample_update(svc.projected_graph(), c.n_del, c.n_add,
                                     seed=c.update_seed + u))
        svc.ingest(updates[-1])
        svc.advance()
        counts.append(svc.counts())
        if u == 1:
            svc.snapshot(snap)
    for i, want in enumerate(zip(EXAMPLE_COUNTS["q1_square"], EXAMPLE_COUNTS["q2_triangle"])):
        got = (counts[i]["q1_square"], counts[i]["q2_triangle"])
        check(got == want, f"service_small: counts {got} after update {i} != {want}")
    consistent = True
    for (name, hi), post in sorted(after.items(), key=lambda kv: kv[0][1]):
        gone = {tuple(r) for p, h, rs in deltas.removed if (p, h) == (name, hi)
                for r in rs.tolist()}
        new = {tuple(r) for p, h, rs in deltas.added if (p, h) == (name, hi)
               for r in rs.tolist()}
        consistent &= gone <= before[name] and (before[name] - gone) | new == post
        before[name] = post
    check(consistent, "service_small: a batch's row deltas do not give its rows")
    check(len(svc.audits) == len(svc.metrics) and all(ok for *_, ok in svc.audits),
          f"service_small: audits {svc.audits}")
    check(all(bm.overflow == 0 for bm in svc.metrics), "service_small: overflow")
    service_capture(svc, trace_dir)
    restored = {}
    for backend in ("sharded", "host"):
        extra = kw if backend == "sharded" else {}
        back = ListingService.restore(snap, backend=backend, scheduler=scheduler(), **extra)
        check(back.counts() == counts[2], f"service_small: {backend} restore {back.counts()}")
        back.ingest(updates[2])
        back.advance()
        restored[backend] = back.counts()
        check(restored[backend] == counts[3] and all(back.audit().values()),
              f"service_small: {backend} restore then update 3 gives {restored[backend]}")
        del back
    snap_dir.cleanup()
    pm = PlanManager(verify=True)
    events = pm.reoptimize(svc, trigger="manual")
    check(svc.counts() == counts[3], f"service_small: counts after the plan manager "
          f"{svc.counts()} != {counts[3]}")
    emit({"phase": "service_small", "counts": counts, "batches": len(svc.metrics),
          "audits": len(svc.audits),
          "host_bytes": [bm.host_bytes for bm in svc.metrics],
          "row_deltas_consistent": consistent, "restored": restored,
          "plan_events": [{"pattern": e.pattern, "swapped": e.swapped,
                           "incumbent_cost": e.incumbent_cost,
                           "candidate_cost": e.candidate_cost, "count": e.count}
                          for e in events],
          "seconds": time.perf_counter() - t_phase})
    del svc
    free_device_memory()


def rebalance_phase():
    """``rebalance``: the NP storage of ``run.EXAMPLE_Q1``'s graph at m = 8,
    half the centers of the partition storing the most edges moved to the
    one storing the fewest (``repro_torch.dist.rebalance_plan`` and
    ``apply_rebalance``), padded at caps holding every partition (any cap
    raised above EXAMPLE_Q1's is named) and listed on the card with the
    kernels (q1_square and q2_triangle by their join trees: list + init
    store); then the storage re-cut at m = 4 (``repartition_storage``) and
    listed on ``LocalMesh(4)``. Each count must equal the unrebalanced
    storage's, ``EXAMPLE_COUNTS``' first and the host ``DDSL``'s under the
    rebalanced partition function (Lemma 3.1). The launches are those of
    the rebalanced and re-cut listings; the widest edge probe and CC-join
    they made are held against the plain versions on the same inputs."""
    from repro_torch import sharded
    from repro_torch.core import DDSL
    from repro_torch.core.estimator import GraphStats
    from repro_torch.core.pattern import PATTERN_LIBRARY
    from repro_torch.core.storage import build_np_storage
    from repro_torch.data.graphs import rmat_graph
    from repro_torch.dist import (apply_rebalance, rebalance_plan, repartition_delta,
                                  repartition_storage)
    from repro_torch.engine import EngineCaps
    from repro_torch.kernels import ops
    from repro_torch.mesh import LocalMesh
    from repro_torch.run import EXAMPLE_Q1 as c
    from repro_torch.run import plan_pattern

    t_phase = time.perf_counter()
    graph = rmat_graph(c.n_log2, c.n_edges, seed=c.graph_seed)
    stats = GraphStats.of(graph)
    base = build_np_storage(graph, c.m)
    edges = [p.num_edges for p in base.parts]
    slow, fast = int(np.argmax(edges)), int(np.argmin(edges))
    plan = rebalance_plan(base, slow=[slow], fast=[fast], fraction=0.5)
    moved = apply_rebalance(base, plan)
    recut = repartition_storage(moved, 4)
    storages = {"m8": base, "m8_rebalanced": moved, "m4_recut": recut}
    need = {"v_cap": max(p.vertices.shape[0] for st in storages.values() for p in st.parts),
            "e_cap": max(p.num_edges for st in storages.values() for p in st.parts),
            "deg_cap": max(int(np.diff(p.indptr).max(initial=0))
                           for st in storages.values() for p in st.parts)}
    caps = EngineCaps(**{f: max(getattr(c, f), need.get(f, 0)) for f in CAP_FIELDS})
    raised = {f: [getattr(c, f), getattr(caps, f)] for f in CAP_FIELDS
              if getattr(caps, f) != getattr(c, f)}

    def listed(storage):
        mesh = LocalMesh(storage.m)
        pt = sharded.stack_partitions(storage, caps, "cuda")
        out = {}
        for name in BACKEND_PATTERNS:
            p = plan_pattern(name, stats, storage, caps, mesh)
            root, ldiag = p.list_step(pt)
            _, idiag = p.init_step(root)
            out[name] = {"count": int(idiag["count"]),
                         "overflow": int(ldiag["overflow"]) + int(idiag["overflow"])}
        return out

    counts = {"m8": listed(base)}
    ops.reset_launch_counts()
    with probe_spy(caps.e_cap) as probe, ccjoin_spy() as ccjoin:
        counts["m8_rebalanced"] = listed(moved)
        counts["m4_recut"] = listed(recut)
    torch.cuda.synchronize()
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    host = {}
    for name in BACKEND_PATTERNS:
        eng = DDSL(graph, PATTERN_LIBRARY[name], m=c.m, h=moved.h)
        eng.initial()
        host[name] = eng.count()
    emit({"phase": "rebalance", "slow": slow, "fast": fast, "moved_centers": len(plan),
          "edges_by_partition": {k: [p.num_edges for p in st.parts]
                                 for k, st in storages.items()},
          "caps_needed": need, "caps_raised": raised, "counts": counts, "host_ddsl": host,
          "repartition_delta": repartition_delta(moved, 4),
          "repartition_delta_unbalanced": repartition_delta(base, 4),
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    for name in BACKEND_PATTERNS:
        want = EXAMPLE_COUNTS[name][0]
        got = {k: v[name] for k, v in counts.items()}
        check(all(v == {"count": want, "overflow": 0} for v in got.values())
              and host[name] == want,
              f"rebalance: {name} counts {got}, host {host[name]}, want {want}")
    check(launches["member_probe"] > 0 and launches["set_intersect"] > 0,
          f"rebalance: launches {launches}")
    check("args" in probe and "args" in ccjoin, "rebalance: no edge probe or CC-join captured")
    cases = {"member_probe": level_probe_case(
                 "rebalance", probe["args"], launches_rebalance=launches["member_probe"]),
             "set_intersect": set_intersect_check(
                 "rebalance", *ccjoin["args"], timed=True,
                 launches_rebalance=launches["set_intersect"])}
    del probe, ccjoin
    torch.cuda.empty_cache()
    emit({"phase": "kernel_check", **{k: [v] for k, v in cases.items()}})
    return launches, cases


def steady(fn, reps: int = 3):
    """``fn()`` once to warm up, then ``reps`` timed runs (host clock
    ending in a synchronize): (last result, median seconds, all seconds,
    peak GiB)."""
    fn()
    times, peak, result = [], 0.0, None
    for _ in range(reps):
        result, seconds, pk = timed_stage(fn)
        times.append(seconds)
        peak = max(peak, pk)
    return result, statistics.median(times), times, peak


def device_split(fn):
    """One more ``fn()`` under the profiler: its device seconds, kernel
    count and the idle share of its device span."""
    _, prof = profiled(fn)
    return {"device_s": prof["device_s"], "kernels": prof["device_events"],
            "span_idle_share": prof["span_idle_share"]}


def counted_run(fn, e_cap: int, path: str):
    """One run of ``fn()`` with the launch counts set to 0 just before it
    and read just after, under :func:`probe_spy`: (result, the DDSL
    kernels' launches in the run, the inputs of its widest edge-table
    probe). ``member_probe`` must have launched."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    with probe_spy(e_cap) as widest:
        result = fn()
    torch.cuda.synchronize()
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    check(launches["member_probe"] > 0, f"member_probe never launched on {path}")
    return result, launches, widest["args"]


def wcoj_vs_tree_phase():
    """K5 and K4 on the planted near-clique graph at m = 1, listed from
    scratch (list + init store, ``Pipeline.list_pattern``) under each
    executor, both lossless: the generic join with its calibrated caps; the
    join tree with match_cap from TREE_MATCH_CAP0 up 4x until its listing
    drops nothing, and its store groups doubled until its store does (the
    steps are rebuilt at each cap, as bench_wcoj.py's protocol does, and
    the lossless pair is put into the pipeline's plan). Both must give
    ``PLANTED_COUNTS``. Each executor's first run after planning is the
    counted run (launches set to 0 just before it, read just after, its
    widest level or edge-check probe kept); then the steady-state seconds
    (median of 3 after a warm-up) and their ratio are reported, not gated,
    with one more run of each under the profiler (device seconds, kernels,
    idle share). These listings make no ``set_intersect`` call (the
    generic join intersects by edge probes; the planted trees at m = 1
    check edges by probes and join no compressed sets), so only
    ``member_probe`` must launch; both counts are reported. Returns the
    launches by path and the ``member_probe`` cases at the widest probe of
    each executor."""
    import dataclasses

    from repro_torch import sharded
    from repro_torch.planner.sizing import StoreCaps, quantize_store_caps
    from repro_torch.run import PLANTED_K4, PLANTED_K5, Pipeline

    by_path, widest = {}, {}
    for cfg in (PLANTED_K5, PLANTED_K4):
        t_phase = time.perf_counter()
        name, want = cfg.pattern, PLANTED_COUNTS[cfg.pattern]
        path = f"planted_k{name[-1]}"
        pipe = Pipeline(cfg, "cuda")
        p = pipe.plans[name]
        check(p.executor == "wcoj", f"wcoj_vs_tree: {name} is not on the generic join")
        (_, wd0), launches, args = counted_run(lambda: pipe.list_pattern(name),
                                               pipe.caps.e_cap, f"{path}_wcoj")
        by_path[f"{path}_wcoj"] = launches
        if args[0].numel() > widest.get("wcoj", args)[0].numel() or "wcoj" not in widest:
            widest["wcoj"] = args
        (wst, wd), w_s, w_runs, w_peak = steady(lambda: pipe.list_pattern(name))
        wcoj = {"s": w_s, "runs": w_runs, "peak_gib": w_peak, "count": int(wd["count"]),
                "overflow": int(wd["overflow"]), "first_count": int(wd0["count"]),
                "level_caps": list(p.level_caps), "store_caps": dataclasses.asdict(p.store_caps),
                "launches": launches, "widest_probe": int(args[0].numel()),
                **device_split(lambda: pipe.list_pattern(name))}
        del pipe, wst, args
        torch.cuda.empty_cache()

        pipe = Pipeline(dataclasses.replace(cfg, executor="tree"), "cuda")
        p = pipe.plans[name]
        mc, store_g, tries = TREE_MATCH_CAP0, p.store_caps.group_cap, []
        while True:
            check(mc <= 1 << 22, f"wcoj_vs_tree: {name} tree caps past 4M rows")
            caps = dataclasses.replace(pipe.caps, match_cap=mc,
                                       group_cap=max(pipe.caps.group_cap, mc))
            lstep = sharded.make_list_step(p.prog, pipe.mesh, caps)
            out, ld = lstep(pipe.pt)
            if int(ld["overflow"]):
                tries.append({"match_cap": mc, "list_overflow": int(ld["overflow"])})
                mc *= 4
                continue
            scaps = quantize_store_caps(StoreCaps(store_g, p.store_caps.set_cap))
            istep = sharded.make_init_store_step(p.prog, pipe.mesh, caps, scaps)
            _, idiag = istep(out)
            if int(idiag["overflow"]):
                tries.append({"match_cap": mc, "store_group_cap": scaps.group_cap,
                              "store_overflow": int(idiag["overflow"])})
                store_g *= 2
                continue
            break
        del out
        pipe.plans[name] = dataclasses.replace(p, list_step=lstep, init_step=istep,
                                               store_caps=scaps)
        torch.cuda.empty_cache()
        (_, td0), launches, args = counted_run(lambda: pipe.list_pattern(name),
                                               pipe.caps.e_cap, f"{path}_tree")
        by_path[f"{path}_tree"] = launches
        if args[0].numel() > widest.get("tree", args)[0].numel() or "tree" not in widest:
            widest["tree"] = args
        (tst, td), t_s, t_runs, t_peak = steady(lambda: pipe.list_pattern(name))
        tree = {"s": t_s, "runs": t_runs, "peak_gib": t_peak, "count": int(td["count"]),
                "overflow": int(td["overflow"]), "first_count": int(td0["count"]),
                "match_cap": mc, "store_caps": dataclasses.asdict(scaps), "escalations": tries,
                "launches": launches, "widest_probe": int(args[0].numel()),
                **device_split(lambda: pipe.list_pattern(name))}
        del pipe, tst, lstep, istep, args
        torch.cuda.empty_cache()
        emit({"phase": "wcoj_vs_tree", "pattern": name, "graph": "planted", "m": cfg.m,
              "wcoj": wcoj, "tree": tree, "tree_over_wcoj": t_s / w_s,
              "seconds": time.perf_counter() - t_phase})
        for label, r in (("wcoj", wcoj), ("tree", tree)):
            check(r["overflow"] == 0 and r["count"] == r["first_count"] == want,
                  f"wcoj_vs_tree: {name} {label} count {r['count']} (overflow "
                  f"{r['overflow']}) != {want}")
    cases = [level_probe_case(f"planted_{label}", widest[label], **{
        f"launches_{path}": n["member_probe"] for path, n in by_path.items()
        if path.endswith(label)}) for label in ("wcoj", "tree")]
    del widest
    torch.cuda.empty_cache()
    emit({"phase": "kernel_check", "member_probe": cases})
    return by_path, cases


def profiled(fn, kernels=()):
    """``fn()`` under ``torch.profiler``: its result, and wall time, summed
    device time of its kernels, idle share, the kernels that took most of
    it and, for each name in ``kernels``, the device seconds and launches
    of every kernel whose name contains it. Read from the profiler's raw
    events: its per-op tables (``key_averages()``) took ~100 s to build
    after a 9-s DDSL batch, the raw events a second or two."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    cuda = [e for e in events if e.device_type() == DeviceType.CUDA]
    # host ops by correlation id: a kernel links to the op that launched it
    # (a kernel launched outside any op, as the port's are, links to none)
    ops = {e.correlation_id(): e.name() for e in events
           if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0
           and e.correlation_id() > 0 and not e.is_async()}
    op_calls = {}
    for name in ops.values():
        op_calls[name] = op_calls.get(name, 0) + 1
    # Kernels only: "Command Buffer Full" marks a full launch queue, not device work.
    by_kernel, by_op = {}, {}
    for e in cuda:
        if e.name().startswith("Command Buffer") or e.is_async():
            continue
        sec = e.duration_ns() / 1e9
        acc = by_kernel.setdefault(e.name(), [0.0, 0])
        acc[0] += sec
        acc[1] += 1
        op = ops.get(e.linked_correlation_id())
        if op is not None:
            by_op[op] = by_op.get(op, 0.0) + sec
    dev = [(k, sec, n) for k, (sec, n) in by_kernel.items() if sec > 0]
    busy = sum(sec for _, sec, _ in dev)
    top = sorted(dev, key=lambda r: -r[1])[:12]
    # device time of the kernels each host op launched itself
    by_op = sorted(((k, sec, op_calls[k]) for k, sec in by_op.items() if sec > 0),
                   key=lambda r: -r[1])[:12]
    # the device timeline: the profiler may miss the first kernels after it
    # starts, so the kernel count and the span show what it saw
    kern = [(e.start_ns(), e.duration_ns()) for e in cuda]
    span = (max(a + d for a, d in kern) - min(a for a, _ in kern)) / 1e9 if kern else 0.0
    named = {k: {"s": sum(t for key, t, _ in dev if k in key),
                 "calls": sum(c for key, _, c in dev if k in key)} for k in kernels}
    return result, {"wall_s": wall, "device_s": busy, "idle_share": max(0.0, 1 - busy / wall),
                    "named_kernels": named,
                    "device_events": len(kern), "device_span_s": span,
                    "span_idle_share": max(0.0, 1 - sum(d for _, d in kern) / 1e9 / span)
                    if span else None,
                    "top": [{"kernel": k[:90], "s": sec, "calls": n} for k, sec, n in top],
                    "by_op": [{"op": k, "s": sec, "calls": n} for k, sec, n in by_op]}


def profile_batch(pipe):
    """One more batch under ``torch.profiler``. ``set_intersect_fill``: the
    mean non-pad values a row of ``a`` and ``b`` over the batch's
    ``set_intersect`` calls, counted on the card by a wrapper around
    ``ops.set_intersect`` set for this batch only (its reductions are in
    the profile), and the share of rows whose ``a`` is all pad. Returns the
    batch's record and the fill."""
    from repro_torch.kernels import ops

    inner, calls = ops.set_intersect, []

    def counted(a, b, *, pad, use_kernels):
        live = a != pad
        calls.append((tuple(a.shape), b.shape[1], live.sum(), (b != pad).sum(),
                      (~live.any(1)).sum()))
        return inner(a, b, pad=pad, use_kernels=use_kernels)

    upd = pipe.next_update()
    ops.set_intersect = counted
    try:
        d, prof = profiled(lambda: {k: int(v) for k, v in pipe.apply(upd).items()}, DDSL_KERNELS)
    finally:
        ops.set_intersect = inner
    rows = max(1, sum(shape[0] for shape, *_ in calls))
    fill = {"calls": len(calls), "rows": rows,
            "mean_nonpad_a": sum(int(c[2]) for c in calls) / rows,
            "mean_nonpad_b": sum(int(c[3]) for c in calls) / rows,
            "empty_a_share": sum(int(c[4]) for c in calls) / rows,
            "shapes": sorted({(shape[0], shape[1], cb) for shape, cb, *_ in calls})}
    emit({"phase": "profile", "count": d["count"], "overflow": d["overflow"],
          "set_intersect_fill": fill, **prof})
    return d, fill


# ---------------------------------------------------------------------------
# GNN slice: segment_sum and full-graph inference
# ---------------------------------------------------------------------------

def segment_ids(e: int, n: int, gen, out_of_range: bool = True) -> torch.Tensor:
    """Ids uniform over [0, n), unsorted; 1 % set to n and 0.5 % to -1."""
    seg = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32, device="cuda")
    if out_of_range:
        r = torch.rand(e, generator=gen, device="cuda")
        seg[r < 0.01] = n
        seg[(r >= 0.01) & (r < 0.015)] = -1
    return seg


def heavy_ids(e: int, n: int, gen) -> torch.Tensor:
    """Ids uniform over [0, n), unsorted, with half the rows set to n // 2."""
    seg = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32, device="cuda")
    seg[torch.rand(e, generator=gen, device="cuda") < 0.5] = n // 2
    return seg


def segment_sum_phase():
    """The segment-sum kernel against its plain version on their float64
    accumulators (``ref.ACC_DTYPE``), at the GNN path's shapes and at edge
    cases, each through its segment plan, built first. The bound and the
    ``index_add_`` yardstick are those of the function itself, whose
    accumulator is float32: the kernel's float64 traffic shows as distance
    from the bound."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.segment_sum import segment_plan

    gen = torch.Generator(device="cuda").manual_seed(1)
    big_n, big_e = 2_449_029, 1 << 24
    bf16, f32 = torch.bfloat16, torch.float32
    # the nodes of one edge slice of the forward, whose edge list is sorted
    # by destination: 2**24 of the 123,718,280 edges, about 50.5 a node
    slice_nodes = round(big_n * big_e / (2 * get_arch(GNN_ARCH).shape(GNN_SHAPE).n_edges))

    def rows(e, d, dtype):
        return torch.randn((e, d), generator=gen, device="cuda").to(dtype)

    slice_rows = rows(big_e, 70, bf16)
    mol_ids = torch.sort(torch.randint(0, 3840, (16_384,), generator=gen, dtype=torch.int32,
                                       device="cuda")).values
    cases = {
        # one gatedgcn edge slice (msg / eta) at full width, ids unsorted
        "gatedgcn_slice": (slice_rows, segment_ids(big_e, big_n, gen), big_n),
        # the same rows with ids sorted, as the forward feeds them
        "gatedgcn_slice_sorted": (slice_rows, torch.sort(torch.randint(
            0, slice_nodes, (big_e,), generator=gen, dtype=torch.int32, device="cuda")).values,
            big_n),
        # the same rows, half of them in one id
        "heavy_segment": (slice_rows, heavy_ids(big_e, big_n, gen), big_n),
        # the _segment_mean ones column over the same ids: integer sums, exact
        "ones_column": (torch.ones((big_e, 1), dtype=bf16, device="cuda"),
                        segment_ids(big_e, big_n, gen), big_n),
        # meshgraphnet (d 128, bf16) and graphsage layer 0 (d 1433, float32)
        # on full_graph_sm
        "meshgraphnet": (rows(21_112, 128, bf16), segment_ids(21_112, 2708, gen), 2708),
        "graphsage_l0": (rows(21_112, 1433, f32), segment_ids(21_112, 2708, gen), 2708),
        # EquiformerV2 on molecule: one chunk's messages [16,384, 49 x 128] float32 and
        # the softmax denominators [16,384, 8] float32, ids sorted over 3,840 nodes as
        # the forward feeds them
        "eqv2_messages": (rows(16_384, 49 * 128, f32), mol_ids, 3840),
        "eqv2_den": (rows(16_384, 8, f32), mol_ids, 3840),
        # edge cases
        "empty": (rows(0, 70, bf16), segment_ids(0, 10, gen), 10),
        "all_out_of_range": (rows(5000, 70, bf16),
                             torch.where(segment_ids(5000, 2, gen, False) == 0, -1, 64).int(), 64),
        "n_1": (rows(4097, 3, f32), segment_ids(4097, 1, gen), 1),
        "unsorted_duplicates": (rows(3001, 5, f32),
                                torch.randint(-2, 9, (3001,), generator=gen, dtype=torch.int32,
                                              device="cuda"), 7),
    }
    del slice_rows, mol_ids
    out = []
    for name in list(cases):
        data, seg, n = cases.pop(name)
        timed = data.shape[0] * data.shape[1] >= 1 << 20 or name.startswith("eqv2")
        out.append(segment_sum_case(name, data, seg, n, segment_plan(seg, n), timed))
        del data, seg
    torch.cuda.empty_cache()
    return out


def segment_sum_case(name, data, seg, n, plan, timed: bool):
    """One ``segment_sum`` case: the kernel through ``plan``, the segment
    plan of ``seg``, against the plain version from the ids, within 1e-5
    of max |plain| (exact for the integer-valued cases). When ``timed``:
    the kernel, the plan, the plain version and ``index_add_`` into
    float32, and the function's byte bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_sum import segment_plan, segment_sum_cuda

    e, d = data.shape
    zeros = lambda: torch.zeros((n, d), dtype=ref.ACC_DTYPE, device="cuda")  # noqa: E731
    got = segment_sum_cuda(data, plan, zeros())
    want = ref.segment_sum_ref(data, seg, n, zeros())
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    top = float(want.abs().max()) if want.numel() else 0.0
    limit = 0.0 if name in ("ones_column", "empty", "all_out_of_range") else 1e-5 * max(1.0, top)
    check(err <= limit, f"segment_sum {name}: max |kernel - plain| {err} > {limit}")
    if name == "all_out_of_range":
        check(not got.any(), "segment_sum: out-of-range ids were added")
    rec = {"case": name, "rows": e, "d": d, "n": n, "dtype": str(data.dtype).split(".")[-1],
           "max_abs_err": err, "max_abs_ref": top, "limit": limit,
           "sorted": plan.order is None, "segments": plan.hi - plan.lo,
           "heavy_segments": plan.heavy.shape[0], "heavy_parts": plan.n_parts}
    if timed:
        keep = (seg >= 0) & (seg < n)
        src = torch.where(keep[:, None], data.float(), 0.0)
        idx = seg.clamp(0, n - 1)
        acc = torch.zeros((n, d), dtype=torch.float32, device="cuda")
        touched = int(torch.unique(seg[keep]).numel())
        rec["ms"] = cuda_ms(lambda: segment_sum_cuda(data, plan, got))
        rec["plan_ms"] = cuda_ms(lambda: segment_plan(seg, n), reps=3)
        rec["plain_ms"] = cuda_ms(lambda: ref.segment_sum_ref(data, seg, n, want), reps=3)
        rec["library_ms"] = cuda_ms(lambda: acc.index_add_(0, idx, src))
        if rec["ms"] < 1:  # the card's time alone, the host's hidden
            rec["ms_back_to_back"] = cuda_ms(lambda: segment_sum_cuda(data, plan, got), per=20)
            rec["library_ms_back_to_back"] = cuda_ms(lambda: acc.index_add_(0, idx, src),
                                                     per=20)
        # the function's bytes: data and ids read once, the float32 rows
        # of the touched segments written once; e * d float32 adds
        n_bytes = e * d * data.element_size() + 4 * e + 4 * touched * d
        rec["touched_segments"] = touched
        rec["bytes"] = n_bytes
        rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, e * d)
    return rec


def sort_and_plan(g, slice_rows=None):
    """The forward's first step alone: sort the edge list by destination
    and build its segment plans (``gnn.sort_edges``); seconds on the host
    clock around it, its peak GiB above what was resident, the plans."""
    from repro_torch.models import gnn

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ed = gnn.sort_edges(g, slice_rows)
    torch.cuda.synchronize()
    rec = {"sort_plan_seconds": time.perf_counter() - t0,
           "sort_plan_peak_extra_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
           "plans": len(ed.plans), "sorted_plans": sum(p.order is None for p in ed.plans),
           "heavy_segments": sum(p.heavy.shape[0] for p in ed.plans)}
    del ed
    torch.cuda.empty_cache()
    return rec


def gnn_forward(params, g, cfg, use_kernels: bool, label: str):
    """One full-graph forward; its record, output and launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import gnn

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = gnn.forward(params, g, cfg, use_kernels=use_kernels)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    rec = {"phase": "gnn_forward", "arch": cfg.name, "run": label, "seconds": seconds,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "segment_sum_launches": counts["segment_sum"], "inference_mode": out.is_inference(),
           "shape": list(out.shape), "dtype": str(out.dtype).split(".")[-1],
           "finite": bool(torch.isfinite(out).all()), "max_abs_out": float(out.abs().max())}
    check(rec["finite"], f"{cfg.name} {label}: output is not finite")
    check(rec["inference_mode"], f"{cfg.name} {label}: forward ran outside inference_mode")
    return rec, out, counts


def compare_outputs(name: str, out_k, out_p, tol: float):
    delta = (out_k.float() - out_p.float()).abs()
    diff = float(delta.max())
    top = float(out_p.float().abs().max())
    rec = {"arch": name, "max_abs_diff": diff, "max_abs_plain": top,
           "ratio": diff / top if top else 0.0, "limit_ratio": tol,
           "equal_share": float((delta == 0).float().mean())}
    check(diff <= tol * top, f"{name}: max |kernel - plain| {diff} > {tol} * {top}")
    return rec


def gnn_profile(params, g, cfg):
    """One kernel forward under ``torch.profiler``; returns its output."""
    from repro_torch.models import gnn

    out, prof = profiled(lambda: gnn.forward(params, g, cfg, use_kernels=True))
    emit({"phase": "gnn_profile", "arch": cfg.name, **prof})
    return out


def gnn_phase():
    """gatedgcn full-graph inference at ogb_products size, kernels then
    plain; returns the kernel run's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import graph_from_numpy
    from repro_torch.data import build_graph_data
    from repro_torch.models import gnn
    import dataclasses

    spec = get_arch(GNN_ARCH)
    shape = spec.shape(GNN_SHAPE)
    cfg = dataclasses.replace(spec.config, d_in=shape.d_feat)
    n_nodes, n_edges = shape.n_nodes, 2 * shape.n_edges
    t0 = time.perf_counter()
    raw = build_graph_data(n_nodes, n_edges, shape.d_feat, seed=0)
    data_s = time.perf_counter() - t0
    g = graph_from_numpy(raw, "cuda")
    del raw
    params = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    slices = math.ceil(n_edges / gnn.EDGE_SLICE)
    predicted = cfg.n_layers * 2 * slices
    setup_s = time.perf_counter() - t0
    sort = sort_and_plan(g, gnn.EDGE_SLICE)
    check(sort["plans"] == sort["sorted_plans"] == slices,
          f"{sort['plans']} segment plans ({sort['sorted_plans']} sorted) for {slices} slices")
    emit({"phase": "gnn_plan", "arch": cfg.name, "shape": GNN_SHAPE, "nodes": n_nodes,
          "edges": n_edges, "d_in": cfg.d_in, "d_hidden": cfg.d_hidden, "d_out": cfg.d_out,
          "layers": cfg.n_layers, "dtype": cfg.dtype, "edge_slice": gnn.EDGE_SLICE,
          "slices": slices, "predicted_segment_sum_launches": predicted,
          "data_seconds": data_s, "setup_seconds": setup_s,
          "resident_gib": torch.cuda.memory_allocated() / 2**30, **sort})

    rec, out_k, counts = gnn_forward(params, g, cfg, True, "kernels")
    emit(rec)
    check(counts["segment_sum"] == predicted,
          f"segment_sum launched {counts['segment_sum']} times, predicted {predicted}")
    for name in DDSL_KERNELS:
        check(counts[name] == 0, f"{name} launched on the GNN path")
    rec, out_p, plain_counts = gnn_forward(params, g, cfg, False, "plain")
    emit(rec)
    check(not any(plain_counts.values()), f"the plain forward launched kernels: {plain_counts}")
    equal = compare_outputs(cfg.name, out_k, out_p, 3e-2)
    del out_p
    # a second kernel forward (profiled): without atomics it repeats bit for bit
    out_r = gnn_profile(params, g, cfg)
    equal["kernel_repeat_max_abs_diff"] = float((out_r.float() - out_k.float()).abs().max())
    check(equal["kernel_repeat_max_abs_diff"] == 0,
          f"two kernel forwards differ by {equal['kernel_repeat_max_abs_diff']}")
    emit({"phase": "gnn_equal", **equal})
    del out_k, out_r, g, params
    torch.cuda.empty_cache()
    return counts


def gnn_small_phase():
    """graphsage-reddit and meshgraphnet at full width on full_graph_sm."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import graph_from_numpy
    from repro_torch.data import build_graph_data
    from repro_torch.models import gnn
    import dataclasses

    for arch, tol in GNN_SMALL:
        spec = get_arch(arch)
        shape = spec.shape("full_graph_sm")
        cfg = dataclasses.replace(spec.config, d_in=shape.d_feat)
        raw = build_graph_data(shape.n_nodes, 2 * shape.n_edges, shape.d_feat,
                               d_edge=cfg.d_edge_in, seed=0)
        g = graph_from_numpy(raw, "cuda")
        params = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
        gnn.forward(params, g, cfg, use_kernels=False)  # warm-up: first-use costs
        sort = sort_and_plan(g)
        rec_k, out_k, counts = gnn_forward(params, g, cfg, True, "kernels")
        rec_p, out_p, _ = gnn_forward(params, g, cfg, False, "plain")
        check(counts["segment_sum"] > 0, f"{arch}: segment_sum never launched")
        emit({"phase": "gnn_small", "shape": "full_graph_sm", "nodes": shape.n_nodes,
              "edges": 2 * shape.n_edges, "dtype": cfg.dtype,
              "segment_sum_launches": counts["segment_sum"],
              "kernel_seconds": rec_k["seconds"], "plain_seconds": rec_p["seconds"],
              "sort_plan_seconds": sort["sort_plan_seconds"],
              **compare_outputs(arch, out_k, out_p, tol)})


# ---------------------------------------------------------------------------
# EquiformerV2 inference
# ---------------------------------------------------------------------------

def eqv2_terms(cfg, dense_rotation: bool = True):
    """FLOP of the port's EquiformerV2 forward by kind, 2 a multiply-add:
    (per edge and layer, the rotations in pass 1 (the m = 0 rows) and pass
    2 (the rows with |m| <= m_max in and back) and the messages'
    weighting; per edge and layer, the products of a weight: the first d
    columns of the attention's m = 0 product, the logit MLP and the SO(2)
    mixing (one product for m = 0, four for each m > 0); per node and
    layer, the update MLP and the gates; per edge, building the rotations).
    ``dense_rotation``: the rotations as the forward executes them, each
    row against all (l_max + 1)**2 coefficients; else only the 2l + 1 of
    its own degree l (the rotation is block-diagonal by l), the FLOP the
    function needs."""
    from repro_torch.models import gnn

    d, dim = cfg.d_hidden, (cfg.l_max + 1) ** 2
    groups = gnn._eqv2_m_indices(cfg.l_max, cfg.m_max)
    n0, rows = len(groups[0]), sum(len(v) for v in groups.values())
    if dense_rotation:
        nnz0, nnz = n0 * dim, rows * dim
    else:
        nnz0 = dim  # the m = 0 row of degree l has 2l + 1 entries
        nnz = sum(min(2 * l + 1, 2 * cfg.m_max + 1) * (2 * l + 1) for l in range(cfg.l_max + 1))
    so2 = 2 * (n0 * d) ** 2 + sum(8 * (len(groups[m]) * d) ** 2 for m in groups if m > 0)
    rotate = 2 * nnz0 * d + 2 * (2 * nnz * d) + 2 * dim * d
    weights = 2 * n0 * d * d + 2 * d * d + 2 * d * cfg.n_heads + so2
    per_node = 2 * 2 * d * d + 2 * d * cfg.l_max
    build = sum(6 * (2 * l + 1) ** 3 for l in range(cfg.l_max + 1))
    return rotate, weights, per_node, build


def eqv2_flops(cfg, nodes: int, edges: int, dense_rotation: bool = True) -> float:
    """FLOP of the port's EquiformerV2 forward (:func:`eqv2_terms`): the
    layers, the edge rotations, the embedding and the readout."""
    rotate, weights, per_node, build = eqv2_terms(cfg, dense_rotation)
    return float(cfg.n_layers * (edges * (rotate + weights) + nodes * per_node)
                 + edges * build + 2 * nodes * cfg.d_hidden * (cfg.d_in + cfg.d_out))


def eqv2_graphs():
    """The EquiformerV2 requests: (shape, seed, nodes, edges, d_feat)."""
    from repro_torch.configs import get_arch

    spec = get_arch(EQV2_ARCH)
    mol, sm = spec.shape("molecule"), spec.shape("full_graph_sm")
    reqs = [("molecule", s, mol.batch_graphs * mol.n_nodes,
             2 * mol.batch_graphs * mol.n_edges, mol.d_feat) for s in EQV2_MOLECULE_SEEDS]
    return reqs + [("full_graph_sm", 0, sm.n_nodes, 2 * sm.n_edges, sm.d_feat)]


def eqv2_phase():
    """EquiformerV2 at full width: four molecule requests and one
    full_graph_sm request, kernels then plain after a warm-up each; the
    chunked forward; the repeat and the rotation gaps; one profiled
    forward. Returns the segment-sum launches by path."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import graph_from_numpy
    from repro_torch.data import build_graph_data
    from repro_torch.launch.steps import gnn_flops
    from repro_torch.models import gnn

    spec = get_arch(EQV2_ARCH)
    params, plan, by_path = {}, [], {"eqv2_molecule": 0, "eqv2_full_graph_sm": 0}
    for shape, seed, nodes, edges, d_feat in eqv2_graphs():
        cfg = dataclasses.replace(spec.config, d_in=d_feat)
        chunks = gnn.eqv2_chunks(edges, cfg.edge_chunk)
        if shape not in params:
            params[shape] = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                                            "cuda")
            executed = eqv2_flops(cfg, nodes, edges)
            needed = eqv2_flops(cfg, nodes, edges, dense_rotation=False)
            plan.append({"shape": shape, "nodes": nodes, "edges": edges, "d_in": d_feat,
                         "chunks": chunks, "edge_chunk": cfg.edge_chunk,
                         "params": sum(p.numel() for p in params[shape].values()),
                         "model_flops": gnn_flops(cfg, nodes, edges)["model_flops"],
                         "executed_flops": executed, "needed_flops": needed,
                         "executed_bound_ms": bound_ms(0, executed)[0],
                         "bound_ms": bound_ms(0, needed)[0],
                         "predicted_segment_sum_launches": cfg.n_layers * (1 + chunks)})
    emit({"phase": "eqv2_plan", "arch": EQV2_ARCH, "layers": spec.config.n_layers,
          "d_hidden": spec.config.d_hidden, "l_max": spec.config.l_max,
          "m_max": spec.config.m_max, "heads": spec.config.n_heads, "dtype": spec.config.dtype,
          "shapes": plan, "tf32": torch.backends.cuda.matmul.allow_tf32})
    info = {r["shape"]: r for r in plan}

    outs, ratios, warm = {}, [], set()
    for shape, seed, nodes, edges, d_feat in eqv2_graphs():
        cfg = dataclasses.replace(spec.config, d_in=d_feat)
        t0 = time.perf_counter()
        g = graph_from_numpy(build_graph_data(nodes, edges, d_feat, seed=seed, geometric=True),
                             "cuda")
        data_s = time.perf_counter() - t0
        if shape not in warm:  # warm-up: first-use costs
            gnn.forward(params[shape], g, cfg, use_kernels=True)
            warm.add(shape)
        pair = {}
        for use_kernels, label in ((True, "kernels"), (False, "plain")):
            rec, out, counts = gnn_forward(params[shape], g, cfg, use_kernels, label)
            want = info[shape]["predicted_segment_sum_launches"] if use_kernels else 0
            check(rec["segment_sum_launches"] == want,
                  f"{shape} {seed} {label}: {rec['segment_sum_launches']} segment_sum launches,"
                  f" predicted {want}")
            check(not any(v for k, v in counts.items() if k != "segment_sum"),
                  f"{shape} {seed} {label}: other kernels launched: {counts}")
            rec.update(phase="eqv2_serve", shape=shape, seed=seed, data_seconds=data_s,
                       model_flops=info[shape]["model_flops"],
                       executed_flops=info[shape]["executed_flops"],
                       executed_tflops_per_s=info[shape]["executed_flops"] / rec["seconds"] / 1e12,
                       needed_flops=info[shape]["needed_flops"],
                       executed_bound_ms=info[shape]["executed_bound_ms"],
                       bound_ms=info[shape]["bound_ms"])
            emit(rec)
            pair[label] = out
            if use_kernels:
                by_path[f"eqv2_{shape}"] += counts["segment_sum"]
        ratios.append({"shape": shape, "seed": seed,
                       **compare_outputs(EQV2_ARCH, pair["kernels"], pair["plain"], EQV2_TOL)})
        outs[shape, seed] = (g, pair["kernels"])

    # the chunked forward: molecule seed 0 in EQV2_CHUNK-edge chunks
    g, out_k = outs["molecule", 0]
    mol = info["molecule"]
    ccfg = dataclasses.replace(spec.config, d_in=mol["d_in"], edge_chunk=EQV2_CHUNK)
    chunks = gnn.eqv2_chunks(mol["edges"], EQV2_CHUNK)
    rec, out_c, counts = gnn_forward(params["molecule"], g, ccfg, True, "kernels")
    by_path["eqv2_chunked"] = counts["segment_sum"]
    check(counts["segment_sum"] == ccfg.n_layers * (1 + chunks),
          f"chunked: {counts['segment_sum']} segment_sum launches for {chunks} chunks")
    emit({"phase": "eqv2_chunked", "edge_chunk": EQV2_CHUNK, "chunks": chunks,
          "segment_sum_launches": counts["segment_sum"], "seconds": rec["seconds"],
          "peak_gib": rec["peak_gib"], "finite": rec["finite"],
          **compare_outputs("equiformer-v2 chunked", out_c, out_k, EQV2_TOL)})
    del out_c

    # a second kernel forward (profiled) repeats the first bit for bit; the
    # rotation gaps of the bf16 stack are reported
    cfg = dataclasses.replace(spec.config, d_in=mol["d_in"])
    out_r, prof = profiled(lambda: gnn.forward(params["molecule"], g, cfg, use_kernels=True),
                           kernels=("segment_sum",))
    seg = prof["named_kernels"]["segment_sum"]
    emit({"phase": "eqv2_profile", "arch": EQV2_ARCH, "shape": "molecule",
          "segment_sum_share": seg["s"] / prof["device_s"] if prof["device_s"] else None,
          **prof})
    repeat = float((out_r.float() - out_k.float()).abs().max())
    check(repeat == 0, f"two EquiformerV2 kernel forwards differ by {repeat}")
    th = 1.1
    rot_z = torch.tensor([[math.cos(th), -math.sin(th), 0.0], [math.sin(th), math.cos(th), 0.0],
                          [0.0, 0.0, 1.0]])
    q, _ = torch.linalg.qr(torch.randn(3, 3, generator=torch.Generator().manual_seed(5),
                                       dtype=torch.float64))
    rot_g = (q * torch.sign(torch.linalg.det(q))).float()
    top = float(out_k.float().abs().max())
    gaps = {}
    for name, rot in (("z_1.1", rot_z), ("general", rot_g)):
        g_rot = dataclasses.replace(g, positions=g.positions @ rot.T.to(g.positions))
        out_t = gnn.forward(params["molecule"], g_rot, cfg, use_kernels=True)
        gaps[name] = float((out_t.float() - out_k.float()).abs().max()) / top
    emit({"phase": "eqv2_equal", "limit_ratio": EQV2_TOL, "requests": ratios,
          "max_ratio": max(r["ratio"] for r in ratios),
          "kernel_repeat_max_abs_diff": repeat, "rotation_gap": gaps})
    del outs, g, out_k, out_r, params
    torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------------------
# GNN training
# ---------------------------------------------------------------------------

def eqv2_train_flops(cfg, nodes: int, edges: int, dense_rotation: bool = True) -> float:
    """FLOP of one EquiformerV2 training step (:func:`eqv2_terms`, with
    ``dense_rotation`` as the port executes the rotations, else as the
    function needs them): the layers' forward, again in the backward's
    recompute (``remat``), and their backward: twice the forward for every
    product of a weight (the gradients of its input and of the weight),
    once for the rotations and the messages' weighting (the rotations take
    no gradient); the edge rotations built once; the embedding's weight
    gradient and the readout's two."""
    rotate, weights, per_node, build = eqv2_terms(cfg, dense_rotation)
    d = cfg.d_hidden
    fwd = cfg.n_layers * (edges * (rotate + weights) + nodes * per_node)
    bwd = cfg.n_layers * (edges * (rotate + 2 * weights) + nodes * 2 * per_node)
    io = 2 * nodes * d * cfg.d_in * 2 + 2 * nodes * d * cfg.d_out * 3
    return float(fwd * (2 if cfg.remat else 1) + bwd + edges * build + io)


def train_grads(params, tg, labels, cfg, use_kernels: bool):
    """One loss and gradient (``gnn_value_and_grad``), synchronized:
    (loss, grads, seconds, peak GiB, launch counts)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import gnn_value_and_grad

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads = gnn_value_and_grad(params, tg, labels, cfg, use_kernels=use_kernels)
    torch.cuda.synchronize()
    return (loss, grads, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30,
            ops.launch_counts())


def grad_gap(got, want, share: float):
    """The largest |got - want| of each gradient over ``share`` times its
    largest |want| plus 1e-6 of the model's largest (a gradient that is
    zero in exact arithmetic is rounding noise in both): the worst such
    ratio (<= 1 passes), and whether every gradient is bit-equal."""
    top = max(float(v.float().abs().max()) for v in want.values())
    worst, equal = 0.0, True
    for k, w in want.items():
        diff = float((got[k].float() - w.float()).abs().max())
        equal = equal and torch.equal(got[k], w)
        limit = share * float(w.float().abs().max()) + 1e-6 * top
        worst = max(worst, diff / limit if limit else (0.0 if diff == 0 else math.inf))
    return worst, equal


def train_cell(arch: str, shape_name: str, gate: float):
    """One architecture's training cell: the checks from one parameter
    draw, then TRAIN_STEPS steps on the kernel path; returns (the
    segment_sum launches of the steps, the kernel_check cases at the
    training shapes)."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import graph_from_numpy
    from repro_torch.data import build_graph_data
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import gnn_counts, gnn_flops, gnn_train_step
    from repro_torch.models import gnn
    from repro_torch.optim import adamw_init

    spec = get_arch(arch)
    shape = spec.shape(shape_name)
    cfg = dataclasses.replace(spec.config, d_in=shape.d_feat)
    eqv2 = cfg.arch == "equiformer_v2"
    nodes, edges = gnn_counts(shape)
    t0 = time.perf_counter()
    raw = build_graph_data(nodes, edges, shape.d_feat, d_edge=cfg.d_edge_in, seed=0,
                           geometric=eqv2)
    g = graph_from_numpy(raw, "cuda")
    deg = np.bincount(raw["dst"][raw["edge_mask"]], minlength=nodes)
    labels = torch.from_numpy((np.minimum(deg, cfg.d_out - 1) if cfg.d_out > 1 else deg)
                              .astype(np.int32)).cuda()
    del raw
    params = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(4), "cuda")
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tg = gnn.train_graph(g, cfg)
    torch.cuda.synchronize()
    plan = {"phase": "gnn_train_plan", "arch": arch, "shape": shape_name, "nodes": nodes,
            "edges": edges, "d_in": cfg.d_in, "d_hidden": cfg.d_hidden, "d_out": cfg.d_out,
            "layers": cfg.n_layers, "dtype": cfg.dtype, "remat": cfg.remat,
            "params": sum(p.numel() for p in params.values()), "data_seconds": data_s,
            "plan_seconds": time.perf_counter() - t0, "edge_chunks": len(tg.ed.plans),
            "model_flops": gnn_flops(cfg, nodes, edges, train=True)["model_flops"]}
    if eqv2:
        plan["executed_flops"] = eqv2_train_flops(cfg, nodes, edges)
        plan["needed_flops"] = eqv2_train_flops(cfg, nodes, edges, dense_rotation=False)
        plan["executed_bound_ms"] = bound_ms(0, plan["executed_flops"])[0]
        plan["bound_ms"] = bound_ms(0, plan["needed_flops"])[0]
    emit(plan)

    # ---- checks from one parameter draw -------------------------------------
    train_grads(params, tg, labels, cfg, True)  # warm-up: first-use costs
    loss_k, g_k, sec_k, peak_k, cnt_k = train_grads(params, tg, labels, cfg, True)
    loss_r, g_r, _, _, _ = train_grads(params, tg, labels, cfg, True)
    loss_p, g_p, sec_p, peak_p, cnt_p = train_grads(params, tg, labels, cfg, False)
    check(not any(cnt_p.values()), f"{arch}: the plain step launched kernels: {cnt_p}")
    check(cnt_k["segment_sum"] > 0, f"{arch}: segment_sum never launched in a step")
    check(not any(v for k, v in cnt_k.items() if k != "segment_sum"),
          f"{arch}: other kernels launched: {cnt_k}")
    finite = all(bool(torch.isfinite(v).all()) for v in (*g_k.values(), loss_k))
    check(finite, f"{arch}: a gradient or the loss is not finite")
    loss_ratio = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    grad_ratio, grad_equal = grad_gap(g_k, g_p, TRAIN_GRAD_TOL)
    check(loss_ratio <= TRAIN_GRAD_TOL and grad_ratio <= 1,
          f"{arch}: kernel vs plain: loss {loss_ratio}, gradients {grad_ratio} of the limit")
    repeat = torch.equal(loss_k, loss_r) and all(torch.equal(g_k[k], g_r[k]) for k in g_k)
    check(repeat, f"{arch}: two kernel steps differ")
    rec = {"phase": "gnn_train_check", "arch": arch, "shape": shape_name,
           "loss_kernels": float(loss_k), "loss_plain": float(loss_p), "loss_ratio": loss_ratio,
           "grad_limit": TRAIN_GRAD_TOL, "grad_worst_over_limit": grad_ratio,
           "grads_bitwise_plain": grad_equal, "repeat_bitwise": repeat,
           "grad_seconds": sec_k, "plain_grad_seconds": sec_p, "peak_gib": peak_k,
           "plain_peak_gib": peak_p, "segment_sum_launches": cnt_k["segment_sum"]}
    del g_r, g_p
    if arch in REMAT_CHECKED:
        loss_o, g_o, sec_o, peak_o, cnt_o = train_grads(
            params, tg, labels, dataclasses.replace(cfg, remat=False), True)
        top = max(float(v.float().abs().max()) for v in g_k.values())
        gap = max(float((g_o[k].float() - g_k[k].float()).abs().max()) for k in g_k)
        check(gap <= REMAT_TOL * top and float(loss_o) == float(loss_k),
              f"{arch}: remat off differs from on by {gap} (limit {REMAT_TOL} * {top})")
        rec.update(remat_off_max_abs_diff=gap, remat_limit=REMAT_TOL * top,
                   remat_off_bitwise=all(torch.equal(g_o[k], g_k[k]) for k in g_k),
                   remat_off_peak_gib=peak_o, remat_off_seconds=sec_o,
                   remat_off_segment_sum_launches=cnt_o["segment_sum"])
        del g_o
    del g_k
    free_device_memory()
    out_t = gnn.train_forward(params, tg, cfg, use_kernels=True)
    out_i = gnn.forward(params, g, cfg, use_kernels=True)
    fwd = compare_outputs(f"{arch} training forward", out_t.detach(), out_i, gate)
    rec.update(forward_gate=gate, forward_ratio=fwd["ratio"],
               forward_equal_share=fwd["equal_share"])
    emit(rec)
    del out_t, out_i

    # ---- training: TRAIN_STEPS steps on the kernel path ---------------------
    opt = adamw_init(params)
    losses, norms, times, peak = [], [], [], 0.0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        params, opt, loss, gnorm = gnn_train_step(params, opt, tg, labels, cfg, lr=TRAIN_LR,
                                                  use_kernels=True)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
        losses.append(float(loss))
        norms.append(float(gnorm))
        peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    counts = ops.launch_counts()
    check(all(math.isfinite(v) for v in losses + norms), f"{arch}: a loss or norm is not finite")
    check(losses[-1] < losses[0], f"{arch}: the loss did not fall: {losses}")
    check(counts["segment_sum"] == TRAIN_STEPS * cnt_k["segment_sum"],
          f"{arch}: {counts['segment_sum']} segment_sum launches in {TRAIN_STEPS} steps, "
          f"{cnt_k['segment_sum']} a step before")
    rec = {"phase": "gnn_train", "arch": arch, "shape": shape_name, "steps": TRAIN_STEPS,
           "lr": TRAIN_LR, "losses": losses, "gnorms": norms, "step_seconds": times,
           "median_step_seconds": statistics.median(times), "peak_gib": peak,
           "segment_sum_launches": counts["segment_sum"],
           "segment_sum_launches_per_step": counts["segment_sum"] // TRAIN_STEPS}
    if eqv2:
        rec["executed_tflops_per_s"] = plan["executed_flops"] / rec["median_step_seconds"] / 1e12
        rec["bound_share"] = plan["bound_ms"] / 1e3 / rec["median_step_seconds"]
        rec["model_flops"] = plan["model_flops"]
        _, prof = profiled(lambda: gnn_train_step(params, opt, tg, labels, cfg, lr=TRAIN_LR,
                                                  use_kernels=True), kernels=("segment_sum",))
        seg = prof["named_kernels"]["segment_sum"]
        rec["profile"] = {"segment_sum_share": seg["s"] / prof["device_s"]
                          if prof["device_s"] else None, **prof}
    emit(rec)

    # ---- segment_sum at the training shapes ----------------------------------
    ed, n = tg.ed, g.n
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = (cfg.l_max + 1) ** 2 * cfg.d_hidden  # EquiformerV2's [E, dim, d] features
    width = {"equiformer_v2": (rows, rows),
             "graphsage": (cfg.d_hidden, cfg.d_in)}.get(cfg.arch, (cfg.d_hidden, cfg.d_hidden))
    kind = torch.float32 if eqv2 else cfg.tdtype
    src_ids = torch.where(ed.seg < n, ed.src, n).to(torch.int32)
    cases = []
    for name, ids, tplan, d in ((f"{arch}_train_src", src_ids, tg.src_plan, width[0]),
                                (f"{arch}_train_dst", ed.seg, tg.seg_plan, width[1])):
        data = torch.randn((edges, d), generator=gen, device="cuda").to(kind)
        cases.append(segment_sum_case(name, data, ids, n, tplan, True))
        del data
    del tg, g, params, opt
    free_device_memory()
    return counts["segment_sum"], cases


def gnn_mesh_phase():
    """``gnn_mesh``: one step of ``gnn_train_step`` on a train graph built
    with ``mesh=`` a ``(1, 1)`` ``GridMesh`` over a process group of world
    size 1 started here (NCCL), for each of GNN_MESH_ARCHS at ``_FULL`` on
    ``molecule``, with the kernels (EquiformerV2 through the channel-split
    gather and segment sum), against the one-device ``gnn_train_step`` on
    the same parameters and graph: loss and norm (GNN_MESH_LIMIT), and
    after the update every parameter and both moments, which the grid must
    reproduce bit for bit; the launches a step as the one device's, the
    collectives' calls and bytes by kind and axis. Returns the mesh steps'
    segment_sum launches by path."""
    import socket

    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.convert import graph_from_numpy, graph_shard
    from repro_torch.data import build_graph_data
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_grid_mesh
    from repro_torch.launch.steps import gnn_adamw_init, gnn_counts, gnn_train_step
    from repro_torch.models import gnn
    from repro_torch.optim import adamw_init

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    t0 = time.perf_counter()
    mesh = init_grid_mesh(1, 1, "cuda", timeout_s=300)
    init_s = time.perf_counter() - t0
    by_path = {}
    try:
        backend = dist.get_backend()
        for arch in GNN_MESH_ARCHS:
            spec = get_arch(arch)
            shape = spec.shape(GNN_MESH_SHAPE)
            cfg = dataclasses.replace(spec.config, d_in=shape.d_feat)
            nodes, edges = gnn_counts(shape, mesh.world)
            raw = build_graph_data(nodes, edges, shape.d_feat, d_edge=cfg.d_edge_in, seed=0,
                                   geometric=cfg.arch == "equiformer_v2")
            deg = np.bincount(raw["dst"][raw["edge_mask"]], minlength=nodes)
            labels = torch.from_numpy((np.minimum(deg, cfg.d_out - 1) if cfg.d_out > 1
                                       else deg).astype(np.int32)).cuda()
            params = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(4), "cuda")
            runs = {}
            for kind in ("single", "mesh"):
                if kind == "mesh":
                    tg = gnn.train_graph(graph_shard(raw, mesh, device="cuda"), cfg, mesh=mesh)
                    opt = gnn_adamw_init(params, cfg, mesh)
                else:
                    tg = gnn.train_graph(graph_from_numpy(raw, "cuda"), cfg)
                    opt = adamw_init(params)
                gnn_train_step(params, opt, tg, labels, cfg, lr=TRAIN_LR, use_kernels=True)
                torch.cuda.synchronize()   # warm-up: first-use costs
                ops.reset_launch_counts()
                mesh.reset_counts()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                p2, o2, loss, norm = gnn_train_step(params, opt, tg, labels, cfg, lr=TRAIN_LR,
                                                    use_kernels=True)
                torch.cuda.synchronize()
                runs[kind] = {"param": p2, "mu": o2.mu, "nu": o2.nu, "loss": float(loss),
                              "gnorm": float(norm),
                              "seconds": time.perf_counter() - t0,
                              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                              "launches": ops.launch_counts(), "calls": dict(mesh.calls),
                              "bytes": dict(mesh.bytes)}
                del tg, opt
            one, grid = runs["single"], runs["mesh"]
            # at (1, 1) a rank's ZeRO-1 moments are the whole leaves
            state_gap = {}
            for kind in ("param", "mu", "nu"):
                check(sorted(grid[kind]) == sorted(one[kind]), f"gnn_mesh {arch}: {kind} leaves")
                gaps = {k: float((grid[kind][k].float() - v.float()).abs().max())
                        for k, v in one[kind].items()}
                state_gap[kind] = {"max_abs_diff": max(gaps.values()),
                                   "leaves_differing": sorted(k for k, g in gaps.items() if g)}
            rec = {"phase": "gnn_mesh", "arch": arch, "shape": GNN_MESH_SHAPE, "grid": [1, 1],
                   "backend": backend, "nodes": nodes, "edges": edges, "layers": cfg.n_layers,
                   "dtype": cfg.dtype, "loss_mesh": grid["loss"], "loss_single": one["loss"],
                   "loss_ratio": abs(grid["loss"] - one["loss"]) / abs(one["loss"]),
                   "gnorm_mesh": grid["gnorm"], "gnorm_single": one["gnorm"],
                   "gnorm_ratio": abs(grid["gnorm"] - one["gnorm"]) / one["gnorm"],
                   "limit": GNN_MESH_LIMIT, "params": len(one["param"]),
                   "state_after_step": state_gap, "step_seconds": grid["seconds"],
                   "single_step_seconds": one["seconds"], "peak_gib": grid["peak_gib"],
                   "single_peak_gib": one["peak_gib"],
                   "launches": {k: n for k, n in grid["launches"].items() if n},
                   "collective_calls": grid["calls"], "collective_bytes": grid["bytes"]}
            emit(rec)
            check(math.isfinite(grid["loss"]) and math.isfinite(grid["gnorm"]),
                  f"gnn_mesh {arch}: loss {grid['loss']}, norm {grid['gnorm']}")
            check(rec["loss_ratio"] <= GNN_MESH_LIMIT and rec["gnorm_ratio"] <= GNN_MESH_LIMIT,
                  f"gnn_mesh {arch}: against one device loss {rec['loss_ratio']}, gnorm "
                  f"{rec['gnorm_ratio']} > {GNN_MESH_LIMIT}")
            for kind, gap in state_gap.items():
                check(not gap["leaves_differing"],
                      f"gnn_mesh {arch}: the updated {kind} differs from one device's in "
                      f"{gap['leaves_differing']} (max |diff| {gap['max_abs_diff']})")
            check(grid["launches"] == one["launches"] and grid["launches"]["segment_sum"] > 0,
                  f"gnn_mesh {arch}: launches {grid['launches']} != one device's "
                  f"{one['launches']}")
            want = (("all_to_all/model", "all_gather/data", "reduce_scatter/data",
                     "all_reduce/data,model") if cfg.arch == "equiformer_v2" else
                    ("all_gather/data,model", "reduce_scatter/data,model"))
            for kind in want:
                check(grid["calls"].get(kind, 0) > 0,
                      f"gnn_mesh {arch}: no {kind} collective: {grid['calls']}")
            by_path[f"gnn_mesh_{arch}"] = grid["launches"]["segment_sum"]
            del runs, one, grid, params
            free_device_memory()
    finally:
        dist.destroy_process_group()
    emit({"phase": "gnn_mesh_done", "backend": backend, "init_process_group_s": init_s,
          "seconds": time.perf_counter() - t_phase})
    check(backend == "nccl", f"gnn_mesh: backend {backend}")
    return by_path


def gnn_train_phase():
    """GNN training at full width: the four TRAIN_CELLS. Returns the
    segment_sum launches by training path and the kernel_check cases."""
    by_path, cases = {}, []
    for arch, shape_name, gate in TRAIN_CELLS:
        by_path[f"train_{arch}_{shape_name}"], more = train_cell(arch, shape_name, gate)
        cases += more
    emit({"phase": "kernel_check", "segment_sum": cases})
    return by_path, cases


# ---------------------------------------------------------------------------
# LM slice: flash_attention and phi4-mini-3.8b serving
# ---------------------------------------------------------------------------

def attention_work(b, hq, hkv, lq, lk, dh, off, causal, elem, dv=None):
    """The function's keys admitted per query row, operations and bytes:
    2 * b * hq * (dh + dv) FLOP per admitted (query, key) pair (4 * dh when
    the value width ``dv`` is dh); q (dh) and out (dv) once, and the
    admitted key (dh) and value (dv) rows of each KV head once."""
    dv = dh if dv is None else dv
    admitted = off + lq if causal else lk
    pairs = lq * off + lq * (lq + 1) // 2 if causal else lq * lk
    flops = 2 * b * hq * (dh + dv) * pairs
    n_bytes = elem * (b * hq * lq * (dh + dv) + b * hkv * admitted * (dh + dv))
    return admitted, flops, n_bytes


def sdpa_call(q, k, v, off, causal):
    """One ``scaled_dot_product_attention`` call computing the same
    function, on K/V cut to the admitted keys (its yardstick; the port
    never calls it)."""
    import torch.nn.functional as F

    lq = q.shape[2]
    admitted = off + lq if causal else k.shape[2]
    kc, vc = k[:, :, :admitted].contiguous(), v[:, :, :admitted].contiguous()
    if causal and lq == admitted:
        return lambda: F.scaled_dot_product_attention(q, kc, vc, is_causal=True, enable_gqa=True)
    mask = None
    if causal:
        i = torch.arange(lq, device=q.device)[:, None]
        mask = torch.arange(admitted, device=q.device)[None, :] <= i + (admitted - lq)
    return lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask, enable_gqa=True)


def v_layout_ms(q, k, v, vpad, got, off, causal):
    """Device ms of one decode call (20 in a row) on V of Dv < Dqk handed
    over as ``models/transformer.py`` ``_mla_attention`` builds it, a
    head-major view of the ``[B, Lk, H·Dv]`` product, three ways: the view
    itself (the wrapper's one pad), the view made contiguous first (a copy,
    then the pad), and the view written into a zero-filled Dqk-wide buffer
    (a fill and a strided write, the output sliced); and, for the pad's
    cost, the kernel alone on ``vpad``, V padded before the call. Each
    gives ``got`` bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    b, hkv, lk, dv = v.shape
    view = v.transpose(1, 2).contiguous().transpose(1, 2)

    def zero_filled():
        vp = torch.zeros((b, hkv, lk, q.shape[-1]), dtype=v.dtype, device=v.device)
        vp[..., :dv] = view
        return flash_attention_cuda(q, k, vp, causal=causal, q_offset=off)[..., :dv]

    ways = {"view_padded_in_wrapper": lambda: flash_attention_cuda(q, k, view, causal=causal,
                                                                   q_offset=off),
            "contiguous_then_padded": lambda: flash_attention_cuda(q, k, view.contiguous(),
                                                                   causal=causal, q_offset=off),
            "zero_filled_buffer": zero_filled,
            "padded_before_the_call": lambda: flash_attention_cuda(
                q, k, vpad, causal=causal, q_offset=off)[..., :dv]}
    for name, fn in ways.items():
        check(torch.equal(fn(), got), f"flash_attention decode on V {name}: not the "
                                      f"contiguous call's output bit for bit")
    return {name: cuda_ms(fn, per=20) for name, fn in ways.items()}


def flash_attention_phase():
    """The attention kernel against its plain version at the serving
    shapes and at edge cases, each timed beside its plain version, SDPA
    and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda, route

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    mx = LM_PROMPT + LM_GEN
    # name: (b, hq, hkv, lq, lk, dh, q_offset, causal, dtypes[, dv])
    cases = {
        "prefill": (LM_BATCH, 24, 8, LM_PROMPT, mx, 128, 0, True, (bf16,)),
        "chunk_2": (LM_BATCH, 24, 8, LM_CHUNK, mx, 128, LM_CHUNK, True, (bf16,)),
        "decode_first": (LM_BATCH, 24, 8, 1, mx, 128, LM_PROMPT, True, (bf16,)),
        "decode_last": (LM_BATCH, 24, 8, 1, mx, 128, mx - 2, True, (bf16,)),
        # command-r-35b's grouping (64 query heads over 8 KV heads): each KV
        # head's cache is read once for its 8 query rows
        "decode_group8": (LM_BATCH, 64, 8, 1, mx, 128, LM_PROMPT, True, (bf16,)),
        "prefill_dh64": (2, 32, 8, 4096, 4100, 64, 0, True, (bf16,)),
        "prefill_f32_gate": (LM_EQ_BATCH, 24, 8, LM_EQ_PROMPT, LM_EQ_PROMPT + LM_EQ_GEN, 128, 0,
                             True, (f32,)),
        "dh8": (2, 6, 2, 300, 333, 8, 0, True, (f32, bf16)),
        "dh64_mha": (2, 8, 8, 257, 257, 64, 0, True, (f32, bf16)),
        "lq1": (3, 6, 2, 1, 1000, 128, 517, True, (f32, bf16)),
        "offset_plus_lq_eq_lk": (1, 6, 2, 100, 357, 128, 257, True, (f32, bf16)),
        "noncausal": (2, 6, 2, 200, 512, 128, 0, False, (f32, bf16)),
        "lk_not_tile_multiple": (1, 3, 1, 1000, 1001, 128, 1, True, (f32, bf16)),
        "dh256_short": (1, 4, 2, 9, 40, 256, 31, True, (f32, bf16)),
        # Dh 20: five 16-byte float32 chunks, a partial column block
        "dh20": (2, 4, 2, 50, 77, 20, 27, True, (f32,)),
        "dh20_lq3": (2, 4, 2, 3, 77, 20, 74, True, (f32,)),
        # MLA (LM_CELLS' shapes): q and k of qk_nope + qk_rope columns, v of
        # v_head columns (the last field), as models/transformer.py
        # _mla_attention calls the kernels; prefill on the tensor cores at
        # those widths, decode at group 1 on V the wrapper pads
        "mla_minicpm3_prefill": (4, 40, 40, 4096, 4112, 96, 0, True, (bf16,), 64),
        "mla_deepseek_prefill": (4, 16, 16, 4096, 4112, 192, 0, True, (bf16,), 128),
        "mla_minicpm3_decode": (4, 40, 40, 1, 4112, 96, 4096, True, (bf16,), 64),
        "mla_deepseek_decode": (4, 16, 16, 1, 4112, 192, 4096, True, (bf16,), 128),
        # the MLA float32 gates (LM_CELLS' gate shapes): prefill on the CUDA
        # cores and decode, each on V the wrapper pads to Dqk
        "mla_minicpm3_f32_gate": (2, 40, 40, 1024, 1032, 96, 0, True, (f32,), 64),
        "mla_deepseek_f32_gate": (2, 16, 16, 512, 520, 192, 0, True, (f32,), 128),
        "mla_minicpm3_f32_gate_decode": (2, 40, 40, 1, 1032, 96, 1024, True, (f32,), 64),
        "mla_deepseek_f32_gate_decode": (2, 16, 16, 1, 520, 192, 512, True, (f32,), 128),
        # granite-moe-3b-a800m (Dh 64, 24 query heads over 8) and command-r-35b
        # (Dh 128, 64 over 8) at LM_CELLS' shapes: prefill on the tensor cores
        "granite_prefill": (4, 24, 8, 8192, 8208, 64, 0, True, (bf16,)),
        "granite_decode": (4, 24, 8, 1, 8208, 64, 8192, True, (bf16,)),
        "command_r_prefill": (2, 64, 8, 4096, 4112, 128, 0, True, (bf16,)),
        "command_r_decode": (2, 64, 8, 1, 4112, 128, 4096, True, (bf16,)),
    }
    # Dh 20 in bf16 is not a whole number of 16-byte chunks: refused
    q, k = (torch.zeros(s, device="cuda", dtype=bf16) for s in ((1, 2, 3, 20), (1, 2, 9, 20)))
    try:
        flash_attention_cuda(q, k, k, causal=True, q_offset=0)
        fail("flash_attention took a bf16 Dh of 20")
    except ValueError:
        pass
    out = []
    for name, (b, hq, hkv, lq, lk, dh, off, causal, dtypes, *rest) in cases.items():
        dv = rest[0] if rest else dh
        for dtype in dtypes:
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                       for s in ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dv)))
            kind = route(lq, dtype, dh, dv)
            got = flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
            check(tuple(got.shape) == (b, hq, lq, dv), f"flash_attention {name}: output "
                                                       f"{tuple(got.shape)}")
            want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off)
            want32, limit = ref.flash_attention_limits(q, k, v, causal, off)
            dev = (got.float() - want32).abs()
            worst = float((dev / limit).max())
            err = float((got.float() - want.float()).abs().max())
            tag = str(dtype).split(".")[-1]
            check(worst <= 1.0, f"flash_attention {name} {tag}: |kernel - plain in float32| "
                                f"reaches {worst} of its limit")
            rec = {"case": name, "dtype": tag, "route": kind, "b": b, "hq": hq,
                   "hkv": hkv, "lq": lq, "lk": lk, "dh": dh, "q_offset": off, "causal": causal,
                   "max_abs_err": err,
                   "max_abs_ref": float(want32.abs().max()),
                   "max_abs_err_f32_plain": float(dev.max()), "max_err_over_limit": worst}
            del want32, limit, dev
            admitted, flops, n_bytes = attention_work(b, hq, hkv, lq, lk, dh, off, causal,
                                                      q.element_size(), dv)
            if dv != dh:
                rec["dv"] = dv
                if kind == "tc":   # the split P's second product, at V's own width
                    rec["issued_flops"] = flops + (flops // (dh + dv)) * dv
                else:              # the one-width kernels run on V padded to dh
                    _, rec["padded_flops"], rec["padded_bytes"] = attention_work(
                        b, hq, hkv, lq, lk, dh, off, causal, q.element_size())
            rec["ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                             q_offset=off))
            rec["plain_ms"] = cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, q_offset=off), reps=3)
            rec["library_ms"] = cuda_ms(sdpa_call(q, k, v, off, causal))
            if dv != dh:
                # SDPA above on V at its own width; here on V zero-padded to dh
                rec["library_v"] = "own width"
                vpad = torch.nn.functional.pad(v, (0, dh - dv))
                rec["library_padded_ms"] = cuda_ms(sdpa_call(q, k, vpad, off, causal))
                if kind != "tc":
                    # the one-width kernel alone on V padded before the call:
                    # ms less this is the wrapper's pad
                    rec["padded_input_ms"] = cuda_ms(lambda: flash_attention_cuda(
                        q, k, vpad, causal=causal, q_offset=off))
                if kind == "decode":
                    rec["v_layout_ms_back_to_back"] = v_layout_ms(q, k, v, vpad, got, off, causal)
                del vpad
            if rec["ms"] < 1.0:
                # device time without the host's share: 20 calls between two events
                rec["ms_back_to_back"] = cuda_ms(lambda: flash_attention_cuda(
                    q, k, v, causal=causal, q_offset=off), per=20)
                rec["library_ms_back_to_back"] = cuda_ms(sdpa_call(q, k, v, off, causal), per=20)
            rec["admitted_keys"], rec["flops"], rec["bytes"] = admitted, flops, n_bytes
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                n_bytes, flops, PEAK_BF16_FLOPS if dtype == bf16 else PEAK_OPS_PER_S)
            rec["tflop_per_s"] = flops / rec["ms"] / 1e9
            out.append(rec)
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def flash_kernels_line():
    """Registers, static shared, local (spill) and dynamic shared bytes of
    each flash kernel at its main-path instantiation (``cudaFuncGetAttributes``),
    and the decode grid the wrapper plans at phi4-mini's decode shape."""
    import importlib

    from repro_torch.kernels import build

    # the module (the package's ``flash_attention`` is the dispatch function)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    attrs = {"tc_dh128": fa.kernel_attributes("tc", bf16, 128),
             "tc_dh64": fa.kernel_attributes("tc", bf16, 64),
             # MLA's prefill: minicpm3-4b (Dqk 96, Dv 64), deepseek-v2-lite-16b (192, 128)
             "tc_dqk96_dv64": fa.kernel_attributes("tc", bf16, 96, dv=64),
             "tc_dqk192_dv128": fa.kernel_attributes("tc", bf16, 192, dv=128),
             "decode_rows3": fa.kernel_attributes("decode", bf16, 128, 3),
             "decode_rows8": fa.kernel_attributes("decode", bf16, 128, 8),
             # the float32 gates' prefill: phi4 / granite (Dh 128 / 64), MLA's (96 / 192)
             "simt_f32": fa.kernel_attributes("simt", f32, 128),
             "simt_f32_dh96": fa.kernel_attributes("simt", f32, 96),
             "simt_f32_dh192": fa.kernel_attributes("simt", f32, 192),
             "decode_rows1_dh96": fa.kernel_attributes("decode", bf16, 96, 1),
             "decode_rows1_dh192": fa.kernel_attributes("decode", bf16, 192, 1)}
    for name in ("tc_dh128", "tc_dh64", "tc_dqk96_dv64", "tc_dqk192_dv128"):
        check(attrs[name]["local_bytes"] == 0,
              f"flash_attention {name} spills: {attrs[name]['local_bytes']} local bytes")
    rows, chunks, _ = fa.decode_rows(24, 8, 1)
    slots = fa.decode_slots(torch.device("cuda", torch.cuda.current_device()), 1, 128, rows)
    heads = LM_BATCH * 8 * chunks
    splits, kps = fa.plan_splits(heads, LM_PROMPT + 1, slots,
                                 build.library().flash_decode_max_splits())
    return {"phase": "flash_kernels", "attributes": attrs,
            "decode_grid": {"rows": rows, "resident_blocks": slots, "splits": splits,
                            "keys_per_split": kps, "blocks": heads * splits}}


def lm_run(cfg, params, prompt, gen: int, use_kernels: bool, label: str, forced=None,
           phase: str = "lm_serve"):
    """One ``serve`` call (prefill + gen - 1 decode steps); its record,
    result and launch counts, the counts taken over exactly this call."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve(cfg, params, prompt, gen, use_kernels=use_kernels, forced=forced)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    b = prompt.shape[0]
    prefill_s = res.records[0]["seconds"]
    decode = [r["seconds"] for r in res.records[1:]]
    rec = {"phase": phase, "arch": cfg.name, "run": label, "dtype": cfg.dtype, "batch": b,
           "prompt_len": prompt.shape[1], "gen": gen, "teacher_forced": forced is not None,
           "prefill_seconds": prefill_s, "decode_seconds": sum(decode),
           "decode_ms_per_step": 1e3 * sum(decode) / len(decode),
           "decode_ms_median": 1e3 * statistics.median(decode),
           "decode_tokens_per_s": b * len(decode) / sum(decode),
           "generated_tokens_per_s": b * gen / wall, "wall_seconds": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "flash_attention_launches": counts["flash_attention"],
           "flash_attention_tc_launches": counts["flash_attention_tc"],
           "flash_decode_launches": counts["flash_decode"],
           "finite": bool(torch.isfinite(res.logits).all()),
           "ids_first_request": res.ids[0].tolist()}
    check(rec["finite"], f"{cfg.name} {label}: logits are not finite")
    check(tuple(res.ids.shape) == (b, gen), f"{cfg.name} {label}: ids {tuple(res.ids.shape)}")
    return rec, res, counts


def step_ratios(res_k, res_p):
    """max |kernel - plain| / max |plain| of the logits at each step."""
    out = []
    for i in range(res_k.logits.shape[1]):
        lk, lp = res_k.logits[:, i].float(), res_p.logits[:, i].float()
        out.append(float((lk - lp).abs().max()) / float(lp.abs().max()))
    return out


def lm_phase():
    """phi4-mini-3.8b serving at full width: kernels, plain, chunked,
    profiled, and the float32 gate; returns the kernel run's launches.
    A prefill launches the tensor-core kernel once a layer (the float32
    gate the CUDA-core kernel), a decode step the split-K decode kernel
    once a layer."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.models import transformer as tf
    import dataclasses

    cfg = get_arch(LM_ARCH).config
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 2**30
    prompt = torch.from_numpy(prompt_tokens(cfg.vocab, LM_BATCH, LM_PROMPT, 0)).cuda()
    predicted = {"flash_attention": cfg.n_layers, "flash_decode": cfg.n_layers * (LM_GEN - 1)}
    emit({"phase": "lm_plan", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "d_head": cfg.d_head,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
          "params": cfg.param_count(), "batch": LM_BATCH, "prompt_len": LM_PROMPT,
          "gen": LM_GEN, "max_len": LM_PROMPT + LM_GEN,
          "predicted_launches": predicted, "init_seconds": init_s,
          "resident_gib": resident})

    rec, res_k, counts = lm_run(cfg, params, prompt, LM_GEN, True, "kernels")
    rec["resident_gib"] = resident
    emit(rec)
    for name, n in predicted.items():
        check(counts[name] == n, f"{name} launched {counts[name]} times, predicted {n}")
    check(counts["flash_attention_tc"] == cfg.n_layers,
          f"{counts['flash_attention_tc']} of the {cfg.n_layers} bf16 prefill launches took "
          "the tensor-core kernel")
    others = {k: n for k, n in counts.items()
              if k not in predicted and k != "flash_attention_tc" and n}
    check(not others, f"other kernels launched on the LM path: {others}")
    rec, res_p, plain_counts = lm_run(cfg, params, prompt, LM_GEN, False, "plain",
                                      forced=res_k.ids)
    rec["resident_gib"] = resident
    emit(rec)
    check(not any(plain_counts.values()), f"the plain serve launched kernels: {plain_counts}")
    ratios = step_ratios(res_k, res_p)
    bf16_equal = {"dtype": "bfloat16", "max_ratio": max(ratios), "step_ratios": ratios,
                  "equal_token_share": float((res_k.ids == res_p.ids).float().mean())}
    del res_p
    torch.cuda.empty_cache()

    # chunked prefill against the kernel run's unchunked prefill
    from repro_torch.kernels import ops

    cache = tf.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_c, _ = tf.prefill_chunked(params, prompt, cache, cfg, chunk=LM_CHUNK, use_kernels=True)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    chunk_counts = ops.launch_counts()
    n_chunk = chunk_counts["flash_attention"]
    n_chunk_tc = chunk_counts["flash_attention_tc"]
    want = cfg.n_layers * (LM_PROMPT // LM_CHUNK)
    check(n_chunk == want and n_chunk_tc == want and chunk_counts["flash_decode"] == 0,
          f"chunked prefill launched {chunk_counts} ({n_chunk_tc} on the tensor cores), "
          f"predicted {want} flash_attention, all on the tensor cores")
    whole = res_k.logits[:, 0].float()
    rec = {"phase": "lm_chunked", "chunk": LM_CHUNK, "seconds": chunked_s,
           "flash_attention_launches": n_chunk, "flash_attention_tc_launches": n_chunk_tc,
           "finite": bool(torch.isfinite(logits_c).all()),
           "logits_max_abs_diff": float((logits_c[:, -1].float() - whole).abs().max()),
           "logits_max_abs_unchunked": float(whole.abs().max()),
           "same_first_token": bool(torch.equal(logits_c[:, -1].argmax(-1), res_k.ids[:, 0]))}
    for i, name in enumerate(("k", "v")):
        a = cache["dense"][i][:, :, :, :LM_PROMPT].float()
        b = res_k.cache["dense"][i][:, :, :, :LM_PROMPT].float()
        rec[f"cache_{name}_max_abs_diff"] = float((a - b).abs().max())
        rec[f"cache_{name}_max_abs"] = float(b.abs().max())
        del a, b
    emit(rec)
    check(rec["finite"], "chunked prefill logits are not finite")
    check(rec["same_first_token"], "chunked prefill picks another first token")
    for name in ("logits", "cache_k", "cache_v"):
        top = rec["logits_max_abs_unchunked" if name == "logits" else f"{name}_max_abs"]
        check(rec[f"{name}_max_abs_diff"] <= 1e-2 * top,
              f"chunked prefill {name}: max |chunked - unchunked| "
              f"{rec[f'{name}_max_abs_diff']} > 1e-2 * {top}")
    del cache, logits_c, res_k
    torch.cuda.empty_cache()

    # where a prefill's and a decode step's device time goes
    cache = tf.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN)
    (logits, _), prof = profiled(lambda: tf.prefill(params, prompt, cache, cfg,
                                                    use_kernels=True))
    emit({"phase": "lm_profile", "arch": cfg.name, "stage": "prefill", **prof})
    tok = logits[:, -1].argmax(-1)[:, None]
    _, prof = profiled(lambda: tf.decode_step(params, tok, cache, LM_PROMPT, cfg,
                                              use_kernels=True))
    emit({"phase": "lm_profile", "arch": cfg.name, "stage": "decode", "pos": LM_PROMPT, **prof})
    del cache, params, logits
    torch.cuda.empty_cache()

    # the gate: the same model in float32, kernels against plain
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tf.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompt32 = torch.from_numpy(prompt_tokens(cfg.vocab, LM_EQ_BATCH, LM_EQ_PROMPT, 1)).cuda()
    rec_k, res_k, c32 = lm_run(cfg32, params32, prompt32, LM_EQ_GEN, True, "kernels")
    rec_p, res_p, _ = lm_run(cfg32, params32, prompt32, LM_EQ_GEN, False, "plain",
                             forced=res_k.ids)
    check(c32["flash_attention"] == cfg.n_layers and c32["flash_attention_tc"] == 0
          and c32["flash_decode"] == cfg.n_layers * (LM_EQ_GEN - 1),
          f"float32 run launched {c32}")
    ratios = step_ratios(res_k, res_p)
    f32_equal = {"dtype": "float32", "batch": LM_EQ_BATCH, "prompt_len": LM_EQ_PROMPT,
                 "gen": LM_EQ_GEN, "limit_ratio": 1e-3, "max_ratio": max(ratios),
                 "step_ratios": ratios,
                 "equal_token_share": float((res_k.ids == res_p.ids).float().mean()),
                 "kernel_prefill_seconds": rec_k["prefill_seconds"],
                 "plain_prefill_seconds": rec_p["prefill_seconds"],
                 "kernel_decode_ms_per_step": rec_k["decode_ms_per_step"],
                 "plain_decode_ms_per_step": rec_p["decode_ms_per_step"]}
    emit({"phase": "lm_equal", "gate": f32_equal, "reported": bf16_equal})
    check(max(ratios) <= 1e-3, f"float32 logits: max |kernel - plain| / max |plain| "
                               f"{max(ratios)} > 1e-3")
    del params32, res_k, res_p
    torch.cuda.empty_cache()
    return counts, c32


# ---------------------------------------------------------------------------
# LM slice, the other four configurations: MLA, MoE and command-r-35b
# ---------------------------------------------------------------------------

# phase, arch, prompts, prompt tokens, generated tokens, the float32 gate's
# (prompts, prompt tokens, generated tokens) or None. Each at its _FULL
# config with random weights from seed 0; every bf16 prefill on the tensor
# cores (MLA's at its own widths). prefill_32k (32 x 32,768) is cut as
# phi4-mini's is; decode_32k and long_500k are left out. command-r-35b has
# no float32 gate: its weights would take 130 GB.
LM_CELLS = (("mla_serve", "minicpm3-4b", 4, 4096, 16, (2, 1024, 8)),
            ("moe_serve", "deepseek-v2-lite-16b", 4, 4096, 16, (2, 512, 8)),
            ("moe_serve", "granite-moe-3b-a800m", 4, 8192, 16, (2, 1024, 8)),
            ("lm_large", "command-r-35b", 2, 4096, 16, None))
LM_PATHS = {"phi4-mini-3.8b": "phi4", "minicpm3-4b": "minicpm3",
            "deepseek-v2-lite-16b": "deepseek", "granite-moe-3b-a800m": "granite",
            "command-r-35b": "command_r"}
# The absorbed MLA decode against the materialized one on the same bf16
# weights, cache and tokens: max |absorbed - materialized| / max
# |materialized| of each decode step's logits. The two forms round at
# different points (the latent query in bf16, against the expanded keys and
# values in bf16), and bf16 spacing is 2**-8 of a value: a few spacings
# carried through the layers.
ABSORBED_LIMIT = 5e-2
ATTN_KERNELS = ("flash_attention_kernel", "flash_attention_tc_kernel", "flash_decode_kernel")


class Routing:
    """The MoE layers' routing decisions of one serve run, in call order
    (``record``), and a later run made to take them (``replay``): each of
    its ``_moe_route`` calls returns the recorded experts, weighted by its
    own router probabilities of them and renormalized as ``_moe_route``
    does. Where its own top-k set differs (a flip), the row is counted with
    the probability gap between its own k-th choice and the recorded expert
    it ranks lowest. With no flip the replaying run computes what it would
    compute alone. The counts stay on the card until ``replay`` ends."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def record(self):
        from repro_torch.models import transformer as tf

        inner = tf._moe_route
        self.calls = []

        def spy(lp, x, c):
            w, sel = inner(lp, x, c)
            self.calls.append(sel)
            return w, sel

        tf._moe_route = spy
        try:
            yield self
        finally:
            tf._moe_route = inner

    @contextlib.contextmanager
    def replay(self):
        from repro_torch.models import transformer as tf

        inner, queue = tf._moe_route, iter(self.calls)
        acc, stats = [], {"moe_calls": len(self.calls)}

        def forced(lp, x, c):
            sel = next(queue)
            probs = tf._router_probs(lp, x)
            own = tf._top_experts(probs, c.top_k)
            differ = (own.sort(-1).values != sel.sort(-1).values).any(-1)
            kth = probs.gather(-1, own[:, -1:])[:, 0]
            gap = torch.where(differ, kth - probs.gather(-1, sel).min(-1).values, 0.0)
            acc.append((differ.numel(), differ.sum(), gap.max(), (gap / kth).max()))
            return tf._route_weights(probs, sel), sel

        tf._moe_route = forced
        try:
            yield stats
        finally:
            tf._moe_route = inner
        check(next(queue, None) is None, "a replaying run made fewer MoE calls than recorded")
        stats.update(rows=sum(a[0] for a in acc), flips=sum(int(a[1]) for a in acc),
                     max_prob_gap=max((float(a[2]) for a in acc), default=0.0),
                     max_rel_prob_gap=max((float(a[3]) for a in acc), default=0.0))


class ExpertLoop:
    """While ``watch`` is on, per call of the MoE expert loop
    (``transformer._moe_experts``): the rows routed, the experts run, the
    loop's host seconds and those blocked in its one read of the per-expert
    row counts (``_expert_rows``)."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def watch(self):
        from repro_torch.models import transformer as tf

        loop, rows = tf._moe_experts, tf._expert_rows
        self.calls, cur = [], {}

        def timed_rows(experts, n):
            t0 = time.perf_counter()
            out = rows(experts, n)
            cur.update(read_s=time.perf_counter() - t0, rows=sum(out),
                       experts=sum(1 for r in out if r))
            return out

        def timed_loop(lp, x, w, sel, c):
            t0 = time.perf_counter()
            out = loop(lp, x, w, sel, c)
            self.calls.append({**cur, "loop_s": time.perf_counter() - t0})
            return out

        tf._moe_experts, tf._expert_rows = timed_loop, timed_rows
        try:
            yield self
        finally:
            tf._moe_experts, tf._expert_rows = loop, rows

    def summary(self, layers: int) -> dict:
        """The first ``layers`` calls (a prefill's) and the rest (decode
        steps'), each: calls, routed rows and experts run a layer (mean),
        the loop's host seconds and the blocking reads' seconds (sums)."""
        def part(cs):
            if not cs:
                return None
            return {"calls": len(cs),
                    "routed_rows_per_layer": statistics.mean(c["rows"] for c in cs),
                    "experts_run_per_layer": statistics.mean(c["experts"] for c in cs),
                    "loop_host_s": sum(c["loop_s"] for c in cs),
                    "count_read_s": sum(c["read_s"] for c in cs)}
        return {"prefill": part(self.calls[:layers]), "decode": part(self.calls[layers:])}


def lm_prefill_flops(cfg, b: int, s: int, max_len: int) -> int:
    """The products' FLOP of one prefill of ``b`` prompts of ``s`` tokens
    over a cache of ``max_len`` positions: 2 per weight a token reads in each
    layer (MoE: the router, its top_k experts and the shared ones), for MLA
    K and V expanded from the whole latent cache once a layer, the
    attention's 2 * (Dqk + Dv) per admitted (query, key) pair and head, and
    the last position's lm_head."""
    from repro_torch.models import transformer as tf

    t, d = b * s, cfg.d_model
    pairs = b * s * (s + 1) // 2
    attn = tf._attn_shapes(cfg)
    if cfg.attn == "mla":
        per_token = sum(math.prod(attn[n]) for n in ("wq", "wq_a", "wq_b", "wkv_a", "wo")
                        if n in attn)
        expand = 2 * b * max_len * (math.prod(attn["wk_b"]) + math.prod(attn["wv_b"]))
        attention = 2 * cfg.n_heads * (cfg.qk_nope + cfg.qk_rope + cfg.v_head) * pairs
    else:
        per_token = sum(math.prod(attn[n]) for n in ("wq", "wk", "wv", "wo"))
        expand = 0
        attention = 4 * cfg.n_heads * cfg.d_head * pairs
    dense_ffn = 3 * d * cfg.d_ff
    moe_ffn = d * cfg.n_experts + 3 * d * cfg.d_expert * (cfg.top_k + cfg.n_shared)
    layers = ((2 * t * per_token + expand + attention) * cfg.n_layers
              + 2 * t * (dense_ffn * cfg.n_dense_layers + moe_ffn * cfg.n_moe_layers))
    return layers + 2 * b * d * cfg.vocab


def lm_cell(phase: str, arch: str, batch: int, prompt_len: int, gen: int, gate):
    """One configuration of ``LM_CELLS`` served at full width through
    ``serve``: a ``plan`` record, the kernel run, the plain run
    (teacher-forced on the kernel run's tokens, MoE routing replayed),
    for MLA the absorbed decode, profiled prefill and decode steps, and the
    float32 gate. Returns the kernel run's launches and the gate's kernel
    run's (None without a gate)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.models import transformer as tf

    cfg = get_arch(arch).config
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    resident = torch.cuda.memory_allocated() / 2**30
    max_len = prompt_len + gen
    cache_gib = sum(t.numel() * t.element_size()
                    for g in tf.init_cache(cfg, batch, max_len, "meta").values()
                    for t in g) / 2**30
    prompt = torch.from_numpy(prompt_tokens(cfg.vocab, batch, prompt_len, 0)).cuda()
    n = cfg.n_layers
    predicted = {"flash_attention": n, "flash_attention_tc": n, "flash_decode": n * (gen - 1)}
    flops = lm_prefill_flops(cfg, batch, prompt_len, max_len)
    emit({"phase": phase, "record": "plan", "arch": cfg.name, "attn": cfg.attn, "moe": cfg.moe,
          "layers": n, "dense_layers": cfg.n_dense_layers, "moe_layers": cfg.n_moe_layers,
          "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "d_head": cfg.d_head, "kv_lora": cfg.kv_lora, "qk": cfg.qk_nope + cfg.qk_rope,
          "v_head": cfg.v_head, "experts": cfg.n_experts,
          "experts_padded": cfg.n_experts_padded if cfg.moe else 0, "top_k": cfg.top_k,
          "shared": cfg.n_shared, "d_ff": cfg.d_ff, "d_expert": cfg.d_expert,
          "vocab": cfg.vocab, "dtype": cfg.dtype, "params": cfg.param_count(),
          "active_params": cfg.active_param_count(), "batch": batch,
          "prompt_len": prompt_len, "gen": gen, "max_len": max_len, "prefill_route": "tc",
          "predicted_launches": predicted, "prefill_flops": flops, "init_seconds": init_s,
          "init_peak_gib": init_peak, "resident_gib": resident, "cache_gib": cache_gib})

    routing, loop = Routing(), ExpertLoop()
    with routing.record(), loop.watch():
        rec, res_k, counts = lm_run(cfg, params, prompt, gen, True, "kernels", phase=phase)
    rec.update(resident_gib=resident, prefill_tokens_per_s=batch * prompt_len
               / rec["prefill_seconds"], prefill_tflop_per_s=flops / rec["prefill_seconds"] / 1e12)
    if cfg.moe:
        rec["expert_loop"] = loop.summary(cfg.n_moe_layers)
    emit(rec)
    for name, want in predicted.items():
        check(counts[name] == want, f"{cfg.name}: {name} launched {counts[name]} times, "
                                    f"predicted {want}")
    others = {k: c for k, c in counts.items() if k not in predicted and c}
    check(not others, f"other kernels launched on the {cfg.name} path: {others}")

    with routing.replay() as replayed:
        rec_p, res_p, plain_counts = lm_run(cfg, params, prompt, gen, False, "plain",
                                            forced=res_k.ids, phase=phase)
    rec_p["resident_gib"] = resident
    if cfg.moe:
        rec_p["routing"] = replayed
    emit(rec_p)
    check(not any(plain_counts.values()), f"the plain serve launched kernels: {plain_counts}")
    ratios = step_ratios(res_k, res_p)
    bf16_equal = {"dtype": cfg.dtype, "max_ratio": max(ratios), "step_ratios": ratios,
                  "equal_token_share": float((res_k.ids == res_p.ids).float().mean())}
    if cfg.moe:
        bf16_equal["routing"] = replayed
    del res_p
    free_device_memory()

    if cfg.attn == "mla":
        # the absorbed decode on the same prefill, tokens and routing
        with routing.replay() as replayed:
            rec_a, res_a, ca = lm_run(dataclasses.replace(cfg, decode_absorbed=True), params,
                                      prompt, gen, True, "absorbed", forced=res_k.ids,
                                      phase=phase)
        want = dict(predicted, flash_decode=0)
        check(all(ca[k] == v for k, v in want.items()),
              f"{cfg.name} absorbed run launched {ca}, predicted {want}")
        ar = step_ratios(res_a, res_k)[1:]
        rec_a["absorbed_vs_materialized"] = {
            "limit_ratio": ABSORBED_LIMIT, "max_ratio": max(ar), "step_ratios": ar,
            "prefill_logits_equal": bool(torch.equal(res_a.logits[:, 0], res_k.logits[:, 0])),
            "equal_token_share": float((res_a.ids[:, 1:] == res_k.ids[:, 1:]).float().mean())}
        if cfg.moe:
            rec_a["routing"] = replayed
        rec_a["decode_ms_per_step_materialized"] = rec["decode_ms_per_step"]
        emit(rec_a)
        check(max(ar) <= ABSORBED_LIMIT, f"{cfg.name} absorbed decode: max |absorbed - "
                                         f"materialized| / max {max(ar)} > {ABSORBED_LIMIT}")
        del res_a
    del res_k
    free_device_memory()

    # where a prefill's and a decode step's device time goes
    cache = tf.init_cache(cfg, batch, max_len)
    kernel = "flash_attention_tc_kernel"
    with loop.watch():
        (logits, _), prof = profiled(lambda: tf.prefill(params, prompt, cache, cfg,
                                                        use_kernels=True), ATTN_KERNELS)
    extra = {}
    if cfg.moe:
        extra = {"expert_loop": loop.summary(cfg.n_moe_layers)["prefill"]}
        extra["expert_loop_host_share"] = extra["expert_loop"]["loop_host_s"] / prof["wall_s"]
    emit({"phase": phase, "record": "profile", "arch": cfg.name, "stage": "prefill",
          "attention_kernel": kernel, "attention_share":
          prof["named_kernels"][kernel]["s"] / prof["device_s"], **extra, **prof})
    tok = logits[:, -1].argmax(-1)[:, None]
    with loop.watch():
        _, prof = profiled(lambda: tf.decode_step(params, tok, cache, prompt_len, cfg,
                                                  use_kernels=True), ATTN_KERNELS)
    if cfg.moe:
        extra = {"expert_loop": loop.summary(0)["decode"]}
        extra["expert_loop_host_share"] = extra["expert_loop"]["loop_host_s"] / prof["wall_s"]
    emit({"phase": phase, "record": "profile", "arch": cfg.name, "stage": "decode",
          "pos": prompt_len, "attention_share": prof["named_kernels"]["flash_decode_kernel"]["s"]
          / prof["device_s"], **extra, **prof})
    del cache, logits, params
    free_device_memory()

    equal = {"phase": phase, "record": "equal", "arch": cfg.name, "reported": bf16_equal}
    if gate is None:
        emit(equal)
        return counts, None
    # the gate: the same model in float32, kernels against plain
    eb, ep, eg = gate
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tf.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompt32 = torch.from_numpy(prompt_tokens(cfg.vocab, eb, ep, 1)).cuda()
    with routing.record():
        rec_k, res_k, c32 = lm_run(cfg32, params32, prompt32, eg, True, "kernels", phase=phase)
    with routing.replay() as replayed:
        rec_p, res_p, _ = lm_run(cfg32, params32, prompt32, eg, False, "plain",
                                 forced=res_k.ids, phase=phase)
    want = {"flash_attention": n, "flash_attention_tc": 0, "flash_decode": n * (eg - 1)}
    check(all(c32[k] == v for k, v in want.items()),
          f"{cfg.name} float32 run launched {c32}, predicted {want}")
    ratios = step_ratios(res_k, res_p)
    equal["gate"] = {"dtype": "float32", "batch": eb, "prompt_len": ep, "gen": eg,
                     "limit_ratio": 1e-3, "max_ratio": max(ratios), "step_ratios": ratios,
                     "equal_token_share": float((res_k.ids == res_p.ids).float().mean()),
                     "peak_gib": rec_k["peak_gib"],
                     "kernel_prefill_seconds": rec_k["prefill_seconds"],
                     "plain_prefill_seconds": rec_p["prefill_seconds"],
                     "kernel_decode_ms_per_step": rec_k["decode_ms_per_step"],
                     "plain_decode_ms_per_step": rec_p["decode_ms_per_step"]}
    if cfg.moe:
        equal["gate"]["routing"] = replayed
    emit(equal)
    check(max(ratios) <= 1e-3, f"{cfg.name} float32 logits: max |kernel - plain| / max |plain| "
                               f"{max(ratios)} > 1e-3")
    del params32, res_k, res_p
    free_device_memory()
    return counts, c32


# ---------------------------------------------------------------------------
# DLRM slice: embedding_bag and dlrm-rm2 serving
# ---------------------------------------------------------------------------

def dlrm_lookups(batch: int, sizes, v: int, gen):
    """Row indices and bag ids of one DLRM forward over the stacked tables
    (models/dlrm.py ``_embedding_bags``): ``sizes[f]`` uniform ids of field
    f per example, row ``f * v + id``, bag ``b * F + f``, sorted by bag."""
    n_f = len(sizes)
    field = torch.repeat_interleave(torch.arange(n_f, device="cuda"),
                                    torch.tensor(sizes, device="cuda"))          # [per example]
    ids = torch.randint(0, v, (batch, field.shape[0]), generator=gen, device="cuda")
    rows = (field[None, :] * v + ids).to(torch.int32).reshape(-1)
    bags = (torch.arange(batch, device="cuda")[:, None] * n_f + field[None, :])
    return rows, bags.to(torch.int32).reshape(-1), batch * n_f


def bag_limits(table, idx, bag, nb):
    """float64 bag sums of the rows in range, the limit a float32 sum is
    held to (n_b * 2**-23 * sum |rows|), the rows per bag and the bags with
    an out-of-range row (NaN by contract)."""
    v, d = table.shape
    keep = (bag >= 0) & (bag < nb)
    b, i = bag[keep].long(), idx[keep].long()
    ok = (i >= 0) & (i < v)
    rows = table[i.clamp(0, v - 1)].double()
    s = torch.zeros((nb, d), dtype=torch.float64, device="cuda").index_add_(0, b, rows)
    a = torch.zeros_like(s).index_add_(0, b, rows.abs())
    cnt = torch.bincount(b, minlength=nb)[:, None].double()
    nan = torch.zeros(nb, dtype=torch.bool, device="cuda")
    nan[b[~ok]] = True
    return s, cnt * 2.0**-23 * a, cnt, nan


def embedding_bag_phase():
    """The embedding-bag kernel against its plain version at the DLRM
    serving shapes, a multi-hot shape and edge cases, each timed beside
    ``F.embedding_bag`` and its byte bound where it is large."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    cfg = get_arch(DLRM_ARCH).config
    n_f, v, d = cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(4)
    big = torch.randn((n_f * v, d), generator=gen, device="cuda").mul_(d ** -0.5)
    one = (1,) * n_f

    def small(rows, width, dtype=torch.float32):
        return torch.randn((rows, width), generator=gen, device="cuda").to(dtype)

    def unsorted(n, nb, v_rows):
        idx = torch.randint(0, v_rows, (n,), generator=gen, dtype=torch.int32, device="cuda")
        bag = torch.randint(0, nb, (n,), generator=gen, dtype=torch.int32, device="cuda")
        return idx, bag

    cases = {"serve_bulk": (big, *dlrm_lookups(262_144, one, v, gen)),
             "serve_p99": (big, *dlrm_lookups(512, one, v, gen)),
             "multi_hot": (big, *dlrm_lookups(4096, MULTI_HOT_SIZES, v, gen))}
    t = small(5000, 64, torch.bfloat16)
    cases["bf16"] = (t, *unsorted(60_000, 7000, 5000), 7000)
    t = small(5000, 64)
    idx, bag = unsorted(20_000, 3000, 5000)
    cases["empty_bags"] = (t, idx, bag * 3, 9000)                 # two bags in three empty
    idx, bag = unsorted(20_000, 3000, 5000)
    bag[::50], bag[7::50] = 3000, -1
    cases["bag_ids_out_of_range"] = (t, idx, bag, 3000)
    idx, bag = unsorted(20_000, 3000, 5000)
    idx[[11, 4321]] = 5000
    cases["row_index_v"] = (t, idx, bag, 3000)
    cases["d13"] = (small(5000, 13), *unsorted(30_000, 4000, 5000), 4000)
    # bags of 0, 1, 2, 31, 32, 33 and 100 rows: one-row and multi-row bags
    # in one 32-row window, bags crossing windows, empty bags at their edges
    sizes = torch.tensor([0, 0, 1, 1, 1, 1, 2, 31, 32, 33, 100], device="cuda")
    sizes = sizes[torch.randint(0, sizes.shape[0], (3000,), generator=gen, device="cuda")]
    bag = torch.repeat_interleave(torch.arange(3000, device="cuda"), sizes).to(torch.int32)
    cases["mixed_windows"] = (t, torch.randint(0, 5000, bag.shape, generator=gen,
                                               dtype=torch.int32, device="cuda"), bag, 3000)
    # serve_bulk's lookups folded into the table's first GiB (4,194,304
    # rows): against serve_bulk, a TLB limit on the 6.2 GiB of random rows
    # shows as a gap, a latency limit as none
    rows_1g = (1 << 30) // (d * big.element_size())
    cases["serve_bulk_1gib"] = (big, cases["serve_bulk"][1] % rows_1g, *cases["serve_bulk"][2:])
    exact = ("serve_bulk", "serve_p99", "serve_bulk_1gib")
    out = []
    for name, (table, idx, bag, nb) in cases.items():
        idx, bag = ops.sort_by_bag(idx, bag)
        got = embedding_bag_cuda(table, idx, bag, nb)
        bits = torch.int16 if got.element_size() == 2 else torch.int32
        check(torch.equal(got.view(bits), embedding_bag_cuda(table, idx, bag, nb).view(bits)),
              f"embedding_bag {name}: two launches differ")
        want = ref.embedding_bag_ref(table, idx, bag, nb)
        s, limit, cnt, nan = bag_limits(table, idx, bag, nb)
        torch.cuda.synchronize()
        if table.dtype == torch.bfloat16:
            limit = 2.0**-8 * s.abs() + (1 + 2.0**-8) * limit
        check(torch.equal(torch.isnan(got), nan[:, None].expand_as(got))
              and torch.equal(torch.isnan(want), torch.isnan(got)),
              f"embedding_bag {name}: NaN outside the bags of out-of-range rows")
        fin = ~nan
        worst = 0.0
        for label, x in (("kernel", got), ("plain", want)):
            dev = (x[fin].double() - s[fin]).abs()
            share = float((dev / limit[fin].clamp_min(1e-300)).max()) if dev.numel() else 0.0
            check(bool((dev <= limit[fin]).all()),
                  f"embedding_bag {name}: {label} off the float64 sum by {share} of its limit")
            worst = max(worst, share)
        check(not got[(cnt[:, 0] == 0)].any(), f"embedding_bag {name}: an empty bag is not zero")
        equal = torch.equal(got[fin], want[fin])
        if name in exact:
            check(equal, f"embedding_bag {name}: kernel and plain differ on one-row bags")
        rec = {"case": name, "v": table.shape[0], "d": table.shape[1], "n": idx.shape[0],
               "num_bags": nb, "dtype": str(table.dtype).split(".")[-1], "equal": equal,
               "max_abs_err": float((got[fin].float() - want[fin].float()).abs().max()),
               "max_abs_ref": float(want[fin].float().abs().max()),
               "max_err_over_limit": worst, "nan_bags": int(nan.sum()),
               "empty_bags": int((cnt == 0).sum())}
        if name == "serve_bulk_1gib":
            rec["ms"] = cuda_ms(lambda: embedding_bag_cuda(table, idx, bag, nb))
            rec["plain_ms"] = cuda_ms(lambda: ref.embedding_bag_ref(table, idx, bag, nb), reps=3)
            offsets = torch.searchsorted(bag, torch.arange(nb, device="cuda", dtype=torch.int32))
            lib = functools.partial(F.embedding_bag, idx.long(), table, offsets, mode="sum")
            rec["library_equal"] = torch.equal(lib(), want)
            rec["library_ms"] = cuda_ms(lib)
            rec["library_ms_back_to_back"] = cuda_ms(lib, per=20)
            del offsets, lib
        if name in ("serve_bulk", "serve_p99", "multi_hot"):
            n = idx.shape[0]
            rec["ms"] = cuda_ms(lambda: embedding_bag_cuda(table, idx, bag, nb))
            # the card's time alone: 20 calls in a row
            rec["ms_back_to_back"] = cuda_ms(lambda: embedding_bag_cuda(table, idx, bag, nb),
                                             per=20)
            rec["plain_ms"] = cuda_ms(lambda: ref.embedding_bag_ref(table, idx, bag, nb), reps=3)
            i64 = idx.long()
            offsets = torch.searchsorted(bag, torch.arange(nb, device="cuda", dtype=torch.int32))
            lib = lambda: F.embedding_bag(i64, table, offsets, mode="sum")  # noqa: E731
            rec["library_equal"] = torch.equal(lib(), want) if name in exact else None
            rec["library_ms"] = cuda_ms(lib)
            rec["library_ms_back_to_back"] = cuda_ms(lib, per=20)
            rec["sort_ms"] = cuda_ms(lambda: ops.sort_by_bag(idx, bag))  # ops.embedding_bag's
            # rows read once, bags written once, ids read once; n * d adds
            n_bytes = (n + nb) * d * table.element_size() + 8 * n
            rec["bytes"] = n_bytes
            rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n * d)
            del i64, offsets
        out.append(rec)
        del got, want, s, limit, cnt, nan
    # N = 0 and num_bags = 0: answered without a launch
    before = embedding_bag_cuda.launches
    e = torch.empty(0, dtype=torch.int32, device="cuda")
    check(not embedding_bag_cuda(big, e, e, 5).any(), "embedding_bag N=0 is not zero")
    i1 = torch.zeros(3, dtype=torch.int32, device="cuda")
    check(embedding_bag_cuda(big, i1, i1, 0).shape == (0, d), "embedding_bag num_bags=0")
    check(embedding_bag_cuda.launches == before, "embedding_bag launched for an empty input")
    del cases, big
    torch.cuda.empty_cache()
    return out


def dlrm_requests(cfg, shape, r: int):
    """Request r of ``shape`` on the card, as ``serve_recsys`` draws it."""
    from repro_torch.launch import steps

    dense, sparse = (torch.from_numpy(a).cuda() for a in steps.recsys_requests(cfg, shape.batch, r))
    return dense, sparse


def dlrm_serve(cfg, params, shapes, use_kernels: bool, label: str):
    """For each shape, a warm-up request (its first use of each product
    shape), then DLRM_REQUESTS through ``serve_recsys``; a ``dlrm_serve``
    line per shape. Returns the outputs by shape and the launches over the
    whole run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve_recsys

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    outputs = {}
    for name, n in DLRM_REQUESTS.items():
        shape = shapes[name]
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()["embedding_bag"]
        warm = serve_recsys(cfg, params, shape, 1, use_kernels=use_kernels, device="cuda",
                            seed=1000)
        res = serve_recsys(cfg, params, shape, n, use_kernels=use_kernels, device="cuda")
        secs = [r["seconds"] for r in res.records]
        examples = shape.n_candidates if shape.kind == "retrieval" else shape.batch
        flops = steps.dlrm_flops(cfg, examples)["model_flops"]
        rec = {"phase": "dlrm_serve", "run": label, "shape": name, "kind": shape.kind,
               "requests": n, "batch": shape.batch, "candidates": shape.n_candidates,
               "seconds": secs, "median_s": statistics.median(secs), "max_s": max(secs),
               "examples_per_s": examples * n / sum(secs),
               "model_flop_per_request": flops,
               "model_tflop_per_s": flops / statistics.median(secs) / 1e12,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "warmup_s": warm.records[0]["seconds"],
               "embedding_bag_launches": ops.launch_counts()["embedding_bag"] - before,
               "finite": all(bool(torch.isfinite(o).all()) for o in res.outputs)}
        del warm
        emit(rec)
        check(rec["finite"], f"dlrm {label} {name}: outputs are not finite")
        check(all(tuple(o.shape) == (examples,) for o in res.outputs),
              f"dlrm {label} {name}: output shapes {[tuple(o.shape) for o in res.outputs]}")
        outputs[name] = res.outputs
    return outputs, ops.launch_counts()


def dlrm_phase():
    """dlrm-rm2 serving at full width: plan, kernels, plain, equality and a
    profiled serve_bulk forward; returns the kernel run's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.models import dlrm

    spec = get_arch(DLRM_ARCH)
    cfg = spec.config
    shapes = {name: spec.shape(name) for name in DLRM_REQUESTS}
    check(not torch.backends.cuda.matmul.allow_tf32, "DLRM runs its float32 products in float32")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dlrm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # one launch a request, the warm-ups included
    predicted = len(DLRM_REQUESTS) + sum(DLRM_REQUESTS.values())
    emit({"phase": "dlrm_plan", "arch": cfg.name, "params": cfg.param_count(),
          "tables": cfg.n_sparse, "rows_per_table": cfg.rows_per_table,
          "embed_dim": cfg.embed_dim, "bot_mlp": list(cfg.bot_mlp), "top_mlp": list(cfg.top_mlp),
          "multi_hot": cfg.multi_hot, "dtype": cfg.dtype,
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "table_gib": params["tables"].numel() * params["tables"].element_size() / 2**30,
          "shapes": [{"name": s.name, "kind": s.kind, "batch": s.batch,
                      "candidates": s.n_candidates, "requests": DLRM_REQUESTS[s.name]}
                     for s in shapes.values()],
          "predicted_embedding_bag_launches": predicted, "init_seconds": init_s,
          "resident_gib": torch.cuda.memory_allocated() / 2**30})

    out_k, counts = dlrm_serve(cfg, params, shapes, True, "kernels")
    check(counts["embedding_bag"] == predicted,
          f"embedding_bag launched {counts['embedding_bag']} times, predicted {predicted}")
    others = {k: n for k, n in counts.items() if k != "embedding_bag" and n}
    check(not others, f"other kernels launched on the DLRM path: {others}")
    out_p, plain_counts = dlrm_serve(cfg, params, shapes, False, "plain")
    check(not any(plain_counts.values()), f"the plain serve launched kernels: {plain_counts}")

    # the gate: logits of every request, and the embedding outputs bitwise
    ratios, equal_share, emb_equal = {}, {}, True
    with torch.inference_mode():
        for name, n in DLRM_REQUESTS.items():
            ratios[name] = [float((k - p).abs().max()) / float(p.abs().max())
                            for k, p in zip(out_k[name], out_p[name])]
            equal_share[name] = float(torch.cat([(k == p).float() for k, p in
                                                 zip(out_k[name], out_p[name])]).mean())
            for r in range(n):
                _, sparse = dlrm_requests(cfg, shapes[name], r)
                ek = dlrm._embedding_bags(params, sparse, cfg, use_kernels=True)
                ep = dlrm._embedding_bags(params, sparse, cfg, use_kernels=False)
                emb_equal &= torch.equal(ek, ep)
                del ek, ep
    worst = max(max(r) for r in ratios.values())
    emit({"phase": "dlrm_equal", "limit_ratio": 1e-5, "max_ratio": worst, "ratios": ratios,
          "equal_share": equal_share, "embedding_bitwise_equal": emb_equal})
    check(worst <= 1e-5, f"dlrm logits: max |kernel - plain| / max |plain| {worst} > 1e-5")
    check(emb_equal, "dlrm embedding outputs of one-row bags differ between kernel and plain")
    del out_k, out_p
    torch.cuda.empty_cache()

    # where a serve_bulk forward's device time goes: DLRM_PROFILED forwards
    # after a warm-up that fills the allocator's cache as serving does (the
    # profiler can miss the first kernels of its window; over several
    # forwards that is a small share), device times per forward
    dense, sparse = dlrm_requests(cfg, shapes["serve_bulk"], 0)
    dlrm.forward(params, dense, sparse, cfg, use_kernels=True)
    _, prof = profiled(lambda: [dlrm.forward(params, dense, sparse, cfg, use_kernels=True)
                                for _ in range(DLRM_PROFILED)])
    ops_s = {o["op"]: o["s"] for o in prof["by_op"]}
    split = {"embedding_bag": sum(k["s"] for k in prof["top"] if "embedding_bag" in k["kernel"]),
             "sort": ops_s.get("aten::sort", 0.0), "mm": ops_s.get("aten::mm", 0.0),
             "bmm": ops_s.get("aten::bmm", 0.0), "cat": ops_s.get("aten::cat", 0.0),
             "add": ops_s.get("aten::add", 0.0), "relu": ops_s.get("aten::clamp_min", 0.0),
             "index": ops_s.get("aten::index", 0.0)}
    emit({"phase": "dlrm_profile", "arch": cfg.name, "shape": "serve_bulk",
          "batch": shapes["serve_bulk"].batch, "forwards": DLRM_PROFILED,
          "device_s_per_forward": prof["device_s"] / DLRM_PROFILED,
          "split_s_per_forward": {k: v / DLRM_PROFILED for k, v in split.items()}, **prof})
    del params, dense, sparse
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Training slices: dlrm-rm2 and phi4-mini-3.8b, and the attention backward
# ---------------------------------------------------------------------------

def dlrm_train_run(cfg, batches, use_kernels: bool):
    """DLRM_TRAIN_STEPS steps of ``dlrm_train_step`` from the parameters of
    seed 0: (losses, norms, CUDA-event seconds, peak GiB, launch counts,
    profile), the counts over exactly these steps; with the kernels one
    more step (the first batch again) under ``torch.profiler``."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import dlrm_train_step
    from repro_torch.models import dlrm
    from repro_torch.optim import adamw_init

    free_device_memory()
    params = dlrm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, norms, times = [], [], []
    for dense, sparse, labels in batches:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        params, opt, loss, gnorm = dlrm_train_step(params, opt, dense, sparse, labels, cfg,
                                                   lr=DLRM_TRAIN_LR, use_kernels=use_kernels)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
        losses.append(float(loss))
        norms.append(float(gnorm))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = None
    if use_kernels:
        _, prof = profiled(lambda: dlrm_train_step(params, opt, *batches[0], cfg,
                                                   lr=DLRM_TRAIN_LR, use_kernels=True),
                           kernels=("embedding_bag", "segment_sum"))
    del params, opt
    free_device_memory()
    return losses, norms, times, peak, counts, prof


def dlrm_train_phase():
    """dlrm-rm2 training at full width on ``train_batch`` (65,536 examples
    from ``click_batches(seed=0)``), DLRM_TRAIN_STEPS in-place AdamW steps
    with the kernels, then the same steps on the plain versions from the
    same parameters; then the embedding bag and the tables' segment sum at
    the first batch's skewed lookups. Returns the kernel run's launches and
    the kernel_check cases."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.data import click_batches
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.segment_sum import segment_plan
    from repro_torch.launch.steps import dlrm_flops

    spec = get_arch(DLRM_ARCH)
    cfg, shape = spec.config, spec.shape("train_batch")
    n_f, v, d, batch = cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim, shape.batch
    t0 = time.perf_counter()
    stream = click_batches(cfg.n_dense, n_f, v, batch, multi_hot=cfg.multi_hot, seed=0)
    batches = [tuple(torch.from_numpy(a).cuda() for a in next(stream))
               for _ in range(DLRM_TRAIN_STEPS)]
    offsets = torch.arange(0, n_f * v, v, device="cuda")[None, :, None]
    rows = [(s.long() + offsets).reshape(-1) for _, s, _ in batches]
    touched = [int(torch.unique(r).numel()) for r in rows]
    row0 = int((batches[0][1][:, :, 0] == 0).sum()) / n_f
    data_s = time.perf_counter() - t0
    emit({"phase": "dlrm_train_plan", "arch": cfg.name, "shape": shape.name,
          "batch": batch, "steps": DLRM_TRAIN_STEPS, "lr": DLRM_TRAIN_LR,
          "params": cfg.param_count(), "lookups": batch * n_f * cfg.multi_hot,
          "distinct_rows": touched, "row0_lookups_per_field": row0,
          "model_flops": dlrm_flops(cfg, batch, train=True)["model_flops"],
          "tf32": torch.backends.cuda.matmul.allow_tf32, "data_seconds": data_s})

    losses, norms, times, peak, counts, prof = dlrm_train_run(cfg, batches, True)
    finite = all(math.isfinite(x) for x in losses + norms)
    check(finite, f"dlrm training: a loss or norm is not finite: {losses} {norms}")
    check(losses[-1] < losses[0], f"dlrm training: the loss did not fall: {losses}")
    for name in ("embedding_bag", "segment_sum"):
        check(counts[name] == DLRM_TRAIN_STEPS,
              f"dlrm training: {name} launched {counts[name]} times in {DLRM_TRAIN_STEPS} steps")
    others = {k: n for k, n in counts.items() if k not in ("embedding_bag", "segment_sum") and n}
    check(not others, f"dlrm training: other kernels launched: {others}")
    emit({"phase": "dlrm_train", "run": "kernels", "losses": losses, "gnorms": norms,
          "step_seconds": times, "median_step_seconds": statistics.median(times),
          "examples_per_s": batch / statistics.median(times), "peak_gib": peak,
          "launches_per_step": {k: n // DLRM_TRAIN_STEPS for k, n in counts.items() if n}})
    emit({"phase": "dlrm_train_profile", "arch": cfg.name, **prof})
    losses_p, norms_p, times_p, peak_p, counts_p, _ = dlrm_train_run(cfg, batches, False)
    check(not any(counts_p.values()), f"the plain DLRM steps launched kernels: {counts_p}")
    bitwise = losses_p == losses and norms_p == norms
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses + norms, losses_p + norms_p))
    emit({"phase": "dlrm_train", "run": "plain", "losses": losses_p, "gnorms": norms_p,
          "step_seconds": times_p, "median_step_seconds": statistics.median(times_p),
          "peak_gib": peak_p, "bitwise_equal_kernels": bitwise, "max_rel_diff": worst,
          "limit": DLRM_TRAIN_LIMIT})
    check(worst <= DLRM_TRAIN_LIMIT,
          f"dlrm training: kernel and plain losses / norms differ by {worst} (relative)")

    # the kernels at the first batch's lookups: the embedding bag over the
    # stacked tables, and the tables' gradient summed into the touched rows
    gen = torch.Generator(device="cuda").manual_seed(6)
    table = torch.randn((n_f * v, d), generator=gen, device="cuda").mul_(d ** -0.5)
    idx = rows[0].to(torch.int32)
    bag = torch.arange(batch * n_f, device="cuda", dtype=torch.int32)
    nb = batch * n_f
    got = embedding_bag_cuda(table, idx, bag, nb)
    want = ref.embedding_bag_ref(table, idx, bag, nb)
    check(torch.equal(got, want), "embedding_bag train_batch: kernel and plain differ")
    i64 = idx.long()
    lib = functools.partial(F.embedding_bag, i64, table, bag.long(), mode="sum")
    rec = {"case": "train_batch", "v": n_f * v, "d": d, "n": idx.shape[0], "num_bags": nb,
           "dtype": "float32", "equal": True, "max_abs_err": 0.0,
           "max_abs_ref": float(want.abs().max()), "distinct_rows": touched[0],
           "library_equal": torch.equal(lib(), want),
           "ms": cuda_ms(lambda: embedding_bag_cuda(table, idx, bag, nb)),
           "ms_back_to_back": cuda_ms(lambda: embedding_bag_cuda(table, idx, bag, nb), per=20),
           "plain_ms": cuda_ms(lambda: ref.embedding_bag_ref(table, idx, bag, nb), reps=3),
           "library_ms": cuda_ms(lib), "library_ms_back_to_back": cuda_ms(lib, per=20)}
    # the distinct rows read once, the bags written once, the ids read once
    n_bytes = (touched[0] + nb) * d * 4 + 8 * idx.shape[0]
    rec["bytes"] = n_bytes
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, idx.shape[0] * d)
    del got, want, table, lib, i64
    free_device_memory()
    # the tables' gradient: one bag-gradient row a lookup, summed by the
    # lookup's row, compacted to the touched rows (ops._touched_sum)
    uniq, compact = torch.unique(rows[0], sorted=True, return_inverse=True)
    compact = compact.to(torch.int32)
    grad_rows = torch.randn((compact.shape[0], d), generator=gen, device="cuda").mul_(1e-5)
    seg = segment_sum_case("dlrm_table_grad", grad_rows, compact, uniq.shape[0],
                           segment_plan(compact, uniq.shape[0]), True)
    del uniq, compact, grad_rows, batches, rows
    free_device_memory()
    return counts, rec, seg


def lm_train_value_and_norm(params, tok, lab, cfg, use_kernels: bool):
    """One loss and gradient from the current state, without an update:
    (loss, global norm, each leaf's norm), the gradient freed."""
    from repro_torch.launch.steps import lm_value_and_grad
    from repro_torch.optim.adamw import _sum_squares

    loss, grads = lm_value_and_grad(params, tok, lab, cfg, use_kernels=use_kernels)
    # the optimizer's sum of squares: a leaf over NORM_BLOCK_BYTES by blocks
    # of rows (a whole float32 copy of deepseek's expert gradients, 6.88 GiB,
    # would not fit beside its state)
    leaf = {k: math.sqrt(float(_sum_squares(g))) for k, g in grads.items()}
    norm = math.sqrt(sum(x * x for x in leaf.values()))
    del grads
    free_device_memory()
    return float(loss), norm, leaf


class TrainRouting:
    """While ``watch`` is on, each MoE layer's per-expert row counts as the
    routed training sum reads them (``transformer._expert_rows``, in call
    order: a step's forward, then its recompute, layers backwards) and the
    host seconds of each ``_moe_routed`` call."""

    def __init__(self):
        self.counts, self.loop_s = [], []

    @contextlib.contextmanager
    def watch(self):
        from repro_torch.models import transformer as tf

        rows, routed = tf._expert_rows, tf._moe_routed
        self.counts, self.loop_s = [], []

        def spy_rows(experts, n):
            out = rows(experts, n)
            self.counts.append(out)
            return out

        def timed(*args):
            t0 = time.perf_counter()
            out = routed(*args)
            self.loop_s.append(time.perf_counter() - t0)
            return out

        tf._expert_rows, tf._moe_routed = spy_rows, timed
        try:
            yield self
        finally:
            tf._expert_rows, tf._moe_routed = rows, routed


def one_micro_batch(cfg, spec, seq: int) -> int:
    """The largest batch up to train_4k's published one at which
    ``lm_micro_batches`` gives one microbatch."""
    from repro_torch.launch.steps import lm_micro_batches

    top = spec.shape("train_4k").global_batch
    return max(b for b in range(1, top + 1) if lm_micro_batches(cfg, b, seq) == 1)


def lm_train_phase(arch: str, path: str):
    """``arch`` training at full width at train_4k's sequence (the batch cut
    to the largest with one microbatch at the published depth; the depth
    cut to ``LM_TRAIN_LAYERS`` where it names the arch): LM_TRAIN_STEPS in-place AdamW steps
    with remat, a profiled step, then the loss and gradient of the next
    batch with the kernels and with the plain versions from the same state.
    For MoE also each layer's rows past their expert's window and whether
    each recompute routed as its forward. Lines are tagged with ``path``.
    Returns the steps' launches and the first batch's tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.data import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import flat_params, lm_flops, lm_micro_batches, lm_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    spec = get_arch(arch)
    published = spec.config
    cfg = dataclasses.replace(published, n_layers=LM_TRAIN_LAYERS.get(arch, published.n_layers))
    s = LM_TRAIN_SEQ
    b = one_micro_batch(published, spec, s)
    check(arch != LM_ARCH or b == LM_TRAIN_BATCH, f"{path}: batch {b} != {LM_TRAIN_BATCH}")
    shape = dataclasses.replace(spec.shape("train_4k"), global_batch=b)
    n_micro = lm_micro_batches(cfg, b, s)
    check(n_micro == 1, f"{path}: {n_micro} microbatches at batch {b}, expected 1")
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = adamw_init(flat_params(params))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stream = token_batches(cfg.vocab, b, s, seed=0)
    batches = [tuple(torch.from_numpy(a).cuda() for a in next(stream))
               for _ in range(LM_TRAIN_STEPS + 2)]
    flops = lm_flops(cfg, shape)["model_flops"]
    per_step = {"flash_attention": 2 * cfg.n_layers, "flash_attention_tc": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers, "flash_attention_bwd_tc": cfg.n_layers,
                "segment_sum": 1}
    widths = ((cfg.qk_nope + cfg.qk_rope, cfg.v_head) if cfg.attn == "mla"
              else (cfg.d_head, cfg.d_head))
    emit({"phase": "lm_train_plan", "path": path, "arch": cfg.name,
          "layers": cfg.n_layers, "layers_published": published.n_layers,
          "params": cfg.param_count(), "active_params": cfg.active_param_count(),
          "batch": b, "seq": s, "global_batch_published": spec.shape("train_4k").global_batch,
          "n_micro": n_micro, "remat": cfg.remat, "dtype": cfg.dtype, "lr": LM_TRAIN_LR,
          "steps": LM_TRAIN_STEPS, "attention_widths": widths,
          "model_flops_per_step": flops, "predicted_launches_per_step": per_step,
          "init_seconds": init_s, "resident_gib": torch.cuda.memory_allocated() / 2**30})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    routing = TrainRouting()
    losses, norms, times = [], [], []
    with routing.watch():
        for tok, lab in batches[:LM_TRAIN_STEPS]:
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            params, opt, loss, gnorm = lm_train_step(params, opt, tok, lab, cfg,
                                                     lr=LM_TRAIN_LR, use_kernels=True, n_micro=1)
            ev1.record()
            torch.cuda.synchronize()
            times.append(ev0.elapsed_time(ev1) / 1e3)
            losses.append(float(loss))
            norms.append(float(gnorm))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(x) for x in losses + norms),
          f"{path}: a loss or norm is not finite: {losses} {norms}")
    check(peak < 79.2, f"{path}: peak {peak} GiB")
    for name, n in per_step.items():
        check(counts[name] == n * LM_TRAIN_STEPS,
              f"{path}: {name} launched {counts[name]} times, predicted {n * LM_TRAIN_STEPS}")
    others = {k: n for k, n in counts.items() if k not in per_step and n}
    check(not others, f"{path}: other kernels launched: {others}")
    med = statistics.median(times)
    rec = {"phase": "lm_train", "path": path, "arch": cfg.name, "run": "kernels",
           "losses": losses, "gnorms": norms, "step_seconds": times,
           "median_step_seconds": med, "peak_gib": peak,
           "model_tflop_per_s": flops / med / 1e12, "tokens_per_s": b * s / med,
           "launches_per_step": {k: n // LM_TRAIN_STEPS for k, n in counts.items() if n}}
    if cfg.moe:
        # a step reads the counts in its forward (layers in order) and in its
        # recompute (layers backwards); the recompute must route as the
        # forward did, or checkpoint would have raised on the saved shapes
        n = cfg.n_moe_layers
        check(len(routing.counts) == 2 * n * LM_TRAIN_STEPS,
              f"{path}: {len(routing.counts)} routings in {LM_TRAIN_STEPS} steps")
        fwd = [routing.counts[i * 2 * n:i * 2 * n + n] for i in range(LM_TRAIN_STEPS)]
        recomp = [routing.counts[i * 2 * n + n:(i + 1) * 2 * n][::-1]
                  for i in range(LM_TRAIN_STEPS)]
        mismatch = sum(a != r for f, rc in zip(fwd, recomp) for a, r in zip(f, rc))
        total, window = tf.moe_window(cfg, b * s)
        masked = [sum(c) - sum(tf.moe_windows(c, total, window)) for f in fwd for c in f]
        rec["moe"] = {"routed_rows_per_layer": b * s * cfg.top_k, "total": total,
                      "window": window, "mean_rows_per_expert": b * s * cfg.top_k
                      / cfg.n_experts, "max_rows_per_expert": max(max(c) for f in fwd for c in f),
                      "masked_rows_per_layer": {"mean": statistics.mean(masked),
                                                "max": max(masked),
                                                "layers_masking": sum(1 for m in masked if m),
                                                "of_layers": len(masked)},
                      "recompute_routing_equal": mismatch == 0,
                      "recompute_routing_mismatches": mismatch,
                      "routed_sum_host_s_per_step": sum(routing.loop_s) / LM_TRAIN_STEPS}
        check(mismatch == 0, f"{path}: {mismatch} layers recomputed with other routing")
    emit(rec)

    tok, lab = batches[LM_TRAIN_STEPS]
    _, prof = profiled(lambda: lm_train_step(params, opt, tok, lab, cfg, lr=LM_TRAIN_LR,
                                             use_kernels=True, n_micro=1),
                       kernels=("flash_attention_bwd", "flash_attention_tc", "segment_sum"))
    emit({"phase": "lm_train_profile", "path": path, "arch": cfg.name, **prof})

    # the gate: the next batch's loss and gradient from the same state, with
    # the kernels and with the plain versions (attention forward and backward,
    # the embedding's segment sum)
    tok, lab = batches[LM_TRAIN_STEPS + 1]
    with routing.watch():
        loss_k, norm_k, leaf_k = lm_train_value_and_norm(params, tok, lab, cfg, True)
        routed_k = list(routing.counts)
    with routing.watch():
        loss_p, norm_p, leaf_p = lm_train_value_and_norm(params, tok, lab, cfg, False)
        routed_p = list(routing.counts)
    loss_ratio = abs(loss_k - loss_p) / abs(loss_p)
    norm_ratio = abs(norm_k - norm_p) / norm_p
    leaf_ratio = max(abs(leaf_k[k] - leaf_p[k]) / max(leaf_p[k], 1e-30) for k in leaf_p)
    extra = {}
    if cfg.moe:
        extra["routing_counts_equal"] = routed_k == routed_p
        extra["routing_layers_differing"] = sum(a != c for a, c in zip(routed_k, routed_p))
    emit({"phase": "lm_train_equal", "path": path, "arch": cfg.name, "limit": LM_TRAIN_LIMIT,
          "loss_kernels": loss_k, "loss_plain": loss_p, "loss_ratio": loss_ratio,
          "gnorm_kernels": norm_k, "gnorm_plain": norm_p, "gnorm_ratio": norm_ratio,
          "leaf_norm_max_ratio": leaf_ratio, **extra})
    check(loss_ratio <= LM_TRAIN_LIMIT and norm_ratio <= LM_TRAIN_LIMIT,
          f"{path}: kernel against plain loss {loss_ratio}, gnorm {norm_ratio} "
          f"> {LM_TRAIN_LIMIT}")
    first = batches[0][0]
    del params, opt, batches, tok, lab
    free_device_memory()
    return counts, first


def lm_mesh_phase():
    """``lm_mesh``: one step of ``lm_train_step(..., mesh=grid)`` on a ``(1,
    1)`` ``GridMesh`` over a process group of world size 1 started here
    (NCCL), granite-moe-3b-a800m at full width cut to ``LM_MESH_LAYERS``
    layers, 1 × 4,096 tokens, with the kernels; against the one-device
    ``lm_train_step`` on the same parameters and tokens: loss and gradient
    norm, and after the update every parameter and both moments, which the
    grid must reproduce bit for bit (at world 1 it does the same arithmetic
    in the same order). Returns the mesh step's launches."""
    import socket

    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_params_shard
    from repro_torch.data import token_batches
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_grid_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    t_phase = time.perf_counter()
    published = get_arch(LM_MESH_ARCH).config
    cfg = dataclasses.replace(published, n_layers=LM_MESH_LAYERS)
    b, s = 1, LM_TRAIN_SEQ
    tok, lab = (torch.from_numpy(a).cuda() for a in next(token_batches(cfg.vocab, b, s, seed=0)))

    def params0():
        return tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")

    params = params0()
    opt = adamw_init(steps.flat_params(params))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, loss1, norm1 = steps.lm_train_step(params, opt, tok, lab, cfg, lr=LM_TRAIN_LR,
                                             use_kernels=True, n_micro=1)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single = ops.launch_counts()
    loss1, norm1 = float(loss1), float(norm1)
    # the updated state, kept on the host while the grid's step runs
    after1 = {"param": {k: v.cpu() for k, v in steps.flat_params(params).items()},
              "mu": {k: v.cpu() for k, v in opt.mu.items()},
              "nu": {k: v.cpu() for k, v in opt.nu.items()}}
    del params, opt
    free_device_memory()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    t0 = time.perf_counter()
    mesh = init_grid_mesh(1, 1, "cuda", timeout_s=300)
    init_s = time.perf_counter() - t0
    try:
        whole = params0()
        params = lm_params_shard(whole, cfg, mesh, device="cuda")
        del whole
        opt = steps.lm_adamw_init(params, cfg, mesh)
        stats = tf.RoutedStats()
        free_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        mesh.reset_counts()
        t0 = time.perf_counter()
        _, _, loss, norm = steps.lm_train_step(params, opt, tok, lab, cfg, lr=LM_TRAIN_LR,
                                               use_kernels=True, n_micro=1, mesh=mesh,
                                               stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
        calls, nbytes = dict(mesh.calls), dict(mesh.bytes)
        moe = stats.summary()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    loss, norm = float(loss), float(norm)
    # at (1, 1) a rank's shards and ZeRO-1 moments are the whole leaves
    after = {"param": steps.flat_params(params), "mu": opt.mu, "nu": opt.nu}
    state_gap = {}
    for kind, leaves in after.items():
        check(sorted(leaves) == sorted(after1[kind]), f"lm_mesh: {kind} leaves differ")
        gaps = {k: float((v.float() - after1[kind][k].to(v.device).float()).abs().max())
                for k, v in leaves.items()}
        state_gap[kind] = {"max_abs_diff": max(gaps.values()),
                           "leaves_differing": sorted(k for k, g in gaps.items() if g != 0)}
    del params, opt, after, after1
    free_device_memory()
    rec = {"phase": "lm_mesh", "arch": cfg.name, "grid": [1, 1], "backend": backend,
           "layers": LM_MESH_LAYERS, "layers_published": published.n_layers,
           "batch": b, "seq": s, "loss_mesh": loss, "loss_single": loss1,
           "loss_ratio": abs(loss - loss1) / abs(loss1), "gnorm_mesh": norm,
           "gnorm_single": norm1, "gnorm_ratio": abs(norm - norm1) / norm1,
           "limit": LM_TRAIN_LIMIT, "state_after_step": state_gap,
           "step_seconds": seconds, "single_step_seconds": single_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "exchange_overflow": moe["overflow"], "routed_calls": moe["calls"],
           "masked_rows_per_call": moe["masked_per_call"],
           "launches": {k: n for k, n in launches.items() if n},
           "collective_calls": calls, "collective_bytes": nbytes,
           "init_process_group_s": init_s, "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(backend == "nccl", f"lm_mesh: backend {backend}")
    check(math.isfinite(loss) and math.isfinite(norm), f"lm_mesh: loss {loss}, norm {norm}")
    check(rec["loss_ratio"] <= LM_TRAIN_LIMIT and rec["gnorm_ratio"] <= LM_TRAIN_LIMIT,
          f"lm_mesh: against one device loss {rec['loss_ratio']}, gnorm {rec['gnorm_ratio']} "
          f"> {LM_TRAIN_LIMIT}")
    for kind, gap in state_gap.items():
        check(not gap["leaves_differing"],
              f"lm_mesh: the updated {kind} differs from one device's in "
              f"{gap['leaves_differing']} (max |diff| {gap['max_abs_diff']})")
    check(moe["overflow"] == 0 and moe["calls"] == 2 * LM_MESH_LAYERS,
          f"lm_mesh: exchange {moe}")
    check(launches == single, f"lm_mesh: launches {launches} != one device's {single}")
    for name, n in (("flash_attention_tc", 2 * LM_MESH_LAYERS),
                    ("flash_attention_bwd_tc", LM_MESH_LAYERS), ("segment_sum", 1)):
        check(launches[name] == n, f"lm_mesh: {name} launched {launches[name]} times, not {n}")
    for kind in ("all_reduce/model", "all_to_all/model", "all_gather/model",
                 "all_reduce/data"):
        check(calls.get(kind, 0) > 0, f"lm_mesh: no {kind} collective: {calls}")
    return launches


def attention_bwd_work(b, hq, hkv, l, dh, elem, dv=None):
    """The backward's operations and bytes: five causal products of
    2 * b * hq * (l * (l + 1) / 2) FLOP a column, S, dQ and dK over Dqk
    ``dh``, dP and dV over ``dv`` (``dh`` by default); q, k, v, O and dO read
    once and dQ, dK, dV written once."""
    dv = dh if dv is None else dv
    pairs = l * (l + 1) // 2
    flops = 2 * b * hq * pairs * (3 * dh + 2 * dv)
    n_bytes = elem * l * 2 * (b * hq * (dh + dv) + b * hkv * (dh + dv))
    return flops, n_bytes


def flash_attention_bwd_phase(train_batch: int):
    """The attention backward kernels against their plain version at the LM
    training shapes (phi4-mini's, and MLA's at (Dqk, Dv) = (96, 64),
    minicpm3-4b, and (192, 128), deepseek-v2-lite-16b) and at edge cases (L
    1, 17, 4,095; groups 1, 3, 8; Dh 64 and 128; (96, 64) and (192, 128) at
    L 4,095, 1,000 and 300; bf16 on the tensor cores from the
    forward's log-sum-exp, float32 on the CUDA cores), each element of dQ, dK and dV within
    ``ref.flash_attention_bwd_limits``, two launches bitwise equal; the
    forward's output bitwise the same with and without the log-sum-exp, and
    the log-sum-exp against ``torch.logsumexp`` of the scores; timed beside
    the plain backward, SDPA's forward and backward through autograd and
    SDPA's backward alone, and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import bwd_route, flash_attention_cuda, route
    from repro_torch.kernels.flash_attention_bwd import (flash_attention_bwd_cuda,
                                                         kernel_attributes)

    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    # name: b, hq, hkv, l, Dqk, Dv, types
    cases = {"train": (train_batch, 24, 8, LM_TRAIN_SEQ, 128, 128, (bf16,)),
             "mla_minicpm3_train": (1, 40, 40, LM_TRAIN_SEQ, 96, 64, (bf16,)),
             "l1": (2, 6, 2, 1, 128, 128, (f32, bf16)),
             "l17_group3": (2, 6, 2, 17, 128, 128, (f32, bf16)),
             "l4095_group1": (1, 4, 4, 4095, 64, 64, (f32, bf16)),
             "group8_dh64": (1, 16, 2, 300, 64, 64, (f32, bf16)),
             "group3_dh128": (2, 24, 8, 1000, 128, 128, (f32, bf16)),
             "group1_dh128": (1, 4, 4, 600, 128, 128, (bf16,)),
             "group8_dh128": (1, 16, 2, 300, 128, 128, (bf16,)),
             "mla_l4095_group1": (1, 4, 4, 4095, 96, 64, (bf16,)),
             "mla_l1000_group3": (2, 6, 2, 1000, 96, 64, (bf16,)),
             "mla_l300": (1, 40, 40, 300, 96, 64, (bf16,)),
             "mla_deepseek_train": (1, 16, 16, LM_TRAIN_SEQ, 192, 128, (bf16,)),
             "mla192_l4095_group1": (1, 4, 4, 4095, 192, 128, (bf16,)),
             "mla192_l1000_group3": (2, 6, 2, 1000, 192, 128, (bf16,)),
             "mla192_l300": (1, 16, 16, 300, 192, 128, (bf16,))}
    out = []
    for name, (b, hq, hkv, l, dh, dv, dtypes) in cases.items():
        for dtype in dtypes:
            q, k, v, dout = (torch.randn(sh, generator=gen, device="cuda").to(dtype)
                             for sh in ((b, hq, l, dh), (b, hkv, l, dh), (b, hkv, l, dv),
                                        (b, hq, l, dv)))
            kind = bwd_route(dtype, dh, dv)
            tag = str(dtype).split(".")[-1]
            rec = {"case": name, "dtype": tag, "route": kind, "b": b, "hq": hq, "hkv": hkv,
                   "l": l, "dh": dh, "dv": dv}
            lse = None
            if kind == "tc":
                o, lse = flash_attention_cuda(q, k, v, causal=True, q_offset=0, return_lse=True)
                if route(l, dtype, dh, dv) == "tc":
                    # serving's call (no log-sum-exp) on the same kernel: the same output
                    rec["forward_bitwise_without_lse"] = torch.equal(
                        o, flash_attention_cuda(q, k, v, causal=True, q_offset=0))
                    check(rec["forward_bitwise_without_lse"],
                          f"flash_attention {name}: the output differs with the log-sum-exp")
                if "train" not in name:
                    kg = k.float().repeat_interleave(hq // hkv, dim=1)
                    sc = torch.matmul(q.float(), kg.transpose(-1, -2)) / math.sqrt(dh)
                    sc.masked_fill_(torch.ones(l, l, dtype=torch.bool, device="cuda").triu(1),
                                    -math.inf)
                    want_lse = torch.logsumexp(sc, -1) / math.log(2.0)
                    rec["lse_max_rel_err"] = float(((lse - want_lse).abs()
                                                    / want_lse.abs().clamp(min=1.0)).max())
                    check(rec["lse_max_rel_err"] <= 1e-5,
                          f"flash_attention {name}: log-sum-exp off by {rec['lse_max_rel_err']}")
                    del kg, sc, want_lse
            else:
                o = flash_attention_cuda(q, k, v, causal=True, q_offset=0)
            got = flash_attention_bwd_cuda(q, k, v, o, dout, lse)
            again = flash_attention_bwd_cuda(q, k, v, o, dout, lse)
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
            del again
            want, limit = ref.flash_attention_bwd_limits(q, k, v, dout)
            plain = ref.flash_attention_bwd_ref(q, k, v, dout)
            worst = {n: float(((g.float() - w).abs() / lim).max())
                     for n, g, w, lim in zip(("dq", "dk", "dv"), got, want, limit)}
            err = max(float((g.float() - p.float()).abs().max()) for g, p in zip(got, plain))
            check(all(x <= 1.0 for x in worst.values()),
                  f"flash_attention_bwd {name} {tag}: |kernel - plain in float32| reaches "
                  f"{worst} of its limit")
            check(repeat, f"flash_attention_bwd {name} {tag}: two launches differ")
            rec.update({"max_abs_err": err,
                        "max_abs_ref": max(float(w.abs().max()) for w in want),
                        "max_err_over_limit": worst, "repeat_bitwise": repeat})
            del want, limit, plain, got
            flops, n_bytes = attention_bwd_work(b, hq, hkv, l, dh, q.element_size(), dv)
            rec["ms"] = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, dout, lse),
                                reps=5 if "train" in name else 10)
            rec["plain_ms"] = cuda_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, dout), reps=3)
            if "train" in name:
                # the forward with and without the log-sum-exp it keeps for this kernel
                rec["forward_ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v))
                rec["forward_lse_ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v,
                                                                             return_lse=True))
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def sdpa():
                y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
                torch.autograd.grad(y, (qg, kg, vg), dout)

            rec["library_ms"] = cuda_ms(sdpa)
            # SDPA's backward alone: its forward once, outside the timed call
            y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
            rec["library_bwd_ms"] = cuda_ms(
                lambda: torch.autograd.grad(y, (qg, kg, vg), dout, retain_graph=True))
            del y
            rec["flops"], rec["bytes"] = flops, n_bytes
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                n_bytes, flops, PEAK_BF16_FLOPS if dtype == bf16 else PEAK_OPS_PER_S)
            rec["tflop_per_s"] = flops / rec["ms"] / 1e9
            out.append(rec)
            del q, k, v, dout, o, lse, qg, kg, vg
    free_device_memory()
    attrs = {f"{kind}_dh{dh}": kernel_attributes(kind, dh)
             for kind in ("tc", "simt") for dh in (64, 128)}
    attrs["tc_dqk96_dv64"] = kernel_attributes("tc", 96, 64)
    attrs["tc_dqk192_dv128"] = kernel_attributes("tc", 192, 128)
    emit({"phase": "flash_kernels", "flash_attention_bwd": attrs})
    # the tensor-core kernels (the training paths') keep everything in registers
    for key in ("tc_dh64", "tc_dh128", "tc_dqk96_dv64", "tc_dqk192_dv128"):
        check(all(a["local_bytes"] == 0 for a in attrs[key].values()),
              f"flash_attention_bwd {key} spills: {attrs[key]}")
    return out


def lm_embed_grad_case(tokens):
    """``segment_sum`` at the LM embedding's gradient: a [B * S, d_model]
    bf16 row a token, summed by token id, compacted to the tokens the batch
    holds (ops._touched_sum)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.segment_sum import segment_plan

    d = get_arch(LM_ARCH).config.d_model
    uniq, compact = torch.unique(tokens.reshape(-1), sorted=True, return_inverse=True)
    compact = compact.to(torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = torch.randn((compact.shape[0], d), generator=gen, device="cuda").to(torch.bfloat16)
    return segment_sum_case("lm_embed_grad", rows, compact, uniq.shape[0],
                            segment_plan(compact, uniq.shape[0]), True)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def device_ms(fn, kernel: str) -> float:
    """Device milliseconds a call of ``fn`` spends in the kernels whose
    names contain ``kernel`` (all of its kernels for ""), from the
    profiler over 20 calls."""
    fn()
    _, prof = profiled(lambda: [fn() for _ in range(20)], (kernel,))
    return prof["named_kernels"][kernel]["s"] * 1e3 / 20


def kernel_times(src: str) -> None:
    """``--kernel-times SRC``: the member_probe, set_intersect and
    embedding_bag kernels of the package under ``SRC`` (this checkout's
    ``src``, or another's, so that two trees are compared on one card in one
    call) timed at the main paths' shapes, one call at a time, 20 in a row
    and on the device (the profiler over 20 calls), beside
    ``F.embedding_bag``; then stage 1, one profiled DDSL batch, with the
    device seconds of each DDSL kernel, and set_intersect at the CC-join's
    shape and the batch's fill. Checks nothing but equality."""
    import dataclasses

    import torch.nn.functional as F

    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.member_probe import member_probe_cuda
    from repro_torch.kernels.set_intersect import set_intersect_cuda
    from repro_torch.run import WT_Q1, Pipeline, stages

    import repro_torch

    tree = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    build.library()
    emit({"phase": "kernel_times", "src": tree, "build_s": build.build_seconds(),
          "device": nvidia_smi()})
    pipe = Pipeline(dataclasses.replace(WT_Q1), "cuda")
    caps, ush, store = pipe.caps, pipe.ushapes, pipe.store_caps
    gen = torch.Generator(device="cuda").manual_seed(0)
    drop = sorted_table(ush.cedge_cap, 64, 4096, gen)
    recs = []   # (record, call, library call)
    for name, (n, tbl) in {"patch_rows": (ush.cand_cap * caps.deg_cap, drop),
                           "patch_edges": (caps.e_cap, drop),
                           "filter_sets": (store.group_cap * store.set_cap,
                                           sorted_table(64, 0, 4096, gen)),
                           "tiny": (1000, sorted_table(1, 0, 4096, gen)),
                           "all_pad": (1000, torch.full((5, 2), -1, dtype=torch.int32,
                                                        device="cuda"))}.items():
        q = probe_queries(n, tbl, 4096, gen)
        args = (q[:, 0].contiguous(), q[:, 1].contiguous(), tbl[:, 0].contiguous(),
                tbl[:, 1].contiguous())
        del q
        check(torch.equal(member_probe_cuda(*args), ref.member_probe_ref(*args)),
              f"member_probe {name}")
        call = functools.partial(member_probe_cuda, *args)
        recs.append(({"phase": "kernel_times", "kernel": "member_probe", "case": name, "n": n,
                      "m": tbl.shape[0], "ms": cuda_ms(call),
                      "ms_back_to_back": cuda_ms(call, per=20)}, call, None))
    for name, (g, c) in {"ccjoin": (caps.group_cap, caps.set_cap),
                         "zcommon": (ush.cedge_cap, caps.deg_cap)}.items():
        a, b = padded_sets(g, c, 4096, gen), padded_sets(g, c, 4096, gen)
        check(torch.equal(set_intersect_cuda(a, b, -1), ref.set_intersect_ref(a, b, -1)),
              f"set_intersect {name}")
        call = functools.partial(set_intersect_cuda, a, b, -1)
        recs.append(({"phase": "kernel_times", "kernel": "set_intersect", "case": name, "g": g,
                      "ca": c, "cb": c, "ms": cuda_ms(call),
                      "ms_back_to_back": cuda_ms(call, per=20)}, call, None))
    del a, b
    cfg = get_arch(DLRM_ARCH).config
    n_f, v, d = cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(4)
    big = torch.randn((n_f * v, d), generator=gen, device="cuda").mul_(d ** -0.5)
    one = (1,) * n_f
    bulk = dlrm_lookups(262_144, one, v, gen)
    for name, (idx, bag, nb) in {
            "serve_bulk": bulk, "serve_p99": dlrm_lookups(512, one, v, gen),
            "multi_hot": dlrm_lookups(4096, MULTI_HOT_SIZES, v, gen),
            "serve_bulk_1gib": (bulk[0] % ((1 << 30) // (4 * d)), *bulk[1:])}.items():
        idx, bag = ops.sort_by_bag(idx, bag)
        i64 = idx.long()
        offsets = torch.searchsorted(bag, torch.arange(nb, device="cuda", dtype=torch.int32))
        lib = functools.partial(F.embedding_bag, i64, big, offsets, mode="sum")
        call = functools.partial(embedding_bag_cuda, big, idx, bag, nb)
        check(bool(((call() - lib()).abs() <= 1e-5).all()), f"embedding_bag {name}")
        recs.append(({"phase": "kernel_times", "kernel": "embedding_bag", "case": name,
                      "n": idx.shape[0], "num_bags": nb, "ms": cuda_ms(call),
                      "ms_back_to_back": cuda_ms(call, per=20), "library_ms": cuda_ms(lib),
                      "library_ms_back_to_back": cuda_ms(lib, per=20)}, call, lib))
    # device times last: the profiler leaves the host slower for the rest of
    # the process
    for rec, call, lib in recs:
        rec["device_ms"] = device_ms(call, rec["kernel"])
        if lib is not None:
            rec["library_device_ms"] = device_ms(lib, "")
        emit(rec)
    del recs, call, lib
    del big, bulk
    torch.cuda.empty_cache()
    for rec in stages(pipe, 1):
        emit({"phase": "kernel_times", **rec})
    _, fill = profile_batch(pipe)
    # the CC-join's shape at the profiled batch's fill (after the profiler:
    # one call at a time reads slower, 20 in a row does not)
    g, c = caps.group_cap, caps.set_cap
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = padded_sets(g, c, 4096, gen, -1, fill["mean_nonpad_a"], fill["empty_a_share"])
    b = padded_sets(g, c, 4096, gen, -1, fill["mean_nonpad_b"])
    check(torch.equal(set_intersect_cuda(a, b, -1), ref.set_intersect_ref(a, b, -1)),
          "set_intersect ccjoin_fill")
    call = functools.partial(set_intersect_cuda, a, b, -1)
    emit({"phase": "kernel_times", "kernel": "set_intersect", "case": "ccjoin_fill", "g": g,
          "ca": c, "cb": c, "fill": fill,
          "ms": cuda_ms(call), "ms_back_to_back": cuda_ms(call, per=20)})


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    from repro_torch.kernels import build, ops
    from repro_torch.run import EXAMPLE_Q1, WT_Q1, Pipeline, stages
    import dataclasses

    # float32 products in full float32 on the card (no TF32), stated here:
    # the GNN comparisons hold float32 outputs to 1e-4, and the DLRM model
    # is float32 throughout (logits within 1e-5).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    check(torch.cuda.device_count() == 1,
          f"expects one visible card, sees {torch.cuda.device_count()} "
          "(set CUDA_VISIBLE_DEVICES)")

    # 1. build
    build.library()
    emit({"phase": "build", "seconds": build.build_seconds(), "sources": [
        os.path.relpath(s, HERE) for s in build.SOURCES]})

    # 2. kernels against their plain versions at the main path's shapes
    shapes_pipe = Pipeline(dataclasses.replace(WT_Q1), "cuda")
    shapes = (dataclasses.asdict(shapes_pipe.caps), dataclasses.asdict(shapes_pipe.ushapes),
              dataclasses.asdict(shapes_pipe.store_caps))
    plan = shapes_pipe.describe()
    del shapes_pipe
    torch.cuda.empty_cache()
    checks = kernel_phase(shapes)
    emit({"phase": "kernel_check", **checks})

    # 3. main path with the kernels; launches counted over exactly this run
    emit({"phase": "plan", **plan})
    ops.reset_launch_counts()
    recs_k, snaps_k, pipe = drive(WT_Q1, True, "kernels")
    launches = ops.launch_counts()
    check(recs_k[0]["count"] == WT_INITIAL_COUNT,
          f"initial count {recs_k[0]['count']} != host {WT_INITIAL_COUNT}")
    check(tuple(r["count"] for r in recs_k) == WT_COUNTS[:len(recs_k)],
          f"counts {[r['count'] for r in recs_k]} != {list(WT_COUNTS[:len(recs_k)])}")
    for r in recs_k:
        check(r["overflow"] == 0, f"overflow in {r}")
    for name in DDSL_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")

    # where a batch's device time goes: one more batch under the profiler
    final, fill = profile_batch(pipe)
    check(final["overflow"] == 0, f"overflow in the profiled batch {final}")
    check(final["count"] == WT_COUNTS[len(recs_k)],
          f"profiled batch count {final['count']} != {WT_COUNTS[len(recs_k)]}")
    # the CC-join's shape at the batch's mean fill of a and b
    shapes = pipe.caps
    checks["set_intersect"].append(set_intersect_case(
        "ccjoin_fill", shapes.group_cap, shapes.set_cap, shapes.set_cap, ("padded",),
        fill=(fill["mean_nonpad_a"], fill["mean_nonpad_b"], fill["empty_a_share"]),
        gen=torch.Generator(device="cuda").manual_seed(1)))
    emit({"phase": "kernel_check", "set_intersect": checks["set_intersect"][-1:]})
    profiled_snap = store_snapshot(pipe.store)

    # small batches on the same pipeline, where the carry skips listing
    small_k, small_snaps = small_batches(pipe, "kernels")
    final = small_k[-1]
    final_snap = small_snaps[-1]

    # the full-gather storage update against the delta one, from this state
    storage_full_phase(pipe)

    # 4. audit: list from scratch on the final partitions (the maintained
    #    store is on the host as its snapshot; free it on the card first)
    pipe.stores = pipe.carries = None
    torch.cuda.empty_cache()
    (astore, adiag), seconds, peak = timed_stage(pipe.list_pattern)
    audit = {k: int(v) for k, v in adiag.items()}
    emit({"phase": "audit", **audit, "maintained": final["count"], "seconds": seconds,
          "peak_gib": peak})
    check(audit["overflow"] == 0 and audit["count"] == final["count"],
          "audit count differs from the maintained count")
    check(snapshots_equal(store_snapshot(astore), final_snap),
          "audit store differs from the maintained store")
    del pipe, astore
    torch.cuda.empty_cache()

    # 5. the plain path on the card must give the same counts and stores,
    #    over the same batches (the profiled one and the small ones too)
    recs_p, snaps_p, pipe = drive(WT_Q1, False, "plain")
    for i, (a, b) in enumerate(zip(recs_k, recs_p)):
        check(a["count"] == b["count"] and a["overflow"] == b["overflow"],
              f"step {i}: kernel {a} vs plain {b}")
        check(snapshots_equal(snaps_k[i], snaps_p[i]), f"step {i}: MatchStore tensors differ")
    d = pipe.apply(pipe.next_update())
    check(int(d["count"]) == WT_COUNTS[len(recs_p)] and int(d["overflow"]) == 0,
          f"plain profiled batch {d}")
    check(snapshots_equal(store_snapshot(pipe.store), profiled_snap),
          "profiled batch: MatchStore tensors differ")
    # the first small batch only: a plain one takes ~19 s on the card
    small_p, small_snaps_p = small_batches(pipe, "plain", n=1)
    for i, (a, b) in enumerate(zip(small_k, small_p)):
        check(a["count"] == b["count"] and a["unit_refreshes"] == b["unit_refreshes"],
              f"small batch {i}: kernel {a} vs plain {b}")
        check(snapshots_equal(small_snaps[i], small_snaps_p[i]),
              f"small batch {i}: MatchStore tensors differ")
    emit({"phase": "plain_equal", "steps": len(recs_k) + 1 + len(small_p)})
    del pipe
    torch.cuda.empty_cache()

    # 6. two patterns in one megastep
    q2_tree_counts = multi_phase(snaps_k)

    # 6b. the service on a process mesh (NCCL, one rank), against LocalMesh
    mesh_launches = mesh_phase()

    # 7. small reference: host-engine counts of the example graph
    for pname, want in EXAMPLE_COUNTS.items():
        pipe = Pipeline(dataclasses.replace(EXAMPLE_Q1, pattern=pname), "cuda")
        got = []
        for d in stages(pipe, N_BATCHES):
            check(d["overflow"] == 0, f"reference {pname}: overflow")
            got.append(d["count"])
        check(tuple(got) == want, f"reference {pname}: {got} != host {list(want)}")
        emit({"phase": "reference", "pattern": pname, "counts": got, "host": list(want)})
    del pipe
    torch.cuda.empty_cache()

    # 8. the generic-join executor: K5 + K4 on WT~, its audit and plain
    #    replay, the mixed megastep beside the tree, and the planted graph
    wcoj_launches, auto_launches, auto_snaps, auto_recs, wcoj_case = wcoj_phase(
        snaps_k, q2_tree_counts)
    checks["member_probe"].append(wcoj_case)
    del snaps_k

    # 8b. the streaming service's device backend over the same deployment
    backend_launches = backend_phase(auto_snaps, auto_recs)
    del auto_snaps
    backend_resize_phase()

    # 8c. the service's front door on the card: ingest, journal, scheduler,
    #     shared delta, the device backend, sinks, audits, snapshots, swaps
    service_launches = service_phase()
    service_small_phase()
    rebalance_launches, rebalance_cases = rebalance_phase()
    for name, case in rebalance_cases.items():
        checks[name].append(case)
    planted_launches, planted_cases = wcoj_vs_tree_phase()
    checks["member_probe"].extend(planted_cases)

    # 9. segment_sum against its plain version at the GNN path's shapes
    checks["segment_sum"] = segment_sum_phase()
    emit({"phase": "kernel_check", "segment_sum": checks["segment_sum"]})

    # 10. GNN full-graph inference; launches counted over the kernel forward
    launches["segment_sum"] = gnn_phase()["segment_sum"]

    # 11. the two other architectures at full width on the small graph
    gnn_small_phase()

    # 12. EquiformerV2 at full width
    segment_paths = {"gatedgcn": launches["segment_sum"], **eqv2_phase()}

    # 12b. GNN training at full width: the four GNNs, 10 steps each
    train_paths, train_cases = gnn_train_phase()
    segment_paths.update(train_paths)
    checks["segment_sum"] += train_cases

    # 12c. the GNN step on a (1, 1) grid at NCCL world 1
    segment_paths.update(gnn_mesh_phase())

    # 13. flash_attention against its plain version at the serving shapes
    checks["flash_attention"] = flash_attention_phase()
    emit({"phase": "kernel_check", "flash_attention": checks["flash_attention"]})

    emit(flash_kernels_line())

    # 14. phi4-mini-3.8b serving; launches counted over the kernel serve (the
    #     float32 gate's for the CUDA-core kernel, which bf16 serving skips)
    lm_counts, f32_counts = lm_phase()

    # 14b. minicpm3-4b (MLA), deepseek-v2-lite-16b (MLA + MoE),
    #      granite-moe-3b-a800m (MoE) and command-r-35b serving; launches
    #      counted over each kernel serve and each float32 gate's kernel
    #      serve (``<path>_f32_gate``)
    lm_paths = {"phi4": lm_counts, "phi4_f32_gate": f32_counts}
    for cell in LM_CELLS:
        path = LM_PATHS[cell[1]]
        lm_paths[path], gate_counts = lm_cell(*cell)
        if gate_counts is not None:
            lm_paths[f"{path}_f32_gate"] = gate_counts
    attention_paths = {
        "flash_attention": {p: c["flash_attention_tc"] for p, c in lm_paths.items()},
        "flash_decode": {p: c["flash_decode"] for p, c in lm_paths.items()},
        "flash_attention_simt": {p: c["flash_attention"] - c["flash_attention_tc"]
                                 for p, c in lm_paths.items()}}
    for name, paths in attention_paths.items():
        launches[name] = sum(paths.values())
    checks["flash_decode"] = checks["flash_attention_simt"] = checks["flash_attention"]

    # 15. embedding_bag against its plain version at the DLRM shapes
    checks["embedding_bag"] = embedding_bag_phase()
    emit({"phase": "kernel_check", "embedding_bag": checks["embedding_bag"]})

    # 16. dlrm-rm2 serving; launches counted over the kernel serve
    launches["embedding_bag"] = dlrm_phase()["embedding_bag"]

    # 17. dlrm-rm2 training; launches counted over the kernel run's steps
    dlrm_train_counts, bag_case, table_case = dlrm_train_phase()
    # 18. LM training: phi4-mini-3.8b, minicpm3-4b (MLA), granite-moe-3b-a800m
    #     (MoE) and deepseek-v2-lite-16b (MLA + MoE, 11 of 27 layers);
    #     launches counted over each one's steps
    train_counts = {}
    for arch, path in LM_TRAIN_CELLS:
        train_counts[path], tokens = lm_train_phase(arch, path)
        if arch == LM_ARCH:
            train_tokens = tokens
        del tokens
    embed_case = lm_embed_grad_case(train_tokens)
    del train_tokens
    # 18b. the sharded step on a (1, 1) grid at NCCL world 1
    train_counts["lm_mesh"] = lm_mesh_phase()
    # 19. the attention backward against its plain version
    checks["flash_attention_bwd"] = flash_attention_bwd_phase(LM_TRAIN_BATCH)
    checks["embedding_bag"].append(bag_case)
    checks["segment_sum"] += [table_case, embed_case]
    emit({"phase": "kernel_check", "flash_attention_bwd": checks["flash_attention_bwd"],
          "embedding_bag": [bag_case], "segment_sum": [table_case, embed_case]})
    segment_paths["dlrm_train"] = dlrm_train_counts["segment_sum"]
    attention_paths["flash_attention_bwd"] = {}
    for path, c in train_counts.items():
        segment_paths[path] = c["segment_sum"]
        attention_paths["flash_attention"][path] = c["flash_attention_tc"]
        attention_paths["flash_decode"][path] = c["flash_decode"]
        attention_paths["flash_attention_simt"][path] = (c["flash_attention"]
                                                         - c["flash_attention_tc"])
        attention_paths["flash_attention_bwd"][path] = c["flash_attention_bwd"]
    bwd_routes = {"tc": sum(c["flash_attention_bwd_tc"] for c in train_counts.values())}
    bwd_routes["simt"] = sum(attention_paths["flash_attention_bwd"].values()) - bwd_routes["tc"]
    for name, paths in attention_paths.items():
        launches[name] = sum(paths.values())
    bag_paths = {"dlrm_serve": launches["embedding_bag"],
                 "dlrm_train": dlrm_train_counts["embedding_bag"]}
    launches["embedding_bag"] = sum(bag_paths.values())

    # summary lines
    line = nvidia_smi()
    name, _, power = line.rpartition(",")
    emit({"phase": "device", "nvidia_smi": line, "name": name.strip(),
          "power_limit": power.strip()})
    sources = {"member_probe": ("src/repro_torch/kernels/csrc/member_probe.cu",
                                "src/repro/kernels/member_probe.py:52", "filter_sets"),
               "set_intersect": ("src/repro_torch/kernels/csrc/set_intersect.cu",
                                 "src/repro/kernels/set_intersect.py:34", "ccjoin"),
               "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                               "src/repro/kernels/segment_sum.py:53", "gatedgcn_slice_sorted"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                                   "src/repro/kernels/flash_attention.py:84", "prefill"),
               "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_attention.py:84", "decode_first"),
               "flash_attention_simt": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                        "src/repro/kernels/flash_attention.py:84",
                                        "prefill_f32_gate"),
               "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                                 "src/repro/kernels/embedding_bag.py:41", "serve_bulk"),
               "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
                                       "src/repro/kernels/flash_attention.py:84", "train")}
    kernels = []
    for name, (src, replaces, case) in sources.items():
        rec = next(r for r in checks[name] if r["case"] == case)
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                 "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                 "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                 "library_ms": rec["library_ms"], "case": case}
        if name in DDSL_KERNELS:
            # the same kernel's launches on each DDSL path (counts set to 0
            # just before each path and read just after)
            entry["launches_by_path"] = {
                "wt_q1": launches[name], "wt_clique": wcoj_launches[name],
                "wt_multi_auto": auto_launches[name], "backend": backend_launches[name],
                "service": service_launches[name], "rebalance": rebalance_launches[name],
                "mesh": mesh_launches[name],
                **{path: n[name] for path, n in planted_launches.items()}}
        elif name == "segment_sum":
            entry["launches_by_path"] = segment_paths
        elif name in attention_paths:
            # the serving paths and the LM training steps (counts set to 0
            # just before each and read just after); launches is their sum
            entry["launches_by_path"] = attention_paths[name]
        elif name == "embedding_bag":
            entry["launches_by_path"] = bag_paths
        if name == "flash_attention_bwd":
            # the route the training steps' backward launches took
            entry["launches_by_route"] = bwd_routes
            entry["library_bwd_ms"] = rec["library_bwd_ms"]
        kernels.append(entry)
    emit({"kernels": kernels})
    # the contract's last line, exactly (no t_s)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernel-times"] and len(sys.argv) == 3:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
        kernel_times(sys.argv[2])
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--kernel-times SRC]")
    else:
        main()
