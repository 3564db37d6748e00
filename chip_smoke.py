#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (``elasticdl_tpu_torch``) on one card.

    python3 chip_smoke.py                # every phase below
    python3 chip_smoke.py --phase fwd    # kernel #1 alone: build, check, time
    python3 chip_smoke.py --phase bwd    # kernels #3 and #4 alone
    python3 chip_smoke.py --phase chunk  # kernel #2 alone
    python3 chip_smoke.py --phase lookup # kernels #5 and #6 alone
    python3 chip_smoke.py --phase host   # the host tier alone, no kernel build
    python3 chip_smoke.py --phase vision # the vision zoo alone, no build
    python3 chip_smoke.py --phase tabular # the tabular zoo alone, no build
    python3 chip_smoke.py --phase checkpoint # checkpoints and the jobs
                                             # alone (embedding kernels)
    python3 chip_smoke.py --phase worker # the master's task plane and the
                                         # worker alone (embedding kernels)
    python3 chip_smoke.py --phase rowservice # the row service alone, no
                                             # build, with its timings
    python3 chip_smoke.py --phase fleet  # the rest of serving alone
                                         # (kernel #1 only), with timings
    python3 chip_smoke.py --phase parallel # data and tensor parallel
                                           # over the one-card mesh
                                           # alone (embedding and
                                           # flash kernels)
    python3 chip_smoke.py --phase multihost # data, tensor and sequence
                                            # parallel across two
                                            # processes on the card
                                            # alone (embedding and
                                            # flash kernels)
    python3 chip_smoke.py --phase tpfault # 11i (d) sound and with a
                                          # planted tp fault: the gaps
                                          # TP_TOL must separate
    python3 chip_smoke.py --phase pipeline # PipelineLM at the flagship's
                                         # widths vs TransformerLM
    python3 chip_smoke.py --phase moe    # MoE, the fused head and
                                         # generate alone (the flash
                                         # forward and backward kernels)
    python3 chip_smoke.py --phase failover # 11f (a) and (e) alone, the
                                           # port's failover drill and
                                           # the journal's fsync times

1. Prints the card (``nvidia-smi`` name and power limit), versions, and
   whether ``grpc`` can be imported.
2. Builds every CUDA kernel of the port from ``elasticdl_tpu_torch/ops/csrc``.
3. Holds each kernel against its plain PyTorch version on the card:
   flash-attention forward (#1) folded over the kernel's own key tiles
   and, beside it, over the whole score matrix, at the flagship
   forward's shape (B 8, H 4, S 1024, D 128, causal, bf16), at the
   served requests' (S 128 and a ragged S 100), at BH 4 x S 8192, and at
   further shapes that reach every instance of the kernel (bf16 and
   f32, head dim 16, 32, 64 and 128, causal and not, ragged last tiles,
   scores below -1e30); bf16 cases also read the plain version without
   p's rounding, which must fail. Times the kernel's device time (a CUDA
   graph of 50 launches) beside the CUDA-event window of 50 calls and
   its issue time, the plain version and the PyTorch library call that
   computes the same function (SDPA, a yardstick only, its device time
   measured the same way) at B 8 x S 1024 and BH 4 x S 8192. The zoo
   twin (head dim 16) runs a ragged forward on the card through the
   kernel.
4. Serves the transformer-LM flagship (vocab 32768, d_model 512, 4 heads
   of 128, 8 layers, d_ff 2048, max_len 1024, bf16, random weights from
   a seed carried through ``bridge.state_dict_from_flax``): exports a
   bundle, starts ``InferenceServer`` on CUDA and sends three JSON
   predicts of 128 tokens, two of them concurrent so the batcher forms
   a batch of two, then one of 100 tokens (a length that is not a tile
   multiple). Kernel launch counts are zeroed just before and read
   just after.
5. Checks every reply is 200, that each layer of each served batch went
   through the kernel (the 100-token request too), that the answers
   match an in-process ``ServedModel.predict`` and the same bundle run
   on the CPU through the plain versions.
6. Times a batched predict at B 8 x S 1024: the forward over several
   windows with CUDA events (median and spread, with the host's time to
   issue each window and the card's clocks after), and the host clock
   around ``ServedModel.predict``.
7. Holds the backward kernels (dq and dk/dv, ``flash_chunk_grads``)
   against their plain version on the card, launched through their C
   entry points into outputs filled with NaN: the flagship's shape (BH
   32, S 1024, D 128) bf16 causal and not and f32 causal, ragged lengths
   and every head dim, a ring chunk (Sq 512 of Sk 1024 at q_offset 512),
   the zoo twin's training shape, keys beyond every causal query (their
   k tiles must store zeros), q rows before every key (k_offset 128:
   their dq rows must be zeros, at D 128 and 32, both dq routes), the
   ring's wholly future pair (every gradient zero), and the ring's local
   block (BH 4, 2048, D 128) as a past and as the diagonal chunk; then
   gradients through ``flash_attention`` against the CPU plain path.
   Each check prints its readings (largest error, median and largest
   |w|, relative L2) and, for bf16, the same readings of the plain
   version without its bf16 roundings, which must fall outside the
   limits. Prints the dq kernels' ptxas lines (registers, spills, shared
   memory, wgmma serialization). Times each kernel's device time (a CUDA
   graph of 50 launches) beside its bound and SDPA's flash backward op
   on the same work, measured the same way (a yardstick only), and the
   pair's sum, at the flagship shape and the ring's two chunks, and the
   plain version at the flagship shape.
8. Trains the zoo twin for 5 steps through ``LocalExecutor`` on the card
   and on the CPU from the same seed: the losses, the first step's
   gradients and every parameter's change agree, and the ``--output``
   bundle serves on the card. Steps are recorded by a ``Callback``
   passed to the executor.
9. Trains the flagship through ``LocalExecutor`` (a zoo module written
   to a temp dir calls the twin's ``custom_model`` with the flagship
   config, bench_suite.py's ``_transformer_spec``): 40 steps at B 8 x
   S 1024 on +1-chain records. Launch counts are zeroed just before and
   read just after: 8 forward, 8 dq and 8 dk/dv launches a step. Checks
   finite parameters and a falling loss; times the step with CUDA
   events beside the host's time to issue it.
10. ``embedding kernel check``: every embedding kernel and rule against
   its plain version on the card (``ops/pallas_embedding.py``): both
   lookups (#6 ``lookup_combine``, #5 ``lookup_combine_aligned``) at the
   recsys step's shape (1M x 256, B 512, L 32) and at odd batches,
   widths 16 to 2000 (130: not a multiple of 4), zero-weight rows under
   mean and sqrtn and ids outside the table, and cases that reach #5's
   ring and grid (ids outside the table on reused ring slots at L 96,
   rows split into column strips at B 1 and 64, D 4, and a table viewed
   at a 4-byte offset, #5's 4-byte instance; #5's lines name its
   instance and ring), each launched again through its C entry point
   into a NaN-filled output that must equal the wrapper's bit for bit
   (``--phase lookup`` runs these cases alone, then times #5, #6,
   ``embedding_bag`` and the bound at the sweep's four tiers, and prints
   the two lookup kernels' rows); the row kernel (#7) under
   SGD, Momentum, Adagrad, Adam and AMSGrad and the fused one (#8, SGD
   and Momentum) at the step's 1M x 256 shape and at odd n, Adam at
   steps 1 and 7, Nesterov on and off, cases where eps matters, with
   pads that carry gradients and every untouched row and slot checked
   bit-equal. Each case prints its readings; the limits sit between the
   sound readings and those of mutants of the sources (PERF.md).
11. ``sparse training``: the recsys twin at full width (1,000,000 x 256
   f32 table, 32 ids an example, Adagrad rows, bf16 MLP, Adam) through
   ``LocalExecutor`` from a zoo module written to a temp dir that pins
   the kernels with ``use_pallas="always"``: 2048 frappe-style records,
   B 512, 6 epochs, 1024 validation records. Launch counts are zeroed
   just before and read just after: lookup = train steps + eval
   batches, row update = train steps. The same run on the library route
   ("never") from the same seed: the losses and the touched rows agree,
   untouched rows stay bit-equal to their initial values, the loss
   falls; step ms (CUDA events) beside issue ms, examples/s, peak memory.
   Then the twin at 100,000 x 64 for 5 steps with the kernels, on the
   card and on the CPU (plain versions), agreeing.
11b. ``host training`` (the host tier; ``--phase host`` runs it alone):
   2048 frappe records (10 ids in [0, 5500)), the deepfm_host twin
   through ``LocalExecutor`` at B 512 for 4 epochs, once on the card and
   once on the CPU from the same seed, through a zoo module written to a
   temp dir whose runner applies rows synchronously: per-step losses and
   the touched rows' change agree, the table holds exactly the touched
   ids, untouched ids read their lazy initial rows, the loss falls, the
   table is the native store (``g++``-built at first use; its build
   seconds printed), and no kernel launches. Then the zoo's own runner
   (async apply) on the card for 8 epochs: finite parameters, a falling
   loss, step ms (CUDA events) beside issue ms and examples/s. Then the
   host engine alone at the recsys shape (a native 1,000,000 x 256 f32
   table, lazily materialised, 16,384 ids a batch, Adagrad rows): median
   ms of dedup, row pull, pad, the whole prepare, device placement and
   apply. Then deepfm_functional (BASELINE #4) for 5 Local steps on the
   card and on the CPU: losses, first-step gradients and every
   parameter's change within the zoo twin's limits, no kernel launches.
11c. ``vision`` (BatchNorm and the vision zoo; ``--phase vision`` runs
   it alone): mnist_functional through ``LocalExecutor`` at B 512 for 5
   steps on the learnable mnist records, on the card and on the CPU from
   the same seed: losses, first-step gradients, every parameter's
   change (TRAJ_TOL) and the running statistics agree; the card's
   ``--output`` bundle served on the card (``load_served_model``)
   answers as the trained model's eval forward; on the card a full batch
   moves the statistics and a batch with padded rows leaves them
   bit-equal, from a host mask and from a batch already on the card.
   Then the resnet50 twin (``custom_model()``: s2d stem, 10 classes) at
   B 128 x 224 x 224 through the executor's train step on bench_suite's
   synthetic batches, 3 untimed and 10 timed steps: step ms (CUDA
   events) beside issue ms, examples/s, peak memory; a finite loss and
   every statistic moved. Every kernel counter reads 0 on these paths.
11d. ``tabular`` (the preprocessing package and the tabular zoo;
   ``--phase tabular`` runs it alone): census_wide_deep (BASELINE #5),
   census_dnn, census_feature_columns, census_sqlflow and heart on
   their generators' records, iris from a CSV, each through
   ``LocalExecutor`` at B 512 for 5 steps on the card and on the CPU
   from the same seed: losses, first-step gradients and every
   parameter's change (TRAJ_TOL). Then census_wide_deep on 4096 records
   for 3 epochs on the card, evaluated on 1024 at the end: step ms (CUDA
   events) beside issue ms, examples/s, peak memory, and its
   ``dataset_fn`` on one batch on the host; its card run's ``--output``
   bundle served by ``InferenceServer`` on the card answers a JSON
   predict of dict features as the trained model's eval forward. Every
   kernel counter is zeroed before the phase and reads 0 after it.
11e. ``checkpoint`` (checkpoints, resume and the evaluate/predict
   jobs; ``--phase checkpoint`` runs it alone and builds only the
   embedding kernels): (a) the recsys twin at full width with the
   kernels pinned, a straight run of 8 steps over records A then B
   against a split run, A with ``--checkpoint_steps 4`` and a new
   executor restored by ``--checkpoint_dir_for_init`` over B, each run
   evaluated on one batch: the restored state (table, accumulator,
   dense parameters, Adam slots, step, generator, table steps) equals
   the saved one bit for bit; the resumed losses, the touched rows'
   change and accumulator within SPARSE_TOL of the straight run;
   untouched rows bit-equal; launches exactly lookup = steps + eval
   batches and Adagrad row updates = steps on each run; the save's
   stall, seconds, bytes and GB/s and the restore's seconds from the
   port's registry, the card's peak memory and the host's RSS. (b)
   deepfm_host, a base and two deltas (``--checkpoint_delta_chain 2``)
   resumed from the chain: host rows and slots bit-equal after the
   restore, losses and rows within HOST_TOL of a straight run, no
   kernel launch. (c) census_wide_deep with its schedule compressed in
   versions: the split run's learning rate at each version equals the
   straight run's; ``python -m elasticdl_tpu_torch evaluate`` and
   ``predict`` in two subprocesses side by side on the card from the
   checkpoint: metrics
   equal to the training executor's final eval, predictions (the zoo
   module's ``PredictionOutputsProcessor``) bit-equal to its eval
   forward; TensorBoard's scalars carry the eval metrics.
11f. ``worker`` (the master's task plane and the worker; ``--phase
   worker`` runs it alone and builds only the embedding kernels): the
   recsys twin at full width, kernels pinned, 4096 records (8 steps at
   B 512) in tasks of 4 minibatches, one epoch, no shuffle, the master
   evaluating 1024 records every 8 versions. (a) The port's
   ``MiniCluster`` (one worker on the card, ``InProcessMaster``) against
   ``LocalExecutor`` on the same records and seed: per-step losses, the
   table and the accumulator bit-equal, untouched rows bit-equal to the
   initial table, launches exactly lookup = 8 steps + eval batches and
   Adagrad row updates = 8 (every other counter 0, zeroed just before
   the run and read just after), the master's accuracy at version 8
   equal to the Local run's final eval, the dispatcher's counters at
   4096 training records; step ms (CUDA events) beside issue ms and
   examples/s for the worker and the Local run, and the RPCs a step.
   (b) The same job with the zoo's ``dataset_fn`` raising once at the
   first batch of task 2: the task is re-queued at the front, the job
   drains, the run is bit-equal to (a) with (a)'s launches. (c)
   deepfm_host through the worker at B 512 for 8 steps (tasks of 4,
   each ending with the runner's ``flush``), a synchronous runner on
   the card against the CPU within HOST_TOL, untouched ids bit-equal,
   then the zoo's asynchronous runner (the worker's row pull-ahead) on
   the card; every kernel counter 0. (d) The port's ``Master`` on
   localhost:0 in this process and ``python -m
   elasticdl_tpu_torch.worker.main`` on the card in a subprocess, over
   gRPC, on (a)'s records laid out so that the master's seeded shuffle
   hands them out in (a)'s order; the subprocess starts after (a) and
   runs while (b) and (c) run here: the worker exits 0, the job drains,
   the master's accuracy equals (a)'s at each round; its wall time, the
   time from its first task and examples/s over it. Without a ``grpc``
   module (and only then) (d) prints that it did not run. (e) (d)'s job
   through a journaled primary ``master.main`` and a ``--standby`` on one
   ``--journal_dir`` (heartbeat 0.2 s, 2 misses) and a worker subprocess
   on the card with ``--master_addr primary,standby`` (a wrapper around
   ``worker.main``'s entry point that holds its first training report and
   its first evaluation report at a pause, times its master RPCs and
   prints its launches last), started beside (d): the primary SIGKILLed
   while the journal (read with ``read_records``) shows the training task
   leased, so the standby fences and promotes; then the promoted standby
   SIGKILLed with the eval round open and the task's fold in, and a cold
   ``master.main`` relaunch on the primary's port (imported up front
   behind a go file) replays the journal. The final journal, recovered
   into a fresh dispatcher here, counts every training record once, its
   generation is 2 and ``check_journal`` finds nothing; the master's
   accuracy equals (a)'s bit for bit and the worker's launches equal
   (a)'s; each takeover's time from the kill to the worker's first
   acknowledged RPC and first task, and the cold replay's records and
   seconds. ``--phase failover`` runs (a) and (e) alone, then the port's
   failover drill (``chaos/failover_drill.py``: a twin, a standby run and
   a restart-and-replay run, held to the drill's gates) and one journal
   append's and one bare write+fsync's p50/p99 on the host's disk.
11g. ``rowservice`` (the row service; ``--phase rowservice`` runs it
   alone, with no kernel build): deepfm_host's 5500 x 16 native table
   behind the port's ``HostRowService`` over localhost gRPC, 2048 frappe
   records at B 512 in tasks of 4 minibatches. (a) One worker on the
   card with a synchronous remote runner (``HostStepRunner(
   make_remote_engine(addr, ...), async_apply=False)``) against one
   in-process service, held to the same job with the in-process
   synchronous runner: per-step losses, and the service's rows and step
   counters bit-equal; untouched ids read their lazy rows; the remote
   runner's ``host_tables`` is None. (b) The same job against two
   services: every row on its ``ShardMap.bootstrap`` home, the rows of
   both shards equal to (a)'s, the two-shard ``export_dense`` equal to
   the one-shard one. (c) ``python -m
   elasticdl_tpu_torch.embedding.row_service`` in a subprocess
   (``--checkpoint_steps 4 --shard_id 0 --num_shards 1``; in the whole
   smoke it is started before the worker phase and boots while that
   runs) shared by two workers on the card (``MiniCluster``, the zoo's
   async runner) over 2560 records, run first: the job drains (5
   pushes), losses finite; after SIGTERM the newest valid checkpoint
   version equals the push count, and a relaunch (restoring while (a)
   and (b) run) restores it and answers a pull with the saved rows bit
   for bit. The relaunch and (f)'s third incarnation are started with the
   first and import while the worker phase runs; each runs the service's
   main when its go file appears. The service of (c) and its relaunches are tiered and logged
   (``--hot_budget_rows 512 --push_log_dir``, durable acks, 2 ms group
   commit; the 5500 x 16 table is ~10x the budget): its ``row_tier_*``
   readings from ``/metrics`` (``--metrics_port 0``) show at most 512 hot
   rows, evictions and cold rows. (f) Through the relaunch, 2 more
   durably acked pushes (versions 6 and 7, under the checkpoint
   interval), the touched rows read, then SIGKILL: the port's
   ``tools.check_pushlog`` finds the log clean, and the third incarnation
   restores version 5, replays exactly 2 records and answers the pull
   bit for bit. Step
   ms (CUDA events) beside issue ms for (a)'s and (c)'s workers. Every
   kernel counter is zeroed just before each run and reads 0 after it.
   (d) ``--phase rowservice`` only: pull and push at the recsys shape
   (a native 1,000,000 x 256 table, Adagrad rows, 16,384 unique ids a
   batch) over localhost gRPC to the service's main in a subprocess,
   beside the in-process table's pull and apply: median ms and MB/s,
   cold and warm; the host engine's phases at that shape in the same
   call. (e) ``--phase rowservice`` only: deepfm_host's step through one
   worker on the card over 40 batches at B 512, the rows in process or
   on the service's main in a subprocess, with a synchronous and the
   zoo's asynchronous runner: step ms (CUDA events, one-step windows)
   beside issue ms; every kernel counter 0. (g) ``--phase rowservice``
   only: the tiered store at the recsys shape. (d)'s 1,000,000 x 256
   Adagrad table on the service's main in six subprocesses, tiered
   (``--hot_budget_rows 100000``) or not, each with a durable, an
   applied or no push log; the whole vocabulary is pulled once (the
   table 10x the budget), then 40 batches of 16,384 ids of a 65,536-row
   working set plus 64 strangers, 4,096 rows of the set replaced every
   5 batches (``tools/bench_tiered_store.py``'s schedule): pull and push
   p50 and p99 ms of each, the tiered durable service's faults,
   evictions, cold rows and bytes on disk; the final rows of all six
   byte-equal. Then that service is SIGKILLed after its last acked push
   and relaunched: the replay's records, seconds and MB/s, and a pull
   bit-equal to the rows read before the kill. (h) Live resharding in
   the whole smoke: (b)'s job on two in-process services under a port
   ``ShardMapController`` (RPC transports, its state file in the smoke's
   directory); after the worker's second push a thread runs ``split(0,
   new_addr=<a third in-process service>)`` while the next push is in
   flight (the migration's chunk hook holds the copy until that push
   has applied on the source, so a catch-up round ships it): losses and
   the ``export_dense`` over the final map bit-equal to (b)'s, every
   materialised id on one shard (its home under map v3: bootstrap v1,
   the added shard v2, the cutover v3), v3 on every service and, after
   its next pull, on the worker's client, ``check_reshard`` clean with
   no migration in flight, the move's rows, bytes, catch-up rounds and
   seconds. Then ``update_replicas()`` (``replica_min_pulls=1``,
   ``replica_count=1``) gives (b)'s most-pulled ids a replica each; once
   the homes' warm-up refreshes land, a fresh client's reads of them go
   through the replicas (``row_replica_reads_total`` rises, the
   staleness histogram counts the refreshes) and equal the homes'
   bytes. Every kernel counter reads 0. (i) ``--phase rowservice``
   only: live resharding at the recsys shape. (d)'s 1,000,000 x 256
   Adagrad table on the service's main in five subprocesses: a fleet of
   two shards and an empty third (the target) and a twin fleet of two,
   each under a bootstrap map; each fleet's whole vocabulary is filled
   by a zero-gradient push (rows and their Adagrad slots, ~1 GB a
   shard); one client a fleet runs 40 batches of 16,384 unique ids (64
   hot ids pinned in every batch), a pull and a push a batch, and after
   batch 10 the split fleet's controller splits shard 0 (~250,000 rows
   and their slots, ~512 MB in 2048-row chunks) while the batches go on;
   then its controller designates replicas from ``shard_stats``
   (``update_replicas``) and both fleets run 8 more batches: pull and
   push p50/p99 ms before, during and after the move, the move's
   seconds, MB/s, rows and catch-up rounds, the fenced window (fence to
   cutover, from the source's log), pushes retried after a fenced
   reply, the replicas' share of hot-id reads, their staleness p50/p99
   (bucket bounds), each shard's pulled rows a batch before and with
   replicas, each subprocess's peak RSS; then SIGTERM drains a
   checkpoint of every shard, and the two fleets' gathered rows and
   slots (one sha256 each) must be byte-equal, every id on one home.
11h. ``fleet`` (the rest of serving; ``--phase fleet`` runs it alone,
   builds only ``flash_attention_fwd.cu`` and exports the flagship
   bundle itself). Every kernel counter is zeroed just before each part
   and read just after. (a) deepfm_host through ``LocalExecutor`` on the
   card, 2048 frappe records (10 ids in [0, 5500)) at B 512 for one
   epoch, with ``--output``: the bundle holds the 5500 x 16 table
   materialised dense (trained rows bit-equal to the engine's, untouched
   rows their lazy initial values, the live table's row count unchanged
   by the export); ``ModelStore`` and ``InferenceServer`` on the card
   answer a msgpack and a JSON request of 64 examples (one id training
   never read) bit-equal to the trained module's forward on the card
   over the engine's rows, and the same bundle on the CPU within
   HOST_TOL; no kernel launches. (b) The trained module exported with
   ``host_id_keys``, served over a port ``HostRowService`` in process
   over localhost gRPC holding the trained rows, with a cache of 4096
   rows probed every request, over one shard and then two (a comma
   list): the answer equals (a)'s bit for bit, a repeat is served from
   the cache (hits = unique ids, no pull on any shard), and after a push
   the answer moves and equals the module's forward over the pushed
   rows; no kernel launches. (c) The flagship bundle of step 4 from two
   ``InferenceServer`` replicas on the card behind a ``RouterServer``
   (least loaded, hedging on): 16 msgpack requests of 128 tokens from 4
   threads, then 8 more under which replica 0 is stopped as a dead
   process stops (listener and open connections cut): every reply is
   200 and matches ``ServedModel.predict`` within LOGITS_REL_TOL,
   kernel #1 launches exactly 8 times the batches the two replicas'
   ``serving_batch_flushes_total`` count and no other kernel launches,
   the router marks replica 0 unhealthy and counts a failover, and the
   router's and the replicas' ``/metrics`` render their families. (d)
   ``--phase fleet`` only: the flagship's 128-token request latency, p50
   and p99 on the host clock, at concurrency 1 and 8, direct to a
   replica and through the router, with each replica's batch occupancy;
   the row-service bundle's resolve at B 512, cold and warm.
11i. ``parallel`` (data parallel over a (4,) ``dp`` mesh of the one
   card, and (d) tensor parallel; ``--phase parallel`` runs it alone
   and builds the embedding and flash sources). (c)'s first half runs
   first, then (a) and (b) while its checkpoint is written, then (c)'s
   second half, then (d). (a)
   cifar10_functional at B 256 through ``make_runner_for_spec`` with
   its LR schedule, dp4 against dp1 from the same weights, 8 steps:
   losses and every checkpoint leaf bit-equal (cuDNN deterministic),
   each entry holding 1/4 of the split slots' bytes, no launches. (b)
   resnet50 at B 128 x 224^2 through ``MiniCluster(mesh=dp4)`` in tasks
   of 2 steps, the master's barrier taking it to dp2 at the first report
   and back to dp4 once applied, against an unresized dp4 run over the
   same records: the meshes of the steps, both resizes applied and
   acked with their ``worker_resize_seconds``, losses and parameters
   bit-equal; then its step ms at dp4, dp2 and dp1 (CUDA events). (c)
   the recsys ranker at 1M x 256, B 512, through the zoo's
   ``make_sparse_runner(mesh=)`` with kernels pinned, its table and
   accumulator split 4 x 250,000: 8 steps against the unsharded runner
   (SPARSE_TOL), launches exactly #6 = #7 = 4 a step, others 0; every
   shard's #6 and #7 on the next batch's local ids against the plain
   version of the same shard (EMB_TOL, untouched rows bit-equal); a dp4
   checkpoint, a live resize to dp2 that keeps every byte, 4 more steps
   (#6 = #7 = 2 a step); the checkpoint restored into the unsharded
   state and placed at dp2, bit-equal to the state it saved; that state
   placed on dp4 takes one fused SGD step: #8 = 4, each shard's #8
   against its plain version. (d) tensor parallel in one process: the
   flagship at full width (2 layers, B 2 x S 512, bf16, weights from the
   seed through bridge) through the zoo twin's rules on a (1, 2, 2)
   dp/sp/tp mesh, 3 steps, against the unsharded run (#1) on the same
   batches: TP_TOL, launches exact (per step and layer each of the two
   tp entries folds 4 chunk pairs: #2 = #3 = #4 = 48, #1 0), step ms;
   and its probe (one step of SGD at lr 1 from the seed's weights with
   every bias drawn N(0, 0.05): the gradients) against the unsharded
   probe's, within TP_TOL's ``probe``. ``--phase tpfault`` runs (d) and
   its probe sound and with a planted fault (each row-parallel bias
   added once a tp entry, or not at all) and fails unless TP_TOL passes
   the first and refuses both faults.
11j. ``multihost`` (data, tensor and sequence parallel across two
   processes on the one card, ``parallel/multihost.py``; ``--phase
   multihost`` runs it alone and builds the embedding and flash
   sources). The two processes (this script
   with ``--multihost-child``) start with the smoke, import and join
   their process group (a ``FileStore``; the data group is gloo, both
   drive ``cuda:0``) while the other phases run, and wait for a go
   file: in the whole smoke it is written when the checkpoint phase's
   evaluate/predict subprocesses start, and the processes set up and
   train while those run (each draws the 1M x 256 table on the host,
   ~9 s, and places its shard) and while the worker phase runs ((d)-(f)),
   after which the smoke waits for them; their results are held to the
   references after the parallel phase ((a)'s is that phase's dp4 run
   at step 8). With ``--phase multihost`` the references run first
   ((a)'s: PR 18's row-split runner at dp2), then the go file. Each
   process: (a) the recsys ranker at 1M x 256 row-split
   over the two processes (a 500,000-row shard each, its table and
   accumulator 0.5 GB each), kernels pinned, 8 steps on its 256 rows of
   each global B 512 batch: launches exactly #6 = #7 = 8 in each process
   and 0 for the others (zeroed just before, read just after), its
   shard's #6 and #7 against their plain version on the same shard
   (EMB_TOL), the processes' losses equal and, with the touched rows
   and accumulator, within SPARSE_TOL of PR 18's one-process row-split
   runner at dp2 on the same batches; (b) mnist_functional at B 256
   (128 a process), SGD 0.001, 8 steps against the one-process dp2 run:
   losses and parameter changes within TRAJ_TOL, running statistics
   within VISION_STATS_TOL, both processes' states equal. Beside it,
   reported and not checked, the reduction order's own effect: the
   one-process run on the same batches with their rows permuted (the
   same sums in another order) against the one-process run, at 0.001
   and at SGD 0.01, where the trajectory diverges, with the two
   processes' run at 0.01 against one process, and both pairs at 0.01
   again with f32 compute; (c) a job over
   localhost gRPC, process 0 hosting the master (dispatcher, evaluation
   service) beside its worker, each worker built by ``worker.main
   .build_worker`` with ``--num_jax_processes 2``: 2048 mnist records
   at B 128 a process in tasks of 512, an eval task every 4 versions;
   both workers end at one version, every batch trained once, eval
   metrics reported. (d) the flagship of 11i (d) with ``tp`` across the
   processes (``(1, 2, 2)`` over ``("dp", "tp", "sp")``: half of each
   placed kernel, two heads, half of the vocabulary a process; the ring
   local), and (d') one step on ``(1, 2)`` over ``("dp", "tp")``, where
   attention does not ring and #1 takes each process's two heads; (e)
   ``sp`` across them (``("dp", "sp", "tp")``: each process its half
   of every sequence, K/V chunks and their gradients by send/recv);
   each against 11i (d)'s one-process run (d' against the unsharded
   run's first step) within TP_TOL, (d) and (e) with their probes
   against 11i (d)'s unsharded probe, the processes' losses and whole
   parameters equal, launches exact, and one launch of each kernel
   (#2 of a chunk from the other rank, #3/#4 of a past chunk or the
   diagonal, #1 in d') held to its plain version on the same inputs.
   (f) tests/test_feature_column.py:238's model, its 4 MB table split
   over the processes (16,384 rows each), against the one-process dp2
   run: TABLE_TOL, the processes equal. (g) 11l's PipelineLM with `pp`
   across the processes (each its stage, 4 of the 8 blocks, and the
   ends whole) against 11l (a)'s one-process run (PIPE_MH_TOL), the
   processes equal, #1 = #3 = #4 = 16 a process a step, one launch of
   #1 and of #3/#4 held to its plain version. (h) after (d)'s steps,
   both processes save through ``CheckpointHook(backend="orbax")``
   (``torch.distributed.checkpoint``, each its parts) and restore into
   a fresh state of (d)'s layout, bit-equal; process 0 restores the
   same version onto the unsharded model, bit-equal to the gathered
   state; the save's stall and seconds, its bytes, the restores'
   seconds. (i) (c)'s job writes its checkpoints (``--checkpoint_dir``,
   every 3 versions): its newest version is its final one, and a
   second job in the same processes from ``--checkpoint_dir_for_init``
   resumes there. Prints the data backend (and
   why), which gloo collectives take CUDA tensors, and per step the
   step ms (CUDA events), issue ms and the ms inside the collectives
   (the all-reduces, the all-gathers, the ring's and the pipeline's
   send/recv, its broadcasts).
11k. ``moe`` (the rest of the flagship transformer; ``--phase moe`` runs
   it alone): (a) bench_suite.py's moe config (8 experts in every
   second block, top-1, scatter, capacity factor 1.25) at full width
   through the zoo module and ``core.step``, 12 steps of B 8 x S 1024
   from the twin's own seeded init: the loss falls, #1 = #3 = #4 = 8
   launches a step exactly, step ms beside issue ms, tokens/s, peak
   memory, the dropped share; (b) with (a)'s weights the scatter at
   capacity factor E (drop-free) against the dense dispatch, one
   forward and backward (MOE_DISPATCH_TOL); (c) the zoo twin's CONFIG
   with 4 experts in block 1, 5 steps card vs CPU: the tokens routed
   differently, the losses within TRAJ_TOL; (d) the flagship's fused
   head against the materialised one at B 8 x S 1024: loss, lm_head's
   gradients (FUSED_TOL), launches, peak memory (the fused lower); (e)
   ``generate``, B 8, a 128-token prompt, 64 greedy tokens: ms a token,
   no launch while decoding, each token within GEN_MARGIN_ULPS bf16
   steps of the full forward's top logit; (f) in the multihost
   processes, MoE with ``ep`` across them and the scatter under ``dp``
   across them, each against the one-process run (MOE_MH_TOL, drops,
   launches, the processes equal). In the whole smoke (a)-(e) and (f)'s
   references run while the checkpoint phase's evaluate/predict
   subprocesses run, and (f) after the multihost phase.
11l. ``pipeline`` (the GPipe pipeline; ``--phase pipeline`` runs (a)
   alone and builds the flash forward and backward sources): (a)
   PipelineLM at the flagship's widths (dropout 0) on a one-card (pp 2,
   dp 2) mesh, 4 layers a stage, M 4, B 16 x S 1024, 3 Adam steps from
   its own seeded weights, against TransformerLM on the same weights
   (stage s, layer l as block 4s + l) and batches: each step's loss, the
   first step's gradients and the 3 steps' changes per tensor within
   PIPE_TOL; #1 = #3 = #4 = 32 a step exactly; step ms beside issue ms
   and tokens/s at M 4 and M 8 (64 launches a step), beside the
   flagship's. In the whole smoke it runs while the checkpoint phase's
   evaluate/predict subprocesses run, after the moe phase's parts; its
   run is (g)'s reference.
12. ``fused path``: ``DeviceSparseRunner`` over the recsys table with
   Momentum (Nesterov) and ``use_pallas="fused"`` for 10 steps against
   "never": one fused-kernel launch a step.
13. ``sparse sweep``: ``tools/bench_kernel_device_sweep.py``'s tiers
   (kernel, library and bound ms, a JSON line each), the path on which
   kernel #5's launches are counted.
14. ``chunk kernel check`` (after the backward checks): the ring's
   chunk-update kernel (#2, ``flash_chunk_update``) against its plain
   version folded in the kernel's own order (64-key tiles; on the wgmma
   route even tiles into the carry, odd ones into an empty state, then
   merged), and in one call over the whole chunk: f32 and bf16, head
   dims 16-128 (both bf16 routes), causal and not, a diagonal, a past
   and a wholly future chunk, one that masks only the first rows, one
   key tile and an odd number of them, Sq != Sk and ragged lengths, an
   initial carry and one folded from an earlier chunk; bf16 cases also
   read the plain version without the rounding of p, which must fail.
   Each case launches again through the C entry point into outputs
   filled with NaN and with the outputs aliasing a copy of the carry:
   both must equal the wrapper's bit for bit. Prints the kernels' ptxas
   lines. Times the kernel's device time (a CUDA graph of 50 launches)
   beside its event windows and issue time at the ring's local block
   (BH 4, 2048, bf16) for a past and a diagonal chunk at D 128 and 64,
   each beside its bound, the plain version and SDPA's flash forward
   with logsumexp over the same chunk (a yardstick: the chunk's products
   without the carry).
15. ``ring check``: ``ring_attention`` over ``make_mesh((4,), ("sp",),
   [cuda:0] * 4)`` against kernel #1 (and #3/#4) on the whole sequence,
   output and dq, dk, dv, at B 1 x S 8192 and B 8 x S 1024 (bf16), and
   f32 against the CPU plain ring; the whole ring forward at S 8192
   timed beside #1 and SDPA.
16. ``ring training``: the flagship's widths at max_len 8192 with remat,
   B 1 x S 8192, 10 Adam steps through ``MeshRunner`` on the (4,) sp
   mesh, and the same steps through ``core.step.build_train_step``
   (#1) from the same weights and batches: losses agree; exact launch
   counts (per step 256 chunk updates, 128 dq, 128 dk/dv; 128 chunk
   updates an eval batch); step ms beside issue ms, tokens/s, peak
   memory.
17. Prints a ``serving``, a ``training``, a ``sparse_training``, a
   ``ring_training``, a ``host_training``, a ``vision``, a ``tabular``,
   a ``checkpoint``, a ``worker``, a ``rowservice``, a ``fleet``, a
   ``parallel``, a ``multihost``, a ``moe``, a ``pipeline``, a
   ``phase_s`` (each phase's seconds)
   and a
   ``kernels`` JSON line (the four flash kernels and the four embedding kernels
   with their ms, plain ms, library ms, bound ms and launches, and their
   launches on the host, vision, tabular, checkpoint, worker and row
   service paths, ``launches_host_training``, ``launches_vision``,
   ``launches_tabular``, ``launches_checkpoint`` (the straight, first
   and resumed recsys runs), ``launches_worker`` (the in-process and
   failed-task runs), ``launches_rowservice`` ((a)'s two runs, (b),
   (c)), ``launches_fleet`` ((a), (b) over one and two shards, (c)),
   ``launches_parallel`` ((a), (b), (c) at dp4 and dp2, the fused step,
   (d)), ``launches_multihost`` ((a) in each process, (b), (c), (d),
   (d'), (e) and (g) a step in each process), ``launches_moe`` ((a),
   (d) fused and materialised, (e) decoding, (f) in each process),
   ``launches_pipeline`` ((a)'s step at M 4, the timed steps at M 4
   and M 8);
   #5 with its times at
   the sweep's tiers, the row kernels with a per-rule list) and, last,
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero; without CUDA it
exits 2 and prints no result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
SERVE_TOKENS = 128
RAGGED_TOKENS = 100   # a served length that is not a multiple of the tile
SEED = 0
DEVICE = "cuda"
# The whole smoke's aim in seconds (after the builds start), printed
# beside its total in the phase_s line (the script must end within
# 1200 s, the builds included).
SMOKE_AIM_S = 240
# bench_suite.py _TRANSFORMER_SIZES["transformer"] at the bench's
# vocab and context.
FLAGSHIP = dict(vocab_size=32768, d_model=512, n_heads=4, n_layers=8,
                d_ff=2048, max_len=1024)

# Stated tolerances. bf16 o: one bf16 rounding of o and of each p
# (relative 2^-9), p taken against the running max in the kernel and the
# final max in the plain version. f32: the order of f32 sums over up to
# 1024 keys. lse: f32 sums in a different order, in both dtypes.
TOL = {"bfloat16": dict(o=2e-2, lse=1e-3), "float32": dict(o=2e-5, lse=2e-5)}
# The forward (#1) against its plain version folded over the kernel's
# own key-tile width (fa.forward_block_k: 128 for the wgmma kernel, 64
# for the others), so that both round p to bf16 against the same running
# max: o per case, |g - w| <= elem * (|w| + median|w|) at every element
# and ||g - w|| / ||w|| <= l2; lse |g - w| <= lse * (1 + |w|). bf16: only
# an exp or a product sum that differs in its last f32 bit flips a
# rounding of p or of o; the plain version without p's rounding (the
# "unrounded" reading, o still rounded to bf16) must fail. f32: sums over
# 64 keys in another order. On an H100 (80GB HBM3, 700 W) sound bf16
# readings reach elem 1.4e-2, L2 1.6e-4, lse 2.9e-7 and the unrounded
# version L2 1.8e-3 or more; the limits sit between the sound readings
# and those of the mutants in tools/flash_fwd_mutants.py (PERF.md).
FWD_TOL = {"bfloat16": dict(elem=3e-2, l2=5e-4, lse=1e-5),
           "float32": dict(elem=2e-5, l2=1e-6, lse=1e-5)}
# Backward (dq, dk, dv in f32) against the plain version on the same
# inputs, per tensor: |g - w| <= elem * (|w| + median|w|) at every
# element, and ||g - w|| / ||w|| <= l2. bf16: kernel and plain version
# round ds and p to bf16 at the same points, from an exp whose last f32
# bits differ, so a rounding flips only now and then; one flip in a row
# that sums few terms (the first causal rows) moves an element by about
# 2^-8 of its size, which sets elem. The plain version without those
# roundings (the "unrounded" reading, printed beside) differs by about
# 2^-9 at every term: l2 sits between the two readings, and the script
# checks that the unrounded one fails. f32: sums over up to 1024 keys or
# queries in another order.
BWD_TOL = {"bfloat16": dict(elem=3e-2, l2=2e-4),
           "float32": dict(elem=2e-5, l2=1e-6)}
# Gradients through flash_attention on the card vs the CPU plain path,
# bf16 leaves: o and the gradients are rounded to bf16 on both sides,
# and a flip of o's rounding carries into every gradient of its row.
GRAD_TOL = dict(elem=6e-2, l2=5e-3)
# The zoo twin, 5 Local steps on the card vs the CPU (bf16 products in
# another order): the loss at each step, relative; the first step's
# gradient of every parameter and each parameter's change over the 5
# Adam steps, relative L2 per tensor (Adam's first step is lr * sign(g),
# so a sign that flips on a near-zero gradient moves a whole step). The
# key biases' true gradient is 0 (a bias shared by every key of a row
# leaves its softmax alone): both sides' gradients are noise and Adam
# steps them by it, so they are left out.
TRAJ_TOL = dict(loss=2e-4, grad_l2=2e-2, delta_l2=2.5e-1)
TRAIN_STEPS = 40
TRAIN_BATCH = 8
FLAGSHIP_ZOO = """
import torch

from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as twin
from elasticdl_tpu_torch.model_zoo.transformer.transformer_lm import (
    dataset_fn, eval_metrics_fn, loss, optimizer)
from elasticdl_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(vocab_size=32768, d_model=512, n_heads=4,
                           n_layers=8, d_ff=2048, max_len=1024,
                           dropout_rate=0.0, remat=False,
                           compute_dtype=torch.bfloat16)


def custom_model(device=None):
    return twin.custom_model(config=CONFIG, device=device)
"""
# The recsys ranker (model_zoo/recsys/recsys_sparse.py, bench_suite.py's
# "recsys" config): a 1M x 256 f32 table, 32 ids an example, batch 512.
EMB_VOCAB, EMB_DIM, EMB_IDS, EMB_BATCH = 1_000_000, 256, 32, 512
# Embedding kernels against their plain versions on the same inputs
# (grad_readings per output; row updates read the change of each touched
# row and slot, kernel vs plain). nvcc contracts a * b + c into fused
# multiply-adds where the plain version rounds the product first: on an
# H100 (80GB HBM3, 700 W) sound readings reach L2 1.2e-7 / elem 5.3e-7
# (lookups) and 4.1e-7 / 4.2e-6 (row updates), while mutants of the
# sources (eps dropped, Nesterov ignored, weights ignored) read 0.47 L2
# or more and a zero denominator gives NaN; a mutant that writes pads
# fails the bit-equality of untouched rows (PERF.md).
EMB_TOL = {"lookup": dict(elem=1e-5, l2=1e-6),
           "rows": dict(elem=3e-5, l2=2e-6)}
RECSYS_TABLE = "item_emb"
SPARSE_RECORDS, SPARSE_EVAL_RECORDS, SPARSE_EPOCHS = 2048, 1024, 6
FUSED_STEPS = 10
SMALL_VOCAB, SMALL_DIM = 100_000, 64
# The recsys twin's zoo module as a user would write it, pinning the
# kernels through the JAX package's own switch (or the library route).
RECSYS_ZOO = """
import functools

from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (  # noqa
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer)

make_sparse_runner = functools.partial(twin.make_sparse_runner,
                                       use_pallas="{mode}")
"""
# The twin at a small width, kernels pinned.
SMALL_ZOO = f"""
from elasticdl_tpu_torch.embedding.device_sparse import (
    DeviceSparseRunner, TableSpec)
from elasticdl_tpu_torch.embedding.optimizer import Adagrad
from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin
from elasticdl_tpu_torch.model_zoo.recsys.recsys_sparse import (  # noqa
    dataset_fn, eval_metrics_fn, loss, optimizer)

SPECS = (TableSpec(twin.TABLE_NAME, vocab={SMALL_VOCAB}, dim={SMALL_DIM},
                   feature_key=twin.FEATURE_KEY),)


def custom_model(device=None):
    return twin.RecsysRanker(emb_dim={SMALL_DIM}).to(device)


def make_sparse_runner():
    return DeviceSparseRunner(SPECS, Adagrad(lr=0.05), use_pallas="always")
"""
# The recsys twin, kernels ("always", "fused") against the library route
# ("never") on the card from the same seed: per-step losses (relative)
# and the change of the touched rows and their slots (relative L2). The
# rows' first Adagrad steps are ~1e-5 and follow d_emb, which comes back
# through the bf16 MLP: a lookup sum in another order flips bf16
# roundings, and a sound run on an H100 reads 2.3e-2 on the changes
# (max abs 4.2e-6) and 5.7e-5 on the losses, where a wiring fault (rows
# updated with another row's gradient, or not at all) reads about 1.
SPARSE_TOL = dict(loss=1e-3, delta_l2=0.1)
# The small twin, 5 steps on the card vs the CPU: losses (relative), the
# change of the table and of every dense parameter (relative L2; Adam's
# first step is lr * sign(g)).
SMALL_TOL = dict(loss=2e-3, delta_l2=0.25)
# The host tier: the deepfm_host twin at its widths (a
# 5500-id table of 16, 10 ids an example, bf16 MLP 64-32-1, SGD rows at
# 0.05, Adam 1e-3) through LocalExecutor at bench_suite's deepfm batch,
# card against CPU with a synchronous runner; then the zoo's own
# (asynchronous) runner on the card, timed over HOST_TIMED_EPOCHS.
HOST_RECORDS, HOST_BATCH, HOST_EPOCHS, HOST_TIMED_EPOCHS = 2048, 512, 4, 8
HOST_IDS, HOST_MAX_ID = 10, 5500
# Card vs CPU: per-step losses (relative) and the change of the touched
# rows (relative L2). The MLP computes in bf16 on both, with other
# summation orders (cuBLAS against the CPU's GEMM), so bf16 roundings
# flip; the rows' SGD steps follow d_emb through that MLP.
HOST_TOL = dict(loss=2e-2, delta_l2=2e-2)
# The sync runner's zoo module: the twin with async_apply off, so the
# card and CPU runs apply every step's rows before the next pull.
HOST_ZOO = """
from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
from elasticdl_tpu_torch.model_zoo.deepfm.deepfm_host import (  # noqa
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer)


def make_host_runner():
    return HostStepRunner(twin.make_host_runner().engine, async_apply=False)
"""
# The zoo's asynchronous runner on the card against a synchronous one,
# over HOST_DISJOINT_BATCHES batches each drawing its ids from a span of
# the id range of its own: no pull reads a row that an apply still in
# flight writes, so losses and the table must be bit-equal. This holds
# the paths that run only on the card: the row gradients' copy on a side
# stream into pinned memory, and the pull-ahead's pinned placement.
HOST_DISJOINT_BATCHES = 8
# The host engine alone at the recsys table's shape: a native
# EMB_VOCAB x EMB_DIM f32 table, materialised lazily, EMB_IDS ids an
# example at EMB_BATCH, uniform ids as the recsys records draw them,
# Adagrad rows (the recsys rule). Cold: HOST_ENGINE_BATCHES fresh
# batches, nearly every id a first touch. Warm: the same batches again,
# every row resident. The first HOST_ENGINE_SKIP batches of each pass
# are not counted.
HOST_ENGINE_BATCHES, HOST_ENGINE_SKIP = 12, 2
# deepfm_functional (BASELINE #4), card vs CPU for this many Local steps
# at HOST_BATCH, held to TRAJ_TOL as the transformer twin is.
DEEPFM_STEPS = 5
# The vision zoo (bench_suite.py CONFIGS: mnist at B 512, resnet50 at
# B 128 x 224 x 224). mnist_functional runs VISION_STEPS Local steps on
# the card and on the CPU from the same seed, on the learnable mnist
# records (testing.data: the label's block of pixels brightened), held
# to TRAJ_TOL: the loss, the first step's gradients and each parameter's
# change; the running statistics after the run at VISION_STATS_TOL
# (relative L2): they average bf16 activations that cuDNN's and
# oneDNN's convolutions sum in other orders, as the gradients do. Then
# the padded-batch guard on the card, and the --output bundle served on
# the card against the trained model's eval forward (LOGITS_REL_TOL).
# resnet50 (the zoo's custom_model(): s2d stem, 10 classes) takes
# VISION_WARM untimed and VISION_TIMED timed steps at RESNET_BATCH on
# bench_suite's synthetic batches (uniform [0, 1) images).
VISION_BATCH, VISION_STEPS = 512, 5
VISION_STATS_TOL = 2e-2
RESNET_BATCH, RESNET_HW = 128, 224
VISION_WARM, VISION_TIMED = 3, 10
# The tabular zoo (bench_suite.py CONFIGS["census"] at B 512).
# Each twin runs TABULAR_STEPS Local steps on the card and on the CPU
# from the same seed, held to TRAJ_TOL: census_wide_deep (BASELINE #5),
# census_dnn, census_feature_columns and census_sqlflow on
# CENSUS_RECORDS census records, heart on its records, iris from a CSV.
# Then census_wide_deep through the executor on the card for
# TABULAR_TIMED_EPOCHS over the census records, the first TABULAR_WARM
# steps untimed, evaluated on CENSUS_EVAL_RECORDS at the end; its
# dataset_fn alone on one batch of records on the host, TABULAR_DECODES
# times; and the card run's --output bundle served by InferenceServer
# on the card: one JSON predict of dict features ({"ids", "dense"})
# against the trained model's eval forward (LOGITS_REL_TOL).
TABULAR_BATCH, TABULAR_STEPS = 512, 5
CENSUS_RECORDS, CENSUS_EVAL_RECORDS, TABULAR_RECORDS = 4096, 1024, 2560
TABULAR_TIMED_EPOCHS, TABULAR_WARM, TABULAR_DECODES = 3, 4, 10
TABULAR_SERVED_ROWS = 8
# (model_def, records: "census", "heart" or "iris")
TABULAR_TWINS = (
    ("census.census_wide_deep.custom_model", "census"),
    ("census.census_dnn.custom_model", "census"),
    ("census.census_feature_columns.custom_model", "census"),
    ("census.census_sqlflow.custom_model", "census"),
    ("heart.heart.custom_model", "heart"),
    ("iris.iris_dnn.custom_model", "iris"),
)
# Checkpoints, resume and the evaluate/predict jobs (slice 14; ``--phase
# checkpoint`` runs it alone). (a) The recsys twin at full width, its
# kernels pinned (RECSYS_ZOO "always"): a straight run over records A
# then B (CKPT_RECORDS each: 4 steps at EMB_BATCH), against a split run:
# A with --checkpoint_steps CKPT_STEPS, then a new executor restored
# from it over B; each run evaluated on CKPT_EVAL_RECORDS (one batch).
# The restored state equals the saved one bit for bit; the resumed
# losses and the touched rows' change and accumulator follow the
# straight run within SPARSE_TOL (the row gradients' index_add uses
# atomics on the card, so two runs differ by rounding).
CKPT_RECORDS, CKPT_EVAL_RECORDS, CKPT_STEPS = 2048, 512, 4
# (b) deepfm_host (HOST_ZOO, synchronous rows) at HOST_BATCH: A of
# HOST_CKPT_A records (6 steps) saved every 2 versions as a base and two
# deltas (--checkpoint_delta_chain 2), resumed over B (HOST_CKPT_B, 2
# steps), against a straight run, within HOST_TOL.
HOST_CKPT_A, HOST_CKPT_B = 3072, 1024
# (c) census_wide_deep (BASELINE #5) with its schedule read at
# CENSUS_LR_SCALE times the version, so the schedule's steps (versions
# 5000 and 12000) fall at versions 2 and 5 of a run of 8 steps at
# TABULAR_BATCH (records A and B, CKPT_RECORDS each); split at
# CKPT_STEPS. Then `python -m elasticdl_tpu_torch evaluate` and
# `predict` in two subprocesses side by side on the card from the
# straight run's
# checkpoint, on CENSUS_EVAL_RECORDS: the metrics equal the training
# executor's final eval and the predictions its eval forward, bit for
# bit (the same card, kernels and shapes).
CENSUS_LR_SCALE = 2500
CKPT_ZOO_CENSUS = f"""
import os

import numpy as np

from elasticdl_tpu_torch.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.model_zoo.census import census_wide_deep as twin
from elasticdl_tpu_torch.model_zoo.census.census_wide_deep import (  # noqa
    custom_model, dataset_fn, eval_metrics_fn, loss, optimizer)


def callbacks():
    return [LearningRateScheduler(
        lambda v: twin.lr_multiplier({CENSUS_LR_SCALE} * v))]


class PredictionOutputsProcessor:
    \"\"\"Saves each batch of predictions beside this module.\"\"\"

    def __init__(self):
        self.batches = 0

    def process(self, predictions, worker_id):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            f"predictions-{{self.batches:04d}}.npy")
        np.save(path, predictions)
        self.batches += 1
"""
# The task plane (slice 15; ``--phase worker`` runs it alone and builds
# only the embedding kernels): the recsys twin at full width, kernels
# pinned (RECSYS_ZOO "always"), trained by the port's worker on the
# port's master over WORKER_RECORDS records (8 steps at EMB_BATCH) in
# tasks of WORKER_TASK_BATCHES minibatches, one epoch, no shuffle, the
# master evaluating WORKER_EVAL_RECORDS every WORKER_EVAL_STEPS versions.
# (a) In process, against the Local executor on the same records and
# seed: the same batches in the same order on the same kernels, so the
# per-step losses, the tables and the accumulators are bit-equal. (b)
# The same job with the zoo's dataset_fn raising once, at the first
# batch of task 2 (batch WORKER_FAIL_AT_BATCH of the job): the task is
# re-queued at the front and the run stays bit-equal to (a). (c)
# deepfm_host (HOST_ZOO, synchronous rows) on WORKER_HOST_RECORDS
# records (8 steps at HOST_BATCH, tasks of 4) through the worker, card
# against CPU within HOST_TOL; then the zoo's own runner (asynchronous
# rows, so the worker pulls rows ahead) on the card. (d) The port's
# Master on localhost:0 in this process and `python -m
# elasticdl_tpu_torch.worker.main` on the card in a subprocess (started
# after (a), running beside (b) and (c)), over gRPC, on (a)'s records
# laid out so the master's seeded shuffle hands them out in (a)'s order:
# the master's accuracy equals (a)'s.
WORKER_RECORDS, WORKER_EVAL_RECORDS = 4096, 1024
WORKER_TASK_BATCHES, WORKER_EVAL_STEPS = 4, 8
WORKER_FAIL_AT_BATCH = WORKER_TASK_BATCHES + 1
WORKER_HOST_RECORDS = 4096
WORKER_RPCS = ("get_task", "report_task_result", "report_version",
               "report_evaluation_metrics", "report_metrics")
# The row service (slice 16; ``--phase rowservice`` runs it alone, with
# no kernel build): deepfm_host (5500 x 16 native table, SGD rows)
# behind the port's HostRowService over localhost gRPC, on ROWSVC_RECORDS
# frappe records at HOST_BATCH in tasks of WORKER_TASK_BATCHES. (a) One
# worker, synchronous remote runner, against the same job with the
# in-process synchronous runner: the same native store, the same SGD on
# the same unique ids in the same order, and the row gradients cross the
# wire as f32 bytes, so losses, rows and step counters are bit-equal.
# (b) The same job against two shards: every row on its bootstrap home,
# the rows gathered from both equal to (a)'s, and so the export. (c) The
# service's own main in a subprocess (``--checkpoint_steps``
# ROWSVC_CKPT_STEPS) shared by two workers with the zoo's async runner
# over ROWSVC_C_RECORDS records (two tasks, 5 pushes: an interval
# checkpoint at 4, the SIGTERM drain at 5); a relaunch restores the
# drained version and answers a pull with the saved rows bit for bit.
# Each start imports torch (~8 s on the chip machine), so all three
# incarnations are started ahead (the later two behind go files) and
# import while the worker phase runs.
# (d) ``--phase rowservice`` only: pull and push at the recsys shape
# (EMB_VOCAB x EMB_DIM native table, Adagrad rows, ROWSVC_TIMED_IDS
# unique ids a batch) over localhost gRPC to the service's main in a
# subprocess, beside the in-process table's pull and apply, cold and
# warm, over HOST_ENGINE_BATCHES batches (HOST_ENGINE_SKIP not counted).
# (e) ``--phase rowservice`` only: deepfm_host's step through one
# worker over ROWSVC_STEP_BATCHES batches, the rows in process or on the
# service's main in a subprocess, each with a synchronous and the zoo's
# asynchronous runner; and the host engine's phases at the recsys shape
# (``host_engine_times``) in the same call as (d).
# (c)'s service keeps ROWSVC_HOT_BUDGET rows of its table hot and logs
# every push ahead of its checkpoints; (f) pushes ROWSVC_KILL_PUSHES
# batches of ROWSVC_KILL_IDS ids through the relaunch, SIGKILLs it, and
# a third incarnation restores and replays them.
# (g) ``--phase rowservice`` only: the tiered store at the recsys shape,
# (d)'s table behind a ROWSVC_G_BUDGET-row hot tier or none, with each
# push-log ack mode (ROWSVC_G_SERVICES); ROWSVC_G_BATCHES batches of
# ROWSVC_TIMED_IDS ids from a ROWSVC_G_WORKING-row working set plus
# ROWSVC_G_STRANGERS strangers, ROWSVC_G_DRIFT rows of the set replaced
# every ROWSVC_G_DRIFT_EVERY batches (tools/bench_tiered_store.py's
# schedule at this shape).
ROWSVC_RECORDS, ROWSVC_C_RECORDS, ROWSVC_CKPT_STEPS = 2048, 2560, 4
ROWSVC_TIMED_IDS = 16384
ROWSVC_STEP_BATCHES = 40
ROWSVC_HOT_BUDGET = 512
ROWSVC_KILL_PUSHES, ROWSVC_KILL_IDS = 2, 1024
ROWSVC_G_BUDGET, ROWSVC_G_BATCHES = 100_000, 40
ROWSVC_G_WORKING, ROWSVC_G_STRANGERS = 65_536, 64
ROWSVC_G_DRIFT, ROWSVC_G_DRIFT_EVERY = 4096, 5
# (h): (b)'s job through a live split after ROWSVC_H_SPLIT_AFTER pushes
# (bootstrap v1, the third shard added v2, the cutover v3), then one read
# replica for each of the ROWSVC_H_HOT most-pulled ids, read
# ROWSVC_H_READS times by a fresh client (round robin: every other read
# through the replica).
ROWSVC_H_SPLIT_AFTER, ROWSVC_H_VERSION = 2, 3
ROWSVC_H_HOT, ROWSVC_H_READS = 8, 4
# (i) ``--phase rowservice`` only: live resharding at the recsys shape.
# (d)'s table on the service's main in subprocesses: a fleet of two
# shards plus an empty third (the split's target) and a twin fleet of
# two. Each fleet's whole vocabulary is filled by a zero-gradient push
# (a push materialises a row and its Adagrad slot; a pull only the row),
# then one client a fleet runs ROWSVC_I_BATCHES batches of
# ROWSVC_TIMED_IDS unique ids (ROWSVC_I_HOT of them pinned in every
# batch), a pull and a push a batch; after ROWSVC_I_SPLIT_AFTER batches
# the split fleet's controller splits shard 0 in a thread while the
# batches go on. Then its controller designates replicas (policy
# ROWSVC_I_POLICY) and both fleets run ROWSVC_I_REPLICA_BATCHES more.
ROWSVC_I_BATCHES, ROWSVC_I_SPLIT_AFTER, ROWSVC_I_HOT = 40, 10, 64
ROWSVC_I_REPLICA_BATCHES = 8
# The split fleet's batches go on until ROWSVC_I_AFTER_MOVE of them ran
# after the move (at most ROWSVC_I_MAX_BATCHES); the twin then runs as
# many.
ROWSVC_I_AFTER_MOVE, ROWSVC_I_MAX_BATCHES = 10, 200
ROWSVC_I_POLICY = dict(replica_top_k=64, replica_min_pulls=8,
                       replica_count=2)
ROWSVC_I_FLEETS = {"split": 3, "twin": 2}
# name: (tiered, push-log ack or None for no log)
ROWSVC_G_SERVICES = {
    "tiered_durable": (True, "durable"), "tiered_applied": (True, "applied"),
    "tiered_no_log": (True, None), "untiered_durable": (False, "durable"),
    "untiered_applied": (False, "applied"), "untiered_no_log": (False, None),
}
ROWSVC_BENCH_ZOO = f"""
from elasticdl_tpu_torch.embedding.optimizer import Adagrad
from elasticdl_tpu_torch.embedding.row_service import HostRowService
from elasticdl_tpu_torch.native.row_store import (
    make_host_optimizer, make_host_table)


def make_row_service():
    return HostRowService(
        {{{RECSYS_TABLE!r}: make_host_table({RECSYS_TABLE!r}, {EMB_DIM})}},
        make_host_optimizer(Adagrad(lr=0.05)))
"""
# The fleet phase (the rest of serving). (a) deepfm_host through
# LocalExecutor on the card, FLEET_RECORDS frappe records at HOST_BATCH
# for one epoch, with --output: its dense bundle served on the card (a
# request of FLEET_QUERY examples, msgpack and JSON). (b) The same
# trained module exported in row-service mode, served over a port
# HostRowService in process (one shard, then two) through a cache of
# FLEET_CACHE_ROWS rows probed on every request. (c) The flagship bundle
# from two replicas behind a RouterServer (least loaded, hedging on with
# a floor of FLEET_HEDGE_MIN_MS): FLEET_REQUESTS requests of
# SERVE_TOKENS tokens from FLEET_THREADS threads, then
# FLEET_FAILOVER_REQUESTS more while one replica is stopped under them.
# (d) ``--phase fleet`` only: request latency at concurrency 1 and 8
# (FLEET_LATENCY requests), direct and routed, beside the replicas' own
# request and batch times; one request's predict, reply encode and
# decode alone (FLEET_ALONE_REPS); and the row-service bundle's resolve
# at B HOST_BATCH, cold and warm (FLEET_RESOLVE_REPS).
FLEET_RECORDS, FLEET_EPOCHS, FLEET_QUERY = 2048, 1, 64
FLEET_CACHE_ROWS = 4096
FLEET_REQUESTS, FLEET_THREADS, FLEET_FAILOVER_REQUESTS = 16, 4, 8
FLEET_HEDGE_MIN_MS = 200.0
FLEET_LATENCY = {1: 400, 8: 400}
FLEET_ALONE_REPS = 20
FLEET_RESOLVE_REPS = 10
# Ring attention over an sp mesh of one card (slice 4): the long-context
# row of tools/bench_long_context.py, (S 8192, B 1, remat), on the
# flagship's widths, the sequence cut over RING_SP ranks (chunks of 2048).
RING_SP = 4
RING_SEQ = 8192
RING_TRAIN_STEPS = 10
# The chunk-update kernel (#2) against its plain version on the same
# inputs, folded over the kernel's 64-key tiles (so both take p against
# the same running maximum and round it to bf16 at the same points) and,
# read beside it, in one call over the whole chunk. Per output (m, l,
# acc): |g - w| <= elem * (|w| + median|w|) at every element and
# ||g - w|| / ||w|| <= l2, as the backward checks. bf16: only an exp or
# a product sum that differs in its last f32 bit flips a rounding, and
# the plain version without the rounding of p (the "unrounded" reading)
# must fail. f32: sums over 64 keys in another order.
CHUNK_TOL = {"bfloat16": dict(elem=3e-2, l2=2e-4),
             "float32": dict(elem=2e-5, l2=1e-6)}
# The whole-chunk plain version rounds p against the chunk's final
# maximum, the kernel against each tile's running one: a different bf16
# rounding of every p (2^-9 relative) that passes through the sums.
CHUNK_WHOLE_TOL = {"bfloat16": dict(elem=6e-2, l2=5e-3),
                   "float32": dict(elem=2e-5, l2=1e-6)}
# The ring on the card against kernel #1 (and #3/#4) over the whole
# sequence, bf16: p rounded against other maxima (as CHUNK_WHOLE_TOL),
# dq summed over the ring's chunks in f32 before its bf16 rounding. #1
# rounds p against 128-key tiles' running maxima (the wgmma kernel), the
# ring's #2 against 64-key tiles' in its own chunk order, so o and with
# it delta = rowsum(dO o o) differ by a rounding at many rows; where
# dp - delta cancels, that moves an element of dk by up to 7.8e-2 of
# (|w| + median|w|) on an H100 (80GB HBM3, 700 W), at L2 1.2e-3. The
# mutants of #2 that the ring check sees (tools/chunk_kernel_mutants.py:
# alpha dropped, carry ignored, k_offset ignored) read elem 6.6 or more
# there (PERF.md).
RING_TOL = {"bfloat16": dict(elem=1e-1, l2=5e-3),
            "float32": dict(elem=2e-5, l2=2e-6)}
# The flagship trained on the ring against the same steps through kernel
# #1 on the whole sequence, from the same weights and batches: per-step
# loss, relative. bf16 attention outputs that differ in their last bits
# read 2.7e-5 over 4 steps on an H100 (80GB HBM3, 700 W); a ring that
# folds a chunk at the wrong offset changes the attention of whole rows.
RING_TRAIN_TOL = dict(loss=1e-3)
# Served logits against the in-process predict / the CPU run of the same
# bundle: relative L2 error. Both run the bf16 model; a different batch
# size or device changes the matrix products' summation order, and a
# one-ulp bf16 difference in one layer carries through the next ones.
LOGITS_REL_TOL = 2e-2


def check(cond, message):
    if not cond:
        raise AssertionError(message)


def cuda_windows(fn, iters, windows, warmup=3):
    """Per-call ms over ``windows`` windows of ``iters`` calls each,
    timed with CUDA events, and the host's ms to issue each window's
    calls (the time before the end event is recorded)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    device_ms, issue_ms = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        issue_ms.append((time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end) / iters)
    return device_ms, issue_ms


def spread(values):
    return {"median": float(np.median(values)), "min": min(values),
            "max": max(values), "windows": values}


def cuda_ms(fn, iters, windows=5):
    """Median per-call ms over several windows."""
    return float(np.median(cuda_windows(fn, iters, windows)[0]))


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def flash_bound(bh, s, d, dtype, causal):
    """Least time for the flash forward's work on an H100: each input
    read once and each output written once over the memory rate, against
    the unmasked score pairs' two products over the peak rate."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * bh * s * d * elt + bh * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 2 * 2 * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_lines(log):
    """(kernel, "registers / spills / shared memory") per compiled
    kernel in an nvcc -Xptxas -v log, and each warning (ptxas says so
    where it must serialize wgmma instructions)."""
    import re

    name, out = "?", []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(_Z\w*)'", line)
        # The mangled name's kernel is the <length><name> pair whose
        # length matches (an anonymous namespace's hash may precede it).
        found = entry and next(
            (m for m in re.finditer(r"(?=(\d+)([a-z][a-z0-9_]*?_kernel)I"
                                    r"(\w*?)EE)", entry.group(1))
             if int(m.group(1)) == len(m.group(2))), None)
        if entry:
            targs = re.findall(r"Li(\d+)|Lb(\d)|(float4|float)",
                               found.group(3)) if found else []
            name = (f"{found.group(2)}<{','.join(''.join(t) for t in targs)}>"
                    if found else "?")
        elif any(word in line for word in ("spill", "registers", "error",
                                           "warning", "Performance")):
            out.append((name, line.split(":", 1)[-1].strip()))
    return out


def graph_ms(torch, fn, iters=50, replays=5):
    """Device ms per call with no host issue inside the window: ``iters``
    calls captured in one CUDA graph, each replay timed with CUDA events
    (one entry per replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


# Kernel #1's cases: (name, b, h, s, d, dtype, causal). "flagship" (the
# B 8 x S 1024 forward) and "long" (BH 4 x S 8192, the ring's
# single-device comparison) are timed. "saturated" sets q = 2^50 and
# k = -2^50 everywhere, so every score (exact in f32) lies below -1e30,
# the running max's start: every p underflows to 0 and o = 0, lse =
# -1e30 + log(1e-30), unless a masked key's p, exp(-1e30 - -1e30) = 1,
# is left unzeroed or the mask or the start is -inf. p is exactly 0 or
# 1 (no rounding to see), and the whole-matrix version takes each row's
# max from its scores alone (its last row, with no masked key, then
# differs), so the case is held to the tiled version only.
FWD_CASES = [
    ("flagship", 8, 4, 1024, 128, "bfloat16", True),
    ("served", 2, 4, SERVE_TOKENS, 128, "bfloat16", True),
    ("ragged", 1, 4, RAGGED_TOKENS, 128, "bfloat16", True),
    ("long", 1, 4, RING_SEQ, 128, "bfloat16", True),
    ("ragged", 2, 4, 1000, 128, "bfloat16", False),
    ("full", 8, 4, 512, 64, "bfloat16", False),
    ("causal", 2, 4, 256, 64, "bfloat16", True),
    ("ragged", 2, 4, 300, 64, "bfloat16", True),
    ("twin", 2, 8, RAGGED_TOKENS, 16, "bfloat16", True),
    ("ragged", 2, 4, 200, 32, "bfloat16", False),
    ("saturated", 1, 4, 384, 128, "bfloat16", True),
    ("saturated", 1, 4, 200, 16, "bfloat16", True),
    ("causal", 2, 4, 256, 128, "float32", True),
    ("full", 2, 4, 256, 64, "float32", False),
    ("ragged", 2, 4, 130, 16, "float32", True),
    ("ragged", 2, 4, 37, 32, "float32", False),
]
FWD_TIMED = ("flagship", "long")


def fwd_kernel(torch, fa, d, dtype):
    """The kernel #1 takes at a (head dim, dtype): the dispatch by head
    dim in flash_attention_fwd.cu, read through its key-tile width."""
    if dtype != torch.bfloat16:
        return "f32 scalar, 64-key tiles"
    if fa.forward_block_k(d, dtype) == 128:
        return "wgmma: TMA ring, 128 q rows, 128-key tiles"
    return "mma.sync: cp.async ring, 64 q rows, 64-key tiles"


def fwd_inputs(torch, rng, name, bh, s, d, dtype):
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d),
                                                    dtype=np.float32))
               .to(DEVICE, dtype) for _ in range(3))
    if name == "saturated":
        q, k = torch.full_like(q, 2.0 ** 50), torch.full_like(k, -2.0 ** 50)
    return q, k, v


def lse_reading(got, want):
    """The largest |got - want| / (1 + |want|)."""
    return ((got - want).abs() / (1 + want.abs())).max().item()


def kernel_phase(torch, fa, check=check, timed=True):
    """Kernel #1 against its plain version on the card over FWD_CASES:
    folded over the kernel's own key tiles (FWD_TOL) and, read beside
    it, over the whole score matrix (TOL); then its device time at the
    timed shapes. ``check`` may record instead of raise
    (tools/flash_fwd_mutants.py); each case's "ok" says whether it
    passed."""
    lib = fa._library()
    rng = np.random.default_rng(SEED)
    checks, timing = [], {}
    for name, b, h, s, d, dtype_name, causal in FWD_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = fwd_inputs(torch, rng, name, b * h, s, d, dtype)
        scale = d ** -0.5
        block_k = fa.forward_block_k(d, dtype)
        o, lse = fa.flash_forward_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_tiled, lse_tiled = fa.flash_forward_reference(q, k, v, causal,
                                                        scale, block_k)
        o_whole, lse_whole = fa.flash_forward_reference(q, k, v, causal,
                                                        scale)
        rounds = dtype_name == "bfloat16" and name != "saturated"
        if rounds:   # p unrounded, o still rounded to bf16
            o_unrounded = fa.flash_forward_reference(
                q.float(), k.float(), v.float(), causal, scale,
                block_k)[0].to(dtype)
        torch.cuda.synchronize()
        tol, whole_tol = FWD_TOL[dtype_name], TOL[dtype_name]
        label = (f"{name}/{dtype_name}/D{d}/S{s}/"
                 f"{'causal' if causal else 'full'}")
        res = {"case": label, "shape": [b * h, s, d], "kernel":
               fwd_kernel(torch, fa, d, dtype), "block_k": block_k, "tol": tol,
               "o": grad_readings(o, o_tiled),
               "lse": lse_reading(lse, lse_tiled)}
        o_err = (o.float() - o_whole.float()).abs()
        res["whole"] = {
            "max_abs_err": o_err.max().item(),
            "o_ok": bool((o_err <= whole_tol["o"]
                          * (1 + o_whole.float().abs())).all()),
            "lse_max_abs_err": (lse - lse_whole).abs().max().item(),
            "lse_ok": (lse - lse_whole).abs().max().item()
            <= whole_tol["lse"] * (1 + lse_whole.abs().max().item()),
            "tol": whole_tol, "held": name != "saturated"}
        ok = (bool(torch.isfinite(o.float()).all())
              and within(res["o"], tol) and res["lse"] <= tol["lse"])
        if res["whole"]["held"]:
            ok = ok and res["whole"]["o_ok"] and res["whole"]["lse_ok"]
        if rounds:
            res["o_unrounded"] = grad_readings(o_unrounded, o_tiled)
        res["ok"] = ok
        print("kernel check", json.dumps(res), flush=True)
        check(ok, f"kernel {label}: outside tolerance {res}")
        if rounds:
            check(not within(res["o_unrounded"], tol),
                  f"kernel {label}: the unrounded plain version passes "
                  f"the limits, which could not see a rounding fault {res}")
        checks.append(res)
        if timed and name in FWD_TIMED:
            timing[name] = (q, k, v, causal, scale, b, h)
    if not timed:
        return None, checks
    times = {name: fwd_times(torch, fa, lib, *args)
             for name, args in timing.items()}
    flagship = times["flagship"]
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:156",
        "kernels": {f"bfloat16 D{d}": fwd_kernel(torch, fa, d, torch.bfloat16)
                    for d in fa.HEAD_DIMS},
        "shape": flagship["shape"], "dtype": "bfloat16", "causal": True,
        "max_abs_err": max(c["o"]["max_abs_err"] for c in checks),
        "lse_max_abs_err": max(c["whole"]["lse_max_abs_err"]
                               for c in checks if c["whole"]["held"]),
        "checks": checks,
        **{key: flagship[key] for key in (
            "ms", "ms_replays", "event_ms", "issue_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_event_ms")},
        "kernel_ms": flagship["ms"],
        "ms_source": "CUDA graph of 50 launches, replayed, CUDA events",
        "long": times["long"],
    }, checks


def fwd_times(torch, fa, lib, q, k, v, causal, scale, b, h):
    """Kernel #1's device time (a graph of raw launches: these are not
    counted) beside the CUDA-event window of 50 wrapper calls and its
    issue time, SDPA's device time measured the same way, the plain
    version and the bound."""
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=DEVICE)
    ptrs = [t.data_ptr() for t in (q, k, v, o, lse)]

    def launch():
        err = lib.edl_flash_attention_fwd(
            *ptrs, bh, s, d, 1, scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"flash forward launch: CUDA error {err}")

    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale)

    device_ms = graph_ms(torch, launch)
    event_ms, issue_ms = cuda_windows(
        lambda: fa.flash_forward_cuda(q, k, v, causal, scale), 50, 5)
    library_ms = graph_ms(torch, sdpa)
    bound_ms, bound_by = flash_bound(bh, s, d, "bfloat16", causal)
    return {
        "shape": [bh, s, d], "ms": float(np.median(device_ms)),
        "ms_replays": device_ms, "event_ms": float(np.median(event_ms)),
        "issue_ms": float(np.median(issue_ms)),
        "plain_ms": cuda_ms(lambda: fa.flash_forward_reference(
            q, k, v, causal, scale), iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": float(np.median(library_ms)),
        "library_event_ms": cuda_ms(sdpa, iters=50),
    }


def post_json(port, tokens):
    body = json.dumps({"features": tokens.tolist()}).encode("utf-8")
    request = urllib.request.Request(
        f"http://localhost:{port}/v1/predict", data=body,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(request, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def grad_readings(g, w):
    """g against w (tensors, one device): the largest |g - w|, the
    median and largest |w|, the largest |g - w| / (|w| + median|w|)
    ("elem") and ||g - w|| / ||w|| ("l2")."""
    g, w = g.float(), w.float()
    err = (g - w).abs()
    size = w.abs()
    median = size.median().item()
    return {
        "max_abs_err": err.max().item(), "median_abs": median,
        "max_abs": size.max().item(),
        "elem": (err / (size + max(median, 1e-30))).max().item(),
        "l2": (err.norm() / w.norm().clamp_min(1e-30)).item(),
    }


def within(reading, tol):
    return reading["elem"] <= tol["elem"] and reading["l2"] <= tol["l2"]


def zoo_phase(torch, fa):
    """The zoo twin (head dim 16) on the card: a ragged forward goes
    through the kernel in every layer and matches the CPU run."""
    from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm

    torch.manual_seed(SEED)
    model = transformer_lm.custom_model(device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, model.cfg.vocab_size, (2, RAGGED_TOKENS)))
    with torch.inference_mode():
        want = model(tokens).numpy()
        model = model.to(DEVICE)
        before = fa.launches
        got = model(tokens.to(DEVICE)).cpu().numpy()
        launches = fa.launches - before
    err = rel_err(got, want)
    print("zoo twin", json.dumps({"head_dim": model.cfg.head_dim,
                                  "seq": RAGGED_TOKENS,
                                  "flash_launches": launches,
                                  "rel_err_vs_cpu_plain": err}), flush=True)
    check(launches == model.cfg.n_layers,
          f"zoo twin: {launches} flash launches for "
          f"{model.cfg.n_layers} layers")
    check(err <= LOGITS_REL_TOL, f"zoo twin != CPU plain: {err}")


def export_flagship_bundle(torch, bundle):
    """The flagship (random weights from SEED) exported to ``bundle``;
    returns its config."""
    from elasticdl_tpu_torch import bridge
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from elasticdl_tpu_torch.serving.export import export_serving_bundle

    cfg = TransformerConfig(**FLAGSHIP, compute_dtype=torch.bfloat16)
    model = TransformerLM(cfg)
    model.load_state_dict(bridge.state_dict_from_flax(
        bridge.init_flax_params(cfg, seed=SEED)))
    export_serving_bundle(
        bundle, model,
        batch_example=np.zeros((1, SERVE_TOKENS), np.int32),
        model_def="transformer.transformer_lm.custom_model", version=1,
    )
    return cfg


def serving_phase(torch, fa, bundle_root):
    from elasticdl_tpu_torch.serving.export import load_model
    from elasticdl_tpu_torch.serving.model_store import ModelStore
    from elasticdl_tpu_torch.serving.server import InferenceServer

    bundle = os.path.join(bundle_root, "v1")
    cfg = export_flagship_bundle(torch, bundle)
    rng = np.random.default_rng(SEED + 1)
    store = ModelStore(bundle_root, device=DEVICE)
    served = store.load_initial()
    server = InferenceServer(store, max_batch_size=8,
                             batch_deadline_ms=200.0, port=0).start()
    lengths = [SERVE_TOKENS] * 3 + [RAGGED_TOKENS]
    requests = [rng.integers(0, cfg.vocab_size, (1, n),
                             dtype=np.int64).astype(np.int32)
                for n in lengths]
    replies = [None] * len(requests)

    def send(i):
        replies[i] = post_json(server.port, requests[i])

    try:
        fa.launches = 0                       # the main path starts here
        t0 = time.monotonic()
        send(0)                               # alone: a batch of one
        pair = [threading.Thread(target=send, args=(i,)) for i in (1, 2)]
        for t in pair:
            t.start()
        for t in pair:
            t.join()
        before_ragged = fa.launches
        send(3)                               # ragged: not a tile multiple
        ragged_launches = fa.launches - before_ragged
        http_s = time.monotonic() - t0
        launches = fa.launches                # ... and ends here
        occupancy = dict(server.predictor.batch_occupancy)
        statuses = [status for status, _ in replies]
    finally:
        server.stop()
    batches = sum(occupancy.values())
    print("serving requests", json.dumps({
        "lengths": lengths, "statuses": statuses,
        "batch_occupancy": occupancy, "flash_launches": launches,
        "ragged_request_launches": ragged_launches, "seconds": http_s}),
        flush=True)
    check(statuses == [200] * len(requests), f"statuses {statuses}")
    check(max(occupancy) > 1, f"no batch larger than one: {occupancy}")
    check(launches == cfg.n_layers * batches,
          f"{launches} flash launches for {batches} batches of "
          f"{cfg.n_layers} layers: a layer left the kernel path")
    check(ragged_launches == cfg.n_layers,
          f"the {RAGGED_TOKENS}-token request made {ragged_launches} "
          f"flash launches, not {cfg.n_layers}")

    answers = [np.asarray(body["predictions"], np.float32)
               for _, body in replies]
    in_process = [served.predict(tokens) for tokens in requests]
    cpu_model = load_model(bundle, device="cpu")
    with torch.inference_mode():
        on_cpu = [cpu_model(torch.from_numpy(requests[i])).numpy()
                  for i in (0, 3)]
    errs = [rel_err(a, b) for a, b in zip(answers, in_process)]
    cpu_errs = [rel_err(answers[i], want) for i, want in zip((0, 3), on_cpu)]
    cpu_err = max(cpu_errs)
    print("serving checks", json.dumps({
        "rel_err_vs_in_process": errs,
        "rel_err_vs_cpu_plain": dict(zip(("s128", "s100"), cpu_errs)),
        "max_abs_err_vs_cpu_plain": max(
            float(np.abs(answers[i] - want).max())
            for i, want in zip((0, 3), on_cpu))}), flush=True)
    for a, n in zip(answers, lengths):
        check(a.shape == (1, n, cfg.vocab_size),
              f"prediction shape {a.shape}")
        check(bool(np.isfinite(a).all()), "non-finite predictions")
    check(max(errs) <= LOGITS_REL_TOL, f"served != in-process: {errs}")
    check(cpu_err <= LOGITS_REL_TOL, f"served != CPU plain: {cpu_errs}")

    # Timing at the full context: B 8 x S 1024.
    big = rng.integers(0, cfg.vocab_size, (8, cfg.max_len),
                       dtype=np.int64).astype(np.int32)
    gpu_model = load_model(bundle, device=DEVICE)
    tokens = torch.from_numpy(big).to(DEVICE)
    with torch.inference_mode():
        forward, issue = cuda_windows(lambda: gpu_model(tokens), iters=5,
                                      windows=9)
    clocks = smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    t_host = []
    for _ in range(3):
        t0 = time.monotonic()
        out = served.predict(big)
        t_host.append((time.monotonic() - t0) * 1e3)
    check(out.shape == (8, cfg.max_len, cfg.vocab_size)
          and bool(np.isfinite(out).all()), "B8xS1024 predict")
    return {
        "model": "transformer flagship (bench_suite.py _TRANSFORMER_SIZES"
                 "['transformer']), random weights, seed 0",
        "requests": len(replies), "statuses": statuses,
        "batch_occupancy": {str(k): v for k, v in occupancy.items()},
        "flash_launches": launches, "batches": batches,
        "http_seconds": http_s,
        "rel_err_vs_in_process": max(errs),
        "rel_err_vs_cpu_plain": cpu_err,
        "predict_b8_s1024_forward_ms": spread(forward),
        "predict_b8_s1024_issue_ms": spread(issue),
        "clocks_after_forward": clocks,
        "predict_b8_s1024_host_ms": min(t_host),
    }


def bwd_bound(bh, sq, sk, d, dtype, causal, products, outputs,
              q_offset=0, k_offset=0):
    """Least time for one backward kernel on an H100: q, dO (BH, Sq, D),
    k, v (BH, Sk, D), lse and delta read once, ``outputs`` f32 gradients
    written once (dq: (BH, Sq, D); dk, dv: (BH, Sk, D)), over the memory
    rate; against ``products`` products over the pairs the mask leaves at
    these offsets, at the peak rate."""
    elt = 2 if dtype == "bfloat16" else 4
    rows = sq if outputs == 1 else sk
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * elt + 2 * bh * sq * 4 \
        + outputs * bh * rows * d * 4
    pairs = unmasked_pairs(sq, sk, q_offset, k_offset, causal)
    ops = 2 * products * bh * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def chunk_inputs(torch, rng, bh, sq, sk, d, dtype, causal, q_offset,
                 k_offset=0):
    """q, k, v, dO on the card and lse (the scores' logsumexp under the
    mask at these global offsets) and delta = rowsum(dO o o) as the
    forward would give them. A row that no key reaches has lse -1e30."""
    q, do = (torch.from_numpy(rng.standard_normal((bh, sq, d),
                                                  dtype=np.float32))
             .to("cuda", dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((bh, sk, d),
                                                 dtype=np.float32))
            .to("cuda", dtype) for _ in range(2))
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * d ** -0.5
    if causal:
        qpos = q_offset + torch.arange(sq, device="cuda")
        kpos = k_offset + torch.arange(sk, device="cuda")
        s = s.masked_fill(qpos[:, None] < kpos[None, :], -1e30)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = torch.matmul(p, v.float())
    delta = (do.float() * o).sum(dim=-1, keepdim=True)
    return q, k, v, do, lse.contiguous(), delta.contiguous()


# The backward kernels' cases: (name, bh, sq, sk, d, dtype, causal,
# q_offset, k_offset). The C entry points' outputs are filled with NaN
# before each launch, so a row left unstored shows. "beyond": keys
# 384-511 come after every query, so their k tiles meet no query and
# must store exact zeros; fewer than half the rows are zero, so that
# median |w|, elem's floor, is not 0. "before": keys start at 128, so
# the first 128 q rows (two q tiles) reach no key and their dq rows must
# be exact zeros, again fewer than half; at D 128 and 32, both dq
# routes. "future" is the ring's wholly future pair at sp 4: no query
# reaches any key, and dq, dk and dv must be exact zeros. Every gradient
# there is 0 (the plain version without its roundings too), so elem and
# L2 say nothing, and elem's floor would be 0: the case is held by its
# zeros alone. "ring_past" and "ring_diagonal" are the ring's local
# block at sp 4 (BH 4, 2048, D 128): a past chunk, every pair unmasked,
# and the diagonal chunk; they and "flagship" are timed. The bf16 D 64
# "ragged" case holds both wgmma kernels' D 64 instances. The cases draw
# their inputs in turn from one seeded generator, so new cases are
# appended: each earlier case keeps its inputs.
BWD_CASES = [
    ("flagship", 32, 1024, 1024, 128, "bfloat16", True, 0, 0),
    ("full", 32, 1024, 1024, 128, "bfloat16", False, 0, 0),
    ("flagship", 32, 1024, 1024, 128, "float32", True, 0, 0),
    ("ragged", 8, 100, 100, 128, "bfloat16", True, 0, 0),
    ("ragged", 8, 37, 37, 16, "bfloat16", False, 0, 0),
    ("ragged", 8, 130, 130, 32, "float32", True, 0, 0),
    ("ragged", 8, 200, 200, 64, "float32", False, 0, 0),
    ("chunk", 8, 512, 1024, 128, "bfloat16", True, 512, 0),
    ("twin", 64, 127, 127, 16, "bfloat16", True, 0, 0),
    ("beyond", 8, 384, 512, 128, "bfloat16", True, 0, 0),
    ("beyond", 8, 384, 512, 32, "bfloat16", True, 0, 0),
    ("beyond", 8, 384, 512, 64, "float32", True, 0, 0),
    ("ring_past", 4, 2048, 2048, 128, "bfloat16", True, 2048, 0),
    ("ring_diagonal", 4, 2048, 2048, 128, "bfloat16", True, 0, 0),
    ("ragged", 8, 200, 200, 64, "bfloat16", True, 0, 0),
    ("before", 8, 384, 256, 128, "bfloat16", True, 0, 128),
    ("before", 8, 384, 256, 32, "bfloat16", True, 0, 128),
    ("future", 4, 2048, 2048, 128, "bfloat16", True, 0, 2048),
]
BWD_TIMED = ("flagship", "ring_past", "ring_diagonal")


def bwd_launcher(fa, lib, args, outs, q_offset, causal, k_offset=0):
    """Launches of the dq and dk/dv kernels of ``lib`` through their C
    entry points (not counted), writing into ``outs`` = (dq, dk, dv)."""
    scale = args[0].shape[-1] ** -0.5

    def launch(name):
        targets = outs[:1] if name == "dq" else outs[1:]
        err = fa._bwd_launch(lib, name, args, targets, q_offset, k_offset,
                             causal, scale)
        check(err == 0, f"{name} launch: CUDA error {err}")

    return launch


def kernel_ptxas(log, prefix):
    """ptxas's lines about the kernels whose names start with ``prefix``
    in a build log: registers, spills and shared memory of each
    instance, and any warning that names one (C7512/C7518: wgmma
    serialized)."""
    lines = [f"{kernel}: {line}" for kernel, line in ptxas_lines(log)
             if kernel.startswith(prefix) and "Performance" not in line]
    lines += [line.strip() for line in log.splitlines()
              if prefix in line and ("warning" in line or "C75" in line)]
    return lines


def bwd_kernel_phase(torch, fa, check=check, timed=True):
    """The backward kernels against their plain version over BWD_CASES,
    through the wrapper every caller uses (flash_chunk_grads_cuda), and
    launched again through their C entry points into outputs filled with
    NaN (a row left unstored shows), which must equal the wrapper's bit
    for bit (the kernels sum in a fixed order); rows that no key or no
    query reaches must be exact zeros there. Then the dq kernels' ptxas
    lines and the device times. ``check`` may record instead of raise
    (tools/flash_bwd_mutants.py); each case's "ok" says whether it
    passed."""
    lib = fa._bwd_library()
    rng = np.random.default_rng(SEED + 10)
    checks, timing = [], {}
    for (name, bh, sq, sk, d, dtype_name, causal, q_offset,
         k_offset) in BWD_CASES:
        dtype = getattr(torch, dtype_name)
        args = chunk_inputs(torch, rng, bh, sq, sk, d, dtype, causal,
                            q_offset, k_offset)
        got = fa.flash_chunk_grads_cuda(*args, q_offset, k_offset, causal,
                                        d ** -0.5)
        raw = tuple(torch.full((bh, rows, d), float("nan"), device=DEVICE)
                    for rows in (sq, sk, sk))
        launch = bwd_launcher(fa, lib, args, raw, q_offset, causal,
                              k_offset)
        launch("dq")
        launch("dkv")
        torch.cuda.synchronize()
        want = fa.flash_chunk_grads_reference(*args, q_offset, k_offset,
                                              causal, d ** -0.5)
        zeros_only = name == "future"   # held by its zeros alone (above)
        unrounded = None
        if dtype_name == "bfloat16" and not zeros_only:
            # the same sums without the roundings
            unrounded = fa.flash_chunk_grads_reference(
                *(x.float() for x in args[:4]), *args[4:], q_offset,
                k_offset, causal, d ** -0.5)
        torch.cuda.synchronize()
        tol = BWD_TOL[dtype_name]
        res = {"case": name, "shape": [bh, sq, sk, d], "dtype": dtype_name,
               "causal": causal, "q_offset": q_offset,
               "k_offset": k_offset, "tol": tol,
               "c_entry_bit_equal": all(bool(torch.equal(g, r))
                                        for g, r in zip(got, raw))}
        ok = res["c_entry_bit_equal"]
        for i, (grad, g, w) in enumerate(zip(("dq", "dk", "dv"), got,
                                             want)):
            reading = grad_readings(g, w)
            res[f"{grad}_max_abs_err"] = reading["max_abs_err"]
            res[grad] = reading
            ok = ok and bool(torch.isfinite(g).all())
            if not zeros_only:
                ok = ok and within(reading, tol)
            if unrounded is not None:
                res[f"{grad}_unrounded"] = grad_readings(unrounded[i], w)
        if causal:
            # q rows before the first key reach none; keys after the last
            # query meet none: exact zeros in the NaN-filled launch.
            no_key = min(max(k_offset - q_offset, 0), sq)
            no_query = min(max(q_offset + sq - k_offset, 0), sk)
            if no_key:
                res["no_key_rows_zero"] = bool((raw[0][:, :no_key] == 0)
                                               .all())
                ok = ok and res["no_key_rows_zero"]
            if no_query < sk:
                res["beyond_zero"] = all(bool((g[:, no_query:] == 0).all())
                                         for g in raw[1:])
                ok = ok and res["beyond_zero"]
        if zeros_only:
            res["all_zero"] = all(bool((g == 0).all()) for g in got + raw)
            ok = ok and res["all_zero"]
        res["ok"] = ok
        print("bwd kernel check", json.dumps(res), flush=True)
        label = f"{name}/{dtype_name}/D{d}/Sq{sq}/Sk{sk}"
        check(ok, f"bwd kernel {label}: non-finite, outside tolerance or "
                  f"not zero where nothing is reached {res}")
        if unrounded is not None:
            for grad in ("dq", "dk", "dv"):
                check(not within(res[f"{grad}_unrounded"], tol),
                      f"bwd kernel {label}: {grad}'s unrounded plain "
                      f"version passes the limits, which could not see a "
                      f"rounding fault {res}")
        checks.append(res)
        if timed and name in BWD_TIMED and dtype_name == "bfloat16":
            timing[name] = (args, q_offset, causal)
    if not timed:
        return None, checks
    from elasticdl_tpu_torch.ops import _build

    ptxas = kernel_ptxas(_build.build_all([fa._BWD_SOURCE])[fa._BWD_SOURCE],
                         "flash_bwd_dq_")
    for line in ptxas:
        print(f"dq ptxas: {line}", flush=True)
    times = {name: bwd_times(torch, fa, lib, *value)
             for name, value in timing.items()}
    errs = {"dq": max(c["dq_max_abs_err"] for c in checks),
            "dkv": max(max(c["dk_max_abs_err"], c["dv_max_abs_err"])
                       for c in checks)}
    rows = []
    for name, replaces in (
            ("flash_attention_bwd_dq",
             "elasticdl_tpu/ops/flash_attention.py:493"),
            ("flash_attention_bwd_dkv",
             "elasticdl_tpu/ops/flash_attention.py:528")):
        kind = name.rsplit("_", 1)[1]
        flagship = times["flagship"]
        rows.append({
            "name": name, "route": "cuda",
            "source": "elasticdl_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": replaces, "shape": flagship["shape"],
            "dtype": "bfloat16", "causal": True, "max_abs_err": errs[kind],
            "ms": flagship[kind]["ms"],
            "ms_replays": flagship[kind]["ms_replays"],
            "ms_source": "CUDA graph of 50 launches, replayed, CUDA events",
            "plain_ms": flagship["plain_ms"],
            "plain_computes": "dq, dk and dv",
            "bound_ms": flagship[kind]["bound_ms"],
            "bound_by": flagship[kind]["bound_by"],
            "library_ms": flagship["library_ms"],
            "pair_ms": flagship["pair_ms"],
            "library_call": "SDPA's flash backward op (dq, dk and dv "
                            "together), device time the same way; "
                            "pair_ms: dq + dk/dv, the same function",
            "ring": {shape: {key: times[shape][kind][key]
                             for key in ("ms", "bound_ms", "bound_by")}
                     | {key: times[shape][key]
                        for key in ("library_ms", "library_causal",
                                    "pair_ms")}
                     for shape in ("ring_past", "ring_diagonal")},
        })
    rows[0]["ptxas"] = ptxas
    return rows, checks


def sdpa_backward(torch, q, k, v, do, causal, heads):
    """SDPA's flash backward op alone (no autograd), given its forward's
    saved outputs, on (B, H, S, D) views of the (BH, S, D) inputs."""
    b = q.shape[0] // heads
    q4, k4, v4, do4 = (x.view(b, heads, *x.shape[1:])
                       for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, causal, False, scale=scale)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]

    def backward():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, out, lse, cum_q, cum_k, max_q, max_k, 0.0,
            causal, seed, offset, scale=scale)

    return backward


def bwd_times(torch, fa, lib, args, q_offset, causal):
    """#3's and #4's device times (CUDA graphs of 50 launches through
    the C entry points: not counted), each beside its bound, and SDPA's
    backward op on the same work measured the same way (a past ring
    chunk, all pairs unmasked, against a non-causal SDPA backward); the
    plain version at the flagship shape."""
    q, k, v, do = args[:4]
    bh, sq, d = q.shape
    sk = k.shape[1]
    outs = tuple(torch.empty((bh, rows, d), device=DEVICE)
                 for rows in (sq, sk, sk))
    launch = bwd_launcher(fa, lib, args, outs, q_offset, causal)
    out = {"shape": [bh, sq, sk, d], "q_offset": q_offset}
    for kind, products, outputs in (("dq", 3, 1), ("dkv", 4, 2)):
        replays = graph_ms(torch, lambda: launch(kind))
        bound_ms, bound_by = bwd_bound(bh, sq, sk, d, "bfloat16", causal,
                                       products, outputs, q_offset)
        out[kind] = {"ms": float(np.median(replays)), "ms_replays": replays,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    out["pair_ms"] = out["dq"]["ms"] + out["dkv"]["ms"]
    # SDPA has no offsets: its causal mask is the diagonal chunk's, and a
    # chunk with every pair unmasked is its non-causal backward.
    lib_causal = causal and unmasked_pairs(sq, sk, q_offset, 0, True) \
        < sq * sk
    heads = FLAGSHIP["n_heads"]
    library = graph_ms(torch, sdpa_backward(torch, q, k, v, do, lib_causal,
                                            heads))
    out["library_ms"] = float(np.median(library))
    out["library_ms_replays"] = library
    out["library_causal"] = lib_causal
    if (bh, sq) == (32, 1024):
        out["plain_ms"] = cuda_ms(lambda: fa.flash_chunk_grads_reference(
            *args, q_offset, 0, causal, d ** -0.5), iters=5)
    return out


def bwd_autograd_phase(torch, fa):
    """Gradients through flash_attention: card (kernels) vs CPU (plain)."""
    rng = np.random.default_rng(SEED + 11)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 256, 4, 128),
                                                    dtype=np.float32))
               .to(torch.bfloat16) for _ in range(3))
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves)
        (out.float() * out.float().cos()).sum().backward()
        grads.append([x.grad.float().cpu() for x in leaves])
    torch.cuda.synchronize()
    readings = {name: grad_readings(g, w)
                for name, g, w in zip(("dq", "dk", "dv"), *grads)}
    print("bwd autograd check", json.dumps({
        "shape": [2, 256, 4, 128], "dtype": "bfloat16",
        "vs_cpu_plain": readings, "tol": GRAD_TOL}), flush=True)
    for name, reading in readings.items():
        check(within(reading, GRAD_TOL),
              f"flash_attention {name} vs CPU plain: {reading}")


def unmasked_pairs(sq, sk, q_offset, k_offset, causal):
    """The (query, key) pairs a chunk update must fold: keys at or before
    each query's global position when causal."""
    if not causal:
        return sq * sk
    rows = q_offset + np.arange(sq) - k_offset + 1
    return int(np.clip(rows, 0, sk).sum())


def chunk_bound(bh, sq, sk, d, dtype, causal, q_offset, k_offset):
    """Least time for one chunk update on an H100: q, k, v read once,
    the f32 carry (m, l, acc) read and written once, over the memory
    rate; against both products over this chunk's unmasked pairs at the
    peak rate."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (bh * sq * d + 2 * bh * sk * d) * elt \
        + 2 * (2 * bh * sq + bh * sq * d) * 4
    ops = 2 * 2 * bh * unmasked_pairs(sq, sk, q_offset, k_offset,
                                      causal) * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def chunk_tiled_reference(fa, q, k, v, m, l, acc, q_offset, k_offset,
                          causal, scale, dtype=None):
    """The plain version folded in the kernel's own order: over the key
    tiles of the route that ``dtype`` (q's by default) takes, into one
    running state or, on the wgmma route, into two merged at the end."""
    d = q.shape[-1]
    dtype = dtype or q.dtype
    return fa.flash_chunk_update_reference(
        q, k, v, m, l, acc, q_offset, k_offset, causal, scale,
        block_k=fa.chunk_block_k(d, dtype),
        consumers=fa.chunk_consumers(d, dtype))


# (name, bh, sq, sk, d, dtype, causal, q_offset, k_offset, carry). The
# first two are the ring's local block at the slice's shape (BH 4, 2048,
# D 128): its diagonal chunk and a past chunk. bf16 D 64 and 128 take the
# wgmma kernel, bf16 D 16 and 32 the mma.sync one. Every case also
# launches through the C entry point into NaN-filled outputs and with the
# outputs aliasing the carry (a copy of it), which must equal the
# wrapper's launch bit for bit. The cases draw their inputs in turn from
# one seeded generator, so new cases are appended: each earlier case
# keeps its inputs.
CHUNK_CASES = [
    ("diagonal", 4, 2048, 2048, 128, "bfloat16", True, 2048, 2048,
     "initial"),
    ("past", 4, 2048, 2048, 128, "bfloat16", True, 4096, 0, "folded"),
    # Every key after every query; Sq is ragged so that the last q tile
    # is not skipped whole and its rows meet the mask.
    ("future", 4, 200, 256, 128, "bfloat16", True, 0, 200, "initial"),
    ("future", 4, 200, 256, 64, "float32", True, 0, 200, "folded"),
    # Rows 0-43 (global 256-299) see no key of the chunk (keys from 300).
    ("first_rows", 4, 256, 256, 64, "bfloat16", True, 256, 300, "initial"),
    ("first_rows", 4, 256, 256, 32, "float32", True, 256, 300, "initial"),
    ("full", 4, 256, 384, 16, "bfloat16", False, 0, 0, "initial"),
    ("full", 4, 256, 384, 64, "float32", False, 0, 0, "folded"),
    ("ragged", 4, 200, 333, 16, "bfloat16", True, 500, 100, "folded"),
    ("ragged", 4, 130, 37, 32, "bfloat16", True, 37, 0, "initial"),
    ("ragged", 4, 200, 333, 128, "float32", True, 300, 100, "initial"),
    ("diagonal", 4, 512, 512, 64, "float32", True, 512, 512, "folded"),
    ("diagonal", 4, 512, 512, 32, "bfloat16", True, 512, 512, "folded"),
    ("past", 4, 512, 512, 16, "float32", True, 1024, 0, "initial"),
    # The wgmma kernel's edges: one key tile (the second consumer has
    # none), an odd number of them, a ragged Sk (333) and Sq (200) across
    # the diagonal, rows that see no key, and the ring's chunks at D 64.
    ("one_tile", 4, 256, 64, 128, "bfloat16", True, 1024, 0, "folded"),
    ("odd_tiles", 4, 256, 320, 128, "bfloat16", True, 1024, 0, "folded"),
    ("ragged", 4, 200, 333, 128, "bfloat16", True, 300, 100, "folded"),
    ("first_rows", 4, 256, 256, 128, "bfloat16", True, 256, 300, "initial"),
    ("past", 4, 2048, 2048, 64, "bfloat16", True, 4096, 0, "folded"),
    ("diagonal", 4, 2048, 2048, 64, "bfloat16", True, 2048, 2048,
     "initial"),
    # Rows that see no key on the mma.sync route (D 64 went to wgmma).
    ("first_rows", 4, 256, 256, 32, "bfloat16", True, 256, 300, "initial"),
]
# Timed: the ring's chunks (BH 4 x 2048 x 2048) at D 128 and 64.
CHUNK_TIMED = ("past", "diagonal")


def chunk_kernel_phase(torch, fa, check=check, timed=True):
    """Kernel #2 against its plain version on the card over CHUNK_CASES,
    through the wrapper every caller uses (flash_chunk_update_cuda), and
    launched again through its C entry point into outputs filled with
    NaN (a row left unstored shows) and with the outputs aliasing a copy
    of the carry: both must equal the wrapper's bit for bit (the kernel
    sums in a fixed order). Then its ptxas lines and its times at the
    slice's shape. ``check`` may record instead of raise
    (tools/chunk_kernel_mutants.py); each case's "ok" says whether it
    passed."""
    lib = fa._chunk_library()
    rng = np.random.default_rng(SEED + 50)
    checks = []
    timing = {}
    for (name, bh, sq, sk, d, dtype_name, causal, q_off, k_off,
         carry) in CHUNK_CASES:
        dtype = getattr(torch, dtype_name)

        def randn(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(DEVICE, dtype)

        q, k, v = randn(bh, sq, d), randn(bh, sk, d), randn(bh, sk, d)
        scale = d ** -0.5
        state = (torch.full((bh, sq, 1), -1e30, device=DEVICE),
                 torch.zeros((bh, sq, 1), device=DEVICE),
                 torch.zeros((bh, sq, d), device=DEVICE))
        if carry == "folded":   # the carry an earlier (past) chunk leaves
            state = fa.flash_chunk_update_reference(
                q, randn(bh, 256, d), randn(bh, 256, d), *state, q_off,
                -256, False, scale)
        got = fa.flash_chunk_update_cuda(q, k, v, *state, q_off, k_off,
                                         causal, scale)
        raw = tuple(torch.full_like(t, float("nan")) for t in state)
        aliased = tuple(t.clone() for t in state)
        for carry_in, outs in ((state, raw), (aliased, aliased)):
            err = fa._chunk_launch(lib, (q, k, v, *carry_in), outs, q_off,
                                   k_off, causal, scale)
            check(err == 0, f"chunk launch: CUDA error {err}")
        torch.cuda.synchronize()
        want = chunk_tiled_reference(fa, q, k, v, *state, q_off, k_off,
                                     causal, scale)
        whole = fa.flash_chunk_update_reference(q, k, v, *state, q_off,
                                                k_off, causal, scale)
        pairs = unmasked_pairs(sq, sk, q_off, k_off, causal)
        unrounded = None
        if dtype_name == "bfloat16" and pairs:
            unrounded = chunk_tiled_reference(
                fa, q.float(), k.float(), v.float(), *state, q_off, k_off,
                causal, scale, dtype)
        torch.cuda.synchronize()
        tol = CHUNK_TOL[dtype_name]
        res = {"case": name, "shape": [bh, sq, sk, d], "dtype": dtype_name,
               "causal": causal, "q_offset": q_off, "k_offset": k_off,
               "carry": carry, "pairs": pairs, "tol": tol,
               "whole_tol": CHUNK_WHOLE_TOL[dtype_name],
               "consumers": fa.chunk_consumers(d, dtype),
               "c_entry_bit_equal": all(bool(torch.equal(g, r))
                                        for g, r in zip(got, raw)),
               "aliased_bit_equal": all(bool(torch.equal(g, a))
                                        for g, a in zip(got, aliased))}
        ok = res["c_entry_bit_equal"] and res["aliased_bit_equal"]
        for i, out in enumerate(("m", "l", "acc")):
            res[out] = grad_readings(got[i], want[i])
            res[f"{out}_whole"] = grad_readings(got[i], whole[i])
            ok = ok and bool(torch.isfinite(got[i]).all()) \
                and within(res[out], tol) \
                and within(res[f"{out}_whole"],
                           CHUNK_WHOLE_TOL[dtype_name])
        if unrounded is not None:
            res["acc_unrounded"] = grad_readings(unrounded[2], want[2])
        if not pairs:          # nothing to fold: the carry comes back
            res["carry_unchanged"] = all(torch.equal(g, s)
                                         for g, s in zip(got, state))
            ok = ok and res["carry_unchanged"]
        res["ok"] = ok
        print("chunk kernel check", json.dumps(res), flush=True)
        label = f"{name}/{dtype_name}/D{d}/{carry}"
        check(ok, f"chunk kernel {label} outside tolerance or not "
                  f"bit-equal {res}")
        if unrounded is not None:
            check(not within(res["acc_unrounded"], tol),
                  f"chunk kernel {label}: the unrounded plain version "
                  f"passes the limits, which could not see a rounding "
                  f"fault {res}")
        checks.append(res)
        if timed and name in CHUNK_TIMED and (bh, sq, sk) == (4, 2048, 2048):
            timing[f"{name}_d{d}"] = (q, k, v, state, q_off, k_off, causal,
                                      scale)
    if not timed:
        return None, checks
    from elasticdl_tpu_torch.ops import _build

    ptxas = kernel_ptxas(
        _build.build_all([fa._CHUNK_SOURCE])[fa._CHUNK_SOURCE],
        "flash_chunk_")
    for line in ptxas:
        print(f"chunk ptxas: {line}", flush=True)
    row = chunk_times(torch, fa, lib, timing, checks)
    row["ptxas"] = ptxas
    return row, checks


def sdpa_forward(torch, q, k, v, causal, heads):
    """SDPA's flash forward op with its logsumexp on (B, H, S, D) views
    of (BH, S, D) inputs: the chunk's two products and softmax without
    the carry, a yardstick for #2."""
    b = q.shape[0] // heads
    q4, k4, v4 = (x.view(b, heads, *x.shape[1:]) for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        q4, k4, v4, 0.0, causal, False, scale=scale)


def chunk_times(torch, fa, lib, timing, checks):
    """Kernel #2 at the slice's shape (past and diagonal chunks, D 128 and
    64) through its C entry point (these launches are not counted):
    device ms from a CUDA graph of 50 launches, beside the event windows
    of 50 calls and the host's issue time, the plain version, the bound
    and the yardstick (SDPA's forward over the same chunk: non-causal for
    a past chunk, causal for the diagonal)."""
    out = {}
    for key, (q, k, v, state, q_off, k_off, causal, scale) in \
            timing.items():
        bh, sq, d = q.shape
        outs = [torch.empty_like(t) for t in state]

        def launch():
            err = fa._chunk_launch(lib, (q, k, v, *state), outs, q_off,
                                   k_off, causal, scale)
            check(err == 0, f"chunk launch: CUDA error {err}")

        replays = graph_ms(torch, launch)
        window_ms, issue_ms = cuda_windows(launch, 50, 5)
        bound_ms, bound_by = chunk_bound(bh, sq, k.shape[1], d, "bfloat16",
                                         causal, q_off, k_off)
        lib_causal = causal and q_off == k_off
        yardstick = graph_ms(torch, sdpa_forward(
            torch, q, k, v, lib_causal, FLAGSHIP["n_heads"]))
        out[key] = {
            "shape": [bh, sq, k.shape[1], d], "q_offset": q_off,
            "k_offset": k_off,
            "ms": float(np.median(replays)), "ms_replays": replays,
            "window_ms": float(np.median(window_ms)),
            "issue_ms": float(np.median(issue_ms)),
            "plain_ms": cuda_ms(lambda: fa.flash_chunk_update_reference(
                q, k, v, *state, q_off, k_off, causal, scale), iters=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "yardstick_ms": float(np.median(yardstick)),
            "yardstick_causal": lib_causal,
            "pairs": unmasked_pairs(sq, k.shape[1], q_off, k_off, causal),
        }
    past = out["past_d128"]
    return {
        "name": "flash_chunk_update", "route": "cuda",
        "source": "elasticdl_tpu_torch/ops/csrc/flash_chunk_update.cu",
        "replaces": "elasticdl_tpu/ops/flash_attention.py:277",
        "shape": past["shape"], "dtype": "bfloat16",
        "chunk": "past (the ring's step t > 0), folded carry",
        "max_abs_err": max(max(c[o]["max_abs_err"] for o in ("m", "l",
                                                            "acc"))
                           for c in checks),
        "ms": past["ms"], "ms_replays": past["ms_replays"],
        "ms_source": "CUDA graph of 50 launches, replayed, CUDA events",
        "window_ms": past["window_ms"], "issue_ms": past["issue_ms"],
        "plain_ms": past["plain_ms"],
        "bound_ms": past["bound_ms"], "bound_by": past["bound_by"],
        "library_ms": None,
        "library_call": "none: no PyTorch call carries (m, l, acc)",
        "yardstick_ms": past["yardstick_ms"],
        "yardstick": "SDPA's flash forward with logsumexp over the same "
                     "chunk (non-causal past, causal diagonal), device "
                     "time the same way: the chunk's products without "
                     "the carry fold, not the same function",
        "chunks": out,
    }


def ring_mesh(torch, sp=RING_SP, device=None):
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((sp,), ("sp",), [torch.device(device or DEVICE)] * sp)


def ring_check_phase(torch, fa, ra, check=check, timed=True):
    """ring_attention on an sp mesh of the card against kernel #1 (and
    #3/#4) over the whole sequence, output and gradients, at the slice's
    shape and the flagship's; f32 against the CPU plain ring; then the
    whole ring forward timed beside #1 and SDPA. ``check`` may record
    instead of raise (tools/chunk_kernel_mutants.py)."""
    mesh = ring_mesh(torch)
    rng = np.random.default_rng(SEED + 60)
    checks = []
    for b, s, dtype_name in ((1, RING_SEQ, "bfloat16"),
                             (8, 1024, "bfloat16"), (1, 512, "float32")):
        d = 128 if dtype_name == "bfloat16" else 64
        arrays = [rng.standard_normal((b, s, 4, d), dtype=np.float32)
                  for _ in range(4)]
        dtype = getattr(torch, dtype_name)
        runs = {}
        for label in ("ring", "flash" if dtype_name == "bfloat16"
                      else "cpu_ring"):
            dev = "cpu" if label == "cpu_ring" else DEVICE
            leaves = [torch.from_numpy(x).to(dev, dtype).requires_grad_()
                      for x in arrays[:3]]
            do = torch.from_numpy(arrays[3]).to(dev, dtype)
            before = (fa.chunk_launches, fa.dq_launches, fa.launches)
            if label == "flash":
                out = fa.flash_attention(*leaves)
            else:
                out = ra.ring_attention(
                    *leaves, mesh if dev == DEVICE else ring_mesh(
                        torch, device="cpu"))
            out.backward(do)
            torch.cuda.synchronize()
            runs[label] = [out.detach().float().cpu()] + [
                x.grad.float().cpu() for x in leaves]
            runs[label + "_launches"] = (fa.chunk_launches - before[0],
                                         fa.dq_launches - before[1],
                                         fa.launches - before[2])
        ref = "flash" if dtype_name == "bfloat16" else "cpu_ring"
        tol = RING_TOL[dtype_name]
        res = {"shape": [b, s, 4, d], "dtype": dtype_name, "sp": RING_SP,
               "against": ref, "tol": tol,
               "ring_launches": runs["ring_launches"]}
        for i, name in enumerate(("out", "dq", "dk", "dv")):
            res[name] = grad_readings(runs["ring"][i], runs[ref][i])
        print("ring check", json.dumps(res), flush=True)
        check(runs["ring_launches"] == (RING_SP ** 2, RING_SP ** 2, 0),
              f"ring launches (chunk, dq, fwd) {runs['ring_launches']}: "
              f"{RING_SP ** 2} chunk updates and dq kernels a ring")
        for name in ("out", "dq", "dk", "dv"):
            check(within(res[name], tol), f"ring {name} vs {ref}: {res}")
        checks.append(res)
    if not timed:
        return checks, None

    # The whole forward at S 8192: the ring against #1 and SDPA.
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, RING_SEQ, 4, 128), dtype=np.float32)).to(DEVICE, torch.bfloat16)
        for _ in range(3))
    q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
    with torch.inference_mode():
        times = {
            "ring_forward_ms": cuda_ms(
                lambda: ra.ring_attention(q, k, v, mesh), iters=5),
            "flash_forward_ms": cuda_ms(
                lambda: fa.flash_attention(q, k, v), iters=10),
            "sdpa_ms": cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), iters=10),
        }
    times["bound_ms"], times["bound_by"] = flash_bound(4, RING_SEQ, 128,
                                                       "bfloat16", True)
    times["shape"] = [1, RING_SEQ, 4, 128]
    print("ring forward times", json.dumps(times), flush=True)
    return checks, times


def ring_training_phase(torch, fa):
    """The flagship at S 8192 with remat trained on the ring: MeshRunner
    on an sp mesh of the card, against the same steps through
    core.step.build_train_step (kernel #1) from the same weights and
    batches."""
    from elasticdl_tpu_torch import bridge
    from elasticdl_tpu_torch.core.step import build_train_step
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm
    from elasticdl_tpu_torch.models.transformer import TransformerConfig
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    cfg = TransformerConfig(**dict(FLAGSHIP, max_len=RING_SEQ), remat=True,
                            compute_dtype=torch.bfloat16)
    weights = bridge.state_dict_from_flax(
        bridge.init_flax_params(cfg, seed=SEED))
    rng = np.random.default_rng(SEED + 70)
    batches = []
    for _ in range(RING_TRAIN_STEPS + 1):    # the last one is evaluated
        start = rng.integers(0, cfg.vocab_size, (1, 1))
        seq = (start + np.arange(RING_SEQ + 1)[None]) % cfg.vocab_size
        batches.append({"features": seq[:, :-1].astype(np.int32),
                        "labels": seq[:, 1:].astype(np.int32),
                        "mask": np.ones(1, np.float32)})
    layers = cfg.n_layers
    runs = {}
    for label in ("ring", "single"):
        mesh = ring_mesh(torch) if label == "ring" else None
        model = transformer_lm.custom_model(config=cfg, device=DEVICE,
                                            mesh=mesh)
        model.load_state_dict(weights)
        if mesh is not None:
            runner = MeshRunner(mesh)
            state = runner.init_state(model, transformer_lm.optimizer(),
                                      batches[0], seed=SEED)
            step = runner.train_step(transformer_lm.loss)
            eval_step = runner.eval_step()
        else:
            state = init_train_state(model, transformer_lm.optimizer(),
                                     seed=SEED)
            step = build_train_step(transformer_lm.loss)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events, issue, losses = [], [], []
        fa.launches = fa.chunk_launches = 0     # the main path starts here
        fa.dq_launches = fa.dkv_launches = 0
        for batch in batches[:RING_TRAIN_STEPS]:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            state, metrics = step(state, batch)
            end.record()
            issue.append((time.perf_counter() - t0) * 1e3)
            events.append((start, end))
            losses.append(metrics["loss"])
        counts = {"flash_chunk_update": fa.chunk_launches,  # ... ends here
                  "flash_attention_bwd_dq": fa.dq_launches,
                  "flash_attention_bwd_dkv": fa.dkv_launches,
                  "flash_attention_fwd": fa.launches}
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        step_ms, issue_ms = [], []
        for i in range(2, RING_TRAIN_STEPS - 1, 2):
            step_ms.append(events[i][0].elapsed_time(events[i + 1][1]) / 2)
            issue_ms.append(float(np.mean(issue[i:i + 2])))
        run = {"losses": [float(x) for x in losses],
               "launches": counts, "step_ms": spread(step_ms),
               "issue_ms": spread(issue_ms),
               "tokens_per_s": RING_SEQ / (np.median(step_ms) / 1e3),
               "max_memory_allocated_bytes": peak,
               "params_finite": all(bool(torch.isfinite(p).all())
                                    for p in state.model.parameters())}
        if mesh is not None:
            fa.chunk_launches = fa.dq_launches = 0   # one eval batch
            logits = eval_step(state, batches[-1])
            run["eval_launches"] = {"flash_chunk_update": fa.chunk_launches,
                                    "flash_attention_bwd_dq":
                                        fa.dq_launches}
            run["eval_logits_finite"] = bool(torch.isfinite(logits).all())
            run["eval_shape"] = list(logits.shape)
        runs[label] = run
        del state, step, model
        torch.cuda.empty_cache()
    ring, single = runs["ring"], runs["single"]
    rel = [abs(a - b) / abs(b) for a, b in zip(ring["losses"],
                                               single["losses"])]
    out = {
        "model": "transformer flagship widths (bench_suite.py "
                 "_TRANSFORMER_SIZES['transformer']) at max_len "
                 f"{RING_SEQ}, remat on, dropout 0, random weights "
                 f"seed {SEED}, the twin's Adam 1e-3",
        "batch": 1, "seq": RING_SEQ, "sp": RING_SP,
        "steps": RING_TRAIN_STEPS, "ring": ring, "single_device": single,
        "loss_max_rel_diff": max(rel), "tol": RING_TRAIN_TOL,
        "clocks_after": smi("clocks.sm,clocks.max.sm,power.draw,"
                            "temperature.gpu"),
    }
    print("ring training", json.dumps(out), flush=True)
    per_pair = RING_TRAIN_STEPS * layers * RING_SP ** 2
    check(ring["launches"] == {"flash_chunk_update": 2 * per_pair,
                               "flash_attention_bwd_dq": per_pair,
                               "flash_attention_bwd_dkv": per_pair,
                               "flash_attention_fwd": 0},
          f"ring launches {ring['launches']} in {RING_TRAIN_STEPS} steps: "
          f"{2 * per_pair} chunk updates (remat recomputes the forward), "
          f"{per_pair} dq and dk/dv, no #1")
    check(ring["eval_launches"] == {
        "flash_chunk_update": layers * RING_SP ** 2,
        "flash_attention_bwd_dq": 0},
        f"ring eval launches {ring['eval_launches']}")
    check(single["launches"]["flash_attention_fwd"]
          == 2 * RING_TRAIN_STEPS * layers
          and single["launches"]["flash_chunk_update"] == 0,
          f"single-device launches {single['launches']}")
    check(ring["eval_logits_finite"] and ring["eval_shape"] == [
        1, RING_SEQ, cfg.vocab_size], f"ring eval logits {ring}")
    for run in (ring, single):
        check(run["params_finite"] and all(np.isfinite(run["losses"])),
              "non-finite parameters or losses")
    check(max(rel) <= RING_TRAIN_TOL["loss"],
          f"ring vs single-device losses: {rel}")
    return out


def path_ids(rng, vocab, batch, num_ids):
    """A recsys batch's ids and their ``unique_pad`` (sorted distinct ids
    padded with the vocab size to batch x num_ids), as numpy."""
    ids = rng.integers(0, vocab, (batch, num_ids)).astype(np.int32)
    uniq = np.unique(ids)
    pads = np.full(ids.size - uniq.size, vocab, np.int32)
    return ids, np.concatenate([uniq, pads]).astype(np.int32)


def uniform_table(torch, vocab, dim, scale, gen):
    return torch.empty(vocab, dim, device="cuda").uniform_(
        -scale, scale, generator=gen)


def emb_within(reading, tol):
    return (np.isfinite(reading["max_abs_err"]) and within(reading, tol))


# Cases of lookup_checks: (vocab, dim, batch, num_ids, combiner, weights,
# table). The first eight draw from the phase's generators; the rest,
# appended to reach kernel #5's ring and grid, from their own (SEED + 21),
# so the earlier cases' inputs and the row checks' after them stay as
# they were: ids outside the table late in L 96 (past the ring's 32
# slots, so they land on reused slots), B 1 and B 64 at D 256 (rows split
# into column strips), D 4 (one 16-byte strip) and a table viewed at a
# 4-byte offset (#5's 4-byte instance).
LOOKUP_CASES = [
    (EMB_VOCAB, EMB_DIM, EMB_BATCH, EMB_IDS, "sum", "ones", "plain"),
    (4096, 16, 37, 5, "mean", "zero_rows", "plain"),
    (4096, 128, 37, 9, "sqrtn", "zero_rows", "plain"),
    (4096, 256, 37, 32, "sqrtn", "random", "plain"),
    (4096, 512, 64, 64, "sum", "random", "plain"),
    (4096, 130, 37, 7, "mean", "zero_rows", "plain"),     # D % 4 != 0
    (4096, 2000, 9, 3, "sqrtn", "random", "plain"),       # two column tiles
    (4096, 64, 16, 6, "mean", "out_of_range", "plain"),
]
LOOKUP_CASES_LATER = [
    (4096, 256, 37, 96, "mean", "late_out_of_range", "plain"),
    (4096, 256, 1, 32, "sqrtn", "random", "plain"),
    (4096, 256, 64, 32, "sum", "random", "plain"),
    (4096, 4, 37, 40, "mean", "zero_rows", "plain"),
    (4096, 256, 37, 32, "sqrtn", "random", "offset4"),
]


def lookup_case_inputs(torch, rng, gen, case, tables):
    """A case's table (kept in ``tables`` while the next case shares its
    shape), ids and weights on the card."""
    vocab, dim, batch, num_ids, _, kind, layout = case
    key = (vocab, dim, layout)
    if key not in tables:
        tables.clear()
        if layout == "offset4":      # a view 4 bytes into its storage
            flat = torch.empty(vocab * dim + 1, device="cuda").uniform_(
                -dim ** -0.5, dim ** -0.5, generator=gen)
            tables[key] = flat[1:].view(vocab, dim)
        else:
            tables[key] = uniform_table(torch, vocab, dim, dim ** -0.5, gen)
    ids = rng.integers(0, vocab, (batch, num_ids)).astype(np.int32)
    w = (np.ones((batch, num_ids), np.float32) if kind == "ones"
         else rng.random((batch, num_ids), dtype=np.float32))
    if kind == "zero_rows":
        w[::3] = 0.0
        w[1, num_ids // 2:] = 0.0
    if kind == "out_of_range":
        ids[::2, 0] = vocab
        ids[1::2, -1] = -1
    if kind == "late_out_of_range":
        ids[::2, 70] = vocab
        ids[1::2, 90] = -1
        ids[::5, -1] = vocab
    return (tables[key], torch.from_numpy(ids).cuda(),
            torch.from_numpy(w).cuda())


def lookup_checks(torch, pe, rng, gen, check=check):
    """Both lookup kernels against the plain version (``LOOKUP_CASES``
    and ``LOOKUP_CASES_LATER``): the recsys step's shape and the edge
    cases. Each kernel launches through its wrapper and again through
    its C entry point into an output filled with NaN, which must equal
    the wrapper's bit for bit (a strip left unstored shows); #5's lines
    name its instance and ring (``pe.aligned_plan``)."""
    lib = pe._lookup_library()
    checks = []
    tables = {}
    later = (np.random.default_rng(SEED + 21),
             torch.Generator(device="cuda").manual_seed(SEED + 21))
    for case in LOOKUP_CASES + LOOKUP_CASES_LATER:
        vocab, dim, batch, num_ids, combiner, kind, layout = case
        draw = (rng, gen) if case in LOOKUP_CASES else later
        table, ids_t, w_t = lookup_case_inputs(torch, *draw, case, tables)
        want = pe.lookup_combine_reference(table, ids_t, w_t, combiner)
        for name, fn in (("lookup_combine", pe.lookup_combine_pallas),
                         ("lookup_combine_aligned",
                          pe.lookup_combine_aligned)):
            aligned = name == "lookup_combine_aligned"
            got = fn(table, ids_t, w_t, combiner)
            nan_out = torch.full_like(got, float("nan"))
            err = pe._lookup_launch(lib, aligned, table, ids_t, w_t,
                                    nan_out, combiner)
            check(err == 0, f"{name} C entry: CUDA error {err}")
            torch.cuda.synchronize()
            reading = grad_readings(got, want)
            res = {"kernel": name, "vocab": vocab, "dim": dim,
                   "batch": batch, "num_ids": num_ids,
                   "combiner": combiner, "weights": kind,
                   "table_layout": layout,
                   **reading, "tol": EMB_TOL["lookup"],
                   "c_entry_bit_equal": torch.equal(
                       nan_out.view(torch.int32), got.view(torch.int32))}
            if aligned:
                res["plan"] = pe.aligned_plan(table, ids_t, got)
            res["ok"] = (bool(torch.isfinite(got).all())
                         and emb_within(reading, EMB_TOL["lookup"])
                         and res["c_entry_bit_equal"])
            print("embedding kernel check", json.dumps(res), flush=True)
            check(bool(torch.isfinite(got).all()), f"non-finite {res}")
            check(emb_within(reading, EMB_TOL["lookup"]),
                  f"{name} outside tolerance {res}")
            check(res["c_entry_bit_equal"],
                  f"{name}: the C entry's launch differs {res}")
            checks.append(res)
    try:
        pe.lookup_combine_aligned(table[:4095], ids_t, w_t, "mean")
        check(False, "aligned lookup took a vocab that is not a multiple "
                     "of 8")
    except ValueError:
        pass
    return checks


RULE_HYPER = {
    "sgd": dict(lr=0.05),
    "momentum": dict(lr=0.05, momentum=0.9),
    "adagrad": dict(lr=0.05, eps=1e-8),
    "adam": dict(lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8),
    "amsgrad": dict(lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8),
}


def rule_slots(torch, rule, vocab, dim, gen, tiny):
    """The rule's slot tables as an optimizer would leave them after a
    few steps (``tiny``: zeros, so that eps matters)."""
    from elasticdl_tpu_torch.ops.pallas_embedding import RULE_SLOTS

    n_slots = RULE_SLOTS[rule]
    if tiny or rule == "sgd":
        return [torch.zeros(vocab, dim, device="cuda")
                for _ in range(n_slots)]
    if rule == "adagrad":
        return [torch.full((vocab, dim), 0.1, device="cuda")]
    return [uniform_table(torch, vocab, dim, 0.01, gen).abs_()
            for _ in range(n_slots)]


def row_update_checks(torch, pe, rng, gen):
    """Kernels #7 (every rule) and #8 (SGD, momentum) against the plain
    version: the recsys step's shape (1M x 256, a batch's unique ids
    padded with the vocab size), odd n and widths 16 and 130, Adam at
    steps 1 and 7, Nesterov on and off, and cases where eps matters
    (zero slots, gradients of 1e-8). Pads carry nonzero gradients; every
    row a pad or nobody names, and its slots, must stay bit-equal."""
    cases = []   # (kernel, rule, vocab, dim, n, step, nesterov, tiny)
    for rule in ("sgd", "momentum", "adagrad", "adam", "amsgrad"):
        cases.append(("row_update", rule, EMB_VOCAB, EMB_DIM, None, 1,
                      False, False))
        cases.append(("row_update", rule, 4096, 16, 37, 1, False, False))
        cases.append(("row_update", rule, 4096, 130, 37, 7, True, False))
    cases += [
        ("row_update", "adam", EMB_VOCAB, EMB_DIM, None, 7, False, False),
        ("row_update", "momentum", EMB_VOCAB, EMB_DIM, None, 1, True,
         False),
        ("row_update", "adagrad", 4096, 256, 37, 1, False, True),
        ("row_update", "adam", 4096, 256, 37, 1, False, True),
        ("row_update", "amsgrad", 4096, 256, 37, 7, False, True),
        ("fused_row_update", "sgd", EMB_VOCAB, EMB_DIM, None, 1, False,
         False),
        ("fused_row_update", "momentum", EMB_VOCAB, EMB_DIM, None, 1,
         False, False),
        ("fused_row_update", "momentum", EMB_VOCAB, EMB_DIM, None, 1,
         True, False),
        ("fused_row_update", "sgd", 4096, 16, 37, 1, False, False),
        ("fused_row_update", "momentum", 4096, 130, 37, 1, True, False),
    ]
    checks = []
    for kernel, rule, vocab, dim, n, step, nesterov, tiny in cases:
        if n is None:     # the path's layout: sorted ids, trailing pads
            _, uids = path_ids(rng, vocab - 1, EMB_BATCH, EMB_IDS)
            uids[uids == vocab - 1] = vocab
        else:             # shuffled, with pads among the ids
            real = rng.choice(vocab - 1, n - 5, replace=False)
            uids = rng.permutation(np.concatenate(
                [real, np.full(5, vocab)])).astype(np.int32)
        grads = rng.standard_normal((uids.size, dim), dtype=np.float32)
        if tiny:
            grads *= 1e-8
        before = [uniform_table(torch, vocab, dim, dim ** -0.5, gen)] + \
            rule_slots(torch, rule, vocab, dim, gen, tiny)
        ids_t = torch.from_numpy(uids).cuda()
        g_t = torch.from_numpy(grads).cuda()
        hyper = dict(RULE_HYPER[rule], nesterov=nesterov)
        got = [t.clone() for t in before]
        pe.row_update(rule, ids_t, g_t, got, fused=kernel != "row_update",
                      step=step, **hyper)
        want = [t.clone() for t in before]
        pe.row_update_reference(
            rule, ids_t, g_t, want,
            bc=pe.bias_corrections(hyper.get("beta1", 0.0),
                                   hyper.get("beta2", 0.0), step), **hyper)
        torch.cuda.synchronize()
        rows = ids_t[ids_t < vocab].long()
        untouched = torch.ones(vocab, dtype=torch.bool, device="cuda")
        untouched[rows] = False
        res = {"kernel": kernel, "rule": rule, "vocab": vocab, "dim": dim,
               "n": int(uids.size), "rows": int(rows.numel()), "step": step,
               "nesterov": nesterov, "eps_matters": tiny,
               "tol": EMB_TOL["rows"]}
        same = True
        for name, g, w, b in zip(("table", "slot0", "slot1", "slot2"), got,
                                 want, before):
            reading = grad_readings(g[rows] - b[rows], w[rows] - b[rows])
            res[name] = reading
            same = same and torch.equal(g[untouched], b[untouched])
        res["untouched_bit_equal"] = bool(same)
        print("embedding kernel check", json.dumps(res), flush=True)
        check(same, f"{kernel} {rule}: a pad or untouched row changed")
        for name in ("table", "slot0", "slot1", "slot2")[:len(got)]:
            check(emb_within(res[name], EMB_TOL["rows"]),
                  f"{kernel} {rule} {name} outside tolerance {res}")
        checks.append(res)
        del before, got, want
    return checks


def embedding_kernel_phase(torch, pe):
    """Every embedding kernel and rule against its plain version on the
    card (no timing)."""
    rng = np.random.default_rng(SEED + 20)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    return (lookup_checks(torch, pe, rng, gen)
            + row_update_checks(torch, pe, rng, gen))


def table_snapshot(torch):
    """A Callback that keeps a copy of every sparse table (on its device)
    as it stands before the first train step."""
    from elasticdl_tpu_torch.callbacks import Callback

    class TableSnapshot(Callback):
        initial = None

        def on_train_batch_begin(self, owner=None):
            if self.initial is None:
                self.initial = {name: t.clone()
                                for name, t in owner.state.tables.items()}

    return TableSnapshot()


def frappe_ids(num_records, input_length, max_id, seed):
    """The ids ``create_frappe_record_file`` writes for these arguments."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, max_id, size=(input_length,))
                     for _ in range(num_records)])


def touched_rows(torch, ids, vocab):
    mask = torch.zeros(vocab, dtype=torch.bool, device="cuda")
    mask[torch.from_numpy(np.unique(ids)).cuda()] = True
    return mask


def window_ms(record, warm, window):
    """Step ms over windows of ``window`` steps after ``warm`` (CUDA
    events) and the host's ms to issue each window's steps."""
    step_ms, issue_ms = [], []
    for i in range(warm, len(record.events) - window + 1, window):
        step_ms.append(record.events[i][0].elapsed_time(
            record.events[i + window - 1][1]) / window)
        issue_ms.append(float(np.mean(record.issue_ms[i:i + window])))
    return step_ms, issue_ms


def write_zoo(root, name, source):
    zoo = os.path.join(root, "zoo")
    os.makedirs(os.path.join(zoo, name), exist_ok=True)
    with open(os.path.join(zoo, name, "rec.py"), "w") as f:
        f.write(source)
    return zoo


def sparse_training_phase(torch, pe, root):
    """The recsys twin at full width through LocalExecutor, its zoo
    module pinning the kernels (use_pallas="always"), then the same run
    on the library route ("never") from the same seed."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    train = tdata.create_frappe_record_file(
        os.path.join(root, "recsys_train.rec"), SPARSE_RECORDS, seed=SEED,
        input_length=EMB_IDS, max_id=EMB_VOCAB)
    evalf = tdata.create_frappe_record_file(
        os.path.join(root, "recsys_eval.rec"), SPARSE_EVAL_RECORDS,
        seed=SEED + 1, input_length=EMB_IDS, max_id=EMB_VOCAB)
    runs = {}
    for mode in ("always", "never"):
        zoo = write_zoo(root, f"recsys_{mode}", RECSYS_ZOO.format(mode=mode))
        args = tdata.make_local_args(
            zoo, f"recsys_{mode}.rec.custom_model", train,
            validation_data=evalf, minibatch_size=EMB_BATCH,
            num_epochs=SPARSE_EPOCHS, extra=["--random_seed", str(SEED)])
        record, snap = step_recorder(torch), table_snapshot(torch)
        executor = LocalExecutor(args, callbacks=[record, snap])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pe.reset_launches()                   # the main path starts here
        result = executor.run()
        counts = {"lookup_combine": pe.lookup_launches,   # ... and ends
                  "lookup_combine_aligned": pe.aligned_launches,
                  "row_update": pe.row_update_launches,
                  "row_update_adagrad":
                      pe.row_update_rule_launches["adagrad"],
                  "fused_row_update": pe.fused_launches}
        state = executor.state
        runs[mode] = dict(
            result=result, counts=counts, record=record,
            peak=torch.cuda.max_memory_allocated(),
            initial=snap.initial[RECSYS_TABLE],
            final=state.tables[RECSYS_TABLE],
            accumulator=state.slot_tables[RECSYS_TABLE]["accumulator"])
        del executor, state
    steps = runs["always"]["result"]["steps"]
    eval_batches = -(-SPARSE_EVAL_RECORDS // EMB_BATCH)
    touched = touched_rows(torch, frappe_ids(SPARSE_RECORDS, EMB_IDS,
                                             EMB_VOCAB, SEED), EMB_VOCAB)
    untouched = ~touched
    losses = {m: [float(x) for x in r["record"].loss]
              for m, r in runs.items()}
    per_epoch = steps // SPARSE_EPOCHS
    epoch_loss = [float(np.mean(losses["always"][i:i + per_epoch]))
                  for i in range(0, steps, per_epoch)]
    a, n = runs["always"], runs["never"]
    delta_a = (a["final"][touched] - a["initial"][touched]).cpu().numpy()
    delta_n = (n["final"][touched] - n["initial"][touched]).cpu().numpy()
    acc_a = a["accumulator"][touched].cpu().numpy()
    acc_n = n["accumulator"][touched].cpu().numpy()
    untouched_equal = {m: bool(
        torch.equal(r["final"][untouched], r["initial"][untouched])
        and bool((r["accumulator"][untouched] == 0.1).all()))
        for m, r in runs.items()}
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(losses["always"],
                                                       losses["never"]))
    step_ms, issue_ms = window_ms(a["record"], warm=per_epoch,
                                  window=per_epoch)
    median = float(np.median(step_ms))
    out = {
        "model": "recsys ranker twin (model_zoo/recsys/recsys_sparse.py: "
                 "1,000,000 x 256 f32 table, 32 ids an example, Adagrad "
                 "rows lr 0.05, MLP 256-256-128-1 bf16, Adam 1e-3), "
                 f"random weights, seed {SEED}",
        "batch": EMB_BATCH, "steps": steps, "eval_batches": eval_batches,
        "launches": a["counts"], "launches_never": n["counts"],
        "losses_always": losses["always"], "losses_never": losses["never"],
        "epoch_mean_loss": epoch_loss,
        "loss_max_rel_diff": loss_rel,
        "table_delta_l2": rel_err(delta_a, delta_n),
        "table_delta_max_abs_err": float(np.abs(delta_a - delta_n).max()),
        "accumulator_l2": rel_err(acc_a, acc_n),
        "touched_rows": int(touched.sum()),
        "untouched_bit_equal": untouched_equal,
        "same_initial_table": bool(torch.equal(a["initial"], n["initial"])),
        "eval_accuracy": {m: r["result"]["eval_metrics"]["accuracy"]
                          for m, r in runs.items()},
        "step_ms": spread(step_ms), "issue_ms": spread(issue_ms),
        "examples_per_s": EMB_BATCH / (median / 1e3),
        "max_memory_allocated_bytes": a["peak"],
        "tol": SPARSE_TOL,
        "clocks_after": smi("clocks.sm,clocks.max.sm,power.draw,"
                            "temperature.gpu"),
    }
    print("sparse training", json.dumps(out), flush=True)
    check(steps == SPARSE_EPOCHS * SPARSE_RECORDS // EMB_BATCH,
          f"{steps} sparse steps")
    check(a["counts"]["lookup_combine"] == steps + eval_batches,
          f"lookup kernel launches {a['counts']} for {steps} steps and "
          f"{eval_batches} eval batches")
    check(a["counts"]["row_update"] == steps
          and a["counts"]["row_update_adagrad"] == steps,
          f"row kernel launches {a['counts']} for {steps} steps")
    check(not any(n["counts"].values()),
          f"the library route launched kernels: {n['counts']}")
    check(out["same_initial_table"], "the two runs start from other tables")
    check(all(untouched_equal.values()),
          f"an untouched row or accumulator moved: {untouched_equal}")
    check(all(np.isfinite(losses["always"])), "non-finite loss")
    check(epoch_loss[-1] < epoch_loss[0],
          f"the loss did not fall: {epoch_loss}")
    check(loss_rel <= SPARSE_TOL["loss"], f"losses always vs never {out}")
    check(out["table_delta_l2"] <= SPARSE_TOL["delta_l2"]
          and out["accumulator_l2"] <= SPARSE_TOL["delta_l2"],
          f"touched rows always vs never {out}")
    runs.clear()
    torch.cuda.empty_cache()
    return out


def small_twin_phase(torch, pe, root):
    """The twin at a small width (100,000 x 64), 5 Local steps with
    use_pallas="always" on the card and on the CPU (plain versions) from
    the same seed: losses, the changed rows and every dense parameter's
    change agree."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_frappe_record_file(
        os.path.join(root, "small.rec"), 5 * 256, seed=SEED + 2,
        input_length=EMB_IDS, max_id=SMALL_VOCAB)
    zoo = write_zoo(root, "small", SMALL_ZOO)
    runs = {}
    for dev in ("cuda", "cpu"):
        args = tdata.make_local_args(
            zoo, "small.rec.custom_model", records, minibatch_size=256,
            extra=["--device", dev, "--random_seed", str(SEED)])
        record, snap = step_recorder(torch), table_snapshot(torch)
        executor = LocalExecutor(args, callbacks=[record, snap])
        pe.reset_launches()
        executor.run()
        counts = (pe.lookup_launches, pe.row_update_launches)
        state = executor.state
        runs[dev] = dict(
            counts=counts, loss=[float(x) for x in record.loss],
            initial=record.initial,
            final={k: p.detach().float().cpu()
                   for k, p in state.model.named_parameters()},
            table0=snap.initial[RECSYS_TABLE].cpu(),
            table=state.tables[RECSYS_TABLE].cpu())
    card, cpu = runs["cuda"], runs["cpu"]
    rel = [abs(x - y) / abs(y) for x, y in zip(card["loss"], cpu["loss"])]
    delta_l2 = {k: rel_err((card["final"][k] - card["initial"][k]).numpy(),
                           (cpu["final"][k] - cpu["initial"][k]).numpy())
                for k in cpu["final"]}
    table_l2 = rel_err((card["table"] - card["table0"]).numpy(),
                       (cpu["table"] - cpu["table0"]).numpy())
    out = {"vocab": SMALL_VOCAB, "dim": SMALL_DIM, "steps": len(rel),
           "launches_card": card["counts"], "launches_cpu": cpu["counts"],
           "losses_card": card["loss"], "losses_cpu": cpu["loss"],
           "loss_max_rel_diff": max(rel), "table_delta_l2": table_l2,
           "param_delta_l2": delta_l2, "tol": SMALL_TOL}
    print("recsys twin card vs cpu", json.dumps(out), flush=True)
    check(len(rel) == 5, f"{len(rel)} small-twin steps")
    check(torch.equal(card["table0"], cpu["table0"]),
          "card and CPU start from other tables")
    check(card["counts"] == (5, 5) and cpu["counts"] == (0, 0),
          f"launches card {card['counts']} cpu {cpu['counts']}")
    check(max(rel) <= SMALL_TOL["loss"], f"card vs CPU losses {out}")
    check(table_l2 <= SMALL_TOL["delta_l2"]
          and max(delta_l2.values()) <= SMALL_TOL["delta_l2"],
          f"card vs CPU changes {out}")
    return out


def kernel_launch_counts(fa, pe):
    """Every kernel's launch counter, by its ``kernels`` row name."""
    return {"flash_attention_fwd": fa.launches,
            "flash_chunk_update": fa.chunk_launches,
            "flash_attention_bwd_dq": fa.dq_launches,
            "flash_attention_bwd_dkv": fa.dkv_launches,
            "lookup_combine": pe.lookup_launches,
            "lookup_combine_aligned": pe.aligned_launches,
            "row_update": pe.row_update_launches,
            "fused_row_update": pe.fused_launches}


def reset_kernel_launches(fa, pe):
    fa.launches = fa.dq_launches = fa.dkv_launches = fa.chunk_launches = 0
    pe.reset_launches()


def launches_since(fa, pe, before):
    """Each kernel's launches since ``before`` (a kernel_launch_counts
    reading)."""
    return {k: v - before[k] for k, v in kernel_launch_counts(fa, pe).items()}


def host_twin_run(torch, fa, pe, zoo, model_def, records, device, epochs):
    """One LocalExecutor run of a deepfm_host zoo module; kernel launch
    counts are zeroed just before it and read just after."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    args = tdata.make_local_args(
        zoo, model_def, records, minibatch_size=HOST_BATCH,
        num_epochs=epochs,
        extra=["--device", device, "--random_seed", str(SEED)])
    record = step_recorder(torch)
    executor = LocalExecutor(args, callbacks=[record])
    reset_kernel_launches(fa, pe)             # the host path starts here
    result = executor.run()
    counts = kernel_launch_counts(fa, pe)     # ... and ends
    return executor, record, result, counts


def host_training_phase(torch, fa, pe, root):
    """The deepfm_host twin through LocalExecutor: card against CPU with
    a synchronous runner (losses, touched rows, untouched rows, the
    native store), then the zoo's own runner on the card, timed, and
    against a synchronous runner on batches of disjoint ids; the host
    engine alone at the recsys shape, cold and warm; deepfm_functional
    card against CPU."""
    from elasticdl_tpu_torch import native
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.native.row_store import NativeEmbeddingTable
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_frappe_record_file(
        os.path.join(root, "host.rec"), HOST_RECORDS, seed=SEED,
        input_length=HOST_IDS, max_id=HOST_MAX_ID)
    zoo = write_zoo(root, "host_sync", HOST_ZOO)
    runs = {}
    for dev in ("cuda", "cpu"):
        executor, record, result, counts = host_twin_run(
            torch, fa, pe, zoo, "host_sync.rec.custom_model", records, dev,
            HOST_EPOCHS)
        table = executor._step_runner.engine.tables[twin.TABLE_NAME]
        ids, rows = table.to_arrays()
        runs[dev] = dict(loss=[float(x) for x in record.loss],
                         counts=counts, table=table, ids=ids, rows=rows,
                         initial=record.initial, steps=result["steps"])
    card, cpu = runs["cuda"], runs["cpu"]
    touched = np.unique(frappe_ids(HOST_RECORDS, HOST_IDS, HOST_MAX_ID,
                                   SEED))
    check(all(np.array_equal(r["ids"], touched) for r in runs.values()),
          "the host table's rows are not the ids the batches touched")
    lazy = NativeEmbeddingTable(twin.TABLE_NAME, twin.EMBEDDING_DIM)
    initial = lazy.get(touched)
    rel = [abs(x - y) / abs(y) for x, y in zip(card["loss"], cpu["loss"])]
    delta_l2 = rel_err(card["rows"] - initial, cpu["rows"] - initial)
    rows_l2 = rel_err(card["rows"], cpu["rows"])
    untouched = np.setdiff1d(np.arange(HOST_MAX_ID), touched)[:64]
    untouched_equal = all(
        np.array_equal(r["table"].get(untouched), lazy.get(untouched))
        for r in runs.values())
    per_epoch = HOST_RECORDS // HOST_BATCH
    epoch_loss = [float(np.mean(card["loss"][i:i + per_epoch]))
                  for i in range(0, card["steps"], per_epoch)]
    same_start = all(torch.equal(card["initial"][n], cpu["initial"][n])
                     for n in cpu["initial"])

    # The zoo's own runner (async apply) on the card, timed.
    executor, record, result, async_counts = host_twin_run(
        torch, fa, pe, tdata.model_zoo_dir(),
        "deepfm.deepfm_host.custom_model", records, "cuda",
        HOST_TIMED_EPOCHS)
    async_loss = [float(x) for x in record.loss]
    async_epochs = [float(np.mean(async_loss[i:i + per_epoch]))
                    for i in range(0, len(async_loss), per_epoch)]
    finite = all(bool(torch.isfinite(p).all())
                 for p in executor.state.model.parameters())
    step_ms, issue_ms = window_ms(record, warm=per_epoch, window=per_epoch)
    median = float(np.median(step_ms))
    async_check = host_async_check(torch, fa, pe)
    engine = host_engine_times(torch)
    functional = deepfm_functional_phase(torch, fa, pe, root)
    out = {
        "model": "deepfm_host twin (model_zoo/deepfm/deepfm_host.py: "
                 "5500 x 16 host table, 10 ids an example, SGD rows lr "
                 "0.05, MLP 160-64-32-1 bf16, Adam 1e-3), random weights, "
                 f"seed {SEED}",
        "batch": HOST_BATCH, "steps": card["steps"],
        "native_store": all(isinstance(r["table"], NativeEmbeddingTable)
                            for r in runs.values()),
        "native_library": os.path.relpath(native.library_path()),
        "native_build_s": native.build_seconds,
        "launches_card": card["counts"], "launches_cpu": cpu["counts"],
        "launches_async": async_counts,
        "losses_card": card["loss"], "losses_cpu": cpu["loss"],
        "loss_max_rel_diff": max(rel), "touched_rows": int(touched.size),
        "rows_delta_l2": delta_l2, "rows_l2": rows_l2,
        "untouched_bit_equal": untouched_equal,
        "epoch_mean_loss": epoch_loss, "same_initial_weights": same_start,
        "tol": HOST_TOL,
        "async": {"steps": result["steps"], "epoch_mean_loss": async_epochs,
                  "params_finite": finite,
                  "step_ms": spread(step_ms), "issue_ms": spread(issue_ms),
                  "examples_per_s": HOST_BATCH / (median / 1e3),
                  "clocks_after": smi("clocks.sm,clocks.max.sm,power.draw,"
                                      "temperature.gpu")},
        "async_vs_sync": async_check,
        "engine": engine, "deepfm_functional": functional,
    }
    print("host training", json.dumps(out), flush=True)
    check(out["native_store"], "the host table is not the native store")
    check(card["steps"] == HOST_EPOCHS * per_epoch
          and cpu["steps"] == card["steps"], f"{card['steps']} host steps")
    for name, counts in (("card", card["counts"]), ("cpu", cpu["counts"]),
                         ("async", async_counts)):
        check(not any(counts.values()),
              f"the host path ({name}) launched kernels: {counts}")
    check(same_start, "card and CPU start from other weights")
    check(untouched_equal, "an untouched row is not its lazy initial value")
    check(all(np.isfinite(card["loss"])), "non-finite loss")
    check(epoch_loss[-1] < epoch_loss[0],
          f"the loss did not fall: {epoch_loss}")
    check(max(rel) <= HOST_TOL["loss"], f"card vs CPU losses {out}")
    check(delta_l2 <= HOST_TOL["delta_l2"], f"card vs CPU rows {out}")
    check(result["steps"] == HOST_TIMED_EPOCHS * per_epoch and finite
          and async_epochs[-1] < async_epochs[0],
          f"async run: {result['steps']} steps, finite {finite}, "
          f"{async_epochs}")
    return out


def host_engine_times(torch):
    """Per-batch median ms of the host engine's phases at the recsys
    table's shape: dedup, row pull, pad (each as the engine calls it, on
    one batch), the whole ``prepare_batch`` (on a second batch), device
    placement (pinned copy + transfer, synchronised) and the Adagrad
    apply of that batch's row gradients; a cold pass over fresh batches
    (the pull and the apply materialise rows and accumulators), then a
    warm pass over the same batches."""
    from elasticdl_tpu_torch.embedding.host_engine import (
        HostEmbeddingEngine,
        PreparedBatch,
        dedup_ids,
        pad_rows,
    )
    from elasticdl_tpu_torch.embedding.optimizer import Adagrad
    from elasticdl_tpu_torch.native.row_store import (
        NativeEmbeddingTable,
        make_host_optimizer,
    )

    table = NativeEmbeddingTable(RECSYS_TABLE, EMB_DIM)
    engine = HostEmbeddingEngine(
        {RECSYS_TABLE: table}, make_host_optimizer(Adagrad(lr=0.05)),
        id_keys={RECSYS_TABLE: "ids"})
    rng = np.random.RandomState(SEED + 4)

    def fresh():
        return {"features": {"ids": rng.randint(
                    0, EMB_VOCAB, (EMB_BATCH, EMB_IDS)).astype(np.int64)},
                "labels": np.zeros((EMB_BATCH,), np.int32),
                "mask": np.ones((EMB_BATCH,), np.float32)}

    batches = [(fresh(), fresh()) for _ in range(HOST_ENGINE_BATCHES)]

    def run_pass():
        phases = {k: [] for k in ("dedup", "row_pull", "pad",
                                  "prepare_batch", "device_placement",
                                  "apply")}
        uniques = []

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            phases[name].append((time.perf_counter() - t0) * 1e3)
            return out

        for first, batch in batches:
            uniq, _ = timed("dedup", dedup_ids, first["features"]["ids"])
            pulled = timed("row_pull", table.get, uniq)
            timed("pad", pad_rows, pulled, EMB_DIM)
            prepared = PreparedBatch(batch, *timed(
                "prepare_batch", engine.prepare_batch, batch))

            def place():
                placed = engine.place_on_device(prepared, "cuda")
                torch.cuda.synchronize()
                return placed

            timed("device_placement", place)
            u = prepared.uniques[RECSYS_TABLE][1]
            uniques.append(u)
            grads = {RECSYS_TABLE: rng.standard_normal(
                (u, EMB_DIM)).astype(np.float32) * 1e-3}
            timed("apply", engine.apply_row_grads, grads, prepared.uniques)
        return {"rows_resident_after": table.num_rows,
                "unique_ids_median": int(np.median(uniques)),
                "ms_median": {k: float(np.median(v[HOST_ENGINE_SKIP:]))
                              for k, v in phases.items()},
                "ms_range": {k: [float(min(v[HOST_ENGINE_SKIP:])),
                                 float(max(v[HOST_ENGINE_SKIP:]))]
                             for k, v in phases.items()}}

    cold = run_pass()
    warm = run_pass()
    return {"table": f"{EMB_VOCAB} x {EMB_DIM} f32, native, lazy",
            "batch": EMB_BATCH, "ids": EMB_BATCH * EMB_IDS,
            "batches": HOST_ENGINE_BATCHES, "skipped": HOST_ENGINE_SKIP,
            "cold": cold, "warm": warm}


def host_async_check(torch, fa, pe):
    """The zoo's deepfm_host runner (async apply) on the card, inline and
    with pull-ahead (``iter_prepared``: rows pulled on a thread and
    placed on the card from pinned memory), against a synchronous runner
    over the same HOST_DISJOINT_BATCHES batches of disjoint ids: losses
    and the host table bit-equal, no kernel launched. Losses stay on the
    card until the run ends, so no step waits for the one before."""
    from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin

    span = HOST_MAX_ID // HOST_DISJOINT_BATCHES
    rng = np.random.RandomState(SEED + 6)
    batches = []
    for b in range(HOST_DISJOINT_BATCHES):
        ids = b * span + rng.randint(0, span, (HOST_BATCH, HOST_IDS))
        batches.append({"features": {twin.FEATURE_KEY: ids.astype(np.int64)},
                        "labels": (ids.sum(1) % 2).astype(np.int32),
                        "mask": np.ones((HOST_BATCH,), np.float32)})

    def run(mode):
        runner = twin.make_host_runner()
        if mode == "sync":
            runner = HostStepRunner(runner.engine, async_apply=False)
        torch.manual_seed(SEED)
        model = twin.custom_model("cuda")
        reset_kernel_launches(fa, pe)
        state = runner.init_state(model, twin.optimizer(), batches[0],
                                  seed=SEED)
        step = runner.train_step(twin.loss)
        losses = []
        if mode == "pull_ahead":
            with runner.iter_prepared(iter(batches)) as prepared:
                for pb in prepared:
                    state, metrics = step(state, pb)
                    losses.append(metrics["loss"])
        else:
            for batch in batches:
                state, metrics = step(state, batch)
                losses.append(metrics["loss"])
        runner.flush()
        counts = kernel_launch_counts(fa, pe)
        ids, rows = runner.engine.tables[twin.TABLE_NAME].to_arrays()
        return dict(losses=[float(x) for x in losses], ids=ids, rows=rows,
                    counts=counts)

    runs = {mode: run(mode) for mode in ("sync", "async", "pull_ahead")}
    sync = runs["sync"]
    out = {"batches": HOST_DISJOINT_BATCHES, "id_span": span,
           "rows": int(sync["ids"].size), "losses_sync": sync["losses"]}
    for mode in ("async", "pull_ahead"):
        r = runs[mode]
        out[mode] = {
            "losses_bit_equal": r["losses"] == sync["losses"],
            "ids_equal": bool(np.array_equal(r["ids"], sync["ids"])),
            "rows_bit_equal": bool(r["rows"].shape == sync["rows"].shape
                                   and np.array_equal(r["rows"],
                                                      sync["rows"])),
            "rows_max_abs_diff": (float(np.abs(r["rows"] - sync["rows"]).max())
                                  if r["rows"].shape == sync["rows"].shape
                                  else None),
            "launches": r["counts"]}
    print("host async vs sync", json.dumps(out), flush=True)
    for mode in ("sync", "async", "pull_ahead"):
        check(not any(runs[mode]["counts"].values()),
              f"the host path ({mode}) launched kernels: "
              f"{runs[mode]['counts']}")
    for mode in ("async", "pull_ahead"):
        check(out[mode]["losses_bit_equal"] and out[mode]["ids_equal"]
              and out[mode]["rows_bit_equal"],
              f"{mode} apply on the card is not the sync apply: {out}")
    return out


def deepfm_functional_phase(torch, fa, pe, root):
    """deepfm_functional, DEEPFM_STEPS Local steps on the card and on the
    CPU from the same seed: losses, first-step gradients and every
    parameter's change agree (TRAJ_TOL); no kernel launches."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_frappe_record_file(
        os.path.join(root, "deepfm.rec"), DEEPFM_STEPS * HOST_BATCH,
        seed=SEED + 5, input_length=HOST_IDS, max_id=HOST_MAX_ID)
    runs = {}
    for dev in ("cuda", "cpu"):
        args = tdata.make_local_args(
            tdata.model_zoo_dir(), "deepfm.deepfm_functional.custom_model",
            records, minibatch_size=HOST_BATCH,
            extra=["--device", dev, "--random_seed", str(SEED)])
        record = step_recorder(torch)
        executor = LocalExecutor(args, callbacks=[record])
        reset_kernel_launches(fa, pe)
        executor.run()
        record.counts = kernel_launch_counts(fa, pe)
        record.final = {name: p.detach().float().cpu()
                        for name, p in executor.state.model.named_parameters()}
        runs[dev] = record
    card, cpu = runs["cuda"], runs["cpu"]
    losses = {dev: [float(x) for x in r.loss] for dev, r in runs.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                               losses["cpu"])]
    grad_l2 = {n: rel_err(card.first_grads[n].numpy(),
                          cpu.first_grads[n].numpy()) for n in cpu.initial}
    delta_l2 = {n: rel_err((card.final[n] - card.initial[n]).numpy(),
                           (cpu.final[n] - cpu.initial[n]).numpy())
                for n in cpu.initial}
    out = {"steps": len(rel), "batch": HOST_BATCH,
           "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
           "loss_max_rel_diff": max(rel), "grad_l2": grad_l2,
           "delta_l2": delta_l2, "launches_card": card.counts,
           "launches_cpu": cpu.counts, "tol": TRAJ_TOL}
    print("deepfm_functional card vs cpu", json.dumps(out), flush=True)
    check(len(rel) == DEEPFM_STEPS, f"{len(rel)} deepfm_functional steps")
    check(all(torch.equal(card.initial[n], cpu.initial[n])
              for n in cpu.initial), "deepfm: other initial weights")
    check(not any(card.counts.values()) and not any(cpu.counts.values()),
          f"deepfm_functional launched kernels: {card.counts}")
    check(max(rel) <= TRAJ_TOL["loss"], f"deepfm card vs CPU losses {out}")
    check(max(grad_l2.values()) <= TRAJ_TOL["grad_l2"],
          f"deepfm card vs CPU first-step gradients {grad_l2}")
    check(max(delta_l2.values()) <= TRAJ_TOL["delta_l2"],
          f"deepfm card vs CPU parameter changes {delta_l2}")
    return out


def vision_phase(torch, fa, pe, root):
    """The vision zoo on the card: mnist_functional through
    LocalExecutor (card vs CPU, the padded-batch guard, the bundle
    served), resnet50 at full width timed; every kernel counter 0."""
    mnist = mnist_phase(torch, fa, pe, root)
    resnet = resnet50_phase(torch, fa, pe)
    out = {"mnist_functional": mnist, "resnet50": resnet}
    print("vision", json.dumps(out), flush=True)
    return out


def mnist_phase(torch, fa, pe, root):
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin
    from elasticdl_tpu_torch.serving.model_store import load_served_model
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_mnist_record_file(
        os.path.join(root, "mnist.rec"), VISION_STEPS * VISION_BATCH,
        seed=SEED)
    runs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(root, f"mnist_{dev}")
        args = tdata.make_local_args(
            tdata.model_zoo_dir(), "mnist.mnist_functional.custom_model",
            records, minibatch_size=VISION_BATCH,
            extra=["--device", dev, "--random_seed", str(SEED),
                   "--output", out])
        record = step_recorder(torch)
        executor = LocalExecutor(args, callbacks=[record])
        reset_kernel_launches(fa, pe)          # the vision path starts here
        executor.run()
        record.counts = kernel_launch_counts(fa, pe)    # ... and ends
        record.final = {name: p.detach().float().cpu()
                        for name, p in executor.state.model.named_parameters()}
        record.stats = {name: b.cpu().clone()
                        for name, b in executor.state.batch_stats.items()}
        record.executor, record.bundle = executor, out
        runs[dev] = record
    card, cpu = runs["cuda"], runs["cpu"]
    losses = {dev: [float(x) for x in r.loss] for dev, r in runs.items()}
    # After the first step the learnable records' loss reaches 0 on both.
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(losses["cuda"], losses["cpu"])]
    grad_l2 = {n: rel_err(card.first_grads[n].numpy(),
                          cpu.first_grads[n].numpy())
               for n in cpu.initial if np.any(cpu.first_grads[n].numpy())}
    delta_l2 = {n: rel_err((card.final[n] - card.initial[n]).numpy(),
                           (cpu.final[n] - cpu.initial[n]).numpy())
                for n in cpu.initial}
    stats_l2 = {n: rel_err(card.stats[n].numpy(), cpu.stats[n].numpy())
                for n in cpu.stats}
    # The card's bundle served on the card, against the trained model's
    # eval forward on the same batch; then the guard, which trains on.
    served = load_served_model(
        card.bundle, device="cuda",
        model_fn=lambda: twin.custom_model(device="cuda"))
    features = card.executor.last_batch["features"]
    with torch.no_grad():
        want = card.executor.state.model.eval()(
            torch.from_numpy(features).cuda()).cpu().numpy()
    reset_kernel_launches(fa, pe)
    got = served.predict(features)
    serve_counts = kernel_launch_counts(fa, pe)
    serve_l2 = rel_err(got, want)
    guard = padded_guard_check(torch, card.executor.state, twin)
    out = {"model": "mnist_functional twin (model_zoo/mnist/"
                    "mnist_functional.py, bf16, SGD 0.1 momentum 0.9), "
                    f"random weights, seed {SEED}",
           "batch": VISION_BATCH, "steps": len(rel),
           "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
           "loss_max_rel_diff": max(rel), "grad_l2": grad_l2,
           "delta_l2": delta_l2, "stats_l2": stats_l2,
           "launches_card": card.counts, "launches_cpu": cpu.counts,
           "launches_served": serve_counts, "padded_guard": guard,
           "served_vs_eval_l2": serve_l2,
           "tol": dict(TRAJ_TOL, stats_l2=VISION_STATS_TOL,
                       served=LOGITS_REL_TOL)}
    print("mnist_functional card vs cpu", json.dumps(out), flush=True)
    check(len(rel) == VISION_STEPS, f"{len(rel)} mnist steps")
    check(all(torch.equal(card.initial[n], cpu.initial[n])
              for n in cpu.initial), "mnist: other initial weights")
    for counts in (card.counts, cpu.counts, serve_counts):
        check(not any(counts.values()),
              f"the vision path launched kernels: {counts}")
    check(all(np.isfinite(losses["cuda"])), "mnist: non-finite loss")
    check(losses["cuda"][-1] < losses["cuda"][0],
          f"mnist: the loss did not fall: {losses['cuda']}")
    check(max(rel) <= TRAJ_TOL["loss"], f"mnist card vs CPU losses {out}")
    check(grad_l2 and max(grad_l2.values()) <= TRAJ_TOL["grad_l2"],
          f"mnist card vs CPU first-step gradients {grad_l2}")
    check(max(delta_l2.values()) <= TRAJ_TOL["delta_l2"],
          f"mnist card vs CPU parameter changes {delta_l2}")
    check(max(stats_l2.values()) <= VISION_STATS_TOL,
          f"mnist card vs CPU statistics {stats_l2}")
    check(all(guard.values()), f"the padded-batch guard on the card: {guard}")
    check(serve_l2 <= LOGITS_REL_TOL, f"served vs eval forward {serve_l2}")
    return out


def padded_guard_check(torch, state, twin):
    """On the card: a full batch moves the statistics; a batch with
    padded rows leaves them bit-equal, from a host mask and from a batch
    already on the card (torch.where, no read-back); the step still
    trains."""
    from elasticdl_tpu_torch.core.step import build_train_step
    from elasticdl_tpu_torch.data.batcher import pad_batch, tree_map

    rng = np.random.default_rng(SEED + 40)

    def batch(real, placed=False):
        b = pad_batch(rng.random((real, 28, 28), dtype=np.float32),
                      rng.integers(0, 10, real).astype(np.int32), real,
                      VISION_BATCH)
        return tree_map(lambda x: torch.from_numpy(x).cuda(), b) \
            if placed else b

    def stats():
        return [b.clone() for b in state.batch_stats.values()]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    step = build_train_step(twin.loss)
    out = {}
    before = stats()
    step(state, batch(VISION_BATCH))
    out["full_moves"] = not same(before, stats())
    for placed in (False, True):
        before = stats()
        weight = state.model.Dense_0.weight.detach().clone()
        step(state, batch(VISION_BATCH // 2, placed))
        key = "placed" if placed else "host"
        out[f"padded_{key}_bit_equal"] = same(before, stats())
        out[f"padded_{key}_trains"] = not torch.equal(
            weight, state.model.Dense_0.weight)
    torch.cuda.synchronize()
    return out


def resnet50_phase(torch, fa, pe):
    """The resnet50 zoo twin (custom_model(): s2d stem, 10 classes, bf16)
    at RESNET_BATCH x RESNET_HW^2 through the executor's train step,
    timed: step ms (CUDA events) beside issue ms, examples/s, peak
    memory; a finite loss and moved statistics; no kernel launches."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.core.step import build_train_step
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.testing import data as tdata

    torch.manual_seed(SEED)
    spec = get_model_spec(tdata.model_zoo_dir(),
                          "resnet50.resnet50.custom_model", device="cuda")
    state = init_train_state(spec.model, spec.make_optimizer(), seed=SEED)
    step = build_train_step(spec.loss)
    rng = np.random.RandomState(SEED)      # bench_suite._make_batch's
    batches = [{"features": rng.rand(RESNET_BATCH, RESNET_HW, RESNET_HW,
                                     3).astype(np.float32),
                "labels": rng.randint(0, 10, RESNET_BATCH).astype(np.int32),
                "mask": np.ones(RESNET_BATCH, np.float32)}
               for _ in range(2)]
    initial_stats = {k: v.clone() for k, v in state.batch_stats.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches(fa, pe)            # the resnet path starts here
    events, issue_ms, losses = [], [], []
    for i in range(VISION_WARM + VISION_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, metrics = step(state, batches[i % 2])
        end.record()
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    counts = kernel_launch_counts(fa, pe)    # ... and ends
    peak = torch.cuda.max_memory_allocated()
    clocks = smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    step_ms = [s.elapsed_time(e) for s, e in events[VISION_WARM:]]
    timed_issue = issue_ms[VISION_WARM:]
    losses = [float(x) for x in losses]
    moved = {k: not torch.equal(v, initial_stats[k])
             for k, v in state.batch_stats.items()}
    finite = all(bool(torch.isfinite(p).all())
                 for p in state.model.parameters())
    median = float(np.median(step_ms))
    out = {"model": "resnet50 twin (model_zoo/resnet50/resnet50.py "
                    "custom_model(): s2d stem, bottleneck v1.5 (3, 4, 6, "
                    "3), 10 classes, bf16, SGD 0.02 Nesterov), random "
                    f"weights, seed {SEED}",
           "batch": RESNET_BATCH, "image_hw": RESNET_HW,
           "warm_steps": VISION_WARM, "timed_steps": VISION_TIMED,
           "step_ms": spread(step_ms), "issue_ms": spread(timed_issue),
           "examples_per_s": RESNET_BATCH / (median / 1e3),
           "max_memory_allocated_bytes": peak, "losses": losses,
           "params_finite": finite, "statistics": len(moved),
           "statistics_moved": sum(moved.values()), "launches": counts,
           "card": smi("name,power.limit"), "clocks_after": clocks}
    print("resnet50 training", json.dumps(out), flush=True)
    check(all(np.isfinite(losses)) and finite,
          f"resnet50: non-finite loss or weights: {losses}")
    check(moved and all(moved.values()),
          f"resnet50: statistics that did not move: "
          f"{[k for k, v in moved.items() if not v]}")
    check(not any(counts.values()), f"resnet50 launched kernels: {counts}")
    return out


def tabular_records(root):
    """{kind: path} of the phase's records, from the port's generators
    (the JAX generators' bytes for the same seed)."""
    from elasticdl_tpu_torch.testing import data as tdata

    return {
        "census": tdata.create_census_record_file(
            os.path.join(root, "census.rec"), CENSUS_RECORDS, seed=SEED),
        "census_eval": tdata.create_census_record_file(
            os.path.join(root, "census_eval.rec"), CENSUS_EVAL_RECORDS,
            seed=SEED + 1),
        "heart": tdata.create_heart_record_file(
            os.path.join(root, "heart.rec"), TABULAR_RECORDS, seed=SEED),
        "iris": tdata.create_iris_csv(
            os.path.join(root, "iris.csv"), TABULAR_RECORDS, seed=SEED),
    }


def tabular_twin_phase(torch, fa, pe, root, model_def, records):
    """One tabular twin, TABULAR_STEPS Local steps at TABULAR_BATCH on
    the card and on the CPU from the same seed: losses, first-step
    gradients and every parameter's change within TRAJ_TOL; no kernel
    launches. The card run exports its --output bundle."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    name = model_def.split(".")[1]
    runs = {}
    for dev in ("cuda", "cpu"):
        extra = ["--device", dev, "--random_seed", str(SEED),
                 "--max_steps", str(TABULAR_STEPS)]
        if dev == "cuda":
            extra += ["--output", os.path.join(root, f"{name}_bundles",
                                               "v1")]
        args = tdata.make_local_args(
            tdata.model_zoo_dir(), model_def, records,
            minibatch_size=TABULAR_BATCH, extra=extra)
        record = step_recorder(torch)
        executor = LocalExecutor(args, callbacks=[record])
        before = kernel_launch_counts(fa, pe)
        executor.run()
        record.counts = launches_since(fa, pe, before)
        record.final = {n: p.detach().float().cpu()
                        for n, p in executor.state.model.named_parameters()}
        record.executor = executor
        runs[dev] = record
    card, cpu = runs["cuda"], runs["cpu"]
    losses = {dev: [float(x) for x in r.loss] for dev, r in runs.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                               losses["cpu"])]
    grad_l2 = {n: rel_err(card.first_grads[n].numpy(),
                          cpu.first_grads[n].numpy()) for n in cpu.initial}
    delta_l2 = {n: rel_err((card.final[n] - card.initial[n]).numpy(),
                           (cpu.final[n] - cpu.initial[n]).numpy())
                for n in cpu.initial}
    out = {"steps": len(rel), "batch": TABULAR_BATCH,
           "losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
           "loss_max_rel_diff": max(rel), "grad_l2": grad_l2,
           "delta_l2": delta_l2, "launches_card": card.counts,
           "launches_cpu": cpu.counts, "tol": TRAJ_TOL}
    print(f"{name} card vs cpu", json.dumps(out), flush=True)
    check(len(rel) == TABULAR_STEPS, f"{len(rel)} {name} steps")
    check(all(torch.equal(card.initial[n], cpu.initial[n])
              for n in cpu.initial), f"{name}: other initial weights")
    check(not any(card.counts.values()) and not any(cpu.counts.values()),
          f"{name} launched kernels: {card.counts}")
    check(all(np.isfinite(losses["cuda"])), f"{name}: non-finite loss")
    check(max(rel) <= TRAJ_TOL["loss"], f"{name} card vs CPU losses {out}")
    check(max(grad_l2.values()) <= TRAJ_TOL["grad_l2"],
          f"{name} card vs CPU first-step gradients {grad_l2}")
    check(max(delta_l2.values()) <= TRAJ_TOL["delta_l2"],
          f"{name} card vs CPU parameter changes {delta_l2}")
    return out, card.executor


def census_timed_phase(torch, fa, pe, records, eval_records):
    """census_wide_deep through LocalExecutor on the card for
    TABULAR_TIMED_EPOCHS, evaluated at the end: step ms (CUDA events)
    beside issue ms, examples/s, peak memory; its dataset_fn on one
    batch on the host."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.data.record_file import RecordFileScanner
    from elasticdl_tpu_torch.model_zoo.census import census_wide_deep as twin
    from elasticdl_tpu_torch.testing import data as tdata

    args = tdata.make_local_args(
        tdata.model_zoo_dir(), "census.census_wide_deep.custom_model",
        records, validation_data=eval_records,
        minibatch_size=TABULAR_BATCH, num_epochs=TABULAR_TIMED_EPOCHS,
        extra=["--device", "cuda", "--random_seed", str(SEED)])
    record = step_recorder(torch)
    executor = LocalExecutor(args, callbacks=[record])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_launch_counts(fa, pe)
    result = executor.run()
    counts = launches_since(fa, pe, before)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in record.events[TABULAR_WARM:]]
    issue = record.issue_ms[TABULAR_WARM:]
    losses = [float(x) for x in record.loss]
    with RecordFileScanner(records, 0, TABULAR_BATCH) as scanner:
        batch = list(scanner)
    decode_ms = []
    for _ in range(TABULAR_DECODES):
        t0 = time.perf_counter()
        twin.dataset_fn(batch, Mode.TRAINING, None)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(step_ms))
    out = {"model": "census_wide_deep twin (model_zoo/census/"
                    "census_wide_deep.py: 22 x 1 wide and 22 x 8 deep "
                    "tables, bf16 MLP 34-16-8-1, Adam 1e-3 x 0.3), random "
                    f"weights, seed {SEED}",
           "batch": TABULAR_BATCH, "records": CENSUS_RECORDS,
           "steps": len(losses), "warm_steps": TABULAR_WARM,
           "step_ms": spread(step_ms), "issue_ms": spread(issue),
           "examples_per_s": TABULAR_BATCH / (median / 1e3),
           "executor_examples_per_s": result["examples_per_sec"],
           "dataset_fn_ms": spread(decode_ms),
           "max_memory_allocated_bytes": peak,
           "first_loss": losses[0], "last_loss": losses[-1],
           "eval_metrics": result["eval_metrics"], "launches": counts,
           "card": smi("name,power.limit"),
           "clocks_after": smi("clocks.sm,clocks.max.sm,power.draw,"
                               "temperature.gpu")}
    print("census_wide_deep timed", json.dumps(out), flush=True)
    check(all(np.isfinite(losses)), f"census timed: non-finite {losses}")
    check(result["eval_metrics"] is not None
          and 0.0 <= result["eval_metrics"]["accuracy"] <= 1.0,
          f"census timed: eval metrics {result['eval_metrics']}")
    check(not any(counts.values()), f"census timed launched {counts}")
    return out


def census_serving_check(torch, fa, pe, executor, bundles):
    """The card run's bundle (the one version under ``bundles``) through
    ModelStore and InferenceServer on the card: one JSON predict of dict
    features against the trained model's eval forward on the same
    rows."""
    from elasticdl_tpu_torch.model_zoo.census import census_wide_deep as twin
    from elasticdl_tpu_torch.serving.model_store import ModelStore
    from elasticdl_tpu_torch.serving.server import InferenceServer

    features = {k: v[:TABULAR_SERVED_ROWS]
                for k, v in executor.last_batch["features"].items()}
    with torch.no_grad():
        want = executor.state.model.eval()(
            {k: torch.from_numpy(v).cuda() for k, v in features.items()}
        ).cpu().numpy()
    store = ModelStore(bundles, device="cuda",
                       model_fn=lambda: twin.custom_model(device="cuda"))
    store.load_initial()
    server = InferenceServer(store, port=0, batch_deadline_ms=1).start()
    before = kernel_launch_counts(fa, pe)
    try:
        body = json.dumps({"features": {k: v.tolist()
                                        for k, v in features.items()}})
        request = urllib.request.Request(
            f"http://localhost:{server.port}/v1/predict",
            data=body.encode("utf-8"),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=600) as resp:
            status, reply = resp.status, json.loads(resp.read())
    finally:
        server.stop()
        store.stop()
    counts = launches_since(fa, pe, before)
    got = np.asarray(reply["predictions"], np.float32)
    out = {"status": status, "rows": TABULAR_SERVED_ROWS,
           "model_version": reply["model_version"],
           "served_vs_eval_l2": rel_err(got, want), "launches": counts,
           "tol": LOGITS_REL_TOL}
    print("census_wide_deep served", json.dumps(out), flush=True)
    check(status == 200 and got.shape == want.shape,
          f"census served: {status} {got.shape}")
    check(out["served_vs_eval_l2"] <= LOGITS_REL_TOL,
          f"census served vs eval forward {out}")
    check(not any(counts.values()), f"census serving launched {counts}")
    return out


def tabular_phase(torch, fa, pe, root):
    """The tabular zoo on the card: each twin card vs CPU, census wide &
    deep timed and served; every kernel counter 0 over the phase."""
    records = tabular_records(root)
    twins, executors = {}, {}
    reset_kernel_launches(fa, pe)              # the tabular path starts here
    for model_def, kind in TABULAR_TWINS:
        name = model_def.split(".")[1]
        twins[name], executors[name] = tabular_twin_phase(
            torch, fa, pe, root, model_def, records[kind])
    timed = census_timed_phase(torch, fa, pe, records["census"],
                               records["census_eval"])
    served = census_serving_check(
        torch, fa, pe, executors["census_wide_deep"],
        os.path.join(root, "census_wide_deep_bundles"))
    launches = kernel_launch_counts(fa, pe)    # ... and ends
    out = {"twins": twins, "census_wide_deep": timed, "served": served,
           "launches": launches, "card": smi("name,power.limit")}
    print("tabular", json.dumps({k: out[k] for k in
                                 ("census_wide_deep", "served",
                                  "launches")}), flush=True)
    check(not any(launches.values()),
          f"the tabular path launched kernels: {launches}")
    return out


def bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.reshape(-1).view(np.uint8),
                               b.reshape(-1).view(np.uint8)))


def unequal_leaves(got, want):
    """Names of the leaves of ``want`` that ``got`` lacks or holds with
    other bits."""
    return [n for n in want if n not in got or not bit_equal(got[n], want[n])]


def checkpoint_registry():
    """The port's registry's ``checkpoint_*`` series: histograms as
    (count, sum), counters and gauges as their value."""
    from elasticdl_tpu_torch.observability import default_registry

    out = {}
    for family in default_registry().snapshot()["families"]:
        if "_checkpoint_" not in family["name"]:
            continue
        name = family["name"].split("_checkpoint_", 1)[1]
        for series in family["series"]:
            key = name + "".join(f"[{v}]" for v in series["labels"])
            out[key] = ((series["count"], series["sum"])
                        if "count" in series else series["value"])
    return out


def registry_since(before):
    """Each checkpoint series' change since ``before``: histograms as
    {count, sum}, counters as their increase."""
    out = {}
    for key, value in checkpoint_registry().items():
        old = before.get(key)
        if isinstance(value, tuple):
            old = old or (0, 0.0)
            out[key] = {"count": value[0] - old[0], "sum": value[1] - old[1]}
        else:
            out[key] = value - (old or 0.0)
    return out


def host_rss():
    """(current, peak) resident bytes of this process."""
    import resource

    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return pages * os.sysconf("SC_PAGE_SIZE"), peak


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def ckpt_run(torch, fa, pe, zoo, model_def, data, batch, extra,
             callbacks=(), validation=""):
    """One LocalExecutor run on the card; every kernel counter is zeroed
    just before it and read just after."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    args = tdata.make_local_args(
        zoo, model_def, data, validation_data=validation,
        minibatch_size=batch,
        extra=["--device", DEVICE, "--random_seed", str(SEED)] + extra)
    record = step_recorder(torch)
    executor = LocalExecutor(args, callbacks=[record, *callbacks])
    reset_kernel_launches(fa, pe)             # the path starts here
    result = executor.run()
    counts = kernel_launch_counts(fa, pe)     # ... and ends
    counts["row_update_adagrad"] = pe.row_update_rule_launches["adagrad"]
    return executor, [float(x) for x in record.loss], result, counts


def restored_check(torch, want_leaves, want_tables=None):
    """A Callback that, at the first batch of a resumed run (after the
    restore, before the first step), reads the state's leaves and the
    runner's host tables against the saved ones, bit for bit."""
    from elasticdl_tpu_torch.callbacks import Callback
    from elasticdl_tpu_torch.checkpoint import named_leaves_from_state

    class RestoredCheck(Callback):
        reading = None

        def on_train_batch_begin(self, owner=None):
            if self.reading is not None:
                return
            got = named_leaves_from_state(owner.state)
            bad = unequal_leaves(got, want_leaves)
            extra = sorted(set(got) - set(want_leaves))
            tables_bad = []
            for name, (ids, rows) in (want_tables or {}).items():
                got_ids, got_rows = \
                    owner._step_runner.host_tables[name].to_arrays()
                if not (bit_equal(got_ids, ids) and bit_equal(got_rows,
                                                              rows)):
                    tables_bad.append(name)
            self.reading = {"step": owner.state.step,
                            "leaves": len(want_leaves), "unequal": bad,
                            "unexpected": extra,
                            "host_tables": sorted(want_tables or {}),
                            "host_tables_unequal": tables_bad}

    return RestoredCheck()


def loss_rel(got, want):
    return max(abs(x - y) / abs(y) for x, y in zip(got, want))


def checkpoint_recsys_part(torch, fa, pe, root):
    """(a) The recsys twin at full width: straight against split, the
    restored state against the saved one, the save and restore read
    from the port's registry."""
    from elasticdl_tpu_torch.checkpoint import named_leaves_from_state
    from elasticdl_tpu_torch.testing import data as tdata

    both = os.path.join(root, "ckpt_recsys_ab")
    os.makedirs(both)
    files = [tdata.create_frappe_record_file(
        os.path.join(both, f"{part}.rec"), CKPT_RECORDS, seed=seed,
        input_length=EMB_IDS, max_id=EMB_VOCAB)
        for part, seed in (("a", SEED + 10), ("b", SEED + 11))]
    evalf = tdata.create_frappe_record_file(
        os.path.join(root, "ckpt_recsys_eval.rec"), CKPT_EVAL_RECORDS,
        seed=SEED + 12, input_length=EMB_IDS, max_id=EMB_VOCAB)
    zoo = write_zoo(root, "ckpt_recsys", RECSYS_ZOO.format(mode="always"))
    model_def = "ckpt_recsys.rec.custom_model"
    ckpt = os.path.join(root, "ckpt_recsys")

    def run(data, extra, callbacks=()):
        return ckpt_run(torch, fa, pe, zoo, model_def, data, EMB_BATCH,
                        extra, callbacks, validation=evalf)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_before = host_rss()[0]
    snap = table_snapshot(torch)
    straight, s_loss, _, s_counts = run(both, [], [snap])
    initial = snap.initial[RECSYS_TABLE]
    s_table = straight.state.tables[RECSYS_TABLE]
    s_acc = straight.state.slot_tables[RECSYS_TABLE]["accumulator"]
    del straight
    before = checkpoint_registry()
    first, f_loss, _, f_counts = run(files[0], [
        "--checkpoint_dir", ckpt, "--checkpoint_steps", str(CKPT_STEPS)])
    saved_registry = registry_since(before)
    saved_files = sorted(os.listdir(ckpt))
    saved_bytes = dir_bytes(ckpt)
    t0 = time.monotonic()
    saved = named_leaves_from_state(first.state)   # the state at the save
    host_copy_s = time.monotonic() - t0
    del first
    torch.cuda.empty_cache()
    before = checkpoint_registry()
    restored = restored_check(torch, saved)
    resumed, r_loss, _, r_counts = run(files[1], [
        "--checkpoint_dir_for_init", ckpt], [restored])
    restore_registry = registry_since(before)
    peak = torch.cuda.max_memory_allocated()
    rss_after, rss_peak = host_rss()
    del saved
    r_table = resumed.state.tables[RECSYS_TABLE]
    r_acc = resumed.state.slot_tables[RECSYS_TABLE]["accumulator"]
    ids = np.concatenate([frappe_ids(CKPT_RECORDS, EMB_IDS, EMB_VOCAB, s)
                          for s in (SEED + 10, SEED + 11)])
    touched = torch.zeros(initial.shape[0], dtype=torch.bool,
                          device=initial.device)
    touched[torch.from_numpy(np.unique(ids)).to(initial.device)] = True
    untouched = ~touched
    delta_r = (r_table[touched] - initial[touched]).cpu().numpy()
    delta_s = (s_table[touched] - initial[touched]).cpu().numpy()
    save_s = saved_registry["save_seconds"]["sum"]
    stall = saved_registry["stall_seconds"]
    restore_s = restore_registry["restore_seconds"]["sum"]
    eval_batches = -(-CKPT_EVAL_RECORDS // EMB_BATCH)
    out = {
        "model": "recsys ranker twin, 1,000,000 x 256 f32 table, Adagrad "
                 "rows, bf16 MLP, Adam; kernels pinned",
        "steps": {"straight": len(s_loss), "first": len(f_loss),
                  "resumed": len(r_loss)},
        "resumed_step": resumed.state.step,
        "launches": {"straight": s_counts, "first": f_counts,
                     "resumed": r_counts},
        "restored": restored.reading,
        "saved_files": saved_files, "saved_dir_bytes": saved_bytes,
        "losses_straight": s_loss, "losses_split": f_loss + r_loss,
        "loss_max_rel_diff": loss_rel(f_loss + r_loss, s_loss),
        "table_delta_l2": rel_err(delta_r, delta_s),
        "table_delta_max_abs_err": float(np.abs(delta_r - delta_s).max()),
        "accumulator_l2": rel_err(r_acc[touched].cpu().numpy(),
                                  s_acc[touched].cpu().numpy()),
        "touched_rows": int(touched.sum()),
        "untouched_bit_equal": bool(
            torch.equal(r_table[untouched], initial[untouched])
            and bool((r_acc[untouched] == 0.1).all())),
        "stall_s": stall, "save_s": save_s,
        "saved_bytes": saved_registry["saved_bytes_total"],
        "save_gb_per_s": saved_registry["saved_bytes_total"] / save_s / 1e9,
        "restore_s": restore_s,
        "restore_gb_per_s": saved_bytes / restore_s / 1e9,
        "host_copy_s": host_copy_s,
        "registry_save": saved_registry, "registry_restore": restore_registry,
        "max_memory_allocated_bytes": peak,
        "host_rss_bytes": {"before": rss_before, "after": rss_after,
                           "peak": rss_peak},
        "tol": SPARSE_TOL,
    }
    print("checkpoint recsys", json.dumps(out), flush=True)
    reading = restored.reading or {}
    check(reading.get("step") == CKPT_STEPS and not reading.get("unequal")
          and not reading.get("unexpected"),
          f"the restored state is not the saved one: {reading}")
    check(resumed.state.step == 2 * CKPT_STEPS,
          f"resumed at step {resumed.state.step}")
    for name, counts, steps in (("straight", s_counts, 2 * CKPT_STEPS),
                                ("first", f_counts, CKPT_STEPS),
                                ("resumed", r_counts, CKPT_STEPS)):
        want = {k: 0 for k in counts}
        want.update(lookup_combine=steps + eval_batches, row_update=steps,
                    row_update_adagrad=steps)
        check(counts == want, f"{name} run launches {counts}, not {want}")
    check(out["loss_max_rel_diff"] <= SPARSE_TOL["loss"],
          f"resumed vs straight losses {out}")
    check(out["table_delta_l2"] <= SPARSE_TOL["delta_l2"]
          and out["accumulator_l2"] <= SPARSE_TOL["delta_l2"],
          f"resumed vs straight rows {out}")
    check(out["untouched_bit_equal"], "an untouched row or accumulator moved")
    check(saved_files == [f"version-{CKPT_STEPS}"]
          and saved_registry["saves_total"] == 1
          and stall["count"] == 1
          and restore_registry["restore_seconds"]["count"] == 1,
          f"saves {saved_files}, registry {saved_registry}")
    return out


def checkpoint_host_part(torch, fa, pe, root):
    """(b) deepfm_host on the host tier: a base and two deltas, resumed
    from the chain against a straight run (synchronous rows)."""
    from elasticdl_tpu_torch.checkpoint import named_leaves_from_state
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.native.row_store import NativeEmbeddingTable
    from elasticdl_tpu_torch.testing import data as tdata

    both = os.path.join(root, "ckpt_host_ab")
    os.makedirs(both)
    files = [tdata.create_frappe_record_file(
        os.path.join(both, f"{part}.rec"), n, seed=seed,
        input_length=HOST_IDS, max_id=HOST_MAX_ID)
        for part, n, seed in (("a", HOST_CKPT_A, SEED + 20),
                              ("b", HOST_CKPT_B, SEED + 21))]
    zoo = write_zoo(root, "ckpt_host", HOST_ZOO)
    model_def = "ckpt_host.rec.custom_model"
    ckpt = os.path.join(root, "ckpt_host")

    def run(data, extra, callbacks=()):
        return ckpt_run(torch, fa, pe, zoo, model_def, data, HOST_BATCH,
                        extra, callbacks)

    def main_rows(executor):
        return executor._step_runner.engine.tables[
            twin.TABLE_NAME].to_arrays()

    straight, s_loss, _, s_counts = run(both, [])
    s_ids, s_rows = main_rows(straight)
    first, f_loss, _, f_counts = run(files[0], [
        "--checkpoint_dir", ckpt, "--checkpoint_steps", "2",
        "--checkpoint_delta_chain", "2"])
    layout = sorted(os.listdir(ckpt))
    tables = {n: t.to_arrays()
              for n, t in first._step_runner.host_tables.items()}
    restored = restored_check(torch, named_leaves_from_state(first.state),
                              tables)
    resumed, r_loss, _, r_counts = run(files[1], [
        "--checkpoint_dir_for_init", ckpt], [restored])
    r_ids, r_rows = main_rows(resumed)
    initial = NativeEmbeddingTable(twin.TABLE_NAME,
                                   twin.EMBEDDING_DIM).get(s_ids)
    same_ids = bool(np.array_equal(r_ids, s_ids))
    out = {"model": "deepfm_host twin, 5500 x 16 host table, SGD rows, "
                    "synchronous runner",
           "layout": layout, "restored": restored.reading,
           "resumed_step": resumed.state.step,
           "launches": {"straight": s_counts, "first": f_counts,
                        "resumed": r_counts},
           "losses_straight": s_loss, "losses_split": f_loss + r_loss,
           "loss_max_rel_diff": loss_rel(f_loss + r_loss, s_loss),
           "same_ids": same_ids,
           "rows_delta_l2": (rel_err(r_rows - initial, s_rows - initial)
                             if same_ids else None),
           "tol": HOST_TOL}
    print("checkpoint host", json.dumps(out), flush=True)
    reading = restored.reading or {}
    check(layout == ["delta-4", "delta-6", "version-2"],
          f"host checkpoint layout {layout}")
    check(reading.get("step") == 6 and not reading.get("unequal")
          and not reading.get("host_tables_unequal")
          and len(reading.get("host_tables", [])) >= 2,
          f"the restored host state is not the saved one: {reading}")
    check(resumed.state.step == 8, f"resumed at {resumed.state.step}")
    for name, counts in (("straight", s_counts), ("first", f_counts),
                         ("resumed", r_counts)):
        check(not any(counts.values()),
              f"the host path ({name}) launched kernels: {counts}")
    check(out["loss_max_rel_diff"] <= HOST_TOL["loss"],
          f"resumed vs straight host losses {out}")
    check(same_ids and out["rows_delta_l2"] <= HOST_TOL["delta_l2"],
          f"resumed vs straight host rows {out}")
    return out


def lr_recorder():
    from elasticdl_tpu_torch.callbacks import Callback

    class LrRecorder(Callback):
        def __init__(self):
            self.lrs = []

        def on_train_batch_begin(self, owner=None):
            self.lrs.append(owner.state.optimizer.param_groups[0]["lr"])

    return LrRecorder()


def job_subprocesses(jobs, while_running=None):
    """``python -m elasticdl_tpu_torch <role>`` on the card for each
    (role, zoo, model_def, data_flag, data, ckpt) of ``jobs``, side by
    side; each one's result from its log and its seconds.
    ``while_running()`` is called once they are started."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH", "")) if p)
    logs = [tempfile.TemporaryFile("w+") for _ in jobs]
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch", role,
         "--model_zoo", zoo, "--model_def", model_def, data_flag, data,
         "--checkpoint_dir_for_init", ckpt,
         "--minibatch_size", str(TABULAR_BATCH), "--device", DEVICE],
        env=env, cwd=os.path.dirname(zoo), stdout=log,
        stderr=subprocess.STDOUT)
        for (role, zoo, model_def, data_flag, data, ckpt), log
        in zip(jobs, logs)]
    out = []
    try:
        if while_running is not None:
            while_running()
        for (role, *_), proc, log in zip(jobs, procs, logs):
            proc.wait(timeout=600)
            seconds = time.monotonic() - t0
            log.seek(0)
            stderr = log.read()
            check(proc.returncode == 0,
                  f"{role} exited {proc.returncode}: {stderr[-3000:]}")
            marker = f"{role} finished: "
            line = [x for x in stderr.splitlines() if marker in x]
            check(len(line) == 1,
                  f"{role}: no result line in {stderr[-2000:]}")
            out.append((json.loads(line[0].split(marker, 1)[1]), seconds))
    finally:
        for proc, log in zip(procs, logs):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return out


def checkpoint_jobs_part(torch, fa, pe, root, while_jobs=None):
    """(c) census_wide_deep: the schedule through a split run, then the
    evaluate and predict jobs in subprocesses from the checkpoint."""
    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.testing import data as tdata

    both = os.path.join(root, "ckpt_census_ab")
    os.makedirs(both)
    files = [tdata.create_census_record_file(
        os.path.join(both, f"{part}.rec"), CKPT_RECORDS, seed=seed)
        for part, seed in (("a", SEED + 30), ("b", SEED + 31))]
    evalf = tdata.create_census_record_file(
        os.path.join(root, "ckpt_census_eval.rec"), CENSUS_EVAL_RECORDS,
        seed=SEED + 32)
    zoo = write_zoo(root, "ckpt_census", CKPT_ZOO_CENSUS)
    model_def = "ckpt_census.rec.custom_model"
    ckpt, split_ckpt = (os.path.join(root, "ckpt_census"),
                        os.path.join(root, "ckpt_census_split"))
    tb = os.path.join(root, "ckpt_census_tb")

    def run(data, extra, validation=""):
        lrs = lr_recorder()
        executor, losses, result, counts = ckpt_run(
            torch, fa, pe, zoo, model_def, data, TABULAR_BATCH, extra,
            [lrs], validation=validation)
        return executor, losses, result, counts, lrs.lrs

    straight, s_loss, s_res, s_counts, s_lrs = run(
        both, ["--checkpoint_dir", ckpt, "--tensorboard_log_dir", tb],
        validation=evalf)
    _, f_loss, _, f_counts, f_lrs = run(files[0], [
        "--checkpoint_dir", split_ckpt, "--checkpoint_steps",
        str(CKPT_STEPS)])
    resumed, r_loss, _, r_counts, r_lrs = run(files[1], [
        "--checkpoint_dir_for_init", split_ckpt])
    (metrics, eval_s), (summary, predict_s) = job_subprocesses([
        ("evaluate", zoo, model_def, "--validation_data", evalf, ckpt),
        ("predict", zoo, model_def, "--prediction_data", evalf, ckpt)],
        while_jobs)
    pred_dir = os.path.join(zoo, "ckpt_census")
    preds = np.concatenate([
        np.load(os.path.join(pred_dir, name))
        for name in sorted(os.listdir(pred_dir)) if name.endswith(".npy")])
    want = []
    with torch.no_grad():
        for batch in straight._task_batches_raw(straight._eval_reader,
                                                Mode.PREDICTION):
            real = int(np.sum(batch["mask"]))
            out_b = straight._eval_step(straight.state, batch)
            want.append(out_b.float().cpu().numpy()[:real])
    want = np.concatenate(want)
    with open(os.path.join(tb, "scalars.jsonl")) as f:
        summaries = [json.loads(line) for line in f]
    out = {"model": "census_wide_deep twin, its schedule at "
                    f"{CENSUS_LR_SCALE}x the version",
           "lrs_straight": s_lrs, "lrs_split": f_lrs + r_lrs,
           "losses_straight": s_loss, "losses_split": f_loss + r_loss,
           "loss_max_rel_diff": loss_rel(f_loss + r_loss, s_loss),
           "resumed_step": resumed.state.step,
           "eval_metrics_training": s_res["eval_metrics"],
           "eval_metrics_job": metrics, "predict_job": summary,
           "predictions": list(preds.shape),
           "predictions_bit_equal": bit_equal(preds, want),
           "predictions_max_abs_err": float(np.abs(preds - want).max()),
           "job_seconds": {"evaluate": eval_s, "predict": predict_s},
           "tensorboard": summaries,
           "launches": {"straight": s_counts, "first": f_counts,
                        "resumed": r_counts}}
    print("checkpoint jobs", json.dumps(out), flush=True)
    check(f_lrs + r_lrs == s_lrs and len(set(s_lrs)) == 3,
          f"split run's learning rates {f_lrs + r_lrs} vs {s_lrs}")
    check(resumed.state.step == 2 * CKPT_STEPS,
          f"census resumed at {resumed.state.step}")
    check(out["loss_max_rel_diff"] <= TRAJ_TOL["loss"],
          f"census resumed vs straight losses {out}")
    check(metrics == s_res["eval_metrics"],
          f"evaluate job {metrics} vs training {s_res['eval_metrics']}")
    check(summary == {"batches": -(-CENSUS_EVAL_RECORDS // TABULAR_BATCH)}
          and out["predictions_bit_equal"],
          f"predict job vs eval forward {out}")
    check(summaries and summaries[-1].get("eval/accuracy")
          == s_res["eval_metrics"]["accuracy"],
          f"TensorBoard scalars {summaries}")
    for name, counts in out["launches"].items():
        counts = {k: v for k, v in counts.items()}
        check(not any(counts.values()),
              f"census ({name}) launched kernels: {counts}")
    return out


def checkpoint_phase(torch, fa, pe, root, while_jobs=None):
    """Checkpoints and resume on the card: the recsys twin at full width,
    deepfm_host's delta chain, census and the evaluate/predict jobs
    (``while_jobs()`` called once those subprocesses start)."""
    t0 = time.monotonic()
    out = {"recsys": checkpoint_recsys_part(torch, fa, pe, root)}
    torch.cuda.empty_cache()
    out["host"] = checkpoint_host_part(torch, fa, pe, root)
    out["jobs"] = checkpoint_jobs_part(torch, fa, pe, root, while_jobs)
    out["seconds"] = time.monotonic() - t0
    out["card"] = smi("name,power.limit")
    return out


class RecordingRunner:
    """A step runner that delegates to ``inner`` and keeps, per train
    step, the loss tensor, CUDA events around the step (on the card) and
    the host's ms to issue it, and a copy of the sparse tables as they
    stand before the first step."""

    def __init__(self, torch, inner):
        self._torch = torch
        self._inner = inner
        self.loss, self.events, self.issue_ms = [], [], []
        self.initial = None

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def train_step(self, loss_fn):
        step = self._inner.train_step(loss_fn)
        torch = self._torch

        def recorded(state, batch):
            if self.initial is None:
                self.initial = {n: t.clone() for n, t in
                                getattr(state, "tables", {}).items()}
            start = None
            if state.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            self.issue_ms.append((time.perf_counter() - t0) * 1e3)
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.events.append((start, end))
            self.loss.append(metrics["loss"])
            return state, metrics

        return recorded


def worker_cluster_run(torch, fa, pe, zoo, model_def, train, evalf, device,
                       batch, dataset_fn=None, runner_factory=None):
    """The port's MiniCluster (one worker, InProcessMaster, no shuffle)
    over ``train``; the worker's runner (``runner_factory()`` when
    given) records its steps, its master client the tasks it pulls, and
    every RPC is counted. Each kernel counter is zeroed just before the
    run and read just after."""
    from elasticdl_tpu_torch.testing.cluster import MiniCluster

    rpcs = {name: 0 for name in WORKER_RPCS}

    def counter(name):
        def count(request):
            rpcs[name] += 1
        return count

    cluster = MiniCluster(
        zoo, model_def, training_data=train, validation_data=evalf,
        minibatch_size=batch, num_minibatches_per_task=WORKER_TASK_BATCHES,
        eval_steps=WORKER_EVAL_STEPS if evalf else 0, device=device,
        random_seed=SEED, step_runner_factory=runner_factory,
        worker_callbacks={name: counter(name) for name in WORKER_RPCS})
    worker = cluster.workers[0]
    record = RecordingRunner(torch, worker._step_runner)
    worker._step_runner = record
    if dataset_fn is not None:
        worker._task_data._dataset_fn = dataset_fn
    tasks = []
    client = worker._master
    pull = client.get_task

    def get_task(metrics=None):
        task, finished = pull(metrics=metrics)
        tasks.append(None if task is None else task.to_dict())
        return task, finished

    client.get_task = get_task
    if device == "cuda":
        torch.cuda.synchronize()
    reset_kernel_launches(fa, pe)             # the worker's path starts
    t0 = time.monotonic()
    result = cluster.run()[0]
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernel_launch_counts(fa, pe)     # ... and ends
    counts["row_update_adagrad"] = pe.row_update_rule_launches["adagrad"]
    return dict(cluster=cluster, worker=worker, record=record,
                result=result, counts=counts, rpcs=rpcs, wall_s=wall,
                tasks=tasks, loss=[float(x) for x in record.loss])


def step_times(record, batch, window):
    """Median step ms (CUDA events, windows of ``window`` steps after the
    first) beside issue ms, and examples/s at the median."""
    step_ms, issue_ms = window_ms(record, warm=window, window=window)
    median = float(np.median(step_ms))
    return {"step_ms": spread(step_ms), "issue_ms": spread(issue_ms),
            "examples_per_s": batch / (median / 1e3)}


def worker_recsys_part(torch, fa, pe, root):
    """(a) In process against the Local executor; returns its readings
    and what (b) and (d) compare with."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.common.constants import TaskType
    from elasticdl_tpu_torch.testing import data as tdata

    train = tdata.create_frappe_record_file(
        os.path.join(root, "worker_train.rec"), WORKER_RECORDS,
        seed=SEED + 30, input_length=EMB_IDS, max_id=EMB_VOCAB)
    evalf = tdata.create_frappe_record_file(
        os.path.join(root, "worker_eval.rec"), WORKER_EVAL_RECORDS,
        seed=SEED + 31, input_length=EMB_IDS, max_id=EMB_VOCAB)
    zoo = write_zoo(root, "worker_recsys", RECSYS_ZOO.format(mode="always"))
    model_def = "worker_recsys.rec.custom_model"
    steps = WORKER_RECORDS // EMB_BATCH
    eval_batches = -(-WORKER_EVAL_RECORDS // EMB_BATCH)
    rounds = steps // WORKER_EVAL_STEPS

    # The Local executor on the same records and seed.
    args = tdata.make_local_args(
        zoo, model_def, train, validation_data=evalf,
        minibatch_size=EMB_BATCH,
        extra=["--device", DEVICE, "--random_seed", str(SEED)])
    local_record = step_recorder(torch)
    local = LocalExecutor(args, callbacks=[local_record])
    torch.cuda.synchronize()
    reset_kernel_launches(fa, pe)             # the Local path starts
    t0 = time.monotonic()
    local_result = local.run()
    torch.cuda.synchronize()
    local_wall = time.monotonic() - t0
    local_counts = kernel_launch_counts(fa, pe)   # ... and ends
    local_loss = [float(x) for x in local_record.loss]
    l_table = local.state.tables[RECSYS_TABLE]
    l_acc = local.state.slot_tables[RECSYS_TABLE]["accumulator"]
    local_times = step_times(local_record, EMB_BATCH, WORKER_TASK_BATCHES)
    del local

    a = worker_cluster_run(torch, fa, pe, zoo, model_def, train, evalf,
                           DEVICE, EMB_BATCH)
    state = a["worker"].state
    table = state.tables[RECSYS_TABLE]
    acc = state.slot_tables[RECSYS_TABLE]["accumulator"]
    initial = a["record"].initial[RECSYS_TABLE]
    ids = frappe_ids(WORKER_RECORDS, EMB_IDS, EMB_VOCAB, SEED + 30)
    touched = touched_rows(torch, ids, EMB_VOCAB)
    untouched = ~touched
    results = a["cluster"].eval_service.completed_results
    counters = a["cluster"].dispatcher.counters
    rpcs_total = sum(a["rpcs"].values())
    worker_times = step_times(a["record"], EMB_BATCH, WORKER_TASK_BATCHES)
    out_a = {
        "model": "recsys ranker twin, 1,000,000 x 256 f32 table, Adagrad "
                 "rows, bf16 MLP, Adam; kernels pinned",
        "steps": len(a["loss"]), "tasks_pulled": a["tasks"],
        "launches_worker": a["counts"], "launches_local": local_counts,
        "losses_worker": a["loss"], "losses_local": local_loss,
        "losses_bit_equal": a["loss"] == local_loss,
        "table_bit_equal": bool(torch.equal(table, l_table)),
        "accumulator_bit_equal": bool(torch.equal(acc, l_acc)),
        "touched_rows": int(touched.sum()),
        "untouched_bit_equal": bool(
            torch.equal(table[untouched], initial[untouched])
            and bool((acc[untouched] == 0.1).all())),
        "eval_results": {str(k): v for k, v in results.items()},
        "local_eval": local_result["eval_metrics"],
        "records": dict(counters.total_records),
        "failed_records": dict(counters.failed_records),
        "rpcs": a["rpcs"], "rpcs_per_step": rpcs_total / max(1, steps),
        "worker": {**worker_times, "job_wall_s": a["wall_s"],
                   "job_examples_per_s": WORKER_RECORDS / a["wall_s"]},
        "local": {**local_times, "job_wall_s": local_wall,
                  "executor_examples_per_s":
                      local_result["examples_per_sec"]},
    }
    print("worker in process", json.dumps(out_a), flush=True)
    want = {k: 0 for k in a["counts"]}
    want.update(lookup_combine=steps + rounds * eval_batches,
                row_update=steps, row_update_adagrad=steps)
    check(a["counts"] == want,
          f"worker launches {a['counts']}, not {want}")
    check(out_a["steps"] == steps and out_a["losses_bit_equal"],
          "worker vs Local losses differ: "
          f"{a['loss']} against {local_loss}")
    check(out_a["table_bit_equal"] and out_a["accumulator_bit_equal"],
          "worker vs Local tables differ")
    check(out_a["untouched_bit_equal"], "an untouched row or slot moved")
    check(sorted(results) == [WORKER_EVAL_STEPS * (i + 1)
                              for i in range(rounds)]
          and results[steps] == local_result["eval_metrics"],
          f"master eval {results} against Local "
          f"{local_result['eval_metrics']}")
    check(out_a["records"] == {
        TaskType.TRAINING: WORKER_RECORDS,
        TaskType.EVALUATION: rounds * WORKER_EVAL_RECORDS}
        and not out_a["failed_records"],
        f"dispatcher counters {out_a['records']}")
    del l_table, l_acc
    a_job = dict(zoo=zoo, model_def=model_def, train=train, evalf=evalf,
                 results=results, loss=a["loss"], counts=a["counts"],
                 tasks=[t for t in a["tasks"]
                        if t and t["type"] == "training"],
                 table=table, acc=acc, out=out_a,
                 dataset_fn=a["cluster"].spec.dataset_fn)
    return out_a, a_job


def worker_failed_task_part(torch, fa, pe, a_job):
    """(b) (a)'s job with the first batch of task 2 failing once."""
    spec_dataset_fn = a_job["dataset_fn"]
    calls = {"n": 0}

    def flaky(records, mode, metadata):
        if mode == "training":
            calls["n"] += 1
            if calls["n"] == WORKER_FAIL_AT_BATCH:
                raise RuntimeError("injected dataset_fn failure")
        return spec_dataset_fn(records, mode, metadata)

    a_loss, a_counts, a_tasks = (a_job["loss"], a_job["counts"],
                                 a_job["tasks"])
    table, acc, out_a = a_job["table"], a_job["acc"], a_job["out"]
    b = worker_cluster_run(torch, fa, pe, a_job["zoo"], a_job["model_def"],
                           a_job["train"], a_job["evalf"], DEVICE,
                           EMB_BATCH, dataset_fn=flaky)
    b_state = b["worker"].state
    b_train = [t for t in b["tasks"] if t and t["type"] == "training"]
    span = [(t["start"], t["end"]) for t in b_train]
    b_counters = b["cluster"].dispatcher.counters
    out_b = {
        "tasks_pulled": b["tasks"], "launches": b["counts"],
        "losses_bit_equal": b["loss"] == a_loss,
        "table_bit_equal": bool(torch.equal(
            b_state.tables[RECSYS_TABLE], table)),
        "accumulator_bit_equal": bool(torch.equal(
            b_state.slot_tables[RECSYS_TABLE]["accumulator"], acc)),
        "records": dict(b_counters.total_records),
        "eval_results": {str(k): v for k, v in
                         b["cluster"].eval_service.completed_results.items()},
    }
    print("worker failed task", json.dumps(out_b), flush=True)
    # Task 2 was pulled, failed, and came back next, at the front.
    check(len(b_train) == len(a_tasks) + 1 and span[1] == span[2]
          and [s for i, s in enumerate(span) if i != 1]
          == [(t["start"], t["end"]) for t in a_tasks],
          f"failed task not re-queued at the front: {span}")
    check(out_b["losses_bit_equal"] and out_b["table_bit_equal"]
          and out_b["accumulator_bit_equal"],
          "the run with a failed task is not bit-equal to (a)")
    check(b["counts"] == a_counts,
          f"launches {b['counts']} against (a)'s {a_counts}")
    check(out_b["records"] == out_a["records"],
          f"dispatcher counters {out_b['records']}")
    check(out_b["eval_results"] == out_a["eval_results"],
          f"master eval {out_b['eval_results']}")
    return out_b


def worker_host_part(torch, fa, pe, root):
    """(c) deepfm_host through the worker: card against CPU with a
    synchronous runner, then the zoo's asynchronous runner on the
    card."""
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.native.row_store import NativeEmbeddingTable
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_frappe_record_file(
        os.path.join(root, "worker_host.rec"), WORKER_HOST_RECORDS,
        seed=SEED + 32, input_length=HOST_IDS, max_id=HOST_MAX_ID)
    zoo = write_zoo(root, "worker_host_sync", HOST_ZOO)
    runs = {}
    for dev in ("card", "cpu"):
        run = worker_cluster_run(torch, fa, pe, zoo,
                                 "worker_host_sync.rec.custom_model",
                                 records, "", DEVICE if dev == "card"
                                 else "cpu", HOST_BATCH)
        table = run["worker"]._step_runner.engine.tables[twin.TABLE_NAME]
        ids, rows = table.to_arrays()
        runs[dev] = dict(loss=run["loss"], counts=run["counts"],
                         table=table, ids=ids, rows=rows,
                         pull_ahead=run["worker"]._step_runner.pull_ahead)
    card, cpu = runs["card"], runs["cpu"]
    touched = np.unique(frappe_ids(WORKER_HOST_RECORDS, HOST_IDS,
                                   HOST_MAX_ID, SEED + 32))
    lazy = NativeEmbeddingTable(twin.TABLE_NAME, twin.EMBEDDING_DIM)
    initial = lazy.get(touched)
    rel = [abs(x - y) / abs(y) for x, y in zip(card["loss"], cpu["loss"])]
    delta_l2 = rel_err(card["rows"] - initial, cpu["rows"] - initial)
    untouched = np.setdiff1d(np.arange(HOST_MAX_ID), touched)[:64]
    untouched_equal = all(
        np.array_equal(r["table"].get(untouched), lazy.get(untouched))
        for r in runs.values())
    zoo_run = worker_cluster_run(
        torch, fa, pe, tdata.model_zoo_dir(),
        "deepfm.deepfm_host.custom_model", records, "", DEVICE, HOST_BATCH)
    steps = WORKER_HOST_RECORDS // HOST_BATCH
    out = {
        "model": "deepfm_host twin (5500 x 16 host table, SGD rows, bf16 "
                 "MLP, Adam), synchronous rows",
        "steps": len(card["loss"]),
        "losses_card": card["loss"], "losses_cpu": cpu["loss"],
        "loss_max_rel_diff": max(rel), "rows_delta_l2": delta_l2,
        "touched_rows": int(touched.size),
        "untouched_bit_equal": untouched_equal,
        "launches_card": card["counts"], "launches_cpu": cpu["counts"],
        "async": {"pull_ahead": zoo_run["worker"]._step_runner.pull_ahead,
                  "losses": zoo_run["loss"],
                  "launches": zoo_run["counts"],
                  "records": dict(zoo_run["cluster"].dispatcher
                                  .counters.total_records)},
        "tol": HOST_TOL,
    }
    print("worker host tier", json.dumps(out), flush=True)
    check(len(card["loss"]) == len(cpu["loss"]) == steps,
          f"{len(card['loss'])} / {len(cpu['loss'])} host steps")
    check(not card["pull_ahead"] and not cpu["pull_ahead"],
          "the synchronous runner pulled ahead")
    check(all(np.array_equal(r["ids"], touched) for r in runs.values()),
          "the host table's rows are not the ids the batches touched")
    check(untouched_equal, "an untouched row is not its lazy initial value")
    check(max(rel) <= HOST_TOL["loss"], f"card vs CPU losses {out}")
    check(delta_l2 <= HOST_TOL["delta_l2"], f"card vs CPU rows {out}")
    for name, counts in (("card", card["counts"]), ("cpu", cpu["counts"]),
                         ("async", zoo_run["counts"])):
        check(not any(v for k, v in counts.items()),
              f"the host path ({name}) launched kernels: {counts}")
    check(out["async"]["pull_ahead"] and len(zoo_run["loss"]) == steps
          and all(np.isfinite(zoo_run["loss"]))
          and out["async"]["records"] == {"training": WORKER_HOST_RECORDS},
          f"the asynchronous runner through the worker: {out['async']}")
    return out


def worker_wire_start(root, a_job):
    """(d), first half: the port's Master in this process over (a)'s
    records, and the port's worker.main started in a subprocess on the
    card, over localhost gRPC; None (and a line saying so) when there is
    no grpc module. The subprocess starts while (b) and (c) run here."""
    import importlib.util

    if importlib.util.find_spec("grpc") is None:
        print("worker wire: not run, no grpc module on this machine",
              flush=True)
        return None
    master, flags, order = wire_layout(root, a_job)
    # The first task the worker pulls starts its training clock.
    pulls = []
    get_task = master.servicer.get_task

    def timed_get_task(request):
        pulls.append(time.monotonic())
        return get_task(request)

    master.servicer.get_task = timed_get_task
    master.prepare()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH", "")) if p)
    log = open(os.path.join(root, "worker_wire.log"), "w+")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
         "--worker_id", "0", "--master_addr", f"localhost:{master.port}",
         "--device", DEVICE] + flags,
        env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT)
    return dict(master=master, proc=proc, log=log, t0=t0, order=order,
                pulls=pulls, flags=flags)


def wire_layout(root, a_job):
    """(a)'s records laid out so that the master's seeded shuffle hands
    them out in (a)'s order: the port's Master over them (not started),
    the job's flags, the training tasks in dispatch order."""
    from elasticdl_tpu_torch.common.args import build_parser
    from elasticdl_tpu_torch.common.constants import TaskType
    from elasticdl_tpu_torch.data.record_file import (
        RecordFileScanner,
        RecordFileWriter,
    )
    from elasticdl_tpu_torch.master.main import Master

    with RecordFileScanner(a_job["train"]) as scanner:
        payloads = list(scanner)
    wire_train = os.path.join(root, "worker_wire_train.rec")
    with RecordFileWriter(wire_train) as writer:
        for payload in payloads:
            writer.write(payload)
    flags = ["--model_zoo", a_job["zoo"], "--model_def", a_job["model_def"],
             "--training_data", wire_train,
             "--validation_data", a_job["evalf"],
             "--minibatch_size", str(EMB_BATCH),
             "--num_minibatches_per_task", str(WORKER_TASK_BATCHES),
             "--random_seed", str(SEED)]
    master = Master(build_parser("master").parse_args(
        flags + ["--evaluation_steps", str(WORKER_EVAL_STEPS),
                 "--master_addr", "localhost:0"]))
    # The master's dispatcher shuffles its tasks (seed 0): lay the
    # records out so that the i-th task it hands out reads (a)'s i-th
    # span of records.
    order = [t for t in master.task_dispatcher.export_state()["todo"]
             if t["type"] == TaskType.TRAINING]
    per_task = EMB_BATCH * WORKER_TASK_BATCHES
    layout = [None] * len(payloads)
    for i, task in enumerate(order):
        layout[task["start"]:task["end"]] = \
            payloads[i * per_task:(i + 1) * per_task]
    with RecordFileWriter(wire_train) as writer:
        for payload in layout:
            writer.write(payload)
    return master, flags, order


def worker_wire_finish(wire, want, failed=False):
    """(d), second half: wait for the worker, stop the master, hold the
    master's eval results to (a)'s. With ``failed`` (a part in between
    raised) it only stops both."""
    from elasticdl_tpu_torch.common.constants import TaskType

    if wire is None:
        return {"run": False, "reason": "no grpc module"}
    master, proc = wire["master"], wire["proc"]
    try:
        if failed:
            proc.kill()
        proc.wait(timeout=300)
        wall = time.monotonic() - wire["t0"]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        master.stop()
        wire["log"].seek(0)
        output = wire["log"].read()
        wire["log"].close()
    if failed:
        return None
    results = master.evaluation_service.completed_results
    pulls = wire["pulls"]
    train_s = wall - (pulls[0] - wire["t0"]) if pulls else None
    out = {
        "run": True, "task_order": [(t["start"], t["end"])
                                    for t in wire["order"]],
        "worker_exit": proc.returncode,
        "wall_s": wall, "from_first_task_s": train_s,
        "to_last_get_task_s": pulls[-1] - wire["t0"] if pulls else None,
        "examples_per_s_from_first_task": (
            WORKER_RECORDS / train_s if train_s else None),
        "get_task_calls": len(pulls),
        "finished": master.task_dispatcher.finished(),
        "records": dict(master.task_dispatcher.counters.total_records),
        "eval_results": {str(k): v for k, v in results.items()},
    }
    print("worker wire", json.dumps(out), flush=True)
    check(proc.returncode == 0,
          f"worker.main exited {proc.returncode}: {output[-3000:]}")
    check(out["finished"] and out["records"][TaskType.TRAINING]
          == WORKER_RECORDS, f"the wire job did not drain: {out}")
    check(results == want,
          f"master eval over the wire {results} against (a)'s {want}")
    return out


# (e): (d)'s job through a journaled primary ``master.main`` and a
# ``--standby`` on one journal directory, and a cold relaunch; every
# process starts before (a) and imports while it runs, behind a go file
# that carries its argv (JSON) when the run reaches it. The worker
# subprocess runs this wrapper around ``worker.main``'s entry point,
# which also makes its CUDA context while it waits. It holds its first
# training task's report (and then its first evaluation task's, after
# the task's fold went in) at a pause: it writes ``<pause>.at`` and waits
# for ``<pause>.go``, so each SIGKILL lands on a known state. It times
# every master RPC and prints its kernel launches and those times as its
# last line.
FAILOVER_WORKER = """\
import json, os, sys, time
import torch
from elasticdl_tpu_torch.ops import flash_attention as fa
from elasticdl_tpu_torch.ops import pallas_embedding as pe
from elasticdl_tpu_torch.worker import main as worker_main
from elasticdl_tpu_torch.worker import master_client as mc

if torch.cuda.is_available():
    torch.zeros(1, device="cuda")
while not os.path.exists(sys.argv[3]):
    time.sleep(0.005)
with open(sys.argv[3]) as fh:
    argv = json.load(fh)
pauses = {"training": sys.argv[1], "evaluation": sys.argv[2]}
kinds, rpcs = {}, []
get_task = mc.MasterClient.get_task
report = mc.MasterClient.report_task_result


def timed(name, fn):
    def call(self, *args, **kwargs):
        try:
            out = fn(self, *args, **kwargs)
        except Exception:
            rpcs.append([name, time.monotonic(), False, None, None])
            raise
        kind = (out[0].type if name == "get_task" and out[0] is not None
                else None)
        rpcs.append([name, time.monotonic(), True, self.last_generation,
                     kind])
        return out
    return call


def pulled(self, *args, **kwargs):
    task, finished = get_task(self, *args, **kwargs)
    if task is not None:
        kinds[task.task_id] = task.type
    return task, finished


def held(self, task_id, *args, **kwargs):
    pause = pauses.pop(kinds.get(task_id), None)
    if pause:
        open(pause + ".at", "w").close()
        while not os.path.exists(pause + ".go"):
            time.sleep(0.005)
    return report(self, task_id, *args, **kwargs)


mc.MasterClient.get_task = timed("get_task", pulled)
mc.MasterClient.report_task_result = timed("report_task_result", held)
code = worker_main.main(argv)
print(json.dumps({"launches": {
    "flash_attention_fwd": fa.launches,
    "flash_chunk_update": fa.chunk_launches,
    "flash_attention_bwd_dq": fa.dq_launches,
    "flash_attention_bwd_dkv": fa.dkv_launches,
    "lookup_combine": pe.lookup_launches,
    "lookup_combine_aligned": pe.aligned_launches,
    "row_update": pe.row_update_launches,
    "row_update_adagrad": pe.row_update_rule_launches["adagrad"],
    "fused_row_update": pe.fused_launches}, "rpcs": rpcs}), flush=True)
sys.exit(code or 0)
"""
# The master's main behind a go file: the process imports the package
# at once and runs ``main`` on the argv the file holds when it appears.
WAITING_MASTER = (
    "import json, os, sys, time\n"
    "from elasticdl_tpu_torch.master import main as master_main\n"
    "while not os.path.exists(sys.argv[1]):\n"
    "    time.sleep(0.005)\n"
    "with open(sys.argv[1]) as fh:\n"
    "    argv = json.load(fh)\n"
    "sys.exit(master_main.main(argv))\n")
FAILOVER_HEARTBEAT_S, FAILOVER_MISSES = 0.2, 2


def go_with(path, argv):
    """A go file carrying ``argv`` (written whole, then renamed)."""
    with open(path + ".tmp", "w") as fh:
        json.dump(argv, fh)
    os.replace(path + ".tmp", path)


def free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def wait_for(cond, what, timeout=240.0, procs=()):
    deadline = time.monotonic() + timeout
    while not cond():
        for proc, log in procs:
            check(proc.poll() is None,
                  f"{what}: a process exited early: {log_text(log)[-3000:]}")
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.005)


def journal_view(path):
    """What the journal at ``path`` says now: the leased tasks by type
    (dispatched, not reported), the open eval round's folds, the highest
    generation."""
    from elasticdl_tpu_torch.master.journal import read_records

    leased, folds, generation, open_round = {}, [], -1, False
    for _o, _e, rec in read_records(path):
        if rec["t"] == "dispatch":
            leased[rec["task_id"]] = rec["task"]["type"]
        elif rec["t"] == "report":
            leased.pop(rec["task_id"], None)
        elif rec["t"] == "generation":
            generation = max(generation, rec["generation"])
        elif rec["t"] == "eval_round":
            open_round = rec["event"] == "open"
            folds = []
        elif rec["t"] == "eval_fold":
            folds.append(rec["task_id"])
    return dict(leased=leased, folds=folds if open_round else [],
                open_round=open_round, generation=generation)


def worker_failover_prestart(root):
    """(e), before (a): the primary, the standby, the cold relaunch and
    the worker wrapper start importing behind their go files. None when
    there is no grpc module ((d) and (e) do not run)."""
    import importlib.util

    if importlib.util.find_spec("grpc") is None:
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH", "")) if p)
    base = os.path.join(root, "failover")
    os.makedirs(base)
    wrapper = os.path.join(base, "failover_worker.py")
    with open(wrapper, "w") as fh:
        fh.write(FAILOVER_WORKER)
    logs, procs = {}, {}
    for name in ("primary", "standby", "relaunch", "worker"):
        logs[name] = open(os.path.join(base, f"{name}.log"), "w+")
        entry = (["-c", WAITING_MASTER] if name != "worker" else
                 [wrapper, os.path.join(base, "lease"),
                  os.path.join(base, "fold")])
        procs[name] = subprocess.Popen(
            [sys.executable, *entry, os.path.join(base, f"{name}.go")],
            env=env, cwd=root, stdout=logs[name], stderr=subprocess.STDOUT)
    return dict(procs=procs, logs=logs, base=base, kills={}, error=None)


def worker_failover_start(fo, wire_flags):
    """(e), first half: the go files of the primary and the worker (over
    (d)'s records and flags), then a thread that starts the standby once
    the primary serves, kills at the worker's pauses and lets the
    relaunch go."""
    if fo is None:
        return None
    procs, logs, base = fo["procs"], fo["logs"], fo["base"]
    journal_dir = os.path.join(base, "journal")
    p1, p2 = free_ports(2)
    flags = wire_flags + ["--journal_dir", journal_dir,
                          "--evaluation_steps", str(WORKER_EVAL_STEPS)]
    go_standby = os.path.join(base, "standby.go")
    go_relaunch = os.path.join(base, "relaunch.go")
    fo.update(journal_dir=journal_dir, flags=flags, t0=time.monotonic())
    go_with(os.path.join(base, "primary.go"),
            flags + ["--master_addr", f"localhost:{p1}"])
    go_with(os.path.join(base, "worker.go"), [
        "--worker_id", "0", "--device", DEVICE,
        "--master_addr", f"localhost:{p1},localhost:{p2}",
        "--master_reattach_grace", "120", *wire_flags])

    def choreography():
        journal = os.path.join(journal_dir, "journal.log")
        watch = [(procs["worker"], logs["worker"])]
        wait_for(lambda: "Master RPC serving" in log_text(logs["primary"]),
                 "the primary to serve", procs=watch)
        go_with(go_standby, flags + [
            "--standby", "--master_addr", f"localhost:{p2}",
            "--primary_addr", f"localhost:{p1}",
            "--standby_heartbeat_secs", str(FAILOVER_HEARTBEAT_S),
            "--standby_miss_threshold", str(FAILOVER_MISSES)])
        wait_for(lambda: "standby: heartbeating" in log_text(
            logs["standby"]), "the standby to tail", procs=watch)
        # Kill 1: the primary, while the worker holds a training task.
        wait_for(lambda: os.path.exists(os.path.join(base, "lease.at")),
                 "the worker to hold a training lease", procs=watch)
        view = journal_view(journal)
        check("training" in view["leased"].values(),
              f"no training task leased at kill 1: {view}")
        fo["kills"]["primary"] = dict(t=time.monotonic(), journal=view)
        procs["primary"].kill()
        procs["primary"].wait()
        go(os.path.join(base, "lease.go"))
        # Kill 2: the promoted standby, with the eval round open and the
        # worker's fold in; the cold relaunch takes the primary's port.
        wait_for(lambda: os.path.exists(os.path.join(base, "fold.at")),
                 "the worker to hold a folded evaluation task",
                 procs=watch + [(procs["standby"], logs["standby"])])
        view = journal_view(journal)
        check(view["generation"] == 1 and view["open_round"]
              and view["folds"]
              and "evaluation" in view["leased"].values(),
              f"no open round with a fold in at kill 2: {view}")
        fo["kills"]["standby"] = dict(t=time.monotonic(), journal=view)
        procs["standby"].kill()
        procs["standby"].wait()
        go_with(go_relaunch, flags + ["--master_addr", f"localhost:{p1}"])
        go(os.path.join(base, "fold.go"))

    def run():
        try:
            choreography()
        except BaseException as exc:  # re-raised by the finish
            fo["error"] = exc

    fo["thread"] = threading.Thread(target=run, daemon=True)
    fo["thread"].start()
    return fo


def worker_failover_finish(fo, a_job, want_counts, failed=False):
    """(e), second half: wait for the worker and the relaunch, then hold
    the final journal (recovered into a fresh dispatcher here), its fsck,
    its generation, the master's eval results and the worker's launches.
    With ``failed`` it only stops every process."""
    from elasticdl_tpu_torch.common.args import parse_master_args
    from elasticdl_tpu_torch.common.constants import TaskType
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.master.journal import MasterJournal, apply_replay
    from elasticdl_tpu_torch.master.main import build_dispatcher
    from elasticdl_tpu_torch.tools.check_journal import check_journal

    if fo is None:
        return {"run": False, "reason": "no grpc module"}
    procs, logs = fo["procs"], fo["logs"]
    try:
        if not failed:
            check("thread" in fo, "(e) never started")
            fo["thread"].join(timeout=300)
            check(not fo["thread"].is_alive(), "the kills never happened")
            if fo["error"] is not None:
                raise fo["error"]
            check(procs["worker"].wait(timeout=300) == 0,
                  "the failover worker exited "
                  f"{procs['worker'].returncode}: "
                  f"{log_text(logs['worker'])[-3000:]}")
            # The relaunch exits at its run loop's next 5 s tick; every
            # report is journaled before its reply left, so it is
            # stopped here unless it already ended (and then cleanly).
            check(procs["relaunch"].poll() in (None, 0),
                  "the relaunched master exited "
                  f"{procs['relaunch'].returncode}: "
                  f"{log_text(logs['relaunch'])[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    texts = {name: log_text(log) for name, log in logs.items()}
    for log in logs.values():
        log.close()
    if failed:
        return None
    worker_out = json.loads(texts["worker"].strip().splitlines()[-1])
    # From (e)'s go to the worker's last master RPC (the get_task that
    # said the job is finished): one clock, CLOCK_MONOTONIC, across the
    # processes.
    wall = worker_out["rpcs"][-1][1] - fo["t0"]
    args = parse_master_args(fo["flags"])
    spec = get_model_spec(args.model_zoo, args.model_def, device="cpu")
    dispatcher = build_dispatcher(args, spec)
    carry = apply_replay(dispatcher,
                         MasterJournal(fo["journal_dir"]).replay_records())
    resolved = dispatcher.export_state()["resolved"]
    spans = sorted((t["start"], t["end"]) for _i, t, _w, _r in resolved
                   if t and t["type"] == TaskType.TRAINING)
    per_task = EMB_BATCH * WORKER_TASK_BATCHES
    problems = check_journal(fo["journal_dir"])
    results = carry["eval"]["results"]
    rpcs = worker_out["rpcs"]

    def first_after(t, gen, task=False):
        for name, at, ok, seen, kind in rpcs:
            if at > t and ok and seen == gen and (
                    not task or kind not in (None, TaskType.WAIT)):
                return at - t
        return None

    downtimes = {}
    for gen, (name, kill) in enumerate(sorted(
            fo["kills"].items(), key=lambda kv: kv[1]["t"]), start=1):
        downtimes[name] = {
            "kill_to_first_ack_s": first_after(kill["t"], gen),
            "kill_to_first_task_s": first_after(kill["t"], gen, task=True),
            "journal_at_kill": kill["journal"]}
    import re

    replay = re.search(r"(\d+) record\(s\) replayed .*in ([0-9.]+) s",
                       texts["relaunch"])
    out = {
        "run": True, "wall_s": wall,
        "generation": carry["generation"],
        "finished": dispatcher.finished(),
        "records": dict(dispatcher.counters.total_records),
        "training_spans": len(spans),
        "resolved_unique": len({r[0] for r in resolved}) == len(resolved),
        "check_journal": problems,
        "eval_results": {str(k): v for k, v in results.items()},
        "launches": worker_out["launches"],
        "downtimes": downtimes,
        "cold_replay": {"records": int(replay.group(1)),
                        "seconds": float(replay.group(2))} if replay
        else None,
        "takeover_log": [line for line in texts["standby"].splitlines()
                         if "taking over" in line],
    }
    print("worker failover", json.dumps(out, default=str), flush=True)
    check(out["generation"] == 2, f"final generation {out['generation']}")
    check(out["finished"] and out["resolved_unique"]
          and out["records"][TaskType.TRAINING] == WORKER_RECORDS
          and spans == [(s, s + per_task)
                        for s in range(0, WORKER_RECORDS, per_task)],
          f"the failover job's accounting: {out}")
    check(problems == [], f"check_journal: {problems}")
    check(results == a_job["results"],
          f"master eval after two kills {results} against (a)'s "
          f"{a_job['results']}")
    check(out["launches"] == want_counts,
          f"failover worker launches {out['launches']}, not {want_counts}")
    check(replay is not None and all(
        d["kill_to_first_task_s"] is not None for d in downtimes.values()),
        f"a takeover left no trace: {out}")
    return out


def worker_phase(torch, fa, pe, root):
    """The task plane on the card: the recsys twin through the worker
    in process against Local, a failed task, deepfm_host through the
    worker, the worker over gRPC, and the same job through a primary, a
    standby and a cold relaunch with two SIGKILLs ((d)'s worker started
    after (a), (e)'s processes before it, importing behind go files; both
    jobs run while (b) and (c) run here)."""
    t0 = time.monotonic()
    fo = worker_failover_prestart(root)
    try:
        out_a, a_job = worker_recsys_part(torch, fa, pe, root)
    except BaseException:
        worker_failover_finish(fo, None, None, failed=True)
        raise
    out = {"in_process": out_a}
    torch.cuda.empty_cache()
    wire = None
    try:
        wire = worker_wire_start(root, a_job)
        worker_failover_start(fo, wire and wire["flags"])
        out["failed_task"] = worker_failed_task_part(torch, fa, pe, a_job)
        out["host"] = worker_host_part(torch, fa, pe, root)
    except BaseException:
        worker_wire_finish(wire, None, failed=True)
        worker_failover_finish(fo, a_job, None, failed=True)
        raise
    try:
        out["wire"] = worker_wire_finish(wire, a_job["results"])
    except BaseException:
        worker_failover_finish(fo, a_job, None, failed=True)
        raise
    out["failover"] = worker_failover_finish(fo, a_job, a_job["counts"])
    out["seconds"] = time.monotonic() - t0
    out["card"] = smi("name,power.limit")
    return out


def journal_append_times(root, appends=200):
    """One journal append (flock, fence check, write, flush, fsync) and
    the bare write + fsync of a frame of the same size, p50/p99 in ms,
    on this host's disk under ``root``."""
    from elasticdl_tpu_torch.master.journal import MasterJournal

    journal = MasterJournal(os.path.join(root, "fsync_journal"))
    journal.open_generation()
    append_ms, fsync_ms = [], []
    for i in range(appends):
        t = time.perf_counter()
        journal.append("version", model_version=i)
        append_ms.append((time.perf_counter() - t) * 1e3)
    journal.close()
    frame = os.path.getsize(journal.path) // (appends + 1)
    with open(os.path.join(root, "fsync_probe"), "ab") as fh:
        for _ in range(appends):
            t = time.perf_counter()
            fh.write(b"x" * frame)
            fh.flush()
            os.fsync(fh.fileno())
            fsync_ms.append((time.perf_counter() - t) * 1e3)

    def p(xs):
        return {"p50": float(np.percentile(xs, 50)),
                "p99": float(np.percentile(xs, 99)), "n": len(xs)}

    return {"append_ms": p(append_ms), "write_fsync_ms": p(fsync_ms),
            "frame_bytes": frame, "card": smi("name,power.limit")}


def failover_phase(torch, fa, pe, root):
    """``--phase failover``: (a) for its results and launches, (e) alone,
    the port's failover drill (twin, standby and restart-and-replay runs
    and their gates), and one journal append's times on this host."""
    from elasticdl_tpu_torch.chaos import failover_drill

    fo = worker_failover_prestart(root)
    try:
        out_a, a_job = worker_recsys_part(torch, fa, pe, root)
        torch.cuda.empty_cache()
        master, flags, _order = wire_layout(root, a_job)
        master.stop()
        worker_failover_start(fo, flags)
    except BaseException:
        worker_failover_finish(fo, None, None, failed=True)
        raise
    out = {"failover": worker_failover_finish(fo, a_job, a_job["counts"]),
           "in_process_wall_s": out_a["worker"]["job_wall_s"]}
    workdir = os.path.join(root, "drill")
    t = time.monotonic()
    code = failover_drill.main(["run", "--workdir", workdir])
    with open(os.path.join(workdir, "failover_drill.json")) as fh:
        report = json.load(fh)

    def scenario(run):
        return [{"scenario": f["scenario"],
                 "downtime_s": f.get("downtime_secs"),
                 "recovery": f.get("recovery")}
                for f in report[run]["failovers"]]

    drill = {
        "passed": report["passed"], "exit": code,
        "problems": report["problems"], "seconds": time.monotonic() - t,
        "downtime": report.get("downtime"),
        "standby_downtimes_s": report["standby"]["downtimes_secs"],
        "restart_downtimes_s": report["restart"]["downtimes_secs"],
        "standby_failovers": scenario("standby"),
        "restart_failovers": scenario("restart"),
        "fsck": {run: report[run]["fsck"]
                 for run in ("twin", "standby", "restart")},
        "zombie": report["standby"].get("zombie"),
    }
    print("failover drill", json.dumps(drill, default=str), flush=True)
    check(code == 0 and report["passed"],
          f"the failover drill's gates: {report['problems']}")
    out["drill"] = drill
    out["journal_append"] = journal_append_times(root)
    out["card"] = smi("name,power.limit")
    return out


def remote_sync_runner(addr):
    """A runner factory: the zoo's deepfm_host rows behind the row
    service at ``addr`` (one address or a comma list of shards), applied
    synchronously."""
    from elasticdl_tpu_torch.embedding.host_engine import HostStepRunner
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin

    return lambda: HostStepRunner(make_remote_engine(
        addr, id_keys={twin.TABLE_NAME: twin.FEATURE_KEY}),
        async_apply=False)


# The row service's main behind a go file: the process imports the
# package (torch with it) at once and calls ``main`` when the file
# appears, so a relaunch that must wait for its predecessor's death
# boots while earlier work runs.
WAITING_MAIN = (
    "import os, sys, time\n"
    "from elasticdl_tpu_torch.embedding import row_service\n"
    "while not os.path.exists(sys.argv[1]):\n"
    "    time.sleep(0.01)\n"
    "row_service.main(sys.argv[2:])\n")


def row_service_main(root, zoo, model_def, log_name, extra=(), go=None):
    """``python -m elasticdl_tpu_torch.embedding.row_service`` in a
    subprocess on localhost:0: (process, log file). ``service_port``
    waits for the port it logs. With ``go`` (a path) the process imports
    the package now and runs ``main`` once the path exists."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, env.get("PYTHONPATH", "")) if p)
    log = open(os.path.join(root, log_name), "w+")
    entry = (["-m", "elasticdl_tpu_torch.embedding.row_service"]
             if go is None else ["-c", WAITING_MAIN, go])
    proc = subprocess.Popen(
        [sys.executable, *entry,
         "--model_zoo", zoo, "--model_def", model_def,
         "--addr", "localhost:0", *extra],
        env=env, cwd=root, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def go(path):
    with open(path, "w"):
        pass


def service_port(proc, log, timeout=120.0):
    """The port a row-service subprocess logged, and its log so far."""
    import re

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        log.seek(0)
        text = log.read()
        found = re.search(r"Row service on port (\d+)", text)
        if found:
            return int(found.group(1)), text
        check(proc.poll() is None, f"the row service exited: {text[-3000:]}")
        time.sleep(0.05)
    raise AssertionError("the row service did not report its port")


def stop_service(proc, log):
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()


def log_text(log):
    log.flush()
    log.seek(0)
    return log.read()


def service_metrics(log):
    """A row-service subprocess's ``/metrics`` (``--metrics_port 0``):
    {family: total} for counters and gauges, {family_bucket: {le:
    count}} for histograms."""
    import re

    port = re.search(r"/metrics serving on port (\d+)", log_text(log))
    check(port is not None, "the row service logged no /metrics port")
    with urllib.request.urlopen(
            f"http://localhost:{port.group(1)}/metrics", timeout=60) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        found = re.match(r'edl_tpu_(\w+?)(\{[^}]*\})? ([-+0-9.eE]+|NaN|'
                         r'[+-]Inf)$', line)
        if not found:
            continue
        name, labels, value = found.groups()
        if name.endswith("_bucket"):
            le = re.search(r'le="([^"]+)"', labels or "")
            out.setdefault(name, {})[le.group(1)] = float(value)
        else:
            out[name] = out.get(name, 0.0) + float(value)
    return out


def tier_readings(log):
    """The ``row_tier_*`` and ``row_push_log_*`` counters and gauges (and
    histogram sums and counts) of a row-service subprocess started with
    ``--metrics_port 0``."""
    return {k: v for k, v in service_metrics(log).items()
            if k.startswith(("row_tier_", "row_push_log_"))
            and not k.endswith("_bucket")}


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(base, f))
               for base, _, files in os.walk(path) for f in files)


def card_steps(record):
    """A row-service run's step ms (CUDA events, one-step windows after
    the first step) beside issue ms; None for a run of fewer than three
    steps or off the card."""
    if len(record.events) < 3:
        return None
    return step_times(record, HOST_BATCH, 1)


def rowservice_one_shard(torch, fa, pe, root, records):
    """(a) One worker on the card against one in-process service, held
    to the in-process synchronous runner on the same job."""
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.native.row_store import NativeEmbeddingTable
    from elasticdl_tpu_torch.testing import data as tdata

    zoo = write_zoo(root, "rowsvc_sync", HOST_ZOO)
    local = worker_cluster_run(torch, fa, pe, zoo,
                               "rowsvc_sync.rec.custom_model", records, "",
                               DEVICE, HOST_BATCH)
    svc = twin.make_row_service().start("localhost:0")
    addr = f"localhost:{svc.port}"
    remote = worker_cluster_run(
        torch, fa, pe, tdata.model_zoo_dir(), "deepfm.deepfm_host."
        "custom_model", records, "", DEVICE, HOST_BATCH,
        runner_factory=remote_sync_runner(addr))
    runner = remote["worker"]._step_runner
    local_tables = local["worker"]._step_runner.host_tables
    served = {n: v.to_arrays() for n, v in svc.host_tables.items()}
    unequal = [n for n, v in local_tables.items()
               if not all(np.array_equal(a, b) for a, b in
                          zip(v.to_arrays(), served[n]))]
    touched = np.unique(frappe_ids(ROWSVC_RECORDS, HOST_IDS, HOST_MAX_ID,
                                   SEED + 48))
    lazy = NativeEmbeddingTable(twin.TABLE_NAME, twin.EMBEDDING_DIM)
    untouched = np.setdiff1d(np.arange(HOST_MAX_ID), touched)[:64]
    untouched_equal = np.array_equal(
        runner.engine.tables[twin.TABLE_NAME].get(untouched),
        lazy.get(untouched))
    out = {
        "service": addr, "steps": len(remote["loss"]),
        "losses_service": remote["loss"], "losses_in_process": local["loss"],
        "losses_bit_equal": remote["loss"] == local["loss"],
        "tables_compared": sorted(local_tables),
        "tables_unequal": unequal,
        "touched_rows": int(touched.size),
        "service_rows": int(served[twin.TABLE_NAME][0].size),
        "untouched_bit_equal": untouched_equal,
        "remote_host_tables_none": runner.host_tables is None,
        "launches_service": remote["counts"],
        "launches_in_process": local["counts"],
        "worker_step": card_steps(remote["record"]),
        "in_process_step": card_steps(local["record"]),
        "wall_s": {"service": remote["wall_s"], "in_process": local["wall_s"]},
    }
    print("rowservice one shard", json.dumps(out), flush=True)
    check(len(local["loss"]) == ROWSVC_RECORDS // HOST_BATCH,
          f"{len(local['loss'])} steps")
    check(out["losses_bit_equal"], f"losses over the wire {out}")
    check(not unequal, f"the service's tables differ: {unequal}")
    check(np.array_equal(served[twin.TABLE_NAME][0], touched),
          "the service's rows are not the ids the batches touched")
    check(untouched_equal, "an untouched row is not its lazy initial value")
    check(out["remote_host_tables_none"],
          "the remote runner claims the service's rows")
    for name, counts in (("service", remote["counts"]),
                         ("in process", local["counts"])):
        check(not any(counts.values()),
              f"the row-service path ({name}) launched kernels: {counts}")
    return out, svc, served[twin.TABLE_NAME], remote["loss"]


def rowservice_two_shards(torch, fa, pe, records, one_svc, one_rows,
                          one_loss):
    """(b) The same job against two in-process shards."""
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.embedding.shard_map import ShardMap
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.testing import data as tdata

    shards = [twin.make_row_service().start("localhost:0")
              for _ in range(2)]
    try:
        addrs = [f"localhost:{s.port}" for s in shards]
        run = worker_cluster_run(
            torch, fa, pe, tdata.model_zoo_dir(), "deepfm.deepfm_host."
            "custom_model", records, "", DEVICE, HOST_BATCH,
            runner_factory=remote_sync_runner(",".join(addrs)))
        smap = ShardMap.bootstrap(addrs)
        per_shard = [s.host_tables[twin.TABLE_NAME].to_arrays()
                     for s in shards]
        placed = all(ids.size and (smap.home_of_ids(ids) == k).all()
                     for k, (ids, _) in enumerate(per_shard))
        ids = np.concatenate([i for i, _ in per_shard])
        rows = np.concatenate([r for _, r in per_shard])
        order = np.argsort(ids)
        gathered_equal = (np.array_equal(ids[order], one_rows[0])
                          and np.array_equal(rows[order], one_rows[1]))
        keys = {twin.TABLE_NAME: twin.FEATURE_KEY}
        t0 = time.monotonic()
        export_two = make_remote_engine(",".join(addrs), keys).tables[
            twin.TABLE_NAME].export_dense(HOST_MAX_ID)
        export_s = time.monotonic() - t0
        export_one = make_remote_engine(
            f"localhost:{one_svc.port}", keys).tables[
            twin.TABLE_NAME].export_dense(HOST_MAX_ID)
    finally:
        for s in shards:
            s.stop(0)
    out = {"shards": addrs, "rows_per_shard": [int(i.size)
                                               for i, _ in per_shard],
           "placed_by_map": bool(placed), "rows_equal_one_shard":
           gathered_equal, "losses_equal_one_shard": run["loss"] == one_loss,
           "export_equal_one_shard": bool(np.array_equal(export_two,
                                                         export_one)),
           "export_shape": list(export_two.shape), "export_s": export_s,
           "launches": run["counts"]}
    print("rowservice two shards", json.dumps(out), flush=True)
    check(placed, f"a row off its map home: {out}")
    check(gathered_equal and out["losses_equal_one_shard"],
          f"two shards against one: {out}")
    check(out["export_equal_one_shard"], "the two-shard export differs")
    check(not any(run["counts"].values()),
          f"the two-shard path launched kernels: {run['counts']}")
    return out, export_two


def rowservice_live_split(torch, fa, pe, root, records, one_loss,
                          export_two):
    """(h) (b)'s job on two in-process shards under a port
    ShardMapController (RPC transports, its state file under ``root``):
    after the worker's ROWSVC_H_SPLIT_AFTER-th push a thread splits shard
    0 onto a third service, and the worker's next step waits until the
    first chunk has shipped; the migration's chunk hook then holds the
    copy until that step's push has applied on the source, so a catch-up
    round ships it. Then the most-pulled ids
    get one read replica each and a fresh client reads them."""
    from elasticdl_tpu_torch.embedding import row_service as rs
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.master.row_reshard import (
        ReshardPolicy,
        ShardMapController,
    )
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.observability import default_registry
    from elasticdl_tpu_torch.testing import data as tdata
    from elasticdl_tpu_torch.tools.check_reshard import check_reshard

    t0 = time.monotonic()
    registry = default_registry()
    keys = {twin.TABLE_NAME: twin.FEATURE_KEY}
    shards = [twin.make_row_service().start("localhost:0")
              for _ in range(3)]
    addrs = [f"localhost:{s.port}" for s in shards]
    state = os.path.join(root, "rowsvc_h_shard_map.json")
    ctrl = ShardMapController(state, policy=ReshardPolicy(
        replica_top_k=ROWSVC_H_HOT, replica_min_pulls=1, replica_count=1))
    pushes = {"n": 0}
    pushed = threading.Condition()
    split = {}
    engines = []

    def run_split():
        try:
            split["stats"] = ctrl.split(0, new_addr=addrs[2])
        except BaseException as exc:  # noqa: BLE001 - checked below
            split["error"] = repr(exc)

    copying = threading.Event()

    def on_push():
        with pushed:
            pushes["n"] += 1
            pushed.notify_all()
        if pushes["n"] == ROWSVC_H_SPLIT_AFTER:
            split["thread"] = threading.Thread(target=run_split)
            split["thread"].start()
            # The worker's next step starts once the copy is under way.
            copying.wait(timeout=60)

    def hold_copy(_svc, _mig, _view, _chunk):
        # The first bulk chunk has shipped: let the worker go on, and
        # hold the copy until its next push has applied on the source,
        # so a catch-up round has rows to ship.
        if copying.is_set():
            return
        with pushed:
            at = pushes["n"]
            copying.set()
            pushed.wait_for(lambda: pushes["n"] > at, timeout=60)

    def factory():
        runner = remote_sync_runner(",".join(addrs[:2]))()
        opt = runner.engine.optimizer
        apply = opt.apply_gradients

        def counted(table, ids, grads):
            out = apply(table, ids, grads)
            on_push()
            return out

        opt.apply_gradients = counted
        engines.append(runner.engine)
        return runner

    rs.set_reshard_chaos_hooks(mid_migrate=hold_copy)
    try:
        ctrl.bootstrap(addrs[:2])
        reset_kernel_launches(fa, pe)         # (h) starts
        run = worker_cluster_run(
            torch, fa, pe, tdata.model_zoo_dir(), "deepfm.deepfm_host."
            "custom_model", records, "", DEVICE, HOST_BATCH,
            runner_factory=factory)
        split["thread"].join(timeout=120)
        stats = split.get("stats") or {}
        m = ctrl.map
        export = make_remote_engine(",".join(addrs), keys).tables[
            twin.TABLE_NAME].export_dense(HOST_MAX_ID)
        held = [s._tables[twin.TABLE_NAME].all_ids() for s in shards]
        one_home = all((m.home_of_ids(ids) == k).all()
                       for k, ids in enumerate(held))
        all_ids = np.concatenate(held)
        versions = [s._shard_map.version for s in shards]
        # The worker's client learns the cutover on its next pull (a
        # redirect, or the epoch piggybacked on the reply).
        worker_pull = engines[0].tables[twin.TABLE_NAME].get(
            np.sort(all_ids))
        fsck_errors, fsck = check_reshard(state)
        # Replicas for the most-pulled ids, then reads through them.
        reads0 = family_total(registry, "edl_tpu_row_replica_reads_total")
        stale0 = family_total(registry,
                              "edl_tpu_row_replica_staleness_seconds")
        designated = ctrl.update_replicas()
        per = ctrl.map.replicas.get(twin.TABLE_NAME, {})
        hot = np.array(sorted(per), np.int64)
        deadline = time.monotonic() + 30
        while not all(
                i in shards[r]._replica_store.get(twin.TABLE_NAME, {})
                for i, reps in per.items() for r in reps):
            check(time.monotonic() < deadline, "the replicas never warmed")
            time.sleep(0.005)
        reader = make_remote_engine(",".join(addrs), keys).tables[
            twin.TABLE_NAME]
        homes = ctrl.map.home_of_ids(hot)
        want = np.stack([shards[h]._tables[twin.TABLE_NAME].get([i])[0]
                         for i, h in zip(hot.tolist(), homes.tolist())])
        answers = [reader.get(hot) for _ in range(ROWSVC_H_READS)]
        counts = kernel_launch_counts(fa, pe)     # ... and ends
        replica_reads = family_total(
            registry, "edl_tpu_row_replica_reads_total") - reads0
        staleness = family_total(
            registry, "edl_tpu_row_replica_staleness_seconds") - stale0
    finally:
        rs.set_reshard_chaos_hooks(mid_migrate=None)
        ctrl.close()
        for s in shards:
            s.stop(0)
    out = {
        "shards": addrs, "split_after_push": ROWSVC_H_SPLIT_AFTER,
        "pushes": pushes["n"], "split_error": split.get("error"),
        "migration": stats, "map_version": m.version,
        "ranges": [list(r) for r in m.ranges],
        "service_versions": versions,
        "client_version": engines[0].shard_map.version if engines else None,
        "rows_per_shard": [int(i.size) for i in held],
        "one_home_each": bool(one_home),
        "unique_ids": bool(np.unique(all_ids).size == all_ids.size),
        "losses_equal_two_shards": run["loss"] == one_loss,
        "export_equal_two_shards": bool(np.array_equal(export, export_two)),
        "worker_pull_equal_export": bool(np.array_equal(
            worker_pull, export[np.sort(all_ids)])),
        "fsck_errors": fsck_errors,
        "migration_in_flight": fsck["migration_in_flight"],
        "replicas_designated": bool(designated),
        "replica_ids": hot.tolist(),
        "replica_map_version": ctrl.map.version,
        "replica_reads": replica_reads,
        "replica_refreshes_observed": staleness,
        "replica_answers_equal_home": all(
            np.array_equal(a, want) for a in answers),
        "launches": counts, "seconds": time.monotonic() - t0,
    }
    print("rowservice live split", json.dumps(out), flush=True)
    check(out["split_error"] is None and stats.get("rows", 0) > 0,
          f"the split: {out}")
    check(stats.get("catchup_rounds", 0) >= 1,
          f"no catch-up round shipped the racing push: {stats}")
    check(out["losses_equal_two_shards"] and out["export_equal_two_shards"]
          and out["worker_pull_equal_export"],
          f"the job through a live split differs from (b): {out}")
    check(one_home and out["unique_ids"],
          f"an id off its home after the split: {out['rows_per_shard']}")
    check(m.version == ROWSVC_H_VERSION
          and versions == [ROWSVC_H_VERSION] * 3
          and out["client_version"] == ROWSVC_H_VERSION,
          f"map versions after the split: {out}")
    check(not fsck_errors and not fsck["migration_in_flight"],
          f"the authority's state file: {fsck_errors}")
    check(designated and hot.size > 0 and replica_reads > 0
          and staleness > 0 and out["replica_answers_equal_home"],
          f"the replica reads: {out}")
    check(not any(counts.values()), f"(h) launched kernels: {counts}")
    return out


def rowservice_flags(root):
    """(c)'s service flags: checkpoints every ROWSVC_CKPT_STEPS pushes,
    a ROWSVC_HOT_BUDGET-row hot tier (cold rows in ``<ckpt>_cold``), a
    durably acked push log, and ``/metrics`` on an ephemeral port."""
    return ["--checkpoint_dir", os.path.join(root, "rowsvc_ckpt"),
            "--checkpoint_steps", str(ROWSVC_CKPT_STEPS),
            "--shard_id", "0", "--num_shards", "1",
            "--hot_budget_rows", str(ROWSVC_HOT_BUDGET),
            "--push_log_dir", os.path.join(root, "rowsvc_wal"),
            "--metrics_port", "0"]


def rowservice_start(root):
    """(c)'s service main and its two later incarnations, started in
    subprocesses ahead of their use: the first boots (the import of
    torch) while earlier work runs, the relaunch (after SIGTERM) and
    (f)'s third incarnation (after SIGKILL) import too and run main once
    their go files appear."""
    from elasticdl_tpu_torch import native
    from elasticdl_tpu_torch.testing import data as tdata

    native.get_lib()  # built here once, before the subprocess loads it
    out = dict(ckpt=os.path.join(root, "rowsvc_ckpt"),
               wal=os.path.join(root, "rowsvc_wal"))
    for name, log_name in (("first", "rowsvc_main.log"),
                           ("relaunch", "rowsvc_relaunch.log"),
                           ("third", "rowsvc_third.log")):
        go_file = (None if name == "first"
                   else os.path.join(root, f"rowsvc_{name}.go"))
        proc, log = row_service_main(
            root, tdata.model_zoo_dir(), "deepfm.deepfm_host.custom_model",
            log_name, rowservice_flags(root), go=go_file)
        out[name] = dict(proc=proc, log=log, go=go_file)
    return out


def rowservice_stop(service):
    for name in ("first", "relaunch", "third"):
        stop_service(service[name]["proc"], service[name]["log"])


def rowservice_shared_run(torch, fa, pe, root, records, service):
    """(c), first half: the started service shared by two workers on the
    card with the zoo's async runner, its tier readings, then SIGTERM,
    the drained version, and the relaunch's go file (it restores while
    (a) and (b) run)."""
    import signal

    from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.testing import data as tdata
    from elasticdl_tpu_torch.testing.cluster import MiniCluster

    proc, log = service["first"]["proc"], service["first"]["log"]
    port, _ = service_port(proc, log)
    addr = f"localhost:{port}"
    cluster = MiniCluster(
        tdata.model_zoo_dir(), "deepfm.deepfm_host.custom_model",
        training_data=records, minibatch_size=HOST_BATCH,
        num_minibatches_per_task=WORKER_TASK_BATCHES, num_workers=2,
        step_runner_factory=lambda: twin.make_host_runner(
            remote_addr=addr),
        device=DEVICE, random_seed=SEED)
    recorders = []
    for worker in cluster.workers:
        recorders.append(RecordingRunner(torch, worker._step_runner))
        worker._step_runner = recorders[-1]
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    reset_kernel_launches(fa, pe)             # the shared job starts
    t0 = time.monotonic()
    results = cluster.run()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = kernel_launch_counts(fa, pe)     # ... and ends
    table = make_remote_engine(
        addr, {twin.TABLE_NAME: twin.FEATURE_KEY}).tables[twin.TABLE_NAME]
    pushes = table.pull_version()
    touched = np.unique(frappe_ids(ROWSVC_C_RECORDS, HOST_IDS, HOST_MAX_ID,
                                   SEED + 64))
    live = table.get(touched)
    tiers = tier_readings(log)
    proc.send_signal(signal.SIGTERM)
    exit_code = proc.wait(timeout=120)
    stop_service(proc, log)
    saved = CheckpointSaver(service["ckpt"]).get_valid_latest_version()
    go(service["relaunch"]["go"])  # its imports are done
    out = {
        "service": addr, "workers": len(results),
        "trained_batches": [r["trained_batches"] for r in results],
        "records": dict(cluster.dispatcher.counters.total_records),
        "finished": cluster.finished,
        "losses": [float(x) for r in recorders for x in r.loss],
        "pushes": pushes, "touched_rows": int(touched.size),
        "sigterm_exit": exit_code, "saved_version": saved,
        "launches": counts, "wall_s": wall,
        "worker_steps": [card_steps(r) for r in recorders],
        "tiers": tiers, "hot_budget_rows": ROWSVC_HOT_BUDGET,
    }
    return out, dict(service["relaunch"], ckpt=service["ckpt"],
                     wal=service["wal"], touched=touched, live=live,
                     third=service["third"])


def rowservice_relaunch_check(out, relaunch):
    """(c), second half: the relaunched service restored the drained
    version and answers a pull with the saved rows bit for bit."""
    from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin

    touched, live = relaunch["touched"], relaunch["live"]
    _, _, embeddings = CheckpointSaver(relaunch["ckpt"]).restore()
    ids, rows = embeddings[twin.TABLE_NAME].to_arrays()
    t0 = time.monotonic()
    port, text = service_port(relaunch["proc"], relaunch["log"])
    again = make_remote_engine(
        f"localhost:{port}", {twin.TABLE_NAME: twin.FEATURE_KEY}).tables[
        twin.TABLE_NAME].get(touched)
    out.update({
        "relaunch_wait_s": time.monotonic() - t0,
        "restored_line": (f"Row service restored version "
                          f"{out['saved_version']}" in text),
        "checkpoint_rows_equal_live": bool(
            np.array_equal(ids, touched) and np.array_equal(rows, live)),
        "relaunch_pull_bit_equal": bool(np.array_equal(again, live)),
    })
    print("rowservice subprocess", json.dumps(out), flush=True)
    steps = -(-ROWSVC_C_RECORDS // HOST_BATCH)
    check(out["finished"] and sum(out["trained_batches"]) == steps
          and out["records"] == {"training": ROWSVC_C_RECORDS},
          f"the shared job did not drain: {out}")
    check(all(n > 0 for n in out["trained_batches"]),
          f"a worker took no task: {out['trained_batches']}")
    check(all(np.isfinite(out["losses"])), "non-finite loss")
    check(out["pushes"] == steps and touched.size > 0,
          f"{out['pushes']} pushes, {touched.size} rows on the service")
    check(out["sigterm_exit"] == 0 and out["saved_version"] == steps,
          f"SIGTERM exit {out['sigterm_exit']}, newest version "
          f"{out['saved_version']}, {out['pushes']} pushes")
    check(out["restored_line"] and out["checkpoint_rows_equal_live"]
          and out["relaunch_pull_bit_equal"],
          f"the relaunch did not restore the drained rows: {out}")
    check(not any(out["launches"].values()),
          f"the shared job launched kernels: {out['launches']}")
    tiers = out["tiers"]
    check(tiers.get("row_tier_hot_rows", 1e9) <= ROWSVC_HOT_BUDGET
          and tiers.get("row_tier_evictions_total", 0) > 0
          and tiers.get("row_tier_cold_rows", 0) > 0,
          f"the tiered service's readings: {tiers}")
    check(tiers.get("row_push_log_group_size_count", 0) > 0,
          f"the service logged no push: {tiers}")
    return out


def rowservice_kill_check(torch, fa, pe, relaunch):
    """(f) Through the relaunched service: ROWSVC_KILL_PUSHES durably
    acked pushes (versions 6 and 7), the touched rows read, SIGKILL; the
    port's fsck over the log; the third incarnation restores version 5,
    replays exactly those pushes and answers the pull bit for bit."""
    import signal

    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.tools.check_pushlog import check_one_log

    keys = {twin.TABLE_NAME: twin.FEATURE_KEY}
    touched, third = relaunch["touched"], relaunch["third"]
    port, _ = service_port(relaunch["proc"], relaunch["log"])
    engine = make_remote_engine(f"localhost:{port}", keys)
    table = engine.tables[twin.TABLE_NAME]
    rng = np.random.RandomState(SEED + 96)
    reset_kernel_launches(fa, pe)             # (f)'s pushes start
    t0 = time.monotonic()
    for _ in range(ROWSVC_KILL_PUSHES):
        ids = np.sort(rng.choice(touched, ROWSVC_KILL_IDS, replace=False))
        engine.optimizer.apply_gradients(
            table, ids, (rng.standard_normal((ids.size, twin.EMBEDDING_DIM))
                         * 1e-2).astype(np.float32))
    push_s = time.monotonic() - t0
    counts = kernel_launch_counts(fa, pe)     # ... and end
    pushes = table.pull_version()
    before = table.get(touched)
    relaunch["proc"].send_signal(signal.SIGKILL)
    relaunch["proc"].wait(timeout=60)
    errors, report = check_one_log(relaunch["wal"], relaunch["ckpt"])
    t0 = time.monotonic()
    go(third["go"])
    port, text = service_port(third["proc"], third["log"])
    start_s = time.monotonic() - t0
    again = make_remote_engine(f"localhost:{port}", keys).tables[
        twin.TABLE_NAME].get(touched)
    out = {
        "pushes": pushes, "push_s": push_s, "launches": counts,
        "fsck_errors": errors, "fsck": {k: report[k] for k in (
            "records", "first_version", "last_version", "checkpoint_tip",
            "torn_tail", "version_gaps")},
        "third_start_s": start_s,
        "restored_5": "Row service restored version 5" in text,
        "replayed_2": (f"replayed {ROWSVC_KILL_PUSHES} record(s) past "
                       f"checkpoint version 5") in text,
        "pull_bit_equal": bool(np.array_equal(again, before)),
        "changed_rows": int((before != relaunch["live"]).any(1).sum()),
    }
    print("rowservice sigkill", json.dumps(out), flush=True)
    check(pushes == ROWSVC_KILL_PUSHES,
          f"{pushes} pushes through the relaunch")
    check(not errors and report["last_version"] == 5 + ROWSVC_KILL_PUSHES
          and report["checkpoint_tip"] == 5,
          f"the push log's fsck: {errors} {report}")
    check(out["restored_5"] and out["replayed_2"],
          f"the third incarnation's log: {text[-3000:]}")
    check(out["pull_bit_equal"] and out["changed_rows"] > 0,
          f"the third incarnation lost acked pushes: {out}")
    check(not any(counts.values()), f"(f) launched kernels: {counts}")
    return out


def rowservice_times(torch, root):
    """(d) Pull and push at the recsys shape over localhost gRPC to the
    service's main in a subprocess, beside the in-process table's pull
    and apply on the same batches: median ms and MB/s, cold then warm.
    The in-process passes run once while the service boots (its import
    of torch beside them) and once on a fresh table after it has booted;
    the second is the one compared."""
    from elasticdl_tpu_torch.embedding.optimizer import Adagrad
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.native.row_store import (
        NativeEmbeddingTable,
        make_host_optimizer,
    )

    zoo = write_zoo(root, "rowsvc_bench", ROWSVC_BENCH_ZOO)
    proc, log = row_service_main(root, zoo, "rowsvc_bench.rec.custom_model",
                                 "rowsvc_bench.log")
    try:
        rng = np.random.RandomState(SEED + 5)
        batches = [
            (np.sort(rng.permutation(EMB_VOCAB)[:ROWSVC_TIMED_IDS]),
             (rng.standard_normal((ROWSVC_TIMED_IDS, EMB_DIM)) * 1e-3)
             .astype(np.float32))
            for _ in range(HOST_ENGINE_BATCHES)]
        mb = ROWSVC_TIMED_IDS * EMB_DIM * 4 / 1e6

        def run_pass(pull, push):
            ms = {"pull": [], "push": []}
            for ids, grads in batches:
                for name, fn, args in (("pull", pull, (ids,)),
                                       ("push", push, (ids, grads))):
                    t0 = time.perf_counter()
                    fn(*args)
                    ms[name].append((time.perf_counter() - t0) * 1e3)
            out = {}
            for name, values in ms.items():
                kept = values[HOST_ENGINE_SKIP:]
                median = float(np.median(kept))
                out[name] = {"ms_median": median,
                             "ms_range": [min(kept), max(kept)],
                             "mb_per_s": mb / (median / 1e3)}
            return out

        def in_process_passes():
            table = NativeEmbeddingTable(RECSYS_TABLE, EMB_DIM)
            opt = make_host_optimizer(Adagrad(lr=0.05))

            def push(ids, grads):
                opt.apply_gradients(table, ids, grads)

            return {"cold": run_pass(table.get, push),
                    "warm": run_pass(table.get, push)}

        during_boot = in_process_passes()
        port, _ = service_port(proc, log)
        in_process = in_process_passes()
        engine = make_remote_engine(f"localhost:{port}",
                                    {RECSYS_TABLE: "ids"})
        remote = engine.tables[RECSYS_TABLE]
        remote_push = lambda ids, g: engine.optimizer.apply_gradients(  # noqa: E731
            remote, ids, g)
        over_grpc = {"cold": run_pass(remote.get, remote_push),
                     "warm": run_pass(remote.get, remote_push)}
    finally:
        stop_service(proc, log)
    out = {"table": f"{EMB_VOCAB} x {EMB_DIM} f32, native, lazy, "
                    "Adagrad rows",
           "unique_ids": ROWSVC_TIMED_IDS, "mb_a_batch": mb,
           "batches": HOST_ENGINE_BATCHES, "skipped": HOST_ENGINE_SKIP,
           "over_grpc": over_grpc, "in_process": in_process,
           "in_process_during_boot": during_boot,
           "card": smi("name,power.limit")}
    print("rowservice times", json.dumps(out), flush=True)
    return out


def rowservice_step_times(torch, fa, pe, root, service):
    """(e) deepfm_host's step through one worker on the card over
    ROWSVC_STEP_BATCHES batches at HOST_BATCH: the rows in process or on
    ``service`` (the service's main in a subprocess), each with a
    synchronous and the zoo's asynchronous runner. Step ms (CUDA events,
    one-step windows after the first) beside issue ms."""
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_frappe_record_file(
        os.path.join(root, "rowsvc_steps.rec"),
        ROWSVC_STEP_BATCHES * HOST_BATCH, seed=SEED + 80,
        input_length=HOST_IDS, max_id=HOST_MAX_ID)
    sync_zoo = write_zoo(root, "rowsvc_sync", HOST_ZOO)
    port, _ = service_port(service["proc"], service["log"])
    addr = f"localhost:{port}"
    zoo, model_def = tdata.model_zoo_dir(), "deepfm.deepfm_host.custom_model"
    runs = {
        "in_process_sync": (sync_zoo, "rowsvc_sync.rec.custom_model", None),
        "in_process_async": (zoo, model_def, None),
        "service_sync": (zoo, model_def, remote_sync_runner(addr)),
        "service_async": (zoo, model_def,
                          lambda: twin.make_host_runner(remote_addr=addr)),
    }
    out = {"steps": ROWSVC_STEP_BATCHES, "batch": HOST_BATCH,
           "service": addr}
    for name, (run_zoo, run_def, factory) in runs.items():
        run = worker_cluster_run(torch, fa, pe, run_zoo, run_def, records,
                                 "", DEVICE, HOST_BATCH,
                                 runner_factory=factory)
        check(len(run["loss"]) == ROWSVC_STEP_BATCHES
              and all(np.isfinite(run["loss"])),
              f"{name}: {len(run['loss'])} steps, losses {run['loss']}")
        check(not any(run["counts"].values()),
              f"{name} launched kernels: {run['counts']}")
        out[name] = dict(card_steps(run["record"]), wall_s=run["wall_s"])
    print("rowservice step times", json.dumps(out), flush=True)
    return out


def tiered_schedule():
    """(g)'s batches: ROWSVC_TIMED_IDS ids drawn from a working set of
    ROWSVC_G_WORKING rows, ROWSVC_G_DRIFT of them replaced every
    ROWSVC_G_DRIFT_EVERY batches, plus ROWSVC_G_STRANGERS strangers
    (``tools/bench_tiered_store.py``'s schedule at the recsys shape)."""
    rng = np.random.RandomState(SEED + 13)
    working = rng.choice(EMB_VOCAB, ROWSVC_G_WORKING,
                         replace=False).astype(np.int64)
    out = []
    for b in range(ROWSVC_G_BATCHES):
        if b and b % ROWSVC_G_DRIFT_EVERY == 0:
            gone = rng.choice(ROWSVC_G_WORKING, ROWSVC_G_DRIFT,
                              replace=False)
            working[gone] = rng.randint(0, EMB_VOCAB, ROWSVC_G_DRIFT)
        take = rng.choice(working, ROWSVC_TIMED_IDS, replace=False)
        strangers = rng.randint(0, EMB_VOCAB, ROWSVC_G_STRANGERS)
        out.append(np.unique(np.concatenate([take, strangers]))
                   .astype(np.int64))
    return out


def tiered_grads(b, n):
    return (np.random.RandomState(SEED + 1000 + b).standard_normal(
        (n, EMB_DIM)) * 1e-3).astype(np.float32)


def rowservice_tiered_start(root):
    """(g)'s services (ROWSVC_G_SERVICES) on the rowsvc_bench zoo, each
    in its own directory, and the tiered durable one's relaunch behind a
    go file: all boot while (a)-(e) run."""
    zoo = write_zoo(root, "rowsvc_bench", ROWSVC_BENCH_ZOO)
    model_def = "rowsvc_bench.rec.custom_model"
    services = {}
    for name, (tiered, ack) in ROWSVC_G_SERVICES.items():
        base = os.path.join(root, f"rowsvc_g_{name}")
        flags = ["--metrics_port", "0"]
        if tiered:
            flags += ["--hot_budget_rows", str(ROWSVC_G_BUDGET),
                      "--cold_dir", os.path.join(base, "cold")]
        if ack:
            flags += ["--push_log_dir", os.path.join(base, "wal"),
                      "--push_log_ack", ack]
        proc, log = row_service_main(root, zoo, model_def,
                                     f"rowsvc_g_{name}.log", flags)
        services[name] = dict(proc=proc, log=log, base=base, flags=flags)
    flags = services["tiered_durable"]["flags"]
    go_file = os.path.join(root, "rowsvc_g_relaunch.go")
    proc, log = row_service_main(root, zoo, model_def,
                                 "rowsvc_g_relaunch.log", flags, go=go_file)
    return dict(services=services,
                relaunch=dict(proc=proc, log=log, go=go_file))


def rowservice_tiered_stop(g):
    for svc in list(g["services"].values()) + [g["relaunch"]]:
        stop_service(svc["proc"], svc["log"])


def _pull_all(table, ids, chunk=ROWSVC_TIMED_IDS):
    return np.concatenate([table.get(ids[lo:lo + chunk])
                           for lo in range(0, ids.size, chunk)])


def _log_seconds(text, first, last):
    """Seconds between the log lines holding ``first`` and ``last`` (the
    service logs at millisecond resolution)."""
    import datetime
    import re

    stamps = []
    for marker in (first, last):
        found = re.search(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3})\][^\n]*"
                          + re.escape(marker), text)
        check(found is not None, f"no log line with {marker!r}")
        stamps.append(datetime.datetime.strptime(found.group(1),
                                                 "%Y-%m-%d %H:%M:%S,%f"))
    return (stamps[1] - stamps[0]).total_seconds()


def rowservice_tiered_times(torch, fa, pe, g):
    """(g) The tiered store at the recsys shape: each service of
    ROWSVC_G_SERVICES has the whole vocabulary pulled once (all six at
    a time), then runs the schedule alone, a pull and a push a batch:
    p50/p99 ms; all six end with byte-equal rows. The tiered durable
    one's tier readings and bytes on disk, then SIGKILL after its last
    acked push and a relaunch (imported ahead, behind a go file): the
    replay's records, seconds and MB/s, and a pull bit-equal to the rows
    read before the kill."""
    import hashlib
    import re
    import shutil
    import signal

    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine

    schedule = tiered_schedule()
    touched = np.unique(np.concatenate(schedule))
    vocab = np.arange(EMB_VOCAB, dtype=np.int64)
    services = g["services"]
    keys = {RECSYS_TABLE: "ids"}
    for svc in services.values():
        port, _ = service_port(svc["proc"], svc["log"], timeout=300)
        svc["engine"] = make_remote_engine(f"localhost:{port}", keys)
        svc["table"] = svc["engine"].tables[RECSYS_TABLE]
    reset_kernel_launches(fa, pe)             # (g)'s runs start
    t0 = time.monotonic()
    threads = [threading.Thread(target=_pull_all, args=(svc["table"], vocab))
               for svc in services.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    prefill_s = time.monotonic() - t0
    out = {"table": f"{EMB_VOCAB} x {EMB_DIM} f32, native, Adagrad rows",
           "hot_budget_rows": ROWSVC_G_BUDGET, "batches": len(schedule),
           "ids_a_batch": [int(min(map(len, schedule))),
                           int(max(map(len, schedule)))],
           "touched_rows": int(touched.size), "prefill_s": prefill_s,
           "services": {}}
    digests = {}
    for name, svc in services.items():
        table, opt = svc["table"], svc["engine"].optimizer
        pull_ms, push_ms = [], []
        for b, ids in enumerate(schedule):
            grads = tiered_grads(b, ids.size)
            t1 = time.perf_counter()
            table.get(ids)
            t2 = time.perf_counter()
            opt.apply_gradients(table, ids, grads)
            t3 = time.perf_counter()
            pull_ms.append((t2 - t1) * 1e3)
            push_ms.append((t3 - t2) * 1e3)
        final = _pull_all(table, touched)
        digests[name] = hashlib.sha256(final.tobytes()).hexdigest()
        row = {k: {"p50": float(np.percentile(v, 50)),
                   "p99": float(np.percentile(v, 99)),
                   "max": max(v)} for k, v in (("pull_ms", pull_ms),
                                               ("push_ms", push_ms))}
        row["tiers"] = tier_readings(svc["log"])
        row["bytes_on_disk"] = dir_bytes(svc["base"])
        out["services"][name] = row
        if name == "tiered_durable":
            before = final
        else:
            stop_service(svc["proc"], svc["log"])
            shutil.rmtree(svc["base"], ignore_errors=True)
    counts = kernel_launch_counts(fa, pe)     # ... and end
    out["final_rows_sha256"] = digests
    out["final_rows_equal"] = len(set(digests.values())) == 1
    out["launches"] = counts
    # SIGKILL the tiered durable service after its last acked push.
    svc, relaunch = services["tiered_durable"], g["relaunch"]
    svc["proc"].send_signal(signal.SIGKILL)
    svc["proc"].wait(timeout=60)
    wal = os.path.join(svc["base"], "wal")
    wal_bytes = dir_bytes(wal)
    t0 = time.monotonic()
    go(relaunch["go"])
    port, text = service_port(relaunch["proc"], relaunch["log"],
                              timeout=600)
    start_s = time.monotonic() - t0
    replayed = re.search(r"replayed (\d+) record\(s\)", text)
    replay_s = _log_seconds(text, "Row service tiering on",
                            "Row service push log at")
    again = _pull_all(make_remote_engine(f"localhost:{port}", keys).tables[
        RECSYS_TABLE], touched)
    out["sigkill"] = {
        "wal_bytes": wal_bytes,
        "replayed_records": int(replayed.group(1)) if replayed else None,
        "replay_s": replay_s, "replay_mb_per_s": wal_bytes / 1e6 / replay_s,
        "relaunch_to_serving_s": start_s,
        "pull_bit_equal": bool(np.array_equal(again, before)),
    }
    out["card"] = smi("name,power.limit")
    print("rowservice tiered", json.dumps(out), flush=True)
    check(out["final_rows_equal"],
          f"tiered and untiered final rows differ: {digests}")
    check(not any(counts.values()), f"(g) launched kernels: {counts}")
    tiers = out["services"]["tiered_durable"]["tiers"]
    check(tiers.get("row_tier_hot_rows", 1e9) <= ROWSVC_G_BUDGET
          and tiers.get("row_tier_evictions_total", 0) > 0
          and tiers.get("row_tier_cold_rows", 0) > 0,
          f"the tiered service's readings: {tiers}")
    check(out["sigkill"]["replayed_records"] == ROWSVC_G_BATCHES
          and out["sigkill"]["pull_bit_equal"],
          f"the relaunch after SIGKILL: {out['sigkill']}")
    return out


def rowservice_reshard_start(root):
    """(i)'s services: the split fleet's three and the twin fleet's two
    (ROWSVC_I_FLEETS), each the service's main on the rowsvc_bench zoo
    with ``/metrics`` and a checkpoint directory (SIGTERM drains one):
    they boot while (a)-(g) run."""
    zoo = write_zoo(root, "rowsvc_bench", ROWSVC_BENCH_ZOO)
    fleets = {}
    for fleet, n in ROWSVC_I_FLEETS.items():
        fleets[fleet] = []
        for k in range(n):
            ckpt = os.path.join(root, f"rowsvc_i_{fleet}{k}")
            proc, log = row_service_main(
                root, zoo, "rowsvc_bench.rec.custom_model",
                f"rowsvc_i_{fleet}{k}.log",
                ["--metrics_port", "0", "--checkpoint_dir", ckpt,
                 "--shard_id", str(k), "--num_shards", str(n)])
            fleets[fleet].append(dict(proc=proc, log=log, ckpt=ckpt))
    return fleets


def rowservice_reshard_stop(fleets):
    for procs in fleets.values():
        for svc in procs:
            stop_service(svc["proc"], svc["log"])


def rss_mb(pid):
    """A live process's resident set (``/proc/<pid>/statm``), or None
    where the file is not there."""
    try:
        with open(f"/proc/{pid}/statm") as fh:
            pages = int(fh.read().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**20


def bucket_quantile(buckets, q):
    """The upper bound of the bucket that holds quantile ``q`` of a
    cumulative histogram ({le: count}); None when it is empty."""
    edges = sorted(((float(le), n) for le, n in buckets.items()),
                   key=lambda e: e[0])
    if not edges or edges[-1][1] <= 0:
        return None
    for le, n in edges:
        if n >= q * edges[-1][1]:
            return le
    return edges[-1][0]


def reshard_schedule():
    """(i)'s hot ids and its batches, drawn as they are asked for: each
    ROWSVC_TIMED_IDS unique ids of the vocabulary, the same ROWSVC_I_HOT
    hot ids in every one, with their gradients."""
    rng = np.random.RandomState(SEED + 21)
    hot = rng.choice(EMB_VOCAB, ROWSVC_I_HOT, replace=False).astype(np.int64)
    cold = np.setdiff1d(np.arange(EMB_VOCAB, dtype=np.int64), hot)
    out = []

    def batch(b):
        while len(out) <= b:
            rest = rng.choice(cold, ROWSVC_TIMED_IDS - ROWSVC_I_HOT,
                              replace=False)
            ids = np.sort(np.concatenate([hot, rest]))
            out.append((ids, tiered_grads(len(out), ids.size)))
        return out[b]

    return hot, batch


def rowservice_reshard_times(torch, fa, pe, root, fleets):
    """(i) Live resharding at the recsys shape (ROWSVC_I_*): the split
    and its twin, per-batch pull/push ms before, during and after the
    move, the move's readings, replicas from ``shard_stats``; then
    SIGTERM drains a checkpoint of every shard, and the two fleets'
    gathered rows and slots must be byte-equal."""
    import hashlib
    import signal

    from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
    from elasticdl_tpu_torch.comm.rpc import RpcStub
    from elasticdl_tpu_torch.embedding import row_service as rs
    from elasticdl_tpu_torch.embedding.row_service import make_remote_engine
    from elasticdl_tpu_torch.embedding.table import get_slot_table_name
    from elasticdl_tpu_torch.master.row_reshard import (
        ReshardPolicy,
        ShardMapController,
    )
    from elasticdl_tpu_torch.tools.check_reshard import check_reshard

    t_phase = time.monotonic()
    keys = {RECSYS_TABLE: "ids"}
    hot, schedule = reshard_schedule()
    runs = {}
    for fleet, procs in fleets.items():
        addrs = [f"localhost:{service_port(p['proc'], p['log'], 300)[0]}"
                 for p in procs]
        state = os.path.join(root, f"rowsvc_i_{fleet}_shard_map.json")
        ctrl = ShardMapController(state,
                                  policy=ReshardPolicy(**ROWSVC_I_POLICY))
        ctrl.bootstrap(addrs[:2])
        engine = make_remote_engine(",".join(addrs[:2]), keys)
        runs[fleet] = dict(addrs=addrs, ctrl=ctrl, engine=engine,
                           state=state, procs=procs,
                           table=engine.tables[RECSYS_TABLE])
    reset_kernel_launches(fa, pe)             # (i) starts

    def fill(run):
        t0 = time.monotonic()
        zeros = np.zeros((ROWSVC_TIMED_IDS, EMB_DIM), np.float32)
        for lo in range(0, EMB_VOCAB, ROWSVC_TIMED_IDS):
            ids = np.arange(lo, min(lo + ROWSVC_TIMED_IDS, EMB_VOCAB),
                            dtype=np.int64)
            run["engine"].optimizer.apply_gradients(
                run["table"], ids, zeros[:ids.size])
        run["fill_s"] = time.monotonic() - t0

    threads = [threading.Thread(target=fill, args=(r,))
               for r in runs.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    fenced = {"n": 0}
    real_check = rs._check_reshard

    def counting_check(resp):
        info = resp.get("reshard") if isinstance(resp, dict) else None
        if info and info.get("reason") == "fenced":
            fenced["n"] += 1
        return real_check(resp)

    def batches(run, lo, hi, split_at=None):
        """A pull and a push a batch: (batch, start, end, pull ms, push
        ms); at ``split_at`` the split starts in a thread first."""
        for b in range(lo, hi):
            if b == split_at:
                def go_split():
                    run["split_t0"] = time.monotonic()
                    run["split"] = run["ctrl"].split(
                        0, new_addr=run["addrs"][2])
                    run["split_t1"] = time.monotonic()
                run["split_thread"] = threading.Thread(target=go_split)
                run["split_thread"].start()
            ids, grads = schedule(b)
            t0 = time.monotonic()
            t1 = time.perf_counter()
            run["table"].get(ids)
            t2 = time.perf_counter()
            run["engine"].optimizer.apply_gradients(run["table"], ids,
                                                    grads)
            t3 = time.perf_counter()
            run.setdefault("ms", []).append(
                (b, t0, time.monotonic(), (t2 - t1) * 1e3,
                 (t3 - t2) * 1e3))

    split_run, twin_run = runs["split"], runs["twin"]
    # The split fleet's batches go on past ROWSVC_I_BATCHES until
    # ROWSVC_I_AFTER_MOVE of them started after the move ended.
    rs._check_reshard = counting_check
    try:
        n_main = 0
        while (n_main < ROWSVC_I_BATCHES or "split_t1" not in split_run
               or sum(r[1] >= split_run["split_t1"]
                      for r in split_run["ms"]) < ROWSVC_I_AFTER_MOVE):
            check(n_main < ROWSVC_I_MAX_BATCHES,
                  "the move did not end within the batches")
            batches(split_run, n_main, n_main + 1, ROWSVC_I_SPLIT_AFTER)
            n_main += 1
        split_run["split_thread"].join(timeout=600)
    finally:
        rs._check_reshard = real_check
    stats = split_run.get("split", {})
    src_log = log_text(split_run["procs"][0]["log"])
    fence_ms = _log_seconds(src_log, "write fence on buckets",
                            "lifted by the cutover") * 1e3
    ctrl = split_run["ctrl"]
    # The last batch before the replicas, with the shards' pulled rows
    # read around it, then the designation and its warm-up.
    before = ctrl.poll_stats()
    batches(split_run, n_main, n_main + 1)
    after_one = ctrl.poll_stats()
    home_pulled_before = [after_one[s]["pulled_rows"] - before[s][
        "pulled_rows"] for s in sorted(before)]
    designated = ctrl.update_replicas()
    per = ctrl.map.replicas.get(RECSYS_TABLE, {})
    stubs = {a: RpcStub(a, rs.SERVICE_NAME) for a in ctrl.map.shards}
    warm_t0 = time.monotonic()
    targets = {}
    for i, reps in per.items():
        for r in reps:
            targets.setdefault(r, []).append(i)
    while True:
        missing = 0
        for r, ids in targets.items():
            found = stubs[ctrl.map.shards[r]].call(
                "pull_replica_rows", table=RECSYS_TABLE,
                ids=np.asarray(ids, np.int64))["found"]
            missing += int((~np.asarray(found, bool)).sum())
        if not missing:
            break
        check(time.monotonic() - warm_t0 < 60, "the replicas never warmed")
        time.sleep(0.02)
    warm_s = time.monotonic() - warm_t0
    for stub in stubs.values():
        stub.close()
    m0 = [service_metrics(p["log"]) for p in split_run["procs"]]
    p0 = ctrl.poll_stats()
    n_total = n_main + 1 + ROWSVC_I_REPLICA_BATCHES
    batches(split_run, n_main + 1, n_total)
    p1 = ctrl.poll_stats()
    m1 = [service_metrics(p["log"]) for p in split_run["procs"]]
    batches(twin_run, 0, n_total)
    home_pulled_after = [(p1[s]["pulled_rows"] - p0[s]["pulled_rows"])
                         / ROWSVC_I_REPLICA_BATCHES for s in sorted(p0)]
    replica_reads = sum(b.get("row_replica_reads_total", 0)
                        - a.get("row_replica_reads_total", 0)
                        for a, b in zip(m0, m1))
    stale = {}
    for m in m1:
        for le, n in m.get("row_replica_staleness_seconds_bucket",
                           {}).items():
            stale[le] = stale.get(le, 0.0) + n
    mig = {k: sum(m.get(f"row_migration_{k}_total", 0) for m in m1)
           for k in ("rows", "bytes", "seconds")}
    counts = kernel_launch_counts(fa, pe)     # ... and ends
    fsck_errors, fsck = check_reshard(split_run["state"])
    final_map = ctrl.map
    for run in runs.values():
        run["engine"].close()
        run["ctrl"].close()
    rss_now = {f"{fleet}{k}": rss_mb(p["proc"].pid)
               for fleet, run in runs.items()
               for k, p in enumerate(run["procs"])}
    # SIGTERM drains a checkpoint of every shard; gather each fleet's
    # views from them.
    t_drain = time.monotonic()
    for run in runs.values():
        for p in run["procs"]:
            p["proc"].send_signal(signal.SIGTERM)
    rss = {}
    for fleet, run in runs.items():
        for k, p in enumerate(run["procs"]):
            # The child's peak RSS (the drain's checkpoint included) from
            # its rusage as it is reaped.
            _pid, status, usage = os.wait4(p["proc"].pid, 0)
            p["proc"].returncode = os.waitstatus_to_exitcode(status)
            rss[f"{fleet}{k}"] = usage.ru_maxrss / 1024.0
    drain_s = time.monotonic() - t_drain
    views = (RECSYS_TABLE, get_slot_table_name(RECSYS_TABLE, "accumulator"))
    digests, homes_ok, rows_by_fleet = {}, True, {}
    for fleet, run in runs.items():
        parts = {v: [] for v in views}
        for k, p in enumerate(run["procs"]):
            _, _, emb = CheckpointSaver(p["ckpt"]).restore()
            for v in views:
                ids, rows = emb[v].to_arrays()
                parts[v].append((np.asarray(ids, np.int64),
                                 np.asarray(rows, np.float32)))
                if fleet == "split" and ids.size:
                    homes_ok &= bool(
                        (final_map.home_of_ids(ids) == k).all())
            del emb
        digests[fleet] = {}
        for v in views:
            ids = np.concatenate([i for i, _ in parts[v]])
            rows = np.concatenate([r for _, r in parts[v]])
            order = np.argsort(ids, kind="stable")
            ids, rows = ids[order], rows[order]
            h = hashlib.sha256(ids.tobytes())
            h.update(rows.tobytes())
            digests[fleet][v] = h.hexdigest()
            if v == RECSYS_TABLE:
                rows_by_fleet[fleet] = int(ids.size)
                homes_ok &= bool(np.unique(ids).size == ids.size)
        del parts

    def stage(row):
        """before, during or after the move, by the batch's interval."""
        if row[2] <= split_run["split_t0"]:
            return "before"
        return "after" if row[1] >= split_run["split_t1"] else "during"

    def stage_ms(name, col):
        vals = [r[col] for r in split_run["ms"]
                if r[0] < n_main and stage(r) == name]
        if not vals:
            return None
        return {"n": len(vals), "p50": float(np.percentile(vals, 50)),
                "p99": float(np.percentile(vals, 99)), "max": max(vals)}

    out = {
        "table": f"{EMB_VOCAB} x {EMB_DIM} f32, native, Adagrad rows",
        "batches": ROWSVC_I_BATCHES, "ids_a_batch": ROWSVC_TIMED_IDS,
        "hot_ids": ROWSVC_I_HOT, "split_after": ROWSVC_I_SPLIT_AFTER,
        "fill_s": {f: r["fill_s"] for f, r in runs.items()},
        "migration": stats,
        "migration_mb_per_s": (stats.get("bytes", 0) / 1e6
                               / max(stats.get("seconds", 0), 1e-9)),
        "migration_metrics": mig,
        "split_wall_s": split_run.get("split_t1", 0)
        - split_run.get("split_t0", 0),
        "fenced_window_ms": fence_ms,
        "pushes_retried_after_fence": fenced["n"],
        "map_version": final_map.version,
        "ranges": [list(r) for r in final_map.ranges],
        "pull_ms": {st: stage_ms(st, 3) for st in ("before", "during",
                                                   "after")},
        "push_ms": {st: stage_ms(st, 4) for st in ("before", "during",
                                                   "after")},
        "twin_ms": {name: {
            "p50": float(np.percentile([r[col] for r in twin_run["ms"]],
                                       50)),
            "p99": float(np.percentile([r[col] for r in twin_run["ms"]],
                                       99))}
            for name, col in (("pull", 3), ("push", 4))},
        "batches_during_move": [r[0] for r in split_run["ms"]
                                if r[0] < n_main and stage(r) == "during"],
        "batches_in_all": n_total,
        "pull_ms_with_replicas": {
            "p50": float(np.percentile([r[3] for r in split_run["ms"]
                                        if r[0] > n_main], 50)),
            "p99": float(np.percentile([r[3] for r in split_run["ms"]
                                        if r[0] > n_main], 99))},
        "replicas_designated": bool(designated),
        "replica_ids": len(per), "replica_warm_s": warm_s,
        "hot_reads_after": ROWSVC_I_HOT * ROWSVC_I_REPLICA_BATCHES,
        "replica_reads": replica_reads,
        "replica_share": replica_reads / float(
            ROWSVC_I_HOT * ROWSVC_I_REPLICA_BATCHES),
        "replica_staleness_s": {"p50_le": bucket_quantile(stale, 0.5),
                                "p99_le": bucket_quantile(stale, 0.99),
                                "count": max(stale.values(), default=0),
                                "buckets": stale},
        "pulled_rows_a_batch_before_replicas": home_pulled_before,
        "pulled_rows_a_batch_with_replicas": home_pulled_after,
        "rss_before_drain_mb": rss_now,
        "peak_rss_mb_with_drain": rss, "drain_s": drain_s,
        "rows": rows_by_fleet, "sha256": digests,
        "fleets_byte_equal": digests["split"] == digests["twin"],
        "one_home_each": homes_ok, "fsck_errors": fsck_errors,
        "migration_in_flight": fsck["migration_in_flight"],
        "launches": counts, "seconds": time.monotonic() - t_phase,
        "card": smi("name,power.limit"),
    }
    print("rowservice reshard", json.dumps(out), flush=True)
    check(out["fleets_byte_equal"],
          f"the split fleet's rows or slots differ from the twin's: {out}")
    check(homes_ok and rows_by_fleet["split"] == EMB_VOCAB,
          f"an id off its one home: {rows_by_fleet}")
    check(stats.get("rows", 0) > 0 and not fsck_errors
          and not fsck["migration_in_flight"], f"the move: {stats}")
    check(designated and replica_reads > 0, f"the replicas: {out}")
    check(not any(counts.values()), f"(i) launched kernels: {counts}")
    return out


def rowservice_phase(torch, fa, pe, root, service=None, timed=False):
    """The row service on the card: the service's main in a subprocess
    (``service``, from ``rowservice_start``, or started here; tiered and
    logged) shared by two workers, SIGTERM and a relaunch that restores
    while one in-process shard is held to the in-process runner and two
    shards to one, then (f)'s SIGKILL and replay; with ``timed`` the pull
    and push at the recsys shape beside the host engine's phases, the
    worker's step over the service and in process, and (g) the tiered
    store at the recsys shape."""
    from elasticdl_tpu_torch.testing import data as tdata

    t0 = time.monotonic()
    service = service or rowservice_start(root)
    one_svc = steps_svc = tiered = reshard = None
    try:
        if timed:
            # (e)'s and (g)'s services boot while (a)-(d) run.
            proc, log = row_service_main(
                root, tdata.model_zoo_dir(),
                "deepfm.deepfm_host.custom_model", "rowsvc_steps.log")
            steps_svc = dict(proc=proc, log=log)
            tiered = rowservice_tiered_start(root)
            reshard = rowservice_reshard_start(root)
        try:
            records = tdata.create_frappe_record_file(
                os.path.join(root, "rowsvc.rec"), ROWSVC_RECORDS,
                seed=SEED + 48, input_length=HOST_IDS, max_id=HOST_MAX_ID)
            shared = tdata.create_frappe_record_file(
                os.path.join(root, "rowsvc_shared.rec"), ROWSVC_C_RECORDS,
                seed=SEED + 64, input_length=HOST_IDS, max_id=HOST_MAX_ID)
            out_c, relaunch = rowservice_shared_run(torch, fa, pe, root,
                                                    shared, service)
            out_a, one_svc, one_rows, one_loss = rowservice_one_shard(
                torch, fa, pe, root, records)
            out_b, export_two = rowservice_two_shards(
                torch, fa, pe, records, one_svc, one_rows, one_loss)
            out = {"one_shard": out_a, "two_shards": out_b,
                   "live_split": rowservice_live_split(
                       torch, fa, pe, root, records, one_loss, export_two),
                   "subprocess": rowservice_relaunch_check(out_c, relaunch)}
            out["sigkill"] = rowservice_kill_check(torch, fa, pe, relaunch)
        finally:
            if one_svc is not None:
                one_svc.stop(0)
            rowservice_stop(service)
        out["seconds"] = time.monotonic() - t0
        if timed:
            out["times"] = rowservice_times(torch, root)
            out["engine"] = host_engine_times(torch)
            print("rowservice engine", json.dumps(out["engine"]),
                  flush=True)
            out["step_times"] = rowservice_step_times(torch, fa, pe, root,
                                                      steps_svc)
            stop_service(steps_svc["proc"], steps_svc["log"])
            out["tiered"] = rowservice_tiered_times(torch, fa, pe, tiered)
            rowservice_tiered_stop(tiered)
            tiered = None
            out["reshard"] = rowservice_reshard_times(torch, fa, pe, root,
                                                      reshard)
    finally:
        if steps_svc is not None:
            stop_service(steps_svc["proc"], steps_svc["log"])
        if tiered is not None:
            rowservice_tiered_stop(tiered)
        if reshard is not None:
            rowservice_reshard_stop(reshard)
    out["card"] = smi("name,power.limit")
    return out


def post_msgpack(port, features, headers=None):
    """(status, decoded body) of a msgpack predict; an HTTP error answers
    with its code and None."""
    from elasticdl_tpu_torch.common import tensor_utils

    request = urllib.request.Request(
        f"http://localhost:{port}/v1/predict",
        data=tensor_utils.dumps({"features": features}),
        headers={"Content-Type": "application/x-msgpack", **(headers or {})})
    try:
        with urllib.request.urlopen(request, timeout=600) as resp:
            return resp.status, tensor_utils.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, None


def post_json_features(port, features):
    body = json.dumps({"features": features}).encode("utf-8")
    request = urllib.request.Request(
        f"http://localhost:{port}/v1/predict", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def get_text(port, path):
    with urllib.request.urlopen(f"http://localhost:{port}{path}",
                                timeout=60) as resp:
        return resp.read().decode("utf-8")


def family_total(registry, name):
    """The sum of a registry family's series values (0 when absent)."""
    for family in registry.snapshot()["families"]:
        if family["name"] == name:
            return sum(s.get("value", s.get("count", 0))
                       for s in family["series"])
    return 0.0


def host_forward(torch, model, rows_of, query):
    """The trained host module's forward on the card over ``rows_of``'s
    rows for ``query``'s raw ids, as the training engine feeds it: the
    inverse map and the bucket-padded row block."""
    from elasticdl_tpu_torch.embedding.host_engine import bucket_size
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin

    uniq, inverse = np.unique(query, return_inverse=True)
    block = np.zeros((bucket_size(len(uniq)), twin.EMBEDDING_DIM),
                     np.float32)
    block[:len(uniq)] = rows_of(uniq)
    with torch.inference_mode():
        return model(
            {twin.FEATURE_KEY: torch.from_numpy(inverse.reshape(
                query.shape).astype(np.int32)).to(DEVICE)},
            host_rows={twin.TABLE_NAME: torch.from_numpy(block).to(DEVICE)},
        ).cpu().numpy()


def fleet_host_part(torch, fa, pe, root):
    """(a) deepfm_host trained through LocalExecutor on the card with
    --output; the dense bundle served on the card and on the CPU."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.callbacks import Callback
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.native.row_store import NativeEmbeddingTable
    from elasticdl_tpu_torch.observability import MetricsRegistry
    from elasticdl_tpu_torch.serving.export import HOST_ROWS_FILE
    from elasticdl_tpu_torch.serving.model_store import (
        ModelStore,
        load_served_model,
    )
    from elasticdl_tpu_torch.serving.server import InferenceServer
    from elasticdl_tpu_torch.testing import data as tdata

    t0 = time.monotonic()
    records = tdata.create_frappe_record_file(
        os.path.join(root, "fleet.rec"), FLEET_RECORDS, seed=SEED,
        input_length=HOST_IDS, max_id=HOST_MAX_ID)
    bundle = os.path.join(root, "fleet_host", "v1")
    rows_before_export = {}

    class RowCount(Callback):
        """Runs before the exporter (which the executor appends last)."""

        def on_train_end(self, owner=None):
            rows_before_export["n"] = owner._step_runner.engine.tables[
                twin.TABLE_NAME].num_rows

    args = tdata.make_local_args(
        tdata.model_zoo_dir(), "deepfm.deepfm_host.custom_model", records,
        minibatch_size=HOST_BATCH, num_epochs=FLEET_EPOCHS,
        extra=["--device", DEVICE, "--random_seed", str(SEED),
               "--output", bundle])
    executor = LocalExecutor(args, callbacks=[RowCount()])
    reset_kernel_launches(fa, pe)             # (a) starts here
    result = executor.run()
    table = executor._step_runner.engine.tables[twin.TABLE_NAME]
    rows_after_export = table.num_rows
    touched = np.unique(frappe_ids(FLEET_RECORDS, HOST_IDS, HOST_MAX_ID,
                                   SEED))
    untouched = np.setdiff1d(np.arange(HOST_MAX_ID), touched)
    query = np.random.default_rng(SEED + 60).choice(
        touched, (FLEET_QUERY, HOST_IDS)).astype(np.int32)
    query[-1, 0] = untouched[0]               # a row training never read
    registry = MetricsRegistry()
    store = ModelStore(bundle, device=DEVICE, metrics_registry=registry,
                       model_fn=lambda: twin.custom_model(device="cpu"))
    store.load_initial()
    server = InferenceServer(store, max_batch_size=FLEET_QUERY,
                             batch_deadline_ms=1.0, port=0,
                             metrics_registry=registry).start()
    try:
        status_m, body_m = post_msgpack(server.port,
                                        {twin.FEATURE_KEY: query})
        status_j, body_j = post_json_features(
            server.port, {twin.FEATURE_KEY: query.tolist()})
    finally:
        server.stop()
    counts = kernel_launch_counts(fa, pe)     # ... and ends
    seconds = time.monotonic() - t0
    ids, trained = table.to_arrays()
    dense = torch.load(os.path.join(bundle, HOST_ROWS_FILE))[
        twin.TABLE_NAME].numpy()
    lazy = NativeEmbeddingTable(twin.TABLE_NAME, twin.EMBEDDING_DIM)
    model = executor.state.model.eval()
    served = np.asarray(body_m["predictions"], np.float32)
    # The engine's table reads the untouched id lazily here, after the
    # row counts were taken.
    want = host_forward(torch, model, table.get, query)
    on_cpu = load_served_model(
        bundle, device="cpu",
        model_fn=lambda: twin.custom_model(device="cpu")).predict(
        {twin.FEATURE_KEY: query})
    out = {
        "model": "deepfm_host twin (5500 x 16 host table, SGD rows, MLP "
                 "160-64-32-1 bf16), trained 1 epoch on the card",
        "steps": result["steps"], "bundle_version": store.current().version,
        "statuses": [status_m, status_j],
        "table_shape": list(dense.shape),
        "trained_rows_bit_equal": bool(np.array_equal(dense[ids], trained)),
        "untouched_rows_lazy": bool(np.array_equal(
            dense[untouched[:64]], lazy.get(untouched[:64]))),
        "live_rows_before_export": rows_before_export["n"],
        "live_rows_after_export": rows_after_export,
        "served_bit_equal_to_module": bool(np.array_equal(served, want)),
        "served_max_abs_err_vs_module": float(np.abs(served - want).max()),
        "json_equals_msgpack": bool(np.array_equal(
            np.asarray(body_j["predictions"], np.float32), served)),
        "rel_err_vs_cpu": rel_err(on_cpu, served),
        "launches": counts, "seconds": seconds,
    }
    print("fleet host bundle", json.dumps(out), flush=True)
    check(out["statuses"] == [200, 200], f"statuses {out['statuses']}")
    check(out["table_shape"] == [HOST_MAX_ID, twin.EMBEDDING_DIM],
          f"dense table {out['table_shape']}")
    check(out["trained_rows_bit_equal"], "the bundle's trained rows differ")
    check(out["untouched_rows_lazy"],
          "an untouched row in the bundle is not its lazy initial value")
    check(rows_before_export["n"] == rows_after_export == touched.size,
          f"the export grew the live table: {out}")
    check(out["served_bit_equal_to_module"],
          f"served != the module's forward over the engine's rows: {out}")
    check(out["json_equals_msgpack"], "the JSON answer differs")
    check(out["rel_err_vs_cpu"] <= HOST_TOL["delta_l2"],
          f"card vs CPU bundle {out['rel_err_vs_cpu']}")
    check(not any(counts.values()), f"(a) launched kernels: {counts}")
    return out, dict(executor=executor, model=model, table=table,
                     query=query, served=served)


def fleet_rows_part(torch, fa, pe, root, host, timed):
    """(b) The trained module exported in row-service mode, served over
    port HostRowServices in process (one shard, then two) through the
    hot-row cache."""
    from elasticdl_tpu_torch import bridge
    from elasticdl_tpu_torch.embedding.optimizer import SGD
    from elasticdl_tpu_torch.embedding.row_service import (
        HostRowService,
        make_remote_engine,
    )
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.native.row_store import (
        make_host_optimizer,
        make_host_table,
    )
    from elasticdl_tpu_torch.observability import MetricsRegistry
    from elasticdl_tpu_torch.serving.export import export_serving_bundle
    from elasticdl_tpu_torch.serving.model_store import ModelStore
    from elasticdl_tpu_torch.serving.server import InferenceServer

    executor, model, query = host["executor"], host["model"], host["query"]
    key, name = twin.FEATURE_KEY, twin.TABLE_NAME
    bundle = os.path.join(root, "fleet_rows", "v1")
    export_serving_bundle(
        bundle, model, batch_example=executor.last_batch,
        model_def="deepfm.deepfm_host.custom_model",
        version=executor.state.step, host_id_keys={name: key})
    unique = np.unique(query)
    out = {}
    for shards in (1, 2):
        t0 = time.monotonic()
        reset_kernel_launches(fa, pe)         # (b) starts here
        service_registries = [MetricsRegistry() for _ in range(shards)]
        services = []
        for service_registry in service_registries:
            table = make_host_table(name, twin.EMBEDDING_DIM)
            bridge.copy_host_table(host["table"], table)
            services.append(HostRowService(
                {name: table}, make_host_optimizer(SGD(lr=0.05)),
                metrics_registry=service_registry).start("localhost:0"))
        addr = ",".join(f"localhost:{s.port}" for s in services)

        def pulls():
            return sum(family_total(r, "edl_tpu_row_service_pull_seconds")
                       for r in service_registries)

        registry = MetricsRegistry()
        store = ModelStore(bundle, device=DEVICE, row_service_addr=addr,
                           model_fn=lambda: twin.custom_model(device="cpu"),
                           row_cache_capacity=FLEET_CACHE_ROWS,
                           row_cache_version_check_secs=0,
                           metrics_registry=registry)
        store.load_initial()
        server = InferenceServer(store, max_batch_size=FLEET_QUERY,
                                 batch_deadline_ms=1.0, port=0,
                                 metrics_registry=registry).start()
        client = make_remote_engine(addr, id_keys={name: key})
        try:
            status_1, body_1 = post_msgpack(server.port, {key: query})
            hits0 = family_total(registry,
                                 "edl_tpu_serving_row_cache_hits_total")
            pulls0 = pulls()
            status_2, body_2 = post_msgpack(server.port, {key: query})
            repeat_hits = family_total(
                registry, "edl_tpu_serving_row_cache_hits_total") - hits0
            repeat_pulls = pulls() - pulls0
            pushed = unique[:8].astype(np.int64)
            client.optimizer.apply_gradients(
                client.tables[name], pushed,
                np.full((len(pushed), twin.EMBEDDING_DIM), 1.0, np.float32))
            status_3, body_3 = post_msgpack(server.port, {key: query})
            times = fleet_resolve_times(store, query.shape[1]) \
                if timed and shards == 1 else None
        finally:
            server.stop()
        counts = kernel_launch_counts(fa, pe)     # ... and ends
        seconds = time.monotonic() - t0
        first = np.asarray(body_1["predictions"], np.float32)
        after = np.asarray(body_3["predictions"], np.float32)
        want_after = host_forward(torch, model, client.tables[name].get,
                                  query)
        for s in services:
            s.stop(0)
        part = {
            "shards": shards, "statuses": [status_1, status_2, status_3],
            "equals_host_bundle": bool(np.array_equal(first,
                                                      host["served"])),
            "repeat_equal": bool(np.array_equal(
                np.asarray(body_2["predictions"], np.float32), first)),
            "unique_ids": int(unique.size), "repeat_cache_hits": repeat_hits,
            "repeat_pulls": repeat_pulls,
            "push_moved_answer": bool(not np.array_equal(after, first)),
            "after_push_bit_equal_to_module": bool(np.array_equal(
                after, want_after)),
            "after_push_max_abs_err": float(np.abs(after - want_after).max()),
            "launches": counts, "seconds": seconds,
        }
        if times is not None:
            part["resolve_ms_b512"] = times
        print(f"fleet row-service bundle, {shards} shard(s)",
              json.dumps(part), flush=True)
        check(part["statuses"] == [200, 200, 200],
              f"statuses {part['statuses']}")
        check(part["equals_host_bundle"],
              f"{shards} shard(s): the row-service answer != (a)'s")
        check(part["repeat_equal"], "the cached repeat answered otherwise")
        check(repeat_hits == unique.size and repeat_pulls == 0,
              f"the repeat was not served from the cache: {part}")
        check(part["push_moved_answer"] and
              part["after_push_bit_equal_to_module"],
              f"the answer did not follow the push: {part}")
        check(not any(counts.values()), f"(b) launched kernels: {counts}")
        out["one_shard" if shards == 1 else "two_shards"] = part
    return out


def fleet_resolve_times(store, width):
    """(d) Median ms of the row-service bundle's resolve of a B
    HOST_BATCH batch through a cache probed every resolve (the served
    configuration): cold, each from an empty cache, and warm, every id
    a hit."""
    from elasticdl_tpu_torch.model_zoo.deepfm import deepfm_host as twin
    from elasticdl_tpu_torch.observability import MetricsRegistry
    from elasticdl_tpu_torch.serving.model_store import (
        HostRowResolver,
        HotRowCache,
    )

    served = store.current()
    tables = served._resolver._tables
    rng = np.random.default_rng(SEED + 61)
    batch = {twin.FEATURE_KEY: rng.integers(
        0, HOST_MAX_ID, (HOST_BATCH, width)).astype(np.int32)}

    def resolver(cache):
        return HostRowResolver(served.meta["host_serving"], tables,
                               feature_signature=served.meta.get(
                                   "feature_signature"),
                               row_cache=cache,
                               metrics_registry=MetricsRegistry())

    cold, warm = [], []
    for _ in range(FLEET_RESOLVE_REPS):
        r = resolver(HotRowCache(FLEET_CACHE_ROWS, version_check_secs=0,
                                 metrics_registry=MetricsRegistry()))
        t0 = time.monotonic()
        r.resolve(dict(batch))
        cold.append((time.monotonic() - t0) * 1e3)
    for _ in range(FLEET_RESOLVE_REPS):
        t0 = time.monotonic()
        r.resolve(dict(batch))
        warm.append((time.monotonic() - t0) * 1e3)
    return {"batch": HOST_BATCH,
            "unique_ids": int(np.unique(batch[twin.FEATURE_KEY]).size),
            "cold_ms": float(np.median(cold)),
            "warm_ms": float(np.median(warm)),
            "cold_spread_ms": spread(cold), "warm_spread_ms": spread(warm)}


def routed_wave(port, requests, threads):
    """Send ``requests`` (token arrays) as msgpack from ``threads``
    threads; returns [(status, predictions or None)] in request order."""
    replies = [None] * len(requests)

    def send(indices):
        for i in indices:
            status, body = post_msgpack(port, requests[i])
            replies[i] = (status, None if body is None else np.asarray(
                body["predictions"], np.float32))

    workers = [threading.Thread(target=send,
                                args=(range(t, len(requests), threads),))
               for t in range(threads)]
    for w in workers:
        w.start()
    return workers, replies


def fleet_latency(port, requests, concurrency, count):
    """Host-clock ms of each of ``count`` requests sent from
    ``concurrency`` threads."""
    samples = []
    lock = threading.Lock()

    def send(indices):
        for i in indices:
            t0 = time.monotonic()
            status, _ = post_msgpack(port, requests[i % len(requests)])
            with lock:
                samples.append((time.monotonic() - t0) * 1e3)
            check(status == 200, f"latency request answered {status}")

    workers = [threading.Thread(target=send,
                                args=(range(t, count, concurrency),))
               for t in range(concurrency)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    return {"requests": count, "p50_ms": float(np.percentile(samples, 50)),
            "p99_ms": float(np.percentile(samples, 99)),
            "max_ms": float(max(samples)),
            "mean_ms": float(np.mean(samples))}


def histogram_sum_count(registry, name):
    """(sum, count) over a registry histogram's series ((0, 0) when
    absent)."""
    for family in registry.snapshot()["families"]:
        if family["name"] == name:
            return (sum(s["sum"] for s in family["series"]),
                    sum(s["count"] for s in family["series"]))
    return 0.0, 0


def fleet_timings(replicas, registries, router_port, requests):
    """(d) The flagship's 128-token request on the host clock, direct
    and routed at each concurrency of FLEET_LATENCY, beside what each
    replica measured of the same requests: the mean of its
    ``serving_request_seconds`` (submit to answer: the queue wait and
    the batch) and of its ``serving_batch_seconds`` (the predict call),
    and its batch occupancy."""
    families = {"replica_request_ms": "edl_tpu_serving_request_seconds",
                "replica_batch_ms": "edl_tpu_serving_batch_seconds"}
    times = {}
    for c, count in FLEET_LATENCY.items():
        for target, port in (("direct", replicas[0].port),
                             ("routed", router_port)):
            occupancy = [dict(r.predictor.batch_occupancy)
                         for r in replicas]
            before = [{k: histogram_sum_count(reg, f)
                       for k, f in families.items()} for reg in registries]
            reading = fleet_latency(port, requests, c, count)
            for key, family in families.items():
                reading[key] = []
                for reg, b in zip(registries, before):
                    total, n = histogram_sum_count(reg, family)
                    n -= b[key][1]
                    reading[key].append(
                        (total - b[key][0]) / n * 1e3 if n else None)
            reading["batch_occupancy"] = [
                {str(k): v - b.get(k, 0) for k, v in
                 r.predictor.batch_occupancy.items() if v - b.get(k, 0)}
                for r, b in zip(replicas, occupancy)]
            times[f"{target}_c{c}"] = reading
    return times


def fleet_alone_times(served, tokens):
    """(d) One request alone, FLEET_ALONE_REPS times, on the host clock:
    ``ServedModel.predict`` (tokens in, forward, logits to the host) and
    the reply's msgpack encode and decode."""
    from elasticdl_tpu_torch.common import tensor_utils

    predict, encode, decode = [], [], []
    for _ in range(FLEET_ALONE_REPS):
        t0 = time.monotonic()
        out = served.predict(tokens)
        t1 = time.monotonic()
        body = tensor_utils.dumps({"predictions": out,
                                   "model_version": served.version})
        t2 = time.monotonic()
        tensor_utils.loads(body)
        t3 = time.monotonic()
        predict.append((t1 - t0) * 1e3)
        encode.append((t2 - t1) * 1e3)
        decode.append((t3 - t2) * 1e3)

    def spread(xs):
        return {"median": float(np.median(xs)), "min": float(min(xs)),
                "max": float(max(xs))}

    return {"reps": FLEET_ALONE_REPS, "reply_bytes": len(body),
            "predict_ms": spread(predict), "encode_ms": spread(encode),
            "decode_ms": spread(decode)}


def fleet_router_part(torch, fa, pe, bundle, timed):
    """(c) The flagship bundle from two replicas on the card behind a
    RouterServer; one replica stopped under load."""
    from elasticdl_tpu_torch.observability import (
        MetricsRegistry,
        render_prometheus,
    )
    from elasticdl_tpu_torch.serving.model_store import ModelStore
    from elasticdl_tpu_torch.serving.router import RouterServer
    from elasticdl_tpu_torch.serving.server import InferenceServer

    t0 = time.monotonic()
    registries = [MetricsRegistry(), MetricsRegistry()]
    stores = [ModelStore(bundle, device=DEVICE, metrics_registry=r)
              for r in registries]
    for store in stores:
        store.load_initial()
    replicas = [InferenceServer(store, max_batch_size=8,
                                batch_deadline_ms=5.0, port=0,
                                request_timeout=20.0,
                                metrics_registry=r).start()
                for store, r in zip(stores, registries)]
    router_registry = MetricsRegistry()
    router = RouterServer(
        [f"localhost:{r.port}" for r in replicas], port=0,
        policy="least_loaded", hedge=True, hedge_min_ms=FLEET_HEDGE_MIN_MS,
        replica_timeout=120.0, metrics_registry=router_registry).start()
    vocab = FLAGSHIP["vocab_size"]
    rng = np.random.default_rng(SEED + 70)
    requests = [rng.integers(0, vocab, (1, SERVE_TOKENS)).astype(np.int32)
                for _ in range(FLEET_REQUESTS + FLEET_FAILOVER_REQUESTS)]
    wave, tail = requests[:FLEET_REQUESTS], requests[FLEET_REQUESTS:]
    times = None
    killed = False
    try:
        reset_kernel_launches(fa, pe)         # (c) starts here
        workers, replies = routed_wave(router.port, wave, FLEET_THREADS)
        for w in workers:
            w.join()
        metrics = {"router": get_text(router.port, "/metrics"),
                   "replica_0": get_text(replicas[0].port, "/metrics")}
        if timed:
            times = fleet_timings(replicas, registries, router.port, wave)
        # Stop replica 0 under the tail's requests.
        workers, tail_replies = routed_wave(router.port, tail,
                                            FLEET_THREADS)
        deadline = time.monotonic() + 60
        while (router.core.replicas[0].inflight == 0
               and any(w.is_alive() for w in workers)
               and time.monotonic() < deadline):
            time.sleep(0.0005)
        inflight_at_kill = router.core.replicas[0].inflight
        # stop() closes the listener and cuts the open connections, as
        # the replica's process dying would.
        replicas[0].stop()
        killed = True
        for w in workers:
            w.join()
        metrics["replica_1"] = get_text(replicas[1].port, "/metrics")
        states = router.core.states()
        counts = kernel_launch_counts(fa, pe)     # ... and ends
        flushes = [family_total(r, "edl_tpu_serving_batch_flushes_total")
                   for r in registries]
        failovers = family_total(router_registry,
                                 "edl_tpu_router_failovers_total")
    finally:
        router.stop()
        for i, r in enumerate(replicas):
            if i or not killed:
                r.stop()
    seconds = time.monotonic() - t0
    served = stores[1].current()
    answers = replies + tail_replies
    errs = [rel_err(body, served.predict(tokens))
            for (status, body), tokens in zip(answers, requests)
            if body is not None]
    statuses = [status for status, _ in answers]
    replica_families = ("edl_tpu_serving_requests_total",
                        "edl_tpu_serving_batch_occupancy",
                        "edl_tpu_serving_batch_flushes_total",
                        "edl_tpu_serving_queue_depth",
                        "edl_tpu_serving_model_version")
    router_families = ("edl_tpu_router_requests_total",
                       "edl_tpu_router_attempts_total",
                       "edl_tpu_router_failovers_total",
                       "edl_tpu_router_replica_unhealthy_total",
                       "edl_tpu_router_replicas_healthy")
    missing = sorted(
        [f for f in router_families if f not in metrics["router"]]
        + [f"{name}:{f}" for name in ("replica_0", "replica_1")
           for f in replica_families if f not in metrics[name]])
    out = {
        "model": "transformer flagship bundle from the serving phase, "
                 "two replicas on one card; the clients, the router and "
                 "both replicas share this one process",
        "requests": len(answers), "statuses": statuses,
        "batch_flushes": flushes, "flash_launches": counts[
            "flash_attention_fwd"],
        "rel_err_vs_served_model": max(errs) if errs else None,
        "inflight_at_kill": inflight_at_kill,
        "replica_health": [s["healthy"] for s in states],
        "failovers": failovers,
        "router_render": len(render_prometheus(router_registry.snapshot())),
        "missing_families": missing,
        "launches": counts, "seconds": seconds,
    }
    if times is not None:
        # After the counts: these launches are no routed batch's.
        times["alone"] = fleet_alone_times(served, wave[0])
        out["latency"] = times
    print("fleet router", json.dumps(out), flush=True)
    check(statuses == [200] * len(answers), f"statuses {statuses}")
    check(len(errs) == len(answers)
          and max(errs) <= LOGITS_REL_TOL, f"routed != served: {errs}")
    check(counts["flash_attention_fwd"]
          == FLAGSHIP["n_layers"] * int(sum(flushes)),
          f"{counts['flash_attention_fwd']} flash launches for "
          f"{flushes} batches of {FLAGSHIP['n_layers']} layers")
    check(all(v == 0 for k, v in counts.items()
              if k != "flash_attention_fwd"),
          f"(c) launched another kernel: {counts}")
    check(out["replica_health"] == [False, True],
          f"replica health after the stop: {out['replica_health']}")
    check(failovers > 0, "no failover after the replica stopped")
    check(not missing, f"families missing from /metrics: {missing}")
    return out


def fleet_phase(torch, fa, pe, root, flagship_bundle, timed=False):
    """The rest of serving: (a) a host-tier bundle, (b) a row-service
    bundle over one shard and two, (c) the flagship behind the router;
    (d) with ``timed``."""
    host, host_state = fleet_host_part(torch, fa, pe, root)
    rows = fleet_rows_part(torch, fa, pe, root, host_state, timed)
    router = fleet_router_part(torch, fa, pe, flagship_bundle, timed)
    return {
        "host_bundle": host, "row_service": rows, "router": router,
        "launches": {"host_bundle": host["launches"],
                     "row_service_one_shard":
                         rows["one_shard"]["launches"],
                     "row_service_two_shards":
                         rows["two_shards"]["launches"],
                     "router": router["launches"]},
        "seconds": {"host_bundle": host["seconds"],
                    "row_service": rows["one_shard"]["seconds"]
                    + rows["two_shards"]["seconds"],
                    "router": router["seconds"]},
    }


def fused_path_phase(torch, pe):
    """DeviceSparseRunner(recsys TABLE_SPECS, Momentum(lr 0.05, Nesterov),
    use_pallas="fused") on the twin for FUSED_STEPS steps, against the
    library route ("never") from the same seed: kernel #8 once a step."""
    from elasticdl_tpu_torch.embedding.device_sparse import (
        DeviceSparseRunner,
    )
    from elasticdl_tpu_torch.embedding.optimizer import Momentum
    from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin

    rng = np.random.default_rng(SEED + 30)
    batches = []
    for _ in range(FUSED_STEPS):
        ids = rng.integers(0, EMB_VOCAB, (EMB_BATCH, EMB_IDS))
        batches.append({"features": {"ids": ids},
                        "labels": (ids.sum(axis=1) % 2).astype(np.int32),
                        "mask": np.ones(EMB_BATCH, np.float32)})
    runs = {}
    for mode in ("fused", "never"):
        torch.manual_seed(SEED)
        runner = DeviceSparseRunner(
            twin.TABLE_SPECS, Momentum(lr=0.05, nesterov=True),
            use_pallas=mode)
        state = runner.init_state(twin.custom_model(device="cuda"),
                                  twin.optimizer(), batches[0], seed=SEED)
        step = runner.train_step(twin.loss)
        initial = state.tables[RECSYS_TABLE].clone()
        pe.reset_launches()                   # the fused path starts here
        losses = [step(state, b)[1]["loss"] for b in batches]
        counts = {"fused_row_update": pe.fused_launches,   # ... and ends
                  "row_update": pe.row_update_launches,
                  "lookup_combine": pe.lookup_launches}
        runs[mode] = dict(losses=[float(x) for x in losses], counts=counts,
                          initial=initial, final=state.tables[RECSYS_TABLE],
                          velocity=state.slot_tables[RECSYS_TABLE][
                              "momentum"])
        del state, runner, step
    touched = touched_rows(torch, np.stack(
        [b["features"]["ids"] for b in batches]), EMB_VOCAB)
    f, n = runs["fused"], runs["never"]
    rel = [abs(x - y) / abs(y) for x, y in zip(f["losses"], n["losses"])]
    out = {
        "steps": FUSED_STEPS, "launches": f["counts"],
        "launches_never": n["counts"], "loss_max_rel_diff": max(rel),
        "table_delta_l2": rel_err(
            (f["final"][touched] - f["initial"][touched]).cpu().numpy(),
            (n["final"][touched] - n["initial"][touched]).cpu().numpy()),
        "velocity_l2": rel_err(f["velocity"][touched].cpu().numpy(),
                               n["velocity"][touched].cpu().numpy()),
        "untouched_bit_equal": bool(
            torch.equal(f["final"][~touched], f["initial"][~touched])
            and bool((f["velocity"][~touched] == 0).all())),
        "tol": SPARSE_TOL,
    }
    print("fused path", json.dumps(out), flush=True)
    check(f["counts"] == {"fused_row_update": FUSED_STEPS, "row_update": 0,
                          "lookup_combine": 0},
          f"fused path launches {f['counts']}")
    check(not any(n["counts"].values()), f"never launched {n['counts']}")
    check(out["untouched_bit_equal"], "fused path moved an untouched row")
    check(max(rel) <= SPARSE_TOL["loss"], f"fused vs never losses {out}")
    check(out["table_delta_l2"] <= SPARSE_TOL["delta_l2"]
          and out["velocity_l2"] <= SPARSE_TOL["delta_l2"],
          f"fused vs never rows {out}")
    runs.clear()
    torch.cuda.empty_cache()
    return out


def lookup_phase(torch, pe):
    """Kernel #5 alone (``--phase lookup``): every lookup check case of
    #5 and #6, then #5, #6, ``embedding_bag`` and the bound at the sweep
    tool's four tiers (its inputs, from the same seed), and the two
    lookup kernels' rows of the kernels line, launches counted over the
    tiers."""
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    checks = lookup_checks(
        torch, pe, np.random.default_rng(SEED + 20),
        torch.Generator(device="cuda").manual_seed(SEED + 20))
    pe.reset_launches()
    tiers = tool.lookup_rows(
        pe, torch.Generator(device="cuda").manual_seed(SEED), iters=20,
        windows=5)
    launches = {"lookup_combine": (pe.lookup_launches, "lookup tiers"),
                "lookup_combine_aligned": (pe.aligned_launches,
                                           "lookup tiers")}
    lookup = lookup_times(
        torch, pe, torch.Generator(device="cuda").manual_seed(SEED + 40))
    return lookup_kernel_rows(checks, lookup, launches, tiers)


def sweep_phase(torch, pe):
    """The ported sweep tool's tiers; the lookup tiers are the path on
    which kernel #5 runs (its launches are counted here)."""
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    pe.reset_launches()                       # the sweep path starts here
    # Three windows of ten calls a tier (the tool's default is five of
    # twenty): the whole smoke stays within its 240 s.
    result = tool.sweep(iters=10, windows=3, seed=SEED)  # a line a tier
    counts = {"lookup_combine_aligned": pe.aligned_launches,   # ... ends
              "lookup_combine": pe.lookup_launches,
              "row_update": pe.row_update_launches,
              "fused_row_update": pe.fused_launches}
    print("sparse sweep", json.dumps({"launches": counts}), flush=True)
    check(all(counts.values()), f"a kernel missed the sweep: {counts}")
    return result, counts


def lookup_times(torch, pe, gen):
    """Both lookup kernels at the recsys step's shape (B 512, L 32, D 256
    over 1M rows; the step's ~16,250 distinct ids), their plain version,
    the library call and route, and the bound."""
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    table = uniform_table(torch, EMB_VOCAB, EMB_DIM, EMB_DIM ** -0.5, gen)
    sets, distinct = tool.lookup_inputs(EMB_BATCH, EMB_IDS, EMB_DIM, gen)

    def lookup_ms(fn, iters=50):
        return tool.device_ms(tool.cycling(fn, sets), iters)[0]

    lookup = {
        "lookup_combine": lookup_ms(
            lambda i, w: pe.lookup_combine_pallas(table, i, w, "sum")),
        "lookup_combine_aligned": lookup_ms(
            lambda i, w: pe.lookup_combine_aligned(table, i, w, "sum")),
        "plain_ms": lookup_ms(lambda i, w: pe.lookup_combine_reference(
            table, i, w, "sum"), iters=5),
        "library_ms": lookup_ms(lambda i, w: torch.nn.functional
                                .embedding_bag(i, table,
                                               per_sample_weights=w,
                                               mode="sum")),
        "route_ms": lookup_ms(lambda i, w: pe.lookup_combine(
            table, i, w, "sum", force_xla=True)),
        "bound": tool.lookup_bound(EMB_BATCH, EMB_IDS, EMB_DIM, distinct),
        "distinct_rows": distinct,
    }
    del table, sets
    torch.cuda.empty_cache()
    return lookup


def embedding_times(torch, pe):
    """Each embedding kernel at the recsys step's shape (``lookup_times``;
    the row kernels at the step's 16,384 ids), its plain version, the
    library call or route, and the bound."""
    from elasticdl_tpu_torch.embedding.optimizer import Adagrad, Momentum
    from elasticdl_tpu_torch.embedding.optimizer import sparse_apply
    from elasticdl_tpu_torch.tools import bench_kernel_device_sweep as tool

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    rng = np.random.RandomState(SEED + 40)
    lookup = lookup_times(torch, pe, gen)
    n = EMB_BATCH * EMB_IDS
    usets, real = tool.apply_inputs(n, EMB_DIM, rng)

    def rows_ms(rule, fused=False, iters=20):
        slots = pe.RULE_SLOTS[rule]
        tables = [uniform_table(torch, EMB_VOCAB, EMB_DIM, EMB_DIM ** -0.5,
                                gen)] + [
            torch.full((EMB_VOCAB, EMB_DIM), 0.1, device="cuda")
            for _ in range(slots)]
        ms = tool.device_ms(tool.cycling(lambda i, g: pe.row_update(
            rule, i, g, tables, fused=fused, step=1,
            **dict(RULE_HYPER[rule], nesterov=True)), usets), iters)[0]
        bound = tool.row_update_bound(real, n + 1, EMB_DIM, slots)
        return {"rule": rule, "ms": ms, "bound_ms": bound[0],
                "bound_by": bound[1]}

    def other_ms(fn, opt):
        table = uniform_table(torch, EMB_VOCAB, EMB_DIM, EMB_DIM ** -0.5, gen)
        slots = {name: torch.full((EMB_VOCAB, EMB_DIM), 0.1, device="cuda")
                 for name in opt.slot_names}
        return tool.device_ms(tool.cycling(
            lambda i, g: fn(opt, table, slots, i, g), usets), 5)[0]

    def plain(opt, table, slots, i, g):
        rule = "adagrad" if isinstance(opt, Adagrad) else "momentum"
        return pe.row_update_reference(
            rule, i, g, [table] + list(slots.values()),
            **dict(RULE_HYPER[rule], nesterov=True))

    def route(opt, table, slots, i, g):
        return sparse_apply(opt, table, slots, i, g, step=1,
                            use_pallas="never")

    adagrad = Adagrad(lr=0.05)
    momentum = Momentum(lr=0.05, nesterov=True)
    rows = {
        "rules": [rows_ms(rule) for rule in pe.RULES],
        "fused": [rows_ms(rule, fused=True) for rule in ("sgd", "momentum")],
        "adagrad_plain_ms": other_ms(plain, adagrad),
        "adagrad_route_ms": other_ms(route, adagrad),
        "momentum_plain_ms": other_ms(plain, momentum),
        "momentum_route_ms": other_ms(route, momentum),
        "rows": real, "n": n + 1,
    }
    torch.cuda.empty_cache()
    return lookup, rows


def kernel_errors(checks):
    """The largest error of each kernel's check cases."""
    err = {}
    for c in checks:
        reading = max(c.get(k, {}).get("max_abs_err", 0.0)
                      for k in ("table", "slot0", "slot1", "slot2")) \
            if "table" in c else c["max_abs_err"]
        err[c["kernel"]] = max(err.get(c["kernel"], 0.0), reading)
    return err


def lookup_kernel_rows(checks, lookup, launches, tiers):
    """The kernels-line entries of the two lookup kernels; ``launches``
    maps each to (count, the path it was counted on); ``tiers`` are the
    sweep tool's lookup rows (#5's times at each tier)."""
    err = kernel_errors(checks)
    bound_ms, bound_by = lookup["bound"]
    shape = {"vocab": EMB_VOCAB, "dim": EMB_DIM, "batch": EMB_BATCH,
             "num_ids": EMB_IDS, "combiner": "sum"}
    out = []
    for name, replaces in (
            ("lookup_combine", "elasticdl_tpu/ops/pallas_embedding.py:286"),
            ("lookup_combine_aligned",
             "elasticdl_tpu/ops/pallas_embedding.py:242")):
        row = {
            "name": name, "route": "cuda",
            "source": "elasticdl_tpu_torch/ops/csrc/embedding_lookup.cu",
            "replaces": replaces, **shape,
            "distinct_rows": lookup["distinct_rows"],
            "launches": launches[name][0], "launches_path": launches[name][1],
            "max_abs_err": err[name], "ms": lookup[name],
            "plain_ms": lookup["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lookup["library_ms"],
            "library_call": "torch.nn.functional.embedding_bag(mode='sum', "
                            "per_sample_weights)",
            "route_ms": lookup["route_ms"],
        }
        if name == "lookup_combine_aligned":
            row["tiers"] = [
                {k: t[k] for k in ("dim", "L", "batch", "aligned_ms",
                                   "kernel_ms", "embedding_bag_ms",
                                   "bound_ms", "aligned_plan")}
                for t in tiers]
        out.append(row)
    return out


def embedding_kernel_rows(checks, times, counts, sweep_counts, tiers):
    """The kernels-line entries of the four embedding kernels."""
    lookup, rows = times
    source = "elasticdl_tpu_torch/ops/csrc/"
    err = kernel_errors(checks)
    out = lookup_kernel_rows(checks, lookup, {
        "lookup_combine": (counts["lookup_combine"], "sparse training "
                           "(train steps + eval batches)"),
        "lookup_combine_aligned": (sweep_counts["lookup_combine_aligned"],
                                   "sparse sweep")}, tiers)
    by_rule = {r["rule"]: r for r in rows["rules"]}
    fused = {r["rule"]: r for r in rows["fused"]}
    route_note = ("sparse_apply(use_pallas='never'): gather, apply_rows, "
                  "scatter; a route of several PyTorch calls, not one call")
    for name, replaces, rule, launches, path, sub, plain, route in (
            ("row_update", "elasticdl_tpu/ops/pallas_embedding.py:566",
             "adagrad", counts["row_update"], "sparse training (train "
             "steps, Adagrad)", rows["rules"], rows["adagrad_plain_ms"],
             rows["adagrad_route_ms"]),
            ("fused_row_update", "elasticdl_tpu/ops/pallas_embedding.py:859",
             "momentum", counts["fused_row_update"], "fused path (train "
             "steps, Momentum with Nesterov)", rows["fused"],
             rows["momentum_plain_ms"], rows["momentum_route_ms"])):
        row = (by_rule if name == "row_update" else fused)[rule]
        out.append({
            "name": name, "route": "cuda",
            "source": source + "embedding_row_update.cu",
            "replaces": replaces, "rule": rule, "vocab": EMB_VOCAB,
            "dim": EMB_DIM, "rows": rows["rows"], "n": rows["n"],
            "launches": launches, "launches_path": path,
            "max_abs_err": err[name], "ms": row["ms"], "plain_ms": plain,
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": route, "library_call": route_note,
            "rules": sub,
        })
    return out


def step_recorder(torch):
    """A Callback for LocalExecutor that keeps, per train step, the loss
    tensor, CUDA events around the step (on the card) and the host's ms
    to issue it; and, on the CPU in f32, every parameter before the
    first step and its gradient from the first step."""
    from elasticdl_tpu_torch.callbacks import Callback

    def on_cpu(named):
        return {name: t.detach().float().cpu().clone() for name, t in named}

    class StepRecorder(Callback):
        def __init__(self):
            self.loss, self.events, self.issue_ms = [], [], []
            self.initial = self.first_grads = None

        def on_train_batch_begin(self, owner=None):
            model = owner.state.model
            if self.initial is None:
                self.initial = on_cpu(model.named_parameters())
            self._start = None
            self._t0 = time.perf_counter()
            if owner.device.type == "cuda":
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record()

        def on_train_batch_end(self, owner=None, metrics=None):
            if self._start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.events.append((self._start, end))
            self.issue_ms.append((time.perf_counter() - self._t0) * 1e3)
            self.loss.append(metrics["loss"])
            if self.first_grads is None:
                self.first_grads = on_cpu(
                    (name, p.grad)
                    for name, p in owner.state.model.named_parameters()
                    if p.grad is not None)

    return StepRecorder()


def twin_training_phase(torch, fa, root):
    """The zoo twin, 5 Local steps on the card and on the CPU from the
    same seed: the losses, the first step's gradients and the change of
    every parameter agree; the card's --output bundle served on the
    card."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.serving.export import load_predictor
    from elasticdl_tpu_torch.testing import data as tdata

    records = tdata.create_lm_record_file(os.path.join(root, "twin.rec"),
                                          40, seed=SEED, seq_len=127)
    runs, models = {}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(root, f"twin_{dev}")
        args = tdata.make_local_args(
            tdata.model_zoo_dir(), "transformer.transformer_lm.custom_model",
            records, minibatch_size=8, extra=[
                "--device", dev, "--max_steps", "5", "--output", out])
        record = step_recorder(torch)
        executor = LocalExecutor(args, callbacks=[record])
        executor.run()
        models[dev] = executor.state.model
        record.final = {name: p.detach().float().cpu()
                        for name, p in models[dev].named_parameters()}
        runs[dev] = record
    card, cpu = runs["cuda"], runs["cpu"]
    losses = {dev: [float(x) for x in run.loss] for dev, run in runs.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    # The key biases' gradients are noise on both sides (TRAJ_TOL).
    names = [name for name in cpu.initial
             if not name.endswith("attn.key.bias")]
    grad_l2 = {name: rel_err(card.first_grads[name].numpy(),
                             cpu.first_grads[name].numpy())
               for name in names}
    delta_l2 = {name: rel_err((card.final[name] - card.initial[name]).numpy(),
                              (cpu.final[name] - cpu.initial[name]).numpy())
                for name in names}
    same_start = all(torch.equal(card.initial[n], cpu.initial[n])
                     for n in cpu.initial)
    bundle = os.path.join(root, "twin_cuda")
    predict = load_predictor(bundle, device=DEVICE)
    tokens = np.random.default_rng(SEED + 3).integers(
        0, 256, (2, RAGGED_TOKENS)).astype(np.int32)
    before = fa.launches
    served = predict(tokens)
    served_launches = fa.launches - before
    model = models["cuda"].eval()
    with torch.inference_mode():
        want = model(torch.from_numpy(tokens).to(DEVICE)).cpu().numpy()
    served_err = rel_err(served, want)
    result = {"losses_cuda": losses["cuda"], "losses_cpu": losses["cpu"],
              "loss_max_rel_diff": max(rel),
              "grad_l2_worst": max(grad_l2.items(), key=lambda kv: kv[1]),
              "grad_l2_median": float(np.median(list(grad_l2.values()))),
              "delta_l2_worst": max(delta_l2.items(), key=lambda kv: kv[1]),
              "delta_l2_median": float(np.median(list(delta_l2.values()))),
              "tol": TRAJ_TOL, "served_rel_err": served_err,
              "served_flash_launches": served_launches}
    print("zoo twin training", json.dumps(result), flush=True)
    check(same_start, "twin: card and CPU runs start from other weights")
    check(len(rel) == 5, f"twin steps: {len(rel)}")
    check(max(rel) <= TRAJ_TOL["loss"], f"twin card vs CPU losses: {result}")
    check(max(grad_l2.values()) <= TRAJ_TOL["grad_l2"],
          f"twin card vs CPU first-step gradients: {grad_l2}")
    check(max(delta_l2.values()) <= TRAJ_TOL["delta_l2"],
          f"twin card vs CPU parameter changes: {delta_l2}")
    check(losses["cuda"][-1] < losses["cuda"][0], "twin loss did not fall")
    check(served_launches == model.cfg.n_layers,
          f"served bundle made {served_launches} flash launches")
    check(served_err <= LOGITS_REL_TOL, f"served bundle: {served_err}")
    return result


def training_phase(torch, fa, root):
    """The flagship trained through LocalExecutor on the card."""
    from elasticdl_tpu_torch.api.local_executor import LocalExecutor
    from elasticdl_tpu_torch.testing import data as tdata

    zoo = os.path.join(root, "zoo")
    os.makedirs(os.path.join(zoo, "flagship"))
    with open(os.path.join(zoo, "flagship", "lm.py"), "w") as f:
        f.write(FLAGSHIP_ZOO)
    seq, vocab = FLAGSHIP["max_len"], FLAGSHIP["vocab_size"]
    records = tdata.create_lm_record_file(
        os.path.join(root, "flagship.rec"), TRAIN_STEPS * TRAIN_BATCH,
        seed=SEED, seq_len=seq, vocab=vocab)
    args = tdata.make_local_args(zoo, "flagship.lm.custom_model", records,
                                 minibatch_size=TRAIN_BATCH,
                                 extra=["--random_seed", str(SEED)])
    record = step_recorder(torch)
    executor = LocalExecutor(args, callbacks=[record])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = 0   # the main path
    result = executor.run()
    counts = {"flash_attention_fwd": fa.launches,                # ... ends
              "flash_attention_bwd_dq": fa.dq_launches,
              "flash_attention_bwd_dkv": fa.dkv_launches}
    peak = torch.cuda.max_memory_allocated()
    clocks = smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    steps = result["steps"]
    layers = FLAGSHIP["n_layers"]
    losses = [float(x) for x in record.loss]
    finite = all(bool(torch.isfinite(p).all())
                 for p in executor.state.model.parameters())
    warm = 5
    window = 5
    step_ms, issue_ms = [], []
    for i in range(warm, steps - window + 1, window):
        start = record.events[i][0]
        end = record.events[i + window - 1][1]
        step_ms.append(start.elapsed_time(end) / window)
        issue_ms.append(float(np.mean(record.issue_ms[i:i + window])))
    median = float(np.median(step_ms))
    out = {
        "model": "transformer flagship (bench_suite.py _TRANSFORMER_SIZES"
                 "['transformer'], remat off, dropout 0), random weights, "
                 f"seed {SEED}, Adam 1e-3",
        "batch": TRAIN_BATCH, "seq": seq, "steps": steps,
        "launches": counts, "launches_per_step": {
            k: v / steps for k, v in counts.items()},
        "step_ms": spread(step_ms), "issue_ms": spread(issue_ms),
        "tokens_per_s": TRAIN_BATCH * seq / (median / 1e3),
        "max_memory_allocated_bytes": peak,
        "first_loss": losses[0], "last_loss": losses[-1],
        "losses": losses, "params_finite": finite,
        "clocks_after": clocks,
    }
    check(steps == TRAIN_STEPS, f"{steps} steps, not {TRAIN_STEPS}")
    for name, n in counts.items():
        check(n == layers * steps,
              f"{name}: {n} launches in {steps} steps of {layers} layers")
    check(finite, "a parameter is not finite after training")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < 0.9 * losses[0],
          f"loss did not fall: {losses[0]} -> {losses[-1]}")
    return out, counts



# Data parallel over the one-card mesh (``--phase parallel`` runs it
# alone and builds only the two embedding sources). (a) cifar10 at B 256
# through make_runner_for_spec, dp4 against dp1 from the same weights;
# (b) resnet50 at B 128 x 224^2 through MiniCluster + InProcessMaster in
# tasks of PAR_TASK_STEPS steps, the master's resize barrier taking it
# dp4 -> dp2 -> dp4, against an unresized dp4 run over the same records,
# and its step ms at dp4, dp2 and dp1; (c) the recsys ranker at 1M x 256,
# B 512, its table and accumulator row-split 4 x 250,000 through the
# zoo's make_sparse_runner(mesh=), kernels pinned: against the unsharded
# runner, a live dp4 -> dp2 resize, a dp4 checkpoint restored at dp2,
# every shard's kernel launch held against its plain version, and one
# fused SGD step (#8 once a shard).
PAR_N = 4
PAR_CIFAR_BATCH, PAR_CIFAR_STEPS = 256, 8
PAR_TASK_STEPS, PAR_TASKS = 2, 4
PAR_WARM, PAR_TIMED = 1, 4
PAR_RECSYS_STEPS, PAR_RECSYS_MORE = 8, 4


def card_mesh(torch, n, axis="dp"):
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((n,), (axis,), [torch.device("cuda:0")] * n)


class Deterministic:
    """cuDNN's deterministic algorithms for a comparison that must be
    bit-equal (its default convolution backward sums with atomics)."""

    def __init__(self, torch):
        self.backends = torch.backends.cudnn

    def __enter__(self):
        self.saved = (self.backends.deterministic, self.backends.benchmark)
        self.backends.deterministic, self.backends.benchmark = True, False

    def __exit__(self, *exc):
        self.backends.deterministic, self.backends.benchmark = self.saved


def slot_bytes(optimizer):
    """Bytes of optimizer state each entry holds (its slices of the split
    slots), and the bytes of the slots held whole."""
    from elasticdl_tpu_torch.parallel.mesh import ShardedTensor

    entries, replicated = [0] * optimizer.num_entries, 0
    for _, _, value in optimizer.named_slots():
        if isinstance(value, ShardedTensor):
            for e, shard in enumerate(value.shards):
                entries[e] += shard.numel() * shard.element_size()
        elif hasattr(value, "dim") and value.dim():
            replicated += value.numel() * value.element_size()
    return {"entries": entries, "replicated": replicated}


def parallel_cifar10_part(torch, fa, pe):
    """(a) cifar10_functional at B 256 through make_runner_for_spec with
    its LR schedule folded in, dp4 against dp1 from the same weights,
    PAR_CIFAR_STEPS steps: bit-equal losses, parameters and slots."""
    from elasticdl_tpu_torch.callbacks import apply_callbacks_to_optimizer
    from elasticdl_tpu_torch.checkpoint import state_io
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.parallel.mesh_runner import make_runner_for_spec
    from elasticdl_tpu_torch.testing import data as tdata

    rng = np.random.default_rng(SEED + 60)
    batches = [{"features": rng.random((PAR_CIFAR_BATCH, 32, 32, 3),
                                       dtype=np.float32),
                "labels": rng.integers(0, 10, PAR_CIFAR_BATCH).astype(
                    np.int32),
                "mask": np.ones(PAR_CIFAR_BATCH, np.float32)}
               for _ in range(PAR_CIFAR_STEPS)]
    runs = {}
    for n in (PAR_N, 1):
        torch.manual_seed(SEED)
        spec = get_model_spec(tdata.model_zoo_dir(),
                              "cifar10.cifar10_functional.custom_model",
                              device="cuda")
        mesh = card_mesh(torch, n)
        runner = make_runner_for_spec(spec, mesh)
        tx = apply_callbacks_to_optimizer(
            spec.make_optimizer(),
            spec.callbacks_fn() if spec.callbacks_fn else [])
        state = runner.init_state(spec.model, tx, seed=SEED)
        step = runner.train_step(spec.loss)
        with Deterministic(torch):
            torch.cuda.synchronize()
            reset_kernel_launches(fa, pe)        # the dp path starts here
            losses = [step(state, b)[1]["loss"] for b in batches]
            torch.cuda.synchronize()
            counts = kernel_launch_counts(fa, pe)   # ... and ends
        runs[n] = dict(losses=torch.stack(losses).cpu(), counts=counts,
                       leaves=state_io.named_leaves_from_state(state),
                       slots=slot_bytes(state.optimizer),
                       entries=state.optimizer.num_entries)
    a, b = runs[PAR_N], runs[1]
    unequal = [k for k in b["leaves"]
               if not np.array_equal(a["leaves"][k], b["leaves"][k])]
    out = {"model": "cifar10_functional twin (zoo LR schedule, SGD 0.1 "
                    f"momentum 0.9), random weights, seed {SEED}",
           "batch": PAR_CIFAR_BATCH, "steps": PAR_CIFAR_STEPS,
           "losses_dp4": a["losses"].tolist(),
           "losses_dp1": b["losses"].tolist(),
           "leaves": len(b["leaves"]), "unequal_leaves": unequal,
           "slot_bytes_dp4": a["slots"], "slot_bytes_dp1": b["slots"],
           "launches": a["counts"]}
    print("parallel cifar10", json.dumps(out), flush=True)
    check(a["entries"] == PAR_N and b["entries"] == 1,
          f"cifar10 entries {a['entries']} / {b['entries']}")
    check(torch.equal(a["losses"], b["losses"]),
          f"cifar10 dp4 vs dp1 losses {out}")
    check(not unequal, f"cifar10 dp4 vs dp1 leaves differ: {unequal}")
    split = a["slots"]["entries"]
    check(len(set(split)) == 1 and split[0] > 0
          and PAR_N * split[0] + a["slots"]["replicated"]
          == b["slots"]["replicated"],
          f"cifar10 slot bytes {a['slots']} vs {b['slots']}")
    check(not any(a["counts"].values()), f"cifar10 launched {a['counts']}")
    check(all(np.isfinite(out["losses_dp4"])), "cifar10 non-finite loss")
    return out, a["counts"]


def write_resnet_records(path, num, seed):
    from elasticdl_tpu_torch.common import tensor_utils
    from elasticdl_tpu_torch.data.record_file import RecordFileWriter

    rng = np.random.default_rng(seed)
    with RecordFileWriter(path) as writer:
        for _ in range(num):
            image = rng.integers(0, 256, (RESNET_HW, RESNET_HW, 3),
                                 dtype=np.uint8)
            writer.write(tensor_utils.dumps(
                {"image": image, "label": int(rng.integers(10))}))
    return path


def resnet_cluster_run(torch, fa, pe, records, resize):
    """resnet50 through MiniCluster(mesh=dp4): the worker's runner
    records each step's loss and mesh; with ``resize`` the master's
    barrier is opened for dp2 at the first report and for dp4 at the
    first report after the worker has applied it."""
    from elasticdl_tpu_torch.testing import data as tdata
    from elasticdl_tpu_torch.testing.cluster import MiniCluster

    box = {"rids": [], "seconds": []}

    def on_report(request):
        if not resize:
            return
        worker = box["cluster"].workers[0]
        dp = worker._step_runner.mesh.shape["dp"]
        pending = box["cluster"].servicer.resize_status() is not None
        if not box["rids"]:
            box["rids"].append(box["cluster"].begin_resize(
                card_mesh(torch, 2), direction="shrink"))
        elif len(box["rids"]) == 1 and dp == 2 and not pending:
            box["rids"].append(box["cluster"].begin_resize(
                card_mesh(torch, PAR_N), direction="grow"))

    cluster = MiniCluster(
        tdata.model_zoo_dir(), "resnet50.resnet50.custom_model",
        training_data=records, minibatch_size=RESNET_BATCH,
        num_minibatches_per_task=PAR_TASK_STEPS, device="cuda",
        random_seed=SEED, mesh=card_mesh(torch, PAR_N),
        worker_callbacks={"report_task_result": on_report})
    box["cluster"] = cluster
    worker = cluster.workers[0]
    record = RecordingRunner(torch, worker._step_runner)
    meshes = []
    inner_step = record.train_step

    def train_step(loss_fn):
        step = inner_step(loss_fn)

        def stepped(state, batch):
            meshes.append(record._inner.mesh.shape["dp"])
            return step(state, batch)

        return stepped

    record.train_step = train_step
    worker._step_runner = record
    observe = worker._m_resize.observe

    def observed(seconds, *args, **kwargs):
        box["seconds"].append(seconds)
        return observe(seconds, *args, **kwargs)

    worker._m_resize.observe = observed
    with Deterministic(torch):
        torch.cuda.synchronize()
        reset_kernel_launches(fa, pe)          # the worker's path starts
        result = cluster.run()[0]
        torch.cuda.synchronize()
        counts = kernel_launch_counts(fa, pe)  # ... and ends
    return dict(cluster=cluster, worker=worker, result=result,
                losses=torch.stack(record.loss).float().cpu(),
                meshes=meshes, counts=counts, rids=box["rids"],
                resize_seconds=box["seconds"],
                params={k: v.detach().clone() for k, v in
                        worker.state.model.named_parameters()})


def resnet_step_ms(torch):
    """resnet50's step (CUDA events) at dp4, dp2 and dp1 on one model:
    each mesh's MeshRunner with its own ZeRO optimizer."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner
    from elasticdl_tpu_torch.testing import data as tdata

    torch.manual_seed(SEED)
    spec = get_model_spec(tdata.model_zoo_dir(),
                          "resnet50.resnet50.custom_model", device="cuda")
    rng = np.random.RandomState(SEED)
    batches = [{"features": rng.rand(RESNET_BATCH, RESNET_HW, RESNET_HW,
                                     3).astype(np.float32),
                "labels": rng.randint(0, 10, RESNET_BATCH).astype(np.int32),
                "mask": np.ones(RESNET_BATCH, np.float32)}
               for _ in range(2)]
    out = {}
    for n in (PAR_N, 2, 1):
        runner = MeshRunner(card_mesh(torch, n))
        state = runner.init_state(spec.model, spec.make_optimizer(),
                                  seed=SEED)
        step = runner.train_step(spec.loss)
        events, issue = [], []
        for i in range(PAR_WARM + PAR_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, _ = step(state, batches[i % 2])
            end.record()
            issue.append((time.perf_counter() - t0) * 1e3)
            events.append((start, end))
        torch.cuda.synchronize()
        out[f"dp{n}"] = {
            "step_ms": spread([s.elapsed_time(e)
                               for s, e in events[PAR_WARM:]]),
            "issue_ms": spread(issue[PAR_WARM:]),
            "slot_bytes": slot_bytes(state.optimizer)}
        del state, runner, step
    return out


def parallel_resnet50_part(torch, fa, pe, root):
    """(b) resnet50 at B 128 x 224^2 through MiniCluster on dp4, resized
    live dp4 -> dp2 -> dp4 by the master's barrier, against an
    unresized dp4 run over the same records: bit-equal losses and
    parameters (cuDNN deterministic in both). Its step ms at dp4, dp2
    and dp1 (``resnet_step_ms``) is taken apart, with no writer thread
    beside it."""
    records = write_resnet_records(
        os.path.join(root, "resnet.rec"),
        PAR_TASKS * PAR_TASK_STEPS * RESNET_BATCH, SEED + 61)
    resized = resnet_cluster_run(torch, fa, pe, records, resize=True)
    straight = resnet_cluster_run(torch, fa, pe, records, resize=False)
    worker = resized["worker"]
    unequal = [k for k, v in straight["params"].items()
               if not torch.equal(v, resized["params"][k])]
    out = {"model": "resnet50 twin (s2d stem, bf16, SGD 0.02 Nesterov), "
                    f"random weights, seed {SEED}",
           "batch": RESNET_BATCH, "image_hw": RESNET_HW,
           "task_steps": PAR_TASK_STEPS,
           "meshes": resized["meshes"], "resize_ids": resized["rids"],
           "worker_resize_seconds": resized["resize_seconds"],
           "losses_resized": resized["losses"].tolist(),
           "losses_straight": straight["losses"].tolist(),
           "unequal_params": unequal, "launches": resized["counts"],
           "card": smi("name,power.limit")}
    print("parallel resnet50", json.dumps(out), flush=True)
    meshes = resized["meshes"]
    check(resized["cluster"].finished and straight["cluster"].finished,
          "a resnet50 job did not drain")
    check(len(resized["rids"]) == 2
          and worker._applied_resize_id == resized["rids"][-1]
          and len(resized["resize_seconds"]) == 2,
          f"resnet50 resizes {out}")
    first2 = meshes.index(2) if 2 in meshes else -1
    check(first2 > 0 and meshes[0] == PAR_N and meshes[-1] == PAR_N
          and PAR_N in meshes[first2:],
          f"resnet50 meshes per step {meshes}")
    check(set(straight["meshes"]) == {PAR_N},
          f"straight run meshes {straight['meshes']}")
    check(worker.state.optimizer.num_entries == PAR_N,
          "resnet50 ends off dp4")
    check(len(meshes) == PAR_TASKS * PAR_TASK_STEPS,
          f"resnet50 {len(meshes)} steps")
    check(torch.equal(resized["losses"], straight["losses"]),
          f"resized vs straight losses {out}")
    check(not unequal, f"resized vs straight parameters differ: {unequal}")
    check(all(np.isfinite(out["losses_resized"])), "resnet50 non-finite")
    check(not any(resized["counts"].values()),
          f"resnet50 launched {resized['counts']}")
    return out, resized["counts"]


def shard_kernel_checks(torch, pe, shards, slot_shards, ids, weights, uids,
                        grads, opt, first=0):
    """Each shard's launches of #6 and #7 (and #8 for SGD) on the local
    ids the sharded step gives it, against the plain version of the same
    shard on the card (outside every counted window). ``shards[0]`` is
    shard ``first`` of the table (a process holds its own)."""
    from elasticdl_tpu_torch.embedding import optimizer as topt

    rows = int(shards[0].shape[0])
    out = []
    for i, shard in enumerate(shards, start=first):
        local = ids - i * rows
        in_range = (local >= 0) & (local < rows)
        w_local = torch.where(in_range, weights, 0.0)
        local_c = local.clamp(0, rows - 1)
        got = pe.lookup_combine_pallas(shard, local_c, w_local, "sum")
        want = pe.lookup_combine_reference(shard, local_c, w_local, "sum")
        lookup = grad_readings(got, want)
        lu = uids - i * rows
        lu = torch.where((lu >= 0) & (lu < rows), lu, rows).to(torch.int32)
        slots = slot_shards[i - first]
        tables = [shard.clone()] + [s.clone() for s in slots]
        plain = [t.clone() for t in tables]
        if slots:
            topt._pallas_sparse_apply(
                opt, tables[0], {"accumulator": tables[1]}, lu, grads, 1)
            pe.row_update_reference("adagrad", lu, grads, plain, lr=opt.lr,
                                    eps=opt.epsilon)
        else:
            pe.fused_sgd_scatter_apply(tables[0], lu, grads, lr=opt.lr)
            pe.row_update_reference("sgd", lu, grads, plain, lr=opt.lr)
        touched = lu[lu < rows].long()
        res = {"shard": i, "rows": int(touched.numel()),
               "lookup": lookup,
               "table": grad_readings(tables[0][touched] - shard[touched],
                                      plain[0][touched] - shard[touched])}
        if slots:
            res["accumulator"] = grad_readings(tables[1][touched],
                                               plain[1][touched])
        keep = torch.ones(rows, dtype=torch.bool, device=shard.device)
        keep[touched] = False
        res["untouched_bit_equal"] = bool(
            torch.equal(tables[0][keep], shard[keep]))
        out.append(res)
        del tables, plain
    return out


def parallel_recsys_start(torch, fa, pe, root, reuse=None):
    """(c), first half: the recsys ranker at 1M x 256, B 512, row-sharded
    over dp4 through the zoo's make_sparse_runner(mesh=),
    use_pallas="always", against the unsharded runner from the same
    seed; each dp4 shard's kernels against their plain version; a dp4
    checkpoint started (its writer thread runs on while (a) and (b)
    run); the live resize to dp2 and 4 more steps. Returns what the
    second half needs; fills ``reuse["recsys"]`` with the dp4 run at
    step 8 for the multihost phase (``mh_recsys_reference``)."""
    from elasticdl_tpu_torch.checkpoint import CheckpointHook
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.embedding.device_sparse import _unique_pad
    from elasticdl_tpu_torch.parallel.mesh import ShardedTensor

    zoo = write_zoo(root, "recsys_par", RECSYS_ZOO.format(mode="always"))
    model_def = "recsys_par.rec.custom_model"
    rng = np.random.default_rng(SEED + 62)
    batches = []
    for _ in range(PAR_RECSYS_STEPS + PAR_RECSYS_MORE + 1):
        ids = rng.integers(0, EMB_VOCAB, (EMB_BATCH, EMB_IDS))
        batches.append({"features": {"ids": ids},
                        "labels": (ids.sum(axis=1) % 2).astype(np.int32),
                        "mask": np.ones(EMB_BATCH, np.float32)})
    runs = {}
    for name, n in (("dp4", PAR_N), ("whole", None)):
        torch.manual_seed(SEED)
        spec = get_model_spec(zoo, model_def, device="cuda")
        runner = spec.make_sparse_runner(
            mesh=card_mesh(torch, n) if n else None)
        state = runner.init_state(spec.model, spec.make_optimizer(),
                                  batches[0], seed=SEED)
        runs[name] = dict(spec=spec, runner=runner, state=state,
                          step=runner.train_step(spec.loss))
    sharded, whole = runs["dp4"], runs["whole"]
    table0 = whole["state"].tables[RECSYS_TABLE].clone()
    t4 = sharded["state"].tables[RECSYS_TABLE]
    check(isinstance(t4, ShardedTensor) and len(t4.shards) == PAR_N
          and t4.shards[0].shape == (EMB_VOCAB // PAR_N, EMB_DIM)
          and torch.equal(t4.gather(), table0),
          "the sharded table does not start as the whole one")

    def train(run, part):
        losses = []
        for b in part:
            run["state"], m = run["step"](run["state"], b)
            losses.append(m["loss"])
        return losses

    torch.cuda.synchronize()
    reset_kernel_launches(fa, pe)              # the dp4 path starts here
    loss4 = train(sharded, batches[:PAR_RECSYS_STEPS])
    torch.cuda.synchronize()
    counts_dp4 = kernel_launch_counts(fa, pe)  # ... and ends
    counts_dp4["row_update_adagrad"] = pe.row_update_rule_launches["adagrad"]
    loss1 = train(whole, batches[:PAR_RECSYS_STEPS])
    state4 = sharded["state"]
    # Every dp4 shard's kernels against their plain version on the next
    # batch's ids (outside the counted windows).
    nxt = batches[-1]["features"]["ids"]
    ids = torch.from_numpy(nxt).to("cuda", torch.int32)
    weights = torch.ones(ids.shape, device="cuda")
    uids, _ = _unique_pad(ids.reshape(-1), EMB_VOCAB)
    grads = torch.from_numpy(np.random.default_rng(SEED + 63).standard_normal(
        (uids.numel(), EMB_DIM), dtype=np.float32)).cuda()
    shard_checks = shard_kernel_checks(
        torch, pe, state4.tables[RECSYS_TABLE].shards,
        [[a] for a in state4.slot_tables[RECSYS_TABLE][
            "accumulator"].shards], ids, weights, uids, grads,
        sharded["runner"].row_opt)
    # The dp4 state at step 8, gathered on the card, and its checkpoint
    # (written in the background while the resize runs).
    saved = {"table": state4.tables[RECSYS_TABLE].gather(),
             "accumulator": state4.slot_tables[RECSYS_TABLE][
                 "accumulator"].gather(),
             "params": {k: v.detach().clone() for k, v in
                        state4.model.named_parameters()}}
    if reuse is not None:
        reuse["recsys"] = mh_recsys_reference(
            loss4, touched_rows(torch, np.stack(
                [b["features"]["ids"] for b in batches[:MH_STEPS]]),
                EMB_VOCAB), table0, saved["table"], saved["accumulator"])
    ckpt = os.path.join(root, "par_ckpt")
    hook = CheckpointHook(checkpoint_dir=ckpt,
                          checkpoint_steps=PAR_RECSYS_STEPS)
    check(hook.maybe_save(state4), "the dp4 checkpoint was not written")
    t0 = time.monotonic()
    state4 = sharded["runner"].resize(card_mesh(torch, 2), state4)
    torch.cuda.synchronize()
    resize_s = time.monotonic() - t0
    sharded["state"] = state4
    sharded["step"] = sharded["runner"].train_step(sharded["spec"].loss)
    kept = (torch.equal(state4.tables[RECSYS_TABLE].gather(),
                        saved["table"])
            and torch.equal(state4.slot_tables[RECSYS_TABLE][
                "accumulator"].gather(), saved["accumulator"]))
    shards2 = len(state4.tables[RECSYS_TABLE].shards)
    reset_kernel_launches(fa, pe)              # the dp2 path starts here
    loss4 += train(sharded, batches[PAR_RECSYS_STEPS:-1])
    torch.cuda.synchronize()
    counts_dp2 = kernel_launch_counts(fa, pe)  # ... and ends
    loss1 += train(whole, batches[PAR_RECSYS_STEPS:-1])
    # The readings against the unsharded run, before its state is
    # reused for the restore.
    loss4 = [float(x) for x in loss4]
    loss1 = [float(x) for x in loss1]
    touched = touched_rows(torch, np.stack(
        [b["features"]["ids"] for b in batches[:-1]]), EMB_VOCAB)
    final4 = state4.tables[RECSYS_TABLE].gather()
    acc4 = state4.slot_tables[RECSYS_TABLE]["accumulator"].gather()
    final1 = whole["state"].tables[RECSYS_TABLE]
    acc1 = whole["state"].slot_tables[RECSYS_TABLE]["accumulator"]
    delta4 = (final4[touched] - table0[touched]).cpu().numpy()
    delta1 = (final1[touched] - table0[touched]).cpu().numpy()
    acc_l2 = rel_err(acc4[touched].cpu().numpy(),
                     acc1[touched].cpu().numpy())
    untouched = ~touched
    untouched_equal = bool(torch.equal(final4[untouched], table0[untouched])
                           and bool((acc4[untouched] == 0.1).all()))
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(loss4, loss1))
    del final4, acc4, final1, acc1, state4, table0
    sharded.clear()
    return dict(whole=whole, hook=hook, ckpt=ckpt, saved=saved,
                batches=batches, probe=(ids, weights, uids, grads),
                counts_dp4=counts_dp4, counts_dp2=counts_dp2,
                out={"batch": EMB_BATCH, "steps_dp4": PAR_RECSYS_STEPS,
                     "steps_dp2": PAR_RECSYS_MORE,
                     "losses_sharded": loss4, "losses_whole": loss1,
                     "loss_max_rel_diff": loss_rel,
                     "table_delta_l2": rel_err(delta4, delta1),
                     "accumulator_l2": acc_l2,
                     "untouched_bit_equal": untouched_equal,
                     "resize_kept_state": kept, "resize_shards": shards2,
                     "resize_s": resize_s, "shard_checks": shard_checks})


def parallel_recsys_finish(torch, fa, pe, started):
    """(c), second half: the dp4 checkpoint restored into the unsharded
    state (a restore lands whole) and placed by a dp2 runner, bit-equal
    to the state it saved; then that state placed on dp4 takes one fused
    SGD step (#8 once a shard), each shard's #8 held to its plain
    version. Checks the whole of (c)."""
    from elasticdl_tpu_torch.checkpoint import restore_from_dir
    from elasticdl_tpu_torch.embedding.device_sparse import (
        DeviceSparseRunner,
        build_sparse_train_step,
        sparse_template,
    )
    from elasticdl_tpu_torch.embedding.optimizer import SGD
    from elasticdl_tpu_torch.model_zoo.recsys import recsys_sparse as twin

    whole, saved = started["whole"], started["saved"]
    counts_dp4, counts_dp2 = started["counts_dp4"], started["counts_dp2"]
    batches, out = started["batches"], started["out"]
    ids, weights, uids, grads = started["probe"]
    started["hook"].flush()
    runner2 = whole["spec"].make_sparse_runner(mesh=card_mesh(torch, 2))
    t0 = time.monotonic()
    restored = restore_from_dir(whole["state"], started["ckpt"])
    restored = runner2.place_state(restored)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    restored_equal = {
        "table": torch.equal(restored.tables[RECSYS_TABLE].gather(),
                             saved["table"]),
        "accumulator": torch.equal(restored.slot_tables[RECSYS_TABLE][
            "accumulator"].gather(), saved["accumulator"]),
        "params": all(torch.equal(v, saved["params"][k]) for k, v in
                      restored.model.named_parameters()),
        "step": restored.step == PAR_RECSYS_STEPS,
        "shards": len(restored.tables[RECSYS_TABLE].shards) == 2}
    del saved
    whole.clear()
    started.clear()
    # One fused SGD step on that state placed on dp4: #8 once a shard.
    opt = SGD(lr=0.05)
    fused_runner = DeviceSparseRunner(twin.TABLE_SPECS, opt,
                                      use_pallas="fused",
                                      mesh=card_mesh(torch, PAR_N))
    fstate = fused_runner.place_state(restored)
    fstep = build_sparse_train_step(
        twin.loss, fused_runner.specs, opt, sparse_template(fstate.model),
        use_pallas="fused", mesh=fused_runner.mesh,
        sharded_tables=fused_runner.sharded_tables)
    before = fstate.tables[RECSYS_TABLE].gather()
    torch.cuda.synchronize()
    reset_kernel_launches(fa, pe)              # the fused path starts here
    fstate, fm = fstep(fstate, batches[0])
    torch.cuda.synchronize()
    counts_fused = kernel_launch_counts(fa, pe)  # ... and ends
    fused_moved = int((fstate.tables[RECSYS_TABLE].gather() != before)
                      .any(dim=1).sum())
    fused_checks = shard_kernel_checks(
        torch, pe, fstate.tables[RECSYS_TABLE].shards, [[]] * PAR_N, ids,
        weights, uids, grads, opt)
    fused_loss = float(fm["loss"])
    del fstate, restored, fused_runner, before
    torch.cuda.empty_cache()
    out = {"model": "recsys ranker twin (1,000,000 x 256 f32 table "
                    "row-split 4 x 250,000, 32 ids an example, Adagrad "
                    "rows lr 0.05, bf16 MLP, Adam 1e-3), random weights, "
                    f"seed {SEED}", **out,
           "launches_dp4": counts_dp4, "launches_dp2": counts_dp2,
           "launches_fused": counts_fused,
           "restore_s": restore_s, "restored_equal": restored_equal,
           "fused_checks": fused_checks,
           "fused_rows_moved": fused_moved, "fused_loss": fused_loss,
           "tol": SPARSE_TOL, "kernel_tol": EMB_TOL}
    print("parallel recsys", json.dumps(out), flush=True)
    steps4, steps2 = PAR_RECSYS_STEPS, PAR_RECSYS_MORE
    check(counts_dp4["lookup_combine"] == PAR_N * steps4
          and counts_dp4["row_update"] == PAR_N * steps4
          and counts_dp4["row_update_adagrad"] == PAR_N * steps4
          and not any(v for k, v in counts_dp4.items()
                      if k not in ("lookup_combine", "row_update",
                                   "row_update_adagrad")),
          f"dp4 launches {counts_dp4} for {steps4} steps of {PAR_N} shards")
    check(counts_dp2["lookup_combine"] == 2 * steps2
          and counts_dp2["row_update"] == 2 * steps2
          and not any(v for k, v in counts_dp2.items()
                      if k not in ("lookup_combine", "row_update")),
          f"dp2 launches {counts_dp2} for {steps2} steps of 2 shards")
    check(counts_fused["fused_row_update"] == PAR_N
          and not any(v for k, v in counts_fused.items()
                      if k != "fused_row_update"),
          f"fused launches {counts_fused}")
    check(out["resize_kept_state"] and out["resize_shards"] == 2,
          "the live resize changed the state")
    check(all(restored_equal.values()),
          f"the dp4 checkpoint restored at dp2: {restored_equal}")
    check(out["untouched_bit_equal"], "an untouched row or accumulator moved")
    check(all(np.isfinite(out["losses_sharded"])), "non-finite sharded loss")
    check(out["loss_max_rel_diff"] <= SPARSE_TOL["loss"],
          f"sharded vs whole losses {out}")
    check(out["table_delta_l2"] <= SPARSE_TOL["delta_l2"]
          and out["accumulator_l2"] <= SPARSE_TOL["delta_l2"],
          f"sharded vs whole rows {out}")
    for res in out["shard_checks"] + fused_checks:
        check(emb_within(res["lookup"], EMB_TOL["lookup"]),
              f"shard lookup outside tolerance {res}")
        check(emb_within(res["table"], EMB_TOL["rows"])
              and ("accumulator" not in res
                   or emb_within(res["accumulator"], EMB_TOL["rows"])),
              f"shard row update outside tolerance {res}")
        check(res["untouched_bit_equal"],
              f"a shard's untouched row moved {res}")
    check(fused_moved > 0 and np.isfinite(fused_loss),
          f"the fused step moved {fused_moved} rows")
    return out, counts_dp4, counts_dp2, counts_fused


def parallel_phase(torch, fa, pe, root, reuse=None):
    """(c)'s first half, then (a) and (b) while (c)'s checkpoint is
    written, (c)'s second half, then resnet50's step times, then (d) the
    flagship on a one-process (1, 2, 2) dp/sp/tp mesh
    (``parallel_tp_part``, kept in ``reuse`` for the multihost phase);
    returns the phase's line and its launches by part."""
    marks = [time.monotonic()]
    started = parallel_recsys_start(torch, fa, pe, root, reuse)
    marks.append(time.monotonic())
    cifar, cifar_counts = parallel_cifar10_part(torch, fa, pe)
    marks.append(time.monotonic())
    resnet, resnet_counts = parallel_resnet50_part(torch, fa, pe, root)
    marks.append(time.monotonic())
    recsys, dp4, dp2, fused = parallel_recsys_finish(torch, fa, pe, started)
    marks.append(time.monotonic())
    resnet["step"] = resnet_step_ms(torch)
    marks.append(time.monotonic())
    tp, tp_counts, tp_ref = parallel_tp_part(torch, fa, pe, root)
    if reuse is not None:
        reuse["tp"] = tp_ref
    marks.append(time.monotonic())
    part_s = dict(zip(("recsys_start", "cifar10", "resnet50",
                       "recsys_finish", "resnet50_step_ms", "tp"),
                      np.diff(marks).tolist()))
    print("parallel step ms", json.dumps(resnet["step"]), flush=True)
    return {"cifar10": cifar, "resnet50": resnet, "recsys": recsys,
            "tp": tp, "part_s": part_s,
            "launches": {"cifar10": cifar_counts, "resnet50": resnet_counts,
                         "recsys_dp4": dp4, "recsys_dp2": dp2,
                         "fused": fused, "tp_one_process": tp_counts}}


# ---- tensor parallel and the ring across processes (item 6b, 2b-4) -------
#
# The flagship at full width (vocab 32768, d_model 512, 4 heads of 128,
# d_ff 2048, bf16) through the zoo twin's rules and make_runner_for_spec,
# weights from the seed through bridge.py. Depth 2 and B 2 x S 512: the
# logits cross the processes as f32 (B x S x 32768, 128 MB at this size,
# gathered over tp through the host by gloo), and the parts run beside
# the checkpoint jobs; 512 positions give every ring chunk 256 rows, two
# of #2's 128-row q tiles. The parallel phase runs it on a one-process
# (1, 2, 2) dp/sp/tp mesh against the unsharded run (the reference of
# the processes' (d) and (e) too); the processes run (d) tp across them
# (with (d') one step on a (1, 2) dp/tp mesh, where attention does not
# ring and #1 takes each entry's two heads), (e) sp across them and (f)
# the 4 MB table split over them.
TP_LAYERS, TP_SEQ, TP_BATCH, TP_STEPS = 2, 512, 2, 3
TP_ZOO = f"""
import torch

from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as twin
from elasticdl_tpu_torch.model_zoo.transformer.transformer_lm import (
    batch_sharding_rule, dataset_fn, eval_metrics_fn, loss, optimizer,
    param_sharding_rules)
from elasticdl_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(vocab_size=32768, d_model=512, n_heads=4,
                           n_layers={TP_LAYERS}, d_ff=2048,
                           max_len={TP_SEQ}, compute_dtype=torch.bfloat16)


def custom_model(device=None, mesh=None):
    return twin.custom_model(config=CONFIG, device=device, mesh=mesh)
"""
TP_LAYOUTS = {"one": ((1, 2, 2), ("dp", "sp", "tp")),
              "tp": ((1, 2, 2), ("dp", "tp", "sp")),
              "sp": ((1, 2, 2), ("dp", "sp", "tp")),
              "tp_only": ((1, 2), ("dp", "tp"))}
# The (1, 2, 2) run against the unsharded one (the ring's chunks and the
# row-parallel layers' partial sums in bf16 against #1 over the whole
# sequence), and the processes' runs against the one-process (1, 2, 2)
# run (each process's weight gradients rounded to bf16 before their
# sum): the largest sound readings on the H100 are 2.83e-5 on the loss
# and 3.75e-2 on the changes, so the limits are 3.5x and 2.7x those.
# They bound the drift and cannot tell a misplaced bias: planted (the
# ``tpfault`` phase) it reads 4.3e-5 and 3.9e-2. The probe's gradients
# can: sound 8.2e-3 (one process, tp across, sp across), the bias added
# once an entry 0.299, dropped 0.374; its limit lies between.
TP_TOL = dict(loss=1e-4, delta_l2=1e-1, probe=5e-2)
# The probe: one step of SGD at lr 1 (the parameters' changes are the
# gradients, summed over the processes by the step) from the seed's
# weights with every bias drawn N(0, TP_PROBE_BIAS): Adam's first steps
# read only the gradients' signs and the seed's biases are zero, so the
# runs above cannot see a bias added in the wrong place or a gradient
# summed the wrong number of times; the probe's gradients can.
TP_PROBE_BIAS = 0.05
# (f): DenseFeatures over an identity column of 32768 ids x 32 (f32,
# 4 MB: split P("dp", None) over the processes) and a Dense(1), SGD 0.1,
# the global B 8 (4 a process); against the one-process dp2 run: f32
# sums of two halves against the whole batch's.
TABLE_STEPS, TABLE_BATCH, TABLE_TOL = 3, 8, dict(loss=1e-5, param=1e-6)
_TP_WEIGHTS = {}
_TP_SPECS = {}      # the zoo module's spec, built once a process and root


def tp_weights(cfg):
    """The seed's flagship weights through bridge (drawn once a
    process)."""
    from elasticdl_tpu_torch import bridge

    if not _TP_WEIGHTS:
        _TP_WEIGHTS.update(bridge.state_dict_from_flax(
            bridge.init_flax_params(cfg, seed=SEED)))
    return _TP_WEIGHTS


def tp_probe_weights(torch, cfg):
    """The probe's weights: the seed's, every bias drawn N(0,
    TP_PROBE_BIAS) from the seed."""
    rng = np.random.default_rng(SEED + 82)
    return {k: torch.from_numpy(rng.normal(0.0, TP_PROBE_BIAS, tuple(
                v.shape)).astype(np.float32)) if k.endswith(".bias") else v
            for k, v in tp_weights(cfg).items()}


def tp_batches():
    rng = np.random.default_rng(SEED + 80)
    vocab = FLAGSHIP["vocab_size"]
    out = []
    for _ in range(TP_STEPS):
        start = rng.integers(0, vocab, (TP_BATCH, 1))
        seq = (start + np.arange(TP_SEQ + 1)[None]) % vocab
        out.append({"features": seq[:, :-1].astype(np.int32),
                    "labels": seq[:, 1:].astype(np.int32),
                    "mask": np.ones(TP_BATCH, np.float32)})
    return out


def tp_block(batch, lo, hi):
    """A process's block of the sequence, positions lo to hi."""
    return {k: v[:, lo:hi] if v.ndim == 2 else v for k, v in batch.items()}


def whole_params(runner, state):
    """Every parameter whole on the host in f32: a placed one's blocks
    gathered over its group."""
    shardings = runner.param_shardings(state.model) if runner else {}
    out = {}
    for name, p in state.model.named_parameters():
        s = shardings.get(name)
        value = (s.gather_block(p.detach())
                 if s is not None and s.spans_processes else p.detach())
        out[name] = value.float().cpu()
    return out


def tp_run(torch, fa, pe, root, layout, clock, steps=TP_STEPS, seq=None,
           probe=False, after=None):
    """The flagship zoo module on ``layout``'s mesh (None: unsharded,
    ``core.step``), ``steps`` steps of tp_batches (``seq``: this
    process's positions); flash launches zeroed just before and read
    just after; ``probe``: one step of the probe (TP_PROBE_BIAS);
    ``after(runner, state, spec, mesh, tx)``: called on the trained
    state, its result the record's ``after``. Returns its record and
    its whole parameters."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.core.step import build_train_step
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import make_runner_for_spec

    from elasticdl_tpu_torch.parallel import multihost

    name = f"tp_lm{multihost.process_index()}"
    spec = _TP_SPECS.get(root)
    if spec is None:
        zoo = write_zoo(root, name, TP_ZOO)
        spec = _TP_SPECS[root] = get_model_spec(
            zoo, f"{name}.rec.custom_model", device=DEVICE)
    runner = None
    weights = tp_probe_weights if probe else (lambda _, cfg: tp_weights(cfg))
    tx = ((lambda p: torch.optim.SGD(p, lr=1.0)) if probe
          else spec.make_optimizer())
    steps = 1 if probe else steps
    if layout is None:
        mesh = None
        model = spec.make_model()
        model.load_state_dict(weights(torch, model.cfg))
        state = init_train_state(model, tx, seed=SEED)
        step = build_train_step(spec.loss)
    else:
        shape, axes = TP_LAYOUTS[layout]
        per = int(np.prod(shape)) // multihost.process_count()
        mesh = make_mesh(shape, axes, [torch.device(DEVICE)] * per)
        model = spec.make_model(mesh)
        model.load_state_dict(weights(torch, model.cfg))
        runner = make_runner_for_spec(spec, mesh)
        state = runner.init_state(model, tx, seed=SEED)
        step = runner.train_step(spec.loss)
    batches = tp_batches()[:steps]
    if seq is not None:
        batches = [tp_block(b, *seq) for b in batches]
    if runner is not None:
        batches = [runner.place_batch(b) for b in batches]
    torch.cuda.synchronize()
    reset_kernel_launches(fa, pe)              # the path starts here
    state, losses, times = mh_timed_steps(torch, step, state, batches,
                                          clock)
    torch.cuda.synchronize()
    counts = kernel_launch_counts(fa, pe)      # ... and ends here
    held = {n: list(p.shape) for n, p in state.model.named_parameters()
            if n in ("blocks.0.attn.query.weight", "token_embed.weight",
                     "lm_head.weight", "blocks.0.mlp.wo.weight")}
    record = {"losses": losses, **times, "launches": counts,
              "held_shapes": held}
    params = whole_params(runner, state)
    if after is not None:
        record["after"] = after(runner, state, spec, mesh, tx)
    del state, model
    torch.cuda.empty_cache()
    return record, params


def tp_gaps(got, want, start, got_losses, want_losses):
    """Loss (largest relative gap a step) and parameter changes
    (relative L2 over every parameter but the key biases, whose true
    gradient is 0 and which Adam steps by noise)."""
    keys = [k for k in want if not k.endswith("attn.key.bias")]

    def flat(tree):
        return np.concatenate([(tree[k] - start[k]).numpy().ravel()
                               for k in keys])

    return {"loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                     zip(got_losses, want_losses)),
            "delta_l2": rel_err(flat(got), flat(want))}


def tp_probe_gap(torch, got, want, cfg):
    """The probe's gradients (its one step's changes) against the
    unsharded probe's: relative L2 over every parameter."""
    start = {k: v.float() for k, v in tp_probe_weights(torch, cfg).items()}
    return tp_gaps(got, want, start, [1.0], [1.0])["delta_l2"]


def tp_within(gaps):
    """Whether a run's gaps lie within TP_TOL: its losses and changes,
    and its probe's gradients where it has a probe."""
    return (gaps["loss_max_rel_diff"] <= TP_TOL["loss"]
            and gaps.get("delta_l2", 0.0) <= TP_TOL["delta_l2"]
            and gaps.get("probe_delta_l2", 0.0) <= TP_TOL["probe"])


def tp_expected_launches(layout, steps=TP_STEPS):
    """Exact launches of a run: per layer and step, each local tp entry
    folds its local sp ranks' chunks (all n of them) through #2 in the
    forward and their pairs through #3 and #4 in the backward; without
    a ring, #1 once and #3/#4 once an entry."""
    shape, axes = TP_LAYOUTS[layout]
    size = dict(zip(axes, shape))
    across = {"one": {}, "tp": {"tp": 2}, "sp": {"sp": 2},
              "tp_only": {"tp": 2}}[layout]
    tp_local = size.get("tp", 1) // across.get("tp", 1)
    sp, sp_local = size.get("sp", 1), size.get("sp", 1) // across.get(
        "sp", 1)
    per = steps * TP_LAYERS * tp_local
    out = dict.fromkeys(("lookup_combine", "lookup_combine_aligned",
                         "row_update", "fused_row_update"), 0)
    if sp > 1:
        pairs = per * sp_local * sp
        return {**out, "flash_attention_fwd": 0, "flash_chunk_update": pairs,
                "flash_attention_bwd_dq": pairs,
                "flash_attention_bwd_dkv": pairs}
    return {**out, "flash_attention_fwd": per, "flash_chunk_update": 0,
            "flash_attention_bwd_dq": per, "flash_attention_bwd_dkv": per}


def plant_bias_fault(times):
    """A planted fault of the tensor-parallel layers (the ``tpfault``
    phase's): each row-parallel layer's bias (attention's ``out``, the
    MLP's ``wo``) added ``times(dense)`` times instead of once, by
    wrapping the layers' forwards. Returns the undo."""
    from elasticdl_tpu_torch.models import transformer as tm

    saved = {tm.SelfAttention: ("out", tm.SelfAttention.forward),
             tm.Mlp: ("wo", tm.Mlp.forward)}

    def wrap(forward, last):
        def faulty(self, x):
            dense = getattr(self, last)
            extra = (times(dense) - 1) * dense.bias.to(dense.compute_dtype)
            return forward(self, x) + extra

        return faulty

    for cls, (last, forward) in saved.items():
        cls.forward = wrap(forward, last)

    def undo():
        for cls, (_, forward) in saved.items():
            cls.forward = forward

    return undo


def tp_fault_phase(torch, fa, pe, root):
    """11i (d)'s (1, 2, 2) run and its probe against the unsharded
    ones, sound and with a planted fault: the row-parallel bias added
    once per tp entry (the fault Megatron's layout invites: twice here)
    and not at all. Prints the gaps beside TP_TOL and fails unless
    TP_TOL passes the sound run and refuses both faults."""
    from elasticdl_tpu_torch.models.transformer import TransformerConfig
    from elasticdl_tpu_torch.parallel import multihost
    from elasticdl_tpu_torch.parallel.tensor_parallel import placement

    faults = {"sound": None,
              "bias_per_entry": lambda d: placement(d, "weight").num_shards,
              "bias_dropped": lambda d: 0}
    clock = CollectiveClock(torch, multihost)
    try:
        plain, plain_params = tp_run(torch, fa, pe, root, None, clock)
        _, plain_probe = tp_run(torch, fa, pe, root, None, clock,
                                probe=True)
        runs = {}
        for name, times in faults.items():
            undo = plant_bias_fault(times) if times else (lambda: None)
            try:
                runs[name] = (
                    tp_run(torch, fa, pe, root, "one", clock),
                    tp_run(torch, fa, pe, root, "one", clock, probe=True)[1])
            finally:
                undo()
    finally:
        clock.restore()
    cfg = TransformerConfig(**dict(FLAGSHIP, n_layers=TP_LAYERS,
                                   max_len=TP_SEQ))
    start = {k: v.float().cpu() for k, v in tp_weights(cfg).items()}
    gaps = {name: {**tp_gaps(params, plain_params, start, rec["losses"],
                             plain["losses"]),
                   "probe_delta_l2": tp_probe_gap(torch, probe, plain_probe,
                                                  cfg)}
            for name, ((rec, params), probe) in runs.items()}
    out = {"gaps": gaps, "tol": TP_TOL,
           "losses": {"unsharded": plain["losses"],
                      **{n: r[0][0]["losses"] for n, r in runs.items()}}}
    print("tpfault", json.dumps(out), flush=True)
    check(tp_within(gaps["sound"]), f"sound run outside TP_TOL: {gaps}")
    check(not tp_within(gaps["bias_per_entry"])
          and not tp_within(gaps["bias_dropped"]),
          f"a planted fault inside TP_TOL: {gaps}")
    return out


def parallel_tp_part(torch, fa, pe, root):
    """The flagship on a one-process (1, 2, 2) dp/sp/tp mesh with the
    transformer rules, TP_STEPS steps, against the unsharded run on the
    same batches from the same weights. Returns the line, the launches,
    and the (1, 2, 2) run (the processes' reference)."""
    from elasticdl_tpu_torch.models.transformer import TransformerConfig
    from elasticdl_tpu_torch.parallel import multihost

    clock = CollectiveClock(torch, multihost)
    try:
        one, one_params = tp_run(torch, fa, pe, root, "one", clock)
        plain, plain_params = tp_run(torch, fa, pe, root, None, clock)
        _, one_probe = tp_run(torch, fa, pe, root, "one", clock,
                              probe=True)
        _, plain_probe = tp_run(torch, fa, pe, root, None, clock,
                                probe=True)
    finally:
        clock.restore()
    cfg = TransformerConfig(**dict(FLAGSHIP, n_layers=TP_LAYERS,
                                   max_len=TP_SEQ))
    start = {k: v.float().cpu() for k, v in tp_weights(cfg).items()}
    gaps = tp_gaps(one_params, plain_params, start, one["losses"],
                   plain["losses"])
    gaps["probe_delta_l2"] = tp_probe_gap(torch, one_probe, plain_probe, cfg)
    out = {"model": f"transformer flagship widths, {TP_LAYERS} layers, "
                    f"B {TP_BATCH} x S {TP_SEQ}, bf16, Adam 1e-3, random "
                    f"weights seed {SEED} (bridge)",
           "mesh": "(1, 2, 2) over (dp, sp, tp), one process",
           "one_process_tp": one, "unsharded": plain, **gaps,
           "tol": TP_TOL}
    print("parallel tp", json.dumps(out), flush=True)
    check(one["launches"] == tp_expected_launches("one"),
          f"(1, 2, 2) launches {one['launches']}, want "
          f"{tp_expected_launches('one')}")
    check(plain["launches"]["flash_attention_fwd"] == TP_STEPS * TP_LAYERS,
          f"unsharded launches {plain['launches']}")
    check(all(np.isfinite(one["losses"])) and tp_within(gaps),
          f"(1, 2, 2) vs unsharded: {gaps}")
    return out, one["launches"], {"losses": one["losses"],
                                  "params": one_params, "start": start,
                                  "plain_losses": plain["losses"],
                                  "probe": plain_probe, "cfg": cfg}


class KernelCapture:
    """The inputs of one launch of each flash kernel on a path (clones),
    patched over the wrappers that launch them: #1's first; #2's first
    whose chunk is another rank's (k_offset != q_offset); #3/#4's first
    of a past chunk, else of the diagonal."""

    def __init__(self, torch, fa):
        self.torch, self.fa, self.saved, self.args = torch, fa, {}, {}
        for name in ("flash_forward_cuda", "flash_chunk_update_cuda",
                     "flash_chunk_grads_cuda"):
            fn = getattr(fa, name)
            self.saved[name] = fn
            setattr(fa, name, self._wrap(name, fn))

    def _wanted(self, name, args):
        have = self.args.get(name)
        if name == "flash_forward_cuda":
            return have is None
        q_off, k_off = args[6], args[7]
        if name == "flash_chunk_update_cuda":
            return have is None and k_off != q_off
        return k_off <= q_off and (have is None or (
            k_off < q_off and have[7] == have[6]))

    def _wrap(self, name, fn):
        def call(*args):
            if self._wanted(name, args):
                self.args[name] = [a.clone() if isinstance(
                    a, self.torch.Tensor) else a for a in args]
            return fn(*args)
        return call

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.fa, name, fn)

    def checks(self):
        """Each captured launch again against its plain version on the
        same inputs (after the path's counts are read)."""
        fa, out = self.fa, {}
        if "flash_forward_cuda" in self.args:
            q, k, v, causal, scale = self.args["flash_forward_cuda"]
            o, lse = fa.flash_forward_cuda(q, k, v, causal, scale)
            want_o, want_lse = fa.flash_forward_reference(
                q, k, v, causal, scale,
                block_k=fa.forward_block_k(q.shape[-1], q.dtype))
            tol = FWD_TOL[str(q.dtype).split(".")[-1]]
            r = {"shape": list(q.shape), "o": grad_readings(o, want_o),
                 "lse": lse_reading(lse, want_lse)}
            r["ok"] = within(r["o"], tol) and r["lse"] <= tol["lse"]
            out["flash_attention_fwd"] = r
        if "flash_chunk_update_cuda" in self.args:
            args = self.args["flash_chunk_update_cuda"]
            got = fa.flash_chunk_update_cuda(*args)
            want = chunk_tiled_reference(fa, *args)
            tol = CHUNK_TOL[str(args[0].dtype).split(".")[-1]]
            r = {"shape": list(args[0].shape), "q_offset": args[6],
                 "k_offset": args[7]}
            for i, name in enumerate(("m", "l", "acc")):
                r[name] = grad_readings(got[i], want[i])
            r["ok"] = all(within(r[n], tol) for n in ("m", "l", "acc"))
            out["flash_chunk_update"] = r
        if "flash_chunk_grads_cuda" in self.args:
            args = self.args["flash_chunk_grads_cuda"]
            got = fa.flash_chunk_grads_cuda(*args)
            want = fa.flash_chunk_grads_reference(*args)
            tol = BWD_TOL[str(args[0].dtype).split(".")[-1]]
            r = {"shape": list(args[0].shape), "q_offset": args[6],
                 "k_offset": args[7]}
            for i, name in enumerate(("dq", "dk", "dv")):
                r[name] = grad_readings(got[i], want[i])
            r["ok"] = all(within(r[n], tol) for n in ("dq", "dk", "dv"))
            out["flash_attention_bwd"] = r
        self.torch.cuda.synchronize()
        return out


def mh_child_tp(torch, fa, pe, pid, root, out):
    """(d) tp across the processes, (d') one step with no ring, (e) sp
    across them: the flagship, its block of each batch; each path's
    launches, one launch of each kernel held to its plain version, the
    whole parameters saved."""
    from elasticdl_tpu_torch.parallel import multihost

    res = {}
    for part, layout, seq in (("d", "tp", None),
                              ("d_tp_only", "tp_only", None),
                              ("e", "sp", (pid * TP_SEQ // MH_PROCS,
                                           (pid + 1) * TP_SEQ // MH_PROCS))):
        clock = CollectiveClock(torch, multihost)
        capture = KernelCapture(torch, fa)
        # (h): the multi-host checkpoint of (d)'s trained state.
        after = (None if part != "d" else
                 lambda *a: mh_checkpoint_part(torch, root, pid, *a))
        try:
            record, params = tp_run(
                torch, fa, pe, root, layout, clock,
                steps=1 if layout == "tp_only" else TP_STEPS, seq=seq,
                after=after)
        finally:
            capture.restore()
            clock.restore()
        if after is not None:
            out["checkpoint"] = record.pop("after")
        record["kernel_checks"] = capture.checks()
        record["collective_calls"] = clock.calls
        record["collective_ms_by_name"] = clock.ms_by_name
        torch.save(params, os.path.join(root, f"tp_{part}_{pid}.pt"))
        if layout != "tp_only":
            clock = CollectiveClock(torch, multihost)
            try:
                _, probe = tp_run(torch, fa, pe, root, layout, clock,
                                  seq=seq, probe=True)
            finally:
                clock.restore()
            torch.save(probe, os.path.join(root,
                                           f"tp_{part}_probe_{pid}.pt"))
        res[part] = record
    out["tp"] = res


def table_model(torch):
    from elasticdl_tpu_torch.preprocessing import feature_column as fc

    class Model(torch.nn.Module):
        """tests/test_feature_column.py:238's model."""

        def __init__(self):
            super().__init__()
            self.features = fc.DenseFeatures([
                fc.numeric_column("x"),
                fc.embedding_column(fc.categorical_column_with_identity(
                    "c", 1 << 15), 32)])
            self.Dense_0 = torch.nn.Linear(33, 1)

        def forward(self, features):
            return self.Dense_0(self.features(features))[..., 0]

    torch.manual_seed(SEED)
    return Model().to(DEVICE)


def table_batches():
    rng = np.random.default_rng(SEED + 81)
    return [{"features": {"x": rng.random((TABLE_BATCH, 1), np.float32),
                          "c": rng.integers(0, 1 << 15, (TABLE_BATCH, 2))
                          .astype(np.int32)},
             "labels": rng.random(TABLE_BATCH, np.float32),
             "mask": np.ones(TABLE_BATCH, np.float32)}
            for _ in range(TABLE_STEPS)]


def table_run(torch, per, pid=None):
    """(f)'s model on a (2,) dp mesh of ``per`` entries a process, SGD
    0.1, TABLE_STEPS steps of table_batches (``pid``: its rows)."""
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    def loss(labels, preds, mask):
        return torch.mean(torch.square(preds - labels) * mask)

    runner = MeshRunner(make_mesh((2,), ("dp",),
                                  [torch.device(DEVICE)] * per))
    state = runner.init_state(table_model(torch),
                              lambda p: torch.optim.SGD(p, lr=0.1))
    step = runner.train_step(loss)
    losses = []
    for b in table_batches():
        if pid is not None:
            b = mh_local(b, pid)
        state, m = step(state, runner.place_batch(b))
        losses.append(float(m["loss"]))
    spec = runner.state_shardings(state)[
        "params.features.c_embedding.embedding"]
    rows = int(state.model.features.c_embedding.embedding.shape[0])
    return ({"losses": losses, "table_spec": str(spec.spec),
             "table_rows_held": rows},
            whole_params(runner, state))


def mh_child_table(torch, fa, pe, pid, root, out):
    """(f) in process ``pid``: its rows of each batch, the table split
    over the processes."""
    record, params = table_run(torch, 1, pid)
    torch.save(params, os.path.join(root, f"table_{pid}.pt"))
    out["table"] = record


# ---- multihost: data parallel across two processes on the one card --------

MH_PROCS = 2
MH_STEPS = 8            # PAR_RECSYS_STEPS: the parallel phase's dp4 run
MH_DENSE_BATCH, MH_LR = 256, 0.001
# (b)'s divergent rate (loss 2.8 -> 72 in 8 steps): its gaps are
# reported beside the checked run's, with the reordered control's.
MH_LR_DIVERGENT = 0.01
MH_JOB_RECORDS, MH_JOB_EVAL, MH_JOB_BATCH, MH_JOB_TASK = 2048, 256, 128, 512
# (i): the job's checkpoint interval (its 8 steps save at 3, 6 and the
# final version) and the records of the job that resumes from it (two
# tasks: one a process).
MH_JOB_CKPT_STEPS, MH_JOB_RESUME_RECORDS = 3, 1024
MH_WAIT_S = 900         # the go file, and the processes' run after it


def multihost_start(torch):
    """Start the phase's two processes (this script with
    ``--multihost-child``) at the smoke's start, so that their imports
    and their process group overlap the earlier phases; they set up and
    train once ``multihost_go`` writes their go file."""
    root = tempfile.mkdtemp(prefix="chip_smoke_mh_")
    procs, logs = [], []
    for pid in range(MH_PROCS):
        log = open(os.path.join(root, f"child{pid}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-child",
             str(pid), root], stdout=log, stderr=subprocess.STDOUT))
        logs.append(log)
    return {"root": root, "procs": procs, "logs": logs}


def multihost_stop(started):
    """Kill the phase's processes if they still run, and remove their
    directory."""
    import shutil

    for proc in started["procs"]:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    for log in started["logs"]:
        log.close()
    shutil.rmtree(started["root"], ignore_errors=True)


def mh_recsys_batches():
    """The global batches of (a): B EMB_BATCH x L EMB_IDS over the full
    vocab, one more than MH_STEPS for the shard checks; the first are
    those of ``parallel_recsys_start``, whose dp4 run at step MH_STEPS
    is (a)'s reference in the whole smoke."""
    rng = np.random.default_rng(SEED + 62)
    out = []
    for _ in range(MH_STEPS + 1):
        ids = rng.integers(0, EMB_VOCAB, (EMB_BATCH, EMB_IDS))
        out.append({"features": {"ids": ids},
                    "labels": (ids.sum(axis=1) % 2).astype(np.int32),
                    "mask": np.ones(EMB_BATCH, np.float32)})
    return out


def mh_dense_batches():
    rng = np.random.default_rng(SEED + 71)
    return [{"features": rng.standard_normal((MH_DENSE_BATCH, 28, 28),
                                             dtype=np.float32),
             "labels": rng.integers(0, 10, MH_DENSE_BATCH).astype(np.int32),
             "mask": np.ones(MH_DENSE_BATCH, np.float32)}
            for _ in range(MH_STEPS)]


def mh_local(batch, pid):
    """Process ``pid``'s rows of a global batch."""
    if isinstance(batch, dict):
        return {k: mh_local(v, pid) for k, v in batch.items()}
    rows = batch.shape[0] // MH_PROCS
    return batch[pid * rows:(pid + 1) * rows]


def mh_dense_spec(torch, mesh, lr=MH_LR, dtype=None):
    """mnist_functional from the seed, its MeshRunner and SGD at
    ``lr``; ``dtype``: its compute dtype in place of the zoo's bf16."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin
    from elasticdl_tpu_torch.models.vision import place
    from elasticdl_tpu_torch.parallel.mesh_runner import make_runner_for_spec
    from elasticdl_tpu_torch.testing import data as tdata

    torch.manual_seed(SEED)
    spec = get_model_spec(tdata.model_zoo_dir(),
                          "mnist.mnist_functional.custom_model",
                          device="cuda")
    model = spec.model
    if dtype is not None:
        torch.manual_seed(SEED)
        model = place(twin.MnistModel(dtype), "cuda")
    runner = make_runner_for_spec(spec, mesh)
    state = runner.init_state(model, twin.optimizer(lr=lr), seed=SEED)
    return spec, runner, state


def mh_dense_leaves(state):
    return {k: v.detach().float().cpu() for k, v in
            state.model.state_dict().items()}


class CollectiveClock:
    """Host ms inside the processes' collectives (the card synchronised
    at entry and exit), patched over ``multihost``'s helpers: the
    all-reduces (the gradients, tp's ``reduce_from`` and ``copy_to``),
    the all-gathers (ZeRO's slices, the logits over tp, a split table's
    ids) and the ring's send/recv."""

    def __init__(self, torch, multihost,
                 names=("all_reduce_", "all_gather", "ring_shift")):
        self.ms, self.calls = 0.0, 0
        self.ms_by_name = dict.fromkeys(names, 0.0)
        self.mh, self.saved = multihost, {}
        for name in names:
            fn = getattr(multihost, name)
            self.saved[name] = fn
            setattr(multihost, name, self._timed(torch, name, fn))

    def _timed(self, torch, name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.ms += ms
            self.ms_by_name[name] += ms
            self.calls += 1
            return out
        return call

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.mh, name, fn)


def mh_timed_steps(torch, step, state, batches, clock):
    """Train ``batches``; per step: CUDA-event ms, issue ms (the host's
    time in ``step``) and collective ms."""
    losses, step_ms, issue_ms, coll_ms = [], [], [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = clock.ms
        t0 = time.perf_counter()
        start.record()
        state, m = step(state, b)
        end.record()
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        coll_ms.append(clock.ms - before)
        losses.append(float(m["loss"]))
    return state, losses, {"step_ms": step_ms, "issue_ms": issue_ms,
                           "collective_ms": coll_ms}


def mh_child_recsys(torch, fa, pe, pid, root, out):
    """(a) in process ``pid``: the recsys ranker row-split over the two
    processes (one shard each, its table drawn whole on the host),
    kernels pinned, MH_STEPS steps on its rows of the global batches;
    exact launches; its shard's #6 and #7 against their plain version;
    its touched rows saved."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.embedding.device_sparse import _unique_pad
    from elasticdl_tpu_torch.parallel import multihost
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    zoo = write_zoo(root, f"recsys_mh{pid}", RECSYS_ZOO.format(mode="always"))
    batches = mh_recsys_batches()
    torch.manual_seed(SEED)
    spec = get_model_spec(zoo, f"recsys_mh{pid}.rec.custom_model",
                          device="cuda")
    mesh = make_mesh((MH_PROCS,), ("dp",), [torch.device("cuda:0")])
    t0 = time.monotonic()
    runner = spec.make_sparse_runner(mesh=mesh)
    state = runner.init_state(spec.model, spec.make_optimizer(),
                              mh_local(batches[0], pid), seed=SEED)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    table = state.tables[RECSYS_TABLE]
    acc = state.slot_tables[RECSYS_TABLE]["accumulator"]
    step = runner.train_step(spec.loss)
    clock = CollectiveClock(torch, multihost)
    torch.cuda.synchronize()
    reset_kernel_launches(fa, pe)              # the multihost path starts
    torch.cuda.reset_peak_memory_stats()
    state, losses, times = mh_timed_steps(
        torch, step, state, [mh_local(b, pid) for b in batches[:MH_STEPS]],
        clock)
    torch.cuda.synchronize()
    counts = kernel_launch_counts(fa, pe)      # ... and ends
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts["row_update_adagrad"] = pe.row_update_rule_launches["adagrad"]
    clock.restore()
    first = table.sharding.local_shards[0]
    ids = torch.from_numpy(batches[-1]["features"]["ids"]).to(
        "cuda", torch.int32)
    weights = torch.ones(ids.shape, device="cuda")
    uids, _ = _unique_pad(ids.reshape(-1), EMB_VOCAB)
    grads = torch.from_numpy(np.random.default_rng(SEED + 72)
                             .standard_normal((uids.numel(), EMB_DIM),
                                              dtype=np.float32)).cuda()
    checks = shard_kernel_checks(torch, pe, table.shards,
                                 [[a] for a in acc.shards], ids, weights,
                                 uids, grads, runner.row_opt, first=first)
    rows = int(table.shards[0].shape[0])
    touched = touched_rows(torch, np.stack(
        [b["features"]["ids"] for b in batches[:MH_STEPS]]),
        EMB_VOCAB)[first * rows:(first + len(table.shards)) * rows]
    local_table = torch.cat(table.shards)
    local_acc = torch.cat(acc.shards)
    np.save(os.path.join(root, f"rows{pid}.npy"),
            local_table[touched].cpu().numpy())
    np.save(os.path.join(root, f"acc{pid}.npy"),
            local_acc[touched].cpu().numpy())
    out["recsys"] = {
        "losses": losses, **times, "init_s": init_s, "launches": counts,
        "shards": table.sharding.local_shards, "shard_rows": rows,
        "table_bytes": sum(t.numel() * 4 for t in table.shards),
        "accumulator_bytes": sum(t.numel() * 4 for t in acc.shards),
        "collective_calls": clock.calls, "shard_checks": checks,
        "collective_ms_by_name": clock.ms_by_name,
        "peak_gb_steps": peak_gb}
    del state, table, acc, local_table, local_acc
    torch.cuda.empty_cache()


def mh_child_dense(torch, fa, pe, pid, root, out):
    """(b) in process ``pid``: mnist_functional over the two processes,
    its rows of the global batches, MH_STEPS steps."""
    from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin
    from elasticdl_tpu_torch.parallel import multihost
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((MH_PROCS,), ("dp",), [torch.device("cuda:0")])
    _, runner, state = mh_dense_spec(torch, mesh)
    step = runner.train_step(twin.loss)
    clock = CollectiveClock(torch, multihost)
    with Deterministic(torch):
        torch.cuda.synchronize()
        reset_kernel_launches(fa, pe)
        state, losses, times = mh_timed_steps(
            torch, step, state, [mh_local(b, pid) for b in
                                 mh_dense_batches()], clock)
        torch.cuda.synchronize()
        counts = kernel_launch_counts(fa, pe)
    clock.restore()
    torch.save(mh_dense_leaves(state), os.path.join(root, f"dense{pid}.pt"))
    out["dense"] = {"losses": losses, **times, "launches": counts,
                    "collective_calls": clock.calls,
                    "collective_ms_by_name": clock.ms_by_name,
                    "zero_local_entries": state.optimizer.num_local,
                    "zero_entries": state.optimizer.num_entries}
    for name, dtype in (("", None), ("_f32", torch.float32)):
        _, runner, state = mh_dense_spec(torch, mesh, MH_LR_DIVERGENT, dtype)
        step = runner.train_step(twin.loss)
        with Deterministic(torch):
            out["dense"]["losses_divergent" + name] = [
                float(step(state, mh_local(b, pid))[1]["loss"])
                for b in mh_dense_batches()]


def mh_child_job(torch, fa, pe, pid, root, out):
    """(c) in process ``pid``: a port worker through ``build_worker``
    with the multi-host flags; process 0 also hosts the master (the
    dispatcher and the evaluation service over localhost gRPC). (i):
    the job writes its multi-host checkpoints (``--checkpoint_dir``),
    then a second job in the same processes, from
    ``--checkpoint_dir_for_init``, resumes at the first's final
    version."""
    from elasticdl_tpu_torch.checkpoint.orbax_backend import OrbaxSaver

    ckpt = os.path.join(root, "ckpt_i")
    t0 = time.monotonic()
    reset_kernel_launches(fa, pe)
    job = mh_job_run(torch, pid, root, "train.rec", MH_JOB_RECORDS,
                     ["--checkpoint_dir", ckpt, "--checkpoint_steps",
                      str(MH_JOB_CKPT_STEPS)], evaluate=True)
    torch.cuda.synchronize()
    job["wall_s"] = time.monotonic() - t0
    job["launches"] = kernel_launch_counts(fa, pe)
    job["versions"] = OrbaxSaver(ckpt, collective=False).versions()
    t0 = time.monotonic()
    resumed = mh_job_run(torch, pid, root, "resume.rec",
                         MH_JOB_RESUME_RECORDS,
                         ["--checkpoint_dir_for_init", ckpt])
    resumed["wall_s"] = time.monotonic() - t0
    job["resumed"] = resumed
    out["job"] = job


def mh_job_run(torch, pid, root, records, num_records, extra,
               evaluate=False):
    """One job over localhost gRPC: process 0 writes ``records`` and
    hosts the master (with an evaluation service where ``evaluate``),
    each process runs a worker built by ``build_worker`` with the
    multi-host flags and ``extra``. Returns the worker's record (and,
    in process 0, the master's)."""
    from elasticdl_tpu_torch.common.args import parse_worker_args
    from elasticdl_tpu_torch.testing import data as tdata
    from elasticdl_tpu_torch.worker.main import build_worker

    zoo = tdata.model_zoo_dir()
    model_def = "mnist.mnist_functional.custom_model"
    train = os.path.join(root, records)
    port_file = os.path.join(root, f"master_port_{records}")
    server = None
    if pid == 0:
        from elasticdl_tpu_torch.comm.rpc import RpcServer
        from elasticdl_tpu_torch.core.model_spec import get_model_spec
        from elasticdl_tpu_torch.data.factory import create_data_reader
        from elasticdl_tpu_torch.master.evaluation_service import (
            EvaluationService,
        )
        from elasticdl_tpu_torch.master.servicer import (
            SERVICE_NAME,
            MasterServicer,
        )
        from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher

        evalf = os.path.join(root, "eval.rec")
        tdata.create_mnist_record_file(train, num_records, seed=1)
        if evaluate:
            tdata.create_mnist_record_file(evalf, MH_JOB_EVAL, seed=2)
        spec = get_model_spec(zoo, model_def, device="cuda")
        dispatcher = TaskDispatcher(
            training_shards=create_data_reader(train).create_shards(),
            evaluation_shards=(create_data_reader(evalf).create_shards()
                               if evaluate else {}),
            records_per_task=MH_JOB_TASK, num_epochs=1)
        evals = EvaluationService(
            dispatcher, spec.eval_metrics_fn(),
            eval_steps=MH_JOB_RECORDS // MH_JOB_BATCH // 4 if evaluate
            else 0)
        server = RpcServer("localhost:0", {SERVICE_NAME: MasterServicer(
            dispatcher, evals).handlers()}).start()
        with open(port_file + ".tmp", "w") as f:
            f.write(str(server.port))
        os.replace(port_file + ".tmp", port_file)
    deadline = time.monotonic() + 120
    while not os.path.exists(port_file):
        check(time.monotonic() < deadline, "no master port")
        time.sleep(0.05)
    with open(port_file) as f:
        master_port = f.read()
    args = parse_worker_args([
        "--worker_id", str(pid), "--model_zoo", zoo, "--model_def",
        model_def, "--training_data", train, "--minibatch_size",
        str(MH_JOB_BATCH), "--master_addr", f"localhost:{master_port}",
        "--distribution_strategy", "MeshStrategy", "--mesh_shape",
        str(MH_PROCS), "--mesh_axes", "dp", "--num_jax_processes",
        str(MH_PROCS), "--coordinator_addr", f"file://{root}/store",
        "--jax_process_id", str(pid), *extra])
    worker = build_worker(args)
    result = worker.run()
    job = {"version": result["final_version"],
           "batches": result["trained_batches"],
           "loss": result["final_loss"]}
    if pid == 0:
        deadline = time.monotonic() + 60
        while not dispatcher.finished() and time.monotonic() < deadline:
            time.sleep(0.1)
        job["finished"] = dispatcher.finished()
        job["evals"] = {str(v): r for v, r in
                        evals.completed_results.items()}
        server.stop(0)
    return job


def mh_gloo_probe(torch):
    """Which gloo collectives take CUDA tensors here (a throwaway gloo
    group; the port stages CUDA tensors through the host either way)."""
    import torch.distributed as dist

    group = dist.new_group(backend="gloo")
    x = torch.ones(4, device="cuda")
    probes = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), 0, group=group),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(MH_PROCS)], x, group=group),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(2, device="cuda"),
            [torch.ones(2, device="cuda")] * MH_PROCS, group=group)}
    out = {}
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as exc:
            out[name] = f"{type(exc).__name__}: {str(exc)[:120]}"
    return out


def multihost_go(started, parts="all"):
    """Let the phase's processes run: ``parts`` "all" (the whole smoke:
    the multihost phase's parts, then the moe phase's (f)), "multihost"
    or "moe" (``--phase``)."""
    path = os.path.join(started["root"], "go")
    with open(path + ".tmp", "w") as f:
        f.write(parts)
    os.replace(path + ".tmp", path)


def multihost_child(pid, root):
    """One of the phase's two processes: wire the process group (CPU
    only), wait for the go file, run the parts it names ((a)-(i), then
    the moe phase's (f)), write the result."""
    import torch

    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import pallas_embedding as pe
    from elasticdl_tpu_torch.parallel import multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"pid": pid}
    multihost.initialize_multihost(f"file://{root}/store", MH_PROCS, pid,
                                   device="cuda:0")
    out["data_backend"] = multihost.data_backend()
    go = os.path.join(root, "go")
    deadline = time.monotonic() + MH_WAIT_S
    while not os.path.exists(go):
        check(time.monotonic() < deadline, "no go file")
        time.sleep(0.05)
    with open(go) as f:
        wanted = f.read().strip()
    parts = {"recsys": mh_child_recsys, "dense": mh_child_dense,
             "job": mh_child_job, "tp": mh_child_tp,
             "table": mh_child_table, "pipe": mh_child_pipe,
             "moe": mh_child_moe}
    names = {"moe": ["moe"], "multihost": list(parts)[:-1]}.get(
        wanted, list(parts))
    marks = [time.monotonic()]
    for name in names:
        parts[name](torch, fa, pe, pid, root, out)
        marks.append(time.monotonic())
        print(f"multihost process {pid}: {name} done", flush=True)
    out["part_s"] = dict(zip(names, np.diff(marks).tolist()))
    out["gloo_cuda"] = mh_gloo_probe(torch)
    with open(os.path.join(root, f"result{pid}.json.tmp"), "w") as f:
        json.dump(out, f)
    os.replace(os.path.join(root, f"result{pid}.json.tmp"),
               os.path.join(root, f"result{pid}.json"))
    multihost.shutdown()
    return 0


def mh_recsys_reference(losses, touched, table0, final, acc):
    """(a)'s reference from a one-process row-split run at step
    MH_STEPS on ``mh_recsys_batches``: its losses, the touched-row mask
    and the touched rows of the initial table, the final table and its
    accumulator."""
    return {"losses": [float(x) for x in losses[:MH_STEPS]],
            "touched": touched, "table0": table0[touched].clone(),
            "final": final[touched].clone(), "acc": acc[touched].clone()}


def mh_reference(torch, fa, pe, root, recsys=None):
    """The one-process runs the processes are held to, from the same
    seeds: (a) PR 18's row-split runner on the global batches (at dp2
    here, unless the parallel phase's dp4 run is passed), (b)
    mnist_functional at dp2 on the global batches."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.model_zoo.mnist import mnist_functional as twin

    if recsys is None:
        zoo = write_zoo(root, "recsys_mh", RECSYS_ZOO.format(mode="always"))
        batches = mh_recsys_batches()
        torch.manual_seed(SEED)
        spec = get_model_spec(zoo, "recsys_mh.rec.custom_model",
                              device="cuda")
        runner = spec.make_sparse_runner(mesh=card_mesh(torch, MH_PROCS))
        state = runner.init_state(spec.model, spec.make_optimizer(),
                                  batches[0], seed=SEED)
        table0 = state.tables[RECSYS_TABLE].gather().clone()
        step = runner.train_step(spec.loss)
        losses = [step(state, b)[1]["loss"] for b in batches[:MH_STEPS]]
        recsys = mh_recsys_reference(
            losses, touched_rows(torch, np.stack(
                [b["features"]["ids"] for b in batches[:MH_STEPS]]),
                EMB_VOCAB), table0, state.tables[RECSYS_TABLE].gather(),
            state.slot_tables[RECSYS_TABLE]["accumulator"].gather())
        del state, runner, table0
        torch.cuda.empty_cache()
    order = np.random.default_rng(SEED + 72).permutation(MH_DENSE_BATCH)
    dense = {}
    f32 = torch.float32
    for name, lr, rows, dtype in (
            ("", MH_LR, None, None),
            ("_reordered", MH_LR, order, None),
            ("_divergent", MH_LR_DIVERGENT, None, None),
            ("_divergent_reordered", MH_LR_DIVERGENT, order, None),
            ("_divergent_f32", MH_LR_DIVERGENT, None, f32),
            ("_divergent_f32_reordered", MH_LR_DIVERGENT, order, f32)):
        _, runner, state = mh_dense_spec(torch, card_mesh(torch, MH_PROCS),
                                         lr, dtype)
        dense.setdefault("start", mh_dense_leaves(state))
        step = runner.train_step(twin.loss)
        batches = mh_dense_batches()
        if rows is not None:
            batches = [{k: v[rows] for k, v in b.items()} for b in batches]
        with Deterministic(torch):
            dense["losses" + name] = [float(step(state, b)[1]["loss"])
                                      for b in batches]
        dense["leaves" + name] = mh_dense_leaves(state)
    return recsys, dense


def mh_wait(started):
    """Wait for both children (a failed one ends the other: its peer
    would wait in a collective); their results."""
    procs = started["procs"]
    deadline = time.monotonic() + MH_WAIT_S
    while any(p.poll() is None for p in procs):
        if (time.monotonic() > deadline
                or any(p.poll() not in (None, 0) for p in procs)):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.1)
    for p in procs:
        p.wait()
    results = {}
    paths = [os.path.join(started["root"], f"result{pid}.json")
             for pid in range(MH_PROCS)]
    if any(p.returncode != 0 for p in procs) or not all(
            map(os.path.exists, paths)):
        tails = []
        for pid, p in enumerate(procs):
            with open(os.path.join(started["root"], f"child{pid}.log")) as f:
                tails.append(f"process {pid} exit {p.returncode}:\n"
                             + f.read()[-6000:])
        raise AssertionError("multihost processes failed\n"
                             + "\n".join(tails))
    for pid, path in enumerate(paths):
        with open(path) as f:
            results[pid] = json.load(f)
    return results


def multihost_phase(torch, fa, pe, root, started, recsys_ref=None,
                    res=None, tp_ref=None, pipe_ref=None):
    """The references here (``recsys_ref``: the parallel phase's dp4 run,
    ``mh_recsys_reference``; ``pipe_ref``: the pipeline phase's run),
    then the go file: (a)-(i) in the two processes, unless their
    results ``res`` are given (the whole smoke runs them earlier,
    ``multihost_go``). Returns the phase's line and its launches by
    part."""
    marks = [time.monotonic()]
    recsys_ref, dense_ref = mh_reference(torch, fa, pe, root, recsys_ref)
    if tp_ref is None:
        _, _, tp_ref = parallel_tp_part(torch, fa, pe, root)
    if pipe_ref is None:
        _, _, pipe_ref = pipeline_phase(torch, fa, pe, root)
    table_ref, table_params = table_run(torch, 2)
    marks.append(time.monotonic())
    if res is None:
        multihost_go(started, "multihost")
        res = mh_wait(started)
    marks.append(time.monotonic())
    rec = {pid: res[pid]["recsys"] for pid in res}
    table0 = recsys_ref["table0"].cpu().numpy()
    got = np.concatenate([np.load(os.path.join(
        started["root"], f"rows{pid}.npy")) for pid in sorted(res)])
    acc = np.concatenate([np.load(os.path.join(
        started["root"], f"acc{pid}.npy")) for pid in sorted(res)])
    table_l2 = rel_err(got - table0,
                       recsys_ref["final"].cpu().numpy() - table0)
    acc_l2 = rel_err(acc, recsys_ref["acc"].cpu().numpy())
    loss_rel = max(abs(x - y) / abs(y) for x, y in
                   zip(rec[0]["losses"], recsys_ref["losses"]))
    dense = {pid: res[pid]["dense"] for pid in res}
    got = [torch.load(os.path.join(started["root"], f"dense{pid}.pt"))
           for pid in res]
    start, want = dense_ref["start"], dense_ref["leaves"]
    stat_keys = [k for k in want if k.endswith(("mean", "var"))]
    par_keys = [k for k in want if k not in stat_keys]

    def flat(tree, keys, base=None):
        return np.concatenate([(tree[k] - (base[k] if base else 0))
                               .numpy().ravel() for k in keys])

    dense_delta = rel_err(flat(got[0], par_keys, start),
                          flat(want, par_keys, start))
    dense_stats = rel_err(flat(got[0], stat_keys), flat(want, stat_keys))
    def loss_gap(got_losses, want_losses):
        return max(abs(x - y) / max(abs(y), 1e-6) for x, y in
                   zip(got_losses, want_losses))

    dense_loss = loss_gap(dense[0]["losses"], dense_ref["losses"])
    # The reduction order's own effect: the one-process run on permuted
    # rows against the one-process run, at the checked rate and at the
    # divergent one, beside the two processes' run at the divergent one.
    reorder = {
        "lr": MH_LR,
        "loss_max_rel_diff": loss_gap(dense_ref["losses_reordered"],
                                      dense_ref["losses"]),
        "delta_l2": rel_err(flat(dense_ref["leaves_reordered"], par_keys,
                                 start), flat(want, par_keys, start))}
    divergent = {
        "lr": MH_LR_DIVERGENT,
        "losses_one_process": dense_ref["losses_divergent"],
        "two_processes_loss_max_rel_diff": loss_gap(
            dense[0]["losses_divergent"], dense_ref["losses_divergent"]),
        "reordered_loss_max_rel_diff": loss_gap(
            dense_ref["losses_divergent_reordered"],
            dense_ref["losses_divergent"]),
        "reordered_delta_l2": rel_err(
            flat(dense_ref["leaves_divergent_reordered"], par_keys, start),
            flat(dense_ref["leaves_divergent"], par_keys, start)),
        # The same pair with f32 compute: each process's weight
        # gradients are then not rounded to bf16 before their sum.
        "f32": {
            "losses_one_process": dense_ref["losses_divergent_f32"],
            "two_processes_loss_max_rel_diff": loss_gap(
                dense[0]["losses_divergent_f32"],
                dense_ref["losses_divergent_f32"]),
            "reordered_loss_max_rel_diff": loss_gap(
                dense_ref["losses_divergent_f32_reordered"],
                dense_ref["losses_divergent_f32"])}}
    job = {pid: res[pid]["job"] for pid in res}
    tp_out, tp_launches = mh_tp_results(torch, started["root"], res, tp_ref)
    table_out = mh_table_results(torch, started["root"], res, table_ref,
                                 table_params)
    pipe_out, pipe_launches = mh_pipe_results(torch, started["root"], res,
                                              pipe_ref)
    ckpt_out = mh_checkpoint_results(res, job)
    out = {
        "data_backend": res[0]["data_backend"],
        "why": "both processes drive cuda:0; NCCL refuses two ranks on "
               "one device, so the data group is gloo, CUDA tensors staged "
               "through the host",
        "gloo_cuda": res[0]["gloo_cuda"],
        "recsys": {
            "model": "recsys ranker twin (1,000,000 x 256 f32 table "
                     "row-split over 2 processes, 500,000 rows each, 32 ids "
                     "an example, Adagrad rows lr 0.05, bf16 MLP, Adam "
                     f"1e-3), random weights, seed {SEED}",
            "batch": EMB_BATCH, "steps": MH_STEPS,
            "losses": {pid: rec[pid]["losses"] for pid in rec},
            "losses_one_process": recsys_ref["losses"],
            "loss_max_rel_diff": loss_rel, "table_delta_l2": table_l2,
            "accumulator_l2": acc_l2,
            **{f"p{pid}": {k: rec[pid][k] for k in (
                "step_ms", "issue_ms", "collective_ms", "collective_calls",
                "collective_ms_by_name", "init_s", "launches", "shards",
                "table_bytes", "accumulator_bytes", "peak_gb_steps",
                "shard_checks")}
               for pid in rec}},
        "dense": {
            "model": "mnist_functional twin (bf16, SGD lr 0.001 momentum "
                     f"0.9), B {MH_DENSE_BATCH} over 2 processes vs one "
                     f"process at dp2, random weights, seed {SEED}",
            "losses": {pid: dense[pid]["losses"] for pid in dense},
            "losses_one_process": dense_ref["losses"],
            "loss_max_rel_diff": dense_loss, "delta_l2": dense_delta,
            "stats_l2": dense_stats, "reordered_one_process": reorder,
            "divergent": divergent,
            "equal_across_processes": all(
                torch.equal(got[0][k], got[1][k]) for k in want),
            **{f"p{pid}": {k: dense[pid][k] for k in (
                "step_ms", "issue_ms", "collective_ms", "collective_calls",
                "collective_ms_by_name", "launches", "zero_local_entries",
                "zero_entries")}
               for pid in dense}},
        "job": job, "tp": tp_out, "table": table_out,
        "pipeline": pipe_out, "checkpoint": ckpt_out,
        "part_s": {"reference": marks[1] - marks[0],
                   "children": marks[2] - marks[1],
                   "child_parts": {pid: res[pid]["part_s"] for pid in res}},
        "tol": {"sparse": SPARSE_TOL, "kernel": EMB_TOL, "dense": TRAJ_TOL,
                "stats": VISION_STATS_TOL}}
    print("multihost", json.dumps(out), flush=True)
    for pid in rec:
        c = rec[pid]["launches"]
        check(c["lookup_combine"] == MH_STEPS and c["row_update"] == MH_STEPS
              and c["row_update_adagrad"] == MH_STEPS
              and not any(v for k, v in c.items() if k not in (
                  "lookup_combine", "row_update", "row_update_adagrad")),
              f"process {pid} launches {c} for {MH_STEPS} steps of 1 shard")
        check(rec[pid]["table_bytes"] == rec[pid]["accumulator_bytes"]
              == EMB_VOCAB // MH_PROCS * EMB_DIM * 4,
              f"process {pid} holds {rec[pid]['table_bytes']} table and "
              f"{rec[pid]['accumulator_bytes']} accumulator bytes")
        for r in rec[pid]["shard_checks"]:
            check(emb_within(r["lookup"], EMB_TOL["lookup"])
                  and emb_within(r["table"], EMB_TOL["rows"])
                  and emb_within(r["accumulator"], EMB_TOL["rows"])
                  and r["untouched_bit_equal"],
                  f"process {pid} shard check {r}")
        check(not any(dense[pid]["launches"].values())
              and not any(job[pid]["launches"].values()),
              f"process {pid} launched on the dense path")
    check(rec[0]["losses"] == rec[1]["losses"],
          f"the processes' recsys losses differ {out['recsys']['losses']}")
    check(all(np.isfinite(rec[0]["losses"])), "non-finite recsys loss")
    check(loss_rel <= SPARSE_TOL["loss"] and table_l2 <= SPARSE_TOL[
        "delta_l2"] and acc_l2 <= SPARSE_TOL["delta_l2"],
        f"recsys over processes vs one process {out['recsys']}")
    check(dense[0]["losses"] == dense[1]["losses"]
          and out["dense"]["equal_across_processes"],
          "the processes' dense states differ")
    check(dense_loss <= TRAJ_TOL["loss"]
          and dense_delta <= TRAJ_TOL["delta_l2"]
          and dense_stats <= VISION_STATS_TOL,
          f"dense over processes vs one process {out['dense']}")
    check(job[0]["version"] == job[1]["version"] > 0
          and job[0]["finished"] and job[0]["evals"]
          and job[0]["batches"] + job[1]["batches"]
          == MH_JOB_RECORDS // MH_JOB_BATCH
          and np.isfinite(job[0]["loss"]) and np.isfinite(job[1]["loss"]),
          f"the two-process job {job}")
    launches = {"recsys_p0": rec[0]["launches"],
                "recsys_p1": rec[1]["launches"],
                "dense": dense[0]["launches"], "job": job[0]["launches"],
                **tp_launches, **pipe_launches}
    return out, launches


def mh_checkpoint_results(res, job):
    """(h) and (i) of both processes: (h) each process's restore of (d)'s
    checkpoint onto a fresh state of its layout bit-equal, process 0's
    onto the unsharded model bit-equal, every process's parts written;
    (i) the job's newest version is its final version in both processes,
    and the job resumed from it starts there."""
    ckpt = {pid: res[pid]["checkpoint"] for pid in res}
    out = {"h": ckpt, "i": {
        pid: {"versions": job[pid]["versions"],
              "final_version": job[pid]["version"],
              "resumed": job[pid]["resumed"]} for pid in job}}
    print("multihost checkpoint", json.dumps(out), flush=True)
    for pid, rec in ckpt.items():
        check(not rec["unequal"] and rec["leaves"] > 0,
              f"(h) process {pid} restored leaves differ: "
              f"{rec['unequal'][:8]}")
        check(len([f for f in rec["files"] if f.endswith(".distcp")])
              == MH_PROCS and ".metadata" in rec["files"],
              f"(h) process {pid} sees the files {rec['files']}")
    check("unsharded_unequal" in ckpt[0]
          and not ckpt[0]["unsharded_unequal"],
          "(h) the unsharded restore differs: "
          f"{ckpt[0].get('unsharded_unequal')}")
    final = job[0]["version"]
    for pid in job:
        resumed = job[pid]["resumed"]
        check(job[pid]["versions"] and job[pid]["versions"][-1] == final
              and job[pid]["versions"][0] == MH_JOB_CKPT_STEPS,
              f"(i) process {pid} versions {job[pid]['versions']}, final "
              f"{final}")
        # A fresh start ends at most at its batches' count (8 here);
        # the resumed job ends past the first job's final version.
        batches = resumed["batches"] + job[1 - pid]["resumed"]["batches"]
        check(resumed["batches"] > 0
              and final < resumed["version"] <= final + batches,
              f"(i) process {pid} resumed at {resumed} from {final}")
    check(job[0]["resumed"]["version"] == job[1]["resumed"]["version"]
          and job[0]["resumed"]["finished"],
          f"(i) the resumed job: {job[0]['resumed']}, {job[1]['resumed']}")
    return out


def mh_tp_results(torch, root, res, ref):
    """(d), (d') and (e) of both processes against the one-process
    (1, 2, 2) run ``ref`` (the unsharded run's first loss for (d')):
    losses and parameter changes within TP_TOL, the processes' losses
    and whole parameters equal, exact launches, each captured launch
    within its plain version's limits. Returns the line and the
    launches by part and process."""
    out, launches, seen = {}, {}, set()
    for part, layout in (("d", "tp"), ("d_tp_only", "tp_only"),
                         ("e", "sp")):
        rec = {pid: res[pid]["tp"][part] for pid in res}
        params = [torch.load(os.path.join(root, f"tp_{part}_{pid}.pt"))
                  for pid in sorted(res)]
        equal = all(torch.equal(params[0][k], params[1][k])
                    for k in params[0])
        if layout == "tp_only":
            gaps = {"loss_max_rel_diff": abs(
                rec[0]["losses"][0] - ref["plain_losses"][0])
                / abs(ref["plain_losses"][0])}
            want = tp_expected_launches(layout, steps=1)
        else:
            gaps = tp_gaps(params[0], ref["params"], ref["start"],
                           rec[0]["losses"], ref["losses"])
            probes = [torch.load(os.path.join(root,
                                              f"tp_{part}_probe_{pid}.pt"))
                      for pid in sorted(res)]
            gaps["probe_delta_l2"] = tp_probe_gap(torch, probes[0],
                                                  ref["probe"], ref["cfg"])
            equal = equal and all(torch.equal(probes[0][k], probes[1][k])
                                  for k in probes[0])
            want = tp_expected_launches(layout)
        out[part] = {"mesh": str(TP_LAYOUTS[layout]), **gaps,
                     "losses": {p: rec[p]["losses"] for p in rec},
                     "params_equal_across_processes": equal,
                     **{f"p{p}": rec[p] for p in rec}}
        for pid in rec:
            launches[f"tp_{part}_p{pid}"] = rec[pid]["launches"]
            check(rec[pid]["launches"] == want,
                  f"({part}) process {pid} launches {rec[pid]['launches']}"
                  f", want {want}")
            for name, r in rec[pid]["kernel_checks"].items():
                seen.add(name)
                check(r["ok"], f"({part}) process {pid} {name} vs its "
                               f"plain version: {r}")
        check(rec[0]["losses"] == rec[1]["losses"] and equal
              and all(np.isfinite(rec[0]["losses"])),
              f"({part}) the processes differ: {out[part]['losses']}")
        check(tp_within(gaps), f"({part}) vs one process: {gaps}")
    check(seen == {"flash_attention_fwd", "flash_chunk_update",
                   "flash_attention_bwd"},
          f"kernels held to their plain versions across processes: {seen}")
    out["tol"] = TP_TOL
    return out, launches


def mh_table_results(torch, root, res, ref, ref_params):
    """(f) of both processes against the one-process dp2 run."""
    rec = {pid: res[pid]["table"] for pid in res}
    params = [torch.load(os.path.join(root, f"table_{pid}.pt"))
              for pid in sorted(res)]
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(rec[0]["losses"], ref["losses"]))
    param = max((params[0][k] - v).abs().max().item()
                for k, v in ref_params.items())
    equal = all(torch.equal(params[0][k], params[1][k]) for k in params[0])
    out = {"model": "tests/test_feature_column.py:238's: DenseFeatures "
                    "(x, an identity column of 32768 ids x 32, f32) and "
                    f"Dense(1), SGD 0.1, global B {TABLE_BATCH}, "
                    f"{TABLE_STEPS} steps",
           "losses": {p: rec[p]["losses"] for p in rec},
           "losses_one_process": ref["losses"],
           "loss_max_rel_diff": loss, "param_max_abs_diff": param,
           "params_equal_across_processes": equal,
           "table_spec": rec[0]["table_spec"],
           "table_rows_held": {p: rec[p]["table_rows_held"] for p in rec},
           "tol": TABLE_TOL}
    check(all(rec[p]["table_rows_held"] == (1 << 15) // MH_PROCS
              for p in rec)
          and rec[0]["table_spec"] == "PartitionSpec('dp', None)",
          f"(f) the table is not split over the processes: {out}")
    check(equal and rec[0]["losses"] == rec[1]["losses"]
          and loss <= TABLE_TOL["loss"] and param <= TABLE_TOL["param"],
          f"(f) across processes vs one process: {out}")
    return out


# The rest of the flagship transformer (``--phase moe`` runs it alone
# and builds the flash forward and backward sources; its (f) runs in the
# multihost phase's two processes): (a) bench_suite.py's "moe" config
# (bench_suite.py:124-126) at full width trained through the zoo twin's
# module and the port's train step; (b) its scatter dispatch against the
# dense one at a capacity that drops nothing; (c) a small MoE twin, card
# against CPU; (d) the fused head at the flagship width against the
# materialised head; (e) ``generate`` at the flagship width; (f) MoE with
# ``ep`` across the two processes, and the scatter under ``dp`` across
# them, each against one process.
MOE = dict(FLAGSHIP, moe_experts=8, moe_every=2, moe_top_k=1,
           moe_dispatch="scatter", moe_capacity_factor=1.25)
MOE_ZOO = f"""
import torch

from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as twin
from elasticdl_tpu_torch.model_zoo.transformer.transformer_lm import (
    batch_sharding_rule, dataset_fn, eval_metrics_fn, loss, optimizer,
    param_sharding_rules)
from elasticdl_tpu_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(compute_dtype=torch.bfloat16, **{MOE!r})


def custom_model(device=None, mesh=None):
    return twin.custom_model(config=CONFIG, device=device, mesh=mesh)
"""
MOE_STEPS, MOE_BATCH = 12, 8
# (b) scatter (capacity factor E: C = T, nothing dropped) against dense
# dispatch, one forward and backward at full width. Both run each
# token through the same expert with the same gate; the products differ
# only in shape ((E, C) slots against (B, E, S) rows), so cuBLAS sums
# them in another order and a bf16 rounding flips now and then, as the
# card against the CPU: the logits within LOGITS_REL_TOL, the loss 1e-3
# relative, every gradient within 5e-2 relative L2 (the port's bf16
# whole-model gradient limit, tests/test_torch_transformer.py), the key
# biases left out (true gradient 0: both are noise).
MOE_DISPATCH_TOL = dict(logits=LOGITS_REL_TOL, loss=1e-3, grad_l2=5e-2)
# (d) the fused head against the materialised one at B 8 x S 1024: the
# materialised head rounds the logits and their gradient to bf16
# (2^-9 relative an element), the fused one sums f32 logits from the
# bf16 operands and rounds each 128-token chunk's kernel gradient to
# bf16, summed over 8 chunks in bf16 (as JAX's scan): the loss 1e-3
# relative, lm_head's weight and bias gradients 2e-2 relative L2.
FUSED_TOL = dict(loss=1e-3, grad_l2=2e-2)
# (e) generate: B 8, a 128-token prompt, 64 greedy tokens. Decoding
# takes dense attention over the cache, the full forward #1: the two
# bf16 paths differ by a rounding now and then, and each rounds its
# logits to bf16. Each generated token's full-forward logit must lie
# within GEN_MARGIN_ULPS bf16 steps (2^-7·|top| each) of that
# position's top logit: the argmax, or at a near-tie a logit that
# ties it within the margin.
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_MARGIN_ULPS = 8, 128, 64, 2
# (f): the "moe" config cut to 2 layers (block 1 MoE), B 2 x S 512 (as
# the tp parts), 3 steps; ``ep`` across the processes on (1, 2,
# 2) over (dp, ep, tp) and ``dp`` across them on (2, 2) over (dp, ep)
# with top-2 at capacity factor 0.5 (choices dropped), each against the
# one-process run of its mesh. With ``ep`` across, both processes read
# the whole batch and add the same partial outputs (bit-equal to one
# process on the CPU): TP_TOL's loss and change limits. With ``dp``
# across, each process's weight gradients are bf16 sums over its own
# rows, added across the processes (1.3e-4 on the loss at a small width
# on the CPU, as the multihost phase's mnist reads 1.64e-4): TRAJ_TOL's.
MOE_MH_TOL = {"ep": dict(loss=TP_TOL["loss"], delta_l2=TP_TOL["delta_l2"]),
              "dp": dict(loss=TRAJ_TOL["loss"],
                         delta_l2=TRAJ_TOL["delta_l2"])}
MOE_MH_LAYERS, MOE_MH_STEPS = 2, 3
MOE_MH_DROP_SLACK = 0.01
MOE_MH_LAYOUTS = {"ep": ((1, 2, 2), ("dp", "ep", "tp"), {}),
                  "dp": ((2, 2), ("dp", "ep"),
                         dict(moe_top_k=2, moe_capacity_factor=0.5))}
_MOE_WEIGHTS = {}


def moe_weights(cfg):
    """The seed's weights of ``cfg`` through bridge (drawn once a
    process and architecture: the MoE routing options are not in the
    parameters)."""
    from elasticdl_tpu_torch import bridge

    key = (cfg.n_layers, cfg.moe_experts, cfg.max_len, cfg.d_model)
    if key not in _MOE_WEIGHTS:
        _MOE_WEIGHTS[key] = bridge.state_dict_from_flax(
            bridge.init_flax_params(cfg, seed=SEED))
    return _MOE_WEIGHTS[key]


def chain_batches(n, batch, seq, vocab, seed):
    """Learnable +1-chain token batches (the JAX tests' ``_batch``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        start = rng.integers(0, vocab, (batch, 1))
        tokens = (start + np.arange(seq + 1)[None]) % vocab
        out.append({"features": tokens[:, :-1].astype(np.int32),
                    "labels": tokens[:, 1:].astype(np.int32),
                    "mask": np.ones(batch, np.float32)})
    return out


def moe_dropped(model):
    """(dropped, choices) of the last forward over the MoE blocks (a
    device scalar, an int)."""
    moes = [b.moe for b in model.blocks if hasattr(b, "moe")]
    return (sum(m.dropped for m in moes), sum(m.choices for m in moes))


FLASH_PATH = ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")


def moe_training_part(torch, fa, pe, root):
    """(a) the "moe" config through the zoo module and ``core.step``'s
    train step: MOE_STEPS steps of B 8 x S 1024; the loss falls, #1 = #3
    = #4 = 8 launches a step exactly (0 for the others), step ms beside
    issue ms, tokens/s, peak memory and the share of dropped choices."""
    from elasticdl_tpu_torch.core.model_spec import get_model_spec
    from elasticdl_tpu_torch.core.step import build_train_step
    from elasticdl_tpu_torch.core.train_state import init_train_state

    zoo = write_zoo(root, "moe_lm", MOE_ZOO)
    spec = get_model_spec(zoo, "moe_lm.rec.custom_model", device=DEVICE)
    # The twin's own initialisation (torch's defaults), as the flagship's
    # training phase: from flax's (bridge.init_flax_params) the router
    # sent 43-84% of the choices past capacity and the loss did not
    # fall in 12 steps on the H100 (PERF.md §6).
    torch.manual_seed(SEED)
    with torch.device(DEVICE):
        model = spec.make_model()
    model.train()
    state = init_train_state(model, spec.make_optimizer(), seed=SEED)
    step = build_train_step(spec.loss)
    batches = chain_batches(MOE_STEPS, MOE_BATCH, MOE["max_len"],
                            MOE["vocab_size"], SEED + 90)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_launches(fa, pe)                # the moe path starts
    losses, events, issue_ms, dropped = [], [], [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, m = step(state, b)
        end.record()
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        events.append((start, end))
        losses.append(m["loss"])
        dropped.append(moe_dropped(state.model)[0])
    torch.cuda.synchronize()
    counts = kernel_launch_counts(fa, pe)        # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    choices = moe_dropped(state.model)[1]
    losses = [float(x) for x in losses]
    step_ms = [s.elapsed_time(e) for s, e in events]
    shares = [int(d) / choices for d in dropped]
    warm = step_ms[2:]
    seq = MOE["max_len"]
    out = {"model": "bench_suite.py's moe config (8 experts in every "
                    "second block, top-1, scatter, capacity factor 1.25) "
                    "at full width, the twin's own random weights, seed "
                    f"{SEED}, Adam 1e-3", "batch": MOE_BATCH, "seq": seq,
           "steps": len(batches), "losses": losses,
           "launches": counts, "step_ms": spread(warm),
           "issue_ms": spread(issue_ms[2:]),
           "first_step_ms": step_ms[0],
           "tokens_per_s": MOE_BATCH * seq / (np.median(warm) / 1e3),
           "max_memory_allocated_bytes": peak,
           "dropped_share": shares, "choices_a_step": choices}
    print("moe training", json.dumps(out), flush=True)
    layers = MOE["n_layers"]
    for name in FLASH_PATH:
        check(counts[name] == layers * len(batches),
              f"(a) {name}: {counts[name]} launches in {len(batches)} "
              f"steps of {layers} layers")
    check(not any(v for k, v in counts.items() if k not in FLASH_PATH),
          f"(a) other kernels: {counts}")
    check(all(np.isfinite(losses)), f"(a) non-finite loss {losses}")
    check(losses[-1] < 0.9 * losses[0],
          f"(a) the loss did not fall: {losses}")
    check(0.0 <= min(shares) and max(shares) < 1.0, f"(a) drops {shares}")
    model = state.model
    del state, step
    torch.cuda.empty_cache()
    return out, counts, model


def moe_grads(torch, model, batch, loss_fn):
    """One training forward and backward: the loss, the logits (None for
    the fused triple) and every parameter's gradient, in f32 on the
    card."""
    model.train()
    model.zero_grad(set_to_none=True)
    features = torch.as_tensor(batch["features"], device=DEVICE)
    labels = torch.as_tensor(batch["labels"], device=DEVICE)
    mask = torch.as_tensor(batch["mask"], device=DEVICE)
    out = model(features)
    loss = loss_fn(labels, out, mask)
    loss.backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    logits = None if isinstance(out, tuple) else out.detach().float()
    return float(loss), logits, grads


def rel_l2(got, want):
    """||got - want|| / ||want|| of two tensors on one device."""
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def grad_gaps(got, want):
    """Relative L2 of each gradient (the key biases, true gradient 0,
    left out)."""
    return {n: rel_l2(got[n], w) for n, w in want.items()
            if not n.endswith("attn.key.bias")}


def with_cfg(model, cfg):
    """Point ``model`` and its MoE layers at ``cfg`` (the dispatch, the
    capacity and the head are read at each forward; the parameters do
    not depend on them). Returns the old config."""
    old = model.cfg
    model.cfg = cfg
    for block in model.blocks:
        if hasattr(block, "moe"):
            block.moe.cfg = cfg
    return old


def moe_dispatch_part(torch, fa, pe, model):
    """(b) the "moe" config's scatter dispatch at capacity factor E
    (C = T: drop-free) against the dense dispatch, one forward and its
    gradients on the same batch, with (a)'s trained weights
    (MOE_DISPATCH_TOL)."""
    from elasticdl_tpu_torch.model_zoo.transformer import (
        transformer_lm as zoo,
    )

    cfg = model.cfg
    batch = chain_batches(1, MOE_BATCH, MOE["max_len"], MOE["vocab_size"],
                          SEED + 91)[0]
    runs = {}
    try:
        for name, changes in (("scatter", dict(
                moe_capacity_factor=float(MOE["moe_experts"]))),
                ("dense", dict(moe_dispatch="dense"))):
            with_cfg(model, dataclasses.replace(cfg, **changes))
            runs[name] = moe_grads(torch, model, batch, zoo.loss)
            if name == "scatter":
                dropped = int(moe_dropped(model)[0])
    finally:
        with_cfg(model, cfg)
    (s_loss, s_logits, s_grads), (d_loss, d_logits, d_grads) = (
        runs["scatter"], runs["dense"])
    gaps = grad_gaps(s_grads, d_grads)
    worst = max(gaps.items(), key=lambda kv: kv[1])
    out = {"capacity_factor": float(MOE["moe_experts"]), "dropped": dropped,
           "loss_scatter": s_loss, "loss_dense": d_loss,
           "loss_rel_diff": abs(s_loss - d_loss) / abs(d_loss),
           "logits_rel_l2": rel_l2(s_logits, d_logits),
           "grad_l2_worst": worst,
           "grad_l2_median": float(np.median(list(gaps.values()))),
           "tol": MOE_DISPATCH_TOL}
    print("moe dispatch", json.dumps(out), flush=True)
    check(dropped == 0, f"(b) the drop-free scatter dropped {dropped}")
    check(out["logits_rel_l2"] <= MOE_DISPATCH_TOL["logits"]
          and out["loss_rel_diff"] <= MOE_DISPATCH_TOL["loss"]
          and worst[1] <= MOE_DISPATCH_TOL["grad_l2"],
          f"(b) scatter vs dense: {out}")
    return out


def moe_twin_part(torch, fa, pe):
    """(c) the zoo twin's CONFIG with 4 experts in block 1 (top-1,
    scatter, capacity factor 1.25, bf16), 5 Adam steps on the card and
    on the CPU from the same weights and batches: the tokens whose
    expert differs at the first step (the router's strict-f32 product on
    each side's own input), and the losses within TRAJ_TOL."""
    from elasticdl_tpu_torch.core.step import build_train_step
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.model_zoo.transformer import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.models.transformer import TransformerLM

    cfg = dataclasses.replace(zoo.CONFIG, moe_experts=4, moe_every=2,
                              moe_dispatch="scatter")
    batches = chain_batches(5, 8, cfg.max_len, cfg.vocab_size, SEED + 92)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = TransformerLM(cfg).to(dev)
        model.load_state_dict(moe_weights(cfg))
        model.train()
        routed = []

        def hook(module, args, routed=routed):
            if not routed:
                with torch.no_grad():
                    routed.append(module.route(args[0])[0].cpu())

        handle = model.blocks[1].moe.register_forward_pre_hook(hook)
        state = init_train_state(model, zoo.optimizer(), seed=SEED)
        step = build_train_step(zoo.loss)
        before = kernel_launch_counts(fa, pe)
        losses, dropped = [], []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            dropped.append(int(moe_dropped(state.model)[0]))
        handle.remove()
        runs[dev] = (losses, routed[0], dropped,
                     launches_since(fa, pe, before))
    card, cpu = runs["cuda"], runs["cpu"]
    flips = int((card[1] != cpu[1]).any(-1).sum())
    rel = [abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0])]
    out = {"config": "the zoo twin's CONFIG (vocab 256, d 128, 8 heads, "
                     "2 layers, d_ff 256) with 4 experts in block 1, "
                     "top-1, scatter 1.25, bf16",
           "losses_cuda": card[0], "losses_cpu": cpu[0],
           "loss_max_rel_diff": max(rel), "tokens": int(card[1].shape[0]
                                                        * card[1].shape[1]),
           "tokens_routed_differently": flips,
           "dropped_cuda": card[2], "dropped_cpu": cpu[2],
           "launches_cuda": card[3], "tol": TRAJ_TOL["loss"]}
    print("moe twin", json.dumps(out), flush=True)
    check(all(v == (cfg.n_layers * len(batches) if k in FLASH_PATH else 0)
              for k, v in card[3].items()), f"(c) card launches {card[3]}")
    check(max(rel) <= TRAJ_TOL["loss"], f"(c) card vs CPU losses: {out}")
    check(card[0][-1] < card[0][0], f"(c) the loss did not fall: {out}")
    return out


def flagship_on_card(torch):
    """The flagship (FLAGSHIP, bf16) built on the card with the twin's
    own seeded initialisation."""
    from elasticdl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    torch.manual_seed(SEED)
    with torch.device(DEVICE):
        return TransformerLM(TransformerConfig(**FLAGSHIP))


def fused_head_part(torch, fa, pe, model):
    """(d) the flagship with the fused head against the materialised
    head at B 8 x S 1024 on the card, one training forward and backward
    each with the same weights: the loss and lm_head's gradients
    (FUSED_TOL), #1 = #3 = #4 = 8 launches each, and the peak memory of
    each step above what was allocated before it (the fused one must be
    lower)."""
    from elasticdl_tpu_torch.model_zoo.transformer import (
        transformer_lm as zoo,
    )

    cfg = model.cfg
    batch = chain_batches(1, TRAIN_BATCH, FLAGSHIP["max_len"],
                          FLAGSHIP["vocab_size"], SEED + 93)[0]
    runs = {}
    try:
        for fused in (True, False):
            with_cfg(model, dataclasses.replace(cfg, fused_head=fused))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = kernel_launch_counts(fa, pe)
            loss, _, grads = moe_grads(torch, model, batch, zoo.loss)
            counts = launches_since(fa, pe, before)
            peak = torch.cuda.max_memory_allocated() - base
            runs[fused] = (loss, {n: grads[n] for n in (
                "lm_head.weight", "lm_head.bias")}, peak, counts)
            del grads
    finally:
        with_cfg(model, cfg)
    (f_loss, f_grads, f_peak, f_counts), (p_loss, p_grads, p_peak,
                                          p_counts) = runs[True], runs[False]
    gaps = {n: rel_l2(f_grads[n], p_grads[n]) for n in f_grads}
    out = {"batch": TRAIN_BATCH, "seq": FLAGSHIP["max_len"],
           "loss_fused": f_loss, "loss_plain": p_loss,
           "loss_rel_diff": abs(f_loss - p_loss) / abs(p_loss),
           "lm_head_grad_l2": gaps,
           "peak_bytes_above_start": {"fused": f_peak, "plain": p_peak},
           "launches": {"fused": f_counts, "plain": p_counts},
           "tol": FUSED_TOL}
    print("fused head", json.dumps(out), flush=True)
    for counts in (f_counts, p_counts):
        check(all(v == (cfg.n_layers if k in FLASH_PATH else 0)
                  for k, v in counts.items()), f"(d) launches {counts}")
    check(out["loss_rel_diff"] <= FUSED_TOL["loss"]
          and max(gaps.values()) <= FUSED_TOL["grad_l2"],
          f"(d) fused vs materialised head: {out}")
    check(f_peak < p_peak, f"(d) the fused head's peak is not lower: {out}")
    return out


def generate_part(torch, fa, pe, model):
    """(e) ``generate`` with the flagship (d)'s weights: B 8, a 128-token
    prompt, 64 greedy tokens; ms a token (CUDA events over the whole
    call, and the host's wall); no kernel launches while decoding
    (dense attention over the cache, as JAX's decode); then the full
    forward (#1) over prompt + generated: each token its argmax, or at a
    near-tie (GEN_MARGIN_ULPS) one of its top two."""
    from elasticdl_tpu_torch.models.transformer import generate

    cfg = model.cfg
    prompt = np.random.default_rng(SEED + 94).integers(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    generate(cfg, model, prompt[:, :8], 2)                # warm
    torch.cuda.synchronize()
    before = kernel_launch_counts(fa, pe)                 # decoding starts
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    tokens = generate(cfg, model, prompt, GEN_NEW)
    end.record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    decode_counts = launches_since(fa, pe, before)        # ... and ends
    device_ms = start.elapsed_time(end)
    tokens = tokens.cpu().numpy()
    full = np.concatenate([prompt, tokens], axis=1)[:, :-1]
    before = kernel_launch_counts(fa, pe)
    with torch.inference_mode():
        logits = model.eval()(torch.as_tensor(full, device=DEVICE))[
            :, GEN_PROMPT - 1:].float()
    forward_counts = launches_since(fa, pe, before)
    top2 = logits.topk(2, dim=-1)
    top, second = top2.values[..., 0], top2.values[..., 1]
    margin = GEN_MARGIN_ULPS * torch.exp2(
        torch.floor(torch.log2(top.abs().clamp_min(1e-30))) - 7)
    near = ((top - second) <= margin).cpu().numpy()
    chosen = logits.gather(-1, torch.as_tensor(
        tokens, device=logits.device).long()[..., None])[..., 0]
    within_margin = ((top - chosen) <= margin).cpu().numpy()
    first = top2.indices[..., 0].cpu().numpy() == tokens
    out = {"batch": GEN_BATCH, "prompt": GEN_PROMPT, "new": GEN_NEW,
           "ms_per_token": device_ms / GEN_NEW,
           "wall_ms_per_token": wall_ms / GEN_NEW,
           "issue_ms_per_token": issue_ms / GEN_NEW,
           "tokens_per_s": GEN_BATCH * GEN_NEW / (wall_ms / 1e3),
           "decode_launches": decode_counts,
           "forward_launches": forward_counts,
           "positions": int(near.size), "near_ties": int(near.sum()),
           "margin_bf16_steps": GEN_MARGIN_ULPS,
           "argmax_equal": int(first.sum()),
           "other_token_within_margin": int((~first & within_margin).sum()),
           "outside_margin": int((~within_margin).sum()),
           "min_top2_gap": float((top - second).min())}
    print("generate", json.dumps(out), flush=True)
    check(tokens.shape == (GEN_BATCH, GEN_NEW), f"(e) shape {tokens.shape}")
    check(not any(decode_counts.values()),
          f"(e) decoding launched {decode_counts}")
    check(all(v == (cfg.n_layers if k == "flash_attention_fwd" else 0)
              for k, v in forward_counts.items()),
          f"(e) the full forward's launches {forward_counts}")
    check(out["outside_margin"] == 0,
          f"(e) generated tokens vs the full forward: {out}")
    return out


def moe_mh_config():
    from elasticdl_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**dict(MOE, n_layers=MOE_MH_LAYERS,
                                    max_len=TP_SEQ))


def moe_mh_run(torch, fa, pe, layout, pid=None):
    """(f)'s run of ``layout`` (MOE_MH_LAYOUTS) through MeshRunner with
    the transformer's rules: in process ``pid`` its block of the batches
    (None: the one-process run, every entry here). Returns its record
    and its whole parameters."""
    from elasticdl_tpu_torch.model_zoo.transformer import (
        transformer_lm as zoo,
    )
    from elasticdl_tpu_torch.models.transformer import (
        TransformerLM,
        transformer_sharding_rules,
    )
    from elasticdl_tpu_torch.parallel import multihost
    from elasticdl_tpu_torch.parallel import rules
    from elasticdl_tpu_torch.parallel.mesh import make_mesh
    from elasticdl_tpu_torch.parallel.mesh_runner import MeshRunner

    shape, axes, changes = MOE_MH_LAYOUTS[layout]
    base = moe_mh_config()
    cfg = dataclasses.replace(base, **changes)
    per = int(np.prod(shape)) // (1 if pid is None else MH_PROCS)
    mesh = make_mesh(shape, axes, [torch.device(DEVICE)] * per)
    model = TransformerLM(cfg, mesh=mesh).to(DEVICE)
    model.load_state_dict(moe_weights(base))
    runner = MeshRunner(mesh, param_rule=rules.regex_param_rule(
        transformer_sharding_rules(), mesh=mesh),
        batch_rule=zoo.batch_sharding_rule)
    state = runner.init_state(
        model, lambda params: torch.optim.Adam(params, lr=1e-3), seed=SEED)
    step = runner.train_step(zoo.loss)
    batches = chain_batches(MOE_MH_STEPS, TP_BATCH, TP_SEQ,
                            cfg.vocab_size, SEED + 95)
    if pid is not None and "dp" in layout:
        rows = TP_BATCH // MH_PROCS
        batches = [{k: v[pid * rows:(pid + 1) * rows] for k, v in b.items()}
                   for b in batches]
    batches = [runner.place_batch(b) for b in batches]
    clock = CollectiveClock(torch, multihost)
    try:
        torch.cuda.synchronize()
        reset_kernel_launches(fa, pe)             # the path starts here
        dropped = []
        losses, times = [], {"step_ms": [], "issue_ms": [],
                             "collective_ms": []}
        for b in batches:
            state, ls, t = mh_timed_steps(torch, step, state, [b], clock)
            losses += ls
            for k in times:
                times[k] += t[k]
            dropped.append(int(state.model.blocks[1].moe.dropped)
                           if cfg.moe_dispatch == "scatter" else None)
        torch.cuda.synchronize()
        counts = kernel_launch_counts(fa, pe)     # ... and ends here
    finally:
        clock.restore()
    held = list(state.model.blocks[1].moe.wi.shape)
    record = {"losses": losses, **times, "launches": counts,
              "dropped": dropped, "wi_held": held,
              "collective_ms_by_name": clock.ms_by_name}
    params = whole_params(runner, state)
    del state, model
    torch.cuda.empty_cache()
    return record, params


def mh_child_moe(torch, fa, pe, pid, root, out):
    """(f) in process ``pid``: ``ep`` across the processes, then the
    scatter under ``dp`` across them; the whole parameters saved."""
    res = {}
    for layout in MOE_MH_LAYOUTS:
        record, params = moe_mh_run(torch, fa, pe, layout, pid)
        torch.save(params, os.path.join(root, f"moe_{layout}_{pid}.pt"))
        res[layout] = record
    out["moe"] = res


def moe_mh_references(torch, fa, pe):
    """(f)'s one-process runs, every entry here: per layout its record
    and whole parameters."""
    return {layout: moe_mh_run(torch, fa, pe, layout)
            for layout in MOE_MH_LAYOUTS}


def moe_mh_results(torch, root, res, refs):
    """(f) of both processes against the one-process runs ``refs``:
    losses and changes within MOE_MH_TOL, the processes' losses and
    whole parameters equal, the dropped choices the one-process run's
    (MOE_MH_DROP_SLACK after the first step), the experts held a half a
    process under ``ep``, launches as one process's. Returns the line
    and the launches by part and process."""
    out, launches = {}, {}
    start = {k: v.float() for k, v in moe_weights(moe_mh_config()).items()}
    for layout in MOE_MH_LAYOUTS:
        ref, ref_params = refs[layout]
        rec = {pid: res[pid]["moe"][layout] for pid in res}
        params = [torch.load(os.path.join(root, f"moe_{layout}_{pid}.pt"))
                  for pid in sorted(res)]
        equal = all(torch.equal(params[0][k], params[1][k])
                    for k in params[0])
        gaps = tp_gaps(params[0], ref_params, start, rec[0]["losses"],
                       ref["losses"])
        if layout == "ep":
            dropped = rec[0]["dropped"]
            split = (rec[0]["wi_held"][0] * MH_PROCS == ref["wi_held"][0]
                     == MOE["moe_experts"])
        else:
            dropped = [a + b for a, b in zip(rec[0]["dropped"],
                                             rec[1]["dropped"])]
            split = rec[0]["wi_held"] == ref["wi_held"]
        out[layout] = {"mesh": str(MOE_MH_LAYOUTS[layout][:2]), **gaps,
                       "losses": {p: rec[p]["losses"] for p in rec},
                       "losses_one_process": ref["losses"],
                       "dropped": dropped, "dropped_one_process":
                       ref["dropped"], "params_equal_across_processes":
                       equal, "one_process": ref,
                       **{f"p{p}": rec[p] for p in rec}}
        for pid in rec:
            launches[f"moe_{layout}_p{pid}"] = rec[pid]["launches"]
            check(rec[pid]["launches"] == ref["launches"]
                  and ref["launches"]["flash_attention_fwd"] > 0,
                  f"(f) {layout} process {pid} launches "
                  f"{rec[pid]['launches']}, one process {ref['launches']}")
        check(split, f"(f) {layout}: the experts held {rec[0]['wi_held']}")
        check(rec[0]["losses"] == rec[1]["losses"] and equal
              and all(np.isfinite(rec[0]["losses"])),
              f"(f) {layout}: the processes differ {out[layout]['losses']}")
        # The first step starts from the same weights: the processes
        # drop the one-process run's choices (ranked locally, each would
        # fill the slots from 0 and drop hundreds fewer). Later steps
        # start from weights a bf16 rounding apart, where a near-tie
        # may route a token elsewhere: within MOE_MH_DROP_SLACK.
        check(dropped[0] == ref["dropped"][0] and all(
            abs(d - r) <= MOE_MH_DROP_SLACK * r
            for d, r in zip(dropped, ref["dropped"])),
            f"(f) {layout}: dropped {dropped}, one process "
            f"{ref['dropped']}")
        check(layout != "dp" or min(ref["dropped"]) > 0,
              f"(f) dp: nothing dropped {ref['dropped']}")
        tol = MOE_MH_TOL[layout]
        check(gaps["loss_max_rel_diff"] <= tol["loss"]
              and gaps["delta_l2"] <= tol["delta_l2"],
              f"(f) {layout} vs one process: {gaps}, limits {tol}")
    out["tol"] = MOE_MH_TOL
    return out, launches


def moe_local_parts(torch, fa, pe, root):
    """(a)-(e) and (f)'s one-process references: what the phase runs in
    this process. In the whole smoke it runs while the checkpoint
    phase's evaluate/predict subprocesses do (its step times then share
    the host with them and with the multihost processes; ``--phase
    moe`` gives them the host alone)."""
    marks, out = {}, {}
    t = time.monotonic()
    out["training"], counts, model = moe_training_part(torch, fa, pe, root)
    marks["a"] = time.monotonic() - t
    t = time.monotonic()
    out["dispatch"] = moe_dispatch_part(torch, fa, pe, model)
    del model
    torch.cuda.empty_cache()
    marks["b"] = time.monotonic() - t
    t = time.monotonic()
    out["twin"] = moe_twin_part(torch, fa, pe)
    marks["c"] = time.monotonic() - t
    t = time.monotonic()
    model = flagship_on_card(torch)
    out["fused_head"] = fused_head_part(torch, fa, pe, model)
    marks["d"] = time.monotonic() - t
    t = time.monotonic()
    out["generate"] = generate_part(torch, fa, pe, model)
    del model
    torch.cuda.empty_cache()
    marks["e"] = time.monotonic() - t
    t = time.monotonic()
    refs = moe_mh_references(torch, fa, pe)
    marks["f_references"] = time.monotonic() - t
    launches = {"training": counts,
                "fused_head": out["fused_head"]["launches"]["fused"],
                "plain_head": out["fused_head"]["launches"]["plain"],
                "generate": out["generate"]["decode_launches"]}
    return {"out": out, "launches": launches, "refs": refs,
            "part_s": marks}


def moe_phase(torch, fa, pe, root, started, local=None, res=None):
    """(a)-(e) here (``local``: ``moe_local_parts``' result where the
    whole smoke ran them already); (f) from the multihost processes'
    results ``res`` (``--phase moe`` writes the go file for their moe
    part alone and waits for them). Returns the phase's line and its
    launches by part."""
    if res is None:
        multihost_go(started, "moe")
    if local is None:
        local = moe_local_parts(torch, fa, pe, root)
    marks = dict(local["part_s"])
    t = time.monotonic()
    if res is None:
        res = mh_wait(started)
    marks["f_wait"] = time.monotonic() - t
    t = time.monotonic()
    mh, mh_launches = moe_mh_results(torch, started["root"], res,
                                     local["refs"])
    marks["f"] = time.monotonic() - t
    out = {**local["out"], "multihost": mh,
           "part_s": {k: round(v, 2) for k, v in marks.items()}}
    return out, {**local["launches"], **mh_launches}


# The GPipe pipeline (``--phase pipeline`` runs (a) alone and builds the
# flash forward and backward sources; (g) runs in the multihost phase's
# two processes, with the multi-host checkpoints (h) and the job's (i)):
# (a) PipelineLM at the flagship's widths (bench_suite.py:121, dropout 0)
# on a one-card (pp 2, dp 2) mesh, 4 layers a stage, M 4, B 16 x S 1024,
# 3 Adam steps, against the port's TransformerLM with the same weights
# and batches; its step timed at M 4 and M 8.
PIPE_MESH = ((2, 2), ("pp", "dp"))
PIPE_STAGE_LAYERS, PIPE_M, PIPE_STEPS = 4, 4, 3
PIPE_BATCH, PIPE_TIMED_M, PIPE_TIMED_STEPS = 16, (4, 8), 4
# (a) against TransformerLM, TRAJ_TOL's readings per tensor: each
# microbatch's forward is the flagship's on its rows (the same kernels
# at a quarter of the rows), so the first loss agrees to the ulp; the
# backward rounds each microbatch's weight gradients to bf16 before the
# f32 sum over the microbatches, where the flagship rounds the whole
# batch's once: the same effect as two processes' bf16 gradients summed
# (mnist over two processes: 1.34e-5 in f32, 1.636e-4 in bf16), which
# TRAJ_TOL bounds for the twin card vs CPU (loss 2e-4, first gradients 2e-2,
# changes 0.25; Adam's first steps lr * sign(g) turn a sign flipped on a
# near-zero gradient into a whole step). (g), the processes against (a):
# TP_TOL (the stages' gradients summed over the microbatches in another
# order, the ends' bit-equal by construction).
PIPE_TOL = dict(TRAJ_TOL)
PIPE_MH_TOL = dict(loss=TP_TOL["loss"], delta_l2=TP_TOL["delta_l2"])
_PIPE_WEIGHTS = {}


def pipe_config():
    from elasticdl_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**FLAGSHIP)


def pipe_weights(torch):
    """PipelineLM's own initialisation from SEED, whole, on the host
    (drawn once a process, on a one-process CPU mesh of its shape)."""
    from elasticdl_tpu_torch.models.pipeline_lm import PipelineLM
    from elasticdl_tpu_torch.parallel.mesh import Mesh

    if not _PIPE_WEIGHTS:
        shape, axes = PIPE_MESH
        mesh = Mesh(np.array([torch.device("cpu")] * int(np.prod(shape)),
                             dtype=object).reshape(shape), axes)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            lm = PipelineLM(pipe_config(), mesh,
                            layers_per_stage=PIPE_STAGE_LAYERS)
        _PIPE_WEIGHTS.update({k: v.detach()
                              for k, v in lm.state_dict().items()})
    return _PIPE_WEIGHTS


def pipe_model(torch, mesh, m=PIPE_M):
    """PipelineLM on ``mesh`` with ``m`` microbatches and pipe_weights,
    on the card."""
    from elasticdl_tpu_torch.models.pipeline_lm import PipelineLM

    with torch.device("meta"):
        lm = PipelineLM(pipe_config(), mesh, num_microbatches=m,
                        layers_per_stage=PIPE_STAGE_LAYERS)
    lm = lm.to_empty(device=DEVICE)
    lm.load_state_dict(pipe_weights(torch))
    return lm


def pipe_batches():
    return chain_batches(PIPE_STEPS, PIPE_BATCH, FLAGSHIP["max_len"],
                         FLAGSHIP["vocab_size"], SEED + 100)


def pipe_expected(m, layers):
    """Exact launches of one pipeline step: #1, #3 and #4 once a layer a
    microbatch (each microbatch runs once over its dp rows)."""
    return {**dict.fromkeys(("lookup_combine", "lookup_combine_aligned",
                             "row_update", "fused_row_update",
                             "flash_chunk_update"), 0),
            **dict.fromkeys(FLASH_PATH, m * layers)}


def pipe_steps(torch, fa, pe, lm, batches, clock=None, whole=None):
    """``lm``'s train step (the zoo's loss, Adam 1e-3) on ``batches``:
    per step the loss, CUDA-event ms, issue ms and launches (zeroed just
    before each step, read just after), ms inside the collectives; the
    first step's gradients and the final parameters, whole on the host
    in f32 by the flagship's names (``whole``: a parameter's whole
    value from what the process holds)."""
    from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as zoo
    from elasticdl_tpu_torch.models.pipeline_lm import sequential_state_dict

    whole = whole or (lambda name, t: t)
    step = lm.make_train_step(zoo.loss, zoo.optimizer())

    def named(of):
        return sequential_state_dict(
            {n: whole(n, of(p).detach()).float().cpu().clone()
             for n, p in lm.named_parameters()},
            lm.pp_size, lm.layers_per_stage)

    start = named(lambda p: p)
    rec = {"losses": [], "step_ms": [], "issue_ms": [], "launches": [],
           "collective_ms": []}
    grads = None
    for b in batches:
        torch.cuda.synchronize()
        reset_kernel_launches(fa, pe)            # the step starts here
        before = clock.ms if clock else 0.0
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        begin.record()
        loss = step(b)
        end.record()
        rec["issue_ms"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        rec["launches"].append(kernel_launch_counts(fa, pe))  # ... ends
        rec["step_ms"].append(begin.elapsed_time(end))
        rec["collective_ms"].append((clock.ms if clock else 0.0) - before)
        rec["losses"].append(float(loss))
        if grads is None:
            grads = named(lambda p: p.grad)
    return rec, start, grads, named(lambda p: p)


def pipe_flagship_steps(torch, fa, pe, batches):
    """The port's TransformerLM on the same weights (stage s, layer l as
    block s * 4 + l) and batches, Adam 1e-3, one card: its losses, step
    ms, first gradients and final parameters."""
    from elasticdl_tpu_torch.model_zoo.transformer import transformer_lm as zoo
    from elasticdl_tpu_torch.models.pipeline_lm import sequential_state_dict
    from elasticdl_tpu_torch.models.transformer import TransformerLM

    with torch.device("meta"):
        model = TransformerLM(pipe_config())
    model = model.to_empty(device=DEVICE)
    model.load_state_dict(sequential_state_dict(
        pipe_weights(torch), PIPE_MESH[0][0], PIPE_STAGE_LAYERS))
    model.train()
    opt = zoo.optimizer()(model.parameters())
    rec = {"losses": [], "step_ms": [], "issue_ms": []}
    grads = None
    for b in batches:
        feats, labels, mask = (torch.as_tensor(b[k]).to(DEVICE) for k in (
            "features", "labels", "mask"))
        torch.cuda.synchronize()
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        begin.record()
        opt.zero_grad(set_to_none=True)
        loss = zoo.loss(labels, model(feats), mask)
        loss.backward()
        opt.step()
        end.record()
        rec["issue_ms"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        rec["step_ms"].append(begin.elapsed_time(end))
        rec["losses"].append(float(loss.detach()))
        if grads is None:
            grads = {n: p.grad.detach().float().cpu().clone()
                     for n, p in model.named_parameters()}
    final = {n: p.detach().float().cpu().clone()
             for n, p in model.named_parameters()}
    del model, opt
    torch.cuda.empty_cache()
    return rec, grads, final


def pipe_tokens_per_s(rec):
    warm = rec["step_ms"][1:] or rec["step_ms"]
    return PIPE_BATCH * FLAGSHIP["max_len"] / (float(np.median(warm)) / 1e3)


def pipeline_phase(torch, fa, pe, root):
    """(a): PipelineLM on the one-card (pp 2, dp 2) mesh against the
    flagship TransformerLM, launches exact, then the step timed at M 4
    and M 8. Returns its line, its launches by part and the run's
    record ((g)'s reference)."""
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    marks = [time.monotonic()]
    shape, axes = PIPE_MESH
    mesh = make_mesh(shape, axes, [torch.device(DEVICE)] * int(np.prod(
        shape)))
    batches = pipe_batches()
    pipe_weights(torch)
    weights_s = time.monotonic() - marks[0]
    lm = pipe_model(torch, mesh)
    rec, start, grads, final = pipe_steps(torch, fa, pe, lm, batches)
    del lm
    torch.cuda.empty_cache()
    marks.append(time.monotonic())
    flat, flat_grads, flat_final = pipe_flagship_steps(torch, fa, pe,
                                                       batches)
    marks.append(time.monotonic())
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(rec["losses"], flat["losses"]))
    grad = grad_gaps(grads, flat_grads)
    delta = grad_gaps({n: final[n] - start[n] for n in final},
                      {n: flat_final[n] - start[n] for n in flat_final})
    timed = {}
    for m in PIPE_TIMED_M:
        lm = pipe_model(torch, mesh, m)
        t_rec, _, _, _ = pipe_steps(torch, fa, pe, lm, chain_batches(
            PIPE_TIMED_STEPS, PIPE_BATCH, FLAGSHIP["max_len"],
            FLAGSHIP["vocab_size"], SEED + 101))
        del lm
        torch.cuda.empty_cache()
        timed[f"M{m}"] = {
            "step_ms": spread(t_rec["step_ms"][1:]),
            "issue_ms": spread(t_rec["issue_ms"][1:]),
            "first_step_ms": t_rec["step_ms"][0],
            "tokens_per_s": pipe_tokens_per_s(t_rec),
            "launches_a_step": t_rec["launches"][-1]}
        for counts in t_rec["launches"]:
            check(counts == pipe_expected(m, FLAGSHIP["n_layers"]),
                  f"(a) M {m}: launches {counts} a step")
    marks.append(time.monotonic())
    worst = lambda gaps: max(gaps, key=gaps.get)  # noqa: E731
    out = {"model": "PipelineLM at the flagship's widths (vocab 32768, d "
                    "512, 4 heads of 128, 8 layers, d_ff 2048, bf16, "
                    "dropout 0), PipelineLM's own random weights, seed "
                    f"{SEED}, Adam 1e-3, against TransformerLM on the "
                    "same weights",
           "mesh": str(PIPE_MESH), "layers_per_stage": PIPE_STAGE_LAYERS,
           "microbatches": PIPE_M, "batch": PIPE_BATCH,
           "seq": FLAGSHIP["max_len"], "steps": PIPE_STEPS,
           "losses": rec["losses"], "losses_flagship": flat["losses"],
           "loss_max_rel_diff": loss_gap,
           "grad_l2_max": grad[worst(grad)], "grad_l2_worst": worst(grad),
           "grad_l2_median": float(np.median(list(grad.values()))),
           "delta_l2_max": delta[worst(delta)],
           "delta_l2_worst": worst(delta),
           "delta_l2_median": float(np.median(list(delta.values()))),
           "step_ms": rec["step_ms"], "issue_ms": rec["issue_ms"],
           "flagship_step_ms": flat["step_ms"],
           "flagship_issue_ms": flat["issue_ms"],
           "flagship_tokens_per_s": pipe_tokens_per_s(flat),
           "timed": timed, "launches_a_step": rec["launches"],
           "part_s": {"weights": weights_s,
                      "pipeline": marks[1] - marks[0],
                      "flagship": marks[2] - marks[1],
                      "timed": marks[3] - marks[2]},
           "tol": PIPE_TOL}
    print("pipeline", json.dumps(out), flush=True)
    for counts in rec["launches"]:
        check(counts == pipe_expected(PIPE_M, FLAGSHIP["n_layers"]),
              f"(a) launches {counts} a step")
    check(all(np.isfinite(rec["losses"])), f"(a) losses {rec['losses']}")
    check(loss_gap <= PIPE_TOL["loss"]
          and out["grad_l2_max"] <= PIPE_TOL["grad_l2"]
          and out["delta_l2_max"] <= PIPE_TOL["delta_l2"],
          f"(a) PipelineLM vs TransformerLM: loss {loss_gap}, gradient "
          f"{out['grad_l2_max']} ({out['grad_l2_worst']}), change "
          f"{out['delta_l2_max']} ({out['delta_l2_worst']})")
    launches = {"a": rec["launches"][0],
                **{f"a_{k}": v["launches_a_step"] for k, v in timed.items()}}
    ref = {"losses": rec["losses"], "start": start, "final": final}
    return out, launches, ref


def mh_child_pipe(torch, fa, pe, pid, root, out):
    """(g) in process ``pid``: PipelineLM with ``pp`` across the two
    processes (this process's stage: 4 of the 8 blocks, the ends whole),
    (a)'s weights and batches; launches exact; one launch of #1 and of
    #3/#4 held to its plain version; the whole parameters saved."""
    from elasticdl_tpu_torch.parallel import multihost
    from elasticdl_tpu_torch.parallel.mesh import make_mesh

    shape, axes = PIPE_MESH
    mesh = make_mesh(shape, axes, [torch.device(DEVICE)] * (
        int(np.prod(shape)) // multihost.process_count()))
    lm = pipe_model(torch, mesh)
    shardings = lm.param_shardings()
    lm.place()
    held = {n: list(p.shape) for n, p in lm.named_parameters()
            if n in ("blocks.attn.query.weight", "ends.lm_head.weight")}
    # The pipeline's send (the host copy and the start), recv (to the
    # data's arrival: it waits for the previous stage) and broadcasts.
    clock = CollectiveClock(torch, multihost, (
        "all_reduce_", "all_gather", "send", "recv", "broadcast"))
    capture = KernelCapture(torch, fa)

    def whole(name, t):
        s = shardings[name]
        return s.gather_block(t) if s.spans_processes else t

    try:
        rec, start, _, final = pipe_steps(torch, fa, pe, lm, pipe_batches(),
                                          clock, whole)
    finally:
        capture.restore()
        clock.restore()
    rec["kernel_checks"] = capture.checks()
    rec["collective_calls"] = clock.calls
    rec["collective_ms_by_name"] = clock.ms_by_name
    rec["held_shapes"] = held
    torch.save({"start": start, "final": final},
               os.path.join(root, f"pipe_{pid}.pt"))
    del lm
    torch.cuda.empty_cache()
    out["pipe"] = rec


def mh_pipe_results(torch, root, res, ref):
    """(g) of both processes against (a)'s one-process run: losses and
    parameter changes within PIPE_MH_TOL, the processes' losses and
    whole parameters equal, exact launches a step, the captured launches
    within their plain versions' limits."""
    rec = {pid: res[pid]["pipe"] for pid in res}
    got = [torch.load(os.path.join(root, f"pipe_{pid}.pt"))
           for pid in sorted(res)]
    gaps = tp_gaps(got[0]["final"], ref["final"], ref["start"],
                   rec[0]["losses"], ref["losses"])
    equal = all(torch.equal(got[0]["final"][k], got[1]["final"][k])
                for k in got[0]["final"])
    want = pipe_expected(PIPE_M, PIPE_STAGE_LAYERS)
    out = {"mesh": f"{PIPE_MESH} over 2 processes (pp across)", **gaps,
           "losses": {p: rec[p]["losses"] for p in rec},
           "losses_one_process": ref["losses"],
           "params_equal_across_processes": equal,
           **{f"p{p}": {k: rec[p][k] for k in (
               "step_ms", "issue_ms", "collective_ms", "collective_calls",
               "collective_ms_by_name", "kernel_checks", "held_shapes")}
              for p in rec}, "tol": PIPE_MH_TOL}
    print("multihost pipeline", json.dumps(out), flush=True)
    launches = {}
    for pid in rec:
        launches[f"pipe_g_p{pid}"] = rec[pid]["launches"][0]
        for counts in rec[pid]["launches"]:
            check(counts == want, f"(g) process {pid} launches {counts} a "
                                  f"step, want {want}")
        checks = rec[pid]["kernel_checks"]
        check(set(checks) == {"flash_attention_fwd", "flash_attention_bwd"}
              and all(r["ok"] for r in checks.values()),
              f"(g) process {pid} kernels vs their plain versions: "
              f"{checks}")
        check(rec[pid]["held_shapes"]["blocks.attn.query.weight"][0] == 1,
              f"(g) process {pid} holds {rec[pid]['held_shapes']}")
    check(rec[0]["losses"] == rec[1]["losses"] and equal
          and all(np.isfinite(rec[0]["losses"])),
          f"(g) the processes differ: {out['losses']}")
    check(gaps["loss_max_rel_diff"] <= PIPE_MH_TOL["loss"]
          and gaps["delta_l2"] <= PIPE_MH_TOL["delta_l2"],
          f"(g) across processes vs one process: {gaps}")
    return out, launches


def mh_whole_leaves(torch, state):
    """Every leaf of ``state`` whole on the host (the native capture,
    each parameter held as its process's block gathered)."""
    from elasticdl_tpu_torch.checkpoint.state_io import (
        named_leaves_from_state,
    )
    from elasticdl_tpu_torch.common import dtypes

    out = named_leaves_from_state(state)
    for prefix, module in state.model.named_modules():
        for leaf, sharding in module.__dict__.get("_placed", {}).items():
            if sharding.spans_processes:
                value = sharding.gather_block(
                    getattr(module, leaf).detach()).cpu()
                out[f"params.{prefix}.{leaf}" if prefix
                    else f"params.{leaf}"] = (
                    dtypes.bf16_to_numpy(value)
                    if value.dtype == torch.bfloat16 else value.numpy())
    return out


def mh_checkpoint_part(torch, root, pid, runner, state, spec, mesh, tx):
    """(h) after (d)'s tp-across steps: every process saves through
    ``CheckpointHook(backend="orbax")`` and restores into a fresh state
    of (d)'s layout (bit-equal); process 0 also restores the same
    version onto the unsharded model, bit-equal to the gathered state.
    The save's stall (the step thread's capture) and seconds (to the
    version's rename), its bytes, the restores' seconds."""
    from elasticdl_tpu_torch.checkpoint import CheckpointHook
    from elasticdl_tpu_torch.checkpoint import restore_from_dir
    from elasticdl_tpu_torch.checkpoint.orbax_backend import (
        OrbaxSaver,
        restore_state,
    )
    from elasticdl_tpu_torch.core.train_state import init_train_state
    from elasticdl_tpu_torch.parallel.mesh_runner import make_runner_for_spec

    ckpt = os.path.join(root, "ckpt_h")
    want = mh_whole_leaves(torch, state)
    hook = CheckpointHook(ckpt, checkpoint_steps=int(state.step),
                          backend="orbax")
    t0 = time.perf_counter()
    check(hook.maybe_save(state), "(h) no save at the interval")
    stall = time.perf_counter() - t0
    hook.flush()
    save_s = time.perf_counter() - t0
    path = os.path.join(ckpt, f"orbax-{int(state.step)}")
    rec = {"version": int(state.step), "stall_s": stall, "save_s": save_s,
           "bytes": dir_bytes(path),
           "files": sorted(os.listdir(path))}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 7)
        model = spec.make_model(mesh)
    fresh = make_runner_for_spec(spec, mesh).init_state(model, tx,
                                                        seed=SEED + 7)
    t0 = time.perf_counter()
    fresh = restore_from_dir(fresh, ckpt)
    rec["restore_s"] = time.perf_counter() - t0
    rec["unequal"] = unequal_leaves(mh_whole_leaves(torch, fresh), want)
    rec["leaves"] = len(want)
    del fresh, model
    if pid == 0:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED + 8)
            plain = init_train_state(spec.make_model(), tx, seed=SEED + 8)
        t0 = time.perf_counter()
        plain = restore_state(OrbaxSaver(ckpt, collective=False), plain)
        rec["unsharded_restore_s"] = time.perf_counter() - t0
        rec["unsharded_unequal"] = unequal_leaves(
            mh_whole_leaves(torch, plain), want)
        del plain
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    import argparse

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--multihost-child"]:
        return multihost_child(int(argv[1]), argv[2])
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--phase", choices=("all", "fwd", "bwd", "chunk", "lookup", "host",
                            "vision", "tabular", "checkpoint", "worker",
                            "rowservice", "fleet", "parallel", "multihost",
                            "tpfault", "moe", "pipeline", "failover"),
        default="all",
        help="fwd: build flash_attention_fwd.cu alone, then run kernel "
             "#1's checks and times and print its kernels row; bwd: the "
             "same for flash_attention_bwd.cu (#3 and #4); chunk: the "
             "same for flash_chunk_update.cu (#2); lookup: the same for "
             "embedding_lookup.cu (#5 and #6, timed at the sweep's tiers); "
             "host: the host training phase alone (no kernel build); "
             "vision: the vision phase alone (no kernel build); "
             "tabular: the tabular phase alone (no kernel build); "
             "checkpoint: the checkpoint phase alone (the embedding "
             "kernels only); worker: the worker phase alone (the "
             "embedding kernels only); rowservice: the row-service "
             "phase alone with its 1M x 256 timings and the tiered store "
             "at that shape (no kernel build); "
             "fleet: the fleet phase alone with its timings "
             "(flash_attention_fwd.cu only); parallel: data and tensor "
             "parallel over the one-card mesh alone (the embedding and "
             "flash kernels); multihost: data, tensor and sequence "
             "parallel across two processes on the card alone (the "
             "embedding and flash kernels); tpfault: the one-process "
             "tensor-parallel run sound and with a planted fault, "
             "against TP_TOL (the flash kernels); moe: the moe config "
             "trained, scatter vs dense, the MoE twin card vs CPU, the "
             "fused head, generate, and MoE across the two processes "
             "(the flash forward and backward kernels); pipeline: "
             "PipelineLM at the flagship's widths on one card against "
             "TransformerLM, timed at M 4 and M 8 (the flash forward and "
             "backward kernels); failover: the worker phase's (a) and (e) "
             "alone, then the port's failover drill (standby against "
             "restart-and-replay) and one journal append's fsync times "
             "(the embedding kernels only)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    # The multihost phase's processes start first, so that their imports
    # overlap the earlier phases.
    mh = (multihost_start(torch)
          if args.phase in ("all", "multihost", "moe") else None)
    try:
        return run(args, torch, mh)
    finally:
        if mh is not None:
            multihost_stop(mh)


def run(args, torch, mh) -> int:
    """The phases ``args.phase`` names, on the card."""
    from elasticdl_tpu_torch.ops import _build
    from elasticdl_tpu_torch.ops import flash_attention as fa
    from elasticdl_tpu_torch.ops import pallas_embedding as pe
    from elasticdl_tpu_torch.ops import ring_attention as ra

    print(smi("name,power.limit"), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    try:
        import grpc

        print(f"grpc {grpc.__version__} importable", flush=True)
    except ImportError as exc:
        print(f"grpc not importable: {exc}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.phase in ("host", "vision", "tabular", "rowservice"):
        with tempfile.TemporaryDirectory() as root:
            if args.phase == "host":
                line = {"host_training": host_training_phase(torch, fa, pe,
                                                             root)}
            elif args.phase == "rowservice":
                line = {"rowservice": rowservice_phase(torch, fa, pe, root,
                                                       timed=True)}
            elif args.phase == "vision":
                line = {"vision": vision_phase(torch, fa, pe, root)}
            else:
                line = {"tabular": tabular_phase(torch, fa, pe, root)}
        print(json.dumps(line))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    t0 = time.monotonic()
    alone = {"fwd": [fa._SOURCE], "bwd": [fa._BWD_SOURCE],
             "chunk": [fa._CHUNK_SOURCE], "lookup": [pe._LOOKUP_SOURCE],
             "checkpoint": [pe._LOOKUP_SOURCE, pe._UPDATE_SOURCE],
             "worker": [pe._LOOKUP_SOURCE, pe._UPDATE_SOURCE],
             "failover": [pe._LOOKUP_SOURCE, pe._UPDATE_SOURCE],
             "parallel": [pe._LOOKUP_SOURCE, pe._UPDATE_SOURCE,
                          fa._CHUNK_SOURCE, fa._BWD_SOURCE, fa._SOURCE],
             "multihost": [pe._LOOKUP_SOURCE, pe._UPDATE_SOURCE,
                           fa._CHUNK_SOURCE, fa._BWD_SOURCE, fa._SOURCE],
             "fleet": [fa._SOURCE],
             "tpfault": [fa._CHUNK_SOURCE, fa._BWD_SOURCE, fa._SOURCE],
             "moe": [fa._BWD_SOURCE, fa._SOURCE],
             "pipeline": [fa._BWD_SOURCE, fa._SOURCE]}
    logs = _build.build_all(alone.get(args.phase))
    print(f"built {sorted(logs)} in {time.monotonic() - t0:.1f}s",
          flush=True)
    for name, log in logs.items():
        for kernel_name, line in ptxas_lines(log):
            print(f"  {name}: {kernel_name}: {line}", flush=True)

    if args.phase == "bwd":
        bwd_rows, _ = bwd_kernel_phase(torch, fa)
        print(json.dumps({"kernels": bwd_rows}))
        return 0
    if args.phase == "chunk":
        chunk_row, _ = chunk_kernel_phase(torch, fa)
        print(json.dumps({"kernels": [chunk_row]}))
        return 0
    if args.phase == "lookup":
        print(json.dumps({"kernels": lookup_phase(torch, pe)}))
        return 0
    if args.phase in ("checkpoint", "worker", "fleet", "parallel",
                      "multihost", "tpfault", "moe", "pipeline",
                      "failover"):
        with tempfile.TemporaryDirectory() as root:
            if args.phase == "pipeline":
                t1 = time.monotonic()
                line, counts, _ = pipeline_phase(torch, fa, pe, root)
                line = {"pipeline": {**line, "launches": counts}}
                print(json.dumps({"phase_s": {
                    "pipeline": round(time.monotonic() - t1, 2)}}))
            elif args.phase == "moe":
                t1 = time.monotonic()
                line, _ = moe_phase(torch, fa, pe, root, mh)
                line = {"moe": line}
                print(json.dumps({"phase_s": {
                    "moe": round(time.monotonic() - t1, 2)}}))
            elif args.phase == "multihost":
                t1 = time.monotonic()
                line, _ = multihost_phase(torch, fa, pe, root, mh)
                line = {"multihost": line}
                print(json.dumps({"phase_s": {
                    "multihost": round(time.monotonic() - t1, 2)}}))
            elif args.phase == "fleet":
                bundle = os.path.join(root, "v1")
                export_flagship_bundle(torch, bundle)
                line = {"fleet": fleet_phase(torch, fa, pe, root, bundle,
                                             timed=True)}
            elif args.phase == "parallel":
                line = {"parallel": parallel_phase(torch, fa, pe, root)}
            elif args.phase == "tpfault":
                line = {"tpfault": tp_fault_phase(torch, fa, pe, root)}
            elif args.phase == "failover":
                line = {"failover": failover_phase(torch, fa, pe, root)}
            else:
                phase = checkpoint_phase if args.phase == "checkpoint" \
                    else worker_phase
                line = {args.phase: phase(torch, fa, pe, root)}
        print(json.dumps(line))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    marks = {"builds": round(time.monotonic() - t0, 2)}
    last = [time.monotonic()]

    def mark(name):
        """Seconds of the phase that just ended (the smoke's budget)."""
        now = time.monotonic()
        marks[name] = round(now - last[0], 2)
        last[0] = now

    kernel, _ = kernel_phase(torch, fa)
    if args.phase == "fwd":
        print(json.dumps({"kernels": [kernel]}))
        return 0
    bwd_rows, _ = bwd_kernel_phase(torch, fa)
    bwd_autograd_phase(torch, fa)
    chunk_row, _ = chunk_kernel_phase(torch, fa)
    _, ring_times = ring_check_phase(torch, fa, ra)
    zoo_phase(torch, fa)
    mark("kernel_checks")
    emb_checks = embedding_kernel_phase(torch, pe)
    mark("embedding_checks")
    with tempfile.TemporaryDirectory() as root:
        serving = serving_phase(torch, fa, root)
        mark("serving")
        twin_training_phase(torch, fa, root)
        training, counts = training_phase(torch, fa, root)
        mark("training")
        ring_training = ring_training_phase(torch, fa)
        mark("ring_training")
        sparse = sparse_training_phase(torch, pe, root)
        small_twin_phase(torch, pe, root)
        mark("sparse_training")
        host = host_training_phase(torch, fa, pe, root)
        mark("host")
        vision = vision_phase(torch, fa, pe, root)
        mark("vision")
        tabular = tabular_phase(torch, fa, pe, root)
        mark("tabular")
        # While the checkpoint phase's evaluate/predict subprocesses
        # run: the multihost processes set up and train (their results
        # are held to the parallel phase's runs below), and the moe
        # phase's parts and the pipeline phase in this process run.
        moe_local, pipe = {}, {}

        def while_jobs():
            multihost_go(mh, "all")
            moe_local.update(moe_local_parts(torch, fa, pe, root))
            t = time.monotonic()
            (pipe["line"], pipe["launches"],
             pipe["ref"]) = pipeline_phase(torch, fa, pe, root)
            pipe["line"]["phase_s"] = round(time.monotonic() - t, 2)

        checkpoint = checkpoint_phase(torch, fa, pe, root, while_jobs)
        mark("checkpoint")
        # The row service's main boots in a subprocess while the worker
        # phase runs.
        row_service = rowservice_start(root)
        try:
            worker = worker_phase(torch, fa, pe, root)
        except BaseException:
            rowservice_stop(row_service)
            raise
        mark("worker")
        mh_results = mh_wait(mh)
        mark("multihost_wait")
        rowservice = rowservice_phase(torch, fa, pe, root,
                                      service=row_service)
        mark("rowservice")
        fleet = fleet_phase(torch, fa, pe, root, os.path.join(root, "v1"))
        mark("fleet")
        reuse = {}
        parallel = parallel_phase(torch, fa, pe, root, reuse)
        mark("parallel")
        multihost, multihost_counts = multihost_phase(
            torch, fa, pe, root, mh, reuse.pop("recsys"), mh_results,
            reuse.pop("tp"), pipe["ref"])
        mark("multihost")
        moe, moe_counts = moe_phase(torch, fa, pe, root, mh, moe_local,
                                    mh_results)
        mark("moe")
    fused = fused_path_phase(torch, pe)
    sweep, sweep_counts = sweep_phase(torch, pe)
    emb_times = embedding_times(torch, pe)
    mark("fused_sweep_times")
    kernel["launches"] = counts["flash_attention_fwd"]
    kernel["launches_serving"] = serving["flash_launches"]
    for row in bwd_rows:
        row["launches"] = counts[row["name"]]
    chunk_row["launches"] = ring_training["ring"]["launches"][
        "flash_chunk_update"]
    chunk_row["launches_path"] = (f"ring training ({RING_TRAIN_STEPS} "
                                  "train steps, remat)")
    chunk_row["ring_forward_s8192"] = ring_times
    emb_rows = embedding_kernel_rows(
        emb_checks, emb_times,
        {**sparse["launches"],
         "fused_row_update": fused["launches"]["fused_row_update"]},
        sweep_counts, sweep["lookup"])
    for row in [kernel, chunk_row] + bwd_rows + emb_rows:
        row["launches_host_training"] = host["launches_card"][row["name"]]
        row["launches_vision"] = (
            vision["mnist_functional"]["launches_card"][row["name"]]
            + vision["resnet50"]["launches"][row["name"]])
        row["launches_tabular"] = tabular["launches"][row["name"]]
        row["launches_checkpoint"] = {
            run: counts[row["name"]] for run, counts in
            checkpoint["recsys"]["launches"].items()}
        row["launches_worker"] = {
            "in_process": worker["in_process"]["launches_worker"][
                row["name"]],
            "failed_task": worker["failed_task"]["launches"][row["name"]]}
        if worker["failover"]["run"]:
            row["launches_worker"]["failover"] = worker["failover"][
                "launches"][row["name"]]
        row["launches_rowservice"] = {
            "one_shard": rowservice["one_shard"]["launches_service"][
                row["name"]],
            "in_process": rowservice["one_shard"]["launches_in_process"][
                row["name"]],
            "two_shards": rowservice["two_shards"]["launches"][row["name"]],
            "shared": rowservice["subprocess"]["launches"][row["name"]]}
        row["launches_fleet"] = {
            part: counts[row["name"]]
            for part, counts in fleet["launches"].items()}
        row["launches_parallel"] = {
            part: counts[row["name"]]
            for part, counts in parallel["launches"].items()}
        row["launches_multihost"] = {
            part: counts[row["name"]]
            for part, counts in multihost_counts.items()}
        row["launches_moe"] = {
            part: counts[row["name"]]
            for part, counts in moe_counts.items()}
        row["launches_pipeline"] = {
            part: counts[row["name"]]
            for part, counts in pipe["launches"].items()}
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"sparse_training": sparse}))
    print(json.dumps({"ring_training": ring_training}))
    print(json.dumps({"host_training": host}))
    print(json.dumps({"vision": vision}))
    print(json.dumps({"tabular": tabular}))
    print(json.dumps({"checkpoint": checkpoint}))
    print(json.dumps({"worker": worker}))
    print(json.dumps({"rowservice": rowservice}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"multihost": multihost}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"pipeline": pipe["line"]}))
    marks["total"] = round(time.monotonic() - t0, 2)
    marks["aim"] = SMOKE_AIM_S
    print(json.dumps({"phase_s": marks}))
    print(json.dumps({"kernels": [kernel, chunk_row] + bwd_rows
                      + emb_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
