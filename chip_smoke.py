#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (ytklearn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card, as a user would: GBDT online serving
on the fused rung (slice 1), int8 GBDT training (slice 2), `cli train`
with the bf16 histograms and the binned serving rung (slice 3), the
histogram tuning tools with K8, the int8 one-hot histogram (slice 4), the
redesigned bf16/f32 histograms K1 and K3 of `cli train` (slice 5), the
redesigned int8 histograms K2 and K4 of int8 training (slice 6), K8
redesigned on warpgroup tensor cores and K5, wave routing, redesigned
(slice 7), the serving walks K6 and K7 redesigned as (row, tree)-
parallel walks with an ordered fold per row (slice 8), and GOSS, the
sampling rates and EFB in training with bench.py's GBDT cell as the
reference runs it, GOSS on, through scripts/bench_gbdt.py (slice 9), and
the convex stack, `cli train` for linear, multiclass_linear, FM and FFM
with bench.py's FM cell through scripts/bench_fm.py (slice 10; plain
torch, no kernel of the port), and GBDT training from text as the
reference runs it (slice 11, no new kernel): the native C++ parser for
both ingests, softmax with K trees a round, l1 with the approximate LAD
refine, the other losses, the host samplers and continue_train, and
GBST through `cli train` and `cli serve` for every family (slice 12,
plain torch, no new kernel), and the host GBDT engine and resilience
(slice 13, plain torch, no new kernel), and `cli serve` as the reference
runs it by default: hot reload, rollback and pin, AIMD batching, the
prediction cache, 429 with Retry-After and the obs planes (slice 14, no
new kernel), and continual training: `cli retrain` against a model `cli
serve` serves under traffic, `cli predict` and `cli convert` (slice 15,
no new kernel), and the serving fleet: `cli serve --replicas 2` and an
autoscaling `--replicas-min 1 --replicas-max 2` fleet whose replica
processes launch K6 and K7 on the one card (slice 16, no new kernel),
and the profiling plane: `cli train --profile --trace-out`, YTK_PROF=1
`cli serve` and scripts/prof_drill.py on the card (slice 17, no new
kernel), and GBDT across ranks: `cli train gbdt --coordinator` and
`--devices` over NCCL and gloo, and the cross-check against the golden
tree (slice 18, no new kernel). Every phase prints its wall time, and the
run its total.

  1. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions, `nvcc --version` and whether ninja is on PATH;
  2. builds the five kernel libraries (serve/csrc/heap_walk.cu: K6, K7;
     gbdt/csrc/hist.cu: K2, K4; gbdt/csrc/hist_float.cu: K1, K3;
     gbdt/csrc/route.cu: K5; gbdt/csrc/hist_u8.cu: K8) from the checkout,
     one nvcc each, the host text parser (io/csrc/ytk_parse.cpp, g++) and
     the host serving library (serve/csrc/ytk_serve.cpp, g++), all
     started together, and prints each build's time and ptxas' report;
  3. holds K6 against its plain PyTorch version and against the stacked
     rung, and K7 against its plain version on uint8 and uint16 bins of
     the same rows, all on the card, with torch.equal (tolerance: exact)
     at the (trees, depth, rows) of KERNEL_SHAPES (depth 1 to 10, every
     ladder rung, a ragged row tile, T past one 512-tree chunk), on rows
     with NaN, +-inf and values exactly at splits;
  4. writes a seeded 500-tree, depth-6, 28-feature sigmoid model and its
     config, serves it through ModelRegistry + ServeApp on cuda with
     YTK_SERVE_FUSED=1, POSTs 1, 7, 64, 512 and 600 rows plus a burst of 16
     concurrent one-row requests, and holds every score bit-equal to the
     host GBDTPredictor.batch_scores (predictions within rtol 1e-14 of its
     sigmoid); the kernel's launch count is zeroed just before these
     requests and read just after;
  5. times the one-row HTTP p50 latency, then traces 50 more one-row
     requests with torch.profiler for the device's idle share on the
     fused rung, and, per
     ladder rung, holds the kernel against its plain version (torch.equal)
     and times a call of the kernel, its plain version and the stacked
     rung (CUDA events, median of repeats; the call is the kernels line's
     `ms`, as for every kernel) beside the kernel's bound, and the
     kernel's own device time (torch.profiler's events, the median of 50
     launches; the line's `device_ms`);
  6. holds the training kernels K2 (hist_q), K4 (hist_gather_q) and K5
     (route) against their plain PyTorch versions with torch.equal
     (tolerance: exact, the sums are int32) at the shapes listed in
     HIST_SHAPES and GATHER_SHAPES; K1 (hist) and K3 (hist_gather) at bf16
     and f32 at the same shapes (counts exact, g/h within rtol 1e-5 plus
     1e-5 of the largest |sum|: float atomics add in any order); each also
     on a 64-slot wave with a duplicated id and pads, whose two slots must
     get the same sums (K2/K4 exact, K1/K3 at that tolerance); K7
     (binned_walk) with torch.equal on uint8 and uint16 tables at every
     rung of the 500-tree model; then (slice 7) K5 on duplicated valid
     ids (the later slot wins), a duplicated id whose later slot is
     invalid, node ids above 57,344, ids spread past the direct map (the
     sorted lookup, int64 fields), a misaligned pos[1:] with out separate
     and aliased, and int32 bins, each with torch.equal;
  7. trains a seeded Higgs-shaped synthetic (the torch twin of bench.py's
     _gen_gbdt) at full width with bench.py's GBDT configuration on cuda
     (TRAIN_ROWS rows, TRAIN_ROUNDS rounds, hist_precision="int8"), counts
     the kernels' launches over that run only, asserts the train loss
     falls below 0.65 and the test AUC and logloss to the digit
     (INT8_TEST_METRICS), and prints steady trees/s, launches and host
     syncs per tree; then traces two rounds of a second
     run with torch.profiler for the device's idle share;
  8. trains small l2 configurations on cuda and on the CPU and requires
     the trees' integer fields and split values to be equal: int8; int8
     with GOSS (0.2, 0.125) and instance and feature rates 0.8; int8 with
     EFB on an exclusive one-hot block (slice 9); and requires
     prng.uniform over the padded bench rows to be bit-equal on both;
     then (slice 11) the int8 objectives at 2^16 rows, card against CPU
     with the kernels' counts zeroed just before (K2, K4 and K5 must
     launch, K1 and K3 not): softmax K = 7 on Covertype-shaped rows
     (round 0's trees equal, every tree equal to the CPU's engine.grow on
     the card's gradients, masks and key, losses at rtol 1e-4: softmax's
     exp may round apart), l1 with the approximate LAD (every tree and
     leaf equal), and continue_train (3 + 3 rounds of l2: the card's
     resumed text equals its uninterrupted 6-round text byte for byte,
     its trees the CPU's); then (slice 9, its main path) trains bench.py's cell as the reference
     runs it, GOSS (0.2, 0.125) on, at full width in int8 with the counts
     zeroed just before: the kept rows of every tree equal ceil(0.2 n) +
     ceil(0.125 (n - ceil(0.2 n))), K2, K4 and K5 launch, K5 three times a
     wave (fit rows, training rows, test rows), the train loss falls below
     0.65, test AUC and logloss lie inside bench.py's synthetic band with
     the GOSS headroom, and steady trees/s prints beside the GOSS-off
     run's; the GOSS steps (the two stable sorts, the threefry draw, the
     compaction and gather) are timed alone, and two GOSS rounds of a
     second run are traced for the idle share; phase_efb trains 28 dense
     and 300 one-hot columns over 2^20 rows with EFB (two bundles) and
     holds each round's tree against `grow` on the unbundled matrix from
     the same gradients, the bundled K2 and K1 histograms and K5 with the
     members' real lo/hi (int32 and int64) against their plain versions;
     and `python -m ytklearn_tpu_torch.scripts.bench_gbdt` runs once in a
     fresh process, its JSON on a line of its own;
  9. times each training kernel at the full-width shapes (CUDA events,
     median of repeats) beside its bound, its plain version and one
     scatter_add_ call; then the int8 width phase of slice 6: K2 over every
     bench row and K4 at its first fused rung (R = n/64) on waves of N = 1,
     2, 8, 16, 32, 42 and 64 slots, each held against its plain version
     with torch.equal and then timed beside one int32 scatter_add_ and its
     bound, with the plan q_plan took; and the saturating cases: every
     bench row in one node and bin at gq = -127, then +127, and hq = 127,
     K2 at the root wave and a 64-slot wave (q_plan's plan, one chunk,
     red) and K4 over every row gathered, each equal to the known sums;
 10. writes 2^20 + 2^17 Higgs-shaped text lines and runs
     `python -m ytklearn_tpu_torch.cli train gbdt experiment/higgs/
     local_gbdt.conf` with --set overrides (paths, 20 rounds, max_depth 8;
     full width: 28 features, 255 bins and leaves, bf16) in this process,
     and requires 20 trees, the model and its sidecar, launches of K1, K3
     and K5 only, and (slice 11) the native parser, its ingest seconds
     printed beside the Python parser's 34.689 s (PERF.md section 5);
 11. serves that model on the binned rung (YTK_SERVE_BINNED=1, edges from
     its sidecar): 200 one-row requests and one of 512 rows, every score
     bit-equal to the port's CPU binned scorer, with K7's launches counted,
     the one-row p50 and, over 50 more traced requests, the binned rung's
     idle share; then, without the sidecar, thresholds mode bit-equal to
     the host tree walk; times K7 at every ladder rung on that model and
     on the 500-tree model as K6 is timed, each held to its plain version
     first;
 12. trains the bench configuration of step 7 in bf16 (K1, K3, K5),
     prints its trees/s beside the figure PERF.md records for the kernels
     before their redesign, and times K1 and K3 at its shapes; then, the
     width phase of slice 5, K1 over every bench row and K3 at the first
     fused rung (R = n/64) on waves of N = 1, 2, 8, 16, 32, 42 and 64
     slots, each held against its plain version (counts exact, g/h at
     HIST_RTOL) and then timed beside one scatter_add_ and its bound;
     then a small l2 bf16 run twice on the card and once on the CPU,
     printing whether the card's trees repeat; and (slice 9) the bench
     cell in bf16 with GOSS on at GOSS_BF16_ROUNDS trees (K1, K3 and K5
     on the fit matrix); then (slice 11, its main path) `cli train gbdt`
     with softmax, class_num 7, on 2^19 + 2^16 Covertype-shaped text
     lines (54 features: 10 integer measurements, one-hot groups of 4 and
     40; scripts/covertype_synth.py) with the Higgs config's trees, 10
     rounds = 70 trees, the counts zeroed just before: rc 0, 70 trees, the
     native parser, K1, K3 and K5 launched (K2 and K4 not), each held
     at every shape that run launched it, on the run's own inputs (a
     ShapeRecorder; K1 and K3 over the EFB-bundled columns to the float64
     sums of the same values at HIST_RTOL, counts exact and equal to
     their plain versions', whose f32 error is printed beside; K5 to its
     plain version with torch.equal, in place too, with the bundles'
     member ranges; the recorded calls equal to the launch counts), the
     dumped model's stacked-rung scores of every test row bit-equal to
     predict/trees.py's host walk on the first 2048, and test accuracy
     above SOFTMAX_ACC_FLOOR;
 13. holds K8 (hist_q_u8) against its plain version with torch.equal at
     N = 1, 7, 32 and 64 slots (F = 28, B = 256, a ragged n) and on waves
     of 64 and 100 slots (3N > 256: two n-tiles) with a duplicated id and
     pads, and against K2 in K8's layout;
 14. runs the tuning tools in this process, the main path of slice 4:
     tune_hist_kernel at the reference's size with its full variant list
     (K2, K1 and K8 across launch shapes, then K8 == K2 with torch.equal;
     K8's launches are counted over this run), micro_hist_gather at two
     budgets (K4 == gather-then-K2, exact) and tune_gbdt cut to waves 32
     and 64 in int8 at 2^21 rows and 6 trees;
 15. times K8 at the tune shape beside its bytes bound, its tensor-core
     floor (mma_floor_ms), its plain version and one scatter_add_, then K8
     and K2 on waves of 1 to 64 slots that hold every row;
 16. (slice 10, its main path) writes seeded synthetic text files
     (CONVEX_DATA: 2^16 lines for linear and FM, 2^15 for multiclass and
     FFM) and runs `cli train` in this process for each of CONVEX_RUNS on
     the card and on the CPU: linear with L1 (OWL-QN), linear grid,
     multiclass_linear softmax K = 5, FM k = [1, 8], FFM over 8 fields,
     linear HOAG, each parsed by the native parser (slice 11); each card
     run has the CPU run's status and iterations,
     its first 5 iterations' and final avg loss at rtol 1e-4 and test AUC
     within 1e-4, and prints ingest seconds against training seconds; no
     kernel wrapper's launch count moves; then scripts/bench_fm.py's cell
     at its default size (2,000,000 rows, dim 2^18, rank 8): examples/s,
     loss, peak memory, the idle share and top device ops of two traced
     L-BFGS iterations, the loss falling over accepted iterations, and
     whether two trainings dump byte-identical texts;
 17. (slice 12, its main path) keeps those convex models, writes the FM
     case's data again at 2^16 + 2^13 and 2^15 + 2^12 lines and runs
     `cli train` in this process for each of GBST_RUNS (gbmlr K = 8, 2
     trees; gbsdt, gbhmlr, gbhsdt K = 8, 2 trees; a random_forest run; a
     continue_train run, 2 + 1 trees; lr 0.3, rates 0.8) at GBST_ITERS
     L-BFGS iterations a tree on the card: trees, seconds a tree, ingest
     against training, test AUC above 0.6; then each again at
     GBST_HELD_ITERS on the card and the CPU,
     held together (statuses and iterations equal, losses at rtol 1e-4,
     AUC within 1e-4); then serves linear, multiclass_linear, FM, FFM,
     gbmlr and gbhsdt on cuda (ModelRegistry + ServeApp, what `cli serve`
     starts) at f64 and bf16: 200 one-row requests (p50, p99) and one of
     64 rows, f64 scores at rtol 1e-10 of the host predictor, bf16
     predictions inside the 0.1 band; then one `cli serve` process for
     gbmlr answers 64 rows and drains on SIGTERM; no kernel wrapper's
     launch count moves on either phase;
 18. (slice 13, its main path) after the binned serving phases, trains
     the host engine through `cli train gbdt` in this process over the
     same 2^20 + 2^17 text lines (HOST_RUNS: level-wise sigmoid with
     `tree_maker = "feature"`, 20 trees, train loss below 0.65 and test
     AUC above HOST_AUC_FLOOR, bench.py's band printed; loss-wise l1 with
     `lad_refine_appr = false`, 3 trees, the loss falling every round):
     seconds and host syncs a tree, ingest and host binning against the
     rounds; then both at HOST_SMALL lines on cuda twice and on the CPU,
     whose dumps must be byte-identical; no kernel wrapper's count moves.
     Then the chaos drill (`phase_resilience`): the device engine at 2^19
     Higgs rows and 20 rounds, int8 and bf16, SIGTERM at the RES_CUT-th
     loss read (exit 143 at the next round start) and continue_train
     (int8 byte-identical to the uninterrupted run, bf16 completing with
     its node values apart counted); the host engine's kill -9 (chaos
     kind `kill` at round 1's first dump commit) in a `cli train`
     subprocess, exit 137, then `--resume auto` byte-identical;
     `io.read:oserror:0.3:1` over the native ingest (faults retried, no
     give-up, the dataset equal); FM and gbmlr SIGTERM at their first
     dump (exit 143) then `--resume auto` (rc 0); `--max-restarts 1`
     after one injected `error` at a dump commit, ending byte-identical;
 19. (slice 14, its main path) right after the binned serving phase,
     `phase_serve_ops`: `python -m ytklearn_tpu_torch.cli serve` as a
     subprocess at the reference's defaults (AIMD at 100 ms, quality
     sampling 0.05, the SLO burn sentinel) with `--watch-interval 0.5`,
     YTK_TRACE_SAMPLE=0.05 and YTK_OBS=1 (the counters are no-ops
     without it, in both packages), serving phase_slice's 500-tree model
     and, as `--extra-model binned`, the model `cli train` wrote with its
     `.sketch.json`, both on the fused rung; 8 clients of 1-64-row
     requests for SERVE_OPS_SECONDS, the fused model's text replaced
     atomically by a second 500-tree model after SERVE_OPS_SWAP_S; every
     response bit-equal to the host GBDTPredictor of the version it
     names, no failed request, only v2 after v2 first answered;
     /admin/rollback (v1, pinned), again (v2), /admin/unpin, a 404 for an
     unknown name; /metrics (serve.reload >= 1, serve.rollback = 2, the
     AIMD block, per-model requests summing to serve.requests, a PSI for
     the `cli train` model, and K6's launches as serve.scorer.batches,
     held to the batches, requests and rows served); /admin/traces
     non-empty; SIGTERM drains, exit 0; client-clock p50/p99 and the
     reload's warm_ms from the server's log. The rung is one process-wide
     knob, so a second `cli serve` (YTK_SERVE_BINNED=1) serves a copy of
     the `cli train` model on K7: its text rewritten with new leaf values
     (v2, thresholds: the sidecar names the old text), then its bin-edge
     sidecar with the new text's digest (v3, edges), each a hot reload;
     every response bit-equal to the binned rung's plain version of its
     files, K7's launches from /metrics as above, exit 0 on SIGTERM. Then
     in this process both rungs side by side (K6 and K7), both registries
     built before any count is read: a 4096-row cache answers a repeat
     bit-identically with `cached: true` (one K7 launch for the cold
     request, none for the repeat), and max_queue 4 sheds a flood with
     429s whose Retry-After is an integer, the flood launching both;
 20. (slice 15, its main path) right after phase_serve_ops,
     `phase_continual`: a `cli serve` process (fused rung, K6,
     --watch-interval 0.5) serves a copy of the `cli train` model under 8
     paced clients of 1-64 held-out rows; in this process `cli retrain
     gbdt` on 2^20 fresh Higgs-shaped lines of a new seed (written by 8
     spawned processes) with a 2^17-line held-out file and 10 extra
     rounds promotes v2 (rc 0, `.version.json`, the archive `.v1`), its
     candidate launching K1, K3 and K5 (K2, K4 not) at least once a new
     tree and its gate K6 once a scored batch (2 x 2^17 / 512), no scorer
     fallback; a candidate on 2^17 label-flipped lines is rejected by the
     band (exit 1 under YTK_CONTINUAL_STRICT=1); `cli retrain --rollback`
     restores v1. Every response is bit-equal to the host walk of one
     model version (one a server version), none fails, v2 answers within
     10 watch periods of its promotion, the rejection leaves v2 serving
     and the rollback v1. Card against CPU, while the server starts: an
     int8 retrain (2^14 lines, 3 + 2 rounds) whose dumps are
     byte-identical; `retrain linear --mode ftrl` on the convex phase's
     2^17 lines, bootstrap then warm, twice on the card (bit-equal) and
     the bootstrap on the CPU (weights at rtol 1e-5 plus 1e-5 of the
     largest |w|); `cli predict gbdt` of the incumbent over 4096 held-out
     lines (raw scores bit-equal to the host walk, predictions at rtol
     1e-14 of the CPU's, leaf ids equal); `cli convert` of a libsvm
     file, then `cli train` on it;
 21. (slice 16, its main path) right after phase_continual,
     `phase_fleet` on the `cli train` model: the native host library
     (serve/csrc/ytk_serve.cpp, built with the kernels in step 2) holds
     `bin_rows`' native entry bit-equal to its numpy loop on the served
     rows and `native_binned_scores` bit-equal to K7 on the card on the
     same bins; then `python -m ytklearn_tpu_torch.cli serve --replicas
     2` on cuda (fused rung, K6 in each replica process) under 8 clients
     of 1-64 rows: each replica's K6 launches from its own /metrics held
     to the rows the front's answers say it scored, then under traffic a
     kill -9 of replica 0 (restarted by the front), a hot reload to v2
     seen by both replicas and a fleet-wide /admin/rollback to v1; every
     response bit-equal to the host walk of its version, none fails, the
     front's flight dump at SIGTERM names the death and the restart;
     then `cli serve --replicas-min 1 --replicas-max 2` on the binned
     rung (K7, native binning) under 16 clients of 64 rows grows to 2
     and, idle, drains back to 1 (SCALE_KNOBS), each replica's K7
     launches from its own /metrics, every response bit-equal to the
     binned rung's CPU version, never above 2 slots; prints the `fleet`
     line (client p50/p99 at 1 and 2 replicas, spawn to ready, the
     restart, the grow and the drain);
 22. (slice 17, its main path) right after phase_fleet, `phase_profile`
     on phase_cli_train's config and the head of its text (2^19 + 2^16
     lines): `cli train gbdt --profile DIR
     --trace-out T` in this process (the report: each phase's wall and
     the coverage of the run, at least 0.9; the kernel table of the
     gbdt.train capture with device ms, whose K1, K3 and K5 rows count
     exactly their wrappers' launches; the build ledger; each phase's
     memory peak; the device's busy share over gbdt.train; a capture
     with no device event fails), the same training without the flags
     and with `--profile` alone (the rounds' wall of the three: the
     plane's overhead, with and without a capture), a `YTK_PROF=1 cli
     serve` process on the fused rung under requests at every ladder
     rung (/metrics?prof=1: every rung filled, its rows the rows sent, a
     load of K6's library and K6's instantiation in the ledger, no
     unexpected retrace), a fresh process whose armed fused scorer sees
     a binned scorer's first K7 launch (health.retrace naming the
     culprit program and kernel), and scripts/prof_drill.py on the card
     (every check hard; the ledger holds the loads of the parser's and
     the kernels' libraries and the kernels' instantiations);
 22b. (slice 23, its main path) right after phase_profile,
     `phase_serving`: the port's scripts/serve_bench.py at 500 trees,
     depth 6 (the rung matrix: the score() loop, the stacked, fused (K6)
     and binned (K7) rungs, each bit-identical to the host walk, none
     downgraded, no build after warmup, the binned and bf16 bands, the
     tracing, quality and transform arms, a binned fleet of 2), then at
     once `--fleet --replicas 2` (its floor against the same run's
     single-process stacked rung), `--ramp --replicas 3` and the trace,
     drift and mesh drills, each process's every correctness field held
     and each speed floor printed beside its value and the card;
 23. (slice 18, its main path) right after phase_serving, `phase_dist`
     on the same config and text at DIST_ROUNDS int8 trees: the one-rank
     `cli train gbdt` in this process, then as subprocesses `--coordinator`
     at world size 1 (NCCL; model and bin sidecar byte-identical to one
     rank), `--devices 2 --rank-devices cuda:0,cuda:0` (two ranks sharing
     the card over gloo, bins built once by the launcher; the int8 dump
     byte-identical to one rank) and two `--coordinator` processes on
     cuda:0 over gloo started by the port's cluster launcher (each its
     lines_avg shard; both ranks' lines labelled in its master log; rank
     0's train loss within DIST_LOSS_RTOL of one process, its model scored
     by `cli predict`); every rank launches K2 and K5 and
     merges histograms (psum_scatter, pargmax), and prints its backend,
     seconds, K2/K4/K5 launches and collective census; then
     scripts/cross_check.py's card arm (full scan K2, partitioned, fused
     K4) equal to the JAX package's golden tree; then `tree_maker =
     "feature"` on `--devices 2` sharing the card (the columns sharded,
     K1 at f32 on each rank) against one rank's level-wise host engine on
     2^17 + 2^14 of the lines, loss and test AUC within DIST_FP_RTOL;
 24. (slice 19, its main path) right after phase_dist,
     `phase_dist_convex`: `cli train linear` and `cli train fm` at the FM
     cell's width (38 features and the bias, dim about 2^18, rank 8) and
     gbmlr on one rank in this process, while, as subprocesses, each runs
     under `--coordinator` at world size 1 (NCCL; dumps byte-identical to
     one rank), on `--devices 2` with both ranks on cuda:0 over gloo (the
     one-rank iterations and status, losses at rtol 1e-4, test AUC within
     1e-4; gbmlr at GBST_HELD_ITERS), and linear as two `--coordinator`
     processes on their lines_avg shards (within rel 1e-3 of one); then
     `cli retrain gbdt` (int8) of phase_cli_train's text cut to 2^17 +
     2^14 lines on one device and with the candidate on two ranks sharing
     the card: each rank launches K2 and K5, the gate K6, and the two
     candidates are the same bytes; each part prints its seconds, backend
     and collective census;
 25. (slice 21, after phase_repro) `phase_deep_tree`: one l2 tree of
     DEEP_LEAVES = 30,000 leaves (59,999 nodes, past the 57,344 whose node
     lookup fits shared memory at 256 bins, so K1-K4 take the global
     lookup kind) over 2^17 Higgs-shaped rows, int8 and bf16 on the card
     and on the CPU (two spawned processes of REF_CPU_THREADS threads,
     started after phase_serving with the wide-bin runs' CPU
     references): the
     int8 dumps byte-identical, bf16 train losses within OBJ_RTOL, every
     K1-K4 call of the card runs (the first at each shape) held to its
     plain version; K1-K4 timed in both lookup kinds at the trainer's
     64-slot wave; the int8 model through one `cli serve` process with
     YTK_SERVE_FUSED=1: fused refused (depth past the heap cap), stacked
     scores bit-equal to the host walk;
 26. prints the `kernels` JSON line (eight kernels; K6 and K7 also carry
     `device_ms` and `serve_bench_launches`, the launches of
     phase_serving's rung matrix; K2, K4 and K5's launches from the GOSS bench cell; K1-K4
     also `deep_launches`, `ms_shared_lookup` and `ms_global_lookup` from
     slice 21's deep tree), the card line, and last the result line
     {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero without the result line;
without a CUDA device it exits 2 before importing the port.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

SEED = 20261016
T_START = time.perf_counter()
N_FEATURES = 28  # the Higgs width (experiment/higgs/local_gbdt.conf)
N_TREES = 500  # scripts/serve_bench.py's GBDT serving width
DEPTH = 6
LADDER = (1, 8, 64, 512)  # the default serving ladder
#: (trees, depth, rows) of the walk checks: depth 1 to 10, every ladder
#: rung and a ragged row tile, and T past one of the kernels' tree chunks
#: (512 trees)
KERNEL_SHAPES = ((13, 1, 1), (64, 10, 512), (500, 6, 1), (500, 6, 512),
                 (40, 10, 8), (600, 6, 1), (600, 6, 513), (1100, 4, 64),
                 (300, 8, 513))
#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
#: FP64 rate outside the tensor cores that the walk's compares and adds use
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sh(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout + out.stderr).strip()


# -- model and rows -----------------------------------------------------------


def random_rows(rng, n, names, splits):
    """Feature dicts with gaps (missing -> NaN), +-inf, values exactly at
    split thresholds, and the odd unknown feature."""
    rows = []
    for _ in range(n):
        row = {}
        for nm in names:
            r = rng.rand()
            if r < 0.15:
                continue
            if r < 0.18:
                row[nm] = float("inf")
            elif r < 0.21:
                row[nm] = float("-inf")
            elif r < 0.35:
                row[nm] = float(splits[rng.randint(len(splits))])
            else:
                row[nm] = float(rng.randn())
        if rng.rand() < 0.1:
            row["unknown_feature"] = 1.0
        rows.append(row)
    return rows


def write_model(tmp, model, name):
    """The model file and its serving config; round_num above every
    model's tree count, so the scorer serves the whole ensemble."""
    path = os.path.join(tmp, f"{name}.model")
    with open(path, "w") as f:
        f.write(model.dumps())
    conf = os.path.join(tmp, f"{name}.conf")
    with open(conf, "w") as f:
        f.write(f'model {{ data_path = "{path}" }}\n'
                "optimization { loss_function = sigmoid, "
                "round_num = 100000 }\n")
    return conf


def split_values(model):
    return [t.split[i] for t in model.trees for i in range(t.n_nodes())
            if not t.is_leaf(i)]


# -- timing -------------------------------------------------------------------


def cuda_ms(fn, iters, repeats=7):
    """Median over `repeats` of the mean per-call time of `iters` calls,
    from CUDA events around the run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def walk_bound_ms(X, ht):
    """Least time for one walk of these rows, the larger of: the bytes the
    walk must move over HBM bandwidth, and its compares and adds over the
    FP64 rate. The bytes are what this run's data needs, each read once:
    the X elements some row looks up, each heap slot's feat id where some
    row visits it, its split where a visiting row has a value, its dleft
    where a visiting row has NaN, each leaf some row reaches; the scores
    are written once. The visited sets come from replaying the walk on the
    same inputs (the last heap level is read only as leaves)."""
    import torch

    from ytklearn_tpu_torch.serve.kernels import unpack_records

    B, F = X.shape
    feat, split, dleft = unpack_records(ht.nodes)
    T, H = feat.shape
    LL = ht.leaf.shape[1]
    rows = torch.arange(B, device=X.device)[:, None]
    tids = torch.arange(T, device=X.device)[None, :]
    pos = torch.zeros((B, T), dtype=torch.long, device=X.device)
    slots, split_at, dleft_at, cells = [], [], [], []
    for _ in range(ht.depth):
        f = feat[tids, pos].long()
        v = X[rows, f]
        nan = torch.isnan(v)
        slot = tids * H + pos
        slots.append(slot.flatten())
        split_at.append(slot[~nan])
        dleft_at.append(slot[nan])
        cells.append((rows * F + f).flatten())
        go_left = torch.where(nan, dleft[tids, pos] > 0,
                              v <= split[tids, pos])
        pos = 2 * pos + 2 - go_left.long()

    def distinct(parts):
        return int(torch.unique(torch.cat(parts)).numel())

    nbytes = (distinct(cells) * 8 + distinct(slots) * 4
              + distinct(split_at) * 8 + distinct(dleft_at) * 4
              + distinct([(tids * LL + pos - (LL - 1)).flatten()]) * 8
              + B * 8)
    ops = B * T * (ht.depth + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- HTTP ---------------------------------------------------------------------


def post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        check(resp.status == 200, f"/predict answered {resp.status}")
        return json.loads(resp.read())


def fmt_top(top, width):
    return ", ".join(f"{e.key[:width]} {e.self_device_time_total / 1e3:.3f} "
                     f"ms x{e.count}" for e in top)


def profile_requests(port, rows, card, rung):
    """A separate traced run of one-row requests on a serving rung: device
    busy time (CUDA kernels and copies, from torch.profiler) against the
    client's wall time gives the device's idle share while serving."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ytklearn_tpu_torch.scripts._common import device_busy

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for row in rows:
            post(port, {"features": row})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_busy(prof, 4)
    check(busy_ms > 0, "the profiler saw no device time")
    print(f"profile: {rung} rung, {len(rows)} one-row requests (traced), wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; top device ops: {fmt_top(top, 40)} "
          f"[{card}]", flush=True)


# -- phases -------------------------------------------------------------------


def k7_tables(model, vocab, heap):
    """K7's two bin widths for a model: edges spanning its split values in
    200 steps a feature (uint8) and in 400 (uint16)."""
    import numpy as np

    from ytklearn_tpu_torch.serve import kernels

    sv = split_values(model)
    out = []
    for steps, sentinel in ((200, 255), (400, 65535)):
        edges = {n: np.linspace(min(sv) - 1.0, max(sv) + 1.0, steps)
                 for n in vocab}
        table, why = kernels.build_bin_table(model.trees, vocab, edges)
        check(table is not None and table.sentinel == sentinel, why)
        out.append(table)
    return out


def phase_kernel(tmp, card):
    """K6 against its plain version and the stacked rung, and K7 against
    its plain version on uint8 and uint16 bins of the same rows, on the
    card at KERNEL_SHAPES. Returns the largest |kernel - plain| of each."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.scripts.time_walk import random_model
    from ytklearn_tpu_torch.serve import CompiledScorer, kernels

    names = [f"f{i}" for i in range(N_FEATURES)]
    max_err = k7_err = 0.0
    for T, depth, B in KERNEL_SHAPES:
        rng = np.random.RandomState(SEED + T * 16 + depth)
        model = random_model(rng, T, depth, names, base=0.0)
        conf = write_model(tmp, model, f"k{T}_{depth}")
        pred = create_predictor("gbdt", conf)
        fused = CompiledScorer(pred, ladder=(B,), mode="fused",
                               device="cuda", warmup=False)
        stacked = CompiledScorer(pred, ladder=(B,), mode="stacked",
                                 device="cuda", warmup=False)
        check(fused.rung_info()["backend"] == "fused-cuda",
              f"fused rung not on the kernel: {fused.rung_info()}")
        rows = random_rows(rng, B, names, split_values(model))
        X = torch.from_numpy(fused.featurize(rows)).cuda()
        heap, why = kernels.build_heap(model.trees, fused.vocab)
        check(heap is not None, why)
        ht = kernels.heap_from_numpy(heap.feat, heap.split, heap.dleft,
                                     heap.leaf, heap.depth, heap.n_trees,
                                     "cuda")
        k = kernels.heap_walk(X, ht.nodes, ht.leaf, ht.depth,
                              max_feat=ht.max_feat)
        torch.cuda.synchronize()
        p = kernels.heap_walk_plain(X, *kernels.unpack_records(ht.nodes),
                                    ht.leaf, ht.depth)
        s_stacked, _ = stacked.score_tensor(X)
        s_fused, _ = fused.score_tensor(X)
        torch.cuda.synchronize()
        err = float((k - p).abs().max()) if B else 0.0
        max_err = max(max_err, err)
        ok = (torch.equal(k, p) and torch.equal(k + 0.0, s_stacked)
              and torch.equal(s_fused, s_stacked))
        print(f"kernel check T={T} (padded {heap.feat.shape[0]}) "
              f"depth={depth} B={B}, tolerance exact (torch.equal): "
              f"kernel==plain {torch.equal(k, p)}, "
              f"kernel==stacked {torch.equal(k + 0.0, s_stacked)}, "
              f"fused rung==stacked rung {torch.equal(s_fused, s_stacked)}, "
              f"max_abs_err {err} [{card}]", flush=True)
        check(ok, f"heap walk disagrees at T={T} depth={depth} B={B}")
        Xh = fused.featurize(rows)
        for table in k7_tables(model, fused.vocab, heap):
            bins, packed, leaf = binned_inputs(heap, table, Xh)
            kb = kernels.binned_walk(bins, packed, leaf, heap.depth,
                                     table.sentinel,
                                     max_feat=int(heap.feat.max()))
            pb = kernels.binned_walk_plain(bins, packed, leaf, heap.depth,
                                           table.sentinel)
            torch.cuda.synchronize()
            err = float((kb - pb).abs().max()) if B else 0.0
            k7_err = max(k7_err, err)
            print(f"kernel check binned_walk T={T} depth={depth} B={B} "
                  f"{table.dtype} bins, tolerance exact (torch.equal): "
                  f"{torch.equal(kb, pb)}, max_abs_err {err} [{card}]",
                  flush=True)
            check(torch.equal(kb, pb), f"binned walk disagrees at T={T} "
                  f"depth={depth} B={B} ({table.dtype})")
    return max_err, k7_err


def phase_slice(tmp, card):
    """The served 500-tree model on the fused CUDA rung, end to end."""
    import numpy as np

    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.scripts.time_walk import random_model
    from ytklearn_tpu_torch.serve import (
        BatchPolicy,
        ModelRegistry,
        ServeApp,
        kernels,
    )

    names = [f"f{i}" for i in range(N_FEATURES)]
    rng = np.random.RandomState(SEED)
    model = random_model(rng, N_TREES, DEPTH, names, base=0.1234)
    conf = write_model(tmp, model, "slice")
    os.environ["YTK_SERVE_FUSED"] = "1"
    t0 = time.perf_counter()
    registry = ModelRegistry(device="cuda")  # default ladder 1/8/64/512
    entry = registry.load("default", "gbdt", hocon.load(conf))
    load_s = time.perf_counter() - t0
    info = entry.scorer.rung_info()
    print(f"slice: loaded {N_TREES} trees depth {DEPTH} x {N_FEATURES} "
          f"features in {load_s:.3f} s, rung {json.dumps(info)} [{card}]",
          flush=True)
    check(info["mode"] == "fused" and info["backend"] == "fused-cuda",
          f"not serving on the fused CUDA rung: {info}")
    check(entry.scorer.ladder == LADDER, f"ladder {entry.scorer.ladder}")
    app = ServeApp(registry, BatchPolicy(max_batch=512, max_wait_ms=2.0),
                   host="127.0.0.1", port=0).start()
    host_pred = entry.predictor
    splits = split_values(model)
    n_checked = 0
    try:
        kernels.heap_walk.launches = 0  # count the main path's launches only
        for n in (1, 7, 64, 512, 600):
            rows = random_rows(rng, n, names, splits)
            out = post(app.port, {"rows": rows})
            want = host_pred.batch_scores(rows)
            check(np.array_equal(np.asarray(out["scores"]), want),
                  f"{n}-row response differs from the host tree walk")
            preds = np.asarray(out["predictions"])
            check(preds.shape == (n,) and np.all(np.isfinite(preds))
                  and np.allclose(preds, host_pred.batch_predicts(rows),
                                  rtol=1e-14, atol=0),
                  f"{n}-row predictions are off the host sigmoid "
                  "(rtol 1e-14)")
            n_checked += n
        burst = random_rows(rng, 16, names, splits)
        results = [None] * len(burst)

        def one(i):
            results[i] = post(app.port, {"features": burst[i]})

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(burst))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            check(not t.is_alive(), "burst request hung")
        want = host_pred.batch_scores(burst)
        for i, out in enumerate(results):
            check(out is not None and out["scores"] == [want[i]],
                  f"burst request {i} differs from the host tree walk")
        n_checked += len(burst)
        launches = kernels.heap_walk.launches
        print(f"slice: {n_checked} rows in 21 requests, every score "
              f"bit-equal to the host GBDTPredictor.batch_scores; heap_walk "
              f"launches {launches} [{card}]", flush=True)
        check(launches > 0, "the main path launched no heap_walk kernel")

        lat = []
        one_row = random_rows(rng, 200, names, splits)
        for row in one_row:
            t0 = time.perf_counter()
            post(app.port, {"features": row})
            lat.append((time.perf_counter() - t0) * 1e3)
        p50 = statistics.median(lat)
        print(f"timing: HTTP /predict one-row p50 {p50:.4f} ms over "
              f"{len(lat)} sequential requests (client clock) [{card}]",
              flush=True)
        profile_requests(app.port, random_rows(rng, 50, names, splits), card,
                         "fused")
    finally:
        app.stop(drain=True, timeout=30.0)
    return launches, model, p50


def fmt_kernel(device_ms):
    """A walk kernel's own time, or why it was not measured."""
    from ytklearn_tpu_torch.scripts.time_walk import TRACE_EMPTY

    return TRACE_EMPTY if device_ms is None else f"{device_ms:.6f} ms"


def phase_timings(model, card):
    """Per rung: kernel, plain walk and stacked rung on the card. A call's
    time is CUDA events around 50 calls back to back, as every kernel's
    `ms` (at a few microseconds of kernel the wrapper's host work sets
    it); the kernel's own time beside it is the median of the profiler's
    device events over 50 launches (time_walk.kernel_ms)."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.scripts.time_walk import kernel_ms
    from ytklearn_tpu_torch.serve import CompiledScorer, kernels

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_t_")
    try:
        conf = write_model(tmp, model, "timing")
        pred = create_predictor("gbdt", conf)
        fused = CompiledScorer(pred, ladder=LADDER, mode="fused",
                               device="cuda", warmup=False)
        stacked = CompiledScorer(pred, ladder=LADDER, mode="stacked",
                                 device="cuda", warmup=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    heap, _ = kernels.build_heap(model.trees, fused.vocab)
    ht = kernels.heap_from_numpy(heap.feat, heap.split, heap.dleft,
                                 heap.leaf, heap.depth, heap.n_trees, "cuda")
    names = sorted(fused.vocab)
    rng = np.random.RandomState(SEED + 1)
    out = {}
    max_err = 0.0
    for B in LADDER:
        rows = random_rows(rng, B, names, split_values(model))
        X = torch.from_numpy(fused.featurize(rows)).cuda()
        plain = (X, *kernels.unpack_records(ht.nodes), ht.leaf, ht.depth)

        def k6():
            return kernels.heap_walk(X, ht.nodes, ht.leaf, ht.depth,
                                     max_feat=ht.max_feat)

        k = k6()
        p = kernels.heap_walk_plain(*plain)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        max_err = max(max_err, err)
        print(f"kernel check rung {B}, tolerance exact (torch.equal): "
              f"kernel==plain {torch.equal(k, p)}, max_abs_err {err} "
              f"[{card}]", flush=True)
        check(torch.equal(k, p), f"heap walk disagrees at rung {B}")
        ms = cuda_ms(k6, iters=50)
        device_ms = kernel_ms(torch.device("cuda"), k6, 50)
        plain_ms = cuda_ms(lambda: kernels.heap_walk_plain(*plain), iters=3,
                           repeats=5)
        stacked_ms = cuda_ms(lambda: stacked.score_tensor(X), iters=3,
                             repeats=5)
        fused_ms = cuda_ms(lambda: fused.score_tensor(X), iters=20)
        bound_ms, bound_by = walk_bound_ms(X, ht)
        out[B] = (ms, plain_ms, bound_ms, bound_by, device_ms)
        print(f"timing: rung {B} ({ht.nodes.shape[0]} padded trees, depth "
              f"{ht.depth}): heap_walk a call {ms:.6f} ms, kernel "
              f"{fmt_kernel(device_ms)} (device), plain walk "
              f"{plain_ms:.6f} ms, stacked rung {stacked_ms:.6f} ms, fused "
              f"rung with sigmoid {fused_ms:.6f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}) [{card}]", flush=True)
    return out, max_err


# -- training slice ------------------------------------------------------------

#: bench.py's GBDT cell at its own size: 10,500,000 train rows, 500,000
#: test rows and 40 trees on the synthetic (bench.py:306-317)
TRAIN_ROWS = 10_500_000
TEST_ROWS = 500_000
TRAIN_ROUNDS = 40
#: bench.py's GOSS default (bench.py:286), and the trees of the bf16 run
GOSS = (0.2, 0.125)
GOSS_BF16_ROUNDS = 12
#: phase_efb's sparse width: rows, one-hot columns beside the 28 dense
#: ones, trees
EFB_ROWS = 1 << 20
EFB_ONEHOT = 300
EFB_ROUNDS = 6
REPO = os.path.dirname(os.path.abspath(__file__))
#: (F, n, B, N, bins dtype) for K2; (R, dead share) for K4; NW for K5
HIST_SHAPES = ((28, 65536, 256, 1, "u8"), (28, 65536, 256, 64, "u8"),
               (5, 49152, 16, 7, "i32"))
GATHER_SHAPES = (1024, 262144)
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA-core rate (int32 adds bound below it)


def kernel_counts():
    from ytklearn_tpu_torch.gbdt import engine, hist, route
    from ytklearn_tpu_torch.serve import kernels

    return {"hist": hist.hist_wave.launches,
            "hist_gather": hist.hist_wave_gather_mxu.launches,
            "hist_q": hist.hist_wave_q.launches,
            "hist_gather_q": hist.hist_wave_gather.launches,
            "route": route.route_wave.launches,
            "binned_walk": kernels.binned_walk.launches,
            "hist_q_u8": hist.hist_q_u8.launches,
            "host_syncs": engine.grow.host_syncs}


def zero_kernel_counts():
    from ytklearn_tpu_torch.gbdt import engine, hist, route
    from ytklearn_tpu_torch.serve import kernels

    hist.hist_wave.launches = 0
    hist.hist_wave_gather_mxu.launches = 0
    hist.hist_wave_q.launches = 0
    hist.hist_wave_gather.launches = 0
    route.route_wave.launches = 0
    kernels.binned_walk.launches = 0
    hist.hist_q_u8.launches = 0
    engine.grow.host_syncs = 0


#: the histogram kernels each precision runs (full scan, gather)
PRECISION_KERNELS = {"int8": ("hist_q", "hist_gather_q"),
                     "bf16": ("hist", "hist_gather"),
                     "f32": ("hist", "hist_gather")}


def rand_hist_inputs(gen, F, n, B, N, dtype, M=None):
    """Bins, positions over 2N+1 nodes (a tenth dead), quantized grads at
    +-127 and N wave ids (a quarter -2 pads when N > 2), on the card."""
    import torch

    M = M or 2 * N + 1
    bins = torch.randint(0, B, (F, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    bins = bins.to(torch.uint8) if dtype == "u8" else bins
    pos = torch.randint(0, M, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[torch.rand((n,), generator=gen, device="cuda") < 0.1] = -1
    gq = torch.randint(-127, 128, (n,), generator=gen, device="cuda").float()
    hq = torch.randint(0, 128, (n,), generator=gen, device="cuda").float()
    gq[:2] = torch.tensor([127.0, -127.0], device="cuda")
    ids = torch.randperm(M, generator=gen, device="cuda")[:N].to(torch.int32)
    if N > 2:
        ids[torch.rand((N,), generator=gen, device="cuda") < 0.25] = -2
    return bins, pos, gq, hq, ids, M


def compacted(pos, gq, hq, ids, R, dead_share, gen):
    """The engine's compaction of a wave's rows into R slots, with a share
    of dead slots (pos_g = -1) at the end."""
    import torch

    from ytklearn_tpu_torch.gbdt.hist import compact_indices

    member = torch.isin(pos, ids[ids >= 0])
    keep = int(R * (1 - dead_share))
    rows = torch.nonzero(member).flatten()
    rows = rows[torch.randperm(len(rows), generator=gen, device="cuda")[
        :keep]].sort().values
    mask = torch.zeros_like(member)
    mask[rows] = True
    idx, cnt = compact_indices(mask, R)
    valid = torch.arange(R, device="cuda") < cnt
    li = idx.long()
    pg = torch.where(valid, pos[li], -1).to(torch.int32)
    return idx, pg, gq[li].contiguous(), hq[li].contiguous()


def dup_ids(ids):
    """The wave's ids with slot 1's id (made a real one) repeated in the
    last slot and slot 0 a pad."""
    ids[-1] = ids[1] = ids[1].clamp(min=0)
    ids[0] = -2
    return ids


def dup_wave_inputs(gen):
    """rand_hist_inputs' 64-slot wave over 2^20 rows with a duplicated id
    (slots 1 and 63) and a pad."""
    bins, pos, gq, hq, ids, M = rand_hist_inputs(gen, 28, 1 << 20, 256, 64,
                                                 "u8")
    return bins, pos, gq, hq, dup_ids(ids), M


def phase_train_kernels(card):
    """K2, K4 and K5 against their plain versions on the card, exact."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist, route

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = {"hist_q": 0.0, "hist_gather_q": 0.0, "route": 0.0}

    def cmp(name, got, want, what):
        torch.cuda.synchronize()
        err = float((got.long() - want.long()).abs().max()) if got.numel() \
            else 0.0
        errs[name] = max(errs[name], err)
        ok = torch.equal(got, want)
        print(f"kernel check {name} {what}, tolerance exact (torch.equal): "
              f"{ok}, max_abs_err {err} [{card}]", flush=True)
        check(ok, f"{name} disagrees with its plain version at {what}")

    for F, n, B, N, dt in HIST_SHAPES:
        bins, pos, gq, hq, ids, M = rand_hist_inputs(gen, F, n, B, N, dt)
        got = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M)
        want = hist.hist_wave_q_plain(bins, pos, gq, hq, ids, B, M)
        cmp("hist_q", got, want, f"(F, n, B, N) = ({F}, {n}, {B}, {N}) "
            f"{dt} bins")
    bins, pos, gq, hq, ids, M = rand_hist_inputs(
        gen, 28, 1 << 20, 256, 64, "u8")
    rows = bins.t().contiguous()
    for R in GATHER_SHAPES:
        idx, pg, gg, hg = compacted(pos, gq, hq, ids, R, 0.25, gen)
        got = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, 256,
                                    max_nodes=M)
        want = hist.hist_gather_q_plain(rows, idx, pg, gg, hg, ids, 256, M)
        cmp("hist_gather_q", got, want, f"R = {R}, N = 64, a quarter of "
            "the slots dead")
    bins, pos, gq, hq, ids, M = dup_wave_inputs(gen)
    got = hist.hist_wave_q(bins, pos, gq, hq, ids, 256, max_nodes=M)
    cmp("hist_q", got, hist.hist_wave_q_plain(bins, pos, gq, hq, ids, 256, M),
        "a duplicated id (slots 1 and 63) and pads, N = 64")
    check(torch.equal(got[1], got[63]) and bool(got[1].any()),
          "hist_q: the duplicated id's slots differ")
    rows = bins.t().contiguous()
    idx, pg, gg, hg = compacted(pos, gq, hq, ids, 65536, 0.25, gen)
    got = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, 256, max_nodes=M)
    cmp("hist_gather_q", got, hist.hist_gather_q_plain(rows, idx, pg, gg, hg,
                                                       ids, 256, M),
        "R = 65536, a duplicated id (slots 1 and 63) and pads, N = 64")
    check(torch.equal(got[1], got[63]) and bool(got[1].any()),
          "hist_gather_q: the duplicated id's slots differ")
    NW, n = 64, 1 << 20
    nid = torch.randperm(M, generator=gen, device="cuda")[:NW].to(
        torch.int32)
    valid = torch.rand((NW,), generator=gen, device="cuda") < 0.75
    feat = torch.randint(0, 28, (NW,), generator=gen, device="cuda",
                         dtype=torch.int32)
    feat[~valid] = -1
    slot = torch.randint(0, 256, (NW,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lch = (M + 2 * torch.arange(NW, device="cuda")).to(torch.int32)
    lo = torch.randint(0, 128, (NW,), generator=gen, device="cuda",
                       dtype=torch.int32)
    hi = lo + torch.randint(1, 128, (NW,), generator=gen, device="cuda",
                            dtype=torch.int32)
    args = (bins, pos, valid, nid, feat, slot, lch, lch + 1, lo, hi)
    got = route.route_wave(*args[:8], lo=lo, hi=hi)
    want = route.route_wave_plain(*args)
    cmp("route", got, want, "NW = 64 over 2^20 rows, invalid slots, EFB "
        "member ranges")
    route_edge_cases(gen, cmp)
    return errs


def route_edge_cases(gen, cmp):
    """K5's lookup, row and store paths (slice 7), each against its plain
    version: duplicated valid ids (the later slot wins), a duplicated id
    whose later slot is invalid, node ids above K1-K4's 57,344 cap and a
    wave wider than the direct map, a misaligned pos[1:] view, out
    separate from and aliased to pos, int32 bins, int64 slot fields."""
    import torch

    from ytklearn_tpu_torch.gbdt import route

    NW, n, F = 64, (1 << 20) + 3, 28
    for what, dup, base, spread, view, alias, i32, wide in (
            ("duplicated valid ids", "valid", 0, 129, False, False, False,
             False),
            ("a duplicated id whose later slot is invalid", "invalid", 0,
             129, False, True, False, False),
            ("node ids above 57,344", None, 60000, 129, False, False, False,
             False),
            ("ids spread over 10^6 (the sorted lookup)", None, 60000,
             10 ** 6, False, True, False, True),
            ("a misaligned pos[1:], out separate", None, 0, 129, True,
             False, False, False),
            ("a misaligned pos[1:], out aliased", None, 0, 129, True, True,
             False, False),
            ("int32 bins, out aliased", None, 0, 129, False, True, True,
             False)):
        B = 1024 if i32 else 256
        bins = torch.randint(0, B, (F, n), generator=gen, device="cuda",
                             dtype=torch.int32)
        bins = bins if i32 else bins.to(torch.uint8)
        ids = torch.randperm(spread, generator=gen, device="cuda")[:NW]
        nid = (ids + base).to(torch.int32)
        full = nid[torch.randint(0, NW, (n + 1,), generator=gen,
                                 device="cuda")]
        full[torch.rand((n + 1,), generator=gen, device="cuda") < 0.2] = -1
        pos = full[1:] if view else full[:n].clone()
        valid = torch.rand((NW,), generator=gen, device="cuda") < 0.8
        if dup:
            nid[NW - 1] = nid[1]
            valid[1] = True
            valid[NW - 1] = dup == "valid"
        feat = torch.randint(-1, F + 1, (NW,), generator=gen, device="cuda",
                             dtype=torch.int32)
        slot = torch.randint(0, B, (NW,), generator=gen, device="cuda",
                             dtype=torch.int32)
        lch = (base + 2 * spread + 2 * torch.arange(NW, device="cuda")).to(
            torch.int32)
        lo = torch.randint(0, B // 4, (NW,), generator=gen, device="cuda",
                           dtype=torch.int32)
        hi = lo + B // 2
        if wide:
            feat, slot, lo, hi = (x.long() for x in (feat, slot, lo, hi))
        want = route.route_wave_plain(bins, pos, valid, nid, feat, slot, lch,
                                      lch + 1, lo, hi)
        got = route.route_wave(bins, pos, valid, nid, feat, slot, lch,
                               lch + 1, lo=lo, hi=hi,
                               out=pos if alias else None)
        check(not alias or got.data_ptr() == pos.data_ptr(),
              f"route: out is not pos at {what}")
        cmp("route", got, want, f"NW = {NW} over {n} rows, {what}")


def phase_train(tmp, card, precision="int8", goss=(1.0, 0.0),
                rounds=TRAIN_ROUNDS, recorder=None):
    """The full-width training run at one histogram precision: int8, the
    main path of slice 2, or bf16, the JAX trainer's default; GOSS off, or
    (slice 9) bench.py's default (0.2, 0.125). K5 must run once a wave for
    each routed row set: the training rows and the test rows, and under
    GOSS the fit rows besides. A ShapeRecorder, if given, sees the
    engine's K2, K4 and K5 calls of the run."""
    import torch

    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.scripts.bench_gbdt import (
        bench_params,
        gen_higgs_like,
    )

    train, test = gen_higgs_like(TRAIN_ROWS, TEST_ROWS, N_FEATURES, SEED)
    params = bench_params(rounds, os.path.join(tmp, "train.model"))
    trainer = GBDTTrainer(params, hist_precision=precision, device="cuda",
                          goss=goss)
    torch.cuda.synchronize()
    zero_kernel_counts()  # count the main path's launches only
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext():
        res = trainer.train(train=train, test=test)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    losses = [r["train_loss"] for r in res.round_log]
    trees = len(res.model.trees)
    sync = trainer.sync_log
    # bench.py:346-352: from the first sync at round >= 3 to the last
    tail = [(r, t) for r, t in sync if r >= 3]
    check(len(tail) >= 2, f"too few syncs for a steady window: {sync}")
    (r0, t0s), (r1, t1s) = tail[0], tail[-1]
    tps = (r1 - r0) / (t1s - t0s)
    auc = res.test_metrics["auc"]
    label = precision if goss[0] >= 1 else \
        f"{precision} GOSS a={goss[0]:g} b={goss[1]:g}"
    print(f"train {label}: {TRAIN_ROWS} rows x {N_FEATURES} features, "
          f"{TEST_ROWS} test rows, {trees} trees (loss policy, 255 leaves, "
          f"wave {trainer.grow_spec.wave}, ladder {trainer.grow_spec.ladder}, "
          f"{label}) in {wall:.3f} s (preprocess "
          f"{trainer.time_stats['preprocess']:.3f} s, rounds "
          f"{trainer.time_stats['train']:.3f} s); steady {tps:.4f} trees/s "
          f"(sync log, rounds {r0}..{r1}); train loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; test AUC {auc:.6f}, test logloss "
          f"{res.test_loss:.6f} (EvalSet logloss "
          f"{res.test_metrics['logloss']:.6f}) [{card}]", flush=True)
    per_tree = {k: v / trees for k, v in counts.items()}
    # the trainer reads one loss per round besides the engine's probes
    syncs = (counts["host_syncs"] + len(sync)) / trees
    full, gather = PRECISION_KERNELS[precision]
    print(f"train {label}: launches per tree: {full} "
          f"{per_tree[full]:.2f}, {gather} {per_tree[gather]:.2f}, route "
          f"{per_tree['route']:.2f}; host syncs per tree {syncs:.2f} "
          f"({counts['host_syncs']} phase probes + {len(sync)} loss reads "
          f"over {trees} trees); wave log rows used per tree "
          f"{(trainer.wave_log[..., 3] > 0).sum() / trees:.2f} [{card}]",
          flush=True)
    other = [k for k in ("hist", "hist_gather", "hist_q", "hist_gather_q")
             if k not in (full, gather)]
    check(all(counts[k] > 0 for k in (full, gather, "route"))
          and all(counts[k] == 0 for k in other),
          f"the {label} path did not run exactly its kernels: {counts}")
    # every histogram pass but each tree's root follows a wave's routing
    waves = int((trainer.wave_log[..., 3] > 0).sum()) - trees
    sets = 2 + (goss[0] < 1)
    print(f"train {label}: route launches {counts['route']} over "
          f"{waves} waves: {counts['route'] / waves:.4f} a wave, {sets} row "
          f"sets [{card}]", flush=True)
    check(counts["route"] == sets * waves,
          f"route ran {counts['route']} times over {waves} waves, not "
          f"{sets} a wave")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0]
          and res.train_loss < 0.65, f"train loss did not fall: {losses}")
    check(0.5 < auc <= 1.0 and math.isfinite(res.test_loss),
          f"test AUC {auc} / logloss {res.test_loss}")
    return counts, trainer, res, tps


def phase_train_profile(card, goss=(1.0, 0.0)):
    """Two traced rounds of a second full-width run: device busy time
    (kernels and copies) against the wall time of those rounds; GOSS off,
    or (slice 9) bench.py's default."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.scripts._common import device_busy
    from ytklearn_tpu_torch.scripts.bench_gbdt import (
        bench_params,
        gen_higgs_like,
    )

    class Traced(GBDTTrainer):
        def _round(self, rnd, dd, spec, state):
            if rnd == 1:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            out = super()._round(rnd, dd, spec, state)
            if rnd == 2:
                torch.cuda.synchronize()
                self.wall_ms = (time.perf_counter() - self.t0) * 1e3
                self.prof.__exit__(None, None, None)
            return out

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_p_")
    try:
        train, test = gen_higgs_like(TRAIN_ROWS, TEST_ROWS, N_FEATURES, SEED)
        tr = Traced(bench_params(3, os.path.join(tmp, "p.model")),
                    hist_precision="int8", device="cuda", goss=goss)
        tr.train(train=train, test=test)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    busy_ms, top = device_busy(tr.prof, 8 if goss[0] < 1 else 6)
    check(busy_ms > 0, "the profiler saw no device time in training")
    idle = 1 - busy_ms / tr.wall_ms
    what = "" if goss[0] >= 1 else f" GOSS a={goss[0]:g} b={goss[1]:g}"
    print(f"train profile{what}: 2 rounds (traced), wall {tr.wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share {idle:.4f}; top device "
          f"ops: {fmt_top(top, 48)} [{card}]", flush=True)
    return idle


def exclusive_block(rng, n, n_dense, n_onehot):
    """(X, names): n_dense gaussian columns, then a one-hot block of
    n_onehot mutually exclusive columns (one 1.0 a row), float32."""
    import numpy as np

    X = np.zeros((n, n_dense + n_onehot), np.float32)
    X[:, :n_dense] = rng.randn(n, n_dense)
    X[np.arange(n), n_dense + rng.randint(0, n_onehot, n)] = 1.0
    return X, [f"f{i}" for i in range(n_dense + n_onehot)]


def phase_cpu_card_compare(card):
    """Small l2 configurations on cuda and on the CPU: the same trees.
    Plain int8; GOSS (0.2, 0.125) with instance and feature rates 0.8
    (slice 9); EFB on an exclusive sparse block (slice 9). Then
    prng.uniform over the bench rows, bit-equal on the card and the CPU."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.config.params import (
        ApproximateSpec,
        GBDTParams,
        ModelParams,
    )
    from ytklearn_tpu_torch.gbdt import prng
    from ytklearn_tpu_torch.gbdt.data import GBDTData
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    rng = np.random.RandomState(SEED)
    n, F = 65536, 8
    X = rng.randn(n, F).astype(np.float32)
    y = (1.5 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
         + rng.randn(n) * 0.3).astype(np.float32)
    names = [f"f{i}" for i in range(F)]
    Xe, enames = exclusive_block(rng, n, 4, 60)
    ye = (Xe[:, 0] * Xe[:, 1] + Xe[:, 4:24].sum(1) - Xe[:, 30:40].sum(1)
          + rng.randn(n) * 0.3).astype(np.float32)
    configs = (
        ("int8", X, y, names, {}, {}),
        ("int8 GOSS (0.2, 0.125), rates 0.8", X, y, names,
         {"goss": (0.2, 0.125)},
         {"instance_sample_rate": 0.8, "feature_sample_rate": 0.8}),
        ("int8 EFB, 4 dense + 60 one-hot columns", Xe, ye, enames,
         {"efb": True}, {}),
    )
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_c_")
    rel = 0.0
    try:
        for what, Xc, yc, nc, ctor, over in configs:
            models, plans = {}, {}
            for dev in ("cuda", "cpu"):
                p = GBDTParams(
                    round_num=5, max_depth=8, max_leaf_cnt=63,
                    tree_grow_policy="loss", learning_rate=0.1,
                    min_child_hessian_sum=10.0, loss_function="l2",
                    eval_metric=["rmse"],
                    approximate=[ApproximateSpec(max_cnt=255)],
                    model=ModelParams(data_path=os.path.join(tmp, dev),
                                      dump_freq=0), **over)
                tr = GBDTTrainer(p, hist_precision="int8", device=dev,
                                 wave=16, **ctor)
                models[dev] = tr.train(GBDTData(
                    Xc, yc, np.ones(n, np.float32), n, nc)).model
                plans[dev] = tr._efb_plan
            check((plans["cuda"] is None) == ("EFB" not in what)
                  and (plans["cuda"] is None
                       or plans["cuda"].bundles == plans["cpu"].bundles),
                  f"cpu/card {what}: EFB plans {plans}")
            for a, b in zip(models["cuda"].trees, models["cpu"].trees):
                for f in ("feat", "left", "right", "slot", "sample_cnt",
                          "split"):
                    check(getattr(a, f) == getattr(b, f),
                          f"cuda and cpu trees differ in {f} ({what})")
                la, lb = np.asarray(a.leaf_value), np.asarray(b.leaf_value)
                rel = max(rel, float(np.max(np.abs(la - lb)
                                            / np.maximum(np.abs(lb), 1e-30))))
            nodes = sum(t.n_nodes() for t in models["cuda"].trees)
            extra = "" if plans["cuda"] is None else \
                f"; plan {plans['cuda'].summary()}"
            print(f"cpu/card: l2 {what}, {n} rows x {Xc.shape[1]} features, "
                  f"5 trees ({nodes} nodes, root rows "
                  f"{models['cuda'].trees[0].sample_cnt[0]}) on cuda and on "
                  f"the CPU: integer fields and split values equal; largest "
                  f"relative leaf difference {rel:.3e}{extra} [{card}]",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_pad = -(-TRAIN_ROWS // 16384) * 16384
    key = prng.fold_in(prng.PRNGKey(20170425), 7)
    u_card = prng.uniform(key, n_pad, device="cuda").cpu()
    u_cpu = prng.uniform(key, n_pad)
    same = torch.equal(u_card.view(torch.int32), u_cpu.view(torch.int32))
    print(f"cpu/card: prng.uniform over {n_pad} rows (the bench rows "
          f"padded), bit-equal on cuda and on the CPU: {same} [{card}]",
          flush=True)
    check(same, "prng.uniform differs on the card and the CPU")
    return rel


def goss_kept_rows(n_real, a, b):
    """k_a + k_b of bench.py's GOSS cell from the real row count, the
    formula of bench.py's docstring: ceil(a n) + ceil(b (n - ceil(a n)))."""
    k_a = math.ceil(a * n_real)
    return k_a + math.ceil(b * (n_real - k_a))


def phase_train_goss(tmp, card, tps_off):
    """Slice 9's main path: bench.py's GBDT cell as the reference runs it,
    GOSS (0.2, 0.125) on, at full width in int8 (K2 over the fit matrix,
    K4 over its rungs, K5 three times a wave); then the GOSS steps timed
    alone on that run's last gradients."""
    import torch

    from ytklearn_tpu_torch.gbdt import engine, prng
    from ytklearn_tpu_torch.scripts.bench_gbdt import quality_band

    a, b = GOSS
    recorder = ShapeRecorder()
    counts, trainer, res, tps = phase_train(tmp, card, "int8", goss=GOSS,
                                            recorder=recorder)
    kept = goss_kept_rows(TRAIN_ROWS, a, b)
    wl = trainer.wave_log
    per_tree = sorted(set(wl[:, 0, 4].tolist()))
    roots = {t.sample_cnt[0] for t in res.model.trees}
    print(f"train int8 GOSS: kept rows a tree {per_tree} (wave log), root "
          f"counts {sorted(roots)}, formula ceil({a} n) + ceil({b} (n - "
          f"ceil({a} n))) = {kept} at n = {TRAIN_ROWS}; fit matrix "
          f"{int(wl[0, 0, 0])} rows [{card}]", flush=True)
    check(per_tree == [kept] and roots == {kept},
          f"GOSS kept {per_tree} / {roots} rows a tree, not {kept}")
    auc, ll = res.test_metrics["auc"], res.test_loss
    band = quality_band(auc, ll, False)
    print(f"train int8 GOSS: test AUC {auc:.6f}, logloss {ll:.6f}, "
          f"bench.py's synthetic band with the GOSS headroom: {band}; "
          f"steady {tps:.4f} trees/s beside {tps_off:.4f} with GOSS off "
          f"({tps / tps_off:.3f}x) [{card}]", flush=True)
    check(band == "ok", f"GOSS run outside the band: {band}")

    # the GOSS steps alone, on this run's last gradients (CUDA events)
    dd, spec = trainer.dev_inputs, trainer.grow_spec
    scores = trainer.final_scores[0]
    g, h = trainer.loss.grad_hess(trainer.loss.predict(scores), dd.y)
    g, h = g * dd.weight, h * dd.weight
    key = prng.fold_in(prng.PRNGKey(20170425), TRAIN_ROUNDS)
    n = dd.bins_t.shape[1]
    absg = torch.where(dd.real_mask, g.abs(), -1.0)
    u = prng.uniform(key, n, device="cuda")
    keep = engine._top_rows(absg, kept)  # a kept set of GOSS's size
    R_fit = int(wl[0, 0, 0])
    idx, _ = engine.compact_indices(keep, R_fit)
    steps = {
        "sort |g|": lambda: torch.sort(absg, descending=True, stable=True),
        "uniform draw": lambda: prng.uniform(key, n, device="cuda"),
        "sort draws": lambda: torch.sort(u, descending=True, stable=True),
        "compact + gather": lambda: (
            engine.compact_indices(keep, R_fit),
            dd.bins_t.index_select(1, idx.long()), g[idx.long()],
            h[idx.long()]),
        "goss_sample": lambda: engine.goss_sample(
            spec, dd.bins_t, dd.real_mask, g, h, key),
    }
    tree_ms = 1e3 / tps
    times = {k: cuda_ms(fn, 3) for k, fn in steps.items()}
    print("train int8 GOSS: a tree's GOSS steps, CUDA events: " + ", ".join(
        f"{k} {v:.6f} ms ({v / tree_ms:.4f} of a tree)"
        for k, v in times.items()) + f"; a steady tree {tree_ms:.3f} ms "
        f"[{card}]", flush=True)
    del trainer, dd, scores, g, h, absg, u, keep, idx, steps
    torch.cuda.empty_cache()
    ktimes, kerrs = phase_goss_kernels(recorder, counts, spec, card)
    return counts, tps, ktimes, kerrs


class ShapeRecorder:
    """While active, wraps the engine's histogram wrappers of one precision
    (int8: K2 and K4; bf16/f32: K1 and K3) and K5: counts each one's calls
    at each shape (rows, wave slots) and keeps a copy of the first call's
    inputs at that shape. The launches stay the wrappers' own."""

    #: name, engine attribute, (rows, slots) of a call's arguments
    ROUTE = ("route", "route_wave", lambda a: (a[0].shape[1], a[3].shape[0]))
    KERNELS = {
        "int8": (
            ("hist_q", "hist_wave_q",
             lambda a: (a[0].shape[1], a[4].shape[0])),
            ("hist_gather_q", "hist_wave_gather",
             lambda a: (a[1].shape[0], a[5].shape[0])),
            ROUTE),
        "float": (
            ("hist", "hist_wave", lambda a: (a[0].shape[1], a[4].shape[0])),
            ("hist_gather", "hist_wave_gather",
             lambda a: (a[1].shape[0], a[5].shape[0])),
            ROUTE),
    }

    def __init__(self, precision="int8"):
        self.kernels = self.KERNELS[precision]
        self.calls = {}  # (name, rows, N) -> [calls, args, kwargs]

    def _wrap(self, name, fn, shape_of):
        import torch

        def call(*args, **kw):
            key = (name,) + shape_of(args)
            if key not in self.calls:
                # the bins are never written; K5 writes its positions in
                # place, so the rest is copied before the call
                keep = [args[0]] + [a.clone() if torch.is_tensor(a) else a
                                    for a in args[1:]]
                kw_keep = {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in kw.items() if k != "out"}
                self.calls[key] = [0, keep, kw_keep]
            self.calls[key][0] += 1
            return fn(*args, **kw)

        return call

    def __enter__(self):
        from ytklearn_tpu_torch.gbdt import engine

        self.saved = {}
        for name, attr, shape_of in self.kernels:
            self.saved[attr] = getattr(engine, attr)
            setattr(engine, attr, self._wrap(name, self.saved[attr],
                                             shape_of))
        return self

    def __exit__(self, *exc):
        from ytklearn_tpu_torch.gbdt import engine

        for attr, fn in self.saved.items():
            setattr(engine, attr, fn)


def phase_goss_kernels(recorder, counts, spec, card):
    """K2, K4 and K5 at every shape the GOSS bench run gave them, on that
    run's own inputs (the first call at each shape): K2 over the fit matrix
    (R_fit rows) at each wave width and over any gathered rung, K4 over the
    fused rungs, K5 over the fit rows, the full training matrix and the
    test rows. Each call is held exactly to its plain version (K5 also in
    place, as the engine calls it), then timed beside its plain version,
    one int32 scatter_add_ of the same sums (K2, K4) and its bound. The
    calls at the shapes must add up to the run's launch counts. Returns
    the kernels line's (ms, plain_ms, bound_ms, bound_by, library_ms) of
    each kernel, each the mean per launch over the run's mix of shapes
    (bound_by the side of the larger share of bound time), and each
    kernel's largest error."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist, route

    t0 = time.perf_counter()
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    F, B, M = spec.F, spec.B, spec.max_nodes
    for name in ("hist_q", "hist_gather_q", "route"):
        seen = sum(c for (k, _, _), (c, _, _) in recorder.calls.items()
                   if k == name)
        check(seen == counts[name], f"{name}: {seen} calls recorded at "
              f"their shapes, {counts[name]} launches counted")
    shapes = {"hist_q": [], "hist_gather_q": [], "route": []}
    errs = dict.fromkeys(shapes, 0.0)
    for (name, rows, N), (calls, args, kw) in sorted(
            recorder.calls.items()):
        if name == "hist_q":
            bins, pos, gq, hq, ids, _ = args
            fn, plain, keys_of = (
                lambda: hist.hist_wave_q(*args, **kw),
                lambda: hist.hist_wave_q_plain(bins, pos, gq, hq, ids, B, M),
                lambda: flat_keys(lambda f, r: bins[f, r], F, B, pos, gq, hq,
                                  ids, M))
            bound = hist_bound_ms(bins, False, None, pos, ids, M, B)
            what = (f"{rows} rows scanned, q_plan "
                    f"{plan_text(hist.q_plan(N, F, B, M, rows, sm))}")
        elif name == "hist_gather_q":
            brows, idx, pg, gg, hg, ids, _ = args
            fn, plain, keys_of = (
                lambda: hist.hist_wave_gather(*args, **kw),
                lambda: hist.hist_gather_q_plain(brows, idx, pg, gg, hg, ids,
                                                 B, M),
                lambda: flat_keys(lambda f, r: brows[idx[r].long(), f], F, B,
                                  pg, gg, hg, ids, M))
            bound = hist_bound_ms(brows, True, idx, pg, ids, M, B)
            what = (f"R = {rows} gathered rows, q_plan "
                    f"{plan_text(hist.q_plan(N, F, B, M, rows, sm, True))}")
        else:
            bins, pos, valid, nid, feat = args[:5]
            fn, plain, keys_of = (
                lambda: route.route_wave(*args, **kw),
                lambda: route.route_wave_plain(*args, kw["lo"], kw["hi"]),
                None)
            bound = route_bound_ms(bins, pos, valid, nid, feat)
            what = f"{rows} rows routed"
        got, want = fn(), plain()
        ok = torch.equal(got, want)
        if name == "route":
            inplace = pos.clone()
            route.route_wave(bins, inplace, *args[2:], out=inplace, **kw)
            ok = ok and torch.equal(inplace, want)
            del inplace
        torch.cuda.synchronize()
        err = float((got.long() - want.long()).abs().max()) \
            if got.numel() else 0.0
        print(f"kernel check {name} at the GOSS run's shape N = {N}, {what} "
              f"({calls} calls), tolerance exact (torch.equal): {ok}, "
              f"max_abs_err {err} [{card}]", flush=True)
        check(ok, f"{name} disagrees with its plain version at the GOSS "
              f"run's shape N = {N}, {rows} rows")
        errs[name] = max(errs[name], err)
        del got, want
        ms = cuda_ms(fn, iters=10)
        plain_ms = cuda_ms(plain, iters=1, repeats=3)
        lib_ms = None
        if keys_of is not None:
            keys, vals = keys_of()
            flat = torch.zeros(N * F * B * 3, dtype=torch.int32,
                               device="cuda")
            lib_ms = cuda_ms(lambda: flat.zero_().scatter_add_(0, keys, vals),
                             iters=3, repeats=3)
            del keys, vals, flat
        print(f"timing goss: {name} N = {N}, {rows} rows, {calls} calls: "
              f"{ms:.6f} ms, plain {plain_ms:.6f} ms, one scatter_add_ "
              f"{'%.6f ms' % lib_ms if lib_ms is not None else 'none'}, "
              f"bound {bound[0]:.6f} ms ({bound[1]}) [{card}]", flush=True)
        shapes[name].append({"calls": calls, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound[0], "bound_by": bound[1],
                             "library_ms": lib_ms})
    out = {}
    for name, got in shapes.items():
        n = sum(x["calls"] for x in got)

        def mean(k):
            return sum(x["calls"] * x[k] for x in got) / n

        share = {}
        for x in got:
            share[x["bound_by"]] = (share.get(x["bound_by"], 0.0)
                                    + x["calls"] * x["bound_ms"])
        lib = None if name == "route" else mean("library_ms")
        out[name] = (mean("ms"), mean("plain_ms"), mean("bound_ms"),
                     max(share, key=share.get), lib)
        print(f"timing goss: {name} over the run's {n} launches at "
              f"{len(got)} shapes, a launch on average: {out[name][0]:.6f} "
              f"ms, plain {out[name][1]:.6f} ms, bound {out[name][2]:.6f} ms "
              f"({out[name][3]}), one scatter_add_ "
              f"{'%.6f ms' % lib if lib is not None else 'none'} [{card}]",
              flush=True)
    recorder.calls.clear()
    print(f"phase goss kernels: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return out, errs


def phase_efb(card):
    """EFB at a realistic sparse width on the card (slice 9): the 28 dense
    Higgs-like features and a one-hot block of EFB_ONEHOT exclusive
    columns over EFB_ROWS rows. The plan bundles the block into two
    columns (a bundle holds at most B - 1 = 255 one-bin members). An int8
    run with EFB trains EFB_ROUNDS trees; each round's tree must be the
    tree `grow` makes from the same gradients on the unbundled matrix
    (structure, counts, split values and feature names equal; leaves at
    rtol 1e-4 with a floor of 1e-4 of the largest), or part from it only
    where f32 order decides: at a node whose two choices' gains agree
    within 1e-4, or where a child's hessian sits on min_child_hessian_sum.
    The range correction adds f32 in another order than the unbundled
    prefix sum (the reference's test_efb_lossless_on_exclusive_block says
    the same), so neither whole runs nor model texts are compared byte for
    byte. Then the bundled K2 and K1 histograms and K5 with the members'
    real lo/hi are held against their plain versions."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.gbdt import engine, hist, route, state
    from ytklearn_tpu_torch.gbdt.data import GBDTData
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.scripts.bench_gbdt import bench_params

    class Recording(GBDTTrainer):
        def _round(self, rnd, dd, spec, st):
            g, h = self.loss.grad_hess(self.loss.predict(st[0]), dd.y)
            out = super()._round(rnd, dd, spec, st)
            self.rounds.append((g * dd.weight, h * dd.weight, {
                k: v[rnd].cpu().numpy() for k, v in out[2].items()}))
            return out

    rng = np.random.RandomState(SEED + 9)
    n = EFB_ROWS
    X, names = exclusive_block(rng, n, N_FEATURES, EFB_ONEHOT)
    # each one-hot category shifts the logit by its own weight
    w = (rng.randn(EFB_ONEHOT) * 2.0).astype(np.float32)
    logit = (1.5 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
             + X[:, N_FEATURES:] @ w)
    y = (logit + 0.5 * rng.randn(n) > 0).astype(np.float32)
    data = GBDTData(torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda(),
                    np.ones(n, np.float32), n, names)
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_e_")
    try:
        tr = Recording(bench_params(EFB_ROUNDS, os.path.join(tmp, "e")),
                       hist_precision="int8", device="cuda", efb=True)
        tr.rounds = []
        zero_kernel_counts()
        t0 = time.perf_counter()
        tr.train(data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = kernel_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the same data unbundled: the inputs and spec the efb=False trainer
    # would grow on
    plain = GBDTTrainer(tr.params, hist_precision="int8", device="cuda",
                        efb=False)
    du = plain._prep_device_inputs(data, None)
    spec_u = plain._grow_spec(du.F, du.B)
    plan = tr._efb_plan
    print(f"efb: {n} rows x {X.shape[1]} features -> "
          f"{tr.dev_inputs.bins_t.shape[0]} columns ({plan.summary()}), "
          f"{EFB_ROUNDS} trees int8 in {wall:.3f} s; launches hist_q "
          f"{c['hist_q']}, hist_gather_q {c['hist_gather_q']}, route "
          f"{c['route']} [{card}]", flush=True)
    check(c["hist_q"] > 0 and c["hist_gather_q"] > 0 and c["route"] > 0,
          f"efb: the kernels did not run: {c}")
    check(len(plan.bundles) == 2 and plan.n_bundled_features == EFB_ONEHOT,
          f"efb: the one-hot block did not bundle: {plan.summary()}")
    bins_f, min_h = tr.dev_inputs.bins, tr.params.min_child_hessian_sum
    rel, split_on, notes = 0.0, set(), []
    for rnd, (g, h, arrays) in enumerate(tr.rounds):
        a = tr._arrays_to_tree(arrays, bins_f, names)
        tu, *_ = engine.grow(spec_u, du.bins_t, du.real_mask, g, h,
                             torch.ones(du.F, dtype=torch.bool,
                                        device="cuda"))
        b = plain._arrays_to_tree(state.tree_arrays_to_numpy(tu), du.bins,
                                  names)
        split_on |= set(a.feat_name) & set(names[N_FEATURES:])
        first = next((i for i in range(min(a.n_nodes(), b.n_nodes()))
                      if (a.feat[i], a.slot[i], a.split[i], a.sample_cnt[i])
                      != (b.feat[i], b.slot[i], b.split[i], b.sample_cnt[i])),
                     None)
        if first is None and a.n_nodes() == b.n_nodes():
            check(a.feat_name == b.feat_name
                  and a.default_left == b.default_left,
                  f"efb: round {rnd}'s trees differ in names or defaults")
            # leaves at rtol 1e-4 with a floor of 1e-4 of the largest: a
            # member's side is the node total less the default side, so
            # the f32 order's ulp of the total shows in small leaves
            la, lb = np.asarray(a.leaf_value), np.asarray(b.leaf_value)
            rel = max(rel, float(np.max(np.abs(la - lb) / (
                np.abs(lb) + np.abs(lb).max()))))
            continue
        # where they part, the two choices must be apart only by f32 order:
        # gains within 1e-4, or a child's hessian on the min_h boundary
        i = first
        check(i is not None and a.sample_cnt[i] == b.sample_cnt[i],
              f"efb: round {rnd}'s trees differ in size only")
        ga, gb = a.gain[i], b.gain[i]
        tie = abs(ga - gb) <= 1e-4 * max(abs(ga), abs(gb))
        edge = [t.hess_sum[c] for t in (a, b) for c in (t.left[i], t.right[i])
                if t.left[i] >= 0 and abs(t.hess_sum[c] - min_h) <= 1e-4 * min_h]
        notes.append(f"round {rnd} parts at node {i} ({a.sample_cnt[i]} rows:"
                     f" {a.feat_name[i]} slot {a.slot[i]} gain {ga} against "
                     f"{b.feat_name[i]} slot {b.slot[i]} gain {gb}"
                     f"{', a child hessian ' + str(edge[0]) if edge else ''})")
        check(tie or edge, f"efb: {notes[-1]} is not a float tie")
    print(f"efb: {EFB_ROUNDS - len(notes)} of {EFB_ROUNDS} rounds' bundled "
          f"trees equal the trees grown from their gradients on the "
          f"unbundled matrix (structure, counts, split values, names; "
          f"leaves: largest |a - b| / (|b| + max |b|) {rel:.3e}); "
          f"{'; '.join(notes) or 'none parts'}; {len(split_on)} one-hot "
          f"features split on [{card}]", flush=True)
    check(rel <= 1e-4 and split_on and len(notes) < EFB_ROUNDS,
          f"efb: leaves differ by {rel}, or no one-hot feature split")

    # the bundled matrix through K2, K1 and K5 against the plain versions
    dd = tr.dev_inputs
    bins = dd.bins_t
    F, nb = bins.shape
    B = dd.B
    M = 129
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    pos = torch.randint(-1, M, (nb,), generator=gen, device="cuda",
                        dtype=torch.int32)
    gq = torch.randint(-127, 128, (nb,), generator=gen, device="cuda").float()
    hq = torch.randint(0, 128, (nb,), generator=gen, device="cuda").float()
    ids = torch.randperm(M, generator=gen, device="cuda")[:64].to(
        torch.int32)
    err = {}
    got = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M)
    want = hist.hist_wave_q_plain(bins, pos, gq, hq, ids, B, M)
    err["hist_q"] = float((got.long() - want.long()).abs().max())
    check(torch.equal(got, want), "efb: K2 on the bundled matrix disagrees")
    g = torch.randn(nb, generator=gen, device="cuda")
    hh = torch.rand(nb, generator=gen, device="cuda")
    got = hist.hist_wave(bins, pos, g, hh, ids, B, max_nodes=M)
    want = hist.hist_wave_plain(bins, pos, g, hh, ids, B, M)
    e = hist_err(got, want, "the bundled matrix, N = 64, bf16", "hist",
                 card)
    err["hist"] = e
    rlo, rhi = dd.ranges
    U = len(plan.col_fid)
    NW = 64
    feat = torch.randint(U, F, (NW,), generator=gen, device="cuda",
                         dtype=torch.int32)
    slot_r = torch.zeros(NW, dtype=torch.int64, device="cuda")
    for i in range(NW):  # a boundary inside a member of that bundle
        b_ = int(feat[i]) - U
        j = int(torch.randint(len(plan.bundles[b_]), (1,), generator=gen,
                              device="cuda"))
        slot_r[i] = plan.member_lo[b_][j] + int(
            torch.randint(0, plan.member_hi[b_][j] - plan.member_lo[b_][j]
                          + 1, (1,), generator=gen, device="cuda"))
    lo = rlo[feat.long(), slot_r]
    hi = rhi[feat.long(), slot_r]
    slot = (lo - 1).to(torch.int32)
    nid = torch.randperm(M, generator=gen, device="cuda")[:NW].to(
        torch.int32)
    valid = torch.rand(NW, generator=gen, device="cuda") < 0.9
    lch = (M + 2 * torch.arange(NW, device="cuda")).to(torch.int32)
    want = route.route_wave_plain(bins, pos, valid, nid, feat, slot, lch,
                                  lch + 1, lo, hi)
    err["route"] = 0.0
    for what, (l_, h_) in (("int32", (lo, hi)),
                           ("int64", (lo.long(), hi.long()))):
        got = route.route_wave(bins, pos, valid, nid, feat, slot, lch,
                               lch + 1, lo=l_, hi=h_)
        ok = torch.equal(got, want)
        moved = int(((want != pos) & (want % 2 == 0)).sum())
        print(f"kernel check route on the bundled matrix, {NW} slots with "
              f"the members' {what} lo/hi ({moved} rows sent right), "
              f"tolerance exact (torch.equal): {ok} [{card}]", flush=True)
        check(ok and moved > 0,
              f"route with EFB lo/hi ({what}) disagrees with its plain "
              "version")
    print(f"kernel check hist_q on the bundled matrix ({F} x {nb}, N = 64), "
          f"tolerance exact (torch.equal): True [{card}]", flush=True)
    return err


def phase_bench_script(card):
    """scripts/bench_gbdt.py as a user runs it, in a fresh process: bench.py's
    cell with its GOSS default; its JSON line is printed here."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "ytklearn_tpu_torch.scripts.bench_gbdt"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(out.returncode == 0,
          f"bench_gbdt exited {out.returncode}: {out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"bench_gbdt: {wall:.3f} s (wall, a fresh process) [{card}]",
          flush=True)
    print(json.dumps(rec), flush=True)
    check(rec["band"] == "ok" and rec["goss"] == "a=0.2,b=0.125"
          and rec["goss_rows_per_tree"] == goss_kept_rows(TRAIN_ROWS, *GOSS),
          f"bench_gbdt: {rec}")
    return rec


def bound_ms(nbytes, int_ops):
    """The larger of: `nbytes` over HBM bandwidth, `int_ops` int32
    operations over the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sector_bytes(offsets):
    """Bytes of the distinct 32-byte sectors that hold these byte offsets:
    the device reads memory in whole sectors."""
    import torch

    return 32 * int(torch.unique(offsets // 32).numel())


def hist_bound_ms(bins, gather, idx, pos, ids, M, B):
    """K2/K4's bound from this call's own inputs. Bytes: pos read whole;
    the sectors of gq, hq (and K4's idx) that hold a row of the wave, and
    of bins those rows' bins (K2: each feature's, feature-major; K4: the
    gathered rows' F bins, row-major); the (N, F, B, 3) int32 histogram
    written once. Operations: three int32 adds per wave row and feature."""
    import torch

    from ytklearn_tpu_torch.gbdt.hist import node_slots

    eb = bins.element_size()
    n, N = pos.shape[0], ids.shape[0]
    _, ok = node_slots(pos, ids, M)
    live = torch.nonzero(ok).flatten()
    F = bins.shape[1] if gather else bins.shape[0]
    nbytes = 4 * n + 12 * N * F * B
    nbytes += (3 if gather else 2) * sector_bytes(live * 4)  # (idx,) gq, hq
    if gather:
        rows = idx[live].long()
        nbytes += sector_bytes(((rows * F)[:, None]
                                + torch.arange(F, device=rows.device)) * eb)
    else:
        nbytes += sum(sector_bytes((f * bins.shape[1] + live) * eb)
                      for f in range(F))
    return bound_ms(nbytes, 3 * F * live.numel())


def route_bound_ms(bins_t, pos, valid, nid, feat):
    """K5's bound from this call's own inputs. Bytes: every row's position
    read and written (8 B a row), the slot table, and the sectors of bins
    that hold the bin of a row's matching slot's feature (a row outside
    the wave reads none). Operations: one id compare per row and slot."""
    import torch

    F, n = bins_t.shape
    f_row = torch.full_like(pos, -1)
    for i in range(nid.shape[0]):  # a later matching slot wins, as in K5
        hit = (pos == nid[i]) & valid[i]
        f_row = torch.where(hit, feat[i].clamp(0, F - 1), f_row)
    rows = torch.nonzero(f_row >= 0).flatten()
    nbytes = 8 * n + 32 * nid.shape[0] + sector_bytes(
        (f_row[rows].long() * n + rows) * bins_t.element_size())
    return bound_ms(nbytes, n * nid.shape[0])


def flat_keys(bin_of, F, B, pos, gq, hq, ids, M, bf16=None):
    """Flattened (slot, feature, bin, channel) keys and the values of every
    (row, feature) update: the input of the one-call yardstick. int32
    values of quantized grads (bf16 None), else f32 values of g/h (rounded
    to bf16 first when bf16)."""
    import torch

    from ytklearn_tpu_torch.gbdt.hist import node_slots, round_bf16

    slot, ok = node_slots(pos, ids, M)
    rows = torch.nonzero(ok).flatten()
    s = slot[rows]
    f = torch.arange(F, device="cuda")
    b = torch.stack([bin_of(fi, rows) for fi in range(F)], dim=1).long()
    base = ((s[:, None] * F + f[None, :]) * B + b) * 3  # (rows, F)
    keys = (base[..., None] + torch.arange(3, device="cuda")).flatten()
    if bf16 is None:
        gv, hv = gq[rows].int(), hq[rows].int()
    else:
        gv, hv = gq[rows], hq[rows]
        if bf16:
            gv, hv = round_bf16(gv), round_bf16(hv)
    vals = torch.stack([gv, hv, torch.ones_like(gv)], dim=1)
    vals = vals[:, None, :].expand(-1, F, -1).flatten().contiguous()
    return keys, vals


def phase_train_timings(trainer, card):
    """Each training kernel at the full-width training shapes."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist, route

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    dd_bins = trainer.dev_inputs.bins_t  # (28, n_pad) u8 training bins
    F, n = dd_bins.shape
    B, M = trainer.grow_spec.B, trainer.grow_spec.max_nodes
    N = trainer.grow_spec.wave
    pos = torch.randint(0, 2 * N + 1, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    gq = torch.randint(-127, 128, (n,), generator=gen, device="cuda").float()
    hq = torch.randint(0, 128, (n,), generator=gen, device="cuda").float()
    ids = torch.arange(1, 2 * N + 1, 2, device="cuda", dtype=torch.int32)
    out = {}

    def run(name, fn, plain, lib, bound, iters):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name} disagrees at the timing shape")
        ms = cuda_ms(fn, iters=iters)
        plain_ms = cuda_ms(plain, iters=1, repeats=3)
        lib_ms = cuda_ms(lib, iters=3, repeats=3) if lib else None
        out[name] = (ms, plain_ms, bound[0], bound[1], lib_ms)
        print(f"timing: {name} {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"one scatter_add_ "
              f"{'%.6f ms' % lib_ms if lib_ms is not None else 'none'}, "
              f"bound {bound[0]:.6f} ms ({bound[1]}) [{card}]", flush=True)

    # K2: one full-scan wave of N slots over every training row
    args = (dd_bins, pos, gq, hq, ids, B)
    keys, vals = flat_keys(lambda f, r: dd_bins[f, r], F, B, pos, gq, hq,
                           ids, M)
    flat = torch.zeros(N * F * B * 3, dtype=torch.int32, device="cuda")
    run("hist_q", lambda: hist.hist_wave_q(*args, max_nodes=M),
        lambda: hist.hist_wave_q_plain(*args, M),
        lambda: flat.zero_().scatter_add_(0, keys, vals),
        hist_bound_ms(dd_bins, False, None, pos, ids, M, B), iters=10)
    del keys, vals
    # K4: the first fused rung (n/64 rows) of the same wave
    rows = dd_bins.t().contiguous()
    R = -(-(n // 64) // 1024) * 1024
    idx, pg, gg, hg = compacted(pos, gq, hq, ids, R, 0.05, gen)
    keys, vals = flat_keys(lambda f, r: rows[idx[r].long(), f], F, B, pg,
                           gg, hg, ids, M)
    run("hist_gather_q",
        lambda: hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, B,
                                      max_nodes=M),
        lambda: hist.hist_gather_q_plain(rows, idx, pg, gg, hg, ids, B, M),
        lambda: flat.zero_().scatter_add_(0, keys, vals),
        hist_bound_ms(rows, True, idx, pg, ids, M, B), iters=20)
    del keys, vals, rows
    # K5: one wave of N slots over every training row
    valid = torch.ones(N, dtype=torch.bool, device="cuda")
    nid = ids
    feat = torch.randint(0, F, (N,), generator=gen, device="cuda",
                         dtype=torch.int32)
    slot = torch.randint(0, B, (N,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lch = (2 * N + 1 + 2 * torch.arange(N, device="cuda")).to(torch.int32)
    lo = torch.zeros(N, dtype=torch.int32, device="cuda")
    hi = torch.full((N,), B - 1, dtype=torch.int32, device="cuda")
    rargs = (dd_bins, pos, valid, nid, feat, slot, lch, lch + 1)
    run("route", lambda: route.route_wave(*rargs, lo=lo, hi=hi),
        lambda: route.route_wave_plain(*rargs, lo, hi), None,
        route_bound_ms(dd_bins, pos, valid, nid, feat), iters=20)
    return out


# -- slice 6: K2 and K4 redesigned (csrc/hist.cu) ----------------------------

#: the waves of the int8 width phase (the float one's)
Q_WAVES = (1, 2, 8, 16, 32, 42, 64)
#: the int8 bench run's test AUC and logloss, to the digit: int8 sums are
#: exact and the split scans run in a fixed order, so a histogram kernel
#: that moves them is wrong
INT8_TEST_METRICS = ("0.949614", "0.308781")


def q_err(got, want, what, name, card):
    """Hold an int8 histogram exactly to its plain version; print and
    return the largest absolute difference (0 when equal)."""
    import torch

    torch.cuda.synchronize()
    err = float((got.long() - want.long()).abs().max()) if got.numel() \
        else 0.0
    ok = torch.equal(got, want)
    print(f"kernel check {name} {what}, tolerance exact (torch.equal): {ok}, "
          f"max_abs_err {err} [{card}]", flush=True)
    check(ok, f"{name} disagrees with its plain version {what}")
    return err


def plan_text(plan):
    return (f"{plan['kind']} {plan['ng']} x {plan['fg']}, {plan['n_tiles']} "
            f"tiles x {plan['n_chunks']} chunks of {plan['rows_per_chunk']} "
            f"rows, {plan['threads']} threads")


def phase_q_widths(trainer, card):
    """K2 over every bench row and K4 at its first fused rung (R = n/64), on
    waves of Q_WAVES slots (positions over 2N+1 nodes, the wave the odd
    ids, quantized grads at +-127), each held exactly to its plain version
    first, then timed beside one int32 scatter_add_ of the same sums and
    its bound, with the plan q_plan took. Returns the largest error."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    dd_bins = trainer.dev_inputs.bins_t
    F, n = dd_bins.shape
    B = trainer.grow_spec.B
    rows = dd_bins.t().contiguous()
    R = -(-(n // 64) // 1024) * 1024
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    gq = torch.randint(-127, 128, (n,), generator=gen, device="cuda").float()
    hq = torch.randint(0, 128, (n,), generator=gen, device="cuda").float()
    err = 0.0
    for N in Q_WAVES:
        M = 2 * N + 1
        pos = torch.randint(0, M, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids = torch.arange(1, M, 2, device="cuda", dtype=torch.int32)
        idx, pg, gg, hg = compacted(pos, gq, hq, ids, R, 0.05, gen)
        for name, fn, plain, keys_of, bound, plan, iters in (
            ("hist_q", lambda: hist.hist_wave_q(dd_bins, pos, gq, hq, ids, B,
                                                max_nodes=M),
             lambda: hist.hist_wave_q_plain(dd_bins, pos, gq, hq, ids, B, M),
             lambda: flat_keys(lambda f, r: dd_bins[f, r], F, B, pos, gq, hq,
                               ids, M),
             lambda: hist_bound_ms(dd_bins, False, None, pos, ids, M, B),
             hist.q_plan(N, F, B, M, n, sm), 10),
            ("hist_gather_q",
             lambda: hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, B,
                                           max_nodes=M),
             lambda: hist.hist_gather_q_plain(rows, idx, pg, gg, hg, ids, B,
                                              M),
             lambda: flat_keys(lambda f, r: rows[idx[r].long(), f], F, B,
                               pg, gg, hg, ids, M),
             lambda: hist_bound_ms(rows, True, idx, pg, ids, M, B),
             hist.q_plan(N, F, B, M, R, sm, True), 50),
        ):
            what = (f"at the int8 width phase's N = {N} "
                    f"({'n' if name == 'hist_q' else 'R'} = "
                    f"{n if name == 'hist_q' else R})")
            err = max(err, q_err(fn(), plain(), what, name, card))
            ms = cuda_ms(fn, iters=iters)
            keys, vals = keys_of()
            flat = torch.zeros(N * F * B * 3, dtype=torch.int32,
                               device="cuda")
            lib_ms = cuda_ms(lambda: flat.zero_().scatter_add_(0, keys, vals),
                             iters=3, repeats=3)
            del keys, vals, flat
            b_ms, b_by = bound()
            print(f"width q: {name} N = {N} {ms:.6f} ms, one int32 "
                  f"scatter_add_ {lib_ms:.6f} ms (ratio {ms / lib_ms:.3f}), "
                  f"bound {b_ms:.6f} ms ({b_by}), plan {plan_text(plan)} "
                  f"[{card}]", flush=True)
        del idx, pg, gg, hg
    print(f"phase q widths: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err


def phase_q_saturating(n, card):
    """The largest sums a lane of K2/K4 takes: every one of n rows in one
    node and one bin at gq = -127, then +127, and hq = 127 (|sum| = 127 n,
    within int32 at the bench's rows). K2 in the root wave and in a
    64-slot wave at q_plan's plan, at the longest chunk (one chunk: one
    block's tile takes every row) and at red; K4 over all n rows gathered,
    at its plan and its longest chunk. Each exactly against the known sums
    and the plain version."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    t0 = time.perf_counter()
    F, B = N_FEATURES, 256
    check(127 * n < 2 ** 31, f"{n} rows at 127 would wrap int32")
    bins = torch.full((F, n), 17, dtype=torch.uint8, device="cuda")
    pos = torch.full((n,), 5, dtype=torch.int32, device="cuda")
    h = torch.full((n,), 127.0, device="cuda")
    root = torch.tensor([5], dtype=torch.int32, device="cuda")
    wave = torch.arange(64, dtype=torch.int32, device="cuda")
    rows = bins.t().contiguous()
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    err = 0.0
    for gv in (-127.0, 127.0):
        g = torch.full((n,), gv, device="cuda")
        sums = torch.tensor([int(gv) * n, 127 * n, n], dtype=torch.int32,
                            device="cuda")
        cases = []
        for ids in (root, wave):
            N = ids.shape[0]
            ng, fg = hist._q_tile(N, F, B)
            tile = {"ng": ng, "fg": fg, "threads": 1024}
            for plan in (None, dict(tile, kind="tile", n_chunks=1),
                         {"kind": "red", "n_chunks": 528}):
                cases.append(("hist_q", ids, plan, lambda ids=ids, p=plan:
                              hist.hist_wave_q(bins, pos, g, h, ids, B,
                                               max_nodes=64, plan=p)))
        for plan in (None, {"kind": "tile", "ng": 1, "fg": F,
                            "n_chunks": 1}):
            cases.append(("hist_gather_q", root, plan, lambda p=plan:
                          hist.hist_wave_gather(rows, idx, pos, g, h, root,
                                                B, max_nodes=64, plan=p)))
        for name, ids, plan, fn in cases:
            N = ids.shape[0]
            want = torch.zeros((N, F, B, 3), dtype=torch.int32,
                               device="cuda")
            want[0 if N == 1 else 5, :, 17] = sums
            got = fn()
            shown = ("q_plan's " + plan_text(hist.q_plan(
                N, F, B, 64, n, torch.cuda.get_device_properties(0)
                .multi_processor_count, name == "hist_gather_q"))
                if plan is None else str(plan))
            what = (f"saturating: {n} rows in one node and bin, gq = "
                    f"{gv:+.0f}, hq = 127, N = {N}, plan {shown}")
            err = max(err, q_err(got, want, what, name, card))
            if name == "hist_q" and plan is None:
                check(torch.equal(got, hist.hist_wave_q_plain(
                    bins, pos, g, h, ids, B, 64)),
                      f"hist_q's plain version disagrees at {what}")
        del g
    print(f"phase q saturating: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err

# -- slice 3: cli train, the f32/bf16 histograms, the binned rung -------------

#: the text files `cli train` reads on the card (2^20 train, 2^17 test
#: lines), its rounds and the depth that keeps its trees on the binned rung
CLI_ROWS = 1 << 20
CLI_TEST_ROWS = 1 << 17
CLI_ROUNDS = 20
CLI_DEPTH = 8
#: cli train's ingest of the same 2^20 + 2^17 lines with the Python parser
#: (PERF.md section 5; NVIDIA H100 80GB HBM3, 700.00 W)
CLI_INGEST_PYTHON_S = 34.689
CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "experiment", "higgs", "local_gbdt.conf")
#: K1/K3 against their plain versions: float sums in two atomic orders
HIST_RTOL = 1e-5


def hist_err(got, want, what, name, card):
    """Counts exact; g/h within rtol HIST_RTOL and HIST_RTOL of the largest
    |sum|. Returns the largest absolute g/h error."""
    import torch

    torch.cuda.synchronize()
    counts_ok = torch.equal(got[..., 2], want[..., 2])
    scale = float(want[..., :2].abs().max()) if want.numel() else 0.0
    diff = (got[..., :2] - want[..., :2]).abs()
    err = float(diff.max()) if want.numel() else 0.0
    ok = counts_ok and bool((diff <= HIST_RTOL * want[..., :2].abs()
                             + HIST_RTOL * scale).all())
    print(f"kernel check {name} {what}, tolerance counts exact, g/h rtol "
          f"{HIST_RTOL} + {HIST_RTOL} x max|sum| ({scale:.6g}): counts exact "
          f"{counts_ok}, within {ok}, max_abs_err {err} [{card}]", flush=True)
    check(ok, f"{name} disagrees with its plain version at {what}")
    return err


def exact_float_hist(bin_of, F, B, pos, g, h, ids, M, bf16):
    """The (N, F, B, 3) sums of K1/K3's (bf16-rounded) f32 values, added
    in float64 (each id's lowest slot; the engine's waves hold no
    duplicated id): the yardstick where a bin takes most of a wave's rows
    and an f32 sum in any order rounds off."""
    import torch

    keys, vals = flat_keys(bin_of, F, B, pos, g, h, ids, M, bf16=bf16)
    N = ids.shape[0]
    out = torch.zeros(N * F * B * 3, dtype=torch.float64, device="cuda")
    return out.scatter_add_(0, keys, vals.double()).view(N, F, B, 3)


def exact_err(got, want, exact, what, name, card):
    """K1/K3 (got) against the exact sums of the same values: counts equal
    to the plain version's (want) and the exact ones; each g/h sum within
    HIST_RTOL of the exact sum plus HIST_RTOL of the largest, hist_err's
    tolerance. The plain version's own distance from the exact sums is
    printed beside: it accumulates in float64 and rounds once (an f32
    cell adding a bin's rows one at a time drifts by hundreds at the
    softmax root wave). Returns the largest |got - want| of g/h."""
    import torch

    torch.cuda.synchronize()
    counts_ok = torch.equal(got[..., 2], want[..., 2]) and torch.equal(
        got[..., 2].double(), exact[..., 2])
    e = exact[..., :2]
    scale = float(e.abs().max()) if e.numel() else 0.0
    d_k = (got[..., :2].double() - e).abs()
    d_p = (want[..., :2].double() - e).abs()
    ok = counts_ok and bool((d_k <= HIST_RTOL * e.abs()
                             + HIST_RTOL * scale).all())
    err = float((got[..., :2] - want[..., :2]).abs().max()) \
        if got.numel() else 0.0
    print(f"kernel check {name} {what}, against the float64 sums of the same "
          f"values, tolerance counts exact, g/h rtol {HIST_RTOL} + "
          f"{HIST_RTOL} x max|sum| ({scale:.6g}): counts exact {counts_ok}, "
          f"within {ok}; max error of the kernel "
          f"{float(d_k.max()) if d_k.numel() else 0.0:.6g}, of the plain "
          f"version {float(d_p.max()) if d_p.numel() else 0.0:.6g}, "
          f"max_abs_err (kernel - plain) {err} [{card}]", flush=True)
    check(ok, f"{name} disagrees with the exact sums at {what}")
    return err


def phase_float_kernels(card):
    """K1 and K3 at bf16 and f32 against their plain versions on the card,
    at the int8 checks' shapes."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs = {"hist": 0.0, "hist_gather": 0.0}
    for F, n, B, N, dt in HIST_SHAPES:
        bins, pos, _, _, ids, M = rand_hist_inputs(gen, F, n, B, N, dt)
        g = torch.randn((n,), generator=gen, device="cuda") * 3
        h = torch.rand((n,), generator=gen, device="cuda")
        for bf16 in (True, False):
            got = hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M,
                                 use_bf16=bf16)
            want = hist.hist_wave_plain(bins, pos, g, h, ids, B, M, bf16)
            errs["hist"] = max(errs["hist"], hist_err(
                got, want, f"(F, n, B, N) = ({F}, {n}, {B}, {N}) {dt} bins "
                f"{'bf16' if bf16 else 'f32'}", "hist", card))
    bins, pos, _, _, ids, M = rand_hist_inputs(gen, 28, 1 << 20, 256, 64,
                                               "u8")
    g = torch.randn((1 << 20,), generator=gen, device="cuda") * 3
    h = torch.rand((1 << 20,), generator=gen, device="cuda")
    rows = bins.t().contiguous()
    for R in GATHER_SHAPES:
        idx, pg, gg, hg = compacted(pos, g, h, ids, R, 0.25, gen)
        for bf16 in (True, False):
            got = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, 256,
                                        mode="mxu", max_nodes=M,
                                        use_bf16=bf16)
            want = hist.hist_gather_plain(rows, idx, pg, gg, hg, ids, 256, M,
                                          bf16)
            errs["hist_gather"] = max(errs["hist_gather"], hist_err(
                got, want, f"R = {R}, N = 64, a quarter of the slots dead, "
                f"{'bf16' if bf16 else 'f32'}", "hist_gather", card))
    bins, pos, _, _, ids, M = dup_wave_inputs(gen)
    rows = bins.t().contiguous()
    idx, pg, gg, hg = compacted(pos, g, h, ids, 65536, 0.25, gen)
    for bf16 in (True, False):
        what = (f"a duplicated id (slots 1 and 63) and pads, N = 64, "
                f"{'bf16' if bf16 else 'f32'}")
        full = hist.hist_wave(bins, pos, g, h, ids, 256, max_nodes=M,
                              use_bf16=bf16)
        gath = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, 256,
                                     mode="mxu", max_nodes=M, use_bf16=bf16)
        errs["hist"] = max(errs["hist"], hist_err(
            full, hist.hist_wave_plain(bins, pos, g, h, ids, 256, M, bf16),
            what, "hist", card))
        errs["hist_gather"] = max(errs["hist_gather"], hist_err(
            gath, hist.hist_gather_plain(rows, idx, pg, gg, hg, ids, 256, M,
                                         bf16), "R = 65536, " + what,
            "hist_gather", card))
        hist_err(full[63], full[1], what + ": slot 63 against slot 1",
                 "hist", card)
        hist_err(gath[63], gath[1], what + ": slot 63 against slot 1",
                 "hist_gather", card)
    return errs


def binned_tables(model):
    """(vocab, heap, u8 edges table, u16 thresholds table) of a model: the
    edges span its split values in 200 steps per feature; the thresholds
    are its own split values (more than 254 on a feature of the 500-tree
    model)."""
    import numpy as np

    from ytklearn_tpu_torch.serve import kernels

    used = sorted({t.feat_name[i] for t in model.trees
                   for i in range(t.n_nodes()) if not t.is_leaf(i)})
    vocab = {n: i for i, n in enumerate(used)}
    heap, why = kernels.build_heap(model.trees, vocab)
    check(heap is not None, why)
    sv = split_values(model)
    edges = {n: np.linspace(min(sv) - 1.0, max(sv) + 1.0, 200) for n in used}
    u8, why = kernels.build_bin_table(model.trees, vocab, edges)
    check(u8 is not None and u8.mode == "edges" and u8.sentinel == 255, why)
    u16, why = kernels.build_bin_table(model.trees, vocab, None)
    check(u16 is not None and u16.sentinel == 65535,
          f"want a uint16 thresholds table: {why}")
    return vocab, heap, u8, u16


def binned_inputs(heap, table, X, device="cuda"):
    import numpy as np
    import torch

    from ytklearn_tpu_torch.serve import kernels

    bins = torch.from_numpy(kernels.bin_rows(X, table)).to(device)
    packed = torch.from_numpy(kernels.pack_heap_nodes(heap, table)).to(
        device)
    leaf = torch.from_numpy(np.ascontiguousarray(heap.leaf)).to(device)
    return bins, packed, leaf


def phase_binned_kernel(model, card):
    """K7 against its plain version with torch.equal, on uint8 and uint16
    tables, rows with missing values (the sentinel), at every ladder rung
    of the seeded 500-tree model."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.serve import kernels

    vocab, heap, u8, u16 = binned_tables(model)
    rng = np.random.RandomState(SEED + 5)
    max_err = 0.0
    for table in (u8, u16):
        for B in LADDER:
            rows = random_rows(rng, B, list(vocab), split_values(model))
            X = np.full((B, len(vocab)), np.nan)
            for i, r in enumerate(rows):
                for k, v in r.items():
                    if k in vocab:
                        X[i, vocab[k]] = v
            bins, packed, leaf = binned_inputs(heap, table, X)
            got = kernels.binned_walk(bins, packed, leaf, heap.depth,
                                      table.sentinel,
                                      max_feat=int(heap.feat.max()))
            want = kernels.binned_walk_plain(bins, packed, leaf, heap.depth,
                                             table.sentinel)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            print(f"kernel check binned_walk {table.mode} {table.dtype} "
                  f"table, {heap.n_trees} trees depth {heap.depth}, rung {B} "
                  f"({int((bins == table.sentinel).sum())} sentinel bins), "
                  f"tolerance exact (torch.equal): {ok}, max_abs_err {err} "
                  f"[{card}]", flush=True)
            check(ok, f"binned_walk disagrees at rung {B} ({table.dtype})")
    return max_err


CONT_WRITERS = 8  # processes formatting the text of a large write
TEXT_PARALLEL_ROWS = 1 << 18  # rows from which write_ytk_lines spawns them


def write_ytk_text(path, X, y, rng):
    """ytklearn text lines `1###label###f0:v,...`, 1% of them with one
    feature left out (a missing value)."""
    write_ytk_lines(path, X.cpu().double().numpy(),
                    y.cpu().numpy().astype(int), rng)


def _format_lines(args):
    """The text of write_ytk_lines for rows Xh, labels yh and each row's
    left-out feature (`drop`, -1 for none)."""
    Xh, yh, drop = args
    F = Xh.shape[1]
    fmt = "1###%d###" + ",".join(f"f{j}:%.9g" for j in range(F)) + "\n"
    out = []
    for row, y, j in zip(Xh.tolist(), yh, drop):
        if j >= 0:
            out.append(f"1###{y}###" + ",".join(
                f"f{k}:{row[k]:.9g}" for k in range(F) if k != j) + "\n")
        else:
            out.append(fmt % (y, *row))
    return "".join(out)


def write_ytk_lines(path, Xh, yh, rng):
    """write_ytk_text on host arrays (float64 X, int y). From
    TEXT_PARALLEL_ROWS rows on, CONT_WRITERS spawned processes format
    contiguous slices, written in order: the same bytes, the random draws
    all made here first."""
    yh = [int(v) for v in yh]
    F = Xh.shape[1]
    blank = (rng.rand(len(Xh)) < 0.01).tolist()
    drop = [rng.randint(F) if b else -1 for b in blank]
    if len(Xh) < TEXT_PARALLEL_ROWS:
        parts = [_format_lines((Xh, yh, drop))]
    else:
        import multiprocessing

        step = -(-len(Xh) // CONT_WRITERS)
        jobs = [(Xh[lo:lo + step], yh[lo:lo + step], drop[lo:lo + step])
                for lo in range(0, len(Xh), step)]
        with multiprocessing.get_context("spawn").Pool(CONT_WRITERS) as pool:
            parts = pool.map(_format_lines, jobs, chunksize=1)
    with open(path, "w") as f:
        for part in parts:
            f.write(part)


class Recorder:
    """Keeps each instance whose `method` runs, and that call's seconds."""

    def __init__(self, cls, method):
        self.cls, self.method, self.calls = cls, method, []

    def __enter__(self):
        orig = getattr(self.cls, self.method)
        rec = self

        def wrapped(obj, *a, **k):
            t0 = time.perf_counter()
            out = orig(obj, *a, **k)
            rec.calls.append((obj, time.perf_counter() - t0))
            return out

        self.orig = orig
        setattr(self.cls, self.method, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.orig)


def cli_train_argv(paths, model):
    """`cli train gbdt` of the Higgs config on the text at `paths`, dumping
    `model`: phase_cli_train's command line."""
    return ["train", "gbdt", CONF,
            "--set", f"data.train.data_path={paths['train']}",
            "--set", f"data.test.data_path={paths['test']}",
            "--set", f"model.data_path={model}",
            "--set", f"model.feature_importance_path={model}.imp",
            "--set", f"optimization.round_num={CLI_ROUNDS}",
            "--set", f"optimization.max_depth={CLI_DEPTH}"]


def phase_cli_train(tmp, card):
    """`python -m ytklearn_tpu_torch.cli train gbdt <conf>` on the card, run
    in this process (cli.main with the same arguments) so that the kernels'
    counts can be read: the Higgs config at full width (F = 28, 255 bins,
    255 leaves, loss policy, bf16) on 2^20 text lines."""
    import contextlib
    import io

    import numpy as np
    import torch

    from ytklearn_tpu_torch import cli
    from ytklearn_tpu_torch.gbdt.data import GBDTIngest
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.scripts.bench_gbdt import gen_higgs_like

    train, test = gen_higgs_like(CLI_ROWS, CLI_TEST_ROWS, N_FEATURES,
                                 SEED + 6)
    rng = np.random.RandomState(SEED + 6)
    t0 = time.perf_counter()
    paths = {k: os.path.join(tmp, f"{k}.txt") for k in ("train", "test")}
    write_ytk_text(paths["train"], train.X, train.y, rng)
    write_ytk_text(paths["test"], test.X, test.y, rng)
    del train, test
    torch.cuda.empty_cache()
    model = os.path.join(tmp, "cli", "gbdt.model")
    argv = cli_train_argv(paths, model)
    print(f"cli train: wrote {CLI_ROWS} + {CLI_TEST_ROWS} text lines in "
          f"{time.perf_counter() - t0:.3f} s (host) [{card}]; python -m "
          f"ytklearn_tpu_torch.cli {' '.join(argv)}", flush=True)
    out = io.StringIO()
    zero_kernel_counts()  # count the main path's launches only
    with Recorder(GBDTIngest, "load") as ingest, \
            Recorder(GBDTTrainer, "train") as trained, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernel_counts()
    line = out.getvalue().strip().splitlines()[-1]
    print(f"cli train: rc {rc}, {wall:.3f} s [{card}]; {line}", flush=True)
    res = json.loads(line)
    trainer = trained.calls[0][0]
    ts = trainer.time_stats
    sync = [(r, t) for r, t in trainer.sync_log if r >= 3]
    tps = (sync[-1][0] - sync[0][0]) / (sync[-1][1] - sync[0][1])
    trees = res["trees"]
    print(f"cli train: parser {ts.get('parser')}; ingest "
          f"{ingest.calls[0][1]:.3f} s (parse + fill, host) beside "
          f"{CLI_INGEST_PYTHON_S} s with the Python parser (PERF.md section "
          f"5) [{card}]", flush=True)
    check(ts.get("parser") == "native",
          f"cli train parsed with the {ts.get('parser')} parser, not the "
          "native one (g++ is on this machine: nvcc needs it)")
    print(f"cli train: ingest {ingest.calls[0][1]:.3f} s (parse + fill, "
          f"host), preprocess {ts['preprocess']:.3f} s, rounds "
          f"{ts['train']:.3f} s, steady {tps:.4f} trees/s; precision "
          f"{trainer.hist_precision}, test AUC "
          f"{res['test_metrics']['auc']:.6f}, test loss "
          f"{res['test_loss']:.6f}; launches per tree: hist "
          f"{counts['hist'] / trees:.2f}, hist_gather "
          f"{counts['hist_gather'] / trees:.2f}, route "
          f"{counts['route'] / trees:.2f} (hist_q {counts['hist_q']}, "
          f"hist_gather_q {counts['hist_gather_q']}) [{card}]", flush=True)
    check(rc == 0 and trees == CLI_ROUNDS, f"cli train: rc {rc}, {res}")
    check(os.path.exists(model) and os.path.exists(model + ".bins.json"),
          "cli train wrote no model or no sidecar")
    check(trainer.hist_precision == "bf16", "cli train did not run bf16")
    check(all(counts[k] > 0 for k in ("hist", "hist_gather", "route"))
          and counts["hist_q"] == 0 and counts["hist_gather_q"] == 0,
          f"cli train did not run K1, K3 and K5 only: {counts}")
    check(0.5 < res["test_metrics"]["auc"] <= 1.0
          and res["train_loss"] < 0.69, f"cli train result {res}")
    return counts, model, tps, res


def serve_conf(model, tmp, name):
    conf = os.path.join(tmp, f"{name}.conf")
    with open(conf, "w") as f:
        f.write(f'model {{ data_path = "{model}" }}\n'
                "optimization { loss_function = sigmoid, round_num = 1000 }\n")
    return conf


def phase_serve_binned(tmp, model_path, card):
    """The model `cli train` just wrote, served on the binned rung (what
    `cli serve` starts, with YTK_SERVE_BINNED=1): edges mode from its
    sidecar, every score bit-equal to the port's CPU binned scorer; then,
    with the sidecar removed, thresholds mode bit-equal to the host tree
    walk."""
    import numpy as np

    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel
    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.serve import (
        BatchPolicy,
        CompiledScorer,
        ModelRegistry,
        ServeApp,
        kernels,
    )

    with open(model_path) as f:
        model = GBDTModel.loads(f.read())
    names = [f"f{i}" for i in range(N_FEATURES)]
    splits = split_values(model)
    conf = serve_conf(model_path, tmp, "binned")
    os.environ.pop("YTK_SERVE_FUSED", None)
    os.environ["YTK_SERVE_BINNED"] = "1"
    try:
        registry = ModelRegistry(device="cuda")
        entry = registry.load("default", "gbdt", hocon.load(conf))
    finally:
        os.environ.pop("YTK_SERVE_BINNED")
    info = entry.scorer.rung_info()
    print(f"serve binned: {len(model.trees)} trees of depth <= "
          f"{max(t.max_depth() for t in model.trees)}, rung "
          f"{json.dumps(info)} [{card}]", flush=True)
    check((info["mode"], info["backend"], info.get("bin_mode")) ==
          ("binned", "binned-cuda", "edges"), f"not binned on K7: {info}")
    cpu = CompiledScorer(create_predictor("gbdt", conf), mode="binned",
                         device="cpu")
    app = ServeApp(registry, BatchPolicy(max_batch=512, max_wait_ms=2.0),
                   host="127.0.0.1", port=0).start()
    rng = np.random.RandomState(SEED + 7)
    try:
        kernels.binned_walk.launches = 0  # count the main path's only
        lat = []
        one_rows = random_rows(rng, 200, names, splits)
        got = []
        for row in one_rows:
            t0 = time.perf_counter()
            got += post(app.port, {"features": row})["scores"]
            lat.append((time.perf_counter() - t0) * 1e3)
        batch = random_rows(rng, 512, names, splits)
        out = post(app.port, {"rows": batch})
        launches = kernels.binned_walk.launches
        profile_requests(app.port, random_rows(rng, 50, names, splits), card,
                         "binned")
    finally:
        app.stop(drain=True, timeout=30.0)
    rows = one_rows + batch
    got = np.asarray(got + out["scores"])
    want = cpu.score_batch(rows)
    p50 = statistics.median(lat)
    print(f"serve binned: 200 one-row requests + one of 512 rows, every "
          f"score bit-equal to the CPU binned scorer "
          f"{np.array_equal(got, want)}; one-row p50 {p50:.4f} ms (client "
          f"clock); binned_walk launches {launches} [{card}]", flush=True)
    check(np.array_equal(got, want), "binned rung differs from the CPU's")
    check(launches > 0, "the binned rung launched no binned_walk kernel")
    side = model_path + ".bins.json"
    os.rename(side, side + ".off")
    try:
        pred = create_predictor("gbdt", conf)
        th = CompiledScorer(pred, mode="binned", device="cuda")
        s = th.score_batch(rows)
        ok = np.array_equal(s, pred.batch_scores(rows))
    finally:
        os.rename(side + ".off", side)
    print(f"serve binned: without the sidecar, rung "
          f"{json.dumps(th.rung_info())}, scores bit-equal to "
          f"GBDTPredictor.batch_scores {ok} [{card}]", flush=True)
    check(th.rung_info()["bin_mode"] == "thresholds" and ok,
          "thresholds-mode binned scores differ from the host tree walk")
    return launches, p50


SERVE_OPS_THREADS = 8
SERVE_OPS_SECONDS = 10.0
SERVE_OPS_SWAP_S = 3.0
SERVE_OPS_WATCH_S = 0.5
SERVE_OPS_TRACE_SAMPLE = 0.05
SERVE_OPS_POOL = 2048  # rows a model; requests are slices of the pool
FLOOD_CLIENTS = 24  # concurrent 64-row requests against max_queue 4


def http_json(method, port, path, payload=None, timeout=60):
    """(status, headers, body) of one request; HTTP errors are answers."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def serve_ops_traffic(port, pools, deadline, swap_at, swap):
    """SERVE_OPS_THREADS clients POST 1-64-row requests until `deadline`,
    three in four to the fused model; the calling thread runs `swap()` at
    `swap_at`. Returns one record a request."""
    import numpy as np

    records = []
    lock = threading.Lock()
    errors = []

    def client(i):
        rng = np.random.RandomState(SEED + 100 + i)
        mine = []
        try:
            while time.perf_counter() < deadline:
                name = "default" if rng.rand() < 0.75 else "binned"
                pool = pools[name]
                n = int(rng.randint(1, 65))
                lo = int(rng.randint(0, len(pool) - n))
                t0 = time.perf_counter()
                status, _h, out = http_json("POST", port, "/predict",
                                            {"rows": pool[lo:lo + n],
                                             "model": name})
                t1 = time.perf_counter()
                if status != 200:
                    errors.append((status, out))
                    return
                mine.append({"model": name, "lo": lo, "n": n, "t0": t0,
                             "t1": t1, "version": out["version"],
                             "scores": out["scores"]})
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        with lock:
            records.extend(mine)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_OPS_THREADS)]
    for t in threads:
        t.start()
    time.sleep(max(0.0, swap_at - time.perf_counter()))
    t_swap = time.perf_counter()
    swap()
    for t in threads:
        t.join(timeout=120)
        check(not t.is_alive(), "a serve_ops client hung")
    check(not errors, f"serve_ops requests failed: {errors[:3]}")
    return records, t_swap


def spawn_cli_serve(args, env, err_path):
    """`python -m ytklearn_tpu_torch.cli serve *args` in a process of its
    own, its log to `err_path`; its banner is the first line it prints."""
    with open(err_path, "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "ytklearn_tpu_torch.cli", "serve", *args],
            env=env, stdout=subprocess.PIPE, stderr=err, text=True, cwd=REPO)


def start_cli_serve(args, env, err_path):
    """spawn_cli_serve, then its banner: (process, banner)."""
    proc = spawn_cli_serve(args, env, err_path)
    try:
        return proc, json.loads(proc.stdout.readline())
    except BaseException:
        stop_cli_serve(proc, err_path)
        raise


def stop_cli_serve(proc, err_path):
    """SIGTERM (the server's drain), then (exit code, the process's log,
    the warm_ms of each hot reload it logged)."""
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed after 60 s"
    proc.stdout.close()
    with open(err_path) as f:
        err_text = f.read()
    warm = [line.split("warmed in ")[1].split(" ms")[0]
            for line in err_text.splitlines() if "hot-reloaded" in line]
    return rc, err_text, warm


def cli_serve_launches(c, served_rows, what):
    """The kernel launches of a `cli serve` process on a kernel rung, from
    its /metrics counters: each scored batch (serve.scorer.batches; warm
    runs count apart, serve.scorer.warmup_rungs) is one launch of the
    rung's kernel. Held to the traffic: at least one, no fewer than the
    batcher's batches, no more batches than requests, and every row the
    clients were served scored once."""
    k = c.get("serve.scorer.batches", 0.0)
    b = c.get("serve.batches", 0.0)
    check(0 < b <= k and b <= c.get("serve.requests", 0.0),
          f"{what}: serve.scorer.batches {k}, serve.batches {b}, "
          f"serve.requests {c.get('serve.requests')}")
    check(c.get("serve.scorer.rows") == c.get("serve.request_rows")
          == served_rows, f"{what}: scored {c.get('serve.scorer.rows')} "
          f"rows, requested {c.get('serve.request_rows')}, the clients "
          f"were served {served_rows}")
    return int(k)


def serve_ops_fused(tmp, model, bconf, pools, host, card):
    """The `cli serve` process of phase_serve_ops on the fused rung (K6):
    phase_slice's model and, as --extra-model, the `cli train` model,
    under 8 clients with a hot reload, then /admin, /metrics and
    /admin/traces. Returns the K6 launches of its traffic."""
    import numpy as np

    from ytklearn_tpu_torch.scripts.time_walk import random_model

    names = [f"f{i}" for i in range(N_FEATURES)]
    conf = write_model(tmp, model, "ops")
    path = os.path.join(tmp, "ops.model")
    v2 = random_model(np.random.RandomState(SEED + 12), N_TREES, DEPTH,
                      names, base=0.4321)
    conf_v2 = write_model(tmp, v2, "ops_v2")
    host[("default", 1)] = create_host(conf)
    host[("default", 2)] = create_host(conf_v2)
    env = dict(os.environ, YTK_SERVE_FUSED="1", YTK_OBS="1",
               YTK_TRACE_SAMPLE=str(SERVE_OPS_TRACE_SAMPLE),
               PYTHONPATH=REPO)
    env.pop("YTK_SERVE_BINNED", None)
    err_path = os.path.join(tmp, "ops_serve.err")
    t0 = time.perf_counter()
    proc, banner = start_cli_serve(
        [conf, "gbdt", "--host", "127.0.0.1", "--port", "0",
         "--watch-interval", str(SERVE_OPS_WATCH_S),
         "--extra-model", f"binned:gbdt:{bconf}"], env, err_path)
    try:
        port = banner["port"]
        print(f"serve_ops: `cli serve` up in {time.perf_counter() - t0:.3f} "
              f"s, banner {json.dumps(banner)} [{card}]", flush=True)
        check("wall_t0" in banner and banner["rung"]["backend"] ==
              "fused-cuda", f"banner {banner}")

        def swap():
            tmp_text = path + ".next"
            with open(tmp_text, "w") as f:
                f.write(v2.dumps())
            os.replace(tmp_text, path)

        start = time.perf_counter()
        records, t_swap = serve_ops_traffic(
            port, pools, start + SERVE_OPS_SECONDS,
            start + SERVE_OPS_SWAP_S, swap)
        wall = time.perf_counter() - start
        # every response against the host walk of the version it names:
        # a row's score does not depend on its request, so each version
        # walks its pool once and every response is held to its slice
        for key in sorted({(r["model"], r["version"]) for r in records}):
            check(key in host, f"a response named {key}")
            want = host[key].batch_scores(pools[key[0]])
            mine = [r for r in records if (r["model"], r["version"]) == key]
            got = np.asarray([s for r in mine for s in r["scores"]])
            check(np.array_equal(got, np.concatenate(
                [want[r["lo"]:r["lo"] + r["n"]] for r in mine])),
                  f"{key}: responses differ from the host GBDTPredictor")
        fused = [r for r in records if r["model"] == "default"]
        first_v2 = min((r["t1"] for r in fused if r["version"] == 2),
                       default=None)
        check(first_v2 is not None, "the fused model never reloaded")
        late_v1 = [r for r in fused if r["version"] == 1
                   and r["t0"] > first_v2]
        check(not late_v1, f"{len(late_v1)} v1 answers after v2 answered")
        lat = sorted((r["t1"] - r["t0"]) * 1e3 for r in records)
        served_rows = sum(r["n"] for r in records)
        p50 = statistics.median(lat)
        p99 = lat[min(len(lat) - 1, int(math.ceil(0.99 * len(lat))) - 1)]
        print(f"serve_ops: {len(records)} requests, {served_rows} rows in "
              f"{wall:.3f} s under {SERVE_OPS_THREADS} clients (1-64 rows, "
              f"3 in 4 fused); client-clock p50 {p50:.4f} ms, p99 "
              f"{p99:.4f} ms; v2 first answered {first_v2 - t_swap:.3f} s "
              f"after the swap; every response bit-equal to the host "
              f"GBDTPredictor of its version [{card}]", flush=True)

        # rollback pins and is undoable; unpin; an unknown name is a 404
        st, _h, out = http_json("POST", port, "/admin/rollback",
                                {"model": "default"})
        check(st == 200 and out["version"] == 1 and out["pinned"],
              f"first rollback {st} {out}")
        rows = pools["default"][:16]
        st, _h, out = http_json("POST", port, "/predict",
                                {"rows": rows, "model": "default"})
        check(st == 200 and out["version"] == 1 and np.array_equal(
            np.asarray(out["scores"]), host[("default", 1)].batch_scores(
                rows)), f"after the rollback: {st} version "
              f"{out.get('version')}")
        served_rows += len(rows)
        st, _h, out = http_json("POST", port, "/admin/rollback",
                                {"model": "default"})
        check(st == 200 and out["version"] == 2, f"second rollback {out}")
        st, _h, out = http_json("POST", port, "/admin/unpin",
                                {"model": "default"})
        check(st == 200 and out["pinned"] is False, f"unpin {st} {out}")
        st, _h, out = http_json("POST", port, "/admin/rollback",
                                {"model": "nope"})
        check(st == 404 and out["type"] == "unknown_model",
              f"rollback of an unknown name: {st} {out}")

        st, _h, m = http_json("GET", port, "/metrics?models=1&quality=1")
        check(st == 200, f"/metrics answered {st}")
        c = m["counters"]
        fams = m["model_metrics"]["models"]
        fam_requests = sum(f["counters"].get("requests", 0.0)
                           for f in fams.values())
        qual = m["quality"]["models"].get("binned@v1", {})
        psi = {k: v["psi"] for k, v in qual.get("features", {}).items()
               if "psi" in v}
        rungs = {n: e["rung"]["backend"] for n, e in m["models"].items()}
        batching = m["batching"].get("default", {})
        print(f"serve_ops: /metrics serve.reload {c.get('serve.reload')}, "
              f"serve.rollback {c.get('serve.rollback')}, serve.requests "
              f"{c.get('serve.requests')} (per-model sum {fam_requests}), "
              f"serve.batches {c.get('serve.batches')}, "
              f"serve.scorer.batches {c.get('serve.scorer.batches')}, "
              f"batching {json.dumps(batching)}, rungs {rungs}, binned "
              f"quality psi_max {qual.get('psi_max')} over "
              f"{qual.get('rows_sampled')} sampled rows, latency "
              f"{json.dumps(m['latency'])} (server clock) [{card}]",
              flush=True)
        check(c.get("serve.reload", 0) >= 1, "no serve.reload counted")
        check(c.get("serve.rollback") == 2, "serve.rollback != 2")
        check(batching.get("slo_ms") == 100.0 and batching.get(
            "max_batch") in banner["ladder"], f"AIMD block {batching}")
        # both models on K6: every scored batch of the traffic is a launch
        check(set(rungs.values()) == {"fused-cuda"}, f"rungs {rungs}")
        k6 = cli_serve_launches(c, served_rows, "fused `cli serve`")
        check(fam_requests == c.get("serve.requests"),
              "per-model requests do not sum to serve.requests")
        check(not qual.get("no_baseline", True) and psi,
              f"no PSI for the binned model: {qual}")
        st, _h, tr = http_json("GET", port, "/admin/traces")
        check(st == 200 and tr["exemplars"], "/admin/traces is empty")
        hops = {}
        for ex in tr["exemplars"]:
            for hop in ex["hops"]:
                hops.setdefault(hop["name"], []).append(hop["dur_ms"])
        hop_txt = ", ".join(
            f"{k} p50 {statistics.median(v):.4f} max {max(v):.4f}"
            for k, v in sorted(hops.items()))
        print(f"serve_ops: /admin/traces {len(tr['exemplars'])} exemplars "
              f"at sample {tr['sample']}; hop ms (server clock): {hop_txt} "
              f"[{card}]", flush=True)
    finally:
        rc, err_text, warm = stop_cli_serve(proc, err_path)
    print(f"serve_ops: SIGTERM drained, rc {rc}; reload warm_ms {warm} "
          f"(the watcher thread's build + warm of every rung); K6 launches "
          f"of the traffic {k6} (serve.scorer.batches) [{card}]", flush=True)
    check(rc == 0, f"cli serve exited {rc}: {err_text[-2000:]}")
    check(warm, "no hot reload logged")
    return k6


def create_host(conf):
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.predict import create_predictor

    return create_predictor("gbdt", hocon.load(conf))


def binned_on_cpu(conf):
    """The binned rung's plain version over the model files as they stand
    now: what a response of the binned rung must equal bit for bit."""
    from ytklearn_tpu_torch.serve import CompiledScorer

    return CompiledScorer(create_host(conf), mode="binned", device="cpu")


def serve_ops_binned(tmp, cli_model, pool, card):
    """The `cli train` model on the binned rung (K7) under `cli serve`, in a
    process of its own (the rung is one process-wide knob in both
    packages): its text is rewritten (new leaf values), then its bin-edge
    sidecar (the new text's digest), in the trainer's order. Each rewrite
    is one hot reload: v2 on thresholds (the sidecar names the old text,
    so the reload falls back to the ensemble's splits, bit-equal to the
    host GBDTPredictor), v3 on the new edges. Every response is held to
    the binned rung's plain version of the files of the version it names.
    Returns the K7 launches of its traffic."""
    import numpy as np

    from ytklearn_tpu_torch.gbdt.binning import model_text_digest
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel

    bdir = os.path.join(tmp, "ops_binned")
    os.makedirs(bdir)
    path = os.path.join(bdir, "m.model")
    for suffix in ("", ".bins.json", ".sketch.json"):
        if os.path.exists(cli_model + suffix):
            shutil.copy(cli_model + suffix, path + suffix)
    conf = serve_conf(path, tmp, "ops_binned_solo")
    want = {1: binned_on_cpu(conf)}
    check(want[1].bin_mode == "edges", "the `cli train` model's bin-edge "
          "sidecar does not pair with its text")
    with open(path) as f:
        v2 = GBDTModel.loads(f.read())
    for t in v2.trees:
        t.leaf_value = [0.75 * v for v in t.leaf_value]
    v2_text = v2.dumps()
    env = dict(os.environ, YTK_SERVE_BINNED="1", YTK_OBS="1",
               PYTHONPATH=REPO)
    env.pop("YTK_SERVE_FUSED", None)
    err_path = os.path.join(tmp, "ops_binned.err")
    t0 = time.perf_counter()
    proc, banner = start_cli_serve(
        [conf, "gbdt", "--host", "127.0.0.1", "--port", "0",
         "--watch-interval", str(SERVE_OPS_WATCH_S)], env, err_path)
    records, stages = [], []
    try:
        port = banner["port"]
        check(banner["rung"]["backend"] == "binned-cuda"
              and banner["rung"].get("bin_mode") == "edges",
              f"binned banner {banner}")
        print(f"serve_ops binned: `cli serve` up in "
              f"{time.perf_counter() - t0:.3f} s, rung "
              f"{json.dumps(banner['rung'])} [{card}]", flush=True)

        def stage(version, mode):
            """Wait for `version` to serve, then 8 requests of 1-64 rows;
            returns the seconds it took to answer."""
            t_wait = time.perf_counter()
            deadline = t_wait + 30.0
            while True:
                st, _h, m = http_json("GET", port, "/metrics")
                entry = m["models"]["default"] if st == 200 else {}
                if entry.get("version") == version:
                    break
                check(time.perf_counter() < deadline,
                      f"v{version} did not load: {st} {entry}")
                time.sleep(0.05)
            waited = time.perf_counter() - t_wait
            rung = entry["rung"]
            check((rung["backend"], rung.get("bin_mode")) ==
                  ("binned-cuda", mode), f"v{version} rung {rung}")
            rng = np.random.RandomState(SEED + 20 + version)
            for _ in range(8):
                n = int(rng.randint(1, 65))
                lo = int(rng.randint(0, len(pool) - n))
                st, _h, out = http_json("POST", port, "/predict",
                                        {"rows": pool[lo:lo + n]})
                check(st == 200, f"binned /predict answered {st}: {out}")
                records.append((out["version"], lo, n, out["scores"]))
            stages.append(f"v{version} {mode} after {waited:.3f} s")

        stage(1, "edges")
        with open(path + ".next", "w") as f:
            f.write(v2_text)
        os.replace(path + ".next", path)
        want[2] = create_host(conf)
        stage(2, "thresholds")
        with open(path + ".bins.json") as f:
            side = json.load(f)
        side["model_digest"] = model_text_digest(v2_text)
        with open(path + ".bins.json.next", "w") as f:
            json.dump(side, f)
        os.replace(path + ".bins.json.next", path + ".bins.json")
        want[3] = binned_on_cpu(conf)
        check(want[3].bin_mode == "edges", "the rewritten sidecar does not "
              "pair with the new text")
        stage(3, "edges")
        for version, scorer in sorted(want.items()):
            ref = (scorer.batch_scores(pool) if version == 2
                   else scorer.score_batch(pool))
            mine = [r for r in records if r[0] == version]
            check(len(mine) == 8 and all(
                np.array_equal(np.asarray(r[3]), ref[r[1]:r[1] + r[2]])
                for r in mine), f"binned v{version}: responses differ from "
                  "the binned rung's plain version of its files")
        st, _h, m = http_json("GET", port, "/metrics")
        c = m["counters"]
        check(c.get("serve.reload") == 2, f"binned serve.reload "
              f"{c.get('serve.reload')} (two rewrites)")
        served_rows = sum(r[2] for r in records)
        k7 = cli_serve_launches(c, served_rows, "binned `cli serve`")
    finally:
        rc, err_text, warm = stop_cli_serve(proc, err_path)
    print(f"serve_ops binned: {'; '.join(stages)}; 24 requests, "
          f"{served_rows} rows, each bit-equal to the binned rung's plain "
          f"version of its files (v2's to the host GBDTPredictor too); "
          f"reload warm_ms {warm}; K7 launches of the traffic {k7} "
          f"(serve.scorer.batches); SIGTERM rc {rc} [{card}]", flush=True)
    check(rc == 0, f"binned cli serve exited {rc}: {err_text[-2000:]}")
    check(len(warm) == 2, f"binned hot reloads logged: {warm}")
    return k7


def phase_serve_ops(tmp, model, cli_model, card):
    """`cli serve` as the JAX package runs it by default, on the card. The
    rung is one process-wide knob in both packages, so two processes:
    serve_ops_fused (phase_slice's 500-tree model and, as --extra-model,
    the model `cli train` wrote with its port-written `.sketch.json`, on
    K6, under 8 clients with a hot reload, rollback, pin and unpin,
    /metrics, /admin/traces and the SIGTERM drain) and serve_ops_binned
    (the `cli train` model on K7, reloaded on a rewrite of its text and
    then of its bin-edge sidecar). Then in this process both rungs side
    by side: a ServeApp with a 4096-row cache answers a repeat
    bit-identically without a launch, and one with max_queue 4 sheds a
    flood with a Retry-After. Every launch count is of its own traffic."""
    import numpy as np

    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel
    from ytklearn_tpu_torch.obs import quality as obs_quality
    from ytklearn_tpu_torch.obs.heartbeat import stop_history_sampler
    from ytklearn_tpu_torch.serve import (
        BatchPolicy,
        ModelRegistry,
        ServeApp,
        kernels,
    )

    names = [f"f{i}" for i in range(N_FEATURES)]
    rng = np.random.RandomState(SEED + 11)
    bconf = serve_conf(cli_model, tmp, "ops_binned")
    check(os.path.exists(cli_model + ".sketch.json"),
          "cli train wrote no .sketch.json beside its model")
    host = {("binned", 1): create_host(bconf)}
    with open(cli_model) as f:
        bsplits = split_values(GBDTModel.loads(f.read()))
    pools = {"default": random_rows(rng, SERVE_OPS_POOL, names,
                                    split_values(model)),
             "binned": random_rows(rng, SERVE_OPS_POOL, names, bsplits)}
    k6_cli = serve_ops_fused(tmp, model, bconf, pools, host, card)
    k7_cli = serve_ops_binned(tmp, cli_model, pools["binned"], card)

    # in this process: both rungs side by side, the cache, then the 429;
    # both registries are built (and warmed) before any count is read
    def both_rungs():
        registry = ModelRegistry(device="cuda")
        os.environ["YTK_SERVE_FUSED"] = "1"
        try:
            registry.load("default", "gbdt",
                          hocon.load(os.path.join(tmp, "ops_v2.conf")))
            os.environ["YTK_SERVE_BINNED"] = "1"
            registry.load("binned", "gbdt", hocon.load(bconf))
        finally:
            os.environ.pop("YTK_SERVE_FUSED", None)
            os.environ.pop("YTK_SERVE_BINNED", None)
        return registry

    cpu = binned_on_cpu(bconf)
    cached_reg, flood_reg = both_rungs(), both_rungs()
    app = ServeApp(cached_reg, BatchPolicy(max_batch=512, max_wait_ms=2.0),
                   host="127.0.0.1", port=0, slo_ms=100.0,
                   cache_rows=4096).start()
    try:
        rows = pools["binned"][:64]
        kernels.heap_walk.launches = 0
        kernels.binned_walk.launches = 0
        st, _h, a = http_json("POST", app.port, "/predict",
                              {"rows": rows, "model": "binned"})
        cold = (kernels.heap_walk.launches, kernels.binned_walk.launches)
        st2, _h, b = http_json("POST", app.port, "/predict",
                               {"rows": rows, "model": "binned"})
        warm = (kernels.heap_walk.launches, kernels.binned_walk.launches)
        m = app.metrics_payload()
        rungs = {n: e["rung"]["backend"] for n, e in m["models"].items()}
    finally:
        app.stop(drain=True, timeout=30.0)
    check(rungs == {"default": "fused-cuda", "binned": "binned-cuda"},
          f"rungs {rungs}")
    check(st == st2 == 200 and b.get("cached") is True
          and "cached" not in a and a["scores"] == b["scores"]
          and np.array_equal(np.asarray(a["scores"]), cpu.score_batch(rows)),
          "the cached repeat is not bit-identical to the cold answer")
    check(cold == (0, 1) and warm == cold, f"launches (heap_walk, "
          f"binned_walk): cold request {cold}, after the cached repeat "
          f"{warm}; want one K7 launch, then none")
    app = ServeApp(flood_reg, BatchPolicy(max_batch=512, max_wait_ms=2.0,
                                          max_queue=4),
                   host="127.0.0.1", port=0, slo_ms=100.0).start()
    shed, resets = [], []
    try:
        kernels.heap_walk.launches = 0
        kernels.binned_walk.launches = 0
        for _round in range(5):  # until the flood has shed
            def flood(i):
                for k in range(6):
                    lo = (64 * (6 * i + k)) % (len(pools["default"]) - 64)
                    try:
                        s, h, out = http_json(
                            "POST", app.port, "/predict",
                            {"rows": pools["default"][lo:lo + 64],
                             "model": "default" if k % 2 else "binned"})
                    except OSError:
                        # the listener's accept backlog (the stdlib's 5)
                        # overflowed: a refused connection, not an answer
                        resets.append(i)
                        continue
                    if s == 429:
                        shed.append(h.get("Retry-After"))
                    elif s != 200:
                        shed.append(f"status {s}: {out}")

            threads = [threading.Thread(target=flood, args=(i,))
                       for i in range(FLOOD_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            if shed:
                break
    finally:
        app.stop(drain=True, timeout=30.0)
        # the serving planes' process-wide threads, which a server leaves
        # running, end with the phase
        obs_quality.stop_quality_evaluator()
        stop_history_sampler()
    k6, k7 = kernels.heap_walk.launches, kernels.binned_walk.launches
    print(f"serve_ops: in process, rungs {rungs}; the cached repeat "
          f"bit-identical, launches (K6, K7) {cold} for the cold request "
          f"and none for the repeat; max_queue 4: {len(shed)} of "
          f"{FLOOD_CLIENTS * 6 * (_round + 1)} flood requests shed with "
          f"Retry-After {sorted(set(shed))} ({len(resets)} connections "
          f"refused at the accept backlog); the flood's launches heap_walk "
          f"{k6}, binned_walk {k7}; the `cli serve` processes' traffic K6 "
          f"{k6_cli}, K7 {k7_cli} [{card}]", flush=True)
    check(shed and all(str(v).isdigit() for v in shed),
          f"no 429 with an integer Retry-After: {shed[:4]}")
    check(k6 > 0 and k7 > 0, "the flood launched no serving kernel")
    return k6_cli, k7_cli


def phase_repro(card):
    """The small l2 configuration in bf16, twice on the card and once on
    the CPU: do the card's float atomics give the same trees run to run?"""
    import numpy as np

    from ytklearn_tpu_torch.config.params import (
        ApproximateSpec,
        GBDTParams,
        ModelParams,
    )
    from ytklearn_tpu_torch.gbdt.data import GBDTData
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    rng = np.random.RandomState(SEED)
    n, F = 65536, 8
    X = rng.randn(n, F).astype(np.float32)
    y = (1.5 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
         + rng.randn(n) * 0.3).astype(np.float32)
    names = [f"f{i}" for i in range(F)]
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_r_")
    runs = []
    try:
        for i, dev in enumerate(("cuda", "cuda", "cpu")):
            p = GBDTParams(
                round_num=5, max_depth=8, max_leaf_cnt=63,
                tree_grow_policy="loss", learning_rate=0.1,
                min_child_hessian_sum=10.0, loss_function="l2",
                eval_metric=["rmse"],
                approximate=[ApproximateSpec(max_cnt=255)],
                model=ModelParams(data_path=os.path.join(tmp, str(i)),
                                  dump_freq=0))
            res = GBDTTrainer(p, hist_precision="bf16", device=dev,
                              wave=16).train(
                GBDTData(X, y, np.ones(n, np.float32), n, names))
            runs.append(res)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def key(t):
        return (t.feat, t.left, t.right, t.slot, t.sample_cnt, t.split)

    def leaf_rel(xs, zs):
        """Largest relative leaf difference over the trees of the same
        structure."""
        rel = 0.0
        for x, z in zip(xs, zs):
            if key(x) == key(z):
                la, lz = np.asarray(x.leaf_value), np.asarray(z.leaf_value)
                rel = max(rel, float(np.max(np.abs(la - lz)
                                            / np.maximum(np.abs(lz), 1e-30))))
        return rel

    a, b, c = (r.model.trees for r in runs)
    same_card = sum(key(x) == key(y) for x, y in zip(a, b))
    same_leaves = sum(x.leaf_value == y.leaf_value for x, y in zip(a, b))
    differ = sum(key(x) != key(z) for x, z in zip(a, c))
    rel, rel_card = leaf_rel(a, c), leaf_rel(a, b)
    losses = [np.asarray([r["train_loss"] for r in res.round_log])
              for res in runs]
    loss_rel = max(float(np.max(np.abs(la - losses[2]) / losses[2]))
                   for la in losses[:2])
    identical = same_card == same_leaves == len(a)
    print(f"repro: l2 bf16, {n} rows x {F} features, {len(a)} trees, wave "
          f"16: two card runs give identical trees {identical} (structure "
          f"equal in {same_card}, leaf values equal in {same_leaves} of "
          f"{len(a)} trees; largest relative leaf difference {rel_card:.3e}"
          f"); {differ} of {len(a)} trees differ in structure between card "
          f"and CPU; largest relative leaf difference card/CPU "
          f"(same-structure trees) {rel:.3e}; largest relative train-loss "
          f"difference {loss_rel:.3e} [{card}]", flush=True)
    check(loss_rel <= 1e-4, f"bf16 card and CPU losses differ: {losses}")
    return identical, differ, rel


def phase_float_timings(trainer, card):
    """K1 and K3 at the full-width bf16 training shapes: one 64-slot
    full-scan wave over every training row, and the first fused rung."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    dd_bins = trainer.dev_inputs.bins_t  # (28, n_pad) u8 training bins
    F, n = dd_bins.shape
    B, M = trainer.grow_spec.B, trainer.grow_spec.max_nodes
    N = trainer.grow_spec.wave
    bf16 = trainer.grow_spec.use_bf16
    pos = torch.randint(0, 2 * N + 1, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    g = torch.randn((n,), generator=gen, device="cuda") * 0.5
    h = torch.rand((n,), generator=gen, device="cuda") * 0.25
    ids = torch.arange(1, 2 * N + 1, 2, device="cuda", dtype=torch.int32)
    flat = torch.zeros(N * F * B * 3, dtype=torch.float32, device="cuda")
    out = {}

    def run(name, fn, plain, lib, bound, iters):
        hist_err(fn(), plain(), "at the timing shape", name, card)
        ms = cuda_ms(fn, iters=iters)
        plain_ms = cuda_ms(plain, iters=1, repeats=3)
        lib_ms = cuda_ms(lib, iters=3, repeats=3)
        out[name] = (ms, plain_ms, bound[0], bound[1], lib_ms)
        print(f"timing: {name} ({'bf16' if bf16 else 'f32'}) {ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms, one f32 scatter_add_ {lib_ms:.6f} "
              f"ms, bound {bound[0]:.6f} ms ({bound[1]}) [{card}]",
              flush=True)

    keys, vals = flat_keys(lambda f, r: dd_bins[f, r], F, B, pos, g, h, ids,
                           M, bf16=bf16)
    run("hist", lambda: hist.hist_wave(dd_bins, pos, g, h, ids, B,
                                       max_nodes=M, use_bf16=bf16),
        lambda: hist.hist_wave_plain(dd_bins, pos, g, h, ids, B, M, bf16),
        lambda: flat.zero_().scatter_add_(0, keys, vals),
        hist_bound_ms(dd_bins, False, None, pos, ids, M, B), iters=10)
    del keys, vals
    rows = dd_bins.t().contiguous()
    R = -(-(n // 64) // 1024) * 1024
    idx, pg, gg, hg = compacted(pos, g, h, ids, R, 0.05, gen)
    keys, vals = flat_keys(lambda f, r: rows[idx[r].long(), f], F, B, pg,
                           gg, hg, ids, M, bf16=bf16)
    run("hist_gather",
        lambda: hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, B,
                                      mode="mxu", max_nodes=M,
                                      use_bf16=bf16),
        lambda: hist.hist_gather_plain(rows, idx, pg, gg, hg, ids, B, M,
                                       bf16),
        lambda: flat.zero_().scatter_add_(0, keys, vals),
        hist_bound_ms(rows, True, idx, pg, ids, M, B), iters=20)
    return out


#: the waves of the width phase, and bf16 bench trees/s with the kernels
#: K1/K3 had before their redesign (PERF.md section 5, same cell, NVIDIA
#: H100 80GB HBM3 at 700 W)
FLOAT_WAVES = (1, 2, 8, 16, 32, 42, 64)
BF16_TPS_BEFORE = 8.7082


def phase_float_widths(trainer, card):
    """K1 over every bench row and K3 at the first fused rung (R = n/64),
    on waves of FLOAT_WAVES slots (positions over 2N+1 nodes, the wave the
    odd ids), each held against its plain version first, then timed beside
    one f32 scatter_add_ of the same sums and its bound, with the plan
    float_plan took. Returns the largest g/h error."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    dd_bins = trainer.dev_inputs.bins_t
    F, n = dd_bins.shape
    B = trainer.grow_spec.B
    rows = dd_bins.t().contiguous()
    R = -(-(n // 64) // 1024) * 1024
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.randn((n,), generator=gen, device="cuda") * 0.5
    h = torch.rand((n,), generator=gen, device="cuda") * 0.25
    err = 0.0
    for N in FLOAT_WAVES:
        M = 2 * N + 1
        pos = torch.randint(0, M, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids = torch.arange(1, M, 2, device="cuda", dtype=torch.int32)
        idx, pg, gg, hg = compacted(pos, g, h, ids, R, 0.05, gen)
        for name, fn, plain, keys_of, bound, plan, iters in (
            ("hist", lambda: hist.hist_wave(dd_bins, pos, g, h, ids, B,
                                            max_nodes=M),
             lambda: hist.hist_wave_plain(dd_bins, pos, g, h, ids, B, M),
             lambda: flat_keys(lambda f, r: dd_bins[f, r], F, B, pos, g, h,
                               ids, M, bf16=True),
             lambda: hist_bound_ms(dd_bins, False, None, pos, ids, M, B),
             hist.float_plan(N, F, B, M, n, sm), 10),
            ("hist_gather",
             lambda: hist.hist_wave_gather_mxu(rows, idx, pg, gg, hg, ids, B,
                                               max_nodes=M),
             lambda: hist.hist_gather_plain(rows, idx, pg, gg, hg, ids, B,
                                            M),
             lambda: flat_keys(lambda f, r: rows[idx[r].long(), f], F, B,
                               pg, gg, hg, ids, M, bf16=True),
             lambda: hist_bound_ms(rows, True, idx, pg, ids, M, B),
             hist.float_plan(N, F, B, M, R, sm, True), 50),
        ):
            what = (f"at the width phase's N = {N} "
                    f"({'n' if name == 'hist' else 'R'} = "
                    f"{n if name == 'hist' else R}), bf16")
            err = max(err, hist_err(fn(), plain(), what, name, card))
            ms = cuda_ms(fn, iters=iters)
            keys, vals = keys_of()
            flat = torch.zeros(N * F * B * 3, dtype=torch.float32,
                               device="cuda")
            lib_ms = cuda_ms(lambda: flat.zero_().scatter_add_(0, keys, vals),
                             iters=3, repeats=3)
            del keys, vals, flat
            b_ms, b_by = bound()
            print(f"width: {name} N = {N} {ms:.6f} ms, one f32 scatter_add_ "
                  f"{lib_ms:.6f} ms (ratio {ms / lib_ms:.3f}), bound "
                  f"{b_ms:.6f} ms ({b_by}), plan {plan['kind']} "
                  f"{plan['ng']} x {plan['fg']}, {plan['n_tiles']} tiles x "
                  f"{plan['n_chunks']} chunks of {plan['rows_per_chunk']} "
                  f"rows, {plan['threads']} threads [{card}]", flush=True)
        del idx, pg, gg, hg
    print(f"phase float widths: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err


def binned_bound_ms(bins, packed, depth, LL):
    """K7's bound from this call's inputs: the bins some row looks up (1 or
    2 B each), each packed slot some row visits (4 B), each leaf some row
    reaches (8 B), read once, and the scores written once; operations, the
    compares and f64 adds, over the FP64 rate."""
    import torch

    from ytklearn_tpu_torch.serve import kernels

    B, F = bins.shape
    T, H = packed.shape
    rows = torch.arange(B, device=bins.device)[:, None]
    tids = torch.arange(T, device=bins.device)[None, :]
    pos = torch.zeros((B, T), dtype=torch.long, device=bins.device)
    slots, cells = [], []
    bw = bins.long()
    for _ in range(depth):
        fv, rank1, dl = kernels.unpack_nodes(packed[tids, pos])
        slots.append((tids * H + pos).flatten())
        cells.append((rows * F + fv).flatten())
        vv = bw[rows, fv]
        go_left = torch.where(vv == (255 if bins.element_size() == 1
                                     else 65535), dl > 0, vv < rank1)
        pos = 2 * pos + 2 - go_left.long()

    def distinct(parts):
        return int(torch.unique(torch.cat(parts)).numel())

    nbytes = (distinct(cells) * bins.element_size() + distinct(slots) * 4
              + distinct([(tids * LL + pos - (LL - 1)).flatten()]) * 8
              + B * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * T * (depth + 1) / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_binned_timing(served_model_path, model500, card):
    """K7 at every ladder rung on the model the binned rung served (the
    main path's shape), and on the 500-tree model beside K6, timed as K6
    (a call's time, and the kernel's device time beside it); returns the
    served model's rung 512, the kernels line's row."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.gbdt.tree import GBDTModel
    from ytklearn_tpu_torch.gbdt.binning import bin_edges_path, \
        load_bin_edges, model_text_digest
    from ytklearn_tpu_torch.io.fs import LocalFileSystem
    from ytklearn_tpu_torch.scripts.time_walk import kernel_ms
    from ytklearn_tpu_torch.serve import kernels

    with open(served_model_path) as f:
        text = f.read()
    served = GBDTModel.loads(text)
    edges = load_bin_edges(LocalFileSystem(),
                           bin_edges_path(served_model_path),
                           model_text_digest(text))
    rng = np.random.RandomState(SEED + 9)
    out = {}
    for label, model, table_of in (
            ("served", served, lambda vocab, heap: kernels.build_bin_table(
                served.trees, vocab, edges)[0]),
            ("500-tree", model500, None)):
        if table_of is None:
            vocab, heap, table, _ = binned_tables(model)
        else:
            used = sorted({t.feat_name[i] for t in model.trees
                           for i in range(t.n_nodes()) if not t.is_leaf(i)})
            vocab = {n: i for i, n in enumerate(used)}
            heap, why = kernels.build_heap(model.trees, vocab)
            check(heap is not None, why)
            table = table_of(vocab, heap)
        for B in LADDER:
            rows = random_rows(rng, B, list(vocab), split_values(model))
            X = np.full((B, len(vocab)), np.nan)
            for i, r in enumerate(rows):
                for k, v in r.items():
                    if k in vocab:
                        X[i, vocab[k]] = v
            bins, packed, leaf = binned_inputs(heap, table, X)
            mf = int(heap.feat.max())

            def fn():
                return kernels.binned_walk(bins, packed, leaf, heap.depth,
                                           table.sentinel, max_feat=mf)

            def plain():
                return kernels.binned_walk_plain(bins, packed, leaf,
                                                 heap.depth, table.sentinel)

            got, want = fn(), plain()
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"binned_walk disagrees ({label}, rung {B})")
            ms = cuda_ms(fn, iters=50)
            device_ms = kernel_ms(torch.device("cuda"), fn, 50)
            plain_ms = cuda_ms(plain, iters=3, repeats=5)
            bound = binned_bound_ms(bins, packed, heap.depth,
                                    heap.leaf.shape[1])
            out[label, B] = (ms, plain_ms, bound[0], bound[1], device_ms)
            print(f"timing: binned_walk rung {B}, {label} model "
                  f"({heap.feat.shape[0]} padded trees, depth {heap.depth}, "
                  f"{table.mode} {table.dtype} table): a call {ms:.6f} ms, "
                  f"kernel {fmt_kernel(device_ms)} (device), plain "
                  f"{plain_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}); "
                  f"no single PyTorch call computes it [{card}]", flush=True)
    return out["served", LADDER[-1]]


# -- slice 4: K8 and the histogram tuning tools --------------------------------

#: published H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
#: K8 against its plain version: (N, fg, rows_per_block) at F = 28, B = 256
#: over a ragged n
U8_SHAPES = ((1, None, None), (7, 2, 4096), (32, None, None),
             (64, 4, 20000))
U8_ROWS = 200_003
#: wave widths of the K8 / K2 comparison at the tune shape
U8_WAVES = (1, 4, 8, 16, 32, 64)


def mma_floor_ms(N, F, B, n):
    """K8's tensor-core floor: the int8 operations of its padded product,
    2 * 16 ceil(3N/16) * 8 ceil(B/8) * n * F, over the dense int8 rate."""
    ops = 2 * 16 * -(-3 * N // 16) * 8 * -(-B // 8) * n * F
    return ops / INT8_OPS_PER_S * 1e3


def phase_u8_kernels(card):
    """K8 against its plain version (exact) at the U8_SHAPES, on a wave
    with a duplicated id and pads, and against K2 in K8's layout."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    err = 0.0
    cases = [(N, fg, rows, False) for N, fg, rows in U8_SHAPES]
    cases.append((64, None, None, True))
    cases.append((100, None, None, True))  # 3N > 256: two n-tiles of PV
    for N, fg, rows, dup in cases:
        bins, pos, gq, hq, ids, M = rand_hist_inputs(
            gen, N_FEATURES, U8_ROWS, 256, N, "u8")
        if dup:
            dup_ids(ids)
        got = hist.hist_q_u8(bins, pos, gq, hq, ids, 256, fg=fg,
                             rows_per_block=rows)
        want = hist.hist_q_u8_plain(bins, pos, gq, hq, ids, 256)
        k2 = hist.hist_wave_q(bins, pos, gq, hq, ids, 256, max_nodes=M)
        torch.cuda.synchronize()
        e = float((got.long() - want.long()).abs().max())
        err = max(err, e)
        ok = torch.equal(got, want)
        same_k2 = torch.equal(got, k2.permute(1, 3, 0, 2).reshape(
            N_FEATURES, 3 * N, 256))
        what = (f"(N, F, n, B) = ({N}, {N_FEATURES}, {U8_ROWS}, 256), fg "
                f"{fg or 'default'}, rows/block {rows or 'default'}"
                + (f", a duplicated id (slots 1 and {N - 1}) and pads"
                   if dup else ""))
        print(f"kernel check hist_q_u8 {what}, tolerance exact "
              f"(torch.equal): {ok}, equals K2 permuted {same_k2}, "
              f"max_abs_err {e} [{card}]", flush=True)
        check(ok and same_k2, f"hist_q_u8 disagrees at {what}")
        if dup:
            check(all(torch.equal(got[:, c * N + 1], got[:, c * N + N - 1])
                      for c in range(3)) and bool(got[:, 2 * N + 1].any()),
                  "hist_q_u8: the duplicated id's slots differ")
    print(f"phase u8 kernels: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err


def phase_tools(card):
    """The tuning tools in this process, as `python -m
    ytklearn_tpu_torch.scripts.<tool>` runs them: the main path of slice 4.
    Every launch count is zeroed just before the tools and read just after
    them: tune_hist_kernel runs K1, K2 and K8, micro_hist_gather K2 and K4,
    tune_gbdt K2, K4 and K5."""
    from ytklearn_tpu_torch.scripts import (
        micro_hist_gather,
        tune_gbdt,
        tune_hist_kernel,
    )

    for name, mod, argv in (
        ("tune_hist_kernel", tune_hist_kernel, []),
        ("micro_hist_gather", micro_hist_gather, ["--divs", "8,64",
                                                  "--repeats", "3"]),
        ("tune_gbdt", tune_gbdt, ["--rows", str(1 << 21), "--trees", "6",
                                  "--configs", "32:int8,64:int8"]),
    ):
        t0 = time.perf_counter()
        if name == "tune_hist_kernel":
            zero_kernel_counts()  # count the main path's launches only
        rc = mod.main(argv)
        print(f"phase tool {name} {' '.join(argv)}: rc {rc}, "
              f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        check(rc == 0, f"{name} exited {rc}")
    counts = kernel_counts()
    ran = ("hist", "hist_q", "hist_gather_q", "route", "hist_q_u8")
    print(f"tools: launches over the three tools: "
          f"{', '.join(f'{k} {counts[k]}' for k in ran)} [{card}]",
          flush=True)
    check(all(counts[k] > 0 for k in ran),
          f"the tools did not launch each of their kernels: {counts}")
    return counts["hist_q_u8"]


def phase_u8_timing(card):
    """K8 at the reference's tune shape (its data): exact against its plain
    version and K2, timed beside its bytes bound (hist_bound_ms, counted as
    K2's), its tensor-core floor, its plain version and one scatter_add_."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist
    from ytklearn_tpu_torch.scripts import tune_hist_kernel as tk

    t0 = time.perf_counter()
    n, F, B, N, M = tk.ROWS, tk.F, tk.B, tk.N, tk.SPREAD
    bins, pos, _, _, gq, hq, ids = tk.make_data(n, torch.device("cuda"))

    def fn():
        return hist.hist_q_u8(bins, pos, gq, hq, ids, B)

    def plain():
        return hist.hist_q_u8_plain(bins, pos, gq, hq, ids, B)

    got, want = fn(), plain()
    k2 = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M)
    torch.cuda.synchronize()
    err = float((got.long() - want.long()).abs().max())
    ok = torch.equal(got, want)
    same_k2 = torch.equal(got, k2.permute(1, 3, 0, 2).reshape(F, 3 * N, B))
    print(f"kernel check hist_q_u8 at the tune shape (n, F, B, N) = ({n}, "
          f"{F}, {B}, {N}), tolerance exact (torch.equal): {ok}, equals K2 "
          f"permuted {same_k2}, max_abs_err {err} [{card}]", flush=True)
    check(ok and same_k2, "hist_q_u8 disagrees at the tune shape")
    del got, want, k2
    keys, vals = flat_keys(lambda f, r: bins[f, r], F, B, pos, gq, hq, ids, M)
    flat = torch.zeros(N * F * B * 3, dtype=torch.int32, device="cuda")
    ms = cuda_ms(fn, iters=5)
    plain_ms = cuda_ms(plain, iters=1, repeats=3)
    lib_ms = cuda_ms(lambda: flat.zero_().scatter_add_(0, keys, vals),
                     iters=3, repeats=3)
    del keys, vals
    bound, bound_by = hist_bound_ms(bins, False, None, pos, ids, M, B)
    floor = mma_floor_ms(N, F, B, n)
    k2_ms = cuda_ms(lambda: hist.hist_wave_q(bins, pos, gq, hq, ids, B,
                                             max_nodes=M), iters=5)
    plan = hist.u8_plan(N, F, B, n, torch.cuda.get_device_properties(0)
                        .multi_processor_count)
    print(f"timing: hist_q_u8 (default plan W {plan['W']}, fg "
          f"{plan['fg']}, {plan['rows_per_block']} rows a chunk, "
          f"{plan['items']} items over {plan['blocks']} blocks) "
          f"{ms:.6f} ms, plain {plain_ms:.6f} ms, one scatter_add_ "
          f"{lib_ms:.6f} ms, bound {bound:.6f} ms ({bound_by}), "
          f"mma_floor_ms {floor:.6f}; K2 at the same inputs {k2_ms:.6f} ms "
          f"[{card}]", flush=True)
    # where, if anywhere, the one-hot product wins: K8 and K2 at their
    # default plans on waves of N slots holding every row (the root wave
    # at N = 1), positions folded from the tune data
    for Nw in U8_WAVES:
        pw = (pos % Nw).contiguous()
        iw = torch.arange(Nw, dtype=torch.int32, device="cuda")
        a = cuda_ms(lambda: hist.hist_q_u8(bins, pw, gq, hq, iw, B), iters=3)
        b = cuda_ms(lambda: hist.hist_wave_q(bins, pw, gq, hq, iw, B,
                                             max_nodes=Nw), iters=3)
        print(f"timing: wave of {Nw} slots holding all {n} rows: hist_q_u8 "
              f"{a:.6f} ms (mma_floor_ms {mma_floor_ms(Nw, F, B, n):.6f}), "
              f"hist_q {b:.6f} ms, ratio {a / b:.3f} [{card}]", flush=True)
    print(f"phase u8 timing: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err, (ms, plain_ms, bound, bound_by, lib_ms)


# -- slice 10: the convex stack ------------------------------------------------

CONVEX_SEED = 1010
#: (data, family, train lines, write_convex_case keywords)
CONVEX_DATA = (
    ("linear", "linear", 1 << 16, dict(vocab=50000, nnz=12)),
    ("multiclass", "multiclass_linear", 1 << 15,
     dict(vocab=200, nnz=10, K=5)),
    ("fm", "fm", 1 << 16, dict(vocab=20000, nnz=16, k=8)),
    ("ffm", "ffm", 1 << 15, dict(vocab=2000, nnz=12, n_fields=8, k=4)),
)
#: (run, data, l1, l2, max_iter, hyper block)
CONVEX_RUNS = (
    ("linear OWL-QN", "linear", 1e-5, 1e-4, 15, None),
    ("linear grid", "linear", 0.0, 1e-4, 8,
     {"switch_on": True, "mode": "grid", "grid": {"l2": [1e-4, 1e-3]}}),
    ("multiclass_linear softmax K=5", "multiclass", 0.0, 0.01, 15, None),
    ("fm k=[1,8]", "fm", 0.0, 1e-3, 12, None),
    ("ffm 8 fields", "ffm", 0.0, 1e-3, 15, None),
    ("linear hoag", "linear", 0.0, 1e-4, 8,
     {"switch_on": True, "mode": "hoag",
      "hoag": {"l2": [1e-3], "outer_iter": 2}}),
)
CONVEX_RTOL = 1e-4  # tests/test_torch_hoag_train.py's tolerances


def convex_cli(cfg, family, device, tag, tmp):
    """`cli train <family>` in this process -> (JSON line, TrainResult,
    the trainer's time_stats)."""
    import contextlib
    import io

    from ytklearn_tpu_torch import cli
    from ytklearn_tpu_torch import train as ptrain

    c = json.loads(json.dumps(cfg))
    c["model"]["data_path"] = os.path.join(tmp, f"{tag}_{device}", "model")
    conf = os.path.join(tmp, f"{tag}_{device}.conf")
    with open(conf, "w") as f:
        json.dump(c, f)
    got = []
    real = ptrain.HoagTrainer.train

    def train(self, *a, **kw):
        res = real(self, *a, **kw)
        got.append((res, dict(self.time_stats)))
        return res

    ptrain.HoagTrainer.train = train
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["train", family, conf, "--device", device])
    finally:
        ptrain.HoagTrainer.train = real
    check(rc == 0 and len(got) == 1, f"cli train {family} on {device}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), *got[0]


def launch_counts():
    """Every kernel wrapper's launch count."""
    from ytklearn_tpu_torch.gbdt import hist, route
    from ytklearn_tpu_torch.serve import kernels

    fns = (hist.hist_wave, hist.hist_wave_gather, hist.hist_wave_q,
           hist.hist_wave_gather_mxu, hist.hist_q_u8, route.route_wave,
           kernels.heap_walk, kernels.binned_walk)
    return [f.launches for f in fns]


def phase_convex_cli(card, tmp):
    """Slice 10's main path: `cli train` for linear (OWL-QN, grid, HOAG),
    multiclass_linear, FM and FFM on seeded synthetic files, on the card
    and on the CPU; each card run held to its CPU run (status and
    iterations equal, the first 5 iterations' and the final avg loss at
    rtol 1e-4, test AUC within 1e-4). The path launches no kernel of the
    port: every wrapper's count stays where it was. Returns the card
    configs of the first run of each family (their dumps stay in `tmp`
    for phase_serve_families)."""
    from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case

    models = {}
    base = {}
    lines = [(name, n) for name, _, n, _ in CONVEX_DATA]
    for name, family, n, kw in CONVEX_DATA:
        base[name] = (family, write_convex_case(
            os.path.join(tmp, name), family, n, n // 8, CONVEX_SEED,
            **kw))
    before = launch_counts()
    for i, (run, data, l1, l2, iters, hyper) in enumerate(CONVEX_RUNS):
        family, cfg = base[data]
        cfg = json.loads(json.dumps(cfg))
        cfg["loss"]["evaluate_metric"] = ["auc"]
        cfg["loss"]["regularization"] = {"l1": [l1], "l2": [l2]}
        conv = cfg["optimization"]["line_search"]["lbfgs"]["convergence"]
        conv["max_iter"], conv["eps"] = iters, 1e-7
        if hyper:
            cfg["hyper"] = hyper
        tag = f"run{i}"
        line, res, ts = convex_cli(cfg, family, "cuda", tag, tmp)
        _, cres, cts = convex_cli(cfg, family, "cpu", tag, tmp)
        if family not in models:
            models[family] = json.loads(json.dumps(cfg))
            models[family]["model"]["data_path"] = os.path.join(
                tmp, f"{tag}_cuda", "model")
        auc, cauc = res.test_metrics["auc"], cres.test_metrics["auc"]
        check(ts.get("parser") == cts.get("parser") == "native",
              f"{run}: parsers {ts.get('parser')}/{cts.get('parser')}, "
              "not native")
        print(f"convex cli {run} ({family}, {dict(lines)[data]} "
              f"lines, {ts['parser']} parser): n_iter {res.n_iter}, "
              f"status {res.status}, "
              f"avg_loss {res.avg_loss:.6f} (cpu {cres.avg_loss:.6f}), "
              f"test AUC {auc:.6f} (cpu {cauc:.6f}); ingest "
              f"{ts['load']:.3f} s against training {ts['train']:.3f} s "
              f"(cpu: {cts['load']:.3f} s, {cts['train']:.3f} s) "
              f"[{card}]", flush=True)
        check(line["model"] == family and line["n_iter"] == res.n_iter,
              f"{run}: JSON line {line}")
        check((res.status, res.n_iter) == (cres.status, cres.n_iter),
              f"{run}: card {res.status}/{res.n_iter}, cpu "
              f"{cres.status}/{cres.n_iter}")
        h = [r["avg_loss"] for r in res.history[:6]]
        ch = [r["avg_loss"] for r in cres.history[:6]]
        for a, b in zip(h + [res.avg_loss], ch + [cres.avg_loss]):
            check(abs(a - b) <= CONVEX_RTOL * abs(b),
                  f"{run}: avg loss card {h} {res.avg_loss}, cpu {ch} "
                  f"{cres.avg_loss}")
        check(abs(auc - cauc) <= 1e-4, f"{run}: AUC {auc} vs {cauc}")
        check(math.isfinite(res.avg_loss) and res.n_iter >= 5
              and auc > 0.6, f"{run}: did not train ({res.status})")
    check(launch_counts() == before,
          "a kernel wrapper launched on the convex path")
    return models


def phase_bench_fm(card):
    """scripts/bench_fm.py in this process at its default size (bench.py's
    FM cell): examples/s and loss, the peak memory, two traced L-BFGS
    iterations (idle share, top device ops), the loss falling over
    accepted iterations, and whether two trainings dump byte-identical
    model texts (the gather's backward accumulates on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ytklearn_tpu_torch.io.fs import LocalFileSystem
    from ytklearn_tpu_torch.scripts import bench_fm
    from ytklearn_tpu_torch.scripts._common import device_busy

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    cell = bench_fm.Cell(bench_fm.cell_rows(), dev)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    rec = bench_fm.measure(cell, card)
    peak = torch.cuda.max_memory_allocated(dev)
    print(json.dumps(rec), flush=True)
    print(f"bench_fm: {rec['rows']} rows, row chunk {rec['row_chunk']}, "
          f"{rec['fm_examples_per_sec']:.1f} examples/s, fm_loss "
          f"{rec['fm_loss']:.6f}, {rec['n_iter']} iterations in "
          f"{rec['seconds']:.6f} s; data and model set-up {setup_s:.3f} s "
          f"(host); peak memory {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated) [{card}]", flush=True)
    check(math.isfinite(rec["fm_loss"]) and rec["n_iter"] == 12,
          f"bench_fm: {rec}")

    class Trace:
        """Profiles iterations 1 and 2 (from the callback after the first
        evaluation to the one after the second iteration)."""

        def __call__(self, it, st):
            if it == 0:
                torch.cuda.synchronize(dev)
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            elif it == 2:
                torch.cuda.synchronize(dev)
                self.wall_ms = (time.perf_counter() - self.t0) * 1e3
                self.prof.__exit__(None, None, None)
            return False

    tr = Trace()
    cell.run(2, callback=tr)
    busy_ms, top = device_busy(tr.prof, 8)
    check(busy_ms > 0, "the profiler saw no device time in bench_fm")
    print(f"bench_fm profile: 2 L-BFGS iterations (traced), wall "
          f"{tr.wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / tr.wall_ms:.4f}; top device ops: "
          f"{fmt_top(top, 48)} [{card}]", flush=True)

    losses = []
    runs = [cell.run(12, callback=lambda it, st: losses.append(
        (st.loss, st.ls_status)) and False), cell.run(12)]
    acc = [loss for loss, status in losses if status > 0]
    check(all(b <= a for a, b in zip(acc, acc[1:])),
          f"bench_fm: the loss rose over accepted iterations: {losses}")
    fmap = {f"f{i}": i for i in range(bench_fm.DIM)}
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_fm_")
    texts = []
    try:
        for i, res in enumerate(runs):
            cell.model.params.model.data_path = os.path.join(tmp, f"m{i}")
            cell.model.dump_model(LocalFileSystem(), res.w.cpu().numpy(),
                                  None, fmap)
            with open(os.path.join(tmp, f"m{i}", "model-00000"), "rb") as f:
                texts.append(f.read())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same_w = torch.equal(runs[0].w, runs[1].w)
    print(f"bench_fm repeat: two 12-iteration trainings give "
          f"{'byte-identical' if texts[0] == texts[1] else 'different'} "
          f"dumps ({len(texts[0])} bytes; weights "
          f"{'bit-equal' if same_w else 'not bit-equal'}; losses "
          f"{runs[0].loss!r}, {runs[1].loss!r}) [{card}]", flush=True)
    return rec


# -- slice 11: softmax, l1 with the approximate LAD, continue_train, the
# native parser ---------------------------------------------------------------

SOFTMAX_ROWS = 1 << 19
SOFTMAX_TEST_ROWS = 1 << 16
SOFTMAX_ROUNDS = 10
SOFTMAX_K = 7
SOFTMAX_SEED = 20261017
#: the test accuracy the card's softmax run must pass: the same
#: configuration and generator on 2^16 + 2^14 lines reached 0.6420 on the
#: CPU (PERF.md section 6); more training rows only help
SOFTMAX_ACC_FLOOR = 0.60
#: rows of the host tree walk the stacked rung's scores are held to
SOFTMAX_HOST_ROWS = 2048
OBJ_ROWS = 1 << 16
N_FEATURES_L1 = 28  # the Higgs width, for the l1 and resume runs
OBJ_RTOL = 1e-4  # losses of a run through exp (tests/test_torch_gbdt_objectives.py)


def text_rows(path):
    """ytklearn lines -> feature dicts, as a client would send them."""
    rows = []
    with open(path) as f:
        for line in f:
            feats = line.rstrip("\n").split("###")[2]
            rows.append({k: float(v) for k, v in
                         (kv.split(":") for kv in feats.split(","))})
    return rows


def phase_softmax_cli(card):
    """`cli train gbdt` with softmax (K = 7 trees a round) on Covertype-
    shaped text at full width: the Higgs config's trees (255 leaves, loss
    policy, 255 bins, lr 0.1, bf16) over 2^19 + 2^16 lines of 54 features,
    10 rounds; K1, K3 and K5 at every shape the run launched them against
    their plain versions (softmax_kernels); the dumped model's stacked-rung
    scores against the host tree walk, and its test accuracy. Returns the
    kernels' largest errors."""
    import contextlib
    import io

    import numpy as np
    import torch

    from ytklearn_tpu_torch import cli
    from ytklearn_tpu_torch.gbdt.data import GBDTIngest
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.predict.trees import GBDTPredictor
    from ytklearn_tpu_torch.scripts.covertype_synth import N_FEATURES, \
        write_split
    from ytklearn_tpu_torch.serve.scorer import CompiledScorer

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_sm_")
    try:
        t0 = time.perf_counter()
        train, test, ytest = write_split(tmp, SOFTMAX_ROWS,
                                         SOFTMAX_TEST_ROWS, SOFTMAX_SEED)
        wrote = time.perf_counter() - t0
        model = os.path.join(tmp, "softmax.model")
        argv = ["train", "gbdt", CONF,
                "--set", f"data.train.data_path={train}",
                "--set", f"data.test.data_path={test}",
                "--set", f"data.max_feature_dim={N_FEATURES}",
                "--set", f"model.data_path={model}",
                "--set", f"model.feature_importance_path={model}.imp",
                "--set", "optimization.loss_function=softmax",
                "--set", f"optimization.class_num={SOFTMAX_K}",
                "--set", f"optimization.round_num={SOFTMAX_ROUNDS}",
                "--set", 'optimization.eval_metric=["confusion_matrix"]']
        print(f"softmax cli: wrote {SOFTMAX_ROWS} + {SOFTMAX_TEST_ROWS} "
              f"Covertype-shaped lines in {wrote:.3f} s (host) [{card}]; "
              f"python -m ytklearn_tpu_torch.cli {' '.join(argv)}",
              flush=True)
        out = io.StringIO()
        shapes = ShapeRecorder("float")
        zero_kernel_counts()  # count this path's launches only
        with Recorder(GBDTIngest, "load") as ingest, \
                Recorder(GBDTTrainer, "train") as trained, shapes, \
                contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = kernel_counts()
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        trainer = trained.calls[0][0]
        ts = trainer.time_stats
        trees = res["trees"]
        plan = trainer._efb_plan
        print(f"softmax cli: rc {rc}, {wall:.3f} s [{card}]; {trees} trees "
              f"({SOFTMAX_K} a round), parser {ts.get('parser')}, ingest "
              f"{ingest.calls[0][1]:.3f} s, preprocess "
              f"{ts['preprocess']:.3f} s, rounds {ts['train']:.3f} s, steady "
              f"{ts.get('trees_per_sec_steady', float('nan')):.4f} trees/s; "
              f"train loss {res['train_loss']:.6f}, test loss "
              f"{res['test_loss']:.6f}, test accuracy "
              f"{res['test_metrics']['confusion_matrix']:.6f}; EFB "
              f"{plan.summary() if plan is not None else 'none'}; launches "
              f"per tree: hist {counts['hist'] / max(trees, 1):.2f}, "
              f"hist_gather {counts['hist_gather'] / max(trees, 1):.2f}, "
              f"route {counts['route'] / max(trees, 1):.2f} [{card}]",
              flush=True)
        check(rc == 0 and trees == SOFTMAX_ROUNDS * SOFTMAX_K,
              f"softmax cli: rc {rc}, {res}")
        check(ts.get("parser") == "native",
              f"softmax cli parsed with the {ts.get('parser')} parser")
        check(trainer.hist_precision == "bf16", "softmax cli is not bf16")
        check(all(counts[k] > 0 for k in ("hist", "hist_gather", "route"))
              and counts["hist_q"] == 0 and counts["hist_gather_q"] == 0,
              f"softmax cli did not run K1, K3 and K5 only: {counts}")
        check(res["train_loss"] < math.log(SOFTMAX_K),
              f"softmax cli did not learn: {res}")
        errs = softmax_kernels(shapes, counts, card)
        # the dump on the stacked rung, held to the host tree walk
        pred = GBDTPredictor({"model": {"data_path": model}, "optimization": {
            "loss_function": "softmax", "class_num": SOFTMAX_K,
            "round_num": SOFTMAX_ROUNDS}})
        rows = text_rows(test)
        scorer = CompiledScorer(pred, mode="stacked", device="cuda")
        t0 = time.perf_counter()
        scores = scorer.score_batch(rows)
        t_stacked = time.perf_counter() - t0
        want = pred.batch_scores(rows[:SOFTMAX_HOST_ROWS])
        same = np.array_equal(scores[:SOFTMAX_HOST_ROWS], want)
        acc = float((np.argmax(scores, axis=1) == ytest).mean())
        print(f"softmax cli: the dump's stacked-rung scores of "
              f"{SOFTMAX_TEST_ROWS} test rows ({scores.shape}) in "
              f"{t_stacked:.3f} s; bit-equal to predict/trees.py on the first "
              f"{SOFTMAX_HOST_ROWS}: {same}; test accuracy {acc:.6f} (floor "
              f"{SOFTMAX_ACC_FLOOR}, from a CPU run) [{card}]", flush=True)
        check(scores.shape == (SOFTMAX_TEST_ROWS, SOFTMAX_K) and same,
              "the stacked rung's softmax scores differ from the host walk")
        check(acc > SOFTMAX_ACC_FLOOR,
              f"softmax test accuracy {acc} under {SOFTMAX_ACC_FLOOR}")
        return errs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def softmax_kernels(recorder, counts, card):
    """K1, K3 and K5 at every shape the softmax `cli train` gave them, on
    that run's own inputs (the first call at each shape): K1 over the
    EFB-bundled training matrix at each wave width, K3 over the fused
    rungs, K5 over the training and the test rows with the bundles' member
    ranges. The calls at the shapes must add up to the run's launch
    counts. K1 and K3 are held to the float64 sums of the same values at
    hist_err's tolerance, counts exact and equal to their plain versions'
    (exact_err), and to their plain versions (float64 sums rounded once)
    at hist_err's tolerance; K5 exactly, also in place.
    Returns each kernel's largest error against its plain version."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist, route

    t0 = time.perf_counter()
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {"hist": 0.0, "hist_gather": 0.0, "route": 0.0}
    for name in errs:
        seen = sum(c for (k, _, _), (c, _, _) in recorder.calls.items()
                   if k == name)
        check(seen == counts[name], f"softmax cli: {name}: {seen} calls "
              f"recorded at their shapes, {counts[name]} launches counted")
    for (name, rows, N), (calls, args, kw) in sorted(recorder.calls.items()):
        what = f"at the softmax run's shape N = {N}, {rows} rows ({calls} calls)"
        if name == "route":
            bins, pos = args[:2]
            got = route.route_wave(*args, **kw)
            want = route.route_wave_plain(*args, kw["lo"], kw["hi"])
            inplace = pos.clone()
            route.route_wave(bins, inplace, *args[2:], out=inplace, **kw)
            torch.cuda.synchronize()
            ok = torch.equal(got, want) and torch.equal(inplace, want)
            err = float((got.long() - want.long()).abs().max()) \
                if got.numel() else 0.0
            print(f"kernel check route {what}, with EFB member ranges, "
                  f"tolerance exact (torch.equal, also in place): {ok}, "
                  f"max_abs_err {err} [{card}]", flush=True)
            check(ok, f"route disagrees with its plain version {what}")
        elif name == "hist":
            bins, pos, g, h, ids, B = args
            F, M, bf16 = bins.shape[0], kw["max_nodes"], kw["use_bf16"]
            plan = hist.float_plan(N, F, B, M, rows, sm)
            got = hist.hist_wave(*args, **kw)
            want = hist.hist_wave_plain(bins, pos, g, h, ids, B, M, bf16)
            where = f"{what}, F = {F}, plan {plan_text(plan)}"
            err = exact_err(
                got, want,
                exact_float_hist(lambda f, r: bins[f, r], F, B, pos, g, h,
                                 ids, M, bf16), where, name, card)
            hist_err(got, want, where, name, card)
        else:
            brows, idx, pg, gg, hg, ids, B = args
            F, M, bf16 = brows.shape[1], kw["max_nodes"], kw["use_bf16"]
            plan = hist.float_plan(N, F, B, M, rows, sm, True)
            got = hist.hist_wave_gather(*args, **kw)
            want = hist.hist_gather_plain(brows, idx, pg, gg, hg, ids, B, M,
                                          bf16)
            where = f"{what}, F = {F}, plan {plan_text(plan)}"
            err = exact_err(
                got, want,
                exact_float_hist(lambda f, r: brows[idx[r].long(), f], F, B,
                                 pg, gg, hg, ids, M, bf16), where, name, card)
            hist_err(got, want, where, name, card)
        errs[name] = max(errs[name], err)
    print(f"softmax cli: {len(recorder.calls)} shapes of K1, K3 and K5 held "
          f"to their plain versions (K1 and K3 also to the exact sums) in "
          f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    recorder.calls.clear()
    return errs


def recording_trainer():
    """A GBDTTrainer that keeps, for every tree, its weighted gradients on
    the CPU, the round's masks, its GOSS key and its arrays."""
    import torch

    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    class Recording(GBDTTrainer):
        def _round(self, rnd, dd, spec, st):
            gs, hs = self.loss.grad_hess(self.loss.predict(st[0]), dd.y)
            include, fmask = self._sample_masks(rnd, dd)
            out = super()._round(rnd, dd, spec, st)
            live = dd.weight > 0
            for grp in range(self.K):
                g = gs[:, grp] if self.K > 1 else gs
                h = hs[:, grp] if self.K > 1 else hs
                t = rnd * self.K + grp
                self.trees.append((
                    torch.where(live, g * dd.weight, 0.0).cpu(),
                    torch.where(live, h * dd.weight, 0.0).cpu(),
                    include.cpu(), fmask.cpu(), self._goss_key(rnd, grp),
                    {k: v[t].cpu() for k, v in out[2].items()}))
            return out

    return Recording


def phase_objectives_int8(card):
    """Slice 11's objectives in int8 (K2, K4, K5) on the card against the
    CPU at 2^16 rows: softmax K = 7 on Covertype-shaped rows, l1 with the
    approximate LAD refine, and continue_train (3 + 3 rounds of l2).
    softmax goes through exp, which the card and the CPU may round apart
    in the last ulp: round 0's trees are held exactly, every later tree
    through the CPU's engine.grow fed the card's gradients, masks and key,
    the losses at OBJ_RTOL. l1's sign gradient and its LAD medians (unit
    weights) are exact: every tree and every leaf equal. The resumed card
    text equals the card's uninterrupted 6-round text byte for byte, and
    its trees the CPU's resumed ones."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.config.params import (
        ApproximateSpec,
        GBDTParams,
        ModelParams,
    )
    from ytklearn_tpu_torch.gbdt import engine
    from ytklearn_tpu_torch.gbdt.data import GBDTData
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel
    from ytklearn_tpu_torch.scripts.covertype_synth import (
        N_FEATURES,
        N_NUMERIC,
        N_WILD,
        covertype_like,
    )

    n = OBJ_ROWS
    num, wild, soil, label = covertype_like(n, SOFTMAX_SEED + 1)
    Xs = np.zeros((n, N_FEATURES), np.float32)
    Xs[:, :N_NUMERIC] = num
    Xs[np.arange(n), N_NUMERIC + wild] = 1.0
    Xs[np.arange(n), N_NUMERIC + N_WILD + soil] = 1.0
    Ys = np.eye(SOFTMAX_K, dtype=np.float32)[label]
    snames = [f"f{j}" for j in range(N_FEATURES)]
    rng = np.random.RandomState(SEED + 11)
    Xr = rng.randn(n, N_FEATURES_L1).astype(np.float32)
    yr = (1.5 * Xr[:, 0] * Xr[:, 1] + np.sin(2 * Xr[:, 2])
          + np.abs(Xr[:, 3]) + rng.laplace(0, 0.3, n)).astype(np.float32)
    rnames = [f"f{j}" for j in range(N_FEATURES_L1)]
    w = np.ones(n, np.float32)
    Recording = recording_trainer()
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_o_")

    def params(path, rounds, resume=False, **kw):
        return GBDTParams(
            round_num=rounds, max_depth=8, max_leaf_cnt=63,
            tree_grow_policy="loss", learning_rate=0.1,
            min_child_hessian_sum=10.0, eval_metric=[],
            approximate=[ApproximateSpec(max_cnt=255)],
            model=ModelParams(data_path=os.path.join(tmp, path),
                              dump_freq=0, continue_train=resume), **kw)

    def int_fields(a, b, what):
        for f in ("feat", "left", "right", "slot", "sample_cnt", "split"):
            check(getattr(a, f) == getattr(b, f),
                  f"{what}: cuda and cpu trees differ in {f}")

    zero_kernel_counts()
    try:
        # softmax
        t0 = time.perf_counter()
        tc = Recording(params("sm_cuda", 3, loss_function="softmax",
                              class_num=SOFTMAX_K),
                       hist_precision="int8", device="cuda")
        tc.trees = []
        rc = tc.train(GBDTData(Xs, Ys, w, n, snames))
        rp = GBDTTrainer(params("sm_cpu", 3, loss_function="softmax",
                                class_num=SOFTMAX_K),
                         hist_precision="int8", device="cpu").train(
            GBDTData(Xs, Ys, w, n, snames))
        check(len(rc.model.trees) == len(rp.model.trees) == 3 * SOFTMAX_K,
              "softmax: tree counts")
        for a, b in zip(rc.model.trees[:SOFTMAX_K],
                        rp.model.trees[:SOFTMAX_K]):
            int_fields(a, b, "softmax round 0")
        dd = tc.dev_inputs
        bins_t = dd.bins_t.cpu()
        ranges = None if dd.ranges is None else tuple(
            r.cpu() for r in dd.ranges)
        for t, (g, h, inc, fm, key, got) in enumerate(tc.trees):
            tr, *_ = engine.grow(tc.grow_spec, bins_t, inc, g, h, fm,
                                 key=key, ranges=ranges)
            for f in ("feat", "slot", "slot_r", "left", "right", "cnt",
                      "n_nodes"):
                check(torch.equal(getattr(tr, f), got[f]),
                      f"softmax tree {t}: the CPU's grow on the card's "
                      f"gradients differs in {f}")
        lc = [r["train_loss"] for r in rc.round_log]
        lp = [r["train_loss"] for r in rp.round_log]
        check(all(abs(a - b) <= OBJ_RTOL * abs(b) for a, b in zip(lc, lp)),
              f"softmax losses card {lc}, cpu {lp}")
        print(f"objectives int8: softmax K = {SOFTMAX_K}, {n} rows x "
              f"{N_FEATURES} features, {len(rc.model.trees)} trees on cuda "
              f"and on the CPU: round 0 equal, every tree equal to the CPU's "
              f"grow on the card's gradients; train losses card {lc}, cpu "
              f"{lp}; {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        # l1, the approximate LAD refine
        t0 = time.perf_counter()
        rc = GBDTTrainer(params("l1_cuda", 4, loss_function="l1"),
                         hist_precision="int8", device="cuda").train(
            GBDTData(Xr, yr, w, n, rnames))
        rp = GBDTTrainer(params("l1_cpu", 4, loss_function="l1"),
                         hist_precision="int8", device="cpu").train(
            GBDTData(Xr, yr, w, n, rnames))
        for a, b in zip(rc.model.trees, rp.model.trees):
            int_fields(a, b, "l1")
            leaves = [i for i in range(a.n_nodes()) if a.is_leaf(i)]
            check([a.leaf_value[i] for i in leaves]
                  == [b.leaf_value[i] for i in leaves],
                  "l1: the card's LAD leaves differ from the CPU's")
        lc = [r["train_loss"] for r in rc.round_log]
        print(f"objectives int8: l1 with the approximate LAD refine, {n} "
              f"rows x {N_FEATURES_L1} features, 4 trees on cuda and on the "
              f"CPU: every tree and leaf equal; train losses {lc}; "
              f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        check(lc[-1] < lc[0], f"l1 did not learn: {lc}")
        # continue_train
        t0 = time.perf_counter()
        texts = {}
        for dev in ("cuda", "cpu"):
            for path, rounds, resume in ((f"r_{dev}", 3, False),
                                         (f"r_{dev}", 6, True),
                                         (f"whole_{dev}", 6, False)):
                if dev == "cpu" and path.startswith("whole"):
                    continue
                GBDTTrainer(params(path, rounds, resume, loss_function="l2"),
                            hist_precision="int8", device=dev).train(
                    GBDTData(Xr, yr, w, n, rnames))
                with open(os.path.join(tmp, path)) as f:
                    texts[path] = f.read()
        check(texts["r_cuda"] == texts["whole_cuda"],
              "continue_train: the card's 3 + 3 text differs from its "
              "uninterrupted 6-round text")
        mc, mp = (GBDTModel.loads(texts["r_cuda"]),
                  GBDTModel.loads(texts["r_cpu"]))
        for a, b in zip(mc.trees, mp.trees):
            int_fields(a, b, "continue_train")
        print(f"objectives int8: continue_train, 3 + 3 rounds of l2 on {n} "
              f"rows: the card's resumed text equals its uninterrupted "
              f"6-round text byte for byte; its trees equal the CPU's resumed "
              f"ones (texts identical: {texts['r_cuda'] == texts['r_cpu']}); "
              f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = kernel_counts()
    print(f"objectives int8: launches {counts} [{card}]", flush=True)
    check(all(counts[k] > 0 for k in ("hist_q", "hist_gather_q", "route"))
          and counts["hist"] == 0 and counts["hist_gather"] == 0,
          f"the int8 objectives did not run K2, K4 and K5 only: {counts}")
    return counts



# -- slice 12: GBST training and serving every family --------------------------

#: GBST on the FM case's data (CONVEX_DATA "fm": convex_synth binary lines,
#: vocab 20000, 16 non-zeros a row, CONVEX_SEED): (lines, test lines)
GBST_DATA = {"big": (1 << 16, 1 << 13), "small": (1 << 15, 1 << 12)}
GBST_SHAPE = dict(vocab=20000, nnz=16, l2=1e-3)
#: (run, variant, data, trees, extra config, continue_train trees)
GBST_RUNS = (
    ("gbmlr", "gbmlr", "big", 2, {}, 0),
    ("gbsdt", "gbsdt", "small", 2, {}, 0),
    ("gbhmlr", "gbhmlr", "small", 2, {}, 0),
    ("gbhsdt", "gbhsdt", "small", 2, {}, 0),
    ("gbsdt random_forest", "gbsdt", "small", 2,
     {"type": "random_forest"}, 0),
    ("gbhmlr continue_train 2 + 1", "gbhmlr", "small", 2, {}, 1),
)
GBST_ITERS = 10  # L-BFGS iterations a tree on the main path
#: iterations a tree where a card run is held to its CPU run: L-BFGS on
#: the soft mixture is chaotic in f32 sum order past about that many
#: (PERF.md section 6), so the main path's GBST_ITERS are held only to the
#: sanity bounds
GBST_HELD_ITERS = 6
GBST_RTOL = 1e-4  # tests/test_torch_gbst.py's tolerances


def gbst_cli(cfg, variant, device, tag, tmp, iters, more=0):
    """`cli train <variant>` in this process, then with `more` > 0 again
    with continue_train to `more` more trees -> (the last run's JSON
    line, BoostResult and time_stats, the config it ran)."""
    import contextlib
    import io

    from ytklearn_tpu_torch import boost, cli

    c = json.loads(json.dumps(cfg))
    c["model"]["data_path"] = os.path.join(tmp, f"{tag}_{device}_{iters}",
                                           "model")
    c["optimization"]["line_search"]["lbfgs"]["convergence"][
        "max_iter"] = iters
    conf = os.path.join(tmp, f"{tag}_{device}_{iters}.conf")
    got = []
    real = boost.GBSTTrainer.train

    def train(self, *a, **kw):
        res = real(self, *a, **kw)
        got.append((res, dict(self.time_stats)))
        return res

    boost.GBSTTrainer.train = train
    try:
        for cont in ([False, True] if more else [False]):
            if cont:
                c["model"]["continue_train"] = True
                c["tree_num"] += more
            with open(conf, "w") as f:
                json.dump(c, f)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["train", variant, conf, "--device", device])
            check(rc == 0, f"cli train {variant} on {device}")
    finally:
        boost.GBSTTrainer.train = real
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    return line, *got[-1], c


def gbst_line(run, who, res, ts, card):
    secs = ts.get("trees") or [0.0]
    print(f"gbst cli {run} on {who}: {res.n_trees} trees, per-tree fit "
          f"avg loss {[round(v, 6) for v in res.per_tree_loss]}, iterations "
          f"{res.per_tree_iter}, statuses {res.per_tree_status}, train "
          f"{res.train_loss:.6f}, test {res.test_loss:.6f}, test AUC "
          f"{res.test_metrics['auc']:.6f}; {statistics.median(secs):.3f} s "
          f"a tree (median of {len(secs)}), ingest {ts['load']:.3f} s "
          f"({ts['parser']} parser) against training {ts['train']:.3f} s "
          f"[{card}]", flush=True)


def gbst_held(run, res, cres):
    """A card run against its CPU run: statuses and iterations a tree
    equal, per-tree fit and final losses at GBST_RTOL, test AUC within
    1e-4 and above 0.6."""
    check((res.per_tree_status, res.per_tree_iter) ==
          (cres.per_tree_status, cres.per_tree_iter),
          f"{run}: card {res.per_tree_status}/{res.per_tree_iter}, cpu "
          f"{cres.per_tree_status}/{cres.per_tree_iter}")
    for a, b in zip(res.per_tree_loss + [res.train_loss, res.test_loss],
                    cres.per_tree_loss + [cres.train_loss, cres.test_loss]):
        check(abs(a - b) <= GBST_RTOL * abs(b),
              f"{run}: losses card {res.per_tree_loss} {res.train_loss} "
              f"{res.test_loss}, cpu {cres.per_tree_loss} "
              f"{cres.train_loss} {cres.test_loss}")
    auc, cauc = res.test_metrics["auc"], cres.test_metrics["auc"]
    check(abs(auc - cauc) <= 1e-4 and auc > 0.6,
          f"{run}: test AUC {auc} vs cpu {cauc}")


def phase_gbst_cli(card, tmp):
    """Slice 12's main path: `cli train` for gbmlr (K = 8, 2 trees, 2^16 +
    2^13 lines: dim 20001 x 15 weights, a (rows, 17, 15) gather a pass),
    gbsdt, gbhmlr and gbhsdt (K = 8, 2 trees, 2^15 + 2^12 lines), a
    random_forest run and a continue_train run (2 + 1 trees), each at
    learning_rate 0.3, instance and feature rates 0.8 and GBST_ITERS
    L-BFGS iterations a tree on the card: trees, seconds a tree, ingest
    against training, test AUC above 0.6. Each run again at
    GBST_HELD_ITERS, card held to CPU (gbst_held). No kernel wrapper's count moves. Returns the
    card's gbmlr and gbhsdt configs (their dumps stay in `tmp`)."""
    from ytklearn_tpu_torch.scripts.convex_synth import write_gbst_case

    data = {}
    for name, (n, n_test) in GBST_DATA.items():
        data[name] = write_gbst_case(os.path.join(tmp, f"data_{name}"), n,
                                     n_test, CONVEX_SEED, K=8,
                                     learning_rate=0.3,
                                     instance_sample_rate=0.8,
                                     feature_sample_rate=0.8, **GBST_SHAPE)
    before = launch_counts()
    served = {}
    for i, (run, variant, dname, trees, extra, more) in enumerate(GBST_RUNS):
        cfg = json.loads(json.dumps(data[dname]))
        cfg.update(extra, tree_num=trees)
        cfg["loss"]["evaluate_metric"] = ["auc"]
        cfg["optimization"]["line_search"]["lbfgs"]["convergence"][
            "eps"] = 1e-7
        tag = f"gbst{i}"
        line, res, ts, used = gbst_cli(cfg, variant, "cuda", tag, tmp,
                                       GBST_ITERS, more)
        gbst_line(f"{run} ({GBST_DATA[dname][0]} lines)", "cuda", res, ts,
                  card)
        check(line["model"] == variant and res.n_trees == trees + more
              and len(res.per_tree_loss) == (more or trees)
              and ts["parser"] == "native" and all(
                  math.isfinite(v) for v in res.per_tree_loss)
              and res.test_metrics["auc"] > 0.6,
              f"{run}: did not train ({line})")
        if run in ("gbmlr", "gbhsdt"):
            served[variant] = used
        _, hres, _, _ = gbst_cli(cfg, variant, "cuda", tag, tmp,
                                 GBST_HELD_ITERS, more)
        _, hcres, _, _ = gbst_cli(cfg, variant, "cpu", tag, tmp,
                                  GBST_HELD_ITERS, more)
        gbst_held(run, hres, hcres)
        print(f"gbst cli {run} at {GBST_HELD_ITERS} iterations a tree: "
              f"card {hres.per_tree_loss} {hres.test_loss:.6f} AUC "
              f"{hres.test_metrics['auc']:.6f}, cpu {hcres.per_tree_loss} "
              f"{hcres.test_loss:.6f} AUC {hcres.test_metrics['auc']:.6f}: "
              f"held (statuses, iterations, losses at rtol {GBST_RTOL}, "
              f"AUC within 1e-4) [{card}]", flush=True)
    check(launch_counts() == before,
          "a kernel wrapper launched on the GBST path")
    return served


def phase_serve_families(card, models):
    """`cli serve`'s path (ModelRegistry + ServeApp, as in
    phase_serve_binned) for every family `cli train` writes but GBDT:
    linear, multiclass_linear, FM and FFM as phase_convex_cli trained them
    on the card, gbmlr and gbhsdt as phase_gbst_cli did. At each rung
    (YTK_SERVE_PRECISION f64 and bf16): 200 one-row requests (p50 and p99
    of the client's clock) and one of 64 rows, from the model's test
    lines. f64: every score equal to the host predictor's at rtol 1e-10,
    atol 1e-12; bf16 (the einsum families; GBST serves f64 at either):
    predictions within the reference's 0.1 band of the host's, the rung
    named in rung_info. Then one `cli serve` process (gbmlr, f64) answers
    a 64-row /predict equal to the host, and drains on SIGTERM. No kernel
    wrapper's count moves."""
    import numpy as np

    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.serve import BatchPolicy, ModelRegistry, ServeApp

    before = launch_counts()
    for family, cfg in models.items():
        pred = create_predictor(family, cfg)
        rows = text_rows(cfg["data"]["test"]["data_path"])[:264]
        want_s = pred.batch_scores(rows)
        want_p = pred.batch_predicts(rows)
        for precision in ("f64", "bf16"):
            os.environ["YTK_SERVE_PRECISION"] = precision
            try:
                registry = ModelRegistry(device="cuda")
                entry = registry.load("default", family, cfg)
            finally:
                os.environ.pop("YTK_SERVE_PRECISION")
            info = entry.scorer.rung_info()
            served = ("bf16" if precision == "bf16"
                      and family in ("linear", "multiclass_linear", "fm",
                                     "ffm") else "f64")
            check((info["mode"], info["precision"], info["downgraded"]) ==
                  ("stacked", served, False), f"{family}: rung {info}")
            app = ServeApp(registry, BatchPolicy(max_batch=512,
                                                 max_wait_ms=2.0),
                           host="127.0.0.1", port=0).start()
            try:
                lat, got_s, got_p = [], [], []
                for row in rows[:200]:
                    t0 = time.perf_counter()
                    out = post(app.port, {"features": row})
                    lat.append((time.perf_counter() - t0) * 1e3)
                    got_s += out["scores"]
                    got_p += out["predictions"]
                out = post(app.port, {"rows": rows[200:264]})
            finally:
                app.stop(drain=True, timeout=30.0)
                registry.close()
            got_s = np.asarray(got_s + out["scores"], np.float64)
            got_p = np.asarray(got_p + out["predictions"], np.float64)
            if served == "f64":
                ok = bool(np.all(np.abs(got_s - want_s)
                                 <= 1e-12 + 1e-10 * np.abs(want_s)))
                band = float(np.max(np.abs(got_p - want_p)))
                what = "every score at rtol 1e-10, atol 1e-12"
            else:
                band = float(np.max(np.abs(got_p - want_p)))
                ok = 0.0 < band < 0.1
                what = "predictions inside the 0.1 band"
            lat.sort()
            p50 = statistics.median(lat)
            p99 = lat[int(0.99 * (len(lat) - 1))]
            print(f"serve {family} ({precision} requested, {served} "
                  f"served): 200 one-row requests + one of 64 rows, "
                  f"{what} of the host predictor: {ok}, max |prediction "
                  f"diff| {band:.6g}; one-row p50 {p50:.4f} ms, p99 "
                  f"{p99:.4f} ms (client clock) [{card}]", flush=True)
            check(ok, f"serve {family} at {precision}: scores off the host "
                  "predictor's")
    # the CLI itself, in its own process
    family, cfg = "gbmlr", models["gbmlr"]
    conf = os.path.join(os.path.dirname(cfg["model"]["data_path"]),
                        "serve.conf")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    env.pop("YTK_SERVE_PRECISION", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ytklearn_tpu_torch.cli", "serve", conf,
         family, "--host", "127.0.0.1", "--port", "0", "--device",
         "cuda"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = json.loads(proc.stdout.readline() or "{}")
        check(banner.get("model") == family, f"cli serve banner {banner}")
        rows = text_rows(cfg["data"]["test"]["data_path"])[:64]
        out = post(banner["port"], {"rows": rows})
        want = create_predictor(family, cfg).batch_scores(rows)
        ok = bool(np.all(np.abs(np.asarray(out["scores"]) - want)
                         <= 1e-12 + 1e-10 * np.abs(want)))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"cli serve {family}: banner rung {json.dumps(banner['rung'])}, "
          f"64 rows equal to the host predictor at rtol 1e-10: {ok}, "
          f"SIGTERM exit {rc} [{card}]", flush=True)
    check(ok and rc == 0, f"cli serve {family}: scores {ok}, exit {rc}")
    check(launch_counts() == before,
          "a kernel wrapper launched while serving the non-GBDT families")


# -- slice 13: the host engine and resilience -----------------------------------

#: (run, trees, optimization overrides): the host engine's two full-width
#: `cli train gbdt` runs on the Higgs config (F = 28, 255 bins, 255
#: leaves, lr 0.1, min_child_hessian_sum 100) over phase_cli_train's text
HOST_RUNS = (
    ("level sigmoid feature", 20,
     {"tree_maker": "feature", "tree_grow_policy": "level"}),
    ("loss l1 precise", 3,
     {"loss_function": "l1", "lad_refine_appr": False,
      "tree_grow_policy": "loss"}),
)
#: the level-wise run's test AUC floor (see phase_host_engine)
HOST_AUC_FLOOR = 0.9
#: card against CPU: text lines and trees a run
HOST_SMALL = (1 << 16, 1 << 13)
HOST_SMALL_TREES = 2
RES_ROWS = 1 << 19  # the device engine's resume runs (Higgs rows)
RES_ROUNDS = 20
RES_CUT = 10  # the sync read that draws the SIGTERM (first draw < rate)


def host_cli(conf_args, device, tag, tmp, extra=(), sets=()):
    """`cli train gbdt` in this process -> (rc, JSON line or None, the
    last GBDTTrainer that ran, with its GBDTResult as `.result`, ingest
    seconds, model path)."""
    import contextlib
    import io

    from ytklearn_tpu_torch import cli
    from ytklearn_tpu_torch.gbdt.data import GBDTIngest
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    real = GBDTTrainer.train

    def train(self, *a, **kw):
        self.result = real(self, *a, **kw)
        return self.result

    model = os.path.join(tmp, tag, "gbdt.model")
    argv = (["train", "gbdt", CONF] + list(conf_args)
            + ["--set", f"model.data_path={model}",
               "--set", f"model.feature_importance_path={model}.imp"]
            + [a for kv in sets for a in ("--set", kv)]
            + ["--device", device] + list(extra))
    buf = io.StringIO()
    GBDTTrainer.train = train
    try:
        with Recorder(GBDTIngest, "load") as ingest, \
                Recorder(GBDTTrainer, "train") as trained, \
                contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        GBDTTrainer.train = real
    lines = buf.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if rc == 0 and lines else None
    trainer = trained.calls[-1][0] if trained.calls else None
    secs = ingest.calls[-1][1] if ingest.calls else float("nan")
    return rc, line, trainer, secs, model


def opt_sets(over):
    return [f"optimization.{k}={json.dumps(v)}" for k, v in over.items()]


def text_of(path):
    with open(path) as f:
        return f.read()


def phase_host_engine(card, paths, tmp):
    """The host engine through `cli train gbdt` on the card: HOST_RUNS at
    full width over phase_cli_train's 2^20 + 2^17 Higgs lines, then both
    policies at HOST_SMALL lines on cuda twice and on the CPU, whose dumps
    must be byte-identical. No kernel wrapper launches on this phase."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.scripts.bench_gbdt import (
        gen_higgs_like,
        quality_band,
    )

    before = launch_counts()
    data = ["--set", f"data.train.data_path={paths['train']}",
            "--set", f"data.test.data_path={paths['test']}"]
    for run, trees, over in HOST_RUNS:
        t0 = time.perf_counter()
        rc, res, tr, ingest_s, _m = host_cli(
            data, "cuda", run.replace(" ", "_"), tmp,
            sets=opt_sets(dict(over, round_num=trees)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0 and res["trees"] == trees and tr.engine == "host",
              f"host engine {run}: rc {rc}, {res}")
        ts = tr.time_stats
        secs = tr.tree_seconds
        print(f"host engine {run}: {trees} trees on {CLI_ROWS} rows x "
              f"{N_FEATURES} features in {wall:.3f} s (wall); ingest "
              f"{ingest_s:.3f} s (parse + fill, host), preprocess "
              f"{ts['preprocess']:.3f} s (host binning), rounds "
              f"{ts['train']:.3f} s; {statistics.mean(secs):.4f} s a tree "
              f"(min {min(secs):.4f}, max {max(secs):.4f}), "
              f"{tr.host_syncs / trees:.1f} host syncs a tree; train loss "
              f"{res['train_loss']:.6f}, test loss {res['test_loss']:.6f}, "
              f"test metrics {res['test_metrics']} [{card}]", flush=True)
        if over.get("loss_function") == "l1":
            losses = [r["train_loss"] for r in tr.result.round_log]
            check(all(b < a for a, b in zip(losses, losses[1:])),
                  f"host engine l1: the loss did not fall every round: "
                  f"{losses}")
            print(f"host engine {run}: train loss by round {losses} "
                  f"[{card}]", flush=True)
        else:
            # bench.py's band is its 40-tree cell's; 20 level-wise trees at
            # lr 0.1 sit below it (0.9327 at 2^17 rows on the CPU), so the
            # run is held to HOST_AUC_FLOOR and the band's verdict printed
            auc = res["test_metrics"]["auc"]
            band = quality_band(auc, res["test_loss"], False)
            print(f"host engine {run}: bench.py's synthetic band: {band} "
                  f"[{card}]", flush=True)
            check(res["train_loss"] < 0.65 and auc > HOST_AUC_FLOOR,
                  f"host engine {run}: train loss {res['train_loss']}, "
                  f"test AUC {auc}")
    # card against CPU, and a second card run, at HOST_SMALL lines
    n, nt = HOST_SMALL
    train, test = gen_higgs_like(n, nt, N_FEATURES, SEED + 13,
                                 device="cuda")
    rng = np.random.RandomState(SEED + 13)
    small = {k: os.path.join(tmp, f"small_{k}.txt") for k in ("train", "test")}
    write_ytk_text(small["train"], train.X, train.y, rng)
    write_ytk_text(small["test"], test.X, test.y, rng)
    del train, test
    sdata = ["--set", f"data.train.data_path={small['train']}",
             "--set", f"data.test.data_path={small['test']}"]
    texts = {}
    for run, _trees, over in HOST_RUNS:
        for who in ("cuda", "cuda2", "cpu"):
            dev = who.rstrip("2")
            t0 = time.perf_counter()
            rc, res, tr, _s, model = host_cli(
                sdata, dev, f"small_{run.replace(' ', '_')}_{who}", tmp,
                sets=opt_sets(dict(over, round_num=HOST_SMALL_TREES)))
            check(rc == 0, f"host engine small {run} on {who}: rc {rc}")
            texts[(run, who)] = text_of(model)
            print(f"host engine small {run} on {who}: {HOST_SMALL_TREES} "
                  f"trees on {n} rows in {time.perf_counter() - t0:.3f} s "
                  f"(wall), {statistics.mean(tr.tree_seconds):.4f} s a tree,"
                  f" {tr.host_syncs / HOST_SMALL_TREES:.1f} host syncs a "
                  f"tree [{card}]", flush=True)
        same_cpu = texts[(run, "cuda")] == texts[(run, "cpu")]
        same_card = texts[(run, "cuda")] == texts[(run, "cuda2")]
        print(f"host engine small {run}: card dump byte-identical to the "
              f"CPU's: {same_cpu}; to a second card run: {same_card} "
              f"({len(texts[(run, 'cuda')])} bytes) [{card}]", flush=True)
        check(same_cpu and same_card,
              f"host engine small {run}: the card's dumps differ")
    after = launch_counts()
    print(f"host engine: kernel launches {before} before the phase, "
          f"{after} after [{card}]", flush=True)
    check(after == before, "a kernel wrapper launched on the host engine")
    return small


@contextlib.contextmanager
def chaos(spec):
    """YTK_CHAOS armed for this process, with fresh per-site call counts
    and counters."""
    from ytklearn_tpu_torch import resilience

    resilience.reset_chaos()
    resilience.reset_counters()
    os.environ["YTK_CHAOS"] = spec
    try:
        yield
    finally:
        os.environ.pop("YTK_CHAOS", None)
        resilience.reset_chaos()


CHAOS_RATE = 0.05


def first_draw_seed(site, n, upto=40):
    """A chaos seed at CHAOS_RATE whose draw n at `site` fires and whose
    other draws up to `upto` pass."""
    from ytklearn_tpu_torch.resilience import site_draw

    return next(s for s in range(1 << 20)
                if site_draw(s, site, n) < CHAOS_RATE
                and all(site_draw(s, site, k) >= CHAOS_RATE
                        for k in range(1, upto + 1) if k != n))


def node_values_apart(a, b):
    """Node values (leaf, gain, hessian) that differ between two model
    texts of the same tree count, and the trees whose structure differs."""
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel

    ma, mb = GBDTModel.loads(a), GBDTModel.loads(b)
    vals = total = shape = 0
    for x, y in zip(ma.trees, mb.trees):
        if (x.feat_name, x.left, x.split) != (y.feat_name, y.left, y.split):
            shape += 1
            continue
        for f in ("leaf_value", "gain", "hess_sum"):
            total += len(getattr(x, f))
            vals += sum(u != v for u, v in zip(getattr(x, f), getattr(y, f)))
    return vals, total, shape


def phase_resilience(card, small):
    """scripts/chaos_drill.py's steps on the card: the device engine's
    SIGTERM and resume at int8 (byte-identical) and at bf16 (completes;
    node values apart counted), the host engine's kill -9 in a `cli train`
    subprocess and `--resume auto` (byte-identical), transient read faults
    over the native ingest, FM and gbmlr preempted and resumed, and
    `--max-restarts 1` after one injected error."""
    import io

    import numpy as np
    import torch

    from ytklearn_tpu_torch import resilience
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.config.params import GBDTParams
    from ytklearn_tpu_torch.gbdt.data import GBDTIngest
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel
    from ytklearn_tpu_torch.resilience import Preempted
    from ytklearn_tpu_torch.scripts.bench_gbdt import (
        bench_params,
        gen_higgs_like,
    )
    from ytklearn_tpu_torch.scripts.convex_synth import (
        write_convex_case,
        write_gbst_case,
    )

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_res_")
    try:
        # the device engine: baseline, SIGTERM at the RES_CUT-th sync, resume
        train, test = gen_higgs_like(RES_ROWS, RES_ROWS >> 3, N_FEATURES,
                                     SEED + 14, device="cuda")
        cut_seed = first_draw_seed("gbdt.sync", RES_CUT)
        for prec in ("int8", "bf16"):
            def run_dev(tag, resume=False):
                p = bench_params(RES_ROUNDS, os.path.join(tmp, f"{prec}_{tag}"))
                p.model.continue_train = resume
                t0 = time.perf_counter()
                res = GBDTTrainer(p, hist_precision=prec,
                                  device="cuda").train(train=train, test=test)
                torch.cuda.synchronize()
                return res, time.perf_counter() - t0

            _r, t_whole = run_dev("whole")
            with chaos(f"gbdt.sync:sigterm:{CHAOS_RATE}:{cut_seed}"):
                try:
                    run_dev("cut")
                    check(False, f"{prec}: the SIGTERM did not preempt")
                except Preempted as e:
                    code = e.exit_code
            cut_text = text_of(os.path.join(tmp, f"{prec}_cut"))
            done = len(GBDTModel.loads(cut_text).trees)
            res, t_resume = run_dev("cut", resume=True)
            whole = text_of(os.path.join(tmp, f"{prec}_whole"))
            resumed = text_of(os.path.join(tmp, f"{prec}_cut"))
            apart, total, shape = node_values_apart(resumed, whole)
            print(f"resilience {prec}: device engine, {RES_ROWS} Higgs rows,"
                  f" {RES_ROUNDS} rounds: SIGTERM at sync {RES_CUT} -> exit "
                  f"{code} with {done} trees dumped; resume "
                  f"{t_resume:.3f} s beside {t_whole:.3f} s uninterrupted; "
                  f"resumed text byte-identical: {resumed == whole}; node "
                  f"values apart {apart} of {total}, trees of another shape "
                  f"{shape} [{card}]", flush=True)
            check(code == 143 and 0 < done < RES_ROUNDS
                  and len(res.model.trees) == RES_ROUNDS,
                  f"{prec} preemption: exit {code}, {done} trees")
            if prec == "int8":
                check(resumed == whole, "int8: the resumed dump differs from "
                      "the uninterrupted run's")
        del train, test
        torch.cuda.empty_cache()
        # the host engine: kill -9 in a subprocess, then --resume auto
        data = ["--set", f"data.train.data_path={small['train']}",
                "--set", f"data.test.data_path={small['test']}"]
        run, _t, over = HOST_RUNS[0]
        sets = opt_sets(dict(over, round_num=HOST_SMALL_TREES))
        rc, _l, _tr, _s, base = host_cli(data, "cuda", "k9_whole", tmp,
                                         sets=sets)
        check(rc == 0, "host engine baseline")
        # commits a round: sidecar, model, importance; draw 4 is round 1's
        # sidecar, after round 0's model is on disk
        kill_seed = first_draw_seed("io.dump", 4)
        model = os.path.join(tmp, "k9", "gbdt.model")
        argv = ([sys.executable, "-m", "ytklearn_tpu_torch.cli", "train",
                 "gbdt", CONF] + data + [a for kv in sets + [
                     f"model.data_path={model}", "model.dump_freq=1",
                     f"model.feature_importance_path={model}.imp"]
                     for a in ("--set", kv)] + ["--device", "cuda"])
        env = dict(os.environ,
                   YTK_CHAOS=f"io.dump:kill:{CHAOS_RATE}:{kill_seed}",
                   PYTHONPATH=REPO)
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, env=env,
                              cwd=REPO, timeout=300)
        t_kill = time.perf_counter() - t0
        check(proc.returncode == 137 and os.path.exists(model),
              f"kill -9 stand-in: rc {proc.returncode}, "
              f"{proc.stderr[-1500:]}")
        killed = len(GBDTModel.loads(text_of(model)).trees)
        rc, _l, _tr, _s, _m = host_cli(
            data, "cuda", "k9", tmp, extra=["--resume", "auto"],
            sets=sets + ["model.dump_freq=1"])
        same = text_of(model) == text_of(base)
        print(f"resilience host engine ({run}, {HOST_SMALL[0]} lines): "
              f"kill -9 at io.dump draw 4 -> exit {proc.returncode} after "
              f"{t_kill:.3f} s with {killed} trees on disk; --resume auto "
              f"rc {rc}, dump byte-identical to the uninterrupted run: "
              f"{same} [{card}]", flush=True)
        check(rc == 0 and same, "host engine kill -9 resume")
        # transient read faults over the native ingest
        conf = hocon.load(CONF)
        for k, v in (("data.train.data_path", small["train"]),
                     ("data.test.data_path", small["test"])):
            conf = hocon.set_path(conf, k, v)
        p = GBDTParams.from_config(conf)
        resilience.reset_counters()
        t0 = time.perf_counter()
        clean, clean_t = GBDTIngest(p).load()
        t_clean = time.perf_counter() - t0
        with chaos("io.read:oserror:0.3:1"):
            t0 = time.perf_counter()
            ing = GBDTIngest(p)
            faulted, faulted_t = ing.load()
            t_fault = time.perf_counter() - t0
        snap = resilience.counters()
        equal = all(np.array_equal(np.asarray(a), np.asarray(b),
                                   equal_nan=True)
                    for a, b in ((faulted.X, clean.X), (faulted.y, clean.y),
                                 (faulted_t.X, clean_t.X)))
        print(f"resilience ingest: io.read:oserror:0.3:1 over the "
              f"{ing.parser} parser: {snap.get('chaos.injected', 0)} faults "
              f"injected, {snap.get('io.retry.attempts', 0)} retries, "
              f"{snap.get('io.retry.giveup', 0)} give-ups; dataset equal: "
              f"{equal}; {t_fault:.3f} s beside {t_clean:.3f} s unfaulted "
              f"(host) [{card}]", flush=True)
        check(ing.parser == "native" and equal
              and snap.get("chaos.injected", 0) >= 1
              and "io.retry.giveup" not in snap, "transient ingest faults")
        # FM and gbmlr: SIGTERM at the first dump commit, then resume
        cases = {
            "fm": write_convex_case(os.path.join(tmp, "fm"), "fm", 1 << 14,
                                    1 << 11, CONVEX_SEED + 13, vocab=20000,
                                    nnz=16, k=8, l2=1e-3, max_iter=6),
            "gbmlr": write_gbst_case(os.path.join(tmp, "gbmlr"), 1 << 14,
                                     1 << 11, CONVEX_SEED + 14, K=4,
                                     tree_num=3, max_iter=4, **GBST_SHAPE),
        }
        for family, cfg in cases.items():
            cfg["model"]["dump_freq"] = 1
            cfg["model"]["data_path"] = os.path.join(tmp, family, "model")
            conf_path = os.path.join(tmp, f"{family}.conf")
            with open(conf_path, "w") as f:
                json.dump(cfg, f)
            from ytklearn_tpu_torch import cli

            with chaos("io.dump:sigterm:1:0"), \
                    contextlib.redirect_stdout(io.StringIO()):
                rc1 = cli.main(["train", family, conf_path, "--device",
                                "cuda"])
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc2 = cli.main(["train", family, conf_path, "--device",
                                "cuda", "--resume", "auto"])
            print(f"resilience {family}: SIGTERM at the first dump -> exit "
                  f"{rc1}; --resume auto -> rc {rc2} in "
                  f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
            check(rc1 == 143 and rc2 == 0, f"{family} preempt/resume")
        # --max-restarts 1 after one injected error (round 1's model commit)
        err_seed = first_draw_seed("io.dump", 5)
        with chaos(f"io.dump:error:{CHAOS_RATE}:{err_seed}"):
            rc, _l, _tr, _s, model = host_cli(
                data, "cuda", "restart", tmp, extra=["--max-restarts", "1"],
                sets=sets + ["model.dump_freq=1"])
            injected = resilience.counters().get("chaos.injected.io.dump")
        same = rc == 0 and text_of(model) == text_of(base)
        print(f"resilience --max-restarts 1: one injected error at io.dump "
              f"draw 5 ({injected} injected in all) -> rc {rc}, dump "
              f"byte-identical to the uninterrupted run: {same} [{card}]",
              flush=True)
        check(same, "--max-restarts did not recover")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- slice 15: continual training -----------------------------------------------

CONT_ROWS = 1 << 20  # fresh lines of the promoted candidate
CONT_HOLDOUT = 1 << 17  # held-out lines of the gate
CONT_FLIP_ROWS = 1 << 17  # label-flipped lines of the rejected candidate
CONT_EXTRA = 10  # extra boosting rounds a retrain
CONT_SEED = 20261018
CONT_WATCH_S = 0.5
CONT_THINK_S = 0.05  # a client's pause between requests
CONT_POOL = 2048  # held-out rows the clients send, 1-64 at a time
CONT_PREDICT_ROWS = 1 << 12  # held-out lines through `cli predict`
CONT_FTRL_TEST = 2048  # held-out lines of the FTRL retrains' gate
CONT_SMALL = (1 << 14, 1 << 12)  # the int8 card-against-CPU retrain
CONT_SMALL_ROUNDS = (3, 2)  # bootstrap rounds, then extra rounds


def _write_part(args):
    path, Xh, yh, seed = args
    import numpy as np

    write_ytk_lines(path, Xh, yh, np.random.RandomState(seed))
    return path


def write_text_parallel(sets):
    """write_ytk_lines for each (directory, X, y, seed) of `sets`, into
    CONT_WRITERS part files a directory, formatted by CONT_WRITERS spawned
    processes (the text is formatted in Python); the ingest reads a
    directory whole."""
    import multiprocessing

    jobs = []
    for dirpath, Xh, yh, seed in sets:
        os.makedirs(dirpath, exist_ok=True)
        step = -(-len(Xh) // CONT_WRITERS)
        jobs += [(os.path.join(dirpath, f"part-{i:05d}"), Xh[lo:lo + step],
                  yh[lo:lo + step], seed + i)
                 for i, lo in enumerate(range(0, len(Xh), step))]
    with multiprocessing.get_context("spawn").Pool(CONT_WRITERS) as pool:
        pool.map(_write_part, jobs, chunksize=1)
    return [dirpath for dirpath, *_ in sets]


def continual_traffic(port, pool, stop, records, errors):
    """SERVE_OPS_THREADS clients POST 1-64 held-out rows until `stop` is
    set, CONT_THINK_S apart; each answer goes into `records` as it comes
    (wall and perf clocks)."""
    import numpy as np

    def client(i):
        rng = np.random.RandomState(CONT_SEED + 100 + i)
        t0 = None
        try:
            while not stop.is_set():
                n = int(rng.randint(1, 65))
                lo = int(rng.randint(0, len(pool) - n))
                t0 = time.perf_counter()
                status, _h, out = http_json("POST", port, "/predict",
                                            {"rows": pool[lo:lo + n]})
                if status != 200:
                    errors.append((status, out, t0))
                    return
                records.append({"lo": lo, "n": n, "t0": t0,
                                "t1": time.perf_counter(),
                                "wall": time.time(),
                                "version": out["version"],
                                "scores": out["scores"]})
                stop.wait(CONT_THINK_S)
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append((repr(e), t0))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_OPS_THREADS)]
    for t in threads:
        t.start()
    return threads


def cli_quiet(argv, env=None):
    """cli.main(argv) in this process, stdout captured, `env` set for the
    call -> (rc, the last JSON line printed)."""
    import io
    from unittest import mock

    from ytklearn_tpu_torch import cli

    buf = io.StringIO()
    with mock.patch.dict(os.environ, env or {}), \
            contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


def copy_model(src, dst):
    """The model text and its sidecars, as the trainer wrote them."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    for suffix in ("", ".bins.json", ".sketch.json"):
        if os.path.exists(src + suffix):
            shutil.copyfile(src + suffix, dst + suffix)


def read_holdout(path, n):
    """The first n lines of a text file as feature dicts."""
    from ytklearn_tpu_torch.config.params import DelimParams
    from ytklearn_tpu_torch.predict import parse_feature_kvs

    d = DelimParams()
    rows = []
    with open(path) as f:
        for line in f:
            rows.append(parse_feature_kvs(line.rstrip("\n").split("###")[2],
                                          d))
            if len(rows) == n:
                break
    return rows


def wait_for_version(records, before, watch_s, periods=20):
    """Until a response names a server version past `before` (at most
    `periods` watch periods), then two periods more of traffic."""
    deadline = time.perf_counter() + periods * watch_s
    while time.perf_counter() < deadline and not any(
            r["version"] > before for r in list(records)):
        time.sleep(watch_s / 5)
    time.sleep(2 * watch_s)


def held_versions(records, host, pool):
    """Each response against the host walks: every server version must
    answer with one model text's scores, bit for bit. Returns {server
    version: text tag} and the records in time order."""
    import numpy as np

    want = {tag: h.batch_scores(pool) for tag, h in host.items()}
    fits = {}  # server version -> the model versions all its answers fit
    for r in records:
        got = np.asarray(r["scores"])
        tags = {t for t, w in want.items()
                if np.array_equal(got, w[r["lo"]:r["lo"] + r["n"]])}
        fits[r["version"]] = fits.get(r["version"], tags) & tags
    for v, tags in fits.items():
        check(tags, f"server version {v}'s answers fit no one model "
              f"version's host walk")
    of = {v: sorted(tags)[0] for v, tags in fits.items()}
    for r in records:
        r["tag"] = of[r["version"]]
    return of, sorted(records, key=lambda r: r["t1"])


def phase_continual(tmp, cli_model, card):
    """Slice 15's main path, `cli retrain gbdt` on the card against a GBDT
    incumbent that `cli serve` serves under traffic: a copy of
    phase_cli_train's model (20 trees, F = 28, 255 bins and leaves, loss
    policy, bf16) served on the fused rung (K6) by a `cli serve` process
    with --watch-interval CONT_WATCH_S under 8 clients, then in this
    process: (1) a retrain on CONT_ROWS fresh Higgs-shaped lines from a new
    seed with a CONT_HOLDOUT-line held-out file and CONT_EXTRA extra
    rounds promotes v2 (`.version.json`, the archive `.v1`, rc 0), the
    candidate's training launching K1, K3 and K5 (not K2 or K4) at least
    once a tree and the gate's held-out scoring K6 once a scored batch of
    the incumbent's and the candidate's, no scorer fallback; the server
    answers with v2's text within a few watch periods; (2) a candidate
    trained on CONT_FLIP_ROWS label-flipped lines is rejected by the band
    (its gate on the held-out file's first part, 2^14 lines), exit 1
    under YTK_CONTINUAL_STRICT=1, and the server stays on v2;
    (3) `cli retrain --rollback` brings v1's files back and the server
    with them. Every response of the traffic is bit-equal to the host walk
    of one model version, the same one for all of a server version's
    responses, and no request fails. Card against CPU, run while the
    server starts (continual_card_cpu): an int8 retrain (bootstrap, then
    extra rounds on fresh lines) whose dumps are byte-identical; `retrain
    linear --mode ftrl` on the convex phase's 2^16 lines (bootstrap and
    warm twice on the card, bit-equal; the bootstrap on the CPU, weights
    at rtol 1e-5 plus 1e-5 of the largest |w|); `cli predict gbdt` of the
    incumbent over the held-out file's first CONT_PREDICT_ROWS lines (raw
    scores bit-equal to the host walk, predictions at rtol 1e-14 of the
    CPU's, leaf ids equal); `cli convert` of a libsvm file, then `cli
    train` on its output. Returns the candidate's and the gate's
    launches."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.gbdt.data import GBDTIngest
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.scripts.bench_gbdt import gen_higgs_like
    from ytklearn_tpu_torch.serve import kernels

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "continual")
    live = os.path.join(d, "live", "gbdt.model")
    copy_model(cli_model, live)
    with open(live) as f:
        v1_text = f.read()
    sconf = serve_conf(live, d, "serve")
    env = dict(os.environ, YTK_SERVE_FUSED="1", YTK_OBS="1",
               PYTHONPATH=REPO)
    env.pop("YTK_SERVE_BINNED", None)
    err_path = os.path.join(d, "serve.err")
    t_spawn = time.perf_counter()
    # the server starts while this process writes the data
    proc = spawn_cli_serve(
        [sconf, "gbdt", "--host", "127.0.0.1", "--port", "0",
         "--watch-interval", str(CONT_WATCH_S)], env, err_path)
    stop = threading.Event()
    records, errors, threads = [], [], []
    marks = {}
    try:
        # the fresh lines, the held-out file and the flipped lines, from a
        # seed of their own
        t0 = time.perf_counter()
        train, test = gen_higgs_like(CONT_ROWS, CONT_HOLDOUT, N_FEATURES,
                                     CONT_SEED)
        Xh, yh = train.X.cpu().double().numpy(), train.y.cpu().numpy()
        fresh, holdout, flipped = write_text_parallel([
            (os.path.join(d, "fresh"), Xh, yh, CONT_SEED),
            (os.path.join(d, "holdout"), test.X.cpu().double().numpy(),
             test.y.cpu().numpy(), CONT_SEED + 50),
            (os.path.join(d, "flipped"), Xh[:CONT_FLIP_ROWS],
             1 - yh[:CONT_FLIP_ROWS], CONT_SEED + 60)])
        del train, test
        t_write = time.perf_counter() - t0
        # the card-against-CPU checks need no server: they run while it
        # starts (`cli predict` on the incumbent, v1)
        continual_card_cpu(d, live, holdout, card)
        banner = json.loads(proc.stdout.readline())
        t_up = time.perf_counter() - t_spawn
        check(banner["rung"]["backend"] == "fused-cuda", f"banner {banner}")
        pool = read_holdout(os.path.join(holdout, "part-00000"), CONT_POOL)
        threads = continual_traffic(banner["port"], pool, stop, records,
                                    errors)
        rconf = os.path.join(d, "retrain.conf")
        rcfg = hocon.load(CONF)
        for key, val in (("model.data_path", live),
                         ("model.feature_importance_path", live + ".imp"),
                         ("optimization.round_num", CLI_ROUNDS),
                         ("optimization.max_depth", CLI_DEPTH)):
            hocon.set_path(rcfg, key, val)
        with open(rconf, "w") as f:
            json.dump(rcfg, f)  # JSON is HOCON
        argv = ["retrain", "gbdt", rconf, "--data", fresh, "--test",
                holdout, "--extra-rounds", str(CONT_EXTRA)]
        knobs = {}
        for knob in ("net/ipv4/tcp_abort_on_overflow", "net/core/somaxconn"):
            try:
                with open(f"/proc/sys/{knob}") as f:
                    knobs[knob] = f.read().strip()
            except OSError:
                knobs[knob] = "not readable"
        print(f"continual: the host's listen settings {knobs} [{card}]",
              flush=True)
        print(f"continual: `cli serve` up {t_up:.3f} s after its spawn "
              f"(the writing overlaps it); wrote "
              f"{CONT_ROWS} + {CONT_HOLDOUT} + {CONT_FLIP_ROWS} lines in "
              f"{t_write:.3f} s ({CONT_WRITERS} processes, host); python -m "
              f"ytklearn_tpu_torch.cli {' '.join(argv)} [{card}]",
              flush=True)

        # (1) the promotion, its kernels counted over the call alone
        time.sleep(CONT_WATCH_S)
        before_v = max((r["version"] for r in list(records)), default=1)
        zero_kernel_counts()
        kernels.heap_walk.launches = 0
        obs.reset()
        with Recorder(GBDTTrainer, "train") as trained, \
                Recorder(GBDTIngest, "load") as ingest:
            t0 = time.perf_counter()
            rc, res = cli_quiet(argv, {"YTK_SERVE_FUSED": "1"})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        marks["promoted"] = time.perf_counter()
        counts = kernel_counts()
        k6 = kernels.heap_walk.launches
        c = obs.snapshot()["counters"]
        spans = {}
        for e in obs.REGISTRY.events:
            if e["name"].startswith("continual.") and "dur" in e:
                spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"]
        trainer = trained.calls[0][0]
        ts = trainer.time_stats
        with open(live + ".version.json") as f:
            vinfo = json.load(f)
        with open(live) as f:
            v2_text = f.read()
        trees = res.get("trained", {}).get("trees")
        print(f"continual: retrain rc {rc}, {wall:.3f} s (wall) [{card}]; "
              f"{json.dumps(res)}", flush=True)
        print(f"continual: candidate ingest {ingest.calls[0][1]:.3f} s "
              f"(parse + fill, host), "
              f"preprocess {ts.get('preprocess', 0.0):.3f} s, rounds "
              f"{ts.get('train', 0.0):.3f} s; spans (s, summed) "
              f"{json.dumps({k: round(v, 3) for k, v in spans.items()})}; "
              f"launches hist {counts['hist']}, hist_gather "
              f"{counts['hist_gather']}, route {counts['route']}, hist_q "
              f"{counts['hist_q']}, hist_gather_q {counts['hist_gather_q']}, "
              f"heap_walk (the gate) {k6} for serve.scorer.batches "
              f"{c.get('serve.scorer.batches')}; gate_eval_fallback "
              f"{c.get('continual.gate_eval_fallback', 0)} [{card}]",
              flush=True)
        check(rc == 0 and res["promoted"] and res["version"] == 2,
              f"the retrain did not promote v2: {res}")
        check(vinfo["version"] == 2 and vinfo["archives"] == [1]
              and os.path.exists(live + ".v1")
              and open(live + ".v1").read() == v1_text,
              f"version record {vinfo}, or the archive .v1")
        check(trees == CLI_ROUNDS + CONT_EXTRA
              and trainer.hist_precision == "bf16",
              f"the candidate has {trees} trees")
        new = CONT_EXTRA
        check(counts["hist"] >= new and counts["route"] >= new
              and counts["hist_gather"] > 0 and counts["hist_q"] == 0
              and counts["hist_gather_q"] == 0,
              f"the candidate did not launch K1, K3 and K5 only: {counts}")
        batches = 2 * -(-CONT_HOLDOUT // LADDER[-1])
        check(k6 == c.get("serve.scorer.batches") == batches,
              f"the gate launched K6 {k6} times for "
              f"{c.get('serve.scorer.batches')} scored batches, want "
              f"{batches}")
        check(c.get("continual.gate_eval_fallback", 0) == 0,
              "the gate fell back to the host walk")
        check(res["gate"]["holdout_rows"] == CONT_HOLDOUT
              and res["gate"]["candidate_loss"]
              <= res["gate"]["incumbent_loss"], f"gate {res['gate']}")
        wait_for_version(records, before_v, CONT_WATCH_S)

        # (2) a label-flipped candidate, strict: rejected, v2 stays
        marks["reject0"] = time.perf_counter()
        t0 = time.perf_counter()
        part = os.path.join(holdout, "part-00000")
        rc2, rej = cli_quiet(argv[:4] + [flipped, "--test", part]
                             + argv[7:],
                             {"YTK_SERVE_FUSED": "1",
                              "YTK_CONTINUAL_STRICT": "1"})
        print(f"continual: the label-flipped candidate: rc {rc2}, "
              f"{time.perf_counter() - t0:.3f} s (wall); {json.dumps(rej)} "
              f"[{card}]", flush=True)
        check(rc2 == 1 and rej["promoted"] is False and rej["strict"]
              and any("outside the band" in r for r in rej["reasons"]),
              f"the flipped candidate was not rejected by the band: {rej}")
        with open(live) as f:
            check(f.read() == v2_text, "the rejection touched the model")
        time.sleep(2 * CONT_WATCH_S)  # a watch period past the rejection
        marks["reject1"] = time.perf_counter()
        before_v = max(r["version"] for r in list(records))

        # (3) the rollback: v1's files, and the server with them
        marks["rollback"] = time.perf_counter()
        rc3, rb = cli_quiet(["retrain", "gbdt", rconf, "--rollback"])
        check(rc3 == 0 and rb["rolled_back"] and rb["version"] == 1,
              f"rollback {rb}")
        with open(live) as f:
            check(f.read() == v1_text, "the rollback did not restore v1")
        wait_for_version(records, before_v, CONT_WATCH_S)
        stop.set()
        for t in threads:
            t.join(timeout=120)
            check(not t.is_alive(), "a client hung")
        # the server's K6 launches: one a scored batch of the traffic
        st, _h, m = http_json("GET", banner["port"], "/metrics")
        check(st == 200, f"/metrics answered {st}")
        k6_serve = cli_serve_launches(
            m["counters"], sum(r["n"] for r in records),
            "the continual phase's `cli serve`")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        rc_s, err_text, warm = stop_cli_serve(proc, err_path)
    check(not errors, f"requests failed (error, sent at): {errors[:3]}; "
          f"marks {marks}")
    check(rc_s == 0, f"cli serve exited {rc_s}: {err_text[-2000:]}")
    host = {}
    for tag, text in (("v1", v1_text), ("v2", v2_text)):
        path = os.path.join(d, tag, "gbdt.model")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        host[tag] = create_host(serve_conf(path, d, f"host_{tag}"))
    of, recs = held_versions(records, host, pool)
    first_v2 = min((r for r in recs if r["tag"] == "v2"),
                   key=lambda r: r["t1"], default=None)
    check(first_v2 is not None, "the server never answered with v2")
    swap_s = first_v2["wall"] - vinfo["promoted_at"]
    between = [r["tag"] for r in recs
               if marks["reject0"] <= r["t0"] and r["t1"] <= marks["reject1"]]
    after_rb = [r for r in recs if r["t0"] > marks["rollback"]]
    back = min((r["t1"] for r in after_rb if r["tag"] == "v1"), default=None)
    check(between and set(between) == {"v2"},
          f"answers during the rejection: {sorted(set(between))}")
    check(back is not None and not [r for r in after_rb if r["tag"] == "v2"
                                    and r["t0"] > back],
          "the server did not stay on v1 after the rollback")
    # sent after v2 first answered, answered before the rollback began (a
    # request that straddles the rollback may be scored on either side)
    late_v1 = [(r["version"], r["t0"], r["t1"]) for r in recs
               if r["tag"] == "v1" and r["t0"] > first_v2["t1"]
               and r["t1"] < marks["rollback"]]
    check(not late_v1, f"v1 answered after v2 had, before the rollback: "
          f"(server version, sent, answered) {late_v1[:3]}, v2 first "
          f"answered at {first_v2['t1']}, the rollback began at "
          f"{marks['rollback']}")
    check(swap_s <= 10 * CONT_WATCH_S,
          f"v2 answered {swap_s:.3f} s after its promotion")
    lat = sorted((r["t1"] - r["t0"]) * 1e3 for r in recs)
    print(f"continual: {len(recs)} requests, {sum(r['n'] for r in recs)} "
          f"rows under {SERVE_OPS_THREADS} clients ({CONT_THINK_S} s "
          f"apart), no failure; server versions {json.dumps(of)}; v2 first "
          f"answered {swap_s:.3f} s after promoted_at, v1 again "
          f"{back - marks['rollback']:.3f} s after the rollback began; "
          f"client-clock p50 {statistics.median(lat):.4f} ms, p99 "
          f"{lat[min(len(lat) - 1, int(math.ceil(0.99 * len(lat))) - 1)]:.4f}"
          f" ms; reload warm_ms {warm}; the server's K6 launches "
          f"{k6_serve} (serve.scorer.batches); every response bit-equal to "
          f"the host walk of its version [{card}]", flush=True)
    print(f"continual: {time.perf_counter() - t_phase:.3f} s (wall) in all "
          f"[{card}]", flush=True)
    return counts, k6


def _small_retrain(d, who, device, data, extra):
    """An int8 retrain of the small Higgs-shaped set on `device`."""
    from ytklearn_tpu_torch import continual
    from ytklearn_tpu_torch.config import hocon

    cfg = hocon.load(CONF)
    model = os.path.join(d, who, "gbdt.model")
    for key, val in (("data.train.data_path", data),
                     ("data.test.data_path", os.path.join(d, "small_test")),
                     ("model.data_path", model),
                     ("model.feature_importance_path", model + ".imp"),
                     ("optimization.round_num", CONT_SMALL_ROUNDS[0]),
                     ("optimization.max_depth", 6)):
        hocon.set_path(cfg, key, val)
    res = continual.retrain("gbdt", cfg, device=device, extra_rounds=extra,
                            hist_precision="int8")
    with open(model) as f:
        return res, f.read()


def _model_text(path):
    """Every part file of a dumped convex model, concatenated."""
    out = []
    for part in sorted(os.listdir(path)):
        with open(os.path.join(path, part)) as f:
            out.append(f.read())
    return "".join(out)


def continual_card_cpu(d, live, holdout, card):
    """phase_continual's card-against-CPU checks (see there); `live` is
    the served incumbent, `holdout` the held-out directory."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.scripts.bench_gbdt import gen_higgs_like
    from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case

    t0 = time.perf_counter()
    # int8 retrain: bootstrap, then extra rounds on fresh lines
    n, n_test = CONT_SMALL
    rng = np.random.RandomState(CONT_SEED + 7)
    tr, te = gen_higgs_like(n, n_test, N_FEATURES, CONT_SEED + 7)
    tr2, _ = gen_higgs_like(n, 1, N_FEATURES, CONT_SEED + 8)
    for name, data in (("small_a", tr), ("small_test", te),
                       ("small_b", tr2)):
        write_ytk_text(os.path.join(d, name), data.X, data.y, rng)
    zero_kernel_counts()
    texts = {}
    for who, device in (("int8_cuda", "cuda"), ("int8_cpu", "cpu")):
        boot, t_boot = _small_retrain(d, who, device,
                                      os.path.join(d, "small_a"), 0)
        warm, t_warm = _small_retrain(d, who, device,
                                      os.path.join(d, "small_b"),
                                      CONT_SMALL_ROUNDS[1])
        texts[who] = (t_boot, t_warm, boot, warm)
        if device == "cuda":
            counts = kernel_counts()
    (cb, cw, cboot, cwarm), (pb, pw, pboot, pwarm) = (texts["int8_cuda"],
                                                      texts["int8_cpu"])
    print(f"continual: int8 retrain at {n} + {n_test} lines in "
          f"{time.perf_counter() - t0:.3f} s (wall), "
          f"{CONT_SMALL_ROUNDS[0]} + {CONT_SMALL_ROUNDS[1]} rounds: card "
          f"promoted {cboot.promoted}/{cwarm.promoted} (v{cwarm.version}), "
          f"cpu {pboot.promoted}/{pwarm.promoted}; card dumps byte-identical "
          f"to the CPU's: bootstrap {cb == pb}, warm {cw == pw}; card "
          f"launches hist_q {counts['hist_q']}, hist_gather_q "
          f"{counts['hist_gather_q']}, route {counts['route']} [{card}]",
          flush=True)
    check(cwarm.promoted and pwarm.promoted and cwarm.version == 2
          and cb == pb and cw == pw,
          "the int8 card retrain is not the CPU retrain byte for byte")
    check(counts["hist_q"] > 0 and counts["route"] > 0
          and counts["hist"] == 0, f"int8 launches {counts}")

    # FTRL on the convex phase's linear lines: twice on the card, once on
    # the CPU
    t1 = time.perf_counter()
    name, family, lines, kw = CONVEX_DATA[0]
    cfg = write_convex_case(os.path.join(d, "ftrl"), family, lines,
                            lines // 8, CONVEX_SEED, **kw)
    cfg["continual"] = {"ftrl": {"alpha": 1.0, "l2": 1e-4},
                        "batch_rows": 8192, "band": 0.5}
    # the gate on the test file's first CONT_FTRL_TEST lines: the linear
    # scorer's featurized rows are dense (rows x 50001)
    test = cfg["data"]["test"]["data_path"]
    with open(test) as f:
        head = [line for _, line in zip(range(CONT_FTRL_TEST), f)]
    with open(test + ".head", "w") as f:
        f.writelines(head)
    cfg["data"]["test"]["data_path"] = test + ".head"
    from ytklearn_tpu_torch.continual import online

    real_pass = online.ftrl_pass
    states = []

    def ftrl_pass(*a, **kw):
        state = real_pass(*a, **kw)
        states.append(state.w.cpu().numpy())
        return state

    texts, ftrl_out, ws = {}, {}, {}
    online.ftrl_pass = ftrl_pass
    try:
        for who, device, passes in (("card_a", "cuda", 2),
                                    ("card_b", "cuda", 2), ("cpu", "cpu", 1)):
            c = json.loads(json.dumps(cfg))
            c["model"]["data_path"] = os.path.join(d, f"ftrl_{who}", "model")
            conf = os.path.join(d, f"ftrl_{who}.conf")
            with open(conf, "w") as f:
                json.dump(c, f)
            outs = []
            del states[:]
            # a bootstrap pass, then (on the card) a warm one
            for _step in range(passes):
                rc, out = cli_quiet(["retrain", family, conf, "--mode",
                                     "ftrl", "--device", device])
                check(rc == 0 and out["promoted"], f"ftrl retrain {out}")
                outs.append(out)
            ftrl_out[who], ws[who] = outs, list(states)
            texts[who] = _model_text(c["model"]["data_path"])
    finally:
        online.ftrl_pass = real_pass
    same = (texts["card_a"] == texts["card_b"] and all(
        np.array_equal(x, y) for x, y in zip(ws["card_a"], ws["card_b"])))
    # the bootstrap pass from zeros, card against CPU: float32 gradient
    # sums in another order part a weight whose z sums cancel, so rtol
    # 1e-5 plus 1e-5 of the largest |w|
    va, vc = ws["card_a"][0], ws["cpu"][0]
    scale = float(np.max(np.abs(vc)))
    gap = float(np.max(np.abs(va - vc)))
    close = bool(np.allclose(va, vc, rtol=1e-5, atol=1e-5 * scale))
    print(f"continual: retrain {family} --mode ftrl on {lines} lines "
          f"in {time.perf_counter() - t1:.3f} s (wall; bootstrap, then "
          f"warm on the card; bootstrap on the CPU), the "
          f"gate on {CONT_FTRL_TEST} held-out lines: avg loss card "
          f"{[o['trained']['avg_loss'] for o in ftrl_out['card_a']]}, cpu "
          f"{[o['trained']['avg_loss'] for o in ftrl_out['cpu']]}; the two "
          f"card runs bit-equal (both passes' weights, the dumps): {same}; "
          f"the bootstrap pass's {va.size} weights within rtol 1e-5 plus "
          f"1e-5 of the largest |w| ({scale:.6g}) of the CPU's: {close} "
          f"(largest gap {gap:.3g}) [{card}]", flush=True)
    check(same and close and len(ws["card_a"]) == 2,
          "FTRL on the card is not repeatable or parts from the CPU's")

    # cli predict over the held-out file's first lines, on the incumbent
    t1 = time.perf_counter()
    pfile = os.path.join(d, "predict.txt")
    with open(pfile, "w") as g:
        n_lines = 0
        for part in sorted(os.listdir(holdout)):
            with open(os.path.join(holdout, part)) as f:
                for line in f:
                    if n_lines < CONT_PREDICT_ROWS:
                        g.write(line)
                        n_lines += 1
    pconf = serve_conf(live, d, "predict")
    host = create_host(pconf)
    want = host.batch_scores(read_holdout(pfile, CONT_PREDICT_ROWS))
    got = {}
    for tag, extra in (("raw_cuda", ["--device", "cuda", "--set",
                                     "optimization.loss_function=l2"]),
                       ("cuda", ["--device", "cuda"]),
                       ("cpu", ["--device", "cpu"]),
                       ("leaf_cuda", ["--device", "cuda", "--predict-type",
                                      "leafid"]),
                       ("leaf_cpu", ["--device", "cpu", "--predict-type",
                                     "leafid"])):
        rc, out = cli_quiet(["predict", pconf, "gbdt", pfile, "--suffix",
                             f"_{tag}", "--set",
                             "optimization.round_num=0"] + extra)
        check(rc == 0, f"cli predict {tag}")
        with open(pfile + f"_{tag}") as f:
            got[tag] = f.read().splitlines()
    raw = np.asarray([float(v) for v in got["raw_cuda"]])
    pc = np.asarray([float(v) for v in got["cuda"]])
    pp = np.asarray([float(v) for v in got["cpu"]])
    sig = 1.0 / (1.0 + np.exp(-want))
    print(f"continual: cli predict gbdt over {CONT_PREDICT_ROWS} held-out "
          f"lines, five runs in {time.perf_counter() - t1:.3f} s: raw scores bit-equal to the host walk "
          f"{np.array_equal(raw, want)}; predictions on the card within "
          f"rtol 1e-14 of the CPU's {np.allclose(pc, pp, rtol=1e-14, atol=0)}"
          f" and of the host's sigmoid "
          f"{np.allclose(pc, sig, rtol=1e-14, atol=0)}; leaf ids equal "
          f"{got['leaf_cuda'] == got['leaf_cpu']} [{card}]", flush=True)
    check(np.array_equal(raw, want)
          and np.allclose(pc, pp, rtol=1e-14, atol=0)
          and np.allclose(pc, sig, rtol=1e-14, atol=0)
          and got["leaf_cuda"] == got["leaf_cpu"]
          and len(got["leaf_cuda"]) == CONT_PREDICT_ROWS,
          "cli predict on the card parts from the host walk or the CPU")

    # cli convert, then cli train on its output
    lib = os.path.join(d, "small.libsvm")
    Xs, ys = tr.X[:4096].cpu().double().numpy(), tr.y[:4096].cpu().numpy()
    with open(lib, "w") as f:
        for x, y in zip(Xs.tolist(), ys.tolist()):
            f.write(("+1" if y > 0 else "-1") + " " + " ".join(
                f"{j + 1}:{v:.6g}" for j, v in enumerate(x)) + "\n")
    conv = os.path.join(d, "small.ytk")
    rc, out = cli_quiet(["convert", "binary_classification@-1,+1", lib,
                         conv])
    check(rc == 0 and out["lines"] == 4096, f"cli convert {out}")
    lconf = os.path.join(d, "converted.conf")
    with open(lconf, "w") as f:
        json.dump({"data": {"train": {"data_path": conv}},
                   "model": {"data_path": os.path.join(d, "converted")},
                   "loss": {"loss_function": "sigmoid",
                            "evaluate_metric": ["auc"],
                            "regularization": {"l2": [1e-3]}},
                   "optimization": {"line_search": {"lbfgs": {
                       "convergence": {"max_iter": 10}}}}}, f)
    rc, out = cli_quiet(["train", "linear", lconf, "--device", "cuda"])
    print(f"continual: cli convert wrote {out and 4096} lines; cli train "
          f"linear on them: rc {rc}, train AUC "
          f"{out['train_metrics']['auc']:.6f} [{card}]", flush=True)
    check(rc == 0 and out["train_metrics"]["auc"] > 0.5,
          f"cli train on the converted file: {out}")
    torch.cuda.empty_cache()
    print(f"continual: card against CPU {time.perf_counter() - t0:.3f} s "
          f"(wall) [{card}]", flush=True)


# -- slice 16: the serving fleet ----------------------------------------------

FLEET_CLIENTS = 8
FLEET_WATCH_S = 0.5
FLEET_POOL = 2048  # rows; requests are 1-64-row slices of the pool
FLEET_COUNT_S = 3.0  # traffic of the launch count, before the kill
FLEET_STEP_S = 1.0  # traffic between the kill, reload and rollback steps
SCALE_CLIENTS = 16  # 64-row requests, enough backlog to grow the fleet
SCALE_AT_TWO_S = 3.0  # traffic once the second replica is ready
#: the autoscaling fleet's knobs: a tick every 0.25 s, grow after two
#: ticks over 128 queued or in-flight rows a replica, reap after twelve
#: ticks under 8 (3 s idle), the SLO signals off (--slo-ms 0)
SCALE_KNOBS = {"YTK_SERVE_SCALE_INTERVAL_S": "0.25",
               "YTK_SERVE_SCALE_UP_BACKLOG": "128",
               "YTK_SERVE_SCALE_DOWN_BACKLOG": "8",
               "YTK_SERVE_SCALE_UP_WINDOWS": "2",
               "YTK_SERVE_SCALE_DOWN_WINDOWS": "12",
               "YTK_SERVE_SCALE_UP_COOLDOWN_S": "0",
               "YTK_SERVE_SCALE_DOWN_COOLDOWN_S": "3"}


def fleet_traffic(port, pool, stop, records, errors, seed, clients,
                  fixed_rows=None):
    """`clients` threads POST slices of `pool` (1-64 rows, or
    `fixed_rows`) to the front until `stop` is set; each answer goes into
    `records` as it comes, with the replica that scored it."""
    import numpy as np

    def client(i):
        rng = np.random.RandomState(seed + i)
        t0 = None
        try:
            while not stop.is_set():
                n = fixed_rows or int(rng.randint(1, 65))
                lo = int(rng.randint(0, len(pool) - n))
                t0 = time.perf_counter()
                status, _h, out = http_json("POST", port, "/predict",
                                            {"rows": pool[lo:lo + n]})
                if status != 200:
                    errors.append((status, out, t0))
                    return
                records.append({"lo": lo, "n": n, "t0": t0,
                                "t1": time.perf_counter(),
                                "version": out["version"],
                                "replica": out["replica"],
                                "scores": out["scores"]})
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append((repr(e), t0))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    return threads


def join_traffic(stop, threads, errors, what):
    stop.set()
    for t in threads:
        t.join(timeout=120)
        check(not t.is_alive(), f"a {what} client hung")
    check(not errors, f"{what}: {len(errors)} failed requests: "
          f"{errors[:3]}")


def lat_ms(records):
    """(p50, p99) of the records' client-clock latencies, in ms."""
    lat = sorted((r["t1"] - r["t0"]) * 1e3 for r in records)
    check(lat, "no request in a latency window")
    return (statistics.median(lat),
            lat[min(len(lat) - 1, int(math.ceil(0.99 * len(lat))) - 1)])


def replica_launches(front_port, records, what):
    """Each replica's kernel launches of `records`' traffic, from the
    replica's own /metrics (its serve.scorer.batches: a launch of its
    rung's kernel a scored batch), held to the rows the front's answers
    say it scored. -> {replica id: launches}."""
    _st, _h, fm = http_json("GET", front_port, "/metrics")
    out = {}
    for rid, info in sorted(fm["replicas"].items()):
        check(info["state"] == "ready", f"{what}: replica {rid} {info}")
        st, _h, rm = http_json("GET", info["port"], "/metrics")
        check(st == 200, f"{what}: replica {rid} /metrics answered {st}")
        rows = sum(r["n"] for r in records if str(r["replica"]) == rid)
        out[int(rid)] = cli_serve_launches(rm["counters"], rows,
                                           f"{what} replica {rid}")
    return out


def replica_versions(front_port):
    """{replica id: the version each replica's registry serves}."""
    _st, _h, fm = http_json("GET", front_port, "/metrics")
    out = {}
    for rid, info in fm["replicas"].items():
        if info["state"] != "ready":
            out[rid] = None
            continue
        st, _h, rm = http_json("GET", info["port"], "/metrics")
        out[rid] = rm["models"]["default"]["version"] if st == 200 else None
    return out


def wait_until(cond, what, timeout=120.0, step=0.05):
    deadline = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < deadline, f"{what} within {timeout} s")
        time.sleep(step)
    return time.perf_counter()


def flight_events(flight_dir):
    """(reason, the ring's events) of the one flight dump in the dir."""
    dumps = sorted(f for f in os.listdir(flight_dir)
                   if f.startswith("flight_"))
    check(len(dumps) == 1, f"flight dumps in {flight_dir}: {dumps}")
    with open(os.path.join(flight_dir, dumps[0])) as f:
        doc = json.load(f)
    return doc["flight"]["reason"], doc["flight"]["ring"]


def fleet_native_checks(conf, pool, card):
    """The native host library on the served rows: `bin_rows`' native entry
    bit-equal to its numpy loop, and `native_binned_scores` (the CPU
    binned rung) bit-equal to K7 on the card on the same bins. Run before
    any replica starts, so every replica finds K6/K7 built."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.serve import kernels

    check(kernels.native_serve_available(),
          "the native serve library did not build")
    sc = binned_on_cpu(conf)
    check(sc.backend == "binned-native", f"CPU binned rung {sc.backend}")
    table = sc._bin_table
    X = sc.featurize(pool)
    def host_ms(fn):
        """(result, median ms of 5 calls on the host clock)."""
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = fn(X, table)
            ts.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(ts)

    bins, t_native = host_ms(kernels.bin_rows)
    plain, t_plain = host_ms(kernels.bin_rows_plain)
    check(bins.dtype == plain.dtype and np.array_equal(bins, plain),
          "native bin_rows differs from its numpy loop")
    heap, why = kernels.build_heap(sc.predictor.model.trees, sc.vocab)
    check(heap is not None, why)
    packed = kernels.pack_heap_nodes(heap, table)
    leaf = np.ascontiguousarray(heap.leaf)
    native = kernels.native_binned_scores(
        bins, packed, leaf, heap.depth, table.sentinel,
        kernels.resolve_kernel_threads())
    k7 = kernels.binned_walk(
        torch.from_numpy(bins).cuda(), torch.from_numpy(packed).cuda(),
        torch.from_numpy(leaf).cuda(), heap.depth, table.sentinel,
        max_feat=int(heap.feat.max())).cpu().numpy()
    check(np.array_equal(native, k7), "native_binned_scores differs from "
          "K7 on the same bins")
    print(f"fleet: native bin_rows bit-equal to its numpy loop on "
          f"{len(pool)} served rows ({table.mode}, {table.dtype}; "
          f"{t_native:.3f} ms beside {t_plain:.3f} ms, host clock, median "
          f"of 5 calls), native_binned_scores bit-equal to K7 on those "
          f"bins [{card}]", flush=True)
    return {"native_bin_ms": t_native, "numpy_bin_ms": t_plain}


def fleet_fused(d, cli_model, pool, card):
    """`cli serve --replicas 2` on cuda, fused rung (K6): 8 clients for
    FLEET_COUNT_S (each replica's K6 launches of that traffic from its own
    /metrics), then under traffic a kill -9 of replica 0 and its restart, a
    hot reload to v2 on every replica and a fleet-wide /admin/rollback to
    v1. Every response bit-equal to the host walk of its version; no
    request fails; the front's flight dump names the death and the
    restart."""
    import numpy as np

    from ytklearn_tpu_torch.gbdt.tree import GBDTModel

    path = os.path.join(d, "fused", "gbdt.model")
    copy_model(cli_model, path)
    conf = serve_conf(path, d, "fused")
    host = {1: create_host(conf)}
    with open(path) as f:
        v2 = GBDTModel.loads(f.read())
    for t in v2.trees:
        t.leaf_value = [0.75 * v for v in t.leaf_value]
    flight = os.path.join(d, "fused_flight")
    env = dict(os.environ, YTK_SERVE_FUSED="1", YTK_OBS="1",
               PYTHONPATH=REPO, YTK_FLIGHT_DIR=flight,
               YTK_FLIGHT_N=str(1 << 20))
    env.pop("YTK_SERVE_BINNED", None)
    err_path = os.path.join(d, "fused.err")
    t0 = time.perf_counter()
    proc, banner = start_cli_serve(
        [conf, "gbdt", "--host", "127.0.0.1", "--port", "0", "--replicas",
         "2", "--watch-interval", str(FLEET_WATCH_S)], env, err_path)
    res = {"spawn_to_ready_s": time.perf_counter() - t0}
    records, errors = [], []
    try:
        port = banner["port"]
        check(banner["fleet"] is True and banner["replicas"] == 2
              and banner["device"] == "cuda"
              and sorted(banner["replica_ports"]) == ["0", "1"],
              f"fleet banner {banner}")
        for rid, p in banner["replica_ports"].items():
            st, _h, rm = http_json("GET", p, "/metrics")
            rung = rm["models"]["default"]["rung"]
            check(st == 200 and rung["backend"] == "fused-cuda",
                  f"replica {rid} rung {rung}")
        # 1. the launch count: 8 clients, then each replica's own /metrics
        stop = threading.Event()
        threads = fleet_traffic(port, pool, stop, records, errors, SEED + 300,
                                FLEET_CLIENTS)
        time.sleep(FLEET_COUNT_S)
        join_traffic(stop, threads, errors, "fleet")
        counted = list(records)
        res["launches"] = replica_launches(port, counted, "fused fleet")
        check(all(k > 0 for k in res["launches"].values()),
              f"a replica launched no K6: {res['launches']}")
        res["p50_ms"], res["p99_ms"] = lat_ms(counted)
        res["requests"] = len(counted)
        # 2. kill -9, restart, hot reload, fleet-wide rollback, under load
        stop = threading.Event()
        threads = fleet_traffic(port, pool, stop, records, errors, SEED + 400,
                                FLEET_CLIENTS)
        time.sleep(FLEET_STEP_S)
        _st, _h, hz = http_json("GET", port, "/healthz")
        victim = hz["replicas"]["0"]["pid"]
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)

        def restarted():
            _s, _h, h = http_json("GET", port, "/healthz")
            r = h["replicas"]["0"]
            return r["restarts"] >= 1 and r["state"] == "ready"

        res["restart_s"] = wait_until(restarted, "replica 0 restarted") \
            - t_kill
        t_back = time.perf_counter()
        time.sleep(FLEET_STEP_S)
        with open(path + ".next", "w") as f:
            f.write(v2.dumps())
        os.replace(path + ".next", path)
        host[2] = create_host(conf)
        t_swap = time.perf_counter()
        res["reload_s"] = wait_until(
            lambda: set(replica_versions(port).values()) == {2},
            "both replicas on v2") - t_swap
        time.sleep(FLEET_STEP_S)
        st, _h, rb = http_json("POST", port, "/admin/rollback", {})
        t_rb = time.perf_counter()
        check(st == 200 and rb["ok"] is True
              and sorted(rb["replicas"]) == ["0", "1"]
              and all(v["version"] == 1 and v["pinned"]
                      for v in rb["replicas"].values()),
              f"fleet rollback {st} {rb}")
        time.sleep(FLEET_STEP_S)
        join_traffic(stop, threads, errors, "fleet")
        for version in sorted({r["version"] for r in records}):
            check(version in host, f"a response named v{version}")
            want = host[version].batch_scores(pool)
            mine = [r for r in records if r["version"] == version]
            check(np.array_equal(
                np.asarray([s for r in mine for s in r["scores"]]),
                np.concatenate([want[r["lo"]:r["lo"] + r["n"]]
                                for r in mine])),
                  f"v{version}: fleet responses differ from the host walk")
        check(any(r["version"] == 2 for r in records), "no v2 answer")
        late = [r for r in records if r["t0"] > t_rb and r["version"] != 1]
        check(not late, f"{len(late)} answers past the rollback not on v1")
        check(any(r["replica"] == 0 and r["t0"] > t_back for r in records),
              "the restarted replica took no traffic")
        st, _h, fm = http_json("GET", port, "/metrics")
        c = fm["counters"]
        check(c.get("serve.worker.died", 0) >= 1
              and c.get("serve.worker.restarted", 0) >= 1,
              f"front counters {c}")
        res["reroutes"] = c.get("serve.front.reroutes", 0.0)
        res["total_requests"] = len(records)
    finally:
        rc, err_text, _warm = stop_cli_serve(proc, err_path)
    check(rc == 0, f"fleet exited {rc}: {err_text[-2000:]}")
    reason, ring = flight_events(flight)
    named = {(e["name"], (e.get("args") or {}).get("replica_id"))
             for e in ring}
    check(reason == "sigterm" and ("serve.worker.died", 0) in named
          and ("serve.worker.restarted", 0) in named,
          f"the front's flight dump ({reason}) lacks replica 0's death "
          f"and restart")
    return res


def fleet_autoscale(d, cli_model, pool, card):
    """`cli serve --replicas-min 1 --replicas-max 2` on cuda, binned rung
    (K7, rows binned by the native library): SCALE_CLIENTS clients of
    64-row requests grow it to 2 (SCALE_KNOBS), SCALE_AT_TWO_S of traffic
    at 2, each replica's K7 launches from its own /metrics, then idling
    drains it back to 1. No request fails, every response bit-equal to the
    binned rung's CPU version, and the fleet never holds more than 2
    slots."""
    import numpy as np

    path = os.path.join(d, "binned", "gbdt.model")
    copy_model(cli_model, path)
    conf = serve_conf(path, d, "binned")
    want = binned_on_cpu(conf).score_batch(pool)
    flight = os.path.join(d, "binned_flight")
    env = dict(os.environ, YTK_SERVE_BINNED="1", YTK_OBS="1",
               PYTHONPATH=REPO, YTK_FLIGHT_DIR=flight,
               YTK_FLIGHT_N=str(1 << 20), **SCALE_KNOBS)
    env.pop("YTK_SERVE_FUSED", None)
    err_path = os.path.join(d, "binned.err")
    t0 = time.perf_counter()
    proc, banner = start_cli_serve(
        [conf, "gbdt", "--host", "127.0.0.1", "--port", "0",
         "--replicas-min", "1", "--replicas-max", "2", "--slo-ms", "0",
         "--watch-interval", "0"], env, err_path)
    res = {"spawn_to_ready_s": time.perf_counter() - t0}
    records, errors, slots = [], [], [1]
    try:
        port = banner["port"]
        check(banner["replicas"] == 1 and banner["autoscale"] is True
              and (banner["replicas_min"], banner["replicas_max"]) == (1, 2),
              f"autoscale banner {banner}")
        st, _h, rm = http_json("GET", banner["replica_ports"]["0"],
                               "/metrics")
        rung = rm["models"]["default"]["rung"]
        check((rung["backend"], rung.get("bin_mode")) ==
              ("binned-cuda", "edges"), f"replica rung {rung}")

        def ready(n, downs=0):
            """n slots, all ready, after `downs` reaps have completed (the
            front counts a reap once its replica has exited)."""
            _s, _h, m = http_json("GET", port, "/metrics")
            slots[0] = max(slots[0], m["fleet"]["replicas"])
            return (m["fleet"]["ready"] == n
                    and m["fleet"]["replicas"] == n
                    and m["counters"].get("serve.scale.down", 0) >= downs)

        stop = threading.Event()
        t_load = time.perf_counter()
        threads = fleet_traffic(port, pool, stop, records, errors, SEED + 500,
                                SCALE_CLIENTS, fixed_rows=64)
        t_two = wait_until(lambda: ready(2), "the fleet grew to 2",
                           timeout=180.0)
        res["grow_s"] = t_two - t_load
        time.sleep(SCALE_AT_TWO_S)
        join_traffic(stop, threads, errors, "autoscale")
        # read at once: the reap waits 12 idle ticks (3 s)
        res["launches"] = replica_launches(port, records, "autoscale fleet")
        check(sorted(res["launches"]) == [0, 1]
              and all(k > 0 for k in res["launches"].values()),
              f"both replicas must launch K7: {res['launches']}")
        one = [r for r in records if r["t1"] < t_two]
        two = [r for r in records if r["t0"] > t_two + 0.5]
        res["p50_ms_1"], res["p99_ms_1"] = lat_ms(one)
        res["p50_ms_2"], res["p99_ms_2"] = lat_ms(two)
        res["requests_1"], res["requests_2"] = len(one), len(two)
        t_idle = time.perf_counter()
        res["shrink_s"] = wait_until(lambda: ready(1, downs=1),
                                     "the fleet drained to 1") - t_idle
        got = np.asarray([s for r in records for s in r["scores"]])
        check(np.array_equal(got, np.concatenate(
            [want[r["lo"]:r["lo"] + r["n"]] for r in records])),
              "autoscale responses differ from the binned rung's CPU "
              "version")
        st, _h, out = http_json("POST", port, "/predict",
                                {"rows": pool[:8]})
        check(st == 200 and np.array_equal(np.asarray(out["scores"]),
                                           want[:8]), "after the drain")
        st, _h, fm = http_json("GET", port, "/metrics")
        c = fm["counters"]
        check(c.get("serve.scale.up", 0) >= 1
              and c.get("serve.scale.down", 0) >= 1
              and fm["autoscale"]["last_decision"]["action"] == "down",
              f"scale counters {c}, autoscale {fm['autoscale']}")
        check(slots[0] <= 2, f"the fleet held {slots[0]} slots, max 2")
        res["requests"] = len(records)
    finally:
        rc, err_text, _warm = stop_cli_serve(proc, err_path)
    check(rc == 0, f"autoscaling fleet exited {rc}: {err_text[-2000:]}")
    reason, ring = flight_events(flight)
    names = {e["name"] for e in ring}
    check({"serve.scale.up", "serve.scale.up_ready", "serve.scale.drain",
           "serve.scale.down_done"} <= names,
          f"the front's flight dump ({reason}) lacks the scale events")
    return res


def phase_fleet(tmp, cli_model, card):
    """Slice 16's main path, the serving fleet on the card, on
    phase_cli_train's model (20 trees, F = 28, depth 8): the native host
    library checked and K6/K7 built here first (fleet_native_checks), then
    `cli serve --replicas 2` on the fused rung (fleet_fused) and `cli serve
    --replicas-min 1 --replicas-max 2` on the binned rung
    (fleet_autoscale), each a front process whose replicas are `cli serve`
    processes sharing the card. Prints the `fleet` line. Returns the K6
    and K7 launches of the replicas' traffic."""
    import numpy as np

    from ytklearn_tpu_torch.gbdt.tree import GBDTModel

    d = os.path.join(tmp, "fleet")
    os.makedirs(d)
    names = [f"f{i}" for i in range(N_FEATURES)]
    with open(cli_model) as f:
        splits = split_values(GBDTModel.loads(f.read()))
    pool = random_rows(np.random.RandomState(SEED + 16), FLEET_POOL, names,
                       splits)
    native = fleet_native_checks(serve_conf(cli_model, d, "native"), pool,
                                 card)
    fused = fleet_fused(d, cli_model, pool, card)
    auto = fleet_autoscale(d, cli_model, pool, card)
    line = {"card": card, "native": native, "fused_2": fused,
            "autoscale_binned": auto}
    print(f"fleet: {json.dumps(line)}", flush=True)
    print(f"fleet: 2 fused replicas up in {fused['spawn_to_ready_s']:.3f} "
          f"s, client p50 {fused['p50_ms']:.4f} ms, p99 "
          f"{fused['p99_ms']:.4f} ms under {FLEET_CLIENTS} clients, K6 "
          f"launches {fused['launches']}; kill -9 to restarted "
          f"{fused['restart_s']:.3f} s, {fused['total_requests']} requests, "
          f"none failed, {fused['reroutes']} reroutes; autoscaling binned "
          f"fleet: up in {auto['spawn_to_ready_s']:.3f} s, grew to 2 after "
          f"{auto['grow_s']:.3f} s of load, p50/p99 {auto['p50_ms_1']:.4f}"
          f"/{auto['p99_ms_1']:.4f} ms at 1 replica and "
          f"{auto['p50_ms_2']:.4f}/{auto['p99_ms_2']:.4f} ms at 2 under "
          f"{SCALE_CLIENTS} clients of 64 rows, drained to 1 "
          f"{auto['shrink_s']:.3f} s after the load stopped, K7 launches "
          f"{auto['launches']} [{card}]", flush=True)
    return (sum(fused["launches"].values()),
            sum(auto["launches"].values()))


#: requests a ladder rung: (rows, repeats); every rung of LADDER filled
#: rows of phase_profile's kernel table: all of the capture's kernels
PROFILE_TOPK = 1 << 12
#: the head of phase_cli_train's text (train, test lines) the profiled
#: `cli train` runs read
PROFILE_LINES = (1 << 19, 1 << 16)
PROF_REQUESTS = ((1, 8), (5, 4), (8, 4), (40, 4), (64, 4), (300, 2),
                 (512, 2))
#: the libraries the profiling drill's path loads (or builds), and the
#: kernels it launches, each a first instantiation in its process
PROF_DRILL_LIBS = ("libytk_parse.so", "libytk_hist_float.so",
                   "libytk_route.so", "libytk_heap_walk.so")
PROF_DRILL_KERNELS = ("hist", "route", "heap_walk")


def plant_retrace(model):
    """Run in a fresh process (phase_profile): with the profiling plane on,
    a fused scorer on `model` warms up (K6's first launch, credited) and
    arms its retrace sentinel; then a binned scorer built without warmup
    scores a batch: K7's first launch in the process, a kernel
    instantiation the fused scorer did not warm, under the ledger label
    `serve.rung.<rung>`; the fused scorer's next batch fires
    health.retrace. Prints one JSON line: the retrace events before and
    after the plant, the counters, the ledger."""
    import numpy as np

    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs import profiler
    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.serve.scorer import CompiledScorer

    profiler.configure_profiler(on=True, mem_interval=0.0)
    pred = create_predictor("gbdt", {
        "model": {"data_path": model},
        "optimization": {"loss_function": "sigmoid", "round_num": 1000}})
    rng = np.random.RandomState(SEED + 17)
    rows = [{f"f{j}": float(rng.randn()) for j in range(N_FEATURES)}
            for _ in range(12)]
    fused = CompiledScorer(pred, mode="fused", device="cuda")
    fused.score_batch(rows)  # steady state: no build

    def retraces():
        return [e.get("args", {}) for e in obs.REGISTRY.events
                if e["name"] == "health.retrace"]

    before = retraces()
    binned = CompiledScorer(pred, mode="binned", device="cuda",
                            warmup=False)
    binned.score_batch(rows)
    fused.score_batch(rows)
    print(json.dumps({
        "before": before, "after": retraces(),
        "rungs": [fused.rung_info(), binned.rung_info()],
        "counters": obs.snapshot()["counters"],
        "ledger": profiler.LEDGER.snapshot(),
    }), flush=True)


def prof_serve(tmp, model, card):
    """A `YTK_PROF=1 cli serve` process on the fused rung under requests at
    every ladder rung (PROF_REQUESTS, one client): its /metrics?prof=1."""
    conf = serve_conf(model, tmp, "prof_serve")
    rows = read_holdout(os.path.join(tmp, "test.txt"),
                        max(n for n, _ in PROF_REQUESTS))
    env = dict(os.environ, YTK_SERVE_FUSED="1", YTK_PROF="1",
               PYTHONPATH=REPO)
    env.pop("YTK_SERVE_BINNED", None)
    err_path = os.path.join(tmp, "prof_serve.err")
    proc, banner = start_cli_serve(
        [conf, "gbdt", "--host", "127.0.0.1", "--port", "0"], env, err_path)
    try:
        check(banner["rung"]["backend"] == "fused-cuda", f"banner {banner}")
        port = banner["port"]
        sent = 0
        for n, repeats in PROF_REQUESTS:
            for _ in range(repeats):
                out = post(port, {"rows": rows[:n]})
                check(len(out["scores"]) == n, f"{n} rows scored "
                      f"{len(out['scores'])}")
                sent += n
        _s, _h, m = http_json("GET", port, "/metrics?prof=1")
    finally:
        rc, err_text, _warm = stop_cli_serve(proc, err_path)
    check(rc == 0, f"YTK_PROF cli serve exited {rc}: {err_text[-2000:]}")
    return m, sent


def phase_profile(tmp, model, card):
    """The profiling plane on the card (slice 17): `cli train gbdt
    --profile DIR --trace-out T` in this process on phase_cli_train's
    config and the head of its text (PROFILE_LINES), the same training
    without the flags and with the
    plane on but no capture (the plane's overhead), a `YTK_PROF=1 cli
    serve` process, a planted kernel instantiation in a fresh process, and
    scripts/prof_drill.py; every check hard."""
    import io

    from ytklearn_tpu_torch import cli, obs
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.obs import profiler

    pdir = os.path.join(tmp, "prof")
    os.makedirs(pdir, exist_ok=True)
    paths = {k: os.path.join(pdir, f"head_{k}.txt") for k in ("train",
                                                            "test")}
    for k, n_lines in zip(("train", "test"), PROFILE_LINES):
        head_lines(os.path.join(tmp, f"{k}.txt"), paths[k], n_lines)
    prof_dir = os.path.join(pdir, "captures")
    trace_out = os.path.join(pdir, "trace.json")
    argv = cli_train_argv(paths, os.path.join(pdir, "gbdt.model"))
    # the subprocesses start while this process trains: they wait for
    # nothing of it, and the drill and the plant hold no measurement
    drill_rec = os.path.join(pdir, "drill.json")
    os.makedirs(pdir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("YTK_PROF", "YTK_SERVE_FUSED", "YTK_SERVE_BINNED"):
        env.pop(k, None)
    runs = {}
    obs_was = obs.enabled()
    try:
        for tag, extra in (("plain", []), ("plane", ["--profile"]),
                           ("profiled", ["--profile", prof_dir,
                                         "--trace-out", trace_out])):
            if extra:
                # every kernel row in the table, not the top 10
                profiler.configure_profiler(topk=PROFILE_TOPK)
            zero_kernel_counts()
            out = io.StringIO()
            with Recorder(GBDTTrainer, "train") as trained, \
                    contextlib.redirect_stdout(out):
                t0 = time.perf_counter()
                rc = cli.main(argv + extra)
                wall = time.perf_counter() - t0
            res = json.loads(out.getvalue().strip().splitlines()[-1])
            check(rc == 0 and res["trees"] == CLI_ROUNDS,
                  f"cli train {tag}: rc {rc}, {res}")
            runs[tag] = (kernel_counts(), trained.calls[0][0].time_stats,
                         wall, res)
            if tag == "plane":  # the next run's report is its own
                profiler.configure_profiler(on=False)
                profiler.reset_profiler()
    finally:
        profiler.configure_profiler(on=False, capture_dir=None, topk=10)
        obs.configure(enabled=obs_was, trace_path=None)
    counts, ts, wall, res = runs["profiled"]
    _pcounts, pts, pwall, pres = runs["plain"]
    _ncounts, nts, nwall, _nres = runs["plane"]
    with open(os.path.join(prof_dir, "ytkprof.json")) as f:
        rep = json.load(f)
    profiler.reset_profiler()
    obs.reset()
    top = dict(rep, kernels=dict(rep["kernels"],
                                 top_kernels=rep["kernels"]["top_kernels"][:12]))
    print("profile: the report of `cli train gbdt --profile DIR "
          f"--trace-out T` (its top 12 kernels) [{card}]:\n"
          f"{profiler.format_report(top)}", flush=True)
    cov = rep["phase_coverage"]
    check(cov >= 0.9, f"phase coverage {cov} of the cli train run < 0.9")
    check({"gbdt.load", "gbdt.preprocess", "gbdt.train", "gbdt.finalize"}
          <= set(rep["phases"]), f"phases {list(rep['phases'])}")
    kern = rep["kernels"]
    win = [w for w in kern["windows"] if w["phase"] == "gbdt.train"]
    check(len(win) == 1 and win[0]["device"] and win[0]["device_busy_ms"] > 0,
          f"the gbdt.train capture traced no device event: {kern['windows']}")
    busy = win[0]["device_busy_ms"] / win[0]["window_ms"]
    table = {k["name"]: k for k in kern["top_kernels"]}
    k_rows = ("hist", "hist_gather", "route")
    # the port's kernels counted under their own names: their launch's
    # annotation missed them (shown when a row below disagrees)
    stray = [(n[:60], r["count"]) for n, r in table.items()
             if "anonymous namespace" in n]
    for name, k in zip(k_rows, ("K1", "K3", "K5")):
        row = table.get(name)
        check(row is not None and row["ms"] > 0
              and row["count"] == counts[name],
              f"kernel table row of {k} ({name}) {row} against its "
              f"wrapper's {counts[name]} launches; the table's K1/K3/K5 "
              f"rows {[table.get(n) for n in k_rows]} of {len(table)}, "
              f"launches {counts}; rows of the port's kernels outside a "
              f"launch's annotation {stray}")
    krows = ", ".join(f"{n} {table[n]['ms']:.3f} ms x{table[n]['count']} "
                      f"({100 * table[n]['share']:.1f}%)"
                      for n in ("hist", "hist_gather", "route"))
    print(f"profile: gbdt.train capture: device busy "
          f"{win[0]['device_busy_ms']:.3f} of {win[0]['window_ms']:.3f} ms "
          f"({100 * busy:.2f}%), device total {kern['device_total_ms']:.3f}"
          f" ms; {krows}; launches hist {counts['hist']}, hist_gather "
          f"{counts['hist_gather']}, route {counts['route']} [{card}]",
          flush=True)
    with open(trace_out) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    check({"gbdt.train", "gbdt.round", "gbdt.sync", "ingest.parse"} <= names,
          f"--trace-out holds no trainer spans: {sorted(names)[:20]}")
    print(f"profile: rounds {ts['train']:.3f} s profiled (phase "
          f"gbdt.train {rep['phases']['gbdt.train']['wall_s']:.3f} s with the"
          f" capture's start and export), {nts['train']:.3f} s with the "
          f"plane on and no capture (`--profile`), {pts['train']:.3f} s "
          f"plain: overhead x{ts['train'] / pts['train']:.3f} and "
          f"x{nts['train'] / pts['train']:.3f}; the cli run {wall:.3f} s "
          f"profiled, {nwall:.3f} s with the plane, {pwall:.3f} s plain; "
          f"test AUC {res['test_metrics']['auc']:.6f} and "
          f"{pres['test_metrics']['auc']:.6f} [{card}]", flush=True)

    # a fresh process for the plant and one for the drill, beside the
    # serving process
    plant = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke; chip_smoke.plant_retrace(sys.argv[1])",
         model], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    drill = subprocess.Popen(
        [sys.executable, "-m", "ytklearn_tpu_torch.scripts.prof_drill",
         "--record", drill_rec], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        m, sent = prof_serve(tmp, model, card)
    finally:
        p_out, p_err = plant.communicate(timeout=600)
        d_out, d_err = drill.communicate(timeout=600)
    prof = m["prof"]
    rungs = prof["models"]["default"]["rungs"]
    c = m["counters"]
    print(f"profile: YTK_PROF cli serve, {sent} rows in "
          f"{sum(r for _, r in PROF_REQUESTS)} requests; /metrics?prof=1 "
          f"rungs {json.dumps(rungs)}; compile.retraces.unexpected "
          f"{c.get('compile.retraces.unexpected', 0)}; ledger "
          f"{json.dumps(prof['compile']['by_program'])} [{card}]",
          flush=True)
    check(prof["enabled"] and set(rungs) == {str(r) for r in LADDER}
          and all(v["calls"] > 0 for v in rungs.values())
          and sum(v["rows"] for v in rungs.values()) == sent,
          f"/metrics?prof=1 rungs {rungs} against {sent} rows sent")
    check(c.get("compile.retraces.unexpected", 0) == 0
          and c.get("health.retrace", 0) == 0,
          f"retraces over steady serving: {c}")
    kinds = {(e["kind"], e.get("kernel")) for e in prof["compile"]["entries"]}
    check(("load", "libytk_heap_walk.so") in kinds
          and ("instantiate", "heap_walk[]") in kinds,
          f"the serving ledger lacks K6's load or instantiation: {kinds}")

    check(plant.returncode == 0, f"plant: rc {plant.returncode}: "
          f"{p_err[-3000:]}")
    planted = json.loads(p_out.strip().splitlines()[-1])
    after = planted["after"]
    culprits = [cu for a in after for cu in a.get("culprits", [])]
    print(f"profile: planted K7 instantiation in a fresh process: rungs "
          f"{planted['rungs'][0]['backend']} then "
          f"{planted['rungs'][1]['backend']}; health.retrace before "
          f"{len(planted['before'])}, after {len(after)}: {json.dumps(after)}"
          f" [{card}]", flush=True)
    check(not planted["before"] and len(after) == 1
          and any(cu["program"].startswith("serve.rung.")
                  and cu.get("kernel", "").startswith("binned_walk[")
                  for cu in culprits),
          f"the planted instantiation did not fire health.retrace with its "
          f"culprit: {planted}")

    summary = (d_out.strip().splitlines() or [""])[0]
    print(f"profile: prof_drill: {summary}", flush=True)
    check(drill.returncode == 0, f"prof_drill: rc {drill.returncode}: "
          f"{summary[:2000]} {d_err[-2000:]}")
    with open(drill_rec) as f:
        drec = json.load(f)
    entries = drec["ledger"]["entries"]
    done = {e.get("kernel") for e in entries if e["kind"] in ("load", "build")}
    inst = {e.get("kernel", "").split("[")[0] for e in entries
            if e["kind"] == "instantiate"}
    check(drec["ok"] and set(PROF_DRILL_LIBS) <= done
          and set(PROF_DRILL_KERNELS) <= inst,
          f"prof_drill: ok {drec['ok']}, failures {drec['failures']}, "
          f"libraries {sorted(done)}, instantiations {sorted(inst)}")
    dwin = drec["prof"]["kernels"]["windows"][0]
    led = ", ".join(f"{e['kind']} {e.get('kernel')} {e['ms']:.3f} ms "
                    f"({e['program']})" for e in entries)
    print(f"profile: prof_drill ok, coverage {drec['phase_coverage']}, "
          f"gbdt.train busy {dwin['device_busy_ms']:.3f} of "
          f"{dwin['window_ms']:.3f} ms; serve rungs "
          f"{json.dumps(drec['serve']['rungs'])}; ledger: {led} [{card}]",
          flush=True)


DIST_ROUNDS = 5  # phase_dist's trees (the Higgs config's width: 255
#                  leaves, 255 bins, F = 28), int8 so the dumps can be equal
DIST_LOSS_RTOL = 0.05  # merged bins (tests/test_multiprocess.py:139-152)
DIST_PREDICT_ROWS = 4096
DIST_TIMEOUT_S = 420
#: the head of phase_cli_train's text (train, test lines) the one-rank
#: run and parts (1)-(3) read: each of their processes parses it
DIST_LINES = (1 << 17, 1 << 14)
#: the feature-parallel part: text lines, trees, depth (level-wise)
DIST_FP = ((1 << 17, 1 << 14), 3, 6)
DIST_FP_RTOL = 1e-4  # tests/test_feature_parallel.py's loss and AUC bands


def dist_argv(paths, model):
    """phase_dist's `cli train gbdt` (phase_cli_train's config and text,
    DIST_ROUNDS int8 trees)."""
    return (cli_train_argv(paths, model)[:-4]
            + ["--set", f"optimization.round_num={DIST_ROUNDS}",
               "--set", f"optimization.max_depth={CLI_DEPTH}",
               "--hist-precision", "int8"])


def run_cli_procs(argvs, tmp, tag):
    """`python -m ytklearn_tpu_torch.cli <argv>` for each argv, all at once
    (stderr to files: a rank blocked on a full pipe while its peer waits in
    a collective would hang the group) -> (the JSON lines, seconds)."""
    return finish_cli_procs(start_cli_procs(argvs, tmp, tag))


def start_cli_procs(argvs, tmp, tag):
    """run_cli_procs's processes, started; finish_cli_procs waits."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    procs, errs = [], []
    for i, argv in enumerate(argvs):
        ef = open(os.path.join(tmp, f"{tag}.{i}.err"), "w+")
        errs.append(ef)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ytklearn_tpu_torch.cli"] + argv,
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=ef, text=True))
    return procs, errs, t0, tag


def finish_cli_procs(started):
    """Wait for start_cli_procs's processes -> (the JSON lines, seconds
    since they started); a failed process fails the run."""
    procs, errs, t0, tag = started
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=DIST_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for i, (p, ef) in enumerate(zip(procs, errs)):
        ef.seek(0)
        err = ef.read()
        ef.close()
        check(p.returncode == 0,
              f"{tag} process {i} exited {p.returncode}: {err[-3000:]}")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs], wall


def same_files(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def fmt_census(c):
    return ", ".join(f"{k} {v['calls']} calls {v['bytes']} B"
                     + (f" ({v['staged']} staged)" if v.get("staged") else "")
                     for k, v in sorted(c.items()))


LAUNCHER = os.path.join(REPO, "ytklearn_tpu_torch", "bin",
                        "cluster_optimizer.sh")


def launch_ranks(argv, n, d):
    """`cli <argv>` (`train <model> <config> ...`) on n `--coordinator`
    ranks through the port's cluster launcher -> (each rank's JSON line:
    rank 0's from the launcher's stdout, the others' from its master log;
    seconds; the master log's text)."""
    from ytklearn_tpu_torch.gbdt.launch import free_port

    model, conf = argv[1], argv[2]
    log_path = os.path.join(d, "master.log")
    env = dict(os.environ, PYTHON=sys.executable,
               YTK_COORDINATOR_PORT=str(free_port()),
               YTK_MASTER_LOG=log_path)
    for k in ("YTK_SLAVE_HOSTS", "YTK_COORDINATOR_HOST"):
        env.pop(k, None)
    t0 = time.perf_counter()
    with open(os.path.join(d, "launcher.err"), "w+") as ef:
        # a session of its own, so a launcher past its time is stopped
        # with its ranks
        p = subprocess.Popen(["bash", LAUNCHER, model, conf, str(n)]
                             + argv[3:], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=ef, text=True,
                             start_new_session=True)
        try:
            out, _ = p.communicate(timeout=DIST_TIMEOUT_S)
        finally:
            kill_script((p,))
        ef.seek(0)
        err = ef.read()
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"the launcher exited {p.returncode}: "
          f"{err[-3000:]}")
    with open(log_path) as f:
        master = f.read()
    recs = [json.loads(out.strip().splitlines()[-1])]
    for r in range(1, n):
        tag = f"[rank {r}] {{"
        lines = [ln for ln in master.splitlines() if ln.startswith(tag)]
        check(len(lines) == 1, f"rank {r}'s JSON line in the master log: "
              f"{len(lines)}")
        recs.append(json.loads(lines[0][len(tag) - 1:]))
    return recs, wall, master


def phase_dist(tmp, card):
    """GBDT across ranks (slice 18) on the head (DIST_LINES) of
    phase_cli_train's Higgs-shaped text at full width (F = 28, 255 bins,
    255 leaves), DIST_ROUNDS int8 trees:
    the one-rank `cli train gbdt` in this process, then (1) `--coordinator`
    at world size 1 over NCCL, its dump byte-identical; (2) `--devices 2`
    with both ranks on cuda:0 over gloo (one launcher, bins built once),
    its int8 dump byte-identical to the one-rank dump; (3) two
    `--coordinator` processes on cuda:0 over gloo, each ingesting its
    lines_avg shard, started by the port's launcher
    (`ytklearn_tpu_torch/bin/cluster_optimizer.sh`): both ranks labelled in
    its master log, rank 0's train loss within DIST_LOSS_RTOL of one
    process, its model scored by `cli predict`;
    (4) scripts/cross_check.py's card arm (full scan K2, partitioned,
    fused K4) equal to the golden tree; (5) `tree_maker = "feature"` on
    `--devices 2` sharing the card (the host engine on every rank, the
    columns sharded: K1 at f32 over each rank's columns) against one
    rank's level-wise host engine, loss and test AUC within DIST_FP_RTOL.
    Prints each part's backend, seconds, per-rank K2/K4/K5 (K1 in part 5)
    launches and collective census."""
    from ytklearn_tpu_torch.gbdt.launch import free_port
    from ytklearn_tpu_torch.scripts import cross_check

    full = {k: os.path.join(tmp, f"{k}.txt") for k in ("train", "test")}
    d = os.path.join(tmp, "dist")
    os.makedirs(d, exist_ok=True)
    paths = {k: os.path.join(d, f"head_{k}.txt") for k in full}
    for k, n_lines in zip(("train", "test"), DIST_LINES):
        head_lines(full[k], paths[k], n_lines)
    base = os.path.join(d, "one", "gbdt.model")
    zero_kernel_counts()
    t0 = time.perf_counter()
    rc, one = cli_quiet(dist_argv(paths, base))
    t_one = time.perf_counter() - t0
    c1 = kernel_counts()
    check(rc == 0 and one["trees"] == DIST_ROUNDS, f"one rank: {rc} {one}")
    print(f"dist: one rank, in this process: {t_one:.3f} s, train loss "
          f"{one['train_loss']:.6f}, test AUC "
          f"{one['test_metrics']['auc']:.6f}; launches hist_q "
          f"{c1['hist_q']}, hist_gather_q {c1['hist_gather_q']}, route "
          f"{c1['route']} [{card}]", flush=True)
    check(c1["hist_q"] > 0 and c1["route"] > 0 and c1["hist"] == 0,
          f"one rank did not run K2 and K5 only: {c1}")

    def ranks_line(part, reps, wall):
        for r in reps:
            ln = r["launches"]
            print(f"dist {part}: rank {r['rank']} on {r['device']}, backend "
                  f"{r['backend']}, {r['seconds']:.3f} s in train(); "
                  f"launches hist_q {ln['hist_q']}, hist_gather_q "
                  f"{ln['hist_gather_q']}, route {ln['route']}; "
                  f"collectives: {fmt_census(r['collectives'])} [{card}]",
                  flush=True)
            check(ln["hist_q"] > 0 and ln["route"] > 0 and ln["hist"] == 0,
                  f"dist {part}: rank {r['rank']} did not run K2 and K5: "
                  f"{ln}")
            check(r["collectives"].get("psum_scatter", {}).get("calls", 0)
                  > 0 and r["collectives"].get("pargmax", {}).get(
                      "calls", 0) > 0,
                  f"dist {part}: rank {r['rank']} ran no histogram merge")
        print(f"dist {part}: {wall:.3f} s (wall, the processes' start and "
              f"the text parse included) beside {t_one:.3f} s for one rank "
              f"in this process [{card}]", flush=True)

    # (1) NCCL at world size 1
    m1 = os.path.join(d, "nccl1", "gbdt.model")
    (r1,), w1 = run_cli_procs([dist_argv(paths, m1) + [
        "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
        "--process-id", "0"]], d, "nccl1")
    check(r1["rank"]["backend"] == "nccl", f"world 1 ran {r1['rank']}")
    ranks_line("(1) --coordinator, world 1", [r1["rank"]], w1)
    eq1 = same_files(base, m1) and same_files(base + ".bins.json",
                                              m1 + ".bins.json")
    print(f"dist (1): dump and bin sidecar byte-identical to one rank: {eq1}"
          f" [{card}]", flush=True)
    check(eq1, "the NCCL world-1 dump is not the one-rank dump")

    # (2) --devices 2, both ranks on cuda:0 over gloo
    m2 = os.path.join(d, "dev2", "gbdt.model")
    (r2,), w2 = run_cli_procs([dist_argv(paths, m2) + [
        "--devices", "2", "--rank-devices", "cuda:0,cuda:0"]], d, "dev2")
    check([r["backend"] for r in r2["ranks"]] == ["gloo", "gloo"],
          f"--devices 2 on one card: {r2['ranks']}")
    ranks_line("(2) --devices 2 on cuda:0", r2["ranks"], w2)
    eq2 = same_files(base, m2)
    print(f"dist (2): int8 dump byte-identical to one rank: {eq2}; train "
          f"loss {r2['train_loss']:.6f} beside {one['train_loss']:.6f}; "
          f"two ranks sharing one card are expected no faster than one "
          f"[{card}]", flush=True)
    check(eq2, "the two-rank --devices dump is not the one-rank dump")

    # (3) two --coordinator processes on cuda:0 over gloo, started by the
    # port's cluster launcher (rank 0 in its foreground, rank 1 beside it,
    # both rank-labelled in one master log)
    m3 = os.path.join(d, "coord2", "gbdt.model")
    r3, w3, master = launch_ranks(dist_argv(paths, m3), 2, d)
    ranks_line("(3) two --coordinator processes through the launcher",
               [r["rank"] for r in r3], w3)
    labelled = {r: sum(ln.startswith(f"[rank {r}] ")
                       for ln in master.splitlines()) for r in range(2)}
    print(f"dist (3): the master log holds {labelled[0]} lines of rank 0 "
          f"and {labelled[1]} of rank 1 [{card}]", flush=True)
    check(labelled[0] > 0 and labelled[1] > 0,
          f"the launcher's master log lacks a rank: {labelled}")
    rel = abs(r3[0]["train_loss"] - one["train_loss"]) / one["train_loss"]
    print(f"dist (3): rank 0 train loss {r3[0]['train_loss']:.6f}, one "
          f"process {one['train_loss']:.6f} (rel {rel:.6f}, band "
          f"{DIST_LOSS_RTOL}); test AUC {r3[0]['test_metrics']['auc']:.6f}"
          f"; rank 1's trees {r3[1]['trees']} [{card}]", flush=True)
    check(rel <= DIST_LOSS_RTOL, f"two processes' loss rel {rel}")
    # every rank gets the launcher's one command line, so both name the
    # same model path: the one dump there is rank 0's, and the ranks'
    # records agree on the trees
    check(os.path.exists(m3) and r3[1]["trees"] == r3[0]["trees"],
          "rank 0 must dump, and the ranks must agree")
    pfile = os.path.join(d, "predict.txt")
    with open(paths["test"]) as f, open(pfile, "w") as g:
        for i, line in enumerate(f):
            if i >= DIST_PREDICT_ROWS:
                break
            g.write(line)
    rc, pred = cli_quiet(["predict", serve_conf(m3, d, "dist"), "gbdt",
                          pfile, "--set", "optimization.round_num=0"])
    with open(pfile + "_predict") as f:
        preds = [float(v) for v in f.read().split()]
    print(f"dist (3): cli predict of rank 0's model over "
          f"{DIST_PREDICT_ROWS} test lines: rc {rc}, {pred} [{card}]",
          flush=True)
    check(rc == 0 and len(preds) == DIST_PREDICT_ROWS
          and all(0.0 < v < 1.0 for v in preds), "cli predict of rank 0")

    # (4) the cross-check's card arm
    zero_kernel_counts()
    t0 = time.perf_counter()
    sigs = cross_check.card_arm("cuda")
    c4 = kernel_counts()
    with open(cross_check.GOLDEN) as f:
        golden = json.load(f)
    ok4 = {k: cross_check.matches(v, golden) for k, v in sigs.items()}
    print(f"dist (4): cross_check card arm {ok4} in "
          f"{time.perf_counter() - t0:.3f} s; launches hist_q "
          f"{c4['hist_q']}, hist_gather_q {c4['hist_gather_q']}, route "
          f"{c4['route']} [{card}]", flush=True)
    check(all(ok4.values()) and c4["hist_gather_q"] > 0,
          f"cross_check card arm: {ok4}, {c4}")

    # (5) the feature-parallel maker, two ranks sharing the card
    (n_fp, nt_fp), fp_rounds, fp_depth = DIST_FP
    small = {k: os.path.join(d, f"fp_{k}.txt") for k in ("train", "test")}
    for k, n_lines in (("train", n_fp), ("test", nt_fp)):
        head_lines(full[k], small[k], n_lines)

    def fp_argv(model):
        return (cli_train_argv(small, model)[:-4]
                + ["--set", "optimization.tree_maker=feature",
                   "--set", "optimization.tree_grow_policy=level",
                   "--set", f"optimization.max_depth={fp_depth}",
                   "--set", f"optimization.round_num={fp_rounds}"])

    mf1 = os.path.join(d, "fp1", "gbdt.model")
    rc, fp1 = cli_quiet(fp_argv(mf1))
    check(rc == 0 and fp1["trees"] == fp_rounds, f"fp one rank: {fp1}")
    mf2 = os.path.join(d, "fp2", "gbdt.model")
    (r5,), w5 = run_cli_procs([fp_argv(mf2) + [
        "--devices", "2", "--rank-devices", "cuda:0,cuda:0"]], d, "fp2")
    for r in r5["ranks"]:
        ln = r["launches"]
        print(f"dist (5) feature-parallel: rank {r['rank']} on {r['device']}"
              f", backend {r['backend']}, engine {r['engine']}, "
              f"{r['seconds']:.3f} s in train(); launches hist {ln['hist']}"
              f" (K1, f32), route {ln['route']}; collectives: "
              f"{fmt_census(r['collectives'])} [{card}]", flush=True)
        check(r["engine"] == "host" and ln["hist"] > 0,
              f"dist (5): rank {r['rank']} ran no K1: {r}")
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel

    with open(mf1) as f, open(mf2) as g:
        t1, t2 = GBDTModel.loads(f.read()).trees, GBDTModel.loads(
            g.read()).trees
    same = sum(a.feat == b.feat and a.left == b.left and a.right == b.right
               for a, b in zip(t1, t2))
    rel5 = abs(r5["train_loss"] - fp1["train_loss"]) / fp1["train_loss"]
    auc5 = abs(r5["test_metrics"]["auc"] - fp1["test_metrics"]["auc"])
    print(f"dist (5): {n_fp} + {nt_fp} lines, {fp_rounds} level-wise trees"
          f" of depth {fp_depth}: {w5:.3f} s (wall) for the two ranks; train"
          f" loss {r5['train_loss']:.6f} beside one rank's "
          f"{fp1['train_loss']:.6f} (rel {rel5:.2e}), test AUC delta "
          f"{auc5:.2e}; {same} of {len(t1)} trees of the same structure "
          f"(K1 adds f32 with atomics, the host engine in float64) "
          f"[{card}]", flush=True)
    check(rel5 <= DIST_FP_RTOL and auc5 <= DIST_FP_RTOL,
          f"feature-parallel against one rank: rel {rel5}, AUC {auc5}")
    return {"one": c1, "devices2": [r["launches"] for r in r2["ranks"]],
            "coord2": [r["rank"]["launches"] for r in r3],
            "feature2": [r["launches"] for r in r5["ranks"]]}


# -- slice 19: the convex families and GBST across ranks ----------------------

#: the FM cell's width (bench.py:367-422: 38 features and the bias a row,
#: dim 2^18, rank 8), its depth cut to these text lines (train, test)
DCONV_LINES = (1 << 16, 1 << 13)
DCONV_ITERS = 10  # L-BFGS iterations of the linear and FM runs
DCONV_GBST = ((1 << 15, 1 << 12), 2)  # gbmlr's lines and trees (K = 8)
#: `cli retrain gbdt`: phase_cli_train's text cut to these lines (train,
#: held-out), int8 trees, depth
DCONV_RETRAIN = ((1 << 17, 1 << 14), 5, 6)
DCONV_RTOL = 1e-4  # tests/test_torch_mesh_convex.py's tolerances
DCONV_MP_RTOL = 1e-3  # tests/test_multiprocess.py's two-process bound


def head_lines(src, dst, n):
    """The first n lines of `src` into `dst`."""
    with open(src) as f, open(dst, "w") as g:
        for i, line in enumerate(f):
            if i >= n:
                break
            g.write(line)


def dconv_argv(d, family, cfg, tag, extra=()):
    """`cli train <family>` of `cfg` dumping into d/tag/model."""
    c = json.loads(json.dumps(cfg))
    c["model"]["data_path"] = os.path.join(d, tag, "model")
    conf = os.path.join(d, f"{tag}.conf")
    with open(conf, "w") as f:
        json.dump(c, f)
    return ["train", family, conf] + list(extra)


def same_tree(a, b):
    """Every file under directory `a` is in `b` with the same bytes."""
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _d, fs in os.walk(a) for f in fs)
    return bool(files) and all(
        same_files(os.path.join(a, p), os.path.join(b, p)) for p in files)


def phase_dist_convex(tmp, card):
    """The convex families and GBST across ranks (slice 19): `cli train
    linear` and `cli train fm` at the FM cell's width (DCONV_LINES lines
    of 38 features and the bias, dim about 2^18, rank 8, DCONV_ITERS
    L-BFGS iterations) in this process on one rank while one batch of
    processes runs: (a) each under `--coordinator` at world size 1 over NCCL,
    its dump byte-identical to the one-rank dump; (b) each on `--devices
    2` with both ranks on cuda:0 over gloo: the same iterations and
    status, the loss at rtol DCONV_RTOL and test AUC within 1e-4 of one
    rank; (c) gbmlr on `--devices 2` at GBST_HELD_ITERS against one rank
    (trees equal, losses at DCONV_RTOL); (d) two `--coordinator` linear
    processes, each ingesting its lines_avg shard: the loss within
    DCONV_MP_RTOL of one process, rank 1 dumping nothing; then (e) `cli
    retrain gbdt` (continual.retrain, int8) of phase_cli_train's text cut
    to DCONV_RETRAIN on one device and on two ranks sharing the card: the
    two ranks launch K2 and K5 each, the gate in this process launches
    K6, and both promote the same bytes. No kernel of the port runs on
    the convex and GBST paths (the wrappers' counts in this process stay
    where they were). Prints each part's seconds, backend and collective
    census."""
    from unittest import mock

    from ytklearn_tpu_torch import continual
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.gbdt.launch import free_port
    from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case, \
        write_gbst_case
    from ytklearn_tpu_torch.serve import kernels

    d = os.path.join(tmp, "dist_convex")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    (n, n_test), ((gn, gn_test), g_trees) = DCONV_LINES, DCONV_GBST
    fm = write_convex_case(os.path.join(d, "fm_data"), "fm", n, n_test,
                           CONVEX_SEED, vocab=(1 << 18) - 1, nnz=38, k=8,
                           max_iter=DCONV_ITERS)
    fm["optimization"]["line_search"]["lbfgs"]["convergence"]["eps"] = 1e-7
    lin = json.loads(json.dumps(fm))
    del lin["k"]
    gb = write_gbst_case(os.path.join(d, "gbst_data"), gn, gn_test,
                         CONVEX_SEED, K=8, tree_num=g_trees,
                         learning_rate=0.3, instance_sample_rate=0.8,
                         feature_sample_rate=0.8,
                         max_iter=GBST_HELD_ITERS, **GBST_SHAPE)
    gb["loss"]["evaluate_metric"] = ["auc"]
    gb["optimization"]["line_search"]["lbfgs"]["convergence"]["eps"] = 1e-7
    print(f"dist_convex: text written in {time.perf_counter() - t0:.3f} s "
          f"({n} + {n_test} lines of 38 features, {gn} + {gn_test} GBST "
          f"lines) [{card}]", flush=True)
    runs = {"linear": ("linear", lin), "fm": ("fm", fm),
            "gbmlr": ("gbmlr", gb)}
    # (a), (b), (c) and (d) in one batch of processes, started first; the
    # one-rank runs go in this process while they start
    mp = json.loads(json.dumps(lin))
    mp["data"]["assigned"] = False
    mp["data"]["unassigned_mode"] = "lines_avg"
    port_mp = free_port()
    batch = {}
    for name in ("linear", "fm"):
        family, cfg = runs[name]
        batch[f"{name}_nccl1"] = dconv_argv(d, family, cfg, f"{name}_nccl1", [
            "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
            "1", "--process-id", "0"])
    for name in ("linear", "fm", "gbmlr"):
        family, cfg = runs[name]
        batch[f"{name}_dev2"] = dconv_argv(d, family, cfg, f"{name}_dev2", [
            "--devices", "2", "--rank-devices", "cuda:0,cuda:0"])
    for r in range(2):
        batch[f"linear_coord2_r{r}"] = dconv_argv(
            d, "linear", mp, f"linear_coord2_r{r}", [
                "--coordinator", f"127.0.0.1:{port_mp}", "--num-processes",
                "2", "--process-id", str(r)])
    started = start_cli_procs(list(batch.values()), d, "dconv")
    before = launch_counts()
    one = {}
    for name, (family, cfg) in runs.items():
        t1 = time.perf_counter()
        rc, line = cli_quiet(dconv_argv(d, family, cfg, f"{name}_one"))
        one[name] = line
        check(rc == 0 and line["model"] == family, f"{name} one rank: "
              f"{line}")
        print(f"dist_convex: {name} on one rank, in this process: "
              f"{time.perf_counter() - t1:.3f} s, {line} [{card}]",
              flush=True)
    check(launch_counts() == before,
          "a kernel wrapper launched on the convex or GBST path")

    outs, wall = finish_cli_procs(started)
    got = dict(zip(batch, outs))
    print(f"dist_convex (a)-(d): {len(batch)} processes at once, "
          f"{wall:.3f} s (wall, their start and parse included) [{card}]",
          flush=True)

    def rank_lines(part, reps):
        for r in reps:
            print(f"dist_convex {part}: rank {r['rank']} on {r['device']}, "
                  f"backend {r['backend']}, {r['seconds']:.3f} s in train();"
                  f" collectives: {fmt_census(r['collectives'])} [{card}]",
                  flush=True)
            check(r["collectives"].get("psum", {}).get("calls", 0) > 0,
                  f"dist_convex {part}: rank {r['rank']} ran no psum")

    for name in ("linear", "fm"):
        # (a) NCCL at world size 1
        g = got[f"{name}_nccl1"]
        rank_lines(f"(a) {name} --coordinator, world 1", [g["rank"]])
        check(g["rank"]["backend"] == "nccl", f"(a) {name}: {g['rank']}")
        eq = same_tree(os.path.join(d, f"{name}_one", "model"),
                       os.path.join(d, f"{name}_nccl1", "model"))
        print(f"dist_convex (a) {name}: n_iter {g['n_iter']}, avg_loss "
              f"{g['avg_loss']!r} beside one rank's "
              f"{one[name]['avg_loss']!r}; dump byte-identical to one rank:"
              f" {eq} [{card}]", flush=True)
        check(eq, f"(a) {name}: the NCCL world-1 dump is not the one-rank "
              "dump")
    for name in ("linear", "fm", "gbmlr"):
        # (b), (c) two ranks sharing the card
        g, o = got[f"{name}_dev2"], one[name]
        rank_lines(f"({'c' if name == 'gbmlr' else 'b'}) {name} "
                   "--devices 2 on cuda:0", g["ranks"])
        check([r["backend"] for r in g["ranks"]] == ["gloo", "gloo"],
              f"{name} --devices 2: {g['ranks']}")
        if name == "gbmlr":
            pairs = [(g["train_loss"], o["train_loss"]),
                     (g["test_loss"], o["test_loss"])]
            same = g["trees"] == o["trees"] == g_trees
        else:
            pairs = [(g["avg_loss"], o["avg_loss"]),
                     (g["test_loss"], o["test_loss"])]
            same = (g["n_iter"], g["status"]) == (o["n_iter"], o["status"])
        rel = max(abs(a - b) / abs(b) for a, b in pairs)
        dauc = abs(g["test_metrics"]["auc"] - o["test_metrics"]["auc"])
        print(f"dist_convex ({'c' if name == 'gbmlr' else 'b'}) {name} on "
              f"two ranks: {g} beside one rank's {o}: losses rel "
              f"{rel:.3e}, test AUC delta {dauc:.3e} [{card}]", flush=True)
        check(same and rel <= DCONV_RTOL and dauc <= 1e-4,
              f"{name} --devices 2 against one rank: rel {rel}, AUC "
              f"{dauc}, {g} {o}")
    # (d) two --coordinator processes, each on its lines_avg shard
    g0, g1 = got["linear_coord2_r0"], got["linear_coord2_r1"]
    rank_lines("(d) two --coordinator linear processes",
               [g0["rank"], g1["rank"]])
    rel = abs(g0["avg_loss"] - one["linear"]["avg_loss"]) \
        / one["linear"]["avg_loss"]
    print(f"dist_convex (d): rank 0 avg_loss {g0['avg_loss']!r} (rank 1 "
          f"{g1['avg_loss']!r}), one process {one['linear']['avg_loss']!r}"
          f" (rel {rel:.3e}, band {DCONV_MP_RTOL}); n_iter {g0['n_iter']} "
          f"[{card}]", flush=True)
    check(g0["avg_loss"] == g1["avg_loss"] and rel <= DCONV_MP_RTOL
          and g0["n_iter"] == one["linear"]["n_iter"],
          f"two --coordinator processes: {g0} {g1}")
    check(os.path.exists(os.path.join(d, "linear_coord2_r0", "model"))
          and not os.path.exists(os.path.join(d, "linear_coord2_r1")),
          "rank 0 must dump and rank 1 must not")

    # (e) cli retrain gbdt on two ranks sharing the card
    (rn, rn_test), r_rounds, r_depth = DCONV_RETRAIN
    rt = {k: os.path.join(d, f"rt_{k}.txt") for k in ("train", "test")}
    head_lines(os.path.join(tmp, "train.txt"), rt["train"], rn)
    head_lines(os.path.join(tmp, "test.txt"), rt["test"], rn_test)
    res = {}
    for tag, devices in (("one", None), ("two", ["cuda:0", "cuda:0"])):
        cfg = hocon.load(CONF)
        model = os.path.join(d, f"rt_{tag}", "gbdt.model")
        for key, val in (("data.train.data_path", rt["train"]),
                         ("data.test.data_path", rt["test"]),
                         ("model.data_path", model),
                         ("model.feature_importance_path", model + ".imp"),
                         ("optimization.round_num", r_rounds),
                         ("optimization.max_depth", r_depth)):
            hocon.set_path(cfg, key, val)
        zero_kernel_counts()
        k6 = kernels.heap_walk.launches
        t1 = time.perf_counter()
        # the gate scores on the fused rung (K6), as phase_continual's
        with mock.patch.dict(os.environ, {"YTK_SERVE_FUSED": "1"}):
            r = continual.retrain("gbdt", cfg, device="cuda",
                                  devices=devices, hist_precision="int8")
        secs = time.perf_counter() - t1
        c = kernel_counts()
        k6 = kernels.heap_walk.launches - k6
        res[tag] = (r, model, c, secs, k6)
        print(f"dist_convex (e) retrain gbdt, {tag} "
              f"{'rank' if devices is None else 'ranks on cuda:0'}: "
              f"{secs:.3f} s, promoted {r.promoted} v{r.version}, trained "
              f"{r.trained}, held-out loss {r.gate.candidate_loss!r}; this "
              f"process launched hist_q {c['hist_q']}, hist_gather_q "
              f"{c['hist_gather_q']}, route {c['route']}, heap_walk (K6, "
              f"the gate) {k6} [{card}]", flush=True)
        check(r.promoted and k6 > 0, f"retrain gbdt {tag}: {r.to_json()}")
    r2, _m2, c2, _s2, _k6 = res["two"]
    rank_lines("(e) retrain gbdt --devices 2", r2.ranks)
    for rep in r2.ranks:
        ln = rep["launches"]
        print(f"dist_convex (e): rank {rep['rank']} launched hist_q (K2) "
              f"{ln['hist_q']}, hist_gather_q (K4) {ln['hist_gather_q']}, "
              f"route (K5) {ln['route']} [{card}]", flush=True)
        check(ln["hist_q"] > 0 and ln["route"] > 0 and ln["hist"] == 0,
              f"retrain rank {rep['rank']} did not run K2 and K5: {ln}")
    check(c2["hist_q"] == 0 and c2["route"] == 0,
          f"the two-rank retrain trained in this process: {c2}")
    eq = same_files(res["one"][1], res["two"][1])
    print(f"dist_convex (e): the two-rank candidate, promoted, "
          f"byte-identical to the one-device candidate: {eq} [{card}]",
          flush=True)
    check(eq, "retrain --devices 2: the candidate is not the one-device "
          "candidate")
    return {"retrain_ranks": [rep["launches"] for rep in r2.ranks],
            "retrain_gate_k6": res["two"][4]}


# -- slice 21: GBDT trees past the histogram kernels' shared node lookup -------

#: one l2 tree of DEEP_LEAVES leaves over DEEP_ROWS Higgs-shaped rows: a
#: node capacity of 2 x 30,000 - 1 = 59,999, past the 57,344 ids whose
#: lookup fits shared memory beside a tile of 256 bins (ROADMAP.md 1.8), so
#: K1-K4 take the global lookup kind. The target is the rows' planted
#: signal plus noise, a real number: a first sigmoid tree sees two
#: gradients only, its pure nodes stop splitting, and it stopped at 10,657
#: leaves at 2^17 rows
DEEP_ROWS = 1 << 17
DEEP_LEAVES = 30_000
DEEP_SEED = 20261018
#: the shared lookup kind's largest capacity at B = 256
SHARED_CAP_256 = 57_344
DEEP_SERVE_ROWS = 256
#: torch threads of each CPU reference process (two of them): they run
#: beside the card's phases, so they take a quarter of the cores each
REF_CPU_THREADS = 2


def deep_params(path, leaves=DEEP_LEAVES):
    """One l2 tree, loss-wise, no depth cap, any hessian past 1e-8: the
    tree grows until its leaf cap or its rows run out."""
    from ytklearn_tpu_torch.config.params import (
        ApproximateSpec,
        GBDTParams,
        ModelParams,
    )

    return GBDTParams(
        round_num=1, max_depth=0, max_leaf_cnt=leaves,
        tree_grow_policy="loss", learning_rate=0.1,
        min_child_hessian_sum=1e-8, loss_function="l2",
        eval_metric=["rmse"], approximate=[ApproximateSpec(max_cnt=255)],
        model=ModelParams(data_path=path, dump_freq=0))


def held_kernels(recorder, card, float_mode, what_of):
    """Each histogram call a run recorded (the first at each shape) held
    to its plain version: int8 exactly, bf16 at the float tolerance
    (hist_err). `what_of(name, rows, N, calls, B, M)` checks the call's
    shape and returns its description. Returns the largest error of each
    kernel."""
    from ytklearn_tpu_torch.gbdt import hist

    errs = {}
    for (name, rows, N), (calls, args, kw) in sorted(recorder.calls.items()):
        if name == "route":
            continue
        gather = "gather" in name
        B, M = args[6 if gather else 5], kw["max_nodes"]
        what = what_of(name, rows, N, calls, B, M)
        if name in ("hist_q", "hist"):
            bins, pos, g, h, ids = args[:5]
            got = (hist.hist_wave if float_mode else hist.hist_wave_q)(
                *args, **kw)
            want = (hist.hist_wave_plain(bins, pos, g, h, ids, B, M,
                                         kw["use_bf16"])
                    if float_mode else
                    hist.hist_wave_q_plain(bins, pos, g, h, ids, B, M))
        else:
            brows, idx, pg, gg, hg, ids = args[:6]
            got = hist.hist_wave_gather(*args, **kw)
            want = (hist.hist_gather_plain(brows, idx, pg, gg, hg, ids, B, M,
                                           kw["use_bf16"])
                    if float_mode else
                    hist.hist_gather_q_plain(brows, idx, pg, gg, hg, ids, B,
                                             M))
        err = (hist_err(got, want, what, name, card) if float_mode
               else q_err(got, want, what, name, card))
        errs[name] = max(errs.get(name, 0.0), err)
        del got, want
    recorder.calls.clear()
    return errs


def deep_kernels(recorder, M, card, float_mode):
    """The deep run's recorded calls (held_kernels), each on the global
    lookup kind at capacity M."""
    from ytklearn_tpu_torch.gbdt import hist

    def what_of(name, rows, N, calls, B, m):
        check(m == M and hist.lookup_kind(B, m, N) == "global",
              f"{name}: the deep run's call at N = {N} is not on the global "
              f"lookup kind ({m})")
        return f"in the deep run, N = {N}, {rows} rows ({calls} calls)"

    return held_kernels(recorder, card, float_mode, what_of)


def deep_lookup_timings(card):
    """K1-K4 at the deep run's widest wave on the same inputs in both
    lookup kinds: max_nodes SHARED_CAP_256 (the shared kind's largest) and
    2 x DEEP_LEAVES - 1 (the global kind; every id below the cap, so the
    sums are the same). Returns {kernel: (shared ms, global ms)}."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    M_g = 2 * DEEP_LEAVES - 1
    F, B, N = N_FEATURES, 256, 64
    gen = torch.Generator(device="cuda").manual_seed(DEEP_SEED)
    bins, pos, gq, hq, ids, M = rand_hist_inputs(gen, F, DEEP_ROWS, B, N,
                                                 "u8", SHARED_CAP_256)
    check(hist.lookup_kind(B, M, N) == "shared"
          and hist.lookup_kind(B, M_g, N) == "global",
          f"lookup kinds at {M} and {M_g}")
    g = torch.randn((DEEP_ROWS,), generator=gen, device="cuda")
    h = torch.rand((DEEP_ROWS,), generator=gen, device="cuda")
    R = 16384
    idx, pg, gqg, hqg = compacted(pos, gq, hq, ids, R, 0.1, gen)
    gg, hg = g[idx.long()].contiguous(), h[idx.long()].contiguous()
    rows = bins.t().contiguous()
    calls = {
        "hist_q": lambda m: hist.hist_wave_q(bins, pos, gq, hq, ids, B,
                                             max_nodes=m),
        "hist_gather_q": lambda m: hist.hist_wave_gather(
            rows, idx, pg, gqg, hqg, ids, B, max_nodes=m),
        "hist": lambda m: hist.hist_wave(bins, pos, g, h, ids, B,
                                         max_nodes=m),
        "hist_gather": lambda m: hist.hist_wave_gather(
            rows, idx, pg, gg, hg, ids, B, mode="mxu", max_nodes=m),
    }
    out = {}
    for name, fn in calls.items():
        a, b = fn(M), fn(M_g)
        if name in ("hist_q", "hist_gather_q"):
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"{name}: the two lookup kinds differ")
        else:
            hist_err(b, a, f"global kind against shared at N = {N}", name,
                     card)
        del a, b
        ms_s = cuda_ms(lambda: fn(M), iters=20)
        ms_g = cuda_ms(lambda: fn(M_g), iters=20)
        out[name] = (ms_s, ms_g)
        rows_of = R if "gather" in name else DEEP_ROWS
        print(f"timing deep: {name} N = {N}, {rows_of} rows, F = {F}, B = "
              f"{B}: shared lookup (max_nodes {M}) {ms_s:.6f} ms, global "
              f"lookup (max_nodes {M_g}) {ms_g:.6f} ms, global / shared "
              f"{ms_g / ms_s:.4f} [{card}]", flush=True)
    return out


def deep_data():
    """The deep tree's rows: gen_higgs_like's features and an l2 target,
    the planted signal plus noise, as numpy (the card and CPU runs take
    the same arrays)."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.gbdt.data import GBDTData
    from ytklearn_tpu_torch.scripts.bench_gbdt import gen_higgs_like

    train, _ = gen_higgs_like(DEEP_ROWS, 1, N_FEATURES, DEEP_SEED)
    X = train.X
    gen = torch.Generator(device="cuda").manual_seed(DEEP_SEED)
    y = (1.5 * X[:, 0] * X[:, 1] + torch.sin(X[:, 2] * 2)
         + 0.8 * (X[:, 3] > 0.5) - 0.5 * X[:, 4] ** 2 + 0.3 * X[:, 5]
         * X[:, 6] + 0.5 * torch.randn((DEEP_ROWS,), generator=gen,
                                       device="cuda"))
    return GBDTData(X=X.cpu().numpy(), y=y.cpu().numpy(),
                    weight=np.ones(DEEP_ROWS, np.float32), n_real=DEEP_ROWS,
                    feature_names=train.feature_names)


def deep_tree_run(prec, dev, data, path):
    """One deep tree: (train loss, seconds, nodes, leaves, depth); the dump
    at `path`. The CPU runs go through this in processes of their own,
    REF_CPU_THREADS threads each, beside the card's phases."""
    import torch

    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    if dev == "cpu":
        torch.set_num_threads(REF_CPU_THREADS)
    t0 = time.perf_counter()
    r = GBDTTrainer(deep_params(path), hist_precision=prec,
                    device=dev).train(train=data)
    tree = r.model.trees[0]
    return (r.train_loss, time.perf_counter() - t0, tree.n_nodes(),
            tree.leaf_cnt(), tree.max_depth())


def start_cpu_references(card):
    """The CPU references of phase_deep_tree (the int8 and bf16 deep trees)
    and of phase_wide_bins (WIDE_RUNS), started after phase_serving in two
    spawned processes of REF_CPU_THREADS threads, so they grow beside the
    card's phases up to the deep phase (not beside phase_profile's
    capture or the serving bench) -> the pool, its temp dir, the two
    phases' data and futures; each prints when it is done."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_refs_")
    pool = ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    deep, wide = deep_data(), wide_data()
    refs = {"pool": pool, "tmp": tmp, "t0": t0, "deep_data": deep,
            "wide_data": wide}
    refs["deep_cpu"] = {prec: pool.submit(deep_tree_run, prec, "cpu", deep,
                                          os.path.join(tmp, f"{prec}_cpu"))
                        for prec in ("int8", "bf16")}
    refs["wide_cpu"] = {run: pool.submit(
        wide_run, *run, "cpu", wide,
        os.path.join(tmp, f"wide_{run[0]}_{run[1]}_cpu"))
        for run in WIDE_RUNS}
    for what, fut in [(f"deep {p}", f) for p, f in refs["deep_cpu"].items()] \
            + [(f"wide {r[0]} {r[1]}", f) for r, f in refs["wide_cpu"].items()]:
        # to the process's own stdout: a phase may be capturing sys.stdout
        fut.add_done_callback(lambda f, what=what: print(
            f"cpu references: {what} done {time.perf_counter() - t0:.3f} s "
            f"after they started [{card}]", file=sys.__stdout__, flush=True))
    return refs


def phase_deep_tree(card, refs):
    """ROADMAP 1.8 on the card: one l2 tree of up to DEEP_LEAVES leaves
    over DEEP_ROWS Higgs-shaped rows, past the shared node lookup's
    capacity, in int8 and in bf16, on the card and (the reference, in two
    processes beside the card's runs) on the CPU. int8: the dumps byte for
    byte equal, and every K2/K4 call of the card run (the first at each
    shape) exactly its plain version's. bf16: every K1/K3 call of the card
    run within the float tolerance of its plain version (hist_err), and
    the train loss within OBJ_RTOL of the CPU run's. K1-K4 launches of
    each card run; the four kernels timed in both lookup kinds; the int8
    model served once by `cli serve` with YTK_SERVE_FUSED=1: the fused
    rung refuses its depth, so it serves on the stacked rung, every score
    bit-equal to the host tree walk. Between the card's runs and the CPU
    results, phase_wide_bins (slice 22); finish_wide_bins after. The CPU
    references grow from phase_serving's end on (start_cpu_references,
    `refs`). Returns
    ({kernel: launches}, {kernel: (shared ms, global ms)}, {kernel:
    largest error}, phase_wide_bins' record)."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.gbdt import hist
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel
    from ytklearn_tpu_torch.predict import create_predictor

    timings = deep_lookup_timings(card)
    data = refs["deep_data"]
    M = 2 * DEEP_LEAVES - 1
    tmp = refs["tmp"]
    launches, errs, res = {}, {}, {}
    pool, cpu = refs["pool"], refs["deep_cpu"]
    try:
        for prec in ("int8", "bf16"):
            rec = ShapeRecorder("int8" if prec == "int8" else "float")
            zero_kernel_counts()
            with rec:
                res[prec, "cuda"] = deep_tree_run(
                    prec, "cuda", data, os.path.join(tmp, f"{prec}_cuda"))
            c = kernel_counts()
            launches.update({k: c[k] for k in PRECISION_KERNELS[prec]})
            check(all(c[k] > 0 for k in PRECISION_KERNELS[prec]),
                  f"deep {prec}: a histogram kernel never launched {c}")
            print(f"deep {prec}: launches K1 {c['hist']}, K3 "
                  f"{c['hist_gather']}, K2 {c['hist_q']}, K4 "
                  f"{c['hist_gather_q']}, K5 {c['route']} [{card}]",
                  flush=True)
            errs.update(deep_kernels(rec, M, card, prec == "bf16"))
            torch.cuda.empty_cache()
        # slice 22, while the CPU trees grow: features past one tile of
        # bins on the card (their CPU runs queue behind the deep trees)
        wide = phase_wide_bins(card, refs)
        torch.cuda.empty_cache()
        # while the CPU trees grow: the int8 model through `cli serve`,
        # fused asked for and refused (depth past the heap kernels' cap),
        # so stacked serves it
        model_path = os.path.join(tmp, "int8_cuda")
        with open(model_path) as f:
            model = GBDTModel.loads(f.read())
        conf = os.path.join(tmp, "deep.conf")
        with open(conf, "w") as f:
            f.write(f'model {{ data_path = "{model_path}" }}\n'
                    "optimization { loss_function = l2, round_num = 1 }\n")
        names = [f"f{i}" for i in range(N_FEATURES)]
        rows = random_rows(np.random.RandomState(DEEP_SEED), DEEP_SERVE_ROWS,
                           names, split_values(model))
        env = dict(os.environ, PYTHONPATH=REPO, YTK_SERVE_FUSED="1")
        env.pop("YTK_SERVE_BINNED", None)
        err_path = os.path.join(tmp, "serve.log")
        proc, banner = start_cli_serve(
            [conf, "gbdt", "--host", "127.0.0.1", "--port", "0",
             "--device", "cuda"], env, err_path)
        try:
            got = np.asarray(post(banner["port"], {"rows": rows})["scores"])
        finally:
            rc, _log, _warm = stop_cli_serve(proc, err_path)
        want = create_predictor("gbdt", conf).batch_scores(rows)
        ok = np.array_equal(got, want)
        print(f"deep serve: cli serve of the {model.trees[0].n_nodes()}-node "
              f"tree (depth {model.trees[0].max_depth()}), rung "
              f"{json.dumps(banner['rung'])}; {len(rows)} rows bit-equal to "
              f"the host tree walk {ok}; SIGTERM exit {rc} [{card}]",
              flush=True)
        check(banner["rung"]["mode"] == "stacked" and ok and rc == 0,
              f"deep serve: rung {banner['rung']}, scores {ok}, exit {rc}")

        t_wait = time.perf_counter()
        for prec in ("int8", "bf16"):
            res[prec, "cpu"] = cpu[prec].result()
        print(f"deep: waited {time.perf_counter() - t_wait:.3f} s for the "
              f"CPU trees, {time.perf_counter() - refs['t0']:.3f} s after "
              f"they started [{card}]", flush=True)
        for (prec, dev), (loss, secs, nodes, leaves, depth) in sorted(
                res.items()):
            print(f"deep {prec} on {dev}: {DEEP_ROWS} rows, one tree of "
                  f"{nodes} nodes ({leaves} leaves, depth {depth}), "
                  f"capacity {M} (lookup {hist.lookup_kind(256, M)}), "
                  f"{secs:.3f} s (wall; the CPU's with {REF_CPU_THREADS} "
                  f"threads beside the card's phases), train loss "
                  f"{loss:.9f} [{card}]", flush=True)
            check(nodes > SHARED_CAP_256, f"deep {prec} on {dev}: {nodes} "
                  f"nodes, not past {SHARED_CAP_256}")
        texts = {}
        for dev in ("cuda", "cpu"):
            with open(os.path.join(tmp, f"int8_{dev}"), "rb") as f:
                texts[dev] = f.read()
        same = texts["cuda"] == texts["cpu"]
        print(f"deep int8: the card's dump equals the CPU's byte for byte "
              f"{same} ({len(texts['cuda'])} bytes) [{card}]", flush=True)
        check(same, "deep int8: the card and CPU dumps differ")
        a, b = res["bf16", "cuda"][0], res["bf16", "cpu"][0]
        loss_rel = abs(a - b) / abs(b)
        print(f"deep bf16: relative train-loss difference card/CPU "
              f"{loss_rel:.3e} (at most {OBJ_RTOL}) [{card}]", flush=True)
        check(loss_rel <= OBJ_RTOL, "deep bf16: card and CPU losses differ")
        finish_wide_bins(wide, tmp, card)
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, timings, errs, wide


WIDE_ROWS = 1 << 19
WIDE_F = 8
WIDE_LEAVES = 31
WIDE_ROUNDS = 3
#: waves of 8 slots after the slow start, fused budgets of n/2 and n/8
#: rows: these shallow trees then grow most waves through K3/K4 too
WIDE_WAVE = 8
WIDE_LADDER = "2,8"
WIDE_SEED = 20261019
#: (precision, max_cnt) of the wide runs: B = 2^15 and 2^16 in int8,
#: 2^15 in bf16
WIDE_RUNS = (("int8", 30000), ("int8", 60000), ("bf16", 30000))
#: the kind matrix: both widths, three waves, K1/K2 over WIDE_ROWS rows,
#: K3/K4 over WIDE_GATHER_ROWS gathered ones
WIDE_BINS = (1 << 15, 1 << 16)
WIDE_WAVES = (1, 16, 64)
WIDE_GATHER_ROWS = 1 << 15
#: the wave whose planner's plan the kernels line reports
WIDE_REPORT_N = 16


def wide_data():
    """gen_higgs_like's rows at WIDE_F continuous features and its 0/1
    labels, as numpy (the card and the CPU take the same arrays)."""
    import numpy as np

    from ytklearn_tpu_torch.gbdt.data import GBDTData
    from ytklearn_tpu_torch.scripts.bench_gbdt import gen_higgs_like

    train, _ = gen_higgs_like(WIDE_ROWS, 1, WIDE_F, WIDE_SEED)
    return GBDTData(X=train.X.cpu().numpy(), y=train.y.cpu().numpy(),
                    weight=np.ones(WIDE_ROWS, np.float32),
                    n_real=WIDE_ROWS, feature_names=train.feature_names)


def wide_params(path, max_cnt):
    from ytklearn_tpu_torch.config.params import (
        ApproximateSpec,
        GBDTParams,
        ModelParams,
    )

    return GBDTParams(
        round_num=WIDE_ROUNDS, max_depth=0, max_leaf_cnt=WIDE_LEAVES,
        tree_grow_policy="loss", learning_rate=0.1,
        min_child_hessian_sum=1.0, loss_function="sigmoid",
        eval_metric=["auc"], approximate=[ApproximateSpec(max_cnt=max_cnt)],
        model=ModelParams(data_path=path, dump_freq=0))


def wide_run(prec, max_cnt, dev, data, path):
    """One wide-bin training (YTK_LADDER = WIDE_LADDER while it runs):
    (train loss, seconds, padded bins B, trees); the dump at `path`. The
    CPU runs go through this in the deep phase's processes."""
    import torch

    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    if dev == "cpu":
        torch.set_num_threads(REF_CPU_THREADS)
    saved = os.environ.get("YTK_LADDER")
    os.environ["YTK_LADDER"] = WIDE_LADDER
    try:
        t0 = time.perf_counter()
        tr = GBDTTrainer(wide_params(path, max_cnt), hist_precision=prec,
                         device=dev, wave=WIDE_WAVE)
        r = tr.train(train=data)
        secs = time.perf_counter() - t0
    finally:
        os.environ.pop("YTK_LADDER", None)
        if saved is not None:
            os.environ["YTK_LADDER"] = saved
    return r.train_loss, secs, tr.grow_spec.B, len(r.model.trees)


def wide_kernels(recorder, card, float_mode):
    """A wide run's recorded calls (held_kernels), each past one tile of
    bins, with the plan its planner takes."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    sm = torch.cuda.get_device_properties(0).multi_processor_count

    def what_of(name, rows, N, calls, B, M):
        check(B >= 1 << 15 and hist.bin_ranges(B) > 1,
              f"{name}: a wide call at B = {B}, not past one tile")
        plan = (hist.float_plan if float_mode else hist.q_plan)(
            N, WIDE_F, B, M, rows, sm, "gather" in name)
        return (f"in a wide run, B = {B}, N = {N}, {rows} rows ({calls} "
                f"calls), plan {plan_text(plan)}, {plan['nb']} bin ranges")

    return held_kernels(recorder, card, float_mode, what_of)


def wide_plans(name, n, sm):
    """The planner's plan (None) and every kind its checker takes for
    kernel `name` at this shape: K1 tile / auto / red, K2 tile / auto /
    red, K3 red, K4 tile / auto / red; a tile of one slot x one feature x
    one of the planner's bin ranges."""
    from ytklearn_tpu_torch.gbdt import hist

    red = {"kind": "red", "n_chunks": 2 * sm, "threads": hist.THREADS}
    if name == "hist_gather":
        return [None]
    tile = {"fg": 1, "ng": 1, "threads": 2 * hist.THREADS}
    if name == "hist_gather_q":
        tile["n_chunks"] = min(hist.Q_STORE_CHUNKS, max(1, n // 4096))
    else:
        tile["rows_per_chunk"] = 1 << 16
    return [None, dict(tile, kind="tile"), dict(tile, kind="auto"), red]


def wide_kind_matrix(card):
    """K1-K4 at B = 2^15 and 2^16 and waves of WIDE_WAVES slots in every
    kind their checkers take, each call held to its plain version (int8
    exact, f32 at the float tolerance), then timed (CUDA events) beside
    one scatter_add_ of the same sums and the call's byte bound, with the
    plan printed. Returns ({name: {B: report}}, {name: largest error})."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(WIDE_SEED)
    F, n, R = WIDE_F, WIDE_ROWS, WIDE_GATHER_ROWS
    report, errs = {}, {}
    for B in WIDE_BINS:
        for N in WIDE_WAVES:
            bins, pos, gq, hq, ids, M = rand_hist_inputs(gen, F, n, B, N,
                                                         "i32")
            g = torch.randn((n,), generator=gen, device="cuda") * 3
            h = torch.rand((n,), generator=gen, device="cuda")
            idx, pg, gqg, hqg = compacted(pos, gq, hq, ids, R, 0.05, gen)
            gg, hg = g[idx.long()].contiguous(), h[idx.long()].contiguous()
            rows = bins.t().contiguous()
            cases = {
                "hist": (lambda p: hist.hist_wave(
                    bins, pos, g, h, ids, B, max_nodes=M, use_bf16=False,
                    plan=p),
                    lambda: hist.hist_wave_plain(bins, pos, g, h, ids, B, M,
                                                 False),
                    lambda: flat_keys(lambda f, r: bins[f, r], F, B, pos, g,
                                      h, ids, M, bf16=False),
                    lambda: hist_bound_ms(bins, False, None, pos, ids, M,
                                          B), n, False),
                "hist_q": (lambda p: hist.hist_wave_q(
                    bins, pos, gq, hq, ids, B, max_nodes=M, plan=p),
                    lambda: hist.hist_wave_q_plain(bins, pos, gq, hq, ids, B,
                                                   M),
                    lambda: flat_keys(lambda f, r: bins[f, r], F, B, pos, gq,
                                      hq, ids, M),
                    lambda: hist_bound_ms(bins, False, None, pos, ids, M,
                                          B), n, False),
                "hist_gather": (lambda p: hist.hist_wave_gather(
                    rows, idx, pg, gg, hg, ids, B, mode="mxu", max_nodes=M,
                    use_bf16=False, plan=p),
                    lambda: hist.hist_gather_plain(rows, idx, pg, gg, hg, ids,
                                                   B, M, False),
                    lambda: flat_keys(lambda f, r: rows[idx[r].long(), f], F,
                                      B, pg, gg, hg, ids, M, bf16=False),
                    lambda: hist_bound_ms(rows, True, idx, pg, ids, M, B), R,
                    True),
                "hist_gather_q": (lambda p: hist.hist_wave_gather(
                    rows, idx, pg, gqg, hqg, ids, B, max_nodes=M, plan=p),
                    lambda: hist.hist_gather_q_plain(rows, idx, pg, gqg, hqg,
                                                     ids, B, M),
                    lambda: flat_keys(lambda f, r: rows[idx[r].long(), f], F,
                                      B, pg, gqg, hqg, ids, M),
                    lambda: hist_bound_ms(rows, True, idx, pg, ids, M, B), R,
                    True),
            }
            for name, (fn, plain, keys_of, bound, rows_of, gather) in \
                    cases.items():
                float_mode = name in ("hist", "hist_gather")
                want = plain()
                keys, vals = keys_of()
                flat = torch.zeros(N * F * B * 3, dtype=vals.dtype,
                                   device="cuda")
                lib_ms = cuda_ms(lambda: flat.zero_().scatter_add_(
                    0, keys, vals), iters=2, repeats=3)
                del keys, vals, flat
                b_ms, b_by = bound()
                for p in wide_plans(name, rows_of, sm):
                    plan = (hist.check_float_plan(p, N, F, B, M, rows_of,
                                                  gather)
                            if float_mode and p is not None else
                            hist.check_q_plan(p, N, F, B, M, rows_of)
                            if p is not None else
                            (hist.float_plan if float_mode else hist.q_plan)(
                                N, F, B, M, rows_of, sm, gather))
                    what = (f"at B = {B}, N = {N}, {rows_of} rows, "
                            f"{'the planner' if p is None else 'explicit'} "
                            f"{plan_text(plan)}, {plan['nb']} bin ranges")
                    got = fn(p)
                    err = (hist_err(got, want, what, name, card)
                           if float_mode else q_err(got, want, what, name,
                                                    card))
                    errs[name] = max(errs.get(name, 0.0), err)
                    del got
                    ms = cuda_ms(lambda: fn(p), iters=3, repeats=3)
                    print(f"wide: {name} B = {B} N = {N} {ms:.6f} ms, one "
                          f"scatter_add_ {lib_ms:.6f} ms, bound {b_ms:.6f} "
                          f"ms ({b_by}), {what} [{card}]", flush=True)
                    if p is None and N == WIDE_REPORT_N:
                        report.setdefault(name, {})[str(B)] = {
                            "N": N, "ms": ms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": lib_ms,
                            "plan": plan_text(plan), "nb": plan["nb"]}
                del want
            del bins, pos, gq, hq, g, h, idx, pg, gqg, hqg, gg, hg, rows
            torch.cuda.empty_cache()
    return report, errs


def phase_wide_bins(card, refs):
    """ROADMAP 1.8b on the card: GBDT over features of more bins than one
    shared-memory tile holds (K1, K2 and K4 tiles of bin ranges). Three
    trainings of WIDE_ROUNDS trees over WIDE_ROWS Higgs-shaped rows of
    WIDE_F continuous features: int8 at max_cnt 30,000 (B = 2^15) and
    60,000 (2^16), bf16 at 2^15, on the card here and on the CPU in the
    references' pool (start_cpu_references: they run once the deep CPU
    trees are done). Every recorded K1-K4 call held to its plain version
    (K2/K4 exact, K1/K3 at HIST_RTOL); each of K1-K4 launched; then the
    kind matrix (wide_kind_matrix). Returns what finish_wide_bins needs."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    data, cpu, tmp = refs["wide_data"], refs["wide_cpu"], refs["tmp"]
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, launches, errs = {}, {}, {}
    for prec, cnt in WIDE_RUNS:
        rec = ShapeRecorder("int8" if prec == "int8" else "float")
        zero_kernel_counts()
        with rec:
            res[prec, cnt] = wide_run(prec, cnt, "cuda", data, os.path.join(
                tmp, f"wide_{prec}_{cnt}_cuda"))
        c = kernel_counts()
        loss, secs, B, trees = res[prec, cnt]
        for k in PRECISION_KERNELS[prec]:
            launches[k] = launches.get(k, 0) + c[k]
        print(f"wide {prec} max_cnt {cnt}: B = {B} ({B // 1024}K bins, "
              f"tiles of {hist.bin_ranges(B)} bin ranges), {trees} trees of {WIDE_LEAVES} leaves over "
              f"{WIDE_ROWS} rows x {WIDE_F} features on the card in "
              f"{secs:.3f} s, train loss {loss:.9f}; launches K1 "
              f"{c['hist']}, K3 {c['hist_gather']}, K2 {c['hist_q']}, K4 "
              f"{c['hist_gather_q']}, K5 {c['route']} [{card}]", flush=True)
        check(B >= 1 << 15 and trees == WIDE_ROUNDS,
              f"wide {prec} {cnt}: B = {B}, {trees} trees")
        check(all(c[k] > 0 for k in PRECISION_KERNELS[prec]),
              f"wide {prec} {cnt}: a histogram kernel never launched {c}")
        for k, v in wide_kernels(rec, card, prec != "int8").items():
            errs[k] = max(errs.get(k, 0.0), v)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"wide: the three card runs in {time.perf_counter() - t0:.3f} s, "
          f"peak device memory {peak:.3f} GiB; launches {launches} "
          f"[{card}]", flush=True)
    check(all(launches.get(k, 0) > 0 for k in
              ("hist", "hist_gather", "hist_q", "hist_gather_q")),
          f"wide: K1-K4 did not all launch at B >= 2^15: {launches}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    report, merrs = wide_kind_matrix(card)
    for k, v in merrs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    print(f"wide: kind matrix in {time.perf_counter() - t0:.3f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} "
          f"GiB [{card}]", flush=True)
    return {"cpu": cpu, "res": res, "launches": launches, "errs": errs,
            "report": report}


def finish_wide_bins(wide, tmp, card):
    """The wide runs' CPU side, once the pool has grown them: every int8
    dump of the card byte for byte the CPU's, the bf16 train loss within
    OBJ_RTOL of the CPU's."""
    for run, fut in wide["cpu"].items():
        loss, secs, B, trees = fut.result()
        prec, cnt = run
        print(f"wide {prec} max_cnt {cnt} on the CPU: B = {B}, {trees} "
              f"trees in {secs:.3f} s (in the references' pool), train loss "
              f"{loss:.9f} [{card}]", flush=True)
        if prec == "int8":
            texts = {}
            for dev in ("cuda", "cpu"):
                with open(os.path.join(tmp, f"wide_{prec}_{cnt}_{dev}"),
                          "rb") as f:
                    texts[dev] = f.read()
            same = texts["cuda"] == texts["cpu"]
            print(f"wide int8 B = {B}: the card's dump equals the CPU's byte "
                  f"for byte {same} ({len(texts['cuda'])} bytes) [{card}]",
                  flush=True)
            check(same, f"wide int8 B = {B}: the card and CPU dumps differ")
        else:
            a = wide["res"][run][0]
            rel = abs(a - loss) / abs(loss)
            print(f"wide bf16 B = {B}: relative train-loss difference "
                  f"card/CPU {rel:.3e} (at most {OBJ_RTOL}) [{card}]",
                  flush=True)
            check(rel <= OBJ_RTOL, f"wide bf16: card and CPU losses differ")


ENGINE_SCRIPT_ROWS = 1 << 18
ENGINE_SCRIPT_TIMEOUT_S = 240


def engine_script_runs(tmp):
    """(script, argv, extra env) of the engine's scripts: each at
    ENGINE_SCRIPT_ROWS rows and two or three trees, ablate's b256 and goss
    arms."""
    n = str(ENGINE_SCRIPT_ROWS)
    return (
        ("profile_gbdt", [n, "2", "loss"], {}),
        ("profile_engine", [n, "2", "16", "loss", "255", "int8"], {}),
        ("micro_engine", [n], {}),
        ("ablate_engine", [n, "b256", "goss"],
         {"ABLATE_TREES": "3",
          "ABLATE_RECORD": os.path.join(tmp, "ablate.json")}),
    )


def phase_engine_scripts(card):
    """The engine's profile, micro and ablation scripts (slice 22's ports
    of scripts/{profile_gbdt,profile_engine,micro_engine,ablate_engine}.py)
    on the card, the four at once, each in a process of its own: exit 0,
    the trees/s (or ms) lines, the profiler's report, the ablation record
    with its arms and wave table, and each script's own count of kernel
    launches: K1 or K2, and K5."""
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_scripts_")
    try:
        env0 = {k: v for k, v in os.environ.items()
                if not k.startswith(("ABLATE_", "YTK_"))}
        env0["PYTHONPATH"] = REPO
        procs = {}
        t0 = time.perf_counter()
        for script, argv, extra in engine_script_runs(tmp):
            out = open(os.path.join(tmp, f"{script}.out"), "w")
            err = open(os.path.join(tmp, f"{script}.err"), "w")
            procs[script] = (subprocess.Popen(
                [sys.executable, "-m", f"ytklearn_tpu_torch.scripts.{script}",
                 *argv], cwd=REPO, env=dict(env0, **extra), stdout=out,
                stderr=err), out, err)
        rcs = {}
        for script, (p, out, err) in procs.items():
            try:
                rcs[script] = p.wait(timeout=ENGINE_SCRIPT_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                rcs[script] = p.wait()
            out.close()
            err.close()
        wall = time.perf_counter() - t0
        for script, argv, _extra in engine_script_runs(tmp):
            with open(os.path.join(tmp, f"{script}.out")) as f:
                text = f.read()
            with open(os.path.join(tmp, f"{script}.err")) as f:
                etext = f.read()
            rc = rcs[script]
            if rc != 0:
                print(f"engine scripts: {script} stderr tail:\n"
                      f"{etext[-3000:]}", flush=True)
            lines = text.splitlines()
            counts = json.loads(next(
                ln for ln in lines if ln.startswith("kernel launches: "))
                [len("kernel launches: "):].rsplit(" [", 1)[0]) \
                if rc == 0 else {}
            if script.startswith("profile"):
                head = next((ln for ln in lines if ln.startswith("policy=")),
                            "")
                try:
                    tps = float(head.split("trees/s=")[1].split()[0])
                except (IndexError, ValueError):  # no line, or no time
                    tps = 0.0
                ok = (rc == 0 and tps > 0 and "profile.run" in text
                      and "coverage" in text and "gbdt.train" in text)
                print(f"engine scripts: {script} {' '.join(argv)}: rc {rc}; "
                      f"{head}; profiler report {'profile.run' in text}; "
                      f"launches {counts} [{card}]", flush=True)
            elif script == "micro_engine":
                timings = [ln for ln in lines if ln.endswith(f"ms [{card}]")]
                ok = rc == 0 and len(timings) == 4
                for ln in timings:
                    print(f"engine scripts: micro_engine {ln}", flush=True)
                print(f"engine scripts: micro_engine {argv[0]}: rc {rc}; "
                      f"launches {counts} [{card}]", flush=True)
            else:
                rec_path = os.path.join(tmp, "ablate.json")
                record = {}
                if os.path.exists(rec_path):
                    with open(rec_path) as f:
                        record = json.load(f)
                cfgs = record.get("configs", {})
                ok = (rc == 0 and sorted(cfgs) == ["b256", "goss"]
                      and all((e["steady_trees_per_sec"] or 0.0) > 0
                              and e["wave_columns"][0] == "rows_scanned"
                              and e["last_tree_waves"]
                              for e in cfgs.values()))
                for cfg, e in cfgs.items():
                    print(f"engine scripts: ablate_engine {cfg}: steady "
                          f"{e['steady_trees_per_sec']} trees/s, AUC "
                          f"{e['auc']:.6f}, scan/need {e['scan_over_need']}, "
                          f"{len(e['last_tree_waves'])} waves in the last "
                          f"tree's table [{card}]", flush=True)
                print(f"engine scripts: ablate_engine {' '.join(argv)}: rc "
                      f"{rc}; launches {counts} [{card}]", flush=True)
            kernels_ok = ((counts.get("K1", 0) > 0 or counts.get("K2", 0) > 0)
                          and counts.get("K5", 0) > 0)
            check(ok and kernels_ok, f"engine scripts: {script} rc {rc}, "
                  f"launches {counts}: {text[-2000:]}")
        print(f"engine scripts: the four in {wall:.3f} s (wall, at once) "
              f"[{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- slice 23: the serving bench and the drills ------------------------------

#: each arm's window (the scripts' --seconds; every floor keeps its default)
SB_SECONDS = 1.0
SB_MIXED_SECONDS = 6.0
SB_REPLICAS = 2  # --rungs-fleet and --fleet
SB_RAMP_REPLICAS = 3  # SCALE_MIN_PEAK's default 3 needs a ceiling of 3
SB_RAMP_TIMEOUT_S = 90.0  # --ramp-grow-timeout and --ramp-shrink-timeout
SB_TIMEOUT_S = 420
TRACE_SECONDS = 3.0
#: the drills' one speed floor each, as its failure message begins
DRILL_FLOOR = {"trace_drill": "sampled tracing",
               "drift_drill": "quality-sampler overhead",
               "mesh_drill": "?models=1 scrape cost"}


def start_script(name, args, d):
    """`python -m ytklearn_tpu_torch.scripts.<name> <args> --record
    <d>/<name>.json` with every floor and window knob at its default (the
    script's own environment keeps no YTK_, SERVE_, BENCH_, SCALE_ or MESH_
    variable of this process) -> (process, record path, stderr file, t0)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ("YTK_", "SERVE_", "BENCH_", "SCALE_", "MESH_"))}
    env["PYTHONPATH"] = REPO
    rec = os.path.join(d, f"{name}.json")
    ef = open(os.path.join(d, f"{name}.err"), "w+")
    # a session of its own: kill_script stops its replicas with it
    p = subprocess.Popen(
        [sys.executable, "-m", f"ytklearn_tpu_torch.scripts.{name}",
         "--record", rec] + list(args), cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=ef, start_new_session=True)
    return p, rec, ef, time.perf_counter()


def kill_script(started):
    """Kill every process left in a start_script process's session (its
    fleet's replicas too, should it have died without stopping them)."""
    p = started[0]
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    p.wait()


def finish_script(started, what, card):
    """Wait for start_script's process -> (rc, the record, seconds). The
    exit code may be 1 for a missed speed floor only: the caller holds
    every correctness field itself."""
    p, rec, ef, t0 = started
    try:
        p.wait(timeout=SB_TIMEOUT_S)
    finally:
        kill_script(started)
    wall = time.perf_counter() - t0
    ef.seek(0)
    err = ef.read()
    ef.close()
    check(p.returncode in (0, 1) and os.path.exists(rec),
          f"{what} exited {p.returncode}: {err[-3000:]}")
    with open(rec) as f:
        out = json.load(f)
    fails = [ln.split("FAIL: ", 1)[1] for ln in err.splitlines()
             if "FAIL: " in ln]
    print(f"serving {what}: exit {p.returncode} in {wall:.3f} s (wall), "
          f"device {out['device']}, record card {out['card']!r}; failures "
          f"printed {fails} [{card}]", flush=True)
    return p.returncode, out, wall


def floors_line(what, rec, rc, card):
    """Each speed floor beside its value and the card; a run that exited 1
    must have missed one."""
    missed = [f["name"] for f in rec["floors"] if not f["met"]]
    for f in rec["floors"]:
        print(f"serving {what} floor {f['name']}: value {f['value']}, limit "
              f"{f['limit']}, met {f['met']} [{card}]", flush=True)
    check(rc == 0 or missed, f"{what} exited {rc} with every floor met")


def check_rungs(rec, rc, card):
    """serve_bench's rung matrix at the card's width: K6 and K7 launched by
    the fused and binned rungs, every rung bit-identical to the host walk,
    none downgraded, no build after warmup; the bands and the transform
    path; the binned fleet."""
    check(rec["trees"] == N_TREES and rec["data_source"] == "synthetic",
          f"serve_bench model: {rec['trees']} trees, {rec['data_source']}")
    print(f"serving rungs: score() loop {rec['baseline_req_per_sec']} req/s;"
          f" default rung x{rec['speedup_vs_score_loop']} [{card}]",
          flush=True)
    backends = {"default": "stacked-torch", "fused": "fused-cuda",
                "binned": "binned-cuda"}
    for r in rec["rungs"]:
        print(f"serving rung {r['rung']}: {r['backend']}, {r['req_per_sec']} "
              f"req/s, p50 {r['p50_ms']} ms, p99 {r['p99_ms']} ms, "
              f"{r['requests']} requests, x{r['speedup_vs_default']} the "
              f"default rung, bit-identical {r['bit_identical']}, "
              f"downgraded {r['downgraded']}, builds after warmup "
              f"{r['retraces_after_warmup']} [{card}]", flush=True)
        check(r["backend"] == backends[r["rung"]] and not r["downgraded"]
              and r["bit_identical"] and r["retraces_after_warmup"] == 0,
              f"serve_bench rung {r['rung']}: {r}")
    kl = rec["kernel_launches"]
    print(f"serving rungs: the process launched K6 {kl['heap_walk']} and K7 "
          f"{kl['binned_walk']} times [{card}]", flush=True)
    check(kl["heap_walk"] > 0 and kl["binned_walk"] > 0,
          f"serve_bench's rungs launched no K6 or K7: {kl}")
    q, bands = rec["binned_quality"], rec["precision_bands"]
    print(f"serving bands: binned max |pred diff| {q['max_abs_pred_diff']} "
          f"(band 1e-9), boundary rows diverged "
          f"{q['boundary_diverged_fraction']}; bf16 {bands} (band 0.1) "
          f"[{card}]", flush=True)
    check(q["max_abs_pred_diff"] <= 1e-9
          and all(b <= 0.1 for b in bands.values()),
          f"serve_bench bands: {q}, {bands}")
    tr = rec["transform_overhead"]
    for arm in ("tracing_overhead", "quality_overhead"):
        o = rec[arm]
        print(f"serving {arm}: off {o['off_req_per_sec']}, sampled "
              f"{o['sampled_req_per_sec']}, always {o['always_req_per_sec']}"
              f" req/s [{card}]", flush=True)
    print(f"serving transform: raw {tr['raw_req_per_sec']}, assembled "
          f"{tr['assembled_req_per_sec']} req/s, "
          f"{tr.get('transform_us_per_row')} us a row, bit-identical "
          f"{tr['assembled_bit_identical']}, builds {tr['raw_retraces']} "
          f"[{card}]", flush=True)
    check(tr["assembled_bit_identical"] and tr["raw_retraces"] == 0,
          f"serve_bench transform arm: {tr}")
    fl = rec["fleet"]
    http = fl["front_http"]
    print(f"serving rungs-fleet: {fl['replicas']} binned replicas, "
          f"{fl['req_per_sec']} req/s, p50 {fl['p50_ms']} ms, p99 "
          f"{fl['p99_ms']} ms, rungs {fl['rung_by_replica']}; front ingress "
          f"raw splice {http['raw_splice']['rows_per_sec']} rows/s, general "
          f"parse {http['general_parse']['rows_per_sec']} rows/s "
          f"({http['parse_overhead_us_per_row']} us a row) [{card}]",
          flush=True)
    check(fl["retraces_fleet"] == 0 and fl["batches_fleet"] > 0
          and len(fl["rung_by_replica"]) == SB_REPLICAS
          and all(r["backend"] == "binned-cuda" and not r["downgraded"]
                  for r in fl["rung_by_replica"].values())
          and http["raw_splice"]["errors"] == 0
          and http["general_parse"]["errors"] == 0
          and http["raw_splice_requests"] > 0,
          f"serve_bench rungs-fleet: {fl}")
    floors_line("rungs", rec, rc, card)


def check_fleet(rec, rc, card):
    base, mixed, hot = rec["baseline"], rec["mixed_traffic"], rec["hot_cache"]
    check(base["measured"] == "this run" and base["req_per_sec"] > 0,
          f"--fleet baseline: {base}")
    for s in rec["scaling"]:
        print(f"serving fleet: {s['replicas']} replica(s), {s['req_per_sec']}"
              f" req/s, p50 {s['p50_ms']} ms, p99 {s['p99_ms']} ms, builds "
              f"{s['retraces']} [{card}]", flush=True)
        check(s["retraces"] == 0, f"--fleet scaling: {s}")
    print(f"serving fleet: x{rec['speedup_vs_single']} the single-process "
          f"default rung of this run ({base['req_per_sec']} req/s); hot cache"
          f" {hot['req_per_sec']} req/s, hit rate {hot['hit_rate']}; mixed "
          f"{mixed['requests']} requests, {mixed['shed_429']} shed, "
          f"{mixed['failures']} failed, versions {mixed['versions_seen']} "
          f"[{card}]", flush=True)
    check(hot["retraces"] == 0 and mixed["failures"] == 0
          and mixed["shed_429"] > 0 and mixed["versions_seen"] == [1, 2]
          and mixed["retraces_fleet"] == 0, f"--fleet mixed: {mixed}")
    floors_line("fleet", rec, rc, card)


def check_ramp(rec, rc, card):
    hist = [v for _t, v in rec["history_replicas"]]
    names = {e["name"] for e in rec["scale_events"]}
    print(f"serving ramp: 1 -> {rec['peak_replicas']} -> "
          f"{rec['end_replicas']} replicas (ceiling {rec['replicas_max']}), "
          f"peak at {rec['t_peak_s']} s, {rec['requests']} requests, "
          f"{rec['failures']} failed, {rec['shed_429']} shed in "
          f"{rec['shed_window_s']} s, {rec['sheds_after_peak']} after the "
          f"peak; p50 {rec['p50_ms']} ms, p99 {rec['p99_ms']} ms (at the "
          f"peak {rec['p99_at_peak_ms']}); phases {rec['phases']} [{card}]",
          flush=True)
    check(rec["failures"] == 0 and rec["sheds_after_peak"] == 0
          and rec["end_replicas"] == 1 and rec["peak_replicas"] > 1
          and {"serve.scale.up", "serve.scale.down"} <= names
          and hist and max(hist) > 1 and hist[-1] == 1,
          f"--ramp: {rec['failures']} failed, {rec['sheds_after_peak']} "
          f"sheds after the peak, end {rec['end_replicas']}, events "
          f"{sorted(names)}, ring tail {hist[-8:]}")
    floors_line("ramp", rec, rc, card)


def check_drill(name, rec, rc, card):
    """A drill's record: its failures at most its one speed floor's, and
    its own correctness fields."""
    floor_fails = [f for f in rec["failures"]
                   if f.startswith(DRILL_FLOOR[name])]
    other = [f for f in rec["failures"] if f not in floor_fails]
    check(other == [], f"{name}: {other}")
    if name == "trace_drill":
        s1, s2, s3 = (rec["steps"][k] for k in ("traced_fleet", "overhead",
                                                "slo_burn"))
        print(f"serving trace drill: {s1['requests']} traced requests, "
              f"client p50 {s1['client_p50_ms']} ms, p99 "
              f"{s1['client_p99_ms']} ms; the p99 exemplar "
              f"{s1['p99_exemplar_ms']} ms, its hops sum to "
              f"{s1['p99_hop_sum_ms']} ms ({s1['p99_hop_share']}), replica "
              f"hops inside front.forward "
              f"{s1['replica_side']['inside_forward']}"
              f"; overhead off {s2['off_req_per_sec']} / sampled "
              f"{s2['sampled_req_per_sec']} req/s; SLO burn fired "
              f"{s3['slo_burn_fired']}, in the dump {s3['event_in_dump']} "
              f"[{card}]", flush=True)
        check(s1["errors"] == 0 and 0.9 <= s1["p99_hop_share"] <= 1.1
              and s1["replica_side"]["inside_forward"]
              and s1["waterfall_rendered"] and s3["slo_burn_fired"]
              and s3["event_in_dump"] and s3["slo_burn_in_report"],
              f"trace drill: {s1}, {s3}")
    elif name == "drift_drill":
        st = rec["steps"]
        quiet = st["in_distribution"]["replicas"]
        loud = st["shifted"]["replicas"]
        print(f"serving drift drill: in-distribution PSI "
              f"{[r['psi_max'] for r in quiet.values()]}, fired "
              f"{[r['drift_fired'] for r in quiet.values()]}; shifted PSI "
              f"{[r['psi_max'] for r in loud.values()]}, fired "
              f"{[r['drift_fired'] for r in loud.values()]}, worst "
              f"{[r['worst_features'] for r in loud.values()]}; the front's "
              f"merge agrees {st['fleet_merge']['agrees']}; flight fired "
              f"{st['flight']['drift_fired']}; overhead off "
              f"{st['overhead']['off_req_per_sec']} / sampled "
              f"{st['overhead']['sampled_req_per_sec']} req/s; its trainer "
              f"launched K1 {rec['kernel_launches']['hist_wave']}, K3 "
              f"{rec['kernel_launches']['hist_wave_gather_mxu']}, K5 "
              f"{rec['kernel_launches']['route_wave']} [{card}]", flush=True)
        check(rec["kernel_launches"]["hist_wave"] > 0
              and rec["kernel_launches"]["route_wave"] > 0,
              f"the drift drill's trainer ran no K1 or K5 on the card: "
              f"{rec['kernel_launches']}")
        check(len(quiet) == len(loud) == rec["replicas"]
              and not any(r["drift_fired"] for r in quiet.values())
              and all(r["drift_fired"] and r["retraces"] == 0
                      for r in loud.values())
              and st["fleet_merge"]["agrees"] and st["flight"]["drift_fired"]
              and st["flight"]["event_in_dump"], f"drift drill: {st}")
    else:
        iso, cons = rec["burn_isolation"], rec["conservation"]
        print(f"serving mesh drill: the hog fired {iso['abusive_fired']} "
              f"windows, the quiet tenants {iso['quiet_fired']}; "
              f"conservation exact on {len(cons['per_replica'])} replicas "
              f"{cons['ok']}; abuse {rec['traffic']['abuse']}; top talker "
              f"{(rec['top_talkers'] or [{}])[0].get('model')}; scrape "
              f"{rec['overhead']['plain_ms']} / {rec['overhead']['models_ms']}"
              f" ms; flight {rec['flight']['models_in_dump']} [{card}]",
              flush=True)
        check(iso["ok"] and cons["ok"]
              and len(cons["per_replica"]) == rec["replicas"]
              and rec["flight"]["ok"], f"mesh drill: {iso}, {cons}")
    floors_line(name, rec, rc, card)


def phase_serving(card):
    """The reference's serving bench and drills on the card (slice 23),
    each its own process of the port's script: serve_bench's rung matrix at
    500 trees, depth 6 (K6 and K7 on the fused and binned rungs) with a
    binned fleet of SB_REPLICAS (`--rungs-fleet`) alone, then `--fleet
    --replicas SB_REPLICAS`, `--ramp --replicas SB_RAMP_REPLICAS` and the
    trace, drift and mesh drills at once, each fleet's replicas `cli
    serve` processes sharing the card. Every
    correctness field is held here; a speed floor is printed beside its
    value, and a run may exit 1 for a missed floor only. Returns
    serve_bench's kernel launches (K6 and K7 among them)."""
    d = tempfile.mkdtemp(prefix="ytk_chip_smoke_serving_")
    t0 = time.perf_counter()
    live = []

    def start(name, args, where):
        live.append(start_script(name, args, where))
        return live[-1]

    try:
        rc, rungs, _w = finish_script(start("serve_bench", [
            "--seconds", str(SB_SECONDS), "--rungs-fleet",
            str(SB_REPLICAS)], d), "serve_bench rungs", card)
        check_rungs(rungs, rc, card)
        # the fleet matrix, the ramp and the three drills at once: each is
        # its own fleet on the card
        t_d = time.perf_counter()
        fleet = start("serve_bench", [
            "--fleet", "--replicas", str(SB_REPLICAS), "--seconds",
            str(SB_SECONDS), "--mixed-seconds", str(SB_MIXED_SECONDS)], d)
        ramp = start("serve_bench", [
            "--ramp", "--replicas", str(SB_RAMP_REPLICAS),
            "--ramp-grow-timeout", str(SB_RAMP_TIMEOUT_S),
            "--ramp-shrink-timeout", str(SB_RAMP_TIMEOUT_S)], d)
        drills = {}
        for name, args in (("trace_drill", ["--seconds",
                                            str(TRACE_SECONDS)]),
                           ("drift_drill", []), ("mesh_drill", [])):
            # a directory each: the trace drill's snapshot lands beside
            # its record
            os.makedirs(os.path.join(d, name))
            drills[name] = start(name, args, os.path.join(d, name))
        done = {name: finish_script(started, name, card)
                for name, started in drills.items()}
        done["ramp"] = finish_script(ramp, "serve_bench --ramp", card)
        done["fleet"] = finish_script(fleet, "serve_bench --fleet", card)
        print(f"serving: the fleet matrix, the ramp and the three drills at "
              f"once in {time.perf_counter() - t_d:.3f} s (wall) [{card}]",
              flush=True)
        for name, (rc, rec, _w) in done.items():
            if name == "fleet":
                check_fleet(rec, rc, card)
            elif name == "ramp":
                check_ramp(rec, rc, card)
            else:
                check_drill(name, rec, rc, card)
    finally:
        for started in live:
            kill_script(started)
        shutil.rmtree(d, ignore_errors=True)
    print(f"serving: bench and drills in {time.perf_counter() - t0:.3f} s "
          f"(wall) [{card}]", flush=True)
    return rungs["kernel_launches"]


def stop_cpu_references(refs):
    """Stop the references' pool and its processes (idempotent): no
    process of the script outlives it."""
    if not refs:
        return
    pool = refs["pool"]
    for proc in list((getattr(pool, "_processes", None) or {}).values()):
        if proc.is_alive():
            proc.terminate()
    pool.shutdown(wait=True, cancel_futures=True)
    shutil.rmtree(refs["tmp"], ignore_errors=True)


def timed(name, fn, *args, **kw):
    """Run one phase, print its wall time; return what it returns."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s (wall)",
          flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    from concurrent.futures import ThreadPoolExecutor

    from ytklearn_tpu_torch.gbdt import hist, route
    from ytklearn_tpu_torch.serve import kernels

    print(sh([kernels.find_nvcc(), "--version"]).splitlines()[-1], flush=True)
    print(f"ninja: {shutil.which('ninja') or 'not found'} (not used: the "
          "kernels are built by nvcc into ctypes libraries)", flush=True)

    from ytklearn_tpu_torch.io import native

    def build_parser():
        """The host text parser (g++), built beside the kernels."""
        t0 = time.perf_counter()
        ok = native.native_available()
        return {"cmd": " ".join(["g++", *native.GXX_FLAGS, "ytk_parse.cpp"]),
                "seconds": time.perf_counter() - t0,
                "log": f"native parser available: {ok}"}

    def build_serve_native():
        """The host serving library (g++): binning for both binned rungs,
        the CPU binned walk."""
        t0 = time.perf_counter()
        ok = kernels.native_serve_available()
        return {"cmd": " ".join(["g++", "-fopenmp", *native.GXX_FLAGS,
                                 "ytk_serve.cpp"]),
                "seconds": time.perf_counter() - t0,
                "log": f"native serve library available: {ok}"}

    # one nvcc per source (and g++ for the two host libraries), all
    # started together
    sources = {"ytk_parse.cpp": build_parser,
               "ytk_serve.cpp": build_serve_native,
               "heap_walk.cu": kernels.build_kernel,
               "hist.cu": hist.build_kernel,
               "hist_float.cu": hist.build_float_kernel,
               "route.cu": route.build_kernel,
               "hist_u8.cu": hist.build_u8_kernel}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = {k: pool.submit(fn) for k, fn in sources.items()}
        builds = {k: f.result() for k, f in builds.items()}
    print(f"build: {len(sources)} libraries in {time.perf_counter() - t0:.3f} s (wall, "
          f"in parallel) [{card}]", flush=True)
    for name, build in builds.items():
        print(f"build: {name} in {build['seconds']:.3f} s [{card}]: "
              f"{build['cmd']}", flush=True)
        print(build["log"].strip(), flush=True)

    refs = {}
    try:
        return main_phases(card, refs)
    finally:
        stop_cpu_references(refs)


def main_phases(card, refs) -> int:
    """The phases after the builds; `refs` receives the CPU references'
    pool (start_cpu_references), which main stops whatever happens."""
    import torch

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_")
    try:
        max_err, k7_err = timed("kernel", phase_kernel, tmp, card)
        launches, model, _p50 = timed("slice", phase_slice, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    times, timing_err = timed("timings", phase_timings, model, card)
    max_err = max(max_err, timing_err)
    ms, plain_ms, bound_ms, bound_by, device_ms = times[LADDER[-1]]
    rows = [{
        "name": "heap_walk",
        "route": "cuda",
        "source": "ytklearn_tpu_torch/serve/csrc/heap_walk.cu",
        "replaces": "ytklearn_tpu/serve/kernels.py:341",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "device_ms": device_ms,
    }]

    errs = timed("train_kernels", phase_train_kernels, card)
    errs.update(timed("float_kernels", phase_float_kernels, card))
    errs["binned_walk"] = max(k7_err, timed("binned_kernel",
                                            phase_binned_kernel, model,
                                            card))
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_t_")
    try:
        _counts, trainer, res8, tps8 = timed("train", phase_train, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = (f"{res8.test_metrics['auc']:.6f}", f"{res8.test_loss:.6f}")
    print(f"train int8: test AUC and logloss {got}, expected "
          f"{INT8_TEST_METRICS} [{card}]", flush=True)
    check(got == INT8_TEST_METRICS,
          f"int8 test AUC/logloss {got} moved from {INT8_TEST_METRICS}")
    ttimes = timed("train_timings", phase_train_timings, trainer, card)
    q_width_err = timed("q_widths", phase_q_widths, trainer, card)
    n_bench = trainer.dev_inputs.bins_t.shape[1]
    del trainer
    torch.cuda.empty_cache()
    q_sat_err = timed("q_saturating", phase_q_saturating, n_bench, card)
    errs["hist_q"] = max(errs["hist_q"], q_width_err, q_sat_err)
    errs["hist_gather_q"] = max(errs["hist_gather_q"], q_width_err, q_sat_err)
    torch.cuda.empty_cache()
    timed("train_profile", phase_train_profile, card)
    timed("cpu_card_compare", phase_cpu_card_compare, card)
    # slice 11: softmax, l1 and continue_train in int8, card against CPU
    timed("objectives_int8", phase_objectives_int8, card)
    torch.cuda.empty_cache()

    # slice 9: bench.py's cell with its GOSS default, EFB, the bench script
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_g_")
    try:
        goss_counts, _tps_goss, goss_times, goss_errs = timed(
            "train_goss", phase_train_goss, tmp, card, tps8)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the kernels line reads K2, K4 and K5 at the main path's own shapes
    ttimes.update(goss_times)
    for k, v in goss_errs.items():
        errs[k] = max(errs[k], v)
    torch.cuda.empty_cache()
    timed("train_profile_goss", phase_train_profile, card, GOSS)
    efb_err = timed("efb", phase_efb, card)
    for k, v in efb_err.items():
        errs[k] = max(errs[k], v)
    torch.cuda.empty_cache()
    timed("bench_script", phase_bench_script, card)

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_cli_")
    try:
        cli_counts, cli_model, _cli_tps, _cli_res = timed(
            "cli_train", phase_cli_train, tmp, card)
        k7_launches, _k7_p50 = timed("serve_binned", phase_serve_binned,
                                     tmp, cli_model, card)
        k7_time = timed("binned_timing", phase_binned_timing, cli_model,
                        model, card)
        # slice 14: `cli serve` at the reference's defaults, hot reload,
        # rollback, the obs planes; both serving rungs in this process
        timed("serve_ops", phase_serve_ops, tmp, model, cli_model, card)
        torch.cuda.empty_cache()
        # slice 15: `cli retrain` against that model served under traffic
        timed("continual", phase_continual, tmp, cli_model, card)
        torch.cuda.empty_cache()
        # slice 16: that model behind the serving fleet, fused and binned
        timed("fleet", phase_fleet, tmp, cli_model, card)
        torch.cuda.empty_cache()
        # slice 17: the profiling plane over phase_cli_train's config
        timed("profile", phase_profile, tmp, cli_model, card)
        torch.cuda.empty_cache()
        # slice 23: the reference's serving bench and drills
        sb_launches = timed("serving", phase_serving, card)
        torch.cuda.empty_cache()
        # the deep and wide phases' CPU references grow from here, beside
        # the card's phases up to phase_deep_tree
        refs.update(timed("cpu_references", start_cpu_references, card))
        # slice 18: GBDT across ranks over the same text
        timed("dist", phase_dist, tmp, card)
        torch.cuda.empty_cache()
        # slice 19: the convex families and GBST across ranks, then a
        # retrain of that text on two ranks
        timed("dist_convex", phase_dist_convex, tmp, card)
        torch.cuda.empty_cache()
        # slice 13: the host engine over the same text, then resilience
        t0 = time.perf_counter()
        small = timed("host_engine", phase_host_engine, card,
                      {k: os.path.join(tmp, f"{k}.txt")
                       for k in ("train", "test")}, tmp)
        torch.cuda.empty_cache()
        timed("resilience", phase_resilience, card, small)
        torch.cuda.empty_cache()
        print(f"slice 13 phases: {time.perf_counter() - t0:.3f} s (wall) "
              f"[{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_b_")
    try:
        _c16, trainer, res16, tps16 = timed("train_bf16", phase_train,
                                            tmp, card, "bf16")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"train: test AUC bf16 {res16.test_metrics['auc']:.6f} beside "
          f"int8 {res8.test_metrics['auc']:.6f}; logloss bf16 "
          f"{res16.test_loss:.6f}, int8 {res8.test_loss:.6f} [{card}]",
          flush=True)
    print(f"train bf16: steady {tps16:.4f} trees/s beside "
          f"{BF16_TPS_BEFORE} trees/s before the K1/K3 redesign (PERF.md "
          f"section 5, the same cell and card) [{card}]", flush=True)
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_gb_")
    try:
        c16g, _t, _r, tps16g = timed("train_bf16_goss", phase_train, tmp,
                                     card, "bf16", goss=GOSS,
                                     rounds=GOSS_BF16_ROUNDS)
        del _t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"train bf16 GOSS: {GOSS_BF16_ROUNDS} trees, steady {tps16g:.4f} "
          f"trees/s beside {tps16:.4f} with GOSS off over 40 [{card}]",
          flush=True)
    ttimes.update(timed("float_timings", phase_float_timings, trainer,
                        card))
    errs["hist"] = max(errs["hist"], timed("float_widths",
                                           phase_float_widths, trainer,
                                           card))
    del trainer
    torch.cuda.empty_cache()
    timed("repro", phase_repro, card)
    # slice 21: one tree past the shared node lookup (K1-K4's global kind)
    # (slice 22: the wide-bin runs inside it, while its CPU trees grow)
    deep_launches, deep_ms, deep_errs, wide = timed(
        "deep_tree", phase_deep_tree, card, refs)
    for k, v in deep_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    for k, v in wide["errs"].items():
        errs[k] = max(errs.get(k, 0.0), v)
    torch.cuda.empty_cache()
    # slice 22: the engine's profile, micro and ablation scripts (after the
    # deep phase: beside its CPU trees they slowed those more than they
    # saved, PERF.md section 6)
    timed("engine_scripts", phase_engine_scripts, card)
    # slice 11: softmax through cli train at full width (K1, K3, K5)
    for k, v in timed("softmax_cli", phase_softmax_cli, card).items():
        errs[k] = max(errs[k], v)
    torch.cuda.empty_cache()

    errs["hist_q_u8"] = timed("u8_kernels", phase_u8_kernels, card)
    u8_launches = timed("tools", phase_tools, card)
    torch.cuda.empty_cache()
    u8_err, ttimes["hist_q_u8"] = timed("u8_timing", phase_u8_timing, card)
    errs["hist_q_u8"] = max(errs["hist_q_u8"], u8_err)
    torch.cuda.empty_cache()

    # slice 10: the convex stack (no kernel of the port on its path); its
    # models stay for slice 12's serving phase
    t0 = time.perf_counter()
    ctmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_convex_")
    try:
        served = timed("convex_cli", phase_convex_cli, card, ctmp)
        torch.cuda.empty_cache()
        timed("bench_fm", phase_bench_fm, card)
        torch.cuda.empty_cache()
        print(f"convex phases: {time.perf_counter() - t0:.3f} s (wall) "
              f"[{card}]", flush=True)
        # slice 12: GBST through cli train, then cli serve for every
        # family but GBDT (no kernel of the port on either path)
        t0 = time.perf_counter()
        served.update(timed("gbst_cli", phase_gbst_cli, card, ctmp))
        torch.cuda.empty_cache()
        timed("serve_families", phase_serve_families, card, served)
        torch.cuda.empty_cache()
        print(f"slice 12 phases: {time.perf_counter() - t0:.3f} s (wall) "
              f"[{card}]", flush=True)
    finally:
        shutil.rmtree(ctmp, ignore_errors=True)
    # K2, K4 and K5 launch on slice 9's main path, the GOSS bench cell
    launches_of = dict(goss_counts)
    launches_of.update({k: cli_counts[k] for k in ("hist", "hist_gather")})
    launches_of["hist_q_u8"] = u8_launches

    for name, src, line in (
        ("hist_q", "hist.cu", "ytklearn_tpu/gbdt/hist.py:113"),
        ("hist_gather_q", "hist.cu", "ytklearn_tpu/gbdt/hist.py:434"),
        ("route", "route.cu", "ytklearn_tpu/gbdt/route.py:23"),
        ("hist", "hist_float.cu", "ytklearn_tpu/gbdt/hist.py:51"),
        ("hist_gather", "hist_float.cu", "ytklearn_tpu/gbdt/hist.py:371"),
        ("hist_q_u8", "hist_u8.cu", "scripts/tune_hist_kernel.py:71"),
    ):
        ms, plain_ms, bound_ms, bound_by, lib_ms = ttimes[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"ytklearn_tpu_torch/gbdt/csrc/{src}",
            "replaces": line,
            "launches": launches_of[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms,
        })
        if name in deep_ms:  # K1-K4 on slice 21's deep tree
            rows[-1].update({"deep_launches": deep_launches[name],
                             "ms_shared_lookup": deep_ms[name][0],
                             "ms_global_lookup": deep_ms[name][1]})
        if name in wide["report"]:  # K1-K4 past one tile (slice 22)
            rows[-1].update({"wide_launches": wide["launches"][name],
                             "wide_bins": wide["report"][name]})
    ms, plain_ms, bound_ms, bound_by, device_ms = k7_time
    rows.append({
        "name": "binned_walk",
        "route": "cuda",
        "source": "ytklearn_tpu_torch/serve/csrc/heap_walk.cu",
        "replaces": "ytklearn_tpu/serve/kernels.py:439",
        "launches": k7_launches,
        "max_abs_err": errs["binned_walk"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "device_ms": device_ms,
        "serve_bench_launches": sb_launches["binned_walk"],
    })
    # K6 on slice 23's path: serve_bench's fused rung
    rows[0]["serve_bench_launches"] = sb_launches["heap_walk"]
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"chip_smoke: {time.perf_counter() - T_START:.3f} s in all, the "
          f"kernel builds included (wall) [{card}]", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
