"""The tuning and timing tools: one counterpart per histogram tool of the
reference's `scripts/`, and the timers of two checkouts:

  tune_hist_kernel   K2, K1 and K8 across launch shapes at the Higgs tune
                     shape, and the spot check K8 == K2
                     (scripts/tune_hist_kernel.py)
  tune_hist          K1 (bf16) across launch shapes at waves of 16-64 slots,
                     positions over the wave or over 509 nodes, chained
                     launches (scripts/tune_hist.py, micro_hist_chain.py)
  micro_hist_gather  K4 against gather-then-K2 at row budgets R
                     (scripts/micro_hist_gather.py)
  tune_gbdt          the trainer's wave width x histogram precision in
                     trees/s (scripts/tune_gbdt.py)
  time_hist          K1-K5 and K8 at chip_smoke.py's timing shapes on one
                     line, to compare two checkouts in turns on one card
  time_walk          K6 and K7, the serving walks, at every ladder rung, for
                     the same comparison (--sweep: launch shapes)
  bench_gbdt         bench.py's GBDT cell as the reference runs it (GOSS on
                     by default): steady trees/s, test AUC and logloss
                     against bench.py's synthetic band, one JSON object a
                     run; --repeats N runs it in N fresh processes and adds
                     the medians (bench.py::bench_gbdt)
  bench_fm           bench.py's FM cell: rank-8 FM, full-batch L-BFGS over
                     2,000,000 Criteo-shaped rows; examples/s and the loss,
                     --repeats N as bench_gbdt (bench.py::bench_fm)
  convex_synth       seeded text files and configs of the convex families
                     for the tests and chip_smoke.py (no command line)

Each runs as `python -m ytklearn_tpu_torch.scripts.<name>` on the card
(the default device; without a GPU it raises), times with CUDA events and
prints the card's name and power limit on its lines. `--device cpu` runs
the control flow and the spot checks on the plain versions at a small
`--rows` and prints "not measured (cpu)" in place of every time.
"""
