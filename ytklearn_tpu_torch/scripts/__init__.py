"""The histogram tuning tools, one counterpart per tool of the reference's
`scripts/`:

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
  time_hist          K1-K4 at chip_smoke.py's timing shapes on one line,
                     to compare two checkouts in turns on one card

Each runs as `python -m ytklearn_tpu_torch.scripts.<name>` on the card
(the default device; without a GPU it raises), times with CUDA events and
prints the card's name and power limit on its lines. `--device cpu` runs
the control flow and the spot checks on the plain versions at a small
`--rows` and prints "not measured (cpu)" in place of every time.
"""
