"""The reference's experiment protocols (layer L5, orchestration and
verification), each a module with a main(argv) that runs as
`python -m cuda_selection_criteria_tpu_torch.experiments.<name>`:

  compare_engines      - the device engine against the scalar host engine
                         at tau=0.01, pair by pair (comparacion_*.csv)
  run_time_experiment  - the timing sweep over SMH sizes and blocks, a
                         device arm and a host arm
                         (experimento_smh_comparativo.csv)
  confirm_throughput   - pairs/s of the exact confirm stage, host and
                         device-assisted, and the reject-bound workload
                         (one JSON line)

Ports of experiments/{compare_engines,run_time_experiment,
confirm_throughput}.py of the JAX package; they default to --device cuda.
"""
